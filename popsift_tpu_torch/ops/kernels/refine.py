"""K2: 5-step sub-pixel refinement of DoG extremum candidates
(csrc/refine.cu).

Replaces popsift_tpu/ops/pallas/refine.py::refine_windows_pallas, the
fused window read + refinement: one thread per candidate reads its
27-neighbourhood straight from the dense DoG stack, as the reference
refines in registers (s_extrema.cu:359-460). (The separate window copy
of the unfused route is kernel K6, ops/kernels/window.py.)

Output: f32[K, 16], columns (nx, ny, nz, dx, dy, dz, v, Dx, Dy, Ds, DDx,
DDy, DXy, 0, 0, 0) -- the state popsift_tpu.ops.extrema.finalize_refined
reads. Rows at or past ``n`` are zeros.

The frame-batched entry (:func:`refine_state_batched`, replacing
``refine_windows_pallas_batched``) refines F frames' candidates, F*cap
rows frame-major, against their stacks laid back to back, in one launch
with its own launch counter; each row reads only its own frame's layers.

:func:`refine_state_octaves` is the entry of the extraction paths: ONE
launch over the candidate rows of all octaves of F frames, laid out as
the compaction kernel writes them (ops/kernels/compact.py; frame-major,
frame f's octave o at rows f * Ktot + offs[o] .. + cap[o]), each row's
live count read from ``n_found[f, o]`` on the device. The per-octave and
batched entries stay beside it, off every extraction path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

NAME = "refine"
SOURCE = "popsift_tpu_torch/csrc/refine.cu"
REPLACES = "popsift_tpu/ops/pallas/refine.py:350"
NAME_BATCHED = "refine_batched"
REPLACES_BATCHED = "popsift_tpu/ops/pallas/refine.py:380"
NAME_OCTAVES = "refine_octaves"
REPLACES_OCTAVES = REPLACES
MAX_OCTAVES = 16      # MAX_OCT of csrc/refine.cu
MAX_ITERATIONS = 5    # s_extrema.cu:363
NOUT = 16
launches = 0
launches_batched = 0
launches_octaves = 0


def solve3(a00, a01, a02, a11, a12, a22, b0, b1, b2):
    """Symmetric 3x3 solve via the adjugate (s_solve.h:24-85), in the op
    order of popsift_tpu.ops.extrema._solve3. Returns (singular, x0, x1,
    x2); singular rows get x == 0."""
    det0 = a11 * a22 - a12 * a12
    det1 = a12 * a02 - a01 * a22
    det2 = a01 * a12 - a11 * a02
    det3 = a00 * a22 - a02 * a02
    det4 = a01 * a02 - a00 * a12
    det5 = a00 * a11 - a01 * a01
    det = a00 * det0 + a01 * det1 + a02 * det2
    singular = det == 0.0
    one = torch.ones_like(det)
    rsd = torch.where(singular, one, 1.0 / torch.where(singular, one, det))
    x0 = (det0 * b0 + det1 * b1 + det2 * b2) * rsd
    x1 = (det1 * b0 + det3 * b1 + det4 * b2) * rsd
    x2 = (det2 * b0 + det4 * b1 + det5 * b2) * rsd
    z = torch.zeros_like(x0)
    return (singular, torch.where(singular, z, x0),
            torch.where(singular, z, x1), torch.where(singular, z, x2))


def refine_loop(neighbourhood, nx, ny, nz, W, H, *, maxlevel: int,
                vlfeat: bool):
    """The 5-step refinement of popsift_tpu.ops.extrema.refine_candidates
    (:652-728) on n candidates starting at (nx, ny, nz) i64[n], up to its
    13 state columns. ``neighbourhood(nz, ny, nx)`` returns the f32
    [n, 3, 3, 3] values dog[nz+a-1, ny+b-1, nx+c-1] around the current
    positions; ``W``/``H`` are ints or per-row i64 tensors. One body for
    every reader of the DoG (the dense stack, pre-cut windows), so they
    round alike. Returns the 13 columns as a tuple."""
    n = nx.shape[0]
    zf = torch.zeros(n, dtype=torch.float32, device=nx.device)
    v = dx = dy = dz = Dx = Dy = Ds = DDx = DDy = DXy = zf
    done = torch.zeros(n, dtype=torch.bool, device=nx.device)

    for it in range(1, MAX_ITERATIONS + 1):
        act = ~done
        nb = neighbourhood(nz, ny, nx)                   # [n, 3, 3, 3]
        c = nb[:, 1, 1, 1]
        if it == 1:
            v = c              # contrast base, s_extrema.cu:357
        p2, p0 = nb[:, 1, 1, 2], nb[:, 1, 1, 0]
        q2, q0 = nb[:, 1, 2, 1], nb[:, 1, 0, 1]
        r2, r0 = nb[:, 2, 1, 1], nb[:, 0, 1, 1]
        nDx = 0.5 * (p2 - p0)
        nDy = 0.5 * (q2 - q0)
        nDs = 0.5 * (r2 - r0)
        nDDx = p2 + p0 - 2.0 * c
        nDDy = q2 + q0 - 2.0 * c
        nDDs = r2 + r0 - 2.0 * c
        nDXy = 0.25 * (nb[:, 1, 2, 2] + nb[:, 1, 0, 0]
                       - nb[:, 1, 2, 0] - nb[:, 1, 0, 2])
        nDXs = 0.25 * (nb[:, 2, 1, 2] + nb[:, 0, 1, 0]
                       - nb[:, 2, 1, 0] - nb[:, 0, 1, 2])
        nDYs = 0.25 * (nb[:, 2, 2, 1] + nb[:, 0, 0, 1]
                       - nb[:, 0, 2, 1] - nb[:, 2, 0, 1])
        sing, sx, sy, ss = solve3(nDDx, nDXy, nDXs, nDDy, nDYs, nDDs,
                                  -nDx, -nDy, -nDs)
        Dx = torch.where(act, nDx, Dx)
        Dy = torch.where(act, nDy, Dy)
        Ds = torch.where(act, nDs, Ds)
        DDx = torch.where(act, nDDx, DDx)
        DDy = torch.where(act, nDDy, DDy)
        DXy = torch.where(act, nDXy, DXy)
        dx = torch.where(act, sx, dx)
        dy = torch.where(act, sy, dy)
        dz = torch.where(act, ss, dz)
        if it == MAX_ITERATIONS:
            break
        # step policy (popsift s_extrema.cu:258-284; vlfeat :207-232)
        tx = ((sx >= 0.6) & (nx < W - 2)).long() \
            - ((sx <= -0.6) & (nx > 1)).long()
        ty = ((sy >= 0.6) & (ny < H - 2)).long() \
            - ((sy <= -0.6) & (ny > 1)).long()
        if vlfeat:
            tz = torch.zeros_like(tx)
        else:
            tz = ((ss >= 0.6) & (nz < maxlevel - 1)).long() \
                - ((ss <= -0.6) & (nz > 1)).long()
        converged = (tx == 0) & (ty == 0) & (tz == 0)
        move = act & ~sing & ~converged
        nx = torch.where(move, nx + tx, nx)
        ny = torch.where(move, ny + ty, ny)
        nz = torch.where(move, nz + tz, nz)
        done = done | (act & (sing | converged))

    return (nx.float(), ny.float(), nz.float(), dx, dy, dz, v,
            Dx, Dy, Ds, DDx, DDy, DXy)


def refine_state_torch(dog: torch.Tensor, x0: torch.Tensor,
                       y0: torch.Tensor, z0: torch.Tensor, n: int, *,
                       maxlevel: int, vlfeat: bool) -> torch.Tensor:
    """Plain version: popsift_tpu.ops.extrema.refine_candidates (:604-731)
    up to the 13-column state, on rows [0, n). Neighbour reads clamp z
    to [0, D-1] as ``neighborhood`` does (:630); x and y are clamped to
    the image, which is the JAX twin's edge-padded window (the step
    policy keeps every read inside it anyway)."""
    D, H, W = dog.shape
    K = x0.shape[0]
    out = torch.zeros((K, NOUT), dtype=torch.float32, device=dog.device)
    if n == 0:
        return out
    flat = dog.reshape(-1)
    ar3 = torch.arange(3, device=dog.device) - 1

    def neighbourhood(nz, ny, nx):
        zi = (nz[:, None] + ar3).clamp(0, D - 1)
        yi = (ny[:, None] + ar3).clamp(0, H - 1)
        xi = (nx[:, None] + ar3).clamp(0, W - 1)
        idx = (zi[:, :, None, None] * H + yi[:, None, :, None]) * W \
            + xi[:, None, None, :]
        return flat[idx]

    cols = refine_loop(neighbourhood, x0[:n].long(), y0[:n].long(),
                       z0[:n].long(), W, H, maxlevel=maxlevel, vlfeat=vlfeat)
    out[:n, :len(cols)] = torch.stack(cols, dim=1)
    return out


def refine_state(dog: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                 z0: torch.Tensor, n: int, *, maxlevel: int,
                 vlfeat: bool) -> torch.Tensor:
    """f32[K, 16] refinement state of candidates (x0, y0, z0) i32[K],
    rows [0, n) live: plain version on the CPU, kernel K2 on CUDA."""
    global launches
    if dog.dim() != 3 or dog.dtype != torch.float32:
        raise ValueError("refine_state expects a f32[D, H, W] DoG stack")
    if dog.device.type == "cpu":
        return refine_state_torch(dog, x0, y0, z0, n, maxlevel=maxlevel,
                                  vlfeat=vlfeat)
    x0, y0, z0 = (t.to(torch.int32).contiguous() for t in (x0, y0, z0))
    build.require_cuda(NAME, dog, x0, y0, z0)
    D, H, W = dog.shape
    K = x0.shape[0]
    if not 0 <= n <= K:
        raise ValueError(f"refine_state: n={n} outside [0, {K}]")
    out = torch.zeros((K, NOUT), dtype=torch.float32, device=dog.device)
    if n == 0:
        return out
    lib = build.load_library()
    build.launch(
        NAME, dog, lib.ps_refine,
        dog.data_ptr(), x0.data_ptr(), y0.data_ptr(),
                       z0.data_ptr(), n, D, H, W, maxlevel, int(vlfeat),
                       out.data_ptr())
    launches += 1
    return out


def refine_state_batched_torch(dog: torch.Tensor, x0: torch.Tensor,
                               y0: torch.Tensor, z0: torch.Tensor,
                               n_found: torch.Tensor, F: int, *,
                               maxlevel: int, vlfeat: bool) -> torch.Tensor:
    """Plain version of the batched entry: :func:`refine_state_torch` on
    each frame's own D layers, rows [f*cap, f*cap + n_found[f]) live."""
    D = dog.shape[0] // F
    cap = x0.shape[0] // F
    nf = n_found.tolist()
    return torch.cat([
        refine_state_torch(dog[f * D:(f + 1) * D],
                           x0[f * cap:(f + 1) * cap],
                           y0[f * cap:(f + 1) * cap],
                           z0[f * cap:(f + 1) * cap], int(nf[f]),
                           maxlevel=maxlevel, vlfeat=vlfeat)
        for f in range(F)])


def refine_state_batched(dog: torch.Tensor, x0: torch.Tensor,
                         y0: torch.Tensor, z0: torch.Tensor,
                         n_found: torch.Tensor, F: int, *, maxlevel: int,
                         vlfeat: bool) -> torch.Tensor:
    """f32[F*cap, 16] refinement state of F frames' candidates, i32
    [F*cap] frame-major with frame-local z, against their DoG stacks
    stacked on the layer axis, f32[F*D, H, W]; frame f's rows below
    ``n_found[f]`` (a [F] tensor on the stack's device) are live. Plain
    version on the CPU, one launch of kernel K2 on a CUDA device."""
    global launches_batched
    if (dog.dim() != 3 or dog.dtype != torch.float32 or F < 1
            or dog.shape[0] % F or x0.shape[0] % F
            or n_found.shape != (F,)):
        raise ValueError("refine_state_batched expects f32[F*D, H, W], "
                         "F*cap candidates and n_found[F]")
    if dog.device.type == "cpu":
        return refine_state_batched_torch(dog, x0, y0, z0, n_found, F,
                                          maxlevel=maxlevel, vlfeat=vlfeat)
    x0, y0, z0, n_found = (t.to(torch.int32).contiguous()
                           for t in (x0, y0, z0, n_found))
    build.require_cuda(NAME_BATCHED, dog, x0, y0, z0, n_found)
    FD, H, W = dog.shape
    cap = x0.shape[0] // F
    out = torch.zeros((F * cap, NOUT), dtype=torch.float32,
                      device=dog.device)
    if cap == 0:
        return out
    lib = build.load_library()
    build.launch(
        NAME_BATCHED, dog, lib.ps_refine_batched,
        dog.data_ptr(), x0.data_ptr(), y0.data_ptr(), z0.data_ptr(),
        n_found.data_ptr(), F, cap, FD // F, H, W, maxlevel, int(vlfeat),
        out.data_ptr())
    launches_batched += 1
    return out


def _check_octaves(dogs, x0, caps, n_found, F: int) -> None:
    if (not 1 <= len(dogs) <= MAX_OCTAVES or len(caps) != len(dogs)
            or F < 1 or x0.shape[0] != F * sum(caps)
            or n_found.shape != (F, len(dogs))):
        raise ValueError(f"refine_state_octaves expects 1 to {MAX_OCTAVES} "
                         f"octaves, F * sum(caps) rows and n_found[F, "
                         f"n_oct]")
    for d in dogs:
        if d.dim() != 3 or d.dtype != torch.float32 or d.shape[0] % F:
            raise ValueError("refine_state_octaves expects f32[F*D, H, W] "
                             "stacks")


def refine_state_octaves_torch(dogs, x0: torch.Tensor, y0: torch.Tensor,
                               z0: torch.Tensor, n_found: torch.Tensor,
                               caps, F: int = 1, *, maxlevel: int,
                               vlfeat: bool) -> torch.Tensor:
    """Plain version of :func:`refine_state_octaves`:
    :func:`refine_state_torch` on each frame's octave rows and its own D
    layers, in the kernel's row order."""
    _check_octaves(dogs, x0, caps, n_found, F)
    nf = n_found.tolist()
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(int)
    out = []
    for f in range(F):
        for o, dog in enumerate(dogs):
            D = dog.shape[0] // F
            rows = slice(f * int(offs[-1]) + int(offs[o]),
                         f * int(offs[-1]) + int(offs[o + 1]))
            out.append(refine_state_torch(
                dog[f * D:(f + 1) * D], x0[rows], y0[rows], z0[rows],
                int(nf[f][o]), maxlevel=maxlevel, vlfeat=vlfeat))
    return torch.cat(out)


def refine_state_octaves(dogs, x0: torch.Tensor, y0: torch.Tensor,
                         z0: torch.Tensor, n_found: torch.Tensor, caps,
                         F: int = 1, *, maxlevel: int,
                         vlfeat: bool) -> torch.Tensor:
    """f32[F*Ktot, 16] refinement state of the candidate rows of all
    octaves of F frames (``dogs``: per octave the frames' stacks back to
    back, f32[F*D_o, H_o, W_o]; ``x0``, ``y0``, ``z0`` i32[F*Ktot]
    frame-major with frame-local z; octave o's rows below ``n_found[f,
    o]`` live, the rest zeros). Plain version on the CPU, ONE launch of
    kernel K2 on a CUDA device, with no count read back."""
    global launches_octaves
    _check_octaves(dogs, x0, caps, n_found, F)
    if x0.device.type == "cpu":
        return refine_state_octaves_torch(dogs, x0, y0, z0, n_found, caps,
                                          F, maxlevel=maxlevel, vlfeat=vlfeat)
    x0, y0, z0 = (t.to(torch.int32).contiguous() for t in (x0, y0, z0))
    n_found = n_found.to(torch.int64).contiguous()
    build.require_cuda(NAME_OCTAVES, *dogs, x0, y0, z0, n_found)
    out = torch.empty((x0.shape[0], NOUT), dtype=torch.float32,
                      device=x0.device)
    ends = np.cumsum(caps)
    table = np.asarray([[d.data_ptr(), d.shape[0] // F, d.shape[1],
                         d.shape[2], e] for d, e in zip(dogs, ends)],
                       np.int64)
    lib = build.load_library()
    build.launch(
        NAME_OCTAVES, x0, lib.ps_refine_octaves,
        table.ctypes.data_as(ctypes.c_void_p), len(dogs), F, x0.data_ptr(),
        y0.data_ptr(), z0.data_ptr(), n_found.data_ptr(), maxlevel,
        int(vlfeat), out.data_ptr())
    launches_octaves += 1
    return out
