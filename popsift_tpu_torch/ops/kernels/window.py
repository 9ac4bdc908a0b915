"""K6: per-candidate window copy from a layered volume (csrc/window.cu).

Replaces popsift_tpu/ops/pallas/window.py::extract_windows_pallas and its
frame-batched form ``extract_windows_pallas_batched``: the copy that
feeds the unfused refinement each candidate's [D, 11, 11] DoG
neighbourhood.

Window cell (d, i, j) of candidate k holds
``vol[d, clamp(cy[k] - radius + i, 0, H-1), clamp(cx[k] - radius + j, 0,
W-1)]``: the slice at ``clip(c - radius)`` of the volume edge-padded by
``radius``, which is how the JAX package cuts its windows
(popsift_tpu/ops/extrema.py:377-388). Rows at or past the live count are
zeros. The count is a tensor on the volume's device, so the kernel reads
it there and nothing comes back to the host.

The batched entry (:func:`extract_windows_batched`) takes F frames'
D-layer stacks back to back, f32[F*D, H, W], and F*cap rows frame-major;
row k reads only the layers of its frame f = k // cap and is live below
``n_found[f]``. It has its own launch counter.
"""

from __future__ import annotations

import torch

from . import build

NAME = "extract_windows"
SOURCE = "popsift_tpu_torch/csrc/window.cu"
REPLACES = "popsift_tpu/ops/pallas/window.py:105"
NAME_BATCHED = "extract_windows_batched"
REPLACES_BATCHED = "popsift_tpu/ops/pallas/window.py:224"
launches = 0
launches_batched = 0


def extract_windows_batched_torch(vol: torch.Tensor, cy: torch.Tensor,
                                  cx: torch.Tensor, n_found: torch.Tensor,
                                  F: int, radius: int, rows: int,
                                  cols: int) -> torch.Tensor:
    """Plain version: one advanced-indexing gather with clamped
    coordinates, rows past each frame's count zeroed."""
    FD, H, W = vol.shape
    D = FD // F
    K = cy.shape[0]
    cap = K // F
    dev = vol.device
    k = torch.arange(K, device=dev)
    f = k // cap
    live = (k - f * cap) < n_found.to(dev).long()[f]
    zi = f[:, None] * D + torch.arange(D, device=dev)            # [K, D]
    yi = (cy.long()[:, None] - radius
          + torch.arange(rows, device=dev)).clamp(0, H - 1)      # [K, rows]
    xi = (cx.long()[:, None] - radius
          + torch.arange(cols, device=dev)).clamp(0, W - 1)      # [K, cols]
    out = vol[zi[:, :, None, None], yi[:, None, :, None],
              xi[:, None, None, :]]
    return torch.where(live[:, None, None, None], out,
                       torch.zeros_like(out))


def extract_windows_torch(vol: torch.Tensor, cy: torch.Tensor,
                          cx: torch.Tensor, n_valid: torch.Tensor,
                          radius: int, rows: int, cols: int) -> torch.Tensor:
    """Plain version of the single-frame entry."""
    return extract_windows_batched_torch(vol, cy, cx, n_valid.reshape(1), 1,
                                         radius, rows, cols)


def _check(name: str, vol, cy, cx, n_found, F: int, rows: int, cols: int):
    if (vol.dim() != 3 or vol.dtype != torch.float32 or F < 1
            or vol.shape[0] % F or cy.shape != cx.shape or cy.dim() != 1
            or cy.shape[0] % F or n_found.numel() != F):
        raise ValueError(f"{name} expects f32[F*D, H, W], F*cap centres and "
                         f"{F} counts")
    if not (1 <= rows <= 16 and 1 <= cols <= 128):
        raise ValueError(f"{name}: window {rows} x {cols} (at most 16 x 128)")


def _launch(entry: str, vol, cy, cx, n_found, F: int, radius: int, rows: int,
            cols: int) -> torch.Tensor:
    cy, cx, n_found = (t.to(torch.int32).contiguous()
                       for t in (cy, cx, n_found.reshape(F)))
    build.require_cuda(entry, vol, cy, cx, n_found)
    FD, H, W = vol.shape
    K = cy.shape[0]
    out = torch.empty((K, FD // F, rows, cols), dtype=torch.float32,
                      device=vol.device)
    if K == 0:
        return out
    lib = build.load_library()
    tail = (FD // F, H, W, radius, rows, cols, out.data_ptr())
    ptrs = (vol.data_ptr(), cy.data_ptr(), cx.data_ptr(), n_found.data_ptr())
    if entry == NAME:
        build.launch(entry, vol, lib.ps_extract_windows, *ptrs, K, *tail)
    else:
        build.launch(entry, vol, lib.ps_extract_windows_batched, *ptrs, F,
                     K // F, *tail)
    return out


def extract_windows(vol: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                    n_valid: torch.Tensor, radius: int, rows: int,
                    cols: int) -> torch.Tensor:
    """f32[K, D, rows, cols] windows of ``vol`` f32[D, H, W] around the
    centres (cy, cx) i[K]; rows at or past ``n_valid`` (a one-element
    tensor on the volume's device) are zeros. Plain version on the CPU,
    kernel K6 on a CUDA device."""
    global launches
    _check(NAME, vol, cy, cx, n_valid, 1, rows, cols)
    if vol.device.type == "cpu":
        return extract_windows_torch(vol, cy, cx, n_valid, radius, rows, cols)
    out = _launch(NAME, vol, cy, cx, n_valid, 1, radius, rows, cols)
    launches += 1 if cy.shape[0] else 0
    return out


def extract_windows_batched(vol: torch.Tensor, cy: torch.Tensor,
                            cx: torch.Tensor, n_found: torch.Tensor, F: int,
                            radius: int, rows: int,
                            cols: int) -> torch.Tensor:
    """f32[F*cap, D, rows, cols] windows of F frames' stacks
    f32[F*D, H, W] around F*cap centres, frame-major; frame f's rows
    below ``n_found[f]`` (a [F] tensor on the volume's device) are live,
    the rest zeros. Plain version on the CPU, one launch of kernel K6 on
    a CUDA device."""
    global launches_batched
    _check(NAME_BATCHED, vol, cy, cx, n_found, F, rows, cols)
    if vol.device.type == "cpu":
        return extract_windows_batched_torch(vol, cy, cx, n_found, F, radius,
                                             rows, cols)
    out = _launch(NAME_BATCHED, vol, cy, cx, n_found, F, radius, rows, cols)
    launches_batched += 1 if cy.shape[0] else 0
    return out
