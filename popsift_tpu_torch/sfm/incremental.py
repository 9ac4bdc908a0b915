"""Incremental structure-from-motion reconstruction.

Port of :mod:`popsift_tpu.sfm.incremental`. Host orchestration (which
image to register next) drives batched device-side solvers: two-view
RANSAC for the seed pair (twoview.py), PnP RANSAC for registration
(pnp.py), batched DLT triangulation, and Schur-complement BA (ba.py),
all on ``IncrementalSfM``'s device. The host bookkeeping is the JAX
package's numpy, line for line: the image-track incidence built once as
a sparse CSR matrix (seed co-visibility = one sparse matmul), per-image
reconstructed-point counts maintained incrementally, observation
packing for BA by NumPy indexing, and the padding of every device batch
to a power of two (and to ``pnp_chunk`` images), which keeps the shapes,
and so the sample draws, those of the JAX driver. Each device result is
read back (``.cpu().numpy()``) where the JAX driver calls
``np.asarray``. The reconstruction state is checkpointable at every
milestone (checkpoint.py).

Random draws. The JAX driver keeps a ``PRNGKey`` and splits it once per
device call (``_next_key``). No torch generator reproduces threefry, so
this driver keeps a ``torch.Generator`` seeded from ``seed`` and draws
every RANSAC's sample ranks through one method, :meth:`IncrementalSfM._draw`
(its counterpart of ``_next_key``), at the shape the call needs: [512, 8]
for a seed pair, [pnp_chunk, 256, 6] for a PnP chunk, [32, 512, 8] for a
chunk of view-graph edges (global_sfm.py). A test replays JAX's key
chain by overriding that method. The generator lives on the host, so a
run on the card and a run on the CPU from the same seed draw the same
ranks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.f32 import full_f32
from .ba import bundle_adjust, problem_from_numpy
from .pnp import ransac_pnp_batch
from .rotation import exp_so3, hat, log_so3
from .tracks import Tracks
from .twoview import (draw_ranks, ransac_essential, recover_pose,
                      refine_pose, triangulate, triangulate_rows)

# hypotheses of each RANSAC the driver runs (the JAX entries' defaults)
ESSENTIAL_HYPOTHESES = 512
PNP_HYPOTHESES = 256


@dataclass
class Reconstruction:
    """Mutable host-side reconstruction state (cams map world->camera)."""

    intr: np.ndarray                       # fx fy cx cy (shared)
    cam_R: dict = field(default_factory=dict)    # img -> [3,3]
    cam_t: dict = field(default_factory=dict)    # img -> [3]
    points: dict = field(default_factory=dict)   # track -> [3]
    registered: list = field(default_factory=list)

    def normalized(self, uv: np.ndarray) -> np.ndarray:
        fx, fy, cx, cy = self.intr
        return np.stack([(uv[..., 0] - cx) / fx,
                         (uv[..., 1] - cy) / fy], axis=-1)


class _PointView:
    """Dict-like view over the dense (xyz, known) point arrays.

    ``IncrementalSfM`` keeps reconstructed points in a dense
    ``f32[n_tracks, 3]`` array + boolean mask so the hot paths
    (triangulation, BA packing, culling) are pure array indexing; this
    view preserves the original ``rec.points`` mapping interface for
    the checkpoint/export/eval consumers. Iteration yields track ids
    in ascending order (what every consumer's ``sorted()`` produced).
    """

    def __init__(self, xyz: np.ndarray, known: np.ndarray):
        self._xyz = xyz
        self._known = known

    def __getitem__(self, tr):
        if not self._known[tr]:
            raise KeyError(tr)
        return self._xyz[tr]

    def __setitem__(self, tr, v):
        self._xyz[tr] = v
        self._known[tr] = True

    def __delitem__(self, tr):
        if not self._known[tr]:
            raise KeyError(tr)
        self._known[tr] = False

    def __contains__(self, tr):
        return bool(0 <= int(tr) < len(self._known)
                    and self._known[int(tr)])

    def __iter__(self):
        return iter(int(t) for t in np.flatnonzero(self._known))

    def __len__(self):
        return int(self._known.sum())

    def keys(self):
        return list(self)

    def items(self):
        return ((int(t), self._xyz[t])
                for t in np.flatnonzero(self._known))


def _pad(a, n, fill=0):
    a = np.asarray(a)
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[:len(a)] = a
    return out


class IncrementalSfM:
    """Incremental reconstruction driver.

    Usage::

        sfm = IncrementalSfM(tracks, intrinsics, device="cuda")
        sfm.initialize()          # best seed pair
        while sfm.register_next():
            pass
        sfm.global_ba()

    Takes every argument of the JAX driver, plus ``device`` (``"cuda"``
    by default; asking for it without a card raises), where every device
    call runs.
    """

    def __init__(self, tracks: Tracks, intr, seed: int = 0,
                 min_pnp_points: int = 8, reproj_thresh: float = 2e-4,
                 ba_every: int = 3, checkpoint_dir: str | None = None,
                 register_batch: int = 1, pnp_chunk: int = 16,
                 local_ba_window: int = 0, ba_growth: float = 0.0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.tracks = tracks
        self.rec = Reconstruction(intr=np.asarray(intr, np.float32))
        self.generator = torch.Generator().manual_seed(seed)
        self.min_pnp_points = min_pnp_points
        self.reproj_thresh = reproj_thresh
        self.ba_every = ba_every
        self.checkpoint_dir = checkpoint_dir
        self.register_batch = max(1, int(register_batch))
        self.pnp_chunk = max(1, int(pnp_chunk))
        # > 0: run windowed local BA after every registration batch
        # between the (now affordable-rare) global BAs
        self.local_ba_window = int(local_ba_window)
        # > 1: COLMAP-style geometric global-BA schedule — a full BA
        # (10 iters) whenever the registered count grows by this factor
        # since the last one, with ba_every as the most registrations
        # between two
        self.ba_growth = float(ba_growth)
        self._next_global_ba = 0
        self._since_ba = 0
        self._last_rescue_nreg = -1  # registrations at the last drift rescue

        t = tracks
        self.images = sorted(set(int(i) for i in t.image_id))
        self._img_pos = {img: k for k, img in enumerate(self.images)}
        # per-image observation rows + track-sorted views (built once;
        # _obs_uv and _common_tracks are then pure searchsorted)
        self._rows = {}
        self._img_tracks = {}
        self._img_rows_sorted = {}
        image_id = np.asarray(t.image_id)
        track_id = np.asarray(t.track_id, np.int64)
        for img in self.images:
            rows = np.nonzero(image_id == img)[0]
            self._rows[img] = rows
            tr = track_id[rows]
            o = np.argsort(tr, kind="stable")
            self._img_tracks[img] = tr[o]
            self._img_rows_sorted[img] = rows[o]
        self._n_tracks = int(track_id.max()) + 1 if len(track_id) else 0
        # track -> observing-image positions (CSR over sorted track ids)
        order = np.argsort(track_id, kind="stable")
        self._tr_sorted = track_id[order]
        self._tr_rows = order                 # original observation rows
        self._tr_img_pos = np.asarray(
            [self._img_pos[int(i)] for i in image_id[order]], np.int64)
        self._tr_ptr = np.searchsorted(self._tr_sorted,
                                       np.arange(self._n_tracks + 1))
        # incremental registration state
        self._pt_known = np.zeros(self._n_tracks, bool)
        self._seen = np.zeros(len(self.images), np.int64)
        self._reg_mask = np.zeros(len(self.images), bool)
        # dense point storage; rec.points is a mapping view over it
        self._pts = np.zeros((self._n_tracks, 3), np.float32)
        self.rec.points = _PointView(self._pts, self._pt_known)

    # -- helpers -----------------------------------------------------------

    def _draw(self, valid: torch.Tensor, n_hyp: int,
              min_set: int) -> torch.Tensor:
        """Sample ranks for one device call's RANSAC: i64[..., n_hyp,
        min_set] over the valid rows of each row of ``valid`` [..., N],
        from the driver's generator (the JAX driver's ``_next_key``)."""
        return draw_ranks(self.generator, valid, n_hyp, min_set)

    def _dev(self, a) -> torch.Tensor:
        """A numpy array as a tensor on the driver's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _common_tracks(self, a: int, b: int):
        return np.intersect1d(self._img_tracks[a], self._img_tracks[b])

    def _obs_uv(self, img: int, track_ids):
        """uv of given tracks in the given image (must exist)."""
        tr = self._img_tracks[img]
        idx = np.searchsorted(tr, np.asarray(track_ids, np.int64))
        return self.tracks.uv[self._img_rows_sorted[img][idx]]

    def _spans_flat(self, track_ids):
        """Concatenate the CSR observation spans of ``track_ids``.

        Returns (flat, seg): ``flat`` indexes the track-sorted
        observation arrays (``_tr_img_pos`` / ``_tr_rows``); ``seg[k]``
        is the position in ``track_ids`` owning entry k. Pure NumPy —
        no per-track Python loop."""
        track_ids = np.asarray(track_ids, np.int64)
        starts = self._tr_ptr[track_ids]
        cnt = self._tr_ptr[track_ids + 1] - starts
        total = int(cnt.sum())
        seg = np.repeat(np.arange(len(track_ids)), cnt)
        off = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        return starts[seg] + off, seg

    def _add_points(self, track_ids, X):
        """Record new 3-D points and update the per-image seen counts."""
        track_ids = np.asarray(track_ids, np.int64)
        fresh = ~self._pt_known[track_ids]
        track_ids, X = track_ids[fresh], np.asarray(X)[fresh]
        self._pts[track_ids] = X
        self._pt_known[track_ids] = True
        if len(track_ids):
            flat, _ = self._spans_flat(track_ids)
            np.add.at(self._seen, self._tr_img_pos[flat], 1)

    def _drop_points(self, track_ids):
        """Remove points and roll back the per-image seen counts."""
        track_ids = np.asarray(track_ids, np.int64)
        track_ids = track_ids[self._pt_known[track_ids]]
        self._pt_known[track_ids] = False
        if len(track_ids):
            flat, _ = self._spans_flat(track_ids)
            np.add.at(self._seen, self._tr_img_pos[flat], -1)

    def cull_points(self, max_err_px: float = 4.0) -> int:
        """Drop points whose WORST reprojection error over the
        registered observations exceeds ``max_err_px`` pixels.
        Returns the number of points dropped (the COLMAP-style post-BA
        observation filter)."""
        from .ba import residuals

        prob, cam_ids, track_ids = self.as_ba_problem()
        track_ids = np.asarray(track_ids, np.int64)
        if len(track_ids) == 0:
            return 0
        r = residuals(prob).cpu().numpy()
        err = np.sqrt((r ** 2).sum(1))
        worst = np.zeros(len(track_ids), np.float32)
        np.maximum.at(worst, prob.obs_pt.cpu().numpy(), err)
        bad = track_ids[worst > max_err_px]
        self._drop_points(bad)
        return len(bad)

    def refine(self, rounds: int = 2, max_err_px: float = 4.0,
               ba_iters: int = 8, huber_delta: float | None = 2.0):
        """Iterative refinement: robust BA -> cull gross points ->
        retriangulate their tracks -> repeat. Cleans up the structure
        drift a long incremental run accumulates."""
        from .global_sfm import _triangulate_all

        costs = None
        for _ in range(rounds):
            costs = self.global_ba(iters=ba_iters, huber_delta=huber_delta)
            n_bad = self.cull_points(max_err_px)
            _triangulate_all(self)
            if len(self.rec.points) == 0:
                # every track failed the cull AND re-triangulation — the
                # model is beyond local repair; surface the last BA
                # costs instead of failing on an empty BA problem
                return costs
            if n_bad == 0:
                break
        return self.global_ba(iters=ba_iters, huber_delta=huber_delta)

    def _mark_registered(self, img: int):
        self._reg_mask[self._img_pos[img]] = True
        self.rec.registered.append(img)

    def _sync_from_rec(self):
        """Rebuild the incremental index state from ``self.rec``
        (after resume or external mutation). A plain-dict ``points``
        (e.g. loaded by checkpoint.load_reconstruction) is migrated
        into the dense array storage and replaced by the view."""
        if not isinstance(self.rec.points, _PointView):
            items = list(self.rec.points.items())
            self._pt_known[:] = False
            self._pts[:] = 0.0
            self.rec.points = _PointView(self._pts, self._pt_known)
            if items:
                ids = np.asarray([int(t) for t, _ in items], np.int64)
                self._pts[ids] = np.stack([v for _, v in items])
                self._pt_known[ids] = True
        self._reg_mask[:] = False
        for img in self.rec.registered:
            self._reg_mask[self._img_pos[img]] = True
        for k, img in enumerate(self.images):
            self._seen[k] = int(np.count_nonzero(
                self._pt_known[self._img_tracks[img]]))

    # -- phases ------------------------------------------------------------

    @full_f32()
    def _solve_pair(self, a: int, b: int):
        """Two-view solve for a candidate seed pair: essential RANSAC,
        pose recovery, essential-manifold GN refinement, cheirality
        re-decomposition, triangulation, and point acceptance.

        Returns (R2, t2, common, good, X, score) or None if the pair is
        unusable. score = accepted points x median triangulation angle
        (capped at 5 deg): co-visibility alone picks ADJACENT frames of
        a sequence, whose near-zero baseline triangulates quasi-infinite
        depths."""
        common = self._common_tracks(a, b)
        if len(common) < 8:
            return None
        xa = self.rec.normalized(self._obs_uv(a, common))
        xb = self.rec.normalized(self._obs_uv(b, common))
        N = len(common)
        cap = max(64, 1 << (N - 1).bit_length())
        valid = self._dev(np.arange(cap) < N)
        xap, xbp = self._dev(_pad(xa, cap)), self._dev(_pad(xb, cap))
        res = ransac_essential(
            None, xap, xbp, valid, thresh=self.reproj_thresh,
            ranks=self._draw(valid, ESSENTIAL_HYPOTHESES, 8))
        R2, t2, good = recover_pose(res.model, xap, xbp,
                                    valid & res.inliers)
        # GN polish on the essential manifold: the 8-point translation
        # direction is several degrees off at typical noise. The Sampson
        # objective is sign-blind in t, so re-run the cheirality
        # decomposition on the refined E to re-pick the
        # in-front-of-both-cameras (R, t) and refresh ``good``.
        R2, t2 = refine_pose(R2, t2, xap, xbp, valid & res.inliers)
        R2, t2, good = recover_pose(hat(t2) @ R2, xap, xbp,
                                    valid & res.inliers)
        eye = torch.eye(3, device=self.device)
        X = triangulate(eye, torch.zeros(3, device=self.device), R2, t2,
                        xap, xbp).cpu().numpy()[:N]
        R2, t2 = R2.cpu().numpy(), t2.cpu().numpy()
        good = good.cpu().numpy()[:N] & self._accept_points(
            X, [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                 xa), (R2, t2, xb)])
        if not good.any():
            return None
        # triangulation angle between the two observation rays
        C2 = -(R2.T @ t2)
        r1 = X[good] / np.maximum(
            np.linalg.norm(X[good], axis=1, keepdims=True), 1e-12)
        d2 = X[good] - C2
        r2 = d2 / np.maximum(np.linalg.norm(d2, axis=1, keepdims=True),
                             1e-12)
        ang = np.degrees(np.arccos(np.clip((r1 * r2).sum(1), -1, 1)))
        score = float(good.sum()) * min(float(np.median(ang)), 5.0)
        return R2, t2, common, good, X, score

    def initialize(self, pair=None, top_k: int = 8) -> tuple:
        """Pick (or accept) a seed pair, estimate relative pose, and
        triangulate the shared tracks. Returns the pair used.

        The candidate search is one sparse co-visibility matmul M @ M.T
        over the [images x tracks] incidence (scipy CSR); the ``top_k``
        most co-visible pairs are then two-view-solved and scored by
        inliers x triangulation angle (:meth:`_solve_pair`)."""
        if pair is None:
            import scipy.sparse as sp
            I = len(self.images)
            rows = np.concatenate(
                [np.full(len(self._img_tracks[img]), k, np.int64)
                 for k, img in enumerate(self.images)])
            cols = np.concatenate(
                [self._img_tracks[img] for img in self.images])
            M = sp.csr_matrix(
                (np.ones(len(rows), np.int32), (rows, cols)),
                shape=(I, self._n_tracks))
            C = (M @ M.T).toarray()
            C[np.tril_indices(I)] = -1         # j > i only
            flat = C.ravel()
            k = min(top_k, int((flat >= 8).sum()))
            if k == 0:
                raise ValueError("no image pair shares >= 8 tracks")
            top = np.argpartition(flat, -k)[-k:]
            cands = [tuple(np.unravel_index(t, C.shape)) for t in top]
            cands = [(self.images[i], self.images[j]) for i, j in cands]
        else:
            cands = [tuple(pair)]

        best = None
        for (a, b) in cands:
            sol = self._solve_pair(a, b)
            if sol is not None and (best is None or sol[5] > best[1][5]):
                best = ((a, b), sol)
        if best is None:
            raise ValueError("seed pair shares fewer than 8 tracks")
        (a, b), (R2, t2, common, good, X, _) = best

        self.rec.cam_R[a] = np.eye(3, dtype=np.float32)
        self.rec.cam_t[a] = np.zeros(3, np.float32)
        self.rec.cam_R[b] = R2
        self.rec.cam_t[b] = t2
        self._mark_registered(a)
        self._mark_registered(b)
        self._add_points(np.asarray(common)[good], X[good])
        self._checkpoint("init")
        return (a, b)

    def _pnp_eval_chunk(self, imgs: list) -> list:
        """One batched-RANSAC device call evaluating PnP for several
        candidate images against the CURRENT point snapshot. Returns
        [(R, t, n_inliers)] per image. The batch is padded to
        ``pnp_chunk`` rows and a power-of-two point capacity, as the
        JAX driver pads it."""
        data = []
        for img in imgs:
            trs = self._img_tracks[img]
            known = self._pt_known[trs]
            sel_tr = trs[known]
            X = self._pts[sel_tr]
            uv = self.tracks.uv[self._img_rows_sorted[img][known]]
            data.append((X, self.rec.normalized(uv)))
        n_max = max(len(X) for X, _ in data)
        cap = max(64, 1 << (n_max - 1).bit_length())
        B = self.pnp_chunk
        Xp = np.zeros((B, cap, 3), np.float32)
        xp = np.zeros((B, cap, 2), np.float32)
        vp = np.zeros((B, cap), bool)
        for i, (X, x) in enumerate(data):
            Xp[i, :len(X)] = X
            xp[i, :len(x)] = x
            vp[i, :len(X)] = True
        valid = self._dev(vp)
        res = ransac_pnp_batch(None, self._dev(Xp), self._dev(xp), valid,
                               thresh=self.reproj_thresh,
                               ranks=self._draw(valid, PNP_HYPOTHESES, 6))
        R = res.R.cpu().numpy()
        t = res.t.cpu().numpy()
        ni = res.n_inliers.cpu().numpy()
        return [(R[i], t[i], int(ni[i])) for i in range(len(imgs))]

    def _register_pass(self) -> int | None:
        """One ranked sweep over the registrable candidates, stopping
        after ``register_batch`` successes. Unlike a fixed top-K batch,
        a sweep does not give up just because the K highest-covisibility
        candidates fail PnP. Candidates are PnP-evaluated ``pnp_chunk``
        at a time in one device call; every passing candidate in a chunk
        registers off the shared point snapshot."""
        seen = np.where(self._reg_mask, -1, self._seen)
        cand_pos = np.nonzero(seen >= self.min_pnp_points)[0]
        if len(cand_pos) == 0:
            return None
        # highest count first; ties broken toward the larger image id
        order = np.lexsort((-cand_pos, -seen[cand_pos]))
        cands = cand_pos[order]
        last = None
        n_ok = 0
        for c0 in range(0, len(cands), self.pnp_chunk):
            chunk = cands[c0:c0 + self.pnp_chunk]
            results = self._pnp_eval_chunk(
                [self.images[p] for p in chunk])
            for pos, (R, t, n_inl) in zip(chunk, results):
                if n_inl < self.min_pnp_points:
                    continue
                img = self.images[pos]
                self.rec.cam_R[img] = R
                self.rec.cam_t[img] = t
                self._mark_registered(img)
                self._triangulate_new(img)
                self._since_ba += 1
                last = img
                n_ok += 1
                if n_ok >= self.register_batch:
                    return last
        return last

    def register_next(self) -> int | None:
        """Register the unregistered image(s) seeing the most
        reconstructed points (PnP RANSAC), then triangulate their new
        tracks. Registers up to ``register_batch`` images per call.
        Returns the last image id registered, or None when no image can
        be registered.

        When EVERY candidate fails, one drift rescue runs (robust BA +
        full retriangulation) and the sweep retries once; the rescue
        repeats only if registrations were gained since the previous
        one, so a truly unregistrable tail still terminates. No rescue
        runs once every image is registered."""
        last = self._register_pass()
        if last is None:
            nreg = len(self.rec.registered)
            if (nreg and not self._reg_mask.all()
                    and nreg != self._last_rescue_nreg):
                self._last_rescue_nreg = nreg
                self.global_ba(iters=6, huber_delta=2.0)
                from .global_sfm import _triangulate_all
                _triangulate_all(self)
                self._since_ba = 0
                last = self._register_pass()
        if last is None:
            return None
        nreg = len(self.rec.registered)
        if self.ba_growth > 1.0:
            # geometric growth with ba_every as the MAX spacing
            if nreg >= self._next_global_ba:
                self.global_ba(iters=10)
                self._since_ba = 0
                self._next_global_ba = min(
                    max(int(nreg * self.ba_growth), nreg + 1),
                    nreg + max(self.ba_every, 1))
            elif self.local_ba_window > 0:
                self.local_ba(window=self.local_ba_window)
        elif self._since_ba >= self.ba_every:
            self.global_ba(iters=4)
            self._since_ba = 0
        elif self.local_ba_window > 0:
            self.local_ba(window=self.local_ba_window)
        self._checkpoint(f"reg-{last}")
        return last

    def _triangulate_new(self, img: int):
        """Triangulate tracks newly observable from ``img``.

        ONE co-visibility pass over the CSR track index picks, for each
        not-yet-reconstructed track of ``img``, a registered partner
        observation; all tracks are then triangulated in a single
        per-row-pose device call (:func:`triangulate_rows`). Tracks the
        acceptance gate rejects get one retry against a different
        partner."""
        trs = self._img_tracks[img]
        new = trs[~self._pt_known[trs]]
        if len(new) == 0:
            return
        my_pos = self._img_pos[img]
        flat, seg = self._spans_flat(new)
        pos = self._tr_img_pos[flat]
        usable = self._reg_mask[pos] & (pos != my_pos)

        xb_all = self.rec.normalized(self._obs_uv(img, new))
        Rb = np.asarray(self.rec.cam_R[img], np.float32)
        tb = np.asarray(self.rec.cam_t[img], np.float32)

        done = np.zeros(len(new), bool)
        for pick in ("first", "last"):
            sel = np.flatnonzero(usable & ~done[seg])
            if len(sel) == 0:
                break
            if pick == "last":
                sel = sel[::-1]
            # one observation per track: first occurrence per segment
            segs, first = np.unique(seg[sel], return_index=True)
            obs = flat[sel[first]]              # CSR entry per track
            part_pos = self._tr_img_pos[obs]
            xa = self.rec.normalized(
                self.tracks.uv[self._tr_rows[obs]])
            xb = xb_all[segs]
            Ra = np.stack([self.rec.cam_R[self.images[p]]
                           for p in part_pos]).astype(np.float32)
            ta = np.stack([self.rec.cam_t[self.images[p]]
                           for p in part_pos]).astype(np.float32)
            N = len(segs)
            cap = max(16, 1 << (N - 1).bit_length())
            Rap = _pad(Ra, cap)
            Rap[N:] = np.eye(3, dtype=np.float32)  # keep pad rows sane
            X = triangulate_rows(
                self._dev(Rap),
                self._dev(_pad(ta, cap)),
                self._dev(np.repeat(Rb[None], cap, axis=0)),
                self._dev(np.repeat(tb[None], cap, axis=0)),
                self._dev(_pad(xa, cap)),
                self._dev(_pad(xb, cap))).cpu().numpy()[:N]
            keep = self._accept_points_rows(
                X, [(Ra, ta, xa),
                    (np.broadcast_to(Rb, (N, 3, 3)), tb, xb)])
            self._add_points(new[segs[keep]], X[keep])
            done[segs] = True    # retried at most once with a new pick
            done[segs[~keep]] = False
            # a track whose only usable partner was tried is done
            if pick == "last":
                break

    def _accept_points_rows(self, X, views, mult: float = 9.0):
        """Row-batched form of :meth:`_accept_points`: each view is
        (R [N,3,3] or [3,3]-broadcast, t [N,3] or [3], x [N,2])."""
        thr = mult * self.reproj_thresh
        keep = np.ones(len(X), bool)
        for R, t, x in views:
            R = np.asarray(R, np.float64)
            t = np.asarray(t, np.float64)
            if R.ndim == 2:
                R = np.broadcast_to(R, (len(X), 3, 3))
            if t.ndim == 1:
                t = np.broadcast_to(t, (len(X), 3))
            Xc = np.einsum("nij,nj->ni", R, X) + t
            z = Xc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                proj = Xc[:, :2] / z[:, None]
                err = ((proj - np.asarray(x)[:len(X)]) ** 2).sum(1)
            keep &= (z > 0) & np.isfinite(err) & (err < thr)
        return keep

    def _accept_points(self, X, views, mult: float = 9.0):
        """Point-acceptance gate: cheirality AND reprojection agreement
        in every view. Near-parallel rays triangulate to quasi-infinite
        depths that pass a bare z>0 test but wreck later PnP and
        overflow the f32 BA normal equations; the reprojection gate (3x
        the RANSAC inlier distance by default; ``mult`` is the
        squared-distance multiplier, loosened by the global-SfM
        bootstrap whose camera positions are pre-BA estimates) removes
        them at creation."""
        thr = mult * self.reproj_thresh    # squared normalized coords
        keep = np.ones(len(X), bool)
        for R, t, x in views:
            Xc = X @ np.asarray(R).T + np.asarray(t)
            z = Xc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                proj = Xc[:, :2] / z[:, None]
                err = ((proj - np.asarray(x)[:len(X)]) ** 2).sum(1)
            keep &= (z > 0) & np.isfinite(err) & (err < thr)
        return keep

    def as_ba_problem(self, cam_ids=None, track_mask=None,
                      fixed_mask=None) -> tuple:
        """Pack the current reconstruction into a BAProblem on the
        driver's device (pure NumPy indexing — no Python
        per-observation loop). Returns (problem, cam_ids, track_ids).

        ``cam_ids``/``track_mask``/``fixed_mask`` restrict the problem
        to a sub-reconstruction (``local_ba``'s window): only
        observations of selected cameras on masked tracks enter, and
        ``fixed_mask[i]`` pins camera ``cam_ids[i]`` (anchor cameras
        outside the optimization window)."""
        if cam_ids is None:
            cam_ids = list(self.rec.registered)
        if track_mask is None:
            track_ids = np.asarray(sorted(self.rec.points), np.int64)
        else:
            track_ids = np.nonzero(self._pt_known & track_mask)[0]

        t = self.tracks
        oc, op, ouv = [], [], []
        for ci, img in enumerate(cam_ids):
            trs = self._img_tracks[img]
            m = self._pt_known[trs]
            if track_mask is not None:
                m = m & track_mask[trs]
            sel = trs[m]
            oc.append(np.full(len(sel), ci, np.int32))
            op.append(np.searchsorted(track_ids, sel).astype(np.int32))
            ouv.append(t.uv[self._img_rows_sorted[img][m]])
        oc = np.concatenate(oc)
        op = np.concatenate(op)
        ouv = np.concatenate(ouv).astype(np.float32)
        # ONE batched log map for all cameras
        R_all = np.stack([self.rec.cam_R[c] for c in cam_ids])
        rvec = log_so3(self._dev(R_all.astype(np.float32))).cpu().numpy()
        t_all = np.stack([self.rec.cam_t[c] for c in cam_ids])
        cams = np.concatenate([rvec, t_all], axis=1).astype(np.float32)
        pts = self._pts[track_ids].astype(np.float32)
        if fixed_mask is None:
            fixed = np.zeros(len(cam_ids), bool)
            fixed[0] = True
        else:
            fixed = np.asarray(fixed_mask, bool)

        prob = problem_from_numpy(dict(
            cams=cams, points=pts, intr=self.rec.intr, obs_cam=oc,
            obs_pt=op, obs_uv=ouv, obs_valid=np.ones(len(oc), bool),
            cam_fixed=fixed), self.device)
        return prob, cam_ids, [int(tr) for tr in track_ids]

    def local_ba(self, window: int = 25, iters: int = 6,
                 huber_delta: float | None = None):
        """Windowed bundle adjustment over the most recently registered
        cameras (COLMAP-style local BA): the last ``window`` cameras and
        every point they observe are optimized; OTHER registered cameras
        observing those points join the problem FIXED, anchoring the
        window's gauge to the rest of the model.

        The anchor set is every registered camera outside the window that
        observes any of the window's points, as the JAX driver builds it
        (incremental.py:716-722). On long tracks that set grows with the
        number of registered cameras, so the per-registration cost is
        not the O(window) that COLMAP's local BA has; the behaviour is
        kept for parity with the JAX package."""
        reg = self.rec.registered
        sel = reg[-window:]
        if len(sel) < 2:
            return None
        sel_set = set(sel)
        # tracks seen by the window
        track_mask = np.zeros(len(self._pt_known), bool)
        for img in sel:
            trs = self._img_tracks[img]
            track_mask[trs[self._pt_known[trs]]] = True
        if not track_mask.any():
            return None
        # anchor cameras: registered, outside the window, observing a
        # masked track (found via the CSR track->observation spans)
        flat, _ = self._spans_flat(np.nonzero(track_mask)[0])
        obs_pos = np.unique(self._tr_img_pos[flat])
        anchors = [self.images[k] for k in obs_pos
                   if self._reg_mask[k] and self.images[k] not in sel_set]
        cam_ids = anchors + list(sel)
        fixed = np.zeros(len(cam_ids), bool)
        fixed[:len(anchors)] = True
        if not len(anchors):
            fixed[0] = True                     # gauge anchor
        prob, cam_ids, track_ids = self.as_ba_problem(
            cam_ids=cam_ids, track_mask=track_mask, fixed_mask=fixed)
        out, costs = bundle_adjust(prob, iters=iters,
                                   huber_delta=huber_delta)
        cams = out.cams.cpu().numpy()
        pts = out.points.cpu().numpy()
        R_all = exp_so3(out.cams[:, :3]).cpu().numpy()
        for i, c in enumerate(cam_ids):
            if fixed[i]:
                continue
            self.rec.cam_R[c] = R_all[i]
            self.rec.cam_t[c] = cams[i, 3:]
        self._pts[np.asarray(track_ids, np.int64)] = pts
        return costs

    def global_ba(self, iters: int = 10, huber_delta: float | None = None,
                  refine_intrinsics: bool = False, intr_mask=None):
        """Full-reconstruction LM bundle adjustment. Returns the costs
        (numpy f32[iters]).

        ``refine_intrinsics`` also optimizes the shared (fx, fy, cx, cy)
        block (ba.py::intr_step; ``intr_mask`` restricts components,
        e.g. (1, 1, 0, 0) for focal only) and writes the refined values
        back to ``rec.intr`` — so COLMAP export and later registrations
        use them."""
        prob, cam_ids, track_ids = self.as_ba_problem()
        out, costs = bundle_adjust(prob, iters=iters,
                                   huber_delta=huber_delta,
                                   opt_intr=refine_intrinsics,
                                   intr_mask=intr_mask)
        if refine_intrinsics:
            self.rec.intr = out.intr.cpu().numpy().astype(np.float32)
        cams = out.cams.cpu().numpy()
        pts = out.points.cpu().numpy()
        R_all = exp_so3(out.cams[:, :3]).cpu().numpy()
        for i, c in enumerate(cam_ids):
            self.rec.cam_R[c] = R_all[i]
            self.rec.cam_t[c] = cams[i, 3:]
        ids = np.asarray(track_ids, np.int64)
        self._pts[ids] = pts
        self._checkpoint("ba")
        return costs.cpu().numpy()

    def _checkpoint(self, tag: str):
        if self.checkpoint_dir is None:
            return
        from .checkpoint import save_reconstruction
        save_reconstruction(self.checkpoint_dir, self.rec, tag=tag)

    @classmethod
    def resume(cls, tracks: Tracks, checkpoint_dir: str, seed: int = 0,
               **kw) -> "IncrementalSfM":
        """Restart a killed run from the LATEST checkpoint.

        The reconstruction state (cameras, points, registered set) is
        restored; ``register_next``/``global_ba`` then continue where
        the crashed process left off (with a generator seeded afresh
        from ``seed``). ``kw`` takes the constructor's other arguments,
        ``device`` among them."""
        from .checkpoint import load_reconstruction
        rec = load_reconstruction(checkpoint_dir)
        sfm = cls(tracks, rec.intr, seed=seed,
                  checkpoint_dir=checkpoint_dir, **kw)
        sfm.rec = rec
        sfm._sync_from_rec()
        return sfm
