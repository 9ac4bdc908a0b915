"""Roofline arithmetic for bundle adjustment on BAL problems: the least
time one NVIDIA H100 SXM could take for the Levenberg-Marquardt
iterations of one problem, counted as a sparse Schur-complement solver
needs the work, from the counts the reference sees (``reference/bal.py``:
the observations, each point's track, the cameras). The count is the
same whatever implements the step, so a dense camera-point coupling's
zero blocks are waste, not work.

An iteration, f32 operations (a multiply-add is two):

* each observation: the projection, its residual and the analytic
  Jacobians (``OPS_LINEARIZE``, from the reference's formulas), its
  normal-equation blocks Jc^T Jc, Jp^T Jp, W = Jc^T Jp and the two
  gradients (``OPS_BLOCKS``), W Hpp^-1 (9 x 3 x 3), the back-substitution
  W^T dc (9 x 3) and the trial projection with its residual
  (``OPS_TRIAL``);
* each point: the damped 3 x 3 inverse (``OPS_INV3``) and Hpp^-1 times
  its right-hand side;
* each ordered pair of observations in a track: one 9 x 3 . 3 x 9 block
  product of the reduced camera system;
* the solve of the reduced camera system, (9 Nc)^3 / 3 (Cholesky).

Bytes of an iteration: the observations read (two i32 indices and two
f32 pixels), the cameras and points read and written in f32, and the
reduced camera system written and read once.
"""

from __future__ import annotations

from .bounds import bound_s

CAM = 9                       # BAL's camera block: rotvec, t, f, k1, k2
OPS_LINEARIZE = 200           # projection, residual, Jc [2, 9], Jp [2, 3]
OPS_BLOCKS = 2 * 2 * (CAM * CAM + 3 * 3 + CAM * 3 + CAM + 3)
OPS_TRIAL = 40 + 6            # trial projection, residual, its square
OPS_INV3 = 50


def iteration_ops(n_cams: int, n_points: int, n_obs: int,
                  n_pairs: int) -> float:
    """f32 operations of one LM iteration (module docstring);
    ``n_pairs`` counts every ordered pair of a track's observations, a
    pair of one observation with itself included (sum of the squared
    track lengths)."""
    per_obs = (OPS_LINEARIZE + OPS_BLOCKS + 2 * CAM * 3 * 3
               + 2 * CAM * 3 + OPS_TRIAL)
    per_point = OPS_INV3 + 2 * 3 * 3
    return (n_obs * per_obs + n_points * per_point
            + n_pairs * 2 * CAM * CAM * 3 + (CAM * n_cams) ** 3 / 3.0)


def iteration_bytes(n_cams: int, n_points: int, n_obs: int) -> float:
    """Bytes of one LM iteration (module docstring)."""
    return (n_obs * (4 + 4 + 8) + 2 * 4 * (CAM * n_cams + 3 * n_points)
            + 2 * 4 * (CAM * n_cams) ** 2)


def ba_bound(n_cams: int, n_points: int, n_obs: int, n_pairs: int,
             iters: int) -> float:
    """Seconds of ``iters`` LM iterations of one problem at the H100's
    rates (``bounds.bound_s``: bytes or f32 operations, the larger),
    iteration by iteration."""
    return iters * bound_s(iteration_bytes(n_cams, n_points, n_obs),
                           iteration_ops(n_cams, n_points, n_obs, n_pairs))
