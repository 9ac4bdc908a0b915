"""popsift_tpu_torch/tools/step_spread.py and the gaps it shares with
tests/test_torch_sfm_cuda.py, on the CPU at a small size (12 cameras /
600 points).

On the CPU the "card" run is the CPU's own, so every gap between the two
is exactly 0. A reordering of the observations moves the f32 step's
largest entries (the check the GN model's norm replaced) by far more
than it moves the step in that norm, which is the property the card
test's GN-step check rests on; the f64 steps agree with each other within 1e-9.
"""

import numpy as np
import torch

from popsift_tpu_torch.sfm import ba as B
from popsift_tpu_torch.tools import step_spread
from popsift_tpu_torch.tools.step_spread import (TRANSLATION_F32_TOL, _gap,
                                                 as_f64, gn_norm_gap,
                                                 gn_steps, step_scene)

SIZE = dict(n_cams=12, n_points=600)


def test_gn_norm_gap_is_the_models_norm():
    """|d|_H^2 = |J d|^2 + lam |d|^2, relative to the reference step."""
    p = as_f64(B.problem_from_numpy(step_scene(**SIZE), "cpu"))
    Jc, Jp = B._jacobians(p)
    jac = (Jc, Jp, p.obs_cam, p.obs_pt)
    rng = np.random.default_rng(3)
    ref = (torch.from_numpy(rng.normal(size=(12, 6))),
           torch.from_numpy(rng.normal(size=(600, 3))))
    d = (torch.from_numpy(rng.normal(size=(12, 6))) * 1e-3,
         torch.from_numpy(rng.normal(size=(600, 3))) * 1e-3)
    got = (ref[0] + d[0], ref[1] + d[1])

    def h2(dc, dp):
        Jd = (np.einsum("oki,oi->ok", Jc.numpy(), dc.numpy()[p.obs_cam])
              + np.einsum("oki,oi->ok", Jp.numpy(), dp.numpy()[p.obs_pt]))
        return (Jd ** 2).sum() + 1e-3 * ((dc.numpy() ** 2).sum()
                                         + (dp.numpy() ** 2).sum())

    want = np.sqrt(h2(*d) / h2(*ref))
    assert abs(gn_norm_gap(jac, got, ref, 1e-3) - want) <= 1e-12 * want
    assert gn_norm_gap(jac, ref, ref, 1e-3) == 0.0


def test_step_spread_on_the_cpu():
    s = step_spread.main(["--device", "cpu", "--reps", "1", "--reorder",
                          "2", "--cams", "12", "--points", "600"])
    for kind in ("dense", "cg"):
        for k in ("f64_card_cpu.dc", "f64_card_cpu.dp", "card_cpu.dc",
                  "card_cpu.dp"):
            assert s[f"{kind}.{k}"] == [0.0, 0.0]
        assert s[f"{kind}.h_norm.card_f64"] == s[f"{kind}.h_norm.cpu_f64"]
        assert s[f"{kind}.h_norm.cpu_f64"][1] <= 1e-3
        # reordering moves the largest entries more than the model's norm
        assert s[f"{kind}.reordered.cpu_dc"][1] > 0.0
        assert s[f"{kind}.reordered.h_norm"][1] <= 1e-3
    for kind in ("dense", "cg"):
        assert s[f"translation.{kind}.card_cpu"] == [0.0, 0.0]
        assert s[f"translation.{kind}.card_f64"][1] <= TRANSLATION_F32_TOL


def test_f64_steps_do_not_move_with_the_order():
    """The card test holds the card's f64 step to the CPU's within 1e-9: two
    orders of the same sums give f64 steps that agree far below it."""
    fields = step_scene(**SIZE)
    perm = np.random.default_rng(1).permutation(len(fields["obs_cam"]))
    reordered = dict(fields, **{k: fields[k][perm] for k in fields
                                if k.startswith("obs_")})
    lam = torch.full((), 1e-3, dtype=torch.float64)
    for kind, step in gn_steps().items():
        a, b = (step(as_f64(B.problem_from_numpy(f, "cpu")), lam)
                for f in (fields, reordered))
        assert _gap(b[0], a[0]) <= 1e-9 and _gap(b[1], a[1]) <= 1e-9, kind
