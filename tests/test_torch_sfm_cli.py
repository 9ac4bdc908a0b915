"""popsift_tpu_torch.cli.sfm on the CPU against the JAX package.

The scene is the E2E artifact's orbital fly-around
(``tools/e2e_proof.py::render_sequence``, the copy of
scripts/e2e_proof.py's) at its smallest: 3 frames of 48 x 64. Two
frames build no track, and at 36 x 48 JAX's 11 tracks leave no pair that
shares 8, so the reconstruction cannot start; 3 x 48 x 64 builds 16.

Not slow: the port's CLI prints the same ``image``, ``retrieval
shortlist``, ``pair`` and ``tracks:`` lines as JAX's library calls give
on the same frames (k-means drawing JAX's init scores), keypoints within
the golden tolerance, and it writes the checkpoint, the COLMAP model and
the PLY. ``slow``: the whole CLI against JAX's CLI, incremental and
``--global``, with the port's RANSAC draws replaced by JAX's key chain
(tests/test_torch_incremental.py::Replay): incremental, the same lines
and BA costs within 1e-3 relative; global, the same lines up to
``tracks:``, every camera placed, ATE under 5 % on both.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.api import PopSift as JPopSift
from popsift_tpu.config import SiftConfig as JSiftConfig
from popsift_tpu.eval.repeatability import \
    strongest_descriptor_per_keypoint as jstrongest
from popsift_tpu.ops.matching import match_descriptors as jmatch
from popsift_tpu.sfm import retrieval as JR
from popsift_tpu.sfm.tracks import build_tracks
from popsift_tpu_torch.cli.sfm import main as port_sfm
from popsift_tpu_torch.cli.sfm import pad_to
from popsift_tpu_torch.io.image import write_pgm
from popsift_tpu_torch.sfm import incremental as TI
from popsift_tpu_torch.sfm import retrieval as TR
from popsift_tpu_torch.tools.e2e_proof import render_sequence

torch.set_num_threads(1)
N_FRAMES, H, W = 3, 48, 64
TOP_M = 2
HEAD = ("image ", "retrieval shortlist:", "pair (", "tracks:")


def jax_scores(n, seed=0):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))


def with_jax_scores(monkeypatch):
    """The port's k-means draws JAX's init scores (threefry, seed 0)."""
    monkeypatch.setattr(TR, "draw_scores", jax_scores)


def write_scene(d, n_frames, h, w, pick=slice(None)):
    """The sequence's frames (those ``pick`` selects) as PGM files in
    ``d``: (frames, the CLI's ``-i`` and intrinsics arguments)."""
    frames, gt, (fx, fy, cx, cy) = render_sequence(n_frames, h, w)
    frames = frames[pick]
    paths = []
    for i, fr in enumerate(frames):
        paths.append(str(d / f"frame_{i:04d}.pgm"))
        write_pgm(paths[-1], fr)
    intr = ["--fx", str(fx), "--fy", str(fy), "--cx", str(cx), "--cy",
            str(cy)]
    return frames, ["-i"] + paths + intr


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("sfm_cli")
    frames, argv = write_scene(d, N_FRAMES, H, W)
    return d, frames, argv


@pytest.fixture(scope="module")
def jax_stages(scene):
    """What JAX's library calls give on the frames, as the CLI's lines:
    extraction, the VLAD shortlist at top 2, one match a pair, tracks."""
    _, frames, _ = scene
    ps = JPopSift(JSiftConfig())
    kps, descs, lines = {}, {}, []
    for i, fr in enumerate(frames):
        kps[i], descs[i] = jstrongest(ps.enqueue(fr).get())
        lines.append(f"image {i}: {len(kps[i])} keypoints")
    todo = JR.pair_shortlist(JR.build_signatures(descs), top_m=TOP_M)
    n = len(frames)
    lines.append(f"retrieval shortlist: {len(todo)} of {n * (n - 1) // 2} "
                 f"pairs")
    cap = max(256, 1 << (max(len(d) for d in descs.values()) - 1)
              .bit_length())
    pm = {}
    for i, j in todo:
        res = jmatch(jnp.asarray(pad_to(descs[i], cap)),
                     jnp.asarray(np.arange(cap) < len(descs[i])),
                     jnp.asarray(pad_to(descs[j], cap)),
                     jnp.asarray(np.arange(cap) < len(descs[j])), ratio=0.8)
        rows = np.nonzero(np.asarray(res.accept))[0]
        pm[(i, j)] = np.stack([rows, np.asarray(res.best_idx)[rows]], 1)
        lines.append(f"pair ({i},{j}): {len(pm[(i, j)])} matches")
    tracks = build_tracks(pm, kps, min_length=2)
    lines.append(f"tracks: {tracks.n_tracks}")
    return kps, lines, tracks.n_tracks


@pytest.fixture(scope="module")
def port_run(scene):
    """The port's CLI end to end on the CPU, k-means drawing JAX's
    scores: (exit code, printed lines, output directory)."""
    import contextlib
    import io

    d, _, argv = scene
    out = d / "port"
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        with_jax_scores(mp)
        with contextlib.redirect_stdout(buf):
            rc = port_sfm(argv + [
                "--device", "cpu", "-v", "--retrieval", str(TOP_M),
                "--refine", "--export", str(out / "rec.npz"),
                "--export-colmap", str(out / "sparse"),
                "--export-ply", str(out / "cloud.ply")])
    return rc, buf.getvalue().splitlines(), out


def test_stage_lines_match_jax(port_run, jax_stages):
    """Per-image keypoint counts, the shortlist, per-pair match counts and
    the track count equal JAX's library calls on the same frames."""
    rc, lines, _ = port_run
    _, want, n_tracks = jax_stages
    assert rc == 0, lines
    assert [l for l in lines if l.startswith(HEAD)] == want
    assert n_tracks >= 8


def test_keypoints_match_jax(scene, jax_stages):
    """The port's strongest descriptor per keypoint on the CPU: the same
    keypoints as JAX's within the golden tolerance (5e-3 px)."""
    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.eval.repeatability import \
        strongest_descriptor_per_keypoint

    _, frames, _ = scene
    kps, _, _ = jax_stages
    ps = PopSift(device="cpu")
    for i, fr in enumerate(frames):
        kp, d = strongest_descriptor_per_keypoint(ps.enqueue(fr).get())
        assert kp.shape == kps[i].shape and d.shape == (len(kp), 128)
        np.testing.assert_allclose(kp, kps[i], rtol=0, atol=5e-3)


def test_cli_writes_the_model(port_run):
    rc, lines, out = port_run
    assert rc == 0
    for name in ("seed pair:", "final BA cost:", "refined BA cost:",
                 "reconstruction written to", "COLMAP model written to",
                 "PLY written to"):
        assert sum(l.startswith(name) for l in lines) == 1, name
    z = np.load(out / "rec.npz")
    assert len(z["registered"]) >= 2
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert os.path.getsize(out / "sparse" / name) > 0, name
    assert os.path.getsize(out / "cloud.ply") > 0


def test_cuda_without_a_card_raises(scene):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        port_sfm(scene[2])


COST = re.compile(r"(BA cost: )(-?[0-9.]+)")


def split_costs(lines):
    """The lines with each BA cost taken out, and the costs."""
    costs = [float(m.group(2)) for l in lines for m in [COST.search(l)] if m]
    return [COST.sub(r"\1#", l) for l in lines], costs


def run_both(tmp_path, monkeypatch, capsys, argv):
    """JAX's CLI, then the port's on the CPU drawing JAX's k-means scores
    and replaying JAX's key chain: {package: (lines with the BA costs
    taken out and the output directory named OUT, costs)}."""
    from popsift_tpu.cli.sfm import main as jax_sfm
    from test_torch_incremental import Replay

    runs = {}
    for name, main, dev in (("jax", jax_sfm, []),
                            ("port", port_sfm, ["--device", "cpu"])):
        if name == "port":
            with_jax_scores(monkeypatch)
            monkeypatch.setattr(TI, "IncrementalSfM", Replay)
        rc = main(argv + ["-v", "--export", str(tmp_path / name / "r.npz")]
                  + dev)
        out = capsys.readouterr().out.replace(str(tmp_path / name), "OUT")
        assert rc == 0, out
        runs[name] = split_costs(out.splitlines())
    return runs


@pytest.mark.slow
def test_cli_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """The whole incremental CLI against popsift_tpu.cli.sfm on the first
    6 frames of the E2E artifact's 100 (240 x 320), ``--retrieval 3
    --refine``: every printed line equal but for the paths, BA costs
    within 1e-3 relative."""
    _, argv = write_scene(tmp_path, 100, 240, 320, slice(0, 6))
    runs = run_both(tmp_path, monkeypatch, capsys,
                    argv + ["--retrieval", "3", "--refine"])
    (got, got_c), (want, want_c) = runs["port"], runs["jax"]
    assert got == want
    assert len(got_c) == len(want_c) == 2
    np.testing.assert_allclose(got_c, want_c, rtol=1e-3, atol=1e-4)


@pytest.mark.slow
def test_global_cli_against_jax_cli(tmp_path, monkeypatch, capsys):
    """``--global`` on every tenth of the artifact's first 60 frames
    (4.8 degrees apart): the lines up to ``tracks:`` equal JAX's, both
    place every camera, and the port's ATE is at most twice JAX's or 5 %
    of the trajectory, whichever is larger (``chip_smoke.py`` phase 11's
    rule for ``--global``). The points and the BA cost are not held to
    JAX's:
    the view-graph edges hold 17-28 correspondences, so most of each
    RANSAC's 8-row samples (drawn with replacement) repeat a row, and a
    rank-deficient 8-point system's null vector is whatever its SVD
    returns: from the same ranks, XLA's and torch's CPU SVDs give other
    hypotheses, other inlier sets and relative rotations up to 2 apart
    (max |R - R'|) on four of 15 edges (ROADMAP C)."""
    from popsift_tpu_torch.tools.e2e_proof import ate_report

    _, argv = write_scene(tmp_path, 100, 240, 320, slice(0, 60, 10))
    runs = run_both(tmp_path, monkeypatch, capsys,
                    argv + ["--global", "--min-covis", "8"])
    (got, _), (want, _) = runs["port"], runs["jax"]
    head = lambda lines: [l for l in lines if l.startswith(HEAD)]
    assert head(got) == head(want) and len(head(got)) == 6 + 15 + 1
    cams = lambda lines: [l.split(",")[0] for l in lines
                          if l.startswith("global SfM:")]
    assert cams(got) == cams(want) == ["global SfM: 6/6 cameras"]
    gt = render_sequence(100, 240, 320)[1][0:60:10]
    ate = {name: ate_report(str(tmp_path / name / "r.npz"), gt)
           for name in ("jax", "port")}
    assert ate["jax"]["registered"] == ate["port"]["registered"] == 6
    assert ate["port"]["rmse_pct_of_traj"] <= max(
        2 * ate["jax"]["rmse_pct_of_traj"], 5.0), ate
