"""The port's restartable batch job and its CLI on the CPU, against the
JAX package's job (tests/test_batchjob.py is the pattern): five 48x64
PGM frames, ``batch=3`` (one batched run of three frames, then two),
manifest counts equal to the JAX job's, and a re-run that recomputes
nothing."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu.runtime.batchjob import BatchExtractJob as JaxBatchJob
from popsift_tpu_torch.cli import batch as batch_cli
from popsift_tpu_torch.runtime.batchjob import BatchExtractJob
from test_torch_pipeline import port_config
from test_torch_pipeline import port_config

torch.set_num_threads(1)
CFG = SiftConfig(octaves=2, extrema_capacity=64)


def _write_frames(d, n=5):
    paths = []
    for i in range(n):
        img = synthetic_image(48, 64, seed=i)
        p = os.path.join(d, f"frame{i}.pgm")
        with open(p, "wb") as fh:
            fh.write(b"P5\n64 48\n255\n" + img.tobytes())
        paths.append(p)
    return paths


def _manifest(out):
    with open(os.path.join(out, "MANIFEST.jsonl")) as fh:
        return {r["frame"]: r for r in map(json.loads, fh) if r}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    frames = _write_frames(str(d))
    port_out, jax_out, one_out = (str(d / n) for n in ("port", "jax", "one"))
    stats = BatchExtractJob(port_out, port_config(CFG), batch=3,
                            device="cpu").run(frames)
    JaxBatchJob(jax_out, CFG, batch=3).run(frames)
    BatchExtractJob(one_out, port_config(CFG), batch=1, device="cpu").run(frames)
    return frames, port_out, jax_out, one_out, stats


def test_batch_job_counts_match_jax(jobs):
    frames, port_out, jax_out, _, stats = jobs
    assert stats == {"done": 5, "skipped": 0}
    port, ref = _manifest(port_out), _manifest(jax_out)
    assert sorted(port) == sorted(ref) == sorted(frames)
    for f in frames:
        assert port[f]["n_kp"] == ref[f]["n_kp"]
        assert port[f]["n_desc"] == ref[f]["n_desc"]
    assert sum(r["n_kp"] for r in port.values()) > 0


def test_batched_job_equals_per_frame_job(jobs):
    frames, port_out, _, one_out, _ = jobs
    for f in frames:
        name = os.path.basename(f).replace(".pgm", ".features.npz")
        a = np.load(os.path.join(port_out, name))
        b = np.load(os.path.join(one_out, name))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), (name, k)


def test_batch_job_resumes_without_recompute(jobs):
    frames, port_out, _, _, _ = jobs
    npzs = sorted(f for f in os.listdir(port_out) if f.endswith(".npz"))
    assert len(npzs) == 5
    mtimes = {f: os.path.getmtime(os.path.join(port_out, f)) for f in npzs}
    seen = []
    stats = BatchExtractJob(port_out, port_config(CFG), batch=3,
                            device="cpu").run(
        frames, on_frame=lambda p, feats: seen.append(p))
    assert stats == {"done": 0, "skipped": 5} and seen == []
    for f in npzs:
        assert os.path.getmtime(os.path.join(port_out, f)) == mtimes[f]


def test_batch_cli_on_cpu(jobs, tmp_path, capsys):
    frames, port_out, _, _, _ = jobs
    out = str(tmp_path / "cli")
    args = ["-i", *frames[:4], "-o", out, "--octaves", "2", "--batch", "3",
            "--device", "cpu"]
    assert batch_cli.main(args) == 0
    assert "4 extracted, 0 resumed" in capsys.readouterr().out
    assert batch_cli.main(args + ["-i", *frames]) == 0
    assert "1 extracted, 4 resumed" in capsys.readouterr().out
    assert len(_manifest(out)) == 5
