"""popsift_tpu_torch end to end against the JAX package on the CPU.

The two main-path golden scenes (scripts/make_golden.py:28-55) run
through the port's ``PopSift(cfg, device="cpu")`` (the three variant
scenes in tests/test_torch_golden_variants.py): counts equal JAX
``PopSift`` exactly, features sit within the golden tolerances
(tests/test_golden.py:21-24) of both JAX and the oracle fixtures. Also:
the text writer, the explicit-device rule, the launch counters on the
CPU, and that the port never loads jax.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from popsift_tpu.api import PopSift as JaxPopSift
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch.config import SiftConfig as PortSiftConfig
from popsift_tpu_torch.ops import kernels
from popsift_tpu_torch.utils.device import resolve_device
from test_golden import (DESC_TOL, GOLDEN_DIR, ORI_TOL, POS_TOL, SIG_TOL,
                         _flatten_host, _load_cases)

torch.set_num_threads(1)
CASES = ("scene64_default", "scene120_default")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_config(cfg) -> PortSiftConfig:
    """The port's SiftConfig built from the same keyword arguments as the
    JAX package's ``cfg`` (the two packages keep separate classes)."""
    return PortSiftConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def runs():
    """Port and JAX results of both scenes, computed once."""
    kernels.reset_launch_counts()
    out = {}
    for name in CASES:
        img, cfg, _ = _load_cases()[name]
        out[name] = (tapi.PopSift(port_config(cfg),
                                  device="cpu").enqueue(img).get(),
                     JaxPopSift(cfg).enqueue(img).get())
    return out


def _assert_within_golden_tolerances(got, want):
    assert len(got["x"]) == len(want["x"])
    assert np.array_equal(got["num_ori"], want["num_ori"])
    assert np.max(np.abs(got["x"] - want["x"])) < POS_TOL
    assert np.max(np.abs(got["y"] - want["y"])) < POS_TOL
    assert np.max(np.abs(got["sigma"] - want["sigma"])) < SIG_TOL
    assert np.max(np.abs(got["ori"] - want["ori"])) < ORI_TOL
    assert got["desc"].shape == want["desc"].shape
    assert np.max(np.abs(got["desc"] - want["desc"])) < DESC_TOL


@pytest.mark.parametrize("name", CASES)
def test_counts_and_features_match_jax(runs, name):
    port, jax_host = runs[name]
    assert port.getFeatureCount() == jax_host.getFeatureCount() > 0
    assert port.getDescriptorCount() == jax_host.getDescriptorCount()
    _assert_within_golden_tolerances(_flatten_host(port),
                                     _flatten_host(jax_host))


@pytest.mark.parametrize("name", CASES)
def test_features_match_golden(runs, name):
    port, _ = runs[name]
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    _assert_within_golden_tolerances(_flatten_host(port), want)


def test_save_writes_one_row_per_descriptor(runs, tmp_path):
    port, _ = runs["scene120_default"]
    path = tmp_path / "feats.txt"
    port.save(str(path))
    rows = path.read_text().splitlines()
    assert len(rows) == port.getDescriptorCount()
    assert len(rows[0].split()) == 5 + 128


def test_launch_counters_stay_zero_on_cpu(runs):
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_matching_mode_keeps_tensors():
    img, cfg, _ = _load_cases()["scene64_default"]
    dev = tapi.PopSift(port_config(cfg), mode="matching",
                       device="cpu").enqueue(img).get()
    assert isinstance(dev, tapi.FeaturesDev)
    assert dev.descriptors.shape[1] == 128
    assert dev.getDescriptorCount() == int(dev.desc_valid.sum()) > 0


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.PopSift(device="cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import popsift_tpu_torch\n"
        "for m in pkgutil.walk_packages(popsift_tpu_torch.__path__,\n"
        "                               'popsift_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'popsift_tpu')\n"
        "             or k.startswith(('jax.', 'jaxlib', 'popsift_tpu.')))\n"
        "assert not bad, bad\n"
        "for m in ('popsift_tpu_torch.runtime.batchjob',\n"
        "          'popsift_tpu_torch.cli.batch'):\n"
        "    assert m in sys.modules, m\n"
        "print('ok', len([k for k in sys.modules\n"
        "                 if k.startswith('popsift_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) >= 15


def test_demo_cli_on_cpu(tmp_path):
    from popsift_tpu.io.image import write_pgm
    from popsift_tpu_torch.cli import demo

    img, _, _ = _load_cases()["scene64_default"]
    src, out = tmp_path / "img.pgm", tmp_path / "out.txt"
    write_pgm(str(src), img)
    assert demo.main(["-i", str(src), "-o", str(out), "--device", "cpu",
                      "--octaves", "3"]) == 0
    rows = out.read_text().splitlines()
    assert len(rows) > 0 and len(rows[0].split()) == 5 + 128
