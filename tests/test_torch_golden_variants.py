"""The three variant golden scenes through popsift_tpu_torch on the CPU.

``scene64_vlfeat_igrid``, ``scene64_grid_fixed9`` and
``scene64_iloop_interp`` (scripts/make_golden.py:28-55) run through the
port's ``PopSift(cfg, device="cpu")`` as tests/test_torch_pipeline.py
runs the two ``*_default`` scenes: counts equal to JAX ``PopSift``
exactly, features within the golden tolerances (tests/test_golden.py:
21-24) of both JAX and the oracle fixtures.
"""

import os

import numpy as np
import pytest
import torch

from popsift_tpu.api import PopSift as JaxPopSift
from popsift_tpu_torch import api as tapi
from test_golden import GOLDEN_DIR, _flatten_host, _load_cases
from test_torch_pipeline import _assert_within_golden_tolerances, port_config

torch.set_num_threads(1)
CASES = ("scene64_vlfeat_igrid", "scene64_grid_fixed9",
         "scene64_iloop_interp")


@pytest.mark.parametrize("name", CASES)
def test_variant_golden_through_the_port(name):
    img, cfg, _ = _load_cases()[name]
    port = tapi.PopSift(port_config(cfg), device="cpu").enqueue(img).get()
    jax_host = JaxPopSift(cfg).enqueue(img).get()
    assert port.getFeatureCount() == jax_host.getFeatureCount() > 0
    assert port.getDescriptorCount() == jax_host.getDescriptorCount()
    got = _flatten_host(port)
    _assert_within_golden_tolerances(got, _flatten_host(jax_host))
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    _assert_within_golden_tolerances(got, want)
