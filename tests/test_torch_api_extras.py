"""What popsift_tpu_torch's API and demo CLI share with the JAX package's
beyond extraction: ``Feature.print`` / ``FeaturesHost.print`` text
character for character, the deprecated ``PopSift.init`` / ``execute``,
every flag of ``popsift_tpu.cli.demo`` with its default, the output file
of a variant flag set against the JAX CLI, and ``device_report`` and the
profiling helpers on the CPU.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from popsift_tpu import api as japi
from popsift_tpu.cli import demo as jdemo
from popsift_tpu.io.image import write_pgm
from popsift_tpu.pipeline import SiftFeatures as JaxSiftFeatures
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch.cli import demo as tdemo
from popsift_tpu_torch.config import SiftConfig as PortSiftConfig
from popsift_tpu_torch.pipeline import SiftFeatures
from popsift_tpu_torch.utils import device as tdevice
from popsift_tpu_torch.utils import profiling
from test_golden import DESC_TOL, POS_TOL, SIG_TOL, _load_cases

torch.set_num_threads(1)


def _raw_arrays(seed=0, K=12, J=16):
    """A capacity-padded result with invalid rows, keypoints of up to
    four orientations and descriptors in both print ranges."""
    rng = np.random.default_rng(seed)
    valid = rng.random(K) < 0.75
    num_ori = np.where(valid, rng.integers(0, 3, K), 0).astype(np.int32)
    kp = np.flatnonzero(num_ori > 0)
    desc_kp = np.resize(kp, J)
    desc_valid = np.arange(J) < min(J, int(num_ori.sum()))
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        x=f32(rng.uniform(0, 300, K)), y=f32(rng.uniform(0, 200, K)),
        sigma=f32(rng.uniform(1, 9, K)),
        octave=rng.integers(0, 4, K).astype(np.int32), num_ori=num_ori,
        valid=valid, ori=f32(rng.uniform(0, 6.28, (K, 4))),
        ori_valid=np.arange(4)[None] < num_ori[:, None],
        desc=f32(rng.uniform(0, 300, (J, 128)) * (rng.random((J, 128)) < .5)),
        desc_kp=desc_kp.astype(np.int32), desc_valid=desc_valid,
        n_keypoints=np.int32(valid.sum()),
        n_descriptors=np.int32(desc_valid.sum()),
        octave_candidates=np.zeros(4, np.int32),
        octave_dropped=np.zeros(4, np.int32))


@pytest.mark.parametrize("uchar", [False, True], ids=["float", "uchar"])
def test_print_text_equals_jax(uchar):
    raw = _raw_arrays()
    jhost = japi.FeaturesHost(JaxSiftFeatures(**raw))
    thost = tapi.FeaturesHost(SiftFeatures(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in raw.items()}))
    a, b = io.StringIO(), io.StringIO()
    thost.print(a, write_as_uchar=uchar)
    jhost.print(b, write_as_uchar=uchar)
    assert a.getvalue() == b.getvalue()
    assert a.getvalue().count("\n") == thost.getDescriptorCount() > 0
    f = next(thost.features())
    jf = japi.Feature(**f.__dict__)
    a, b = io.StringIO(), io.StringIO()
    f.print(a, uchar)
    jf.print(b, uchar)
    assert a.getvalue() == b.getvalue() != ""


def test_init_and_execute_warn(small_image):
    ps = tapi.PopSift(PortSiftConfig(octaves=2, extrema_capacity=64),
                      device="cpu")
    with pytest.warns(DeprecationWarning, match="PopSift.init"):
        assert ps.init(small_image.shape[1], small_image.shape[0])
    assert len(ps._plans) == 1
    with pytest.warns(DeprecationWarning, match="PopSift.execute"):
        host = ps.execute(small_image)
    want = ps.enqueue(small_image).get()
    assert host.getDescriptorCount() == want.getDescriptorCount() > 0
    assert np.array_equal(host.descriptors, want.descriptors)


def test_every_jax_demo_flag_is_accepted():
    jp, tp = jdemo.build_parser(), tdemo.build_parser()
    jflags = {s for a in jp._actions for s in a.option_strings}
    tflags = {s for a in tp._actions for s in a.option_strings}
    assert jflags <= tflags, sorted(jflags - tflags)
    assert tflags - jflags == {"--device", "--extrema-capacity"}
    jargs = vars(jp.parse_args(["-i", "x.pgm"]))
    targs = vars(tp.parse_args(["-i", "x.pgm"]))
    for k, v in jargs.items():
        assert targs[k] == v, k
    assert targs["device"] == "cuda"
    # the variant flags reach the config as the JAX CLI's do
    argv = ["-i", "x.pgm", "--downsampling", "0", "--gauss-mode", "fixed15",
            "--desc-mode", "grid", "--filter-max-extrema", "50",
            "--filter-grid", "3", "--filter-sort", "random",
            "--direct-scaling", "--norm-mode", "classic", "-v",
            "--opencv-mode"]
    jc = jdemo.config_from_args(jp.parse_args(argv))
    tc = tdemo.config_from_args(tp.parse_args(argv))
    for k, v in jc.__dict__.items():
        assert getattr(tc, k) == v, k


def _read_rows(path):
    return np.array([[float(v) for v in line.split()]
                     for line in open(path).read().splitlines()])


def test_variant_flags_give_the_jax_cli_output(tmp_path, capsys):
    """The vlfeat / igrid / classic-norm golden configuration through
    both CLIs on the CPU: the same counts and number of rows, positions,
    scales and descriptors within the golden tolerances (the text prints
    values that differ in the last bits, descriptors with %.3g)."""
    img, _, _ = _load_cases()["scene64_vlfeat_igrid"]
    src = str(tmp_path / "img.pgm")
    write_pgm(src, img)
    flags = ["--octaves", "3", "--vlfeat-mode", "--desc-mode", "igrid",
             "--classic-norm", "--pgmread-loading"]
    out_t, out_j = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    assert tdemo.main(["-i", src, "-o", out_t, "--device", "cpu"]
                      + flags) == 0
    assert jdemo.main(["-i", src, "-o", out_j] + flags) == 0
    printed = capsys.readouterr().out.splitlines()
    counts = [l for l in printed if l.startswith("Number of")]
    assert counts[:2] == counts[2:] and len(counts) == 4
    t, j = _read_rows(out_t), _read_rows(out_j)
    assert t.shape == j.shape and t.shape[0] > 0
    order = lambda a: np.lexsort((a[:, 2], a[:, 1], a[:, 0]))
    t, j = t[order(t)], j[order(j)]
    assert np.abs(t[:, :2] - j[:, :2]).max() < POS_TOL
    sig_t, sig_j = t[:, 2] ** -0.5, j[:, 2] ** -0.5
    assert np.abs(sig_t - sig_j).max() < SIG_TOL
    # plus two %.3g roundings of components below 1
    assert np.abs(t[:, 5:] - j[:, 5:]).max() < DESC_TOL + 1e-3


def test_log_writes_the_planes_and_a_trace(tmp_path, small_image):
    src = str(tmp_path / "img.pgm")
    write_pgm(src, small_image)
    log = tmp_path / "log"
    assert tdemo.main(["-i", src, "--dont-write", "--device", "cpu",
                       "--octaves", "2", "--log", "--log-dir", str(log),
                       "--print-gauss-tables", "--print-dev-info"]) == 0
    names = set(os.listdir(log))
    assert {"pyramid-o-0-l-0.pgm", "pyramid-o-1-l-5.pgm",
            "d-dog-o-1-l-4.pgm", "trace.json"} <= names
    assert "traceEvents" in json.load(open(log / "trace.json"))


def test_device_report_on_cpu(capsys):
    from popsift_tpu.utils.device import device_report as jreport
    rows = tdevice.device_report()
    printed = capsys.readouterr().out
    keys = set(jreport(verbose=False)[0]) | {"hbm_bytes", "hbm_in_use"}
    assert rows and set(rows[0]) == keys
    if not torch.cuda.is_available():
        assert rows[0]["platform"] == "cpu" and len(rows) == 1
        assert printed.startswith("backend: cpu  processes: 1  devices: 1")


def test_profiling_helpers_on_cpu(tmp_path, capsys, small_image):
    """The demo's --print-time-info (and -v) table is the span summary:
    load, the extraction's stages and write, and the counters of the
    request; device_trace writes a trace that holds the spans' marks."""
    src = str(tmp_path / "img.pgm")
    write_pgm(src, small_image)
    for flag in ("--print-time-info", "-v"):
        assert tdemo.main(["-i", src, "-o", str(tmp_path / "o.txt"),
                           "--device", "cpu", "--octaves", "2", flag]) == 0
        lines = capsys.readouterr().out.splitlines()
        at = lines.index("span                   calls  self ms total"
                         "  self ms a call")
        assert lines[at - 1].startswith("Host time on cpu")
        rows = {l.split()[0]: l.split()[1:] for l in lines[at + 1:]}
        for name in ("load", "enqueue", "front", "desc", "get", "copy",
                     "write"):
            assert rows[name][0] == "1", name
        assert rows["host_syncs"] == ["1", "2.0"]
        assert not profiling.tracing()
    with profiling.device_trace(str(tmp_path / "tr")):
        with profiling.span("marked"):
            torch.ones(16).cumsum(0)
    trace = json.load(open(tmp_path / "tr" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"popsift/marked", "popsift/marked/end"} <= names