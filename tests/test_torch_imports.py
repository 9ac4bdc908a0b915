"""The port and its card tests import nothing of jax or of the JAX
package, no module of the port imports ``chip_smoke.py``, and its own
copies of the shared plain-Python modules agree with the originals:
``SiftConfig`` field for field and default for default, the Gauss tables
bit for bit, ``sfm/tracks.py``, ``sfm/export.py``,
``sfm/checkpoint.py``, ``eval/repeatability.py`` and
``oracle/sift_oracle.py`` class for class and function for function
(source and fields), the numpy classes of
``sfm/incremental.py``, and ``tools/e2e_proof.py::render_sequence``
(scripts/e2e_proof.py's scene).
"""

import ast
import dataclasses
import glob
import importlib.util
import inspect
import os

import numpy as np
import pytest

from popsift_tpu import config as jconfig
from popsift_tpu import gauss as jgauss
from popsift_tpu.eval import repeatability as jrepeatability
from popsift_tpu.oracle import sift_oracle as joracle
from popsift_tpu.sfm import checkpoint as jcheckpoint
from popsift_tpu.sfm import export as jexport
from popsift_tpu.sfm import incremental as jincremental
from popsift_tpu.sfm import tracks as jtracks
from popsift_tpu_torch import config as tconfig
from popsift_tpu_torch import gauss as tgauss
from popsift_tpu_torch.eval import repeatability as trepeatability
from popsift_tpu_torch.oracle import sift_oracle as toracle
from popsift_tpu_torch.sfm import checkpoint as tcheckpoint
from popsift_tpu_torch.sfm import export as texport
from popsift_tpu_torch.sfm import incremental as tincremental
from popsift_tpu_torch.sfm import tracks as ttracks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "popsift_tpu_torch")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_modules(path):
    """Absolute module names a file imports, at any depth of nesting."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_has_sources():
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    rel |= {os.path.relpath(p, REPO)
            for p in glob.glob(os.path.join(PORT, "csrc", "*.cu"))}
    assert {"chip_smoke.py", "popsift_tpu_torch/config.py",
            "popsift_tpu_torch/gauss.py", "popsift_tpu_torch/io/image.py",
            "popsift_tpu_torch/runtime/native.py",
            "popsift_tpu_torch/runtime/build.py",
            "popsift_tpu_torch/ops/gridfilter.py",
            "popsift_tpu_torch/utils/profiling.py",
            "popsift_tpu_torch/utils/device.py",
            "popsift_tpu_torch/sfm/tracks.py",
            "popsift_tpu_torch/sfm/evaluate.py",
            "popsift_tpu_torch/sfm/pnp.py",
            "popsift_tpu_torch/sfm/ba.py",
            "popsift_tpu_torch/sfm/export.py",
            "popsift_tpu_torch/sfm/checkpoint.py",
            "popsift_tpu_torch/sfm/incremental.py",
            "popsift_tpu_torch/sfm/global_sfm.py",
            "popsift_tpu_torch/tools/sfm_scenes.py",
            "popsift_tpu_torch/tools/sfm_scale.py",
            "popsift_tpu_torch/tools/step_spread.py",
            "popsift_tpu_torch/eval/repeatability.py",
            "popsift_tpu_torch/sfm/retrieval.py",
            "popsift_tpu_torch/cli/sfm.py",
            "popsift_tpu_torch/tools/e2e_proof.py",
            "popsift_tpu_torch/parallel/__init__.py",
            "popsift_tpu_torch/parallel/mesh.py",
            "popsift_tpu_torch/parallel/launch.py",
            "popsift_tpu_torch/parallel/batch.py",
            "popsift_tpu_torch/sfm/distributed.py",
            "popsift_tpu_torch/tools/rank_cases.py",
            "popsift_tpu_torch/tools/multiproc_worker.py",
            "popsift_tpu_torch/tools/dryrun_multichip.py",
            "popsift_tpu_torch/oracle/__init__.py",
            "popsift_tpu_torch/oracle/sift_oracle.py",
            "popsift_tpu_torch/sfm/bal.py",
            "popsift_tpu_torch/sfm/bal_reference.py",
            "popsift_tpu_torch/tools/bal_scene.py",
            "popsift_tpu_torch/ops/kernels/match.py",
            "popsift_tpu_torch/csrc/match.cu"} <= rel
    assert len(rel) >= 84


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "popsift_tpu"), \
            f"{os.path.relpath(path, REPO)} imports {name}"


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "tests",
                                          "test_torch_*_cuda.py")))
    + [os.path.join(REPO, "tests", "torch_card.py")],
    ids=os.path.basename)
def test_card_test_imports_neither_jax_nor_the_jax_package(path):
    """The card's machine has no jax, and its tests run with
    ``--noconftest``; ``torch_card.py`` is what they share."""
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "popsift_tpu"), \
            f"{os.path.basename(path)} imports {name}"


def test_no_port_module_imports_chip_smoke():
    """The card check's runner sits above the package: nothing in
    ``popsift_tpu_torch/`` reaches up into it."""
    for path in _port_sources():
        if os.path.relpath(path, REPO) == "chip_smoke.py":
            continue
        for name in _imported_modules(path):
            assert name.split(".")[0] != "chip_smoke", \
                f"{os.path.relpath(path, REPO)} imports {name}"


def test_siftconfig_fields_and_defaults_equal():
    jf = dataclasses.fields(jconfig.SiftConfig)
    tf = dataclasses.fields(tconfig.SiftConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [f.type for f in tf] == [f.type for f in jf]
    assert dataclasses.asdict(tconfig.SiftConfig()) \
        == dataclasses.asdict(jconfig.SiftConfig())
    assert tconfig.SiftConfig is not jconfig.SiftConfig
    consts = [n for n in dir(jconfig) if n.isupper()]
    assert len(consts) >= 5
    for n in consts:
        assert getattr(tconfig, n) == getattr(jconfig, n), n


@pytest.mark.parametrize("kw", [
    dict(), dict(octaves=3, levels=4, sigma=1.8),
    dict(sift_mode="vlfeat"), dict(sift_mode="opencv"),
    dict(upscale_factor=0.0, extrema_capacity=512)],
    ids=["default", "levels4", "vlfeat", "opencv", "no_upscale"])
def test_siftconfig_derived_values_equal(kw):
    j, t = jconfig.SiftConfig(**kw), tconfig.SiftConfig(**kw)
    assert t.total_levels == j.total_levels
    for w, h in ((1920, 1080), (80, 64), (33, 17)):
        assert t.num_octaves_for(w, h) == j.num_octaves_for(w, h)
        assert t.octave_dims(w, h) == j.octave_dims(w, h)
        dims = j.octave_dims(w, h)
        assert [t.capacity_for_octave(oh, ow) for oh, ow in dims] \
            == [j.capacity_for_octave(oh, ow) for oh, ow in dims]
    assert dataclasses.asdict(t.replace(octaves=2)) \
        == dataclasses.asdict(j.replace(octaves=2))


@pytest.mark.parametrize("kw", [
    dict(), dict(sift_mode="vlfeat"),
    dict(sift_mode="vlfeat", gauss_mode="vlfeat-relative-all"),
    dict(gauss_mode="fixed9")],
    ids=["default", "vlfeat", "vlfeat_relative_all", "fixed9"])
def test_gauss_tables_bit_equal(kw):
    jt = jgauss.build_gauss_tables(jconfig.SiftConfig(**kw))
    tt = tgauss.build_gauss_tables(tconfig.SiftConfig(**kw))
    fields = [f.name for f in dataclasses.fields(jt)]
    assert [f.name for f in dataclasses.fields(tt)] == fields
    for name in fields:
        a, b = np.asarray(getattr(tt, name)), np.asarray(getattr(jt, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    for l in range(jconfig.SiftConfig(**kw).total_levels):
        assert np.array_equal(
            tgauss.full_kernel(tt.inc[l], int(tt.inc_span[l])),
            jgauss.full_kernel(jt.inc[l], int(jt.inc_span[l])))


def test_tracks_copy_equals_the_original():
    """The copy keeps the original's code: the same ``Tracks`` fields and
    the same source for every other class and function."""
    assert [(f.name, f.type) for f in dataclasses.fields(ttracks.Tracks)] \
        == [(f.name, f.type) for f in dataclasses.fields(jtracks.Tracks)]
    assert inspect.getsource(ttracks.Tracks.observations_of) \
        == inspect.getsource(jtracks.Tracks.observations_of)
    for name in ("_UnionFind", "build_tracks"):
        assert inspect.getsource(getattr(ttracks, name)) \
            == inspect.getsource(getattr(jtracks, name)), name


@pytest.mark.parametrize("port,orig,names", [
    (texport, jexport, ("_rot_to_quat", "write_colmap_text", "write_ply")),
    (tcheckpoint, jcheckpoint, ("save_reconstruction", "load_reconstruction",
                                "resume_incremental")),
    (tincremental, jincremental, ("Reconstruction", "_PointView", "_pad")),
    (trepeatability, jrepeatability, ("project", "PairScores",
                                      "evaluate_pair",
                                      "strongest_descriptor_per_keypoint",
                                      "warp_image", "synthetic_scene",
                                      "protocol_homographies")),
    (toracle, joracle, ("_bilinear_clamped", "_conv_half",
                        "_resample_from_input", "oracle_pyramid",
                        "OracleExtremum", "_solve3", "_read_dog",
                        "_is_extremum_26", "oracle_extrema", "_refine",
                        "_gradient", "oracle_orientations", "_bilinear2d",
                        "oracle_descriptor_grid",
                        "oracle_descriptor_tilegrid",
                        "oracle_descriptor_iloop", "oracle_descriptor_loop",
                        "normalize_descriptor", "oracle_extract"))],
    ids=["export", "checkpoint", "incremental", "repeatability", "oracle"])
def test_numpy_copies_equal_the_originals(port, orig, names):
    """The copies keep the original's code class for class and function
    for function, and the numpy modules define exactly the original's
    functions."""
    for name in names:
        assert inspect.getsource(getattr(port, name)) \
            == inspect.getsource(getattr(orig, name)), name
    if port is not tincremental:
        functions = lambda m: sorted(
            n for n, v in vars(m).items()
            if inspect.isfunction(v) and v.__module__ == m.__name__)
        assert functions(port) == functions(orig) \
            == sorted(n for n in names if inspect.isfunction(getattr(orig, n)))


def test_render_sequence_copy_equals_the_original():
    """The port's E2E tool renders scripts/e2e_proof.py's scene: the same
    source, and the same frames, centers and intrinsics."""
    from popsift_tpu_torch.tools import e2e_proof as tproof
    spec = importlib.util.spec_from_file_location(
        "_jax_e2e_proof", os.path.join(REPO, "scripts", "e2e_proof.py"))
    jproof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jproof)
    assert inspect.getsource(tproof.render_sequence) \
        == inspect.getsource(jproof.render_sequence)
    (tf, tc, ti), (jf, jc, ji) = (m.render_sequence(3, 24, 32)
                                  for m in (tproof, jproof))
    assert ti == ji and np.array_equal(tc, jc)
    assert all(np.array_equal(a, b) for a, b in zip(tf, jf))


@pytest.mark.parametrize("name", ["evaluate", "tracks", "export",
                                  "checkpoint"])
def test_sfm_numpy_modules_import_no_jax_package(name):
    """The port's numpy SfM modules stand alone: no import of jax or of
    ``popsift_tpu``, nested ones (``evaluate.camera_centers`` in the
    JAX package imports jax inside the function) included."""
    path = os.path.join(PORT, "sfm", f"{name}.py")
    tops = {m.split(".")[0] for m in _imported_modules(path)}
    assert not tops & {"jax", "jaxlib", "popsift_tpu"}
