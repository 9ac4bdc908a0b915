"""popsift_tpu_torch.cli.match on the CPU against popsift_tpu.cli.match:
the same ``left:``, ``right:`` and ``accepted matches:`` lines on the
same files; geometric verification of a shifted copy
(tests/test_io_cli.py:91-115); the explicit-device rule."""

import numpy as np
import pytest
import torch

from popsift_tpu.cli.match import main as jax_match
from popsift_tpu.io.image import write_pgm
from popsift_tpu_torch.cli.match import main as port_match

torch.set_num_threads(1)
HEAD = ("left:", "right:", "accepted matches:")


@pytest.fixture(scope="module")
def pgm_pairs(small_image, medium_image, tmp_path_factory):
    """Each image and its (3, 5) roll written as PGM files."""
    d = tmp_path_factory.mktemp("match_cli")
    out = {}
    for name, img in (("small", small_image), ("medium", medium_image)):
        paths = [str(d / f"{name}_{s}.pgm") for s in ("l", "r")]
        write_pgm(paths[0], img)
        write_pgm(paths[1], np.roll(img, (3, 5), axis=(0, 1)))
        out[name] = ["-l", paths[0], "-r", paths[1]]
    return out


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


def test_head_lines_match_jax(pgm_pairs, capsys):
    port = _run(port_match, pgm_pairs["small"] + ["--device", "cpu"],
                capsys)
    want = _run(jax_match, pgm_pairs["small"], capsys)
    head = [l for l in port if l.startswith(HEAD)]
    assert head == [l for l in want if l.startswith(HEAD)]
    assert len(head) == 3 and int(head[2].split(": ")[1]) > 0


def test_geometric_verification(pgm_pairs, capsys):
    """Port of tests/test_io_cli.py:91-115: a pure translation is a
    homography, so nearly every ratio-test match verifies."""
    out = _run(port_match, pgm_pairs["medium"] + [
        "--device", "cpu", "--octaves", "3", "--geom", "homography",
        "--max-print", "5"], capsys)
    line = [l for l in out if l.startswith("geometric verification")][0]
    inl, tot = map(int, line.split(": ")[1].split(" ")[0].split("/"))
    assert tot >= 8 and inl / tot >= 0.7, line
    assert sum(l.endswith(" inlier") for l in out) >= 1


def test_essential_and_int8_routes(pgm_pairs, capsys):
    out = _run(port_match, pgm_pairs["medium"] + [
        "--device", "cpu", "--octaves", "3", "--geom", "essential",
        "--int8", "--max-print", "0", "--seed", "3"], capsys)
    n_acc = int([l for l in out if l.startswith("accepted matches:")][0]
                .split(": ")[1])
    line = [l for l in out if l.startswith("geometric verification")][0]
    assert line.startswith("geometric verification (essential): ")
    assert int(line.split("/")[1].split(" ")[0]) == n_acc >= 8
    assert sum(l.startswith("desc ") for l in out) == n_acc


def test_cuda_without_a_card_raises(pgm_pairs):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        port_match(pgm_pairs["small"])


@pytest.mark.parametrize("flag", [["--desc-mode", "grid"],
                                  ["--gauss-mode", "fixed9"]],
                         ids=["desc_mode", "gauss_mode"])
def test_variants_match_jax_head_lines(pgm_pairs, flag, capsys):
    """The variants the port once refused now run: the same head lines as
    the JAX CLI with the same flag."""
    port = _run(port_match, pgm_pairs["small"] + ["--device", "cpu"] + flag,
                capsys)
    want = _run(jax_match, pgm_pairs["small"] + flag, capsys)
    head = [l for l in port if l.startswith(HEAD)]
    assert head == [l for l in want if l.startswith(HEAD)]
    assert len(head) == 3 and int(head[2].split(": ")[1]) > 0
