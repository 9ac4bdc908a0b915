"""Two processes of one ``torch.distributed`` job, each started on its
own (``popsift_tpu_torch/tools/multiproc_worker.py``), meeting over
``tcp://127.0.0.1:<free port>`` on gloo and the CPU: batched extraction
across the processes, ``psum``, ``ppermute``, ``all_gather`` and one
distributed BA step. The port of tests/test_multiprocess.py; the
replicated ``RESULT`` line must be equal on both processes and count
keypoints.
"""

import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.distributed
def test_two_process_job():
    nprocs = 2
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "popsift_tpu_torch.tools.multiproc_worker",
             coordinator, str(nprocs), str(pid), "--device", "cpu",
             "--backend", "gloo"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, out[-4000:]
        results.append(lines[-1])
    # replicated outputs agree bit for bit across processes
    assert results[0] == results[1], results
    # and the workload found real keypoints
    assert not results[0].startswith("RESULT (0,"), results[0]
