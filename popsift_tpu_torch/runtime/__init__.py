"""Host-side runtime of the port: restartable batch jobs
(:mod:`.batchjob`) and the native decode pipeline
(:mod:`.native`, built from native/popsift_host.cpp by :mod:`.build`).

``from popsift_tpu_torch.runtime import native`` raises ImportError when
the C++ toolchain is unavailable; use :func:`available` to probe.
"""


def available() -> bool:
    try:
        from . import native  # noqa: F401
        return True
    except Exception:
        return False
