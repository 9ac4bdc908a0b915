"""Evaluation helpers (port of :mod:`popsift_tpu.eval`): the port's copy
of the numpy repeatability protocol (``repeatability.py``)."""
