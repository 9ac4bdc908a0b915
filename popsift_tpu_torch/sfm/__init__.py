"""Structure-from-motion geometry in PyTorch (port of
:mod:`popsift_tpu.sfm`): SO(3) utilities, two-view geometry, PnP
(``pnp.py``), bundle adjustment (``ba.py``), trajectory evaluation
(``evaluate.py``) and track building (``tracks.py``, the port's copy of
the numpy original)."""
