"""Structure-from-motion in PyTorch (port of :mod:`popsift_tpu.sfm`):
SO(3) utilities, two-view geometry, PnP (``pnp.py``), bundle adjustment
(``ba.py``), trajectory evaluation (``evaluate.py``), the incremental
driver (``incremental.py``) and global SfM by rotation and translation
averaging (``global_sfm.py``); track building (``tracks.py``), COLMAP /
PLY export (``export.py``) and checkpoints (``checkpoint.py``) are the
port's copies of the numpy originals."""
