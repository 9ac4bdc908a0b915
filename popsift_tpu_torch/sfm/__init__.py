"""Structure-from-motion geometry in PyTorch (port of
:mod:`popsift_tpu.sfm`): SO(3) utilities and two-view geometry."""
