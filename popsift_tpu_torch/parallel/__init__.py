"""Multi-process parallel layer on ``torch.distributed`` (port of
:mod:`popsift_tpu.parallel`, without ``spatial.py`` yet).

* :mod:`.mesh` — process meshes, the collectives and the device report.
* :mod:`.launch` — start the ranks of a job on one host.
* :mod:`.batch` — data-parallel batched extraction, ring matching and
  block-sharded all-pairs matching.
"""

from .batch import (gather_features, make_allpairs_match_fn,
                    make_batched_extract_fn, ring_matches)
from .mesh import make_mesh, make_mesh_2d

__all__ = [
    "gather_features",
    "make_allpairs_match_fn",
    "make_batched_extract_fn",
    "make_mesh",
    "make_mesh_2d",
    "ring_matches",
]
