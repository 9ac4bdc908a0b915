"""Multi-process parallel layer on ``torch.distributed`` (port of
:mod:`popsift_tpu.parallel`).

* :mod:`.mesh` — process meshes, the collectives and the device report.
* :mod:`.launch` — start the ranks of a job on one host.
* :mod:`.batch` — data-parallel batched extraction, ring matching and
  block-sharded all-pairs matching.
* :mod:`.spatial` — the row-sharded pyramid and the full spatially
  sharded extraction with halo exchange, and its DP x SP composition.
"""

from .batch import (gather_features, make_allpairs_match_fn,
                    make_batched_extract_fn, ring_matches)
from .mesh import make_mesh, make_mesh_2d
from .spatial import (make_batched_sharded_extract_fn,
                      make_sharded_extract_fn, make_sharded_pyramid_fn)

__all__ = [
    "gather_features",
    "make_allpairs_match_fn",
    "make_batched_extract_fn",
    "make_batched_sharded_extract_fn",
    "make_mesh",
    "make_mesh_2d",
    "make_sharded_extract_fn",
    "make_sharded_pyramid_fn",
    "ring_matches",
]
