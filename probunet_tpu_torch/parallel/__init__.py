"""Full-domain tiling (port of the tiling half of ``probunet_tpu/parallel``).

The mesh paths (``halo_exchange``, ``halo_conv2d``, data- and
member-parallel steps, ``tiled_ensemble(mesh=)``) are not ported yet
(ROADMAP.md §1 item 7).
"""

from probunet_tpu_torch.parallel.spatial import extract_tiles, stitch_tiles, tiled_ensemble

__all__ = ["extract_tiles", "stitch_tiles", "tiled_ensemble"]
