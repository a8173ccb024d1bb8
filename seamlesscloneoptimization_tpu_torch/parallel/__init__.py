"""The tile-based domain decomposition (ROADMAP slices 8a, 8 and 8b): a
device mesh, in one process or spanning several (``init_distributed``), the
halo exchange, the distributed red-black and DD multigrid solvers, the
partitioned V-cycles (``solve_multigrid_sharded``,
``solve_multigrid_dyn_sharded``), each also on tiles in and out, the tiled
seamless clone and the tiled local edits with their stages per tile and the
destination resident on the mesh (``parallel/stages.py``), and
``dryrun_multichip``; and the batch (slice 6): N jobs into one destination
a step, the jobs split over a mesh with ``clone_roi_batch(mesh=...)``."""

from seamlesscloneoptimization_tpu_torch.parallel.batch import (
    clone_batch_composite,
    clone_batch_composite_dyn,
    clone_batch_composite_p,
    clone_roi_batch,
    fast_dst_solver,
    seamless_clone_batch_fused,
)
from seamlesscloneoptimization_tpu_torch.parallel.clone_tiled import (
    TiledSeamlessClone,
    local_edit_tiled,
    seamless_clone_tiled,
)
from seamlesscloneoptimization_tpu_torch.parallel.dryrun import dryrun_multichip
from seamlesscloneoptimization_tpu_torch.parallel.mesh import (
    TileMesh,
    gather_tiles,
    init_distributed,
    make_tile_mesh,
    shard_tiles,
)
from seamlesscloneoptimization_tpu_torch.parallel.tiled import (
    halo_exchange,
    solve_multigrid_dd,
    solve_multigrid_dyn_sharded,
    solve_multigrid_sharded,
    solve_poisson_dd,
    solve_redblack_tiled,
)

__all__ = [
    "TileMesh",
    "init_distributed",
    "make_tile_mesh",
    "shard_tiles",
    "gather_tiles",
    "halo_exchange",
    "solve_redblack_tiled",
    "solve_multigrid_dd",
    "solve_multigrid_sharded",
    "solve_multigrid_dyn_sharded",
    "solve_poisson_dd",
    "TiledSeamlessClone",
    "seamless_clone_tiled",
    "local_edit_tiled",
    "dryrun_multichip",
    "fast_dst_solver",
    "clone_roi_batch",
    "clone_batch_composite",
    "clone_batch_composite_p",
    "clone_batch_composite_dyn",
    "seamless_clone_batch_fused",
]
