"""The tile-based domain decomposition (ROADMAP slice 8a): a device mesh,
the halo exchange, the distributed red-black and DD multigrid solvers, and
the tiled seamless clone."""

from seamlesscloneoptimization_tpu_torch.parallel.clone_tiled import (
    TiledSeamlessClone,
    local_edit_tiled,
    seamless_clone_tiled,
)
from seamlesscloneoptimization_tpu_torch.parallel.mesh import (
    TileMesh,
    gather_tiles,
    make_tile_mesh,
    shard_tiles,
)
from seamlesscloneoptimization_tpu_torch.parallel.tiled import (
    halo_exchange,
    solve_multigrid_dd,
    solve_poisson_dd,
    solve_redblack_tiled,
)

__all__ = [
    "TileMesh",
    "make_tile_mesh",
    "shard_tiles",
    "gather_tiles",
    "halo_exchange",
    "solve_redblack_tiled",
    "solve_multigrid_dd",
    "solve_poisson_dd",
    "TiledSeamlessClone",
    "seamless_clone_tiled",
    "local_edit_tiled",
]
