"""The pipeline's stages as plain PyTorch (``layout``, ``mask``,
``guidance``, ``rhs``, ``postprocess``), the kernels' wrappers
(``kernels``) and the edits (``edit``, ``canny``). The nine stage functions
are re-exported here, as the JAX package's ``ops`` does."""

from seamlesscloneoptimization_tpu_torch.ops.layout import (
    interleaved_to_planar,
    planar_to_interleaved,
)
from seamlesscloneoptimization_tpu_torch.ops.mask import binarize_mask, erode3x3
from seamlesscloneoptimization_tpu_torch.ops.guidance import (
    gradient_x,
    gradient_y,
    guidance_field,
)
from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs
from seamlesscloneoptimization_tpu_torch.ops.postprocess import postprocess_roi

__all__ = [
    "interleaved_to_planar",
    "planar_to_interleaved",
    "binarize_mask",
    "erode3x3",
    "guidance_field",
    "gradient_x",
    "gradient_y",
    "poisson_rhs",
    "postprocess_roi",
]
