"""rtsdm_tpu_torch — the PyTorch / CUDA port of rtsdm_tpu (ray-traced
stochastic depth maps for ambient occlusion) for NVIDIA Hopper.

The JAX package `rtsdm_tpu` is the reference this package is held against;
module paths and function names follow it so each function has an obvious
counterpart. Plain tensor code is PyTorch; the five kernels of the main path
(visibility raster, attribute fetch, shifted direction fetch, packed SD
fetch, SD ray trace) are hand-written CUDA under csrc/, built on first use
by `_build.py`. This package never imports jax.

Layer map:
  scene/        — Scene + Camera dataclasses of tensors, procedural scenes
  ops/          — raster, SVAO sampling math, the CUDA kernel wrappers
  rendergraph/  — pass protocol + DAG execution (nested graphs)
  passes/       — G-buffer, depth chain, SVAO, stochastic depth map (RT)
"""

__version__ = "0.1.0"

import torch as _torch

# Renderer-wide precision policy: geometry transforms and depth
# linearization must stay true float32 (a reduced-precision camera
# transform puts ~0.4% error on NDC depth, which linearization amplifies by
# ~far/near). Matmuls in TF32 or cuDNN TF32 convolutions would break that.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
