"""p2p_tpu_torch: the PyTorch/CUDA port of p2p_tpu for NVIDIA Hopper.

Prompt-to-prompt editing — a Stable Diffusion sampler whose attention sites
carry an explicit controller hook — with the JAX package's two Pallas
kernels on the sampling path rewritten as CUDA C++ for ``sm_90a``: flash
attention (K1) and the fused-edit attention (K2). The JAX package
``p2p_tpu`` is the reference the port is held against; this package imports
neither it nor JAX.
"""

__version__ = "0.1.0"

from .engine.sampler import Pipeline, random_pipeline, text2image  # noqa: E402
from .controllers.factory import (  # noqa: E402
    attention_refine,
    attention_replace,
    make_controller,
)
from .kernels.dispatch import KernelConfig  # noqa: E402

__all__ = ["Pipeline", "random_pipeline", "text2image", "attention_refine",
           "attention_replace", "make_controller", "KernelConfig"]
