"""p2p_tpu_torch: the PyTorch/CUDA port of p2p_tpu for NVIDIA Hopper.

Prompt-to-prompt editing — a Stable Diffusion sampler whose attention sites
carry an explicit controller hook — and null-text inversion of real images,
with the JAX package's Pallas kernels rewritten as CUDA C++ for ``sm_90a``:
flash attention (K1), the fused-edit attention (K2), the flash forward with
softmax residuals (K3) and the flash backward (K4). The JAX package
``p2p_tpu`` is the reference the port is held against; this package imports
neither it nor JAX.
"""

__version__ = "0.1.0"

from .engine.sampler import Pipeline, random_pipeline, text2image  # noqa: E402
from .engine.inversion import InversionArtifact, invert  # noqa: E402
from .controllers.factory import (  # noqa: E402
    attention_refine,
    attention_replace,
    attention_reweight,
    local_blend,
    make_controller,
)
from .kernels.dispatch import KernelConfig  # noqa: E402

__all__ = ["Pipeline", "random_pipeline", "text2image", "InversionArtifact",
           "invert", "attention_refine", "attention_replace",
           "attention_reweight", "local_blend", "make_controller", "KernelConfig"]
