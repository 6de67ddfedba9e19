"""The port's sampler with the fused-edit dispatch against the JAX
package's, on TINY: the port's ``KernelConfig()`` (K2's plain version on the
CPU) against ``KernelConfig(interpret=True)`` (the Pallas kernel in the
interpreter), with and without the attention store. Same setup and bars as
``test_torch_pipeline.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from p2p_tpu.kernels import KernelConfig as JKernelConfig  # noqa: E402

from p2p_tpu_torch.kernels import KernelConfig  # noqa: E402
from tests.test_torch_pipeline import compare  # noqa: E402


@pytest.mark.parametrize("store", [True, False])
def test_text2image_matches_jax_fused_edit(store):
    compare(store, KernelConfig(), JKernelConfig(interpret=True))
