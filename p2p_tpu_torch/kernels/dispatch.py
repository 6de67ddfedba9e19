"""Static kernel dispatch: which attention variant each site runs.

The PyTorch counterpart of ``p2p_tpu/kernels/dispatch.py``, decided from the
:class:`KernelConfig`, the controller and the site's ``AttnMeta``:

=================  =========================================================
variant            what runs
=================  =========================================================
``use``            nothing — the site is served from a cache (reuse
                   schedules; not ported yet, so never chosen by the port)
``flash``          plain attention (``models.nn.fused_attention``: K1 at
                   S ≥ 2048, the einsum below) — sites no controller touches
``fused-edit``     the in-kernel edit (K2, ``kernels.fused_edit``)
``materialized``   the f32 probabilities through ``apply_attention_control``
                   — touched sites the kernel cannot express (store sites)
                   or that the config does not cover
=================  =========================================================
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from ..controllers.base import AttnMeta, Controller, controller_touches
from ..controllers.kernel_spec import kernel_edit_spec

VARIANT_USE = "use"
VARIANT_FLASH = "flash"
VARIANT_FUSED = "fused-edit"
VARIANT_MATERIALIZED = "materialized"


def site_name(meta: AttnMeta) -> str:
    """The canonical name of one attention site (``cross_attn/down3``) — a
    copy of ``p2p_tpu/engine/reuse.py:site_name``."""
    kind = "cross_attn" if meta.is_cross else "self_attn"
    return f"{kind}/{meta.place}{meta.layer_idx}"


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Fused-kernel dispatch plan. ``sites``: ``"*"`` fuses every
    kernel-compilable site; a tuple of site names restricts fusion to those.
    ``block_q`` is kept for signature parity with the JAX package; the CUDA
    kernel picks its own query tile."""

    sites: Union[str, Tuple[str, ...]] = "*"
    block_q: int = 0

    def __post_init__(self):
        if self.sites != "*" and not isinstance(self.sites, tuple):
            raise ValueError(
                f"KernelConfig.sites must be '*' or a tuple of site names, "
                f"got {self.sites!r}")

    def covers(self, name: str) -> bool:
        return self.sites == "*" or name in self.sites


def site_variant(kernels: Optional[KernelConfig],
                 controller: Optional[Controller],
                 meta: AttnMeta, mode: str = "off") -> str:
    """The attention variant for one site. ``mode`` is the site's
    reuse-schedule action (``"off"`` on the port's path)."""
    if mode == "use":
        return VARIANT_USE
    if not controller_touches(controller, meta):
        return VARIANT_FLASH
    if (kernels is not None and kernels.covers(site_name(meta))
            and kernel_edit_spec(controller, meta) is not None):
        return VARIANT_FUSED
    return VARIANT_MATERIALIZED
