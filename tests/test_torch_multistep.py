"""The port's PLMS and DPM-Solver++ sampling against the JAX package's, on
TINY: a Replace + LocalBlend + Reweight edit of 50 steps through
``text2image(scheduler=...)``, materialized and with the kernels (their
plain versions on the CPU), against the JAX program's scan with its
multistep carry. A 50-step PLMS run makes 51 U-Net calls, so its step index
runs to 50 and the controller reads the last of its 51 ``cross_alpha``
rows; the kernels' operands, the self window and LocalBlend's start are
also held to JAX's at every step index of such a run.

Same weights (numpy-made, ``tests/test_torch_ldm.py:numpy_pipes``), one
numpy-seeded x_T. Bars as
``tests/test_torch_pipeline.py``: final latents ≤ 1e-3, uint8 images
max ≤ 3 and mean ≤ 0.5; the operands exact up to f32 rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from p2p_tpu.controllers import kernel_spec as j_kspec  # noqa: E402
from p2p_tpu.models import TINY as J_TINY  # noqa: E402
from p2p_tpu.models.config import unet_layout as j_unet_layout  # noqa: E402

from p2p_tpu_torch.controllers import kernel_spec as p_kspec  # noqa: E402
from p2p_tpu_torch.kernels import KernelConfig  # noqa: E402
from p2p_tpu_torch.models.config import TINY, unet_layout  # noqa: E402
from p2p_tpu_torch.ops import schedulers as P  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer as PTok  # noqa: E402
from tests.test_torch_bf16_inversion import few_threads  # noqa: E402,F401
from tests.test_torch_ldm import assert_f32_match, jax_run, numpy_pipes, port_run  # noqa: E402
from tests.test_torch_replay import _controllers  # noqa: E402

STEPS = 50
X_T = np.random.RandomState(8).randn(1, 16, 16, 4).astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    return numpy_pipes("TINY", (JTok(model_max_length=16), PTok(model_max_length=16)), 8)


@pytest.fixture(scope="module")
def jax_edit(pipes):
    """The JAX package's 50-step edit under ``scheduler``, run once a
    scheduler for both of the port's runs."""
    done = {}

    def run(scheduler):
        if scheduler not in done:
            jc, _ = _controllers(steps=STEPS)
            done[scheduler] = jax_run(pipes[0], jc, X_T, None, scheduler=scheduler,
                                      steps=STEPS)
        return done[scheduler]

    return run


@pytest.mark.parametrize("kernels", ["none", "fused"])
@pytest.mark.parametrize("scheduler", ["plms", "dpm"])
def test_edit_matches_jax(pipes, jax_edit, scheduler, kernels):
    _, pc = _controllers(steps=STEPS)
    got = port_run(pipes[1], pc, X_T, KernelConfig() if kernels == "fused" else None,
                   scheduler=scheduler, steps=STEPS)
    assert_f32_match(got, jax_edit(scheduler))


@pytest.mark.parametrize("steps", [4, 9])
def test_plms_runs_one_more_unet_call_than_steps(pipes, monkeypatch, steps):
    """T PLMS steps: T + 1 U-Net calls with step indices 0..T (the last
    reads the last of ``cross_alpha``'s T + 1 rows); DPM: T calls."""
    from p2p_tpu_torch.engine import sampler as psampler

    seen, inner = [], psampler.apply_unet

    def spy(*a, step, **kw):
        seen.append(step)
        return inner(*a, step=step, **kw)

    monkeypatch.setattr(psampler, "apply_unet", spy)
    _, pc = _controllers(steps=steps)
    assert pc.edit.cross_alpha.shape[0] == steps + 1
    for scheduler, calls in (("plms", steps + 1), ("dpm", steps)):
        seen.clear()
        port_run(pipes[1], pc, X_T, KernelConfig(), scheduler=scheduler, steps=steps)
        assert seen == list(range(calls))
        assert len(P.schedule_from_config(steps, TINY.scheduler,
                                          kind=scheduler).timesteps) == calls


def test_step_windows_and_operands_match_jax_at_every_plms_step():
    """At every step index of a 50-step PLMS run (0..50): the kernels'
    operands at each edited site, the self window and LocalBlend's start
    agree with the JAX package's."""
    jc, pc = _controllers(steps=STEPS)
    assert (pc.edit.self_start, pc.edit.self_end) == (int(jc.edit.self_start),
                                                      int(jc.edit.self_end))
    assert pc.blend.start_blend == int(jc.blend.start_blend)
    sites = [(jm, pm) for jm, pm in zip(j_unet_layout(J_TINY.unet).metas,
                                        unet_layout(TINY.unet).metas)
             if p_kspec.kernel_edit_spec(pc, pm) is not None]
    assert any(pm.is_cross for _, pm in sites) and any(not pm.is_cross for _, pm in sites)
    for step in range(STEPS + 1):
        for jm, pm in sites:
            js, ps = j_kspec.kernel_edit_spec(jc, jm), p_kspec.kernel_edit_spec(pc, pm)
            assert (ps.kind, ps.is_cross, ps.key_len, ps.pad_len) == (
                js.kind, js.is_cross, js.key_len, js.pad_len)
            want = j_kspec.edit_operands(jc.edit, js, jnp.int32(step))
            got = p_kspec.edit_operands(pc.edit, ps, step)
            assert sorted(got) == sorted(want)
            for name in want:
                np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                           rtol=0, atol=1e-6)
