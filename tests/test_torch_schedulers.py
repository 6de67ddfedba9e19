"""The port's schedulers against the JAX package's (``p2p_tpu/ops/schedulers.py``).

Timesteps and constants for DDIM, PLMS and DPM-Solver++; PLMS through its
warm-up (counters 0 to 5), DPM through its first, second-order and final
steps, DDPM fed the JAX package's own ``jax.random.normal`` draw, and
``add_noise``: each output within 1e-6 of the JAX one, relative to its
largest magnitude, in f32 (the same f32 arithmetic in the same order; the
JAX side runs eagerly). One bf16 PLMS step at each counter, from the same
bf16 state: the output within one bf16 ulp, the port's ring staying bf16.
And the port's DPM-20 against DDIM-50 on ``tests/test_dpm_quality.py``'s
analytic problem, held to ``tests/golden/dpm_quality.json``.
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.models import config as j_config  # noqa: E402
from p2p_tpu.ops import schedulers as J  # noqa: E402

from p2p_tpu_torch.models import config as p_config  # noqa: E402
from p2p_tpu_torch.ops import schedulers as P  # noqa: E402

SHAPE = (2, 8, 8, 4)
REL = 1e-6
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "dpm_quality.json")


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30), (
        np.abs(got - want).max(), np.abs(want).max())


def _draws(n, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(dtype) for _ in range(n)]


@pytest.mark.parametrize("kind", ["ddim", "plms", "dpm"])
@pytest.mark.parametrize("preset", ["sd14", "ldm256"])
@pytest.mark.parametrize("steps", [4, 20, 50])
def test_schedule_matches_jax(kind, preset, steps):
    jc = j_config.PRESET_CONFIGS[preset].scheduler
    pc = p_config.PRESET_CONFIGS[preset].scheduler
    js = J.schedule_from_config(steps, jc, kind=kind)
    ps = P.schedule_from_config(steps, pc, kind=kind)
    np.testing.assert_array_equal(ps.timesteps.numpy(), np.asarray(js.timesteps))
    np.testing.assert_array_equal(ps.alphas_cumprod.numpy(),
                                  np.asarray(js.alphas_cumprod))
    assert float(ps.final_alpha_cumprod) == float(js.final_alpha_cumprod)
    assert ps.step_size == js.step_size
    if kind == "plms":
        assert len(ps.timesteps) == steps + 1


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown schedule kind"):
        P.make_schedule(10, kind="euler")
    with pytest.raises(ValueError, match="unknown scheduler kind"):
        P.init_multistep_state("euler", SHAPE)


def test_plms_steps_match_jax():
    """Six PLMS evaluations (counters 0 to 5: the raw step, the warm-up
    re-evaluation, the 2nd-, 3rd- and 4th-order combinations) over the
    same ε's from the same sample, SD-1.4's PNDM offset."""
    steps = 5
    js = J.make_schedule(steps, kind="plms", steps_offset=1)
    ps = P.make_schedule(steps, kind="plms", steps_offset=1)
    x0, *eps = _draws(1 + len(ps.timesteps), 0)
    jst, pst = J.init_plms_state(SHAPE), P.init_plms_state(SHAPE)
    jx, px = jnp.asarray(x0), torch.from_numpy(x0)
    for t, e in zip(ps.timesteps.tolist(), eps):
        jst, jx = J.plms_step(js, jst, jnp.asarray(e), jnp.int32(t), jx)
        pst, px = P.plms_step(ps, pst, torch.from_numpy(e), t, px)
        _close(px.numpy(), jx)
        assert pst.counter == int(jst.counter)
        for a, b in zip(pst.ets, np.asarray(jst.ets)):
            _close(a.numpy(), b)
        _close(pst.cur_sample.numpy(), jst.cur_sample)


@pytest.mark.parametrize("counter", [0, 1, 2, 3, 4])
def test_plms_bf16_step_matches_jax(counter):
    """One bf16 PLMS step (bf16 sample and ring, the f32 ε CFG hands it) at
    each counter, from the same state on both sides: the output within one
    bf16 ulp, the port's ring and saved sample still bf16."""
    sched_args = dict(kind="plms", steps_offset=1)
    js, ps = J.make_schedule(10, **sched_args), P.make_schedule(10, **sched_args)
    x, cur, e, *ring = _draws(7, counter + 1)
    t = int(ps.timesteps[min(counter, 3)])
    to16 = lambda a: jnp.asarray(a, jnp.bfloat16)     # noqa: E731
    jst = J.PlmsState(ets=jnp.stack([to16(r) for r in ring]),
                      counter=jnp.int32(counter), cur_sample=to16(cur))
    pst = P.PlmsState(ets=tuple(torch.from_numpy(r).to(torch.bfloat16) for r in ring),
                      counter=counter,
                      cur_sample=torch.from_numpy(cur).to(torch.bfloat16))
    _, jx = J.plms_step(js, jst, jnp.asarray(e), jnp.int32(t), to16(x))
    pst, px = P.plms_step(ps, pst, torch.from_numpy(e), t,
                          torch.from_numpy(x).to(torch.bfloat16))
    assert px.dtype == torch.bfloat16 and jx.dtype == jnp.bfloat16
    assert all(r.dtype == torch.bfloat16 for r in pst.ets)
    assert pst.cur_sample.dtype == torch.bfloat16
    got, want = px.float().numpy(), np.asarray(jx.astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.max(np.abs(got - want) / ulp) <= 1.0


@pytest.mark.parametrize("clip", [False, True])
def test_dpm_steps_match_jax(clip):
    """Eight DPM-Solver++ steps, the first order-1, the rest order-2 but
    the final one (t − Δ < 0), over the same ε's."""
    steps = 8
    js = J.make_schedule(steps, kind="dpm", clip_sample=clip)
    ps = P.make_schedule(steps, kind="dpm", clip_sample=clip)
    x0, *eps = _draws(1 + steps, 2)
    jst, pst = J.init_dpm_state(SHAPE), P.init_dpm_state(SHAPE)
    jx, px = jnp.asarray(x0), torch.from_numpy(x0)
    for t, e in zip(ps.timesteps.tolist(), eps):
        jst, jx = J.dpm_step(js, jst, jnp.asarray(e), jnp.int32(t), jx)
        pst, px = P.dpm_step(ps, pst, torch.from_numpy(e), t, px)
        _close(px.numpy(), jx)
        _close(pst.x0_prev.numpy(), jst.x0_prev)
        assert abs(float(pst.lam_prev) - float(jst.lam_prev)) <= REL * abs(float(jst.lam_prev))


@pytest.mark.parametrize("t_index", [0, 5, 9])
def test_ddpm_step_matches_jax_with_its_noise(t_index):
    """Fed the JAX package's own ``jax.random.normal`` draw; the last
    timestep (t − Δ < 0) is the mean alone on both sides."""
    js, ps = J.make_schedule(10), P.make_schedule(10)
    t = int(ps.timesteps[t_index])
    x, e = _draws(2, 3)
    rng = jax.random.PRNGKey(t_index)
    want = J.ddpm_step(js, jnp.asarray(e), jnp.int32(t), jnp.asarray(x), rng)
    noise = np.asarray(jax.random.normal(rng, SHAPE, dtype=jnp.float32))
    got = P.ddpm_step(ps, torch.from_numpy(e), t, torch.from_numpy(x),
                      noise=torch.from_numpy(noise))
    _close(got.numpy(), want)
    if t_index == 9:                       # the mean: any draw gives it
        gen = torch.Generator().manual_seed(0)
        _close(P.ddpm_step(ps, torch.from_numpy(e), t, torch.from_numpy(x),
                           generator=gen).numpy(), want)


def test_add_noise_matches_jax():
    js, ps = J.make_schedule(50), P.make_schedule(50)
    x0, noise = _draws(2, 4)
    for t in (0, 500, 999):
        _close(P.add_noise(ps, torch.from_numpy(x0), torch.from_numpy(noise), t).numpy(),
               J.add_noise(js, jnp.asarray(x0), jnp.asarray(noise), jnp.int32(t)))
    ts = np.array([10, 700], np.int64)            # one timestep a sample
    _close(P.add_noise(ps, torch.from_numpy(x0), torch.from_numpy(noise),
                       torch.from_numpy(ts)).numpy(),
           J.add_noise(js, jnp.asarray(x0), jnp.asarray(noise),
                       jnp.asarray(ts, jnp.int32)))


# --- tests/test_dpm_quality.py's analytic problem, through the port's steps

T_START, T_STOP = 900, 100


def _lam(a):
    return 0.5 * math.log(a / (1.0 - a))


def _anti(lam):
    return math.exp(lam) * (math.sin(lam) - math.cos(lam)) / 2.0


def _solve(kind, n):
    """Max per-step |x − exact| integrating x0-prediction sin(λ) over
    t ∈ [100, 900] with the port's ``ddim_step`` / ``dpm_step``."""
    sched = P.make_schedule(n, kind="ddim")
    x = torch.tensor([1.0])
    x_true, max_err = 1.0, 0.0
    ms = P.init_dpm_state(x.shape)
    for t in sched.timesteps.tolist():
        if t > T_START or t - sched.step_size < T_STOP:
            continue
        a = float(P._alpha_at(sched, t))
        a_n = float(P._alpha_at(sched, t - sched.step_size))
        eps = (x - math.sqrt(a) * math.sin(_lam(a))) / math.sqrt(1.0 - a)
        if kind == "dpm":
            ms, x = P.dpm_step(sched, ms, eps, t, x)
        else:
            x = P.ddim_step(sched, eps, t, x)
        s_a, s_n = math.sqrt(1.0 - a), math.sqrt(1.0 - a_n)
        x_true = (s_n / s_a) * x_true + s_n * (_anti(_lam(a_n)) - _anti(_lam(a)))
        max_err = max(max_err, abs(float(x[0]) - x_true))
    return max_err


def test_dpm20_beats_ddim50_as_the_golden_file_says():
    err = {f"{kind}{n}": _solve(kind, n)
           for kind, n in (("ddim", 20), ("ddim", 50), ("dpm", 10), ("dpm", 20))}
    assert err["dpm20"] * 3 < err["ddim50"], err
    assert err["dpm10"] < err["ddim20"], err
    assert err["ddim50"] < err["ddim20"] and err["dpm20"] < err["dpm10"], err
    with open(GOLDEN) as f:
        committed = json.load(f)["abs_error"]
    for k, v in err.items():
        assert abs(committed[k] - v) <= 0.2 * max(v, 1e-6) + 1e-9, (k, committed[k], v)
