"""Solver-distilled training (``train/distill.py``) against the JAX package
on the CPU.

* ``diverse_clip``: numpy, bit for bit the JAX package's, every family.
* ``generate_targets``: the clips, patterns and band magnitudes as the JAX
  package's (the bands to 1e-5), and the solver's targets over 3
  iterations of the float32 slab path on both sides (``matmul_precision
  "highest"``): NAdam's early moves are nearly lr * sign(g), so an element
  whose gradient rounds to the other sign moves the other way; all but
  1 % of the target elements agree to 1e-4 of the band's scale.  On the
  default card the port's targets come from the whole-step kernel path
  (its plain version here), which runs 3 iterations to finite targets
  inside the box.
* One step of ``make_distill_step`` and ``make_distill_step_visible``
  against the JAX package's with the same parameters: the metrics to
  1e-4 relative and the moves as tests/test_torch_train.py holds them;
  then five more steps with finite losses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.models import init_params
from aware_tpu.train import adversarial as jadv
from aware_tpu.train import distill as jdistill
from aware_tpu_torch.config import AwareConfig
from aware_tpu_torch.train import adversarial as adv
from aware_tpu_torch.train import distill

SECONDS = 0.5
METRIC_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def d_params():
    return {k: np.asarray(v) for k, v in init_params(JaxConfig().detection_net).items()}


def _clip(seed: int) -> np.ndarray:
    return distill.diverse_clip(seed, SECONDS)


def _jax_clip(seed: int) -> np.ndarray:
    return jdistill.diverse_clip(seed, SECONDS)


def test_diverse_clip_bit_for_bit():
    for seed in range(8):
        for seconds in (0.25, 2.0):
            np.testing.assert_array_equal(distill.diverse_clip(seed, seconds),
                                          jdistill.diverse_clip(seed, seconds))


def test_generate_targets_matches_jax(d_params):
    flags = dict(matmul_precision="highest")
    ours = distill.generate_targets(d_params, AwareConfig(**flags), 3, batch=2, seed=4,
                                    clip_fn=_clip, solver_iterations=3, device="cpu")
    ref = jdistill.generate_targets({k: jnp.asarray(v) for k, v in d_params.items()},
                                    JaxConfig().replace(**flags), 3, batch=2, seed=4,
                                    clip_fn=_jax_clip, solver_iterations=3)
    clips, bands, pats, targets = ours
    np.testing.assert_array_equal(clips, ref[0])
    np.testing.assert_array_equal(pats, ref[2])
    np.testing.assert_allclose(bands, ref[1], rtol=1e-5, atol=1e-5)
    assert targets.shape == ref[3].shape == bands.shape
    scale = np.abs(bands).max()
    assert np.mean(np.abs(targets - ref[3]) > 1e-4 * scale) <= 0.01
    # the default card: the whole-step kernel path
    default = distill.generate_targets(d_params, AwareConfig(), 2, batch=2, seed=4,
                                       clip_fn=_clip, solver_iterations=3, device="cpu")
    box = 10.0 ** (-AwareConfig().tolerance_db / 20.0)
    assert np.all(np.isfinite(default[3]))
    assert np.all(np.abs(default[3] - default[1]) <= box * default[1] * (1 + 1e-5) + 1e-6)


def _states(d_params, phase: bool):
    ecfg = dict(hidden=(32, 32), phase_conditioned=phase)
    je = jadv.init_embedder_params(jadv.AmortizedEmbedderConfig(**ecfg), 225, 20)
    jtcfg = jadv.TrainConfig(learning_rate=3e-4)
    jstate = jadv.TrainState(je, {k: jnp.asarray(v) for k, v in d_params.items()},
                             jdistill.distill_optimizer(jtcfg).init(je), jnp.zeros((), jnp.int32))
    tcfg = adv.TrainConfig(learning_rate=3e-4)
    e = adv._as_params({k: np.asarray(v) for k, v in je.items()}, "cpu")
    state = adv.TrainState(e, adv._as_params(d_params, "cpu"),
                           distill.distill_optimizer(tcfg).init({"e": e}), 0)
    return state, jstate, tcfg, jtcfg


def _hold(state, new, m, jstate, jnew, jm, lr):
    assert new.step == 1
    for k in m:
        assert abs(float(m[k]) - float(jm[k])) <= METRIC_TOL * abs(float(jm[k])) + 1e-6, k
    for k in new.e_params:
        move = (new.e_params[k] - state.e_params[k]).numpy()
        want = np.asarray(jnew.e_params[k]) - np.asarray(jstate.e_params[k])
        assert np.abs(want).max() > 0.5 * lr, k
        assert np.mean(np.abs(move - want) > 0.05 * lr) <= 0.01, k


def _more_steps(step, state, batch):
    for _ in range(5):
        state, m = step(state, *batch)
        assert all(np.isfinite(float(v)) for v in m.values())
    assert state.step == 6


def test_distill_step_matches_jax(d_params):
    state, jstate, tcfg, jtcfg = _states(d_params, phase=False)
    cfg = AwareConfig()
    clips = np.stack([_clip(s) for s in range(2)])
    _, bands, pats, targets = distill.generate_targets(d_params, cfg, 2, batch=2, seed=1,
                                                       clip_fn=_clip, solver_iterations=2,
                                                       device="cpu")
    assert clips.shape[0] == bands.shape[0]
    jnew, jm = jax.jit(jdistill.make_distill_step(JaxConfig(), jtcfg))(
        jstate, jnp.asarray(bands), jnp.asarray(pats), jnp.asarray(targets))
    step = distill.make_distill_step(cfg, tcfg)
    new, m = step(state, bands, pats, targets)
    _hold(state, new, m, jstate, jnew, jm, tcfg.learning_rate)
    _more_steps(step, new, (bands, pats, targets))


def test_distill_step_visible_matches_jax(d_params):
    state, jstate, tcfg, jtcfg = _states(d_params, phase=True)
    cfg = AwareConfig()
    clips, _, pats, targets = distill.generate_targets(d_params, cfg, 2, batch=2, seed=2,
                                                       clip_fn=_clip, solver_iterations=2,
                                                       device="cpu")
    jnew, jm = jax.jit(jdistill.make_distill_step_visible(JaxConfig(), jtcfg))(
        jstate, jnp.asarray(clips), jnp.asarray(pats), jnp.asarray(targets))
    step = distill.make_distill_step_visible(cfg, tcfg)
    new, m = step(state, clips, pats, targets)
    _hold(state, new, m, jstate, jnew, jm, tcfg.learning_rate)
    _more_steps(step, new, (clips, pats, targets))
