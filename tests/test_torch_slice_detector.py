"""The second slice as a whole: the port's embed solver on the fused-detector
path (round-trip synthesis kernel, then the merged analysis + detector
kernels, ``use_pallas_iteration=False``) against the JAX package's
``build_problem`` / ``embed_batch`` under the same flags, on the CPU.

The 25-iteration solve, which is chaotic, is held at the outcome level,
as in tests/test_torch_slice.py: 0 % BER on every lane and best losses
within 0.02.  The first objective and gradient are held to the spread of
the JAX package's own objective on this path, which is far wider than on
the first slice's: the whole detector runs on bf16 operands with bf16
residuals, so an ulp of difference anywhere before a bf16 rounding flips
it, and the norms carry each flip on.  Moving the coefficients by 1e-6 of
themselves moves the JAX loss by up to 1.7e-4 relative and its gradient by
up to 0.16 in relative L2 norm (1 - cosine up to 0.014); the port against
JAX measured up to 1.15e-4 and 0.128 (1 - cosine 8.2e-3), over six clips
(``PYTHONPATH=. python tests/test_torch_slice_detector.py`` prints these
readings).
So: loss within 3e-4 relative, gradient within 0.2 in relative L2 and
1 - cosine 0.02.  Each kernel alone, given the same inputs, is held far
tighter in tests/test_torch_kernels_detector.py and
tests/test_torch_kernels_analysis_detector.py.

The clips are made here from their own seed, so that they do not depend on
which tests ran before in the same process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.embed.solver import build_problem as jax_build_problem
from aware_tpu.embed.solver import embed_batch as jax_embed_batch
from aware_tpu.models import detect_values as jax_detect_values
from aware_tpu.models import init_params
from aware_tpu_torch.config import AwareConfig
from aware_tpu_torch.embed import solver
from aware_tpu_torch.models.detector import (
    DetectorNet,
    detect_values_batch,
    load_key_params,
    params_from_jax,
)

ITERS = 25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_cfg():
    return JaxConfig().replace(use_pallas_roundtrip=True, use_pallas_detector=True,
                               use_pallas_iteration=False, num_iterations=ITERS)


@pytest.fixture(scope="module")
def jax_params(jax_cfg):
    return {k: jnp.asarray(v) for k, v in init_params(jax_cfg.detection_net).items()}


@pytest.fixture(scope="module")
def net():
    return DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)


def _speechlike(seed: int) -> np.ndarray:
    """The suite's 2 s speech-like clip (tests/conftest.py), noise from ``seed``."""
    sr = 16000
    t = np.arange(2 * sr) / sr
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)) / sr)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    bits = np.random.default_rng(19).integers(0, 2, (2, 20))
    clip = _speechlike(1234)
    return np.stack([clip, np.roll(clip, 4321)]), bits


def _ber(values, bits):
    return np.mean((np.asarray(values) > 0).astype(int) != bits, axis=-1)


def _first_step(jax_cfg, jax_params, net, clip, wm, move=0.0):
    """(JAX loss, JAX gradient, port loss, port gradient) at the JAX
    package's starting coefficients (an ulp of difference in them can flip
    the bf16 rounding of their products), and the JAX loss and gradient at
    those coefficients moved by ``move`` of themselves."""
    jpb = jax_build_problem(jax_params, jnp.asarray(clip), jnp.asarray(wm), jax_cfg)
    objective_ct, to_carry = jpb.carry[0], jpb.carry[1]
    ct0 = np.array(to_carry(jpb.coeffs0))
    value_and_grad = jax.jit(jax.value_and_grad(objective_ct))
    jl, jg = value_and_grad(jnp.asarray(ct0))
    moved = None
    if move:
        noise = np.random.default_rng(0).standard_normal(ct0.shape).astype(np.float32)
        ml, mg = value_and_grad(jnp.asarray(ct0 * (1 + move * noise)))
        moved = (float(ml), np.asarray(mg, np.float64))
    cfg = AwareConfig(use_pallas_iteration=False)
    pb = solver.build_problem(net, torch.from_numpy(clip)[None], torch.from_numpy(wm)[None], cfg)
    assert pb.fused is not None and pb.path == "analysis_detector"
    ct = torch.from_numpy(ct0)[None].requires_grad_(True)
    loss = solver.objective(ct, pb, net, cfg)
    (grad,) = torch.autograd.grad(loss.sum(), ct)
    return (float(jl), np.asarray(jg, np.float64), loss.item(),
            grad[0].numpy().astype(np.float64), moved)


def _spread(loss, grad, ref_loss, ref_grad):
    """(relative loss error, relative L2 gradient error, 1 - cosine)."""
    a, b = grad.ravel(), ref_grad.ravel()
    return (abs(loss - ref_loss) / abs(ref_loss), np.linalg.norm(a - b) / np.linalg.norm(b),
            1 - a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_first_objective_and_gradient_match_jax(jax_cfg, jax_params, net, batch):
    clips, bits = batch
    wm = (2.0 * bits - 1.0).astype(np.float32)
    for i in range(2):
        jl, jg, loss, grad, _ = _first_step(jax_cfg, jax_params, net, clips[i], wm[i])
        dl, dg, dcos = _spread(loss, grad, jl, jg)
        assert dl <= 3e-4 and dg <= 0.2 and dcos <= 0.02, (dl, dg, dcos)


def test_embed_batch_matches_jax_outcome(jax_cfg, jax_params, net, batch):
    clips, bits = batch
    wm = (2.0 * bits - 1.0).astype(np.float32)
    ref = jax_embed_batch(jax_params, jnp.asarray(clips), jnp.asarray(wm), jax_cfg)
    ours = solver.embed_batch(net, torch.from_numpy(clips), torch.from_numpy(wm),
                              AwareConfig(num_iterations=ITERS, use_pallas_iteration=False))
    audio = ours.audio.numpy()
    assert audio.shape == np.asarray(ref.audio).shape == (2, 125 * 256)
    assert np.all(np.isfinite(audio))
    assert np.all(_ber(detect_values_batch(net, ours.audio), bits) == 0.0)
    ref_values = np.stack([np.asarray(jax_detect_values(jax_params, a)) for a in ref.audio])
    assert np.all(_ber(ref_values, bits) == 0.0)
    jax_on_ours = np.stack([np.asarray(jax_detect_values(jax_params, jnp.asarray(a)))
                            for a in audio])
    assert np.all(_ber(jax_on_ours, bits) == 0.0)
    np.testing.assert_array_less(
        np.abs(ours.best_loss.numpy() - np.asarray(ref.best_loss)), 0.02)
    assert np.all(ours.best_loss.numpy() <= ours.final_loss.numpy() + 1e-6)


@pytest.mark.parametrize("seconds, fused", [(2.0, True), (6 * 256 / 16000, False)])
def test_objective_runs_the_banded_detector_only_off_the_gate(net, monkeypatch, seconds, fused):
    """Where the JAX gate holds (T >= 8 and the default detector), the
    objective goes through the merged kernels and never calls the plain
    detector; a 7-frame clip takes the round-trip path with it."""
    calls = []
    banded = DetectorNet.forward_banded

    def counting(self, *args):
        calls.append(args[0].shape)
        return banded(self, *args)

    monkeypatch.setattr(DetectorNet, "forward_banded", counting)
    n = int(seconds * 16000)
    clip = torch.from_numpy(np.random.default_rng(5).standard_normal((1, n)).astype(np.float32))
    cfg = AwareConfig(use_pallas_iteration=False)
    pb = solver.build_problem(net, clip, torch.ones(1, 20), cfg)
    assert (pb.fused is not None) == fused
    assert pb.ct0.shape[1] == (126 if fused else 7)
    loss = solver.objective(pb.ct0, pb, net, cfg)
    assert loss.shape == (1,) and torch.isfinite(loss).all()
    assert len(calls) == (0 if fused else 1)


def test_the_first_slice_path_stays_selectable(net, batch):
    clips, bits = batch
    wm = torch.from_numpy((2.0 * bits - 1.0).astype(np.float32))
    pb = solver.build_problem(net, torch.from_numpy(clips), wm,
                              AwareConfig(use_pallas_detector=False))
    assert pb.fused is None


if __name__ == "__main__":
    # The readings behind the first-step bounds: the port against JAX, and
    # JAX against itself with the coefficients moved by 1e-6 of themselves,
    # on clips with noise from seeds 0..5.
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    cfg = JaxConfig().replace(use_pallas_roundtrip=True, use_pallas_detector=True,
                              use_pallas_iteration=False, num_iterations=ITERS)
    params = {k: jnp.asarray(v) for k, v in init_params(cfg.detection_net).items()}
    detector = DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)
    message = (2.0 * np.random.default_rng(19).integers(0, 2, 20) - 1.0).astype(np.float32)
    for seed in range(6):
        jl, jg, loss, grad, (ml, mg) = _first_step(cfg, params, detector, _speechlike(seed),
                                                   message, move=1e-6)
        port = _spread(loss, grad, jl, jg)
        own = _spread(ml, mg, jl, jg)
        print(f"seed {seed}: port vs JAX: loss {port[0]:.3e}, gradient L2 {port[1]:.3e}, "
              f"1 - cos {port[2]:.3e}; JAX moved by 1e-6 vs JAX: loss {own[0]:.3e}, "
              f"gradient L2 {own[1]:.3e}, 1 - cos {own[2]:.3e}", flush=True)
