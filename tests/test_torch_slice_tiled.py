"""The fourth slice as a whole: clips over 1024 frames, on the port's "tiled"
path (synth_tiled_fwd and shift_mm, ops/kernels/roundtrip_tiled.py), on the
CPU, where the kernels' wrappers run their plain versions.

* The path selection of ``build_problem``, as the JAX package's gate
  (``aware_tpu/embed/solver.py:383-398``): past 1024 frames the tiled
  kernels, whatever the detector, iteration or optimizer settings say; at
  1024 frames the whole-step path stays.
* The first objective and its gradient against the JAX package's
  ``build_problem(...)`` objective with ``use_pallas_roundtrip=True`` (its
  tiled kernels in interpret mode), on two speech-like clips of 1100
  frames, at the JAX package's starting coefficients: the loss to 1e-4
  relative, the gradient to 5e-2 in relative L2 norm, the bounds of
  tests/test_torch_slice.py and for the same reason (y2 is rounded to bf16
  before the analysis, so ulp differences in the two packages' STFTs flip
  a few roundings, and the detector's norms amplify that in the gradient).
* A short batched solve runs and keeps its box.
* The public API on a 17 s clip given at 44.1 kHz: the spectral VAD, the
  resample path both ways, the batch embed on the tiled path (25
  iterations), ``_reconstruct`` and detect read the message back.
* (slow) A 20 s clip embeds in 400 iterations and reads back at 0 % BER,
  by the port's detector and the JAX package's, as
  tests/test_pallas_tiled.py::test_long_clip_solver_outcome holds the
  JAX package's tiled path.
"""

import numpy as np
import pytest
import torch

import aware_tpu_torch

import jax
import jax.numpy as jnp

from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.embed.solver import build_problem as jax_build_problem
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
from aware_tpu_torch.ops.resample import resample

SR, HOP = 16000, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    return DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)


def _speechlike(frames: int, seed: int) -> np.ndarray:
    """A speech-like clip of ``frames`` STFT frames ((frames-1)*hop samples),
    the suite's harmonic fixture with noise from ``seed``."""
    t = np.arange((frames - 1) * HOP) / SR
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)) / SR)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _message(seed, batch=1):
    bits = np.random.default_rng(seed).integers(0, 2, (batch, 20))
    return bits, torch.from_numpy((2.0 * bits - 1.0).astype(np.float32))


@pytest.mark.parametrize("frames, overrides, path", [
    (1025, {}, "tiled"),
    (1025, {"use_pallas_iteration": False}, "tiled"),
    (1025, {"use_pallas_detector": False}, "tiled"),
    (1025, {"optimizer_params": {"lr": 0.1, "weight_decay": 1e-4}}, "tiled"),
    (1024, {}, "iteration_step"),
])
def test_path_selection_follows_the_jax_gate(net, frames, overrides, path):
    _, wm = _message(0)
    x = torch.from_numpy(_speechlike(frames, 1))[None]
    pb = solver.build_problem(net, x, wm, AwareConfig(**overrides))
    assert pb.ct0.shape[1] == frames and pb.path == path
    if path == "tiled":
        assert pb.fused is None and pb.iteration is None and pb.csin is None
        assert pb.tiled.csinp.dtype == torch.float32
        assert pb.tiled.csinp.shape == (1, frames + 3, 2 * pb.ct0.shape[2])
    else:
        assert pb.tiled is None


def _first_step(net, clips, wm, move=0.0):
    """For each clip: the JAX loss and gradient at the JAX package's
    starting coefficients (an ulp of difference in them can flip the bf16
    rounding of their products), the port's there, and, with ``move``, the
    JAX loss and gradient at those coefficients moved by ``move`` of
    themselves.  Returns a list of (jl, jg, loss, grad, moved)."""
    jax_cfg = JaxConfig().replace(use_pallas_roundtrip=True)
    params = {k: jnp.asarray(v) for k, v in init_params(jax_cfg.detection_net).items()}
    cfg = AwareConfig()
    pb = solver.build_problem(net, torch.from_numpy(clips), wm, cfg)
    assert pb.path == "tiled"
    ct0, jax_out = [], []
    for i in range(len(clips)):
        jpb = jax_build_problem(params, jnp.asarray(clips[i]), jnp.asarray(wm[i].numpy()),
                                jax_cfg)
        objective_ct, to_carry = jpb.carry[0], jpb.carry[1]
        c0 = to_carry(jpb.coeffs0)
        assert "pallas" in str(jax.make_jaxpr(objective_ct)(c0)).lower()
        np.testing.assert_allclose(pb.ct0[i].numpy(), np.asarray(c0), rtol=1e-5, atol=1e-5)
        value_and_grad = jax.jit(jax.value_and_grad(objective_ct))
        jl, jg = value_and_grad(c0)
        moved = None
        if move:
            noise = np.random.default_rng(i).standard_normal(c0.shape).astype(np.float32)
            ml, mg = value_and_grad(jnp.asarray(np.asarray(c0) * (1 + move * noise)))
            moved = (float(ml), np.asarray(mg))
        ct0.append(np.asarray(c0))
        jax_out.append((float(jl), np.asarray(jg), moved))
    # the clips' losses are independent, so one batched call gives both
    ct = torch.from_numpy(np.stack(ct0)).requires_grad_(True)
    loss = solver.objective(ct, pb, net, cfg)
    (grad,) = torch.autograd.grad(loss.sum(), ct)
    return [(jl, jg, loss[i].item(), grad[i].numpy(), moved)
            for i, (jl, jg, moved) in enumerate(jax_out)]


def _long_pair():
    clips = np.stack([_speechlike(1100, 7), np.roll(_speechlike(1100, 8), 999)])
    return clips, _message(3, 2)[1]


def test_first_objective_and_gradient_match_jax(net):
    for jl, jg, loss, grad, _ in _first_step(net, *_long_pair()):
        assert abs(loss - jl) <= 1e-4 * abs(jl)
        assert np.linalg.norm(grad - jg) <= 5e-2 * np.linalg.norm(jg)


def test_short_solve_keeps_the_box(net):
    frames = 1030
    clips = np.stack([_speechlike(frames, 11), _speechlike(frames, 12)[::-1].copy()])
    _, wm = _message(4, 2)
    cfg = AwareConfig(num_iterations=3)
    x = torch.from_numpy(clips)
    pb = solver.build_problem(net, x, wm, cfg)
    res = solver.embed_batch(net, x, wm, cfg)
    assert res.audio.shape == (2, (frames - 1) * HOP) and torch.isfinite(res.audio).all()
    assert res.coeffs.shape == (2, pb.nb, frames)
    lower = pb.lower[..., : pb.nb].transpose(1, 2)
    upper = pb.upper[..., : pb.nb].transpose(1, 2)
    assert torch.all(res.coeffs >= lower) and torch.all(res.coeffs <= upper)
    assert torch.all(res.best_loss <= res.final_loss + 1e-6)
    with torch.no_grad():  # the solve made headway from the start
        assert torch.all(res.best_loss < solver.objective(pb.ct0, pb, net, cfg))


def test_public_api_long_clip_44k(monkeypatch):
    emb, det = aware_tpu_torch.load(device="cpu", num_iterations=25)
    clip = resample(torch.from_numpy(_speechlike(1064, 13)), SR, 44100).numpy()
    bits = np.random.default_rng(13).integers(0, 2, 20)
    paths, build = [], solver.build_problem

    def build_and_record(*args):
        pb = build(*args)
        paths.append(pb.path)
        return pb

    monkeypatch.setattr(solver, "build_problem", build_and_record)
    out = aware_tpu_torch.embed_watermark(clip, 44100, bits, emb)
    assert paths == ["tiled"]
    assert out.shape == clip.shape and np.all(np.isfinite(out))
    np.testing.assert_array_equal(aware_tpu_torch.detect_watermark(out, 44100, det), bits)


@pytest.mark.slow
def test_long_clip_solver_outcome(net):
    """A 20 s clip (T = 1251 > 1024) embeds in 400 iterations through the
    tiled path and reads back at 0 % BER."""
    frames = 1251
    clip = _speechlike(frames, 5)
    bits, wm = _message(5)
    res = solver.embed_batch(net, torch.from_numpy(clip)[None], wm, AwareConfig())
    assert torch.isfinite(res.audio).all()
    values = detect_values_batch(net, res.audio).numpy()
    assert np.mean((values > 0).astype(int) != bits) == 0.0
    params = {k: jnp.asarray(v) for k, v in init_params(JaxConfig().detection_net).items()}
    jax_values = np.asarray(jax_detect_values(params, jnp.asarray(res.audio[0].numpy())))
    assert np.mean((jax_values > 0).astype(int) != bits[0]) == 0.0


def _readings(seeds: int = 4) -> None:
    """The first objective and gradient against JAX's, beside JAX's own
    move under a 1e-6 move of its coefficients; then the CPU plain solve's
    own spread on the tiled path: the 10-iteration best loss of 2 clips of
    T = 1025 and 1281 frames against the same solve with the clips moved
    by 1e-6 of themselves (chip_smoke.py's phase 5 holds the card's solve
    to the CPU's within 0.02)."""
    net = DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)
    for i, (jl, jg, loss, grad, (ml, mg)) in enumerate(_first_step(net, *_long_pair(), 1e-6)):
        scale = np.linalg.norm(jg)
        print(f"clip {i}, T = 1100: loss relative error {abs(loss - jl) / abs(jl):.3e} (JAX's "
              f"own {abs(ml - jl) / abs(jl):.3e}); gradient relative L2 "
              f"{np.linalg.norm(grad - jg) / scale:.3e} (JAX's own "
              f"{np.linalg.norm(mg - jg) / scale:.3e})")
    cfg = AwareConfig(num_iterations=10)
    for frames in (1025, 1281):
        worst = 0.0
        for seed in range(seeds):
            clips = np.stack([_speechlike(frames, 2 * seed), _speechlike(frames, 2 * seed + 1)])
            noise = np.random.default_rng(seed).standard_normal(clips.shape).astype(np.float32)
            _, wm = _message(seed, 2)
            a, b = (solver.embed_batch(net, torch.from_numpy(c), wm, cfg).best_loss
                    for c in (clips, clips * (1 + 1e-6 * noise)))
            worst = max(worst, float((a - b).abs().max()))
        print(f"T = {frames}: 10-iteration best loss moved by up to {worst:.3e} "
              f"under a 1e-6 move of the clips ({seeds} seeds, B = 2)")


if __name__ == "__main__":
    _readings()
