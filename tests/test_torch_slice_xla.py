"""The fifth slice as a whole: the float32 round trips of the port's "slab",
"frames", "ola" and "fft" paths (embed/solver.py), held against the JAX
package's ``build_problem`` on the same flags, on the CPU (the "ola"
path's kernel runs its plain version here, and the JAX kernel in
interpret mode).

* The path selection of ``build_problem``, as the JAX package's gate
  (``aware_tpu/embed/solver.py:318``, ``:352-357``, ``:383-390``):
  use_matmul_dft=False -> "fft"; use_pallas_ola -> "ola"; use_slab_dft=False
  -> "frames"; the slab decomposition without the kernels
  (use_pallas_roundtrip=False or matmul_precision "highest") -> "slab", at
  any length (a 1030-frame clip too); each path builds its own constants
  and no bf16 kernel constant.  On the JAX side each of these paths has no
  carry (no kernel round trip), and only "ola" reaches a Pallas kernel.
* The starting coefficients, the box, and the first objective and its
  gradient against the JAX objective on the same flags, at JAX's starting
  coefficients, on two 2 s clips (126 frames) and a 63-frame pair.  Both
  sides run float32 throughout, so the loss is held to LOSS_TOL relative
  and the gradient to GRAD_TOL in relative L2 norm;
  ``PYTHONPATH=. python tests/test_torch_slice_xla.py`` prints the
  readings (well inside both) beside JAX's own move under a 1e-6 move of
  its coefficients.
* A 10-iteration batched solve: best losses within 2e-2 of JAX
  ``embed_batch``'s, the bound of tests/test_pallas.py:83 (the loop is
  chaotic, so only the outcome is held).
* (slow) 400 iterations on each path read back at 0 % BER, by the port's
  detector and the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aware_tpu_torch
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
from aware_tpu_torch.ops.kernels import ola_norm

SR, HOP = 16000, 256
LOSS_TOL = 1e-5   # first objective, relative
GRAD_TOL = 1e-3   # first gradient, relative L2
# path: the flags that select it, the same on both packages
PATHS = {
    "slab": {"matmul_precision": "highest"},
    "frames": {"use_slab_dft": False},
    "ola": {"use_pallas_ola": True},
    "fft": {"use_matmul_dft": False},
}


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


@pytest.fixture(scope="module")
def jax_params():
    return {k: jnp.asarray(v) for k, v in init_params(JaxConfig().detection_net).items()}


def _speechlike(frames: int, seed: int) -> np.ndarray:
    """A speech-like clip of ``frames`` STFT frames, the suite's harmonic
    fixture with noise from ``seed``."""
    t = np.arange((frames - 1) * HOP) / SR
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)) / SR)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _pair(frames: int):
    clips = np.stack([_speechlike(frames, 21), np.roll(_speechlike(frames, 22), 777)])
    bits = np.random.default_rng(frames).integers(0, 2, (2, 20))
    return clips, bits, (2.0 * bits - 1.0).astype(np.float32)


@pytest.mark.parametrize("flags, path", [
    ({}, "iteration_step"),
    ({"matmul_precision": "highest"}, "slab"),
    ({"use_pallas_roundtrip": False}, "slab"),
    ({"matmul_precision": "highest", "use_pallas_iteration": False}, "slab"),
    ({"use_slab_dft": False}, "frames"),
    ({"use_slab_dft": False, "matmul_precision": "highest"}, "frames"),
    ({"use_pallas_ola": True}, "ola"),
    ({"use_pallas_ola": True, "use_slab_dft": False}, "ola"),
    ({"use_matmul_dft": False}, "fft"),
    ({"use_matmul_dft": False, "use_pallas_ola": True}, "fft"),
])
def test_path_selection_follows_the_jax_gate(net, flags, path):
    clips, _, wm = _pair(63)
    pb = solver.build_problem(net, torch.from_numpy(clips), torch.from_numpy(wm),
                              AwareConfig(**flags))
    assert pb.path == path
    if path != "iteration_step":
        # the plain paths build no bf16 kernel constant
        assert pb.plain is not None
        assert all(getattr(pb, f) is None for f in
                   ("csin", "ab", "abt", "csw", "cswt", "csw_k", "fused", "iteration", "tiled"))
        assert (pb.y_const is not None) == (path == "slab")
        assert (pb.plain.frames_const is not None) == (path in ("frames", "ola"))


@pytest.mark.parametrize("flags, path", [
    ({"matmul_precision": "highest"}, "slab"),
    ({"use_pallas_roundtrip": False}, "slab"),
    ({"use_pallas_ola": True}, "ola"),
    ({"use_slab_dft": False}, "frames"),
    ({}, "tiled"),
])
def test_clips_over_1024_frames_take_tiled_only_with_the_kernels(net, flags, path):
    x = torch.from_numpy(_speechlike(1030, 3))[None]
    pb = solver.build_problem(net, x, torch.ones(1, 20), AwareConfig(**flags))
    assert pb.ct0.shape[1] == 1030 and pb.path == path
    assert (pb.tiled is not None) == (path == "tiled")


def _first_step(net, jax_params, path, clips, wm, move=0.0):
    """Per clip: (JAX loss, JAX gradient (nb, T), the port's loss and
    gradient at JAX's starting coefficients, and with ``move`` JAX's loss
    and gradient at them moved by ``move`` of themselves)."""
    flags = PATHS[path]
    cfg = AwareConfig(**flags)
    jax_cfg = JaxConfig().replace(**flags)
    pb = solver.build_problem(net, torch.from_numpy(clips), torch.from_numpy(wm), cfg)
    assert pb.path == path
    out, c0s = [], []
    for i in range(len(clips)):
        jpb = jax_build_problem(jax_params, jnp.asarray(clips[i]), jnp.asarray(wm[i]), jax_cfg)
        assert jpb.carry is None  # no kernel round trip on these paths
        c0 = np.asarray(jpb.coeffs0)
        has_pallas = "pallas" in str(jax.make_jaxpr(jpb.objective)(jpb.coeffs0)).lower()
        assert has_pallas == (path == "ola")
        # the starting coefficients and the box, as the JAX package's
        for ours, ref in ((pb.ct0, c0), (pb.lower, jpb.lower), (pb.upper, jpb.upper)):
            np.testing.assert_allclose(ours[i, :, : pb.nb].numpy().T, np.asarray(ref),
                                       rtol=1e-5, atol=1e-5)
        value_and_grad = jax.jit(jax.value_and_grad(jpb.objective))
        jl, jg = value_and_grad(jpb.coeffs0)
        moved = None
        if move:
            noise = np.random.default_rng(i).standard_normal(c0.shape).astype(np.float32)
            ml, mg = value_and_grad(jnp.asarray(c0 * (1 + move * noise)))
            moved = (float(ml), np.asarray(mg))
        c0s.append(c0.T)
        out.append((float(jl), np.asarray(jg), moved))
    # the clips' losses are independent, so one batched call gives both
    ct = torch.zeros_like(pb.ct0)
    ct[..., : pb.nb] = torch.from_numpy(np.stack(c0s))
    ct.requires_grad_(True)
    loss = solver.objective(ct, pb, net, cfg)
    (grad,) = torch.autograd.grad(loss.sum(), ct)
    assert torch.all(grad[..., pb.nb :] == 0)  # the padding columns stay 0
    return [(jl, jg, loss[i].item(), grad[i, :, : pb.nb].numpy().T, moved)
            for i, (jl, jg, moved) in enumerate(out)]


@pytest.mark.parametrize("frames", [126, 63])
@pytest.mark.parametrize("path", list(PATHS))
def test_first_objective_and_gradient_match_jax(net, jax_params, path, frames):
    clips, _, wm = _pair(frames)
    for jl, jg, loss, grad, _ in _first_step(net, jax_params, path, clips, wm):
        assert abs(loss - jl) <= LOSS_TOL * abs(jl)
        assert np.linalg.norm(grad - jg) <= GRAD_TOL * np.linalg.norm(jg)


@pytest.mark.parametrize("path", list(PATHS))
def test_short_solve_matches_jax_outcome(net, jax_params, path):
    clips, _, wm = _pair(126)
    flags = dict(PATHS[path], num_iterations=10)
    ref = jax_embed_batch(jax_params, jnp.asarray(clips), jnp.asarray(wm),
                          JaxConfig().replace(**flags))
    before = [k.launches for k in ola_norm.KERNELS]
    ours = solver.embed_batch(net, torch.from_numpy(clips), torch.from_numpy(wm),
                              AwareConfig(**flags))
    assert [k.launches for k in ola_norm.KERNELS] == before  # nothing launched on the CPU
    audio = ours.audio.numpy()
    assert audio.shape == np.asarray(ref.audio).shape == (2, 125 * HOP)
    assert np.all(np.isfinite(audio))
    np.testing.assert_array_less(
        np.abs(ours.best_loss.numpy() - np.asarray(ref.best_loss)), 2e-2)
    assert np.all(ours.best_loss.numpy() <= ours.final_loss.numpy() + 1e-6)


def test_default_card_file_embeds_on_the_slab_path(monkeypatch):
    """The JAX package's default card file (matmul_precision: highest)
    loads, and the public API embeds through the "slab" path."""
    emb, det = aware_tpu_torch.load("config", device="cpu", num_iterations=25)
    assert emb.cfg.matmul_precision == "highest"
    paths, build = [], solver.build_problem

    def build_and_record(*args):
        pb = build(*args)
        paths.append(pb.path)
        return pb

    monkeypatch.setattr(solver, "build_problem", build_and_record)
    clips, bits, _ = _pair(126)
    out = aware_tpu_torch.embed_watermark_batch(clips, SR, bits, emb)
    assert paths == ["slab"] and np.all(np.isfinite(out))
    np.testing.assert_array_equal(aware_tpu_torch.detect_watermark_batch(out, SR, det), bits)


@pytest.mark.slow
@pytest.mark.parametrize("path", list(PATHS))
def test_full_solve_reads_back(net, jax_params, path):
    clips, bits, wm = _pair(126)
    res = solver.embed_batch(net, torch.from_numpy(clips), torch.from_numpy(wm),
                             AwareConfig(**PATHS[path]))
    assert torch.isfinite(res.audio).all()
    values = detect_values_batch(net, res.audio).numpy()
    assert np.all((values > 0).astype(int) == bits)
    for a, b in zip(res.audio.numpy(), bits):
        jax_values = np.asarray(jax_detect_values(jax_params, jnp.asarray(a)))
        assert np.all((jax_values > 0).astype(int) == b)


def _readings() -> None:
    """The first objective and gradient against JAX's on each path, beside
    JAX's own move under a 1e-6 move of its coefficients."""
    net = DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)
    params = {k: jnp.asarray(v) for k, v in init_params(JaxConfig().detection_net).items()}
    for frames in (126, 63):
        clips, _, wm = _pair(frames)
        for path in PATHS:
            for i, (jl, jg, loss, grad, (ml, mg)) in enumerate(
                    _first_step(net, params, path, clips, wm, 1e-6)):
                scale = np.linalg.norm(jg)
                print(f"{path}, T = {frames}, clip {i}: loss relative error "
                      f"{abs(loss - jl) / abs(jl):.3e} (JAX's own {abs(ml - jl) / abs(jl):.3e}); "
                      f"gradient relative L2 {np.linalg.norm(grad - jg) / scale:.3e} (JAX's own "
                      f"{np.linalg.norm(mg - jg) / scale:.3e})")


if __name__ == "__main__":
    _readings()
