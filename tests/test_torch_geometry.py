"""The frame geometries that the JAX gate takes off the default kernels,
held against the JAX package on the CPU.

The JAX package's ``build_problem`` (``aware_tpu/embed/solver.py:352-390``)
takes the slab round trip where hop divides n_fft and n_fft / 2, with
r = n_fft / hop slabs and (n_fft / 2) / hop rows of centre padding; the
round-trip kernels only where n_fft = 4 hop and hop % 128 == 0; and the
frames round trip otherwise.  The port's gate is the same
(``aware_tpu_torch/embed/solver.py``).  Each geometry here:

    768 / 192    "slab", r = 4 (hop % 128 != 0)
    1024 / 512   "slab", r = 2
    2048 / 256   "slab", r = 8
    1024 / 200   "frames" (hop divides neither)
    2048 / 512   "band_analysis": the round-trip kernels (rows 1-4 of the
                 TPU kernel table) at P = 512, hop = 512; the fused
                 detector needs P = 256, so its plain detector follows

and the ``ola_normalize`` kernels (rows 14-15) at r = 2, 4 (hop 192) and 8
through ``use_pallas_ola``.  The JAX kernels run in interpret mode, as
the JAX suite runs them on the CPU.

Held: the path name, the first objective and its gradient at JAX's
starting coefficients (float32 paths to 1e-5 relative and 1e-3 relative
L2, as tests/test_torch_slice_xla.py; the bf16 kernel path to 1e-4 and
5e-2, as tests/test_torch_slice.py, whose docstring says why), and a
3-iteration embed's best loss within the 2e-2 of tests/test_pallas.py:83.
The refusals: detection at a frame length other than the net's n_fft
raises ValueError in both packages (the window is the card's win_length,
the frames the net's n_fft); ``win_length != frame_length`` raises
ValueError at ``load()``, as the JAX package's STFT raises at its first
call; ``use_pallas_ola`` where hop does not divide n_fft raises
ValueError at ``load()``, where the JAX kernel returns NaN.
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
from aware_tpu_torch.models.detector import DetectorNet, load_key_params, params_from_jax
from aware_tpu_torch.ops.kernels import ola_norm
from aware_tpu_torch.ops.kernels import roundtrip as rt

SR = 16000
PLAIN_TOL = (1e-5, 1e-3)   # float32 paths: loss relative, gradient relative L2
KERNEL_TOL = (1e-4, 5e-2)  # the bf16 round-trip kernels
# (n_fft, hop): the path both gates take, and the frames of the test clips
GEOMETRIES = {
    (768, 192): ("slab", 40),
    (1024, 512): ("slab", 24),
    (2048, 256): ("slab", 48),
    (1024, 200): ("frames", 48),
    (2048, 512): ("band_analysis", 20),
}
OLA = [(1024, 512), (768, 192), (2048, 256)]  # r = 2, 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _geometry(n_fft: int, hop: int, **flags) -> dict:
    return dict(frame_length=n_fft, hop_length=hop, win_length=n_fft, **flags)


def _jax_cfg(flags: dict) -> JaxConfig:
    # the JAX package turns its round-trip kernels on where it loads on a
    # TPU; the port's config has them on by default
    return JaxConfig().replace(use_pallas_roundtrip=True, **flags)


def _speechlike(samples: int, seed: int) -> np.ndarray:
    t = np.arange(samples) / SR
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)) / SR)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _pair(frames: int, hop: int):
    n = (frames - 1) * hop
    clips = np.stack([_speechlike(n, 31), np.roll(_speechlike(n, 32), 555)])
    bits = np.random.default_rng(frames + hop).integers(0, 2, (2, 20))
    return clips, bits, (2.0 * bits - 1.0).astype(np.float32)


def _first_step(net, jax_params, flags, clips, wm):
    """Per clip: (JAX loss, JAX gradient (nb, T), the port's loss and
    gradient at JAX's starting coefficients), and the port's problem."""
    cfg = AwareConfig(**flags)
    pb = solver.build_problem(net, torch.from_numpy(clips), torch.from_numpy(wm), cfg)
    jax_cfg = _jax_cfg(flags)
    out, c0s = [], []
    for i in range(len(clips)):
        jpb = jax_build_problem(jax_params, jnp.asarray(clips[i]), jnp.asarray(wm[i]), jax_cfg)
        c0 = np.asarray(jpb.coeffs0)
        for ours, ref in ((pb.ct0, c0), (pb.lower, jpb.lower), (pb.upper, jpb.upper)):
            np.testing.assert_allclose(ours[i, :, : pb.nb].numpy().T, np.asarray(ref),
                                       rtol=1e-5, atol=1e-5)
        jl, jg = jax.jit(jax.value_and_grad(jpb.objective))(jpb.coeffs0)
        c0s.append(c0.T)
        out.append((float(jl), np.asarray(jg)))
    ct = torch.zeros_like(pb.ct0)
    ct[..., : pb.nb] = torch.from_numpy(np.stack(c0s))
    ct.requires_grad_(True)
    loss = solver.objective(ct, pb, net, cfg)
    (grad,) = torch.autograd.grad(loss.sum(), ct)
    assert torch.all(grad[..., pb.nb :] == 0)
    return pb, [(jl, jg, loss[i].item(), grad[i, :, : pb.nb].numpy().T)
                for i, (jl, jg) in enumerate(out)]


def _hold(results, tol):
    loss_tol, grad_tol = tol
    for jl, jg, loss, grad in results:
        assert np.isfinite(loss) and np.all(np.isfinite(grad))
        assert abs(loss - jl) <= loss_tol * abs(jl)
        assert np.linalg.norm(grad - jg) <= grad_tol * np.linalg.norm(jg)


@pytest.mark.parametrize("geometry", list(GEOMETRIES), ids=lambda g: f"{g[0]}-{g[1]}")
def test_objective_and_gradient_match_jax(net, jax_params, geometry):
    path, frames = GEOMETRIES[geometry]
    clips, _, wm = _pair(frames, geometry[1])
    pb, results = _first_step(net, jax_params, _geometry(*geometry), clips, wm)
    assert pb.path == path
    if path == "band_analysis":
        assert pb.ct0.shape[-1] == 512 and pb.csw.shape == (2048, 1024)
    _hold(results, KERNEL_TOL if path == "band_analysis" else PLAIN_TOL)


@pytest.mark.parametrize("geometry", OLA, ids=lambda g: f"{g[0]}-{g[1]}")
def test_ola_kernel_at_r_slabs_matches_jax(net, jax_params, geometry):
    clips, _, wm = _pair(GEOMETRIES[geometry][1], geometry[1])
    flags = _geometry(*geometry, use_pallas_ola=True)
    pb, results = _first_step(net, jax_params, flags, clips, wm)
    assert pb.path == "ola"
    _hold(results, PLAIN_TOL)


@pytest.mark.parametrize("geometry", OLA, ids=lambda g: f"{g[0]}-{g[1]}")
def test_ola_plain_versions_at_r_slabs(geometry):
    """The kernels' plain versions at r slabs: the forward is the frames
    path's OLA + crop + envelope + double peak-norm, the VJP its autograd."""
    n_fft, hop = geometry
    r, pad = ola_norm.slabs(n_fft, hop)
    assert (r, pad) == (n_fft // hop, r // 2)
    gen = torch.Generator().manual_seed(n_fft + hop)
    t = 9
    wf = torch.randn(2, t, n_fft, generator=gen, dtype=torch.float64).requires_grad_(True)
    env = 0.5 + torch.rand(t - 1, hop, generator=gen, dtype=torch.float64)
    y2, m1 = ola_norm.ola_normalize_fwd_plain(wf, env)
    from aware_tpu_torch.ops.stft import istft_synthesis, peak_normalize

    ref = peak_normalize(peak_normalize(
        istft_synthesis(wf, n_fft, hop, None, env=env.reshape(-1)))).reshape(2, t - 1, hop)
    np.testing.assert_allclose(y2.detach().numpy(), ref.detach().numpy(), rtol=1e-12, atol=1e-14)
    g = torch.randn(2, t - 1, hop, generator=gen, dtype=torch.float64)
    (want,) = torch.autograd.grad((ref * g).sum(), wf)
    got = ola_norm.ola_normalize_bwd_plain(g, y2.detach(), env, m1.detach(), n_fft)
    assert got.shape == (2, t, n_fft)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-12)
    plan = ola_norm.ola_plan(2, t, hop, r=r)
    assert plan.grows[0][0] == 0 and plan.grows[-1][1] == t + r - 1
    assert all(a[1] == b[0] for a, b in zip(plan.grows, plan.grows[1:]))


@pytest.mark.parametrize("geometry", list(GEOMETRIES), ids=lambda g: f"{g[0]}-{g[1]}")
def test_three_iteration_embed_matches_jax_outcome(net, jax_params, geometry):
    path, frames = GEOMETRIES[geometry]
    clips, _, wm = _pair(frames, geometry[1])
    flags = _geometry(*geometry, num_iterations=3)
    ref = jax_embed_batch(jax_params, jnp.asarray(clips[:1]), jnp.asarray(wm[:1]),
                          _jax_cfg(flags))
    before = [k.launches for k in rt.KERNELS + ola_norm.KERNELS]
    ours = solver.embed_batch(net, torch.from_numpy(clips[:1]), torch.from_numpy(wm[:1]),
                              AwareConfig(**flags))
    assert [k.launches for k in rt.KERNELS + ola_norm.KERNELS] == before  # CPU: plain versions
    assert ours.audio.shape == np.asarray(ref.audio).shape == (1, (frames - 1) * geometry[1])
    assert torch.isfinite(ours.audio).all()
    np.testing.assert_array_less(
        np.abs(ours.best_loss.numpy() - np.asarray(ref.best_loss)), 2e-2)


@pytest.mark.parametrize("geometry", list(GEOMETRIES), ids=lambda g: f"{g[0]}-{g[1]}")
def test_load_takes_the_geometry_and_detection_follows_jax(jax_params, geometry):
    """``load()`` accepts each geometry; detection raises ValueError in
    both packages where the frame length is not the net's n_fft (1024),
    and reads both packages' values alike where it is."""
    n_fft, hop = geometry
    emb, det = aware_tpu_torch.load(device="cpu", **_geometry(n_fft, hop))
    assert (emb.cfg.frame_length, emb.cfg.hop_length) == geometry
    clip = _speechlike(SR, 5)

    def jax_detect():
        return np.asarray(jax_detect_values(jax_params, jnp.asarray(clip), hop_length=hop,
                                            win_length=n_fft))

    if n_fft != 1024:
        with pytest.raises(ValueError, match="broadcast"):
            det.detect(clip, SR)
        with pytest.raises(ValueError):
            jax_detect()
        return
    np.testing.assert_allclose(det.detect(clip, SR), jax_detect(), atol=2e-5)


def test_win_length_other_than_the_frame_raises():
    with pytest.raises(ValueError, match="win_length 512 != frame_length 1024"):
        aware_tpu_torch.load(device="cpu", win_length=512)
    # the JAX package's STFT raises there too
    from aware_tpu.ops.stft import stft as jax_stft
    from aware_tpu.ops.windows import get_window as jax_window

    with pytest.raises(ValueError):
        jax_stft(jnp.zeros(4096), 1024, 256, jax_window("hann", 512))


def test_ola_kernel_refuses_a_hop_that_does_not_divide_the_frame(jax_params):
    with pytest.raises(ValueError, match="n_fft % hop != 0"):
        aware_tpu_torch.load(device="cpu", **_geometry(1024, 200, use_pallas_ola=True))
    with pytest.raises(ValueError, match="hop to divide"):
        ola_norm.ola_normalize_fwd(torch.zeros(1, 4, 1024), torch.ones(3, 200))
    # the JAX package's ola kernel gives a NaN gradient there (its
    # r = n_fft // hop drops the remainder), and a NaN embed after two steps
    clips, _, wm = _pair(24, 200)
    jpb = jax_build_problem(jax_params, jnp.asarray(clips[0]), jnp.asarray(wm[0]),
                            _jax_cfg(_geometry(1024, 200, use_pallas_ola=True)))
    _, g = jax.value_and_grad(jpb.objective)(jpb.coeffs0)
    assert not np.isfinite(np.asarray(g)).all()


def test_c_entries_match_their_bindings():
    """Each C entry of csrc/*.cu and its ctypes binding agree in the count
    and kind of their parameters (a pointer, an int or a float): the ola
    entries took the slab count and the crop as new ints, and a binding
    that lags its entry passes garbage on the card, where no compiler
    checks the call."""
    import ctypes
    import pathlib
    import re

    from aware_tpu_torch.ops.kernels.build import SIGNATURES

    csrc = pathlib.Path(ola_norm.__file__).resolve().parents[2] / "csrc"
    kinds = {}
    for path in sorted(csrc.glob("*.cu")):
        for m in re.finditer(r"^int (aw_\w+)\(([^)]*)\)", path.read_text(), re.M):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            kinds[m.group(1)] = [ctypes.c_void_p if "*" in p else
                                 ctypes.c_float if p.startswith("float") else ctypes.c_int
                                 for p in params]
    assert set(kinds) == set(SIGNATURES)
    for name, argtypes in SIGNATURES.items():
        assert kinds[name] == list(argtypes), name
