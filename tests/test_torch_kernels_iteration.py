"""The port's whole-iteration kernels against ``aware_tpu.ops.pallas.iteration``.

The plain PyTorch versions of the three CUDA kernels (``iteration_forward``
forward and VJP, ``iteration_step``) are held against the JAX package's
Pallas kernels, run in interpret mode on the CPU as its own tests run
them, on the constants of two speech-like clips (noise from a seeded numpy
generator) built by the port's ``build_problem``; the JAX kernels get the
same arrays.  T = 126 (a 2 s clip) and T = 9 (the fewest frames but one).

Tolerances, from the readings that ``PYTHONPATH=. python
tests/test_torch_kernels_iteration.py`` prints (PERF.md has them):
* forward: pred within 1e-3 absolute, the bound of
  tests/test_torch_kernels_detector.py for the fused detector: the two
  frameworks sum the slab products in other orders, so now and then a
  value rounds to the other bf16 neighbour before the detector and the
  norms carry the flip on; y2 and m1, before any bf16 rounding, within
  1e-5 of max|ref| (float32 sums in another order);
* VJP (the port's plain forward then backward against ``jax.vjp`` of the
  JAX kernel): relative L2 0.2 and 1 - cosine 0.02, the bounds of
  tests/test_torch_slice_detector.py for the same chain, which is the
  JAX objective's own spread under a 1e-6 move of the coefficients; below
  32 frames the chain's direction is not defined better than that spread
  (tests/test_torch_kernels_analysis_detector.py), so T = 9 is held to
  agreement.SHORT_CHAIN_TOL, twice that spread;
* the step in two parts, because NAdam's first step is about
  +-lr sign(g) and a flipped sign of a tiny gradient element would make
  any elementwise bound on ct meaningless: (a) the loss within 3e-4
  relative, the bound of the first-step test of
  tests/test_torch_slice_detector.py; (b) the port's NAdam / clamp / best
  epilogue given the JAX step kernel's own gradient and loss against the
  JAX step's new ct, m, v, best and best_loss within 2e-5 of each one's
  max, the tolerance of tests/test_iteration.py:154-217, at t = 1 and
  t = 2 with another lr per clip.  (``jax.grad`` of push_extremes after
  ``iteration_forward`` is not that gradient to the sign of every element:
  the test says why.)

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.config import in_band_bins
from aware_tpu.embed.losses import push_extremes as jax_push_extremes
from aware_tpu.models import init_params
from aware_tpu.ops.mel import mel_filter_bank
from aware_tpu.ops.pallas import analysis_detector as jad
from aware_tpu.ops.pallas import detector as jd
from aware_tpu.ops.pallas import iteration as jit_
from aware_tpu_torch.config import AwareConfig
from aware_tpu_torch.embed import solver
from aware_tpu_torch.embed.optim import nadam_schedule
from aware_tpu_torch.models.detector import DetectorNet, load_key_params, params_from_jax
from aware_tpu_torch.ops.kernels import agreement as ag
from aware_tpu_torch.ops.kernels import iteration as it
from test_torch_kernels_detector import _cos

CFG = JaxConfig()
NET = CFG.detection_net
HOP = CFG.hop_length
LO, HI = in_band_bins(NET.sample_rate, CFG.frame_length, CFG.embedding_bands)
FRAMES = [126, 9]
B1, B2, PSI, EPS = 0.9, 0.999, 4e-3, 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speechlike(frames: int, seed: int) -> np.ndarray:
    sr = NET.sample_rate
    t = np.arange((frames - 1) * HOP) / sr
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)) / sr)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _problem(frames: int):
    """The port's problem for two clips of ``frames`` frames, the JAX
    kernels' constants for each clip from the same arrays, and the two
    messages."""
    clips = np.stack([_speechlike(frames, 100 + frames), _speechlike(frames, 200 + frames)])
    bits = np.random.default_rng(frames).integers(0, 2, (2, 20))
    wm = (2.0 * bits - 1.0).astype(np.float32)
    net = DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)
    pb = solver.build_problem(net, torch.from_numpy(clips), torch.from_numpy(wm), AwareConfig())
    assert pb.path == "iteration_step" and pb.ct0.shape[1] == frames
    c = pb.iteration
    params = {k: jnp.asarray(v) for k, v in init_params(NET).items()}
    det = jd.fused_detector_consts(
        params, mel_filter_bank(NET.sample_rate, CFG.frame_length, NET.n_mels), LO, HI, frames)

    def bf16(x):
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)

    jcs = [
        jit_.IterConsts(csin=bf16(c.csin[i]), y_const=jnp.asarray(c.y_const[i].numpy()),
                        env=jnp.asarray(c.env.numpy()), ab=bf16(c.ab), abt=bf16(c.abt),
                        pads=jad.reflect_pad_matrices(HOP), csw=bf16(c.csw), cswt=bf16(c.cswt),
                        det=det)
        for i in range(2)
    ]
    return pb, jcs, wm


@pytest.fixture(scope="module")
def problems():
    return {t: _problem(t) for t in FRAMES}


_jax_fwd = jax.jit(jit_._iter_fwd_impl)


@jax.jit
def _jax_vjp(ct, c, g):
    return jax.vjp(lambda v: jit_.iteration_forward(v, c), ct)[1](g)[0]


@jax.jit
def _jax_loss_grad(ct, c, wm):
    return jax.value_and_grad(lambda v: jax_push_extremes(jit_.iteration_forward(v, c), wm))(ct)


@jax.jit
def _jax_step(ct, m, v, best, wm_pad, lower, upper, s1, s2, d2, bl, c):
    return jit_.iteration_step(ct, m, v, best, wm_pad, lower, upper, s1, s2, d2, bl, c,
                               b1=B1, b2=B2, eps=EPS, n_bits=20)


def _spread(ours, ref):
    """(relative L2 error, 1 - cosine)."""
    a, b = np.ravel(ours).astype(np.float64), np.ravel(ref).astype(np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b), 1 - _cos(a, b)


@pytest.mark.parametrize("t", FRAMES)
def test_forward_matches_jax(problems, t):
    pb, jcs, _ = problems[t]
    pred, res = it.iteration_forward_fwd_plain(pb.ct0, pb.iteration)
    assert pred.shape == (2, 128) and torch.all(pred[:, 20:] == 0)
    for i in range(2):
        outs = _jax_fwd(jnp.asarray(pb.ct0[i].numpy()), jcs[i])
        ref_pred, ref_y2, ref_m1 = (np.asarray(outs[k]) for k in (0, 16, 17))
        np.testing.assert_allclose(pred[i].numpy(), ref_pred[0], rtol=0, atol=1e-3)
        y2 = res.y2[i].numpy()
        assert np.max(np.abs(y2 - ref_y2)) <= 1e-5 * np.max(np.abs(ref_y2))
        assert abs(float(res.m1[i]) - float(ref_m1[0, 0])) <= 1e-5 * float(ref_m1[0, 0])


@pytest.mark.parametrize("t", FRAMES)
def test_vjp_matches_jax(problems, t):
    pb, jcs, _ = problems[t]
    g = np.zeros((2, 128), np.float32)
    g[:, :20] = np.random.default_rng(t).standard_normal((2, 20))
    _, res = it.iteration_forward_fwd_plain(pb.ct0, pb.iteration)
    dct = it.iteration_forward_bwd_plain(torch.from_numpy(g), res, pb.iteration).numpy()
    assert dct.shape == (2, t, 256) and np.all(np.isfinite(dct))
    assert np.all(dct[..., HI - LO :] == 0)  # the padding columns
    for i in range(2):
        ref = np.asarray(_jax_vjp(jnp.asarray(pb.ct0[i].numpy()), jcs[i], jnp.asarray(g[i, :20])))
        if t >= ag.SHORT_FRAMES:
            dl, dcos = _spread(dct[i], ref)
            assert dl <= 0.2 and dcos <= 0.02, (dl, dcos)
        else:
            r = ag.vjp_report(torch.from_numpy(dct[i]), torch.from_numpy(ref.copy()))
            assert all(r[k] <= tol for k, tol in ag.SHORT_CHAIN_TOL.items()), r


def _scalars(step, mu_prod, lr):
    """NAdam's s1, s2 (per clip) and d2 of the step after ``step``, from the
    port's float32 recursion."""
    t, mu_t, mu_next, mu_prod = nadam_schedule(step, mu_prod, B1, PSI)
    s1 = lr * (1.0 - mu_t) / (1.0 - mu_prod)
    s2 = lr * mu_next / (1.0 - mu_prod * mu_next)
    return t, mu_prod, s1, s2, (1.0 - B2**t).reshape(1)


def test_step_loss_matches_jax(problems):
    pb, jcs, wm = problems[126]
    ct = pb.ct0.clone()
    m, v, best = torch.zeros_like(ct), torch.zeros_like(ct), ct.clone()
    bl = torch.full((2,), float("inf"))
    lr = torch.tensor([0.1, 0.05])
    _, _, s1, s2, d2 = _scalars(torch.zeros(()), torch.ones(()), lr)
    wm_pad = np.zeros((2, 128), np.float32)
    wm_pad[:, :20] = wm
    loss = it.iteration_step_plain(ct, m, v, best, bl, pb.lower, pb.upper,
                                   torch.from_numpy(wm_pad), s1, s2, d2, pb.iteration,
                                   it.nadam_coefs((B1, B2), EPS))
    for i in range(2):
        z = jnp.zeros_like(jnp.asarray(pb.ct0[i].numpy()))
        out = _jax_step(jnp.asarray(pb.ct0[i].numpy()), z, z, jnp.asarray(pb.ct0[i].numpy()),
                        jnp.asarray(wm_pad[i : i + 1]), jnp.asarray(pb.lower[i].numpy()),
                        jnp.asarray(pb.upper[i].numpy()), jnp.full((1, 1), float(s1[i])),
                        jnp.full((1, 1), float(s2[i])), jnp.full((1, 1), float(d2[0])),
                        jnp.full((1, 1), jnp.inf), jcs[i])
        ref = float(out[0][0, 0])
        assert abs(float(loss[i]) - ref) <= 3e-4 * abs(ref), (float(loss[i]), ref)
    # the plain step updated the state in place; its best is the new ct
    assert torch.equal(best, ct) and torch.equal(bl, loss)
    assert torch.all(ct >= pb.lower) and torch.all(ct <= pb.upper)


def test_step_epilogue_matches_jax(problems):
    """Steps t = 1 and 2 of the JAX kernel from its own state, and the
    port's epilogue from the same state given the JAX kernel's own loss and
    gradient.  The gradient is read back from the kernel's first moment,
    g = m_prev + (m_new - m_prev) / (1 - b1) in float64 (at t = 1 exact to
    an ulp): ``jax.grad`` through ``iteration_forward`` is the JAX
    package's own spread away from it (on clip 1 here: relative L2
    6.6e-4, 11 flipped signs, each moving ct by about 2 lr)."""
    pb, jcs, wm = problems[126]
    k = it.nadam_coefs((B1, B2), EPS)
    lr = torch.tensor([0.1, 0.05])
    wm_pad = np.zeros((2, 128), np.float32)
    wm_pad[:, :20] = wm
    ct = [jnp.asarray(pb.ct0[i].numpy()) for i in range(2)]
    m = [jnp.zeros_like(c) for c in ct]
    v = [jnp.zeros_like(c) for c in ct]
    best = list(ct)
    bl = [jnp.full((1, 1), jnp.inf) for _ in ct]
    step, mu_prod = torch.zeros(()), torch.ones(())
    for _ in range(2):
        step, mu_prod, s1, s2, d2 = _scalars(step, mu_prod, lr)
        for i in range(2):
            out = _jax_step(ct[i], m[i], v[i], best[i], jnp.asarray(wm_pad[i : i + 1]),
                            jnp.asarray(pb.lower[i].numpy()), jnp.asarray(pb.upper[i].numpy()),
                            jnp.full((1, 1), float(s1[i])), jnp.full((1, 1), float(s2[i])),
                            jnp.full((1, 1), float(d2[0])), bl[i], jcs[i])
            m_prev = np.asarray(m[i], np.float64)
            g = (m_prev + (np.asarray(out[2], np.float64) - m_prev) / k.c_m).astype(np.float32)
            state = [torch.from_numpy(np.array(x))[None] for x in (ct[i], m[i], v[i], best[i])]
            bl_t = torch.tensor([float(bl[i][0, 0])])
            it.step_epilogue_plain(
                torch.from_numpy(g)[None], *state, bl_t, pb.lower[i : i + 1],
                pb.upper[i : i + 1], torch.tensor([float(out[0][0, 0])]), s1[i : i + 1],
                s2[i : i + 1], d2, k)
            _, ct[i], m[i], v[i], best[i], bl[i] = out
            for name, ours, ref in zip(("ct", "m", "v", "best"), state, out[1:5]):
                ref = np.asarray(ref)
                np.testing.assert_allclose(ours[0].numpy(), ref, rtol=0,
                                           atol=2e-5 * (np.max(np.abs(ref)) + 1e-12),
                                           err_msg=f"{name} at t={int(step)} clip {i}")
            ref_bl = float(out[5][0, 0])
            assert abs(float(bl_t[0]) - ref_bl) <= 2e-5 * abs(ref_bl)


def test_wrappers_take_the_plain_version_on_cpu_without_counting(problems):
    pb, _, wm = problems[9]
    c = pb.iteration
    it.reset_launches()
    pred, res = it.iteration_forward_fwd(pb.ct0, c)
    pred_p, res_p = it.iteration_forward_fwd_plain(pb.ct0, c)
    assert torch.equal(pred, pred_p) and torch.equal(res.u, res_p.u)
    g = torch.zeros(2, 128)
    g[:, :20] = 1.0
    assert torch.equal(it.iteration_forward_bwd(g, res, c),
                       it.iteration_forward_bwd_plain(g, res_p, c))
    wm_pad = torch.zeros(2, 128)
    wm_pad[:, :20] = torch.from_numpy(wm)
    s = torch.full((2,), 0.01)
    states = []
    for step in (it.iteration_step, it.iteration_step_plain):
        ct = pb.ct0.clone()
        m, v, best, bl = torch.zeros_like(ct), torch.zeros_like(ct), ct.clone(), torch.full(
            (2,), float("inf"))
        loss = step(ct, m, v, best, bl, pb.lower, pb.upper, wm_pad, s, s, torch.ones(1), c,
                    it.nadam_coefs())
        states.append((loss, ct, m, v, best, bl))
    assert all(torch.equal(a, b) for a, b in zip(*states))
    assert [kk.launches for kk in it.KERNELS] == [0, 0, 0]


def test_function_gradient_equals_the_plain_vjp(problems):
    pb, _, _ = problems[9]
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 20)).astype(np.float32))
    x = pb.ct0.clone().requires_grad_(True)
    out = it.iteration_forward(x, pb.iteration)
    (grad,) = torch.autograd.grad((out * g).sum(), x)
    gpad = torch.zeros(2, 128)
    gpad[:, :20] = g
    _, res = it.iteration_forward_fwd_plain(pb.ct0, pb.iteration)
    assert out.shape == (2, 20)
    assert torch.equal(grad, it.iteration_forward_bwd_plain(gpad, res, pb.iteration))


@pytest.mark.parametrize("t", FRAMES)
def test_the_card_check_runs_on_the_plain_versions(problems, t):
    """agreement.check_iteration, which holds the kernels on the card, on
    CPU tensors, where every wrapper runs its plain version: every reading
    is 0 (a rehearsal of the card check's code)."""
    pb, _, wm = problems[t]
    wm_pad = torch.zeros(2, 128)
    wm_pad[:, :20] = torch.from_numpy(wm)
    g = torch.zeros(2, 128)
    g[:, :20] = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 20)))
    r = ag.check_iteration(pb.ct0, pb.iteration, wm_pad, g, it.nadam_coefs(), t)
    assert r["iteration_forward_fwd"] == r["iteration_forward_bwd"] == r["iteration_step"] == 0
    assert max(r["epilogue"].values()) == 0 and max(r["signal"].values()) == 0


def test_short_clips_are_refused(problems):
    pb, _, _ = problems[9]
    with pytest.raises(ValueError, match="T >= 8"):
        it._check_iter(pb.iteration, 2, 7, 256, torch.device("cpu"))


if __name__ == "__main__":
    # The readings behind the bounds: the port against JAX, and JAX against
    # itself with the coefficients moved by 1e-6 of themselves.
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    for t in FRAMES:
        pb, jcs, wm = _problem(t)
        pred, res = it.iteration_forward_fwd_plain(pb.ct0, pb.iteration)
        g = np.zeros((2, 128), np.float32)
        g[:, :20] = np.random.default_rng(t).standard_normal((2, 20))
        dct = it.iteration_forward_bwd_plain(torch.from_numpy(g), res, pb.iteration).numpy()
        noise = np.random.default_rng(0).standard_normal(pb.ct0.shape[1:]).astype(np.float32)
        for i in range(2):
            ct = pb.ct0[i].numpy()
            outs = _jax_fwd(jnp.asarray(ct), jcs[i])
            moved = _jax_fwd(jnp.asarray(ct * (1 + 1e-6 * noise)), jcs[i])
            ref = np.asarray(_jax_vjp(jnp.asarray(ct), jcs[i], jnp.asarray(g[i, :20])))
            ref_m = np.asarray(_jax_vjp(jnp.asarray(ct * (1 + 1e-6 * noise)), jcs[i],
                                        jnp.asarray(g[i, :20])))
            rp = np.asarray(outs[0])[0]
            if t == 126:  # the JAX step kernel's own gradient against jax.grad's
                wm_pad = np.zeros((1, 128), np.float32)
                wm_pad[0, :20] = wm[i]
                _, _, s1, s2, d2 = _scalars(torch.zeros(()), torch.ones(()), torch.tensor([0.1]))
                z = jnp.zeros_like(jnp.asarray(ct))
                out = _jax_step(jnp.asarray(ct), z, z, jnp.asarray(ct), jnp.asarray(wm_pad),
                                jnp.asarray(pb.lower[i].numpy()), jnp.asarray(pb.upper[i].numpy()),
                                jnp.full((1, 1), float(s1[0])), jnp.full((1, 1), float(s2[0])),
                                jnp.full((1, 1), float(d2[0])), jnp.full((1, 1), jnp.inf), jcs[i])
                g_step = np.asarray(out[2], np.float64) / (1.0 - B1)
                g_grad = np.asarray(_jax_loss_grad(jnp.asarray(ct), jcs[i], jnp.asarray(wm[i]))[1])
                print(f"T={t} clip {i}: JAX step kernel's gradient against jax.grad: (L2, 1-cos) "
                      f"{_spread(g_step, g_grad)}, flipped signs "
                      f"{int(np.sum(np.sign(g_step) != np.sign(g_grad)))}", flush=True)
            print(f"T={t} clip {i}: max|pred| {np.max(np.abs(rp)):.3e}; pred error: port "
                  f"{np.max(np.abs(pred[i].numpy() - rp)):.3e}, JAX moved "
                  f"{np.max(np.abs(np.asarray(moved[0])[0] - rp)):.3e}; y2 error / max "
                  f"{np.max(np.abs(res.y2[i].numpy() - outs[16])) / np.max(np.abs(outs[16])):.3e}"
                  f"; VJP (L2, 1-cos): port {_spread(dct[i], ref)}, JAX moved "
                  f"{_spread(ref_m, ref)}", flush=True)
