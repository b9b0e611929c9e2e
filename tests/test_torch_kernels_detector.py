"""The port's fused detector against ``aware_tpu.ops.pallas.detector``.

The plain PyTorch versions of the two CUDA kernels (``detector_fused``
forward and VJP) are held against the JAX package's Pallas kernels, run in
interpret mode on the CPU as its own tests run them.  Inputs come from a
seeded numpy generator (the in-band Re/Im of ``tests/test_pallas_detector.py``:
0.1-scale, zero in the padding columns, a few exactly-zero bins) and reach
both frameworks as the same arrays.  T = 126 (a 2 s clip) and T = 63 (odd:
the pool drops the last frame).

Tolerances:
* constants: exact;
* forward: pred within 1e-3 absolute, about twice the JAX kernel's own
  spread.  The two frameworks sum their float32 reductions (the mel
  product, the norms' means and variances) in different orders, so the
  values that reach a bf16 rounding differ by an ulp or so; now and then
  one rounds the other way, and the norms carry each flip on.  Moving the
  JAX kernel's input by 1e-6 of itself moves its pred by up to 5.1e-4; the
  port against it measured up to 2.8e-4, with max|pred| 0.025 to 0.093
  (six seeds at each T: ``PYTHONPATH=. python
  tests/test_torch_kernels_detector.py`` prints these readings).
  The statistics before the conv stack are held to 1e-4 relative (a
  variance far below the 1e-5 eps of a near-constant mel channel loses
  digits to cancellation) and the bf16 residuals to one bf16 ulp;
* VJP, from the JAX kernel's own forward residuals: max error within
  1e-2 * max|ref| and cosine >= 0.99999 (measured: 0.4 % and 0.999999; the
  three norm backwards amplify a flipped bf16 rounding of dh);
* the autograd.Function's gradient against autograd through the plain
  forward: 2 % of the max element, the bound of
  ``tests/test_pallas_detector.py`` for its kernel against its replica
  (autograd rounds other cotangents to bf16 than the closed-form VJP), and
  cosine > 0.9999, tighter than its 0.999 (measured: 0.5-0.7 % and
  1 - cosine 1.8e-5).

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.config import in_band_bins
from aware_tpu.models import init_params
from aware_tpu.ops.mel import mel_filter_bank
from aware_tpu.ops.pallas import detector as jd
from aware_tpu_torch.config import DetectorNetConfig
from aware_tpu_torch.models.detector import load_key_params, params_from_jax
from aware_tpu_torch.ops.kernels import agreement as ag
from aware_tpu_torch.ops.kernels import detector as td

NET = JaxConfig().detection_net
LO, HI = in_band_bins(NET.sample_rate, NET.n_fft, JaxConfig().embedding_bands)
NB = HI - LO
FRAMES = [126, 63]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def basis():
    return mel_filter_bank(NET.sample_rate, NET.n_fft, NET.n_mels)


@pytest.fixture(scope="module")
def jax_params():
    return {k: jnp.asarray(v) for k, v in init_params(NET).items()}


@pytest.fixture(scope="module")
def consts(basis):
    return td.fused_detector_consts(params_from_jax(load_key_params()), basis, LO, HI)


@pytest.fixture(scope="module")
def jax_consts(jax_params, basis):
    return {t: jd.fused_detector_consts(jax_params, basis, LO, HI, t) for t in FRAMES}


def _cs(t, batch=2, seed=42):
    r = np.random.default_rng(seed + t)
    x = np.zeros((batch, t, 2 * td.P_BAND), np.float32)
    x[..., :NB] = r.standard_normal((batch, t, NB)) * 0.1
    x[..., td.P_BAND : td.P_BAND + NB] = r.standard_normal((batch, t, NB)) * 0.1
    x[:, 3:6, 7] = 0.0
    x[:, 3:6, td.P_BAND + 7] = 0.0
    return x


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


_jax_fwd = jax.jit(jd._fwd_impl)


@jax.jit
def _jax_bwd(g, outs, c):
    return jd._bwd_impl(g, (*outs, c))


def _residuals_from_jax(outs) -> td.DetResiduals:
    """The JAX kernel's 16 outputs for one clip as the port's batch-of-one
    residuals."""
    vals = []
    for name, o in zip(td.DetResiduals._fields, outs):
        o = np.asarray(o)
        if name in ("gmu", "gr", "s"):
            vals.append(torch.tensor([float(o.reshape(()))]))
        elif name in ("pred", "mu1", "r1") or name.startswith("rin"):
            vals.append(torch.from_numpy(o.astype(np.float32)))
        else:
            vals.append(torch.from_numpy(o.astype(np.float32)).to(torch.bfloat16)[None])
    return td.DetResiduals(*vals)


def test_consts_equal_jax(consts, jax_consts, basis):
    ref = jax_consts[126]
    for name in td.DetConsts._fields:
        ours, want = getattr(consts, name), getattr(ref, name)
        assert ours.dtype == {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[
            want.dtype.type], name
        np.testing.assert_array_equal(ours.float().numpy(), _f32(want), err_msg=name)


@pytest.mark.parametrize("t", FRAMES)
def test_strided_pool_equals_the_jax_pool_matrices(jax_consts, t):
    """The port builds no pool matrix: its strided pair mean is the JAX
    kernel's f32 products with pmt (forward) and pm (backward), exactly."""
    c = jax_consts[t]
    t2 = t // 2
    b = np.random.default_rng(t).standard_normal((t, 128)).astype(np.float32)
    want = _f32(c.pmt) @ b
    bt = torch.from_numpy(b)
    ours = 0.5 * bt[0 : 2 * t2 : 2] + 0.5 * bt[1 : 2 * t2 : 2]
    np.testing.assert_array_equal(ours.numpy(), want)
    dx = np.random.default_rng(t + 1).standard_normal((t2, 128)).astype(np.float32)
    db = np.zeros((t, 128), np.float32)
    db[0 : 2 * t2 : 2] = 0.5 * dx
    db[1 : 2 * t2 : 2] = 0.5 * dx
    np.testing.assert_array_equal(db, _f32(c.pm) @ dx)


@pytest.mark.parametrize("change, nb, t_frames, n_fft", [
    ({}, NB, 126, None),
    ({}, NB, 126, 1024),
    ({}, NB, 126, 2048),
    ({}, NB, 1024, None),
    ({}, NB, 1025, None),
    ({}, 256, 63, None),
    ({}, 257, 63, None),
    ({"n_filters": (500, 1024, 1024)}, NB, 126, None),
    ({"n_filters": (512, 1024, 512)}, NB, 126, None),
    ({"n_mels": 64}, NB, 126, None),
    ({"initial_pool_size": 3}, NB, 126, None),
    ({"initial_pool_stride": 1}, NB, 126, None),
    ({"num_blocks": 2, "n_filters": (512, 1024)}, NB, 126, None),
    ({"output_length": 16}, NB, 126, None),
    ({"n_fft": 2048}, NB, 126, 1024),
])
def test_supported_gate_matches_jax(change, nb, t_frames, n_fft):
    ours = td.fused_detector_supported(
        dataclasses.replace(DetectorNetConfig(), **change), nb, t_frames, n_fft)
    ref = jd.fused_detector_supported(dataclasses.replace(NET, **change), nb, t_frames, n_fft)
    assert ours == ref


@pytest.mark.parametrize("t", FRAMES)
def test_forward_matches_jax(consts, jax_consts, t):
    cs = _cs(t)
    pred, res = td.detector_fused_fwd_plain(torch.from_numpy(cs), consts)
    assert pred.shape == (2, 128) and torch.all(pred[:, td.N_BITS :] == 0)
    for i in range(cs.shape[0]):
        outs = _jax_fwd(jnp.asarray(cs[i]), jax_consts[t])
        ref = _residuals_from_jax(outs)
        np.testing.assert_allclose(pred[i].numpy(), ref.pred[0].numpy(), rtol=0, atol=1e-3)
        # the statistics before the first bf16 conv operand
        for name in ("mu1", "r1", "gr", "s"):
            np.testing.assert_allclose(getattr(res, name)[i].numpy(),
                                       getattr(ref, name)[0].numpy(), rtol=1e-4, err_msg=name)
        for name in ("mel", "nph"):  # bf16 residuals: at most one bf16 ulp apart
            a, b = getattr(res, name)[i].float(), getattr(ref, name)[0].float()
            assert torch.all((a - b).abs() <= 2.0 ** -7 * b.abs() + 1e-30), name
        for name in td.DetResiduals._fields:
            assert getattr(res, name).shape[1:] == getattr(ref, name).shape[1:], name


@pytest.mark.parametrize("t", FRAMES)
def test_vjp_matches_jax(consts, jax_consts, t):
    cs = _cs(t)
    g = np.random.default_rng(43 + t).standard_normal((2, 128)).astype(np.float32)
    g[:, td.N_BITS :] = 0.0
    for i in range(cs.shape[0]):
        outs = _jax_fwd(jnp.asarray(cs[i]), jax_consts[t])
        ref = np.asarray(_jax_bwd(jnp.asarray(g[i : i + 1]), outs, jax_consts[t]))
        ours = td.detector_fused_bwd_plain(torch.from_numpy(g[i : i + 1]),
                                           _residuals_from_jax(outs), consts)[0].numpy()
        assert np.max(np.abs(ours - ref)) <= 1e-2 * np.max(np.abs(ref))
        assert _cos(ours, ref) >= 0.99999
        # exactly-zero bins keep exactly-zero gradients (sgn(0) = 0)
        assert np.all(ours[3:6, 7] == 0) and np.all(ours[3:6, td.P_BAND + 7] == 0)


@pytest.mark.parametrize("t", FRAMES)
def test_function_gradient_matches_plain_autograd(consts, t):
    cs = torch.from_numpy(_cs(t))
    g = torch.from_numpy(np.random.default_rng(44 + t).standard_normal((2, 20)).astype(np.float32))
    x = cs.clone().requires_grad_(True)
    out = td.detector_fused(x, consts)
    (g_fn,) = torch.autograd.grad((out * g).sum(), x)
    x2 = cs.clone().requires_grad_(True)
    (g_ad,) = torch.autograd.grad((td.detector_fused_fwd_plain(x2, consts)[0][:, :20] * g).sum(), x2)
    assert out.shape == (2, 20)
    assert torch.isfinite(g_fn).all()
    assert float((g_fn - g_ad).abs().max()) <= 0.02 * float(g_ad.abs().max())
    assert _cos(g_fn.numpy(), g_ad.numpy()) > 0.9999


def test_padded_channels_stay_zero_and_finite(consts):
    """conv3's 40 outputs are padded to 128: those channels normalize a
    constant 0 (rsqrt(eps)), so their yhat is exactly 0 and finite."""
    _, res = td.detector_fused_fwd_plain(torch.from_numpy(_cs(126)), consts)
    for v in res:
        assert torch.isfinite(v.float()).all()
    assert torch.all(res.y3[..., 40:] == 0)
    assert torch.all(res.pred[:, td.N_BITS :] == 0)


def test_wrappers_take_the_plain_version_on_cpu_without_counting(consts):
    cs = torch.from_numpy(_cs(63))
    td.reset_launches()
    pred, res = td.detector_fused_fwd(cs, consts)
    pred_p, res_p = td.detector_fused_fwd_plain(cs, consts)
    assert all(torch.equal(a, b) for a, b in zip(res, res_p))
    g = torch.zeros(2, 128)
    g[:, :20] = 1.0
    assert torch.equal(td.detector_fused_bwd(g, res, consts),
                       td.detector_fused_bwd_plain(g, res, consts))
    assert [k.launches for k in td.KERNELS] == [0, 0]


def test_consts_reject_a_band_wider_than_the_padding(basis):
    with pytest.raises(ValueError, match="band width"):
        td.fused_detector_consts(params_from_jax(load_key_params()), basis, 0, 300)



@pytest.mark.parametrize("field, scale", [("y1", 1.01), ("mel", 1.01), ("rin2", 1.02),
                                          ("gr", 1.001)])
def test_agreement_bounds_catch_a_wrong_residual(consts, field, scale):
    """The bounds the chip check holds the CUDA forward to see a residual
    off by a fraction of a percent, which pred alone need not show."""
    _, res = td.detector_fused_fwd_plain(torch.from_numpy(_cs(126)), consts)
    ag.check_forward(res, res, 126)
    wrong = getattr(res, field)
    wrong = res._replace(**{field: (wrong.double() * scale).to(wrong.dtype)})
    with pytest.raises(AssertionError, match=field):
        ag.check_forward(wrong, res, 126)


def test_agreement_bounds_catch_a_scaled_vjp():
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 126, 512)))
    ag.check_vjp(g, g)
    ag.check_vjp(g, g, chain=True)
    for chain in (False, True):
        with pytest.raises(AssertionError):
            ag.check_vjp(1.01 * g, g, chain=chain)
    one_ulp = torch.tensor([1.0 + 2.0**-7, 3.0]).to(torch.bfloat16)
    assert ag.bf16_ulps(one_ulp, torch.tensor([1.0, 3.0])).tolist() == [1.0, 0.0]


if __name__ == "__main__":
    # The readings behind the forward bound: pred of the plain version
    # against the JAX kernel, and of the JAX kernel against itself with its
    # input moved by 1e-6 of itself, on seeds 0..5 of the inputs above.
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    mel = mel_filter_bank(NET.sample_rate, NET.n_fft, NET.n_mels)
    ours_c = td.fused_detector_consts(params_from_jax(load_key_params()), mel, LO, HI)
    params = {k: jnp.asarray(v) for k, v in init_params(NET).items()}
    for t in FRAMES:
        jax_c = jd.fused_detector_consts(params, mel, LO, HI, t)
        for seed in range(6):
            cs = _cs(t, batch=1, seed=1000 * seed)
            moved = cs * (1 + 1e-6 * np.random.default_rng(seed).standard_normal(cs.shape))
            ref = np.asarray(_jax_fwd(jnp.asarray(cs[0]), jax_c)[0])[0]
            own = np.asarray(_jax_fwd(jnp.asarray(moved[0].astype(np.float32)), jax_c)[0])[0]
            ours = td.detector_fused_fwd_plain(torch.from_numpy(cs), ours_c)[0][0].numpy()
            print(f"T {t} seed {seed}: max|pred| {np.abs(ref).max():.4f}, port vs JAX "
                  f"{np.abs(ours - ref).max():.3e}, JAX moved by 1e-6 vs JAX "
                  f"{np.abs(own - ref).max():.3e}", flush=True)
