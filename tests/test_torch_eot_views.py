"""The EOT views alone (aware_tpu_torch/attacks/) against the JAX package's
(aware_tpu/attacks/): the vocoder's time_stretch at every stretch rate of
the robust card and pitch_shift at its +/-5 cents, mp3_approx at
qualities 10 and 11 (the compression card's) and 2 (a lame quality),
celp_approx in both modes.  The port runs a batch of two clips, the JAX
functions one clip at a time; the port's batch equals its clips run one
at a time.

Values are held to rtol 1e-4 and the VJP under a seeded random cotangent
to 1e-3 in relative L2 norm, in float64 (the JAX package under
``jax.enable_x64``): in float32 neither package is that close to its own
float64 value.  The vocoder accumulates the synthesis phase over the
frames up to 1e5 rad, where a float32 ulp is 0.008 rad: JAX's float32
stretch and pitch stand 1.7-2.7e-4 (values, relative L2) from its float64
ones, and the port's float32 views are held to be no farther from that
float64 value than JAX's.  The quantizers round with a straight-through
gradient, and the LPC envelope comes from a Levinson-Durbin recursion that
turns float32 noise in the autocorrelation (1.8e-7 between the two FFT
libraries) into 3e-4 in the predictor; the JAX package runs that part in
float32 whatever the input's dtype.  So ``_levinson`` is held in float64 and no less accurate than
JAX's in float32, the rounding on ties, and celp_approx with both
packages' recursion taken in float64 and their rounding the identity.
``PYTHONPATH=. python tests/test_torch_eot_views.py`` prints these
readings (in float64 the two packages' views agree to 5e-8, mp3 to 4e-15).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.attacks import celp as jax_celp
from aware_tpu.attacks import codec as jax_codec
from aware_tpu.attacks import vocoder as jax_vocoder
from aware_tpu_torch.attacks import celp, codec, vocoder

SR = 16000
RTOL = 1e-4      # values
VJP_TOL = 1e-3   # VJP, relative L2
RATES = (0.8, 0.85, 0.9, 0.95, 1.05, 1.1, 1.15, 1.2)  # the robust card's
CENTS = (-5.0, 5.0)
QUALITIES = (10, 11, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips() -> np.ndarray:
    """Two 2 s speech-like clips (float64), 125 hops long as the solver's y2."""
    t = np.arange(125 * 256) / SR
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)) / SR)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(5).standard_normal(len(t))
    x = x / np.max(np.abs(x))
    return np.stack([x, np.roll(x, 999) * 0.7])


def _views(kind, value):
    """(the port's function, the JAX package's) of one view."""
    if kind == "ts":
        return (lambda y: vocoder.time_stretch(y, value),
                lambda y: jax_vocoder.time_stretch(y, value))
    if kind == "ps":  # cents, as the solver's views take them
        return (lambda y: vocoder.pitch_shift(y, value / 100.0),
                lambda y: jax_vocoder.pitch_shift(y, value / 100.0))
    if kind == "mp3":
        return (lambda y: codec.mp3_approx(y, SR, value),
                lambda y: jax_codec.mp3_approx(y, SR, value))
    return (lambda y: celp.celp_approx(y, SR, value),
            lambda y: jax_celp.celp_approx(y, SR, value))


def _port(fn, x: np.ndarray, cot_seed: int = 0):
    """The port's batched values and VJP under a seeded random cotangent,
    and the cotangent."""
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    cot = np.random.default_rng(cot_seed).standard_normal(tuple(y.shape)).astype(x.dtype)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(cot))
    return y.detach().numpy(), g.numpy(), cot


def _jax(fn, x: np.ndarray, cot: np.ndarray):
    """The JAX function's values and VJP, one clip at a time, in x's dtype."""
    ys, gs = [], []
    fn = jax.jit(fn)
    with jax.enable_x64(x.dtype == np.float64):
        for xi, ci in zip(x, cot):
            y, vjp = jax.vjp(fn, jnp.asarray(xi))
            (g,) = vjp(jnp.asarray(ci))
            ys.append(np.asarray(y))
            gs.append(np.asarray(g))
    assert ys[0].dtype == x.dtype
    return np.stack(ys), np.stack(gs)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _hold(y, g, y_ref, g_ref) -> None:
    for i in range(len(y)):
        np.testing.assert_allclose(y[i], y_ref[i], rtol=RTOL, atol=RTOL * np.abs(y_ref[i]).max())
        assert _rel(g[i], g_ref[i]) <= VJP_TOL


VIEWS = ([("ts", r) for r in RATES] + [("ps", c) for c in CENTS]
         + [("mp3", q) for q in QUALITIES])


@pytest.mark.parametrize("kind, value", VIEWS)
def test_view_matches_jax_in_float64(kind, value):
    fn, jax_fn = _views(kind, value)
    x = _clips()
    y, g, cot = _port(fn, x)
    if kind != "ts":
        assert y.shape == x.shape
    y_ref, g_ref = _jax(jax_fn, x, cot)
    assert y.shape == y_ref.shape
    _hold(y, g, y_ref, g_ref)
    # the batch is its clips run one at a time
    for i in range(len(x)):
        y1, _, _ = _port(fn, x[i : i + 1])
        np.testing.assert_allclose(y1[0], y[i], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("kind, value", [("ts", 0.8), ("ts", 1.2), ("ps", -5.0), ("ps", 5.0)])
def test_vocoder_in_float32_is_no_less_accurate_than_jax(kind, value):
    """The solver's float32 views against the JAX package's float64 value:
    the port's values and VJP no farther from it than JAX's float32 ones
    (1.5 times, or 1e-6, whichever is larger)."""
    fn, jax_fn = _views(kind, value)
    x = _clips()
    y, g, cot = _port(fn, x.astype(np.float32))
    y64, g64 = _jax(jax_fn, x, cot.astype(np.float64))
    y32, g32 = _jax(jax_fn, x.astype(np.float32), cot)
    for ours, jaxs, ref in ((y, y32, y64), (g, g32, g64)):
        for i in range(len(x)):
            ours_err = _rel(ours[i].astype(np.float64), ref[i])
            assert ours_err <= max(1.5 * _rel(jaxs[i].astype(np.float64), ref[i]), 1e-6)


def _lags(dtype) -> np.ndarray:
    """The celp view's autocorrelation lags (2, order+1, T) of the clips."""
    from aware_tpu_torch.ops.stft import stft

    z = stft(torch.from_numpy(_clips()), 512, 256, "hann")
    power = (z.real**2 + z.imag**2).numpy()
    return np.fft.irfft(power, n=512, axis=-2)[..., :11, :].astype(dtype)


def test_levinson_matches_jax_in_float64():
    r = _lags(np.float64)
    rt = torch.from_numpy(r).requires_grad_(True)
    a, g2 = celp._levinson(rt)
    ca = np.random.default_rng(1).standard_normal(a.shape)
    cg = np.random.default_rng(2).standard_normal(g2.shape)
    (gr,) = torch.autograd.grad((a, g2), rt, (torch.from_numpy(ca), torch.from_numpy(cg)))
    with jax.enable_x64(True):
        for i in range(len(r)):
            (a_j, g2_j), vjp = jax.vjp(jax.jit(jax_celp._levinson), jnp.asarray(r[i]))
            (gr_j,) = vjp((jnp.asarray(ca[i]), jnp.asarray(cg[i])))
            np.testing.assert_allclose(a[i].detach().numpy(), np.asarray(a_j), rtol=RTOL,
                                       atol=RTOL)
            np.testing.assert_allclose(g2[i].detach().numpy(), np.asarray(g2_j), rtol=RTOL)
            assert _rel(gr[i].numpy(), np.asarray(gr_j)) <= VJP_TOL


def test_levinson_in_float32_is_no_less_accurate_than_jax():
    """In float32 the recursion is ill-conditioned in both packages; the
    port's predictor is held within twice JAX's distance from the float64
    recursion (max abs)."""
    r = _lags(np.float32)
    levinson = jax.jit(jax_celp._levinson)
    with jax.enable_x64(True):
        ref = np.stack([np.asarray(levinson(jnp.asarray(ri, jnp.float64))[0]) for ri in r])
    jax32 = np.stack([np.asarray(levinson(jnp.asarray(ri))[0]) for ri in r])
    ours = celp._levinson(torch.from_numpy(r))[0].numpy()
    assert np.abs(ours - ref).max() <= 2 * np.abs(jax32 - ref).max()


def test_straight_through_round_matches_jax():
    """Half to even on the ties, and the identity's gradient."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, 0.51, 3.2], np.float32)
    for port, ref in ((codec._ste_round, jax_codec._ste_round),
                      (celp._ste_round, jax_celp._ste_round)):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = port(xt)
        (g,) = torch.autograd.grad(y.sum(), xt)
        y_ref, vjp = jax.vjp(ref, jnp.asarray(x))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
        np.testing.assert_array_equal(g.numpy(), np.asarray(vjp(jnp.ones_like(y_ref))[0]))


@pytest.mark.parametrize("mode", ["nb8k", "mb16k"])
def test_celp_matches_jax_with_exact_recursion_and_no_rounding(mode, monkeypatch):
    """celp_approx of float32 clips, as the solver runs it, with both
    packages' Levinson recursion taken in float64 and their straight-through
    rounding the identity (each held on its own above)."""
    lev, jax_lev = celp._levinson, jax_celp._levinson
    monkeypatch.setattr(celp, "_levinson", lambda r: tuple(
        v.to(r.dtype) for v in lev(r.double())))
    monkeypatch.setattr(celp, "_ste_round", lambda x: x)
    monkeypatch.setattr(jax_celp, "_levinson", lambda r: tuple(
        v.astype(r.dtype) for v in jax_lev(r.astype(jnp.float64))))
    monkeypatch.setattr(jax_celp, "_ste_round", lambda x: x)
    fn, jax_fn = _views("celp", mode)
    x = _clips().astype(np.float32)
    y, g, cot = _port(fn, x)
    with jax.enable_x64(True):  # for the recursion; the clips stay float32
        y_ref, g_ref = [], []
        for xi, ci in zip(x, cot):
            yj, vjp = jax.vjp(jax.jit(jax_fn), jnp.asarray(xi))
            y_ref.append(np.asarray(yj))
            g_ref.append(np.asarray(vjp(jnp.asarray(ci))[0]))
    assert y_ref[0].dtype == np.float32
    _hold(y, g, np.stack(y_ref), np.stack(g_ref))
    for i in range(len(x)):
        y1, _, _ = _port(fn, x[i : i + 1])
        np.testing.assert_allclose(y1[0], y[i], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["nb8k", "mb16k"])
def test_celp_runs_whole_and_batched(mode):
    """The view as the solver runs it: the input's length and dtype, finite
    values and VJP, at most a few quantizer decisions away from JAX's
    (relative L2 of the values under 1e-2)."""
    fn, jax_fn = _views("celp", mode)
    x = _clips().astype(np.float32)
    y, g, cot = _port(fn, x)
    assert y.shape == x.shape and y.dtype == np.float32
    assert np.isfinite(y).all() and np.isfinite(g).all()
    y_ref, _ = _jax(jax_fn, x, cot)
    for i in range(len(x)):
        assert _rel(y[i], y_ref[i]) <= 1e-2


def _stretch_loss_grad(rate: float, x: np.ndarray) -> np.ndarray:
    """The JAX package's gradient, w.r.t. the waveform, of a stretch view's
    loss as its solver takes it (stretch, peak-norm, STFT, the banded
    detector, push_extremes), in x's dtype."""
    from aware_tpu.config import AwareConfig as JaxConfig
    from aware_tpu.embed.losses import get_loss_fn
    from aware_tpu.models import init_params
    from aware_tpu.models.detector import detector_apply_banded
    from aware_tpu.ops.stft import magphase, peak_normalize, stft
    from aware_tpu.ops.windows import get_window

    net = JaxConfig().detection_net
    params = {k: jnp.asarray(v) for k, v in init_params(net).items()}
    wm = np.where(np.arange(20) % 3, 1.0, -1.0).astype(x.dtype)
    loss_fn = get_loss_fn("push_extremes")

    def view_loss(y):
        m2, _ = magphase(stft(peak_normalize(jax_vocoder.time_stretch(y, rate)), 1024, 256,
                              get_window("hann", 1024)))
        pred = detector_apply_banded(params, m2[32:257], 32, 257, net, "highest")
        return loss_fn(pred, jnp.asarray(wm))

    with jax.enable_x64(x.dtype == np.float64):
        return np.asarray(jax.jit(jax.grad(view_loss))(jnp.asarray(x)))


def _readings() -> None:
    """The readings the bounds above rest on: each view against the JAX
    package's in float64; the float32 views' distance from the float64
    values, the JAX package's and the port's; the JAX package's float32
    gradient of a stretch view's loss against its float64 one; the
    Levinson recursion's inputs and outputs in float32."""
    x = _clips()
    for kind, value in VIEWS:
        fn, jax_fn = _views(kind, value)
        y, g, cot = _port(fn, x)
        y_ref, g_ref = _jax(jax_fn, x, cot)
        print(f"{kind} {value}, float64, port against JAX: values "
              f"{max(_rel(y[i], y_ref[i]) for i in range(2)):.1e}, VJP "
              f"{max(_rel(g[i], g_ref[i]) for i in range(2)):.1e} (relative L2)")
    for kind, value in [("ts", 0.8), ("ts", 1.2), ("ps", 5.0)]:
        fn, jax_fn = _views(kind, value)
        y64, _ = _jax(jax_fn, x, np.zeros((2, *_port(fn, x)[0].shape[1:])))
        y32, _ = _jax(jax_fn, x.astype(np.float32), np.zeros((2, *y64.shape[1:]), np.float32))
        ours = _port(fn, x.astype(np.float32))[0]
        print(f"{kind} {value}, float32 values against JAX's float64: JAX "
              f"{max(_rel(y32[i], y64[i]) for i in range(2)):.1e}, port "
              f"{max(_rel(ours[i], y64[i]) for i in range(2)):.1e}")
    for rate in (0.9, 1.1):
        g32 = _stretch_loss_grad(rate, x[0].astype(np.float32))
        g64 = _stretch_loss_grad(rate, x[0])
        print(f"stretch {rate} view loss, the JAX package's float32 gradient against its "
              f"float64 one: {_rel(g32, g64):.3f} relative L2")
    from aware_tpu_torch.ops.stft import stft

    z = stft(torch.from_numpy(x.astype(np.float32)), 512, 256, "hann")
    power = (z.real**2 + z.imag**2)
    r_torch = torch.fft.irfft(power, n=512, dim=-2)[..., :11, :].numpy()
    r_jax = np.asarray(jnp.fft.irfft(jnp.asarray(power.numpy()), n=512, axis=-2))[..., :11, :]
    print(f"autocorrelation lags, torch against JAX irfft in float32: "
          f"{np.abs(r_torch - r_jax).max() / np.abs(r_jax).max():.1e} (max, relative)")
    r = _lags(np.float32)
    levinson = jax.jit(jax_celp._levinson)
    with jax.enable_x64(True):
        ref = np.stack([np.asarray(levinson(jnp.asarray(ri, jnp.float64))[0]) for ri in r])
    jax32 = np.stack([np.asarray(levinson(jnp.asarray(ri))[0]) for ri in r])
    ours = celp._levinson(torch.from_numpy(r))[0].numpy()
    print(f"Levinson predictor in float32 against float64 (max abs): JAX "
          f"{np.abs(jax32 - ref).max():.1e}, port {np.abs(ours - ref).max():.1e}")


if __name__ == "__main__":
    _readings()
