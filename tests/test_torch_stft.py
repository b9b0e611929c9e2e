"""The port's STFT pieces against ``aware_tpu/ops/stft.py``.

Same numpy inputs through both frameworks on the CPU; values and
gradients agree to 1e-5 * max|ref| (float32 FFTs of two libraries, which
sum in different orders).  Host-side constants (windows, envelopes, DFT
bases, the mel basis) are computed by the same numpy code and must be
equal exactly.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu_torch.ops import mel as tmel
from aware_tpu_torch.ops import stft as ts
from aware_tpu_torch.ops import windows as tw

# the JAX package's ops/__init__ re-exports functions under these names
jmel = importlib.import_module("aware_tpu.ops.mel")
js = importlib.import_module("aware_tpu.ops.stft")
jw = importlib.import_module("aware_tpu.ops.windows")

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return np.max(np.abs(ours - ref)) / max(np.max(np.abs(ref)), 1e-30)


def _signal(length, batch=2, seed=0):
    return np.random.default_rng(seed + length).standard_normal((batch, length)).astype(np.float32)


@pytest.mark.parametrize("window", ["hann", "hamming"])
@pytest.mark.parametrize("n", [512, 1024])
def test_windows_equal(window, n):
    np.testing.assert_array_equal(tw.get_window(window, n), jw.get_window(window, n))


@pytest.mark.parametrize("n_fft", [512, 1024])
def test_dft_bases_equal(n_fft):
    for ours, ref in zip(ts.rfft_basis(n_fft) + ts.irfft_basis(n_fft),
                         js.rfft_basis(n_fft) + js.irfft_basis(n_fft)):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("frames", [8, 63, 126])
def test_ola_envelope_equal(frames):
    key = tuple(jw.get_window("hann", 1024).tolist())
    np.testing.assert_array_equal(ts._ola_envelope(key, 1024, 256, frames),
                                  js._ola_envelope(key, 1024, 256, frames))


@pytest.mark.parametrize("sr,n_mels", [(16000, 128), (16000, 64), (22050, 80)])
def test_mel_filter_bank_equal(sr, n_mels):
    np.testing.assert_array_equal(tmel.mel_filter_bank(sr, 1024, n_mels),
                                  jmel.mel_filter_bank(sr, 1024, n_mels))


@pytest.mark.parametrize("window", ["hann", "hamming"])
@pytest.mark.parametrize("n_fft,hop,length", [(1024, 256, 4000), (1024, 256, 8192 + 37),
                                              (512, 128, 3000), (1024, 384, 5000)])
def test_stft_matches_jax(n_fft, hop, length, window):
    x = _signal(length)
    ours = ts.stft(torch.from_numpy(x), n_fft, hop, window).numpy()
    for i in range(x.shape[0]):
        ref = np.asarray(js.stft(jnp.asarray(x[i]), n_fft, hop, window))
        assert ours[i].shape == ref.shape
        assert _rel_err(ours[i].real, ref.real) <= TOL
        assert _rel_err(ours[i].imag, ref.imag) <= TOL


@pytest.mark.parametrize("n_fft,hop,length", [(1024, 256, 4096), (512, 128, 3000)])
def test_istft_matches_jax(n_fft, hop, length):
    x = _signal(length)
    spec = np.array(js.stft(jnp.asarray(x[0]), n_fft, hop))
    ref = np.asarray(js.istft(jnp.asarray(spec), n_fft, hop))
    ours = ts.istft(torch.from_numpy(spec)[None], n_fft, hop)[0].numpy()
    assert ours.shape == ((spec.shape[-1] - 1) * hop,)
    assert _rel_err(ours, ref) <= TOL


def test_istft_synthesis_and_overlap_add_match_jax():
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, 20, 1024)).astype(np.float32)
    win = jw.get_window("hann", 1024)
    assert _rel_err(ts.overlap_add(torch.from_numpy(frames), 256).numpy(),
                    js.overlap_add(jnp.asarray(frames), 256)) <= TOL
    # the generic (hop does not divide n_fft) overlap-add
    assert _rel_err(ts.overlap_add(torch.from_numpy(frames), 384).numpy(),
                    js.overlap_add(jnp.asarray(frames), 384)) <= TOL
    assert _rel_err(ts.istft_synthesis(torch.from_numpy(frames), 1024, 256, win).numpy(),
                    js.istft_synthesis(jnp.asarray(frames), 1024, 256, win)) <= TOL


def test_stft_gradient_matches_jax():
    x = _signal(3000, batch=1)[0]
    probe = np.random.default_rng(5).standard_normal((513, 12)).astype(np.float32)

    def jloss(v):
        z = js.stft(v)
        return jnp.sum(js.safe_magnitude(z.real, z.imag) * probe)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    z = ts.stft(xt)
    (ts.safe_magnitude(z.real, z.imag) * torch.from_numpy(probe)).sum().backward()
    assert _rel_err(xt.grad.numpy(), ref) <= TOL


def test_istft_gradient_matches_jax():
    rng = np.random.default_rng(6)
    mag = np.abs(rng.standard_normal((513, 10))).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (513, 10)).astype(np.float32)
    probe = rng.standard_normal(9 * 256).astype(np.float32)
    ref = np.asarray(jax.grad(
        lambda m: jnp.sum(js.peak_normalize(js.istft(js.polar(m, jnp.asarray(ph)))) * probe)
    )(jnp.asarray(mag)))
    mt = torch.from_numpy(mag).requires_grad_(True)
    y = ts.peak_normalize(ts.istft(ts.polar(mt, torch.from_numpy(ph))))
    (y * torch.from_numpy(probe)).sum().backward()
    assert _rel_err(mt.grad.numpy(), ref) <= TOL


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-9, 0.0])
def test_peak_normalize_eps_matches_jax(scale):
    """x / (max|x| + 1e-8): the eps dominates tiny inputs, zeros stay 0."""
    x = _signal(1000) * np.float32(scale)
    ours = ts.peak_normalize(torch.from_numpy(x)).numpy()
    for i in range(x.shape[0]):
        ref = np.asarray(js.peak_normalize(jnp.asarray(x[i])))
        np.testing.assert_allclose(ours[i], ref, rtol=TOL, atol=0)


def _with_zero_bins(seed):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((6, 9)).astype(np.float32)
    im = rng.standard_normal((6, 9)).astype(np.float32)
    re[1, 2] = im[1, 2] = 0.0
    re[4, :] = im[4, :] = 0.0
    im[0, 0] = 0.0  # a zero part alone is no zero bin
    return re, im


@pytest.mark.parametrize("fn", ["safe_magnitude", "safe_angle"])
@pytest.mark.parametrize("seed", [0, 1])
def test_safe_ops_values_and_gradients_match_jax(fn, seed):
    re, im = _with_zero_bins(seed)
    probe = np.random.default_rng(seed + 9).standard_normal(re.shape).astype(np.float32)
    jf, tf = getattr(js, fn), getattr(ts, fn)
    ref_v = np.asarray(jf(jnp.asarray(re), jnp.asarray(im)))
    ref_g = jax.grad(lambda a, b: jnp.sum(jf(a, b) * probe), argnums=(0, 1))(
        jnp.asarray(re), jnp.asarray(im))
    rt_, it_ = (torch.from_numpy(v).requires_grad_(True) for v in (re, im))
    val = tf(rt_, it_)
    (val * torch.from_numpy(probe)).sum().backward()
    assert _rel_err(val.detach().numpy(), ref_v) <= TOL
    for ours, ref in zip((rt_.grad, it_.grad), ref_g):
        assert np.all(np.isfinite(ours.numpy()))
        assert _rel_err(ours.numpy(), ref) <= TOL
    # exactly-zero bins: value 0 and gradient exactly 0 (torch's sgn(0) = 0)
    assert val[1, 2] == 0 and rt_.grad[1, 2] == 0 and it_.grad[1, 2] == 0
    assert torch.all(rt_.grad[4] == 0) and torch.all(it_.grad[4] == 0)


def test_magphase_and_polar_match_jax():
    x = _signal(2048, batch=1)[0]
    spec = js.stft(jnp.asarray(x))
    mag_j, ph_j = js.magphase(spec)
    mag_t, ph_t = ts.magphase(torch.from_numpy(np.array(spec)))
    assert _rel_err(mag_t.numpy(), mag_j) <= TOL
    np.testing.assert_allclose(ph_t.numpy(), np.asarray(ph_j), atol=1e-5)
    z = ts.polar(mag_t, ph_t).numpy()
    zj = np.asarray(js.polar(mag_j, ph_j))
    assert _rel_err(z.real, zj.real) <= TOL and _rel_err(z.imag, zj.imag) <= TOL


def test_frame_counts_match_jax():
    for length in (1000, 16000, 160000):
        assert ts.num_frames(length, 256) == js.num_frames(length, 256)
        assert ts.istft_length(ts.num_frames(length, 256), 256) == js.istft_length(
            js.num_frames(length, 256), 256)
