"""The port's metrics (``aware_tpu_torch/metrics``) against the JAX
package's (``aware_tpu/metrics``), on the CPU.

* ``ber`` and ``snr`` (host numpy in both) exactly, stereo, truncation and
  the +inf of identical signals included.
* ``stoi`` and ``pesq`` (host numpy and scipy, copied) to 1e-9 at 16 kHz,
  where no resampling runs; at 44.1 kHz, where each resamples to 16 kHz
  with its own package's resampler (float32 sums in other orders, about
  1e-7 of the samples), within RESAMPLED (measured 5e-10 on STOI and 1e-8
  on PESQ for this pair).
* ``stoi_device`` and ``pesq_proxy`` (torch here, jnp there) within 1e-4.
"""

import numpy as np
import pytest
import torch

import aware_tpu.metrics as jm
import aware_tpu_torch.metrics as pm
from test_torch_slice_detector import _speechlike

SR = 16000
EXACT_HOST = 1e-9
RESAMPLED = 1e-6
DEVICE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    clean = _speechlike(21)
    noisy = clean + 0.05 * np.random.default_rng(3).standard_normal(len(clean))
    return noisy.astype(np.float32), clean


def _at_44k(x: np.ndarray) -> np.ndarray:
    from scipy.signal import resample_poly

    return resample_poly(x.astype(np.float64), 441, 160).astype(np.float32)


def test_ber_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        a, b = rng.integers(0, 2, 20), rng.integers(0, 2, 20)
        assert pm.ber(a, b) == jm.ber(a, b)
    assert pm.ber(np.ones(20), np.ones(20)) == 0.0
    assert pm.ber(np.ones(4), np.zeros(4)) == 100.0


def test_snr_matches_jax(pair):
    noisy, clean = pair
    assert pm.snr(noisy, clean) == jm.snr(noisy, clean)
    assert pm.snr(noisy[:-100], clean) == jm.snr(noisy[:-100], clean)
    stereo = np.stack([noisy, clean], axis=1)
    assert pm.snr(stereo, clean) == jm.snr(stereo, clean)
    assert pm.snr(clean, clean) == float("inf") == jm.snr(clean, clean)
    assert pm.SNR()(noisy, clean) == pm.snr(noisy, clean)
    assert pm.BER()(np.ones(3), np.zeros(3)) == 100.0


def test_stoi_and_pesq_match_jax_at_16k(pair):
    noisy, clean = pair
    for ours, ref in ((pm.stoi, jm.stoi), (pm.pesq, jm.pesq)):
        a, b = ours(noisy, clean, SR), ref(noisy, clean, SR)
        assert abs(a - b) <= EXACT_HOST
    assert abs(pm.STOI()(noisy, clean, SR) - pm.stoi(noisy, clean, SR)) == 0.0
    assert abs(pm.PESQ()(noisy, clean, SR) - pm.pesq(noisy, clean, SR)) == 0.0
    np.testing.assert_allclose(pm.stoi_exact(clean, noisy, SR), jm.stoi_exact(clean, noisy, SR),
                               rtol=0, atol=EXACT_HOST)
    np.testing.assert_allclose(pm.pesq_wb(clean, noisy, SR), jm.pesq_wb(clean, noisy, SR),
                               rtol=0, atol=EXACT_HOST)


def test_stoi_and_pesq_match_jax_at_44k(pair):
    noisy, clean = (_at_44k(x) for x in pair)
    for ours, ref in ((pm.stoi, jm.stoi), (pm.pesq, jm.pesq)):
        assert abs(ours(noisy, clean, 44100, device="cpu") - ref(noisy, clean, 44100)) <= RESAMPLED


@pytest.mark.parametrize("sr", [SR, 44100])
def test_device_metrics_match_jax(pair, sr):
    noisy, clean = pair if sr == SR else tuple(_at_44k(x) for x in pair)
    for ours, ref in ((pm.stoi_device, jm.stoi_device), (pm.pesq_proxy, jm.pesq_proxy)):
        assert abs(ours(noisy, clean, sr, device="cpu") - ref(noisy, clean, sr)) <= DEVICE


def test_metrics_take_stereo_and_identity(pair):
    _, clean = pair
    stereo = np.stack([clean, clean], axis=1)
    assert abs(pm.stoi_device(stereo, clean, SR, device="cpu")
               - jm.stoi_device(stereo, clean, SR)) <= DEVICE
    assert pm.pesq_proxy(clean, clean, SR, device="cpu") > 4.4
    assert pm.stoi(clean, clean, SR) > 0.999


def test_device_metrics_on_cuda_without_a_card_raise(pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.pesq_proxy(*pair, SR)
