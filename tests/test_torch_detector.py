"""The port's detector against ``aware_tpu/models/detector.py`` and the
torch oracle of the reference net (``tests/oracles/torch_ref.py``).

Weights: ``params_from_jax(load_key_params())`` equals the JAX package's
key exactly.  Values: 1e-4 relative (float32 matmuls and reductions in
different orders, TF32 off), with a 2e-5 absolute floor for values near 0,
as ``tests/test_detector.py`` holds the JAX net against the oracle.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.config import DetectorNetConfig as JaxNetConfig
from aware_tpu_torch.config import DetectorNetConfig, in_band_bins
from aware_tpu_torch.models import detector as td
from tests.oracles.torch_ref import OracleDetectorNet, oracle_detect_values

jd = importlib.import_module("aware_tpu.models.detector")

RTOL, ATOL = 1e-4, 2e-5
KEYS = [f"conv{i}_{p}" for i in range(4) for p in "wb"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    return jd.load_key_params()


@pytest.fixture(scope="module")
def net(jax_params):
    return td.DetectorNet(td.params_from_jax(jax_params), DetectorNetConfig())


def _mags(t, batch=2, seed=0):
    rng = np.random.default_rng(seed + t)
    return np.abs(rng.standard_normal((batch, 513, t))).astype(np.float32) * 3.0


@pytest.mark.parametrize("key", KEYS)
def test_params_from_jax_equal_the_key(jax_params, key):
    ours = td.params_from_jax(jax_params)[key]
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), jax_params[key])
    np.testing.assert_array_equal(td.load_key_params()[key], jax_params[key])


def test_config_defaults_equal_the_jax_package():
    ours, ref = DetectorNetConfig(), JaxNetConfig()
    for field in ("sample_rate", "n_fft", "n_mels", "num_blocks", "initial_pool_size",
                  "initial_pool_stride", "n_filters", "output_length", "channels"):
        assert getattr(ours, field) == getattr(ref, field)


@pytest.mark.parametrize("t", [16, 33, 64])
def test_forward_matches_jax(net, jax_params, t):
    mags = _mags(t)
    ours = net(torch.from_numpy(mags)).numpy()
    for i in range(len(mags)):
        ref = np.asarray(jax.jit(jd.detector_apply)(jax_params, jnp.asarray(mags[i])))
        np.testing.assert_allclose(ours[i], ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", [16, 64])
def test_banded_forward_matches_jax(net, jax_params, t):
    lo, hi = in_band_bins(16000, 1024, (500.0, 4000.0))
    band = _mags(t)[:, lo:hi]
    ours = net.forward_banded(torch.from_numpy(band), lo, hi).numpy()
    for i in range(len(band)):
        ref = np.asarray(jax.jit(jd.detector_apply_banded, static_argnums=(2, 3))(
            jax_params, jnp.asarray(band[i]), lo, hi))
        np.testing.assert_allclose(ours[i], ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fn", ["instance_norm", "global_standardize"])
def test_norms_match_jax(fn):
    x = np.random.default_rng(2).standard_normal((3, 40, 17)).astype(np.float32) * 5 + 1
    ours = getattr(td, fn)(torch.from_numpy(x)).numpy()
    for i in range(len(x)):
        ref = np.asarray(getattr(jd, fn)(jnp.asarray(x[i])))
        np.testing.assert_allclose(ours[i], ref, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("size,stride", [(2, 2), (3, 2)])
def test_avg_pool_matches_jax(size, stride):
    x = np.random.default_rng(4).standard_normal((2, 8, 21)).astype(np.float32)
    ours = td.avg_pool_1d(torch.from_numpy(x), size, stride).numpy()
    ref = np.asarray(jd.avg_pool_1d(jnp.asarray(x), size, stride))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def _clips(speechlike):
    noise = np.random.default_rng(8).standard_normal(speechlike.shape).astype(np.float32)
    return np.stack([speechlike, np.roll(speechlike, 777), 0.3 * noise])


def test_detect_values_batch_matches_jax(net, jax_params, speechlike):
    clips = _clips(speechlike)
    ours = td.detect_values_batch(net, torch.from_numpy(clips)).numpy()
    ref = np.asarray(jd.detect_values_batch_jit(jax_params, jnp.asarray(clips)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_detect_values_matches_jax(net, jax_params, speechlike):
    ours = td.detect_values(net, torch.from_numpy(speechlike)).numpy()
    ref = np.asarray(jd.detect_values_jit(jax_params, jnp.asarray(speechlike)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_detect_values_match_the_torch_oracle(net, speechlike):
    oracle = OracleDetectorNet().eval()
    for clip in _clips(speechlike):
        ours = td.detect_values(net, torch.from_numpy(clip)).numpy()
        # the oracle's own tolerance against the JAX net (test_detector.py)
        np.testing.assert_allclose(ours, oracle_detect_values(oracle, clip),
                                   rtol=1e-3, atol=5e-5)


def test_net_holds_no_trainable_parameters(net):
    assert list(net.parameters()) == []
    assert {k for k, _ in net.named_buffers()} == {"mel_basis", *KEYS}
