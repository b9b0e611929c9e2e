"""The port's IIR filters (``aware_tpu_torch/ops/iir.py``) against the JAX
package's (``aware_tpu/ops/iir.py``), on the CPU, where the scan kernels'
wrappers run their plain versions.

* The host design (float64 numpy, copied) equals the JAX package's to
  1e-12.
* ``lfilter``, ``sosfilt``, ``filtfilt`` and ``sosfiltfilt`` on seeded
  inputs of up to 4000 samples, batched and with ``zi``, within 1e-5 of
  max|y| of the JAX ``lax.scan``: the same float32 recurrences in the same
  order (XLA may contract a multiply and an add into an FMA where torch
  does not).
* ``fir_approx`` against the JAX one; the wrappers' checks; no launch on
  the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aware_tpu.ops.iir as jiir
from aware_tpu_torch.ops import iir
from aware_tpu_torch.ops.kernels import iir as ki

TOL = 1e-5  # relative to max|y|

DESIGNS = [
    (6, 0.5, "low"),          # the suite's low_pass at 16 kHz
    (4, 0.0625, "high"),      # its high_pass
    (4, (0.1, 0.125), "bandstop"),  # a bandstop_200Hz band
    (3, (0.2, 0.4), "bandpass"),
    (2, 0.3, "highpass"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("order, wn, btype", DESIGNS)
def test_design_equals_jax(order, wn, btype):
    for ours, ref in zip(iir.butter_zpk(order, wn, btype), jiir.butter_zpk(order, wn, btype)):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    for ours, ref in zip(iir.butter(order, wn, btype), jiir.butter(order, wn, btype)):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    sos = iir.butter_sos(order, wn, btype)
    np.testing.assert_allclose(sos, jiir.butter_sos(order, wn, btype), rtol=0, atol=1e-12)
    np.testing.assert_allclose(iir.sosfilt_zi(sos), jiir.sosfilt_zi(sos), rtol=0, atol=1e-12)
    b, a = iir.butter(order, wn, btype)
    np.testing.assert_allclose(iir.lfilter_zi(b, a), jiir.lfilter_zi(b, a), rtol=0, atol=1e-12)
    np.testing.assert_allclose(iir.iir_impulse_response(b, a, 300),
                               jiir.iir_impulse_response(b, a, 300), rtol=0, atol=1e-12)


def _close(ours: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    assert np.abs(ours.numpy() - ref).max() <= TOL * np.abs(ref).max()


def _x(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(4000,), (3, 1500), (2, 2, 700)])
def test_lfilter_matches_jax(shape):
    b, a = iir.butter(6, 0.5, "low")
    x = _x(1, shape)
    _close(iir.lfilter(b, a, torch.from_numpy(x)), jiir.lfilter(b, a, jnp.asarray(x)))


def test_lfilter_with_zi_matches_jax():
    b, a = iir.butter(4, 0.3, "low")
    x = _x(2, (3, 2000))
    zi = iir.lfilter_zi(b, a)
    # one state for all lanes, and a state per lane
    _close(iir.lfilter(b, a, torch.from_numpy(x), zi=zi),
           jiir.lfilter(b, a, jnp.asarray(x), zi=zi))
    zl = zi[None] * x[:, :1]
    _close(iir.lfilter(b, a, torch.from_numpy(x), zi=torch.from_numpy(zl.astype(np.float32))),
           jiir.lfilter(b, a, jnp.asarray(x), zi=jnp.asarray(zl)))


@pytest.mark.parametrize("order, wn, btype", DESIGNS[1:4])
def test_sosfilt_matches_jax(order, wn, btype):
    sos = iir.butter_sos(order, wn, btype)
    x = _x(3, (2, 4000))
    _close(iir.sosfilt(sos, torch.from_numpy(x)), jiir.sosfilt(sos, jnp.asarray(x)))
    zi = iir.sosfilt_zi(sos)
    _close(iir.sosfilt(sos, torch.from_numpy(x), zi=zi),
           jiir.sosfilt(sos, jnp.asarray(x), zi=zi))


def test_filtfilt_matches_jax():
    b, a = iir.butter(4, 0.2, "low")
    x = _x(4, (2, 3000))
    _close(iir.filtfilt(b, a, torch.from_numpy(x)), jiir.filtfilt(b, a, jnp.asarray(x)))
    with pytest.raises(ValueError, match="too short"):
        iir.filtfilt(b, a, torch.zeros(10))


@pytest.mark.parametrize("shape", [(4000,), (3, 2000)])
def test_sosfiltfilt_matches_jax(shape):
    sos = iir.butter_sos(4, (1000 / 8000, 1200 / 8000), "bandstop")
    x = _x(5, shape)
    _close(iir.sosfiltfilt(sos, torch.from_numpy(x)), jiir.sosfiltfilt(sos, jnp.asarray(x)))
    with pytest.raises(ValueError, match="too short"):
        iir.sosfiltfilt(sos, torch.zeros(20))


def test_fir_approx_matches_jax():
    b, a = iir.butter(6, 0.5, "low")
    x = _x(6, (2, 3000))
    _close(iir.fir_approx(b, a, torch.from_numpy(x), length=512),
           jiir.fir_approx(b, a, jnp.asarray(x), length=512))


def test_the_cpu_runs_the_plain_versions_and_launches_nothing():
    before = (ki.lfilter_scan.launches, ki.sosfilt_scan.launches)
    b, a = iir.butter(6, 0.5, "low")
    bn, an = iir._ba(b, a)
    x = torch.from_numpy(_x(7, (2, 500)))
    assert torch.equal(ki.lfilter_scan(x, bn, an), ki.lfilter_plain(x, bn, an))
    sos = iir.butter_sos(4, 0.0625, "high")
    assert torch.equal(ki.sosfilt_scan(x, sos), ki.sosfilt_plain(x, sos))
    assert (ki.lfilter_scan.launches, ki.sosfilt_scan.launches) == before


def test_wrapper_checks():
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError, match="state"):
        ki.check_lfilter(x, np.ones(18), None)
    with pytest.raises(ValueError, match="sections"):
        ki.check_sosfilt(x, np.ones((17, 6)), None)
    with pytest.raises(ValueError, match="sections"):
        ki.check_sosfilt(x, np.ones((2, 5)), None)
    with pytest.raises(TypeError, match="float32"):
        ki.check_lfilter(x.double(), np.ones(3), None)
    with pytest.raises(ValueError, match="shape"):
        ki.check_lfilter(x, np.ones(3), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="shape"):
        ki.check_sosfilt(x, np.ones((2, 6)), torch.zeros(2, 3, 2))
    assert ki.check_sosfilt(x, np.ones((2, 6)), torch.zeros(2, 2, 2)) == (2, 100, 2)
