"""The ola_normalize kernel's plain versions (ops/kernels/ola_norm.py) against
the JAX package's Pallas kernels (aware_tpu/ops/pallas/ola_norm.py), which
run in interpret mode on the CPU, on the same numpy-seeded frames.

Tolerances are the JAX suite's own for this kernel (tests/test_pallas.py):
the forward to atol 1e-6 / rtol 1e-6 (the plain version adds the frame
slices in the TPU kernel's order and applies the same collapsed scale),
the VJP to atol 1e-5 / rtol 1e-4 (the sum q = sum g * y2 runs in another
order).  Also covered: a tie of opposite signs at the peak (each tie gets
K / ties of the peak-norm's gradient, with the mask taken on y2 itself), a
silent lane (m1 = 0: every element a tie, sign 0, a finite gradient),
clips independent of each other in the batch (each clip's m1 is its own),
the autograd op, and the CPU wrappers, which count no launch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.ops.pallas.ola_norm import _env_rows, _ola_fwd_impl, ola_normalize
from aware_tpu.ops.windows import get_window
from aware_tpu_torch.ops.kernels import ola_norm as on

N_FFT, HOP = 1024, 256
WKEY = tuple(get_window("hann", N_FFT).tolist())
FWD = {"atol": 1e-6, "rtol": 1e-6}
VJP = {"atol": 1e-5, "rtol": 1e-4}


def _frames(t, batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, t, N_FFT)).astype(np.float32)


def _env(t):
    return _env_rows(WKEY, N_FFT, HOP, t)


def _jax(wf, g):
    """JAX's y2 rows, m1 and VJP of the cotangent rows g."""
    b, t, _ = wf.shape
    _, (rows, m1) = _ola_fwd_impl(jnp.asarray(wf), N_FFT, HOP, WKEY)
    _, vjp = jax.vjp(lambda x: ola_normalize(x, N_FFT, HOP, WKEY), jnp.asarray(wf))
    (dwf,) = vjp(jnp.asarray(g.reshape(b, -1)))
    return np.asarray(rows), np.asarray(m1)[:, 0], np.asarray(dwf)


def _ours(wf, g):
    env = torch.from_numpy(_env(wf.shape[1]))
    y2, m1 = on.ola_normalize_fwd_plain(torch.from_numpy(wf), env)
    dwf = on.ola_normalize_bwd_plain(torch.from_numpy(g), y2, env, m1)
    return y2.numpy(), m1.numpy(), dwf.numpy()


def _cotangent(wf, seed=3):
    b, t, _ = wf.shape
    return np.random.default_rng(seed).standard_normal((b, t - 1, HOP)).astype(np.float32)


@pytest.mark.parametrize("t", [63, 8, 64])
def test_forward_and_vjp_match_jax(t):
    wf = _frames(t, seed=t)
    g = _cotangent(wf)
    (y2, m1, dwf), (jy2, jm1, jdwf) = _ours(wf, g), _jax(wf, g)
    np.testing.assert_allclose(y2, jy2, **FWD)
    np.testing.assert_allclose(m1, jm1, **FWD)
    np.testing.assert_allclose(dwf, jdwf, **VJP)
    assert y2.shape == (2, t - 1, HOP) and dwf.shape == wf.shape


def test_ties_of_opposite_sign_split_the_peak_gradient():
    """Frames whose envelope-divided signal peaks at +M and -M: the VJP
    gives each tie K / ties with its sign, as the JAX kernel does."""
    t = 63
    wf = 0.1 * _frames(t, seed=5)
    env = _env(t)
    # a spike in one slice of one frame lands on one output sample; the
    # envelope there is divided back in, so the two peaks are exactly +-M
    for (frame, k, col), sign in (((20, 1, 17), 1.0), ((40, 2, 17), -1.0)):
        row = frame + k - on.PAD
        wf[:, frame, k * HOP + col] = sign * 50.0 * env[row, col]
    # the other slices at those samples are zeroed, so the sums are exact
    for frame, k, col in ((20, 1, 17), (40, 2, 17)):
        for kk in range(on.R):
            if kk != k:
                wf[:, frame + k - kk, kk * HOP + col] = 0.0
    g = _cotangent(wf)
    (y2, m1, dwf), (jy2, jm1, jdwf) = _ours(wf, g), _jax(wf, g)
    np.testing.assert_allclose(y2, jy2, **FWD)
    np.testing.assert_allclose(dwf, jdwf, **VJP)
    np.testing.assert_allclose(m1, 50.0, rtol=1e-6)
    peak = np.abs(y2).max(axis=(1, 2), keepdims=True)
    assert np.all((np.abs(y2) == peak).sum(axis=(1, 2)) == 2)
    # at each tie the VJP takes K * sign / 2 off g / c (then / env)
    c = (m1 + 1e-8) * (m1 / (m1 + 1e-8) + 1e-8)
    q = (g.astype(np.float64) * y2).sum(axis=(1, 2))
    k_coef = (m1 / (m1 + 1e-8) + 1e-8) * q * (1e-8 + c) / (c * c)
    for (frame, k, col), sign in (((20, 1, 17), 1.0), ((40, 2, 17), -1.0)):
        row = frame + k - on.PAD
        g_env = dwf[:, frame, k * HOP + col] * env[row, col]
        np.testing.assert_allclose(g[:, row, col] / c - g_env, sign * k_coef / 2, rtol=1e-4)
    assert np.all(np.isfinite(dwf))


def test_silent_lane_has_a_finite_gradient():
    wf = _frames(63)
    wf[1] = 0.0
    g = _cotangent(wf)
    (y2, m1, dwf), (jy2, jm1, jdwf) = _ours(wf, g), _jax(wf, g)
    assert m1[1] == 0.0 and np.all(y2[1] == 0.0)
    assert np.all(np.isfinite(dwf)) and np.all(np.isfinite(jdwf))
    np.testing.assert_allclose(y2, jy2, **FWD)
    np.testing.assert_allclose(dwf, jdwf, **VJP)


def test_each_clip_is_its_own():
    """The batch is a plain leading dimension: each clip's m1, y2 and VJP
    are those of the clip alone, as JAX's vmap of the kernel gives."""
    wf = _frames(63, batch=3, seed=7)
    wf[2] *= 40.0  # a loud clip beside quiet ones
    g = _cotangent(wf)
    y2, m1, dwf = _ours(wf, g)
    for i in range(3):
        y2_i, m1_i, dwf_i = _ours(wf[i : i + 1], g[i : i + 1])
        np.testing.assert_array_equal(m1[i], m1_i[0])
        np.testing.assert_array_equal(y2[i], y2_i[0])
        np.testing.assert_array_equal(dwf[i], dwf_i[0])
    single = jax.vmap(lambda x: ola_normalize(x[None], N_FFT, HOP, WKEY)[0])(jnp.asarray(wf))
    np.testing.assert_allclose(y2.reshape(3, -1), np.asarray(single), **FWD)


def test_autograd_op_runs_the_plain_versions_on_the_cpu():
    wf = torch.from_numpy(_frames(31)).requires_grad_(True)
    env = torch.from_numpy(_env(31))
    g = torch.from_numpy(_cotangent(wf.detach().numpy()))
    before = [k.launches for k in on.KERNELS]
    y2 = on.ola_normalize(wf, env)
    (dwf,) = torch.autograd.grad((y2 * g).sum(), wf)
    assert [k.launches for k in on.KERNELS] == before
    ref_y2, ref_m1 = on.ola_normalize_fwd_plain(wf.detach(), env)
    torch.testing.assert_close(y2.detach(), ref_y2, rtol=0, atol=0)
    torch.testing.assert_close(dwf, on.ola_normalize_bwd_plain(g, ref_y2, env, ref_m1),
                               rtol=0, atol=0)
