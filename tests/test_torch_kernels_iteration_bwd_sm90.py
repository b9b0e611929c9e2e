"""The iteration_forward VJP on the sm90 chain's backward half against the JAX package.

``aw_iteration_bwd`` (csrc/iteration_sm90.cu) is the whole step's
backward half run from a given cotangent g (B, 128) and the forward's
residuals alone, then the phase fold.  It cannot run here, so this file
walks it in torch on the CPU with ``bwd_walk`` of
tests/test_torch_kernels_step_sm90.py (each product's A materialized as
the chain writes it, each product on its planned tiles with the chain's
two-level sums, the per-clip reductions from per-chunk partial sums) from
the residuals of the port's plain forward, as the chip check and the
weight-decay path (whose forward is row 9's WMMA chain) hand them over.
The walk is held:

* against the VJP of ``aware_tpu.ops.pallas.iteration.iteration_forward``
  (``jax.vjp``, Pallas interpret mode) on two speech-like clips of 40 and
  of 9 frames, under tests/test_torch_kernels_iteration.py's tolerances:
  relative L2 0.2 and 1 - cosine 0.02 from 32 frames, agreement.
  SHORT_CHAIN_TOL below (the JAX chain's own spread there);
* against the port's plain VJP from the same residuals to agreement.
  VJP_TOL, the bound the chip check holds the kernel to.

The Python half is tested as it is: the backward GEMMs are the step's
last seven in the chain's order with the step's own tiles, and the
wrapper's checks refuse T < 8, a fold too large for the partial sums and
misaligned weights before any launch.  The kernel itself runs only on the
card: chip_smoke.py and tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aware_tpu_torch.ops.kernels import agreement as ag
from aware_tpu_torch.ops.kernels import iteration as it
from test_torch_kernels_iteration import _jax_vjp, _problem, _spread
from test_torch_kernels_step_sm90 import bwd_walk, step_plans


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problems():
    return {t: _problem(t) for t in (40, 9)}


def _cotangent(t):
    g = np.zeros((2, 128), np.float32)
    g[:, :20] = np.random.default_rng(50 + t).standard_normal((2, 20))
    return torch.from_numpy(g)


@pytest.mark.parametrize("t", [40, 9])
def test_bwd_walk_from_the_plain_residuals_matches_jax(problems, t):
    pb, jcs, _ = problems[t]
    c = pb.iteration
    g = _cotangent(t)
    _, res = it.iteration_forward_fwd_plain(pb.ct0, c)
    dct = bwd_walk(g, res, c, step_plans(2, t, 256, c.env.shape[-1]))
    assert dct.shape == (2, t, 256) and torch.all(torch.isfinite(dct))
    ag.check_vjp(dct, it.iteration_forward_bwd_plain(g, res, c))
    for i in range(2):
        ref = np.asarray(_jax_vjp(jnp.asarray(pb.ct0[i].numpy()), jcs[i],
                                  jnp.asarray(g[i, :20].numpy())))
        if t >= ag.SHORT_FRAMES:
            dl, dcos = _spread(dct[i].numpy(), ref)
            assert dl <= 0.2 and dcos <= 0.02, (dl, dcos)
        else:
            r = ag.vjp_report(dct[i], torch.from_numpy(ref.copy()))
            assert all(r[k] <= tol for k, tol in ag.SHORT_CHAIN_TOL.items()), r


@pytest.mark.parametrize("b, t", [(8, 626), (2, 40), (2, 9)])
def test_step_gemms_split_into_the_chains_halves(b, t):
    fwd, bwd = it.step_gemms_fwd(b, t, 256, 256), it.step_gemms_bwd(b, t, 256, 256)
    assert fwd + bwd == it.step_gemms(b, t, 256, 256)
    assert [g.name for g in fwd] == ["synthesis", "reflect analysis", "mel", "conv 0", "conv 1",
                                     "conv 2", "conv 3"]
    assert [g.name for g in bwd] == ["conv 3 VJP", "conv 2 VJP", "conv 1 VJP", "conv 0 VJP",
                                     "mel VJP", "reflect analysis VJP", "synthesis VJP"]
    assert it.plan_bwd(b, t, 256, 256, 132) == it.plan_step(b, t, 256, 256, 132)[7:]
    assert list(it.bwd_tiles(b, t, 256, 256, 132)) == list(it.step_tiles(b, t, 256, 256, 132))[14:]


def _misaligned(x):
    """A contiguous copy of x 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("case", ["frames", "g", "residual", "cswt", "abt", "w2", "melbt"])
def test_bwd_checks_refuse_before_any_launch(problems, case):
    pb, _, _ = problems[9]
    c = pb.iteration
    g = _cotangent(9)
    _, res = it.iteration_forward_fwd_plain(pb.ct0, c)
    assert it.check_iteration_bwd(g, res, c) == (2, 9, 256, 256)  # what it takes
    if case == "frames":  # T = 7 < 8
        res = res._replace(det=res.det._replace(nph=res.det.nph[:, :7].contiguous()))
    elif case == "g":  # the padded (B, 128) cotangent, not the 20 lanes
        g = g[:, :20].contiguous()
    elif case == "residual":
        res = res._replace(u=res.u.double())
    elif case in ("cswt", "abt"):  # the slab GEMMs' weights, for their tensor maps
        c = c._replace(**{case: _misaligned(getattr(c, case))})
    else:  # the dense GEMMs' weights
        c = c._replace(det=c.det._replace(**{case: _misaligned(getattr(c.det, case))}))
    it.reset_launches()
    with pytest.raises((ValueError, TypeError)):
        it.check_iteration_bwd(g, res, c)
    assert [k.launches for k in it.KERNELS] == [0, 0, 0]


def test_bwd_refuses_a_fold_too_large_for_the_partial_sums():
    room = it.FOLD_CHUNK * (it.PART_LD // 3)
    it._check_fold(room // 256 + 1, 256)  # (T-1) hop == room: it fits
    with pytest.raises(ValueError, match="partial sums"):
        it._check_fold(room // 256 + 2, 256)
