"""The iteration_forward forward and the detector VJPs on the sm90 chain's halves.

``aw_iteration_fwd_sm90`` is the whole step's forward half
(csrc/iteration_sm90.cu ``step_fwd``) on the step's first seven tiles,
which no path runs yet (ops/kernels/iteration.py says why);
``aw_detector_bwd`` is the backward half's detector part
(csrc/detector_sm90.cuh ``det_bwd_sm90``) from a given g;
``aw_reflect_analysis_bwd`` is its reflect analysis VJP (the slab GEMM
with the pad rows routed aside) and the fold, which after
``aw_detector_bwd`` makes the analysis_detector VJP.  None can run here,
so this file walks each in torch on the CPU with the walks of
tests/test_torch_kernels_step_sm90.py (``fwd_walk``, ``det_bwd_walk``,
``reflect_bwd_walk``: each product's A materialized as the chain writes
it, each product on its planned tiles with the chain's two-level sums, the
per-clip reductions from per-chunk partial sums), and holds them:

* the forward walk against the forward of
  ``aware_tpu.ops.pallas.iteration.iteration_forward`` (Pallas interpret
  mode) on two speech-like clips of 40 and of 9 frames, under the
  tolerances of tests/test_torch_kernels_iteration.py (pred within 1e-3
  absolute; y2 and m1 within 1e-5 of max|ref|), and against the port's
  plain forward to agreement.ITER_FWD_TOL and ITER_SHARE_TOL, the bounds
  the chip check holds the kernel to;
* the detector VJP walk from the JAX kernel's own residuals against the
  VJP of ``aware_tpu.ops.pallas.detector`` (1e-2 of max|ref| and cosine
  >= 0.99999, tests/test_torch_kernels_detector.py's bounds), and from the
  port's plain forward's residuals against the plain VJP to
  agreement.VJP_TOL, the chip check's bound;
* the same for the detector VJP walk followed by the reflect analysis VJP
  walk against ``aware_tpu.ops.pallas.analysis_detector``'s VJP;
* the chain of the sm90 halves: the forward walk's residuals carried
  through the backward walk (row 9's sm90 forward into row 10) against ``jax.vjp``
  of the JAX ``iteration_forward`` (relative L2 0.2 and 1 - cosine 0.02
  from 32 frames, agreement.SHORT_CHAIN_TOL below).

The Python half is tested as it is: the detector's GEMMs are the step's in
the chain's order with the step's own tiles, the chunk plan of the mel
stages covers every frame once in pool pairs, and the wrappers' checks
refuse T < 8, misaligned weights and a chunk plan whose partial sums do
not fit before any launch (the analysis_detector VJP's both halves before
its first).  The kernels themselves run only on the card:
chip_smoke.py and tests/test_torch_gpu.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.ops.pallas import analysis_detector as jad
from aware_tpu.ops.pallas import detector as jd
from aware_tpu_torch.ops.kernels import agreement as ag
from aware_tpu_torch.ops.kernels import analysis_detector as tad
from aware_tpu_torch.ops.kernels import detector as td
from aware_tpu_torch.ops.kernels import iteration as it
from test_torch_kernels_detector import _cos, _residuals_from_jax
from test_torch_kernels_iteration import _jax_fwd, _jax_vjp, _problem, _spread
from test_torch_kernels_step_sm90 import det_bwd_walk, fwd_walk, reflect_bwd_walk

FRAMES = [40, 9]
HOP, P = 256, 256


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
    return {t: _problem(t) for t in FRAMES}


_jax_det_fwd = jax.jit(jd._fwd_impl)


@jax.jit
def _jax_det_bwd(g, outs, c):
    return jd._bwd_impl(g, (*outs, c))


@jax.jit
def _jax_ad_fwd(y2, pads, csw, c):
    return jad._ad_fwd_impl(y2, pads, csw, c)


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_ad_bwd(g, outs, lr, cswt, pads, c):
    return jad._ad_bwd_impl(g, (*outs, lr, HOP, cswt, pads, c))


def _plans(gemms, plans):
    return {g.name: pl for g, pl in zip(gemms, plans)}


def _fwd_plans(b, t):
    return _plans(it.step_gemms_fwd(b, t, P, HOP), it.plan_fwd(b, t, P, HOP, 132))


def _bwd_plans(b, t):
    return _plans(it.step_gemms_bwd(b, t, P, HOP), it.plan_bwd(b, t, P, HOP, 132))


def _cotangent(t, batch=2):
    g = np.zeros((batch, 128), np.float32)
    g[:, :20] = np.random.default_rng(70 + t).standard_normal((batch, 20))
    return torch.from_numpy(g)


# ------------------------------------------------------------ the forward ---

@pytest.mark.parametrize("t", FRAMES)
def test_fwd_walk_on_the_forward_tiles_matches_jax(problems, t):
    pb, jcs, _ = problems[t]
    c = pb.iteration
    pred, res = fwd_walk(pb.ct0, c, _fwd_plans(2, t))
    assert pred.shape == (2, 128) and torch.all(torch.isfinite(pred))
    for i in range(2):
        outs = _jax_fwd(jnp.asarray(pb.ct0[i].numpy()), jcs[i])
        ref_pred, ref_y2, ref_m1 = (np.asarray(outs[k]) for k in (0, 16, 17))
        np.testing.assert_allclose(pred[i].numpy(), ref_pred[0], rtol=0, atol=1e-3)
        y2 = res.y2[i].numpy()
        assert np.max(np.abs(y2 - ref_y2)) <= 1e-5 * np.max(np.abs(ref_y2))
        assert abs(float(res.m1[i]) - float(ref_m1[0, 0])) <= 1e-5 * float(ref_m1[0, 0])
    # against the plain forward, to the bounds the chip check holds the kernel to
    _, res_p = it.iteration_forward_fwd_plain(pb.ct0, c)
    ag.check_forward(res.det, res_p.det, t, ag.ITER_FWD_TOL, ag.ITER_SHARE_TOL)
    assert float((res.y2 - res_p.y2).abs().max()) <= ag.Y2_TOL * float(res_p.y2.abs().max())


@pytest.mark.parametrize("t", FRAMES)
def test_fwd_walk_residuals_carry_the_bwd_walk(problems, t):
    """Row 9's sm90 forward into row 10's sm90 VJP (the step's two halves)
    against jax.vjp of the JAX iteration_forward."""
    from test_torch_kernels_step_sm90 import bwd_walk

    pb, jcs, _ = problems[t]
    c = pb.iteration
    g = _cotangent(t)
    _, res = fwd_walk(pb.ct0, c, _fwd_plans(2, t))
    dct = bwd_walk(g, res, c, _bwd_plans(2, t))
    assert dct.shape == (2, t, P) and torch.all(torch.isfinite(dct))
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
def test_forward_gemms_are_the_steps_first_seven(b, t):
    assert it.plan_fwd(b, t, P, HOP, 132) == it.plan_step(b, t, P, HOP, 132)[:7]
    assert list(it.fwd_tiles(b, t, P, HOP, 132)) == list(it.step_tiles(b, t, P, HOP, 132))[:14]
    assert it.step_gemms_fwd(b, t, P, HOP)[2:] == td.det_gemms_fwd(b, t, P)
    assert [g.name for g in td.det_gemms_fwd(b, t, P)] == ["mel", "conv 0", "conv 1", "conv 2",
                                                           "conv 3"]


# ------------------------------------------------------ the detector VJPs ---

def _detector_inputs(pb, t):
    """The detector's input on the path, cs2 = the reflect analysis of the
    plain forward's y2, and the analysis_detector's, y2."""
    _, res = it.iteration_forward_fwd_plain(pb.ct0, pb.iteration)
    return tad.reflect_analysis_fwd_plain(res.y2, pb.iteration.analysis), res.y2


@pytest.mark.parametrize("t", FRAMES)
def test_det_bwd_walk_matches_jax_detector_vjp(problems, t):
    pb, jcs, _ = problems[t]
    c = pb.iteration
    cs, _ = _detector_inputs(pb, t)
    g = _cotangent(t)
    one = _bwd_plans(1, t)
    for i in range(2):
        outs = _jax_det_fwd(jnp.asarray(cs[i].numpy()), jcs[i].det)
        ref = np.asarray(_jax_det_bwd(jnp.asarray(g[i : i + 1].numpy()), outs, jcs[i].det))
        ours = det_bwd_walk(g[i : i + 1], _residuals_from_jax(outs), c.det, one)[0].numpy()
        assert ours.shape == ref.shape == (t, 2 * P)
        assert np.max(np.abs(ours - ref)) <= 1e-2 * np.max(np.abs(ref))
        assert _cos(ours, ref) >= 0.99999
    # from the plain forward's residuals, as after row 5's forward
    _, res = td.detector_fused_fwd_plain(cs, c.det)
    ag.check_vjp(det_bwd_walk(g, res, c.det, _bwd_plans(2, t)),
                 td.detector_fused_bwd_plain(g, res, c.det))


@pytest.mark.parametrize("t", FRAMES)
def test_analysis_det_bwd_walk_matches_jax_vjp(problems, t):
    pb, jcs, _ = problems[t]
    c = pb.iteration
    _, y2 = _detector_inputs(pb, t)
    g = _cotangent(t)
    one = _bwd_plans(1, t)
    for i in range(2):
        outs = _jax_ad_fwd(jnp.asarray(y2[i].numpy()), jcs[i].pads, jcs[i].csw, jcs[i].det)
        ref = np.asarray(_jax_ad_bwd(jnp.asarray(g[i : i + 1].numpy()), outs, t - 1,
                                     jcs[i].cswt, jcs[i].pads, jcs[i].det))
        dcs = det_bwd_walk(g[i : i + 1], _residuals_from_jax(outs), c.det, one)
        ours = reflect_bwd_walk(dcs, c.cswt, one["reflect analysis VJP"])[0].numpy()
        assert ours.shape == ref.shape == (t - 1, HOP)
        assert np.max(np.abs(ours - ref)) <= 1e-2 * np.max(np.abs(ref))
        assert _cos(ours, ref) >= 0.99999
    # from the plain forward's residuals, as after row 7's forward
    plans = _bwd_plans(2, t)
    _, res = tad.analysis_detector_fwd_plain(y2, c.analysis)
    walk = reflect_bwd_walk(det_bwd_walk(g, res, c.det, plans), c.cswt,
                            plans["reflect analysis VJP"])
    ag.check_vjp(walk, tad.analysis_detector_bwd_plain(g, res, c.analysis))


@pytest.mark.parametrize("b, t", [(8, 626), (2, 40), (2, 9)])
def test_detector_vjp_gemms_are_the_steps_first_five(b, t):
    assert it.step_gemms_bwd(b, t, P, HOP)[:5] == td.det_gemms_bwd(b, t, P)
    assert list(td.det_bwd_tiles(b, t, P, 132)) == list(it.bwd_tiles(b, t, P, HOP, 132))[:10]
    assert [g.name for g in td.det_gemms_bwd(b, t, P)] == ["conv 3 VJP", "conv 2 VJP",
                                                           "conv 1 VJP", "conv 0 VJP", "mel VJP"]


def test_mel_chunks_cover_every_frame_once_in_pool_pairs():
    for t in range(td.MIN_FRAMES, 4097):
        rc, nch = td.mel_chunks(t)
        assert rc % 2 == 0 and 1 <= nch <= td.MEL_CHUNKS, (t, rc, nch)
        assert (nch - 1) * rc < t <= nch * rc, (t, rc, nch)  # no empty chunk
        td._check_mel_chunks(t)  # their partial sums fit PART_LD


def test_mel_chunks_refuse_partial_sums_past_their_room(monkeypatch):
    _, nch = td.mel_chunks(626)
    need = 2 * nch * (td.CH[0] + 1)
    monkeypatch.setattr(td, "PART_LD", need)
    td._check_mel_chunks(626)  # exactly the room: it fits
    monkeypatch.setattr(td, "PART_LD", need - 1)
    with pytest.raises(ValueError, match="partial sums"):
        td._check_mel_chunks(626)


# ------------------------------------------------------------ the checks ---

def _misaligned(x):
    """A contiguous copy of x 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def _counts():
    return [k.launches for k in it.KERNELS + td.KERNELS + tad.KERNELS]


@pytest.mark.parametrize("case", ["frames", "g", "residual", "w2", "melbt", "w0", "room"])
def test_detector_bwd_checks_refuse_before_any_launch(problems, monkeypatch, case):
    pb, _, _ = problems[9]
    c = pb.iteration.det
    cs, _ = _detector_inputs(pb, 9)
    g = _cotangent(9)
    _, res = td.detector_fused_fwd_plain(cs, c)
    assert td.check_detector_bwd(g, res, c) == (2, 9, P)  # what it takes
    if case == "frames":  # T = 7 < 8, residuals of 7 frames
        _, res = td.detector_fused_fwd_plain(cs[:, :7].contiguous(), c)
    elif case == "g":  # the padded (B, 128) cotangent, not the 20 lanes
        g = g[:, :20].contiguous()
    elif case == "residual":
        res = res._replace(mel=res.mel.float())
    elif case == "room":  # the mel stages' partial sums past the room
        monkeypatch.setattr(td, "PART_LD", 2 * td.CH[0])
    else:  # the dense GEMMs' weights, for their tensor maps
        c = c._replace(**{case: _misaligned(getattr(c, case))})
    before = _counts()
    with pytest.raises((ValueError, TypeError)):
        td.check_detector_bwd(g, res, c)
    assert _counts() == before


@pytest.mark.parametrize("case", ["frames", "ct", "ab", "csw", "melb", "w1t"])
def test_fwd_checks_refuse_before_any_launch(problems, case):
    pb, _, _ = problems[9]
    c = pb.iteration
    ct = pb.ct0
    assert it.check_iteration_fwd(ct, c) == (2, 9, P, HOP)  # what it takes
    if case == "frames":  # T = 7 < 8 (the constants cut to match)
        ct = ct[:, :7].contiguous()
        c = c._replace(csin=c.csin[:, :7].contiguous(), y_const=c.y_const[:, :6].contiguous(),
                       env=c.env[:6].contiguous())
    elif case == "ct":
        ct = ct.double()
    elif case in ("ab", "csw"):  # the slab GEMMs' weights, for their tensor maps
        c = c._replace(**{case: _misaligned(getattr(c, case))})
    else:  # the dense GEMMs' weights
        c = c._replace(det=c.det._replace(**{case: _misaligned(getattr(c.det, case))}))
    before = _counts()
    with pytest.raises((ValueError, TypeError)):
        it.check_iteration_fwd(ct, c)
    assert _counts() == before


@pytest.mark.parametrize("case", ["frames", "cswt", "w2"])
def test_analysis_detector_bwd_checks_refuse_before_any_launch(problems, case):
    """Both halves' checks run before the detector half launches: a
    misaligned analysis weight is refused before any launch too."""
    pb, _, _ = problems[9]
    ac = pb.iteration.analysis
    _, y2 = _detector_inputs(pb, 9)
    g = _cotangent(9)
    _, res = tad.analysis_detector_fwd_plain(y2, ac)
    assert tad.check_analysis_detector_bwd(g, res, ac) == (2, 9, 2 * P, HOP)  # what it takes
    if case == "frames":  # T = 7 < 8
        _, res = tad.analysis_detector_fwd_plain(y2[:, :6].contiguous(), ac)
    elif case == "cswt":  # the slab GEMM's weight, for its tensor map
        ac = ac._replace(cswt=_misaligned(ac.cswt))
    else:  # a dense GEMM's weight
        ac = ac._replace(det=ac.det._replace(w2=_misaligned(ac.det.w2)))
    before = _counts()
    with pytest.raises(ValueError):
        tad.check_analysis_detector_bwd(g, res, ac)
    if case != "w2":  # the analysis half's own wrapper refuses them too
        dcs = torch.zeros(2, res.nph.shape[1], 2 * P)
        with pytest.raises(ValueError):
            tad._reflect_analysis_bwd(dcs, ac)
    assert _counts() == before
