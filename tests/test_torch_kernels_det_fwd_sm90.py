"""The detector_fused and analysis_detector forwards on the sm90 step's forward half.

``aw_detector_fwd`` is the forward half's detector part
(csrc/detector_sm90.cuh ``det_fwd_sm90``) from a given cs, on the step's
tiles of its five GEMMs; ``aw_reflect_analysis_fwd`` is its reflect
analysis (the reflect-pad pass, then the slab GEMM), which before
``aw_detector_fwd`` makes the analysis_detector forward.  Neither can run
here, so this file walks each in torch on the CPU (``reflect_fwd_walk``,
``det_fwd_walk``: each product's A materialized as the chain writes it,
each product on its planned tiles with the chain's two-level sums, the
mel norm from per-chunk partial sums), and holds them:

* their composition against the step's forward walk
  (tests/test_torch_kernels_step_sm90.py ``fwd_walk``): bit for bit, as
  the step calls the same two stages;
* the detector walk from cs against the forward of
  ``aware_tpu.ops.pallas.detector`` (Pallas interpret mode), and the
  reflect walk then the detector walk against the forward of
  ``aware_tpu.ops.pallas.analysis_detector``, on two speech-like clips of
  40 and of 9 frames, under the tolerances of
  tests/test_torch_kernels_detector.py (pred within 1e-3 absolute; the
  statistics before the conv stack within 1e-4 relative; the mel and nph
  residuals within one bf16 ulp);
* both walks against the port's plain forwards to agreement.FWD_TOL and
  SHARE_TOL, the bounds the chip check holds the kernels to (for the
  analysis_detector, frame 0's unit phases that are rounding noise on
  both sides left out of nph's share: ``_without_noise_phases`` says
  why).

The Python half is tested as it is: the forwards' GEMMs and tiles are the
step's (``gMel..gConv3`` and ``gAnalysis``), and the wrappers' checks
refuse T < 8, misaligned weights and a mel chunk plan whose partial sums
do not fit, before any launch (the analysis_detector forward's both
halves before its first).  Phase 3s's sign test at 8 and 9 frames
(agreement.short_outcome) is held to its definition.  The kernels
themselves run only on the card: chip_smoke.py and tests/test_torch_gpu.py.
"""

import math

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
from aware_tpu_torch.ops.kernels import roundtrip as rt
from aware_tpu_torch.ops.kernels.detector import DetResiduals
from test_torch_kernels_detector import _residuals_from_jax
from test_torch_kernels_iteration import _problem
from test_torch_kernels_step_sm90 import chunk_sum, dense_walk, fwd_walk, slab_walk

FRAMES = [40, 9]
HOP, P = 256, 256
CH = td.CH
IN_EPS, GS_EPS = 1e-5, 1e-8


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
def _jax_ad_fwd(y2, pads, csw, c):
    return jad._ad_fwd_impl(y2, pads, csw, c)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _fwd_plans(b, t):
    return {g.name: pl for g, pl in zip(it.step_gemms_fwd(b, t, P, HOP),
                                        it.plan_fwd(b, t, P, HOP, 132))}


# -------------------------------------------------------------- the walks ---

def reflect_fwd_walk(y, csw, plan):
    """The reflect analysis (reflect_analysis_fwd_sm90): the signal rows y
    (B, T-1, hop) -> the reflect-padded rows (B, T+3, hop), then the slab
    GEMM with csw (4 hop, 2P) -> cs (B, T, 2P)."""
    b, lr, hop = y.shape
    t = lr + 1
    flat = y.reshape(b, -1)
    n = flat.shape[1]
    f = torch.arange(-2 * hop, n + 2 * hop)
    f = torch.where(f < 0, -f, torch.where(f >= n, 2 * (n - 1) - f, f))
    ypad = flat[:, f].reshape(b, t + 3, hop)
    return slab_walk(ypad, csw.float(), t, csw.shape[1], hop, 0, +1, 0, plan)


def det_fwd_walk(cs, d, plans):
    """The detector forward (det_fwd_sm90): cs (B, T, 2P) -> (pred (B, 128),
    DetResiduals), each product's A materialized in bf16, the mel norm's
    sums from per-chunk partial sums in chunk order."""
    b, t, p2 = cs.shape
    p, t2 = p2 // 2, t // 2
    re, im = cs[..., :p], cs[..., p:]
    sq = re * re + im * im
    inv = torch.where(sq == 0, torch.zeros_like(sq), 1.0 / torch.sqrt(sq))
    nph = _bf16(torch.cat([re * inv, im * inv], dim=-1))
    mel = dense_walk(_bf16(sq * inv).reshape(b * t, p), d.melb.float(), plans["mel"])
    mel = mel.reshape(b, t, CH[0])
    rc, _ = td.mel_chunks(t)
    mu1 = chunk_sum(mel, 1, rc) / t
    r1 = 1.0 / torch.sqrt(chunk_sum((mel - mu1[:, None]) ** 2, 1, rc) / t + IN_EPS)
    a = (mel - mu1[:, None]) * r1[:, None]
    n_el = t * CH[0]
    gmu = chunk_sum(a.sum(dim=2), 1, rc) / n_el
    sd = torch.sqrt(chunk_sum(((a - gmu[:, None, None]) ** 2).sum(dim=2), 1, rc) / (n_el - 1))
    gr = 1.0 / (sd + GS_EPS)
    bs = (a - gmu[:, None, None]) * gr[:, None, None]
    x = _bf16(0.5 * bs[:, 0 : 2 * t2 : 2] + 0.5 * bs[:, 1 : 2 * t2 : 2])
    ys, rins = [], []
    for i in range(4):
        h = dense_walk(x.reshape(b * t2, CH[i]), getattr(d, f"w{i}t").float(),
                       plans[f"conv {i}"]).reshape(b, t2, CH[i + 1]) + d.biases[i, : CH[i + 1]]
        mu = h.mean(dim=1, keepdim=True)
        r = 1.0 / torch.sqrt(((h - mu) ** 2).mean(dim=1, keepdim=True) + IN_EPS)
        yhat = (h - mu) * r
        ys.append(yhat.to(torch.bfloat16))
        rins.append(r[:, 0])
        x = _bf16(torch.where(yhat >= 0, yhat, 0.2 * yhat))
    pool4 = torch.where(yhat >= 0, yhat, 0.2 * yhat).mean(dim=1)
    pred = torch.tanh(pool4 @ d.eo)
    return pred, DetResiduals(pred, nph.to(torch.bfloat16), mel.to(torch.bfloat16), *ys, mu1,
                              r1, *rins, gmu, gr, sd)


def _inputs(pb):
    """The path's detector input, cs2 = the reflect analysis of the plain
    forward's y2, and the analysis_detector's, y2."""
    _, res = it.iteration_forward_fwd_plain(pb.ct0, pb.iteration)
    return tad.reflect_analysis_fwd_plain(res.y2, pb.iteration.analysis), res.y2


def _hold_to_jax(det, i, outs, same_cs=True):
    """Clip i of the walk's forward against the JAX kernel's 16 outputs,
    under tests/test_torch_kernels_detector.py's tolerances; the bf16 mel
    and nph residuals only from the same cs (``same_cs``: the detector's
    forward; the analysis_detector's computes its own cs, whose near-zero
    bins take another unit phase after an ulp of difference, as
    tests/test_torch_kernels_analysis_detector.py holds it)."""
    ref = _residuals_from_jax(outs)
    np.testing.assert_allclose(det.pred[i].numpy(), ref.pred[0].numpy(), rtol=0, atol=1e-3)
    for name in ("mu1", "r1", "gr", "s"):
        np.testing.assert_allclose(getattr(det, name)[i].numpy(), getattr(ref, name)[0].numpy(),
                                   rtol=1e-4, err_msg=name)
    for name in ("mel", "nph") if same_cs else ():  # bf16: at most one ulp apart
        a, b = getattr(det, name)[i].float(), getattr(ref, name)[0].float()
        assert torch.all((a - b).abs() <= 2.0 ** -7 * b.abs() + 1e-30), name
    for name in DetResiduals._fields:
        assert getattr(det, name).shape[1:] == getattr(ref, name).shape[1:], name


NOISE_PHASE = 2.0**-14  # |unit phase component| of float32 rounding noise in cs


def _without_noise_phases(det, ref):
    """det and ref with nph zeroed where frame 0's unit phase is rounding
    noise on both sides.  The reflect pad mirrors the clip's start about its
    first sample, so frame 0 is even about its centre and, with the real
    analysis basis, the imaginary part of most of its bins is float32
    rounding noise (about 1e-7 against |cs| of 0.1 to 10): its unit phase
    carries no bits, and another summation order turns it by many ulps.
    Those components of frame 0's imaginary half (both sides under
    NOISE_PHASE) are left out of the share; every other nph element is
    held to SHARE_TOL."""
    noise = torch.zeros(det.nph.shape, dtype=torch.bool)
    noise[:, 0, P:] = ((det.nph[:, 0, P:].float().abs() < NOISE_PHASE)
                       & (ref.nph[:, 0, P:].float().abs() < NOISE_PHASE))
    zero = torch.zeros((), dtype=det.nph.dtype)
    return (det._replace(nph=torch.where(noise, zero, det.nph)),
            ref._replace(nph=torch.where(noise, zero, ref.nph)))


# ------------------------------------------------------------ the forward ---

@pytest.mark.parametrize("t", FRAMES)
def test_the_halves_compose_to_the_steps_forward_walk(problems, t):
    """The reflect walk on y2 = u / cden, then the detector walk, give the
    step's forward walk bit for bit: step_fwd calls the same two stages."""
    pb, _, _ = problems[t]
    c = pb.iteration
    plans = _fwd_plans(2, t)
    pred, res = fwd_walk(pb.ct0, c, plans)
    cs = reflect_fwd_walk(res.y2, c.csw, plans["reflect analysis"])
    pred2, det = det_fwd_walk(cs, c.det, plans)
    assert torch.equal(pred, pred2)
    for name, a, b in zip(DetResiduals._fields, res.det, det):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("t", FRAMES)
def test_det_fwd_walk_matches_jax_detector_forward(problems, t):
    pb, jcs, _ = problems[t]
    c = pb.iteration
    cs, _ = _inputs(pb)
    pred, det = det_fwd_walk(cs, c.det, _fwd_plans(2, t))
    assert pred.shape == (2, 128) and torch.all(torch.isfinite(pred))
    assert torch.all(pred[:, td.N_BITS :] == 0)
    for i in range(2):
        _hold_to_jax(det, i, _jax_det_fwd(jnp.asarray(cs[i].numpy()), jcs[i].det))
    # against the plain forward, to the bounds the chip check holds the kernel to
    _, res_p = td.detector_fused_fwd_plain(cs, c.det)
    ag.check_forward(det, res_p, t)


@pytest.mark.parametrize("t", FRAMES)
def test_reflect_then_det_fwd_walk_matches_jax_analysis_detector(problems, t):
    pb, jcs, _ = problems[t]
    c = pb.iteration
    _, y2 = _inputs(pb)
    plans = _fwd_plans(2, t)
    cs = reflect_fwd_walk(y2, c.csw, plans["reflect analysis"])
    assert cs.shape == (2, t, 2 * P)
    _, det = det_fwd_walk(cs, c.det, plans)
    for i in range(2):
        outs = _jax_ad_fwd(jnp.asarray(y2[i].numpy()), jcs[i].pads, jcs[i].csw, jcs[i].det)
        _hold_to_jax(det, i, outs, same_cs=False)
    _, res_p = tad.analysis_detector_fwd_plain(y2, c.analysis)
    ag.check_forward(*_without_noise_phases(det, res_p), t)


@pytest.mark.parametrize("t", FRAMES)
def test_reflect_fwd_walk_matches_the_plain_reflect_analysis(problems, t):
    """The reflect-pad pass reads the reflected samples by index, the plain
    version builds the pad rows with the JAX kernel's flip matrices: the
    same bf16 samples, so the two differ only by float32 sums in another
    order."""
    pb, _, _ = problems[t]
    _, y2 = _inputs(pb)
    cs = reflect_fwd_walk(y2, pb.iteration.csw, _fwd_plans(2, t)["reflect analysis"])
    ref = tad.reflect_analysis_fwd_plain(y2, pb.iteration.analysis)
    assert float((cs - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("b, t", [(8, 626), (2, 40), (2, 9)])
def test_forward_gemms_are_the_steps(b, t):
    """aw_detector_fwd's five tiles are the step's gMel..gConv3, and
    aw_reflect_analysis_fwd's tile the step's gAnalysis."""
    step = list(it.step_tiles(b, t, P, HOP, 132))
    assert list(td.det_fwd_tiles(b, t, P, 132)) == step[4:14]
    gm = tad.reflect_gemm_fwd(t, 2 * P, HOP)
    assert it.step_gemms_fwd(b, t, P, HOP)[1] == gm
    plan = rt.plan_slab_gemm(b, gm.rows, gm.n, 132)
    assert (plan.bm, plan.bn) == tuple(step[2:4])


# ------------------------------------------------------------ the checks ---

def _misaligned(x):
    """A contiguous copy of x 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def _counts():
    return [k.launches for k in it.KERNELS + td.KERNELS + tad.KERNELS]


@pytest.mark.parametrize("case", ["frames", "cs", "melb", "w2t", "biases", "room"])
def test_detector_fwd_checks_refuse_before_any_launch(problems, monkeypatch, case):
    pb, _, _ = problems[9]
    c = pb.iteration.det
    cs, _ = _inputs(pb)
    assert td.check_detector_fwd(cs, c) == (2, 9, P)  # what it takes
    if case == "frames":  # T = 7 < 8
        cs = cs[:, :7].contiguous()
    elif case == "cs":
        cs = cs.double()
    elif case == "biases":
        c = c._replace(biases=c.biases[:, :512].contiguous())
    elif case == "room":  # the mel stages' partial sums past the room
        monkeypatch.setattr(td, "PART_LD", 2 * CH[0])
    else:  # the dense GEMMs' weights, for their tensor maps
        c = c._replace(**{case: _misaligned(getattr(c, case))})
    before = _counts()
    with pytest.raises((ValueError, TypeError)):
        td.check_detector_fwd(cs, c)
    assert _counts() == before


@pytest.mark.parametrize("case", ["frames", "y2", "csw", "w1t", "room"])
def test_analysis_detector_fwd_checks_refuse_before_any_launch(problems, monkeypatch, case):
    """Both halves' checks run before the reflect analysis launches: a
    misaligned detector weight or a mel plan past its room is refused
    before any launch too."""
    pb, _, _ = problems[9]
    ac = pb.iteration.analysis
    _, y2 = _inputs(pb)
    assert tad.check_analysis_detector_fwd(y2, ac) == (2, 9, 2 * P, HOP)  # what it takes
    if case == "frames":  # T = 7 < 8
        y2 = y2[:, :6].contiguous()
    elif case == "y2":
        y2 = y2.double()
    elif case == "csw":  # the slab GEMM's weight, for its tensor map
        ac = ac._replace(csw=_misaligned(ac.csw))
    elif case == "w1t":  # a dense GEMM's weight
        ac = ac._replace(det=ac.det._replace(w1t=_misaligned(ac.det.w1t)))
    else:
        monkeypatch.setattr(td, "PART_LD", 2 * CH[0])
    before = _counts()
    with pytest.raises((ValueError, TypeError)):
        tad.check_analysis_detector_fwd(y2, ac)
    if case in ("frames", "y2", "csw"):  # the analysis half's own wrapper refuses them too
        with pytest.raises((ValueError, TypeError)):
            tad._reflect_analysis_fwd(y2, ac)
    assert _counts() == before


# ------------------------------------------------- phase 3s's sign test ---

def _binomial_tail(n, w):
    """P(Binomial(n, 1/2) >= w), summed term by term in float64."""
    return float(sum(np.exp(math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
                            - n * math.log(2.0)) for k in range(w, n + 1)))


def _lanes(w, l, ties=0):
    """Per-lane BERs with w lanes worse on the card, l better, ties equal."""
    card = [5.0] * w + [0.0] * l + [10.0] * ties
    ref = [0.0] * w + [5.0] * l + [10.0] * ties
    return card, ref


def test_short_outcome_passes_all_ties():
    card, ref = _lanes(0, 0, ties=64)
    assert ag.short_outcome(card, ref) == (0, 0, 1.0, True)


@pytest.mark.parametrize("w, l, ok", [(10, 0, False), (9, 0, True), (3, 5, True),
                                      (18, 2, False), (17, 3, True), (26, 6, False),
                                      (25, 7, True), (0, 12, True)])
def test_short_outcome_refuses_only_past_alpha(w, l, ok):
    """The rule's thresholds: 10 discordant lanes refuse only at W = 10, 20
    at W >= 18, 32 at W >= 26; ties never count."""
    card, ref = _lanes(w, l, ties=7)
    got = ag.short_outcome(card, ref)
    assert got[:2] == (w, l) and got[3] is ok


@pytest.mark.parametrize("n", [1, 7, 20, 32, 64])
def test_short_outcome_p_is_the_binomial_tail(n):
    for w in range(n + 1):
        card, ref = _lanes(w, n - w)
        _, _, p, ok = ag.short_outcome(card, ref)
        assert abs(p - _binomial_tail(n, w)) <= 1e-12 * max(p, 1e-300) + 1e-15
        assert ok is (p >= ag.SHORT_ALPHA)


def test_short_outcome_takes_lanes_pairwise():
    with pytest.raises(ValueError):
        ag.short_outcome([0.0, 5.0], [0.0])


@pytest.mark.parametrize("t", [8, 9])
def test_short_lanes_are_fixed_by_their_seeds(t):
    """The sign test's clips come from generators of their own: the same
    seed gives the same clips, bits and move, and the move is 1e-6 of the
    clips."""
    a, b = ag.short_lanes(3, t), ag.short_lanes(3, t)
    clips, bits, moved = a
    assert clips.shape == (2, (t - 1) * HOP) and bits.shape == (2, 20)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(clips, ag.short_lanes(4, t)[0])
    assert np.max(np.abs(moved - clips)) <= 1e-5 * np.max(np.abs(clips))
    assert np.max(np.abs(moved - clips)) > 0
