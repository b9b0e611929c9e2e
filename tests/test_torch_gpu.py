"""The port's CUDA kernels on the card (``gpu`` marker; skipped without one).

This file imports no jax, so that the card's machine, which has none, can
run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors: the round-trip kernels to 1e-3 * max|plain| (float32 sums in
another order on the card); the detector kernels on pred and every
residual, their VJPs from the plain residuals, and the forward-then-VJP
chain from the kernel's own residuals, to the bounds of
aware_tpu_torch/ops/kernels/agreement.py (which says why they are what
they are); the whole-iteration kernels by agreement.check_iteration;
ola_normalize to the JAX suite's tolerances for it (forward atol/rtol
1e-6, VJP atol 1e-5 rtol 1e-4), with a silent lane and a tie probe, each
variant (the cluster forward the stream forward's bits, the cluster VJP
the same bits on two launches); the
sm90 slab GEMM (shift_mm at its three uses, the band_analysis forward and
VJP) on each tile it can take, to 1e-3 * max|plain|, bit for bit over two
launches, and its wrapper checks; the sm90 dense GEMM of the whole step on
each tile, to the same bound against the float32 product of its bf16
operands, and the whole step bit for bit over two launches from one state;
the redesigned synth_norm pair (the forward's u and m1 bit for bit
against the step's forward half's, the VJP on clips with tied maxima),
tiled synthesis, iteration_forward forward and VJP, and detector_fused
and analysis_detector forwards and VJPs beside their first WMMA versions
and their plain versions, and their wrappers' checks.
"""

import numpy as np
import pytest
import torch

from aware_tpu_torch.config import AwareConfig, DetectorNetConfig, in_band_bins
from aware_tpu_torch.embed import solver
from aware_tpu_torch.models.detector import DetectorNet, load_key_params, params_from_jax
from aware_tpu_torch.ops.kernels import agreement as ag
from aware_tpu_torch.ops.kernels import analysis_detector as tad
from aware_tpu_torch.ops.kernels import detector as td
from aware_tpu_torch.ops.kernels import iteration as it
from aware_tpu_torch.ops.kernels import ola_norm as on
from aware_tpu_torch.ops.kernels import roundtrip as rt
from aware_tpu_torch.ops.kernels import roundtrip_tiled as rtt
from aware_tpu_torch.ops.mel import mel_filter_bank
from aware_tpu_torch.ops.stft import _ola_envelope
from aware_tpu_torch.ops.windows import get_window

HOP, B = 256, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data(t, device, p=256):
    rng = np.random.default_rng(t)
    lr, nfft = t - 1, 4 * HOP

    def f32(*shape, scale=1.0, shift=0.0):
        x = scale * rng.standard_normal(shape) + shift
        return torch.as_tensor(x.astype(np.float32), device=device)

    d = {
        "ct": f32(B, t, p), "yconst": f32(B, lr, HOP, scale=0.1),
        "env": 1.0 + f32(lr, HOP).abs(), "g_y2": f32(B, lr, HOP), "g_cs": f32(B, t, 2 * p),
        "csin": f32(B, t, 2 * p).to(torch.bfloat16),
        "ab": f32(2 * p, nfft, scale=1 / 16).to(torch.bfloat16),
        "csw": f32(nfft, 2 * p, scale=1 / 16).to(torch.bfloat16),
    }
    d["abt"], d["cswt"] = d["ab"].t().contiguous(), d["csw"].t().contiguous()
    return d


def _close(ours, ref):
    err = float((ours - ref).abs().max())
    assert err <= 1e-3 * float(ref.abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 97, 626])
def test_cuda_kernels_match_plain(cuda, t):
    d = _data(t, cuda)
    before = [k.launches for k in rt.KERNELS]
    y2, m1 = rt.synth_norm_fwd(d["ct"], d["csin"], d["yconst"], d["env"], d["ab"])
    y2p, m1p = rt.synth_norm_fwd_plain(d["ct"], d["csin"], d["yconst"], d["env"], d["ab"])
    torch.cuda.synchronize()
    _close(y2, y2p)
    _close(m1, m1p)
    _close(rt.synth_norm_bwd(d["g_y2"], y2p, m1p, d["csin"], d["env"], d["abt"]),
           rt.synth_norm_bwd_plain(d["g_y2"], y2p, m1p, d["csin"], d["env"], d["abt"]))
    _close(rt.band_analysis_fwd(y2p, d["csw"]), rt.band_analysis_fwd_plain(y2p, d["csw"]))
    _close(rt.band_analysis_bwd(d["g_cs"], d["cswt"]),
           rt.band_analysis_bwd_plain(d["g_cs"], d["cswt"]))
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(rt.KERNELS, before)] == [1, 1, 1, 1]


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    d = _data(8, cuda)
    with pytest.raises(TypeError):
        rt.synth_norm_fwd(d["ct"], d["csin"].float(), d["yconst"], d["env"], d["ab"])
    with pytest.raises(ValueError):
        rt.band_analysis_fwd(d["yconst"].transpose(1, 2).contiguous(), d["csw"])
    with pytest.raises(ValueError):
        rt.band_analysis_bwd(d["g_cs"][:, :, ::2], d["cswt"])
    with pytest.raises(ValueError):
        rt.band_analysis_fwd(d["yconst"], d["csw"].cpu())


@pytest.mark.gpu
def test_autograd_functions_launch_the_backward_kernels(cuda):
    d = _data(33, cuda)
    before = [k.launches for k in rt.KERNELS]
    ct = d["ct"].clone().requires_grad_(True)
    y2 = rt.synth_norm(ct, d["csin"], d["yconst"], d["env"], d["ab"], d["abt"])
    cs2 = rt.band_analysis(y2, d["csw"], d["cswt"])
    (cs2 * d["g_cs"]).sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(ct.grad).all()
    assert [k.launches - n for k, n in zip(rt.KERNELS, before)] == [1, 1, 1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 97, 626])
def test_synth_norm_wmma_entries_match_plain(cuda, t):
    """The synth_norm pair's first versions (aw_synth_norm_fwd_wmma,
    aw_synth_norm_bwd_wmma: the WMMA template, reached by no wrapper)
    still agree with the plain versions, and count nowhere."""
    d = _data(t, cuda)
    before = [k.launches for k in rt.KERNELS]
    y2, m1 = rt._synth_norm_fwd_wmma(d["ct"], d["csin"], d["yconst"], d["env"], d["ab"])
    y2p, m1p = rt.synth_norm_fwd_plain(d["ct"], d["csin"], d["yconst"], d["env"], d["ab"])
    dc = rt._synth_norm_bwd_wmma(d["g_y2"], y2p, m1p, d["csin"], d["env"], d["abt"])
    torch.cuda.synchronize()
    _close(y2, y2p)
    _close(m1, m1p)
    _close(dc, rt.synth_norm_bwd_plain(d["g_y2"], y2p, m1p, d["csin"], d["env"], d["abt"]))
    assert [k.launches for k in rt.KERNELS] == before


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 40, 626])
def test_synth_norm_u_is_the_steps_forward_half(cuda, t):
    """Row 1's first two launches (aw_synth_u) give aw_iteration_fwd_sm90's
    u and m1 bit for bit on the same ct: the same stages on the same
    tile; its y2 is u / peak_den(m1) bit for bit; it repeats bit for bit."""
    ct, c, _, _ = _iter_inputs(t, cuda)
    u, m1 = rt._synth_u(ct, c.csin, c.y_const, c.env, c.ab)
    _, res = it.iteration_forward_fwd(ct, c)
    y2, m1_y2 = rt.synth_norm_fwd(ct, c.csin, c.y_const, c.env, c.ab)
    again = rt.synth_norm_fwd(ct, c.csin, c.y_const, c.env, c.ab)
    torch.cuda.synchronize()
    assert torch.equal(u, res.u) and torch.equal(m1, res.m1)
    assert torch.equal(m1_y2, m1) and torch.equal(y2, u / rt.peak_den(m1))
    assert torch.equal(again[0], y2) and torch.equal(again[1], m1_y2)


@pytest.mark.gpu
def test_synth_norm_bwd_splits_ties_and_repeats(cuda):
    """Row 2 on clips with several equal maxima of both signs, at m1 = 3:
    the sm90 VJP to the plain version's tie split, bit for bit twice."""
    d = _data(97, cuda)
    y2, _ = rt.synth_norm_fwd_plain(d["ct"], d["csin"], d["yconst"], d["env"], d["ab"])
    flat = y2.reshape(B, -1)
    peak = flat.abs().amax(dim=1)
    flat[:, 11], flat[:, 5000], flat[:, -4] = peak, -peak, peak
    m1 = torch.full((B,), 3.0, device=cuda)
    args = (d["g_y2"], y2, m1, d["csin"], d["env"], d["abt"])
    new, again = rt.synth_norm_bwd(*args), rt.synth_norm_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(new, again)
    _close(new, rt.synth_norm_bwd_plain(*args))


@pytest.mark.gpu
def test_synth_norm_wrappers_refuse_before_any_launch(cuda):
    def moved(x):  # a copy 2 bytes past a 16-byte boundary
        out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        out.copy_(x)
        return out

    d = _data(8, cuda)
    before = [k.launches for k in rt.KERNELS]
    with pytest.raises(ValueError):
        rt.synth_norm_fwd(d["ct"], d["csin"], d["yconst"], d["env"], moved(d["ab"]))
    with pytest.raises(ValueError):  # T = 1
        rt.synth_norm_fwd(d["ct"][:, :1].contiguous(), d["csin"][:, :1].contiguous(),
                          d["yconst"][:, :0], d["env"][:0], d["ab"])
    y2, m1 = rt.synth_norm_fwd_plain(d["ct"], d["csin"], d["yconst"], d["env"], d["ab"])
    with pytest.raises(ValueError):
        rt.synth_norm_bwd(d["g_y2"], y2, m1, d["csin"], d["env"], moved(d["abt"]))
    with pytest.raises(TypeError):
        rt.synth_norm_bwd(d["g_y2"], y2, m1.double(), d["csin"], d["env"], d["abt"])
    assert [k.launches for k in rt.KERNELS] == before


def _det_consts(device):
    net = DetectorNetConfig()
    lo, hi = in_band_bins(net.sample_rate, net.n_fft, (500.0, 4000.0))
    basis = mel_filter_bank(net.sample_rate, net.n_fft, net.n_mels)
    rng = np.random.default_rng(7)
    csw = torch.as_tensor((rng.standard_normal((4 * HOP, 2 * td.P_BAND)) / 16).astype(np.float32),
                          device=device).to(torch.bfloat16)
    return tad.AnalysisDetConsts(
        csw=csw, cswt=csw.t().contiguous(),
        det=td.fused_detector_consts(params_from_jax(load_key_params()), basis, lo, hi, device),
    ), hi - lo


def _det_inputs(t, device, nb):
    rng = np.random.default_rng(100 + t)
    cs = np.zeros((B, t, 2 * td.P_BAND), np.float32)
    cs[..., :nb] = 0.1 * rng.standard_normal((B, t, nb))
    cs[..., td.P_BAND : td.P_BAND + nb] = 0.1 * rng.standard_normal((B, t, nb))
    y2 = 0.8 * np.tanh(rng.standard_normal((B, t - 1, HOP)))
    g = np.zeros((B, td.CH[4]), np.float32)
    g[:, : td.N_BITS] = rng.standard_normal((B, td.N_BITS))
    return (torch.as_tensor(v.astype(np.float32), device=device) for v in (cs, y2, g))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 97, 626])
def test_detector_kernels_match_plain(cuda, t):
    ac, nb = _det_consts(cuda)
    cs, y2, g = _det_inputs(t, cuda, nb)
    before = [k.launches for k in td.KERNELS + tad.KERNELS]
    for x, fwd, fwd_plain, bwd, bwd_plain, c in (
        (cs, td.detector_fused_fwd, td.detector_fused_fwd_plain, td.detector_fused_bwd,
         td.detector_fused_bwd_plain, ac.det),
        (y2, tad.analysis_detector_fwd, tad.analysis_detector_fwd_plain,
         tad.analysis_detector_bwd, tad.analysis_detector_bwd_plain, ac),
    ):
        _, res_k = fwd(x, c)
        _, res_p = fwd_plain(x, c)
        ag.check_forward(res_k, res_p, t)
        ref = bwd_plain(g, res_p, c)
        ag.check_vjp(bwd(g, res_p, c), ref)
        # the solver's chain: the VJP on the kernel's residuals, below 32
        # frames to the short-clip bound
        ag.check_vjp(bwd(g, res_k, c), ref, chain=True, t=t)
    torch.cuda.synchronize()
    # the merged wrappers launch the detector kernels too
    assert [k.launches - n for k, n in zip(td.KERNELS + tad.KERNELS, before)] == [2, 4, 1, 2]


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 97, 626])
def test_reflect_analysis_kernels_match_plain(cuda, t):
    """The merged kernels' own halves, where no bf16 rounding of a float32
    sum can flip: the reflect-pad GEMM and the interior rows of its
    transpose to 1e-5 * max|plain| (float32 sums in another order).  The
    six boundary rows also take the pad rows' cotangents, rounded to bf16
    before they are routed, where one rounding may flip: 2^-8 * max|plain|."""
    ac, nb = _det_consts(cuda)
    _, y2, _ = _det_inputs(t, cuda, nb)
    cs2 = tad._reflect_analysis_fwd(y2, ac)
    ref = tad.reflect_analysis_fwd_plain(y2, ac)
    assert float((cs2 - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    dcs = torch.as_tensor(np.random.default_rng(t).standard_normal(tuple(cs2.shape)),
                          dtype=torch.float32, device=cuda)
    gy2 = tad._reflect_analysis_bwd(dcs, ac)
    ref = tad.reflect_analysis_bwd_plain(dcs, ac)
    scale = float(ref.abs().max())
    assert float((gy2 - ref)[:, 3:-3].abs().max()) <= 1e-5 * scale
    assert float((gy2 - ref).abs().max()) <= 2.0**-8 * scale


@pytest.mark.gpu
def test_detector_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ac, nb = _det_consts(cuda)
    cs, y2, g = _det_inputs(8, cuda, nb)
    with pytest.raises(TypeError):
        td.detector_fused_fwd(cs.double(), ac.det)
    with pytest.raises(ValueError):
        td.detector_fused_fwd(cs[..., :256].contiguous(), ac.det)
    with pytest.raises(ValueError):
        tad.analysis_detector_fwd(y2[:, :6].contiguous(), ac)  # T = 7 < 8
    with pytest.raises(ValueError):
        tad.analysis_detector_fwd(y2, ac._replace(csw=ac.csw.cpu()))


@pytest.mark.gpu
def test_detector_autograd_functions_launch_the_backward_kernels(cuda):
    ac, nb = _det_consts(cuda)
    cs, y2, _ = _det_inputs(33, cuda, nb)
    before = [k.launches for k in td.KERNELS + tad.KERNELS]
    x = y2.clone().requires_grad_(True)
    tad.analysis_detector(x, ac).sum().backward()
    c = cs.clone().requires_grad_(True)
    td.detector_fused(c, ac.det).sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all() and torch.isfinite(c.grad).all()
    assert [k.launches - n for k, n in zip(td.KERNELS + tad.KERNELS, before)] == [2, 2, 1, 1]


def _iter_inputs(t, device):
    # speech-like clips through the solver's build_problem, as on the main path
    return ag.iteration_problem(t, B, 200 + t, device)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 97, 626])
def test_iteration_kernels_match_plain(cuda, t):
    ct, c, wm, g = _iter_inputs(t, cuda)
    before = [k.launches for k in it.KERNELS]
    ag.check_iteration(ct, c, wm, g, it.nadam_coefs(), t)
    torch.cuda.synchronize()
    # the forward once, the VJP on the plain, the forward's and the step's
    # residuals, the step once
    assert [k.launches - n for k, n in zip(it.KERNELS, before)] == [1, 3, 1]


@pytest.mark.gpu
def test_iteration_launch_counts(cuda):
    ct, c, wm, _ = _iter_inputs(33, cuda)
    others = rt.KERNELS + td.KERNELS + tad.KERNELS
    before = [k.launches for k in it.KERNELS + others]
    x = ct.clone().requires_grad_(True)
    it.iteration_forward(x, c).sum().backward()
    state = [ct.clone(), torch.zeros_like(ct), torch.zeros_like(ct), ct.clone(),
             torch.full((B,), float("inf"), device=cuda)]
    s = torch.full((B,), 0.1, device=cuda)
    loss = it.iteration_step(*state, ct - 1, ct + 1, wm, s, s, torch.full((1,), 1e-3, device=cuda),
                             c, it.nadam_coefs())
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all() and torch.isfinite(loss).all()
    assert torch.equal(state[4], loss) and torch.equal(state[3], state[0])
    # one forward and one VJP through the autograd function, one step, and
    # nothing of the two-kernel chain
    assert [k.launches - n for k, n in zip(it.KERNELS + others, before)] == [1, 1, 1] + [0] * 8


@pytest.mark.gpu
def test_iteration_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ct, c, wm, g = _iter_inputs(8, cuda)
    with pytest.raises(TypeError):
        it.iteration_forward_fwd(ct.double(), c)
    with pytest.raises(ValueError):
        it.iteration_forward_fwd(ct[:, :7].contiguous(), c)  # T = 7 < 8
    with pytest.raises(ValueError):
        it.iteration_forward_fwd(ct, c._replace(csw=c.csw.cpu()))
    _, res = it.iteration_forward_fwd(ct, c)
    with pytest.raises(ValueError):
        it.iteration_forward_bwd(g[:, :20].contiguous(), res, c)
    s = torch.full((B,), 0.1, device=cuda)
    state = [ct.clone(), torch.zeros_like(ct), torch.zeros_like(ct), ct.clone(),
             torch.full((B,), float("inf"), device=cuda)]
    with pytest.raises(ValueError):  # d2 is one value on the card
        it.iteration_step(*state, ct - 1, ct + 1, wm, s, s, torch.full((B,), 1e-3, device=cuda),
                          c, it.nadam_coefs())
    with pytest.raises(ValueError):
        it.iteration_step(*state, ct - 1, ct + 1, wm[:, :20].contiguous(), s, s,
                          torch.full((1,), 1e-3, device=cuda), c, it.nadam_coefs())


def _tiled_data(t, device, loud_tail=False):
    """The long-clip kernels' operands; with ``loud_tail`` y_const 0, env
    4 and the last frame x50, so that the rows past lr set m1 (the last
    frame reaches rows lr-2 .. lr+1; the envelope divides those below lr)."""
    rng = np.random.default_rng(300 + t)
    p, lr, nfft = 256, t - 1, 4 * HOP

    def f32(*shape, scale=1.0):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32),
                               device=device)

    cos, sin = f32(B, 225, t), f32(B, 225, t)
    d = {"ct": f32(B, t, p, scale=0.1), "csinp": rtt.make_csinp(cos, sin, p),
         "yconst": f32(B, lr, HOP, scale=0.01), "env": 1.0 + f32(lr, HOP).abs(),
         "g_y2": f32(B, lr, HOP), "g_cs": f32(B, t, 2 * p)}
    if loud_tail:
        d["ct"][:, -1] *= 50.0
        d["yconst"].zero_()
        d["env"].fill_(4.0)
    d.update(rtt.build_tiled_bases(rng.standard_normal((2 * p, nfft)).astype(np.float32) / 16,
                                   rng.standard_normal((nfft, 2 * p)).astype(np.float32) / 16,
                                   device))
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("t, loud_tail", [(257, False), (300, True), (1281, False),
                                          (3751, False)])
def test_tiled_kernels_match_plain(cuda, t, loud_tail):
    d = _tiled_data(t, cuda, loud_tail)
    lr = t - 1
    before = [k.launches for k in rtt.KERNELS]
    args = (d["ct"], d["csinp"], d["yconst"], d["env"], d["w_sf"])
    u, m1 = rtt.synth_tiled_fwd(*args)
    up, m1p = rtt.synth_tiled_fwd_plain(*args)
    torch.cuda.synchronize()
    _close(u, up)
    _close(m1, m1p)
    if loud_tail:
        assert torch.all(m1 > 1.1 * u.abs().amax(dim=(1, 2)))
    pad = torch.nn.functional.pad
    for x, w, n_out in ((pad(up, (0, 0, 2, 0)), d["w_af"], t),
                        (pad(d["g_cs"], (0, 0, 3, 0)), d["w_ab"], lr + 3),
                        (pad(d["g_y2"], (0, 0, 2, 0)), d["w_sb"], t)):
        _close(rtt.shift_mm(x, w, n_out), rtt.shift_mm_plain(x, w, n_out))
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(rtt.KERNELS, before)] == [3, 1]


@pytest.mark.gpu
def test_tiled_autograd_functions_launch_the_kernels(cuda):
    d = _tiled_data(1100, cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        before = [k.launches for k in rtt.KERNELS + rt.KERNELS]
        ct = d["ct"].to(dev).clone().requires_grad_(True)
        y2 = rtt.synth_norm_tiled(ct, *(d[k].to(dev) for k in
                                        ("csinp", "yconst", "env", "w_sf", "w_sb")))
        cs2 = rtt.band_analysis_tiled(y2, d["w_af"].to(dev), d["w_ab"].to(dev))
        (cs2 * d["g_cs"].to(dev)).sum().backward()
        torch.cuda.synchronize()
        grads.append(ct.grad.cpu())
        launched = [k.launches - n for k, n in zip(rtt.KERNELS + rt.KERNELS, before)]
        # on the card the forward and two VJP products and the synthesis,
        # nothing of the whole-clip kernels; on the CPU nothing
        assert launched == ([3, 1] if dev == cuda else [0, 0]) + [0] * 4
    assert torch.isfinite(grads[0]).all()
    _close(grads[0], grads[1])


@pytest.mark.gpu
def test_tiled_wrappers_reject_what_the_kernels_do_not_take(cuda):
    d = _tiled_data(300, cuda)
    with pytest.raises(TypeError):  # the tiled path's phase is float32
        rtt.synth_tiled_fwd(d["ct"], d["csinp"].to(torch.bfloat16), d["yconst"], d["env"],
                            d["w_sf"])
    with pytest.raises(ValueError):
        rtt.synth_tiled_fwd(d["ct"], d["csinp"][:, :-1].contiguous(), d["yconst"], d["env"],
                            d["w_sf"])
    with pytest.raises(ValueError):
        rtt.shift_mm(d["g_cs"][:, :, ::2], d["w_ab"], 300)
    with pytest.raises(ValueError):
        rtt.shift_mm(d["g_y2"], d["w_sb"].cpu(), 300)


@pytest.mark.gpu
@pytest.mark.parametrize("t, loud_tail", [(257, False), (300, True), (3751, False)])
def test_synth_tiled_against_its_wmma_version_and_plain(cuda, t, loud_tail):
    """The sm90 synthesis (the reim pass, then the slab GEMM) and its first
    WMMA version (aw_synth_tiled_fwd_wmma, reached by no wrapper) against
    the plain version; the new one bit for bit over two launches."""
    d = _tiled_data(t, cuda, loud_tail)
    args = (d["ct"], d["csinp"], d["yconst"], d["env"], d["w_sf"])
    b, _, p = d["ct"].shape
    before = rtt.synth_tiled_fwd.launches
    new, again = rtt.synth_tiled_fwd(*args), rtt.synth_tiled_fwd(*args)
    ref = rtt.synth_tiled_fwd_plain(*args)
    old = (torch.empty_like(ref[0]), torch.empty_like(ref[1]))
    rt._run("aw_synth_tiled_fwd_wmma", cuda, *args, *old, b, t, p, HOP, rtt.m1_rows(t - 1))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(new, again))
    for ours in (new, old):
        _close(ours[0], ref[0])
        _close(ours[1], ref[1])
    if loud_tail:  # the rows past lr set m1
        assert torch.all(new[1] > 1.1 * new[0].abs().amax(dim=(1, 2)))
    assert rtt.synth_tiled_fwd.launches - before == 2


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 97, 626])
def test_iteration_bwd_against_its_wmma_version_and_plain(cuda, t):
    """The sm90 VJP (the step's backward half from g, then the phase fold)
    and its first WMMA chain (aw_iteration_bwd_wmma, reached by no wrapper)
    against the plain VJP from the plain residuals, to agreement.VJP_TOL;
    the new one bit for bit over two launches."""
    ct, c, _, g = _iter_inputs(t, cuda)
    _, res = it.iteration_forward_fwd_plain(ct, c)
    before = [k.launches for k in it.KERNELS]
    new, again = it.iteration_forward_bwd(g, res, c), it.iteration_forward_bwd(g, res, c)
    old = it._iteration_forward_bwd_wmma(g, res, c)
    ref = it.iteration_forward_bwd_plain(g, res, c)
    torch.cuda.synchronize()
    assert torch.equal(new, again)
    ag.check_vjp(new, ref)
    ag.check_vjp(old, ref)
    assert [k.launches - n for k, n in zip(it.KERNELS, before)] == [0, 2, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("t", [40, 626])
def test_iteration_fwd_sm90_against_the_paths_wmma_chain_and_plain(cuda, t):
    """The forward on the sm90 step's forward half (aw_iteration_fwd_sm90,
    the path's) and its first WMMA chain (aw_iteration_fwd_wmma, reached by no
    wrapper) against the plain forward on pred and every residual
    (agreement.ITER_FWD_TOL and ITER_SHARE_TOL), y2 and m1 to Y2_TOL; the
    sm90 one bit for bit over two launches, and its residuals carried by
    the sm90 VJP to ITER_CHAIN_TOL of the plain chain."""
    ct, c, _, g = _iter_inputs(t, cuda)
    before = [k.launches for k in it.KERNELS]
    new, again = it.iteration_forward_fwd(ct, c), it.iteration_forward_fwd(ct, c)
    old = it._iteration_forward_fwd_wmma(ct, c)
    _, ref = it.iteration_forward_fwd_plain(ct, c)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((*new[1].det, new[1].u, new[1].m1),
                                                 (*again[1].det, again[1].u, again[1].m1)))
    for _, ours in (new, old):
        ag.check_forward(ours.det, ref.det, t, ag.ITER_FWD_TOL, ag.ITER_SHARE_TOL)
        assert ag._rel(ours.y2, ref.y2) <= ag.Y2_TOL and ag._rel(ours.m1, ref.m1) <= ag.Y2_TOL
    ag.check_vjp(it.iteration_forward_bwd(g, new[1], c), it.iteration_forward_bwd_plain(g, ref, c),
                 chain=True, t=t, chain_tol=ag.ITER_CHAIN_TOL)
    # the path's forward twice and the VJP once; the WMMA forward counts nowhere
    assert [k.launches - n for k, n in zip(it.KERNELS, before)] == [2, 1, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 40, 626])
def test_detector_forwards_against_their_wmma_versions_and_plain(cuda, t):
    """The sm90 detector_fused forward (the step's detector forward from
    cs) and the analysis_detector forward (the step's reflect analysis,
    then it), each beside its first WMMA version (aw_detector_fwd_wmma,
    aw_reflect_analysis_fwd_wmma then it; reached by no wrapper), against
    the plain forward on pred and every residual (agreement.FWD_TOL and
    SHARE_TOL); the new ones bit for bit over two launches, and the sm90
    VJP on the new forward's residuals as a chain."""
    ac, nb = _det_consts(cuda)
    cs, y2, g = _det_inputs(t, cuda, nb)
    before = [k.launches for k in td.KERNELS + tad.KERNELS]
    for x, fwd, fwd_wmma, fwd_plain, bwd, bwd_plain, c in (
        (cs, td.detector_fused_fwd, td._detector_fused_fwd_wmma, td.detector_fused_fwd_plain,
         td.detector_fused_bwd, td.detector_fused_bwd_plain, ac.det),
        (y2, tad.analysis_detector_fwd, tad._analysis_detector_fwd_wmma,
         tad.analysis_detector_fwd_plain, tad.analysis_detector_bwd,
         tad.analysis_detector_bwd_plain, ac),
    ):
        (_, new), (_, again) = fwd(x, c), fwd(x, c)
        _, old = fwd_wmma(x, c)
        _, ref = fwd_plain(x, c)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(new, again))
        ag.check_forward(new, ref, t)
        ag.check_forward(old, ref, t)
        ag.check_vjp(bwd(g, new, c), bwd_plain(g, ref, c), chain=True, t=t)
    # the merged wrapper launches the detector forward too; the WMMA versions count nowhere
    assert [k.launches - n for k, n in zip(td.KERNELS + tad.KERNELS, before)] == [4, 2, 2, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("t", [40, 626])
def test_detector_vjps_against_their_wmma_versions_and_plain(cuda, t):
    """The sm90 detector_fused VJP (the step's detector VJP from g) and
    the analysis_detector VJP (it, then the step's reflect analysis VJP and
    the fold), each beside its first WMMA version (aw_detector_bwd_wmma,
    then aw_reflect_analysis_bwd_wmma; reached by no wrapper), against the
    plain VJP from the plain residuals to agreement.VJP_TOL; the new ones
    bit for bit over two launches."""
    ac, nb = _det_consts(cuda)
    cs, y2, g = _det_inputs(t, cuda, nb)
    before = [k.launches for k in td.KERNELS + tad.KERNELS]
    for x, fwd_plain, bwd, bwd_wmma, bwd_plain, c in (
        (cs, td.detector_fused_fwd_plain, td.detector_fused_bwd, td._detector_fused_bwd_wmma,
         td.detector_fused_bwd_plain, ac.det),
        (y2, tad.analysis_detector_fwd_plain, tad.analysis_detector_bwd,
         tad._analysis_detector_bwd_wmma, tad.analysis_detector_bwd_plain, ac),
    ):
        _, res = fwd_plain(x, c)
        new, again = bwd(g, res, c), bwd(g, res, c)
        old = bwd_wmma(g, res, c)
        ref = bwd_plain(g, res, c)
        torch.cuda.synchronize()
        assert torch.equal(new, again)
        ag.check_vjp(new, ref)
        ag.check_vjp(old, ref)
    # the merged wrapper launches the detector VJP too; the WMMA versions count nowhere
    assert [k.launches - n for k, n in zip(td.KERNELS + tad.KERNELS, before)] == [0, 4, 0, 2]


@pytest.mark.gpu
def test_redesigned_wrappers_refuse_before_any_launch(cuda):
    def moved(x):  # a copy 4 (bf16: 2) bytes past a 16-byte boundary
        out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        out.copy_(x)
        return out

    d = _tiled_data(300, cuda)
    before = rtt.synth_tiled_fwd.launches
    for i, name in enumerate(("ct", "csinp", "yconst", "env", "w_sf")):
        args = [d[k] for k in ("ct", "csinp", "yconst", "env", "w_sf")]
        args[i] = moved(args[i])
        with pytest.raises(ValueError):
            rtt.synth_tiled_fwd(*args)
    assert rtt.synth_tiled_fwd.launches == before
    ct, c, _, g = _iter_inputs(8, cuda)
    _, res = it.iteration_forward_fwd_plain(ct, c)
    before = it.iteration_forward_bwd.launches
    with pytest.raises(ValueError):
        it.iteration_forward_bwd(g, res, c._replace(cswt=moved(c.cswt)))
    with pytest.raises(ValueError):
        it.iteration_forward_bwd(g, res, c._replace(det=c.det._replace(w2=moved(c.det.w2))))
    with pytest.raises(ValueError):  # T = 7 < 8
        short = res._replace(det=res.det._replace(nph=res.det.nph[:, :7].contiguous()))
        it.iteration_forward_bwd(g, short, c)
    assert it.iteration_forward_bwd.launches == before
    before = it.iteration_forward_fwd.launches
    for case in ("ab", "csw"):  # the sm90 forward's tensor maps
        with pytest.raises(ValueError):
            it.iteration_forward_fwd(ct, c._replace(**{case: moved(getattr(c, case))}))
    with pytest.raises(ValueError):
        it.iteration_forward_fwd(ct, c._replace(det=c.det._replace(w1t=moved(c.det.w1t))))
    assert it.iteration_forward_fwd.launches == before
    ac, nb = _det_consts(cuda)
    cs, y2, g = _det_inputs(8, cuda, nb)
    _, res = td.detector_fused_fwd_plain(cs, ac.det)
    before = [k.launches for k in td.KERNELS + tad.KERNELS]
    with pytest.raises(ValueError):  # the sm90 forwards' tensor maps and frames
        td.detector_fused_fwd(cs, ac.det._replace(w2t=moved(ac.det.w2t)))
    with pytest.raises(ValueError):  # T = 7 < 8
        td.detector_fused_fwd(cs[:, :7].contiguous(), ac.det)
    with pytest.raises(ValueError):
        tad.analysis_detector_fwd(y2, ac._replace(csw=moved(ac.csw)))
    with pytest.raises(ValueError):  # the detector half's weight, before the analysis launches
        tad.analysis_detector_fwd(y2, ac._replace(det=ac.det._replace(melb=moved(ac.det.melb))))
    with pytest.raises(ValueError):
        td.detector_fused_bwd(g, res, ac.det._replace(melbt=moved(ac.det.melbt)))
    with pytest.raises(ValueError):  # T = 7 < 8
        td.detector_fused_bwd(g, td.detector_fused_fwd_plain(cs[:, :7].contiguous(), ac.det)[1],
                              ac.det)
    with pytest.raises(ValueError):
        tad.analysis_detector_bwd(g, tad.analysis_detector_fwd_plain(y2, ac)[1],
                                  ac._replace(cswt=moved(ac.cswt)))
    assert [k.launches for k in td.KERNELS + tad.KERNELS] == before


def _slab_uses(d, t):
    """shift_mm's three uses on the long path, its operands padded as the
    autograd ops pad them: (x, w, n_out)."""
    pad = torch.nn.functional.pad
    return ((pad(d["g_y2"], (0, 0, 2, 0)), d["w_af"], t),
            (pad(d["g_cs"], (0, 0, 3, 0)), d["w_ab"], t + 2),
            (pad(d["g_y2"], (0, 0, 2, 0)), d["w_sb"], t))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [257, 1281, 3751])
def test_slab_gemm_shift_mm_matches_plain_on_every_tile(cuda, t):
    """The sm90 slab GEMM at shift_mm's three uses: through the wrapper
    (its planned tile, one launch each) and on each tile it can take."""
    d = _tiled_data(t, cuda)
    before = rtt.shift_mm.launches
    for x, w, n_out in _slab_uses(d, t):
        ref = rtt.shift_mm_plain(x, w, n_out)
        _close(rtt.shift_mm(x, w, n_out), ref)
        b, n, dd = x.shape
        e = w.shape[-1]
        for bm, bn in rt.SLAB_TILES:
            out = torch.full((b, n_out, e), float("nan"), device=cuda)
            rt._run("aw_shift_mm", cuda, x, w, out, b, n, dd, e, n_out, bm, bn)
            _close(out, ref)
    torch.cuda.synchronize()
    assert rtt.shift_mm.launches - before == 3


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 97, 626])
def test_slab_gemm_band_analysis_vjp_matches_plain_on_every_tile(cuda, t):
    d = _data(t, cuda)
    ref = rt.band_analysis_bwd_plain(d["g_cs"], d["cswt"])
    before = rt.band_analysis_bwd.launches
    _close(rt.band_analysis_bwd(d["g_cs"], d["cswt"]), ref)
    for bm, bn in rt.SLAB_TILES:
        out = torch.full((B, t - 1, HOP), float("nan"), device=cuda)
        rt._run("aw_band_analysis_bwd", cuda, d["g_cs"], d["cswt"], out, B, t, 512, HOP, bm, bn)
        _close(out, ref)
    torch.cuda.synchronize()
    assert rt.band_analysis_bwd.launches - before == 1


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 97, 626])
def test_slab_gemm_band_analysis_forward_matches_plain_on_every_tile(cuda, t):
    d = _data(t, cuda)
    y2 = d["g_y2"]
    ref = rt.band_analysis_fwd_plain(y2, d["csw"])
    before = rt.band_analysis_fwd.launches
    _close(rt.band_analysis_fwd(y2, d["csw"]), ref)
    for bm, bn in rt.SLAB_TILES:
        out = torch.full((B, t, 512), float("nan"), device=cuda)
        rt._run("aw_band_analysis_fwd", cuda, y2, d["csw"], out, B, t, 512, HOP, bm, bn)
        _close(out, ref)
    torch.cuda.synchronize()
    assert rt.band_analysis_fwd.launches - before == 1


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n", [(8 * 313, 1024, 128), (3 * 48, 512, 1024), (7, 128, 256)])
def test_dense_gemm_matches_plain_on_every_tile(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = torch.as_tensor(rng.standard_normal((m, k)).astype(np.float32), device=cuda)
    w = torch.as_tensor(rng.standard_normal((k, n)).astype(np.float32) / 16, device=cuda)
    a, w = a.to(torch.bfloat16), w.to(torch.bfloat16)
    ref = a.float() @ w.float()
    for bm, bn in rt.SLAB_TILES:
        out = torch.full((m, n), float("nan"), device=cuda)
        rt._run("aw_dense_gemm", cuda, a, w, out, m, k, n, bm, bn)
        _close(out, ref)
        again = out.clone()
        rt._run("aw_dense_gemm", cuda, a, w, out, m, k, n, bm, bn)
        assert torch.equal(again, out)


@pytest.mark.gpu
def test_iteration_step_repeats_bit_for_bit(cuda):
    ct, c, wm, _ = _iter_inputs(97, cuda)
    s = torch.full((B,), 0.1, device=cuda)
    bufs = it.step_buffers(B, 97, 512, HOP, cuda)
    outs = []
    for _ in range(2):
        state = [ct.clone(), torch.zeros_like(ct), torch.zeros_like(ct), ct.clone(),
                 torch.full((B,), float("inf"), device=cuda)]
        loss = it.iteration_step(*state, ct - 1, ct + 1, wm, s, s,
                                 torch.full((1,), 1e-3, device=cuda), c, it.nadam_coefs(), bufs)
        outs.append([*state, loss.clone(), bufs.scratch.big.clone()])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*outs))


@pytest.mark.gpu
def test_slab_gemm_kernels_repeat_bit_for_bit(cuda):
    d = _tiled_data(1281, cuda)
    for x, w, n_out in _slab_uses(d, 1281):
        assert torch.equal(rtt.shift_mm(x, w, n_out), rtt.shift_mm(x, w, n_out))
    d = _data(626, cuda)
    assert torch.equal(rt.band_analysis_bwd(d["g_cs"], d["cswt"]),
                       rt.band_analysis_bwd(d["g_cs"], d["cswt"]))
    assert torch.equal(rt.band_analysis_fwd(d["g_y2"], d["csw"]),
                       rt.band_analysis_fwd(d["g_y2"], d["csw"]))


@pytest.mark.gpu
def test_slab_gemm_wrappers_reject_what_the_kernels_do_not_take(cuda):
    d = _tiled_data(300, cuda)
    x = d["g_y2"]
    before = (rtt.shift_mm.launches, rt.band_analysis_bwd.launches)
    moved = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)  # 4 bytes off 16
    moved.copy_(x)
    with pytest.raises(ValueError):  # TMA's 16-byte address alignment
        rtt.shift_mm(moved, d["w_af"], 300)
    with pytest.raises(ValueError):  # D % 32
        rtt.shift_mm(x[..., :240].contiguous(), d["w_af"][:, :240].contiguous(), 300)
    with pytest.raises(ValueError):  # E % 64
        rtt.shift_mm(x, d["w_af"][..., :480].contiguous(), 300)
    with pytest.raises(ValueError):  # no output row
        rtt.shift_mm(x, d["w_af"], 0)
    g = _data(97, cuda)["g_cs"]
    g_moved = torch.empty(g.numel() + 1, device=cuda)[1:].view(g.shape)
    g_moved.copy_(g)
    with pytest.raises(ValueError):
        rt.band_analysis_bwd(g_moved, _data(97, cuda)["cswt"])
    y_moved = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    y_moved.copy_(x)
    before_fwd = rt.band_analysis_fwd.launches
    with pytest.raises(ValueError):
        rt.band_analysis_fwd(y_moved, _data(300, cuda)["csw"])
    assert (rtt.shift_mm.launches, rt.band_analysis_bwd.launches) == before
    assert rt.band_analysis_fwd.launches == before_fwd


def _ola_data(t, device, batch=B):
    rng = np.random.default_rng(t)
    wkey = tuple(get_window("hann", 4 * HOP).tolist())
    env = _ola_envelope(wkey, 4 * HOP, HOP, t).reshape(t - 1, HOP).astype(np.float32)
    return (torch.as_tensor(rng.standard_normal((batch, t, 4 * HOP)).astype(np.float32),
                            device=device),
            torch.as_tensor(env, device=device),
            torch.as_tensor(rng.standard_normal((batch, t - 1, HOP)).astype(np.float32),
                            device=device))


def _ola_variants(t, batch=B):
    """The ola_normalize variants that take a clip of t frames: the
    cluster variant at each cluster size where its rows fit, the stream
    variant always."""
    out = [("stream", on.CLUSTER)]
    for size in on.CLUSTER_SIZES:
        plan = on.ola_plan(batch, t, HOP, size)
        if plan.variant == "cluster":
            out.append(("cluster", size))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 63, 626, 3751])
def test_ola_kernels_match_plain(cuda, t):
    """The JAX suite's tolerances for this kernel (tests/test_pallas.py):
    forward atol/rtol 1e-6, VJP atol 1e-5 rtol 1e-4; with a silent lane,
    and a tie of opposite signs at the peak of another; the wrappers (the
    planned variant, the stream variant at 3751 frames) and each variant."""
    wf, env, g = _ola_data(t, cuda)
    wf[1] = 0.0  # a silent lane
    y2p, m1p = on.ola_normalize_fwd_plain(wf, env)
    before = [k.launches for k in on.KERNELS]
    plan = on.ola_plan(B, t, HOP)
    taken = [dict(k.variants) for k in on.KERNELS]
    y2, m1 = on.ola_normalize_fwd(wf, env)
    outs = [(y2, m1)] + [on._ola_fwd_variant(wf, env, v, size) for v, size in _ola_variants(t)]
    for yy, mm in outs:
        torch.testing.assert_close(yy, y2p, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(mm, m1p, atol=1e-6, rtol=1e-6)
        assert float(mm[1]) == 0.0
    ties = y2p.clone()
    ties[2, 0, 5], ties[2, -1, 7] = 2.0, -2.0  # two ties above every other |y2|
    for y in (y2p, ties):
        ref = on.ola_normalize_bwd_plain(g, y, env, m1p)
        dwfs = [on.ola_normalize_bwd(g, y, env, m1p)] + [
            on._ola_bwd_variant(g, y, env, m1p, v, size) for v, size in _ola_variants(t)]
        for dwf in dwfs:
            assert torch.isfinite(dwf).all()
            torch.testing.assert_close(dwf, ref, atol=1e-5, rtol=1e-4)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(on.KERNELS, before)] == [1, 2]
    assert [k.variants[plan.variant] - d[plan.variant] for k, d in zip(on.KERNELS, taken)] == [
        1, 2]
    assert plan.variant == ("stream" if t == 3751 else "cluster")


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 63, 626])
def test_ola_cluster_forward_gives_the_stream_forwards_bits(cuda, t):
    """The same adds in the same order and the same division: y2 and m1
    bit for bit, at each cluster size."""
    wf, env, _ = _ola_data(t, cuda)
    wf[0] *= 40.0  # a loud clip beside quiet ones
    y2s, m1s = on._ola_fwd_variant(wf, env, "stream")
    for v, size in _ola_variants(t)[1:]:
        y2c, m1c = on._ola_fwd_variant(wf, env, v, size)
        assert torch.equal(y2c, y2s) and torch.equal(m1c, m1s)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 63, 626])
def test_ola_cluster_vjp_repeats_bit_for_bit(cuda, t):
    """Partials combined in rank order, ties counted as integers: two
    launches give the same bits, at each cluster size."""
    wf, env, g = _ola_data(t, cuda)
    y2, m1 = on.ola_normalize_fwd_plain(wf, env)
    for v, size in _ola_variants(t)[1:]:
        a = on._ola_bwd_variant(g, y2, env, m1, v, size)
        b = on._ola_bwd_variant(g, y2, env, m1, v, size)
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_ola_path_launches_the_kernels_and_the_plain_paths_none(cuda):
    """One objective and gradient on each float32 path of the solver: only
    "ola" launches a kernel, once per direction; the card agrees with the
    CPU."""
    kernels = rt.KERNELS + td.KERNELS + tad.KERNELS + it.KERNELS + rtt.KERNELS + on.KERNELS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = DetectorNet(params_from_jax(load_key_params()), DetectorNetConfig())
    rng = np.random.default_rng(0)
    clips = torch.as_tensor(rng.standard_normal((2, 62 * HOP)).astype(np.float32))
    wm = torch.as_tensor(2.0 * rng.integers(0, 2, (2, 20)) - 1.0, dtype=torch.float32)
    for flags, path in (({"use_pallas_ola": True}, "ola"), ({"use_slab_dft": False}, "frames"),
                        ({"matmul_precision": "highest"}, "slab"),
                        ({"use_matmul_dft": False}, "fft")):
        cfg = AwareConfig(**flags)
        out = []
        for dev in (cuda, torch.device("cpu")):
            pb = solver.build_problem(net.to(dev), clips.to(dev), wm.to(dev), cfg)
            assert pb.path == path
            before = [k.launches for k in kernels]
            ct = pb.ct0.clone().requires_grad_(True)
            loss = solver.objective(ct, pb, net, cfg)
            (grad,) = torch.autograd.grad(loss.sum(), ct)
            torch.cuda.synchronize()
            launched = {k.__name__: k.launches - n for k, n in zip(kernels, before)}
            want = {"ola_normalize_fwd": 1, "ola_normalize_bwd": 1} if (
                path == "ola" and dev == cuda) else {}
            assert {k: n for k, n in launched.items() if n} == want
            out.append((loss.detach().cpu(), grad.cpu()))
        (lk, gk), (lp, gp) = out
        torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
        assert float((gk - gp).norm()) <= 1e-2 * float(gp.norm())


@pytest.mark.gpu
def test_ola_wrappers_reject_what_the_kernels_do_not_take(cuda):
    wf, env, g = _ola_data(63, cuda)
    with pytest.raises(TypeError):
        on.ola_normalize_fwd(wf.double(), env)
    with pytest.raises(ValueError):
        on.ola_normalize_fwd(wf[:, :, :512].contiguous(), env)
    with pytest.raises(ValueError):
        on.ola_normalize_fwd(wf, env[:-1].contiguous())
    y2, m1 = on.ola_normalize_fwd(wf, env)
    with pytest.raises(ValueError):
        on.ola_normalize_bwd(g, y2, env, m1.cpu())
