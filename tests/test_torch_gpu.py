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
they are); the whole-iteration kernels by agreement.check_iteration.
"""

import numpy as np
import pytest
import torch

from aware_tpu_torch.config import DetectorNetConfig, in_band_bins
from aware_tpu_torch.models.detector import load_key_params, params_from_jax
from aware_tpu_torch.ops.kernels import agreement as ag
from aware_tpu_torch.ops.kernels import analysis_detector as tad
from aware_tpu_torch.ops.kernels import detector as td
from aware_tpu_torch.ops.kernels import iteration as it
from aware_tpu_torch.ops.kernels import roundtrip as rt
from aware_tpu_torch.ops.mel import mel_filter_bank

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
