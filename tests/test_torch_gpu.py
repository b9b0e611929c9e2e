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
1e-6, VJP atol 1e-5 rtol 1e-4), with a silent lane and a tie probe.
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


def _ola_data(t, device, batch=B):
    rng = np.random.default_rng(t)
    wkey = tuple(get_window("hann", 4 * HOP).tolist())
    env = _ola_envelope(wkey, 4 * HOP, HOP, t).reshape(t - 1, HOP).astype(np.float32)
    return (torch.as_tensor(rng.standard_normal((batch, t, 4 * HOP)).astype(np.float32),
                            device=device),
            torch.as_tensor(env, device=device),
            torch.as_tensor(rng.standard_normal((batch, t - 1, HOP)).astype(np.float32),
                            device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 63, 626])
def test_ola_kernels_match_plain(cuda, t):
    """The JAX suite's tolerances for this kernel (tests/test_pallas.py):
    forward atol/rtol 1e-6, VJP atol 1e-5 rtol 1e-4; with a silent lane,
    and a tie of opposite signs at the peak of another."""
    wf, env, g = _ola_data(t, cuda)
    wf[1] = 0.0  # a silent lane
    y2p, m1p = on.ola_normalize_fwd_plain(wf, env)
    before = [k.launches for k in on.KERNELS]
    y2, m1 = on.ola_normalize_fwd(wf, env)
    torch.testing.assert_close(y2, y2p, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(m1, m1p, atol=1e-6, rtol=1e-6)
    assert float(m1[1]) == 0.0
    ties = y2p.clone()
    ties[2, 0, 5], ties[2, -1, 7] = 2.0, -2.0  # two ties above every other |y2|
    for y in (y2p, ties):
        dwf = on.ola_normalize_bwd(g, y, env, m1p)
        assert torch.isfinite(dwf).all()
        torch.testing.assert_close(dwf, on.ola_normalize_bwd_plain(g, y, env, m1p),
                                   atol=1e-5, rtol=1e-4)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(on.KERNELS, before)] == [1, 2]


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
