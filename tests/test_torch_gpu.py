"""The port's CUDA kernels on the card (``gpu`` marker; skipped without one).

This file imports no jax, so that the card's machine, which has none, can
run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, to 1e-3 * max|plain| (float32 sums in another order on the card).
"""

import numpy as np
import pytest
import torch

from aware_tpu_torch.ops.kernels import roundtrip as rt

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
