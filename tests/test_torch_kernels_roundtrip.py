"""The port's round-trip kernels against the JAX package's Pallas kernels.

The plain PyTorch versions of the four CUDA kernels (synth_norm and
band_analysis, forward and VJP) are held against
``aware_tpu.ops.pallas.roundtrip`` run in Pallas interpret mode on the
CPU.  Inputs come from a seeded numpy generator and reach both frameworks
as the same arrays; bf16 operands are rounded once, in numpy's float32 ->
bf16 cast of each framework (both round to nearest even).

Tolerances:
* forward <= 1e-5 * max|ref|: the bf16 operands are identical and only
  the float32 summation order differs;
* VJPs <= 1e-4 * max|ref|: as the forward, plus the rare bf16 rounding
  flip of a cotangent whose float32 value differs in its last bit;
* the port's autograd.Function gradient against autograd through the
  plain forward <= 2e-2 * max|ref|: the kernel VJP rounds the cotangent
  to bf16 before the transposed product, autograd does not, the same
  bf16-level gap ``tests/test_pallas.py`` allows its kernels.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.ops.pallas import roundtrip as jrt
from aware_tpu_torch.ops.kernels import roundtrip as rt

HOP, B = 256, 2
FRAMES = [8, 33, 64]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(t, p=256, seed=0):
    rng = np.random.default_rng(seed + 1000 * t + p)
    lr, nfft = t - 1, 4 * HOP
    f32 = np.float32
    d = {
        "ct": rng.standard_normal((B, t, p)).astype(f32),
        "csin": rng.standard_normal((B, t, 2 * p)).astype(f32),
        "yconst": (0.1 * rng.standard_normal((B, lr, HOP))).astype(f32),
        "env": (1.0 + rng.random((lr, HOP))).astype(f32),
        "ab": (rng.standard_normal((2 * p, nfft)) / 16).astype(f32),
        "csw": (rng.standard_normal((nfft, 2 * p)) / 16).astype(f32),
        "g_y2": rng.standard_normal((B, lr, HOP)).astype(f32),
        "g_cs": rng.standard_normal((B, t, 2 * p)).astype(f32),
    }
    bf = ("csin", "ab", "csw")
    jx = {k: jnp.asarray(v, jnp.bfloat16 if k in bf else jnp.float32) for k, v in d.items()}
    jx["abt"] = jnp.asarray(d["ab"].T.copy(), jnp.bfloat16)
    jx["cswt"] = jnp.asarray(d["csw"].T.copy(), jnp.bfloat16)
    th = {k: torch.from_numpy(v).to(torch.bfloat16 if k in bf else torch.float32)
          for k, v in d.items()}
    th["abt"] = th["ab"].t().contiguous()
    th["cswt"] = th["csw"].t().contiguous()
    return jx, th


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return np.max(np.abs(ours - ref)) / np.max(np.abs(ref))


# jitted once per shape, so that the clips of a batch share one compile
_jax_synth_impl = jax.jit(jrt._synth_impl)
_jax_analysis = jax.jit(jrt.band_analysis)


@jax.jit
def _jax_synth_vjp(c, csin, yconst, env, ab, abt, g):
    return jax.vjp(lambda x: jrt.synth_norm(x, csin, yconst, env, ab, abt), c)[1](g)[0]


@jax.jit
def _jax_analysis_vjp(y, csw, cswt, g):
    return jax.vjp(lambda x: jrt.band_analysis(x, csw, cswt), y)[1](g)[0]


@pytest.mark.parametrize("t", FRAMES)
def test_synth_forward_matches_jax(t):
    jx, th = _data(t)
    y2, m1 = rt.synth_norm_fwd_plain(th["ct"], th["csin"], th["yconst"], th["env"], th["ab"])
    for i in range(B):
        y2_j, m1_j = _jax_synth_impl(jx["ct"][i], jx["csin"][i], jx["yconst"][i],
                                     jx["env"], jx["ab"])
        assert _rel_err(y2[i], y2_j) <= 1e-5
        assert abs(float(m1[i]) - float(m1_j[0, 0])) <= 1e-5 * float(m1_j[0, 0])


@pytest.mark.parametrize("t", FRAMES)
def test_synth_vjp_matches_jax(t):
    jx, th = _data(t)
    for i in range(B):
        y2_j, m1_j = _jax_synth_impl(jx["ct"][i], jx["csin"][i], jx["yconst"][i],
                                     jx["env"], jx["ab"])
        ref = _jax_synth_vjp(jx["ct"][i], jx["csin"][i], jx["yconst"][i], jx["env"],
                             jx["ab"], jx["abt"], jnp.asarray(th["g_y2"][i].numpy()))
        # the port's VJP from the same forward residuals as the JAX VJP
        ours = rt.synth_norm_bwd_plain(
            th["g_y2"][i : i + 1],
            torch.from_numpy(np.array(y2_j))[None],
            torch.from_numpy(np.array(m1_j)).reshape(1),
            th["csin"][i : i + 1], th["env"], th["abt"],
        )
        assert _rel_err(ours[0], ref) <= 1e-4


@pytest.mark.parametrize("t", FRAMES)
def test_analysis_forward_matches_jax(t):
    jx, th = _data(t)
    y2 = rt.synth_norm_fwd_plain(th["ct"], th["csin"], th["yconst"], th["env"], th["ab"])[0]
    cs2 = rt.band_analysis_fwd_plain(y2, th["csw"])
    for i in range(B):
        ref = _jax_analysis(jnp.asarray(y2[i].numpy()), jx["csw"], jx["cswt"])
        assert _rel_err(cs2[i], ref) <= 1e-5


@pytest.mark.parametrize("t", FRAMES)
def test_analysis_vjp_matches_jax(t):
    jx, th = _data(t)
    y2 = rt.synth_norm_fwd_plain(th["ct"], th["csin"], th["yconst"], th["env"], th["ab"])[0]
    gy2 = rt.band_analysis_bwd_plain(th["g_cs"], th["cswt"])
    for i in range(B):
        ref = _jax_analysis_vjp(jnp.asarray(y2[i].numpy()), jx["csw"], jx["cswt"],
                                jnp.asarray(th["g_cs"][i].numpy()))
        assert _rel_err(gy2[i], ref) <= 1e-4


@pytest.mark.parametrize("t", FRAMES)
def test_edge_corrections_match_jax(t):
    jx, th = _data(t)
    y2 = rt.synth_norm_fwd_plain(th["ct"], th["csin"], th["yconst"], th["env"], th["ab"])[0]
    csw = th["csw"].float()
    slabs = [csw[k * HOP : (k + 1) * HOP] for k in range(4)]
    ours = rt.edge_corrections(y2.reshape(B, -1), slabs, 4 * HOP, HOP, t)
    for i in range(B):
        ref = jrt.edge_corrections(jnp.asarray(y2[i].reshape(-1).numpy()),
                                   [jnp.asarray(s.numpy()) for s in slabs], 4 * HOP, HOP, t)
        assert _rel_err(ours[i], ref) <= 1e-5


@pytest.mark.parametrize("t", FRAMES)
def test_synth_function_gradient_matches_plain_autograd(t):
    jx, th = _data(t)
    ct = th["ct"].clone().requires_grad_(True)
    y2 = rt.synth_norm(ct, th["csin"], th["yconst"], th["env"], th["ab"], th["abt"])
    (g_fn,) = torch.autograd.grad((y2 * th["g_y2"]).sum(), ct)
    ct2 = th["ct"].clone().requires_grad_(True)
    y2p, _ = rt.synth_norm_fwd_plain(ct2, th["csin"], th["yconst"], th["env"], th["ab"])
    (g_ad,) = torch.autograd.grad((y2p * th["g_y2"]).sum(), ct2)
    assert torch.equal(y2.detach(), y2p.detach())
    assert _rel_err(g_fn, g_ad) <= 2e-2


@pytest.mark.parametrize("t", FRAMES)
def test_analysis_function_gradient_matches_plain_autograd(t):
    _, th = _data(t)
    y2 = th["yconst"].clone().requires_grad_(True)
    cs2 = rt.band_analysis(y2, th["csw"], th["cswt"])
    (g_fn,) = torch.autograd.grad((cs2 * th["g_cs"]).sum(), y2)
    y2p = th["yconst"].clone().requires_grad_(True)
    (g_ad,) = torch.autograd.grad((rt.band_analysis_fwd_plain(y2p, th["csw"]) * th["g_cs"]).sum(), y2p)
    assert _rel_err(g_fn, g_ad) <= 2e-2


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    _, th = _data(8)
    rt.reset_launches()
    y2, m1 = rt.synth_norm_fwd(th["ct"], th["csin"], th["yconst"], th["env"], th["ab"])
    y2p, m1p = rt.synth_norm_fwd_plain(th["ct"], th["csin"], th["yconst"], th["env"], th["ab"])
    assert torch.equal(y2, y2p) and torch.equal(m1, m1p)
    assert torch.equal(rt.band_analysis_fwd(y2, th["csw"]), rt.band_analysis_fwd_plain(y2, th["csw"]))
    assert torch.equal(
        rt.synth_norm_bwd(th["g_y2"], y2, m1, th["csin"], th["env"], th["abt"]),
        rt.synth_norm_bwd_plain(th["g_y2"], y2, m1, th["csin"], th["env"], th["abt"]),
    )
    assert torch.equal(rt.band_analysis_bwd(th["g_cs"], th["cswt"]),
                       rt.band_analysis_bwd_plain(th["g_cs"], th["cswt"]))
    assert [k.launches for k in rt.KERNELS] == [0, 0, 0, 0]


def test_tie_split_subgradient_spreads_over_equal_maxima():
    """Two samples tie at the peak: the peak-norm's VJP splits the max
    term between them, as JAX's autodiff of max does."""
    jx, th = _data(8)
    y2 = torch.zeros(1, 7, HOP)
    y2[0, 1, 3], y2[0, 4, 9] = 1.0, -1.0
    m1 = torch.ones(1)
    g = torch.ones(1, 7, HOP)
    ours = rt.synth_norm_bwd_plain(g, y2, m1, th["csin"][:1], th["env"], th["abt"])

    def jax_bwd(gg):
        return jrt._synth_bwd((jnp.asarray(y2[0].numpy()), jnp.ones((1, 1)),
                               jx["csin"][0], jx["env"], jx["abt"]), gg)[0]

    ref = jax_bwd(jnp.asarray(g[0].numpy()))
    assert _rel_err(ours[0], ref) <= 1e-4


@pytest.mark.parametrize("bad", [dict(p=250), dict(hop=96), dict(n_fft=2048)])
def test_kernel_geometry_is_checked(bad):
    args = dict(p=256, hop=256, n_fft=1024) | bad
    with pytest.raises(ValueError):
        rt._check_geometry(args["p"], args["hop"], args["n_fft"])
