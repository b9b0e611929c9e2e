"""The ola_normalize cluster variant (csrc/ola_norm.cu ``aw_ola_fwd_cluster``,
``aw_ola_bwd_cluster``) walked on the CPU, and the plan that picks it.

Neither kernel can run here, so this file walks each in numpy float32 as
the kernel computes it (``fwd_walk``, ``bwd_walk``): the clip's rows split
among the cluster's CTAs by ``ola_plan``, each CTA's partials taken in the
kernel's order (a thread's float4s in order, x y z w, then the block's xor
butterfly over 32 lanes and over the warps), and the partials combined in
rank order, the VJP's grows rows written by the CTA that owns them.  Every
float operation rounds to float32 once, as the kernel's _rn intrinsics do.
The walks are held:

* the forward against ``ola_normalize_fwd_plain`` bit for bit (the same
  adds in the same order, the same division; a max is exact in any
  order), and against the JAX kernel (``_ola_fwd_impl``, Pallas interpret
  mode) to the JAX suite's atol/rtol 1e-6 (tests/test_pallas.py:43);
* the VJP against JAX's VJP of ``ola_normalize`` and against the plain
  version to the JAX suite's atol 1e-5 / rtol 1e-4 (tests/test_pallas.py:
  65-67: q = sum g * y2 runs in another order);

at 8, 63, 64 and 626 frames, B = 2, at each cluster size; also with ties
of opposite sign in different CTAs (each takes K / 2 of the peak-norm's
gradient, so a tie count that misses a CTA moves it) and a silent lane
(m1 = 0, a finite gradient).  The plan's rows and grows rows cover the
clip once each, its shared memory stays within the card's 232,448 bytes,
and it takes the cluster variant up to the largest clip that fits and the
stream variant past it.  The wrappers refuse what the kernels cannot take
before any launch (driven on meta tensors, the launch replaced by a
recorder).  The kernels themselves run only on the card: chip_smoke.py
and tests/test_torch_gpu.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.ops.pallas.ola_norm import _env_rows, _ola_fwd_impl, ola_normalize
from aware_tpu.ops.windows import get_window
from aware_tpu_torch.ops.kernels import ola_norm as on

N_FFT, HOP, B = 1024, 256, 2
WKEY = tuple(get_window("hann", N_FFT).tolist())
FWD = {"atol": 1e-6, "rtol": 1e-6}
VJP = {"atol": 1e-5, "rtol": 1e-4}
FRAMES = (8, 63, 64, 626)
EPS = np.float32(1e-8)
F32 = np.float32


# -------------------------------------------------------------- the walks ---

def _scale(m1):
    """(c, n) of the collapsed double peak-norm, as the kernel's peak_scale."""
    c1 = F32(m1 + EPS)
    n = F32(m1 / c1)
    return F32(c1 * F32(n + EPS)), n


def _butterfly(v):
    """The kernel's block_reduce of a sum: an xor butterfly over each
    warp's 32 lanes, then over the warps' lane-0 values (padded with 0)."""
    lanes = np.arange(32)
    w = v.reshape(-1, 32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[:, lanes ^ o]
    top = np.zeros(32, F32)
    top[: w.shape[0]] = w[:, 0]
    for o in (16, 8, 4, 2, 1):
        top = top + top[lanes ^ o]
    return top[0]


def block_sum(values, threads=on.CLUSTER_THREADS):
    """A CTA's partial sum of ``values`` (its float4s, (n4, 4) float32):
    thread e % threads adds its float4s in order, lane by lane, from 0,
    then the butterfly.  A thread past the CTA's last float4 adds none; the
    0.0 it is padded with here changes no sum (one that starts at +0 is
    never -0)."""
    n4 = values.shape[0]
    passes = -(-n4 // threads)
    pad = np.zeros((passes * threads, 4), F32)
    pad[:n4] = values
    pad = pad.reshape(passes, threads, 4)
    s = np.zeros(threads, F32)
    for p in range(passes):
        for lane in range(4):
            s = s + pad[p, :, lane]
    return _butterfly(s)


def _abs_max(x):
    return F32(np.abs(x).max()) if x.size else F32(0.0)


def fwd_walk(wf, env, plan):
    """aw_ola_fwd_cluster: each CTA forms its rows of acc from the frame
    slices in k = 0..3 order from 0, divides by env and takes its max
    |y_env|; the maxima combined in rank order give m1, and each CTA
    scales its rows -> (y2, m1)."""
    b, t, _ = wf.shape
    lr = t - 1
    y2 = np.empty((b, lr, HOP), F32)
    m1 = np.empty(b, F32)
    for clip in range(b):
        y_env, parts = [], []
        for r0, r1 in plan.rows:
            js = np.arange(r0, r1)
            acc = np.zeros((r1 - r0, HOP), F32)
            for k in range(on.R):
                f = js + on.PAD - k
                ok = (f >= 0) & (f < t)
                acc[ok] = acc[ok] + wf[clip, f[ok], k * HOP : (k + 1) * HOP]
            y_env.append(acc / env[r0:r1])
            parts.append(_abs_max(y_env[-1]))
        m = F32(0.0)
        for p in parts:  # rank order
            m = max(m, p)
        c, _ = _scale(m)
        for (r0, r1), ye in zip(plan.rows, y_env):
            y2[clip, r0:r1] = ye / c
        m1[clip] = m
    return y2, m1


def bwd_walk(g, y2, env, m1, plan):
    """aw_ola_bwd_cluster: each CTA writes its grows rows as if no element
    were a tie, g / c / env, while it takes its partial q = sum g * y2
    (block_sum) and max |y2|; the partials combined in rank order, each
    CTA's tie count summed in rank order; then each float4 that holds a
    tie written again, every lane by the stream variant's expressions ->
    (dwf, q, ties per clip)."""
    b, lr, _ = g.shape
    t = lr + 1
    dwf = np.empty((b, t, on.R * HOP), F32)
    qs, counts = [], []
    for clip in range(b):
        pm, pq = [], []
        for r0, r1 in plan.rows:
            gv, yv = g[clip, r0:r1].reshape(-1, 4), y2[clip, r0:r1].reshape(-1, 4)
            pq.append(block_sum(gv * yv))
            pm.append(_abs_max(yv))
        m2b, q = F32(0.0), F32(0.0)
        for m, s in zip(pm, pq):  # rank order
            m2b, q = max(m2b, m), F32(q + s)
        ties = sum(int((np.abs(y2[clip, r0:r1]) == m2b).sum()) for r0, r1 in plan.rows)
        c, n = _scale(m1[clip])
        p = F32(F32(n + EPS) * q)
        kc = F32(F32(p * F32(EPS + c)) / F32(c * c))
        grows = np.full((t + on.R - 1, HOP), np.nan, F32)
        for (r0, r1), (g0, g1) in zip(plan.rows, plan.grows):
            assert np.isnan(grows[g0:g1]).all()  # each grows row written once
            grows[g0:g1] = 0.0
            yv, gv = y2[clip, r0:r1], g[clip, r0:r1]
            mask = np.abs(yv) == m2b
            tie = (kc * np.sign(yv)) * mask.astype(F32) / F32(ties)
            quad = mask.reshape(-1, 4).any(axis=1).repeat(4).reshape(mask.shape)
            grows[r0 + on.PAD : r1 + on.PAD] = np.where(
                quad, (gv / c - tie) / env[r0:r1], gv / c / env[r0:r1])
        assert not np.isnan(grows).any()
        for k in range(on.R):
            dwf[clip, :, k * HOP : (k + 1) * HOP] = grows[k : k + t]
        qs.append(q)
        counts.append(ties)
    return dwf, qs, counts


# ------------------------------------------------------------------- data ---

def _frames(t, batch=B, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, t, N_FFT)).astype(F32)


def _cotangent(t, batch=B, seed=3):
    return np.random.default_rng(seed).standard_normal((batch, t - 1, HOP)).astype(F32)


@functools.lru_cache(maxsize=None)
def _env(t):
    return _env_rows(WKEY, N_FFT, HOP, t)


def _jax(wf, g):
    """JAX's y2 rows, m1 and VJP of the cotangent rows g."""
    b = wf.shape[0]
    _, (rows, m1) = _ola_fwd_impl(jnp.asarray(wf), N_FFT, HOP, WKEY)
    _, vjp = jax.vjp(lambda x: ola_normalize(x, N_FFT, HOP, WKEY), jnp.asarray(wf))
    (dwf,) = vjp(jnp.asarray(g.reshape(b, -1)))
    return np.asarray(rows), np.asarray(m1)[:, 0], np.asarray(dwf)


@functools.lru_cache(maxsize=None)
def _case(t):
    wf, g = _frames(t, seed=t), _cotangent(t, seed=t + 1)
    return wf, g, _jax(wf, g)


def _plain(wf, g):
    env = torch.from_numpy(_env(wf.shape[1]))
    y2, m1 = on.ola_normalize_fwd_plain(torch.from_numpy(wf), env)
    dwf = on.ola_normalize_bwd_plain(torch.from_numpy(g), y2, env, m1)
    return y2.numpy(), m1.numpy(), dwf.numpy()


# ------------------------------------------------- against the JAX package ---

@pytest.mark.parametrize("cluster", on.CLUSTER_SIZES)
@pytest.mark.parametrize("t", FRAMES)
def test_fwd_walk_is_the_plain_forward_and_matches_jax(t, cluster):
    wf, g, (jy2, jm1, _) = _case(t)
    y2, m1 = fwd_walk(wf, _env(t), on.ola_plan(B, t, HOP, cluster))
    py2, pm1, _ = _plain(wf, g)
    np.testing.assert_array_equal(y2, py2)
    np.testing.assert_array_equal(m1, pm1)
    np.testing.assert_allclose(y2, jy2, **FWD)
    np.testing.assert_allclose(m1, jm1, **FWD)


@pytest.mark.parametrize("cluster", on.CLUSTER_SIZES)
@pytest.mark.parametrize("t", FRAMES)
def test_bwd_walk_matches_jax_and_the_plain_vjp(t, cluster):
    wf, g, (jy2, jm1, jdwf) = _case(t)
    env = _env(t)
    y2, m1 = fwd_walk(wf, env, on.ola_plan(B, t, HOP, cluster))
    dwf, _, ties = bwd_walk(g, y2, env, m1, on.ola_plan(B, t, HOP, cluster))
    _, _, pdwf = _plain(wf, g)
    assert dwf.shape == wf.shape and ties == [1, 1]
    np.testing.assert_allclose(dwf, jdwf, **VJP)
    np.testing.assert_allclose(dwf, pdwf, **VJP)


def _tied_frames(t=63):
    """Frames whose y_env peaks at +50 (row 19) and -50 (row 40): a spike
    in one slice of one frame, the other slices there zeroed, lands on one
    output sample with the envelope divided back in (as
    tests/test_torch_kernels_ola.py builds its ties)."""
    wf = 0.1 * _frames(t, seed=5)
    env = _env(t)
    spots = (((20, 1, 17), 1.0), ((40, 2, 17), -1.0))
    for (frame, k, col), sign in spots:
        wf[:, frame, k * HOP + col] = sign * 50.0 * env[frame + k - on.PAD, col]
        for kk in range(on.R):
            if kk != k:
                wf[:, frame + k - kk, kk * HOP + col] = 0.0
    return wf, [(frame + k - on.PAD, col, sign) for (frame, k, col), sign in spots]


@pytest.mark.parametrize("cluster", on.CLUSTER_SIZES)
def test_ties_in_two_ctas_split_the_peak_gradient(cluster):
    t = 63
    wf, spots = _tied_frames(t)
    plan = on.ola_plan(B, t, HOP, cluster)
    owners = {next(r for r, (a, z) in enumerate(plan.rows) if a <= j < z) for j, _, _ in spots}
    assert len(owners) == 2  # the ties lie in different CTAs
    env, g = _env(t), _cotangent(t)
    y2, m1 = fwd_walk(wf, env, plan)
    dwf, qs, ties = bwd_walk(g, y2, env, m1, plan)
    jy2, jm1, jdwf = _jax(wf, g)
    assert ties == [2, 2]
    np.testing.assert_allclose(y2, jy2, **FWD)
    np.testing.assert_allclose(dwf, jdwf, **VJP)
    np.testing.assert_allclose(m1, 50.0, rtol=1e-6)
    c = (m1 + 1e-8) * (m1 / (m1 + 1e-8) + 1e-8)
    q = (g.astype(np.float64) * y2).sum(axis=(1, 2))
    np.testing.assert_allclose(qs, q, rtol=1e-5)
    k_coef = (m1 / (m1 + 1e-8) + 1e-8) * q * (1e-8 + c) / (c * c)
    for row, col, sign in spots:
        g_env = dwf[:, row + on.PAD, col] * env[row, col]  # slice k = 0 holds grows row + PAD
        np.testing.assert_allclose(g[:, row, col] / c - g_env, sign * k_coef / 2, rtol=1e-4)


@pytest.mark.parametrize("cluster", on.CLUSTER_SIZES)
def test_silent_lane_has_a_finite_gradient(cluster):
    t = 63
    wf, g = _frames(t), _cotangent(t)
    wf[1] = 0.0
    env = _env(t)
    plan = on.ola_plan(B, t, HOP, cluster)
    y2, m1 = fwd_walk(wf, env, plan)
    dwf, _, ties = bwd_walk(g, y2, env, m1, plan)
    jy2, jm1, jdwf = _jax(wf, g)
    assert m1[1] == 0.0 and not y2[1].any() and ties[1] == (t - 1) * HOP
    assert np.isfinite(dwf).all()
    np.testing.assert_allclose(y2, jy2, **FWD)
    np.testing.assert_allclose(dwf, jdwf, **VJP)


# --------------------------------------------------------------- the plan ---

@pytest.mark.parametrize("cluster", on.CLUSTER_SIZES)
@pytest.mark.parametrize("t", [2, 8, 9, 17, 63, 626, 1025, 3751])
def test_plan_covers_the_clip_once(t, cluster):
    plan = on.ola_plan(B, t, HOP, cluster)
    assert plan.cluster == cluster and len(plan.rows) == len(plan.grows) == cluster
    for spans, total in ((plan.rows, t - 1), (plan.grows, t + on.R - 1)):
        assert spans[0][0] == 0 and spans[-1][1] == total
        assert all(a <= z == a2 for (a, z), (a2, _) in zip(spans, spans[1:]))
    # a CTA's grows rows are its rows, PAD on, and the edges' zero rows
    for r, ((a, z), (ga, gz)) in enumerate(zip(plan.rows, plan.grows)):
        assert ga == (0 if r == 0 else a + on.PAD)
        assert gz == (t + on.R - 1 if r == cluster - 1 else z + on.PAD)
    assert plan.smem == max(z - a for a, z in plan.rows) * HOP * 4
    assert plan.variant == (
        "cluster" if plan.smem + on.CLUSTER_STATIC <= on.SMEM_LIMIT else "stream")


@pytest.mark.parametrize("cluster", on.CLUSTER_SIZES)
@pytest.mark.parametrize("hop", [HOP, HOP // 2])
def test_plan_takes_the_cluster_up_to_its_room(cluster, hop):
    """The largest clip whose rows fit the cluster's shared memory takes
    the cluster variant, the next frame the stream variant."""
    rows = (on.SMEM_LIMIT - on.CLUSTER_STATIC) // (hop * 4)
    largest = cluster * rows + 1
    fits, past = on.ola_plan(B, largest, hop, cluster), on.ola_plan(B, largest + 1, hop, cluster)
    assert (fits.variant, past.variant) == ("cluster", "stream")
    assert fits.smem + on.CLUSTER_STATIC <= on.SMEM_LIMIT == 232448
    assert fits.smem + hop * 4 + on.CLUSTER_STATIC > on.SMEM_LIMIT


def test_plan_of_the_ola_path_and_the_long_clip():
    """10 s clips (626 frames) take the cluster variant both ways at
    every size, 60 s clips (3751) the stream variant."""
    for cluster in on.CLUSTER_SIZES:
        assert on.ola_plan(8, 626, HOP, cluster).variant == "cluster"
        assert on.ola_plan(2, 3751, HOP, cluster).variant == "stream"
    assert on.CLUSTER in on.CLUSTER_SIZES and on.ola_plan(8, 626, HOP).cluster == on.CLUSTER


# ------------------------------------------------------------ the wrappers ---

@pytest.fixture
def launches(monkeypatch):
    """The wrappers driven past their CPU branch on meta tensors: each
    launch recorded in place of running; the counters restored afterwards."""
    calls = []
    monkeypatch.setattr(on, "_run", lambda entry, device, *args: calls.append((entry, args)))
    for k in on.KERNELS:
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "variants", dict.fromkeys(on.VARIANTS, 0))
    return calls


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _misaligned(*shape):
    return torch.empty(int(np.prod(shape)) + 1, device="meta")[1:].view(*shape)


@pytest.mark.parametrize("case", [None, "long", "dtype", "n_fft", "env", "contiguity", "frames",
                                  "aligned"])
def test_fwd_wrapper_refuses_before_any_launch(launches, case):
    b, t = 3, 63
    wf, env = _meta(b, t, N_FFT), _meta(t - 1, HOP)
    if case == "long":
        t = 3751
        wf, env = _meta(2, t, N_FFT), _meta(t - 1, HOP)
    elif case == "dtype":
        wf = wf.double()
    elif case == "n_fft":  # hop divides neither n_fft nor n_fft / 2
        wf = _meta(b, t, 2 * HOP + 64)
    elif case == "env":
        env = _meta(t - 2, HOP)
    elif case == "contiguity":
        wf = _meta(t, b, N_FFT).transpose(0, 1)
    elif case == "frames":  # T = 1
        wf, env = _meta(b, 1, N_FFT), _meta(0, HOP)
    elif case == "aligned":  # the cluster variant's 16-byte loads
        wf = _misaligned(b, t, N_FFT)
    if case in (None, "long"):
        y2, m1 = on.ola_normalize_fwd(wf, env)
        variant = "stream" if case else "cluster"
        (entry, args), = launches
        assert entry == f"aw_ola_fwd_{variant}" and y2.shape == (wf.shape[0], t - 1, HOP)
        assert args[4:] == ((wf.shape[0], t, HOP, on.R, on.PAD, on.CLUSTER)
                            if variant == "cluster" else (wf.shape[0], t, HOP, on.R, on.PAD))
        assert m1.shape == (wf.shape[0],)
        assert on.ola_normalize_fwd.launches == 1
        assert on.ola_normalize_fwd.variants == {"cluster": int(not case), "stream": int(case == "long")}
        return
    with pytest.raises((ValueError, TypeError)):
        on.ola_normalize_fwd(wf, env)
    assert launches == [] and on.ola_normalize_fwd.launches == 0


@pytest.mark.parametrize("case", [None, "long", "dtype", "y2", "m1", "env", "contiguity",
                                  "frames", "aligned"])
def test_bwd_wrapper_refuses_before_any_launch(launches, case):
    b, t = 3, 63
    g, y2, env, m1 = _meta(b, t - 1, HOP), _meta(b, t - 1, HOP), _meta(t - 1, HOP), _meta(b)
    if case == "long":
        t = 3751
        g, y2, env, m1 = _meta(2, t - 1, HOP), _meta(2, t - 1, HOP), _meta(t - 1, HOP), _meta(2)
    elif case == "dtype":
        g = g.double()
    elif case == "y2":
        y2 = _meta(b, t - 1, HOP // 2)
    elif case == "m1":  # one value a clip, not (B, 1)
        m1 = _meta(b, 1)
    elif case == "env":
        env = env.double()
    elif case == "contiguity":
        y2 = _meta(t - 1, b, HOP).transpose(0, 1)
    elif case == "frames":  # T = 1
        g, y2, env = _meta(b, 0, HOP), _meta(b, 0, HOP), _meta(0, HOP)
    elif case == "aligned":
        y2 = _misaligned(b, t - 1, HOP)
    if case in (None, "long"):
        dwf = on.ola_normalize_bwd(g, y2, env, m1)
        variant = "stream" if case else "cluster"
        (entry, args), = launches
        assert entry == f"aw_ola_bwd_{variant}" and dwf.shape == (g.shape[0], t, N_FFT)
        assert args[-6 if variant == "cluster" else -5:] == (
            (g.shape[0], t, HOP, on.R, on.PAD, on.CLUSTER) if variant == "cluster"
            else (g.shape[0], t, HOP, on.R, on.PAD))
        assert on.ola_normalize_bwd.launches == 1
        assert on.ola_normalize_bwd.variants == {"cluster": int(not case), "stream": int(case == "long")}
        return
    with pytest.raises((ValueError, TypeError)):
        on.ola_normalize_bwd(g, y2, env, m1)
    assert launches == [] and on.ola_normalize_bwd.launches == 0


def test_a_variant_past_its_room_is_refused(launches):
    """The chip check's explicit variants: the cluster variant of a clip
    past the cluster's room raises before any launch."""
    t = 3751
    with pytest.raises(ValueError, match="do not fit"):
        on._ola_fwd_variant(_meta(2, t, N_FFT), _meta(t - 1, HOP), "cluster", 16)
    with pytest.raises(ValueError, match="do not fit"):
        on._ola_bwd_variant(_meta(2, t - 1, HOP), _meta(2, t - 1, HOP), _meta(t - 1, HOP),
                            _meta(2), "cluster", 8)
    assert launches == []
    on._ola_fwd_variant(_meta(2, 626, N_FFT), _meta(625, HOP), "stream", 8)
    (entry, _), = launches
    assert entry == "aw_ola_fwd_stream" and on.ola_normalize_fwd.launches == 0
