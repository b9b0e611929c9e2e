"""The sm90 whole-step chain's scheme (csrc/iteration_sm90.cu) against the JAX package.

The chain that runs ``iteration_step`` on the card cannot run here, so
this file walks its decomposition in torch on the CPU (``step_walk``):
the A operand of every product materialized as the chain writes it (reim
= ct csin and the reflect-padded y2 and gcrop in float32; |cs|, the pool's
input, leaky(yhat), dh and the mel VJP's operand in bf16), each product on
its planned tiles with the chain's two-level sums (the tensor cores sum
one depth chunk from zero: 4 slabs x 32 deep, or 64 deep for the dense
products; float32 adds carry the chunks), and the per-clip reductions
finished from per-chunk partial sums in chunk order.  The walk is held
against ``aware_tpu.ops.pallas.iteration.iteration_step`` in interpret
mode, on two speech-like clips of 40 and of 9 frames, under the
tolerances of tests/test_torch_kernels_iteration.py: the loss within
3e-4 relative; pred within 1e-3 absolute of the JAX forward's; the
step's gradient (the JAX kernel's own, read back from its first moment
at t = 1) to relative L2 0.2 and 1 - cosine 0.02 from 32 frames, to
agreement.SHORT_CHAIN_TOL below.  The walk's state update is held to
the port's plain epilogue given the walk's own gradient (the same
operations: exactly).

The Python half of the chain is tested as it is: the dense planner's grid
covers every output once and gives each of the step's dense products at
B = 8, T = 626 the most blocks it can, the step's GEMM list is in the
chain's order, and the checks reject what the tensor maps cannot take.
The kernels themselves run only on the card: chip_smoke.py and
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aware_tpu_torch.ops.kernels import agreement as ag
from aware_tpu_torch.ops.kernels import detector as td
from aware_tpu_torch.ops.kernels import iteration as it
from aware_tpu_torch.ops.kernels.detector import DetResiduals
from aware_tpu_torch.ops.kernels import roundtrip as rt
from test_torch_kernels_iteration import B1, B2, EPS, HI, LO, _jax_fwd, _jax_step, _problem
from test_torch_kernels_iteration import _scalars, _spread

SLABS, CH = 4, (128, 512, 1024, 1024, 128)
IN_EPS, GS_EPS = 1e-5, 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return x.to(torch.bfloat16).float()


# --------------------------------------------------------- the products ---

def slab_walk(a, w, n_out, e, k_row, k_col, direction, pad, plan):
    """slab_gemm_sm90: a (B, N, D) f32 -> (B, n_out, e); per tile and depth
    chunk of 32, one bf16 window read by the four slabs, the chunk's four
    products summed from zero, then added to the tile's float32 sums."""
    batch, n, d = a.shape
    first = -pad if direction > 0 else pad - (SLABS - 1)
    offsets = [direction * (k - pad) - first for k in range(SLABS)]
    rows = plan.bm + SLABS - 1
    out = torch.full((batch, n_out, e), float("nan"))
    for t0 in range(0, n_out, plan.bm):
        src = torch.arange(t0 + first, t0 + first + rows)
        inside = (src >= 0) & (src < n)
        for n0 in range(0, e, plan.bn):
            acc = torch.zeros(batch, plan.bm, plan.bn)
            for c0 in range(0, d, rt.SLAB_DEPTH):
                win = torch.zeros(batch, rows, rt.SLAB_DEPTH)
                win[:, inside] = a[:, src[inside], c0 : c0 + rt.SLAB_DEPTH]
                win = _bf16(win)
                part = sum(win[:, off : off + plan.bm]
                           @ w[k * k_row + c0 : k * k_row + c0 + rt.SLAB_DEPTH,
                               k * k_col + n0 : k * k_col + n0 + plan.bn]
                           for k, off in enumerate(offsets))
                acc = acc + part
            keep = min(plan.bm, n_out - t0)
            out[:, t0 : t0 + keep, n0 : n0 + plan.bn] = acc[:, :keep]
    return out


def dense_walk(a, w, plan):
    """dense_gemm_sm90: a (M, K) bf16-valued, w (K, N) -> (M, N); per tile
    and depth chunk of 64, the chunk's product from zero, then added."""
    m, k = a.shape
    n = w.shape[1]
    out = torch.full((m, n), float("nan"))
    for m0 in range(0, m, plan.bm):
        for n0 in range(0, n, plan.bn):
            acc = torch.zeros(min(plan.bm, m - m0), plan.bn)
            for c0 in range(0, k, rt.DENSE_DEPTH):
                acc = acc + (a[m0 : m0 + plan.bm, c0 : c0 + rt.DENSE_DEPTH]
                             @ w[c0 : c0 + rt.DENSE_DEPTH, n0 : n0 + plan.bn])
            out[m0 : m0 + plan.bm, n0 : n0 + plan.bn] = acc
    return out


def chunk_sum(x, dim, size):
    """A sum over ``dim`` from partial sums of ``size`` consecutive entries,
    added in chunk order (the chain's per-(chunk, clip) blocks)."""
    parts = torch.split(x, size, dim=dim)
    total = parts[0].sum(dim=dim)
    for q in parts[1:]:
        total = total + q.sum(dim=dim)
    return total


# -------------------------------------------------------------- the walk ---

def step_plans(b, t, p, hop, sms=132):
    """The planned tile of each of the step's GEMMs, by name."""
    return dict(zip((g.name for g in it.step_gemms(b, t, p, hop)),
                    it.plan_step(b, t, p, hop, sms)))


def fwd_walk(ct, c, plans):
    """The chain's forward half: ct (B, T, P) -> (pred (B, 128),
    IterResiduals), the residuals in the dtypes the chain writes them."""
    b, t, p = ct.shape
    hop = c.env.shape[-1]
    lr, t2 = t - 1, t // 2
    d = c.det
    # the round trip forward: reim, the synthesis, the reflect-padded y2, the analysis
    cs_in = c.csin.float()
    reim = torch.cat([ct * cs_in[..., :p], ct * cs_in[..., p:]], dim=-1)
    u = slab_walk(reim, c.ab.float(), lr, hop, 0, hop, -1, 2, plans["synthesis"]) / c.env
    u = u + c.y_const
    m1 = u.abs().amax(dim=(1, 2))
    y2 = (u / rt.peak_den(m1)).reshape(b, -1)
    n = y2.shape[1]
    f = torch.arange(-2 * hop, n + 2 * hop)
    f = torch.where(f < 0, -f, torch.where(f >= n, 2 * (n - 1) - f, f))
    ypad = y2[:, f].reshape(b, t + 3, hop)
    cs = slab_walk(ypad, c.csw.float(), t, 2 * p, hop, 0, +1, 0, plans["reflect analysis"])
    # the detector forward, each product's A materialized in bf16
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
    det = DetResiduals(pred, nph.to(torch.bfloat16), mel.to(torch.bfloat16), *ys, mu1, r1,
                       *rins, gmu, gr, sd)
    return pred, it.IterResiduals(det, u, m1)


def det_bwd_walk(dpred, det, d, plans):
    """The chain's detector VJP (det_bwd_sm90) from dpred (B, 128) and the
    detector's residuals alone -> dcs (B, T, 2P)."""
    b, t, p2 = det.nph.shape
    p, t2 = p2 // 2, t // 2
    pred = det.pred
    dx = ((dpred * (1 - pred * pred)) @ d.eot / t2)[:, None, :].expand(b, t2, CH[4])
    for i in range(3, -1, -1):
        y = getattr(det, f"y{i}").float()
        du = dx * torch.where(y >= 0, 1.0, 0.2)
        g1, g2 = du.mean(dim=1, keepdim=True), (du * y).mean(dim=1, keepdim=True)
        dh = _bf16(getattr(det, f"rin{i}")[:, None] * (du - g1 - y * g2))
        dx = dense_walk(dh.reshape(b * t2, CH[i + 1]), getattr(d, f"w{i}").float(),
                        plans[f"conv {i} VJP"]).reshape(b, t2, CH[i])
    rc, _ = td.mel_chunks(t)
    n_el = t * CH[0]
    mu1, r1, gmu, gr, sd = det.mu1, det.r1, det.gmu, det.gr, det.s
    db = torch.zeros(b, t, CH[0])
    db[:, : 2 * t2] = 0.5 * dx.repeat_interleave(2, dim=1)
    a = (det.mel.float() - mu1[:, None]) * r1[:, None]
    bs = (a - gmu[:, None, None]) * gr[:, None, None]
    mean_db = chunk_sum(db.sum(dim=2), 1, rc) / n_el
    coef = chunk_sum((db * bs).sum(dim=2), 1, rc) / (sd * (n_el - 1))
    da = gr[:, None, None] * (db - mean_db[:, None, None]) - bs * coef[:, None, None]
    g1 = chunk_sum(da, 1, rc) / t
    g2 = chunk_sum(da * a, 1, rc) / t
    dmel = _bf16(r1[:, None] * (da - g1[:, None] - a * g2[:, None]))
    dm = dense_walk(dmel.reshape(b * t, CH[0]), d.melbt.float(), plans["mel VJP"])
    return dm.reshape(b, t, p).repeat(1, 1, 2) * det.nph.float()


def reflect_bwd_walk(dcs, cswt, plan):
    """The reflect analysis VJP (the slab GEMM over the lr + 4 padded rows,
    the pad rows' cotangents rounded to bf16) and the fold of the pad rows
    into the samples they reflect: dcs (B, T, 2P) -> gy2 (B, T-1, hop)."""
    b, t, _ = dcs.shape
    hop = cswt.shape[1] // SLABS
    lr = t - 1
    gp = slab_walk(dcs, cswt.float(), t + 3, hop, 0, hop, -1, 0, plan)
    gy2 = gp[:, 2 : 2 + lr].reshape(b, -1).clone()
    gpad = _bf16(torch.cat([gp[:, :2], gp[:, lr + 2 :]], dim=1)).reshape(b, -1)
    half = 2 * hop
    e = torch.arange(2 * half)
    n = lr * hop
    gy2[:, torch.where(e < half, half - e, n - 2 - (e - half))] += gpad
    return gy2.reshape(b, lr, hop)


def bwd_walk(dpred, res, c, plans):
    """The chain's backward half from dpred (B, 128) and the forward's
    residuals alone -> the gradient on ct (B, T, P): the phase fold of the
    dreim it leaves."""
    det = res.det
    b, t, p2 = det.nph.shape
    hop = c.env.shape[-1]
    lr = t - 1
    dcs = det_bwd_walk(dpred, det, c.det, plans)
    # the round trip backward: the analysis VJP and the reflect fold, gcrop,
    # the synthesis VJP
    gy2 = reflect_bwd_walk(dcs, c.cswt, plans["reflect analysis VJP"]).reshape(b, -1)
    m1 = res.m1
    cden = rt.peak_den(m1)[:, 0, 0]
    yv = (res.u / rt.peak_den(m1)).reshape(b, -1)
    q = chunk_sum(gy2 * yv, 1, it.FOLD_CHUNK)
    mx = yv.abs().amax(dim=1)
    ties = (yv.abs() == mx[:, None]).float().sum(dim=1)
    mask = (yv.abs() == mx[:, None]).float()
    gu = gy2 / cden[:, None] - (q * (1.0 + 1e-8) / cden)[:, None] * torch.sign(yv) * mask / ties[:, None]
    gcrop = gu.reshape(b, lr, hop) / c.env
    dreim = slab_walk(gcrop, c.abt.float(), t, p2, hop, 0, +1, 2, plans["synthesis VJP"])
    return rt.phase_fold_plain(dreim, c.csin)


def step_walk(ct, m, v, best, best_loss, lower, upper, wm, s1, s2, d2, c, k, sms=132):
    """One step of the sm90 chain, in place on ct, m, v, best and
    best_loss; returns (loss, pred, the step's gradient on ct)."""
    b, t, p = ct.shape
    plans = step_plans(b, t, p, c.env.shape[-1], sms)
    pred, res = fwd_walk(ct, c, plans)
    loss, dpred = it.push_extremes_grad(pred, wm)
    g = bwd_walk(dpred, res, c, plans)
    it.step_epilogue_plain(g, ct, m, v, best, best_loss, lower, upper, loss, s1, s2, d2, k)
    return loss, pred, g


@pytest.fixture(scope="module")
def problems():
    return {t: _problem(t) for t in (40, 9)}


@pytest.mark.parametrize("t", [40, 9])
def test_step_walk_matches_jax(problems, t):
    pb, jcs, wm = problems[t]
    k = it.nadam_coefs((B1, B2), EPS)
    lr = torch.tensor([0.1, 0.05])
    _, _, s1, s2, d2 = _scalars(torch.zeros(()), torch.ones(()), lr)
    wm_pad = torch.zeros(2, 128)
    wm_pad[:, :20] = torch.from_numpy(wm)
    state = [pb.ct0.clone(), torch.zeros_like(pb.ct0), torch.zeros_like(pb.ct0),
             pb.ct0.clone(), torch.full((2,), float("inf"))]
    before = [x.clone() for x in state]
    loss, pred, g = step_walk(*state, pb.lower, pb.upper, wm_pad, s1, s2, d2, pb.iteration, k)
    assert torch.all(torch.isfinite(g)) and torch.all(g[..., HI - LO :] == 0)
    for i in range(2):
        ct = jnp.asarray(pb.ct0[i].numpy())
        np.testing.assert_allclose(pred[i].numpy(), np.asarray(_jax_fwd(ct, jcs[i])[0])[0],
                                   rtol=0, atol=1e-3)
        z = jnp.zeros_like(ct)
        out = _jax_step(ct, z, z, ct, jnp.asarray(wm_pad[i : i + 1].numpy()),
                        jnp.asarray(pb.lower[i].numpy()), jnp.asarray(pb.upper[i].numpy()),
                        jnp.full((1, 1), float(s1[i])), jnp.full((1, 1), float(s2[i])),
                        jnp.full((1, 1), float(d2[0])), jnp.full((1, 1), jnp.inf), jcs[i])
        ref = float(out[0][0, 0])
        assert abs(float(loss[i]) - ref) <= 3e-4 * abs(ref), (float(loss[i]), ref)
        g_ref = np.asarray(out[2], np.float64) / k.c_m  # m_prev = 0 at t = 1
        if t >= ag.SHORT_FRAMES:
            dl, dcos = _spread(g[i].numpy(), g_ref)
            assert dl <= 0.2 and dcos <= 0.02, (dl, dcos)
        else:
            r = ag.vjp_report(g[i], torch.from_numpy(g_ref.astype(np.float32)))
            assert all(r[key] <= tol for key, tol in ag.SHORT_CHAIN_TOL.items()), r
    # the walk's state update is the plain epilogue given its own gradient
    it.step_epilogue_plain(g, *before, pb.lower, pb.upper, loss, s1, s2, d2, k)
    assert all(torch.equal(a, b) for a, b in zip(state, before))


def test_step_gemms_are_the_chains_fourteen_in_order():
    gs = it.step_gemms(8, 626, 256, 256)
    assert [g.name for g in gs] == [
        "synthesis", "reflect analysis", "mel", "conv 0", "conv 1", "conv 2", "conv 3",
        "conv 3 VJP", "conv 2 VJP", "conv 1 VJP", "conv 0 VJP", "mel VJP",
        "reflect analysis VJP", "synthesis VJP"]
    flops = sum(2 * (8 if g.kind == "slab" else 1) * g.rows * g.k * g.n
                * (SLABS if g.kind == "slab" else 1) for g in gs)
    assert abs(flops / 1e9 - 39.41) < 0.01  # the step's 39.4 GFLOP
    tiles = it.step_tiles(8, 626, 256, 256, 132)
    assert list(tiles)[:4] == [64, 128, 128, 128]  # 160 blocks each


DENSE = [(g.rows, g.k, g.n) for g in it.step_gemms(8, 626, 256, 256) if g.kind == "dense"]


@pytest.mark.parametrize("m, k, n", DENSE + [(7, 128, 64), (2 * 4, 512, 1024), (1, 64, 128)])
def test_dense_plan_covers_every_output_once(m, k, n):
    plan = rt.plan_dense_gemm(m, n)
    cols, tiles, one = plan.grid
    assert one == 1 and cols * plan.bn == n
    hits = torch.zeros(m, n, dtype=torch.int32)
    for y in range(tiles):
        rows = range(y * plan.bm, min((y + 1) * plan.bm, m))
        assert len(rows) > 0  # no block without an output row
        for x in range(cols):
            hits[rows.start : rows.stop, x * plan.bn : (x + 1) * plan.bn] += 1
    assert torch.all(hits == 1)


@pytest.mark.parametrize("m, k, n", DENSE)
def test_dense_plan_fills_the_card_at_the_steps_shapes(m, k, n):
    """A block for every one of the 132 SMs where a tile gives one (the
    largest such tile), else the most blocks any tile gives: the 128-wide
    products over 2504 rows get 80 blocks of 64 x 64."""
    plan = rt.plan_dense_gemm(m, n)
    most = max(-(-m // bm) * (n // bn) for bm, bn in rt.SLAB_TILES if n % bn == 0)
    if most >= rt.H100_SMS:
        assert plan.blocks >= rt.H100_SMS
        bigger = [(bm, bn) for bm, bn in rt.SLAB_TILES
                  if bm * bn > plan.bm * plan.bn and -(-m // bm) * (n // bn) >= rt.H100_SMS]
        assert not bigger
    else:
        assert plan.blocks == most
    assert {(2504, 128): 80, (2504, 512): 160, (2504, 1024): 160, (5008, 128): 158,
            (5008, 256): 158}[(m, n)] == plan.blocks


def _misaligned(*shape, dtype=torch.bfloat16):
    """A contiguous tensor 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(*shape)


@pytest.mark.parametrize("case", ["depth", "width", "a_address", "b_address", "rows",
                                  "a_room", "dtype"])
def test_dense_checks_reject_what_the_kernel_cannot_take(case):
    m, k, n = 40, 128, 64
    a = torch.zeros(m, k, dtype=torch.bfloat16)
    b = torch.zeros(k, n, dtype=torch.bfloat16)
    rt.check_dense_gemm(a, b, m, k, n)  # what it takes
    if case == "depth":  # K % 64
        k, a, b = 96, torch.zeros(m, 96, dtype=torch.bfloat16), torch.zeros(96, n, dtype=torch.bfloat16)
    elif case == "width":  # N % 64
        n, b = 96, torch.zeros(k, 96, dtype=torch.bfloat16)
    elif case == "a_address":  # TMA's 16-byte address alignment
        a = _misaligned(m, k)
    elif case == "b_address":
        b = _misaligned(k, n)
    elif case == "rows":
        m = 0
    elif case == "a_room":  # the A buffer holds fewer than M x K values
        m = 41
    else:
        a = torch.zeros(m, k)
    with pytest.raises((ValueError, TypeError)):
        rt.check_dense_gemm(a, b, m, k, n)
