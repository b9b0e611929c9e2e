"""The synth_norm forward and VJP on the sm90 step's synthesis stages.

``aw_synth_norm_fwd`` is the step's synthesis (csrc/roundtrip_sm90.cuh
``synth_fwd_sm90``: the reim pass, then the slab GEMM with the synthesis
epilogue), then the scale of u into y2 in place; ``aw_synth_norm_bwd`` is
the step's synthesis VJP (``synth_vjp_sm90``) on y2 itself, with no
reflect fold, then the phase fold.  Neither can run here, so this file
walks each in torch on the CPU (``synth_fwd_walk``, ``synth_bwd_walk``:
reim and gcrop materialized in float32 as the stages write them, each
product on its planned tile with the chain's two-level sums by
``slab_walk``, the peak-norm VJP's q from per-chunk partial sums added in
chunk order), and holds them:

* against ``aware_tpu.ops.pallas.roundtrip`` (Pallas interpret mode) at
  8, 33 and 64 frames, B = 2, under the tolerances of
  tests/test_torch_kernels_roundtrip.py: the forward within 1e-5 of
  max|ref| (the same bf16 operands, float32 sums in another order), the
  VJP within 1e-4 (as the forward, plus the rare bf16 rounding flip of a
  gcrop value whose float32 differs in its last bit), also on clips with
  several equal maxima of both signs (the equal-tie split);
* against the step's own walks (tests/test_torch_kernels_step_sm90.py):
  the forward walk gives ``fwd_walk``'s u, m1 and y2 bit for bit, and the
  VJP walk, from the step's folded cotangent and y2 = u / cden, gives
  ``bwd_walk``'s gradient bit for bit: the same stages.

The Python half is tested as it is: the two GEMMs and their tiles are the
step's (``gSynth``, ``gSynthVjp``), and the wrappers refuse bad shapes,
dtypes, frames, misaligned weights and a VJP past its partial sums' room
before any launch (driven on meta tensors, the launch replaced by a
recorder).  The kernels themselves run only on the card: chip_smoke.py
and tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aware_tpu.ops.pallas import roundtrip as jrt
from aware_tpu_torch.ops.kernels import iteration as it
from aware_tpu_torch.ops.kernels import roundtrip as rt
from test_torch_kernels_iteration import _problem
from test_torch_kernels_roundtrip import B, FRAMES, HOP, _data, _jax_synth_impl, _jax_synth_vjp
from test_torch_kernels_roundtrip import _rel_err
from test_torch_kernels_step_sm90 import (
    bwd_walk,
    chunk_sum,
    det_bwd_walk,
    fwd_walk,
    reflect_bwd_walk,
    slab_walk,
    step_plans,
)

P = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- the walks ---

def _plan(gemm, b, sms=132):
    return rt.plan_gemms([gemm], b, sms)[0]


def synth_fwd_walk(ct, csin, y_const, env, ab, plan):
    """aw_synth_norm_fwd: reim = ct csin in float32, the slab GEMM on the
    synthesis tile, its epilogue u = acc / env + y_const and m1 = max |u|,
    then y2 = u / peak_den(m1) -> (y2, m1, u)."""
    _, t, p = ct.shape
    hop = env.shape[-1]
    cs = csin.float()
    reim = torch.cat([ct * cs[..., :p], ct * cs[..., p:]], dim=-1)
    u = slab_walk(reim, ab.float(), t - 1, hop, 0, hop, -1, 2, plan) / env
    u = u + y_const
    m1 = u.abs().amax(dim=(1, 2))
    return u / rt.peak_den(m1), m1, u


def synth_bwd_walk(g, y2, m1, csin, env, abt, plan):
    """aw_synth_norm_bwd from the cotangent g of y2 (B, T-1, hop), the
    forward's y2 and m1: q = sum g y2 from per-chunk partial sums in chunk
    order, max |y2| and its ties, gcrop = the peak-norm VJP / env in
    float32, the slab GEMM on the synthesis-VJP tile, the phase fold ->
    dcoeffs (B, T, P)."""
    b, lr, hop = g.shape
    t, p2 = lr + 1, abt.shape[1]
    gf, yv = g.reshape(b, -1), y2.reshape(b, -1)
    cden = rt.peak_den(m1)[:, 0, 0]
    q = chunk_sum(gf * yv, 1, rt.FOLD_CHUNK)
    mx = yv.abs().amax(dim=1)
    mask = (yv.abs() == mx[:, None]).float()
    ties = chunk_sum(mask, 1, rt.FOLD_CHUNK)
    gu = gf / cden[:, None] - (q * (1.0 + 1e-8) / cden)[:, None] * torch.sign(yv) * mask / ties[:, None]
    gcrop = gu.reshape(b, lr, hop) / env
    dreim = slab_walk(gcrop, abt.float(), t, p2, hop, 0, +1, 2, plan)
    return rt.phase_fold_plain(dreim, csin)


def _fwd(th, t):
    return synth_fwd_walk(th["ct"], th["csin"], th["yconst"], th["env"], th["ab"],
                          _plan(rt.synth_gemm(t, P, HOP), B))


def _bwd(g, y2, m1, th, t):
    return synth_bwd_walk(g, y2, m1, th["csin"], th["env"], th["abt"],
                          _plan(rt.synth_vjp_gemm(t, P, HOP), B))


# ------------------------------------------------- against the JAX package ---

@pytest.mark.parametrize("t", FRAMES)
def test_fwd_walk_matches_jax_synth_norm(t):
    jx, th = _data(t)
    y2, m1, _ = _fwd(th, t)
    for i in range(B):
        y2_j, m1_j = _jax_synth_impl(jx["ct"][i], jx["csin"][i], jx["yconst"][i],
                                     jx["env"], jx["ab"])
        assert _rel_err(y2[i], y2_j) <= 1e-5
        assert abs(float(m1[i]) - float(m1_j[0, 0])) <= 1e-5 * float(m1_j[0, 0])


@pytest.mark.parametrize("t", FRAMES)
def test_bwd_walk_matches_jax_synth_norm_vjp(t):
    """From the JAX forward's residuals, as the JAX VJP takes them."""
    jx, th = _data(t)
    y2_j, m1_j = zip(*(_jax_synth_impl(jx["ct"][i], jx["csin"][i], jx["yconst"][i], jx["env"],
                                       jx["ab"]) for i in range(B)))
    y2 = torch.from_numpy(np.stack([np.asarray(y) for y in y2_j]))
    m1 = torch.from_numpy(np.stack([np.asarray(m).reshape(()) for m in m1_j]))
    ours = _bwd(th["g_y2"], y2, m1, th, t)
    for i in range(B):
        ref = _jax_synth_vjp(jx["ct"][i], jx["csin"][i], jx["yconst"][i], jx["env"], jx["ab"],
                             jx["abt"], jnp.asarray(th["g_y2"][i].numpy()))
        assert _rel_err(ours[i], ref) <= 1e-4


def _tied(t, m1_value):
    """A clip pair of t frames whose y2 each has four samples at its peak
    (the peak and three set to it), of both signs, in separate fold chunks
    where the clip has several, and m1 = m1_value."""
    _, th = _data(t)
    y2, _, _ = _fwd(th, t)
    flat = y2.reshape(B, -1).clone()
    n = flat.shape[1]
    peak = flat.abs().amax(dim=1)
    for b in range(B):
        for k, f in enumerate((3 + b, n // 2 + 5 * b, n - 2 - b)):
            flat[b, f] = peak[b] if k % 2 == 0 else -peak[b]
    ties = (flat.abs() == peak[:, None]).sum(dim=1)
    assert bool((ties >= 4).all()), ties
    return th, flat.reshape(y2.shape), torch.full((B,), m1_value)


@pytest.mark.parametrize("t, m1_value", [(8, 1.0), (64, 3.0)])
def test_bwd_walk_splits_equal_maxima_as_jax(t, m1_value):
    """The max term split among the equal maxima, as JAX's autodiff of
    max splits it; at 64 frames the ties lie in three of the clip's four
    fold chunks and cden is 3, far from 1."""
    th, y2, m1 = _tied(t, m1_value)
    jx, _ = _data(t)
    ours = _bwd(th["g_y2"], y2, m1, th, t)
    for i in range(B):
        ref = jrt._synth_bwd((jnp.asarray(y2[i].numpy()), jnp.full((1, 1), m1_value),
                              jx["csin"][i], jx["env"], jx["abt"]),
                             jnp.asarray(th["g_y2"][i].numpy()))[0]
        assert _rel_err(ours[i], ref) <= 1e-4


def test_tie_split_moves_the_gradient():
    """The tie probe has teeth: counting one tie instead of the four moves
    the VJP far past the tolerance above."""
    th, y2, m1 = _tied(64, 3.0)
    plan = _plan(rt.synth_vjp_gemm(64, P, HOP), B)
    ours = synth_bwd_walk(th["g_y2"], y2, m1, th["csin"], th["env"], th["abt"], plan)
    b, lr, hop = y2.shape
    yv = y2.reshape(b, -1)
    mask = (yv.abs() == yv.abs().amax(dim=1, keepdim=True)).float()
    cden = rt.peak_den(m1)[:, 0]
    q = (th["g_y2"].reshape(b, -1) * yv).sum(dim=1, keepdim=True)
    gu = th["g_y2"].reshape(b, -1) / cden - q * (1.0 + 1e-8) / cden * torch.sign(yv) * mask
    dreim = slab_walk((gu.reshape(b, lr, hop) / th["env"]), th["abt"].float(), 64, 2 * P, HOP,
                      0, +1, 2, plan)
    assert _rel_err(rt.phase_fold_plain(dreim, th["csin"]), ours) > 1e-2


# ------------------------------------------------- against the step's walks ---

@pytest.fixture(scope="module")
def problems():
    return {t: _problem(t) for t in (40, 9)}


@pytest.mark.parametrize("t", [40, 9])
def test_fwd_walk_is_the_steps_synthesis(problems, t):
    """The forward walk on the planned synthesis tile gives the step's
    forward walk's u and m1, and y2 = u / cden, bit for bit."""
    pb, _, _ = problems[t]
    c = pb.iteration
    b = pb.ct0.shape[0]
    plans = step_plans(b, t, P, HOP)
    assert _plan(rt.synth_gemm(t, P, HOP), b) == plans["synthesis"]
    y2, m1, u = synth_fwd_walk(pb.ct0, c.csin, c.y_const, c.env, c.ab, plans["synthesis"])
    _, res = fwd_walk(pb.ct0, c, plans)
    assert torch.equal(u, res.u) and torch.equal(m1, res.m1)
    assert torch.equal(y2, res.y2)


@pytest.mark.parametrize("t", [40, 9])
def test_bwd_walk_is_the_steps_synthesis_vjp(problems, t):
    """The VJP walk from the step's folded cotangent gy2 and y2 = u / cden
    gives the step's backward walk's gradient bit for bit: the step's
    round-trip VJP is the reflect analysis VJP and fold, then this."""
    pb, _, _ = problems[t]
    c = pb.iteration
    b = pb.ct0.shape[0]
    plans = step_plans(b, t, P, HOP)
    _, res = fwd_walk(pb.ct0, c, plans)
    rng = np.random.default_rng(t)
    dpred = torch.zeros(b, 128)
    dpred[:, :20] = torch.as_tensor(rng.standard_normal((b, 20)).astype(np.float32))
    gy2 = reflect_bwd_walk(det_bwd_walk(dpred, res.det, c.det, plans), c.cswt,
                           plans["reflect analysis VJP"])
    ours = synth_bwd_walk(gy2, res.y2, res.m1, c.csin, c.env, c.abt, plans["synthesis VJP"])
    assert torch.equal(ours, bwd_walk(dpred, res, c, plans))


# ------------------------------------------------------------ the plans ---

@pytest.mark.parametrize("b, t", [(8, 626), (2, 40), (2, 9), (3, 2)])
def test_synthesis_gemms_and_tiles_are_the_steps(b, t):
    """aw_synth_norm_fwd's tile is the step's gSynth, aw_synth_norm_bwd's
    its gSynthVjp: the same GEMMs, planned by the same rule."""
    assert it.step_gemms_fwd(b, t, P, HOP)[0] == rt.synth_gemm(t, P, HOP)
    assert it.step_gemms_bwd(b, t, P, HOP)[-1] == rt.synth_vjp_gemm(t, P, HOP)
    if t >= 8:
        step = list(it.step_tiles(b, t, P, HOP, 132))
        assert list(rt.synth_fwd_tiles(b, t, P, HOP, 132)) == step[0:2]
        assert list(rt.synth_bwd_tiles(b, t, P, HOP, 132)) == step[-2:]
    for tiles in (rt.synth_fwd_tiles(b, t, P, HOP, 132), rt.synth_bwd_tiles(b, t, P, HOP, 132)):
        assert len(tiles) == 2 and tuple(tiles) in rt.SLAB_TILES


# ------------------------------------------------------------ the checks ---

def _misaligned(x):
    """A contiguous copy of x 4 (bf16: 2) bytes past a 16-byte boundary."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.fixture
def launches(monkeypatch):
    """The wrappers driven past their CPU branch on meta tensors: the card
    lookup and the launch replaced, each launch recorded; the counters
    restored afterwards."""
    calls = []
    monkeypatch.setattr(rt, "_sms", lambda index: 132)
    monkeypatch.setattr(rt, "_run", lambda entry, device, *args: calls.append((entry, args)))
    for k in rt.KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    return calls


def _meta(th, t):
    d = {k: th[k].to("meta") for k in ("ct", "csin", "yconst", "env", "ab", "abt", "g_y2")}
    d["y2"] = torch.empty(B, t - 1, HOP, device="meta")
    d["m1"] = torch.empty(B, device="meta")
    return d


@pytest.mark.parametrize("case", [None, "frames", "coeffs", "csin", "y_const", "ab", "geometry"])
def test_fwd_wrapper_refuses_before_any_launch(launches, case):
    _, th = _data(8)
    d = _meta(th, 8)
    args = [d["ct"], d["csin"], d["yconst"], d["env"], d["ab"]]
    if case == "frames":  # T = 1
        args = [d["ct"][:, :1], d["csin"][:, :1], d["yconst"][:, :0], d["env"][:0], d["ab"]]
    elif case == "coeffs":
        args[0] = args[0].double()
    elif case == "csin":
        args[1] = args[1].float()
    elif case == "y_const":
        args[2] = args[2][:, :, :128]
    elif case == "ab":  # the slab GEMM's weight, for its tensor map
        args[4] = _misaligned(args[4])
    elif case == "geometry":  # P % 32
        args[0] = args[0][..., :250]
    if case is None:
        y2, m1 = rt.synth_norm_fwd(*args)
        assert y2.shape == (B, 7, HOP) and m1.shape == (B,)
        (entry, run_args), = launches
        tiles = run_args[8]
        assert entry == "aw_synth_norm_fwd" and list(tiles) == list(
            rt.synth_fwd_tiles(B, 8, P, HOP, 132)) and run_args[9:] == (2, B, 8, P, HOP)
        assert rt.synth_norm_fwd.launches == 1
        return
    with pytest.raises((ValueError, TypeError)):
        rt.synth_norm_fwd(*args)
    assert launches == [] and rt.synth_norm_fwd.launches == 0


@pytest.mark.parametrize("case", [None, "frames", "g", "y2", "m1", "abt", "room"])
def test_bwd_wrapper_refuses_before_any_launch(launches, monkeypatch, case):
    _, th = _data(8)
    d = _meta(th, 8)
    args = [d["g_y2"], d["y2"], d["m1"], d["csin"], d["env"], d["abt"]]
    if case == "frames":  # T = 1
        args = [d["g_y2"][:, :0], d["y2"][:, :0], d["m1"], d["csin"][:, :1], d["env"][:0],
                d["abt"]]
    elif case == "g":
        args[0] = args[0].double()
    elif case == "y2":
        args[1] = args[1][:, :, :128]
    elif case == "m1":  # one value a clip, not (B, 1)
        args[2] = args[2][:, None]
    elif case == "abt":  # the slab GEMM's weight, for its tensor map
        args[5] = _misaligned(args[5])
    elif case == "room":  # the peak-norm VJP's partial sums past their room
        monkeypatch.setattr(rt, "PART_LD", 2)  # room for no chunk
    if case is None:
        dc = rt.synth_norm_bwd(*args)
        assert dc.shape == (B, 8, P)
        (entry, run_args), = launches
        assert entry == "aw_synth_norm_bwd" and list(run_args[11]) == list(
            rt.synth_bwd_tiles(B, 8, P, HOP, 132)) and run_args[12:] == (2, B, 8, P, HOP)
        assert rt.synth_norm_bwd.launches == 1
        return
    with pytest.raises((ValueError, TypeError)):
        rt.synth_norm_bwd(*args)
    assert launches == [] and rt.synth_norm_bwd.launches == 0


def test_fold_room_is_three_partials_a_chunk():
    room = rt.FOLD_CHUNK * (rt.PART_LD // 3)
    rt._check_fold(room // HOP + 1, HOP)  # (T-1) hop == room: it fits
    with pytest.raises(ValueError, match="partial sums"):
        rt._check_fold(room // HOP + 2, HOP)
