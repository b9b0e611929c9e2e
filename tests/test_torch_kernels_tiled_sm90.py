"""The long-clip synthesis on the sm90 slab GEMM against the JAX package.

``aw_synth_tiled_fwd`` (csrc/roundtrip_tiled.cu) is two launches: a pass
that writes reim = ct csinp (B, T, 2P) in float32, unrounded, then one
slab GEMM (csrc/slab_gemm_sm90.cuh) over reim with w_sf's four slabs at
dir +1, pad 1, whose epilogue divides by env, adds y_const and takes m1
by the reference's tail rule.  It cannot run here, so this file walks it
in torch on the CPU (``synth_walk``): the float32 reim as the pass writes
it, the GEMM by ``slab_walk`` of tests/test_torch_kernels_step_sm90.py
(per tile and 32-deep chunk one window rounded to bf16 and read by the
four slabs, the chunk's products summed from zero, float32 adds across
chunks; rows -1, T and T + 1 of each clip zero), then the tail epilogue.
The walk is held, on each of rt.SLAB_TILES:

* against the JAX ``synth_norm_tiled`` forward (``_synth_tiled_impl`` of
  aware_tpu/ops/pallas/roundtrip_tiled.py in Pallas interpret mode, under
  ``jax.vmap``) at T = 257, 300 and 1025, with the loud tail of
  tests/test_torch_kernels_roundtrip_tiled.py at T = 300 (the rows past lr
  set m1) and none where lr is a multiple of 256 (the rule plays no part);
* against ``synth_tiled_fwd_plain``.

Tolerances, relative to max|ref|: u and m1 within 1e-5, those of the
forwards in tests/test_torch_kernels_roundtrip_tiled.py (the same bf16
operands, float32 sums in another order).  The bf16 operand of every
product is the reference's to the bit: the pass rounds nothing, and
bf16(reim) is bf16(ctp csinp).

The Python half is tested as it is: the planner's grid covers each of
the 3752 rows of the long path's m1 (B = 8, T = 3751) once and fills the
132 SMs, and the wrapper's checks refuse what the launches cannot take
before any launch.  The kernel itself runs only on the card:
chip_smoke.py and tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from aware_tpu_torch.ops.kernels import roundtrip as rt
from aware_tpu_torch.ops.kernels import roundtrip_tiled as rtt
from test_torch_kernels_roundtrip_tiled import _jax_synth_impl, _rel_err, _synth_data
from test_torch_kernels_step_sm90 import slab_walk

HOP, P = 256, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reim_pass(ct, csinp):
    """The pass: reim[b, m] = ct[b, m] (both halves) * csinp[b, m + 1], f32."""
    t, p = ct.shape[1], ct.shape[2]
    cs = csinp[:, 1 : t + 1]
    return torch.cat([ct * cs[..., :p], ct * cs[..., p:]], dim=-1)


def synth_walk(ct, csinp, y_const, env, w_sf, bm, bn):
    """aw_synth_tiled_fwd's scheme on one tile: (u (B, T-1, hop), m1 (B,))."""
    b, t, p = ct.shape
    lr, hop = env.shape
    rows = rtt.m1_rows(lr)
    plan = rt.SlabPlan(bm, bn, (hop // bn, -(-rows // bm), b))
    acc = slab_walk(reim_pass(ct, csinp), w_sf.float().reshape(rtt.R * 2 * p, hop), rows, hop,
                    2 * p, 0, +1, 1, plan)
    u = acc[:, :lr] / env + y_const
    m1 = u.abs().amax(dim=(1, 2))
    if rows > lr:  # the tail rows from lr on enter m1 with env 1 and y_const 0
        m1 = torch.maximum(m1, acc[:, lr:].abs().amax(dim=(1, 2)))
    return u, m1


CASES = [(257, False), (300, True), (1025, False)]


@pytest.fixture(scope="module")
def references():
    """The JAX kernel's (u, m1) and the port's operands, per case."""
    out = {}
    for t, loud in CASES:
        d = _synth_data(t, loud)
        ctp = jnp.pad(jnp.asarray(d["ct"]), ((0, 0), (1, rtt.HALO - 1), (0, 0)))
        u_j, m1_j = _jax_synth_impl(ctp, d["csinp_j"], jnp.asarray(d["yconst"]),
                                    jnp.asarray(d["env"]), d["jb"]["w_sf"])
        args = (torch.from_numpy(d["ct"]), d["csinp_t"], torch.from_numpy(d["yconst"]),
                torch.from_numpy(d["env"]), d["tb"]["w_sf"])
        out[t] = (args, np.asarray(u_j), np.asarray(m1_j))
    return out


@pytest.mark.parametrize("tile", rt.SLAB_TILES)
@pytest.mark.parametrize("t, loud_tail", CASES)
def test_synth_walk_matches_jax_and_plain(references, t, loud_tail, tile):
    args, u_j, m1_j = references[t]
    u, m1 = synth_walk(*args, *tile)
    assert u.shape == (2, t - 1, HOP)
    assert _rel_err(u, u_j) <= 1e-5
    np.testing.assert_allclose(m1.numpy(), m1_j, rtol=1e-5)
    u_p, m1_p = rtt.synth_tiled_fwd_plain(*args)
    assert _rel_err(u, u_p) <= 1e-5
    np.testing.assert_allclose(m1.numpy(), m1_p.numpy(), rtol=1e-5)
    inner = u.abs().amax(dim=(1, 2))
    if loud_tail:  # the rows past lr set m1
        assert torch.all(m1 > 1.1 * inner)
    else:
        assert torch.equal(m1, inner)


@pytest.mark.parametrize("t", [257, 300, 1025])
def test_reim_rounds_to_the_references_operand(references, t):
    """bf16 of the pass's float32 reim is the bf16 operand the first
    version's loader (and the plain version) formed from ctp csinp: row m
    of reim is padded row m + 1; rows -1, T and T + 1 are the zero rows."""
    (ct, csinp, *_), _, _ = references[t]
    reim = reim_pass(ct, csinp)
    assert reim.dtype == torch.float32 and reim.shape == (2, t, 2 * P)
    ctp = F.pad(ct, (0, 0, 1, rtt.HALO - 1))
    ref = torch.cat([ctp * csinp[..., :P], ctp * csinp[..., P:]], dim=-1)
    assert torch.equal(rt._bf16(reim), rt._bf16(ref[:, 1 : t + 1]))
    assert not ref[:, 0].any() and not ref[:, t + 1 :].any()


def test_plan_covers_the_long_paths_rows_once_and_fills_the_card():
    rows = rtt.m1_rows(3750)
    assert rows == 3752
    plan = rt.plan_slab_gemm(8, rows, HOP)
    assert (plan.bm, plan.bn) == (128, 128) and plan.blocks >= rt.H100_SMS
    cols, tiles, clips = plan.grid
    assert clips == 8 and cols * plan.bn == HOP
    hits = torch.zeros(rows, HOP, dtype=torch.int32)
    for y in range(tiles):
        rr = range(y * plan.bm, min((y + 1) * plan.bm, rows))
        assert len(rr) > 0  # no block without an output row
        for x in range(cols):
            hits[rr.start : rr.stop, x * plan.bn : (x + 1) * plan.bn] += 1
    assert torch.all(hits == 1)


def _misaligned(x, by=1):
    """A contiguous copy of x ``by`` elements past a 16-byte boundary."""
    flat = torch.zeros(x.numel() + by, dtype=x.dtype)
    out = flat[by:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("case", ["ct", "csinp", "w_sf", "y_const", "env", "dtype", "shape",
                                  "frames"])
def test_synth_checks_refuse_before_any_launch(references, case):
    args = list(references[257][0])
    assert rtt.check_synth_tiled(*args) == (2, 257, P, HOP)  # what it takes
    names = ("ct", "csinp", "y_const", "env", "w_sf")
    if case in names:
        i = names.index(case)
        args[i] = _misaligned(args[i])  # 4 (w_sf: 2) bytes past 16
    elif case == "dtype":  # the tiled path's phase is float32
        args[1] = args[1].to(torch.bfloat16)
    elif case == "shape":
        args[1] = args[1][:, :-1].contiguous()
    else:  # one frame: no row of u
        args = [args[0][:, :1].contiguous(), args[1][:, :4].contiguous(),
                args[2][:, :0].contiguous(), args[3][:0].contiguous(), args[4]]
    rtt.reset_launches()
    with pytest.raises((ValueError, TypeError)):
        rtt.check_synth_tiled(*args)
    assert [k.launches for k in rtt.KERNELS] == [0, 0]


def test_float2_operands_may_sit_8_bytes_off():
    """y_const and env are read as float2: 8-byte alignment is enough."""
    d = _synth_data(257, False)
    args = [torch.from_numpy(d["ct"]), d["csinp_t"], torch.from_numpy(d["yconst"]),
            torch.from_numpy(d["env"]), d["tb"]["w_sf"]]
    args[2], args[3] = _misaligned(args[2], 2), _misaligned(args[3], 2)
    assert rtt.check_synth_tiled(*args) == (2, 257, P, HOP)
