"""The sm90 slab GEMM's scheme (csrc/slab_gemm_sm90.cuh) against the JAX package.

The kernel that runs shift_mm and the band_analysis VJP on the card cannot
run here, so this file runs its scheme in torch on the CPU (``tile_walk``):
per clip, per BM x BN output tile, per depth chunk of 32 columns, one A
window of BM + 3 rows starting at the smallest slab shift, its rows
outside [0, N) of that clip read as zero, rounded to bf16; slab k reads
the window at its own row offset (shift dir * (k - pad) less the
smallest); output rows at or past n_out are masked.  That walk is held:

* at shift_mm's geometry (dir +1, pad 0) against ``shift_mm_plain`` and
  against the JAX ``shift_mm`` of aware_tpu/ops/pallas/roundtrip_tiled.py
  (Pallas interpret mode on the CPU), at the long path's three (D, E)
  uses, with n_out % BM != 0, N < n_out + 3 and B = 3, on every tile the
  planner can choose;
* at the band_analysis VJP's geometry (dir -1, pad 2) against
  ``band_analysis_bwd_plain`` and the VJP of the JAX ``band_analysis``
  (``jax.vjp``, interpret mode), at T = 8, 40 and 97 with B = 3;
* at the band_analysis forward's geometry (dir +1, pad 2, the weight
  slabs csw[k hop:(k+1) hop, :]) against ``band_analysis_fwd_plain`` and
  the JAX ``band_analysis`` (interpret mode), at T = 8, 40 and 97 with
  B = 3, on the tile the planner chooses.

Tolerances, relative to max|ref|: 1e-5 against the plain versions and the
JAX forward (the same bf16 operands, float32 sums in another order); 1e-4
against the JAX VJP, the tolerance of the round-trip tests
(tests/test_torch_kernels_roundtrip.py), which adds the rare bf16
rounding flip of a cotangent whose float32 value differs in its last bit.

The Python half of the geometry is tested as it is: the tile planner's
grid covers every output row and column exactly once, and the wrapper
checks reject what the kernel cannot take.  The kernel itself runs only on
the card: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.ops.pallas import roundtrip as jrt
from aware_tpu.ops.pallas import roundtrip_tiled as jrtt
from aware_tpu_torch.ops.kernels import roundtrip as rt
from aware_tpu_torch.ops.kernels import roundtrip_tiled as rtt

HOP, P, NB, B = 256, 256, 225, 3
N_FFT = 4 * HOP
SLABS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tile_walk(a, slab, n_out, e, direction, pad, bm, bn):
    """The kernel's scheme: a (B, N, D) f32; slab(k) the (D, E) weights of
    slab k as float32; output (B, n_out, e) from BM x BN tiles."""
    batch, n, d = a.shape
    first = -pad if direction > 0 else pad - (SLABS - 1)  # the smallest shift
    offsets = [direction * (k - pad) - first for k in range(SLABS)]
    rows = bm + SLABS - 1
    out = torch.full((batch, n_out, e), float("nan"))
    for t0 in range(0, n_out, bm):
        src = torch.arange(t0 + first, t0 + first + rows)
        inside = (src >= 0) & (src < n)
        for n0 in range(0, e, bn):
            acc = torch.zeros(batch, bm, bn)
            for c0 in range(0, d, rt.SLAB_DEPTH):
                win = torch.zeros(batch, rows, rt.SLAB_DEPTH)
                win[:, inside] = a[:, src[inside], c0 : c0 + rt.SLAB_DEPTH]
                win = win.to(torch.bfloat16).float()
                for k, off in enumerate(offsets):
                    acc += win[:, off : off + bm] @ slab(k)[c0 : c0 + rt.SLAB_DEPTH, n0 : n0 + bn]
            keep = min(bm, n_out - t0)
            out[:, t0 : t0 + keep, n0 : n0 + bn] = acc[:, :keep]
    return out


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return np.max(np.abs(ours - ref)) / np.max(np.abs(ref))


def _tiled_bases(rng):
    """Random windowed bases, stacked per direction as both packages do."""
    ab_np = np.zeros((2 * P, N_FFT), np.float32)
    ab_np[:NB] = rng.standard_normal((NB, N_FFT)) * 0.05
    ab_np[P : P + NB] = rng.standard_normal((NB, N_FFT)) * 0.05
    csw_np = np.zeros((N_FFT, 2 * P), np.float32)
    csw_np[:, :NB] = rng.standard_normal((N_FFT, NB)) * 0.05
    csw_np[:, P : P + NB] = rng.standard_normal((N_FFT, NB)) * 0.05
    return jrtt.build_tiled_bases(ab_np, csw_np), rtt.build_tiled_bases(ab_np, csw_np, "cpu")


# the long path's three uses: D x E of the weight stack
USES = {"w_af": (HOP, 2 * P), "w_ab": (2 * P, HOP), "w_sb": (HOP, 2 * P)}


@pytest.mark.parametrize("tile", rt.SLAB_TILES)
@pytest.mark.parametrize("use", list(USES))
def test_tile_walk_holds_shift_mm(use, tile):
    """n_out = 300 (no multiple of 64 or 128) from N = 301 rows, so that
    the last three output rows read rows at and past N, B = 3 clips whose
    neighbours' rows must not leak in."""
    n_out, n = 300, 301
    rng = np.random.default_rng(17)
    jb, tb = _tiled_bases(rng)
    d, e = USES[use]
    assert tuple(tb[use].shape) == (SLABS, d, e)
    x = rng.standard_normal((B, n, d)).astype(np.float32)
    w = tb[use].float()
    ours = tile_walk(torch.from_numpy(x), lambda k: w[k], n_out, e, +1, 0, *tile)
    assert _rel_err(ours, rtt.shift_mm_plain(torch.from_numpy(x), tb[use], n_out)) <= 1e-5
    ref = jax.vmap(lambda a: jrtt.shift_mm(a, jb[use], n_out))(jnp.asarray(x))
    assert _rel_err(ours, ref) <= 1e-5


@jax.jit
def _jax_analysis_vjp(y, csw, cswt, g):
    return jax.vjp(lambda x: jrt.band_analysis(x, csw, cswt), y)[1](g)[0]


@pytest.mark.parametrize("t", [8, 40, 97])
def test_tile_walk_holds_band_analysis_vjp(t):
    """Output row i reads g rows i + 2, i + 1, i and i - 1: row -1 of each
    clip is zero, and so is row T at the last output row T - 2 + 2."""
    rng = np.random.default_rng(1000 + t)
    csw = (rng.standard_normal((N_FFT, 2 * P)) / 16).astype(np.float32)
    g = rng.standard_normal((B, t, 2 * P)).astype(np.float32)
    cswt = torch.from_numpy(csw.T.copy()).to(torch.bfloat16)
    cswt_f = cswt.float()
    plan = rt.plan_slab_gemm(B, t - 1, HOP)
    ours = tile_walk(torch.from_numpy(g), lambda k: cswt_f[:, k * HOP : (k + 1) * HOP],
                     t - 1, HOP, -1, 2, plan.bm, plan.bn)
    assert _rel_err(ours, rt.band_analysis_bwd_plain(torch.from_numpy(g), cswt)) <= 1e-5
    csw_j = jnp.asarray(csw, jnp.bfloat16)
    cswt_j = jnp.asarray(csw.T.copy(), jnp.bfloat16)
    y = jnp.zeros((t - 1, HOP), jnp.float32)  # the VJP of a linear map: any point
    for i in range(B):
        ref = _jax_analysis_vjp(y, csw_j, cswt_j, jnp.asarray(g[i]))
        assert _rel_err(ours[i], ref) <= 1e-4


@jax.jit
def _jax_analysis(y, csw, cswt):
    return jrt.band_analysis(y, csw, cswt)


@pytest.mark.parametrize("t", [8, 40, 97])
def test_tile_walk_holds_band_analysis_forward(t):
    """Output row i reads y2 rows i - 2, i - 1, i and i + 1: rows -2, -1
    and T - 1 of each clip are zero."""
    rng = np.random.default_rng(2000 + t)
    csw_np = (rng.standard_normal((N_FFT, 2 * P)) / 16).astype(np.float32)
    y2 = rng.standard_normal((B, t - 1, HOP)).astype(np.float32)
    csw = torch.from_numpy(csw_np).to(torch.bfloat16)
    csw_f = csw.float()
    plan = rt.plan_slab_gemm(B, t, 2 * P)
    ours = tile_walk(torch.from_numpy(y2), lambda k: csw_f[k * HOP : (k + 1) * HOP], t, 2 * P,
                     +1, 2, plan.bm, plan.bn)
    assert _rel_err(ours, rt.band_analysis_fwd_plain(torch.from_numpy(y2), csw)) <= 1e-5
    csw_j = jnp.asarray(csw_np, jnp.bfloat16)
    cswt_j = jnp.asarray(csw_np.T.copy(), jnp.bfloat16)
    for i in range(B):
        assert _rel_err(ours[i], _jax_analysis(jnp.asarray(y2[i]), csw_j, cswt_j)) <= 1e-5


@pytest.mark.parametrize("batch, n_out, e", [
    (8, 3751, 512), (8, 3753, 256), (8, 625, 256), (3, 7, 256), (3, 300, 512), (2, 1, 64),
])
def test_plan_covers_every_output_once(batch, n_out, e):
    plan = rt.plan_slab_gemm(batch, n_out, e)
    cols, tiles, clips = plan.grid
    assert clips == batch and cols * plan.bn == e
    hits = torch.zeros(batch, n_out, e, dtype=torch.int32)
    for z in range(clips):
        for y in range(tiles):
            rows = range(y * plan.bm, min((y + 1) * plan.bm, n_out))
            assert len(rows) > 0  # no block without an output row
            for x in range(cols):
                hits[z, rows.start : rows.stop, x * plan.bn : (x + 1) * plan.bn] += 1
    assert torch.all(hits == 1)


def test_plan_fills_the_card_on_the_main_paths():
    # shift_mm's three uses at B = 8 x 3751 frames: 128 x 128 tiles, 480 or
    # 960 blocks; the band_analysis VJP at B = 8 x 626: 128 x 128 would
    # leave 80 blocks for 132 SMs, so 64 x 128, 160 blocks
    for n_out, e, blocks in ((3751, 512, 960), (3753, 256, 480), (3751, 512, 960)):
        plan = rt.plan_slab_gemm(8, n_out, e)
        assert (plan.bm, plan.bn, plan.blocks) == (128, 128, blocks)
    plan = rt.plan_slab_gemm(8, 625, 256)
    assert (plan.bm, plan.bn, plan.blocks) == (64, 128, 160)
    assert rt.plan_slab_gemm(8, 625, 256, sms=200).bn == 64  # the most blocks


def _misaligned(*shape, dtype=torch.float32):
    """A contiguous tensor 4 (or 2) bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(*shape)


@pytest.mark.parametrize("case", ["depth", "width", "a_address", "w_address", "rows"])
def test_slab_checks_reject_what_the_kernel_cannot_take(case):
    a = torch.zeros(2, 40, 64)
    w = torch.zeros(SLABS, 64, 128, dtype=torch.bfloat16)
    e, n_out = 128, 40
    rt.check_slab_gemm(a, w, e, n_out)  # what it takes
    if case == "depth":  # D % 32
        a, w = torch.zeros(2, 40, 48), torch.zeros(SLABS, 48, 128, dtype=torch.bfloat16)
    elif case == "width":  # E % 64
        e, w = 96, torch.zeros(SLABS, 64, 96, dtype=torch.bfloat16)
    elif case == "a_address":  # TMA's 16-byte address alignment
        a = _misaligned(2, 40, 64)
    elif case == "w_address":
        w = _misaligned(SLABS, 64, 128, dtype=torch.bfloat16)
    else:
        n_out = 0
    with pytest.raises(ValueError):
        rt.check_slab_gemm(a, w, e, n_out)
