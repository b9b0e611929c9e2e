"""The port's long-clip kernels against the JAX package's time-tiled ones.

The plain PyTorch versions of the two CUDA kernels (shift_mm and the
synth_norm_tiled forward) and the port's two autograd ops are held against
``aware_tpu.ops.pallas.roundtrip_tiled`` run in Pallas interpret mode on
the CPU, batched B = 2 under ``jax.vmap`` (the JAX kernels' own batched
grid).  Inputs come from a seeded numpy generator and reach both
frameworks as the same arrays.

Tolerances:
* forwards (shift_mm's out, the synthesis' u, m1 and y2) <= 1e-5 *
  max|ref|: the bf16 operands are identical and only the float32
  summation order differs;
* VJPs <= 1e-4 * max|ref|: as the forwards, plus the rare bf16 rounding
  flip of a cotangent element whose float32 value differs in its last bit.

The m1 tail rule (ops/kernels/roundtrip_tiled.py) is held with clips whose
last two frames are loud, so that the rows past lr set m1 (T = 300: rows
lr and lr+1; T = 256: row lr only), and where it plays no part
(lr % 256 == 0: T = 257, 1281).

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.ops.pallas import roundtrip_tiled as jrt
from aware_tpu_torch.ops.kernels import roundtrip_tiled as rtt

HOP, P, NB, B = 256, 256, 225, 2
N_FFT = 4 * HOP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bases(rng):
    """Random windowed bases in the solver's padded layouts."""
    ab_np = np.zeros((2 * P, N_FFT), np.float32)
    ab_np[:NB] = rng.standard_normal((NB, N_FFT)) * 0.05
    ab_np[P : P + NB] = rng.standard_normal((NB, N_FFT)) * 0.05
    csw_np = np.zeros((N_FFT, 2 * P), np.float32)
    csw_np[:, :NB] = rng.standard_normal((N_FFT, NB)) * 0.05
    csw_np[:, P : P + NB] = rng.standard_normal((N_FFT, NB)) * 0.05
    return ab_np, csw_np, jrt.build_tiled_bases(ab_np, csw_np), rtt.build_tiled_bases(
        ab_np, csw_np, "cpu")


def _synth_data(t, loud_tail, seed=0):
    """Coefficients, phase, y_const and env of B clips of t frames; with
    ``loud_tail`` the probe of the tail rule: y_const 0, env 1.5 and the
    last two frames' coefficients x50."""
    rng = np.random.default_rng(seed + t)
    ab_np, csw_np, jb, tb = _bases(rng)
    lr = t - 1
    coeffs = (rng.standard_normal((B, NB, t)) * 0.1).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (B, NB, t))
    cos, sin = np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)
    if loud_tail:
        coeffs[..., -2:] *= 50.0
        yconst = np.zeros((B, lr, HOP), np.float32)
        env = np.full((lr, HOP), 1.5, np.float32)
    else:
        yconst = (rng.standard_normal((B, lr, HOP)) * 0.01).astype(np.float32)
        env = (1.0 + rng.random((lr, HOP))).astype(np.float32)
    ct = np.zeros((B, t, P), np.float32)
    ct[..., :NB] = coeffs.transpose(0, 2, 1)
    csinp_j = jax.vmap(jrt.make_csinp, in_axes=(0, 0, None))(
        jnp.asarray(cos), jnp.asarray(sin), P)
    csinp_t = rtt.make_csinp(torch.from_numpy(cos), torch.from_numpy(sin), P)
    return {"ct": ct, "yconst": yconst, "env": env, "csinp_j": csinp_j,
            "csinp_t": csinp_t, "jb": jb, "tb": tb}


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return np.max(np.abs(ours - ref)) / np.max(np.abs(ref))


def test_tiled_bases_and_phase_match_jax():
    rng = np.random.default_rng(3)
    _, _, jb, tb = _bases(rng)
    for k in ("w_sf", "w_sb", "w_af", "w_ab"):
        np.testing.assert_array_equal(tb[k].float().numpy(), np.asarray(jb[k], np.float32))
    d = _synth_data(40, False)
    np.testing.assert_array_equal(d["csinp_t"].numpy(), np.asarray(d["csinp_j"]))
    assert d["csinp_t"].dtype == torch.float32


@pytest.mark.parametrize("use", ["w_af", "w_ab", "w_sb"])
@pytest.mark.parametrize("extra_rows", [1, 3])
def test_shift_mm_plain_matches_jax(use, extra_rows):
    """n = 300 output rows, not a tile multiple, at each of the three
    (D, E) uses; the solver's operands have n + 1 rows, the JAX test's
    n + 3."""
    n = 300
    rng = np.random.default_rng(11)
    _, _, jb, tb = _bases(rng)
    d = tb[use].shape[1]
    x = rng.standard_normal((B, n + extra_rows, d)).astype(np.float32)
    ref = jax.vmap(lambda a: jrt.shift_mm(a, jb[use], n))(jnp.asarray(x))
    ours = rtt.shift_mm(torch.from_numpy(x), tb[use], n)
    assert _rel_err(ours, ref) <= 1e-5


_jax_synth_impl = jax.jit(jax.vmap(jrt._synth_tiled_impl, in_axes=(0, 0, 0, None, None)))


@pytest.mark.parametrize("t, loud_tail", [(300, True), (256, True), (257, False),
                                          (1281, False)])
def test_synth_tiled_forward_matches_jax(t, loud_tail):
    d = _synth_data(t, loud_tail)
    lr = t - 1
    ctp = jnp.pad(jnp.asarray(d["ct"]), ((0, 0), (1, jrt.HALO - 1), (0, 0)))
    u_j, m1_j = _jax_synth_impl(ctp, d["csinp_j"], jnp.asarray(d["yconst"]),
                                jnp.asarray(d["env"]), d["jb"]["w_sf"])
    ct = torch.from_numpy(d["ct"])
    args = (d["csinp_t"], torch.from_numpy(d["yconst"]), torch.from_numpy(d["env"]))
    u, m1 = rtt.synth_tiled_fwd(ct, *args, d["tb"]["w_sf"])
    assert _rel_err(u, u_j) <= 1e-5
    np.testing.assert_allclose(m1.numpy(), np.asarray(m1_j), rtol=1e-5)
    inner = u.abs().amax(dim=(1, 2))
    if loud_tail:  # the rows past lr set m1
        assert torch.all(m1 > 1.1 * inner)
    else:
        torch.testing.assert_close(m1, inner, rtol=0, atol=0)
    y2_j = jax.vmap(jrt.synth_norm_tiled, in_axes=(0, 0, 0, None, None, None))(
        jnp.asarray(d["ct"]), d["csinp_j"], jnp.asarray(d["yconst"]),
        jnp.asarray(d["env"]), d["jb"]["w_sf"], d["jb"]["w_sb"])
    y2 = rtt.synth_norm_tiled(ct, *args, d["tb"]["w_sf"], d["tb"]["w_sb"])
    assert y2.shape == (B, lr, HOP)
    assert _rel_err(y2, y2_j) <= 1e-5


@pytest.mark.parametrize("t, loud_tail", [(300, True), (257, False)])
def test_synth_tiled_vjp_matches_jax(t, loud_tail):
    d = _synth_data(t, loud_tail, seed=5)
    g = np.random.default_rng(t).standard_normal((B, t - 1, HOP)).astype(np.float32)
    consts_j = (jnp.asarray(d["yconst"]), jnp.asarray(d["env"]), d["jb"]["w_sf"],
                d["jb"]["w_sb"])

    def f(ct, csinp, yconst):
        return jrt.synth_norm_tiled(ct, csinp, yconst, *consts_j[1:])

    _, vjp = jax.vjp(lambda c: jax.vmap(f)(c, d["csinp_j"], consts_j[0]),
                     jnp.asarray(d["ct"]))
    (ref,) = vjp(jnp.asarray(g))
    ct = torch.from_numpy(d["ct"]).requires_grad_(True)
    y2 = rtt.synth_norm_tiled(ct, d["csinp_t"], torch.from_numpy(d["yconst"]),
                              torch.from_numpy(d["env"]), d["tb"]["w_sf"], d["tb"]["w_sb"])
    (ours,) = torch.autograd.grad(y2, ct, torch.from_numpy(g))
    assert _rel_err(ours, ref) <= 1e-4


@pytest.mark.parametrize("t", [300, 257])
def test_band_analysis_tiled_matches_jax(t):
    rng = np.random.default_rng(100 + t)
    _, _, jb, tb = _bases(rng)
    y2 = rng.standard_normal((B, t - 1, HOP)).astype(np.float32)
    g = rng.standard_normal((B, t, 2 * P)).astype(np.float32)
    fwd_j, vjp = jax.vjp(
        jax.vmap(lambda y: jrt.band_analysis_tiled(y, jb["w_af"], jb["w_ab"])),
        jnp.asarray(y2))
    (ref,) = vjp(jnp.asarray(g))
    y = torch.from_numpy(y2).requires_grad_(True)
    cs2 = rtt.band_analysis_tiled(y, tb["w_af"], tb["w_ab"])
    assert _rel_err(cs2.detach(), fwd_j) <= 1e-5
    (ours,) = torch.autograd.grad(cs2, y, torch.from_numpy(g))
    assert _rel_err(ours, ref) <= 1e-4


def test_m1_rows_follow_the_tile_grid():
    assert [rtt.m1_rows(lr) for lr in (256, 255, 299, 1280, 3750)] == [
        256, 256, 301, 1280, 3752]


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    d = _synth_data(40, False)
    ct = torch.from_numpy(d["ct"])
    args = (d["csinp_t"], torch.from_numpy(d["yconst"]), torch.from_numpy(d["env"]),
            d["tb"]["w_sf"])
    rtt.reset_launches()
    for ours, plain in zip(rtt.synth_tiled_fwd(ct, *args), rtt.synth_tiled_fwd_plain(ct, *args)):
        assert torch.equal(ours, plain)
    x = torch.from_numpy(d["yconst"])
    assert torch.equal(rtt.shift_mm(x, d["tb"]["w_af"], 40),
                       rtt.shift_mm_plain(x, d["tb"]["w_af"], 40))
    assert [k.launches for k in rtt.KERNELS] == [0, 0]


def _tail_probe() -> None:
    """The m1 tail rows of the reference, read from the JAX kernel and the
    port: the random bases of tests/test_pallas_tiled.py's data, numpy seed
    0, T = 300, y_const 0, env 1.5, the last two frames' band coefficients
    x50."""
    t, lr = 300, 299
    rng = np.random.default_rng(0)
    coeffs = rng.standard_normal((NB, t)).astype(np.float32) * 0.1
    cos = np.cos(rng.uniform(-np.pi, np.pi, (NB, t))).astype(np.float32)
    sin = np.sqrt(np.maximum(1 - cos**2, 0)).astype(np.float32)
    rng.standard_normal((lr, HOP))  # the data's y_const and env draws, unused here
    rng.random((lr, HOP))
    ab_np = np.zeros((2 * P, N_FFT), np.float32)
    ab_np[:NB] = rng.standard_normal((NB, N_FFT)) * 0.05
    ab_np[P : P + NB] = rng.standard_normal((NB, N_FFT)) * 0.05
    csw_np = np.zeros((N_FFT, 2 * P), np.float32)
    coeffs[:, -2:] *= 50.0
    ct = np.zeros((t, P), np.float32)
    ct[:, :NB] = coeffs.T
    yconst, env = np.zeros((lr, HOP), np.float32), np.full((lr, HOP), 1.5, np.float32)
    jb = jrt.build_tiled_bases(ab_np, csw_np)
    ctp = jnp.pad(jnp.asarray(ct), ((1, jrt.HALO - 1), (0, 0)))
    u_j, m1_j = jrt._synth_tiled_impl(ctp, jrt.make_csinp(jnp.asarray(cos), jnp.asarray(sin), P),
                                      jnp.asarray(yconst), jnp.asarray(env), jb["w_sf"])
    u, m1 = rtt.synth_tiled_fwd(
        torch.from_numpy(ct)[None],
        rtt.make_csinp(torch.from_numpy(cos)[None], torch.from_numpy(sin)[None], P),
        torch.from_numpy(yconst)[None], torch.from_numpy(env),
        rtt.build_tiled_bases(ab_np, csw_np, "cpu")["w_sf"])
    print(f"tail probe, T = {t}: JAX kernel m1 {float(m1_j):.4f} against max|u[:lr]| "
          f"{float(jnp.max(jnp.abs(u_j))):.4f}; port m1 {float(m1[0]):.4f} against "
          f"{float(u.abs().max()):.4f}")


if __name__ == "__main__":
    _tail_probe()
