"""The turbo card's precision: ``matmul_precision: "default"`` (one bf16
pass per product, as ``jax.lax.Precision.DEFAULT`` on a TPU) and
``scan_unroll``, on the CPU.

* ``models.detector.matmul`` at "default", both ways, against a reference
  built here: the operands (and for the VJP the cotangent) rounded to bf16
  by ``jnp.astype(bfloat16)``, multiplied in float64: within 1e-5 of
  max|ref| (float32 accumulation of exact bf16 products).
* Against the JAX package on the CPU, where XLA ignores ``precision``
  (all three precisions read 5.8e-7 relative on a 64x256x64 product, bf16
  operands 2.3e-3): the products, the detector and the first objective of
  the float32 round trips at BF16_TOL, the bf16 boundary below.
* The turbo card file read as ``aware_tpu.config.AwareConfig.from_dict``
  reads it; ``scan_unroll`` validated.
* A 50-iteration embed of two 2 s clips on the whole-step path (the turbo
  card's at 10 s) against the JAX package's ``embed_batch`` with its
  whole-step kernel (interpret mode), at the outcome level of
  tests/test_torch_slice_iteration.py: 0 % BER on every lane, best losses
  within 0.02; detection at "default" reads the JAX detector's bits.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aware_tpu_torch
from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.embed.solver import build_problem as jax_build_problem
from aware_tpu.embed.solver import embed_batch as jax_embed_batch
from aware_tpu.models import detect_values as jax_detect_values
from aware_tpu.models import init_params
from aware_tpu.models.detector import detector_apply, detector_apply_banded
from aware_tpu_torch.config import AwareConfig
from aware_tpu_torch.embed import solver
from aware_tpu_torch.models.detector import (
    DetectorNet,
    detect_values_batch,
    load_key_params,
    matmul,
    params_from_jax,
)
from test_torch_slice_detector import _speechlike

ROOT = pathlib.Path(__file__).resolve().parents[1]
TURBO = ROOT / "aware_tpu" / "cards" / "turbo.yaml"
HOP = 256
# the bf16 boundary: an operand rounded to bf16 moves by up to 2^-9 of
# itself, a product of two by up to about 2^-8; sums of such products
# against the float32 ones, relative to the largest output, hold within
# 2^-7 (4x bf16's unit roundoff; measured 2.3e-3 on a 64x256x64 product)
BF16_TOL = 2.0**-7
REF_TOL = 1e-5    # against the float64 product of the bf16-rounded operands
LOSS_TOL = 0.02   # 50-iteration best loss against the JAX solve
# Against the JAX package with TPU "default" products (the fixture
# tpu_default): the same bf16 roundings, float32 sums in other orders.  An
# ulp in a sum flips a bf16 rounding downstream, and the detector's output
# (a small difference of pooled means) amplifies such flips: the reference
# itself moves under 1e-6 moves of its input by up to 1.1e-2 of max|out|
# (the detector, 3 random magnitudes x 3 moves), 2.7e-4 relative (the first
# loss) and 0.20 relative L2 (its gradient, "slab", "frames" and "fft", 2
# clips x 2 moves).  The port reads 0.4-0.8e-2, 0.3e-4-1.9e-4 and 0.02-0.21
# there; each bound is about twice the reference's own spread (the
# gradient's is the views' float32 bound of tests/test_torch_eot_objective.py,
# 0.3).
DET_TOL = 2e-2
LOSS_REL = 1e-3
GRAD_REL = 0.3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    return DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)


@pytest.fixture(scope="module")
def jax_params():
    return {k: jnp.asarray(v) for k, v in init_params(JaxConfig().detection_net).items()}


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 by JAX, as float64."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32),
                      np.float64)


def _operands(seed: int, shape_a=(64, 256), shape_b=(256, 64)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_a).astype(np.float32),
            rng.standard_normal(shape_b).astype(np.float32))


@pytest.mark.parametrize("shape_a, shape_b", [
    ((64, 256), (256, 64)),
    ((3, 40, 225), (225, 126)),      # batched, as the mel projection of 3 clips
    ((512, 128), (2, 128, 63)),      # a weight against a batch (w @ x)
])
def test_default_product_is_one_bf16_pass(shape_a, shape_b):
    a, b = _operands(0, shape_a, shape_b)
    ours = matmul(torch.from_numpy(a), torch.from_numpy(b), "default").numpy()
    ref = _bf16(a) @ _bf16(b)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= REF_TOL * np.abs(ref).max()
    # bf16 operands are a different function from float32's
    f32 = matmul(torch.from_numpy(a), torch.from_numpy(b), "highest").numpy()
    assert np.abs(f32 - ref).max() > 10 * REF_TOL * np.abs(ref).max()
    # and from torch's bf16 x bf16 product, which rounds the result too
    bf = (torch.from_numpy(a).bfloat16() @ torch.from_numpy(b).bfloat16()).float().numpy()
    assert np.abs(bf - ref).max() > np.abs(ours - ref).max()


def test_default_product_vjp_is_one_bf16_pass():
    a, b = _operands(1)
    g = np.random.default_rng(2).standard_normal((64, 64)).astype(np.float32)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    ga, gb = torch.autograd.grad(matmul(ta, tb, "default"), (ta, tb), torch.from_numpy(g))
    ref_a = _bf16(g) @ _bf16(b).T
    ref_b = _bf16(a).T @ _bf16(g)
    assert np.abs(ga.numpy() - ref_a).max() <= REF_TOL * np.abs(ref_a).max()
    assert np.abs(gb.numpy() - ref_b).max() <= REF_TOL * np.abs(ref_b).max()
    # a weight shared by a batch: its cotangent sums over the batch
    x = torch.randn(3, 256, 5, requires_grad=True)
    w = torch.randn(7, 256, requires_grad=True)
    gx, gw = torch.autograd.grad(matmul(w, x, "default").sum(), (x, w))
    assert gx.shape == x.shape and gw.shape == w.shape


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_products_against_jax_on_the_cpu(precision):
    a, b = _operands(3)
    prec = {"default": jax.lax.Precision.DEFAULT, "high": jax.lax.Precision.HIGH,
            "highest": jax.lax.Precision.HIGHEST}[precision]
    ref = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b), precision=prec))
    ours = matmul(torch.from_numpy(a), torch.from_numpy(b), precision).numpy()
    tol = BF16_TOL if precision == "default" else 1e-5
    assert np.abs(ours - ref).max() <= tol * np.abs(ref).max()


def _round(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


@jax.custom_vjp
def _tpu_default_matmul(a, b):
    return jnp.matmul(_round(a), _round(b), precision=jax.lax.Precision.HIGHEST)


def _tpu_default_fwd(a, b):
    ra, rb = _round(a), _round(b)
    return jnp.matmul(ra, rb, precision=jax.lax.Precision.HIGHEST), (ra, rb)


def _tpu_default_bwd(res, g):
    ra, rb = res
    gr = _round(g)
    hi = jax.lax.Precision.HIGHEST
    return (jnp.matmul(gr, jnp.swapaxes(rb, -1, -2), precision=hi),
            jnp.matmul(jnp.swapaxes(ra, -1, -2), gr, precision=hi))


_tpu_default_matmul.defvjp(_tpu_default_fwd, _tpu_default_bwd)


class _TpuDefaultJnp:
    """``jax.numpy`` with ``matmul(..., precision=DEFAULT)`` computed as a
    TPU computes it (bf16 operands, and in the VJP a bf16 cotangent, float32
    products and sums), where XLA on the CPU ignores the precision.  Each
    product's site (:func:`_site`) is appended to ``log``."""

    def __init__(self, log=None):
        self.log = [] if log is None else log

    def __getattr__(self, name):
        return getattr(jnp, name)

    def matmul(self, a, b, precision=None):
        self.log.append(_site(_PRECISIONS.get(precision, str(precision)), a, b))
        if precision == jax.lax.Precision.DEFAULT:
            return _tpu_default_matmul(a, b)
        return jnp.matmul(a, b, precision=precision)


_PRECISIONS = {jax.lax.Precision.DEFAULT: "default", jax.lax.Precision.HIGH: "high",
               jax.lax.Precision.HIGHEST: "highest"}


def _site(precision, a, b):
    """A product as (precision, a's last two dims, b's last two dims): the
    port batches the clips that the JAX package maps one by one."""
    return precision, tuple(a.shape[-2:]), tuple(b.shape[-2:])


@pytest.fixture
def tpu_default(monkeypatch):
    """The JAX package's detector and solver with "default" products as on
    a TPU, for this test only (the package's modules are not edited).
    Returns the list of the JAX products' sites, in order."""
    import aware_tpu.embed.solver as jax_solver
    import aware_tpu.models.detector as jax_detector

    log = []
    monkeypatch.setattr(jax_detector, "jnp", _TpuDefaultJnp(log))
    monkeypatch.setattr(jax_solver, "jnp", _TpuDefaultJnp(log))
    return log


@pytest.fixture
def port_products(monkeypatch):
    """Every product of the port's plain paths (``models.detector.matmul``,
    as the detector and the solver call it) as (site, a, b, out), in order.
    Against the JAX package's sites it shows that each call site takes the
    card's precision, where the detector's output is too chaotic to tell
    bf16 products from float32 ones (DET_TOL, GRAD_REL)."""
    from aware_tpu_torch.models import detector as port_detector

    log = []

    def recorded(a, b, precision="highest"):
        out = matmul(a, b, precision)
        log.append((_site(precision, a, b), a.detach(), b.detach(), out.detach()))
        return out

    monkeypatch.setattr(port_detector, "matmul", recorded)
    monkeypatch.setattr(solver, "matmul", recorded)
    return log


def _check_products(port_log, jax_sites, clips=1):
    """The port's products are the JAX package's, site by site (``clips``
    JAX calls to the port's one batched call), and each "default" one is a
    single bf16 pass on its own operands (REF_TOL)."""
    assert clips * [site for site, *_ in port_log] == jax_sites
    for site, a, b, out in port_log:
        if site[0] == "default":
            ref = _bf16(a.numpy()) @ _bf16(b.numpy())
            assert np.abs(out.numpy() - ref).max() <= REF_TOL * np.abs(ref).max(), site


def test_tpu_default_emulation_is_the_bf16_reference():
    a, b = _operands(6)
    ref = np.asarray(_tpu_default_matmul(jnp.asarray(a), jnp.asarray(b)))
    assert np.abs(ref - _bf16(a) @ _bf16(b)).max() <= REF_TOL * np.abs(ref).max()


def test_detector_at_default_against_jax(net, jax_params, tpu_default, port_products):
    """The detector at "default" against the JAX detector with TPU
    "default" products, within DET_TOL of max|ref|; its products site by
    site (:func:`_check_products`), the banded entry's too."""
    rng = np.random.default_rng(4)
    mag = np.abs(rng.standard_normal((2, 513, 126))).astype(np.float32)
    ours = net(torch.from_numpy(mag), "default").numpy()
    ref = np.stack([np.asarray(detector_apply(jax_params, jnp.asarray(m),
                                              matmul_precision="default")) for m in mag])
    _check_products(port_products, tpu_default, clips=2)
    f32 = np.stack([np.asarray(detector_apply(jax_params, jnp.asarray(m),
                                              matmul_precision="highest")) for m in mag])
    assert np.abs(ours - ref).max() <= DET_TOL * np.abs(ref).max()
    # the float32 detector is another function: its distance is printed by
    # the readings, not held (1.6-3.3e-2 of max|out| there)
    assert not np.array_equal(f32, ref)
    # the banded entry is the same function at "default" too
    lo, hi = 32, 257
    tpu_default.clear()
    port_products.clear()
    banded = net.forward_banded(torch.from_numpy(mag[:, lo:hi]), lo, hi, "default").numpy()
    detector_apply_banded(jax_params, jnp.asarray(mag[0, lo:hi]), lo, hi,
                          matmul_precision="default")
    _check_products(port_products, tpu_default)
    zeroed = mag.copy()
    zeroed[:, :lo] = zeroed[:, hi:] = 0.0
    full = net(torch.from_numpy(zeroed), "default").numpy()
    np.testing.assert_allclose(banded, full, atol=DET_TOL * np.abs(full).max())


# path -> the flags that select it with "default" on both packages
PLAIN = {
    "slab": {"use_pallas_roundtrip": False},
    "frames": {"use_slab_dft": False},
    "fft": {"use_matmul_dft": False},
}


@pytest.mark.parametrize("path", list(PLAIN))
def test_first_objective_at_default_against_jax(net, jax_params, path, tpu_default,
                                                port_products):
    """The float32 round trips with their products and detector at
    "default": the first objective and its gradient against the JAX
    package's on the same flags with TPU "default" products, within
    LOSS_REL and GRAD_REL (relative L2); the set-up's and the objective's
    products site by site (:func:`_check_products`)."""
    clips = np.stack([_speechlike(41)[: 62 * HOP], _speechlike(42)[: 62 * HOP]])
    wm = (2.0 * np.random.default_rng(5).integers(0, 2, (2, 20)) - 1.0).astype(np.float32)
    flags = dict(PLAIN[path], matmul_precision="default")
    cfg = AwareConfig(**flags)
    pb = solver.build_problem(net, torch.from_numpy(clips), torch.from_numpy(wm), cfg)
    assert pb.path == path
    ct = pb.ct0.clone().requires_grad_(True)
    loss = solver.objective(ct, pb, net, cfg)
    (grad,) = torch.autograd.grad(loss.sum(), ct)
    for i in range(2):
        jpb = jax_build_problem(jax_params, jnp.asarray(clips[i]), jnp.asarray(wm[i]),
                                JaxConfig().replace(**flags))
        np.testing.assert_allclose(pb.ct0[i, :, : pb.nb].numpy().T, np.asarray(jpb.coeffs0),
                                   rtol=1e-5, atol=1e-5)
        jl, jg = jax.value_and_grad(jpb.objective)(jpb.coeffs0)
        assert abs(float(loss[i]) - float(jl)) <= LOSS_REL * abs(float(jl))
        g = grad[i, :, : pb.nb].numpy().T
        assert np.linalg.norm(g - np.asarray(jg)) <= GRAD_REL * np.linalg.norm(np.asarray(jg))
    _check_products(port_products, tpu_default, clips=2)


# the detector's other call sites: the kernel paths' plain detector
# ("band_analysis", as the tiled path; its kernels are bf16 on every
# precision) and the EOT views' detector (on "fft", where no kernel runs)
OTHER_SITES = {
    "band_analysis": ({"use_pallas_detector": False},
                      {"use_pallas_roundtrip": True, "use_pallas_detector": False}),
    "views": ({"use_matmul_dft": False, "eot_stretch_rates": (0.9,), "eot_mode": "cycle"},
              {"use_matmul_dft": False, "eot_stretch_rates": (0.9,), "eot_mode": "cycle"}),
}


@pytest.mark.parametrize("case", list(OTHER_SITES))
def test_kernel_path_and_view_detectors_take_the_precision(net, jax_params, case, tpu_default,
                                                           port_products):
    """The set-up's and the first objective's products at "default" on the
    kernel paths' plain detector and on the EOT views' detector, site by
    site against the JAX package's (:func:`_check_products`)."""
    flags, jax_flags = OTHER_SITES[case]
    clips = np.stack([_speechlike(46)[: 62 * HOP]])
    wm = (2.0 * np.random.default_rng(6).integers(0, 2, (1, 20)) - 1.0).astype(np.float32)
    cfg = AwareConfig(**flags, matmul_precision="default")
    pb = solver.build_problem(net, torch.from_numpy(clips), torch.from_numpy(wm), cfg)
    assert pb.path == ("band_analysis" if case == "band_analysis" else "fft")
    ct = pb.ct0.clone().requires_grad_(True)
    torch.autograd.grad(solver.objective(ct, pb, net, cfg, 0).sum(), ct)
    jpb = jax_build_problem(jax_params, jnp.asarray(clips[0]), jnp.asarray(wm[0]),
                            JaxConfig().replace(**jax_flags, matmul_precision="default"))
    if jpb.carry is not None:
        objective, to_carry = jpb.carry[0], jpb.carry[1]
        jax.value_and_grad(objective)(to_carry(jpb.coeffs0), jnp.int32(0))
    else:
        jax.value_and_grad(jpb.objective)(jpb.coeffs0, jnp.int32(0))
    _check_products(port_products, tpu_default)
    assert len(port_products) > 5  # a view's detector beside the clip's (or the set-up's)


def test_turbo_card_reads_as_the_jax_package_reads_it():
    import yaml

    card = yaml.safe_load(TURBO.read_text())
    ours = AwareConfig.from_dict(card)
    ref = JaxConfig.from_dict(card)
    assert ours.matmul_precision == "default" and ours.scan_unroll == 2
    assert ours.num_iterations == 50
    for field in dataclasses.fields(ours):
        if field.name == "detection_net":
            for f in dataclasses.fields(ours.detection_net):
                if f.name != "key_file":
                    assert getattr(ours.detection_net, f.name) == \
                        getattr(ref.detection_net, f.name), f.name
            continue
        if field.name == "use_pallas_roundtrip":
            # the card leaves it unset: True in the port, as the JAX
            # package's load() sets it on a TPU (the JAX default is False)
            continue
        theirs = getattr(ref, field.name)
        mine = getattr(ours, field.name)
        if isinstance(theirs, dict):
            theirs = tuple(sorted(theirs.items()))
        if isinstance(theirs, list):
            theirs = tuple(theirs)
        assert mine == theirs, field.name
    emb, det = aware_tpu_torch.load("turbo", device="cpu")
    assert emb.cfg == ours and det.cfg.matmul_precision == "default"


def test_bench_configuration_loads():
    """bench.py's configuration (matmul_precision "default", scan_unroll 2)."""
    emb, _ = aware_tpu_torch.load(device="cpu", matmul_precision="default", scan_unroll=2)
    assert emb.cfg.matmul_precision == "default" and emb.cfg.scan_unroll == 2


@pytest.mark.parametrize("value", [0, -1, 1.5, True, "2"])
def test_scan_unroll_is_validated(value):
    with pytest.raises(ValueError, match="scan_unroll"):
        AwareConfig(scan_unroll=value)
    with pytest.raises(ValueError, match="scan_unroll"):
        aware_tpu_torch.load(device="cpu", scan_unroll=value)


def _ber(values, bits):
    return np.mean((np.asarray(values) > 0).astype(int) != bits, axis=-1)


def test_turbo_embed_matches_jax_outcome(net, jax_params):
    """50 iterations (the turbo card's) of two 2 s clips on the whole-step
    path, against the JAX package's whole-step kernel in interpret mode."""
    clip = _speechlike(4321)
    clips = np.stack([clip, np.roll(clip, 1234)])
    bits = np.random.default_rng(29).integers(0, 2, (2, 20))
    wm = (2.0 * bits - 1.0).astype(np.float32)
    _, det = aware_tpu_torch.load("turbo", device="cpu")
    cfg = det.cfg
    jax_cfg = JaxConfig.from_card(TURBO).replace(use_pallas_roundtrip=True,
                                                 use_pallas_detector=True,
                                                 use_pallas_iteration=True)
    ref = jax_embed_batch(jax_params, jnp.asarray(clips), jnp.asarray(wm), jax_cfg)
    assert solver.build_problem(det.net, torch.from_numpy(clips), torch.from_numpy(wm),
                                cfg).path == "iteration_step"
    ours = solver.embed_batch(det.net, torch.from_numpy(clips), torch.from_numpy(wm), cfg)
    audio = ours.audio.numpy()
    assert audio.shape == np.asarray(ref.audio).shape and np.all(np.isfinite(audio))
    ours_values = detect_values_batch(det.net, ours.audio, precision="default").numpy()
    assert np.all(_ber(ours_values, bits) == 0.0)
    ref_values = np.stack([np.asarray(jax_detect_values(jax_params, a, matmul_precision="default"))
                           for a in ref.audio])
    assert np.all(_ber(ref_values, bits) == 0.0)
    np.testing.assert_array_less(np.abs(ours.best_loss.numpy() - np.asarray(ref.best_loss)),
                                 LOSS_TOL)
    # detection at "default" reads the JAX detector's bits on the same audio
    on_ref = detect_values_batch(det.net, torch.from_numpy(np.asarray(ref.audio)),
                                 precision="default").numpy()
    assert np.array_equal(on_ref > 0, ref_values > 0)
    assert np.abs(on_ref - ref_values).max() <= BF16_TOL * np.abs(ref_values).max()
    # the service: the turbo handles embed and read back their bits
    out = aware_tpu_torch.embed_watermark(clip, 16000, bits[0], aware_tpu_torch.load(
        "turbo", device="cpu")[0])
    np.testing.assert_array_equal(aware_tpu_torch.detect_watermark(out, 16000, det), bits[0])


def test_setup_products_at_default(net):
    """The set-up's out-of-band frames (``frames_const``, the slab paths'
    y_const comes from them) at "default": the four products of
    bf16-rounded operands, summed in float64 here."""
    from aware_tpu_torch.ops.stft import irfft_basis
    from aware_tpu_torch.ops.windows import get_window

    clips = np.stack([_speechlike(43)[: 40 * HOP]])
    cfg = AwareConfig(use_slab_dft=False, matmul_precision="default")
    pb = solver.build_problem(net, torch.from_numpy(clips), torch.ones(1, 20), cfg)
    assert pb.path == "frames"
    mag, phase = pb.mag[0].numpy(), pb.phase[0].numpy()
    re = (mag * np.cos(phase).astype(np.float32)).astype(np.float32)
    im = (mag * np.sin(phase).astype(np.float32)).astype(np.float32)
    a, b = irfft_basis(1024)
    w = get_window("hann", 1024)
    aw, bw = (a * w[None, :]).astype(np.float32), (b * w[None, :]).astype(np.float32)
    lo, hi = pb.lo, pb.hi
    ref = sum(_bf16(x[rows].T) @ _bf16(basis[rows])
              for x, basis in ((re, aw), (im, bw)) for rows in (slice(0, lo), slice(hi, None)))
    ours = pb.plain.frames_const[0].numpy()
    assert np.abs(ours - ref).max() <= REF_TOL * np.abs(ref).max()


def test_detection_takes_the_cards_precision(net, jax_params, tpu_default, port_products):
    """The service's detection runs the detector at the card's precision,
    its products those of the JAX package's ``detect_values`` site by site."""
    clips = np.stack([_speechlike(44), _speechlike(45)])
    for precision in ("default", "highest"):
        _, det = aware_tpu_torch.load(device="cpu", matmul_precision=precision)
        tpu_default.clear()
        port_products.clear()
        got = det.detect_batch(clips)
        for clip in clips:
            jax_detect_values(jax_params, jnp.asarray(clip), matmul_precision=precision)
        _check_products(port_products, tpu_default, clips=2)
        want = detect_values_batch(det.net, torch.from_numpy(clips), precision=precision)
        np.testing.assert_array_equal(got, want.numpy())
    f32 = detect_values_batch(net, torch.from_numpy(clips), precision="highest")
    bf16 = detect_values_batch(net, torch.from_numpy(clips), precision="default")
    assert not torch.equal(f32, bf16)
