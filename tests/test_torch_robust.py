"""The port's desync-robust detection (``aware_tpu_torch/service/robust.py``
and ``DetectorNet.forward_masked``) against the JAX package's
(``aware_tpu/service/robust.py``, ``detector_apply_masked``), on the CPU.

* The masked forward on zero-padded batches equals JAX's masked forward
  and the port's own unpadded forward (2e-5 abs / 1e-4 rel, as
  ``tests/test_robust.py``), the split-half masks too.
* Each lane's compensated length equals the JAX lane's (the masks depend
  on it); the resample lanes' values equal JAX's at 2e-5 / 1e-4.  The
  stretch lanes pass through the float32 phase vocoder, whose phase
  accumulation stands 1.7-2.7e-4 (relative L2) from its float64 value in
  both packages: as in ``tests/test_torch_eot_views.py``, the port's lane
  values are held no farther from the JAX float64 pipeline's than 1.5
  times JAX's float32 lane.
* The search picks the JAX package's (kind, rate) and bits; the
  harness's ``robust=True`` reads the JAX harness's rows.
* The compensation plans of one clip length are built once a stream.
* (slow) A full-solve mark read back after speed changes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aware_tpu.eval.harness as jh
from aware_tpu.attacks import default_attack_suite as jax_suite
from aware_tpu.attacks import vocoder as jax_vocoder
from aware_tpu.config import in_band_bins
from aware_tpu.models.detector import detector_apply, detector_apply_masked
from aware_tpu.models.detector import preprocess_magnitude as jax_preprocess
from aware_tpu.ops.windows import get_window
from aware_tpu.service import robust as jr
from aware_tpu.service.api import load as jax_load
import aware_tpu_torch
import aware_tpu_torch.eval.harness as ph
from aware_tpu_torch.attacks import default_attack_suite
from aware_tpu_torch.models.detector import preprocess_magnitude
from aware_tpu_torch.ops import resample as presample
from aware_tpu_torch.ops.resample import resample_poly
from aware_tpu_torch.service import robust

GRID = (0.9, 0.95, 1.0, 1.05, 1.11)
STRETCH = (0.9, 1.1)
ATOL, RTOL = 2e-5, 1e-4
MSG_BITS = np.array([1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def handles():
    emb, det = aware_tpu_torch.load(device="cpu", num_iterations=30)
    _, jdet = jax_load(num_iterations=1)
    return emb, det, jdet


@pytest.fixture(scope="module")
def marked(handles):
    emb, _, _ = handles
    clip = ph.synthesize_speech_clip(900)
    return aware_tpu_torch.embed_watermark(clip, 16000, MSG_BITS, emb)


def _mags(det, lengths, seed=3):
    cfg = det.cfg
    net = cfg.detection_net
    w = get_window(cfg.window, net.n_fft)
    lo, hi = in_band_bins(net.sample_rate, net.n_fft, cfg.embedding_bands)
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(n).astype(np.float32) for n in lengths]
    return [preprocess_magnitude(torch.from_numpy(x), net.n_fft, cfg.hop_length, w, lo, hi)
            .numpy() for x in xs]


_jax_masked = jax.jit(detector_apply_masked, static_argnums=(3, 4))
_jax_forward = jax.jit(detector_apply, static_argnums=(2, 3))


@pytest.mark.parametrize("pad", [0, 1, 7, 40])
def test_masked_forward_matches_jax_and_the_unpadded_forward(handles, pad):
    _, det, jdet = handles
    mags = _mags(det, (16000, 12000, 9000, 4000))
    t_max = max(m.shape[-1] for m in mags) + pad
    mag_b = np.stack([np.pad(m, ((0, 0), (0, t_max - m.shape[-1]))) for m in mags])
    mask = np.stack([(np.arange(t_max) < m.shape[-1]).astype(np.float32) for m in mags])
    got = det.net.forward_masked(torch.from_numpy(mag_b), torch.from_numpy(mask)).numpy()
    net = jdet.cfg.detection_net
    for i, m in enumerate(mags):
        ref = _jax_masked(jdet.params, jnp.asarray(mag_b[i]), jnp.asarray(mask[i]), net,
                          "highest")
        np.testing.assert_allclose(got[i], np.asarray(ref), atol=ATOL, rtol=RTOL)
        unpadded = det.net(torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got[i], unpadded, atol=ATOL, rtol=RTOL)
        if pad == 0:
            want = np.asarray(_jax_forward(jdet.params, jnp.asarray(m), net, "highest"))
            np.testing.assert_allclose(got[i], want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_split_masks_read_each_half(handles, precision):
    """(H, 3, T) masks: the whole lane and its two halves.  Each readout is
    the JAX masked forward's under the same mask ("highest"), and the
    unpadded forward's on those frames where the initial pool's pairs line
    up with them: the whole lane, the first half, and the second half when
    it starts on an even frame (63 frames: it starts on 31, the pool pairs
    (30, 31) and drops it; 53 frames: on 26).  At "default" the unpadded
    forward is held beside its own spread (:func:`_spread`)."""
    _, det, jdet = handles
    mags = _mags(det, (16000, 13312), seed=5)
    assert [m.shape[-1] for m in mags] == [63, 53]
    t_max = max(m.shape[-1] for m in mags) + 3
    mag_b = np.stack([np.pad(m, ((0, 0), (0, t_max - m.shape[-1]))) for m in mags])
    frames = np.arange(t_max)
    masks = np.array([[frames < t, frames < t // 2, (frames >= t // 2) & (frames < t)]
                      for t in (m.shape[-1] for m in mags)], np.float32)
    got = det.net.forward_masked(torch.from_numpy(mag_b), torch.from_numpy(masks),
                                 precision).numpy()
    assert got.shape == (2, 3, 20)
    net = jdet.cfg.detection_net
    for i, m in enumerate(mags):
        t = m.shape[-1]
        for j, part in enumerate((m, m[:, : t // 2], m[:, t // 2:])):
            if precision == "highest":
                ref = _jax_masked(jdet.params, jnp.asarray(mag_b[i]), jnp.asarray(masks[i, j]),
                                  net, "highest")
                np.testing.assert_allclose(got[i, j], np.asarray(ref), atol=ATOL, rtol=RTOL)
            if j < 2 or (t // 2) % 2 == 0:
                part = np.ascontiguousarray(part)
                want = det.net(torch.from_numpy(part), precision).numpy()
                atol = ATOL if precision == "highest" else max(ATOL, _spread(det, part))
                np.testing.assert_allclose(got[i, j], want, atol=atol, rtol=RTOL)


def _spread(det, mag):
    """How far the "default" (one bf16 pass a product) forward moves when
    its input moves by 1e-6 of itself: the float32 sums of the masked and
    the unpadded forwards differ in order by an ulp, and an ulp flips the
    bf16 rounding of the next product's operand."""
    want = det.net(torch.from_numpy(mag), "default").numpy()
    rng = np.random.default_rng(0)
    moved = [det.net(torch.from_numpy((mag * (1 + 1e-6 * rng.standard_normal(mag.shape)))
                                      .astype(np.float32)), "default").numpy()
             for _ in range(2)]
    return float(max(np.abs(m - want).max() for m in moved))


def test_masked_forward_refuses_overlapping_pools(handles):
    import dataclasses

    _, det, _ = handles
    net = type(det.net)({k: getattr(det.net, k) for k, _ in det.net.named_buffers()
                         if k.startswith("conv")},
                        dataclasses.replace(det.cfg.detection_net, initial_pool_stride=1))
    with pytest.raises(ValueError, match="size==stride"):
        net.forward_masked(torch.zeros(1, 513, 10), torch.ones(1, 10))


def test_lane_lengths_are_the_jax_lengths():
    x = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
    for kind, rates in (("resample", robust.DEFAULT_RATES),
                        ("stretch", robust.DEFAULT_STRETCH_RATES)):
        for rate in rates:
            ours = robust._compensate(torch.from_numpy(x), kind, rate)
            ref = jax.eval_shape(lambda y: jr._compensate(y, kind, rate),
                                 jax.ShapeDtypeStruct(x.shape, jnp.float32))
            assert tuple(ours.shape) == ref.shape, (kind, rate)
    assert robust._rate_fraction(0.78) == jr._rate_fraction(0.78)


@pytest.mark.parametrize("n, rate", [(25600, 1.12), (8000, 1.25)])
def test_stretch_lane_where_the_steps_reach_the_last_frame(n, rate):
    """A stretch whose float steps reach the last frame (51 frames at
    1 / 1.12: numpy's arange gives 57 steps, the last 50.0), where JAX's
    gather clamps the frame after it: the port's values equal JAX's, in
    float64 (``tests/test_torch_eot_views.py``'s tolerance)."""
    x = np.random.default_rng(n).standard_normal(n)
    ours = robust._compensate(torch.from_numpy(x), "stretch", rate).numpy()
    with jax.enable_x64(True):
        ref = np.asarray(jax.jit(lambda y: jr._compensate(y, "stretch", rate))(jnp.asarray(x)))
    assert ref.dtype == np.float64 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def _float64_stretch_lane(jdet, x, rate):
    """The JAX package's stretch lane in float64: the vocoder, the
    magnitude and the unmasked detector."""
    cfg = jdet.cfg
    net = cfg.detection_net
    lo, hi = in_band_bins(net.sample_rate, net.n_fft, cfg.embedding_bands)
    w = get_window(cfg.window, net.n_fft).astype(np.float64)

    @jax.jit
    def lane(params, y):
        mag = jax_preprocess(jax_vocoder.time_stretch(y, 1.0 / rate), net.n_fft,
                             cfg.hop_length, w, lo, hi)
        return detector_apply(params, mag, net, "highest")

    with jax.enable_x64(True):
        params = {k: jnp.asarray(v, jnp.float64) for k, v in jdet.params.items()}
        out = np.asarray(lane(params, jnp.asarray(x, jnp.float64)))
    assert out.dtype == np.float64
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("split", [False, True])
def test_lane_values_match_jax(handles, marked, split):
    _, det, jdet = handles
    fn, jfn = ((robust.robust_values_split, jr.robust_values_split) if split
               else (robust.robust_values, jr.robust_values))
    ours = fn(det, marked, GRID, STRETCH)
    ref = jfn(jdet, marked, GRID, STRETCH)
    assert ours.shape == ref.shape == ((7, 3, 20) if split else (7, 20))
    n = len(GRID)
    np.testing.assert_allclose(ours[:n], ref[:n], atol=ATOL, rtol=RTOL)
    for j, rate in enumerate(STRETCH):
        want = _float64_stretch_lane(jdet, marked, rate)
        got, jax32 = ours[n + j], ref[n + j]
        if split:
            got, jax32 = got[0], jax32[0]
        assert _rel(got, want) <= max(1.5 * _rel(jax32, want), 1e-6), rate
    # the identity lane is the plain detection
    plain = det.detect(marked, 16000)
    ident = ours[GRID.index(1.0)]
    np.testing.assert_allclose(ident[0] if split else ident, plain, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("num, den", [(1, 1), (11, 10)])
def test_search_picks_the_jax_lane(handles, marked, num, den):
    _, det, jdet = handles
    audio = resample_poly(torch.from_numpy(marked), num, den).numpy()
    for refine, margin in ((False, 1.0), (True, 1.9)):
        ours = robust.detect_watermark_robust(audio, 16000, det, GRID, STRETCH, True,
                                              refine, margin)
        ref = jr.detect_watermark_robust(audio, 16000, jdet, GRID, STRETCH, True,
                                         refine, margin)
        assert (ours.kind, ours.rate) == (ref.kind, ref.rate)
        np.testing.assert_array_equal(ours.bits, ref.bits)
        assert abs(ours.confidence - ref.confidence) <= 1e-4 * ref.confidence
    stereo = np.stack([audio, audio], axis=1)
    np.testing.assert_array_equal(
        robust.detect_watermark_robust(stereo, 16000, det, GRID, STRETCH), ours.bits)
    with pytest.raises(ValueError, match="16000"):
        robust.detect_watermark_robust(audio, 44100, det)


def test_a_stream_of_one_length_builds_each_plan_once():
    """Every lane of the coarse grids and of every fine grid around them,
    for one clip length, fits the plan caches: a second pass over all of
    them builds nothing."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4000).astype(np.float32))
    hyps = robust._hypotheses(robust.DEFAULT_RATES, robust.DEFAULT_STRETCH_RATES)
    hyps += tuple((kind, round(rate * f, 4)) for kind, rate in hyps if rate != 1.0
                  for f in robust.REFINE_FACTORS)
    from aware_tpu_torch.attacks import vocoder
    from aware_tpu_torch.ops import stft

    caches = (presample._polyphase_plan, presample._g_tensor, vocoder._plan,
              stft.device_envelope)

    def run():
        for kind, rate in hyps:
            robust._compensate(x, kind, rate)
        return [c.cache_info().misses for c in caches]

    run()
    first = run()
    assert run() == first


def test_harness_robust_reads_the_jax_rows(handles, marked, monkeypatch):
    """``run_robustness_eval(robust=True)``: the same marked clip through
    both harnesses' robust detection (on the test's grid), clean, after
    PCM quantization and after a stretch."""
    import functools

    emb, det, _ = handles
    monkeypatch.setattr(ph, "embed_watermark", lambda *a: marked)
    monkeypatch.setattr(jh, "embed_watermark", lambda *a: marked)
    for mod in (robust, jr):  # the harnesses import it when robust=True
        monkeypatch.setattr(mod, "detect_watermark_robust", functools.partial(
            mod.detect_watermark_robust, rates=GRID, stretch_rates=STRETCH))
    names = ("pcm_16", "ts_0.9")
    ours_attacks = [a for a in default_attack_suite() if a.name in names]
    ref_attacks = [a for a in jax_suite() if a.name in names]
    assert [a.name for a in ours_attacks] == [a.name for a in ref_attacks] == list(names)
    ours = ph.run_robustness_eval(n_clips=1, seed=900, attacks=ours_attacks, model=(emb, det),
                                  robust=True)
    ref = jh.run_robustness_eval(n_clips=1, seed=900, attacks=ref_attacks,
                                 model=jax_load(num_iterations=1), robust=True)
    assert set(ours) == set(ref)
    for key in ("clean_ber",) + tuple(f"ber:{a.name}" for a in ref_attacks):
        assert ours[key] == ref[key], key


@pytest.mark.slow
@pytest.mark.parametrize("num, den", [(21, 20), (9, 10), (11, 10)])
def test_recovers_bits_after_speed_change(num, den):
    """tests/test_robust.py's gates on a full 400-iteration port embed."""
    emb, det = aware_tpu_torch.load(device="cpu")
    from aware_tpu_torch.models.detector import detect_values

    clip = ph.synthesize_speech_clip(901)
    wm = aware_tpu_torch.embed_watermark(clip, 16000, MSG_BITS, emb)
    sped = resample_poly(torch.from_numpy(wm), num, den)
    naive = detect_values(det.net, sped).numpy()
    assert float(np.mean((naive > 0).astype(int) != MSG_BITS)) * 100 > 20.0
    res = robust.detect_watermark_robust(sped.numpy(), 16000, det, rates=GRID,
                                         stretch_rates=(), return_confidence=True)
    assert float(np.mean(res.bits != MSG_BITS)) == 0.0
    assert res.kind == "resample"
    assert abs(res.rate - den / num) < 0.06
