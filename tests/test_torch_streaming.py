"""The port's streaming localization (``aware_tpu_torch/service/streaming.py``)
against the JAX package's (``aware_tpu/service/streaming.py``), on the CPU.

* Per-window values against JAX ``detect_values`` on the same windows
  (2e-5 abs / 1e-4 rel); the auto threshold (``_calibrate_null``) to 1e-5
  relative.
* Segment grouping (bridge, confirm, weighted vote, bit agreement) equal
  to JAX's on patched window values, as ``tests/test_streaming_service.py``.
* At most ``IN_FLIGHT`` window batches are sent and not read back.
* ``detect_file``, ``detect_watermark_streaming``; ``detect_global`` raises.
* (slow) A 2 s mark in 20 s of speech is found and read, as the JAX test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aware_tpu.models.detector import detect_values_batch_jit
from aware_tpu.service import streaming as js
from aware_tpu.service.api import load as jax_load
import aware_tpu_torch
from aware_tpu_torch.eval.harness import synthesize_speech_clip
from aware_tpu_torch.service import streaming
from aware_tpu_torch.utils.io import write_wav

ATOL, RTOL = 2e-5, 1e-4
BITS = np.array([1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1])


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
    _, det = aware_tpu_torch.load(device="cpu", num_iterations=1)
    _, jdet = jax_load(num_iterations=1)
    return det, jdet


@pytest.fixture(scope="module")
def carrier():
    """10 s of unwatermarked speech fixtures."""
    return np.concatenate([synthesize_speech_clip(50 + i) for i in range(5)])


def test_window_values_match_jax(handles, carrier):
    det, jdet = handles
    sd = streaming.StreamingDetector(det, hop_seconds=0.5, batch_windows=5, threshold=0.5)
    starts = np.arange(0, len(carrier) - sd.window + 1, sd.hop)
    ours = sd._values_for_windows(carrier, starts)
    assert ours.shape == (17, 20)
    cfg = jdet.cfg
    wins = np.stack([carrier[s : s + sd.window] for s in starts])
    ref = np.asarray(detect_values_batch_jit(
        jdet.params, jnp.asarray(wins), cfg.detection_net, hop_length=cfg.hop_length,
        window=cfg.window, win_length=cfg.win_length, embedding_bands=cfg.embedding_bands,
        matmul_precision=cfg.matmul_precision))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)
    res = sd.detect(carrier, 16000)
    np.testing.assert_array_equal(res.values, ours)
    np.testing.assert_allclose(res.window_starts, starts / 16000)


def test_auto_threshold_matches_jax(handles):
    det, jdet = handles
    ours = streaming.StreamingDetector(det)
    ref = js.StreamingDetector(jdet)
    for name in ("threshold", "strong_threshold", "_null_mean", "_null_std"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert abs(a - b) <= 1e-5 * abs(b), (name, a, b)


def _patched(detector, vals, module):
    """A detector of ``module`` whose window values are ``vals``, so that
    the grouping alone is tested (tests/test_streaming_service.py:74)."""
    sd = module.StreamingDetector(detector, threshold=0.5, min_run=2)
    sd.strong_threshold = 0.9
    sd._values_for_windows = lambda audio, starts: vals[: len(starts)]
    audio = np.zeros(sd.window + (len(vals) - 1) * sd.hop, np.float32)
    return sd.detect(audio, sd.sr)


def _cases():
    rng = np.random.default_rng(4)
    a = np.full((12, 20), 0.01, np.float32)
    a[1] = 0.6      # isolated hit below the strong bar: rejected
    a[7:9] = 0.7    # a 2-window run: kept
    b = np.full((10, 20), 0.01, np.float32)
    b[3] = 0.95     # isolated but strong: kept
    c = np.full((12, 20), 0.01, np.float32)
    c[4] = 0.6      # two fragments 2 windows apart: one segment
    c[7:9] = 0.7
    d = (0.2 * rng.standard_normal((40, 20))).astype(np.float32)
    d[10:14] += 0.7 * (2 * BITS - 1)  # a signed mark, some windows disagreeing
    d[30] = -0.95
    return [a, b, c, d]


@pytest.mark.parametrize("case", range(4))
def test_grouping_matches_jax(handles, case):
    det, jdet = handles
    vals = _cases()[case]
    ours, ref = _patched(det, vals, streaming), _patched(jdet, vals, js)
    assert ours.rejected_segments == ref.rejected_segments
    assert len(ours.segments) == len(ref.segments) > 0
    for a, b in zip(ours.segments, ref.segments):
        assert (a.start_seconds, a.end_seconds, a.n_windows) == \
            (b.start_seconds, b.end_seconds, b.n_windows)
        assert a.confidence == pytest.approx(b.confidence, rel=1e-6)
        assert a.bit_agreement == pytest.approx(b.bit_agreement, rel=1e-6)
        np.testing.assert_array_equal(a.bits, b.bits)
    np.testing.assert_array_equal(ours.best_bits, ref.best_bits)
    assert ours.detected == ref.detected


def test_in_flight_batches_are_bounded(handles, carrier, monkeypatch):
    """Every batch sent finds at most IN_FLIGHT - 1 earlier ones not yet
    read back, and the values come back in window order."""
    det, _ = handles
    sd = streaming.StreamingDetector(det, hop_seconds=0.25, batch_windows=3, threshold=0.5)
    unread: list = []
    sent = []

    class Pending:
        def __init__(self, values):
            self.values = values
            unread.append(self)

        def cpu(self):
            unread.remove(self)
            return self

        def numpy(self):
            return self.values.numpy()

    real = sd._batched

    def batched(windows):
        assert len(unread) < streaming.IN_FLIGHT
        sent.append(len(windows))
        return Pending(real(windows))

    monkeypatch.setattr(sd, "_batched", batched)
    starts = np.arange(0, len(carrier) - sd.window + 1, sd.hop)
    got = sd._values_for_windows(carrier, starts)
    assert sum(sent) == len(starts) and len(sent) == 11 and not unread
    monkeypatch.undo()
    np.testing.assert_allclose(got, sd._values_for_windows(carrier, starts), atol=1e-6)


def test_file_and_one_call_paths(handles, carrier, tmp_path):
    det, _ = handles
    path = str(tmp_path / "null.wav")
    write_wav(path, carrier, 16000)
    sd = streaming.StreamingDetector(det)
    res = sd.detect_file(path)
    assert not res.detected and res.values.shape == (9, 20)
    one = streaming.detect_watermark_streaming(carrier, 16000, det)
    assert one.threshold == sd.threshold and not one.detected
    np.testing.assert_allclose(res.values, one.values, atol=1e-4)
    # another rate is resampled to the model's; short audio is padded
    short = sd.detect(carrier[:8000], 16000)
    assert short.values.shape == (1, 20)
    assert sd.detect(carrier[: 3 * 8000], 8000).values.shape == (2, 20)  # 3 s


def test_detect_global_is_not_ported(handles):
    det, _ = handles
    with pytest.raises(ValueError, match="mesh"):
        streaming.StreamingDetector(det, threshold=0.1).detect_global(np.zeros(100), 16000)
    with pytest.raises(NotImplementedError, match="parallel/streaming.py"):
        streaming.StreamingDetector(det, threshold=0.1, mesh=object()).detect_global(
            np.zeros(100), 16000)


@pytest.mark.slow
def test_localizes_a_marked_span():
    """tests/test_streaming_service.py's 20 s carrier with a 2 s mark at
    9 s (a 120-iteration port embed): found, overlapping, decoded."""
    emb, det = aware_tpu_torch.load(device="cpu", num_iterations=120)
    carrier = np.concatenate([synthesize_speech_clip(50 + i) for i in range(10)])
    wm = emb.embed(synthesize_speech_clip(99), 16000, (2 * BITS - 1).astype(np.float32))
    start = 9 * 16000
    wm = wm * (np.max(np.abs(carrier[start : start + len(wm)])) + 1e-9)
    clip = carrier.copy()
    clip[start : start + len(wm)] = wm
    res = streaming.StreamingDetector(det, hop_seconds=0.5).detect(clip, 16000)
    assert res.detected
    best = max(res.segments, key=lambda s: s.confidence)
    assert best.start_seconds < 9 + len(wm) / 16000 and best.end_seconds > 9
    np.testing.assert_array_equal(np.asarray(best.bits).astype(int), BITS)
    null = np.concatenate([synthesize_speech_clip(200 + i) for i in range(5)])
    assert not streaming.StreamingDetector(det).detect(null, 16000).detected
