"""The port's host runtime (``aware_tpu_torch/_native``, ``native.py``)
against the JAX package's (``aware_tpu.native``).

The port's library is built here with g++ into ``aware_tpu_torch/_build``;
the JAX package's is its own build.  Both are the same C++ but for the
batch loader's close of a batch, so every decision and sample must agree
exactly: the GMM VAD's per-frame flags and gate, the spectral gate,
``pcm_quantize`` bit for bit, WAV files written by one read by the other.
The loader gives the one-thread batches with four threads on a short final
batch in 20 runs (the JAX package's loader closes such a batch early in
some runs; ``tests/test_native.py::test_batch_loader_deterministic``).
"""

import numpy as np
import pytest

from aware_tpu import native as jn
from aware_tpu.eval import synthesize_speech_clip
from aware_tpu.service.api import _gate_silent
from aware_tpu.config import AwareConfig as JaxConfig
import aware_tpu_torch
from aware_tpu_torch import native as tn
from aware_tpu_torch.service import api as tapi

pytestmark = pytest.mark.skipif(not jn.native_available(),
                                reason="the JAX package's native library is unavailable")


@pytest.fixture(scope="module")
def lib():
    path = tn.build_native()
    assert path.parent == tn.BUILD_DIR and path.name.startswith("libaware_native_")
    assert tn.native_available()
    return tn.get_lib()


def _fixtures(speechlike):
    """tests/test_native.py's GMM fixtures, then 20 seeded clips at 16 and
    at 8 kHz: speech-like ones at levels from -40 to 0 dB, noise, tones."""
    rng = np.random.default_rng(2024)
    sr = 16000
    cases = [
        (speechlike, sr), (speechlike * 0.1, sr), (np.zeros(2 * sr, np.float32), sr),
        ((0.001 * rng.standard_normal(2 * sr)).astype(np.float32), sr),
        ((0.5 * rng.standard_normal(2 * sr)).astype(np.float32), sr),
        ((0.5 * np.sin(2 * np.pi * 1000 * np.arange(2 * sr) / sr)).astype(np.float32), sr),
        (speechlike[::2].copy(), 8000),
    ]
    for seed in range(20):
        r = np.random.default_rng(seed)
        rate = 16000 if seed % 2 else 8000
        n = int(r.integers(rate // 2, 2 * rate))
        kind = seed % 4
        if kind == 0:
            x = synthesize_speech_clip(seed, seconds=n / 16000)[:: 16000 // rate][:n]
        elif kind == 1:
            x = r.standard_normal(n) * 10 ** r.uniform(-4, -0.3)
        elif kind == 2:
            x = np.sin(2 * np.pi * r.uniform(100, 3000) * np.arange(n) / rate) * r.uniform(0.01, 0.9)
        else:
            x = synthesize_speech_clip(seed, seconds=n / 16000)[:: 16000 // rate][:n]
            x = x * 10 ** r.uniform(-2, 0) + r.standard_normal(len(x)) * 1e-3
        cases.append((np.asarray(x, np.float32), rate))
    return cases


def test_gmm_vad_and_gates_match_the_jax_library(lib, speechlike):
    decisions = set()
    for x, sr in _fixtures(speechlike):
        np.testing.assert_array_equal(tn.vad_gmm_flags(x, sr), jn.vad_gmm_flags(x, sr))
        for aggr in (0, 3):
            assert tn.vad_gmm_is_silent(x, sr, aggressiveness=aggr) == \
                jn.vad_gmm_is_silent(x, sr, aggressiveness=aggr)
        assert tn.vad_is_silent(x, sr) == jn.vad_is_silent(x, sr)
        decisions.add(tn.vad_gmm_is_silent(x, sr))
    assert decisions == {True, False}
    with pytest.raises(ValueError):
        tn.vad_gmm_flags(speechlike, 44100)  # not reducible to 8 kHz


def test_gmm_fixtures_read_as_the_jax_suite_says(lib, speechlike):
    """tests/test_native.py:102-126's decisions, on the port's library."""
    rng = np.random.default_rng(7)
    sr = 16000
    assert not tn.vad_gmm_is_silent(speechlike, sr)
    assert not tn.vad_gmm_is_silent(speechlike * 0.1, sr)
    assert tn.vad_gmm_is_silent(np.zeros(2 * sr, np.float32), sr)
    assert tn.vad_gmm_is_silent((0.001 * rng.standard_normal(2 * sr)).astype(np.float32), sr)
    assert not tn.vad_gmm_is_silent((0.5 * rng.standard_normal(2 * sr)).astype(np.float32), sr)


@pytest.mark.parametrize("bits", [8, 12, 16, 24])
def test_pcm_quantize_is_bit_exact(lib, bits):
    x = (np.random.default_rng(bits).standard_normal(5000) * 0.7).astype(np.float32)
    ours, ref = tn.pcm_quantize(x, bits), jn.pcm_quantize(x, bits)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("channels, bits", [(1, 16), (2, 16), (1, 32), (2, 32)])
def test_wav_round_trips_across_the_libraries(lib, tmp_path, channels, bits):
    rng = np.random.default_rng(channels * bits)
    shape = (4000,) if channels == 1 else (4000, channels)
    x = (0.9 * rng.uniform(-1, 1, shape)).astype(np.float32)
    for writer, reader in ((tn.write_wav, jn.read_wav), (jn.write_wav, tn.read_wav),
                           (tn.write_wav, tn.read_wav)):
        path = str(tmp_path / f"{writer.__module__}_{reader.__module__}.wav")
        writer(path, x, 22050, bits=bits)
        y, sr = reader(path)
        ref, sr_ref = jn.read_wav(path)
        assert sr == sr_ref == 22050 and y.shape == x.shape
        np.testing.assert_array_equal(y, ref)
        np.testing.assert_allclose(y, x, atol=1e-7 if bits == 32 else 7e-5)


def _wavs(tmp_path, n):
    files = []
    for i in range(n):
        path = tmp_path / f"clip{i}.wav"
        tn.write_wav(str(path), synthesize_speech_clip(10 + i, seconds=0.25 + 0.05 * i), 16000)
        files.append(str(path))
    return files


def test_batch_loader_is_deterministic_on_a_short_final_batch(lib, tmp_path):
    files = _wavs(tmp_path, 9)  # batches of 4: 4 + 4 + 1
    want = list(tn.BatchLoader(files, 4, 6000, n_threads=1))
    assert [b[3] for b in want] == [4, 4, 1]
    for i, (data, lengths, rates, _) in enumerate(want):
        for slot in range(4):
            k = 4 * i + slot
            if k >= len(files):
                assert not data[slot].any() and lengths[slot] == 0
                continue
            clip, sr = tn.read_wav(files[k])
            n = min(len(clip), 6000)
            assert sr == rates[slot] == 16000 and lengths[slot] == n
            np.testing.assert_array_equal(data[slot, :n], clip[:n])
    for _ in range(20):
        got = list(tn.BatchLoader(files, 4, 6000, n_threads=4))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_batch_loader_hands_out_batches_in_file_order_under_load(lib, tmp_path):
    """37 files in batches of 4 (the last holds one), 8 threads and room
    for one batch, the consumer slow enough that the queue stays full: the
    workers that close batches j and j+1 race for the queue, and the
    batches must still leave in file order, 50 times over."""
    import time

    files = _wavs(tmp_path, 37)
    want = list(tn.BatchLoader(files, 4, 6000, n_threads=1, prefetch=1))
    assert [b[3] for b in want] == [4] * 9 + [1]
    for _ in range(50):
        got = []
        for b in tn.BatchLoader(files, 4, 6000, n_threads=8, prefetch=1):
            got.append(b)
            time.sleep(0.0005)
        assert [b[3] for b in got] == [b[3] for b in want]
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_load_gates_with_the_gmm_vad(lib, speechlike):
    """``load(vad="webrtc_gmm")``: the service's gate is the GMM classifier,
    decided as the JAX package's ``_gate_silent``; a silent clip raises in
    the single-clip embed and passes through under ``on_silent="mask"``
    (the loud-noise lane reads as speech there, as webrtcvad's does)."""
    emb, det = aware_tpu_torch.load(device="cpu", vad="webrtc_gmm", num_iterations=2)
    jcfg = JaxConfig().replace(vad="webrtc_gmm")
    rng = np.random.default_rng(3)
    lanes = np.stack([speechlike, np.zeros_like(speechlike), speechlike * 0.1,
                      (0.5 * rng.standard_normal(len(speechlike))).astype(np.float32)])
    ours = tapi._silent(lanes, 16000, emb)
    ref = np.array([_gate_silent(a, 16000, jcfg) for a in lanes])
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, [False, True, False, False])
    with pytest.raises(ValueError, match="speech"):
        aware_tpu_torch.embed_watermark(lanes[1], 16000, np.ones(20, int), emb)
    out, mask = aware_tpu_torch.embed_watermark_batch(lanes, 16000, np.ones((4, 20), int), emb,
                                                      on_silent="mask")
    np.testing.assert_array_equal(mask, ~ref)
    np.testing.assert_array_equal(out[1], lanes[1, : out.shape[1]])


def test_fallbacks_without_the_library(tmp_path, speechlike, monkeypatch):
    """Without a toolchain: WAV I/O takes utils/io.py, the spectral gate
    ops/vad.py, pcm_quantize the attack suite's; the GMM gate and the loader
    raise, as the JAX package's."""
    ours = {"silent": tn.vad_is_silent(speechlike * 0.001, 16000),
            "pcm": tn.pcm_quantize(speechlike, 16)} if tn.native_available() else None
    monkeypatch.setattr(tn, "get_lib", lambda: None)
    path = str(tmp_path / "fallback.wav")
    tn.write_wav(path, speechlike, 16000)
    y, sr = tn.read_wav(path)
    assert sr == 16000 and np.abs(y - speechlike).max() < 7e-5
    assert tn.vad_is_silent(np.zeros(16000, np.float32), 16000)
    assert not tn.vad_is_silent(speechlike, 16000)
    if ours is not None:
        assert tn.vad_is_silent(speechlike * 0.001, 16000) == ours["silent"]
        np.testing.assert_allclose(tn.pcm_quantize(speechlike, 16), ours["pcm"], atol=1e-6)
    with pytest.raises(RuntimeError, match="no fallback"):
        tn.vad_gmm_is_silent(speechlike, 16000)
    with pytest.raises(RuntimeError):
        tn.BatchLoader([path], 1, 100)
