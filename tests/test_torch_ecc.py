"""The port's ECC message layer (``aware_tpu_torch/service/ecc.py``)
against the JAX package's (``aware_tpu/service/ecc.py``), on the CPU.

The code search is seeded numpy in both, so the generators, minimum
distances and codebooks must come out bit for bit, for k = 1..14 at the
detector's n = 20 and at n = 16.  Decodes of the same seeded soft values
give the same message, and score, margin and p-value to 1e-6 relative;
likewise the window-summed decode (with and without ``top``) and the
robust lane choice.  The service wrappers run through the port's API on
a 30-iteration embed, whose values the JAX detector reads as well.
"""

import numpy as np
import pytest
import torch

from aware_tpu.service import ecc as jecc
from aware_tpu.service.api import load as jax_load
import aware_tpu_torch
from aware_tpu_torch.eval.harness import synthesize_speech_clip
from aware_tpu_torch.service import ecc

REL = 1e-6
MSG = np.array([1, 0, 1, 1, 0, 1, 0, 1])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_result(ours, ref):
    np.testing.assert_array_equal(ours.msg_bits, ref.msg_bits)
    np.testing.assert_array_equal(ours.slot_bits, ref.slot_bits)
    for name in ("score", "margin", "pvalue"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert abs(a - b) <= REL * max(abs(b), 1e-30), (name, a, b)


@pytest.mark.parametrize("n", [20, 16])
@pytest.mark.parametrize("k", range(1, 15))
def test_code_is_the_jax_code(k, n):
    ours, ref = ecc.get_code(k, n), jecc.get_code(k, n)
    assert ours.d_min == ref.d_min
    np.testing.assert_array_equal(ours.G, ref.G)
    np.testing.assert_array_equal(ours.codebook, ref.codebook)
    assert ours.codebook.dtype == ref.codebook.dtype == np.float32
    msg = np.random.default_rng(k + 100 * n).integers(0, 2, k)
    np.testing.assert_array_equal(ecc.encode_message(msg, n), jecc.encode_message(msg, n))


@pytest.mark.parametrize("k", [1, 4, 8, 12, 14])
def test_decode_is_the_jax_decode(k):
    rng = np.random.default_rng(k)
    code = ecc.get_code(k)
    for trial in range(4):
        slots = code.encode(rng.integers(0, 2, k))
        # soft tanh-like values at growing noise; the last trial no mark
        noise = (0.3, 0.8, 1.5, 50.0)[trial]
        values = np.tanh((2.0 * slots - 1.0) * 0.4 + noise * 0.4 * rng.standard_normal(20))
        _same_result(ecc.decode_message(values, k), jecc.decode_message(values, k))


def test_window_decode_is_the_jax_decode():
    rng = np.random.default_rng(7)
    slots = ecc.encode_message(MSG)
    values = 0.9 * rng.standard_normal((30, 20)).astype(np.float32)
    values[10:16] += 0.6 * (2.0 * slots - 1.0)
    for top in (0, 6, 40):
        _same_result(ecc.decode_message_windows(values, 8, top=top),
                     jecc.decode_message_windows(values, 8, top=top))
    with pytest.raises(ValueError):
        ecc.decode_message_windows(values[0], 8)


@pytest.mark.parametrize("margin", [1.0, 1.9])
def test_best_lane_is_the_jax_choice(margin):
    rng = np.random.default_rng(11)
    code = ecc.get_code(8)
    lanes = 0.3 * rng.standard_normal((9, 20)).astype(np.float32)
    lanes[6] += 0.5 * (2.0 * code.encode(MSG) - 1.0)
    for ident in (None, 4):
        best, res = ecc._best_lane(lanes, code, ident, margin)
        best_ref, res_ref = jecc._best_lane(lanes, jecc.get_code(8), ident, margin)
        assert best == best_ref
        _same_result(res, res_ref)


def test_invalid_sizes_raise_as_in_jax():
    for k, n in ((0, 20), (15, 20), (12, 10)):
        with pytest.raises(ValueError):
            ecc.get_code(k, n)
        with pytest.raises(ValueError):
            jecc.get_code(k, n)
    with pytest.raises(ValueError):
        ecc.get_code(8).encode(np.ones(7))
    with pytest.raises(ValueError):
        ecc.get_code(8).decode(np.ones(19))


@pytest.fixture(scope="module")
def marked():
    emb, det = aware_tpu_torch.load(device="cpu", num_iterations=30)
    clip = synthesize_speech_clip(900)
    return clip, emb, det, ecc.embed_message(clip, 16000, MSG, emb)


def test_embed_message_is_the_codeword_embed(marked):
    clip, emb, _, wm = marked
    want = aware_tpu_torch.embed_watermark(clip, 16000, ecc.encode_message(MSG, 20), emb)
    np.testing.assert_array_equal(wm, want)


def test_detect_message_reads_as_the_jax_detector(marked):
    """The port's detect_message and the JAX package's on the same marked
    clip, mono and stereo (the per-slot abs-max merge)."""
    _, _, det, wm = marked
    _, jdet = jax_load(num_iterations=1)
    stereo = np.stack([wm, 0.3 * wm[::-1]], axis=1)
    for audio in (wm, stereo):
        ours = ecc.detect_message(audio, 16000, det, 8)
        ref = jecc.detect_message(audio, 16000, jdet, 8)
        np.testing.assert_array_equal(ours.msg_bits, MSG)
        np.testing.assert_array_equal(ours.msg_bits, ref.msg_bits)
        # the values agree to the detector's float tolerance, not bit for bit
        assert abs(ours.score - ref.score) <= 1e-4 * abs(ref.score)
        assert abs(ours.margin - ref.margin) <= 1e-3 * abs(ref.margin) + 1e-4


def test_detect_message_robust_picks_the_jax_lane(marked):
    _, _, det, wm = marked
    _, jdet = jax_load(num_iterations=1)
    grid, stretch = (0.95, 1.0, 1.05), (0.9,)
    for margin in (1.0, 1.9):
        ours, kind, rate = ecc.detect_message_robust(wm, 16000, det, 8, grid, stretch, margin)
        ref, jkind, jrate = jecc.detect_message_robust(wm, 16000, jdet, 8, grid, stretch, margin)
        assert (kind, rate) == (jkind, jrate) == ("resample", 1.0)
        np.testing.assert_array_equal(ours.msg_bits, ref.msg_bits)
        np.testing.assert_array_equal(ours.msg_bits, MSG)
    with pytest.raises(ValueError, match="16000"):
        ecc.detect_message_robust(wm, 8000, det, 8)
