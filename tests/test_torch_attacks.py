"""The port's attack suite (``aware_tpu_torch/attacks/attacks.py``) against
the JAX package's (``aware_tpu/attacks/attacks.py``), on the CPU.

Each class against the JAX class on the same clip; the random attacks
(DeleteSamples, RandomBandstop, SampleSupression, GaussianNoise) take the
value ``jax.random`` drew for the same key through ``apply_drawn``, since
the port draws from torch.  Tolerances, relative to max|JAX output|: the
PCM quantizer, the cuts and the suppressions exact; the filters, the
resamplers and the noise 1e-5 (float32 in the same order; XLA may
contract into FMAs); the MDCT codec model 1e-4 (measured 1e-5); the
vocoder's stretch and pitch shift 1e-3 (measured 1e-4-2.3e-4: its float32
phase accumulation, tests/test_torch_eot_views.py).  The suite's names and
order equal the JAX suite's; the real MP3 round trip is the JAX package's
bit for bit where the codec libraries load.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aware_tpu.attacks.attacks as ja
from aware_tpu.attacks import default_attack_suite as jax_suite
from aware_tpu.attacks import mp3_real as jax_mp3
import aware_tpu_torch.attacks as pa
from aware_tpu_torch.attacks import mp3_real
from test_torch_slice_detector import _speechlike

SR = 16000
EXACT, FILTER, CODEC, VOCODER = 0.0, 1e-5, 1e-4, 1e-3

DETERMINISTIC = [
    ("PCMBitDepthConversion", (8,), EXACT),
    ("PCMBitDepthConversion", (12,), EXACT),
    ("PCMBitDepthConversion", (16,), EXACT),
    ("PCMBitDepthConversion", (24,), EXACT),
    ("MP3Compression", (9,), CODEC),
    ("MP3Compression", (2,), CODEC),
    ("MP3Compression", (0,), CODEC),
    ("Cropout", (0.1,), EXACT),
    ("TimeStretch", (0.8,), VOCODER),
    ("TimeStretch", (1.1,), VOCODER),
    ("PitchShift", (), VOCODER),
    ("Resample", (), FILTER),
    ("LowPassFilter", (), FILTER),
    ("HighPassFilter", (), FILTER),
    ("SpeedChange", (), FILTER),
    ("SpeedChange", (0.9,), FILTER),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip():
    return _speechlike(11)


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    if tol == EXACT:
        np.testing.assert_array_equal(ours, ref)
    else:
        assert np.abs(ours - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("cls, args, tol", DETERMINISTIC,
                         ids=[f"{c}{a}" for c, a, _ in DETERMINISTIC])
def test_deterministic_attack_matches_jax(clip, cls, args, tol):
    ours_attack, ref_attack = getattr(pa, cls)(*args), getattr(ja, cls)(*args)
    assert ours_attack.name == ref_attack.name
    _close(ours_attack.apply(clip, SR, device="cpu"), ref_attack.apply(clip, SR), tol)


def test_resample_decimation_path_matches_jax(clip):
    """sr a multiple of the target: decimation and linear re-interpolation."""
    _close(pa.Resample(16000).apply(clip, 32000, device="cpu"),
           ja.Resample(16000).apply(clip, 32000), FILTER)


def _jax_key(seed):
    return jax.random.PRNGKey(seed)


def test_delete_samples_with_the_jax_draw(clip):
    for pct in (0.1, 0.15, 0.2):
        ours, ref = pa.DeleteSamples(pct), ja.DeleteSamples(pct)
        n, d = len(clip), int(pct * len(clip))
        start = int(jax.random.randint(_jax_key(7), (), 0, n - d))
        _close(ours.apply_drawn(clip, SR, start), ref.apply(clip, SR, key=7), EXACT)
        assert ours.name == ref.name


def test_sample_supression_with_the_jax_draw(clip):
    for pct in (0.1, 0.25):
        ours, ref = pa.SampleSupression(pct), ja.SampleSupression(pct)
        d = int(pct * SR)
        start = int(jax.random.randint(_jax_key(8), (), 0, len(clip) - d))
        _close(ours.apply_drawn(clip, SR, start), ref.apply(clip, SR, key=8), EXACT)


def test_random_bandstop_with_the_jax_draw(clip):
    clip = clip[:8000]  # the filters' plain loops take a step a sample
    ours, ref = pa.RandomBandstop(), ja.RandomBandstop()
    f_low = float(jax.random.uniform(_jax_key(9), (), minval=ref.min_freq,
                                     maxval=ref.max_freq - ref.band_width))
    _close(ours.apply_drawn(clip, SR, f_low, device="cpu"), ref.apply(clip, SR, key=9), FILTER)
    assert ours.name == ref.name == "bandstop_200Hz"


def test_gaussian_noise_with_the_jax_draw(clip):
    ours, ref = pa.GaussianNoise(20.0), ja.GaussianNoise(20.0)
    noise = np.asarray(jax.random.normal(_jax_key(10), clip.shape))
    _close(ours.apply_drawn(clip, SR, noise, device="cpu"), ref.apply(clip, SR, key=10), FILTER)
    assert ours.name == ref.name


@pytest.mark.parametrize("attack", [pa.DeleteSamples(0.1), pa.SampleSupression(0.1),
                                    pa.RandomBandstop(), pa.GaussianNoise(30.0)],
                         ids=lambda a: a.name)
def test_random_attacks_draw_from_their_key_alone(clip, attack):
    """A seed gives the same result twice, a torch.Generator is taken, the
    global random state is not touched, and no key raises."""
    clip = clip[:4000]
    state = torch.random.get_rng_state()
    a = attack.apply(clip, SR, key=3, device="cpu")
    b = attack.apply(clip, SR, key=3, device="cpu")
    np.testing.assert_array_equal(a, b)
    c = attack.apply(clip, SR, key=torch.Generator().manual_seed(3), device="cpu")
    np.testing.assert_array_equal(a, c)
    assert torch.equal(torch.random.get_rng_state(), state)
    with pytest.raises(ValueError, match="randomized"):
        attack.apply(clip, SR, device="cpu")


def test_draws_lie_where_the_jax_draws_do(clip):
    starts = [pa.DeleteSamples(0.2).draw(clip, SR, k) for k in range(50)]
    assert 0 <= min(starts) and max(starts) < len(clip) - int(0.2 * len(clip))
    bands = [pa.RandomBandstop().draw(clip, SR, k) for k in range(50)]
    assert 300.0 <= min(bands) and max(bands) < 3800.0
    noise = pa.GaussianNoise().draw(clip, SR, 0)
    assert noise.shape == clip.shape and abs(float(noise.std()) - 1.0) < 0.02


@pytest.mark.parametrize("real_mp3", [False, None])
def test_suite_names_and_order_equal_jax(real_mp3):
    if real_mp3 is None and not jax_mp3.available():
        pytest.skip("the MP3 codec libraries do not load here")
    ours = pa.default_attack_suite(real_mp3=real_mp3)
    ref = jax_suite(real_mp3=real_mp3)
    assert len(ours) == 22
    assert [a.name for a in ours] == [a.name for a in ref]
    assert [type(a).__name__ for a in ours] == [type(a).__name__ for a in ref]


def test_real_mp3_without_the_libraries_raises(monkeypatch):
    monkeypatch.setattr(mp3_real, "available", lambda: False)
    with pytest.raises(RuntimeError, match="libmp3lame/libmpg123"):
        pa.default_attack_suite(real_mp3=True)
    assert all(not a.name.startswith("mp3_") for a in pa.default_attack_suite())


def test_mp3_roundtrip_is_the_jax_packages_bit_for_bit(clip):
    if not (mp3_real.available() and jax_mp3.available()):
        pytest.skip("the MP3 codec libraries do not load here")
    for q in (9, 2):
        ours = pa.MP3CompressionReal(q).apply(clip, SR, device="cpu")
        ref = jax_mp3.MP3CompressionReal(q).apply(clip, SR)
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(mp3_real.mp3_roundtrip(clip, SR, quality=q),
                                      jax_mp3.mp3_roundtrip(clip, SR, quality=q))


def test_attacks_on_cuda_without_a_card_raise(clip):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pa.LowPassFilter().apply(clip, SR)


def test_jnp_input_free():
    """The port's attacks take numpy and return float32 numpy."""
    out = pa.PCMBitDepthConversion(16).apply(np.zeros(100, np.float64) + 0.5, SR, device="cpu")
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    assert not isinstance(out, jnp.ndarray)
