"""The port's host codecs (``aware_tpu_torch/attacks/voice_codecs.py``,
``av_codecs.py``, ``soxr_real.py`` and the port's copy of the libavcodec
shim, ``_native/aware_codecs.cc``) against the JAX package's, on the CPU.

* Every round trip equals the JAX function's output bit for bit on the
  same seeded 1.5 s clip: ``opus_roundtrip`` at 8, 16 and 32 kb/s, voip
  and audio; ``gsm_roundtrip`` at 16 and 8 kHz; ``soxr_roundtrip``
  through 44.1 and 8 kHz; ``avc_roundtrip`` for each of the extended
  suite's libavcodec codecs (aac, libvorbis, libspeex, g722); ``_align``
  on a shifted copy.  Both packages call the same system libraries on the
  same float32 input, so nothing but a difference in the glue can differ.
* ``extended_attack_suite()`` names the JAX rows in the JAX order; the
  attack classes keep the JAX names and take the port's ``device``; the
  attacks package exports every name the JAX one does.
* The error paths are the JAX ones: a rate Opus does not support, an
  unknown libavcodec codec, a library that does not load (``_load_first``
  monkeypatched to return None in both packages), and the port's shim
  that cannot be built.

Each test skips only where the system library is absent, decided inside
the test.  The JAX shim is built by g++ into a temporary directory and
given to ``aware_tpu.attacks.av_codecs`` through ``_LIB_PATH``, never by
the JAX package's ``make`` in its own directory.
"""

import shutil
import subprocess

import numpy as np
import pytest

import aware_tpu.attacks.av_codecs as jav
import aware_tpu.attacks.soxr_real as jsx
import aware_tpu.attacks.voice_codecs as jvc
from aware_tpu_torch.attacks import av_codecs as av
from aware_tpu_torch.attacks import soxr_real as sx
from aware_tpu_torch.attacks import voice_codecs as vc
from aware_tpu_torch.native import BUILD_DIR

SR = 16000
AVC_ROWS = {"aac": (64000, -1.0), "libvorbis": (0, 3.0), "libspeex": (0, -1.0),
            "g722": (64000, -1.0)}


@pytest.fixture(scope="module")
def clip() -> np.ndarray:
    """A seeded 1.5 s speech-like clip: harmonics of a wobbling f0 under a
    syllabic envelope, plus noise."""
    rng = np.random.default_rng(22)
    t = np.arange(int(1.5 * SR)) / SR
    phase = np.cumsum(2 * np.pi * (130.0 + 25.0 * np.sin(2 * np.pi * 2.1 * t)) / SR)
    x = sum(np.cos(k * phase + rng.uniform(0, 6.28)) / k for k in range(1, 20))
    x = x * (0.3 + 0.7 * np.clip(np.sin(2 * np.pi * 3.3 * t), 0, None))
    x = x + 0.02 * rng.standard_normal(len(t))
    return (0.9 * x / np.max(np.abs(x))).astype(np.float32)


def _need(ok: bool, lib: str) -> None:
    if not ok:
        pytest.skip(f"{lib} is not installed on this machine")


@pytest.fixture(scope="module")
def jax_shim(tmp_path_factory):
    """The JAX package's libavcodec shim, built by g++ into a temporary
    directory and bound through its ``_LIB_PATH``; None where it cannot
    be built here."""
    out = tmp_path_factory.mktemp("jax_shim") / "libaware_codecs.so"
    src = jav._NATIVE_DIR / "aware_codecs.cc"
    cxx = shutil.which("g++")
    if cxx is None or subprocess.run(
            [cxx, "-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared", "-o", str(out),
             str(src), "-lavcodec", "-lavutil", "-lswresample"],
            capture_output=True).returncode != 0:
        yield None
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jav, "_LIB_PATH", out)
        jav._lib.cache_clear()
        yield jav
    jav._lib.cache_clear()


@pytest.mark.parametrize("voip", [True, False], ids=["voip", "audio"])
@pytest.mark.parametrize("kbps", [8, 16, 32])
def test_opus_roundtrip_matches_jax(clip, kbps, voip):
    _need(vc.opus_available(), "libopus")
    ours = vc.opus_roundtrip(clip, SR, kbps * 1000, voip)
    assert ours.shape == clip.shape and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jvc.opus_roundtrip(clip, SR, kbps * 1000, voip))


@pytest.mark.parametrize("sr", [16000, 8000])
def test_gsm_roundtrip_matches_jax(clip, sr):
    _need(vc.gsm_available(), "libgsm")
    x = clip if sr == SR else vc.gsm_resample(clip, SR, sr)
    ours = vc.gsm_roundtrip(x, sr)
    assert ours.shape == x.shape and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jvc.gsm_roundtrip(x, sr))


@pytest.mark.parametrize("rate", [44100, 8000])
def test_soxr_roundtrip_matches_jax(clip, rate):
    _need(sx.soxr_available(), "libsoxr")
    ours = sx.soxr_roundtrip(clip, SR, rate)
    assert ours.shape == clip.shape and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jsx.soxr_roundtrip(clip, SR, rate))
    np.testing.assert_array_equal(sx.soxr_resample(clip, SR, rate),
                                  jsx.soxr_resample(clip, SR, rate))


@pytest.mark.parametrize("codec", list(AVC_ROWS))
def test_avc_roundtrip_matches_jax(clip, codec, jax_shim):
    _need(av.avc_available(codec), f"libavcodec with {codec}")
    assert jax_shim is not None and jax_shim.avc_available(codec)
    bitrate, q = AVC_ROWS[codec]
    ours = av.avc_roundtrip(clip, SR, codec, bitrate, q)
    assert ours.shape == clip.shape and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jax_shim.avc_roundtrip(clip, SR, codec, bitrate, q))


@pytest.mark.parametrize("shift", [137, -59])
def test_align_matches_jax_on_a_shifted_copy(clip, shift):
    moved = np.roll(clip, shift)
    ours = vc._align(moved, clip)
    np.testing.assert_array_equal(ours, jvc._align(moved, clip))
    inner = slice(abs(shift), len(clip) - abs(shift))
    np.testing.assert_array_equal(ours[inner], clip[inner])
    # a shorter decode is padded to the reference's length, as in JAX
    np.testing.assert_array_equal(vc._align(clip[:-300], clip), jvc._align(clip[:-300], clip))


def test_extended_suite_names_the_jax_rows_in_order():
    ours = [a.name for a in vc.extended_attack_suite()]
    assert ours == [a.name for a in jvc.extended_attack_suite()]
    left_out = dict(vc.extended_rows_left_out())
    assert len(ours) + len(left_out) == 22 + 11
    assert not set(ours) & set(left_out)


def test_attack_classes_keep_the_jax_names_and_take_a_device(clip, jax_shim):
    rows = []
    if vc.opus_available():
        rows.append((vc.OpusCompression(16000), lambda x: vc.opus_roundtrip(x, SR, 16000)))
    if vc.gsm_available():
        rows.append((vc.GSMFullRate(), lambda x: vc.gsm_roundtrip(x, SR)))
    if sx.soxr_available():
        rows.append((sx.SoxrResample(8000), lambda x: sx.soxr_roundtrip(x, SR, 8000)))
    if av.avc_available("g722"):
        rows.append((av.G722Telephony(), lambda x: av.avc_roundtrip(x, SR, "g722", 64000)))
    _need(bool(rows), "any host codec library")
    for attack, roundtrip in rows:
        np.testing.assert_array_equal(attack.apply(clip, SR, key=3, device="cpu"),
                                      roundtrip(clip))
    names = {"aac_32k": lambda: av.AACCompression(32), "vorbis_q3": av.VorbisCompression,
             "speex_wb": av.SpeexWideband, "g722": av.G722Telephony,
             "opus_8k": lambda: vc.OpusCompression(8000), "gsm_fr": vc.GSMFullRate,
             "soxr_44100": sx.SoxrResample}
    for name, make in names.items():
        try:
            assert make().name == name
        except RuntimeError:  # its library is absent here
            pass


def test_opus_rejects_a_rate_it_does_not_support(clip):
    _need(vc.opus_available(), "libopus")
    for fn in (vc.opus_roundtrip, jvc.opus_roundtrip):
        with pytest.raises(ValueError, match="Opus supports"):
            fn(clip, 44100)


def test_an_unknown_avc_codec_raises(clip, jax_shim):
    _need(av.avc_available(), "libavcodec")
    assert not av.avc_available("no_such_codec") and not jax_shim.avc_available("no_such_codec")
    assert "no 'no_such_codec'" in av.avc_unavailable_reason("no_such_codec")
    for mod in (av, jax_shim):
        with pytest.raises(RuntimeError, match="avc roundtrip failed for 'no_such_codec'"):
            mod.avc_roundtrip(clip, SR, "no_such_codec")


@pytest.fixture
def no_libraries(monkeypatch):
    """``_load_first`` returning None in both packages, and the libraries'
    caches cleared before and after."""
    caches = (vc._opus, vc._gsm, sx._soxr, jvc._opus, jvc._gsm, jsx._soxr)
    for mod in (vc, sx, jvc, jsx):
        monkeypatch.setattr(mod, "_load_first", lambda names: None)
    for cache in caches:
        cache.cache_clear()
    yield
    monkeypatch.undo()
    for cache in caches:
        cache.cache_clear()


@pytest.mark.parametrize("lib, make, call, message", [
    ("libopus", "OpusCompression", lambda m, x: m.opus_roundtrip(x, SR), "libopus"),
    ("libgsm", "GSMFullRate", lambda m, x: m.gsm_roundtrip(x, SR), "libgsm"),
    ("libsoxr", "SoxrResample", lambda m, x: m.soxr_roundtrip(x, SR, 8000), "libsoxr"),
])
def test_a_missing_library_raises_as_in_jax(clip, no_libraries, lib, make, call, message):
    messages = []
    for mod in (vc, jvc) if lib != "libsoxr" else (sx, jsx):
        assert not getattr(mod, f"{lib[3:]}_available")()
        with pytest.raises(RuntimeError, match=message) as at_call:
            call(mod, clip)
        with pytest.raises(RuntimeError, match=message) as at_make:
            getattr(mod, make)()
        messages.append((str(at_call.value), str(at_make.value)))
    assert messages[0] == messages[1]  # the JAX messages
    rows = [a.name for a in vc.extended_attack_suite()]
    assert rows == [a.name for a in jvc.extended_attack_suite()]
    causes = dict(vc.extended_rows_left_out())
    for name in ("opus_32k", "opus_16k", "opus_8k", "gsm_fr", "soxr_44100", "soxr_8000"):
        assert name not in rows and name in causes


def test_a_shim_that_cannot_build_leaves_its_rows_out(monkeypatch):
    def fail():
        raise RuntimeError("g++ failed (1):\nx.cc:25:10: fatal error: libavcodec/avcodec.h: No such "
                           "file or directory\ncompilation terminated.")

    monkeypatch.setattr(av, "build_codecs", fail)
    av._load.cache_clear()
    try:
        assert not av.avc_available() and not av.avc_available("aac")
        assert "avcodec.h" in av.avc_unavailable_reason("aac")
        with pytest.raises(RuntimeError, match="unavailable"):
            av.AACCompression(64)
        with pytest.raises(RuntimeError, match="libaware_codecs.so unavailable"):
            av.avc_roundtrip(np.zeros(160, np.float32), SR, "g722")
        causes = dict(vc.extended_rows_left_out())
        rows = [a.name for a in vc.extended_attack_suite()]
        for name in ("aac_64k", "aac_32k", "vorbis_q3", "speex_wb", "g722"):
            assert name not in rows and "avcodec.h" in causes[name]
    finally:
        av._load.cache_clear()


def test_the_shim_builds_under_a_hashed_name():
    _need(av.avc_available(), "libavcodec with its headers")
    path = av.build_codecs()
    assert path.parent == BUILD_DIR and path.name.startswith("libaware_codecs_")
    assert av.build_codecs() == path  # built once, then found


def test_the_attacks_package_exports_every_jax_name():
    import aware_tpu.attacks as jax_attacks
    import aware_tpu_torch.attacks as attacks

    assert set(jax_attacks.__all__) <= set(attacks.__all__)
    for name in attacks.__all__:
        assert getattr(attacks, name) is not None
    assert attacks.extended_attack_suite is vc.extended_attack_suite
    assert attacks.avc_roundtrip is av.avc_roundtrip
