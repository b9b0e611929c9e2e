"""The port's eval harness (``aware_tpu_torch/eval``) and WAV I/O against
the JAX package's, on the CPU.

* The attack-and-detect sweep: one watermarked clip (embedded once, by
  the port) handed to both harnesses in place of their embeds, through the
  deterministic attacks of the 22-attack suite (the PCM, MP3, stretch,
  pitch, resample and filter rows): each ``ber:`` row the JAX harness's,
  but for bits whose JAX detector value lies within 1e-4 of the
  threshold, each worth 5 % of a row; the two harnesses' key sets equal.
* A tiny harness run (5 iterations, one clip, three attacks, a random one
  among them) gives that key set; a clip that the embed's VAD gate rejects
  is skipped as in the JAX harness.
* The WAV-directory path (a 44.1 kHz file resampled to 16 kHz), and WAV
  I/O read back as the JAX package's reader reads it.
* (slow) The CLI on the CPU with the 22-attack suite.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aware_tpu.eval.harness as jh
import aware_tpu_torch
import aware_tpu_torch.eval.harness as ph
from aware_tpu.attacks import default_attack_suite as jax_suite
from aware_tpu.models import detect_values as jax_detect_values
from aware_tpu.models import init_params
from aware_tpu.service.api import load as jax_load
from aware_tpu.utils.io import read_wav as jax_read_wav
from aware_tpu_torch.attacks import default_attack_suite
from aware_tpu_torch.utils.io import read_wav, write_wav

SR = 16000
EXEMPT = 1e-4  # |JAX detector value| below which a bit may read either way
RANDOM = ("delete_", "bandstop_", "sample_supression_")
BASE_KEYS = {"clean_ber", "pesq", "pesq_proxy", "stoi", "snr"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def marked():
    """One fixture clip, its message (the harness's first draw for seed 0)
    and its watermarked audio from a 30-iteration port embed."""
    clip = ph.synthesize_speech_clip(0)
    bits = np.random.default_rng(0).integers(0, 2, size=20, dtype=np.int32)
    emb, _ = aware_tpu_torch.load(device="cpu", num_iterations=30)
    return clip, bits, aware_tpu_torch.embed_watermark(clip, SR, bits, emb)


def _deterministic(suite):
    return [a for a in suite if not a.name.startswith(RANDOM)]


def test_clip_fixture_equals_jax():
    for seed in (0, 3):
        np.testing.assert_array_equal(ph.synthesize_speech_clip(seed),
                                      jh.synthesize_speech_clip(seed))


def test_sweep_reads_the_jax_harness_bits(marked, monkeypatch):
    clip, bits, wm = marked
    monkeypatch.setattr(ph, "embed_watermark", lambda *a: wm)
    monkeypatch.setattr(jh, "embed_watermark", lambda *a: wm)
    ours_attacks = _deterministic(default_attack_suite())
    ref_attacks = _deterministic(jax_suite())
    assert [a.name for a in ours_attacks] == [a.name for a in ref_attacks]
    assert len(ours_attacks) == 16
    ours = ph.run_robustness_eval(n_clips=1, seed=0, attacks=ours_attacks,
                                  model=aware_tpu_torch.load(device="cpu"))
    ref = jh.run_robustness_eval(n_clips=1, seed=0, attacks=ref_attacks,
                                 model=jax_load(num_iterations=1))
    assert set(ours) == set(ref) == BASE_KEYS | {f"ber:{a.name}" for a in ref_attacks}
    params = {k: jnp.asarray(v) for k, v in init_params(jax_load()[0].cfg.detection_net).items()}
    for j, attack in enumerate(ref_attacks):
        attacked = attack.apply(wm, SR, key=j)
        values = np.asarray(jax_detect_values(params, jnp.asarray(attacked, jnp.float32)))
        exempt = int(np.sum(np.abs(values) < EXEMPT))
        key = f"ber:{attack.name}"
        assert abs(ours[key] - ref[key]) <= 5.0 * exempt, (key, ours[key], ref[key])
    assert ours["clean_ber"] == ref["clean_ber"] == 0.0
    assert ours["snr"] == ref["snr"]
    for k in ("pesq", "stoi"):
        assert abs(ours[k] - ref[k]) <= 1e-9
    assert abs(ours["pesq_proxy"] - ref["pesq_proxy"]) <= 1e-4


def test_tiny_run_gives_the_jax_key_set():
    emb, det = aware_tpu_torch.load(device="cpu", num_iterations=5)
    attacks = [a for a in default_attack_suite(real_mp3=False)
               if a.name in ("pcm_16", "sample_supression_0.1", "mp3approx_9")]
    res = ph.run_robustness_eval(n_clips=1, seed=2, attacks=attacks, model=(emb, det))
    assert set(res) == BASE_KEYS | {f"ber:{a.name}" for a in attacks}
    assert all(np.isfinite(v) for k, v in res.items() if k != "snr")
    assert 1.0 <= res["pesq"] <= 4.65 and 0.0 <= res["stoi"] <= 1.0


def test_wav_directory_path(tmp_path):
    """Clips read from WAV files, one at 44.1 kHz (resampled to 16 kHz), and
    a silent one, which the embed rejects and the harness skips."""
    clip = ph.synthesize_speech_clip(3)
    write_wav(str(tmp_path / "a.wav"), clip, SR)
    from scipy.signal import resample_poly

    write_wav(str(tmp_path / "b.wav"), resample_poly(clip, 441, 160).astype(np.float32), 44100)
    write_wav(str(tmp_path / "c.wav"), np.zeros(SR, np.float32), SR)
    loaded = ph._load_clips(str(tmp_path), 3, 0, SR, torch.device("cpu"))
    ref = jh._load_clips(str(tmp_path), 3, 0, SR)
    assert [len(c) for c in loaded] == [len(c) for c in ref]
    for ours, theirs in zip(loaded, ref):
        np.testing.assert_allclose(ours, theirs, atol=1e-5)
    model = aware_tpu_torch.load(device="cpu", num_iterations=3)
    res = ph.run_robustness_eval(audio_dir=str(tmp_path), n_clips=3, attacks=[], model=model)
    assert set(res) == BASE_KEYS
    with pytest.raises(FileNotFoundError):
        ph.run_robustness_eval(audio_dir=str(tmp_path / "none"), attacks=[], model=model)


def test_wav_io_reads_as_the_jax_reader(tmp_path):
    rng = np.random.default_rng(5)
    mono = (0.9 * rng.uniform(-1, 1, 4000)).astype(np.float32)
    stereo = (0.4 * rng.standard_normal((3000, 2))).astype(np.float32)
    for name, x, sr, bits in (("m16", mono, 16000, 16), ("s32", stereo, 44100, 32)):
        path = str(tmp_path / f"{name}.wav")
        write_wav(path, x, sr, bits=bits)
        y, got_sr = read_wav(path)
        y_ref, sr_ref = jax_read_wav(path)
        np.testing.assert_array_equal(y, y_ref)
        assert got_sr == sr_ref == sr
        np.testing.assert_allclose(y, x, atol=7e-5 if bits == 16 else 0)


def test_unported_modes_raise(monkeypatch):
    """``--extended`` raises; ``--robust-detect`` (ported with
    ``service/robust.py``) reaches ``run_robustness_eval(robust=True)``,
    which ``tests/test_torch_robust.py`` holds against the JAX harness."""
    with pytest.raises(NotImplementedError, match="voice_codecs"):
        ph.main(["--extended", "--cpu"])
    calls = []
    monkeypatch.setattr(ph, "run_robustness_eval", lambda *a, **k: calls.append(k) or {})
    ph.main(["--robust-detect", "--cpu"])
    assert calls == [{"model": None, "robust": True, "device": "cpu"}]


@pytest.mark.slow
def test_cli_on_the_cpu(tmp_path, capsys):
    """The CLI with the 22-attack suite, 1 clip, a 10-iteration card."""
    card = tmp_path / "card.yaml"
    card.write_text("num_iterations: 10\n")
    ph.main(["--cpu", "--clips", "1", "--card", str(card)])
    res = json.loads(capsys.readouterr().out)
    assert set(res) == BASE_KEYS | {f"ber:{a.name}" for a in default_attack_suite()}
