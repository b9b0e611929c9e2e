"""The port's command line (``python -m aware_tpu_torch``, ``__main__.py``)
on the CPU (``--cpu``) with a short-solve card, against the JAX package's
command line reading the same files.

* ``embed --message`` then ``detect --message-k``: the port's JSON reads
  the message, and the JAX command line reads the same message from the
  port's file; ``--robust`` too.  ``embed --bits`` then ``detect`` and
  ``detect --robust``; ``detect --streaming`` prints its segments.
* The two repairs over the JAX command line: the codeword has the
  embedder's ``output_length`` slots, and a ``--message`` with a character
  other than 0 or 1 is refused.
* ``embed --oneshot --variant diverse`` writes the JAX command line's
  file (to a PCM step) and reads back through ``detect`` as the JAX
  command line reads it; ``--oneshot`` refuses a 44.1 kHz file and an
  unknown variant, as the JAX one.  ``eval --extended`` reaches the
  harness with ``extended_attack_suite()``, the JAX rows; ``eval
  --robust-detect`` reaches the harness's ``robust=True``; an unknown card
  name is refused.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from aware_tpu.__main__ import main as jax_main
from aware_tpu.attacks.voice_codecs import extended_attack_suite as jax_extended
import aware_tpu_torch.eval.harness as ph
from aware_tpu_torch.__main__ import main
from aware_tpu_torch.service import ecc
from aware_tpu_torch.utils.io import read_wav, write_wav

ROOT = pathlib.Path(__file__).resolve().parents[1]
BITS = "10110010110100111001"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    card = d / "card.yaml"
    card.write_text("num_iterations: 30\n")
    wav = d / "in.wav"
    write_wav(str(wav), ph.synthesize_speech_clip(900), 16000)
    return d, str(card), str(wav)


def _json(capsys):
    return json.loads(capsys.readouterr().out)


def test_message_round_trip_reads_as_the_jax_cli(files, capsys):
    d, card, wav = files
    out = str(d / "msg.wav")
    main(["embed", wav, out, "--message", "10110101", "--card", card, "--cpu"])
    assert "codeword:" in capsys.readouterr().out
    audio, sr = read_wav(out)
    assert sr == 16000 and audio.shape == (32000,)
    main(["detect", out, "--message-k", "8", "--cpu"])
    ours = _json(capsys)
    jax_main(["detect", out, "--message-k", "8"])
    ref = _json(capsys)
    assert ours["message"] == ref["message"] == "10110101"
    assert abs(ours["margin"] - ref["margin"]) <= 1e-3 * ref["margin"]
    main(["detect", out, "--message-k", "8", "--robust", "--identity-margin", "1.9", "--cpu"])
    ours = _json(capsys)
    assert ours["message"] == "10110101"
    assert (ours["lane"], ours["rate"]) == ("resample", 1.0)


def test_bits_round_trip_plain_robust_and_streaming(files, capsys):
    d, card, wav = files
    out = str(d / "bits.wav")
    main(["embed", wav, out, "--bits", BITS, "--card", card, "--cpu"])
    capsys.readouterr()
    main(["detect", out, "--cpu"])
    assert capsys.readouterr().out.split() == ["bits:", BITS]
    main(["detect", out, "--robust", "--cpu"])
    line = capsys.readouterr().out
    assert line.startswith(f"bits: {BITS}  (resample rate 1.0")
    main(["detect", wav, "--streaming", "--win-hop", "0.5", "--cpu"])
    res = _json(capsys)
    assert set(res) == {"detected", "threshold", "segments", "rejected_segments"}
    assert res["detected"] is False and res["segments"] == []
    # without --bits the bits are drawn from --seed
    main(["embed", wav, str(d / "seeded.wav"), "--seed", "3", "--card", card, "--cpu"])
    drawn = np.random.default_rng(3).integers(0, 2, 20, dtype=np.int32)
    assert capsys.readouterr().out.splitlines()[0] == "bits: " + "".join(map(str, drawn))


def test_message_codeword_has_the_embedders_slots(files, monkeypatch):
    d, card, wav = files
    seen = []
    real = ecc.encode_message

    def spy(msg, n_slots=20):
        seen.append((tuple(msg), n_slots))
        return real(msg, n_slots)

    monkeypatch.setattr(ecc, "encode_message", spy)
    main(["embed", wav, str(d / "spy.wav"), "--message", "1011", "--card", card, "--cpu"])
    assert seen == [((1, 0, 1, 1), 20)]


@pytest.mark.parametrize("message", ["10b1", "1011 0101", "", "2"])
def test_non_binary_message_is_refused(files, message):
    d, card, wav = files
    out = d / f"refused{len(message)}.wav"
    with pytest.raises(SystemExit, match="0s and 1s"):
        main(["embed", wav, str(out), "--message", message, "--card", card, "--cpu"])
    assert not out.exists()


def test_oneshot_round_trip_as_the_jax_cli(files, capsys):
    d, _, wav = files
    ours, ref = str(d / "oneshot.wav"), str(d / "oneshot_jax.wav")
    main(["embed", wav, ours, "--oneshot", "--variant", "diverse", "--bits", BITS, "--cpu"])
    jax_main(["embed", wav, ref, "--oneshot", "--variant", "diverse", "--bits", BITS])
    capsys.readouterr()
    a, sr = read_wav(ours)
    b, _ = read_wav(ref)
    assert sr == 16000 and a.shape == b.shape == (32000,)
    np.testing.assert_allclose(a, b, atol=2.0 / 32768)
    main(["detect", ours, "--cpu"])
    got = capsys.readouterr().out.split()
    jax_main(["detect", ours])
    assert got == capsys.readouterr().out.split() and got[0] == "bits:"


def test_unported_modes_and_bad_cards(files, monkeypatch):
    d, card, wav = files
    wav44 = str(d / "in44.wav")
    write_wav(wav44, ph.synthesize_speech_clip(901)[:22050], 44100)
    with pytest.raises(SystemExit, match="16 kHz"):
        main(["embed", wav44, str(d / "x.wav"), "--oneshot", "--cpu"])
    with pytest.raises(FileNotFoundError, match="v2"):
        main(["embed", wav, str(d / "x.wav"), "--oneshot", "--variant", "v2", "--cpu"])
    with pytest.raises(SystemExit, match="unknown card"):
        main(["detect", wav, "--card", "no_such_card", "--cpu"])
    with pytest.raises(SystemExit):
        main(["embed", wav, str(d / "x.wav"), "--bits", "101", "--card", card, "--cpu"])
    calls = []
    monkeypatch.setattr(ph, "run_robustness_eval", lambda *a, **k: calls.append((a, k)) or {})
    main(["eval", "--robust-detect", "--clips", "2", "--seed", "5", "--card", card, "--cpu"])
    (args, kwargs), = calls
    assert args[:3] == (None, 2, 5) and kwargs["robust"] is True
    assert kwargs["device"] == "cpu" and kwargs["model"][0].cfg.num_iterations == 30
    assert kwargs["attacks"] is None
    calls.clear()
    main(["eval", "--extended", "--cpu"])
    (args, kwargs), = calls
    assert [a.name for a in kwargs["attacks"]] == [a.name for a in jax_extended()]
    assert kwargs["robust"] is False and kwargs["model"] is None


def test_python_dash_m_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "aware_tpu_torch", "--help"], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    for cmd in ("embed", "detect", "eval"):
        assert cmd in out.stdout


def test_profiling_trace_writes_a_chrome_trace(tmp_path, caplog):
    """``utils/profiling.py``: ``trace`` writes the block's torch.profiler
    trace as Chrome JSON (CPU activity here), ``timed`` logs the block."""
    import logging

    from aware_tpu_torch.utils.profiling import timed, trace

    with trace(tmp_path / "t") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in row.key for row in prof.key_averages())
    logger = logging.getLogger("aware_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        with timed("the block"):
            pass
    finally:
        logger.removeHandler(caplog.handler)
    assert "the block:" in caplog.text
