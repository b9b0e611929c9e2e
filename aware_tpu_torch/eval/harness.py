"""Robustness evaluation harness.

The port of ``aware_tpu/eval/harness.py`` (reference: scripts/test.py:13-120):
for each clip, embed a random 20-bit mark, measure the clean BER, PESQ,
PESQ proxy, STOI and SNR, then re-detect after every attack of the suite
and average each attack's BER over the clips.  It returns the JAX
harness's result dict (the same keys and means) and draws the same
per-attack keys (``seed*10007 + i*101 + j``); the random attacks draw
from torch with them (``attacks/attacks.py``).  Clips are the synthesized
speech-like fixtures unless a WAV directory is given.  Embedding, the
attacks and the device metrics run on the model's device.

``--extended`` runs ``extended_attack_suite()`` (attacks/voice_codecs.py)
in place of the 22-attack suite: the real host codecs' rows follow, one
``ber:<name>`` key each, and a row whose library does not load here is
left out with a line on standard error that names it and its cause.

Run:  python -m aware_tpu_torch.eval [audio_dir] [--clips N] [--seed S]
      [--card NAME] [--extended] [--robust-detect] [--cpu]
"""

from __future__ import annotations

import logging
import pathlib
import sys
from typing import Mapping, Sequence

import numpy as np
import torch

from aware_tpu_torch.attacks import Attack, default_attack_suite
from aware_tpu_torch.metrics import ber, pesq, pesq_proxy, snr, stoi
from aware_tpu_torch.ops.resample import resample
from aware_tpu_torch.service.api import (
    AWAREDetector,
    AWAREEmbedder,
    detect_watermark,
    embed_watermark,
    load,
)
from aware_tpu_torch.utils.io import read_wav

logger = logging.getLogger("aware_tpu_torch.eval")


def synthesize_speech_clip(seed: int, seconds: float = 2.0, sr: int = 16000) -> np.ndarray:
    """Deterministic speech-like fixture (harmonic source + syllabic
    envelope + noise floor) for data-free eval runs."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 100.0 + 60.0 * rng.random() + 30.0 * np.sin(2 * np.pi * (1.5 + rng.random()) * t)
    phase = np.cumsum(2 * np.pi * f0 / sr)
    x = np.zeros_like(t)
    for k in range(1, 25):
        x += np.cos(k * phase + rng.random() * 6.28) / k
    env = 0.35 + 0.65 * np.clip(np.sin(2 * np.pi * (2.5 + rng.random()) * t), 0, None)
    x = x * env + 0.02 * rng.standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _load_clips(audio_dir: str | None, n_clips: int, seed: int, sr: int,
                device: torch.device) -> list[np.ndarray]:
    if audio_dir:
        clips = []
        for p in sorted(pathlib.Path(audio_dir).glob("*.wav"))[:n_clips]:
            audio, file_sr = read_wav(str(p))
            if audio.ndim == 2:
                audio = audio.mean(axis=1)
            if file_sr != sr:
                x = torch.as_tensor(audio.astype(np.float32), device=device)
                audio = resample(x, file_sr, sr).cpu().numpy()
            clips.append(audio.astype(np.float32))
        if not clips:
            raise FileNotFoundError(f"no .wav files in {audio_dir}")
        return clips
    return [synthesize_speech_clip(seed + i) for i in range(n_clips)]


def run_robustness_eval(
    audio_dir: str | None = None,
    n_clips: int = 4,
    seed: int = 0,
    attacks: Sequence[Attack] | None = None,
    model: tuple[AWAREEmbedder, AWAREDetector] | None = None,
    sample_rate: int = 16000,
    robust: bool = False,
    device: str | torch.device | None = None,
) -> Mapping[str, float]:
    """Full embed -> attack -> detect sweep; returns mean metrics.

    Result keys: ``clean_ber``, ``pesq``, ``pesq_proxy``, ``stoi``,
    ``snr`` and one ``ber:<attack-name>`` per attack (all means over
    clips; BERs are percentages per the reference metric quirk).  A clip
    that ``embed_watermark`` rejects (the VAD gate) is skipped.  ``model``
    defaults to ``load(device=device)``; everything runs on the model's
    device.  With ``robust=True`` every detection goes through the
    rate-search compensation detector (``service/robust.py``,
    ``detect_watermark_robust``) instead of the plain forward.
    """
    embedder, detector = model if model else load(device=device)
    dev = embedder.device
    attacks = list(default_attack_suite()) if attacks is None else list(attacks)
    clips = _load_clips(audio_dir, n_clips, seed, sample_rate, dev)
    rng = np.random.default_rng(seed)
    if robust:
        from aware_tpu_torch.service.robust import detect_watermark_robust as _detect
    else:
        _detect = detect_watermark

    rec: dict[str, list[float]] = {
        "clean_ber": [], "pesq": [], "pesq_proxy": [], "stoi": [], "snr": [],
    }
    n_bits = embedder.output_length
    for i, audio in enumerate(clips):
        bits = rng.integers(0, 2, size=n_bits, dtype=np.int32)
        try:
            wm = embed_watermark(audio, sample_rate, bits, embedder)
        except ValueError as e:
            logger.warning("skipping clip %d: %s", i, e)
            continue
        detected = _detect(wm, sample_rate, detector)
        rec["clean_ber"].append(ber(bits, detected))
        rec["pesq"].append(pesq(wm, audio, sample_rate, device=dev))
        rec["pesq_proxy"].append(pesq_proxy(wm, audio, sample_rate, device=dev))
        rec["stoi"].append(stoi(wm, audio, sample_rate, device=dev))
        rec["snr"].append(snr(wm, audio[: len(wm)]))

        for j, attack in enumerate(attacks):
            attacked = attack.apply(wm, sample_rate, key=seed * 10007 + i * 101 + j, device=dev)
            detected = _detect(np.asarray(attacked, dtype=np.float32), sample_rate, detector)
            rec.setdefault(f"ber:{attack.name}", []).append(ber(bits, detected))

    results = {k: float(np.mean(v)) for k, v in rec.items() if v}
    for k, v in sorted(results.items()):
        logger.info("%s: mean %.4f", k, v)
    return results


def extended_suite() -> list[Attack]:
    """``extended_attack_suite()``, after a line on standard error for each
    row that this machine's libraries leave out, with its cause."""
    from aware_tpu_torch.attacks.voice_codecs import (
        extended_attack_suite,
        extended_rows_left_out,
    )

    for name, why in extended_rows_left_out():
        print(f"extended suite: row {name} left out: {why}", file=sys.stderr)
    return extended_attack_suite()


def main(argv: Sequence[str] | None = None) -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("audio_dir", nargs="?", default=None)
    ap.add_argument("--clips", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--extended", action="store_true",
                    help="the reference's 22-attack suite plus the real-codec rows "
                         "(Opus/GSM/AAC/Vorbis/Speex/G.722/soxr) whose libraries load here")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions) instead of the CUDA card")
    ap.add_argument("--card", default=None,
                    help="config card to load: a bare card name of the JAX package's "
                         "('robust', 'compression', 'voice', 'turbo', 'desync') or a YAML "
                         "path; the default card otherwise")
    ap.add_argument("--robust-detect", action="store_true",
                    help="detect through the rate-search compensation detector "
                         "(service/robust.py) instead of the plain forward")
    args = ap.parse_args(argv)
    attacks = extended_suite() if args.extended else None
    device = "cpu" if args.cpu else None
    model = load(args.card, device=device) if args.card else None
    results = run_robustness_eval(args.audio_dir, args.clips, args.seed, attacks=attacks,
                                  model=model, robust=args.robust_detect, device=device)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
