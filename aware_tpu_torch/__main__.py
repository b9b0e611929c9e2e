"""Command line: embed / detect / eval (the port of ``aware_tpu/__main__.py``).

    python -m aware_tpu_torch embed  in.wav out.wav [--bits 1011...] [--card turbo]
    python -m aware_tpu_torch embed  in.wav out.wav --message 10110101
    python -m aware_tpu_torch detect in.wav [--robust]
    python -m aware_tpu_torch detect in.wav --message-k 8 [--robust]
    python -m aware_tpu_torch detect long.wav --streaming [--window 2 --win-hop 1]
    python -m aware_tpu_torch eval   [audio_dir] [--clips 4] [--robust-detect]

Every command runs on the CUDA card; ``--cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

_ONESHOT = ("the one-shot embed (service/fast.py, the amortized embedder) is not ported")


def _parse_bits(s: str, n: int) -> np.ndarray:
    bits = np.array([int(c) for c in s if c in "01"], dtype=np.int32)
    if len(bits) != n:
        raise SystemExit(f"expected {n} bits, got {len(bits)}")
    return bits


def _parse_message(s: str) -> np.ndarray:
    """A message of 0s and 1s; any other character is refused (where the
    JAX package's command line drops it and embeds a shorter message)."""
    if not s or set(s) - set("01"):
        raise SystemExit(f"--message must be a string of 0s and 1s, got {s!r}")
    return np.array([int(c) for c in s], dtype=np.int32)


def _load(args):
    from aware_tpu_torch.service.api import CARDS_DIR, load

    card = args.card
    if card and not card.endswith((".yaml", ".yml")) and not (CARDS_DIR / f"{card}.yaml").exists():
        names = sorted(p.stem for p in CARDS_DIR.glob("*.yaml"))
        raise SystemExit(f"unknown card {card!r}; available: {names}")
    return load(card, device="cpu" if args.cpu else None)


def cmd_embed(args) -> None:
    from aware_tpu_torch.service.api import embed_watermark
    from aware_tpu_torch.utils.io import read_wav, write_wav

    if args.oneshot or args.variant is not None:
        raise NotImplementedError(f"--oneshot / --variant: {_ONESHOT}")
    embedder, _ = _load(args)
    audio, sr = read_wav(args.input)
    if args.message is not None:
        # a k-bit payload -> the [n, k] soft-decision codeword (service/ecc.py);
        # decode with `detect --message-k K`
        from aware_tpu_torch.service.ecc import encode_message

        msg = _parse_message(args.message)
        bits = encode_message(msg, embedder.output_length)
        print(f"message k={len(msg)} -> codeword:", "".join(map(str, bits)))
    elif args.bits:
        bits = _parse_bits(args.bits, embedder.output_length)
    else:
        bits = np.random.default_rng(args.seed).integers(
            0, 2, embedder.output_length, dtype=np.int32)
        print("bits:", "".join(map(str, bits)))
    out = embed_watermark(audio, sr, bits, embedder)
    write_wav(args.output, out, sr)
    print(f"wrote {args.output} ({out.shape[0]} samples @ {sr} Hz)")


def cmd_detect(args) -> None:
    from aware_tpu_torch.service.api import detect_watermark
    from aware_tpu_torch.utils.io import read_wav

    _, detector = _load(args)
    audio, sr = read_wav(args.input)
    if args.streaming:
        from aware_tpu_torch.service.streaming import StreamingDetector

        sd = StreamingDetector(detector, window_seconds=args.window, hop_seconds=args.win_hop)
        res = sd.detect(audio, sr)
        print(json.dumps({
            "detected": res.detected,
            "threshold": res.threshold,
            "segments": [
                {
                    "start_s": s.start_seconds,
                    "end_s": s.end_seconds,
                    "confidence": s.confidence,
                    "n_windows": s.n_windows,
                    "bit_agreement": s.bit_agreement,
                    "bits": "".join(map(str, np.asarray(s.bits).astype(int))),
                }
                for s in res.segments
            ],
            "rejected_segments": res.rejected_segments,
        }, indent=2))
    elif args.message_k:
        if args.robust:
            from aware_tpu_torch.service.ecc import detect_message_robust

            res, kind, rate = detect_message_robust(
                audio, sr, detector, k=args.message_k, identity_margin=args.identity_margin)
            extra = {"lane": kind, "rate": rate}
        else:
            from aware_tpu_torch.service.ecc import detect_message

            res = detect_message(audio, sr, detector, k=args.message_k)
            extra = {}
        print(json.dumps({
            "message": "".join(map(str, np.asarray(res.msg_bits))),
            "margin": float(res.margin),
            "pvalue": float(res.pvalue),
            **extra,
        }, indent=2))
    elif args.robust:
        from aware_tpu_torch.service.robust import detect_watermark_robust

        res = detect_watermark_robust(audio, sr, detector, return_confidence=True)
        print(f"bits: {''.join(map(str, res.bits))}  "
              f"({res.kind} rate {res.rate}, conf {res.confidence:.3f})")
    else:
        bits = detect_watermark(audio, sr, detector)
        print("bits:", "".join(map(str, np.asarray(bits).astype(int))))


def cmd_eval(args) -> None:
    from aware_tpu_torch.eval import harness

    argv = [args.audio_dir] if args.audio_dir else []
    argv += ["--clips", str(args.clips), "--seed", str(args.seed)]
    argv += ["--extended"] * args.extended + ["--robust-detect"] * args.robust_detect
    argv += ["--cpu"] * args.cpu + (["--card", args.card] if args.card else [])
    harness.main(argv)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="aware_tpu_torch", description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--card", default=None,
                        help="config card: a bare card name of the JAX package's "
                             "(robust/compression/turbo/desync) or a YAML path")
    common.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions) instead of the CUDA card")

    p = sub.add_parser("embed", parents=[common], help="embed a watermark into a WAV file")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--bits", help="bit string, e.g. 10110... (random if omitted)")
    p.add_argument("--message",
                   help="k-bit payload of 0s and 1s (k <= 14) encoded through the [n, k] "
                        "soft-decision ECC instead of raw slot bits; decode with "
                        "`detect --message-k K`")
    p.add_argument("--oneshot", action="store_true",
                   help="the one-shot amortized embed (not ported: raises)")
    p.add_argument("--variant", default=None,
                   help="one-shot bundle variant (not ported: raises)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_embed)

    p = sub.add_parser("detect", parents=[common], help="detect a watermark in a WAV file")
    p.add_argument("input")
    p.add_argument("--streaming", action="store_true",
                   help="sliding-window localization over a long file (prints JSON segments)")
    p.add_argument("--window", type=float, default=2.0, help="streaming window seconds")
    p.add_argument("--win-hop", type=float, default=1.0, help="streaming window hop seconds")
    p.add_argument("--robust", action="store_true", help="speed-change-robust rate search")
    p.add_argument("--message-k", type=int, default=None,
                   help="ML-decode a k-bit ECC payload (prints JSON with margin and presence "
                        "p-value); with --robust over the compensation grid")
    p.add_argument("--identity-margin", type=float, default=1.0,
                   help="lane guard for --robust --message-k: 1.0 for solver-strength marks, "
                        "1.9 for weak marks")
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("eval", parents=[common], help="run the robustness attack suite")
    p.add_argument("audio_dir", nargs="?", default=None)
    p.add_argument("--clips", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--extended", action="store_true",
                   help="the real voice-codec rows (not ported: raises)")
    p.add_argument("--robust-detect", action="store_true",
                   help="detect through the rate-search compensation detector")
    p.set_defaults(fn=cmd_eval)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
