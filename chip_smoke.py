#!/usr/bin/env python3
"""Chip check of aware_tpu_torch on one CUDA card (written for an H100).

    python3 chip_smoke.py            # all phases, the default card's 400 iterations
    python3 chip_smoke.py --quick    # phases 0-2 only, one launch per kernel

Phases, each printing one progress line (plus details) and failing the run
with a non-zero exit on any error:

0. the card: nvidia-smi's name and power limit, torch and CUDA versions;
1. build: nvcc of aware_tpu_torch/csrc into aware_tpu_torch/_build, with
   its seconds and the ptxas register / shared-memory lines;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   main path's shapes (B = 8 clips of T = 626 frames, P = 256, hop = 256),
   error <= 1e-3 * max|plain| (float32 sums in another order on the card);
   device times of kernel and plain version (CUDA-graph replays timed by
   CUDA events), per-call times from Python, and the bound of each;
3. main path: load() -> embed_watermark_batch on 8 speech-like 10 s 16 kHz
   clips with random 20-bit messages (400 iterations) -> detect_watermark_
   batch; every lane must read back at 0 % BER, and every kernel must have
   been launched by the solve.  Then a small reference (a short solve on
   the card against the same solve through the plain versions on the CPU)
   and a torch.profiler breakdown of a 20-iteration solve;
4. single clip: embed_watermark / detect_watermark of a 2 s clip given at
   44.1 kHz (the resample path).

The last lines are one JSON object with a record per kernel
({"kernels": [...]}), nvidia-smi's name/power line, and
{"ok": true, "device": {...}}.  Without a CUDA card, or without the
package beside it, the script fails and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
TOL = 1e-3                # kernel vs plain, relative to max|plain|
F32, BF16 = 4, 2          # bytes
BATCH = 8                 # clips of the main path
REPS = 20                 # timed launches per kernel


def say(msg: str) -> None:
    print(msg, flush=True)


def speechlike(rng: np.random.Generator, seconds: float, sr: int) -> np.ndarray:
    """Harmonic speech-like clip (the VAD rejects noise and silence)."""
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(100, 180) + rng.uniform(15, 40) * np.sin(
        2 * np.pi * rng.uniform(1.5, 3.0) * t
    )
    ph = np.cumsum(2 * np.pi * f0 / sr)
    x = sum(np.cos(k * ph) / k for k in range(1, 25))
    x *= 0.4 + 0.6 * np.clip(np.sin(2 * np.pi * rng.uniform(2.5, 4.0) * t), 0, None)
    x += 0.02 * rng.standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


def time_ms(torch, fn, reps: int) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``.  Device time replays ``fn``
    captured in a CUDA graph, so the host's launch overhead is out of it;
    call time is back-to-back calls from Python, overhead included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    out = []
    for run in (graph.replay, fn):
        run()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            run()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return out[0], out[1]


def profile_solve(torch, run) -> str:
    """Device time by kind of kernel over one call of ``run``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ours = ("shift_gemm", "peak_scale", "synth_bwd_scalars", "fold_phase")
    kinds = {"round-trip kernels": 0.0, "cuBLAS GEMM": 0.0, "FFT": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.device_time_total <= 0:
            continue
        t = ev.device_time_total / 1e3
        name = ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
        low = name.lower()
        if any(k in name for k in ours):
            kinds["round-trip kernels"] += t
        elif "gemm" in low or "xmma" in low:
            kinds["cuBLAS GEMM"] += t
        elif "fft" in low:
            kinds["FFT"] += t
        else:
            kinds["other"] += t
        top.append((t, name[:70], ev.count))
    busy = sum(kinds.values())
    if busy == 0:
        return f"wall {wall_ms:.1f} ms; device time not visible to torch.profiler"
    top = sorted(top, reverse=True)[:6]
    return (
        f"wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f} %, idle {100 - 100 * busy / wall_ms:.1f} %); "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items())
        + "; top: " + "; ".join(f"{n} x{c} {t:.2f} ms" for t, n, c in top)
    )


def check_kernels(torch, rt, pb, hop, rng, quick: bool) -> dict:
    """Phase 2: each kernel against its plain version on the main path's
    operands; returns one record per kernel."""
    bsz, t, p = pb.ct0.shape
    lr = t - 1
    dev = pb.ct0.device
    ct = pb.ct0.contiguous()
    y2, m1 = rt.synth_norm_fwd_plain(ct, pb.csin, pb.y_const, pb.env, pb.ab)
    g_y2 = torch.as_tensor(rng.standard_normal((bsz, lr, hop)).astype(np.float32), device=dev)
    g_cs = torch.as_tensor(rng.standard_normal((bsz, t, 2 * p)).astype(np.float32), device=dev)
    basis = rt.R * hop * 2 * p * BF16
    cases = {  # name: (kernel, plain, replaces, FLOP, bytes in + out)
        "synth_norm_fwd": (
            lambda: rt.synth_norm_fwd(ct, pb.csin, pb.y_const, pb.env, pb.ab),
            lambda: rt.synth_norm_fwd_plain(ct, pb.csin, pb.y_const, pb.env, pb.ab),
            "aware_tpu/ops/pallas/roundtrip.py:179",
            2 * bsz * lr * hop * (rt.R * 2 * p),
            bsz * t * p * F32 + bsz * t * 2 * p * BF16 + 2 * bsz * lr * hop * F32
            + lr * hop * F32 + basis + bsz * F32,
        ),
        "synth_norm_bwd": (
            lambda: rt.synth_norm_bwd(g_y2, y2, m1, pb.csin, pb.env, pb.abt),
            lambda: rt.synth_norm_bwd_plain(g_y2, y2, m1, pb.csin, pb.env, pb.abt),
            "aware_tpu/ops/pallas/roundtrip.py:223",
            2 * bsz * t * (2 * p) * (rt.R * hop) + 2 * bsz * t * p,
            2 * bsz * lr * hop * F32 + bsz * F32 + bsz * t * 2 * p * BF16
            + lr * hop * F32 + basis + bsz * t * p * F32,
        ),
        "band_analysis_fwd": (
            lambda: rt.band_analysis_fwd(y2, pb.csw),
            lambda: rt.band_analysis_fwd_plain(y2, pb.csw),
            "aware_tpu/ops/pallas/roundtrip.py:254",
            2 * bsz * t * (2 * p) * (rt.R * hop),
            bsz * lr * hop * F32 + basis + bsz * t * 2 * p * F32,
        ),
        "band_analysis_bwd": (
            lambda: rt.band_analysis_bwd(g_cs, pb.cswt),
            lambda: rt.band_analysis_bwd_plain(g_cs, pb.cswt),
            "aware_tpu/ops/pallas/roundtrip.py:281",
            2 * bsz * lr * hop * (rt.R * 2 * p),
            bsz * t * 2 * p * F32 + basis + bsz * lr * hop * F32,
        ),
    }
    records = {}
    for name, (kern, plain, replaces, flops, nbytes) in cases.items():
        out_k = kern()
        torch.cuda.synchronize()
        out_p = plain()
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        err = 0.0
        for a, ref in zip(outs_k, outs_p):
            if a.shape != ref.shape or not torch.isfinite(a).all():
                raise RuntimeError(f"{name}: bad output {tuple(a.shape)}")
            e = float((a - ref).abs().max())
            if e > TOL * float(ref.abs().max()):
                raise RuntimeError(f"{name}: max error {e:.3e} over {TOL} * max|plain|")
            err = max(err, e)
        t_flop = flops / PEAK_BF16_FLOPS * 1e3
        t_byte = nbytes / PEAK_BYTES * 1e3
        rec = {
            "name": name,
            "route": "cuda",
            "source": "aware_tpu_torch/csrc/roundtrip.cu",
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": err,
            "ms": None,
            "plain_ms": None,
            "bound_ms": max(t_flop, t_byte),
            "bound_by": "operations" if t_flop >= t_byte else "bytes",
            # no single PyTorch call computes a shifted-slab product with
            # these prologues and epilogues
            "library_ms": None,
        }
        call = (None, None)
        if not quick:
            rec["ms"], call_k = time_ms(torch, kern, REPS)
            rec["plain_ms"], call_p = time_ms(torch, plain, REPS)
            call = (call_k, call_p)
        records[name] = rec
        say(
            f"phase 2 kernel {name}: max_abs_err {err:.3e} device ms {rec['ms']} "
            f"plain device ms {rec['plain_ms']} (per call from Python: kernel "
            f"{call[0]} plain {call[1]}) bound_us {rec['bound_ms'] * 1e3:.2f} "
            f"({rec['bound_by']})"
        )
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="phases 0-2, one launch each")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from aware_tpu_torch import (
        detect_watermark,
        detect_watermark_batch,
        embed_watermark,
        embed_watermark_batch,
        load,
    )
    from aware_tpu_torch.embed.solver import build_problem, embed_batch
    from aware_tpu_torch.ops.kernels import roundtrip as rt
    from aware_tpu_torch.ops.kernels.build import build

    t_start = time.perf_counter()
    # ---- phase 0: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(f"phase 0 card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # ---- phase 1: build
    b = build()
    say(f"phase 1 build: {b.seconds:.2f} s nvcc -> {b.path.name}")
    for line in b.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            say("  " + line.strip())

    # ---- phase 2: kernels vs plain on the main path's shapes
    dev = torch.device("cuda")
    emb, det = load(device=dev)
    cfg = emb.cfg
    sr = cfg.detection_net.sample_rate
    rng = np.random.default_rng(args.seed)
    clips = np.stack([speechlike(rng, 10.0, sr) for _ in range(BATCH)])
    bits = rng.integers(0, 2, (BATCH, cfg.detection_net.output_length))
    x = torch.as_tensor(clips, device=dev)
    wm = torch.as_tensor(2.0 * bits - 1.0, device=dev)
    records = check_kernels(torch, rt, build_problem(x, wm, cfg), cfg.hop_length, rng,
                            args.quick)

    if not args.quick:
        # ---- phase 3: the main path
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rt.reset_launches()
        t0 = time.perf_counter()
        out = embed_watermark_batch(clips, sr, bits, emb)
        torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
        got = detect_watermark_batch(out, sr, det)
        launches = {k.__name__: k.launches for k in rt.KERNELS}
        n_out = (clips.shape[1] // cfg.hop_length) * cfg.hop_length
        if out.shape != (BATCH, n_out) or not np.isfinite(out).all():
            raise RuntimeError(f"embed output {out.shape} is not finite of (B, (T-1)*hop)")
        ber = np.mean(got != bits, axis=1) * 100.0
        ref = clips[:, :n_out]
        snr = 10 * np.log10(np.mean(out**2, 1) / np.mean((out - ref) ** 2, 1))
        say(
            f"phase 3 main path: B={BATCH} x 10 s x {cfg.num_iterations} iterations: "
            f"embed {embed_s:.3f} s, {BATCH / embed_s:.3f} clips/s, "
            f"BER % per lane {ber.tolist()}, mean SNR {snr.mean():.2f} dB, "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
        )
        say(f"phase 3 launches: {launches}")
        if ber.any():
            raise RuntimeError("a lane did not read back its message")
        for name, n in launches.items():
            if n < 1:
                raise RuntimeError(f"kernel {name} was not launched on the main path")
            records[name]["launches"] = n

        # the same short solve on the card (kernels) and on the CPU (plain)
        small = clips[:2, : 2 * sr]
        wm2 = torch.as_tensor(2.0 * bits[:2] - 1.0)
        short = cfg.replace(num_iterations=10)
        res_k = embed_batch(det.net, torch.as_tensor(small, device=dev), wm2.to(dev), short)
        _, det_cpu = load(device="cpu")
        res_p = embed_batch(det_cpu.net, torch.as_tensor(small), wm2, short)
        dloss = float((res_k.best_loss.cpu() - res_p.best_loss).abs().max())
        say(f"phase 3 reference: 10-iteration best_loss card vs CPU plain |diff| {dloss:.3e}")
        if not dloss < 0.02:
            raise RuntimeError("the card's solve departs from the plain solve")

        prof_cfg = cfg.replace(num_iterations=20)
        say(f"phase 3 profile, B={BATCH} x 20 iterations: " + profile_solve(
            torch, lambda: embed_batch(det.net, x, wm, prof_cfg)))

        # ---- phase 4: one clip at 44.1 kHz
        rt.reset_launches()
        clip44 = speechlike(rng, 2.0, 44100)
        msg = rng.integers(0, 2, cfg.detection_net.output_length)
        t0 = time.perf_counter()
        wm44 = embed_watermark(clip44, 44100, msg, emb)
        one_s = time.perf_counter() - t0
        got44 = detect_watermark(wm44, 44100, det)
        ber44 = float(np.mean(got44 != msg) * 100.0)
        say(
            f"phase 4 single clip 2 s @ 44.1 kHz: embed {one_s:.3f} s, "
            f"BER {ber44} %, launches {[k.launches for k in rt.KERNELS]}"
        )
        if ber44 != 0.0 or wm44.shape != clip44.shape or not np.isfinite(wm44).all():
            raise RuntimeError("single-clip round trip failed")

    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
