#!/usr/bin/env python3
"""Chip check of aware_tpu_torch on one CUDA card (written for an H100).

    python3 chip_smoke.py            # all phases, the default card's 400 iterations
    python3 chip_smoke.py --quick    # phases 0-2 only, one launch per kernel

Phases, each printing one progress line (plus details) and failing the run
with a non-zero exit on any error:

0. the card: nvidia-smi's name and power limit, torch and CUDA versions;
1. build: nvcc of aware_tpu_torch/csrc into aware_tpu_torch/_build (one
   nvcc per source, started together, then one link), with its seconds and
   the ptxas register / shared-memory lines;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   main path's operands (B = 8 clips of T = 626 frames, P = 256, hop = 256):
   the round-trip kernels to 1e-3 * max|plain| (float32 sums in another
   order on the card); the detector and whole-iteration kernels to the
   bounds of aware_tpu_torch/ops/kernels/agreement.py, which says why they
   are what they are: each forward on pred and on every residual its VJP
   reads (iteration_forward also on y2 and m1), each VJP from the plain
   forward's residuals, the chain the solver runs (the forward kernel,
   then the VJP kernel on the kernel's own residuals) against the plain
   chain, and iteration_step by its loss, its internal gradient (as a
   chain, and against the VJP kernel on the step's own residuals) and its
   NAdam / clamp / best epilogue given the same input.
   Device times of kernel and plain version (CUDA-graph replays timed by
   CUDA events), per-call times from Python, and the bound of each;
3. main path: load() -> embed_watermark_batch on 8 speech-like 10 s 16 kHz
   clips with random 20-bit messages (400 iterations) -> detect_watermark_
   batch, on the four solver paths: the default (the iteration_step kernel
   once per iteration), use_pallas_iteration=False (synth_norm ->
   analysis_detector -> detector_fused kernels), use_pallas_detector=False
   (synth_norm -> band_analysis -> plain detector) and NAdam with weight
   decay (the iteration_forward kernels and their VJP); every lane must
   read back at 0 % BER, and each kernel of a path must have been launched
   once per iteration by its solve, every other kernel never.  Then the
   first two paths timed again in turns (default, two-kernel, two-kernel,
   default); per path, a small reference (a short solve on the card against the same
   solve through the plain versions on the CPU), a torch.profiler
   breakdown of a 20-iteration solve, and, on the default path, a
   20-iteration loop under torch.cuda.set_sync_debug_mode("error") (no
   host sync);
3s. short clips: on each of the four paths, 2 clips each of T = 8, 9, 16
   and 31 frames through the solver: the 10-iteration best loss within
   SHORT_LOSS_TOL of the CPU plain solve's, and after 400 iterations no
   lane with a higher BER than the CPU plain solve's on the same lane;
4. single clip: embed_watermark / detect_watermark of a 2 s clip given at
   44.1 kHz (the resample path), on the default path.

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
TOL = 1e-3                # round-trip kernels vs plain, relative to max|plain|
F32, BF16 = 4, 2          # bytes
BATCH = 8                 # clips of the main path
REPS = 20                 # timed launches per kernel


def say(msg: str) -> None:
    print(msg, flush=True)


def speechlike(rng: np.random.Generator, seconds: float, sr: int, samples: int = 0) -> np.ndarray:
    """Harmonic speech-like clip (the VAD rejects noise and silence) of
    ``seconds`` or, where given, ``samples``."""
    t = np.arange(samples or int(seconds * sr)) / sr
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


def profile_solve(torch, run, trace: str | None = None) -> str:
    """Device time by kind of kernel over one call of ``run``; with
    ``trace``, the Chrome trace is written to that file."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace:
        prof.export_chrome_trace(trace)
    ours = ("shift_gemm", "peak_scale", "synth_bwd_scalars", "fold_phase", "in_norm_fwd",
            "mel_norm_fwd", "brh_fwd", "brh_bwd", "in_norm_bwd_stats", "mel_bwd_stats",
            "reflect_fold", "fold_scalars", "nadam_fold", "best_loss_update")
    kinds = {"our kernels": 0.0, "cuBLAS GEMM": 0.0, "FFT": 0.0, "other": 0.0}
    top = []
    dtoh = 0
    for ev in prof.key_averages():
        if "DtoH" in ev.key:
            dtoh += ev.count
        if ev.device_type != DeviceType.CUDA or ev.device_time_total <= 0:
            continue
        t = ev.device_time_total / 1e3
        name = ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
        low = name.lower()
        if any(k in name for k in ours):
            kinds["our kernels"] += t
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
    # the solver loop's own window, from the start of the first of our GEMMs
    # to the end of the last (set-up and reconstruction launch none), and
    # the device's idle share inside it
    spans = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start]
    gemms = [(a, b) for a, b, n in spans if "shift_gemm" in n]
    lo, hi = min(a for a, _ in gemms), max(b for _, b in gemms)
    in_loop = sum(min(b, hi) - max(a, lo) for a, b, _ in spans if b > lo and a < hi)
    top = sorted(top, reverse=True)[:6]
    return (
        f"wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f} %, idle {100 - 100 * busy / wall_ms:.1f} %); "
        f"solver loop {(hi - lo) / 1e3:.1f} ms, device idle in it "
        f"{100 - 100 * in_loop / (hi - lo):.1f} %; "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items())
        + f"; device-to-host copies {dtoh} (set-up and result included)"
        + "; top: " + "; ".join(f"{n} x{c} {t:.2f} ms" for t, n, c in top)
    )


def _close(name, outs_k, outs_p) -> float:
    """Round-trip kernels: every output within TOL * max|plain|."""
    err = 0.0
    for a, ref in zip(outs_k, outs_p):
        if a.shape != ref.shape or not a.isfinite().all():
            raise RuntimeError(f"{name}: bad output {tuple(a.shape)}")
        e = float((a - ref).abs().max())
        if e > TOL * float(ref.abs().max()):
            raise RuntimeError(f"{name}: max error {e:.3e} over {TOL} * max|plain|")
        err = max(err, e)
    return err


def _close_det(name, outs_k, outs_p) -> float:
    """Detector forwards: pred and every residual within agreement.py's
    bounds; returns the largest error of pred."""
    from aware_tpu_torch.ops.kernels import agreement as ag

    report = ag.check_forward(outs_k[1], outs_p[1], outs_p[1].nph.shape[1])
    say(f"  {name} vs plain, max error / max|plain|: {ag.fmt(report)}")
    return float((outs_k[0] - outs_p[0]).abs().max())


def _close_vjp(name, out_k, out_p, chain=False) -> float:
    """Detector VJPs (or, ``chain``, forward then VJP) within agreement.py's
    bounds; returns the largest error."""
    from aware_tpu_torch.ops.kernels import agreement as ag

    report = ag.check_vjp(out_k, out_p, chain=chain)
    say(f"  {name}{' chain' if chain else ''} vs plain: {ag.fmt(report)}")
    return float((out_k - out_p).abs().max())


def _det_counts(bsz, t, p, td):
    """FLOP and bytes of the detector forward and VJP: the five GEMMs
    (the norms' and activations' elementwise work is small beside them),
    and each input read once, each output written once."""
    t2 = t // 2
    ch = td.CH
    conv_macs = sum(ch[i] * ch[i + 1] for i in range(4))
    flops = 2 * bsz * (t * p * ch[0] + t2 * conv_macs)
    weights = (p * ch[0] + conv_macs) * BF16 + 4 * ch[2] * F32 + ch[4] * ch[4] * F32
    residuals = (
        bsz * ch[4] * F32 + bsz * t * 2 * p * BF16 + bsz * t * ch[0] * BF16
        + bsz * t2 * sum(ch[1:]) * BF16 + 2 * bsz * ch[0] * F32
        + bsz * sum(ch[1:]) * F32 + 3 * bsz * F32
    )
    cs = bsz * t * 2 * p * F32
    fwd_bytes = cs + weights + residuals
    bwd_bytes = bsz * ch[4] * F32 + residuals + weights + cs
    return flops, fwd_bytes, bwd_bytes, weights, residuals


def check_kernels(torch, pb, hop, rng, quick: bool) -> dict:
    """Phase 2: each kernel against its plain version on the main path's
    operands; returns one record per kernel."""
    from aware_tpu_torch.ops.kernels import agreement as ag
    from aware_tpu_torch.ops.kernels import analysis_detector as tad
    from aware_tpu_torch.ops.kernels import detector as td
    from aware_tpu_torch.ops.kernels import iteration as it
    from aware_tpu_torch.ops.kernels import roundtrip as rt

    bsz, t, p = pb.ct0.shape
    lr = t - 1
    dev = pb.ct0.device
    ct = pb.ct0.contiguous()
    ac = pb.fused
    y2, m1 = rt.synth_norm_fwd_plain(ct, pb.csin, pb.y_const, pb.env, pb.ab)
    cs = rt.band_analysis_fwd_plain(y2, pb.csw) + rt.edge_corrections(
        y2.reshape(bsz, -1), pb.csw_k, rt.R * hop, hop, t)
    g_y2 = torch.as_tensor(rng.standard_normal((bsz, lr, hop)).astype(np.float32), device=dev)
    g_cs = torch.as_tensor(rng.standard_normal((bsz, t, 2 * p)).astype(np.float32), device=dev)
    g_det = torch.zeros(bsz, td.CH[4], device=dev)
    g_det[:, : td.N_BITS] = torch.as_tensor(
        rng.standard_normal((bsz, td.N_BITS)).astype(np.float32), device=dev)
    _, res_det = td.detector_fused_fwd_plain(cs, ac.det)
    _, res_ad = tad.analysis_detector_fwd_plain(y2, ac)
    basis = rt.R * hop * 2 * p * BF16
    det_flops, det_fwd_bytes, det_bwd_bytes, det_weights, det_res = _det_counts(bsz, t, p, td)
    ana_flops = 2 * bsz * t * (2 * p) * (rt.R * hop)
    ana_bwd_flops = 2 * bsz * (lr + 2 * rt.PAD) * hop * (rt.R * 2 * p)
    cs_bytes = bsz * t * 2 * p * F32
    y2_bytes = bsz * lr * hop * F32
    # the whole-iteration kernels: checked once (agreement.check_iteration),
    # then timed on operands allocated once, as the solver does
    c = pb.iteration
    wm = torch.zeros(bsz, td.CH[4], device=dev)
    wm[:, : pb.wm.shape[1]] = pb.wm
    coefs = it.nadam_coefs()
    rep = ag.check_iteration(ct, c, wm, g_det, coefs, t)
    for key in ("fwd", "signal", "bwd", "bwd chain", "step gradient", "step own gradient",
                "step scalars", "epilogue"):
        say(f"  iteration {key} vs plain: {ag.fmt(rep[key])}")
    say(f"  iteration step loss, max error / max|plain|: vs plain {rep['step loss']:.3e}, "
        f"vs its own pred's {rep['step own loss']:.3e}")
    _, res_it = it.iteration_forward_fwd_plain(ct, c)

    def step_state():
        return [ct.clone(), torch.zeros_like(ct), torch.zeros_like(ct), ct.clone(),
                torch.full((bsz,), float("inf"), device=dev)]

    st_k, st_p = step_state(), step_state()
    bufs = it.step_buffers(bsz, t, 2 * p, hop, dev)
    s12 = torch.full((bsz,), 0.1, device=dev)
    d2 = torch.full((1,), 1e-3, device=dev)
    step_args = (pb.lower, pb.upper, wm, s12, s12, d2, c, coefs)
    synth_flops = 2 * bsz * lr * hop * (rt.R * 2 * p)
    synth_bwd_flops = 2 * bsz * t * (2 * p) * (rt.R * hop)
    it_fwd_flops = synth_flops + ana_flops + det_flops
    it_bwd_flops = det_flops + ana_bwd_flops + synth_bwd_flops
    state = bsz * t * p * F32              # one (B, T, P) f32 tensor
    csin_env = bsz * t * 2 * p * BF16 + lr * hop * F32
    u_m1 = y2_bytes + bsz * F32
    it_fwd_bytes = state + csin_env + y2_bytes + 2 * basis + det_weights + det_res + u_m1
    it_bwd_bytes = bsz * td.CH[4] * F32 + det_res + u_m1 + csin_env + 2 * basis + det_weights + state
    # ct, m, v, best, lower, upper in, ct, m, v, best out; wm, s1, s2, d2,
    # best_loss in, best_loss, loss out; csin, env, y_const, the four bases,
    # the detector's weights both ways
    it_step_bytes = (10 * state + bsz * td.CH[4] * F32 + 6 * bsz * F32 + F32 + csin_env
                     + y2_bytes + 4 * basis + 2 * det_weights)
    it_src = "aware_tpu_torch/csrc/iteration.cu"
    rt_src = "aware_tpu_torch/csrc/roundtrip.cu"
    det_src = "aware_tpu_torch/csrc/detector.cu"
    ad_src = "aware_tpu_torch/csrc/analysis_detector.cu"  # then detector.cu's chain
    cases = {  # name: (kernel, plain, compare, source, replaces, FLOP, bytes in + out)
        "synth_norm_fwd": (
            lambda: rt.synth_norm_fwd(ct, pb.csin, pb.y_const, pb.env, pb.ab),
            lambda: rt.synth_norm_fwd_plain(ct, pb.csin, pb.y_const, pb.env, pb.ab),
            _close, rt_src, "aware_tpu/ops/pallas/roundtrip.py:179",
            2 * bsz * lr * hop * (rt.R * 2 * p),
            bsz * t * p * F32 + bsz * t * 2 * p * BF16 + 2 * bsz * lr * hop * F32
            + lr * hop * F32 + basis + bsz * F32,
        ),
        "synth_norm_bwd": (
            lambda: rt.synth_norm_bwd(g_y2, y2, m1, pb.csin, pb.env, pb.abt),
            lambda: rt.synth_norm_bwd_plain(g_y2, y2, m1, pb.csin, pb.env, pb.abt),
            _close, rt_src, "aware_tpu/ops/pallas/roundtrip.py:223",
            2 * bsz * t * (2 * p) * (rt.R * hop) + 2 * bsz * t * p,
            2 * bsz * lr * hop * F32 + bsz * F32 + bsz * t * 2 * p * BF16
            + lr * hop * F32 + basis + bsz * t * p * F32,
        ),
        "band_analysis_fwd": (
            lambda: rt.band_analysis_fwd(y2, pb.csw),
            lambda: rt.band_analysis_fwd_plain(y2, pb.csw),
            _close, rt_src, "aware_tpu/ops/pallas/roundtrip.py:254",
            ana_flops, y2_bytes + basis + cs_bytes,
        ),
        "band_analysis_bwd": (
            lambda: rt.band_analysis_bwd(g_cs, pb.cswt),
            lambda: rt.band_analysis_bwd_plain(g_cs, pb.cswt),
            _close, rt_src, "aware_tpu/ops/pallas/roundtrip.py:281",
            2 * bsz * lr * hop * (rt.R * 2 * p), cs_bytes + basis + y2_bytes,
        ),
        "detector_fused_fwd": (
            lambda: td.detector_fused_fwd(cs, ac.det),
            lambda: td.detector_fused_fwd_plain(cs, ac.det),
            _close_det, det_src, "aware_tpu/ops/pallas/detector.py:310",
            det_flops, det_fwd_bytes,
        ),
        "detector_fused_bwd": (
            lambda: td.detector_fused_bwd(g_det, res_det, ac.det),
            lambda: td.detector_fused_bwd_plain(g_det, res_det, ac.det),
            _close_vjp, det_src, "aware_tpu/ops/pallas/detector.py:401",
            det_flops, det_bwd_bytes,
        ),
        "analysis_detector_fwd": (
            lambda: tad.analysis_detector_fwd(y2, ac),
            lambda: tad.analysis_detector_fwd_plain(y2, ac),
            _close_det, ad_src, "aware_tpu/ops/pallas/analysis_detector.py:177",
            ana_flops + det_flops, y2_bytes + basis + det_fwd_bytes - cs_bytes,
        ),
        "analysis_detector_bwd": (
            lambda: tad.analysis_detector_bwd(g_det, res_ad, ac),
            lambda: tad.analysis_detector_bwd_plain(g_det, res_ad, ac),
            _close_vjp, ad_src, "aware_tpu/ops/pallas/analysis_detector.py:251",
            ana_bwd_flops + det_flops, det_bwd_bytes - cs_bytes + basis + y2_bytes,
        ),
        "iteration_forward_fwd": (
            lambda: it.iteration_forward_fwd(ct, c),
            lambda: it.iteration_forward_fwd_plain(ct, c),
            None, it_src, "aware_tpu/ops/pallas/iteration.py:173",
            it_fwd_flops, it_fwd_bytes,
        ),
        "iteration_forward_bwd": (
            lambda: it.iteration_forward_bwd(g_det, res_it, c),
            lambda: it.iteration_forward_bwd_plain(g_det, res_it, c),
            None, it_src, "aware_tpu/ops/pallas/iteration.py:285",
            it_bwd_flops, it_bwd_bytes,
        ),
        "iteration_step": (
            lambda: it.iteration_step(*st_k, *step_args, bufs),
            lambda: it.iteration_step_plain(*st_p, *step_args),
            None, it_src, "aware_tpu/ops/pallas/iteration.py:513",
            it_fwd_flops + it_bwd_flops, it_step_bytes,
        ),
    }
    records = {}
    for name, (kern, plain, close, source, replaces, flops, nbytes) in cases.items():
        out_k = kern()
        torch.cuda.synchronize()
        out_p = plain()
        if close is None:  # checked by agreement.check_iteration above
            err = rep[name]
        elif close is _close:
            err = close(name, out_k if isinstance(out_k, tuple) else (out_k,),
                        out_p if isinstance(out_p, tuple) else (out_p,))
        else:
            err = close(name, out_k, out_p)
        t_flop = flops / PEAK_BF16_FLOPS * 1e3
        t_byte = nbytes / PEAK_BYTES * 1e3
        rec = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": err,
            "ms": None,
            "plain_ms": None,
            "bound_ms": max(t_flop, t_byte),
            "bound_by": "operations" if t_flop >= t_byte else "bytes",
            # no single PyTorch call computes a shifted-slab product with
            # these prologues and epilogues, nor the detector's chain
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
            f"({rec['bound_by']}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)"
        )
    # the chain the solver runs: the forward kernel, then the VJP kernel on
    # the forward kernel's own residuals, against the plain chain
    for name, fwd, bwd, x, c in (
        ("detector_fused_bwd", td.detector_fused_fwd, td.detector_fused_bwd, cs, ac.det),
        ("analysis_detector_bwd", tad.analysis_detector_fwd, tad.analysis_detector_bwd, y2, ac),
    ):
        _close_vjp(name, bwd(g_det, fwd(x, c)[1], c), cases[name][1](), chain=True)
    return records


def solve_path(torch, kernels, label, emb, det, clips, bits, path_kernels, records) -> None:
    """Phase 3 for one solver path: the 400-iteration batch embed and
    detect, with every count set to 0 just before and read just after; the
    path's kernels must each have launched once per iteration."""
    from aware_tpu_torch import detect_watermark_batch, embed_watermark_batch

    cfg = emb.cfg
    sr = cfg.detection_net.sample_rate
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = embed_watermark_batch(clips, sr, bits, emb)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    got = detect_watermark_batch(out, sr, det)
    launches = {k.__name__: k.launches for k in kernels}
    n_out = (clips.shape[1] // cfg.hop_length) * cfg.hop_length
    if out.shape != (BATCH, n_out) or not np.isfinite(out).all():
        raise RuntimeError(f"embed output {out.shape} is not finite of (B, (T-1)*hop)")
    ber = np.mean(got != bits, axis=1) * 100.0
    ref = clips[:, :n_out]
    snr = 10 * np.log10(np.mean(out**2, 1) / np.mean((out - ref) ** 2, 1))
    say(
        f"phase 3 {label}: B={BATCH} x 10 s x {cfg.num_iterations} iterations: "
        f"embed {embed_s:.3f} s, {BATCH / embed_s:.3f} clips/s, "
        f"BER % per lane {ber.tolist()}, mean SNR {snr.mean():.2f} dB, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
    )
    say(f"phase 3 {label} launches: {launches}")
    if ber.any():
        raise RuntimeError(f"{label}: a lane did not read back its message")
    for name, n in launches.items():
        want = cfg.num_iterations if name in path_kernels else 0
        if n != want:
            raise RuntimeError(f"{label}: kernel {name} launched {n} times, not {want}")
    for name in path_kernels:
        if records[name]["launches"] == 0:  # the first path that runs it
            records[name]["launches"] = launches[name]


SHORT_LOSS_TOL = 0.1  # 10-iteration best loss, card vs CPU, below 32 frames


def short_clips(torch, paths, det_cpu, rng) -> None:
    """Phase 3s: clips of 8, 9, 16 and 31 frames through the solver on each
    path, held at the outcome level against the CPU plain solve: the
    10-iteration best loss within SHORT_LOSS_TOL, and after 400 iterations
    no lane with a higher BER than the CPU's on the same lane.

    SHORT_LOSS_TOL is twice the plain solve's own spread: moving the clips
    by 1e-6 of themselves moves the CPU plain solve's 10-iteration best
    loss by up to 0.053 at these lengths (six seeds; ``PYTHONPATH=. python
    tests/test_torch_slice_iteration.py`` retakes the readings), where the
    norms run over 4 to 15 pooled frames; 0.02, the bound at 626 frames,
    is below that spread."""
    from aware_tpu_torch.embed.solver import build_problem, embed_batch
    from aware_tpu_torch.models.detector import detect_values_batch

    for frames in (8, 9, 16, 31):
        n = (frames - 1) * 256
        clips = np.stack([speechlike(rng, 0.0, 16000, samples=n) for _ in range(2)])
        bits = rng.integers(0, 2, (2, 20))
        x = torch.as_tensor(clips)
        wm = torch.as_tensor(2.0 * bits - 1.0, dtype=torch.float32)
        for label, e, d, _ in paths:
            pb = build_problem(d.net, x.to(e.device), wm.to(e.device), e.cfg)
            if pb.ct0.shape[1] != frames:
                raise RuntimeError(f"{frames} frames expected, got {pb.ct0.shape[1]}")
            out = {}
            for iters in (10, e.cfg.num_iterations):
                cfg = e.cfg.replace(num_iterations=iters)
                res_k = embed_batch(d.net, x.to(e.device), wm.to(e.device), cfg)
                res_p = embed_batch(det_cpu.net, x, wm, cfg)
                out[iters] = (res_k, res_p)
            dloss = float((out[10][0].best_loss.cpu() - out[10][1].best_loss).abs().max())
            res_k, res_p = out[e.cfg.num_iterations]
            ber_k = np.mean((detect_values_batch(d.net, res_k.audio).cpu().numpy() > 0)
                            != bits, axis=1) * 100.0
            ber_p = np.mean((detect_values_batch(det_cpu.net, res_p.audio).numpy() > 0)
                            != bits, axis=1) * 100.0
            say(f"phase 3s {frames} frames, {label} ({pb.path}): 10-iteration best_loss card "
                f"vs CPU plain |diff| {dloss:.3e}; {e.cfg.num_iterations}-iteration BER % per "
                f"lane card {ber_k.tolist()} CPU {ber_p.tolist()}")
            if not dloss < SHORT_LOSS_TOL:
                raise RuntimeError(f"{frames} frames, {label}: the card departs from the CPU")
            if np.any(ber_k > ber_p):
                raise RuntimeError(f"{frames} frames, {label}: a lane reads worse on the card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="phases 0-2, one launch each")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="a directory for the Chrome traces of the phase 3 profiles")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from aware_tpu_torch import detect_watermark, embed_watermark, embed_watermark_batch, load
    from aware_tpu_torch.embed.solver import build_problem, embed_batch, solve
    from aware_tpu_torch.ops.kernels import analysis_detector as tad
    from aware_tpu_torch.ops.kernels import detector as td
    from aware_tpu_torch.ops.kernels import iteration as it
    from aware_tpu_torch.ops.kernels import roundtrip as rt
    from aware_tpu_torch.ops.kernels.build import build

    kernels = rt.KERNELS + td.KERNELS + tad.KERNELS + it.KERNELS
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
    pb = build_problem(det.net, x, wm, cfg)
    if pb.path != "iteration_step":
        raise RuntimeError(f"the default card took the {pb.path} path, not iteration_step")
    records = check_kernels(torch, pb, cfg.hop_length, rng, args.quick)
    del pb

    if not args.quick:
        # ---- phase 3: the four solver paths
        two = ("synth_norm_fwd", "synth_norm_bwd")
        paths = []
        for label, overrides, names in (
            ("default path (whole step)", {}, ("iteration_step",)),
            ("two-kernel path (use_pallas_iteration=False)", {"use_pallas_iteration": False},
             two + ("analysis_detector_fwd", "analysis_detector_bwd", "detector_fused_fwd",
                    "detector_fused_bwd")),
            ("first-slice path (use_pallas_detector=False)", {"use_pallas_detector": False},
             two + ("band_analysis_fwd", "band_analysis_bwd")),
            ("iteration_forward path (NAdam weight decay 1e-4)",
             {"optimizer_params": {"lr": 0.1, "weight_decay": 1e-4}},
             ("iteration_forward_fwd", "iteration_forward_bwd")),
        ):
            e, d = (emb, det) if not overrides else load(device=dev, **overrides)
            paths.append((label, e, d, names))
        for label, e, d, names in paths:
            solve_path(torch, kernels, label, e, d, clips, bits, names, records)
        for name, rec in records.items():
            if rec["launches"] < 1:
                raise RuntimeError(f"kernel {name} was not launched on any path")
        # the first two paths again, in turns (a later solve finds the
        # process warm): the default, the two-kernel path, then both reversed
        turns = []
        for label, e, _, _ in (paths[0], paths[1], paths[1], paths[0]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            embed_watermark_batch(clips, sr, bits, e)
            turns.append(f"{label} {time.perf_counter() - t0:.3f} s")
        say("phase 3 in turns, embed of B=8 x 10 s x 400 iterations: " + "; ".join(turns))

        # the same short solve on the card (kernels) and on the CPU (plain),
        # on each path
        small = clips[:2, : 2 * sr]
        wm2 = torch.as_tensor(2.0 * bits[:2] - 1.0)
        _, det_cpu = load(device="cpu")
        for label, e, d, _ in paths:
            short = e.cfg.replace(num_iterations=10)
            res_k = embed_batch(d.net, torch.as_tensor(small, device=dev), wm2.to(dev), short)
            res_p = embed_batch(det_cpu.net, torch.as_tensor(small), wm2, short)
            dloss = float((res_k.best_loss.cpu() - res_p.best_loss).abs().max())
            say(f"phase 3 reference, {label}: 10-iteration best_loss card vs CPU plain "
                f"|diff| {dloss:.3e}")
            if not dloss < 0.02:
                raise RuntimeError(f"{label}: the card's solve departs from the plain solve")

        for i, (label, e, d, _) in enumerate(paths):
            prof_cfg = e.cfg.replace(num_iterations=20)
            trace = f"{args.trace}/trace_path{i}.json" if args.trace else None
            say(f"phase 3 profile, {label}, B={BATCH} x 20 iterations: " + profile_solve(
                torch, lambda: embed_batch(d.net, x, wm, prof_cfg), trace))

        # the default path's loop makes no host sync (no .item(), no copy to
        # the host): torch raises on one in this mode
        loop_cfg = cfg.replace(num_iterations=20)
        pb = build_problem(det.net, x, wm, loop_cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            solve(pb, det.net, loop_cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        say("phase 3 default path: a 20-iteration loop ran with no host sync")
        del pb

        # ---- phase 3s: short clips on every path
        short_clips(torch, paths, det_cpu, rng)

        # ---- phase 4: one clip at 44.1 kHz
        for k in kernels:
            k.launches = 0
        clip44 = speechlike(rng, 2.0, 44100)
        msg = rng.integers(0, 2, cfg.detection_net.output_length)
        t0 = time.perf_counter()
        wm44 = embed_watermark(clip44, 44100, msg, emb)
        one_s = time.perf_counter() - t0
        got44 = detect_watermark(wm44, 44100, det)
        ber44 = float(np.mean(got44 != msg) * 100.0)
        launches44 = {k.__name__: k.launches for k in kernels}
        say(f"phase 4 single clip 2 s @ 44.1 kHz: embed {one_s:.3f} s, "
            f"BER {ber44} %, launches {launches44}")
        if ber44 != 0.0 or wm44.shape != clip44.shape or not np.isfinite(wm44).all():
            raise RuntimeError("single-clip round trip failed")
        if launches44["iteration_step"] != cfg.num_iterations:
            raise RuntimeError("the single-clip embed did not run the whole-step kernel")

    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
