#!/usr/bin/env python3
"""Chip check of aware_tpu_torch on one CUDA card (written for an H100).

    python3 chip_smoke.py            # all phases, the default card's 400 iterations
    python3 chip_smoke.py --quick    # phases 0-2 only, each kernel checked, none timed

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
   NAdam / clamp / best epilogue given the same input.  Then the long
   path's kernels on its operands (B = 8 clips of T = 3751 frames, 60 s):
   shift_mm at each of its three uses and the tiled synthesis, on the
   problem's coefficients and on a probe whose last frame is loud (the
   rows past the crop set m1), to 1e-3 * max|plain|.  Then ola_normalize,
   forward and VJP, on the "ola" path's frames (B = 8, T = 626) and on
   random frames at B = 3, T = 63 with a silent lane, to the JAX suite's
   tolerances for it (forward atol/rtol 1e-6, VJP atol 1e-5, rtol 1e-4),
   and a tie probe (two ties of opposite sign at the peak of y2: each must
   take K / 2 of the peak-norm's gradient).
   Device times of kernel and plain version (CUDA-graph replays timed by
   CUDA events), per-call times from Python, the bound of each, and where
   one PyTorch call computes the same function (band_analysis and
   shift_mm: a 4-tap bf16 conv1d, band_analysis's VJP its
   conv_transpose1d) that call's device time;
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
   44.1 kHz (the resample path), on the default path;
5. long clips: load() -> embed_watermark_batch of 8 speech-like 60 s
   clips (T = 3751 frames, over the whole-clip kernels' 1024: the tiled
   path on the default card, whatever its detector and iteration flags)
   -> detect_watermark_batch: 0 % BER on
   every lane, shift_mm launched 3 times and synth_tiled_fwd once per
   iteration, every other kernel never; a torch.profiler breakdown of a
   20-iteration solve; and a 10-iteration solve of 2 clips of T = 1025 and
   of T = 1281 on the card against the same solve through the plain
   versions on the CPU;
6. the float32 round trips: load("config") (the JAX package's default
   card file, matmul_precision: highest) -> embed_watermark_batch of the
   phase 3 clips (8 x 10 s, 400 iterations) -> detect_watermark_batch on
   the "slab" path (bare), "ola" (use_pallas_ola=True), "frames"
   (use_slab_dft=False) and "fft" (use_matmul_dft=False): 0 % BER on
   every lane, the ola_normalize kernels launched once per iteration each
   on "ola", and no kernel at all on the other three; a 10-iteration solve
   per path on the card against the CPU's; a torch.profiler breakdown of a
   20-iteration solve on "ola"; and 2 clips of 1030 frames under the card
   file, which keep the slab path (no tiled kernel) and read back at 0 %.

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
LIB_TOL = 1e-2            # a bf16-output library call vs plain, relative to max|plain|
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


def profile_solve(torch, run, trace: str | None = None, marker: str = "shift_gemm") -> str:
    """Device time by kind of kernel over one call of ``run``; with
    ``trace``, the Chrome trace is written to that file.  The solver
    loop's window runs from the first launch of a kernel whose name holds
    ``marker`` to the end of the last (set-up and reconstruction launch
    none)."""
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
            "reflect_fold", "fold_scalars", "nadam_fold", "best_loss_update", "ola_")
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
    # the solver loop's own window, and the device's idle share inside it
    spans = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start]
    gemms = [(a, b) for a, b, n in spans if marker in n]
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


def _record(name, source, replaces, err, flops, nbytes, library_ms=None) -> dict:
    """One kernel's record; bound = max(FLOP / peak, bytes / peak rate)."""
    t_flop = flops / PEAK_BF16_FLOPS * 1e3
    t_byte = nbytes / PEAK_BYTES * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": None, "plain_ms": None,
        "bound_ms": max(t_flop, t_byte),
        "bound_by": "operations" if t_flop >= t_byte else "bytes",
        "library_ms": library_ms,
    }


def _library_ms(torch, name, call, ref, quick):
    """Device ms of one PyTorch call that computes a kernel's function,
    its (B, E, rows) bf16 output first held to LIB_TOL * max|plain| against
    the plain version's (B, rows, E); None with ``quick``."""
    out = call().float().transpose(1, 2)
    if out.shape != ref.shape:
        raise RuntimeError(f"{name} library call: shape {tuple(out.shape)}")
    err = float((out - ref).abs().max())
    if err > LIB_TOL * float(ref.abs().max()):
        raise RuntimeError(f"{name} library call: max error {err:.3e} over {LIB_TOL} * max|plain|")
    return None if quick else time_ms(torch, call, REPS)[0]


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
    # one PyTorch call that computes the analysis and its VJP: a 4-tap bf16
    # conv1d over the hop-wide rows (2 rows of padding each side), and its
    # conv_transpose1d, on bf16 channels-first copies of the inputs
    import torch.nn.functional as F

    y2_t = y2.to(torch.bfloat16).transpose(1, 2).contiguous()
    csw_w = pb.csw.reshape(rt.R, hop, 2 * p).permute(2, 1, 0).contiguous()
    g_t = g_cs.to(torch.bfloat16).transpose(1, 2).contiguous()
    cswt_w = pb.cswt.reshape(2 * p, rt.R, hop).permute(0, 2, 1).contiguous()
    library = {
        "band_analysis_fwd": lambda: F.conv1d(y2_t, csw_w, padding=rt.PAD),
        "band_analysis_bwd": lambda: F.conv_transpose1d(g_t, cswt_w, padding=rt.PAD),
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
        # no single PyTorch call computes the synthesis' shifted-slab product
        # with its prologue and epilogue, nor the detector's chain
        rec = _record(name, source, replaces, err, flops, nbytes)
        if name in library:
            ref = out_p[0] if isinstance(out_p, tuple) else out_p
            rec["library_ms"] = _library_ms(torch, name, library[name], ref, quick)
        call = (None, None)
        if not quick:
            rec["ms"], call_k = time_ms(torch, kern, REPS)
            rec["plain_ms"], call_p = time_ms(torch, plain, REPS)
            call = (call_k, call_p)
        records[name] = rec
        say(
            f"phase 2 kernel {name}: max_abs_err {err:.3e} device ms {rec['ms']} "
            f"plain device ms {rec['plain_ms']} library device ms {rec['library_ms']} "
            f"(per call from Python: kernel {call[0]} plain {call[1]}) bound_us "
            f"{rec['bound_ms'] * 1e3:.2f} ({rec['bound_by']}; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB)"
        )
    # the chain the solver runs: the forward kernel, then the VJP kernel on
    # the forward kernel's own residuals, against the plain chain
    for name, fwd, bwd, x, c in (
        ("detector_fused_bwd", td.detector_fused_fwd, td.detector_fused_bwd, cs, ac.det),
        ("analysis_detector_bwd", tad.analysis_detector_fwd, tad.analysis_detector_bwd, y2, ac),
    ):
        _close_vjp(name, bwd(g_det, fwd(x, c)[1], c), cases[name][1](), chain=True)
    return records


def check_tiled_kernels(torch, pb, rng, quick: bool) -> dict:
    """Phase 2, the long path's kernels (rows 12-13) on its operands
    (B = 8, T = 3751): shift_mm at each of its three uses, the tiled
    synthesis on the problem's coefficients and on a probe (y_const 0, env
    4, the last frame 50 times each bin's largest) whose rows past the crop
    set m1; each to TOL * max|plain|.  Returns one record per kernel;
    shift_mm's numbers are the mean over its three uses, one launch each."""
    import torch.nn.functional as F

    from aware_tpu_torch.ops.kernels import roundtrip as rt
    from aware_tpu_torch.ops.kernels import roundtrip_tiled as rtt

    bsz, t, p = pb.ct0.shape
    lr, hop = pb.env.shape
    dev = pb.ct0.device
    tc = pb.tiled
    ct = pb.ct0.contiguous()
    src = "aware_tpu_torch/csrc/roundtrip_tiled.cu"
    # the tail probe first: the last frame reaches rows lr-2 .. lr+1; rows
    # below lr are divided by the envelope, the two past the crop are not
    loud = ct.clone()
    loud[:, -1:] = 50.0 * ct.amax(dim=1, keepdim=True)
    probe = (loud, tc.csinp, torch.zeros_like(pb.y_const), torch.full_like(pb.env, 4.0),
             tc.w_sf)
    u_k, m1_k = rtt.synth_tiled_fwd(*probe)
    err_tail = _close("synth_tiled_fwd tail probe", (u_k, m1_k), rtt.synth_tiled_fwd_plain(*probe))
    inner = u_k.abs().amax(dim=(1, 2))
    say(f"  synth_tiled_fwd tail probe: m1 {m1_k.tolist()} against max|u| {inner.tolist()}, "
        f"max error {err_tail:.3e}")
    if not torch.all(m1_k > inner):
        raise RuntimeError("synth_tiled_fwd: the tail probe's m1 was not set past the crop")

    synth = (ct, tc.csinp, pb.y_const, pb.env, tc.w_sf)
    u, m1 = rtt.synth_tiled_fwd_plain(*synth)
    y2 = u / rt.peak_den(m1)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)

    uses = {  # the three uses: (x, w, n_out), x as the autograd ops pad it
        "analysis forward (w_af)": (F.pad(y2, (0, 0, 2, 0)), tc.w_af, t),
        "analysis VJP (w_ab)": (F.pad(rand(bsz, t, 2 * p), (0, 0, 3, 0)), tc.w_ab, lr + 3),
        "synthesis VJP (w_sb)": (F.pad(rand(bsz, lr, hop), (0, 0, 2, 0)), tc.w_sb, t),
    }
    recs = []
    for use, (x, w, n_out) in uses.items():
        _, n, d = x.shape
        e = w.shape[-1]
        kern = lambda x=x, w=w, n_out=n_out: rtt.shift_mm(x, w, n_out)  # noqa: E731
        plain = lambda x=x, w=w, n_out=n_out: rtt.shift_mm_plain(x, w, n_out)  # noqa: E731
        out_p = plain()
        err = _close(f"shift_mm {use}", (kern(),), (out_p,))
        # the library's 4-tap conv1d, on a bf16 channels-first copy of x
        # with the zero rows the kernel reads past N
        x_t = F.pad(x, (0, 0, 0, n_out + rtt.HALO - n)).to(torch.bfloat16).transpose(1, 2)
        x_t, w_t = x_t.contiguous(), w.permute(2, 1, 0).contiguous()
        lib = _library_ms(torch, f"shift_mm {use}", lambda x_t=x_t, w_t=w_t: F.conv1d(x_t, w_t),
                          out_p, quick)
        flops = 2 * bsz * n_out * rtt.R * d * e
        nbytes = bsz * n * d * F32 + rtt.R * d * e * BF16 + bsz * n_out * e * F32
        rec = _record("shift_mm", src, "aware_tpu/ops/pallas/roundtrip_tiled.py:103", err,
                      flops, nbytes, library_ms=lib)
        if not quick:
            rec["ms"] = time_ms(torch, kern, REPS)[0]
            rec["plain_ms"] = time_ms(torch, plain, REPS)[0]
        say(f"phase 2 kernel shift_mm, {use}: max_abs_err {err:.3e} device ms {rec['ms']} "
            f"plain device ms {rec['plain_ms']} library device ms {lib} bound_us "
            f"{rec['bound_ms'] * 1e3:.2f} ({rec['bound_by']}; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB)")
        recs.append(rec)
    shift = dict(recs[0])
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [r[key] for r in recs]
        shift[key] = None if None in vals else sum(vals) / len(vals)
    shift["max_abs_err"] = max(r["max_abs_err"] for r in recs)

    kern = lambda: rtt.synth_tiled_fwd(*synth)  # noqa: E731
    plain = lambda: rtt.synth_tiled_fwd_plain(*synth)  # noqa: E731
    err = max(_close("synth_tiled_fwd", kern(), plain()), err_tail)
    rows = rtt.m1_rows(lr)
    flops = 2 * bsz * rows * rtt.R * 2 * p * hop
    # ct, csinp, y_const, env, w_sf in; u, m1 out
    nbytes = (bsz * t * p * F32 + bsz * (t + rtt.HALO) * 2 * p * F32 + 2 * bsz * lr * hop * F32
              + lr * hop * F32 + rtt.R * 2 * p * hop * BF16 + bsz * F32)
    # no single PyTorch call builds the phase products, divides by the
    # envelope and takes the per-clip max
    synth_rec = _record("synth_tiled_fwd", src, "aware_tpu/ops/pallas/roundtrip_tiled.py:214",
                        err, flops, nbytes)
    if not quick:
        synth_rec["ms"] = time_ms(torch, kern, REPS)[0]
        synth_rec["plain_ms"] = time_ms(torch, plain, REPS)[0]
    say(f"phase 2 kernel synth_tiled_fwd: max_abs_err {err:.3e} device ms {synth_rec['ms']} "
        f"plain device ms {synth_rec['plain_ms']} bound_us {synth_rec['bound_ms'] * 1e3:.2f} "
        f"({synth_rec['bound_by']}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return {"shift_mm": shift, "synth_tiled_fwd": synth_rec}


OLA_FWD_TOL = (1e-6, 1e-6)   # ola_normalize forward: atol, rtol (tests/test_pallas.py:43)
OLA_VJP_TOL = (1e-5, 1e-4)   # its VJP (tests/test_pallas.py:65-67)


def _close_ola(name, out, ref, tol) -> float:
    """ola_normalize: |out - plain| <= atol + rtol |plain| everywhere, the
    JAX suite's test of this kernel; returns the largest error."""
    atol, rtol = tol
    if out.shape != ref.shape or not out.isfinite().all():
        raise RuntimeError(f"{name}: bad output {tuple(out.shape)}")
    err = (out - ref).abs()
    if (err > atol + rtol * ref.abs()).any():
        raise RuntimeError(f"{name}: max error {float(err.max()):.3e} over atol {atol} + "
                           f"rtol {rtol} * |plain|")
    return float(err.max())


def check_ola_kernels(torch, pb, rng, quick: bool) -> dict:
    """Phase 2, rows 14-15: ola_normalize forward and VJP against their
    plain versions, to the JAX suite's tolerances for this kernel: on the
    "ola" path's frames at its start (B = 8, T = 626) and on random frames
    at B = 3, T = 63 (odd rows) with a silent lane; the VJP from the plain
    forward's y2 and m1, and from the kernel's own.  Then the tie probe: y2
    with the peak magnitude at two places of opposite sign, where each tie
    must take K / 2 off g / c with its sign.  Returns one record each."""
    from aware_tpu_torch.ops.kernels import ola_norm as on
    from aware_tpu_torch.ops.stft import _ola_envelope
    from aware_tpu_torch.ops.windows import get_window

    bsz, t, _ = pb.ct0.shape
    lr, hop = pb.env.shape
    n_fft = on.R * hop
    dev = pb.ct0.device
    src = "aware_tpu_torch/csrc/ola_norm.cu"

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)

    c = pb.plain
    coeffs = pb.ct0[..., : pb.nb]
    frames = (c.frames_const + torch.cat([coeffs * c.cos, coeffs * c.sin], -1) @ c.ab).contiguous()
    small = rand(3, 63, n_fft)
    small[1] = 0.0  # a silent lane
    wkey = tuple(get_window("hann", n_fft).tolist())
    env_small = torch.as_tensor(_ola_envelope(wkey, n_fft, hop, 63), dtype=torch.float32,
                                device=dev).reshape(62, hop)
    err_f = err_b = 0.0
    for label, wf, env in (("B=8, T=626", frames, pb.env), ("B=3, T=63", small, env_small)):
        y2p, m1p = on.ola_normalize_fwd_plain(wf, env)
        y2, m1 = on.ola_normalize_fwd(wf, env)
        err_f = max(err_f, _close_ola(f"ola_normalize_fwd {label} y2", y2, y2p, OLA_FWD_TOL),
                    _close_ola(f"ola_normalize_fwd {label} m1", m1, m1p, OLA_FWD_TOL))
        g = rand(*y2p.shape)
        for res, (yy, mm) in (("plain", (y2p, m1p)), ("own", (y2, m1))):
            err_b = max(err_b, _close_ola(
                f"ola_normalize_bwd {label} from the {res} residuals",
                on.ola_normalize_bwd(g, yy, env, mm),
                on.ola_normalize_bwd_plain(g, yy, env, mm), OLA_VJP_TOL))
        if label.startswith("B=3") and not (float(m1[1]) == 0.0 and not y2[1].any()):
            raise RuntimeError("ola_normalize_fwd: the silent lane is not silent")
    # the tie probe: lane 0's y2 with +2 and -2 above every other |y2|
    y2p, m1p = on.ola_normalize_fwd_plain(frames, pb.env)
    g = rand(bsz, lr, hop)
    ties = y2p.clone()
    spots = ((3, 5, 2.0), (lr - 2, 100, -2.0))  # (row, column, value)
    for j, col, v in spots:
        ties[0, j, col] = v
    dwf = on.ola_normalize_bwd(g, ties, pb.env, m1p)
    err_b = max(err_b, _close_ola("ola_normalize_bwd tie probe", dwf,
                                  on.ola_normalize_bwd_plain(g, ties, pb.env, m1p),
                                  OLA_VJP_TOL))
    m = float(m1p[0])
    cc = (m + 1e-8) * (m / (m + 1e-8) + 1e-8)
    q = float((g[0].double() * ties[0].double()).sum())
    k_coef = (m / (m + 1e-8) + 1e-8) * q * (1e-8 + cc) / (cc * cc)
    shares = []
    for j, col, v in spots:
        k = 0 if j + on.PAD < t else on.R - 1  # a slice of dwf that holds row j
        g_env = float(dwf[0, j + on.PAD - k, k * hop + col]) * float(pb.env[j, col])
        g_c = float(g[0, j, col]) / cc
        shares.append(g_c - g_env)
        if abs(shares[-1] - np.sign(v) * k_coef / 2) > 1e-3 * (abs(k_coef / 2) + abs(g_c)):
            raise RuntimeError(f"ola_normalize_bwd tie probe: the tie at row {j} took "
                               f"{shares[-1]:.6e}, not {np.sign(v) * k_coef / 2:.6e} = K / 2")
    say(f"  ola_normalize tie probe: the two ties took {shares[0]:.6e} and {shares[1]:.6e} "
        f"of K = {k_coef:.6e}; silent lane m1 0, y2 0, VJP finite")

    g = rand(bsz, lr, hop)
    y2p, m1p = on.ola_normalize_fwd_plain(frames, pb.env)
    f32_rows = bsz * lr * hop * F32
    cases = {  # name: (kernel, plain, replaces, bytes in + out, largest error)
        "ola_normalize_fwd": (
            lambda: on.ola_normalize_fwd(frames, pb.env),
            lambda: on.ola_normalize_fwd_plain(frames, pb.env),
            "aware_tpu/ops/pallas/ola_norm.py:135",
            bsz * t * n_fft * F32 + lr * hop * F32 + f32_rows + bsz * F32, err_f),
        "ola_normalize_bwd": (
            lambda: on.ola_normalize_bwd(g, y2p, pb.env, m1p),
            lambda: on.ola_normalize_bwd_plain(g, y2p, pb.env, m1p),
            "aware_tpu/ops/pallas/ola_norm.py:167",
            2 * f32_rows + lr * hop * F32 + bsz * F32 + bsz * t * n_fft * F32, err_b),
    }
    records = {}
    for name, (kern, plain, replaces, nbytes, err) in cases.items():
        # a few operations per element: bytes bound both; no single
        # PyTorch call computes either (F.fold does the overlap-add alone)
        rec = _record(name, src, replaces, err, 0, nbytes)
        if not quick:
            rec["ms"] = time_ms(torch, kern, REPS)[0]
            rec["plain_ms"] = time_ms(torch, plain, REPS)[0]
        records[name] = rec
        say(f"phase 2 kernel {name}: max_abs_err {err:.3e} device ms {rec['ms']} plain device "
            f"ms {rec['plain_ms']} bound_us {rec['bound_ms'] * 1e3:.2f} ({rec['bound_by']}; "
            f"{nbytes / 1e6:.2f} MB)")
    return records


def solve_path(torch, kernels, label, emb, det, clips, bits, per_iteration, records,
               phase="3") -> None:
    """One solver path: the batch embed and detect, with every count set to
    0 just before and read just after; each of the path's kernels
    (``per_iteration``: name -> launches per iteration) must have launched
    that many times per iteration, every other kernel never."""
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
        f"phase {phase} {label}: B={BATCH} x {clips.shape[1] / sr:g} s x "
        f"{cfg.num_iterations} iterations: "
        f"embed {embed_s:.3f} s, {BATCH / embed_s:.3f} clips/s, "
        f"BER % per lane {ber.tolist()}, mean SNR {snr.mean():.2f} dB, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
    )
    say(f"phase {phase} {label} launches: {launches}")
    if ber.any():
        raise RuntimeError(f"{label}: a lane did not read back its message")
    for name, n in launches.items():
        want = cfg.num_iterations * per_iteration.get(name, 0)
        if n != want:
            raise RuntimeError(f"{label}: kernel {name} launched {n} times, not {want}")
    for name in per_iteration:
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
    from aware_tpu_torch import (
        detect_watermark,
        detect_watermark_batch,
        embed_watermark,
        embed_watermark_batch,
        load,
    )
    from aware_tpu_torch.embed.solver import build_problem, embed_batch, solve
    from aware_tpu_torch.ops.kernels import analysis_detector as tad
    from aware_tpu_torch.ops.kernels import detector as td
    from aware_tpu_torch.ops.kernels import iteration as it
    from aware_tpu_torch.ops.kernels import ola_norm as on
    from aware_tpu_torch.ops.kernels import roundtrip as rt
    from aware_tpu_torch.ops.kernels import roundtrip_tiled as rtt
    from aware_tpu_torch.ops.kernels.build import build

    kernels = rt.KERNELS + td.KERNELS + tad.KERNELS + it.KERNELS + rtt.KERNELS + on.KERNELS
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
    # the long path's kernels on its operands: 8 clips of 60 s, from a
    # generator of their own, so that the other phases' data do not depend
    # on this phase
    long_rng = np.random.default_rng([args.seed, 60])
    long_clips = np.stack([speechlike(long_rng, 60.0, sr) for _ in range(BATCH)])
    long_bits = long_rng.integers(0, 2, (BATCH, cfg.detection_net.output_length))
    x_long = torch.as_tensor(long_clips, device=dev)
    wm_long = torch.as_tensor(2.0 * long_bits - 1.0, device=dev)
    pb = build_problem(det.net, x_long, wm_long, cfg)
    if pb.path != "tiled" or pb.ct0.shape[1] != 3751:
        raise RuntimeError(f"8 x 60 s took the {pb.path} path at T = {pb.ct0.shape[1]}")
    records.update(check_tiled_kernels(torch, pb, long_rng, args.quick))
    del pb
    # rows 14-15 on the "ola" path's operands (the 10 s clips), with random
    # data from a generator of their own
    emb_ola, det_ola = load("config", device=dev, use_pallas_ola=True)
    pb = build_problem(det_ola.net, x, wm, emb_ola.cfg)
    if pb.path != "ola":
        raise RuntimeError(f"use_pallas_ola took the {pb.path} path, not ola")
    records.update(check_ola_kernels(torch, pb, np.random.default_rng([args.seed, 14]),
                                     args.quick))
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
            solve_path(torch, kernels, label, e, d, clips, bits, dict.fromkeys(names, 1),
                       records)
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

        # ---- phase 5: long clips, the tiled path
        solve_path(torch, kernels, "long clips (tiled path)", emb, det, long_clips, long_bits,
                   {"shift_mm": 3, "synth_tiled_fwd": 1}, records, phase="5")
        prof_cfg = cfg.replace(num_iterations=20)
        trace = f"{args.trace}/trace_long.json" if args.trace else None
        say(f"phase 5 profile, long clips, B={BATCH} x 60 s x 20 iterations: " + profile_solve(
            torch, lambda: embed_batch(det.net, x_long, wm_long, prof_cfg), trace))
        short = cfg.replace(num_iterations=10)
        for frames in (1025, 1281):
            n = (frames - 1) * cfg.hop_length
            pair = torch.as_tensor(np.stack([speechlike(long_rng, 0.0, sr, samples=n)
                                             for _ in range(2)]))
            wm2 = torch.as_tensor(2.0 * long_rng.integers(0, 2, (2, 20)) - 1.0,
                                  dtype=torch.float32)
            res_k = embed_batch(det.net, pair.to(dev), wm2.to(dev), short)
            res_p = embed_batch(det_cpu.net, pair, wm2, short)
            dloss = float((res_k.best_loss.cpu() - res_p.best_loss).abs().max())
            say(f"phase 5 reference, T = {frames}: 10-iteration best_loss card vs CPU plain "
                f"|diff| {dloss:.3e}")
            if not dloss < 0.02:
                raise RuntimeError(f"T = {frames}: the card's tiled solve departs from the plain solve")

        # ---- phase 6: the float32 round trips, from the default card file
        xla = []
        for label, overrides, path, names in (
            ('"slab" path (load("config"))', {}, "slab", ()),
            ('"ola" path (use_pallas_ola=True)', {"use_pallas_ola": True}, "ola",
             ("ola_normalize_fwd", "ola_normalize_bwd")),
            ('"frames" path (use_slab_dft=False)', {"use_slab_dft": False}, "frames", ()),
            ('"fft" path (use_matmul_dft=False)', {"use_matmul_dft": False}, "fft", ()),
        ):
            e, d = (emb_ola, det_ola) if path == "ola" else load("config", device=dev, **overrides)
            got = build_problem(d.net, x, wm, e.cfg).path
            if got != path:
                raise RuntimeError(f"{label} took the {got} path")
            xla.append((label, e, d))
            solve_path(torch, kernels, label, e, d, clips, bits, dict.fromkeys(names, 1),
                       records, phase="6")
        pair = torch.as_tensor(clips[:2, : 2 * sr])
        wm_pair = torch.as_tensor(2.0 * bits[:2] - 1.0, dtype=torch.float32)
        for label, e, d in xla:
            short = e.cfg.replace(num_iterations=10)
            res_k = embed_batch(d.net, pair.to(dev), wm_pair.to(dev), short)
            res_p = embed_batch(det_cpu.net, pair, wm_pair, short)
            dloss = float((res_k.best_loss.cpu() - res_p.best_loss).abs().max())
            say(f"phase 6 reference, {label}: 10-iteration best_loss card vs CPU plain "
                f"|diff| {dloss:.3e}")
            if not dloss < 0.02:
                raise RuntimeError(f"{label}: the card's solve departs from the plain solve")
        _, e, d = xla[1]
        prof_cfg = e.cfg.replace(num_iterations=20)
        trace = f"{args.trace}/trace_ola.json" if args.trace else None
        say(f"phase 6 profile, \"ola\" path, B={BATCH} x 20 iterations: " + profile_solve(
            torch, lambda: embed_batch(d.net, x, wm, prof_cfg), trace, marker="ola_"))
        # a clip over 1024 frames under the card file keeps the slab path
        _, e, d = xla[0]
        r1030 = np.random.default_rng([args.seed, 1030])
        pair = np.stack([speechlike(r1030, 0.0, sr, samples=1029 * cfg.hop_length)
                         for _ in range(2)])
        bits2 = r1030.integers(0, 2, (2, cfg.detection_net.output_length))
        got = build_problem(d.net, torch.as_tensor(pair, device=dev),
                            torch.as_tensor(2.0 * bits2 - 1.0, device=dev), e.cfg)
        if got.path != "slab" or got.ct0.shape[1] != 1030:
            raise RuntimeError(f"1030 frames under the card file: {got.path}, T = {got.ct0.shape[1]}")
        del got
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = embed_watermark_batch(pair, sr, bits2, e)
        torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
        ber = np.mean(detect_watermark_batch(out, sr, d) != bits2, axis=1) * 100.0
        launched = {k.__name__: k.launches for k in kernels if k.launches}
        say(f"phase 6 1030 frames under the card file (slab): B=2 x {cfg.num_iterations} "
            f"iterations, embed {embed_s:.3f} s, BER % per lane {ber.tolist()}, kernels "
            f"launched {launched}")
        if launched or ber.any() or not np.isfinite(out).all():
            raise RuntimeError("1030 frames under the card file: a kernel ran or a lane failed")

        for name, rec in records.items():
            if rec["launches"] < 1:
                raise RuntimeError(f"kernel {name} was not launched on any path")

    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
