#!/usr/bin/env python3
"""Chip check of aware_tpu_torch on one CUDA card (written for an H100).

    python3 chip_smoke.py            # all phases, the default card's 400 iterations
    python3 chip_smoke.py --quick    # phases 0-2 and 8's filter checks, none timed
    python3 chip_smoke.py --reference-lib LIB  # also: rows 9-11 give LIB's bits

Phases, each printing one progress line (plus details) and failing the run
with a non-zero exit on any error:

0. the card: nvidia-smi's name and power limit, torch and CUDA versions;
1. build: nvcc of aware_tpu_torch/csrc into aware_tpu_torch/_build (one
   nvcc per source, started together, then one link), with its seconds and
   the ptxas register / shared-memory / spill lines; for the sm90 GEMMs
   (the slab GEMM of shift_mm, the band_analysis pair, the step's round
   trip and the synth_norm pair; the dense GEMM of the step's detector
   products) the tile,
   grid, threads, ring stages and dynamic shared memory of each launch the
   main paths make, each instance's registers at entry, which must be what
   its setmaxnreg split assumes, and the HGMMA and UTMALDG instructions in
   its SASS (cuobjdump), none of either failing the run; for the
   ola_normalize cluster kernels (rows 14-15) at each cluster size, the
   registers, static and dynamic shared memory, spills and
   cudaOccupancyMaxActiveClusters;
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
   forward and VJP, each variant (one cluster a clip at 8 and at 16 CTAs,
   and the stream variant) and the wrappers, on the "ola" path's frames
   (B = 8, T = 626), on random frames at B = 3, T = 63 with a silent lane
   and at B = 2, T = 3751 (past the cluster's room: the wrappers take the
   stream variant), to the JAX suite's tolerances for it (forward
   atol/rtol 1e-6, VJP atol 1e-5, rtol 1e-4), the cluster forward the
   stream forward's bits, the cluster VJP the same bits on two launches,
   and a tie probe (two ties of opposite sign at the peak of y2, in
   different CTAs: each must take K / 2 of the peak-norm's gradient); the
   variants and the plain version timed in turns.
   Device times of kernel and plain version (CUDA-graph replays timed by
   CUDA events), per-call times from Python, the bound of each, and where
   one PyTorch call computes the same function (band_analysis and
   shift_mm: a 4-tap bf16 conv1d, band_analysis's VJP its
   conv_transpose1d) that call's device time.  The three sm90 slab-GEMM
   kernels (shift_mm at each use, the band_analysis forward and VJP) must
   give the same bits on two launches, and are timed in turns beside
   their first WMMA versions (aw_*_wmma, held to TOL too, reached by no
   path), their plain versions and the library call (new, WMMA, plain,
   library, then the reverse).  iteration_step (the sm90 chain) must give
   the same bits on two launches from one state, each of its 14 GEMMs
   alone the same bits twice and an rms error against float64 within
   SUM_TOL of the plain product's; each launch of it and of its first WMMA
   chain (aw_iteration_step_wmma) is timed beside its bound, and the two
   chains and the plain version in turns; with --reference-lib, it must
   give the bits of another build's aw_iteration_step from the same state.
   The kernels redesigned as parts of that chain (redesign_checks) must
   give the same bits on two launches and, like their first WMMA chains
   (aw_*_wmma), meet the agreement bounds against their plain versions;
   each of their launches is timed beside its bound, and each with its
   WMMA chain and its plain version in turns: iteration_forward_bwd (the
   step's backward half from g, then the phase fold; with
   --reference-lib also the bits of that build's aw_iteration_bwd),
   iteration_forward_fwd (the step's forward half; pred and every
   residual to ITER_FWD_TOL, y2 and m1 to Y2_TOL; the sm90 VJP on the
   WMMA forward's residuals as a chain; with --reference-lib also the
   bits of that build's aw_iteration_fwd_sm90), detector_fused_fwd (the forward
   half's detector part from cs) and analysis_detector_fwd (its reflect
   analysis, then that; FWD_TOL and SHARE_TOL both), detector_fused_bwd
   (the backward half's detector VJP from g) and analysis_detector_bwd
   (that VJP, then the backward half's reflect analysis VJP and the
   fold; VJP_TOL both), synth_norm_fwd (the forward half's synthesis,
   then the scale of u into y2; its first two launches alone, aw_synth_u,
   must give aw_iteration_fwd_sm90's u and m1 bit for bit on the same ct)
   and synth_norm_bwd (the backward half's synthesis VJP on y2 itself,
   with no reflect fold, then the phase fold; also on a tie probe: TIES
   more samples of each clip at its peak, both signs, m1 = 3), both to
   TOL.  The tiled
   synthesis (a reim pass, then the slab GEMM) must give the same bits on
   two launches and from its two launches alone, its pass exactly ct
   csinp, its GEMM's sums an rms error against float64 within SUM_TOL of
   the plain product's, and u and m1 exactly what the tail rule makes of
   those sums (on the problem and on the tail probe); it, its WMMA version
   (aw_synth_tiled_fwd_wmma), the plain version and its two launches alone
   are timed in turns;
3. main path: load() -> embed_watermark_batch on 8 speech-like 10 s 16 kHz
   clips with random 20-bit messages (400 iterations) -> detect_watermark_
   batch, on the four solver paths: the default (the iteration_step kernel
   once per iteration), use_pallas_iteration=False (synth_norm ->
   analysis_detector -> detector_fused kernels), use_pallas_detector=False
   (synth_norm -> band_analysis -> plain detector) and NAdam with weight
   decay (the iteration_forward kernels and their VJP); every lane must
   read back at 0 % BER, and each kernel of a path must have been launched
   once per iteration by its solve, every other kernel never.  Then the
   default, two-kernel and weight-decay paths timed again in turns (then
   reversed); per path, a small reference (a short solve on the card
   against the same solve through the plain versions on the CPU), a torch.profiler
   breakdown of a 20-iteration solve, and, on the default path, a
   20-iteration loop under torch.cuda.set_sync_debug_mode("error") (no
   host sync);
3s. short clips: on each of the four paths, 2 clips each of T = 8, 9, 16
   and 31 frames through the solver: the 10-iteration best loss within
   SHORT_LOSS_TOL of the CPU plain solve's, and at 16 and 31 frames after
   400 iterations no lane with a higher BER than the CPU plain solve's on
   the same lane; at 8 and 9 frames, where one solve's BER on a lane is a
   draw (for the CPU reference too), a one-sided sign test over 64 lanes
   a path (16 clip pairs a length from fixed seeds): the card is refused
   when it reads worse than the CPU plain solve on so many more lanes
   than better that chance gives as many less than once in 1000
   (agreement.short_outcome); the CPU plain solve from the clips moved by
   1e-6 of themselves is printed beside it on the default path;
4. single clip: embed_watermark / detect_watermark of a 2 s clip given at
   44.1 kHz (the resample path), on the default path;
5. long clips: load() -> embed_watermark_batch of 8 speech-like 60 s
   clips (T = 3751 frames, over the whole-clip kernels' 1024: the tiled
   path on the default card, whatever its detector and iteration flags)
   -> detect_watermark_batch: 0 % BER on
   every lane, shift_mm launched 3 times and synth_tiled_fwd once per
   iteration, every other kernel never; a torch.profiler breakdown of a
   20-iteration solve (its loop window from the first to the last launch
   of either kernel); and a 10-iteration solve of 2 clips of T = 1025 and
   of T = 1281 on the card against the same solve through the plain
   versions on the CPU;
6. the float32 round trips: load("config") (the JAX package's default
   card file, matmul_precision: highest) -> embed_watermark_batch of the
   phase 3 clips (8 x 10 s, 400 iterations) -> detect_watermark_batch on
   the "slab" path (bare), "ola" (use_pallas_ola=True), "frames"
   (use_slab_dft=False) and "fft" (use_matmul_dft=False): 0 % BER on
   every lane, the ola_normalize kernels launched once per iteration each
   on "ola", every launch the cluster variant, and no kernel at all on the
   other three; a 10-iteration solve
   per path on the card against the CPU's; a torch.profiler breakdown of a
   20-iteration solve on "ola"; and 2 clips of 1030 frames under the card
   file, which keep the slab path (no tiled kernel) and read back at 0 %;
7. the EOT cards: load("robust"), load("desync") and load("compression")
   (EOT views: each iteration also scores the live waveform after a
   vocoder stretch or pitch shift, or an MDCT or CELP codec model, in
   plain torch) -> embed_watermark_batch of the phase 3 clips (8 x 10 s,
   each card's 400 iterations, its "cycle" of views) ->
   detect_watermark_batch with the card's own key: 0 % BER on every lane;
   synth_norm and analysis_detector (and detector_fused inside it)
   launched once per iteration each, the whole-iteration kernels never;
   the embed s, peak memory and mean SNR per card; the robust card's and
   phase 3's default-card embeds of the same clips read after the port's
   time_stretch at 0.9 and 1.1: the robust card's mean BER must be below
   the default card's and at most 10 %; the desync embeds read under the
   default key (printed, not gated); a 10-iteration robust-card solve of
   2 clips, at 2 s and at T = 1025 (the tiled path with views), on the
   card against the CPU plain solve, within EOT_LOSS_TOL (twice the CPU
   solve's own spread, printed beside it); and a torch.profiler breakdown
   of a 20-iteration robust-card solve;
8. the turbo card and the robustness eval: the attack suite's filters,
   the scan kernels aw_lfilter (the order-6 low-pass) and aw_sosfilt (the
   order-4 high-pass, and twice for the band-stop sosfiltfilt at a fixed
   band), against their plain loops at B = 4 lanes x 8000 samples within
   FILTER_TOL * max|plain|, and at 1 lane x 160 000 samples against a
   float64 recurrence within the JAX suite's bounds; load("turbo") (50
   iterations, matmul_precision "default") -> embed_watermark_batch of the
   phase 3 clips ->
   detect_watermark_batch: 0 % BER on every lane and exactly 50
   iteration_step launches, the embed s and peak memory against phase 3's
   default-card embed, and the largest difference between the bf16 and
   the float32 detection values (printed); then run_robustness_eval on the
   turbo card (4 fixture clips, seed 0, the 22-attack suite, the attacks on
   the card): every key, clean_ber, ber:pcm_16 and ber:pcm_24 at 0, the
   filter kernels launched once (low_pass) and three times (high_pass, the
   band-stop's two passes) a clip; every key, the MP3 rows it took, the
   wall seconds and the attacks' share, beside the JAX package's own record
   of that eval (EVAL_RESULTS_TURBO.json); then each filter kernel against
   its plain loop on the very inputs the eval gave it on its first clip
   (one lane of the watermarked clip's length, the band-stop's passes that
   plus its padding), within FILTER_TOL * max|plain|, each timed beside its
   plain version: the kernels' records.
9. every solver mode of the card schema, and the host runtime: load() with
   each of the six other losses, the eight other optimizers (sparse_adam
   among them) and the six schedules (MODE_SCHEDULES: their params) ->
   embed_watermark_batch of the phase 3 clips (8 x 10 s, 400 iterations)
   -> detect_watermark_batch: a loss or optimizer mode launches rows 9-10
   (iteration_forward and its VJP) 400 times each and row 11 never (ber:
   no VJP, its loss has no gradient graph), a schedule row 11 400 times
   and rows 9-10 never; 0 % BER on every lane but for sgd and adadelta
   (printed: they barely move at lr 0.1, as in the JAX package) and bce
   and ber, whose output must equal the 0-iteration reconstruction to the
   bit (bce's loss is NaN, ber's gradient 0, as in the JAX package), and
   sign, whose solve must reach a best loss of 0 on every lane and whose
   BER is printed (MARGINLESS_MODES says why); per
   mode the embed s and mean SNR, and a 10-iteration solve of 2 clips on
   the card against the CPU plain solve within SHORT_LOSS_TOL; then lbfgs
   through embed_watermark on one 10 s clip (0 % BER, rows 9-10 400 times
   each) and its short solve; then the host runtime (aware_tpu_torch/
   _native, built here with g++, the phase failing if it cannot be):
   load(vad="webrtc_gmm") on the 8 clips and a silent lane under
   on_silent="mask" (the silent lane masked and passed through, 0 % BER on
   the others), and the batch loader over 9 files in batches of 4 with 4
   threads giving the 1-thread batches in 20 runs.
10. the payload and long-form services (service/ecc.py, robust.py,
   streaming.py) and the command line, each part failing the run on a
   missed gate: (a) seeded k = 8 messages through the [20, 8] code into
   the phase 3 clips (embed_watermark_batch, 400 iteration_step launches;
   embed_message on one clip, 400 more), all decoded by detect_message,
   and by detect_message_robust after a (9, 10) and an (11, 10) speed
   change (resample_poly), margins and p-values printed; (b)
   detect_watermark_robust (the full coarse grid and the refine) on phase
   3's default-card embeds: 0 % BER on every lane after the speed changes
   (21, 20), (9, 10) and (11, 10), each won by a resample lane within 0.06
   of down / up, and on the clean clips by the identity lane, plain
   detection's BER beside each; time_stretch at 0.9 and 1.1 and the wall
   s a clip as readings; run_robustness_eval(n_clips=4, robust=True) on
   the turbo card beside phase 8's plain eval (the same keys, clean_ber
   0); (c) tools/streaming_eval.py's stream and plants, draw for draw:
   one hour of the eval's speech fixtures at gains of 0.4-1.0 (summed on
   the card) with 24 planted 4 s marks carrying k = 8 messages (one batch
   embed, 400 iteration_step launches) at arbitrary offsets, localized by
   StreamingDetector (auto threshold, 2 s windows, 1 s hop: 3599
   windows): 24/24 segments, no false segment, 24/24 messages by
   decode_message_windows over each segment's windows, and the hour's
   peak device memory within MEMORY_RATIO of its first 10 minutes'; (d)
   python -m aware_tpu_torch as subprocesses: embed --message, detect
   --message-k (the message back) and detect --robust on a (9, 10) speed
   change of the marked file (0 % BER).
11. the frame geometries and the amortized embedder: (a) 768/192,
   1024/512, 2048/256 (the float32 slab path at r = 4, 2, 8) and 1024/200
   (the frames path) on the phase 3 clips (8 x 10 s x 400): the path, no
   kernel launched, the embed s and peak memory, 0 % BER where the
   detector's n_fft is the frame length and detection's ValueError
   elsewhere (the JAX package's behaviour); (b) 2048/512, T = 313, P = 512
   ("band_analysis"): a 400-iteration solve with 400 launches of each of
   rows 1-4 and no other kernel, every lane's loss lowered, a 10-iteration
   card-vs-CPU solve, and rows 1-4 on its operands against their plain
   versions (phase 2's tolerance) timed in turns beside their bounds; one
   40 s pair (T = 1251, the tiled path) over a 20-iteration solve, rows
   12-13 held and timed the same way; rows 14-15 at r = 2 (1024/512), 4
   (768/192) and 8 (2048/256) on "ola", both variants against the plain
   version (the cluster forward the stream forward's bits), with a
   20-iteration solve's launches; each reading kept in the kernel's record
   under "geometries"; (c) each one-shot variant and a U-Net bundle
   (amortized_embed) on the phase 3 clips (ms a clip, BER and SNR
   readings), one clip against the CPU's to ONESHOT_TOL; (d) the turbo
   embed of each clip at 100 iterations (row 11 x 100 a clip, 0 % BER), 20
   adversarial steps at 8 x 2 s with the desync and compression branches
   and a joint step (finite losses, steps/s), a checkpoint round trip,
   generate_targets of 8 clips at 20 iterations (row 11 x 20) and 5 steps
   of each distill step (finite losses); (e) python -m aware_tpu_torch
   embed --oneshot --variant diverse, then detect, as subprocesses.
12. the multi-device path (aware_tpu_torch/parallel) in an NCCL world of
   one on cuda:0, joined through file:// (NCCL takes one rank a device; the
   ranks' exchange is held by tests/test_torch_parallel.py's gloo world):
   get_mesh(("data",)) and ("seq",); sharded_embed_batch of the phase 3
   clips (8 x 10 s x 400, row 11 x 400 and no other kernel, 0 % BER, its
   audio within 1e-5 of embed_batch's on the same clips);
   sharded_detect_batch against detect_values_batch; detect_global of
   phase 5's first 60 s embed (its bits); streaming_detect_values over
   phase 10's hour against one detect_values of it (atol 1e-4, rtol 1e-3),
   each one's wall s and peak memory; two training steps with the batch
   over data against two unsharded ones, in turns (the history to 1e-4
   relative, the embedder within 5 % of the rate).  Then a card whose detector is
   another architecture (ARCH_CARD: gelu, no norm, a sigmoid readout,
   256-512-512, a fresh init) on the phase 3 clips x 400: the first
   slice's path, rows 1-4 400 launches each and no detector kernel (the
   JAX gate's), its BER a reading, and a 10-iteration card-vs-CPU solve
   (best loss within 0.02).
13. the host codecs, the voice card and the extended eval: which host
   libraries load here (libopus, libgsm, libsoxr, libmp3lame + libmpg123,
   the libavcodec shim's g++ build); where libopus and libgsm load,
   load("voice") (its real-codec views opus_8k and gsm_fr, run on the host
   lane by lane each iteration with a straight-through gradient) ->
   embed_watermark_batch of VOICE_CLIPS of the phase 3 clips (a batch cut
   from 8: the codecs cost about 44 s of host time a lane at 400
   iterations) -> detect_watermark_batch: the analysis_detector path, rows
   1-2 and 5-8 400 launches each and no other kernel, 0 % BER on both
   lanes, the embed s and the view's host seconds (codec, copies, the wait
   for the device before the copy out), and the BER after real opus_8k,
   opus_16k and gsm_fr round trips beside phase 3's default-card embeds of
   the same clips (readings); where either library is absent,
   load("voice") must raise the RuntimeError that names it, and the
   straight-through view then runs on the card with the scipy 8 kHz
   resample leg of gsm_roundtrip (no codec) as its host function, 2 clips
   x 20 iterations on the same path (rows 1-2 and 5-8 20 launches each),
   printed as the plumbing, not the card; then run_robustness_eval with
   extended_attack_suite() on phase 8's turbo model and fixtures: the rows
   run and the rows left out with their causes, every row's BER finite,
   clean, pcm_16 and pcm_24 at 0, the wall s and the attacks' share.

Each phase ends with a line of its wall seconds ("phase N wall ... s").

The last lines are one JSON object with a record per kernel
({"kernels": [...]}), nvidia-smi's name/power line, and
{"ok": true, "device": {...}}.  Without a CUDA card, or without the
package beside it, the script fails and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 rate outside the tensor cores
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


_SIDE = []  # the one warm-up stream of time_ms


def time_ms(torch, fn, reps: int) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``.  Device time replays ``fn``
    captured in a CUDA graph, so the host's launch overhead is out of it;
    call time is back-to-back calls from Python, overhead included.  The
    warm-up runs on one side stream for the whole run: each stream that
    runs a cuBLAS product keeps a workspace allocated, which would count in
    the later phases' peak memory."""
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
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


# the GEMM kernels of the kernel paths: the WMMA template's and the sm90
# slab and dense GEMMs' (shift_mm, the band_analysis pair, the whole step)
GEMM_KERNELS = ("shift_gemm", "slab_gemm_sm90", "dense_gemm_sm90")


def profile_solve(torch, run, trace: str | None = None, markers=GEMM_KERNELS, show=()) -> str:
    """Device time by kind of kernel over one call of ``run``; with
    ``trace``, the Chrome trace is written to that file.  The solver
    loop's window runs from the first launch of a kernel whose name holds
    one of ``markers`` to the end of the last (set-up and reconstruction
    launch none).  Each kernel whose name holds one of ``show`` is listed
    with its launches and device time, whatever its rank."""
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
    ours = (*GEMM_KERNELS, "peak_scale", "synth_bwd_scalars", "fold_phase", "in_norm_fwd",
            "mel_norm_fwd", "brh_fwd", "brh_bwd", "in_norm_bwd_stats", "mel_bwd_stats",
            "reflect_fold", "fold_scalars", "nadam_fold", "best_loss_update", "ola_",
            "reim_pass", "reflect_pad", "mag_pass", "mel_norm", "mel_bwd", "fold_partial",
            "ties_partial", "gcrop_pass", "tiled_reim")
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
    gemms = [(a, b) for a, b, n in spans if any(m in n for m in markers)]
    lo, hi = min(a for a, _ in gemms), max(b for _, b in gemms)
    in_loop = sum(min(b, hi) - max(a, lo) for a, b, _ in spans if b > lo and a < hi)
    shown = [f"{n} x{c} {t:.3f} ms" for t, n, c in top if any(k in n for k in show)]
    top = sorted(top, reverse=True)[:6]
    return (
        f"wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f} %, idle {100 - 100 * busy / wall_ms:.1f} %); "
        f"solver loop {(hi - lo) / 1e3:.1f} ms, device idle in it "
        f"{100 - 100 * in_loop / (hi - lo):.1f} %; "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items())
        + f"; device-to-host copies {dtoh} (set-up and result included)"
        + "; top: " + "; ".join(f"{n} x{c} {t:.2f} ms" for t, n, c in top)
        + ("; " + "; ".join(shown) if shown else "")
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


def _close_flat(name, out_k, out_p) -> float:
    """_close on a kernel's output (a tensor or a tuple of them)."""
    return _close(name, _flat(out_k), _flat(out_p))


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


def _record(name, source, replaces, err, flops, nbytes, library_ms=None,
            peak_flops=PEAK_BF16_FLOPS) -> dict:
    """One kernel's record; bound = max(FLOP / peak, bytes / peak rate)."""
    t_flop = flops / peak_flops * 1e3
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


SM90_EPILOGUES = ("StoreF32", "SlabSynthEpi", "SlabSynthTailEpi", "SlabReflectBwdEpi", "DenseStore",
                  "DenseBias", "DensePhase")


def sm90_instance(name: str):
    """(family, BM, BN, epilogue, source) of an sm90 GEMM kernel's mangled
    name, or None; the source file is read from the name nvcc gives its
    anonymous namespace, "?" where the name does not carry it."""
    m = re.search(r"(slab|dense)_gemm_sm90ILi(\d+)ELi(\d+)E", name)
    if not m:
        return None
    epi = next((e for e in SM90_EPILOGUES if e in name), "?")
    src = re.search(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+", name)
    return m.group(1), 64 * int(m.group(2)), int(m.group(3)), epi, src.group(1) if src else "?"


def sm90_report(torch, b) -> None:
    """Phase 1, the sm90 GEMMs (slab: shift_mm, band_analysis, the tiled
    synthesis and the step's round trip; dense: the step's detector
    products, the iteration_forward VJP's among them): the tile, grid,
    threads, ring stages and dynamic shared memory of each launch the main
    paths make (shift_mm at the long path's three uses and the tiled
    synthesis, B = 8 x 3751 frames; the band_analysis pair and the step's
    14 GEMMs at B = 8 x 626, the VJP's 7 the step's last 7);
    each instance's registers at entry, which must be the count its
    setmaxnreg split assumes (with fewer, its consumers would wait
    forever); and the HGMMA and UTMALDG instructions in the SASS of each
    instance, none of either failing the run.  Without cuobjdump, the
    wgmma and TMA instructions of the sources are counted instead."""
    import ctypes
    import os
    import pathlib
    import shutil

    from aware_tpu_torch.ops.kernels import iteration as it
    from aware_tpu_torch.ops.kernels import roundtrip as rt
    from aware_tpu_torch.ops.kernels import roundtrip_tiled as rtt

    def config(family, bm, bn):
        threads, stages, regs = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        fn = b.lib.aw_slab_gemm_config if family == "slab" else b.lib.aw_dense_gemm_config
        smem = fn(bm, bn, ctypes.byref(threads), ctypes.byref(stages), ctypes.byref(regs))
        return smem, threads.value, stages.value, regs.value

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    uses = [(f"shift_mm, {u}", "slab", rt.plan_slab_gemm(BATCH, n_out, e, sms), n_out, e)
            for u, n_out, e in (("analysis forward (w_af)", 3751, 512),
                                ("analysis VJP (w_ab)", 3753, 256),
                                ("synthesis VJP (w_sb)", 3751, 512))]
    uses += [(f"band_analysis {d}", "slab", rt.plan_slab_gemm(BATCH, n_out, e, sms), n_out, e)
             for d, n_out, e in (("forward", 626, 512), ("VJP", 625, 256))]
    rows = rtt.m1_rows(3750)
    uses.append(("synth_tiled_fwd (w_sf, T = 3751)", "slab", rt.plan_slab_gemm(BATCH, rows, 256, sms),
                 rows, 256))
    uses += [(f"iteration_step {g.name} ({g.kind}, K {g.k})", g.kind, pl, g.rows, g.n)
             for g, pl in zip(it.step_gemms(BATCH, 626, 256, 256),
                              it.plan_step(BATCH, 626, 256, 256, sms))]
    uses += [(f"synth_norm {d} ({g.name}, K {g.k})", "slab",
              rt.plan_gemms([g], BATCH, sms)[0], g.rows, g.n)
             for d, g in (("forward", rt.synth_gemm(626, 256, 256)),
                          ("VJP", rt.synth_vjp_gemm(626, 256, 256)))]
    for call, family, plan, rows, e in uses:
        smem, threads, stages, _ = config(family, plan.bm, plan.bn)
        say(f"  sm90 GEMM {call}: rows {rows}, N {e}: tile {plan.bm} x {plan.bn}, grid "
            f"{plan.grid} = {plan.blocks} blocks on {sms} SMs, {threads} threads, "
            f"{stages} stages, {smem} B dynamic shared memory")
    used, inst = {}, None
    for line in b.log.splitlines():
        if "Compiling entry" in line:
            inst = sm90_instance(line)
        elif inst and "Used" in line:
            used[inst] = int(re.search(r"Used (\d+) registers", line).group(1))
            inst = None
    if not any(k[0] == "dense" for k in used) or not any(k[0] == "slab" for k in used):
        raise RuntimeError(f"ptxas reported no sm90 GEMM of one family: {sorted(used)}")
    for (family, bm, bn, epi, src), regs in sorted(used.items()):
        want = config(family, bm, bn)[3]
        say(f"  {family} GEMM {bm} x {bn} tiles, {epi} ({src}.cu): {regs} registers at entry, "
            f"{want} assumed by its setmaxnreg split")
        if regs != want:
            raise RuntimeError(f"{family} GEMM {bm} x {bn} {epi}: {regs} registers at entry, "
                               f"not the {want} its setmaxnreg split assumes")
    ops = ("HGMMA", "UTMALDG")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        csrc = pathlib.Path(rt.__file__).resolve().parents[2] / "csrc"
        for name in ("slab_gemm_sm90.cuh", "dense_gemm_sm90.cuh"):
            text = (csrc / name).read_text()
            say(f"  no cuobjdump: in csrc/{name}, wgmma.mma_async "
                f"{text.count('wgmma.mma_async')}x, cp.async.bulk.tensor "
                f"{text.count('cp.async.bulk.tensor')}x")
        return
    sass = subprocess.run([tool, "-sass", str(b.path)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = sm90_instance(line.split("Function :")[1].strip())
            if fn:
                counts[fn] = dict.fromkeys(ops, 0)
        elif fn in counts:
            for op in ops:
                counts[fn][op] += op in line
    if {k[0] for k in counts} != {"slab", "dense"}:
        raise RuntimeError(f"the library's SASS lacks an sm90 GEMM family: {sorted(counts)}")
    for (family, bm, bn, epi, src), c in sorted(counts.items()):
        tile = f"{family}_gemm_sm90 {bm} x {bn}, {epi} ({src}.cu)"
        say(f"  SASS of {tile}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
        if not all(c.values()):
            raise RuntimeError(f"{tile}: no {[op for op in ops if not c[op]]}")


def ola_report(torch, b) -> None:
    """Phase 1, rows 14-15's cluster variant: the forward and the VJP at
    each cluster size on the "ola" path's shapes (B = 8, T = 626, hop =
    256): registers, static shared memory and spilled (local) bytes a
    thread, the dynamic shared memory a CTA takes, which must be the
    plan's, and cudaOccupancyMaxActiveClusters at it (fewer than B
    clusters at once would run the clips in waves)."""
    import ctypes

    from aware_tpu_torch.ops.kernels import ola_norm as on

    for vjp, name in ((0, "aw_ola_fwd_cluster"), (1, "aw_ola_bwd_cluster")):
        for size in on.CLUSTER_SIZES:
            vals = [ctypes.c_int() for _ in range(5)]
            err = b.lib.aw_ola_cluster_config(vjp, 626, 256, size, *map(ctypes.byref, vals))
            if err:
                raise RuntimeError(f"{name}, cluster {size}: CUDA error {err}")
            regs, static, local, dyn, clusters = (v.value for v in vals)
            want = on.ola_plan(BATCH, 626, 256, size).smem
            say(f"  {name}, cluster of {size} ({on.CLUSTER_THREADS} threads a CTA): {regs} "
                f"registers, {static} B static + {dyn} B dynamic shared memory, {local} B "
                f"local (spills) a thread; cudaOccupancyMaxActiveClusters {clusters} "
                f"(B = {BATCH} clips){' <- planned' if size == on.CLUSTER else ''}")
            if dyn != want or static > on.CLUSTER_STATIC:
                raise RuntimeError(f"{name}, cluster {size}: {dyn} B dynamic, {static} B static "
                                   f"shared memory, not the plan's {want} and at most "
                                   f"{on.CLUSTER_STATIC}")
            if clusters < 1:
                raise RuntimeError(f"{name}: no cluster of {size} fits the card")


def in_turns(torch, fns: dict) -> dict:
    """Device ms of each call of ``fns`` (name -> call), timed in turns:
    in order, then in reverse; name -> its two readings."""
    names = list(fns)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        out[n].append(time_ms(torch, fns[n], REPS)[0])
    return out


SUM_TOL = 3.0  # the slab GEMM's rms error against float64, over the plain version's


def slab_turns(torch, name, new, wmma, plain, library, ref, exact, quick) -> dict:
    """An sm90 slab-GEMM kernel beside its first WMMA version: the same
    bits on two launches of the new kernel, the WMMA version and the
    library call held to TOL and LIB_TOL of the plain version ``ref``;
    each against the float64 product ``exact()`` of the same bf16
    operands, the new kernel's rms error within SUM_TOL times the plain
    version's (its two-level sums; summed inside the tensor cores over
    the whole depth, as the WMMA kernels do, it is some 20 times the
    plain version's); then (not ``quick``) the four timed in turns.
    Returns the record's ms, wmma_ms, plain_ms and library_ms, each the
    mean of two readings."""
    a, b = new(), new()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise RuntimeError(f"{name}: two launches gave different bits")
    old = wmma()
    _close(f"{name} (WMMA version)", (old,), (ref,))
    ex = exact()
    rms = {k: float((v.double() - ex).pow(2).mean().sqrt() / ex.abs().max())
           for k, v in (("new", a), ("WMMA", old), ("plain", ref))}
    say(f"  {name} against a float64 product, rms error / max|float64|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rms.items()))
    if rms["new"] > SUM_TOL * rms["plain"]:
        raise RuntimeError(f"{name}: rms error {rms['new']:.3e} over {SUM_TOL} x the plain "
                           f"version's {rms['plain']:.3e}")
    _library_ms(torch, name, library, ref, quick=True)
    if quick:
        return {"ms": None, "wmma_ms": None, "plain_ms": None, "library_ms": None}
    turns = in_turns(torch, {"ms": new, "wmma_ms": wmma, "plain_ms": plain,
                             "library_ms": library})
    say(f"  {name} in turns (new, WMMA, plain, library, then reversed), device ms: "
        + "; ".join(f"{k} {v[0]:.5f} {v[1]:.5f}" for k, v in turns.items())
        + "; the same bits on two launches")
    return {k: sum(v) / len(v) for k, v in turns.items()}


def step_work(bsz, t, p, hop, chain) -> list:
    """Each launch of one iteration_step call, in launch order, as (what,
    FLOP, bytes), the bytes each input read once and each output written
    once.  ``chain`` "wmma" is the first chain (aw_iteration_step_wmma:
    the WMMA loaders build the A operands), "sm90" the TMA + wgmma chain
    (aw_iteration_step: the pass before each product writes its A)."""
    lr, t2, p2 = t - 1, t // 2, 2 * p
    state = bsz * t * p * F32                     # one (B, T, P) f32 tensor
    re32, re16 = bsz * t * p2 * F32, bsz * t * p2 * BF16
    rows = bsz * lr * hop * F32                   # one (B, T-1, hop) f32 tensor
    padded = bsz * (t + 3) * hop * F32            # the reflect-padded rows
    env, basis, clip = lr * hop * F32, 4 * hop * p2 * BF16, bsz * F32
    mel32, mel16, mag16 = bsz * t * 128 * F32, bsz * t * 128 * BF16, bsz * t * p * BF16

    def h32(c):
        return bsz * t2 * c * F32

    def h16(c):
        return bsz * t2 * c * BF16

    def stats(c):
        return bsz * c * F32

    sm90 = chain == "sm90"
    slab = 2 * bsz * t * p2 * 4 * hop             # a round-trip product's FLOP
    if sm90:
        out = [("reim = ct csin (f32), m1 = 0", 0, state + re16 + re32 + clip),
               ("synthesis: slab + SynthEpi", slab, re32 + basis + env + 2 * rows + clip),
               ("reflect-padded y2 = u / cden", 0, rows + clip + padded),
               ("reflect analysis: slab", slab, padded + basis + re32),
               ("bf16 |cs|, nph", 0, re32 + re16 + mag16),
               ("mel: dense", 2 * bsz * t * p * 128, mag16 + p * 128 * BF16 + mel32),
               ("mel norm 1: channel sums, bf16 mel", 0, mel32 + mel16),
               ("mel norm 2: channel variances", 0, mel32),
               ("mel norm 3: sum of a", 0, mel32),
               ("mel norm 4: sum of (a - gmu)^2", 0, mel32),
               ("mel norm 5: the pool's bf16 A", 0,
                mel32 + h16(128) + 2 * stats(128) + 3 * clip)]
    else:
        out = [("memset m1", 0, clip),
               ("synthesis: SynthA, SynthEpi", slab, state + re16 + basis + env + 2 * rows + clip),
               ("reflect analysis: ReflectA", slab, rows + clip + basis + re32),
               ("mel: MagA", 2 * bsz * t * p * 128, re32 + re16 + p * 128 * BF16 + mel32),
               ("mel_norm_fwd", 0, mel32 + mel16 + 2 * stats(128) + 3 * clip)]
    ch = (128, 512, 1024, 1024, 128)
    for i in range(4):
        cin, cout = ch[i], ch[i + 1]
        if sm90:
            a, how = h16(cin), "dense"
        elif i == 0:
            a, how = mel32 + 2 * stats(128) + 2 * clip, "PoolA"
        else:
            a, how = h32(cin) + 2 * stats(cin), "NormLeakyA"
        out.append((f"conv {i} ({cin} -> {cout}): {how}", 2 * bsz * t2 * cin * cout,
                    a + cin * cout * BF16 + cout * F32 + h32(cout)))
        nxt = h16(cout) if sm90 and i < 3 else 0
        out.append((f"in_norm_fwd {cout}" + (" + the next bf16 A" if nxt else ""), 0,
                    h32(cout) + h16(cout) + 2 * stats(cout) + nxt
                    + (stats(128) if i == 3 else 0)))
    out.append(("brh_fwd", 2 * bsz * 128 * 128, 2 * stats(128) + 128 * 128 * F32))
    out.append(("brh_bwd (loss, gradient)", 2 * bsz * 128 * 128,
                4 * stats(128) + 128 * 128 * F32 + clip))
    for i in range(3, -1, -1):
        cin, cout = ch[i], ch[i + 1]
        dx = stats(128) if i == 3 else h32(cout)
        out.append((f"in_norm_bwd_stats {cout}" + (" + bf16 dh" if sm90 else ""), 0,
                    dx + h16(cout) + 2 * stats(cout) + (stats(cout) + h16(cout) if sm90 else 0)))
        a = h16(cout) if sm90 else dx + h16(cout) + 3 * stats(cout)
        out.append((f"conv {i} VJP ({cout} -> {cin}): " + ("dense" if sm90 else "NormBwdA"),
                    2 * bsz * t2 * cout * cin, a + cout * cin * BF16 + h32(cin)))
    mel_in = h32(128) + mel16 + 2 * stats(128) + 3 * clip
    if sm90:
        out += [("mel VJP stats 1: clip sums", 0, mel_in),
                ("mel VJP stats 2: channel sums", 0, mel_in),
                ("mel VJP stats 3: the mel VJP's bf16 A", 0, mel_in + mel16)]
    else:
        out.append(("mel_bwd_stats", 0, mel_in + 2 * stats(128) + 2 * clip))
    out.append(("mel VJP: " + ("dense + PhaseEpi" if sm90 else "MelBwdA, PhaseEpi"),
                2 * bsz * t * 128 * p,
                (mel16 if sm90 else mel_in + 2 * stats(128) + 2 * clip)
                + 128 * p * BF16 + re16 + re32))
    out.append(("reflect analysis VJP" + (": slab + ReflectBwdEpi" if sm90 else ""),
                2 * bsz * (t + 3) * hop * 4 * p2, re32 + basis + rows + bsz * 4 * hop * F32))
    if sm90:
        out += [("reflect fold, q and max partials", 0,
                 2 * bsz * 4 * hop * F32 + 2 * rows + clip),
                ("ties partials", 0, rows + clip),
                ("scalars, gcrop = peak-norm VJP / env", 0, 3 * rows + env + 5 * clip),
                ("synthesis VJP: slab", slab, rows + basis + re32)]
    else:
        out += [("fold_scalars", 0, 2 * bsz * 4 * hop * F32 + 2 * rows + 5 * clip),
                ("synthesis VJP: SynthBwdA", slab, 2 * rows + env + 4 * clip + basis + re32)]
    out.append(("nadam_fold", 0, re32 + re16 + 9 * state + 4 * clip + F32))
    out.append(("best_loss_update", 0, 3 * clip))
    return out


def bwd_work(bsz, t, p, hop) -> list:
    """Each launch of one iteration_forward_bwd call (aw_iteration_bwd:
    the sm90 step's backward half from g, then the phase fold), in launch
    order, as step_work gives them."""
    sm90 = step_work(bsz, t, p, hop, "sm90")
    first = next(i for i, w in enumerate(sm90) if w[0].startswith("brh_bwd"))
    state = bsz * t * p * F32
    return ([("brh_bwd (the given g)",) + sm90[first][1:]] + sm90[first + 1 : -2]
            + [("fold_phase", 0, bsz * t * 2 * p * (F32 + BF16) + state)])


def fwd_work(bsz, t, p, hop) -> list:
    """Each launch of one iteration_forward_fwd call (aw_iteration_fwd_sm90:
    the sm90 step's forward half), in launch order, as step_work gives them."""
    sm90 = step_work(bsz, t, p, hop, "sm90")
    return sm90[: next(i for i, w in enumerate(sm90) if w[0].startswith("brh_bwd"))]


def synth_fwd_work(bsz, t, p, hop) -> list:
    """Each launch of one synth_norm_fwd call (aw_synth_norm_fwd: the sm90
    step's synthesis, then the scale of u into y2 in place), as fwd_work
    gives them."""
    rows = bsz * (t - 1) * hop * F32
    return fwd_work(bsz, t, p, hop)[:2] + [("y2 = u / cden in place", 0, 2 * rows + bsz * F32)]


def synth_bwd_work(bsz, t, p, hop) -> list:
    """Each launch of one synth_norm_bwd call (aw_synth_norm_bwd: the sm90
    step's synthesis VJP on y2 itself, with no reflect fold, then the
    phase fold), as bwd_work gives them."""
    rows = bsz * (t - 1) * hop * F32
    work = bwd_work(bsz, t, p, hop)
    i = next(i for i, w in enumerate(work) if w[0].startswith("ties partials"))
    return [("q and max partials", 0, 2 * rows + bsz * F32)] + work[i:]


def det_fwd_work(bsz, t, p, hop) -> list:
    """Each launch of one detector_fused_fwd call (aw_detector_fwd: the
    sm90 step's detector forward from cs), as fwd_work gives them."""
    work = fwd_work(bsz, t, p, hop)
    return work[next(i for i, w in enumerate(work) if w[0].startswith("bf16 |cs|")):]


def ad_fwd_work(bsz, t, p, hop) -> list:
    """Each launch of one analysis_detector_fwd call: aw_reflect_analysis_fwd
    (the reflect pad of y2 itself, no scale read, then the step's reflect
    analysis slab), then det_fwd_work."""
    work = fwd_work(bsz, t, p, hop)
    i = next(i for i, w in enumerate(work) if w[0].startswith("reflect-padded"))
    rows, padded = bsz * (t - 1) * hop * F32, bsz * (t + 3) * hop * F32
    return [("reflect-padded y2", 0, rows + padded), work[i + 1]] + det_fwd_work(bsz, t, p, hop)


def det_bwd_work(bsz, t, p, hop) -> list:
    """Each launch of one detector_fused_bwd call (aw_detector_bwd: the
    sm90 step's detector VJP from g), as bwd_work gives them."""
    work = bwd_work(bsz, t, p, hop)
    return work[: next(i for i, w in enumerate(work) if w[0].startswith("mel VJP:")) + 1]


def ad_bwd_work(bsz, t, p, hop) -> list:
    """Each launch of one analysis_detector_bwd call: det_bwd_work, then
    aw_reflect_analysis_bwd (the step's reflect analysis VJP, then the fold
    of the pad rows: each pad row's sample read, its target read and
    written)."""
    work = bwd_work(bsz, t, p, hop)
    vjp = next(w for w in work if w[0].startswith("reflect analysis VJP"))
    return det_bwd_work(bsz, t, p, hop) + [vjp, ("reflect_fold", 0, 3 * bsz * 4 * hop * F32)]


def launch_table(torch, label, call, work, reps=5) -> list:
    """Each launch of one call of a chain of kernels: device us (the
    torch.profiler rows of ``reps`` calls, in launch order, each
    position's mean) beside its bound from ``work`` (step_work's list).
    A profile missing a row is taken again, three times at most.  Prints
    the table; returns [(what, kernel, us, bound us)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    n = len(work)
    for _ in range(3):  # the profiler now and then drops a row: take the profile again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
                      and ev.time_range.end > ev.time_range.start),
                     key=lambda ev: ev.time_range.start)
        if len(evs) == reps * n:
            break
    else:
        raise RuntimeError(f"{label}: {len(evs)} device rows for {reps} calls of {n} launches")
    rows = []
    for i, (what, flops, nbytes) in enumerate(work):
        us = sum(evs[r * n + i].time_range.end - evs[r * n + i].time_range.start
                 for r in range(reps)) / reps
        name = re.sub(r"\(anonymous namespace\)::|void |\(.*", "", evs[i].name)[:56]
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e6
        rows.append((what, name, us, bound))
    say(f"  {label}: {n} launches, {sum(r[2] for r in rows):.1f} us of device time per call "
        f"(torch.profiler rows, mean of {reps} calls), bound {sum(r[3] for r in rows):.2f} us")
    for i, (what, name, us, bound) in enumerate(rows):
        say(f"    {i:2d} {what:<40s} {us:9.2f} us  bound {bound:7.3f} us  {name}")
    return rows


def step_gemm_checks(torch, it, c, bsz, t, p, hop, rng) -> None:
    """Each of the step's 14 GEMMs alone, on its planned tile through the
    generic entries (aw_slab_gemm, aw_dense_gemm: the step's kernels with a
    plain store), with the step's weights and a random A at the step's
    shapes: the same bits on two launches, and the rms error against a
    float64 product of the same bf16 operands within SUM_TOL times the
    plain float32 product's."""
    import torch.nn.functional as F

    from aware_tpu_torch.ops.kernels import roundtrip as rt

    dev = c.env.device
    plans = it.plan_step(bsz, t, p, hop, torch.cuda.get_device_properties(0).multi_processor_count)
    # the slab GEMMs' weights and geometry: (w, rows of A, k_row, k_col, dir, pad)
    slab = {"synthesis": (c.ab, t, 0, hop, -1, 2),
            "reflect analysis": (c.csw, t + 3, hop, 0, +1, 0),
            "reflect analysis VJP": (c.cswt, t, 0, hop, -1, 0),
            "synthesis VJP": (c.abt, t - 1, hop, 0, +1, 2)}
    dense_w = [c.det.melb, c.det.w0t, c.det.w1t, c.det.w2t, c.det.w3t,
               c.det.w3, c.det.w2, c.det.w1, c.det.w0, c.det.melbt]

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)

    for g, pl in zip(it.step_gemms(bsz, t, p, hop), plans):
        if g.kind == "slab":
            w, n_src, k_row, k_col, dr, pad = slab[g.name]
            a = rand(bsz, n_src, g.k)
            out = torch.empty(bsz, g.rows, g.n, device=dev)
            args = ("aw_slab_gemm", dev, a, w, out, bsz, n_src, g.k, w.shape[0], w.shape[1],
                    g.rows, g.n, k_row, k_col, dr, pad, pl.bm, pl.bn)

            def prod(dtype, a=a, w=w, k_row=k_row, k_col=k_col, dr=dr, pad=pad, g=g):
                ab = F.pad(a.to(torch.bfloat16).to(dtype), (0, 0, 8, g.rows + 8))
                wd = w.to(dtype)
                return sum(ab[:, 8 + dr * (k - pad): 8 + dr * (k - pad) + g.rows]
                           @ wd[k * k_row: k * k_row + g.k, k * k_col: k * k_col + g.n]
                           for k in range(rt.R))
        else:
            w = dense_w.pop(0)
            a = rand(g.rows, g.k).to(torch.bfloat16)
            out = torch.empty(g.rows, g.n, device=dev)
            args = ("aw_dense_gemm", dev, a, w, out, g.rows, g.k, g.n, pl.bm, pl.bn)

            def prod(dtype, a=a, w=w):
                return a.to(dtype) @ w.to(dtype)
        rt._run(*args)
        first = out.clone()
        rt._run(*args)
        torch.cuda.synchronize()
        if not torch.equal(first, out):
            raise RuntimeError(f"step GEMM {g.name}: two launches gave different bits")
        ex = prod(torch.float64)
        rms = {k: float((v.double() - ex).pow(2).mean().sqrt() / ex.abs().max())
               for k, v in (("new", out), ("plain", prod(torch.float32)))}
        say(f"  step GEMM {g.name} ({g.kind}, {g.rows} rows, K {g.k}, N {g.n}, tile "
            f"{pl.bm} x {pl.bn}): rms error / max|float64| new {rms['new']:.3e}, plain "
            f"{rms['plain']:.3e}; the same bits on two launches")
        if rms["new"] > SUM_TOL * rms["plain"]:
            raise RuntimeError(f"step GEMM {g.name}: rms error {rms['new']:.3e} over {SUM_TOL} x "
                               f"the plain product's {rms['plain']:.3e}")


def reference_entry(torch, lib_path, entry, tensors, tiles, *args) -> None:
    """Run ``entry`` of another build of the kernel library (the shared
    library at ``lib_path``, whose entry takes the same pointer table and
    tiles) on ``tensors``, and wait for it."""
    import ctypes

    from aware_tpu_torch.ops.kernels.build import SIGNATURES

    fn = getattr(ctypes.CDLL(lib_path), entry)
    fn.argtypes, fn.restype = SIGNATURES[entry], ctypes.c_int
    table = (ctypes.c_void_p * len(tensors))(*[x.data_ptr() for x in tensors])
    err = fn(table, len(tensors), tiles, len(tiles), *args,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"{lib_path}: {entry}: CUDA error {err}")


def reference_step(torch, it, lib_path, state, step_args, bsz, t, p, hop) -> list:
    """aw_iteration_step of another build from ``state``: its state, loss
    and dreim."""
    state = [x.clone() for x in state]
    bufs = it.step_buffers(bsz, t, 2 * p, hop, state[0].device)
    tiles = it.step_tiles(bsz, t, p, hop, torch.cuda.get_device_properties(0).multi_processor_count)
    reference_entry(torch, lib_path, "aw_iteration_step",
                    [*it._step_tensors(*state, *step_args[:7], bufs), *bufs.ops], tiles,
                    bsz, t, p, hop, *step_args[7])
    return [*state, bufs.loss, bufs.scratch.big]


def reference_bwd(torch, it, lib_path, g, res, c, bsz, t, p, hop):
    """aw_iteration_bwd of another build from g and the residuals: its dct."""
    dev = g.device
    dct = torch.empty(bsz, t, p, device=dev)
    tensors = [*it._bwd_tensors(g, res, c, dct, it._scratch(bsz, t, 2 * p, hop, dev)),
               *it.step_ops(bsz, t, 2 * p, hop, dev)]
    tiles = it.bwd_tiles(bsz, t, p, hop, torch.cuda.get_device_properties(0).multi_processor_count)
    reference_entry(torch, lib_path, "aw_iteration_bwd", tensors, tiles, bsz, t, p, hop)
    return dct


def reference_fwd(torch, it, lib_path, ct, c, bsz, t, p, hop):
    """aw_iteration_fwd_sm90 of another build from ct: its IterResiduals."""
    dev = ct.device
    res = it._residuals(bsz, t, 2 * p, hop, dev)
    tensors = [*it._fwd_tensors(ct, c, res, it._scratch(bsz, t, 2 * p, hop, dev)),
               *it.step_ops(bsz, t, 2 * p, hop, dev)]
    tiles = it.fwd_tiles(bsz, t, p, hop, torch.cuda.get_device_properties(0).multi_processor_count)
    reference_entry(torch, lib_path, "aw_iteration_fwd_sm90", tensors, tiles, bsz, t, p, hop)
    return res


def step_checks(torch, it, states, step_args, bufs, bsz, t, p, hop, rng, quick,
                reference_lib=None) -> dict:
    """Row 11 beyond agreement.check_iteration: the sm90 chain repeats bit
    for bit from the same state (and, given ``reference_lib``, gives the
    bits of that build's aw_iteration_step); each of its GEMMs alone
    (step_gemm_checks); each launch of it and of its first WMMA chain
    (aw_iteration_step_wmma, reached by no path) timed beside its bound
    (launch_table); then (not ``quick``) the two chains and the plain
    version timed in turns (new, WMMA, plain, then reversed).  Returns the
    record's ms, wmma_ms and plain_ms, each the mean of two readings."""
    st_k, st_p = states
    outs = []
    for _ in range(2):
        state = [x.clone() for x in st_k]
        loss = it.iteration_step(*state, *step_args, bufs).clone()
        torch.cuda.synchronize()
        outs.append([*state, loss, bufs.scratch.big.clone()])
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise RuntimeError("iteration_step: two launches from the same state gave different bits")
    say("  iteration_step: two launches from the same state gave the same bits "
        "(ct, m, v, best, best_loss, loss, dreim)")
    if reference_lib:
        ref = reference_step(torch, it, reference_lib, st_k, step_args, bsz, t, p, hop)
        if not all(torch.equal(a, b) for a, b in zip(outs[0], ref)):
            raise RuntimeError(f"iteration_step: not the bits of {reference_lib}'s")
        say(f"  iteration_step: the same bits as {reference_lib}'s aw_iteration_step from the "
            "same state (ct, m, v, best, best_loss, loss, dreim)")
    step_gemm_checks(torch, it, step_args[6], bsz, t, p, hop, rng)
    bufs_w = it.step_buffers(bsz, t, 2 * p, hop, st_k[0].device)
    st_w = [x.clone() for x in st_k]
    fns = {"ms": lambda: it.iteration_step(*st_k, *step_args, bufs),
           "wmma_ms": lambda: it._iteration_step_wmma(*st_w, *step_args, bufs_w),
           "plain_ms": lambda: it.iteration_step_plain(*st_p, *step_args)}
    launch_table(torch, "iteration_step per launch (sm90 chain, aw_iteration_step)", fns["ms"],
                 step_work(bsz, t, p, hop, "sm90"))
    launch_table(torch, "iteration_step per launch (WMMA chain, aw_iteration_step_wmma)",
                 fns["wmma_ms"], step_work(bsz, t, p, hop, "wmma"))
    if quick:
        return {"wmma_ms": None}
    turns = in_turns(torch, fns)
    say("  iteration_step in turns (sm90 chain, WMMA chain, plain, then reversed), device ms: "
        + "; ".join(f"{k} {v[0]:.5f} {v[1]:.5f}" for k, v in turns.items())
        + f"; per call from Python (checks and launches included): sm90 chain "
        f"{time_ms(torch, fns['ms'], REPS)[1]:.5f} ms")
    return {k: sum(v) / len(v) for k, v in turns.items()}


def _flat(out) -> list:
    """The tensors of a kernel's output (a tensor or nested tuples of them)."""
    if isinstance(out, tuple):
        return [x for o in out for x in _flat(o)]
    return [out]


def redesign_checks(torch, name, label, fns, hold, work, quick, new="ms", old="wmma_ms") -> dict:
    """A kernel redesigned on the sm90 templates (rows 1, 2 and 5-10),
    beyond its phase 2 case: the same bits on two launches of the new
    chain (``fns[new]``); the new chain and the other (``fns[old]``: its
    first WMMA version, reached by no path, or, for row 9, the WMMA chain
    the path runs) each held to the plain version by ``hold``; each launch
    of the new chain timed beside its bound (launch_table over ``work``);
    then (not ``quick``) the two chains and the plain version
    (``fns["plain_ms"]``) timed in turns (new, old, plain, then reversed).
    Returns the record's timings under the keys of ``fns``, each the mean
    of two readings."""
    a, b = fns[new](), fns[new]()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b))):
        raise RuntimeError(f"{name}: two launches gave different bits")
    hold(f"{name} (sm90 chain)", a)
    hold(f"{name} (WMMA chain)", fns[old]())
    say(f"  {name}: the same bits on two launches")
    launch_table(torch, f"{name} per launch ({label})", fns[new], work)
    if quick:
        return {k: None for k in fns if k != "ms"}
    turns = in_turns(torch, fns)
    say(f"  {name} in turns (sm90 chain, WMMA chain, plain, then reversed), device ms: "
        + "; ".join(f"{k} {v[0]:.5f} {v[1]:.5f}" for k, v in turns.items())
        + f"; per call from Python (checks, allocations and launches included): sm90 chain "
        f"{time_ms(torch, fns[new], REPS)[1]:.5f} ms")
    return {k: sum(v) / len(v) for k, v in turns.items()}


def bwd_checks(torch, it, g, res, c, out_p, bsz, t, p, hop, quick, reference_lib=None) -> dict:
    """Row 10: the sm90 VJP (aw_iteration_bwd) and its first WMMA chain
    (aw_iteration_bwd_wmma) against the plain VJP from the plain residuals
    (agreement.VJP_TOL), by redesign_checks; given ``reference_lib``, the
    bits of that build's aw_iteration_bwd from the same g and residuals."""
    fns = {"ms": lambda: it.iteration_forward_bwd(g, res, c),
           "wmma_ms": lambda: it._iteration_forward_bwd_wmma(g, res, c),
           "plain_ms": lambda: it.iteration_forward_bwd_plain(g, res, c)}
    if reference_lib:
        if not torch.equal(fns["ms"](), reference_bwd(torch, it, reference_lib, g, res, c, bsz, t,
                                                      p, hop)):
            raise RuntimeError(f"iteration_forward_bwd: not the bits of {reference_lib}'s")
        say(f"  iteration_forward_bwd: the same bits as {reference_lib}'s aw_iteration_bwd "
            "from the same g and residuals (dct)")
    return redesign_checks(torch, "iteration_forward_bwd", "sm90 chain, aw_iteration_bwd", fns,
                           lambda label, out: _close_vjp(label, out, out_p),
                           bwd_work(bsz, t, p, hop), quick)


def fwd_checks(torch, it, ct, c, g, out_p, bsz, t, p, hop, quick, reference_lib=None) -> dict:
    """Row 9: the forward on the sm90 step's forward half
    (aw_iteration_fwd_sm90) and its first WMMA chain (aw_iteration_fwd_wmma,
    reached by no path) against the plain forward on pred and every
    residual (agreement.ITER_FWD_TOL, ITER_SHARE_TOL) and on y2 and m1
    (Y2_TOL), by redesign_checks; and the sm90 VJP on the WMMA forward's
    residuals against the plain chain (ITER_CHAIN_TOL), the other pairing
    than the path's; given ``reference_lib``, the bits of that build's
    aw_iteration_fwd_sm90 from the same ct."""
    from aware_tpu_torch.ops.kernels import agreement as ag

    if reference_lib:
        ours = it.iteration_forward_fwd(ct, c)[1]
        ref = reference_fwd(torch, it, reference_lib, ct, c, bsz, t, p, hop)
        if not all(torch.equal(a, b) for a, b in zip((*ours.det, ours.u, ours.m1),
                                                     (*ref.det, ref.u, ref.m1))):
            raise RuntimeError(f"iteration_forward_fwd: not the bits of {reference_lib}'s")
        say(f"  iteration_forward_fwd: the same bits as {reference_lib}'s aw_iteration_fwd_sm90 "
            "from the same ct (pred, the 16 residuals, u, m1)")

    def hold(label, out):
        rep = ag.check_forward(out[1].det, out_p[1].det, t, ag.ITER_FWD_TOL, ag.ITER_SHARE_TOL)
        sig = {"y2": ag._rel(out[1].y2, out_p[1].y2), "m1": ag._rel(out[1].m1, out_p[1].m1)}
        if not all(v <= ag.Y2_TOL for v in sig.values()):
            raise RuntimeError(f"{label}: y2, m1 past {ag.Y2_TOL}: {ag.fmt(sig)}")
        say(f"  {label} vs plain, max error / max|plain|: {ag.fmt(rep)}, {ag.fmt(sig)}")

    fns = {"ms": lambda: it.iteration_forward_fwd(ct, c),
           "wmma_ms": lambda: it._iteration_forward_fwd_wmma(ct, c),
           "plain_ms": lambda: it.iteration_forward_fwd_plain(ct, c)}
    rec = redesign_checks(torch, "iteration_forward_fwd", "sm90 chain, aw_iteration_fwd_sm90",
                          fns, hold, fwd_work(bsz, t, p, hop), quick)
    rep = ag.check_vjp(it.iteration_forward_bwd(g, fns["wmma_ms"]()[1], c),
                       it.iteration_forward_bwd_plain(g, out_p[1], c), chain=True, t=t,
                       chain_tol=ag.ITER_CHAIN_TOL)
    say(f"  iteration_forward_bwd on the WMMA forward's residuals, chain vs plain: {ag.fmt(rep)}")
    return rec


def synth_fwd_checks(torch, rt, it, ct, c) -> None:
    """Row 1 beyond redesign_checks: its first two launches alone
    (aw_synth_u) give aw_iteration_fwd_sm90's u and m1 bit for bit on the
    same ct (the same stages on the same tile), and its y2 is u /
    peak_den(m1) as torch divides, bit for bit."""
    u, m1 = rt._synth_u(ct, c.csin, c.y_const, c.env, c.ab)
    _, res = it.iteration_forward_fwd(ct, c)
    y2, m1_y2 = rt.synth_norm_fwd(ct, c.csin, c.y_const, c.env, c.ab)
    torch.cuda.synchronize()
    if not (torch.equal(u, res.u) and torch.equal(m1, res.m1)):
        raise RuntimeError("synth_norm_fwd: u and m1 are not aw_iteration_fwd_sm90's bits")
    if not (torch.equal(m1_y2, m1) and torch.equal(y2, u / rt.peak_den(m1))):
        raise RuntimeError("synth_norm_fwd: y2 is not u / peak_den(m1) bit for bit")
    say("  synth_norm_fwd: u and m1 (aw_synth_u, its first two launches) are "
        "aw_iteration_fwd_sm90's bits on the same ct; y2 = u / peak_den(m1) bit for bit")


TIES = 3  # samples of a clip the tie probe sets to its peak


def synth_tie_probe(torch, rt, g, y2, pb) -> None:
    """Row 2 on a tie probe: each clip's y2 with TIES more samples set to
    its peak, of both signs, in three of its fold chunks, and m1 = 3 (cden
    far from 1): the sm90 VJP and its WMMA version to TOL of the plain
    version, which splits the max term K ways among the K maxima."""
    bsz = y2.shape[0]
    flat = y2.clone().reshape(bsz, -1)
    n = flat.shape[1]
    peak = flat.abs().amax(dim=1)
    for b in range(bsz):
        for k, f in enumerate((5 + 13 * b, n // 2 + 7 * b, n - 3 - b)):
            flat[b, f] = peak[b] if k % 2 == 0 else -peak[b]
    y2t = flat.reshape(y2.shape)
    m1t = torch.full((bsz,), 3.0, device=y2.device)
    ties = (y2t.abs() == peak[:, None, None]).sum(dim=(1, 2))
    if not bool((ties >= TIES).all()):
        raise RuntimeError(f"tie probe: {ties.tolist()} maxima a clip, not {TIES}")
    ref = rt.synth_norm_bwd_plain(g, y2t, m1t, pb.csin, pb.env, pb.abt)
    err = _close("synth_norm_bwd (tie probe, sm90)",
                 (rt.synth_norm_bwd(g, y2t, m1t, pb.csin, pb.env, pb.abt),), (ref,))
    err_w = _close("synth_norm_bwd (tie probe, WMMA)",
                   (rt._synth_norm_bwd_wmma(g, y2t, m1t, pb.csin, pb.env, pb.abt),), (ref,))
    say(f"  synth_norm_bwd tie probe ({ties.tolist()} maxima a clip, m1 = 3): max error / "
        f"max|plain| sm90 {err / float(ref.abs().max()):.3e}, WMMA "
        f"{err_w / float(ref.abs().max()):.3e}")


def check_kernels(torch, pb, hop, rng, gemm_rng, quick: bool, reference_lib=None) -> dict:
    """Phase 2: each kernel against its plain version on the main path's
    operands (random cotangents from ``rng``; the step's GEMMs alone on
    operands from ``gemm_rng``, a generator of their own, so that the
    later phases' data do not depend on them); returns one record per
    kernel.  ``reference_lib``: another build of the kernel library whose
    aw_iteration_step must give the same bits (step_checks)."""
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
    rt_src = "aware_tpu_torch/csrc/roundtrip_sm90.cu"  # rows 1-2
    slab_src = "aware_tpu_torch/csrc/slab_gemm_sm90.cu"
    sm90_src = "aware_tpu_torch/csrc/iteration_sm90.cu"
    det_sm90_src = "aware_tpu_torch/csrc/detector_sm90.cu"  # rows 5-8
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
            _close, slab_src, "aware_tpu/ops/pallas/roundtrip.py:254",
            ana_flops, y2_bytes + basis + cs_bytes,
        ),
        "band_analysis_bwd": (
            lambda: rt.band_analysis_bwd(g_cs, pb.cswt),
            lambda: rt.band_analysis_bwd_plain(g_cs, pb.cswt),
            _close, slab_src, "aware_tpu/ops/pallas/roundtrip.py:281",
            2 * bsz * lr * hop * (rt.R * 2 * p), cs_bytes + basis + y2_bytes,
        ),
        "detector_fused_fwd": (
            lambda: td.detector_fused_fwd(cs, ac.det),
            lambda: td.detector_fused_fwd_plain(cs, ac.det),
            _close_det, det_sm90_src, "aware_tpu/ops/pallas/detector.py:310",
            det_flops, det_fwd_bytes,
        ),
        "detector_fused_bwd": (
            lambda: td.detector_fused_bwd(g_det, res_det, ac.det),
            lambda: td.detector_fused_bwd_plain(g_det, res_det, ac.det),
            _close_vjp, det_sm90_src, "aware_tpu/ops/pallas/detector.py:401",
            det_flops, det_bwd_bytes,
        ),
        "analysis_detector_fwd": (
            lambda: tad.analysis_detector_fwd(y2, ac),
            lambda: tad.analysis_detector_fwd_plain(y2, ac),
            _close_det, det_sm90_src, "aware_tpu/ops/pallas/analysis_detector.py:177",
            ana_flops + det_flops, y2_bytes + basis + det_fwd_bytes - cs_bytes,
        ),
        "analysis_detector_bwd": (
            lambda: tad.analysis_detector_bwd(g_det, res_ad, ac),
            lambda: tad.analysis_detector_bwd_plain(g_det, res_ad, ac),
            _close_vjp, det_sm90_src, "aware_tpu/ops/pallas/analysis_detector.py:251",
            ana_bwd_flops + det_flops, det_bwd_bytes - cs_bytes + basis + y2_bytes,
        ),
        "iteration_forward_fwd": (
            lambda: it.iteration_forward_fwd(ct, c),
            lambda: it.iteration_forward_fwd_plain(ct, c),
            None, sm90_src, "aware_tpu/ops/pallas/iteration.py:173",
            it_fwd_flops, it_fwd_bytes,
        ),
        "iteration_forward_bwd": (
            lambda: it.iteration_forward_bwd(g_det, res_it, c),
            lambda: it.iteration_forward_bwd_plain(g_det, res_it, c),
            None, sm90_src, "aware_tpu/ops/pallas/iteration.py:285",
            it_bwd_flops, it_bwd_bytes,
        ),
        "iteration_step": (
            lambda: it.iteration_step(*st_k, *step_args, bufs),
            lambda: it.iteration_step_plain(*st_p, *step_args),
            None, sm90_src, "aware_tpu/ops/pallas/iteration.py:513",
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
    # the analysis's first WMMA versions, which no path reaches, for the turns
    cs2_wmma = torch.empty(bsz, t, 2 * p, device=dev)
    gy2_wmma = torch.empty(bsz, lr, hop, device=dev)

    def fwd_wmma():
        rt._run("aw_band_analysis_fwd_wmma", dev, y2, pb.csw, cs2_wmma, bsz, t, 2 * p, hop)
        return cs2_wmma

    def fwd_exact():
        yd = F.pad(y2, (0, 0, rt.PAD, rt.R - rt.PAD)).to(torch.bfloat16).double()
        cd = pb.csw.double()
        return sum(yd[:, k : k + t] @ cd[k * hop : (k + 1) * hop] for k in range(rt.R))

    def vjp_wmma():
        rt._run("aw_band_analysis_bwd_wmma", dev, g_cs, pb.cswt, gy2_wmma, bsz, t, 2 * p, hop)
        return gy2_wmma

    def vjp_exact():
        gd, cd = g_cs.to(torch.bfloat16).double(), pb.cswt.double()
        return sum(F.pad(gd @ cd[:, k * hop : (k + 1) * hop], (0, 0, k, rt.R - 1 - k))
                   for k in range(rt.R))[:, rt.PAD : rt.PAD + lr]

    wmma = {"band_analysis_fwd": (fwd_wmma, fwd_exact), "band_analysis_bwd": (vjp_wmma, vjp_exact)}
    # the detector kernels redesigned on the sm90 chain's halves, beside
    # their first WMMA versions (reached by no path) and their launches'
    # bounds: (label, WMMA version, launches' work, the plain output's check)
    redesigned = {
        "synth_norm_fwd": ("sm90 chain, aw_synth_norm_fwd",
                           lambda: rt._synth_norm_fwd_wmma(ct, pb.csin, pb.y_const, pb.env, pb.ab),
                           synth_fwd_work(bsz, t, p, hop), _close_flat),
        "synth_norm_bwd": ("sm90 chain, aw_synth_norm_bwd",
                           lambda: rt._synth_norm_bwd_wmma(g_y2, y2, m1, pb.csin, pb.env, pb.abt),
                           synth_bwd_work(bsz, t, p, hop), _close_flat),
        "detector_fused_fwd": ("sm90 chain, aw_detector_fwd",
                               lambda: td._detector_fused_fwd_wmma(cs, ac.det),
                               det_fwd_work(bsz, t, p, hop), _close_det),
        "detector_fused_bwd": ("sm90 chain, aw_detector_bwd",
                               lambda: td._detector_fused_bwd_wmma(g_det, res_det, ac.det),
                               det_bwd_work(bsz, t, p, hop), _close_vjp),
        "analysis_detector_fwd": ("sm90 chains, aw_reflect_analysis_fwd then aw_detector_fwd",
                                  lambda: tad._analysis_detector_fwd_wmma(y2, ac),
                                  ad_fwd_work(bsz, t, p, hop), _close_det),
        "analysis_detector_bwd": ("sm90 chains, aw_detector_bwd then aw_reflect_analysis_bwd",
                                  lambda: tad._analysis_detector_bwd_wmma(g_det, res_ad, ac),
                                  ad_bwd_work(bsz, t, p, hop), _close_vjp),
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
        call = (None, None)
        if name in wmma:
            old, exact = wmma[name]
            rec.update(slab_turns(torch, name, kern, old, plain, library[name], out_p, exact,
                                  quick))
        elif name in library:
            ref = out_p[0] if isinstance(out_p, tuple) else out_p
            rec["library_ms"] = _library_ms(torch, name, library[name], ref, quick)
        if name == "iteration_step":
            rec.update(step_checks(torch, it, (st_k, st_p), step_args, bufs, bsz, t, p, hop,
                                   gemm_rng, quick, reference_lib))
        elif name == "iteration_forward_bwd":
            rec.update(bwd_checks(torch, it, g_det, res_it, c, out_p, bsz, t, p, hop, quick,
                                  reference_lib))
        elif name == "iteration_forward_fwd":
            rec.update(fwd_checks(torch, it, ct, c, g_det, out_p, bsz, t, p, hop, quick,
                                  reference_lib))
        elif name in redesigned:
            label, wmma_call, work, hold = redesigned[name]
            if name == "synth_norm_fwd":
                synth_fwd_checks(torch, rt, it, ct, c)
            elif name == "synth_norm_bwd":
                synth_tie_probe(torch, rt, g_y2, y2, pb)
            rec.update(redesign_checks(
                torch, name, label, {"ms": kern, "wmma_ms": wmma_call, "plain_ms": plain},
                lambda label, out, ref=out_p, hold=hold: hold(label, out, ref), work, quick))
        elif not quick and name not in wmma:
            rec["ms"], call_k = time_ms(torch, kern, REPS)
            rec["plain_ms"], call_p = time_ms(torch, plain, REPS)
            call = (call_k, call_p)
        records[name] = rec
        wmma_ms = f" WMMA version device ms {rec['wmma_ms']}" if "wmma_ms" in rec else ""
        say(
            f"phase 2 kernel {name}: max_abs_err {err:.3e} device ms {rec['ms']}{wmma_ms} "
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
    shift_mm's numbers are the mean over its three uses (each printed),
    timed in turns beside its WMMA version (slab_turns)."""
    import torch.nn.functional as F

    from aware_tpu_torch.ops.kernels import roundtrip as rt
    from aware_tpu_torch.ops.kernels import roundtrip_tiled as rtt

    bsz, t, p = pb.ct0.shape
    lr, hop = pb.env.shape
    dev = pb.ct0.device
    tc = pb.tiled
    ct = pb.ct0.contiguous()
    src = "aware_tpu_torch/csrc/slab_gemm_sm90.cu"
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
        out_wmma = torch.empty(bsz, n_out, e, device=dev)

        def wmma(x=x, w=w, n=n, d=d, e=e, n_out=n_out, out=out_wmma):
            rt._run("aw_shift_mm_wmma", dev, x, w, out, bsz, n, d, e, n_out)
            return out

        out_p = plain()
        err = _close(f"shift_mm {use}", (kern(),), (out_p,))
        # the library's 4-tap conv1d, on a bf16 channels-first copy of x
        # with the zero rows the kernel reads past N
        x_t = F.pad(x, (0, 0, 0, n_out + rtt.HALO - n)).to(torch.bfloat16).transpose(1, 2)
        x_t, w_t = x_t.contiguous(), w.permute(2, 1, 0).contiguous()
        flops = 2 * bsz * n_out * rtt.R * d * e
        nbytes = bsz * n * d * F32 + rtt.R * d * e * BF16 + bsz * n_out * e * F32
        rec = _record("shift_mm", src, "aware_tpu/ops/pallas/roundtrip_tiled.py:103", err,
                      flops, nbytes)
        def exact(x=x, w=w, n=n, n_out=n_out):
            xd = F.pad(x, (0, 0, 0, max(0, n_out + rtt.HALO - n))).to(torch.bfloat16).double()
            return sum(xd[:, o : o + n_out] @ w[o].double() for o in range(rtt.R))

        rec.update(slab_turns(torch, f"shift_mm {use}", kern, wmma, plain,
                              lambda x_t=x_t, w_t=w_t: F.conv1d(x_t, w_t), out_p, exact,
                              quick))
        plan = rt.slab_plan_for(x, n_out, e)
        say(f"phase 2 kernel shift_mm, {use}: max_abs_err {err:.3e} device ms {rec['ms']} "
            f"WMMA version device ms {rec['wmma_ms']} plain device ms {rec['plain_ms']} "
            f"library device ms {rec['library_ms']} bound_us {rec['bound_ms'] * 1e3:.2f} "
            f"({rec['bound_by']}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB); tile "
            f"{plan.bm} x {plan.bn}, grid {plan.grid}")
        recs.append(rec)
    shift = dict(recs[0])
    for key in ("ms", "wmma_ms", "plain_ms", "library_ms", "bound_ms"):
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
    synth_rec = _record("synth_tiled_fwd", "aware_tpu_torch/csrc/roundtrip_tiled.cu",
                        "aware_tpu/ops/pallas/roundtrip_tiled.py:214",
                        err, flops, nbytes)
    synth_rec.update(synth_tiled_checks(torch, rt, rtt, synth, probe, quick))
    say(f"phase 2 kernel synth_tiled_fwd: max_abs_err {err:.3e} device ms {synth_rec['ms']} "
        f"WMMA version device ms {synth_rec['wmma_ms']} plain device ms "
        f"{synth_rec['plain_ms']} (reim pass {synth_rec.get('reim_ms')}, slab GEMM "
        f"{synth_rec.get('gemm_ms')}) bound_us {synth_rec['bound_ms'] * 1e3:.2f} "
        f"({synth_rec['bound_by']}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return {"shift_mm": shift, "synth_tiled_fwd": synth_rec}


def synth_tiled_checks(torch, rt, rtt, synth, probe, quick) -> dict:
    """Row 13 beyond its TOL check against the plain version: the same
    bits on two launches, and from its two launches alone (the reim pass,
    aw_synth_tiled_reim: the f32 products exactly; the slab GEMM,
    aw_synth_tiled_gemm); the GEMM's sums (the same kernel on its planned
    tile with a plain store, aw_slab_gemm) against a float64 product of
    the same bf16 operands, rms error within SUM_TOL of the plain float32
    product's; u and m1 exactly what the tail rule makes of those sums (u
    = acc / env + y_const below lr, m1 = max |u| and |acc| of the rows from
    lr to m1_rows), on the problem's operands and on the tail probe; the
    first WMMA version (aw_synth_tiled_fwd_wmma, reached by no path) to
    TOL; then (not ``quick``) new, WMMA, plain and the two launches alone
    timed in turns.  Returns the record's ms, wmma_ms, plain_ms, reim_ms
    and gemm_ms, each the mean of two readings."""
    import torch.nn.functional as F

    ct, csinp, y_const, env, w_sf = synth
    bsz, t, p = ct.shape
    lr, hop = env.shape
    dev = ct.device
    rows = rtt.m1_rows(lr)
    reim = torch.empty(bsz, t, 2 * p, device=dev)
    u, m1 = torch.empty(bsz, lr, hop, device=dev), torch.empty(bsz, device=dev)
    u_w, m1_w = torch.empty_like(u), torch.empty_like(m1)
    plan = rt.slab_plan_for(reim, rows, hop)

    def parts(x=ct, csinp=csinp, y_const=y_const, env=env):
        rt._run("aw_synth_tiled_reim", dev, x, csinp, reim, m1, bsz, t, p)
        rt._run("aw_synth_tiled_gemm", dev, reim, y_const, env, w_sf, u, m1, bsz, t, p, hop,
                rows, plan.bm, plan.bn)
        return u, m1

    def sums():  # the slab GEMM on reim, with a plain store
        acc = torch.empty(bsz, rows, hop, device=dev)
        rt._run("aw_slab_gemm", dev, reim, w_sf, acc, bsz, t, 2 * p, rtt.R * 2 * p, hop, rows,
                hop, 2 * p, 0, +1, 1, plan.bm, plan.bn)
        return acc

    def product(dtype):  # output row j reads reim rows j - 1 .. j + 2
        xb = F.pad(reim, (0, 0, 1, rows + 2 - t)).to(torch.bfloat16).to(dtype)
        return sum(xb[:, k : k + rows] @ w_sf[k].to(dtype) for k in range(rtt.R))

    a, b = rtt.synth_tiled_fwd(*synth), rtt.synth_tiled_fwd(*synth)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError("synth_tiled_fwd: two launches gave different bits")
    for label, args in (("problem", synth), ("tail probe", probe)):
        full = [x.clone() for x in rtt.synth_tiled_fwd(*args)]
        got = parts(*args[:4])
        x, cs = args[0], args[1]
        if not torch.equal(reim, torch.cat([x * cs[:, 1 : t + 1, :p], x * cs[:, 1 : t + 1, p:]],
                                           dim=-1)):
            raise RuntimeError(f"synth_tiled_fwd {label}: the reim pass is not ct csinp")
        if not all(torch.equal(x, y) for x, y in zip(full, got)):
            raise RuntimeError(f"synth_tiled_fwd {label}: its two launches alone gave other bits")
        acc = sums()
        u_rule = acc[:, :lr] / args[3] + args[2]
        m1_rule = u_rule.abs().amax(dim=(1, 2))
        if rows > lr:  # the tail rows
            m1_rule = torch.maximum(m1_rule, acc[:, lr:].abs().amax(dim=(1, 2)))
        if not (torch.equal(full[0], u_rule) and torch.equal(full[1], m1_rule)):
            raise RuntimeError(f"synth_tiled_fwd {label}: u and m1 are not the tail rule's of "
                               "the GEMM's sums")
        if label == "problem":
            ex = product(torch.float64)
            rms = {k: float((v.double() - ex).pow(2).mean().sqrt() / ex.abs().max())
                   for k, v in (("new", acc), ("plain", product(torch.float32)))}
            say(f"  synth_tiled_fwd slab GEMM ({rows} rows, tile {plan.bm} x {plan.bn}, grid "
                f"{plan.grid}) against a float64 product, rms error / max|float64|: new "
                f"{rms['new']:.3e}, plain {rms['plain']:.3e}")
            if rms["new"] > SUM_TOL * rms["plain"]:
                raise RuntimeError(f"synth_tiled_fwd: rms error {rms['new']:.3e} over {SUM_TOL} x "
                                   f"the plain product's {rms['plain']:.3e}")
    say("  synth_tiled_fwd: the same bits on two launches and from its two launches alone; "
        "the reim pass exactly ct csinp; u and m1 exactly the tail rule's of the GEMM's sums "
        "(problem and tail probe)")

    def wmma():
        rt._run("aw_synth_tiled_fwd_wmma", dev, *synth, u_w, m1_w, bsz, t, p, hop, rows)
        return u_w, m1_w

    _close("synth_tiled_fwd (WMMA version)", wmma(), rtt.synth_tiled_fwd_plain(*synth))
    if quick:
        return {"wmma_ms": None}
    turns = in_turns(torch, {
        "ms": lambda: rtt.synth_tiled_fwd(*synth), "wmma_ms": wmma,
        "plain_ms": lambda: rtt.synth_tiled_fwd_plain(*synth),
        "reim_ms": lambda: rt._run("aw_synth_tiled_reim", dev, ct, csinp, reim, m1, bsz, t, p),
        "gemm_ms": lambda: rt._run("aw_synth_tiled_gemm", dev, reim, y_const, env, w_sf, u, m1,
                                   bsz, t, p, hop, rows, plan.bm, plan.bn)})
    say("  synth_tiled_fwd in turns (new, WMMA, plain, the reim pass, the slab GEMM, then "
        "reversed), device ms: "
        + "; ".join(f"{k} {v[0]:.5f} {v[1]:.5f}" for k, v in turns.items()))
    return {k: sum(v) / len(v) for k, v in turns.items()}


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


def _ola_tie_shares(name, dwf, g, ties, m1, env, spots, t, hop) -> list:
    """The tie probe: each tie of ``spots`` (row, column, value) in lane 0
    of ``ties`` must take K / 2 off g / c with its sign; returns the two
    shares."""
    from aware_tpu_torch.ops.kernels import ola_norm as on

    m = float(m1[0])
    cc = (m + 1e-8) * (m / (m + 1e-8) + 1e-8)
    q = float((g[0].double() * ties[0].double()).sum())
    k_coef = (m / (m + 1e-8) + 1e-8) * q * (1e-8 + cc) / (cc * cc)
    shares = []
    for j, col, v in spots:
        k = 0 if j + on.PAD < t else on.R - 1  # a slice of dwf that holds row j
        g_env = float(dwf[0, j + on.PAD - k, k * hop + col]) * float(env[j, col])
        g_c = float(g[0, j, col]) / cc
        shares.append(g_c - g_env)
        if abs(shares[-1] - np.sign(v) * k_coef / 2) > 1e-3 * (abs(k_coef / 2) + abs(g_c)):
            raise RuntimeError(f"{name} tie probe: the tie at row {j} took {shares[-1]:.6e}, "
                               f"not {np.sign(v) * k_coef / 2:.6e} = K / 2")
    return shares + [k_coef]


def check_ola_kernels(torch, pb, rng, quick: bool) -> dict:
    """Phase 2, rows 14-15: ola_normalize forward and VJP, each variant
    (the cluster variant at each cluster size, the stream variant) and the
    wrappers (the planned variant), against their plain versions to the
    JAX suite's tolerances for this kernel: on the "ola" path's frames at
    its start (B = 8, T = 626), on random frames at B = 3, T = 63 (odd
    rows) with a silent lane, and on random frames at B = 2, T = 3751 (the
    60 s clip, past the cluster's room: the wrappers must take the stream
    variant); the VJP from the plain forward's y2 and m1, and from the
    kernel's own.  The cluster forward must give the stream forward's y2
    and m1 bit for bit, the cluster VJP the same bits on two launches.
    Then the tie probe on each variant: y2 with the peak magnitude at two
    places of opposite sign, in different CTAs of the cluster, where each
    tie must take K / 2 off g / c with its sign.  Then (not ``quick``) the
    variants and the plain version timed in turns at B = 8, T = 626, and
    the wrappers and plain at the long case.  Returns one record each."""
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

    def env_for(frames):
        wkey = tuple(get_window("hann", n_fft).tolist())
        return torch.as_tensor(_ola_envelope(wkey, n_fft, hop, frames), dtype=torch.float32,
                               device=dev).reshape(frames - 1, hop)

    def sized(b, frames):  # the cluster sizes whose CTAs' shared memory holds the clip
        return [c for c in on.CLUSTER_SIZES if on.ola_plan(b, frames, hop, c).variant == "cluster"]

    c = pb.plain
    coeffs = pb.ct0[..., : pb.nb]
    frames = (c.frames_const + torch.cat([coeffs * c.cos, coeffs * c.sin], -1) @ c.ab).contiguous()
    small = rand(3, 63, n_fft)
    small[1] = 0.0  # a silent lane
    inputs = (("B=8, T=626", frames, pb.env), ("B=3, T=63", small, env_for(63)),
              ("B=2, T=3751", rand(2, 3751, n_fft), env_for(3751)))
    err_f = err_b = 0.0
    for label, wf, env in inputs:
        b, frames_n, _ = wf.shape
        plan = on.ola_plan(b, frames_n, hop)
        sizes = sized(b, frames_n)
        if label.startswith("B=2") and (plan.variant, sizes) != ("stream", []):
            raise RuntimeError(f"ola_plan at {label}: {plan.variant}, clusters of {sizes}, not "
                               f"the stream variant at every cluster size")
        y2p, m1p = on.ola_normalize_fwd_plain(wf, env)
        before = {k.__name__: dict(k.variants) for k in on.KERNELS}
        y2, m1 = on.ola_normalize_fwd(wf, env)
        outs = {"wrapper": (y2, m1), "stream": on._ola_fwd_variant(wf, env, "stream")}
        for size in sizes:
            outs[f"cluster {size}"] = on._ola_fwd_variant(wf, env, "cluster", size)
        for name, (yy, mm) in outs.items():
            err_f = max(err_f,
                        _close_ola(f"ola_normalize_fwd {name} {label} y2", yy, y2p, OLA_FWD_TOL),
                        _close_ola(f"ola_normalize_fwd {name} {label} m1", mm, m1p, OLA_FWD_TOL))
            if not (torch.equal(yy, outs["stream"][0]) and torch.equal(mm, outs["stream"][1])):
                raise RuntimeError(f"ola_normalize_fwd {name} {label}: not the stream "
                                   f"variant's bits")
        g = rand(*y2p.shape)
        for res, (yy, mm) in (("plain", (y2p, m1p)), ("own", (y2, m1))):
            ref = on.ola_normalize_bwd_plain(g, yy, env, mm)
            dwf = {"wrapper": on.ola_normalize_bwd(g, yy, env, mm),
                   "stream": on._ola_bwd_variant(g, yy, env, mm, "stream")}
            for size in sizes:
                dwf[f"cluster {size}"] = on._ola_bwd_variant(g, yy, env, mm, "cluster", size)
                again = on._ola_bwd_variant(g, yy, env, mm, "cluster", size)
                if not torch.equal(dwf[f"cluster {size}"], again):
                    raise RuntimeError(f"ola_normalize_bwd cluster {size} {label}: two "
                                       f"launches gave different bits")
            for name, out in dwf.items():
                err_b = max(err_b, _close_ola(
                    f"ola_normalize_bwd {name} {label} from the {res} residuals", out, ref,
                    OLA_VJP_TOL))
        took = {k.__name__: {v: n - before[k.__name__][v] for v, n in k.variants.items()}
                for k in on.KERNELS}
        want = {"ola_normalize_fwd": {plan.variant: 1}, "ola_normalize_bwd": {plan.variant: 2}}
        if {k: {v: n for v, n in d.items() if n} for k, d in took.items()} != want:
            raise RuntimeError(f"ola_normalize at {label}: the wrappers took {took}, not {want}")
        say(f"  ola_normalize {label}: the wrappers took the {plan.variant} variant; clusters "
            f"of {sizes} held (the forward the stream forward's bits, the VJP the same bits "
            f"twice)")
        if label.startswith("B=3") and not (float(m1[1]) == 0.0 and not y2[1].any()):
            raise RuntimeError("ola_normalize_fwd: the silent lane is not silent")
    # the tie probe: lane 0's y2 with +2 and -2 above every other |y2|, at
    # rows 3 and lr - 2, which lie in the first and the last CTA of a cluster
    y2p, m1p = on.ola_normalize_fwd_plain(frames, pb.env)
    g = rand(bsz, lr, hop)
    ties = y2p.clone()
    spots = ((3, 5, 2.0), (lr - 2, 100, -2.0))  # (row, column, value)
    for j, col, v in spots:
        ties[0, j, col] = v
    ref = on.ola_normalize_bwd_plain(g, ties, pb.env, m1p)
    probes = {"wrapper": on.ola_normalize_bwd(g, ties, pb.env, m1p),
              "stream": on._ola_bwd_variant(g, ties, pb.env, m1p, "stream")}
    for size in on.CLUSTER_SIZES:
        rows = on.ola_plan(bsz, t, hop, size).rows
        owners = [next(r for r, (a, z) in enumerate(rows) if a <= j < z) for j, _, _ in spots]
        if owners[0] == owners[1]:
            raise RuntimeError(f"the tie probe's two ties lie in one CTA of a cluster of {size}")
        probes[f"cluster {size}"] = on._ola_bwd_variant(g, ties, pb.env, m1p, "cluster", size)
    for name, dwf in probes.items():
        err_b = max(err_b, _close_ola(f"ola_normalize_bwd {name} tie probe", dwf, ref,
                                      OLA_VJP_TOL))
        shares = _ola_tie_shares(f"ola_normalize_bwd {name}", dwf, g, ties, m1p, pb.env, spots,
                                 t, hop)
        say(f"  ola_normalize tie probe, {name}: the two ties took {shares[0]:.6e} and "
            f"{shares[1]:.6e} of K = {shares[2]:.6e}")
    say("  ola_normalize silent lane: m1 0, y2 0, VJP finite on every variant")

    g = rand(bsz, lr, hop)
    y2p, m1p = on.ola_normalize_fwd_plain(frames, pb.env)
    f32_rows = bsz * lr * hop * F32
    cases = {  # name: (variant call, plain, replaces, bytes in + out, largest error)
        "ola_normalize_fwd": (
            lambda v, size: (lambda: on._ola_fwd_variant(frames, pb.env, v, size)),
            lambda: on.ola_normalize_fwd_plain(frames, pb.env),
            "aware_tpu/ops/pallas/ola_norm.py:135",
            bsz * t * n_fft * F32 + lr * hop * F32 + f32_rows + bsz * F32, err_f),
        "ola_normalize_bwd": (
            lambda v, size: (lambda: on._ola_bwd_variant(g, y2p, pb.env, m1p, v, size)),
            lambda: on.ola_normalize_bwd_plain(g, y2p, pb.env, m1p),
            "aware_tpu/ops/pallas/ola_norm.py:167",
            2 * f32_rows + lr * hop * F32 + bsz * F32 + bsz * t * n_fft * F32, err_b),
    }
    wrappers = {"ola_normalize_fwd": lambda: on.ola_normalize_fwd(frames, pb.env),
                "ola_normalize_bwd": lambda: on.ola_normalize_bwd(g, y2p, pb.env, m1p)}
    records = {}
    for name, (variant, plain, replaces, nbytes, err) in cases.items():
        # a few operations per element: bytes bound both; no single
        # PyTorch call computes either (F.fold does the overlap-add alone)
        rec = _record(name, src, replaces, err, 0, nbytes)
        if not quick:
            fns = {f"cluster{size}_ms": variant("cluster", size) for size in on.CLUSTER_SIZES}
            fns.update(stream_ms=variant("stream", on.CLUSTER), plain_ms=plain)
            turns = in_turns(torch, fns)
            rec.update({k: sum(v) / len(v) for k, v in turns.items()})
            rec["ms"] = rec[f"cluster{on.CLUSTER}_ms"]
            call_ms = time_ms(torch, wrappers[name], REPS)[1]
            say(f"  {name} in turns (" + ", ".join(fns) + ", then reversed), device ms: "
                + "; ".join(f"{k} {v[0]:.5f} {v[1]:.5f}" for k, v in turns.items())
                + f"; the wrapper {call_ms:.4f} ms a call from Python")
        records[name] = rec
        say(f"phase 2 kernel {name}: max_abs_err {err:.3e} device ms {rec['ms']} (cluster of "
            f"{on.CLUSTER}) stream device ms {rec.get('stream_ms')} plain device ms "
            f"{rec['plain_ms']} bound_us {rec['bound_ms'] * 1e3:.2f} ({rec['bound_by']}; "
            f"{nbytes / 1e6:.2f} MB)")
    if not quick:  # the long clip, where the wrappers take the stream variant
        label, wf, env = inputs[2]
        y2l, m1l = on.ola_normalize_fwd_plain(wf, env)
        gl = rand(*y2l.shape)
        turns = in_turns(torch, {
            "forward": lambda: on.ola_normalize_fwd(wf, env),
            "forward plain": lambda: on.ola_normalize_fwd_plain(wf, env),
            "VJP": lambda: on.ola_normalize_bwd(gl, y2l, env, m1l),
            "VJP plain": lambda: on.ola_normalize_bwd_plain(gl, y2l, env, m1l)})
        rows_l = y2l.numel() * F32
        bounds = {"forward": (wf.numel() + env.numel()) * F32 + rows_l,
                  "VJP": 2 * rows_l + env.numel() * F32 + wf.numel() * F32}
        say(f"  ola_normalize at {label} (stream variant) in turns, device ms: "
            + "; ".join(f"{k} {v[0]:.5f} {v[1]:.5f}" for k, v in turns.items())
            + "; bound_us " + ", ".join(f"{k} {n / PEAK_BYTES * 1e6:.2f}"
                                        for k, n in bounds.items()))
    return records


def embed_and_read(torch, kernels, label, emb, det, clips, bits, phase="3") -> dict:
    """The batch embed and detect of ``clips``, with every count set to 0
    just before and read just after, and the line that reports them:
    {"out", "embed_s", "ber" (% per lane), "snr" (dB per lane), "launches"}."""
    from aware_tpu_torch import detect_watermark_batch, embed_watermark_batch

    cfg = emb.cfg
    sr = cfg.detection_net.sample_rate
    for k in kernels:
        k.launches = 0
        if hasattr(k, "variants"):  # ola_normalize's launches by variant
            k.variants = dict.fromkeys(k.variants, 0)
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
    if out.shape != (len(clips), n_out) or not np.isfinite(out).all():
        raise RuntimeError(f"embed output {out.shape} is not finite of (B, (T-1)*hop)")
    ber = np.mean(got != bits, axis=1) * 100.0
    ref = clips[:, :n_out]
    snr = 10 * np.log10(np.mean(out**2, 1) / np.mean((out - ref) ** 2, 1))
    say(
        f"phase {phase} {label}: B={len(clips)} x {clips.shape[1] / sr:g} s x "
        f"{cfg.num_iterations} iterations: "
        f"embed {embed_s:.3f} s, {len(clips) / embed_s:.3f} clips/s, "
        f"BER % per lane {ber.tolist()}, mean SNR {snr.mean():.2f} dB, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
    )
    say(f"phase {phase} {label} launches: {launches}")
    return {"out": out, "embed_s": embed_s, "ber": ber, "snr": snr, "launches": launches}


def check_launches(label, launches, per_iteration, iterations) -> None:
    """Each kernel of ``per_iteration`` (name -> launches per iteration)
    launched that many times per iteration, every other kernel never."""
    for name, n in launches.items():
        want = iterations * per_iteration.get(name, 0)
        if n != want:
            raise RuntimeError(f"{label}: kernel {name} launched {n} times, not {want}")


def solve_path(torch, kernels, label, emb, det, clips, bits, per_iteration, records,
               phase="3") -> None:
    """One solver path: ``embed_and_read``, 0 % BER on every lane, and each
    of the path's kernels (``per_iteration``: name -> launches per
    iteration) launched that many times per iteration, every other kernel
    never.  Returns the watermarked clips and the embed's seconds."""
    run = embed_and_read(torch, kernels, label, emb, det, clips, bits, phase)
    launches = run["launches"]
    if run["ber"].any():
        raise RuntimeError(f"{label}: a lane did not read back its message")
    check_launches(label, launches, per_iteration, emb.cfg.num_iterations)
    for name in per_iteration:
        if records[name]["launches"] == 0:  # the first path that runs it
            records[name]["launches"] = launches[name]
    return run["out"], run["embed_s"]


# the two-kernel path's kernels, one launch each an iteration: the path of
# the cards with EOT views
TWO_KERNEL = ("synth_norm_fwd", "synth_norm_bwd", "analysis_detector_fwd",
              "analysis_detector_bwd", "detector_fused_fwd", "detector_fused_bwd")
EOT_CARDS = ("robust", "desync", "compression")
STRETCH_RATES = (0.9, 1.1)  # the robustness reading of phase 7
STRETCH_MAX_BER = 10.0      # % the robust card may read after them
# 10-iteration best loss, card vs CPU, on the robust card: about twice the
# CPU plain solve's own spread.  Its views make the float32 solve
# ill-conditioned (the JAX reference's own first gradient moves by up to
# 0.18 under a 1e-6 move of its coefficients, tests/test_torch_eot_objective.py):
# moving the clips by 1e-6 of themselves moves the CPU plain robust-card
# solve's best loss on phase 7's 2 s pair by up to 0.031 over 20 moves
# (0.013 at T = 1025 over 8), where phase 3's 0.02 holds paths without
# views; ``PYTHONPATH=. python tests/test_torch_eot_outcome.py`` retakes
# the readings
EOT_LOSS_TOL = 0.06


def stretch_ber(torch, audio, bits, det) -> float:
    """Mean BER % of (B, L) embeds after the port's time_stretch at each of
    STRETCH_RATES, read by ``det``."""
    from aware_tpu_torch import detect_watermark_batch
    from aware_tpu_torch.attacks.vocoder import time_stretch

    sr = det.cfg.detection_net.sample_rate
    x = torch.as_tensor(audio, dtype=torch.float32, device=det.device)
    bers = []
    for rate in STRETCH_RATES:
        with torch.no_grad():
            att = time_stretch(x, rate).cpu().numpy()
        bers.append(np.mean(detect_watermark_batch(att, sr, det) != bits) * 100.0)
    return float(np.mean(bers))


def eot_cards(torch, kernels, clips, bits, default_out, det_default, det_cpu, records,
              trace: str | None) -> None:
    """Phase 7: the EOT cards on the phase 3 clips (module docstring)."""
    from aware_tpu_torch import detect_watermark_batch, load
    from aware_tpu_torch.embed.solver import build_problem, embed_batch

    dev = det_default.device
    sr = det_default.cfg.detection_net.sample_rate
    x = torch.as_tensor(clips, device=dev)
    wm = torch.as_tensor(2.0 * bits - 1.0, dtype=torch.float32, device=dev)
    outs = {}
    for card in EOT_CARDS:
        e, d = load(card, device=dev)
        path = build_problem(d.net, x, wm, e.cfg).path
        if path != "analysis_detector":
            raise RuntimeError(f'load("{card}") took the {path} path, not analysis_detector')
        outs[card] = (solve_path(torch, kernels, f'{card} card (load("{card}"), {path})', e, d,
                                 clips, bits, dict.fromkeys(TWO_KERNEL, 1), records,
                                 phase="7")[0], e, d)
    robust = stretch_ber(torch, outs["robust"][0], bits, outs["robust"][2])
    default = stretch_ber(torch, default_out, bits, det_default)
    say(f"phase 7 time_stretch {STRETCH_RATES}: mean BER % robust card {robust:.3f}, "
        f"default card {default:.3f}")
    if not (robust < default and robust <= STRETCH_MAX_BER):
        raise RuntimeError(f"the robust card reads {robust:.3f} % after the stretch, the default "
                           f"card {default:.3f} %")
    ber = np.mean(detect_watermark_batch(outs["desync"][0], sr, det_default) != bits, axis=1)
    say(f"phase 7 desync embeds read with the default key (a reading): BER % per lane "
        f"{(ber * 100.0).tolist()}")

    # the robust card's short solve on the card and on the CPU (plain
    # versions), at 2 s and at T = 1025 (the tiled path)
    _, e, d = outs["robust"]
    short = e.cfg.replace(num_iterations=10)
    r1025 = np.random.default_rng(1025)
    for label, pair, want in (
        ("2 s", clips[:2, : 2 * sr], "analysis_detector"),
        ("T = 1025", np.stack([speechlike(r1025, 0.0, sr, samples=1024 * e.cfg.hop_length)
                               for _ in range(2)]), "tiled"),
    ):
        xp = torch.as_tensor(pair)
        wm2 = torch.as_tensor(2.0 * bits[:2] - 1.0, dtype=torch.float32)
        path = build_problem(d.net, xp.to(dev), wm2.to(dev), short).path
        if path != want:
            raise RuntimeError(f"robust card, {label}: the {path} path, not {want}")
        res_k = embed_batch(d.net, xp.to(dev), wm2.to(dev), short)
        res_p = embed_batch(det_cpu.net, xp, wm2, short)
        dloss = float((res_k.best_loss.cpu() - res_p.best_loss).abs().max())
        own = []
        for seed in (100, 101):
            noise = np.random.default_rng(seed).standard_normal(pair.shape).astype(np.float32)
            moved = embed_batch(det_cpu.net, torch.as_tensor(pair * (1 + 1e-6 * noise)), wm2, short)
            own.append(float((moved.best_loss - res_p.best_loss).abs().max()))
        say(f"phase 7 reference, robust card, {label} ({path}): 10-iteration best_loss card vs "
            f"CPU plain |diff| {dloss:.3e} (bound {EOT_LOSS_TOL}); the CPU plain solve's own "
            f"under two 1e-6 moves of the clips (not gated): {own[0]:.3e}, {own[1]:.3e}")
        if not dloss < EOT_LOSS_TOL:
            raise RuntimeError(f"robust card, {label}: the card's solve departs from the plain solve")
    prof_cfg = e.cfg.replace(num_iterations=20)
    say(f"phase 7 profile, robust card, B={BATCH} x 20 iterations: " + profile_solve(
        torch, lambda: embed_batch(d.net, x, wm, prof_cfg), trace))


# ---- phase 8: the turbo card and the robustness eval
FILTER_TOL = 1e-4              # filter kernels vs plain, relative to max|plain|
FILTER_REF_TOL = (1e-3, 1e-2)  # at 160 000 samples vs float64: atol, rtol
#                                (the JAX suite's, tests/test_attacks.py:151-156)
BANDSTOP_LOW = 1000.0          # Hz, the band-stop check's fixed band [1000, 1200)
EVAL_CLIPS = 4
IIR_SOURCE = "aware_tpu_torch/csrc/iir.cu"


def _df2t64(b, a, x) -> np.ndarray:
    """lfilter in float64 Python floats: the reference recurrence."""
    n = len(b)
    z = [0.0] * (n - 1)
    y = np.empty(len(x))
    for t, xn in enumerate(x.tolist()):
        yn = b[0] * xn + z[0]
        for i in range(n - 1):
            z[i] = b[i + 1] * xn - a[i + 1] * yn + (z[i + 1] if i + 2 < n else 0.0)
        y[t] = yn
    return y


def _sos64(sos, x, zi=None) -> np.ndarray:
    """sosfilt in float64 Python floats."""
    c = [list(map(float, np.concatenate([r[:3], r[3:] / r[3]]))) for r in np.asarray(sos)]
    z = [list(map(float, r)) for r in zi] if zi is not None else [[0.0, 0.0] for _ in c]
    y = np.empty(len(x))
    for t, v in enumerate(x.tolist()):
        for s, (b0, b1, b2, _, a1, a2) in enumerate(c):
            out = b0 * v + z[s][0]
            z[s][0], z[s][1] = b1 * v - a1 * out + z[s][1], b2 * v - a2 * out
            v = out
        y[t] = v
    return y


def _sosfiltfilt_with(torch, scan, sos, x):
    """ops.iir.sosfiltfilt on (B, L), each pass through ``scan`` (the
    kernel's wrapper or its plain version), or with ``scan`` None in float64
    on the host from ``x`` (L,) as numpy."""
    from aware_tpu_torch.ops import iir

    padlen = 3 * (2 * len(sos) + 1)
    zi = iir.sosfilt_zi(sos)
    if scan is None:
        ext = np.concatenate([2 * x[:1] - x[1 : padlen + 1][::-1], x,
                              2 * x[-1:] - x[-padlen - 1 : -1][::-1]])
        y = _sos64(sos, ext, zi * ext[0])[::-1]
        return _sos64(sos, y, zi * y[0])[::-1][padlen:-padlen]
    ext = iir._odd_ext(x, padlen)
    zt = iir.device_array(zi, x.device)
    y = scan(ext, sos, (zt * ext[:, :1, None]).contiguous()).flip(-1)
    return scan(y, sos, (zt * y[:, :1, None]).contiguous()).flip(-1)[:, padlen:-padlen]


def _events_ms(torch, fn):
    """(the result, device ms) of one call of ``fn`` by CUDA events: the
    plain loops, hundreds of thousands of launches, too many to capture in
    a graph, and seconds long, so that a warm-up call would add little to
    the reading and much to the run."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def filter_checks(torch, rng, quick: bool) -> dict:
    """The attack suite's three filters on the card: the scan kernels
    against their plain versions at B = 4 lanes x 8000 samples (within
    FILTER_TOL * max|plain|), and at 1 lane x 160 000 samples (a 10 s clip)
    against a float64 recurrence (FILTER_REF_TOL).  Returns the two
    kernels' records at B = 4 x 8000: ``eval_filter_checks`` replaces them
    by the eval's own inputs where the eval runs."""
    from aware_tpu_torch.ops import iir
    from aware_tpu_torch.ops.kernels import iir as ki

    sr = 16000
    b, a = iir.butter(6, 4000.0 / (0.5 * sr), "low")          # low_pass
    bn, an = iir._ba(b, a)
    sos_hp = iir.butter_sos(4, 500.0 / (0.5 * sr), "high")     # high_pass
    sos_bs = iir.butter_sos(4, (BANDSTOP_LOW / (0.5 * sr), (BANDSTOP_LOW + 200.0) / (0.5 * sr)),
                            "bandstop")                          # bandstop_200Hz
    dev = torch.device("cuda")
    x = torch.as_tensor(rng.standard_normal((4, 8000)), dtype=torch.float32, device=dev)
    cases = {
        "low_pass (aw_lfilter)": (lambda: ki.lfilter_scan(x, bn, an),
                                  lambda: ki.lfilter_plain(x, bn, an),
                                  lambda: iir.lfilter(b, a, x)),
        "high_pass (aw_sosfilt)": (lambda: ki.sosfilt_scan(x, sos_hp),
                                   lambda: ki.sosfilt_plain(x, sos_hp),
                                   lambda: iir.sosfilt(sos_hp, x)),
        "bandstop_200Hz (aw_sosfilt, twice)": (
            lambda: _sosfiltfilt_with(torch, ki.sosfilt_scan, sos_bs, x),
            lambda: _sosfiltfilt_with(torch, ki.sosfilt_plain, sos_bs, x),
            lambda: iir.sosfiltfilt(sos_bs, x)),
    }
    times = {}
    for label, (kernel, plain, library) in cases.items():
        out_k = kernel()
        out_p, plain_ms = (plain(), None) if quick else _events_ms(torch, plain)
        if not torch.equal(out_k, library()):
            raise RuntimeError(f"{label}: ops.iir does not give the wrapper's bits")
        err = float((out_k - out_p).abs().max())
        ref = float(out_p.abs().max())
        say(f"phase 8 filter {label}, B=4 x 8000: max_abs_err vs plain {err:.3e} "
            f"(bound {FILTER_TOL} * max|plain| = {FILTER_TOL * ref:.3e})")
        if not (out_k.isfinite().all() and err <= FILTER_TOL * ref):
            raise RuntimeError(f"{label}: the kernel departs from its plain version")
        ms = None if quick else time_ms(torch, kernel, REPS)[0]
        times[label] = (err, ms, plain_ms)
        say(f"phase 8 filter {label}, B=4 x 8000: device ms kernel {ms} plain {plain_ms}")

    # one 10 s clip against float64 recurrences on the host
    x1 = rng.standard_normal(160000).astype(np.float32)
    xt = torch.as_tensor(x1, device=dev)[None]
    for label, kernel, ref in (
        ("low_pass (aw_lfilter)", lambda: iir.lfilter(b, a, xt), lambda: _df2t64(bn, an, x1)),
        ("high_pass (aw_sosfilt)", lambda: iir.sosfilt(sos_hp, xt), lambda: _sos64(sos_hp, x1)),
        ("bandstop_200Hz (aw_sosfilt, twice)", lambda: iir.sosfiltfilt(sos_bs, xt),
         lambda: _sosfiltfilt_with(torch, None, sos_bs, x1.astype(np.float64))),
    ):
        y = kernel()[0].cpu().numpy().astype(np.float64)
        y64 = ref()
        err = float(np.abs(y - y64).max())
        atol, rtol = FILTER_REF_TOL
        over = float(np.max(np.abs(y - y64) - rtol * np.abs(y64)))
        ms = None if quick else time_ms(torch, kernel, 5)[0]
        say(f"phase 8 filter {label}, 1 x 160000: max_abs_err vs float64 {err:.3e}, "
            f"max(|err| - {rtol} |ref|) {over:.3e} (atol {atol}); device ms {ms}")
        if not (np.isfinite(y).all() and over <= atol):
            raise RuntimeError(f"{label}, 160000 samples: departs from the float64 recurrence")

    lp = times["low_pass (aw_lfilter)"]
    hp = times["high_pass (aw_sosfilt)"]
    n = x.numel()
    records = {
        "aw_lfilter": _record("aw_lfilter", IIR_SOURCE,
                              "aware_tpu/ops/iir.py:247 (lax.scan, not a TPU kernel)", lp[0],
                              n * (2 + 4 * (len(bn) - 1)), 2 * n * F32, peak_flops=PEAK_F32_FLOPS),
        "aw_sosfilt": _record("aw_sosfilt", IIR_SOURCE,
                              "aware_tpu/ops/iir.py:304 (lax.scan, not a TPU kernel)", hp[0],
                              n * 9 * len(sos_hp), 2 * n * F32, peak_flops=PEAK_F32_FLOPS),
    }
    for name, (_, ms, plain_ms) in (("aw_lfilter", lp), ("aw_sosfilt", hp)):
        records[name].update(ms=ms, plain_ms=plain_ms)
    return records


class _Timed:
    """An attack whose ``apply`` adds its wall seconds to ``spent``."""

    def __init__(self, attack, spent: list):
        self.attack, self.name, self.spent = attack, attack.name, spent

    def apply(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.attack.apply(*args, **kwargs)
        self.spent[0] += time.perf_counter() - t0
        return out


def turbo_and_eval(torch, kernels, clips, bits, default_s, records) -> tuple:
    """Phase 8 after the filter checks: the turbo card on the phase 3 clips,
    then run_robustness_eval on it with the 22-attack suite (module
    docstring).  Returns the turbo handles, the eval's results and its
    wall seconds, for phase 10's robust eval."""
    import pathlib

    from aware_tpu_torch import load
    from aware_tpu_torch.attacks import default_attack_suite
    from aware_tpu_torch.embed.solver import build_problem
    from aware_tpu_torch.eval import run_robustness_eval
    from aware_tpu_torch.models.detector import detect_values_batch
    from aware_tpu_torch.ops.kernels import iir as ki

    dev = torch.device("cuda")
    emb, det = load("turbo", device=dev)
    x = torch.as_tensor(clips, device=dev)
    wm = torch.as_tensor(2.0 * bits - 1.0, dtype=torch.float32, device=dev)
    path = build_problem(det.net, x, wm, emb.cfg).path
    if path != "iteration_step" or emb.cfg.num_iterations != 50:
        raise RuntimeError(f'load("turbo") took the {path} path at {emb.cfg.num_iterations}')
    out, embed_s = solve_path(torch, kernels, f'turbo card (load("turbo"), {path})', emb, det,
                              clips, bits, {"iteration_step": 1}, records, phase="8")
    say(f"phase 8 turbo embed {embed_s:.3f} s; over phase 3's 400-iteration default-card embed "
        f"of the same clips: {embed_s / default_s:.4f}")
    y = torch.as_tensor(out, device=dev)
    v16 = detect_values_batch(det.net, y, precision="default")
    v32 = detect_values_batch(det.net, y, precision="highest")
    say(f"phase 8 turbo detection values, bf16 (the card's) vs float32 products: max |diff| "
        f"{float((v16 - v32).abs().max()):.3e} (a reading); sign flips "
        f"{int(((v16 > 0) != (v32 > 0)).sum())} of {v16.numel()}")

    suite = default_attack_suite()
    mp3_rows = [a.name for a in suite if a.name.startswith("mp3")]
    say(f"phase 8 eval suite: {len(suite)} attacks, MP3 rows {mp3_rows} "
        f"({'the real codec' if mp3_rows[0].startswith('mp3_') else 'the MDCT approximation'})")
    spent = [0.0]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _FilterInputs() as inputs:
        results = run_robustness_eval(n_clips=EVAL_CLIPS, seed=0, model=(emb, det),
                                      attacks=[_Timed(a, spent) for a in suite])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in kernels if k.launches}
    say(f"phase 8 eval, turbo card, {EVAL_CLIPS} clips x {len(suite)} attacks: wall {wall:.3f} s, "
        f"attacks {spent[0]:.3f} s ({100 * spent[0] / wall:.1f} %); launches {launched}")
    say("phase 8 eval results (this run): " + json.dumps(results))
    record = pathlib.Path(__file__).resolve().parent / "EVAL_RESULTS_TURBO.json"
    say("phase 8 EVAL_RESULTS_TURBO.json, the JAX package's record of its own turbo-card eval "
        "(BERs; no time): " + (json.dumps(json.loads(record.read_text())) if record.exists()
                                else "absent"))
    keys = {"clean_ber", "pesq", "pesq_proxy", "stoi", "snr"} | {f"ber:{a.name}" for a in suite}
    missing = keys - set(results)
    if missing or not all(np.isfinite(results[k]) for k in keys - {"snr"}):
        raise RuntimeError(f"eval: keys missing {sorted(missing)} or not finite")
    if results["clean_ber"] != 0.0 or results["ber:pcm_16"] != 0.0 or results["ber:pcm_24"] != 0.0:
        raise RuntimeError("eval: the clean, pcm_16 or pcm_24 BER is not 0")
    want = {"lfilter_scan": EVAL_CLIPS, "sosfilt_scan": 3 * EVAL_CLIPS,
            "iteration_step": EVAL_CLIPS * emb.cfg.num_iterations}
    got = {name: launched.get(name, 0) for name in want}
    if got != want:
        raise RuntimeError(f"eval: launches {got}, not {want}")
    records["aw_lfilter"]["launches"] = ki.lfilter_scan.launches
    records["aw_sosfilt"]["launches"] = ki.sosfilt_scan.launches
    eval_filter_checks(torch, inputs, records)
    return (emb, det), results, wall


class _FilterInputs:
    """While open, ``ops.iir``'s calls of the two scan wrappers go through
    unchanged, and the arguments of the first clip's calls (one lfilter and
    three sosfilt calls a clip) are kept, cloned, in ``calls``: the inputs
    that the main path gives the kernels."""

    PER_CLIP = {"lfilter_scan": 1, "sosfilt_scan": 3}

    def __init__(self):
        self.calls = {name: [] for name in self.PER_CLIP}

    def __enter__(self):
        from aware_tpu_torch.ops import iir

        self.saved = {name: getattr(iir, name) for name in self.PER_CLIP}
        for name, wrapper in self.saved.items():
            setattr(iir, name, self._keeping(name, wrapper))
        return self.calls

    def _keeping(self, name, wrapper):
        def call(*args):
            if len(self.calls[name]) < self.PER_CLIP[name]:
                self.calls[name].append(tuple(
                    a.clone() if hasattr(a, "clone") else a for a in args))
            return wrapper(*args)
        return call

    def __exit__(self, *exc):
        from aware_tpu_torch.ops import iir

        for name, wrapper in self.saved.items():
            setattr(iir, name, wrapper)
        return False


def eval_filter_checks(torch, inputs, records) -> None:
    """Each filter kernel against its plain loop on the inputs that the
    eval gave it on its first clip (``_FilterInputs``), within FILTER_TOL *
    max|plain|, each timed beside its plain version.  The kernel's record
    takes the largest error over its calls and the first call's times and
    bound (lfilter: the low-pass; sosfilt: its first call a clip)."""
    from aware_tpu_torch.ops.kernels import iir as ki

    plains = {"lfilter_scan": ki.lfilter_plain, "sosfilt_scan": ki.sosfilt_plain}
    wrappers = {"lfilter_scan": ki.lfilter_scan, "sosfilt_scan": ki.sosfilt_scan}
    names = {"lfilter_scan": "aw_lfilter", "sosfilt_scan": "aw_sosfilt"}
    for key, calls in inputs.items():
        if len(calls) != _FilterInputs.PER_CLIP[key]:
            raise RuntimeError(f"eval: {len(calls)} {key} calls on its first clip")
        rec, worst = records[names[key]], 0.0
        for i, args in enumerate(calls):
            x, zi = args[0], args[-1]
            kernel = functools.partial(wrappers[key], *args)
            out_k = kernel()
            out_p, plain_ms = _events_ms(torch, functools.partial(plains[key], *args))
            err = float((out_k - out_p).abs().max())
            ref = float(out_p.abs().max())
            ms = time_ms(torch, kernel, REPS)[0]
            say(f"phase 8 filter {names[key]} on the eval's call {i} of its first clip, "
                f"{tuple(x.shape)}{' with zi' if zi is not None else ''}: max_abs_err vs plain "
                f"{err:.3e} (bound {FILTER_TOL} * max|plain| = {FILTER_TOL * ref:.3e}); device "
                f"ms kernel {ms} plain {plain_ms}")
            if not (out_k.isfinite().all() and err <= FILTER_TOL * ref):
                raise RuntimeError(f"{names[key]}: departs from its plain version on the eval's "
                                   f"input {tuple(x.shape)}")
            worst = max(worst, err)
            if i == 0:
                n, taps = x.numel(), args[1]
                if key == "lfilter_scan":
                    flops = n * (2 + 4 * (len(taps) - 1))
                else:
                    flops = n * 9 * len(taps)
                fresh = _record(names[key], IIR_SOURCE, rec["replaces"], 0.0, flops,
                                2 * n * F32, peak_flops=PEAK_F32_FLOPS)
                rec.update(bound_ms=fresh["bound_ms"], bound_by=fresh["bound_by"], ms=ms,
                           plain_ms=plain_ms)
        rec["max_abs_err"] = worst


SHORT_LOSS_TOL = 0.1  # 10-iteration best loss, card vs CPU, below 32 frames
SIGN_FRAMES = (8, 9)   # the lengths held by the sign test
SIGN_SEEDS = 16        # its clip pairs a length: seeds 0-15
MOVED_PATHS = 1        # the paths whose sign test also reads the moved CPU solve


def short_clips(torch, paths, det_cpu, rng) -> None:
    """Phase 3s: clips of 8, 9, 16 and 31 frames through the solver on each
    path, held at the outcome level against the CPU plain solve: on 2
    clips a length, the 10-iteration best loss within SHORT_LOSS_TOL, and
    at 16 and 31 frames after 400 iterations no lane with a higher BER than
    the CPU's on the same lane; at 8 and 9 frames, the sign test of
    ``short_sign_test`` instead of that per-lane rule.

    SHORT_LOSS_TOL is twice the plain solve's own spread: moving the clips
    by 1e-6 of themselves moves the CPU plain solve's 10-iteration best
    loss by up to 0.053 at these lengths (six seeds; ``PYTHONPATH=. python
    tests/test_torch_slice_iteration.py`` retakes the readings), where the
    norms run over 4 to 15 pooled frames; 0.02, the bound at 626 frames,
    is below that spread."""
    from aware_tpu_torch.embed.solver import build_problem, embed_batch
    from aware_tpu_torch.ops.kernels.agreement import lane_ber

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
            for iters in (10,) if frames in SIGN_FRAMES else (10, e.cfg.num_iterations):
                cfg = e.cfg.replace(num_iterations=iters)
                res_k = embed_batch(d.net, x.to(e.device), wm.to(e.device), cfg)
                res_p = embed_batch(det_cpu.net, x, wm, cfg)
                out[iters] = (res_k, res_p)
            dloss = float((out[10][0].best_loss.cpu() - out[10][1].best_loss).abs().max())
            line = (f"phase 3s {frames} frames, {label} ({pb.path}): 10-iteration best_loss "
                    f"card vs CPU plain |diff| {dloss:.3e}")
            if frames not in SIGN_FRAMES:
                res_k, res_p = out[e.cfg.num_iterations]
                ber_k = lane_ber(d.net, res_k.audio, bits)
                ber_p = lane_ber(det_cpu.net, res_p.audio, bits)
                line += (f"; {e.cfg.num_iterations}-iteration BER % per lane card "
                         f"{ber_k.tolist()} CPU {ber_p.tolist()}")
            say(line)
            if not dloss < SHORT_LOSS_TOL:
                raise RuntimeError(f"{frames} frames, {label}: the card departs from the CPU")
            if frames not in SIGN_FRAMES and np.any(ber_k > ber_p):
                raise RuntimeError(f"{frames} frames, {label}: a lane reads worse on the card")
    short_sign_test(torch, paths, det_cpu)


def short_sign_test(torch, paths, det_cpu) -> None:
    """Phase 3s at 8 and 9 frames: on each path, the 400-iteration solve on
    the card and the CPU plain solve of the same clips, lane by lane, over
    SIGN_SEEDS clip pairs a length (64 lanes a path),
    drawn by agreement.short_lanes from generators of their own (no other
    phase moves them).  The card is refused when the one-sided sign test
    (agreement.short_outcome) finds W lanes reading worse on the card and
    L better (ties dropped) with P(Binomial(W + L, 1/2) >= W) under
    agreement.SHORT_ALPHA.  At these lengths a single solve's BER on a lane
    is a draw, for the reference too: the CPU plain solve from the clips
    moved by 1e-6 of themselves, printed beside it and not gated, reads
    worse than itself on as many lanes.  That reading is taken on the
    first path alone (MOVED_PATHS): the CPU solves are most of the phase's
    time, and the reference's own spread does not depend on the path."""
    from aware_tpu_torch.embed.solver import embed_batch
    from aware_tpu_torch.ops.kernels import agreement as ag

    lanes = {t: [ag.short_lanes(seed, t) for seed in range(SIGN_SEEDS)] for t in SIGN_FRAMES}
    for i, (label, e, d, _) in enumerate(paths):
        moved_too = i < MOVED_PATHS
        ber = {"card": [], "cpu": [], "cpu moved": []}
        for t in SIGN_FRAMES:
            clips, bits, moved = (np.concatenate(v) for v in zip(*lanes[t]))
            wm = torch.as_tensor(2.0 * bits - 1.0, dtype=torch.float32)
            res = embed_batch(d.net, torch.as_tensor(clips, dtype=torch.float32, device=e.device),
                              wm.to(e.device), e.cfg)
            ber["card"].append(ag.lane_ber(d.net, res.audio, bits))
            for key, x in (("cpu", clips), ("cpu moved", moved))[: 1 + moved_too]:
                res = embed_batch(det_cpu.net, torch.as_tensor(x, dtype=torch.float32), wm, e.cfg)
                ber[key].append(ag.lane_ber(det_cpu.net, res.audio, bits))
        ber = {k: np.concatenate(v) for k, v in ber.items() if v}
        worse, better, p_val, ok = ag.short_outcome(ber["card"], ber["cpu"])
        line = (f"phase 3s sign test, {label}, {len(ber['card'])} lanes at {SIGN_FRAMES} frames "
                f"x {e.cfg.num_iterations} iterations: card vs CPU plain W {worse} L {better} p "
                f"{p_val:.3e}; mean BER % card {ber['card'].mean():.3f} CPU "
                f"{ber['cpu'].mean():.3f}")
        if moved_too:
            m_worse, m_better, m_p, _ = ag.short_outcome(ber["cpu moved"], ber["cpu"])
            line += (f" CPU moved {ber['cpu moved'].mean():.3f}; CPU moved vs CPU (not gated) "
                     f"W {m_worse} L {m_better} p {m_p:.3e}")
        say(line)
        if not ok:
            raise RuntimeError(f"{label}: at {SIGN_FRAMES} frames the card reads worse than the "
                               f"CPU on {worse} lanes, better on {better}: p {p_val:.3e} < "
                               f"{ag.SHORT_ALPHA}")


# ---- phase 9: every solver mode of the card schema, and the host runtime
MODE_LOSSES = ("hinge", "mse", "push_sigmoid", "sign", "bce", "ber")
MODE_OPTIMIZERS = ("adam", "adamw", "sgd", "rmsprop", "adagrad", "adadelta", "adamax",
                   "sparse_adam")
MODE_SCHEDULES = {
    "cosine_annealing": {"T_max": 400},
    "cosine_annealing_warm_restarts": {"T_0": 50, "T_mult": 2},
    "step": {"step_size": 100, "gamma": 0.5},
    "multi_step": {"milestones": [100, 250], "gamma": 0.5},
    "exponential": {"gamma": 0.995},
    "cyclic": {"base_lr": 0.01, "max_lr": 0.1, "step_size_up": 100, "mode": "triangular2"},
}
# the modes whose output is the unperturbed reconstruction, in the JAX
# package too: bce's loss is NaN on the detector's tanh outputs, so no step
# is ever better; ber has no gradient
UNPERTURBED = ("bce", "ber")
# SGD and Adadelta barely move the coefficients at lr 0.1 (the JAX package
# reads 20 % BER on a 2 s clip): their BER is printed, not gated
SLOW_MODES = ("sgd", "adadelta")
# the sign loss is 0 once every bit's sign is right inside the solve, so the
# best snapshot keeps the first such iteration, whose smallest margin is
# 1e-4 to 1e-2: the reconstruction can flip that bit on a lane, in the JAX
# package too (its float32 path reads 5 % on one of six 2 s lanes;
# ``PYTHONPATH=. python tests/test_torch_solver_modes.py`` retakes it).  Its
# gate is the solve's own: best loss 0 on every lane; its BER is printed
MARGINLESS_MODES = ("sign",)
LOADER_FILES, LOADER_BATCH, LOADER_RUNS = 9, 4, 20  # 4 + 4 + 1: a short final batch


def _short_solve(torch, label, cfg, d, det_cpu, pair, wm2, lbfgs=False) -> float:
    """The 10-iteration solve of ``pair`` on the card and through the plain
    versions on the CPU: |best_loss difference| (0 where both have none,
    as bce's), held to SHORT_LOSS_TOL."""
    from aware_tpu_torch.embed.solver import embed_batch, embed_lbfgs

    short = cfg.replace(num_iterations=10)
    dev = torch.device("cuda")
    if lbfgs:
        res = [embed_lbfgs(net, pair[0].to(dv), wm2[0].to(dv), short).best_loss.reshape(1)
               for net, dv in ((d.net, dev), (det_cpu.net, torch.device("cpu")))]
    else:
        res = [embed_batch(net, pair.to(dv), wm2.to(dv), short).best_loss
               for net, dv in ((d.net, dev), (det_cpu.net, torch.device("cpu")))]
    card, cpu = res[0].cpu(), res[1]
    both_none = torch.isinf(card) & torch.isinf(cpu)
    dloss = float(torch.where(both_none, 0.0, (card - cpu).abs()).max())
    say(f"phase 9 reference, {label}: 10-iteration best_loss card {card.tolist()} CPU plain "
        f"{cpu.tolist()}, |diff| {dloss:.3e} (bound {SHORT_LOSS_TOL})")
    if not dloss < SHORT_LOSS_TOL:
        raise RuntimeError(f"{label}: the card's solve departs from the plain solve")
    return dloss


def solver_modes(torch, kernels, clips, bits, det_cpu) -> None:
    """Phase 9: every loss, optimizer and schedule of the card schema, L-BFGS,
    and the host runtime (module docstring).  Every mode runs, and the
    phase then fails naming each mode that failed."""
    from aware_tpu_torch import embed_watermark_batch, load
    from aware_tpu_torch.embed.solver import build_problem, embed_batch

    dev = torch.device("cuda")
    sr = 16000
    x = torch.as_tensor(clips, device=dev)
    wm = torch.as_tensor(2.0 * bits - 1.0, dtype=torch.float32, device=dev)
    pair, wm2 = torch.as_tensor(clips[:2, : 2 * sr]), wm[:2].cpu()
    modes = ([(name, {"loss": name}) for name in MODE_LOSSES]
             + [(name, {"optimizer_name": name}) for name in MODE_OPTIMIZERS]
             + [(name, {"scheduler_name": name, "scheduler_params": params})
                for name, params in MODE_SCHEDULES.items()])
    start_out, summary, failed = None, [], []
    for name, override in modes:
        try:
            e, d = load(device=dev, **override)
            path = build_problem(d.net, x, wm, e.cfg).path
            want = "iteration_step" if "scheduler_name" in override else "iteration_forward"
            if path != want:
                raise RuntimeError(f"the {path} path, not {want}")
            # rows 9-10 for a loss or optimizer (ber's loss has no gradient
            # graph, so nothing reaches the VJP), row 11 for a schedule
            per_iteration = ({"iteration_step": 1} if want == "iteration_step" else
                             {"iteration_forward_fwd": 1,
                              "iteration_forward_bwd": int(name != "ber")})
            label = f"mode {name} ({path})"
            run = embed_and_read(torch, kernels, label, e, d, clips, bits, phase="9")
            summary.append(f"{name} {run['embed_s']:.3f} s {run['snr'].mean():.2f} dB")
            check_launches(label, run["launches"], per_iteration, e.cfg.num_iterations)
            _short_solve(torch, label, e.cfg, d, det_cpu, pair, wm2)
            if name in UNPERTURBED:
                if start_out is None:
                    e0, _ = load(device=dev, num_iterations=0)
                    start_out = embed_watermark_batch(clips, sr, bits, e0)
                diff = float(np.abs(run["out"] - start_out).max())
                say(f"phase 9 {label}: max |output - the 0-iteration reconstruction| {diff:.3e}")
                if diff != 0.0:
                    raise RuntimeError("not the unperturbed reconstruction")
            elif name in SLOW_MODES:
                say(f"phase 9 {label}: mean BER {run['ber'].mean():.2f} % (a reading, not gated)")
            elif name in MARGINLESS_MODES:
                best = embed_batch(d.net, x, wm, e.cfg).best_loss
                say(f"phase 9 {label}: best loss per lane {best.tolist()} (must be 0); mean BER "
                    f"{run['ber'].mean():.2f} % (a reading, not gated)")
                if best.abs().max() != 0.0:
                    raise RuntimeError("the solve did not reach every sign")
            elif run["ber"].any():
                raise RuntimeError("a lane did not read back its message")
        except RuntimeError as err:
            say(f"phase 9 mode {name} FAILED: {err}")
            failed.append(name)
    say(f"phase 9 modes, B={len(clips)} x {clips.shape[1] / sr:g} s x 400 iterations, embed s "
        "and mean SNR: " + "; ".join(summary))

    try:
        lbfgs_mode(torch, kernels, clips, bits, det_cpu, pair, wm2)
    except RuntimeError as err:
        say(f"phase 9 lbfgs FAILED: {err}")
        failed.append("lbfgs")
    host_runtime(torch, kernels, clips, bits)
    if failed:
        raise RuntimeError(f"phase 9: the modes {failed} failed")


def lbfgs_mode(torch, kernels, clips, bits, det_cpu, pair, wm2) -> None:
    """Phase 9's L-BFGS: the service's single-clip embed of the first clip,
    one value and gradient an iteration through rows 9-10, then the short
    solve of ``pair``."""
    from aware_tpu_torch import detect_watermark, embed_watermark, load

    sr = 16000
    e, d = load(device=torch.device("cuda"), optimizer_name="lbfgs")
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = embed_watermark(clips[0], sr, bits[0], e)
    torch.cuda.synchronize()
    lbfgs_s = time.perf_counter() - t0
    ber = float(np.mean(detect_watermark(out, sr, d) != bits[0]) * 100.0)
    n_out = len(out)
    snr = 10 * np.log10(np.mean(out**2) / np.mean((out - clips[0, :n_out]) ** 2))
    launches = {k.__name__: k.launches for k in kernels}
    say(f"phase 9 lbfgs (embed_watermark, 1 x {clips.shape[1] / sr:g} s x "
        f"{e.cfg.num_iterations} iterations): embed "
        f"{lbfgs_s:.3f} s, BER {ber} %, SNR {snr:.2f} dB, launches {launches}")
    check_launches("lbfgs", launches, {"iteration_forward_fwd": 1, "iteration_forward_bwd": 1},
                   e.cfg.num_iterations)
    if ber != 0.0 or not np.isfinite(out).all():
        raise RuntimeError("lbfgs: the clip did not read back its message")
    _short_solve(torch, "lbfgs (embed_lbfgs)", e.cfg, d, det_cpu, pair, wm2, lbfgs=True)


def host_runtime(torch, kernels, clips, bits) -> None:
    """Phase 9's host runtime: the g++ build, the GMM gate on the phase 3
    clips plus a silent lane, the loader's batches in file order."""
    import tempfile

    from aware_tpu_torch import detect_watermark_batch, embed_watermark_batch, load, native

    t0 = time.perf_counter()
    so = native.build_native()
    say(f"phase 9 host runtime: g++ {time.perf_counter() - t0:.2f} s -> {so.name}")
    sr = 16000
    e, d = load(device=torch.device("cuda"), vad="webrtc_gmm")
    lanes = np.concatenate([clips, np.zeros((1, clips.shape[1]), np.float32)])
    lane_bits = np.concatenate([bits, bits[:1]])
    t0 = time.perf_counter()
    gate = [native.vad_gmm_is_silent(a, sr) for a in lanes]
    gate_s = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    out, mask = embed_watermark_batch(lanes, sr, lane_bits, e, on_silent="mask")
    launches = {k.__name__: k.launches for k in kernels}
    ber = np.mean(detect_watermark_batch(out[:-1], sr, d) != bits, axis=1) * 100.0
    say(f"phase 9 vad webrtc_gmm, {len(lanes)} lanes (the {len(clips)} clips and a silent one): "
        f"gate {gate} in {gate_s:.3f} s on the host, mask {mask.tolist()}, BER % per lane "
        f"{ber.tolist()}, launches {launches}")
    check_launches("vad webrtc_gmm", launches, {"iteration_step": 1}, e.cfg.num_iterations)
    if (mask.tolist() != [True] * len(clips) + [False] or ber.any()
            or not np.array_equal(out[-1], lanes[-1, : out.shape[1]])):
        raise RuntimeError("the GMM gate's batch embed failed")

    rng = np.random.default_rng(9)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i in range(LOADER_FILES):
            path = f"{tmp}/clip{i}.wav"
            native.write_wav(path, speechlike(rng, 0.25 + 0.05 * i, sr), sr)
            files.append(path)
        want = list(native.BatchLoader(files, LOADER_BATCH, sr // 2, n_threads=1))
        t0 = time.perf_counter()
        for _ in range(LOADER_RUNS):
            got = list(native.BatchLoader(files, LOADER_BATCH, sr // 2, n_threads=4))
            if len(got) != len(want) or not all(
                    np.array_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w)):
                raise RuntimeError("the loader's batches with 4 threads differ from 1 thread's")
        loader_s = time.perf_counter() - t0
    say(f"phase 9 loader: {LOADER_FILES} files in batches of {LOADER_BATCH} (counts "
        f"{[b[3] for b in want]}), 4 threads gave the 1-thread batches in {LOADER_RUNS} runs "
        f"({loader_s:.3f} s)")
    if [b[3] for b in want] != [4, 4, 1]:
        raise RuntimeError("the loader's counts are not 4, 4, 1")


# ---- phase 10: the payload and long-form services, and the command line
MSG_K = 8                                 # payload bits of the ECC messages
SPEEDS = ((21, 20), (9, 10), (11, 10))    # resample_poly (up, down): speed changes
STREAM_HOURS = 1.0
PLANTS, PLANT_SECONDS = 24, 4.0
MEMORY_RATIO = 1.25  # the hour's peak device memory over its first 10 minutes'


def messages(torch, kernels, emb, det, clips, rng) -> np.ndarray:
    """Phase 10 (a): seeded k = 8 messages through the [20, 8] code into the
    phase 3 clips (one batch embed, and embed_message on one clip), read
    back by detect_message, then by detect_message_robust after a 0.9 and
    a 1.1 speed change.  Returns the messages."""
    from aware_tpu_torch.ops.resample import resample_poly
    from aware_tpu_torch.service import ecc

    sr = emb.cfg.detection_net.sample_rate
    msgs = rng.integers(0, 2, (len(clips), MSG_K))
    words = np.stack([ecc.encode_message(m, emb.output_length) for m in msgs])
    run = embed_and_read(torch, kernels, f"ECC messages (k = {MSG_K})", emb, det, clips, words,
                         phase="10")
    if run["ber"].any():
        raise RuntimeError("messages: a lane did not read back its codeword")
    check_launches("messages", run["launches"], {"iteration_step": 1}, emb.cfg.num_iterations)
    out = run["out"]
    for k in kernels:
        k.launches = 0
    one = ecc.embed_message(clips[0], sr, msgs[0], emb)
    check_launches("embed_message", {k.__name__: k.launches for k in kernels},
                   {"iteration_step": 1}, emb.cfg.num_iterations)
    reads = {"clean": out, "embed_message": one[None]}
    dev = torch.device("cuda")
    for up, down in ((9, 10), (11, 10)):
        reads[f"speed ({up}, {down})"] = resample_poly(
            torch.as_tensor(out, device=dev), up, down).cpu().numpy()
    for label, audio in reads.items():
        t0 = time.perf_counter()
        if label.startswith("speed"):
            got = [ecc.detect_message_robust(a, sr, det, MSG_K) for a in audio]
            lanes = [f"{kind} {rate}" for _, kind, rate in got]
            got = [g[0] for g in got]
        else:
            got, lanes = [ecc.detect_message(a, sr, det, MSG_K) for a in audio], None
        wall = time.perf_counter() - t0
        want = msgs[:1] if label == "embed_message" else msgs
        ok = sum(np.array_equal(g.msg_bits, m) for g, m in zip(got, want))
        say(f"phase 10 messages, {label}: {ok}/{len(want)} decoded, margins "
            f"{[round(g.margin, 4) for g in got]}, p-values "
            f"{[float(f'{g.pvalue:.3e}') for g in got]}"
            + (f", lanes {lanes}" if lanes else "") + f", {wall:.3f} s")
        if ok != len(want):
            raise RuntimeError(f"messages, {label}: {ok} of {len(want)} decoded")
    return msgs


def robust_detection(torch, det, default_out, bits, turbo, plain_eval, plain_wall) -> None:
    """Phase 10 (b): desync-robust detection of phase 3's default-card
    embeds after speed changes and on the clean clips, the stretch
    readings, and the robust eval beside phase 8's plain one."""
    from aware_tpu_torch import detect_watermark_batch
    from aware_tpu_torch.attacks.vocoder import time_stretch
    from aware_tpu_torch.eval import run_robustness_eval
    from aware_tpu_torch.ops.resample import resample_poly
    from aware_tpu_torch.service.robust import detect_watermark_robust

    sr = det.cfg.detection_net.sample_rate
    dev = torch.device("cuda")
    y = torch.as_tensor(default_out, device=dev)

    def robust_all(audio):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [detect_watermark_robust(a, sr, det, return_confidence=True) for a in audio]
        wall = (time.perf_counter() - t0) / len(audio)
        ber = np.array([np.mean(r.bits != b) * 100.0 for r, b in zip(res, bits)])
        return res, ber, wall

    cases = [("clean", None, default_out)]
    cases += [(f"speed ({up}, {down})", (up, down), resample_poly(y, up, down).cpu().numpy())
              for up, down in SPEEDS]
    for label, speed, audio in cases:
        res, ber, wall = robust_all(audio)
        plain = np.mean(detect_watermark_batch(audio, sr, det) != bits, axis=1) * 100.0
        lanes = [(r.kind, r.rate) for r in res]
        say(f"phase 10 robust, {label}: BER % per lane robust {ber.tolist()} plain "
            f"{plain.tolist()}; lanes {lanes}; {wall:.4f} s a clip (full grid, refine)")
        if ber.any():
            raise RuntimeError(f"robust, {label}: a lane did not read back")
        if speed is None:
            if any(lane != ("resample", 1.0) for lane in lanes):
                raise RuntimeError(f"robust, clean: lanes {lanes}, not the identity")
            continue
        rate = speed[1] / speed[0]
        if any(r.kind != "resample" or abs(r.rate - rate) >= 0.06 for r in res):
            raise RuntimeError(f"robust, {label}: lanes {lanes}, not resample near {rate:.4f}")
    for rate in (0.9, 1.1):
        audio = time_stretch(y, rate).cpu().numpy()
        res, ber, wall = robust_all(audio)
        plain = np.mean(detect_watermark_batch(audio, sr, det) != bits, axis=1) * 100.0
        say(f"phase 10 robust, time_stretch {rate} (a reading): mean BER robust {ber.mean():.2f} "
            f"% plain {plain.mean():.2f} %; lanes {[(r.kind, r.rate) for r in res]}; "
            f"{wall:.4f} s a clip")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_robustness_eval(n_clips=EVAL_CLIPS, seed=0, model=turbo, robust=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = {k: (round(results[k], 4), round(plain_eval[k], 4)) for k in sorted(results)}
    say(f"phase 10 robust eval, turbo card, {EVAL_CLIPS} clips x 22 attacks: wall {wall:.3f} s "
        f"(phase 8's plain eval {plain_wall:.3f} s); (robust, plain) per key: {json.dumps(rows)}")
    if set(results) != set(plain_eval) or results["clean_ber"] != 0.0:
        raise RuntimeError("the robust eval's keys differ from the plain eval's, or clean_ber != 0")


def speech_stream(torch, seconds: float, sr: int, seed: int = 77) -> np.ndarray:
    """Continuous speech-like audio as tools/streaming_eval.py's
    build_stream makes it: the eval harness's 10 s fixtures
    (synthesize_speech_clip(seed * 1000 + i)) end to end, each at a gain
    drawn from default_rng(seed).  The draws are numpy's, in the fixture's
    order; the harmonics are summed on the card in float64 (numpy takes
    tens of seconds for an hour)."""
    n, clip = int(np.ceil(seconds / 10.0)), 10 * sr
    u = np.empty((n, 27))
    noise = np.empty((n, clip))
    for i in range(n):
        r = np.random.default_rng(seed * 1000 + i)
        u[i] = r.random(27)  # f0, its modulation rate, 24 phases, the envelope's rate
        noise[i] = r.standard_normal(clip)
    gain = np.random.default_rng(seed).uniform(0.4, 1.0, n)[:, None]
    dev = torch.device("cuda")
    u = torch.as_tensor(u, device=dev)
    t = torch.arange(clip, dtype=torch.float64, device=dev) / sr
    f0 = 100.0 + 60.0 * u[:, :1] + 30.0 * torch.sin(2 * np.pi * (1.5 + u[:, 1:2]) * t)
    phase = torch.cumsum(2 * np.pi * f0 / sr, dim=-1)
    del f0
    x = torch.zeros_like(phase)
    for k in range(1, 25):
        x += torch.cos(k * phase + u[:, 1 + k : 2 + k] * 6.28) / k
    del phase
    env = 0.35 + 0.65 * torch.clamp(torch.sin(2 * np.pi * (2.5 + u[:, 26:27]) * t), min=0)
    x = x * env + 0.02 * torch.as_tensor(noise, device=dev)
    x = (x / x.abs().amax(dim=1, keepdim=True)).float()
    out = (x.cpu().numpy() * gain).astype(np.float32).reshape(-1)[: int(seconds * sr)]
    del x, env, t, u
    torch.cuda.empty_cache()
    return out


def streaming(torch, kernels, emb, det, seed) -> np.ndarray:
    """Phase 10 (c): one hour of speech with 24 planted 4 s marks carrying
    k = 8 messages (one batch embed), localized by StreamingDetector with
    the auto threshold, 2 s windows and a 1 s hop, as tools/streaming_eval.py
    builds and scores it; the hour's peak device memory against its first
    10 minutes'.  Returns the hour with its plants."""
    from aware_tpu_torch import embed_watermark_batch
    from aware_tpu_torch.eval import synthesize_speech_clip
    from aware_tpu_torch.service import ecc
    from aware_tpu_torch.service.streaming import IN_FLIGHT, StreamingDetector

    sr = emb.cfg.detection_net.sample_rate
    t0 = time.perf_counter()
    stream = speech_stream(torch, STREAM_HOURS * 3600, sr, 77 + seed)
    make_s = time.perf_counter() - t0
    # the plants, their messages, offsets and gains: the tool's draws
    rng = np.random.default_rng(11 + seed)
    plant_len = int(PLANT_SECONDS * sr)
    plants = np.stack([synthesize_speech_clip(5000 + i, seconds=PLANT_SECONDS)[:plant_len]
                       for i in range(PLANTS)])
    msgs = rng.integers(0, 2, size=(PLANTS, MSG_K)).astype(np.int32)
    words = np.stack([ecc.encode_message(m, emb.output_length) for m in msgs])
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    marked = embed_watermark_batch(plants, sr, words, emb)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    check_launches("streaming plants", {k.__name__: k.launches for k in kernels},
                   {"iteration_step": 1}, emb.cfg.num_iterations)
    # non-overlapping arbitrary offsets with a window of clearance, each
    # peak-normalized mark at a gain of 0.5-1.0
    window = 2 * sr
    min_gap = marked.shape[1] + 2 * window
    slots = rng.choice((len(stream) - min_gap) // min_gap, size=PLANTS, replace=False)
    offsets = np.sort(slots * min_gap + rng.integers(0, min_gap - plant_len, PLANTS))
    gains = []
    for off, m in zip(offsets, marked):
        gains.append(float(rng.uniform(0.5, 1.0)))
        stream[off : off + len(m)] = m / np.abs(m).max() * gains[-1]

    sd = StreamingDetector(det, window_seconds=2.0, hop_seconds=1.0, threshold="auto")
    peaks = {}
    for label, audio in (("10 minutes", stream[: 600 * sr]), ("hour", stream)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = sd.detect(audio, sr)
        wall = time.perf_counter() - t0
        peaks[label] = torch.cuda.max_memory_allocated()
    n_win = len(res.window_starts)
    spans = [(o / sr, (o + marked.shape[1]) / sr) for o in offsets]
    found, msg_ok, bit_err, matched = 0, 0, [], set()
    for p, ((s0, s1), word, msg) in enumerate(zip(spans, words, msgs)):
        near = [(i, s) for i, s in enumerate(res.segments)
                if s.start_seconds < s1 + 2.0 and s.end_seconds > s0 - 2.0]
        if not near:
            inside = (res.window_starts >= s0) & (res.window_starts + 2.0 <= s1)
            say(f"phase 10 streaming: plant {p} at {s0:.4f} s (gain {gains[p]:.3f}) missed: "
                f"the confidences of its windows {res.confidences[inside].round(4).tolist()}, "
                f"threshold {res.threshold:.4f}")
            continue
        i, seg = max(near, key=lambda p: p[1].confidence)
        found += 1
        matched.add(i)
        bit_err.append(float(np.mean(seg.bits != word)) * 100.0)
        inside = (res.window_starts >= seg.start_seconds) & (res.window_starts <= seg.end_seconds)
        msg_ok += bool(np.array_equal(ecc.decode_message_windows(res.values[inside], MSG_K)
                                      .msg_bits, msg))
    false = len(res.segments) - len(matched)
    ratio = peaks["hour"] / peaks["10 minutes"]
    say(f"phase 10 streaming: {STREAM_HOURS:g} h of speech made in {make_s:.2f} s, {PLANTS} plants "
        f"of {PLANT_SECONDS:g} s embedded in {embed_s:.3f} s; {n_win} windows (2 s, hop 1 s) in "
        f"{wall:.3f} s: {n_win / wall:.1f} windows/s, realtime factor "
        f"{STREAM_HOURS * 3600 / wall:.1f}; threshold {res.threshold:.4f}; segments found "
        f"{found}/{PLANTS}, false {false}, rejected {res.rejected_segments}; messages "
        f"{msg_ok}/{PLANTS}; hit bit error {np.mean(bit_err) if bit_err else float('nan'):.3f} %")
    say(f"phase 10 streaming peak device memory (max_memory_allocated, IN_FLIGHT {IN_FLIGHT}): "
        f"10 minutes {peaks['10 minutes'] / 2**20:.1f} MiB, hour {peaks['hour'] / 2**20:.1f} "
        f"MiB, ratio {ratio:.3f}")
    if n_win != int(STREAM_HOURS * 3600) - 1 or found != PLANTS or false or msg_ok != PLANTS:
        raise RuntimeError(f"streaming: windows {n_win}, segments {found}, false {false}, "
                           f"messages {msg_ok}")
    if ratio > MEMORY_RATIO:
        raise RuntimeError(f"streaming: the hour's peak memory is {ratio:.3f}x the 10 minutes'")
    return stream


def command_line(torch, clips, sr) -> None:
    """Phase 10 (d): ``python -m aware_tpu_torch`` on the card, as
    subprocesses: embed --message, detect --message-k, and detect --robust
    on a 0.9 speed change of the marked file."""
    import os
    import pathlib
    import tempfile

    from aware_tpu_torch.ops.resample import resample_poly
    from aware_tpu_torch.service.ecc import encode_message
    from aware_tpu_torch.utils.io import read_wav, write_wav

    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))

    def cli(*argv) -> str:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "aware_tpu_torch", *argv], cwd=root, env=env,
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise RuntimeError(f"aware_tpu_torch {argv[0]} failed ({run.returncode}):\n"
                               f"{run.stdout}{run.stderr}")
        say(f"phase 10 command line, {argv[0]} {' '.join(argv[2 + (argv[0] == 'embed'):])}: "
            f"{time.perf_counter() - t0:.2f} s")
        return run.stdout

    msg = "10110101"
    word = encode_message(np.array([int(c) for c in msg]), 20)
    with tempfile.TemporaryDirectory() as tmp:
        src, out, sped = f"{tmp}/in.wav", f"{tmp}/out.wav", f"{tmp}/sped.wav"
        write_wav(src, clips[0], sr)
        said = cli("embed", src, out, "--message", msg)
        if "codeword: " + "".join(map(str, word)) not in said:
            raise RuntimeError(f"embed --message printed {said!r}")
        got = json.loads(cli("detect", out, "--message-k", str(MSG_K)))
        audio, _ = read_wav(out)
        x = resample_poly(torch.as_tensor(audio, device=torch.device("cuda")), 9, 10)
        write_wav(sped, x.cpu().numpy(), sr)
        line = cli("detect", sped, "--robust").strip().splitlines()[-1]
    bits = np.array([int(c) for c in line.split()[1]])
    ber = float(np.mean(bits != word)) * 100.0
    say(f"phase 10 command line: message {got['message']} (margin {got['margin']:.4f}, p-value "
        f"{got['pvalue']:.3e}); detect --robust on the (9, 10) speed change: {line!r}, BER {ber} %")
    if got["message"] != msg or ber != 0.0:
        raise RuntimeError("the command line's round trips failed")


def services(torch, kernels, emb, det, clips, default_out, bits, turbo, plain_eval, plain_wall,
             smi, seed) -> np.ndarray:
    """Phase 10: (a) ECC messages, (b) robust detection and the robust eval,
    (c) streaming over an hour, (d) the command line (module docstring).
    Returns (c)'s hour, for phase 12."""
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 10])
    say(f"phase 10 card: {smi}")
    messages(torch, kernels, emb, det, clips, rng)
    robust_detection(torch, det, default_out, bits, turbo, plain_eval, plain_wall)
    hour = streaming(torch, kernels, emb, det, seed)
    command_line(torch, clips, emb.cfg.detection_net.sample_rate)
    say(f"phase 10: {time.perf_counter() - t0:.1f} s ({smi})")
    return hour


# ---- phase 11: the frame geometries and the amortized embedder

# the frame geometries the JAX gate takes off the default kernels, each
# with the path both gates take (n_fft, hop) -> path
GEOMETRY_PATHS = {(768, 192): "slab", (1024, 512): "slab", (2048, 256): "slab",
                  (1024, 200): "frames"}
OLA_GEOMETRIES = ((1024, 512), (768, 192), (2048, 256))  # rows 14-15 at r = 2, 4, 8
KERNEL_GEOMETRY = (2048, 512)  # rows 1-4 at P = 512, hop = 512; past 1024 frames rows 12-13
SHORT_ITERS = 20  # the solves that count a geometry's launches
TURBO_ITERS = 100
TRAIN_STEPS = 20
DISTILL_STEPS = 5
ONESHOT_TOL = 1e-4  # one clip's one-shot embed, card against CPU (float32, TF32 off)


def _geometry(n_fft: int, hop: int, **flags) -> dict:
    return dict(frame_length=n_fft, hop_length=hop, win_length=n_fft, **flags)


def _counted(torch, kernels, run):
    """``run()`` with every count set to 0 just before and read just
    after: (its result, wall s, {kernel: launches} of those launched)."""
    for k in kernels:
        k.launches = 0
        if hasattr(k, "variants"):
            k.variants = dict.fromkeys(k.variants, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k.__name__: k.launches for k in kernels if k.launches}


def _snr(out, ref) -> np.ndarray:
    ref = ref[:, : out.shape[1]]
    return 10 * np.log10(np.mean(out**2, 1) / np.mean((out - ref) ** 2, 1))


def frame_geometries(torch, kernels, clips, bits, smi) -> None:
    """Phase 11 (a): 768/192, 1024/512, 2048/256 and 1024/200 on the
    phase 3 clips (8 x 10 s x 400): the path, no kernel launched, the embed
    s and peak memory, the BER where the JAX package detects (frame length
    1024: 0 % on every lane) and the ValueError where it raises."""
    from aware_tpu_torch import detect_watermark_batch, embed_watermark_batch, load
    from aware_tpu_torch.embed.solver import build_problem

    dev = torch.device("cuda")
    x = torch.as_tensor(clips, device=dev)
    wm = torch.as_tensor(2.0 * bits - 1.0, device=dev, dtype=torch.float32)
    for (n_fft, hop), path in GEOMETRY_PATHS.items():
        emb, det = load(device=dev, **_geometry(n_fft, hop))
        sr = emb.cfg.detection_net.sample_rate
        got = build_problem(det.net, x, wm, emb.cfg).path
        if got != path:
            raise RuntimeError(f"{n_fft}/{hop} took the {got} path, not {path}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, embed_s, launched = _counted(
            torch, kernels, lambda: embed_watermark_batch(clips, sr, bits, emb))
        n_out = (clips.shape[1] // hop) * hop
        if out.shape != (BATCH, n_out) or not np.isfinite(out).all() or launched:
            raise RuntimeError(f"{n_fft}/{hop}: output {out.shape}, kernels {launched}")
        if n_fft == emb.cfg.detection_net.n_fft:
            ber = np.mean(detect_watermark_batch(out, sr, det) != bits, axis=1) * 100.0
            read = f"BER % per lane {ber.tolist()}"
            if ber.any():
                raise RuntimeError(f"{n_fft}/{hop}: a lane did not read back its message")
        else:
            try:
                detect_watermark_batch(out, sr, det)
            except ValueError as err:
                read = f"detection raises ValueError as in the JAX package ({err})"
            else:
                raise RuntimeError(f"{n_fft}/{hop}: detection did not raise")
        say(f"phase 11 geometry {n_fft}/{hop} ({path}): B={BATCH} x {clips.shape[1] / sr:g} s x "
            f"{emb.cfg.num_iterations}: embed {embed_s:.3f} s, mean SNR "
            f"{_snr(out, clips).mean():.2f} dB, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, no kernel; {read} ({smi})")


def _geometry_reading(torch, name, rec, kernel, plain, flops, nbytes, launches, shape,
                      smi) -> None:
    """A kernel at a new geometry: held to TOL * max|plain| against its plain
    version, kernel and plain timed in turns, its bound; kept in the
    kernel's record under "geometries"."""
    err = _close_flat(f"{name} at {shape}", kernel(), plain())
    turns = in_turns(torch, {"ms": kernel, "plain_ms": plain})
    reading = _record(name, rec["source"], rec["replaces"], err, flops, nbytes)
    reading.update({k: sum(v) / len(v) for k, v in turns.items()}, launches=launches,
                   shape=shape)
    for key in ("name", "route", "source", "replaces", "library_ms"):
        reading.pop(key)
    rec.setdefault("geometries", []).append(reading)
    say(f"phase 11 kernel {name} at {shape}: max_abs_err {err:.3e}, in turns (kernel, plain, "
        f"then reversed) device ms " + "; ".join(f"{k} {v[0]:.5f} {v[1]:.5f}"
                                                 for k, v in turns.items())
        + f", bound_us {reading['bound_ms'] * 1e3:.2f} ({reading['bound_by']}), launches "
        f"{launches} ({smi})")


def kernel_geometry(torch, kernels, records, clips, bits, rng, smi) -> None:
    """Phase 11 (b): rows 1-4 at 2048/512 on the phase 3 clips (B = 8,
    T = 313, P = 512): a 400-iteration solve on "band_analysis" (400
    launches each, no other kernel), each against its plain version and
    timed in turns, a 10-iteration card-vs-CPU solve; rows 12-13 on one
    40 s pair (T = 1251, the tiled path) held the same way over a short
    solve; rows 14-15 at r = 2, 4 (hop 192) and 8 on "ola", each variant
    against the plain version, with a short solve's launches."""
    from aware_tpu_torch import load
    from aware_tpu_torch.embed.solver import build_problem, embed_batch
    from aware_tpu_torch.ops.kernels import ola_norm as on
    from aware_tpu_torch.ops.kernels import roundtrip as rt
    from aware_tpu_torch.ops.kernels import roundtrip_tiled as rtt

    dev = torch.device("cuda")
    n_fft, hop = KERNEL_GEOMETRY
    emb, det = load(device=dev, **_geometry(n_fft, hop))
    cfg = emb.cfg
    sr = cfg.detection_net.sample_rate
    x = torch.as_tensor(clips, device=dev)
    wm = torch.as_tensor(2.0 * bits - 1.0, device=dev, dtype=torch.float32)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)

    pb = build_problem(det.net, x, wm, cfg)
    bsz, t, p = pb.ct0.shape
    if (pb.path, t, p) != ("band_analysis", clips.shape[1] // hop + 1, 512):
        raise RuntimeError(f"{n_fft}/{hop}: {pb.path} at T = {t}, P = {p}")
    lr = t - 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, embed_s, launched = _counted(torch, kernels, lambda: embed_batch(det.net, x, wm, cfg))
    per = {k: cfg.num_iterations for k in ("synth_norm_fwd", "synth_norm_bwd",
                                           "band_analysis_fwd", "band_analysis_bwd")}
    finite = torch.isfinite(res.audio).all() and torch.isfinite(res.best_loss).all()
    if launched != per or not finite:
        raise RuntimeError(f"{n_fft}/{hop}: launches {launched}, not {per}, or a non-finite result")
    ref = embed_batch(det.net, x, wm, cfg.replace(num_iterations=1))
    say(f"phase 11 {n_fft}/{hop} (band_analysis, T = {t}, P = {p}): B={BATCH} x "
        f"{clips.shape[1] / sr:g} s x "
        f"{cfg.num_iterations}: embed {embed_s:.3f} s, best loss per lane "
        f"{[round(v, 4) for v in res.best_loss.tolist()]} (first iteration's "
        f"{[round(v, 4) for v in ref.final_loss.tolist()]}), mean SNR "
        f"{_snr(res.audio.cpu().numpy(), clips).mean():.2f} dB, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, launches {launched} ({smi})")
    if not (res.best_loss < ref.final_loss).all():
        raise RuntimeError(f"{n_fft}/{hop}: the solve did not lower every lane's loss")
    pair = clips[:2, : 2 * sr]
    short = cfg.replace(num_iterations=10)
    _, det_c = load(device="cpu", **_geometry(n_fft, hop))
    res_k = embed_batch(det.net, torch.as_tensor(pair, device=dev), wm[:2], short)
    res_p = embed_batch(det_c.net, torch.as_tensor(pair), wm[:2].cpu(), short)
    dloss = float((res_k.best_loss.cpu() - res_p.best_loss).abs().max())
    say(f"phase 11 reference, {n_fft}/{hop}: 10-iteration best_loss card vs CPU plain |diff| "
        f"{dloss:.3e} ({smi})")
    if not dloss < 0.02:
        raise RuntimeError(f"{n_fft}/{hop}: the card's solve departs from the plain solve")

    ct = pb.ct0.contiguous()
    y2, m1 = rt.synth_norm_fwd_plain(ct, pb.csin, pb.y_const, pb.env, pb.ab)
    g_y2, g_cs = rand(bsz, lr, hop), rand(bsz, t, 2 * p)
    basis = n_fft * 2 * p * BF16
    y2_bytes, cs_bytes = bsz * lr * hop * F32, bsz * t * 2 * p * F32
    shape = f"{n_fft}/{hop}, B={bsz}, T={t}, P={p}"
    for name, kernel, plain, flops, nbytes in (
        ("synth_norm_fwd", lambda: rt.synth_norm_fwd(ct, pb.csin, pb.y_const, pb.env, pb.ab),
         lambda: rt.synth_norm_fwd_plain(ct, pb.csin, pb.y_const, pb.env, pb.ab),
         2 * bsz * lr * hop * (rt.R * 2 * p),
         bsz * t * p * F32 + bsz * t * 2 * p * BF16 + 2 * y2_bytes + lr * hop * F32 + basis
         + bsz * F32),
        ("synth_norm_bwd", lambda: rt.synth_norm_bwd(g_y2, y2, m1, pb.csin, pb.env, pb.abt),
         lambda: rt.synth_norm_bwd_plain(g_y2, y2, m1, pb.csin, pb.env, pb.abt),
         2 * bsz * t * (2 * p) * (rt.R * hop) + 2 * bsz * t * p,
         2 * y2_bytes + bsz * F32 + bsz * t * 2 * p * BF16 + lr * hop * F32 + basis
         + bsz * t * p * F32),
        ("band_analysis_fwd", lambda: rt.band_analysis_fwd(y2, pb.csw),
         lambda: rt.band_analysis_fwd_plain(y2, pb.csw),
         2 * bsz * t * (2 * p) * (rt.R * hop), y2_bytes + basis + cs_bytes),
        ("band_analysis_bwd", lambda: rt.band_analysis_bwd(g_cs, pb.cswt),
         lambda: rt.band_analysis_bwd_plain(g_cs, pb.cswt),
         2 * bsz * lr * hop * (rt.R * 2 * p), cs_bytes + basis + y2_bytes),
    ):
        _geometry_reading(torch, name, records[name], kernel, plain, flops, nbytes,
                          launched[name], shape, smi)
    del pb, y2, g_y2, g_cs

    # rows 12-13: one 40 s pair past 1024 frames
    long_rng = np.random.default_rng([int(rng.integers(1 << 30)), 40])
    pair = np.stack([speechlike(long_rng, 40.0, sr) for _ in range(2)])
    xl = torch.as_tensor(pair, device=dev)
    pb = build_problem(det.net, xl, wm[:2], cfg)
    _, t, p = pb.ct0.shape
    if (pb.path, t) != ("tiled", pair.shape[1] // hop + 1):
        raise RuntimeError(f"40 s at {n_fft}/{hop}: {pb.path} at T = {t}")
    scfg = cfg.replace(num_iterations=SHORT_ITERS)
    res, long_s, launched = _counted(torch, kernels,
                                     lambda: embed_batch(det.net, xl, wm[:2], scfg))
    want = {"shift_mm": 3 * SHORT_ITERS, "synth_tiled_fwd": SHORT_ITERS}
    if launched != want or not torch.isfinite(res.audio).all():
        raise RuntimeError(f"40 s at {n_fft}/{hop}: launches {launched}, not {want}")
    say(f"phase 11 {n_fft}/{hop} 40 s pair (tiled, T = {t}): {SHORT_ITERS} iterations in "
        f"{long_s:.3f} s, launches {launched} ({smi})")
    tc, ct, lr = pb.tiled, pb.ct0.contiguous(), t - 1
    u, _ = rtt.synth_tiled_fwd_plain(ct, tc.csinp, pb.y_const, pb.env, tc.w_sf)
    xa = torch.nn.functional.pad(u, (0, 0, rtt.HALO - 1, 0)).contiguous()
    rows = rtt.m1_rows(lr)
    shape = f"{n_fft}/{hop}, B=2, T={t}, P={p}"
    _geometry_reading(
        torch, "shift_mm", records["shift_mm"], lambda: rtt.shift_mm(xa, tc.w_af, t),
        lambda: rtt.shift_mm_plain(xa, tc.w_af, t), 2 * 2 * t * hop * (rtt.R * 2 * p),
        xa.numel() * F32 + tc.w_af.numel() * BF16 + 2 * t * 2 * p * F32, launched["shift_mm"],
        shape + " (the analysis use)", smi)
    _geometry_reading(
        torch, "synth_tiled_fwd", records["synth_tiled_fwd"],
        lambda: rtt.synth_tiled_fwd(ct, tc.csinp, pb.y_const, pb.env, tc.w_sf),
        lambda: rtt.synth_tiled_fwd_plain(ct, tc.csinp, pb.y_const, pb.env, tc.w_sf),
        2 * 2 * rows * hop * (rtt.R * 2 * p),
        ct.numel() * F32 + tc.csinp.numel() * F32 + 2 * pb.y_const.numel() * F32
        + pb.env.numel() * F32 + tc.w_sf.numel() * BF16 + 2 * F32,
        launched["synth_tiled_fwd"], shape, smi)
    del pb, u, xa, res

    # rows 14-15 at r = 2, 4 (hop 192) and 8
    for n_fft_o, hop_o in OLA_GEOMETRIES:
        e_o, d_o = load(device=dev, **_geometry(n_fft_o, hop_o, use_pallas_ola=True))
        pb = build_problem(d_o.net, x, wm, e_o.cfg)
        if pb.path != "ola":
            raise RuntimeError(f"use_pallas_ola at {n_fft_o}/{hop_o} took {pb.path}")
        bsz, t, _ = pb.ct0.shape
        r = n_fft_o // hop_o
        c = pb.plain
        coeffs = pb.ct0[..., : pb.nb]
        frames = (c.frames_const + torch.cat([coeffs * c.cos, coeffs * c.sin], -1) @ c.ab
                  ).contiguous()
        y2p, m1p = on.ola_normalize_fwd_plain(frames, pb.env)
        g = rand(*y2p.shape)
        ref = on.ola_normalize_bwd_plain(g, y2p, pb.env, m1p, n_fft_o)
        outs = {v: on._ola_fwd_variant(frames, pb.env, v) for v in on.VARIANTS}
        err_f = max(max(_close_ola(f"ola_normalize_fwd {v} r={r}", yy, y2p, OLA_FWD_TOL),
                        _close_ola(f"ola_normalize_fwd {v} r={r} m1", mm, m1p, OLA_FWD_TOL))
                    for v, (yy, mm) in outs.items())
        if not all(torch.equal(a, b) for a, b in zip(outs["cluster"], outs["stream"])):
            raise RuntimeError(f"ola_normalize_fwd r={r}: the variants' bits differ")
        err_b = max(_close_ola(f"ola_normalize_bwd {v} r={r}",
                               on._ola_bwd_variant(g, y2p, pb.env, m1p, v, n_fft=n_fft_o), ref,
                               OLA_VJP_TOL) for v in on.VARIANTS)
        scfg = e_o.cfg.replace(num_iterations=SHORT_ITERS)
        res, ola_s, launched = _counted(torch, kernels,
                                        lambda: embed_batch(d_o.net, x, wm, scfg))
        want = {"ola_normalize_fwd": SHORT_ITERS, "ola_normalize_bwd": SHORT_ITERS}
        variants = {k.__name__: dict(k.variants) for k in on.KERNELS}
        if launched != want or not torch.isfinite(res.audio).all():
            raise RuntimeError(f"ola r={r}: launches {launched}, not {want}")
        say(f"phase 11 ola r={r} ({n_fft_o}/{hop_o}, T = {t}): {SHORT_ITERS} iterations in "
            f"{ola_s:.3f} s, launches by variant {variants}; max_abs_err fwd {err_f:.3e} "
            f"VJP {err_b:.3e} (every variant) ({smi})")
        rows = bsz * (t - 1) * hop_o * F32
        shape = f"{n_fft_o}/{hop_o} (r={r}), B={bsz}, T={t}"
        _geometry_reading(
            torch, "ola_normalize_fwd", records["ola_normalize_fwd"],
            lambda: on.ola_normalize_fwd(frames, pb.env),
            lambda: on.ola_normalize_fwd_plain(frames, pb.env), 0,
            frames.numel() * F32 + pb.env.numel() * F32 + rows + bsz * F32,
            launched["ola_normalize_fwd"], shape, smi)
        _geometry_reading(
            torch, "ola_normalize_bwd", records["ola_normalize_bwd"],
            lambda: on.ola_normalize_bwd(g, y2p, pb.env, m1p, n_fft_o),
            lambda: on.ola_normalize_bwd_plain(g, y2p, pb.env, m1p, n_fft_o), 0,
            2 * rows + pb.env.numel() * F32 + bsz * F32 + frames.numel() * F32,
            launched["ola_normalize_bwd"], shape, smi)
        del pb, frames, res


def oneshot_and_turbo(torch, kernels, records, emb, det, clips, bits, smi) -> None:
    """Phase 11 (c) and the turbo half of (d): each one-shot variant and
    a U-Net bundle (``amortized_embed``) on the phase 3 clips (BER and SNR
    readings, s a clip), one clip against the CPU's; the turbo embed of
    each clip at TURBO_ITERS iterations (row 11 x TURBO_ITERS a clip,
    0 % BER)."""
    from aware_tpu_torch import detect_watermark_batch, load
    from aware_tpu_torch.models.detector import KEY_DIR
    from aware_tpu_torch.service import fast
    from aware_tpu_torch.train.adversarial import amortized_embed

    sr = emb.cfg.detection_net.sample_rate
    for variant in sorted(fast._VARIANTS):
        outs, wall, launched = _counted(torch, kernels, lambda: np.stack([
            fast.embed_watermark_oneshot(c, sr, b, emb, variant=variant)
            for c, b in zip(clips, bits)]))
        ber = np.mean(detect_watermark_batch(outs, sr, det) != bits, axis=1) * 100.0
        if launched or not np.isfinite(outs).all():
            raise RuntimeError(f"one-shot {variant}: kernels {launched} or a non-finite output")
        say(f"phase 11 one-shot {variant}: {wall / BATCH * 1e3:.2f} ms a "
            f"{clips.shape[1] / sr:g} s clip, BER % per "
            f"lane {ber.tolist()} (mean {ber.mean():.2f}), mean SNR "
            f"{_snr(outs, clips).mean():.2f} dB ({smi})")
    with np.load(KEY_DIR / "amortized_unet_speech.npz") as z:
        unet = {k: z[k] for k in z.files}
    pats = 2.0 * bits - 1.0
    outs, wall, _ = _counted(torch, kernels, lambda: np.stack([
        amortized_embed(unet, None, c, p, emb.cfg) for c, p in zip(clips, pats)]))
    ber = np.mean(detect_watermark_batch(outs, sr, det) != bits, axis=1) * 100.0
    say(f"phase 11 amortized_embed, U-Net (amortized_unet_speech): {wall / BATCH * 1e3:.2f} ms "
        f"a clip, BER % per lane {ber.tolist()}, mean SNR {_snr(outs, clips).mean():.2f} dB "
        f"({smi})")
    emb_c, _ = load(device="cpu")
    card = fast.embed_watermark_oneshot(clips[0], sr, bits[0], emb)
    cpu = fast.embed_watermark_oneshot(clips[0], sr, bits[0], emb_c)
    diff = float(np.abs(card - cpu).max())
    say(f"phase 11 one-shot default, clip 0: card vs CPU max |diff| {diff:.3e} ({smi})")
    if not diff <= ONESHOT_TOL:
        raise RuntimeError(f"the one-shot embed departs from the CPU's by {diff:.3e}")

    outs, wall, launched = _counted(torch, kernels, lambda: np.stack([
        fast.embed_watermark_turbo(c, sr, b, emb, num_iterations=TURBO_ITERS)
        for c, b in zip(clips, bits)]))
    ber = np.mean(detect_watermark_batch(outs, sr, det) != bits, axis=1) * 100.0
    want = {"iteration_step": BATCH * TURBO_ITERS}
    say(f"phase 11 turbo ({TURBO_ITERS} iterations from the default bundle): "
        f"{wall / BATCH:.3f} s a {clips.shape[1] / sr:g} s clip, BER % per lane {ber.tolist()}, "
        f"mean SNR "
        f"{_snr(outs, clips).mean():.2f} dB, launches {launched} ({smi})")
    if launched != want or ber.any():
        raise RuntimeError(f"turbo: launches {launched}, not {want}, or a lane lost bits")
    records["iteration_step"]["turbo_launches"] = launched["iteration_step"]


def training(torch, kernels, records, emb, smi) -> None:
    """Phase 11 (d): TRAIN_STEPS adversarial steps on 8 x 2 s diverse clips
    with the desync and compression branches, a joint step (detector_lr,
    dual view), a checkpoint round trip; generate_targets of 8 clips at
    SHORT_ITERS iterations (row 11 x SHORT_ITERS) and DISTILL_STEPS steps
    of each distill step: every loss finite."""
    import tempfile

    from aware_tpu_torch.models.detector import load_key_params
    from aware_tpu_torch.train import adversarial as adv
    from aware_tpu_torch.train import distill

    cfg = emb.cfg
    d_params = load_key_params()
    clips = np.stack([distill.diverse_clip(i, 2.0) for i in range(BATCH)])
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(5)
    tcfg = adv.TrainConfig(desync_attacks=True, compression_attacks=True)
    state = adv.init_train_state(cfg, tcfg, d_params)
    step = adv.make_train_step(cfg, tcfg)
    losses = []

    def run():
        nonlocal state
        for _ in range(TRAIN_STEPS):
            state, m = step(state, clips, adv.training_patterns(rng, BATCH, 20), gen)
            losses.append({k: float(v) for k, v in m.items()})

    _, wall, launched = _counted(torch, kernels, run)
    say(f"phase 11 adversarial training, B={BATCH} x 2 s, desync + compression branches: "
        f"{TRAIN_STEPS} steps in {wall:.3f} s ({TRAIN_STEPS / wall:.2f} steps/s); loss first "
        f"{losses[0]['loss']:.4f} last {losses[-1]['loss']:.4f}, hard_ber last "
        f"{losses[-1]['hard_ber']:.3f}; kernels {launched} ({smi})")
    if not all(np.isfinite(v) for m in losses for v in m.values()) or launched:
        raise RuntimeError("adversarial training: a non-finite metric or a kernel launched")
    jcfg = adv.TrainConfig(train_detector=True, detector_lr=1e-4, dual_view=True)
    joint = adv.init_train_state(cfg, jcfg, d_params)
    t0 = time.perf_counter()
    joint, m = adv.make_train_step(cfg, jcfg)(joint, clips, adv.training_patterns(rng, BATCH, 20),
                                              gen)
    torch.cuda.synchronize()
    say(f"phase 11 joint step (detector_lr 1e-4, dual view): {time.perf_counter() - t0:.3f} s, "
        f"loss {float(m['loss']):.4f} ({smi})")
    if not np.isfinite(float(m["loss"])):
        raise RuntimeError("the joint step's loss is not finite")
    with tempfile.TemporaryDirectory() as tmp:
        adv.save_checkpoint(tmp, joint)
        back = adv.restore_checkpoint(tmp)
    same = all(torch.equal(back.e_params[k], joint.e_params[k]) for k in joint.e_params) and all(
        torch.equal(back.d_params[k], joint.d_params[k]) for k in joint.d_params)
    say(f"phase 11 checkpoint round trip: step {back.step}, the same tensors: {same} ({smi})")
    if not same or back.step != joint.step:
        raise RuntimeError("the checkpoint round trip changed the state")

    targets, wall, launched = _counted(torch, kernels, lambda: distill.generate_targets(
        emb.net, cfg, BATCH, batch=BATCH, seed=0, solver_iterations=SHORT_ITERS))
    clips_t, bands, pats, tgt = targets
    want = {"iteration_step": SHORT_ITERS}
    say(f"phase 11 generate_targets, {BATCH} x 2 s x {SHORT_ITERS} iterations: {wall:.3f} s, "
        f"launches {launched} ({smi})")
    if launched != want or not np.isfinite(tgt).all():
        raise RuntimeError(f"generate_targets: launches {launched}, not {want}")
    records["iteration_step"]["generate_targets_launches"] = launched["iteration_step"]
    for name, make, ecfg, batch in (
        ("make_distill_step", distill.make_distill_step, adv.AmortizedEmbedderConfig(),
         (bands, pats, tgt)),
        ("make_distill_step_visible", distill.make_distill_step_visible,
         adv.AmortizedEmbedderConfig(phase_conditioned=True), (clips_t, pats, tgt)),
    ):
        tc = adv.TrainConfig(embedder=ecfg)
        e = adv._as_params(adv.init_embedder_params(ecfg, bands.shape[1], 20), emb.device)
        st = adv.TrainState(e, adv._as_params(d_params, emb.device),
                            distill.distill_optimizer(tc).init({"e": e}), 0)
        fn = make(cfg, tc)
        out = []
        t0 = time.perf_counter()
        for _ in range(DISTILL_STEPS):
            st, m = fn(st, *batch)
            out.append(float(m["loss"]))
        torch.cuda.synchronize()
        say(f"phase 11 {name}: {DISTILL_STEPS} steps in {time.perf_counter() - t0:.3f} s, "
            f"losses {[round(v, 4) for v in out]} ({smi})")
        if not np.isfinite(out).all():
            raise RuntimeError(f"{name}: a non-finite loss")


def oneshot_command_line(torch, clips, bits, sr, smi) -> None:
    """Phase 11 (e): python -m aware_tpu_torch embed --oneshot --variant
    diverse, then detect, as subprocesses."""
    import os
    import pathlib
    import tempfile

    from aware_tpu_torch.utils.io import write_wav

    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    word = "".join(map(str, bits))
    with tempfile.TemporaryDirectory() as tmp:
        src, out = f"{tmp}/in.wav", f"{tmp}/oneshot.wav"
        write_wav(src, clips, sr)
        lines = []
        for argv in (["embed", src, out, "--oneshot", "--variant", "diverse", "--bits", word],
                     ["detect", out]):
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-m", "aware_tpu_torch", *argv], cwd=root,
                                 env=env, capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                raise RuntimeError(f"aware_tpu_torch {argv[0]} failed ({run.returncode}):\n"
                                   f"{run.stdout}{run.stderr}")
            lines.append(run.stdout.strip().splitlines()[-1])
            say(f"phase 11 command line, {' '.join(argv[:1] + argv[3:])}: "
                f"{time.perf_counter() - t0:.2f} s: {lines[-1]!r} ({smi})")
    got = lines[-1].split()[-1]
    if len(got) != len(word):
        raise RuntimeError(f"detect printed {lines[-1]!r}")
    say(f"phase 11 command line: one-shot (diverse) bits read back {got} of {word}, BER "
        f"{np.mean(np.array(list(got)) != np.array(list(word))) * 100:.1f} % ({smi})")


def geometries_and_amortized(torch, kernels, records, emb, det, clips, bits, smi,
                             seed) -> None:
    """Phase 11: (a) the frame geometries, (b) the kernels at their new
    shapes, (c) the one-shot embeds, (d) turbo and training, (e) the
    command line (module docstring)."""
    t0 = time.perf_counter()
    say(f"phase 11 card: {smi}")
    frame_geometries(torch, kernels, clips, bits, smi)
    kernel_geometry(torch, kernels, records, clips, bits, np.random.default_rng([seed, 11]), smi)
    oneshot_and_turbo(torch, kernels, records, emb, det, clips, bits, smi)
    training(torch, kernels, records, emb, smi)
    oneshot_command_line(torch, clips[0], bits[0], emb.cfg.detection_net.sample_rate, smi)
    say(f"phase 11: {time.perf_counter() - t0:.1f} s ({smi})")


# ---- phase 12: the multi-device path in a world of one, and a detector of
# another architecture

# a card's detector that the kernels' gate takes off rows 5-11: another
# block activation, no norm, another readout, other widths (a fresh init
# from its seed, as the JAX package's init_params gives it)
ARCH_CARD = {"activation": "gelu", "norm_layer": "none", "final_activation": "sigmoid",
             "n_filters": [256, 512, 512], "seed": 12}
# the kernels of the path the JAX gate sends such a detector: the first
# slice's round trip, one launch each an iteration, the detector in plain torch
FIRST_SLICE = ("synth_norm_fwd", "synth_norm_bwd", "band_analysis_fwd", "band_analysis_bwd")
VALUE_ATOL, VALUE_RTOL = 1e-4, 1e-3  # detection values, tests/test_parallel.py's
TRAIN_TOL = 1e-4  # the training metrics, relative (tests/test_torch_train.py's)


def _values_diff(a, b) -> tuple[float, bool, int]:
    """(max |a - b|, within VALUE_ATOL + VALUE_RTOL |b|, sign flips)."""
    a, b = a.float().cpu(), b.float().cpu()
    gap = (a - b).abs()
    return (float(gap.max()), bool((gap <= VALUE_ATOL + VALUE_RTOL * b.abs()).all()),
            int(((a > 0) != (b > 0)).sum()))


def multi_device(torch, kernels, emb, det, clips, bits, long_out, long_bits, hour, smi,
                 seed) -> None:
    """Phase 12: the parallel package in an NCCL world of one on cuda:0
    (NCCL takes one rank a device: the ranks' exchange is the CPU tests'),
    then one detector of another architecture (module docstring)."""
    import tempfile

    import torch.distributed as dist
    import yaml

    from aware_tpu_torch import load
    from aware_tpu_torch.embed.solver import build_problem, embed_batch
    from aware_tpu_torch.models.detector import detect_values, detect_values_batch
    from aware_tpu_torch.models.detector import load_key_params
    from aware_tpu_torch.parallel import (
        get_mesh,
        sharded_detect_batch,
        sharded_embed_batch,
        streaming_detect_values,
    )
    from aware_tpu_torch.service.streaming import StreamingDetector
    from aware_tpu_torch.train import adversarial as adv

    t_phase = time.perf_counter()
    cfg = emb.cfg
    sr = cfg.detection_net.sample_rate
    dev = torch.device("cuda", 0)
    det_kw = dict(hop_length=cfg.hop_length, window=cfg.window, win_length=cfg.win_length,
                  embedding_bands=cfg.embedding_bands, precision=cfg.matmul_precision)
    wm = (2.0 * bits - 1.0).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0)
        try:
            data, seq = get_mesh(("data",)), get_mesh(("seq",))
            say(f"phase 12 world: {dist.get_world_size()} rank, {dist.get_backend()}; {data}, "
                f"{seq} ({smi})")
            if data.shape != {"data": 1} or seq.shape != {"seq": 1} or data.device != dev:
                raise RuntimeError(f"the meshes of a world of one: {data}, {seq}")

            # (a) the sharded embed of phase 3's clips, and embed_batch's
            res, wall, launched = _counted(
                torch, kernels, lambda: sharded_embed_batch(det.net, clips, wm, cfg, data))
            values = sharded_detect_batch(det.net, res.audio, cfg, data)
            ber = ((values.cpu().numpy() > 0) != bits).mean(axis=1) * 100.0
            ref = embed_batch(det.net, torch.as_tensor(clips, device=dev),
                              torch.as_tensor(wm, device=dev), cfg)
            audio_diff = float((res.audio - ref.audio).abs().max())
            say(f"phase 12 sharded_embed_batch, B={BATCH} x {clips.shape[1] / sr:g} s x "
                f"{cfg.num_iterations}: {wall:.3f} s, launches {launched}, BER % per lane "
                f"{ber.tolist()}, max |audio - embed_batch's| {audio_diff:.3e} ({smi})")
            if launched != {"iteration_step": cfg.num_iterations} or ber.any():
                raise RuntimeError("the sharded embed: its launches or a lane's bits")
            if audio_diff > 1e-5 or not torch.isfinite(res.audio).all():
                raise RuntimeError("the sharded embed departs from embed_batch")
            # (b) the sharded detect against detect_values_batch
            plain = detect_values_batch(det.net, res.audio, **det_kw)
            diff, close, flips = _values_diff(values, plain)
            say(f"phase 12 sharded_detect_batch vs detect_values_batch: max |diff| {diff:.3e}, "
                f"sign flips {flips}")
            if not close or flips:
                raise RuntimeError("the sharded detect departs from detect_values_batch")

            # (c) detect_global of phase 5's first 60 s embed (its first
            # collective sets up the NCCL communicator)
            t0 = time.perf_counter()
            got = StreamingDetector(det, mesh=seq, threshold=0.1).detect_global(long_out[0], sr)
            ber = float(np.mean(np.asarray(got) != long_bits[0]) * 100.0)
            say(f"phase 12 detect_global of a 60 s embed: BER {ber} %, "
                f"{time.perf_counter() - t0:.3f} s")
            if ber:
                raise RuntimeError("detect_global did not read the 60 s embed's bits")

            # (d) sequence-parallel detection of phase 10's hour against
            # one detect_values of it
            readings = {}
            for label, run in (
                ("streaming_detect_values", lambda: streaming_detect_values(det.net, hour, cfg, seq)),
                ("detect_values", lambda: detect_values(
                    det.net, torch.as_tensor(hour, device=dev), **det_kw)),
            ):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                readings[label] = (out, time.perf_counter() - t0,
                                   (torch.cuda.max_memory_allocated() - base) / 2**20)
            (sp, sp_s, sp_mib), (one, one_s, one_mib) = readings.values()
            diff, close, flips = _values_diff(sp, one)
            say(f"phase 12 hour ({len(hour)} samples): streaming_detect_values {sp_s:.3f} s, peak "
                f"{sp_mib:.1f} MiB above the start; detect_values {one_s:.3f} s, {one_mib:.1f} "
                f"MiB; max |diff| {diff:.3e} (atol {VALUE_ATOL}, rtol {VALUE_RTOL}), sign flips "
                f"{flips} ({smi})")
            if not close or sp.shape != (cfg.detection_net.output_length,):
                raise RuntimeError("sequence-parallel detection departs from detect_values")

            # (e) two training steps with the batch over data, and unsharded
            tcfg = adv.TrainConfig(batch_size=BATCH, steps=2)
            short = clips[:, : 2 * sr]
            runs, walls = {}, {"sharded": [], "unsharded": []}
            for label in ("sharded", "unsharded", "unsharded", "sharded"):  # in turns
                kw = {"mesh": data} if label == "sharded" else {"device": dev}
                t0 = time.perf_counter()
                runs[label] = adv.train_amortized_embedder(cfg, tcfg, load_key_params(),
                                                           lambda i: short, seed=seed, **kw)
                torch.cuda.synchronize()
                walls[label].append(f"{time.perf_counter() - t0:.3f}")
            (s1, h1), (s0, h0) = runs["sharded"], runs["unsharded"]
            hist = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(h1, h0) for k in b)
            params = max(float((s1.e_params[k] - s0.e_params[k]).abs().max()) for k in s0.e_params)
            say(f"phase 12 training, B={BATCH} x 2 s x 2 steps, in turns: sharded "
                f"{' / '.join(walls['sharded'])} s, unsharded {' / '.join(walls['unsharded'])} s; "
                f"max relative |history diff| {hist:.3e}, max |embedder diff| {params:.3e} "
                f"(learning rate {tcfg.learning_rate})")
            if hist > TRAIN_TOL or params > 0.05 * tcfg.learning_rate:
                raise RuntimeError("the sharded training steps depart from the unsharded ones")
        finally:
            dist.destroy_process_group()

        # (f) a detector of another architecture, from a card file
        card = f"{tmp}/arch.yaml"
        with open(card, "w") as f:
            yaml.safe_dump({"detection_net_cfg": ARCH_CARD}, f)
        e_a, d_a = load(card, device=dev)
        _, d_cpu = load(card, device="cpu")
    x = torch.as_tensor(clips, device=dev)
    path = build_problem(d_a.net, x, torch.as_tensor(wm, device=dev), e_a.cfg).path
    label = f"detector {ARCH_CARD} ({path})"
    run = embed_and_read(torch, kernels, label, e_a, d_a, clips, bits, phase="12")
    check_launches(label, run["launches"], dict.fromkeys(FIRST_SLICE, 1), e_a.cfg.num_iterations)
    if path != "band_analysis":
        raise RuntimeError(f"{label}: not the first slice's path")
    pair = torch.as_tensor(clips[:2, : 2 * sr])
    wm2 = torch.as_tensor(wm[:2])
    ten = e_a.cfg.replace(num_iterations=10)
    res_k = embed_batch(d_a.net, pair.to(dev), wm2.to(dev), ten)
    res_p = embed_batch(d_cpu.net, pair, wm2, ten)
    dloss = float((res_k.best_loss.cpu() - res_p.best_loss).abs().max())
    say(f"phase 12 reference, {label}: 10-iteration best_loss card vs CPU plain |diff| "
        f"{dloss:.3e}; its BER (a reading: a sigmoid readout reads every bit as 1) "
        f"{run['ber'].mean():.2f} %")
    if not dloss < 0.02:
        raise RuntimeError(f"{label}: the card's solve departs from the plain solve")
    say(f"phase 12: {time.perf_counter() - t_phase:.1f} s ({smi})")


# ---- phase 13: the host codecs, the voice card, the extended eval
VOICE_CLIPS = 2       # of phase 3's 8 clips: the real codecs cost about 44 s of host a lane
PLUMBING_ITERS = 20   # the straight-through view's plumbing run, where the codecs are absent
VOICE_READINGS = (("opus_8k", "opus", 8000), ("opus_16k", "opus", 16000), ("gsm_fr", "gsm", 0))
EVAL_KEEP_ZERO = ("clean_ber", "ber:pcm_16", "ber:pcm_24")


def host_libraries() -> dict:
    """Which host libraries load on this machine: name -> "yes" or the cause."""
    from aware_tpu_torch.attacks import av_codecs, mp3_real, soxr_real
    from aware_tpu_torch.attacks import voice_codecs as vc

    def no(lib):
        return f"no ({lib} does not load)"

    reason = av_codecs.avc_unavailable_reason()
    return {
        "libopus": "yes" if vc.opus_available() else no("libopus.so.0"),
        "libgsm": "yes" if vc.gsm_available() else no("libgsm.so.1"),
        "libsoxr": "yes" if soxr_real.soxr_available() else no("libsoxr.so.0"),
        "libmp3lame + libmpg123": "yes" if mp3_real.available() else no("libmp3lame.so.0 "
                                                                          "or libmpg123.so.0"),
        "libavcodec (the shim, g++ with its headers)": "yes" if not reason else f"no ({reason})",
    }


def _view_times() -> str:
    from aware_tpu_torch.embed.solver import HOST_VIEW_TIMES as t

    return (f"{t.calls} view calls, {t.lanes} lanes: host function {t.host_s:.3f} s, copies "
            f"{t.copy_s:.3f} s, waiting for the device before the copy out {t.wait_s:.3f} s")


def voice_card(torch, kernels, clips, bits, default_out, det_default) -> None:
    """Phase 13 where libopus and libgsm load: load("voice") on VOICE_CLIPS
    of the phase 3 clips at full width (module docstring)."""
    from aware_tpu_torch import detect_watermark_batch, load
    from aware_tpu_torch.attacks import voice_codecs as vc
    from aware_tpu_torch.embed import solver

    dev = det_default.device
    sr = det_default.cfg.detection_net.sample_rate
    pair, pair_bits = clips[:VOICE_CLIPS], bits[:VOICE_CLIPS]
    e, d = load("voice", device=dev)
    wm = torch.as_tensor(2.0 * pair_bits - 1.0, dtype=torch.float32, device=dev)
    path = solver.build_problem(d.net, torch.as_tensor(pair, device=dev), wm, e.cfg).path
    if path != "analysis_detector":
        raise RuntimeError(f'load("voice") took the {path} path, not analysis_detector')
    solver.HOST_VIEW_TIMES.reset()
    run = embed_and_read(torch, kernels, f'voice card (load("voice"), {path}, views '
                         f'{list(solver.eot_views(e.cfg))})', e, d, pair, pair_bits, phase="13")
    say(f"phase 13 voice card embed {run['embed_s']:.3f} s: {_view_times()}")
    if run["ber"].any():
        raise RuntimeError("voice card: a lane did not read back its message")
    check_launches("voice card", run["launches"], dict.fromkeys(TWO_KERNEL, 1),
                   e.cfg.num_iterations)
    readings = []
    for name, codec, bps in VOICE_READINGS:
        for label, out, det in (("voice", run["out"], d),
                                ("default", default_out[:VOICE_CLIPS], det_default)):
            coded = np.stack([vc.opus_roundtrip(a, sr, bps) if codec == "opus"
                              else vc.gsm_roundtrip(a, sr) for a in out])
            ber = np.mean(detect_watermark_batch(coded, sr, det) != pair_bits) * 100.0
            readings.append(f"{name} {label} {ber:.2f}")
    say("phase 13 BER % after the real codecs (readings), voice card vs phase 3's default-card "
        "embeds of the same clips: " + "; ".join(readings))


def voice_plumbing(torch, kernels, clips, bits, det_default, missing) -> None:
    """Phase 13 where libopus or libgsm is absent: load("voice") must raise
    the RuntimeError that names the library, then the straight-through
    view on the card with the scipy 8 kHz resample leg of gsm_roundtrip
    (no codec) as its host function: the plumbing, not the card."""
    import yaml

    from aware_tpu_torch import load
    from aware_tpu_torch.attacks import voice_codecs as vc
    from aware_tpu_torch.config import AwareConfig
    from aware_tpu_torch.embed import solver
    from aware_tpu_torch.service.api import CARDS_DIR

    say(f"phase 13 the voice card cannot run on this machine: {', '.join(missing)} "
        "does not load")
    try:
        load("voice", device=det_default.device)
    except RuntimeError as err:
        if not all(lib in str(err) for lib in missing):
            raise RuntimeError(f'load("voice") raised without naming {missing}: {err}') from err
        say(f'phase 13 load("voice") raises RuntimeError: {err}')
    else:
        raise RuntimeError(f'load("voice") loaded without {missing}')

    dev = det_default.device
    cfg = AwareConfig.from_dict(yaml.safe_load((CARDS_DIR / "voice.yaml").read_text()))
    cfg = cfg.replace(num_iterations=PLUMBING_ITERS)
    if cfg.detection_net != det_default.cfg.detection_net:
        raise RuntimeError("the voice card's detector is not the default card's")

    def resample_leg(name, sr):
        def leg(a):
            return vc._align(vc.gsm_resample(vc.gsm_resample(a, sr, 8000), 8000, sr), a)
        return leg

    pair = torch.as_tensor(clips[:VOICE_CLIPS], device=dev)
    wm = torch.as_tensor(2.0 * bits[:VOICE_CLIPS] - 1.0, dtype=torch.float32, device=dev)
    saved = solver.ste_codec
    solver.ste_codec = resample_leg
    try:
        pb = solver.build_problem(det_default.net, pair, wm, cfg)
        if pb.path != "analysis_detector":
            raise RuntimeError(f"the plumbing run took the {pb.path} path")
        for k in kernels:
            k.launches = 0
        solver.HOST_VIEW_TIMES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, best_loss, _ = solver.solve(pb, det_default.net, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        solver.ste_codec = saved
    launches = {k.__name__: k.launches for k in kernels}
    say(f"phase 13 PLUMBING, NOT THE VOICE CARD: the straight-through view on the card with "
        f"the scipy 8 kHz resample leg of gsm_roundtrip (no codec) as its host function, "
        f"views {list(solver.eot_views(cfg))}, B={VOICE_CLIPS} x "
        f"{clips.shape[1] / cfg.detection_net.sample_rate:g} s x "
        f"{PLUMBING_ITERS} iterations: solve {wall:.3f} s, best_loss "
        f"{best_loss.cpu().tolist()}; {_view_times()}; launches {launches}")
    check_launches("plumbing", launches, dict.fromkeys(TWO_KERNEL, 1), PLUMBING_ITERS)
    if not torch.isfinite(best_loss).all():
        raise RuntimeError("plumbing: the best loss is not finite")
    if solver.HOST_VIEW_TIMES.calls != PLUMBING_ITERS:
        raise RuntimeError(f"plumbing: {solver.HOST_VIEW_TIMES.calls} view calls, "
                           f"not {PLUMBING_ITERS}")


def extended_eval(torch, turbo) -> None:
    """Phase 13's extended eval: run_robustness_eval with extended_attack_suite
    on the phase 8 turbo model and fixtures (module docstring)."""
    from aware_tpu_torch.attacks.voice_codecs import (
        extended_attack_suite,
        extended_rows_left_out,
    )
    from aware_tpu_torch.eval import run_robustness_eval

    suite = extended_attack_suite()
    left_out = extended_rows_left_out()
    say(f"phase 13 extended suite: {len(suite)} rows run: {[a.name for a in suite]}")
    say("phase 13 extended suite, rows left out: " + (
        "; ".join(f"{name}: {why}" for name, why in left_out) or "none"))
    spent = [0.0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_robustness_eval(n_clips=EVAL_CLIPS, seed=0, model=turbo,
                                  attacks=[_Timed(a, spent) for a in suite])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    say(f"phase 13 extended eval, turbo card, {EVAL_CLIPS} clips x {len(suite)} attacks: wall "
        f"{wall:.3f} s, attacks {spent[0]:.3f} s ({100 * spent[0] / wall:.1f} %)")
    say("phase 13 extended eval results: " + json.dumps(results))
    keys = {f"ber:{a.name}" for a in suite} | set(EVAL_KEEP_ZERO)
    missing = keys - set(results)
    if missing or not all(np.isfinite(results[k]) for k in keys):
        raise RuntimeError(f"extended eval: rows missing {sorted(missing)} or not finite")
    if any(results[k] != 0.0 for k in EVAL_KEEP_ZERO):
        raise RuntimeError(f"extended eval: {EVAL_KEEP_ZERO} not all 0")


def host_codecs(torch, kernels, clips, bits, default_out, det, turbo, smi) -> None:
    """Phase 13: the host libraries, the voice card (or, without its
    codecs, the refusal and the plumbing run), the extended eval."""
    t_phase = time.perf_counter()
    libs = host_libraries()
    say("phase 13 host libraries: " + "; ".join(f"{k}: {v}" for k, v in libs.items()))
    missing = [lib for lib in ("libopus", "libgsm") if libs[lib] != "yes"]
    if missing:
        voice_plumbing(torch, kernels, clips, bits, det, missing)
    else:
        voice_card(torch, kernels, clips, bits, default_out, det)
    extended_eval(torch, turbo)
    say(f"phase 13: {time.perf_counter() - t_phase:.1f} s ({smi})")


class PhaseClock:
    """Each phase's wall seconds, on a line of its own as the phase ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        say(f"phase {phase} wall {now - self.t:.1f} s")
        self.t = now


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 0-2 and the filter checks of 8, one launch each")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="a directory for the Chrome traces of the phase 3 profiles")
    ap.add_argument("--reference-lib", default=None,
                    help="another build of the kernel library (a shared library path), whose "
                    "aw_iteration_step, aw_iteration_fwd_sm90 and aw_iteration_bwd must give the "
                    "same bits in phase 2")
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
    from aware_tpu_torch.ops.kernels import iir as ki
    from aware_tpu_torch.ops.kernels import iteration as it
    from aware_tpu_torch.ops.kernels import ola_norm as on
    from aware_tpu_torch.ops.kernels import roundtrip as rt
    from aware_tpu_torch.ops.kernels import roundtrip_tiled as rtt
    from aware_tpu_torch.ops.kernels.build import build

    kernels = (rt.KERNELS + td.KERNELS + tad.KERNELS + it.KERNELS + rtt.KERNELS + on.KERNELS
               + ki.KERNELS)
    t_start = time.perf_counter()
    clock = PhaseClock()
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
        if any(k in line for k in ("registers", "Compiling entry", "spill", "(C75")):
            say("  " + line.strip())
    sm90_report(torch, b)
    ola_report(torch, b)
    clock.lap("0-1")

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
    records = check_kernels(torch, pb, cfg.hop_length, rng,
                            np.random.default_rng([args.seed, 11]), args.quick,
                            args.reference_lib)
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
    clock.lap("2")

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
        default_out = default_s = None
        for label, e, d, names in paths:
            out, embed_s = solve_path(torch, kernels, label, e, d, clips, bits,
                                      dict.fromkeys(names, 1), records)
            if default_out is None:
                default_out, default_s = out, embed_s
        # the default, two-kernel and weight-decay paths again, in turns (a
        # later solve finds the process warm), then reversed
        turns = []
        for label, e, _, _ in (paths[0], paths[1], paths[3], paths[3], paths[1], paths[0]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            embed_watermark_batch(clips, sr, bits, e)
            torch.cuda.synchronize()
            turns.append(f"{label} {time.perf_counter() - t0:.3f} s")
        say("phase 3 in turns, embed of B=8 x 10 s x 400 iterations: " + "; ".join(turns))

        clock.lap("3 (the four paths, in turns)")
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
        clock.lap("3 (the card-vs-CPU reference solves)")

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

        clock.lap("3 (profiles, the no-sync loop)")
        # ---- phase 3s: short clips on every path
        short_clips(torch, paths, det_cpu, rng)
        clock.lap("3s")

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
        clock.lap("4")

        # ---- phase 5: long clips, the tiled path
        long_out, _ = solve_path(torch, kernels, "long clips (tiled path)", emb, det, long_clips,
                                 long_bits, {"shift_mm": 3, "synth_tiled_fwd": 1}, records,
                                 phase="5")
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
        clock.lap("5")

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
            if path == "ola":  # every launch of the 10 s clips a cluster launch
                by = {k.__name__: dict(k.variants) for k in on.KERNELS}
                say(f"phase 6 {label}: launches by variant {by}")
                want = {"cluster": e.cfg.num_iterations, "stream": 0}
                if any(v != want for v in by.values()):
                    raise RuntimeError(f"{label}: launches by variant {by}, not {want} each")
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
            torch, lambda: embed_batch(d.net, x, wm, prof_cfg), trace, markers=("ola_",),
            show=("ola_",)))
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
        clock.lap("6")

        # ---- phase 7: the EOT cards
        eot_cards(torch, kernels, clips, bits, default_out, det, det_cpu, records,
                  f"{args.trace}/trace_robust.json" if args.trace else None)
        clock.lap("7")

    # ---- phase 8: the filter kernels, the turbo card and the eval
    records.update(filter_checks(torch, np.random.default_rng([args.seed, 8]), args.quick))
    if not args.quick:
        turbo, plain_eval, plain_wall = turbo_and_eval(torch, kernels, clips, bits, default_s,
                                                       records)
        clock.lap("8")
        # ---- phase 9: every solver mode, and the host runtime
        solver_modes(torch, kernels, clips, bits, det_cpu)
        clock.lap("9")
        # ---- phase 10: the payload and long-form services, the command line
        hour = services(torch, kernels, emb, det, clips, default_out, bits, turbo, plain_eval,
                        plain_wall, smi, args.seed)
        clock.lap("10")
        # ---- phase 11: the frame geometries and the amortized embedder
        geometries_and_amortized(torch, kernels, records, emb, det, clips, bits, smi, args.seed)
        clock.lap("11")
        # ---- phase 12: the multi-device path, a detector of another architecture
        multi_device(torch, kernels, emb, det, clips, bits, long_out, long_bits, hour, smi,
                     args.seed)
        clock.lap("12")
        # ---- phase 13: the host codecs, the voice card, the extended eval
        host_codecs(torch, kernels, clips, bits, default_out, det, turbo, smi)
        clock.lap("13")
        for name, rec in records.items():
            if rec["launches"] < 1:
                raise RuntimeError(f"kernel {name} was not launched on any path")
    return finish(torch, t_start, records, smi, kind)


def finish(torch, t_start, records, smi, kind) -> int:
    """The last three lines: the kernel records, nvidia-smi's line, the result."""
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
