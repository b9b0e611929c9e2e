// The whole solver step for Hopper (sm_90a) on TMA and wgmma: the port's
// aw_iteration_step, and its halves alone as aw_iteration_fwd_sm90 and
// aw_iteration_bwd.
//
//   aw_iteration_step     <- aware_tpu/ops/pallas/iteration.py iteration_step
//                            (pallas_call :513, _step_kernel :341)
//   aw_iteration_fwd_sm90 <- the iteration_forward forward (pallas_call :173,
//                            _iter_fwd_kernel :72): the step's forward half
//   aw_iteration_bwd      <- the iteration_forward VJP (pallas_call :285,
//                            _iter_bwd_kernel :193): the step's backward half
//                            from a given g, then the phase fold
//
// It computes what the first chain, aw_iteration_step_wmma (iteration.cu,
// which says what a step is), computes, with the same pointer table, the
// same in-place updates and the same scratch left behind (dreim in big,
// the folded gy2, the peak-norm VJP's scalars, the residuals), plus three
// buffers of its own (StepOps).  The WMMA chain measured 2.95 ms a step on
// an H100 at B = 8, T = 626 (PERF.md), 75x the 0.040 ms its 39.5 GFLOP
// take at the bf16 peak: its 14 GEMMs ran on the unpipelined WMMA
// template, whose A loaders computed their operands element by element,
// and three per-clip reductions ran one block per clip (8 blocks on 132
// SMs; fold_scalars alone 0.10 ms).  Here:
//
//   * every GEMM runs on wgmma with TMA-fed operands and two-level sums
//     (the tensor cores sum one depth chunk from zero, f32 adds carry the
//     chunks): the four round-trip products (synthesis, reflect analysis,
//     its VJP, synthesis VJP) on slab_gemm_sm90.cuh with an epilogue
//     functor each, the detector's ten on dense_gemm_sm90.cuh;
//   * each A operand is written to memory by the pass before its product,
//     so that the products only load: the round trip's in f32 (reim =
//     ct csin; the reflect-padded y2 = u / cden, so that the analysis reads
//     padded rows with no reflection; gcrop = the peak-norm VJP / env), the
//     detector's in bf16 (|cs| beside the nph residual; the pool's input
//     from the mel norm; leaky(yhat) from in_norm_fwd; dh from
//     in_norm_bwd_stats; the mel VJP's from its statistics), each the
//     f32 expression the WMMA loader computes, rounded the same way, so the
//     products see the bits they saw there;
//   * the per-clip reductions (the mel norm, the mel VJP's statistics, the
//     reflect fold and the peak-norm VJP's scalars) run over (row chunk,
//     clip) blocks, each writing its partial sums, and the next launch
//     finishes them in one fixed order (every block of a clip the same
//     floats), as ola_norm.cu does: no float atomics, so a repeated launch
//     gives the same bits;
//   * tiles are planned per call by the wrapper (ops/kernels/iteration.py)
//     and passed in `tiles`; nothing is allocated, nothing syncs with the
//     host, every launch goes to the caller's stream (the chain can be
//     captured in a CUDA graph).
//
// Launches (chip_smoke.py times each, beside its bound): reim; synthesis;
// reflect pad; analysis; |cs| and nph; mel; 5 mel-norm stages; 4 x (conv,
// in_norm_fwd); brh_fwd; brh_bwd; 4 x (in_norm_bwd_stats, conv VJP); 3 mel
// VJP statistics stages; mel VJP; analysis VJP; 2 fold and scalar stages;
// gcrop; synthesis VJP; nadam_fold; best_loss_update: 40.  The chain is
// two halves (step_fwd: 20 launches, step_bwd: 18) and the epilogue.
// aw_iteration_fwd_sm90 is step_fwd: 20 launches; its first chain,
// aw_iteration_fwd_wmma (iteration.cu, 13 launches on the WMMA template),
// measured 1.34 ms at B = 8, T = 626 (PERF.md), 67x its 0.020 ms bound.
// aw_iteration_bwd is step_bwd from g, reading only the residuals, then
// fold_phase: 19 launches; its first chain, aw_iteration_bwd_wmma
// (iteration.cu, 15 launches), measured 1.62 ms, 81x its 0.020 ms bound.
// Both halves' detector parts and reflect analyses are shared with the
// detector_fused and analysis_detector forwards and VJPs
// (detector_sm90.cuh), their synthesis stages with the synth_norm forward
// and VJP (roundtrip_sm90.cuh: reim and the synthesis slab; the fold and
// scalar stages, gcrop and the synthesis-VJP slab).

#include "detector_sm90.cuh"
#include "roundtrip_sm90.cuh"

namespace {

// The step's own buffers: a16 (B, max(T2 1024, T P)) bf16, the detector
// GEMMs' A operands in turn; rows (B, T+3, hop) f32, the reflect-padded
// y2, then gcrop (B, T-1, hop); part (B, kPartLd) f32, partial sums.
struct StepOps {
  bf16* a16;
  float* rows;
  float* part;
};

// ---------------------------------------------------------------- chain ---

// The forward half: ct (B, T, P) -> u (B, T-1, hop), m1 (B,), pred and
// the detector's residuals r, or the first CUDA error of a launch.  w:
// big, mel32, ha, hb, mu and small as scratch; o: all three.  tl: the
// FwdGemm tiles.  20 launches.
int step_fwd(const float* ct, const RoundConsts& c, const DetFwdConsts& dfc, const DetRes& r,
             float* u, float* m1, const IterScratch& w, const StepOps& o, const Tiles& tl,
             int batch, int t, int p, int hop, cudaStream_t st) {
  int err;

  // ---- the round trip forward
  AW_TRY(synth_fwd_sm90(ct, c.csin, c.ab, c.env, c.y_const, w.big, u, m1, tl.bm(gSynth),
                        tl.bn(gSynth), batch, t, p, hop, st));
  AW_TRY(reflect_analysis_fwd_sm90(u, m1, c.csw, o.rows, w.big, tl.bm(gAnalysis),
                                   tl.bn(gAnalysis), batch, t, 2 * p, hop, st));

  // ---- the detector forward, from cs2 in big
  return det_fwd_sm90(w.big, dfc, r, w, o.a16, o.part, Tiles{tl.bmbn + 2 * gMel}, batch, t, p,
                      st);
}

// The backward half: g (B, 128), or given wm the push_extremes gradient
// with the loss out, -> dreim (B, T, 2P) in w.big, or the first CUDA error
// of a launch: the detector's VJP (det_bwd_sm90, dcs into w.big), then the
// round trip's.  It reads only the forward's residuals (r, u, m1) and the
// constants: every StepOps buffer it reads, it has written itself
// (o.a16 by in_norm_bwd_stats and mel_bwd3, o.part by mel_bwd1 and
// fold_partial, o.rows by gcrop_pass).  tl: the BwdGemm tiles.  18
// launches.
int step_bwd(const float* g, const float* wm, float* loss, const DetRes& r, const float* u,
             const float* m1, const RoundConsts& c, const DetBwdConsts& dbc,
             const IterScratch& w, const StepOps& o, const Tiles& tl, int batch, int t, int p,
             int hop, cudaStream_t st) {
  const int p2 = 2 * p;
  int err;
  AW_TRY(det_bwd_sm90(g, wm, loss, r, dbc, w.big, w, o.a16, o.part, tl, batch, t, p, st));

  // ---- the round trip backward: the reflect analysis VJP, then the
  // synthesis's from the folded gy2 and u, gcrop in o.rows, dreim in w.big
  AW_TRY(reflect_analysis_bwd_sm90(w.big, c.cswt, w.gy2, w.gpad, tl.bm(gAnalysisVjp),
                                   tl.bn(gAnalysisVjp), batch, t, p2, hop, st));
  return synth_vjp_sm90<StepVjp>(w.gpad, w.gy2, u, m1, c.env, c.abt, o.part, w.scal, o.rows,
                                 w.big, tl.bm(gSynthVjp), tl.bn(gSynthVjp), batch, t, p2, hop,
                                 st);
}

// The step, or the first CUDA error of a launch: the forward half, the
// backward half with the loss, then NAdam, the clamp and the best
// snapshot, in place.  tl: the FwdGemm tiles, then the BwdGemm tiles.
int step_chain(const StepArgs& s, const StepOps& o, const Tiles& tl, int batch, int t, int p,
               int hop, NadamCoefs k, cudaStream_t st) {
  int err;
  AW_TRY(step_fwd(s.ct, s.c, s.dfc, s.r, s.u, s.m1, s.w, o, tl, batch, t, p, hop, st));
  AW_TRY(step_bwd(nullptr, s.wm, s.loss, s.r, s.u, s.m1, s.c, s.dbc, s.w, o,
                  Tiles{tl.bmbn + 2 * gFwdGemms}, batch, t, p, hop, st));
  launch_step_epilogue(s.w.big, s.c.csin, s.ct, s.m, s.v, s.best, s.best_loss, s.lower, s.upper,
                       s.loss, s.s1, s.s2, s.d2, k, batch, t, p, st);
  return (int)cudaGetLastError();
}

#undef AW_LAUNCHED
#undef AW_TRY

StepOps take_ops(Ptrs& a) {
  StepOps o;
  o.a16 = a.next<bf16>();
  o.rows = a.next<float>();
  o.part = a.next<float>();
  return o;
}

}  // namespace

extern "C" {

// ptrs (64): the 61 of StepArgs (iteration.cuh), then StepOps: a16 (B,
// max(T2 1024, T P)) bf16, rows (B, T+3, hop) f32, part (B, 4096) f32.
// tiles: (bm, bn) of each of the 14 GEMMs in launch order (FwdGemm, then
// BwdGemm), as the wrapper planned them.  c_m, b2, c_v, eps: NadamCoefs.
// Needs T >= 8 and (T-1) hop within the fold's partial sums' room.
int aw_iteration_step(void* const* ptrs, int n, const int* tiles, int n_tiles, int batch, int t,
                      int p, int hop, float c_m, float b2, float c_v, float eps, void* stream) {
  Ptrs a{ptrs, n, 0};
  const StepArgs s = take_step(a);
  const StepOps o = take_ops(a);
  if (!a.done() || n_tiles != 2 * (gFwdGemms + gBwdGemms) || t < kMinFrames ||
      !fold_fits(t, hop))
    return (int)cudaErrorInvalidValue;
  return step_chain(s, o, Tiles{tiles}, batch, t, p, hop, NadamCoefs{c_m, b2, c_v, eps},
                    (cudaStream_t)stream);
}

// The iteration_forward forward on the step's forward half: ptrs (45),
// the 42 of FwdArgs (iteration.cuh), then StepOps' 3 -> pred, the 16
// residuals, u and m1.  tiles: (bm, bn) of the 7 forward GEMMs (FwdGemm).
// Refuses T < 8 and a wrong length of either array, before any launch.
int aw_iteration_fwd_sm90(void* const* ptrs, int n, const int* tiles, int n_tiles, int batch,
                          int t, int p, int hop, void* stream) {
  Ptrs a{ptrs, n, 0};
  const FwdArgs s = take_fwd(a);
  const StepOps o = take_ops(a);
  if (!a.done() || n_tiles != 2 * gFwdGemms || t < kMinFrames) return (int)cudaErrorInvalidValue;
  return step_fwd(s.ct, s.c, s.dc, s.r, s.u, s.m1, s.w, o, Tiles{tiles}, batch, t, p, hop,
                  (cudaStream_t)stream);
}

// The iteration_forward VJP: ptrs (44), the 41 of BwdArgs (iteration.cuh),
// then StepOps' 3 -> dct (B, T, P) f32: the step's backward half from g,
// then the phase fold of its dreim.  tiles: (bm, bn) of the 7 backward
// GEMMs (BwdGemm).  Refuses what aw_iteration_step refuses, before any
// launch.
int aw_iteration_bwd(void* const* ptrs, int n, const int* tiles, int n_tiles, int batch, int t,
                     int p, int hop, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Ptrs a{ptrs, n, 0};
  const BwdArgs s = take_bwd(a);
  const StepOps o = take_ops(a);
  if (!a.done() || n_tiles != 2 * gBwdGemms || t < kMinFrames || !fold_fits(t, hop))
    return (int)cudaErrorInvalidValue;
  const int err = step_bwd(s.g, nullptr, nullptr, s.r, s.u, s.m1, s.c, s.dc, s.w, o,
                           Tiles{tiles}, batch, t, p, hop, st);
  if (err != 0) return err;
  const long long rows = (long long)batch * t;
  fold_phase<<<elementwise_blocks(rows * p), 256, 0, st>>>(s.w.big, s.c.csin, s.dct, rows, p);
  return (int)cudaGetLastError();
}

// One dense GEMM of the step's kind on given operands, with a plain f32
// store: a (m, k) bf16, b (k, n) bf16 -> out (m, n) f32 (the chip check
// holds each of the step's products against float64 this way).
int aw_dense_gemm(const bf16* a, const bf16* b, float* out, int m, int k, int n, int bm, int bn,
                  void* stream) {
  return sm90::launch_dense_gemm(a, b, m, k, n, sm90::DenseStore{out, n}, bm, bn,
                                 (cudaStream_t)stream);
}

// (dynamic shared memory bytes, threads, stages, registers a thread at
// entry) of a dense GEMM tile, for the build report; -1 for none.
int aw_dense_gemm_config(int bm, int bn, int* threads, int* stages, int* regs) {
  return sm90::dense_tile_config(bm, bn, threads, stages, regs);
}

}  // extern "C"
