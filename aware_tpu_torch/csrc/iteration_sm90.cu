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
// (detector_sm90.cuh).

#include "detector_sm90.cuh"

namespace {

constexpr int kFoldChunk = 4096;  // samples of a fold / scalar block

// The step's own buffers: a16 (B, max(T2 1024, T P)) bf16, the detector
// GEMMs' A operands in turn; rows (B, T+3, hop) f32, the reflect-padded
// y2, then gcrop (B, T-1, hop); part (B, kPartLd) f32, partial sums.
struct StepOps {
  bf16* a16;
  float* rows;
  float* part;
};

// ------------------------------------------------------------- passes ---

// reim = ct csin (B T rows of 2P, f32, SynthA's value); m1 = 0 for the
// synthesis's atomicMax.
__global__ void reim_pass(const float* ct, const bf16* csin, float* reim, float* m1,
                          long long rows, int p, int batch) {
  const long long total = rows * 2 * p;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / (2 * p);
    const int c = (int)(i % (2 * p));
    const int cc = c < p ? c : c - p;
    reim[i] = ct[row * p + cc] * __bfloat162float(csin[i]);
    if (i < batch) m1[i] = 0.f;
  }
}

// -------------------------- the reflect fold and the peak-norm VJP's scalars ---
//
// fold_scalars (iteration.cu) over (sample chunk, clip) blocks: stage 1
// folds the pad rows' cotangents into gy2 (each sample of a chunk gets at
// most one, as in reflect_fold_clip) and sums q = gy2 y2 and max |y2| of
// the chunk; stage 2 counts the chunk's ties at the clip's max; the gcrop
// pass finishes the scalars (block 0 of a clip writes them to scal) and
// writes the synthesis VJP's A.  Partials: part[3 k + {q, max, ties}].

struct FoldChunks {
  long long len;  // samples of a clip: lr hop
  int nch;
  __device__ long long lo() const { return blockIdx.x * (long long)kFoldChunk; }
  __device__ long long hi() const {
    return min(len, (long long)(blockIdx.x + 1) * kFoldChunk);
  }
};

__global__ void __launch_bounds__(kRedBlock)
fold_partial(const float* gpad, float* gy2, const float* u, const float* m1, float* part_all,
             FoldChunks ch, int hop) {
  __shared__ float sh[kRedBlock / 32];
  const int b = blockIdx.y;
  const long long half = (long long)kPad * hop;
  const float* gp = gpad + (long long)b * 2 * half;
  float* g = gy2 + b * ch.len;
  const float* y = u + b * ch.len;
  const float cden = peak_den(m1[b]);
  float q = 0.f, mx = 0.f;
  for (long long f = ch.lo() + threadIdx.x; f < ch.hi(); f += kRedBlock) {
    float gv = g[f];
    if (f >= 1 && f <= half) {
      gv += gp[half - f];
      g[f] = gv;
    } else if (f >= ch.len - 1 - half && f <= ch.len - 2) {
      gv += gp[half + (ch.len - 2 - f)];
      g[f] = gv;
    }
    const float yv = y[f] / cden;
    q += gv * yv;
    mx = fmaxf(mx, fabsf(yv));
  }
  q = block_reduce<false>(q, sh);
  mx = block_reduce<true>(mx, sh);
  if (threadIdx.x == 0) {
    float* part = part_all + (long long)b * kPartLd;
    part[3 * blockIdx.x] = q;
    part[3 * blockIdx.x + 1] = mx;
  }
}

__device__ float clip_max(const float* part, int nch) {
  float mx = 0.f;
  for (int k = 0; k < nch; ++k) mx = fmaxf(mx, part[3 * k + 1]);
  return mx;
}

__global__ void __launch_bounds__(kRedBlock)
ties_partial(const float* u, const float* m1, float* part_all, FoldChunks ch) {
  __shared__ float sh[kRedBlock / 32];
  const int b = blockIdx.y;
  float* part = part_all + (long long)b * kPartLd;
  const float mx = clip_max(part, ch.nch);
  const float cden = peak_den(m1[b]);
  const float* y = u + b * ch.len;
  float ties = 0.f;
  for (long long f = ch.lo() + threadIdx.x; f < ch.hi(); f += kRedBlock)
    ties += fabsf(y[f] / cden) == mx;
  ties = block_reduce<false>(ties, sh);
  if (threadIdx.x == 0) part[3 * blockIdx.x + 2] = ties;
}

// gcrop = g_u / env (B, lr, hop), SynthBwdA's value, from the folded gy2,
// u and the scalars sc = (cden, q (1+e) / cden, max |y2|, ties).
__global__ void __launch_bounds__(kRedBlock)
gcrop_pass(const float* gy2, const float* u, const float* m1, const float* env,
           const float* part_all, float* scal, float* gcrop, FoldChunks ch) {
  const int b = blockIdx.y;
  const float* part = part_all + (long long)b * kPartLd;
  float q = 0.f, ties = 0.f;
  for (int k = 0; k < ch.nch; ++k) {
    q += part[3 * k];
    ties += part[3 * k + 2];
  }
  const float cden = peak_den(m1[b]);
  const float sc[4] = {cden, q * (1.f + kEps) / cden, clip_max(part, ch.nch), ties};
  if (blockIdx.x == 0 && threadIdx.x < 4) scal[4 * b + threadIdx.x] = sc[threadIdx.x];
  const long long off = b * ch.len;
  for (long long f = ch.lo() + threadIdx.x; f < ch.hi(); f += kRedBlock) {
    const float yv = u[off + f] / sc[0];
    const float mask = fabsf(yv) == sc[2] ? 1.f : 0.f;
    const float sgn = (float)((yv > 0.f) - (yv < 0.f));
    const float gu = gy2[off + f] / sc[0] - sc[1] * sgn * mask / sc[3];
    gcrop[off + f] = gu / env[f];
  }
}

// ---------------------------------------------------------------- chain ---

// The (T-1) hop samples of a clip fit the fold's partial sums.
bool fold_fits(int t, int hop) {
  return (long long)(t - 1) * hop <= (long long)kFoldChunk * (kPartLd / 3);
}

// The forward half: ct (B, T, P) -> u (B, T-1, hop), m1 (B,), pred and
// the detector's residuals r, or the first CUDA error of a launch.  w:
// big, mel32, ha, hb, mu and small as scratch; o: all three.  tl: the
// FwdGemm tiles.  20 launches.
int step_fwd(const float* ct, const RoundConsts& c, const DetFwdConsts& dfc, const DetRes& r,
             float* u, float* m1, const IterScratch& w, const StepOps& o, const Tiles& tl,
             int batch, int t, int p, int hop, cudaStream_t st) {
  const int lr = t - 1, p2 = 2 * p;
  int err;

  // ---- the round trip forward
  const long long rows_t = (long long)batch * t;
  reim_pass<<<elementwise_blocks(rows_t * p2), 256, 0, st>>>(ct, c.csin, w.big, m1, rows_t, p,
                                                             batch);
  AW_LAUNCHED();
  AW_TRY(sm90::launch_slab_gemm(
      sm90::Problem{w.big, batch, t, c.ab, p2, 4 * hop,
                    sm90::Params{lr, hop, p2, /*k_row=*/0, /*k_col=*/hop, /*dir=*/-1, /*pad=*/kPad}},
      sm90::SlabSynthEpi{u, c.env, c.y_const, (unsigned int*)m1, lr, hop}, tl.bm(gSynth),
      tl.bn(gSynth), st));
  AW_TRY(reflect_analysis_fwd_sm90(u, m1, c.csw, o.rows, w.big, tl.bm(gAnalysis),
                                   tl.bn(gAnalysis), batch, t, p2, hop, st));

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
  const int lr = t - 1, p2 = 2 * p;
  int err;
  AW_TRY(det_bwd_sm90(g, wm, loss, r, dbc, w.big, w, o.a16, o.part, tl, batch, t, p, st));

  // ---- the round trip backward
  AW_TRY(reflect_analysis_bwd_sm90(w.big, c.cswt, w.gy2, w.gpad, tl.bm(gAnalysisVjp),
                                   tl.bn(gAnalysisVjp), batch, t, p2, hop, st));
  const FoldChunks fc{(long long)lr * hop, (int)(((long long)lr * hop + kFoldChunk - 1) / kFoldChunk)};
  const dim3 fold_grid(fc.nch, batch);
  fold_partial<<<fold_grid, kRedBlock, 0, st>>>(w.gpad, w.gy2, u, m1, o.part, fc, hop);
  ties_partial<<<fold_grid, kRedBlock, 0, st>>>(u, m1, o.part, fc);
  gcrop_pass<<<fold_grid, kRedBlock, 0, st>>>(w.gy2, u, m1, c.env, o.part, w.scal, o.rows, fc);
  AW_LAUNCHED();
  AW_TRY(sm90::launch_slab_gemm(
      sm90::Problem{o.rows, batch, lr, c.abt, 4 * hop, p2,
                    sm90::Params{t, p2, hop, /*k_row=*/hop, /*k_col=*/0, /*dir=*/+1, /*pad=*/kPad}},
      w.big, tl.bm(gSynthVjp), tl.bn(gSynthVjp), st));
  return (int)cudaGetLastError();
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
