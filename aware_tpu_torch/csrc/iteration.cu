// The whole-iteration kernels of the embed solver, for Hopper (sm_90a).
//
// They replace the three Pallas TPU kernels of aware_tpu/ops/pallas/iteration.py:
//
//   aw_iteration_fwd  <- iteration_forward forward (_iter_fwd_impl :173,
//                        _iter_fwd_kernel :72): in iteration_sm90.cu, the
//                        forward half of the sm90 step,
//                        aw_iteration_fwd_sm90; its first chain stays here
//                        as aw_iteration_fwd_wmma
//   aw_iteration_bwd  <- iteration_forward VJP (_iter_bwd_impl :285,
//                        _iter_bwd_kernel :193): in iteration_sm90.cu, the
//                        backward half of the sm90 step; its first chain
//                        stays here as aw_iteration_bwd_wmma
//   aw_iteration_step <- iteration_step (pallas_call :513, _step_kernel :341):
//                        in iteration_sm90.cu, on TMA + wgmma; its first
//                        chain stays here as aw_iteration_step_wmma
//
// What they compute, per clip b (T frames, P = 256 padded band bins, hop
// samples per row, lr = T - 1 rows, R = 4 slabs):
//
//   fwd:  ct (T, P) f32 -> u = synthesis (roundtrip.cu's synth_norm before
//         its peak-norm) (lr, hop), m1 = max |u|, y2 = u / (m1 (1+1e-8) +
//         1e-16) -> reflect-pad slab analysis cs2 (T, 2P) -> the fused
//         detector (detector.cuh) -> pred (128,) and its 16 residuals; u and
//         m1 are kept for the backward (y2 is never written: every kernel
//         that needs it divides u by the same denominator, the same float);
//   bwd:  g (128,) -> the detector VJP -> dcs (T, 2P) -> the transposed
//         analysis slabs with the reflect-pad routing -> gy2 (lr, hop) ->
//         the peak-norm VJP (equal-tie split of the max) / env -> the
//         transposed synthesis slabs -> dreim (T, 2P) -> the phase fold
//         dct = dreim_re csin_re + dreim_im csin_im (T, P);
//   step: fwd; the push_extremes loss of the 20 message lanes and its
//         gradient on pred, in the kernel that starts the backward; bwd;
//         then, in the phase fold's epilogue, torch's NAdam step with the
//         per-clip coefficients s1, s2 and the shared d2 computed outside
//         from the mu-product recursion, the clamp to [lower, upper] and the
//         best snapshot (best = new ct where loss < best_loss), on ct, m, v
//         and best in place; a last tiny kernel updates best_loss after every
//         element has read it.  The loss is the pre-step ct's, the snapshot
//         the post-clamp new ct, as in the Pallas kernel.
//
// The Pallas programs hold a clip in 64-100 MB of VMEM; an SM has 227 KB of
// shared memory, so here each direction stays a chain of launches through
// device memory, on the caller's stream, with nothing allocated:
//
//   fwd  (13 launches + 1 memset, aw_iteration_fwd_wmma): memset m1; the
//        synthesis GEMM with the per-clip atomicMax of |u| into m1's bits;
//        the reflect-pad analysis GEMM, whose loader forms y2 = u / cden
//        as it stages it (no peak_scale pass, no y2 in memory); the 11
//        launches of the detector forward;
//   bwd  (15 launches, aw_iteration_bwd_wmma): the 11 of the detector
//        backward; the transposed analysis GEMM (pad rows' cotangents to a
//        small scratch); ONE per-clip kernel that folds the pad rows into
//        the six boundary rows and then reduces q = sum gy2 y2, max |y2|
//        and its ties (two launches in the two-kernel chain); the
//        synthesis-VJP GEMM; the phase fold;
//   step (29 launches + 1 memset, aw_iteration_step_wmma): fwd, bwd with
//        the loss in brh_bwd, and the NAdam epilogue in place of the phase
//        fold, then best_loss.
//
// Bounds at the main path's shapes (B = 8, T = 626): each direction is the
// synthesis GEMM (5.3 GFLOP) plus the analysis and detector GEMMs (14.4
// GFLOP), about 19.7 GFLOP, 0.020 ms at the bf16 peak; the step is both,
// 39.5 GFLOP, 0.040 ms.  The device code is shared with the two-kernel
// chain (roundtrip.cuh, analysis_detector.cuh, detector.cuh, iteration.cuh);
// its times are in PERF.md.
//
// Each entry takes a host array of the device pointers in a fixed order
// (the Python wrappers in ops/kernels/iteration.py build it) and its
// length, refuses a length that does not match before it launches
// anything, and returns cudaGetLastError() so that a refused launch is
// reported.

#include "iteration.cuh"

namespace {

// Per clip (one block each): fold the four pad rows' bf16 cotangents into
// the six boundary rows of gy2, then the peak-norm VJP's scalars from gy2
// and y2 = u / cden (synth_bwd_scalars_clip).  The fold's writes are
// visible to the whole block after the barrier.
__global__ void __launch_bounds__(kRedThreads)
fold_scalars(const float* gpad, float* gy2, const float* u, const float* m1, float* scal,
             int lr, int hop) {
  __shared__ float sh[kRedThreads / 32];
  const int b = blockIdx.x;
  const long long len = (long long)lr * hop;
  float* gb = gy2 + b * len;
  reflect_fold_clip(gpad + (long long)b * 2 * kPad * hop, gb, lr, hop);
  __syncthreads();
  synth_bwd_scalars_clip(gb, u + b * len, m1[b], true, scal + 4 * b, (int)len, sh);
}

// ct (B, T, P) -> pred and the residuals (r), u (B, T-1, hop) and m1 (B,).
void iteration_fwd_chain(const float* ct, const RoundConsts& c, const DetFwdConsts& dc,
                         const DetRes& r, float* u, float* m1, const IterScratch& w, int batch,
                         int t, int p, int hop, cudaStream_t st) {
  const int lr = t - 1;
  cudaMemsetAsync(m1, 0, sizeof(float) * batch, st);  // max |u| >= 0: its bits order
  const Geometry geo{lr, 0, t, 2 * p, hop, kR, -1, kPad, c.ab, (long long)kR * hop,
                     (long long)hop};
  launch_shift_gemm<SynthA, SynthEpi, true>(SynthA{ct, c.csin, t, p},
                                            SynthEpi{u, c.env, c.y_const, lr, hop}, geo, batch,
                                            (unsigned int*)m1, st);
  launch_reflect_analysis(u, m1, c.csw, w.big, batch, t, 2 * p, hop, st);
  detector_fwd_chain(w.big, dc, r, DetFwdScratch{w.mel32, w.ha, w.hb, w.mu, w.small}, batch, t,
                     p, st);
}

// g (B, 128) (or, given wm, the push_extremes gradient, with the loss out)
// -> dreim (B, T, 2P) in w.big.
void iteration_bwd_chain(const float* g, const float* wm, float* loss, const DetRes& r,
                         const float* u, const float* m1, const RoundConsts& c,
                         const DetBwdConsts& dc, const IterScratch& w, int batch, int t, int p,
                         int hop, cudaStream_t st) {
  const int lr = t - 1;
  detector_bwd_chain(g, wm, loss, r, dc, w.big,
                     DetBwdScratch{w.ha, w.hb, w.mu, w.m2, w.small, w.clip2}, batch, t, p, st);
  launch_reflect_analysis_bwd(w.big, c.cswt, w.gy2, w.gpad, batch, t, 2 * p, hop, st);
  fold_scalars<<<batch, kRedThreads, 0, st>>>(w.gpad, w.gy2, u, m1, w.scal, lr, hop);
  const Geometry geo{t, 0, lr, hop, 2 * p, kR, +1, kPad, c.abt, (long long)2 * p,
                     (long long)hop * 2 * p};
  launch_shift_gemm<SynthBwdA, StoreEpi, false>(SynthBwdA{w.gy2, u, c.env, w.scal, lr, hop, true},
                                                StoreEpi{w.big, t, 2 * p}, geo, batch, nullptr,
                                                st);
}

}  // namespace

extern "C" {

// ptrs (42, FwdArgs).  The first chain of the forward, which
// aw_iteration_fwd_sm90 (iteration_sm90.cu) replaced; no wrapper reaches
// it: chip_smoke.py times the two in turns.
int aw_iteration_fwd_wmma(void* const* ptrs, int n, int batch, int t, int p, int hop,
                     void* stream) {
  Ptrs a{ptrs, n, 0};
  const FwdArgs s = take_fwd(a);
  if (!a.done()) return (int)cudaErrorInvalidValue;
  iteration_fwd_chain(s.ct, s.c, s.dc, s.r, s.u, s.m1, s.w, batch, t, p, hop,
                      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// ptrs (41, BwdArgs).  The first WMMA chain of the VJP, which
// aw_iteration_bwd (iteration_sm90.cu) replaced; no wrapper reaches it:
// chip_smoke.py times the two in turns.
int aw_iteration_bwd_wmma(void* const* ptrs, int n, int batch, int t, int p, int hop,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Ptrs a{ptrs, n, 0};
  const BwdArgs s = take_bwd(a);
  if (!a.done()) return (int)cudaErrorInvalidValue;
  iteration_bwd_chain(s.g, nullptr, nullptr, s.r, s.u, s.m1, s.c, s.dc, s.w, batch, t, p, hop,
                      st);
  const long long rows = (long long)batch * t;
  fold_phase<<<elementwise_blocks(rows * p), 256, 0, st>>>(s.w.big, s.c.csin, s.dct, rows, p);
  return (int)cudaGetLastError();
}

// ptrs (61, StepArgs): the step's state, inputs, constants, residuals and
// scratch.  c_m, b2, c_v, eps: NadamCoefs.  The first WMMA chain of the
// step, which aw_iteration_step (iteration_sm90.cu) replaced; no wrapper
// reaches it: chip_smoke.py times the two in turns.
int aw_iteration_step_wmma(void* const* ptrs, int n, int batch, int t, int p, int hop,
                           float c_m, float b2, float c_v, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Ptrs a{ptrs, n, 0};
  const StepArgs s = take_step(a);
  if (!a.done()) return (int)cudaErrorInvalidValue;
  iteration_fwd_chain(s.ct, s.c, s.dfc, s.r, s.u, s.m1, s.w, batch, t, p, hop, st);
  iteration_bwd_chain(nullptr, s.wm, s.loss, s.r, s.u, s.m1, s.c, s.dbc, s.w, batch, t, p, hop,
                      st);
  launch_step_epilogue(s.w.big, s.c.csin, s.ct, s.m, s.v, s.best, s.best_loss, s.lower, s.upper,
                       s.loss, s.s1, s.s2, s.d2, NadamCoefs{c_m, b2, c_v, eps}, batch, t, p, st);
  return (int)cudaGetLastError();
}

// The step's epilogue alone (the chip check holds it against its plain
// version given the same dreim).  ptrs (13): dreim (B, T, 2P) f32, csin
// (B, T, 2P) bf16; ct, m, v, best, best_loss in place; lower, upper, loss,
// s1, s2, d2 as in aw_iteration_step.
int aw_step_epilogue(void* const* ptrs, int n, int batch, int t, int p, float c_m, float b2,
                     float c_v, float eps, void* stream) {
  Ptrs a{ptrs, n, 0};
  const float* dreim = a.next<const float>();
  const bf16* csin = a.next<const bf16>();
  float* ct = a.next<float>();
  float* m = a.next<float>();
  float* v = a.next<float>();
  float* best = a.next<float>();
  float* best_loss = a.next<float>();
  const float* lower = a.next<const float>();
  const float* upper = a.next<const float>();
  const float* loss = a.next<const float>();
  const float* s1 = a.next<const float>();
  const float* s2 = a.next<const float>();
  const float* d2 = a.next<const float>();
  if (!a.done()) return (int)cudaErrorInvalidValue;
  launch_step_epilogue(dreim, csin, ct, m, v, best, best_loss, lower, upper, loss, s1, s2, d2,
                       NadamCoefs{c_m, b2, c_v, eps}, batch, t, p, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
