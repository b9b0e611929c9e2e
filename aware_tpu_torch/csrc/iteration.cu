// The whole-iteration kernels of the embed solver, for Hopper (sm_90a).
//
// They replace the three Pallas TPU kernels of aware_tpu/ops/pallas/iteration.py:
//
//   aw_iteration_fwd  <- iteration_forward forward (_iter_fwd_impl :173,
//                        _iter_fwd_kernel :72)
//   aw_iteration_bwd  <- iteration_forward VJP (_iter_bwd_impl :285,
//                        _iter_bwd_kernel :193)
//   aw_iteration_step <- iteration_step (pallas_call :513, _step_kernel :341)
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
//   fwd  (13 launches + 1 memset): memset m1; the synthesis GEMM with the
//        per-clip atomicMax of |u| into m1's bits; the reflect-pad analysis
//        GEMM, whose loader forms y2 = u / cden as it stages it (no
//        peak_scale pass, no y2 in memory); the 11 launches of the detector
//        forward;
//   bwd  (15 launches): the 11 of the detector backward; the transposed
//        analysis GEMM (pad rows' cotangents to a small scratch); ONE
//        per-clip kernel that folds the pad rows into the six boundary rows
//        and then reduces q = sum gy2 y2, max |y2| and its ties (two
//        launches in the two-kernel chain); the synthesis-VJP GEMM; the
//        phase fold;
//   step (29 launches + 1 memset): fwd, bwd with the loss in brh_bwd, and
//        the NAdam epilogue in place of the phase fold, then best_loss.
//
// Bounds at the main path's shapes (B = 8, T = 626): each direction is the
// synthesis GEMM (5.3 GFLOP) plus the analysis and detector GEMMs (14.4
// GFLOP), about 19.7 GFLOP, 0.020 ms at the bf16 peak; the step is both,
// 39.5 GFLOP, 0.040 ms.  The device code is shared with the two-kernel
// chain (roundtrip.cuh, analysis_detector.cuh, detector.cuh); its times are
// in PERF.md.
//
// Each entry takes a host array of the device pointers in a fixed order
// (the Python wrappers in ops/kernels/iteration.py build it) and its
// length, refuses a length that does not match before it launches
// anything, and returns cudaGetLastError() so that a refused launch is
// reported.

#include "analysis_detector.cuh"
#include "detector.cuh"

namespace {

// A cursor over the host array of device pointers an entry takes.
struct Ptrs {
  void* const* p;
  int n;
  int i;
  template <class T>
  T* next() {
    return i < n ? (T*)p[i++] : (++i, nullptr);
  }
  bool done() const { return i == n; }
};

using bf16 = __nv_bfloat16;

// The round trip's constants (per clip where batched): csin (B, T, 2P)
// bf16, y_const (B, T-1, hop), env (T-1, hop) f32, ab (2P, 4 hop), abt
// (4 hop, 2P), csw (4 hop, 2P), cswt (2P, 4 hop) bf16.
struct RoundConsts {
  const bf16* csin;
  const float* y_const;
  const float* env;
  const bf16* ab;
  const bf16* abt;
  const bf16* csw;
  const bf16* cswt;
};

// Scratch of both directions, reused across them: big (B, T, 2P) holds
// cs2, then dcs, then dreim; mel32 (B, T, 128); ha, hb (B, T2, 1024) the
// conv pre-activations, then the conv cotangents; mu, m2 (B, 1024); small
// (B, 128) the BRH pool, then its cotangent; clip2 (B, 2); gy2 (B, T-1,
// hop); gpad (B, 4, hop); scal (B, 4).  All f32.
struct IterScratch {
  float *big, *mel32, *ha, *hb, *mu, *m2, *small, *clip2, *gy2, *gpad, *scal;
};

DetFwdConsts take_det_fwd(Ptrs& a) {
  DetFwdConsts c;
  c.melb = a.next<const bf16>();
  c.w0t = a.next<const bf16>();
  c.w1t = a.next<const bf16>();
  c.w2t = a.next<const bf16>();
  c.w3t = a.next<const bf16>();
  c.biases = a.next<const float>();
  c.eo = a.next<const float>();
  return c;
}

DetBwdConsts take_det_bwd(Ptrs& a) {
  DetBwdConsts c;
  c.w0 = a.next<const bf16>();
  c.w1 = a.next<const bf16>();
  c.w2 = a.next<const bf16>();
  c.w3 = a.next<const bf16>();
  c.eot = a.next<const float>();
  c.melbt = a.next<const bf16>();
  return c;
}

// The detector's 16 residuals, in DetResiduals' order.
DetRes take_res(Ptrs& a) {
  DetRes r;
  r.pred = a.next<float>();
  r.nph = a.next<bf16>();
  r.mel = a.next<bf16>();
  r.y0 = a.next<bf16>();
  r.y1 = a.next<bf16>();
  r.y2 = a.next<bf16>();
  r.y3 = a.next<bf16>();
  r.mu1 = a.next<float>();
  r.r1 = a.next<float>();
  r.rin0 = a.next<float>();
  r.rin1 = a.next<float>();
  r.rin2 = a.next<float>();
  r.rin3 = a.next<float>();
  r.gmu = a.next<float>();
  r.gr = a.next<float>();
  r.s = a.next<float>();
  return r;
}

IterScratch take_scratch(Ptrs& a) {
  IterScratch w;
  float** f[] = {&w.big, &w.mel32, &w.ha, &w.hb, &w.mu, &w.m2,
                 &w.small, &w.clip2, &w.gy2, &w.gpad, &w.scal};
  for (float** q : f) *q = a.next<float>();
  return w;
}

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

// torch.optim.NAdam's constants as float32: 1 - b1, b2, 1 - b2 (each
// rounded from its double value, as torch and the plain version see them)
// and eps.
struct NadamCoefs {
  float c_m, b2, c_v, eps;
};

// The step's epilogue, element i of (B, T, P): g = the phase fold of dreim;
// m += (1 - b1)(g - m); v = b2 v + (1 - b2) g^2; denom = sqrt(v / d2) + eps;
// ct -= s1[b] g / denom; ct -= s2[b] m / denom; ct = clamp(ct, lower,
// upper); best = ct where loss[b] < best_loss[b].  Each operation rounded
// as torch's elementwise ops round it (no fused multiply-adds).
__global__ void nadam_fold(const float* dreim, const bf16* csin, float* ct, float* m, float* v,
                           float* best, const float* lower, const float* upper,
                           const float* s1, const float* s2, const float* d2,
                           const float* loss, const float* best_loss, NadamCoefs k,
                           long long per_clip, int p, int batch) {
  const long long total = per_clip * batch;
  const float d2v = d2[0];
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(i / per_clip);
    const float g = phase_fold(dreim, csin, i, p);
    const float mo = m[i];
    const float mn = __fadd_rn(mo, __fmul_rn(k.c_m, __fsub_rn(g, mo)));
    const float vn = __fadd_rn(__fmul_rn(k.b2, v[i]), __fmul_rn(k.c_v, __fmul_rn(g, g)));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, d2v)), k.eps);
    float pn = __fsub_rn(ct[i], __fdiv_rn(__fmul_rn(s1[b], g), den));
    pn = __fsub_rn(pn, __fdiv_rn(__fmul_rn(s2[b], mn), den));
    pn = fminf(fmaxf(pn, lower[i]), upper[i]);
    m[i] = mn;
    v[i] = vn;
    ct[i] = pn;
    if (loss[b] < best_loss[b]) best[i] = pn;
  }
}

// After every element of every clip has read best_loss: best_loss = loss
// where loss < best_loss.
__global__ void best_loss_update(const float* loss, float* best_loss, int batch) {
  for (int b = threadIdx.x; b < batch; b += blockDim.x)
    if (loss[b] < best_loss[b]) best_loss[b] = loss[b];
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

void launch_step_epilogue(const float* dreim, const bf16* csin, float* ct, float* m, float* v,
                          float* best, float* best_loss, const float* lower,
                          const float* upper, const float* loss, const float* s1,
                          const float* s2, const float* d2, NadamCoefs k, int batch, int t,
                          int p, cudaStream_t st) {
  const long long per_clip = (long long)t * p;
  nadam_fold<<<elementwise_blocks(per_clip * batch), 256, 0, st>>>(
      dreim, csin, ct, m, v, best, lower, upper, s1, s2, d2, loss, best_loss, k, per_clip, p,
      batch);
  best_loss_update<<<1, 32, 0, st>>>(loss, best_loss, batch);
}

}  // namespace

extern "C" {

// ptrs (42): ct (B, T, P) f32; csin, y_const, env, ab, csw (RoundConsts);
// melb, w0t..w3t, biases, eo (the detector's forward constants) -> the 16
// residuals (DetResiduals' order: pred first), u (B, T-1, hop) and m1 (B,)
// f32; then the 11 scratch buffers (IterScratch).
int aw_iteration_fwd(void* const* ptrs, int n, int batch, int t, int p, int hop,
                     void* stream) {
  Ptrs a{ptrs, n, 0};
  const float* ct = a.next<const float>();
  RoundConsts c{};
  c.csin = a.next<const bf16>();
  c.y_const = a.next<const float>();
  c.env = a.next<const float>();
  c.ab = a.next<const bf16>();
  c.csw = a.next<const bf16>();
  const DetFwdConsts dc = take_det_fwd(a);
  const DetRes r = take_res(a);
  float* u = a.next<float>();
  float* m1 = a.next<float>();
  const IterScratch w = take_scratch(a);
  if (!a.done()) return (int)cudaErrorInvalidValue;
  iteration_fwd_chain(ct, c, dc, r, u, m1, w, batch, t, p, hop, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// ptrs (41): g (B, 128) f32; the forward's 16 residuals, u and m1; csin,
// env, abt, cswt (RoundConsts); w0..w3, eot, melbt (the detector's backward
// constants) -> dct (B, T, P) f32; then the 11 scratch buffers.
int aw_iteration_bwd(void* const* ptrs, int n, int batch, int t, int p, int hop,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Ptrs a{ptrs, n, 0};
  const float* g = a.next<const float>();
  const DetRes r = take_res(a);
  const float* u = a.next<const float>();
  const float* m1 = a.next<const float>();
  RoundConsts c{};
  c.csin = a.next<const bf16>();
  c.env = a.next<const float>();
  c.abt = a.next<const bf16>();
  c.cswt = a.next<const bf16>();
  const DetBwdConsts dc = take_det_bwd(a);
  float* dct = a.next<float>();
  const IterScratch w = take_scratch(a);
  if (!a.done()) return (int)cudaErrorInvalidValue;
  iteration_bwd_chain(g, nullptr, nullptr, r, u, m1, c, dc, w, batch, t, p, hop, st);
  const long long rows = (long long)batch * t;
  fold_phase<<<elementwise_blocks(rows * p), 256, 0, st>>>(w.big, c.csin, dct, rows, p);
  return (int)cudaGetLastError();
}

// ptrs (61): ct, m, v, best (B, T, P) and best_loss (B,) f32, updated in
// place; lower, upper (B, T, P), wm (B, 128) (the bipolar message in the
// first 20 lanes, 0 after), s1, s2 (B,), d2 (1,) f32 -> loss (B,) f32 (the
// pre-step ct's); csin, y_const, env, ab, abt, csw, cswt (RoundConsts);
// the detector's 7 forward and 6 backward constants; the 16 residuals, u
// and m1 as scratch; then the 11 scratch buffers.  c_m, b2, c_v, eps:
// NadamCoefs.
int aw_iteration_step(void* const* ptrs, int n, int batch, int t, int p, int hop, float c_m,
                      float b2, float c_v, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Ptrs a{ptrs, n, 0};
  float* ct = a.next<float>();
  float* m = a.next<float>();
  float* v = a.next<float>();
  float* best = a.next<float>();
  float* best_loss = a.next<float>();
  const float* lower = a.next<const float>();
  const float* upper = a.next<const float>();
  const float* wm = a.next<const float>();
  const float* s1 = a.next<const float>();
  const float* s2 = a.next<const float>();
  const float* d2 = a.next<const float>();
  float* loss = a.next<float>();
  RoundConsts c;
  c.csin = a.next<const bf16>();
  c.y_const = a.next<const float>();
  c.env = a.next<const float>();
  c.ab = a.next<const bf16>();
  c.abt = a.next<const bf16>();
  c.csw = a.next<const bf16>();
  c.cswt = a.next<const bf16>();
  const DetFwdConsts dfc = take_det_fwd(a);
  const DetBwdConsts dbc = take_det_bwd(a);
  const DetRes r = take_res(a);
  float* u = a.next<float>();
  float* m1 = a.next<float>();
  const IterScratch w = take_scratch(a);
  if (!a.done()) return (int)cudaErrorInvalidValue;
  iteration_fwd_chain(ct, c, dfc, r, u, m1, w, batch, t, p, hop, st);
  iteration_bwd_chain(nullptr, wm, loss, r, u, m1, c, dbc, w, batch, t, p, hop, st);
  launch_step_epilogue(w.big, c.csin, ct, m, v, best, best_loss, lower, upper, loss, s1, s2,
                       d2, NadamCoefs{c_m, b2, c_v, eps}, batch, t, p, st);
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
