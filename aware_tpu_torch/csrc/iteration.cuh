// What iteration.cu (the WMMA chains: aw_iteration_fwd_wmma,
// aw_iteration_bwd_wmma, aw_iteration_step_wmma) and iteration_sm90.cu (the
// TMA + wgmma chains: aw_iteration_step, aw_iteration_fwd_sm90,
// aw_iteration_bwd) share: the reading of the pointer table their C
// entries take, the round trip's constants, the scratch, and the step's
// NAdam / clamp / best epilogue.  What they compute: iteration.cu.

#pragma once

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

// The forward's pointer table (42), as aw_iteration_fwd_wmma and
// aw_iteration_fwd_sm90 take it: ct (B, T, P) f32; csin, y_const, env, ab,
// csw (RoundConsts); melb, w0t..w3t, biases, eo (the detector's forward
// constants) -> the 16 residuals (DetResiduals' order: pred first), u
// (B, T-1, hop) and m1 (B,) f32; then the 11 scratch buffers.
struct FwdArgs {
  const float* ct;
  RoundConsts c;
  DetFwdConsts dc;
  DetRes r;
  float *u, *m1;
  IterScratch w;
};

FwdArgs take_fwd(Ptrs& a) {
  FwdArgs s{};
  s.ct = a.next<const float>();
  s.c.csin = a.next<const bf16>();
  s.c.y_const = a.next<const float>();
  s.c.env = a.next<const float>();
  s.c.ab = a.next<const bf16>();
  s.c.csw = a.next<const bf16>();
  s.dc = take_det_fwd(a);
  s.r = take_res(a);
  s.u = a.next<float>();
  s.m1 = a.next<float>();
  s.w = take_scratch(a);
  return s;
}

// The VJP's pointer table (41), as aw_iteration_bwd and
// aw_iteration_bwd_wmma take it: g (B, 128) f32; the forward's 16
// residuals, u and m1; csin, env, abt, cswt (RoundConsts); w0..w3, eot,
// melbt (the detector's backward constants) -> dct (B, T, P) f32; then the
// 11 scratch buffers.
struct BwdArgs {
  const float* g;
  DetRes r;
  const float *u, *m1;
  RoundConsts c;
  DetBwdConsts dc;
  float* dct;
  IterScratch w;
};

BwdArgs take_bwd(Ptrs& a) {
  BwdArgs s{};
  s.g = a.next<const float>();
  s.r = take_res(a);
  s.u = a.next<const float>();
  s.m1 = a.next<const float>();
  s.c.csin = a.next<const bf16>();
  s.c.env = a.next<const float>();
  s.c.abt = a.next<const bf16>();
  s.c.cswt = a.next<const bf16>();
  s.dc = take_det_bwd(a);
  s.dct = a.next<float>();
  s.w = take_scratch(a);
  return s;
}

// The step's pointer table (61), as aw_iteration_step and
// aw_iteration_step_wmma take it: ct, m, v, best (B, T, P) and best_loss
// (B,) f32, updated in place; lower, upper (B, T, P), wm (B, 128) (the
// bipolar message in the first 20 lanes, 0 after), s1, s2 (B,), d2 (1,)
// f32 -> loss (B,) f32 (the pre-step ct's); csin, y_const, env, ab, abt,
// csw, cswt (RoundConsts); the detector's 7 forward and 6 backward
// constants; the 16 residuals, u and m1 as scratch; then the 11 scratch
// buffers.
struct StepArgs {
  float *ct, *m, *v, *best, *best_loss;
  const float *lower, *upper, *wm, *s1, *s2, *d2;
  float* loss;
  RoundConsts c;
  DetFwdConsts dfc;
  DetBwdConsts dbc;
  DetRes r;
  float *u, *m1;
  IterScratch w;
};

StepArgs take_step(Ptrs& a) {
  StepArgs s;
  s.ct = a.next<float>();
  s.m = a.next<float>();
  s.v = a.next<float>();
  s.best = a.next<float>();
  s.best_loss = a.next<float>();
  s.lower = a.next<const float>();
  s.upper = a.next<const float>();
  s.wm = a.next<const float>();
  s.s1 = a.next<const float>();
  s.s2 = a.next<const float>();
  s.d2 = a.next<const float>();
  s.loss = a.next<float>();
  s.c.csin = a.next<const bf16>();
  s.c.y_const = a.next<const float>();
  s.c.env = a.next<const float>();
  s.c.ab = a.next<const bf16>();
  s.c.abt = a.next<const bf16>();
  s.c.csw = a.next<const bf16>();
  s.c.cswt = a.next<const bf16>();
  s.dfc = take_det_fwd(a);
  s.dbc = take_det_bwd(a);
  s.r = take_res(a);
  s.u = a.next<float>();
  s.m1 = a.next<float>();
  s.w = take_scratch(a);
  return s;
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
