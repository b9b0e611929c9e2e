// The fused detector's device code, for Hopper (sm_90a): the kernels and
// the two chains of launches that detector.cu's C entries (detector_fused
// forward, and the VJP's first chain aw_detector_bwd_wmma) and
// iteration.cu's WMMA chains run; the sm90 chains (detector_sm90.cuh,
// iteration_sm90.cu) share its norm, BRH and mel-term kernels.
//
// What they compute, per clip b (T frames, T2 = T // 2, P padded band bins,
// channels 128 -> 512 -> 1024 -> 1024 -> 128, the last padded from 40):
//
//   fwd:  m = |cs| (sgn(0) = 0), nph = bf16(cs / |cs|)         (T, 2P) residual
//         mel = bf16(m) @ melb                                  (T, 128)
//         a = instance_norm(mel), b = (a - gmu) * gr  (global standardize,
//         unbiased), x = AvgPool(2, 2)(b)                       (T2, 128)
//         4x: h = bf16(x) @ w_i^T + bias_i; yhat = instance_norm(h);
//             residual bf16(yhat); x = leaky_0.2(yhat) (from the f32 yhat)
//         pred = tanh(mean_t(x) @ eo)                           (128,)
//   bwd:  the input cotangent only (the detector is frozen key material):
//         tanh', then per layer du = dx * leaky'(yhat),
//         dh = r (du - mean_t du - yhat mean_t(du yhat)), dx = bf16(dh) @ w_i;
//         pool backward in f32; the global-standardize and mel instance-norm
//         backwards from the bf16 mel residual; dm = bf16(dmel) @ melbt;
//         dcs = dm * nph.
//
// The Pallas kernels hold one clip's whole working set (about 6 MB) in VMEM.
// An SM has 227 KB of shared memory, so here each direction is a chain of
// kernels with the intermediates in device memory: the five GEMMs run on
// the shifted-slab WMMA template (tile_gemm.cuh) with the norm, pool and
// activation applied in their A-operand loaders and the bias or phase in
// their epilogues, and the reductions over time run in separate kernels,
// one block per (clip, 32 channels) looping over the rows (one block per
// clip where a statistic spans the whole clip), with no float atomics, so a
// run repeats bit for bit.  Variances are two-pass (subtract the mean, then
// square), as in the Pallas kernel: the one-pass form amplified
// kernel-vs-replica drift there.

#pragma once

#include "tile_gemm.cuh"

namespace {

constexpr float kInEps = 1e-5f;  // nn.InstanceNorm1d eps, inside the rsqrt
constexpr float kGsEps = 1e-8f;  // GlobalStandardize eps, added to the std
constexpr int kMel = 128;        // mel channels
constexpr int kBits = 20;        // BRH outputs that carry the message
constexpr int kNormCh = 32;      // channels per block of the per-channel norms
constexpr int kNormLanes = 8;    // row lanes per channel in those blocks
constexpr int kMelLanes = kRedThreads / kMel;  // row lanes of the per-clip blocks

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.2f * v; }

// The sum over the NL row lanes of each of NCH channels of a block whose
// thread i holds channel i % NCH, lane i / NCH; every thread gets its
// channel's sum, added in lane order.
template <int NCH, int NL>
__device__ float lane_sum(float v, float* sh) {
  __syncthreads();
  sh[threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
  for (int l = 0; l < NL; ++l) s += sh[l * NCH + threadIdx.x % NCH];
  return s;
}

// ------------------------------------------------------------ forward ---

struct MagA {  // m = |re + i im| of cs (B, T, 2P); nph written once, by column block 0
  const float* cs;
  __nv_bfloat16* nph;
  int t;
  int p;
  __device__ float operator()(int b, int s, int c) const {
    const long long row = ((long long)b * t + s) * 2 * p;
    const float re = cs[row + c], im = cs[row + p + c];
    const float sq = re * re + im * im;
    const float inv = sq == 0.f ? 0.f : 1.f / sqrtf(sq);
    if (blockIdx.x == 0) {
      nph[row + c] = __float2bfloat16(re * inv);
      nph[row + p + c] = __float2bfloat16(im * inv);
    }
    return sq * inv;
  }
};

struct PoolA {  // x[i] = 0.5 b[2i] + 0.5 b[2i+1], b the standardized mel
  const float* mel;  // (B, T, 128) f32
  const float* mu1;
  const float* r1;
  const float* gmu;
  const float* gr;
  int t;
  __device__ float operator()(int b, int i, int c) const {
    const float* m0 = mel + ((long long)b * t + 2 * i) * kMel + c;
    const float mu = mu1[b * kMel + c], r = r1[b * kMel + c];
    const float b0 = ((m0[0] - mu) * r - gmu[b]) * gr[b];
    const float b1 = ((m0[kMel] - mu) * r - gmu[b]) * gr[b];
    return 0.5f * b0 + 0.5f * b1;
  }
};

struct NormLeakyA {  // x = leaky((h - mu) * r) of the previous layer's h (B, T2, C)
  const float* h;
  const float* mu;
  const float* r;
  int m;
  int c_n;
  __device__ float operator()(int b, int s, int c) const {
    const int k = b * c_n + c;
    return leaky((h[((long long)b * m + s) * c_n + c] - mu[k]) * r[k]);
  }
};

struct BiasEpi {  // h = acc + bias
  float* h;
  const float* bias;
  int m;
  int n;
  __device__ float operator()(int b, int row, int col, float acc) const {
    h[((long long)b * m + row) * n + col] = acc + bias[col];
    return 0.f;
  }
};

// Instance norm over the m rows of h (B, m, C), one block per (32
// channels, clip): mu, r = rsqrt(var + eps), the bf16 residual yhat, and,
// where pool4 is given, the time mean of leaky(yhat) (the BRH pool); where
// xa is given, the next layer's bf16 A operand leaky(yhat) (B, m, C), the
// value NormLeakyA builds from the same h, mu and r (the sm90 chain's).
__global__ void __launch_bounds__(kNormCh * kNormLanes)
in_norm_fwd(const float* h, int m, int c_n, float* mu_out, float* r_out,
            __nv_bfloat16* y, float* pool4, __nv_bfloat16* xa) {
  __shared__ float sh[kNormCh * kNormLanes];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kNormCh + threadIdx.x % kNormCh;
  const int lane = threadIdx.x / kNormCh;
  const long long base = (long long)b * m * c_n + c;
  float acc = 0.f;
  for (int i = lane; i < m; i += kNormLanes) acc += h[base + (long long)i * c_n];
  const float mu = lane_sum<kNormCh, kNormLanes>(acc, sh) / m;
  acc = 0.f;
  for (int i = lane; i < m; i += kNormLanes) {
    const float d = h[base + (long long)i * c_n] - mu;
    acc += d * d;
  }
  const float var = lane_sum<kNormCh, kNormLanes>(acc, sh) / m;
  const float r = 1.f / sqrtf(var + kInEps);
  acc = 0.f;
  for (int i = lane; i < m; i += kNormLanes) {
    const long long e = base + (long long)i * c_n;
    const float v = (h[e] - mu) * r;
    y[e] = __float2bfloat16(v);
    if (xa != nullptr) xa[e] = __float2bfloat16(leaky(v));
    acc += leaky(v);
  }
  if (pool4 != nullptr) {
    const float pooled = lane_sum<kNormCh, kNormLanes>(acc, sh) / m;
    if (lane == 0) pool4[b * c_n + c] = pooled;
  }
  if (lane == 0) {
    mu_out[b * c_n + c] = mu;
    r_out[b * c_n + c] = r;
  }
}

// The mel stage, one block per clip: the per-channel instance norm (mu1,
// r1) and then the clip's global standardize (gmu, s, gr = 1 / (s + eps))
// of a = (mel - mu1) r1; writes the bf16 mel residual.
__global__ void __launch_bounds__(kRedThreads)
mel_norm_fwd(const float* mel, int t, __nv_bfloat16* mel_bf, float* mu1, float* r1,
             float* gmu, float* gr, float* s_out) {
  __shared__ float sh[kRedThreads];
  const int b = blockIdx.x;
  const int c = threadIdx.x % kMel;
  const int lane = threadIdx.x / kMel;
  const long long base = (long long)b * t * kMel + c;
  float acc = 0.f;
  for (int i = lane; i < t; i += kMelLanes) {
    const float v = mel[base + (long long)i * kMel];
    mel_bf[base + (long long)i * kMel] = __float2bfloat16(v);
    acc += v;
  }
  const float mu = lane_sum<kMel, kMelLanes>(acc, sh) / t;
  acc = 0.f;
  for (int i = lane; i < t; i += kMelLanes) {
    const float d = mel[base + (long long)i * kMel] - mu;
    acc += d * d;
  }
  const float r = 1.f / sqrtf(lane_sum<kMel, kMelLanes>(acc, sh) / t + kInEps);
  const float n_el = (float)t * kMel;
  acc = 0.f;
  for (int i = lane; i < t; i += kMelLanes) acc += (mel[base + (long long)i * kMel] - mu) * r;
  const float g_mu = block_sum(acc, sh) / n_el;
  acc = 0.f;
  for (int i = lane; i < t; i += kMelLanes) {
    const float d = (mel[base + (long long)i * kMel] - mu) * r - g_mu;
    acc += d * d;
  }
  const float s = sqrtf(block_sum(acc, sh) / (n_el - 1.f));
  if (lane == 0) {
    mu1[b * kMel + c] = mu;
    r1[b * kMel + c] = r;
  }
  if (threadIdx.x == 0) {
    gmu[b] = g_mu;
    s_out[b] = s;
    gr[b] = 1.f / (s + kGsEps);
  }
}

// BRH readout, one block of 128 threads per clip: pred = tanh(pool4 @ eo).
__global__ void brh_fwd(const float* pool4, const float* eo, float* pred) {
  const int b = blockIdx.x, j = threadIdx.x;
  float acc = 0.f;
  for (int k = 0; k < kMel; ++k) acc += pool4[b * kMel + k] * eo[k * kMel + j];
  pred[b * kMel + j] = tanhf(acc);
}

// ----------------------------------------------------------- backward ---

// One block of 128 threads per clip: dx = (g (1 - pred^2)) @ eot / T2, the
// cotangent of every row of the last layer's output (the time mean's).
// With wm (B, 128), g is not read: the kernel takes the push_extremes loss
// of the first kBits lanes, loss[b] = (sum (pred - wm)^2 - 0.1 sum |pred|)
// / kBits, and its gradient g = (2 (pred - wm) - 0.1 sgn(pred)) / kBits
// there (sgn(0) = 0), 0 on the other lanes.
__global__ void brh_bwd(const float* g, const float* wm, float* loss, const float* pred,
                        const float* eot, int t2, float* dxb) {
  __shared__ float gt[kMel];
  __shared__ float sq[kMel];
  __shared__ float ab[kMel];
  const int b = blockIdx.x, j = threadIdx.x;
  const float pv = pred[b * kMel + j];
  float gv;
  if (wm != nullptr) {
    const bool on = j < kBits;
    const float diff = on ? pv - wm[b * kMel + j] : 0.f;
    const float sgn = on ? (float)((pv > 0.f) - (pv < 0.f)) : 0.f;
    gv = (2.f * diff - 0.1f * sgn) / kBits;
    sq[j] = diff * diff;
    ab[j] = on ? fabsf(pv) : 0.f;
  } else {
    gv = g[b * kMel + j];
  }
  gt[j] = gv * (1.f - pv * pv);
  __syncthreads();
  if (wm != nullptr && j == 0) {
    float s2 = 0.f, s1 = 0.f;
    for (int k = 0; k < kBits; ++k) {
      s2 += sq[k];
      s1 += ab[k];
    }
    loss[b] = (s2 - 0.1f * s1) / kBits;
  }
  float acc = 0.f;
  for (int k = 0; k < kMel; ++k) acc += gt[k] * eot[k * kMel + j];
  dxb[b * kMel + j] = acc / t2;
}

// Instance-norm backward statistics over the m rows, one block per (32
// channels, clip): m1 = mean_t du, m2 = mean_t (du yhat) with du = dx
// leaky'(yhat).  dx[b, i, c] sits at dx + b * dx_clip + i * dx_row + c
// (dx_row = 0 broadcasts one row).  Where dh is given, a second sweep
// writes the VJP GEMM's bf16 A operand dh = r (du - m1 - yhat m2) (B, m, C),
// the value NormBwdA builds (the sm90 chain's).
__global__ void __launch_bounds__(kNormCh * kNormLanes)
in_norm_bwd_stats(const float* dx, long long dx_clip, long long dx_row,
                  const __nv_bfloat16* y, int m, int c_n, float* m1, float* m2,
                  const float* r, __nv_bfloat16* dh) {
  __shared__ float sh[kNormCh * kNormLanes];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kNormCh + threadIdx.x % kNormCh;
  const int lane = threadIdx.x / kNormCh;
  float a1 = 0.f, a2 = 0.f;
  for (int i = lane; i < m; i += kNormLanes) {
    const float yh = __bfloat162float(y[((long long)b * m + i) * c_n + c]);
    const float du = dx[b * dx_clip + i * dx_row + c] * (yh >= 0.f ? 1.f : 0.2f);
    a1 += du;
    a2 += du * yh;
  }
  a1 = lane_sum<kNormCh, kNormLanes>(a1, sh) / m;
  a2 = lane_sum<kNormCh, kNormLanes>(a2, sh) / m;
  if (lane == 0) {
    m1[b * c_n + c] = a1;
    m2[b * c_n + c] = a2;
  }
  if (dh != nullptr) {
    const float rk = r[b * c_n + c];
    for (int i = lane; i < m; i += kNormLanes) {
      const long long e = ((long long)b * m + i) * c_n + c;
      const float yh = __bfloat162float(y[e]);
      const float du = dx[b * dx_clip + i * dx_row + c] * (yh >= 0.f ? 1.f : 0.2f);
      dh[e] = __float2bfloat16(rk * (du - a1 - yh * a2));
    }
  }
}

struct NormBwdA {  // dh = r (du - m1 - yhat m2), du = dx leaky'(yhat)
  const float* dx;
  long long dx_clip;
  long long dx_row;
  const __nv_bfloat16* y;
  const float* r;
  const float* m1;
  const float* m2;
  int m;
  int c_n;
  __device__ float operator()(int b, int s, int c) const {
    const float yh = __bfloat162float(y[((long long)b * m + s) * c_n + c]);
    const float du = dx[b * dx_clip + s * dx_row + c] * (yh >= 0.f ? 1.f : 0.2f);
    const int k = b * c_n + c;
    return r[k] * (du - m1[k] - yh * m2[k]);
  }
};

// The mel stage's backward values at frame i, channel c of clip b: the
// pooled cotangent db, a = (mel - mu1) r1 from the bf16 mel residual, and
// the standardized bs = (a - gmu) gr.
struct MelBwdTerms {
  const float* dx0;  // (B, T2, 128), the cotangent of the pool's output
  const __nv_bfloat16* mel_bf;
  const float* mu1;
  const float* r1;
  const float* gmu;
  const float* gr;
  int t;
  __device__ void operator()(int b, int i, int c, float& db, float& a, float& bs) const {
    const int t2 = t / 2;
    db = i < 2 * t2 ? 0.5f * dx0[((long long)b * t2 + i / 2) * kMel + c] : 0.f;
    const float mel = __bfloat162float(mel_bf[((long long)b * t + i) * kMel + c]);
    a = (mel - mu1[b * kMel + c]) * r1[b * kMel + c];
    bs = (a - gmu[b]) * gr[b];
  }
};

// One block per clip: the global-standardize backward's scalars (mean db,
// coef = sum(db bs) / (s (N - 1))), then, with da = gr (db - mean db) -
// bs coef, the mel instance-norm backward's m1 = mean_t da,
// m2 = mean_t (da a) per channel.
__global__ void __launch_bounds__(kRedThreads)
mel_bwd_stats(MelBwdTerms terms, const float* s, float* clip2, float* m1, float* m2) {
  __shared__ float sh[kRedThreads];
  const int b = blockIdx.x;
  const int c = threadIdx.x % kMel;
  const int lane = threadIdx.x / kMel;
  const int t = terms.t;
  const float n_el = (float)t * kMel;
  float a1 = 0.f, a2 = 0.f, db, a, bs;
  for (int i = lane; i < t; i += kMelLanes) {
    terms(b, i, c, db, a, bs);
    a1 += db;
    a2 += db * bs;
  }
  const float mean_db = block_sum(a1, sh) / n_el;
  const float coef = block_sum(a2, sh) / (s[b] * (n_el - 1.f));
  const float g_r = terms.gr[b];
  a1 = 0.f;
  a2 = 0.f;
  for (int i = lane; i < t; i += kMelLanes) {
    terms(b, i, c, db, a, bs);
    const float da = g_r * (db - mean_db) - bs * coef;
    a1 += da;
    a2 += da * a;
  }
  a1 = lane_sum<kMel, kMelLanes>(a1, sh) / t;
  a2 = lane_sum<kMel, kMelLanes>(a2, sh) / t;
  if (lane == 0) {
    m1[b * kMel + c] = a1;
    m2[b * kMel + c] = a2;
  }
  if (threadIdx.x == 0) {
    clip2[2 * b] = mean_db;
    clip2[2 * b + 1] = coef;
  }
}

struct MelBwdA {  // dmel = r1 (da - m1 - a m2)
  MelBwdTerms terms;
  const float* clip2;
  const float* m1;
  const float* m2;
  __device__ float operator()(int b, int i, int c) const {
    float db, a, bs;
    terms(b, i, c, db, a, bs);
    const float da = terms.gr[b] * (db - clip2[2 * b]) - bs * clip2[2 * b + 1];
    const int k = b * kMel + c;
    return terms.r1[k] * (da - m1[k] - a * m2[k]);
  }
};

struct PhaseEpi {  // dcs = dm * nph, in both the Re and the Im block
  float* dcs;
  const __nv_bfloat16* nph;
  int t;
  int p;
  __device__ float operator()(int b, int row, int col, float acc) const {
    const long long e = ((long long)b * t + row) * 2 * p + col;
    dcs[e] = acc * __bfloat162float(nph[e]);
    dcs[e + p] = acc * __bfloat162float(nph[e + p]);
    return 0.f;
  }
};

constexpr int kCh[5] = {128, 512, 1024, 1024, 128};  // mel, conv0..conv3 out
constexpr int kBiasLd = 1024;                        // row stride of biases (4, 1024)

dim3 norm_grid(int c_n, int batch) { return dim3(c_n / kNormCh, batch); }

// The detector's constants, residuals and scratch, as the C entries take
// them (shapes: aw_detector_fwd, aw_detector_bwd).
struct DetFwdConsts {
  const __nv_bfloat16 *melb, *w0t, *w1t, *w2t, *w3t;
  const float *biases, *eo;
};
struct DetBwdConsts {
  const __nv_bfloat16 *w0, *w1, *w2, *w3;
  const float* eot;
  const __nv_bfloat16* melbt;
};
struct DetRes {
  float* pred;
  __nv_bfloat16 *nph, *mel, *y0, *y1, *y2, *y3;
  float *mu1, *r1, *rin0, *rin1, *rin2, *rin3, *gmu, *gr, *s;
};
struct DetFwdScratch {
  float *mel32, *ha, *hb, *mu, *pool4;
};
struct DetBwdScratch {
  float *dxa, *dxb, *m1, *m2, *dx4, *clip2;
};

// The forward chain: 11 launches on st.
void detector_fwd_chain(const float* cs, const DetFwdConsts& c, const DetRes& r,
                        const DetFwdScratch& w, int batch, int t, int p, cudaStream_t st) {
  const int t2 = t / 2;
  launch_shift_gemm(MagA{cs, r.nph, t, p}, StoreEpi{w.mel32, t, kMel},
                    plain_geometry(t, p, kMel, c.melb), batch, nullptr, st);
  mel_norm_fwd<<<batch, kRedThreads, 0, st>>>(w.mel32, t, r.mel, r.mu1, r.r1, r.gmu, r.gr,
                                              r.s);

  const __nv_bfloat16* wt[4] = {c.w0t, c.w1t, c.w2t, c.w3t};
  __nv_bfloat16* ys[4] = {r.y0, r.y1, r.y2, r.y3};
  float* rins[4] = {r.rin0, r.rin1, r.rin2, r.rin3};
  float* hs[2] = {w.ha, w.hb};
  for (int i = 0; i < 4; ++i) {
    const Geometry geo = plain_geometry(t2, kCh[i], kCh[i + 1], wt[i]);
    const BiasEpi epi{hs[i % 2], c.biases + i * kBiasLd, t2, kCh[i + 1]};
    if (i == 0)
      launch_shift_gemm(PoolA{w.mel32, r.mu1, r.r1, r.gmu, r.gr, t}, epi, geo, batch, nullptr,
                        st);
    else
      launch_shift_gemm(NormLeakyA{hs[(i + 1) % 2], w.mu, rins[i - 1], t2, kCh[i]}, epi, geo,
                        batch, nullptr, st);
    in_norm_fwd<<<norm_grid(kCh[i + 1], batch), kNormCh * kNormLanes, 0, st>>>(
        hs[i % 2], t2, kCh[i + 1], w.mu, rins[i], ys[i], i == 3 ? w.pool4 : nullptr, nullptr);
  }
  brh_fwd<<<batch, kMel, 0, st>>>(w.pool4, c.eo, r.pred);
}

// The backward chain, g (B, 128) -> dcs (B, T, 2P): 11 launches on st.
// With wm, brh_bwd takes the push_extremes gradient in place of g and
// writes the loss.
void detector_bwd_chain(const float* g, const float* wm, float* loss, const DetRes& r,
                        const DetBwdConsts& c, float* dcs, const DetBwdScratch& w, int batch,
                        int t, int p, cudaStream_t st) {
  const int t2 = t / 2;
  brh_bwd<<<batch, kMel, 0, st>>>(g, wm, loss, r.pred, c.eot, t2, w.dx4);

  const __nv_bfloat16* ws[4] = {c.w0, c.w1, c.w2, c.w3};
  const __nv_bfloat16* ys[4] = {r.y0, r.y1, r.y2, r.y3};
  const float* rins[4] = {r.rin0, r.rin1, r.rin2, r.rin3};
  float* dxs[2] = {w.dxa, w.dxb};
  const float* dx = w.dx4;  // layer 3's cotangent: one row, broadcast over time
  long long dx_clip = kMel, dx_row = 0;
  for (int i = 3; i >= 0; --i) {
    const int c_out = kCh[i + 1], c_in = kCh[i];
    in_norm_bwd_stats<<<norm_grid(c_out, batch), kNormCh * kNormLanes, 0, st>>>(
        dx, dx_clip, dx_row, ys[i], t2, c_out, w.m1, w.m2, nullptr, nullptr);
    float* out = dxs[i % 2];
    launch_shift_gemm(NormBwdA{dx, dx_clip, dx_row, ys[i], rins[i], w.m1, w.m2, t2, c_out},
                      StoreEpi{out, t2, c_in}, plain_geometry(t2, c_out, c_in, ws[i]),
                      batch, nullptr, st);
    dx = out;
    dx_clip = (long long)t2 * c_in;
    dx_row = c_in;
  }
  const MelBwdTerms terms{dx, r.mel, r.mu1, r.r1, r.gmu, r.gr, t};
  mel_bwd_stats<<<batch, kRedThreads, 0, st>>>(terms, r.s, w.clip2, w.m1, w.m2);
  launch_shift_gemm(MelBwdA{terms, w.clip2, w.m1, w.m2}, PhaseEpi{dcs, r.nph, t, p},
                    plain_geometry(t, kMel, p, c.melbt), batch, nullptr, st);
}

}  // namespace

