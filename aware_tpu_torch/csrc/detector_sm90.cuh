// The detector and its reflect analysis on TMA and wgmma for Hopper
// (sm_90a), both directions, as the sm90 chains run them: the device code
// that iteration_sm90.cu (the step's two halves: aw_iteration_step,
// aw_iteration_fwd_sm90, aw_iteration_bwd) and detector_sm90.cu
// (aw_detector_fwd, aw_reflect_analysis_fwd, aw_detector_bwd,
// aw_reflect_analysis_bwd: the detector_fused and analysis_detector
// forwards and VJPs) share.  One definition of each stage: what
// iteration_sm90.cu says of the chain (two-level sums, A operands written
// by the pass before each product, partial sums finished in one fixed
// order) holds for every entry.
//
//   reflect_analysis_fwd_sm90   y2 (or u and m1) -> cs2: reflect_pad, then
//                               the slab GEMM (2 launches)
//   det_fwd_sm90                cs -> pred and the 16 residuals: mag_pass,
//                               the mel GEMM, 5 mel-norm stages, 4 x (conv
//                               GEMM, in_norm_fwd), brh_fwd (16 launches)
//   det_bwd_sm90                g -> dcs: brh_bwd, 4 x (in_norm_bwd_stats,
//                               conv VJP), 3 mel VJP statistics stages, the
//                               mel VJP with the phase epilogue (13 launches)
//   reflect_analysis_bwd_sm90   dcs -> gy2 and the pad rows' cotangents: the
//                               slab GEMM with SlabReflectBwdEpi (1 launch)
//
// The reductions' primitives (kRedBlock, kPartLd, block_reduce) come from
// chain_sm90.cuh, which roundtrip_sm90.cuh's synthesis stages share.

#pragma once

#include "chain_sm90.cuh"
#include "dense_gemm_sm90.cuh"
#include "iteration.cuh"
#include "slab_gemm_sm90.cuh"

namespace {

constexpr int kMelChunks = 15;  // row chunks of the mel stages: 2 x 15 x 128 + 30 partials
constexpr int kMinFrames = 8;   // distinct reflect-pad boundary rows

// The planned tiles, (bm, bn) per GEMM in launch order: the forward
// half's seven, then the backward half's (the step takes both lists in
// one array, aw_iteration_fwd_sm90 the first, aw_iteration_bwd the
// second, aw_detector_fwd the first's last five, from gMel,
// aw_detector_bwd the second's first five).
enum FwdGemm { gSynth, gAnalysis, gMel, gConv0, gConv1, gConv2, gConv3, gFwdGemms };
enum BwdGemm {
  gConv3Vjp, gConv2Vjp, gConv1Vjp, gConv0Vjp, gMelVjp, gAnalysisVjp, gSynthVjp, gBwdGemms
};
constexpr int gDetFwdGemms = gFwdGemms - gMel;
constexpr int gDetBwdGemms = gMelVjp + 1;

struct Tiles {
  const int* bmbn;  // (bm, bn) pairs
  int bm(int g) const { return bmbn[2 * g]; }
  int bn(int g) const { return bmbn[2 * g + 1]; }
};

// ------------------------------------------------- slab GEMM epilogues ---

// The reflect analysis's VJP: padded row j, interior -> gy2 (B, lr, hop),
// the four pad rows -> gpad (B, 4, hop), rounded to bf16.
struct SlabReflectBwdEpi {
  static constexpr bool kMax = false;
  float* gy2;
  float* gpad;
  int lr;
  int hop;
  __device__ float operator()(int b, int j, int col, float v0, float v1) const {
    if (j >= kPad && j < lr + kPad) {
      *reinterpret_cast<float2*>(gy2 + ((long long)b * lr + j - kPad) * hop + col) =
          make_float2(v0, v1);
    } else {
      const int pr = j < kPad ? j : j - lr;  // 0, 1 | 2, 3
      *reinterpret_cast<float2*>(gpad + ((long long)b * 2 * kPad + pr) * hop + col) =
          make_float2(bf16_round(v0), bf16_round(v1));
    }
    return 0.f;
  }
};

// ------------------------------------------- the mel stages, in chunks ---
//
// The mel norm's and the mel VJP's reductions over (row chunk, clip)
// blocks of kRedBlock threads: channel c = thread % 128, two row lanes.
// Stage k writes its partials to part (the clip's kPartLd floats) at its
// own offset, and every later block of the clip finishes them in chunk
// order.  Chunks are `rc` rows, rc even, so that a pool row's two frames
// share a block.

struct MelChunks {
  int t;
  int rc;   // rows per chunk
  int nch;  // chunks
  __device__ int lo() const { return blockIdx.x * rc; }
  __device__ int hi() const { return min(t, (int)blockIdx.x * rc + rc); }
};

// Chunks of rc rows, rc even, at most kMelChunks of them.
MelChunks mel_chunks(int t) {
  int rc = (t + kMelChunks - 1) / kMelChunks;
  rc += rc & 1;
  return MelChunks{t, rc, (t + rc - 1) / rc};
}

// The mel stages' partial sums of T frames fit a clip's kPartLd floats:
// per chunk, 2 x 128 channel sums and 2 clip sums (either direction).
bool mel_fits(int t) {
  const MelChunks mc = mel_chunks(t);
  return mc.nch <= kMelChunks && 2 * mc.nch * (kMel + 1) <= kPartLd;
}

constexpr int kMelBlockLanes = kRedBlock / kMel;

// The per-channel sums of this block's two lanes, to part[off + chunk 128 + c].
__device__ void put_channel(float v, float* sh, float* part, int off) {
  __syncthreads();
  sh[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x < kMel)
    part[off + blockIdx.x * kMel + threadIdx.x] = sh[threadIdx.x] + sh[kMel + threadIdx.x];
}

// Channel c's sum over the chunks of part[off + k 128 + c].
__device__ float channel_total(const float* part, int off, int nch, int c) {
  float s = 0.f;
  for (int k = 0; k < nch; ++k) s += part[off + k * kMel + c];
  return s;
}

__device__ float chunk_total(const float* part, int off, int nch) {
  float s = 0.f;
  for (int k = 0; k < nch; ++k) s += part[off + k];
  return s;
}

// ------------------------------------------------ the forward's passes ---

// The reflect-padded y2 (B, lr + 4, hop): padded row j holds ReflectA's
// row j - 2, the reflected sample of u / peak_den(m1), or, with m1 =
// nullptr, of u itself (the signal rows y2).
__global__ void reflect_pad(const float* u, const float* m1, float* ypad, int batch, int lr,
                            int hop) {
  const ReflectA ra{u, m1, lr, hop};
  const long long per_clip = (long long)(lr + 2 * kPad) * hop;
  const long long total = per_clip * batch;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(i / per_clip);
    const long long f = i % per_clip;
    ypad[i] = ra(b, (int)(f / hop) - kPad, (int)(f % hop));
  }
}

// nph = bf16(cs / |cs|) (B, T, 2P) and the mel GEMM's A bf16(|cs|) (B, T, P)
// from cs2 (B, T, 2P): MagA's values.
__global__ void mag_pass(const float* cs, bf16* nph, bf16* mag, long long rows, int p) {
  const long long total = rows * p;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = (i / p) * 2 * p;
    const int c = (int)(i % p);
    const float re = cs[row + c], im = cs[row + p + c];
    const float sq = re * re + im * im;
    const float inv = sq == 0.f ? 0.f : 1.f / sqrtf(sq);
    nph[row + c] = __float2bfloat16(re * inv);
    nph[row + p + c] = __float2bfloat16(im * inv);
    mag[i] = __float2bfloat16(sq * inv);
  }
}

// ------------------------------------------- the mel norm, in chunks ---
//
// mel_norm_fwd's reductions (detector.cuh) over (row chunk, clip) blocks,
// on the chunks above (MelChunks).

// The offsets of the stages' partials in a clip's kPartLd floats.
struct MelParts {
  int nch;
  __device__ int sum() const { return 0; }              // nch x 128
  __device__ int sq() const { return nch * kMel; }      // nch x 128
  __device__ int a() const { return 2 * nch * kMel; }   // nch
  __device__ int a2() const { return 2 * nch * kMel + nch; }  // nch
};

struct MelStats {  // channel c's mean and 1 / sqrt(var + eps)
  float mu, r;
};

__device__ MelStats mel_channel(const float* part, MelParts o, int t, int c) {
  const float mu = channel_total(part, o.sum(), o.nch, c) / t;
  const float r = 1.f / sqrtf(channel_total(part, o.sq(), o.nch, c) / t + kInEps);
  return {mu, r};
}

// stage 1: the bf16 mel residual, and each channel's sum
__global__ void __launch_bounds__(kRedBlock)
mel_norm1(const float* mel, bf16* mel_bf, float* part_all, MelChunks ch) {
  __shared__ float sh[kRedBlock];
  const int b = blockIdx.y, c = threadIdx.x % kMel, lane = threadIdx.x / kMel;
  const long long base = (long long)b * ch.t * kMel + c;
  float acc = 0.f;
  for (int i = ch.lo() + lane; i < ch.hi(); i += kMelBlockLanes) {
    const float v = mel[base + (long long)i * kMel];
    mel_bf[base + (long long)i * kMel] = __float2bfloat16(v);
    acc += v;
  }
  put_channel(acc, sh, part_all + (long long)b * kPartLd, MelParts{ch.nch}.sum());
}

// stage 2: each channel's sum of (mel - mu)^2
__global__ void __launch_bounds__(kRedBlock)
mel_norm2(const float* mel, float* part_all, MelChunks ch) {
  __shared__ float sh[kRedBlock];
  const int b = blockIdx.y, c = threadIdx.x % kMel, lane = threadIdx.x / kMel;
  float* part = part_all + (long long)b * kPartLd;
  const MelParts o{ch.nch};
  const float mu = channel_total(part, o.sum(), ch.nch, c) / ch.t;
  const long long base = (long long)b * ch.t * kMel + c;
  float acc = 0.f;
  for (int i = ch.lo() + lane; i < ch.hi(); i += kMelBlockLanes) {
    const float d = mel[base + (long long)i * kMel] - mu;
    acc += d * d;
  }
  put_channel(acc, sh, part, o.sq());
}

// stage 3: the chunk's sum of a = (mel - mu) r
__global__ void __launch_bounds__(kRedBlock)
mel_norm3(const float* mel, float* part_all, MelChunks ch) {
  __shared__ float sh[kRedBlock / 32];
  const int b = blockIdx.y, c = threadIdx.x % kMel, lane = threadIdx.x / kMel;
  float* part = part_all + (long long)b * kPartLd;
  const MelParts o{ch.nch};
  const MelStats s = mel_channel(part, o, ch.t, c);
  const long long base = (long long)b * ch.t * kMel + c;
  float acc = 0.f;
  for (int i = ch.lo() + lane; i < ch.hi(); i += kMelBlockLanes)
    acc += (mel[base + (long long)i * kMel] - s.mu) * s.r;
  acc = block_reduce<false>(acc, sh);
  if (threadIdx.x == 0) part[o.a() + blockIdx.x] = acc;
}

// stage 4: the chunk's sum of (a - gmu)^2
__global__ void __launch_bounds__(kRedBlock)
mel_norm4(const float* mel, float* part_all, MelChunks ch) {
  __shared__ float sh[kRedBlock / 32];
  const int b = blockIdx.y, c = threadIdx.x % kMel, lane = threadIdx.x / kMel;
  float* part = part_all + (long long)b * kPartLd;
  const MelParts o{ch.nch};
  const MelStats s = mel_channel(part, o, ch.t, c);
  const float g_mu = chunk_total(part, o.a(), ch.nch) / ((float)ch.t * kMel);
  const long long base = (long long)b * ch.t * kMel + c;
  float acc = 0.f;
  for (int i = ch.lo() + lane; i < ch.hi(); i += kMelBlockLanes) {
    const float d = (mel[base + (long long)i * kMel] - s.mu) * s.r - g_mu;
    acc += d * d;
  }
  acc = block_reduce<false>(acc, sh);
  if (threadIdx.x == 0) part[o.a2() + blockIdx.x] = acc;
}

// stage 5: the pool GEMM's bf16 A x = 0.5 b[2i] + 0.5 b[2i+1] (PoolA's
// value) for the chunk's pool rows; block 0 of the clip writes mu1, r1,
// gmu, s and gr.
__global__ void __launch_bounds__(kRedBlock)
mel_norm5(const float* mel, float* part_all, MelChunks ch, bf16* pool_a, float* mu1, float* r1,
          float* gmu, float* gr_out, float* s_out) {
  const int b = blockIdx.y, c = threadIdx.x % kMel, lane = threadIdx.x / kMel;
  const float* part = part_all + (long long)b * kPartLd;
  const MelParts o{ch.nch};
  const MelStats s = mel_channel(part, o, ch.t, c);
  const float n_el = (float)ch.t * kMel;
  const float g_mu = chunk_total(part, o.a(), ch.nch) / n_el;
  const float sd = sqrtf(chunk_total(part, o.a2(), ch.nch) / (n_el - 1.f));
  const float g_r = 1.f / (sd + kGsEps);
  const int t2 = ch.t / 2;
  for (int i = ch.lo() / 2 + lane; i < min(ch.hi() / 2, t2); i += kMelBlockLanes) {
    const float* m0 = mel + ((long long)b * ch.t + 2 * i) * kMel + c;
    const float b0 = ((m0[0] - s.mu) * s.r - g_mu) * g_r;
    const float b1 = ((m0[kMel] - s.mu) * s.r - g_mu) * g_r;
    pool_a[((long long)b * t2 + i) * kMel + c] = __float2bfloat16(0.5f * b0 + 0.5f * b1);
  }
  if (blockIdx.x == 0) {
    if (lane == 0) {
      mu1[b * kMel + c] = s.mu;
      r1[b * kMel + c] = s.r;
    }
    if (threadIdx.x == 0) {
      gmu[b] = g_mu;
      s_out[b] = sd;
      gr_out[b] = g_r;
    }
  }
}

// ------------------------------------ the mel VJP's statistics, in chunks ---
//
// mel_bwd_stats (detector.cuh) over (row chunk, clip) blocks: stage 1 the
// clip's sums of db and db bs, stage 2 each channel's sums of da and da a,
// stage 3 the mel VJP GEMM's bf16 A, MelBwdA's value.

struct MelBwdParts {
  int nch;
  __device__ int db() const { return 0; }              // nch
  __device__ int dbbs() const { return nch; }           // nch
  __device__ int da() const { return 2 * nch; }         // nch x 128
  __device__ int daa() const { return 2 * nch + nch * kMel; }  // nch x 128
};

__global__ void __launch_bounds__(kRedBlock)
mel_bwd1(MelBwdTerms terms, float* part_all, MelChunks ch) {
  __shared__ float sh[kRedBlock / 32];
  const int b = blockIdx.y, c = threadIdx.x % kMel, lane = threadIdx.x / kMel;
  float a1 = 0.f, a2 = 0.f, db, a, bs;
  for (int i = ch.lo() + lane; i < ch.hi(); i += kMelBlockLanes) {
    terms(b, i, c, db, a, bs);
    a1 += db;
    a2 += db * bs;
  }
  a1 = block_reduce<false>(a1, sh);
  a2 = block_reduce<false>(a2, sh);
  float* part = part_all + (long long)b * kPartLd;
  const MelBwdParts o{ch.nch};
  if (threadIdx.x == 0) {
    part[o.db() + blockIdx.x] = a1;
    part[o.dbbs() + blockIdx.x] = a2;
  }
}

struct MelBwdClip {
  float mean_db, coef;
};

__device__ MelBwdClip mel_bwd_clip(const float* part, MelBwdParts o, const float* s, int b,
                                   int t) {
  const float n_el = (float)t * kMel;
  return {chunk_total(part, o.db(), o.nch) / n_el,
          chunk_total(part, o.dbbs(), o.nch) / (s[b] * (n_el - 1.f))};
}

__global__ void __launch_bounds__(kRedBlock)
mel_bwd2(MelBwdTerms terms, const float* s, float* part_all, MelChunks ch) {
  __shared__ float sh[kRedBlock];
  const int b = blockIdx.y, c = threadIdx.x % kMel, lane = threadIdx.x / kMel;
  float* part = part_all + (long long)b * kPartLd;
  const MelBwdParts o{ch.nch};
  const MelBwdClip k = mel_bwd_clip(part, o, s, b, ch.t);
  const float g_r = terms.gr[b];
  float a1 = 0.f, a2 = 0.f, db, a, bs;
  for (int i = ch.lo() + lane; i < ch.hi(); i += kMelBlockLanes) {
    terms(b, i, c, db, a, bs);
    const float da = g_r * (db - k.mean_db) - bs * k.coef;
    a1 += da;
    a2 += da * a;
  }
  put_channel(a1, sh, part, o.da());
  put_channel(a2, sh, part, o.daa());
}

__global__ void __launch_bounds__(kRedBlock)
mel_bwd3(MelBwdTerms terms, const float* s, const float* part_all, MelChunks ch, bf16* dmel) {
  const int b = blockIdx.y, c = threadIdx.x % kMel, lane = threadIdx.x / kMel;
  const float* part = part_all + (long long)b * kPartLd;
  const MelBwdParts o{ch.nch};
  const MelBwdClip k = mel_bwd_clip(part, o, s, b, ch.t);
  const float m1 = channel_total(part, o.da(), ch.nch, c) / ch.t;
  const float m2 = channel_total(part, o.daa(), ch.nch, c) / ch.t;
  const float g_r = terms.gr[b], r1 = terms.r1[b * kMel + c];
  float db, a, bs;
  for (int i = ch.lo() + lane; i < ch.hi(); i += kMelBlockLanes) {
    terms(b, i, c, db, a, bs);
    const float da = g_r * (db - k.mean_db) - bs * k.coef;
    dmel[((long long)b * ch.t + i) * kMel + c] = __float2bfloat16(r1 * (da - m1 - a * m2));
  }
}

// ---------------------------------------------------------------- chains ---

// The reflect analysis: the signal rows y (B, T-1, hop), y2 itself or,
// given m1, the synthesis u with y2 = u / peak_den(m1) -> the
// reflect-padded rows into ypad (B, T+3, hop), then their slab GEMM with
// csw (4 hop, 2P) bf16 into cs2 (B, T, 2P), on the planned tile (bm, bn).
// 2 launches.
int reflect_analysis_fwd_sm90(const float* y, const float* m1, const bf16* csw, float* ypad,
                              float* cs2, int bm, int bn, int batch, int t, int p2, int hop,
                              cudaStream_t st) {
  const int lr = t - 1;
  reflect_pad<<<elementwise_blocks((long long)batch * (lr + 2 * kPad) * hop), 256, 0, st>>>(
      y, m1, ypad, batch, lr, hop);
  int err;
  AW_LAUNCHED();
  return sm90::launch_slab_gemm(
      sm90::Problem{ypad, batch, lr + 2 * kPad, csw, 4 * hop, p2,
                    sm90::Params{t, p2, hop, /*k_row=*/hop, /*k_col=*/0, /*dir=*/+1, /*pad=*/0}},
      cs2, bm, bn, st);
}

// The detector's forward: cs (B, T, 2P) -> pred and the 16 residuals r, or
// the first CUDA error of a launch.  w.mel32 (B, T, 128), w.ha, w.hb (B,
// T2, 1024), w.mu (B, 1024) and w.small (B, 128) are its scratch, as are
// a16 (B, max(T2 1024, T P)) bf16, the products' A operands, and part (B,
// kPartLd) f32, the mel norm's partial sums; it writes each before it
// reads it.  tl: the (bm, bn) of its 5 GEMMs (mel, conv 0..3: FwdGemm from
// gMel).  16 launches.
int det_fwd_sm90(const float* cs, const DetFwdConsts& dfc, const DetRes& r,
                 const IterScratch& w, bf16* a16, float* part, const Tiles& tl, int batch, int t,
                 int p, cudaStream_t st) {
  const int t2 = t / 2;
  const long long rows_t = (long long)batch * t;
  const int rows_t2 = batch * t2;
  int err;

  mag_pass<<<elementwise_blocks(rows_t * p), 256, 0, st>>>(cs, r.nph, a16, rows_t, p);
  AW_LAUNCHED();
  AW_TRY(sm90::launch_dense_gemm(a16, dfc.melb, (int)rows_t, p, kMel,
                                 sm90::DenseStore{w.mel32, kMel}, tl.bm(0), tl.bn(0), st));
  const MelChunks mc = mel_chunks(t);
  const dim3 mel_grid(mc.nch, batch);
  mel_norm1<<<mel_grid, kRedBlock, 0, st>>>(w.mel32, r.mel, part, mc);
  mel_norm2<<<mel_grid, kRedBlock, 0, st>>>(w.mel32, part, mc);
  mel_norm3<<<mel_grid, kRedBlock, 0, st>>>(w.mel32, part, mc);
  mel_norm4<<<mel_grid, kRedBlock, 0, st>>>(w.mel32, part, mc);
  mel_norm5<<<mel_grid, kRedBlock, 0, st>>>(w.mel32, part, mc, a16, r.mu1, r.r1, r.gmu, r.gr,
                                            r.s);
  AW_LAUNCHED();
  const bf16* wt[4] = {dfc.w0t, dfc.w1t, dfc.w2t, dfc.w3t};
  bf16* ys[4] = {r.y0, r.y1, r.y2, r.y3};
  float* rins[4] = {r.rin0, r.rin1, r.rin2, r.rin3};
  float* hs[2] = {w.ha, w.hb};
  for (int i = 0; i < 4; ++i) {
    const int g = 1 + i;
    AW_TRY(sm90::launch_dense_gemm(a16, wt[i], rows_t2, kCh[i], kCh[i + 1],
                                   sm90::DenseBias{hs[i % 2], dfc.biases + i * kBiasLd,
                                                   kCh[i + 1]},
                                   tl.bm(g), tl.bn(g), st));
    in_norm_fwd<<<norm_grid(kCh[i + 1], batch), kNormCh * kNormLanes, 0, st>>>(
        hs[i % 2], t2, kCh[i + 1], w.mu, rins[i], ys[i], i == 3 ? w.small : nullptr,
        i < 3 ? a16 : nullptr);
    AW_LAUNCHED();
  }
  brh_fwd<<<batch, kMel, 0, st>>>(w.small, dfc.eo, r.pred);
  return (int)cudaGetLastError();
}

// The detector's VJP: g (B, 128), or given wm the push_extremes gradient
// with the loss out, -> dcs (B, T, 2P), or the first CUDA error of a
// launch.  It reads only the forward's residuals r and the constants:
// w.ha, w.hb (B, T2, 1024), w.mu, w.m2 (B, 1024) and w.small (B, 128) are
// its scratch, and a16 (B, max(T2 1024, T 128)) bf16 and part (B,
// kPartLd) f32 it writes before it reads them (a16 by in_norm_bwd_stats
// and mel_bwd3, part by mel_bwd1).  tl: the BwdGemm tiles, of which it
// reads the first gDetBwdGemms.  13 launches.
int det_bwd_sm90(const float* g, const float* wm, float* loss, const DetRes& r,
                 const DetBwdConsts& dbc, float* dcs, const IterScratch& w, bf16* a16,
                 float* part, const Tiles& tl, int batch, int t, int p, cudaStream_t st) {
  const int t2 = t / 2;
  const long long rows_t = (long long)batch * t;
  const int rows_t2 = batch * t2;
  int err;

  brh_bwd<<<batch, kMel, 0, st>>>(g, wm, loss, r.pred, dbc.eot, t2, w.small);
  AW_LAUNCHED();
  const bf16* ws[4] = {dbc.w0, dbc.w1, dbc.w2, dbc.w3};
  const bf16* ys[4] = {r.y0, r.y1, r.y2, r.y3};
  const float* rins[4] = {r.rin0, r.rin1, r.rin2, r.rin3};
  float* hs[2] = {w.ha, w.hb};
  const float* dx = w.small;  // layer 3's cotangent: one row, broadcast over time
  long long dx_clip = kMel, dx_row = 0;
  for (int i = 3; i >= 0; --i) {
    const int c_out = kCh[i + 1], c_in = kCh[i];
    const int gi = gConv3Vjp + (3 - i);
    in_norm_bwd_stats<<<norm_grid(c_out, batch), kNormCh * kNormLanes, 0, st>>>(
        dx, dx_clip, dx_row, ys[i], t2, c_out, w.mu, w.m2, rins[i], a16);
    AW_LAUNCHED();
    float* out = hs[i % 2];
    AW_TRY(sm90::launch_dense_gemm(a16, ws[i], rows_t2, c_out, c_in,
                                   sm90::DenseStore{out, c_in}, tl.bm(gi), tl.bn(gi), st));
    dx = out;
    dx_clip = (long long)t2 * c_in;
    dx_row = c_in;
  }
  const MelChunks mc = mel_chunks(t);
  const dim3 mel_grid(mc.nch, batch);
  const MelBwdTerms terms{dx, r.mel, r.mu1, r.r1, r.gmu, r.gr, t};
  mel_bwd1<<<mel_grid, kRedBlock, 0, st>>>(terms, part, mc);
  mel_bwd2<<<mel_grid, kRedBlock, 0, st>>>(terms, r.s, part, mc);
  mel_bwd3<<<mel_grid, kRedBlock, 0, st>>>(terms, r.s, part, mc, a16);
  AW_LAUNCHED();
  return sm90::launch_dense_gemm(a16, dbc.melbt, (int)rows_t, kMel, p,
                                 sm90::DensePhase{dcs, r.nph, p}, tl.bm(gMelVjp),
                                 tl.bn(gMelVjp), st);
}

// The reflect analysis's VJP on the slab GEMM: dcs (B, T, 2P), cswt (2P,
// 4 hop) bf16 -> the interior rows' cotangents into gy2 (B, T-1, hop), the
// four pad rows' (rounded to bf16) into gpad (B, 4, hop), on the planned
// tile (bm, bn); the fold of gpad into gy2 is the caller's.
int reflect_analysis_bwd_sm90(const float* dcs, const bf16* cswt, float* gy2, float* gpad,
                              int bm, int bn, int batch, int t, int p2, int hop,
                              cudaStream_t st) {
  const int lr = t - 1;
  return sm90::launch_slab_gemm(
      sm90::Problem{dcs, batch, t, cswt, p2, 4 * hop,
                    sm90::Params{lr + 2 * kPad, hop, p2, /*k_row=*/0, /*k_col=*/hop,
                                 /*dir=*/-1, /*pad=*/0}},
      SlabReflectBwdEpi{gy2, gpad, lr, hop}, bm, bn, st);
}

}  // namespace
