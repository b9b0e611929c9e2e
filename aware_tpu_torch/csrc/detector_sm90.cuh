// The detector's VJP on TMA and wgmma for Hopper (sm_90a), as the sm90
// chains run it: the device code that iteration_sm90.cu (the step's
// backward half, aw_iteration_step and aw_iteration_bwd) and
// detector_sm90.cu (aw_detector_bwd, aw_reflect_analysis_bwd: the
// detector_fused and analysis_detector VJPs) share, with the chunked
// reductions' helpers that the step's forward half uses too.  One
// definition of each stage: what iteration_sm90.cu says of the chain
// (two-level sums, A operands written by the pass before each product,
// partial sums finished in one fixed order) holds for every entry.
//
//   det_bwd_sm90                g -> dcs: brh_bwd, 4 x (in_norm_bwd_stats,
//                               conv VJP), 3 mel VJP statistics stages, the
//                               mel VJP with the phase epilogue (13 launches)
//   reflect_analysis_bwd_sm90   dcs -> gy2 and the pad rows' cotangents: the
//                               slab GEMM with SlabReflectBwdEpi (1 launch)

#pragma once

#include "dense_gemm_sm90.cuh"
#include "iteration.cuh"
#include "slab_gemm_sm90.cuh"

namespace {

constexpr int kRedBlock = 256;  // threads of the chunked reductions and passes
constexpr int kPartLd = 4096;   // floats of one clip's partial sums
constexpr int kMelChunks = 15;  // row chunks of the mel stages: 2 x 15 x 128 + 30 partials
constexpr int kMinFrames = 8;   // distinct reflect-pad boundary rows

// The planned tiles, (bm, bn) per GEMM in launch order: the forward
// half's seven, then the backward half's (the step takes both lists in
// one array, aw_iteration_fwd_sm90 the first, aw_iteration_bwd the
// second, aw_detector_bwd the second's first five).
enum FwdGemm { gSynth, gAnalysis, gMel, gConv0, gConv1, gConv2, gConv3, gFwdGemms };
enum BwdGemm {
  gConv3Vjp, gConv2Vjp, gConv1Vjp, gConv0Vjp, gMelVjp, gAnalysisVjp, gSynthVjp, gBwdGemms
};
constexpr int gDetBwdGemms = gMelVjp + 1;

struct Tiles {
  const int* bmbn;  // (bm, bn) pairs
  int bm(int g) const { return bmbn[2 * g]; }
  int bn(int g) const { return bmbn[2 * g + 1]; }
};

// The sum (or max) over a kRedBlock block in a fixed order: every thread
// gets it.
template <bool kIsMax>
__device__ float block_reduce(float v, float* sh) {
  for (int o = 16; o > 0; o /= 2) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kIsMax ? fmaxf(v, w) : v + w;
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) sh[threadIdx.x / 32] = v;
  __syncthreads();
  float s = sh[0];
  for (int w = 1; w < kRedBlock / 32; ++w) s = kIsMax ? fmaxf(s, sh[w]) : s + sh[w];
  return s;
}

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

#define AW_TRY(call)               \
  if ((err = (call)) != 0) return err
#define AW_LAUNCHED() AW_TRY((int)cudaGetLastError())

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
