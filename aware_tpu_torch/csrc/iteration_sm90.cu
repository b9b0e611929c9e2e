// The whole solver step for Hopper (sm_90a) on TMA and wgmma: the port's
// aw_iteration_step, and its backward half alone as aw_iteration_bwd.
//
//   aw_iteration_step <- aware_tpu/ops/pallas/iteration.py iteration_step
//                        (pallas_call :513, _step_kernel :341)
//   aw_iteration_bwd  <- the iteration_forward VJP (pallas_call :285,
//                        _iter_bwd_kernel :193): the step's backward half
//                        from a given g, then the phase fold
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
// two halves (step_fwd: 20 launches, step_bwd: 18) and the epilogue;
// aw_iteration_bwd is step_bwd from g, reading only the residuals, then
// fold_phase: 19 launches.  Its first chain, aw_iteration_bwd_wmma
// (iteration.cu, 15 launches on the WMMA template), measured 1.62 ms at
// B = 8, T = 626 (PERF.md), 81x its 0.020 ms bound.

#include "dense_gemm_sm90.cuh"
#include "iteration.cuh"
#include "slab_gemm_sm90.cuh"

namespace {

constexpr int kRedBlock = 256;  // threads of the chunked reductions and passes
constexpr int kPartLd = 4096;   // floats of one clip's partial sums
constexpr int kFoldChunk = 4096;  // samples of a fold / scalar block
constexpr int kMelChunks = 15;    // row chunks of the mel stages: 2 x 15 x 128 + 30 partials

// The step's own buffers: a16 (B, max(T2 1024, T P)) bf16, the detector
// GEMMs' A operands in turn; rows (B, T+3, hop) f32, the reflect-padded
// y2, then gcrop (B, T-1, hop); part (B, kPartLd) f32, partial sums.
struct StepOps {
  bf16* a16;
  float* rows;
  float* part;
};

// The planned tiles, (bm, bn) per GEMM in launch order: the forward
// half's seven, then the backward half's (the step takes both lists in
// one array, aw_iteration_bwd the second).
enum FwdGemm { gSynth, gAnalysis, gMel, gConv0, gConv1, gConv2, gConv3, gFwdGemms };
enum BwdGemm {
  gConv3Vjp, gConv2Vjp, gConv1Vjp, gConv0Vjp, gMelVjp, gAnalysisVjp, gSynthVjp, gBwdGemms
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

// The reflect-padded y2 (B, lr + 4, hop): padded row j holds ReflectA's
// row j - 2, u / peak_den(m1) at the reflected sample.
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
// mel_norm_fwd's reductions (detector.cuh) over (row chunk, clip) blocks of
// kRedBlock threads: channel c = thread % 128, two row lanes.  Stage k
// writes its partials to part (the clip's kPartLd floats) at its own
// offset, and every later block of the clip finishes them in chunk order.
// Chunks are `rc` rows, rc even, so that a pool row's two frames share a
// block.

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

struct Tiles {
  const int* bmbn;  // (bm, bn) pairs
  int bm(int g) const { return bmbn[2 * g]; }
  int bn(int g) const { return bmbn[2 * g + 1]; }
};

// The (T-1) hop samples of a clip fit the fold's partial sums.
bool fold_fits(int t, int hop) {
  return (long long)(t - 1) * hop <= (long long)kFoldChunk * (kPartLd / 3);
}

#define AW_TRY(call)               \
  if ((err = (call)) != 0) return err
#define AW_LAUNCHED() AW_TRY((int)cudaGetLastError())

// The forward half: ct -> u, m1, pred and the detector's residuals, or
// the first CUDA error of a launch.  tl: the FwdGemm tiles.
int step_fwd(const StepArgs& s, const StepOps& o, const Tiles& tl, int batch, int t, int p,
             int hop, cudaStream_t st) {
  const int lr = t - 1, t2 = t / 2, p2 = 2 * p;
  const RoundConsts& c = s.c;
  const IterScratch& w = s.w;
  const DetRes& r = s.r;
  int err;

  // ---- the round trip forward
  const long long rows_t = (long long)batch * t;
  reim_pass<<<elementwise_blocks(rows_t * p2), 256, 0, st>>>(s.ct, c.csin, w.big, s.m1, rows_t,
                                                             p, batch);
  AW_LAUNCHED();
  AW_TRY(sm90::launch_slab_gemm(
      sm90::Problem{w.big, batch, t, c.ab, p2, 4 * hop,
                    sm90::Params{lr, hop, p2, /*k_row=*/0, /*k_col=*/hop, /*dir=*/-1, /*pad=*/kPad}},
      sm90::SlabSynthEpi{s.u, c.env, c.y_const, (unsigned int*)s.m1, lr, hop}, tl.bm(gSynth),
      tl.bn(gSynth), st));
  reflect_pad<<<elementwise_blocks((long long)batch * (lr + 2 * kPad) * hop), 256, 0, st>>>(
      s.u, s.m1, o.rows, batch, lr, hop);
  AW_LAUNCHED();
  AW_TRY(sm90::launch_slab_gemm(
      sm90::Problem{o.rows, batch, lr + 2 * kPad, c.csw, 4 * hop, p2,
                    sm90::Params{t, p2, hop, /*k_row=*/hop, /*k_col=*/0, /*dir=*/+1, /*pad=*/0}},
      w.big, tl.bm(gAnalysis), tl.bn(gAnalysis), st));

  // ---- the detector forward
  mag_pass<<<elementwise_blocks(rows_t * p), 256, 0, st>>>(w.big, r.nph, o.a16, rows_t, p);
  AW_LAUNCHED();
  AW_TRY(sm90::launch_dense_gemm(o.a16, s.dfc.melb, (int)rows_t, p, kMel,
                                 sm90::DenseStore{w.mel32, kMel}, tl.bm(gMel), tl.bn(gMel), st));
  const MelChunks mc = mel_chunks(t);
  const dim3 mel_grid(mc.nch, batch);
  mel_norm1<<<mel_grid, kRedBlock, 0, st>>>(w.mel32, r.mel, o.part, mc);
  mel_norm2<<<mel_grid, kRedBlock, 0, st>>>(w.mel32, o.part, mc);
  mel_norm3<<<mel_grid, kRedBlock, 0, st>>>(w.mel32, o.part, mc);
  mel_norm4<<<mel_grid, kRedBlock, 0, st>>>(w.mel32, o.part, mc);
  mel_norm5<<<mel_grid, kRedBlock, 0, st>>>(w.mel32, o.part, mc, o.a16, r.mu1, r.r1, r.gmu,
                                            r.gr, r.s);
  AW_LAUNCHED();
  const bf16* wt[4] = {s.dfc.w0t, s.dfc.w1t, s.dfc.w2t, s.dfc.w3t};
  bf16* ys[4] = {r.y0, r.y1, r.y2, r.y3};
  float* rins[4] = {r.rin0, r.rin1, r.rin2, r.rin3};
  float* hs[2] = {w.ha, w.hb};
  const int rows_t2 = batch * t2;
  for (int i = 0; i < 4; ++i) {
    const int g = gConv0 + i;
    AW_TRY(sm90::launch_dense_gemm(o.a16, wt[i], rows_t2, kCh[i], kCh[i + 1],
                                   sm90::DenseBias{hs[i % 2], s.dfc.biases + i * kBiasLd,
                                                   kCh[i + 1]},
                                   tl.bm(g), tl.bn(g), st));
    in_norm_fwd<<<norm_grid(kCh[i + 1], batch), kNormCh * kNormLanes, 0, st>>>(
        hs[i % 2], t2, kCh[i + 1], w.mu, rins[i], ys[i], i == 3 ? w.small : nullptr,
        i < 3 ? o.a16 : nullptr);
    AW_LAUNCHED();
  }
  brh_fwd<<<batch, kMel, 0, st>>>(w.small, s.dfc.eo, r.pred);
  return (int)cudaGetLastError();
}

// The backward half: g (B, 128), or given wm the push_extremes gradient
// with the loss out, -> dreim (B, T, 2P) in w.big, or the first CUDA error
// of a launch.  It reads only the forward's residuals (r, u, m1) and the
// constants: every StepOps buffer it reads, it has written itself
// (o.a16 by in_norm_bwd_stats and mel_bwd3, o.part by mel_bwd1 and
// fold_partial, o.rows by gcrop_pass).  tl: the BwdGemm tiles.
int step_bwd(const float* g, const float* wm, float* loss, const DetRes& r, const float* u,
             const float* m1, const RoundConsts& c, const DetBwdConsts& dbc,
             const IterScratch& w, const StepOps& o, const Tiles& tl, int batch, int t, int p,
             int hop, cudaStream_t st) {
  const int lr = t - 1, t2 = t / 2, p2 = 2 * p;
  const long long rows_t = (long long)batch * t;
  const int rows_t2 = batch * t2;
  int err;

  // ---- the detector backward
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
        dx, dx_clip, dx_row, ys[i], t2, c_out, w.mu, w.m2, rins[i], o.a16);
    AW_LAUNCHED();
    float* out = hs[i % 2];
    AW_TRY(sm90::launch_dense_gemm(o.a16, ws[i], rows_t2, c_out, c_in,
                                   sm90::DenseStore{out, c_in}, tl.bm(gi), tl.bn(gi), st));
    dx = out;
    dx_clip = (long long)t2 * c_in;
    dx_row = c_in;
  }
  const MelChunks mc = mel_chunks(t);
  const dim3 mel_grid(mc.nch, batch);
  const MelBwdTerms terms{dx, r.mel, r.mu1, r.r1, r.gmu, r.gr, t};
  mel_bwd1<<<mel_grid, kRedBlock, 0, st>>>(terms, o.part, mc);
  mel_bwd2<<<mel_grid, kRedBlock, 0, st>>>(terms, r.s, o.part, mc);
  mel_bwd3<<<mel_grid, kRedBlock, 0, st>>>(terms, r.s, o.part, mc, o.a16);
  AW_LAUNCHED();
  AW_TRY(sm90::launch_dense_gemm(o.a16, dbc.melbt, (int)rows_t, kMel, p,
                                 sm90::DensePhase{w.big, r.nph, p}, tl.bm(gMelVjp),
                                 tl.bn(gMelVjp), st));

  // ---- the round trip backward
  AW_TRY(sm90::launch_slab_gemm(
      sm90::Problem{w.big, batch, t, c.cswt, p2, 4 * hop,
                    sm90::Params{lr + 2 * kPad, hop, p2, /*k_row=*/0, /*k_col=*/hop,
                                 /*dir=*/-1, /*pad=*/0}},
      SlabReflectBwdEpi{w.gy2, w.gpad, lr, hop}, tl.bm(gAnalysisVjp), tl.bn(gAnalysisVjp),
      st));
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
  AW_TRY(step_fwd(s, o, tl, batch, t, p, hop, st));
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
  if (!a.done() || n_tiles != 2 * (gFwdGemms + gBwdGemms) || t < 8 || !fold_fits(t, hop))
    return (int)cudaErrorInvalidValue;
  return step_chain(s, o, Tiles{tiles}, batch, t, p, hop, NadamCoefs{c_m, b2, c_v, eps},
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
  if (!a.done() || n_tiles != 2 * gBwdGemms || t < 8 || !fold_fits(t, hop))
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
