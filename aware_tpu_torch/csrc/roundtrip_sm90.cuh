// The round trip's synthesis on TMA and wgmma for Hopper (sm_90a), both
// directions, as the sm90 chains run them: the device code that
// iteration_sm90.cu (the step's two halves: aw_iteration_step,
// aw_iteration_fwd_sm90, aw_iteration_bwd) and roundtrip_sm90.cu
// (aw_synth_norm_fwd, aw_synth_norm_bwd: the synth_norm forward and VJP)
// share.  One definition of each stage; what iteration_sm90.cu says of
// the chain (A operands written by the pass before each product,
// two-level sums, partial sums finished in one fixed order) holds for
// every entry.
//
//   synth_fwd_sm90     ct -> u (B, T-1, hop) and m1 = max |u|: reim_pass,
//                      then the slab GEMM with SlabSynthEpi (2 launches)
//   synth_vjp_sm90<V>  the cotangent of y2 -> dreim (B, T, 2P): the
//                      peak-norm VJP's scalars over (chunk, clip) blocks
//                      (fold_partial, ties_partial), gcrop_pass, then the
//                      slab GEMM (4 launches)
//
// V fixes at compile time what the peak-norm VJP reads (StepVjp,
// SynthVjp), so that neither variant branches in its loops.

#pragma once

#include "chain_sm90.cuh"
#include "roundtrip.cuh"
#include "slab_gemm_sm90.cuh"

namespace {

constexpr int kFoldChunk = 4096;  // samples of a fold / scalar block

// ------------------------------------------------------ the synthesis ---

// reim = ct csin (B T rows of 2P, f32, SynthA's value); m1 = 0 for the
// synthesis's atomicMax.
__global__ void reim_pass(const float* ct, const __nv_bfloat16* csin, float* reim, float* m1,
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

// The synthesis: ct (B, T, P) f32 and csin (B, T, 2P) bf16 -> reim (B, T,
// 2P) f32 and m1 = 0 (reim_pass), then the slab GEMM of reim with ab (2P,
// 4 hop) bf16 on the planned tile (bm, bn), whose epilogue writes u =
// acc / env + y_const into u (B, T-1, hop) and folds max |u|'s bits into
// m1 (B,).  2 launches; the first CUDA error of a launch, or 0.
int synth_fwd_sm90(const float* ct, const __nv_bfloat16* csin, const __nv_bfloat16* ab,
                   const float* env, const float* y_const, float* reim, float* u, float* m1,
                   int bm, int bn, int batch, int t, int p, int hop, cudaStream_t st) {
  const int lr = t - 1, p2 = 2 * p;
  const long long rows_t = (long long)batch * t;
  int err;
  reim_pass<<<elementwise_blocks(rows_t * p2), 256, 0, st>>>(ct, csin, reim, m1, rows_t, p,
                                                             batch);
  AW_LAUNCHED();
  return sm90::launch_slab_gemm(
      sm90::Problem{reim, batch, t, ab, p2, 4 * hop,
                    sm90::Params{lr, hop, p2, /*k_row=*/0, /*k_col=*/hop, /*dir=*/-1, /*pad=*/kPad}},
      sm90::SlabSynthEpi{u, env, y_const, (unsigned int*)m1, lr, hop}, bm, bn, st);
}

// ---------------------------------------------- the synthesis's VJP ---
//
// fold_scalars (iteration.cu) over (sample chunk, clip) blocks: stage 1
// sums q = g y2 and max |y2| of the chunk (in the step, first folding the
// reflect pad rows' cotangents into gy2: each sample of a chunk gets at
// most one, as in reflect_fold_clip); stage 2 counts the chunk's ties at
// the clip's max; the gcrop pass finishes the scalars (block 0 of a clip
// writes them to scal) and writes the synthesis VJP's A.  Partials:
// part[3 k + {q, max, ties}].

// What the peak-norm VJP's stages read.  The step keeps u, the synthesis
// before the peak-norm, and forms y2 = u / cden itself; the reflect pad
// before its analysis leaves cotangents on four pad rows, folded into gy2
// first (and written back).  synth_norm's VJP keeps y2 itself and has no
// reflect pad.
struct StepVjp {
  static constexpr bool kFold = true;
  static constexpr bool kFromU = true;
};
struct SynthVjp {
  static constexpr bool kFold = false;
  static constexpr bool kFromU = false;
};

// y2 at sample f of a clip's signal rows y (u or y2, by V).
template <class V>
__device__ __forceinline__ float y2_at(const float* y, long long f, float cden) {
  if constexpr (V::kFromU) {
    return y[f] / cden;
  } else {
    return y[f];
  }
}

struct FoldChunks {
  long long len;  // samples of a clip: lr hop
  int nch;
  __device__ long long lo() const { return blockIdx.x * (long long)kFoldChunk; }
  __device__ long long hi() const {
    return min(len, (long long)(blockIdx.x + 1) * kFoldChunk);
  }
};

// gy2 is written only by the step's fold (V::kFold); gpad is read only by it.
template <class V>
__global__ void __launch_bounds__(kRedBlock)
fold_partial(const float* gpad, float* gy2, const float* y, const float* m1, float* part_all,
             FoldChunks ch, int hop) {
  __shared__ float sh[kRedBlock / 32];
  const int b = blockIdx.y;
  float* g = gy2 + b * ch.len;
  const float* yb = y + b * ch.len;
  const float cden = peak_den(m1[b]);
  float q = 0.f, mx = 0.f;
  for (long long f = ch.lo() + threadIdx.x; f < ch.hi(); f += kRedBlock) {
    float gv = g[f];
    if constexpr (V::kFold) {
      const long long half = (long long)kPad * hop;
      const float* gp = gpad + (long long)b * 2 * half;
      if (f >= 1 && f <= half) {
        gv += gp[half - f];
        g[f] = gv;
      } else if (f >= ch.len - 1 - half && f <= ch.len - 2) {
        gv += gp[half + (ch.len - 2 - f)];
        g[f] = gv;
      }
    }
    const float yv = y2_at<V>(yb, f, cden);
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

template <class V>
__global__ void __launch_bounds__(kRedBlock)
ties_partial(const float* y, const float* m1, float* part_all, FoldChunks ch) {
  __shared__ float sh[kRedBlock / 32];
  const int b = blockIdx.y;
  float* part = part_all + (long long)b * kPartLd;
  const float mx = clip_max(part, ch.nch);
  const float cden = peak_den(m1[b]);
  const float* yb = y + b * ch.len;
  float ties = 0.f;
  for (long long f = ch.lo() + threadIdx.x; f < ch.hi(); f += kRedBlock)
    ties += fabsf(y2_at<V>(yb, f, cden)) == mx;
  ties = block_reduce<false>(ties, sh);
  if (threadIdx.x == 0) part[3 * blockIdx.x + 2] = ties;
}

// gcrop = g_u / env (B, lr, hop), SynthBwdA's value, from the (folded)
// gy2, the signal rows y and the scalars sc = (cden, q (1+e) / cden,
// max |y2|, ties).
template <class V>
__global__ void __launch_bounds__(kRedBlock)
gcrop_pass(const float* gy2, const float* y, const float* m1, const float* env,
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
    const float yv = y2_at<V>(y, off + f, sc[0]);
    const float mask = fabsf(yv) == sc[2] ? 1.f : 0.f;
    const float sgn = (float)((yv > 0.f) - (yv < 0.f));
    const float gu = gy2[off + f] / sc[0] - sc[1] * sgn * mask / sc[3];
    gcrop[off + f] = gu / env[f];
  }
}

// The (T-1) hop samples of a clip fit the fold's partial sums.
bool fold_fits(int t, int hop) {
  return (long long)(t - 1) * hop <= (long long)kFoldChunk * (kPartLd / 3);
}

// The synthesis's VJP, from gy2 (B, T-1, hop), the cotangent of y2, the
// forward's signal rows y (B, T-1, hop) (u or y2, by V) and m1 (B,) ->
// dreim (B, T, 2P) f32: the peak-norm VJP's scalars over (chunk, clip)
// blocks into part (B, kPartLd) (with V::kFold, first the fold of gpad
// (B, 4, hop), the pad rows' cotangents, into gy2), gcrop = g_u / env into
// gcrop (B, T-1, hop) and the scalars into scal (B, 4), then the slab GEMM
// of gcrop with abt (4 hop, 2P) bf16 on the planned tile (bm, bn).  4
// launches; the first CUDA error of a launch, or 0.
template <class V>
int synth_vjp_sm90(const float* gpad, float* gy2, const float* y, const float* m1,
                   const float* env, const __nv_bfloat16* abt, float* part, float* scal,
                   float* gcrop, float* dreim, int bm, int bn, int batch, int t, int p2, int hop,
                   cudaStream_t st) {
  const int lr = t - 1;
  int err;
  const FoldChunks fc{(long long)lr * hop, (int)(((long long)lr * hop + kFoldChunk - 1) / kFoldChunk)};
  const dim3 fold_grid(fc.nch, batch);
  fold_partial<V><<<fold_grid, kRedBlock, 0, st>>>(gpad, gy2, y, m1, part, fc, hop);
  ties_partial<V><<<fold_grid, kRedBlock, 0, st>>>(y, m1, part, fc);
  gcrop_pass<V><<<fold_grid, kRedBlock, 0, st>>>(gy2, y, m1, env, part, scal, gcrop, fc);
  AW_LAUNCHED();
  return sm90::launch_slab_gemm(
      sm90::Problem{gcrop, batch, lr, abt, 4 * hop, p2,
                    sm90::Params{t, p2, hop, /*k_row=*/hop, /*k_col=*/0, /*dir=*/+1, /*pad=*/kPad}},
      dreim, bm, bn, st);
}

}  // namespace
