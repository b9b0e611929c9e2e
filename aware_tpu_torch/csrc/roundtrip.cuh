// The round trip's device code, for Hopper (sm_90a): the synthesis GEMM's
// operand loaders and epilogue, the peak-norm VJP's per-clip scalars and
// the phase fold, shared by roundtrip.cu (synth_norm) and iteration.cu
// (iteration_forward, iteration_step).  What they compute: roundtrip.cu.

#pragma once

#include "tile_gemm.cuh"

namespace {

constexpr int kR = 4;      // slabs: n_fft / hop
constexpr int kPad = 2;    // rows of centre padding: (n_fft / 2) / hop
constexpr float kEps = 1e-8f;

// The peak-norm's denominator m1 (1 + e) + e^2, rounded after each
// operation (never fused), as the plain version computes it; every kernel
// that divides by it takes it from here, so y2 = u / peak_den(m1) is the
// same float wherever it is formed.
__device__ __forceinline__ float peak_den(float m1) {
  return __fadd_rn(__fmul_rn(m1, 1.f + kEps), kEps * kEps);
}

// A operands: the f32 value of A[b, s, c] before its rounding to bf16.

struct SynthA {  // reim = coeffs * csin, coeffs (B, T, P), csin (B, T, 2P) bf16
  const float* coeffs;
  const __nv_bfloat16* csin;
  int t;
  int p;
  __device__ float operator()(int b, int s, int c) const {
    long long row = (long long)b * t + s;
    int cc = c < p ? c : c - p;
    return coeffs[row * p + cc] * __bfloat162float(csin[row * 2 * p + c]);
  }
};

// gcrop = g_u / env, from g, the forward's signal rows y (B, T-1, hop) and
// env (T-1, hop).  y is y2, or (from_u) the synthesis u before the
// peak-norm, and then y2 = u / cden.
struct SynthBwdA {
  const float* g;
  const float* y;
  const float* env;
  const float* scal;  // per clip: cden, q (1+e) / cden, max |y2|, ties
  int lr;
  int hop;
  bool from_u;
  __device__ float operator()(int b, int s, int c) const {
    long long i = ((long long)b * lr + s) * hop + c;
    const float* sc = scal + 4 * b;
    float yv = from_u ? y[i] / sc[0] : y[i];
    float mask = fabsf(yv) == sc[2] ? 1.f : 0.f;
    float sgn = (float)((yv > 0.f) - (yv < 0.f));
    float gu = g[i] / sc[0] - sc[1] * sgn * mask / sc[3];
    return gu / env[(long long)s * hop + c];
  }
};

// Epilogue of the synthesis GEMM: u = acc / env + y_const, written out;
// returns |u| for the per-clip maximum.
struct SynthEpi {
  float* u;
  const float* env;
  const float* y_const;
  int lr;
  int hop;
  __device__ float operator()(int b, int row, int col, float acc) const {
    long long e = (long long)row * hop + col;
    long long i = (long long)b * lr * hop + e;
    float v = acc / env[e] + y_const[i];
    u[i] = v;
    return fabsf(v);
  }
};

__device__ float block_max(float v, float* sh) {
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) sh[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kRedThreads / 32; ++w) s = fmaxf(s, sh[w]);
  return s;
}

int elementwise_blocks(long long total) {
  long long blocks = (total + 255) / 256;
  return (int)(blocks < 4096 ? blocks : 4096);
}

// The peak-norm VJP's scalars of one clip, by a whole kRedThreads block:
// sc = (cden, q (1+e) / cden, max |y2|, ties) with q = sum g * y2 over the
// clip's n elements and ties the number of elements at max |y2|.  y is
// y2, or (from_u) u, and then y2 = u / cden.
__device__ void synth_bwd_scalars_clip(const float* g, const float* y, float m1, bool from_u,
                                       float* sc, int n, float* sh) {
  const float cden = peak_den(m1);
  float q = 0.f, mx = 0.f;
  for (int i = threadIdx.x; i < n; i += kRedThreads) {
    const float yv = from_u ? y[i] / cden : y[i];
    q += g[i] * yv;
    mx = fmaxf(mx, fabsf(yv));
  }
  q = block_sum(q, sh);
  mx = block_max(mx, sh);
  float ties = 0.f;
  for (int i = threadIdx.x; i < n; i += kRedThreads)
    ties += fabsf(from_u ? y[i] / cden : y[i]) == mx;
  ties = block_sum(ties, sh);
  if (threadIdx.x == 0) {
    sc[0] = cden;
    sc[1] = q * (1.f + kEps) / cden;
    sc[2] = mx;
    sc[3] = ties;
  }
}

// g = dreim[:, :P] * csin[:, :P] + dreim[:, P:] * csin[:, P:] at element i
// of (rows, P), each product and the sum rounded as the plain version's.
__device__ __forceinline__ float phase_fold(const float* dreim, const __nv_bfloat16* csin,
                                            long long i, int p) {
  const long long base = (i / p) * 2 * p + i % p;
  return __fadd_rn(__fmul_rn(dreim[base], __bfloat162float(csin[base])),
                   __fmul_rn(dreim[base + p], __bfloat162float(csin[base + p])));
}

// dcoeffs = the phase fold of dreim (B * T rows)
__global__ void fold_phase(const float* dreim, const __nv_bfloat16* csin, float* dcoeffs,
                           long long rows, int p) {
  const long long total = rows * p;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    dcoeffs[i] = phase_fold(dreim, csin, i, p);
}

}  // namespace
