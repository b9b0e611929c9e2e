// Fused overlap-add -> crop -> envelope -> double peak-norm, and its VJP,
// for Hopper (sm_90a).
//
// They replace the two Pallas TPU kernels of aware_tpu/ops/pallas/ola_norm.py,
// the opt-in use_pallas_ola round trip of the JAX package's embed solver:
//
//   aw_ola_fwd <- ola_normalize forward (_ola_fwd_impl, _fwd_kernel)
//   aw_ola_bwd <- ola_normalize VJP     (_ola_vjp_bwd,  _bwd_kernel)
//
// What they compute, per clip b of a batch (R = n_fft / hop = 4 slabs,
// PAD = (n_fft / 2) / hop = 2 rows of centre crop, e = 1e-8, lr = T - 1):
//
//   forward:  acc[i]  = sum_{k<4, 0<=i-k<T} wf[i-k, k*hop:(k+1)*hop], in k = 0..3
//                       order from 0 (the TPU kernel's row adds),
//             y_env[j] = acc[j + PAD] / env[j]                       for j < lr,
//             m1 = max |y_env|,  c = (m1 + e) * (m1 / (m1 + e) + e),  y2 = y_env / c;
//   VJP:      q = sum g * y2,  m2b = max |y2|,  mask = |y2| == m2b,  ties = sum mask,
//             n = m1 / (m1 + e),  K = (n + e) * q * (e + c) / (c * c),
//             g_env = g / c - K * sign(y2) * mask / ties,   grows[j + PAD] = g_env[j] / env[j]
//             (zero elsewhere in T + 3 rows),  dwf[t, k*hop:(k+1)*hop] = grows[t + k].
//
// The tie mask comes from y2 itself (ola_norm.py:95-99): rebuilding y_env
// as y2 * c rounds, can match no element and would divide by ties = 0.
// sign(0) = 0, so a silent clip (m1 = 0, c = 1e-16, every element a tie)
// gets the finite g / c.
//
// The TPU kernel holds a whole clip in VMEM, one grid step per clip, and
// carries its sums there.  Here the clip is spread over blocks of 1024
// elements: the forward is one elementwise launch that adds the frame
// slices, divides by the envelope and atomicMax-es the float bits of
// |y_env| per clip (m1 is zeroed first), then one launch that scales by
// c.  The VJP is three launches: per-block partial max |y2| and sum g*y2,
// then every block finishes its clip's partials in one fixed order (no
// float atomics, so a run repeats bit for bit) and counts its ties with an
// integer atomicAdd, then one elementwise launch that writes each row of
// grows into its four places of dwf.  Every float operation is an _rn
// intrinsic in the TPU kernel's order, so that nothing contracts into an
// FMA: the forward rounds as the TPU kernel does.
//
// Bytes bound both: at B = 8, T = 626 the forward reads 20.5 MB of frames
// and 0.64 MB of envelope and writes 5.1 MB (7.8 us at 3.35 TB/s), the
// VJP reads 10.9 MB and writes 20.5 MB (9.4 us); the arithmetic is a few
// operations per element.
//
// Each kernel runs on the caller's stream and allocates nothing; each C
// entry returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kElems = 4;  // elements per thread
constexpr int kChunk = kThreads * kElems;  // elements per block (ops/kernels/ola_norm.py CHUNK)
constexpr int kR = 4;
constexpr int kPad = 2;
constexpr float kEps = 1e-8f;

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};

// The reduction of v over the block, returned to every thread.  The xor
// butterfly leaves the same bits in every lane (each step combines a pair
// of lanes both ways round, and the ops commute), so the result does not
// depend on the thread that reads it.
template <class Op>
__device__ float block_reduce(float v, float identity, Op op) {
  __shared__ float sh[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // a previous call's readers are done with sh
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = lane < kWarps ? sh[lane] : identity;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ long long elem(int e) {
  return (long long)blockIdx.x * kChunk + e * kThreads + threadIdx.x;
}

// c = (m1 + e) * (m1 / (m1 + e) + e), the collapsed double peak-norm scale.
__device__ __forceinline__ float peak_scale(float m1, float* n_out) {
  const float c1 = __fadd_rn(m1, kEps);
  const float n = __fdiv_rn(m1, c1);
  *n_out = n;
  return __fmul_rn(c1, __fadd_rn(n, kEps));
}

// wf (B, T, 4 hop), env (lr, hop) -> y (B, lr, hop) = y_env, m1 bits (B,) by atomicMax.
__global__ void ola_fwd_rows(const float* __restrict__ wf, const float* __restrict__ env,
                             float* __restrict__ y, unsigned int* m1_bits, int t, int hop) {
  const int b = blockIdx.y;
  const long long n = (long long)(t - 1) * hop;
  const long long nfft = (long long)kR * hop;
  const float* wfb = wf + (long long)b * t * nfft;
  float mx = 0.f;
  for (int e = 0; e < kElems; ++e) {
    const long long idx = elem(e);
    if (idx >= n) break;
    const int j = (int)(idx / hop), c = (int)(idx % hop);
    const int i = j + kPad;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int f = i - k;
      if (f >= 0 && f < t) acc = __fadd_rn(acc, wfb[f * nfft + k * hop + c]);
    }
    const float v = __fdiv_rn(acc, env[idx]);
    y[(long long)b * n + idx] = v;
    mx = fmaxf(mx, fabsf(v));
  }
  mx = block_reduce(mx, 0.f, MaxOp());
  if (threadIdx.x == 0) atomicMax(m1_bits + b, __float_as_uint(mx));
}

// y (B, lr * hop) /= c(m1[b]) in place.
__global__ void ola_fwd_scale(float* __restrict__ y, const float* __restrict__ m1, long long n) {
  const int b = blockIdx.y;
  float nn;
  const float c = peak_scale(m1[b], &nn);
  for (int e = 0; e < kElems; ++e) {
    const long long idx = elem(e);
    if (idx >= n) break;
    y[(long long)b * n + idx] = __fdiv_rn(y[(long long)b * n + idx], c);
  }
}

// part (B, nblk, 2): each block's max |y2| and sum g * y2.
__global__ void ola_bwd_partials(const float* __restrict__ g, const float* __restrict__ y2,
                                 float* __restrict__ part, long long n) {
  const int b = blockIdx.y;
  float mx = 0.f, s = 0.f;
  for (int e = 0; e < kElems; ++e) {
    const long long idx = elem(e);
    if (idx >= n) break;
    const float yv = y2[(long long)b * n + idx];
    s = __fadd_rn(s, __fmul_rn(g[(long long)b * n + idx], yv));
    mx = fmaxf(mx, fabsf(yv));
  }
  mx = block_reduce(mx, 0.f, MaxOp());
  s = block_reduce(s, 0.f, SumOp());
  if (threadIdx.x == 0) {
    float* p = part + ((long long)b * gridDim.x + blockIdx.x) * 2;
    p[0] = mx;
    p[1] = s;
  }
}

// Every block reduces its clip's nblk partials in the same order, counts
// the ties |y2| == max |y2| in its chunk into ties[b]; block 0 writes
// scal (B, 2) = (max |y2|, sum g * y2).
__global__ void ola_bwd_ties(const float* __restrict__ y2, const float* __restrict__ part,
                             float* __restrict__ scal, int* ties, long long n) {
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const float* pb = part + (long long)b * nblk * 2;
  float mx = 0.f, s = 0.f;
  for (int i = threadIdx.x; i < nblk; i += kThreads) {
    mx = fmaxf(mx, pb[2 * i]);
    s = __fadd_rn(s, pb[2 * i + 1]);
  }
  mx = block_reduce(mx, 0.f, MaxOp());
  s = block_reduce(s, 0.f, SumOp());
  float count = 0.f;  // exact: at most kElems per thread
  for (int e = 0; e < kElems; ++e) {
    const long long idx = elem(e);
    if (idx >= n) break;
    if (fabsf(y2[(long long)b * n + idx]) == mx) count += 1.f;
  }
  count = block_reduce(count, 0.f, SumOp());
  if (threadIdx.x == 0) {
    if (count > 0.f) atomicAdd(ties + b, (int)count);
    if (blockIdx.x == 0) {
      scal[2 * b] = mx;
      scal[2 * b + 1] = s;
    }
  }
}

// dwf (B, T, 4 hop): row i of grows (T + 3 rows of hop), computed once,
// written to dwf[i - k, k*hop:(k+1)*hop] for each k with 0 <= i - k < T.
__global__ void ola_bwd_rows(const float* __restrict__ g, const float* __restrict__ y2,
                             const float* __restrict__ env, const float* __restrict__ m1,
                             const float* __restrict__ scal, const int* __restrict__ ties,
                             float* __restrict__ dwf, int t, int hop) {
  const int b = blockIdx.y;
  const int lr = t - 1;
  const long long n = (long long)lr * hop;
  const long long rows = (long long)(t + kR - 1) * hop;
  const long long nfft = (long long)kR * hop;
  float nn;
  const float c = peak_scale(m1[b], &nn);
  const float m2b = scal[2 * b];
  const float p = __fmul_rn(__fadd_rn(nn, kEps), scal[2 * b + 1]);
  const float kc = __fdiv_rn(__fmul_rn(p, __fadd_rn(kEps, c)), __fmul_rn(c, c));
  const float nties = (float)ties[b];
  float* out = dwf + (long long)b * t * nfft;
  for (int e = 0; e < kElems; ++e) {
    const long long idx = elem(e);
    if (idx >= rows) break;
    const int i = (int)(idx / hop), col = (int)(idx % hop);
    const int j = i - kPad;
    float v = 0.f;
    if (j >= 0 && j < lr) {
      const long long src = (long long)j * hop + col;
      const float yv = y2[(long long)b * n + src];
      const float sgn = yv > 0.f ? 1.f : (yv < 0.f ? -1.f : 0.f);
      const float mask = fabsf(yv) == m2b ? 1.f : 0.f;
      const float tie = __fdiv_rn(__fmul_rn(__fmul_rn(kc, sgn), mask), nties);
      const float g_env = __fsub_rn(__fdiv_rn(g[(long long)b * n + src], c), tie);
      v = __fdiv_rn(g_env, env[src]);
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int f = i - k;
      if (f >= 0 && f < t) out[f * nfft + k * hop + col] = v;
    }
  }
}

inline dim3 grid_for(long long n, int batch) {
  return dim3((unsigned)((n + kChunk - 1) / kChunk), (unsigned)batch);
}

}  // namespace

extern "C" {

// wframes (B, T, 4 hop) f32, env (T-1, hop) f32 -> y2 (B, T-1, hop) f32, m1 (B,) f32.
int aw_ola_fwd(const float* wframes, const float* env, float* y2, float* m1, int batch, int t,
               int hop, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)(t - 1) * hop;
  cudaMemsetAsync(m1, 0, sizeof(float) * batch, st);
  ola_fwd_rows<<<grid_for(n, batch), kThreads, 0, st>>>(
      wframes, env, y2, reinterpret_cast<unsigned int*>(m1), t, hop);
  ola_fwd_scale<<<grid_for(n, batch), kThreads, 0, st>>>(y2, m1, n);
  return (int)cudaGetLastError();
}

// g, y2 (B, T-1, hop) f32, env (T-1, hop) f32, m1 (B,) f32; scratch part
// (B, ceil((T-1) hop / 1024), 2) f32, scal (B, 2) f32, ties (B,) int32
// -> dwf (B, T, 4 hop) f32.
int aw_ola_bwd(const float* g, const float* y2, const float* env, const float* m1, float* part,
               float* scal, int* ties, float* dwf, int batch, int t, int hop, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)(t - 1) * hop;
  cudaMemsetAsync(ties, 0, sizeof(int) * batch, st);
  ola_bwd_partials<<<grid_for(n, batch), kThreads, 0, st>>>(g, y2, part, n);
  ola_bwd_ties<<<grid_for(n, batch), kThreads, 0, st>>>(y2, part, scal, ties, n);
  ola_bwd_rows<<<grid_for((long long)(t + kR - 1) * hop, batch), kThreads, 0, st>>>(
      g, y2, env, m1, scal, ties, dwf, t, hop);
  return (int)cudaGetLastError();
}

}  // extern "C"
