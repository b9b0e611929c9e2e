// The attack suite's IIR filters as sequential scans, for Hopper (sm_90a).
//
// Not TPU kernels: the JAX package runs these recurrences as lax.scan
// (aware_tpu/ops/iir.py:247 lfilter, :304 sosfilt), one step a sample.
// The port's attacks low_pass (lfilter, order 6), high_pass (sosfilt,
// order 4) and bandstop_200Hz (sosfiltfilt: two sosfilt passes over the
// odd-extended clip, order 4 bandstop) run them here:
//
//   aw_lfilter:  direct form II transposed, per lane and sample
//                  yn = b0 xn + z0,
//                  z_i = (b_{i+1} xn - a_{i+1} yn) + z_{i+1}   (z_{n-1} = 0),
//                with b and a divided by a0 on the host in float64, then cast;
//   aw_sosfilt:  a cascade of DF2T biquads, per lane, sample and section
//                (v = xn into the first, each section's y into the next)
//                  y  = b0 v + z0,
//                  z0 = (b1 v - a1 y) + z1,
//                  z1 = b2 v - a2 y,
//                with a1, a2 divided by a0.
//
// Float32 in the JAX step's order: every operation an _rn intrinsic, so
// that nothing contracts into an FMA, and the plain torch loops of
// ops/kernels/iir.py give the same operations.  Optional initial state zi
// per lane (filtfilt's edge conditions); the final state is not returned.
//
// Design.  The recurrence is serial in time, so a lane's samples are one
// dependent chain: one thread per lane, its coefficients and state in
// registers (the state length and section count are template parameters,
// so the arrays stay in registers), the samples of a lane read in chunks
// of kChunk with the next chunk's loads issued before the current chunk's
// chain, so that the chain waits for no load.  The bound is that chain,
// not bytes: about 5 dependent float operations a sample for lfilter's
// step (the next yn needs z0, which needs yn) and as many a section for
// sosfilt's; the bytes (each sample read and written once) would take
// microseconds.  A parallel scan over chunks (the recurrence is linear in
// its state) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxState = 16;     // lfilter's state length n-1, at most
constexpr int kMaxSections = 16;  // sosfilt's sections, at most
constexpr int kChunk = 32;        // samples a lane loads ahead
constexpr int kThreads = 64;      // lanes a block

__device__ __forceinline__ void load_chunk(const float* __restrict__ x, int c0, int length,
                                           float (&v)[kChunk]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) v[j] = (c0 + j < length) ? __ldg(x + c0 + j) : 0.f;
}

// x (B, L), coefs [b (NS+1) | a (NS+1)], zi (B, NS) or null -> y (B, L).
template <int NS>
__global__ void __launch_bounds__(kThreads)
    lfilter_kernel(const float* __restrict__ x, const float* __restrict__ coefs,
                   const float* __restrict__ zi, float* __restrict__ y, int batch, int length) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  float b[NS + 1], a[NS + 1], z[NS];
#pragma unroll
  for (int i = 0; i <= NS; ++i) {
    b[i] = coefs[i];
    a[i] = coefs[NS + 1 + i];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) z[i] = zi ? zi[(long long)lane * NS + i] : 0.f;
  const float* xl = x + (long long)lane * length;
  float* yl = y + (long long)lane * length;
  float cur[kChunk], nxt[kChunk];
  load_chunk(xl, 0, length, cur);
  for (int c0 = 0; c0 < length; c0 += kChunk) {
    load_chunk(xl, c0 + kChunk, length, nxt);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float xn = cur[j];
      const float yn = __fadd_rn(__fmul_rn(b[0], xn), z[0]);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float t = __fsub_rn(__fmul_rn(b[i + 1], xn), __fmul_rn(a[i + 1], yn));
        z[i] = __fadd_rn(t, i + 1 < NS ? z[i + 1] : 0.f);
      }
      if (c0 + j < length) yl[c0 + j] = yn;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = nxt[j];
  }
}

// x (B, L), coefs (NSEC, 6) [b0 b1 b2 a0 a1 a2] with a / a0, zi (B, NSEC, 2)
// or null -> y (B, L).
template <int NSEC>
__global__ void __launch_bounds__(kThreads)
    sosfilt_kernel(const float* __restrict__ x, const float* __restrict__ coefs,
                   const float* __restrict__ zi, float* __restrict__ y, int batch, int length) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  float c[NSEC][6], z0[NSEC], z1[NSEC];
#pragma unroll
  for (int s = 0; s < NSEC; ++s) {
#pragma unroll
    for (int k = 0; k < 6; ++k) c[s][k] = coefs[s * 6 + k];
    z0[s] = zi ? zi[((long long)lane * NSEC + s) * 2] : 0.f;
    z1[s] = zi ? zi[((long long)lane * NSEC + s) * 2 + 1] : 0.f;
  }
  const float* xl = x + (long long)lane * length;
  float* yl = y + (long long)lane * length;
  float cur[kChunk], nxt[kChunk];
  load_chunk(xl, 0, length, cur);
  for (int c0 = 0; c0 < length; c0 += kChunk) {
    load_chunk(xl, c0 + kChunk, length, nxt);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      float v = cur[j];
#pragma unroll
      for (int s = 0; s < NSEC; ++s) {
        const float out = __fadd_rn(__fmul_rn(c[s][0], v), z0[s]);
        const float n0 = __fadd_rn(__fsub_rn(__fmul_rn(c[s][1], v), __fmul_rn(c[s][4], out)),
                                   z1[s]);
        z1[s] = __fsub_rn(__fmul_rn(c[s][2], v), __fmul_rn(c[s][5], out));
        z0[s] = n0;
        v = out;
      }
      if (c0 + j < length) yl[c0 + j] = v;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = nxt[j];
  }
}

inline int blocks_for(int batch) { return (batch + kThreads - 1) / kThreads; }

}  // namespace

#define AW_IIR_CASE(KERNEL, N) \
  case N:                      \
    KERNEL<N><<<blocks_for(batch), kThreads, 0, st>>>(x, coefs, zi, y, batch, length); \
    break;

#define AW_IIR_CASES(KERNEL)                                                               \
  AW_IIR_CASE(KERNEL, 1) AW_IIR_CASE(KERNEL, 2) AW_IIR_CASE(KERNEL, 3)                     \
  AW_IIR_CASE(KERNEL, 4) AW_IIR_CASE(KERNEL, 5) AW_IIR_CASE(KERNEL, 6)                     \
  AW_IIR_CASE(KERNEL, 7) AW_IIR_CASE(KERNEL, 8) AW_IIR_CASE(KERNEL, 9)                     \
  AW_IIR_CASE(KERNEL, 10) AW_IIR_CASE(KERNEL, 11) AW_IIR_CASE(KERNEL, 12)                  \
  AW_IIR_CASE(KERNEL, 13) AW_IIR_CASE(KERNEL, 14) AW_IIR_CASE(KERNEL, 15)                  \
  AW_IIR_CASE(KERNEL, 16)

static_assert(kMaxState == 16 && kMaxSections == 16, "the dispatch cases cover 1-16");

extern "C" {

// x (B, L) f32, coefs (2, ns + 1) f32, zi (B, ns) f32 or null -> y (B, L) f32.
int aw_lfilter(const float* x, const float* coefs, const float* zi, float* y, int batch,
               int length, int ns, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (batch <= 0 || length <= 0) return 0;
  switch (ns) {
    AW_IIR_CASES(lfilter_kernel)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (B, L) f32, coefs (n_sec, 6) f32, zi (B, n_sec, 2) f32 or null -> y (B, L) f32.
int aw_sosfilt(const float* x, const float* coefs, const float* zi, float* y, int batch,
               int length, int n_sec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (batch <= 0 || length <= 0) return 0;
  switch (n_sec) {
    AW_IIR_CASES(sosfilt_kernel)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
