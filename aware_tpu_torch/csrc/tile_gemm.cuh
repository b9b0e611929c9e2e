// The shifted-slab WMMA GEMM shared by the port's kernels (sm_90a), and the
// block sum of their per-clip kernels.
//
//   out[b, i, :] = sum_{k < slabs} bf16(A[b, i + dir * (k - pad), :]) @ W_k
//
// with W_k = w + k * w_kstride a (kd, n) row-major bf16 slab, f32
// accumulation, and A rows outside [s_lo, s_hi) read as zero.  A slab count
// of 1 and dir 0 make it a plain batched GEMM.  The A operand comes from a
// functor that returns the f32 value of A[b, s, c] before its rounding to
// bf16, so operands are built while they are staged (products, norms,
// activations, reflections) and never written to device memory; the
// epilogue functor takes each f32 sum.
//
// 64 x 64 output tiles, 4 warps of WMMA bf16 16x16x16 products, 32-deep
// operand tiles staged through shared memory.  Requires n % 64 == 0 and
// kd % 32 == 0; rows are masked.  The simple right version: wgmma, TMA and a
// pipelined ring of tiles are in slab_gemm_sm90.cuh, for the two products
// that only load their operands (shift_mm and the band_analysis VJP); the
// rest is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;     // output rows per block
constexpr int BN = 64;     // output columns per block
constexpr int BK = 32;     // depth per staged tile
constexpr int kThreads = 128;
constexpr int LDA = BK + 8;  // shared-memory row strides, padded against
constexpr int LDB = BN + 8;  // bank conflicts (multiples of 8 bf16 / 4 f32,
constexpr int LDC = BN + 4;  // as WMMA requires)

struct Geometry {
  int m_out;   // output rows per clip
  int s_lo;    // A rows outside [s_lo, s_hi) read as zero
  int s_hi;
  int kd;      // depth of one slab
  int n;       // output columns
  int slabs;
  int dir;     // source row = row + dir * (k - pad)
  int pad;
  const __nv_bfloat16* w;
  long long w_ld;       // row stride of W
  long long w_kstride;  // offset of slab k in W
};

// A plain batched GEMM: (B, m, kd) f32-valued A times a (kd, n) bf16 W.
inline Geometry plain_geometry(int m, int kd, int n, const __nv_bfloat16* w) {
  return Geometry{m, 0, m, kd, n, 1, 0, 0, w, (long long)n, 0};
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct LoadA {  // a plain (B, m_src, ld) f32 tensor
  const float* a;
  int ld;
  int m_src;
  __device__ float operator()(int b, int s, int c) const {
    return a[((long long)b * m_src + s) * ld + c];
  }
};

struct StoreEpi {  // out (B, m_out, n) f32
  float* out;
  int m_out;
  int n;
  __device__ float operator()(int b, int row, int col, float acc) const {
    out[((long long)b * m_out + row) * n + col] = acc;
    return 0.f;
  }
};

// The epilogue returns a value whose per-clip maximum the kernel reduces
// into max_bits (as float bits) when kMax is set.
template <class AOp, class Epi, bool kMax>
__global__ void __launch_bounds__(kThreads)
shift_gemm(AOp aop, Epi epi, Geometry g, unsigned int* max_bits) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ float red[kThreads / 32];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = (warp / 2) * 32;  // this warp's 32 x 32 quarter of the tile
  const int wc = (warp % 2) * 32;

  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);

  for (int k = 0; k < g.slabs; ++k) {
    const int shift = g.dir * (k - g.pad);
    const __nv_bfloat16* wk = g.w + k * g.w_kstride;
    for (int c0 = 0; c0 < g.kd; c0 += BK) {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, c = e % BK;
        const int s = row0 + r + shift;
        float v = 0.f;
        if (row0 + r < g.m_out && s >= g.s_lo && s < g.s_hi) v = aop(b, s, c0 + c);
        As[r * LDA + c] = __float2bfloat16(v);
      }
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int r = e / BN, c = e % BN;
        Bs[r * LDB + c] = wk[(long long)(c0 + r) * g.w_ld + col0 + c];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               nvcuda::wmma::row_major> fa[2];
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               nvcuda::wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          nvcuda::wmma::load_matrix_sync(fa[i], As + (wr + 16 * i) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvcuda::wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wc + 16 * j, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(Cs + (wr + 16 * i) * LDC + wc + 16 * j, acc[i][j],
                                      LDC, nvcuda::wmma::mem_row_major);
  __syncthreads();

  float mx = 0.f;
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    if (row0 + r < g.m_out) mx = fmaxf(mx, epi(b, row0 + r, col0 + c, Cs[r * LDC + c]));
  }
  if (kMax) {
    for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (tid % 32 == 0) red[warp] = mx;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kThreads / 32; ++w) mx = fmaxf(mx, red[w]);
      // non-negative floats order as their bit patterns
      atomicMax(max_bits + b, __float_as_uint(mx));
    }
  }
}

template <class AOp, class Epi, bool kMax = false>
void launch_shift_gemm(AOp aop, Epi epi, const Geometry& g, int batch,
                       unsigned int* max_bits, cudaStream_t stream) {
  dim3 grid(g.n / BN, (g.m_out + BM - 1) / BM, batch);
  shift_gemm<AOp, Epi, kMax><<<grid, kThreads, 0, stream>>>(aop, epi, g, max_bits);
}

// The sum over a 1024-thread block (one block per clip), in a fixed order,
// so that a run repeats bit for bit.
constexpr int kRedThreads = 1024;

__device__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) sh[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kRedThreads / 32; ++w) s += sh[w];
  return s;
}

}  // namespace
