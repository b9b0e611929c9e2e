// The detector's plain GEMMs for Hopper (sm_90a), as aw_iteration_step
// (iteration_sm90.cu) runs them: its mel product, four conv layers, their
// four VJPs and the mel VJP,
//
//   out[r, :] = sum_k A[r, k] B[k, :]   for r < M,
//
// with A (M, K) bf16 (the B clips' rows stacked: M = B T or B T2), B (K, N)
// bf16 row-major (the weights as the WMMA chain reads them), f32 sums and
// an epilogue functor that stores each pair of sums (a plain store, the
// bias of a conv layer, the phase of the mel VJP).  At the step's shapes
// (B = 8, T = 626: M 2504 or 5008, K and N of 128 to 1024) the ten take
// 18.3 GFLOP, 18.5 us at the bf16 peak, against 2 to 21 MB each.
//
// The WMMA chain built each A operand element by element while it staged
// it (the norm, leaky, pool, magnitude or norm-VJP of the previous
// layer's output): loaders that compute ran 2-3x slower than loaders that
// only load, and the 64 x 64 WMMA tiles had no overlap of copy and
// product.  Here the kernel that runs before each product writes its A in
// bf16, the same f32 expression rounded by the same __float2bfloat16 as
// the loader's, so the bits of every operand are kept, and the product
// only loads:
//   * TMA stages both operands into a ring of four stages, 64 deep (one
//     128-byte row of A, swizzled); one thread of a producer warpgroup
//     issues every copy and hands its registers to the consumers
//     (setmaxnreg), as in slab_gemm_sm90.cuh.  Rows at or past M are
//     zero-filled by the tensor map.
//   * wgmma m64nNk16 with both operands in shared memory (A K-major, B
//     N-major with the transpose bit), one warpgroup per 64 output rows,
//     N = BN = 128 or 64.
//   * Two-level sums: the tensor cores sum one 64-deep chunk from zero
//     and f32 adds carry the chunks (the tensor cores' own accumulate over
//     the whole depth moved the slab products' error 7-18x, PERF.md).
//   * Deterministic: no split of the depth, no float atomics.
//   * BM x BN (128 x 128, 64 x 128 or 64 x 64) is planned per call by the
//     wrapper (ops/kernels/iteration.py, plan_dense_gemm): the largest tile
//     whose grid has a block for every SM, else the one with the most
//     blocks.  A product 128 wide over 2504 rows gets 80 blocks of 64 x 64:
//     without a split of the depth it cannot fill the 132 SMs.
// Requirements, which the wrapper checks: K % 64 == 0, N % BN == 0, A and
// B 16-byte aligned.

#pragma once

#include "sm90_common.cuh"

namespace {

namespace sm90 {

constexpr int kDK = 64;              // depth chunk: bf16 columns of one A box (128 bytes)
constexpr int kDenseBoxB = kDK * 128;  // bytes of one B box: 64 rows of 128 bytes

template <int NWG, int BN>
struct DenseTile {
  static constexpr int BM = 64 * NWG;
  static constexpr int A_BYTES = BM * 128;       // BM rows of 64 bf16: a multiple of 1024
  static constexpr int NB = BN / kBoxN;          // B boxes
  static constexpr int B_BYTES = NB * kDenseBoxB;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = 4;
  static constexpr int MIN_BLOCKS = NWG == 2 ? 1 : 2;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + slack to align to 1024
  static constexpr int THREADS = 128 * NWG + 128;
  static constexpr int CONSUMER_REGS = consumer_regs(THREADS, MIN_BLOCKS, 128 * NWG);
};

// K-major A with 128-byte swizzle: 8-row groups 1024 bytes apart (the
// leading byte offset is not read for this layout).
__device__ __forceinline__ uint64_t desc_a(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// wgmma m64nNk16, A and B from shared memory (B transposed: N-major):
// d = A B, or with `accumulate` d += A B, in f32.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Epilogues: called for output row r < M at columns col and col + 1.
struct DenseStore {  // out (M, n) f32
  float* out;
  int n;
  __device__ void operator()(int r, int col, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + (long long)r * n + col) = make_float2(v0, v1);
  }
};

// h = acc + bias, (M, n) f32; the bias through the read-only path, so
// that its loads may pass the stores to h (plain loads may not pass a
// store that could alias them).
struct DenseBias {
  float* h;
  const float* bias;
  int n;
  __device__ void operator()(int r, int col, float v0, float v1) const {
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + col));
    *reinterpret_cast<float2*>(h + (long long)r * n + col) = make_float2(v0 + bv.x, v1 + bv.y);
  }
};

// dcs = dm * nph in both the Re and the Im block, (M, 2p) f32; nph through
// the read-only path, as DenseBias's bias.
struct DensePhase {
  float* dcs;
  const __nv_bfloat16* nph;
  int p;
  __device__ void operator()(int r, int col, float v0, float v1) const {
    const long long e = (long long)r * 2 * p + col;
    const __nv_bfloat162 re = __ldg(reinterpret_cast<const __nv_bfloat162*>(nph + e));
    const __nv_bfloat162 im = __ldg(reinterpret_cast<const __nv_bfloat162*>(nph + e + p));
    *reinterpret_cast<float2*>(dcs + e) =
        make_float2(v0 * __low2float(re), v1 * __high2float(re));
    *reinterpret_cast<float2*>(dcs + e + p) =
        make_float2(v0 * __low2float(im), v1 * __high2float(im));
  }
};

template <int NWG, int BN, class Epi>
__global__ void __launch_bounds__(DenseTile<NWG, BN>::THREADS, DenseTile<NWG, BN>::MIN_BLOCKS)
dense_gemm_sm90(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                int m, int depth, Epi epi) {
  using T = DenseTile<NWG, BN>;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * BN;
  const int chunks = depth / kDK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- producer: one thread keeps the ring of stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == 4 * NWG && lane == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int s = c % S;
        if (c >= S) mbar_wait(smem_u32(&empty[s]), ((c / S) - 1) & 1);
        const uint32_t fb = smem_u32(&full[s]);
        const uint32_t st = base + s * T::STAGE;
        mbar_expect_tx(fb, T::STAGE);
        tma_load_2d(st, &tm_a, fb, c * kDK, m0);
#pragma unroll
        for (int j = 0; j < T::NB; ++j)
          tma_load_2d(st + T::A_BYTES + j * kDenseBoxB, &tm_b, fb, n0 + j * kBoxN, c * kDK);
      }
    }
  } else {
    // ---- consumers: warpgroup wg multiplies output rows [64 wg, 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(T::CONSUMER_REGS));
    const int wg = warp / 4;
    const int g = lane / 4;  // fragment row (and row + 8)
    const int q = lane % 4;  // fragment column pair

    // two-level sums: the tensor cores sum one chunk's 64-deep products
    // into `part` from zero, f32 adds carry the chunks in `acc`
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int s = c % S;
      mbar_wait(smem_u32(&full[s]), (c / S) & 1);
      const uint32_t st = base + s * T::STAGE;
      fence_operands(part);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < kDK / 16; ++h)  // 16 deep: 32 bytes along A's row, 16 rows of B
        wgmma_ss(part, desc_a(st + wg * 64 * 128 + h * 32),
                 desc_b(st + T::A_BYTES + h * 16 * 128, kDenseBoxB), h > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(part);
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }

    // ---- epilogue: rows r0 and r0 + 8, two columns per 8
    const int r0 = m0 + 64 * wg + 16 * (warp % 4) + g, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      if (r0 < m) epi(r0, col, acc[4 * j], acc[4 * j + 1]);
      if (r1 < m) epi(r1, col, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ------------------------------------------------------------------ host ---

template <int NWG, int BN, class Epi>
int launch_dense(const __nv_bfloat16* a, const __nv_bfloat16* b, int m, int k, int n,
                 const Epi& epi, cudaStream_t stream) {
  using T = DenseTile<NWG, BN>;
  CUtensorMap tm_a, tm_b;
  if (!encode_2d(&tm_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, k, m, kDK, T::BM) ||
      !encode_2d(&tm_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, n, k, kBoxN, kDK))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;  // once per instantiation, before any graph capture
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(dense_gemm_sm90<NWG, BN, Epi>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  dim3 grid(n / BN, (m + T::BM - 1) / T::BM);
  dense_gemm_sm90<NWG, BN, Epi><<<grid, T::THREADS, T::SMEM, stream>>>(tm_a, tm_b, m, k, epi);
  return (int)cudaGetLastError();
}

// out = A (m, k) @ B (k, n) through the epilogue, on the planned tile.
template <class Epi>
int launch_dense_gemm(const __nv_bfloat16* a, const __nv_bfloat16* b, int m, int k, int n,
                      const Epi& epi, int bm, int bn, cudaStream_t stream) {
  if (k % kDK != 0 || n % bn != 0 || m < 1) return (int)cudaErrorInvalidValue;
  if (bm == 128 && bn == 128) return launch_dense<2, 128>(a, b, m, k, n, epi, stream);
  if (bm == 64 && bn == 128) return launch_dense<1, 128>(a, b, m, k, n, epi, stream);
  if (bm == 64 && bn == 64) return launch_dense<1, 64>(a, b, m, k, n, epi, stream);
  return (int)cudaErrorInvalidValue;
}

// (dynamic shared memory bytes, threads, stages, registers a thread at
// entry) of a tile, for reports.
inline int dense_tile_config(int bm, int bn, int* threads, int* stages, int* regs) {
#define AW_TILE(NWG, BN)                                                            \
  if (bm == 64 * NWG && bn == BN) {                                                 \
    using T = DenseTile<NWG, BN>;                                                   \
    *threads = T::THREADS;                                                          \
    *stages = T::STAGES;                                                            \
    *regs = entry_regs(T::THREADS, T::MIN_BLOCKS);                                  \
    return T::SMEM;                                                                 \
  }
  AW_TILE(2, 128)
  AW_TILE(1, 128)
  AW_TILE(1, 64)
#undef AW_TILE
  return -1;
}

}  // namespace sm90

}  // namespace
