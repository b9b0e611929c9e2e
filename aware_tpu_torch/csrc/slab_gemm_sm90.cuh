// The shifted-slab GEMM of the round trips, redesigned for Hopper
// (sm_90a): TMA into a ring of shared-memory stages, a producer
// warpgroup, and wgmma products in one or two consumer warpgroups.
//
//   out[b, i, :] = sum_{k<4} bf16(A[b, i + dir * (k - pad), :]) @ W_k   for i < n_out,
//
// per clip b, with A (B, N, D) f32, rows outside [0, N) of that clip read as
// zero, W_k the (D, E) bf16 slab whose origin in the weight matrix is
// (k * k_row, k * k_col), f32 accumulation and an epilogue functor that
// stores each pair of sums (a plain f32 store, StoreF32, or one of the
// whole-step chain's, iteration_sm90.cu).  It replaces three Pallas TPU
// kernels, each one entry of slab_gemm_sm90.cu:
//
//   aw_shift_mm          <- aware_tpu/ops/pallas/roundtrip_tiled.py shift_mm
//                           (_shift_mm_kernel): dir +1, pad 0, W (4, D, E);
//   aw_band_analysis_fwd <- aware_tpu/ops/pallas/roundtrip.py band_analysis
//                           (_analysis_impl, _analysis_kernel): dir +1, pad 2,
//                           W_k = csw[k hop:(k+1) hop, :] of csw (4 hop, 2P);
//   aw_band_analysis_bwd <- aware_tpu/ops/pallas/roundtrip.py band_analysis VJP
//                           (_analysis_bwd, _analysis_bwd_kernel): dir -1, pad 2,
//                           W_k = cswt[:, k hop:(k+1) hop] of cswt (2P, 4 hop);
//
// and runs the four round-trip products of aw_iteration_step (the
// synthesis, the reflect analysis, its VJP and the synthesis VJP).
//
// What bounds each use on an H100 (989 TFLOP/s bf16, 3.35 TB/s):
//   shift_mm at the long path's three uses (B = 8, n_out 3751-3753, D x E
//   256 x 512 or 512 x 256): 31.5 GFLOP against 93.2 MB (x read, w, out
//   written once), 31.8 us of operations against 27.8 us of bytes;
//   the band_analysis forward and VJP at B = 8, T = 626 (D x E 256 x 512
//   or 512 x 256): 5.24 GFLOP against 16.4 MB each, 5.3 us of operations
//   against 4.9 us of bytes; the step's four products the same.
// Operations bound both, narrowly, so the design is about feeding the
// tensor cores:
//   * TMA, not threads, stages both operands, into a ring of stages with
//     mbarrier completion; one thread of a producer warpgroup keeps the
//     ring full while the consumer warpgroups multiply, so copy and product
//     overlap.  The producer hands its registers to the consumers
//     (setmaxnreg: 40 against 232, or 216 where two blocks share an SM).  The
//     weight slabs come through 64-column boxes with 128-byte swizzle (the
//     N-major layout wgmma reads with its B-transpose bit).  A comes through
//     a 3-D tensor map over (columns, rows, clips): rows before 0 or at and
//     past N are zero-filled by the hardware inside one clip and never read
//     from the neighbouring clip, which is the clip's end in shift_mm, row -1
//     in the VJP, and whole clips as short as 8 frames.
//   * One A window per depth chunk serves all four slabs: rows
//     [t0 + min shift, t0 + BM + 3 + min shift) of 32 f32 columns are loaded
//     once, and slab k reads it at its own row offset, a quarter of the A
//     traffic of one load per slab.
//   * A stays f32 in memory, as every caller produces it.  Each consumer
//     thread reads its wgmma A fragment from the swizzled f32 window, rounds
//     it with cvt.rn.bf16x2 (round to nearest even, as .to(torch.bfloat16)),
//     and feeds wgmma from registers with B from shared memory; a register
//     operand makes the one-row slab offsets free, where a shared-memory A
//     descriptor at a one-row offset would fall out of the swizzle pattern.
//   * wgmma m64nNk16 (bf16 in, f32 accumulate), N = BN = 128 or 64, one
//     warpgroup per 64 output rows.  A warpgroup builds one depth chunk's
//     fragments, issues its 8 products and waits for them; two warpgroups
//     share each SM (two per block, or two blocks of one), so one builds
//     while the other multiplies.  (Building the next chunk's fragments
//     while the products run makes ptxas serialize every wgmma, C7513, and
//     was slower on the card.)  BM x BN is chosen per call by the wrapper
//     (ops/kernels/roundtrip.py, plan_slab_gemm) so that the grid fills
//     the 132 SMs.
//   * Two-level sums.  The tensor cores' own accumulate is less exact than
//     an f32 add: summed inside them over the whole depth (4 x 256 or
//     4 x 512), the products came out some 20 times further from a float64
//     product than the plain version's f32 sums, as the WMMA kernels' do.
//     Here the tensor cores sum one chunk (4 slabs x 32 deep) from zero,
//     and f32 adds, rounded to nearest, carry the chunks, which brings the
//     error to the plain version's (chip_smoke.py phase 2 prints both).
//   * Deterministic: no split of the depth, no float atomics; a repeated
//     launch gives the same bits.
// The kernel allocates nothing and runs on the caller's stream; the tensor
// maps are encoded on the host per call (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so nothing links libcuda) and passed by
// value as __grid_constant__ parameters.  Requirements, which the wrapper
// checks: D % 32 == 0, E % BN == 0, A and W 16-byte aligned.

#pragma once

#include "sm90_common.cuh"

namespace {

namespace sm90 {

constexpr int kSlabs = 4;
constexpr int kBK = 32;     // depth chunk: f32 columns of one A box (128 bytes)
constexpr int kBoxB = kBK * 128;  // bytes of one B box: 32 rows of 128 bytes

template <int NWG, int BN>
struct Tile {
  static constexpr int BM = 64 * NWG;            // output rows per block
  static constexpr int WR = BM + kSlabs - 1;     // A window rows
  static constexpr int A_TX = WR * 128;          // bytes of one A box
  static constexpr int A_BYTES = (A_TX + 1023) / 1024 * 1024;
  static constexpr int NB = BN / kBoxN;          // B boxes per slab
  static constexpr int B_BYTES = kSlabs * NB * kBoxB;
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1024
  // two warpgroups fill one SM; a one-warpgroup tile stays within half
  // the shared memory, so that two of its blocks share an SM
  static constexpr int STAGES = (NWG == 2 || BN == 64) ? 4 : 2;
  static constexpr int MIN_BLOCKS = NWG == 2 ? 1 : 2;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + slack to align to 1024
  // the consumer warpgroups, then one producer warpgroup whose first
  // thread issues every copy
  static constexpr int THREADS = 128 * NWG + 128;
  // registers a thread (entry_regs: 168 or 128, as chip_smoke.py phase 1
  // shows; with fewer, the consumers' increase would wait forever); the
  // producer hands all but 40 of its own to the consumers, which hold two
  // sets of accumulators and a chunk's fragments
  static constexpr int CONSUMER_REGS = consumer_regs(THREADS, MIN_BLOCKS, 128 * NWG);
  static constexpr uint32_t TX = A_TX + B_BYTES;       // bytes TMA delivers per stage
};

// wgmma m64nNk16, A from registers (the m16n8k16 fragment of each warp's 16
// rows), B from shared memory transposed (N-major): d = A B, or with
// `accumulate` d += A B, in f32.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}


// Round two f32 to a bf16 pair, the first in the low half: the layout of
// a wgmma register fragment.
__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The output rows' geometry of one launch; the epilogue functor stores.
struct Params {
  int n_out;    // output rows per clip
  int e;        // output columns
  int depth;    // D
  int k_row;    // origin of slab k in W: (k * k_row, k * k_col)
  int k_col;
  int dir;      // source row = row + dir * (k - pad)
  int pad;
};

// Epilogues: called for output row `row` < n_out of clip b at columns col
// and col + 1 with their f32 sums.  kMax epilogues return a non-negative
// value whose per-clip maximum the kernel folds into their max_bits (float
// bits, atomicMax: the same bits in any order).
struct StoreF32 {  // out (B, n_out, e) f32
  static constexpr bool kMax = false;
  float* out;
  int n_out;
  int e;
  __device__ float operator()(int b, int row, int col, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + ((long long)b * n_out + row) * e + col) =
        make_float2(v0, v1);
    return 0.f;
  }
};

// The synthesis (the whole step's, iteration_sm90.cu): u = acc / env +
// y_const into u (B, lr, hop); |u| for m1's bits.  env and y_const come
// through the read-only path (__ldg), which lets the compiler issue a
// step's loads ahead of the previous step's store to u (plain loads may
// not pass a store that could alias them).
struct SlabSynthEpi {
  static constexpr bool kMax = true;
  float* u;
  const float* env;
  const float* y_const;
  unsigned int* max_bits;
  int lr;
  int hop;
  __device__ float operator()(int b, int row, int col, float v0, float v1) const {
    const long long e = (long long)row * hop + col;
    const long long i = (long long)b * lr * hop + e;
    const float2 ev = __ldg(reinterpret_cast<const float2*>(env + e));
    const float2 yc = __ldg(reinterpret_cast<const float2*>(y_const + i));
    const float u0 = v0 / ev.x + yc.x;
    const float u1 = v1 / ev.y + yc.y;
    *reinterpret_cast<float2*>(u + i) = make_float2(u0, u1);
    return fmaxf(fabsf(u0), fabsf(u1));
  }
};

// The long-clip synthesis (roundtrip_tiled.cu): SlabSynthEpi for the rows
// of u; the rows from lr on (the reference's m1 tail rows, which still
// hold the overlap-add tail of the last frames) enter the max with env 1
// and y_const 0 and are not written.
struct SlabSynthTailEpi : SlabSynthEpi {
  __device__ float operator()(int b, int row, int col, float v0, float v1) const {
    if (row >= lr) return fmaxf(fabsf(v0), fabsf(v1));  // acc / 1 + 0
    return SlabSynthEpi::operator()(b, row, col, v0, v1);
  }
};

// The rows of A that slab k reads lie off_k rows into the window that
// starts at row t0 + first_row(dir, pad): the smallest shift of the four.
__device__ __forceinline__ int first_row(int dir, int pad) {
  return dir > 0 ? -pad : pad - (kSlabs - 1);
}
__device__ __forceinline__ int slab_offset(int dir, int k) {
  return dir > 0 ? k : kSlabs - 1 - k;
}

template <int NWG, int BN, class Epi>
__global__ void __launch_bounds__(Tile<NWG, BN>::THREADS, Tile<NWG, BN>::MIN_BLOCKS)
slab_gemm_sm90(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
               Params p, Epi epi) {
  using T = Tile<NWG, BN>;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle repeats every 1024
  const uint8_t* gbase = smem_raw + (base - raw);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * BN;
  const int chunks = p.depth / kBK;

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
      const int row0 = t0 + first_row(p.dir, p.pad);
      for (int c = 0; c < chunks; ++c) {
        const int s = c % S;
        if (c >= S) mbar_wait(smem_u32(&empty[s]), ((c / S) - 1) & 1);
        const uint32_t fb = smem_u32(&full[s]);
        const uint32_t st = base + s * T::STAGE;
        mbar_expect_tx(fb, T::TX);
        tma_load_3d(st, &tm_a, fb, c * kBK, row0, b);
#pragma unroll
        for (int k = 0; k < kSlabs; ++k)
#pragma unroll
          for (int j = 0; j < T::NB; ++j)
            tma_load_2d(st + T::A_BYTES + (k * T::NB + j) * kBoxB, &tm_w, fb,
                        k * p.k_col + n0 + j * kBoxN, k * p.k_row + c * kBK);
      }
    }
  } else {
    // ---- consumers: warpgroup wg multiplies output rows [64 wg, 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(T::CONSUMER_REGS));
    const int wg = warp / 4;
    const int g = lane / 4;  // fragment row (and row + 8)
    const int q = lane % 4;  // fragment column pair
    const int row = 64 * wg + 16 * (warp % 4) + g;
    // byte offset of each slab's fragment row in the window, and its swizzle key
    int roff[kSlabs], key[kSlabs];
#pragma unroll
    for (int k = 0; k < kSlabs; ++k) {
      const int r = row + slab_offset(p.dir, k);
      roff[k] = r * 128 + (q & 1) * 8;
      key[k] = r & 7;
    }

    // two-level sums: the tensor cores sum one chunk's 4 x 32-deep products
    // into `part` from zero, f32 adds carry the chunks in `acc`
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    uint32_t fa[kSlabs][2][4];  // one chunk's fragments: [slab][16-deep step][reg]

    auto load = [&](uint32_t (&f)[kSlabs][2][4], const uint8_t* win) {
#pragma unroll
      for (int k = 0; k < kSlabs; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // columns 16 h + 2 q (+1) and 16 h + 8 + 2 q (+1): 16-byte chunks
          // 4 h + q / 2 and 4 h + 2 + q / 2 of the row, swizzled by the row
          const int lo = ((4 * h + q / 2) ^ key[k]) * 16;
          const int hi = ((4 * h + 2 + q / 2) ^ key[k]) * 16;
          const uint8_t* r0 = win + roff[k];
          const uint8_t* r1 = r0 + 8 * 128;  // row + 8: the same swizzle key
          f[k][h][0] = pack_bf16(*reinterpret_cast<const float2*>(r0 + lo));
          f[k][h][1] = pack_bf16(*reinterpret_cast<const float2*>(r1 + lo));
          f[k][h][2] = pack_bf16(*reinterpret_cast<const float2*>(r0 + hi));
          f[k][h][3] = pack_bf16(*reinterpret_cast<const float2*>(r1 + hi));
        }
    };
    auto multiply = [&](const uint32_t (&f)[kSlabs][2][4], uint32_t wst) {
#pragma unroll
      for (int k = 0; k < kSlabs; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_rs(part, f[k][h], desc_b(wst + k * T::NB * kBoxB + h * 16 * 128, kBoxB),
                   k + h > 0);
    };
    // chunk c: wait for its stage, build its fragments, issue its products,
    // wait for them, release the stage and add the chunk's sums
    for (int c = 0; c < chunks; ++c) {
      const int s = c % S;
      mbar_wait(smem_u32(&full[s]), (c / S) & 1);
      load(fa, gbase + s * T::STAGE);
      fence_operands(part);
      wgmma_fence();
      multiply(fa, base + s * T::STAGE + T::A_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(part);
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }

    // ---- epilogue: rows row and row + 8 of the tile, two columns per 8
    const int r0 = t0 + row, r1 = r0 + 8;
    float mx = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      if (r0 < p.n_out) mx = fmaxf(mx, epi(b, r0, col, acc[4 * j], acc[4 * j + 1]));
      if (r1 < p.n_out) mx = fmaxf(mx, epi(b, r1, col, acc[4 * j + 2], acc[4 * j + 3]));
    }
    if constexpr (Epi::kMax) {
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // non-negative floats order as their bit patterns
      if (lane == 0) atomicMax(epi.max_bits + b, __float_as_uint(mx));
    }
  }
}

// ------------------------------------------------------------------ host ---

// The operands of one launch.
struct Problem {
  const float* a;           // (batch, n_src, depth) f32
  int batch;
  int n_src;
  const __nv_bfloat16* w;   // (w_rows, w_cols) bf16
  int w_rows;
  int w_cols;
  Params p;
};

template <int NWG, int BN, class Epi>
int launch(const Problem& pr, const Epi& epi, cudaStream_t stream) {
  using T = Tile<NWG, BN>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_a, tm_w;
  const cuuint64_t a_dim[3] = {(cuuint64_t)pr.p.depth, (cuuint64_t)pr.n_src, (cuuint64_t)pr.batch};
  const cuuint64_t a_stride[2] = {(cuuint64_t)pr.p.depth * 4, (cuuint64_t)pr.n_src * pr.p.depth * 4};
  const cuuint32_t a_box[3] = {kBK, T::WR, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (enc(&tm_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(pr.a), a_dim, a_stride,
          a_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  if (!encode_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, pr.w, pr.w_cols, pr.w_rows, kBoxN,
                 kBK))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;  // once per instantiation, before any graph capture
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(slab_gemm_sm90<NWG, BN, Epi>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  dim3 grid(pr.p.e / BN, (pr.p.n_out + T::BM - 1) / T::BM, pr.batch);
  slab_gemm_sm90<NWG, BN, Epi><<<grid, T::THREADS, T::SMEM, stream>>>(tm_a, tm_w, pr.p, epi);
  return (int)cudaGetLastError();
}

// The tile the wrapper planned: BM x BN of 128 x 128, 64 x 128 or 64 x 64.
template <class Epi>
int launch_slab_gemm(const Problem& pr, const Epi& epi, int bm, int bn, cudaStream_t stream) {
  if (pr.p.depth % kBK != 0 || pr.p.e % bn != 0) return (int)cudaErrorInvalidValue;
  if (bm == 128 && bn == 128) return launch<2, 128>(pr, epi, stream);
  if (bm == 64 && bn == 128) return launch<1, 128>(pr, epi, stream);
  if (bm == 64 && bn == 64) return launch<1, 64>(pr, epi, stream);
  return (int)cudaErrorInvalidValue;
}

// A plain f32 store of the rows into out (B, n_out, e).
inline int launch_slab_gemm(const Problem& pr, float* out, int bm, int bn,
                            cudaStream_t stream) {
  return launch_slab_gemm(pr, StoreF32{out, pr.p.n_out, pr.p.e}, bm, bn, stream);
}

// (dynamic shared memory bytes, threads, stages, registers a thread at
// entry) of a tile, for reports.
inline int tile_config(int bm, int bn, int* threads, int* stages, int* regs) {
#define AW_TILE(NWG, BN)                                                            \
  if (bm == 64 * NWG && bn == BN) {                                                 \
    using T = Tile<NWG, BN>;                                                        \
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
