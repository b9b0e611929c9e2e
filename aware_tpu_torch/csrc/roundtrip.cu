// Round-trip kernels of the embed solver, for Hopper (sm_90a).
//
// They replace the four Pallas TPU kernels of aware_tpu/ops/pallas/roundtrip.py:
//
//   aw_synth_norm_fwd    <- synth_norm forward     (_synth_impl,  _synth_kernel)
//   aw_synth_norm_bwd    <- synth_norm VJP         (_synth_bwd,   _synth_bwd_kernel)
//   aw_band_analysis_fwd <- band_analysis forward  (_analysis_impl, _analysis_kernel)
//   aw_band_analysis_bwd <- band_analysis VJP      (_analysis_bwd, _analysis_bwd_kernel)
//
// What they compute, per clip b of a batch (T frames, P padded band bins,
// hop samples per row, R = n_fft / hop = 4 slabs, pad = R / 2 = 2 rows):
//
//   synth fwd:  reim[t]  = bf16(coeffs[t] * csin[t])          (T, 2P), Re | Im
//               u[i]     = sum_k reim[i+2-k] @ ab[:, k*hop:(k+1)*hop] / env[i]
//                          + y_const[i]                       (T-1, hop)
//               m1       = max |u|,   y2 = u / (m1 (1+1e-8) + 1e-16)
//   synth bwd:  the equal-tie-split max subgradient of the peak-norm gives
//               g_u; gcrop = g_u / env;
//               dreim[t] = sum_k bf16(gcrop[t+k-2]) @ abt[k*hop:(k+1)*hop, :]
//               dcoeffs  = dreim[:, :P] * csin[:, :P] + dreim[:, P:] * csin[:, P:]
//   ana fwd:    cs2[t]   = sum_k bf16(y2[t+k-2]) @ csw[k*hop:(k+1)*hop, :]   (T, 2P)
//   ana bwd:    gy2[i]   = sum_k bf16(g[i+2-k]) @ cswt[:, k*hop:(k+1)*hop]   (T-1, hop)
//
// Rows outside a clip read as zero (the zero padding of the Pallas kernels).
//
// Each direction is one "shifted-slab" product: out[i] = sum_k A[i +- (k-2)] @ W_k,
// a GEMM of depth R * depth(W_k) whose A rows are shifted per slab.  At the
// main path's shapes (B = 8, T = 626, P = 256, hop = 256) each of the four is
// 2 * 8 * 626 * 512 * 1024 = 5.3 GFLOP against about 20 MB of operands, i.e.
// some 260 operations per byte: close to the H100's bf16 ridge (989 TFLOP/s
// over 3.35 TB/s = 295), so both the tensor cores and the memory bound it.
// This first version is the simple right one: 64 x 64 output tiles, 4 warps
// of WMMA bf16 16x16x16 products with f32 accumulation, operands staged
// through shared memory.  The A operand is built while it is staged (the
// coeffs * csin product, the peak-norm subgradient, the shifted zero-padded
// rows), so no intermediate of the Pallas kernels' scratch (reim, yd, gyd,
// yp, gyp) goes through device memory.  wgmma, TMA and a pipelined ring of
// tiles are later work.
//
// Every kernel runs on the caller's stream and allocates nothing; each C
// entry returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kR = 4;      // slabs: n_fft / hop
constexpr int kPad = 2;    // rows of centre padding: (n_fft / 2) / hop
constexpr int BM = 64;     // output rows per block
constexpr int BN = 64;     // output columns per block
constexpr int BK = 32;     // depth per staged tile
constexpr int kThreads = 128;
constexpr int LDA = BK + 8;  // shared-memory row strides, padded against
constexpr int LDB = BN + 8;  // bank conflicts (multiples of 8 bf16 / 4 f32,
constexpr int LDC = BN + 4;  // as WMMA requires)
constexpr float kEps = 1e-8f;

// The shifted-slab product's geometry.
struct Geometry {
  int m_out;   // output rows per clip
  int m_src;   // rows of the A operand per clip
  int kd;      // depth of one slab
  int n;       // output columns
  int dir;     // source row = row + dir * (k - kPad)
  const __nv_bfloat16* w;
  long long w_ld;       // row stride of W
  long long w_kstride;  // offset of slab k in W
};

// A operands: the f32 value of A[b, s, c] before its rounding to bf16.

struct LoadA {  // a plain (B, m_src, kd) f32 tensor
  const float* a;
  int ld;
  int m_src;
  __device__ float operator()(int b, int s, int c) const {
    return a[((long long)b * m_src + s) * ld + c];
  }
};

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

struct SynthBwdA {  // gcrop = g_u / env, from g, y2 (B, T-1, hop), env (T-1, hop)
  const float* g;
  const float* y2;
  const float* env;
  const float* scal;  // per clip: cden, q (1+e) / cden, max |y2|, ties
  int lr;
  int hop;
  __device__ float operator()(int b, int s, int c) const {
    long long i = ((long long)b * lr + s) * hop + c;
    const float* sc = scal + 4 * b;
    float yv = y2[i];
    float mask = fabsf(yv) == sc[2] ? 1.f : 0.f;
    float sgn = (float)((yv > 0.f) - (yv < 0.f));
    float gu = g[i] / sc[0] - sc[1] * sgn * mask / sc[3];
    return gu / env[(long long)s * hop + c];
  }
};

// Epilogues: take the f32 sum at (b, row, col); return the value whose
// per-clip maximum the kernel reduces (0 where none is wanted).

struct StoreEpi {
  float* out;
  int m_out;
  int n;
  __device__ float operator()(int b, int row, int col, float acc) const {
    out[((long long)b * m_out + row) * n + col] = acc;
    return 0.f;
  }
};

struct SynthEpi {  // u = acc / env + y_const, kept for the peak-norm scale
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

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k = 0; k < kR; ++k) {
    const int shift = g.dir * (k - kPad);
    const __nv_bfloat16* wk = g.w + k * g.w_kstride;
    for (int c0 = 0; c0 < g.kd; c0 += BK) {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, c = e % BK;
        const int s = row0 + r + shift;
        float v = 0.f;
        if (row0 + r < g.m_out && s >= 0 && s < g.m_src) v = aop(b, s, c0 + c);
        As[r * LDA + c] = __float2bfloat16(v);
      }
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int r = e / BN, c = e % BN;
        Bs[r * LDB + c] = wk[(long long)(c0 + r) * g.w_ld + col0 + c];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wr + 16 * i) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wc + 16 * j, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + 16 * i) * LDC + wc + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
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

// y2 = u / (m1 (1 + e) + e^2) in place; m1 out.
__global__ void peak_scale(float* y, const unsigned int* max_bits, float* m1,
                           long long per_clip, int batch) {
  const long long total = per_clip * batch;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const float m = __uint_as_float(max_bits[i / per_clip]);
    y[i] = y[i] / (m * (1.f + kEps) + kEps * kEps);
    if (i < batch) m1[i] = __uint_as_float(max_bits[i]);
  }
}

// Per clip (one block each): cden, q (1+e) / cden with q = sum g * y2,
// max |y2| and the number of elements that tie at it.
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

__device__ float block_max(float v, float* sh) {
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) sh[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kRedThreads / 32; ++w) s = fmaxf(s, sh[w]);
  return s;
}

__global__ void __launch_bounds__(kRedThreads)
synth_bwd_scalars(const float* g, const float* y2, const float* m1, float* scal,
                  int per_clip) {
  __shared__ float sh[kRedThreads / 32];
  const int b = blockIdx.x;
  const float* gb = g + (long long)b * per_clip;
  const float* yb = y2 + (long long)b * per_clip;
  float q = 0.f, mx = 0.f;
  for (int i = threadIdx.x; i < per_clip; i += kRedThreads) {
    q += gb[i] * yb[i];
    mx = fmaxf(mx, fabsf(yb[i]));
  }
  q = block_sum(q, sh);
  mx = block_max(mx, sh);
  float ties = 0.f;
  for (int i = threadIdx.x; i < per_clip; i += kRedThreads) ties += fabsf(yb[i]) == mx;
  ties = block_sum(ties, sh);
  if (threadIdx.x == 0) {
    const float cden = m1[b] * (1.f + kEps) + kEps * kEps;
    scal[4 * b + 0] = cden;
    scal[4 * b + 1] = q * (1.f + kEps) / cden;
    scal[4 * b + 2] = mx;
    scal[4 * b + 3] = ties;
  }
}

// dcoeffs = dreim[:, :P] * csin[:, :P] + dreim[:, P:] * csin[:, P:]
__global__ void fold_phase(const float* dreim, const __nv_bfloat16* csin, float* dcoeffs,
                           long long rows, int p) {
  const long long total = rows * p;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / p;
    const int c = (int)(i % p);
    const long long base = row * 2 * p + c;
    dcoeffs[i] = dreim[base] * __bfloat162float(csin[base]) +
                 dreim[base + p] * __bfloat162float(csin[base + p]);
  }
}

template <class AOp, class Epi, bool kMax>
void launch_shift_gemm(AOp aop, Epi epi, const Geometry& g, int batch,
                       unsigned int* max_bits, cudaStream_t stream) {
  dim3 grid(g.n / BN, (g.m_out + BM - 1) / BM, batch);
  shift_gemm<AOp, Epi, kMax><<<grid, kThreads, 0, stream>>>(aop, epi, g, max_bits);
}

int elementwise_blocks(long long total) {
  long long blocks = (total + 255) / 256;
  return (int)(blocks < 4096 ? blocks : 4096);
}

}  // namespace

extern "C" {

// coeffs (B, T, P) f32, csin (B, T, 2P) bf16, y_const (B, T-1, hop) f32,
// env (T-1, hop) f32, ab (2P, 4 hop) bf16 -> y2 (B, T-1, hop) f32, m1 (B,) f32;
// max_bits (B,) u32 scratch.
int aw_synth_norm_fwd(const float* coeffs, const __nv_bfloat16* csin, const float* y_const,
                      const float* env, const __nv_bfloat16* ab, float* y2, float* m1,
                      unsigned int* max_bits, int batch, int t, int p, int hop,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int lr = t - 1;
  cudaMemsetAsync(max_bits, 0, sizeof(unsigned int) * batch, st);
  Geometry g{lr, t, 2 * p, hop, -1, ab, (long long)kR * hop, (long long)hop};
  launch_shift_gemm<SynthA, SynthEpi, true>(SynthA{coeffs, csin, t, p},
                                            SynthEpi{y2, env, y_const, lr, hop}, g, batch,
                                            max_bits, st);
  const long long per_clip = (long long)lr * hop;
  peak_scale<<<elementwise_blocks(per_clip * batch), 256, 0, st>>>(y2, max_bits, m1,
                                                                  per_clip, batch);
  return (int)cudaGetLastError();
}

// g, y2 (B, T-1, hop) f32, m1 (B,) f32, csin (B, T, 2P) bf16, env (T-1, hop) f32,
// abt (4 hop, 2P) bf16 -> dcoeffs (B, T, P) f32; scratch dreim (B, T, 2P) f32,
// scal (B, 4) f32.
int aw_synth_norm_bwd(const float* g, const float* y2, const float* m1,
                      const __nv_bfloat16* csin, const float* env,
                      const __nv_bfloat16* abt, float* dcoeffs, float* dreim, float* scal,
                      int batch, int t, int p, int hop, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int lr = t - 1;
  synth_bwd_scalars<<<batch, kRedThreads, 0, st>>>(g, y2, m1, scal, lr * hop);
  Geometry geo{t, lr, hop, 2 * p, +1, abt, (long long)2 * p, (long long)hop * 2 * p};
  launch_shift_gemm<SynthBwdA, StoreEpi, false>(SynthBwdA{g, y2, env, scal, lr, hop},
                                                StoreEpi{dreim, t, 2 * p}, geo, batch,
                                                nullptr, st);
  const long long rows = (long long)batch * t;
  fold_phase<<<elementwise_blocks(rows * p), 256, 0, st>>>(dreim, csin, dcoeffs, rows, p);
  return (int)cudaGetLastError();
}

// y2 (B, T-1, hop) f32, csw (4 hop, 2P) bf16 -> cs2 (B, T, 2P) f32.
int aw_band_analysis_fwd(const float* y2, const __nv_bfloat16* csw, float* cs2, int batch,
                         int t, int p2, int hop, void* stream) {
  const int lr = t - 1;
  Geometry geo{t, lr, hop, p2, +1, csw, (long long)p2, (long long)hop * p2};
  launch_shift_gemm<LoadA, StoreEpi, false>(LoadA{y2, hop, lr}, StoreEpi{cs2, t, p2}, geo,
                                            batch, nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// g (B, T, 2P) f32, cswt (2P, 4 hop) bf16 -> gy2 (B, T-1, hop) f32.
int aw_band_analysis_bwd(const float* g, const __nv_bfloat16* cswt, float* gy2, int batch,
                         int t, int p2, int hop, void* stream) {
  const int lr = t - 1;
  Geometry geo{lr, t, p2, hop, -1, cswt, (long long)kR * hop, (long long)hop};
  launch_shift_gemm<LoadA, StoreEpi, false>(LoadA{g, p2, t}, StoreEpi{gy2, lr, hop}, geo,
                                            batch, nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
