// Round-trip kernels of the embed solver, for Hopper (sm_90a).
//
// They were the first versions of the four Pallas TPU kernels of
// aware_tpu/ops/pallas/roundtrip.py:
//
//   aw_synth_norm_fwd_wmma    <- synth_norm forward (_synth_impl, _synth_kernel)
//   aw_synth_norm_bwd_wmma    <- synth_norm VJP (_synth_bwd, _synth_bwd_kernel)
//   aw_band_analysis_fwd_wmma <- band_analysis forward (_analysis_impl, _analysis_kernel)
//   aw_band_analysis_bwd_wmma <- band_analysis VJP (_analysis_bwd, _analysis_bwd_kernel)
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
// yp, gyp) goes through device memory.
//
// The port's entries moved to TMA into a ring of stages and wgmma, the
// design of slab_gemm_sm90.cuh: the analysis's, aw_band_analysis_fwd and
// aw_band_analysis_bwd, to slab_gemm_sm90.cu; the synthesis's,
// aw_synth_norm_fwd and aw_synth_norm_bwd, to roundtrip_sm90.cu, as the
// sm90 step's synthesis stages.  The four here are kept so that
// chip_smoke.py can time each beside its successor in turns; no wrapper
// reaches them.
//
// Every kernel runs on the caller's stream and allocates nothing; each C
// entry returns cudaGetLastError() so that a refused launch is reported.

#include "roundtrip.cuh"

namespace {

// y2 = u / peak_den(m1) in place; m1 out.
__global__ void peak_scale(float* y, const unsigned int* max_bits, float* m1,
                           long long per_clip, int batch) {
  const long long total = per_clip * batch;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const float m = __uint_as_float(max_bits[i / per_clip]);
    y[i] = y[i] / peak_den(m);
    if (i < batch) m1[i] = __uint_as_float(max_bits[i]);
  }
}

// Per clip (one block each): the peak-norm VJP's scalars.
__global__ void __launch_bounds__(kRedThreads)
synth_bwd_scalars(const float* g, const float* y2, const float* m1, float* scal,
                  int per_clip) {
  __shared__ float sh[kRedThreads / 32];
  const int b = blockIdx.x;
  synth_bwd_scalars_clip(g + (long long)b * per_clip, y2 + (long long)b * per_clip, m1[b],
                         false, scal + 4 * b, per_clip, sh);
}

}  // namespace

extern "C" {

// coeffs (B, T, P) f32, csin (B, T, 2P) bf16, y_const (B, T-1, hop) f32,
// env (T-1, hop) f32, ab (2P, 4 hop) bf16 -> y2 (B, T-1, hop) f32, m1 (B,) f32;
// max_bits (B,) u32 scratch.
int aw_synth_norm_fwd_wmma(const float* coeffs, const __nv_bfloat16* csin, const float* y_const,
                      const float* env, const __nv_bfloat16* ab, float* y2, float* m1,
                      unsigned int* max_bits, int batch, int t, int p, int hop,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int lr = t - 1;
  cudaMemsetAsync(max_bits, 0, sizeof(unsigned int) * batch, st);
  Geometry g{lr, 0, t, 2 * p, hop, kR, -1, kPad, ab, (long long)kR * hop, (long long)hop};
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
int aw_synth_norm_bwd_wmma(const float* g, const float* y2, const float* m1,
                      const __nv_bfloat16* csin, const float* env,
                      const __nv_bfloat16* abt, float* dcoeffs, float* dreim, float* scal,
                      int batch, int t, int p, int hop, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int lr = t - 1;
  synth_bwd_scalars<<<batch, kRedThreads, 0, st>>>(g, y2, m1, scal, lr * hop);
  Geometry geo{t, 0, lr, hop, 2 * p, kR, +1, kPad, abt, (long long)2 * p,
               (long long)hop * 2 * p};
  launch_shift_gemm<SynthBwdA, StoreEpi, false>(SynthBwdA{g, y2, env, scal, lr, hop, false},
                                                StoreEpi{dreim, t, 2 * p}, geo, batch,
                                                nullptr, st);
  const long long rows = (long long)batch * t;
  fold_phase<<<elementwise_blocks(rows * p), 256, 0, st>>>(dreim, csin, dcoeffs, rows, p);
  return (int)cudaGetLastError();
}

// y2 (B, T-1, hop) f32, csw (4 hop, 2P) bf16 -> cs2 (B, T, 2P) f32.
int aw_band_analysis_fwd_wmma(const float* y2, const __nv_bfloat16* csw, float* cs2,
                              int batch, int t, int p2, int hop, void* stream) {
  const int lr = t - 1;
  Geometry geo{t, 0, lr, hop, p2, kR, +1, kPad, csw, (long long)p2, (long long)hop * p2};
  launch_shift_gemm<LoadA, StoreEpi, false>(LoadA{y2, hop, lr}, StoreEpi{cs2, t, p2}, geo,
                                            batch, nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// g (B, T, 2P) f32, cswt (2P, 4 hop) bf16 -> gy2 (B, T-1, hop) f32.
int aw_band_analysis_bwd_wmma(const float* g, const __nv_bfloat16* cswt, float* gy2,
                              int batch, int t, int p2, int hop, void* stream) {
  const int lr = t - 1;
  Geometry geo{lr, 0, t, p2, hop, kR, -1, kPad, cswt, (long long)kR * hop, (long long)hop};
  launch_shift_gemm<LoadA, StoreEpi, false>(LoadA{g, p2, t}, StoreEpi{gy2, lr, hop}, geo,
                                            batch, nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
