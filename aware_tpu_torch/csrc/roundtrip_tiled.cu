// Long-clip round-trip kernels of the embed solver, for Hopper (sm_90a).
//
// They replace the two Pallas TPU kernels of aware_tpu/ops/pallas/roundtrip_tiled.py,
// the JAX package's round trip for clips over 1024 frames:
//
//   aw_shift_mm        <- shift_mm                  (_shift_mm_core, _shift_mm_kernel)
//   aw_synth_tiled_fwd <- synth_norm_tiled forward  (_synth_core,    _synth_tiled_kernel)
//
// What they compute, per clip b of a batch (R = 4 slabs):
//
//   shift_mm:   out[t] = sum_{o<4} bf16(x[t+o]) @ w[o]   for t < n_out,
//               x (N, D) f32 with rows at or past N read as zero, w (4, D, E) bf16;
//   synth fwd:  with ctp = ct (T, P) padded by one zero row before and two
//               after (row m+1 holds frame m) and csinp (T+3, 2P) f32,
//               acc[j] = sum_{o<4} bf16(ctp[j+o] * csinp[j+o]) @ w_sf[o]
//               (the Re and Im products side by side along the 2P depth),
//               u[j]   = acc[j] / env[j] + y_const[j]    for j < lr = T-1 (written),
//               m1     = max |u[j]| over j < m_rows, rows j >= lr taken with
//               env 1 and y_const 0 and not written.
//
// m_rows = min(ceil(lr / 256) * 256, lr + 2) is the TPU kernel's tail rule:
// it takes the running max over its whole last 256-row tile, padded with
// env 1 and y_const 0, and rows lr and lr+1 still hold the overlap-add
// tail of the last two frames (ops/kernels/roundtrip_tiled.py says more).
//
// The TPU kernels grid over 256-frame tiles with a 3-row halo copied into
// VMEM, and carry m1 across the sequential grid; here each is one launch of
// the shifted-slab GEMM of tile_gemm.cuh over all clips, reading device
// memory directly, with m1 an atomicMax of float bits per clip written
// straight into the m1 tensor.  At the long path's shapes (B = 8, T = 3751,
// P = 256, hop = 256) each launch is 2 * 8 * 3751 * 4 * 256 * 512 = 31.5
// GFLOP; shift_mm moves about 93 MB (about 340 operations per byte, just
// over the H100's bf16 ridge of 295: operations bound it), the synthesis
// about 158 MB (about 200 per byte: bytes bound it).  The simple right
// version: 64 x 64 WMMA tiles, unpipelined staging; the synthesis builds
// its bf16 operand from ct and csinp while it stages it.
//
// Each kernel runs on the caller's stream and allocates nothing; each C
// entry returns cudaGetLastError() so that a refused launch is reported.

#include "roundtrip.cuh"

namespace {

// bf16(ctp[s] * csinp[s]) for ctp rows s in [1, T] (frame s-1); the
// geometry reads every other row as zero.  ct (B, T, P), csinp (B, T+3, 2P).
struct TiledSynthA {
  const float* ct;
  const float* csinp;
  int t;
  int p;
  __device__ float operator()(int b, int s, int c) const {
    const int cc = c < p ? c : c - p;
    return ct[((long long)b * t + s - 1) * p + cc] *
           csinp[((long long)b * (t + 3) + s) * 2 * p + c];
  }
};

// SynthEpi for the rows of u; the tail rows past it enter the max only.
struct TiledSynthEpi {
  SynthEpi rows;
  __device__ float operator()(int b, int row, int col, float acc) const {
    if (row >= rows.lr) return fabsf(acc);  // acc / 1 + 0
    return rows(b, row, col, acc);
  }
};

}  // namespace

extern "C" {

// x (B, N, D) f32, w (4, D, E) bf16 -> out (B, n_out, E) f32.
int aw_shift_mm(const float* x, const __nv_bfloat16* w, float* out, int batch, int n, int d,
                int e, int n_out, void* stream) {
  Geometry g{n_out, 0, n, d, e, kR, +1, 0, w, (long long)e, (long long)d * e};
  launch_shift_gemm<LoadA, StoreEpi, false>(LoadA{x, d, n}, StoreEpi{out, n_out, e}, g, batch,
                                            nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// ct (B, T, P) f32, csinp (B, T+3, 2P) f32, y_const (B, T-1, hop) f32,
// env (T-1, hop) f32, w_sf (4, 2P, hop) bf16 -> u (B, T-1, hop) f32, m1 (B,) f32.
int aw_synth_tiled_fwd(const float* ct, const float* csinp, const float* y_const,
                       const float* env, const __nv_bfloat16* w_sf, float* u, float* m1,
                       int batch, int t, int p, int hop, int m_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(m1, 0, sizeof(float) * batch, st);
  Geometry g{m_rows, 1, t + 1, 2 * p, hop, kR, +1, 0, w_sf, (long long)hop,
             (long long)2 * p * hop};
  launch_shift_gemm<TiledSynthA, TiledSynthEpi, true>(
      TiledSynthA{ct, csinp, t, p}, TiledSynthEpi{SynthEpi{u, env, y_const, t - 1, hop}}, g,
      batch, reinterpret_cast<unsigned int*>(m1), st);
  return (int)cudaGetLastError();
}

}  // extern "C"
