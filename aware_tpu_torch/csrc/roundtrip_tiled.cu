// Long-clip round-trip kernels of the embed solver, for Hopper (sm_90a).
//
// They replace the two Pallas TPU kernels of aware_tpu/ops/pallas/roundtrip_tiled.py,
// the JAX package's round trip for clips over 1024 frames:
//
//   aw_shift_mm        <- shift_mm                  (_shift_mm_core, _shift_mm_kernel)
//   aw_synth_tiled_fwd <- synth_norm_tiled forward  (_synth_core,    _synth_tiled_kernel)
//
// shift_mm's entry, aw_shift_mm, is in slab_gemm_sm90.cu (TMA, a ring of
// stages, wgmma); the synthesis's is here, on the same template.  Their
// first WMMA versions stay here as aw_shift_mm_wmma and
// aw_synth_tiled_fwd_wmma, kept so that chip_smoke.py can time each pair
// in turns; no wrapper reaches them.
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
// VMEM, and carry m1 across the sequential grid; here m1 is an atomicMax
// of float bits per clip written straight into the m1 tensor.  At the long
// path's shapes (B = 8, T = 3751, P = 256, hop = 256) each product is
// 2 * 8 * 3751 * 4 * 256 * 512 = 31.5 GFLOP; shift_mm moves about 93 MB
// (about 340 operations per byte, just over the H100's bf16 ridge of 295:
// operations bound it), the synthesis about 158 MB (about 200 per byte:
// bytes bound it).
//
// The synthesis (aw_synth_tiled_fwd) is two launches:
//   * tiled_reim: reim[b, m] = ct[b, m] csinp[b, m + 1] (B, T, 2P) in f32,
//     the product TiledSynthA forms for padded row m + 1, unrounded; it
//     also zeroes m1.  (The first version's loader formed it element by
//     element while it staged each tile, which ran 2-3x slower than
//     loaders that only load, PERF.md.)
//   * one slab GEMM (slab_gemm_sm90.cuh) over A = reim with w_sf's four
//     slabs, dir +1 and pad 1: output row j reads reim rows j - 1 .. j + 2,
//     the 3-D tensor map zero-filling rows -1, T and T + 1 of each clip
//     (ctp's zero rows); its consumers round each f32 product with
//     cvt.rn.bf16x2, the bf16 of the same float the first version rounded,
//     and sum in two levels (the tensor cores one 32-deep chunk of the four
//     slabs from zero, f32 adds across chunks).  Its epilogue
//     (SlabSynthTailEpi) writes u below lr and takes m1 over m_rows rows
//     by the tail rule.
// aw_synth_tiled_reim and aw_synth_tiled_gemm are the two launches alone
// (the chip check times each).  The entries run on the caller's stream,
// allocate nothing (reim is the caller's) and return cudaGetLastError()
// (or the error of a tensor-map encoding), so that a refused launch is
// reported.

#include "roundtrip.cuh"
#include "slab_gemm_sm90.cuh"

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

// reim (B, T, 2P) f32: row m = ct[m] (both halves) * csinp[m + 1], one
// float4 a thread (P % 4 == 0); m1 = 0 for the GEMM's atomicMax.
__global__ void tiled_reim(const float4* ct, const float4* csinp, float4* reim, float* m1,
                           int batch, int t, int p) {
  const int q = p / 4;  // float4 of a half row
  const long long rows = (long long)batch * t;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long b = r / t;
    const float4* x = ct + r * q;
    const float4* s = csinp + (r + b * 3 + 1) * 2 * q;  // row b (T+3) + m + 1
    float4* out = reim + r * 2 * q;
    for (int c = threadIdx.x; c < 2 * q; c += blockDim.x) {
      const float4 xv = x[c < q ? c : c - q];
      const float4 sv = s[c];
      out[c] = make_float4(xv.x * sv.x, xv.y * sv.y, xv.z * sv.z, xv.w * sv.w);
    }
    if (r < batch && threadIdx.x == 0) m1[r] = 0.f;
  }
}

}  // namespace

extern "C" {

// x (B, N, D) f32, w (4, D, E) bf16 -> out (B, n_out, E) f32.
int aw_shift_mm_wmma(const float* x, const __nv_bfloat16* w, float* out, int batch, int n,
                     int d, int e, int n_out, void* stream) {
  Geometry g{n_out, 0, n, d, e, kR, +1, 0, w, (long long)e, (long long)d * e};
  launch_shift_gemm<LoadA, StoreEpi, false>(LoadA{x, d, n}, StoreEpi{out, n_out, e}, g, batch,
                                            nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The synthesis's reim pass alone: ct (B, T, P) f32, csinp (B, T+3, 2P)
// f32 -> reim (B, T, 2P) f32; m1 (B,) = 0.  Needs P % 4 == 0 and ct,
// csinp, reim 16-byte aligned.
int aw_synth_tiled_reim(const float* ct, const float* csinp, float* reim, float* m1, int batch,
                        int t, int p, void* stream) {
  if (p % 4 != 0 || batch < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * t;
  tiled_reim<<<(int)(rows < 16384 ? rows : 16384), 128, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(ct), reinterpret_cast<const float4*>(csinp),
      reinterpret_cast<float4*>(reim), m1, batch, t, p);
  return (int)cudaGetLastError();
}

// The synthesis's slab GEMM alone, on the planned bm x bn tile: reim (B, T,
// 2P) f32, y_const (B, T-1, hop) f32, env (T-1, hop) f32, w_sf (4, 2P,
// hop) bf16 -> u (B, T-1, hop) f32, and the bits of max |u| over m_rows
// rows by the tail rule folded into m1 (B,) (which the reim pass zeroes).
int aw_synth_tiled_gemm(const float* reim, const float* y_const, const float* env,
                        const __nv_bfloat16* w_sf, float* u, float* m1, int batch, int t, int p,
                        int hop, int m_rows, int bm, int bn, void* stream) {
  sm90::Problem pr{reim, batch, t, w_sf, 4 * 2 * p, hop,
                   sm90::Params{m_rows, hop, 2 * p, /*k_row=*/2 * p, /*k_col=*/0, /*dir=*/+1,
                                /*pad=*/1}};
  sm90::SlabSynthTailEpi epi{{u, env, y_const, reinterpret_cast<unsigned int*>(m1), t - 1, hop}};
  return sm90::launch_slab_gemm(pr, epi, bm, bn, (cudaStream_t)stream);
}

// ct (B, T, P) f32, csinp (B, T+3, 2P) f32, y_const (B, T-1, hop) f32,
// env (T-1, hop) f32, w_sf (4, 2P, hop) bf16, reim (B, T, 2P) f32 scratch
// -> u (B, T-1, hop) f32, m1 (B,) f32: the reim pass, then the slab GEMM
// on the planned bm x bn tile.
int aw_synth_tiled_fwd(const float* ct, const float* csinp, const float* y_const,
                       const float* env, const __nv_bfloat16* w_sf, float* reim, float* u,
                       float* m1, int batch, int t, int p, int hop, int m_rows, int bm, int bn,
                       void* stream) {
  const int err = aw_synth_tiled_reim(ct, csinp, reim, m1, batch, t, p, stream);
  if (err != 0) return err;
  return aw_synth_tiled_gemm(reim, y_const, env, w_sf, u, m1, batch, t, p, hop, m_rows, bm, bn,
                             stream);
}

// The first version of aw_synth_tiled_fwd, on the WMMA template (the same
// operands but reim; the loader forms the products while it stages).
int aw_synth_tiled_fwd_wmma(const float* ct, const float* csinp, const float* y_const,
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
