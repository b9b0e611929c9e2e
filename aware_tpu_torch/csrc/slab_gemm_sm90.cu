// The three shifted-slab GEMM entries redesigned for Hopper (sm_90a): the
// long-clip round trip's shift_mm and the first slice's band_analysis
// forward and VJP, all launches of slab_gemm_sm90.cuh (which says what it
// replaces, what bounds each use and what the design does about it).
// Their earlier WMMA versions stay in roundtrip_tiled.cu and roundtrip.cu
// as aw_shift_mm_wmma, aw_band_analysis_fwd_wmma and
// aw_band_analysis_bwd_wmma, which no wrapper reaches: chip_smoke.py times
// them beside these.
//
// Each entry takes the tile the wrapper planned (bm x bn: 128 x 128,
// 64 x 128 or 64 x 64), runs on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or the error of the tensor-map encoding), so
// that a refused launch is reported.

#include "slab_gemm_sm90.cuh"

extern "C" {

// x (B, N, D) f32, w (4, D, E) bf16 -> out (B, n_out, E) f32:
// out[t] = sum_{o<4} bf16(x[t+o]) @ w[o], rows at or past N read as zero.
int aw_shift_mm(const float* x, const __nv_bfloat16* w, float* out, int batch, int n, int d,
                int e, int n_out, int bm, int bn, void* stream) {
  sm90::Problem pr{x, batch, n, w, 4 * d, e,
                   sm90::Params{n_out, e, d, /*k_row=*/d, /*k_col=*/0, /*dir=*/+1, /*pad=*/0}};
  return sm90::launch_slab_gemm(pr, out, bm, bn, (cudaStream_t)stream);
}

// y2 (B, T-1, hop) f32, csw (4 hop, 2P) bf16 -> cs2 (B, T, 2P) f32:
// cs2[t] = sum_{k<4} bf16(y2[t+k-2]) @ csw[k hop:(k+1) hop, :], rows -2, -1 and
// T-1 read as zero.
int aw_band_analysis_fwd(const float* y2, const __nv_bfloat16* csw, float* cs2, int batch,
                         int t, int p2, int hop, int bm, int bn, void* stream) {
  sm90::Problem pr{y2, batch, t - 1, csw, 4 * hop, p2,
                   sm90::Params{t, p2, hop, /*k_row=*/hop, /*k_col=*/0, /*dir=*/+1, /*pad=*/2}};
  return sm90::launch_slab_gemm(pr, cs2, bm, bn, (cudaStream_t)stream);
}

// g (B, T, 2P) f32, cswt (2P, 4 hop) bf16 -> gy2 (B, T-1, hop) f32:
// gy2[i] = sum_{k<4} bf16(g[i+2-k]) @ cswt[:, k hop:(k+1) hop], row -1 read as zero.
int aw_band_analysis_bwd(const float* g, const __nv_bfloat16* cswt, float* gy2, int batch,
                         int t, int p2, int hop, int bm, int bn, void* stream) {
  sm90::Problem pr{g, batch, t, cswt, p2, 4 * hop,
                   sm90::Params{t - 1, hop, p2, /*k_row=*/0, /*k_col=*/hop, /*dir=*/-1, /*pad=*/2}};
  return sm90::launch_slab_gemm(pr, gy2, bm, bn, (cudaStream_t)stream);
}

// Any geometry of the slab GEMM, with a plain f32 store (the chip check
// holds the step's four round-trip products against float64 this way):
// a (B, n_src, D) f32, w (w_rows, w_cols) bf16 -> out (B, n_out, E) f32.
int aw_slab_gemm(const float* a, const __nv_bfloat16* w, float* out, int batch, int n_src,
                 int d, int w_rows, int w_cols, int n_out, int e, int k_row, int k_col, int dir,
                 int pad, int bm, int bn, void* stream) {
  sm90::Problem pr{a, batch, n_src, w, w_rows, w_cols,
                   sm90::Params{n_out, e, d, k_row, k_col, dir, pad}};
  return sm90::launch_slab_gemm(pr, out, bm, bn, (cudaStream_t)stream);
}

// The dynamic shared memory of a planned tile (-1 if it has none), with
// its threads, ring stages and the registers a thread must get at entry
// (the count its setmaxnreg split assumes), for the build report.
int aw_slab_gemm_config(int bm, int bn, int* threads, int* stages, int* regs) {
  return sm90::tile_config(bm, bn, threads, stages, regs);
}

}  // extern "C"
