// The reflect-pad analysis of the merged analysis + detector kernels, for
// Hopper (sm_90a).
//
// They replace the analysis halves of the two Pallas TPU kernels of
// aware_tpu/ops/pallas/analysis_detector.py; the detector halves are
// aw_detector_fwd and aw_detector_bwd, which the wrappers launch right
// after and right before:
//
//   aw_reflect_analysis_fwd <- analysis_detector forward (_ad_fwd_kernel:
//                              reflect-pad framing + slab DFT)
//   aw_reflect_analysis_bwd <- analysis_detector VJP (_ad_bwd_kernel:
//                              transposed slabs + reflect-pad routing)
//
// All four are in detector_sm90.cu, on the sm90 slab and dense GEMMs; the
// first versions of the analysis halves stay here as
// aw_reflect_analysis_fwd_wmma and aw_reflect_analysis_bwd_wmma, which no
// wrapper reaches (chip_smoke.py times each beside its sm90 version).
//
// Per clip (T frames, lr = T - 1 signal rows of hop samples, y the
// flattened rows, L = lr * hop, R = 4 slabs, 2 rows of centre padding):
//
//   fwd:  yp = reflect_pad(y, 2 hop) as lr + 4 rows; cs2[t] = sum_k
//         bf16(yp[t + k]) @ csw[k*hop:(k+1)*hop, :]                (T, 2P)
//   bwd:  gyp[j] = sum_k bf16(dcs[j - k]) @ cswt[:, k*hop:(k+1)*hop]
//         for the lr + 4 padded rows j; gy2 = its interior rows, unrounded,
//         plus the 4 pad rows' cotangents, rounded to bf16, routed back to
//         the samples they reflect.
//
// The Pallas kernels build the pad rows as products with 0/1 flip matrices
// (F1, E1, F2, E2).  Each output of those products is one bf16 sample, so
// they are the same function as reading the reflected sample by index:
// position f of the padded signal reads y[-f] before the clip and
// y[2 (L - 1) - f] after it.  The forward's A-operand loader does that;
// the backward's epilogue sends the pad rows' sums to a small scratch, and
// one more kernel adds each to the sample it reflects (a one-to-one map
// for T >= 8, so no two threads touch one sample).  Bounds: as
// band_analysis (roundtrip.cu), a GEMM of 2 * T * 2P * 4 hop FLOP per clip.

#include "analysis_detector.cuh"

extern "C" {

// y2 (B, T-1, hop) f32, csw (4 hop, 2P) bf16 -> cs2 (B, T, 2P) f32.  The
// first WMMA version, which aw_reflect_analysis_fwd (detector_sm90.cu)
// replaced.
int aw_reflect_analysis_fwd_wmma(const float* y2, const __nv_bfloat16* csw, float* cs2,
                            int batch, int t, int p2, int hop, void* stream) {
  launch_reflect_analysis(y2, nullptr, csw, cs2, batch, t, p2, hop, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// dcs (B, T, 2P) f32, cswt (2P, 4 hop) bf16 -> gy2 (B, T-1, hop) f32;
// scratch gpad (B, 4, hop) f32.  The first WMMA version, which
// aw_reflect_analysis_bwd (detector_sm90.cu) replaced; no wrapper reaches
// it: chip_smoke.py times the two in turns.
int aw_reflect_analysis_bwd_wmma(const float* dcs, const __nv_bfloat16* cswt, float* gy2,
                                 float* gpad, int batch, int t, int p2, int hop, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  launch_reflect_analysis_bwd(dcs, cswt, gy2, gpad, batch, t, p2, hop, st);
  launch_reflect_fold(gpad, gy2, batch, t - 1, hop, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
