// The detector_fused and analysis_detector kernels for Hopper (sm_90a),
// both directions, as the sm90 step's two halves compute them
// (detector_sm90.cuh: one definition of each stage):
//
//   aw_detector_fwd          <- aware_tpu/ops/pallas/detector.py detector_fused
//                               forward (pallas_call :310, _fwd_kernel):
//                               det_fwd_sm90 from cs, 16 launches
//   aw_reflect_analysis_fwd  <- the analysis half of
//                               aware_tpu/ops/pallas/analysis_detector.py's
//                               forward (pallas_call :177, _ad_fwd_kernel):
//                               reflect_pad, then the slab GEMM, 2 launches
//   aw_detector_bwd          <- aware_tpu/ops/pallas/detector.py detector_fused
//                               VJP (pallas_call :401, _bwd_kernel): det_bwd_sm90
//                               from g, 13 launches
//   aw_reflect_analysis_bwd  <- the analysis half of
//                               aware_tpu/ops/pallas/analysis_detector.py's VJP
//                               (pallas_call :251, _ad_bwd_kernel): the slab
//                               GEMM with the pad rows routed to a scratch,
//                               then reflect_fold (analysis_detector.cuh), 2
//                               launches
//
// The analysis_detector forward (row 7 of PERF.md) is aw_reflect_analysis_fwd
// then aw_detector_fwd (18 launches), its VJP (row 8) aw_detector_bwd then
// aw_reflect_analysis_bwd, each pair from its wrapper
// (ops/kernels/analysis_detector.py).  Their first WMMA versions stay as
// aw_detector_fwd_wmma, aw_detector_bwd_wmma (detector.cu),
// aw_reflect_analysis_fwd_wmma and aw_reflect_analysis_bwd_wmma
// (analysis_detector.cu), which no wrapper reaches: chip_smoke.py times
// each beside its sm90 chain in turns.  At B = 8, T = 626 the detector's
// five GEMMs take 9.2 GFLOP each way, 9.3 us at the bf16 peak; the WMMA
// chains measured 0.70 ms (forward) and 0.72 ms (VJP) (PERF.md): their A
// loaders built every operand element by element and their mel
// statistics ran one block per clip.  Here every product only loads its
// A, written in bf16 by the pass before it, and the mel statistics run
// over (row chunk, clip) blocks whose partial sums the next stage
// finishes in one fixed order, so that a repeated launch gives the same
// bits.  The fold adds 1024 rounded samples a clip, one block per clip.
//
// Each entry refuses, before any launch, what its chain cannot take, runs
// on the caller's stream, allocates nothing and returns the first CUDA
// error of a launch (or cudaGetLastError()).

#include "detector_sm90.cuh"

extern "C" {

// cs (B, T, 2P) f32; melb (P, 128), w0t..w3t (C_in, C_out) bf16; biases
// (4, 1024), eo (128, 128) f32 -> pred (B, 128) f32 and the residuals nph
// (B, T, 2P), mel (B, T, 128), y0..y3 (B, T2, C_i) bf16; mu1, r1 (B, 128),
// rin0..rin3 (B, C_i), gmu, gr, s (B,) f32.  Scratch: mel32 (B, T, 128),
// ha, hb (B, T2, 1024), mu (B, 1024), pool4 (B, 128) f32; a16 (B, max(T2
// 1024, T P)) bf16; part (B, 4096) f32.  tiles: (bm, bn) of the 5 GEMMs
// (mel, conv 0..3), as the wrapper planned them.  Refuses T < 8, mel
// stages whose partial sums do not fit part and a wrong length of the
// tile array.
int aw_detector_fwd(const float* cs, const bf16* melb, const bf16* w0t, const bf16* w1t,
                    const bf16* w2t, const bf16* w3t, const float* biases, const float* eo,
                    float* pred, bf16* nph, bf16* mel_bf, bf16* y0, bf16* y1, bf16* y2,
                    bf16* y3, float* mu1, float* r1, float* rin0, float* rin1, float* rin2,
                    float* rin3, float* gmu, float* gr, float* s, float* mel32, float* ha,
                    float* hb, float* mu, float* pool4, bf16* a16, float* part,
                    const int* tiles, int n_tiles, int batch, int t, int p, void* stream) {
  if (n_tiles != 2 * gDetFwdGemms || t < kMinFrames || !mel_fits(t))
    return (int)cudaErrorInvalidValue;
  IterScratch w{};
  w.mel32 = mel32;
  w.ha = ha;
  w.hb = hb;
  w.mu = mu;
  w.small = pool4;
  return det_fwd_sm90(cs, DetFwdConsts{melb, w0t, w1t, w2t, w3t, biases, eo},
                      DetRes{pred, nph, mel_bf, y0, y1, y2, y3, mu1, r1, rin0, rin1, rin2, rin3,
                             gmu, gr, s},
                      w, a16, part, Tiles{tiles}, batch, t, p, (cudaStream_t)stream);
}

// y2 (B, T-1, hop) f32, csw (4 hop, 2P) bf16 -> cs2 (B, T, 2P) f32;
// scratch ypad (B, T+3, hop) f32, the reflect-padded rows: the pass, then
// the slab GEMM on the planned tile (bm, bn).  Refuses T < 8.
int aw_reflect_analysis_fwd(const float* y2, const bf16* csw, float* cs2, float* ypad,
                            int batch, int t, int p2, int hop, int bm, int bn, void* stream) {
  if (t < kMinFrames) return (int)cudaErrorInvalidValue;
  return reflect_analysis_fwd_sm90(y2, nullptr, csw, ypad, cs2, bm, bn, batch, t, p2, hop,
                                   (cudaStream_t)stream);
}

// g (B, 128) f32 and the forward's 16 residuals (aw_detector_fwd's); w0..w3
// (C_out, C_in) bf16, eot (128, 128) f32, melbt (128, P) bf16 -> dcs
// (B, T, 2P) f32.  Scratch: dxa, dxb (B, T2, 1024), m1, m2 (B, 1024), dx4
// (B, 128) f32; a16 (B, max(T2 1024, T 128)) bf16; part (B, 4096) f32.
// tiles: (bm, bn) of the 5 GEMMs (conv 3, 2, 1, 0 VJP, mel VJP), as the
// wrapper planned them.  Refuses T < 8, mel stages whose partial sums do
// not fit part and a wrong length of the tile array.
int aw_detector_bwd(const float* g, float* pred, bf16* nph, bf16* mel_bf, bf16* y0, bf16* y1,
                    bf16* y2, bf16* y3, float* mu1, float* r1, float* rin0, float* rin1,
                    float* rin2, float* rin3, float* gmu, float* gr, float* s, const bf16* w0,
                    const bf16* w1, const bf16* w2, const bf16* w3, const float* eot,
                    const bf16* melbt, float* dcs, float* dxa, float* dxb, float* m1,
                    float* m2, float* dx4, bf16* a16, float* part, const int* tiles,
                    int n_tiles, int batch, int t, int p, void* stream) {
  if (n_tiles != 2 * gDetBwdGemms || t < kMinFrames || !mel_fits(t))
    return (int)cudaErrorInvalidValue;
  IterScratch w{};
  w.ha = dxa;
  w.hb = dxb;
  w.mu = m1;
  w.m2 = m2;
  w.small = dx4;
  return det_bwd_sm90(g, nullptr, nullptr,
                      DetRes{pred, nph, mel_bf, y0, y1, y2, y3, mu1, r1, rin0, rin1, rin2, rin3,
                             gmu, gr, s},
                      DetBwdConsts{w0, w1, w2, w3, eot, melbt}, dcs, w, a16, part,
                      Tiles{tiles}, batch, t, p, (cudaStream_t)stream);
}

// dcs (B, T, 2P) f32, cswt (2P, 4 hop) bf16 -> gy2 (B, T-1, hop) f32;
// scratch gpad (B, 4, hop) f32: the slab GEMM on the planned tile (bm,
// bn), then the fold of the four pad rows.  Refuses T < 8 (the fold's map
// is one to one from there).
int aw_reflect_analysis_bwd(const float* dcs, const bf16* cswt, float* gy2, float* gpad,
                            int batch, int t, int p2, int hop, int bm, int bn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (t < kMinFrames) return (int)cudaErrorInvalidValue;
  const int err = reflect_analysis_bwd_sm90(dcs, cswt, gy2, gpad, bm, bn, batch, t, p2, hop, st);
  if (err != 0) return err;
  launch_reflect_fold(gpad, gy2, batch, t - 1, hop, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
