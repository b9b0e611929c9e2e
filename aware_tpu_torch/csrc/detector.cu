// The fused detector's kernels, for Hopper (sm_90a).
//
// They replace the two Pallas TPU kernels of aware_tpu/ops/pallas/detector.py:
//
//   aw_detector_fwd <- detector_fused forward (_fwd_impl, _fwd_kernel, _det_fwd_values)
//   aw_detector_bwd <- detector_fused VJP     (_bwd_impl, _bwd_kernel, _det_bwd_values)
//
// Both are in detector_sm90.cu, the sm90 step's detector halves; the first
// chains stay here as aw_detector_fwd_wmma and aw_detector_bwd_wmma, which
// no wrapper reaches (chip_smoke.py times each pair in turns).
//
// The device code and the two chains of launches are in detector.cuh, which
// the whole-iteration entries of iteration.cu share.
//
// At the main path's shapes (B = 8, T = 626) the forward is 2 * 8 * (626 *
// 256 * 128 + 313 * (128 * 512 + 512 * 1024 + 1024 * 1024 + 1024 * 128))
// = 9.2 GFLOP over about 34 MB of operands and residuals, 270 FLOP per
// byte, near the bf16 ridge of the H100 (295): the tensor cores and the
// memory bound it about equally (about 10 us); the backward is the same
// GEMMs transposed.  These first versions were the simple right ones; their
// times are in PERF.md.
//
// Every kernel runs on the caller's stream and allocates nothing; each C
// entry returns cudaGetLastError() so that a refused launch is reported.

#include "detector.cuh"

extern "C" {

// cs (B, T, 2P) f32; melb (P, 128), w0t..w3t (C_in, C_out) bf16; biases
// (4, 1024), eo (128, 128) f32 -> pred (B, 128) f32 and the residuals nph
// (B, T, 2P), mel (B, T, 128), y0..y3 (B, T2, C_i) bf16; mu1, r1 (B, 128),
// rin0..rin3 (B, C_i), gmu, gr, s (B,) f32.  Scratch: mel32 (B, T, 128),
// ha, hb (B, T2, 1024), mu (B, 1024), pool4 (B, 128) f32.  The first WMMA
// chain of the forward, which aw_detector_fwd (detector_sm90.cu) replaced;
// no wrapper reaches it: chip_smoke.py times the two in turns.
int aw_detector_fwd_wmma(const float* cs, const __nv_bfloat16* melb, const __nv_bfloat16* w0t,
                    const __nv_bfloat16* w1t, const __nv_bfloat16* w2t,
                    const __nv_bfloat16* w3t, const float* biases, const float* eo,
                    float* pred, __nv_bfloat16* nph, __nv_bfloat16* mel_bf,
                    __nv_bfloat16* y0, __nv_bfloat16* y1, __nv_bfloat16* y2,
                    __nv_bfloat16* y3, float* mu1, float* r1, float* rin0, float* rin1,
                    float* rin2, float* rin3, float* gmu, float* gr, float* s,
                    float* mel32, float* ha, float* hb, float* mu, float* pool4,
                    int batch, int t, int p, void* stream) {
  detector_fwd_chain(cs, DetFwdConsts{melb, w0t, w1t, w2t, w3t, biases, eo},
                     DetRes{pred, nph, mel_bf, y0, y1, y2, y3, mu1, r1, rin0, rin1, rin2, rin3,
                            gmu, gr, s},
                     DetFwdScratch{mel32, ha, hb, mu, pool4}, batch, t, p,
                     (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// g (B, 128) f32 and the forward's outputs (see aw_detector_fwd_wmma); w0..w3
// (C_out, C_in) bf16, eot (128, 128) f32, melbt (128, P) bf16 -> dcs
// (B, T, 2P) f32.  Scratch: dxa, dxb (B, T2, 1024), m1, m2 (B, 1024),
// dx4 (B, 128), clip2 (B, 2) f32.  The first WMMA chain of the VJP, which
// aw_detector_bwd (detector_sm90.cu) replaced; no wrapper reaches it:
// chip_smoke.py times the two in turns.
int aw_detector_bwd_wmma(const float* g, float* pred, __nv_bfloat16* nph,
                         __nv_bfloat16* mel_bf, __nv_bfloat16* y0, __nv_bfloat16* y1,
                         __nv_bfloat16* y2, __nv_bfloat16* y3, float* mu1, float* r1,
                         float* rin0, float* rin1, float* rin2, float* rin3, float* gmu,
                         float* gr, float* s, const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                         const __nv_bfloat16* w2, const __nv_bfloat16* w3, const float* eot,
                         const __nv_bfloat16* melbt, float* dcs, float* dxa, float* dxb,
                         float* m1, float* m2, float* dx4, float* clip2, int batch, int t,
                         int p, void* stream) {
  detector_bwd_chain(g, nullptr, nullptr,
                     DetRes{pred, nph, mel_bf, y0, y1, y2, y3, mu1, r1, rin0, rin1, rin2, rin3,
                            gmu, gr, s},
                     DetBwdConsts{w0, w1, w2, w3, eot, melbt}, dcs,
                     DetBwdScratch{dxa, dxb, m1, m2, dx4, clip2}, batch, t, p,
                     (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
