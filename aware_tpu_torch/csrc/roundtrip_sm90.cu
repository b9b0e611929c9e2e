// The synth_norm forward and VJP for Hopper (sm_90a), as the sm90 step's
// synthesis stages compute them (roundtrip_sm90.cuh: one definition of
// each stage, shared with iteration_sm90.cu):
//
//   aw_synth_norm_fwd  <- aware_tpu/ops/pallas/roundtrip.py synth_norm forward
//                         (pallas_call :179, _synth_kernel :52): the step's
//                         synthesis (reim_pass, the slab GEMM with
//                         SlabSynthEpi), then peak_scale_rows: 3 launches
//   aw_synth_norm_bwd  <- the synth_norm VJP (pallas_call :223,
//                         _synth_bwd_kernel :85): the step's synthesis VJP
//                         on y2 itself with no reflect fold
//                         (synth_vjp_sm90<SynthVjp>: fold_partial,
//                         ties_partial, gcrop_pass, the slab GEMM), then
//                         fold_phase: 5 launches
//
// What they compute: roundtrip.cu.  Their first versions stay in
// roundtrip.cu as aw_synth_norm_fwd_wmma and aw_synth_norm_bwd_wmma, which
// no wrapper reaches (chip_smoke.py times each beside these).  Those ran
// at 58x and 72x their 0.0066 ms bounds at B = 8, T = 626 (PERF.md),
// slower than the plain versions: their products were unpipelined WMMA
// whose A loaders formed coeffs x csin, or the whole peak-norm
// subgradient over env, element by element while they staged each tile,
// and the VJP's scalars ran one block per clip (8 blocks on 132 SMs).
// Here every product only loads its A (f32 reim or gcrop, written by the
// pass before it) through TMA into wgmma with two-level sums, and the
// scalars run over (4096-sample chunk, clip) blocks whose partial sums
// the next launch finishes in one fixed order: a repeated launch gives
// the same bits.  Both functions move about 22 MB at these shapes (6.6
// us at 3.35 TB/s) for 5.2 GFLOP (5.3 us of bf16 tensor work): bytes and
// operations bound them nearly alike.
//
// Each entry takes the tiles the wrapper planned (ops/kernels/roundtrip.py,
// the step's own for its synthesis GEMMs), refuses before any launch what
// the stages cannot take (T < 2, the VJP's (T-1) hop past the partial
// sums' room, a tile array of another length), allocates nothing (reim,
// gcrop, dreim, the partial sums and the scalars are the caller's), runs on
// the caller's stream and returns the first CUDA error of a launch (or
// cudaGetLastError()).

#include "roundtrip_sm90.cuh"

namespace {

// y2 = u / peak_den(m1) in place, u (B, per_clip) with per_clip % 4 == 0,
// one float4 a thread over (chunk, clip) blocks.
__global__ void peak_scale_rows(float4* y, const float* m1, long long per_clip) {
  const int b = blockIdx.y;
  const float cden = peak_den(m1[b]);
  float4* yb = y + b * (per_clip / 4);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < per_clip / 4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 v = yb[i];
    v.x = v.x / cden;
    v.y = v.y / cden;
    v.z = v.z / cden;
    v.w = v.w / cden;
    yb[i] = v;
  }
}

}  // namespace

extern "C" {

// The forward's first two launches alone (the step's synthesis): coeffs
// (B, T, P) f32, csin (B, T, 2P) bf16, y_const (B, T-1, hop) f32, env (T-1,
// hop) f32, ab (2P, 4 hop) bf16, reim (B, T, 2P) f32 scratch -> u (B, T-1,
// hop) f32, m1 (B,) f32.  tiles: the synthesis GEMM's (bm, bn).
int aw_synth_u(const float* coeffs, const __nv_bfloat16* csin, const float* y_const,
               const float* env, const __nv_bfloat16* ab, float* reim, float* u, float* m1,
               const int* tiles, int n_tiles, int batch, int t, int p, int hop, void* stream) {
  if (n_tiles != 2 || t < 2 || batch < 1) return (int)cudaErrorInvalidValue;
  return synth_fwd_sm90(coeffs, csin, ab, env, y_const, reim, u, m1, tiles[0], tiles[1], batch,
                        t, p, hop, (cudaStream_t)stream);
}

// synth_norm's forward: aw_synth_u with u written into y2, then y2 = u /
// peak_den(m1) in place.  3 launches.
int aw_synth_norm_fwd(const float* coeffs, const __nv_bfloat16* csin, const float* y_const,
                      const float* env, const __nv_bfloat16* ab, float* reim, float* y2,
                      float* m1, const int* tiles, int n_tiles, int batch, int t, int p, int hop,
                      void* stream) {
  const int err = aw_synth_u(coeffs, csin, y_const, env, ab, reim, y2, m1, tiles, n_tiles,
                             batch, t, p, hop, stream);
  if (err != 0) return err;
  const long long per_clip = (long long)(t - 1) * hop;
  const long long blocks = (per_clip / 4 + kRedBlock - 1) / kRedBlock;
  peak_scale_rows<<<dim3((unsigned)(blocks < 1024 ? blocks : 1024), batch), kRedBlock, 0,
                    (cudaStream_t)stream>>>(reinterpret_cast<float4*>(y2), m1, per_clip);
  return (int)cudaGetLastError();
}

// synth_norm's VJP: g, y2 (B, T-1, hop) f32, m1 (B,) f32, csin (B, T, 2P)
// bf16, env (T-1, hop) f32, abt (4 hop, 2P) bf16 -> dcoeffs (B, T, P) f32.
// Scratch: dreim (B, T, 2P), gcrop (B, T-1, hop), part (B, 4096), scal (B,
// 4) f32.  tiles: the synthesis-VJP GEMM's (bm, bn).  g is only read.  5
// launches.
int aw_synth_norm_bwd(const float* g, const float* y2, const float* m1,
                      const __nv_bfloat16* csin, const float* env, const __nv_bfloat16* abt,
                      float* dcoeffs, float* dreim, float* gcrop, float* part, float* scal,
                      const int* tiles, int n_tiles, int batch, int t, int p, int hop,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles != 2 || t < 2 || batch < 1 || !fold_fits(t, hop)) return (int)cudaErrorInvalidValue;
  // SynthVjp's fold_partial writes nothing to its gy2
  const int err = synth_vjp_sm90<SynthVjp>(nullptr, const_cast<float*>(g), y2, m1, env, abt,
                                           part, scal, gcrop, dreim, tiles[0], tiles[1], batch,
                                           t, 2 * p, hop, st);
  if (err != 0) return err;
  const long long rows = (long long)batch * t;
  fold_phase<<<elementwise_blocks(rows * p), 256, 0, st>>>(dreim, csin, dcoeffs, rows, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
