// The reflect-pad analysis of the merged analysis + detector kernels, for
// Hopper (sm_90a).
//
// They replace the analysis halves of the two Pallas TPU kernels of
// aware_tpu/ops/pallas/analysis_detector.py; the detector halves are
// aw_detector_fwd / aw_detector_bwd (detector.cu), which the wrappers
// launch right after:
//
//   aw_reflect_analysis_fwd <- analysis_detector forward (_ad_fwd_kernel:
//                              reflect-pad framing + slab DFT)
//   aw_reflect_analysis_bwd <- analysis_detector VJP (_ad_bwd_kernel:
//                              transposed slabs + reflect-pad routing)
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

#include "tile_gemm.cuh"

namespace {

constexpr int kR = 4;    // slabs: n_fft / hop
constexpr int kPad = 2;  // rows of centre padding: (n_fft / 2) / hop

struct ReflectA {  // padded row s in [-2, lr + 2) of y2 (B, lr, hop)
  const float* y2;
  int lr;
  int hop;
  __device__ float operator()(int b, int s, int c) const {
    const long long len = (long long)lr * hop;
    long long f = (long long)s * hop + c;
    if (f < 0) f = -f;
    else if (f >= len) f = 2 * (len - 1) - f;
    return y2[b * len + f];
  }
};

struct ReflectBwdEpi {  // padded row j: interior -> gy2, pad rows -> bf16 gpad
  float* gy2;   // (B, lr, hop)
  float* gpad;  // (B, 4, hop): the rows before the clip, then the rows after it
  int lr;
  int hop;
  __device__ float operator()(int b, int j, int col, float acc) const {
    if (j >= kPad && j < lr + kPad) {
      gy2[((long long)b * lr + j - kPad) * hop + col] = acc;
    } else {
      const int pr = j < kPad ? j : j - lr;  // 0, 1 | 2, 3
      gpad[((long long)b * 2 * kPad + pr) * hop + col] = bf16_round(acc);
    }
    return 0.f;
  }
};

// gy2[reflected sample] += gpad, one block per clip.
__global__ void reflect_fold(const float* gpad, float* gy2, int lr, int hop) {
  const int b = blockIdx.x;
  const long long len = (long long)lr * hop;
  const int half = kPad * hop;
  for (int e = threadIdx.x; e < 2 * half; e += blockDim.x) {
    const long long f = e < half ? half - e : len - 2 - (e - half);
    gy2[b * len + f] += gpad[(long long)b * 2 * half + e];
  }
}

}  // namespace

extern "C" {

// y2 (B, T-1, hop) f32, csw (4 hop, 2P) bf16 -> cs2 (B, T, 2P) f32.
int aw_reflect_analysis_fwd(const float* y2, const __nv_bfloat16* csw, float* cs2,
                            int batch, int t, int p2, int hop, void* stream) {
  const int lr = t - 1;
  const Geometry geo{t, -kPad, lr + kPad, hop, p2, kR, +1, kPad, csw, (long long)p2,
                     (long long)hop * p2};
  launch_shift_gemm(ReflectA{y2, lr, hop}, StoreEpi{cs2, t, p2}, geo, batch, nullptr,
                    (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// dcs (B, T, 2P) f32, cswt (2P, 4 hop) bf16 -> gy2 (B, T-1, hop) f32;
// scratch gpad (B, 4, hop) f32.
int aw_reflect_analysis_bwd(const float* dcs, const __nv_bfloat16* cswt, float* gy2,
                            float* gpad, int batch, int t, int p2, int hop, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int lr = t - 1;
  // output row j of the padded signal reads dcs row j - k
  const Geometry geo{lr + 2 * kPad, 0, t, p2, hop, kR, -1, 0, cswt, (long long)kR * hop,
                     (long long)hop};
  launch_shift_gemm(LoadA{dcs, p2, t}, ReflectBwdEpi{gy2, gpad, lr, hop}, geo, batch,
                    nullptr, st);
  reflect_fold<<<batch, 2 * kPad * hop < 1024 ? 2 * kPad * hop : 1024, 0, st>>>(
      gpad, gy2, lr, hop);
  return (int)cudaGetLastError();
}

}  // extern "C"
