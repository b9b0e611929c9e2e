// The reflect-pad analysis's device code, for Hopper (sm_90a), shared by
// analysis_detector.cu (analysis_detector) and iteration.cu
// (iteration_forward, iteration_step).  What it computes:
// analysis_detector.cu.

#pragma once

#include "roundtrip.cuh"

namespace {

// Padded row s in [-2, lr + 2) of the signal rows (B, lr, hop): y2, or,
// given m1, y2 = u / peak_den(m1) formed from the synthesis u as it is
// staged (the same float as the synthesis's own peak-norm).
struct ReflectA {
  const float* y;
  const float* m1;  // nullptr: y is y2
  int lr;
  int hop;
  __device__ float operator()(int b, int s, int c) const {
    const long long len = (long long)lr * hop;
    long long f = (long long)s * hop + c;
    if (f < 0) f = -f;
    else if (f >= len) f = 2 * (len - 1) - f;
    const float v = y[b * len + f];
    return m1 == nullptr ? v : v / peak_den(m1[b]);
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

// gy2[reflected sample] += gpad for one clip, by the threads of one block
// (a one-to-one map for T >= 8, so no two threads touch one sample).
__device__ void reflect_fold_clip(const float* gpad, float* gy2, int lr, int hop) {
  const long long len = (long long)lr * hop;
  const int half = kPad * hop;
  for (int e = threadIdx.x; e < 2 * half; e += blockDim.x) {
    const long long f = e < half ? half - e : len - 2 - (e - half);
    gy2[f] += gpad[e];
  }
}

// gy2[reflected sample] += gpad, one block per clip: the fold after
// either version of the reflect analysis's VJP.
__global__ void reflect_fold(const float* gpad, float* gy2, int lr, int hop) {
  const int b = blockIdx.x;
  reflect_fold_clip(gpad + (long long)b * 2 * kPad * hop, gy2 + (long long)b * lr * hop, lr,
                    hop);
}

void launch_reflect_fold(const float* gpad, float* gy2, int batch, int lr, int hop,
                         cudaStream_t st) {
  reflect_fold<<<batch, 2 * kPad * hop < 1024 ? 2 * kPad * hop : 1024, 0, st>>>(gpad, gy2, lr,
                                                                                 hop);
}

// The reflect-pad analysis GEMM: cs2 (B, T, 2P) from the signal rows
// (ReflectA's y, m1) and csw (4 hop, 2P) bf16.
void launch_reflect_analysis(const float* y, const float* m1, const __nv_bfloat16* csw,
                             float* cs2, int batch, int t, int p2, int hop, cudaStream_t st) {
  const int lr = t - 1;
  const Geometry geo{t, -kPad, lr + kPad, hop, p2, kR, +1, kPad, csw, (long long)p2,
                     (long long)hop * p2};
  launch_shift_gemm(ReflectA{y, m1, lr, hop}, StoreEpi{cs2, t, p2}, geo, batch, nullptr, st);
}

// Its transpose: dcs (B, T, 2P), cswt (2P, 4 hop) bf16 -> the interior
// rows' cotangents into gy2 (B, T-1, hop), the four pad rows' (rounded to
// bf16) into gpad (B, 4, hop); the fold into gy2 is the caller's.
void launch_reflect_analysis_bwd(const float* dcs, const __nv_bfloat16* cswt, float* gy2,
                                 float* gpad, int batch, int t, int p2, int hop,
                                 cudaStream_t st) {
  const int lr = t - 1;
  // output row j of the padded signal reads dcs row j - k
  const Geometry geo{lr + 2 * kPad, 0, t, p2, hop, kR, -1, 0, cswt, (long long)kR * hop,
                     (long long)hop};
  launch_shift_gemm(LoadA{dcs, p2, t}, ReflectBwdEpi{gy2, gpad, lr, hop}, geo, batch, nullptr,
                    st);
}

}  // namespace
