// What the sm90 chains' passes share (detector_sm90.cuh's detector stages,
// roundtrip_sm90.cuh's synthesis stages): the block size of the chunked
// reductions, the room of a clip's partial sums, the block reduction in
// a fixed order, and the error macros of the host chains.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kRedBlock = 256;   // threads of the chunked reductions and passes
constexpr int kPartLd = 4096;    // floats of one clip's partial sums

#define AW_TRY(call)               \
  if ((err = (call)) != 0) return err
#define AW_LAUNCHED() AW_TRY((int)cudaGetLastError())

// The sum (or max) over a kRedBlock block in a fixed order: every thread
// gets it.
template <bool kIsMax>
__device__ float block_reduce(float v, float* sh) {
  for (int o = 16; o > 0; o /= 2) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kIsMax ? fmaxf(v, w) : v + w;
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) sh[threadIdx.x / 32] = v;
  __syncthreads();
  float s = sh[0];
  for (int w = 1; w < kRedBlock / 32; ++w) s = kIsMax ? fmaxf(s, sh[w]) : s + sh[w];
  return s;
}

}  // namespace
