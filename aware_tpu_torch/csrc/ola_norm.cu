// Fused overlap-add -> crop -> envelope -> double peak-norm, and its VJP,
// for Hopper (sm_90a).
//
// They replace the two Pallas TPU kernels of aware_tpu/ops/pallas/ola_norm.py,
// the opt-in use_pallas_ola round trip of the JAX package's embed solver:
//
//   aw_ola_fwd_cluster, aw_ola_fwd_stream <- ola_normalize forward
//                                            (_ola_fwd_impl :135, _fwd_kernel :56)
//   aw_ola_bwd_cluster, aw_ola_bwd_stream <- ola_normalize VJP
//                                            (_ola_vjp_bwd :167, _bwd_kernel :77)
//
// What they compute, per clip b of a batch (R = n_fft / hop slabs and
// PAD = (n_fft / 2) / hop rows of centre crop, both given at run time as
// the TPU kernel reads them off its shapes: 4 and 2 on the default card,
// 2 and 1 at n_fft 1024 / hop 512, 8 and 4 at 2048 / 256; e = 1e-8,
// lr = T - 1):
//
//   forward:  acc[i]  = sum_{k<R, 0<=i-k<T} wf[i-k, k*hop:(k+1)*hop], in k = 0..R-1
//                       order from 0 (the TPU kernel's row adds),
//             y_env[j] = acc[j + PAD] / env[j]                       for j < lr,
//             m1 = max |y_env|,  c = (m1 + e) * (m1 / (m1 + e) + e),  y2 = y_env / c;
//   VJP:      q = sum g * y2,  m2b = max |y2|,  mask = |y2| == m2b,  ties = sum mask,
//             n = m1 / (m1 + e),  K = (n + e) * q * (e + c) / (c * c),
//             g_env = g / c - K * sign(y2) * mask / ties,   grows[j + PAD] = g_env[j] / env[j]
//             (zero elsewhere in T + R - 1 rows),  dwf[t, k*hop:(k+1)*hop] = grows[t + k].
//
// The tie mask comes from y2 itself (ola_norm.py:95-99): rebuilding y_env
// as y2 * c rounds, can match no element and would divide by ties = 0.
// sign(0) = 0, so a silent clip (m1 = 0, c = 1e-16, every element a tie)
// gets the finite g / c.  Every float operation is an _rn intrinsic in the
// TPU kernel's order, so that nothing contracts into an FMA.
//
// Bytes bound both: at B = 8, T = 626 the forward reads 20.5 MB of frames
// and 0.64 MB of envelope and writes 5.1 MB (7.8 us at 3.35 TB/s), the
// VJP reads 10.9 MB and writes 20.5 MB (9.4 us); the arithmetic is a few
// operations per element.
//
// The cluster variant (clips whose rows fit the cluster's shared memory;
// ops/kernels/ola_norm.py ola_plan decides from the shapes alone).  The TPU
// kernel holds a whole clip in VMEM, one grid step per clip, and finishes
// its reductions there.  Here a thread-block cluster holds a clip: grid
// (cluster, B), one cluster per clip, CTA `rank` owning the contiguous
// rows [rank lr / C, (rank + 1) lr / C) of y_env (and of g and y2), and the
// rows of grows that those feed, the edge CTAs also the zero rows of the
// centre crop (PAD before, R - PAD after).  One launch each, no memset, no
// atomics, nothing intermediate in device memory:
//   forward: each CTA adds its rows of acc from the R frame slices that
//     feed them, four loads in flight at a time (16-byte loads; each frame
//     element feeds one element of acc, so nothing is read twice), divides
//     by env and keeps y_env in
//     shared memory with its max |y_env| beside it; after a cluster
//     barrier every CTA reads all the CTAs' maxima through distributed
//     shared memory (one lane a rank), so every CTA has the same m1, rank
//     0 writes it, and each CTA writes its rows of y2 = y_env / c once.
//     The adds, the division and the max are the stream variant's, so
//     its y2 and m1 are the same bits;
//   VJP: only the tie split needs the clip's sums, and it touches only the
//     elements at the clip's peak.  So each CTA streams its rows once: it
//     writes each grows row into its up-to-R places of dwf as if no
//     element were a tie (g / c / env: c comes from the input m1), keeps
//     its rows of y2 in shared memory and takes its partial q = sum g * y2
//     (each thread's elements in order, then the block's xor butterfly)
//     and max |y2|; after a barrier every CTA combines the partials in
//     rank order (the same bits in every CTA, and from launch to launch),
//     counts its ties (an integer), and after a second barrier sums the
//     counts in rank order; then the thread that wrote each float4 holding
//     a tie writes it again, every lane by the stream variant's
//     expressions.  The writes overlap the reads instead of waiting on the
//     sums; an element that is no tie differs from the stream variant's at
//     most in the sign of a zero (g = -0).
// A final barrier (arrived at after the last remote read, waited for at
// the end) keeps each CTA's shared memory alive while others read it.
// A cluster is 8 CTAs of 1024 threads (one CTA an SM at their 56-58
// registers).  On an H100 (132 SMs in GPCs of up to 18) phase 1 of
// chip_smoke.py reads cudaOccupancyMaxActiveClusters 15 at 8 CTAs and 7
// at 16 (and at every size from 10 to 16): at 16 the main path's 8 clips
// run in two waves, and timed in turns at B = 8, T = 626 a cluster of 8
// is the faster both ways (PERF.md section 6).  1024 threads rather than
// 512 hide the latency of the float32 divisions on the 64 SMs that 8
// clips take.
//
// The stream variant (longer clips, the 60 s long-form clip among them; the
// first design): blocks of 1024 elements that share nothing.  The forward
// is one elementwise launch that adds the frame slices, divides by the
// envelope and atomicMax-es the float bits of |y_env| per clip (m1 is
// zeroed first), then one launch that scales by c.  The VJP is three
// launches: per-block partial max |y2| and sum g*y2, then every block
// finishes its clip's partials in one fixed order (no float atomics, so a
// run repeats bit for bit) and counts its ties with an integer atomicAdd,
// then one elementwise launch that writes each row of grows into its R
// places of dwf.
//
// Each kernel runs on the caller's stream and allocates nothing; each C
// entry returns the launch's error or cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 4;  // elements per thread
constexpr int kChunk = kThreads * kElems;  // elements per block (ops/kernels/ola_norm.py CHUNK)
constexpr float kEps = 1e-8f;
constexpr int kClusterThreads = 1024;  // a CTA of the cluster variant (ola_norm.py CLUSTER_THREADS)
constexpr int kMaxCluster = 16;       // the non-portable cluster size Hopper allows
constexpr int kSliceGroup = 4;        // frame slices whose loads the cluster forward keeps in flight

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};
struct IntSumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// The reduction of v over a block of Threads, returned to every thread.
// The xor butterfly leaves the same bits in every lane (each step combines
// a pair of lanes both ways round, and the ops commute), so the result
// does not depend on the thread that reads it.
template <int Threads = kThreads, class T, class Op>
__device__ T block_reduce(T v, T identity, Op op) {
  constexpr int kWarps = Threads / 32;
  __shared__ T sh[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // a previous call's readers are done with sh
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = lane < kWarps ? sh[lane] : identity;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ long long elem(int e) {
  return (long long)blockIdx.x * kChunk + e * kThreads + threadIdx.x;
}

// c = (m1 + e) * (m1 / (m1 + e) + e), the collapsed double peak-norm scale.
__device__ __forceinline__ float peak_scale(float m1, float* n_out) {
  const float c1 = __fadd_rn(m1, kEps);
  const float n = __fdiv_rn(m1, c1);
  *n_out = n;
  return __fmul_rn(c1, __fadd_rn(n, kEps));
}

// ------------------------------------------------------- stream variant ---

// Every kernel with slab loops is a template on R: R > 0 fixes r = R and
// pad = R / 2 at compile time, so that its slab loops unroll as in the
// first design (the entries take R = 2, 4 and 8, the geometries of the
// port's paths); R = 0 reads r and pad from its arguments.  Both give the
// same bits: the adds run in k order either way.
template <int R>
__device__ __forceinline__ int slabs_of(int r_arg) { return R > 0 ? R : r_arg; }
template <int R>
__device__ __forceinline__ int pad_of(int pad_arg) { return R > 0 ? R / 2 : pad_arg; }

// wf (B, T, r hop), env (lr, hop) -> y (B, lr, hop) = y_env, m1 bits (B,) by atomicMax.
template <int R>
__global__ void ola_fwd_rows(const float* __restrict__ wf, const float* __restrict__ env,
                             float* __restrict__ y, unsigned int* m1_bits, int t, int hop,
                             int r_arg, int pad_arg) {
  const int r = slabs_of<R>(r_arg), pad = pad_of<R>(pad_arg);
  const int b = blockIdx.y;
  const long long n = (long long)(t - 1) * hop;
  const long long nfft = (long long)r * hop;
  const float* wfb = wf + (long long)b * t * nfft;
  float mx = 0.f;
  for (int e = 0; e < kElems; ++e) {
    const long long idx = elem(e);
    if (idx >= n) break;
    const int j = (int)(idx / hop), c = (int)(idx % hop);
    const int i = j + pad;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < r; ++k) {
      const int f = i - k;
      if (f >= 0 && f < t) acc = __fadd_rn(acc, wfb[f * nfft + k * hop + c]);
    }
    const float v = __fdiv_rn(acc, env[idx]);
    y[(long long)b * n + idx] = v;
    mx = fmaxf(mx, fabsf(v));
  }
  mx = block_reduce(mx, 0.f, MaxOp());
  if (threadIdx.x == 0) atomicMax(m1_bits + b, __float_as_uint(mx));
}

// y (B, lr * hop) /= c(m1[b]) in place.
__global__ void ola_fwd_scale(float* __restrict__ y, const float* __restrict__ m1, long long n) {
  const int b = blockIdx.y;
  float nn;
  const float c = peak_scale(m1[b], &nn);
  for (int e = 0; e < kElems; ++e) {
    const long long idx = elem(e);
    if (idx >= n) break;
    y[(long long)b * n + idx] = __fdiv_rn(y[(long long)b * n + idx], c);
  }
}

// part (B, nblk, 2): each block's max |y2| and sum g * y2.
__global__ void ola_bwd_partials(const float* __restrict__ g, const float* __restrict__ y2,
                                 float* __restrict__ part, long long n) {
  const int b = blockIdx.y;
  float mx = 0.f, s = 0.f;
  for (int e = 0; e < kElems; ++e) {
    const long long idx = elem(e);
    if (idx >= n) break;
    const float yv = y2[(long long)b * n + idx];
    s = __fadd_rn(s, __fmul_rn(g[(long long)b * n + idx], yv));
    mx = fmaxf(mx, fabsf(yv));
  }
  mx = block_reduce(mx, 0.f, MaxOp());
  s = block_reduce(s, 0.f, SumOp());
  if (threadIdx.x == 0) {
    float* p = part + ((long long)b * gridDim.x + blockIdx.x) * 2;
    p[0] = mx;
    p[1] = s;
  }
}

// Every block reduces its clip's nblk partials in the same order, counts
// the ties |y2| == max |y2| in its chunk into ties[b]; block 0 writes
// scal (B, 2) = (max |y2|, sum g * y2).
__global__ void ola_bwd_ties(const float* __restrict__ y2, const float* __restrict__ part,
                             float* __restrict__ scal, int* ties, long long n) {
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const float* pb = part + (long long)b * nblk * 2;
  float mx = 0.f, s = 0.f;
  for (int i = threadIdx.x; i < nblk; i += kThreads) {
    mx = fmaxf(mx, pb[2 * i]);
    s = __fadd_rn(s, pb[2 * i + 1]);
  }
  mx = block_reduce(mx, 0.f, MaxOp());
  s = block_reduce(s, 0.f, SumOp());
  float count = 0.f;  // exact: at most kElems per thread
  for (int e = 0; e < kElems; ++e) {
    const long long idx = elem(e);
    if (idx >= n) break;
    if (fabsf(y2[(long long)b * n + idx]) == mx) count += 1.f;
  }
  count = block_reduce(count, 0.f, SumOp());
  if (threadIdx.x == 0) {
    if (count > 0.f) atomicAdd(ties + b, (int)count);
    if (blockIdx.x == 0) {
      scal[2 * b] = mx;
      scal[2 * b + 1] = s;
    }
  }
}

// dwf (B, T, r hop): row i of grows (T + r - 1 rows of hop), computed once,
// written to dwf[i - k, k*hop:(k+1)*hop] for each k with 0 <= i - k < T.
template <int R>
__global__ void ola_bwd_rows(const float* __restrict__ g, const float* __restrict__ y2,
                             const float* __restrict__ env, const float* __restrict__ m1,
                             const float* __restrict__ scal, const int* __restrict__ ties,
                             float* __restrict__ dwf, int t, int hop, int r_arg, int pad_arg) {
  const int r = slabs_of<R>(r_arg), pad = pad_of<R>(pad_arg);
  const int b = blockIdx.y;
  const int lr = t - 1;
  const long long n = (long long)lr * hop;
  const long long rows = (long long)(t + r - 1) * hop;
  const long long nfft = (long long)r * hop;
  float nn;
  const float c = peak_scale(m1[b], &nn);
  const float m2b = scal[2 * b];
  const float p = __fmul_rn(__fadd_rn(nn, kEps), scal[2 * b + 1]);
  const float kc = __fdiv_rn(__fmul_rn(p, __fadd_rn(kEps, c)), __fmul_rn(c, c));
  const float nties = (float)ties[b];
  float* out = dwf + (long long)b * t * nfft;
  for (int e = 0; e < kElems; ++e) {
    const long long idx = elem(e);
    if (idx >= rows) break;
    const int i = (int)(idx / hop), col = (int)(idx % hop);
    const int j = i - pad;
    float v = 0.f;
    if (j >= 0 && j < lr) {
      const long long src = (long long)j * hop + col;
      const float yv = y2[(long long)b * n + src];
      const float sgn = yv > 0.f ? 1.f : (yv < 0.f ? -1.f : 0.f);
      const float mask = fabsf(yv) == m2b ? 1.f : 0.f;
      const float tie = __fdiv_rn(__fmul_rn(__fmul_rn(kc, sgn), mask), nties);
      const float g_env = __fsub_rn(__fdiv_rn(g[(long long)b * n + src], c), tie);
      v = __fdiv_rn(g_env, env[src]);
    }
#pragma unroll
    for (int k = 0; k < r; ++k) {
      const int f = i - k;
      if (f >= 0 && f < t) out[f * nfft + k * hop + col] = v;
    }
  }
}

inline dim3 grid_for(long long n, int batch) {
  return dim3((unsigned)((n + kChunk - 1) / kChunk), (unsigned)batch);
}

// ------------------------------------------------------ cluster variant ---

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float4 div4(float4 a, float4 b) {
  return make_float4(__fdiv_rn(a.x, b.x), __fdiv_rn(a.y, b.y), __fdiv_rn(a.z, b.z),
                     __fdiv_rn(a.w, b.w));
}
__device__ __forceinline__ float4 div4(float4 a, float c) {
  return make_float4(__fdiv_rn(a.x, c), __fdiv_rn(a.y, c), __fdiv_rn(a.z, c), __fdiv_rn(a.w, c));
}
__device__ __forceinline__ float absmax4(float m, float4 v) {
  return fmaxf(fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fabsf(v.y)), fabsf(v.z)), fabsf(v.w));
}

// The rows [*r0, *r1) of the lr rows of y_env that CTA `rank` of a
// cluster of `size` owns (ola_norm.py ola_plan's rows).
__device__ __forceinline__ void cta_rows(int lr, int rank, int size, int* r0, int* r1) {
  *r0 = (int)((long long)rank * lr / size);
  *r1 = (int)((long long)(rank + 1) * lr / size);
}

// A thread's walk over its float4s of a CTA's rows (q4 float4s a row):
// e = threadIdx.x, then every kClusterThreads-th, with the row j and the
// column col of each, kept without a division per step.
struct Walk {
  int e, j, col;
  const int q4, rows_step, cols_step;
  __device__ Walk(int r0, int q)
      : e(threadIdx.x), j(r0 + (int)threadIdx.x / q), col((int)threadIdx.x % q), q4(q),
        rows_step(kClusterThreads / q), cols_step(kClusterThreads % q) {}
  __device__ void next() {
    e += kClusterThreads;
    j += rows_step;
    col += cols_step;
    if (col >= q4) {
      col -= q4;
      ++j;
    }
  }
};

// barrier.cluster split in two: arrive once this CTA has done its last
// read of another CTA's shared memory, wait before it exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");  // release
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // acquire
}

// Lane r of each warp reads CTA r's copy of `mine` (r < the cluster's
// size, at most 32); the caller combines the lanes in rank order.
template <class T>
__device__ __forceinline__ T remote(cg::cluster_group& cluster, T* mine, int size, T identity) {
  const int lane = threadIdx.x & 31;
  return lane < size ? *cluster.map_shared_rank(mine, lane) : identity;
}

// wf (B, T, r hop), env (lr, hop) -> y2 (B, lr, hop), m1 (B,); grid
// (cluster, B), one cluster a clip; dynamic shared memory: the CTA's rows
// of y_env, ceil(lr / cluster) hop floats.
template <int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
    ola_fwd_cluster(const float4* __restrict__ wf, const float4* __restrict__ env,
                    float4* __restrict__ y2, float* __restrict__ m1, int t, int hop, int r_arg,
                    int pad_arg) {
  const int r = slabs_of<R>(r_arg), pad = pad_of<R>(pad_arg);
  extern __shared__ float4 y_env[];
  __shared__ float part;  // this CTA's max |y_env|
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), size = (int)cluster.num_blocks();
  const int b = blockIdx.y, lr = t - 1, q4 = hop / 4;
  int r0, r1;
  cta_rows(lr, rank, size, &r0, &r1);
  const int n4 = (r1 - r0) * q4;
  const long long nfft4 = (long long)r * q4;
  const float4* wfb = wf + (long long)b * t * nfft4;
  float mx = 0.f;
  for (Walk w(r0, q4); w.e < n4; w.next()) {
    const int i = w.j + pad;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    // four slices at a time: their loads first, all in flight together,
    // then their adds in k order
#pragma unroll
    for (int k0 = 0; k0 < r; k0 += kSliceGroup) {
      float4 slice[kSliceGroup];
#pragma unroll
      for (int d = 0; d < kSliceGroup; ++d) {
        const int k = k0 + d;
        if (k < r && i - k >= 0 && i - k < t)
          slice[d] = __ldg(wfb + (i - k) * nfft4 + k * q4 + w.col);
      }
#pragma unroll
      for (int d = 0; d < kSliceGroup; ++d) {
        const int k = k0 + d;
        if (k < r && i - k >= 0 && i - k < t) acc = add4(acc, slice[d]);
      }
    }
    const float4 v = div4(acc, __ldg(env + w.j * q4 + w.col));
    y_env[w.e] = v;
    mx = absmax4(mx, v);
  }
  mx = block_reduce<kClusterThreads>(mx, 0.f, MaxOp());
  if (threadIdx.x == 0) part = mx;
  cluster.sync();
  const float mine = remote(cluster, &part, size, 0.f);
  float m = 0.f;
  for (int k = 0; k < size; ++k) m = fmaxf(m, __shfl_sync(0xffffffffu, mine, k));
  cluster_arrive();
  if (rank == 0 && threadIdx.x == 0) m1[b] = m;
  float nn;
  const float c = peak_scale(m, &nn);
  float4* out = y2 + ((long long)b * lr + r0) * q4;
  for (int e = threadIdx.x; e < n4; e += kClusterThreads) out[e] = div4(y_env[e], c);
  cluster_wait();
}

// g, y2 (B, lr, hop), env (lr, hop), m1 (B,) -> dwf (B, T, r hop); grid
// (cluster, B); dynamic shared memory: the CTA's rows of y2, ceil(lr /
// cluster) hop floats.
template <int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
    ola_bwd_cluster(const float4* __restrict__ g, const float4* __restrict__ y2,
                    const float4* __restrict__ env, const float* __restrict__ m1,
                    float4* __restrict__ dwf, int t, int hop, int r_arg, int pad_arg) {
  const int r = slabs_of<R>(r_arg), pad = pad_of<R>(pad_arg);
  extern __shared__ float4 ys[];
  __shared__ float part[2];  // this CTA's max |y2| and sum g * y2
  __shared__ int part_ties;  // its count of |y2| == m2b
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), size = (int)cluster.num_blocks();
  const int b = blockIdx.y, lr = t - 1, q4 = hop / 4;
  int r0, r1;
  cta_rows(lr, rank, size, &r0, &r1);
  const int n4 = (r1 - r0) * q4;
  const long long off = ((long long)b * lr + r0) * q4, nfft4 = (long long)r * q4;
  const float4* envr = env + (long long)r0 * q4;
  float4* out = dwf + (long long)b * t * nfft4;
  // row i of grows into its places dwf[i - k, k*hop:(k+1)*hop], 0 <= i - k < T
  auto put = [&](int i, int col, float4 v) {
#pragma unroll
    for (int k = 0; k < r; ++k) {
      const int f = i - k;
      if (f >= 0 && f < t) out[f * nfft4 + k * q4 + col] = v;
    }
  };
  float nn;
  const float c = peak_scale(m1[b], &nn);
  // the edge CTAs' zero rows of the centre crop: grows rows [0, pad) and
  // [lr + pad, lr + r) (0, 1 and T+1, T+2 on the default card)
  for (int e = threadIdx.x; e < r * q4; e += kClusterThreads) {
    const int z = e / q4;
    if (z < pad ? rank == 0 : rank == size - 1)
      put(z < pad ? z : lr + z, e % q4, make_float4(0.f, 0.f, 0.f, 0.f));
  }
  float mx = 0.f, s = 0.f;
  for (Walk w(r0, q4); w.e < n4; w.next()) {  // this thread's elements in order
    const float4 gv = __ldg(g + off + w.e), yv = __ldg(y2 + off + w.e);
    const float4 ev = __ldg(envr + w.e);
    ys[w.e] = yv;
    s = __fadd_rn(s, __fmul_rn(gv.x, yv.x));
    s = __fadd_rn(s, __fmul_rn(gv.y, yv.y));
    s = __fadd_rn(s, __fmul_rn(gv.z, yv.z));
    s = __fadd_rn(s, __fmul_rn(gv.w, yv.w));
    mx = absmax4(mx, yv);
    // every element as if it were no tie (its tie term 0): g / c / env
    put(w.j + pad, w.col, div4(div4(gv, c), ev));
  }
  mx = block_reduce<kClusterThreads>(mx, 0.f, MaxOp());
  s = block_reduce<kClusterThreads>(s, 0.f, SumOp());
  if (threadIdx.x == 0) {
    part[0] = mx;
    part[1] = s;
  }
  cluster.sync();
  const float rm = remote(cluster, &part[0], size, 0.f);
  const float rs = remote(cluster, &part[1], size, 0.f);
  float m2b = 0.f, q = 0.f;
  for (int k = 0; k < size; ++k) {
    m2b = fmaxf(m2b, __shfl_sync(0xffffffffu, rm, k));
    q = __fadd_rn(q, __shfl_sync(0xffffffffu, rs, k));
  }
  int count = 0;
  for (int e = threadIdx.x; e < n4; e += kClusterThreads) {
    const float4 yv = ys[e];
    count += (fabsf(yv.x) == m2b) + (fabsf(yv.y) == m2b) + (fabsf(yv.z) == m2b) +
             (fabsf(yv.w) == m2b);
  }
  count = block_reduce<kClusterThreads>(count, 0, IntSumOp());
  if (threadIdx.x == 0) part_ties = count;
  cluster.sync();  // also: every CTA has read the partials above
  const int rt = remote(cluster, &part_ties, size, 0);
  int ties = 0;
  for (int k = 0; k < size; ++k) ties += __shfl_sync(0xffffffffu, rt, k);
  cluster_arrive();

  // the tie split: each float4 that holds a tie written again, every lane
  // by the stream variant's expressions (the same thread wrote it above)
  const float p = __fmul_rn(__fadd_rn(nn, kEps), q);
  const float kc = __fdiv_rn(__fmul_rn(p, __fadd_rn(kEps, c)), __fmul_rn(c, c));
  const float nties = (float)ties;
  for (Walk w(r0, q4); w.e < n4; w.next()) {
    const float4 yv = ys[w.e];
    const float yl[4] = {yv.x, yv.y, yv.z, yv.w};
    if (fabsf(yl[0]) != m2b && fabsf(yl[1]) != m2b && fabsf(yl[2]) != m2b &&
        fabsf(yl[3]) != m2b)
      continue;
    const float4 gv = __ldg(g + off + w.e), ev = __ldg(envr + w.e);
    const float gl[4] = {gv.x, gv.y, gv.z, gv.w}, el[4] = {ev.x, ev.y, ev.z, ev.w};
    float vl[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float sgn = yl[l] > 0.f ? 1.f : (yl[l] < 0.f ? -1.f : 0.f);
      const float mask = fabsf(yl[l]) == m2b ? 1.f : 0.f;
      const float tie = __fdiv_rn(__fmul_rn(__fmul_rn(kc, sgn), mask), nties);
      vl[l] = __fdiv_rn(__fsub_rn(__fdiv_rn(gl[l], c), tie), el[l]);
    }
    put(w.j + pad, w.col, make_float4(vl[0], vl[1], vl[2], vl[3]));
  }
  cluster_wait();
}

// The dynamic shared memory a CTA of the cluster variant takes, either
// direction: its ceil(lr / cluster) rows of hop floats.
inline int cluster_smem(int t, int hop, int cluster) {
  return (int)((t - 1 + cluster - 1) / cluster * hop * (int)sizeof(float));
}

// Allow the cluster kernel the card's whole opt-in shared memory and the
// non-portable cluster size of 16; once per kernel.
template <class Kernel>
cudaError_t allow_cluster(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <int R>
cudaError_t ready(int vjp) {
  static const cudaError_t fwd = allow_cluster(ola_fwd_cluster<R>);
  static const cudaError_t bwd = allow_cluster(ola_bwd_cluster<R>);
  return vjp ? bwd : fwd;
}

// f(std::integral_constant<int, R>) for the kernels' instance of r slabs
// and pad rows of crop: R = r for r = 2, 4, 8 with pad = r / 2, else 0.
template <class F>
auto with_slabs(int r, int pad, F&& f) {
  if (2 * pad == r) {
    if (r == 4) return f(std::integral_constant<int, 4>{});
    if (r == 2) return f(std::integral_constant<int, 2>{});
    if (r == 8) return f(std::integral_constant<int, 8>{});
  }
  return f(std::integral_constant<int, 0>{});
}

cudaLaunchConfig_t cluster_config(int batch, int cluster, int smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)batch, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// What the cluster variant cannot take: a cluster past 16 or a clip
// shorter than 2 frames, hop not a multiple of 4 (16-byte rows), or rows
// past the opt-in shared memory (the kernels' static shared memory aside).
template <int R>
cudaError_t refuse(int vjp, int t, int hop, int cluster) {
  if (cluster < 1 || cluster > kMaxCluster || t < 2 || hop < 4 || hop % 4)
    return cudaErrorInvalidValue;
  return ready<R>(vjp);
}

// What neither variant can take: fewer than one slab, or a centre crop
// past the slabs.
bool bad_geometry(int r, int pad) { return r < 1 || pad < 0 || pad >= r; }

int finish(cudaError_t launched) {
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

}  // namespace

extern "C" {

// wframes (B, T, r hop) f32, env (T-1, hop) f32 -> y2 (B, T-1, hop) f32, m1 (B,) f32,
// with r slabs and pad rows of centre crop.
int aw_ola_fwd_stream(const float* wframes, const float* env, float* y2, float* m1, int batch,
                      int t, int hop, int r, int pad, void* stream) {
  if (bad_geometry(r, pad)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)(t - 1) * hop;
  cudaMemsetAsync(m1, 0, sizeof(float) * batch, st);
  with_slabs(r, pad, [&](auto k) {
    ola_fwd_rows<decltype(k)::value><<<grid_for(n, batch), kThreads, 0, st>>>(
        wframes, env, y2, reinterpret_cast<unsigned int*>(m1), t, hop, r, pad);
  });
  ola_fwd_scale<<<grid_for(n, batch), kThreads, 0, st>>>(y2, m1, n);
  return (int)cudaGetLastError();
}

// g, y2 (B, T-1, hop) f32, env (T-1, hop) f32, m1 (B,) f32; scratch part
// (B, ceil((T-1) hop / 1024), 2) f32, scal (B, 2) f32, ties (B,) int32
// -> dwf (B, T, r hop) f32.
int aw_ola_bwd_stream(const float* g, const float* y2, const float* env, const float* m1,
                      float* part, float* scal, int* ties, float* dwf, int batch, int t, int hop,
                      int r, int pad, void* stream) {
  if (bad_geometry(r, pad)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)(t - 1) * hop;
  cudaMemsetAsync(ties, 0, sizeof(int) * batch, st);
  ola_bwd_partials<<<grid_for(n, batch), kThreads, 0, st>>>(g, y2, part, n);
  ola_bwd_ties<<<grid_for(n, batch), kThreads, 0, st>>>(y2, part, scal, ties, n);
  with_slabs(r, pad, [&](auto k) {
    ola_bwd_rows<decltype(k)::value>
        <<<grid_for((long long)(t + r - 1) * hop, batch), kThreads, 0, st>>>(
            g, y2, env, m1, scal, ties, dwf, t, hop, r, pad);
  });
  return (int)cudaGetLastError();
}

// The forward as one launch of a cluster of `cluster` CTAs per clip; the
// operands as aw_ola_fwd_stream's, each 16-byte aligned.
int aw_ola_fwd_cluster(const float* wframes, const float* env, float* y2, float* m1, int batch,
                       int t, int hop, int r, int pad, int cluster, void* stream) {
  if (bad_geometry(r, pad)) return (int)cudaErrorInvalidValue;
  return with_slabs(r, pad, [&](auto k) {
    constexpr int R = decltype(k)::value;
    cudaError_t err = refuse<R>(0, t, hop, cluster);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(batch, cluster, cluster_smem(t, hop, cluster),
                                                  (cudaStream_t)stream, &attr);
    return finish(cudaLaunchKernelEx(&cfg, ola_fwd_cluster<R>, (const float4*)wframes,
                                     (const float4*)env, (float4*)y2, m1, t, hop, r, pad));
  });
}

// The VJP as one launch of a cluster of `cluster` CTAs per clip; the
// operands as aw_ola_bwd_stream's (no scratch), each 16-byte aligned.
int aw_ola_bwd_cluster(const float* g, const float* y2, const float* env, const float* m1,
                       float* dwf, int batch, int t, int hop, int r, int pad, int cluster,
                       void* stream) {
  if (bad_geometry(r, pad)) return (int)cudaErrorInvalidValue;
  return with_slabs(r, pad, [&](auto k) {
    constexpr int R = decltype(k)::value;
    cudaError_t err = refuse<R>(1, t, hop, cluster);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(batch, cluster, cluster_smem(t, hop, cluster),
                                                  (cudaStream_t)stream, &attr);
    return finish(cudaLaunchKernelEx(&cfg, ola_bwd_cluster<R>, (const float4*)g,
                                     (const float4*)y2, (const float4*)env, m1, (float4*)dwf, t,
                                     hop, r, pad));
  });
}

// The cluster variant's forward (vjp = 0) or VJP kernel at T frames, hop
// and a cluster size, the default card's instance (r = 4): its registers,
// static shared memory and local (spilled) bytes a thread, the dynamic
// shared memory a CTA takes, and cudaOccupancyMaxActiveClusters at that
// size.
int aw_ola_cluster_config(int vjp, int t, int hop, int cluster, int* regs, int* static_smem,
                          int* local_bytes, int* dyn_smem, int* max_clusters) {
  cudaError_t err = refuse<4>(vjp, t, hop, cluster);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = vjp ? cudaFuncGetAttributes(&fa, ola_bwd_cluster<4>)
            : cudaFuncGetAttributes(&fa, ola_fwd_cluster<4>);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *static_smem = (int)fa.sharedSizeBytes;
  *local_bytes = (int)fa.localSizeBytes;
  *dyn_smem = cluster_smem(t, hop, cluster);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, cluster, *dyn_smem, nullptr, &attr);
  err = vjp ? cudaOccupancyMaxActiveClusters(max_clusters, ola_bwd_cluster<4>, &cfg)
            : cudaOccupancyMaxActiveClusters(max_clusters, ola_fwd_cluster<4>, &cfg);
  return finish(err);
}

}  // extern "C"
