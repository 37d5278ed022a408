// Fused delay-bucketed gossip drain for Hopper (sm_90a):
//
//     out (M, K) f32 = sum_j w_stack[j]^T @ ring[slots[j]]
//
// with j in stack (oldest-first) order and f32 accumulation, for an f32
// or bf16 payload ring (S, N, K). w_stack (J, N, M) holds the masked
// weights of each stored broadcast (senders x receivers; M == N on one
// device, rectangular for a senders slice).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/gossip/gossip.py::gossip_drain_pallas (body
// _drain_kernel), reached from core/protocol.py::draco_window once per
// window through kernels/gossip/ops.py::gossip_drain.
//
// Bound. The work is memory-bound: it must read (non-empty J) * N * K
// payload elements and the J * N * M weights, and write M * K f32
// outputs; arithmetic is 2 * N * M flops per payload column per bucket
// on the CUDA cores, far below the card's ridge point. So the least
// time is (payload bytes + weight bytes + output bytes) / HBM rate.
//
// Design.
//  - Grid over tiles of K columns, one thread per column: the loads of
//    one sender row are coalesced across the warp, and every payload
//    element is read from device memory exactly once.
//  - No (J, N, K) gather copy: the block reads ring + slots[j] * N * K
//    directly; the J slot indices travel by value in the launch.
//  - For each bucket, the block stages that bucket's (N, M) weights in
//    shared memory (zero-padded to MP receivers), one bucket at a time,
//    so the kernel needs N * MP * 4 bytes of shared memory at most.
//  - An all-zero bucket is skipped, decided inside the block by the
//    barrier that ends the staging (__syncthreads_or): the skip is exact
//    (an empty bucket adds an exact +-0 matrix, and the reference loop
//    skips it too), needs no host read, and is what the Psi-capped main
//    path needs, where most buckets of most windows are empty.
//  - MP accumulators per thread live in registers (MP is a template
//    parameter so every index is static); each output element is
//    written once.
//  wgmma, TMA and vector loads are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define DRAIN_MAX_J 32
#define DRAIN_MAX_N 64
#define DRAIN_MAX_M 64
#define DRAIN_THREADS 256

struct DrainSlots {
  int s[DRAIN_MAX_J];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int MP>
__global__ void __launch_bounds__(DRAIN_THREADS)
drain_kernel(const float* __restrict__ w_stack, const T* __restrict__ ring,
             float* __restrict__ out, DrainSlots slots, int J, int N, int M,
             long long K) {
  __shared__ float w_sh[DRAIN_MAX_N * MP];
  const long long col = (long long)blockIdx.x * DRAIN_THREADS + threadIdx.x;
  const bool live = col < K;
  const long long plane = (long long)N * K;

  float acc[MP];
#pragma unroll
  for (int m = 0; m < MP; ++m) acc[m] = 0.f;

  for (int j = 0; j < J; ++j) {
    const float* wj = w_stack + (long long)j * N * M;
    int nonzero = 0;
    for (int i = threadIdx.x; i < N * MP; i += DRAIN_THREADS) {
      const int n = i / MP, m = i % MP;
      const float w = m < M ? wj[n * M + m] : 0.f;
      w_sh[i] = w;
      nonzero |= (w != 0.f);
    }
    // barrier + block-wide OR; uniform across the block, so skipping
    // keeps every thread on the same barriers
    if (!__syncthreads_or(nonzero)) continue;

    if (live) {
      const T* pj = ring + (long long)slots.s[j] * plane + col;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float p = to_f32(pj[(long long)n * K]);
        const float* wn = w_sh + n * MP;
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[m] = fmaf(wn[m], p, acc[m]);
      }
    }
    __syncthreads();  // w_sh is restaged by the next bucket
  }

  if (live) {
#pragma unroll
    for (int m = 0; m < MP; ++m)
      if (m < M) out[(long long)m * K + col] = acc[m];
  }
}

template <typename T>
static void launch(const float* w, const T* ring, float* out, DrainSlots slots,
                   int J, int N, int M, long long K, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((K + DRAIN_THREADS - 1) / DRAIN_THREADS);
  if (M <= 8)
    drain_kernel<T, 8><<<blocks, DRAIN_THREADS, 0, stream>>>(w, ring, out, slots, J, N, M, K);
  else if (M <= 16)
    drain_kernel<T, 16><<<blocks, DRAIN_THREADS, 0, stream>>>(w, ring, out, slots, J, N, M, K);
  else if (M <= 32)
    drain_kernel<T, 32><<<blocks, DRAIN_THREADS, 0, stream>>>(w, ring, out, slots, J, N, M, K);
  else
    drain_kernel<T, 64><<<blocks, DRAIN_THREADS, 0, stream>>>(w, ring, out, slots, J, N, M, K);
}

extern "C" {

int drain_max_j() { return DRAIN_MAX_J; }
int drain_max_n() { return DRAIN_MAX_N; }
int drain_max_m() { return DRAIN_MAX_M; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `slots` is a host array of J ring rows; pointers are device pointers.
int drain_launch(const void* w_stack, const void* ring, void* out,
                 const int* slots, int J, int N, int M, long long K,
                 int ring_is_bf16, void* stream) {
  if (J < 0 || J > DRAIN_MAX_J || N < 1 || N > DRAIN_MAX_N || M < 1 ||
      M > DRAIN_MAX_M || K < 1)
    return (int)cudaErrorInvalidValue;
  DrainSlots s;
  for (int j = 0; j < DRAIN_MAX_J; ++j) s.s[j] = j < J ? slots[j] : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (ring_is_bf16)
    launch<__nv_bfloat16>((const float*)w_stack, (const __nv_bfloat16*)ring,
                          (float*)out, s, J, N, M, K, st);
  else
    launch<float>((const float*)w_stack, (const float*)ring, (float*)out, s,
                  J, N, M, K, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
