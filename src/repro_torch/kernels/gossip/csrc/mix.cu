// Row-stochastic gossip mix for Hopper (sm_90a):
//
//     out (N, K) = Q^T @ deltas,   out[m, k] = sum_n q[n, m] * deltas[n, k]
//
// with f32 accumulation in sender order (n = 0, 1, ..., N-1) for f32 or
// bf16 deltas, written in the deltas' dtype. q (N, N) f32 is
// (sender, receiver), the client-stacked parameter plane deltas (N, K)
// is row-major and contiguous.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/gossip/gossip.py::gossip_mix_pallas (body
// _gossip_kernel), reached from core/mixing.py::mix_dense once per
// trainer step through kernels/gossip/ops.py::gossip_mix.
//
// Bound. Per call the kernel must read N * K delta elements and the
// N * N weights and write N * K outputs. At the trainer's shape (N = 4
// clients, K = Dflat = 1,543,714,304 parameters of qwen2-1.5b, f32) that
// is 49.4 GB, 14.75 ms at 3.35 TB/s; the 2 * N * N * K = 49 GFLOP of FMAs
// take 0.74 ms at the card's 67 TFLOP/s f32 rate, so the kernel is
// memory-bound by a factor of 20.
//
// Design.
//  - One thread per column in a grid-stride loop over K: the loads of
//    one sender row are coalesced across the warp, every delta element
//    is read from device memory exactly once and every output element
//    written once. The grid is a few waves of blocks per SM, so each
//    block stages Q in shared memory once and then streams columns.
//  - Q is staged as NP x NP, zero-padded, where NP in {8, 16, 32, 64}
//    is a template parameter: the NP accumulators of a thread live in
//    registers with static indices, as in drain.cu. N > 64 takes the wide
//    route below.
//  - No padding copy: the reference's wrapper pads N to 8 and K to 512
//    (ops.py:54-55); at the trainer's shape that copy alone would be
//    another 24.7 GB. The ragged edge of K is masked by the loop bound
//    and padded senders are never loaded.
//  - 64-bit offsets: N * K is 6.17e9 at the trainer's shape, beyond
//    2^31, so every row offset n * K and every column index is a
//    long long.
//  - Senders are loaded in chunks of 8 before their FMAs, so a thread
//    has up to 8 independent loads in flight.
//  Scalar 4-byte (f32) and 2-byte (bf16) loads; 16-byte vector loads,
//  TMA and a tuned grid are left for a later change.
//
// The wide route (N > 64): stream.cuh's wide_kernel with one source, Q as
// its weights and deltas as its payload: receivers in groups of at most
// 64 and senders in chunks of 32, each unit's Q block staged beside its payload
// chunk, the product on the tensor cores (split TF32), the outputs in the
// deltas' dtype. At N = 100, K = 146,447 f32 the mix moves 117 MB (35 us
// at 3.35 TB/s) and needs 2.93 GFLOP (44 us at the f32 rate).
#include "stream.cuh"

#define MIX_MAX_N 64  // the one-thread-per-column route
#define MIX_THREADS 256
#define MIX_BLOCKS_PER_SM 8
#define MIX_CHUNK 8

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int NP>
__global__ void __launch_bounds__(MIX_THREADS)
mix_kernel(const float* __restrict__ q, const T* __restrict__ deltas,
           T* __restrict__ out, int N, long long K) {
  __shared__ float q_sh[NP * NP];  // [sender][receiver], zero-padded
  for (int i = threadIdx.x; i < NP * NP; i += MIX_THREADS) {
    const int n = i / NP, m = i % NP;
    q_sh[i] = (n < N && m < N) ? q[n * N + m] : 0.f;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * MIX_THREADS;
  for (long long col = (long long)blockIdx.x * MIX_THREADS + threadIdx.x;
       col < K; col += stride) {
    float acc[NP];
#pragma unroll
    for (int m = 0; m < NP; ++m) acc[m] = 0.f;

    // not unrolled: a full unroll of NP / 8 chunks spilled registers at
    // NP >= 16 (ptxas: 255 registers, up to 19 KB of spills at NP = 64)
#pragma unroll 1
    for (int n0 = 0; n0 < NP; n0 += MIX_CHUNK) {
      if (n0 >= N) break;
      float p[MIX_CHUNK];
#pragma unroll
      for (int j = 0; j < MIX_CHUNK; ++j) {
        const int n = n0 + j;
        p[j] = n < N ? to_f32(deltas[(long long)n * K + col]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < MIX_CHUNK; ++j) {
        const int n = n0 + j;
        if (n < N) {
          const float* qn = q_sh + (n0 + j) * NP;
#pragma unroll
          for (int m = 0; m < NP; ++m) acc[m] = fmaf(qn[m], p[j], acc[m]);
        }
      }
    }

#pragma unroll
    for (int m = 0; m < NP; ++m)
      if (m < N) store(out + (long long)m * K + col, acc[m]);
  }
}

template <typename T>
static void launch(const float* q, const T* deltas, T* out, int N, long long K,
                   cudaStream_t stream) {
  const long long want = (K + MIX_THREADS - 1) / MIX_THREADS;
  const long long cap = (long long)sm_count() * MIX_BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  if (N <= 8)
    mix_kernel<T, 8><<<blocks, MIX_THREADS, 0, stream>>>(q, deltas, out, N, K);
  else if (N <= 16)
    mix_kernel<T, 16><<<blocks, MIX_THREADS, 0, stream>>>(q, deltas, out, N, K);
  else if (N <= 32)
    mix_kernel<T, 32><<<blocks, MIX_THREADS, 0, stream>>>(q, deltas, out, N, K);
  else
    mix_kernel<T, 64><<<blocks, MIX_THREADS, 0, stream>>>(q, deltas, out, N, K);
}

// The wide route's arguments: one source, Q its weights, deltas its payload.
static WideArgs wide_args(const void* q, const void* deltas, void* out, int N, long long K,
                          int is_bf16) {
  WideArgs a;
  a.w = (const float*)q;
  a.w_stride = 0;
  a.p = deltas;
  a.p_stride = 0;
  a.out = out;
  a.S = 1;
  a.N = N;
  a.M = N;
  a.K = K;
  a.per_source = 0;
  a.skip = 0;
  a.out_bf16 = is_bf16;
  for (int s = 0; s < WIDE_MAX_S; ++s) a.slot[s] = 0;
  return a;
}

extern "C" {

long long mix_wide_smem_bytes(int N, int is_bf16) { return wide_smem_bytes(1, N, is_bf16 ? 2 : 4); }
int mix_max_smem() { return max_smem_optin(); }

// The wide route's instance for N > 64, without launching: info =
// {registers per thread, blocks per SM, blocks in the grid}.
int mix_info(int N, long long K, int is_bf16, int* info) {
  if (N <= MIX_MAX_N) return (int)cudaErrorInvalidValue;
  return wide_dispatch(wide_args(nullptr, nullptr, nullptr, N, K, is_bf16), is_bf16, nullptr,
                       info);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q (N, N) f32, deltas and out (N, K) of one dtype; device pointers.
int mix_launch(const void* q, const void* deltas, void* out, int N,
               long long K, int is_bf16, void* stream) {
  if (N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N > MIX_MAX_N)
    return wide_dispatch(wide_args(q, deltas, out, N, K, is_bf16), is_bf16, st, nullptr);
  if (is_bf16)
    launch<__nv_bfloat16>((const float*)q, (const __nv_bfloat16*)deltas,
                          (__nv_bfloat16*)out, N, K, st);
  else
    launch<float>((const float*)q, (const float*)deltas, (float*)out, N, K, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
