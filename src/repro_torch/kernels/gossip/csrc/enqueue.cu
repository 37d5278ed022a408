// Delay-bucketed eager gossip (enqueue) for Hopper (sm_90a):
//
//     out[j] (N, K) = w_stack[j]^T @ pending,   j = 0, ..., J-1
//     out[j, m, k]  = sum_n w_stack[j, n, m] * pending[n, k]
//
// with f32 accumulation in sender order (n = 0, 1, ..., N-1) for f32 or
// bf16 pending updates, written as f32 or bf16 (the wrapper's
// out_dtype). w_stack (J, N, N) f32 is (bucket, sender, receiver): the
// row-stochastic weights masked by each link's delay bucket; pending
// (N, K) and out (J, N, K) are row-major and contiguous.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/gossip/gossip.py::gossip_enqueue_pallas (body
// _enqueue_kernel), reached through kernels/gossip/ops.py::gossip_enqueue.
//
// Bound. Per call the kernel must read the N * K pending elements once
// and write the J * N * K outputs once; the 2 * J * N * N * K FMAs run on
// the CUDA cores. At the windowed path's shape (J = 3 buckets, N = 25
// clients, K = 146,447 f32) that is 14.6 MB read and 43.9 MB written,
// 17.5 us at 3.35 TB/s, against 8.2 us of f32 FMAs at 67 TFLOP/s: the
// kernel is memory-bound, by the J outputs it writes.
//
// Design (mix.cu with J outputs).
//  - One thread per column in a grid-stride loop over K: the N pending
//    values of a column are loaded once, coalesced across the warp, and
//    held in registers (NP of them, NP in {8, 16, 32, 64} a template
//    parameter so every index is static) while the thread produces all
//    J * N outputs of that column, so each pending element is read from
//    device memory exactly once for all J buckets.
//  - The J weight matrices live in dynamic shared memory, transposed to
//    [j][receiver][sender] and zero-padded to NP senders, so a receiver's
//    weights are read as float4 broadcasts (every thread of a warp reads
//    the same address): four FMAs per shared load. J * N * NP * 4 bytes
//    must fit the block's shared memory; the wrapper refuses more.
//  - The (bucket, receiver) loop is not unrolled, so the register count
//    stays that of the NP pending values (mix.cu spilled at NP >= 16
//    while its sender loop was unrolled).
//  - No padding copy: the reference's wrapper pads N to 8 and K to 512
//    (ops.py:91-92); here the ragged edge of K is masked by the loop
//    bound and padded senders are never loaded.
//  - 64-bit offsets for every row offset and column index.
//  Scalar global loads and stores; vector loads and TMA are left for a
//  later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ENQ_MAX_N 64
#define ENQ_THREADS 256
#define ENQ_BLOCKS_PER_SM 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

static int padded_n(int N) { return N <= 8 ? 8 : N <= 16 ? 16 : N <= 32 ? 32 : 64; }

template <typename TI, typename TO, int NP>
__global__ void __launch_bounds__(ENQ_THREADS)
enqueue_kernel(const float* __restrict__ w, const TI* __restrict__ pending,
               TO* __restrict__ out, int J, int N, long long K) {
  extern __shared__ float4 w_sh4[];  // [j][m][NP] = w[j][n][m], zero-padded in n
  float* w_sh = reinterpret_cast<float*>(w_sh4);
  const int rows = J * N;
  for (int i = threadIdx.x; i < rows * NP; i += ENQ_THREADS) {
    const int n = i % NP, jm = i / NP;
    const int m = jm % N, j = jm / N;
    w_sh[i] = n < N ? w[((long long)j * N + n) * N + m] : 0.f;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * ENQ_THREADS;
  for (long long col = (long long)blockIdx.x * ENQ_THREADS + threadIdx.x;
       col < K; col += stride) {
    float p[NP];
#pragma unroll
    for (int n = 0; n < NP; ++n)
      p[n] = n < N ? to_f32(pending[(long long)n * K + col]) : 0.f;

#pragma unroll 1
    for (int jm = 0; jm < rows; ++jm) {
      const float4* wr = w_sh4 + jm * (NP / 4);
      float acc = 0.f;
#pragma unroll
      for (int n4 = 0; n4 < NP / 4; ++n4) {
        const float4 wv = wr[n4];
        acc = fmaf(wv.x, p[4 * n4 + 0], acc);
        acc = fmaf(wv.y, p[4 * n4 + 1], acc);
        acc = fmaf(wv.z, p[4 * n4 + 2], acc);
        acc = fmaf(wv.w, p[4 * n4 + 3], acc);
      }
      store(out + (long long)jm * K + col, acc);
    }
  }
}

static int device_attr(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
}

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    sms = device_attr(cudaDevAttrMultiProcessorCount);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <typename TI, typename TO, int NP>
static int launch_np(const float* w, const TI* pending, TO* out, int J, int N,
                     long long K, cudaStream_t stream) {
  const size_t smem = (size_t)J * N * NP * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        enqueue_kernel<TI, TO, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long want = (K + ENQ_THREADS - 1) / ENQ_THREADS;
  const long long cap = (long long)sm_count() * ENQ_BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  enqueue_kernel<TI, TO, NP><<<blocks, ENQ_THREADS, smem, stream>>>(w, pending, out, J, N, K);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
static int launch(const void* w, const void* pending, void* out, int J, int N,
                  long long K, cudaStream_t stream) {
  const float* wf = (const float*)w;
  const TI* p = (const TI*)pending;
  TO* o = (TO*)out;
  switch (padded_n(N)) {
    case 8: return launch_np<TI, TO, 8>(wf, p, o, J, N, K, stream);
    case 16: return launch_np<TI, TO, 16>(wf, p, o, J, N, K, stream);
    case 32: return launch_np<TI, TO, 32>(wf, p, o, J, N, K, stream);
    default: return launch_np<TI, TO, 64>(wf, p, o, J, N, K, stream);
  }
}

extern "C" {

int enqueue_max_n() { return ENQ_MAX_N; }

// Shared memory the kernel needs for J buckets of N clients, and the
// most a block of this device may have.
long long enqueue_smem_bytes(int J, int N) {
  return (long long)J * N * padded_n(N) * (long long)sizeof(float);
}
int enqueue_max_smem() { return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin); }

// Launches on `stream` and returns the CUDA error (0 on success).
// w (J, N, N) f32, pending (N, K), out (J, N, K); device pointers.
int enqueue_launch(const void* w, const void* pending, void* out, int J, int N,
                   long long K, int in_bf16, int out_bf16, void* stream) {
  if (J < 1 || N < 1 || N > ENQ_MAX_N || K < 1 ||
      enqueue_smem_bytes(J, N) > enqueue_max_smem())
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16)
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(w, pending, out, J, N, K, st)
                    : launch<__nv_bfloat16, float>(w, pending, out, J, N, K, st);
  return out_bf16 ? launch<float, __nv_bfloat16>(w, pending, out, J, N, K, st)
                  : launch<float, float>(w, pending, out, J, N, K, st);
}

}  // extern "C"
