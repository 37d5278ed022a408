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
// and write the J * N * K outputs once; the J * N * N * K FMAs run on
// the CUDA cores. At the windowed path's shape (J = 3 buckets, N = 25
// clients, K = 146,447 f32) that is 14.6 MB read and 43.9 MB written,
// 17.5 us at 3.35 TB/s, against 8.2 us of f32 FMAs at 67 TFLOP/s:
// memory-bound on paper, by the J outputs it writes. In practice the
// product's shared-memory loads and the misaligned rows' stores take
// longer than the copies (PERF.md).
//
// Design (the drain's memory side, stream.cuh).
//  - Persistent grid sized from occupancy, walking tiles of TILE columns
//    round-robin.
//  - A producer warp copies each pending (N, TILE) tile into a ring of
//    STAGES shared-memory stages by bulk copies, one per row on the
//    stage's mbarrier (odd-K rows as their 16-byte-aligned supersets, read
//    at their shift); the first tiles' copies are in flight while the
//    consumer warps stage the J weight matrices, [j][sender][receiver].
//    Every pending element is read from device memory once for all J
//    buckets.
//  - Per tile and bucket, a lane computes MB = ceil(N / GOSSIP_GROUPS)
//    receivers x COLS columns on the CUDA cores (register-blocked, senders
//    in order) and stores them as soon as the bucket is done (scalar
//    stores, fire and forget), so the stores stream under the next
//    bucket's FMAs. A store never passes its row's end: only receivers <
//    N and columns < K are written. The tensor-core product (variant
//    `tensor-cores`) computes faster but its stores cost more here, where
//    the outputs are three times the drain's (PERF.md).
//  - 64-bit offsets for every row offset and column index.
//
// The wide route (stream.cuh's wide_kernel) takes N > 64 and bucket sets
// whose J weight matrices do not fit a block at once (J = 8 at N = 64 in
// f32): per bucket, receivers in groups of at most 64 and senders in
// chunks of 32, the pending chunk and the bucket's weight block staged together,
// the product on the tensor cores (split TF32), each bucket stored after
// its last chunk. It reads the pending plane once per bucket (the narrow
// route reads it once for all J).
#include "stream.cuh"

constexpr int STAGES = 3;  // pending tiles in the ring
static_assert(STAGES <= RING_BARRIERS / 16, "two mbarriers a stage");
constexpr bool TENSOR_CORES = false;  // the product on the tensor cores (stream.cuh)
constexpr int COLS = 4;    // columns per lane
constexpr int TILE = GOSSIP_CONSUMERS / GOSSIP_GROUPS * COLS;  // columns per ring stage
constexpr int ROW = TILE + 8;  // elements per staged row: the tile and the largest shift
#define ENQ_MAX_N 64  // the narrow route's clients

static_assert(!TENSOR_CORES || TILE == GOSSIP_CONSUMERS, "a warp's 32 columns per stage");

// The kernel's receiver blocking R for N receivers: receivers per lane,
// or 16-receiver tiles on the tensor cores.
static int blocking(int N) {
  return TENSOR_CORES ? (N + 15) / 16 : (N + GOSSIP_GROUPS - 1) / GOSSIP_GROUPS;
}
// floats per staged weight row (one sender) and staged senders per bucket
__host__ __device__ constexpr int weight_row(int R) {
  // on the tensor cores 8 or 24 floats over the receivers (mod 32), so an
  // A fragment's four senders fall in four bank octets
  return TENSOR_CORES ? 16 * R + 8 : GOSSIP_GROUPS * lane_weights(R);
}
__host__ __device__ constexpr int weight_rows(int N) { return TENSOR_CORES ? (N + 7) / 8 * 8 : N; }
// the receiver at position p of a staged weight row, or -1 for padding
__host__ __device__ constexpr int staged_receiver(int p, int R) {
  return TENSOR_CORES                       ? p
         : p % lane_weights(R) < R ? p / lane_weights(R) * R + p % lane_weights(R)
                                   : -1;
}

// Dynamic shared memory of one block: ring barriers, weights, ring, row
// offsets (and the tensor cores' store buffers).
static long long smem_bytes(int J, int N, int elem) {
  return RING_BARRIERS + 4LL * align4(J * weight_rows(N) * weight_row(blocking(N))) +
         (TENSOR_CORES ? 4LL * STORE_FLOATS : 0) + (long long)STAGES * N * ROW * elem +
         4LL * STAGES * N;
}

__device__ __forceinline__ void store(void* out, long long i, float x, int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(out)[i] = x;
}

template <typename TI, int R>
__global__ void __launch_bounds__(GOSSIP_THREADS)
enqueue_kernel(const float* __restrict__ w, const TI* __restrict__ pending,
               void* __restrict__ out, int out_bf16, int J, int N, long long K) {
  constexpr int MB = R, WROW = weight_row(R), STEP = 32 / GOSSIP_GROUPS;
  const int NK = weight_rows(N);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar_sh = reinterpret_cast<uint64_t*>(smem);                // full, empty: [2][4]
  float* w_sh = reinterpret_cast<float*>(smem + RING_BARRIERS);        // [J][NK][WROW]
  float* store_sh = w_sh + align4(J * NK * WROW);  // tensor cores: [warp][16][STORE_ROW]
  TI* ring_sh = reinterpret_cast<TI*>(store_sh + (TENSOR_CORES ? STORE_FLOATS : 0));   // [STAGES][N][ROW]
  int* off_sh = reinterpret_cast<int*>(ring_sh + STAGES * N * ROW);    // [STAGES][N]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = lane % GOSSIP_GROUPS;                       // receivers group * MB + r
  const int first = warp * STEP * COLS + lane / GOSSIP_GROUPS;  // columns first + i * STEP
  const Ring<STAGES, ROW, TI> pipe{ring_sh, off_sh, bar_sh, bar_sh + 4, N};
  pipe.init();
  __syncthreads();  // the ring's barriers
  const int tiles = block_tiles<TILE>(K);
  if (warp == GOSSIP_CONSUMERS / 32) {  // the producer
    for (int t = 0; t < tiles; ++t) {
      const long long c0 = tile_start<TILE>(t);
      pipe.fill(t, pending + c0, K, (int)min((long long)TILE, K - c0));
    }
    return;
  }
  // the consumers stage the weights while the first tiles land
  for (int i = tid; i < J * NK * WROW; i += GOSSIP_CONSUMERS) {
    const int m = staged_receiver(i % WROW, R), jn = i / WROW, j = jn / NK, n = jn - j * NK;
    w_sh[i] = m >= 0 && m < N && n < N ? w[((long long)j * N + n) * N + m] : 0.f;
  }
  consumers_sync();

  for (int t = 0; t < tiles; ++t) {
    pipe.wait(t);
    const long long c0 = tile_start<TILE>(t);
    const int cols = (int)min((long long)TILE, K - c0);
    const int s = t % STAGES;
    if (warp * (TILE / 4) >= cols) {  // a warp with no column of the tile idles
    } else if constexpr (TENSOR_CORES) {
      for (int j = 0; j < J; ++j) {
        float c[R][4][4] = {};
        accumulate_tc(c, ring_sh + s * N * ROW + 32 * warp + lane / 4, off_sh + s * N,
                      w_sh + j * NK * WROW + lane / 4, WROW, N);
        float* buf = store_sh + warp * 16 * STORE_ROW;
        store_tc(c, buf, N, cols - 32 * warp, [&](int m, int col, float v) {
          store(out, ((long long)j * N + m) * K + c0 + 32 * warp + col, v, out_bf16);
        });
      }
    } else {
      for (int j = 0; j < J; ++j) {
        float acc[MB][COLS] = {};
        accumulate(acc, ring_sh + s * N * ROW + first, off_sh + s * N,
                   w_sh + j * NK * WROW + group * lane_weights(MB), WROW, N);
#pragma unroll
        for (int r = 0; r < MB; ++r) {
          const int m = group * MB + r;
#pragma unroll
          for (int i = 0; i < COLS; ++i) {
            const int col = first + i * STEP;
            if (m < N && col < cols)
              store(out, ((long long)j * N + m) * K + c0 + col, acc[r][i], out_bf16);
          }
        }
      }
    }
    pipe.release(t);
  }
}

typedef cudaError_t (*enqueue_fn)(const float*, const void*, void*, int, int, int, long long,
                                  size_t, cudaStream_t, int*);

// Launch (or, with `info`, describe) one instance: info = {registers,
// blocks per SM, blocks in the grid}.
template <typename TI, int R>
static cudaError_t run(const float* w, const void* pending, void* out, int out_bf16, int J,
                       int N, long long K, size_t smem, cudaStream_t stream, int* info) {
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm<&enqueue_kernel<TI, R>>(smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const unsigned grid = persistent_grid(per_sm, (K + TILE - 1) / TILE);
  if (info) {
    info[0] = registers<&enqueue_kernel<TI, R>>();
    info[1] = per_sm;
    info[2] = (int)grid;
    return cudaSuccess;
  }
  enqueue_kernel<TI, R><<<grid, GOSSIP_THREADS, smem, stream>>>(
      w, static_cast<const TI*>(pending), out, out_bf16, J, N, K);
  return cudaGetLastError();
}

template <typename TI>
static enqueue_fn pick(int N) {
#define ENQ_CASE(r) \
  case r:           \
    return run<TI, r>;
  if constexpr (TENSOR_CORES) {
    switch (blocking(N)) {
      ENQ_CASE(1) ENQ_CASE(2) ENQ_CASE(3) ENQ_CASE(4)
      default:
        return nullptr;
    }
  } else {
    switch (blocking(N)) {
      ENQ_CASE(1) ENQ_CASE(2) ENQ_CASE(3) ENQ_CASE(4) ENQ_CASE(5) ENQ_CASE(6) ENQ_CASE(7)
      ENQ_CASE(8) ENQ_CASE(9) ENQ_CASE(10) ENQ_CASE(11) ENQ_CASE(12) ENQ_CASE(13) ENQ_CASE(14)
      ENQ_CASE(15) ENQ_CASE(16)
      default:
        return nullptr;
    }
  }
#undef ENQ_CASE
}

// 0: the narrow route (every bucket's weights in one block); 1: the wide
// route; -1: neither takes this shape.
static int route(int J, int N, int in_bf16) {
  if (J < 1 || J > WIDE_MAX_S || N < 1) return -1;
  const int elem = in_bf16 ? 2 : 4;
  if (N <= ENQ_MAX_N && smem_bytes(J, N, elem) <= max_smem_optin()) return 0;
  return wide_smem_bytes(J, N, elem) <= max_smem_optin() ? 1 : -1;
}

static int dispatch(const void* w, const void* pending, void* out, int J, int N, long long K,
                    int in_bf16, int out_bf16, void* stream, int* info) {
  const int r = K < 1 ? -1 : route(J, N, in_bf16);
  if (r < 0) return (int)cudaErrorInvalidValue;
  if (r == 1) {
    WideArgs a;
    a.w = (const float*)w;
    a.w_stride = (long long)N * N;
    a.p = pending;
    a.p_stride = 0;
    a.out = out;
    a.S = J;
    a.N = N;
    a.M = N;
    a.K = K;
    a.per_source = 1;
    a.skip = 0;
    a.out_bf16 = out_bf16;
    for (int s = 0; s < WIDE_MAX_S; ++s) a.slot[s] = 0;
    return wide_dispatch(a, in_bf16, (cudaStream_t)stream, info);
  }
  const long long smem = smem_bytes(J, N, in_bf16 ? 2 : 4);
  const enqueue_fn fn = in_bf16 ? pick<__nv_bfloat16>(N) : pick<float>(N);
  if (!fn) return (int)cudaErrorInvalidValue;
  return (int)fn((const float*)w, pending, out, out_bf16, J, N, K, (size_t)smem,
                 (cudaStream_t)stream, info);
}

extern "C" {


// Shared memory one block needs for J buckets of N clients with a
// pending plane of 2- or 4-byte elements, and the most a block of this
// device may have.
long long enqueue_smem_bytes(int J, int N, int in_bf16) {
  return smem_bytes(J, N, in_bf16 ? 2 : 4);
}
int enqueue_max_smem() { return max_smem_optin(); }
long long enqueue_wide_smem_bytes(int J, int N, int in_bf16) {
  return wide_smem_bytes(J, N, in_bf16 ? 2 : 4);
}
// The route a launch of this shape takes: 0 narrow, 1 wide, -1 none.
int enqueue_route(int J, int N, int in_bf16) { return route(J, N, in_bf16); }

// Launches on `stream` and returns the CUDA error (0 on success).
// w (J, N, N) f32, pending (N, K), out (J, N, K); device pointers.
int enqueue_launch(const void* w, const void* pending, void* out, int J, int N, long long K,
                   int in_bf16, int out_bf16, void* stream) {
  return dispatch(w, pending, out, J, N, K, in_bf16, out_bf16, stream, nullptr);
}

// The instance a launch of this shape takes, without launching:
// info = {registers per thread, blocks per SM, blocks in the grid}.
int enqueue_info(int J, int N, long long K, int in_bf16, int* info) {
  return dispatch(nullptr, nullptr, nullptr, J, N, K, in_bf16, 0, nullptr, info);
}

}  // extern "C"
