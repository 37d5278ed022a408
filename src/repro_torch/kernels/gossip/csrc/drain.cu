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
// Bound. The kernel must read the (live J) * N * K payload elements and
// the J * N * M weights once, and write the M * K f32 outputs once. At the
// windowed path's shape (J = 3, N = M = 25, K = Dflat = 146,447, f32) with
// 3 live buckets that is 43.9 MB read and 14.6 MB written, 17.5 us at
// 3.35 TB/s; with 1 live bucket 8.7 us. The useful FMAs, 3 x 25 x 25 x K
// = 274.6 M, take 8.2 us at 67 TFLOP/s: memory-bound on paper. What held
// the first design (one column per thread, every weight broadcast from
// shared memory) at 0.065 ms was the product: one shared-memory cycle per
// warp FMA, and its copies and stores waited behind it (PERF.md).
//
// Design (stream.cuh holds the shared parts).
//  - Persistent grid: as many blocks as fit the card at once
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, once per instance),
//    walking tiles of TILE columns round-robin: no tail wave, and the
//    blocks running together read neighbouring pieces of every row.
//  - Every bucket's (N, M) weights are staged once per block, in one
//    pass; a flag per bucket builds the list of live buckets, so an
//    all-zero bucket is skipped on the device with no host read (exact:
//    it adds an exact +-0, and the reference loop skips it too).
//  - The block's work is a sequence of (tile, live bucket) units. A
//    producer warp copies each unit's N payload rows x TILE columns into a
//    ring of STAGES shared-memory stages, one bulk copy (cp.async.bulk)
//    per row on the stage's mbarrier; odd-K rows are copied as their
//    16-byte-aligned supersets and read at their element shift. Four
//    consumer warps wait for a stage, reduce it and release it, each at
//    its own pace: no block barrier after the prologue.
//  - The product on the tensor cores (stream.cuh: accumulate_tc): TF32
//    mma.sync with each f32 operand split into hi + lo, three products,
//    within 2.5e-6 of the f32 plain version; 2 x 3 x 4 MMAs per warp and
//    8 senders. It issues about a fifth of the CUDA-core product's
//    shared-memory loads, and timed faster on an H100 at this shape
//    (PERF.md; variant `cuda-cores`). Buckets in stack order.
//  - After a tile's last live bucket each output element is written once,
//    through a per-warp buffer so that each row leaves in 128-byte stores
//    (output rows are misaligned like payload rows).
//  - The J slot indices travel by value in the launch; the weights and
//    ring are read in place, with no gather copy.
//
// The seed axis (a sweep's R seeds in one launch, drain_launch_seeds):
// w_stack (R, J, N, M), ring (R, S, N, K), out (R, M, K), the J slots
// shared. The persistent grid walks (seed, tile) pairs, seed-major, so a
// block's pairs come in runs of one seed: per run it stages that seed's
// weights and flags its live buckets (the seeds' delay draws differ), then
// streams that seed's (tile, live bucket) units through the same ring,
// whose unit count runs on across runs. Each seed's units, their order and
// their arithmetic are a solo launch's, so seed r's output equals a solo
// launch on its weights and ring bit for bit; an all-empty seed costs the
// zero write of its (M, K) plane. Shared memory does not grow with R. The
// loop over seed runs is compiled only into the seed-axis instances
// (SEEDS); one seed takes an instance without it (with the loop, the one
// seed paid registers and, on the wide route, spills; PERF.md).
//
// Routes. The design above stages every bucket's (N, M) weights in one
// block, so it takes N, M <= 64 and as many buckets as a block's shared
// memory holds (J = 7 at N = M = 64 in f32). Any other shape takes the
// wide route of stream.cuh (wide_kernel): receivers in groups of at most
// 64 and senders in chunks of 32, each unit's weight block staged through
// the ring beside its payload chunk, the accumulators kept across the units
// of a (tile, receiver group), all-zero weight blocks left out. Both run
// on the tensor cores. `route` picks one from the shape and the block
// limit alone; drain_route tells the wrapper which.
//
// Bound of the wide route (PERF.md). At N = M = 100, 3 live buckets, K =
// 146,447 f32, it reads 175.7 MB and writes 58.6 MB (70 us at 3.35 TB/s);
// the 8.79 GFLOP of useful FMAs take 131 us at 67 TFLOP/s on the CUDA
// cores, so it runs them on the tensor cores like the narrow route.
#include "stream.cuh"

constexpr int STAGES = 3;  // payload tiles in the ring
static_assert(STAGES <= RING_BARRIERS / 16, "two mbarriers a stage");
constexpr bool TENSOR_CORES = true;  // the product on the tensor cores (stream.cuh)
constexpr int COLS = 4;    // columns per lane
constexpr int TILE = GOSSIP_CONSUMERS / GOSSIP_GROUPS * COLS;  // columns per ring stage
constexpr int ROW = TILE + 8;  // elements per staged row: the tile and the largest shift
#define DRAIN_MAX_J 256  // slot indices passed by value (1 KB of launch parameters)
#define DRAIN_MAX_N 64   // the narrow route's senders and receivers
#define DRAIN_MAX_M 64

static_assert(DRAIN_MAX_J <= WIDE_MAX_S, "the wide route takes every bucket");

struct DrainSlots {
  int s[DRAIN_MAX_J];
};

static_assert(!TENSOR_CORES || TILE == GOSSIP_CONSUMERS, "a warp's 32 columns per stage");

// The kernel's receiver blocking R for M receivers: receivers per lane,
// or 16-receiver tiles on the tensor cores.
static int blocking(int M) {
  return TENSOR_CORES ? (M + 15) / 16 : (M + GOSSIP_GROUPS - 1) / GOSSIP_GROUPS;
}
// floats per staged weight row (one sender) and staged senders per bucket
__host__ __device__ constexpr int weight_row(int R) {
  // on the tensor cores 8 or 24 floats over the receivers (mod 32), so an
  // A fragment's four senders fall in four bank octets; above 32 receivers
  // unpadded, so that 7 buckets of 64 x 64 still fit a block
  return TENSOR_CORES ? 16 * R + (R <= 2 ? 8 : 0) : GOSSIP_GROUPS * lane_weights(R);
}
__host__ __device__ constexpr int weight_rows(int N) { return TENSOR_CORES ? (N + 7) / 8 * 8 : N; }
// the receiver at position p of a staged weight row, or -1 for padding
__host__ __device__ constexpr int staged_receiver(int p, int R) {
  return TENSOR_CORES                       ? p
         : p % lane_weights(R) < R ? p / lane_weights(R) * R + p % lane_weights(R)
                                   : -1;
}

// Dynamic shared memory of one block: ring barriers, weights, ring, row
// offsets, live list and flags (and the tensor cores' store buffers).
static long long smem_bytes(int J, int N, int M, int elem) {
  return RING_BARRIERS + 4LL * align4(J * weight_rows(N) * weight_row(blocking(M))) +
         (TENSOR_CORES ? 4LL * STORE_FLOATS : 0) + (long long)STAGES * N * ROW * elem +
         4LL * STAGES * N + 12LL * J;
}

// The seed axis: R independent drains in one launch, seed r reading its
// weights at w_stack + r * w, its ring at ring + r * ring and writing its
// output at out + r * out (element strides). The slots are shared.
struct DrainSeeds {
  int R;
  long long w, ring, out;
};

template <typename T, int R, bool SEEDS>
__global__ void __launch_bounds__(GOSSIP_THREADS)
drain_kernel(const float* __restrict__ w_stack, const T* __restrict__ ring,
             float* __restrict__ out, DrainSlots slots, int J, int N, int M,
             long long K, DrainSeeds seeds) {
  constexpr int MB = R, WROW = weight_row(R), STEP = 32 / GOSSIP_GROUPS;
  const int NK = weight_rows(N);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar_sh = reinterpret_cast<uint64_t*>(smem);                // full, empty: [2][4]
  float* w_sh = reinterpret_cast<float*>(smem + RING_BARRIERS);        // [J][NK][WROW]
  float* store_sh = w_sh + align4(J * NK * WROW);  // tensor cores: [warp][16][STORE_ROW]
  T* ring_sh = reinterpret_cast<T*>(store_sh + (TENSOR_CORES ? STORE_FLOATS : 0));     // [STAGES][N][ROW]
  int* off_sh = reinterpret_cast<int*>(ring_sh + STAGES * N * ROW);   // [STAGES][N]
  int* live_sh = off_sh + STAGES * N;  // [J][2]: (bucket, ring slot) of each live bucket
  int* flag_sh = live_sh + 2 * J;      // [J]: bucket j has a nonzero weight
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = lane % GOSSIP_GROUPS;                       // receivers group * MB + r
  const int first = warp * STEP * COLS + lane / GOSSIP_GROUPS;  // columns first + i * STEP
  const Ring<STAGES, ROW, T> pipe{ring_sh, off_sh, bar_sh, bar_sh + 4, N};
  pipe.init();

  // The block's work. With SEEDS, (seed, tile) pairs v = seed * tiles +
  // tile, taking v = blockIdx.x, + gridDim.x, ... in order, so its seeds
  // come in runs: one pass of the loop per run, the ring's unit count
  // running on across runs. Without, one pass: the block's tiles of the
  // one drain.
  const int tiles = (int)((K + TILE - 1) / TILE);
  const long long total = (long long)seeds.R * tiles;
  long long v0 = blockIdx.x;
  int done = 0;  // ring units of the earlier runs
  do {
    int seed = 0, seg = block_tiles<TILE>(K);  // this run's seed and tiles
    long long t0 = blockIdx.x;                 // t0 + i * gridDim.x, i < seg
    if constexpr (SEEDS) {
      seed = (int)(v0 / tiles);
      seg = (int)(((long long)(seed + 1) * tiles - v0 + gridDim.x - 1) / gridDim.x);
      t0 = v0 - (long long)seed * tiles;
      v0 += (long long)seg * gridDim.x;
      __syncthreads();  // the previous run's weights, list and stages are free
    }
    const float* __restrict__ w = w_stack + seed * seeds.w;
    const T* __restrict__ ring_r = ring + seed * seeds.ring;
    float* __restrict__ out_r = out + seed * seeds.out;

    // every bucket's weights in one pass, all loads in flight together
    for (int j = tid; j < J; j += GOSSIP_THREADS) flag_sh[j] = 0;
    __syncthreads();
    for (int i = tid; i < J * NK * WROW; i += GOSSIP_THREADS) {
      const int jn = i / WROW, j = jn / NK, n = jn - j * NK;
      const int m = staged_receiver(i - jn * WROW, R);
      const float x = m >= 0 && m < M && n < N ? w[((long long)j * N + n) * M + m] : 0.f;
      w_sh[i] = x;
      if (x != 0.f) flag_sh[j] = 1;
    }
    __syncthreads();
    int live = 0;  // the live buckets in stack order, the same in every thread
    for (int j = 0; j < J; ++j) {
      if (!flag_sh[j]) continue;
      if (tid == 0) {
        live_sh[2 * live] = j;
        live_sh[2 * live + 1] = slots.s[j];
      }
      ++live;
    }
    __syncthreads();  // live_sh

    if (live == 0) {
      for (int i = 0; i < seg; ++i) {
        const long long c0 = (t0 + (long long)i * gridDim.x) * TILE;
        for (long long c = c0 + tid; c < min(K, c0 + TILE); c += GOSSIP_THREADS)
          for (int m = 0; m < M; ++m) out_r[(long long)m * K + c] = 0.f;
      }
      continue;
    }
    const int units = seg * live;
    const long long plane = (long long)N * K;
    if (warp == GOSSIP_CONSUMERS / 32) {  // the producer: unit v = (tile v / live, bucket v % live)
      for (int v = 0; v < units; ++v) {
        const int i = v / live, l = v - i * live;
        const long long c0 = (t0 + (long long)i * gridDim.x) * TILE;
        pipe.fill(done + v, ring_r + live_sh[2 * l + 1] * plane + c0, K,
                  (int)min((long long)TILE, K - c0));
      }
      done += units;
      continue;
    }

    float acc[TENSOR_CORES ? 1 : MB][COLS] = {};  // CUDA cores
    float c[TENSOR_CORES ? R : 1][4][4] = {};     // tensor cores
    int t = 0, l = 0;
    for (int u = 0; u < units; ++u) {
      pipe.wait(done + u);
      const int s = (done + u) % STAGES;
      const long long c0 = (t0 + (long long)t * gridDim.x) * TILE;
      const int cols = (int)min((long long)TILE, K - c0);
      const float* wl = w_sh + live_sh[2 * l] * NK * WROW;
      if (warp * (TILE / 4) < cols) {  // a warp with no column of the tile idles
        if constexpr (TENSOR_CORES) {
          accumulate_tc(c, ring_sh + s * N * ROW + 32 * warp + lane / 4, off_sh + s * N,
                        wl + lane / 4, WROW, N);
        } else {
          accumulate(acc, ring_sh + s * N * ROW + first, off_sh + s * N,
                     wl + group * lane_weights(MB), WROW, N);
        }
      }
      pipe.release(done + u);
      if (++l == live) {  // the tile's last live bucket: write it
        if constexpr (TENSOR_CORES) {
          float* buf = store_sh + warp * 16 * STORE_ROW;
          store_tc(c, buf, M, cols - 32 * warp, [&](int m, int col, float v) {
            out_r[(long long)m * K + c0 + 32 * warp + col] = v;
          });
#pragma unroll
          for (int mt = 0; mt < R; ++mt)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) c[mt][q][e] = 0.f;
        } else {
#pragma unroll
          for (int r = 0; r < MB; ++r) {
            const int m = group * MB + r;
#pragma unroll
            for (int i = 0; i < COLS; ++i) {
              const int col = first + i * STEP;
              if (m < M && col < cols) out_r[(long long)m * K + c0 + col] = acc[r][i];
              acc[r][i] = 0.f;
            }
          }
        }
        l = 0;
        ++t;
      }
    }
    done += units;
  } while (SEEDS && v0 < total);
}

typedef cudaError_t (*drain_fn)(const float*, const void*, float*, const DrainSlots&, int, int,
                                int, long long, const DrainSeeds&, size_t, cudaStream_t, int*);

// Launch (or, with `info`, describe) one instance: info = {registers,
// blocks per SM, blocks in the grid}.
template <typename T, int R, bool SEEDS>
static cudaError_t run(const float* w, const void* ring, float* out, const DrainSlots& slots,
                       int J, int N, int M, long long K, const DrainSeeds& seeds, size_t smem,
                       cudaStream_t stream, int* info) {
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm<&drain_kernel<T, R, SEEDS>>(smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const unsigned grid = persistent_grid(per_sm, seeds.R * ((K + TILE - 1) / TILE));
  if (info) {
    info[0] = registers<&drain_kernel<T, R, SEEDS>>();
    info[1] = per_sm;
    info[2] = (int)grid;
    return cudaSuccess;
  }
  drain_kernel<T, R, SEEDS><<<grid, GOSSIP_THREADS, smem, stream>>>(
      w, static_cast<const T*>(ring), out, slots, J, N, M, K, seeds);
  return cudaGetLastError();
}

template <typename T, bool SEEDS>
static drain_fn pick(int M) {
#define DRAIN_CASE(r) \
  case r:             \
    return run<T, r, SEEDS>;
  if constexpr (TENSOR_CORES) {
    switch (blocking(M)) {
      DRAIN_CASE(1) DRAIN_CASE(2) DRAIN_CASE(3) DRAIN_CASE(4)
      default:
        return nullptr;
    }
  } else {
    switch (blocking(M)) {
      DRAIN_CASE(1) DRAIN_CASE(2) DRAIN_CASE(3) DRAIN_CASE(4) DRAIN_CASE(5) DRAIN_CASE(6)
      DRAIN_CASE(7) DRAIN_CASE(8) DRAIN_CASE(9) DRAIN_CASE(10) DRAIN_CASE(11) DRAIN_CASE(12)
      DRAIN_CASE(13) DRAIN_CASE(14) DRAIN_CASE(15) DRAIN_CASE(16)
      default:
        return nullptr;
    }
  }
#undef DRAIN_CASE
}

// 0: the narrow route (every bucket's weights in one block); 1: the wide
// route; -1: neither takes this shape.
static int route(int J, int N, int M, int ring_is_bf16) {
  if (J < 0 || J > DRAIN_MAX_J || N < 1 || M < 1) return -1;
  const int elem = ring_is_bf16 ? 2 : 4;
  if (N <= DRAIN_MAX_N && M <= DRAIN_MAX_M && smem_bytes(J, N, M, elem) <= max_smem_optin())
    return 0;
  return wide_smem_bytes(J, N, elem) <= max_smem_optin() ? 1 : -1;
}

// R seeds of one shape in one launch: seed r's weights, ring and output
// `seeds.w`, `seeds.ring`, `seeds.out` elements after seed r - 1's.
static int dispatch(const void* w_stack, const void* ring, void* out, const int* slots, int J,
                    int N, int M, long long K, const DrainSeeds& seeds, int ring_is_bf16,
                    void* stream, int* info) {
  const int r = K < 1 || seeds.R < 1 ? -1 : route(J, N, M, ring_is_bf16);
  if (r < 0) return (int)cudaErrorInvalidValue;
  if (r == 1) {
    WideArgs a;
    a.w = (const float*)w_stack;
    a.w_stride = (long long)N * M;
    a.p = ring;
    a.p_stride = (long long)N * K;
    a.out = out;
    a.S = J;
    a.N = N;
    a.M = M;
    a.K = K;
    a.per_source = 0;
    a.skip = 1;
    a.out_bf16 = 0;
    a.R = seeds.R;
    a.w_seed = seeds.w;
    a.p_seed = seeds.ring;
    a.out_seed = seeds.out;
    for (int j = 0; j < WIDE_MAX_S; ++j) a.slot[j] = j < J ? slots[j] : 0;
    return wide_dispatch(a, ring_is_bf16, (cudaStream_t)stream, info);
  }
  const long long smem = smem_bytes(J, N, M, ring_is_bf16 ? 2 : 4);
  DrainSlots s;
  for (int j = 0; j < DRAIN_MAX_J; ++j) s.s[j] = j < J ? slots[j] : 0;
  // one seed takes the instance without the seed loop
  const drain_fn fn = seeds.R > 1
                          ? (ring_is_bf16 ? pick<__nv_bfloat16, true>(M) : pick<float, true>(M))
                          : (ring_is_bf16 ? pick<__nv_bfloat16, false>(M) : pick<float, false>(M));
  if (!fn) return (int)cudaErrorInvalidValue;
  return (int)fn((const float*)w_stack, ring, (float*)out, s, J, N, M, K, seeds, (size_t)smem,
                 (cudaStream_t)stream, info);
}

extern "C" {

int drain_max_j() { return DRAIN_MAX_J; }
int drain_max_smem() { return max_smem_optin(); }
long long drain_smem_bytes(int J, int N, int M, int ring_is_bf16) {
  return smem_bytes(J, N, M, ring_is_bf16 ? 2 : 4);
}
long long drain_wide_smem_bytes(int J, int N, int ring_is_bf16) {
  return wide_smem_bytes(J, N, ring_is_bf16 ? 2 : 4);
}
// The route a launch of this shape takes: 0 narrow, 1 wide, -1 none.
int drain_route(int J, int N, int M, int ring_is_bf16) { return route(J, N, M, ring_is_bf16); }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `slots` is a host array of J ring rows; pointers are device pointers.
int drain_launch(const void* w_stack, const void* ring, void* out, const int* slots, int J,
                 int N, int M, long long K, int ring_is_bf16, void* stream) {
  const DrainSeeds one{1, 0, 0, 0};
  return dispatch(w_stack, ring, out, slots, J, N, M, K, one, ring_is_bf16, stream, nullptr);
}

// R seeds in one launch: w_stack (R, J, N, M), ring (R, S, N, K) and out
// (R, M, K), each seed's block `w_seed`, `ring_seed` and `out_seed`
// elements after the one before; the J slots are shared. Seed r's output
// is what drain_launch gives for its own weights and ring, bit for bit.
int drain_launch_seeds(const void* w_stack, const void* ring, void* out, const int* slots,
                       int R, int J, int N, int M, long long K, long long w_seed,
                       long long ring_seed, long long out_seed, int ring_is_bf16,
                       void* stream) {
  const DrainSeeds seeds{R, w_seed, ring_seed, out_seed};
  return dispatch(w_stack, ring, out, slots, J, N, M, K, seeds, ring_is_bf16, stream, nullptr);
}

// The instance a launch of this shape takes, without launching:
// info = {registers per thread, blocks per SM, blocks in the grid}.
int drain_info(int J, int N, int M, long long K, int ring_is_bf16, int* info) {
  int zero[DRAIN_MAX_J] = {0};
  const DrainSeeds one{1, 0, 0, 0};
  return dispatch(nullptr, nullptr, nullptr, zero, J, N, M, K, one, ring_is_bf16, nullptr, info);
}

}  // extern "C"
