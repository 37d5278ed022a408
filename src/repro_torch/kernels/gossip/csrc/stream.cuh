// Device helpers shared by drain.cu and enqueue.cu: a persistent grid
// over the columns of a tall (rows, K) payload, a ring of payload tiles in
// shared memory filled by bulk asynchronous copies from a producer warp,
// and the product of a staged tile with one bucket's weights, on the CUDA
// cores or on the tensor cores.
//
// The ring. Each stage holds `rows` payload rows x TILE columns. A payload
// row starts at element (slot * N + n) * K of a contiguous ring (or n * K
// of a pending plane), and K is odd on the windowed path (Dflat =
// 146,447): an f32 row is only 4-byte aligned, a bf16 row only 2-byte
// aligned. A tensor map (TMA) needs 16-byte-aligned addresses and row
// strides, so it cannot describe such rows; a bulk copy (cp.async.bulk,
// one per row) and a 16-byte cp.async need only a 16-byte-aligned source
// and size. So each row's 16-byte-aligned superset of the tile's columns
// is copied, and the row's element shift is recorded in `off`: tile column
// c of row r lies at smem element off[r] + c. The superset starts at most
// 15 bytes before the first element and ends at most 15 bytes after the
// last one; every 16-byte chunk it reads holds at least one byte of the
// row, so it stays inside the 16-byte granules of the row's allocation.
// Those extra elements are never used.
//
// The product on the CUDA cores. Shared memory serves 32 lanes x 4 bytes
// a cycle, whatever the load's width: a weight broadcast to a warp (every
// lane the same address) costs a cycle per float like any other load. One
// column per lane with all M receivers' weights broadcast (the first
// design) spends one shared-memory cycle per warp FMA. So a lane owns a
// block of MB receivers x COLS columns: per sender it loads MB weights
// and COLS payload values for MB * COLS FMAs. A warp is GROUPS receiver
// groups x (32 / GROUPS) column groups; lane = column group * GROUPS +
// receiver group, so one weight load reads GROUPS distinct float4s and one
// payload load 32 / GROUPS consecutive floats.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GOSSIP_CONSUMERS 128  // threads of the 4 warps that compute
#define GOSSIP_THREADS 160    // threads per block: the consumers and one producer warp
#define RING_BARRIERS 64      // bytes of shared memory for the ring's mbarriers (4 stages)
#define GOSSIP_GROUPS 4       // receiver groups per warp

// floats rounded up to a whole number of 16-byte chunks (copy targets)
__host__ __device__ constexpr int align4(int floats) { return (floats + 3) & ~3; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The payload ring: STAGES stages of `rows` x ROW elements and their row
// offsets, filled by the producer warp's bulk copies. Unit v lands in
// stage v % STAGES; stage s has a `full` barrier (the producer's arrival
// and the bytes of its copies) and an `empty` one (one arrival per
// consumer warp). The producer fills unit v once the consumers have
// released unit v - STAGES; a consumer warp waits for unit u, reads it and
// releases it. No block barrier: each warp runs at its own pace, so one
// warp's stores overlap another's products.
template <int STAGES, int ROW, typename T>
struct Ring {
  T* data;          // [STAGES][rows][ROW]
  int* off;         // [STAGES][rows]
  uint64_t* full;   // [STAGES]
  uint64_t* empty;  // [STAGES]
  int rows;

  __device__ void init() const {  // then a block barrier
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, GOSSIP_CONSUMERS / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  // By the producer warp: unit v's rows (row r at src + r * stride, `cols`
  // columns) into stage v % STAGES.
  __device__ void fill(int v, const T* src, long long stride, int cols) const {
    const int s = v % STAGES, lane = threadIdx.x & 31;
    if (v >= STAGES) mbar_wait(empty + s, (unsigned)(v / STAGES - 1) & 1u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    unsigned bytes = 0;
    for (int r = lane; r < rows; r += 32) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(src + r * stride);
      bytes += ((unsigned)(a & 15) + cols * (unsigned)sizeof(T) + 15) & ~15u;
      off[s * rows + r] = r * ROW + (int)(a & 15) / (int)sizeof(T);
    }
    bytes = __reduce_add_sync(0xffffffffu, bytes);
    if (lane == 0) mbar_expect_tx(full + s, bytes);
    __syncwarp();
    for (int r = lane; r < rows; r += 32) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(src + r * stride);
      const unsigned head = (unsigned)(a & 15);
      if (bytes) bulk_copy(data + (s * rows + r) * ROW, reinterpret_cast<const void*>(a - head),
                           (head + cols * (unsigned)sizeof(T) + 15) & ~15u, full + s);
    }
  }
  __device__ void wait(int u) const { mbar_wait(full + u % STAGES, (unsigned)(u / STAGES) & 1u); }
  __device__ void release(int u) const {  // by a whole consumer warp, after its reads
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + u % STAGES);
  }
};

// A barrier of the consumer warps alone (the producer runs ahead).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(GOSSIP_CONSUMERS) : "memory");
}

// floats of one lane's MB receiver weights for one sender, padded so that
// they load as float4s
__host__ __device__ constexpr int lane_weights(int MB) { return (MB + 3) / 4 * 4; }

// acc[r][i] += sum_n w[n * wrow + r] * tile[off[n] + i * (32 / GROUPS)],
// senders in order: the lane's MB receivers x COLS columns of one staged
// tile (`tile` at the lane's first column, `w` at its first receiver,
// 16-byte aligned, with wrow a multiple of 4).
template <int MB, int COLS, typename T>
__device__ __forceinline__ void accumulate(float (&acc)[MB][COLS], const T* tile,
                                           const int* off, const float* w, int wrow, int N) {
  constexpr int STEP = 32 / GOSSIP_GROUPS, LW = lane_weights(MB);
#pragma unroll 2
  for (int n = 0; n < N; ++n) {
    const T* row = tile + off[n];
    float p[COLS], wv[LW];
#pragma unroll
    for (int i = 0; i < COLS; ++i) p[i] = to_f32(row[i * STEP]);
    const float4* w4 = reinterpret_cast<const float4*>(w + n * wrow);
#pragma unroll
    for (int q = 0; q < LW / 4; ++q) {
      const float4 v = w4[q];
      wv[4 * q] = v.x;
      wv[4 * q + 1] = v.y;
      wv[4 * q + 2] = v.z;
      wv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < MB; ++r)
#pragma unroll
      for (int i = 0; i < COLS; ++i) acc[r][i] = fmaf(wv[r], p[i], acc[r][i]);
  }
}

// The product on the tensor cores: c[mt][q] (16 receivers x 8 columns,
// the mma.sync m16n8k8 TF32 accumulator layout) += W^T P over the N
// senders, eight at a time. A warp owns 32 columns (four 8-column tiles)
// and R 16-receiver tiles. An f32 operand x is split into TF32 hi + lo: hi
// is x truncated to TF32 by a mask, lo the exact remainder, which the
// tensor core reads truncated to TF32 (within 2^-20 of x): a mask and a
// subtraction per operand, no conversion instruction.
// Each product is w_lo p_hi + w_hi p_lo + w_hi p_hi (w_lo p_lo, under
// 2^-20 of it, is dropped); a bf16 payload is exact in TF32, so its p_lo
// term is skipped. `w` is this bucket's [sender][wrow] weights (receivers
// zero-padded to 16 R, senders to a multiple of 8), at the lane's
// receiver g = lane / 4; `tile` is at the warp's first column + g.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int R, typename T>
__device__ __forceinline__ void accumulate_tc(float (&c)[R][4][4], const T* tile, const int* off,
                                              const float* w, int wrow, int N) {
  const int t = threadIdx.x & 3;
  for (int k0 = 0; k0 < N; k0 += 8) {
    const int k1 = k0 + t, k2 = k0 + t + 4;
    const T* row1 = tile + off[min(k1, N - 1)];
    const T* row2 = tile + off[min(k2, N - 1)];
    uint32_t bh[4][2], bl[4][2];  // column g of each 8-column tile, senders k1, k2
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      split_tf32(k1 < N ? to_f32(row1[8 * q]) : 0.f, bh[q][0], bl[q][0]);
      split_tf32(k2 < N ? to_f32(row2[8 * q]) : 0.f, bh[q][1], bl[q][1]);
    }
#pragma unroll
    for (int mt = 0; mt < R; ++mt) {
      const float* w1 = w + k1 * wrow + 16 * mt;
      const float* w2 = w + k2 * wrow + 16 * mt;
      uint32_t ah[4], al[4];  // receivers g, g + 8 of senders k1, k2
      split_tf32(w1[0], ah[0], al[0]);
      split_tf32(w1[8], ah[1], al[1]);
      split_tf32(w2[0], ah[2], al[2]);
      split_tf32(w2[8], ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mma_tf32(c[mt][q], al, bh[q][0], bh[q][1]);
        if constexpr (sizeof(T) == 4) mma_tf32(c[mt][q], ah, bl[q][0], bl[q][1]);
        mma_tf32(c[mt][q], ah, bh[q][0], bh[q][1]);
      }
    }
  }
}

// The tensor-core outputs leave through a per-warp [16][STORE_ROW] f32
// buffer, one 16-receiver tile at a time: the accumulator layout puts a
// row's 32 columns in four lanes, so stored directly each row would leave
// in eight 8-byte pieces; through the buffer it leaves as one coalesced
// 128-byte store per row. STORE_ROW = 40 keeps the fragment writes within
// two-way bank conflicts. store(m, column, value) for receivers m < M and
// the warp's columns < ncols; `buf` is 8-byte aligned.
#define STORE_ROW 40
#define STORE_FLOATS (GOSSIP_CONSUMERS / 32 * 16 * STORE_ROW)  // a block's buffers
template <int R, typename Store>
__device__ __forceinline__ void store_tc(const float (&c)[R][4][4], float* buf, int M, int ncols,
                                         Store store) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < R; ++mt) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)  // columns 2t, 2t + 1 of row g + 8h: one 8-byte store
        *reinterpret_cast<float2*>(buf + (g + 8 * h) * STORE_ROW + 8 * q + 2 * t) =
            make_float2(c[mt][q][2 * h], c[mt][q][2 * h + 1]);
    __syncwarp();
    float v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) v[r] = buf[r * STORE_ROW + lane];
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (16 * mt + r < M && lane < ncols) store(16 * mt + r, lane, v[r]);
    __syncwarp();
  }
}

// The K columns in tiles of TILE, handed out round-robin: block b takes
// tiles b, b + grid, b + 2 grid, ... So the blocks running at one time read
// neighbouring pieces of every payload row (whole DRAM pages, where
// contiguous ranges per block left the blocks' pieces 1 KB apart), and
// no SM holds more than one tile per block above another.
template <int TILE>
__device__ __forceinline__ int block_tiles(long long K) {
  const long long tiles = (K + TILE - 1) / TILE;
  return (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
}
template <int TILE>
__device__ __forceinline__ long long tile_start(int t) {
  return (blockIdx.x + (long long)t * gridDim.x) * TILE;
}

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

static int max_smem_optin() {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return value;
}

// Blocks of GOSSIP_THREADS threads with `smem` bytes of dynamic shared
// memory that fit one SM for this kernel instance, computed once per
// instance and size; opts the instance in above 48 KB first. 0 when the
// block does not fit.
template <auto KERNEL, int THREADS = GOSSIP_THREADS>
static cudaError_t blocks_per_sm(size_t smem, int* blocks) {
  static size_t opted = 48 * 1024, cached_smem = 0;
  static int cached = -1;
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  if (cached < 0 || smem != cached_smem) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached, KERNEL, THREADS, smem);
    if (err != cudaSuccess) {
      cached = -1;
      return err;
    }
    cached_smem = smem;
  }
  *blocks = cached;
  return cudaSuccess;
}

// The persistent grid for `tiles` column tiles: every resident block, but
// no more blocks than tiles.
static unsigned persistent_grid(int per_sm, long long tiles) {
  const long long cap = (long long)per_sm * sm_count();
  return (unsigned)(tiles < cap ? tiles : cap);
}

// Registers a thread of this instance uses (cudaFuncGetAttributes).
template <auto KERNEL>
static int registers() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, KERNEL) == cudaSuccess ? attr.numRegs : -1;
}

// ---------------------------------------------------------------------------
// The wide route: any number of senders N and receivers M, for the shapes
// the narrow instances above cannot hold (N or M above 64, or more buckets'
// weights than a block's shared memory takes at once). One kernel serves
// the drain, the mix and the enqueue:
//
//     out_s (M, K) [+]= sum over the units of source s of W^T P
//
// where source s is a bucket (the drain, the enqueue) or the one plane
// (the mix), W its (N, M) f32 weights at w + s * w_stride and P its (N, K)
// payload at p + slot[s] * p_stride. The drain sums every source into one
// f32 output; the enqueue writes source s to out + s * M * K; the mix is
// one source.
//  - Receivers in G groups of at most WIDE (balanced: ceil(M / G) each)
//    and senders in chunks of WIDE_K (the last one short). Block b keeps
//    one receiver group, b % G, and walks column tiles of WIDE_TILE
//    round-robin with the other blocks of its group.
//  - A unit is (column tile, source, sender chunk). Each unit's payload
//    chunk (<= WIDE_K rows x WIDE_TILE columns) and its weight block (the
//    chunk's senders x the group's receivers, <= WIDE_K x WIDE f32) go
//    into one stage of a WIDE_STAGES ring: each row's 16-byte-aligned
//    superset (rows of either may start at any element) in 16-byte
//    cp.async chunks spread over the block's four warps, one commit group
//    a unit, the copies of unit v + 2 in flight while unit v is reduced. A
//    row's element shift follows from its address, so the warps compute
//    it and no offsets are staged; each thread copies the same row of
//    every unit, so its row offsets are computed once. Two blocks share
//    an SM (~90 KB of shared memory each), so that one block's copies,
//    index arithmetic and stores run under the other's products: a single
//    block per SM waited on its own (PERF.md). Shared memory no longer
//    grows with N, M or J, except a 4-byte entry per (source, chunk) in
//    the unit list.
//  - The accumulators stay in registers across the units of one (tile,
//    group): sources in order (the drain's stack order, oldest first),
//    ascending sender chunks within a source, the reference's f32 order.
//    The product runs on the tensor cores as the narrow drain's does
//    (split TF32, three products; two for a bf16 payload), each split term
//    issued for all 16-receiver x 8-column tiles before the next, so that
//    no MMA waits on the one before it.
//  - With `skip`, a (source, chunk) whose weight block for this group is
//    all zero is left out: the block finds those in a prologue, from the
//    weights alone (exact for finite payloads: such a block adds +-0).
//  - The seed axis (the drain's, `R` > 1): R independent problems, seed
//    r's weights, payloads and outputs `w_seed`, `p_seed`, `out_seed`
//    elements after seed r - 1's. A group's blocks walk (seed, tile)
//    pairs seed-major, so each block meets its seeds in runs and lists
//    each run's live units from that seed's weights: every seed's units,
//    order and arithmetic are those of a launch of its own.
#define WIDE 64                      // receivers per group, at most
#define WIDE_K 32                    // senders per chunk (the last one short)
#define WIDE_TILE GOSSIP_CONSUMERS   // columns per unit: 32 per consumer warp
#define WIDE_ROW (WIDE_TILE + 8)     // payload elements per staged row: the tile and a shift
#define WIDE_WROW 72                 // floats per staged weight row: 64 and a shift, 8 banks apart
#define WIDE_STAGES 3                // units in the ring
#define WIDE_THREADS GOSSIP_CONSUMERS  // four warps, each 32 columns of a unit
static_assert(WIDE_THREADS % WIDE_K == 0, "whole threads per staged row");
#define WIDE_MAX_S 256               // sources (slot indices passed by value)

struct WideArgs {
  const float* w;       // source s: (N, M) at w + s * w_stride
  long long w_stride;
  const void* p;        // source s: (N, K) at p + slot[s] * p_stride
  long long p_stride;
  void* out;            // (M, K), or (S, M, K) with per_source
  int S, N, M;
  long long K;
  int per_source;       // store each source on its own (the enqueue)
  int skip;             // leave out all-zero weight blocks (the drain)
  int out_bf16;         // the outputs' element type
  int slot[WIDE_MAX_S];
  // the seed axis (the drain's): R independent problems, seed r's weights,
  // payloads and outputs these many elements after seed r - 1's
  int R = 1;
  long long w_seed = 0, p_seed = 0, out_seed = 0;
};

// receiver groups and their width, balanced over the M receivers
__host__ __device__ constexpr int wide_parts(int m) { return (m + WIDE - 1) / WIDE; }
__host__ __device__ constexpr int wide_part(int m) {
  return (m + wide_parts(m) - 1) / wide_parts(m);
}
// sender chunks of the N senders
__host__ __device__ constexpr int wide_chunks(int n) { return (n + WIDE_K - 1) / WIDE_K; }

// Dynamic shared memory of one wide block: the warps' store buffers,
// WIDE_STAGES stages of payload and weight rows, and the unit list.
static long long wide_smem_bytes(int S, int N, int elem) {
  return 4LL * STORE_FLOATS +
         (long long)WIDE_STAGES * WIDE_K * (WIDE_ROW * elem + 4 * WIDE_WROW) +
         4LL * align4(S * wide_chunks(N));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One thread's share of a unit's copies: row WIDE_THREADS / WIDE_K of
// the stage (tid / 4) and every fourth 16-byte chunk of it from tid % 4.
// `src` is row 0's first element plus this thread's row offset, in bytes;
// the row's 16-byte-aligned superset of `cols` elements goes to dst (the
// row's first byte in the stage). The row offset is fixed for a kernel,
// so a unit costs a thread a few instructions a chunk.
template <int ROWB, typename T>
__device__ __forceinline__ void wide_copy(unsigned char* dst, uintptr_t src, int cols) {
  constexpr int CHUNKS = ROWB / 16, PER = WIDE_THREADS / WIDE_K;
  const int first = threadIdx.x % PER;
  const unsigned head = (unsigned)(src & 15);
  const int chunks = (int)((head + cols * (unsigned)sizeof(T) + 15) >> 4);
  const unsigned char* from = reinterpret_cast<const unsigned char*>(src - head);
#pragma unroll
  for (int j = 0; j < (CHUNKS + PER - 1) / PER; ++j) {
    const int c = first + PER * j;
    if (c < chunks) cp_async16(dst + 16 * c, from + 16 * c);
  }
}

// acc += W^T P over one staged unit of `rows` senders, as accumulate_tc.
// `tile` is the stage's payload at the warp's first column + g, `w` its
// weights at receiver g; row k's element shift is ((s0 + k * dk) & 15) /
// sizeof(T) for the payload (s0 the byte phase of row 0, dk that of a row
// stride) and likewise (ws0, wdk) for the weights. Senders past `rows`
// count as zero in both operands.
template <int R, typename T>
__device__ __forceinline__ void accumulate_wide(float (&c)[R][4][4], const T* tile, unsigned s0,
                                                unsigned dk, const float* w, unsigned ws0,
                                                unsigned wdk, int rows) {
  const int t = threadIdx.x & 3;
  for (int k0 = 0; k0 < rows; k0 += 8) {
    const bool v1 = k0 + t < rows, v2 = k0 + t + 4 < rows;
    const int k1 = v1 ? k0 + t : 0, k2 = v2 ? k0 + t + 4 : 0;  // rows inside the stage
    const T* row1 = tile + k1 * WIDE_ROW + ((s0 + k1 * dk) & 15) / sizeof(T);
    const T* row2 = tile + k2 * WIDE_ROW + ((s0 + k2 * dk) & 15) / sizeof(T);
    const float* w1 = w + k1 * WIDE_WROW + ((ws0 + k1 * wdk) & 15) / 4;
    const float* w2 = w + k2 * WIDE_WROW + ((ws0 + k2 * wdk) & 15) / 4;
    uint32_t bh[4][2], bl[4][2];  // column g of each 8-column tile, senders k1, k2
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      split_tf32(v1 ? to_f32(row1[8 * q]) : 0.f, bh[q][0], bl[q][0]);
      split_tf32(v2 ? to_f32(row2[8 * q]) : 0.f, bh[q][1], bl[q][1]);
    }
    uint32_t ah[R][4], al[R][4];  // receivers g, g + 8 of senders k1, k2
#pragma unroll
    for (int mt = 0; mt < R; ++mt) {
      split_tf32(v1 ? w1[16 * mt] : 0.f, ah[mt][0], al[mt][0]);
      split_tf32(v1 ? w1[16 * mt + 8] : 0.f, ah[mt][1], al[mt][1]);
      split_tf32(v2 ? w2[16 * mt] : 0.f, ah[mt][2], al[mt][2]);
      split_tf32(v2 ? w2[16 * mt + 8] : 0.f, ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int mt = 0; mt < R; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) mma_tf32(c[mt][q], al[mt], bh[q][0], bh[q][1]);
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int mt = 0; mt < R; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_tf32(c[mt][q], ah[mt], bl[q][0], bl[q][1]);
    }
#pragma unroll
    for (int mt = 0; mt < R; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) mma_tf32(c[mt][q], ah[mt], bh[q][0], bh[q][1]);
  }
}

__device__ __forceinline__ void wide_store(void* out, long long i, float x, int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(out)[i] = x;
}

template <typename T, int R, bool SEEDS>
__global__ void __launch_bounds__(WIDE_THREADS, 2) wide_kernel(const WideArgs a) {
  const int N = a.N, M = a.M, C = wide_chunks(N), CH = WIDE_K;
  const int G = wide_parts(M), GM = wide_part(M);
  const long long K = a.K;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  float* wbuf_sh = reinterpret_cast<float*>(wide_smem);     // [warp][16][STORE_ROW]
  T* p_sh = reinterpret_cast<T*>(wbuf_sh + STORE_FLOATS);   // [WIDE_STAGES][WIDE_K][WIDE_ROW]
  float* w_sh = reinterpret_cast<float*>(p_sh + WIDE_STAGES * WIDE_K * WIDE_ROW);  // [..][WIDE_WROW]
  // [S * C]: the live (source, chunk)s as source << 16 | chunk
  int* unit_sh = reinterpret_cast<int*>(w_sh + WIDE_STAGES * WIDE_K * WIDE_WROW);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = blockIdx.x % G, g0 = group * GM, gm = min(GM, M - g0);
  const int gblock = blockIdx.x / G, gblocks = gridDim.x / G;
  const long long tiles = (K + WIDE_TILE - 1) / WIDE_TILE;

  // One seed's work for this group (its weights W, payloads P and first
  // output element ob): this block's tiles t0 + t * gblocks, t < my_tiles.
  auto wide_seed = [&](const float* __restrict__ W, const T* __restrict__ P, long long ob,
                       long long t0, int my_tiles) {

    for (int i = tid; i < a.S * C; i += WIDE_THREADS) unit_sh[i] = a.skip ? 0 : 1;
    __syncthreads();
    if (a.skip) {  // flag each (source, chunk) with a nonzero weight for this group
      constexpr int ROWS = 8;  // weight rows a warp has in flight, two loads a lane each
      for (int s = 0; s < a.S; ++s) {
        const float* ws = W + s * a.w_stride + g0;
        for (int n0 = warp * ROWS; n0 < N; n0 += ROWS * WIDE_THREADS / 32) {
          float lo[ROWS], hi[ROWS];  // every load issued before any is tested
#pragma unroll
          for (int q = 0; q < ROWS; ++q) {
            const float* row = ws + (long long)min(n0 + q, N - 1) * M;
            lo[q] = row[min(lane, gm - 1)];
            hi[q] = row[min(lane + 32, gm - 1)];
          }
#pragma unroll
          for (int q = 0; q < ROWS; ++q) {
            const bool nz = n0 + q < N && ((lane < gm && lo[q] != 0.f) ||
                                           (lane + 32 < gm && hi[q] != 0.f));
            if (__any_sync(0xffffffffu, nz) && lane == 0) unit_sh[s * C + (n0 + q) / CH] = 1;
          }
        }
      }
      __syncthreads();
    }
    int units = 0;  // the live (source, chunk)s in order, the same in every thread
    for (int i = 0; i < a.S * C; ++i) units += unit_sh[i];
    __syncthreads();
    if (tid == 0) {
      for (int i = 0, u = 0; i < a.S * C; ++i)
        if (unit_sh[i]) unit_sh[u++] = i / C << 16 | i % C;
    }
    __syncthreads();

    float c[R][4][4] = {};
    float* wbuf = wbuf_sh + warp * 16 * STORE_ROW;
    if (units == 0) {  // nothing reaches this group: its outputs are zeros
      for (int t = 0; t < my_tiles; ++t) {
        const long long c0 = (t0 + (long long)t * gblocks) * WIDE_TILE + 32 * warp;
        store_tc(c, wbuf, gm, (int)min((long long)32, K - c0), [&](int m, int col, float v) {
          wide_store(a.out, ob + (long long)(g0 + m) * K + c0 + col, v, a.out_bf16);
        });
      }
      return;
    }
    const int total = my_tiles * units;
    // this thread's row of every stage, and its offsets in the payload and
    // the weights, in bytes
    const int crow = tid / (WIDE_THREADS / WIDE_K);
    const long long prow = (long long)crow * K * (long long)sizeof(T), wrow = 4LL * crow * M;
    const long long tile_step = (long long)gblocks * WIDE_TILE;
    // the units in order, v = (tile, live (source, chunk)): the next one to
    // copy, WIDE_STAGES - 1 units past the one being reduced
    int in_u = 0, in_st = 0;
    long long in_c0 = t0 * WIDE_TILE;
    // its payload rows and weight rows into stage in_st, one commit group
    auto issue = [&](int v) {
      if (v < total) {
        const int i = unit_sh[in_u], s = i >> 16, n0 = (i & 0xffff) * CH;
        const long long c0 = in_c0;
        const int st = in_st;
        if (++in_u == units) {
          in_u = 0;
          in_c0 += tile_step;
        }
        if (++in_st == WIDE_STAGES) in_st = 0;
        if (crow < N - n0) {
          wide_copy<WIDE_ROW * (int)sizeof(T), T>(
              reinterpret_cast<unsigned char*>(p_sh + (st * WIDE_K + crow) * WIDE_ROW),
              reinterpret_cast<uintptr_t>(P + a.slot[s] * a.p_stride + (long long)n0 * K + c0) +
                  prow,
              (int)min((long long)WIDE_TILE, K - c0));
          wide_copy<WIDE_WROW * 4, float>(
              reinterpret_cast<unsigned char*>(w_sh + (st * WIDE_K + crow) * WIDE_WROW),
              reinterpret_cast<uintptr_t>(W + s * a.w_stride + (long long)n0 * M + g0) + wrow,
              gm);
        }
      }
      cp_async_commit();
    };
    for (int v = 0; v < WIDE_STAGES - 1; ++v) issue(v);
    const unsigned pdk = (unsigned)((K * (long long)sizeof(T)) & 15), wdk = (unsigned)((M * 4) & 15);
    int u = 0, st = 0;
    long long c0 = t0 * WIDE_TILE;
    for (int v = 0; v < total; ++v) {
      const int i = unit_sh[u], s = i >> 16, n0 = (i & 0xffff) * CH;
      cp_async_wait<WIDE_STAGES - 2>();  // this thread's copies of unit v have landed
      __syncthreads();  // everyone's; and unit v - 1's stage is free again
      issue(v + WIDE_STAGES - 1);
      if (c0 + 32 * warp < K) {  // a warp with no column of the tile idles
        const unsigned s0 = (unsigned)(reinterpret_cast<uintptr_t>(
                                P + a.slot[s] * a.p_stride + (long long)n0 * K + c0) & 15);
        const unsigned ws0 = (unsigned)(reinterpret_cast<uintptr_t>(
                                 W + s * a.w_stride + (long long)n0 * M + g0) & 15);
        accumulate_wide(c, p_sh + st * WIDE_K * WIDE_ROW + 32 * warp + lane / 4, s0, pdk,
                        w_sh + st * WIDE_K * WIDE_WROW + lane / 4, ws0, wdk, min(CH, N - n0));
      }
      if (u + 1 == units || (a.per_source && unit_sh[u + 1] >> 16 != s)) {
        const long long base = ob + (a.per_source ? (long long)s * M * K : 0) +
                               (long long)g0 * K + c0 + 32 * warp;
        store_tc(c, wbuf, gm, (int)min((long long)32, K - c0 - 32 * warp),
                 [&](int m, int col, float x) {
                   wide_store(a.out, base + (long long)m * K + col, x, a.out_bf16);
                 });
#pragma unroll
        for (int mt = 0; mt < R; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[mt][q][e] = 0.f;
      }
      if (++u == units) {
        u = 0;
        c0 += tile_step;
      }
      if (++st == WIDE_STAGES) st = 0;
    }
    cp_async_wait<0>();
  };

  if constexpr (SEEDS) {
    // the group's (seed, tile) pairs seed * tiles + tile, this block taking
    // gblock, + gblocks, ... in order, so its seeds come in runs
    for (long long v0 = gblock; v0 < a.R * tiles;) {
      const int seed = (int)(v0 / tiles);
      const int my_tiles = (int)(((seed + 1) * tiles - v0 + gblocks - 1) / gblocks);
      __syncthreads();  // the previous run's unit list and stages are free
      wide_seed(a.w + seed * a.w_seed, static_cast<const T*>(a.p) + seed * a.p_seed,
                seed * a.out_seed, v0 - seed * tiles, my_tiles);
      v0 += (long long)my_tiles * gblocks;
    }
  } else {
    wide_seed(a.w, static_cast<const T*>(a.p), 0, gblock,
              (int)((tiles - gblock + gblocks - 1) / gblocks));
  }
}

// The wide grid: G receiver groups x the blocks of each group, as many as
// fit the card at once (at least one per group), no more than the tiles.
static unsigned wide_grid(int per_sm, int M, long long K, int seeds) {
  const long long groups = wide_parts(M), tiles = seeds * ((K + WIDE_TILE - 1) / WIDE_TILE);
  long long each = (long long)per_sm * sm_count() / groups;
  each = each < 1 ? 1 : (each > tiles ? tiles : each);
  return (unsigned)(groups * each);
}

// Launch (or, with `info`, describe: registers, blocks per SM, grid) the
// wide route for `a`, with elements of type T in the payload.
template <typename T, int R, bool SEEDS>
static cudaError_t wide_run(const WideArgs& a, size_t smem, cudaStream_t stream, int* info) {
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm<&wide_kernel<T, R, SEEDS>, WIDE_THREADS>(smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const unsigned grid = wide_grid(per_sm, a.M, a.K, a.R);
  if (info) {
    info[0] = registers<&wide_kernel<T, R, SEEDS>>();
    info[1] = per_sm;
    info[2] = (int)grid;
    return cudaSuccess;
  }
  wide_kernel<T, R, SEEDS><<<grid, WIDE_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// The wide route for `a` (a payload of 2- or 4-byte elements): refuses
// what a block cannot hold, else launches or describes the instance of
// its receiver blocking.
static int wide_dispatch(const WideArgs& a, int in_bf16, cudaStream_t stream, int* info) {
  if (a.S < 0 || a.S > WIDE_MAX_S || a.N < 1 || a.M < 1 || a.K < 1 || a.R < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = wide_smem_bytes(a.S, a.N, in_bf16 ? 2 : 4);
  if (smem > max_smem_optin()) return (int)cudaErrorInvalidValue;
  cudaError_t (*fn)(const WideArgs&, size_t, cudaStream_t, int*) = nullptr;
  switch ((wide_part(a.M) + 15) / 16) {
#define WIDE_CASE(r) \
  case r:            \
    fn = a.R > 1 ? (in_bf16 ? wide_run<__nv_bfloat16, r, true> : wide_run<float, r, true>) \
                 : (in_bf16 ? wide_run<__nv_bfloat16, r, false> : wide_run<float, r, false>); \
    break;
    WIDE_CASE(1) WIDE_CASE(2) WIDE_CASE(3) WIDE_CASE(4)
#undef WIDE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)fn(a, (size_t)smem, stream, info);
}
