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
template <auto KERNEL>
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
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached, KERNEL, GOSSIP_THREADS, smem);
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
