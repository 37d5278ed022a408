// Row-stochastic gossip mix for Hopper (sm_90a):
//
//     out (N, K) = Q^T @ deltas,   out[m, k] = sum_n q[n, m] * deltas[n, k]
//
// with f32 accumulation, written in the deltas' dtype (f32 or bf16). q
// (N, N) f32 is (sender, receiver); the client-stacked parameter plane
// deltas (N, K) is row-major and contiguous, its rows at any element
// alignment (K is odd on the windowed path: Dflat = 146,447).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/gossip/gossip.py::gossip_mix_pallas (body
// _gossip_kernel), reached from core/mixing.py::mix_dense once per
// trainer step and from core/baselines.py once per baseline round,
// through kernels/gossip/ops.py::gossip_mix.
//
// Bound. Per call the kernel must read the N * K deltas and the N * N
// weights once and write the N * K outputs once. At the trainer's shape
// (N = 4, K = 1,543,714,304 f32) that is 49.4 GB, 14.75 ms at 3.35 TB/s,
// against 0.74 ms of f32 FMAs; at the baselines' (N = 25, K = 146,447)
// 29.3 MB, 8.7 us, against 2.7 us of FMAs: both bound by bytes. At N =
// 100 the 2.93 GFLOP take 44 us on the CUDA cores, more than the 35 us of
// bytes, so the product goes to the tensor cores there.
//
// Three routes, chosen from N and the block's shared-memory limit alone
// (`route`; ops.mix_route mirrors it):
//
// narrow (N <= 64): the CUDA cores, exact f32 FMAs in sender order (n =
//   0, 1, ..., N-1: the plain version's order, so the mix equals it where
//   the plain product sums the same way).
//  - A thread owns C columns x all receivers (padded to a multiple of 4,
//    not to a power of two: 25 run 28). Per sender it reads the receivers'
//    weights as float4 broadcasts from shared memory, each feeding C FMAs:
//    shared memory serves one float a lane a cycle, so one FMA per weight
//    would bind on its cycles.
//  - Many threads with few registers each hide the loads' latency; each
//    thread issues the loads of a chunk of senders before their FMAs (at
//    these sizes this streams faster than a deep shared-memory ring or
//    fewer threads with wider register tiles; PERF.md).
//  - Columns: a thread's C columns a block apart (scalar, coalesced: rows
//    at any phase, K = 146,447 on the windowed path) or, when every row
//    starts on four elements (the trainer's planes), as 16-byte (f32) or
//    8-byte (bf16) vectors, consecutive threads on consecutive vectors.
//  - A grid of every resident block walks column spans round-robin; each
//    block stages Q once.
// tensor (64 < N, while a receiver group's Q fits a block: N <= 272 in
//   f32 on an H100): the transposed product out^T = deltas^T . Q on the
//   tensor cores by wgmma, split TF32 (three products per sender octet:
//   lo.hi, hi.lo, hi.hi; two for a bf16 payload, which is exact in TF32).
//  - A warpgroup owns 64 columns (wgmma's M) x a receiver group of 64 NB
//    (N = 100 runs 128: the tensor cores have time to spare against the
//    bytes). The deltas are the A operand, 64 columns x 8 senders, from
//    registers (TF32 wgmma reads shared-memory operands K-major only, and
//    a staged payload row is column-contiguous); Q is the B operand, split
//    once per block into hi and lo and stored in wgmma's K-major
//    no-swizzle layout (8 x 16-byte core matrices), read by descriptor.
//  - Two warpgroups per block share the group's Q; each streams its 64
//    columns through a ring of its own, TC_STAGES units of TC_K senders
//    filled by 16-byte cp.async from its threads (each row's
//    16-byte-aligned superset, its shift following from its address), and
//    syncs only its own warps, so one's stores overlap the other's products. Every receiver of N <= 128 sits in one block, so
//    each delta byte is read from device memory once; past 128, groups of
//    64 NB receivers read the same deltas (from L2).
//  - A warpgroup's outputs (its accumulator rows are columns of out) leave
//    through a shared-memory buffer as coalesced 64-column rows.
//  - wgmma, not mma.sync: split-TF32 mma.sync runs at ~17-21 cycles per
//    m16n8k8 at these shapes, too slow to beat torch.matmul at N = 100
//    (PERF.md).
// wide (past that): stream.cuh's wide_kernel with one source (receivers
//   in groups of at most 64, each unit's Q block staged beside its payload
//   chunk, split-TF32 mma.sync).
//
// 64-bit offsets throughout: N * K is 6.17e9 at the trainer's shape. The
// kernels allocate nothing; one launch per call.
#include "stream.cuh"

#define MIX_MAX_N 64         // the narrow route's clients
#define NARROW_THREADS 128   // threads per narrow block

// ---------------------------------------------------------------------------
// The narrow route.

// columns per thread for NR receivers (the accumulators at most 64 floats;
// with VEC 8 columns at N <= 4, for more loads in flight) and senders whose
// loads are issued together (16 loads a thread)
__host__ __device__ constexpr int narrow_cols(int NR, bool vec) {
  return vec ? (NR <= 4 ? 8 : 4) : NR <= 16 ? 4 : NR <= 32 ? 2 : 1;
}
__host__ __device__ constexpr int narrow_chunk(int C) { return 16 / C; }

__device__ __forceinline__ void to_f32x4(float4 v, float* p) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
}
__device__ __forceinline__ void to_f32x4(uint2 v, float* p) {  // four bf16
  p[0] = __uint_as_float(v.x << 16);
  p[1] = __uint_as_float(v.x & 0xffff0000u);
  p[2] = __uint_as_float(v.y << 16);
  p[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// four consecutive elements from and to 16-byte (f32) or 8-byte (bf16) aligned addresses
__device__ __forceinline__ void load4(const float* p, float* x) {
  to_f32x4(*reinterpret_cast<const float4*>(p), x);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  to_f32x4(*reinterpret_cast<const uint2*>(p), x);
}
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2(x[0], x[1]), bf16x2(x[2], x[3]));
}
__device__ __forceinline__ void to_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void to_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// acc[m][i] += w[m] * p[i] for the NR receivers (w 16-byte aligned)
template <int NR, int C>
__device__ __forceinline__ void narrow_fma(float (&acc)[NR][C], const float* w,
                                           const float (&p)[C]) {
#pragma unroll
  for (int m4 = 0; m4 < NR / 4; ++m4) {
    const float4 x = *reinterpret_cast<const float4*>(w + 4 * m4);
    const float wm[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < C; ++i) acc[4 * m4 + k][i] = fmaf(wm[k], p[i], acc[4 * m4 + k][i]);
  }
}

// Column i of a thread: c0 + NARROW_THREADS i with c0 = span start + tid
// (scalar), or c0 + 4 NARROW_THREADS (i / 4) + i % 4 with c0 = span start
// + 4 tid (VEC), so that a warp's accesses are contiguous either way.
template <typename T, int NR, bool VEC>
__global__ void __launch_bounds__(NARROW_THREADS)
narrow_mix_kernel(const float* __restrict__ q, const T* __restrict__ deltas, T* __restrict__ out,
              int N, long long K) {
  if (K < 1) return;  // nothing to mix
  constexpr int C = narrow_cols(NR, VEC), CH = narrow_chunk(C);
  constexpr int STEP = VEC ? 4 * NARROW_THREADS : NARROW_THREADS;  // between a thread's columns (vectors)
  __shared__ __align__(16) float q_sh[NR * NR];  // [sender][receiver], zero-padded
  for (int i = threadIdx.x; i < NR * NR; i += NARROW_THREADS) {
    const int n = i / NR, m = i % NR;
    q_sh[i] = n < N && m < N ? q[n * N + m] : 0.f;
  }
  __syncthreads();
  const long long span = (long long)NARROW_THREADS * C;
  for (long long base = (long long)blockIdx.x * span; base < K; base += (long long)gridDim.x * span) {
    const long long c0 = base + (VEC ? 4LL * threadIdx.x : (long long)threadIdx.x);
    float acc[NR][C];
#pragma unroll
    for (int m = 0; m < NR; ++m)
#pragma unroll
      for (int i = 0; i < C; ++i) acc[m][i] = 0.f;
#pragma unroll 1
    for (int n0 = 0; n0 < N; n0 += CH) {
      float p[CH][C];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const bool live = n0 + j < N;
        const T* row = deltas + (long long)(live ? n0 + j : 0) * K;
        if constexpr (VEC) {
#pragma unroll
          for (int i = 0; i < C; i += 4) {
            const long long c = c0 + (long long)STEP * (i / 4);
            if (live && c < K) {
              load4(row + c, &p[j][i]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) p[j][i + e] = 0.f;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const long long c = c0 + (long long)STEP * i;
            p[j][i] = live && c < K ? to_f32(row[c]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CH; ++j)
        if (n0 + j < N) narrow_fma<NR, C>(acc, q_sh + (n0 + j) * NR, p[j]);
    }
#pragma unroll
    for (int m = 0; m < NR; ++m) {
      if (m < N) {
        T* orow = out + (long long)m * K;
        if constexpr (VEC) {
#pragma unroll
          for (int i = 0; i < C; i += 4) {
            const long long c = c0 + (long long)STEP * (i / 4);
            if (c < K) store4(orow + c, &acc[m][i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const long long c = c0 + (long long)STEP * i;
            if (c < K) to_out(orow + c, acc[m][i]);
          }
        }
      }
    }
  }
}

// Launch (or, with `info`, describe) the narrow instance (NR, VEC)
template <typename T, int NR, bool VEC>
static cudaError_t narrow_run(const float* q, const T* d, T* out, int N, long long K,
                              cudaStream_t stream, int* info) {
  constexpr auto kernel = &narrow_mix_kernel<T, NR, VEC>;
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm<kernel, NARROW_THREADS>(0, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  constexpr long long span = (long long)NARROW_THREADS * narrow_cols(NR, VEC);
  const unsigned grid = persistent_grid(per_sm, (K + span - 1) / span);
  if (info) {
    info[0] = registers<kernel>();
    info[1] = per_sm;
    info[2] = (int)grid;
    return cudaSuccess;
  }
  kernel<<<grid, NARROW_THREADS, 0, stream>>>(q, d, out, N, K);
  return cudaGetLastError();
}

// N <= 64 padded to a multiple of 4; the vector instances for N <= 16
template <typename T>
static cudaError_t narrow_dispatch(const float* q, const T* d, T* out, int N, long long K,
                                   bool vec, cudaStream_t stream, int* info) {
  const int nr = (N + 3) / 4 * 4;
#define NARROW_CASE(NR_)                                                                   \
  if (nr == NR_)                                                                           \
    return vec && NR_ <= 16 ? narrow_run<T, NR_, NR_ <= 16>(q, d, out, N, K, stream, info) \
                            : narrow_run<T, NR_, false>(q, d, out, N, K, stream, info);
  NARROW_CASE(4) NARROW_CASE(8) NARROW_CASE(12) NARROW_CASE(16) NARROW_CASE(20)
  NARROW_CASE(24) NARROW_CASE(28) NARROW_CASE(32) NARROW_CASE(36) NARROW_CASE(40)
  NARROW_CASE(44) NARROW_CASE(48) NARROW_CASE(52) NARROW_CASE(56) NARROW_CASE(60)
  NARROW_CASE(64)
#undef NARROW_CASE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The tensor route.

#define TC_THREADS 256    // two warpgroups
constexpr int TC_TILE = 128;      // columns per tile: 64 per warpgroup
constexpr int TC_K = 32;          // senders per staged unit
constexpr int TC_ROW = 64 + 8;    // elements per staged row: a warpgroup's 64 and a shift
constexpr int TC_STAGES = 3;      // units in a warpgroup's ring
constexpr int TC_NB = 2;          // 64-receiver blocks per group, at most
constexpr int TC_MAX_W = 64 * TC_NB;  // receivers per group, at most
constexpr int TC_LD = 64 + 4;     // floats per row of a warpgroup's output buffer

__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }

// Q of a group of 64 nb receivers, hi and lo, for N senders, and the two
// warpgroups' rings and output buffers (64 receivers x 64 columns each)
static long long tensor_smem_bytes(int N, int nb, int elem) {
  return 2LL * 4 * pad8(N) * 64 * nb + 2LL * TC_STAGES * TC_K * TC_ROW * elem +
         2LL * 64 * TC_LD * 4;
}
// The receiver groups for N clients: {group width, 64-receiver blocks} of
// the widest balanced group (at most TC_MAX_W) whose block fits `limit`
// bytes; false if even one block of 64 does not.
static bool tensor_shape(int N, int elem, long long limit, int* gw, int* nb) {
  for (int groups = (N + TC_MAX_W - 1) / TC_MAX_W; groups <= N; ++groups) {
    const int w = (N + groups - 1) / groups, b = (w + 63) / 64;
    if (tensor_smem_bytes(N, b, elem) <= limit) {
      *gw = w;
      *nb = b;
      return true;
    }
    if (b == 1) return false;
  }
  return false;
}

// A wgmma descriptor of a K-major, unswizzled B tile: 8-row x 16-byte core
// matrices, the two of a row block (senders 0-3, 4-7) 128 bytes apart
// (leading byte offset), row blocks 256 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFFu) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// d (64 columns x 64 receivers, f32) += a (64 columns x 8 senders, TF32 in
// registers) * B (8 senders x 64 receivers, TF32 at `desc`)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int NB>
__device__ __forceinline__ void wg_fence_acc(float (&d)[NB][32]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[b][i])::"memory");
}

// acc += deltas^T Q over one staged unit of `rows` senders (its k-steps of
// 8). `tile` is the stage at the warp's 16 columns + g (row k's element
// shift ((s0 + k * dk) & 15) / sizeof(T)); `qh`, `ql` the Q splits at the
// unit's first k-step. Senders past `rows` count as zero.
template <typename T, int NB>
__device__ __forceinline__ void tensor_mma(float (&acc)[NB][32], const T* tile, unsigned s0,
                                           unsigned dk, const float* qh, const float* ql,
                                           int rows) {
  const int t = threadIdx.x & 3;
  const int ksteps = (rows + 7) / 8;
  uint32_t ah[TC_K / 8][4], al[TC_K / 8][4];  // columns g, g + 8 of senders t, t + 4 of each k-step
#pragma unroll
  for (int ks = 0; ks < TC_K / 8; ++ks) {
    const int k1 = 8 * ks + t, k2 = k1 + 4;
    const bool v1 = k1 < rows, v2 = k2 < rows;
    const T* r1 = tile + k1 * TC_ROW + ((s0 + k1 * dk) & 15) / sizeof(T);
    const T* r2 = tile + k2 * TC_ROW + ((s0 + k2 * dk) & 15) / sizeof(T);
    split_tf32(v1 ? to_f32(r1[0]) : 0.f, ah[ks][0], al[ks][0]);
    split_tf32(v1 ? to_f32(r1[8]) : 0.f, ah[ks][1], al[ks][1]);
    split_tf32(v2 ? to_f32(r2[0]) : 0.f, ah[ks][2], al[ks][2]);
    split_tf32(v2 ? to_f32(r2[8]) : 0.f, ah[ks][3], al[ks][3]);
  }
  wg_fence_acc(acc);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < TC_K / 8; ++ks) {
    if (ks < ksteps) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int tile_off = (ks * NB + b) * 64 * 8;  // floats of a (k-step, block) B tile
        const uint64_t dh = b_desc(qh + tile_off), dl = b_desc(ql + tile_off);
        if constexpr (sizeof(T) == 4) wgmma_tf32(acc[b], al[ks], dh);
        wgmma_tf32(acc[b], ah[ks], dl);
        wgmma_tf32(acc[b], ah[ks], dh);
      }
    }
  }
  wg_commit();
  wg_wait0();
  wg_fence_acc(acc);
}

// The accumulators to out, through this warpgroup's buffer `buf`
// ([64 receivers][TC_LD]), one 64-receiver block at a time: acc[b][4 j +
// e] is column 16 (warp % 4) + g + 8 (e >> 1) of the warpgroup's 64 from
// col0, receiver 64 b + 8 j + 2 t + (e & 1) of the group at `orow`; each
// warp then writes 16 receivers' 64 columns as coalesced rows. Columns < K
// and receivers < gw only.
__device__ __forceinline__ void wg_bar() {  // this warpgroup's four warps
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)(threadIdx.x >> 7)) : "memory");
}
template <typename T, int NB>
__device__ __forceinline__ void tensor_store(const float (&acc)[NB][32], float* buf, T* orow,
                                             long long K, long long col0, int gw) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    wg_bar();  // the buffer's last rows have been read
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        buf[(8 * j + 2 * t + (e & 1)) * TC_LD + 16 * wq + g + 8 * (e >> 1)] = acc[b][4 * j + e];
    wg_bar();
    for (int r = wq; r < 64; r += 4) {
      const int m = 64 * b + r;
      if (m < gw) {
        T* dst = orow + (long long)m * K + col0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (col0 + 32 * h + lane < K) to_out(dst + 32 * h + lane, buf[r * TC_LD + 32 * h + lane]);
      }
    }
  }
}

// Block b: receiver group b % G (receivers g0 .. g0 + GW - 1, the last
// group short; 64 NB of them computed), walking column tiles of TC_TILE
// round-robin with the other blocks of its group. Each warpgroup streams
// its 64 columns of a tile, senders in units of TC_K rows, through a ring
// of its own and syncs only its own four warps, so that one warpgroup's
// stores and waits overlap the other's products. Q's splits live in shared
// memory as [k-step][64-receiver block][8-receiver row block][sender
// half][8][4].
template <typename T, int NB>
__global__ void __launch_bounds__(TC_THREADS, 1)
tensor_mix_kernel(const float* __restrict__ q, const T* __restrict__ deltas, T* __restrict__ out,
              int N, long long K, int GW) {
  if (K < 1) return;  // nothing to mix
  constexpr int CHUNKS = TC_ROW * (int)sizeof(T) / 16;  // 16-byte chunks per staged row
  extern __shared__ __align__(128) unsigned char mix_smem[];
  const int N8 = pad8(N), G = (N + GW - 1) / GW, C = (N + TC_K - 1) / TC_K;
  const int qfloats = N8 * 64 * NB;
  float* qh = reinterpret_cast<float*>(mix_smem);
  float* ql = qh + qfloats;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7, wtid = tid & 127;
  // this warpgroup's ring, [TC_STAGES][TC_K][TC_ROW], and output buffer, [64][TC_LD] f32
  T* ring = reinterpret_cast<T*>(ql + qfloats) + wg * TC_STAGES * TC_K * TC_ROW;
  float* buf = reinterpret_cast<float*>(reinterpret_cast<T*>(ql + qfloats) +
                                        2 * TC_STAGES * TC_K * TC_ROW) + wg * 64 * TC_LD;
  const int group = blockIdx.x % G, g0 = group * GW, gw = min(GW, N - g0);
  const long long gblock = blockIdx.x / G, gblocks = gridDim.x / G;
  const long long tiles = (K + TC_TILE - 1) / TC_TILE;
  const long long total = (tiles - gblock + gblocks - 1) / gblocks * C;
  const long long tile_step = gblocks * TC_TILE;
  // the unit to copy next: (the warpgroup's columns at in_c0, sender chunk
  // in_ch) into stage in_st
  int in_ch = 0, in_st = 0;
  long long in_c0 = gblock * TC_TILE + 64 * wg;
  auto issue = [&](long long v) {
    if (v < total && in_c0 < K) {
      const int n0 = in_ch * TC_K, rows = min(TC_K, N - n0);
      const unsigned bytes = (unsigned)(min(64LL, K - in_c0) * (long long)sizeof(T));
      unsigned char* dst = reinterpret_cast<unsigned char*>(ring + in_st * TC_K * TC_ROW);
      for (int i = wtid; i < rows * CHUNKS; i += 128) {
        const int k = i / CHUNKS, ch = i - k * CHUNKS;
        const uintptr_t a = reinterpret_cast<uintptr_t>(deltas + (long long)(n0 + k) * K + in_c0);
        const unsigned head = (unsigned)(a & 15);
        if (ch < (int)((head + bytes + 15) >> 4))
          cp_async16(dst + (k * TC_ROW * (int)sizeof(T) + 16 * ch),
                     reinterpret_cast<const unsigned char*>(a - head) + 16 * ch);
      }
    }
    if (v < total) {
      if (++in_ch == C) {
        in_ch = 0;
        in_c0 += tile_step;
      }
      if (++in_st == TC_STAGES) in_st = 0;
    }
    cp_async_commit();
  };
  for (int v = 0; v < TC_STAGES - 1; ++v) issue(v);
  // Q's splits for the group, under the first units' copies
  for (int n = warp; n < N8; n += TC_THREADS / 32)
    for (int m = lane; m < 64 * NB; m += 32) {
      const float x = n < N && m < gw ? q[(long long)n * N + g0 + m] : 0.f;
      uint32_t hi, lo;
      split_tf32(x, hi, lo);
      const int k = n & 7, at = ((((n >> 3) * NB + (m >> 6)) * 8 + ((m & 63) >> 3)) * 2 +
                                 (k >> 2)) * 32 + (m & 7) * 4 + (k & 3);
      qh[at] = __uint_as_float(hi);
      ql[at] = __uint_as_float(lo);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  __syncthreads();  // Q's splits, for both warpgroups

  const unsigned dk = (unsigned)((K * (long long)sizeof(T)) & 15);
  const int g = lane >> 2;
  const long long wcol = 16 * (warp & 3);  // the warp's first column in its warpgroup's 64
  float acc[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  int ch = 0, st = 0;
  long long c0 = gblock * TC_TILE + 64 * wg;  // the warpgroup's first column
  for (long long v = 0; v < total; ++v) {
    cp_async_wait<TC_STAGES - 2>();  // this thread's copies of unit v have landed
    wg_bar();  // the warpgroup's; and unit v - 1's stage is free again
    issue(v + TC_STAGES - 1);
    const int n0 = ch * TC_K;
    const unsigned s0 =
        (unsigned)(reinterpret_cast<uintptr_t>(deltas + (long long)n0 * K + c0) & 15);
    tensor_mma<T, NB>(acc, ring + st * TC_K * TC_ROW + wcol + g, s0, dk, qh + n0 * 64 * NB,
                      ql + n0 * 64 * NB, min(TC_K, N - n0));
    if (ch == C - 1) {
      tensor_store<T, NB>(acc, buf, out + (long long)g0 * K, K, c0, gw);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
    }
    if (++ch == C) {
      ch = 0;
      c0 += tile_step;
    }
    if (++st == TC_STAGES) st = 0;
  }
  cp_async_wait<0>();
}

template <typename T, int NB>
static cudaError_t tensor_run(const float* q, const T* d, T* out, int N, long long K, int gw,
                              cudaStream_t stream, int* info) {
  constexpr auto kernel = &tensor_mix_kernel<T, NB>;
  const size_t smem = (size_t)tensor_smem_bytes(N, NB, (int)sizeof(T));
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm<kernel, TC_THREADS>(smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long groups = (N + gw - 1) / gw, tiles = (K + TC_TILE - 1) / TC_TILE;
  long long each = (long long)per_sm * sm_count() / groups;
  each = each < 1 ? 1 : (each > tiles ? tiles : each);
  const unsigned grid = (unsigned)(groups * each);
  if (info) {
    info[0] = registers<kernel>();
    info[1] = per_sm;
    info[2] = (int)grid;
    return cudaSuccess;
  }
  kernel<<<grid, TC_THREADS, smem, stream>>>(q, d, out, N, K, gw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
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

// 0 narrow, 1 tensor, 2 wide (ops.MIX_ROUTES)
static int route(int N, int is_bf16) {
  if (N <= MIX_MAX_N) return 0;
  int gw, nb;
  return tensor_shape(N, is_bf16 ? 2 : 4, max_smem_optin(), &gw, &nb) ? 1 : 2;
}

// Launch or, with `info`, describe the route's instance for these shapes.
template <typename T>
static int dispatch(const float* q, const T* d, T* out, int N, long long K, bool vec,
                    cudaStream_t stream, int* info) {
  const int is_bf16 = sizeof(T) == 2;
  switch (route(N, is_bf16)) {
    case 0:
      return (int)narrow_dispatch<T>(q, d, out, N, K, vec, stream, info);
    case 1: {
      int gw = 0, nb = 0;
      tensor_shape(N, (int)sizeof(T), max_smem_optin(), &gw, &nb);
      static_assert(TC_NB <= 2, "a tensor instance per receiver block count");
      return (int)(nb == 1 ? tensor_run<T, 1>(q, d, out, N, K, gw, stream, info)
                           : tensor_run<T, TC_NB>(q, d, out, N, K, gw, stream, info));
    }
    default:
      return wide_dispatch(wide_args(q, d, out, N, K, is_bf16), is_bf16, stream, info);
  }
}

extern "C" {

int mix_route(int N, int is_bf16) { return N < 1 ? -1 : route(N, is_bf16); }
// {group width, 64-receiver blocks} of the tensor route; 0 if it does not take N
int mix_tensor_shape(int N, int is_bf16, int* shape) {
  return N > MIX_MAX_N && tensor_shape(N, is_bf16 ? 2 : 4, max_smem_optin(), shape, shape + 1);
}
long long mix_wide_smem_bytes(int N, int is_bf16) { return wide_smem_bytes(1, N, is_bf16 ? 2 : 4); }
int mix_max_smem() { return max_smem_optin(); }

// The instance the route of these shapes launches, without launching
// (rows aligned to four elements when K is a multiple of 4): info =
// {registers per thread, blocks per SM, blocks in the grid}.
int mix_info(int N, long long K, int is_bf16, int* info) {
  if (N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const bool vec = K % 4 == 0;
  return is_bf16 ? dispatch<__nv_bfloat16>(nullptr, nullptr, nullptr, N, K, vec, nullptr, info)
                 : dispatch<float>(nullptr, nullptr, nullptr, N, K, vec, nullptr, info);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q (N, N) f32, deltas and out (N, K) of one dtype; device pointers.
int mix_launch(const void* q, const void* deltas, void* out, int N, long long K, int is_bf16,
               void* stream) {
  if (N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  // every row starts on four elements: 16-byte (f32) or 8-byte (bf16) accesses
  const uintptr_t vec_align = 4 * (is_bf16 ? 2 : 4) - 1;
  const bool vec = K % 4 == 0 && (((uintptr_t)deltas | (uintptr_t)out) & vec_align) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>((const float*)q, (const __nv_bfloat16*)deltas,
                                           (__nv_bfloat16*)out, N, K, vec, st, nullptr)
                 : dispatch<float>((const float*)q, (const float*)deltas, (float*)out, N, K, vec,
                                   st, nullptr);
}

}  // extern "C"
