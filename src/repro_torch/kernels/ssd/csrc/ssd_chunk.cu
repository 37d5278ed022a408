// Mamba2 SSD intra-chunk step for Hopper (sm_90a). For every (batch b,
// head h, chunk c), with C, B (Q, N), X (Q, P) and cums, dt (Q,) of that
// chunk:
//
//     Y[i, p] = sum_{j <= i} ((C_i . B_j) * exp(cums_i - cums_j)) * dt_j * X[j, p]
//     S[n, p] = sum_q (exp(cums_{Q-1} - cums_q) * dt_q * B[q, n]) * X[q, p]
//
// in f32 from f32 or bf16 C, B, X and f32 cums, dt; Y (Q, P) and S (N, P)
// are written in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py::
// ssd_chunk_pallas (body _ssd_chunk_kernel), which the reference reaches
// through kernels/ssd/ops.py::ssd_forward_kernel; in the port it runs in
// every Mamba2 block (models/ssm.py::ssm_block -> kernels/ssd/ops.py::
// ssd_forward -> ssd_chunk).
//
// Layout. Head h reads group g = h / (H / G) of C and B, and the kernel
// takes C, B as (batch, group, chunk, row, N) and X as (batch, head,
// chunk, row, P) through element strides (the last dimension
// contiguous), so the wrapper hands it views of the block's projection:
// no head-major copy and no H / G repeat of B and C. cums and dt are
// contiguous (batch, head, chunk, row); Y (batch, head, chunk, Q, P) and
// S (batch, head, chunk, N, P) are contiguous. Every offset is 64-bit.
//
// Bound. At the trainer's shape (batch 2, 80 heads, 4 chunks of Q = 128,
// N = 128, P = 64, bf16) a call must read 11.8 MB (X once, C and B once
// per group, cums, dt) and write 41.9 MB of f32 Y and S: 53.6 MB, 16.0 us
// at 3.35 TB/s. The necessary products are the lower triangle of C B^T
// (1.35 GFLOP of bf16 x bf16, exact in f32: 1.4 us at the 989 TFLOP/s of
// the bf16 tensor cores) and the f32-operand products, the masked scores
// times X and S (2.02 GFLOP). A route that keeps the f32 operand to f32
// accuracy (at least the ~22 bits of a hi + lo TF32 pair) puts it through
// the tensor cores as two TF32 terms at 495 TFLOP/s (8.2 us) or as three
// bf16 terms at 989 TFLOP/s (6.1 us, this kernel's route), so the
// products take at least 7.5 us. So the kernel is bound by bytes, mostly
// the f32 Y and S it writes.
//
// Split. The tensor cores multiply bf16 or TF32 operands; the scores and
// the decayed B are f32 and the reference keeps them f32. Each is split
// into three bf16 terms, t0 = bf16(v), t1 = bf16(v - t0), t2 = bf16(v -
// t0 - t1) (the residues are exact in f32), so t0 + t1 + t2 holds v to
// about 2^-24 of |v|. X is bf16, so every term times X is exact in f32,
// and three m16n8k16 bf16 products give the f32 product; one pass of
// bf16(v) alone would err by up to 2^-9 of |v|. Three bf16 terms beat two
// TF32 terms (hi + lo, about 22 bits, m16n8k8): one instruction shape for
// every product of the kernel, 3 instead of 4 instructions per 16 x 8 x
// 16 step at equal instruction rate, and 24 bits instead of 22.
//
// Design of the bf16 kernel (ssd_chunk_kernel_tc).
//  - One block of 4 warps computes Y and S of one (batch, head, chunk)
//    for 64 columns of P (gridDim.y tiles P). B (Q x N) and the block's
//    X (Q x 64) are staged once in dynamic shared memory and feed both
//    products; each warp stages the 16 rows of C of the row tile it is
//    on. Q and N are zero-padded to multiples of 16 and P to 64, so the
//    MMA tiles see zeros; Q, N <= 256 (B, X and four C tiles take at most
//    204 KB).
//  - Staging is 16-byte cp.async (zero-filling ragged ends) where the
//    launcher finds a tensor's base pointer 16-byte aligned and its
//    strides multiples of 8 elements; else element by element.
//  - Y: rows in tiles of 16, dealt to the warps in snake order (warp w
//    takes tiles w and 7 - w of every 8) so that the triangle's work is
//    even. For each 16-column tile j at or below the diagonal (tiles
//    wholly above it are skipped), C_i B_j^T accumulates over N in
//    m16n8k16 bf16 MMAs with f32 sums (even and odd 16-steps of N in
//    separate sums, so four MMAs are in flight); each fragment's (i, j)
//    with j > i (or i beyond Q) gets -1e30 in place of cums_i - cums_j
//    before expf, as the reference masks; the scaled scores are split
//    into three bf16 terms straight from the accumulator registers into A
//    fragments (the m16n8 accumulator layout is the m16k16 A layout) and
//    multiply X_j, read with ldmatrix.trans.
//  - S: rows n in tiles of 16, dealt round-robin. B_q is read with
//    ldmatrix.trans as the A fragment of B^T, scaled by
//    exp(cums_last - cums_q) * dt_q in f32, split into three bf16 terms
//    and multiplied by X_q as above.
//  - No barrier after the staging, so a warp goes from its Y tiles to its
//    S tiles without waiting for the others.
//  - expf, not __expf, and no fast-math flags: the decays span thousands
//    in the exponent.
//  - Leading dimensions padded by 16 bytes keep every ldmatrix free of
//    bank conflicts.
//  wgmma and TMA are left for a later change: at this shape the kernel is
//  bound by bytes once the products run on the tensor cores.
//
// f32 C, B and X (on no main path) take ssd_chunk_kernel_simt, f32 FMAs
// outside the tensor cores: 256 threads, a block per (slice, 32 rows of Y
// or of S, 64 columns of P), tiles at or below the diagonal, N and Q in
// chunks of 32 staged in 20.9 KB of static shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, g, c, q;  // batch, head or group, chunk, row (elements)
};

// ---------------------------------------------------------------------
// bf16 inputs: tensor cores
// ---------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_P = 64;          // columns of P per block
constexpr int TC_LDX = TC_P + 8;  // X tile leading dimension: 144-byte rows
constexpr int TC_MAX = 256;       // largest Q and N

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, of which the first `bytes` are
// read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-step over N of the 16 x 16 tile C_i B_j^T: s0 (s1) += C_i (16 x
// 16 of N from k0) times the first (second) 8 rows of B_j, transposed.
__device__ __forceinline__ void cb_step(float (&s0)[4], float (&s1)[4], const bf16* c,
                                        const bf16* bj, int ld, int k0, int lane) {
  unsigned a[4], b[4];
  ldsm_x4(a, c + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 + (lane >> 4) * 8);
  ldsm_x4(b, bj + ((lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
  mma_bf16(s0, a, b[0], b[1]);
  mma_bf16(s1, a, b[2], b[3]);
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}

// (x, y) as three bf16x2 terms t0 + t1 + t2, x in the low halves: each
// term is the nearest bf16 of what the earlier ones left, and those
// residues are exact in f32.
__device__ __forceinline__ void split3(float x, float y, unsigned& t0, unsigned& t1,
                                       unsigned& t2) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  float2 f = __bfloat1622float2(h);
  t0 = bits(h);
  x -= f.x;
  y -= f.y;
  h = __floats2bfloat162_rn(x, y);
  f = __bfloat1622float2(h);
  t1 = bits(h);
  t2 = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// Rows [0, rows_pad) x columns [0, cols_pad) (a multiple of 8) of the
// (rows x cols) matrix at src, row stride ld, into dst with leading
// dimension lds; zero outside (rows x cols). Thread `first` of `step`
// threads takes every step-th 8-column piece. `vec`: src and every row
// are 16-byte aligned, so each piece is one cp.async (the caller waits).
__device__ __forceinline__ void stage(bf16* dst, int lds, const bf16* src, long long ld,
                                      int rows, int cols, int rows_pad, int cols_pad,
                                      bool vec, int first, int step) {
  const int pieces = cols_pad >> 3;
  for (int e = first; e < rows_pad * pieces; e += step) {
    const int r = e / pieces, c = (e - r * pieces) << 3;
    bf16* d = dst + r * lds + c;
    const int n = r < rows ? min(8, max(0, cols - c)) : 0;
    if (vec) {
      cp_async16(d, n ? src + r * ld + c : src, 2 * n);
    } else {
      for (int k = 0; k < 8; ++k) d[k] = k < n ? src[r * ld + c + k] : __float2bfloat16(0.f);
    }
  }
}

// row[p], row[p + 1] = a, b where inside [0, P); `pair`: one 8-byte store
__device__ __forceinline__ void store2(float* row, int p, int P, bool pair, float a, float b) {
  if (pair && p + 1 < P) {
    *reinterpret_cast<float2*>(row + p) = make_float2(a, b);
  } else {
    if (p < P) row[p] = a;
    if (p + 1 < P) row[p + 1] = b;
  }
}

static int tc_smem_bytes(int Q, int N) {
  const int qp = (Q + 15) & ~15, ldb = ((N + 15) & ~15) + 8;
  return 2 * (qp * ldb + qp * TC_LDX + TC_WARPS * 16 * ldb) + 3 * qp * 4;
}

__global__ void __launch_bounds__(TC_THREADS)
ssd_chunk_kernel_tc(const bf16* __restrict__ C, const bf16* __restrict__ B,
                    const bf16* __restrict__ X, const float* __restrict__ cums,
                    const float* __restrict__ dt, float* __restrict__ Y,
                    float* __restrict__ S, int H, int G, int nc, int Q, int N, int P,
                    Strides cs, Strides bs, Strides xs, int vec_c, int vec_b, int vec_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qp = (Q + 15) & ~15, np = (N + 15) & ~15, ldb = np + 8;
  bf16* b_sh = reinterpret_cast<bf16*>(smem_raw);  // [qp][ldb]   B of the chunk
  bf16* x_sh = b_sh + qp * ldb;                     // [qp][TC_LDX] X, this block's columns
  bf16* c_sh = x_sh + qp * TC_LDX;                  // [warp][16][ldb] C rows per warp
  float* cum_sh = reinterpret_cast<float*>(c_sh + TC_WARPS * 16 * ldb);  // [qp]
  float* dt_sh = cum_sh + qp;                                             // [qp]
  float* w_sh = dt_sh + qp;  // [qp] exp(cums_last - cums_q) * dt_q

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;  // the MMA fragments' row and column pair
  const long long zc = blockIdx.x;          // ((b * H) + h) * nc + c
  const int c = (int)(zc % nc);
  const long long bh = zc / nc;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const int g = h / (H / G);
  const int p0 = blockIdx.y * TC_P, pw = min(TC_P, P - p0);
  const bf16* Cz = C + b * cs.b + g * cs.g + c * cs.c;
  const bf16* Bz = B + b * bs.b + g * bs.g + c * bs.c;
  const bf16* Xz = X + b * xs.b + h * xs.g + c * xs.c + p0;
  const float* cum = cums + zc * Q;
  const float* dtz = dt + zc * Q;
  const int row_tiles = qp >> 4;
  bf16* cw = c_sh + warp * 16 * ldb;

  stage(b_sh, ldb, Bz, bs.q, Q, N, qp, np, vec_b, tid, TC_THREADS);
  stage(x_sh, TC_LDX, Xz, xs.q, Q, pw, qp, TC_P, vec_x, tid, TC_THREADS);
  if (warp < row_tiles)  // the warp's first row tile is tile `warp`
    stage(cw, ldb, Cz + warp * 16 * cs.q, cs.q, Q - warp * 16, N, 16, np, vec_c, lane, 32);
  const float cum_last = cum[Q - 1];
  for (int q = tid; q < qp; q += TC_THREADS) {
    const bool in = q < Q;
    cum_sh[q] = in ? cum[q] : 0.f;
    dt_sh[q] = in ? dtz[q] : 0.f;
    w_sh[q] = in ? expf(cum_last - cum[q]) * dtz[q] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  // ---------------- Y, row tiles in snake order ------------------------
  float* yz = Y + zc * Q * P;
  const bool pair_ok = (P & 1) == 0;
  bool first = true;
  for (int base = 0; base < row_tiles; base += 2 * TC_WARPS) {
    for (int half = 0; half < 2; ++half) {
      const int r = base + (half ? 2 * TC_WARPS - 1 - warp : warp);
      if (r >= row_tiles) continue;
      const int i0 = r * 16;
      if (!first) {
        __syncwarp();
        stage(cw, ldb, Cz + i0 * cs.q, cs.q, Q - i0, N, 16, np, vec_c, lane, 32);
        cp_async_wait_all();
        __syncwarp();
      }
      first = false;
      const int ia = i0 + g8, ib = ia + 8;
      const bool ra = ia < Q, rb = ib < Q;
      const float cia = cum_sh[ia], cib = cum_sh[ib];
      float acc[8][4];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;

      for (int j0 = 0; j0 <= i0; j0 += 16) {
        // C_i B_j^T over N: even and odd 16-steps into separate sums, so
        // four MMAs are in flight instead of two
        float sc[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) sc[k][0] = sc[k][1] = sc[k][2] = sc[k][3] = 0.f;
        for (int k0 = 0; k0 < np; k0 += 32) {
          cb_step(sc[0], sc[1], cw, b_sh + j0 * ldb, ldb, k0, lane);
          if (k0 + 16 < np) cb_step(sc[2], sc[3], cw, b_sh + j0 * ldb, ldb, k0 + 16, lane);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int m = 0; m < 4; ++m) sc[k][m] += sc[k + 2][m];
        // mask before the exp, then decay and dt_j, as the reference;
        // split into the A fragments of the 16 x 16 score tile
        unsigned pa[3][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int j = j0 + 8 * s + 2 * t4;
          const float cj0 = cum_sh[j], cj1 = cum_sh[j + 1];
          const float dj0 = dt_sh[j], dj1 = dt_sh[j + 1];
          const float va0 = sc[s][0] * expf(ra && j <= ia ? cia - cj0 : -1e30f) * dj0;
          const float va1 = sc[s][1] * expf(ra && j + 1 <= ia ? cia - cj1 : -1e30f) * dj1;
          const float vb0 = sc[s][2] * expf(rb && j <= ib ? cib - cj0 : -1e30f) * dj0;
          const float vb1 = sc[s][3] * expf(rb && j + 1 <= ib ? cib - cj1 : -1e30f) * dj1;
          split3(va0, va1, pa[0][2 * s], pa[1][2 * s], pa[2][2 * s]);
          split3(vb0, vb1, pa[0][2 * s + 1], pa[1][2 * s + 1], pa[2][2 * s + 1]);
        }
#pragma unroll
        for (int pp = 0; pp < TC_P / 16; ++pp) {
          unsigned xb[4];
          ldsm_x4_t(xb, x_sh + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LDX + pp * 16 +
                            (lane >> 4) * 8);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            mma_bf16(acc[2 * pp], pa[t], xb[0], xb[1]);
            mma_bf16(acc[2 * pp + 1], pa[t], xb[2], xb[3]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int p = p0 + 8 * k + 2 * t4;
        if (ra) store2(yz + (long long)ia * P, p, P, pair_ok, acc[k][0], acc[k][1]);
        if (rb) store2(yz + (long long)ib * P, p, P, pair_ok, acc[k][2], acc[k][3]);
      }
    }
  }

  // ---------------- S, row tiles of n round-robin ----------------------
  float* sz = S + zc * N * P;
  for (int n0 = warp * 16; n0 < np; n0 += TC_WARPS * 16) {
    float acc[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
    for (int q0 = 0; q0 < qp; q0 += 16) {
      // A fragment of B^T (rows n, columns q): registers 0, 1 hold q0 + 2 t4
      // (+1) for n0 + g8 and n0 + g8 + 8, registers 2, 3 the same at q + 8
      unsigned bq[4];
      ldsm_x4_t(bq, b_sh + (q0 + (lane & 7) + (lane >> 4) * 8) * ldb + n0 +
                        ((lane >> 3) & 1) * 8);
      const float2 w01 = *reinterpret_cast<const float2*>(w_sh + q0 + 2 * t4);
      const float2 w89 = *reinterpret_cast<const float2*>(w_sh + q0 + 8 + 2 * t4);
      unsigned pa[3][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bq[m]));
        const float2 w = m < 2 ? w01 : w89;
        split3(v.x * w.x, v.y * w.y, pa[0][m], pa[1][m], pa[2][m]);
      }
#pragma unroll
      for (int pp = 0; pp < TC_P / 16; ++pp) {
        unsigned xb[4];
        ldsm_x4_t(xb, x_sh + (q0 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LDX + pp * 16 +
                          (lane >> 4) * 8);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          mma_bf16(acc[2 * pp], pa[t], xb[0], xb[1]);
          mma_bf16(acc[2 * pp + 1], pa[t], xb[2], xb[3]);
        }
      }
    }
    const int na = n0 + g8, nb = na + 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int p = p0 + 8 * k + 2 * t4;
      if (na < N) store2(sz + (long long)na * P, p, P, pair_ok, acc[k][0], acc[k][1]);
      if (nb < N) store2(sz + (long long)nb * P, p, P, pair_ok, acc[k][2], acc[k][3]);
    }
  }
}

// ---------------------------------------------------------------------
// f32 inputs: f32 FMAs outside the tensor cores
// ---------------------------------------------------------------------

constexpr int SIMT_THREADS = 256;
constexpr int TI = 32;  // rows of Y (and of S) per block
constexpr int TJ = 32;  // columns j per score tile
constexpr int TK = 32;  // N per staged chunk of C and B
constexpr int TP = 64;  // columns of P per block
constexpr int TQ = 32;  // rows q per staged chunk of the S reduction
constexpr int LD = 33;  // padded leading dimension of 32-wide tiles

__global__ void __launch_bounds__(SIMT_THREADS)
ssd_chunk_kernel_simt(const float* __restrict__ C, const float* __restrict__ B,
                      const float* __restrict__ X, const float* __restrict__ cums,
                      const float* __restrict__ dt, float* __restrict__ Y,
                      float* __restrict__ S, int H, int G, int nc, int Q, int N, int P,
                      Strides cs, Strides bs, Strides xs) {
  __shared__ float smem[3 * TI * LD + TJ * TP];
  const int tid = threadIdx.x;
  const int r = tid / 8;      // row of the tile this thread owns (0..31)
  const int lane8 = tid % 8;  // its column slot: columns lane8 + 8 k

  const long long zc = blockIdx.x;  // ((b * H) + h) * nc + c
  const int c = (int)(zc % nc);
  const long long bh = zc / nc;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const int g = h / (H / G);
  const float* Cz = C + b * cs.b + g * cs.g + c * cs.c;
  const float* Bz = B + b * bs.b + g * bs.g + c * bs.c;
  const float* Xz = X + b * xs.b + h * xs.g + c * xs.c;
  const float* cum = cums + zc * Q;
  const float* dtz = dt + zc * Q;
  const int p0 = blockIdx.z * TP;
  const int row_tiles = (Q + TI - 1) / TI;

  if ((int)blockIdx.y < row_tiles) {
    // ---------------- Y rows i0 .. i0 + 31 --------------------------
    float* c_sh = smem;               // [TI][LD]  C_i, one N chunk
    float* b_sh = smem + TI * LD;     // [TJ][LD]  B_j, one N chunk
    float* s_sh = smem + 2 * TI * LD; // [TI][LD]  masked scores
    float* x_sh = smem + 3 * TI * LD; // [TJ][TP]  X_j
    const int i0 = blockIdx.y * TI;
    const int i = i0 + r;
    const float cum_i = i < Q ? cum[i] : 0.f;
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;

    const int j_end = min(Q, i0 + TI);
    for (int j0 = 0; j0 < j_end; j0 += TJ) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int n0 = 0; n0 < N; n0 += TK) {
        for (int e = tid; e < TI * TK; e += SIMT_THREADS) {
          const int rr = e / TK, kk = e % TK, n = n0 + kk;
          c_sh[rr * LD + kk] = (i0 + rr < Q && n < N) ? Cz[(i0 + rr) * cs.q + n] : 0.f;
          b_sh[rr * LD + kk] = (j0 + rr < Q && n < N) ? Bz[(j0 + rr) * bs.q + n] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < TK; ++kk) {
          const float cv = c_sh[r * LD + kk];
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[k] = fmaf(cv, b_sh[(lane8 + 8 * k) * LD + kk], sc[k]);
        }
        __syncthreads();
      }
      // mask before the exp, then decay and dt_j, as the reference
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int jj = lane8 + 8 * k, j = j0 + jj;
        float v = 0.f;
        if (i < Q && j <= i) v = (sc[k] * expf(cum_i - cum[j])) * dtz[j];
        s_sh[r * LD + jj] = v;
      }
      for (int e = tid; e < TJ * TP; e += SIMT_THREADS) {
        const int jj = e / TP, pp = e % TP, p = p0 + pp;
        x_sh[e] = (j0 + jj < Q && p < P) ? Xz[(j0 + jj) * xs.q + p] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < TJ; ++jj) {
        const float sv = s_sh[r * LD + jj];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(sv, x_sh[jj * TP + lane8 + 8 * k], acc[k]);
      }
      __syncthreads();
    }
    if (i < Q) {
      float* yz = Y + (zc * Q + i) * P;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int p = p0 + lane8 + 8 * k;
        if (p < P) yz[p] = acc[k];
      }
    }
  } else {
    // ---------------- S rows n0 .. n0 + 31 --------------------------
    float* bw_sh = smem;            // [TQ][LD]  B_q * exp(cums_last - cums_q) * dt_q
    float* x_sh = smem + TQ * LD;   // [TQ][TP]  X_q
    const int n0 = (blockIdx.y - row_tiles) * TI;
    const float cum_last = cum[Q - 1];
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    for (int q0 = 0; q0 < Q; q0 += TQ) {
      for (int e = tid; e < TQ * TI; e += SIMT_THREADS) {
        const int qq = e / TI, nn = e % TI, q = q0 + qq, n = n0 + nn;
        float v = 0.f;
        if (q < Q && n < N) v = (expf(cum_last - cum[q]) * dtz[q]) * Bz[q * bs.q + n];
        bw_sh[qq * LD + nn] = v;
      }
      for (int e = tid; e < TQ * TP; e += SIMT_THREADS) {
        const int qq = e / TP, pp = e % TP, p = p0 + pp;
        x_sh[e] = (q0 + qq < Q && p < P) ? Xz[(q0 + qq) * xs.q + p] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int qq = 0; qq < TQ; ++qq) {
        const float bv = bw_sh[qq * LD + r];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(bv, x_sh[qq * TP + lane8 + 8 * k], acc[k]);
      }
      __syncthreads();
    }
    const int n = n0 + r;
    if (n < N) {
      float* sz = S + (zc * N + n) * P;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int p = p0 + lane8 + 8 * k;
        if (p < P) sz[p] = acc[k];
      }
    }
  }
}

// 16-byte cp.async can stage a bf16 tensor: its base pointer is 16-byte
// aligned and every row (and batch, group, chunk) offset a multiple of 8
static int rows_aligned16(const void* p, const long long* s) {
  return (uintptr_t)p % 16 == 0 && s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0 &&
         s[3] % 8 == 0;
}

extern "C" {

// Launches on `stream` and returns the CUDA error (0 on success).
// Strides are element strides (batch, group or head, chunk, row) of C,
// B (Bb, G, nc, Q, N) and X (Bb, H, nc, Q, P), each with a contiguous
// last dimension; cums, dt (Bb, H, nc, Q) f32, Y (Bb, H, nc, Q, P) f32
// and S (Bb, H, nc, N, P) f32 are contiguous. Device pointers. bf16
// inputs take Q, N <= 256.
int ssd_chunk_launch(const void* C, const void* B, const void* X, const void* cums,
                     const void* dt, void* Y, void* S, int Bb, int H, int G, int nc,
                     int Q, int N, int P, const long long* c_strides,
                     const long long* b_strides, const long long* x_strides,
                     int is_bf16, void* stream) {
  if (Bb < 1 || H < 1 || G < 1 || H % G != 0 || nc < 1 || Q < 1 || N < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const long long slices = (long long)Bb * H * nc;
  if (slices > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Strides cs{c_strides[0], c_strides[1], c_strides[2], c_strides[3]};
  const Strides bs{b_strides[0], b_strides[1], b_strides[2], b_strides[3]};
  const Strides xs{x_strides[0], x_strides[1], x_strides[2], x_strides[3]};
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    const long long p_tiles = (P + TC_P - 1) / TC_P;
    if (Q > TC_MAX || N > TC_MAX || p_tiles > 65535) return (int)cudaErrorInvalidValue;
    const int bytes = tc_smem_bytes(Q, N);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)slices, (unsigned)p_tiles);
    ssd_chunk_kernel_tc<<<grid, TC_THREADS, bytes, st>>>(
        (const bf16*)C, (const bf16*)B, (const bf16*)X, (const float*)cums,
        (const float*)dt, (float*)Y, (float*)S, H, G, nc, Q, N, P, cs, bs, xs,
        rows_aligned16(C, c_strides), rows_aligned16(B, b_strides),
        rows_aligned16(X, x_strides));
  } else {
    const long long tiles_y = (Q + TI - 1) / TI + (N + TI - 1) / TI;
    const long long tiles_z = (P + TP - 1) / TP;
    if (tiles_y > 65535 || tiles_z > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)slices, (unsigned)tiles_y, (unsigned)tiles_z);
    ssd_chunk_kernel_simt<<<grid, SIMT_THREADS, 0, st>>>(
        (const float*)C, (const float*)B, (const float*)X, (const float*)cums,
        (const float*)dt, (float*)Y, (float*)S, H, G, nc, Q, N, P, cs, bs, xs);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
