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
// no head-major copy and no H / G repeat of B and C (the reference's
// wrapper materialises jnp.repeat(B_, rep) over heads, an 80x copy at
// mamba2-2.7b's one group of 80 heads). cums and dt are contiguous
// (batch, head, chunk, row); Y (batch, head, chunk, Q, P) and S (batch,
// head, chunk, N, P) are contiguous. Every offset is 64-bit.
//
// Bound. At the trainer's shape (batch 2, 80 heads, 4 chunks of Q = 128,
// N = 128, P = 64, bf16) the necessary work is the lower triangle of
// C B^T (Q (Q + 1) / 2 * N FMAs), its product with X (Q (Q + 1) / 2 * P)
// and S (Q * N * P): 3.4 GFLOP per call, 50 us at the card's 67 TFLOP/s
// of f32 outside the tensor cores (the full Q x Q products of the
// reference are 5.37 GFLOP, 80 us); the bytes (each input read once, Y
// and S written once) are 54 MB, 16 us. So the kernel is bound by
// operations. bf16 tensor cores would need the masked scores rounded
// to bf16 or TF32, which the reference does not do; this kernel keeps
// full f32.
//
// Design (simple and right first).
//  - One launch, two kinds of blocks, 256 threads each. gridDim.x walks
//    the (batch, head, chunk) slices, gridDim.z tiles of 64 columns of
//    P. blockIdx.y < ceil(Q / 32) selects a tile of 32 rows of Y; the
//    rest select a tile of 32 rows of S.
//  - A Y block loops over the 32-column tiles of j at or below its rows
//    (tiles above the diagonal are exactly zero and skipped). For each,
//    it accumulates C_i . B_j over N in chunks of 32 staged in shared
//    memory, masks and scales the 32 x 32 score tile in registers,
//    (j > i is set to 0 before any exp, as the reference's -1e30 mask
//    does: exp(cums_i - cums_j) overflows for j > i at the mamba2 init,
//    where A reaches -80), stages it, and accumulates scores @ X_j into
//    8 register sums per thread.
//  - An S block loops over Q in chunks of 32 rows: B scaled by
//    exp(cums_last - cums_q) * dt_q and X staged in shared memory, 8
//    register sums per thread.
//  - expf, not __expf, and no fast-math flags: the decays span thousands
//    in the exponent.
//  - Tiles are padded to 33 columns where a warp reads down a column, so
//    shared loads are free of bank conflicts; 20.9 KB of static shared
//    memory per block.
//  wgmma, TMA and register tiling are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int SSD_THREADS = 256;
constexpr int TI = 32;  // rows of Y (and of S) per block
constexpr int TJ = 32;  // columns j per score tile
constexpr int TK = 32;  // N per staged chunk of C and B
constexpr int TP = 64;  // columns of P per block
constexpr int TQ = 32;  // rows q per staged chunk of the S reduction
constexpr int LD = 33;  // padded leading dimension of 32-wide tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Strides {
  long long b, g, c, q;  // batch, head or group, chunk, row (elements)
};

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_kernel(const T* __restrict__ C, const T* __restrict__ B,
                 const T* __restrict__ X, const float* __restrict__ cums,
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
  const T* Cz = C + b * cs.b + g * cs.g + c * cs.c;
  const T* Bz = B + b * bs.b + g * bs.g + c * bs.c;
  const T* Xz = X + b * xs.b + h * xs.g + c * xs.c;
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
        for (int e = tid; e < TI * TK; e += SSD_THREADS) {
          const int rr = e / TK, kk = e % TK, n = n0 + kk;
          c_sh[rr * LD + kk] = (i0 + rr < Q && n < N) ? to_f32(Cz[(i0 + rr) * cs.q + n]) : 0.f;
          b_sh[rr * LD + kk] = (j0 + rr < Q && n < N) ? to_f32(Bz[(j0 + rr) * bs.q + n]) : 0.f;
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
      for (int e = tid; e < TJ * TP; e += SSD_THREADS) {
        const int jj = e / TP, pp = e % TP, p = p0 + pp;
        x_sh[e] = (j0 + jj < Q && p < P) ? to_f32(Xz[(j0 + jj) * xs.q + p]) : 0.f;
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
      for (int e = tid; e < TQ * TI; e += SSD_THREADS) {
        const int qq = e / TI, nn = e % TI, q = q0 + qq, n = n0 + nn;
        float v = 0.f;
        if (q < Q && n < N) v = (expf(cum_last - cum[q]) * dtz[q]) * to_f32(Bz[q * bs.q + n]);
        bw_sh[qq * LD + nn] = v;
      }
      for (int e = tid; e < TQ * TP; e += SSD_THREADS) {
        const int qq = e / TP, pp = e % TP, p = p0 + pp;
        x_sh[e] = (q0 + qq < Q && p < P) ? to_f32(Xz[(q0 + qq) * xs.q + p]) : 0.f;
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

extern "C" {

// Launches on `stream` and returns the CUDA error (0 on success).
// Strides are element strides (batch, group or head, chunk, row) of C,
// B (Bb, G, nc, Q, N) and X (Bb, H, nc, Q, P), each with a contiguous
// last dimension; cums, dt (Bb, H, nc, Q) f32, Y (Bb, H, nc, Q, P) f32
// and S (Bb, H, nc, N, P) f32 are contiguous. Device pointers.
int ssd_chunk_launch(const void* C, const void* B, const void* X, const void* cums,
                     const void* dt, void* Y, void* S, int Bb, int H, int G, int nc,
                     int Q, int N, int P, const long long* c_strides,
                     const long long* b_strides, const long long* x_strides,
                     int is_bf16, void* stream) {
  if (Bb < 1 || H < 1 || G < 1 || H % G != 0 || nc < 1 || Q < 1 || N < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const long long slices = (long long)Bb * H * nc;
  const long long tiles_y = (Q + TI - 1) / TI + (N + TI - 1) / TI;
  const long long tiles_z = (P + TP - 1) / TP;
  if (slices > 0x7fffffffLL || tiles_y > 65535 || tiles_z > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides cs{c_strides[0], c_strides[1], c_strides[2], c_strides[3]};
  const Strides bs{b_strides[0], b_strides[1], b_strides[2], b_strides[3]};
  const Strides xs{x_strides[0], x_strides[1], x_strides[2], x_strides[3]};
  const dim3 grid((unsigned)slices, (unsigned)tiles_y, (unsigned)tiles_z);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    ssd_chunk_kernel<__nv_bfloat16><<<grid, SSD_THREADS, 0, st>>>(
        (const __nv_bfloat16*)C, (const __nv_bfloat16*)B, (const __nv_bfloat16*)X,
        (const float*)cums, (const float*)dt, (float*)Y, (float*)S, H, G, nc, Q, N, P,
        cs, bs, xs);
  else
    ssd_chunk_kernel<float><<<grid, SSD_THREADS, 0, st>>>(
        (const float*)C, (const float*)B, (const float*)X, (const float*)cums,
        (const float*)dt, (float*)Y, (float*)S, H, G, nc, Q, N, P, cs, bs, xs);
  return (int)cudaGetLastError();
}

}  // extern "C"
