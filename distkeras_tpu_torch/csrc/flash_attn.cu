// Causal flash attention, forward, dQ and dK/dV, for Hopper (sm_90a).
//
// Replaces, in distkeras_tpu/ops/pallas/flash_attention.py:
//   flash_fwd  <- _fwd_kernel (the pl.pallas_call in _flash_bhld, :213)
//   flash_dq   <- _dq_kernel  (the first pl.pallas_call in _flash_bwd, :249)
//   flash_dkv  <- _dkv_kernel (the second one, :261)
// the custom-VJP triple behind flash_attention.
//
// Inputs q, k, v (and dO) are [B, L, H, D] in the model's own layout, q
// pre-scaled, float32 or bfloat16 (all the same type); the kernels read
// the strided layout directly, one row of D contiguous elements at a time,
// so the wrapper copies and transposes nothing. lse and delta are
// [B*H, L] float32. Outputs are written in the inputs' type.
//
// Numerics, as the TPU kernels compute them: q, k, v, dO and p are rounded
// to bf16 (nearest even) before each product and every product
// accumulates in f32 (the TPU's preferred_element_type=f32 dots); ds is
// rounded to bf16 before it multiplies K or Q. A bf16 x bf16 product is
// exact in f32, so the results differ from the TPU kernels' only by the
// order of the f32 sums.
//   flash_fwd: online softmax over k-tiles 0..the diagonal, running max
//     from -1e30, l summed from the f32 p, acc += bf16(p) V, then
//     out = acc / l and lse = m + log(l). Only the diagonal tile masks.
//   flash_dq:  per q-tile, over k-tiles 0..the diagonal: p = exp(s - lse)
//     (masked), dp = dO V^T, ds = bf16(p * (dp - delta)), dq += ds K.
//   flash_dkv: per k-tile, over q-tiles from the diagonal to the end:
//     dv += bf16(p)^T dO, dk += ds^T Q.
// Every output tile has one owner block, so there are no atomics and two
// calls give the same bits.
//
// What bounds it on this card. At BASELINE config #7's shape (B=8, L=2048,
// H=16, D=64) the forward moves 269 MB in f32 (q, k, v read, out written)
// against 69 GFLOP of causal products, and the backward kernels do 103 and
// 137 GFLOP: at 3.35 TB/s and the tensor cores' 989 TFLOP/s the forward is
// bound by bytes (0.080 ms) a little ahead of its operations (0.069 ms),
// dq and dkv by operations (0.104 and 0.139 ms). The TPU kernel keeps all
// of K and V of a head in VMEM; a Hopper block cannot, and its blocks run
// in parallel in no order.
//
// What the design does about it. One block of 4 warps per (64-row tile,
// batch*head), each warp owning 16 rows; the longest rows are scheduled
// first (tile index reversed for fwd and dq; dkv's k-tile 0 loops longest).
// The products are mma.sync.m16n8k16 bf16 -> f32 on the tensor cores. The
// accumulator layout of S (16 x 8 tiles) is the A-operand layout of P for
// the next product, so s, p and ds stay in registers and never touch
// shared memory; the running max and row sums are reduced over the 4
// lanes of a quad. K, V (and Q, dO in dkv) tiles are staged in shared
// memory as bf16 (the rounding point of the TPU kernel), rows padded by 8
// elements so that every fragment load is free of bank conflicts; the
// B operands that need the transposed tile are read as two 16-bit loads.
// The head dim is padded to 32, 64 or 128 (zeros in the pad), and rows
// past L are loaded as zeros, masked, and never written, so any L >= 1
// works. Simple and right first: one tile in flight at a time, no
// cp.async/TMA pipeline, no wgmma, no warp specialisation; those are the
// next steps.
// expf and logf are the accurate ones; build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;               // query rows of a block, keys of a k-tile
constexpr int kWarps = 4;               // each warp owns 16 rows of the tile
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;          // _NEG of the TPU kernel

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring bf16 of one row (an A fragment, or a B fragment read
// from a tile stored [n][k]).
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p[0] and p[stride] packed (a B fragment read from a tile stored [k][n]).
__device__ __forceinline__ uint32_t ld_pair(const bf16* p, int stride) {
  const uint32_t lo = __bfloat16_as_ushort(p[0]);
  const uint32_t hi = __bfloat16_as_ushort(p[stride]);
  return lo | (hi << 16);
}

// c += a * b on one 16x8x16 tile: a row-major 16x16, b 16x8, c 16x8 f32.
// Lane (g = lane/4, t = lane%4) holds a = {A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]} and
// c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of 16 rows from `row` on, columns col..col+15, of a tile
// in shared memory with row pitch P.
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile,
                                     int P, int row, int col, int g, int t) {
  const bf16* p0 = tile + (row + g) * P + col + 2 * t;
  const bf16* p1 = p0 + 8 * P;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// Eight elements of one row, rounded to bf16.
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Rows r0..r0+63 of one (batch, head) slice of a [B, L, H, D] tensor into
// a bf16 tile [64][DP + 8] in shared memory: rows past L and columns past
// D are zeros.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const T* src, int r0,
                                          int L, int D, size_t rs) {
  constexpr int kChunks = DP / 8;
  constexpr int P = DP + 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L && c < D) v = load8(src + (size_t)(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * P + c) = v;
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Write a warp's 16 x DP accumulator (rows row..row+15 of the slice) to a
// [B, L, H, D] output, rows < L and columns < D.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[DP / 8][4],
                                           int row, int L, int D, size_t rs,
                                           int g, int t) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= D) continue;
    if (row + g < L)
      store_pair(dst + (size_t)(row + g) * rs + col, acc[n][0], acc[n][1]);
    if (row + g + 8 < L)
      store_pair(dst + (size_t)(row + g + 8) * rs + col, acc[n][2],
                 acc[n][3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s[j] (j = 0..7, 64 columns) += A (the warp's 16 rows, DP deep, from
// `at` at row `arow`) * B^T with B's 64 rows from `bt` ([n][k] layout).
template <int DP>
__device__ __forceinline__ void rows_times_tile_t(float (&s)[8][4],
                                                  const bf16* at, int arow,
                                                  const bf16* bt, int g,
                                                  int t) {
  constexpr int P = DP + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ld_a(a, at, P, arow, kk * 16, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* p = bt + (j * 8 + g) * P + kk * 16 + 2 * t;
      mma(s[j], a, ld32(p), ld32(p + 8));
    }
  }
}

// The same with the A operand already in registers.
template <int DP>
__device__ __forceinline__ void frags_times_tile_t(
    float (&s)[8][4], const uint32_t (&af)[DP / 16][4], const bf16* bt,
    int g, int t) {
  constexpr int P = DP + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* p = bt + (j * 8 + g) * P + kk * 16 + 2 * t;
      mma(s[j], af[kk], ld32(p), ld32(p + 8));
    }
}

// acc (16 x DP) += bf16(x) (16 x 64, in accumulator layout) * the tile
// `bt` (64 x DP, [k][n] layout): the accumulator layout of x is the A
// layout of the product, so x never leaves registers.
template <int DP>
__device__ __forceinline__ void regs_times_tile(float (&acc)[DP / 8][4],
                                                const float (&x)[8][4],
                                                const bf16* bt, int g, int t) {
  constexpr int P = DP + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const bf16* p = bt + (kk * 16 + 2 * t) * P + n * 8 + g;
      mma(acc[n], a, ld_pair(p, P), ld_pair(p + 8 * P, P));
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int L, int H, int D) {
  constexpr int P = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * P;
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)b * L * H + h) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, row0 = warp * 16;

  load_tile<T, DP>(ks, q + base, qt * kTile, L, D, rs);
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) ld_a(qf[kk], ks, P, row0, kk * 16, g, t);
  __syncthreads();

  const int qrow = qt * kTile + row0 + g;  // and qrow + 8
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt <= qt; ++kt) {
    load_tile<T, DP>(ks, k + base, kt * kTile, L, D, rs);
    load_tile<T, DP>(vs, v + base, kt * kTile, L, D, rs);
    __syncthreads();
    float s[8][4];
    frags_times_tile_t<DP>(s, qf, ks, g, t);
    const bool diag = kt == qt;
    if (diag) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * kTile + j * 8 + 2 * t + (e & 1) > qrow + 8 * (e >> 1))
            s[j][e] = kNeg;
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float mn[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - mn[r]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = expf(s[j][e] - mn[r]);
        if (diag && kt * kTile + j * 8 + 2 * t + (e & 1) > qrow + 8 * r)
          p = 0.f;
        s[j][e] = p;
        sum[r] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * corr[r] + quad_sum(sum[r]);
      m[r] = mn[r];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    regs_times_tile<DP>(o, s, vs, g, t);
    __syncthreads();
  }
  // out = acc / l, as the TPU kernel divides (not a multiply by 1/l).
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    o[n][0] /= l[0];
    o[n][1] /= l[0];
    o[n][2] /= l[1];
    o[n][3] /= l[1];
  }
  store_rows<T, DP>(out + base, o, qt * kTile + row0, L, D, rs, g, t);
  if (t == 0) {
    float* lrow = lse + (size_t)bh * L;
    if (qrow < L) lrow[qrow] = m[0] + logf(l[0]);
    if (qrow + 8 < L) lrow[qrow + 8] = m[1] + logf(l[1]);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                int L, int H, int D) {
  constexpr int P = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * P;
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)b * L * H + h) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, row0 = warp * 16;

  load_tile<T, DP>(ks, q + base, qt * kTile, L, D, rs);
  load_tile<T, DP>(vs, dout + base, qt * kTile, L, D, rs);
  __syncthreads();
  uint32_t qf[DP / 16][4], df[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ld_a(qf[kk], ks, P, row0, kk * 16, g, t);
    ld_a(df[kk], vs, P, row0, kk * 16, g, t);
  }
  __syncthreads();

  const int qrow = qt * kTile + row0 + g;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    lr[r] = row < L ? lse[(size_t)bh * L + row] : 0.f;
    dr[r] = row < L ? delta[(size_t)bh * L + row] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    load_tile<T, DP>(ks, k + base, kt * kTile, L, D, rs);
    load_tile<T, DP>(vs, v + base, kt * kTile, L, D, rs);
    __syncthreads();
    float s[8][4], dp[8][4];
    frags_times_tile_t<DP>(s, qf, ks, g, t);
    frags_times_tile_t<DP>(dp, df, vs, g, t);
    const bool diag = kt == qt;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool masked =
            diag && kt * kTile + j * 8 + 2 * t + (e & 1) > qrow + 8 * r;
        const float p = masked ? 0.f : expf(s[j][e] - lr[r]);
        s[j][e] = p * (dp[j][e] - dr[r]);  // ds, rounded to bf16 below
      }
    regs_times_tile<DP>(acc, s, ks, g, t);
    __syncthreads();
  }
  store_rows<T, DP>(dq + base, acc, qt * kTile + row0, L, D, rs, g, t);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int L, int H, int D) {
  constexpr int P = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * P;
  bf16* qs = vs + kTile * P;
  bf16* dos = qs + kTile * P;
  float* lse_s = reinterpret_cast<float*>(dos + kTile * P);
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int kt = blockIdx.y;  // k-tile 0 loops over every q-tile: first
  const int nq = gridDim.y;
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)b * L * H + h) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, row0 = warp * 16;
  const int key = kt * kTile + row0 + g;  // and key + 8

  load_tile<T, DP>(ks, k + base, kt * kTile, L, D, rs);
  load_tile<T, DP>(vs, v + base, kt * kTile, L, D, rs);
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = kt; qt < nq; ++qt) {
    load_tile<T, DP>(qs, q + base, qt * kTile, L, D, rs);
    load_tile<T, DP>(dos, dout + base, qt * kTile, L, D, rs);
    if (threadIdx.x < kTile) {
      const int row = qt * kTile + threadIdx.x;
      lse_s[threadIdx.x] = row < L ? lse[(size_t)bh * L + row] : 0.f;
      delta_s[threadIdx.x] = row < L ? delta[(size_t)bh * L + row] : 0.f;
    }
    __syncthreads();
    // The transposed scores: rows are this warp's 16 keys, columns the
    // tile's 64 queries.
    float st[8][4], dpt[8][4];
    rows_times_tile_t<DP>(st, ks, row0, qs, g, t);
    rows_times_tile_t<DP>(dpt, vs, row0, dos, g, t);
    const bool diag = qt == kt;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1), qi = qt * kTile + c;
        const bool masked = qi >= L || (diag && qi < key + 8 * (e >> 1));
        const float p = masked ? 0.f : expf(st[j][e] - lse_s[c]);
        st[j][e] = p;                           // bf16(p) below, for dv
        dpt[j][e] = p * (dpt[j][e] - delta_s[c]);  // ds, bf16 below
      }
    regs_times_tile<DP>(dv_acc, st, dos, g, t);
    regs_times_tile<DP>(dk_acc, dpt, qs, g, t);
    __syncthreads();
  }
  store_rows<T, DP>(dk + base, dk_acc, kt * kTile + row0, L, D, rs, g, t);
  store_rows<T, DP>(dv + base, dv_acc, kt * kTile + row0, L, D, rs, g, t);
}

int check_shape(int B, int L, int H, int D) {
  if (B < 1 || L < 1 || H < 1 || D < 16 || D > 128 || D % 16 != 0 ||
      (L + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Dynamic shared memory of a block: `tiles` bf16 tiles (+ dkv's lse and
// delta rows); above 48 KB the kernel has to be allowed it first.
template <typename K>
int prepare(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DP>
constexpr size_t tile_bytes() {
  return (size_t)kTile * (DP + 8) * sizeof(bf16);
}

template <typename T, int DP>
int fwd(const T* q, const T* k, const T* v, T* out, float* lse, int B,
        int L, int H, int D, cudaStream_t s) {
  const size_t bytes = 2 * tile_bytes<DP>();
  int rc = prepare(flash_fwd_kernel<T, DP>, bytes);
  if (rc != 0) return rc;
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  flash_fwd_kernel<T, DP><<<grid, kThreads, bytes, s>>>(q, k, v, out, lse,
                                                        L, H, D);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int dq_(const T* q, const T* k, const T* v, const T* dout, const float* lse,
        const float* delta, T* dq, int B, int L, int H, int D,
        cudaStream_t s) {
  const size_t bytes = 2 * tile_bytes<DP>();
  int rc = prepare(flash_dq_kernel<T, DP>, bytes);
  if (rc != 0) return rc;
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  flash_dq_kernel<T, DP><<<grid, kThreads, bytes, s>>>(
      q, k, v, dout, lse, delta, dq, L, H, D);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int dkv(const T* q, const T* k, const T* v, const T* dout, const float* lse,
        const float* delta, T* dk, T* dv, int B, int L, int H, int D,
        cudaStream_t s) {
  const size_t bytes = 4 * tile_bytes<DP>() + 2 * kTile * sizeof(float);
  int rc = prepare(flash_dkv_kernel<T, DP>, bytes);
  if (rc != 0) return rc;
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  flash_dkv_kernel<T, DP><<<grid, kThreads, bytes, s>>>(
      q, k, v, dout, lse, delta, dk, dv, L, H, D);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_any(const T* q, const T* k, const T* v, T* out, float* lse, int B,
            int L, int H, int D, void* stream) {
  int rc = check_shape(B, L, H, D);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return fwd<T, 32>(q, k, v, out, lse, B, L, H, D, s);
  if (D <= 64) return fwd<T, 64>(q, k, v, out, lse, B, L, H, D, s);
  return fwd<T, 128>(q, k, v, out, lse, B, L, H, D, s);
}

template <typename T>
int dq_any(const T* q, const T* k, const T* v, const T* dout,
           const float* lse, const float* delta, T* dq, int B, int L, int H,
           int D, void* stream) {
  int rc = check_shape(B, L, H, D);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return dq_<T, 32>(q, k, v, dout, lse, delta, dq, B, L, H, D, s);
  if (D <= 64)
    return dq_<T, 64>(q, k, v, dout, lse, delta, dq, B, L, H, D, s);
  return dq_<T, 128>(q, k, v, dout, lse, delta, dq, B, L, H, D, s);
}

template <typename T>
int dkv_any(const T* q, const T* k, const T* v, const T* dout,
            const float* lse, const float* delta, T* dk, T* dv, int B, int L,
            int H, int D, void* stream) {
  int rc = check_shape(B, L, H, D);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D, s);
  if (D <= 64)
    return dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D, s);
  return dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D, s);
}

}  // namespace

// The forward: q, k, v [B, L, H, D] -> out [B, L, H, D] (the inputs'
// type) and lse [B*H, L] f32. Returns the cudaError_t of the launch.
extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v,
                             float* out, float* lse, int B, int L, int H,
                             int D, void* stream) {
  return fwd_any<float>(q, k, v, out, lse, B, L, H, D, stream);
}
extern "C" int flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                              bf16* out, float* lse, int B, int L, int H,
                              int D, void* stream) {
  return fwd_any<bf16>(q, k, v, out, lse, B, L, H, D, stream);
}

// dq from q, k, v, dO [B, L, H, D] and lse, delta [B*H, L] f32.
extern "C" int flash_dq_f32(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* delta, float* dq, int B, int L,
                            int H, int D, void* stream) {
  return dq_any<float>(q, k, v, dout, lse, delta, dq, B, L, H, D, stream);
}
extern "C" int flash_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                             const bf16* dout, const float* lse,
                             const float* delta, bf16* dq, int B, int L,
                             int H, int D, void* stream) {
  return dq_any<bf16>(q, k, v, dout, lse, delta, dq, B, L, H, D, stream);
}

// dk and dv from the same inputs.
extern "C" int flash_dkv_f32(const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* delta, float* dk, float* dv, int B,
                             int L, int H, int D, void* stream) {
  return dkv_any<float>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D,
                        stream);
}
extern "C" int flash_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                              const bf16* dout, const float* lse,
                              const float* delta, bf16* dk, bf16* dv, int B,
                              int L, int H, int D, void* stream) {
  return dkv_any<bf16>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D,
                       stream);
}
