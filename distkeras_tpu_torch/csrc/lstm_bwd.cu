// Whole-sequence LSTM BPTT backward, f32 or bf16, for Hopper (sm_90a).
//
// Replaces: distkeras_tpu/ops/pallas/lstm.py:_bwd_kernel (pl.pallas_call in
// _lstm_bwd), the custom-VJP backward of lstm_seq. Inputs are the residuals
// the stash forward (csrc/lstm_fwd.cu, lstm_fwd_stash_*) wrote, batch-major:
//   dhs, hs, cs [B,T,H], x [B,T,E], gates [B,T,4H] (activated i,f,g,o)
// and it returns dx [B,T,E], dWx [E,4H], dWh [H,4H], db [4H]. Per step s,
// walking t = T-1 .. 0 with carries dh, dc (zero at t = T-1):
//   dh    = dh_carry + dhs[t]
//   do    = dh * tanh(c_t)
//   dc    = dh * o * (1 - tanh(c_t)^2) + dc_carry
//   dpre  = [dc*g * i(1-i), dc*c_{t-1} * f(1-f), dc*i * (1-g^2), do * o(1-o)]
//   dc_carry = dc * f,  dh_carry = dpre . Wh^T,  dx_t = dpre . Wx^T
//   dWx += x_t^T dpre, dWh += h_{t-1}^T dpre, db += sum dpre
// with c_{-1} = h_{-1} = 0 (the first step is masked, as the TPU kernel's
// clamped t-1 blocks are).
//
// What bounds it on this card. 4*T*B*(E+H)*4H FLOP (161 GFLOP at B=2048,
// T=200, E=64, H=128) against 1.68 GB (f32) or 0.84 GB (bf16) of inputs and
// outputs. A quarter of those FLOPs (dh) sits on the T-step serial chain,
// as in the forward; dx, dWx and dWh have no serial dependency at all.
//
// What the design does about it. The TPU kernel's grid is the time axis,
// run in order, with dWx/dWh/db accumulated in output blocks that stay
// resident across the grid. Hopper's blocks run in no order, so the work is
// split by what is serial and what is not: a recurrent kernel walks t and
// writes dpre for every (b, t) to a workspace, and kernels with no serial
// dependency then reduce it. No float atomics anywhere: every sum has one
// owner and a fixed order, so two calls give the same bits.
//
// bf16 (lstm_bwd_recurrent_bf16 then lstm_bwd_wgrad_bf16, the tensor-core
// body). The TPU kernel rounds dpre to bf16 for all four products
// (ops/pallas/lstm.py:127-142) and sums db from the unrounded f32 dpre
// (:143); dWx, dWh and db are f32 sums rounded to bf16 once (:262-263).
// 1. lstm_bwd_rec_tc: the serial chain. A block of 8 warps owns a 16-row
//    batch tile and walks t = T-1 .. 0 (128 blocks at B = 2048, one wave).
//    Each warp reads the whole dpre tile for its product, so 16 warps of
//    8 units read half as much again from shared memory and were slower
//    on the H100 (PERF.md).
//    All of Wh (bf16 [H][4H], 128 KB at H = 128, as the caller stores it:
//    the [n][k] layout mma's B operand wants) sits in shared memory for all
//    T steps. Each step:
//      - lane (g, t) of warp w holds dh, dc for the cells (row g + 8 rr,
//        unit 16w + 8i + 2t + u) in registers: exactly the accumulator
//        layout of the dh product below, so dh never leaves registers;
//      - it builds dpre for its cells in f32 from the stash (gates, c_t,
//        c_{t-1}, dhs read into registers a step ahead: nothing in them
//        depends on the chain), adds the f32 dpre to its db sums, and writes
//        bf16(dpre) to a double-buffered [16][4H] tile in shared memory
//        and to the bf16 workspace [B, T, 4H] (the f32 dpre never goes to
//        memory: 420 MB at B = 2048 where an f32 workspace took 839 MB);
//      - one barrier, then dh_{t-1} = bf16(dpre) . Wh^T on tensor cores
//        (mma.sync m16n8k16, f32 sums; even and odd k-steps in two chains
//        added at the end), each output from one product in a fixed order.
//    db: each lane sums its rows over all t, the lanes of a column are
//    added by a fixed shuffle tree, and the block writes one partial [4H].
// 2. lstm_bwd_wgrad_tc: [dWx; dWh] = A^T . bf16(dpre) over the N = B*T rows,
//    A[n] = [x[n], h_{t-1}[n]] (h_{t-1} = hs one row back, zero at t = 0:
//    the mask is per row, see lstm_wgrad_rows_plain). 64 x 128 output tiles
//    on tensor cores (ldmatrix.trans feeds both operands from row-major
//    slabs of 32 rows), the rows cut into `splits` chunks, each written as
//    an f32 partial.
// 3. lstm_dx_tc: dx = bf16(dpre) . Wx^T, 64-row tiles, Wx as the caller
//    stores it ([E][4H], mma's [n][k] B layout), stored in bf16.
// 4. lstm_wgrad_reduce_tc: each output sums its partials (and db its block
//    partials) in order, rounded to bf16 once.
// What was hard: the dh product's output layout had to be the layout of
// the cells a lane owns, so that dh and dc stay in registers across steps
// with one barrier a step (the tile the step writes was last read by the
// product two steps back, before the previous step's barrier); and
// keeping db summed from the unrounded dpre while only bf16 dpre is
// stored. A cluster over the hidden units (each block a quarter of Wh,
// dpre all-gathered through distributed shared memory) does the same work
// a step on each SM and adds a cluster barrier; it was not built. Widths:
// E and H multiples of 16, H <= 128, Wh and the tiles within 227 KB of
// shared memory; the wrapper raises on others.
//
// f32 (lstm_bwd_f32: the scalar body, simple and right first; the tensor
// cores would not keep f32's limits):
// 1. lstm_bwd_recurrent: one block owns R batch rows and walks t itself.
//    dc lives in the registers of the thread that owns hidden unit k;
//    dh_carry and this step's dpre [4H][R] live in shared memory. Each
//    step: H threads build dpre from the stashed gates and cell states,
//    then E+H output columns (dx_t and dh_{t-1}) are each summed over the
//    4H gate columns in KSPLIT parts by separate threads, and a fixed-order
//    pass adds the parts. The weights come pre-transposed (WxT [4H,E], WhT
//    [4H,H], a layout copy the wrapper makes once per call) and stay in
//    L2. dpre goes to an f32 workspace [B,T,4H].
// 2. lstm_wgrad_partial: [dWx; dWh; db] = A^T . dpre over the B*T rows,
//    with A[n] = [x[n], h_{t-1}[n], 1]: 64x64 output tiles, 16-row k-slabs
//    in shared memory, 4x4 outputs a thread, `splits` chunks of rows.
// 3. lstm_wgrad_reduce: one thread per output sums the partials in order.
//
// Ragged B: rows >= B are masked in the recurrent kernels and never reach
// the workspace; the later kernels only read rows < B*T.
// Precise expf/tanhf; build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxThreads = 512;  // f32: one thread per gate column
constexpr int KSPLIT = 2;         // parts each dx/dh output sum is cut into

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_recurrent(const float* __restrict__ dhs,    // [B, T, H]
                   const float* __restrict__ cs,     // [B, T, H]
                   const float* __restrict__ gates,  // [B, T, 4H]
                   const float* __restrict__ wxt,    // [4H, E]
                   const float* __restrict__ wht,    // [4H, H]
                   float* __restrict__ dx,           // [B, T, E]
                   float* __restrict__ dpre,         // [B, T, 4H] workspace
                   int B, int T, int E, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int NO = E + H;                 // outputs per row: dx_t, dh_{t-1}
  float* dps = smem;                    // [G][R]  this step's dpre
  float* dhc = dps + G * R;             // [H][R]        dh carry
  float* part = dhc + H * R;            // [KSPLIT][NO][R] partial sums

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);

  for (int i = tid; i < H * R; i += blockDim.x) dhc[i] = 0.0f;
  float dc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dc[r] = 0.0f;
  __syncthreads();

  const int JS = G / KSPLIT;
  for (int t = T - 1; t >= 0; --t) {
    if (tid < H) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
        if (r < rows) {
          const size_t bt = (size_t)(row0 + r) * T + t;
          const float* gt = gates + bt * G;
          const float ig = gt[tid];
          const float fg = gt[H + tid];
          const float gg = gt[2 * H + tid];
          const float og = gt[3 * H + tid];
          const float ct = cs[bt * H + tid];
          const float cp = t > 0 ? cs[(bt - 1) * H + tid] : 0.0f;
          const float dh = dhc[tid * R + r] + dhs[bt * H + tid];
          const float th = tanhf(ct);
          const float dO = dh * th;
          const float dC = dh * og * (1.0f - th * th) + dc[r];
          dc[r] = dC * fg;
          d0 = dC * gg * ig * (1.0f - ig);
          d1 = dC * cp * fg * (1.0f - fg);
          d2 = dC * ig * (1.0f - gg * gg);
          d3 = dO * og * (1.0f - og);
          float* dp = dpre + bt * G;
          dp[tid] = d0;
          dp[H + tid] = d1;
          dp[2 * H + tid] = d2;
          dp[3 * H + tid] = d3;
        }
        dps[tid * R + r] = d0;
        dps[(H + tid) * R + r] = d1;
        dps[(2 * H + tid) * R + r] = d2;
        dps[(3 * H + tid) * R + r] = d3;
      }
    }
    __syncthreads();

    // dx_t[r, e] = sum_j dpre[r, j] Wx[e, j];  dh_{t-1}[r, k] likewise with
    // Wh. Work item w = (part, o): output o's sum over gate columns
    // [part*JS, (part+1)*JS).
    for (int w = tid; w < KSPLIT * NO; w += blockDim.x) {
      const int p = w / NO;
      const int o = w - p * NO;
      const float* wt = o < E ? wxt + o : wht + (o - E);
      const int ld = o < E ? E : H;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      const int j0 = p * JS;
#pragma unroll 32
      for (int j = j0; j < j0 + JS; ++j) {
        const float wv = wt[(size_t)j * ld];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(dps[j * R + r], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) part[(p * NO + o) * R + r] = acc[r];
    }
    __syncthreads();

    for (int w = tid; w < NO * R; w += blockDim.x) {
      const int o = w / R;
      const int r = w - o * R;
      float sum = 0.0f;
#pragma unroll
      for (int p = 0; p < KSPLIT; ++p) sum += part[(p * NO + o) * R + r];
      if (o < E) {
        if (r < rows) dx[((size_t)(row0 + r) * T + t) * E + o] = sum;
      } else {
        dhc[(o - E) * R + r] = sum;
      }
    }
    __syncthreads();
  }
}

constexpr int TF = 64;   // output tile: features (rows of A^T)
constexpr int TJ = 64;   // output tile: gate columns
constexpr int TK = 16;   // rows of the B*T reduction per shared-memory slab
constexpr int kWgThreads = 256;

// Feature f of reduction row n = b*T + t: x (f < E), h_{t-1} (f < E+H; zero
// at t = 0), the bias column 1 (f == E+H), zero padding past that.
__device__ __forceinline__ float feature(const float* __restrict__ x,
                                         const float* __restrict__ hs,
                                         long long n, int f, int T, int E,
                                         int H) {
  if (f < E) return x[n * E + f];
  if (f < E + H) return (n % T) != 0 ? hs[(n - 1) * H + (f - E)] : 0.0f;
  return f == E + H ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kWgThreads)
lstm_wgrad_partial(const float* __restrict__ x,          // [N, E]
                   const float* __restrict__ hs,         // [N, H]
                   const float* __restrict__ dpre,       // [N, 4H]
                   float* __restrict__ partial,          // [splits, F, 4H]
                   long long N, long long chunk, int T, int E, int H) {
  __shared__ float As[TK][TF];
  __shared__ float Ds[TK][TJ];
  const int G = 4 * H;
  const int F = E + H + 1;
  const int j0 = blockIdx.x * TJ;
  const int f0 = blockIdx.y * TF;
  const int split = blockIdx.z;
  const long long n_begin = (long long)split * chunk;
  const long long n_end = min(N, n_begin + chunk);
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // 4 gate columns: j0 + tx*4 + {0..3}
  const int ty = tid / 16;   // 4 features:     f0 + ty*4 + {0..3}

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;

  for (long long n0 = n_begin; n0 < n_end; n0 += TK) {
    for (int i = tid; i < TK * TF; i += kWgThreads) {
      const int kk = i / TF;
      const int ff = i - kk * TF;
      const long long n = n0 + kk;
      As[kk][ff] = n < n_end ? feature(x, hs, n, f0 + ff, T, E, H) : 0.0f;
    }
    for (int i = tid; i < TK * TJ; i += kWgThreads) {
      const int kk = i / TJ;
      const int jj = i - kk * TJ;
      const long long n = n0 + kk;
      Ds[kk][jj] = (n < n_end && j0 + jj < G) ? dpre[n * G + j0 + jj] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = As[kk][ty * 4 + q];
        d[q] = Ds[kk][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], d[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int f = f0 + ty * 4 + p;
    if (f >= F) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (j < G) partial[((size_t)split * F + f) * G + j] = acc[p][q];
    }
  }
}

// The f32 sums over the chunks.
__global__ void lstm_wgrad_reduce(const float* __restrict__ partial,
                                  float* __restrict__ dwx,   // [E, 4H]
                                  float* __restrict__ dwh,   // [H, 4H]
                                  float* __restrict__ db,    // [4H]
                                  int splits, int E, int H) {
  const int G = 4 * H;
  const int F = E + H + 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F * G) return;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * F * G + i];
  const int f = i / G;
  const int j = i - f * G;
  if (f < E) {
    dwx[f * G + j] = sum;
  } else if (f < E + H) {
    dwh[(f - E) * G + j] = sum;
  } else {
    db[j] = sum;
  }
}

template <int R>
int launch_recurrent(const float* dhs, const float* cs, const float* gates,
                     const float* wxt, const float* wht, float* dx,
                     float* dpre, int B, int T, int E, int H,
                     cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)R * (4 * H + H + KSPLIT * (E + H));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_recurrent<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (4 * H + 31) / 32 * 32;
  const int grid = (B + R - 1) / R;
  lstm_bwd_recurrent<R><<<grid, threads, smem, stream>>>(
      dhs, cs, gates, wxt, wht, dx, dpre, B, T, E, H);
  return (int)cudaGetLastError();
}

int bwd_f32(const float* dhs, const float* x, const float* hs,
            const float* cs, const float* gates, const float* wxt,
            const float* wht, float* dx, float* dwx, float* dwh, float* db,
            float* dpre, float* partial, int B, int T, int E, int H,
            int splits, void* stream) {
  if (E <= 0 || H <= 0 || 4 * H > kMaxThreads || B <= 0 || T <= 0 ||
      splits <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long N = (long long)B * T;
  const long long chunk = (N + splits - 1) / splits;  // an empty chunk: zeros
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = B <= 128
      ? launch_recurrent<1>(dhs, cs, gates, wxt, wht, dx, dpre, B, T, E, H,
                            s)
      : launch_recurrent<2>(dhs, cs, gates, wxt, wht, dx, dpre, B, T, E, H,
                            s);
  if (rc != 0) return rc;
  const int G = 4 * H;
  const int F = E + H + 1;
  const dim3 grid((G + TJ - 1) / TJ, (F + TF - 1) / TF, splits);
  lstm_wgrad_partial<<<grid, kWgThreads, 0, s>>>(x, hs, dpre, partial, N,
                                                 chunk, T, E, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  lstm_wgrad_reduce<<<(F * G + threads - 1) / threads, threads, 0, s>>>(
      partial, dwx, dwh, db, splits, E, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, Wh resident in shared memory.

using namespace mma_bf16;

constexpr int kRows = 16;         // batch rows a recurrent block: the mma M
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;           // bf16 of padding a shared-memory row
constexpr int kMaxSmem = 232448;  // shared memory a block may use

// Shared memory of the recurrent body: Wh [H][4H+8] and two dpre tiles
// [16][4H+8], bf16. Mirrored by ops/kernels/lstm.py rec_smem_bytes.
size_t rec_smem(int H) {
  return sizeof(bf16) * ((size_t)H * (4 * H + kPad) +
                         2 * kRows * (4 * H + kPad));
}

bool rec_width_ok(int H) {
  return H > 0 && H % 16 == 0 && H <= 16 * kWarps &&
         rec_smem(H) <= (size_t)kMaxSmem;
}

__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// The stash of one step for a lane's cells: gates [group][row][gate], dhs
// and c_{t-1} [group][row], each a pair of units (bf16x2).
struct Stash {
  uint32_t gt[2][2][4], dh[2][2], cp[2][2];
};

__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_rec_tc(const bf16* __restrict__ dhs,    // [B, T, H]
                const bf16* __restrict__ cs,     // [B, T, H]
                const bf16* __restrict__ gates,  // [B, T, 4H]
                const bf16* __restrict__ wh,     // [H, 4H]
                bf16* __restrict__ dpre,         // [B, T, 4H] workspace
                float* __restrict__ dbp,         // [tiles, 4H] db partials
                int B, int T, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H, GS = G + kPad;
  bf16* whs = reinterpret_cast<bf16*>(smem_raw);  // [H][GS]
  bf16* ab = whs + (size_t)H * GS;                // [2][kRows][GS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const bool active = 2 * warp < H / 8;  // owns units 16w .. 16w+15

  const int gv = G / 8;
  for (int i = tid; i < H * gv; i += kThreads) {
    const int n = i / gv, c = i - n * gv;
    *reinterpret_cast<uint4*>(whs + (size_t)n * GS + c * 8) =
        *reinterpret_cast<const uint4*>(wh + (size_t)n * G + c * 8);
  }

  // Lane (g, tq) of warp w: cells e = 2 rr + u of group i at row g + 8 rr,
  // unit 16w + 8i + 2tq + u.
  bool rv[2];
  size_t rbase[2];  // (row0 + r) * T, for rows < B
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    rv[rr] = active && row0 + g + 8 * rr < B;
    rbase[rr] = rv[rr] ? (size_t)(row0 + g + 8 * rr) * T : 0;
  }
  const int ubase = 16 * warp + 2 * tq;

  // The stash of step t (c_{t-1} of it included; zero at t = 0).
  auto load = [&](Stash& s, int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int unit = ubase + 8 * i;
        const size_t bt = rbase[rr] + t;
        const bool ok = rv[rr];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          s.gt[i][rr][gate] = ok ? ld2(gates + bt * G + gate * H + unit) : 0u;
        }
        s.dh[i][rr] = ok ? ld2(dhs + bt * H + unit) : 0u;
        s.cp[i][rr] = ok && t > 0 ? ld2(cs + (bt - 1) * H + unit) : 0u;
      }
  };

  Stash cur, nxt;
  uint32_t ct[2][2];  // c_t of the current step
  load(cur, T - 1);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      ct[i][rr] = rv[rr] ? ld2(cs + (rbase[rr] + T - 1) * H + ubase + 8 * i)
                         : 0u;
    }

  float dh[2][4], dc[2][4], db[2][4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[i][e] = dc[i][e] = 0.0f;
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      db[i][gate][0] = db[i][gate][1] = 0.0f;
    }
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) load(nxt, t - 1);
    bf16* at = ab + (t & 1) * kRows * GS;
    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int unit = ubase + 8 * i;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float d[4][2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * rr + u;
            const uint32_t* gp = cur.gt[i][rr];
            const float ig = u ? hi(gp[0]) : lo(gp[0]);
            const float fg = u ? hi(gp[1]) : lo(gp[1]);
            const float gg = u ? hi(gp[2]) : lo(gp[2]);
            const float og = u ? hi(gp[3]) : lo(gp[3]);
            const float c_t = u ? hi(ct[i][rr]) : lo(ct[i][rr]);
            const float c_p = u ? hi(cur.cp[i][rr]) : lo(cur.cp[i][rr]);
            const float dhv =
                dh[i][e] + (u ? hi(cur.dh[i][rr]) : lo(cur.dh[i][rr]));
            const float th = tanhf(c_t);
            const float dO = dhv * th;
            const float dC = dhv * og * (1.0f - th * th) + dc[i][e];
            dc[i][e] = dC * fg;
            d[0][u] = dC * gg * ig * (1.0f - ig);
            d[1][u] = dC * c_p * fg * (1.0f - fg);
            d[2][u] = dC * ig * (1.0f - gg * gg);
            d[3][u] = dO * og * (1.0f - og);
          }
          const int r = g + 8 * rr;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) {
            db[i][gate][0] += d[gate][0];
            db[i][gate][1] += d[gate][1];
            const uint32_t p = pack(d[gate][0], d[gate][1]);
            *reinterpret_cast<uint32_t*>(at + r * GS + gate * H + unit) = p;
            if (rv[rr]) {
              *reinterpret_cast<uint32_t*>(
                  dpre + (rbase[rr] + t) * G + gate * H + unit) = p;
            }
          }
        }
      }
    }
    __syncthreads();
    if (t > 0) {
      if (active) {
        // dh_{t-1} = bf16(dpre_t) . Wh^T for units 16w .. 16w+15: even
        // and odd k-steps accumulate apart (four independent mma chains a
        // warp) and are added in a fixed order.
        float part[2][2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][c][e] = 0.0f;
        for (int k0 = 0; k0 < G; k0 += 32) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint32_t a[4], bf[4];
            ldsm_x4(a, a_addr(at, GS, 0, k0 + 16 * c, lane));
            ldsm_x4(bf, b_addr(whs, GS, 16 * warp, k0 + 16 * c, lane));
            mma(part[0][c], a, bf[0], bf[1]);
            mma(part[1][c], a, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[i][e] = part[i][0][e] + part[i][1][e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) ct[i][rr] = cur.cp[i][rr];
      cur = nxt;
    }
  }

  // db: the lanes of one column (g = 0..7) added by a fixed shuffle tree.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = db[i][gate][u];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (active && g == 0) {
          dbp[(size_t)blockIdx.x * G + gate * H + ubase + 8 * i + u] = v;
        }
      }
}

constexpr int WF = 64;   // wgrad output tile: features
constexpr int WJ = 128;  // wgrad output tile: gate columns
constexpr int WK = 32;   // rows of the B*T reduction a slab

// [dWx; dWh] partials of rows [split*chunk, (split+1)*chunk): features
// f0 .. f0+63 by gate columns j0 .. j0+127. Warp w: features 32 (w & 1) ..
// +31 (two m-tiles), columns 32 (w >> 1) .. +31 (four n-tiles).
__global__ void __launch_bounds__(kThreads)
lstm_bwd_wgrad_tc(const bf16* __restrict__ x,     // [N, E]
                  const bf16* __restrict__ hs,    // [N, H]
                  const bf16* __restrict__ dpre,  // [N, 4H]
                  float* __restrict__ partial,    // [splits, E+H, 4H]
                  long long N, long long chunk, int T, int E, int H) {
  constexpr int AS = WF + kPad, DS = WJ + kPad;
  __shared__ __align__(16) bf16 As[2][WK][AS];
  __shared__ __align__(16) bf16 Ds[2][WK][DS];
  const int G = 4 * H, F = E + H;
  const int j0 = blockIdx.x * WJ, f0 = blockIdx.y * WF;
  const long long n_begin = (long long)blockIdx.z * chunk;
  const long long n_end = min(N, n_begin + chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;

  // A slab: 32 rows x 64 features = 256 vectors, one a thread; D slab: 32
  // rows x 128 columns = 512 vectors, two a thread.
  const int ar = tid >> 3, ac = (tid & 7) * 8;
  auto load_a = [&](long long n0) -> uint4 {
    const long long n = n0 + ar;
    const int f = f0 + ac;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n < n_end) {
      if (f < E) {
        v = __ldg(reinterpret_cast<const uint4*>(x + n * E + f));
      } else if (f < F && n % T != 0) {
        v = __ldg(reinterpret_cast<const uint4*>(hs + (n - 1) * H + f - E));
      }
    }
    return v;
  };
  auto load_d = [&](long long n0, int k) -> uint4 {
    const int idx = tid + k * kThreads;
    const long long n = n0 + (idx >> 4);
    const int j = j0 + (idx & 15) * 8;
    return n < n_end && j < G
        ? __ldg(reinterpret_cast<const uint4*>(dpre + n * G + j))
        : make_uint4(0, 0, 0, 0);
  };
  auto store = [&](int buf, uint4 a, uint4 d0, uint4 d1) {
    *reinterpret_cast<uint4*>(&As[buf][ar][ac]) = a;
    const int i0 = tid, i1 = tid + kThreads;
    *reinterpret_cast<uint4*>(&Ds[buf][i0 >> 4][(i0 & 15) * 8]) = d0;
    *reinterpret_cast<uint4*>(&Ds[buf][i1 >> 4][(i1 & 15) * 8]) = d1;
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  if (n_begin < n_end) {
    store(0, load_a(n_begin), load_d(n_begin, 0), load_d(n_begin, 1));
  }
  __syncthreads();
  int buf = 0;
  for (long long n0 = n_begin; n0 < n_end; n0 += WK) {
    const long long nn = n0 + WK;
    uint4 ra = make_uint4(0, 0, 0, 0), rd0 = ra, rd1 = ra;
    if (nn < n_end) {
      ra = load_a(nn);
      rd0 = load_d(nn, 0);
      rd1 = load_d(nn, 1);
    }
#pragma unroll
    for (int k0 = 0; k0 < WK; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A^T from the [row][feature] slab: rows are the product's k.
        ldsm_x4_t(a[mi], &As[buf][k0 + (lane & 7) + 8 * (lane >> 4)]
                            [wm + 16 * mi + 8 * ((lane >> 3) & 1)]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, &Ds[buf][k0 + (lane & 7) + 8 * ((lane >> 3) & 1)]
                         [wn + 16 * np + 8 * (lane >> 4)]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * np], a[mi], bf[0], bf[1]);
          mma(acc[mi][2 * np + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
    if (nn < n_end) store(buf ^ 1, ra, rd0, rd1);
    __syncthreads();
    buf ^= 1;
  }

  float* out = partial + (size_t)blockIdx.z * F * G;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int f = f0 + wm + 16 * mi + g + 8 * rr;
        const int j = j0 + wn + 8 * ni + 2 * tq;
        if (f < F && j < G) {
          *reinterpret_cast<float2*>(out + (size_t)f * G + j) =
              make_float2(acc[mi][ni][2 * rr], acc[mi][ni][2 * rr + 1]);
        }
      }
}

constexpr int XR = 64;   // dx tile: rows
constexpr int XE = 64;   // dx tile: features
constexpr int XK = 64;   // gate columns a slab

// dx = bf16(dpre) . Wx^T for rows n0 .. n0+63 and features e0 .. e0+63.
// Warp w: rows 16 (w & 3) .. +15, features 32 (w >> 2) .. +31.
__global__ void __launch_bounds__(kThreads)
lstm_dx_tc(const bf16* __restrict__ dpre,  // [N, 4H]
           const bf16* __restrict__ wx,    // [E, 4H]
           bf16* __restrict__ dx,          // [N, E]
           long long N, int E, int H) {
  constexpr int PS = XK + kPad;
  __shared__ __align__(16) bf16 Ps[2][XR][PS];
  __shared__ __align__(16) bf16 Ws[2][XE][PS];
  const int G = 4 * H;
  const long long n0 = (long long)blockIdx.x * XR;
  const int e0 = blockIdx.y * XE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;

  // Each slab: 64 rows x 64 columns of each operand, 512 vectors: two a
  // thread of each.
  auto load = [&](int k0, uint4 (&p)[2], uint4 (&w)[2]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int idx = tid + k * kThreads;
      const int r = idx >> 3, c = (idx & 7) * 8;
      p[k] = n0 + r < N
          ? __ldg(reinterpret_cast<const uint4*>(dpre + (n0 + r) * G + k0 + c))
          : make_uint4(0, 0, 0, 0);
      w[k] = e0 + r < E
          ? __ldg(reinterpret_cast<const uint4*>(wx + (size_t)(e0 + r) * G +
                                                 k0 + c))
          : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&](int buf, const uint4 (&p)[2], const uint4 (&w)[2]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int idx = tid + k * kThreads;
      const int r = idx >> 3, c = (idx & 7) * 8;
      *reinterpret_cast<uint4*>(&Ps[buf][r][c]) = p[k];
      *reinterpret_cast<uint4*>(&Ws[buf][r][c]) = w[k];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.0f;

  uint4 p[2], w[2];
  load(0, p, w);
  store(0, p, w);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < G; k0 += XK) {
    const bool more = k0 + XK < G;
    if (more) load(k0 + XK, p, w);
#pragma unroll
    for (int kk = 0; kk < XK; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_addr(&Ps[buf][0][0], PS, wm, kk, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, b_addr(&Ws[buf][0][0], PS, wn + 16 * np, kk, lane));
        mma(acc[2 * np], a, bf[0], bf[1]);
        mma(acc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    if (more) store(buf ^ 1, p, w);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long n = n0 + wm + g + 8 * rr;
      const int e = e0 + wn + 8 * ni + 2 * tq;
      if (n < N && e < E) {
        *reinterpret_cast<uint32_t*>(dx + n * E + e) =
            pack(acc[ni][2 * rr], acc[ni][2 * rr + 1]);
      }
    }
}

// dWx, dWh: the chunks' partials summed in order; db: the recurrent
// blocks' partials summed in order. Rounded to bf16 once.
__global__ void lstm_wgrad_reduce_tc(const float* __restrict__ partial,
                                     const float* __restrict__ dbp,
                                     bf16* __restrict__ dwx,  // [E, 4H]
                                     bf16* __restrict__ dwh,  // [H, 4H]
                                     bf16* __restrict__ db,   // [4H]
                                     int splits, int tiles, int E, int H) {
  const int G = 4 * H, F = E + H;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (F + 1) * G) return;
  float sum = 0.0f;
  if (i < F * G) {
    for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * F * G + i];
  } else {
    for (int s = 0; s < tiles; ++s) sum += dbp[(size_t)s * G + i - F * G];
  }
  const int f = i / G, j = i - f * G;
  bf16* out = f < E ? dwx + (size_t)f * G : f < F ? dwh + (size_t)(f - E) * G
                                                  : db;
  out[j] = __float2bfloat16_rn(sum);
}

int rec_tc(const bf16* dhs, const bf16* cs, const bf16* gates,
           const bf16* wh, bf16* dpre, float* dbp, int B, int T, int H,
           void* stream) {
  if (!rec_width_ok(H) || B <= 0 || T <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = rec_smem(H);
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_rec_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRows - 1) / kRows;
  lstm_bwd_rec_tc<<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      dhs, cs, gates, wh, dpre, dbp, B, T, H);
  return (int)cudaGetLastError();
}

int wgrad_tc(const bf16* x, const bf16* hs, const bf16* wx, const bf16* dpre,
             const float* dbp, float* partial, bf16* dx, bf16* dwx,
             bf16* dwh, bf16* db, int B, int T, int E, int H, int splits,
             void* stream) {
  if (E <= 0 || E % 16 != 0 || !rec_width_ok(H) || B <= 0 || T <= 0 ||
      splits <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = (long long)B * T;
  const long long chunk = (N + splits - 1) / splits;  // an empty chunk: zeros
  const int G = 4 * H, F = E + H;
  lstm_bwd_wgrad_tc<<<dim3((G + WJ - 1) / WJ, (F + WF - 1) / WF, splits),
                      kThreads, 0, s>>>(x, hs, dpre, partial, N, chunk, T,
                                        E, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lstm_dx_tc<<<dim3((unsigned)((N + XR - 1) / XR), (E + XE - 1) / XE),
               kThreads, 0, s>>>(dpre, wx, dx, N, E, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int tiles = (B + kRows - 1) / kRows;
  lstm_wgrad_reduce_tc<<<((F + 1) * G + threads - 1) / threads, threads, 0,
                         s>>>(partial, dbp, dwx, dwh, db, splits, tiles, E,
                              H);
  return (int)cudaGetLastError();
}

}  // namespace

// The BPTT backward of lstm_fwd_stash_f32 (all f32, contiguous, on the
// device). wxt [4H, E] and wht [4H, H] are Wx and Wh transposed. dpre
// [B, T, 4H] and partial [splits, E+H+1, 4H] are f32 scratch the caller
// allocates; the B*T rows are cut into `splits` >= 1 chunks of
// ceil(B*T / splits) rows.
// Writes dx [B, T, E], dwx [E, 4H], dwh [H, 4H], db [4H]. Returns the
// cudaError_t of the launches (0 = launched).
extern "C" int lstm_bwd_f32(const float* dhs, const float* x, const float* hs,
                            const float* cs, const float* gates,
                            const float* wxt, const float* wht, float* dx,
                            float* dwx, float* dwh, float* db, float* dpre,
                            float* partial, int B, int T, int E, int H,
                            int splits, void* stream) {
  return bwd_f32(dhs, x, hs, cs, gates, wxt, wht, dx, dwx, dwh, db, dpre,
                 partial, B, T, E, H, splits, stream);
}

// The backward of lstm_fwd_stash_bf16, first half: the serial chain. Reads
// dhs, cs, gates [B, T, .] and Wh [H, 4H] (bf16); writes bf16(dpre) to the
// workspace dpre [B, T, 4H] (bf16) and one f32 db partial per 16-row tile
// to dbp [ceil(B / 16), 4H].
extern "C" int lstm_bwd_recurrent_bf16(
    const __nv_bfloat16* dhs, const __nv_bfloat16* cs,
    const __nv_bfloat16* gates, const __nv_bfloat16* wh,
    __nv_bfloat16* dpre, float* dbp, int B, int T, int H, void* stream) {
  return rec_tc(dhs, cs, gates, wh, dpre, dbp, B, T, H, stream);
}

// Second half: from the workspace and dbp, writes dx [B, T, E] and dwx
// [E, 4H], dwh [H, 4H], db [4H] (f32 sums rounded to bf16 once). partial
// [splits, E+H, 4H] is f32 scratch; the B*T rows are cut into `splits`
// chunks of ceil(B*T / splits) rows.
extern "C" int lstm_bwd_wgrad_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* hs,
    const __nv_bfloat16* wx, const __nv_bfloat16* dpre, const float* dbp,
    float* partial, __nv_bfloat16* dx, __nv_bfloat16* dwx,
    __nv_bfloat16* dwh, __nv_bfloat16* db, int B, int T, int E, int H,
    int splits, void* stream) {
  return wgrad_tc(x, hs, wx, dpre, dbp, partial, dx, dwx, dwh, db, B, T, E,
                  H, splits, stream);
}
