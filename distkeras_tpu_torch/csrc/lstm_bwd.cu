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
// T=200, E=64, H=128; 2.40 ms at the f32 rate) against 1.68 GB of inputs and
// outputs (0.50 ms at 3.35 TB/s): operations, on paper. Half of those FLOPs
// (dx and dh) sit on the T-step serial chain, as in the forward; the other
// half (dWx, dWh) has no serial dependency at all.
//
// What the design does about it. The TPU kernel's grid is the time axis,
// run in order, with dWx/dWh/db accumulated in output blocks that stay
// resident across the grid. Hopper's blocks run in no order, so the work is
// split by what is serial and what is not:
//
// 1. lstm_bwd_recurrent: one block owns R batch rows and walks t itself
//    (the forward kernel's layout). dc lives in the registers of the thread
//    that owns hidden unit k; dh_carry and this step's dpre [4H][R] live in
//    shared memory. Each step: H threads build dpre from the stashed gates
//    and cell states, then E+H output columns (dx_t and dh_{t-1}) are each
//    summed over the 4H gate columns in KSPLIT parts by separate threads
//    (so all 4H threads load weights), and a fixed-order pass adds the parts.
//    The weights come pre-transposed (WxT [4H,E], WhT [4H,H], a layout copy
//    the wrapper makes once per call), so the threads of a warp read
//    neighbouring addresses; they stay in L2 across steps. dpre for every
//    (b, t) goes to a workspace [B,T,4H] that the wrapper allocates.
// 2. lstm_wgrad_partial: [dWx; dWh; db] = A^T . dpre over the B*T rows, with
//    A[n] = [x[n], h_{t-1}[n], 1] (h_{-1} = 0). A tiled product (64x64
//    output tiles, 16-row k-slabs in shared memory, 4x4 outputs a thread)
//    split over the rows into `splits` chunks, each written as a partial.
// 3. lstm_wgrad_reduce: one thread per output sums the partials in chunk
//    order. No float atomics anywhere, so two calls give the same bits.
//
// bf16 (lstm_bwd_bf16; the storage type S of one templated body): the
// stash, dhs, x, WxT and WhT are bf16 and widen exactly on load; the dh
// and dc carries, dpre and every sum are f32. The TPU kernel rounds dpre to
// bf16 for all four products (ops/pallas/lstm.py:127-142) and sums db from
// the unrounded f32 dpre (:143), so here:
//   * the recurrent kernel rounds this step's dpre to bf16 in shared memory
//     (dx_t and the dh carry are sums over it), stores dx in bf16 and keeps
//     the dh carry f32, as the TPU kernel's dh_ref is;
//   * the workspace keeps the f32 dpre; the weight-gradient kernel rounds it
//     to bf16 as it loads a slab for dWx and dWh, and sums the bias row from
//     the unrounded values;
//   * dWx, dWh and db are f32 sums, rounded to bf16 once at the end: the
//     weights' dtype (:262-263).
//
// Ragged B: the last recurrent block masks rows >= B, which never reach the
// workspace, and the weight-gradient kernels only read rows < B*T.
// Simple and right first; tensor cores, weights resident in shared memory
// and fusing the reduction into the recurrent kernel are later work.
// Precise expf/tanhf; build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;  // one thread per gate column: 4H <= 512
constexpr int KSPLIT = 2;         // parts each dx/dh output sum is cut into

// Storage <-> f32, as in csrc/lstm_fwd.cu: bf16 widens exactly on load and
// rounds to nearest even on store; round_to<S> is a store and a load back.
__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename S>
__device__ __forceinline__ S store_f(float v);
template <>
__device__ __forceinline__ float store_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename S>
__device__ __forceinline__ float round_to(float v) {
  return load_f(store_f<S>(v));
}

template <typename S, int R>
__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_recurrent(const S* __restrict__ dhs,    // [B, T, H]
                   const S* __restrict__ cs,     // [B, T, H]
                   const S* __restrict__ gates,  // [B, T, 4H]
                   const S* __restrict__ wxt,    // [4H, E]
                   const S* __restrict__ wht,    // [4H, H]
                   S* __restrict__ dx,           // [B, T, E]
                   float* __restrict__ dpre,     // [B, T, 4H] workspace, f32
                   int B, int T, int E, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int NO = E + H;                 // outputs per row: dx_t, dh_{t-1}
  float* dps = smem;                    // [G][R]  this step's dpre, in S
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
          const S* gt = gates + bt * G;
          const float ig = load_f(gt[tid]);
          const float fg = load_f(gt[H + tid]);
          const float gg = load_f(gt[2 * H + tid]);
          const float og = load_f(gt[3 * H + tid]);
          const float ct = load_f(cs[bt * H + tid]);
          const float cp = t > 0 ? load_f(cs[(bt - 1) * H + tid]) : 0.0f;
          const float dh = dhc[tid * R + r] + load_f(dhs[bt * H + tid]);
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
        dps[tid * R + r] = round_to<S>(d0);
        dps[(H + tid) * R + r] = round_to<S>(d1);
        dps[(2 * H + tid) * R + r] = round_to<S>(d2);
        dps[(3 * H + tid) * R + r] = round_to<S>(d3);
      }
    }
    __syncthreads();

    // dx_t[r, e] = sum_j dpre[r, j] Wx[e, j];  dh_{t-1}[r, k] likewise with
    // Wh. Work item w = (part, o): output o's sum over gate columns
    // [part*JS, (part+1)*JS).
    for (int w = tid; w < KSPLIT * NO; w += blockDim.x) {
      const int p = w / NO;
      const int o = w - p * NO;
      const S* wt = o < E ? wxt + o : wht + (o - E);
      const int ld = o < E ? E : H;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      const int j0 = p * JS;
#pragma unroll 32
      for (int j = j0; j < j0 + JS; ++j) {
        const float wv = load_f(wt[(size_t)j * ld]);
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
        if (r < rows) {
          dx[((size_t)(row0 + r) * T + t) * E + o] = store_f<S>(sum);
        }
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
template <typename S>
__device__ __forceinline__ float feature(const S* __restrict__ x,
                                         const S* __restrict__ hs,
                                         long long n, int f, int T, int E,
                                         int H) {
  if (f < E) return load_f(x[n * E + f]);
  if (f < E + H) {
    return (n % T) != 0 ? load_f(hs[(n - 1) * H + (f - E)]) : 0.0f;
  }
  return f == E + H ? 1.0f : 0.0f;
}

// dpre enters dWx and dWh rounded to S and db as it is (f32): Ds holds the
// rounded slab, and Db the unrounded one in the block that holds the bias
// feature (for f32 the two are equal and Ds serves both).
template <typename S>
__global__ void __launch_bounds__(kWgThreads)
lstm_wgrad_partial(const S* __restrict__ x,          // [N, E]
                   const S* __restrict__ hs,         // [N, H]
                   const float* __restrict__ dpre,   // [N, 4H]
                   float* __restrict__ partial,      // [splits, F, 4H]
                   long long N, long long chunk, int T, int E, int H) {
  constexpr bool kRound = sizeof(S) < sizeof(float);
  __shared__ float As[TK][TF];
  __shared__ float Ds[TK][TJ];
  __shared__ float Db[kRound ? TK : 1][TJ];
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
  // Whether this block's feature tile holds the bias feature E+H, and
  // which of this thread's four features it is (-1: none).
  const bool bias_tile = kRound && f0 <= E + H && E + H < f0 + TF;
  const int bias_p = E + H - (f0 + ty * 4);
  const int my_bias = bias_tile && bias_p >= 0 && bias_p < 4 ? bias_p : -1;

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
      As[kk][ff] = n < n_end ? feature<S>(x, hs, n, f0 + ff, T, E, H) : 0.0f;
    }
    for (int i = tid; i < TK * TJ; i += kWgThreads) {
      const int kk = i / TJ;
      const int jj = i - kk * TJ;
      const long long n = n0 + kk;
      const float d =
          (n < n_end && j0 + jj < G) ? dpre[n * G + j0 + jj] : 0.0f;
      Ds[kk][jj] = round_to<S>(d);
      if (bias_tile) Db[kk][jj] = d;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], d[4], e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = As[kk][ty * 4 + q];
        d[q] = Ds[kk][tx * 4 + q];
        // the unrounded dpre, for this thread's bias feature (if any)
        e[q] = kRound && my_bias >= 0 ? Db[kk][tx * 4 + q] : d[q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[p][q] = fmaf(a[p], p == my_bias ? e[q] : d[q], acc[p][q]);
        }
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

// The f32 sums over the chunks, stored in S (rounded once, for bf16).
template <typename S>
__global__ void lstm_wgrad_reduce(const float* __restrict__ partial,
                                  S* __restrict__ dwx,   // [E, 4H]
                                  S* __restrict__ dwh,   // [H, 4H]
                                  S* __restrict__ db,    // [4H]
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
    dwx[f * G + j] = store_f<S>(sum);
  } else if (f < E + H) {
    dwh[(f - E) * G + j] = store_f<S>(sum);
  } else {
    db[j] = store_f<S>(sum);
  }
}

template <typename S, int R>
int launch_recurrent(const S* dhs, const S* cs, const S* gates, const S* wxt,
                     const S* wht, S* dx, float* dpre, int B, int T, int E,
                     int H, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)R * (4 * H + H + KSPLIT * (E + H));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_recurrent<S, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (4 * H + 31) / 32 * 32;
  const int grid = (B + R - 1) / R;
  lstm_bwd_recurrent<S, R><<<grid, threads, smem, stream>>>(
      dhs, cs, gates, wxt, wht, dx, dpre, B, T, E, H);
  return (int)cudaGetLastError();
}

template <typename S>
int bwd(const S* dhs, const S* x, const S* hs, const S* cs, const S* gates,
        const S* wxt, const S* wht, S* dx, S* dwx, S* dwh, S* db, float* dpre,
        float* partial, int B, int T, int E, int H, int splits,
        void* stream) {
  if (E <= 0 || H <= 0 || 4 * H > kMaxThreads || B <= 0 || T <= 0 ||
      splits <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long N = (long long)B * T;
  const long long chunk = (N + splits - 1) / splits;  // an empty chunk: zeros
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = B <= 128
      ? launch_recurrent<S, 1>(dhs, cs, gates, wxt, wht, dx, dpre, B, T, E,
                               H, s)
      : launch_recurrent<S, 2>(dhs, cs, gates, wxt, wht, dx, dpre, B, T, E,
                               H, s);
  if (rc != 0) return rc;
  const int G = 4 * H;
  const int F = E + H + 1;
  const dim3 grid((G + TJ - 1) / TJ, (F + TF - 1) / TF, splits);
  lstm_wgrad_partial<S><<<grid, kWgThreads, 0, s>>>(x, hs, dpre, partial, N,
                                                    chunk, T, E, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  lstm_wgrad_reduce<S><<<(F * G + threads - 1) / threads, threads, 0, s>>>(
      partial, dwx, dwh, db, splits, E, H);
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
  return bwd<float>(dhs, x, hs, cs, gates, wxt, wht, dx, dwx, dwh, db, dpre,
                    partial, B, T, E, H, splits, stream);
}

// The backward of lstm_fwd_stash_bf16: every tensor bf16 but the f32
// scratch dpre and partial; dwx, dwh and db are f32 sums rounded to bf16.
extern "C" int lstm_bwd_bf16(const __nv_bfloat16* dhs, const __nv_bfloat16* x,
                             const __nv_bfloat16* hs, const __nv_bfloat16* cs,
                             const __nv_bfloat16* gates,
                             const __nv_bfloat16* wxt,
                             const __nv_bfloat16* wht, __nv_bfloat16* dx,
                             __nv_bfloat16* dwx, __nv_bfloat16* dwh,
                             __nv_bfloat16* db, float* dpre, float* partial,
                             int B, int T, int E, int H, int splits,
                             void* stream) {
  return bwd<__nv_bfloat16>(dhs, x, hs, cs, gates, wxt, wht, dx, dwx, dwh, db,
                            dpre, partial, B, T, E, H, splits, stream);
}
