// Whole-sequence LSTM forward in one launch, f32 or bf16, for Hopper
// (sm_90a).
//
// Replaces: distkeras_tpu/ops/pallas/lstm.py:_fwd_kernel (pl.pallas_call in
// _run_fwd), both modes: stash=False, the inference forward lstm_seq runs
// (lstm_fwd_f32, lstm_fwd_bf16), and stash=True, the training forward that
// also writes the BPTT residuals cs and the activated gates
// (lstm_fwd_stash_f32, lstm_fwd_stash_bf16).
// Gate math is flax's OptimizedLSTMCell, gates packed i,f,g,o along 4H:
//   pre = b + x_t . Wx + h . Wh          [rows, 4H]
//   c'  = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h'  = sigmoid(o) * tanh(c'),  hs[:, t] = h'      (h0 = c0 = 0)
//
// What bounds it on this card: the T-step serial dependency, not bytes or
// FLOPs. Step t+1 needs all of h_t, so each step is one [rows, E+H] by
// [E+H, 4H] product followed by a block-wide barrier. At the serving shapes
// (E=64, H=128, T=200) the call is 2*T*B*(E+H)*4H FLOP (10.1 GFLOP at
// B=256, 0.04 GFLOP at B=1) and ~39 MB of x + hs at B=256: a few percent of
// a millisecond at the card's f32 rate and memory rate. What each step
// costs is the latency of every thread's 192 weight loads: the f32 weights
// (Wx + Wh = 384 KiB) do not fit in shared memory (227 KB per block), so
// they are re-read from L2 every step.
//
// What the design does about it. Batch rows are independent and only time
// is serial, so (unlike the TPU kernel, whose grid is the time axis and
// whose carry lives in revisited output blocks) one thread block owns R
// batch rows and loops over t inside the block:
//   * h and the staged x_t of its rows live in shared memory ([k][r], so a
//     thread reads a k's R values side by side), c lives in the registers
//     of the thread that owns the hidden unit;
//   * one thread per gate column j < 4H sums b[j] + x_t[r,:].Wx[:,j] +
//     h[r,:].Wh[:,j] for its rows; the loops are unrolled 32 deep so 32
//     independent L2 loads (coalesced across j, row-major weights) are in
//     flight per thread, which is what the step latency is made of;
//   * a barrier, then H threads combine i,f,g,o, update c, write h to shared
//     memory and to hs, and stage x_{t+1}; a second barrier ends the step.
// R is 1 up to 128 rows (one block per row, at most one block per SM on
// the 132 SMs) and 2 above (half the blocks and half the L2 weight
// traffic, at the price of R FMAs per weight load). Tuning R and the
// unroll depth, keeping the weights resident on chip (bf16 in shared
// memory, or split over a thread-block cluster) and tensor cores are later
// work.
//
// Stash mode (the STASH template flag): the thread that owns hidden unit k
// already holds c and the four activated gates in registers, so it also
// writes cs[b,t,k] and gates[b,t,{0,1,2,3}*H+k] (i,f,g,o). The layout stays
// batch-major [B,T,.]; csrc/lstm_bwd.cu is the only reader. The extra
// stores are 5H floats a row a step against hs's H, so the stash call moves
// about 6x the output bytes of the plain call but does the same FLOPs.
//
// bf16 (the storage type S, one template, as the TPU kernel runs one body
// for both): x, Wx, Wh and b are bf16 and are converted to f32 as they are
// loaded (a product of two bf16 values is exact in f32, and the sums are
// f32). The h/c carry stays f32; h is rounded to bf16 (round to nearest
// even) where it enters the recurrent product, as the TPU kernel casts h to
// Wh's dtype (ops/pallas/lstm.py:67), so shared memory holds the rounded
// h. hs, cs and gates are stored in bf16 (:80-83). The step's time is the
// same chain of L2 loads at half the bytes.
//
// Ragged batches: the last block masks rows >= B (no padding copy).
// Precise expf/tanhf; build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;  // one thread per gate column: 4H <= 512

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Storage <-> f32. f32 is stored as it is; bf16 is widened exactly on load
// and rounded to nearest even on store. round_to<S> is the value a store
// to S and a load back would give.
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

template <typename S, int R, bool STASH>
__global__ void __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const S* __restrict__ x,   // [B, T, E]
                const S* __restrict__ wx,  // [E, 4H]
                const S* __restrict__ wh,  // [H, 4H]
                const S* __restrict__ b,   // [4H]
                S* __restrict__ hs,        // [B, T, H]
                S* __restrict__ cs,        // [B, T, H]   (STASH only)
                S* __restrict__ gates,     // [B, T, 4H]  (STASH only)
                int B, int T, int E, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* xs = smem;          // [E][R]  x_t of this block's rows
  float* hsm = xs + E * R;   // [H][R]  h_{t-1}, rounded to S
  float* gsm = hsm + H * R;  // [R][G]  gate pre-activations

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);

  for (int i = tid; i < H * R; i += blockDim.x) hsm[i] = 0.0f;
  for (int i = tid; i < R * E; i += blockDim.x) {
    const int r = i / E;
    const int e = i - r * E;
    xs[e * R + r] =
        r < rows ? load_f(x[(size_t)(row0 + r) * T * E + e]) : 0.0f;
  }
  float c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = 0.0f;
  const float bj = tid < G ? load_f(b[tid]) : 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (tid < G) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = bj;
#pragma unroll 32
      for (int e = 0; e < E; ++e) {
        const float w = load_f(wx[(size_t)e * G + tid]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(xs[e * R + r], w, acc[r]);
      }
#pragma unroll 32
      for (int k = 0; k < H; ++k) {
        const float w = load_f(wh[(size_t)k * G + tid]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(hsm[k * R + r], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) gsm[r * G + tid] = acc[r];
    }
    __syncthreads();

    if (tid < H) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          const float* g = gsm + r * G;
          const float ig = sigmoid_f(g[tid]);
          const float fg = sigmoid_f(g[H + tid]);
          const float gg = tanhf(g[2 * H + tid]);
          const float og = sigmoid_f(g[3 * H + tid]);
          c[r] = fg * c[r] + ig * gg;
          const float h = og * tanhf(c[r]);
          const size_t bt = (size_t)(row0 + r) * T + t;
          hsm[tid * R + r] = round_to<S>(h);
          hs[bt * H + tid] = store_f<S>(h);
          if (STASH) {
            cs[bt * H + tid] = store_f<S>(c[r]);
            S* gt = gates + bt * G;
            gt[tid] = store_f<S>(ig);
            gt[H + tid] = store_f<S>(fg);
            gt[2 * H + tid] = store_f<S>(gg);
            gt[3 * H + tid] = store_f<S>(og);
          }
        }
      }
    }
    if (t + 1 < T) {
      for (int i = tid; i < R * E; i += blockDim.x) {
        const int r = i / E;
        const int e = i - r * E;
        xs[e * R + r] =
            r < rows ? load_f(x[((size_t)(row0 + r) * T + t + 1) * E + e])
                     : 0.0f;
      }
    }
    __syncthreads();
  }
}

template <typename S, int R, bool STASH>
int launch(const S* x, const S* wx, const S* wh, const S* b, S* hs, S* cs,
           S* gates, int B, int T, int E, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)R * (E + H + 4 * H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_fwd_kernel<S, R, STASH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (4 * H + 31) / 32 * 32;
  const int grid = (B + R - 1) / R;
  lstm_fwd_kernel<S, R, STASH><<<grid, threads, smem, stream>>>(
      x, wx, wh, b, hs, cs, gates, B, T, E, H);
  return (int)cudaGetLastError();
}

template <typename S, bool STASH>
int dispatch(const S* x, const S* wx, const S* wh, const S* b, S* hs, S* cs,
             S* gates, int B, int T, int E, int H, void* stream) {
  if (E <= 0 || H <= 0 || 4 * H > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 128) {
    return launch<S, 1, STASH>(x, wx, wh, b, hs, cs, gates, B, T, E, H, s);
  }
  return launch<S, 2, STASH>(x, wx, wh, b, hs, cs, gates, B, T, E, H, s);
}

}  // namespace

// hs[B, T, H] = LSTM over x[B, T, E] (all f32, contiguous, on the device).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int lstm_fwd_f32(const float* x, const float* wx, const float* wh,
                            const float* b, float* hs, int B, int T, int E,
                            int H, void* stream) {
  return dispatch<float, false>(x, wx, wh, b, hs, nullptr, nullptr, B, T, E,
                                H, stream);
}

// The same, also writing the BPTT residuals: cs[B, T, H] (cell states) and
// gates[B, T, 4H] (activated i, f, g, o).
extern "C" int lstm_fwd_stash_f32(const float* x, const float* wx,
                                  const float* wh, const float* b, float* hs,
                                  float* cs, float* gates, int B, int T,
                                  int E, int H, void* stream) {
  return dispatch<float, true>(x, wx, wh, b, hs, cs, gates, B, T, E, H,
                               stream);
}

// The bf16 instantiations: every tensor bf16 (f32 sums and carry inside).
extern "C" int lstm_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wx,
                             const __nv_bfloat16* wh, const __nv_bfloat16* b,
                             __nv_bfloat16* hs, int B, int T, int E, int H,
                             void* stream) {
  return dispatch<__nv_bfloat16, false>(x, wx, wh, b, hs, nullptr, nullptr,
                                        B, T, E, H, stream);
}

extern "C" int lstm_fwd_stash_bf16(const __nv_bfloat16* x,
                                   const __nv_bfloat16* wx,
                                   const __nv_bfloat16* wh,
                                   const __nv_bfloat16* b, __nv_bfloat16* hs,
                                   __nv_bfloat16* cs, __nv_bfloat16* gates,
                                   int B, int T, int E, int H, void* stream) {
  return dispatch<__nv_bfloat16, true>(x, wx, wh, b, hs, cs, gates, B, T, E,
                                       H, stream);
}
