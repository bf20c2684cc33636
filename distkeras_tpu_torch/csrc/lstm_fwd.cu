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
// The two dtypes have two bodies.
//
// What bounds it on this card: the T-step serial dependency, not bytes or
// FLOPs. Step t+1 needs all of h_t, so each step is one [rows, E+H] by
// [E+H, 4H] product, the gate epilogue and a barrier. At config #4's
// widths (E=64, H=128, T=200) the call is 2*T*B*(E+H)*4H FLOP (80.5 GFLOP
// at B=2048) and a few hundred MB at most: well under a millisecond at the
// card's rates. A step costs the latency of its product, its epilogue
// (three exponentials, three divisions and two tanh a cell, B*H cells a
// step over the SMs in use) and its barrier.
//
// bf16 (lstm_fwd_bf16, lstm_fwd_stash_bf16: the tensor-core body). Batch
// rows are independent and only time is serial, so one block of 16 warps
// owns a 16-row batch tile (the mma.sync M) and loops over t itself; at
// B = 2048 that is 128 blocks, one wave on the 132 SMs. What it does
// about the per-step latency:
//   * Resident weights. All of [Wx; Wh] in bf16 (192 KB at E=64, H=128)
//     sits in the block's shared memory for all T steps, loaded once from
//     a layout copy the wrapper makes (ops/kernels/lstm.py
//     fwd_weight_layout): [4H][E+H], k contiguous (mma's B operand read by
//     ldmatrix), rows padded by 16 bytes so the eight rows of an ldmatrix
//     hit distinct banks.
//   * Gate products on tensor cores: mma.sync m16n8k16, A = [x_t | h_{t-1}]
//     (bf16 in shared memory), f32 accumulators in registers. Warp w owns
//     hidden units 8w .. 8w+7: 16 warps read faster on the H100 than 8
//     warps of 16 units (PERF.md), the epilogue's dependent exponentials
//     wanting the extra warps.
//   * Gate columns permuted in the layout copy: block column q*32 + gate*8
//     + u holds gate `gate` of unit 8q+u. The four n-tiles of group q then
//     put i, f, g and o of the same (row, unit) into the same lane's
//     accumulators, so the epilogue runs in registers and the
//     pre-activations never go through shared memory.
//   * One barrier a step. h is written to a double-buffered tile and x_{t+1}
//     is read into registers at the start of step t (its latency hidden by
//     the step) and stored into the other x buffer before the barrier; hs
//     (and cs, gates) leave as 4-byte stores from registers, off the chain.
// What was hard: keeping a cell's four gates in one lane (the permutation
// above) without a shared-memory round trip, and keeping every buffer a
// barrier apart from its next writer with a single barrier a step (the
// step writes h_t and x_{t+1} into the buffers that held h_{t-2} and
// x_{t-1}, which the previous step's product read before its barrier).
// The same design with a thread-block cluster over the hidden units (each
// block a quarter of the weights and a 64-row tile, h all-gathered through
// distributed shared memory) does the same work a step on each SM and adds
// a cluster barrier; it was not built.
// Rounding points (the TPU kernel's, ops/pallas/lstm.py:64-83): products of
// bf16 values summed in f32, the bias added in f32, the h/c carry f32, h
// rounded to bf16 where it enters the recurrent product (and stored so in
// hs), cs and gates stored in bf16. Widths: E and H multiples of 16, E <=
// 128, H <= 128, and the weights and tiles within 227 KB of shared memory
// (fwd_smem_bytes); the wrapper raises on others.
//
// f32 (lstm_fwd_f32, lstm_fwd_stash_f32: the scalar body, simple and right
// first). The f32 weights (384 KiB) do not fit in shared memory and the
// tensor cores would not keep f32's 1e-5 limit, so one thread per gate
// column j < 4H sums b[j] + x_t[r,:].Wx[:,j] + h[r,:].Wh[:,j] for the
// block's R rows from L2 (unrolled 32 deep, so 32 independent loads are in
// flight), a barrier, then H threads combine i,f,g,o, update c (in their
// registers), write h to shared memory and to hs, and stage x_{t+1}; a
// second barrier ends the step. R is 1 up to 128 rows and 2 above. In
// stash mode the thread that owns unit k also writes cs and the four
// activated gates.
//
// Ragged batches: rows >= B are masked (no padding copy). Precise
// expf/tanhf; build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxThreads = 512;  // f32: one thread per gate column

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <int R, bool STASH>
__global__ void __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const float* __restrict__ x,   // [B, T, E]
                const float* __restrict__ wx,  // [E, 4H]
                const float* __restrict__ wh,  // [H, 4H]
                const float* __restrict__ b,   // [4H]
                float* __restrict__ hs,        // [B, T, H]
                float* __restrict__ cs,        // [B, T, H]   (STASH only)
                float* __restrict__ gates,     // [B, T, 4H]  (STASH only)
                int B, int T, int E, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* xs = smem;          // [E][R]  x_t of this block's rows
  float* hsm = xs + E * R;   // [H][R]  h_{t-1}
  float* gsm = hsm + H * R;  // [R][G]  gate pre-activations

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);

  for (int i = tid; i < H * R; i += blockDim.x) hsm[i] = 0.0f;
  for (int i = tid; i < R * E; i += blockDim.x) {
    const int r = i / E;
    const int e = i - r * E;
    xs[e * R + r] = r < rows ? x[(size_t)(row0 + r) * T * E + e] : 0.0f;
  }
  float c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = 0.0f;
  const float bj = tid < G ? b[tid] : 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (tid < G) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = bj;
#pragma unroll 32
      for (int e = 0; e < E; ++e) {
        const float w = wx[(size_t)e * G + tid];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(xs[e * R + r], w, acc[r]);
      }
#pragma unroll 32
      for (int k = 0; k < H; ++k) {
        const float w = wh[(size_t)k * G + tid];
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
          hsm[tid * R + r] = h;
          hs[bt * H + tid] = h;
          if (STASH) {
            cs[bt * H + tid] = c[r];
            float* gt = gates + bt * G;
            gt[tid] = ig;
            gt[H + tid] = fg;
            gt[2 * H + tid] = gg;
            gt[3 * H + tid] = og;
          }
        }
      }
    }
    if (t + 1 < T) {
      for (int i = tid; i < R * E; i += blockDim.x) {
        const int r = i / E;
        const int e = i - r * E;
        xs[e * R + r] =
            r < rows ? x[((size_t)(row0 + r) * T + t + 1) * E + e] : 0.0f;
      }
    }
    __syncthreads();
  }
}

template <int R, bool STASH>
int launch(const float* x, const float* wx, const float* wh, const float* b,
           float* hs, float* cs, float* gates, int B, int T, int E, int H,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)R * (E + H + 4 * H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_fwd_kernel<R, STASH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (4 * H + 31) / 32 * 32;
  const int grid = (B + R - 1) / R;
  lstm_fwd_kernel<R, STASH><<<grid, threads, smem, stream>>>(
      x, wx, wh, b, hs, cs, gates, B, T, E, H);
  return (int)cudaGetLastError();
}

template <bool STASH>
int dispatch(const float* x, const float* wx, const float* wh,
             const float* b, float* hs, float* cs, float* gates, int B,
             int T, int E, int H, void* stream) {
  if (E <= 0 || H <= 0 || 4 * H > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 128) {
    return launch<1, STASH>(x, wx, wh, b, hs, cs, gates, B, T, E, H, s);
  }
  return launch<2, STASH>(x, wx, wh, b, hs, cs, gates, B, T, E, H, s);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, weights resident in shared memory.

using namespace mma_bf16;

constexpr int kRows = 16;         // batch rows a block: the mma M
constexpr int kWarps = 16;        // warp w owns hidden units 8w .. 8w+7
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;           // bf16 of padding a shared-memory row
constexpr int kMaxSmem = 232448;  // shared memory a block may use

// Shared memory of the bf16 body: the weights [4H][E+H+8], two x tiles
// [16][E+8] and two h tiles [16][H+8], bf16. Mirrored by
// ops/kernels/lstm.py fwd_smem_bytes.
size_t fwd_smem(int E, int H) {
  return sizeof(bf16) * ((size_t)4 * H * (E + H + kPad) +
                         2 * kRows * (E + kPad) + 2 * kRows * (H + kPad));
}

// The widths the bf16 body takes: E <= 128 (x_t of the tile is at most
// 256 16-byte vectors, one a thread), 8 hidden units a warp (H <= 128),
// k-tiles of 16 that do not straddle x and h.
bool fwd_widths_ok(int E, int H) {
  return E > 0 && H > 0 && E % 16 == 0 && H % 16 == 0 && E <= 128 &&
         H <= 8 * kWarps && fwd_smem(E, H) <= (size_t)kMaxSmem;
}

template <bool STASH>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_tc(const bf16* __restrict__ x,   // [B, T, E]
            const bf16* __restrict__ wt,  // [4H, E+H], gate columns permuted
            const bf16* __restrict__ b,   // [4H]
            bf16* __restrict__ hs,        // [B, T, H]
            bf16* __restrict__ cs,        // [B, T, H]   (STASH only)
            bf16* __restrict__ gates,     // [B, T, 4H]  (STASH only)
            int B, int T, int E, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H, K = E + H;
  const int KS = K + kPad, XS = E + kPad, HS = H + kPad;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [G][KS]
  bf16* xs = ws + (size_t)G * KS;                // [2][kRows][XS]
  bf16* hb = xs + 2 * kRows * XS;                // [2][kRows][HS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const bool active = warp < H / 8;  // owns unit group w

  const int kv = K / 8;
  for (int i = tid; i < G * kv; i += kThreads) {
    const int n = i / kv, c = i - n * kv;
    *reinterpret_cast<uint4*>(ws + (size_t)n * KS + c * 8) =
        *reinterpret_cast<const uint4*>(wt + (size_t)n * K + c * 8);
  }
  for (int i = tid; i < 2 * kRows * HS; i += kThreads) {
    hb[i] = __float2bfloat16_rn(0.0f);  // h_{-1} = 0
  }
  // x_t of the tile: thread tid moves one 16-byte vector (row xr, columns
  // 8 xc ..); rows >= B stay zero.
  const int xv = E / 8;
  const int xr = tid / xv, xc = tid - xr * xv;
  const bool xmine = tid < kRows * xv;
  const bool xload = xmine && row0 + xr < B;
  const bf16* xp = xload ? x + (size_t)(row0 + xr) * T * E + xc * 8 : x;
  uint4 xreg = make_uint4(0, 0, 0, 0);
  if (xload) xreg = *reinterpret_cast<const uint4*>(xp);
  if (xmine) *reinterpret_cast<uint4*>(xs + xr * XS + xc * 8) = xreg;

  // Lane (g, tq) of warp w holds the cells e = 2 rr + u of unit group w:
  // row g + 8 rr, unit 8w + 2tq + u.
  const int unit = 8 * warp + 2 * tq;
  float bv[4][2], c[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      bv[gate][u] = active ? __bfloat162float(b[gate * H + unit + u]) : 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const bool more = t + 1 < T;
    if (more && xload) {
      xreg = *reinterpret_cast<const uint4*>(xp + (size_t)(t + 1) * E);
    }
    if (active) {
      float acc[4][4];  // [gate][e]
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
      const bf16* xa = xs + (t & 1) * kRows * XS;        // x_t
      const bf16* ha = hb + ((t + 1) & 1) * kRows * HS;  // h_{t-1}
      for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t a[4];
        ldsm_x4(a, k0 < E ? a_addr(xa, XS, 0, k0, lane)
                          : a_addr(ha, HS, 0, k0 - E, lane));
#pragma unroll
        for (int gp = 0; gp < 2; ++gp) {  // gates (i, f), then (g, o)
          uint32_t bf[4];
          ldsm_x4(bf, b_addr(ws, KS, warp * 32 + gp * 16, k0, lane));
          mma(acc[2 * gp], a, bf[0], bf[1]);
          mma(acc[2 * gp + 1], a, bf[2], bf[3]);
        }
      }
      float act[4][4], h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e & 1;
        act[0][e] = sigmoid_f(acc[0][e] + bv[0][u]);
        act[1][e] = sigmoid_f(acc[1][e] + bv[1][u]);
        act[2][e] = tanhf(acc[2][e] + bv[2][u]);
        act[3][e] = sigmoid_f(acc[3][e] + bv[3][u]);
        c[e] = act[1][e] * c[e] + act[0][e] * act[2][e];
        h[e] = act[3][e] * tanhf(c[e]);
      }
      bf16* hn = hb + (t & 1) * kRows * HS;  // h_t
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = g + 8 * rr;
        const uint32_t hp = pack(h[2 * rr], h[2 * rr + 1]);
        *reinterpret_cast<uint32_t*>(hn + r * HS + unit) = hp;
        if (row0 + r < B) {
          const size_t bt = (size_t)(row0 + r) * T + t;
          *reinterpret_cast<uint32_t*>(hs + bt * H + unit) = hp;
          if (STASH) {
            *reinterpret_cast<uint32_t*>(cs + bt * H + unit) =
                pack(c[2 * rr], c[2 * rr + 1]);
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
              *reinterpret_cast<uint32_t*>(gates + bt * G + gate * H +
                                           unit) =
                  pack(act[gate][2 * rr], act[gate][2 * rr + 1]);
            }
          }
        }
      }
    }
    if (more && xmine) {
      *reinterpret_cast<uint4*>(xs + ((t + 1) & 1) * kRows * XS + xr * XS +
                                xc * 8) = xreg;
    }
    __syncthreads();
  }
}

template <bool STASH>
int dispatch_tc(const bf16* x, const bf16* wt, const bf16* b, bf16* hs,
                bf16* cs, bf16* gates, int B, int T, int E, int H,
                void* stream) {
  if (!fwd_widths_ok(E, H)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  const size_t smem = fwd_smem(E, H);
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_tc<STASH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRows - 1) / kRows;
  lstm_fwd_tc<STASH><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, wt, b, hs, cs, gates, B, T, E, H);
  return (int)cudaGetLastError();
}

}  // namespace

// hs[B, T, H] = LSTM over x[B, T, E] (all f32, contiguous, on the device).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int lstm_fwd_f32(const float* x, const float* wx, const float* wh,
                            const float* b, float* hs, int B, int T, int E,
                            int H, void* stream) {
  return dispatch<false>(x, wx, wh, b, hs, nullptr, nullptr, B, T, E, H,
                         stream);
}

// The same, also writing the BPTT residuals: cs[B, T, H] (cell states) and
// gates[B, T, 4H] (activated i, f, g, o).
extern "C" int lstm_fwd_stash_f32(const float* x, const float* wx,
                                  const float* wh, const float* b, float* hs,
                                  float* cs, float* gates, int B, int T,
                                  int E, int H, void* stream) {
  return dispatch<true>(x, wx, wh, b, hs, cs, gates, B, T, E, H, stream);
}

// The bf16 forward: every tensor bf16 (f32 sums and carry inside). wt is
// [Wx; Wh] in the layout of ops/kernels/lstm.py fwd_weight_layout: [4H,
// E+H], row q*32 + gate*8 + u holding gate `gate` of unit 8q + u.
extern "C" int lstm_fwd_bf16(const __nv_bfloat16* x,
                             const __nv_bfloat16* wt,
                             const __nv_bfloat16* b, __nv_bfloat16* hs,
                             int B, int T, int E, int H, void* stream) {
  return dispatch_tc<false>(x, wt, b, hs, nullptr, nullptr, B, T, E, H,
                            stream);
}

extern "C" int lstm_fwd_stash_bf16(const __nv_bfloat16* x,
                                   const __nv_bfloat16* wt,
                                   const __nv_bfloat16* b,
                                   __nv_bfloat16* hs, __nv_bfloat16* cs,
                                   __nv_bfloat16* gates, int B, int T,
                                   int E, int H, void* stream) {
  return dispatch_tc<true>(x, wt, b, hs, cs, gates, B, T, E, H, stream);
}
