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
// at B=2048) and a few hundred MB at most. A step costs the latency of its
// product, its epilogue (three exponentials, three divisions and two tanh
// a cell) and its barrier.
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
// Rounding points (the TPU kernel's, ops/pallas/lstm.py:64-83): products of
// bf16 values summed in f32, the bias added in f32, the h/c carry f32, h
// rounded to bf16 where it enters the recurrent product (and stored so in
// hs), cs and gates stored in bf16. Widths: E and H multiples of 16, E <=
// 128, H <= 128, and the weights and tiles within 227 KB of shared memory
// (fwd_smem_bytes: config #4's E=64, H=128 takes 218,112 bytes).
//
// bf16, the xw body (lstm_fwd_xw_bf16, lstm_fwd_stash_xw_bf16), for the
// widths whose [Wx; Wh] does not fit (E=H=128, imdb_lstm()'s default,
// needs 287,744 bytes; any E > 128). Two launches, as the f32 body:
//   1. lstm_xproj_tc: x . Wx for every (b, t) as one mma.sync tile product
//      (128 x 128 tiles, bf16 operands, f32 sums) into an f32 scratch [B,
//      T, 4H], the columns in the recurrence's lane order (ops/kernels/
//      lstm.py xw_permutation: a lane's two units' four gates are eight
//      contiguous floats). pre stays f32: the TPU kernel's x . Wx is an
//      f32 dot_general (preferred_element_type=f32) added to h . Wh and
//      then to b in f32, never rounded to bf16.
//   2. lstm_fwd_xw_tc: lstm_fwd_tc's block, lanes and epilogue with the
//      product over h alone: Wh [4H][H+8] (147,968 bytes with the h tiles
//      at H=128) resident, x . Wx read from the scratch a step ahead
//      (two 16-byte loads a row, off the chain), the gate pre-activation
//      (x . Wx + h . Wh) + b in the TPU kernel's order.
// The body is chosen by width alone (ops/kernels/lstm.py bf16_fwd_body),
// never on a failure: resident wherever [Wx; Wh] fits, since the scratch
// costs a write and a read of 4H f32 a row (1.7 GB at config #4's B=2048,
// about 0.5 ms at 3.35 TB/s beside the resident body's 0.91 ms for the
// whole stash forward there; the two bodies timed there are in PERF.md).
//
// f32 (lstm_fwd_f32, lstm_fwd_stash_f32: the cluster body). f32 products
// stay on the FP32 pipes (FFMA, f32 in, f32 sums: the TPU kernel's
// arithmetic at f32; tensor cores would round to TF32). All of [Wx; Wh] in
// f32 is 384 KiB at E=64, H=128, more than a block's 227 KB. Two launches:
//   1. lstm_xproj_f32: pre = x . Wx + b for every (b, t), off the serial
//      chain, as one FFMA tile product (128 x 128 tiles, 8 x 8 a thread,
//      two blocks an SM) into an f32 scratch [B, T, H, 4]: a unit's four
//      gates side by side (the wrapper's column order, f32_xproj_layout).
//      The chain then carries only h . Wh, two thirds of the fused
//      product, and holds no x.
//   2. lstm_fwd_cluster: a thread-block cluster of C blocks owns a tile of
//      R batch rows; block c owns the hidden units [c U, (c+1) U), U = H /
//      C, and their four gate columns. Its Wh slice ([H][U][4] f32: 32 KiB
//      at C=8, 128 KiB at C=2) stays in its shared memory for all T steps
//      (f32_fwd_weight_layout). A thread owns one unit's four gates for RT
//      rows (2 at R=16, 4 at R=32): a 16-byte weight read and an 8- or
//      16-byte read of its rows' h feed 4 RT FFMAs, and the epilogue runs
//      in its registers. At R=16 the product is cut over k between two
//      thread groups where the threads allow (f32_fwd_ksplit): the second
//      adds its sums in through shared memory before the epilogue, one
//      block barrier a step (8 % off B=256 on the H100, PERF.md). Each step: the thread's pre (loaded a step ahead,
//      off the chain) plus h_{t-1} . Wh, the epilogue (precise
//      expf/tanhf), hs (and cs, gates) to memory, and h_t stored into the
//      other h tile [H][R] of every block of the cluster by st.async,
//      completing bytes on that block's mbarrier; a block waits on its
//      mbarrier for the whole of h_t before the next product. The data
//      dependency orders every write after the last read of its buffer
//      (csrc/lstm_f32.cuh), so a step needs no block or cluster barrier.
//   R and C come from the wrapper (ops/kernels/lstm.py f32_tiling, a plain
//   function): R=16, C=8 up to B=1024 (latency-bound serving: 16 x 64
//   gate columns x H FFMAs a block a step), R=32, C=2 above (config #4's
//   training batch: 64 clusters of two blocks, one wave; the card holds 66
//   at once, cudaOccupancyMaxActiveClusters). The tilings measured on the
//   H100 (R=64 with C=4: 30 clusters fit, two waves; more rows or units a
//   thread: slower) are in PERF.md. Clusters never wait on each other, so
//   a grid over one wave is right, only slower.
//   Exit rule: a block must not exit while a peer may still write into its
//   shared memory; the kernel ends with a cluster barrier.
// What was hard (f32): a step's latency, not its FLOPs, at every batch the
// path sees, hence x . Wx off the chain, h handed over with no barrier a
// step, and a training tiling whose clusters all fit the card at once
// (the variants measured are in PERF.md).
// Widths: E a multiple of 4 (16-byte x reads), H a multiple of 8 C (8
// units a warp), at most 512 threads a block (U R / RT) and the Wh slice
// and tiles within 227 KB (f32_fwd_smem); the wrapper raises on others
// (check_f32_widths).
//
// Ragged batches: rows >= B are masked (no padding copy). Precise
// expf/tanhf; build without --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_f32.cuh"
#include "mma_bf16.cuh"

namespace {

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
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

// ---------------------------------------------------------------------------
// bf16, the xw body: x . Wx off the serial chain as one tensor-core tile
// product into an f32 scratch, then the recurrence with only Wh resident.

constexpr int QM = 128, QN = 128, QK = 32;  // x . Wx tile: rows, columns, k
constexpr int QS = QK + kPad;               // a tile row in shared memory

// pre[n][p] = sum_e x[n][e] wxt[p][e] (f32 sums of bf16 products, no bias)
// for rows n0 .. n0+127 and columns p0 .. p0+127, the columns in the
// recurrence's lane order (ops/kernels/lstm.py xw_permutation). Warp w:
// rows 32 (w & 3) .. +31 (two m-tiles), columns 64 (w >> 2) .. +63 (eight
// n-tiles). k slabs of 32 double-buffered through registers; E a multiple
// of 16 (a slab's second half past E reads zeros).
__global__ void __launch_bounds__(256, 2)
lstm_xproj_tc(const bf16* __restrict__ x,    // [N, E]
              const bf16* __restrict__ wxt,  // [4H, E]
              float* __restrict__ pre,       // [N, 4H]
              long long N, int E, int G) {
  __shared__ __align__(16) bf16 As[2][QM][QS];
  __shared__ __align__(16) bf16 Bs[2][QN][QS];
  const long long n0 = (long long)blockIdx.x * QM;
  const int p0 = blockIdx.y * QN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  // Each slab: 128 rows x 32 k of each operand, 512 vectors: two a thread.
  auto load = [&](int k0, uint4 (&a)[2], uint4 (&w)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + 256 * i;
      const int r = idx >> 2, k = k0 + (idx & 3) * 8;
      a[i] = n0 + r < N && k < E
                 ? __ldg(reinterpret_cast<const uint4*>(x + (n0 + r) * E + k))
                 : make_uint4(0, 0, 0, 0);
      w[i] = p0 + r < G && k < E
                 ? __ldg(reinterpret_cast<const uint4*>(
                       wxt + (size_t)(p0 + r) * E + k))
                 : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&](int buf, const uint4 (&a)[2], const uint4 (&w)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + 256 * i;
      const int r = idx >> 2, k = (idx & 3) * 8;
      *reinterpret_cast<uint4*>(&As[buf][r][k]) = a[i];
      *reinterpret_cast<uint4*>(&Bs[buf][r][k]) = w[i];
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  uint4 a[2], w[2];
  load(0, a, w);
  store(0, a, w);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < E; k0 += QK) {
    const bool more = k0 + QK < E;
    if (more) load(k0 + QK, a, w);
#pragma unroll
    for (int kk = 0; kk < QK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldsm_x4(af[mi], a_addr(&As[buf][0][0], QS, wm + 16 * mi, kk, lane));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, b_addr(&Bs[buf][0][0], QS, wn + 16 * np, kk, lane));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    if (more) store(buf ^ 1, a, w);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const long long n = n0 + wm + 16 * mi + g + 8 * rr;
        const int p = p0 + wn + 8 * ni + 2 * tq;
        if (n < N && p < G) {
          *reinterpret_cast<float2*>(pre + n * G + p) =
              make_float2(acc[mi][ni][2 * rr], acc[mi][ni][2 * rr + 1]);
        }
      }
}

// Shared memory of the xw recurrence: Wh [4H][H+8] and two h tiles
// [16][H+8], bf16. Mirrored by ops/kernels/lstm.py xw_smem_bytes.
size_t xw_smem(int H) {
  return sizeof(bf16) * ((size_t)4 * H * (H + kPad) + 2 * kRows * (H + kPad));
}

bool xw_widths_ok(int E, int H) {
  return E > 0 && H > 0 && E % 16 == 0 && H % 16 == 0 && H <= 8 * kWarps &&
         xw_smem(H) <= (size_t)kMaxSmem;
}

// The recurrence of the xw body: lstm_fwd_tc's tiling, lanes and
// epilogue, with the product over h only (Wh resident, rows in the
// gate_permutation order) and x . Wx read from pre, a step ahead. Lane
// (g, tq) of warp w reads, for rows g and g + 8, the eight floats p = 32 w
// + 8 tq .. + 7 of its row: gates i, f, g, o of units 8w + 2tq and + 1.
// The gate pre-activation is (x . Wx + h . Wh) + b, the TPU kernel's order.
template <bool STASH>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_xw_tc(const float* __restrict__ pre,  // [B, T, 4H], xw order
               const bf16* __restrict__ wt,    // [4H, H], gate columns permuted
               const bf16* __restrict__ b,     // [4H]
               bf16* __restrict__ hs,          // [B, T, H]
               bf16* __restrict__ cs,          // [B, T, H]   (STASH only)
               bf16* __restrict__ gates,       // [B, T, 4H]  (STASH only)
               int B, int T, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H, HS = H + kPad;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [G][HS]
  bf16* hb = ws + (size_t)G * HS;                // [2][kRows][HS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const bool active = warp < H / 8;  // owns unit group w

  const int kv = H / 8;
  for (int i = tid; i < G * kv; i += kThreads) {
    const int n = i / kv, c = i - n * kv;
    *reinterpret_cast<uint4*>(ws + (size_t)n * HS + c * 8) =
        *reinterpret_cast<const uint4*>(wt + (size_t)n * H + c * 8);
  }
  for (int i = tid; i < 2 * kRows * HS; i += kThreads) {
    hb[i] = __float2bfloat16_rn(0.0f);  // h_{-1} = 0
  }

  const int unit = 8 * warp + 2 * tq;
  bool ok[2];
  const float* pp[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    ok[rr] = active && row0 + g + 8 * rr < B;
    pp[rr] = ok[rr] ? pre + (size_t)(row0 + g + 8 * rr) * T * G + 32 * warp +
                          8 * tq
                    : pre;
  }
  // xv[rr][0] = (i, i, f, f), xv[rr][1] = (g, g, o, o) of the lane's two
  // units in row g + 8 rr.
  float4 xv[2][2];
  auto load_pre = [&](int t) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      xv[rr][0] = ok[rr] ? __ldg(reinterpret_cast<const float4*>(
                               pp[rr] + (size_t)t * G))
                         : z;
      xv[rr][1] = ok[rr] ? __ldg(reinterpret_cast<const float4*>(
                               pp[rr] + (size_t)t * G + 4))
                         : z;
    }
  };
  float bv[4][2], c[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      bv[gate][u] = active ? __bfloat162float(b[gate * H + unit + u]) : 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = 0.0f;
  load_pre(0);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float xw[4][4];  // [gate][e], e = 2 rr + u
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      xw[0][2 * rr] = xv[rr][0].x;
      xw[0][2 * rr + 1] = xv[rr][0].y;
      xw[1][2 * rr] = xv[rr][0].z;
      xw[1][2 * rr + 1] = xv[rr][0].w;
      xw[2][2 * rr] = xv[rr][1].x;
      xw[2][2 * rr + 1] = xv[rr][1].y;
      xw[3][2 * rr] = xv[rr][1].z;
      xw[3][2 * rr + 1] = xv[rr][1].w;
    }
    if (t + 1 < T) load_pre(t + 1);
    if (active) {
      float acc[4][4];  // [gate][e]
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
      const bf16* ha = hb + ((t + 1) & 1) * kRows * HS;  // h_{t-1}
      for (int k0 = 0; k0 < H; k0 += 16) {
        uint32_t a[4];
        ldsm_x4(a, a_addr(ha, HS, 0, k0, lane));
#pragma unroll
        for (int gp = 0; gp < 2; ++gp) {  // gates (i, f), then (g, o)
          uint32_t bf[4];
          ldsm_x4(bf, b_addr(ws, HS, warp * 32 + gp * 16, k0, lane));
          mma(acc[2 * gp], a, bf[0], bf[1]);
          mma(acc[2 * gp + 1], a, bf[2], bf[3]);
        }
      }
      float act[4][4], h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e & 1;
        act[0][e] = sigmoid_f((xw[0][e] + acc[0][e]) + bv[0][u]);
        act[1][e] = sigmoid_f((xw[1][e] + acc[1][e]) + bv[1][u]);
        act[2][e] = tanhf((xw[2][e] + acc[2][e]) + bv[2][u]);
        act[3][e] = sigmoid_f((xw[3][e] + acc[3][e]) + bv[3][u]);
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
    __syncthreads();
  }
}

template <bool STASH>
int dispatch_xw(const bf16* x, const bf16* wxt, const bf16* wht,
                const bf16* b, float* pre, bf16* hs, bf16* cs, bf16* gates,
                int B, int T, int E, int H, void* stream) {
  if (!xw_widths_ok(E, H)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = (long long)B * T;
  const int G = 4 * H;
  lstm_xproj_tc<<<dim3((unsigned)((N + QM - 1) / QM), (G + QN - 1) / QN), 256,
                  0, s>>>(x, wxt, pre, N, E, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = xw_smem(H);
  err = cudaFuncSetAttribute(lstm_fwd_xw_tc<STASH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  lstm_fwd_xw_tc<STASH><<<(B + kRows - 1) / kRows, kThreads, smem, s>>>(
      pre, wht, b, hs, cs, gates, B, T, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: x . Wx as one FFMA tile product, then the recurrence on a cluster
// over the hidden units, FFMA products, h handed through distributed
// shared memory behind mbarriers.

namespace cg = cooperative_groups;

using lstm_f32::Slot;
using lstm_f32::ldg4;
using lstm_f32::outer8;
using lstm_f32::peer_addr;
using lstm_f32::rows_per_thread;
using lstm_f32::smem_addr;

// The recurrence's product is cut over k into this many thread groups: two
// at R=16 (latency-bound serving: twice the warps on a step's chain)
// where the threads allow, else one.
int f32_fwd_ksplit(int H, int R, int C) {
  return R == 16 && 2 * (H / C) * (R / rows_per_thread(R)) <= lstm_f32::kThreads
             ? 2
             : 1;
}

// Shared memory of the f32 recurrence: two mbarriers, the block's Wh slice
// [H][U][4], two h tiles [H][R] and, with the product cut over k, the
// second group's sums [U R / RT][RT][4], f32. Mirrored by
// ops/kernels/lstm.py f32_fwd_smem_bytes.
size_t f32_fwd_smem(int H, int R, int C) {
  const size_t U = H / C;
  return 16 + sizeof(float) * (H * 4 * U + 2 * (size_t)H * R +
                               (f32_fwd_ksplit(H, R, C) - 1) * 4 * U * R);
}

bool f32_widths_ok(int E, int H, int R, int C) {
  return E > 0 && E % 4 == 0 && lstm_f32::tiling_ok(H, R, C) &&
         f32_fwd_smem(H, R, C) <= (size_t)kMaxSmem;
}

constexpr int XN = 128, XC = 128, XK = 16;  // x . Wx tile: rows, columns, k
constexpr int kXThreads = 256;

// pre[n][c] = bp[c] + sum_e x[n][e] wxp[e][c] for rows n0 .. n0+127 and
// columns c0 .. c0+127 (c = 4 unit + gate: the recurrence reads a cell's
// four gates as one 16-byte load). Thread (ty = tid / 16, tx = tid % 16):
// rows n0 + 4 ty + {0..3} and n0 + 64 + 4 ty + {0..3}, columns c0 + 4 tx +
// {0..3} and c0 + 64 + 4 tx + {0..3}. x slabs are transposed into shared
// memory, double-buffered through registers.
__global__ void __launch_bounds__(kXThreads, 2)
lstm_xproj_f32(const float* __restrict__ x,    // [N, E]
               const float* __restrict__ wxp,  // [E, 4H]
               const float* __restrict__ bp,   // [4H]
               float* __restrict__ pre,        // [N, 4H]
               long long N, int E, int G) {
  __shared__ __align__(16) float Xs[2][XK][XN + 4];
  __shared__ __align__(16) float Ws[2][XK][XC];
  const long long n0 = (long long)blockIdx.x * XN;
  const int c0 = blockIdx.y * XC;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // x slab: row lr + 64 k of vector lv; W slab: row wr + 8 k of vector wv.
  const int lr = tid >> 2, lv = tid & 3, wr = tid >> 5, wv = tid & 31;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto load = [&](int e0, float4 (&xr)[2], float4 (&wq)[2]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long n = n0 + lr + 64 * k;
      const int e = e0 + 4 * lv;
      xr[k] = n < N && e < E ? ldg4(x + n * E + e) : zero;
      const int we = e0 + wr + 8 * k, c = c0 + 4 * wv;
      wq[k] = we < E && c < G ? ldg4(wxp + (size_t)we * G + c) : zero;
    }
  };
  auto store = [&](int buf, const float4 (&xr)[2], const float4 (&wq)[2]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = lr + 64 * k;
      Xs[buf][4 * lv][r] = xr[k].x;
      Xs[buf][4 * lv + 1][r] = xr[k].y;
      Xs[buf][4 * lv + 2][r] = xr[k].z;
      Xs[buf][4 * lv + 3][r] = xr[k].w;
      *reinterpret_cast<float4*>(&Ws[buf][wr + 8 * k][4 * wv]) = wq[k];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;
  float4 xr[2], wq[2];
  load(0, xr, wq);
  store(0, xr, wq);
  __syncthreads();
  int buf = 0;
  for (int e0 = 0; e0 < E; e0 += XK) {
    const bool more = e0 + XK < E;
    if (more) load(e0 + XK, xr, wq);
#pragma unroll
    for (int k = 0; k < XK; ++k) {
      outer8(acc, *reinterpret_cast<const float4*>(&Xs[buf][k][4 * ty]),
             *reinterpret_cast<const float4*>(&Xs[buf][k][64 + 4 * ty]),
             *reinterpret_cast<const float4*>(&Ws[buf][k][4 * tx]),
             *reinterpret_cast<const float4*>(&Ws[buf][k][64 + 4 * tx]));
    }
    if (more) store(buf ^ 1, xr, wq);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 64 * h + 4 * tx;
    if (c >= G) continue;
    const float4 bias = ldg4(bp + c);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const long long n = n0 + (p < 4 ? 4 * ty + p : 64 + 4 * ty + p - 4);
      if (n < N) {
        *reinterpret_cast<float4*>(pre + n * G + c) =
            make_float4(acc[p][4 * h] + bias.x, acc[p][4 * h + 1] + bias.y,
                        acc[p][4 * h + 2] + bias.z,
                        acc[p][4 * h + 3] + bias.w);
      }
    }
  }
}

// The recurrence of one tile of R rows on a cluster of C blocks (tiling in
// csrc/lstm_f32.cuh). Each step: the thread's cells start from pre (x_t .
// Wx + b, loaded a step ahead), add h_{t-1} . Wh over the block's slice
// (the h tile [H][R] holds all H units: the thread's RT rows are one 8- or
// 16-byte read, its unit's four gates one 16-byte read), the epilogue in
// registers, hs (and cs, gates) to memory, and h_t to every block's other
// h tile by st.async.
template <int R, int C, bool STASH>
__global__ void __launch_bounds__(lstm_f32::kThreads, 1)
lstm_fwd_cluster(const float* __restrict__ pre,  // [B, T, H, 4]
                 const float* __restrict__ wl,   // [C][H][U][4]
                 float* __restrict__ hs,         // [B, T, H]
                 float* __restrict__ cs,         // [B, T, H]   (STASH only)
                 float* __restrict__ gates,      // [B, T, 4H]  (STASH only)
                 int B, int T, int H) {
  constexpr int RT = rows_per_thread(R);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem_raw);  // [2]
  float* ws = reinterpret_cast<float*>(smem_raw + 16);     // [H][U][4]
  cg::cluster_group cluster = cg::this_cluster();
  const int U = H / C, G = 4 * H;
  float* hb = ws + (size_t)H * U * 4;  // [2][H][R]
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / C) * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // kh: the thread's group of the k split (kh > 0 only sums its part of
  // the product, which group 0 adds and carries on with); R=32 never
  // splits, and its code keeps no trace of the split.
  const int cells = U * (R / RT);
  const int kh = R == 16 ? tid / cells : 0, ks = R == 16 ? nthr / cells : 1;
  const Slot sl = lstm_f32::slot_of(tid - kh * cells, U);
  const int r0 = sl.g * RT;       // the thread's first row in the tile
  const int hu = rank * U + sl.s;  // its unit
  const uint32_t tile_bytes = (uint32_t)(H * R * sizeof(float));
  float4* red = reinterpret_cast<float4*>(hb + 2 * H * R) +
                (tid - kh * cells) * RT;  // [cells][RT] gate sums
  const int k0 = kh * (H / ks), k1 = k0 + H / ks;

  {
    const float4* src =
        reinterpret_cast<const float4*>(wl + (size_t)rank * H * U * 4);
    float4* dst = reinterpret_cast<float4*>(ws);
    for (int i = tid; i < H * U; i += nthr) dst[i] = __ldg(src + i);
    for (int i = tid; i < H * R; i += nthr) hb[i] = 0.0f;  // h_{-1}
  }
  const uint32_t bar0 = smem_addr(mbar), hb1 = smem_addr(hb + H * R);
  if (tid == 0) {
    lstm_f32::mbar_init(bar0, 1);
    lstm_f32::mbar_init(bar0 + 8, 1);
    lstm_f32::mbar_init_fence();
    lstm_f32::mbar_expect_tx(bar0, tile_bytes);      // h_1
    lstm_f32::mbar_expect_tx(bar0 + 8, tile_bytes);  // h_0
  }
  cluster.sync();  // every block runs, its barriers are armed

  bool ok[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) ok[i] = row0 + r0 + i < B;
  auto load_pre = [&](float4 (&v)[RT], int t) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      v[i] = ok[i] ? ldg4(pre + (((size_t)(row0 + r0 + i) * T + t) * H + hu) *
                                    4)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  float4 pv[RT];
  float c[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) pv[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kh == 0) load_pre(pv, 0);
#pragma unroll
  for (int i = 0; i < RT; ++i) c[i] = 0.0f;

  for (int t = 0; t < T; ++t) {
    const int b = t & 1;
    if (t > 0) {
      lstm_f32::mbar_wait(bar0 + 8 * b, ((t - 1) >> 1) & 1);
      if (tid == 0) lstm_f32::mbar_expect_tx(bar0 + 8 * b, tile_bytes);
    }
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      acc[i][0] = pv[i].x;
      acc[i][1] = pv[i].y;
      acc[i][2] = pv[i].z;
      acc[i][3] = pv[i].w;
    }
    if (kh == 0 && t + 1 < T) load_pre(pv, t + 1);
    const float* hp = hb + b * H * R + r0;
    const float4* w4 = reinterpret_cast<const float4*>(ws) + sl.s;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      float hv[RT];
      lstm_f32::lds<RT>(hv, hp + k * R);
      const float4 w = w4[k * U];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        acc[i][0] = fmaf(hv[i], w.x, acc[i][0]);
        acc[i][1] = fmaf(hv[i], w.y, acc[i][1]);
        acc[i][2] = fmaf(hv[i], w.z, acc[i][2]);
        acc[i][3] = fmaf(hv[i], w.w, acc[i][3]);
      }
    }
    if (ks > 1) {
      // group 1's sums to group 0 through shared memory: written after this
      // step's wait, read before group 0 sends h_t, which the next step's
      // write waits for.
      if (kh == 1) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          red[i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
      __syncthreads();
      if (kh == 1) continue;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 q = red[i];
        acc[i][0] += q.x;
        acc[i][1] += q.y;
        acc[i][2] += q.z;
        acc[i][3] += q.w;
      }
    }
    float hn[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float ig = sigmoid_f(acc[i][0]);
      const float fg = sigmoid_f(acc[i][1]);
      const float gg = tanhf(acc[i][2]);
      const float og = sigmoid_f(acc[i][3]);
      c[i] = fg * c[i] + ig * gg;
      hn[i] = og * tanhf(c[i]);
      if (ok[i]) {
        const size_t bt = (size_t)(row0 + r0 + i) * T + t;
        hs[bt * H + hu] = hn[i];
        if (STASH) {
          cs[bt * H + hu] = c[i];
          float* gt = gates + bt * G + hu;
          gt[0] = ig;
          gt[H] = fg;
          gt[2 * H] = gg;
          gt[3 * H] = og;
        }
      }
    }
    if (t + 1 < T) {
      // h_t into every block's other h tile, completing on its barrier.
      const uint32_t dst = (b ? smem_addr(hb) : hb1) +
                           (uint32_t)((hu * R + r0) * sizeof(float));
      const uint32_t bar = bar0 + 8 * (b ^ 1);
#pragma unroll
      for (int p = 0; p < C; ++p) {
        lstm_f32::st_async<RT>(peer_addr(dst, p), hn, peer_addr(bar, p));
      }
    }
  }
  cluster.sync();  // no block exits while a peer may still write into it
}

template <int R, int C, bool STASH>
cudaError_t config_fwd_f32(cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute (&attr)[1], int B, int H) {
  const size_t smem = f32_fwd_smem(H, R, C);
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_cluster<R, C, STASH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3((unsigned)((B + R - 1) / R * C));
  cfg.blockDim = dim3((unsigned)(H / C * (R / rows_per_thread(R)) *
                                 f32_fwd_ksplit(H, R, C)));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

template <int R, int C, bool STASH>
int launch_fwd_f32(const float* pre, const float* wl, float* hs, float* cs,
                   float* gates, int B, int T, int H, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = config_fwd_f32<R, C, STASH>(cfg, attr, B, H);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, lstm_fwd_cluster<R, C, STASH>, pre, wl, hs,
                           cs, gates, B, T, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most clusters of lstm_fwd_cluster<R, C, STASH> the card holds at
// once (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
template <int R, int C, bool STASH>
int max_clusters_f32(int H) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = config_fwd_f32<R, C, STASH>(cfg, attr, R, H);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, lstm_fwd_cluster<R, C, STASH>,
                                       &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

template <bool STASH>
int dispatch_f32(const float* x, const float* wxp, const float* bp,
                 const float* wl, float* pre, float* hs, float* cs,
                 float* gates, int B, int T, int E, int H, int R, int C,
                 void* stream) {
  if (!f32_widths_ok(E, H, R, C)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = (long long)B * T;
  const int G = 4 * H;
  lstm_xproj_f32<<<dim3((unsigned)((N + XN - 1) / XN), (G + XC - 1) / XC),
                   kXThreads, 0, s>>>(x, wxp, bp, pre, N, E, G);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define LSTM_FWD_F32(RR, CC)                                                \
  if (R == RR && C == CC) {                                                 \
    return launch_fwd_f32<RR, CC, STASH>(pre, wl, hs, cs, gates, B, T, H, s); \
  }
  LSTM_F32_TILINGS(LSTM_FWD_F32)
#undef LSTM_FWD_F32
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// hs[B, T, H] = LSTM over x[B, T, E] (all f32, contiguous, on the device;
// x 16-byte aligned), in two launches on the stream: pre = x . wxp + bp,
// then the recurrence. wxp [E, 4H] and bp [4H] are Wx and b with the
// columns in the order 4 unit + gate, wl [C][H][H/C][4] is Wh for the
// cluster's blocks (ops/kernels/lstm.py f32_xproj_layout,
// f32_fwd_weight_layout), pre [B, T, 4H] f32 scratch. R and C are the
// tile's rows and the cluster's blocks (f32_tiling). Returns the
// cudaError_t of the launches (0 = launched).
extern "C" int lstm_fwd_f32(const float* x, const float* wxp, const float* bp,
                            const float* wl, float* pre, float* hs, int B,
                            int T, int E, int H, int R, int C, void* stream) {
  return dispatch_f32<false>(x, wxp, bp, wl, pre, hs, nullptr, nullptr, B, T,
                             E, H, R, C, stream);
}

// The same, also writing the BPTT residuals: cs[B, T, H] (cell states) and
// gates[B, T, 4H] (activated i, f, g, o).
extern "C" int lstm_fwd_stash_f32(const float* x, const float* wxp,
                                  const float* bp, const float* wl,
                                  float* pre, float* hs, float* cs,
                                  float* gates, int B, int T, int E, int H,
                                  int R, int C, void* stream) {
  return dispatch_f32<true>(x, wxp, bp, wl, pre, hs, cs, gates, B, T, E, H,
                            R, C, stream);
}

// The most clusters of the f32 recurrence (stash = 1: lstm_fwd_stash_f32)
// at (R, C) that the card holds at once, for H; or minus the cudaError_t.
// A grid of more clusters runs in waves. The stream is not used.
extern "C" int lstm_fwd_f32_clusters(int H, int R, int C, int stash,
                                     void* stream) {
  (void)stream;
  if (!f32_widths_ok(4, H, R, C)) return -(int)cudaErrorInvalidValue;
#define LSTM_FWD_F32_CLUSTERS(RR, CC)                                  \
  if (R == RR && C == CC) {                                            \
    return stash ? max_clusters_f32<RR, CC, true>(H)                   \
                 : max_clusters_f32<RR, CC, false>(H);                 \
  }
  LSTM_F32_TILINGS(LSTM_FWD_F32_CLUSTERS)
#undef LSTM_FWD_F32_CLUSTERS
  return -(int)cudaErrorInvalidValue;
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

// The bf16 xw forward: x . Wx into the f32 scratch pre [B, T, 4H] (no
// bias), then the recurrence with only Wh resident. wxt [4H, E] is Wx in
// the layout of ops/kernels/lstm.py xw_xproj_layout (rows in xw_permutation
// order), wht [4H, H] is Wh in xw_rec_weight_layout's (rows in
// gate_permutation order). Any E a multiple of 16; H a multiple of 16 up to
// 128. Returns the cudaError_t of the launches (0 = launched).
extern "C" int lstm_fwd_xw_bf16(const __nv_bfloat16* x,
                                const __nv_bfloat16* wxt,
                                const __nv_bfloat16* wht,
                                const __nv_bfloat16* b, float* pre,
                                __nv_bfloat16* hs, int B, int T, int E,
                                int H, void* stream) {
  return dispatch_xw<false>(x, wxt, wht, b, pre, hs, nullptr, nullptr, B, T,
                            E, H, stream);
}

extern "C" int lstm_fwd_stash_xw_bf16(const __nv_bfloat16* x,
                                      const __nv_bfloat16* wxt,
                                      const __nv_bfloat16* wht,
                                      const __nv_bfloat16* b, float* pre,
                                      __nv_bfloat16* hs, __nv_bfloat16* cs,
                                      __nv_bfloat16* gates, int B, int T,
                                      int E, int H, void* stream) {
  return dispatch_xw<true>(x, wxt, wht, b, pre, hs, cs, gates, B, T, E, H,
                           stream);
}
