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
// outputs. A third of the serial step's products (dh; dx is the rest of
// dpre . W^T) sits on the T-step serial chain, as in the forward; dx, dWx
// and dWh have no serial dependency at all.
//
// What the design does about it, both dtypes. The TPU kernel's grid is the
// time axis, run in order, with dWx/dWh/db accumulated in output blocks
// that stay resident across the grid. Hopper's blocks run in no order, so
// the work is split by what is serial and what is not: a recurrent kernel
// walks t and writes dpre for every (b, t) to a workspace, and kernels with
// no serial dependency then reduce it. No float atomics anywhere: every sum
// has one owner and a fixed order, so two calls give the same bits.
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
// stored. Widths: E and H multiples of 16, H <= 128, Wh and the tiles
// within 227 KB of shared memory; the wrapper raises on others.
//
// f32 (lstm_bwd_recurrent_f32 then lstm_bwd_wgrad_f32, the cluster body).
// Products on the FP32 pipes (FFMA, f32 sums), as the TPU kernel's f32
// arithmetic; dpre stays f32 (the TPU kernel's dpre.astype(f32) rounds
// nothing), in an f32 workspace [B, T, 4H] (839 MB at B = 2048).
// 1. lstm_bwd_rec_cluster: only the serial work, dpre and dh_{t-1} =
//    dpre . Wh^T; dx leaves the chain. The forward's tiling
//    (csrc/lstm_f32.cuh): a cluster of C blocks owns R batch rows, block c
//    the units [c U, (c+1) U) and their four gate columns of dpre; thread
//    (unit s, RT rows) holds dh, dc of its cells in registers. Each step:
//      - dh = the C partials of its cells summed in rank order, + dhs;
//        dpre of its cells from the stash (gates, c_t, c_{t-1}, dhs loaded
//        a step ahead into registers: nothing there depends on the chain),
//        into the f32 workspace, the db sums (f32 registers over all t) and
//        the block's dpre tile [4U][R] in shared memory;
//      - a block barrier, then the block's partial dh_{t-1} for all H
//        units from its own 4U dpre columns: [R, 4U] x [4U, H] with the
//        block's Wh slice in shared memory ([4U][H], f32_rec_weight_layout,
//        a plain copy made once a call). The thread computes its rows for
//        the C units s + U m and sends the one for unit s + U m to block m's
//        receive buffer (slot: its own rank) by st.async, completing bytes
//        on that block's mbarrier, which the block waits on before it sums.
//    This is layout (ii) of the design: an all-gather of the [R, 4H] f32
//    dpre tile (i) needs two 128 KiB buffers at R = 64 or two 64 KiB ones
//    at R = 32 beside a 128 KiB slice, more than a block has; (ii) keeps
//    Wh's slice (128 KiB at R = 32, C = 2), the dpre tile (32 KiB) and two
//    receive buffers [C][U][R] (32 KiB): 192 KiB. The receive buffers
//    alternate; the data dependency orders each write after the last read
//    of its buffer, and the next step's wait orders the dpre tile's next
//    write after this step's product, so a step has one block barrier and
//    no cluster barrier. db: each thread's sums added over the block's rows
//    in a fixed order, one f32 partial [4H] a tile. The kernel ends with a
//    cluster barrier (the exit rule).
// 2. lstm_wgrad_f32: [dWx; dWh] = A^T . dpre over the N = B*T rows, A[n] =
//    [x[n], h_{t-1}[n]] (h_{t-1} resolved once a row and slab: hs one row
//    back, zero where n % T = 0, wgrad_rows_plain), FFMA 64 x 128 output
//    tiles, 8 x 8 outputs a thread from 16-byte shared-memory reads, slabs
//    of 16 rows double-buffered through registers, `splits` chunks of rows,
//    each written as an f32 partial.
// 3. lstm_dx_f32: dx = dpre . Wx^T, 128 x 64 tiles of FFMA, 8 x 8 a thread,
//    dpre and Wx read as the caller stores them and transposed into shared
//    memory, four blocks an SM. A pass of its own: fused into the weight
//    gradient's pass it would need the [N, 4H] rows of dpre whole in one
//    block, which tiles the reduction over N, not over 4H.
// 4. lstm_wgrad_reduce_f32: the partials summed in order, db from the
//    recurrent tiles' partials.
// Widths: those of the f32 forward (H a multiple of 8 C, at most 512
// threads, the slice and tiles within 227 KB: f32_rec_smem; E a multiple
// of 4). What was hard (f32): fitting Wh's slice, the dpre tile and the
// partials' buffers in one block (layout (ii) above), and a fixed order
// for every sum with no barrier a step: the partials of a unit arrive from
// C blocks in any order, land in C slots and are added in rank order.
//
// Ragged B: rows >= B are masked in the recurrent kernels and never reach
// the workspace; the later kernels only read rows < B*T.
// Precise expf/tanhf; build without --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_f32.cuh"
#include "mma_bf16.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// f32: the recurrent chain on a cluster over the hidden units (the
// forward's tiling, csrc/lstm_f32.cuh), the dh partials handed through
// distributed shared memory behind mbarriers; FFMA tiles for the weight
// gradient and dx.

namespace cg = cooperative_groups;

using lstm_f32::Slot;
using lstm_f32::ldg4;
using lstm_f32::outer8;
using lstm_f32::peer_addr;
using lstm_f32::rows_per_thread;
using lstm_f32::smem_addr;

// Shared memory of the f32 recurrent body: two mbarriers, the Wh slice
// [4U][H], the dpre tile [4U][R] and two receive buffers [C][U][R], f32.
// Mirrored by ops/kernels/lstm.py f32_rec_smem_bytes.
size_t f32_rec_smem(int H, int R, int C) {
  const size_t U = H / C;
  return 16 + sizeof(float) * (4 * U * H + 4 * U * R + 2 * (size_t)C * U * R);
}

bool f32_rec_widths_ok(int H, int R, int C) {
  return lstm_f32::tiling_ok(H, R, C, lstm_f32::rec_max_threads(R, C)) &&
         f32_rec_smem(H, R, C) <= (size_t)kMaxSmem;
}

// The stash of one step for a thread's cells: gates, dhs, c_{t-1}.
template <int RT>
struct StashF32 {
  float gt[RT][4], dh[RT], cp[RT];
};

// One tile of R rows by a cluster of C blocks; block `rank` owns units
// rank*U .. rank*U+U-1, thread (slot s, row group g) the cells of rows
// g RT .. + RT - 1 and unit s. Its dh product outputs are the partials of
// units s + U m (m < C) for its rows: unit s + U m goes to block m.
template <int R, int C>
__global__ void __launch_bounds__(lstm_f32::rec_max_threads(R, C), 1)
lstm_bwd_rec_cluster(const float* __restrict__ dhs,    // [B, T, H]
                     const float* __restrict__ cs,     // [B, T, H]
                     const float* __restrict__ gates,  // [B, T, 4H]
                     const float* __restrict__ whl,    // [C][4U][H]
                     float* __restrict__ dpre,         // [B, T, 4H]
                     float* __restrict__ dbp,          // [tiles, 4H]
                     int B, int T, int H) {
  constexpr int RT = rows_per_thread(R);
  constexpr int CV = C < 4 ? C : 4;  // Wh values a read
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem_raw);  // [2]
  float* whs = reinterpret_cast<float*>(smem_raw + 16);    // [4U][C/CV][U][CV]
  cg::cluster_group cluster = cg::this_cluster();
  const int U = H / C, G = 4 * H;
  float* dpt = whs + (size_t)4 * U * H;   // [4U][R]
  float* recv = dpt + (size_t)4 * U * R;  // [2][C][U][R]
  const int rank = (int)cluster.block_rank();
  const int tile = (int)(blockIdx.x / C);
  const int row0 = tile * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const Slot sl = lstm_f32::slot_of(tid, U);
  const int r0 = sl.g * RT;
  const int hu = rank * U + sl.s;  // the thread's unit
  const uint32_t phase_bytes = (uint32_t)(C * U * R * sizeof(float));

  {
    const float4* src =
        reinterpret_cast<const float4*>(whl + (size_t)rank * 4 * U * H);
    float4* dst = reinterpret_cast<float4*>(whs);
    for (int i = tid; i < U * H; i += nthr) dst[i] = __ldg(src + i);
  }
  const uint32_t bar0 = smem_addr(mbar), recv0 = smem_addr(recv);
  if (tid == 0) {
    lstm_f32::mbar_init(bar0, 1);
    lstm_f32::mbar_init(bar0 + 8, 1);
    lstm_f32::mbar_init_fence();
    lstm_f32::mbar_expect_tx(bar0, phase_bytes);
    lstm_f32::mbar_expect_tx(bar0 + 8, phase_bytes);
  }

  bool ok[RT];
  size_t base[RT];  // (row0 + r) * T, for rows < B
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    ok[i] = row0 + r0 + i < B;
    base[i] = ok[i] ? (size_t)(row0 + r0 + i) * T : 0;
  }
  auto load = [&](StashF32<RT>& s, int t) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const size_t bt = base[i] + t;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        s.gt[i][g] = ok[i] ? __ldg(gates + bt * G + g * H + hu) : 0.0f;
      }
      s.dh[i] = ok[i] ? __ldg(dhs + bt * H + hu) : 0.0f;
      s.cp[i] = ok[i] && t > 0 ? __ldg(cs + (bt - 1) * H + hu) : 0.0f;
    }
  };
  StashF32<RT> cur, nxt;
  float ct[RT], dc[RT], db[4];
  load(cur, T - 1);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    ct[i] = ok[i] ? __ldg(cs + (base[i] + T - 1) * H + hu) : 0.0f;
    dc[i] = 0.0f;
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) db[g] = 0.0f;
  cluster.sync();  // every block runs, its barriers are armed

  for (int t = T - 1; t >= 0; --t) {
    // dh of the step: the C partials the product of step t + 1 sent, in
    // rank order.
    const int rb = (t + 1) & 1;
    float dhv[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) dhv[i] = 0.0f;
    if (t < T - 1) {
      lstm_f32::mbar_wait(bar0 + 8 * rb, ((T - 2 - t) >> 1) & 1);
      if (tid == 0) lstm_f32::mbar_expect_tx(bar0 + 8 * rb, phase_bytes);
      const float* rv = recv + (size_t)rb * C * U * R + sl.s * R + r0;
      lstm_f32::lds<RT>(dhv, rv);
#pragma unroll
      for (int p = 1; p < C; ++p) {
        float part[RT];
        lstm_f32::lds<RT>(part, rv + p * U * R);
#pragma unroll
        for (int i = 0; i < RT; ++i) dhv[i] += part[i];
      }
    }
    float d[4][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float dh = dhv[i] + cur.dh[i];
      const float ig = cur.gt[i][0], fg = cur.gt[i][1];
      const float gg = cur.gt[i][2], og = cur.gt[i][3];
      const float th = tanhf(ct[i]);
      const float dO = dh * th;
      const float dC = dh * og * (1.0f - th * th) + dc[i];
      dc[i] = dC * fg;
      d[0][i] = dC * gg * ig * (1.0f - ig);
      d[1][i] = dC * cur.cp[i] * fg * (1.0f - fg);
      d[2][i] = dC * ig * (1.0f - gg * gg);
      d[3][i] = dO * og * (1.0f - og);
      if (ok[i]) {
        float* dp = dpre + (base[i] + t) * G + hu;
#pragma unroll
        for (int g = 0; g < 4; ++g) dp[g * H] = d[g][i];
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int i = 0; i < RT; ++i) db[g] += d[g][i];
      lstm_f32::sts<RT>(dpt + (size_t)(4 * sl.s + g) * R + r0, d[g]);
    }
    if (t > 0) load(nxt, t - 1);
    __syncthreads();  // the block's dpre tile is whole
    if (t > 0) {
      // partial dh_{t-1}[r][s + U m] = sum over the block's 4U columns j
      // (j = 4 u' + gate) of dpre[r][j] Wh[s + U m][col j].
      float acc[C][RT];
#pragma unroll
      for (int m = 0; m < C; ++m)
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[m][i] = 0.0f;
      const float* wp = whs + sl.s * CV;
#pragma unroll 4
      for (int j = 0; j < 4 * U; ++j) {
        float dv[RT];
        lstm_f32::lds<RT>(dv, dpt + (size_t)j * R + r0);
        float wv[C];
#pragma unroll
        for (int h = 0; h < C / CV; ++h) {
          const float* q = wp + (size_t)j * H + h * U * CV;
          if constexpr (CV == 4) {
            const float4 w = *reinterpret_cast<const float4*>(q);
            wv[4 * h] = w.x;
            wv[4 * h + 1] = w.y;
            wv[4 * h + 2] = w.z;
            wv[4 * h + 3] = w.w;
          } else {
#pragma unroll
            for (int v = 0; v < CV; ++v) wv[h * CV + v] = q[v];
          }
        }
#pragma unroll
        for (int m = 0; m < C; ++m)
#pragma unroll
          for (int i = 0; i < RT; ++i)
            acc[m][i] = fmaf(dv[i], wv[m], acc[m][i]);
      }
      // unit s + U m's partial to block m, slot `rank`, completing on that
      // block's barrier for this step's buffer.
      const int wb = t & 1;
      const uint32_t off = (uint32_t)(
          ((size_t)wb * C * U * R + ((size_t)rank * U + sl.s) * R + r0) *
          sizeof(float));
#pragma unroll
      for (int m = 0; m < C; ++m) {
        lstm_f32::st_async<RT>(peer_addr(recv0 + off, m), acc[m],
                               peer_addr(bar0 + 8 * wb, m));
      }
    }
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < RT; ++i) ct[i] = cur.cp[i];
      cur = nxt;
    }
  }
  cluster.sync();  // no block exits while a peer may still write into it

  // db: the R / RT row groups of a unit added in order; one partial a tile.
  reinterpret_cast<float4*>(dpt)[sl.g * U + sl.s] =
      make_float4(db[0], db[1], db[2], db[3]);
  __syncthreads();
  for (int i = tid; i < 4 * U; i += nthr) {
    const int u = i >> 2, g = i & 3;
    float s = 0.0f;
    for (int k = 0; k < R / RT; ++k) s += dpt[(k * U + u) * 4 + g];
    dbp[(size_t)tile * G + g * H + rank * U + u] = s;
  }
}

template <int R, int C>
cudaError_t config_rec_f32(cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute (&attr)[1], int B, int H) {
  const size_t smem = f32_rec_smem(H, R, C);
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_rec_cluster<R, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3((unsigned)((B + R - 1) / R * C));
  cfg.blockDim = dim3((unsigned)(H / C * (R / rows_per_thread(R))));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

template <int R, int C>
int launch_rec_f32(const float* dhs, const float* cs, const float* gates,
                   const float* whl, float* dpre, float* dbp, int B, int T,
                   int H, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = config_rec_f32<R, C>(cfg, attr, B, H);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_rec_cluster<R, C>, dhs, cs, gates,
                           whl, dpre, dbp, B, T, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most clusters of lstm_bwd_rec_cluster<R, C> the card holds at once,
// or minus the cudaError_t.
template <int R, int C>
int max_clusters_rec_f32(int H) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = config_rec_f32<R, C>(cfg, attr, R, H);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, lstm_bwd_rec_cluster<R, C>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

int rec_f32(const float* dhs, const float* cs, const float* gates,
            const float* whl, float* dpre, float* dbp, int B, int T, int H,
            int R, int C, void* stream) {
  if (!f32_rec_widths_ok(H, R, C) || B <= 0 || T <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LSTM_REC_F32(RR, CC)                                                \
  if (R == RR && C == CC) {                                                 \
    return launch_rec_f32<RR, CC>(dhs, cs, gates, whl, dpre, dbp, B, T, H, \
                                  s);                                       \
  }
  LSTM_F32_TILINGS(LSTM_REC_F32)
#undef LSTM_REC_F32
  return (int)cudaErrorInvalidValue;
}

constexpr int kGemmThreads = 128;
constexpr int GF = 64;   // weight-gradient tile: features
constexpr int GJ = 128;  // weight-gradient tile: gate columns
constexpr int GK = 16;   // rows of the B*T reduction a slab

// [dWx; dWh] partials of rows [split*chunk, (split+1)*chunk): features f0 ..
// f0+63 by gate columns j0 .. j0+127. Thread (ty = tid / 16, tx = tid % 16):
// features f0 + 4 ty + {0..3} and f0 + 32 + 4 ty + {0..3}, columns j0 + 4 tx
// + {0..3} and j0 + 64 + 4 tx + {0..3}.
__global__ void __launch_bounds__(kGemmThreads)
lstm_wgrad_f32(const float* __restrict__ x,     // [N, E]
               const float* __restrict__ hs,    // [N, H]
               const float* __restrict__ dpre,  // [N, 4H]
               float* __restrict__ partial,     // [splits, E+H, 4H]
               long long N, long long chunk, int T, int E, int H) {
  __shared__ __align__(16) float As[2][GK][GF];
  __shared__ __align__(16) float Ds[2][GK][GJ];
  const int G = 4 * H, F = E + H;
  const int j0 = blockIdx.x * GJ, f0 = blockIdx.y * GF;
  const long long n_begin = (long long)blockIdx.z * chunk;
  const long long n_end = min(N, n_begin + chunk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // A slab: 16 rows x 16 vectors, rows ar and ar + 8 of vector av; D slab:
  // 16 rows x 32 vectors, rows dr + 4 k of vector dv.
  const int ar = tid >> 4, av = tid & 15, dr = tid >> 5, dv = tid & 31;
  const int fa = f0 + 4 * av, jd = j0 + 4 * dv;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto load = [&](long long n0, float4 (&ra)[2], float4 (&rd)[4]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long n = n0 + ar + 8 * k;
      ra[k] = zero;
      if (n < n_end) {
        if (fa < E) {
          ra[k] = ldg4(x + n * E + fa);
        } else if (fa < F && n % T != 0) {  // h_{t-1}: one row back
          ra[k] = ldg4(hs + (n - 1) * H + fa - E);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long n = n0 + dr + 4 * k;
      rd[k] = n < n_end && jd < G ? ldg4(dpre + n * G + jd) : zero;
    }
  };
  auto store = [&](int buf, const float4 (&ra)[2], const float4 (&rd)[4]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      *reinterpret_cast<float4*>(&As[buf][ar + 8 * k][4 * av]) = ra[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      *reinterpret_cast<float4*>(&Ds[buf][dr + 4 * k][4 * dv]) = rd[k];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;
  float4 ra[2], rd[4];
  if (n_begin < n_end) {
    load(n_begin, ra, rd);
    store(0, ra, rd);
  }
  __syncthreads();
  int buf = 0;
  for (long long n0 = n_begin; n0 < n_end; n0 += GK) {
    const bool more = n0 + GK < n_end;
    if (more) load(n0 + GK, ra, rd);
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      outer8(acc, *reinterpret_cast<const float4*>(&As[buf][k][4 * ty]),
             *reinterpret_cast<const float4*>(&As[buf][k][32 + 4 * ty]),
             *reinterpret_cast<const float4*>(&Ds[buf][k][4 * tx]),
             *reinterpret_cast<const float4*>(&Ds[buf][k][64 + 4 * tx]));
    }
    if (more) store(buf ^ 1, ra, rd);
    __syncthreads();
    buf ^= 1;
  }

  float* out = partial + (size_t)blockIdx.z * F * G;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int f = f0 + (p < 4 ? 4 * ty + p : 32 + 4 * ty + p - 4);
    if (f >= F) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + 64 * h + 4 * tx;
      if (j < G) {
        *reinterpret_cast<float4*>(out + (size_t)f * G + j) =
            make_float4(acc[p][4 * h], acc[p][4 * h + 1], acc[p][4 * h + 2],
                        acc[p][4 * h + 3]);
      }
    }
  }
}

constexpr int DN = 128;  // dx tile: rows
constexpr int DE = 64;   // dx tile: features
constexpr int DJ = 16;   // gate columns a slab

// dx = dpre . Wx^T for rows n0 .. n0+127 and features e0 .. e0+63. Thread
// (ty = tid / 8, tx = tid % 8): rows n0 + 4 ty + {0..3} and n0 + 64 + 4 ty +
// {0..3}, features e0 + 4 tx + {0..3} and e0 + 32 + 4 tx + {0..3}. Both
// operands are read as stored (j contiguous) and transposed into shared
// memory.
__global__ void __launch_bounds__(kGemmThreads, 4)
lstm_dx_f32(const float* __restrict__ dpre,  // [N, 4H]
            const float* __restrict__ wx,    // [E, 4H]
            float* __restrict__ dx,          // [N, E]
            long long N, int E, int H) {
  __shared__ __align__(16) float Ps[2][DJ][DN + 4];
  __shared__ __align__(16) float Ws[2][DJ][DE + 4];
  const int G = 4 * H;
  const long long n0 = (long long)blockIdx.x * DN;
  const int e0 = blockIdx.y * DE;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  // slabs: row lr + 32 k of vector lv (rows n or features e, 16 columns j).
  const int lr = tid >> 2, lv = tid & 3;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto load = [&](int j0, float4 (&p)[4], float4 (&w)[2]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long n = n0 + lr + 32 * k;
      p[k] = n < N ? ldg4(dpre + n * G + j0 + 4 * lv) : zero;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = e0 + lr + 32 * k;
      w[k] = e < E ? ldg4(wx + (size_t)e * G + j0 + 4 * lv) : zero;
    }
  };
  auto store = [&](int buf, const float4 (&p)[4], const float4 (&w)[2]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lr + 32 * k;
      Ps[buf][4 * lv][r] = p[k].x;
      Ps[buf][4 * lv + 1][r] = p[k].y;
      Ps[buf][4 * lv + 2][r] = p[k].z;
      Ps[buf][4 * lv + 3][r] = p[k].w;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = lr + 32 * k;
      Ws[buf][4 * lv][r] = w[k].x;
      Ws[buf][4 * lv + 1][r] = w[k].y;
      Ws[buf][4 * lv + 2][r] = w[k].z;
      Ws[buf][4 * lv + 3][r] = w[k].w;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;
  float4 p[4], w[2];
  load(0, p, w);
  store(0, p, w);
  __syncthreads();
  int buf = 0;
  for (int j0 = 0; j0 < G; j0 += DJ) {
    const bool more = j0 + DJ < G;
    if (more) load(j0 + DJ, p, w);
#pragma unroll
    for (int k = 0; k < DJ; ++k) {
      outer8(acc, *reinterpret_cast<const float4*>(&Ps[buf][k][4 * ty]),
             *reinterpret_cast<const float4*>(&Ps[buf][k][64 + 4 * ty]),
             *reinterpret_cast<const float4*>(&Ws[buf][k][4 * tx]),
             *reinterpret_cast<const float4*>(&Ws[buf][k][32 + 4 * tx]));
    }
    if (more) store(buf ^ 1, p, w);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long n = n0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
    if (n >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + 32 * h + 4 * tx;
      if (e < E) {
        *reinterpret_cast<float4*>(dx + n * E + e) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                        acc[r][4 * h + 3]);
      }
    }
  }
}

// dWx, dWh: the chunks' partials summed in order; db: the recurrent tiles'
// partials summed in order.
__global__ void lstm_wgrad_reduce_f32(const float* __restrict__ partial,
                                      const float* __restrict__ dbp,
                                      float* __restrict__ dwx,  // [E, 4H]
                                      float* __restrict__ dwh,  // [H, 4H]
                                      float* __restrict__ db,   // [4H]
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
  float* out = f < E ? dwx + (size_t)f * G : f < F ? dwh + (size_t)(f - E) * G
                                                   : db;
  out[j] = sum;
}

int wgrad_f32(const float* x, const float* hs, const float* wx,
              const float* dpre, const float* dbp, float* partial, float* dx,
              float* dwx, float* dwh, float* db, int B, int T, int E, int H,
              int splits, int tiles, void* stream) {
  if (E <= 0 || E % 4 != 0 || H <= 0 || H % 8 != 0 || B <= 0 || T <= 0 ||
      splits <= 0 || tiles <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = (long long)B * T;
  const long long chunk = (N + splits - 1) / splits;  // an empty chunk: zeros
  const int G = 4 * H, F = E + H;
  lstm_wgrad_f32<<<dim3((G + GJ - 1) / GJ, (F + GF - 1) / GF, splits),
                   kGemmThreads, 0, s>>>(x, hs, dpre, partial, N, chunk, T,
                                         E, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lstm_dx_f32<<<dim3((unsigned)((N + DN - 1) / DN), (E + DE - 1) / DE),
                kGemmThreads, 0, s>>>(dpre, wx, dx, N, E, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  lstm_wgrad_reduce_f32<<<((F + 1) * G + threads - 1) / threads, threads, 0,
                          s>>>(partial, dbp, dwx, dwh, db, splits, tiles, E,
                               H);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward of lstm_fwd_stash_f32, first half: the serial chain. Reads
// dhs, cs, gates [B, T, .] and whl, Wh in the layout of ops/kernels/lstm.py
// f32_rec_weight_layout for C ([C][4U][H]); writes dpre to the f32
// workspace [B, T, 4H] and one db partial per R-row tile to dbp
// [ceil(B / R), 4H]. R (16 or 64) and C (1, 4 or 8) as for the forward
// (f32_tiling). Returns the cudaError_t of the launch (0 = launched).
extern "C" int lstm_bwd_recurrent_f32(const float* dhs, const float* cs,
                                      const float* gates, const float* whl,
                                      float* dpre, float* dbp, int B, int T,
                                      int H, int R, int C, void* stream) {
  return rec_f32(dhs, cs, gates, whl, dpre, dbp, B, T, H, R, C, stream);
}

// The most clusters of the f32 recurrent backward at (R, C) that the card
// holds at once, for H; or minus the cudaError_t. The stream is not used.
extern "C" int lstm_bwd_recurrent_f32_clusters(int H, int R, int C,
                                               void* stream) {
  (void)stream;
  if (!f32_rec_widths_ok(H, R, C)) return -(int)cudaErrorInvalidValue;
#define LSTM_REC_F32_CLUSTERS(RR, CC) \
  if (R == RR && C == CC) return max_clusters_rec_f32<RR, CC>(H);
  LSTM_F32_TILINGS(LSTM_REC_F32_CLUSTERS)
#undef LSTM_REC_F32_CLUSTERS
  return -(int)cudaErrorInvalidValue;
}

// Second half: from the workspace and dbp (`tiles` rows), writes dx [B, T,
// E] and dwx [E, 4H], dwh [H, 4H], db [4H]. x, hs, wx and dpre 16-byte
// aligned; partial [splits, E+H, 4H] is f32 scratch; the B*T rows are cut
// into `splits` chunks of ceil(B*T / splits) rows.
extern "C" int lstm_bwd_wgrad_f32(const float* x, const float* hs,
                                  const float* wx, const float* dpre,
                                  const float* dbp, float* partial,
                                  float* dx, float* dwx, float* dwh,
                                  float* db, int B, int T, int E, int H,
                                  int splits, int tiles, void* stream) {
  return wgrad_f32(x, hs, wx, dpre, dbp, partial, dx, dwx, dwh, db, B, T, E,
                   H, splits, tiles, stream);
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
