// Causal flash attention, forward, dQ and dK/dV, for Hopper (sm_90a).
//
// Replaces, in distkeras_tpu/ops/pallas/flash_attention.py:
//   flash_fwd  <- _fwd_kernel (the pl.pallas_call in _flash_bhld, :213)
//   flash_dq   <- _dq_kernel  (the first pl.pallas_call in _flash_bwd, :249)
//   flash_dkv  <- _dkv_kernel (the second one, :261)
// the custom-VJP triple behind flash_attention.
//
// Inputs q, k, v (and dO) are [B, L, H, D] bf16 in the model's own layout,
// q pre-scaled; the kernels read the strided layout directly, so the
// wrapper transposes nothing. lse and delta are [B*H, L] float32. Every
// kernel loads by TMA, which cannot convert, so the wrapper rounds an f32
// caller's inputs to bf16 once (nearest even, the rounding point of the
// TPU kernels) and the kernels write f32 (flash_*_f32) or bf16.
//
// Numerics, as the TPU kernels compute them: q, k, v, dO and p are rounded
// to bf16 (nearest even) before each product and every product
// accumulates in f32 (the TPU's preferred_element_type=f32 dots); ds is
// rounded to bf16 before it multiplies K or Q. A bf16 x bf16 product is
// exact in f32, so the results differ from the TPU kernels' only by the
// order of the f32 sums.
//   flash_fwd: online softmax over 64-key k-tiles 0..the diagonal, running
//     max from -1e30, p = exp(s - m_new) rounded to bf16 against it, l
//     summed from the f32 p, acc = acc corr + bf16(p) V, then out = acc / l
//     and lse = m + log(l). Only the diagonal tile masks. The k-tile is
//     part of the result (the running max p is taken against), so it stays
//     the plain twin's 64.
//   flash_dq:  per q-tile, over k-tiles 0..the diagonal: p = exp(s - lse)
//     (masked), dp = dO V^T, ds = bf16(p * (dp - delta)), dq += ds K.
//   flash_dkv: per k-tile, over q-tiles from the diagonal to the end:
//     dv += bf16(p)^T dO, dk += ds^T Q.
// Every output tile has one owner block, so there are no atomics and two
// calls give the same bits. Every exponential is 2^(x log2(e) - m
// log2(e)) (p = exp(s - m_new) and corr in the forward, p = exp(s - lse)
// in the backward): exp2f (2 ulp) in the backward, the bare ex2.approx.ftz
// in the forward (exp2_ftz); lse's logf is the accurate one. The results
// stay within the same limits against the twins' accurate exp. Build
// without --use_fast_math.
//
// What bounds them on this card. At BASELINE config #7's shape (B=8,
// L=2048, H=16, D=64) the forward does 69 GFLOP of causal products and
// the backward kernels 103 and 137: at the tensor cores' 989 TFLOP/s they
// are bound by operations (0.069, 0.104 and 0.139 ms); the forward's f32
// caller adds bytes (q, k, v read in f32, out written: 269 MB, 0.080 ms at
// 3.35 TB/s). The TPU kernel keeps all of K and V of a head in VMEM; a
// Hopper block cannot, and its blocks run in parallel in no order. So
// every kernel is built to keep the tensor cores fed:
// - Products are wgmma on 64-row warpgroup tiles, bf16 operands, f32
//   accumulators.
// - Loads are TMA behind mbarriers. A producer warp's lane 0 issues every
//   copy into a ring of kStages stages and waits on each stage's "empty"
//   barrier; the consumers wait on its "full" barrier and free the stage
//   after their last product on it. No __syncthreads around a product.
// - The tensor maps are 4-D over the model's layout, dims (D, H, L, B),
//   box (min(DP, 64), 1, rows, 1), encoded on the host from the wrapper's
//   geometry (tma_geometry) with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__
//   kernel parameters. TMA's zero fill past D and past L takes the place
//   of padding. A tile lands in the 128-byte swizzle (64 bf16 a row; D =
//   128 takes two column boxes, D = 256 four) or, at DP = 32, the 64-byte
//   one: the layouts wgmma's descriptors read.
// - Scores (S = Q K^T, dP = dO V^T; S^T = K Q^T, dP^T = V dO^T in dK/dV)
//   read both operands from shared memory, K-major. The products with p
//   or ds (acc += bf16(p) V, dq += ds K, dv += bf16(p)^T dO, dk += ds^T Q)
//   take A from registers: the accumulator layout of the scores is
//   wgmma's register A layout, so p and ds never touch shared memory;
//   their B (V, K, dO, Q) is read MN-major through wgmma's transpose flag,
//   no transposed copy and no 16-bit loads.
// - Longest blocks first: the forward and dQ reverse the q-tile index;
//   dK/dV's k-tile 0 loops over every q-tile.
//
// The forward: a block is a 128-row q-tile, two consumer warpgroups of 64
// rows (warps 0-7) and the producer warp (warp 8), 288 threads (at DP =
// 256 one warpgroup of 64 rows and the producer, below). The two
// warpgroups share every K/V tile of the ring (its "empty" barrier counts
// both), so a K/V tile crosses L2 once per 128 query rows. Warpgroup w's
// diagonal k-tile is 2 qt + w: warpgroup 0 stops before the block's last
// k-tile, which lies after all its rows; a block whose rows 64.. lie past
// L runs warpgroup 0 alone. Each warpgroup in turn computes its scores,
// waits, takes the online softmax and issues its P V product; the other
// warpgroup, and a second block on the SM, fill the tensor cores
// meanwhile. Two blocks fit at DP <= 64 only under 96 registers a thread
// (18 warps, five on one of the SM's four 16K-register files): the
// scores are zeroed before each product so that the last tile's stay
// dead, and the kernel takes 95. That plain order was timed against two
// levers on the H100 when the kernel was written (variants whose script
// is not kept): a warpgroup queueing the next tile's scores behind this
// tile's P V product (it needs about 107 registers, so one block an SM),
// and ping-pong turns on named barriers between the two warpgroups; both
// were slower.
//
// The backward: a block is one consumer warpgroup (warps 0-3) and the
// producer warp (warp 4); with two blocks on an SM (one at DP >= 128) one
// block's exponentials overlap the other's products. The dQ ring holds the
// K and V tiles; the dK/dV ring the Q and dO tiles, with their lse and
// delta rows written by the producer's lanes. dK/dV holds dk, dv, S^T and
// dP^T in registers: at DP = 128 its q-tile is 32 queries (64 + 64 + 16 +
// 16 floats a thread), else 64.
//
// DP = 256 (head dims 144 .. 256, zero-filled past D by TMA), a simple
// kernel first, one block an SM in all three:
// - Registers. ptxas allots registers by whole warpgroups, so a block of
//   two consumer warpgroups and the producer warp (288 threads) counts as
//   384 and caps a thread at 168; a block of one and the producer (160
//   threads) at 255. The forward's O accumulator is 64 x 256 f32 over a
//   warpgroup, 128 floats a thread, with 32 of scores and 16 of p: past
//   168 (built so, it spilled 360 bytes), so at DP = 256 the forward's
//   block is one warpgroup of 64 rows (fwd_groups), and a K/V tile crosses
//   L2 once per 64 query rows instead of 128. dQ's accumulator (128) with S
//   and dP (32 + 32) fits 255 (218 registers, no spill). P V and dS K are
//   wgmma m64n256k16, the widest N it has; S and dP take 16 k-steps of
//   m64n64k16.
// - dK/dV: one warpgroup's dk and dv over all of D would be 128 + 128
//   floats a thread before S^T and dP^T, past 255 at any q-tile. So two
//   blocks share each k-tile (dkv_halves, blockIdx.z), each computing the
//   whole S^T and dP^T over all of D and owning half of D of dk and dv (64
//   + 64 + 16 + 16 floats a thread, as at DP = 128): the two score
//   products are computed twice, 6 products' work where the function needs
//   4, and each block loads the same K, V, Q and dO tiles. Not taken: two
//   consumer warpgroups in one block sharing the tiles (the 168-register
//   cap above spilled 168 bytes), and one warpgroup owning dv (from P^T
//   alone) and another dk (from dS^T, which needs S^T and dP^T): 5
//   products' work, but the dk side does 3 products to the dv side's 2,
//   the same critical path, with a code path for each and the same cap.
// - Shared memory. dQ's Q and dO tiles (64 KB) and three stages of a
//   64-key K and V tile (64 KB each) would be 256 KB against the 227 KB a
//   block may have: dQ's K/V ring is 2 stages deep at DP = 256 (kv_stages,
//   192 KB), and the forward's, which holds one Q tile, takes the same
//   depth (160 KB; three stages would just fit). dK/dV holds K
//   and V (64 KB) and three stages of 32-query Q and dO tiles (96 KB): 160
//   KB, its ring stays 3 deep.

#include <cuda.h>  // CUtensorMap and the encoder's types; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;               // rows of a q-tile, keys of a k-tile
constexpr float kNeg = -1e30f;          // _NEG of the TPU kernel

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// wgmma on tiles that TMA brings into shared memory.

constexpr int kStages = 3;        // depth of a load ring (but kv_stages)
constexpr int kBwdThreads = 160;  // dQ: one consumer warpgroup + the producer
constexpr int kProducer = 4;      // dQ's producer warp
// exp(x - m) is taken as exp2f(x log2(e) - m log2(e)), one fused
// multiply-add and the hardware's base-2 exponential, where the accurate
// expf costs a longer instruction sequence. The two were timed against
// each other in the backward kernels on the H100 when they were written;
// the script of that comparison is not kept.
constexpr float kLog2e = 1.4426950408889634f;

// The head dim a tile holds (zeros past D): 32, 64, 128 or 256.
template <int DP>
__host__ __device__ constexpr int box_cols() {  // columns of a box
  return DP < 64 ? DP : 64;
}
template <int DP>
__host__ __device__ constexpr int swizzle_bytes() {  // 64 or 128
  return 2 * box_cols<DP>();
}
// dK/dV's q-tile, the N of its score products, and the rows of every TMA
// box: 64, or 32 at DP >= 128 so that dK, dV and the two score tiles fit in
// one thread's registers (and, at DP = 256, three stages of Q and dO fit in
// shared memory).
template <int DP>
__host__ __device__ constexpr int q_tile() { return DP >= 128 ? 32 : 64; }
// Depth of the forward's and dQ's K/V ring: kStages, or 2 at DP = 256,
// where the 64 KB of Q (or Q and dO) and three 64 KB stages of K and V
// would pass the 227 KB a block may have.
template <int DP>
__host__ __device__ constexpr int kv_stages() {
  return DP == 256 ? 2 : kStages;
}
// The forward's consumer warpgroups, each 64 query rows of the block's
// q-tile: two (288 threads with the producer warp), or one at DP = 256
// (160 threads), whose 128-float accumulator needs more registers than a
// 288-thread block may give (ptxas allots registers by whole warpgroups,
// so 288 threads cap a thread at 168).
template <int DP>
__host__ __device__ constexpr int fwd_groups() { return DP == 256 ? 1 : 2; }
template <int DP>
__host__ __device__ constexpr int fwd_threads() {
  return 128 * fwd_groups<DP>() + 32;
}
// The blocks of one dK/dV k-tile, each owning NC = DP / halves columns of
// dk and dv: one, or two at DP = 256 (one warpgroup's dk and dv over all
// of D would be 256 floats a thread).
template <int DP>
__host__ __device__ constexpr int dkv_halves() { return DP == 256 ? 2 : 1; }

// The dynamic shared memory a block asks for: 1024 bytes of alignment
// slack, the tiles it keeps (the forward's fwd_groups Q tiles, dQ's Q and
// dO, dK/dV's K and V), its ring's stages (a K and a V tile; dK/dV a
// q-tile of Q and dO and its lse and delta rows) and an 8-byte barrier for
// each load it waits on. Each fits the 227 KB a block may have on the H100
// (checked below for every tile width), and flash_shared_bytes reports it.
constexpr size_t kSmemLimit = 227 * 1024;
template <int DP>
constexpr size_t fwd_smem() {
  return 1024 + (fwd_groups<DP>() + 2 * kv_stages<DP>()) * kTile * DP * 2 +
         8 * (1 + 2 * kv_stages<DP>());
}
template <int DP>
constexpr size_t dq_smem() {
  return 1024 + (2 + 2 * kv_stages<DP>()) * kTile * DP * 2 +
         8 * (1 + 2 * kv_stages<DP>());
}
template <int DP>
constexpr size_t dkv_smem() {
  return 1024 + 2 * kTile * DP * 2 +
         kStages * (2 * q_tile<DP>() * DP * 2 + 2 * q_tile<DP>() * 4) +
         8 * (1 + 2 * kStages);
}
template <int DP>
constexpr bool smem_fits() {
  return fwd_smem<DP>() <= kSmemLimit && dq_smem<DP>() <= kSmemLimit &&
         dkv_smem<DP>() <= kSmemLimit;
}
static_assert(smem_fits<32>() && smem_fits<64>() && smem_fits<128>() &&
                  smem_fits<256>(),
              "a flash kernel's block asks for more shared memory than 227 KB");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Wait for the completion of the barrier's phase of this parity. A phase
// that never completes (a lost copy) traps after about 2^28 tries, seconds
// of waiting, so that the launch fails with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++tries == (1u << 28)) __trap();
  } while (!done);
}

// One box of a [B, L, H, D] tensor map (dims D, H, L, B) into shared
// memory at `dst`: columns c0.., head h, rows r0.., batch b. Elements past
// D or L land as zeros.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int h, int r0,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(h), "r"(r0), "r"(b)
      : "memory");
}

// Rows r0..r0+R-1 of one (batch, head) slice as an R x DP bf16 tile: one
// [R][box_cols] block per column box, each row of it one swizzle span
// (the 64- or 128-byte swizzle that wgmma's descriptors read). R * DP * 2
// bytes arrive on `bar`.
template <int DP, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int r0, int b) {
  constexpr int BC = box_cols<DP>(), BR = q_tile<DP>();
#pragma unroll
  for (int cb = 0; cb < DP / BC; ++cb)
#pragma unroll
    for (int rb = 0; rb < R / BR; ++rb)
      tma_box(dst + (cb * R + rb * BR) * BC * 2, map, bar, cb * BC, h,
              r0 + rb * BR, b);
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets, and the swizzle (1 = 128 bytes, 2 = 64 bytes).
template <int SW>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)(SW == 128 ? 1 : 2) << 62);
}

// k-step kk (16 columns) of an R x DP tile read K-major: the tile's rows
// are the product's M or N, its columns the K. Within a swizzle span the
// step moves the start by 32 bytes; 8-row groups lie a span * 8 apart.
template <int DP, int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  constexpr int BC = box_cols<DP>(), RB = 2 * BC;
  return desc<swizzle_bytes<DP>()>(
      tile + (kk * 16 / BC) * R * RB + (kk * 16 % BC) * 2, 16, 8 * RB);
}
// k-step kk (16 rows) of an R x DP tile read MN-major (wgmma's transpose
// flag): the tile's rows are the product's K, its columns the N. Groups of
// 8 rows lie a span * 8 apart (stride offset), column boxes R spans apart
// (leading offset).
template <int DP, int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  constexpr int BC = box_cols<DP>(), RB = 2 * BC;
  return desc<swizzle_bytes<DP>()>(tile + kk * 16 * RB, R * RB, 8 * RB);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x N f32 over the warpgroup, N/2 a thread) (+)= A * B on one k-step
// of 16: A and B from shared memory, both K-major (wgmma_ss); or A from
// registers (the accumulator layout's pairs, as mma.sync's A fragment) and
// B MN-major (wgmma_rs). scale_d = 0 overwrites d. Lane (g, t) of warp w
// holds d[4j + e] = D[16w + g + 8(e/2)][8j + 2t + e%2].
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, "
      "%68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, "
      "%101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Keep the compiler from moving reads or writes of these registers across
// this point: a wgmma's results exist only after its wait, and its A
// registers must hold their values until then.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// bf16(x) as the A fragments of a product whose K is x's N: x is a 64 x K
// accumulator, and its layout is the register A layout of wgmma, so x
// never leaves registers.
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K / 4],
                                       const float (&x)[K / 2]) {
#pragma unroll
  for (int i = 0; i < K / 4; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// acc (64 x N over the warpgroup) += A * N columns of the R x DP tile
// whose first column box is at `tile`, read MN-major (its R = K rows are
// the product's K), A in registers (pack_a). N = DP takes the whole tile.
template <int DP, int R, int N = DP>
__device__ __forceinline__ void frags_times_tile_mn(float (&acc)[N / 2],
                                                    const uint32_t (&a)[R / 4],
                                                    uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    wgmma_rs(acc, f, mnmajor<DP, R>(tile, kk), 1);
  }
}

// s (64 x N) = A * B^T over DP: A the 64-row tile `at`, B the N-row tile
// `bt`, both K-major.
template <int DP, int N>
__device__ __forceinline__ void tile_times_tile_t(float (&s)[N / 2],
                                                  uint32_t at, uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss(s, kmajor<DP, kTile>(at, kk), kmajor<DP, N>(bt, kk), kk);
}

// Write the warpgroup's 64 x DP accumulator to a [B, L, H, D] output:
// this thread's rows `row` (the tile's first row + 16w + g) and row + 8,
// rows < L and columns < D.
template <typename T, int DP>
__device__ __forceinline__ void store_tile(T* dst, const float (&acc)[DP / 2],
                                           int row, int L, int D, size_t rs,
                                           int t) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col >= D) continue;
    if (row < L)
      store_pair(dst + (size_t)row * rs + col, acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < L)
      store_pair(dst + (size_t)(row + 8) * rs + col, acc[4 * j + 2],
                 acc[4 * j + 3]);
  }
}

// 1024-byte aligned shared memory (the 128-byte swizzle repeats every 8
// rows of 128 bytes, and TMA and the descriptors assume that alignment).
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// 2^x by the exponential unit's own instruction, results below 2^-126
// flushed to zero. exp2f adds a fix-up for such results; a p that small
// moves neither bf16(p) V nor l at f32 level. On the H100 the forward
// read the same errors against its twin at every test shape either way,
// and the fix-up on every score cost it about a tenth of its time.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One k-tile of the online softmax on the scores s (a 64 x 64 accumulator
// of the warpgroup; this thread's rows are wr and wr + 8 of its 64, with
// the keys' columns 8j + 2t + e%2). On the diagonal tile a key after its
// query is masked. The running max m and sum l advance; s becomes p =
// exp(s - m_new) in f32, and corr = exp(m_old - m_new), the factor the
// accumulator takes before this tile's bf16(p) V is added.
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2], bool diag,
                                               int wr, int t) {
  if (diag) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j * 8 + 2 * t + (e & 1) > wr + 8 * (e >> 1))
          s[4 * j + e] = -CUDART_INF_F;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float ml[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = quad_max(mx[r]);
    corr[r] = exp2_ftz((m[r] - mn) * kLog2e);
    m[r] = mn;
    ml[r] = mn * kLog2e;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(fmaf(s[4 * j + e], kLog2e, -ml[e >> 1]));
      s[4 * j + e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
}

template <int DP>
__device__ __forceinline__ void rescale(float (&acc)[DP / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    acc[4 * i] *= corr[0];
    acc[4 * i + 1] *= corr[0];
    acc[4 * i + 2] *= corr[1];
    acc[4 * i + 3] *= corr[1];
  }
}

// out and lse for one q-tile of FW x 64 rows of one (batch, head) (FW =
// fwd_groups: 128 rows, or 64 at DP = 256): the producer warp loads the
// q-tile's 64-row Q tiles once, then the K and V tiles of the k-tiles 0 ..
// FW qt + FW - 1 (none past L) into a ring of kv_stages; consumer
// warpgroup w owns rows 64w .. 64w + 63 of the tile, whose diagonal k-tile
// is FW qt + w. Each k-tile: S = Q K^T (wgmma, shared-memory operands),
// the online softmax, acc = acc corr + bf16(p) V (A from registers, V
// read MN-major); every warpgroup frees the stage. Then out = acc / l and
// lse = m + log(l).
template <typename T, int DP>
__global__ void __launch_bounds__(fwd_threads<DP>(), DP >= 128 ? 1 : 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
                 float* __restrict__ lse, int L, int H, int D) {
  constexpr uint32_t TILE = kTile * DP * 2;
  constexpr int NS = kv_stages<DP>(), FW = fwd_groups<DP>(), QR = FW * kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t qs = aligned_smem(smem);  // warpgroup w's Q at qs + w TILE
  const uint32_t ring = qs + FW * TILE;    // stage s: K at 2s, V at 2s + 1
  const uint32_t bars = ring + 2 * NS * TILE;
  const uint32_t qbar = bars, full = bars + 8, empty = full + 8 * NS;
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  // The k-tiles that reach the block's rows, none past L; warpgroup 1 runs
  // only where some of its rows lie before L.
  const int nk = min(FW * qt + FW, (L + kTile - 1) / kTile);
  const bool two = FW == 2 && qt * QR + kTile < L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, two ? 256 : 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * FW) {  // the producer, after the consumers' warps
    if (lane == 0) {
      mbar_expect_tx(qbar, (two ? 2 : 1) * TILE);
      tma_tile<DP, kTile>(qs, &tq, qbar, h, qt * QR, b);
      if (two)
        tma_tile<DP, kTile>(qs + TILE, &tq, qbar, h, qt * QR + kTile, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % NS;
        const uint32_t f = full + 8 * s, st = ring + 2 * s * TILE;
        mbar_wait(empty + 8 * s, ((kt / NS) & 1) ^ 1);
        mbar_expect_tx(f, 2 * TILE);
        tma_tile<DP, kTile>(st, &tk, f, h, kt * kTile, b);
        tma_tile<DP, kTile>(st + TILE, &tv, f, h, kt * kTile, b);
      }
    }
    return;
  }

  const int wg = warp / 4;
  if (wg == 1 && !two) return;
  const int g = lane / 4, t = lane % 4, wr = (warp % 4) * 16 + g;
  const int diag = FW * qt + wg;  // this warpgroup's diagonal k-tile
  // Warpgroup 0 of two stops at its diagonal: nothing waits for it to free
  // the stage of k-tile 2 qt + 1, the last one loaded.
  const int last = min(diag, nk - 1);
  const int row = qt * QR + wg * kTile + wr;  // and row + 8
  const uint32_t qw = qs + wg * TILE;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, corr[2];
  float sc[32];
  uint32_t a[kTile / 4];

  mbar_wait(qbar, 0);
  for (int kt = 0; kt <= last; ++kt) {
    const int s = kt % NS;
    const uint32_t ks = ring + 2 * s * TILE, vs = ks + TILE;
    mbar_wait(full + 8 * s, (kt / NS) & 1);
    // The product overwrites sc; zeros tell the compiler that the last
    // tile's scores (packed into a since) need not stay alive up to here.
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wg_fence();
    tile_times_tile_t<DP, kTile>(sc, qw, ks);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    online_softmax(sc, m, l, corr, kt == diag, wr, t);
    rescale<DP>(acc, corr);
    pack_a<kTile>(a, sc);
    fence_regs(acc);
    wg_fence();
    frags_times_tile_mn<DP, kTile>(acc, a, vs);
    wg_commit();
    wg_wait_all();
    fence_regs(a);
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }
  // out = acc / l, as the TPU kernel divides (not a multiply by 1/l).
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    acc[4 * i] /= l[0];
    acc[4 * i + 1] /= l[0];
    acc[4 * i + 2] /= l[1];
    acc[4 * i + 3] /= l[1];
  }
  store_tile<T, DP>(out + ((size_t)b * L * H + h) * D, acc, row, L, D,
                    (size_t)H * D, t);
  if (t == 0) {
    float* lrow = lse + (size_t)bh * L;
    if (row < L) lrow[row] = m[0] + logf(l[0]);
    if (row + 8 < L) lrow[row + 8] = m[1] + logf(l[1]);
  }
}

// dq for one 64-row q-tile of one (batch, head): the producer warp loads
// the Q and dO tiles once, then the K and V tiles of k-tiles 0..the
// diagonal into a ring of kv_stages; the consumer warpgroup computes
// S = Q K^T and dP = dO V^T (wgmma, shared-memory operands), p =
// exp(s - lse) (masked on the diagonal tile), ds = p (dp - delta), and
// dq += bf16(ds) K (A from registers, K read MN-major), then frees the
// stage.
template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads, DP >= 128 ? 1 : 2)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int L,
                int H, int D) {
  constexpr uint32_t TILE = kTile * DP * 2;
  constexpr int NS = kv_stages<DP>();
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t qs = aligned_smem(smem), dos = qs + TILE;
  const uint32_t ring = qs + 2 * TILE;  // stage s: K at 2s, V at 2s + 1
  const uint32_t bars = ring + 2 * NS * TILE;
  const uint32_t qbar = bars, full = bars + 8, empty = full + 8 * NS;
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducer) {
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * TILE);
      tma_tile<DP, kTile>(qs, &tq, qbar, h, qt * kTile, b);
      tma_tile<DP, kTile>(dos, &tdo, qbar, h, qt * kTile, b);
      for (int kt = 0; kt <= qt; ++kt) {
        const int s = kt % NS;
        const uint32_t f = full + 8 * s, st = ring + 2 * s * TILE;
        mbar_wait(empty + 8 * s, ((kt / NS) & 1) ^ 1);
        mbar_expect_tx(f, 2 * TILE);
        tma_tile<DP, kTile>(st, &tk, f, h, kt * kTile, b);
        tma_tile<DP, kTile>(st + TILE, &tv, f, h, kt * kTile, b);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int qrow = qt * kTile + warp * 16 + g;  // and qrow + 8
  float lr[2], dr[2];  // lse log2(e), delta of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    lr[r] = row < L ? lse[(size_t)bh * L + row] * kLog2e : 0.f;
    dr[r] = row < L ? delta[(size_t)bh * L + row] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int kt = 0; kt <= qt; ++kt) {
    const int s = kt % NS;
    const uint32_t ks = ring + 2 * s * TILE, vs = ks + TILE;
    mbar_wait(full + 8 * s, (kt / NS) & 1);
    float sc[32], dp[32];
    wg_fence();
    tile_times_tile_t<DP, kTile>(sc, qs, ks);
    tile_times_tile_t<DP, kTile>(dp, dos, vs);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    if (kt == qt) {  // the diagonal tile: a key after the query gets p = 0
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * t + (e & 1) > warp * 16 + g + 8 * (e >> 1))
            sc[4 * j + e] = -CUDART_INF_F;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2f(fmaf(sc[4 * j + e], kLog2e, -lr[r]));
        sc[4 * j + e] = p * (dp[4 * j + e] - dr[r]);  // ds, bf16 below
      }
    uint32_t a[kTile / 4];
    pack_a<kTile>(a, sc);
    fence_regs(acc);
    wg_fence();
    frags_times_tile_mn<DP, kTile>(acc, a, ks);
    wg_commit();
    wg_wait_all();
    fence_regs(a);
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }
  store_tile<T, DP>(dq + ((size_t)b * L * H + h) * D, acc, qrow, L, D,
                    (size_t)H * D, t);
}

// dk and dv, columns NC z .. NC z + NC - 1 (z = blockIdx.z, NC = DP /
// dkv_halves), for one 64-key k-tile of one (batch, head): the producer
// warp loads the K and V tiles once, then, for each q-tile from the
// diagonal to the end, the Q and dO tiles and their lse and delta rows
// into the ring; the consumer warpgroup computes the transposed scores S^T
// = K Q^T and dP^T = V dO^T over all of D, p (masked where the query
// precedes the key or lies past L), dv += bf16(p)^T dO and dk += ds^T Q
// over its columns (A from registers, dO and Q read MN-major), then frees
// the stage.
template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads, DP >= 128 ? 1 : 2)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int L, int H, int D) {
  constexpr int QT = q_tile<DP>(), NC = DP / dkv_halves<DP>();
  constexpr uint32_t KTILE = kTile * DP * 2, QTILE = QT * DP * 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ks = aligned_smem(smem), vs = ks + KTILE;
  const uint32_t ring = ks + 2 * KTILE;  // stage s: Q at 2s, dO at 2s + 1
  // stage s's rows: lse log2(e), then delta, QT floats each
  const uint32_t rows = ring + 2 * kStages * QTILE;
  float* rows_p = reinterpret_cast<float*>(smem + (rows - smem_u32(smem)));
  const uint32_t bars = rows + 2 * kStages * QT * 4;
  const uint32_t kvbar = bars, full = bars + 8, empty = full + 8 * kStages;
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int kt = blockIdx.y;  // k-tile 0 loops over every q-tile: first
  const int q0 = kt * kTile / QT, nq = (L + QT - 1) / QT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);  // every producer lane writes rows
      mbar_init(empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducer) {
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * KTILE);
      tma_tile<DP, kTile>(ks, &tk, kvbar, h, kt * kTile, b);
      tma_tile<DP, kTile>(vs, &tv, kvbar, h, kt * kTile, b);
    }
    for (int qi = q0; qi < nq; ++qi) {
      const int i = qi - q0, s = i % kStages;
      const uint32_t f = full + 8 * s, st = ring + 2 * s * QTILE;
      mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
      float* lrow = rows_p + 2 * s * QT;
      for (int c = lane; c < QT; c += 32) {
        const int row = qi * QT + c;
        lrow[c] = row < L ? lse[(size_t)bh * L + row] * kLog2e : 0.f;
        lrow[QT + c] = row < L ? delta[(size_t)bh * L + row] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(f, 2 * QTILE);
        tma_tile<DP, QT>(st, &tq, f, h, qi * QT, b);
        tma_tile<DP, QT>(st + QTILE, &tdo, f, h, qi * QT, b);
      } else {
        mbar_arrive(f);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4, z = blockIdx.z;
  const int key = kt * kTile + warp * 16 + g;  // and key + 8
  // The block's columns z NC .. of a Q or dO tile: NC / 64 column boxes
  // of QT rows each.
  const uint32_t cols = z * (NC / box_cols<DP>()) * QT * 2 * box_cols<DP>();
  float dk_acc[NC / 2], dv_acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int qi = q0; qi < nq; ++qi) {
    const int i = qi - q0, s = i % kStages;
    const uint32_t qs = ring + 2 * s * QTILE, dos = qs + QTILE;
    const float* lrow = rows_p + 2 * s * QT;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    // The transposed scores: rows are the tile's 64 keys, columns the
    // q-tile's QT queries.
    float st[QT / 2], dpt[QT / 2];
    wg_fence();
    tile_times_tile_t<DP, QT>(st, ks, qs);
    tile_times_tile_t<DP, QT>(dpt, vs, dos);
    wg_commit();
    wg_wait_all();
    fence_regs(st);
    fence_regs(dpt);
    // Masked (p = 0) where the query precedes the key (the q-tiles that
    // reach into this k-tile) or lies past L (the last q-tile).
    if (qi * QT < kt * kTile + kTile || qi * QT + QT > L) {
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qrow = qi * QT + j * 8 + 2 * t + (e & 1);
          if (qrow >= L || qrow < key + 8 * (e >> 1))
            st[4 * j + e] = -CUDART_INF_F;
        }
    }
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const float p = exp2f(fmaf(st[4 * j + e], kLog2e, -lrow[c]));
        st[4 * j + e] = p;                                    // bf16 below
        dpt[4 * j + e] = p * (dpt[4 * j + e] - lrow[QT + c]);  // ds
      }
    uint32_t pa[QT / 4], da[QT / 4];
    pack_a<QT>(pa, st);
    pack_a<QT>(da, dpt);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wg_fence();
    frags_times_tile_mn<DP, QT, NC>(dv_acc, pa, dos + cols);
    frags_times_tile_mn<DP, QT, NC>(dk_acc, da, qs + cols);
    wg_commit();
    wg_wait_all();
    fence_regs(pa);
    fence_regs(da);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(empty + 8 * s);
  }
  const size_t base = ((size_t)b * L * H + h) * D + z * NC;
  const size_t rs = (size_t)H * D;
  store_tile<T, NC>(dk + base, dk_acc, key, L, D - z * NC, rs, t);
  store_tile<T, NC>(dv + base, dv_acc, key, L, D - z * NC, rs, t);
}

int check_shape(int B, int L, int H, int D) {
  if (B < 1 || L < 1 || H < 1 || D < 16 || D > 256 || D % 16 != 0 ||
      (L + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// A block's dynamic shared memory: above 48 KB the kernel has to be
// allowed it first.
template <typename K>
int prepare(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The tensor-map geometry the wrapper passes (ops/kernels/flash_attention.py
// tma_geometry), twelve int64: the dims (D, H, L, B) of a [B, L, H, D]
// bf16 tensor, the byte strides of dims 1-3, the box (columns, 1, rows, 1)
// and the swizzle span in bytes.
struct Geometry {
  long long dims[4], strides[3], box[4], swizzle;
};

// The kernels of head dim DP take only the geometry they were written
// for: the wrapper's helper and the kernels must agree.
template <int DP>
int check_geometry(const Geometry& g, int B, int L, int H, int D) {
  const bool ok =
      g.dims[0] == D && g.dims[1] == H && g.dims[2] == L && g.dims[3] == B &&
      g.strides[0] == 2LL * D && g.strides[1] == 2LL * H * D &&
      g.strides[2] == 2LL * L * H * D && g.box[0] == box_cols<DP>() &&
      g.box[1] == 1 && g.box[2] == q_tile<DP>() && g.box[3] == 1 &&
      g.swizzle == swizzle_bytes<DP>();
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled is a driver-API call: it is reached through the
// runtime's cudaGetDriverEntryPoint, so the library links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over one [B, L, H, D] bf16 tensor. Elements past D and L
// read as zeros. Returns 0, cudaErrorSymbolNotFound without the driver's
// encoder, or 1000 + the CUresult when the driver refuses the map.
int encode(CUtensorMap* map, const bf16* ptr, const Geometry& g) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = (cuuint64_t)g.dims[i];
    box[i] = (cuuint32_t)g.box[i];
  }
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)g.strides[i];
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      g.swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// The input maps of one call: q, k, v (and dO).
template <int DP, int N>
int encode_inputs(CUtensorMap (&m)[N], const bf16* const (&src)[N],
                  const Geometry& g, int B, int L, int H, int D) {
  int rc = check_geometry<DP>(g, B, L, H, D);
  for (int i = 0; rc == 0 && i < N; ++i) rc = encode(&m[i], src[i], g);
  return rc;
}

template <typename T, int DP>
int fwd(const bf16* q, const bf16* k, const bf16* v, T* out, float* lse,
        int B, int L, int H, int D, const Geometry& g, cudaStream_t s) {
  CUtensorMap m[3];
  const bf16* const src[3] = {q, k, v};
  int rc = encode_inputs<DP>(m, src, g, B, L, H, D);
  if (rc != 0) return rc;
  constexpr int FW = fwd_groups<DP>();
  const size_t bytes = fwd_smem<DP>();
  rc = prepare(flash_fwd_kernel<T, DP>, bytes);
  if (rc != 0) return rc;
  const dim3 grid(B * H, (L + FW * kTile - 1) / (FW * kTile));
  flash_fwd_kernel<T, DP><<<grid, fwd_threads<DP>(), bytes, s>>>(
      m[0], m[1], m[2], out, lse, L, H, D);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int dq_(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
        const float* lse, const float* delta, T* dq, int B, int L, int H,
        int D, const Geometry& g, cudaStream_t s) {
  CUtensorMap m[4];
  const bf16* const src[4] = {q, k, v, dout};
  int rc = encode_inputs<DP>(m, src, g, B, L, H, D);
  if (rc != 0) return rc;
  const size_t bytes = dq_smem<DP>();
  rc = prepare(flash_dq_kernel<T, DP>, bytes);
  if (rc != 0) return rc;
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  flash_dq_kernel<T, DP><<<grid, kBwdThreads, bytes, s>>>(
      m[0], m[1], m[2], m[3], lse, delta, dq, L, H, D);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
        const float* lse, const float* delta, T* dk, T* dv, int B, int L,
        int H, int D, const Geometry& g, cudaStream_t s) {
  CUtensorMap m[4];
  const bf16* const src[4] = {q, k, v, dout};
  int rc = encode_inputs<DP>(m, src, g, B, L, H, D);
  if (rc != 0) return rc;
  const size_t bytes = dkv_smem<DP>();
  rc = prepare(flash_dkv_kernel<T, DP>, bytes);
  if (rc != 0) return rc;
  const dim3 grid(B * H, (L + kTile - 1) / kTile, dkv_halves<DP>());
  flash_dkv_kernel<T, DP><<<grid, kBwdThreads, bytes, s>>>(
      m[0], m[1], m[2], m[3], lse, delta, dk, dv, L, H, D);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_any(const bf16* q, const bf16* k, const bf16* v, T* out, float* lse,
            int B, int L, int H, int D, const long long* geometry,
            void* stream) {
  int rc = check_shape(B, L, H, D);
  if (rc != 0) return rc;
  const Geometry& g = *reinterpret_cast<const Geometry*>(geometry);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return fwd<T, 32>(q, k, v, out, lse, B, L, H, D, g, s);
  if (D <= 64) return fwd<T, 64>(q, k, v, out, lse, B, L, H, D, g, s);
  if (D <= 128) return fwd<T, 128>(q, k, v, out, lse, B, L, H, D, g, s);
  return fwd<T, 256>(q, k, v, out, lse, B, L, H, D, g, s);
}

template <typename T>
int dq_any(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
           const float* lse, const float* delta, T* dq, int B, int L, int H,
           int D, const long long* geometry, void* stream) {
  int rc = check_shape(B, L, H, D);
  if (rc != 0) return rc;
  const Geometry& g = *reinterpret_cast<const Geometry*>(geometry);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return dq_<T, 32>(q, k, v, dout, lse, delta, dq, B, L, H, D, g, s);
  if (D <= 64)
    return dq_<T, 64>(q, k, v, dout, lse, delta, dq, B, L, H, D, g, s);
  if (D <= 128)
    return dq_<T, 128>(q, k, v, dout, lse, delta, dq, B, L, H, D, g, s);
  return dq_<T, 256>(q, k, v, dout, lse, delta, dq, B, L, H, D, g, s);
}

template <typename T>
int dkv_any(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
            const float* lse, const float* delta, T* dk, T* dv, int B, int L,
            int H, int D, const long long* geometry, void* stream) {
  int rc = check_shape(B, L, H, D);
  if (rc != 0) return rc;
  const Geometry& g = *reinterpret_cast<const Geometry*>(geometry);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D, g, s);
  if (D <= 64)
    return dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D, g, s);
  if (D <= 128)
    return dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D, g, s);
  return dkv<T, 256>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D, g, s);
}

template <int DP>
int smem_of(int kernel) {
  return kernel == 0   ? (int)fwd_smem<DP>()
         : kernel == 1 ? (int)dq_smem<DP>()
         : kernel == 2 ? (int)dkv_smem<DP>()
                       : -1;
}

}  // namespace

// The dynamic shared memory a block of kernel 0 (the forward), 1 (dQ) or 2
// (dK/dV) asks for at tile width dp (32, 64, 128 or 256), as its launch
// passes it; -1 for another kernel or width. Launches nothing.
extern "C" int flash_shared_bytes(int kernel, int dp, void* stream) {
  (void)stream;
  switch (dp) {
    case 32: return smem_of<32>(kernel);
    case 64: return smem_of<64>(kernel);
    case 128: return smem_of<128>(kernel);
    case 256: return smem_of<256>(kernel);
    default: return -1;
  }
}

// The forward: q, k, v [B, L, H, D] bf16 (an f32 caller's rounded once)
// -> out [B, L, H, D], written in f32 (flash_fwd_f32) or bf16, and lse
// [B*H, L] f32; geometry is the wrapper's tensor-map geometry (twelve
// int64, see Geometry). Returns a cudaError_t, or 1000 + the CUresult of a
// refused tensor map.
extern "C" int flash_fwd_f32(const bf16* q, const bf16* k, const bf16* v,
                             float* out, float* lse, int B, int L, int H,
                             int D, const long long* geometry, void* stream) {
  return fwd_any<float>(q, k, v, out, lse, B, L, H, D, geometry, stream);
}
extern "C" int flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                              bf16* out, float* lse, int B, int L, int H,
                              int D, const long long* geometry,
                              void* stream) {
  return fwd_any<bf16>(q, k, v, out, lse, B, L, H, D, geometry, stream);
}

// dq from q, k, v, dO [B, L, H, D] bf16 (an f32 caller's rounded once) and
// lse, delta [B*H, L] f32, written in f32 (flash_dq_f32) or bf16; geometry
// is the wrapper's tensor-map geometry (twelve int64, see Geometry).
// Returns a cudaError_t, or 1000 + the CUresult of a refused tensor map.
extern "C" int flash_dq_f32(const bf16* q, const bf16* k, const bf16* v,
                            const bf16* dout, const float* lse,
                            const float* delta, float* dq, int B, int L,
                            int H, int D, const long long* geometry,
                            void* stream) {
  return dq_any<float>(q, k, v, dout, lse, delta, dq, B, L, H, D, geometry,
                       stream);
}
extern "C" int flash_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                             const bf16* dout, const float* lse,
                             const float* delta, bf16* dq, int B, int L,
                             int H, int D, const long long* geometry,
                             void* stream) {
  return dq_any<bf16>(q, k, v, dout, lse, delta, dq, B, L, H, D, geometry,
                      stream);
}

// dk and dv from the same inputs.
extern "C" int flash_dkv_f32(const bf16* q, const bf16* k, const bf16* v,
                             const bf16* dout, const float* lse,
                             const float* delta, float* dk, float* dv, int B,
                             int L, int H, int D, const long long* geometry,
                             void* stream) {
  return dkv_any<float>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D,
                        geometry, stream);
}
extern "C" int flash_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                              const bf16* dout, const float* lse,
                              const float* delta, bf16* dk, bf16* dv, int B,
                              int L, int H, int D, const long long* geometry,
                              void* stream) {
  return dkv_any<bf16>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D,
                       geometry, stream);
}
