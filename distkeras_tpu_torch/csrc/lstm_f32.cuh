// The f32 LSTM kernels' shared pieces (csrc/lstm_fwd.cu, csrc/lstm_bwd.cu):
// the cluster tilings, the distributed-shared-memory hand-off behind
// mbarriers, and the FFMA register tile of the tile products. build.py
// digests every .cuh of csrc/ into each library's name, so an edit here
// rebuilds both.
//
// Tilings. A cluster of C blocks owns a tile of R batch rows; block c owns
// the hidden units [c U, (c+1) U), U = H / C. Thread (slot s, row group g)
// owns the cells of rows g RT .. g RT + RT - 1 (contiguous) and local unit
// s (a warp's eight slots read eight consecutive units). In a warp, lane %
// 8 is the slot and lane / 8 the row group; warps tile slots first. The
// (R, C) pairs built are mirrored by ops/kernels/lstm.py F32_TILINGS.
//
// Hand-off. A block's values for its peers (h in the forward, the dh
// partials in the backward) go straight into each peer's shared memory by
// st.async, each store completing bytes on the peer's mbarrier for that
// buffer; the peer waits on the mbarrier's phase before it reads. Two
// buffers alternate. A writer reaches step t + 1's write only after it
// has every block's step t values, which each thread of each block sends
// after its own reads of the buffer it is about to overwrite, so the data
// dependency alone orders every write after the last read of its buffer:
// no cluster barrier a step. One thread re-arms a buffer's next phase
// (arrive + expect_tx of the bytes the phase receives) right after the
// phase it waited for completed; a store that lands before the re-arm
// leaves the tx-count negative, which the phase allows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm_f32 {

constexpr int kThreads = 512;  // the most threads of a block

// Rows a thread owns in a tile of R rows.
__host__ __device__ constexpr int rows_per_thread(int R) {
  return R == 16 ? 2 : 4;
}

// The most threads a block of the recurrent backward at (R, C) is built
// for: 256 at (32, 8), whose thread keeps 8 x 4 dh partials and two steps'
// stash and needs more than the 128 registers of a 512-thread block (no
// width past 256 threads fits its shared memory there), else kThreads.
__host__ __device__ constexpr int rec_max_threads(int R, int C) {
  return R == 32 && C == 8 ? 256 : kThreads;
}

// Whether (R, C) tiles H: U a multiple of 8 (a warp's slots), R of 4 RT
// (its row groups), at most kThreads threads (rec_max_threads(R, C) for
// the recurrent backward).
inline bool tiling_ok(int H, int R, int C, int max_threads = kThreads) {
  if (H <= 0 || C <= 0 || H % C != 0) return false;
  const int U = H / C, RT = rows_per_thread(R);
  if (U % 8 != 0 || R % (4 * RT) != 0) return false;
  return U * (R / RT) <= max_threads;
}

// The (R, C) pairs built, applied to a macro X(R, C): C = 1, 2, 4, 8 (8 is
// the largest portable cluster) at both R; ops/kernels/lstm.py
// F32_TILINGS names the same pairs and f32_tiling picks one by batch and
// by what holds H (whole warps of units, 512 threads, the shared memory):
// H=80 runs at (16, 2) and (32, 2), H=192 at (16, 8) and (32, 4), H=256 at
// (16, 8) and (32, 8).
// clang-format off
#define LSTM_F32_TILINGS(X) X(16, 8) X(16, 4) X(16, 2) X(16, 1) X(32, 8) X(32, 4) X(32, 2) X(32, 1)
// clang-format on

// The thread's slot and row group.
struct Slot {
  int s, g;
};
__device__ __forceinline__ Slot slot_of(int tid, int slots) {
  const int warp = tid >> 5, lane = tid & 31, sw = slots / 8;
  return {(warp % sw) * 8 + (lane & 7), (warp / sw) * 4 + (lane >> 3)};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of this block's shared-memory word `local` in block `rank`
// of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(local), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity. A phase
// that never completes traps after about 2^28 tries, seconds of waiting,
// so that the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++tries == (1u << 28)) __trap();
  } while (!done);
}

// RT contiguous floats (RT = 2, or a multiple of 4) into a peer's shared
// memory at cluster address `dst`, completing their bytes on the peer's
// mbarrier at cluster address `bar`.
template <int RT>
__device__ __forceinline__ void st_async(uint32_t dst, const float (&v)[RT],
                                         uint32_t bar) {
  static_assert(RT == 2 || RT % 4 == 0, "two floats or whole vectors of four");
  if constexpr (RT == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
        "{%1, %2}, [%3];\n" ::"r"(dst),
        "f"(v[0]), "f"(v[1]), "r"(bar)
        : "memory");
  } else {
#pragma unroll
    for (int q = 0; q < RT; q += 4) {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
          "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst + 4 * q),
          "f"(v[q]), "f"(v[q + 1]), "f"(v[q + 2]), "f"(v[q + 3]), "r"(bar)
          : "memory");
    }
  }
}

// RT contiguous floats from shared memory (RT = 2, or a multiple of 4).
template <int RT>
__device__ __forceinline__ void lds(float (&v)[RT], const float* p) {
  if constexpr (RT == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < RT; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  }
}

// RT contiguous floats into shared memory (RT = 2, or a multiple of 4).
template <int RT>
__device__ __forceinline__ void sts(float* p, const float (&v)[RT]) {
  if constexpr (RT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < RT; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  }
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[p][q] += a[p] b[q] over an 8 x 8 register tile: the inner step of
// the FFMA tile products (x . Wx, dWx/dWh, dx).
__device__ __forceinline__ void outer8(float (&acc)[8][8], float4 a0,
                                       float4 a1, float4 b0, float4 b1) {
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
}

}  // namespace lstm_f32
