// GroupNorm (+ReLU), forward and backward, f32 or bf16, for Hopper (sm_90a).
//
// Replaces: distkeras_tpu/ops/pallas/groupnorm.py:_fwd_kernel (the
// pl.pallas_call in _fwd, :239) and :_bwd_kernel (the one in _bwd, :262),
// the custom-VJP pair behind group_norm. Input x is [B, N, C] in NHWC
// memory order (N = H*W), gamma and beta [C], G groups of Cg = C/G
// contiguous channels (flax's rule: channel c is in group c / Cg), n = N*Cg
// elements per (sample, group).
//
// Forward:  s, ss = sums of x and x^2 over each (sample, group), in f32;
//           mean = s/n, var = ss/n - mean^2 (one pass, biased, as the TPU
//           kernel does), inv = 1/sqrt(var + 1e-6);
//           y = x*a_c + b_c with a = inv*gamma, b = beta - mean*inv*gamma,
//           then ReLU if asked.
// Backward: the statistics again from the saved x (nothing else is kept);
//           xhat = (x - mean)*inv; with ReLU, dy is masked where
//           xhat*gamma + beta <= 0; per channel Sdy = sum dy and
//           Sdx = sum dy*xhat; m1 = sum_{c in g} gamma_c*Sdy_c / n,
//           m2 = sum_{c in g} gamma_c*Sdx_c / n;
//           dx = inv*(dy*gamma - m1 - xhat*m2); dgamma = sum_b Sdx,
//           dbeta = sum_b Sdy over the whole batch.
//
// What bounds it on this card: bytes, in principle. A few FLOPs per element
// against 4 or 8 bytes (forward: read x, write y) or 6 or 12 (backward:
// read x and dy, write dx), bf16 or f32; ResNet-50's stem slab at B=128
// moves 411 MB in the bf16 forward (0.123 ms at 3.35 TB/s) and 617 MB in
// the backward. In practice a block's sweeps run one after another with a
// cluster barrier between them, and the blocks of a wave run in step, so
// the card's memory idles while they reduce and compute: the backward's
// three sweeps reach about 40 % of the bound at the stem (PERF.md).
//
// The design. The TPU kernel keeps one sample's whole [N, C] slab in VMEM
// and reads it from HBM once: statistics, then the output, from VMEM. A
// Hopper block has 227 KB of shared memory; the stem's sample slab is 1.6 MB
// in bf16 (3.2 MB f32), and a (sample, group) slab at the stem is 2 channels
// (4 or 8 bytes) strided by C. So:
//   * A thread-block cluster owns one (sample, channel tile): ct channels of
//     whole groups, at least one 128-byte line wide where C allows (64 bf16
//     or 32 f32 channels; gn_tiling in ops/kernels/groupnorm.py, a plain
//     function the CPU tests hold). A thread reads V channels of a row as
//     one 16-byte vector (8 bf16 or 4 f32); the ct/V lanes of a row read a
//     whole line, and rows go down the block's threads.
//   * The cluster's K blocks split the slab's rows; K is the fewest whose
//     share fits shared memory, preferring two blocks an SM (256 threads,
//     at most 115,712 bytes each: one block's barriers and arithmetic
//     overlap the other's loads; 128 threads where a block's rows hold at
//     most 2048 vectors) where that keeps every row on chip, with a tile
//     half a line wide where a whole line cannot, else one block an SM
//     (512 threads, 232,448 bytes). K is 1, 2, 4 or 8 (portable) at every
//     ResNet-50 slab but the stem, which takes 16: past the portable size
//     (cudaFuncAttributeNonPortableClusterSizeAllowed), which an H100's
//     GPCs (16 to 18 SMs) hold. At the stem, clusters of 8 keep only 868
//     of a bf16 backward block's 1568 rows on chip; `tools/kernel_ab.py
//     --tilings` times that and one block an SM against this choice on
//     the card (PERF.md).
//   * Each block starts one cp.async copy of every cached row (x, then dy
//     in the backward) into shared memory at once, no registers held, so
//     a block keeps up to 200 KB of loads in flight; each thread later
//     reads only the vectors it copied, so it waits on its own copies
//     alone. Rows past what fits are read from global memory in each
//     sweep, the second time from L2: none at ResNet-50's slabs at
//     224x224; at the stem of a 448x448 image (224x224x64) 16 blocks keep
//     1736 of 3136 rows a block in the bf16 forward, 868 in the backward
//     (chip_smoke.py gn_uncached, the card tests).
//   * The sums. A thread sums its rows in order; the lanes of a warp that
//     share channels combine by a fixed shuffle tree, the warps in order
//     through shared memory, into per-channel block partials; after one
//     cluster barrier every block reads all K blocks' partials through
//     distributed shared memory in rank order and forms the same per-channel
//     totals and group statistics. No float atomics: two calls give the same
//     bits (chip_smoke.py repeatable_bits). A block must not exit while a
//     peer may still read its shared memory: it arrives on a cluster barrier
//     after its last remote read and waits on it before it exits.
//   * One launch a forward (gn_fwd: statistics, barrier, y). Two a backward:
//     gn_bwd (statistics, barrier, the masked sums, barrier, dx; rank 0 also
//     writes the per-(sample, channel) Sdx and Sdy into a [2, B, C] f32
//     buffer) and gn_param_grads (dgamma, dbeta: those partials summed over
//     samples in sample order, the TPU kernel's sequential-grid order). No
//     scratch but that buffer.
//
// bf16 (group_norm_fwd_bf16, group_norm_bwd_bf16; the storage type T of one
// templated body, as the TPU kernel runs one body for both): x, dy, gamma
// and beta are bf16 and widen exactly on load; the statistics, the ReLU
// mask and every sum stay f32 (the TPU kernel reads bf16 and computes in
// f32, ops/pallas/groupnorm.py:241); y and dx are rounded to bf16 (nearest
// even) as they are stored (:264), and dgamma and dbeta, f32 sums over the
// batch, once at the end (gamma's dtype, :290-291).
// inv is 1.0f / sqrtf (correctly rounded), not the approximate rsqrtf;
// build without --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-6f;
constexpr int kMaxSmem = 232448;  // shared memory a block may use
constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;  // rows a thread has in flight in a sweep

// Storage <-> f32: bf16 widens exactly on load and rounds to nearest even
// on store; f32 passes through.
__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T store_f(float v);
template <>
__device__ __forceinline__ float store_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V channels of one row, moved as one vector (16 bytes at V = 16 / size).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Shared memory of a block: `streams` caches [cached][ct] of T (x, and dy
// in the backward), the reduction rows [2][nred][ct], the published
// partials [2][2][ct], the gathered totals [2][ct] and the group values
// [4][ct / Cg], f32. Mirrored by ops/kernels/groupnorm.py gn_smem_bytes.
__host__ __device__ inline int red_rows(int ct, int V, int threads) {
  const int L = ct / V;
  return 32 % L == 0 ? threads / 32 : threads / L;
}
inline size_t gn_smem(int ct, int V, int threads, int cached, int esize,
                      int streams, int ng) {
  return (size_t)streams * align16((size_t)cached * ct * esize) +
         sizeof(float) * ((size_t)2 * red_rows(ct, V, threads) * ct +
                          6 * (size_t)ct + 4 * (size_t)ng);
}

// The block's share of the work and its place in it.
struct Tile {
  int b, rank, lane, sub, rowpar, L, ch, r0, nrows, ng, cg;
  bool active;
};

__device__ __forceinline__ Tile tile_of(const cg::cluster_group& cluster,
                                        int N, int C, int G, int ct, int V,
                                        int K) {
  Tile t;
  t.b = blockIdx.y;
  t.rank = (int)cluster.block_rank();
  t.L = ct / V;
  t.rowpar = blockDim.x / t.L;
  t.lane = threadIdx.x % t.L;
  t.sub = threadIdx.x / t.L;
  t.active = t.sub < t.rowpar;
  t.ch = (blockIdx.x / K) * ct + t.lane * V;
  const int rpb = (N + K - 1) / K;
  t.r0 = min(N, t.rank * rpb);
  t.nrows = min(N, t.r0 + rpb) - t.r0;
  t.cg = C / G;
  t.ng = ct / t.cg;
  return t;
}

// The block's per-channel sums of two per-thread sums a, b [V] into
// out[0][c], out[1][c], c < ct, in a fixed order: the lanes of a warp that
// share channels by a shuffle tree (where ct/V divides 32), then the rows
// of red in order. Ends with the block synchronised.
template <int V>
__device__ __forceinline__ void block_sums(float (&a)[V], float (&b)[V],
                                           const Tile& t, int ct, float* red,
                                           float* out) {
  const int nred = red_rows(ct, V, blockDim.x);
  float* ra = red;
  float* rb = red + (size_t)nred * ct;
  if (32 % t.L == 0) {
    for (int off = t.L; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
        b[j] += __shfl_xor_sync(0xffffffffu, b[j], off);
      }
    }
    if ((threadIdx.x & 31) < t.L) {
      const int w = threadIdx.x >> 5;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ra[w * ct + t.lane * V + j] = a[j];
        rb[w * ct + t.lane * V + j] = b[j];
      }
    }
  } else if (t.active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ra[t.sub * ct + t.lane * V + j] = a[j];
      rb[t.sub * ct + t.lane * V + j] = b[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ct; c += blockDim.x) {
    float sa = 0.0f, sb = 0.0f;
    for (int k = 0; k < nred; ++k) {
      sa += ra[k * ct + c];
      sb += rb[k * ct + c];
    }
    out[c] = sa;
    out[ct + c] = sb;
  }
}

// tot[0][c], tot[1][c] = the cluster's K blocks' pub[0][c], pub[1][c]
// summed in rank order, read through distributed shared memory.
__device__ __forceinline__ void gather(cg::cluster_group& cluster,
                                       float* pub, float* tot, int ct, int K) {
  for (int c = threadIdx.x; c < ct; c += blockDim.x) {
    float sa = 0.0f, sb = 0.0f;
    for (int r = 0; r < K; ++r) {
      const float* p = cluster.map_shared_rank(pub, r);
      sa += p[c];
      sb += p[ct + c];
    }
    tot[c] = sa;
    tot[ct + c] = sb;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One Pack from global to shared memory without registers (cp.async of 4,
// 8 or 16 bytes), completing in the thread's current cp.async group; a
// plain copy for a narrower Pack.
template <typename T, int V>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  constexpr int bytes = V * (int)sizeof(T);
  if constexpr (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (bytes >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(bytes)
                 : "memory");
  } else {
    *reinterpret_cast<Pack<T, V>*>(dst) =
        *reinterpret_cast<const Pack<T, V>*>(src);
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `PENDING` of the thread's cp.async groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Start copying the block's first n rows of src (its cached rows) into
// cache, each thread its own (row, lane) vectors, as one cp.async group:
// all of a block's cached rows are in flight at once, and each thread later
// reads only the vectors it copied, so waiting on its own group suffices.
template <typename T, int V>
__device__ __forceinline__ void prefetch_rows(const T* __restrict__ src,
                                              T* cache, const Tile& t, int C,
                                              int ct, int n) {
  if (t.active) {
    for (int r = t.sub; r < n; r += t.rowpar) {
      copy_async<T, V>(cache + (size_t)r * ct + t.lane * V,
                       src + (size_t)r * C);
    }
  }
  cp_async_commit();
}

// The thread's first row at or past n (rows sub, sub + rowpar, ...).
__device__ __forceinline__ int first_row_from(const Tile& t, int n) {
  return t.sub + max(0, (n - t.sub + t.rowpar - 1) / t.rowpar) * t.rowpar;
}

// The first sweep of a block: each thread's sums of x and x^2 of its
// channels over its rows, those past the cache read from global memory
// (kUnroll rows in flight) while the cached ones land, then the cached ones
// from shared memory once at most PENDING cp.async groups remain.
template <typename T, int V, int PENDING>
__device__ __forceinline__ void sweep_stats(const T* __restrict__ xb,
                                            const T* cache, const Tile& t,
                                            int C, int ct, int n,
                                            float (&s)[V], float (&ss)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = ss[j] = 0.0f;
  auto add = [&](const Pack<T, V>& p) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = load_f(p.v[j]);
      s[j] += v;
      ss[j] += v * v;
    }
  };
  if (t.active) {
    for (int i = first_row_from(t, n); i < t.nrows;
         i += kUnroll * t.rowpar) {
      Pack<T, V> p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = i + u * t.rowpar;
        if (r < t.nrows) {
          p[u] = *reinterpret_cast<const Pack<T, V>*>(xb + (size_t)r * C);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u * t.rowpar < t.nrows) add(p[u]);
      }
    }
  }
  cp_async_wait<PENDING>();
  if (t.active) {
#pragma unroll 2
    for (int r = t.sub; r < n; r += t.rowpar) {
      add(*reinterpret_cast<const Pack<T, V>*>(cache + (size_t)r * ct +
                                               t.lane * V));
    }
  }
}

// stat[0][g], stat[1][g] = mean, inv of the tile's groups from the totals
// tot[0][c] (sum x), tot[1][c] (sum x^2), the group's channels in order.
__device__ __forceinline__ void group_stats(const float* tot, float* stat,
                                            const Tile& t, int ct,
                                            float inv_n) {
  for (int g = threadIdx.x; g < t.ng; g += blockDim.x) {
    float a0 = 0.0f, a1 = 0.0f;
    for (int k = 0; k < t.cg; ++k) {
      a0 += tot[g * t.cg + k];
      a1 += tot[ct + g * t.cg + k];
    }
    const float mean = a0 * inv_n;
    const float var = a1 * inv_n - mean * mean;
    stat[g] = mean;
    stat[t.ng + g] = 1.0f / sqrtf(var + kEps);
  }
}

// One launch: grid (tiles * K, B), clusters of K blocks along x.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
gn_fwd(const T* __restrict__ x, const T* __restrict__ gamma,
       const T* __restrict__ beta, T* __restrict__ y, int N, int C, int G,
       int ct, int K, int cached, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Tile t = tile_of(cluster, N, C, G, ct, V, K);
  T* cache = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(
      smem + align16((size_t)cached * ct * sizeof(T)));
  float* pub = red + (size_t)2 * red_rows(ct, V, blockDim.x) * ct;  // [2][ct]
  float* tot = pub + 4 * ct;                                        // [2][ct]
  float* stat = tot + 2 * ct;                                       // [2][ng]

  const size_t base = ((size_t)t.b * N + t.r0) * C + t.ch;
  const int n = min(cached, t.nrows);  // the block's cached rows
  prefetch_rows<T, V>(x + base, cache, t, C, ct, n);
  float s[V], ss[V];
  sweep_stats<T, V, 0>(x + base, cache, t, C, ct, n, s, ss);
  block_sums<V>(s, ss, t, ct, red, pub);
  cluster.sync();  // every block's partials are published
  gather(cluster, pub, tot, ct, K);
  __syncthreads();
  group_stats(tot, stat, t, ct, 1.0f / ((float)N * (float)t.cg));
  cluster_arrive();  // this block reads no peer any more
  __syncthreads();

  if (t.active) {
    float a[V], sh[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = (t.lane * V + j) / t.cg;
      const float mean = stat[g], inv = stat[t.ng + g];
      const float ga = load_f(gamma[t.ch + j]);
      a[j] = inv * ga;
      sh[j] = load_f(beta[t.ch + j]) - mean * inv * ga;
    }
#pragma unroll 2
    for (int r = t.sub; r < t.nrows; r += t.rowpar) {
      const Pack<T, V> p =
          r < cached ? *reinterpret_cast<const Pack<T, V>*>(
                           cache + (size_t)r * ct + t.lane * V)
                     : *reinterpret_cast<const Pack<T, V>*>(x + base +
                                                            (size_t)r * C);
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = load_f(p.v[j]) * a[j] + sh[j];
        if (relu && v < 0.0f) v = 0.0f;  // NaN kept
        o.v[j] = store_f<T>(v);
      }
      *reinterpret_cast<Pack<T, V>*>(y + base + (size_t)r * C) = o;
    }
  }
  cluster_wait();  // no block exits while a peer may still read it
}

// The backward's first launch: grid and clusters as gn_fwd. part [2][B][C]
// f32 receives Sdy (plane 0) and Sdx (plane 1) of each (sample, channel).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
gn_bwd(const T* __restrict__ x, const T* __restrict__ dy,
       const T* __restrict__ gamma, const T* __restrict__ beta,
       T* __restrict__ dx, float* __restrict__ part, int B, int N, int C,
       int G, int ct, int K, int cached, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Tile t = tile_of(cluster, N, C, G, ct, V, K);
  const size_t cbytes = align16((size_t)cached * ct * sizeof(T));
  T* xc = reinterpret_cast<T*>(smem);
  T* dc = reinterpret_cast<T*>(smem + cbytes);
  float* red = reinterpret_cast<float*>(smem + 2 * cbytes);
  float* pub = red + (size_t)2 * red_rows(ct, V, blockDim.x) * ct;  // [2][2][ct]
  float* tot = pub + 4 * ct;                                        // [2][ct]
  float* stat = tot + 2 * ct;  // [2][ng] mean, inv; then [2][ng] m1, m2
  float* coef = stat + 2 * t.ng;
  const float inv_n = 1.0f / ((float)N * (float)t.cg);

  // Sweep 1: the cached rows of x, then of dy, start landing in shared
  // memory; the statistics of x.
  const size_t base = ((size_t)t.b * N + t.r0) * C + t.ch;
  const int n = min(cached, t.nrows);  // the block's cached rows
  prefetch_rows<T, V>(x + base, xc, t, C, ct, n);
  prefetch_rows<T, V>(dy + base, dc, t, C, ct, n);
  {
    float s[V], ss[V];
    sweep_stats<T, V, 1>(x + base, xc, t, C, ct, n, s, ss);
    block_sums<V>(s, ss, t, ct, red, pub);
  }
  cluster.sync();
  gather(cluster, pub, tot, ct, K);
  __syncthreads();
  group_stats(tot, stat, t, ct, inv_n);
  __syncthreads();

  float mean[V], inv[V], ga[V], be[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int g = (t.lane * V + j) / t.cg;
    mean[j] = stat[g];
    inv[j] = stat[t.ng + g];
    ga[j] = t.active ? load_f(gamma[t.ch + j]) : 0.0f;
    be[j] = t.active ? load_f(beta[t.ch + j]) : 0.0f;
  }
  auto load_x = [&](int r) {
    return r < cached ? *reinterpret_cast<const Pack<T, V>*>(
                            xc + (size_t)r * ct + t.lane * V)
                      : *reinterpret_cast<const Pack<T, V>*>(x + base +
                                                             (size_t)r * C);
  };

  // Sweep 2: the masked per-channel sums of dy and dy * xhat; rows past the
  // caches from global memory (dy from HBM, x from L2), then the cached
  // rows once dy has landed.
  {
    float sdy[V], sdx[V];
#pragma unroll
    for (int j = 0; j < V; ++j) sdy[j] = sdx[j] = 0.0f;
    auto add = [&](const Pack<T, V>& px, const Pack<T, V>& pd) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (load_f(px.v[j]) - mean[j]) * inv[j];
        float d = load_f(pd.v[j]);
        if (relu && !(xh * ga[j] + be[j] > 0.0f)) d = 0.0f;
        sdy[j] += d;
        sdx[j] += d * xh;
      }
    };
    // Two rows in flight at V = 8: the eight channels' statistics,
    // coefficients and sums fill the 128 registers a thread has.
    constexpr int U = V == 8 ? 2 : kUnroll;
    if (t.active) {
      for (int i = first_row_from(t, n); i < t.nrows; i += U * t.rowpar) {
        Pack<T, V> pd[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = i + u * t.rowpar;
          if (r < t.nrows) {
            pd[u] = *reinterpret_cast<const Pack<T, V>*>(dy + base +
                                                         (size_t)r * C);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = i + u * t.rowpar;
          if (r < t.nrows) add(load_x(r), pd[u]);
        }
      }
    }
    cp_async_wait<0>();
    if (t.active) {
#pragma unroll 2
      for (int r = t.sub; r < n; r += t.rowpar) {
        add(load_x(r), *reinterpret_cast<const Pack<T, V>*>(
                           dc + (size_t)r * ct + t.lane * V));
      }
    }
    block_sums<V>(sdy, sdx, t, ct, red, pub + 2 * ct);
  }
  cluster.sync();
  gather(cluster, pub + 2 * ct, tot, ct, K);
  if (t.rank == 0) {
    const int c0 = t.ch - t.lane * V;  // the tile's first channel
    for (int c = threadIdx.x; c < ct; c += blockDim.x) {
      part[(size_t)t.b * C + c0 + c] = tot[c];
      part[((size_t)B + t.b) * C + c0 + c] = tot[ct + c];
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < t.ng; g += blockDim.x) {
    float a0 = 0.0f, a1 = 0.0f;
    for (int k = 0; k < t.cg; ++k) {
      const float gk = load_f(gamma[t.ch - t.lane * V + g * t.cg + k]);
      a0 += gk * tot[g * t.cg + k];
      a1 += gk * tot[ct + g * t.cg + k];
    }
    coef[g] = a0 * inv_n;
    coef[t.ng + g] = a1 * inv_n;
  }
  cluster_arrive();  // this block reads no peer any more
  __syncthreads();

  // Sweep 3: dx from the caches (or L2 past them).
  if (t.active) {
    float m1[V], m2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = (t.lane * V + j) / t.cg;
      m1[j] = coef[g];
      m2[j] = coef[t.ng + g];
    }
#pragma unroll 2
    for (int r = t.sub; r < t.nrows; r += t.rowpar) {
      const Pack<T, V> px = load_x(r);
      const Pack<T, V> pd =
          r < cached ? *reinterpret_cast<const Pack<T, V>*>(
                           dc + (size_t)r * ct + t.lane * V)
                     : *reinterpret_cast<const Pack<T, V>*>(dy + base +
                                                            (size_t)r * C);
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (load_f(px.v[j]) - mean[j]) * inv[j];
        float d = load_f(pd.v[j]);
        if (relu && !(xh * ga[j] + be[j] > 0.0f)) d = 0.0f;
        o.v[j] = store_f<T>(inv[j] * (d * ga[j] - m1[j] - xh * m2[j]));
      }
      *reinterpret_cast<Pack<T, V>*>(dx + base + (size_t)r * C) = o;
    }
  }
  cluster_wait();
}

// dbeta[c] = sum_b Sdy[b][c], dgamma[c] = sum_b Sdx[b][c], in sample order,
// stored in T.
template <typename T>
__global__ void gn_param_grads(const float* __restrict__ part,
                               T* __restrict__ dgamma, T* __restrict__ dbeta,
                               int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a0 = 0.0f, a1 = 0.0f;
  for (int b = 0; b < B; ++b) {
    a0 += part[(size_t)b * C + c];
    a1 += part[(size_t)(B + b) * C + c];
  }
  dbeta[c] = store_f<T>(a0);
  dgamma[c] = store_f<T>(a1);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

// The tiling the wrapper chose (ops/kernels/groupnorm.py gn_tiling), held
// to what the kernels are written for; returns the shared memory a block
// needs, or 0 where the tiling is refused.
template <typename T>
size_t check_tiling(int B, int N, int C, int G, int ct, int V, int threads,
                    int K, int cached, int streams) {
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || G <= 0 || C % G != 0) {
    return 0;
  }
  const int cgw = C / G;
  if (ct <= 0 || C % ct != 0 || ct % cgw != 0 || ct % V != 0) return 0;
  if (V * (int)sizeof(T) > 16 || (V & (V - 1)) != 0) return 0;
  const int L = ct / V;
  if (threads % 32 != 0 || threads > kMaxThreads || L > threads) return 0;
  if (K != 1 && K != 2 && K != 4 && K != 8 && K != 16) return 0;
  if (cached < 0 || cached > (N + K - 1) / K) return 0;
  if ((long long)(C / ct) * K > 2147483647LL) return 0;
  const size_t smem =
      gn_smem(ct, V, threads, cached, (int)sizeof(T), streams, ct / cgw);
  return smem <= (size_t)kMaxSmem ? smem : 0;
}

template <typename Kern>
cudaError_t launch_cluster(Kern kernel, dim3 grid, int threads, size_t smem,
                           int K, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute (&attr)[1]) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  if (K > 8) {  // 16: past the portable size, which the card allows
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int V>
int fwd_v(const T* x, const T* gamma, const T* beta, T* y, int B, int N,
          int C, int G, int ct, int threads, int K, int cached, int relu,
          size_t smem, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = launch_cluster(gn_fwd<T, V>, dim3(C / ct * K, B), threads,
                                   smem, K, s, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, gn_fwd<T, V>, x, gamma, beta, y, N, C, G, ct,
                           K, cached, relu);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const T* x, const T* gamma, const T* beta, T* y, int B, int N, int C,
        int G, int ct, int V, int threads, int K, int cached, int relu,
        void* stream) {
  const size_t smem =
      check_tiling<T>(B, N, C, G, ct, V, threads, K, cached, 1);
  if (smem == 0 || !aligned(x, V * sizeof(T)) || !aligned(y, V * sizeof(T))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (V) {
    case 1:
      return fwd_v<T, 1>(x, gamma, beta, y, B, N, C, G, ct, threads, K,
                         cached, relu, smem, s);
    case 2:
      return fwd_v<T, 2>(x, gamma, beta, y, B, N, C, G, ct, threads, K,
                         cached, relu, smem, s);
    case 4:
      return fwd_v<T, 4>(x, gamma, beta, y, B, N, C, G, ct, threads, K,
                         cached, relu, smem, s);
    default:
      if constexpr (sizeof(T) == 2) {
        return fwd_v<T, 8>(x, gamma, beta, y, B, N, C, G, ct, threads, K,
                           cached, relu, smem, s);
      }
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int V>
int bwd_v(const T* x, const T* dy, const T* gamma, const T* beta, T* dx,
          float* part, int B, int N, int C, int G, int ct, int threads, int K,
          int cached, int relu, size_t smem, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = launch_cluster(gn_bwd<T, V>, dim3(C / ct * K, B), threads,
                                   smem, K, s, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, gn_bwd<T, V>, x, dy, gamma, beta, dx, part,
                           B, N, C, G, ct, K, cached, relu);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const T* x, const T* dy, const T* gamma, const T* beta, T* dx,
        T* dgamma, T* dbeta, float* part, int B, int N, int C, int G, int ct,
        int V, int threads, int K, int cached, int relu, void* stream) {
  const size_t smem =
      check_tiling<T>(B, N, C, G, ct, V, threads, K, cached, 2);
  const int vb = V * (int)sizeof(T);
  if (smem == 0 || !aligned(x, vb) || !aligned(dy, vb) || !aligned(dx, vb)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (V) {
    case 1:
      rc = bwd_v<T, 1>(x, dy, gamma, beta, dx, part, B, N, C, G, ct, threads,
                       K, cached, relu, smem, s);
      break;
    case 2:
      rc = bwd_v<T, 2>(x, dy, gamma, beta, dx, part, B, N, C, G, ct, threads,
                       K, cached, relu, smem, s);
      break;
    case 4:
      rc = bwd_v<T, 4>(x, dy, gamma, beta, dx, part, B, N, C, G, ct, threads,
                       K, cached, relu, smem, s);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
      if constexpr (sizeof(T) == 2) {
        rc = bwd_v<T, 8>(x, dy, gamma, beta, dx, part, B, N, C, G, ct,
                         threads, K, cached, relu, smem, s);
      }
  }
  if (rc != 0) return rc;
  gn_param_grads<T><<<(C + 255) / 256, 256, 0, s>>>(part, dgamma, dbeta, B,
                                                    C);
  return (int)cudaGetLastError();
}

}  // namespace

// GroupNorm(+ReLU) forward (all f32, contiguous, on the device): x [B,N,C],
// gamma, beta [C] -> y [B,N,C], one launch. The tiling (ct channels a
// cluster, V channels a vector, threads a block, K blocks a cluster, the
// rows a block caches) is ops/kernels/groupnorm.py gn_tiling's; a tiling
// the kernel is not written for, or x or y not aligned to V elements, is
// refused (cudaErrorInvalidValue). Returns the cudaError_t of the launch.
extern "C" int group_norm_fwd_f32(const float* x, const float* gamma,
                                  const float* beta, float* y, int B, int N,
                                  int C, int G, int ct, int V, int threads,
                                  int K, int cached, int relu,
                                  void* stream) {
  return fwd<float>(x, gamma, beta, y, B, N, C, G, ct, V, threads, K, cached,
                    relu, stream);
}

// The same with x, gamma, beta and y in bf16.
extern "C" int group_norm_fwd_bf16(const __nv_bfloat16* x,
                                   const __nv_bfloat16* gamma,
                                   const __nv_bfloat16* beta,
                                   __nv_bfloat16* y, int B, int N, int C,
                                   int G, int ct, int V, int threads, int K,
                                   int cached, int relu, void* stream) {
  return fwd<__nv_bfloat16>(x, gamma, beta, y, B, N, C, G, ct, V, threads, K,
                            cached, relu, stream);
}

// The backward of group_norm_fwd_f32: x, dy [B,N,C], gamma, beta [C] ->
// dx [B,N,C], dgamma, dbeta [C], two launches; part [2, B, C] f32 is the
// caller's buffer for the per-(sample, channel) sums of dy and dy * xhat.
// Returns the cudaError_t of the launches.
extern "C" int group_norm_bwd_f32(const float* x, const float* dy,
                                  const float* gamma, const float* beta,
                                  float* dx, float* dgamma, float* dbeta,
                                  float* part, int B, int N, int C, int G,
                                  int ct, int V, int threads, int K,
                                  int cached, int relu, void* stream) {
  return bwd<float>(x, dy, gamma, beta, dx, dgamma, dbeta, part, B, N, C, G,
                    ct, V, threads, K, cached, relu, stream);
}

// The same with x, dy, gamma, beta, dx, dgamma and dbeta in bf16.
extern "C" int group_norm_bwd_bf16(const __nv_bfloat16* x,
                                   const __nv_bfloat16* dy,
                                   const __nv_bfloat16* gamma,
                                   const __nv_bfloat16* beta,
                                   __nv_bfloat16* dx, __nv_bfloat16* dgamma,
                                   __nv_bfloat16* dbeta, float* part, int B,
                                   int N, int C, int G, int ct, int V,
                                   int threads, int K, int cached, int relu,
                                   void* stream) {
  return bwd<__nv_bfloat16>(x, dy, gamma, beta, dx, dgamma, dbeta, part, B,
                            N, C, G, ct, V, threads, K, cached, relu, stream);
}
