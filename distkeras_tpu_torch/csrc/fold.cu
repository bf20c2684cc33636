// Dequant-fused commit fold, in place, f32 center, for Hopper (sm_90a):
// one launch folds a whole commit.
//
// Replaces: distkeras_tpu/ops/pallas/fold.py:_fold_kernel (pl.pallas_call in
// _folder), the netps server's compressed-domain fold, for every tensor of
// a commit at once:
//   center[i] = center[i] + s * dequant(w[i])
//   int8:  dequant(w) = float(w),             s = f32(scale * spec scale)
//   bf16:  dequant(w) = bitcast_f32(w << 16), s = f32(scale)
//   f32:   dequant(w) = w,                    s = f32(scale)
// (f32 is what the wire sends for a tensor it does not compress: a
// non-finite one, or one that was not f32; the server folded those with a
// torch add of its own.) `scale` is the discipline's commit scale. Each
// entry's s is the product of the commit scale and the entry's factor in
// double, rounded to f32 once (__dmul_rn, __double2float_rn), exactly as
// the host computes it (ops/kernels/fold.py fold_scale) and the numpy
// oracle rounds it (netps/fold.py fold_compressed_numpy). A compressed
// entry whose s is 0 is left alone, as the oracle leaves it.
//
// Bit-exactness: every center element is written by exactly one thread,
// the product and the sum rounded separately (__fmul_rn, __fadd_rn), never
// contracted into one FMA, with no atomics, so the result is bit-equal to
// numpy's `c + (d * s)` and to the plain PyTorch twin whatever the grid.
//
// Input: one staging buffer on the device (netps/fold.py stage_commit packs
// it on the host and copies it over in one piece), laid out by
// ops/kernels/fold.py plan_commit:
//   [E rows of FoldRow][E + 1 int64: the first tile of each entry, then
//   the total][payloads, each at a 16-byte aligned offset]
// A row gives its entry's center as an element offset from the center
// base the launch passes (the server seats every tensor of its flat center
// at a 64-byte offset), its payload's byte offset in the buffer, n, the
// factor and the kind.
//
// What bounds it on this card: bytes, and one launch a commit. Each
// element reads 4 bytes of center and 1 (int8), 2 (bf16) or 4 (f32) of
// wire, and writes 4 of center, for 2 FLOPs: 0.2 FLOP/byte, far below the
// 20 FLOP/byte where the f32 rate would bind. At 3.35 TB/s a ResNet-50
// commit (25.6 M parameters) takes 69 us in int8 and 76 us in bf16, the
// IMDB classifier's (1.38 M) 3.7 / 4.1 us; a cold launch costs 6-10 us on
// its own, and the port's first design paid it, and the wrapper's host
// cost, once per tensor.
//
// What the design does about it. One launch a commit: the grid is the sum
// of the tiles every entry needs (4096 elements a tile), and a block finds
// its entry by counting the entries that start at or before its tile
// (__syncthreads_count over 256 prefix values a pass, one coalesced read),
// so a 2-element bias and a 2.36 M-element kernel share one grid with no
// block idle. A warp folds 32 16-byte wire loads at a time (16 int8, 8 bf16
// or 4 f32 elements a lane, streamed with an evict-first hint); its lanes
// load and store the matching center as float4s L, L + 32, ... of the
// step, so every warp access to the center is one contiguous run, and the
// int8 and bf16 wire reaches the lane that owns its float4 through 512
// bytes of shared memory a step (f32 needs none). A thread keeps 16
// elements in flight, all loads issued before the first use. An entry
// whose center or payload is not 16-byte aligned (a view 1 or 3 floats
// into its storage), and the ragged tail of an entry past its last whole
// warp step, take a scalar loop in the same block and the same launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;                       // elements a thread
constexpr int64_t kTile = kThreads * kPerThread;     // elements a block
static_assert(kPerThread % 16 == 0, "whole wire loads for every kind");

enum Kind : int32_t { kInt8 = 0, kBf16 = 1, kF32 = 2 };

// One entry of a commit (ops/kernels/fold.py ROW, 40 bytes).
struct FoldRow {
  int64_t center;  // element offset of its center from the launch's base
  int64_t wire;    // byte offset of its payload in the staging buffer
  int64_t n;       // elements
  double factor;   // int8: the spec's scale; bf16, f32: 1
  int32_t kind;
  int32_t pad;
};
static_assert(sizeof(FoldRow) == 40, "FoldRow is ops/kernels/fold.py ROW");

__device__ __forceinline__ float fold1(float c, float s, float d) {
  return __fadd_rn(c, __fmul_rn(s, d));
}

// A kind's wire: kV elements in one 16-byte load, one element at an index,
// and the four elements of one float4 of center from the 4, 8 or 16 wire
// bytes that hold them (Four).
template <int KIND>
struct Wire;

template <>
struct Wire<kInt8> {
  static constexpr int kV = 16;
  using Four = uint32_t;
  __device__ __forceinline__ static float one(const uint8_t* w, int64_t i) {
    return static_cast<float>(reinterpret_cast<const int8_t*>(w)[i]);
  }
  __device__ __forceinline__ static float4 four(Four v) {
    return make_float4(static_cast<float>(static_cast<int8_t>(v)),
                       static_cast<float>(static_cast<int8_t>(v >> 8)),
                       static_cast<float>(static_cast<int8_t>(v >> 16)),
                       static_cast<float>(static_cast<int8_t>(v >> 24)));
  }
};

template <>
struct Wire<kBf16> {
  static constexpr int kV = 8;
  using Four = uint2;
  __device__ __forceinline__ static float one(const uint8_t* w, int64_t i) {
    return __uint_as_float(
        static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(w)[i]) << 16);
  }
  __device__ __forceinline__ static float4 four(Four v) {
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  }
};

template <>
struct Wire<kF32> {
  static constexpr int kV = 4;
  using Four = uint4;
  __device__ __forceinline__ static float one(const uint8_t* w, int64_t i) {
    return reinterpret_cast<const float*>(w)[i];
  }
  __device__ __forceinline__ static float4 four(Four v) {
    return make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                       __uint_as_float(v.z), __uint_as_float(v.w));
  }
};

__device__ __forceinline__ float4 fold4(float4 c, float s, float4 d) {
  return make_float4(fold1(c.x, s, d.x), fold1(c.y, s, d.y),
                     fold1(c.z, s, d.z), fold1(c.w, s, d.w));
}

// Fold elements [begin, end) of one entry. Where both pointers are 16-byte
// aligned, a warp takes steps of 32 wire loads (32 * kV elements): lane L
// loads the step's L-th 16 bytes of wire and the step's float4s L, L + 32,
// ... of center (each warp access one contiguous run), int8 and bf16 wire
// handed between lanes through shared memory (an f32 load is the lane's
// own float4); the rest of the entry, one element a thread.
template <int KIND>
__device__ __forceinline__ void fold_tile(float* __restrict__ c,
                                          const uint8_t* __restrict__ w,
                                          int64_t begin, int64_t end,
                                          float s, uint4* stage) {
  using W = Wire<KIND>;
  constexpr int kV = W::kV;
  constexpr int kSteps = kPerThread / kV;  // wire loads a thread
  constexpr int kBytes = 16 / kV;          // bytes a wire element
  constexpr int kF4 = kV / 4;              // float4s of center a load
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t rest = begin;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(w)) &
       15) == 0;
  if (vec) {
    const int64_t steps = (end - begin) / (32 * kV);  // whole warp steps
    uint4 q[kSteps];
    float4 a[kSteps][kF4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t st = static_cast<int64_t>(j) * kWarps + warp;
      if (st < steps) {
        const int64_t e0 = begin + st * 32 * kV;  // the step's first element
        q[j] = __ldcs(reinterpret_cast<const uint4*>(w + e0 * kBytes) + lane);
        const float4* cv = reinterpret_cast<const float4*>(c + e0);
#pragma unroll
        for (int k = 0; k < kF4; ++k) a[j][k] = cv[lane + 32 * k];
      }
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t st = static_cast<int64_t>(j) * kWarps + warp;
      if (st < steps) {
        const int64_t e0 = begin + st * 32 * kV;
        float4* cv = reinterpret_cast<float4*>(c + e0);
        typename W::Four f[kF4];
        if constexpr (KIND == kF32) {
          f[0] = q[j];
        } else {
          uint4* mine = stage + (warp * kSteps + j) * 32;
          mine[lane] = q[j];
          __syncwarp();
          const typename W::Four* four =
              reinterpret_cast<const typename W::Four*>(mine);
#pragma unroll
          for (int k = 0; k < kF4; ++k) f[k] = four[lane + 32 * k];
        }
#pragma unroll
        for (int k = 0; k < kF4; ++k)
          cv[lane + 32 * k] = fold4(a[j][k], s, W::four(f[k]));
      }
    }
    rest = begin + steps * 32 * kV;
  }
  for (int64_t i = rest + threadIdx.x; i < end; i += kThreads) {
    c[i] = fold1(c[i], s, W::one(w, i));
  }
}

// One block a tile. E > 0: the rows and the tile prefix are at the head of
// `buf`. E == 0: one entry, `one`, with its payload at `buf` (the
// one-tensor call).
__global__ void __launch_bounds__(kThreads, 1)
fold_commit_kernel(const uint8_t* __restrict__ buf, int E,
                   float* __restrict__ center, double scale, FoldRow one) {
  __shared__ uint4 stage[kWarps * (kPerThread / 8) * 32];
  const int64_t b = blockIdx.x;
  FoldRow r;
  int64_t tile;
  if (E == 0) {
    r = one;
    tile = b;
  } else {
    const FoldRow* rows = reinterpret_cast<const FoldRow*>(buf);
    const int64_t* first = reinterpret_cast<const int64_t*>(rows + E);
    // The entry is the last one that starts at or before this tile (an
    // empty entry starts where the next one does, so it is never found).
    int e = 0;
    for (int k0 = 1; k0 < E; k0 += kThreads) {
      const int k = k0 + threadIdx.x;
      e += __syncthreads_count(k < E && first[k] <= b);
    }
    r = rows[e];
    tile = b - first[e];
  }
  const float s = __double2float_rn(__dmul_rn(scale, r.factor));
  if (s == 0.0f && r.kind != kF32) return;  // the oracle's zero-scale rule
  const int64_t begin = tile * kTile;
  const int64_t end = begin + kTile < r.n ? begin + kTile : r.n;
  float* c = center + r.center;
  const uint8_t* w = buf + r.wire;
  switch (r.kind) {
    case kInt8: fold_tile<kInt8>(c, w, begin, end, s, stage); break;
    case kBf16: fold_tile<kBf16>(c, w, begin, end, s, stage); break;
    case kF32: fold_tile<kF32>(c, w, begin, end, s, stage); break;
    default: break;
  }
}

}  // namespace

// A whole commit: `buf` the staging buffer on the device (E rows, the
// E + 1 tile prefix, the payloads), `tiles` the prefix's last value,
// `center` the base the rows' center offsets count from, `scale` the
// commit scale. One launch.
extern "C" int fold_commit(const uint8_t* buf, int E, int64_t tiles,
                           float* center, double scale,
                           cudaStream_t stream) {
  if (E <= 0 || tiles <= 0) return 0;
  FoldRow none = {};
  fold_commit_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      buf, E, center, scale, none);
  return static_cast<int>(cudaGetLastError());
}

// One tensor: `center` [n] f32 in place, `wire` [n] of `kind` (int8, the
// bf16 bits, or f32), s = f32(scale * factor). The same kernel, its one
// row passed by value.
extern "C" int fold_tensor(float* center, const uint8_t* wire, int64_t n,
                           double factor, int kind, double scale,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  FoldRow one = {0, 0, n, factor, kind, 0};
  const int64_t tiles = (n + kTile - 1) / kTile;
  fold_commit_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      wire, 0, center, scale, one);
  return static_cast<int>(cudaGetLastError());
}
