// Dequant-fused commit fold, in place, f32 center, for Hopper (sm_90a).
//
// Replaces: distkeras_tpu/ops/pallas/fold.py:_fold_kernel (pl.pallas_call in
// _folder), the netps server's compressed-domain fold:
//   center[i] = center[i] + s * dequant(q[i])
//   int8:  dequant(q) = float(q),             s = f32(commit_scale * spec scale)
//   bf16:  dequant(q) = bitcast_f32(q << 16), s = f32(commit_scale)
// s is rounded to f32 once, on the host, exactly as the numpy oracle
// (netps/fold.py fold_compressed_numpy) rounds it.
//
// Bit-exactness: the product and the sum are rounded separately
// (__fmul_rn, __fadd_rn), never contracted into one FMA, so the result is
// bit-equal to numpy's `c + (q.astype(f32) * s)` and to the plain PyTorch
// twin (two kernels, two roundings).
//
// What bounds it on this card: bytes. Each element reads 4 bytes of center
// and 1 (int8) or 2 (bf16) of wire, and writes 4 of center, for 2 FLOPs:
// 0.2 FLOP/byte, far below the 20 FLOP/byte where the f32 rate would bind.
// At 3.35 TB/s ResNet-50's largest tensor (2,359,296 elements) takes
// 6.3 us in int8 and 7.0 us in bf16; the IMDB classifier's embedding
// (1,280,000) 3.4 / 3.8 us.
//
// What the design does about it. The TPU kernel pads every tensor to
// [rows, 128] with 512-row blocks and stages them through VMEM; here the
// fold is a grid-stride stream that works in place on the center with no
// padding and no copies. Each thread handles 8 elements an iteration: two
// float4 center loads and stores (32 bytes) and one 8-byte (int8) or
// 16-byte (bf16) wire load, so every access is a full-width coalesced
// transaction. The vector path needs the center 16-byte and the wire
// vector-aligned (every fresh tensor is); a tail of n % 8 elements, or a
// tensor whose pointers are not aligned, goes through a scalar kernel.
// The grid is capped at 16 blocks of 256 threads per SM; larger tensors
// loop. One launch (two with a tail) per tensor; batching a commit's
// tensors into one launch is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                 // elements per thread iteration
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ float fold1(float c, float s, float d) {
  return __fadd_rn(c, __fmul_rn(s, d));
}

template <typename W>
struct Wire;

template <>
struct Wire<int8_t> {
  using Vec = uint2;  // 8 x int8
  __device__ __forceinline__ static float one(int8_t q) {
    return static_cast<float>(q);
  }
  __device__ __forceinline__ static void eight(const Vec& v, float* d) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) d[k] = static_cast<float>(b[k]);
  }
};

template <>
struct Wire<uint16_t> {
  using Vec = uint4;  // 8 x bf16 bits
  __device__ __forceinline__ static float one(uint16_t q) {
    return __uint_as_float(static_cast<uint32_t>(q) << 16);
  }
  __device__ __forceinline__ static void eight(const Vec& v, float* d) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) d[k] = one(h[k]);
  }
};

template <typename W>
__global__ void __launch_bounds__(kThreads)
fold_vec_kernel(float* __restrict__ center, const W* __restrict__ q,
                int64_t nvec, float s) {
  using Vec = typename Wire<W>::Vec;
  const Vec* qv = reinterpret_cast<const Vec*>(q);
  float4* cv = reinterpret_cast<float4*>(center);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < nvec; i += stride) {
    float d[kVec];
    Wire<W>::eight(qv[i], d);
    float4 a = cv[2 * i];
    float4 b = cv[2 * i + 1];
    a.x = fold1(a.x, s, d[0]);
    a.y = fold1(a.y, s, d[1]);
    a.z = fold1(a.z, s, d[2]);
    a.w = fold1(a.w, s, d[3]);
    b.x = fold1(b.x, s, d[4]);
    b.y = fold1(b.y, s, d[5]);
    b.z = fold1(b.z, s, d[6]);
    b.w = fold1(b.w, s, d[7]);
    cv[2 * i] = a;
    cv[2 * i + 1] = b;
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
fold_scalar_kernel(float* __restrict__ center, const W* __restrict__ q,
                   int64_t start, int64_t n, float s) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = start + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    center[i] = fold1(center[i], s, Wire<W>::one(q[i]));
  }
}

int64_t blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

template <typename W>
int fold(float* center, const W* q, int64_t n, float s,
         cudaStream_t stream) {
  if (n <= 0) return 0;
  using Vec = typename Wire<W>::Vec;
  const bool aligned =
      reinterpret_cast<uintptr_t>(center) % sizeof(float4) == 0 &&
      reinterpret_cast<uintptr_t>(q) % sizeof(Vec) == 0;
  const int64_t nvec = aligned ? n / kVec : 0;
  if (nvec > 0) {
    fold_vec_kernel<W><<<static_cast<unsigned>(blocks_for(nvec)), kThreads,
                         0, stream>>>(center, q, nvec, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t start = nvec * kVec;
  if (start < n) {
    fold_scalar_kernel<W><<<static_cast<unsigned>(blocks_for(n - start)),
                            kThreads, 0, stream>>>(center, q, start, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// center [n] f32, in place; q [n] int8; s = f32(commit_scale * spec scale).
extern "C" int fold_int8_f32(float* center, const int8_t* q, int64_t n,
                             float s, cudaStream_t stream) {
  return fold<int8_t>(center, q, n, s, stream);
}

// center [n] f32, in place; q_bits [n] the bf16 bits as uint16;
// s = f32(commit_scale).
extern "C" int fold_bf16_f32(float* center, const uint16_t* q_bits,
                             int64_t n, float s, cudaStream_t stream) {
  return fold<uint16_t>(center, q_bits, n, s, stream);
}
