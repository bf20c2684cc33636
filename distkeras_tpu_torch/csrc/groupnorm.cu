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
//           kernel does), inv = rsqrt(var + 1e-6);
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
// What bounds it on this card: bytes. A few FLOPs per element against 8
// bytes (forward: read x, write y) or 12 (backward: read x and dy, write
// dx); at ResNet-50's B=128 slabs that is 0.06 to 0.12 s of f32 math per
// GB against 0.3 s per GB of HBM traffic.
//
// What the design does about it. The TPU kernel keeps one sample's whole
// slab in VMEM and reads it once per pass from there. Hopper's shared
// memory cannot hold a B=128 batch of slabs at once and its blocks run in
// no order, so the work is cut into (row chunk, channel tile, sample)
// blocks whose threads run along C: neighbouring threads read neighbouring
// channels of one row, so every load is coalesced, and each thread keeps
// one channel's coefficients in registers for all its rows. Reductions
// across blocks are a second pass over small per-chunk partial sums, each
// added in a fixed order by one thread, with no atomics: two calls give the
// same bits. Forward: stats (3 launches) + apply, x read twice. Backward:
// stats, the masked reductions, the folds, then dx; x read three times, dy
// twice. Simple and right first; one pass with a (sample, group) slab in
// shared memory (at most 25,088 floats at ResNet-50's shapes) and vector
// loads are later work.
//
// bf16 (group_norm_fwd_bf16, group_norm_bwd_bf16; the storage type T of
// one templated body, T, as the TPU kernel runs one body for both): x, dy,
// gamma and beta are bf16 and widen exactly on load; the statistics, the
// ReLU mask, the partial sums and the scratch stay f32 (the TPU kernel
// reads bf16 and computes in f32, ops/pallas/groupnorm.py:241); y and dx
// are rounded to bf16 (nearest even) as they are stored (:264), and dgamma
// and dbeta, f32 sums over the batch, once at the end (gamma's dtype,
// :290-291). The kernels move half the bytes of the f32 ones.
// inv is 1.0f / sqrtf (correctly rounded), not the approximate rsqrtf;
// build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-6f;

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

// How a block's threads cover its tile: `ct` channel lanes side by side,
// `rpar` rows in parallel (C < 256 leaves room for several rows at once).
struct Tiling {
  int ct, rpar, lane, sub, c;
  __device__ Tiling(int C) {
    ct = C < kThreads ? C : kThreads;
    rpar = kThreads / ct;
    lane = threadIdx.x % ct;
    sub = threadIdx.x / ct;
    c = blockIdx.y * ct + lane;
  }
  // this thread reads channel c on rows sub, sub + rpar, ...
  __device__ bool active(int C) const { return sub < rpar && c < C; }
};

// Adds the rpar row-lanes of two per-thread sums in shared memory (lane 0
// of each channel ends with the totals, in row-lane order) and writes them
// to partial[0 or 1][b][s][c].
__device__ void block_partials(float a0, float a1, const Tiling& t, int C,
                               int b, int S, size_t plane, float* partial) {
  __shared__ float sh0[kThreads];
  __shared__ float sh1[kThreads];
  if (t.rpar > 1) {
    sh0[threadIdx.x] = a0;
    sh1[threadIdx.x] = a1;
    __syncthreads();
    if (t.sub == 0) {
      for (int k = 1; k < t.rpar; ++k) {
        a0 += sh0[k * t.ct + t.lane];
        a1 += sh1[k * t.ct + t.lane];
      }
    }
  }
  if (t.sub == 0 && t.c < C) {
    const size_t o = ((size_t)b * S + blockIdx.x) * C + t.c;
    partial[o] = a0;
    partial[plane + o] = a1;
  }
}

// grid (S row chunks, channel tiles, B). partial planes: sum x, sum x^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_partial(const T* __restrict__ x, float* __restrict__ partial,
                 int N, int C, int rows, int S, size_t plane) {
  const Tiling t(C);
  const int b = blockIdx.z;
  const int n0 = blockIdx.x * rows;
  const int n1 = min(N, n0 + rows);
  float s = 0.0f, ss = 0.0f;
  if (t.active(C)) {
    const T* xb = x + (size_t)b * N * C + t.c;
    for (int n = n0 + t.sub; n < n1; n += t.rpar) {
      const float v = load_f(xb[(size_t)n * C]);
      s += v;
      ss += v * v;
    }
  }
  block_partials(s, ss, t, C, b, S, plane, partial);
}

// persample[k][b][c] = sum over the S chunks, in chunk order, of
// partial[k][b][s][c], k = 0, 1. One thread per (b, c).
__global__ void gn_sum_chunks(const float* __restrict__ partial,
                              float* __restrict__ persample, int B, int C,
                              int S, size_t plane) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C;
  const int c = i - b * C;
  const float* p = partial + (size_t)b * S * C + c;
  float a0 = 0.0f, a1 = 0.0f;
  for (int s = 0; s < S; ++s) {
    a0 += p[(size_t)s * C];
    a1 += p[plane + (size_t)s * C];
  }
  persample[i] = a0;
  persample[(size_t)B * C + i] = a1;
}

// stats[0][b][g] = mean, stats[1][b][g] = inv. One thread per (b, g).
__global__ void gn_group_stats(const float* __restrict__ persample,
                               float* __restrict__ stats, int B, int C,
                               int G, float inv_n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * G) return;
  const int b = i / G;
  const int g = i - b * G;
  const int cg = C / G;
  const float* s = persample + (size_t)b * C + g * cg;
  const float* ss = s + (size_t)B * C;
  float a0 = 0.0f, a1 = 0.0f;
  for (int k = 0; k < cg; ++k) {
    a0 += s[k];
    a1 += ss[k];
  }
  const float mean = a0 * inv_n;
  const float var = a1 * inv_n - mean * mean;
  stats[i] = mean;
  stats[B * G + i] = 1.0f / sqrtf(var + kEps);
}

// grid as gn_stats_partial. y = x*a_c + b_c (+ReLU, NaN kept).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply(const T* __restrict__ x, const T* __restrict__ gamma,
         const T* __restrict__ beta, const float* __restrict__ stats,
         T* __restrict__ y, int B, int N, int C, int G, int rows,
         int relu) {
  const Tiling t(C);
  if (!t.active(C)) return;
  const int b = blockIdx.z;
  const int g = t.c / (C / G);
  const float mean = stats[b * G + g];
  const float inv = stats[B * G + b * G + g];
  const float ga = load_f(gamma[t.c]);
  const float a = inv * ga;
  const float sh = load_f(beta[t.c]) - mean * inv * ga;
  const int n0 = blockIdx.x * rows;
  const int n1 = min(N, n0 + rows);
  const size_t base = (size_t)b * N * C + t.c;
  for (int n = n0 + t.sub; n < n1; n += t.rpar) {
    const size_t o = base + (size_t)n * C;
    float v = load_f(x[o]) * a + sh;
    if (relu && v < 0.0f) v = 0.0f;
    y[o] = store_f<T>(v);
  }
}

// The backward's row reductions: partial planes sum dy and sum dy*xhat,
// dy masked by the recomputed ReLU.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_partial(const T* __restrict__ x, const T* __restrict__ dy,
               const T* __restrict__ gamma, const T* __restrict__ beta,
               const float* __restrict__ stats, float* __restrict__ partial,
               int B, int N, int C, int G, int rows, int S, int relu,
               size_t plane) {
  const Tiling t(C);
  const int b = blockIdx.z;
  float sdy = 0.0f, sdx = 0.0f;
  if (t.active(C)) {
    const int g = t.c / (C / G);
    const float mean = stats[b * G + g];
    const float inv = stats[B * G + b * G + g];
    const float ga = load_f(gamma[t.c]);
    const float be = load_f(beta[t.c]);
    const int n0 = blockIdx.x * rows;
    const int n1 = min(N, n0 + rows);
    const size_t base = (size_t)b * N * C + t.c;
    for (int n = n0 + t.sub; n < n1; n += t.rpar) {
      const size_t o = base + (size_t)n * C;
      const float xh = (load_f(x[o]) - mean) * inv;
      float d = load_f(dy[o]);
      if (relu && !(xh * ga + be > 0.0f)) d = 0.0f;
      sdy += d;
      sdx += d * xh;
    }
  }
  block_partials(sdy, sdx, t, C, b, S, plane, partial);
}

// coeffs[0][b][g] = m1, coeffs[1][b][g] = m2. One thread per (b, g).
template <typename T>
__global__ void gn_group_coeffs(const float* __restrict__ persample,
                                const T* __restrict__ gamma,
                                float* __restrict__ coeffs, int B, int C,
                                int G, float inv_n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * G) return;
  const int b = i / G;
  const int g = i - b * G;
  const int cg = C / G;
  const float* sdy = persample + (size_t)b * C + g * cg;
  const float* sdx = sdy + (size_t)B * C;
  const T* ga = gamma + g * cg;
  float a0 = 0.0f, a1 = 0.0f;
  for (int k = 0; k < cg; ++k) {
    a0 += load_f(ga[k]) * sdy[k];
    a1 += load_f(ga[k]) * sdx[k];
  }
  coeffs[i] = a0 * inv_n;
  coeffs[B * G + i] = a1 * inv_n;
}

// dbeta[c] = sum_b Sdy[b][c], dgamma[c] = sum_b Sdx[b][c], in sample order,
// stored in T.
template <typename T>
__global__ void gn_param_grads(const float* __restrict__ persample,
                               T* __restrict__ dgamma, T* __restrict__ dbeta,
                               int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a0 = 0.0f, a1 = 0.0f;
  for (int b = 0; b < B; ++b) {
    a0 += persample[(size_t)b * C + c];
    a1 += persample[(size_t)(B + b) * C + c];
  }
  dbeta[c] = store_f<T>(a0);
  dgamma[c] = store_f<T>(a1);
}

// grid as gn_stats_partial. dx = inv*(dy*gamma - m1 - xhat*m2).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy,
          const T* __restrict__ gamma, const T* __restrict__ beta,
          const float* __restrict__ stats, const float* __restrict__ coeffs,
          T* __restrict__ dx, int B, int N, int C, int G, int rows,
          int relu) {
  const Tiling t(C);
  if (!t.active(C)) return;
  const int b = blockIdx.z;
  const int g = t.c / (C / G);
  const int bg = b * G + g;
  const float mean = stats[bg];
  const float inv = stats[B * G + bg];
  const float m1 = coeffs[bg];
  const float m2 = coeffs[B * G + bg];
  const float ga = load_f(gamma[t.c]);
  const float be = load_f(beta[t.c]);
  const int n0 = blockIdx.x * rows;
  const int n1 = min(N, n0 + rows);
  const size_t base = (size_t)b * N * C + t.c;
  for (int n = n0 + t.sub; n < n1; n += t.rpar) {
    const size_t o = base + (size_t)n * C;
    const float xh = (load_f(x[o]) - mean) * inv;
    float d = load_f(dy[o]);
    if (relu && !(xh * ga + be > 0.0f)) d = 0.0f;
    dx[o] = store_f<T>(inv * (d * ga - m1 - xh * m2));
  }
}

int check_shape(int B, int N, int C, int G, int rows) {
  if (B <= 0 || N <= 0 || C <= 0 || G <= 0 || C % G != 0 || rows <= 0 ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

dim3 tile_grid(int B, int N, int C, int rows) {
  const int ct = C < kThreads ? C : kThreads;
  return dim3((N + rows - 1) / rows, (C + ct - 1) / ct, B);
}

// The statistics of x into stats [2][B][G] (mean, inv), through partial
// [2][B][S][C] and persample [2][B][C].
template <typename T>
int launch_stats(const T* x, float* partial, float* persample, float* stats,
                 int B, int N, int C, int G, int rows, cudaStream_t s) {
  const dim3 grid = tile_grid(B, N, C, rows);
  const int S = (int)grid.x;
  const size_t plane = (size_t)B * S * C;
  gn_stats_partial<T><<<grid, kThreads, 0, s>>>(x, partial, N, C, rows, S,
                                                plane);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_sum_chunks<<<(B * C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, persample, B, C, S, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float inv_n = 1.0f / ((float)N * (float)(C / G));
  gn_group_stats<<<(B * G + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      persample, stats, B, C, G, inv_n);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const T* x, const T* gamma, const T* beta, T* y, float* partial,
        float* persample, float* stats, int B, int N, int C, int G, int rows,
        int relu, void* stream) {
  int rc = check_shape(B, N, C, G, rows);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = launch_stats<T>(x, partial, persample, stats, B, N, C, G, rows, s);
  if (rc != 0) return rc;
  gn_apply<T><<<tile_grid(B, N, C, rows), kThreads, 0, s>>>(
      x, gamma, beta, stats, y, B, N, C, G, rows, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const T* x, const T* dy, const T* gamma, const T* beta, T* dx,
        T* dgamma, T* dbeta, float* partial, float* persample, float* stats,
        float* coeffs, int B, int N, int C, int G, int rows, int relu,
        void* stream) {
  int rc = check_shape(B, N, C, G, rows);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = launch_stats<T>(x, partial, persample, stats, B, N, C, G, rows, s);
  if (rc != 0) return rc;
  const dim3 grid = tile_grid(B, N, C, rows);
  const int S = (int)grid.x;
  const size_t plane = (size_t)B * S * C;
  gn_bwd_partial<T><<<grid, kThreads, 0, s>>>(x, dy, gamma, beta, stats,
                                              partial, B, N, C, G, rows, S,
                                              relu, plane);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_sum_chunks<<<(B * C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, persample, B, C, S, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float inv_n = 1.0f / ((float)N * (float)(C / G));
  gn_group_coeffs<T><<<(B * G + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      persample, gamma, coeffs, B, C, G, inv_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_param_grads<T><<<(C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      persample, dgamma, dbeta, B, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_dx<T><<<grid, kThreads, 0, s>>>(x, dy, gamma, beta, stats, coeffs,
                                         dx, B, N, C, G, rows, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// GroupNorm(+ReLU) forward (all f32, contiguous, on the device): x [B,N,C],
// gamma, beta [C] -> y [B,N,C]. Scratch the caller allocates, f32: partial
// [2, B, S, C] with S = ceil(N / rows), persample [2, B, C], stats
// [2, B, G] (left holding mean and inv). Returns the cudaError_t of the
// launches.
extern "C" int group_norm_fwd_f32(const float* x, const float* gamma,
                                  const float* beta, float* y,
                                  float* partial, float* persample,
                                  float* stats, int B, int N, int C, int G,
                                  int rows, int relu, void* stream) {
  return fwd<float>(x, gamma, beta, y, partial, persample, stats, B, N, C, G,
                    rows, relu, stream);
}

// The same with x, gamma, beta and y in bf16 (the scratch stays f32).
extern "C" int group_norm_fwd_bf16(const __nv_bfloat16* x,
                                   const __nv_bfloat16* gamma,
                                   const __nv_bfloat16* beta,
                                   __nv_bfloat16* y, float* partial,
                                   float* persample, float* stats, int B,
                                   int N, int C, int G, int rows, int relu,
                                   void* stream) {
  return fwd<__nv_bfloat16>(x, gamma, beta, y, partial, persample, stats, B,
                            N, C, G, rows, relu, stream);
}

// The backward of group_norm_fwd_f32: x, dy [B,N,C], gamma, beta [C] ->
// dx [B,N,C], dgamma, dbeta [C]. Scratch as the forward's, plus coeffs
// [2, B, G] (m1, m2). Returns the cudaError_t of the launches.
extern "C" int group_norm_bwd_f32(const float* x, const float* dy,
                                  const float* gamma, const float* beta,
                                  float* dx, float* dgamma, float* dbeta,
                                  float* partial, float* persample,
                                  float* stats, float* coeffs, int B, int N,
                                  int C, int G, int rows, int relu,
                                  void* stream) {
  return bwd<float>(x, dy, gamma, beta, dx, dgamma, dbeta, partial,
                    persample, stats, coeffs, B, N, C, G, rows, relu, stream);
}

// The same with x, dy, gamma, beta, dx, dgamma and dbeta in bf16.
extern "C" int group_norm_bwd_bf16(const __nv_bfloat16* x,
                                   const __nv_bfloat16* dy,
                                   const __nv_bfloat16* gamma,
                                   const __nv_bfloat16* beta,
                                   __nv_bfloat16* dx, __nv_bfloat16* dgamma,
                                   __nv_bfloat16* dbeta, float* partial,
                                   float* persample, float* stats,
                                   float* coeffs, int B, int N, int C, int G,
                                   int rows, int relu, void* stream) {
  return bwd<__nv_bfloat16>(x, dy, gamma, beta, dx, dgamma, dbeta, partial,
                            persample, stats, coeffs, B, N, C, G, rows, relu,
                            stream);
}
