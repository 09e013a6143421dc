// RMSNorm over the last axis: every block norm, final norm and qk-norm of
// the LMs (17 launches per router decode step, 113 per qwen3-1.7B forward).
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py::rmsnorm (bodies
// _rmsnorm_kernel and _rmsnorm_kernel_noscale).  Same function, as
// ref.rmsnorm_ref computes it: in f32, y = x * rsqrt(mean(x^2) + eps),
// times the scale when one is given, cast back to x's type.
//
// Bound on this card: bytes (one read of x, one read of the scale, one
// write of y; a few flops an element).  At the decode shapes (a few rows
// of 64-256) that is nanoseconds, so the launch path is what costs: the
// wrapper binds this C entry once through ctypes and launches on the
// current stream with no copy.  Design (the host picks the geometry):
//  * rows of up to 4 16-byte vectors a lane (D <= 1024 in bf16): one warp
//    per row, 1-4 rows a block, keeping >= 2 waves on 132 SMs;
//  * longer rows: one block per row with ~4 vectors a thread (64 threads
//    at D = 2048 bf16, 192 at 6144: several loads in flight a thread beat
//    more threads with one each); the warp sums meet in one
//    shared-memory step.
// Each thread keeps its share of the row in registers (at most NVMAX
// 16-byte vectors), so x is read once.  16-byte loads and stores where
// the row is a whole number of 16-byte vectors and every base is 16-byte
// aligned; otherwise a scalar body that reads the row twice (the second
// read hits L1/L2).  x in {f32, bf16} x scale in {none, f32, bf16}.
//
// The backward (rmsnorm_bwd_launch) has no Pallas counterpart: the JAX
// package differentiates its jnp reference.  It computes what
// ref.rmsnorm_bwd_ref computes: with r = rsqrt(mean(x^2) + eps) and
// g = dy * scale, dx = r * (g - x * r^2 * mean(g * x)) and dscale = the
// sum over rows of dy * x * r, in f32.  Bound on this card: bytes (x and
// dy read, dx written).  Two launches with a scale, one without:
//  * rmsnorm_bwd_kernel: TPR threads a row (32..256, a power of two; the
//    row's sums by warp shuffles, and shared memory above a warp), 256 / TPR
//    rows in flight, a grid of at most 4 waves of blocks walking the rows.
//    Each thread owns the columns t + TPR * k, so it adds its share of
//    dscale over all its rows in registers; the block then sums its row
//    groups in a fixed order and writes one partial row of D;
//  * rmsnorm_dscale_kernel: a thread per column sums the blocks' partial
//    rows in block order.
// No atomics: the result does not depend on the order blocks run in.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NVMAX = 8;  // 16-byte vectors a thread keeps in registers
constexpr unsigned FULL = 0xffffffffu;

struct NoScale {};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The sum over the threads of one row: a warp (BLOCK false) or the block.
template <bool BLOCK>
__device__ __forceinline__ float row_sum(float v) {
  v = warp_sum(v);
  if (BLOCK) {
    __shared__ float part[32];
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) part[warp] = v;
    __syncthreads();
    v = 0.f;
    for (int w = 0; w < nw; ++w) v += part[w];
  }
  return v;
}

template <typename S>
__device__ __forceinline__ float scale_at(const S* s, int j) {
  if constexpr (std::is_same<S, NoScale>::value) {
    return 1.f;
  } else {
    return to_f(s[j]);
  }
}

// The VEC scale values of vector vi, in 16- or 8-byte loads (the host
// checked the scale's alignment).
template <typename T, typename S, int VEC>
__device__ __forceinline__ void scale_vec(const S* __restrict__ s, int vi, float (&f)[VEC]) {
  if constexpr (std::is_same<S, NoScale>::value) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = 1.f;
  } else if constexpr (sizeof(S) * VEC == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(s) + vi);
    const S* e = reinterpret_cast<const S*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_f(e[j]);
  } else if constexpr (sizeof(S) * VEC == 32) {
    const uint4 u0 = __ldg(reinterpret_cast<const uint4*>(s) + 2 * vi);
    const uint4 u1 = __ldg(reinterpret_cast<const uint4*>(s) + 2 * vi + 1);
    const S* e0 = reinterpret_cast<const S*>(&u0);
    const S* e1 = reinterpret_cast<const S*>(&u1);
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      f[j] = to_f(e0[j]);
      f[j + VEC / 2] = to_f(e1[j]);
    }
  } else {
    static_assert(sizeof(S) * VEC == 8, "scale vector of 8, 16 or 32 bytes");
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(s) + vi);
    const S* e = reinterpret_cast<const S*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_f(e[j]);
  }
}

// 16-byte vectors: VEC = 16 / sizeof(T) elements each.  Row `row` of the
// block's rows; thread t of the row's TPR threads holds vectors t, t + TPR,
// ... (at most NVMAX, checked by the host).
template <typename T, typename S, bool BLOCK>
__global__ void rmsnorm_vec_kernel(const T* __restrict__ x, const S* __restrict__ s,
                                   T* __restrict__ out, int rows, int D, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int tpr = BLOCK ? blockDim.x : 32;
  const int t = BLOCK ? threadIdx.x : (threadIdx.x & 31);
  const int row = BLOCK ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (!BLOCK && row >= rows) return;  // the whole warp leaves together
  const int nvec = D / VEC;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  uint4 buf[NVMAX];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NVMAX; ++k) {
    const int vi = t + k * tpr;
    if (vi < nvec) {
      buf[k] = __ldg(xr + vi);
      const T* e = reinterpret_cast<const T*>(&buf[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  const float inv = rsqrtf(row_sum<BLOCK>(ss) / (float)D + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
  for (int k = 0; k < NVMAX; ++k) {
    const int vi = t + k * tpr;
    if (vi < nvec) {
      const T* e = reinterpret_cast<const T*>(&buf[k]);
      float sc[VEC];
      scale_vec<T, S, VEC>(s, vi, sc);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float y = to_f(e[j]) * inv;
        if constexpr (!std::is_same<S, NoScale>::value) y *= sc[j];
        oe[j] = from_f<T>(y);
      }
      orow[vi] = o;
    }
  }
}

// Any D and alignment: one element at a time, x read twice.
template <typename T, typename S, bool BLOCK>
__global__ void rmsnorm_scalar_kernel(const T* __restrict__ x, const S* __restrict__ s,
                                      T* __restrict__ out, int rows, int D, float eps) {
  const int tpr = BLOCK ? blockDim.x : 32;
  const int t = BLOCK ? threadIdx.x : (threadIdx.x & 31);
  const int row = BLOCK ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (!BLOCK && row >= rows) return;
  const T* xr = x + (size_t)row * D;
  float ss = 0.f;
  for (int j = t; j < D; j += tpr) {
    const float f = to_f(xr[j]);
    ss = fmaf(f, f, ss);
  }
  const float inv = rsqrtf(row_sum<BLOCK>(ss) / (float)D + eps);
  T* orow = out + (size_t)row * D;
  for (int j = t; j < D; j += tpr) {
    float y = to_f(xr[j]) * inv;
    if constexpr (!std::is_same<S, NoScale>::value) y *= scale_at(s, j);
    orow[j] = from_f<T>(y);
  }
}

template <typename T, typename S>
int launch(const void* x, const void* s, void* out, int rows, int D, float eps, int threads,
           int rows_per_block, int vec, cudaStream_t stream) {
  const bool block = rows_per_block == 1 && threads > 32;
  const int tpr = block ? threads : 32;
  if (threads < 32 || threads > 1024 || threads % 32 ||
      (!block && threads != 32 * rows_per_block))
    return (int)cudaErrorInvalidValue;
  const int grid = (rows + rows_per_block - 1) / rows_per_block;
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(s);
  T* op = static_cast<T*>(out);
  if (vec > 1) {
    constexpr int VEC = 16 / sizeof(T);
    if (vec != VEC || D % VEC || (D / VEC + tpr - 1) / tpr > NVMAX)
      return (int)cudaErrorInvalidValue;
    if (block)
      rmsnorm_vec_kernel<T, S, true><<<grid, threads, 0, stream>>>(xp, sp, op, rows, D, eps);
    else
      rmsnorm_vec_kernel<T, S, false><<<grid, threads, 0, stream>>>(xp, sp, op, rows, D, eps);
  } else if (block) {
    rmsnorm_scalar_kernel<T, S, true><<<grid, threads, 0, stream>>>(xp, sp, op, rows, D, eps);
  } else {
    rmsnorm_scalar_kernel<T, S, false><<<grid, threads, 0, stream>>>(xp, sp, op, rows, D, eps);
  }
  return 0;
}

template <typename T>
int by_scale(const void* x, const void* s, void* out, int rows, int D, int s_dtype, float eps,
             int threads, int rows_per_block, int vec, cudaStream_t stream) {
  switch (s_dtype) {
    case -1: return launch<T, NoScale>(x, s, out, rows, D, eps, threads, rows_per_block, vec, stream);
    case 0: return launch<T, float>(x, s, out, rows, D, eps, threads, rows_per_block, vec, stream);
    case 1:
      return launch<T, __nv_bfloat16>(x, s, out, rows, D, eps, threads, rows_per_block, vec,
                                      stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// The sums of a and b over the TPR threads of each row group (all threads
// of the block call it the same number of times).
__device__ __forceinline__ void row_sums(float& a, float& b, int tpr) {
  const int w = tpr < 32 ? tpr : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < w) {
      a += __shfl_xor_sync(FULL, a, o);
      b += __shfl_xor_sync(FULL, b, o);
    }
  }
  if (tpr > 32) {
    __shared__ float part[2][8];
    const int warp = threadIdx.x >> 5, per = tpr >> 5, first = (threadIdx.x / tpr) * per;
    __syncthreads();   // the previous row's reads of part are over
    if ((threadIdx.x & 31) == 0) {
      part[0][warp] = a;
      part[1][warp] = b;
    }
    __syncthreads();
    a = b = 0.f;
    for (int i = 0; i < per; ++i) {
      a += part[0][first + i];
      b += part[1][first + i];
    }
  }
}

template <typename T, typename S, int CPT>
__global__ void __launch_bounds__(256)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ s, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partial, int rows, int D, float eps,
                   int tpr) {
  constexpr bool SCALED = !std::is_same<S, NoScale>::value;
  const int R = 256 / tpr;                       // rows in flight
  const int t = threadIdx.x % tpr, rg = threadIdx.x / tpr;
  float sc[CPT], acc[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int j = t + tpr * k;
    sc[k] = j < D ? scale_at(s, j) : 0.f;
    acc[k] = 0.f;
  }
  for (int base = blockIdx.x * R; base < rows; base += gridDim.x * R) {
    const int row = base + rg;
    const bool valid = row < rows;
    const T* xr = x + (size_t)row * D;
    const T* dyr = dy + (size_t)row * D;
    float xv[CPT], dv[CPT];
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = t + tpr * k;
      xv[k] = dv[k] = 0.f;
      if (valid && j < D) {
        xv[k] = to_f(xr[j]);
        dv[k] = to_f(dyr[j]);
      }
      ss = fmaf(xv[k], xv[k], ss);
      sg = fmaf(SCALED ? dv[k] * sc[k] : dv[k], xv[k], sg);
    }
    row_sums(ss, sg, tpr);
    const float r = rsqrtf(ss / (float)D + eps);
    const float c = r * r * (sg / (float)D);
    T* dxr = dx + (size_t)row * D;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = t + tpr * k;
      if (valid && j < D) {
        const float g = SCALED ? dv[k] * sc[k] : dv[k];
        dxr[j] = from_f<T>(r * (g - xv[k] * c));
        if (SCALED) acc[k] = fmaf(dv[k] * xv[k], r, acc[k]);
      }
    }
  }
  if constexpr (SCALED) {
    __shared__ float part[256 * CPT];            // row group g's columns at g * TPR * CPT
    const int width = tpr * CPT;
#pragma unroll
    for (int k = 0; k < CPT; ++k) part[rg * width + t + tpr * k] = acc[k];
    __syncthreads();
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float v = 0.f;
      for (int g = 0; g < R; ++g) v += part[g * width + j];
      partial[(size_t)blockIdx.x * D + j] = v;
    }
  }
}

template <typename S>
__global__ void rmsnorm_dscale_kernel(const float* __restrict__ partial, S* __restrict__ ds,
                                      int blocks, int D) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  float v = 0.f;
  for (int b = 0; b < blocks; ++b) v += partial[(size_t)b * D + j];
  ds[j] = from_f<S>(v);
}

template <typename T, typename S, int CPT>
int launch_bwd_cpt(const void* x, const void* s, const void* dy, void* dx, float* partial,
                   void* ds, int rows, int D, float eps, int tpr, int blocks,
                   cudaStream_t stream) {
  rmsnorm_bwd_kernel<T, S, CPT><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(s), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, D, eps, tpr);
  if constexpr (!std::is_same<S, NoScale>::value) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rmsnorm_dscale_kernel<S><<<(D + 255) / 256, 256, 0, stream>>>(partial, static_cast<S*>(ds),
                                                                  blocks, D);
  }
  return 0;
}

template <typename T, typename S>
int launch_bwd(const void* x, const void* s, const void* dy, void* dx, float* partial, void* ds,
               int rows, int D, float eps, int tpr, int cpt, int blocks, cudaStream_t stream) {
  switch (cpt) {
    case 1: return launch_bwd_cpt<T, S, 1>(x, s, dy, dx, partial, ds, rows, D, eps, tpr, blocks, stream);
    case 2: return launch_bwd_cpt<T, S, 2>(x, s, dy, dx, partial, ds, rows, D, eps, tpr, blocks, stream);
    case 4: return launch_bwd_cpt<T, S, 4>(x, s, dy, dx, partial, ds, rows, D, eps, tpr, blocks, stream);
    case 8: return launch_bwd_cpt<T, S, 8>(x, s, dy, dx, partial, ds, rows, D, eps, tpr, blocks, stream);
    case 16: return launch_bwd_cpt<T, S, 16>(x, s, dy, dx, partial, ds, rows, D, eps, tpr, blocks, stream);
    case 32: return launch_bwd_cpt<T, S, 32>(x, s, dy, dx, partial, ds, rows, D, eps, tpr, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd_by_scale(const void* x, const void* s, const void* dy, void* dx, float* partial, void* ds,
                 int rows, int D, int s_dtype, float eps, int tpr, int cpt, int blocks,
                 cudaStream_t stream) {
  switch (s_dtype) {
    case -1:
      return launch_bwd<T, NoScale>(x, s, dy, dx, partial, ds, rows, D, eps, tpr, cpt, blocks, stream);
    case 0:
      return launch_bwd<T, float>(x, s, dy, dx, partial, ds, rows, D, eps, tpr, cpt, blocks, stream);
    case 1:
      return launch_bwd<T, __nv_bfloat16>(x, s, dy, dx, partial, ds, rows, D, eps, tpr, cpt, blocks,
                                          stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (rows, D) contiguous, out like x; s (D,) or null.  x_dtype and s_dtype:
// 0 = float32, 1 = bfloat16, -1 = no scale.  Geometry from the host:
// rows_per_block > 1 gives a warp per row (threads = 32 * rows_per_block),
// rows_per_block == 1 with threads > 32 a block per row; vec = 16 / elt
// takes the 16-byte body, vec = 1 the scalar one.
extern "C" int rmsnorm_launch(const void* x, const void* s, void* out, int rows, int D,
                              int x_dtype, int s_dtype, float eps, int threads,
                              int rows_per_block, int vec, cudaStream_t stream) {
  if (rows > 0 && D > 0) {
    if (rows_per_block < 1) return (int)cudaErrorInvalidValue;
    const int rc = x_dtype == 0
        ? by_scale<float>(x, s, out, rows, D, s_dtype, eps, threads, rows_per_block, vec, stream)
        : x_dtype == 1
        ? by_scale<__nv_bfloat16>(x, s, out, rows, D, s_dtype, eps, threads, rows_per_block, vec,
                                  stream)
        : (int)cudaErrorInvalidValue;
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

// The backward: x, dy and dx (rows, D) contiguous in x_dtype; s (D,) or null
// (s_dtype -1, then partial and ds are unused); partial (blocks, D) f32
// scratch; ds (D,) in s_dtype.  tpr in {32, 64, 128, 256} threads a row,
// cpt in {1, 2, 4, 8, 16, 32} with tpr * cpt >= D.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* s, const void* dy, void* dx,
                                  float* partial, void* ds, int rows, int D, int x_dtype,
                                  int s_dtype, float eps, int tpr, int cpt, int blocks,
                                  cudaStream_t stream) {
  if (rows > 0 && D > 0) {
    if ((tpr != 32 && tpr != 64 && tpr != 128 && tpr != 256) || tpr * cpt < D || blocks < 1)
      return (int)cudaErrorInvalidValue;
    const int rc = x_dtype == 0
        ? bwd_by_scale<float>(x, s, dy, dx, partial, ds, rows, D, s_dtype, eps, tpr, cpt, blocks,
                              stream)
        : x_dtype == 1
        ? bwd_by_scale<__nv_bfloat16>(x, s, dy, dx, partial, ds, rows, D, s_dtype, eps, tpr, cpt,
                                      blocks, stream)
        : (int)cudaErrorInvalidValue;
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
