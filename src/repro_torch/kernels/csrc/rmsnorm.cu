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
// dy read, dx written; at qwen3-1.7B's (4096, 2048) bf16, 0.015 ms at an
// H100 SXM's published 3.35 TB/s).  One
// launch (rmsnorm_bwd_kernel), with or without a scale:
//  * 16-byte loads (8 bf16 or 4 f32 a thread) where the row is a whole
//    number of 16-byte vectors and every base is aligned, else a scalar
//    body; TPR threads a row (a power of two: about D / 16 elements of
//    two vectors each), 256 / TPR rows in flight a block, a grid of two
//    blocks an SM walking the rows; the vector body loads the next row
//    before it reduces the current one (the row's sums by shuffles, and
//    shared memory above a warp);
//  * dscale: each thread owns the columns of its units and adds its share
//    over its rows in registers; the block sums its row groups into one
//    row in shared memory; the blocks of a thread-block cluster (8 where
//    the grid allows) sum the cluster's rows column-parallel, block r a
//    share r of the columns read from the others' shared memory, into one
//    row in device memory; the last block to write its share r of a
//    cluster's row, which an integer arrival counter of share r names
//    (each stream has its own, reset by its last user, so a graph
//    replays), sums that share over the clusters' rows in order.  No float
//    is added atomically, so dscale is the same bits on every call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

// The C entry's one argument, packed by the wrapper in one buffer: outside
// the anonymous namespace, so the entry's signature names a type of its own.
struct BwdArgs {
  const void* x;
  const void* s;
  const void* dy;
  void* dx;
  float* partial;              // (blocks / cluster, D) f32 scratch; null without s
  void* ds;
  unsigned* counters;          // this stream's `cluster` arrival counters, all 0
  long long rows, D, x_dtype, s_dtype;
  double eps;
  long long tpr, units, vec, blocks, cluster;
  cudaStream_t stream;
};
static_assert(sizeof(BwdArgs) == 18 * 8, "BwdArgs must match the wrapper's \"<11qd6q\"");

namespace {

namespace cg = cooperative_groups;

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
// The sums of a and b over the TPR threads of each row group.  Above a
// warp the warps' sums meet in shared memory behind the row group's own
// named barrier; two buffers (by the parity of the row's turn) leave one
// barrier a row.  Every thread of a row group calls it equally often.
__device__ __forceinline__ void row_sums(float& a, float& b, int tpr, int parity) {
  const int w = tpr < 32 ? tpr : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < w) {
      a += __shfl_xor_sync(FULL, a, o);
      b += __shfl_xor_sync(FULL, b, o);
    }
  }
  if (tpr > 32) {
    __shared__ float part[2][2][8];
    const int warp = threadIdx.x >> 5, per = tpr >> 5, first = (threadIdx.x / tpr) * per;
    if ((threadIdx.x & 31) == 0) {
      part[parity][0][warp] = a;
      part[parity][1][warp] = b;
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + (int)threadIdx.x / tpr), "r"(tpr) : "memory");
    a = b = 0.f;
    for (int i = 0; i < per; ++i) {
      a += part[parity][0][first + i];
      b += part[parity][1][first + i];
    }
  }
}

// V elements of a row: one 16-byte vector (V = 16 / sizeof(T)) or one
// element (V = 1, the scalar body).
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(r);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const float2 p = __bfloat1622float2(e[j]);
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  } else {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = to_f(e[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> pack(const float (&f)[V]) {
  if constexpr (V == 1) {
    return from_f<T>(f[0]);
  } else {
    uint4 r;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
      for (int j = 0; j < V / 2; ++j) e[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    } else {
      T* e = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = from_f<T>(f[j]);
    }
    return r;
  }
}

// An add to a device-wide counter that releases the block's earlier writes
// (ordered before it by a block barrier) and acquires those released by
// earlier adds.
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <typename O>
__device__ __forceinline__ void store4(O* out, int c, const float4& v) {
  if constexpr (std::is_same<O, float>::value) {
    reinterpret_cast<float4*>(out)[c] = v;
  } else {
    out[4 * c] = from_f<O>(v.x);
    out[4 * c + 1] = from_f<O>(v.y);
    out[4 * c + 2] = from_f<O>(v.z);
    out[4 * c + 3] = from_f<O>(v.w);
  }
}

// out[j] = the sum of src[r * stride + j] over rows 0 <= r < rows, for the
// columns lo <= j < hi, by all the block's threads: 16-byte loads that
// bypass L1 (other blocks wrote the rows), eight rows in flight a thread.
// Where there are fewer 16-byte columns than threads, the rows are cut into
// that many chunks, summed apart and then in chunk order; every sum is
// taken in a fixed order, so the result is the same bits each time.
template <typename O>
__device__ __forceinline__ void sum_rows(const float* __restrict__ src, int rows, int stride,
                                         int lo, int hi, O* __restrict__ out) {
  if (((lo | hi | stride) & 3) == 0) {
    __shared__ float4 red[256];
    const int n4 = (hi - lo) >> 2;
    if (n4 == 0) return;
    const int chunks = n4 >= (int)blockDim.x ? 1 : (int)blockDim.x / n4;
    const int len = (rows + chunks - 1) / chunks;
    const float4* s4 = reinterpret_cast<const float4*>(src + lo);
    for (int c0 = 0; c0 < n4; c0 += blockDim.x) {
      const int c = c0 + (int)threadIdx.x % n4, k = (int)threadIdx.x / n4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < n4 && k < chunks) {
        const int a = k * len, e = min(rows, a + len);
        int r = a;
        for (; r + 8 <= e; r += 8) {
          float4 v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = __ldcg(s4 + (size_t)(r + i) * (stride >> 2) + c);
#pragma unroll
          for (int i = 0; i < 8; ++i) add4(acc, v[i]);
        }
        for (; r < e; ++r) add4(acc, __ldcg(s4 + (size_t)r * (stride >> 2) + c));
      }
      if (chunks == 1) {
        if (c < n4) store4(out + lo, c, acc);
      } else {
        red[threadIdx.x] = acc;
        __syncthreads();
        if (k == 0) {
          for (int i = 1; i < chunks; ++i) add4(acc, red[i * n4 + threadIdx.x]);
          store4(out + lo, c, acc);
        }
        __syncthreads();
      }
    }
  } else {
    for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc += __ldcg(src + (size_t)r * stride + j);
      out[j] = from_f<O>(acc);
    }
  }
}

// Unit u (V elements) of every row: thread t of a row's TPR threads holds
// units t, t + TPR, ... (NV of them, those below D / V).  256 / TPR rows are
// in flight a block, and a block walks rows blockIdx.x * R + g, stepping
// gridDim.x * R; the vector body loads the next row's units before it
// reduces the current one.  With a scale each thread adds its share of
// dscale over its rows in registers; then the block sums its row groups in
// a fixed order, the cluster its blocks' rows in rank order (block r the
// share r of the columns), and the last block to finish a share r sums it
// over the clusters' rows in cluster order: integer arrival counters, one
// a share (this stream's, reset by their last user), decide which is last,
// and no float is added atomically.
// Two blocks an SM where a thread holds at most 16 columns.
template <typename T, typename S, int V, int NV>
__global__ void __launch_bounds__(256, NV * V <= 16 ? 2 : 1)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ s, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partial, S* __restrict__ ds,
                   unsigned* __restrict__ counters, int rows, int D, float eps, int tpr) {
  constexpr bool SCALED = !std::is_same<S, NoScale>::value;
  constexpr bool PREFETCH = V > 1;
  using R_ = Raw<T, V>;
  const int R = 256 / tpr;                       // rows in flight
  const int t = threadIdx.x % tpr, rg = threadIdx.x / tpr;
  const int nu = D / V;
  const R_* xu = reinterpret_cast<const R_*>(x);
  const R_* du = reinterpret_cast<const R_*>(dy);
  R_* dxu = reinterpret_cast<R_*>(dx);
  float sc[NV][V], acc[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int u = t + tpr * k;
    if constexpr (V == 1) {
      sc[k][0] = u < nu ? scale_at(s, u) : 0.f;
    } else if (u < nu) {
      scale_vec<T, S, V>(s, u, sc[k]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) sc[k][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[k][e] = 0.f;
  }
  const int step = gridDim.x * R;
  R_ xb[NV], db[NV];
  auto load = [&](int row, R_ (&xr)[NV], R_ (&dr)[NV]) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int u = t + tpr * k;
      if (row < rows && u < nu) {
        xr[k] = xu[(size_t)row * nu + u];
        dr[k] = du[(size_t)row * nu + u];
      } else {
        xr[k] = R_{};
        dr[k] = R_{};
      }
    }
  };
  if constexpr (PREFETCH) load(blockIdx.x * R + rg, xb, db);
  for (int base = blockIdx.x * R, turn = 0; base < rows; base += step, ++turn) {
    const int row = base + rg;
    if constexpr (PREFETCH) {
      R_ nx[NV], nd[NV];
      load(row + step, nx, nd);   // in flight while this row is reduced
      float xf[NV][V], df[NV][V];
      float ss = 0.f, sg = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        unpack<T, V>(xb[k], xf[k]);
        unpack<T, V>(db[k], df[k]);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss = fmaf(xf[k][e], xf[k][e], ss);
          sg = fmaf(SCALED ? df[k][e] * sc[k][e] : df[k][e], xf[k][e], sg);
        }
      }
      row_sums(ss, sg, tpr, turn & 1);
      const float r = rsqrtf(ss / (float)D + eps);
      const float c = r * r * (sg / (float)D);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int u = t + tpr * k;
        if (row < rows && u < nu) {
          float o[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float gv = SCALED ? df[k][e] * sc[k][e] : df[k][e];
            o[e] = r * (gv - xf[k][e] * c);
            if (SCALED) acc[k][e] = fmaf(df[k][e] * xf[k][e], r, acc[k][e]);
          }
          dxu[(size_t)row * nu + u] = pack<T, V>(o);
        }
        xb[k] = nx[k];
        db[k] = nd[k];
      }
    } else {
      load(row, xb, db);
      float ss = 0.f, sg = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const float xv = to_f(xb[k]), dv = to_f(db[k]);
        ss = fmaf(xv, xv, ss);
        sg = fmaf(SCALED ? dv * sc[k][0] : dv, xv, sg);
      }
      row_sums(ss, sg, tpr, turn & 1);
      const float r = rsqrtf(ss / (float)D + eps);
      const float c = r * r * (sg / (float)D);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int u = t + tpr * k;
        if (row < rows && u < nu) {
          const float xv = to_f(xb[k]), dv = to_f(db[k]);
          const float gv = SCALED ? dv * sc[k][0] : dv;
          dx[(size_t)row * D + u] = from_f<T>(r * (gv - xv * c));
          if (SCALED) acc[k][0] = fmaf(dv * xv, r, acc[k][0]);
        }
      }
    }
  }
  if constexpr (SCALED) {
    __shared__ __align__(16) float part[256 * NV * V];   // row group g's columns at g * D
    __shared__ unsigned ticket;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int u = t + tpr * k;
      if (u < nu)
#pragma unroll
        for (int e = 0; e < V; ++e) part[rg * D + u * V + e] = acc[k][e];
    }
    __syncthreads();
    // the block's row, each column summed over the row groups in order, in
    // place (a column is one thread's alone)
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float v = part[j];
      for (int g = 1; g < R; ++g) v += part[g * D + j];
      part[j] = v;
    }
    // the cluster's row: each block sums its share of the columns over the
    // cluster's blocks in rank order, reading their shared memory
    cg::cluster_group cluster = cg::this_cluster();
    const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int n_clusters = gridDim.x / CL, cid = blockIdx.x / CL;
    const int q = (D & 3) == 0 ? 4 : 1;                  // a share is whole 16-byte columns
    const int lo = (int)((long long)(D / q) * rank / CL) * q;
    const int hi = (int)((long long)(D / q) * (rank + 1) / CL) * q;
    cluster.sync();
    for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
      float w[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < CL) w[r] = cluster.map_shared_rank(part, r)[j];
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < CL) v += w[r];
      partial[(size_t)cid * D + j] = v;
    }
    // done reading the others' rows (each waits for all before it leaves)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    // the last block to write its share of a cluster's row (counter `rank`)
    // sums that share over the clusters' rows, in cluster order; the
    // counter's acquire-release add orders the block's writes before it
    // and the others' before the sums
    __syncthreads();
    if (threadIdx.x == 0) ticket = atom_add_acq_rel(&counters[rank], 1u);
    __syncthreads();
    if (ticket == (unsigned)(n_clusters - 1)) {
      sum_rows(partial, n_clusters, D, lo, hi, ds);
      if (threadIdx.x == 0) counters[rank] = 0;
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

template <typename T, typename S, int V, int NV>
int launch_bwd_nv(const BwdArgs& a) {
  auto kernel = rmsnorm_bwd_kernel<T, S, V, NV>;
  const T* x = static_cast<const T*>(a.x);
  const S* s = static_cast<const S*>(a.s);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  S* ds = static_cast<S*>(a.ds);
  const int rows = (int)a.rows, D = (int)a.D, tpr = (int)a.tpr;
  const float eps = (float)a.eps;
  if constexpr (std::is_same<S, NoScale>::value) {
    kernel<<<(unsigned)a.blocks, 256, 0, a.stream>>>(x, s, dy, dx, a.partial, ds, a.counters,
                                                     rows, D, eps, tpr);
    return 0;
  } else {
    // clusters of a.cluster blocks; no more of them than fit on the card at
    // once (asked once per cluster size), so the grid is one wave
    const int cl = (int)a.cluster;
    if (cl < 1 || cl > 8 || (cl & (cl - 1)) || a.blocks % cl) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = a.stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static int fit[4] = {-1, -1, -1, -1};   // clusters that fit, by log2 of the size
    const int l2 = cl == 1 ? 0 : cl == 2 ? 1 : cl == 4 ? 2 : 3;
    if (fit[l2] < 0) {
      cfg.gridDim = dim3((unsigned)a.blocks);
      int n = 0;
      fit[l2] = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg) == cudaSuccess && n > 0 ? n : 0;
      cudaGetLastError();
    }
    long long blocks = a.blocks;
    if (fit[l2] > 0 && blocks > (long long)fit[l2] * cl) blocks = (long long)fit[l2] * cl;
    cfg.gridDim = dim3((unsigned)blocks);
    return (int)cudaLaunchKernelEx(&cfg, kernel, x, s, dy, dx, a.partial, ds, a.counters, rows, D,
                                   eps, tpr);
  }
}

template <typename T, typename S, int V>
int launch_bwd_v(const BwdArgs& a) {
  constexpr int MAX_NV = 32 / V;   // 32 floats of a thread's columns in registers
  switch (a.units) {
    case 1: return launch_bwd_nv<T, S, V, 1>(a);
    case 2: return launch_bwd_nv<T, S, V, 2>(a);
    case 4: return launch_bwd_nv<T, S, V, 4>(a);
    case 8: if constexpr (MAX_NV >= 8) return launch_bwd_nv<T, S, V, 8>(a); break;
    case 16: if constexpr (MAX_NV >= 16) return launch_bwd_nv<T, S, V, 16>(a); break;
    case 32: if constexpr (MAX_NV >= 32) return launch_bwd_nv<T, S, V, 32>(a); break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename S>
int launch_bwd(const BwdArgs& a) {
  constexpr int VEC = 16 / sizeof(T);
  if (a.vec == VEC) {
    if (a.D % VEC) return (int)cudaErrorInvalidValue;
    return launch_bwd_v<T, S, VEC>(a);
  }
  if (a.vec == 1) return launch_bwd_v<T, S, 1>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_by_scale(const BwdArgs& a) {
  switch (a.s_dtype) {
    case -1: return launch_bwd<T, NoScale>(a);
    case 0: return launch_bwd<T, float>(a);
    case 1: return launch_bwd<T, __nv_bfloat16>(a);
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
// (s_dtype -1, then partial, ds and counters are unused); ds (D,) in
// s_dtype.  Geometry from the host: tpr threads a row (a power of two up to
// 256), `units` units of `vec` elements a thread (vec = 16 / elt takes the
// 16-byte body, vec = 1 the scalar one; units * vec <= 32), with
// tpr * units * vec >= D; `blocks` blocks of 256 threads (with a scale in
// clusters of `cluster`, a power of two up to 8 that divides blocks; fewer
// blocks where not all fit on the card at once).  One kernel launch, with
// or without a scale.
extern "C" int rmsnorm_bwd_launch(const BwdArgs* a) {
  if (a->rows > 0 && a->D > 0) {
    if (a->tpr < 1 || a->tpr > 256 || (a->tpr & (a->tpr - 1)) ||
        a->tpr * a->units * a->vec < a->D || a->blocks < 1 ||
        (a->s_dtype >= 0 && (a->partial == nullptr || a->counters == nullptr)))
      return (int)cudaErrorInvalidValue;
    const int rc = a->x_dtype == 0   ? bwd_by_scale<float>(*a)
                   : a->x_dtype == 1 ? bwd_by_scale<__nv_bfloat16>(*a)
                                     : (int)cudaErrorInvalidValue;
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
