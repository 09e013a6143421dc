// Backward of the blocked GQA attention (FlashAttention-2's schedule): the
// gradients dQ, dK, dV of every attention layer of a training step.
//
// The Pallas kernel repro/kernels/flash_attention.py::flash_attention has
// no backward: jax.value_and_grad differentiates the jnp references the
// JAX package dispatches to.  This kernel computes the same gradients of
// the forward in flash_attention.cu, as ref.attention_bwd_ref does, from
// the forward's output O and its rows' log-sum-exp (lse, natural log):
//   P  = exp(s * scale - lse), s = q.k, masked keys exactly 0 (the
//        forward's mask: key j visible to query i when j < Skv and, when
//        causal, j <= i + Skv - Sq);
//   delta = rowsum(dO * O);  dS = P * (dO.V - delta);
//   dV = P^T dO;  dK = scale * dS^T Q;  dQ = scale * dS K,
// the G = Hq / Hkv query heads of a group summed into their KV head.
// f32 math throughout (bf16 inputs are widened as they are staged), each
// gradient written in its input's type.
//
// Bound on this card: operations (5 products of 2 * Sq * Skv * D flops a
// head, half of it when causal; this simple version recomputes S and dP
// in both of its roles, 7 products in all).  This first version runs the
// products on the CUDA cores in f32: a later PR moves them to wgmma.
//
// Schedule, one launch, no atomics (so a run is bit for bit repeatable):
//  * blocks [0, B * Hkv * n_kt) own one key tile of 64 keys of one KV
//    head: they walk the group's query heads and the query tiles that see
//    the tile, and keep dK and dV in registers until the end;
//  * the blocks after them own one query tile of 64 queries of one query
//    head: they walk the visible key tiles and keep dQ in registers.
// Each block stages its tiles in shared memory as f32 (row pitch D + 4,
// so a thread's 16-byte loads of neighbouring rows hit distinct banks)
// and computes delta for its query rows as it stages dO.  256 threads, a
// thread owns a 4 x 4 piece of each 64 x 64 score tile (rows ty + 16 i,
// columns tx + 16 j) and 4 rows x D / 16 columns of its accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;          // queries, and keys, a tile
constexpr int THREADS = 256;    // 16 x 16 threads (ty, tx)
constexpr int LP = BT + 4;      // the pitch of the P and dS tiles
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store_elt(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elt(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
struct Geo {
  static constexpr int LD = D + 4;             // the pitch of the Q, K, V and dO tiles
  static constexpr int ND = D / 16;            // accumulator columns a thread
  static constexpr int VW = ND < 4 ? ND : 4;   // of them adjacent (one vector load)
  static constexpr int NG = ND / VW;           // groups of VW columns, 16 * VW apart
  static constexpr int TILE = BT * LD;
  // the key-tile role's shared memory: K, V, Q, dO, P, dS, lse, delta
  static constexpr int SMEM_FLOATS = 4 * TILE + 2 * BT * LP + 2 * BT;
};

// Accumulator column c of thread tx: group c / VW, element c % VW.
template <int D>
__device__ __forceinline__ int acc_col(int tx, int c) {
  using G = Geo<D>;
  return (c / G::VW) * 16 * G::VW + tx * G::VW + c % G::VW;
}

// Rows [0, BT) of a (rows, D) matrix into a shared tile of pitch D + 4;
// rows at or past n_valid are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int n_valid) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < BT * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    const float4 v = r < n_valid ? load4(src + (size_t)r * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * Geo<D>::LD + c) = v;
  }
}

// dO's tile like load_tile, and delta = rowsum(dO * O) of its rows: the
// C4 = D / 4 threads of a row are adjacent lanes of one warp, and every
// thread runs the same number of rounds (BT * C4 is a multiple of 256).
template <int D, typename T>
__device__ __forceinline__ void load_do_delta(float* dst, float* delta, const T* __restrict__ dout,
                                              const T* __restrict__ o, int n_valid) {
  constexpr int C4 = D / 4;
  static_assert((BT * C4) % THREADS == 0 && 32 % C4 == 0, "rows of dO within a warp");
  for (int i = threadIdx.x; i < BT * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r < n_valid) {
      a = load4(dout + (size_t)r * D + c);
      b = load4(o + (size_t)r * D + c);
    }
    *reinterpret_cast<float4*>(dst + r * Geo<D>::LD + c) = a;
    float dot = a.x * b.x;
    dot = fmaf(a.y, b.y, dot);
    dot = fmaf(a.z, b.z, dot);
    dot = fmaf(a.w, b.w, dot);
#pragma unroll
    for (int off = C4 / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
    if (i % C4 == 0) delta[r] = dot;
  }
}

// Element e (a constant once unrolled) of a float4.
__device__ __forceinline__ float elt(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// s[i][j] = X1[ty + 16 i] . Y1[tx + 16 j] and t[i][j] = X2[ty + 16 i] . Y2[tx + 16 j]
// over the D columns of four shared tiles.
template <int D>
__device__ __forceinline__ void two_products(const float* X1, const float* X2, const float* Y1,
                                             const float* Y2, float (&s)[4][4], float (&t)[4][4],
                                             int ty, int tx) {
  constexpr int LD = Geo<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x1[4], x2[4], y1[4], y2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x1[i] = *reinterpret_cast<const float4*>(X1 + (ty + 16 * i) * LD + d);
      x2[i] = *reinterpret_cast<const float4*>(X2 + (ty + 16 * i) * LD + d);
      y1[i] = *reinterpret_cast<const float4*>(Y1 + (tx + 16 * i) * LD + d);
      y2[i] = *reinterpret_cast<const float4*>(Y2 + (tx + 16 * i) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = dot4(x1[i], y1[j], s[i][j]);
        t[i][j] = dot4(x2[i], y2[j], t[i][j]);
      }
  }
}

// acc[i][c] += sum over n < BT of A[ty + 16 i][n] * B[n][acc_col(tx, c)]:
// A a (BT, BT) tile of pitch LP, B a (BT, D) tile of pitch D + 4.
template <int D>
__device__ __forceinline__ void acc_product(const float* A, const float* B,
                                            float (&acc)[4][D / 16], int ty, int tx) {
  using G = Geo<D>;
#pragma unroll 2
  for (int n = 0; n < BT; n += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LP + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* brow = B + (n + e) * G::LD + tx * G::VW;
      float b[G::ND];
#pragma unroll
      for (int gi = 0; gi < G::NG; ++gi) {
        const float* bp = brow + gi * 16 * G::VW;
        if constexpr (G::VW == 4) {
          const float4 v = *reinterpret_cast<const float4*>(bp);
          b[4 * gi] = v.x;
          b[4 * gi + 1] = v.y;
          b[4 * gi + 2] = v.z;
          b[4 * gi + 3] = v.w;
        } else if constexpr (G::VW == 2) {
          const float2 v = *reinterpret_cast<const float2*>(bp);
          b[2 * gi] = v.x;
          b[2 * gi + 1] = v.y;
        } else {
          b[gi] = *bp;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < G::ND; ++c) acc[i][c] = fmaf(elt(a[i], e), b[c], acc[i][c]);
    }
  }
}

// Rows row0 + ty + 16 i (< n_rows) of a (rows, D) output, times mult.
template <int D, typename T>
__device__ __forceinline__ void write_rows(T* __restrict__ out, const float (&acc)[4][D / 16],
                                           int ty, int tx, int n_rows, float mult) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) store_elt(out + (size_t)r * D + acc_col<D>(tx, c), acc[i][c] * mult);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ o, const float* __restrict__ lse,
                 const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
                 T* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
                 int n_kv_blocks, int n_kt, int n_qt) {
  using G = Geo<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int group = Hq / Hkv;
  const int seq_off = Skv - Sq;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float INF = __int_as_float(0x7f800000);

  if ((int)blockIdx.x < n_kv_blocks) {
    // ---- dK and dV of one key tile --------------------------------------
    const int kt = blockIdx.x % n_kt, bkv = blockIdx.x / n_kt;   // bkv = b * Hkv + kv head
    const int b = bkv / Hkv, hk = bkv % Hkv;
    const int k0 = kt * BT, k_rows = min(BT, Skv - k0);
    float* Ks = smem;
    float* Vs = Ks + G::TILE;
    float* Qs = Vs + G::TILE;
    float* dOs = Qs + G::TILE;
    float* Ps = dOs + G::TILE;
    float* dSs = Ps + BT * LP;
    float* lse_s = dSs + BT * LP;
    float* delta_s = lse_s + BT;
    load_tile<D>(Ks, k + ((size_t)bkv * Skv + k0) * D, k_rows);
    load_tile<D>(Vs, v + ((size_t)bkv * Skv + k0) * D, k_rows);
    float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
    // query i sees key j when j <= i + seq_off: tiles before qt0 see none of these keys
    const int qt0 = causal ? max(0, k0 - seq_off) / BT : 0;
    for (int h = hk * group; h < (hk + 1) * group; ++h) {
      const size_t bh = (size_t)b * Hq + h;
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int q0 = qt * BT, q_rows = min(BT, Sq - q0);
        __syncthreads();   // every thread is done with the previous query tile
        load_tile<D>(Qs, q + (bh * Sq + q0) * D, q_rows);
        load_do_delta<D>(dOs, delta_s, dout + (bh * Sq + q0) * D, o + (bh * Sq + q0) * D, q_rows);
        if (threadIdx.x < BT)
          lse_s[threadIdx.x] = (int)threadIdx.x < q_rows ? lse[bh * Sq + q0 + threadIdx.x] : INF;
        __syncthreads();
        float s[4][4], dp[4][4];   // transposed: row = key, column = query
        two_products<D>(Ks, Vs, Qs, dOs, s, dp, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kr = ty + 16 * i, qc = tx + 16 * j;
            const int key = k0 + kr, qi = q0 + qc;
            const bool ok = key < Skv && qi < Sq && (!causal || key <= qi + seq_off);
            const float p = ok ? expf(s[i][j] * scale - lse_s[qc]) : 0.f;
            Ps[kr * LP + qc] = p;
            dSs[kr * LP + qc] = p * (dp[i][j] - delta_s[qc]);
          }
        __syncthreads();
        acc_product<D>(Ps, dOs, dv_acc, ty, tx);
        acc_product<D>(dSs, Qs, dk_acc, ty, tx);
      }
    }
    write_rows<D>(dk + ((size_t)bkv * Skv + k0) * D, dk_acc, ty, tx, k_rows, scale);
    write_rows<D>(dv + ((size_t)bkv * Skv + k0) * D, dv_acc, ty, tx, k_rows, 1.f);
  } else {
    // ---- dQ of one query tile -------------------------------------------
    const int idx = blockIdx.x - n_kv_blocks;
    const int qt = n_qt - 1 - idx % n_qt;   // the longest causal tiles start first
    const int bh = idx / n_qt;
    const int b = bh / Hq, h = bh % Hq;
    const int bkv = b * Hkv + h / group;
    const int q0 = qt * BT, q_rows = min(BT, Sq - q0);
    float* Qs = smem;
    float* dOs = Qs + G::TILE;
    float* Ks = dOs + G::TILE;
    float* Vs = Ks + G::TILE;
    float* dSs = Vs + G::TILE;
    float* lse_s = dSs + BT * LP;
    float* delta_s = lse_s + BT;
    load_tile<D>(Qs, q + ((size_t)bh * Sq + q0) * D, q_rows);
    load_do_delta<D>(dOs, delta_s, dout + ((size_t)bh * Sq + q0) * D,
                     o + ((size_t)bh * Sq + q0) * D, q_rows);
    if (threadIdx.x < BT)
      lse_s[threadIdx.x] =
          (int)threadIdx.x < q_rows ? lse[(size_t)bh * Sq + q0 + threadIdx.x] : INF;
    float dq_acc[4][D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) dq_acc[i][c] = 0.f;
    // keys at or past k_end are masked for every query of this tile
    const int k_end = causal ? min(Skv, q0 + q_rows + seq_off) : Skv;
    for (int k0 = 0; k0 < k_end; k0 += BT) {
      const int k_rows = min(BT, Skv - k0);
      __syncthreads();   // the staged query tile is complete; the last key tile is read
      load_tile<D>(Ks, k + ((size_t)bkv * Skv + k0) * D, k_rows);
      load_tile<D>(Vs, v + ((size_t)bkv * Skv + k0) * D, k_rows);
      __syncthreads();
      float s[4][4], dp[4][4];   // row = query, column = key
      two_products<D>(Qs, dOs, Ks, Vs, s, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = ty + 16 * i, kc = tx + 16 * j;
          const int qi = q0 + qr, key = k0 + kc;
          const bool ok = key < Skv && qi < Sq && (!causal || key <= qi + seq_off);
          const float p = ok ? expf(s[i][j] * scale - lse_s[qr]) : 0.f;
          dSs[qr * LP + kc] = p * (dp[i][j] - delta_s[qr]);
        }
      __syncthreads();
      acc_product<D>(dSs, Ks, dq_acc, ty, tx);
    }
    write_rows<D>(dq + ((size_t)bh * Sq + q0) * D, dq_acc, ty, tx, q_rows, scale);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
           int causal, float scale, cudaStream_t stream) {
  constexpr int smem = Geo<D>::SMEM_FLOATS * (int)sizeof(float);
  auto kernel = flash_bwd_kernel<D, T>;
  static const cudaError_t attr =   // once per instantiation
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_kt = (Skv + BT - 1) / BT, n_qt = (Sq + BT - 1) / BT;
  const long long n_kv_blocks = (long long)B * Hkv * n_kt;
  const long long blocks = n_kv_blocks + (long long)B * Hq * n_qt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), lse, static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq, Skv, causal, scale,
      (int)n_kv_blocks, n_kt, n_qt);
  return 0;
}

template <typename T>
int by_dim(int D, const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
           int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<16, T>(q, k, v, o, lse, dout, dq, dk, dv, B, Hq, Hkv, Sq, Skv, causal, scale,
                           stream);
    case 32:
      return launch<32, T>(q, k, v, o, lse, dout, dq, dk, dv, B, Hq, Hkv, Sq, Skv, causal, scale,
                           stream);
    case 64:
      return launch<64, T>(q, k, v, o, lse, dout, dq, dk, dv, B, Hq, Hkv, Sq, Skv, causal, scale,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, o, lse, dout, dq, dk, dv, B, Hq, Hkv, Sq, Skv, causal,
                            scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout and dq (B, Hq, Sq, D); k, v,
// dk and dv (B, Hkv, Skv, D); lse (B, Hq, Sq) f32 from the forward; all
// contiguous and 16-byte aligned; Hq % Hkv == 0, 0 < Sq <= Skv.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const float* lse, const void* dout,
                                          void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                                          int Sq, int Skv, int D, int dtype, int causal,
                                          float scale, cudaStream_t stream) {
  if (B > 0 && Hq > 0 && Sq > 0) {
    if (Hkv <= 0 || Hq % Hkv || Sq > Skv) return (int)cudaErrorInvalidValue;
    const int rc = dtype == 0
        ? by_dim<float>(D, q, k, v, o, lse, dout, dq, dk, dv, B, Hq, Hkv, Sq, Skv, causal, scale,
                        stream)
        : dtype == 1
        ? by_dim<__nv_bfloat16>(D, q, k, v, o, lse, dout, dq, dk, dv, B, Hq, Hkv, Sq, Skv, causal,
                                scale, stream)
        : (int)cudaErrorInvalidValue;
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
