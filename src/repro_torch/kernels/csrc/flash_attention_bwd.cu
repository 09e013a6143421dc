// Backward of the blocked GQA attention: the gradients dQ, dK, dV of every
// attention layer of a training step.
//
// The Pallas kernel repro/kernels/flash_attention.py::flash_attention has
// no backward: jax.value_and_grad differentiates the jnp references the
// JAX package dispatches to.  This kernel computes the same gradients of
// the forward in flash_attention.cu, as ref.attention_bwd_ref does, from
// the forward's output O and its rows' log-sum-exp (lse, natural log):
//   P  = exp(s * scale - lse), s = q.k, masked keys exactly 0 (the
//        forward's mask: key j visible to query i when j < Skv and, when
//        causal, j <= i + Skv - Sq; a non-causal call may have Sq > Skv,
//        as whisper's cross-attention with more tokens than frames);
//   delta = rowsum(dO * O);  dS = P * (dO.V - delta);
//   dV = P^T dO;  dK = scale * dS^T Q;  dQ = scale * dS K,
// the G = Hq / Hkv query heads of a group summed into their KV head, each
// gradient written in its input's type.
//
// Bound on this card: operations (5 products of 2 * D flops a visible
// (query, key) pair; at qwen3-1.7B's S = 4096, 16/8 heads, D = 128, 0.174 ms
// at an H100 SXM's published 989 TFLOP/s of bf16).  Two roles share one
// grid and no float atomics are used, so a call is bit for bit repeatable:
// key-tile blocks own dK and dV of their keys (summing the group's heads in
// registers), and query-tile blocks own dQ; both recompute S and dP, 7
// products in all.
// Two bodies:
//
//  * float32 (flash_bwd_kernel): f32 on the CUDA cores with no TF32, so
//    the wikikv-router's training matches the CPU to float tolerance and a
//    restart is bit exact.  256 threads, tiles of 64 queries and 64 keys
//    staged as f32 in shared memory (row pitch D + 4, so a thread's 16-byte
//    loads of neighbouring rows hit distinct banks); delta is computed as a
//    block stages dO.  A thread owns a 4 x 4 piece of each 64 x 64 score
//    tile (rows ty + 16 i, columns tx + 16 j) and 4 rows x D / 16 columns of
//    its accumulators.
//  * bfloat16 (flash_bwd_wgmma_kernel, after flash_bwd_delta_kernel):
//    Hopper's warp-specialised shape, the forward's made for the backward.
//     - a pre-pass writes delta and lse * log2 e for every query row into a
//       (B * Hq, ceil(Sq / 64) * 64) f32 workspace, padded rows 0 and +inf
//       (a padded query then contributes exactly nothing);
//     - a key-tile block: one or two consumer warpgroups of 64 keys of one
//       KV head (the host picks, as the forward's query_tile does).  K and
//       V stay in shared memory; dK and dV (64 x D f32 each) stay in
//       registers across its heads and every query tile that sees the keys
//       (causal: from the first such tile).  Its heads are the group's G,
//       or with a head split c > 1 (bwd_geometry: the least c for which
//       the longest key-tile block, ceil(G / c) heads, costs no more than
//       one SM's share of the grid) the part [p G / c, (p + 1) G / c) of
//       c neighbouring blocks of the same keys.  Where a KV head's keys
//       are few against the card (internvl2-1b's 2 KV heads of 7 query
//       heads, dbrx-132b's 1024 keys of 6) the unsplit key-tile blocks ran
//       G times one SM's share while the rest of the card idled.  Each
//       split block writes its f32 partials (128 x DP floats a warpgroup)
//       to the workspace, then draws an integer ticket; the block that
//       draws its keys' last sums the c partials in part order (never in
//       arrival order), so dK and dV are the same bits on every call, and
//       resets the ticket, so a captured graph replays.  No float atomics;
//       at c = 1 (every group of 4 or less, kimi-k2's 8, whisper) the
//       launch runs an instance without the split's code (SPLIT false:
//       with it inside, a ragged row read 6% slower).  For each query tile
//       S^T = K Q^T and dP^T = V dO^T are m64n64k16 wgmma with both operands
//       in shared memory; P^T = exp2(S^T scale log2 e - lse2) (one
//       ex2.approx.ftz, hopper.cuh fast_exp2) and
//       dS^T = P^T (dP^T - delta) on the accumulators; the accumulator
//       layout rounded to bf16 is the A fragment of dV += P^T dO and
//       dK += dS^T Q (m64n{D}k16), dO and Q read MN-major from the tiles
//       they arrived in, so P and dS never pass through shared memory;
//     - a query-tile block: one or two warpgroups of 64 queries of one
//       query head, Q and dO resident; for each visible key tile S = Q K^T
//       and dP = dO V^T, dS, then dQ += dS K (K read MN-major);
//     - one producer thread issues every copy: TMA over 4-D tensor maps
//       (D, rows, heads, sequences) that take q, k, v and dO at their own
//       strides (dO arrives transposed from the attention layer: no copy),
//       a ragged tail zero-filled, never the next head's rows, in the
//       swizzle that fits rows of D bf16 (kimi-k2's D = 112 in tiles padded
//       to 128 columns that TMA zero-fills: hopper.cuh Atoms::DP); the streamed tiles (Q, dO and
//       their lse2 and delta by a bulk copy; or K, V) through a ring of
//       three stages with full and empty mbarriers; with two consumer
//       warpgroups the producer drops to 24 registers and they rise to 240;
//     - only tiles that straddle the diagonal (or, for dQ, the ragged Skv
//       tail) compute the mask; each role's longest blocks start first, and
//       the role whose longest block is longer comes first in the grid;
//     - the epilogue writes dK * scale, dV and dQ * scale through the
//       warpgroup's own resident tiles and TMA stores that drop rows past
//       the end.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// The C entry's one argument, packed by the wrapper in one buffer: outside
// the anonymous namespace, so the entry's signature names a type of its own.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const float* lse;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* ws;                   // bf16: lse2 and delta (B * Hq * Sq_pad floats each), then
                               // with a head split the dK and dV partials of every key-tile block
  unsigned* tickets;           // bf16 with a head split: a counter a (sequence, KV head, key
                               // tile), 0 on entry and left 0
  long long B, Hq, Hkv, Sq, Skv, D, dtype, causal;
  double scale;
  long long block;             // bf16: keys or queries a block, 64 or 128
  long long dq_first;          // bf16: the query-tile blocks come first
  long long head_split;        // bf16: key-tile blocks a (sequence, KV head, key tile), 1..G
  long long strides[12];       // bf16: (sequence, head, row) element strides of q, k, v, dout
  cudaStream_t stream;
};
static_assert(sizeof(BwdArgs) == 36 * 8, "BwdArgs must match the wrapper's \"<19qd16q\"");

namespace {

using namespace hopper;

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int BT = 64;          // queries, and keys, a tile
constexpr int THREADS = 256;    // 16 x 16 threads (ty, tx)
constexpr int LP = BT + 4;      // the pitch of the P and dS tiles

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
struct Geo {
  static constexpr int LD = D + 4;             // the pitch of the Q, K, V and dO tiles
  static constexpr int ND = D / 16;            // accumulator columns a thread
  // of them adjacent (one vector load): 4, 2 or 1, dividing ND (7 at D = 112)
  static constexpr int VW = ND % 4 == 0 ? 4 : ND % 2 == 0 ? 2 : 1;
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
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int n_valid) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < BT * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    const float4 v = r < n_valid ? load4(src + (size_t)r * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * Geo<D>::LD + c) = v;
  }
}

// dO's tile like load_tile, and delta = rowsum(dO * O) of its rows: a row
// takes C4P adjacent lanes of one warp, the power of two at or above
// C4 = D / 4 (32 at D = 112, whose last 4 lanes load nothing), and every
// thread runs the same number of rounds (BT * C4P is a multiple of 256).
template <int D>
__device__ __forceinline__ void load_do_delta(float* dst, float* delta, const float* __restrict__ dout,
                                              const float* __restrict__ o, int n_valid) {
  constexpr int C4 = D / 4;
  constexpr int C4P = C4 <= 4 ? 4 : C4 <= 8 ? 8 : C4 <= 16 ? 16 : 32;
  static_assert(C4 <= 32 && (BT * C4P) % THREADS == 0, "rows of dO within a warp");
  for (int i = threadIdx.x; i < BT * C4P; i += THREADS) {
    const int r = i / C4P, c = (i % C4P) * 4;
    const bool col = c < D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (col && r < n_valid) {
      a = load4(dout + (size_t)r * D + c);
      b = load4(o + (size_t)r * D + c);
    }
    if (col) *reinterpret_cast<float4*>(dst + r * Geo<D>::LD + c) = a;
    float dot = a.x * b.x;
    dot = fmaf(a.y, b.y, dot);
    dot = fmaf(a.z, b.z, dot);
    dot = fmaf(a.w, b.w, dot);
#pragma unroll
    for (int off = C4P / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
    if (i % C4P == 0) delta[r] = dot;
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
template <int D>
__device__ __forceinline__ void write_rows(float* __restrict__ out, const float (&acc)[4][D / 16],
                                           int ty, int tx, int n_rows, float mult) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) out[(size_t)r * D + acc_col<D>(tx, c)] = acc[i][c] * mult;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ lse, const float* __restrict__ dout,
                 float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int Hq,
                 int Hkv, int Sq, int Skv, int causal, float scale, int n_kv_blocks, int n_kt,
                 int n_qt) {
  using G = Geo<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int group = Hq / Hkv;
  const int seq_off = Skv - Sq;   // < 0 only when not causal, and then never read
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

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma, one producer warp and one or two consumer
// warpgroups; a delta pre-pass
// ---------------------------------------------------------------------------
constexpr int ROWS = 64;                      // a warpgroup's keys or queries; a streamed tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tiles : Atoms<D> {
  static constexpr int STAGES = 3;
  static constexpr int TILE = ROWS * Atoms<D>::DP * 2;   // bytes of a tile of 64 rows
};

// resident tiles (K and V, or Q and dO: NWG of each), the ring's stages
// (two tiles each, and 64 lse2 and 64 delta in the key role), and the
// 1024-byte alignment of the 128-byte swizzle
template <int D, int NWG>
constexpr int wgmma_smem_bytes() {
  return 2 * NWG * Tiles<D>::TILE + 2 * Tiles<D>::STAGES * Tiles<D>::TILE +
         2 * Tiles<D>::STAGES * ROWS * 4 + 1024;
}

struct BwdMaps {
  CUtensorMap q, k, v, dout;   // loads: (D, rows, heads, sequences), any 16-byte strides
  CUtensorMap dq, dk, dv;      // stores: contiguous; rows past the end are dropped
};

struct BwdShape {
  const float* lse2;           // (B * Hq, Sq_pad): lse * log2 e, +inf past Sq
  const float* delta;          // (B * Hq, Sq_pad): rowsum(dO * O), 0 past Sq
  float* part;                 // split > 1: (pair, part, warpgroup) blocks of 128 x DP floats
  unsigned* tickets;           // split > 1: one a pair (sequence, KV head, key tile)
  int B, Hq, Hkv, Sq, Skv, Sq_pad, causal;
  int n_kv_blocks, n_kb, n_qb, n_qt, dq_first, split;
  float scale, scale_log2;
};

constexpr int BAR_CONSUMERS = 3;   // a named barrier of every consumer thread (1 + wg: one warpgroup)

// delta = rowsum(dO * O) in f32 and lse2 = lse * log2 e for every query
// row, written to (B * Hq, Sq_pad) rows padded to whole tiles of 64 (0 and
// +inf past Sq, so a padded query contributes nothing).  LPR lanes a row,
// the power of two at or above D / 8 (16 at D = 112, whose last 2 load
// nothing), 16 bytes each, summed by xor shuffles in a fixed order.
template <int D>
struct DeltaLanes {
  static constexpr int LPR = D / 8 <= 2 ? 2 : D / 8 <= 4 ? 4 : D / 8 <= 8 ? 8 : 16;
  static constexpr int RPB = 256 / LPR;   // rows a block
  static_assert(D / 8 <= 16, "a row within half a warp");
};

template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ lse2,
                       float* __restrict__ delta, int Hq, int Sq, int Sq_pad, long long do_b,
                       long long do_h, long long do_s, long long rows_total) {
  constexpr int LPR = DeltaLanes<D>::LPR;
  constexpr int RPB = DeltaLanes<D>::RPB;
  const int lr = threadIdx.x % LPR;
  const long long row = (long long)blockIdx.x * RPB + threadIdx.x / LPR;
  const bool valid = row < rows_total;
  const long long bh = row / Sq_pad;
  const int s = (int)(row % Sq_pad);
  const bool live = valid && s < Sq;
  float dot = 0.f;
  if (live && lr < D / 8) {
    const long long b = bh / Hq, h = bh % Hq;
    const uint4 a = *reinterpret_cast<const uint4*>(dout + b * do_b + h * do_h + s * do_s + lr * 8);
    const uint4 c = *reinterpret_cast<const uint4*>(o + (bh * Sq + s) * D + lr * 8);
    const __nv_bfloat162* ae = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* ce = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(ae[j]), y = __bfloat1622float2(ce[j]);
      dot = fmaf(x.x, y.x, dot);
      dot = fmaf(x.y, y.y, dot);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
  if (valid && lr == 0) {
    lse2[row] = live ? lse[bh * Sq + s] * LOG2E : __int_as_float(0x7f800000);
    delta[row] = live ? dot : 0.f;
  }
}

// A warpgroup's accumulators (64 rows x DP, rows of the thread as in
// acc_to_a) times mult, as bf16 into a 64-row tile of the TMA layout (the
// padded columns of D = 112 too: the store drops them).
template <int D>
__device__ __forceinline__ void stage_rows(uint32_t tile, const float (&acc)[Atoms<D>::DP / 2],
                                           float mult, int warp, int g, int t) {
  using A = Atoms<D>;
#pragma unroll
  for (int j = 0; j < A::DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const int a = col / A::ATOM_E;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off = (warp * 16 + g + 8 * r) * A::ATOM_B + (col % A::ATOM_E) * 2;
      const uint32_t sw = off ^ (((off >> 7) & A::SW_MASK) << 4);
      const uint32_t val = pack_bf16(acc[4 * j + 2 * r] * mult, acc[4 * j + 2 * r + 1] * mult);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(tile + a * ROWS * A::ATOM_B + sw), "r"(val)
                   : "memory");
    }
  }
}

// s (+)= X Y^T over D: X and Y 64-row tiles, K-major, m64n64k16 steps (7
// at D = 112: the padded columns are never read).
template <int D>
__device__ __forceinline__ void product_ss(float (&s)[32], uint32_t x, uint32_t y) {
  using A = Atoms<D>;
  constexpr uint32_t SBO = 8 * A::ATOM_B;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int a = kk * 16 / A::ATOM_E, c = (kk * 16 % A::ATOM_E) * 2;
    wgmma_ss_n64(s, make_desc(x + a * ROWS * A::ATOM_B + c, 16, SBO, A::LAYOUT),
                 make_desc(y + a * ROWS * A::ATOM_B + c, 16, SBO, A::LAYOUT), kk > 0);
  }
}

// acc += A Y over the 64 rows of tile y: A the bf16 fragments of a 64 x 64
// accumulator, Y read MN-major (LBO steps the D atoms, SBO 8 rows), n = DP.
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[Atoms<D>::DP / 2],
                                           const uint32_t (&a)[4][4], uint32_t y) {
  using A = Atoms<D>;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs<A::DP>(acc, a[j], make_desc(y + j * 16 * A::ATOM_B, ROWS * A::ATOM_B, 8 * A::ATOM_B,
                                     A::LAYOUT));
}

// A warpgroup's dK and dV accumulators (DP / 2 floats each a thread) to
// its 128 x DP block of partials, float4 j of thread tid at j * 128 + tid:
// a warp's stores are 512 contiguous bytes.
template <int D>
__device__ __forceinline__ void store_partials(float* dst, const float (&dk)[Atoms<D>::DP / 2],
                                               const float (&dv)[Atoms<D>::DP / 2], int tid) {
  constexpr int H = Atoms<D>::DP / 8;   // float4s of each accumulator
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    d4[j * 128 + tid] = make_float4(dk[4 * j], dk[4 * j + 1], dk[4 * j + 2], dk[4 * j + 3]);
    d4[(H + j) * 128 + tid] = make_float4(dv[4 * j], dv[4 * j + 1], dv[4 * j + 2], dv[4 * j + 3]);
  }
}

// The sum of a pair's `split` blocks of partials in partial-index order
// (part 0 first, whichever block summed them), into dk and dv: read past
// L1 (__ldcg), since other blocks wrote them in this launch.
template <int D>
__device__ __forceinline__ void sum_partials(float (&dk)[Atoms<D>::DP / 2],
                                             float (&dv)[Atoms<D>::DP / 2], const float* first,
                                             size_t part_stride, int split, int tid) {
  constexpr int H = Atoms<D>::DP / 8;
#pragma unroll
  for (int i = 0; i < Atoms<D>::DP / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int p = 0; p < split; ++p) {
    const float4* s4 = reinterpret_cast<const float4*>(first + p * part_stride);
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float4 a = __ldcg(s4 + j * 128 + tid), c = __ldcg(s4 + (H + j) * 128 + tid);
      dk[4 * j] += a.x;
      dk[4 * j + 1] += a.y;
      dk[4 * j + 2] += a.z;
      dk[4 * j + 3] += a.w;
      dv[4 * j] += c.x;
      dv[4 * j + 1] += c.y;
      dv[4 * j + 2] += c.z;
      dv[4 * j + 3] += c.w;
    }
  }
}

template <int D, int NWG, bool SPLIT>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ BwdMaps maps, const BwdShape sh) {
  using G = Tiles<D>;
  constexpr int ST = G::STAGES, T = G::TILE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * ST];   // resident full; ring full, empty
  __shared__ int last_part;                            // this block sums its pair's partials
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t res0 = (raw + 1023u) & ~1023u;       // K (key role) or Q (dQ role), NWG tiles
  const uint32_t res1 = res0 + NWG * T;               // V or dO
  const uint32_t ring = res1 + NWG * T;               // stage st: tiles at ring + 2T st, + T
  const uint32_t vecs = ring + 2 * ST * T;            // stage st: lse2 at vecs + 512 st, delta + 256
  const uint32_t r_bar = smem_u32(bars), f_bar = r_bar + 8, e_bar = f_bar + 8 * ST;

  // blocks [0, n_first) take the first role, the rest the other; each
  // role's longest blocks come first
  const int n_q_blocks = sh.B * sh.Hq * sh.n_qb;
  int idx = blockIdx.x;
  bool key_role;
  if (sh.dq_first) {
    key_role = idx >= n_q_blocks;
    if (key_role) idx -= n_q_blocks;
  } else {
    key_role = idx < sh.n_kv_blocks;
    if (!key_role) idx -= sh.n_kv_blocks;
  }
  // seq_off < 0 (more queries than keys) only when not causal: every use is behind causal
  const int group = sh.Hq / sh.Hkv, seq_off = sh.Skv - sh.Sq;
  int b, hk, h = 0, k0 = 0, q0 = 0, qt0 = 0, nq = 1, n_iter, pair = 0, part = 0, h_lo = 0;
  if (key_role) {
    // NWG * 64 keys of one KV head (a pair): every query tile that sees
    // them (causal: from the first query at or past the keys) of its part
    // of the group's heads, [part * G / split, (part + 1) * G / split); a
    // pair's split parts are neighbours in the grid
    part = SPLIT ? idx % sh.split : 0;
    pair = SPLIT ? idx / sh.split : idx;
    const int bkv = pair % (sh.B * sh.Hkv);
    b = bkv / sh.Hkv;
    hk = bkv % sh.Hkv;
    k0 = (pair / (sh.B * sh.Hkv)) * NWG * ROWS;
    qt0 = sh.causal ? max(0, k0 - seq_off) / ROWS : 0;
    nq = sh.n_qt - qt0;
    h_lo = SPLIT ? part * group / sh.split : 0;
    n_iter = (SPLIT ? (part + 1) * group / sh.split - h_lo : group) * nq;
  } else {
    // NWG * 64 queries of one query head: every key tile they see
    const int bh = idx % (sh.B * sh.Hq);
    b = bh / sh.Hq;
    h = bh % sh.Hq;
    hk = h / group;
    q0 = (sh.n_qb - 1 - idx / (sh.B * sh.Hq)) * NWG * ROWS;
    const int q_rows = min(NWG * ROWS, sh.Sq - q0);
    const int k_end = sh.causal ? min(sh.Skv, q0 + q_rows + seq_off) : sh.Skv;
    n_iter = (k_end + ROWS - 1) / ROWS;
  }
  const int wg = threadIdx.x >> 7;    // warpgroups 0..NWG-1 consume, NWG produces

  if (threadIdx.x == 0) {
    mbar_init(r_bar, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(f_bar + 8 * st, 1);
      mbar_init(e_bar + 8 * st, 4 * NWG);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread issues every copy --------------------------
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NWG * 128) {
      const CUtensorMap* m0 = key_role ? &maps.k : &maps.q;
      const CUtensorMap* m1 = key_role ? &maps.v : &maps.dout;
      const int r0 = key_role ? k0 : q0, rh = key_role ? hk : h;
      mbar_expect_tx(r_bar, 2 * NWG * T);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int a = 0; a < G::ATOMS; ++a) {
          const uint32_t off = w * T + a * ROWS * G::ATOM_B;
          tma_load_4d(res0 + off, m0, r_bar, a * G::ATOM_E, r0 + w * ROWS, rh, b);
          tma_load_4d(res1 + off, m1, r_bar, a * G::ATOM_E, r0 + w * ROWS, rh, b);
        }
      const CUtensorMap* s0 = key_role ? &maps.q : &maps.k;
      const CUtensorMap* s1 = key_role ? &maps.dout : &maps.v;
      for (int i = 0; i < n_iter; ++i) {
        const int st = i % ST;
        // the key role streams (Q, dO, lse2, delta) tiles of (head, query
        // tile); the dQ role (K, V) tiles of its KV head
        const int sh_h = key_role ? hk * group + h_lo + i / nq : hk;
        const int row = key_role ? (qt0 + i % nq) * ROWS : i * ROWS;
        const uint32_t f = f_bar + 8 * st, t0 = ring + 2 * st * T;
        mbar_wait(e_bar + 8 * st, ((i / ST) & 1) ^ 1);   // the first round passes at once
        mbar_expect_tx(f, 2 * T + (key_role ? 2 * ROWS * 4 : 0));
#pragma unroll
        for (int a = 0; a < G::ATOMS; ++a) {
          tma_load_4d(t0 + a * ROWS * G::ATOM_B, s0, f, a * G::ATOM_E, row, sh_h, b);
          tma_load_4d(t0 + T + a * ROWS * G::ATOM_B, s1, f, a * G::ATOM_E, row, sh_h, b);
        }
        if (key_role) {
          const size_t v0 = ((size_t)b * sh.Hq + sh_h) * sh.Sq_pad + row;
          bulk_load(vecs + 512 * st, sh.lse2 + v0, ROWS * 4, f);
          bulk_load(vecs + 512 * st + 256, sh.delta + v0, ROWS * 4, f);
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t x_wg = res0 + wg * T, y_wg = res1 + wg * T;
    const unsigned char* gen = smem_raw + (vecs - raw);   // the lse2 / delta ring, generic
    if (key_role) {
      // S^T = K Q^T and dP^T = V dO^T (keys as rows), P^T, dS^T; then
      // dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers
      const int kw0 = k0 + wg * ROWS;          // the warpgroup's first key
      const int key = kw0 + warp * 16 + g;     // this thread's keys: key, key + 8
      float dk[G::DP / 2], dv[G::DP / 2];
#pragma unroll
      for (int i = 0; i < G::DP / 2; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(r_bar, 0);
      for (int i = 0; i < n_iter; ++i) {
        const int st = i % ST;
        const int qs = (qt0 + i % nq) * ROWS + seq_off;   // the tile's first query position
        const uint32_t q_t = ring + 2 * st * T, do_t = q_t + T;
        const float* lse_s = reinterpret_cast<const float*>(gen + 512 * st);
        const float* delta_s = lse_s + ROWS;
        float s[32], dp[32];
        mbar_wait(f_bar + 8 * st, (i / ST) & 1);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        product_ss<D>(s, x_wg, q_t);
        product_ss<D>(dp, y_wg, do_t);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
        const bool mask = sh.causal && kw0 + ROWS - 1 > qs;   // the tile straddles the diagonal
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = 8 * (e >> 2) + 2 * t + (e & 1);
          float p = fast_exp2(fmaf(s[e], sh.scale_log2, -lse_s[col]));
          if (mask) p = key + 8 * ((e >> 1) & 1) <= qs + col ? p : 0.f;
          s[e] = p;
          dp[e] = p * (dp[e] - delta_s[col]);
        }
        uint32_t pa[4][4], da[4][4];
        acc_to_a<64>(s, pa);
        acc_to_a<64>(dp, da);
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
        product_rs<D>(dv, pa, do_t);
        product_rs<D>(dk, da, q_t);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        if (lane == 0) mbar_arrive(e_bar + 8 * st);   // this warp is done with the stage
      }
      if constexpr (SPLIT) {
        // this block's partials, then a ticket: the block that draws the
        // pair's last sums every part in index order and stores the pair
        constexpr size_t WG_FLOATS = 128 * G::DP;
        float* first = sh.part + (size_t)pair * sh.split * NWG * WG_FLOATS + wg * WG_FLOATS;
        store_partials<D>(first + (size_t)part * NWG * WG_FLOATS, dk, dv, tid);
        __threadfence();   // visible device-wide before the ticket is taken
        bar_sync(BAR_CONSUMERS, NWG * 128);
        if (threadIdx.x == 0) {
          const bool last = atomicAdd(sh.tickets + pair, 1u) == (unsigned)(sh.split - 1);
          if (last) sh.tickets[pair] = 0u;   // every part has drawn: reset for the next call
          last_part = last;
        }
        bar_sync(BAR_CONSUMERS, NWG * 128);
        if (!last_part) return;
        __threadfence();
        sum_partials<D>(dk, dv, first, NWG * WG_FLOATS, sh.split, tid);
      }
      // epilogue: dK * scale and dV through the warpgroup's K and V tiles
      bar_sync(1 + wg, 128);
      stage_rows<D>(x_wg, dk, sh.scale, warp, g, t);
      stage_rows<D>(y_wg, dv, 1.f, warp, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + wg, 128);
      if (tid == 0 && kw0 < sh.Skv) {
#pragma unroll
        for (int a = 0; a < G::ATOMS; ++a) {
          tma_store_4d(&maps.dk, x_wg + a * ROWS * G::ATOM_B, a * G::ATOM_E, kw0, hk, b);
          tma_store_4d(&maps.dv, y_wg + a * ROWS * G::ATOM_B, a * G::ATOM_E, kw0, hk, b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    } else {
      // S = Q K^T and dP = dO V^T, dS; then dQ += dS K, dS from registers
      const int qw0 = q0 + wg * ROWS;          // the warpgroup's first query
      const int row = qw0 + warp * 16 + g;     // this thread's queries: row, row + 8
      float l2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool live = row + 8 * r < sh.Sq;
        const size_t v0 = ((size_t)b * sh.Hq + h) * sh.Sq_pad + row + 8 * r;
        l2[r] = live ? sh.lse2[v0] : __int_as_float(0x7f800000);
        dl[r] = live ? sh.delta[v0] : 0.f;
      }
      float dq[G::DP / 2];
#pragma unroll
      for (int i = 0; i < G::DP / 2; ++i) dq[i] = 0.f;
      mbar_wait(r_bar, 0);
      for (int i = 0; i < n_iter; ++i) {
        const int st = i % ST;
        const int kt0 = i * ROWS;
        const uint32_t k_t = ring + 2 * st * T, v_t = k_t + T;
        float s[32], dp[32];
        mbar_wait(f_bar + 8 * st, (i / ST) & 1);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        product_ss<D>(s, x_wg, k_t);
        product_ss<D>(dp, y_wg, v_t);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
        // the ragged Skv tail, or a tile that straddles the diagonal
        const bool mask = kt0 + ROWS > sh.Skv || (sh.causal && kt0 + ROWS - 1 > qw0 + seq_off);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = (e >> 1) & 1;
          float p = fast_exp2(fmaf(s[e], sh.scale_log2, -l2[r]));
          if (mask) {
            const int kp = kt0 + 8 * (e >> 2) + 2 * t + (e & 1);
            p = kp < sh.Skv && (!sh.causal || kp <= row + 8 * r + seq_off) ? p : 0.f;
          }
          dp[e] = p * (dp[e] - dl[r]);
        }
        uint32_t da[4][4];
        acc_to_a<64>(dp, da);
        fence_regs(dq);
        wgmma_fence();
        product_rs<D>(dq, da, k_t);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
        fence_regs(da);
        if (lane == 0) mbar_arrive(e_bar + 8 * st);
      }
      // epilogue: dQ * scale through the warpgroup's Q tile
      bar_sync(1 + wg, 128);
      stage_rows<D>(x_wg, dq, sh.scale, warp, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + wg, 128);
      if (tid == 0 && qw0 < sh.Sq) {
#pragma unroll
        for (int a = 0; a < G::ATOMS; ++a)
          tma_store_4d(&maps.dq, x_wg + a * ROWS * G::ATOM_B, a * G::ATOM_E, qw0, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

template <int D>
int launch_f32(const BwdArgs& a) {
  constexpr int smem = Geo<D>::SMEM_FLOATS * (int)sizeof(float);
  auto kernel = flash_bwd_kernel<D>;
  static const cudaError_t attr =   // once per instantiation
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int Hq = (int)a.Hq, Hkv = (int)a.Hkv, Sq = (int)a.Sq, Skv = (int)a.Skv;
  const int n_kt = (Skv + BT - 1) / BT, n_qt = (Sq + BT - 1) / BT;
  const long long n_kv_blocks = a.B * Hkv * n_kt;
  const long long blocks = n_kv_blocks + a.B * Hq * n_qt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o), a.lse,
      static_cast<const float*>(a.dout), static_cast<float*>(a.dq), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), Hq, Hkv, Sq, Skv, (int)a.causal, (float)a.scale,
      (int)n_kv_blocks, n_kt, n_qt);
  return 0;
}

// A 4-D map (D, rows, heads, sequences) over a bf16 tensor whose rows are
// contiguous, with element strides (sequence, head, row); boxes of one
// column atom by 64 rows.
template <int D>
int map4(CUtensorMap* map, const void* ptr, long long rows, long long heads, long long B,
         const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Atoms<D>::ATOM_E, (cuuint32_t)ROWS, 1, 1};
  return bf16_map<D>(map, ptr, 4, dims, strides, box);
}

template <int D, int NWG, bool SPLIT>
int launch_wgmma(const BwdArgs& a) {
  constexpr int smem = wgmma_smem_bytes<D, NWG>();
  auto kernel = flash_bwd_wgmma_kernel<D, NWG, SPLIT>;
  static const cudaError_t attr =   // once per instantiation: it is host work on every launch
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long B = a.B, Hq = a.Hq, Hkv = a.Hkv, Sq = a.Sq, Skv = a.Skv;
  const long long Sq_pad = (Sq + ROWS - 1) / ROWS * ROWS;
  const long long rows_total = B * Hq * Sq_pad;
  float* lse2 = a.ws;
  float* delta = a.ws + rows_total;
  const long long group = Hq / Hkv;
  if (a.head_split < 1 || a.head_split > group || (a.head_split > 1 && a.tickets == nullptr))
    return (int)cudaErrorInvalidValue;

  constexpr int RPB = DeltaLanes<D>::RPB;
  flash_bwd_delta_kernel<D><<<(unsigned)((rows_total + RPB - 1) / RPB), 256, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.o), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
      lse2, delta, (int)Hq, (int)Sq, (int)Sq_pad, a.strides[9], a.strides[10], a.strides[11],
      rows_total);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  BwdMaps maps;
  const long long q_st[3] = {Hq * Sq * D, Sq * D, D}, k_st[3] = {Hkv * Skv * D, Skv * D, D};
  int rc = map4<D>(&maps.q, a.q, Sq, Hq, B, a.strides);
  if (!rc) rc = map4<D>(&maps.k, a.k, Skv, Hkv, B, a.strides + 3);
  if (!rc) rc = map4<D>(&maps.v, a.v, Skv, Hkv, B, a.strides + 6);
  if (!rc) rc = map4<D>(&maps.dout, a.dout, Sq, Hq, B, a.strides + 9);
  if (!rc) rc = map4<D>(&maps.dq, a.dq, Sq, Hq, B, q_st);
  if (!rc) rc = map4<D>(&maps.dk, a.dk, Skv, Hkv, B, k_st);
  if (!rc) rc = map4<D>(&maps.dv, a.dv, Skv, Hkv, B, k_st);
  if (rc) return rc;

  BwdShape sh;
  sh.lse2 = lse2;
  sh.delta = delta;
  sh.part = a.ws + 2 * rows_total;
  sh.tickets = a.tickets;
  sh.split = (int)a.head_split;
  sh.B = (int)B;
  sh.Hq = (int)Hq;
  sh.Hkv = (int)Hkv;
  sh.Sq = (int)Sq;
  sh.Skv = (int)Skv;
  sh.Sq_pad = (int)Sq_pad;
  sh.causal = (int)a.causal;
  sh.n_kb = (int)((Skv + NWG * ROWS - 1) / (NWG * ROWS));
  sh.n_qb = (int)((Sq + NWG * ROWS - 1) / (NWG * ROWS));
  sh.n_qt = (int)(Sq_pad / ROWS);
  sh.n_kv_blocks = (int)(B * Hkv * sh.n_kb * a.head_split);
  sh.dq_first = (int)a.dq_first;
  sh.scale = (float)a.scale;
  sh.scale_log2 = (float)a.scale * LOG2E;
  const long long blocks = B * Hkv * sh.n_kb * a.head_split + B * Hq * sh.n_qb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, (NWG + 1) * 128, smem, a.stream>>>(maps, sh);
  return 0;
}

// A head split runs its own instance: the unsplit launch (c = 1) keeps
// the kernel it had before the split was added.
template <int D>
int launch_bf16(const BwdArgs& a) {
  const bool split = a.head_split > 1;
  if (a.block == 128) return split ? launch_wgmma<D, 2, true>(a) : launch_wgmma<D, 2, false>(a);
  if (a.block == 64) return split ? launch_wgmma<D, 1, true>(a) : launch_wgmma<D, 1, false>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout and dq (B, Hq, Sq, D); k, v,
// dk and dv (B, Hkv, Skv, D); lse (B, Hq, Sq) f32 from the forward;
// Hq % Hkv == 0, 0 < Sq, and Sq <= Skv when causal.  float32: every tensor contiguous and
// 16-byte aligned.  bfloat16: o, lse and the outputs contiguous; q, k, v
// and dout of any strides (in elements, `strides`) whose rows are
// contiguous, each stride and base a multiple of 16 bytes; ws 2 * B * Hq *
// ceil(Sq / 64) * 64 floats of scratch, and with head_split c > 1 another
// B * Hkv * ceil(Skv / block) * c * block * 2 * DP (the partials); block
// 128 (two consumer warpgroups a block) or 64 (one); with c > 1, tickets
// B * Hkv * ceil(Skv / block) counters that are 0 (each launch leaves them
// 0).  Two kernel launches for bfloat16 (the delta pre-pass and the body),
// one for float32.
extern "C" int flash_attention_bwd_launch(const BwdArgs* a) {
  if (a->B > 0 && a->Hq > 0 && a->Sq > 0) {
    if (a->Hkv <= 0 || a->Hq % a->Hkv || (a->causal && a->Sq > a->Skv))
      return (int)cudaErrorInvalidValue;
    int rc = (int)cudaErrorInvalidValue;
    if (a->dtype == 0) {
      switch (a->D) {
        case 16: rc = launch_f32<16>(*a); break;
        case 32: rc = launch_f32<32>(*a); break;
        case 64: rc = launch_f32<64>(*a); break;
        case 112: rc = launch_f32<112>(*a); break;
        case 128: rc = launch_f32<128>(*a); break;
      }
    } else if (a->dtype == 1) {
      switch (a->D) {
        case 16: rc = launch_bf16<16>(*a); break;
        case 32: rc = launch_bf16<32>(*a); break;
        case 64: rc = launch_bf16<64>(*a); break;
        case 112: rc = launch_bf16<112>(*a); break;
        case 128: rc = launch_bf16<128>(*a); break;
      }
    }
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
