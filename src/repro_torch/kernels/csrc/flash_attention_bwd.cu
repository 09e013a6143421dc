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
//  * float32 (flash_bwd_f32_kernel, after flash_bwd_delta_f32_kernel): the
//    wikikv-router's training (every train_router step: 4 calls at
//    (8, 4/2, 128 x 128, 64)) and every f32 training parity run, within
//    the plain version's float tolerance, bit for bit repeatable so that
//    a restart is bit exact.  Bound: operations; every product in 3xTF32
//    (tf32.cuh: hi and lo TF32 halves of every operand, three
//    tensor-core products a product, f32 accumulate: 165e12 effective
//    FLOP/s against the CUDA cores' 67e12).  S and dP (S^T and dP^T in
//    the key role) read both operands K-major as they are stored, so up
//    to D = 64 they run on wgmma.m64n32k8, each warpgroup over its half of
//    the streamed tile, from hi and lo tiles that every landed tile is
//    split into once (hi in place, lo in a buffer of its own; the second
//    products then read both halves with no conversion): the router's
//    training backward 0.0264 -> 0.0191 ms on an H100 at 700 W
//    (scripts/time_backward.py --bodies).  At D = 112 and 128 the lo
//    tiles would need 320 KB of shared memory, so there, and for dV, dK
//    and dQ everywhere (their B operands are not K-major), the products
//    run on mma.sync.m16n8k8 with fragments split as they are loaded.  The bf16
//    body's grid and roles with eight warps a block: tiles of 64 keys or
//    queries (16 rows a warp, each of a warp pair over half the streamed
//    tile's 64 columns, their sums added through shared memory at the
//    end: at D = 112 and 128 the tiles leave room for one block an SM,
//    and four warps there ran latency-bound), the resident pair (K, V or Q, dO) and a ring of
//    two stages of streamed tiles, all by TMA over f32 tensor maps in the
//    128-byte swizzle (D = 112 padded to 128 columns, zero-filled), the
//    key role's lse2 and delta by bulk copies from the pre-pass's
//    workspace; thread 0 refills a stage once every warp is past it.  P^T
//    and dS^T (or dS) are the A operands of the second products straight
//    from the accumulators (the depth permuted, and dO, Q or K read in the
//    same order).  A key-tile block keeps dV and dK (D / 2 floats a
//    thread each: with four warps a block, a thread held D of each and
//    ptxas spilled 5-8 KB at D = 112 and 128).  The head split of the bf16
//    body, by the same rule (bwd_geometry): kimi-k2's group of 8 over
//    300 x 1037 runs 136 key-tile blocks of one head each where it ran 17
//    of all 8, and the router's group of 2 runs 64 where it ran 32.  Where
//    the longest query-tile block would then outlast the longest key-tile
//    block and one SM's share, its key tiles are cut into d parts
//    (dq_split, the wrapper's pure function) whose dQ the last to finish
//    sums in part order: kimi-k2's 40 query-tile blocks of 17 key tiles
//    run as 120 of 5 or 6.  Gradients go from the accumulators to global
//    memory.
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
#include "tf32.cuh"

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
  float* ws;                   // lse2 and delta (B * Hq * Sq_pad floats each), then with a
                               // head split the dK and dV partials of every key-tile block
  unsigned* tickets;           // with a head split: a counter a (sequence, KV head, key
                               // tile), 0 on entry and left 0
  long long B, Hq, Hkv, Sq, Skv, D, dtype, causal;
  double scale;
  long long block;             // keys or queries a block: 64 or 128 (bf16), 64 (f32)
  long long dq_first;          // the query-tile blocks come first
  long long head_split;        // key-tile blocks a (sequence, KV head, key tile), 1..G
  long long dq_split;          // f32: query-tile blocks a (query head, query tile); bf16: 1
  long long wgmma;             // f32: S and dP on wgmma (1, head_dim <= 64) or mma.sync (0)
  long long strides[12];       // bf16: (sequence, head, row) element strides of q, k, v, dout
  cudaStream_t stream;
};
static_assert(sizeof(BwdArgs) == 38 * 8, "BwdArgs must match the wrapper's \"<19qd18q\"");

namespace {

using namespace hopper;

constexpr unsigned FULL = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// float32: TMA + 3xTF32 on wgmma and mma.sync (tf32.cuh), after a delta pre-pass
// ---------------------------------------------------------------------------
namespace f32body {

// QW column groups of four warps: warp w takes 16 keys (key role) or
// queries (dQ role), rows 16 (w % 4), against group w / 4 of the streamed
// tile's 64 columns
constexpr int QW = 2;
constexpr int THREADS = 128 * QW;
constexpr int STAGES = 2;      // the ring of streamed tiles
constexpr int NS = 8 / QW;     // n8 blocks of a warp's 64 / QW score columns

template <int D>
struct Bwd {
  using A = tf32::Atoms<D>;
  static constexpr int TILE = ROWS * A::DP * 4;    // bytes of a tile of 64 rows
  static constexpr int NT = D / 8;                 // n8 blocks of a gradient row (padding unread)
  // resident tiles (K and V, or Q and dO), the stages' tiles, the stages'
  // lse2 and delta (key role), and the 1024-byte alignment of the swizzle
  static constexpr int SMEM = 2 * TILE + STAGES * 2 * TILE + STAGES * 2 * ROWS * 4 + 1024;
  // with S and dP on wgmma, the lo halves of the resident pair and of the
  // stage being read follow (hopper's 227 KB hold them up to D = 64)
  static constexpr int LO = SMEM - 1024;
  static constexpr int SMEM_WG = SMEM + 4 * TILE;
  static constexpr bool WG_FITS = SMEM_WG <= 227 * 1024;
};

// delta = rowsum(dO * O) and lse2 = lse * log2 e for every query row, as
// flash_bwd_delta_kernel does for bf16: LPR lanes a row, the power of two
// at or above D / 4 (32 at D = 112, whose last 4 load nothing), 16 bytes
// each, summed by xor shuffles in a fixed order.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_f32_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                           const float* __restrict__ lse, float* __restrict__ lse2,
                           float* __restrict__ delta, int Sq, int Sq_pad, long long rows_total) {
  constexpr int LPR = D / 4 <= 4 ? 4 : D / 4 <= 8 ? 8 : D / 4 <= 16 ? 16 : 32;
  constexpr int RPB = 256 / LPR;
  const int lr = threadIdx.x % LPR;
  const long long row = (long long)blockIdx.x * RPB + threadIdx.x / LPR;
  const bool valid = row < rows_total;
  const long long bh = row / Sq_pad;
  const int s = (int)(row % Sq_pad);
  const bool live = valid && s < Sq;
  float dot = 0.f;
  if (live && lr < D / 4) {
    const float4 a = *reinterpret_cast<const float4*>(dout + (bh * Sq + s) * D + lr * 4);
    const float4 c = *reinterpret_cast<const float4*>(o + (bh * Sq + s) * D + lr * 4);
    dot = a.x * c.x;
    dot = fmaf(a.y, c.y, dot);
    dot = fmaf(a.z, c.z, dot);
    dot = fmaf(a.w, c.w, dot);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
  if (valid && lr == 0) {
    lse2[row] = live ? lse[bh * Sq + s] * LOG2E : __int_as_float(0x7f800000);
    delta[row] = live ? dot : 0.f;
  }
}

struct Maps {
  CUtensorMap q, k, v, dout;   // (D, rows, B * heads), contiguous f32
};

struct Shape {
  const float* lse2;           // (B * Hq, Sq_pad): lse * log2 e, +inf past Sq
  const float* delta;          // (B * Hq, Sq_pad): rowsum(dO * O), 0 past Sq
  float* part;                 // split > 1: (pair, dV or dK, part) blocks of 128 x D / 2 floats
  float* qpart;                // dq_split > 1: (query head, query tile, part) blocks, the same
  unsigned* tickets;           // split > 1: two a pair (sequence, KV head, key tile), dV and
                               // dK; dq_split > 1: from q_ticket0 one a (query head, tile)
  float* dq;
  float* dk;
  float* dv;
  int B, Hq, Hkv, Sq, Skv, Sq_pad, causal;
  int n_kv_blocks, n_kt, n_qt, dq_first, split, dq_split, q_ticket0;
  float scale, scale_log2;
};

// The other column groups' accumulators added to group 0's (the thread
// of the same row and lane), groups 1, 2, ... in that order, through
// shared memory: group 0 then holds the block's sums.  Every thread of the
// block calls it.
template <int NT>
__device__ __forceinline__ void sum_groups(float (&acc)[NT][4], float4* red, int grp, int tq) {
  if (grp > 0)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      red[((grp - 1) * NT + j) * 128 + tq] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  __syncthreads();
  if (grp == 0)
    for (int q = 0; q < QW - 1; ++q)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 x = red[(q * NT + j) * 128 + tq];
        acc[j][0] += x.x;
        acc[j][1] += x.y;
        acc[j][2] += x.z;
        acc[j][3] += x.w;
      }
}

// A block's accumulator summed over its column groups and, with parts > 1,
// over the parts of its slot: this part's sums go to the workspace
// (float4 j of thread tq at j * 128 + tq, coalesced), then a ticket; the
// block that draws the slot's last sums parts 0, 1, ... from the workspace
// (its own included, past L1: other blocks wrote them) and resets the
// ticket, so the sums are the same bits whoever arrives last and a
// captured graph replays.  Every thread of the block calls it; true in
// the threads that then hold the whole sums (group 0 of that block).
template <int NT>
__device__ __forceinline__ bool finish(float (&acc)[NT][4], float4* red, int grp, int tq,
                                       float4* slot_parts, int part, int parts,
                                       unsigned* ticket, int* last_flag) {
  sum_groups<NT>(acc, red, grp, tq);
  if (parts == 1) return grp == 0;
  float4* mine = slot_parts + (size_t)part * NT * 128;
  if (grp == 0)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mine[j * 128 + tq] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  __threadfence();                            // visible device-wide before the ticket is drawn
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(ticket, 1u) == (unsigned)(parts - 1);
    if (last) *ticket = 0u;                   // every part has drawn: reset for the next call
    *last_flag = last;
  }
  __syncthreads();
  if (!*last_flag || grp != 0) return false;
  __threadfence();
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float4* pp = slot_parts + (size_t)p * NT * 128 + tq;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 a = __ldcg(pp + j * 128);
      acc[j][0] += a.x;
      acc[j][1] += a.y;
      acc[j][2] += a.z;
      acc[j][3] += a.w;
    }
  }
  return true;
}

// Rows row, row + 8 (< n_rows) of thread (g, t)'s accumulator block, times
// mult, into a (rows, D) f32 matrix: float2 a thread.
template <int D, int NT>
__device__ __forceinline__ void write_rows(float* out, const float (&acc)[NT][4], int row, int t,
                                           int n_rows, float mult) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= n_rows) continue;
    float* o = out + (size_t)(row + 8 * r) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[j][2 * r] * mult,
                                                          acc[j][2 * r + 1] * mult);
  }
}

// The grid of the bf16 body with blocks of 64 rows and eight warps.
// Key-tile blocks own dV and dK of 64 keys of one KV head, walking every
// query tile that sees the keys of their part of the group's heads.  Query-tile blocks own dQ of 64
// queries of one query head, walking the key tiles they see, or with a
// dQ split (dq_split > 1) part p of them.  A warp takes 16 rows against
// half the streamed tile's columns, and the halves are added at the end.
// Every product is 3xTF32: S^T = K Q^T and dP^T = V dO^T (K and V as A
// from the resident tiles, Q and dO as B from the streamed ones; with WG
// on wgmma from their hi and lo tiles, else on mma.sync), P^T and dS^T on
// the accumulators, then on mma.sync dV += P^T dO and dK += dS^T Q with
// P^T and dS^T the A operands straight from the accumulators (tf32.cuh
// acc_a; dO and Q read as B in the permuted depth order); the dQ role
// likewise S = Q K^T, dP = dO V^T, dQ += dS K.  Split blocks meet in
// `finish`.  Gradients go from the accumulators to global memory.
template <int D, bool SPLIT, bool WG>
__global__ void __launch_bounds__(THREADS)
flash_bwd_f32_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Shape sh) {
  using W = Bwd<D>;
  constexpr int T = W::TILE, NT = W::NT;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];   // resident full; stage full
  __shared__ int last_part;
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base_s = smem_u32(base);
  const uint32_t r_bar = smem_u32(bars), f_bar = r_bar + 8;
  // resident tiles at 0 (K or Q) and T (V or dO); stage st's tiles at
  // 2T (1 + st) and T more, its lse2 and delta at VEC + 512 st and + 256
  constexpr int VEC = 2 * T + STAGES * 2 * T;

  const int n_q_blocks = sh.B * sh.Hq * sh.n_qt * sh.dq_split;
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
  int kt_lo = 0, parts = 1, slot = 0;
  if (key_role) {
    part = SPLIT ? idx % sh.split : 0;
    pair = SPLIT ? idx / sh.split : idx;
    parts = SPLIT ? sh.split : 1;
    const int bkv = pair % (sh.B * sh.Hkv);
    b = bkv / sh.Hkv;
    hk = bkv % sh.Hkv;
    k0 = (pair / (sh.B * sh.Hkv)) * ROWS;
    qt0 = sh.causal ? max(0, k0 - seq_off) / ROWS : 0;
    nq = sh.n_qt - qt0;
    h_lo = SPLIT ? part * group / sh.split : 0;
    n_iter = (SPLIT ? (part + 1) * group / sh.split - h_lo : group) * nq;
  } else {
    // the parts of a (query head, query tile) are neighbours
    part = idx % sh.dq_split;
    idx /= sh.dq_split;
    const int bh = idx % (sh.B * sh.Hq);
    const int qt = sh.n_qt - 1 - idx / (sh.B * sh.Hq);   // the longest causal tiles first
    b = bh / sh.Hq;
    h = bh % sh.Hq;
    hk = h / group;
    q0 = qt * ROWS;
    slot = bh * sh.n_qt + qt;
    const int q_rows = min(ROWS, sh.Sq - q0);
    const int k_end = sh.causal ? min(sh.Skv, q0 + q_rows + seq_off) : sh.Skv;
    const int n_t = (k_end + ROWS - 1) / ROWS;
    parts = max(1, min(sh.dq_split, n_t));
    if (part >= parts) return;                // a tile with fewer key tiles than the split
    kt_lo = part * n_t / parts;
    n_iter = (part + 1) * n_t / parts - kt_lo;
  }
  const int bkv = b * sh.Hkv + hk;

  if (threadIdx.x == 0) {
    mbar_init(r_bar, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) mbar_init(f_bar + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the key role streams (Q, dO, lse2, delta) of (head, query tile); the
  // dQ role (K, V) of its KV head
  auto issue = [&](int i) {
    const int st = i % STAGES;
    const uint32_t f = f_bar + 8 * st, t0 = base_s + 2 * T * (1 + st);
    if (key_role) {
      const int head = b * sh.Hq + hk * group + h_lo + i / nq;
      const int row = (qt0 + i % nq) * ROWS;
      mbar_expect_tx(f, 2 * T + 2 * ROWS * 4);
      tf32::load_tile<D, ROWS>(t0, &maps.q, f, row, head);
      tf32::load_tile<D, ROWS>(t0 + T, &maps.dout, f, row, head);
      const size_t v0 = (size_t)head * sh.Sq_pad + row;
      bulk_load(base_s + VEC + 512 * st, sh.lse2 + v0, ROWS * 4, f);
      bulk_load(base_s + VEC + 512 * st + 256, sh.delta + v0, ROWS * 4, f);
    } else {
      mbar_expect_tx(f, 2 * T);
      tf32::load_tile<D, ROWS>(t0, &maps.k, f, (kt_lo + i) * ROWS, bkv);
      tf32::load_tile<D, ROWS>(t0 + T, &maps.v, f, (kt_lo + i) * ROWS, bkv);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(r_bar, 2 * T);
    if (key_role) {
      tf32::load_tile<D, ROWS>(base_s, &maps.k, r_bar, k0, bkv);
      tf32::load_tile<D, ROWS>(base_s + T, &maps.v, r_bar, k0, bkv);
    } else {
      tf32::load_tile<D, ROWS>(base_s, &maps.q, r_bar, q0, b * sh.Hq + h);
      tf32::load_tile<D, ROWS>(base_s + T, &maps.dout, r_bar, q0, b * sh.Hq + h);
    }
    for (int i = 0; i < min(STAGES, n_iter); ++i) issue(i);
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;             // the warp's first row of the resident tiles
  const int grp = warp >> 2;                  // its column group
  const int c0 = grp * (64 / QW);             // its first column of the streamed tile
  const int tq = tid & 127;                   // its thread among the warps of its group
  // the other groups' accumulators meet group 0's through the ring's
  // stages, free after the walk: red0 for dV or dQ, red1 for dK
  float4* red0 = reinterpret_cast<float4*>(base + 2 * T);
  float4* red1 = red0 + (QW - 1) * NT * 128;
  const unsigned char* x_t = base;            // K or Q
  const unsigned char* y_t = base + T;        // V or dO
  // WG: the lo halves of the resident pair at LO, of the stage at LO + 2T
  unsigned char* lo_r = base + W::LO;
  unsigned char* lo_s = lo_r + 2 * T;
  // S (or S^T) and dP (or dP^T) of the warpgroup's 64 rows against its 32
  // columns of the stage at stage_s: the resident tiles as A, the stage's
  // as B (from row c0), each product 3xTF32 with the small terms first
  auto s_dp_wgmma = [&](float (&s)[NS][4], float (&dp)[NS][4], uint32_t stage_s) {
    float (&sf)[4 * NS] = *reinterpret_cast<float (*)[4 * NS]>(&s[0][0]);
    float (&df)[4 * NS] = *reinterpret_cast<float (*)[4 * NS]>(&dp[0][0]);
    const uint32_t xh = base_s, yh = base_s + T, xl = smem_u32(lo_r), yl = xl + T;
    const uint32_t ah = stage_s, bh = stage_s + T, al = smem_u32(lo_s), bl = al + T;
    fence_regs(sf);
    fence_regs(df);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      tf32::wgmma_ss_n32(sf, tf32::desc<D, ROWS>(xl, kk), tf32::desc<D, ROWS>(ah, kk, c0), kk > 0);
      tf32::wgmma_ss_n32(sf, tf32::desc<D, ROWS>(xh, kk), tf32::desc<D, ROWS>(al, kk, c0), 1);
      tf32::wgmma_ss_n32(sf, tf32::desc<D, ROWS>(xh, kk), tf32::desc<D, ROWS>(ah, kk, c0), 1);
      tf32::wgmma_ss_n32(df, tf32::desc<D, ROWS>(yl, kk), tf32::desc<D, ROWS>(bh, kk, c0), kk > 0);
      tf32::wgmma_ss_n32(df, tf32::desc<D, ROWS>(yh, kk), tf32::desc<D, ROWS>(bl, kk, c0), 1);
      tf32::wgmma_ss_n32(df, tf32::desc<D, ROWS>(yh, kk), tf32::desc<D, ROWS>(bh, kk, c0), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sf);
    fence_regs(df);
  };
  // WG: split a landed pair of tiles (hi in place, lo at lo), visible to wgmma
  auto split_pair = [&](unsigned char* tiles, unsigned char* lo) {
    if constexpr (WG) {
      tf32::split_tile(tiles, lo, 2 * T, tid, THREADS);
      tf32::fence_async();
      __syncthreads();
    }
  };
  if (key_role) {
    const int key = k0 + r0 + g;              // this thread's keys: key, key + 8
    const bool live = k0 + r0 < sh.Skv;       // a warp past the last key only keeps step
    float dv[NT][4], dk[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[j][e] = dk[j][e] = 0.f;
    mbar_wait(r_bar, 0);
    split_pair(base, lo_r);
    for (int i = 0; i < n_iter; ++i) {
      const int st = i % STAGES;
      const int qs = (qt0 + i % nq) * ROWS + seq_off;   // the tile's first query position
      unsigned char* q_t = base + 2 * T * (1 + st);
      const unsigned char* do_t = q_t + T;
      const float* lse_s = reinterpret_cast<const float*>(base + VEC + 512 * st);
      const float* delta_s = lse_s + ROWS;
      mbar_wait(f_bar + 8 * st, (i / STAGES) & 1);
      // the tile straddles the diagonal
      const bool mask = sh.causal && k0 + r0 + 15 > qs;
      float s[NS][4], dp[NS][4];
      if constexpr (WG) {                      // S^T = K Q^T and dP^T = V dO^T
        split_pair(q_t, lo_s);
        s_dp_wgmma(s, dp, smem_u32(q_t));
      }
      if (live) {
        if constexpr (!WG) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
          for (int kk = 0; kk < D / 8; ++kk) {   // S^T = K Q^T and dP^T = V dO^T
            const tf32::FragA ak = tf32::load_a<D, ROWS>(x_t, r0, kk * 8, g, t);
            const tf32::FragA av = tf32::load_a<D, ROWS>(y_t, r0, kk * 8, g, t);
#pragma unroll
            for (int j = 0; j < NS; ++j) {
              tf32::mma3(s[j], ak, tf32::load_b_nmajor<D, ROWS>(q_t, c0 + 8 * j, kk * 8, g, t));
              tf32::mma3(dp[j], av, tf32::load_b_nmajor<D, ROWS>(do_t, c0 + 8 * j, kk * 8, g, t));
            }
          }
        }
        // P^T into s, dS^T = P^T (dP^T - delta) into dp
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + 2 * t + (e & 1);
            float p = fast_exp2(fmaf(s[j][e], sh.scale_log2, -lse_s[col]));
            if (mask) p = key + 8 * (e >> 1) <= qs + col ? p : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - delta_s[col]);
          }
#pragma unroll
        for (int j = 0; j < NS; ++j) {         // dV += P^T dO
          const tf32::FragA a = tf32::acc_a(s[j]);
#pragma unroll
          for (int c = 0; c < NT; ++c)
            tf32::mma3(dv[c], a, WG ? tf32::load_b_kmajor_split<D, ROWS>(do_t, lo_s + T, c0 + 8 * j,
                                                                         8 * c, g, t)
                                    : tf32::load_b_kmajor<D, ROWS>(do_t, c0 + 8 * j, 8 * c, g, t));
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {         // dK += dS^T Q
          const tf32::FragA a = tf32::acc_a(dp[j]);
#pragma unroll
          for (int c = 0; c < NT; ++c)
            tf32::mma3(dk[c], a, WG ? tf32::load_b_kmajor_split<D, ROWS>(q_t, lo_s, c0 + 8 * j,
                                                                         8 * c, g, t)
                                    : tf32::load_b_kmajor<D, ROWS>(q_t, c0 + 8 * j, 8 * c, g, t));
        }
      }
      __syncthreads();                        // every warp is done with stage st
      if (tid == 0 && i + STAGES < n_iter) issue(i + STAGES);
    }
    // tickets and partials a (pair, dV or dK): slot 2 pair + (0 or 1)
    float4* parts4 = reinterpret_cast<float4*>(sh.part);
    const size_t slot_f4 = (size_t)sh.split * NT * 128;
    if (finish<NT>(dv, red0, grp, tq, parts4 + (2 * pair) * slot_f4, part, parts,
                              sh.tickets + 2 * pair, &last_part))
      write_rows<D, NT>(sh.dv + (size_t)bkv * sh.Skv * D, dv, key, t, sh.Skv, 1.f);
    if (finish<NT>(dk, red1, grp, tq, parts4 + (2 * pair + 1) * slot_f4, part, parts,
                              sh.tickets + 2 * pair + 1, &last_part))
      write_rows<D, NT>(sh.dk + (size_t)bkv * sh.Skv * D, dk, key, t, sh.Skv, sh.scale);
  } else {
    const int row = q0 + r0 + g;               // this thread's queries: row, row + 8
    const bool live = q0 + r0 < sh.Sq;
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {              // padded rows: +inf and 0 (the pre-pass)
      const size_t v0 = ((size_t)b * sh.Hq + h) * sh.Sq_pad + row + 8 * r;
      l2[r] = sh.lse2[v0];
      dl[r] = sh.delta[v0];
    }
    float dq[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
    mbar_wait(r_bar, 0);
    split_pair(base, lo_r);
    for (int i = 0; i < n_iter; ++i) {
      const int st = i % STAGES, kt0 = (kt_lo + i) * ROWS;
      unsigned char* k_t = base + 2 * T * (1 + st);
      const unsigned char* v_t = k_t + T;
      mbar_wait(f_bar + 8 * st, (i / STAGES) & 1);
      // the ragged Skv tail, or a tile that straddles the diagonal
      const bool mask = kt0 + ROWS > sh.Skv || (sh.causal && kt0 + ROWS - 1 > q0 + r0 + seq_off);
      float s[NS][4], dp[NS][4];
      if constexpr (WG) {                      // S = Q K^T, dP = dO V^T
        split_pair(k_t, lo_s);
        s_dp_wgmma(s, dp, smem_u32(k_t));
      }
      if (live) {
        if constexpr (!WG) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
          for (int kk = 0; kk < D / 8; ++kk) {   // S = Q K^T, dP = dO V^T
            const tf32::FragA aq = tf32::load_a<D, ROWS>(x_t, r0, kk * 8, g, t);
            const tf32::FragA ad = tf32::load_a<D, ROWS>(y_t, r0, kk * 8, g, t);
#pragma unroll
            for (int j = 0; j < NS; ++j) {
              tf32::mma3(s[j], aq, tf32::load_b_nmajor<D, ROWS>(k_t, c0 + 8 * j, kk * 8, g, t));
              tf32::mma3(dp[j], ad, tf32::load_b_nmajor<D, ROWS>(v_t, c0 + 8 * j, kk * 8, g, t));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float p = fast_exp2(fmaf(s[j][e], sh.scale_log2, -l2[r]));
            if (mask) {
              const int kp = kt0 + c0 + 8 * j + 2 * t + (e & 1);
              p = kp < sh.Skv && (!sh.causal || kp <= row + 8 * r + seq_off) ? p : 0.f;
            }
            dp[j][e] = p * (dp[j][e] - dl[r]);
          }
#pragma unroll
        for (int j = 0; j < NS; ++j) {         // dQ += dS K
          const tf32::FragA da = tf32::acc_a(dp[j]);
#pragma unroll
          for (int c = 0; c < NT; ++c)
            tf32::mma3(dq[c], da, WG ? tf32::load_b_kmajor_split<D, ROWS>(k_t, lo_s, c0 + 8 * j,
                                                                          8 * c, g, t)
                                     : tf32::load_b_kmajor<D, ROWS>(k_t, c0 + 8 * j, 8 * c, g, t));
        }
      }
      __syncthreads();
      if (tid == 0 && i + STAGES < n_iter) issue(i + STAGES);
    }
    float4* qparts = reinterpret_cast<float4*>(sh.qpart) + (size_t)slot * sh.dq_split * NT * 128;
    if (finish<NT>(dq, red0, grp, tq, qparts, part, parts, sh.tickets + sh.q_ticket0 + slot,
                   &last_part))
      write_rows<D, NT>(sh.dq + ((size_t)b * sh.Hq + h) * sh.Sq * D, dq, row, t, sh.Sq, sh.scale);
  }
}

}  // namespace f32body

template <int D, bool SPLIT, bool WG>
int launch_f32_body(const BwdArgs& a) {
  using W = f32body::Bwd<D>;
  constexpr int smem = WG ? W::SMEM_WG : W::SMEM;
  auto kernel = f32body::flash_bwd_f32_kernel<D, SPLIT, WG>;
  static const cudaError_t attr =   // once per instantiation: it is host work on every launch
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long B = a.B, Hq = a.Hq, Hkv = a.Hkv, Sq = a.Sq, Skv = a.Skv;
  const long long Sq_pad = (Sq + ROWS - 1) / ROWS * ROWS;
  const long long rows_total = B * Hq * Sq_pad;
  const long long group = Hq / Hkv;
  if (a.block != ROWS || a.ws == nullptr || a.head_split < 1 || a.head_split > group ||
      a.dq_split < 1 || ((a.head_split > 1 || a.dq_split > 1) && a.tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  float* lse2 = a.ws;
  float* delta = a.ws + rows_total;

  constexpr int RPB = 256 / (D / 4 <= 4 ? 4 : D / 4 <= 8 ? 8 : D / 4 <= 16 ? 16 : 32);
  f32body::flash_bwd_delta_f32_kernel<D><<<(unsigned)((rows_total + RPB - 1) / RPB), 256, 0,
                                           a.stream>>>(
      static_cast<const float*>(a.o), static_cast<const float*>(a.dout), a.lse, lse2, delta,
      (int)Sq, (int)Sq_pad, rows_total);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  f32body::Maps maps;
  int rc = tf32::f32_map<D>(&maps.q, a.q, Sq, B * Hq, ROWS);
  if (!rc) rc = tf32::f32_map<D>(&maps.k, a.k, Skv, B * Hkv, ROWS);
  if (!rc) rc = tf32::f32_map<D>(&maps.v, a.v, Skv, B * Hkv, ROWS);
  if (!rc) rc = tf32::f32_map<D>(&maps.dout, a.dout, Sq, B * Hq, ROWS);
  if (rc) return rc;

  f32body::Shape sh;
  sh.lse2 = lse2;
  sh.delta = delta;
  const long long pairs = B * Hkv * ((Skv + ROWS - 1) / ROWS);
  sh.part = a.ws + 2 * rows_total;
  sh.qpart = sh.part + (a.head_split > 1 ? pairs * a.head_split * 128 * D : 0);
  sh.tickets = a.tickets;
  sh.q_ticket0 = (int)(2 * pairs);
  sh.dq_split = (int)a.dq_split;
  sh.dq = static_cast<float*>(a.dq);
  sh.dk = static_cast<float*>(a.dk);
  sh.dv = static_cast<float*>(a.dv);
  sh.B = (int)B;
  sh.Hq = (int)Hq;
  sh.Hkv = (int)Hkv;
  sh.Sq = (int)Sq;
  sh.Skv = (int)Skv;
  sh.Sq_pad = (int)Sq_pad;
  sh.causal = (int)a.causal;
  sh.n_kt = (int)((Skv + ROWS - 1) / ROWS);
  sh.n_qt = (int)(Sq_pad / ROWS);
  sh.split = (int)a.head_split;
  sh.n_kv_blocks = (int)(pairs * a.head_split);
  sh.dq_first = (int)a.dq_first;
  sh.scale = (float)a.scale;
  sh.scale_log2 = (float)a.scale * LOG2E;
  const long long blocks = (long long)sh.n_kv_blocks + B * Hq * sh.n_qt * a.dq_split;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, f32body::THREADS, smem, a.stream>>>(maps, sh);
  return 0;
}

// A head split runs its own instance, as in the bf16 body; so does the
// wgmma body, where its tiles fit.
template <int D>
int launch_f32(const BwdArgs& a) {
  if (a.wgmma) {
    if constexpr (f32body::Bwd<D>::WG_FITS)
      return a.head_split > 1 ? launch_f32_body<D, true, true>(a)
                              : launch_f32_body<D, false, true>(a);
    return (int)cudaErrorInvalidValue;
  }
  return a.head_split > 1 ? launch_f32_body<D, true, false>(a)
                          : launch_f32_body<D, false, false>(a);
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
  if (a.dq_split != 1) return (int)cudaErrorInvalidValue;
  const bool split = a.head_split > 1;
  if (a.block == 128) return split ? launch_wgmma<D, 2, true>(a) : launch_wgmma<D, 2, false>(a);
  if (a.block == 64) return split ? launch_wgmma<D, 1, true>(a) : launch_wgmma<D, 1, false>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout and dq (B, Hq, Sq, D); k, v,
// dk and dv (B, Hkv, Skv, D); lse (B, Hq, Sq) f32 from the forward;
// Hq % Hkv == 0, 0 < Sq, 0 < Skv, and Sq <= Skv when causal.  float32:
// every tensor contiguous and 16-byte aligned, block 64.  bfloat16: o, lse
// and the outputs contiguous; q, k, v and dout of any strides (in
// elements, `strides`) whose rows are contiguous, each stride and base a
// multiple of 16 bytes; block 128 (two consumer warpgroups a block) or 64
// (one).  Both: ws 2 * B * Hq * ceil(Sq / 64) * 64 floats of scratch, and
// with head_split c > 1 another B * Hkv * ceil(Skv / block) * c * block *
// 2 * DP (the partials) and tickets, B * Hkv * ceil(Skv / block) counters
// (twice as many in f32: dV and dK) that are 0 (each launch leaves them
// 0).  float32 with dq_split d > 1 (bf16: 1): another B * Hq * ceil(Sq /
// 64) * d * 64 * D floats of dQ partials after the key partials, and from
// counter 2 * B * Hkv * ceil(Skv / 64) on one a (query head, query tile).
// Two kernel launches (the delta pre-pass and the body).
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
