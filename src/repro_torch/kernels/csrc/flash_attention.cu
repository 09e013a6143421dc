// Blocked online-softmax GQA attention (FlashAttention forward): the
// full-sequence attention of every forward, prefill and loss evaluation.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel).  For sequence b and query head h
// (KV head h / G, G = Hq / Hkv, any integer): scores q.k * scale in f32
// (the scale multiplies the f32 scores, as the TPU kernel does), online
// softmax with a running (m, l, acc) in f32, out = acc / l with the
// l == 0 -> 1 guard, cast to the input type.  The queries are the last Sq
// positions of the Skv context (seq_off = Skv - Sq); causal masking keeps
// key j for query i when j <= i + seq_off, with the finite -1e30 mask of
// the reference, and key tiles past a query tile's last visible key are
// never visited (the TPU kernel's skipped upper-triangle blocks).  Sq and
// Skv may be any length: the ragged tails of both are masked here, where
// the TPU kernel asserted block multiples.
//
// The TPU carried (m, l, acc) in VMEM scratch across a sequential grid
// over key blocks.  Here one block owns one (sequence, query head, query
// tile) and walks the key tiles in a loop, so the running state stays in
// registers.  GQA is index math only: the block reads its KV head's rows,
// never a repeated copy.  The longest causal query tiles start first.
// Two bodies:
//
//  * float32 (flash_fwd_f32_kernel): the wikikv-router's own attention
//    (the ModelOracle's NLLs, the router's prefill and training forward)
//    and every f32 parity run.  Bound on this card: operations, and only
//    the tensor cores give them at float32 accuracy fast enough: both
//    products in 3xTF32 (tf32.cuh: every operand split into a TF32 hi and
//    lo, three products a product, f32 accumulate; 165e12 effective
//    FLOP/s against 67e12 on the CUDA cores), within the plain version's
//    float tolerance.  S = Q K^T on wgmma.m64nNk8 (Q's hi and lo A
//    fragments in registers for the walk, each K tile split once into a
//    hi tile in place and a lo tile over Q's); O += P V on
//    mma.sync.m16n8k8, P straight from S's accumulators (wgmma reads a
//    tf32 B K-major only, and V is stored the other way).  wgmma took
//    every f32 row the smoke times 11-24% under S on mma.sync, the
//    router's NLLs of 7 and 37 queries too (an H100 at 700 W,
//    scripts/time_backward.py).  128 threads, 64 queries a block
//    (16 a warp), key tiles of 64 (32 at D = 112 and 128: two blocks an
//    SM at every D).  Copies by TMA: f32 tensor maps over (D, S, B*H) in
//    the 128-byte swizzle (32 floats an atom; D = 112 padded to 128
//    columns that TMA zero-fills, a ragged tail's rows zero-filled, never
//    the next head's), Q once and (K, V) through a ring of two stages
//    that thread 0 refills.  Where the grid, B * Hq * ceil(Sq / 64)
//    blocks, leaves SMs idle (kimi-k2's 8 heads over 300 ragged queries:
//    40 blocks), the visible key tiles of each query tile are cut into c
//    parts (the wrapper's key_split: the least c whose longest part is no
//    more than one SM's share of the tiles, and no part under 2 tiles),
//    whose (acc, m, l) the last part to draw a ticket merges in part
//    order.  A warp whose rows all lie past Sq (the router's NLLs of 7-37
//    queries) skips the softmax and P V.
//  * bfloat16 (flash_fwd_wgmma_kernel): Hopper's warp-specialised shape.
//    Bound on this card: operations (4 * D flops per visible (query, key)
//    pair against 2 * D * 2 bytes per key row; at qwen3 prefill, S = 4096,
//    16/8 heads, D = 128, the work is 68.7 GFLOP, 0.0695 ms at the bf16
//    tensor-core peak, the bytes 0.015 ms).  Only wgmma reaches that
//    rate, and only when its operands arrive without the threads' help:
//     - copies by TMA: 3-D tensor maps over (D, S, B*H) for Q, K, V and
//       the output, so a ragged tail is zero-filled (never the next
//       head's rows) and out-of-range output rows are clipped on the
//       store; rows of D bf16 in the swizzle that fits them (128 B at
//       D = 64, 112 and 128, two 64-column atoms at 112 and 128; 64 B at
//       D = 32; 32 B at D = 16), which is the layout the wgmma descriptors
//       read.  kimi-k2's D = 112 is padded to a tile of 128 columns
//       (hopper.cuh Atoms::DP): the maps keep rows of 112, so TMA
//       zero-fills columns 112-127 of Q, K and V and the store drops them;
//       S takes 7 k-steps, P V runs at n128 (14% more products than 112
//       needs), and the scale stays 1/sqrt(112).
//       One producer thread issues them: Q once, K and V through a ring of
//       tiles of 128 keys (2 at D = 112 and 128, 3 below) with full (K, V apart)
//       and empty mbarriers.  With two consumer warpgroups the producer warpgroup
//       drops to 24 registers (setmaxnreg) and the consumers rise to 240;
//       with three to 24 and 160.
//     - products by wgmma: each consumer warpgroup owns 64 query rows
//       (one, two or three a block: 64, 128 or 192 queries; the host's
//       query_tile picks).  S = Q K^T is m64n128k16 with both
//       operands in shared memory; the online softmax runs on its f32
//       accumulators in registers (row max and sum over the 4 threads of a
//       row; the max over the raw scores, the scale being positive, so
//       one FFMA gives s * scale * log2 e - m, and one ex2.approx.ftz the
//       exponential: exp2f adds three instructions of denormal handling);
//       P is rounded to bf16 in registers, where the accumulator layout of
//       S is the A fragment of O += P V (m64n{D}k16), V read MN-major from
//       the same tiles K came in (no transposed copy).
//     - causal work: only tiles that straddle the diagonal or the ragged
//       Skv tail compute the mask; wholly visible tiles skip the compare.
//     - two schedules.  Each visible pair costs 4 * D flops of products
//       and one exp2; an H100's special-function units give ~1/250 of its
//       bf16 tensor rate, so at D = 128 the exponentials take half the
//       products' time and at D = 64 all of it.  One tile at a time (S,
//       its softmax, O += P V; the warpgroups interleave on their own)
//       runs D = 112 and 128, and every 64-query block (one warpgroup).
//       Two or three warpgroups at D <= 64 (whisper-medium, internvl2-1b;
//       PIPELINED) run FlashAttention-3's schedule: batch i issues tile i's
//       S with tile i-1's O += P V and runs tile i's softmax while that
//       P V is on the tensor cores (the ring's third stage lets the
//       producer load tile i + 1 meanwhile), and the warpgroups take turns
//       to issue (named barriers 4 + wg), so one's exponentials run while
//       another's products do.  Measured on an H100 (700 W) against the
//       one-tile schedule with the same 128-query tile, the schedule alone
//       gave 2-3% at whisper's and internvl2's shapes; the cheaper
//       exponential and the folded scale 5-7% more: the softmax's
//       instructions, not the overlap, bound it.  Three warpgroups (192 queries, one more warp
//       a scheduler to hide the softmax's latency) took whisper's encoder
//       from 0.117 to 0.099 ms and internvl2's prefill from 0.091 to
//       0.088, under SDPA; at whisper's 448 decoder positions 192 pads to
//       576 rows and loses, so query_tile keeps 128 there.  The same
//       schedule at D = 112 and 128 (three stages) read within +-2% of
//       one tile at a time, which they keep.  One warpgroup keeps it too:
//       pipelined, a 64-query block read ~30% slower on grids of several
//       waves (why is not measured).
//    The epilogue writes O through the warpgroup's Q tile (swizzled) and
//    one TMA store.
//
// Both bodies write the rows' log-sum-exp of the scaled scores (natural
// log, f32, (B, Hq, Sq)) when `lse` is not null: the training forward
// keeps it for flash_attention_bwd.cu; the inference paths pass null.
// Both keep the running max in the exp2 domain, so the lse is
// (m + log2 l) * ln 2.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;  // the finite mask value of the reference
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: TMA + 3xTF32, S on wgmma and P V on mma.sync (tf32.cuh)
// ---------------------------------------------------------------------------
namespace f32body {

constexpr int BQ = 64;        // queries a block: four warps of 16 rows
constexpr int THREADS = 128;
constexpr int STAGES = 2;     // the ring of (K, V) tiles

template <int D>
struct Fwd {
  using A = tf32::Atoms<D>;
  static constexpr int BK = D <= 64 ? 64 : 32;   // keys a tile (two blocks an SM at every D)
  static constexpr int NT = D / 8;               // n8 blocks of an output row (padding unread)
  static constexpr int Q_BYTES = BQ * A::DP * 4;
  static constexpr int KV_BYTES = BK * A::DP * 4;
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle's period)
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
  static constexpr int PART_F4 = NT + 1;         // float4s a thread of a split's part: acc, (m, l)
};

// One block: 64 queries of one (sequence, query head) over the key tiles
// [t_lo, t_lo + n) of their visible range, which is part p of `parts` (the
// key split; parts = 1 walks them all).  The block is one warpgroup and
// S one wgmma product of its 64 rows; a warp owns 16 of them: its S
// accumulators (rows g, g + 8; key columns 2t, 2t + 1 of each n8 block)
// hold the scores, the online softmax runs on them in registers (m in the
// exp2 domain: scores times scale * log2 e; the scale may have any sign, so
// the max is taken over the scaled scores), and P is the A operand of
// O += P V on mma.sync straight from them (tf32.cuh acc_a).  Q's hi and
// lo fragments are split once into registers (D a thread); K and V
// arrive by TMA in a ring of two stages that thread 0 refills once every
// warp is past a stage, and each K tile is split once by all 128 threads.
// With parts > 1 each block writes its (acc, m, l) and draws a ticket; the
// block that draws the last merges the parts in part order (never in
// arrival order: the same bits every call) and resets the ticket (a
// captured graph replays).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, float* __restrict__ out,
                     float* __restrict__ lse, float* __restrict__ part,
                     unsigned* __restrict__ tickets, int Hq, int Hkv, int Sq, int Skv, int causal,
                     float scale_log2, int n_qt, int split) {
  using F = Fwd<D>;
  constexpr int BK = F::BK, NT = F::NT, NS = BK / 8;   // NS: n8 blocks of a score tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];   // Q full; (K, V) full per stage
  __shared__ int last_part;
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base_s = smem_u32(base);
  const uint32_t q_bar = smem_u32(bars), kv_bar = q_bar + 8;

  const int bh = blockIdx.x;                 // sequence * Hq + query head
  const int qt = n_qt - 1 - blockIdx.y;      // the longest causal tiles start first
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);  // the query head's KV head
  const int q0 = qt * BQ, q_rows = min(BQ, Sq - q0);
  const int seq_off = Skv - Sq;              // < 0 only when not causal, and then never read
  const int k_end = causal ? min(Skv, q0 + q_rows + seq_off) : Skv;
  const int n_t = (k_end + BK - 1) / BK;
  const int parts = max(1, min(split, n_t));
  const int p = blockIdx.z;
  if (p >= parts) return;                    // a tile with fewer key tiles than the split
  const int t_lo = p * n_t / parts, n = (p + 1) * n_t / parts - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) mbar_init(kv_bar + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int i) {                  // key tile t_lo + i into stage i % STAGES
    const int st = i % STAGES;
    const uint32_t bar = kv_bar + 8 * st, k_s = base_s + F::Q_BYTES + st * 2 * F::KV_BYTES;
    mbar_expect_tx(bar, 2 * F::KV_BYTES);
    tf32::load_tile<D, BK>(k_s, &k_map, bar, (t_lo + i) * BK, bkv);
    tf32::load_tile<D, BK>(k_s + F::KV_BYTES, &v_map, bar, (t_lo + i) * BK, bkv);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, F::Q_BYTES);
    tf32::load_tile<D, BQ>(base_s, &q_map, q_bar, q0, bh);
    for (int i = 0; i < min(STAGES, n); ++i) issue(i);
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;                  // the warp's first row of the tile
  const bool live = q0 + r0 < Sq;            // a warp past the last query only keeps step
  const int pos = q0 + r0 + g + seq_off;     // this thread's rows' positions: pos, pos + 8
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);
  // Q's hi and lo A fragments stay in registers for the walk, and its
  // tile then takes each key tile's lo
  uint32_t qh[D / 8][4], ql[D / 8][4];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const tf32::FragA a = tf32::load_a<D, BQ>(base, r0, kk * 8, g, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qh[kk][e] = a.hi[e];
      ql[kk][e] = a.lo[e];
    }
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES, k0 = (t_lo + i) * BK;
    unsigned char* ks = base + F::Q_BYTES + st * 2 * F::KV_BYTES;
    const unsigned char* vs = ks + F::KV_BYTES;
    mbar_wait(kv_bar + 8 * st, (i / STAGES) & 1);
    // S = Q K^T on wgmma, the warpgroup's 64 rows (the padded columns
    // unread): K split once into hi (in place) and lo (over Q's tile)
    float s[NS][4];
    tf32::split_tile(ks, base, F::KV_BYTES, tid, THREADS);
    tf32::fence_async();
    __syncthreads();
    float (&sf)[BK / 2] = *reinterpret_cast<float (*)[BK / 2]>(&s[0][0]);
    const uint32_t k_hi = smem_u32(ks), k_lo = base_s;
    fence_regs(sf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {     // the small terms first, as mma3
      tf32::wgmma_rs<BK>(sf, ql[kk], tf32::desc<D, BK>(k_hi, kk), kk > 0);
      tf32::wgmma_rs<BK>(sf, qh[kk], tf32::desc<D, BK>(k_lo, kk), 1);
      tf32::wgmma_rs<BK>(sf, qh[kk], tf32::desc<D, BK>(k_hi, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sf);
    if (live) {
      // the ragged Skv tail, or a tile that straddles the diagonal
      const bool mask = k0 + BK > Skv || (causal && k0 + BK - 1 > q0 + r0 + seq_off);
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (mask) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            x = key < Skv && (!causal || key <= pos + 8 * (e >> 1)) ? x : NEG;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pr = fast_exp2(s[j][e] - m[r]);
          if (mask) pr = s[j][e] == NEG ? 0.f : pr;
          l[r] += pr;   // this thread's share of the row sum
          s[j][e] = pr;
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {         // O += P V, keys in acc_a's order
        const tf32::FragA pa = tf32::acc_a(s[j]);
#pragma unroll
        for (int c = 0; c < NT; ++c)
          tf32::mma3(o[c], pa, tf32::load_b_kmajor<D, BK>(vs, j * 8, c * 8, g, t));
      }
    }
    __syncthreads();                         // every warp is done with stage st
    if (tid == 0 && i + STAGES < n) issue(i + STAGES);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }

  if (parts > 1) {
    // this part's (acc, m, l), then a ticket; the last to draw merges
    const int slot = bh * n_qt + qt;
    float4* all = reinterpret_cast<float4*>(part) + (size_t)slot * split * F::PART_F4 * THREADS;
    float4* mine = all + (size_t)p * F::PART_F4 * THREADS;
#pragma unroll
    for (int j = 0; j < NT; ++j) mine[j * THREADS + tid] = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
    mine[NT * THREADS + tid] = make_float4(m[0], m[1], l[0], l[1]);
    __threadfence();                         // visible device-wide before the ticket is drawn
    __syncthreads();
    if (tid == 0) {
      const bool last = atomicAdd(tickets + slot, 1u) == (unsigned)(parts - 1);
      if (last) tickets[slot] = 0u;          // every part has drawn: reset for the next call
      last_part = last;
    }
    __syncthreads();
    if (!last_part) return;
    __threadfence();
    // the parts in part order, read past L1: other blocks wrote them
    float M[2] = {NEG, NEG};
    for (int q = 0; q < parts; ++q) {
      const float4 x = __ldcg(all + ((size_t)q * F::PART_F4 + NT) * THREADS + tid);
      M[0] = fmaxf(M[0], x.x);
      M[1] = fmaxf(M[1], x.y);
    }
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int q = 0; q < parts; ++q) {
      const float4* pq = all + (size_t)q * F::PART_F4 * THREADS + tid;
      const float4 x = __ldcg(pq + NT * THREADS);
      const float w0 = fast_exp2(x.x - M[0]), w1 = fast_exp2(x.y - M[1]);
      l[0] = fmaf(x.z, w0, l[0]);
      l[1] = fmaf(x.w, w1, l[1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 y = __ldcg(pq + j * THREADS);
        o[j][0] = fmaf(y.x, w0, o[j][0]);
        o[j][1] = fmaf(y.y, w0, o[j][1]);
        o[j][2] = fmaf(y.z, w1, o[j][2]);
        o[j][3] = fmaf(y.w, w1, o[j][3]);
      }
    }
    m[0] = M[0];
    m[1] = M[1];
  }

  // out = acc / l (l == 0 -> 1) and the natural log-sum-exp, rows < Sq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    float* orow = out + ((size_t)bh * Sq + row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * Sq + row] = l[r] == 0.f ? __int_as_float(0x7f800000)
                                               : (m[r] + log2f(l[r])) * 0.6931471805599453f;
  }
}

}  // namespace f32body

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma, one producer warp and one or two consumer
// warpgroups
// ---------------------------------------------------------------------------
constexpr int WG_ROWS = 64;   // query rows of one consumer warpgroup
constexpr int HBK = 128;      // keys per tile

// The shared-memory layout of a tile of rows of D bf16: ATOMS column
// atoms of ATOM_E elements (ATOM_B bytes a row), each atom rows x ATOM_B
// bytes, swizzled by TMA in the mode of its row length.
// The tile layout of hopper.cuh's Atoms, and the ring's geometry.
template <int D>
struct Geo : hopper::Atoms<D> {
  static constexpr int DP = hopper::Atoms<D>::DP;   // 128 at D = 112: padded columns
  static constexpr int STAGES = DP == 128 ? 2 : 3;
  static constexpr int KV_TILE_BYTES = HBK * DP * 2;
  static constexpr int Q_WG_BYTES = WG_ROWS * DP * 2;
};

// The pipelined schedule with turns, at head_dim 64 and below (where the
// exponentials take as long as the products) and two or three consumer
// warpgroups; D = 112 and 128, and one warpgroup, run one tile at a time
// (the header says what was measured).
template <int D, int NWG>
constexpr bool PIPELINED = D <= 64 && NWG > 1;

template <int D, int NWG>
constexpr int wgmma_smem_bytes() {
  // + 1024: the tiles start on a 1024-byte boundary (the 128-byte swizzle's period)
  return NWG * Geo<D>::Q_WG_BYTES + 2 * Geo<D>::STAGES * Geo<D>::KV_TILE_BYTES + 1024;
}

// One key tile of the online softmax on a warpgroup's S accumulators.
// Element i of s (and of o) is row g + 8 * ((i >> 1) & 1) of the warp's
// 16, column 8 * (i >> 2) + 2 * t + (i & 1).  On return s holds p, (m, l)
// are the rows' new max and this thread's share of their sums (m in the
// exp2 domain: the scaled scores times log2 e), and alpha the factor that
// takes the output accumulated so far to the new max.  The scale is
// positive (the C entry refuses others), so the row max is taken over the
// raw scores, and one FFMA a score gives s * scale - m before its exp2.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[HBK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int t, int pos0,
                                             int kv_len, int causal, float scale_log2) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < HBK / 2; ++i) {
    const int r = (i >> 1) & 1;
    float v = s[i];
    if (MASK) {
      const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const bool ok = key < kv_len && (!causal || key <= pos0 + 8 * r);
      v = ok ? v : NEG;
    }
    s[i] = v;
    mx[r] = fmaxf(mx[r], v);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < HBK / 2; ++i) {
    const int r = (i >> 1) & 1;
    float p = fast_exp2(fmaf(s[i], scale_log2, -m[r]));
    if (MASK) p = s[i] == NEG ? 0.f : p;
    l[r] += p;  // this thread's share of the row sum
    s[i] = p;
  }
}

// softmax_tile with the mask where the tile needs it (the ragged Skv tail,
// or a tile that straddles the diagonal): wholly visible tiles skip the
// compare.
__device__ __forceinline__ void tile_softmax(float (&s)[HBK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int t, int pos0,
                                             int row_wg, int seq_off, int kv_len, int causal,
                                             float scale_log2) {
  if (k0 + HBK > kv_len || (causal && k0 + HBK - 1 > row_wg + seq_off))
    softmax_tile<true>(s, m, l, alpha, k0, t, pos0, kv_len, causal, scale_log2);
  else
    softmax_tile<false>(s, m, l, alpha, k0, t, pos0, kv_len, causal, scale_log2);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// S = Q K^T of one key tile, issued (not awaited): m64n128k16 with both
// operands in shared memory, 7 k-steps at D = 112 (padded columns unread).
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[HBK / 2], uint32_t q_wg, uint32_t k_t) {
  using G = Geo<D>;
  constexpr uint32_t SBO = 8 * G::ATOM_B;   // 8 rows of one atom
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int a = kk * 16 / G::ATOM_E, c = (kk * 16 % G::ATOM_E) * 2;
    wgmma_ss_n128(s, make_desc(q_wg + a * WG_ROWS * G::ATOM_B + c, 16, SBO, G::LAYOUT),
                  make_desc(k_t + a * HBK * G::ATOM_B + c, 16, SBO, G::LAYOUT), kk > 0);
  }
}

// O += P V of one key tile, issued: P the bf16 A fragments of the tile's
// S accumulators (key columns 16j .. 16j + 15 are k-step j), V read
// MN-major from the tile K came in (LBO steps the D atoms, SBO 8 keys).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Geo<D>::DP / 2],
                                         const uint32_t (&pa)[HBK / 16][4], uint32_t v_t) {
  using G = Geo<D>;
#pragma unroll
  for (int j = 0; j < HBK / 16; ++j)
    wgmma_rs<G::DP>(o, pa[j], make_desc(v_t + j * 16 * G::ATOM_B, HBK * G::ATOM_B,
                                        8 * G::ATOM_B, G::LAYOUT));
}

constexpr int PP_BAR = 4;   // turns: named barriers 4 + wg (1 + wg: the epilogue's)

template <int D, int NWG, bool PIPE>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse, int Hq,
                       int Hkv, int Sq, int Skv, int causal, float scale_log2, int n_qt) {
  using G = Geo<D>;
  constexpr int ST = G::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * ST];  // Q full; K full, V full, empty per stage
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + NWG * G::Q_WG_BYTES;
  const uint32_t v_s = k_s + ST * G::KV_TILE_BYTES;
  const uint32_t q_bar = smem_u32(bars);
  const uint32_t k_bar = q_bar + 8, v_bar = k_bar + 8 * ST, e_bar = v_bar + 8 * ST;

  const int bh = blockIdx.x;                 // sequence * Hq + query head
  const int qt = n_qt - 1 - blockIdx.y;      // the longest causal tiles start first
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);  // the query head's KV head
  const int q0 = qt * NWG * WG_ROWS;
  const int seq_off = Skv - Sq;
  const int q_rows = min(NWG * WG_ROWS, Sq - q0);
  const int k_end = causal ? min(Skv, q0 + q_rows + seq_off) : Skv;
  const int n_kt = (k_end + HBK - 1) / HBK;
  const int wg = threadIdx.x >> 7;           // warpgroups 0..NWG-1 consume, NWG produces

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(k_bar + 8 * st, 1);
      mbar_init(v_bar + 8 * st, 1);
      mbar_init(e_bar + 8 * st, 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread issues every copy --------------------------
    if constexpr (NWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_bar, NWG * G::Q_WG_BYTES);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int a = 0; a < G::ATOMS; ++a)
          tma_load_3d(q_s + w * G::Q_WG_BYTES + a * WG_ROWS * G::ATOM_B, &q_map, q_bar,
                      a * G::ATOM_E, q0 + w * WG_ROWS, bh);
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % ST;
        mbar_wait(e_bar + 8 * st, ((i / ST) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(k_bar + 8 * st, G::KV_TILE_BYTES);
#pragma unroll
        for (int a = 0; a < G::ATOMS; ++a)
          tma_load_3d(k_s + st * G::KV_TILE_BYTES + a * HBK * G::ATOM_B, &k_map, k_bar + 8 * st,
                      a * G::ATOM_E, i * HBK, bkv);
        mbar_expect_tx(v_bar + 8 * st, G::KV_TILE_BYTES);
#pragma unroll
        for (int a = 0; a < G::ATOMS; ++a)
          tma_load_3d(v_s + st * G::KV_TILE_BYTES + a * HBK * G::ATOM_B, &v_map, v_bar + 8 * st,
                      a * G::ATOM_E, i * HBK, bkv);
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----------------------------
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    if constexpr (NWG == 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row_wg = q0 + wg * WG_ROWS;            // the warpgroup's first query row
    const int pos0 = row_wg + warp * 16 + g + seq_off;  // this thread's rows: pos0, pos0 + 8
    const uint32_t q_wg = q_s + wg * G::Q_WG_BYTES;
    float o[G::DP / 2];   // at D = 112 the last 16 columns stay 0 (V's padding)
#pragma unroll
    for (int i = 0; i < G::DP / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float s[HBK / 2], alpha[2];
    uint32_t pa[HBK / 16][4];
    mbar_wait(q_bar, 0);

    if constexpr (PIPE) {
      // FlashAttention-3's schedule.  Batch i issues tile i's S with tile
      // i-1's O += P V, then runs tile i's softmax while that P V is on
      // the tensor cores.  The two or three warpgroups each issue their
      // batch only in their turn (a named barrier a warpgroup: warpgroup 0
      // first, then 1, 2, 0, ...), so one's softmax and exponentials run
      // while another's products do.  Tile i-1's stage is released after
      // its P V: with three stages the producer is then loading tile i + 1.
      // The first and last batches are peeled, so that every wgmma of the
      // loop is issued on one path and the compiler keeps them in flight.
      const int turn = PP_BAR + wg, other = PP_BAR + (wg + 1) % NWG;
      if (n_kt > 0) {
        if (wg == NWG - 1) bar_arrive(PP_BAR, 256);   // warpgroup 0 goes first
        mbar_wait(k_bar, 0);
        bar_sync(turn, 256);
        fence_regs(s);
        wgmma_fence();
        issue_s<D>(s, q_wg, k_s);
        wgmma_commit();
        bar_arrive(other, 256);
        wgmma_wait_all();
        fence_regs(s);
        tile_softmax(s, m, l, alpha, 0, t, pos0, row_wg, seq_off, Skv, causal, scale_log2);
        acc_to_a<HBK>(s, pa);   // O is still 0: nothing to rescale
        for (int i = 1; i < n_kt; ++i) {
          const int st = i % ST, pst = (i - 1) % ST;
          mbar_wait(k_bar + 8 * st, (i / ST) & 1);
          mbar_wait(v_bar + 8 * pst, ((i - 1) / ST) & 1);
          bar_sync(turn, 256);
          fence_regs(s);
          fence_regs(o);
          wgmma_fence();
          issue_s<D>(s, q_wg, k_s + st * G::KV_TILE_BYTES);
          wgmma_commit();
          issue_pv<D>(o, pa, v_s + pst * G::KV_TILE_BYTES);
          wgmma_commit();
          bar_arrive(other, 256);
          wgmma_wait_one();   // S is done; P V may still run
          fence_regs(s);
          tile_softmax(s, m, l, alpha, i * HBK, t, pos0, row_wg, seq_off, Skv, causal,
                       scale_log2);
          wgmma_wait_all();
          fence_regs(o);
          fence_regs(pa);
          if (lane == 0) mbar_arrive(e_bar + 8 * pst);   // done with tile i-1's stage
          rescale(o, alpha);
          acc_to_a<HBK>(s, pa);
        }
        const int pst = (n_kt - 1) % ST;
        mbar_wait(v_bar + 8 * pst, ((n_kt - 1) / ST) & 1);
        bar_sync(turn, 256);
        fence_regs(o);
        wgmma_fence();
        issue_pv<D>(o, pa, v_s + pst * G::KV_TILE_BYTES);
        wgmma_commit();
        if (wg != NWG - 1) bar_arrive(other, 256);   // the last has no turn to give
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(e_bar + 8 * pst);
      }
    } else {
      // one tile at a time: S, its softmax, then O += P V
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % ST;
        const uint32_t ph = (i / ST) & 1;
        mbar_wait(k_bar + 8 * st, ph);
        fence_regs(s);
        wgmma_fence();
        issue_s<D>(s, q_wg, k_s + st * G::KV_TILE_BYTES);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        tile_softmax(s, m, l, alpha, i * HBK, t, pos0, row_wg, seq_off, Skv, causal, scale_log2);
        rescale(o, alpha);
        acc_to_a<HBK>(s, pa);
        mbar_wait(v_bar + 8 * st, ph);
        fence_regs(o);
        wgmma_fence();
        issue_pv<D>(o, pa, v_s + st * G::KV_TILE_BYTES);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(e_bar + 8 * st);  // this warp is done with the stage
      }
    }

    // ---- epilogue: O / l through the warpgroup's Q tile, one TMA store ----
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
      inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      const int row = row_wg + warp * 16 + g + 8 * r;
      if (lse != nullptr && t == 0 && row < Sq)
        lse[(size_t)bh * Sq + row] = l[r] == 0.f ? __int_as_float(0x7f800000)
                                                 : (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
    bar_sync(1 + wg, 128);  // Q reads are over
#pragma unroll
    for (int j = 0; j < G::DP / 8; ++j) {   // padded columns land in the tile, never stored
      const int col = 8 * j + 2 * t;
      const int a = col / G::ATOM_E;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = (warp * 16 + g + 8 * r) * G::ATOM_B + (col % G::ATOM_E) * 2;
        const uint32_t sw = off ^ (((off >> 7) & G::SW_MASK) << 4);
        const uint32_t val = pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(q_wg + a * WG_ROWS * G::ATOM_B + sw),
                     "r"(val)
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + wg, 128);
    if (tid == 0 && row_wg < Sq) {
#pragma unroll
      for (int a = 0; a < G::ATOMS; ++a)
        tma_store_3d(&o_map, q_wg + a * WG_ROWS * G::ATOM_B, a * G::ATOM_E, row_wg, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// A 3-D map over (D, rows, heads) of a contiguous (heads, rows, D) bf16
// tensor; boxes of (one atom of D, box_rows, 1).
template <int D>
int tensor_map(CUtensorMap* map, const void* ptr, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)Geo<D>::ATOM_E, (cuuint32_t)box_rows, 1};
  return hopper::bf16_map<D>(map, ptr, 3, dims, strides, box);
}

template <int D, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Hq,
                 int Hkv, int Sq, int Skv, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = wgmma_smem_bytes<D, NWG>();
  auto kernel = flash_fwd_wgmma_kernel<D, NWG, PIPELINED<D, NWG>>;
  static const cudaError_t attr =  // once per instantiation: it is host work on every launch
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap qm, km, vm, om;
  int rc = tensor_map<D>(&qm, q, Sq, B * Hq, WG_ROWS);
  if (!rc) rc = tensor_map<D>(&km, k, Skv, B * Hkv, HBK);
  if (!rc) rc = tensor_map<D>(&vm, v, Skv, B * Hkv, HBK);
  if (!rc) rc = tensor_map<D>(&om, out, Sq, B * Hq, WG_ROWS);
  if (rc) return rc;
  const int n_qt = (Sq + NWG * WG_ROWS - 1) / (NWG * WG_ROWS);
  const dim3 grid(B * Hq, n_qt);
  kernel<<<grid, (NWG + 1) * 128, smem, stream>>>(qm, km, vm, om, lse, Hq, Hkv, Sq, Skv, causal,
                                                   scale * LOG2E, n_qt);
  return 0;
}

template <int D>
int launch_bf16(int block_q, const void* q, const void* k, const void* v, void* out, float* lse,
                int B, int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
                cudaStream_t stream) {
  if constexpr (PIPELINED<D, 3>)   // three consumer warpgroups: D <= 64, pipelined
    if (block_q == 192)
      return launch_wgmma<D, 3>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
  if (block_q == 128)
    return launch_wgmma<D, 2>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
  if (block_q == 64)
    return launch_wgmma<D, 1>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Hq,
               int Hkv, int Sq, int Skv, int causal, float scale, int split, float* part,
               unsigned* tickets, cudaStream_t stream) {
  using F = f32body::Fwd<D>;
  auto kernel = f32body::flash_fwd_f32_kernel<D>;
  static const cudaError_t attr =  // once per instantiation: it is host work on every launch
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (split < 1 || split > 65535 || (split > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int rc = tf32::f32_map<D>(&qm, q, Sq, (long long)B * Hq, f32body::BQ);
  if (!rc) rc = tf32::f32_map<D>(&km, k, Skv, (long long)B * Hkv, F::BK);
  if (!rc) rc = tf32::f32_map<D>(&vm, v, Skv, (long long)B * Hkv, F::BK);
  if (rc) return rc;
  const int n_qt = (Sq + f32body::BQ - 1) / f32body::BQ;
  const dim3 grid(B * Hq, n_qt, split);
  kernel<<<grid, f32body::THREADS, F::SMEM, stream>>>(
      qm, km, vm, static_cast<float*>(out), lse, part, tickets, Hq, Hkv, Sq, Skv, causal,
      scale * LOG2E, n_qt, split);
  return 0;
}

int by_dim_f32(int D, const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int Hq, int Hkv, int Sq, int Skv, int causal, float scale, int split, float* part,
               unsigned* tickets, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_f32<16>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, split, part,
                            tickets, stream);
    case 32:
      return launch_f32<32>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, split, part,
                            tickets, stream);
    case 64:
      return launch_f32<64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, split, part,
                            tickets, stream);
    case 112:
      return launch_f32<112>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, split, part,
                             tickets, stream);
    case 128:
      return launch_f32<128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, split, part,
                             tickets, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int by_dim_bf16(int D, int block_q, const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
                cudaStream_t stream) {
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;   // softmax_tile's max needs it
  switch (D) {
    case 16:
      return launch_bf16<16>(block_q, q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 32:
      return launch_bf16<32>(block_q, q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 64:
      return launch_bf16<64>(block_q, q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 112:
      return launch_bf16<112>(block_q, q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale,
                              stream);
    case 128:
      return launch_bf16<128>(block_q, q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale,
                              stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D),
// out like q, all contiguous and 16-byte aligned; lse (B, Hq, Sq) f32 or
// null (not written); Hq % Hkv == 0; 0 < Sq, 0 < Skv, and Sq <= Skv when
// causal (a non-causal call may have more queries than keys: seq_off =
// Skv - Sq then enters no mask); scale > 0 for bfloat16.  block_q: the
// bf16 body's queries a block, 192 (three consumer warpgroups, D <= 64),
// 128 (two) or 64 (one); the f32 body always takes 64.  split: the f32
// body's key split (1 for bfloat16), c > 1 with part, B * Hq * ceil(Sq / 64)
// * c * (D / 8 + 1) * 512 floats of scratch, and tickets, B * Hq *
// ceil(Sq / 64) counters that are 0 (each launch leaves them 0).
// ceil(Sq / 64) <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                      int dtype, int causal, float scale, int block_q, int split,
                                      float* part, unsigned* tickets, cudaStream_t stream) {
  if (B > 0 && Hq > 0 && Sq > 0) {
    const int rc = dtype == 0
        ? by_dim_f32(D, q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, split, part,
                     tickets, stream)
        : dtype == 1 && split == 1
        ? by_dim_bf16(D, block_q, q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, scale, stream)
        : (int)cudaErrorInvalidValue;
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
