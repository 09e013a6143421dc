// Fused MoE router: softmax + top-k gate over each token's expert logits,
// run on every token of every MoE layer (dbrx 16 experts top-4, jamba 16
// top-2, kimi-k2 384 top-8).
//
// Replaces the Pallas kernel repro/kernels/moe_router.py::moe_router
// (body _router_kernel).  Same function: in f32, p = exp(x - max) / sum
// over the E logits of a token; then k rounds that each take the largest
// remaining probability, ties to the lowest expert id (the TPU kernel's
// first match, lax.top_k's order), and mask it; the k weights are divided
// by their sum when renormalize is set.  Selection is on the
// probabilities, not the logits.  expf and a true division (no fast-math
// flags), so the kernel rounds as the plain version does.
//
// Bound on this card: bytes (T*E*4 read, T*k*8 written; at every shape of
// the model paths under 2 microseconds), so a call costs its launch.  The
// TPU took k rounds of a full-width VPU max plus one-hot masking on a
// (block_t, E) VMEM tile.  Design: a token per SUB = 32 / TPW lanes —
// two tokens a warp (TPW = 2, a half-warp each) at E <= 16, which left
// half of every warp idle at one token a warp; one token a warp above.
// Sub-lane s holds the probabilities of experts s, s + SUB, s + 2 SUB, ...
// in registers (V of them, a template parameter, E up to 1024); the row
// max and the row sum go by __shfl_xor_sync over offsets SUB/2 .. 1,
// which never leave the token's lanes; each round is an arg-max on
// (p, id) pairs: a lane's own best (the lowest id on a tie, as its ids
// rise with the slot), then a butterfly that keeps the larger p and, on
// equal p, the lower id, so every lane of the token ends with the same
// winner and the lane that holds it masks its slot.  Sub-lane r keeps
// round r's weight; the renormalizing sum is one more such sum, and
// sub-lanes 0..k-1 write the k weights and indices.  A token past T
// (the second half of the last warp) still runs every shuffle, on zeros,
// and writes nothing.  Any T (the Pallas version needed T % block_t ==
// 0); padding slots past E hold -1, below every probability, and
// selected slots -1e30, the TPU's mask.  The launch geometry (TPW, V,
// blocks) comes from kernels/moe_router.py router_geometry.
//
// The backward (moe_router_bwd_launch) has no Pallas counterpart: the JAX
// package differentiates its jnp reference.  It takes the weights' gradient
// g (T, k) and writes the logits' gradient (T, E): with renormalize the
// weights are the softmax of the chosen logits alone, so dz_j =
// w_j (g_j - S), S = sum_K w_i g_i, on the chosen ids K and 0 elsewhere;
// without it p = softmax(logits) is recomputed and dz_j =
// p_j ([j in K] g_j - S), S = sum_K p_i g_i, for every j.  Bound: bytes
// (T*k*12 read, T*E*4 written; the logits read too without renormalize),
// under the node floor at every training shape but kimi-k2's 384 experts
// (6.3 MB written), so a call costs its launch and its chain of dependent
// steps.  Design: a token takes L lanes, the least power of two with
// 4 L >= E (at most 32), so 32 / L tokens share a warp (8 at dbrx's 16
// experts, 32 at jamba's cut to 2); a lane holds P pieces of 4
// consecutive columns (P = 1 below 32 lanes; ceil(E / 128), a compiled
// count, at 32).  Lane s of a token reads the chosen triples s, s + L, ...
// (one each where k <= L), S is each lane's share summed in turn and then
// a butterfly over the token's lanes (one fixed order: the call is bit for
// bit repeatable), and the row is staged in shared memory, each lane's
// pieces in its own 16-byte slots: the lanes write their pieces there (0,
// or -p S), the chosen triples' lanes drop their values in by address,
// and each lane reads its pieces back and stores each once to the row,
// one 16-byte store a piece, 16 L contiguous bytes a token a warp
// instruction: no zero pass in memory and no second store to a line.  A
// chosen value placed in registers instead (every lane holding all k
// triples, predicated moves into its piece) costs k x 4 P instructions a
// lane: at kimi-k2's shapes (k = 8) no faster than one token a warp with
// scattered stores, and slower at 384 experts.  Rows whose byte length
// is not a multiple of 16 (odd E, E = 2 mod 4) keep the layout and store
// 8 or 4 bytes at a time, the widest their rows allow.  Without renormalize the
// lane reads its pieces of the logits row once (16-byte loads where rows
// allow) together with the triples, each logit's expf runs once, the max
// and the sum go by shuffles within the token's lanes, and the sum adds in
// the forward kernel's order (so p is its p to the bit; a wide row's from
// the stage, lane f adding columns f, f + 32, ... as the forward's
// sub-lane f does).  Every shuffle and __syncwarp takes the whole warp: a
// token past T runs on the last token's inputs and stores nothing.  The
// geometry comes from kernels/moe_router.py router_bwd_geometry, and the C
// entry refuses any other.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

// The C entry's one argument: outside the anonymous namespace, so the
// entry keeps its external linkage.
struct RouterArgs {  // packed by kernels/moe_router.py (struct "<11q")
  const float* logits;
  float* w;
  int* idx;
  long long T;
  long long E;
  long long k;
  long long renormalize;
  long long tpw;
  long long v;
  long long blocks;
  cudaStream_t stream;
};

struct RouterBwdArgs {  // packed by kernels/moe_router.py (struct "<14q")
  const float* logits;  // read without renormalize only
  const float* w;       // read with renormalize only
  const int* idx;
  const float* dw;
  float* dlogits;
  long long T;
  long long E;
  long long k;
  long long renormalize;
  long long lanes;   // router_bwd_geometry: lanes a token,
  long long pieces;  // pieces of 4 columns a lane,
  long long warps;   // warps a block,
  long long blocks;  // and blocks
  cudaStream_t stream;
};

namespace {

constexpr int WARPS = 8;  // warps a block
constexpr unsigned FULL = 0xffffffffu;
constexpr float MASKED = -1e30f;  // a selected expert (the TPU kernel's NEG_INF)
constexpr float PADDING = -1.f;   // a slot past E: below any probability

template <int V, int TPW>
__global__ void __launch_bounds__(WARPS * 32)
moe_router_kernel(const float* __restrict__ logits, float* __restrict__ w_out,
                  int* __restrict__ idx_out, int T, int E, int k, int renormalize) {
  constexpr int SUB = 32 / TPW;  // lanes a token
  const int lane = threadIdx.x & 31;
  const int sl = lane & (SUB - 1);
  const int t = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * TPW + lane / SUB;
  const bool live = t < T;  // a token past T takes part in every shuffle
  const float* row = logits + (size_t)(live ? t : 0) * E;

  float p[V];
  float m = -INFINITY;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int e = sl + SUB * v;
    p[v] = e < E ? (live ? row[e] : 0.f) : -INFINITY;
    m = fmaxf(m, p[v]);
  }
#pragma unroll
  for (int o = SUB / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p[v] = sl + SUB * v < E ? expf(p[v] - m) : 0.f;
    s += p[v];
  }
#pragma unroll
  for (int o = SUB / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
#pragma unroll
  for (int v = 0; v < V; ++v) p[v] = sl + SUB * v < E ? p[v] / s : PADDING;

  float my_w = 0.f;  // sub-lane r: the weight of round r
  int my_id = 0;
  for (int r = 0; r < k; ++r) {
    float best = p[0];
    int id = sl;
#pragma unroll
    for (int v = 1; v < V; ++v) {
      if (p[v] > best) {  // strict: the lower id (earlier slot) keeps a tie
        best = p[v];
        id = sl + SUB * v;
      }
    }
#pragma unroll
    for (int o = SUB / 2; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, o);
      const int oi = __shfl_xor_sync(FULL, id, o);
      if (ob > best || (ob == best && oi < id)) {
        best = ob;
        id = oi;
      }
    }
    if ((id & (SUB - 1)) == sl) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (sl + SUB * v == id) p[v] = MASKED;
    }
    if (sl == r) {
      my_w = best;
      my_id = id;
    }
  }
  if (renormalize) {
    float total = sl < k ? my_w : 0.f;
#pragma unroll
    for (int o = SUB / 2; o > 0; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
    my_w = my_w / total;
  }
  if (live && sl < k) {
    w_out[(size_t)t * k + sl] = my_w;
    idx_out[(size_t)t * k + sl] = my_id;
  }
}

template <int V, int TPW>
void launch(const RouterArgs* a) {
  moe_router_kernel<V, TPW><<<(int)a->blocks, WARPS * 32, 0, a->stream>>>(
      a->logits, a->w, a->idx, (int)a->T, (int)a->E, (int)a->k, (int)a->renormalize);
}

// the most warps a block: 32 narrow (at most ~35 registers a thread), 8
// wide, whose P pieces take up to ~80 registers and 128 P bytes of stage a
// thread (two warps a block is the geometry's, the sweep's best)
__host__ __device__ constexpr int bwd_max_warps(int L) { return L < 32 ? 32 : 8; }

// columns col .. col + 3 of a row of E floats into x, `width` floats a
// load (4, 2 or 1, each load aligned to its size); columns past E read pad
__device__ __forceinline__ void load4(const float* __restrict__ row, int col, int E, int width,
                                      float pad, float (&x)[4]) {
  if (width == 4) {  // E % 4 == 0: the piece is whole or wholly past E
    if (col < E) {
      const float4 a = *reinterpret_cast<const float4*>(row + col);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = pad;
    }
  } else if (width == 2) {
#pragma unroll
    for (int h = 0; h < 4; h += 2) {
      if (col + h < E) {
        const float2 a = *reinterpret_cast<const float2*>(row + col + h);
        x[h] = a.x; x[h + 1] = a.y;
      } else {
        x[h] = x[h + 1] = pad;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = col + c < E ? row[col + c] : pad;
  }
}

// x into columns col .. col + 3 of a row of E floats, as load4 reads them;
// nothing past E is written
__device__ __forceinline__ void store4(float* __restrict__ row, int col, int E, int width,
                                       const float (&x)[4]) {
  if (width == 4) {
    if (col < E) *reinterpret_cast<float4*>(row + col) = make_float4(x[0], x[1], x[2], x[3]);
  } else if (width == 2) {
#pragma unroll
    for (int h = 0; h < 4; h += 2)
      if (col + h < E) *reinterpret_cast<float2*>(row + col + h) = make_float2(x[h], x[h + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < E) row[col + c] = x[c];
  }
}

// A narrow row (E <= 64): L lanes a token (32 / L tokens a warp), one
// piece of 4 consecutive columns a lane (sub-lane s holds columns 4 s ..
// 4 s + 3), so one store instruction of a warp covers 16 L contiguous
// bytes of each of its tokens' rows.  Lane s holds the chosen triples s,
// s + L, ... (J of them at most); S is each lane's share, then a
// butterfly over the token's lanes.  The row is staged in shared memory
// (the token's lanes' pieces are its 4 L consecutive floats), where each
// chosen triple's lane drops its value by address.  Every shuffle stays
// within a token's lanes.
template <int L, int J, bool RENORM>
__global__ void __launch_bounds__(bwd_max_warps(1) * 32)
moe_router_bwd_kernel(const float* __restrict__ logits, const float* __restrict__ w,
                      const int* __restrict__ idx, const float* __restrict__ dw,
                      float* __restrict__ dz, int T, int E, int k, int ewidth) {
  extern __shared__ float4 stage[];  // one piece a thread
  constexpr int TPW = 32 / L;
  const int tid = threadIdx.x, lane = tid & 31, sl = lane & (L - 1);
  const int warp0 = (blockIdx.x * (blockDim.x >> 5) + (tid >> 5)) * TPW;
  if (warp0 >= T) return;  // the whole warp
  // A token past T (in the last warp) runs on the last token's inputs
  // and stores nothing, so that every shuffle and __syncwarp takes the
  // whole warp (a mask of the token's lanes alone would split the warp
  // into 32 / L groups at each of them).
  const int t_run = warp0 + lane / L, t = t_run < T ? t_run : T - 1;
  float* const row = reinterpret_cast<float*>(stage + (tid - sl));  // the token's row
  // every load first, so that the logits and the triples come in one
  // round trip to memory
  float v[4];
  if (!RENORM) load4(logits + (size_t)t * E, 4 * sl, E, ewidth, -INFINITY, v);
  const size_t base = (size_t)t * k;
  int id[J];
  float g[J], wj[J];
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const int j = sl + L * i;
    id[i] = j < k ? idx[base + j] : -1;
    g[i] = j < k ? dw[base + j] : 0.f;
    wj[i] = RENORM && j < k ? w[base + j] : 0.f;
  }
  float S = 0.f, d[J];
  if (RENORM) {
    stage[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
    // S = sum_K w_i g_i: each lane's triples in turn, then a butterfly
#pragma unroll
    for (int i = 0; i < J; ++i) S = fmaf(wj[i], g[i], S);
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) S += __shfl_xor_sync(FULL, S, o);
#pragma unroll
    for (int i = 0; i < J; ++i) d[i] = wj[i] * (g[i] - S);
  } else {
    float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = 4 * sl + c < E ? expf(v[c] - m) : 0.f;
    // The softmax's sum in the forward kernel's order, so that p is its p
    // to the bit: there sub-lane f of SUB (16 at E <= 16, else 32) adds
    // columns f, f + SUB, ... in turn from 0, then a butterfly over
    // offsets SUB/2 .. 1.  Here column f + SUB u is lane f/4 + 8 u's
    // (L = 16) or lane f/4's (L <= 8, one column a sub-lane); offsets of 4
    // columns and more are lane offsets, 2 and 1 columns within the
    // piece.  A partner past the lanes holds columns past E, zeros there.
    float acc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] = v[c];
      if (L == 16) acc[c] += __shfl_xor_sync(FULL, acc[c], 8);
    }
#pragma unroll
    for (int o = (L <= 4 ? 16 : 32) / 8; o > 0; o >>= 1)
      if (o < L) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += __shfl_xor_sync(FULL, acc[c], o);
      }
    const float s = (acc[0] + acc[2]) + (acc[1] + acc[3]);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = v[c] / s;
    stage[tid] = make_float4(v[0], v[1], v[2], v[3]);
    __syncwarp();
    // S = sum_K p_i g_i, p_i read from the stage: as with renormalize
    float pk[J];
#pragma unroll
    for (int i = 0; i < J; ++i) {
      pk[i] = id[i] >= 0 ? row[id[i]] : 0.f;
      S = fmaf(pk[i], g[i], S);
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) S += __shfl_xor_sync(FULL, S, o);
#pragma unroll
    for (int i = 0; i < J; ++i) d[i] = pk[i] * (g[i] - S);
    __syncwarp();  // every read of p is done
    stage[tid] = make_float4(-v[0] * S, -v[1] * S, -v[2] * S, -v[3] * S);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < J; ++i)
    if (id[i] >= 0) row[id[i]] = d[i];
  __syncwarp();
  const float4 x = stage[tid];
  const float y[4] = {x.x, x.y, x.z, x.w};
  if (t_run < T) store4(dz + (size_t)t * E, 4 * sl, E, ewidth, y);
}

// A wide row (E > 64): one token a warp, lane s holding P pieces (columns
// 4 (s + 32 q) .. + 3), staged as `stage` [P][threads].  Lane j < k holds
// the j-th chosen triple, and S is a butterfly over the warp; the rest is
// the narrow row's.
template <int P, bool RENORM>
__global__ void __launch_bounds__(bwd_max_warps(32) * 32)
moe_router_bwd_wide_kernel(const float* __restrict__ logits, const float* __restrict__ w,
                           const int* __restrict__ idx, const float* __restrict__ dw,
                           float* __restrict__ dz, int T, int E, int k, int ewidth) {
  extern __shared__ float4 stage[];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const long long t = (long long)blockIdx.x * (nt >> 5) + (tid >> 5);
  if (t >= T) return;  // the whole warp: one token a warp
  float* const cols = reinterpret_cast<float*>(stage);
  // column e of this warp's row in the stage
  auto at = [&](int e) -> float& {
    return cols[(((e >> 7) * nt + (tid & ~31) + ((e >> 2) & 31)) << 2) + (e & 3)];
  };
  float v[P][4];
  if (!RENORM) {  // the logits first: one round trip with the chosen triple
#pragma unroll
    for (int q = 0; q < P; ++q)
      load4(logits + (size_t)t * E, 4 * (lane + 32 * q), E, ewidth, -INFINITY, v[q]);
  }
  const size_t base = (size_t)t * k;
  const bool chosen = lane < k;
  const int id = chosen ? idx[base + lane] : 0;
  const float g = chosen ? dw[base + lane] : 0.f;
  float d = 0.f;  // lane j < k: column id_j's value
  if (RENORM) {
    const float wj = chosen ? w[base + lane] : 0.f;
    float S = wj * g;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) S += __shfl_xor_sync(FULL, S, o);
    d = wj * (g - S);
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[q][c] = 0.f;
  } else {
    float m = -INFINITY;
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) m = fmaxf(m, v[q][c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
#pragma unroll
    for (int q = 0; q < P; ++q) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[q][c] = 4 * (lane + 32 * q) + c < E ? expf(v[q][c] - m) : 0.f;
      stage[q * nt + tid] = make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
    }
    __syncwarp();
    // The forward kernel's sum: its sub-lane f (one a lane here, 32 of
    // them) adds columns f, f + 32, ... in turn from 0, then a butterfly.
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < 4 * P; ++u) s += at(lane + 32 * u);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    const float pk = chosen ? at(id) / s : 0.f;
    float S = pk * g;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) S += __shfl_xor_sync(FULL, S, o);
    d = pk * (g - S);
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[q][c] = -(v[q][c] / s) * S;
    __syncwarp();  // every read of the stage above is done
  }
#pragma unroll
  for (int q = 0; q < P; ++q) stage[q * nt + tid] = make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
  __syncwarp();
  if (chosen) at(id) = d;
  __syncwarp();
  float* out = dz + (size_t)t * E;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const float4 x = stage[q * nt + tid];
    const float y[4] = {x.x, x.y, x.z, x.w};
    store4(out, 4 * (lane + 32 * q), E, ewidth, y);
  }
}

template <int L, int J, bool R>
void launch_bwd(const RouterBwdArgs* a, int ewidth) {
  const unsigned threads = (unsigned)a->warps * 32;
  moe_router_bwd_kernel<L, J, R><<<(unsigned)a->blocks, threads, threads * sizeof(float4),
                                   a->stream>>>(
      a->logits, a->w, a->idx, a->dw, a->dlogits, (int)a->T, (int)a->E, (int)a->k, ewidth);
}

template <int P, bool R>
void launch_bwd_wide(const RouterBwdArgs* a, int ewidth) {
  const unsigned threads = (unsigned)a->warps * 32;
  moe_router_bwd_wide_kernel<P, R><<<(unsigned)a->blocks, threads,
                                     threads * P * sizeof(float4), a->stream>>>(
      a->logits, a->w, a->idx, a->dw, a->dlogits, (int)a->T, (int)a->E, (int)a->k, ewidth);
}

// J, the triples a lane, is ceil(k / L) rounded up to 1, 2 or 4:
// k <= E <= 4 L (at L = 16, k <= 32 = 2 L)
template <int L, bool R>
void bwd_by_k(const RouterBwdArgs* a, int ewidth) {
  if (a->k <= L) {
    launch_bwd<L, 1, R>(a, ewidth);
  } else if (L == 16 || a->k <= 2 * L) {
    launch_bwd<L, 2, R>(a, ewidth);
  } else if constexpr (L < 16) {
    launch_bwd<L, 4, R>(a, ewidth);
  }
}

template <int L>
void bwd_narrow(const RouterBwdArgs* a, int ewidth) {
  if (a->renormalize) {
    bwd_by_k<L, true>(a, ewidth);
  } else {
    bwd_by_k<L, false>(a, ewidth);
  }
}

template <int P>
void bwd_wide(const RouterBwdArgs* a, int ewidth) {
  if (a->renormalize) {
    launch_bwd_wide<P, true>(a, ewidth);
  } else {
    launch_bwd_wide<P, false>(a, ewidth);
  }
}

// the lanes a token: the least power of two L with 4 L >= E, at most 32
int bwd_lanes(long long E) {
  int L = 1;
  while (L < 32 && 4 * L < E) L *= 2;
  return L;
}

constexpr int BWD_PIECES[] = {1, 2, 3, 4, 6, 8};  // pieces a lane at 32 lanes, compiled

// the widest access, in floats, that every row of n floats at each given
// base allows: 4 (16 bytes), 2 or 1
int row_width(long long n, std::initializer_list<const void*> bases) {
  for (int width : {4, 2}) {
    bool ok = n % width == 0;
    for (const void* p : bases) ok = ok && (uintptr_t)p % (width * sizeof(float)) == 0;
    if (ok) return width;
  }
  return 1;
}

}  // namespace

// logits (T, E) float32, contiguous; w (T, k) float32 and idx (T, k) int32
// out.  1 <= k <= min(E, 32 / tpw), E <= 1024, (tpw, v) from
// router_geometry: (2, 1) for E <= 16, else (1, ceil(E / 32) rounded up to
// an instance).
extern "C" int moe_router_launch(const RouterArgs* a) {
  if (a->tpw < 1 || a->tpw > 2 || a->k < 1 || a->k > 32 / a->tpw || a->k > a->E ||
      a->E > 32 / a->tpw * a->v)
    return (int)cudaErrorInvalidValue;
  if (a->T > 0) {
    if (a->tpw == 2 && a->v == 1) {
      launch<1, 2>(a);
    } else if (a->tpw == 1) {
      switch (a->v) {
        case 1: launch<1, 1>(a); break;
        case 2: launch<2, 1>(a); break;
        case 4: launch<4, 1>(a); break;
        case 8: launch<8, 1>(a); break;
        case 12: launch<12, 1>(a); break;
        case 16: launch<16, 1>(a); break;
        case 24: launch<24, 1>(a); break;
        case 32: launch<32, 1>(a); break;
        default: return (int)cudaErrorInvalidValue;
      }
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// w, dw (T, k) float32, idx (T, k) int32, dlogits (T, E) float32 out, all
// contiguous; logits (T, E) float32 without renormalize (else unread; the
// weights are unread without it).  1 <= k <= min(E, 32), E <= 1024,
// T < 2^30; the geometry (lanes, pieces, warps, blocks) is
// router_bwd_geometry's: lanes the least power of two with 4 lanes >= E
// (at most 32), pieces the least compiled count that holds E over them,
// 1 <= warps <= bwd_max_warps, and blocks exactly enough for T.  Anything
// else is refused.
extern "C" int moe_router_bwd_launch(const RouterBwdArgs* a) {
  const long long L = a->lanes, P = a->pieces;
  bool ok = a->k >= 1 && a->k <= 32 && a->k <= a->E && a->E <= 1024 && a->T >= 0 &&
            a->T < (1LL << 30) &&
            (a->renormalize || a->logits != nullptr) && L == bwd_lanes(a->E) && a->warps >= 1 &&
            a->warps <= bwd_max_warps((int)L);
  if (ok && L < 32) {
    ok = P == 1;
  } else if (ok) {
    long long least = 0;
    for (int p : BWD_PIECES)
      if (least == 0 && 4 * 32 * p >= a->E) least = p;
    ok = P == least;
  }
  if (ok) {  // L and warps are valid here
    const long long tokens_a_block = a->warps * (32 / L);
    ok = a->blocks == (a->T + tokens_a_block - 1) / tokens_a_block;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  if (a->T == 0) return (int)cudaGetLastError();
  const int ewidth = a->renormalize ? row_width(a->E, {a->dlogits})
                                    : row_width(a->E, {a->dlogits, a->logits});
  switch (L) {
    case 1: bwd_narrow<1>(a, ewidth); break;
    case 2: bwd_narrow<2>(a, ewidth); break;
    case 4: bwd_narrow<4>(a, ewidth); break;
    case 8: bwd_narrow<8>(a, ewidth); break;
    case 16: bwd_narrow<16>(a, ewidth); break;
    default:
      switch (P) {
        case 1: bwd_wide<1>(a, ewidth); break;
        case 2: bwd_wide<2>(a, ewidth); break;
        case 3: bwd_wide<3>(a, ewidth); break;
        case 4: bwd_wide<4>(a, ewidth); break;
        case 6: bwd_wide<6>(a, ewidth); break;
        default: bwd_wide<8>(a, ewidth); break;
      }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* moe_router_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
