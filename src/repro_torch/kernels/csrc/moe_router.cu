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
// without it p = softmax(logits) is recomputed (max and sum in the
// forward's order, so p is the forward's to the bit) and dz_j =
// p_j ([j in K] g_j - S), S = sum_K p_i g_i, for every j.  Bound: bytes
// (T*k*12 read, T*E*4 written; the logits read too without renormalize).
// Design: one token a warp; lanes r < k hold the row's r-th id, weight and
// gradient, S is a butterfly sum; the warp writes the whole E-wide row
// coalesced (zeros, or -p_j S), then __syncwarp orders the k lanes'
// scattered writes of the chosen entries after it.
#include <cuda_runtime.h>
#include <math.h>

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

struct RouterBwdArgs {  // packed by kernels/moe_router.py (struct "<11q")
  const float* logits;  // read without renormalize only
  const float* w;
  const int* idx;
  const float* dw;
  float* dlogits;
  long long T;
  long long E;
  long long k;
  long long renormalize;
  long long blocks;
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

// One token a warp (t is uniform over the warp, so a warp past T leaves
// whole and every shuffle has all 32 lanes).
__global__ void __launch_bounds__(WARPS * 32)
moe_router_bwd_kernel(const float* __restrict__ logits, const float* __restrict__ w,
                      const int* __restrict__ idx, const float* __restrict__ dw,
                      float* __restrict__ dz, int T, int E, int k, int renormalize) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const float* x = renormalize ? nullptr : logits + (size_t)t * E;
  float* out = dz + (size_t)t * E;
  const bool chosen = lane < k;
  const int id = chosen ? idx[(size_t)t * k + lane] : 0;
  const float g = chosen ? dw[(size_t)t * k + lane] : 0.f;
  float m = 0.f, s = 1.f, wk;
  if (renormalize) {
    wk = chosen ? w[(size_t)t * k + lane] : 0.f;
  } else {
    m = -INFINITY;
    for (int e = lane; e < E; e += 32) m = fmaxf(m, x[e]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    s = 0.f;
    for (int e = lane; e < E; e += 32) s += expf(x[e] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    wk = chosen ? expf(x[id] - m) / s : 0.f;
  }
  float S = wk * g;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) S += __shfl_xor_sync(FULL, S, o);
  if (renormalize) {
    for (int e = lane; e < E; e += 32) out[e] = 0.f;
  } else {
    for (int e = lane; e < E; e += 32) out[e] = -(expf(x[e] - m) / s) * S;
  }
  __syncwarp();
  if (chosen) out[id] = wk * (g - S);
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
// contiguous; logits (T, E) float32 without renormalize (else unread).
// 1 <= k <= min(E, 32), blocks = ceil(T / WARPS).
extern "C" int moe_router_bwd_launch(const RouterBwdArgs* a) {
  if (a->k < 1 || a->k > 32 || a->k > a->E || (!a->renormalize && a->logits == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a->T > 0)
    moe_router_bwd_kernel<<<(int)a->blocks, WARPS * 32, 0, a->stream>>>(
        a->logits, a->w, a->idx, a->dw, a->dlogits, (int)a->T, (int)a->E, (int)a->k,
        (int)a->renormalize);
  return (int)cudaGetLastError();
}

extern "C" const char* moe_router_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
