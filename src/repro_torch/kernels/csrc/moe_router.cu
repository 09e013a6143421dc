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
// the model paths under 2 microseconds), so it is bound by launch
// latency.  Design: one warp per token.  The TPU took k rounds of a
// full-width VPU max plus one-hot masking on a (block_t, E) VMEM tile;
// here lane l holds the probabilities of experts l, l + 32, l + 64, ...
// in registers (V = ceil(E / 32) of them, a template parameter, E up to
// 1024), the row max and the row sum go by __shfl_xor_sync, and each
// round is a warp arg-max on (p, id) pairs: a lane's own best (the
// lowest id on a tie, as its ids rise with the slot), then a butterfly
// that keeps the larger p and, on equal p, the lower id, so every lane
// ends with the same winner and the lane that holds it masks its slot.
// Lane r keeps round r's weight; the renormalizing sum is one more warp
// sum, and lanes 0..k-1 write the k weights and indices.  Any T (the
// Pallas version needed T % block_t == 0); padding slots past E hold -1,
// below every probability, and selected slots -1e30, the TPU's mask.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;  // tokens per block
constexpr unsigned FULL = 0xffffffffu;
constexpr float MASKED = -1e30f;  // a selected expert (the TPU kernel's NEG_INF)
constexpr float PADDING = -1.f;   // a slot past E: below any probability

template <int V>
__global__ void moe_router_kernel(const float* __restrict__ logits, float* __restrict__ w_out,
                                  int* __restrict__ idx_out, int T, int E, int k,
                                  int renormalize) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;  // the whole warp leaves together
  const float* row = logits + (size_t)t * E;

  float p[V];
  float m = -INFINITY;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int e = lane + 32 * v;
    p[v] = e < E ? row[e] : -INFINITY;
    m = fmaxf(m, p[v]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p[v] = lane + 32 * v < E ? expf(p[v] - m) : 0.f;
    s += p[v];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
#pragma unroll
  for (int v = 0; v < V; ++v) p[v] = lane + 32 * v < E ? p[v] / s : PADDING;

  float my_w = 0.f;  // lane r: the weight of round r
  int my_id = 0;
  for (int r = 0; r < k; ++r) {
    float best = p[0];
    int id = lane;
#pragma unroll
    for (int v = 1; v < V; ++v) {
      if (p[v] > best) {  // strict: the lower id (earlier slot) keeps a tie
        best = p[v];
        id = lane + 32 * v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, o);
      const int oi = __shfl_xor_sync(FULL, id, o);
      if (ob > best || (ob == best && oi < id)) {
        best = ob;
        id = oi;
      }
    }
    if ((id & 31) == lane) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (lane + 32 * v == id) p[v] = MASKED;
    }
    if (lane == r) {
      my_w = best;
      my_id = id;
    }
  }
  if (renormalize) {
    float total = lane < k ? my_w : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
    my_w = my_w / total;
  }
  if (lane < k) {
    w_out[(size_t)t * k + lane] = my_w;
    idx_out[(size_t)t * k + lane] = my_id;
  }
}

template <int V>
void launch(const float* logits, float* w, int* idx, int T, int E, int k, int renormalize,
            cudaStream_t stream) {
  const int blocks = (T + WARPS - 1) / WARPS;
  moe_router_kernel<V><<<blocks, WARPS * 32, 0, stream>>>(logits, w, idx, T, E, k, renormalize);
}

}  // namespace

// logits (T, E) float32, contiguous; w (T, k) float32 and idx (T, k) int32
// out.  1 <= k <= min(E, 32), E <= 1024.
extern "C" int moe_router_launch(const float* logits, float* w, int* idx, int T, int E, int k,
                                 int renormalize, cudaStream_t stream) {
  if (k < 1 || k > 32 || k > E || E > 1024) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    const int v = (E + 31) / 32;
    if (v <= 1) launch<1>(logits, w, idx, T, E, k, renormalize, stream);
    else if (v <= 2) launch<2>(logits, w, idx, T, E, k, renormalize, stream);
    else if (v <= 4) launch<4>(logits, w, idx, T, E, k, renormalize, stream);
    else if (v <= 8) launch<8>(logits, w, idx, T, E, k, renormalize, stream);
    else if (v <= 12) launch<12>(logits, w, idx, T, E, k, renormalize, stream);
    else if (v <= 16) launch<16>(logits, w, idx, T, E, k, renormalize, stream);
    else if (v <= 24) launch<24>(logits, w, idx, T, E, k, renormalize, stream);
    else launch<32>(logits, w, idx, T, E, k, renormalize, stream);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* moe_router_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
