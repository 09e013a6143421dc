// Single-token GQA decode attention over a padded KV cache: the serving
// LM's attention in every decode step.  One kernel launch per call.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention (body _decode_kernel).  For sequence b and query head
// h (KV head h / G): scores q.k * scale in f32 over positions < lengths[b],
// online softmax in f32, out = sum p v / l with the l == 0 -> 1 guard
// (a length of 0 gives zeros), cast to the input type.  The scale is
// applied to the f32 scores, as the TPU kernel does.
//
// The TPU carried (m, l, acc) in VMEM scratch across a sequential grid
// over KV blocks.  Here one block of W warps takes one (sequence, KV head)
// and the whole query-head group of that KV head (the K/V rows are read
// once for all G heads).  Its warps take the live positions 32 at a time,
// round robin, each with its own (m, l, acc) in registers, and the block
// merges the W partials in shared memory.  The grid's second dimension
// splits a (sequence, KV head) over `nblk` blocks when the plan
// (kernels/decode_attention.py::decode_plan) asks for it: each block
// writes its merged partial to a workspace and takes a ticket; the block
// that draws the last ticket merges the partials, writes the output and
// sets the ticket back to 0.  So no memset and no second kernel.
//
// Bound on this card: bytes (K and V once: 2*B*Hkv*len*D*elt; about one
// flop per byte).  At serving shapes (B = 4, len <= 512) that is well
// under a megabyte, and the cost is the launch and a few dependent loads:
// one launch, q staged once a block, every warp's K and V rows requested
// before it waits on them.  Inside a warp a lane owns one key row for the
// scores (16-byte loads of its row, q from shared memory as broadcasts);
// for P.V, R = D/4 lanes share a V row (4 head dims each: 16 bytes in
// f32, 8 in bf16, which keeps a lane's acc at 4*G floats; at kimi-k2's
// D = 112, 28 lanes, R rounds up to 32 and 4 lanes idle), so one
// warp-wide load covers 32/R rows and a 32-position chunk takes R
// coalesced loads; the lanes that hold the same head dimensions are summed
// by __shfl_xor_sync once, after the warp's last chunk.  Positions at or
// past the length are never read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;  // the finite mask value of the reference
constexpr int SMEM_MAX = 48 * 1024;  // dynamic shared memory without opting in

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using type = float4;
  __device__ static void unpack(const float4& x, float* o) {
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using type = uint4;
  __device__ static void unpack(const uint4& x, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// 4 head dims of a V row: one 16-byte load in f32, one 8-byte load in bf16
template <typename T> struct Piece;
template <> struct Piece<float> {
  using type = float4;
  __device__ static void unpack(const float4& x, float* o) { Vec<float>::unpack(x, o); }
};
template <> struct Piece<__nv_bfloat16> {
  using type = uint2;
  __device__ static void unpack(const uint2& x, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};
constexpr int PN = 4;  // head dims a lane holds in P.V

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Shared memory of one block: q (G*D) and W partials of G*(D+2) floats.
__host__ __device__ constexpr int smem_floats(int W, int G, int D) {
  return G * D + W * G * (D + 2);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(512)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ part,
              unsigned* __restrict__ tickets, int Hkv, int S, float scale) {
  using VT = typename Vec<T>::type;
  using PT = typename Piece<T>::type;
  constexpr int VN = Vec<T>::N;  // elements of a 16-byte K load
  constexpr int RD = D / PN;     // lanes that hold a V row's dims
  // lanes that share a V row: the power of two at or above RD, so rows do
  // not straddle a load (32 at D = 112: lanes 28-31 load nothing)
  constexpr int R = RD <= 4 ? 4 : RD <= 8 ? 8 : RD <= 16 ? 16 : 32;
  static_assert(D % PN == 0 && RD <= 32, "a V row within a warp");
  constexpr int PPI = 32 / R;    // V rows one warp-wide load covers
  const int bh = blockIdx.x;   // sequence * Hkv + KV head
  const int blk = blockIdx.y, nblk = gridDim.y;
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int length = min(lengths[bh / Hkv], S);
  // this block's positions: a whole number of 32-position chunks
  const int span = ((S + 31) / 32 + nblk - 1) / nblk * 32;
  const int lo = blk * span, hi = min(lo + span, length);

  extern __shared__ float smem[];
  float* sq = smem;                // [G][D]
  float* sm = sq + G * D;          // [W][G]
  float* sl = sm + W * G;          // [W][G]
  float* sacc = sl + W * G;        // [W][G][D]
  __shared__ int s_last;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    sq[i] = to_f(q[(size_t)bh * G * D + i]);
  __syncthreads();

  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  float m[G], l[G], acc[G][PN];  // l is this lane's share until the end
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < PN; ++e) acc[g][e] = 0.f;
  }
  const int piece = lane % R, sub = lane / R;

  for (int base = lo + warp * 32; base < hi; base += W * 32) {
    const int s1 = min(base + 32, hi);
    // scores: lane owns position base + lane
    const bool valid = base + lane < s1;
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    if (valid) {
      const VT* kr = reinterpret_cast<const VT*>(kb + (size_t)(base + lane) * D);
#pragma unroll
      for (int c = 0; c < D / VN; ++c) {
        float kv[VN];
        Vec<T>::unpack(__ldg(kr + c), kv);
#pragma unroll
        for (int e = 0; e < VN; ++e)
#pragma unroll
          for (int g = 0; g < G; ++g) sc[g] += sq[g * D + c * VN + e] * kv[e];
      }
    }
    // online softmax: m is the warp's, l and acc are this lane's shares
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s_g = valid ? sc[g] * scale : NEG;
      const float m_new = fmaxf(m[g], warp_max(s_g));
      const float alpha = expf(m[g] - m_new);
      const float p = valid ? expf(s_g - m_new) : 0.f;
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < PN; ++e) acc[g][e] *= alpha;
      m[g] = m_new;
      sc[g] = p;
    }
    // P.V: load i covers rows i*PPI .. i*PPI + PPI - 1 of the chunk
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = i * PPI + sub;
      float vv[PN];
      if (base + j < s1 && piece < RD) {
        Piece<T>::unpack(__ldg(reinterpret_cast<const PT*>(vb + (size_t)(base + j) * D) + piece),
                         vv);
      } else {
#pragma unroll
        for (int e = 0; e < PN; ++e) vv[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(FULL, sc[g], j);
#pragma unroll
        for (int e = 0; e < PN; ++e) acc[g][e] += pj * vv[e];
      }
    }
  }

  // the warp's partial: l over all lanes, acc over the lanes of one piece
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l[g] = warp_sum(l[g]);
#pragma unroll
    for (int o = R; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < PN; ++e) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
    if (lane == 0) {
      sm[warp * G + g] = m[g];
      sl[warp * G + g] = l[g];
    }
    if (lane < RD) {
#pragma unroll
      for (int e = 0; e < PN; ++e) sacc[(warp * G + g) * D + lane * PN + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the block's W partials; thread i takes (g, d) = (i / D, i % D)
  const size_t P = (size_t)G * (D + 2);  // floats of one partial in the workspace
  float* mine = part + ((size_t)bh * nblk + blk) * P;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float M = NEG;
    for (int w = 0; w < W; ++w) M = fmaxf(M, sm[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < W; ++w) {
      const float c = expf(sm[w * G + g] - M);
      L += sl[w * G + g] * c;
      A += sacc[(w * G + g) * D + d] * c;
    }
    if (nblk == 1) {
      out[(size_t)bh * G * D + i] = from_f<T>(A / (L == 0.f ? 1.f : L));
    } else {
      mine[i] = A;
      if (d == 0) {
        mine[G * D + g] = M;
        mine[G * D + G + g] = L;
      }
    }
  }
  if (nblk == 1) return;

  // split: the block that draws the last ticket of this (sequence, KV
  // head) merges all nblk partials (the threadFenceReduction pattern: each
  // block's partial is visible device-wide before its ticket is taken)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(tickets + bh, 1u) == (unsigned)(nblk - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* all = part + (size_t)bh * nblk * P;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float M = NEG;
    for (int b = 0; b < nblk; ++b) M = fmaxf(M, __ldcg(all + b * P + G * D + g));
    float L = 0.f, A = 0.f;
    for (int b = 0; b < nblk; ++b) {
      const float c = expf(__ldcg(all + b * P + G * D + g) - M);
      L += __ldcg(all + b * P + G * D + G + g) * c;
      A += __ldcg(all + b * P + i) * c;
    }
    out[(size_t)bh * G * D + i] = from_f<T>(A / (L == 0.f ? 1.f : L));
  }
  // every other block of this (sequence, KV head) has taken its ticket:
  // the next launch finds 0
  if (threadIdx.x == 0) tickets[bh] = 0u;
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           unsigned* tickets, float* part, int B, int Hkv, int S, float scale, int warps,
           int nblk, cudaStream_t stream) {
  const int smem = smem_floats(warps, G, D) * (int)sizeof(float);
  if (warps < 1 || warps > 16 || nblk < 1 || smem > SMEM_MAX ||
      (nblk > 1 && (tickets == nullptr || part == nullptr)))
    return 1;
  const int BH = B * Hkv;
  decode_kernel<T, D, G><<<dim3(BH, nblk), warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), part, tickets, Hkv, S, scale);
  return 0;
}

template <typename T, int D>
int by_group(int G, const void* q, const void* k, const void* v, const int* lengths, void* out,
             unsigned* tickets, float* part, int B, int Hkv, int S, float scale, int warps,
             int nblk, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    case 2: return launch<T, D, 2>(q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    case 4: return launch<T, D, 4>(q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    case 6: return launch<T, D, 6>(q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    case 7: return launch<T, D, 7>(q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    case 8: return launch<T, D, 8>(q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    default: return 1;
  }
}

template <typename T>
int by_dim(int D, int G, const void* q, const void* k, const void* v, const int* lengths,
           void* out, unsigned* tickets, float* part, int B, int Hkv, int S, float scale,
           int warps, int nblk, cudaStream_t stream) {
  switch (D) {
    case 16: return by_group<T, 16>(G, q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    case 32: return by_group<T, 32>(G, q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    case 64: return by_group<T, 64>(G, q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    case 112: return by_group<T, 112>(G, q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    case 128: return by_group<T, 128>(G, q, k, v, lengths, out, tickets, part, B, Hkv, S, scale, warps, nblk, stream);
    default: return 1;
  }
}

}  // namespace

// The launch's arguments, which the wrapper packs as 17 little-endian
// 8-byte fields (struct "<13qd3q", a null pointer as 0): ctypes then
// passes one buffer instead of converting 17 arguments.  dtype: 0 =
// float32, 1 = bfloat16.  q (B, Hkv*G, D), caches (B, Hkv, S, D), all
// contiguous; (warps, nblk) from decode_plan.  The split path (nblk > 1)
// takes two buffers, null otherwise: `tickets`, at least B*Hkv counters
// that are 0 (each launch leaves its own at 0), and `part`, room for
// B*Hkv*nblk partials of G*(D+2) floats.  They are apart so that no
// launch's partials land where a later launch with more (sequence, KV
// head) pairs keeps its tickets.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  unsigned* tickets;
  float* part;
  long long B, Hkv, G, S, D, dtype;
  double scale;
  long long warps, nblk;
  cudaStream_t stream;
};
static_assert(sizeof(DecodeArgs) == 17 * 8, "DecodeArgs must match the wrapper's \"<13qd3q\"");

extern "C" int decode_attention_launch(const DecodeArgs* a) {
  const int B = (int)a->B, Hkv = (int)a->Hkv, G = (int)a->G, S = (int)a->S, D = (int)a->D;
  const int warps = (int)a->warps, nblk = (int)a->nblk;
  const float scale = (float)a->scale;
  if (B > 0 && Hkv > 0) {
    const int bad = a->dtype == 0
        ? by_dim<float>(D, G, a->q, a->k, a->v, a->lengths, a->out, a->tickets, a->part, B, Hkv, S, scale, warps, nblk, a->stream)
        : a->dtype == 1
        ? by_dim<__nv_bfloat16>(D, G, a->q, a->k, a->v, a->lengths, a->out, a->tickets, a->part, B, Hkv, S, scale, warps, nblk, a->stream)
        : 1;
    if (bad) return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
