// Single-token GQA decode attention over a padded KV cache, split-KV
// (FlashDecoding): the serving LM's attention in every decode step.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention (body _decode_kernel).  For sequence b and query head
// h (KV head h / G): scores q.k * scale in f32 over positions < lengths[b],
// online softmax in f32, out = sum p v / l with the l == 0 -> 1 guard
// (a length of 0 gives zeros), cast to the input type.  The scale is
// applied to the f32 scores, as the TPU kernel does.
//
// The TPU carried (m, l, acc) in VMEM scratch across a sequential grid
// over KV blocks.  Hopper's blocks run in no order, so the reduction over
// KV is split in two kernels: decode_split_kernel, where one warp owns a
// slice of `chunk` positions of one (sequence, KV head) and the whole
// query-head group of that KV head (the K/V rows are read once for all G
// heads), writes its partial (m, l, acc); decode_combine_kernel merges the
// partials of each (sequence, KV head).  Slices at or past the length are
// never launched into work: their warps return at once and the combine
// reads only the valid ones, so the cost follows the live lengths, not S.
//
// Bound on this card: bytes (K and V once: 2*B*Hkv*len*D*elt; about one
// flop per byte).  At serving shapes (B = 4, len <= 512, D = 64) that is
// well under a megabyte and the kernel is bound by launch latency.
// Inside a warp a lane owns one key row for the scores (16-byte loads of
// its row, q from shared memory as broadcasts) and one or more head
// dimensions for P.V (coalesced V rows, p broadcast by __shfl_sync).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;  // the finite mask value of the reference

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

template <typename T, int D, int G>
__global__ void decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, const int* __restrict__ lengths,
                                    float* __restrict__ m_out, float* __restrict__ l_out,
                                    float* __restrict__ acc_out, int Hkv, int S, int chunk,
                                    int n_split, float scale) {
  using VT = typename Vec<T>::type;
  constexpr int VN = Vec<T>::N;
  constexpr int DPL = (D + 31) / 32;  // head dims per lane in the P.V phase
  const int bh = blockIdx.x;          // sequence * Hkv + KV head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.y * WARPS + warp;
  const int length = min(lengths[bh / Hkv], S);

  __shared__ float sq[G][D];
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    sq[i / D][i % D] = to_f(q[(size_t)bh * G * D + i]);
  __syncthreads();

  const int s0 = split * chunk;
  if (split >= n_split || s0 >= length) return;  // the combine skips this slice
  const int s1 = min(s0 + chunk, length);
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  for (int base = s0; base < s1; base += 32) {
    const int s = base + lane;
    const bool valid = s < s1;
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    if (valid) {
      const VT* kr = reinterpret_cast<const VT*>(kb + (size_t)s * D);
#pragma unroll
      for (int c = 0; c < D / VN; ++c) {
        float kv[VN];
        Vec<T>::unpack(__ldg(kr + c), kv);
#pragma unroll
        for (int e = 0; e < VN; ++e)
#pragma unroll
          for (int g = 0; g < G; ++g) sc[g] += sq[g][c * VN + e] * kv[e];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s_g = valid ? sc[g] * scale : NEG;
      const float m_new = fmaxf(m[g], warp_max(s_g));
      const float alpha = expf(m[g] - m_new);
      const float p = valid ? expf(s_g - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
      m[g] = m_new;
      sc[g] = p;
    }
    const int n = min(32, s1 - base);
    for (int j = 0; j < n; ++j) {
      const T* vr = vb + (size_t)(base + j) * D;
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? to_f(vr[d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(FULL, sc[g], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] += pj * vv[i];
      }
    }
  }

  const size_t o = ((size_t)bh * n_split + split) * G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      m_out[o + g] = m[g];
      l_out[o + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc_out[(o + g) * D + d] = acc[g][i];
    }
  }
}

template <typename T, int D, int G>
__global__ void decode_combine_kernel(const float* __restrict__ m_in,
                                      const float* __restrict__ l_in,
                                      const float* __restrict__ acc_in,
                                      const int* __restrict__ lengths, T* __restrict__ out,
                                      int Hkv, int S, int chunk, int n_split) {
  const int bh = blockIdx.x;
  const int length = min(lengths[bh / Hkv], S);
  const int n_valid = length > 0 ? min(n_split, (length + chunk - 1) / chunk) : 0;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float M = NEG;
    for (int s = 0; s < n_valid; ++s) M = fmaxf(M, m_in[((size_t)bh * n_split + s) * G + g]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_valid; ++s) {
      const size_t o = ((size_t)bh * n_split + s) * G + g;
      const float w = expf(m_in[o] - M);
      L += l_in[o] * w;
      A += acc_in[o * D + d] * w;
    }
    out[(size_t)bh * G * D + i] = from_f<T>(A / (L == 0.f ? 1.f : L));
  }
}

template <typename T, int D, int G>
void launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
            float* m_scr, float* l_scr, float* acc_scr, int BH, int Hkv, int S, int chunk,
            int n_split, float scale, cudaStream_t stream) {
  const dim3 grid(BH, (n_split + WARPS - 1) / WARPS);
  decode_split_kernel<T, D, G><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      m_scr, l_scr, acc_scr, Hkv, S, chunk, n_split, scale);
  int threads = ((G * D + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  decode_combine_kernel<T, D, G><<<BH, threads, 0, stream>>>(
      m_scr, l_scr, acc_scr, lengths, static_cast<T*>(out), Hkv, S, chunk, n_split);
}

template <typename T, int D>
int by_group(int G, const void* q, const void* k, const void* v, const int* lengths, void* out,
             float* m_scr, float* l_scr, float* acc_scr, int BH, int Hkv, int S, int chunk,
             int n_split, float scale, cudaStream_t stream) {
  switch (G) {
    case 1: launch<T, D, 1>(q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream); return 0;
    case 2: launch<T, D, 2>(q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream); return 0;
    case 4: launch<T, D, 4>(q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream); return 0;
    case 6: launch<T, D, 6>(q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream); return 0;
    case 8: launch<T, D, 8>(q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream); return 0;
    default: return 1;
  }
}

template <typename T>
int by_dim(int D, int G, const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* m_scr, float* l_scr, float* acc_scr, int BH, int Hkv, int S,
           int chunk, int n_split, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return by_group<T, 16>(G, q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream);
    case 32: return by_group<T, 32>(G, q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream);
    case 64: return by_group<T, 64>(G, q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream);
    case 128: return by_group<T, 128>(G, q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream);
    default: return 1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (B, Hkv*G, D), caches (B, Hkv, S, D),
// all contiguous; scratch m/l (B*Hkv*n_split*G) and acc (... * D) float32.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* lengths, void* out, float* m_scr,
                                       float* l_scr, float* acc_scr, int B, int Hkv, int G,
                                       int S, int D, int dtype, float scale, int chunk,
                                       int n_split, cudaStream_t stream) {
  if (B > 0 && Hkv > 0) {
    const int BH = B * Hkv;
    const int bad = dtype == 0
        ? by_dim<float>(D, G, q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream)
        : dtype == 1
        ? by_dim<__nv_bfloat16>(D, G, q, k, v, lengths, out, m_scr, l_scr, acc_scr, BH, Hkv, S, chunk, n_split, scale, stream)
        : 1;
    if (bad) return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
