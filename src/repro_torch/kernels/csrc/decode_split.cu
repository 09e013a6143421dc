// Single-token GQA decode attention split over a slice of head_dim: the
// decode of a KV cache whose head_dim is cut over the "model" ranks (the
// reference's "head_dim" cache layout, repro/models/model.py::
// decode_state_specs).  Each rank holds columns [r*Dl, (r+1)*Dl) of every
// head, so its cache write is local; attention then runs in two launches
// around one all-reduce of the partial scores:
//
//   decode_scores   q (B, Hq, Dl) x K (B, Hkv, S, Dl) -> s (B, Hq, S) f32:
//                   the slice's q.k times the WHOLE head's 1/sqrt(Dh), so
//                   the ranks' scores sum to the fused kernel's; 0 at
//                   positions at or past lengths[b];
//   (the caller all-reduces s over the ranks)
//   decode_combine  s (B, Hq, S) f32, V (B, Hkv, S, Dl) -> o (B, Hq, Dl):
//                   softmax over positions < lengths[b] (f32, the l == 0
//                   -> 1 guard: a length of 0 gives zeros) times the V
//                   slice, cast to V's type.
//
// Together they replace, on this layout, the Pallas kernel
// repro/kernels/decode_attention.py::decode_attention (body
// _decode_kernel), whose fused softmax needs a head's whole vector.
//
// Dl is any width up to 128 (4 for internvl2's 64 over 16 ranks, 7 for
// kimi-k2's 112, 8 for the 128-wide heads) and G = Hq/Hkv any group up to
// 16, both runtime values (decode_combine bounds the group by 2, 4, 8 or
// 16 for its registers): no table of groups, so a rank count or a group
// that divides differently needs nothing new.  Rows of Dl elements
// are not 16-byte aligned in general (Dl = 7), so each kernel reads its
// rows as one contiguous run, with 16-byte loads only where a row is
// whole 16-byte pieces (decode_scores' K tile).
//
// decode_scores: one block per (sequence, KV head, tile of positions), a
// thread a position.  The block stages the G query rows and the tile's K
// rows (one contiguous run of tile*Dl elements, read coalesced) in shared
// memory as f32, the K tile transposed (pitch tile + 1) so that thread t
// reads column d of its row without bank conflicts, and writes G scores.
// A tile wholly past the length reads nothing and writes zeros.
//
// decode_combine: one block per (sequence, KV head, span of positions).
// Pass 1 takes the block's max of each head's scores; then, tile by tile,
// the threads write p = exp(s - max) for the G heads into shared memory,
// and (position lane, d) threads accumulate p * V[t, d] (a V row's Dl
// elements are adjacent threads', so a tile's rows are read coalesced).
// The lanes' partials are summed in shared memory.  Where B*Hkv blocks
// would leave the card short of blocks (four a SM), the plan
// (kernels/decode_split.py::combine_plan) splits a (sequence, KV head)
// over nblk blocks, and the block that draws the last ticket merges their
// (max, sum, acc) partials, as the fused kernel does
// (csrc/decode_attention.cu): still one launch.
//
// Bound on this card: bytes.  decode_scores reads the live K rows and
// writes the scores; decode_combine reads the live scores and V rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;        // the finite mask value of the reference
constexpr int MAX_G = 16;            // query heads a KV head serves, at most
constexpr int MAX_DL = 128;          // columns of a slice, at most
constexpr int SMEM_MAX = 48 * 1024;  // dynamic shared memory without opting in
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_TILE = 64;     // positions whose p a combine block stages at once

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

// ---------------------------------------------------------------------------
// decode_scores
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int scores_smem_floats(int G, int Dl, int tile) {
  return G * Dl + Dl * (tile + 1);
}

template <typename T>
__global__ void __launch_bounds__(256)
scores_kernel(const T* __restrict__ q, const T* __restrict__ k, const int* __restrict__ lengths,
              float* __restrict__ s, int Hkv, int G, int S, int Dl, float scale) {
  const int tile = blockDim.x;
  const int bh = blockIdx.x;   // sequence * Hkv + KV head
  const int p0 = blockIdx.y * tile;
  const int t = threadIdx.x;
  const int length = min(max(lengths[bh / Hkv], 0), S);
  const int n = min(tile, length - p0);   // live rows of this tile
  float* srow = s + (size_t)bh * G * S;   // head g of the group at srow + g * S
  if (n <= 0) {
    if (p0 + t < S)
      for (int g = 0; g < G; ++g) srow[(size_t)g * S + p0 + t] = 0.f;
    return;
  }
  extern __shared__ float smem[];
  float* sq = smem;              // [G][Dl]
  float* sk = smem + G * Dl;     // [Dl][tile + 1]
  const int pitch = tile + 1;
  for (int i = t; i < G * Dl; i += tile) sq[i] = to_f(q[(size_t)bh * G * Dl + i]);
  const T* kb = k + ((size_t)bh * S + p0) * Dl;   // the tile's rows, contiguous
  constexpr int VN = 16 / sizeof(T);              // elements of a 16-byte load
  if ((Dl * (int)sizeof(T)) % 16 == 0 && reinterpret_cast<size_t>(k) % 16 == 0) {
    // rows of whole 16-byte pieces: VN elements of one row a load
    const uint4* kv = reinterpret_cast<const uint4*>(kb);
    for (int i = t * VN; i < n * Dl; i += tile * VN) {
      const int r = i / Dl, d = i - r * Dl;
      const uint4 x = __ldg(kv + i / VN);
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int j = 0; j < VN; ++j) sk[(d + j) * pitch + r] = to_f(e[j]);
    }
  } else {
    for (int i = t; i < n * Dl; i += tile) {
      const int r = i / Dl, d = i - r * Dl;
      sk[d * pitch + r] = to_f(__ldg(kb + i));
    }
  }
  __syncthreads();
  if (p0 + t >= S) return;
  if (t >= n) {
    for (int g = 0; g < G; ++g) srow[(size_t)g * S + p0 + t] = 0.f;
    return;
  }
  for (int g = 0; g < G; ++g) {
    const float* qg = sq + g * Dl;
    float acc = 0.f;
    for (int d = 0; d < Dl; ++d) acc += qg[d] * sk[d * pitch + t];
    srow[(size_t)g * S + p0 + t] = acc * scale;
  }
}

// ---------------------------------------------------------------------------
// decode_combine
// ---------------------------------------------------------------------------
// Shared memory: the block's max of each head (G), a reduction slot a warp
// (8), the tile's p (G x COMBINE_TILE), and each lane's partial sums
// (lanes x G x Dl, and lanes x G of l); lanes = COMBINE_THREADS / Dl.
__host__ __device__ constexpr int combine_smem_floats(int G, int Dl) {
  return G + COMBINE_THREADS / 32 + G * COMBINE_TILE + (COMBINE_THREADS / Dl) * G * (Dl + 1);
}

// MG: a bound on the group, G <= MG, so that a thread's G accumulators
// stay in registers (one instance for each of 2, 4, 8 and 16).
template <typename T, int MG>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ s, const T* __restrict__ v,
               const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ part,
               unsigned* __restrict__ tickets, int Hkv, int G, int S, int Dl) {
  const int bh = blockIdx.x;
  const int blk = blockIdx.y, nblk = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int length = min(max(lengths[bh / Hkv], 0), S);
  const int span = (S + nblk - 1) / nblk;
  const int lo = blk * span, hi = min(lo + span, length);
  const float* srow = s + (size_t)bh * G * S;
  const T* vb = v + (size_t)bh * S * Dl;
  const int lanes = COMBINE_THREADS / Dl;

  extern __shared__ float smem[];
  float* sM = smem;                          // [G]
  float* red = sM + G;                       // [warps]
  float* sp = red + COMBINE_THREADS / 32;    // [G][COMBINE_TILE]
  float* sacc = sp + G * COMBINE_TILE;       // [lanes][G][Dl]
  float* sl = sacc + lanes * G * Dl;         // [lanes][G]
  __shared__ int s_last;

  // pass 1: the block's max of each head's scores over [lo, hi)
  for (int g = 0; g < G; ++g) {
    float m = NEG;
    for (int t = lo + tid; t < hi; t += COMBINE_THREADS) m = fmaxf(m, srow[(size_t)g * S + t]);
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (tid == 0) {
      float M = NEG;
      for (int w = 0; w < COMBINE_THREADS / 32; ++w) M = fmaxf(M, red[w]);
      sM[g] = M;
    }
    __syncthreads();
  }

  // pass 2: p = exp(s - max) a tile at a time, then P.V by (lane, column)
  const int ln = tid / Dl, d = tid - ln * Dl;
  const bool active = ln < lanes;
  float acc[MG], l[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) acc[g] = l[g] = 0.f;
  for (int base = lo; base < hi; base += COMBINE_TILE) {
    const int n = min(COMBINE_TILE, hi - base);
    for (int i = tid; i < G * COMBINE_TILE; i += COMBINE_THREADS) {
      const int g = i / COMBINE_TILE, j = i - g * COMBINE_TILE;
      sp[i] = j < n ? expf(srow[(size_t)g * S + base + j] - sM[g]) : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int j = ln; j < n; j += lanes) {
        const float x = to_f(__ldg(vb + (size_t)(base + j) * Dl + d));
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          if (g < G) {
            const float p = sp[g * COMBINE_TILE + j];
            acc[g] += p * x;
            l[g] += p;
          }
        }
      }
    }
    __syncthreads();
  }

  // the lanes' partials: acc by (lane, head, column); l once a lane
  if (active) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
        sacc[(ln * G + g) * Dl + d] = acc[g];
        if (d == 0) sl[ln * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  const size_t P = (size_t)G * (Dl + 2);   // floats of one partial in the workspace
  float* mine = part + ((size_t)bh * nblk + blk) * P;
  for (int i = tid; i < G * Dl; i += COMBINE_THREADS) {
    const int g = i / Dl;
    float A = 0.f, L = 0.f;
    for (int r = 0; r < lanes; ++r) {
      A += sacc[(r * G + g) * Dl + (i - g * Dl)];
      L += sl[r * G + g];
    }
    if (nblk == 1) {
      out[(size_t)bh * G * Dl + i] = from_f<T>(A / (L == 0.f ? 1.f : L));
    } else {
      mine[i] = A;
      if (i - g * Dl == 0) {
        mine[G * Dl + g] = sM[g];
        mine[G * Dl + G + g] = L;
      }
    }
  }
  if (nblk == 1) return;

  // split: the block that draws the last ticket of this (sequence, KV
  // head) merges all nblk partials and sets the ticket back to 0
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + bh, 1u) == (unsigned)(nblk - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* all = part + (size_t)bh * nblk * P;
  for (int i = tid; i < G * Dl; i += COMBINE_THREADS) {
    const int g = i / Dl;
    float M = NEG;
    for (int b = 0; b < nblk; ++b) M = fmaxf(M, __ldcg(all + b * P + G * Dl + g));
    float L = 0.f, A = 0.f;
    for (int b = 0; b < nblk; ++b) {
      const float c = expf(__ldcg(all + b * P + G * Dl + g) - M);
      L += __ldcg(all + b * P + G * Dl + G + g) * c;
      A += __ldcg(all + b * P + i) * c;
    }
    out[(size_t)bh * G * Dl + i] = from_f<T>(A / (L == 0.f ? 1.f : L));
  }
  if (tid == 0) tickets[bh] = 0u;
}

bool shape_ok(long long B, long long Hkv, long long G, long long S, long long Dl) {
  return B > 0 && Hkv > 0 && G >= 1 && G <= MAX_G && S > 0 && Dl >= 1 && Dl <= MAX_DL;
}

template <typename T, int MG>
void combine(const float* s, const void* v, const int* lengths, void* out, float* part,
             unsigned* tickets, int B, int Hkv, int G, int S, int Dl, int nblk, int smem,
             cudaStream_t stream) {
  combine_kernel<T, MG><<<dim3(B * Hkv, nblk), COMBINE_THREADS, smem, stream>>>(
      s, static_cast<const T*>(v), lengths, static_cast<T*>(out), part, tickets, Hkv, G, S, Dl);
}

template <typename T>
void combine_by_group(const float* s, const void* v, const int* lengths, void* out, float* part,
                      unsigned* tickets, int B, int Hkv, int G, int S, int Dl, int nblk,
                      int smem, cudaStream_t stream) {
  if (G <= 2)
    combine<T, 2>(s, v, lengths, out, part, tickets, B, Hkv, G, S, Dl, nblk, smem, stream);
  else if (G <= 4)
    combine<T, 4>(s, v, lengths, out, part, tickets, B, Hkv, G, S, Dl, nblk, smem, stream);
  else if (G <= 8)
    combine<T, 8>(s, v, lengths, out, part, tickets, B, Hkv, G, S, Dl, nblk, smem, stream);
  else
    combine<T, 16>(s, v, lengths, out, part, tickets, B, Hkv, G, S, Dl, nblk, smem, stream);
}

}  // namespace

// decode_scores' arguments, packed by the wrapper as 13 little-endian
// 8-byte fields (struct "<10qd2q", a null pointer as 0).  dtype: 0 =
// float32, 1 = bfloat16.  q (B, Hkv*G, Dl), k (B, Hkv, S, Dl), lengths (B,)
// int32, out (B, Hkv*G, S) float32, all contiguous; tile: positions a
// block (its thread count, from kernels/decode_split.py::scores_tile).
struct ScoresArgs {
  const void* q;
  const void* k;
  const int* lengths;
  float* out;
  long long B, Hkv, G, S, Dl, dtype;
  double scale;
  long long tile;
  cudaStream_t stream;
};
static_assert(sizeof(ScoresArgs) == 13 * 8, "ScoresArgs must match the wrapper's \"<10qd2q\"");

// decode_combine's, as 14 fields ("<14q"): s (B, Hkv*G, S) float32, v (B,
// Hkv, S, Dl), lengths (B,) int32, out (B, Hkv*G, Dl) in v's type.  The
// split path (nblk > 1) takes `tickets`, at least B*Hkv counters that are 0
// (each launch leaves its own at 0), and `part`, room for B*Hkv*nblk
// partials of G*(Dl+2) floats; null otherwise.
struct CombineArgs {
  const float* s;
  const void* v;
  const int* lengths;
  void* out;
  unsigned* tickets;
  float* part;
  long long B, Hkv, G, S, Dl, dtype, nblk;
  cudaStream_t stream;
};
static_assert(sizeof(CombineArgs) == 14 * 8, "CombineArgs must match the wrapper's \"<14q\"");

extern "C" int decode_scores_launch(const ScoresArgs* a) {
  const int tile = (int)a->tile;
  const int smem = scores_smem_floats((int)a->G, (int)a->Dl, tile) * (int)sizeof(float);
  if (!shape_ok(a->B, a->Hkv, a->G, a->S, a->Dl) || tile < 32 || tile > 256 || tile % 32 ||
      smem > SMEM_MAX || (a->dtype != 0 && a->dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(a->B * a->Hkv), (unsigned)((a->S + tile - 1) / tile));
  if (a->dtype == 0)
    scores_kernel<float><<<grid, tile, smem, a->stream>>>(
        static_cast<const float*>(a->q), static_cast<const float*>(a->k), a->lengths, a->out,
        (int)a->Hkv, (int)a->G, (int)a->S, (int)a->Dl, (float)a->scale);
  else
    scores_kernel<__nv_bfloat16><<<grid, tile, smem, a->stream>>>(
        static_cast<const __nv_bfloat16*>(a->q), static_cast<const __nv_bfloat16*>(a->k),
        a->lengths, a->out, (int)a->Hkv, (int)a->G, (int)a->S, (int)a->Dl, (float)a->scale);
  return (int)cudaGetLastError();
}

extern "C" int decode_combine_launch(const CombineArgs* a) {
  const int smem = combine_smem_floats((int)a->G, (int)a->Dl) * (int)sizeof(float);
  if (!shape_ok(a->B, a->Hkv, a->G, a->S, a->Dl) || a->nblk < 1 || smem > SMEM_MAX ||
      (a->nblk > 1 && (a->tickets == nullptr || a->part == nullptr)) ||
      (a->dtype != 0 && a->dtype != 1))
    return (int)cudaErrorInvalidValue;
  (a->dtype == 0 ? combine_by_group<float> : combine_by_group<__nv_bfloat16>)(
      a->s, a->v, a->lengths, a->out, a->part, a->tickets, (int)a->B, (int)a->Hkv, (int)a->G,
      (int)a->S, (int)a->Dl, (int)a->nblk, smem, a->stream);
  return (int)cudaGetLastError();
}

extern "C" const char* decode_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
