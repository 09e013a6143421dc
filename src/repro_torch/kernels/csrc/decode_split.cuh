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
// 16, both runtime values; registers are sized by bounds (the group by 2,
// 4, 8 or 16; a combine lane's columns by 1, 2 or 4), so a rank count or a
// group that divides differently needs nothing new.
//
// Bound on this card: bytes, both kernels.  decode_scores reads the live
// K rows and writes every score (zeros past the length); decode_combine
// reads the live scores and V rows.  A slice's rows are narrow (16 bytes
// at Dl 8 in bf16), so what keeps either off that bound is fixed cost and
// the instructions and latency spent on each byte, not arithmetic.
//
// decode_scores: a block walks a contiguous run of tiles of one or more
// (sequence, KV head)s (kernels/decode_split.py::scores_plan), reading a
// lane's length once a run.  Where a K row is one 16-byte piece (Dl 8 in
// bf16, 4 in f32) a thread takes 4 consecutive positions, loads their rows
// straight into registers and writes each head's 4 scores as one float4;
// where a row is several whole pieces (Dl 16 .. 128 in bf16) LANES_A_ROW
// lanes share a row, each taking every LANES_A_ROW-th piece, so that a
// warp's load is a few contiguous runs (one row a thread would touch 32
// lines a load), their partial sums meet by shuffles, and each warp writes
// a contiguous run of each head's scores; other rows (Dl 4 or 7 in bf16)
// come through a two-stage shared ring, the tile's contiguous run copied
// as 16-byte pieces (cp.async), 4 positions a thread.  The first loads of
// the next tile are issued before this tile's scores are stored.  The
// group's q sits in shared memory as f32.  A tile wholly past the length
// only stores zeros; a tile of rows in registers takes no block barrier.
//
// decode_combine: one pass of online softmax (running max and rescale,
// as flash-decoding does), so each live score and V row crosses HBM once.
// A (sequence, KV head)'s live positions [0, length) are cut at run time
// into at most nblk spans of whole CHUNKs, each of at least span_min
// positions (kernels/decode_split.py::combine_plan and combine_span_min;
// combine_spans mirrors the cut), so no block is given a position past
// the length and a long lane takes more blocks than a short one.  Where a
// V row is a power of two of whole 16-byte pieces and the group is at most
// ROW_MAX_G (qwen3's slices, the router's), lanes take whole rows: Q lanes
// a row, each with up to 2 of its pieces, 4 rows a lane a chunk into
// registers, the next chunk's loads in flight, each lane with its own
// running max over its rows, and no warp reduction until one shuffle merge
// of the lanes that hold the same columns at the end.  Otherwise a warp
// takes chunks of 32 positions whose V run and G score runs are copied as
// 16-byte pieces into the warp's two-stage shared ring (cp.async), every
// head's chunk max is reduced in the same five shuffles, its p goes
// through the warp's shared buffer, and each lane holds its (head, column)
// sums in registers.  One block barrier merges the warps.  A split
// (sequence, KV head) writes each live block's (max, sum, acc) partial to
// a workspace; the block that draws the last ticket merges them in
// parallel over (head, column), every partial's loads issued before use,
// and sets the ticket back to 0: still one launch, as the fused kernel's split
// (csrc/decode_attention.cu).  Every sum runs in a fixed order for a given
// plan, so two calls are equal bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;          // the finite mask value of the reference
constexpr int MAX_G = 16;              // query heads a KV head serves, at most
constexpr int MAX_DL = 128;            // columns of a slice, at most
constexpr int SMEM_OPTIN = 226 * 1024; // after opting in: 227 KB less room for static memory

constexpr int SCORES_THREADS = 256;    // a decode_scores block
constexpr int ROWS_A_THREAD = 4;       // consecutive positions a thread takes (narrow rows)
constexpr int SCORES_TILE = SCORES_THREADS * ROWS_A_THREAD;   // positions of a tile
constexpr int SCORES_TILE_WIDE = 64;   // a tile of rows of more than 32 bytes through the ring

constexpr int COMBINE_WARPS = 4;       // a decode_combine block
constexpr int CHUNK = 32;              // positions a warp takes at once, one a lane
constexpr int STAGES = 2;              // the rings' stages
constexpr int MAX_BLOCKS = 64;         // blocks of one (sequence, KV head), at most
constexpr int ROW_MAX_G = 4;           // the group, at most, where a lane takes whole rows

__host__ __device__ constexpr int ru16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int ru4(int x) { return (x + 3) & ~3; }
// the bound on the group that sizes a kernel instance's registers
__host__ __device__ constexpr int group_bound(int G) {
  return G <= 2 ? 2 : G <= 4 ? 4 : G <= 8 ? 8 : 16;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a 16-byte piece of a K or V row as f32: 8 elements in bf16, 4 in f32
template <typename T> struct Piece;
template <> struct Piece<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& x, float* o) {
    o[0] = __uint_as_float(x.x); o[1] = __uint_as_float(x.y);
    o[2] = __uint_as_float(x.z); o[3] = __uint_as_float(x.w);
  }
};
template <> struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the 16-byte granules that cover the nbytes > 0 at src into dst (16-byte
// aligned; ru16(nbytes) + 16 bytes of room), pieces first, first + step, ...
// A granule that holds a byte of a tensor lies inside its allocation (which
// starts 16-byte aligned and is a whole number of granules), so no run is read
// past its buffer.  The run starts at byte (src & 15) of dst.
__device__ __forceinline__ void copy_run(unsigned char* dst, const void* src, int nbytes,
                                         int first, int step) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~uintptr_t(15);
  const int pieces = static_cast<int>((a + nbytes - a0 + 15) >> 4);
  for (int i = first; i < pieces; i += step)
    cp_async16(dst + 16 * i, reinterpret_cast<const unsigned char*>(a0) + 16 * i);
}
__device__ __forceinline__ int run_offset(const void* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
}

__device__ __forceinline__ int lane_length(const int* lengths, int bh, int Hkv, int S) {
  return min(max(__ldg(lengths + bh / Hkv), 0), S);
}

bool shape_ok(long long B, long long Hkv, long long G, long long S, long long Dl) {
  return B > 0 && Hkv > 0 && G >= 1 && G <= MAX_G && S > 0 && Dl >= 1 && Dl <= MAX_DL &&
         B * Hkv <= 0x7fffffffLL;
}

// Opts a kernel into up to SMEM_OPTIN of dynamic shared memory at its
// first launch (the 48 KB without opting in count its static memory too),
// before any graph capture of it where the tests and the smoke warm a call
// up first.
template <typename K>
cudaError_t allow_smem(K kernel, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
  *done = e == cudaSuccess;
  return e;
}

}  // namespace
