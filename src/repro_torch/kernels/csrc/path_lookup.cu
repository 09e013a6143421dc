// Batched GET over the sorted 64-bit path-digest table: the WikiKV
// point lookup behind Q1/Q2/Q3 and keyword routing (Q4C).
//
// Replaces the Pallas kernel repro/kernels/path_lookup.py::path_lookup
// (body _lookup_kernel).  Same three levels, same answer:
//   level 0  a query equal to a pinned hot-set key ("/" and every
//            dimension) returns the staged sorted-table position of the
//            lowest such pinned index;
//   level 1  tile = (number of fences <= q) - 1, clipped to the table,
//            where the fences are every 128th key;
//   level 2  exact compare inside the 128-key tile that starts at
//            min(tile*128, N-128); the lowest matching position wins,
//            otherwise -1.
//
// Keys are one int64 per digest, ((hi << 32) | lo) ^ (1 << 63), so the
// signed order is the unsigned digest order; padding keys are INT64_MAX.
//
// Bound on this card: latency, not bytes.  A query reads 8 bytes in and
// writes 4 bytes out, so the roofline's bytes bound is tiny and the real
// cost is the chain of dependent loads.  Design: a block of 8 warps, one
// query a warp.  The block first stages in shared memory the pinned keys
// and positions and the top level of the fence column (every
// top_stride-th fence: every 32nd, i.e. every 4096th key, 258 keys at
// N = 1.05M).  A query then resolves level 0 and its first fence steps
// in shared memory; only the remaining 32-way fence probe (one step when
// top_stride is 32) and the one 128-key tile read go to global memory:
// two dependent global round trips a query.  The 32-way steps use
// __ballot_sync to count the probes <= q; the tile is read as 4
// coalesced loads of 32 neighbouring keys and __ballot_sync + __ffs pick
// the lowest hit.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

// One 32-way step over a sorted column: fences [0, lo) are <= q and
// [hi, ...) are > q before and after; `f` is this lane's probe at
// lo + lane * step (read by the caller, valid where t < hi).
__device__ __forceinline__ void step32(int& lo, int& hi, int step, int t, long long f,
                                       long long q) {
  const int k = __popc(__ballot_sync(FULL, t < hi && f <= q));  // probes 0..k-1 are <= q
  if (k == 0) {
    hi = lo;
  } else {
    const int next_hi = min(hi, lo + k * step);
    lo = lo + (k - 1) * step + 1;
    hi = next_hi;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
path_lookup_kernel(const long long* __restrict__ keys, int n_keys,
                   const long long* __restrict__ pin_keys, const int* __restrict__ pin_pos,
                   int n_pin, int n_pin_staged, int top_stride, int n_top,
                   const long long* __restrict__ queries, int n_q, int* __restrict__ out) {
  extern __shared__ long long smem[];
  long long* s_top = smem;                                   // n_top fences
  long long* s_pkey = smem + n_top;                          // n_pin_staged keys
  int* s_ppos = reinterpret_cast<int*>(s_pkey + n_pin_staged);
  for (int i = threadIdx.x; i < n_top; i += blockDim.x)
    s_top[i] = __ldg(keys + (long long)i * top_stride * TILE);
  for (int i = threadIdx.x; i < n_pin_staged; i += blockDim.x) {
    s_pkey[i] = __ldg(pin_keys + i);
    s_ppos[i] = __ldg(pin_pos + i);
  }
  __syncthreads();  // the only barrier: warps may leave after it

  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (qi >= n_q) return;  // the whole warp leaves together
  const long long q = __ldg(queries + qi);

  // level 0: the pinned hot set, 32 entries per probe, lowest index wins
  for (int base = 0; base < n_pin; base += 32) {
    const int i = base + lane;
    const long long key = i < n_pin_staged ? s_pkey[i] : i < n_pin ? __ldg(pin_keys + i) : 0;
    const unsigned hit = __ballot_sync(FULL, i < n_pin && key == q);
    if (hit) {
      const int f = base + __ffs(hit) - 1;
      if (lane == 0) out[qi] = f < n_pin_staged ? s_ppos[f] : __ldg(pin_pos + f);
      return;
    }
  }
  if (n_keys <= 0) {  // an empty table: -1 unless pinned
    if (lane == 0) out[qi] = -1;
    return;
  }

  // level 1: c = number of fences keys[t * TILE] <= q.  The staged top
  // level narrows it to top_stride fences in shared memory ...
  const int n_fences = (n_keys + TILE - 1) / TILE;
  int lo = 0, hi = n_fences;
  if (n_top > 0) {
    int tl = 0, th = n_top;
    while (th > tl) {
      const int step = (th - tl + 31) >> 5;
      const int t = tl + lane * step;
      step32(tl, th, step, t, t < th ? s_top[t] : 0, q);
    }
    // top fences [0, tl) are <= q: fences up to (tl - 1) * top_stride
    // are, and fences from tl * top_stride on are not
    lo = tl == 0 ? 0 : (tl - 1) * top_stride + 1;
    hi = tl == 0 ? 0 : min(tl * top_stride, n_fences);
  }
  // ... and the rest in global memory: one step when top_stride is 32
  while (hi > lo) {
    const int step = (hi - lo + 31) >> 5;
    const int t = lo + lane * step;
    step32(lo, hi, step, t, t < hi ? __ldg(keys + (long long)t * TILE) : 0, q);
  }

  // level 2: the tile, 4 coalesced loads of 32 neighbouring keys in flight
  // together, the lowest hit wins
  const int tile = min(max(lo - 1, 0), n_fences - 1);
  const long long start = max(0LL, min((long long)tile * TILE, (long long)n_keys - TILE));
  long long k[TILE / 32];
#pragma unroll
  for (int c = 0; c < TILE / 32; ++c) {
    const long long pos = start + c * 32 + lane;
    k[c] = pos < n_keys ? __ldg(keys + pos) : 0;
  }
  int found = -1;
#pragma unroll
  for (int c = 0; c < TILE / 32; ++c) {
    const unsigned hit = __ballot_sync(FULL, start + c * 32 + lane < n_keys && k[c] == q);
    if (hit && found < 0) found = (int)(start + c * 32 + __ffs(hit) - 1);
  }
  if (lane == 0) out[qi] = found;
}

}  // namespace

// The launch's arguments, which the wrapper packs as 14 little-endian
// int64 (struct "<14q", a null pointer as 0): ctypes then passes one
// buffer instead of converting 14 arguments on every call.
// The geometry comes from kernels/path_lookup.py::lookup_geometry:
// `blocks` blocks of 8 warps, one query a warp, the top level (every
// top_stride-th fence, n_top of them; 0 for none) and the first
// n_pin_staged pinned entries in `smem` bytes of shared memory.
struct LookupArgs {
  const long long* keys;
  long long n_keys;
  const long long* pin_keys;
  const int* pin_pos;
  long long n_pin;
  const long long* queries;
  long long n_q;
  int* out;
  long long blocks, top_stride, n_top, n_pin_staged, smem;
  cudaStream_t stream;
};
static_assert(sizeof(LookupArgs) == 14 * 8, "LookupArgs must match the wrapper's \"<14q\"");

extern "C" int path_lookup_launch(const LookupArgs* a) {
  if (a->n_q > 0)
    path_lookup_kernel<<<(int)a->blocks, WARPS * 32, (int)a->smem, a->stream>>>(
        a->keys, (int)a->n_keys, a->pin_keys, a->pin_pos, (int)a->n_pin,
        (int)a->n_pin_staged, (int)a->top_stride, (int)a->n_top, a->queries, (int)a->n_q,
        a->out);
  return (int)cudaGetLastError();
}

extern "C" const char* path_lookup_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
