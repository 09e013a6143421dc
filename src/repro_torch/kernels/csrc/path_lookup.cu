// Batched GET over the sorted 64-bit path-digest table: the WikiKV
// point lookup behind Q1/Q2/Q3 and keyword routing (Q4C).
//
// Replaces the Pallas kernel repro/kernels/path_lookup.py::path_lookup
// (body _lookup_kernel).  Same three levels, same answer:
//   level 0  a query equal to a pinned hot-set key ("/" and every
//            dimension) returns that key's staged sorted-table position;
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
// writes 4 bytes out, plus a handful of dependent loads (fences, then one
// tile), so the roofline "bytes" bound is tiny and the real cost is the
// dependent-load chain.  Design: one warp per query.  The warp searches
// the fence column 32 ways at a time (32 probes per step, __ballot_sync
// to count the probes <= q), so a table of N keys takes
// ceil(log32(N/128)) dependent steps (3 at N = 1M) instead of log2(N);
// then it reads the one tile coalesced, 4 keys per lane in 4 loads of 32
// neighbouring keys, and __ballot_sync + __ffs pick the lowest hit.  The
// TPU kept the fence column in VMEM; here it stays in L2 (N/128 * 8 bytes
// = 64 KB at 1M keys) and needs no staging.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;

__global__ void path_lookup_kernel(const long long* __restrict__ keys, int n_keys,
                                   const long long* __restrict__ pin_keys,
                                   const int* __restrict__ pin_pos, int n_pin,
                                   const long long* __restrict__ queries, int n_q,
                                   int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (qi >= n_q) return;  // the whole warp leaves together
  const long long q = queries[qi];

  // level 0: pinned hot set, 32 entries per probe, lowest index wins
  for (int base = 0; base < n_pin; base += 32) {
    const int j = base + lane;
    const unsigned hit = __ballot_sync(FULL, j < n_pin && pin_keys[j] == q);
    if (hit) {
      if (lane == 0) out[qi] = pin_pos[base + __ffs(hit) - 1];
      return;
    }
  }
  if (n_keys <= 0) {
    if (lane == 0) out[qi] = -1;
    return;
  }

  // level 1: c = number of fences keys[t * TILE] <= q, searched 32 ways.
  // Invariant: fences [0, lo) are <= q and fences [hi, n_fences) are > q.
  const int n_fences = (n_keys + TILE - 1) / TILE;
  int lo = 0, hi = n_fences;
  while (hi > lo) {
    const int step = (hi - lo + 31) >> 5;
    const int t = lo + lane * step;
    const bool le = t < hi && __ldg(keys + (long long)t * TILE) <= q;
    const int k = __popc(__ballot_sync(FULL, le));  // probes 0..k-1 are <= q
    if (k == 0) {
      hi = lo;
    } else {
      const int next_hi = min(hi, lo + k * step);
      lo = lo + (k - 1) * step + 1;
      hi = next_hi;
    }
  }
  const int tile = min(max(lo - 1, 0), n_fences - 1);
  const long long start = max(0LL, min((long long)tile * TILE, (long long)n_keys - TILE));

  // level 2: the one tile, 4 coalesced loads of 32 neighbouring keys
  int found = -1;
#pragma unroll
  for (int j = 0; j < TILE / 32; ++j) {
    const long long pos = start + j * 32 + lane;
    const unsigned hit = __ballot_sync(FULL, pos < n_keys && __ldg(keys + pos) == q);
    if (hit && found < 0) found = (int)(start + j * 32 + __ffs(hit) - 1);
  }
  if (lane == 0) out[qi] = found;
}

}  // namespace

extern "C" int path_lookup_launch(const long long* keys, int n_keys,
                                  const long long* pin_keys, const int* pin_pos,
                                  int n_pin, const long long* queries, int n_q,
                                  int* out, cudaStream_t stream) {
  if (n_q > 0) {
    const int blocks = (n_q + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    path_lookup_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, stream>>>(
        keys, n_keys, pin_keys, pin_pos, n_pin, queries, n_q, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* path_lookup_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
