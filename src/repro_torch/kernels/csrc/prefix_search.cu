// Batched segment-aware prefix search: the WikiKV Q4 (SEARCH) scan.
//
// Replaces the Pallas kernel repro/kernels/prefix_search.py::prefix_search
// (body _prefix_kernel).  out[r, q] is true when row r of the (N, L) byte
// matrix starts with prefix q's first lens[q] bytes and, unless the prefix
// ends in '/', the byte after it is 0 or '/'.  The boundary check is
// skipped when lens[q] >= L.  For lens[q] == 0 the "last byte" is the
// prefix's byte 0, as in the TPU kernel.  Free rows hold zeros and
// tombstones 255s, so neither matches a real prefix.
//
// Bound on this card: bytes (N*L read, N*Q written) once the instruction
// count follows the prefixes' own lengths.  Comparing every word of the
// row for every prefix (L/4 words, with mask arithmetic on each) made the
// scan bound by instruction throughput at ~12x its bytes bound; writing
// each thread's output row apart from its neighbours touched one sector
// per 4 bytes.  Design:
//   - a persistent grid of 256-thread blocks, each walking 256-row tiles,
//     one row a thread, the row held in registers after L/16 16-byte
//     loads, the next tile's loads started before the barrier and the
//     write-out, so their latency hides behind both (the row is read from
//     device memory once for all prefixes of the launch);
//   - per block, the launch's prefixes staged in shared memory with, per
//     prefix, two 16-byte heads — words 0 and 1, and words 2 and 3, under
//     their masks, and the masks — and an 8-byte descriptor: its word
//     count ceil(len/4), the mask of its last word, the index of the byte
//     after it and whether the boundary rule applies.  The inner loop
//     does no mask arithmetic;
//   - each prefix is compared only as far as the rows need: words 0 and 1
//     of four prefixes at once, one shared load and three logic
//     operations a prefix, no branch; then one warp reduction names the
//     prefixes some lane still matches, and only those go on — words 2
//     and 3 the same way, and past word 3, where any lane still matches,
//     word by word up to the word count, the warp leaving the prefix as
//     soon as __any_sync finds no lane still matching; then the byte
//     after the prefix (from L1).  Padding prefixes, free and tombstone
//     rows fail at word 0, and rows in digest order (the engine's) or in
//     path order part from most prefixes within the first 16 bytes; the
//     answer does not depend on row order, only the speed does.  Lanes
//     past the last row take part in every vote and barrier as "not
//     matching";
//   - the block's (256 x nq) bitmap tile is built in shared memory (rows
//     padded by 16 bytes, so a warp's stores spread over the banks) and
//     written out with neighbouring lanes on neighbouring 16-byte pieces
//     (4- or 1-byte pieces where the output's alignment forbids 16).
// The wrapper splits Q into launches of at most 256 prefixes; shared
// memory above 48 KB (up to 110 KB at L = 128 and 256 prefixes) is opened
// up once, when the library is bound (prefix_search_init).
#include <cuda_runtime.h>
#include <stdint.h>

// The C entry's one argument: outside the anonymous namespace, so the
// entry keeps its external linkage.
struct SearchArgs {  // packed by kernels/prefix_search.py (struct "<11q")
  const uint8_t* tokens;
  long long n_rows;
  long long row_len;
  const uint8_t* prefixes;
  const int* lens;
  long long n_q;
  uint8_t* out;
  long long out_stride;
  long long blocks;
  long long smem;
  cudaStream_t stream;
};

namespace {

constexpr int TILE = 256;  // rows a tile = threads a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;  // 227 KB: the most a block may ask for

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The row of `row` (zeros past the last row) into registers: L/16
// 16-byte loads, left in flight until the words are first used.
template <int NV>
__device__ __forceinline__ void load_row(uint32_t (&w)[NV * 4], const uint8_t* tokens,
                                         long long row, long long n_rows) {
  if (row < n_rows) {
    const uint4* rp = reinterpret_cast<const uint4*>(tokens + row * (NV * 16));
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const uint4 x = __ldg(rp + v);
      w[4 * v] = x.x;
      w[4 * v + 1] = x.y;
      w[4 * v + 2] = x.z;
      w[4 * v + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NV * 4; ++k) w[k] = 0u;
  }
}

template <int NV>  // NV = L / 16: 16-byte vectors per row
__global__ void __launch_bounds__(TILE, 4)
prefix_search_kernel(const uint8_t* __restrict__ tokens, long long n_rows,
                     const uint8_t* __restrict__ prefixes, const int* __restrict__ lens,
                     int n_q, uint8_t* __restrict__ out, long long out_stride, int piece) {
  constexpr int L = NV * 16;
  constexpr int NW = NV * 4;  // 32-bit words per row
  extern __shared__ __align__(16) uint8_t smem[];
  const int nq4 = round_up(n_q, 4);
  const int rs = round_up(n_q, 16) + 16;  // bytes a tile row of the bitmap
  uint32_t* s_pref = reinterpret_cast<uint32_t*>(smem);                       // [n_q][NW]
  uint4* s_head = reinterpret_cast<uint4*>(smem + n_q * L);                    // [2][nq4]
  uint2* s_desc = reinterpret_cast<uint2*>(smem + n_q * L + nq4 * 32);         // [nq4]
  uint8_t* s_out = smem + n_q * L + nq4 * 40;                                  // [TILE][rs]

  // Per prefix, two heads: words 0 and 1 (s_head[q]), words 2 and 3
  // (s_head[nq4 + q]), each as (p_a & m_a, m_a, p_b & m_b, m_b), masks 0
  // past the word count — a row matches words a and b when (w_a & m_a) ==
  // p_a & m_a and likewise for b; a slot past n_q holds (1, 0, 1, 0),
  // which nothing matches.  s_desc: x = word count | next byte's index << 8
  // | boundary rule << 24, y = the last word's mask.
  const int tid = threadIdx.x;
  const uint4* gp = reinterpret_cast<const uint4*>(prefixes);
  uint4* sp = reinterpret_cast<uint4*>(s_pref);
  for (int i = tid; i < n_q * NV; i += TILE) sp[i] = __ldg(gp + i);
  for (int i = tid; i < nq4; i += TILE) {
    if (i >= n_q) {
      s_head[i] = make_uint4(1u, 0u, 1u, 0u);
      continue;
    }
    const int len = max(__ldg(lens + i), 0);
    const int nw = min((len + 3) >> 2, NW);
    const int rem = len - 4 * (nw - 1);
    const uint32_t last_mask = rem >= 4 ? 0xffffffffu : (1u << (8 * rem)) - 1u;
    const uint8_t last = prefixes[(long long)i * L + min(max(len - 1, 0), L - 1)];
    const uint32_t boundary = len < L && last != '/';
    const uint4 p = __ldg(gp + (long long)i * NV);  // words 0..3 of the prefix
    uint32_t m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = k >= nw ? 0u : k == nw - 1 ? last_mask : 0xffffffffu;
    s_head[i] = make_uint4(p.x & m[0], m[0], p.y & m[1], m[1]);
    s_head[nq4 + i] = make_uint4(p.z & m[2], m[2], p.w & m[3], m[3]);
    s_desc[i] = make_uint2((uint32_t)nw | (uint32_t)min(len, L - 1) << 8 | boundary << 24,
                           last_mask);
  }
  __syncthreads();

  const long long n_tiles = (n_rows + TILE - 1) / TILE;
  uint32_t w[NW];
  load_row<NV>(w, tokens, (long long)blockIdx.x * TILE + tid, n_rows);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * TILE;
    const uint32_t valid = row0 + tid < n_rows ? 0xfu : 0u;
    const uint8_t* my_row = tokens + (row0 + tid) * L;
    uint8_t* my_out = s_out + tid * rs;
#pragma unroll 1
    for (int q4 = 0; q4 < n_q; q4 += 4) {
      // four prefixes at once, words 0 and 1 only: bit j of `live` says
      // this lane still matches prefix q4 + j
      uint32_t live = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 h = s_head[q4 + j];
        live |= (uint32_t)((((w[0] & h.y) ^ h.x) | ((w[1] & h.w) ^ h.z)) == 0u) << j;
      }
      live &= valid;
      // the prefixes some lane still matches, one at a time (warp-uniform)
      for (uint32_t any = __reduce_or_sync(FULL, live); any; any &= any - 1) {
        const int j = __ffs(any) - 1;
        const int q = q4 + j;
        const uint4 h = s_head[nq4 + q];
        const uint2 d = s_desc[q];
        const int nw = d.x & 0xff;
        bool alive = ((live >> j) & 1u) &&
                     (((w[2] & h.y) ^ h.x) | ((w[3] & h.w) ^ h.z)) == 0u;
        if (nw > 4 && __any_sync(FULL, alive)) {  // every lane takes every vote
          const uint32_t* pw = s_pref + q * NW;
#pragma unroll
          for (int k = 4; k < NW; ++k) {
            if (k >= nw) break;
            const uint32_t m = k == nw - 1 ? d.y : 0xffffffffu;
            alive = alive && ((w[k] ^ pw[k]) & m) == 0u;
            if (!__any_sync(FULL, alive)) break;
          }
        }
        if (alive && (d.x >> 24)) {  // the byte after the prefix, from L1
          const uint32_t nb = __ldg(my_row + ((d.x >> 8) & 0xff));
          alive = nb == 0u || nb == '/';
        }
        live = (live & ~(1u << j)) | (uint32_t)alive << j;
      }
      // bit j to byte j
      *reinterpret_cast<uint32_t*>(my_out + q4) =
          (live | live << 7 | live << 14 | live << 21) & 0x01010101u;
    }
    // the next tile's rows, in flight across the barrier and the write-out
    load_row<NV>(w, tokens, row0 + (long long)gridDim.x * TILE + tid, n_rows);
    __syncthreads();

    // the tile's bitmap out: neighbouring lanes on neighbouring pieces
    const int rows = (int)min((long long)TILE, n_rows - row0);
    const int per_row = n_q / piece;
    uint8_t* obase = out + row0 * out_stride;
    for (int i = tid; i < rows * per_row; i += TILE) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * piece;
      const uint8_t* src = s_out + r * rs + c;
      uint8_t* dst = obase + r * out_stride + c;
      if (piece == 16)
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else if (piece == 4)
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
      else
        *dst = *src;
    }
    __syncthreads();  // the next tile reuses s_out
  }
}

template <int NV>
void launch(const SearchArgs* a) {
  const int n_q = (int)a->n_q;
  const uintptr_t align = reinterpret_cast<uintptr_t>(a->out) | (uintptr_t)a->out_stride |
                          (uintptr_t)n_q;
  const int piece = (align & 15) == 0 ? 16 : (align & 3) == 0 ? 4 : 1;
  prefix_search_kernel<NV><<<(int)a->blocks, TILE, (size_t)a->smem, a->stream>>>(
      a->tokens, a->n_rows, a->prefixes, a->lens, n_q, a->out, a->out_stride, piece);
}

template <int NV>
cudaError_t open_smem() {
  return cudaFuncSetAttribute(prefix_search_kernel<NV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

}  // namespace

// Once, before the first launch: lets every instance take up to 227 KB of
// shared memory (a launch above 48 KB is refused otherwise).
extern "C" int prefix_search_init() {
  cudaError_t e = open_smem<2>();
  if (e == cudaSuccess) e = open_smem<3>();
  if (e == cudaSuccess) e = open_smem<4>();
  if (e == cudaSuccess) e = open_smem<6>();
  if (e == cudaSuccess) e = open_smem<8>();
  return (int)e;
}

// tokens (n_rows, row_len) uint8 and prefixes (n_q, row_len) uint8, both
// 16-byte aligned and contiguous; lens (n_q,) int32; out rows out_stride
// bytes apart.  n_q <= 256; blocks and smem from search_geometry.
extern "C" int prefix_search_launch(const SearchArgs* a) {
  if (a->n_rows > 0 && a->n_q > 0) {
    if (a->n_q > 256 || a->smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    switch (a->row_len) {
      case 32: launch<2>(a); break;
      case 48: launch<3>(a); break;
      case 64: launch<4>(a); break;
      case 96: launch<6>(a); break;
      case 128: launch<8>(a); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* prefix_search_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
