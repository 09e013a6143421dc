// Batched segment-aware prefix search: the WikiKV Q4 (SEARCH) scan.
//
// Replaces the Pallas kernel repro/kernels/prefix_search.py::prefix_search
// (body _prefix_kernel).  out[r, q] is true when row r of the (N, L) byte
// matrix starts with prefix q's first lens[q] bytes and, unless the prefix
// ends in '/', the byte after it is 0 or '/'.  The boundary check is
// skipped when lens[q] >= L.  Free rows hold zeros and tombstones 255s, so
// neither matches a real prefix.
//
// Bound on this card: bytes.  Each row is read once (N*L) and each output
// bool written once (N*Q); the compares are a few integer operations per
// byte.  Design: one thread per row (grid-stride), the row held in
// registers after L/16 16-byte loads; all Q prefixes of the launch, their
// lengths and last bytes staged once per block in shared memory
// (Q*L + 8*Q bytes, 6.6 KB at Q = 64), read as broadcasts.  A prefix is
// compared four bytes at a time under a byte mask, and the results of four
// prefixes go out as one 32-bit store when the output row is aligned.
// The ragged tail of N is masked here (no padding rows), and the wrapper
// splits Q into launches of at most 256 prefixes to bound shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int NV>  // NV = L / 16: 16-byte vectors per row
__global__ void prefix_search_kernel(const uint8_t* __restrict__ tokens, int n_rows,
                                     const uint8_t* __restrict__ prefixes,
                                     const int* __restrict__ lens, int n_q,
                                     uint8_t* __restrict__ out, long long out_stride,
                                     int aligned4) {
  constexpr int L = NV * 16;
  constexpr int NW = NV * 4;  // 32-bit words per row
  extern __shared__ uint32_t smem[];
  uint32_t* s_pref = smem;                        // [n_q][NW]
  int* s_len = reinterpret_cast<int*>(smem + n_q * NW);
  uint32_t* s_last = reinterpret_cast<uint32_t*>(s_len + n_q);
  const uint32_t* gp = reinterpret_cast<const uint32_t*>(prefixes);
  for (int i = threadIdx.x; i < n_q * NW; i += blockDim.x) s_pref[i] = gp[i];
  for (int i = threadIdx.x; i < n_q; i += blockDim.x) {
    const int len = lens[i];
    s_len[i] = len;
    s_last[i] = prefixes[(long long)i * L + min(max(len - 1, 0), L - 1)];
  }
  __syncthreads();

  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += (long long)gridDim.x * blockDim.x) {
    uint32_t w[NW];
    const uint4* rp = reinterpret_cast<const uint4*>(tokens + row * L);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const uint4 x = __ldg(rp + v);
      w[4 * v] = x.x;
      w[4 * v + 1] = x.y;
      w[4 * v + 2] = x.z;
      w[4 * v + 3] = x.w;
    }
    uint8_t* orow = out + row * out_stride;
    for (int q4 = 0; q4 < n_q; q4 += 4) {
      uint32_t pack = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q4 + j;
        if (q >= n_q) break;
        const int len = s_len[q];
        const uint32_t* pw = s_pref + q * NW;
        const int nxt_at = min(len, L - 1);
        bool eq = true;
        uint32_t nxt_word = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          const int rem = len - 4 * k;
          if (rem > 0) {
            const uint32_t m = rem >= 4 ? 0xffffffffu : ((1u << (8 * rem)) - 1u);
            eq = eq && ((w[k] ^ pw[k]) & m) == 0u;
          }
          if (k == (nxt_at >> 2)) nxt_word = w[k];
        }
        const uint32_t nxt = (nxt_word >> (8 * (nxt_at & 3))) & 0xffu;
        const bool boundary = s_last[q] == '/' || nxt == 0u || nxt == '/';
        if (eq && (len >= L || boundary)) pack |= 1u << (8 * j);
      }
      if (aligned4 && q4 + 4 <= n_q) {
        *reinterpret_cast<uint32_t*>(orow + q4) = pack;
      } else {
        for (int j = 0; j < 4 && q4 + j < n_q; ++j) orow[q4 + j] = (pack >> (8 * j)) & 1u;
      }
    }
  }
}

template <int NV>
void launch(const uint8_t* tokens, int n_rows, const uint8_t* prefixes, const int* lens,
            int n_q, uint8_t* out, long long out_stride, int aligned4, cudaStream_t stream) {
  constexpr int THREADS = 256;
  const size_t smem = (size_t)n_q * (NV * 16 + 8);
  long long blocks = ((long long)n_rows + THREADS - 1) / THREADS;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM on 132 SMs, grid-stride beyond
  if (blocks < 1) blocks = 1;
  prefix_search_kernel<NV><<<(int)blocks, THREADS, smem, stream>>>(
      tokens, n_rows, prefixes, lens, n_q, out, out_stride, aligned4);
}

}  // namespace

extern "C" int prefix_search_launch(const uint8_t* tokens, int n_rows, int row_len,
                                    const uint8_t* prefixes, const int* lens, int n_q,
                                    uint8_t* out, long long out_stride, cudaStream_t stream) {
  if (n_rows > 0 && n_q > 0) {
    const int aligned4 = ((reinterpret_cast<uintptr_t>(out) | (uintptr_t)out_stride) & 3) == 0;
    switch (row_len) {
      case 32: launch<2>(tokens, n_rows, prefixes, lens, n_q, out, out_stride, aligned4, stream); break;
      case 48: launch<3>(tokens, n_rows, prefixes, lens, n_q, out, out_stride, aligned4, stream); break;
      case 64: launch<4>(tokens, n_rows, prefixes, lens, n_q, out, out_stride, aligned4, stream); break;
      case 96: launch<6>(tokens, n_rows, prefixes, lens, n_q, out, out_stride, aligned4, stream); break;
      case 128: launch<8>(tokens, n_rows, prefixes, lens, n_q, out, out_stride, aligned4, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* prefix_search_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
