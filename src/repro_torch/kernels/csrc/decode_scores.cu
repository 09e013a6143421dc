// decode_scores: one head_dim slice's share of decode attention's scores,
// q (B, Hq, Dl) x K (B, Hkv, S, Dl) -> (B, Hq, S) f32; its design, and
// decode_combine's, in decode_split.cuh, which both sources share (each
// is built into a library of its own, so the two compile side by side).
#include "decode_split.cuh"

namespace {

// ---------------------------------------------------------------------------
// decode_scores
// ---------------------------------------------------------------------------
// Wide rows (several whole 16-byte pieces: Dl 16 .. 128 in bf16, 8 .. 128
// in f32) are read by LANES_A_ROW lanes each: a warp's load takes 8 rows'
// runs of 4 pieces, where one row a thread would touch 32 lines a load.
// PB pieces of a row a lane (ceil(P / 4)), NPASS passes of 64 rows a tile,
// so that a lane holds NPASS x PB pieces and NPASS x MG sums.
constexpr int LANES_A_ROW = 4;
constexpr int ROWS_A_PASS = 32 / LANES_A_ROW;   // rows a warp takes a pass
__host__ __device__ constexpr int wide_pieces(int P) {
  return P <= 4 ? 1 : P <= 8 ? 2 : P <= 16 ? 4 : 8;
}
__host__ __device__ constexpr int wide_passes(int PB, int MG) {
  return (8 / PB) < (32 / MG) ? 8 / PB : (32 / MG < 1 ? 1 : 32 / MG);
}
// Positions of a tile: SCORES_TILE where a thread takes ROWS_A_THREAD rows
// (a row of one piece, or of at most 32 bytes through the ring); 8 warps x
// ROWS_A_PASS rows a pass of wide rows; SCORES_TILE_WIDE where rows of
// more than 32 bytes that are no whole number of pieces go through the
// ring (a stage then stays under 33 KB).
__host__ __device__ constexpr int scores_tile(int G, int Dl, int elt, bool vec) {
  return vec ? (Dl * elt == 16 ? SCORES_TILE
                               : SCORES_THREADS / 32 * ROWS_A_PASS *
                                     wide_passes(wide_pieces(Dl * elt / 16), group_bound(G)))
             : Dl * elt <= 32 ? SCORES_TILE : SCORES_TILE_WIDE;
}
// Shared memory: q as f32 (G rows of ru4(Dl)), and where rows are not read
// as whole pieces the ring's two stages of a tile's run.
__host__ __device__ constexpr int scores_smem_bytes(int G, int Dl, int elt, bool vec) {
  return 4 * G * ru4(Dl) +
         (vec ? 0 : STAGES * (ru16(scores_tile(G, Dl, elt, vec) * Dl * elt) + 16));
}
// every group and slice the launcher takes fits what a block may opt into,
// on either path
constexpr bool scores_smem_fits() {
  for (int G = 1; G <= MAX_G; ++G)
    for (int Dl = 1; Dl <= MAX_DL; ++Dl)
      for (int elt = 2; elt <= 4; elt += 2)
        if (scores_smem_bytes(G, Dl, elt, false) > SMEM_OPTIN ||
            ((Dl * elt) % 16 == 0 && scores_smem_bytes(G, Dl, elt, true) > SMEM_OPTIN))
          return false;
  return true;
}
static_assert(scores_smem_fits(), "decode_scores' shared memory exceeds SMEM_OPTIN");
// Whether K's rows are read as whole 16-byte pieces into registers.
bool scores_vec(long long Dl, long long dtype, const void* k) {
  return (Dl * (dtype == 0 ? 4 : 2)) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
}

// VEC: rows of whole pieces, in registers; WIDE: several pieces a row
// (LANES_A_ROW lanes a row, PB pieces a lane a pass), else one piece a row
// (ROWS_A_THREAD rows a thread); otherwise through the ring.
template <typename T, int MG, bool VEC, bool WIDE, int PB>
__global__ void __launch_bounds__(SCORES_THREADS, 1)
scores_kernel(const T* __restrict__ q, const T* __restrict__ k, const int* __restrict__ lengths,
              float* __restrict__ s, int Hkv, int G, int S, int Dl, float scale, int ntiles,
              int per_block) {
  constexpr int VN = Piece<T>::N;
  constexpr int NPASS = WIDE ? wide_passes(PB, MG) : 1;
  constexpr int R = WIDE ? NPASS : ROWS_A_THREAD;   // rows a lane holds
  const int tile = scores_tile(G, Dl, (int)sizeof(T), VEC);
  const int tiles_per_bh = (S + tile - 1) / tile;
  const int QP = ru4(Dl);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int rho = lane / LANES_A_ROW, sigma = lane % LANES_A_ROW;   // WIDE: row, piece
  const int t_begin = blockIdx.x * per_block, t_end = min(t_begin + per_block, ntiles);
  if (t_begin >= t_end) return;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);   // [G][QP]
  unsigned char* ring = reinterpret_cast<unsigned char*>(sq + G * QP);
  const int stage_bytes = ru16(tile * Dl * (int)sizeof(T)) + 16;
  const bool vec_out = (S & 3) == 0 && (reinterpret_cast<uintptr_t>(s) & 15) == 0;
  const int P = Dl * (int)sizeof(T) / 16;       // pieces of a row (VEC)
  // the position of this lane's row r of the tile at p0 (WIDE: warp w
  // takes rows [w, w+1) * ROWS_A_PASS * NPASS of the tile, ROWS_A_PASS a pass)
  auto row_of = [&](int p0, int r) {
    return WIDE ? p0 + (w * NPASS + r) * ROWS_A_PASS + rho : p0 + ROWS_A_THREAD * tid + r;
  };

  uint4 kp[R][WIDE ? PB : 1];
  // tile i's loads, its lane of `length`: this lane's pieces of its rows,
  // or the ring's run of the tile's live rows (a group committed either way)
  auto issue = [&](int i, int stage, int length) {
    const int bh = i / tiles_per_bh, p0 = (i - bh * tiles_per_bh) * tile;
    if (VEC) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int pos = row_of(p0, r);
        if (pos < length) {
          const uint4* kr = reinterpret_cast<const uint4*>(k + ((size_t)bh * S + pos) * Dl);
#pragma unroll
          for (int u = 0; u < (WIDE ? PB : 1); ++u)
            if (!WIDE || sigma + LANES_A_ROW * u < P)
              kp[r][u] = __ldg(kr + (WIDE ? sigma + LANES_A_ROW * u : 0));
        }
      }
    } else {
      const int n = min(tile, length - p0);
      if (n > 0) copy_run(ring + stage * stage_bytes, k + ((size_t)bh * S + p0) * Dl,
                          n * Dl * (int)sizeof(T), tid, SCORES_THREADS);
      cp_async_commit();
    }
  };

  // the lane's length is read once for each (sequence, KV head) of the run
  int cur_bh = t_begin / tiles_per_bh, q_bh = -1;
  int length = lane_length(lengths, cur_bh, Hkv, S);
  issue(t_begin, 0, length);
  for (int i = t_begin; i < t_end; ++i) {
    const int stage = (i - t_begin) & 1;
    const int bh = i / tiles_per_bh, p0 = (i - bh * tiles_per_bh) * tile;
    if (bh != cur_bh) {
      cur_bh = bh;
      length = lane_length(lengths, bh, Hkv, S);
    }
    const int nbh = (i + 1) / tiles_per_bh;
    const int next_length = i + 1 >= t_end ? 0
                            : nbh == bh ? length : lane_length(lengths, nbh, Hkv, S);
    const bool live_tile = p0 < length;   // block-uniform
    float acc[R][MG];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < MG; ++g) acc[r][g] = 0.f;
    if (live_tile) {
      if (q_bh != bh) {
        if (VEC) __syncthreads();   // every thread is done with the last q
        for (int j = tid; j < G * QP; j += SCORES_THREADS) {
          const int g = j / QP, d = j - g * QP;
          sq[j] = d < Dl ? to_f(q[((size_t)bh * G + g) * Dl + d]) : 0.f;
        }
        q_bh = bh;
        if (VEC) __syncthreads();
      }
      if (!VEC) {
        cp_async_wait<0>();
        __syncthreads();   // q and the ring's run
      }
      if (VEC) {
        // piece c of each live row against the group's q piece c
#pragma unroll
        for (int u = 0; u < (WIDE ? PB : 1); ++u) {
          const int c = WIDE ? sigma + LANES_A_ROW * u : 0;
          if (c < P) {
            float kf[R][VN];
#pragma unroll
            for (int r = 0; r < R; ++r) Piece<T>::unpack(kp[r][u], kf[r]);
#pragma unroll
            for (int g = 0; g < MG; ++g) {
              if (g < G) {
                const float4* qv = reinterpret_cast<const float4*>(sq + g * QP + c * VN);
#pragma unroll
                for (int e = 0; e < VN / 4; ++e) {
                  const float4 x = qv[e];
#pragma unroll
                  for (int r = 0; r < R; ++r)
                    acc[r][g] += x.x * kf[r][4 * e] + x.y * kf[r][4 * e + 1] +
                                 x.z * kf[r][4 * e + 2] + x.w * kf[r][4 * e + 3];
                }
              }
            }
          }
        }
        if (WIDE) {   // the row's LANES_A_ROW lanes sum their pieces
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int g = 0; g < MG; ++g)
#pragma unroll
              for (int o = 1; o < LANES_A_ROW; o <<= 1)
                acc[r][g] += __shfl_xor_sync(FULL, acc[r][g], o);
        }
      } else if (ROWS_A_THREAD * tid < tile) {
        const T* row = reinterpret_cast<const T*>(
                           ring + stage * stage_bytes +
                           run_offset(k + ((size_t)bh * S + p0) * Dl)) +
                       (size_t)ROWS_A_THREAD * tid * Dl;
        for (int d0 = 0; d0 < Dl; d0 += 4) {
          float kf[R][4];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) kf[r][e] = d0 + e < Dl ? to_f(row[r * Dl + d0 + e]) : 0.f;
#pragma unroll
          for (int g = 0; g < MG; ++g) {
            if (g < G) {
              const float4 x = *reinterpret_cast<const float4*>(sq + g * QP + d0);
#pragma unroll
              for (int r = 0; r < R; ++r)
                acc[r][g] += x.x * kf[r][0] + x.y * kf[r][1] + x.z * kf[r][2] + x.w * kf[r][3];
            }
          }
        }
      }
      if (!VEC) __syncthreads();   // the ring's stage is read
    }
    if (i + 1 < t_end) issue(i + 1, stage ^ 1, next_length);   // in flight while this is stored

    // the scores, 0 at or past the length: a float4 of each head where a
    // thread holds 4 consecutive rows; one row's heads over its lanes where
    // lanes share a row
    const int n = min(tile, S - p0);
    if (WIDE) {   // lane l takes the warp's rows l, l + 32, ...: a shuffle a pass and head
#pragma unroll
      for (int h0 = 0; h0 < NPASS * ROWS_A_PASS; h0 += 32) {
        const int row = h0 + lane, pos = p0 + w * NPASS * ROWS_A_PASS + row;
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          if (g < G) {
            float x = 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float t = __shfl_sync(FULL, acc[r][g], LANES_A_ROW * (lane % ROWS_A_PASS));
              if (row / ROWS_A_PASS == r) x = t;
            }
            if (row < NPASS * ROWS_A_PASS && pos - p0 < n)
              s[((size_t)bh * G + g) * S + pos] = pos < length ? x * scale : 0.f;
          }
        }
      }
    } else if (ROWS_A_THREAD * tid < n) {
      const int pos = row_of(p0, 0);
      float* out = s + (size_t)bh * G * S + pos;
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          float o[R];
#pragma unroll
          for (int r = 0; r < R; ++r) o[r] = pos + r < length ? acc[r][g] * scale : 0.f;
          if (vec_out) {   // S % 4 == 0: the thread's 4 positions are all below S
            *reinterpret_cast<float4*>(out + (size_t)g * S) = make_float4(o[0], o[1], o[2], o[3]);
          } else {
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (pos + r < S) out[(size_t)g * S + r] = o[r];
          }
        }
      }
    }
  }
}

template <typename T, int MG, bool VEC, bool WIDE, int PB>
cudaError_t scores(const void* q, const void* k, const int* lengths, float* out, int Hkv, int G,
                   int S, int Dl, float scale, int ntiles, int per_block, int blocks, int smem,
                   cudaStream_t stream) {
  static bool opted = false;
  const cudaError_t e = allow_smem(scores_kernel<T, MG, VEC, WIDE, PB>, &opted);
  if (e != cudaSuccess) return e;
  scores_kernel<T, MG, VEC, WIDE, PB><<<blocks, SCORES_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), lengths, out, Hkv, G, S, Dl, scale,
      ntiles, per_block);
  return cudaGetLastError();
}

template <typename T, int MG>
cudaError_t scores_by_row(const void* q, const void* k, const int* lengths, float* out, int Hkv,
                          int G, int S, int Dl, float scale, int ntiles, int per_block,
                          int blocks, int smem, bool vec, cudaStream_t stream) {
  const int P = Dl * (int)sizeof(T) / 16;
  auto f = !vec ? scores<T, MG, false, false, 1>
         : P == 1 ? scores<T, MG, true, false, 1>
         : wide_pieces(P) == 1 ? scores<T, MG, true, true, 1>
         : wide_pieces(P) == 2 ? scores<T, MG, true, true, 2>
         : wide_pieces(P) == 4 ? scores<T, MG, true, true, 4> : scores<T, MG, true, true, 8>;
  return f(q, k, lengths, out, Hkv, G, S, Dl, scale, ntiles, per_block, blocks, smem, stream);
}

template <typename T>
cudaError_t scores_by_group(const void* q, const void* k, const int* lengths, float* out,
                            int Hkv, int G, int S, int Dl, float scale, int ntiles,
                            int per_block, int blocks, int smem, bool vec, cudaStream_t stream) {
  const int mg = group_bound(G);
  auto f = mg == 2 ? scores_by_row<T, 2> : mg == 4 ? scores_by_row<T, 4>
         : mg == 8 ? scores_by_row<T, 8> : scores_by_row<T, 16>;
  return f(q, k, lengths, out, Hkv, G, S, Dl, scale, ntiles, per_block, blocks, smem, vec,
           stream);
}

}  // namespace

// decode_scores' arguments, packed by the wrapper as 14 little-endian
// 8-byte fields (struct "<10qd3q", a null pointer as 0).  dtype: 0 =
// float32, 1 = bfloat16.  q (B, Hkv*G, Dl), k (B, Hkv, S, Dl), lengths (B,)
// int32, out (B, Hkv*G, S) float32, all contiguous.  The plan
// (kernels/decode_split.py::scores_plan): `blocks` blocks, each walking
// `per_block` tiles of the B*Hkv*ceil(S/tile) in order, the tile
// decode_scores_tile's.  The path (rows as whole 16-byte pieces in
// registers, or through the ring) and the shared memory are the
// launcher's own.
struct ScoresArgs {
  const void* q;
  const void* k;
  const int* lengths;
  float* out;
  long long B, Hkv, G, S, Dl, dtype;
  double scale;
  long long blocks, per_block;
  cudaStream_t stream;
};
static_assert(sizeof(ScoresArgs) == 14 * 8, "ScoresArgs must match the wrapper's \"<10qd3q\"");

// The positions of a tile for a group G, a slice of Dl columns, dtype (0
// float32, 1 bfloat16) and the K cache at k: what the plan cuts S into.
extern "C" int decode_scores_tile(long long G, long long Dl, long long dtype, const void* k) {
  if (G < 1 || G > MAX_G || Dl < 1 || Dl > MAX_DL || (dtype != 0 && dtype != 1)) return 0;
  return scores_tile((int)G, (int)Dl, dtype == 0 ? 4 : 2, scores_vec(Dl, dtype, k));
}

extern "C" int decode_scores_launch(const ScoresArgs* a) {
  if (!shape_ok(a->B, a->Hkv, a->G, a->S, a->Dl) || (a->dtype != 0 && a->dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int elt = a->dtype == 0 ? 4 : 2, Dl = (int)a->Dl, G = (int)a->G;
  const bool vec = scores_vec(a->Dl, a->dtype, a->k);
  const int tile = scores_tile(G, Dl, elt, vec);
  const long long ntiles = a->B * a->Hkv * ((a->S + tile - 1) / tile);
  if (a->blocks < 1 || a->per_block < 1 || ntiles > 0x7fffffffLL ||
      a->blocks > 0x7fffffffLL / a->per_block || a->blocks * a->per_block < ntiles ||
      (a->blocks - 1) * a->per_block >= ntiles)
    return (int)cudaErrorInvalidValue;
  auto f = a->dtype == 0 ? scores_by_group<float> : scores_by_group<__nv_bfloat16>;
  return (int)f(a->q, a->k, a->lengths, a->out, (int)a->Hkv, G, (int)a->S, Dl, (float)a->scale,
                (int)ntiles, (int)a->per_block, (int)a->blocks, scores_smem_bytes(G, Dl, elt, vec),
                vec, a->stream);
}

extern "C" const char* decode_scores_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
