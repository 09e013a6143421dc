// Blocked online-softmax GQA attention (FlashAttention-2 forward): the
// full-sequence attention of every forward, prefill and loss evaluation.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel).  For sequence b and query head h
// (KV head h / G, G = Hq / Hkv, any integer): scores q.k * scale in f32
// (the scale multiplies the f32 scores, as the TPU kernel does), online
// softmax with a running (m, l, acc) in f32, out = acc / l with the
// l == 0 -> 1 guard, cast to the input type.  The queries are the last Sq
// positions of the Skv context (seq_off = Skv - Sq); causal masking keeps
// key j for query i when j <= i + seq_off, with the finite -1e30 mask of
// the reference, and key tiles past a query tile's last visible key are
// never visited (the TPU kernel's skipped upper-triangle blocks).  Sq and
// Skv may be any length: the ragged tails of both are masked here, where
// the TPU kernel asserted block multiples.
//
// The TPU carried (m, l, acc) in VMEM scratch across a sequential grid
// over key blocks.  Here one block of 128 threads owns one (sequence,
// query head, 64-query tile) and walks the key tiles in a loop, so the
// running state stays in registers: each warp owns 16 query rows.  GQA is
// index math only: the block reads its KV head's rows, never a repeated
// copy.  Two bodies:
//
//  * float32 (flash_fwd_kernel): f32 on the CUDA cores, full f32 with no
//    TF32, so it matches the plain version to float tolerance.  A lane
//    owns 4 rows x BK/8 score columns and 4 rows x D/8 output dims (lane =
//    8 * ry + rx; row reductions are 3 xor shuffles over rx); Q, the K and
//    V tiles and the warp's P tile are staged in shared memory as f32 with
//    row pitches D + 1 and BK + 1, so a warp's loads hit distinct banks.
//  * bfloat16 (flash_fwd_mma_kernel): both products on the tensor cores
//    with mma.sync m16n8k16 (bf16 in, f32 accumulate).  The warp's Q
//    fragments stay in registers for the whole walk; the S = Q K^T
//    accumulators are laid out as the A fragments of P V, so P goes from
//    the softmax to the second product without shared memory (P is
//    rounded to bf16 there, as the reference's chunked twin does).  K is
//    staged as [key][D + 8] and V transposed as [d][BK + 8] in bf16, so
//    every fragment is one 32-bit shared load on distinct banks.
//
// Bound on this card: operations (4 * D flops per visible (query, key)
// pair against 2 * D * elt bytes per key row; at qwen3 prefill S = 4096
// the bytes take 0.015 ms and the work 68.7 GFLOP, 0.069 ms at the bf16
// tensor-core peak).  mma.sync without a copy pipeline is the simple
// design of this version; wgmma with TMA-fed, double-buffered tiles and
// a split-KV schedule for short query tiles over long contexts are the
// steps toward that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int WARPS = 4;      // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -1e30f;  // the finite mask value of the reference
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
// rows x D floats from global memory (row-major, pitch D) into a shared
// tile of pitch `ld`; rows in [n_valid, rows) are zero-filled (so a masked
// position never multiplies a stale or NaN value).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int n_valid, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] = r < n_valid ? src[(size_t)r * D + d] : 0.f;
  }
}

template <int D, int BK>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + WARPS * 16 * (BK + 1);
}

template <int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Hq, int Hkv, int Sq, int Skv, int causal,
                 float scale, int n_qt) {
  constexpr int NC = BK / 8;   // score columns per lane
  constexpr int ND = D / 8;    // output dims per lane
  constexpr int QLD = D + 1, KLD = D + 1, PLD = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QLD;
  float* Vs = Ks + BK * KLD;
  float* Ps = Vs + BK * D;

  const int bh = blockIdx.x;                 // sequence * Hq + query head
  const int qt = n_qt - 1 - blockIdx.y;      // the longest causal tiles start first
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);  // the query head's KV head
  const int q0 = qt * BQ;
  const int seq_off = Skv - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ry = lane >> 3, rx = lane & 7;
  const int row0 = warp * 16 + ry * 4;       // the lane's first row in the tile

  const float* kb = k + (size_t)bkv * Skv * D;
  const float* vb = v + (size_t)bkv * Skv * D;
  const int q_rows = min(BQ, Sq - q0);
  load_tile<D>(Qs, QLD, q + ((size_t)bh * Sq + q0) * D, q_rows, BQ);
  // keys at or past k_end are masked for every row of this tile
  const int k_end = causal ? min(Skv, q0 + q_rows + seq_off) : Skv;

  float m[4], l[4], acc[4][ND];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
    qpos[i] = q0 + row0 + i + seq_off;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }
  float* Pw = Ps + warp * 16 * PLD;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    const int k_rows = min(BK, Skv - k0);
    __syncthreads();  // every warp is done with the previous K, V and P tiles
    load_tile<D>(Ks, KLD, kb + (size_t)k0 * D, k_rows, BK);
    load_tile<D>(Vs, D, vb + (size_t)k0 * D, k_rows, BK);
    __syncthreads();

    float s[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(row0 + i) * QLD + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) kv[j] = Ks[(rx + 8 * j) * KLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int kp = k0 + rx + 8 * j;
        const bool ok = kp < k_end && (!causal || kp <= qpos[i]);
        s[i][j] = ok ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = s[i][j] == NEG ? 0.f : expf(s[i][j] - m_new);
        rs += p;
        Pw[(ry * 4 + i) * PLD + rx + 8 * j] = p;
      }
      rs += __shfl_xor_sync(FULL, rs, 1);
      rs += __shfl_xor_sync(FULL, rs, 2);
      rs += __shfl_xor_sync(FULL, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();

    const int kn = min(BK, k_end - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Pw[(ry * 4 + i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const float vv = Vs[kk * D + rx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + row0 + i;
    if (row >= Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* o = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c) o[rx + 8 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------
constexpr int MMA_BK = 64;  // keys per tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
constexpr int mma_smem_bytes() {
  return (BQ * (D + 8) + MMA_BK * (D + 8) + D * (MMA_BK + 8)) * 2;
}

// rows x D bf16 from global memory into shared rows of pitch `ld`, 16-byte
// vectors; rows in [n_valid, rows) are zero-filled.  With `transpose` the
// tile lands as [d][row] (pitch `ld` over rows), and neighbouring threads
// take neighbouring rows, so a warp's 2-byte stores fill 16 consecutive
// words of one d row instead of landing on one bank.
template <int D, bool transpose>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, int ld,
                                               const __nv_bfloat16* __restrict__ src,
                                               int n_valid, int rows) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
    const int r = transpose ? i % rows : i / VPR;
    const int c = (transpose ? i / rows : i % VPR) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < n_valid) x = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * D + c));
    if (transpose) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(c + j) * ld + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     int Hq, int Hkv, int Sq, int Skv, int causal, float scale, int n_qt) {
  constexpr int BK = MMA_BK;
  constexpr int QP = D + 8, KP = D + 8, VP = BK + 8;  // shared pitches (bf16)
  constexpr int KD = D / 16;   // k-steps of S = Q K^T
  constexpr int NT = BK / 8;   // 8-key column tiles of S
  constexpr int DT = D / 8;    // 8-dim column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * QP;
  __nv_bfloat16* Vt = Ks + BK * KP;

  const int bh = blockIdx.x;
  const int qt = n_qt - 1 - blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int seq_off = Skv - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group and thread-in-group
  const __nv_bfloat16* kb = k + (size_t)bkv * Skv * D;
  const __nv_bfloat16* vb = v + (size_t)bkv * Skv * D;
  const int q_rows = min(BQ, Sq - q0);
  load_tile_bf16<D, false>(Qs, QP, q + ((size_t)bh * Sq + q0) * D, q_rows, BQ);
  const int k_end = causal ? min(Skv, q0 + q_rows + seq_off) : Skv;
  __syncthreads();

  // the warp's 16 query rows as A fragments, kept for the whole walk
  uint32_t qf[KD][4];
  const __nv_bfloat16* qw = Qs + (warp * 16) * QP;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    qf[kd][0] = ld_u32(qw + g * QP + kd * 16 + 2 * t);
    qf[kd][1] = ld_u32(qw + (g + 8) * QP + kd * 16 + 2 * t);
    qf[kd][2] = ld_u32(qw + g * QP + kd * 16 + 8 + 2 * t);
    qf[kd][3] = ld_u32(qw + (g + 8) * QP + kd * 16 + 8 + 2 * t);
  }
  // this thread's two rows: g and g + 8 of the warp's 16
  int qpos[2];
  qpos[0] = q0 + warp * 16 + g + seq_off;
  qpos[1] = qpos[0] + 8;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    const int k_rows = min(BK, Skv - k0);
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_tile_bf16<D, false>(Ks, KP, kb + (size_t)k0 * D, k_rows, BK);
    load_tile_bf16<D, true>(Vt, VP, vb + (size_t)k0 * D, k_rows, BK);
    __syncthreads();

    // S = Q K^T: s[nt] holds (row g, keys 8nt + 2t, +1) and (row g + 8, same keys)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * KP + kd * 16 + 2 * t;
        mma_bf16(s[nt], qf[kd], ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // online softmax over the tile, two rows per thread (4 lanes per row)
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = key < k_end && (!causal || key <= qpos[e >> 1]);
        s[nt][e] = ok ? s[nt][e] * scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] == NEG ? 0.f : expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p;  // this thread's share of the row sum
        s[nt][e] = p;
      }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: the S accumulators of key tiles 2j, 2j + 1 are the A
    // fragment of k-step j; V^T rows give the B fragments
    const int kn = min(BK, k_end - k0);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      if (j * 16 >= kn) break;
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vp = Vt + (dt * 8 + g) * VP + j * 16 + 2 * t;
        mma_bf16(o[dt], pa, ld_u32(vp), ld_u32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(o[dt][2 * r] / denom, o[dt][2 * r + 1] / denom);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
               int Sq, int Skv, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  auto kernel = flash_fwd_mma_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const dim3 grid(B * Hq, n_qt);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq, Skv,
      causal, scale, n_qt);
  return 0;
}

template <int D, int BK>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
               int Sq, int Skv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D, BK>() * sizeof(float);
  auto kernel = flash_fwd_kernel<D, BK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const dim3 grid(B * Hq, n_qt);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Hq, Hkv, Sq, Skv, causal, scale, n_qt);
  return 0;
}

int by_dim_f32(int D, const void* q, const void* k, const void* v, void* out, int B, int Hq,
               int Hkv, int Sq, int Skv, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_f32<16, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 32: return launch_f32<32, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 64: return launch_f32<64, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 128: return launch_f32<128, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int by_dim_bf16(int D, const void* q, const void* k, const void* v, void* out, int B, int Hq,
                int Hkv, int Sq, int Skv, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 32: return launch_mma<32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 64: return launch_mma<64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 128: return launch_mma<128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D),
// out like q, all contiguous; Hq % Hkv == 0, 0 < Sq <= Skv, ceil(Sq / 64) <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                      int dtype, int causal, float scale,
                                      cudaStream_t stream) {
  if (B > 0 && Hq > 0 && Sq > 0) {
    const int rc = dtype == 0
        ? by_dim_f32(D, q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, scale, stream)
        : dtype == 1
        ? by_dim_bf16(D, q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, scale, stream)
        : (int)cudaErrorInvalidValue;
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
