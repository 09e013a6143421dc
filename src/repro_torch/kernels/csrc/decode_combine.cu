// decode_combine: the rest of decode attention over one head_dim slice of
// V, scores (B, Hq, S) f32 and V (B, Hkv, S, Dl) -> (B, Hq, Dl); its design,
// and decode_scores', in decode_split.cuh, which both sources share (each
// is built into a library of its own, so the two compile side by side).
#include "decode_split.cuh"

namespace {

// ---------------------------------------------------------------------------
// decode_combine
// ---------------------------------------------------------------------------
// A warp's ring stage: the chunk's V run, then G score runs.
__host__ __device__ constexpr int combine_v_bytes(int Dl, int elt) {
  return ru16(CHUNK * Dl * elt) + 16;
}
__host__ __device__ constexpr int combine_stage_bytes(int G, int Dl, int elt) {
  return combine_v_bytes(Dl, elt) + G * (CHUNK * 4 + 16);
}
// the p buffer's pitch in floats: the instance's bound on the group (a
// whole number of float4s), which the kernel's stores of p span
__host__ __device__ constexpr int combine_pitch(int G) {
  return group_bound(G) < 4 ? 4 : group_bound(G);
}
// rows of a warp whose lanes share a chunk (32 / Dl of Dl columns each
// for Dl <= 32), one otherwise
__host__ __device__ constexpr int combine_rows(int Dl) { return Dl <= 32 ? 32 / Dl : 1; }
// Where lanes take whole rows: a V row is 1, 2, 4, ... 32 whole 16-byte
// pieces (Dl 8, 16, 32, 64, 128 in bf16; 4 .. 128 in f32) on a 16-byte
// aligned cache, and the group is at most ROW_MAX_G (a lane's G x 16
// columns of sums stay in registers).
__host__ __device__ constexpr bool combine_by_rows(int G, int Dl, int elt, bool v_aligned) {
  return (Dl * elt) % 16 == 0 && ((Dl * elt / 16) & (Dl * elt / 16 - 1)) == 0 &&
         G <= ROW_MAX_G && v_aligned;
}
// Shared memory, three uses in turn: the warps' rings and p buffers
// (CHUNK x pitch f32 a warp; none where lanes take rows); the warps'
// partials for the block's merge; the split merge's factors (2 x
// MAX_BLOCKS x G) and G maxima and sums.
__host__ __device__ constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
__host__ __device__ constexpr int combine_smem_bytes(int G, int Dl, int elt, bool rows) {
  return max3(rows ? 0
                   : COMBINE_WARPS * (STAGES * combine_stage_bytes(G, Dl, elt) +
                                      CHUNK * combine_pitch(G) * 4),
              4 * COMBINE_WARPS * G * ((rows ? 1 : combine_rows(Dl)) * Dl + 2),
              4 * G * (2 * MAX_BLOCKS + 2));
}
// every group and slice the launcher takes fits what a block may opt into
constexpr bool combine_smem_fits() {
  for (int G = 1; G <= MAX_G; ++G)
    for (int Dl = 1; Dl <= MAX_DL; ++Dl)
      for (int elt = 2; elt <= 4; elt += 2)
        if (combine_smem_bytes(G, Dl, elt, false) > SMEM_OPTIN ||
            combine_smem_bytes(G, Dl, elt, true) > SMEM_OPTIN)
          return false;
  return true;
}
static_assert(combine_smem_fits(), "decode_combine's shared memory exceeds SMEM_OPTIN");

// Where lanes take whole rows: Q lanes a row, each with PPL of its pieces
// (pieces sigma, sigma + Q, ...: a warp's load is 32 / Q rows' runs of Q
// pieces), 4 rows a lane a chunk (rows t, t + 32/Q, t + 2*32/Q, t +
// 3*32/Q); its loads of a chunk: the rows' pieces and their scores of each
// head, nothing at or past hi (NEG there).
template <typename T, int MG, int Q, int PPL>
__device__ __forceinline__ void row_load(uint4 (&vr)[4][PPL], float (&sc)[MG][4], const T* vb,
                                         const float* srow, int S, int G, int P, int t, int hi,
                                         int sigma) {
  constexpr int RI = 32 / Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4* row = reinterpret_cast<const uint4*>(vb) + (size_t)(t + RI * i) * P + sigma;
#pragma unroll
    for (int j = 0; j < PPL; ++j)
      vr[i][j] = t + RI * i < hi ? __ldg(row + Q * j) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int g = 0; g < MG; ++g)
    if (g < G)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sc[g][i] = t + RI * i < hi ? __ldg(srow + (size_t)g * S + t + RI * i) : NEG;
}

// ... and the lane's online softmax over its 4 rows (its own running max):
// the p of every head first, then each row's pieces once for all heads
template <typename T, int MG, int Q, int PPL>
__device__ __forceinline__ void row_step(const uint4 (&vr)[4][PPL], const float (&sc)[MG][4],
                                         float (&acc)[MG][PPL * Piece<T>::N], float (&m)[MG],
                                         float (&l)[MG], int G, int t, int hi) {
  constexpr int VN = Piece<T>::N;
  constexpr int RI = 32 / Q;
  float p[MG][4];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g < G) {
      const float mn = fmaxf(m[g], fmaxf(fmaxf(sc[g][0], sc[g][1]), fmaxf(sc[g][2], sc[g][3])));
      const float alpha = __expf(m[g] - mn);
#pragma unroll
      for (int i = 0; i < 4; ++i) p[g][i] = t + RI * i < hi ? __expf(sc[g][i] - mn) : 0.f;
      m[g] = mn;
      l[g] = l[g] * alpha + ((p[g][0] + p[g][1]) + (p[g][2] + p[g][3]));
#pragma unroll
      for (int e = 0; e < PPL * VN; ++e) acc[g][e] *= alpha;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      float vf[VN];
      Piece<T>::unpack(vr[i][j], vf);
#pragma unroll
      for (int g = 0; g < MG; ++g)
        if (g < G)
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[g][j * VN + e] += p[g][i] * vf[e];
    }
  }
}

// The span of block blk of nblk over a lane of `length` live positions: the
// live positions cut into runs of whole chunks, at most nblk of them and
// each of at least span_min positions (a long lane takes more blocks than
// a short one); `live` blocks get one.
struct Span {
  int lo, hi, live;
};
__device__ __forceinline__ Span combine_span(int length, int nblk, int blk, int span_min) {
  if (length <= 0) return {0, 0, 0};
  const int span = (max((length + nblk - 1) / nblk, span_min) + CHUNK - 1) / CHUNK * CHUNK;
  const int lo = blk * span;
  return {lo, min(lo + span, length), (length + span - 1) / span};
}

// MG: a bound on the group (G <= MG); NC: a bound on the columns a lane
// holds (1 for Dl <= 32, else ceil(Dl / 32)); Q > 0: lanes take whole rows
// (combine_by_rows), Q lanes a row, PPL pieces a lane.
template <typename T, int MG, int NC, int Q, int PPL>
__global__ void __launch_bounds__(COMBINE_WARPS * 32, 1)
combine_kernel(const float* __restrict__ s, const T* __restrict__ v,
               const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ part,
               unsigned* __restrict__ tickets, int Hkv, int G, int S, int Dl, int span_min) {
  constexpr int W = COMBINE_WARPS;
  constexpr int NT = W * 32;
  constexpr int PP = combine_pitch(MG);   // p buffer pitch, in floats (MG's = G's)
  constexpr int ST = STAGES;
  const int bh = blockIdx.x;
  const int blk = blockIdx.y, nblk = gridDim.y;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int length = lane_length(lengths, bh, Hkv, S);
  const Span sp = combine_span(length, nblk, blk, span_min);
  T* o = out + (size_t)bh * G * Dl;
  if (blk >= sp.live) {   // no live position: only an empty lane's block 0 writes
    if (length == 0 && blk == 0)
      for (int i = tid; i < G * Dl; i += NT) o[i] = from_f<T>(0.f);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int elt = (int)sizeof(T);
  const int stage_bytes = combine_stage_bytes(G, Dl, elt);
  const int vbytes = combine_v_bytes(Dl, elt);
  unsigned char* ring = smem + w * (ST * stage_bytes + CHUNK * PP * 4);
  float* pbuf = reinterpret_cast<float*>(ring + ST * stage_bytes);   // [CHUNK][PP]
  const float* srow = s + (size_t)bh * G * S;
  const T* vb = v + (size_t)bh * S * Dl;
  // the warps' partials for the block's merge: (max, sum, acc by row and column)
  constexpr bool ROW = Q > 0;
  const int RW = ROW ? 1 : combine_rows(Dl);
  float* wacc = reinterpret_cast<float*>(smem);            // [W][RW][G][Dl]
  float* wm = wacc + W * RW * G * Dl;           // [W][G]
  float* wl = wm + W * G;                       // [W][G]

  if constexpr (ROW) {
    // lanes (row rho, pieces sigma + Q*j) take 4 rows each of every chunk of
    // 128 / Q positions into registers (the next chunk's loads in flight
    // while they sum this one); the lanes that hold the same columns merge
    // by shuffles once, at the end
    constexpr int VN = Piece<T>::N;
    constexpr int RC = 4 * 32 / Q;   // positions of a chunk
    const int P = Dl * elt / 16, rho = lane / Q, sigma = lane % Q;
    float acc[MG][PPL * VN], m[MG], l[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      m[g] = NEG;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < PPL * VN; ++e) acc[g][e] = 0.f;
    }
    const int nch = (sp.hi - sp.lo + RC - 1) / RC;
    uint4 va[4][PPL], vn[4][PPL];
    float sa[MG][4], sn[MG][4];
    int c = w;   // chunks c, c + W, ...: two register sets in turn, the next one's loads in flight
    if (c < nch)
      row_load<T, MG, Q, PPL>(va, sa, vb, srow, S, G, P, sp.lo + c * RC + rho, sp.hi, sigma);
    while (c < nch) {
      const int c1 = c + W, c2 = c1 + W;
      if (c1 < nch)
        row_load<T, MG, Q, PPL>(vn, sn, vb, srow, S, G, P, sp.lo + c1 * RC + rho, sp.hi, sigma);
      row_step<T, MG, Q, PPL>(va, sa, acc, m, l, G, sp.lo + c * RC + rho, sp.hi);
      if (c1 >= nch) break;
      if (c2 < nch)
        row_load<T, MG, Q, PPL>(va, sa, vb, srow, S, G, P, sp.lo + c2 * RC + rho, sp.hi, sigma);
      row_step<T, MG, Q, PPL>(vn, sn, acc, m, l, G, sp.lo + c1 * RC + rho, sp.hi);
      c = c2;
    }
    float M[MG], L[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
        M[g] = m[g];
#pragma unroll
        for (int o = Q; o < 32; o <<= 1) M[g] = fmaxf(M[g], __shfl_xor_sync(FULL, M[g], o));
        const float cf = __expf(m[g] - M[g]);
        L[g] = l[g] * cf;
#pragma unroll
        for (int o = Q; o < 32; o <<= 1) L[g] += __shfl_xor_sync(FULL, L[g], o);
#pragma unroll
        for (int e = 0; e < PPL * VN; ++e) {
          acc[g][e] *= cf;
#pragma unroll
          for (int o = Q; o < 32; o <<= 1) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
        }
      }
    }
    if (rho == 0) {   // lane sigma: columns (sigma + Q*j) * VN + e
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
#pragma unroll
          for (int j = 0; j < PPL; ++j)
#pragma unroll
            for (int e = 0; e < VN; ++e)
              wacc[(w * G + g) * Dl + (sigma + Q * j) * VN + e] = acc[g][j * VN + e];
          if (sigma == 0) {
            wm[w * G + g] = M[g];
            wl[w * G + g] = L[g];
          }
        }
      }
    }
  } else {
  const int nch = (sp.hi - sp.lo + CHUNK - 1) / CHUNK;
  const int mine = w < nch ? (nch - 1 - w) / W + 1 : 0;
  // chunk j of this warp's into stage j % ST: the V run by all lanes,
  // then each head's score run (at most 9 pieces) over the lanes
  auto issue = [&](int j) {
    const int t0 = sp.lo + (w + j * W) * CHUNK;
    const int n = min(CHUNK, sp.hi - t0);
    unsigned char* st = ring + (j % ST) * stage_bytes;
    copy_run(st, vb + (size_t)t0 * Dl, n * Dl * elt, lane, 32);
    for (int g = 0; g < G; g += 3)   // three heads a pass: 27 lanes, 9 each
      if (lane < 27 && g + lane / 9 < G)
        copy_run(st + vbytes + (g + lane / 9) * (CHUNK * 4 + 16),
                 srow + (size_t)(g + lane / 9) * S + t0, n * 4, lane % 9, 9);
  };

  // lanes as (row r, column d): rows of the chunk r, r + RW, ...
  const int r = Dl <= 32 ? lane / Dl : 0;
  const int d = Dl <= 32 ? lane - r * Dl : lane;
  const bool active = r < RW;
  float acc[MG][NC], m[MG], l[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c] = 0.f;
  }

#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (j < mine) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < mine; ++j) {
    if (j + ST - 1 < mine) issue(j + ST - 1);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncwarp();
    const int t0 = sp.lo + (w + j * W) * CHUNK;
    const int n = min(CHUNK, sp.hi - t0);
    const unsigned char* st = ring + (j % ST) * stage_bytes;
    // online softmax over the chunk: lane j's position is t0 + lane.  The
    // heads' maxima are reduced together, a shuffle of every head a step
    // (heads past G hold NEG and give p = 0), so that no head's chain of
    // shuffles waits on another's.
    float x[MG], cmax[MG], p[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      const float* sg = reinterpret_cast<const float*>(
          st + vbytes + g * (CHUNK * 4 + 16) + run_offset(srow + (size_t)g * S + t0));
      x[g] = g < G && lane < n ? sg[lane] : NEG;
      cmax[g] = x[g];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < MG; ++g) cmax[g] = fmaxf(cmax[g], __shfl_xor_sync(FULL, cmax[g], o));
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      const float mn = fmaxf(m[g], cmax[g]);
      const float alpha = __expf(m[g] - mn);
      m[g] = mn;
      p[g] = g < G && lane < n ? __expf(x[g] - mn) : 0.f;
      l[g] = l[g] * alpha + p[g];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[g][c] *= alpha;
    }
#pragma unroll
    for (int g = 0; g < PP; g += 4)
      *reinterpret_cast<float4*>(pbuf + lane * PP + g) =
          make_float4(g < MG ? p[g] : 0.f, g + 1 < MG ? p[g + 1] : 0.f,
                      g + 2 < MG ? p[g + 2] : 0.f, g + 3 < MG ? p[g + 3] : 0.f);
    __syncwarp();
    if (active) {
      const T* vr = reinterpret_cast<const T*>(st + run_offset(vb + (size_t)t0 * Dl));
      for (int t = r; t < n; t += RW) {
        float x[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) x[c] = d + 32 * c < Dl ? to_f(vr[t * Dl + d + 32 * c]) : 0.f;
#pragma unroll
        for (int g = 0; g < MG; g += 4) {
          const float4 pv = *reinterpret_cast<const float4*>(pbuf + t * PP + g);
          const float pg[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (g + e < MG)
#pragma unroll
              for (int c = 0; c < NC; ++c) acc[g + e][c] += pg[e] * x[c];
        }
      }
    }
    __syncwarp();   // the stage and pbuf are free for the next issue
  }
  cp_async_wait<0>();

  float lsum[MG];   // every head's sum reduced together, as the maxima are
#pragma unroll
  for (int g = 0; g < MG; ++g) lsum[g] = l[g];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int g = 0; g < MG; ++g) lsum[g] += __shfl_xor_sync(FULL, lsum[g], o);
  __syncthreads();   // every warp is done with its ring
  if (active) {
#pragma unroll
    for (int g = 0; g < MG; ++g)
      if (g < G)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (d + 32 * c < Dl) wacc[((w * RW + r) * G + g) * Dl + d + 32 * c] = acc[g][c];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MG; ++g)
      if (g < G) {
        wm[w * G + g] = m[g];
        wl[w * G + g] = lsum[g];
      }
  }
  }   // the warps' rings
  __syncthreads();
  const size_t P = (size_t)G * (Dl + 2);   // floats of one partial in the workspace
  float* mine_part = part + ((size_t)bh * nblk + blk) * P;
  for (int i = tid; i < G * Dl; i += NT) {
    const int g = i / Dl, dd = i - g * Dl;
    float M = NEG;
#pragma unroll
    for (int ww = 0; ww < W; ++ww) M = fmaxf(M, wm[ww * G + g]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int ww = 0; ww < W; ++ww) {
      const float c = expf(wm[ww * G + g] - M);
      float a = 0.f;
      for (int rr = 0; rr < RW; ++rr) a += wacc[((ww * RW + rr) * G + g) * Dl + dd];
      A += a * c;
      L += wl[ww * G + g] * c;
    }
    if (sp.live == 1) {
      o[i] = from_f<T>(A / (L == 0.f ? 1.f : L));
    } else {
      mine_part[i] = A;
      if (dd == 0) {
        mine_part[G * Dl + g] = M;
        mine_part[G * Dl + G + g] = L;
      }
    }
  }
  if (sp.live == 1) return;

  // split: the block that draws the last ticket of this (sequence, KV
  // head) merges the live blocks' partials, in parallel over (head,
  // column), and sets the ticket back to 0
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + bh, 1u) == (unsigned)(sp.live - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* all = part + (size_t)bh * nblk * P;
  const int nb = sp.live;
  float* cm = reinterpret_cast<float*>(smem);   // [nb][G]: m_b, then exp(m_b - M)
  float* cl = cm + MAX_BLOCKS * G;              // [nb][G]: l_b, then l_b exp(m_b - M)
  float* Mg = cl + MAX_BLOCKS * G;              // [G]: the max
  for (int i = tid; i < nb * G; i += NT) {
    const float* pb = all + (size_t)(i / G) * P + G * Dl + i % G;
    cm[i] = __ldcg(pb);
    cl[i] = __ldcg(pb + G);
  }
  __syncthreads();
  for (int g = w; g < G; g += W) {   // a warp a head: the max over the partials
    float M = NEG;
    for (int b = lane; b < nb; b += 32) M = fmaxf(M, cm[b * G + g]);
    M = warp_max(M);
    if (lane == 0) Mg[g] = M;
  }
  __syncthreads();
  for (int i = tid; i < nb * G; i += NT) {
    const float c = expf(cm[i] - Mg[i % G]);
    cm[i] = c;
    cl[i] *= c;
  }
  __syncthreads();
  float* Lg = Mg + G;                  // [G]: the sum
  for (int g = w; g < G; g += W) {
    float L = 0.f;
    for (int b = lane; b < nb; b += 32) L += cl[b * G + g];
    L = warp_sum(L);
    if (lane == 0) Lg[g] = L == 0.f ? 1.f : L;
  }
  __syncthreads();
  // a thread a (head, column), its partials' loads issued before use
  for (int i = tid; i < G * Dl; i += NT) {
    const int g = i / Dl;
    float A = 0.f;
#pragma unroll 8
    for (int b = 0; b < nb; ++b) A += __ldcg(all + (size_t)b * P + i) * cm[b * G + g];
    o[i] = from_f<T>(A / Lg[g]);
  }
  if (tid == 0) tickets[bh] = 0u;
}

template <typename T, int MG, int NC, int Q, int PPL>
cudaError_t combine(const float* s, const void* v, const int* lengths, void* out, float* part,
                    unsigned* tickets, int B, int Hkv, int G, int S, int Dl, int nblk,
                    int span_min, int smem, cudaStream_t stream) {
  static bool opted = false;
  const cudaError_t e = allow_smem(combine_kernel<T, MG, NC, Q, PPL>, &opted);
  if (e != cudaSuccess) return e;
  combine_kernel<T, MG, NC, Q, PPL>
      <<<dim3(B * Hkv, nblk), COMBINE_WARPS * 32, smem, stream>>>(
      s, static_cast<const T*>(v), lengths, static_cast<T*>(out), part, tickets, Hkv, G, S, Dl,
      span_min);
  return cudaGetLastError();
}

// The row path's lanes a row and pieces a lane for rows of P pieces (P a
// power of two up to 32): PPL = min(P, 2), Q = P / PPL.
template <typename T, int MG>
cudaError_t combine_by_width(const float* s, const void* v, const int* lengths, void* out,
                             float* part, unsigned* tickets, int B, int Hkv, int G, int S, int Dl,
                             int nblk, int span_min, int smem, bool rows, cudaStream_t stream) {
  constexpr bool R = MG <= ROW_MAX_G;   // no row instances past the group bound
  const int P = Dl * (int)sizeof(T) / 16;
  auto f = !rows ? (Dl <= 32 ? combine<T, MG, 1, 0, 1> : Dl <= 64 ? combine<T, MG, 2, 0, 1>
                                                                  : combine<T, MG, 4, 0, 1>)
         : P == 1 ? combine<T, MG, 1, R ? 1 : 0, 1> : P == 2 ? combine<T, MG, 1, R ? 1 : 0, R ? 2 : 1>
         : P == 4 ? combine<T, MG, 1, R ? 2 : 0, R ? 2 : 1>
         : P == 8 ? combine<T, MG, 1, R ? 4 : 0, R ? 2 : 1>
         : P == 16 ? combine<T, MG, 1, R ? 8 : 0, R ? 2 : 1>
                   : combine<T, MG, 1, R ? 16 : 0, R ? 2 : 1>;
  return f(s, v, lengths, out, part, tickets, B, Hkv, G, S, Dl, nblk, span_min, smem, stream);
}

template <typename T>
cudaError_t combine_by_group(const float* s, const void* v, const int* lengths, void* out,
                             float* part, unsigned* tickets, int B, int Hkv, int G, int S, int Dl,
                             int nblk, int span_min, int smem, bool rows, cudaStream_t stream) {
  const int mg = group_bound(G);
  auto f = mg == 2 ? combine_by_width<T, 2> : mg == 4 ? combine_by_width<T, 4>
         : mg == 8 ? combine_by_width<T, 8> : combine_by_width<T, 16>;
  return f(s, v, lengths, out, part, tickets, B, Hkv, G, S, Dl, nblk, span_min, smem, rows,
           stream);
}

}  // namespace

// decode_combine's, as 15 fields ("<15q"): s (B, Hkv*G, S) float32, v (B,
// Hkv, S, Dl), lengths (B,) int32, out (B, Hkv*G, Dl) in v's type.  The
// plan (kernels/decode_split.py::combine_plan): nblk blocks a (sequence,
// KV head), at most MAX_BLOCKS, each taking at least span_min positions (a
// whole number of CHUNKs).  The split path (nblk
// > 1) takes `tickets`, at least B*Hkv counters that are 0 (each launch
// leaves its own at 0), and `part`, room for B*Hkv*nblk partials of
// G*(Dl+2) floats; null otherwise.  The path (whole rows or the warps'
// rings) and the shared memory are the launcher's own.
struct CombineArgs {
  const float* s;
  const void* v;
  const int* lengths;
  void* out;
  unsigned* tickets;
  float* part;
  long long B, Hkv, G, S, Dl, dtype, nblk, span_min;
  cudaStream_t stream;
};
static_assert(sizeof(CombineArgs) == 15 * 8, "CombineArgs must match the wrapper's \"<15q\"");

extern "C" int decode_combine_launch(const CombineArgs* a) {
  if (!shape_ok(a->B, a->Hkv, a->G, a->S, a->Dl) || (a->dtype != 0 && a->dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int elt = a->dtype == 0 ? 4 : 2;
  const bool rows = combine_by_rows((int)a->G, (int)a->Dl, elt,
                                    reinterpret_cast<uintptr_t>(a->v) % 16 == 0);
  if (a->nblk < 1 || a->nblk > MAX_BLOCKS || a->span_min < CHUNK || a->span_min % CHUNK ||
      a->span_min > 0x7fffffffLL ||
      (a->nblk > 1 && (a->tickets == nullptr || a->part == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto f = a->dtype == 0 ? combine_by_group<float> : combine_by_group<__nv_bfloat16>;
  return (int)f(a->s, a->v, a->lengths, a->out, a->part, a->tickets, (int)a->B, (int)a->Hkv,
                (int)a->G, (int)a->S, (int)a->Dl, (int)a->nblk, (int)a->span_min,
                combine_smem_bytes((int)a->G, (int)a->Dl, elt, rows), rows, a->stream);
}

extern "C" const char* decode_combine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
