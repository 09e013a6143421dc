// Float32 products on Hopper's tensor cores at float32 accuracy, shared by
// the float32 bodies of the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): 3xTF32 on mma.sync and on wgmma, and the
// swizzled shared-memory layout of tiles of rows of D floats that TMA writes,
// the fragment loaders read and the wgmma descriptors describe.
//
// TF32 keeps 10 bits of mantissa, about three decimal digits: one TF32
// product would miss the float32 tolerance (3e-5) that the router's CPU
// parity holds.  So every operand x is split into hi = tf32(x) (rounded to
// nearest, cvt.rna) and lo = tf32(x - hi) (x - hi is exact in f32), both
// stored as TF32 bit patterns, and a product a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first, accumulated in
// f32; the a_lo b_lo term left out is ~2^-22 of the product.  This is the
// scheme of CUTLASS's OpMultiplyAddFastF32 (3 tensor-core products for one
// float32 product), so at the H100's 495 TFLOP/s of dense TF32 it gives
// 165e12 full-accuracy FLOP/s against 67e12 on the CUDA cores.
//
// mma.sync.m16n8k8 (tf32): a warp's product of a 16 x 8 A, an 8 x 8 B and a
// 16 x 8 f32 accumulator.  With g = lane / 4 and t = lane % 4:
//   A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B: b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product whose depth runs over the columns of an accumulator (P V, with
// P the softmax of S) takes the accumulator as its A operand: in a k8 slice
// the thread holds columns 2t and 2t + 1 where A wants t and t + 4, so the
// depth index is permuted (A column t <-> column 2t, t + 4 <-> 2t + 1) and
// B's rows are read in the same permuted order (load_b_kmajor): a sum over
// k does not care in which order it meets its terms.
//
// wgmma.m64nNk8 (tf32) takes B, and A when it comes from shared memory,
// K-major only (the PTX ISA allows a transposed operand for 16-bit types
// alone), so it serves the products whose operands are stored with their
// depth along the rows: S = Q K^T and dP = dO V^T.  Its A fragment from
// registers is mma.sync's, warp w of the warpgroup holding rows
// 16 w .. 16 w + 15, and its accumulator of N / 2 floats a thread is the
// N / 8 m16n8 accumulators of its warp in order.  The hi and lo halves it
// reads from shared memory are written there by split_tile, hi over the
// tile TMA filled and lo into a second buffer at the same offsets, so
// both keep the tile's swizzle.
#pragma once

#include "hopper.cuh"

namespace tf32 {

// A tile of R rows of D floats in shared memory: ATOMS column atoms of
// ATOM_E floats (rows of ATOM_B bytes), each R x ATOM_B bytes, swizzled by
// TMA in the mode of its row length (128 B: 32 floats, from D = 32 up; 64 B
// at D = 16).  D = 112 pads the tile to DP = 128 columns, which the tensor
// maps zero-fill.  A row's 16-byte chunk c lies at c ^ (row % 8) (128 B),
// so the fragment loads below (8 rows x 4 columns, or 4 row pairs x 8
// columns) meet 32 distinct banks.
template <int D>
struct Atoms {
  static constexpr int ATOM_E = D < 32 ? D : 32;
  static constexpr int ATOM_B = ATOM_E * 4;                 // 64 or 128
  static constexpr int ATOMS = (D + ATOM_E - 1) / ATOM_E;   // 4 at D = 112 and 128
  static constexpr int DP = ATOMS * ATOM_E;                 // the tile's columns
  static constexpr int SW_MASK = ATOM_B / 16 - 1;           // 16-byte chunks xor-ed by row
  static constexpr int LAYOUT = ATOM_B == 128 ? 1 : 2;      // wgmma descriptors: B128 / B64
};

// Byte offset of element (r, c) of a tile of R rows (the tile on a
// 1024-byte boundary, the period of the swizzle).
template <int D, int R>
__device__ __forceinline__ uint32_t at(int r, int c) {
  using A = Atoms<D>;
  const uint32_t o = r * A::ATOM_B + (c % A::ATOM_E) * 4;
  return (c / A::ATOM_E) * R * A::ATOM_B + (o ^ (((o >> 7) & A::SW_MASK) << 4));
}

template <int D, int R>
__device__ __forceinline__ float ld(const unsigned char* tile, int r, int c) {
  return *reinterpret_cast<const float*>(tile + at<D, R>(r, c));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 bit pattern
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// A[i][k] = tile[row0 + i][k0 + k]: 16 rows by 8 columns of a tile
template <int D, int R>
__device__ __forceinline__ FragA load_a(const unsigned char* tile, int row0, int k0, int g,
                                        int t) {
  FragA f;
  split(ld<D, R>(tile, row0 + g, k0 + t), f.hi[0], f.lo[0]);
  split(ld<D, R>(tile, row0 + g + 8, k0 + t), f.hi[1], f.lo[1]);
  split(ld<D, R>(tile, row0 + g, k0 + t + 4), f.hi[2], f.lo[2]);
  split(ld<D, R>(tile, row0 + g + 8, k0 + t + 4), f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = tile[n0 + n][k0 + k]: the transpose of 8 rows (S = Q K^T's K)
template <int D, int R>
__device__ __forceinline__ FragB load_b_nmajor(const unsigned char* tile, int n0, int k0, int g,
                                               int t) {
  FragB f;
  split(ld<D, R>(tile, n0 + g, k0 + t), f.hi[0], f.lo[0]);
  split(ld<D, R>(tile, n0 + g, k0 + t + 4), f.hi[1], f.lo[1]);
  return f;
}

// B[k][n] = tile[k0 + perm(k)][n0 + n], perm(t) = 2t, perm(t + 4) = 2t + 1:
// 8 rows of a tile as they are (O += P V's V), in the depth order of an
// accumulator taken as A (acc_a)
template <int D, int R>
__device__ __forceinline__ FragB load_b_kmajor(const unsigned char* tile, int k0, int n0, int g,
                                               int t) {
  FragB f;
  split(ld<D, R>(tile, k0 + 2 * t, n0 + g), f.hi[0], f.lo[0]);
  split(ld<D, R>(tile, k0 + 2 * t + 1, n0 + g), f.hi[1], f.lo[1]);
  return f;
}

// An accumulator's 16 x 8 block c (rows g, g + 8; columns 2t, 2t + 1) as
// the A fragment of a k8 step in the permuted depth order
__device__ __forceinline__ FragA acc_a(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = hi/lo tiles[k0 + perm(k)][n0 + n]: load_b_kmajor from tiles
// that split_tile has already split (no conversion here)
template <int D, int R>
__device__ __forceinline__ FragB load_b_kmajor_split(const unsigned char* hi,
                                                     const unsigned char* lo, int k0, int n0,
                                                     int g, int t) {
  FragB f;
  const uint32_t o0 = at<D, R>(k0 + 2 * t, n0 + g), o1 = at<D, R>(k0 + 2 * t + 1, n0 + g);
  f.hi[0] = *reinterpret_cast<const uint32_t*>(hi + o0);
  f.lo[0] = *reinterpret_cast<const uint32_t*>(lo + o0);
  f.hi[1] = *reinterpret_cast<const uint32_t*>(hi + o1);
  f.lo[1] = *reinterpret_cast<const uint32_t*>(lo + o1);
  return f;
}

// `bytes` of floats at `tile` (a multiple of 16 * threads) split in place
// into their TF32 hi, the lo at the same offsets from `lo`; the caller's
// `threads` threads each take every threads-th 16 bytes.  Then
// fence_async makes the writes visible to wgmma (the async proxy) once the
// threads have met at a barrier.
__device__ __forceinline__ void split_tile(unsigned char* tile, unsigned char* lo, int bytes,
                                           int tid, int threads) {
  for (int o = tid * 16; o < bytes; o += threads * 16) {
    const float4 x = *reinterpret_cast<const float4*>(tile + o);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(tile + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The wgmma descriptor of k-step kk (8 columns) of a tile of R rows (or of
// its rows from `row0`, a multiple of 8) in the layout above: the atom's
// rows of ATOM_B bytes, 8 of them a swizzle period (SBO), the step 32 bytes
// into the row.
template <int D, int R>
__device__ __forceinline__ uint64_t desc(uint32_t tile, int kk, int row0 = 0) {
  using A = Atoms<D>;
  const int a = kk * 8 / A::ATOM_E, c = (kk * 8 % A::ATOM_E) * 4;
  return hopper::make_desc(tile + a * R * A::ATOM_B + row0 * A::ATOM_B + c, 16, 8 * A::ATOM_B,
                           A::LAYOUT);
}

// D[64 x 32] (+)= A[64 x 8] B[32 x 8]^T in TF32, A from registers, B K-major
// in shared memory; accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] B[64 x 8]^T in TF32, A from registers.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, b, accumulate);
  else wgmma_rs_n64(d, a, b, accumulate);
}

// D[64 x 32] (+)= A[64 x 8] B[32 x 8]^T in TF32, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// A float32 tensor map of three dimensions (dims[0] = D, contiguous; row and
// head strides in bytes, multiples of 16) with boxes of one column atom by
// box_rows rows by one head, swizzled for rows of ATOM_B bytes.  Reads
// outside the dims are zero-filled (the padded columns of D = 112, a ragged
// tail's rows: never the next head's).
template <int D>
int f32_map(CUtensorMap* map, const void* ptr, long long rows, long long heads, int box_rows) {
  using A = Atoms<D>;
  const hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)rows * D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)A::ATOM_E, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         A::ATOM_B == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Rows [row0, row0 + R) of one head of a map: every column atom of the tile
// at `dst`, completing on `bar` (R * DP * 4 bytes, zero fill included).
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int head) {
  using A = Atoms<D>;
#pragma unroll
  for (int a = 0; a < A::ATOMS; ++a)
    hopper::tma_load_3d(dst + a * R * A::ATOM_B, map, bar, a * A::ATOM_E, row0, head);
}

}  // namespace tf32
