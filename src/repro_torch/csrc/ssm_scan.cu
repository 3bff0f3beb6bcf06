// K3: the chunked SSD scan on Hopper (mLSTM and Mamba-2 prefill).
//
// Replaces the Pallas kernel src/repro/kernels/ssm_scan.py (`_ssd_kernel`,
// launched by `ssm_scan_fwd`, wrapped by `kernels/ops.py::ssm_scan`). Same
// contract: per (batch * head) row and per chunk of L steps,
//   cum = cumsum(loga)
//   y   = (C B^T o exp(cum_t - cum_s) o tril) X + (C exp(cum)) h
//   h  <- exp(cum_L) h + (B exp(cum_L - cum))^T X
// from h = 0, summed in fp32 (fp64 where x is fp32); y in x's dtype, the
// final h in fp32. x and c are bf16 or fp32 alike, b either (the mLSTM path hands
// b = k * igate in fp32), loga fp32. The wrapper pads P and N to multiples
// of 8 (`kernels/ssm_scan.py::fold`), so every row is whole 16-byte copies.
//
// What bounds it on the card: at the mLSTM prefill shapes (BH = 4, S =
// 1024, P = 513, N = 512, L = 256) the function moves ~25.2 MB of inputs
// and outputs, 7.5 us at 3.35 TB/s, for ~5.4 GFLOP of products. Those are
// fp32 products: one TF32 pass on an fp32 operand misses the limits the
// kernel is held to (h to 1e-5 of its scale), so each fp32 operand a is
// split as hi = tf32(a), lo = tf32(a - hi) (|a - hi - lo| <= 2^-22 |a|) and
// each product takes hi b + lo b (b bf16, exact in TF32). That is ~10.8
// GFLOP of TF32 work on the bf16 path, a floor of ~22 us at the 495 TFLOP/s
// TF32 peak, above the byte bound. On the fp32 path (tests) both operands
// are fp32: each is split in three parts, whose sum is exact, and the sums
// are kept in fp64, so the kernel stays within its limits of an exact
// result where a dot product of 512 terms cancels.
//
// Design: the chunks are computed in parallel, as the JAX package's
// `chunked_ssd` splits them, not in the Pallas kernel's sequential chunk
// order. Two launches, 128 threads a block, every product a warp's
// `mma.sync.m16n8k8` TF32 tile; tiles are staged in shared memory by
// 16-byte `cp.async` into a two-stage ring (a deeper ring costs blocks an
// SM). bf16 fragments come out of it by `ldmatrix`, and fp32 ones whose
// output index is contiguous by one 16-byte load per k: the warp tile's
// rows (states) or columns (outputs) are permuted for it (`acc_row`).
//  1. `pass_states_weights`, two kinds of blocks in one grid:
//     - states: one block per (row, 64 columns of N, 64 columns of P) walks
//       the chunks and keeps its h tile in registers; per chunk it writes
//       the state entering the chunk to a scratch buffer (BH * (K - 1) * N
//       * P fp32, 12.8 MB at the shapes above, in the 50 MB L2), scales h
//       by exp(cum_L) and adds (B exp(cum_L - cum))^T X;
//     - weights: one block per (row, chunk, 64 x 64 tile of t and s on or
//       below the diagonal) forms W = C B^T o exp(cum_t - cum_s) o tril into
//       a scratch buffer (BH * K * L * L fp32, 4 MB), once for every column
//       tile of pass 2.
//  2. `pass_outputs`: one block per (row, chunk, 64 rows of t, 64 columns
//     of P), the latest chunks and rows first: y = exp(cum_t) (C h_entering)
//     + W X over the s steps up to the diagonal (none above it).
// 448 + 576 blocks at the shapes above. The cumulative log-decay of a chunk
// is summed in fp64, so the decay factors carry no error of its order. No
// atomics: every sum has a fixed order, so two calls are bit-identical and
// a row's result does not depend on how many rows the call holds. The
// launch allocates nothing and sets the shared-memory limit once per
// device, so a call can be captured in a CUDA graph.
//
// Left for later (`scripts/k3_ablation.py` times the parts): the 64 x 64
// tiles read their operands from L2 several times over (~260 MB a call),
// and the fragment loads and splits, more than the tensor cores, set the
// pace of the inner loops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 4 warps, 2 x 2 over a 64 x 64 output tile
constexpr int kTile = 64;           // output tile edge; the t and s tiles of W
constexpr int kStep = 32;           // contraction depth of one pipeline stage
constexpr int kStages = 2;          // cp.async ring depth (a deeper ring costs blocks an SM)
constexpr int kMaxChunk = 1024;     // cum and exp(cum_L - cum) live in shared memory
constexpr int kMaxDevices = 64;
// Shared row strides, chosen so that a warp's fragment loads meet no bank
// conflict: a tile whose contraction index is contiguous is read as pairs
// (k = 2q, 2q + 1) at row g or by ldmatrix (stride = 8 mod 32 words for
// fp32, 4 mod 8 words for bf16); a tile whose output index is contiguous
// is read at rows k = 2q (+1), four adjacent columns at 4g or 8g bytes or
// by ldmatrix (stride = 4 mod 32 words for fp32, 8 mod 32 halves for
// bf16). Every row stays 16-byte aligned for cp.async.
constexpr int kStrideK = kStep + 8;
template <typename T>
struct IdxStride;
template <>
struct IdxStride<float> { static constexpr int v = kTile + 4; };
template <>
struct IdxStride<__nv_bfloat16> { static constexpr int v = kTile + 8; };

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// -- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-fills the destination
// when !full (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 matrices of 16-bit values from shared memory, for one warp:
// lane l gives the address of row l % 8 of matrix l / 8 (16-byte aligned),
// and d[j] holds matrix j, lane (g, q) holding row g, columns 2q and 2q + 1
// (the low half first). ldsm_x4_t transposes: lane (g, q) holds rows 2q
// and 2q + 1 of column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(row))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(row))
               : "memory");
}

// d += a b for one warp: a 16 x 8 (row), b 8 x 8 (col), TF32, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// -- end of PTX helpers

// x rounded to the nearest TF32 value, ties away from zero, as
// cvt.rna.tf32.f32 rounds (which runs on a slow conversion pipe): add half
// of the 13 low mantissa bits, then clear them. Finite x only.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An operand as the sum of PARTS TF32 values, largest first: a bf16 value
// is exact as it is (1 part); a = p0 + p1 to 2^-22 |a| (2 parts, the bf16
// path's fp32 operands); a = p0 + p1 + p2 exactly (3 parts, the fp32
// path). Each difference a - p0, (a - p0) - p1 is exact in fp32.
template <int PARTS>
__device__ __forceinline__ void split(float a, uint32_t (&p)[PARTS]) {
  if constexpr (PARTS == 1) {
    p[0] = __float_as_uint(a);
  } else {
#pragma unroll
    for (int i = 0; i < PARTS; ++i) {
      p[i] = to_tf32(a);
      a -= __uint_as_float(p[i]);
    }
  }
}

// The parts of an operand: an input in bf16 is exact (1); an fp32 one, or
// a product formed in the kernel, takes 2 on the bf16 path and 3 on the
// fp32 path (TX, the type of x and c, says which path).
template <typename TX>
constexpr int kParts = sizeof(TX) == 4 ? 3 : 2;
template <typename TX, typename T>
constexpr int kPartsOf = sizeof(T) == 4 ? kParts<TX> : 1;

// The accumulators: fp32 on the bf16 path; fp64 on the fp32 path, whose
// limit (1e-5 of an element's scale) a dot product of 512 terms summed in
// fp32 misses where its terms cancel.
template <typename TX>
struct AccT { using type = float; };
template <>
struct AccT<float> { using type = double; };
template <typename TX>
using Acc = typename AccT<TX>::type;

// (p[0], p[1]); p is 8-byte aligned
__device__ __forceinline__ void ld2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}

// p[0 .. 4); p is 16-byte (fp32) or 8-byte (bf16) aligned
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(w.x << 16);
  v[1] = __uint_as_float(w.x & 0xffff0000u);
  v[2] = __uint_as_float(w.y << 16);
  v[3] = __uint_as_float(w.y & 0xffff0000u);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(a))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(b))) << 16;
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// p[0 .. 8); p is 16-byte aligned
__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// Stage rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major
// global matrix (ld elements a row) into shared dst (ds elements a row);
// rows >= rmax and columns >= cmax (a multiple of 16 bytes) are zeros.
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ds, const T* src, long long ld, int r0, int rmax,
                                           int c0, int cmax) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = COLS / kVec;
  constexpr int kTotal = ROWS * kPerRow;
  static_assert(COLS % kVec == 0 && kTotal % kThreads == 0, "whole copies, evenly shared");
#pragma unroll
  for (int j = 0; j < kTotal / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kPerRow;
    const int cv = (i - r * kPerRow) * kVec;
    const bool full = r0 + r < rmax && c0 + cv < cmax;
    cp_async16(dst + r * ds + cv, full ? src + (long long)(r0 + r) * ld + c0 + cv : src, full);
  }
}

// The lane's place in a warp's 32 x 32 tile of the block's 64 x 64 output.
struct Lane {
  int g, q, wm, wn;
  __device__ Lane() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2;
    q = lane & 3;
    wm = (warp >> 1) * 32;
    wn = (warp & 1) * 32;
  }
};

// Where the lane's accumulator element (g + 8h, 2q + j) of tile (mi, ni)
// sits in the block's output tile. In order: row wm + 16 mi + g + 8h,
// column wn + 8 ni + 2q + j. With the rows permuted (the states pass): row
// wm + 4g + 2 mi + h, so that the lane's four A rows are adjacent in an
// A tile whose output index is contiguous, one 16-byte load per k. With
// the columns permuted (the outputs pass): column wn + 8q + 4j + ni, so
// that the lane's four B columns wn + 4g + ni are adjacent, and its outputs
// in a row are the eight adjacent columns wn + 8q ... wn + 8q + 7.
__device__ __forceinline__ int acc_row(const Lane& ln, bool perm, int mi, int h) {
  return perm ? ln.wm + 4 * ln.g + 2 * mi + h : ln.wm + 16 * mi + ln.g + 8 * h;
}

// The fragments of one step of 8 in the contraction, k = kk + 2q (+ 1):
// A as v[mi] = {(r, k), (r + 8, k), (r, k + 1), (r + 8, k + 1)} for the
// rows r = wm + 16 mi + g, B as v[ni] = {(k, c), (k + 1, c)} for the
// columns c = wn + 8 ni + g. Taking the contraction index in the order 2q,
// 2q + 1 for the fragment slots q, q + 4 of both operands permutes it
// within each 8: the sum is the same, a lane's pair of k is adjacent in
// memory, and a bf16 pair is one 32-bit value that ldmatrix delivers.
__device__ __forceinline__ float lo16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// A from a tile whose contraction index is contiguous (row r at t + r *
// kStrideK): one ldmatrix for bf16
template <typename T>
__device__ __forceinline__ void frag_a_kmajor(float (&v)[2][4], const T* t, int kk, const Lane& ln) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31;
    uint32_t d[4];
    ldsm_x4(d, t + (ln.wm + lane) * kStrideK + kk);  // matrix j: rows wm + 8j ...
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      v[mi][0] = lo16(d[2 * mi]);
      v[mi][2] = hi16(d[2 * mi]);
      v[mi][1] = lo16(d[2 * mi + 1]);
      v[mi][3] = hi16(d[2 * mi + 1]);
    }
  } else {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const T* p = t + (ln.wm + 16 * mi + ln.g) * kStrideK + kk + 2 * ln.q;
      ld2(p, v[mi][0], v[mi][2]);
      ld2(p + 8 * kStrideK, v[mi][1], v[mi][3]);
    }
  }
}

// B from a tile whose contraction index is contiguous (column c at t + c *
// kStrideK): one ldmatrix for bf16
template <typename T>
__device__ __forceinline__ void frag_b_kmajor(float (&v)[4][2], const T* t, int kk, const Lane& ln) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31;
    uint32_t d[4];
    ldsm_x4(d, t + (ln.wn + lane) * kStrideK + kk);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      v[ni][0] = lo16(d[ni]);
      v[ni][1] = hi16(d[ni]);
    }
  } else {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) ld2(t + (ln.wn + 8 * ni + ln.g) * kStrideK + kk + 2 * ln.q, v[ni][0], v[ni][1]);
  }
}

// B from a tile whose output index is contiguous (row k at t + k * ds):
// one transposing ldmatrix for bf16
template <typename T>
__device__ __forceinline__ void frag_b_idx(float (&v)[4][2], const T* t, int ds, int kk, const Lane& ln) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31;
    uint32_t d[4];
    ldsm_x4_t(d, t + (kk + (lane & 7)) * ds + ln.wn + 8 * (lane >> 3));
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      v[ni][0] = lo16(d[ni]);
      v[ni][1] = hi16(d[ni]);
    }
  } else {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const T* p = t + (kk + 2 * ln.q) * ds + ln.wn + 8 * ni + ln.g;
      v[ni][0] = p[0];
      v[ni][1] = p[ds];
    }
  }
}

// A from a tile whose output index is contiguous (row k at t + k * ds),
// the rows permuted (acc_row): per k one load of the lane's four rows,
// each times e[k]
template <typename T>
__device__ __forceinline__ void frag_a_idx_perm(float (&v)[2][4], const T* t, int ds, const float* e, int kk,
                                                const Lane& ln) {
  const int k = kk + 2 * ln.q;
  float r0[4], r1[4];
  ld4(t + k * ds + ln.wm + 4 * ln.g, r0);
  ld4(t + (k + 1) * ds + ln.wm + 4 * ln.g, r1);
  const float e0 = e[k], e1 = e[k + 1];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    v[mi][0] = r0[2 * mi] * e0;
    v[mi][1] = r0[2 * mi + 1] * e0;
    v[mi][2] = r1[2 * mi] * e1;
    v[mi][3] = r1[2 * mi + 1] * e1;
  }
}

// B from a tile whose output index is contiguous, the columns permuted:
// per k one load of the lane's four columns
template <typename T>
__device__ __forceinline__ void frag_b_idx_perm(float (&v)[4][2], const T* t, int ds, int kk, const Lane& ln) {
  const int k = kk + 2 * ln.q;
  float r0[4], r1[4];
  ld4(t + k * ds + ln.wn + 4 * ln.g, r0);
  ld4(t + (k + 1) * ds + ln.wn + 4 * ln.g, r1);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    v[ni][0] = r0[ni];
    v[ni][1] = r1[ni];
  }
}

// acc += A B over one stage (kStep of the contraction) for the m16 tiles
// [mlo, mhi) and the n8 tiles [0, nhi) of the warp, A in PA parts and B in
// PB; fa(kk, v) and fb(kk, v) give the fragments of the step kk as above.
//
// A product of parts i and j (from 1) is exact in fp32; the terms kept are
// those with i + j <= 1 + max(PA, PB), smallest first: the product error is
// 2^-22 of it on the bf16 path (1 x 2 parts) and ~2^-33 on the fp32 path
// (3 x 3 or 3 x 1 parts). On the fp32 path the products of each 8 of the
// contraction are summed on their own and added to the fp64 acc. On the
// bf16 path they go straight into acc, or with kStaged (the states pass,
// whose h is held to 1e-5) are summed per stage first: the 256 steps of a
// chunk then take 8 fp32 additions in acc rather than 32 tensor-core
// accumulations (without, chip_smoke.py's case with no decay, loga = 0,
// read 2.4e-6 of h's scale on an H100 against 2.2e-7 with them).
template <int PA, int PB, bool kStaged, typename A, class FA, class FB>
__device__ __forceinline__ void mma_stage(A (&acc)[2][4][4], int mlo, int mhi, int nhi, FA fa, FB fb) {
  constexpr bool kFine = PA == 3 || PB == 3;
  constexpr bool kSum = kFine || kStaged;
  float sum[2][4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kStep; kk += 8) {
    float va[2][4], vb[4][2];
    fa(kk, va);
    fb(kk, vb);
    uint32_t a[2][4][PA], b[4][2][PB];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (mi < mlo || mi >= mhi) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) split<PA>(va[mi][r], a[mi][r]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      if (ni >= nhi) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) split<PB>(vb[ni][r], b[ni][r]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if (mi < mlo || mi >= mhi || ni >= nhi) continue;
        auto term = [&](int i, int j) {
          const uint32_t fa4[4] = {a[mi][0][i], a[mi][1][i], a[mi][2][i], a[mi][3][i]};
          const uint32_t fb2[2] = {b[ni][0][j], b[ni][1][j]};
          if constexpr (kSum)
            mma_tf32(sum[mi][ni], fa4, fb2);
          else
            mma_tf32(acc[mi][ni], fa4, fb2);
        };
        if constexpr (PA >= 2 && PB >= 2 && (PA == 3 || PB == 3)) term(1, 1);
        if constexpr (PB >= 3) term(0, 2);
        if constexpr (PA >= 3) term(2, 0);
        if constexpr (PB >= 2) term(0, 1);
        if constexpr (PA >= 2) term(1, 0);
        term(0, 0);
      }
    }
    if constexpr (kFine) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[mi][ni][r] += static_cast<A>(sum[mi][ni][r]);
            sum[mi][ni][r] = 0.f;
          }
    }
  }
  if constexpr (kStaged && !kFine) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += static_cast<A>(sum[mi][ni][r]);
  }
}

// Store the warp's accumulators, columns in order, rows in order or
// permuted (acc_row), as rows [r0 + ...) and columns [c0 + wn, ...) of a
// row-major matrix of ld columns; only rows < rmax and columns < cmax
// (even) are written.
template <bool kRowPerm, typename T, typename A>
__device__ __forceinline__ void store_acc(const A (&acc)[2][4][4], const Lane& ln, T* dst, long long ld, int r0,
                                          int rmax, int c0, int cmax) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + acc_row(ln, kRowPerm, mi, h);
      if (r >= rmax) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = c0 + ln.wn + 8 * ni + 2 * ln.q;
        if (c < cmax)
          st2(dst + (long long)r * ld + c, static_cast<float>(acc[mi][ni][2 * h]),
              static_cast<float>(acc[mi][ni][2 * h + 1]));
      }
    }
}

// The same with the columns permuted (rows in order): each row's eight
// adjacent columns in one store; cmax is a multiple of 8.
template <typename T, typename A>
__device__ __forceinline__ void store_acc_colperm(const A (&acc)[2][4][4], const Lane& ln, T* dst, long long ld,
                                                  int r0, int rmax, int c0, int cmax) {
  const int c = c0 + ln.wn + 8 * ln.q;
  if (c >= cmax) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + acc_row(ln, false, mi, h);
      if (r >= rmax) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) v[4 * j + ni] = static_cast<float>(acc[mi][ni][2 * h + j]);
      st8(dst + (long long)r * ld + c, v);
    }
}

// cum[0, L) = inclusive prefix sum of la[0, L), in fp64 and in a fixed
// order: each thread sums a run of ceil(L / kThreads) values, then a
// log-step scan over the runs' totals (tot: kThreads values). Ends on a
// barrier. In fp64 the decay factors exp(cum_t - cum_s), exp(cum_L - cum)
// and exp(cum) carry no error of the sum's order: in fp32 that error grows
// with |cum| and, at large input gates, outweighed the products'.
__device__ void chunk_cumsum(const float* __restrict__ la, int L, double* cum, double* tot) {
  const int per = (L + kThreads - 1) / kThreads;
  const int i0 = threadIdx.x * per, i1 = min(L, i0 + per);
  double run = 0.0;
  for (int i = i0; i < i1; ++i) {
    run += la[i];
    cum[i] = run;
  }
  tot[threadIdx.x] = run;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const double v = threadIdx.x >= off ? tot[threadIdx.x - off] : 0.0;
    __syncthreads();
    tot[threadIdx.x] += v;
    __syncthreads();
  }
  const double base = threadIdx.x ? tot[threadIdx.x - 1] : 0.0;
  for (int i = i0; i < i1; ++i) cum[i] += base;
  __syncthreads();
}

// Shared memory of the two passes: a ring of kStages stages, then cum (L
// values) and the scan's totals (fp64) and exp(cum_L - cum) (L rounded up
// to a stage). A launch takes what its chunk length needs, so that four
// blocks fit on an SM at L = 256.
__host__ __device__ constexpr int scan_bytes(int L) {
  return ((L + kThreads) * 8 + (L + kStep - 1) / kStep * kStep * 4 + 15) / 16 * 16;
}

template <typename TX, typename TB>
struct Smem {
  // states block: b (s x n) and x (s x p), output index contiguous
  static constexpr int kSB = kStep * IdxStride<TB>::v * (int)sizeof(TB);
  static constexpr int kSX = kStep * IdxStride<TX>::v * (int)sizeof(TX);
  // weights block: c (t x n) and b (s x n), n contiguous
  static constexpr int kWC = kTile * kStrideK * (int)sizeof(TX);
  static constexpr int kWB = kTile * kStrideK * (int)sizeof(TB);
  // outputs block: c (t x n) with h (n x p), then W (t x s) with x (s x p)
  static constexpr int kYC = kTile * kStrideK * (int)sizeof(TX);
  static constexpr int kYH = kStep * IdxStride<float>::v * (int)sizeof(float);
  static constexpr int kYW = kTile * kStrideK * (int)sizeof(float);
  static constexpr int kYX = kStep * IdxStride<TX>::v * (int)sizeof(TX);
  static constexpr int kStage1 = cmax(kSB + kSX, kWC + kWB);
  static constexpr int kStage2 = cmax(kYC + kYH, kYW + kYX);
  static constexpr int kRing1 = kStages * kStage1;
  static constexpr int kRing2 = kStages * kStage2;
};

// A states block: h[n0:n0+64, p0:p0+64] over the chunks.
template <typename TX, typename TB>
__device__ void states_block(int blk, const TX* __restrict__ x, const float* __restrict__ loga,
                             const TB* __restrict__ b, float* __restrict__ hs, float* __restrict__ hout,
                             int S, int P, int N, int L, unsigned char* smem) {
  using M = Smem<TX, TB>;
  constexpr int SB = IdxStride<TB>::v, SX = IdxStride<TX>::v;
  const int ptiles = (P + kTile - 1) / kTile, ntiles = (N + kTile - 1) / kTile;
  const int p0 = (blk % ptiles) * kTile;
  blk /= ptiles;
  const int n0 = (blk % ntiles) * kTile;
  const int row = blk / ntiles;
  const int K = S / L, steps = (L + kStep - 1) / kStep;
  double* cum = reinterpret_cast<double*>(smem + M::kRing1);
  double* tot = cum + L;
  float* eo = reinterpret_cast<float*>(tot + kThreads);
  const Lane ln;
  const int mhi = N - n0 > ln.wm ? 2 : 0;  // the rows are permuted: both m16 tiles reach row wm
  const int nhi = min(4, max(0, (P - p0 - ln.wn + 7) / 8));
  Acc<TX> acc[2][4][4] = {};

  for (int k = 0; k < K; ++k) {
    const long long step0 = (long long)row * S + (long long)k * L;
    auto issue = [&](int i) {
      if (i < steps) {
        unsigned char* st = smem + (i % kStages) * M::kStage1;
        stage_tile<kStep, kTile>(reinterpret_cast<TB*>(st), SB, b + step0 * N, N, i * kStep, L, n0, N);
        stage_tile<kStep, kTile>(reinterpret_cast<TX*>(st + M::kSB), SX, x + step0 * P, P, i * kStep, L, p0, P);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue(i);
    chunk_cumsum(loga + step0, L, cum, tot);
    const double total = cum[L - 1];
    for (int i = threadIdx.x; i < steps * kStep; i += kThreads) eo[i] = i < L ? (float)exp(total - cum[i]) : 0.f;
    if (k > 0)  // the state entering chunk k
      store_acc<true>(acc, ln, hs + ((long long)row * (K - 1) + (k - 1)) * N * P, P, n0, N, p0, P);
    const Acc<TX> ea = static_cast<Acc<TX>>(exp(total));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] *= ea;

    for (int i = 0; i < steps; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage i has landed for every thread; stage i - 1 is free
      issue(i + kStages - 1);
      const unsigned char* st = smem + (i % kStages) * M::kStage1;
      const TB* bs = reinterpret_cast<const TB*>(st);
      const TX* xs = reinterpret_cast<const TX*>(st + M::kSB);
      const float* es = eo + i * kStep;
      // A (n, s) = b[s][n] exp(cum_L - cum_s), rows permuted; B (s, p) = x[s][p]
      mma_stage<kParts<TX>, kPartsOf<TX, TX>, true>(
          acc, 0, mhi, nhi, [&](int kk, float(&v)[2][4]) { frag_a_idx_perm(v, bs, SB, es, kk, ln); },
          [&](int kk, float(&v)[4][2]) { frag_b_idx(v, xs, SX, kk, ln); });
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring, cum and eo are free for the next chunk
  }
  store_acc<true>(acc, ln, hout + (long long)row * N * P, P, n0, N, p0, P);
}

// A weights block: W[t0:t0+64, s0:s0+64] of one chunk, zeros above the
// diagonal and past L, into w (L_pad x L_pad per (row, chunk)).
template <typename TX, typename TB>
__device__ void weights_block(int blk, const float* __restrict__ loga, const TB* __restrict__ b,
                              const TX* __restrict__ c, float* __restrict__ w, int S, int N, int L,
                              unsigned char* smem) {
  using M = Smem<TX, TB>;
  const int T = (L + kTile - 1) / kTile, Lp = T * kTile;
  const int tri = T * (T + 1) / 2;
  int ti = blk % tri;
  blk /= tri;
  const int K = S / L;
  const int k = blk % K, row = blk / K;
  int tt = 0;
  while (ti > tt) ti -= ++tt;
  const int t0 = tt * kTile, s0 = ti * kTile;
  const long long step0 = (long long)row * S + (long long)k * L;
  const int steps = (N + kStep - 1) / kStep;
  double* cum = reinterpret_cast<double*>(smem + M::kRing1);
  double* tot = cum + L;
  const Lane ln;
  Acc<TX> acc[2][4][4] = {};
  auto issue = [&](int i) {
    if (i < steps) {
      unsigned char* st = smem + (i % kStages) * M::kStage1;
      stage_tile<kTile, kStep>(reinterpret_cast<TX*>(st), kStrideK, c + step0 * N, N, t0, L, i * kStep, N);
      stage_tile<kTile, kStep>(reinterpret_cast<TB*>(st + M::kWC), kStrideK, b + step0 * N, N, s0, L, i * kStep, N);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  chunk_cumsum(loga + step0, L, cum, tot);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
    const unsigned char* st = smem + (i % kStages) * M::kStage1;
    const TX* cs = reinterpret_cast<const TX*>(st);
    const TB* bs = reinterpret_cast<const TB*>(st + M::kWC);
    // A (t, n) = c[t][n]; B (n, s) = b[s][n]
    mma_stage<kPartsOf<TX, TX>, kPartsOf<TX, TB>, false>(
        acc, 0, 2, 4,
        [&](int kk, float(&v)[2][4]) { frag_a_kmajor(v, cs, kk, ln); },
        [&](int kk, float(&v)[4][2]) { frag_b_kmajor(v, bs, kk, ln); });
  }
  cp_async_wait<0>();
  float* wk = w + ((long long)row * K + k) * Lp * Lp;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + ln.wm + 16 * mi + ln.g + 8 * h;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int s = s0 + ln.wn + 8 * ni + 2 * ln.q;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          v[j] = (t < L && s + j <= t)
                     ? static_cast<float>(acc[mi][ni][2 * h + j] * static_cast<Acc<TX>>(exp(fmin(cum[t] - cum[s + j], 0.0))))
                     : 0.f;
        st2(wk + (long long)t * Lp + s, v[0], v[1]);
      }
    }
}

// Blocks an SM on the bf16 path: three for pass 1 (its states blocks hold
// the stage sums beside h, and spill at 128 registers a thread), four for
// pass 2 (at most 128 registers)
template <typename TX, int kBf16>
constexpr int kMinBlocks = sizeof(TX) == 2 ? kBf16 : 1;

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks<TX, 3>) pass_states_weights(
    const TX* __restrict__ x, const float* __restrict__ loga, const TB* __restrict__ b,
    const TX* __restrict__ c, float* __restrict__ hs, float* __restrict__ hout, float* __restrict__ w,
    int states_blocks, int S, int P, int N, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < states_blocks)
    states_block<TX, TB>(blockIdx.x, x, loga, b, hs, hout, S, P, N, L, smem);
  else
    weights_block<TX, TB>(blockIdx.x - states_blocks, loga, b, c, w, S, N, L, smem);
}

// y[t0:t0+64, p0:p0+64] of one chunk: exp(cum_t) (C h_entering) + W X.
template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks<TX, 4>) pass_outputs(
    const TX* __restrict__ x, const float* __restrict__ loga, const TX* __restrict__ c,
    const float* __restrict__ hs, const float* __restrict__ w, TX* __restrict__ y, int S, int P, int N, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  using M = Smem<TX, TB>;
  constexpr int SH = IdxStride<float>::v, SX = IdxStride<TX>::v;
  const int K = S / L, Lp = ((L + kTile - 1) / kTile) * kTile;
  // the latest chunks and t tiles (the most work) are dispatched first
  const int BH = gridDim.z / K;
  const int p0 = blockIdx.x * kTile, t0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int k = K - 1 - blockIdx.z / BH, row = blockIdx.z % BH;
  const long long step0 = (long long)row * S + (long long)k * L;
  const int steps1 = k > 0 ? (N + kStep - 1) / kStep : 0;        // over n: C h
  const int steps2 = (min(L, t0 + kTile) + kStep - 1) / kStep;   // over s: W X, up to the diagonal
  const int steps = steps1 + steps2;
  const float* hk = k > 0 ? hs + ((long long)row * (K - 1) + (k - 1)) * N * P : hs;
  const float* wk = w + ((long long)row * K + k) * Lp * Lp;
  double* cum = reinterpret_cast<double*>(smem + M::kRing2);
  double* tot = cum + L;
  const Lane ln;
  const int mhi = min(2, max(0, (L - t0 - ln.wm + 15) / 16));
  const int nhi = P - p0 > ln.wn ? 4 : 0;  // the columns are permuted: every n8 tile reaches column wn
  Acc<TX> acc[2][4][4] = {};
  auto issue = [&](int i) {
    unsigned char* st = smem + (i % kStages) * M::kStage2;
    if (i < steps1) {
      stage_tile<kTile, kStep>(reinterpret_cast<TX*>(st), kStrideK, c + step0 * N, N, t0, L, i * kStep, N);
      stage_tile<kStep, kTile>(reinterpret_cast<float*>(st + M::kYC), SH, hk, P, i * kStep, N, p0, P);
    } else if (i < steps) {
      const int s = (i - steps1) * kStep;
      stage_tile<kTile, kStep>(reinterpret_cast<float*>(st), kStrideK, wk, Lp, t0, Lp, s, Lp);
      stage_tile<kStep, kTile>(reinterpret_cast<TX*>(st + M::kYW), SX, x + step0 * P, P, s, L, p0, P);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  chunk_cumsum(loga + step0, L, cum, tot);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
    const unsigned char* st = smem + (i % kStages) * M::kStage2;
    if (i < steps1) {
      const TX* cs = reinterpret_cast<const TX*>(st);
      const float* hsm = reinterpret_cast<const float*>(st + M::kYC);
      // A (t, n) = c[t][n]; B (n, p) = h[n][p]
      mma_stage<kPartsOf<TX, TX>, kParts<TX>, false>(
          acc, 0, mhi, nhi,
          [&](int kk, float(&v)[2][4]) { frag_a_kmajor(v, cs, kk, ln); },
          [&](int kk, float(&v)[4][2]) { frag_b_idx_perm(v, hsm, SH, kk, ln); });
      continue;
    }
    if (i == steps1 && k > 0) {  // C h is complete: scale its rows by exp(cum_t)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + ln.wm + 16 * mi + ln.g + 8 * h;
          const Acc<TX> e = t < L ? static_cast<Acc<TX>>(exp(cum[t])) : Acc<TX>(0);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            acc[mi][ni][2 * h] *= e;
            acc[mi][ni][2 * h + 1] *= e;
          }
        }
    }
    const float* ws = reinterpret_cast<const float*>(st);
    const TX* xs = reinterpret_cast<const TX*>(st + M::kYW);
    // W is zero where s > t: an m16 tile whose last row is above this
    // stage's first s is skipped
    const int mlo = max(0, min(2, ((i - steps1) * kStep - t0 - ln.wm) / 16));
    // A (t, s) = W[t][s]; B (s, p) = x[s][p]
    mma_stage<kParts<TX>, kPartsOf<TX, TX>, false>(
        acc, mlo, mhi, nhi,
        [&](int kk, float(&v)[2][4]) { frag_a_kmajor(v, ws, kk, ln); },
        [&](int kk, float(&v)[4][2]) { frag_b_idx_perm(v, xs, SX, kk, ln); });
  }
  cp_async_wait<0>();
  store_acc_colperm(acc, ln, y + step0 * P, P, t0, L, p0, P);
}

// Raise a kernel's dynamic shared-memory limit, once per device.
template <typename F>
cudaError_t opt_in_smem(F* func, int bytes, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const float* loga, const void* b, const void* c, void* y, float* h,
                   float* hs, float* w, int BH, int S, int P, int N, int L, cudaStream_t stream) {
  using M = Smem<TX, TB>;
  static bool opted1[kMaxDevices], opted2[kMaxDevices];
  cudaError_t e = opt_in_smem(pass_states_weights<TX, TB>, M::kRing1 + scan_bytes(kMaxChunk), opted1);
  if (e != cudaSuccess) return e;
  e = opt_in_smem(pass_outputs<TX, TB>, M::kRing2 + scan_bytes(kMaxChunk), opted2);
  if (e != cudaSuccess) return e;
  const int K = S / L, T = (L + kTile - 1) / kTile;
  const int ptiles = (P + kTile - 1) / kTile, ntiles = (N + kTile - 1) / kTile;
  const int states_blocks = BH * ntiles * ptiles;
  const int blocks1 = states_blocks + BH * K * (T * (T + 1) / 2);
  const TX* xx = static_cast<const TX*>(x);
  const TB* bb = static_cast<const TB*>(b);
  const TX* cc = static_cast<const TX*>(c);
  pass_states_weights<TX, TB><<<blocks1, kThreads, M::kRing1 + scan_bytes(L), stream>>>(xx, loga, bb, cc, hs, h, w, states_blocks, S, P, N, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  pass_outputs<TX, TB><<<dim3(ptiles, T, BH * K), kThreads, M::kRing2 + scan_bytes(L), stream>>>(xx, loga, cc, hs, w, static_cast<TX*>(y), S, P, N, L);
  return cudaGetLastError();
}

}  // namespace

// x_dtype (x, c, y) and b_dtype: 0 = float32, 1 = bfloat16. Every tensor
// contiguous and 16-byte aligned, P and N multiples of 8, S a multiple of
// L. Scratch: hs holds BH * (S / L - 1) * N * P floats, w BH * (S / L) *
// L_pad^2 floats (L_pad = L rounded up to 64).
extern "C" cudaError_t k3_ssm_scan(int x_dtype, int b_dtype, const void* x, const void* loga,
                                   const void* b, const void* c, void* y, void* h, void* hs, void* w,
                                   int BH, int S, int P, int N, int L, void* stream) {
  if (BH <= 0 || S <= 0 || P <= 0 || N <= 0 || L <= 0 || L > kMaxChunk || S % L != 0 || P % 8 != 0 ||
      N % 8 != 0 || (long long)BH * (S / L) > 65535)
    return cudaErrorInvalidValue;
  const float* la = static_cast<const float*>(loga);
  float* hh = static_cast<float*>(h);
  float* hsc = static_cast<float*>(hs);
  float* ww = static_cast<float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && b_dtype == 0)
    return launch<float, float>(x, la, b, c, y, hh, hsc, ww, BH, S, P, N, L, st);
  if (x_dtype == 0 && b_dtype == 1)
    return launch<float, __nv_bfloat16>(x, la, b, c, y, hh, hsc, ww, BH, S, P, N, L, st);
  if (x_dtype == 1 && b_dtype == 0)
    return launch<__nv_bfloat16, float>(x, la, b, c, y, hh, hsc, ww, BH, S, P, N, L, st);
  if (x_dtype == 1 && b_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, la, b, c, y, hh, hsc, ww, BH, S, P, N, L, st);
  return cudaErrorInvalidValue;
}
