// K2: causal flash-attention forward on Hopper, for prefill.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (`_flash_kernel`, launched by `flash_attention_fwd`, wrapped by
// `kernels/ops.py::flash_attention`). Same function: causal attention with
// a query offset `q_offset`, an optional sliding window and GQA (kv head
// = h / (H / KH)); fp32 running max, normaliser and accumulator; kv tiles
// wholly in the causal future or outside the window are skipped; output in
// q's dtype; q, k and v read in the model layout (B, S, heads, D) through
// strides, so the caller never transposes them.
//
// Unlike the Pallas kernel, masked probabilities are exact zeros. The
// Pallas body computes exp(s - m_new) for masked entries too, which under
// a window gives a row whose first visited tile is fully masked a phantom
// weight of 1 per key (cancelled there only because a later tile always
// follows).
//
// What bounds it on the card: at prefill (Sq = Sk = 1024, H = 16, D = 128)
// the work is ~4.3 GFLOP over ~12.6 MB, about 340 flops per byte, just
// above the H100's bf16 ridge (~295): operations, on the tensor cores.
//
// bf16 (the serving dtype) runs on Hopper's tensor cores through
// `wgmma`. One block of one warpgroup (4 warps, 16 q rows each) per
// (b * H + h, 64-row q tile); the q tiles are walked latest first
// (blockIdx.y reversed), so the longest causal rows start first. Q, K and V
// tiles (64 keys; 32 at D = 256) arrive by 16-byte `cp.async`, rows past Sq
// and Sk zero-filled through the copy's source size, into shared memory in
// the 128-byte-swizzled layout wgmma reads (64-column blocks of 128-byte
// rows, the 16-byte chunks of row r XOR-ed by r % 8). S = Q Kᵀ is a wgmma
// with both operands in shared memory; the score fragment stays in
// registers, where the online softmax runs on it (row max and sum across
// the four lanes of a quad; masking by the fragment's own row and column);
// P, rounded to bf16, is the register A operand of the P V wgmma, which
// reads V transposed from shared memory. The normaliser l sums the fp32 P.
// Three stages of K and V let the next tile's Q Kᵀ run on the tensor cores
// while this tile's softmax runs on the ALUs, with the tile after that in
// flight.
//
// fp32 inputs take the CUDA-core body further down, chosen by dtype in the
// entry point: the tensor cores cannot meet fp32's tolerance (1e-4 against
// the plain version), and only the tests use fp32. One block of 128
// threads per (b * H + h, q tile of BQ rows), BQ = 64 (32 at D = 256);
// TPR = 128 / BQ lanes share a q row, each scoring every TPR-th key of a
// 32-key tile and owning every TPR-th output column.
//
// Left for later: TMA loads with an mbarrier pipeline (each thread now
// issues 16 copies a tile), warp specialisation with two consumer
// warpgroups on 128-row q tiles, overlapping P V with the next softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// -- PTX helpers ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes 16 zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's generic-proxy writes to shared memory (cp.async
// included) visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving reads or writes of accumulator registers
// across a wgmma that is still in flight
template <int N>
__device__ __forceinline__ void wgmma_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 32 fp32 over the warpgroup) += A (64 x 16, smem) * B (32 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 64 fp32 over the warpgroup) += A (64 x 16, smem) * B (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 64 fp32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 128 fp32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 256 fp32) += A (64 x 16, registers) * B (16 x 256, smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- end of PTX helpers -------------------------------------------------------

// two floats as bf16x2, `lo` in the low half (the lower column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D, int BK>
struct Tc {
  static constexpr int BQ = 64;                     // q rows per block: one warpgroup, 16 a warp
  static constexpr int kQBytes = BQ * D * 2;        // the q tile
  static constexpr int kTileBytes = BK * D * 2;     // one K or V tile
  static constexpr int kStages = 3;                 // tiles j (P V), j + 1 (Q Kᵀ), j + 2 (landing)
  // 1024 bytes of slack to align the tiles, q, then the stages of K and of V
  static constexpr size_t smem_bytes = 1024 + kQBytes + 2 * kStages * kTileBytes;
};

// Byte offset of 16-byte chunk c (0 .. D/8 - 1) of row r in a tile of R rows,
// stored as D/64 blocks of R rows x 128 bytes with the chunks of a row
// XOR-swizzled by r % 8: the 128-byte swizzle that wgmma reads (the tile
// sits on a 1024-byte boundary, since the swizzle follows address bits 4-9).
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; byte offsets.
// K-major (Q, K): rows of 128 bytes, 8-row groups `sbo` apart, `lbo`
// unused. MN-major (V, transposed): 8-row groups along K `sbo` apart,
// 64-column blocks along N `lbo` apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db);
  else wgmma_ss_n64(d, da, db);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t a[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

template <int D, int BK>
__global__ void __launch_bounds__(128) flash_tc_kernel(
    const bf16* __restrict__ q,  // (B, Sq, H, D), last dim contiguous
    const bf16* __restrict__ k,  // (B, Sk, KH, D), last dim contiguous
    const bf16* __restrict__ v,  // (B, Sk, KH, D), last dim contiguous
    bf16* __restrict__ out,      // (B, Sq, H, D), last dim contiguous
    int Sq, int Sk, int H, int KH,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int q_offset, int window, float scale_log2) {
  using T = Tc<D, BK>;
  constexpr int BQ = T::BQ;
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int NT = BK / 8;  // score tiles of 8 keys
  constexpr int DT = D / 8;   // output tiles of 8 columns
  constexpr int KD = D / 16;  // k-steps of Q Kᵀ
  static_assert(BK % 16 == 0 && D % 64 == 0, "tiling");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = q_s + T::kQBytes;                  // kStages K tiles
  unsigned char* v_s = k_s + T::kStages * T::kTileBytes;  // kStages V tiles

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // latest q tiles first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tg = lane & 3;   // fragment column pair
  const int row0 = warp * 16;

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + kh * ksh;
  const bf16* vb = v + b * vsb + kh * vsh;

  for (int i = tid; i < BQ * CH; i += 128) {
    const int r = i / CH, c = i - r * CH;
    const bool in = q0 + r < Sq;
    cp_async_16(q_s + swz<BQ>(r, c), in ? qb + (q0 + r) * qss + c * 8 : qb, in ? 16 : 0);
  }
  auto load_kv = [&](int k0, int stage) {
    unsigned char* ks = k_s + stage * T::kTileBytes;
    unsigned char* vs = v_s + stage * T::kTileBytes;
    for (int i = tid; i < BK * CH; i += 128) {
      const int r = i / CH, c = i - r * CH;
      const int t = k0 + r;
      const bool in = t < Sk;
      cp_async_16(ks + swz<BK>(r, c), in ? kb + t * kss + c * 8 : kb, in ? 16 : 0);
      cp_async_16(vs + swz<BK>(r, c), in ? vb + t * vss + c * 8 : vb, in ? 16 : 0);
    }
  };

  // kv tiles this q tile can see: causal end, window start
  const int qlo = q0 + q_offset;           // position of the tile's first row
  const int qhi = q0 + BQ - 1 + q_offset;  // and of its last
  const int kend = min(Sk, qhi + 1);
  int kstart = window > 0 ? max(0, qlo - window + 1) : 0;
  kstart = kstart / BK * BK;
  const int ntiles = kend > kstart ? (kend - kstart + BK - 1) / BK : 0;

  float o[DT * 4];  // o[4 dt + e]: rows g, g + 8 x columns 8 dt + 2 tg + {0, 1}
#pragma unroll
  for (int i = 0; i < DT * 4; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows g and g + 8, log2 domain
  float l_r[2] = {0.f, 0.f};          // this lane's share of the row sums
  const int qpos0 = qlo + row0 + g;
  const uint32_t q_addr = smem_u32(q_s);

  // S = Q Kᵀ of tile t on the tensor cores, issued without waiting:
  // s[4 nt + e] holds rows g, g + 8 x keys of the tile 8 nt + 2 tg + {0, 1}
  float s[NT * 4], s_next[NT * 4];
  auto issue_qk = [&](float (&acc)[NT * 4], int t) {
    const uint32_t k_addr = smem_u32(k_s + (t % T::kStages) * T::kTileBytes);
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) acc[i] = 0.f;
    wgmma_fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      wgmma_ss<BK>(acc, make_desc(q_addr + (kd >> 2) * BQ * 128 + (kd & 3) * 32, 16, 1024),
                   make_desc(k_addr + (kd >> 2) * BK * 128 + (kd & 3) * 32, 16, 1024));
    wgmma_commit();
  };

  // pipeline: tile j's softmax runs on the ALUs while tile j + 1's Q Kᵀ
  // runs on the tensor cores; tile j + 2 is in flight meanwhile
  if (ntiles > 0) load_kv(kstart, 0);
  cp_async_commit();  // group: the q tile and tile 0
  if (ntiles > 1) load_kv(kstart + BK, 1);
  cp_async_commit();  // group: tile 1
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();
  if (ntiles > 0) {
    issue_qk(s, 0);
    wgmma_wait0();
    wgmma_fence_regs(s);
  }

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = kstart + j * BK;
    if (j + 2 < ntiles) load_kv(k0 + 2 * BK, (j + 2) % T::kStages);
    cp_async_commit();
    const bool next = j + 1 < ntiles;
    if (next) {
      cp_async_wait<1>();   // tile j + 1 has landed for this thread
      fence_proxy_async();  // ... is visible to wgmma's reads
      __syncthreads();      // ... for every thread
      issue_qk(s_next, j + 1);
    }

    // mask only tiles that cross the diagonal, the window edge or Sk
    const bool whole = k0 + BK - 1 <= qlo && k0 + BK <= Sk && (window <= 0 || k0 > qhi - window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * nt + e] * scale_log2;
        if (!whole) {
          const int kpos = k0 + nt * 8 + tg * 2 + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          const bool ok = kpos < Sk && kpos <= qpos && (window <= 0 || kpos > qpos - window);
          x = ok ? x : kNegInf;
        }
        s[4 * nt + e] = x;
      }
    }

    // online softmax on the fragment, each row's four lanes by shuffles
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float corr = exp2f(m_r[r] - m_new);
      // while every key so far is masked, m_new is still kNegInf and
      // exp2(s - m_new) would be 1: write the exact zero instead; once
      // m_new is finite a masked score's exp2 underflows to exactly 0
      const bool none = m_new == kNegInf;
      m_r[r] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = none ? 0.f : exp2f(s[4 * nt + e] - m_new);
          s[4 * nt + e] = p;
          ps += p;
        }
      }
      l_r[r] = l_r[r] * corr + ps;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[4 * dt + 2 * r] *= corr;
        o[4 * dt + 2 * r + 1] *= corr;
      }
    }

    // O += P V on the tensor cores: P, rounded to bf16, from registers (the
    // score fragments of keys 16 kk .. 16 kk + 15 are wgmma's A fragment);
    // V read transposed from its tile
    const uint32_t v_addr = smem_u32(v_s + (j % T::kStages) * T::kTileBytes);
    wgmma_fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]), pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]),
                             pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]), pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7])};
      wgmma_rs<D>(o, a, make_desc(v_addr + kk * 16 * 128, BK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait0();  // tile j + 1's Q Kᵀ and tile j's P V
    wgmma_fence_regs(o);
    if (next) {
      wgmma_fence_regs(s_next);
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) s[i] = s_next[i];
    }
    __syncthreads();  // tile j's stage is consumed before tile j + 3 lands in it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int qi = q0 + row0 + g + 8 * r;
    if (qi < Sq) {
      bf16* orow = out + b * osb + qi * oss + h * osh + tg * 2;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack_bf16x2(o[4 * dt + 2 * r] * inv, o[4 * dt + 2 * r + 1] * inv);
    }
  }
}

constexpr int kMaxDevices = 64;

// A kernel's dynamic shared-memory limit is set per device: set it once on
// each device (the current one, where the launch goes), so that a launch
// inside a CUDA graph capture makes no other call
template <typename F>
cudaError_t opt_in_smem(F* func, size_t smem, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

template <int D, int BK>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                      int Sk, int H, int KH, const long long* st, int q_offset, int window,
                      float scale, cudaStream_t stream) {
  const size_t smem = Tc<D, BK>::smem_bytes;
  static bool opted_in[kMaxDevices] = {};
  cudaError_t e = opt_in_smem(flash_tc_kernel<D, BK>, smem, opted_in);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Sq + Tc<D, BK>::BQ - 1) / Tc<D, BK>::BQ);
  flash_tc_kernel<D, BK><<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Sq, Sk, H, KH, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], q_offset, window, scale * kLog2e);
  return cudaGetLastError();
}

// -- fp32: the CUDA-core body --------------------------------------------------

constexpr int kBlockK32 = 32;

template <int D, int BQ>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)kBlockK32 * (D + 1) + (size_t)kBlockK32 * D +
         (size_t)BQ * (kBlockK32 + 1);
}

template <int D, int BQ>
__global__ void __launch_bounds__(128) flash_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int Sq, int Sk, int H, int KH,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int q_offset, int window, float scale) {
  constexpr int TPR = 128 / BQ;         // lanes per q row
  constexpr int DPT = D / TPR;          // output columns per lane
  constexpr int KPT = kBlockK32 / TPR;  // keys per lane per tile
  constexpr int DP = D + 1;             // padded rows: conflict-free column reads
  constexpr int PP = kBlockK32 + 1;
  static_assert(128 % BQ == 0 && D % TPR == 0 && kBlockK32 % TPR == 0, "tiling");

  extern __shared__ float smem[];
  float* q_s = smem;                  // BQ * DP
  float* k_s = q_s + BQ * DP;         // kBlockK32 * DP
  float* v_s = k_s + kBlockK32 * DP;  // kBlockK32 * D
  float* p_s = v_s + kBlockK32 * D;   // BQ * PP

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;

  const float* qb = q + b * qsb + h * qsh;
  for (int i = tid; i < BQ * D; i += 128) {
    const int r = i / D;
    const int d = i - r * D;
    const int qi = q0 + r;
    q_s[r * DP + d] = qi < Sq ? qb[qi * qss + d] : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  const int qpos = q0 + row + q_offset;

  const int kend = min(Sk, q0 + BQ + q_offset);
  int kstart = 0;
  if (window > 0) kstart = max(0, q0 + q_offset - window + 1);
  kstart = (kstart / kBlockK32) * kBlockK32;

  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;
  const float* qr = q_s + row * DP;
  float* pr = p_s + row * PP;

  for (int k0 = kstart; k0 < kend; k0 += kBlockK32) {
    __syncthreads();  // the previous tile is fully consumed (and q_s is loaded)
    for (int i = tid; i < kBlockK32 * D; i += 128) {
      const int r = i / D;
      const int d = i - r * D;
      const int t = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < Sk) {
        kx = kb[t * kss + d];
        vx = vb[t * vss + d];
      }
      k_s[r * DP + d] = kx;
      v_s[r * D + d] = vx;
    }
    __syncthreads();

    float s[KPT];
    bool ok[KPT];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int c = sub + TPR * j;
      const int kpos = k0 + c;
      const float* kr = k_s + c * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      ok[j] = kpos < Sk && kpos <= qpos && (window <= 0 || kpos > qpos - window);
      s[j] = ok[j] ? dot * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;  // exact zero when masked
      pr[sub + TPR * j] = p;
      ps += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
    l = l * corr + ps;
    m = m_new;
    __syncwarp();  // a row's lanes share one warp: its p row is complete

#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = sub + TPR * j;
      float a = acc[j] * corr;
#pragma unroll 8
      for (int c = 0; c < kBlockK32; ++c) a += pr[c] * v_s[c * D + d];
      acc[j] = a;
    }
  }

  if (q0 + row < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = out + b * osb + (long long)(q0 + row) * oss + h * osh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[sub + TPR * j] = acc[j] / denom;
  }
}

template <int D, int BQ>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Sk, int H, int KH, const long long* st, int q_offset, int window,
                        float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D, BQ>();
  static bool opted_in[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    cudaError_t e = opt_in_smem(flash_fp32_kernel<D, BQ>, smem, opted_in);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fp32_kernel<D, BQ><<<grid, 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk, H, KH, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], q_offset, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); q, k, v and
// out share it. Strides are in elements: q (b, s, h), k (b, s, kh), v (b, s,
// kh), out (b, s, h). bf16 needs 16-byte aligned q, k, v and row strides
// that are multiples of 8 elements (the 16-byte copies).
extern "C" cudaError_t k2_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out,
    int B, int Sq, int Sk, int H, int KH, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int q_offset, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0) return cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (B * H > 65535) return cudaErrorInvalidValue;
    switch (D) {
      case 64: return launch_fp32<64, 64>(q, k, v, out, B, Sq, Sk, H, KH, st, q_offset, window, scale, s);
      case 128: return launch_fp32<128, 64>(q, k, v, out, B, Sq, Sk, H, KH, st, q_offset, window, scale, s);
      case 256: return launch_fp32<256, 32>(q, k, v, out, B, Sq, Sk, H, KH, st, q_offset, window, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != 1 || (Sq + 63) / 64 > 65535) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8 != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch_tc<64, 64>(q, k, v, out, B, Sq, Sk, H, KH, st, q_offset, window, scale, s);
    case 128: return launch_tc<128, 64>(q, k, v, out, B, Sq, Sk, H, KH, st, q_offset, window, scale, s);
    case 256: return launch_tc<256, 32>(q, k, v, out, B, Sq, Sk, H, KH, st, q_offset, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
