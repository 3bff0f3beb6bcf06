// K2: causal flash-attention forward on Hopper, for prefill.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (`_flash_kernel`, launched by `flash_attention_fwd`, wrapped by
// `kernels/ops.py::flash_attention`). Same function: causal attention with
// a query offset `q_offset`, an optional sliding window and GQA (kv head
// = h / (H / KH)); fp32 running max, normaliser and accumulator; kv tiles
// wholly in the causal future or outside the window are skipped.
//
// Unlike the Pallas kernel, masked probabilities are written as exact
// zeros. The Pallas body computes exp(s - m_new) for masked entries too,
// which under a window gives a row whose first visited tile is fully
// masked a phantom weight of 1 per key (cancelled there only because a
// later tile always follows).
//
// What bounds it on the card: at prefill (Sq = Sk = 1024, H = 16, D = 128)
// the work is ~4.3 GFLOP over ~12.6 MB, about 340 flops per byte, close to
// the H100's bf16 ridge (~295). This first version does its products on
// the fp32 CUDA cores (67 TFLOP/s peak), so it is compute-bound far below
// the tensor-core bound.
//
// Design: one block of 128 threads per (b * H + h, q tile of BQ rows);
// BQ = 64 for D <= 128 and 32 for D = 256, so the q tile, one 32-key K/V
// tile and the probabilities fit in dynamic shared memory. TPR = 128 / BQ
// neighbouring lanes share a q row: each scores every TPR-th key of the
// tile and owns every TPR-th output column in registers. Q, K and V are
// read in the model layout (B, S, heads, D) through strides, so the caller
// never transposes them.
//
// Left for later: wgmma on bf16 tiles (the tensor cores), TMA loads with a
// multi-stage mbarrier pipeline, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D, int BQ>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)kBlockK * (D + 1) + (size_t)kBlockK * D +
         (size_t)BQ * (kBlockK + 1);
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q,  // (B, Sq, H, D), last dim contiguous
    const T* __restrict__ k,  // (B, Sk, KH, D), last dim contiguous
    const T* __restrict__ v,  // (B, Sk, KH, D), last dim contiguous
    T* __restrict__ out,      // (B, Sq, H, D), last dim contiguous
    int Sq, int Sk, int H, int KH,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int q_offset, int window, float scale) {
  constexpr int TPR = kThreads / BQ;  // lanes per q row
  constexpr int DPT = D / TPR;        // output columns per lane
  constexpr int KPT = kBlockK / TPR;  // keys per lane per tile
  constexpr int DP = D + 1;           // padded rows: conflict-free column reads
  constexpr int PP = kBlockK + 1;
  static_assert(kThreads % BQ == 0 && D % TPR == 0 && kBlockK % TPR == 0, "tiling");

  extern __shared__ float smem[];
  float* q_s = smem;               // BQ * DP
  float* k_s = q_s + BQ * DP;      // kBlockK * DP
  float* v_s = k_s + kBlockK * DP; // kBlockK * D
  float* p_s = v_s + kBlockK * D;  // BQ * PP

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;

  const T* qb = q + b * qsb + h * qsh;
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int qi = q0 + r;
    q_s[r * DP + d] = qi < Sq ? to_f(qb[qi * qss + d]) : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  const int qpos = q0 + row + q_offset;

  // kv tiles this q tile can see: causal end, window start
  const int kend = min(Sk, q0 + BQ + q_offset);
  int kstart = 0;
  if (window > 0) kstart = max(0, q0 + q_offset - window + 1);
  kstart = (kstart / kBlockK) * kBlockK;

  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  const float* qr = q_s + row * DP;
  float* pr = p_s + row * PP;

  for (int k0 = kstart; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed (and q_s is loaded)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int t = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < Sk) {
        kx = to_f(kb[t * kss + d]);
        vx = to_f(vb[t * vss + d]);
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
      for (int c = 0; c < kBlockK; ++c) a += pr[c] * v_s[c * D + d];
      acc[j] = a;
    }
  }

  if (q0 + row < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + b * osb + (long long)(q0 + row) * oss + h * osh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[sub + TPR * j] = from_f<T>(acc[j] / denom);
  }
}

template <typename T, int D, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Sk, int H, int KH, const long long* st, int q_offset, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D, BQ>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<T, D, BQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KH, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], q_offset, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
                       int Sq, int Sk, int H, int KH, int D, const long long* st,
                       int q_offset, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64, 64>(q, k, v, out, B, Sq, Sk, H, KH, st, q_offset, window, scale, stream);
    case 128:
      return launch<T, 128, 64>(q, k, v, out, B, Sq, Sk, H, KH, st, q_offset, window, scale, stream);
    case 256:
      return launch<T, 256, 32>(q, k, v, out, B, Sq, Sk, H, KH, st, q_offset, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Strides are
// in elements: q (b, s, h), k (b, s, kh), v (b, s, kh), out (b, s, h).
extern "C" cudaError_t k2_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out,
    int B, int Sq, int Sk, int H, int KH, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int q_offset, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 || B * H > 65535)
    return cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, B, Sq, Sk, H, KH, D, st, q_offset, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KH, D, st, q_offset,
                                     window, scale, s);
  return cudaErrorInvalidValue;
}
