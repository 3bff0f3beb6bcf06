// K1: flash-decode on Hopper. One query token per (batch row, kv head)
// against the serving KV arena.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py
// (`_decode_kernel`, launched by `decode_attention_fwd`, wrapped by
// `kernels/ops.py::decode_attention`). Same contract: fp32 online softmax,
// a per-row int `valid` mask, masked probabilities written as exact zeros
// (so an all-invalid row returns 0 with l = 0), and `normalize = 0` returns
// the unnormalised partials (acc, m, l) for a logsumexp combine.
//
// What bounds it on the card: bytes. Each step reads the whole K and V
// arena once (B * S * KH * D * 2 values) and does 4 * G flops per cached
// value, far below the H100's ~295 flops/byte ridge. The design therefore
// reads the arena in its model layout (B, S, KH, D) through strides, so no
// step copies the cache into a head-major layout, and keeps q, the running
// (m, l, acc) state and the current K/V tile in shared memory.
//
// Design: one block of 128 threads per (b, kh). The sequential `ki` grid
// axis of the Pallas kernel becomes a loop over 32-key tiles inside the
// block; the S % 32 remainder is masked like padding. With B = 8 and
// KH = 8 that is 64 blocks on 132 SMs.
//
// Left for later: splitting S across blocks and combining with the
// partials contract (fills the SMs), cp.async/TMA double buffering of the
// tiles, 16-byte vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;  // one key per lane in the softmax phase
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q,          // (B, H, D) contiguous
    const T* __restrict__ k,          // (B, S, KH, D), last dim contiguous
    const T* __restrict__ v,          // (B, S, KH, D), last dim contiguous
    const int* __restrict__ valid,    // (B, S) contiguous, nonzero = attend
    float* __restrict__ out,          // (B, H, D)
    float* __restrict__ m_out,        // (B, H)
    float* __restrict__ l_out,        // (B, H)
    int S, int H, int KH, int D,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    float scale, int normalize) {
  extern __shared__ float smem[];
  const int G = H / KH;
  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x - b * KH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int DP = D + 1;  // padded K row: lane r reads bank (r + d) % 32

  float* q_s = smem;                   // G * D
  float* acc_s = q_s + G * D;          // G * D
  float* k_s = acc_s + G * D;          // kBlockK * DP
  float* v_s = k_s + kBlockK * DP;     // kBlockK * D
  float* p_s = v_s + kBlockK * D;      // G * kBlockK
  float* m_s = p_s + G * kBlockK;      // G
  float* l_s = m_s + G;                // G
  float* c_s = l_s + G;                // G: this tile's rescale factor
  int* ok_s = reinterpret_cast<int*>(c_s + G);  // kBlockK

  const long long head0 = (long long)b * H + (long long)kh * G;
  const T* qb = q + head0 * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f(qb[i]);
    acc_s[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  const int* valid_b = valid + (long long)b * S;

  for (int t0 = 0; t0 < S; t0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int t = t0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < S) {
        kx = to_f(kb[t * kss + d]);
        vx = to_f(vb[t * vss + d]);
      }
      k_s[r * DP + d] = kx;
      v_s[r * D + d] = vx;
    }
    if (tid < kBlockK) {
      const int t = t0 + tid;
      ok_s[tid] = (t < S) && (valid_b[t] != 0);
    }
    __syncthreads();

    // scores s[g][r] = q_g . k_r * scale
    for (int i = tid; i < G * kBlockK; i += kThreads) {
      const int g = i / kBlockK;
      const int r = i - g * kBlockK;
      const float* qg = q_s + g * D;
      const float* kr = k_s + r * DP;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qg[d] * kr[d];
      p_s[i] = s * scale;
    }
    __syncthreads();

    // online softmax: one warp per q head of the group, one key per lane
    for (int g = warp; g < G; g += kThreads / 32) {
      const bool ok = ok_s[lane] != 0;
      const float s = ok ? p_s[g * kBlockK + lane] : kNegInf;
      float mx = s;
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      // exact zero for a masked key: while m_new is still kNegInf,
      // exp(s - m_new) would be exp(0) = 1 of phantom mass
      const float p = ok ? expf(s - m_new) : 0.f;
      float ps = p;
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      p_s[g * kBlockK + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + ps;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * corr + sum_r p[g][r] v[r][d]; each thread owns
    // the same (g, d) entries on every tile
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = p_s + g * kBlockK;
      float a = acc_s[i] * c_s[g];
      for (int r = 0; r < kBlockK; ++r) a += pg[r] * v_s[r * D + d];
      acc_s[i] = a;
    }
  }
  __syncthreads();

  float* ob = out + head0 * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float a = acc_s[i];
    if (normalize) a = a / fmaxf(l_s[g], 1e-30f);
    ob[i] = a;
  }
  if (tid < G) {
    m_out[head0 + tid] = m_s[tid];
    l_out[head0 + tid] = l_s[tid];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* valid,
                   float* out, float* m, float* l, int B, int S, int H, int KH, int D,
                   long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh,
                   float scale, int normalize, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = sizeof(float) *
      (2 * G * D + kBlockK * (D + 1) + kBlockK * D + G * kBlockK + 3 * G + kBlockK);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_kernel<T><<<B * KH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid,
      out, m, l, S, H, KH, D, ksb, kss, ksh, vsb, vss, vsh, scale, normalize);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it).
extern "C" cudaError_t k1_decode_attention(
    int dtype, const void* q, const void* k, const void* v, const void* valid,
    void* out, void* m, void* l, int B, int S, int H, int KH, int D,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    float scale, int normalize, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || D > 256)
    return cudaErrorInvalidValue;
  const int* vm = static_cast<const int*>(valid);
  float* o = static_cast<float*>(out);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, vm, o, mm, ll, B, S, H, KH, D, ksb, kss, ksh,
                         vsb, vss, vsh, scale, normalize, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, vm, o, mm, ll, B, S, H, KH, D, ksb, kss,
                                 ksh, vsb, vss, vsh, scale, normalize, st);
  return cudaErrorInvalidValue;
}
