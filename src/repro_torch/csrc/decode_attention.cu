// K1: flash-decode on Hopper. One query token per (batch row, q head)
// against the serving KV arena.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py
// (`_decode_kernel`, launched by `decode_attention_fwd`, wrapped by
// `kernels/ops.py::decode_attention`). Same contract: fp32 online softmax,
// a per-row int `valid` mask, masked probabilities written as exact zeros
// (so an all-invalid row returns 0 with l = 0 and m = -1e30), and
// `normalize = 0` returns the unnormalised partials (acc, m, l) for a
// logsumexp combine.
//
// What bounds it on the card: bytes. Each step reads the whole K and V
// arena once (B * S * KH * D * 2 values) and does 4 * G flops per cached
// value, far below the H100's ~295 flops/byte ridge, so the CUDA cores
// suffice and the design is about keeping HBM busy. The arena is read in
// its model layout (B, S, KH, D) through strides: no step copies it into a
// head-major layout.
//
// Design: two kernels, launched together by the entry point.
// 1. `split_kernel`, grid (B * KH * head groups, n_split): S is cut into
//    splits of kSplit = 256 keys, a length that depends on nothing but
//    itself (never on B or the SM count), so a row's result is the same
//    bits whatever batch it is decoded in. At S = 2048, B = 8, KH = 8 that
//    is 512 blocks on 132 SMs. Each of the 4 warps streams 64 keys of the
//    split with 16-byte loads (a 128-wide bf16 key row is 16 lanes), issuing
//    U rows of K and of V per lane before it uses any of them. q of the
//    grouped heads sits in registers, pre-scaled; a lane's partial dot
//    product is summed over the lanes of its key row by shuffles; each warp
//    keeps an online (m, l, acc) per head. The warps merge in shared
//    memory in a fixed order, and the block writes its fp32 partial
//    (acc, m, l) to a scratch buffer the wrapper allocates.
// 2. `combine_kernel`, one block per (b, h): merges the splits' partials
//    in split order (no atomics), normalised or not.
// Heads are taken in groups of at most 8 (GM), so any G works; G > 8
// re-reads K and V once per group.
//
// Every key of S is read, valid or not, as the Pallas kernel does.
// Skipping wholly invalid splits is a later lever.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 256;               // keys per block; kernels/decode_attention.py::SPLIT_KEYS
constexpr int kWarpKeys = kSplit / kWarps;  // 64
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// the 16 / sizeof(T) values of one 16-byte vector, as floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <typename T, int D, int GM>
struct Plan {
  static constexpr int VEC = 16 / sizeof(T);          // values per 16-byte load
  static constexpr int ROWV = D / VEC;                 // 16-byte vectors per key row
  static constexpr int LPR = ROWV < 32 ? ROWV : 32;    // lanes per key row
  static constexpr int VPL = ROWV / LPR;               // vectors per lane per row
  static constexpr int KPL = 32 / LPR;                 // key rows per warp load
  static constexpr int EPL = VPL * VEC;                // values of a row per lane
  static constexpr int U0 = 16 / GM > 8 ? 8 : 16 / GM;
  static constexpr int U = U0 / VPL > 0 ? U0 / VPL : 1;  // key rows in flight per lane
  static constexpr int CHUNK = U * KPL;                // keys per warp per round
  static_assert(ROWV % LPR == 0 && kWarpKeys % CHUNK == 0, "tiling");
};

template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q,        // (B, H, D) contiguous
    const T* __restrict__ k,        // (B, S, KH, D), last dim contiguous
    const T* __restrict__ v,        // (B, S, KH, D), last dim contiguous
    const int* __restrict__ valid,  // (B, S) contiguous, nonzero = attend
    float* __restrict__ part,       // (B, H, n_split, D + 2): acc, then m and l
    int S, int H, int KH, int G, int n_groups,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    float scale) {
  using P = Plan<T, D, GM>;
  constexpr int VEC = P::VEC, LPR = P::LPR, VPL = P::VPL, KPL = P::KPL, EPL = P::EPL, U = P::U;
  __shared__ float ws_acc[kWarps][GM][D];
  __shared__ float ws_m[kWarps][GM];
  __shared__ float ws_l[kWarps][GM];

  const int grp = blockIdx.x % n_groups;
  const int bkh = blockIdx.x / n_groups;
  const int b = bkh / KH;
  const int kh = bkh - b * KH;
  const int g0 = grp * GM;                  // first head of the group, within the kv head
  const int ng = min(GM, G - g0);           // heads in this group
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPR;  // which vectors of a key row this lane reads
  const int kr = lane / LPR;   // which key row of a warp load

  // q of the group's heads, this lane's values, scaled
  const long long head0 = (long long)b * H + (long long)kh * G + g0;
  float qr[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[g][j * VEC + e] = g < ng ? to_f(q[(head0 + g) * D + (sub + j * LPR) * VEC + e]) * scale : 0.f;

  float m[GM], l[GM], acc[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  const int* valid_b = valid + (long long)b * S;
  const int kbeg = split * kSplit + warp * kWarpKeys;
  const int kstop = min(S, kbeg + kWarpKeys);

  for (int c0 = kbeg; c0 < kstop; c0 += P::CHUNK) {
    // every load of the round first: U rows of K and of V per lane
    uint4 kv[U][VPL], vv[U][VPL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = c0 + u * KPL + kr;
      const bool in = t < S;
      ok[u] = in && valid_b[t] != 0;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int off = (sub + j * LPR) * VEC;
        kv[u][j] = in ? __ldg(reinterpret_cast<const uint4*>(kb + t * kss + off)) : make_uint4(0, 0, 0, 0);
        vv[u][j] = in ? __ldg(reinterpret_cast<const uint4*>(vb + t * vss + off)) : make_uint4(0, 0, 0, 0);
      }
    }
    // scores: a partial dot product per lane, summed over the row's lanes
    float s[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) unpack(kv[u][j], kf + j * VEC, T{});
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qr[g][e] * kf[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][g] = ok[u] ? dot : kNegInf;
      }
    }
    // online softmax over the round, the same (m, corr) on every lane
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) unpack(vv[u][j], vf + j * VEC, T{});
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        // exact zero for a masked key: while m is still kNegInf,
        // exp(s - m) would be exp(0) = 1 of phantom mass
        const float p = ok[u] ? expf(s[u][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += p * vf[e];
      }
    }
  }

  // the warp's key rows hold disjoint keys under one m: add them up
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  }
  if (kr == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) ws_acc[warp][g][(sub + j * LPR) * VEC + e] = acc[g][j * VEC + e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      ws_m[warp][g] = m[g];
      ws_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  // merge the warps in order and write the split's partial
  for (int i = threadIdx.x; i < ng * (D + 2); i += kThreads) {
    const int g = i / (D + 2);
    const int d = i - g * (D + 2);
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, ws_m[w][g]);
    float x;
    if (d == D) {
      x = mw;
    } else {
      x = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        x += (d < D ? ws_acc[w][g][d] : ws_l[w][g]) * expf(ws_m[w][g] - mw);
    }
    part[((head0 + g) * n_split + split) * (D + 2) + d] = x;
  }
}

// one block per (b, h): the splits' partials in split order
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ part, float* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int n_split, int D, int normalize) {
  const long long bh = blockIdx.x;
  const float* pb = part + bh * n_split * (D + 2);
  float mg = kNegInf;
  for (int s = 0; s < n_split; ++s) mg = fmaxf(mg, pb[s * (D + 2) + D]);
  float lg = 0.f;
  for (int s = 0; s < n_split; ++s) lg += pb[s * (D + 2) + D + 1] * expf(pb[s * (D + 2) + D] - mg);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s) a += pb[s * (D + 2) + d] * expf(pb[s * (D + 2) + D] - mg);
    out[bh * D + d] = normalize ? a / fmaxf(lg, 1e-30f) : a;
  }
  if (threadIdx.x == 0) {
    m_out[bh] = mg;
    l_out[bh] = lg;
  }
}

template <typename T, int D, int GM>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* valid, float* part,
                         int B, int S, int H, int KH, int n_split, const long long* st, float scale,
                         cudaStream_t stream) {
  const int G = H / KH;
  const int n_groups = (G + GM - 1) / GM;
  dim3 grid(B * KH * n_groups, n_split);
  split_kernel<T, D, GM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid, part, S,
      H, KH, G, n_groups, st[0], st[1], st[2], st[3], st[4], st[5], scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, const int* valid, float* part,
                       int B, int S, int H, int KH, int n_split, const long long* st, float scale,
                       cudaStream_t stream) {
  const int G = H / KH;
  if (G <= 1) return launch_split<T, D, 1>(q, k, v, valid, part, B, S, H, KH, n_split, st, scale, stream);
  if (G <= 2) return launch_split<T, D, 2>(q, k, v, valid, part, B, S, H, KH, n_split, st, scale, stream);
  if (G <= 4) return launch_split<T, D, 4>(q, k, v, valid, part, B, S, H, KH, n_split, st, scale, stream);
  return launch_split<T, D, 8>(q, k, v, valid, part, B, S, H, KH, n_split, st, scale, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const int* valid, float* part,
                       int B, int S, int H, int KH, int D, int n_split, const long long* st,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return dispatch_g<T, 64>(q, k, v, valid, part, B, S, H, KH, n_split, st, scale, stream);
    case 128: return dispatch_g<T, 128>(q, k, v, valid, part, B, S, H, KH, n_split, st, scale, stream);
    case 256: return dispatch_g<T, 256>(q, k, v, valid, part, B, S, H, KH, n_split, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). `part` is fp32
// scratch of (B, H, n_split, D + 2); `split_keys` must be kSplit and
// n_split = ceil(S / split_keys). k and v must be 16-byte aligned with
// strides that are multiples of 16 bytes.
extern "C" cudaError_t k1_decode_attention(
    int dtype, const void* q, const void* k, const void* v, const void* valid, void* part,
    void* out, void* m, void* l, int B, int S, int H, int KH, int D,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int split_keys, int n_split, float scale, int normalize, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || split_keys != kSplit ||
      n_split != (S + kSplit - 1) / kSplit || n_split > 65535)
    return cudaErrorInvalidValue;
  const long long st[6] = {ksb, kss, ksh, vsb, vss, vsh};
  const int vec = dtype == 0 ? 4 : 8;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) return cudaErrorInvalidValue;
  for (int i = 0; i < 6; ++i)
    if (st[i] % vec != 0) return cudaErrorInvalidValue;
  const int* vm = static_cast<const int*>(valid);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float>(q, k, v, vm, pt, B, S, H, KH, D, n_split, st, scale, s);
  else if (dtype == 1)
    e = dispatch_d<__nv_bfloat16>(q, k, v, vm, pt, B, S, H, KH, D, n_split, st, scale, s);
  else
    return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  combine_kernel<<<B * H, kThreads, 0, s>>>(pt, static_cast<float*>(out), static_cast<float*>(m),
                                            static_cast<float*>(l), n_split, D, normalize);
  return cudaGetLastError();
}
