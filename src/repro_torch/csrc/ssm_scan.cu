// K3: the chunked SSD scan on Hopper (mLSTM and Mamba-2 prefill).
//
// Replaces the Pallas kernel src/repro/kernels/ssm_scan.py (`_ssd_kernel`,
// launched by `ssm_scan_fwd`, wrapped by `kernels/ops.py::ssm_scan`). Same
// contract: per (batch * head) row and per chunk of L steps,
//   cum = cumsum(loga)
//   y   = (C B^T o exp(cum_t - cum_s) o tril) X + (C exp(cum)) h
//   h  <- exp(cum_L) h + (B exp(cum_L - cum))^T X
// from h = 0, all in fp32 whatever the input types; y in x's dtype, the
// final h in fp32. x and c are bf16 or fp32 alike, b either (the mLSTM
// path hands b = k * igate in fp32), loga fp32; rows of P may be odd
// (mLSTM's P = head_dim + 1), so nothing assumes aligned rows.
//
// What bounds it on the card: at the mLSTM prefill shapes (BH = 4, S =
// 1024, P = 513, N = 512, L = 256) the work is ~5.4 GFLOP (C B^T and W X
// on the causal half) against ~25 MB of inputs and outputs, ~210 flops
// per byte, under the H100's bf16 ridge (~295), so bytes would bound a
// bf16 tensor-core kernel; the products are done in fp32 here, and on the
// CUDA cores (67 TFLOP/s) operations bound it by far. The state h (N x P fp32 = 1.05 MB) that the
// Pallas kernel keeps in VMEM does not fit in a block's 227 KB of shared
// memory, and the L x L decay matrix (256 KB fp32) does not either.
//
// Design, two grids launched back to back by one entry point:
//  1. `intra_weights_kernel` forms W = C B^T o decay o tril for every
//     (row, chunk) in 64 x 64 tiles (tiles above the diagonal skipped) and
//     writes it, transposed, to a scratch buffer the wrapper allocates
//     (BH * K * L * L fp32, 4 MB at the shapes above; it stays in L2).
//     So W is formed once, not once per column tile of grid 2.
//  2. `scan_kernel`: one block per (row, 32 columns of P). Columns of P
//     are independent (column p of y and h depends only on column p of X
//     and h), so the state tile h[:, p0:p0+32] lives in shared memory for
//     the whole sequence, and a loop over the chunks inside the block
//     replaces the TPU's sequential chunk grid axis. Per chunk: the block
//     prefix-sums loga, stages the x tile, computes y one row per thread
//     (C streamed through shared memory in 32-wide n tiles, W read from
//     the scratch, coalesced, only up to the warp's causal edge), then
//     updates h one state row per thread. The ragged P tail is masked.
//
// Left for later: 68 blocks on 132 SMs at the shapes above; the inner
// loops run on the fp32 CUDA cores from shared memory (no mma/wgmma, no
// TMA or cp.async overlap); grid 2 reads B and C once per column tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 32;              // columns of P per scan block
constexpr int kPadP = kTileP + 4;       // shared row stride of the x and h tiles (keeps float4 alignment)
constexpr int kTileN = 32;              // n tile of C staged for the carried-state term
constexpr int kStage = kTileN + 1;      // shared row stride of the staged C (and y) tile
constexpr int kTileW = 64;              // W tile edge (t and s)
constexpr int kTileWN = 32;             // reduction step over N for a W tile
constexpr int kMaxChunk = 4 * kThreads; // the block prefix sum holds 4 values per thread

static_assert(kTileN == kTileP, "the staged C tile also stages the y tile");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Inclusive prefix sum of la[0, L) into cum[0, L) in shared memory, by
// log-step doubling. Every thread of the block calls it; it ends on a
// barrier.
__device__ void chunk_cumsum(const float* __restrict__ la, float* cum, int L) {
  const int tid = threadIdx.x;
  for (int i = tid; i < L; i += kThreads) cum[i] = la[i];
  __syncthreads();
  for (int off = 1; off < L; off <<= 1) {
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = tid + r * kThreads;
      v[r] = (i < L && i >= off) ? cum[i - off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = tid + r * kThreads;
      if (i < L) cum[i] += v[r];
    }
    __syncthreads();
  }
}

// wt[row][k][s][t] = (s <= t) * exp(min(cum_t - cum_s, 0)) * sum_n c[t][n] b[s][n]
// for one 64 x 64 (t, s) tile on or below the diagonal of chunk k.
template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads) intra_weights_kernel(
    const float* __restrict__ loga,  // (BH, S)
    const TB* __restrict__ b,        // (BH, S, N)
    const TX* __restrict__ c,        // (BH, S, N)
    float* __restrict__ wt,          // (BH, K, L, L): [s][t]
    int S, int N, int L) {
  const int tiles = (L + kTileW - 1) / kTileW;
  const int tt = blockIdx.x / tiles;
  const int st = blockIdx.x - tt * tiles;
  if (st > tt) return;  // above the diagonal: all zero, never read
  const int k = blockIdx.y;
  const int row = blockIdx.z;
  const int K = S / L;
  __shared__ float cum[kMaxChunk];
  __shared__ __align__(16) float cs[kTileWN][kTileW + 4];
  __shared__ __align__(16) float bs[kTileWN][kTileW + 4];
  const long long step0 = (long long)row * S + (long long)k * L;  // first step of the chunk
  chunk_cumsum(loga + step0, cum, L);

  const int t0 = tt * kTileW, s0 = st * kTileW;
  const int tx = threadIdx.x % 16;  // t = t0 + 4 tx + i
  const int ty = threadIdx.x / 16;  // s = s0 + 4 ty + j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kTileWN) {
    for (int e = threadIdx.x; e < kTileW * kTileWN; e += kThreads) {
      const int r = e / kTileWN;
      const int nn = e - r * kTileWN;
      const int n = n0 + nn;
      const int t = t0 + r, s = s0 + r;
      cs[nn][r] = (t < L && n < N) ? to_f(c[(step0 + t) * N + n]) : 0.f;
      bs[nn][r] = (s < L && n < N) ? to_f(b[(step0 + s) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < kTileWN; ++nn) {
      const float4 cv = *reinterpret_cast<const float4*>(&cs[nn][4 * tx]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[nn][4 * ty]);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
      const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ca[i] * ba[j];
    }
    __syncthreads();
  }

  float* w = wt + ((long long)row * K + k) * L * L;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = s0 + 4 * ty + j;
    if (s >= L) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 4 * tx + i;
      if (t >= L) continue;
      w[(long long)s * L + t] = (s <= t) ? acc[i][j] * expf(fminf(cum[t] - cum[s], 0.f)) : 0.f;
    }
  }
}

// acc[0, 32) += a * row[0, 32), row 16-byte aligned in shared memory
__device__ __forceinline__ void axpy32(float* acc, float a, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < kTileP / 4; ++q) {
    const float4 v = r4[q];
    acc[4 * q] += a * v.x;
    acc[4 * q + 1] += a * v.y;
    acc[4 * q + 2] += a * v.z;
    acc[4 * q + 3] += a * v.w;
  }
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads) scan_kernel(
    const TX* __restrict__ x,        // (BH, S, P)
    const float* __restrict__ loga,  // (BH, S)
    const TB* __restrict__ b,        // (BH, S, N)
    const TX* __restrict__ c,        // (BH, S, N)
    const float* __restrict__ wt,    // (BH, K, L, L) from intra_weights_kernel
    TX* __restrict__ y,              // (BH, S, P)
    float* __restrict__ hout,        // (BH, N, P)
    int S, int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                     // N x kPadP: the state tile
  float* x_s = h_s + N * kPadP;          // L x kPadP: this chunk's x tile
  float* st_s = x_s + L * kPadP;         // kThreads x kStage: staged C tile, then y tile
  float* cum = st_s + kThreads * kStage; // L
  float* e_in = cum + L;                 // L: exp(cum_t)
  float* e_out = e_in + L;               // L: exp(cum_L - cum_s)

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int p0 = blockIdx.x * kTileP;
  const int np = min(kTileP, P - p0);
  const int K = S / L;
  for (int i = tid; i < N * kPadP; i += kThreads) h_s[i] = 0.f;

  for (int k = 0; k < K; ++k) {
    const long long step0 = (long long)row * S + (long long)k * L;
    __syncthreads();  // the previous chunk is done with cum, x_s and h_s
    chunk_cumsum(loga + step0, cum, L);
    const float total = cum[L - 1];
    for (int i = tid; i < L; i += kThreads) {
      e_in[i] = expf(cum[i]);
      e_out[i] = expf(total - cum[i]);
    }
    for (int e = tid; e < L * kTileP; e += kThreads) {
      const int s = e / kTileP;
      const int p = e - s * kTileP;
      x_s[s * kPadP + p] = p < np ? to_f(x[(step0 + s) * P + p0 + p]) : 0.f;
    }
    __syncthreads();

    // y = exp(cum_t) (C h)_t + sum_{s <= t} W[t][s] x_s, one row t per
    // thread, in blocks of kThreads rows
    const float* w = wt + ((long long)row * K + k) * L * L;
    for (int t0 = 0; t0 < L; t0 += kThreads) {
      const int t = t0 + tid;
      const bool live = t < L;
      float acc[kTileP];
#pragma unroll
      for (int p = 0; p < kTileP; ++p) acc[p] = 0.f;
      for (int n0 = 0; n0 < N; n0 += kTileN) {
        __syncthreads();  // the staging tile is free
        for (int e = tid; e < kThreads * kTileN; e += kThreads) {
          const int r = e / kTileN;
          const int nn = e - r * kTileN;
          const int tr = t0 + r, n = n0 + nn;
          st_s[r * kStage + nn] = (tr < L && n < N) ? to_f(c[(step0 + tr) * N + n]) : 0.f;
        }
        __syncthreads();
        if (live) {
          const int nmax = min(kTileN, N - n0);
          for (int nn = 0; nn < nmax; ++nn)
            axpy32(acc, st_s[tid * kStage + nn], h_s + (n0 + nn) * kPadP);
        }
      }
      if (live) {
        const float ei = e_in[t];
#pragma unroll
        for (int p = 0; p < kTileP; ++p) acc[p] *= ei;
        // W is zero above the diagonal; the bound is uniform across a warp
        const int s_end = min(L, (t | 31) + 1);
#pragma unroll 4
        for (int s = 0; s < s_end; ++s) axpy32(acc, w[(long long)s * L + t], x_s + s * kPadP);
      }
      __syncthreads();  // every thread is done reading the staged C tile
      if (live) {
#pragma unroll
        for (int p = 0; p < kTileP; ++p) st_s[tid * kStage + p] = acc[p];
      }
      __syncthreads();
      for (int e = tid; e < kThreads * kTileP; e += kThreads) {
        const int r = e / kTileP;
        const int p = e - r * kTileP;
        const int tr = t0 + r;
        if (tr < L && p < np) y[(step0 + tr) * P + p0 + p] = from_f<TX>(st_s[r * kStage + p]);
      }
    }
    __syncthreads();  // y used the old h

    // h = exp(cum_L) h + sum_s b_s exp(cum_L - cum_s) x_s, one state row n
    // per thread
    const float ea = expf(total);
    for (int n = tid; n < N; n += kThreads) {
      float acc[kTileP];
      float* hr = h_s + n * kPadP;
#pragma unroll
      for (int p = 0; p < kTileP; ++p) acc[p] = ea * hr[p];
#pragma unroll 4
      for (int s = 0; s < L; ++s) axpy32(acc, to_f(b[(step0 + s) * N + n]) * e_out[s], x_s + s * kPadP);
#pragma unroll
      for (int p = 0; p < kTileP; ++p) hr[p] = acc[p];
    }
  }
  __syncthreads();
  for (int e = tid; e < N * kTileP; e += kThreads) {
    const int n = e / kTileP;
    const int p = e - n * kTileP;
    if (p < np) hout[((long long)row * N + n) * P + p0 + p] = h_s[n * kPadP + p];
  }
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const float* loga, const void* b, const void* c, void* y,
                   float* h, float* wt, int BH, int S, int P, int N, int L, cudaStream_t stream) {
  const int K = S / L;
  const int tiles = (L + kTileW - 1) / kTileW;
  intra_weights_kernel<TX, TB><<<dim3(tiles * tiles, K, BH), kThreads, 0, stream>>>(
      loga, static_cast<const TB*>(b), static_cast<const TX*>(c), wt, S, N, L);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(float) * ((size_t)(N + L) * kPadP + kThreads * kStage + 3 * L);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(scan_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  scan_kernel<TX, TB><<<dim3((P + kTileP - 1) / kTileP, BH), kThreads, smem, stream>>>(
      static_cast<const TX*>(x), loga, static_cast<const TB*>(b), static_cast<const TX*>(c), wt,
      static_cast<TX*>(y), h, S, P, N, L);
  return cudaGetLastError();
}

}  // namespace

// x_dtype (x, c, y) and b_dtype: 0 = float32, 1 = bfloat16. Every tensor
// contiguous; wt is scratch of BH * (S / L) * L * L floats.
extern "C" cudaError_t k3_ssm_scan(int x_dtype, int b_dtype, const void* x, const void* loga,
                                   const void* b, const void* c, void* y, void* h, void* wt,
                                   int BH, int S, int P, int N, int L, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || P <= 0 || N <= 0 || L <= 0 || L > kMaxChunk ||
      S % L != 0 || S / L > 65535)
    return cudaErrorInvalidValue;
  const float* la = static_cast<const float*>(loga);
  float* hh = static_cast<float*>(h);
  float* ww = static_cast<float*>(wt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && b_dtype == 0)
    return launch<float, float>(x, la, b, c, y, hh, ww, BH, S, P, N, L, st);
  if (x_dtype == 0 && b_dtype == 1)
    return launch<float, __nv_bfloat16>(x, la, b, c, y, hh, ww, BH, S, P, N, L, st);
  if (x_dtype == 1 && b_dtype == 0)
    return launch<__nv_bfloat16, float>(x, la, b, c, y, hh, ww, BH, S, P, N, L, st);
  if (x_dtype == 1 && b_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, la, b, c, y, hh, ww, BH, S, P, N, L, st);
  return cudaErrorInvalidValue;
}
