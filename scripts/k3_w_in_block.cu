// K3 with W formed inside each output block: the other placement of the
// intra-chunk weights W = C B^T o exp(cum_t - cum_s) o tril, beside the one
// src/repro_torch/csrc/ssm_scan.cu keeps (weights blocks in the first launch
// form each 64 x 64 tile of W once into a scratch buffer, and the output
// blocks read it back). Here the first launch runs the states blocks only,
// and each output block (row, chunk, 64 rows of t, 64 columns of P) forms
// the W tiles of its rows itself, 64 columns of s at a time, into shared
// memory, before it multiplies them into X. Every W value is the same
// expression in the same order as the weights blocks', and W X takes the
// same stages in the same order, so y and h equal the kernel's bit for bit.
//
// A probe, not a path of the port: bf16 x and c with fp32 b only (the
// mLSTM prefill). scripts/k3_w_placement.py builds it (K3W_MIN_BLOCKS, the
// blocks an SM the launch bounds ask for, 2 or 3) and times it against the
// kernel. The same library exports the kernel's own entry point.

#include "../src/repro_torch/csrc/ssm_scan.cu"

#ifndef K3W_MIN_BLOCKS
#define K3W_MIN_BLOCKS 2
#endif

namespace {

template <typename TX, typename TB>
struct SmemW {
  using M = Smem<TX, TB>;
  // one ring stage: C h (c, h), forming W (c, b) or W X (x)
  static constexpr int kStage = cmax(M::kYC + M::kYH, cmax(M::kWC + M::kWB, M::kYX));
  static constexpr int kRing = kStages * kStage;
  // W tile of 64 t x 64 s as two halves of 32 s, read as the kernel reads its staged W
  static constexpr int kW = 2 * kTile * kStrideK * (int)sizeof(float);
};

// y[t0:t0+64, p0:p0+64] of one chunk: exp(cum_t) (C h_entering) + W X, W
// formed here.
template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, K3W_MIN_BLOCKS) pass_outputs_wblock(
    const TX* __restrict__ x, const float* __restrict__ loga, const TB* __restrict__ b,
    const TX* __restrict__ c, const float* __restrict__ hs, TX* __restrict__ y, int S, int P, int N, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  using M = Smem<TX, TB>;
  using W = SmemW<TX, TB>;
  constexpr int SH = IdxStride<float>::v, SX = IdxStride<TX>::v;
  const int K = S / L;
  const int BH = gridDim.z / K;
  const int p0 = blockIdx.x * kTile, t0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int k = K - 1 - blockIdx.z / BH, row = blockIdx.z % BH;
  const long long step0 = (long long)row * S + (long long)k * L;
  const int steps1 = k > 0 ? (N + kStep - 1) / kStep : 0;  // over n: C h
  const int wsteps = (N + kStep - 1) / kStep;              // over n: one W tile
  const int send = min(L, t0 + kTile);                     // W X over s < send
  const int stiles = (send + kTile - 1) / kTile;
  auto xsteps = [&](int st) { return (min(send, st * kTile + kTile) - st * kTile + kStep - 1) / kStep; };
  int steps = steps1;
  for (int st = 0; st < stiles; ++st) steps += wsteps + xsteps(st);
  // stage i past C h: s tile st, its stage j (j < wsteps: forming W)
  auto locate = [&](int i, int& st, int& j) {
    j = i - steps1;
    for (st = 0; j >= wsteps + xsteps(st); ++st) j -= wsteps + xsteps(st);
  };
  const float* hk = k > 0 ? hs + ((long long)row * (K - 1) + (k - 1)) * N * P : hs;
  float* wsm = reinterpret_cast<float*>(smem + W::kRing);
  double* cum = reinterpret_cast<double*>(smem + W::kRing + W::kW);
  double* tot = cum + L;
  const Lane ln;
  const int mhi = min(2, max(0, (L - t0 - ln.wm + 15) / 16));
  const int nhi = P - p0 > ln.wn ? 4 : 0;
  Acc<TX> acc[2][4][4] = {};
  Acc<TX> accw[2][4][4] = {};
  auto issue = [&](int i) {
    unsigned char* st_ = smem + (i % kStages) * W::kStage;
    if (i < steps1) {
      stage_tile<kTile, kStep>(reinterpret_cast<TX*>(st_), kStrideK, c + step0 * N, N, t0, L, i * kStep, N);
      stage_tile<kStep, kTile>(reinterpret_cast<float*>(st_ + M::kYC), SH, hk, P, i * kStep, N, p0, P);
    } else if (i < steps) {
      int st, j;
      locate(i, st, j);
      if (j < wsteps) {
        stage_tile<kTile, kStep>(reinterpret_cast<TX*>(st_), kStrideK, c + step0 * N, N, t0, L, j * kStep, N);
        stage_tile<kTile, kStep>(reinterpret_cast<TB*>(st_ + M::kWC), kStrideK, b + step0 * N, N, st * kTile, L,
                                 j * kStep, N);
      } else {
        stage_tile<kStep, kTile>(reinterpret_cast<TX*>(st_), SX, x + step0 * P, P,
                                 st * kTile + (j - wsteps) * kStep, L, p0, P);
      }
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
    const unsigned char* st_ = smem + (i % kStages) * W::kStage;
    if (i < steps1) {
      const TX* cs = reinterpret_cast<const TX*>(st_);
      const float* hsm = reinterpret_cast<const float*>(st_ + M::kYC);
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
    int st, j;
    locate(i, st, j);
    if (j < wsteps) {
      const TX* cs = reinterpret_cast<const TX*>(st_);
      const TB* bs = reinterpret_cast<const TB*>(st_ + M::kWC);
      // A (t, n) = c[t][n]; B (n, s) = b[s][n], as the weights blocks take it
      mma_stage<kPartsOf<TX, TX>, kPartsOf<TX, TB>, false>(
          accw, 0, 2, 4,
          [&](int kk, float(&v)[2][4]) { frag_a_kmajor(v, cs, kk, ln); },
          [&](int kk, float(&v)[4][2]) { frag_b_kmajor(v, bs, kk, ln); });
      if (j == wsteps - 1) {  // the tile is complete: decay, mask, into shared memory
        const int s0 = st * kTile;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tl = ln.wm + 16 * mi + ln.g + 8 * h, t = t0 + tl;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const int sl = ln.wn + 8 * ni + 2 * ln.q, s = s0 + sl;
              float v[2];
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                v[jj] = (t < L && s + jj <= t) ? static_cast<float>(accw[mi][ni][2 * h + jj] *
                                                                    static_cast<Acc<TX>>(exp(fmin(cum[t] - cum[s + jj], 0.0))))
                                               : 0.f;
                accw[mi][ni][2 * h + jj] = 0;
              }
              st2(wsm + (sl / kStep) * kTile * kStrideK + tl * kStrideK + sl % kStep, v[0], v[1]);
            }
          }
      }
      continue;  // the next stage's barrier orders these stores before W X reads them
    }
    const int half = j - wsteps;
    const float* ws = wsm + half * kTile * kStrideK;
    const TX* xs = reinterpret_cast<const TX*>(st_);
    const int mlo = max(0, min(2, (st * kTile + half * kStep - t0 - ln.wm) / 16));
    // A (t, s) = W[t][s]; B (s, p) = x[s][p]
    mma_stage<kParts<TX>, kPartsOf<TX, TX>, false>(
        acc, mlo, mhi, nhi,
        [&](int kk, float(&v)[2][4]) { frag_a_kmajor(v, ws, kk, ln); },
        [&](int kk, float(&v)[4][2]) { frag_b_idx_perm(v, xs, SX, kk, ln); });
  }
  cp_async_wait<0>();
  store_acc_colperm(acc, ln, y + step0 * P, P, t0, L, p0, P);
}

}  // namespace

// The kernel's entry point and arguments (w is not used); bf16 x and c with
// fp32 b only.
extern "C" cudaError_t k3_ssm_scan_w_in_block(int x_dtype, int b_dtype, const void* x, const void* loga,
                                              const void* b, const void* c, void* y, void* h, void* hs, void* w,
                                              int BH, int S, int P, int N, int L, void* stream) {
  using TX = __nv_bfloat16;
  using TB = float;
  using M = Smem<TX, TB>;
  using W = SmemW<TX, TB>;
  (void)w;
  if (x_dtype != 1 || b_dtype != 0 || BH <= 0 || S <= 0 || P <= 0 || N <= 0 || L <= 0 || L > kMaxChunk ||
      S % L != 0 || P % 8 != 0 || N % 8 != 0 || (long long)BH * (S / L) > 65535)
    return cudaErrorInvalidValue;
  static bool opted1[kMaxDevices], opted2[kMaxDevices];
  cudaError_t e = opt_in_smem(pass_states_weights<TX, TB>, M::kRing1 + scan_bytes(kMaxChunk), opted1);
  if (e != cudaSuccess) return e;
  e = opt_in_smem(pass_outputs_wblock<TX, TB>, W::kRing + W::kW + scan_bytes(kMaxChunk), opted2);
  if (e != cudaSuccess) return e;
  const int K = S / L, T = (L + kTile - 1) / kTile;
  const int ptiles = (P + kTile - 1) / kTile, ntiles = (N + kTile - 1) / kTile;
  const int states_blocks = BH * ntiles * ptiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TX* xx = static_cast<const TX*>(x);
  const TB* bb = static_cast<const TB*>(b);
  const TX* cc = static_cast<const TX*>(c);
  const float* la = static_cast<const float*>(loga);
  float* hsc = static_cast<float*>(hs);
  // the states blocks alone: the grid ends before the first weights block
  pass_states_weights<TX, TB><<<states_blocks, kThreads, M::kRing1 + scan_bytes(L), st>>>(
      xx, la, bb, cc, hsc, static_cast<float*>(h), nullptr, states_blocks, S, P, N, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  pass_outputs_wblock<TX, TB><<<dim3(ptiles, T, BH * K), kThreads, W::kRing + W::kW + scan_bytes(L), st>>>(
      xx, la, bb, cc, hsc, static_cast<TX*>(y), S, P, N, L);
  return cudaGetLastError();
}
