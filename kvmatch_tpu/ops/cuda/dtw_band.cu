// Banded DTW for Hopper: one warp per candidate window, the band in registers.
//
// The DP runs by anti-diagonals s = i + j with band offset k = j - i + r:
//
//     D_s[k] = (a[i] - q[j])^2 + min(D_{s-1}[k-1], D_{s-1}[k+1], D_{s-2}[k])
//
// so every cell of a diagonal depends only on the two previous diagonals.
// Lane l holds cells k = l*CPL .. l*CPL + CPL - 1; the k +- 1 neighbours at a
// lane boundary arrive by warp shuffle.  The a/q operands move systolically:
// the a value of cell k at step s is the a value of cell k - 1 at step s - 1
// (and the q value of cell k + 1), so each step loads one new a (entering at
// k = 0) and one new q (entering at the top cell) instead of 2*W.
//
// Cells with (s + k - r) odd are not grid points.  They are computed anyway:
// a cell of the right parity reads only right-parity cells (k +- 1 on
// s - 1, k on s - 2), so the wrong-parity cells form a closed computation
// that never feeds the answer at (s = 2L - 2, k = r).
//
// Same recurrence as ops/dtw.dtw_banded_batch_multi (which evaluates it row
// by row through a prefix scan); f32 results differ only in rounding order.

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One anti-diagonal step.  Dpp holds D_{s-2} on entry and D_s on exit; Dp is
// D_{s-1}.  A/Qv hold the step s - 1 operands on entry, step s on exit.
template <int CPL, bool kEdge>
__device__ __forceinline__ void dtw_step(
    int s, int lane, int k0, int r, int L, int K, const bool (&inband)[CPL],
    const float* __restrict__ a, const float* __restrict__ q,
    int& abase, float& abuf, int& qbase, float& qbuf,
    float (&A)[CPL], float (&Qv)[CPL], const float (&Dp)[CPL],
    float (&Dpp)[CPL]) {
  // New operands entering the band this step.
  const int ia = (s + r) >> 1;
  const int jq = (s + K - 1 - r) >> 1;
  const int ab = ia & ~31;
  if (ab != abase) {
    abase = ab;
    abuf = a[min(ab + lane, L - 1)];
  }
  const int qb = jq & ~31;
  if (qb != qbase) {
    qbase = qb;
    qbuf = q[min(qb + lane, L - 1)];
  }
  const float a_in = __shfl_sync(kFull, abuf, ia - abase);
  const float q_in = __shfl_sync(kFull, qbuf, jq - qbase);
  const float a_left = __shfl_up_sync(kFull, A[CPL - 1], 1);
  const float q_right = __shfl_down_sync(kFull, Qv[0], 1);
#pragma unroll
  for (int c = CPL - 1; c > 0; --c) A[c] = A[c - 1];
  A[0] = lane == 0 ? a_in : a_left;
#pragma unroll
  for (int c = 0; c < CPL - 1; ++c) Qv[c] = Qv[c + 1];
  Qv[CPL - 1] = lane == 31 ? q_in : q_right;

  float left = __shfl_up_sync(kFull, Dp[CPL - 1], 1);
  float right = __shfl_down_sync(kFull, Dp[0], 1);
  if (lane == 0) left = kBig;
  if (lane == 31) right = kBig;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const float dl = c == 0 ? left : Dp[c - 1];
    const float dr = c == CPL - 1 ? right : Dp[c + 1];
    const float m = fminf(fminf(dl, dr), Dpp[c]);
    const float diff = A[c] - Qv[c];
    const float v = fminf(diff * diff + m, kBig);
    bool valid = inband[c];
    if (kEdge) {
      const int k = k0 + c;
      const int ti = s - k + r;  // 2i (or 2i + 1 off parity)
      const int tj = s + k - r;  // 2j (or 2j + 1 off parity)
      valid = valid && ti >= 0 && ti < 2 * L && tj >= 0 && tj < 2 * L;
    }
    Dpp[c] = valid ? v : kBig;
  }
}

template <int CPL, bool kEdge>
__device__ __forceinline__ void dtw_steps(
    int s0, int s1, bool& odd, int lane, int k0, int r, int L, int K,
    const bool (&inband)[CPL], const float* __restrict__ a,
    const float* __restrict__ q, int& abase, float& abuf, int& qbase,
    float& qbuf, float (&A)[CPL], float (&Qv)[CPL], float (&D1)[CPL],
    float (&D2)[CPL]) {
  // D1/D2 alternate roles: each step overwrites the older diagonal.  `odd`
  // is set while D2 (not D1) holds the newest one.
  int s = s0;
  if (odd && s < s1) {
    dtw_step<CPL, kEdge>(s, lane, k0, r, L, K, inband, a, q, abase, abuf,
                         qbase, qbuf, A, Qv, D2, D1);
    ++s;
    odd = false;
  }
  for (; s + 1 < s1; s += 2) {
    dtw_step<CPL, kEdge>(s, lane, k0, r, L, K, inband, a, q, abase, abuf,
                         qbase, qbuf, A, Qv, D1, D2);
    dtw_step<CPL, kEdge>(s + 1, lane, k0, r, L, K, inband, a, q, abase,
                         abuf, qbase, qbuf, A, Qv, D2, D1);
  }
  if (s < s1) {
    dtw_step<CPL, kEdge>(s, lane, k0, r, L, K, inband, a, q, abase, abuf,
                         qbase, qbuf, A, Qv, D1, D2);
    odd = true;
  }
}

template <int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    dtw_band_kernel(const float* __restrict__ x, const float* __restrict__ qm,
                    const int32_t* __restrict__ qids, float* __restrict__ out,
                    int B, int L, int r, int nq) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform per warp
  const float* a = x + static_cast<size_t>(b) * L;
  const float* q = qm + static_cast<size_t>(clampi(qids[b], 0, nq - 1)) * L;
  const int W = 2 * r + 1;
  const int K = 32 * CPL;
  const int k0 = lane * CPL;

  // State before step 0: D_{-1} = BIG, D_{-2} = 0 at k = r only (the virtual
  // predecessor of cell (0, 0)); operands of step -1.
  bool inband[CPL];
  float A[CPL], Qv[CPL], D1[CPL], D2[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int k = k0 + c;
    inband[c] = k < W;
    D1[c] = kBig;
    D2[c] = k == r ? 0.0f : kBig;
    A[c] = a[clampi((r - 1 - k) >> 1, 0, L - 1)];
    Qv[c] = q[clampi((k - r - 1) >> 1, 0, L - 1)];
  }
  int abase = -64, qbase = -64;
  float abuf = 0.0f, qbuf = 0.0f;

  // Steps r <= s <= 2L - 1 - r have every in-band cell inside the matrix, so
  // only the edges test the index ranges.
  const int S = 2 * L - 1;
  const int mid0 = min(r, S);
  const int mid1 = min(2 * L - r, S);
  bool odd = false;  // D1 holds the newest diagonal (D_{-1} here)
  dtw_steps<CPL, true>(0, mid0, odd, lane, k0, r, L, K, inband, a, q, abase,
                       abuf, qbase, qbuf, A, Qv, D1, D2);
  dtw_steps<CPL, false>(mid0, mid1, odd, lane, k0, r, L, K, inband, a, q,
                        abase, abuf, qbase, qbuf, A, Qv, D1, D2);
  dtw_steps<CPL, true>(mid1, S, odd, lane, k0, r, L, K, inband, a, q, abase,
                       abuf, qbase, qbuf, A, Qv, D1, D2);
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    if (k0 + c == r) out[b] = odd ? D2[c] : D1[c];
  }
}

template <int CPL>
cudaError_t launch(cudaStream_t stream, const float* x, const float* qm,
                   const int32_t* qids, float* out, int B, int L, int r,
                   int nq) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dtw_band_kernel<CPL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      x, qm, qids, out, B, L, r, nq);
  return cudaGetLastError();
}

}  // namespace

// The band 2r + 1 must fit 32 lanes x 32 cells (ops/dtw_cuda.MAX_BAND).
static ffi::Error DtwBandImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> x,
                              ffi::Buffer<ffi::F32> qm,
                              ffi::Buffer<ffi::S32> qids,
                              ffi::ResultBuffer<ffi::F32> out, int32_t r) {
  const auto xd = x.dimensions();
  const auto qd = qm.dimensions();
  if (xd.size() != 2 || qd.size() != 2 || qd[1] != xd[1]) {
    return ffi::Error::InvalidArgument("dtw_band: x (B, L), qm (Q, L) expected");
  }
  const int B = static_cast<int>(xd[0]);
  const int L = static_cast<int>(xd[1]);
  const int nq = static_cast<int>(qd[0]);
  if (B == 0) return ffi::Error::Success();
  if (L < 1 || nq < 1 || r < 0 || r > L - 1) {
    return ffi::Error::InvalidArgument("dtw_band: need L >= 1, Q >= 1, 0 <= r < L");
  }
  const int W = 2 * r + 1;
  const int cpl = (W + 31) / 32;
  const float* xp = x.typed_data();
  const float* qp = qm.typed_data();
  const int32_t* ip = qids.typed_data();
  float* op = out->typed_data();
  cudaError_t err;
  if (cpl <= 1) err = launch<1>(stream, xp, qp, ip, op, B, L, r, nq);
  else if (cpl <= 2) err = launch<2>(stream, xp, qp, ip, op, B, L, r, nq);
  else if (cpl <= 4) err = launch<4>(stream, xp, qp, ip, op, B, L, r, nq);
  else if (cpl <= 8) err = launch<8>(stream, xp, qp, ip, op, B, L, r, nq);
  else if (cpl <= 12) err = launch<12>(stream, xp, qp, ip, op, B, L, r, nq);
  else if (cpl <= 16) err = launch<16>(stream, xp, qp, ip, op, B, L, r, nq);
  else if (cpl <= 20) err = launch<20>(stream, xp, qp, ip, op, B, L, r, nq);
  else if (cpl <= 24) err = launch<24>(stream, xp, qp, ip, op, B, L, r, nq);
  else if (cpl <= 28) err = launch<28>(stream, xp, qp, ip, op, B, L, r, nq);
  else if (cpl <= 32) err = launch<32>(stream, xp, qp, ip, op, B, L, r, nq);
  else return ffi::Error::InvalidArgument("dtw_band: band wider than 1024 cells");
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(KvmatchDtwBand, DtwBandImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("r"));
