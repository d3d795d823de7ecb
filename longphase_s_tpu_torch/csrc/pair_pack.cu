// Banded pair pack for Hopper (sm_90a): the x10 parallel/cross pair sums
// s_para10[S, W] and s_cross10[S, W] straight from the (read, rank)-sorted
// merged observation stream.
//
// Replaces the XLA device programs longphase_s_tpu/ops/fused.py:
// device_pair_counts (scatter-add into [S_pad, W, 4] hi/lo planes) and
// longphase_s_tpu/ops/mxu_pack.py:mxu_pc_counts (int8 Gram matmuls over the
// host-built bit tiles of build_tiles). The vote scan reads only the two
// sums (pallas_scan.py:77-83), so the four combo planes are never formed:
//   s_para10[r, d-1]  = sum over same-allele pairs  of (both qok ? 10 : 1)
//   s_cross10[r, d-1] = sum over cross-allele pairs of (both qok ? 10 : 1)
// which equals 10*hi + lo of rr+aa and ra+ar for alleles in {0, 1} (the
// caller checks that domain).
//
// Pair semantics are the stream-shift semantics of device_pair_counts and
// core/fastpath.pack_flat: observation i pairs with i+m for m = 1..W when
// both lie in the stream, m_read[i+m] == m_read[i] >= 0 and
// 1 <= rank[i+m] - rank[i] <= W. That is not "all same-read pairs with
// d <= W" when split alignments repeat a (read, rank); this kernel follows
// the shift form on such streams too, and on any stream order.
//
// What bounds it: memory traffic and atomics. One thread per observation
// reads its W stream successors (neighbouring threads read neighbouring
// addresses, so the loads coalesce and mostly hit L1/L2) and adds into the
// [S, W] sums with int32 atomicAdd, which gives the same sums in any order.
// No host tile build, no size-dependent choice between two packers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) pair_pack_kernel(
    const int* __restrict__ m_read, const int* __restrict__ m_rank,
    const int8_t* __restrict__ m_allele, const uint8_t* __restrict__ m_qok,
    long long n_obs, int S, int W, int* __restrict__ s_para10,
    int* __restrict__ s_cross10) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_obs) return;
  const int read = m_read[i];
  const int rank = m_rank[i];
  if (read < 0 || rank < 0 || rank >= S) return;
  const int allele = m_allele[i];
  const bool qok = m_qok[i] != 0;
  const long long row = static_cast<long long>(rank) * W;
  for (int m = 1; m <= W; ++m) {
    const long long j = i + m;
    if (j >= n_obs) break;
    if (m_read[j] != read) continue;
    const int d = m_rank[j] - rank;
    if (d < 1 || d > W) continue;
    const int w = (qok && m_qok[j] != 0) ? 10 : 1;
    int* dst = m_allele[j] == allele ? s_para10 : s_cross10;
    atomicAdd(dst + row + (d - 1), w);
  }
}

}  // namespace

// C entry bound with ctypes. The caller zero-fills both [S, W] outputs,
// checks shapes, dtypes and contiguity; the launch goes on `stream`
// (PyTorch's current stream) and cudaGetLastError() is returned.
extern "C" int lps_pair_pack(const int* m_read, const int* m_rank,
                             const int8_t* m_allele, const uint8_t* m_qok,
                             long long n_obs, int S, int W, int* s_para10,
                             int* s_cross10, void* stream) {
  if (W < 1 || S < 0 || n_obs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_obs > 0 && S > 0) {
    const long long blocks = (n_obs + kThreads - 1) / kThreads;
    pair_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        m_read, m_rank, m_allele, m_qok, n_obs, S, W, s_para10, s_cross10);
  }
  return static_cast<int>(cudaGetLastError());
}
