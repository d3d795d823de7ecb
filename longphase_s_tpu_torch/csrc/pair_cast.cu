// Pair cast for Hopper (sm_90a): the vote codes of the haplotype scan
// straight from the merged observation stream, with the x10 pair sums kept
// in shared memory. Three launches:
//
//   1. bucket_count_kernel: the number of source observations of each site
//      tile [s0, s0+T) (key rank / T).
//   2. bucket_scatter_kernel: the observation indices, int32, scattered into
//      one bucket a tile (cursors from the exclusive scan of the counts,
//      which the caller takes with torch.cumsum). The order inside a bucket
//      does not matter: the sums commute.
//   3. pair_cast_kernel: one block a tile. It adds its bucket's pairs into
//      para[T][w] and cross[T][w] in shared memory, then casts every
//      (site, offset) with cast_code (csrc/vote_code.cuh, shared with
//      vote_cast) and writes the code rows and the site words: the only
//      device-memory outputs.
//
// Replaces the XLA device programs longphase_s_tpu/ops/fused.py:26
// device_pair_counts and longphase_s_tpu/ops/mxu_pack.py:152 mxu_pc_counts
// (the pair sums), together with the carry-independent half of the scan,
// longphase_s_tpu/ops/pallas_scan.py:77 planes_from_pc / _prep_plane (the
// cast). Its output is what vote_cast (csrc/vote_scan.cu) writes from the
// sums: codes uint8[S, Wp], zero past w = min(W, S-1), and site int32[S] =
// dmax | (gap > distance) << 16; vote_scan_kernel consumes it unchanged.
//
// Pair semantics are the stream-shift semantics of device_pair_counts:
// observation i (m_read[i] >= 0, 0 <= rank[i] < S) pairs with i+m for
// m = 1..W when i+m lies in the stream, m_read[i+m] == m_read[i] and
// 1 <= rank[i+m] - rank[i] <= W; a pair adds (both qok ? 10 : 1) to the
// same-allele (para) or cross-allele sum of (rank[i], d). This holds on any
// stream order, on duplicate (read, rank) rows and on m_read == -1 padding.
// Only d <= w is kept: a larger offset points past the chromosome and never
// casts a vote.
//
// What bounds it: the function's bytes (the stream, gap and vtype in; the
// codes and site words out), 74.5 MB at S = 319,951, W = 35, about 22 us on
// an H100. The pair pack it replaces (K2) added about 145M pairs into two
// [S, W] int32 sums with global atomics; at 89.6 MB they outgrow the 50 MB
// L2, so each add was a read-modify-write that spilled to HBM, and the
// sums were zero-filled before and read back by vote_cast after. Here the
// adds land in shared memory, the sums never reach device memory, and each
// tile reads its sources' W stream successors, which for a read's
// contiguous observations hit L1/L2. The buckets cost an int32 index (n x 4
// bytes) and two passes over read and rank. Their counters are global, but
// each warp adds once a tile it touches (__match_any_sync on the key: a
// read's consecutive ranks share a tile), about n/32 adds in all; flushing
// block-private histograms of all ceil(S/T) tiles would cost more.
//
// T follows the window: the largest power of two up to 128 whose tile
// (T*Wp staged code bytes, 8*T*w bytes of sums, T site words, a halo of
// T+w target types) fits 16 KB, T = 32 at W = 35 and 16 at W = 100. Small
// tiles keep eight blocks, 64 warps, on an SM to hide the latency of the
// successor walk; taller ones measured slower on an H100
// (tools/pair_cast_probe.py). Past 16 KB, T = 1 up to the card's opt-in
// limit (227 KB: w up to about 25,000), and no launch beyond.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_code.cuh"

namespace {

using namespace lps;

constexpr int kThreads = 256;            // every kernel: 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 128;            // sites a tile
constexpr size_t kTileBudget = 16 * 1024;

size_t tile_smem_bytes(int T, int w, int Wp) {
  return static_cast<size_t>(T) * Wp + 8 * static_cast<size_t>(T) * w +
         4 * static_cast<size_t>(T) + static_cast<size_t>(T) + w;
}

// The tile of observation i, or -1 when i is no source.
__device__ __forceinline__ int source_tile(const int* __restrict__ m_read,
                                           const int* __restrict__ m_rank,
                                           long long i, long long n, int S,
                                           int T) {
  if (i >= n || m_read[i] < 0) return -1;
  const int rank = m_rank[i];
  return rank >= 0 && rank < S ? rank / T : -1;
}

__global__ void __launch_bounds__(kThreads) bucket_count_kernel(
    const int* __restrict__ m_read, const int* __restrict__ m_rank,
    long long n, int S, int T, int* __restrict__ count) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int key = source_tile(m_read, m_rank, i, n, S, T);
  const unsigned active = __ballot_sync(kFull, key >= 0);
  if (key < 0) return;
  const unsigned peers = __match_any_sync(active, key);
  if (static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(count + key, __popc(peers));
  }
}

__global__ void __launch_bounds__(kThreads) bucket_scatter_kernel(
    const int* __restrict__ m_read, const int* __restrict__ m_rank,
    long long n, int S, int T, int* __restrict__ cursor,
    int* __restrict__ order) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int key = source_tile(m_read, m_rank, i, n, S, T);
  const unsigned active = __ballot_sync(kFull, key >= 0);
  if (key < 0) return;
  const unsigned peers = __match_any_sync(active, key);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cursor + key, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  order[base + __popc(peers & ((1u << lane) - 1u))] = static_cast<int>(i);
}

// Block b takes the sites [s0, s0 + rows) of tile b. Dynamic shared memory:
// staged code rows [T][Wp] bytes, para [T][w] and cross [T][w] int32, site
// words [T], target types [T + w].
__global__ void __launch_bounds__(kThreads) pair_cast_kernel(
    const int* __restrict__ m_read, const int* __restrict__ m_rank,
    const int8_t* __restrict__ m_allele, const uint8_t* __restrict__ m_qok,
    long long n, const int* __restrict__ order, const int* __restrict__ ends,
    const int* __restrict__ gap, const int8_t* __restrict__ vtype, int S,
    int W, int w, int Wp, int T, int distance, float thr10, int t_snp,
    int t_mod, int t_indel, int t_danger, uint8_t* __restrict__ codes,
    int* __restrict__ site) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tw = T * w;
  uint8_t* const sh_codes = smem;
  int* const sh_sums = reinterpret_cast<int*>(smem + T * Wp);  // para, cross
  int* const sh_site = sh_sums + 2 * tw;
  int8_t* const sh_vt = reinterpret_cast<int8_t*>(sh_site + T);
  const int tile = blockIdx.x;
  const int s0 = tile * T;
  const int rows = min(T, S - s0);

  for (int k = threadIdx.x; k < 2 * tw; k += kThreads) sh_sums[k] = 0;
  for (int k = threadIdx.x; k < T + w; k += kThreads) {
    sh_vt[k] = k < S - s0 ? vtype[s0 + k] : 0;
  }
  __syncthreads();

  // The bucket's pairs: each thread walks one source's W stream successors.
  const int begin = tile == 0 ? 0 : ends[tile - 1];
  const int end = ends[tile];
  for (int k = begin + static_cast<int>(threadIdx.x); k < end; k += kThreads) {
    const long long i = order[k];
    const int read = m_read[i];
    const int rank = m_rank[i];
    const int allele = m_allele[i];
    const bool qok = m_qok[i] != 0;
    const int row = (rank - s0) * w - 1;  // + d: column d-1 of the row
    const long long last = min(n - 1, i + W);
    for (long long j = i + 1; j <= last; ++j) {
      if (m_read[j] != read) continue;
      const int d = m_rank[j] - rank;
      if (d < 1 || d > w) continue;
      const int add = (qok && m_qok[j] != 0) ? 10 : 1;
      atomicAdd(sh_sums + row + d + (m_allele[j] == allele ? 0 : tw), add);
    }
  }
  __syncthreads();

  // The cast: warp y takes rows y, y+8, ...; lane l the offsets d = l+1,
  // l+33, ... of a row. Codes are staged for a 16-byte store.
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < rows; t += kWarps) {
    const int vt = sh_vt[t];
    const int* para = sh_sums + t * w;
    uint8_t* out = sh_codes + t * Wp;
    unsigned dm = 0;
    for (int c = lane; c < Wp; c += 32) {
      const int d = c + 1;
      uint8_t code = 0;
      if (d <= w) {
        const bool valid = d < S - s0 - t;  // t + d < S
        code = cast_code(para[c], para[c + tw], vt, sh_vt[t + d], valid,
                         thr10, t_snp, t_mod, t_indel, t_danger);
        if (code) dm = static_cast<unsigned>(d);
      }
      out[c] = code;
    }
    const unsigned dmax = __reduce_max_sync(kFull, dm);
    if (lane == 0) {
      sh_site[t] = static_cast<int>(dmax) |
                   ((gap[s0 + t] > distance) << kSkipBit);
    }
  }
  __syncthreads();

  // Rows * Wp bytes, a multiple of 32: 16 bytes a thread, coalesced.
  const uint4* src = reinterpret_cast<const uint4*>(sh_codes);
  uint4* dst = reinterpret_cast<uint4*>(codes + static_cast<long long>(s0) * Wp);
  for (int k = threadIdx.x; k < rows * Wp / 16; k += kThreads) dst[k] = src[k];
  for (int k = threadIdx.x; k < rows; k += kThreads) site[s0 + k] = sh_site[k];
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// C entries bound with ctypes. Each launches on `stream` (PyTorch's current
// stream), allocates nothing and returns a cudaError_t. The caller checks
// shapes, dtypes and contiguity, keeps n below 2^31, and passes the window
// cut to the chromosome, w = min(W, max(S-1, 1)), and the code row width
// Wp = 32*ceil(w/32).

// The tile height T for a window: > 0, 0 when even one site row does not
// fit a block's shared memory, or minus a cudaError_t.
extern "C" int lps_pair_tile(int w, int Wp) {
  if (w < 1 || Wp < w || Wp % 32 != 0) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  for (int T = kMaxTile; T >= 1; T /= 2) {
    if (tile_smem_bytes(T, w, Wp) <= kTileBudget) return T;
  }
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  }
  if (e != cudaSuccess) return -static_cast<int>(e);
  return tile_smem_bytes(1, w, Wp) <= static_cast<size_t>(optin) ? 1 : 0;
}

// Counts the sources of each of the ceil(S/T) tiles into `count` (zeroed
// by the caller).
extern "C" int lps_bucket_count(const int* m_read, const int* m_rank,
                                long long n, int S, int T, int* count,
                                void* stream) {
  if (T < 1 || S < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && S > 0) {
    bucket_count_kernel<<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        m_read, m_rank, n, S, T, count);
  }
  return static_cast<int>(cudaGetLastError());
}

// Scatters the source indices into `order`; `cursor` starts at each
// bucket's first slot and ends at its last plus one.
extern "C" int lps_bucket_scatter(const int* m_read, const int* m_rank,
                                  long long n, int S, int T, int* cursor,
                                  int* order, void* stream) {
  if (T < 1 || S < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && S > 0) {
    bucket_scatter_kernel<<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        m_read, m_rank, n, S, T, cursor, order);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel: `ends` holds each bucket's end in `order` (the inclusive
// scan of the counts); codes [S, Wp] (16-byte aligned) and site [S] out.
extern "C" int lps_pair_cast(const int* m_read, const int* m_rank,
                             const int8_t* m_allele, const uint8_t* m_qok,
                             long long n, const int* order, const int* ends,
                             const int* gap, const int8_t* vtype, int S, int W,
                             int w, int Wp, int T, int distance, float thr10,
                             int t_snp, int t_mod, int t_indel, int t_danger,
                             uint8_t* codes, int* site, void* stream) {
  if (w < 1 || W < w || Wp < w || Wp % 32 != 0 || T < 1 || n < 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const size_t bytes = tile_smem_bytes(T, w, Wp);
  const cudaError_t e = cudaFuncSetAttribute(
      pair_cast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned tiles =
      static_cast<unsigned>((static_cast<long long>(S) + T - 1) / T);
  pair_cast_kernel<<<tiles, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      m_read, m_rank, m_allele, m_qok, n, order, ends, gap, vtype, S, W, w,
      Wp, T, distance, thr10, t_snp, t_mod, t_indel, t_danger, codes, site);
  return static_cast<int>(cudaGetLastError());
}
