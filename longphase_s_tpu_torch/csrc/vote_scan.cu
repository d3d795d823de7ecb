// Haplotype vote scan (edgeConnectResult, PhasingGraph.cpp:286-474) for
// Hopper (sm_90a), in two launches.
//
// Replaces the Pallas TPU kernel longphase_s_tpu/ops/pallas_scan.py:
// _scan_kernel (launched by _pallas_block_call), together with the XLA-side
// planes_from_pc / _prep_plane and the scalar _decide. The contract is that
// of longphase_s_tpu/ops/vote_scan.py:vote_scan_core, taken from the x10
// parallel/cross pair sums: per site t, assigned[t], hp[t] (1|2, also for
// unassigned sites) and bstart[t] (block-start rank, -1 when unassigned),
// at any window W >= 1.
//
// What bounds it: the scan is a true serial recurrence over S sites, so one
// chromosome is one chain and the time is S times the latency of one step.
// So everything that does not depend on the carry leaves the chain, as the
// TPU design does with its vote planes:
//
//   1. vote_cast_kernel, the carry-independent pre-pass, over the whole
//      card: one warp a site row, coalesced reads of the [S, W] sums. For
//      each (t, d) it writes a one-byte code (0 = no vote; else the weight
//      class 1/10/200 in bits 0-1, to_h1 in bit 2, small in bit 3, elig in
//      bit 4), in rows of Wp = 32*ceil(w/32) bytes padded with zeros, and
//      per site one int: the largest connectable d in the low 16 bits and
//      gap > distance in bit 16. It is bound by the bytes it moves.
//   2. vote_scan_kernel, the serial pass, one warp a chromosome. A step
//      does only what depends on the carry: broadcast the consumed ring
//      slot, decide, and add this site's votes. The W-deep ring is indexed
//      by site, so nothing shifts: target site u lives in lane u mod 32,
//      register (u / 32) mod (NS+1), NS = Wp / 32 <= 4. The chunk loop is
//      unrolled over the NS+1 register rotations so every register index
//      is static. h1/h2 and the Onelongcase oh1/oh2 ride as 16-bit halves
//      of one int each (every sum is at most 200*W <= 25,600), so slot t
//      reaches the warp in three shuffles from lane t mod 32. The register
//      that a chunk consumed is cleared once at the chunk's end. The codes
//      and the site words of the next 32 sites travel by cp.async, double
//      buffered; lane k keeps site t0+k's outputs, stored once a chunk,
//      coalesced.
//   3. vote_scan_ring_kernel for W > 128: the same codes, staged the same
//      way a chunk of up to 32 rows at a time, with the ring in shared
//      memory as a circular buffer of W+1 slots indexed by site (five int32
//      fields: above W = 327 the sums outgrow 16 bits). It takes 20*(W+1)
//      bytes of ring plus two staged rows, which bounds W at about 10,500
//      on sm_90 (227 KB a block).
// Windows wider than the chromosome are cut to w = min(W, S-1) first: a
// vote to t+d >= S never counts. On the phase flat path the codes come from
// pair_cast (csrc/pair_cast.cu), which casts them straight from the
// observation stream; vote_cast serves callers that hold the sums (the
// object path). Many chromosomes in one launch are left for later work.
//
// Numerics: see csrc/vote_code.cuh (cast_code, shared with pair_cast).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_code.cuh"

namespace {

using namespace lps;

constexpr int kChunk = 32;        // sites per staged chunk: one per lane
constexpr int kMaxRegSlots = 4;   // register ring up to W = 128
constexpr int kCastRows = 8;      // site rows per cast block (one per warp)

// Grid-wide pre-pass: warp y of block b takes site t = b*kCastRows + y and
// lane l the columns c = l, l+32, ... of its Wp-byte code row.
__global__ void __launch_bounds__(32 * kCastRows) vote_cast_kernel(
    const int* __restrict__ s_para10, const int* __restrict__ s_cross10,
    const int* __restrict__ gap, const int8_t* __restrict__ vtype, int S,
    int ld, int w, int Wp, int distance, float thr10, int t_snp, int t_mod,
    int t_indel, int t_danger, uint8_t* __restrict__ codes,
    int* __restrict__ site) {
  const int t = blockIdx.x * kCastRows + threadIdx.y;
  if (t >= S) return;
  const int lane = threadIdx.x;
  const int vt = vtype[t];
  const long long in_row = static_cast<long long>(t) * ld;
  uint8_t* out_row = codes + static_cast<long long>(t) * Wp;
  unsigned dm = 0;
  for (int c = lane; c < Wp; c += 32) {
    const int d = c + 1;
    uint8_t code = 0;
    if (d <= w) {
      const bool valid = t + d < S;
      code = cast_code(s_para10[in_row + c], s_cross10[in_row + c], vt,
                       valid ? vtype[t + d] : 0, valid, thr10, t_snp, t_mod,
                       t_indel, t_danger);
      if (code) dm = static_cast<unsigned>(d);
    }
    out_row[c] = code;
  }
  const unsigned dmax = __reduce_max_sync(kFull, dm);
  if (lane == 0) {
    site[t] = static_cast<int>(dmax) | ((gap[t] > distance) << kSkipBit);
  }
}

// Asynchronous copy of the codes and site words of sites [t0, t0+n) into
// shared memory (cp.async, 16 bytes a copy for the codes; completion is
// awaited with __pipeline_wait_prior). Wp is a multiple of 32, so every
// copy is 16-byte aligned.
__device__ __forceinline__ void issue_chunk(const uint8_t* __restrict__ codes,
                                            const int* __restrict__ site,
                                            uint8_t* sh_codes, int* sh_site,
                                            int t0, int n, int Wp, int lane) {
  const uint8_t* src = codes + static_cast<long long>(t0) * Wp;
  const int count = n * Wp / 16;
  for (int i = lane; i < count; i += 32) {
    __pipeline_memcpy_async(sh_codes + 16 * i, src + 16 * i, 16);
  }
  for (int i = lane; i < n; i += 32) {
    __pipeline_memcpy_async(sh_site + i, site + t0 + i, sizeof(int));
  }
  __pipeline_commit();
}

// The decision at one site from its consumed ring slot (vote_scan.py:86-102)
// and its site word; updates the carry.
struct Decision {
  bool assigned;
  bool hp2;
};

__device__ __forceinline__ Decision decide(int h1, int h2, int cnt, int oh1,
                                           int oh2, int t, int site_word,
                                           int& last_connect,
                                           int& block_start) {
  const bool use_special = cnt > 3 && !(oh1 == 0 && oh2 == 0);
  const int H1 = use_special ? oh1 : h1;
  const int H2 = use_special ? oh2 : h2;
  const bool skip_distance = (site_word >> kSkipBit) != 0;
  const bool eq = H1 == H2;
  const bool assigned = !skip_distance && !(eq && t < last_connect);
  if (eq && assigned) block_start = t;
  const int dmax = site_word & 0xffff;
  if (assigned && dmax > 0) last_connect = t + dmax;
  return Decision{assigned, H2 > H1};
}

// Register ring state of one lane: the ring's three packed fields for the
// NS+1 register rotations, and the carry (uniform across the warp).
template <int NS>
struct Ring {
  int hh[NS + 1];  // h1 | h2 << 16
  int cnt[NS + 1];
  int oo[NS + 1];  // oh1 | oh2 << 16
  int last_connect;
  int block_start;
};

// One chunk of 32 sites (fewer at the end) whose ring slots sit in register
// R0. Lane l's vote target at offset slot j lies in register R0+j, or R0+j+1
// for lanes l <= k (their sites of this chunk are consumed already).
template <int NS, int R0>
__device__ __forceinline__ void scan_chunk(
    Ring<NS>& r, const uint8_t* rows, const int* site, int t0, int n, int Wp,
    int lane, uint8_t* __restrict__ assigned_out, int* __restrict__ hp_out,
    int* __restrict__ bstart_out) {
  int my_assigned = 0, my_hp = 1, my_bstart = -1;
  // Unrolled so that the next sites' code loads and decode, which do not
  // depend on the carry, overlap this site's chain: 13% off at W = 35 and
  // 11% at W = 100 on an H100 (by 2: 9.5% and 13%).
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const int t = t0 + k;
    const int hh = __shfl_sync(kFull, r.hh[R0], k);
    const int cnt = __shfl_sync(kFull, r.cnt[R0], k);
    const int oo = __shfl_sync(kFull, r.oo[R0], k);
    const Decision dec =
        decide(hh & 0xffff, hh >> 16, cnt, oo & 0xffff, oo >> 16, t, site[k],
               r.last_connect, r.block_start);
    if (lane == k) {
      my_assigned = dec.assigned;
      my_hp = dec.hp2 ? 2 : 1;
      my_bstart = dec.assigned ? r.block_start : -1;
    }

    // this lane's votes: offsets d = ((lane - k - 1) & 31) + 1 + 32*j
    const uint8_t* row = rows + k * Wp + ((lane - k - 1) & 31);
    int vh[NS], vc[NS], vo[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const unsigned code = row[32 * j];
      const int w = static_cast<int>(
          __byte_perm(kWeightBytes, 0, code & kWeightMask));
      const bool to_h1 = (code & kToH1) != 0;
      // the packed add when the site decides hp 1, and when hp 2
      const int a1 = to_h1 ? w : (w << 16);
      const int a2 = to_h1 ? (w << 16) : w;
      const int add = dec.assigned ? (dec.hp2 ? a2 : a1) : 0;
      vh[j] = add;
      vc[j] = (dec.assigned && (code & kSmall)) ? 1 : 0;
      vo[j] = (code & kElig) ? add : 0;
    }
    const bool done = lane <= k;
#pragma unroll
    for (int m = 0; m <= NS; ++m) {
      const int reg = (R0 + m) % (NS + 1);
      const int lo = m < NS ? m : 0;       // vote j = m (lanes l > k)
      const int hi = m > 0 ? m - 1 : 0;    // vote j = m-1 (lanes l <= k)
      const bool take_lo = !done && m < NS;
      const bool take_hi = done && m > 0;
      r.hh[reg] += take_lo ? vh[lo] : (take_hi ? vh[hi] : 0);
      r.cnt[reg] += take_lo ? vc[lo] : (take_hi ? vc[hi] : 0);
      r.oo[reg] += take_lo ? vo[lo] : (take_hi ? vo[hi] : 0);
    }
  }
  // every site of register R0 was consumed in this chunk
  r.hh[R0] = 0;
  r.cnt[R0] = 0;
  r.oo[R0] = 0;
  if (lane < n) {
    assigned_out[t0 + lane] = static_cast<uint8_t>(my_assigned);
    hp_out[t0 + lane] = my_hp;
    bstart_out[t0 + lane] = my_bstart;
  }
}

// Double-buffered staging of `rows` sites: codes, then site words.
size_t staging_bytes(int rows, int Wp) {
  return 2 * (static_cast<size_t>(rows) * Wp + rows * sizeof(int));
}

// Stage, scan and advance one chunk; false when it was the last.
template <int NS, int R0>
__device__ __forceinline__ bool step_chunk(
    Ring<NS>& r, const uint8_t* __restrict__ codes,
    const int* __restrict__ site, uint8_t* sh_codes, int* sh_site, int& t0,
    int& buf, int S, int Wp, int lane, uint8_t* __restrict__ assigned_out,
    int* __restrict__ hp_out, int* __restrict__ bstart_out) {
  const int n = min(kChunk, S - t0);
  const bool more = t0 + kChunk < S;
  if (more) {
    const int nb = buf ^ 1;
    issue_chunk(codes, site, sh_codes + nb * kChunk * Wp,
                sh_site + nb * kChunk, t0 + kChunk,
                min(kChunk, S - t0 - kChunk), Wp, lane);
    __pipeline_wait_prior(1);
  } else {
    __pipeline_wait_prior(0);
  }
  __syncwarp();
  scan_chunk<NS, R0>(r, sh_codes + buf * kChunk * Wp, sh_site + buf * kChunk,
                     t0, n, Wp, lane, assigned_out, hp_out, bstart_out);
  __syncwarp();  // this buffer is read before the next issue overwrites it
  t0 += kChunk;
  buf ^= 1;
  return more;
}

template <int NS, int R0>
__device__ __forceinline__ bool step_rotations(
    Ring<NS>& r, const uint8_t* __restrict__ codes,
    const int* __restrict__ site, uint8_t* sh_codes, int* sh_site, int& t0,
    int& buf, int S, int Wp, int lane, uint8_t* __restrict__ assigned_out,
    int* __restrict__ hp_out, int* __restrict__ bstart_out) {
  if (!step_chunk<NS, R0>(r, codes, site, sh_codes, sh_site, t0, buf, S, Wp,
                          lane, assigned_out, hp_out, bstart_out)) {
    return false;
  }
  if constexpr (R0 < NS) {
    return step_rotations<NS, R0 + 1>(r, codes, site, sh_codes, sh_site, t0,
                                      buf, S, Wp, lane, assigned_out, hp_out,
                                      bstart_out);
  }
  return true;
}

// Register ring, Wp = 32*NS. Dynamic shared memory, double-buffered:
// codes[2][kChunk*Wp] bytes, then site words[2][kChunk].
template <int NS>
__global__ void __launch_bounds__(32) vote_scan_kernel(
    const uint8_t* __restrict__ codes, const int* __restrict__ site, int S,
    uint8_t* __restrict__ assigned_out, int* __restrict__ hp_out,
    int* __restrict__ bstart_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int Wp = 32 * NS;
  uint8_t* const sh_codes = smem;
  int* const sh_site = reinterpret_cast<int*>(smem + 2 * kChunk * Wp);
  const int lane = threadIdx.x;
  Ring<NS> r;
#pragma unroll
  for (int m = 0; m <= NS; ++m) {
    r.hh[m] = 0;
    r.cnt[m] = 0;
    r.oo[m] = 0;
  }
  r.last_connect = -1;
  r.block_start = -1;
  issue_chunk(codes, site, sh_codes, sh_site, 0, min(kChunk, S), Wp, lane);
  int t0 = 0, buf = 0;
  while (step_rotations<NS, 0>(r, codes, site, sh_codes, sh_site, t0, buf, S,
                               Wp, lane, assigned_out, hp_out, bstart_out)) {
  }
}

// Shared-memory ring, any W: five fields of R = W+1 slots; site t uses slot
// t mod R, consumed and cleared at step t, and receives votes from sites
// t-W..t-1, each of which writes its own distinct slot -- one lane per slot
// per step, so no atomics. Codes and site words are staged `rows` sites at
// a time, double-buffered, after the ring.
__global__ void __launch_bounds__(32) vote_scan_ring_kernel(
    const uint8_t* __restrict__ codes, const int* __restrict__ site, int S,
    int W, int Wp, int rows, uint8_t* __restrict__ assigned_out,
    int* __restrict__ hp_out, int* __restrict__ bstart_out) {
  extern __shared__ __align__(16) int ring[];
  const int R = W + 1;
  int* f_h1 = ring;
  int* f_h2 = ring + R;
  int* f_cnt = ring + 2 * R;
  int* f_oh1 = ring + 3 * R;
  int* f_oh2 = ring + 4 * R;
  uint8_t* const sh_codes =
      reinterpret_cast<uint8_t*>(ring + ((5 * R + 3) & ~3));
  int* const sh_site = reinterpret_cast<int*>(sh_codes + 2 * rows * Wp);
  const int lane = threadIdx.x;
  for (int i = lane; i < 5 * R; i += 32) ring[i] = 0;
  int last_connect = -1;
  int block_start = -1;
  issue_chunk(codes, site, sh_codes, sh_site, 0, min(rows, S), Wp, lane);
  __syncwarp();

  for (int t0 = 0, buf = 0, s0 = 0; t0 < S; t0 += rows, buf ^= 1) {
    const int n = min(rows, S - t0);
    const bool more = t0 + rows < S;
    if (more) {
      const int nb = buf ^ 1;
      issue_chunk(codes, site, sh_codes + nb * rows * Wp, sh_site + nb * rows,
                  t0 + rows, min(rows, S - t0 - rows), Wp, lane);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    const uint8_t* chunk = sh_codes + buf * rows * Wp;
    const int* words = sh_site + buf * rows;
    int my_assigned = 0, my_hp = 1, my_bstart = -1;
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      const int h1 = f_h1[s0], h2 = f_h2[s0], cnt = f_cnt[s0];
      const int oh1 = f_oh1[s0], oh2 = f_oh2[s0];
      __syncwarp();
      if (lane == 0) {
        f_h1[s0] = 0;
        f_h2[s0] = 0;
        f_cnt[s0] = 0;
        f_oh1[s0] = 0;
        f_oh2[s0] = 0;
      }
      const Decision dec = decide(h1, h2, cnt, oh1, oh2, t, words[k],
                                  last_connect, block_start);
      if (lane == k) {
        my_assigned = dec.assigned;
        my_hp = dec.hp2 ? 2 : 1;
        my_bstart = dec.assigned ? block_start : -1;
      }
      if (dec.assigned) {
        const uint8_t* row = chunk + k * Wp;
        for (int d = lane + 1; d <= W; d += 32) {
          const unsigned code = row[d - 1];
          if (code == 0) continue;
          const int w = static_cast<int>(
              __byte_perm(kWeightBytes, 0, code & kWeightMask));
          const bool h1_side = ((code & kToH1) != 0) != dec.hp2;
          const int slot = s0 + d < R ? s0 + d : s0 + d - R;
          if (h1_side) f_h1[slot] += w; else f_h2[slot] += w;
          if (code & kSmall) {
            f_cnt[slot] += 1;
          } else if (code & kElig) {
            if (h1_side) f_oh1[slot] += w; else f_oh2[slot] += w;
          }
        }
      }
      s0 = s0 + 1 < R ? s0 + 1 : 0;
      __syncwarp();  // this step's votes land before the next step reads
    }
    if (lane < n) {
      assigned_out[t0 + lane] = static_cast<uint8_t>(my_assigned);
      hp_out[t0 + lane] = my_hp;
      bstart_out[t0 + lane] = my_bstart;
    }
  }
}

size_t ring_smem_bytes(int W, int Wp, int rows) {
  const size_t ring_ints = (5 * static_cast<size_t>(W + 1) + 3) & ~size_t{3};
  return ring_ints * sizeof(int) + staging_bytes(rows, Wp);
}

template <int NS>
int launch_register(const uint8_t* codes, const int* site, int S,
                    uint8_t* assigned, int* hp, int* bstart,
                    cudaStream_t stream) {
  const size_t bytes = staging_bytes(kChunk, 32 * NS);
  const cudaError_t e = cudaFuncSetAttribute(
      vote_scan_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  vote_scan_kernel<NS><<<1, 32, bytes, stream>>>(codes, site, S, assigned,
                                                 hp, bstart);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries bound with ctypes. Each launches on `stream` (PyTorch's current
// stream), allocates nothing and returns a cudaError_t. The caller checks
// shapes, dtypes and contiguity, and passes the window cut to the
// chromosome, w = min(W, max(S-1, 1)), and the code row width
// Wp = 32*ceil(w/32).

// The pre-pass: s_para10/s_cross10 [S, ld] -> codes [S, Wp], site [S].
extern "C" int lps_vote_cast(const int* s_para10, const int* s_cross10,
                             const int* gap, const int8_t* vtype, int S,
                             int ld, int w, int Wp, int distance, float thr10,
                             int t_snp, int t_mod, int t_indel, int t_danger,
                             uint8_t* codes, int* site, void* stream) {
  if (w < 1 || w > ld || Wp < w || Wp % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(32, kCastRows);
  const int blocks = (S + kCastRows - 1) / kCastRows;
  vote_cast_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      s_para10, s_cross10, gap, vtype, S, ld, w, Wp, distance, thr10, t_snp,
      t_mod, t_indel, t_danger, codes, site);
  return static_cast<int>(cudaGetLastError());
}

// The serial pass over the codes: register ring for Wp <= 128, else the
// shared-memory ring; cudaErrorInvalidValue when the ring and two staged
// rows do not fit in a block's shared memory (w above about 10,500).
extern "C" int lps_vote_scan(const uint8_t* codes, const int* site, int S,
                             int w, int Wp, uint8_t* assigned, int* hp,
                             int* bstart, void* stream) {
  if (w < 1 || Wp < w || Wp % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Wp / 32) {
    case 1:
      return launch_register<1>(codes, site, S, assigned, hp, bstart, st);
    case 2:
      return launch_register<2>(codes, site, S, assigned, hp, bstart, st);
    case 3:
      return launch_register<3>(codes, site, S, assigned, hp, bstart, st);
    case kMaxRegSlots:
      return launch_register<kMaxRegSlots>(codes, site, S, assigned, hp,
                                           bstart, st);
    default:
      break;
  }
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  int rows = kChunk;
  while (rows > 1 && ring_smem_bytes(w, Wp, rows) > static_cast<size_t>(optin)) {
    --rows;
  }
  const size_t bytes = ring_smem_bytes(w, Wp, rows);
  if (bytes > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  e = cudaFuncSetAttribute(vote_scan_ring_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  vote_scan_ring_kernel<<<1, 32, bytes, st>>>(codes, site, S, w, Wp, rows,
                                              assigned, hp, bstart);
  return static_cast<int>(cudaGetLastError());
}
