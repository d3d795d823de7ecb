// Haplotype vote scan (edgeConnectResult, PhasingGraph.cpp:286-474) as one
// warp-wide CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel longphase_s_tpu/ops/pallas_scan.py:
// _scan_kernel (launched by _pallas_block_call), together with the XLA-side
// planes_from_pc / _prep_plane and the scalar _decide. The contract is that
// of longphase_s_tpu/ops/vote_scan.py:vote_scan_core, taken from the x10
// parallel/cross pair sums: per site t, assigned[t], hp[t] (1|2, also for
// unassigned sites) and bstart[t] (block-start rank, -1 when unassigned).
//
// What bounds it: the scan is a true serial recurrence over S sites, so one
// chromosome is one chain and the time is S times the latency of one step.
// The design keeps that step short:
//   * one warp runs the chain; the W-deep vote ring (W <= 64) lives in
//     registers, two slots per lane (slot `lane` and slot `lane + 32`), five
//     int32 fields per slot (h1, h2, small-total count, Onelongcase oh1/oh2);
//   * slot 0 reaches every lane by shuffle, the ring shifts by shuffle, and
//     the largest connected offset is one warp max-reduction;
//   * lane l casts the votes for offsets d = l+1 and d = l+33 in-lane from
//     s_para10[t, d-1], s_cross10[t, d-1], vtype[t] and vtype[t+d] -- no
//     [S, 8, 128] plane, no lane padding, no pre-roll, no bit packing;
//   * inputs are staged in shared memory 32 sites at a time, double
//     buffered: the pair sums of the next chunk travel by cp.async, its
//     gaps and types through registers, while the warp steps through the
//     current chunk, so a step reads shared memory and never waits on
//     device memory. Running many chromosomes in one launch (one warp each)
//     is left for later work.
//
// Numerics: exact x10 integers, except the edge-similarity reject, which is
// the float32 compare 10*mn > thr10*mx of vote_scan.py:122-123. Both products
// are written with __fmul_rn so that nvcc cannot contract them into an FMA.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWindow = 64;
constexpr int kChunk = 32;  // sites per staged chunk: one per lane
constexpr int kVtPerLane = (kChunk + kMaxWindow) / 32;  // caster + targets

struct Slot {
  int h1, h2, cnt, oh1, oh2;
};

// The ring after one step: new slot k = old slot k+1 + votes cast to offset
// k+1. Lane l holds slot l in `a` and slot l+32 in `b`; old slot 64 is 0.
__device__ __forceinline__ int shift_a(int a, int b, int lane) {
  const int up = __shfl_down_sync(kFull, a, 1);
  const int b0 = __shfl_sync(kFull, b, 0);
  return lane == 31 ? b0 : up;
}

__device__ __forceinline__ int shift_b(int b, int lane) {
  const int up = __shfl_down_sync(kFull, b, 1);
  return lane == 31 ? 0 : up;
}

struct Cast {
  bool conn_ok;   // edge decided, not rejected, target inside the chromosome
  bool to_h1;     // vote lands on hap 1 when the caster decides hp == 1
  bool small;     // total <= 10: feeds the counter only
  bool elig;      // Onelongcase eligible
  int weight;
};

// Carry-independent part of one vote (pallas_scan.py:84-125).
__device__ __forceinline__ Cast cast_vote(int sp, int sc, int vt, int tvt,
                                          bool valid, float thr10,
                                          int t_snp, int t_mod, int t_indel,
                                          int t_danger) {
  Cast c;
  const int total = sp + sc;
  const int mn = min(sp, sc);
  const int mx = max(sp, sc);
  const bool modsnp = (vt == t_snp && tvt == t_mod) ||
                      (vt == t_mod && tvt == t_snp);
  const float thr = modsnp ? (total < 10 ? -10.0f : 3.0f) : thr10;
  const bool reject = mx > 0 && __fmul_rn(10.0f, static_cast<float>(mn)) >
                                    __fmul_rn(thr, static_cast<float>(mx));
  c.conn_ok = valid && sp != sc && !reject;
  const bool big = (10 * mn <= mx && total >= 10) ||
                   (sp < 10 && sc >= 10) || (sp >= 10 && sc < 10);
  c.weight = vt == t_danger ? 1 : (big ? 200 : 10);
  c.small = total <= 10;
  c.elig = total > 10 && 5 * mn < mx && c.weight >= 10 && vt != t_indel;
  c.to_h1 = sp > sc;
  return c;
}

__device__ __forceinline__ Slot votes(const Cast& c, bool assigned, int hp) {
  Slot v{0, 0, 0, 0, 0};
  if (!(c.conn_ok && assigned)) return v;
  const bool h1 = hp == 1 ? c.to_h1 : !c.to_h1;
  if (h1) v.h1 = c.weight; else v.h2 = c.weight;
  if (c.small) {
    v.cnt = 1;
  } else if (c.elig) {
    if (h1) v.oh1 = c.weight; else v.oh2 = c.weight;
  }
  return v;
}

// One chunk's per-site inputs held in registers on their way to shared
// memory: gap[t0 + lane] and vtype[t0 + lane + 32*j].
struct SiteRegs {
  int gap;
  int8_t vt[kVtPerLane];
};

__device__ __forceinline__ SiteRegs load_sites(const int* __restrict__ gap,
                                               const int8_t* __restrict__ vtype,
                                               int t0, int S, int lane) {
  SiteRegs r;
  r.gap = t0 + lane < S ? gap[t0 + lane] : 0;
#pragma unroll
  for (int j = 0; j < kVtPerLane; ++j) {
    const int t = t0 + lane + 32 * j;
    r.vt[j] = t < S ? vtype[t] : 0;
  }
  return r;
}

__device__ __forceinline__ void store_sites(const SiteRegs& r, int* sh_gap,
                                            int8_t* sh_vt, int lane) {
  sh_gap[lane] = r.gap;
#pragma unroll
  for (int j = 0; j < kVtPerLane; ++j) sh_vt[lane + 32 * j] = r.vt[j];
}

// Asynchronous copy of one chunk's pair sums into shared memory (cp.async;
// completion is awaited with __pipeline_wait_prior).
__device__ __forceinline__ void issue_sums(const int* __restrict__ s_para10,
                                          const int* __restrict__ s_cross10,
                                          int* sh_para, int* sh_cross, int t0,
                                          int S, int W, int lane) {
  const int count = min(kChunk, S - t0) * W;
  const long long base = static_cast<long long>(t0) * W;
  for (int i = lane; i < count; i += 32) {
    __pipeline_memcpy_async(sh_para + i, s_para10 + base + i, sizeof(int));
    __pipeline_memcpy_async(sh_cross + i, s_cross10 + base + i, sizeof(int));
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(32) vote_scan_kernel(
    const int* __restrict__ s_para10, const int* __restrict__ s_cross10,
    const int* __restrict__ gap, const int8_t* __restrict__ vtype, int S,
    int W, int distance, float thr10, int t_snp, int t_mod, int t_indel,
    int t_danger, uint8_t* __restrict__ assigned_out,
    int* __restrict__ hp_out, int* __restrict__ bstart_out) {
  // double-buffered staging: chunk c is read from buffer c & 1 while chunk
  // c+1 is copied into the other one
  __shared__ int sh_para[2][kChunk * kMaxWindow];
  __shared__ int sh_cross[2][kChunk * kMaxWindow];
  __shared__ int sh_gap[2][kChunk];
  __shared__ int8_t sh_vt[2][32 * kVtPerLane];

  const int lane = threadIdx.x;
  const int da = lane + 1;   // offset cast by this lane into ring slot `a`
  const int db = lane + 33;  // offset cast by this lane into ring slot `b`
  Slot a{0, 0, 0, 0, 0};
  Slot b{0, 0, 0, 0, 0};
  int last_connect = -1;
  int block_start = -1;

  issue_sums(s_para10, s_cross10, sh_para[0], sh_cross[0], 0, S, W, lane);
  store_sites(load_sites(gap, vtype, 0, S, lane), sh_gap[0], sh_vt[0], lane);

  for (int t0 = 0, buf = 0; t0 < S; t0 += kChunk, buf ^= 1) {
    const int n = min(kChunk, S - t0);
    const bool more = t0 + kChunk < S;
    SiteRegs next;
    if (more) {
      issue_sums(s_para10, s_cross10, sh_para[buf ^ 1], sh_cross[buf ^ 1],
                 t0 + kChunk, S, W, lane);
      next = load_sites(gap, vtype, t0 + kChunk, S, lane);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    const int* para = sh_para[buf];
    const int* cross = sh_cross[buf];
    const int* gap_c = sh_gap[buf];
    const int8_t* vt_c = sh_vt[buf];

    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      // consume slot 0 (vote_scan.py:86-102)
      const int h1 = __shfl_sync(kFull, a.h1, 0);
      const int h2 = __shfl_sync(kFull, a.h2, 0);
      const int cnt = __shfl_sync(kFull, a.cnt, 0);
      const int oh1 = __shfl_sync(kFull, a.oh1, 0);
      const int oh2 = __shfl_sync(kFull, a.oh2, 0);
      const bool use_special = cnt > 3 && !(oh1 == 0 && oh2 == 0);
      const int H1 = use_special ? oh1 : h1;
      const int H2 = use_special ? oh2 : h2;
      const bool skip_distance = gap_c[k] > distance;
      const bool eq = H1 == H2;
      const bool skip_connected = eq && t < last_connect;
      const bool new_block = eq && !skip_connected && !skip_distance;
      const bool assigned = !skip_distance && !skip_connected;
      const int hp = eq ? 1 : (H1 > H2 ? 1 : 2);
      if (new_block) block_start = t;
      if (lane == 0) {
        assigned_out[t] = assigned ? 1 : 0;
        hp_out[t] = hp;
        bstart_out[t] = assigned ? block_start : -1;
      }

      // cast votes to t+da and t+db (vote_scan.py:104-149)
      const int vt = vt_c[k];
      Cast ca{false, false, false, false, 0};
      Cast cb{false, false, false, false, 0};
      if (da <= W) {
        const bool valid = t + da < S;
        ca = cast_vote(para[k * W + da - 1], cross[k * W + da - 1], vt,
                       valid ? vt_c[k + da] : 0, valid, thr10, t_snp, t_mod,
                       t_indel, t_danger);
      }
      if (db <= W) {
        const bool valid = t + db < S;
        cb = cast_vote(para[k * W + db - 1], cross[k * W + db - 1], vt,
                       valid ? vt_c[k + db] : 0, valid, thr10, t_snp, t_mod,
                       t_indel, t_danger);
      }
      const unsigned dmax = __reduce_max_sync(
          kFull, static_cast<unsigned>(max(ca.conn_ok ? da : 0,
                                           cb.conn_ok ? db : 0)));
      if (assigned && dmax > 0) last_connect = t + static_cast<int>(dmax);

      // shift the ring and add this step's votes
      const Slot va = votes(ca, assigned, hp);
      const Slot vb = votes(cb, assigned, hp);
      Slot na, nb;
      na.h1 = shift_a(a.h1, b.h1, lane) + va.h1;
      na.h2 = shift_a(a.h2, b.h2, lane) + va.h2;
      na.cnt = shift_a(a.cnt, b.cnt, lane) + va.cnt;
      na.oh1 = shift_a(a.oh1, b.oh1, lane) + va.oh1;
      na.oh2 = shift_a(a.oh2, b.oh2, lane) + va.oh2;
      nb.h1 = shift_b(b.h1, lane) + vb.h1;
      nb.h2 = shift_b(b.h2, lane) + vb.h2;
      nb.cnt = shift_b(b.cnt, lane) + vb.cnt;
      nb.oh1 = shift_b(b.oh1, lane) + vb.oh1;
      nb.oh2 = shift_b(b.oh2, lane) + vb.oh2;
      a = na;
      b = nb;
    }
    if (more) store_sites(next, sh_gap[buf ^ 1], sh_vt[buf ^ 1], lane);
    __syncwarp();
  }
}

}  // namespace

// C entry bound with ctypes. Launches on `stream` (PyTorch's current
// stream), allocates nothing and returns cudaGetLastError(). The caller
// checks 1 <= W <= 64, shapes, dtypes and contiguity.
extern "C" int lps_vote_scan(const int* s_para10, const int* s_cross10,
                             const int* gap, const int8_t* vtype, int S,
                             int W, int distance, float thr10, int t_snp,
                             int t_mod, int t_indel, int t_danger,
                             uint8_t* assigned, int* hp, int* bstart,
                             void* stream) {
  if (W < 1 || W > kMaxWindow) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0) {
    vote_scan_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        s_para10, s_cross10, gap, vtype, S, W, distance, thr10, t_snp, t_mod,
        t_indel, t_danger, assigned, hp, bstart);
  }
  return static_cast<int>(cudaGetLastError());
}
