// Latencies, in SM cycles, of the dependent steps of vote_scan's serial
// chain (csrc/vote_scan.cu, scan_chunk), measured on the card with
// clock64(): one warp runs kSteps dependent instances of each kind of step
// and times them. testing/bench.py multiplies each latency by the steps of
// that kind it counts in scan_chunk's loop, for the least time a site adds
// to the chain (the serial scan's floor at the SM clock).
//
//   out[0]  cycles of kSteps dependent warp shuffles (__shfl_sync of a
//           value from a lane fixed before the chain, as scan_chunk's
//           shuffle of its ring slot)
//   out[1]  cycles of kSteps dependent (x ^ a) + b: 2 * kSteps integer
//           operations, each waiting for the one before (LOP3, IADD3)
//   out[2]  cycles of kSteps dependent x == a ? b : x ^ c: the compare and
//           the select it feeds, 2 * kSteps dependent operations (ISETP,
//           SEL; the xor runs beside the compare)
//   out[3]  kSteps
//
// Each chain starts from the last one's result, so none can start before
// the one before it ends; each runs twice and the second run is kept, so
// the instruction cache is warm. `sink` keeps the results alive. Not a
// kernel of any pipeline: nothing counts its launches.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSteps = 4096;

__global__ void __launch_bounds__(32) chain_latency_kernel(
    int a, int b, int c, long long* __restrict__ out, int* __restrict__ sink) {
  const int lane = threadIdx.x;
  const int src = (lane + a) & 31;  // fixed before the chain
  int x = lane, y = 0, z = 0;
  long long cycles[3] = {0, 0, 0};
  for (int rep = 0; rep < 2; ++rep) {
    long long t0 = clock64();
#pragma unroll 32
    for (int i = 0; i < kSteps; ++i) x = __shfl_sync(kFull, x, src);
    long long t1 = clock64();
    y = x;
#pragma unroll 32
    for (int i = 0; i < kSteps; ++i) y = (y ^ a) + b;
    long long t2 = clock64();
    z = y;
#pragma unroll 32
    for (int i = 0; i < kSteps; ++i) z = z == a ? b : z ^ c;
    long long t3 = clock64();
    cycles[0] = t1 - t0;
    cycles[1] = t2 - t1;
    cycles[2] = t3 - t2;
    x = z;
  }
  sink[lane] = z;
  if (lane == 0) {
    out[0] = cycles[0];
    out[1] = cycles[1];
    out[2] = cycles[2];
    out[3] = kSteps;
  }
}

}  // namespace

// out: 4 int64 on the card; sink: 32 int32 on the card. a, b, c: any values
// the compiler cannot see (the caller passes a = 1, b = 3, c = 5).
extern "C" int lps_chain_latency(long long* out, int* sink, int a, int b,
                                 int c, void* stream) {
  chain_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, out, sink);
  return static_cast<int>(cudaGetLastError());
}
