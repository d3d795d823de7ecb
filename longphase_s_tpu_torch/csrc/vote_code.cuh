// One vote's code byte, shared by the two kernels that cast votes:
// vote_cast_kernel (csrc/vote_scan.cu, from the [S, W] pair sums) and
// pair_cast_kernel (csrc/pair_cast.cu, from the observation stream). One
// definition, so the two casts cannot drift apart.
//
// A code is 0 when the edge does not connect; else the weight class 1/10/200
// in bits 0-1, to_h1 in bit 2, small in bit 3 and Onelongcase-eligible in
// bit 4 (ops/cuda_scan.py: CODE_*). The site word beside each code row is
// dmax | (gap > distance) << kSkipBit.
//
// Numerics: exact x10 integers, except the edge-similarity reject, which is
// the float32 compare 10*mn > thr10*mx of vote_scan.py:122-123. Both products
// are written with __fmul_rn so that nvcc cannot contract them into an FMA.

#pragma once

#include <stdint.h>

namespace lps {

constexpr unsigned kFull = 0xffffffffu;

// code bits
constexpr unsigned kWeightMask = 3u;  // 0 none, 1 -> 1, 2 -> 10, 3 -> 200
constexpr unsigned kToH1 = 4u;
constexpr unsigned kSmall = 8u;
constexpr unsigned kElig = 16u;
// the weights of classes 0..3 as bytes of one word, for __byte_perm
constexpr unsigned kWeightBytes = 0xC80A0100u;
constexpr int kSkipBit = 16;  // site word: dmax | (gap > distance) << 16

// One vote's code (pallas_scan.py:84-125); 0 when the edge does not connect.
__device__ __forceinline__ uint8_t cast_code(int sp, int sc, int vt, int tvt,
                                             bool valid, float thr10,
                                             int t_snp, int t_mod,
                                             int t_indel, int t_danger) {
  const int total = sp + sc;
  const int mn = min(sp, sc);
  const int mx = max(sp, sc);
  const bool modsnp = (vt == t_snp && tvt == t_mod) ||
                      (vt == t_mod && tvt == t_snp);
  const float thr = modsnp ? (total < 10 ? -10.0f : 3.0f) : thr10;
  const bool reject = mx > 0 && __fmul_rn(10.0f, static_cast<float>(mn)) >
                                    __fmul_rn(thr, static_cast<float>(mx));
  if (!valid || sp == sc || reject) return 0;
  const bool big = (10 * mn <= mx && total >= 10) ||
                   (sp < 10 && sc >= 10) || (sp >= 10 && sc < 10);
  const unsigned wclass = vt == t_danger ? 1u : (big ? 3u : 2u);
  unsigned code = wclass;
  if (sp > sc) code |= kToH1;
  if (total <= 10) {
    code |= kSmall;
  } else if (5 * mn < mx && wclass >= 2u && vt != t_indel) {
    code |= kElig;
  }
  return static_cast<uint8_t>(code);
}

}  // namespace lps
