// The spec 8.7.2 deblocking edge filters of one line of samples, shared by
// the CUDA kernels: `deblock_luma.cu` (slabs of lines) and `deblock_wave.cu`
// (a whole macroblock wave).  All int32, the same integers as
// `tpu264_torch/kernels/deblock_lines.py` (luma) and
// `tpu264_torch/kernels/deblock.py` `filter_chroma_lines` (chroma).

#pragma once

#include <cstdint>

namespace dbf {

struct EdgeParams {
  int32_t alpha, beta;
  int32_t tc0[3];     // TC0_TABLE[indexA][bS - 1] for bS = 1..3
};

__device__ __forceinline__ int32_t iabs(int32_t v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int32_t clip3(int32_t lo, int32_t hi, int32_t v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Luma: gate |p0-q0| < alpha, |p1-p0| < beta, |q1-q0| < beta and bS > 0;
// bS < 4 the normal filter with tc = tc0 + ap + aq; bS = 4 the strong or
// the weak filter.  p3 and q3 are read only.
__device__ __forceinline__ void luma_line(int32_t p3, int32_t& p2, int32_t& p1,
                                          int32_t& p0, int32_t& q0,
                                          int32_t& q1, int32_t& q2, int32_t q3,
                                          int32_t bs, const EdgeParams& prm) {
  const int32_t alpha = prm.alpha, beta = prm.beta;
  const bool fflag = iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
                     iabs(q1 - q0) < beta && bs > 0;
  if (!fflag) return;
  int32_t o_p2 = p2, o_p1 = p1, o_p0 = p0, o_q0 = q0, o_q1 = q1, o_q2 = q2;
  const bool ap = iabs(p2 - p0) < beta;
  const bool aq = iabs(q2 - q0) < beta;
  if (bs < 4) {
    const int32_t tc0 = prm.tc0[clip3(1, 3, bs) - 1];
    const int32_t tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
    const int32_t delta =
        clip3(-tc, tc, (((q0 - p0) * 4) + (p1 - q1) + 4) >> 3);
    o_p0 = clip3(0, 255, p0 + delta);
    o_q0 = clip3(0, 255, q0 - delta);
    if (ap) o_p1 = p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1);
    if (aq) o_q1 = q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1);
  } else if (bs == 4) {
    const bool strong = iabs(p0 - q0) < ((alpha >> 2) + 2);
    if (strong && ap) {
      o_p0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      o_p1 = (p2 + p1 + p0 + q0 + 2) >> 2;
      o_p2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      o_p0 = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (strong && aq) {
      o_q0 = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      o_q1 = (q2 + q1 + q0 + p0 + 2) >> 2;
      o_q2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      o_q0 = (2 * q1 + q0 + p1 + 2) >> 2;
    }
  }
  p2 = o_p2;
  p1 = o_p1;
  p0 = o_p0;
  q0 = o_q0;
  q1 = o_q1;
  q2 = o_q2;
}

// Chroma: the same gate; bS < 4 moves p0 and q0 by a delta clipped to
// tc0 + 1, bS = 4 takes the weak filter.  p1 and q1 are read only.
__device__ __forceinline__ void chroma_line(int32_t p1, int32_t& p0,
                                            int32_t& q0, int32_t q1,
                                            int32_t bs, const EdgeParams& prm) {
  const bool fflag = iabs(p0 - q0) < prm.alpha && iabs(p1 - p0) < prm.beta &&
                     iabs(q1 - q0) < prm.beta && bs > 0;
  if (!fflag) return;
  if (bs < 4) {
    const int32_t tc = prm.tc0[clip3(1, 3, bs) - 1] + 1;
    const int32_t delta =
        clip3(-tc, tc, (((q0 - p0) * 4) + (p1 - q1) + 4) >> 3);
    const int32_t n_p0 = clip3(0, 255, p0 + delta);
    q0 = clip3(0, 255, q0 - delta);
    p0 = n_p0;
  } else if (bs == 4) {
    const int32_t n_p0 = (2 * p1 + p0 + q1 + 2) >> 2;
    q0 = (2 * q1 + q0 + p1 + 2) >> 2;
    p0 = n_p0;
  }
}

}  // namespace dbf
