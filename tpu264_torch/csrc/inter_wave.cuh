// Device code shared by the two inter wave kernels, the P wave kernel KP
// (`p_wave.cu`) and the B wave kernel KB (`b_wave.cu`): the reference
// planes' geometry, the vector rate, the neighbour vectors and the median
// prediction of spec 8.4.1.3 from the wave loop's three-channel cell maps,
// and one thread's sample of a quarter-pel luma or an eighth-pel chroma
// prediction, read straight from the planes.  Both kernels give a
// macroblock lane one block of `iw::kThreads` threads laid out as in
// `intra_wave.cuh` (thread (blk, p) owns sample p of 4x4 block blk).
// All arithmetic is int32 with arithmetic shifts, equal to the plain torch
// versions (`coding/inter_frame.py`, `coding/b_frame.py`) bit for bit.
// At the end, the packed byte and 16-bit lane arithmetic of the motion
// search's kernels KF and KS, equal to `kernels/me.py` bit for bit.

#pragma once

#include <cstdint>

#include "intra_wave.cuh"

namespace iv {

constexpr int kPad = 24;           // luma padding of the reference planes
constexpr int kUnavail = -2;       // map codes: outside the slice
constexpr int kIntra = -1;         // intra macroblock, or list not used

struct Geometry {
  int wm, hm;        // picture in macroblocks
  int hp, wp;        // padded luma planes
  int hc, wc;        // padded chroma planes
};

// a block's start as `jax.lax.dynamic_slice` reads it: a negative start
// counts from the end, then the block is moved inside [0, dim)
__device__ __forceinline__ int clamp_start(int s, int size, int dim) {
  s = s < 0 ? s + dim : s;
  s = s < dim - size ? s : dim - size;
  return s > 0 ? s : 0;
}

// ue(se(v)) code length of one vector difference component
__device__ __forceinline__ int32_t mvd_bits1(int32_t v) {
  const int32_t k = v > 0 ? 2 * v - 1 : -2 * v;
  return 2 * (31 - __clz(k + 1)) + 1;
}

__device__ __forceinline__ int32_t mv_cost(int32_t dy, int32_t dx) {
  return mvd_bits1(dy) + mvd_bits1(dx);
}

__device__ __forceinline__ int32_t median3(int32_t a, int32_t b, int32_t c) {
  return max(min(max(a, b), c), min(a, b));
}

// One thread: the neighbour vectors A, B, C of the lane at (r, c) (D in C's
// place where C is missing) from one list's maps mv_map [3,hm+2,wm+2,2] and
// ref_map [3,hm+2,wm+2] -> ref[3], mv[3][2]; a neighbour outside the slice
// is kUnavail, and a vector whose ref is not 0 or above reads as zero.
__device__ __forceinline__ void neighbour_vectors(
    const int32_t* mv_map, const int32_t* ref_map, const Geometry& g, int r,
    int c, bool at, bool al, bool atl, bool atr, int32_t (&ref)[3],
    int32_t (&mv)[3][2]) {
  const int wm2 = g.wm + 2, hm2 = g.hm + 2;
  // cells: channel 0 = top-right 4x4 cell, 1 = bottom-left, 2 = bottom-right
  const int cell[4] = {(0 * hm2 + r + 1) * wm2 + c,     // A: left MB
                       (1 * hm2 + r) * wm2 + c + 1,     // B: top MB
                       (1 * hm2 + r) * wm2 + c + 2,     // C: top-right MB
                       (2 * hm2 + r) * wm2 + c};        // D: top-left MB
  const bool ok[4] = {al, at, atr, atl};
  int32_t rf[4], m[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rf[i] = ok[i] ? ref_map[cell[i]] : kUnavail;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      m[i][k] = rf[i] >= 0 ? mv_map[2 * cell[i] + k] : 0;
  }
  const int ci = rf[2] == kUnavail ? 3 : 2;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = i == 2 ? ci : i;
    ref[i] = rf[j];
    mv[i][0] = m[j][0];
    mv[i][1] = m[j][1];
  }
}

// The median prediction of ref 0 (spec 8.4.1.3) from neighbours A, B, C:
// only A available -> A; exactly one neighbour with ref 0 -> its vector;
// else the component-wise median.
__device__ __forceinline__ void median_prediction(const int32_t (&ref)[3],
                                                  const int32_t (&mv)[3][2],
                                                  int32_t* pred) {
  const bool only_a =
      ref[1] == kUnavail && ref[2] == kUnavail && ref[0] != kUnavail;
  const int sa = ref[0] == 0, sb = ref[1] == 0, sc = ref[2] == 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int32_t a = mv[0][k], b = mv[1][k], cc = mv[2][k];
    pred[k] = only_a ? a
                     : (sa + sb + sc == 1 ? sa * a + sb * b + sc * cc
                                          : median3(a, b, cc));
  }
}

// Sample (y, x) of the bh x bw quarter-pel prediction of the block whose
// padded-plane origin is (y0, x0), for vector (mvy, mvx) (`interp.mc_luma`):
// planes [4,hp,wp] (G, b, h, j); qpel[fy * 4 + fx] = p1 dy1 dx1 p2 dy2 dx2
// avg.
__device__ __forceinline__ int32_t mc_luma_sample(const int32_t* planes,
                                                  const int8_t (*qpel)[7],
                                                  const Geometry& g, int y0,
                                                  int x0, int32_t mvy,
                                                  int32_t mvx, int y, int x,
                                                  int bh, int bw) {
  const int8_t* t = qpel[(mvy & 3) * 4 + (mvx & 3)];
  const int by = y0 + (mvy >> 2), bx = x0 + (mvx >> 2);
  const int plane = g.hp * g.wp;
  const int ya = clamp_start(by + t[1], bh, g.hp);
  const int xa = clamp_start(bx + t[2], bw, g.wp);
  const int32_t a = planes[t[0] * plane + (ya + y) * g.wp + xa + x];
  if (!t[6]) return a;
  const int yb = clamp_start(by + t[4], bh, g.hp);
  const int xb = clamp_start(bx + t[5], bw, g.wp);
  const int32_t bv = planes[t[3] * plane + (yb + y) * g.wp + xb + x];
  return (a + bv + 1) >> 1;
}

// Sample (cy, cx) of the bh x bw eighth-pel bilinear chroma prediction
// (`interp.mc_chroma`): a (bh+1) x (bw+1) window at the clamped start.
__device__ __forceinline__ int32_t mc_chroma_sample(const int32_t* cpad,
                                                    const Geometry& g,
                                                    int cy0, int cx0,
                                                    int32_t mvy, int32_t mvx,
                                                    int cy, int cx, int bh,
                                                    int bw) {
  const int fy = mvy & 7, fx = mvx & 7;
  const int sy = clamp_start(cy0 + (mvy >> 3), bh + 1, g.hc);
  const int sx = clamp_start(cx0 + (mvx >> 3), bw + 1, g.wc);
  const int32_t* w = cpad + (sy + cy) * g.wc + sx + cx;
  return ((8 - fx) * (8 - fy) * w[0] + fx * (8 - fy) * w[1] +
          (8 - fx) * fy * w[g.wc] + fx * fy * w[g.wc + 1] + 32) >> 6;
}

// The SATD (DC included, `transform.satd4x4`) of the 4x4 block whose 16
// differences d sit in 16 neighbouring lanes (p = the lane's sample), plus
// that of the other block of the warp: the warp's sum, in every lane.
__device__ __forceinline__ int32_t warp_satd(int32_t d, int p) {
  int32_t t = iw::iabs(iw::wht16(d, p));
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) t += __shfl_xor_sync(iw::kFull, t, m);
  t = (t + 1) >> 1;                                  // this 4x4 block's SATD
  return t + __shfl_xor_sync(iw::kFull, t, 16);      // + the warp's other
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) v += __shfl_xor_sync(iw::kFull, v, m);
  return v;
}

// ---- the motion search's packed arithmetic (KF `me_search.cu`, KS
// `me_subpel.cu`): samples 0..255 held four to a word, first sample in the
// low byte ----

__device__ __forceinline__ uint32_t pack4(const int32_t* s) {
  return (uint32_t)s[0] | (uint32_t)s[1] << 8 | (uint32_t)s[2] << 16 |
         (uint32_t)s[3] << 24;
}

// the four samples from byte o of a byte array held as words (any
// alignment; the word after the last one read must exist)
__device__ __forceinline__ uint32_t bytes4(const uint32_t* s, int o) {
  return __funnelshift_r(s[o >> 2], s[(o >> 2) + 1], 8 * (o & 3));
}

// Two 16-bit lanes a word, each holding its value plus kBias: a lane-wise
// sum or difference is then one 32-bit add with a constant, exact while
// every lane stays in [0, 2^16) (no carry or borrow crosses lanes).
constexpr uint32_t kBias = 4096u;
constexpr uint32_t kBias2 = kBias * 0x10001u;

// samples 0, 2 and 1, 3 of a row word as biased lane pairs
__device__ __forceinline__ uint32_t lanes02(uint32_t row) {
  return __byte_perm(row, 0, 0x4240);
}
__device__ __forceinline__ uint32_t lanes13(uint32_t row) {
  return __byte_perm(row, 0, 0x4341);
}

// (a, b) -> (a + b, a - b), lane-wise, biased in and out
__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b) {
  const uint32_t s = a + b - kBias2;
  b = a - b + kBias2;
  a = s;
}

// `transform.satd4x4` (DC included) of the 4x4 block whose source rows
// are src[r] = (lanes02, lanes13) + kBias2 and whose prediction rows are
// the words pred[r].  The differences sit two to a word, (column c, column
// c + 2); three butterfly stages across words (column bit 0, row bits 0
// and 1) leave |v| <= 8 x 255, so every lane stays in range.  The last
// stage, column bit 1, pairs the two lanes of a word: as |x + y| + |x - y|
// = 2 max(|x|, |y|), the block's (sum + 1) >> 1 is the sum of max(|x|,
// |y|) over the eight words, which is max(max(x, y), -min(x, y)) on lanes
// regrouped two words at a time.  Each instruction works on two samples.
__device__ __forceinline__ int32_t satd4x4_packed(const uint32_t (&src)[4][2],
                                                  const uint32_t (&pred)[4]) {
  uint32_t d[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    d[r][0] = src[r][0] - lanes02(pred[r]);
    d[r][1] = src[r][1] - lanes13(pred[r]);
    butterfly(d[r][0], d[r][1]);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    butterfly(d[0][e], d[1][e]);
    butterfly(d[2][e], d[3][e]);
    butterfly(d[0][e], d[2][e]);
    butterfly(d[1][e], d[3][e]);
  }
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t x = __byte_perm(d[r][0], d[r][1], 0x5410);   // low lanes
    const uint32_t y = __byte_perm(d[r][0], d[r][1], 0x7632);   // high lanes
    const uint32_t m =
        __vmaxu2(__vmaxu2(x, y), 2 * kBias2 - __vminu2(x, y));
    acc = __dp2a_lo(m, 0x0101u, acc);          // both lanes, each + kBias
  }
  return (int32_t)(acc - 8 * kBias);
}

}  // namespace iv
