// 4x4 integer transform pieces shared by the CUDA kernels: the forward
// core-transform butterfly, the dead-zone quantiser of one coefficient and
// the inverse-transform butterfly (spec 8.5.12).  All int32, arithmetic
// shifts, the same integers as `tpu264_torch/kernels/transform.py`.
//
// Used by `dct_quant.cu` and `i16_chroma_wave.cu` (one thread a block,
// everything in registers) and by `i4x4_wave.cu` (four threads a block, one
// row or column each).

#pragma once

#include <cstdint>

namespace t4x4 {

// One 4-point pass of W = Cf X Cf^T.
// Rows of Cf: [1 1 1 1], [2 1 -1 -2], [1 -1 -1 1], [1 -2 2 -1].
__device__ __forceinline__ void cf1d(int32_t& x0, int32_t& x1, int32_t& x2,
                                     int32_t& x3) {
  const int32_t s03 = x0 + x3, d03 = x0 - x3;
  const int32_t s12 = x1 + x2, d12 = x1 - x2;
  x0 = s03 + s12;
  x1 = 2 * d03 + d12;
  x2 = s03 - s12;
  x3 = d03 - 2 * d12;
}

// W = Cf X Cf^T of a raster 4x4 block held in registers.
__device__ __forceinline__ void fdct4x4(int32_t (&w)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) cf1d(w[c], w[4 + c], w[8 + c], w[12 + c]);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    cf1d(w[4 * r], w[4 * r + 1], w[4 * r + 2], w[4 * r + 3]);
}

// One 4-point pass of the Hadamard transform H4 X H4.
// Rows of H4: [1 1 1 1], [1 1 -1 -1], [1 -1 -1 1], [1 -1 1 -1].
__device__ __forceinline__ void h4_1d(int32_t& x0, int32_t& x1, int32_t& x2,
                                      int32_t& x3) {
  const int32_t s01 = x0 + x1, d01 = x0 - x1;
  const int32_t s23 = x2 + x3, d23 = x2 - x3;
  x0 = s01 + s23;
  x1 = s01 - s23;
  x2 = d01 - d23;
  x3 = d01 + d23;
}

// H4 X H4 of a raster 4x4 block held in registers.
__device__ __forceinline__ void hadamard4x4(int32_t (&w)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) h4_1d(w[c], w[4 + c], w[8 + c], w[12 + c]);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    h4_1d(w[4 * r], w[4 * r + 1], w[4 * r + 2], w[4 * r + 3]);
}

// lev = sign(w) * min((|w| * mf + f) >> qbits, lim)
__device__ __forceinline__ int32_t quant1(int32_t w, int32_t mf, int32_t f,
                                          int32_t qbits, int32_t lim) {
  const int32_t a = w < 0 ? -w : w;
  int32_t lev = (a * mf + f) >> qbits;
  lev = lev < lim ? lev : lim;
  return w < 0 ? -lev : (w > 0 ? lev : 0);
}

// One 4-point pass of the inverse transform (without the final rounding).
__device__ __forceinline__ void idct1d(int32_t& d0, int32_t& d1, int32_t& d2,
                                       int32_t& d3) {
  const int32_t e0 = d0 + d2, e1 = d0 - d2;
  const int32_t e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  d0 = e0 + e3;
  d1 = e1 + e2;
  d2 = e1 - e2;
  d3 = e0 - e3;
}

// Residual of a raster 4x4 block of dequantised coefficients held in
// registers: rows, then columns, then (x + 32) >> 6.
__device__ __forceinline__ void idct4x4(int32_t (&d)[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    idct1d(d[4 * r], d[4 * r + 1], d[4 * r + 2], d[4 * r + 3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) idct1d(d[c], d[4 + c], d[8 + c], d[12 + c]);
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = (d[i] + 32) >> 6;
}

}  // namespace t4x4
