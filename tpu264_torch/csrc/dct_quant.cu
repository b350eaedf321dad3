// Kernels K2 and K3: forward 4x4 integer DCT, optionally fused with the
// dead-zone quantiser.
//
// Replaces tpu264/kernels/pallas_kernels.py `_dct_quant_kernel` (K2, via
// `fdct_quant4x4`) and `_dct_kernel` (K3, via `fdct4x4`).  The TPU kernels
// multiply a [16,16] Kronecker matrix by a [16, N] block slab on the MXU
// in float32; here each thread owns one 4x4 block and runs the integer
// butterfly W = Cf X Cf^T in registers, then (K2) the quantiser
//   lev = sign(W) * min((|W| * MF[pos] + f) >> qbits, limit[pos])
// in int32.  For 8-bit residuals (|X| <= 255) |W| <= 36 * 255 < 2^14 and
// |W| * MF < 2^28, so the whole kernel is exact in int32 and equal to the
// torch plain version.
//
// What bounds it on the card: at the encoder's shapes (<= 40 blocks for
// an I4x4 step, <= 720 for I16x16 at 720p) a call is a launch; the bytes
// moved (128 per block) are negligible.  The design keeps one launch per
// call with no staging through shared memory and no second pass; K3 is
// the same kernel with `quantize` = 0.  The butterfly and the quantiser are
// the device functions of `transform4x4.cuh`, which the I4x4 wave kernel
// (`i4x4_wave.cu`) uses too: on the all-intra path that kernel does the
// I4x4 body's transform, and this entry stays for callers that hold whole
// slabs of blocks (the P and B wave bodies).

#include <cstdint>
#include <cuda_runtime.h>

#include "transform4x4.cuh"

namespace {

struct QuantParams {
  int32_t mf[16];     // MF[qp % 6] in raster order
  int32_t lim[16];    // level limit per position for this qp
  int32_t f;          // rounding offset: 2^qbits / 3 (intra) or / 6
  int32_t qbits;      // 15 + qp / 6
};

__global__ void dct_quant_kernel(const int32_t* __restrict__ x,
                                 int32_t* __restrict__ out, int n_blocks,
                                 int quantize, QuantParams qp) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= n_blocks) return;
  const int4* src = reinterpret_cast<const int4*>(x + 16 * (int64_t)blk);
  int32_t w[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int4 v = src[r];
    w[4 * r + 0] = v.x;
    w[4 * r + 1] = v.y;
    w[4 * r + 2] = v.z;
    w[4 * r + 3] = v.w;
  }
  t4x4::fdct4x4(w);
  if (quantize) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[i] = t4x4::quant1(w[i], qp.mf[i], qp.f, qp.qbits, qp.lim[i]);
  }
  int4* dst = reinterpret_cast<int4*>(out + 16 * (int64_t)blk);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    dst[r] = make_int4(w[4 * r], w[4 * r + 1], w[4 * r + 2], w[4 * r + 3]);
}

}  // namespace

extern "C" int tpu264_dct_quant(const int32_t* x, int32_t* out, int n_blocks,
                                int quantize, const int32_t* mf16,
                                const int32_t* lim16, int f, int qbits,
                                void* stream) {
  QuantParams qp;
  for (int i = 0; i < 16; ++i) {
    qp.mf[i] = quantize ? mf16[i] : 0;
    qp.lim[i] = quantize ? lim16[i] : 0;
  }
  qp.f = f;
  qp.qbits = qbits;
  if (n_blocks > 0) {
    const int threads = 128;
    const int grid = (n_blocks + threads - 1) / threads;
    dct_quant_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        x, out, n_blocks, quantize, qp);
  }
  return (int)cudaGetLastError();
}
