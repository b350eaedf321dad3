// Kernel K4: the luma deblocking edge filter over 8-sample lines.
//
// Replaces tpu264/kernels/pallas_kernels.py `_deblock_luma_kernel` (via
// `filter_luma_lines`), the spec 8.7.2 luma filter over lines p3..q3:
// gate |p0-q0| < alpha, |p1-p0| < beta, |q1-q0| < beta and bS > 0; bS < 4
// the normal filter with tc = tc0 + ap + aq; bS = 4 the strong or weak
// filter.  The TPU kernel lays lines on lanes and p3..q3 on sublanes;
// here each thread owns one line and keeps its 8 samples in registers
// (the filter itself is `dbf::luma_line` of `deblock_filter.cuh`).
//
// This is the entry on slabs of lines, for callers that hold per-line bS
// (the P and B paths); the all-intra deblocker runs the wave kernel of
// `deblock_wave.cu` instead.  What bounds it on the card: at a few hundred
// lines a call is a launch plus 64 bytes in and 32 out per line.  The
// design is a single pass with two 16-byte loads and two 16-byte stores
// per line.

#include <cstdint>
#include <cuda_runtime.h>

#include "deblock_filter.cuh"

namespace {

__global__ void deblock_luma_kernel(const int32_t* __restrict__ win,
                                    const int32_t* __restrict__ bs_lines,
                                    int32_t* __restrict__ out, int n_lines,
                                    dbf::EdgeParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lines) return;
  const int4* src = reinterpret_cast<const int4*>(win + 8 * (int64_t)i);
  int4 lo = src[0], hi = src[1];
  dbf::luma_line(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w, bs_lines[i],
                 prm);
  int4* dst = reinterpret_cast<int4*>(out + 8 * (int64_t)i);
  dst[0] = lo;
  dst[1] = hi;
}

}  // namespace

extern "C" int tpu264_deblock_luma(const int32_t* win, const int32_t* bs,
                                   int32_t* out, int n_lines, int alpha,
                                   int beta, const int32_t* tc0_3,
                                   void* stream) {
  dbf::EdgeParams prm;
  prm.alpha = alpha;
  prm.beta = beta;
  for (int k = 0; k < 3; ++k) prm.tc0[k] = tc0_3[k];
  if (n_lines > 0) {
    const int threads = 128;
    const int grid = (n_lines + threads - 1) / threads;
    deblock_luma_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        win, bs, out, n_lines, prm);
  }
  return (int)cudaGetLastError();
}
