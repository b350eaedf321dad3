// The frame form shared by the two inter kernels, KP (`p_wave.cu`) and KB
// (`b_wave.cu`): one cooperative launch runs a picture's waves [w0, w1) in
// order, with a grid-wide barrier between waves, and each macroblock lane of
// a wave gets one warp-specialised block of `kThreads` threads:
//   warps 0-4 (`kI4` threads) run the lane's Intra4x4 search
//     (`i4x4_body.cuh`, K2's layout) on named barrier 1;
//   warps 5-12 (`kInter` threads) run the rest of the wave body in the
//     layout of `intra_wave.cuh` on named barrier 2: the context, the vector
//     prediction and every inter, I16x16 and chroma cost, which do not
//     depend on the Intra4x4 result, overlap the Intra4x4 chain;
//   the two groups join with a block barrier just before the choice, which
//   is the first reader of the Intra4x4 results (`I4Out`, in shared memory).
// A wave narrower than the grid leaves blocks idle; a wider one makes a
// block take lanes blockIdx.x, blockIdx.x + gridDim.x, ...  Every block
// reaches every grid barrier.  What a wave writes (the border buffers, the
// vector maps) other blocks read in the next wave: through plain pointers,
// never the read-only cache.

#pragma once

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "i4x4_body.cuh"
#include "intra_wave.cuh"

namespace fw {

constexpr int kI4 = i4::kThreads;          // 160
constexpr int kInter = iw::kThreads;       // 256
constexpr int kThreads = kI4 + kInter;     // 416
static_assert(kI4 % 32 == 0, "the groups must be whole warps");

using I4Sync = i4::NamedSync<1, kI4>;

// the inter group's barrier
__device__ __forceinline__ void inter_sync() {
  i4::NamedSync<2, kInter>()();
}

// both groups: the Intra4x4 results are ready (or the lane is done)
__device__ __forceinline__ void join() { __syncthreads(); }

// The lane's Intra4x4 results, as K2's wave form writes them a lane.
struct I4Out {
  alignas(16) int32_t mb4[256];   // reconstruction, raster
  int32_t coeffs4[256];           // levels, zig-zag, a 4x4 block in coding order
  int32_t modebuf[16];            // mode grid, raster
  int32_t j4;                     // cost
};

// Waves [w0, w1) of `bmax` lanes each; row b = w * bmax + lane of the
// per-wave arrays coords [.,2], avail [.,4], gy [.,16,16] and modes [.,16]
// (the Intra4x4 modes in coding order, an output).  `inter(b, tid)` is the
// inter group's lane body (tid = 0 .. kInter - 1), which calls `join()`
// once, before it reads `o`.
template <class Inter>
__device__ __forceinline__ void frame_loop(
    const iw::Borders& bd, int wm, const int32_t* coords,
    const uint8_t* avail, const int32_t* gy, int32_t* modes,
    const i4::Params& i4p, int bmax, int w0, int w1, i4::Smem& s4,
    I4Out& o, Inter inter) {
  const int rs = 1 + 16 * wm + 8, mrs = 1 + 4 * wm + 4;
  for (int w = w0; w < w1; ++w) {
    for (int lane = blockIdx.x; lane < bmax; lane += gridDim.x) {
      const int b = w * bmax + lane;
      if (threadIdx.x < kI4) {
        const int r = coords[2 * b], c = coords[2 * b + 1];
        i4::Lane ln;
        ln.orig = gy + (int64_t)b * 256;
        ln.ltop = bd.row_y + r * rs + 16 * c;
        ln.lleft = bd.col_y + r * 16;
        ln.modes_top = bd.modes_row + r * mrs + 4 * c + 1;
        ln.modes_left = bd.modes_col + r * 4;
        ln.at = avail[4 * b] != 0;
        ln.al = avail[4 * b + 1] != 0;
        ln.atl = avail[4 * b + 2] != 0;
        ln.atr = avail[4 * b + 3] != 0;
        ln.recon = o.mb4;
        ln.mode_grid = o.modebuf;
        ln.modes_zz = modes + b * 16;
        ln.coeffs = o.coeffs4;
        ln.cost = &o.j4;
        i4::body(s4, i4p, ln, threadIdx.x, I4Sync());
        join();
      } else {
        inter(b, threadIdx.x - kI4);
      }
      join();                     // the lane's shared memory is free again
    }
    if (w + 1 < w1) cooperative_groups::this_grid().sync();
  }
}

// host: the most blocks of `kernel` (kThreads each, static shared memory
// only) that fit on the current card at once
template <class K>
inline int co_resident(K kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  *blocks = coop ? sms * per_sm : 0;
  return (int)e;
}

// host: a cooperative launch of `grid` blocks; a refused launch returns
// its error (and leaves no error behind for the next launch to report)
template <class K>
inline int launch(K kernel, int grid, void** args, void* stream) {
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace fw
