// Kernel K4, wave form: the in-loop deblocking filter of one macroblock
// wave of a picture in one launch, luma and both chroma planes.
//
// Replaces tpu264/kernels/pallas_kernels.py `_deblock_luma_kernel` (K4) as
// the picture deblocker uses it: the reference's skewed deblocker
// (`tpu264/kernels/deblock.py` `make_deblocker_skewed`) walks the
// anti-diagonal waves d = 2r + c and, for each, slices a strip out of a
// skewed copy of the planes, filters the four vertical and the four
// horizontal luma edges and the two plus two chroma edges of every
// macroblock of the wave as separate array operations, and writes the
// strip back.  Here all of that, for one wave, is one kernel on the raster
// planes, in place.
//
// What bounds it on the card: neither bytes nor arithmetic (a macroblock
// window is 400 + 2 x 120 samples and a filtered line costs about 60
// operations) but the chain of dependent edges: edge k + 1 of a macroblock
// reads samples that edge k wrote, so a macroblock is eight luma steps
// (four vertical, then four horizontal), and the waves follow each other.
// The design gives each macroblock of the wave one block.  The block loads
// the macroblock's 20x20 luma window (4 columns of the left neighbour, 4
// rows of the top one) and the two 10x12 chroma windows into shared memory;
// one warp then runs the eight steps with a warp barrier between them:
// lanes 0-15 own one luma line each (8 samples in registers), lanes 16-23
// and 24-31 one chroma line of U and of V (their 2 + 2 edges run beside the
// first four luma steps); the block stores the windows back.
//
// Within a wave no two macroblocks touch the same sample: (r, c) writes
// itself, 3 columns of (r, c-1) and 3 rows of (r-1, c), and the wave's next
// macroblock is (r+1, c-2).  The order of the launches makes (r, c-1),
// (r-1, c) and (r-1, c+1) final before (r, c) runs.  The picture's left
// column and top row have no neighbour: those window parts are neither
// loaded nor stored, and bS is 0 on those edges by construction.
//
// The thresholds follow spec 8.7.2 per macroblock: the kernel takes the
// picture's luma and chroma QP grids [hm, wm] and FilterOffsetA/B.  An
// internal edge of MB (r, c) uses qp[r, c]; its left MB edge
// (qp[r, c] + qp[r, c-1] + 1) >> 1 and its top MB edge
// (qp[r, c] + qp[r-1, c] + 1) >> 1; indexA = clip(q + off_a, 0, 51)
// selects alpha and tc0, indexB = clip(q + off_b, 0, 51) beta, from the
// tables in constant memory.  Six threads derive the block's six parameter
// sets (luma and chroma x internal, left, top) before the edge steps.  An
// edge that must not be filtered (a slice edge at idc 2) comes with bS 0.
// All arithmetic is int32, equal to the plain torch deblocker bit for bit.
//
// The batched all-intra entry filters a chunk of F pictures of one
// geometry at once: one launch takes the wave in all F pictures, the
// picture in `blockIdx.y`, each plane, bS map and QP grid stacked
// [F, ...] contiguous.

#include <cstdint>
#include <cuda_runtime.h>

#include "deblock_filter.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLumaStride = 21;     // 20 window columns + 1: fewer conflicts
constexpr int kChromaStride = 13;   // 12 + 1

// spec Tables 8-16 and 8-17, as `tpu264_torch/ref/deblock.py` holds them
__constant__ int32_t kAlpha[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6, 7, 8, 9, 10,
    12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90,
    101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
__constant__ int32_t kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3, 3, 3, 3, 4,
    4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15,
    15, 16, 16, 17, 17, 18, 18};
__constant__ int32_t kTc0[52][3] = {
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 1},
    {0, 0, 1}, {0, 0, 1}, {0, 0, 1}, {0, 1, 1}, {0, 1, 1}, {1, 1, 1},
    {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 2}, {1, 1, 2}, {1, 1, 2},
    {1, 1, 2}, {1, 2, 3}, {1, 2, 3}, {2, 2, 3}, {2, 2, 4}, {2, 3, 4},
    {2, 3, 4}, {3, 3, 5}, {3, 4, 6}, {3, 4, 6}, {4, 5, 7}, {4, 5, 8},
    {4, 6, 9}, {5, 7, 10}, {6, 8, 11}, {6, 8, 13}, {7, 10, 14}, {8, 11, 16},
    {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

enum { kInternal = 0, kLeft = 1, kTop = 2 };

// the parameter set of an edge of MB (r, c) of one plane's QP grid
__device__ __forceinline__ dbf::EdgeParams edge_params(
    const int32_t* __restrict__ qp, int wm, int r, int c, int kind, int off_a,
    int off_b) {
  const int64_t at = (int64_t)r * wm + c;
  int32_t q = qp[at];
  if (kind == kLeft && c > 0) q = (q + qp[at - 1] + 1) >> 1;
  if (kind == kTop && r > 0) q = (q + qp[at - wm] + 1) >> 1;
  const int ia = dbf::clip3(0, 51, q + off_a);
  const int ib = dbf::clip3(0, 51, q + off_b);
  dbf::EdgeParams p;
  p.alpha = kAlpha[ia];
  p.beta = kBeta[ib];
  for (int k = 0; k < 3; ++k) p.tc0[k] = kTc0[ia][k];
  return p;
}

// window sample (wy, wx) exists: not in the unused corner, and not beyond
// the picture's top row or left column
__device__ __forceinline__ bool in_window(int wy, int wx, int top, int left,
                                          bool has_top, bool has_left) {
  if (wy < top && wx < left) return false;
  return (wy >= top || has_top) && (wx >= left || has_left);
}

__global__ void __launch_bounds__(kThreads) deblock_wave_kernel(
    int32_t* __restrict__ y,                 // [16 hm, 16 wm], in place
    int32_t* __restrict__ u,                 // [8 hm, 8 wm]
    int32_t* __restrict__ v,
    const int32_t* __restrict__ bs_v,        // [4 hm, 4 wm]
    const int32_t* __restrict__ bs_h,
    const int32_t* __restrict__ qp_y,        // [hm, wm] luma QP per MB
    const int32_t* __restrict__ qp_c,        // [hm, wm] chroma QP per MB
    int wm, int hm, int cp, int r0, int off_a, int off_b) {
  __shared__ int32_t lw[20 * kLumaStride];
  __shared__ int32_t cw[2][10 * kChromaStride];
  __shared__ int32_t bsv[16];     // [row of 4x4 blocks][vertical edge]
  __shared__ int32_t bsh[16];     // [horizontal edge][column of 4x4 blocks]
  __shared__ dbf::EdgeParams prm[2][3];   // [luma, chroma][internal, left, top]

  // picture f of the chunk: every array is [F, ...] contiguous
  const int64_t mbs = (int64_t)hm * wm, f = blockIdx.y;
  y += f * 256 * mbs;
  u += f * 64 * mbs;
  v += f * 64 * mbs;
  bs_v += f * 16 * mbs;
  bs_h += f * 16 * mbs;
  qp_y += f * mbs;
  qp_c += f * mbs;
  const int tid = threadIdx.x;
  const int r = r0 + blockIdx.x;
  const int c = cp - 2 * r;
  const bool has_top = r > 0, has_left = c > 0;
  const int w = 16 * wm, wc = 8 * wm, w4 = 4 * wm;
  int32_t* const planes[2] = {u, v};

  for (int i = tid; i < 400; i += kThreads) {
    const int wy = i / 20, wx = i % 20;
    int32_t s = 0;
    if (in_window(wy, wx, 4, 4, has_top, has_left))
      s = y[(int64_t)(16 * r - 4 + wy) * w + 16 * c - 4 + wx];
    lw[wy * kLumaStride + wx] = s;
  }
  for (int i = tid; i < 240; i += kThreads) {
    const int comp = i / 120, j = i % 120;
    const int wy = j / 12, wx = j % 12;
    int32_t s = 0;
    if (in_window(wy, wx, 2, 4, has_top, has_left))
      s = planes[comp][(int64_t)(8 * r - 2 + wy) * wc + 8 * c - 4 + wx];
    cw[comp][wy * kChromaStride + wx] = s;
  }
  if (tid < 16) {
    bsv[tid] = bs_v[(int64_t)(4 * r + (tid >> 2)) * w4 + 4 * c + (tid & 3)];
  } else if (tid < 32) {
    const int t = tid - 16;
    bsh[t] = bs_h[(int64_t)(4 * r + (t >> 2)) * w4 + 4 * c + (t & 3)];
  } else if (tid < 38) {
    const int t = tid - 32;
    prm[t / 3][t % 3] =
        edge_params(t < 3 ? qp_y : qp_c, wm, r, c, t % 3, off_a, off_b);
  }
  __syncthreads();

  if (tid < 32) {
    for (int step = 0; step < 8; ++step) {
      if (tid < 16) {
        // luma: steps 0-3 the vertical edges left to right (a line is a
        // window row), steps 4-7 the horizontal ones top to bottom (a line
        // is a window column); sample i of the line is at base + i * stride
        const bool vert = step < 4;
        const int k = step & 3;
        const int base = vert ? (4 + tid) * kLumaStride + 4 * k
                              : 4 * k * kLumaStride + 4 + tid;
        const int stride = vert ? 1 : kLumaStride;
        const int32_t bs = vert ? bsv[(tid >> 2) * 4 + k]
                                : bsh[k * 4 + (tid >> 2)];
        int32_t s[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = lw[base + i * stride];
        const int kind = k ? kInternal : (vert ? kLeft : kTop);
        dbf::luma_line(s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], bs,
                       prm[0][kind]);
#pragma unroll
        for (int i = 1; i < 7; ++i) lw[base + i * stride] = s[i];
      } else if (step < 4) {
        // chroma: steps 0-1 the vertical edges at window columns 4 and 8
        // (bS of luma edges 0 and 2), steps 2-3 the horizontal ones at
        // window rows 2 and 6
        int32_t* const win = cw[(tid - 16) >> 3];
        const int l = tid & 7;
        const bool vert = step < 2;
        const int k = 2 * (step & 1);
        const int base = vert ? (2 + l) * kChromaStride + 2 + 2 * k
                              : 2 * k * kChromaStride + 4 + l;
        const int stride = vert ? 1 : kChromaStride;
        const int32_t bs = vert ? bsv[(l >> 1) * 4 + k]
                                : bsh[k * 4 + (l >> 1)];
        const int32_t p1 = win[base], q1 = win[base + 3 * stride];
        int32_t p0 = win[base + stride], q0 = win[base + 2 * stride];
        const int kind = k ? kInternal : (vert ? kLeft : kTop);
        dbf::chroma_line(p1, p0, q0, q1, bs, prm[1][kind]);
        win[base + stride] = p0;
        win[base + 2 * stride] = q0;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int i = tid; i < 400; i += kThreads) {
    const int wy = i / 20, wx = i % 20;
    if (in_window(wy, wx, 4, 4, has_top, has_left))
      y[(int64_t)(16 * r - 4 + wy) * w + 16 * c - 4 + wx] =
          lw[wy * kLumaStride + wx];
  }
  for (int i = tid; i < 240; i += kThreads) {
    const int comp = i / 120, j = i % 120;
    const int wy = j / 12, wx = j % 12;
    if (in_window(wy, wx, 2, 4, has_top, has_left))
      planes[comp][(int64_t)(8 * r - 2 + wy) * wc + 8 * c - 4 + wx] =
          cw[comp][wy * kChromaStride + wx];
  }
}

}  // namespace

// Filters the macroblocks (r, cp - 2r), r = r0 .. r0 + n_rows - 1, of wave
// `cp` in place in each of `n_frames` pictures of wm x hm macroblocks, with
// the per-MB QP grids qp_y, qp_c [hm, wm] and the filter offsets off_a,
// off_b (FilterOffsetA/B); every array is [n_frames, ...] contiguous.
extern "C" int tpu264_deblock_wave(int32_t* y, int32_t* u, int32_t* v,
                                   const int32_t* bs_v, const int32_t* bs_h,
                                   const int32_t* qp_y, const int32_t* qp_c,
                                   int wm, int hm, int cp, int r0, int n_rows,
                                   int n_frames, int off_a, int off_b,
                                   void* stream) {
  if (n_rows > 0 && n_frames > 0) {
    const dim3 grid(n_rows, n_frames);
    deblock_wave_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        y, u, v, bs_v, bs_h, qp_y, qp_c, wm, hm, cp, r0, off_a, off_b);
  }
  return (int)cudaGetLastError();
}
