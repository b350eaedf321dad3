// Kernel KS: the sub-pel refinement of motion estimation, for every
// macroblock of a picture (or band) and every block shape that has a search
// of its own (the macroblock, its 16x8 and 8x16 halves, its 8x8
// quadrants), in one launch.
//
// Replaces no Pallas kernel: the reference writes the refinement in jnp
// (`tpu264/kernels/me.py:214` `subpel_refine`, JM's
// `SubPelBlockMotionSearch`).  The port's plain version, `kernels/me.py`
// `subpel_refine`, refines one block shape a call; each call evaluates
// 2 x 9 candidates, and each evaluation (`interp.mc_luma`'s gathers, the
// SATD, the vector rate) is about 130 eager launches.
//
// The function: from mv = 4 * the full-pel vector, a step of 2 evaluates
// the centre, then the 8 neighbours in the order dy, dx over (-2, 0, 2); a
// neighbour replaces the best only where it is strictly cheaper; a step of
// 1 does the same around the step-2 winner.  A candidate costs the sum of
// `satd4x4` over the 4x4 blocks of the partition, taken on the source less
// its quarter-pel prediction (`interp.mc_luma`: the block start clamped as
// `interp.clamp_start` clamps it), plus lam times the vector's ue(se(v))
// lengths (`me.mv_cost`).
//
// What bounds it on the card: operations (about 12 a sample a candidate:
// one or two plane reads and their average, the difference, four
// butterfly stages, the absolute value and the sum); the bytes are the
// source and the few rows of the half-pel planes around each vector.  The
// design gives each (macroblock, partition) one block of 256 threads:
// thread (candidate, 4x4 block, sample) forms one predicted sample, a
// 16-lane shuffle Hadamard and a warp sum give the SATD of the warp's two
// 4x4 blocks (`inter_wave.cuh` `warp_satd`, the same as KP's), and the
// candidates' sums meet in shared memory; one thread then takes the
// strict-less choice in the candidates' order.  The partitions do not
// depend on each other, so one grid covers every shape.

#include <cstdint>
#include <cuda_runtime.h>

#include "inter_wave.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNames = 9;
constexpr int kCands = 9;

struct Shape {
  int oy, ox, bh, bw;     // the partition's place in the macroblock
};

// by value, as `kernels/me_subpel.py` `pack_params` lays it out
struct Params {
  int wm, hm;             // picture in macroblocks
  int h, w;               // source plane
  iv::Geometry g;         // padded planes (hp, wp; hc, wc unused)
  int pad, lam;
  int n_names;
  Shape shape[kMaxNames];
  int8_t qpel[16][7];     // fy * 4 + fx -> p1 dy1 dx1 p2 dy2 dx2 avg
};

// candidate k of a step s around the centre: k = 0 the centre, then
// (dy, dx) over (-s, 0, s) x (-s, 0, s) in that order, the centre skipped
__device__ __forceinline__ void candidate(int k, int s, int& dy, int& dx) {
  const int j = k == 0 ? 4 : (k <= 4 ? k - 1 : k);
  dy = (j / 3 - 1) * s;
  dx = (j % 3 - 1) * s;
}

__global__ void __launch_bounds__(kThreads) me_subpel_kernel(
    const int32_t* __restrict__ orig,     // [h, w]
    const int32_t* __restrict__ planes,   // [4, hp, wp]: G, b, h, j
    const int32_t* __restrict__ mv_int,   // [n_names, wm * hm, 2] full-pel
    const Params p,
    int32_t* __restrict__ out) {          // [n_names, wm * hm, 2] quarter-pel
  __shared__ int32_t src[256];
  __shared__ int32_t cost[kCands];
  __shared__ int32_t centre[2];
  const int tid = threadIdx.x, mb = blockIdx.x, name = blockIdx.y;
  const int n_mbs = p.wm * p.hm;
  const Shape sh = p.shape[name];
  const int mr = mb / p.wm, mc = mb % p.wm;
  const int by = mr * 16 + sh.oy, bx = mc * 16 + sh.ox;
  const int n_smp = sh.bh * sh.bw;        // 64, 128 or 256
  const int sy = iv::clamp_start(by, sh.bh, p.h);
  const int sx = iv::clamp_start(bx, sh.bw, p.w);
  if (tid < n_smp) {
    src[tid] = orig[(int64_t)(sy + tid / sh.bw) * p.w + sx + tid % sh.bw];
  }
  if (tid < kCands) cost[tid] = 0;
  if (tid == 0) {
    const int32_t* v = mv_int + ((int64_t)name * n_mbs + mb) * 2;
    centre[0] = 4 * v[0];
    centre[1] = 4 * v[1];
  }
  __syncthreads();
  const int y0 = by + p.pad, x0 = bx + p.pad;
  const int bw4 = sh.bw / 4;
  for (int step = 2; step >= 1; --step) {
    const int32_t cy = centre[0], cx = centre[1];
    // items (candidate, 4x4 block, sample): a warp's 32 lie in one
    // candidate, since n_smp is a multiple of 32
    for (int i = tid; i < kCands * n_smp; i += kThreads) {
      const int k = i / n_smp, j = i % n_smp;
      const int blk = j >> 4, ps = j & 15;
      const int y = 4 * (blk / bw4) + (ps >> 2), x = 4 * (blk % bw4) + (ps & 3);
      int dy, dx;
      candidate(k, step, dy, dx);
      const int32_t pred = iv::mc_luma_sample(planes, p.qpel, p.g, y0, x0,
                                              cy + dy, cx + dx, y, x, sh.bh,
                                              sh.bw);
      const int32_t t = iv::warp_satd(src[y * sh.bw + x] - pred, ps);
      if ((tid & 31) == 0) atomicAdd(&cost[k], t);
    }
    __syncthreads();
    if (tid == 0) {
      int32_t best = cost[0] + p.lam * iv::mv_cost(cy, cx);
      int32_t my = cy, mx = cx;
#pragma unroll
      for (int k = 1; k < kCands; ++k) {
        int dy, dx;
        candidate(k, step, dy, dx);
        const int32_t c = cost[k] + p.lam * iv::mv_cost(cy + dy, cx + dx);
        if (c < best) {
          best = c;
          my = cy + dy;
          mx = cx + dx;
        }
      }
      centre[0] = my;
      centre[1] = mx;
#pragma unroll
      for (int k = 0; k < kCands; ++k) cost[k] = 0;
    }
    __syncthreads();
  }
  if (tid == 0) {
    int32_t* o = out + ((int64_t)name * n_mbs + mb) * 2;
    o[0] = centre[0];
    o[1] = centre[1];
  }
}

}  // namespace

// `params`: the host int32 array that `kernels/me_subpel.py` packs.
extern "C" int tpu264_me_subpel(const int32_t* orig, const int32_t* planes,
                                const int32_t* mv_int, int32_t* out,
                                const int32_t* params, void* stream) {
  Params p;
  const int32_t* q = params;
  p.wm = *q++;
  p.hm = *q++;
  p.h = *q++;
  p.w = *q++;
  p.g.wm = p.wm;
  p.g.hm = p.hm;
  p.g.hp = *q++;
  p.g.wp = *q++;
  p.g.hc = p.g.wc = 0;
  p.pad = *q++;
  p.lam = *q++;
  p.n_names = *q++;
  for (int k = 0; k < kMaxNames; ++k) {
    p.shape[k].oy = *q++;
    p.shape[k].ox = *q++;
    p.shape[k].bh = *q++;
    p.shape[k].bw = *q++;
  }
  for (int i = 0; i < 16; ++i)
    for (int k = 0; k < 7; ++k) p.qpel[i][k] = (int8_t)*q++;
  if (p.n_names < 1 || p.n_names > kMaxNames) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < p.n_names; ++k) {
    const Shape& s = p.shape[k];
    if ((s.bh != 8 && s.bh != 16) || (s.bw != 8 && s.bw != 16))
      return (int)cudaErrorInvalidValue;
  }
  const int n_mbs = p.wm * p.hm;
  if (n_mbs > 0) {
    me_subpel_kernel<<<dim3(n_mbs, p.n_names), kThreads, 0,
                       (cudaStream_t)stream>>>(orig, planes, mv_int, p, out);
  }
  return (int)cudaGetLastError();
}
