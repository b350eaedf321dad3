// Kernel KF: the integer full search of motion estimation, for every
// macroblock of a picture (or band) and every requested block of it, in one
// launch.
//
// Replaces no Pallas kernel: the reference writes this search in jnp
// (`tpu264/kernels/me.py:34` `full_search_16x16`, `:88`
// `full_search_parts`, `:156` `full_search_quads`, float32 convolutions
// over each macroblock's search window).  The port's plain version,
// `kernels/me.py` `full_search_blocks`, sums the SSD in int32 in one sweep
// of the four 8x8 quadrants, whose maps add up to the halves' and the
// macroblock's; eagerly it takes a launch or more for each of the 2r + 1
// rows of offsets and moves [n, 16, 2r + 1, 16] tensors through memory.
//
// What bounds it on the card: operations.  A candidate costs a subtract and
// a multiply-add at each of the 256 samples of the macroblock, 1,089
// candidates at r = 16; the bytes are a 48 x 48 window and a 16 x 16 block
// a macroblock.  The design gives a macroblock one block of 256 threads
// that holds its window and its source block in shared memory; the threads
// stride over the (2r + 1)^2 candidates in raster (dy, dx) order, each
// keeping the four quadrant sums of its candidate in registers.  A warp's
// threads read neighbouring words of a window row and one broadcast source
// word, so no read meets a bank conflict.
//
// Exactness: the SSDs are int32 (at most 256 x 255^2 < 2^24), a block's
// cost is the sum of its quadrants' SSDs plus lam times the full-pel
// ue(se(v)) lengths of (dy - r, dx - r) (`me.mv_bits_table`), and of equal
// costs the first candidate in (dy, dx) raster order wins, as `torch.argmin`
// takes it: each block's minimum is over (cost, candidate) packed into one
// 64-bit key.  Window and source starts are clamped as `interp.clamp_start`
// clamps them.

#include <cstdint>
#include <cuda_runtime.h>

#include "inter_wave.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRange = 16;
constexpr int kMaxWin = 16 + 2 * kMaxRange;
constexpr int kMaxNames = 9;

// by value, as `kernels/me_search.py` `pack_params` lays it out
struct Params {
  int wm, hm;             // picture in macroblocks
  int h, w;               // source plane
  int hp, wp;             // padded reference plane
  int pad, r, lam;
  int n_names;
  int quads[kMaxNames];   // bit q: quadrant q (raster) is part of the block
};

// (cost, candidate) as one key whose unsigned order is the cost's signed
// order, then the candidate's
__device__ __forceinline__ uint64_t key_of(int32_t cost, int c) {
  return (uint64_t)((uint32_t)cost ^ 0x80000000u) << 32 | (uint32_t)c;
}

__global__ void __launch_bounds__(kThreads) me_search_kernel(
    const int32_t* __restrict__ orig,     // [h, w]
    const int32_t* __restrict__ ref,      // [hp, wp]
    Params p,
    int32_t* __restrict__ out) {          // [n_names, wm * hm, 2]
  __shared__ int32_t win[kMaxWin * kMaxWin];
  __shared__ int32_t src[256];
  __shared__ uint64_t warp_best[kWarps][kMaxNames];
  const int tid = threadIdx.x, mb = blockIdx.x;
  const int mr = mb / p.wm, mc = mb % p.wm;
  const int n = 16 + 2 * p.r, span = 2 * p.r + 1;
  const int wy = iv::clamp_start(mr * 16 + p.pad - p.r, n, p.hp);
  const int wx = iv::clamp_start(mc * 16 + p.pad - p.r, n, p.wp);
  for (int i = tid; i < n * n; i += kThreads)
    win[i] = ref[(int64_t)(wy + i / n) * p.wp + wx + i % n];
  const int sy = iv::clamp_start(mr * 16, 16, p.h);
  const int sx = iv::clamp_start(mc * 16, 16, p.w);
  src[tid] = orig[(int64_t)(sy + tid / 16) * p.w + sx + tid % 16];
  __syncthreads();

  uint64_t best[kMaxNames];
#pragma unroll
  for (int k = 0; k < kMaxNames; ++k) best[k] = ~0ull;
  for (int c = tid; c < span * span; c += kThreads) {
    const int dy = c / span, dx = c % span;
    int32_t q[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int32_t a = 0, b = 0;
      for (int y = 8 * half; y < 8 * half + 8; ++y) {
        const int32_t* wr = win + (dy + y) * n + dx;
        const int32_t* sr = src + y * 16;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int32_t d = wr[x] - sr[x];
          a += d * d;
        }
#pragma unroll
        for (int x = 8; x < 16; ++x) {
          const int32_t d = wr[x] - sr[x];
          b += d * d;
        }
      }
      q[2 * half] = a;
      q[2 * half + 1] = b;
    }
    const int32_t rate = p.lam * iv::mv_cost(dy - p.r, dx - p.r);
#pragma unroll
    for (int k = 0; k < kMaxNames; ++k) {
      if (k < p.n_names) {
        const int m = p.quads[k];
        const int32_t ssd = (m & 1 ? q[0] : 0) + (m & 2 ? q[1] : 0) +
                            (m & 4 ? q[2] : 0) + (m & 8 ? q[3] : 0);
        const uint64_t key = key_of(ssd + rate, c);
        best[k] = key < best[k] ? key : best[k];
      }
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kMaxNames; ++k) {
    if (k < p.n_names) {
      uint64_t v = best[k];
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        const uint64_t o = __shfl_xor_sync(iw::kFull, v, s);
        v = o < v ? o : v;
      }
      if (lane == 0) warp_best[warp][k] = v;
    }
  }
  __syncthreads();
  if (tid < p.n_names) {
    uint64_t v = warp_best[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      v = warp_best[w][tid] < v ? warp_best[w][tid] : v;
    const int c = (int)(uint32_t)v;
    int32_t* o = out + ((int64_t)tid * p.wm * p.hm + mb) * 2;
    o[0] = c / span - p.r;
    o[1] = c % span - p.r;
  }
}

}  // namespace

// `params`: the host int32 array that `kernels/me_search.py` packs.
extern "C" int tpu264_me_search(const int32_t* orig, const int32_t* ref,
                                int32_t* out, const int32_t* params,
                                void* stream) {
  Params p;
  const int32_t* q = params;
  p.wm = *q++;
  p.hm = *q++;
  p.h = *q++;
  p.w = *q++;
  p.hp = *q++;
  p.wp = *q++;
  p.pad = *q++;
  p.r = *q++;
  p.lam = *q++;
  p.n_names = *q++;
  for (int k = 0; k < kMaxNames; ++k) p.quads[k] = *q++;
  if (p.r < 0 || p.r > kMaxRange || p.n_names < 1 || p.n_names > kMaxNames)
    return (int)cudaErrorInvalidValue;
  const int n_mbs = p.wm * p.hm;
  if (n_mbs > 0) {
    me_search_kernel<<<n_mbs, kThreads, 0, (cudaStream_t)stream>>>(orig, ref,
                                                                   p, out);
  }
  return (int)cudaGetLastError();
}
