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
// What bounds it on the card: operations, a squared difference at each of
// the 256 samples of the macroblock for each of 1,089 candidates at r =
// 16; the bytes are a 48 x 48 window and a 16 x 16 block a macroblock.
// Samples are 0..255 (the source is a picture's luma; the reference the
// edge-padded reconstruction, or `inter_frame.weight_luma`'s weighted
// copy, which it clips to 0..255), so the design holds four samples a
// word: `__vabsdiffu4` then `__dp4a(d, d, acc)` give four squared
// differences in two instructions, exact in the 32-bit sums (a quadrant's
// at most 64 x 255^2).  A macroblock has one block of threads holding its
// window and source as bytes in shared memory; a thread takes four
// neighbouring offsets dx of one dy (297 threads at r = 16, in 10 warps):
// for each source row it reads the five window words that the four
// offsets cover once, forms the shifted words with funnel shifts, and
// reads the source row as one broadcast 16-byte load, so a window word
// serves four candidates.  A warp's lanes take consecutive dy, whose rows
// lie 13 words apart, so no window read meets a bank conflict.  Each
// thread keeps the four quadrant sums of its four candidates and, for each
// block of `me.SEARCH_BLOCKS` up to the last one requested, its first
// cheapest candidate.
//
// Exactness: a block's cost is the sum of its quadrants' SSDs plus lam
// times the full-pel ue(se(v)) lengths of (dy - r, dx - r)
// (`me.mv_bits_table`), and of equal costs the first candidate in (dy, dx)
// raster order wins, as `torch.argmin` takes it: a thread visits its
// candidates in that order with a strict-less compare, and the threads'
// minima meet as (cost, candidate) keys (`key_of`) in a warp and then a
// block reduction.  Window and source starts are clamped as
// `interp.clamp_start` clamps them.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "inter_wave.cuh"

namespace {

constexpr int kMaxRange = 16;
constexpr int kMaxWin = 16 + 2 * kMaxRange;
constexpr int kRowWords = kMaxWin / 4 + 1;   // a window row, and a word for
                                             // the last offsets' shifts
constexpr int kMaxThreads = 320;             // 33 dy x 9 runs of 4 dx
constexpr int kWarps = kMaxThreads / 32;
constexpr int kBlocks = 9;                   // `me.SEARCH_BLOCKS`

// by value: `kernels/me_search.py` `pack_params`'s layout, the requested
// blocks' indices replaced by the output slot of each block of
// `me.SEARCH_BLOCKS` (-1: not requested); the kernel's `ssd[]` holds the
// blocks in that order (`test_torch_me_kernels.py` checks their quadrants)
struct Params {
  int wm, hm;             // picture in macroblocks
  int h, w;               // source plane
  int hp, wp;             // padded reference plane
  int pad, r, lam;
  int slot[kBlocks];
};

// (cost, candidate) as one key whose unsigned order is the cost's signed
// order, then the candidate's: the minimum is the first of equal costs
__device__ __forceinline__ uint64_t key_of(int32_t cost, uint32_t c) {
  return (uint64_t)((uint32_t)cost ^ 0x80000000u) << 32 | c;
}

// NB: the blocks of `me.SEARCH_BLOCKS` searched, a prefix of its order
// (16x16; top, bot, left, right; q0..q3): 1, 5 or 9
template <int NB>
__global__ void __launch_bounds__(kMaxThreads) me_search_kernel(
    const int32_t* __restrict__ orig,     // [h, w]
    const int32_t* __restrict__ ref,      // [hp, wp]
    const Params p,
    int32_t* __restrict__ out) {          // [n_names, wm * hm, 2]
  __shared__ uint32_t win[kMaxWin * kRowWords];
  __shared__ uint4 src[16];
  __shared__ uint64_t warp_best[kWarps][NB];
  const int tid = threadIdx.x, nt = blockDim.x, mb = blockIdx.x;
  const int mr = mb / p.wm, mc = mb % p.wm;
  const int n = 16 + 2 * p.r, span = 2 * p.r + 1;
  const int wy = iv::clamp_start(mr * 16 + p.pad - p.r, n, p.hp);
  const int wx = iv::clamp_start(mc * 16 + p.pad - p.r, n, p.wp);
  for (int i = tid; i < n * kRowWords; i += nt) {
    const int y = i / kRowWords, x = 4 * (i % kRowWords);
    const int32_t* s = ref + (int64_t)(wy + y) * p.wp + wx + x;
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (x + b < n) word |= (uint32_t)s[b] << (8 * b);
    win[i] = word;
  }
  if (tid < 16) {
    const int sy = iv::clamp_start(mr * 16, 16, p.h);
    const int sx = iv::clamp_start(mc * 16, 16, p.w);
    const int32_t* s = orig + (int64_t)(sy + tid) * p.w + sx;
    src[tid] = make_uint4(iv::pack4(s), iv::pack4(s + 4), iv::pack4(s + 8),
                          iv::pack4(s + 12));
  }
  __syncthreads();

  // this thread's offsets: dy, and dx = dx0 .. dx0 + 3
  const int runs = (span + 3) / 4;
  const bool valid = tid < span * runs;
  const int dy = valid ? tid % span : 0, dx0 = valid ? 4 * (tid / span) : 0;
  uint32_t q[4][4] = {};                   // [offset][quadrant] SSDs
#pragma unroll
  for (int y = 0; y < 16; ++y) {
    const uint4 s4 = src[y];
    const uint32_t s[4] = {s4.x, s4.y, s4.z, s4.w};
    const uint32_t* wr = win + (dy + y) * kRowWords + (dx0 >> 2);
    uint32_t w[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) w[j] = wr[j];
    const int half = y >> 3;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t c = k == 0 ? w[j] : __funnelshift_r(w[j], w[j + 1],
                                                           8 * k);
        const uint32_t d = __vabsdiffu4(c, s[j]);
        uint32_t& acc = q[k][2 * half + (j >> 1)];
        acc = __dp4a(d, d, acc);
      }
    }
  }

  // each block's first cheapest of this thread's candidates, in order
  int32_t best[NB];
  uint32_t at[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    best[b] = INT_MAX;                     // no cost exceeds it: if all
    at[b] = valid ? dy * span + dx0 : UINT_MAX;   // equal it, the first wins
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dx = dx0 + k;
    if (valid && dx < span) {
      const int32_t rate = p.lam * iv::mv_cost(dy - p.r, dx - p.r);
      const int32_t q0 = q[k][0], q1 = q[k][1], q2 = q[k][2], q3 = q[k][3];
      const int32_t top = q0 + q1, bot = q2 + q3;
      int32_t ssd[kBlocks] = {top + bot, top, bot, q0 + q2, q1 + q3,
                              q0, q1, q2, q3};
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int32_t c = ssd[b] + rate;
        if (c < best[b]) {
          best[b] = c;
          at[b] = dy * span + dx;
        }
      }
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    uint64_t v = key_of(best[b], at[b]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const uint64_t o = __shfl_xor_sync(iw::kFull, v, s);
      v = o < v ? o : v;
    }
    if (lane == 0) warp_best[warp][b] = v;
  }
  __syncthreads();
  if (tid < NB && p.slot[tid] >= 0) {
    uint64_t v = warp_best[0][tid];
    for (int k = 1; k < nt / 32; ++k)
      v = warp_best[k][tid] < v ? warp_best[k][tid] : v;
    const int c = (int)(uint32_t)v;
    int32_t* o = out + ((int64_t)p.slot[tid] * p.wm * p.hm + mb) * 2;
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
  const int n_names = *q++;
  if (p.r < 0 || p.r > kMaxRange || n_names < 1 || n_names > kBlocks)
    return (int)cudaErrorInvalidValue;
  // output k holds the block of index q[k] in `me.SEARCH_BLOCKS`
  int last = 0;
  for (int b = 0; b < kBlocks; ++b) p.slot[b] = -1;
  for (int k = 0; k < n_names; ++k) {
    const int b = q[k];
    if (b < 0 || b >= kBlocks || p.slot[b] >= 0)
      return (int)cudaErrorInvalidValue;
    p.slot[b] = k;
    last = b > last ? b : last;
  }
  const int span = 2 * p.r + 1;
  const int threads = (span * ((span + 3) / 4) + 31) & ~31;
  const int n_mbs = p.wm * p.hm;
  if (n_mbs > 0) {
    const dim3 grid(n_mbs);
    cudaStream_t s = (cudaStream_t)stream;
    if (last == 0)
      me_search_kernel<1><<<grid, threads, 0, s>>>(orig, ref, p, out);
    else if (last < 5)
      me_search_kernel<5><<<grid, threads, 0, s>>>(orig, ref, p, out);
    else
      me_search_kernel<9><<<grid, threads, 0, s>>>(orig, ref, p, out);
  }
  return (int)cudaGetLastError();
}
