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
// What bounds it on the card: operations (the average of two planes at
// quarter positions, the difference, four butterfly stages, the absolute
// value and the sum at each sample of 17 evaluations); the bytes are the
// source and the few rows of the half-pel planes around each vector.  The
// design gives each (macroblock, block name, 4x4 block) one thread, a
// block of threads several macroblocks (4 with the nine names of
// `me.SEARCH_BLOCKS`, 5 with the five of a B list, 16 with the MB alone).
// The block stages each macroblock's source once, as bytes, and for each
// name the (bh + 2) x (bw + 2) samples of each of the four planes that its
// 17 evaluations reach (every start lies within one sample above or left
// and two below or right of the full-pel vector's block), also as bytes,
// one thread a plane row with all of the row's loads in flight: every
// plane sample is 0..255 (`interp.luma_planes` clamps b, h and j; G is
// the edge-padded reference, whose samples the encoders keep in 0..255,
// the weighted one clipped by `inter_frame.weight_luma`).  A thread reads
// a prediction row as one word (`__vavgu4` is the quarter-pel average),
// takes its 4x4 block's SATD in registers two samples an instruction
// (`inter_wave.cuh` `satd4x4_packed`) at the 9 candidates of a step, then
// the 9 sums over the name's blocks, which are neighbouring lanes aligned
// to their number, by shuffles; every lane of the name then makes the
// plain version's strict-less choice in candidate order itself, so no
// barrier, atomic or one-thread step follows the staging.  Step 1 keeps
// the step-2 winner's cost as its centre's: 17 evaluations a name.  A name
// whose window would leave the planes (a start that `interp.clamp_start`
// moves) is not staged: its threads read each sample from the planes as
// KP does (`inter_wave.cuh` `mc_luma_sample`).

#include <cstdint>
#include <cuda_runtime.h>

#include "inter_wave.cuh"

namespace {

constexpr int kMaxNames = 9;
constexpr int kCands = 9;
constexpr int kThreads = 256;            // a block's threads, at most
constexpr int kMaxMbs = kThreads / 16;   // a block's macroblocks, at most
constexpr int kSmemBytes = 44 * 1024;    // a block's staged bytes, at most
// a staged plane row: bw + 2 samples as bytes in 5 words (the last ones
// zero; the word after a row's last read sample exists)
constexpr int kRowWords = 5;
constexpr int kSrcWords = 64 + 1;        // a 16x16 source, a word of slack

struct Shape {
  int oy, ox, bh, bw;     // the partition's place in the macroblock
};

// by value, as `kernels/me_subpel.py` `pack_params` lays it out, then the
// lane and row layout that the entry derives from it
struct Params {
  int wm, hm;             // picture in macroblocks
  int h, w;               // source plane
  iv::Geometry g;         // padded planes (hp, wp; hc, wc unused)
  int pad, lam;
  int n_names;
  Shape shape[kMaxNames];
  int8_t qpel[16][7];     // fy * 4 + fx -> p1 dy1 dx1 p2 dy2 dx2 avg
  int first[kMaxNames];   // name k's 4x4 blocks: an MB's lanes first[k] ..
  int row[kMaxNames + 1]; // and its staged plane rows (4 x (bh + 2)) here
  int lanes;              // an MB's lanes, a multiple of 16
  int mbs;                // a block's macroblocks
};

// candidate k of a step s around the centre: k = 0 the centre, then
// (dy, dx) over (-s, 0, s) x (-s, 0, s) in that order, the centre skipped
__device__ __forceinline__ void candidate(int k, int s, int& dy, int& dx) {
  const int j = k == 0 ? 4 : (k <= 4 ? k - 1 : k);
  dy = (j / 3 - 1) * s;
  dx = (j % 3 - 1) * s;
}

// a name's vector and whether its plane rows are staged (no start of its
// evaluations is clamped)
struct Centre {
  int vy, vx;
  bool fast;
};

__global__ void __launch_bounds__(kThreads) me_subpel_kernel(
    const int32_t* __restrict__ orig,     // [h, w]
    const int32_t* __restrict__ planes,   // [4, hp, wp]: G, b, h, j
    const int32_t* __restrict__ mv_int,   // [n_names, wm * hm, 2] full-pel
    const Params p,
    int32_t* __restrict__ out) {          // [n_names, wm * hm, 2] quarter-pel
  // a block's macroblocks g, each with its source and its names' rows:
  // words [g * per_mb, + kSrcWords) and then rows of kRowWords
  extern __shared__ uint32_t smem[];
  __shared__ Centre centres[kMaxMbs][kMaxNames];
  __shared__ uint32_t qtab[16];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_mbs = p.wm * p.hm, n_names = p.n_names, rows = p.row[n_names];
  const int per_mb = kSrcWords + rows * kRowWords;
  const int mb0 = blockIdx.x * p.mbs;
  for (int i = tid; i < p.mbs * kSrcWords; i += nt) {
    const int g = i / kSrcWords, j = i - g * kSrcWords, mb = mb0 + g;
    uint32_t word = 0;
    if (j < 64 && mb < n_mbs) {
      const int mr = mb / p.wm, mc = mb % p.wm;
      const int sy = iv::clamp_start(mr * 16, 16, p.h);
      const int sx = iv::clamp_start(mc * 16, 16, p.w);
      word = iv::pack4(orig + (int64_t)(sy + (j >> 2)) * p.w + sx +
                       4 * (j & 3));
    }
    smem[g * per_mb + j] = word;
  }
  if (tid < 16) {
    // the position table, one word an entry: p1 | dy1 << 2 | dx1 << 3 |
    // p2 << 4 | dy2 << 6 | dx2 << 7 | avg << 8
    const int8_t* t = p.qpel[tid];
    qtab[tid] = t[0] | t[1] << 2 | t[2] << 3 | t[3] << 4 | t[4] << 6 |
                t[5] << 7 | t[6] << 8;
  }
  // one thread a staged plane row: of MB g's name k, plane q, row y of
  // the (bh + 2) x (bw + 2) samples that the name's 17 evaluations reach,
  // from one sample above and left of its full-pel vector's block; all of
  // the row's loads in flight at once
  for (int t = tid; t < p.mbs * rows; t += nt) {
    const int g = t / rows, r = t - g * rows, mb = mb0 + g;
    if (mb >= n_mbs) continue;
    int k = 0;
#pragma unroll 1
    while (k + 1 < n_names && r >= p.row[k + 1]) ++k;
    const Shape sh = p.shape[k];
    const int mr = mb / p.wm, mc = mb % p.wm;
    const int32_t* v = mv_int + ((int64_t)k * n_mbs + mb) * 2;
    const int vy = v[0], vx = v[1];
    const int wy = mr * 16 + sh.oy + p.pad + vy - 1;
    const int wx = mc * 16 + sh.ox + p.pad + vx - 1;
    const bool fast = wy >= 0 && wy + sh.bh + 2 <= p.g.hp && wx >= 0 &&
                      wx + sh.bw + 2 <= p.g.wp;
    const int pr = r - p.row[k];
    if (pr == 0) centres[g][k] = Centre{vy, vx, fast};
    if (!fast) continue;
    const int q = sh.bh == 16 ? pr / 18 : pr / 10, y = pr - q * (sh.bh + 2);
    const int32_t* s = planes + ((int64_t)q * p.g.hp + wy + y) * p.g.wp + wx;
    int32_t row[4 * kRowWords];
#pragma unroll
    for (int c = 0; c < 4 * kRowWords; ++c) row[c] = c < sh.bw + 2 ? s[c] : 0;
    uint32_t* o = smem + g * per_mb + kSrcWords + r * kRowWords;
#pragma unroll
    for (int j = 0; j < kRowWords; ++j) o[j] = iv::pack4(row + 4 * j);
  }
  __syncthreads();

  // this thread: MB g's lane, the 4x4 block (by4, bx4) of name k (k = -1:
  // a lane of no block); a name's nb blocks are nb neighbouring lanes,
  // aligned to nb, so its sums are shuffle sums and every lane of the name
  // makes the same choice
  const int g = tid / p.lanes, lane = tid - g * p.lanes, mb = mb0 + g;
  int k = -1, nb = 16;
  if (g < p.mbs && mb < n_mbs) {
#pragma unroll 1
    for (int j = 0; j < n_names; ++j) {
      const int b = lane - p.first[j];
      const int n = (p.shape[j].bh >> 2) * (p.shape[j].bw >> 2);
      if (b >= 0 && b < n) {
        k = j;
        nb = n;
      }
    }
  }
  Shape sh{0, 0, 16, 16};
  int by4 = 0, bx4 = 0, mr = 0, mc = 0;
  Centre c0{0, 0, true};
  uint32_t sb[4][2];
  const uint32_t* w = smem;
  if (k >= 0) {
    sh = p.shape[k];
    const int b = lane - p.first[k];
    by4 = b / (sh.bw >> 2);
    bx4 = b % (sh.bw >> 2);
    mr = mb / p.wm;
    mc = mb % p.wm;
    c0 = centres[g][k];
    const uint32_t* src = smem + g * per_mb;
    const int sy = iv::clamp_start(mr * 16 + sh.oy, sh.bh, p.h) -
                   iv::clamp_start(mr * 16, 16, p.h);
    const int sx = iv::clamp_start(mc * 16 + sh.ox, sh.bw, p.w) -
                   iv::clamp_start(mc * 16, 16, p.w);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t row =
          iv::bytes4(src, (sy + 4 * by4 + r) * 16 + sx + 4 * bx4);
      sb[r][0] = iv::lanes02(row) + iv::kBias2;
      sb[r][1] = iv::lanes13(row) + iv::kBias2;
    }
    w = src + kSrcWords + p.row[k] * kRowWords;
  }
  const int pl = (sh.bh + 2) * 4 * kRowWords;          // a plane's bytes
  int32_t cy = 4 * c0.vy, cx = 4 * c0.vx, best = 0;
  for (int step = 2; step >= 1; --step) {
    // the block's SATD at each candidate, then each candidate's sum over
    // the name's blocks, then the strict-less choice in candidate order
    int32_t t[kCands];
#pragma unroll
    for (int kc = 0; kc < kCands; ++kc) {
      int dy, dx;
      candidate(kc, step, dy, dx);
      const int32_t my = cy + dy, mx = cx + dx;
      t[kc] = 0;
      if (k < 0 || (step == 1 && kc == 0)) continue;
      uint32_t pred[4];
      if (c0.fast) {
        // byte offsets in the name's rows: plane, row, column
        const uint32_t e = qtab[(my & 3) * 4 + (mx & 3)];
        const int y = (my >> 2) - c0.vy + 1 + 4 * by4;
        const int x = (mx >> 2) - c0.vx + 1 + 4 * bx4;
        const int oa = (e & 3) * pl + (y + (e >> 2 & 1)) * 4 * kRowWords +
                       x + (e >> 3 & 1);
        const uint32_t* wa = w + (oa >> 2);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pred[r] = __funnelshift_r(wa[r * kRowWords], wa[r * kRowWords + 1],
                                    8 * (oa & 3));
        if (e >> 8 & 1) {
          const int ob = (e >> 4 & 3) * pl +
                         (y + (e >> 6 & 1)) * 4 * kRowWords + x +
                         (e >> 7 & 1);
          const uint32_t* wb = w + (ob >> 2);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pred[r] = __vavgu4(pred[r],
                               __funnelshift_r(wb[r * kRowWords],
                                               wb[r * kRowWords + 1],
                                               8 * (ob & 3)));
        }
      } else {
        const int y0 = mr * 16 + sh.oy + p.pad, x0 = mc * 16 + sh.ox + p.pad;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int32_t s[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[c] = iv::mc_luma_sample(planes, p.qpel, p.g, y0, x0, my, mx,
                                      4 * by4 + r, 4 * bx4 + c, sh.bh,
                                      sh.bw);
          pred[r] = iv::pack4(s);
        }
      }
      t[kc] = iv::satd4x4_packed(sb, pred);
    }
#pragma unroll
    for (int m = 1; m < 16; m <<= 1) {
#pragma unroll
      for (int kc = 0; kc < kCands; ++kc) {
        const int32_t o = __shfl_xor_sync(iw::kFull, t[kc], m);
        if (m < nb) t[kc] += o;
      }
    }
    int bk = 0;
    if (step == 2) best = t[0] + p.lam * iv::mv_cost(cy, cx);
#pragma unroll
    for (int kc = 1; kc < kCands; ++kc) {
      int dy, dx;
      candidate(kc, step, dy, dx);
      const int32_t c = t[kc] + p.lam * iv::mv_cost(cy + dy, cx + dx);
      if (c < best) {
        best = c;
        bk = kc;
      }
    }
    int dy, dx;
    candidate(bk, step, dy, dx);
    cy += dy;
    cx += dx;
  }
  if (k >= 0 && by4 == 0 && bx4 == 0) {
    int32_t* o = out + ((int64_t)k * n_mbs + mb) * 2;
    o[0] = cy;
    o[1] = cx;
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
  // lanes: name k's 4x4 block b at lane first[k] + b of its MB, first[k] a
  // multiple of nb
  int lanes = 0, rows = 0;
  for (int k = 0; k < p.n_names; ++k) {
    const Shape& s = p.shape[k];
    if ((s.bh != 8 && s.bh != 16) || (s.bw != 8 && s.bw != 16))
      return (int)cudaErrorInvalidValue;
    const int nb = (s.bh / 4) * (s.bw / 4);
    lanes = (lanes + nb - 1) / nb * nb;
    p.first[k] = lanes;
    lanes += nb;
    p.row[k] = rows;
    rows += 4 * (s.bh + 2);
  }
  p.row[p.n_names] = rows;
  p.lanes = (lanes + 15) & ~15;
  // macroblocks a block: as many as its threads and staged bytes allow
  const int per_mb = 4 * (kSrcWords + rows * kRowWords);
  p.mbs = kThreads / p.lanes;
  if (p.mbs * per_mb > kSmemBytes) p.mbs = kSmemBytes / per_mb;
  if (p.mbs < 1) return (int)cudaErrorInvalidValue;
  const int threads = (p.mbs * p.lanes + 31) & ~31;
  const int n_mbs = p.wm * p.hm;
  if (n_mbs > 0) {
    const int blocks = (n_mbs + p.mbs - 1) / p.mbs;
    me_subpel_kernel<<<blocks, threads, p.mbs * per_mb,
                       (cudaStream_t)stream>>>(orig, planes, mv_int, p, out);
  }
  return (int)cudaGetLastError();
}
