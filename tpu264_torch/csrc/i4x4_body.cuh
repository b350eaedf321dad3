// The Intra4x4 search of one macroblock lane, shared by K2's wave form
// (`i4x4_wave.cu`, the all-intra path: a block of `kThreads` threads a lane)
// and the frame kernels KP and KB (`p_wave.cu`, `b_wave.cu`: the first
// `kThreads` threads of a warp-specialised block, beside the inter search).
// `body` takes the barrier it uses, so that it runs alone in a block
// (`BlockSync`) or in a subset of its warps (`NamedSync`).
//
// The lane keeps the macroblock's reconstruction, its top/left context, the
// mode grid and the source samples in shared memory for all 16 steps and
// spends two barriers a step:
//   phase A, 144 threads = 9 modes x 16 samples (+16 idle to fill the warp):
//     each thread forms one predicted sample (three taps of the 13-sample
//     support line, or the DC rule), the 16 threads of a mode take the
//     Hadamard SATD of their residual with warp shuffles, and the mode's
//     cost is SATD + lam4 unless the mode is the most probable one; a mode
//     whose neighbours are missing costs BIG;
//   phase B, one warp: the lowest mode number among the cheapest wins; four
//     threads run residual -> DCT (columns, then rows) -> quant -> zig-zag
//     store -> dequant -> inverse DCT (rows, then columns) -> clip -> write
//     into the shared macroblock buffer, with the butterflies of
//     `transform4x4.cuh`.
// All arithmetic is int32 with arithmetic shifts, equal to the plain torch
// version `eval_i4x4_plain` bit for bit.

#pragma once

#include <cstdint>

#include "transform4x4.cuh"

namespace i4 {

constexpr int kBig = 1 << 28;
constexpr int kThreads = 160;
constexpr unsigned kFull = 0xFFFFFFFFu;

// availability codes of a block rule
enum : uint8_t { kNo = 0, kYes = 1, kMbTop = 2, kMbLeft = 3, kMbTl = 4,
                 kMbTr = 5 };

struct Params {
  int32_t mf[16];        // MF[qp % 6], raster
  int32_t lim[16];       // level limit per position for this qp
  int32_t v[16];         // V[qp % 6], raster (dequant)
  int32_t f, qbits, qshift;   // 2^qbits / 3, 15 + qp / 6, qp / 6
  int32_t lam4, lam24;
  uint8_t zigzag[16];    // scan position -> raster position
  uint8_t tap_idx[384];  // [8 directional modes][16 samples][3 taps]
  uint8_t tap_w[384];
  uint8_t rules[16][6];  // per block in coding order: by, bx, top, left,
                         // tl, tr availability codes
  uint8_t needs[9];      // per mode: bit 0 top, bit 1 left, bit 2 top-left
};

// host: the int32 array that `kernels/i4x4_wave.py` `pack_params` packs:
// mf[16] lim[16] v[16] f qbits qshift lam4 lam24 zigzag[16] tap_idx[384]
// tap_w[384] rules[96] needs[9]
inline void load_params(Params& prm, const int32_t* q) {
  for (int i = 0; i < 16; ++i) prm.mf[i] = *q++;
  for (int i = 0; i < 16; ++i) prm.lim[i] = *q++;
  for (int i = 0; i < 16; ++i) prm.v[i] = *q++;
  prm.f = *q++;
  prm.qbits = *q++;
  prm.qshift = *q++;
  prm.lam4 = *q++;
  prm.lam24 = *q++;
  for (int i = 0; i < 16; ++i) prm.zigzag[i] = (uint8_t)*q++;
  for (int i = 0; i < 384; ++i) prm.tap_idx[i] = (uint8_t)*q++;
  for (int i = 0; i < 384; ++i) prm.tap_w[i] = (uint8_t)*q++;
  for (int i = 0; i < 16; ++i)
    for (int k = 0; k < 6; ++k) prm.rules[i][k] = (uint8_t)*q++;
  for (int i = 0; i < 9; ++i) prm.needs[i] = (uint8_t)*q++;
}

__device__ __forceinline__ bool rule_flag(int code, bool at, bool al, bool atl,
                                          bool atr) {
  switch (code) {
    case kNo: return false;
    case kYes: return true;
    case kMbTop: return at;
    case kMbLeft: return al;
    case kMbTl: return atl;
    default: return atr;
  }
}

// A lane's shared state.  pix row 0 = the context row above (corner, 16
// top, 8 top-right samples), column 0 of rows 1..16 = the context column,
// the rest = the macroblock under reconstruction (zero until written, like
// the plain version).
struct Smem {
  int32_t pix[17][25];
  int32_t src[256];
  int32_t preds[9][16];
  int32_t costs[9];
  int32_t blk[16];
  int32_t lev[16];
  int32_t mgrid[16];
  int32_t mtop[4], mleft[4];
};

// Where a lane reads and writes.  Context: the 25 samples of the row above
// (from the corner), the 16 of the column to the left, the four modes above
// and to the left (-2 outside the picture or slice, -1 not Intra4x4).
// Results: recon [16,16] (16-byte aligned), mode_grid [4,4], modes_zz [16]
// (coding order), coeffs [16,16] (zig-zag levels a block in coding order),
// cost.  Plain pointers: in a frame kernel the context lies in buffers that
// other blocks wrote before the last grid barrier, and must not be read
// through the read-only cache.
struct Lane {
  const int32_t* orig;            // [16,16], 16-byte aligned
  const int32_t *ltop, *lleft, *modes_top, *modes_left;
  bool at, al, atl, atr;
  int32_t *recon, *mode_grid, *modes_zz, *coeffs, *cost;
};

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// a barrier of the first N threads' warps only (named barrier Id >= 1)
template <int Id, int N>
struct NamedSync {
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"n"(Id), "n"(N) : "memory");
  }
};

// The Intra4x4 search of lane `ln` by threads tid = 0 .. kThreads - 1, with
// `sync` as their barrier.  On return the results are written; the caller
// synchronises before anyone else reads them.
template <class Sync>
__device__ __forceinline__ void body(Smem& s, const Params& prm,
                                     const Lane& ln, int tid, Sync sync) {
  const int m = tid >> 4;            // mode 0..8 (9: idle lanes)
  const int p = tid & 15;            // sample within the 4x4 block
  const int py = p >> 2, px = p & 3;

  for (int i = tid; i < 17 * 25; i += kThreads) {
    const int r = i / 25, c = i % 25;
    int32_t val = 0;
    if (r == 0) val = ln.ltop[c];
    else if (c == 0) val = ln.lleft[r - 1];
    s.pix[r][c] = val;
  }
  if (tid < 64) {
    const int4 q = reinterpret_cast<const int4*>(ln.orig)[tid];
    s.src[4 * tid + 0] = q.x;
    s.src[4 * tid + 1] = q.y;
    s.src[4 * tid + 2] = q.z;
    s.src[4 * tid + 3] = q.w;
  }
  if (tid < 16) s.mgrid[tid] = -1;
  if (tid < 4) {
    s.mtop[tid] = ln.modes_top[tid];
    s.mleft[tid] = ln.modes_left[tid];
  }
  const bool mb_at = ln.at, mb_al = ln.al, mb_atl = ln.atl, mb_atr = ln.atr;

  // this thread's three taps (directional modes only; fixed for all blocks)
  int ti[3] = {0, 0, 0};
  int tw[3] = {0, 0, 0};
  int needs = 0;
  if (m < 9) {
    needs = prm.needs[m];
    if (m != 2) {
      const int base = (((m < 2 ? m : m - 1) << 4) + p) * 3;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        ti[t] = prm.tap_idx[base + t];
        tw[t] = prm.tap_w[base + t];
      }
    }
  }
  int32_t total = 0;                 // kept by thread 0
  sync();

  for (int idx = 0; idx < 16; ++idx) {
    const int by = prm.rules[idx][0], bx = prm.rules[idx][1];
    const int y0 = by * 4, x0 = bx * 4;
    const bool b_at = rule_flag(prm.rules[idx][2], mb_at, mb_al, mb_atl, mb_atr);
    const bool b_al = rule_flag(prm.rules[idx][3], mb_at, mb_al, mb_atl, mb_atr);
    const bool b_atl = rule_flag(prm.rules[idx][4], mb_at, mb_al, mb_atl, mb_atr);
    const bool b_atr = rule_flag(prm.rules[idx][5], mb_at, mb_al, mb_atl, mb_atr);

    // ---- phase A: nine predictions, SATD, mode costs ----
    int32_t d = 0;
    if (m < 9) {
      int32_t pred;
      if (m == 2) {
        int32_t st = 0, sl = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          st += s.pix[y0][1 + x0 + i];
          sl += s.pix[1 + y0 + i][x0];
        }
        pred = (b_at && b_al) ? (st + sl + 4) >> 3
               : b_at         ? (st + 2) >> 2
               : b_al         ? (sl + 2) >> 2
                              : 128;
      } else {
        // support line: 0..3 = left samples bottom-up, 4 = corner,
        // 5..12 = the eight samples above; without a top-right neighbour
        // the last four repeat the fourth
        int32_t acc = 2;
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const int j = ti[t];
          int32_t v;
          if (j < 4) {
            v = s.pix[1 + y0 + 3 - j][x0];
          } else if (j == 4) {
            v = s.pix[y0][x0];
          } else {
            int i = j - 5;
            if (!b_atr && i > 3) i = 3;
            v = s.pix[y0][1 + x0 + i];
          }
          acc += tw[t] * v;
        }
        pred = acc >> 2;
      }
      s.preds[m][p] = pred;
      d = s.src[(y0 + py) * 16 + x0 + px] - pred;
    }
    // 16-point Walsh-Hadamard over the mode's 16 lanes: the 2-D 4x4
    // Hadamard up to the order of its outputs, which the sum of absolute
    // values does not see
#pragma unroll
    for (int sh = 1; sh < 16; sh <<= 1) {
      const int32_t o = __shfl_xor_sync(kFull, d, sh);
      d = (p & sh) ? o - d : d + o;
    }
    int32_t sum = d < 0 ? -d : d;
#pragma unroll
    for (int sh = 1; sh < 16; sh <<= 1) sum += __shfl_xor_sync(kFull, sum, sh);
    if (m < 9 && p == 0) {
      // most probable mode: -2 = no neighbour, the MPM is DC outright;
      // -1 = a neighbour that is not Intra4x4 counts as DC
      const int32_t ma = bx == 0 ? (mb_al ? s.mleft[by] : -2)
                                 : s.mgrid[by * 4 + bx - 1];
      const int32_t mb = by == 0 ? (mb_at ? s.mtop[bx] : -2)
                                 : s.mgrid[(by - 1) * 4 + bx];
      const int32_t a = ma == -1 ? 2 : ma;
      const int32_t c = mb == -1 ? 2 : mb;
      const int32_t mpm = (a < 0 || c < 0) ? 2 : (a < c ? a : c);
      const bool valid = (!(needs & 1) || b_at) && (!(needs & 2) || b_al) &&
                         (!(needs & 4) || b_atl);
      const int32_t satd = (sum + 1) >> 1;
      s.costs[m] = valid ? satd + (m == mpm ? 0 : prm.lam4) : kBig;
    }
    sync();

    // ---- phase B (warp 0): choose, transform, quantise, reconstruct ----
    if (tid < 32) {
      int best = 0;
      int32_t best_cost = s.costs[0];
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        const int32_t ck = s.costs[k];
        if (ck < best_cost) {        // strict: the lowest mode wins a tie
          best_cost = ck;
          best = k;
        }
      }
      if (tid < 16) s.blk[p] = s.src[(y0 + py) * 16 + x0 + px] - s.preds[best][p];
      __syncwarp();
      if (tid < 4) {                 // Cf X: column tid
        int32_t c0 = s.blk[tid], c1 = s.blk[4 + tid], c2 = s.blk[8 + tid],
                c3 = s.blk[12 + tid];
        t4x4::cf1d(c0, c1, c2, c3);
        s.blk[tid] = c0;
        s.blk[4 + tid] = c1;
        s.blk[8 + tid] = c2;
        s.blk[12 + tid] = c3;
      }
      __syncwarp();
      if (tid < 4) {                 // (Cf X) Cf^T: row tid, then quant
        int32_t r[4] = {s.blk[4 * tid], s.blk[4 * tid + 1],
                        s.blk[4 * tid + 2], s.blk[4 * tid + 3]};
        t4x4::cf1d(r[0], r[1], r[2], r[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pos = 4 * tid + i;
          r[i] = t4x4::quant1(r[i], prm.mf[pos], prm.f, prm.qbits,
                              prm.lim[pos]);
          s.lev[pos] = r[i];
          r[i] = (r[i] * prm.v[pos]) << prm.qshift;     // dequant
        }
        t4x4::idct1d(r[0], r[1], r[2], r[3]);           // rows first
#pragma unroll
        for (int i = 0; i < 4; ++i) s.blk[4 * tid + i] = r[i];
      }
      __syncwarp();
      if (tid < 16) ln.coeffs[idx * 16 + tid] = s.lev[prm.zigzag[tid]];
      if (tid < 4) {                 // column tid, round, add, clip
        int32_t c[4] = {s.blk[tid], s.blk[4 + tid], s.blk[8 + tid],
                        s.blk[12 + tid]};
        t4x4::idct1d(c[0], c[1], c[2], c[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int32_t rec = s.preds[best][4 * i + tid] + ((c[i] + 32) >> 6);
          rec = rec < 0 ? 0 : (rec > 255 ? 255 : rec);
          s.pix[1 + y0 + i][1 + x0 + tid] = rec;
        }
      }
      if (tid == 0) {
        s.mgrid[by * 4 + bx] = best;
        ln.modes_zz[idx] = best;
        total += best_cost;
      }
    }
    sync();
  }

  if (tid < 64) {
    const int r = tid >> 2, c = (tid & 3) * 4;
    reinterpret_cast<int4*>(ln.recon)[tid] = make_int4(
        s.pix[1 + r][1 + c], s.pix[1 + r][2 + c], s.pix[1 + r][3 + c],
        s.pix[1 + r][4 + c]);
  }
  if (tid < 16) ln.mode_grid[tid] = s.mgrid[tid];
  if (tid == 0) *ln.cost = total + prm.lam24;
}

}  // namespace i4
