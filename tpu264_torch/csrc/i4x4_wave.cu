// Kernel K2, wave form: the whole Intra4x4 body of one macroblock wave in
// one launch.
//
// Replaces tpu264/kernels/pallas_kernels.py `_dct_quant_kernel` (K2) as the
// all-intra path uses it: the reference runs that fused DCT + quant inside
// a 16-step sequential loop over the 4x4 blocks of a macroblock
// (`tpu264/coding/intra_frame.py` `eval_i4x4`), and every other operation
// of a step (neighbour samples, nine predictors, SATD, most probable mode,
// mode choice, dequant + inverse transform, clip, write-back) is its own
// small array operation.  Here all of that is one kernel.
//
// What bounds it on the card: the latency of 16 dependent block steps (a
// block predicts from the reconstruction of the blocks before it), not
// bytes: a macroblock reads about 1.3 KB and writes about 2.2 KB.  The
// design gives each macroblock lane of the wave one CUDA block, keeps the
// macroblock's reconstruction, its top/left context, the mode grid and the
// source samples in shared memory for all 16 steps, and spends two block
// barriers a step:
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
//
// Two C entries launch the same kernel: `tpu264_i4x4_wave` takes a lane's
// neighbour context as gathered per-lane arrays, `tpu264_i4x4_wave_bd`
// (what the wave loop calls) lets the lane read it from the loop's border
// buffers at its own coordinates (`CtxLayout`), which saves the gather.

#include <cstdint>
#include <cuda_runtime.h>

#include "transform4x4.cuh"

namespace {

constexpr int kBig = 1 << 28;
constexpr int kThreads = 160;
constexpr unsigned kFull = 0xFFFFFFFFu;

// availability codes of a block rule
enum : uint8_t { kNo = 0, kYes = 1, kMbTop = 2, kMbLeft = 3, kMbTl = 4,
                 kMbTr = 5 };

struct WaveParams {
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

// Where a lane's context lies.  Without `coords` the four context inputs
// are per-lane arrays ([B,25], [B,16], [B,4], [B,4]).  With `coords` [B,2] =
// (r, c) they are the wave loop's border buffers, and the lane reads what
// `gather_border_ctx` would gather: row_y[r, 16c : 16c + 25], col_y[r],
// modes_row[r, 4c + 1 : 4c + 5], modes_col[r].
struct CtxLayout {
  const int32_t* coords;
  int row_stride, mrow_stride;    // row lengths of row_y and modes_row
};

__global__ void __launch_bounds__(kThreads) i4x4_wave_kernel(
    const int32_t* __restrict__ orig,         // [B,16,16]
    const int32_t* __restrict__ ltop,         // [B,25] or row_y
    const int32_t* __restrict__ lleft,        // [B,16] or col_y
    const int32_t* __restrict__ modes_top,    // [B,4] or modes_row
    const int32_t* __restrict__ modes_left,   // [B,4] or modes_col
    CtxLayout ctx,
    const uint8_t* __restrict__ at, int at_stride,
    const uint8_t* __restrict__ al, int al_stride,
    const uint8_t* __restrict__ atl, int atl_stride,
    const uint8_t* __restrict__ atr, int atr_stride,
    WaveParams prm,
    int32_t* __restrict__ recon,              // [B,16,16]
    int32_t* __restrict__ mode_grid,          // [B,4,4]
    int32_t* __restrict__ modes_zz,           // [B,16]
    int32_t* __restrict__ coeffs,             // [B,16,16]
    int32_t* __restrict__ cost) {             // [B]
  // pix row 0 = the context row above (corner, 16 top, 8 top-right samples),
  // column 0 of rows 1..16 = the context column, the rest = the macroblock
  // under reconstruction (zero until written, like the plain version)
  __shared__ int32_t pix[17][25];
  __shared__ int32_t src[256];
  __shared__ int32_t preds[9][16];
  __shared__ int32_t costs[9];
  __shared__ int32_t blk[16];
  __shared__ int32_t lev[16];
  __shared__ int32_t mgrid[16];
  __shared__ int32_t mtop[4], mleft[4];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int m = tid >> 4;            // mode 0..8 (9: idle lanes)
  const int p = tid & 15;            // sample within the 4x4 block
  const int py = p >> 2, px = p & 3;

  if (ctx.coords != nullptr) {
    const int mr = ctx.coords[2 * b], mc = ctx.coords[2 * b + 1];
    ltop += mr * ctx.row_stride + 16 * mc;
    lleft += mr * 16;
    modes_top += mr * ctx.mrow_stride + 4 * mc + 1;
    modes_left += mr * 4;
  } else {
    ltop += b * 25;
    lleft += b * 16;
    modes_top += b * 4;
    modes_left += b * 4;
  }
  for (int i = tid; i < 17 * 25; i += kThreads) {
    const int r = i / 25, c = i % 25;
    int32_t val = 0;
    if (r == 0) val = ltop[c];
    else if (c == 0) val = lleft[r - 1];
    pix[r][c] = val;
  }
  if (tid < 64) {
    const int4 q = reinterpret_cast<const int4*>(orig + (int64_t)b * 256)[tid];
    src[4 * tid + 0] = q.x;
    src[4 * tid + 1] = q.y;
    src[4 * tid + 2] = q.z;
    src[4 * tid + 3] = q.w;
  }
  if (tid < 16) mgrid[tid] = -1;
  if (tid < 4) {
    mtop[tid] = modes_top[tid];
    mleft[tid] = modes_left[tid];
  }
  const bool mb_at = at[(int64_t)b * at_stride] != 0;
  const bool mb_al = al[(int64_t)b * al_stride] != 0;
  const bool mb_atl = atl[(int64_t)b * atl_stride] != 0;
  const bool mb_atr = atr[(int64_t)b * atr_stride] != 0;

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
  __syncthreads();

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
          st += pix[y0][1 + x0 + i];
          sl += pix[1 + y0 + i][x0];
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
          int32_t s;
          if (j < 4) {
            s = pix[1 + y0 + 3 - j][x0];
          } else if (j == 4) {
            s = pix[y0][x0];
          } else {
            int i = j - 5;
            if (!b_atr && i > 3) i = 3;
            s = pix[y0][1 + x0 + i];
          }
          acc += tw[t] * s;
        }
        pred = acc >> 2;
      }
      preds[m][p] = pred;
      d = src[(y0 + py) * 16 + x0 + px] - pred;
    }
    // 16-point Walsh-Hadamard over the mode's 16 lanes: the 2-D 4x4
    // Hadamard up to the order of its outputs, which the sum of absolute
    // values does not see
#pragma unroll
    for (int s = 1; s < 16; s <<= 1) {
      const int32_t o = __shfl_xor_sync(kFull, d, s);
      d = (p & s) ? o - d : d + o;
    }
    int32_t sum = d < 0 ? -d : d;
#pragma unroll
    for (int s = 1; s < 16; s <<= 1) sum += __shfl_xor_sync(kFull, sum, s);
    if (m < 9 && p == 0) {
      // most probable mode: -2 = no neighbour, the MPM is DC outright;
      // -1 = a neighbour that is not Intra4x4 counts as DC
      const int32_t ma = bx == 0 ? (mb_al ? mleft[by] : -2)
                                 : mgrid[by * 4 + bx - 1];
      const int32_t mb = by == 0 ? (mb_at ? mtop[bx] : -2)
                                 : mgrid[(by - 1) * 4 + bx];
      const int32_t a = ma == -1 ? 2 : ma;
      const int32_t c = mb == -1 ? 2 : mb;
      const int32_t mpm = (a < 0 || c < 0) ? 2 : (a < c ? a : c);
      const bool valid = (!(needs & 1) || b_at) && (!(needs & 2) || b_al) &&
                         (!(needs & 4) || b_atl);
      const int32_t satd = (sum + 1) >> 1;
      costs[m] = valid ? satd + (m == mpm ? 0 : prm.lam4) : kBig;
    }
    __syncthreads();

    // ---- phase B (warp 0): choose, transform, quantise, reconstruct ----
    if (tid < 32) {
      int best = 0;
      int32_t best_cost = costs[0];
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        const int32_t ck = costs[k];
        if (ck < best_cost) {        // strict: the lowest mode wins a tie
          best_cost = ck;
          best = k;
        }
      }
      if (tid < 16) blk[p] = src[(y0 + py) * 16 + x0 + px] - preds[best][p];
      __syncwarp();
      if (tid < 4) {                 // Cf X: column tid
        int32_t c0 = blk[tid], c1 = blk[4 + tid], c2 = blk[8 + tid],
                c3 = blk[12 + tid];
        t4x4::cf1d(c0, c1, c2, c3);
        blk[tid] = c0;
        blk[4 + tid] = c1;
        blk[8 + tid] = c2;
        blk[12 + tid] = c3;
      }
      __syncwarp();
      if (tid < 4) {                 // (Cf X) Cf^T: row tid, then quant
        int32_t r[4] = {blk[4 * tid], blk[4 * tid + 1], blk[4 * tid + 2],
                        blk[4 * tid + 3]};
        t4x4::cf1d(r[0], r[1], r[2], r[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pos = 4 * tid + i;
          r[i] = t4x4::quant1(r[i], prm.mf[pos], prm.f, prm.qbits,
                              prm.lim[pos]);
          lev[pos] = r[i];
          r[i] = (r[i] * prm.v[pos]) << prm.qshift;     // dequant
        }
        t4x4::idct1d(r[0], r[1], r[2], r[3]);           // rows first
#pragma unroll
        for (int i = 0; i < 4; ++i) blk[4 * tid + i] = r[i];
      }
      __syncwarp();
      if (tid < 16)
        coeffs[((int64_t)b * 16 + idx) * 16 + tid] = lev[prm.zigzag[tid]];
      if (tid < 4) {                 // column tid, round, add, clip
        int32_t c[4] = {blk[tid], blk[4 + tid], blk[8 + tid], blk[12 + tid]};
        t4x4::idct1d(c[0], c[1], c[2], c[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int32_t rec = preds[best][4 * i + tid] + ((c[i] + 32) >> 6);
          rec = rec < 0 ? 0 : (rec > 255 ? 255 : rec);
          pix[1 + y0 + i][1 + x0 + tid] = rec;
        }
      }
      if (tid == 0) {
        mgrid[by * 4 + bx] = best;
        modes_zz[b * 16 + idx] = best;
        total += best_cost;
      }
    }
    __syncthreads();
  }

  if (tid < 64) {
    const int r = tid >> 2, c = (tid & 3) * 4;
    reinterpret_cast<int4*>(recon + (int64_t)b * 256)[tid] = make_int4(
        pix[1 + r][1 + c], pix[1 + r][2 + c], pix[1 + r][3 + c],
        pix[1 + r][4 + c]);
  }
  if (tid < 16) mode_grid[b * 16 + tid] = mgrid[tid];
  if (tid == 0) cost[b] = total + prm.lam24;
}

}  // namespace

// `params` is the host int32 array that `kernels/i4x4_wave.py` packs:
// mf[16] lim[16] v[16] f qbits qshift lam4 lam24 zigzag[16] tap_idx[384]
// tap_w[384] rules[96] needs[9].
static int launch_i4x4_wave(
    const int32_t* orig, const int32_t* ltop, const int32_t* lleft,
    const int32_t* modes_top, const int32_t* modes_left, CtxLayout ctx,
    const uint8_t* at, int at_stride, const uint8_t* al, int al_stride,
    const uint8_t* atl, int atl_stride, const uint8_t* atr, int atr_stride,
    const int32_t* params, int32_t* recon, int32_t* mode_grid,
    int32_t* modes_zz, int32_t* coeffs, int32_t* cost, int n_mbs,
    void* stream) {
  WaveParams prm;
  const int32_t* q = params;
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
  if (n_mbs > 0) {
    i4x4_wave_kernel<<<n_mbs, kThreads, 0, (cudaStream_t)stream>>>(
        orig, ltop, lleft, modes_top, modes_left, ctx, at, at_stride, al,
        al_stride, atl, atl_stride, atr, atr_stride, prm, recon, mode_grid,
        modes_zz, coeffs, cost);
  }
  return (int)cudaGetLastError();
}

// The context as per-lane arrays.
extern "C" int tpu264_i4x4_wave(
    const int32_t* orig, const int32_t* ltop, const int32_t* lleft,
    const int32_t* modes_top, const int32_t* modes_left, const uint8_t* at,
    int at_stride, const uint8_t* al, int al_stride, const uint8_t* atl,
    int atl_stride, const uint8_t* atr, int atr_stride, const int32_t* params,
    int32_t* recon, int32_t* mode_grid, int32_t* modes_zz, int32_t* coeffs,
    int32_t* cost, int n_mbs, void* stream) {
  return launch_i4x4_wave(orig, ltop, lleft, modes_top, modes_left,
                          CtxLayout{nullptr, 0, 0}, at, at_stride, al,
                          al_stride, atl, atl_stride, atr, atr_stride, params,
                          recon, mode_grid, modes_zz, coeffs, cost, n_mbs,
                          stream);
}

// The context read from the wave loop's border buffers of a picture `wm`
// macroblocks wide: coords [B,2] = (r, c) and avail [B,4] = (top, left,
// top-left, top-right) of the wave's lanes.
extern "C" int tpu264_i4x4_wave_bd(
    const int32_t* orig, const int32_t* row_y, const int32_t* col_y,
    const int32_t* modes_row, const int32_t* modes_col, const int32_t* coords,
    const uint8_t* avail, int wm, const int32_t* params, int32_t* recon,
    int32_t* mode_grid, int32_t* modes_zz, int32_t* coeffs, int32_t* cost,
    int n_mbs, void* stream) {
  return launch_i4x4_wave(orig, row_y, col_y, modes_row, modes_col,
                          CtxLayout{coords, 1 + 16 * wm + 8, 1 + 4 * wm + 4},
                          avail, 4, avail + 1, 4, avail + 2, 4, avail + 3, 4,
                          params, recon, mode_grid, modes_zz, coeffs, cost,
                          n_mbs, stream);
}
