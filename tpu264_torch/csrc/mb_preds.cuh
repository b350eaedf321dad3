// The derived inputs of a picture's entropy coding, as device code that
// kernels KR (`cabac_records.cu`) and KV (`cavlc_slices.cu`) both run in
// their state passes: each partition's mvd against its spec 8.4.1.3
// predictor and each 4x4 block's most probable Intra4x4 mode, stencils
// over the finished decisions of a macroblock and its left, top,
// top-right and top-left neighbours.
//
// They follow `entropy/device_cavlc.py` `mvd_16x16`,
// `_partition_mvds_core`, `b_list_mvds` and `mpm_grid` (the reference's
// `_partition_mvds_core_j`, `_mpm_grid_j`) on every macroblock, whether its
// mvds or modes are coded or not.  The routines are templates on the
// including kernel's `Io` (the MB dict's pointers, by the names of
// `kernels/mb_preds.py` `INPUTS`) and `Params` (wm, kind, parts, p8x8).
// Slices are whole macroblock rows: the caller says whether the row above
// is in the macroblock's slice (`top_ok`).

#pragma once

#include <cstdint>

namespace mb_preds {

constexpr int SL_I = 0, SL_P = 1, SL_B = 2;
// the ref map codes of `coding/mvpred.py`
constexpr int UNAVAIL = -2, INTRA = -1;

struct Cell {
  int x, y, ref;                      // mv (components 0, 1), ref code
};

__device__ __forceinline__ Cell unavail() { return {0, 0, UNAVAIL}; }

// what the mvd derivation reads of MB j for list l (`_cell_grids2`'s
// inputs): its partition type, the partitions' vectors and list use
struct Motion {
  int ptype;
  bool inter;                         // the MB is inter (with partitions)
  bool use_p0, use_p1;
  bool quads;                         // P_8x8 with its quadrant vectors
  int p0[2], p1[2];
};

template <class Io, class Params>
__device__ Motion motion_of(const Io& io, const Params& P, int j, int l) {
  Motion o;
  o.quads = false;
  o.p1[0] = o.p1[1] = 0;
  o.use_p1 = false;
  const int32_t* mv = P.kind == SL_P ? io.mv : (l ? io.mv1 : io.mv0);
  o.p0[0] = mv[2 * j];
  o.p0[1] = mv[2 * j + 1];
  const bool use = P.kind == SL_P ? io.is_inter[j] != 0
                                  : (l ? io.use1[j] : io.use0[j]) != 0;
  if (!P.parts) {                     // one 16x16 partition (`mvd_16x16`)
    o.ptype = 0;
    o.inter = true;
    o.use_p0 = use;
    return o;
  }
  const int32_t* mvb = P.kind == SL_P ? io.mv2 : (l ? io.mv1b : io.mv0b);
  o.p1[0] = mvb[2 * j];
  o.p1[1] = mvb[2 * j + 1];
  if (P.kind == SL_P) {
    o.ptype = io.ptype[j];
    o.inter = use;
    o.use_p0 = o.use_p1 = true;
    o.quads = P.p8x8 && o.ptype == 3;
  } else {
    const int bt = io.btype[j];
    const int c1 = io.c1[j];
    o.ptype = io.bptype[j];
    o.inter = bt != 4;
    o.use_p0 = use;
    o.use_p1 = bt == 5 ? (l ? c1 != 0 : c1 != 1) : use;
  }
  return o;
}

// MB j's boundary cell k of list l (0 tr, 1 bl, 2 br: the partition
// covering it; on P_8x8 quadrant 1, 2, 3), (0, INTRA) where that
// partition does not use the list or the MB is intra
template <class Io, class Params>
__device__ Cell cell_of(const Io& io, const Params& P, int j, int l, int k) {
  const Motion o = motion_of(io, P, j, l);
  const bool sel = k == 0 ? o.ptype == 2 : (k == 1 ? o.ptype == 1
                                                   : o.ptype > 0);
  int x = sel ? o.p1[0] : o.p0[0], y = sel ? o.p1[1] : o.p0[1];
  if (o.quads) {
    x = io.mvq[8 * j + 2 * (k + 1)];
    y = io.mvq[8 * j + 2 * (k + 1) + 1];
  }
  if (!((sel ? o.use_p1 : o.use_p0) && o.inter)) return {0, 0, INTRA};
  return {x, y, 0};
}

// the neighbours' cells that list l's derivation reads, one a lane of
// a state pass: i = 0 A (left tr), 1 B (top bl), 2 C (top-right bl), 3
// D (top-left br), 4 the top MB's br, 5 the left MB's br
constexpr int kNbCells = 6;

// neighbour cell i of list l of MB m: unavailable outside the picture
// and, for the rows above, across a slice start
template <class Io, class Params>
__device__ Cell nb_cell(const Io& io, const Params& P, int m, bool top_ok,
                        int l, int i) {
  const int dr = (i == 0 || i == 5) ? 0 : -1;
  const int dc = (i == 0 || i == 3 || i == 5) ? -1 : (i == 2 ? 1 : 0);
  const int k = i == 0 ? 0 : (i <= 2 ? 1 : 2);
  const int rr = m / P.wm + dr, cc = m % P.wm + dc;
  if (rr < 0 || cc < 0 || cc >= P.wm || (dr && !top_ok)) return unavail();
  return cell_of(io, P, rr * P.wm + cc, l, k);
}

// the median predictor (`mvpred.predict_mv`): C already D-substituted
__device__ inline void pred_mv(const Cell& a, const Cell& b, const Cell& c,
                               int out[2]) {
  const bool only_a = b.ref == UNAVAIL && c.ref == UNAVAIL &&
                      a.ref != UNAVAIL;
  const int same = (a.ref == 0) + (b.ref == 0) + (c.ref == 0);
  if (only_a || (same == 1 && a.ref == 0)) {
    out[0] = a.x;
    out[1] = a.y;
  } else if (same == 1) {
    out[0] = b.ref == 0 ? b.x : c.x;
    out[1] = b.ref == 0 ? b.y : c.y;
  } else {
    out[0] = max(min(max(a.x, b.x), c.x), min(a.x, b.x));
    out[1] = max(min(max(a.y, b.y), c.y), min(a.y, b.y));
  }
}

// list l's mvds of MB m in `mb_preds.preds_plain`'s layout: part 0, part 1
// (P_8x8: q0, q1), then q2, q3; zeros where the layout has no partition.
// `nb`: the list's neighbour cells (`nb_cell`)
template <class Io, class Params>
__device__ void derive_mvds(const Io& io, const Params& P, int m, int l,
                            const Cell* nb, int d[4][2]) {
  for (int q = 0; q < 4; ++q) d[q][0] = d[q][1] = 0;
  if (P.kind == SL_P && l == 1) return;
  const Cell A = nb[0], B = nb[1], C = nb[2], D = nb[3];
  const Cell C16 = C.ref == UNAVAIL ? D : C;
  const Motion o = motion_of(io, P, m, l);
  int pred16[2];
  pred_mv(A, B, C16, pred16);
  if (!P.parts) {
    d[0][0] = o.p0[0] - pred16[0];
    d[0][1] = o.p0[1] - pred16[1];
    return;
  }
  // 8x16 left half: C is the top MB's col-2 cell (br), D-substituted
  const Cell TBR = nb[4];
  const Cell C0 = TBR.ref == UNAVAIL ? D : TBR;
  int pred0[2];
  if (o.ptype == 2) {
    if (A.ref == 0) {
      pred0[0] = A.x;
      pred0[1] = A.y;
    } else {
      pred_mv(A, B, C0, pred0);
    }
  } else if (o.ptype == 1 && B.ref == 0) {
    pred0[0] = B.x;
    pred0[1] = B.y;
  } else {
    pred0[0] = pred16[0];
    pred0[1] = pred16[1];
  }
  // part 1: its own part 0 as a neighbour (mv zeroed unless it uses the
  // list)
  const int p0_ref = (o.inter && o.use_p0) ? 0 : INTRA;
  const Cell own0 = p0_ref == 0 ? Cell{o.p0[0], o.p0[1], 0}
                                : Cell{0, 0, p0_ref};
  const Cell LBR = nb[5];
  const Cell C1 = C.ref == UNAVAIL ? B : C;
  int pred1[2];
  if (o.ptype == 1) {                 // 16x8 bottom: A = left rows 2-3
    if (LBR.ref == 0) {
      pred1[0] = LBR.x;
      pred1[1] = LBR.y;
    } else {
      pred_mv(LBR, own0, A, pred1);
    }
  } else {                            // 8x16 right: shortcut on C
    if (C1.ref == 0) {
      pred1[0] = C1.x;
      pred1[1] = C1.y;
    } else {
      pred_mv(own0, TBR, C1, pred1);
    }
  }
  for (int k = 0; k < 2; ++k) {
    d[0][k] = o.p0[k] - pred0[k];
    d[1][k] = o.p1[k] - pred1[k];
  }
  if (!(P.kind == SL_P && P.p8x8)) return;
  // P_8x8 quadrants: the general rule with raster-order siblings (ref 0)
  const int32_t* mq = io.mvq + 8 * m;
  const Cell q0{mq[0], mq[1], 0}, q1{mq[2], mq[3], 0};
  const Cell q2{mq[4], mq[5], 0}, q3{mq[6], mq[7], 0};
  int pq[4][2];
  pred_mv(A, B, C0, pq[0]);
  pred_mv(q0, TBR, C1, pq[1]);
  pred_mv(LBR, q0, q1, pq[2]);
  pred_mv(q2, q1, q0, pq[3]);
  const Cell* qs[4] = {&q0, &q1, &q2, &q3};
  int dq[4][2];
  for (int q = 0; q < 4; ++q) {
    dq[q][0] = qs[q]->x - pq[q][0];
    dq[q][1] = qs[q]->y - pq[q][1];
  }
  for (int k = 0; k < 2; ++k) {
    if (o.ptype == 3) {
      d[0][k] = dq[0][k];
      d[1][k] = dq[1][k];
    }
    d[2][k] = dq[2][k];
    d[3][k] = dq[3][k];
  }
}

template <class Io, class Params>
__device__ __forceinline__ bool is_i4_mb(const Io& io, const Params& P,
                                         int j) {
  const bool inter = P.kind == SL_P   ? io.is_inter[j] != 0
                     : P.kind == SL_B ? io.btype[j] != 4
                                      : false;
  return io.sel16[j] == 0 && !inter;
}

// the zig-zag index of the 4x4 block at (by, bx) (`BLK_ORDER`'s inverse)
__device__ __forceinline__ int zz_of(int by, int bx) {
  return 8 * (by >> 1) + 4 * (bx >> 1) + 2 * (by & 1) + (bx & 1);
}

// the mode grid of `mpm_grid`: MB j's mode at (by, bx), -1 where MB j is
// not Intra4x4
template <class Io, class Params>
__device__ __forceinline__ int mode_at(const Io& io, const Params& P, int j,
                                       int by, int bx) {
  return is_i4_mb(io, P, j) ? io.modes[16 * j + zz_of(by, bx)] : -1;
}

// the most probable mode of block `idx` (zig-zag) of MB m (spec 8.3.1.1,
// `mpm_grid`): DC where a neighbour is not Intra4x4, DC where one is not
// available (the picture's left edge, the top of a slice).  `blk`:
// BLK_ORDER as by * 4 + bx
template <class Io, class Params>
__device__ int mpm_of(const Io& io, const Params& P, int m, int idx,
                      bool top_ok, const int32_t* blk) {
  const int pos = blk[idx];
  const int by = pos >> 2, bx = pos & 3;
  const int c = m % P.wm;
  const int left = bx > 0 ? mode_at(io, P, m, by, bx - 1)
                   : c > 0 ? mode_at(io, P, m - 1, by, 3)
                           : UNAVAIL;
  const int top = by > 0   ? mode_at(io, P, m, by - 1, bx)
                  : top_ok ? mode_at(io, P, m - P.wm, 3, bx)
                           : UNAVAIL;
  const int a = left == -1 ? 2 : left, b = top == -1 ? 2 : top;
  return (a < 0 || b < 0) ? 2 : min(a, b);
}

// A warp derives MB m's inputs: lanes 2-13 fetch the neighbours' cells of
// both lists into `cells` (the warp's [2][kNbCells]), then lanes 0 and 1
// derive list 0's and list 1's mvds into `d` (P, B), and lanes 16-31 the
// most probable modes of blocks 0-15 into `*mpm`.  Every lane of the warp
// calls it.
template <class Io, class Params>
__device__ void derive_warp(const Io& io, const Params& P, int m,
                            bool top_ok, const int32_t* blk,
                            Cell (*cells)[kNbCells], int lane, int d[4][2],
                            int* mpm) {
  const int nl = P.kind == SL_B ? 2 : (P.kind == SL_P ? 1 : 0);
  if (lane >= 2 && lane < 2 + nl * kNbCells) {
    const int l = (lane - 2) / kNbCells, i = (lane - 2) % kNbCells;
    cells[l][i] = nb_cell(io, P, m, top_ok, l, i);
  }
  __syncwarp();
  if (lane < 2 && P.kind != SL_I) derive_mvds(io, P, m, lane, cells[lane], d);
  if (lane >= 16) *mpm = mpm_of(io, P, m, lane - 16, top_ok, blk);
}

}  // namespace mb_preds
