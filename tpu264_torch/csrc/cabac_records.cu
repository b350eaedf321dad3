// Kernel KR: CABAC binarize + compact of one picture (I, P or B slices) in
// four launches, from the raster macroblock dict straight to the packed
// per-slice record streams that kernel K1 codes.
//
// Replaces no Pallas kernel: the reference writes this stage in jnp
// (`tpu264/entropy/cabac_binarize_j.py:241` `binarize_frame_j`, `:839`
// `compact_slices_j`, one jitted program a picture).  The port's plain
// version (`entropy/cabac_binarize.py` `binarize_frame` + `compact_slices`)
// builds a slot-major grid of every record slot of every macroblock
// (thousands of slots a macroblock, most of them invalid), then compacts
// it slice by slice; eagerly that is thousands of launches a picture.
//
// A macroblock is one warp.  Its records are what a walk of its syntax in
// the plain version's slot order emits, cut into 32 pieces, one a lane:
// lane 0 the header (mb_skip_flag to mb_qp_delta), lanes 1-31 the 31
// residual blocks in coding order (the I16x16 luma DC, 16 luma 4x4, 4
// luma 8x8, 2 chroma DC, 8 chroma AC), lane 31 also end_of_slice_flag.  A
// lane's piece is a run of the records, so a warp exclusive scan of the
// lanes' counts gives each piece its offset in the macroblock.  One walk
// routine per piece (`walk_lane`), templated on its sink, serves the count
// and the emit pass, so offsets and records cannot disagree.  The lanes
// load the macroblock's 408 coefficients coalesced into shared memory and
// take every block's significance mask from 13 `__ballot_sync`s.
//  (a) `state_kernel`: the derived inputs (each partition's mvd against
//      its spec 8.4.1.3 predictor, and each 4x4 block's most probable
//      Intra4x4 mode: stencils over the finished decisions of the
//      macroblock and its left, top, top-right and top-left neighbours,
//      `derive_mvds`, `mpm_of`) into `mvds` and `mpm`; then what a
//      neighbour reads of a macroblock (its kind, coded_block_pattern,
//      coded_block_flag bits, 8x8 flag, chroma prediction bit and the
//      |mvd| of its boundary 4x4 cells), one record of `kStateWords`
//      words a macroblock.  The derivation is `mb_preds.cuh`, which
//      KV's state pass runs too;
//  (b) `count_kernel`: the walk with a counting sink -> records a
//      macroblock, and each lane's offset in it (a warp scan);
//  (c) `scan_kernel`: one block, each slice's exclusive scan of those
//      counts -> each macroblock's offset in its slice, the slices'
//      counts and the largest;
//  (d) `emit_kernel`: the walk with a writing sink at those offsets
//      (kind << 30 | a << 14 | b, as `pack_records`), no record past a
//      row's end, and zeros from each slice's count to the row's end.
// No slot grid is written.  The host launches (a)-(d) with rows as wide
// as the caller's cap and reads nothing; it launches (d) again into wider
// rows only for a slice over the cap (`tpu264_cabac_records`).
//
// Bound: bytes (the MB dict read once, the records written once); the
// walk's branches and the serial level rows of a block keep it far above
// that (PERF.md, KR's row).
//
// Exactness: the plain version's record of a macroblock is its valid
// slots in slot order, and the walk visits the syntax elements in that
// order with the same valid conditions (the row order of
// `binarize_frame`; inside a residual block the coded_block_flag, the
// significance / last pairs, then six rows a coefficient from the last
// one down).  Slices are whole macroblock rows, so a left neighbour is
// missing only in column 0 and a top one in a slice's first row.  The
// derived inputs follow `entropy/device_cavlc.py` `mvd_16x16`,
// `_partition_mvds_core`, `b_list_mvds` and `mpm_grid` (the reference's
// `_partition_mvds_core_j`, `_mpm_grid_j`) on every macroblock, whether
// its mvds or modes are coded or not.

#include <cstdint>
#include <cuda_runtime.h>

#include "mb_preds.cuh"

namespace {

using mb_preds::Cell;
using mb_preds::kNbCells;
using mb_preds::SL_B;
using mb_preds::SL_I;
using mb_preds::SL_P;

constexpr int kMaxSlices = 256;
constexpr int kStateWords = 16;
constexpr int kWarps = 4;             // macroblocks (warps) a block
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// a macroblock's coefficients in shared memory: luma AC [16][16], chroma
// AC [2][4][16], luma DC [16], chroma DC [2][4]
constexpr int C_LAC = 0, C_CAC = 256, C_LDC = 384, C_CDC = 400;
constexpr int kCoefWords = 408;
constexpr int kMaskWords = (kCoefWords + 31) / 32;

// the tables: first the derivation's, `kernels/mb_preds.py` `tables()`
// (the port's `coding/b_mbtypes.py` and `coding/wavefront.py`), all that
// KD is given; then KR's context tables, `kernels/cabac_records.py`
// `tables()` (the port's `entropy/cabac_ctx.py`)
constexpr int T_COMBO = 0;            // COMBO_IDX [9]
constexpr int T_BLK = 9;              // BLK_ORDER as by * 4 + bx [16]
constexpr int kPredTableWords = 25;
static_assert(T_BLK + 16 == kPredTableWords,
              "KR's context tables follow the derivation's");
constexpr int T_CBF = 25;             // CBF_CAT_OFF [5]
constexpr int T_SIG = 30;             // SIG_CAT_OFF [5]
constexpr int T_LVL = 35;             // LVL_CAT_OFF [6]
constexpr int T_SIG8 = 41;            // SIG8_MAP [63]
constexpr int T_LAST8 = 104;          // LAST8_MAP[:63]
constexpr int kTableWords = 167;

// macroblock kinds a neighbour reads (`cabac_ctx` K_*)
constexpr int K_SKIP = 0, K_INTER = 1, K_I4 = 2, K_I16 = 3, K_DIRECT = 4;

struct Params {
  int wm, hm, kind, t8_mode, parts, p8x8, n_slices;
  int rows[kMaxSlices + 1];           // slice start rows, then hm
};

struct Io {
  const uint8_t* sel16;               // [n] bool
  const uint8_t* is_inter;            // [n] bool (P)
  const uint8_t* t8;                  // [n] bool, null: a zero map
  const int32_t* luma_ac;             // [n, 16, 16]
  const int32_t* luma_dc;             // [n, 16]
  const int32_t* chroma_dc;           // [n, 2, 4]
  const int32_t* chroma_ac;           // [n, 2, 4, 16]
  const int32_t* modes;               // [n, 16]
  const int32_t* cmode;               // [n]
  const int32_t* i16mode;             // [n]
  const int32_t* mv;                  // [n, 2] (P)
  const int32_t* mv_skip;             // [n, 2] (P)
  const int32_t* ptype;               // [n] (P with partitions)
  const int32_t* btype;               // [n] (B)
  const int32_t* c0;                  // [n] (B with partitions)
  const int32_t* c1;
  const int32_t* bptype;
  const int32_t* mv2;                 // [n, 2] (P with partitions)
  const int32_t* mvq;                 // [n, 4, 2] (P_8x8)
  const uint8_t* use0;                // [n] bool (B)
  const uint8_t* use1;
  const int32_t* mv0;                 // [n, 2] (B)
  const int32_t* mv1;
  const int32_t* mv0b;                // [n, 2] (B with partitions)
  const int32_t* mv1b;
  const int32_t* tables;              // [kTableWords]
  int32_t* mvds;                      // [n, 2 lists, 4 parts, 2] (P, B)
  int32_t* mpm;                       // [n, 16]
  int32_t* state;                     // [n, kStateWords]
  int32_t* mb_count;                  // [n]
  int32_t* mb_off;                    // [n]
  int32_t* lane_off;                  // [n, 32]: each lane's piece in its MB
  int32_t* counts;                    // [n_slices + 1]: counts, the largest
};

__device__ __forceinline__ int bitlen_m1(unsigned v) {   // v >= 1
  return 31 - __clz((int)v);
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// the slice of MB row r
__device__ int slice_of(const Params& P, int r) {
  int s = 0;
  while (s + 1 < P.n_slices && P.rows[s + 1] <= r) ++s;
  return s;
}

// ---- the macroblock's own flags (the state pass and the walk) ----

struct Mb {
  bool is_inter, is_direct, sel16, coded, skipped, t8v;
  int cbp_luma, cbp_chroma, cbp, kind;
  int ptype;                          // P: ptype, B: bptype (0 without)
  bool partd;                         // B 16x8 / 8x16
  bool exp[2], exp_b[2];              // B: lists with an explicit mvd
  int btype;
};

// (cl, cc): the MB's whole coded_block_pattern (a skipped MB has none)
__device__ Mb mb_flags(const Io& io, const Params& P, int m, int cl,
                       int cc) {
  Mb b;
  b.btype = 0;
  b.partd = false;
  b.ptype = 0;
  b.exp[0] = b.exp[1] = b.exp_b[0] = b.exp_b[1] = false;
  b.is_direct = false;
  if (P.kind == SL_B) {
    const int bt = io.btype[m];
    b.btype = bt;
    b.is_inter = bt != 4;
    b.partd = bt == 5;
    b.is_direct = bt == 3;
    if (P.parts) {
      const int c0 = io.c0[m], c1 = io.c1[m];
      b.ptype = io.bptype[m];
      b.exp[0] = b.partd ? c0 != 1 : (bt == 0 || bt == 2);
      b.exp[1] = b.partd ? c0 != 0 : (bt == 1 || bt == 2);
      b.exp_b[0] = b.partd && c1 != 1;
      b.exp_b[1] = b.partd && c1 != 0;
    } else {
      b.exp[0] = bt == 0 || bt == 2;
      b.exp[1] = bt == 1 || bt == 2;
    }
  } else if (P.kind == SL_P) {
    b.is_inter = io.is_inter[m] != 0;
    if (P.parts) b.ptype = io.ptype[m];
  } else {
    b.is_inter = false;
  }
  b.sel16 = io.sel16[m] != 0 && !b.is_inter;
  if (b.sel16 && cl > 0) cl = 15;
  b.cbp_luma = cl;
  b.cbp_chroma = cc;
  b.cbp = cl | (cc << 4);
  if (P.kind == SL_P) {
    const int32_t* mv = io.mv + 2 * m;
    const int32_t* ms = io.mv_skip + 2 * m;
    b.skipped = b.is_inter && b.ptype == 0 && mv[0] == ms[0] &&
                mv[1] == ms[1] && b.cbp == 0;
  } else if (P.kind == SL_B) {
    b.skipped = b.is_direct && b.cbp == 0;
  } else {
    b.skipped = false;
  }
  b.coded = !b.skipped;
  b.kind = b.skipped     ? K_SKIP
           : b.is_direct ? K_DIRECT
           : b.is_inter  ? K_INTER
           : b.sel16     ? K_I16
                         : K_I4;
  b.t8v = P.t8_mode && io.t8 != nullptr && io.t8[m] != 0 && b.is_inter &&
          b.coded && b.cbp_luma > 0;
  return b;
}

// the partitions of list `l` whose mvd is coded
__device__ void mvd_on(const Params& P, const Mb& b, int l, bool on[4]) {
  if (P.kind == SL_P) {
    on[0] = l == 0 && b.coded && b.is_inter;
    on[1] = on[0] && b.ptype > 0;
    on[2] = on[3] = P.p8x8 && on[0] && b.ptype == 3;
  } else {
    on[0] = b.coded && b.exp[l];
    on[1] = b.coded && b.exp_b[l] && b.partd;
    on[2] = on[3] = false;
  }
}

// |mvd| of the partitions of list `l` (`d`: its mvds), 0 where not coded
__device__ void mvd_abs(const Params& P, const Mb& b, int l, const int* d,
                        int a[4][2]) {
  bool on[4];
  mvd_on(P, b, l, on);
  for (int q = 0; q < 4; ++q)
    for (int c = 0; c < 2; ++c) a[q][c] = on[q] ? iabs(d[2 * q + c]) : 0;
}

// the boundary cells tr, bl, br of a list: the partition covering each
__device__ void cells(const Params& P, const Mb& b, const int a[4][2],
                      int out[3][2]) {
  const int pt = b.ptype;
  for (int c = 0; c < 2; ++c) {
    if (P.kind == SL_P) {
      out[0][c] = (pt == 2 || pt == 3) ? a[1][c] : a[0][c];
      out[1][c] = pt == 1 ? a[1][c] : a[0][c];
      out[2][c] = pt > 0 ? a[1][c] : a[0][c];
      if (P.p8x8 && pt == 3) {
        out[1][c] = a[2][c];
        out[2][c] = a[3][c];
      }
    } else {
      out[0][c] = pt == 2 ? a[1][c] : a[0][c];
      out[1][c] = pt == 1 ? a[1][c] : a[0][c];
      out[2][c] = pt > 0 ? a[1][c] : a[0][c];
    }
  }
}

// ---- a macroblock's coefficients in shared memory and their masks ----

// the coefficient at word i of the shared layout (C_*)
__device__ __forceinline__ int32_t coef_src(const Io& io, int m, int i) {
  if (i < C_CAC) return io.luma_ac[(size_t)m * 256 + i];
  if (i < C_LDC) return io.chroma_ac[(size_t)m * 128 + (i - C_CAC)];
  if (i < C_CDC) return io.luma_dc[(size_t)m * 16 + (i - C_LDC)];
  return io.chroma_dc[(size_t)m * 8 + (i - C_CDC)];
}

// a warp's MB in shared memory: its coefficients and their masks
struct MbShared {
  int32_t coef[kCoefWords];           // the C_* layout
  unsigned mask[kMaskWords];          // bit lane of word k: coef[32 k + lane]
};

// the warp loads MB m's coefficients (neighbouring lanes on neighbouring
// words) into `sh` and takes the nonzero mask of each 32 of them
__device__ void load_mb(const Io& io, int m, MbShared& sh, int lane) {
#pragma unroll
  for (int k = 0; k < kMaskWords; ++k) {
    const int i = 32 * k + lane;
    const int32_t v = i < kCoefWords ? coef_src(io, m, i) : 0;
    if (i < kCoefWords) sh.coef[i] = v;
    const unsigned bits = __ballot_sync(kFull, v != 0);
    if (lane == 0) sh.mask[k] = bits;
  }
  __syncwarp();
}

// the 16-bit nonzero mask of luma 4x4 block i and of chroma AC block j
__device__ __forceinline__ unsigned luma_mask(const unsigned* mask, int i) {
  return (mask[i >> 1] >> (16 * (i & 1))) & 0xffffu;
}
__device__ __forceinline__ unsigned cac_mask(const unsigned* mask, int j) {
  return (mask[8 + (j >> 1)] >> (16 * (j & 1))) & 0xffffu;
}
__device__ __forceinline__ unsigned ldc_mask(const unsigned* mask) {
  return mask[12] & 0xffffu;
}
__device__ __forceinline__ unsigned cdc_mask(const unsigned* mask, int comp) {
  return (mask[12] >> (16 + 4 * comp)) & 0xfu;
}

// coded_block_pattern (`compute_cbp`) before the I16x16 rule
__device__ void cbp_of(const unsigned* mask, int& cl, int& cc) {
  cl = 0;
  for (int b8 = 0; b8 < 4; ++b8)
    if (mask[2 * b8] | mask[2 * b8 + 1]) cl |= 1 << b8;
  cc = (mask[8] | mask[9] | mask[10] | mask[11]) ? 2
       : ((mask[12] >> 16) & 0xffu)              ? 1
                                                 : 0;
}

// ---- (a) the state pass ----
// word 0: kind | t8v << 3 | cbp_luma << 4 | cbp_chroma << 8 | chroma
//   pred bit << 10 | luma DC cbf << 11 | chroma DC
//   cbf << 12 + comp | chroma AC cbf << 14 + 4 comp + idx;
// word 1: the 16 luma 4x4 cbf bits by position by * 4 + bx;
// words 2 + 6 l + 2 cell + comp: |mvd| of list l's cell (tr, bl, br),
//   at most 255 (its contexts only ask < 3 and <= 32 of a sum).
// Lanes 2-13 fetch the neighbours' cells of both lists, then lanes 0 and
// 1 derive list 0's and list 1's mvds; lanes 16-31 the most probable
// modes of blocks 0-15.
__global__ void __launch_bounds__(kWarps * 32) state_kernel(Io io, Params P) {
  __shared__ MbShared mb_s[kWarps];
  __shared__ Cell cell_s[kWarps][2][kNbCells];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= P.wm * P.hm) return;       // whole warps: no block barrier
  const int r = m / P.wm;
  const bool top_ok = r > P.rows[slice_of(P, r)];
  int d[4][2], pm;
  mb_preds::derive_warp(io, P, m, top_ok, io.tables + T_BLK, cell_s[warp],
                        lane, d, &pm);
  const bool mvd_lane = lane < 2 && P.kind != SL_I;
  if (mvd_lane) {
    int32_t* o = io.mvds + (size_t)m * 16 + lane * 8;
    for (int q = 0; q < 4; ++q)
      for (int c = 0; c < 2; ++c) o[2 * q + c] = d[q][c];
  }
  if (lane >= 16) io.mpm[(size_t)m * 16 + lane - 16] = pm;
  load_mb(io, m, mb_s[warp], lane);
  const unsigned* mask = mb_s[warp].mask;
  int cl, cc;
  cbp_of(mask, cl, cc);
  const Mb b = mb_flags(io, P, m, cl, cc);
  int32_t* st = io.state + (size_t)m * kStateWords;
  if (lane < 2) {
    int c3[3][2] = {{0, 0}, {0, 0}, {0, 0}};
    if (mvd_lane) {
      int a[4][2];
      mvd_abs(P, b, lane, &d[0][0], a);
      cells(P, b, a, c3);
    }
    for (int k = 0; k < 3; ++k)
      for (int comp = 0; comp < 2; ++comp)
        st[2 + 6 * lane + 2 * k + comp] = min(c3[k][comp], 255);
  }
  if (lane != 0) return;
  // a skipped MB's cbp is 0: the neighbours' (0 where not coded) and the
  // whole one are the same
  int w0 = b.kind | (b.t8v << 3) | (b.cbp_luma << 4) | (b.cbp_chroma << 8);
  if (!b.is_inter && io.cmode[m] != 0) w0 |= 1 << 10;
  if (b.sel16 && b.coded && ldc_mask(mask)) w0 |= 1 << 11;
  for (int comp = 0; comp < 2; ++comp) {
    if (cdc_mask(mask, comp) && b.cbp_chroma >= 1 && b.coded)
      w0 |= 1 << (12 + comp);
    for (int idx = 0; idx < 4; ++idx)
      if (b.cbp_chroma == 2 && b.coded && (cac_mask(mask, comp * 4 + idx) >> 1))
        w0 |= 1 << (14 + 4 * comp + idx);
  }
  int w1 = 0;
  for (int idx = 0; idx < 16; ++idx) {
    const bool bit8 = (b.cbp_luma >> (idx / 4)) & 1;
    const unsigned blk = luma_mask(mask, idx);
    bool l4 = b.sel16 ? (blk >> 1) != 0 && b.cbp_luma > 0 : blk != 0 && bit8;
    l4 = l4 && b.coded;
    if (b.t8v) l4 = bit8;
    if (l4) w1 |= 1 << io.tables[T_BLK + idx];
  }
  st[0] = w0;
  st[1] = w1;
  st[14] = st[15] = 0;
}

// ---- the sinks and the record rows ----

struct Counter {
  int n = 0;
  __device__ void put(int, int, int) { ++n; }
};

struct Writer {
  int32_t* out;
  int pos, lim;
  __device__ void put(int k, int a, int b) {
    if (pos < lim) {
      const uint64_t p = ((uint64_t)(uint32_t)k << 30) |
                         ((uint64_t)(uint32_t)a << 14) | (uint64_t)(uint32_t)b;
      out[pos] = (int32_t)(uint32_t)p;
    }
    ++pos;
  }
};

template <class S>
struct Emit {
  S& s;
  __device__ void ctx(int c, int bin, bool v) {
    if (v) s.put(0, c, (bin & 1) | 2);
  }
  __device__ void run(int c, int bin, int count, bool v) {
    if (v && count > 0) s.put(0, c, (bin & 1) | (count << 1));
  }
  __device__ void byp(int val, int nbits, bool v) {
    if (v && nbits > 0) s.put(1, val, nbits);
  }
  __device__ void term(int bin, bool v) {
    if (v) s.put(2, bin, 0);
  }
};

// Exp-Golomb order-k escape of v >= 0 (`eg_parts`)
struct Eg {
  int pre, pre_bits, suf, suf_bits;
};

__device__ Eg eg_parts(int v, int k) {
  const int m = bitlen_m1((unsigned)((v >> k) + 1));
  const int p = 1 << min(m, 30);
  return {(p - 1) << 1, m + 1, v - ((p - 1) << k), k + m};
}

// levels and signs of a block, last coefficient first (`_level_rows`):
// `nz` the nonzero positions, `get(p)` the coefficient at position p
template <class S, class Get>
__device__ void level_rows(Emit<S>& e, uint64_t nz, const Get& get,
                           int lvl) {
  int ngt1 = 0, neq1 = 0;
  while (nz) {
    const int p = 63 - __clzll((long long)nz);
    nz &= ~(1ull << p);
    const int c = get(p);
    const int a = iabs(c) - 1;
    const int ctx0 = lvl + (ngt1 > 0 ? 0 : min(1 + neq1, 4));
    const int ctxn = lvl + 5 + min(ngt1, 4);
    e.ctx(ctx0, a > 0, true);
    e.run(ctxn, 1, min(a, 14) - 1, a >= 2);
    e.ctx(ctxn, 0, a >= 1 && a < 14);
    const Eg g = eg_parts(max(a - 14, 0), 0);
    e.byp(g.pre, g.pre_bits, a >= 14);
    e.byp(g.suf, g.suf_bits, a >= 14);
    e.byp(c < 0, 1, true);
    if (a > 0) ++ngt1; else ++neq1;
  }
}

// a 4x4-style block of `mc` coefficients at p[0..mc) whose nonzero
// positions are `nz` (`_residual_group`)
template <class S>
__device__ void residual(Emit<S>& e, const int32_t* p, int mc, unsigned nz,
                         int sig, int last_b, int lvl, int cbf_ctx,
                         bool coded, bool cdc_inc) {
  if (!coded) nz = 0;
  e.ctx(cbf_ctx, nz != 0, coded);
  if (!coded || nz == 0) return;
  const int last = 31 - __clz((int)nz);
  for (int i = 0; i < 15 && i <= last && i <= mc - 2; ++i) {
    const int inc = cdc_inc ? min(i, 2) : i;
    const bool s = (nz >> i) & 1;
    e.ctx(sig + inc, s, true);
    e.ctx(last_b + inc, i == last, s);
  }
  level_rows(e, nz, [p](int q) { return p[q]; }, lvl);
}

// a cat-5 luma 8x8 block (`_residual_group8`): position 4 k + i is
// coefficient k of the 4x4 block 4 b8 + i
template <class S>
__device__ void residual8(Emit<S>& e, const int32_t* sh, const unsigned* mask,
                          int b8, bool on, const int32_t* tab) {
  if (!on) return;
  const int32_t* base = sh + C_LAC + b8 * 64;
  auto get = [base](int q) { return base[(q & 3) * 16 + (q >> 2)]; };
  unsigned sub[4];
  for (int i = 0; i < 4; ++i) sub[i] = luma_mask(mask, 4 * b8 + i);
  uint64_t nz = 0;
  for (int q = 0; q < 64; ++q)
    nz |= (uint64_t)((sub[q & 3] >> (q >> 2)) & 1u) << q;
  if (nz == 0) return;
  const int last = 63 - __clzll((long long)nz);
  for (int i = 0; i < 63 && i <= last; ++i) {
    const bool s = (nz >> i) & 1;
    e.ctx(402 + tab[T_SIG8 + i], s, true);
    e.ctx(417 + tab[T_LAST8 + i], i == last, s);
  }
  level_rows(e, nz, get, 426);
}

// the mvd of one partition (`emit_mvd`): x (component 1, contexts 40..46)
// then y (component 0, 47..53); s[comp] the neighbours' |mvd| sum
template <class S>
__device__ void mvd_rows(Emit<S>& e, const int32_t* d, const int s[2],
                         bool on) {
  for (int comp = 1; comp >= 0; --comp) {
    const int base = comp == 1 ? 40 : 47;
    const int inc = s[comp] < 3 ? 0 : (s[comp] <= 32 ? 1 : 2);
    const int v = d[comp];
    const int a = iabs(v);
    e.ctx(base + inc, a > 0, on);
    for (int k = 1; k <= 3; ++k) e.ctx(base + k + 2, a > k, on && a >= k);
    e.run(base + 6, 1, min(a, 9) - 4, on && a >= 5);
    e.ctx(base + 6, 0, on && a >= 4 && a < 9);
    const Eg g = eg_parts(max(a - 9, 0), 3);
    e.byp(g.pre, g.pre_bits, on && a >= 9);
    e.byp(g.suf, g.suf_bits, on && a >= 9);
    e.byp(v < 0, 1, on && a > 0);
  }
}

__device__ __forceinline__ int kind_of(int w0) { return w0 & 7; }

// what every lane of a macroblock's warp knows of it
struct MbCtx {
  int m;
  bool av_l, av_t, last_of_slice;
  const int32_t* own;                 // the MB's state
  const int32_t* l;                   // left neighbour's state
  const int32_t* t;                   // top neighbour's state
  int lw0, tw0, lk, tk;
  Mb b;
  const int32_t* sh;                  // the coefficients (C_* layout)
  const unsigned* mask;               // their nonzero masks
};

// lane 0's piece: the header, mb_skip_flag to mb_qp_delta
template <class S>
__device__ void walk_header(Emit<S>& e, const Io& io, const Params& P,
                            const int32_t* tab, const MbCtx& x) {
  const Mb& b = x.b;
  const int m = x.m, lw0 = x.lw0, tw0 = x.tw0, lk = x.lk, tk = x.tk;
  const bool is_i4 = !b.sel16 && !b.is_inter;
  const bool intra_coded = b.coded && !b.is_inter;
  const int t8_inc = (x.av_l ? (lw0 >> 3) & 1 : 0) +
                     (x.av_t ? (tw0 >> 3) & 1 : 0);

  // ---- mb_skip_flag ----
  if (P.kind != SL_I)
    e.ctx((P.kind == SL_B ? 24 : 11) + (x.av_l && lk != K_SKIP) +
              (x.av_t && tk != K_SKIP),
          b.skipped, true);

  // ---- mb_type ----
  int first_ctx, rest[5];
  if (P.kind == SL_B) {
    const bool explicit_ = b.coded && !b.is_direct;
    const int nd = (x.av_l && lk != K_SKIP && lk != K_DIRECT) +
                   (x.av_t && tk != K_SKIP && tk != K_DIRECT);
    e.ctx(27 + nd, !b.is_direct, b.coded);
    const bool one_list =
        explicit_ && b.is_inter && (b.btype == 0 || b.btype == 1);
    const bool on11 = b.btype == 2 || b.partd || !b.is_inter;
    e.ctx(30, on11, explicit_);
    e.ctx(32, b.btype == 1, one_list);
    const bool tail = explicit_ && on11;
    int bits13 = b.is_inter ? 0 : 13;
    int mbt = 0;
    if (P.parts && b.partd) {
      mbt = 4 + 2 * tab[T_COMBO + io.c0[m] * 3 + io.c1[m]] + (b.ptype == 2);
      bits13 = mbt <= 10 ? mbt - 3 : (mbt == 11 ? 14 : (mbt + 4) / 2);
    }
    e.ctx(31, (bits13 >> 3) & 1, tail);
    for (int sh = 2; sh >= 0; --sh) e.ctx(32, (bits13 >> sh) & 1, tail);
    if (P.parts) e.ctx(32, mbt & 1, tail && b.partd && mbt >= 12);
    first_ctx = 32;
    rest[0] = 33; rest[1] = 34; rest[2] = 34; rest[3] = 35; rest[4] = 35;
  } else if (P.kind == SL_P) {
    e.ctx(14, !b.is_inter, b.coded);
    const bool inter_coded = b.coded && b.is_inter;
    const bool pb1 = b.ptype == 1 || b.ptype == 2;
    e.ctx(15, pb1, inter_coded);
    e.ctx(pb1 ? 17 : 16, b.ptype == 1 || b.ptype == 3, inter_coded);
    if (P.p8x8)
      for (int q = 0; q < 4; ++q) e.ctx(21, 1, inter_coded && b.ptype == 3);
    first_ctx = 17;
    rest[0] = 18; rest[1] = 19; rest[2] = 19; rest[3] = 20; rest[4] = 20;
  } else {
    first_ctx = 3 + (lk == K_I16) + (tk == K_I16);
    rest[0] = 6; rest[1] = 7; rest[2] = 8; rest[3] = 9; rest[4] = 10;
  }
  e.ctx(first_ctx, b.sel16, intra_coded);
  const bool on16 = intra_coded && b.sel16;
  const int i16mode = io.i16mode[m];
  e.term(0, on16);
  e.ctx(rest[0], b.cbp_luma > 0, on16);
  e.ctx(rest[1], b.cbp_chroma != 0, on16);
  e.ctx(rest[2], max(b.cbp_chroma - 1, 0), on16 && b.cbp_chroma != 0);
  e.ctx(rest[3], i16mode >> 1, on16);
  e.ctx(rest[4], i16mode & 1, on16);

  // ---- Intra4x4 prediction modes ----
  const bool on_i4 = b.coded && is_i4;
  if (P.t8_mode) e.ctx(399 + t8_inc, 0, on_i4);
  if (on_i4) {
    const int32_t* modes = io.modes + (size_t)m * 16;
    const int32_t* mpm = io.mpm + (size_t)m * 16;
    for (int idx = 0; idx < 16; ++idx) {
      const int md = modes[idx], pm = mpm[idx];
      const bool is_mpm = md == pm;
      e.ctx(68, is_mpm, true);
      const int rem = md - (md > pm);
      e.ctx(69, rem & 1, !is_mpm);
      e.ctx(69, (rem >> 1) & 1, !is_mpm);
      e.ctx(69, (rem >> 2) & 1, !is_mpm);
    }
  }

  // ---- intra_chroma_pred_mode ----
  const int cmode = io.cmode[m];
  e.ctx(64 + (x.av_l ? (lw0 >> 10) & 1 : 0) + (x.av_t ? (tw0 >> 10) & 1 : 0),
        cmode != 0, intra_coded);
  e.ctx(67, cmode > 1, intra_coded && cmode != 0);
  e.ctx(67, cmode == 3, intra_coded && cmode > 1);

  // ---- mvds: per list (B: 0 then 1), partition 0, 1, then P_8x8's q2
  // and q3; the contexts sum the |mvd| of the left and top 4x4 cells ----
  if (P.kind != SL_I) {
    for (int l = 0; l < (P.kind == SL_B ? 2 : 1); ++l) {
      const int32_t* d = io.mvds + (size_t)m * 16 + l * 8;
      bool on[4];
      mvd_on(P, b, l, on);
      int a[4][2];
      mvd_abs(P, b, l, d, a);
      const int* lc = x.l + 2 + 6 * l;    // left cells tr, bl, br
      const int* tc = x.t + 2 + 6 * l;
      int s[2];
      for (int c = 0; c < 2; ++c)
        s[c] = (x.av_l ? lc[0 + c] : 0) + (x.av_t ? tc[2 + c] : 0);
      mvd_rows(e, d, s, on[0]);
      for (int c = 0; c < 2; ++c)
        s[c] = b.ptype == 1 ? (x.av_l ? lc[4 + c] : 0) + a[0][c]
                            : a[0][c] + (x.av_t ? tc[4 + c] : 0);
      mvd_rows(e, d + 2, s, on[1]);
      if (P.kind == SL_P && P.p8x8) {
        for (int c = 0; c < 2; ++c)
          s[c] = (x.av_l ? lc[4 + c] : 0) + a[0][c];
        mvd_rows(e, d + 4, s, on[2]);
        for (int c = 0; c < 2; ++c) s[c] = a[2][c] + a[1][c];
        mvd_rows(e, d + 6, s, on[3]);
      }
    }
  }

  // ---- coded_block_pattern ----
  const bool on_cbp = b.coded && !b.sel16;
  const int lcl = (lw0 >> 4) & 15, tcl = (tw0 >> 4) & 15;
  auto cond_l = [&](int bit) { return x.av_l && !((lcl >> bit) & 1); };
  auto cond_t = [&](int bit) { return x.av_t && !((tcl >> bit) & 1); };
  auto own_z = [&](int bit) { return (int)!((b.cbp >> bit) & 1); };
  e.ctx(73 + cond_l(1) + 2 * cond_t(2), b.cbp & 1, on_cbp);
  e.ctx(73 + own_z(0) + 2 * cond_t(3), (b.cbp >> 1) & 1, on_cbp);
  e.ctx(73 + cond_l(3) + 2 * own_z(0), (b.cbp >> 2) & 1, on_cbp);
  e.ctx(73 + own_z(2) + 2 * own_z(1), (b.cbp >> 3) & 1, on_cbp);
  const int cc = b.cbp >> 4;
  const int lcc = x.av_l ? (lw0 >> 8) & 3 : 0;
  const int tcc = x.av_t ? (tw0 >> 8) & 3 : 0;
  e.ctx(77 + (lcc != 0) + 2 * (tcc != 0), cc != 0, on_cbp);
  e.ctx(81 + (lcc == 2) + 2 * (tcc == 2), max(cc - 1, 0), on_cbp && cc != 0);

  // ---- transform_size_8x8_flag of an inter MB ----
  if (P.t8_mode)
    e.ctx(399 + t8_inc, b.t8v, b.coded && b.is_inter && b.cbp_luma > 0);

  // ---- mb_qp_delta (always 0 in this encoder) ----
  e.ctx(60, 0, b.coded && (b.sel16 || b.cbp > 0));
}

// the piece of lane `lane` of a macroblock's warp, in the plain version's
// slot order: 0 the header; 1 the I16x16 luma DC; 2-17 the 16 luma
// blocks in coding order; 18-21 the luma 8x8 blocks; 22-23 chroma DC;
// 24-31 chroma AC, and after it on lane 31 end_of_slice_flag.  An
// unavailable neighbour counts as coded for an intra MB and as not coded
// for an inter one.
template <class S>
__device__ void walk_lane(S& sink, const Io& io, const Params& P,
                          const int32_t* tab, const MbCtx& x, int lane) {
  Emit<S> e{sink};
  if (lane == 0) {
    walk_header(e, io, P, tab, x);
    return;
  }
  const Mb& b = x.b;
  const int lw0 = x.lw0, tw0 = x.tw0;
  const int ic = !b.is_inter;
  if (lane == 1) {  // I16 luma DC (cat 0)
    const int ca = x.av_l ? (x.lk == K_I16 ? (lw0 >> 11) & 1 : 0) : 1;
    const int cb = x.av_t ? (x.tk == K_I16 ? (tw0 >> 11) & 1 : 0) : 1;
    residual(e, x.sh + C_LDC, 16, ldc_mask(x.mask), 105 + tab[T_SIG + 0],
             166 + tab[T_SIG + 0], 227 + tab[T_LVL + 0],
             85 + tab[T_CBF + 0] + ca + 2 * cb, b.coded && b.sel16, false);
  } else if (lane < 18) {  // luma blocks (a t8 MB's come in its 8x8 groups)
    const int idx = lane - 2;
    const int cat = b.sel16 ? 1 : 2;
    const int w1 = x.own[1];
    const int lw1 = x.av_l ? x.l[1] : 0, tw1 = x.av_t ? x.t[1] : 0;
    const int pos = tab[T_BLK + idx];
    const int by = pos >> 2, bx = pos & 3;
    const int ca = bx > 0 ? (w1 >> (pos - 1)) & 1
                   : x.av_l ? (lw1 >> (by * 4 + 3)) & 1 : ic;
    const int cb = by > 0 ? (w1 >> (pos - 4)) & 1
                   : x.av_t ? (tw1 >> (12 + bx)) & 1 : ic;
    const bool coded_blk =
        b.coded && !b.t8v &&
        ((b.sel16 && b.cbp_luma > 0) ||
         (!b.sel16 && ((b.cbp_luma >> (idx / 4)) & 1)));
    const unsigned nz = luma_mask(x.mask, idx);
    residual(e, x.sh + C_LAC + idx * 16 + (b.sel16 ? 1 : 0),
             b.sel16 ? 15 : 16, b.sel16 ? nz >> 1 : nz,
             105 + tab[T_SIG + cat], 166 + tab[T_SIG + cat],
             227 + tab[T_LVL + cat], 85 + tab[T_CBF + cat] + ca + 2 * cb,
             coded_blk, false);
  } else if (lane < 22) {
    const int b8 = lane - 18;
    if (P.t8_mode)
      residual8(e, x.sh, x.mask, b8, b.t8v && ((b.cbp_luma >> b8) & 1), tab);
  } else if (lane < 24) {  // chroma DC (cat 3)
    const int comp = lane - 22;
    const int lcc = x.av_l ? (lw0 >> 8) & 3 : 0;
    const int tcc = x.av_t ? (tw0 >> 8) & 3 : 0;
    const int ca = x.av_l ? (lcc != 0 ? (lw0 >> (12 + comp)) & 1 : 0) : ic;
    const int cb = x.av_t ? (tcc != 0 ? (tw0 >> (12 + comp)) & 1 : 0) : ic;
    residual(e, x.sh + C_CDC + comp * 4, 4, cdc_mask(x.mask, comp),
             105 + tab[T_SIG + 3], 166 + tab[T_SIG + 3], 227 + tab[T_LVL + 3],
             85 + tab[T_CBF + 3] + ca + 2 * cb,
             b.coded && b.cbp_chroma >= 1, true);
  } else {  // chroma AC (cat 4)
    const int j = lane - 24, comp = j >> 2, idx = j & 3;
    const int w0 = x.own[0];
    const int sh = 14 + 4 * comp;
    const int by = idx >> 1, bx = idx & 1;
    const int ca = bx > 0 ? (w0 >> (sh + idx - 1)) & 1
                   : x.av_l ? (lw0 >> (sh + idx + 1)) & 1 : ic;
    const int cb = by > 0 ? (w0 >> (sh + idx - 2)) & 1
                   : x.av_t ? (tw0 >> (sh + idx + 2)) & 1 : ic;
    residual(e, x.sh + C_CAC + j * 16 + 1, 15, cac_mask(x.mask, j) >> 1,
             105 + tab[T_SIG + 4], 166 + tab[T_SIG + 4],
             227 + tab[T_LVL + 4], 85 + tab[T_CBF + 4] + ca + 2 * cb,
             b.coded && b.cbp_chroma == 2, false);
    // ---- end_of_slice_flag ----
    if (lane == 31) e.term(x.last_of_slice, true);
  }
}

// the warp of MB m (slice s) loads its coefficients and its neighbours'
// state -> what every lane walks from
__device__ MbCtx mb_ctx(const Io& io, const Params& P, int m, int s,
                        MbShared& sh, int lane) {
  load_mb(io, m, sh, lane);
  MbCtx x;
  x.m = m;
  const int r = m / P.wm, c = m % P.wm;
  x.av_l = c > 0;
  x.av_t = r > P.rows[s];
  x.last_of_slice = m == P.rows[s + 1] * P.wm - 1;
  // an unavailable neighbour's state is never read; point at our own
  x.own = io.state + (size_t)m * kStateWords;
  x.l = x.av_l ? x.own - kStateWords : x.own;
  x.t = x.av_t ? x.own - (size_t)P.wm * kStateWords : x.own;
  x.lw0 = x.av_l ? x.l[0] : 0;
  x.tw0 = x.av_t ? x.t[0] : 0;
  x.lk = x.av_l ? kind_of(x.lw0) : -1;
  x.tk = x.av_t ? kind_of(x.tw0) : -1;
  const int w0 = x.own[0];
  x.b = mb_flags(io, P, m, (w0 >> 4) & 15, (w0 >> 8) & 3);
  x.sh = sh.coef;
  x.mask = sh.mask;
  return x;
}

__device__ const int32_t* load_tables(const Io& io, int32_t* sh) {
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    sh[i] = io.tables[i];
  __syncthreads();
  return sh;
}

// ---- (b) the count pass ----
__global__ void __launch_bounds__(kWarps * 32) count_kernel(Io io, Params P) {
  __shared__ int32_t tab_s[kTableWords];
  __shared__ MbShared mb_s[kWarps];
  const int32_t* tab = load_tables(io, tab_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= P.wm * P.hm) return;
  const MbCtx x = mb_ctx(io, P, m, slice_of(P, m / P.wm), mb_s[warp], lane);
  Counter cnt;
  walk_lane(cnt, io, P, tab, x, lane);
  int incl = cnt.n;                   // the warp's inclusive scan
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  io.lane_off[(size_t)m * 32 + lane] = incl - cnt.n;
  if (lane == 31) io.mb_count[m] = incl;
}

// ---- (c) each slice's exclusive scan (one block) ----
__global__ void scan_kernel(Io io, Params P) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int most = 0;
  for (int s = 0; s < P.n_slices; ++s) {
    const int lo = P.rows[s] * P.wm, hi = P.rows[s + 1] * P.wm;
    int carry = 0;
    for (int base = lo; base < hi; base += kScanThreads) {
      const int m = base + threadIdx.x;
      const int v = m < hi ? io.mb_count[m] : 0;
      int x = v;                            // inclusive scan in the warp
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      if (lane == 31) warp_sums[warp] = x;
      __syncthreads();
      if (warp == 0) {
        int w = warp_sums[lane];
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, w, d);
          if (lane >= d) w += y;
        }
        warp_sums[lane] = w;                // inclusive over warps
      }
      __syncthreads();
      const int before = warp > 0 ? warp_sums[warp - 1] : 0;
      if (m < hi) io.mb_off[m] = carry + before + x - v;
      if (threadIdx.x == kScanThreads - 1) carry_s = carry + before + x;
      __syncthreads();
      carry = carry_s;
      __syncthreads();
    }
    if (threadIdx.x == 0) io.counts[s] = carry;
    most = max(most, carry);
  }
  if (threadIdx.x == 0) io.counts[P.n_slices] = most;
}

// ---- (d) the emit pass and the zeros past each slice's count ----
// Each lane writes its piece at its MB's offset plus its own (the count
// pass's warp scan); no record lands past a row's end.
__global__ void __launch_bounds__(kWarps * 32)
    emit_kernel(Io io, Params P, int32_t* recs, int stride) {
  __shared__ int32_t tab_s[kTableWords];
  __shared__ MbShared mb_s[kWarps];
  const int32_t* tab = load_tables(io, tab_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = P.wm * P.hm;
  const int m = blockIdx.x * kWarps + warp;
  if (m < n) {
    const int s = slice_of(P, m / P.wm);
    const MbCtx x = mb_ctx(io, P, m, s, mb_s[warp], lane);
    const int off = io.mb_off[m] + io.lane_off[(size_t)m * 32 + lane];
    Writer w{recs + (size_t)s * stride + off, 0, stride - off};
    walk_lane(w, io, P, tab, x, lane);
  }
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int threads = gridDim.x * blockDim.x;
  for (int s = 0; s < P.n_slices; ++s) {
    int32_t* row = recs + (size_t)s * stride;
    for (int k = io.counts[s] + tid; k < stride; k += threads) row[k] = 0;
  }
}

int parse(void* const* ptrs, const int32_t* params, Io& io, Params& p) {
  const int32_t* q = params;
  p.wm = *q++;
  p.hm = *q++;
  p.kind = *q++;
  p.t8_mode = *q++;
  p.parts = *q++;
  p.p8x8 = *q++;
  p.n_slices = *q++;
  if (p.n_slices < 1 || p.n_slices > kMaxSlices || p.kind < SL_I ||
      p.kind > SL_B)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s <= p.n_slices; ++s) p.rows[s] = q[s];
  if (p.rows[0] != 0 || p.rows[p.n_slices] != p.hm)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < p.n_slices; ++s)
    if (p.rows[s + 1] <= p.rows[s]) return (int)cudaErrorInvalidValue;
  void* const* a = ptrs;
  io.sel16 = (const uint8_t*)a[0];
  io.is_inter = (const uint8_t*)a[1];
  io.t8 = (const uint8_t*)a[2];
  io.luma_ac = (const int32_t*)a[3];
  io.luma_dc = (const int32_t*)a[4];
  io.chroma_dc = (const int32_t*)a[5];
  io.chroma_ac = (const int32_t*)a[6];
  io.modes = (const int32_t*)a[7];
  io.cmode = (const int32_t*)a[8];
  io.i16mode = (const int32_t*)a[9];
  io.mv = (const int32_t*)a[10];
  io.mv_skip = (const int32_t*)a[11];
  io.ptype = (const int32_t*)a[12];
  io.btype = (const int32_t*)a[13];
  io.c0 = (const int32_t*)a[14];
  io.c1 = (const int32_t*)a[15];
  io.bptype = (const int32_t*)a[16];
  io.mv2 = (const int32_t*)a[17];
  io.mvq = (const int32_t*)a[18];
  io.use0 = (const uint8_t*)a[19];
  io.use1 = (const uint8_t*)a[20];
  io.mv0 = (const int32_t*)a[21];
  io.mv1 = (const int32_t*)a[22];
  io.mv0b = (const int32_t*)a[23];
  io.mv1b = (const int32_t*)a[24];
  io.tables = (const int32_t*)a[25];
  io.mvds = (int32_t*)a[26];
  io.mpm = (int32_t*)a[27];
  io.state = (int32_t*)a[28];
  io.mb_count = (int32_t*)a[29];
  io.mb_off = (int32_t*)a[30];
  io.lane_off = (int32_t*)a[31];
  io.counts = (int32_t*)a[32];
  return 0;
}

int mb_blocks(const Params& p) {
  return (p.wm * p.hm + kWarps - 1) / kWarps;
}

void launch_emit(const Io& io, const Params& p, int32_t* recs, int stride,
                 cudaStream_t s) {
  // enough blocks for the zeros too, four words a thread at least
  const int threads = kWarps * 32;
  const long long words = (long long)p.n_slices * stride;
  long long zb = (words / 4 + threads - 1) / threads;
  zb = zb > 4096 ? 4096 : zb;
  const int blocks = mb_blocks(p);
  emit_kernel<<<blocks > zb ? blocks : (int)zb, threads, 0, s>>>(io, p, recs,
                                                                 stride);
}

}  // namespace

// `ptrs`: the 33 device pointers of `Io` in its order (a null pointer
// for an input the slice kind does not have; `mvds`, `mpm`, `state`,
// `mb_count`, `mb_off`, `lane_off` and `counts` are written); `params`:
// the host int32 array of `kernels/mb_preds.py` `pack_params` (wm, hm,
// slice kind, t8 mode, partitions, P_8x8, n_slices, then the n_slices + 1
// row bounds).  `emit_only` 0: launch the state, count, scan and emit
// passes, the emit into `recs` [n_slices, stride]; 1: launch the emit pass
// alone on the offsets and counts of the last scan (for rows wider than
// the first emit's, `stride` at least the largest count).  Nothing is
// read back: the caller reads the largest count, `counts[n_slices]`.
extern "C" int tpu264_cabac_records(void* const* ptrs, const int32_t* params,
                                    int32_t* recs, int stride, int emit_only,
                                    void* stream) {
  Io io;
  Params p;
  if (parse(ptrs, params, io, p) != 0 || stride < 0 || io.mpm == nullptr ||
      io.state == nullptr || (p.kind != SL_I && io.mvds == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n = p.wm * p.hm;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (!emit_only) {
    const int threads = kWarps * 32;
    state_kernel<<<mb_blocks(p), threads, 0, s>>>(io, p);
    count_kernel<<<mb_blocks(p), threads, 0, s>>>(io, p);
    scan_kernel<<<1, kScanThreads, 0, s>>>(io, p);
  }
  launch_emit(io, p, recs, stride, s);
  return (int)cudaGetLastError();
}

