// Kernel KV: CAVLC serialize + pack of one picture (I, P or B slices), or
// of a chunk of all-intra pictures, in four launches, from the raster
// macroblock dict straight to the packed 32-bit words of every slice.
//
// Replaces no Pallas kernel: the reference writes this stage in jnp
// (`tpu264/entropy/device_cavlc.py:88` `encode_blocks_j`, `:373` / `:669` /
// `:819` `serialize_frame{,_p,_b}_j`, `:985` `pack_slices_j`).  The port's
// plain version (`entropy/device_cavlc.py` `serialize_frame*` +
// `pack_slices`) builds a grid of about a thousand (code, length) slots a
// macroblock, then packs it by a prefix sum and two scatter-adds; eagerly
// that is thousands of launches a picture.
//
// A macroblock is one warp.  Its bits are what the plain version's slots
// give in slot order, cut into pieces, one a lane: lane 0 the header
// (mb_type to mb_qp_delta, after the mb_skip_run that the scan places),
// lanes 1-27 the 27 residual blocks in `_residual_slots`' order (the
// I16x16 luma DC, the 16 luma 4x4 blocks in zig-zag order, 2 chroma DC, 8
// chroma AC).  A lane's piece is a run of the macroblock's bits, so a warp
// exclusive scan of the pieces' lengths places each one.  One walk
// routine per piece (`walk_lane`), templated on its sink, serves the count
// and the emit pass, so offsets and bits cannot disagree.  The mvds and
// most probable modes come from KD (`tpu264_mb_preds`, one launch before
// these four).
//  (a) `kv_state_kernel`: each macroblock's coded_block_pattern, whether
//      it is skipped (P_Skip, B_Skip), and the TotalCoeff of its 16 luma
//      and 8 chroma AC blocks as the nC grids count them (all 16
//      coefficients, masked by the 8x8 block's cbp bit; chroma masked by
//      cbp_chroma == 2): `kStateWords` words a macroblock;
//  (b) `kv_count_kernel`: the walk with a counting sink -> bits a
//      macroblock without its mb_skip_run, each lane's offset in it (a
//      warp scan); it also zero-fills the words (the rows to `cap` of
//      every slice), which the emit pass then only adds to;
//  (c) `kv_scan_kernel`: a block a slice, each macroblock's mb_skip_run
//      (a max-scan of the coded macroblocks' positions), its bits with
//      the run's ue(v), their exclusive scan -> each macroblock's first
//      bit in its slice and the slice's bit count;
//  (d) `kv_emit_kernel`: the walk with a writing sink at those offsets.
// No slot grid is written, and the host reads nothing between passes.
//
// Bound: bytes (the MB dict's coefficients and modes read once, the
// words and counts written once; PERF.md, KV's row).
//
// Exactness: every code goes into its word as `pack_slices` puts it, as
// the top `min(len, 32 - off)` bits of its value shifted to its offset
// and the rest into the next word, and is combined by addition modulo
// 2^32 (the plain version's scatter-add; disjoint bits make it an OR),
// so a code wider than its length packs as it does there too.  Words at
// or past `cap` are dropped; the bit counts keep every bit.  Slices are
// whole macroblock rows, so a left neighbour is missing only in column 0
// and a top one in a slice's first row; each picture of a chunk starts a
// slice.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlices = 256;
constexpr int kStateWords = 8;
constexpr int kWarps = 4;             // macroblocks (warps) a block
constexpr int kScanThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// a macroblock's coefficients in shared memory: luma AC [16][16], chroma
// AC [2][4][16], luma DC [16], chroma DC [2][4]
constexpr int C_LAC = 0, C_CAC = 256, C_LDC = 384, C_CDC = 400;
constexpr int kCoefWords = 408;
constexpr int kMaskWords = (kCoefWords + 31) / 32;

// the tables (`kernels/cavlc_slices.py` `tables()`): a code and its
// length as len << 16 | code (coeff_token, total_zeros, run_before; the
// port's `entropy/cavlc_tables.py`), the cbp code numbers
// (`entropy/mb_syntax.py`), COMBO_IDX and BLK_ORDER as by * 4 + bx
constexpr int T_CT = 0;               // coeff_token [4 nC tables][68]
constexpr int T_CCT = 272;            // chroma DC coeff_token [20]
constexpr int T_CTZ = 292;            // chroma DC total_zeros [3][4]
constexpr int T_TZ = 304;             // total_zeros [16][16]
constexpr int T_RB = 560;             // run_before [7][16]
constexpr int T_CBPI = 672;           // CBP_TO_CODENUM_INTRA [48]
constexpr int T_CBPP = 720;           // CBP_TO_CODENUM_INTER [48]
constexpr int T_COMBO = 768;          // COMBO_IDX [9]
constexpr int T_BLK = 777;            // BLK_ORDER as by * 4 + bx [16]
constexpr int kTableWords = 793;

constexpr int SL_I = 0, SL_P = 1, SL_B = 2;

struct Params {
  int wm, hm, kind, t8_mode, parts, p8x8, n_slices;
  int rows[kMaxSlices + 1];           // slice start rows, then hm
  int pics;                           // pictures of this layout, one after
                                      // the other
  int cap;                            // words a slice's row
};

struct Io {
  const uint8_t* sel16;               // [n] bool
  const uint8_t* is_inter;            // [n] bool (P)
  const uint8_t* t8;                  // [n] bool (P with the 8x8 PPS)
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
  const int32_t* tables;              // [kTableWords]
  const int32_t* mvds;                // [n, 2 lists, 4 parts, 2] (KD; P, B)
  const int32_t* mpm;                 // [n, 16] (KD)
  int32_t* state;                     // [n, kStateWords]
  int32_t* mb_count;                  // [n]: bits without the skip run
  int64_t* mb_off;                    // [n]: first bit in its slice
  int32_t* run;                       // [n]: mb_skip_run of a coded MB
  int32_t* lane_off;                  // [n, 32]: each lane's piece in its MB
  uint32_t* words;                    // [pics * n_slices, cap]
  int64_t* nbits;                     // [pics * n_slices]
  uint8_t* skipped;                   // [n] bool (P, B); null in I
};

__device__ __forceinline__ int bitlen_m1(unsigned v) {   // v >= 1
  return 31 - __clz((int)v);
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// the slice of MB row r of a picture
__device__ int slice_of(const Params& P, int r) {
  int s = 0;
  while (s + 1 < P.n_slices && P.rows[s + 1] <= r) ++s;
  return s;
}

// the zig-zag index of the 4x4 block at (by, bx) (`BLK_ORDER`'s inverse)
__device__ __forceinline__ int zz_of(int by, int bx) {
  return 8 * (by >> 1) + 4 * (bx >> 1) + 2 * (by & 1) + (bx & 1);
}

// ---- a macroblock's coefficients in shared memory and their masks ----

__device__ __forceinline__ int32_t coef_src(const Io& io, int m, int i) {
  if (i < C_CAC) return io.luma_ac[(size_t)m * 256 + i];
  if (i < C_LDC) return io.chroma_ac[(size_t)m * 128 + (i - C_CAC)];
  if (i < C_CDC) return io.luma_dc[(size_t)m * 16 + (i - C_LDC)];
  return io.chroma_dc[(size_t)m * 8 + (i - C_CDC)];
}

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

// the 16-bit nonzero masks of luma block i and chroma AC block j (all 16
// coefficients)
__device__ __forceinline__ unsigned luma_mask(const unsigned* mask, int i) {
  return (mask[i >> 1] >> (16 * (i & 1))) & 0xffffu;
}
__device__ __forceinline__ unsigned cac_mask(const unsigned* mask, int j) {
  return (mask[8 + (j >> 1)] >> (16 * (j & 1))) & 0xffffu;
}

// ---- the macroblock's flags ----

struct Mb {
  bool is_inter, is_direct, sel16, coded, is_i4;
  int cbp_luma, cbp_chroma, cbp;
  int ptype;                          // P: ptype, B: bptype (0 without)
  int btype;
  bool partd;                         // B 16x8 / 8x16
  bool exp[2], exp_b[2];              // B: lists with an explicit mvd
};

// (cl, cc): the coefficients' cbp bits before the I16x16 rule
// (`compute_cbp`)
__device__ Mb mb_flags(const Io& io, const Params& P, int m, int cl, int cc) {
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
  bool skipped = false;
  if (P.kind == SL_P) {
    const int32_t* mv = io.mv + 2 * m;
    const int32_t* ms = io.mv_skip + 2 * m;
    skipped = b.is_inter && b.ptype == 0 && mv[0] == ms[0] &&
              mv[1] == ms[1] && b.cbp == 0;
  } else if (P.kind == SL_B) {
    skipped = b.is_direct && b.cbp == 0;
  }
  b.coded = !skipped;
  b.is_i4 = b.coded && !b.is_inter && !b.sel16;
  return b;
}

// coded_block_pattern bits of the coefficients (`compute_cbp`, before the
// I16x16 rule)
__device__ void cbp_of(const unsigned* mask, int& cl, int& cc) {
  cl = 0;
  for (int b8 = 0; b8 < 4; ++b8)
    if (mask[2 * b8] | mask[2 * b8 + 1]) cl |= 1 << b8;
  cc = (mask[8] | mask[9] | mask[10] | mask[11]) ? 2
       : ((mask[12] >> 16) & 0xffu)              ? 1
                                                 : 0;
}

// ---- (a) the state pass ----
// word 0-3: the masked TotalCoeff of luma block 4 w + k in byte k of word
// w; words 4-5: chroma AC block 4 comp + k likewise; word 6: cbp_luma |
// cbp_chroma << 4 | skipped << 8.
__global__ void __launch_bounds__(kWarps * 32)
    kv_state_kernel(Io io, Params P) {
  __shared__ MbShared mb_s[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= P.wm * P.hm * P.pics) return;  // whole warps: no block barrier
  load_mb(io, m, mb_s[warp], lane);
  const unsigned* mask = mb_s[warp].mask;
  int cl, cc;
  cbp_of(mask, cl, cc);
  const Mb b = mb_flags(io, P, m, cl, cc);
  int32_t* st = io.state + (size_t)m * kStateWords;
  if (lane < 6) {
    unsigned w = 0;
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;
      int tc;
      if (lane < 4)
        tc = ((b.cbp_luma >> (i >> 2)) & 1) ? __popc(luma_mask(mask, i)) : 0;
      else
        tc = b.cbp_chroma == 2 ? __popc(cac_mask(mask, i - 16)) : 0;
      w |= (unsigned)tc << (8 * k);
    }
    st[lane] = (int32_t)w;
  } else if (lane == 6) {
    st[6] = b.cbp_luma | (b.cbp_chroma << 4) | ((!b.coded) << 8);
    if (io.skipped != nullptr) io.skipped[m] = !b.coded;
  } else if (lane == 7) {
    st[7] = 0;
  }
}

// ---- the sinks ----

struct Counter {
  int n = 0;
  __device__ void put(uint32_t, int len) { n += len; }
};

// codes into a slice's row of words as `pack_slices` packs them: each
// code's hi and lo parts added to their words, the sums of a word kept
// in a register until the lane moves on to the next word
struct Writer {
  uint32_t* row;
  int cap;
  int64_t pos;
  int64_t cw;                         // the word `acc` belongs to, or -1
  uint32_t acc;
  __device__ void flush() {
    if (cw >= 0 && cw < cap && acc != 0) atomicAdd(row + cw, acc);
  }
  __device__ void add(int64_t w, uint32_t v) {
    if (w != cw) {
      flush();
      cw = w;
      acc = 0;
    }
    acc += v;
  }
  __device__ void put(uint32_t v, int len) {
    if (len <= 0) return;
    const int off = (int)(pos & 31);
    const int64_t w = pos >> 5;
    const int take = min(len, 32 - off), rem = len - take;
    add(w, (uint32_t)((((uint64_t)v >> rem) << (32 - off - take)) &
                      0xffffffffull));
    if (rem > 0)
      add(w + 1, (uint32_t)((((uint64_t)v & ((1ull << rem) - 1)) << (32 - rem))
                            & 0xffffffffull));
    pos += len;
  }
};

// ue(v) (`ue_code`)
template <class S>
__device__ __forceinline__ void put_ue(S& s, int v) {
  const unsigned vp1 = (unsigned)v + 1u;
  s.put(vp1, 2 * bitlen_m1(vp1) + 1);
}

__device__ __forceinline__ int se_to_ue(int v) {
  return v > 0 ? 2 * v - 1 : -2 * v;
}

// a table entry len << 16 | code
template <class S>
__device__ __forceinline__ void put_tab(S& s, int e) {
  s.put((uint32_t)(e & 0xffff), e >> 16);
}

// level_prefix + level_suffix of level_code `lc` at suffixLength `sl`
// (`_encode_level`)
template <class S>
__device__ void put_level(S& s, int lc, int sl) {
  if (sl == 0) {
    if (lc < 14)
      s.put(1u, lc + 1);
    else if (lc < 30)
      s.put((1u << 4) | (uint32_t)(lc - 14), 19);
    else
      s.put((1u << 12) | (uint32_t)(lc - 30), 28);
    return;
  }
  const int prefix = lc >> sl;
  if (prefix < 15)
    s.put((1u << sl) | (uint32_t)(lc & ((1 << sl) - 1)), prefix + 1 + sl);
  else
    s.put((1u << 12) | (uint32_t)(lc - (15 << sl)), 28);
}

// one residual block (`encode_blocks`): `mc` scan-order coefficients at
// p[0..mc), its nC (-1: chroma DC)
template <class S>
__device__ void residual(S& s, const int32_t* p, int mc, int nc,
                         const int32_t* tab) {
  int lev[16], idx[16];
  int tc = 0;
  for (int i = mc - 1; i >= 0; --i)
    if (p[i] != 0) {
      lev[tc] = p[i];
      idx[tc] = i;
      ++tc;
    }
  int t1 = 0;
  while (t1 < 3 && t1 < tc && iabs(lev[t1]) == 1) ++t1;
  // coeff_token
  const int ct = 4 * tc + t1;
  if (nc == -1) {
    put_tab(s, tab[T_CCT + min(ct, 19)]);
  } else {
    const int tsel = nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3));
    put_tab(s, tab[T_CT + tsel * 68 + ct]);
  }
  // trailing ones' signs
  for (int k = 0; k < t1; ++k) s.put(lev[k] < 0, 1);
  // levels
  int sl = (tc > 10 && t1 < 3) ? 1 : 0;
  for (int k = t1; k < tc; ++k) {
    const int v = lev[k], a = iabs(v);
    int lc = v > 0 ? 2 * a - 2 : 2 * a - 1;
    if (k == t1 && t1 < 3) lc -= 2;
    put_level(s, lc, sl);
    if (sl == 0) sl = 1;
    if (a > (3 << (sl - 1)) && sl < 6) ++sl;
  }
  if (tc == 0) return;
  // total_zeros
  const int tz = idx[0] + 1 - tc;
  if (tc < mc) {
    if (mc == 4)
      put_tab(s, tab[T_CTZ + min(tc - 1, 2) * 4 + min(max(tz, 0), 3)]);
    else
      put_tab(s, tab[T_TZ + (tc - 1) * 16 + min(max(tz, 0), 15)]);
  }
  // run_before
  int zl = tz;
  for (int k = 0; k < tc - 1 && k + 1 < mc && zl > 0; ++k) {
    const int run = idx[k] - idx[k + 1] - 1;
    const int row = min(max(min(zl, 7) - 1, 0), 6);
    put_tab(s, tab[T_RB + row * 16 + min(max(run, 0), 15)]);
    zl -= run;
  }
}

// the mvd of one partition: x (component 1) then y (component 0)
template <class S>
__device__ __forceinline__ void put_mvd(S& s, const int32_t* d) {
  put_ue(s, se_to_ue(d[1]));
  put_ue(s, se_to_ue(d[0]));
}

// what every lane of a macroblock's warp knows of it
struct MbCtx {
  int m;                              // the MB (over the chunk)
  bool av_l, av_t;
  const int32_t* own;                 // the MB's state
  const int32_t* l;                   // left neighbour's state
  const int32_t* t;                   // top neighbour's state
  Mb b;
  const int32_t* sh;                  // the coefficients (C_* layout)
};

// lane 0's piece: the header, mb_type to mb_qp_delta
// (`serialize_frame`, `_p`, `_b`)
template <class S>
__device__ void walk_header(S& s, const Io& io, const Params& P,
                            const int32_t* tab, const MbCtx& x) {
  const Mb& b = x.b;
  const int m = x.m;
  if (!b.coded) return;
  const int mbt_intra =
      b.sel16 ? 1 + io.i16mode[m] + 4 * b.cbp_chroma + 12 * (b.cbp_luma > 0)
              : 0;
  if (P.kind == SL_I) {
    put_ue(s, mbt_intra);
  } else if (P.kind == SL_P) {
    put_ue(s, b.is_inter ? b.ptype : 5 + mbt_intra);
    if (P.p8x8 && b.is_inter && b.ptype == 3) s.put(15u, 4);  // 4 x ue(0)
  } else {
    int mbt = b.is_direct ? 0 : (b.is_inter ? b.btype + 1 : 23 + mbt_intra);
    if (P.parts && b.partd)
      mbt = 4 + 2 * tab[T_COMBO + io.c0[m] * 3 + io.c1[m]] + (b.ptype == 2);
    put_ue(s, mbt);
  }
  if (P.t8_mode && b.is_i4) s.put(0u, 1);     // transform_size_8x8_flag
  if (b.is_i4) {
    const int32_t* modes = io.modes + (size_t)m * 16;
    const int32_t* mpm = io.mpm + (size_t)m * 16;
    for (int k = 0; k < 16; ++k) {
      const int md = modes[k], pm = mpm[k];
      if (md == pm)
        s.put(1u, 1);
      else
        s.put((uint32_t)(md - (md > pm)), 4);
    }
  }
  if (!b.is_inter) put_ue(s, io.cmode[m]);
  // mvds: P list 0's part 0 (q0), part 1 (q1), q2, q3; B per list its
  // explicit part 0 and part 1
  const int32_t* d = io.mvds != nullptr ? io.mvds + (size_t)m * 16 : nullptr;
  if (P.kind == SL_P && b.is_inter) {
    put_mvd(s, d);
    if (P.parts && b.ptype > 0) put_mvd(s, d + 2);
    if (P.p8x8 && b.ptype == 3) {
      put_mvd(s, d + 4);
      put_mvd(s, d + 6);
    }
  } else if (P.kind == SL_B) {
    for (int l = 0; l < 2; ++l) {
      if (b.exp[l]) put_mvd(s, d + 8 * l);
      if (P.parts && b.exp_b[l]) put_mvd(s, d + 8 * l + 2);
    }
  }
  // coded_block_pattern, the inter MB's 8x8 flag, mb_qp_delta (se(0))
  if (b.is_inter)
    put_ue(s, tab[T_CBPP + b.cbp]);
  else if (b.is_i4)
    put_ue(s, tab[T_CBPI + b.cbp]);
  if (P.t8_mode && P.kind != SL_I && b.is_inter && b.cbp_luma > 0)
    s.put(P.kind == SL_P && io.t8[m] ? 1u : 0u, 1);
  if (b.sel16 || b.cbp > 0) s.put(1u, 1);
}

// the TotalCoeff that the state keeps of block `i` (0-15 luma, 16-23
// chroma AC)
__device__ __forceinline__ int tc_at(const int32_t* st, int i) {
  return (st[i >> 2] >> (8 * (i & 3))) & 0xff;
}

// nC of luma block `idx` (zig-zag) or, with `chroma`, of chroma AC block
// comp * 4 + idx from its left and top neighbours' TotalCoeff
// (`_nc_from_grid`)
__device__ int nc_of(const MbCtx& x, int idx, bool chroma, int comp,
                     const int32_t* tab) {
  int by, bx, w;
  if (chroma) {
    by = idx >> 1;
    bx = idx & 1;
    w = 2;
  } else {
    const int pos = tab[T_BLK + idx];
    by = pos >> 2;
    bx = pos & 3;
    w = 4;
  }
  auto at = [&](const int32_t* st, int yy, int xx) {
    return chroma ? tc_at(st, 16 + 4 * comp + 2 * yy + xx)
                  : tc_at(st, zz_of(yy, xx));
  };
  const bool av_a = bx > 0 || x.av_l;
  const bool av_b = by > 0 || x.av_t;
  const int na = !av_a ? 0 : bx > 0 ? at(x.own, by, bx - 1)
                                    : at(x.l, by, w - 1);
  const int nb = !av_b ? 0 : by > 0 ? at(x.own, by - 1, bx)
                                    : at(x.t, w - 1, bx);
  if (av_a && av_b) return (na + nb + 1) >> 1;
  return av_a ? na : nb;
}

// the piece of lane `lane` of a macroblock's warp: 0 the header; 1 the
// I16x16 luma DC; 2-17 the 16 luma blocks; 18-19 chroma DC; 20-27 chroma
// AC (`_residual_slots`); an uncoded block has none
template <class S>
__device__ void walk_lane(S& s, const Io& io, const Params& P,
                          const int32_t* tab, const MbCtx& x, int lane) {
  const Mb& b = x.b;
  if (lane == 0) {
    walk_header(s, io, P, tab, x);
  } else if (lane == 1) {
    if (b.sel16) residual(s, x.sh + C_LDC, 16, nc_of(x, 0, false, 0, tab), tab);
  } else if (lane < 18) {
    const int k = lane - 2;
    if ((b.cbp_luma >> (k >> 2)) & 1)
      residual(s, x.sh + C_LAC + 16 * k + (b.sel16 ? 1 : 0),
               b.sel16 ? 15 : 16, nc_of(x, k, false, 0, tab), tab);
  } else if (lane < 20) {
    if (b.cbp_chroma >= 1)
      residual(s, x.sh + C_CDC + 4 * (lane - 18), 4, -1, tab);
  } else if (lane < 28) {
    const int j = lane - 20;
    if (b.cbp_chroma == 2)
      residual(s, x.sh + C_CAC + 16 * j + 1, 15,
               nc_of(x, j & 3, true, j >> 2, tab), tab);
  }
}

// the warp of MB m loads its coefficients and finds its neighbours' state
// -> what every lane walks from
__device__ MbCtx mb_ctx(const Io& io, const Params& P, int m, MbShared& sh,
                        int lane) {
  load_mb(io, m, sh, lane);
  MbCtx x;
  x.m = m;
  const int n = P.wm * P.hm;
  const int loc = m % n;
  const int r = loc / P.wm, c = loc % P.wm;
  x.av_l = c > 0;
  x.av_t = r > P.rows[slice_of(P, r)];
  // an unavailable neighbour's state is never read; point at our own
  x.own = io.state + (size_t)m * kStateWords;
  x.l = x.av_l ? x.own - kStateWords : x.own;
  x.t = x.av_t ? x.own - (size_t)P.wm * kStateWords : x.own;
  const int w6 = x.own[6];
  x.b = mb_flags(io, P, m, w6 & 15, (w6 >> 4) & 3);
  x.sh = sh.coef;
  return x;
}

__device__ const int32_t* load_tables(const Io& io, int32_t* sh) {
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    sh[i] = io.tables[i];
  __syncthreads();
  return sh;
}

// ---- (b) the count pass, and the words' zero fill ----
__global__ void __launch_bounds__(kWarps * 32)
    kv_count_kernel(Io io, Params P) {
  __shared__ int32_t tab_s[kTableWords];
  __shared__ MbShared mb_s[kWarps];
  const int32_t* tab = load_tables(io, tab_s);
  const long long n_words =
      (long long)P.pics * P.n_slices * (long long)P.cap;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < n_words; k += (long long)gridDim.x * blockDim.x)
    io.words[k] = 0u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= P.wm * P.hm * P.pics) return;
  if ((io.state[(size_t)m * kStateWords + 6] >> 8) & 1) {  // skipped
    if (lane == 0) io.mb_count[m] = 0;
    return;
  }
  const MbCtx x = mb_ctx(io, P, m, mb_s[warp], lane);
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

// ---- (c) a block a slice: skip runs and the exclusive scan of bits ----
__global__ void __launch_bounds__(kScanThreads)
    kv_scan_kernel(Io io, Params P) {
  __shared__ long long warp_s[kScanThreads / 32];
  __shared__ long long carry_s[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = kScanThreads / 32;
  const int g = blockIdx.x;           // the slice over the chunk
  const int pic = g / P.n_slices, s = g % P.n_slices;
  const int base_m = pic * P.wm * P.hm;
  const int lo = base_m + P.rows[s] * P.wm;
  const int hi = base_m + P.rows[s + 1] * P.wm;
  long long last = lo - 1;            // the last coded MB so far
  long long carry = 0;                // bits so far
  for (int base = lo; base < hi; base += kScanThreads) {
    const int m = base + threadIdx.x;
    const bool in = m < hi;
    const bool coded =
        in && !((io.state[(size_t)(in ? m : lo) * kStateWords + 6] >> 8) & 1);
    // inclusive max-scan of the coded MBs' positions
    long long x = coded ? m : -1;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = max(x, y);
    }
    if (lane == 31) warp_s[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long w = lane < nw ? warp_s[lane] : -1;
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w = max(w, y);
      }
      if (lane < nw) warp_s[lane] = w;
    }
    __syncthreads();
    // the last coded MB before this one
    long long prev = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) prev = -1;
    if (warp > 0) prev = max(prev, warp_s[warp - 1]);
    prev = max(prev, last);
    const long long tile_last = max(last, warp_s[nw - 1]);
    int bits = 0;
    if (coded) {
      bits = io.mb_count[m];
      if (P.kind != SL_I) {
        const int run = (int)(m - prev - 1);
        io.run[m] = run;
        bits += 2 * bitlen_m1((unsigned)run + 1u) + 1;
      }
    }
    __syncthreads();
    // exclusive sum-scan of the bits
    long long v = bits;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += y;
    }
    if (lane == 31) warp_s[warp] = v;
    __syncthreads();
    if (warp == 0) {
      long long w = lane < nw ? warp_s[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += y;
      }
      if (lane < nw) warp_s[lane] = w;
    }
    __syncthreads();
    const long long before = warp > 0 ? warp_s[warp - 1] : 0;
    if (in) io.mb_off[m] = carry + before + v - bits;
    if (threadIdx.x == 0) {
      carry_s[0] = carry + warp_s[nw - 1];
      carry_s[1] = tile_last;
    }
    __syncthreads();
    carry = carry_s[0];
    last = carry_s[1];
    __syncthreads();
  }
  if (threadIdx.x == 0) io.nbits[g] = carry;
}

// ---- (d) the emit pass ----
// Each lane writes its piece at its MB's first bit plus the skip run's
// bits plus its own offset (the count pass's warp scan); lane 0 writes the
// skip run first.
__global__ void __launch_bounds__(kWarps * 32)
    kv_emit_kernel(Io io, Params P) {
  __shared__ int32_t tab_s[kTableWords];
  __shared__ MbShared mb_s[kWarps];
  const int32_t* tab = load_tables(io, tab_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + warp;
  const int n = P.wm * P.hm;
  if (m >= n * P.pics) return;
  if ((io.state[(size_t)m * kStateWords + 6] >> 8) & 1) return;  // skipped
  const MbCtx x = mb_ctx(io, P, m, mb_s[warp], lane);
  const int pic = m / n, r = m % n / P.wm;
  const int g = pic * P.n_slices + slice_of(P, r);
  Writer w{io.words + (size_t)g * P.cap, P.cap, io.mb_off[m], -1, 0u};
  if (P.kind != SL_I) {
    const int run = io.run[m];
    if (lane == 0)
      put_ue(w, run);
    else
      w.pos += 2 * bitlen_m1((unsigned)run + 1u) + 1;
  }
  w.pos += io.lane_off[(size_t)m * 32 + lane];
  walk_lane(w, io, P, tab, x, lane);
  w.flush();
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
      p.kind > SL_B || p.wm < 1 || p.hm < 1)
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
  io.tables = (const int32_t*)a[17];
  io.mvds = (const int32_t*)a[18];
  io.mpm = (const int32_t*)a[19];
  io.state = (int32_t*)a[20];
  io.mb_count = (int32_t*)a[21];
  io.mb_off = (int64_t*)a[22];
  io.run = (int32_t*)a[23];
  io.lane_off = (int32_t*)a[24];
  io.words = (uint32_t*)a[25];
  io.nbits = (int64_t*)a[26];
  io.skipped = (uint8_t*)a[27];
  return 0;
}

}  // namespace

// `ptrs`: the 28 device pointers of `Io` in its order (a null pointer for
// an input the slice kind does not read; `state`, `mb_count`, `mb_off`,
// `run`, `lane_off`, `words`, `nbits` and, in P and B, `skipped` are
// written); `params`: the host int32 array of `kernels/mb_preds.py`
// `pack_params` (wm, hm, slice kind, t8 mode, partitions, P_8x8,
// n_slices, then the n_slices + 1 row bounds); `pics` pictures of that
// layout one after the other in every input and output; `cap` words a
// slice's row.  Launches the state, count, scan and emit passes; nothing
// is read back.
extern "C" int tpu264_cavlc_slices(void* const* ptrs, const int32_t* params,
                                   int pics, int cap, void* stream) {
  Io io;
  Params p;
  if (parse(ptrs, params, io, p) != 0 || pics < 1 || cap < 0)
    return (int)cudaErrorInvalidValue;
  p.pics = pics;
  p.cap = cap;
  const long long n = (long long)p.wm * p.hm * pics;
  if (n > (1LL << 30) || io.tables == nullptr || io.mpm == nullptr ||
      io.state == nullptr || io.words == nullptr || io.nbits == nullptr ||
      (p.kind != SL_I && (io.mvds == nullptr || io.skipped == nullptr)) ||
      (p.kind == SL_P && p.t8_mode && io.t8 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = kWarps * 32;
  const int blocks = (int)((n + kWarps - 1) / kWarps);
  kv_state_kernel<<<blocks, threads, 0, s>>>(io, p);
  kv_count_kernel<<<blocks, threads, 0, s>>>(io, p);
  kv_scan_kernel<<<pics * p.n_slices, kScanThreads, 0, s>>>(io, p);
  kv_emit_kernel<<<blocks, threads, 0, s>>>(io, p);
  return (int)cudaGetLastError();
}
