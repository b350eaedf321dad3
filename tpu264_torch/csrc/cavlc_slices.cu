// Kernel KV: CAVLC serialize + pack of one picture (I, P or B slices), or
// of a chunk of all-intra pictures, in two launches, from the raster
// macroblock dict straight to the packed 32-bit words of every slice.
//
// Replaces no Pallas kernel: the reference writes this stage in jnp
// (`tpu264/entropy/device_cavlc.py:88` `encode_blocks_j`, `:373` / `:669` /
// `:819` `serialize_frame{,_p,_b}_j`, `:985` `pack_slices_j`, and their
// inputs `:258` `_mpm_grid_j`, `:527` / `:650` `_partition_mvds{_core,}_j`).
// The port's plain version (`entropy/device_cavlc.py` `serialize_frame*` +
// `pack_slices`) builds a grid of about a thousand (code, length) slots a
// macroblock, then packs it by a prefix sum and two scatter-adds; eagerly
// that is thousands of launches a picture.
//
// A macroblock is one warp.  Its bits are what the plain version's slots
// give in slot order, cut into pieces, one a lane: the header in four
// (lane 0 mb_type and an I_NxN MB's transform_size_8x8_flag, lane 28 the
// 16 intra modes, lane 29 intra_chroma_pred_mode and the mvds, lane 30
// coded_block_pattern, an inter MB's 8x8 flag and mb_qp_delta), then lanes
// 1-27 the 27 residual blocks in `_residual_slots`' order (the I16x16 luma
// DC, the 16 luma 4x4 blocks in zig-zag order, 2 chroma DC, 8 chroma AC).
// A piece is a run of the macroblock's bits, so a warp exclusive scan of
// the pieces' lengths in that order places each one.  One walk routine
// per piece (`walk_lane`), templated on its sink, serves the staged and
// the direct path, so offsets and bits cannot disagree.
//  (a) `kv_state_kernel`: each macroblock's mvds and most probable modes
//      (`mb_preds.cuh`, the derivation KR's state pass runs too), its
//      coded_block_pattern, whether it is skipped (P_Skip, B_Skip), and
//      the TotalCoeff of its 16 luma and 8 chroma AC blocks as the nC
//      grids count them (all 16 coefficients, masked by the 8x8 block's
//      cbp bit; chroma masked by cbp_chroma == 2); it also zero-fills the
//      words (the rows to `cap` of every slice) and the tiles' look-back
//      slots;
//  (b) `kv_slices_kernel`: a single-pass scan with decoupled look-back
//      over tiles of `kTileMbs` macroblocks in raster order over the
//      chunk.  A block takes its tile from an atomic counter (so every
//      tile it waits on has started), its warps walk the tile's
//      macroblocks once each, each lane staging its piece in shared
//      memory, and move each macroblock's bits into a per-warp stage; one
//      warp then scans the tile's (bits, first coded MB, last coded MB),
//      which combine associatively by adding the ue(v) of the mb_skip_run
//      between two coded MBs and restart at every slice's first MB,
//      publishes the tile's aggregate, reads its predecessors' and
//      publishes its inclusive prefix.  The block then lays the tile's
//      bits out as the words they fall in and writes them with plain
//      stores, atomics only on the first and last word of each run of
//      them, which a neighbour may share.  A macroblock with a code wider
//      than its length (the level escape past 4,095 at QP 0, which packs
//      into the bits above its own by addition) or more bits than its
//      stage has room for takes a second, direct path: after the stores
//      it walks again, adding each code into its words with atomics.
// No slot grid is written, and the host reads nothing between passes.
//
// Bound: bytes (the MB dict's coefficients, modes and motion read once,
// the words and counts written once; PERF.md, KV's row).
//
// Exactness: every code goes into its word as `pack_slices` puts it, as
// the top `min(len, 32 - off)` bits of its value shifted to its offset
// and the rest into the next word, combined by addition modulo 2^32 (the
// plain version's scatter-add).  Staged codes are exact in their lengths,
// so their bits are disjoint and an OR is that sum; the direct path adds.
// Words at or past `cap` are dropped; the bit counts keep every bit.
// Slices are equal runs of whole macroblock rows, so a left neighbour is
// missing only in column 0 and a top one in a slice's first row; each
// picture of a chunk starts a slice.  A slice's trailing skipped MBs add
// no bits (the host appends their run from the skip map).

#include <cstdint>
#include <cuda_runtime.h>

#include "mb_preds.cuh"

namespace {

using mb_preds::Cell;
using mb_preds::kNbCells;
using mb_preds::SL_B;
using mb_preds::SL_I;
using mb_preds::SL_P;
using mb_preds::zz_of;

constexpr int kMaxSlices = 256;
constexpr int kStateWords = 8;
constexpr int kStateWarps = 8;        // MBs (warps) a block of the state pass
constexpr int kWarps = 32;            // warps a block of the slices pass
constexpr int kTileMbs = 32;          // MBs a tile: a lane each of its scan
constexpr int kMbsPerWarp = kTileMbs / kWarps;
constexpr int kLaneWords = 8;         // a lane's staged piece: 256 bits
constexpr int kStageWords = 80;       // a warp's staged MBs
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

struct Params {
  int wm, hm, kind, t8_mode, parts, p8x8, n_slices;
  int rows[kMaxSlices + 1];           // slice start rows, then hm
  int rh;                             // MB rows a slice
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
  int32_t* lane_off;                  // [n, 32]: a direct MB's pieces
  unsigned long long* tiles;          // [n_tiles, 2] look-back slots, then
                                      // the tile counter
  uint32_t* words;                    // [pics * n_slices, cap]
  int64_t* nbits;                     // [pics * n_slices]
  uint8_t* skipped;                   // [n] bool (P, B); null in I
};

__device__ __forceinline__ int bitlen_m1(unsigned v) {   // v >= 1
  return 31 - __clz((int)v);
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// ue(v)'s length for mb_skip_run `run`
__device__ __forceinline__ int ue_len(int run) {
  return 2 * bitlen_m1((unsigned)run + 1u) + 1;
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
// Lanes 2-13 fetch the neighbours' motion cells of both lists, then lanes
// 0 and 1 derive list 0's and list 1's mvds and lanes 16-31 the most
// probable modes of blocks 0-15 (`mb_preds::derive_warp`).  State: word
// 0-3: the masked TotalCoeff of luma block 4 w + k in byte k of word w;
// words 4-5: chroma AC block 4 comp + k likewise; word 6: cbp_luma |
// cbp_chroma << 4 | skipped << 8.
__global__ void __launch_bounds__(kStateWarps * 32)
    kv_state_kernel(Io io, Params P) {
  __shared__ MbShared mb_s[kStateWarps];
  __shared__ Cell cell_s[kStateWarps][2][kNbCells];
  const int n = P.wm * P.hm * P.pics;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const long long n_words =
      (long long)P.pics * P.n_slices * (long long)P.cap;
  for (long long k = tid; k < n_words; k += threads) io.words[k] = 0u;
  const long long n_slots = 2LL * ((n + kTileMbs - 1) / kTileMbs + 1);
  for (long long k = tid; k < n_slots; k += threads) io.tiles[k] = 0ull;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kStateWarps + warp;
  if (m >= n) return;                 // whole warps: no block barrier
  const bool top_ok = (m / P.wm % P.hm) % P.rh != 0;
  int d[4][2], pm;
  mb_preds::derive_warp(io, P, m, top_ok, io.tables + T_BLK, cell_s[warp],
                        lane, d, &pm);
  if (lane < 2 && P.kind != SL_I) {
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

// A lane's piece staged in shared memory, its first bit the top bit of
// `buf[0]`: the codes shift into a 64-bit register, and each 32 bits are
// stored as they fill.  `bad`: a code wider than its length, which packs
// into the bits above its own by addition and so cannot be moved by
// shifting (`put_checked`: only the level escapes' values are not bounded
// by their lengths), a code longer than 32 bits, or a piece longer than
// the buffer; `pos` counts every bit.
struct Stage {
  uint32_t* buf;
  int pos;
  uint64_t acc;                       // the bits not yet stored, lowest
  bool bad;
  __device__ void store(uint32_t v, int w) {
    if (w < kLaneWords)
      buf[w] = v;
    else
      bad = true;
  }
  __device__ void put(uint32_t v, int len) {
    if (len <= 0) return;
    if (len > 32) {
      bad = true;
      pos += len;
      return;
    }
    const int pending = (pos & 31) + len;
    acc = (acc << len) | v;
    pos += len;
    if (pending >= 32) store((uint32_t)(acc >> (pending - 32)), (pos >> 5) - 1);
  }
  __device__ void put_checked(uint32_t v, int len) {
    if (len < 32 && (v >> len) != 0) bad = true;
    put(v, len);
  }
  __device__ void finish() {
    if (pos & 31) store((uint32_t)(acc << (32 - (pos & 31))), pos >> 5);
  }
};

// codes into a slice's row of words as `pack_slices` packs them: each
// code's hi and lo parts added to their words, the sums of a word kept
// in a register until the lane moves on to the next word (the direct
// path)
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
  __device__ void put_checked(uint32_t v, int len) { put(v, len); }
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
      s.put_checked((1u << 12) | (uint32_t)(lc - 30), 28);
    return;
  }
  const int prefix = lc >> sl;
  if (prefix < 15)
    s.put((1u << sl) | (uint32_t)(lc & ((1 << sl) - 1)), prefix + 1 + sl);
  else
    s.put_checked((1u << 12) | (uint32_t)(lc - (15 << sl)), 28);
}

__device__ __forceinline__ int top_bit(unsigned m) {   // m != 0
  return 31 - __clz((int)m);
}

// one residual block (`encode_blocks`): `mc` scan-order coefficients at
// p[0..mc) whose nonzero ones are the bits of `nz`, its nC (-1: chroma
// DC); the coefficients are taken from the last nonzero one down by the
// mask's highest bits
template <class S>
__device__ void residual(S& s, const int32_t* p, unsigned nz, int mc, int nc,
                         const int32_t* tab) {
  const int tc = __popc(nz);
  int t1 = 0;
  unsigned rest = nz;                 // the levels after the trailing ones
  while (t1 < 3 && rest) {
    const int i = top_bit(rest);
    if (iabs(p[i]) != 1) break;
    ++t1;
    rest &= ~(1u << i);
  }
  // coeff_token
  const int ct = 4 * tc + t1;
  if (nc == -1) {
    put_tab(s, tab[T_CCT + min(ct, 19)]);
  } else {
    const int tsel = nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3));
    put_tab(s, tab[T_CT + tsel * 68 + ct]);
  }
  // trailing ones' signs
  unsigned ones = nz;
  for (int k = 0; k < t1; ++k) {
    const int i = top_bit(ones);
    s.put(p[i] < 0, 1);
    ones &= ~(1u << i);
  }
  // levels
  int sl = (tc > 10 && t1 < 3) ? 1 : 0;
  for (int k = t1; k < tc; ++k) {
    const int i = top_bit(rest);
    rest &= ~(1u << i);
    const int v = p[i], a = iabs(v);
    int lc = v > 0 ? 2 * a - 2 : 2 * a - 1;
    if (k == t1 && t1 < 3) lc -= 2;
    put_level(s, lc, sl);
    if (sl == 0) sl = 1;
    if (a > (3 << (sl - 1)) && sl < 6) ++sl;
  }
  if (tc == 0) return;
  // total_zeros
  int prev = top_bit(nz);
  const int tz = prev + 1 - tc;
  if (tc < mc) {
    if (mc == 4)
      put_tab(s, tab[T_CTZ + min(tc - 1, 2) * 4 + min(max(tz, 0), 3)]);
    else
      put_tab(s, tab[T_TZ + (tc - 1) * 16 + min(max(tz, 0), 15)]);
  }
  // run_before
  int zl = tz;
  unsigned below = nz & ~(1u << prev);
  for (int k = 0; k < tc - 1 && k + 1 < mc && zl > 0; ++k) {
    const int cur = top_bit(below);
    below &= ~(1u << cur);
    const int run = prev - cur - 1;
    const int row = min(max(min(zl, 7) - 1, 0), 6);
    put_tab(s, tab[T_RB + row * 16 + min(max(run, 0), 15)]);
    zl -= run;
    prev = cur;
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
  const unsigned* mask;               // their nonzero masks
};

// the header's four pieces (`serialize_frame`, `_p`, `_b`), in bit order:
// part 0 mb_type (and a P_8x8 MB's sub_mb_types) and an I_NxN MB's
// transform_size_8x8_flag; part 1 the 16 intra modes; part 2
// intra_chroma_pred_mode and the mvds; part 3 coded_block_pattern, an
// inter MB's transform_size_8x8_flag and mb_qp_delta
template <class S>
__device__ void walk_header(S& s, const Io& io, const Params& P,
                            const int32_t* tab, const MbCtx& x, int part) {
  const Mb& b = x.b;
  const int m = x.m;
  if (!b.coded) return;
  if (part == 0) {
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
    if (P.t8_mode && b.is_i4) s.put(0u, 1);   // transform_size_8x8_flag
  } else if (part == 1) {
    if (!b.is_i4) return;
    const int32_t* modes = io.modes + (size_t)m * 16;
    const int32_t* mpm = io.mpm + (size_t)m * 16;
    for (int k = 0; k < 16; ++k) {
      const int md = modes[k], pm = mpm[k];
      if (md == pm)
        s.put(1u, 1);
      else
        s.put((uint32_t)(md - (md > pm)), 4);
    }
  } else if (part == 2) {
    if (!b.is_inter) put_ue(s, io.cmode[m]);
    // mvds: P list 0's part 0 (q0), part 1 (q1), q2, q3; B per list its
    // explicit part 0 and part 1
    const int32_t* d = io.mvds + (size_t)m * 16;
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
  } else {
    // coded_block_pattern, the inter MB's 8x8 flag, mb_qp_delta (se(0))
    if (b.is_inter)
      put_ue(s, tab[T_CBPP + b.cbp]);
    else if (b.is_i4)
      put_ue(s, tab[T_CBPI + b.cbp]);
    if (P.t8_mode && P.kind != SL_I && b.is_inter && b.cbp_luma > 0)
      s.put(P.kind == SL_P && io.t8[m] ? 1u : 0u, 1);
    if (b.sel16 || b.cbp > 0) s.put(1u, 1);
  }
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

// the piece of lane `lane` of a macroblock's warp: 0, 28, 29, 30 the
// header's parts; 1 the I16x16 luma DC; 2-17 the 16 luma blocks; 18-19
// chroma DC; 20-27 chroma AC (`_residual_slots`); an uncoded block has
// none, and lane 31 none
template <class S>
__device__ void walk_lane(S& s, const Io& io, const Params& P,
                          const int32_t* tab, const MbCtx& x, int lane) {
  const Mb& b = x.b;
  if (lane == 0 || lane >= 28) {
    if (lane < 31) walk_header(s, io, P, tab, x, lane == 0 ? 0 : lane - 27);
  } else if (lane == 1) {
    if (b.sel16)
      residual(s, x.sh + C_LDC, x.mask[12] & 0xffffu, 16,
               nc_of(x, 0, false, 0, tab), tab);
  } else if (lane < 18) {
    const int k = lane - 2;
    const unsigned nz = luma_mask(x.mask, k);
    if ((b.cbp_luma >> (k >> 2)) & 1)
      residual(s, x.sh + C_LAC + 16 * k + (b.sel16 ? 1 : 0),
               b.sel16 ? nz >> 1 : nz, b.sel16 ? 15 : 16,
               nc_of(x, k, false, 0, tab), tab);
  } else if (lane < 20) {
    const int comp = lane - 18;
    if (b.cbp_chroma >= 1)
      residual(s, x.sh + C_CDC + 4 * comp,
               (x.mask[12] >> (16 + 4 * comp)) & 0xfu, 4, -1, tab);
  } else {
    const int j = lane - 20;
    if (b.cbp_chroma == 2)
      residual(s, x.sh + C_CAC + 16 * j + 1, cac_mask(x.mask, j) >> 1, 15,
               nc_of(x, j & 3, true, j >> 2, tab), tab);
  }
}

// a lane's piece in bit order: the header's parts (lanes 0, 28, 29, 30),
// lane 31 (empty), then lanes 1-27
__device__ __forceinline__ int rank_of(int lane) {
  return lane == 0 ? 0 : (lane >= 28 ? lane - 27 : lane + 4);
}
__device__ __forceinline__ int lane_of(int rank) {
  return rank == 0 ? 0 : (rank <= 4 ? rank + 27 : rank - 4);
}

// the warp's exclusive scan of the pieces' lengths in bit order -> this
// lane's offset in its MB and the MB's bits
__device__ void place(int len, int lane, int& off, int& total) {
  const int v = __shfl_sync(kFull, len, lane_of(lane));
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  total = __shfl_sync(kFull, incl, 31);
  off = __shfl_sync(kFull, incl - v, rank_of(lane));
}

// the warp of MB m loads its coefficients and finds its neighbours' state
// -> what every lane walks from
__device__ MbCtx mb_ctx(const Io& io, const Params& P, int m, MbShared& sh,
                        int lane) {
  load_mb(io, m, sh, lane);
  MbCtx x;
  x.m = m;
  const int loc = m % (P.wm * P.hm);
  const int r = loc / P.wm, c = loc % P.wm;
  x.av_l = c > 0;
  x.av_t = r % P.rh != 0;
  // an unavailable neighbour's state is never read; point at our own
  x.own = io.state + (size_t)m * kStateWords;
  x.l = x.av_l ? x.own - kStateWords : x.own;
  x.t = x.av_t ? x.own - (size_t)P.wm * kStateWords : x.own;
  const int w6 = x.own[6];
  x.b = mb_flags(io, P, m, w6 & 15, (w6 >> 4) & 3);
  x.sh = sh.coef;
  x.mask = sh.mask;
  return x;
}

// ---- the scan over tiles ----

// what a run of MBs of one slice adds to it: its bits without the
// mb_skip_run of its first coded MB `f` (whose run depends on the MBs
// before), up to its last coded MB `l`.  `reset`: the run holds a slice's
// first MB and counts from there (as if the MB before that first one were
// coded), so it is whole and ignores what came before; `coded`: it holds
// a coded MB or a slice start (else it is the identity)
struct Agg {
  long long B;
  int f, l;
  bool reset, coded;
};

__device__ __forceinline__ Agg agg_none() { return {0, -1, -1, false, false}; }

// x then y; `runs`: P and B slices, whose coded MBs carry mb_skip_run
__device__ __forceinline__ Agg combine(const Agg& x, const Agg& y,
                                       bool runs) {
  if (y.reset || !x.coded) return y;
  if (!y.coded) return x;
  return {x.B + y.B + (runs ? ue_len(y.f - x.l - 1) : 0), x.f, y.l, x.reset,
          true};
}

__device__ Agg shfl_agg(const Agg& a, int src) {
  Agg r;
  r.B = __shfl_sync(kFull, a.B, src);
  r.f = __shfl_sync(kFull, a.f, src);
  r.l = __shfl_sync(kFull, a.l, src);
  const int fl = __shfl_sync(kFull, (int)a.reset | ((int)a.coded << 1), src);
  r.reset = fl & 1;
  r.coded = (fl >> 1) & 1;
  return r;
}

__device__ Agg shfl_up_agg(const Agg& a, int d) {
  Agg r;
  r.B = __shfl_up_sync(kFull, a.B, d);
  r.f = __shfl_up_sync(kFull, a.f, d);
  r.l = __shfl_up_sync(kFull, a.l, d);
  const int fl = __shfl_up_sync(kFull, (int)a.reset | ((int)a.coded << 1), d);
  r.reset = fl & 1;
  r.coded = (fl >> 1) & 1;
  return r;
}

__device__ Agg shfl_down_agg(const Agg& a, int d) {
  Agg r;
  r.B = __shfl_down_sync(kFull, a.B, d);
  r.f = __shfl_down_sync(kFull, a.f, d);
  r.l = __shfl_down_sync(kFull, a.l, d);
  const int fl =
      __shfl_down_sync(kFull, (int)a.reset | ((int)a.coded << 1), d);
  r.reset = fl & 1;
  r.coded = (fl >> 1) & 1;
  return r;
}

// a tile's look-back slot, status and value in one 16-byte store after a
// fence: word 0 B << 8 | coded << 2 | reset << 1 | 1 (ready), word 1 l
// << 32 | f.  A slot is written twice, the aggregate and then the
// inclusive prefix; a reader takes either, and needs nothing else that
// the writer wrote, so it reads with no fence of its own.
__device__ void publish(unsigned long long* slot, const Agg& a) {
  const unsigned long long w0 = ((unsigned long long)a.B << 8) |
                                ((unsigned long long)a.coded << 2) |
                                ((unsigned long long)a.reset << 1) | 1ull;
  const unsigned long long w1 = (unsigned long long)(unsigned)a.f |
                                ((unsigned long long)(unsigned)a.l << 32);
  __threadfence();
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(slot),
               "l"(w0), "l"(w1)
               : "memory");
}

__device__ Agg wait_for(const unsigned long long* slot) {
  unsigned long long w0, w1;
  do {
    asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(w0), "=l"(w1)
                 : "l"(slot)
                 : "memory");
  } while (!(w0 & 1));
  Agg a;
  a.B = (long long)(w0 >> 8);
  a.coded = (w0 >> 2) & 1;
  a.reset = (w0 >> 1) & 1;
  a.f = (int)(unsigned)w1;
  a.l = (int)(unsigned)(w1 >> 32);
  return a;
}

// a tile's MB i
struct MbInfo {
  long long before;                   // its first bit (its run's) in its slice
  int bits;                           // its bits without the run
  int ue, run;                        // its run's ue(v) length (0: none)
  int stage;                          // its first word in its warp's stage;
                                      // -1 direct, -2 no bits
  int out;                            // the bit of `before` in `out`
};

// a run of the tile's staged MBs in one slice, laid out as its words
struct Piece {
  long long gw0;                      // its first word in the slice's row
  int base, count, g;                 // in `out`; words; the slice's row
};

struct WalkShared {
  uint32_t lane[kWarps][32][kLaneWords];
  MbShared mb[kWarps];
};
constexpr int kOutWords = (int)(sizeof(WalkShared) / 4);
// a tile's words: its staged bits, the runs' ue(v) (at most 64 bits an MB)
// and two partial words a piece
static_assert(kOutWords >= kWarps * kStageWords + 4 * kTileMbs,
              "the tile's words must fit where the walk was staged");

struct TileShared {
  int32_t tab[kTableWords];
  union {
    WalkShared walk;                  // while the warps walk
    uint32_t out[kOutWords];          // then the tile's words
  } u;
  uint32_t stage[kWarps][kStageWords];
  MbInfo info[kTileMbs];
  Piece piece[kTileMbs];
  int tile, n_pieces, out_words;
};

// a code exact in its length OR-ed into `out` at bit `pos` (the leading
// zeros of a ue(v) longer than 32 bits skipped)
__device__ void or_code(uint32_t* out, int pos, uint32_t v, int len) {
  if (len > 32) {
    pos += len - 32;
    len = 32;
  }
  const int off = pos & 31, w = pos >> 5;
  const int take = min(len, 32 - off), rem = len - take;
  atomicOr(out + w, (uint32_t)((((uint64_t)v >> rem) << (32 - off - take)) &
                               0xffffffffull));
  if (rem > 0) atomicOr(out + w + 1, (v & ((1u << rem) - 1)) << (32 - rem));
}

// words `first`, `first + step`, ... of the `n` words of bits at `src`
// OR-ed into `dst` at bit `at`
__device__ void or_words(uint32_t* dst, int at, const uint32_t* src, int n,
                         int first, int step) {
  const int s = at & 31, base = at >> 5;
  for (int w = first; w < n; w += step) {
    const uint32_t v = src[w];
    atomicOr(dst + base + w, v >> s);
    if (s && (v << (32 - s))) atomicOr(dst + base + w + 1, v << (32 - s));
  }
}

// warp 0: the tile's scan, its look-back and its layout
__device__ void tile_scan(const Io& io, const Params& P, TileShared& S,
                          int tile, int lane) {
  const int n1 = P.wm * P.hm, n = n1 * P.pics;
  const int slice_mbs = P.rh * P.wm;
  const bool runs = P.kind != SL_I;
  const int m = tile * kTileMbs + lane;
  const bool exists = m < n;
  const int loc = m % n1;
  const bool start = exists && loc % slice_mbs == 0;
  const bool last = exists && (loc + 1) % slice_mbs == 0;
  const int g = exists ? m / n1 * P.n_slices + loc / slice_mbs : 0;
  const int bits = S.info[lane].bits, stage = S.info[lane].stage;
  const bool coded = exists && stage != -2;
  Agg e = agg_none();
  if (start)
    e = {coded ? (runs ? 1 : 0) + bits : 0, m, coded ? m : m - 1, true, true};
  else if (coded)
    e = {bits, m, m, false, true};
  Agg incl = e;                       // the warp's inclusive scan
  for (int d = 1; d < 32; d <<= 1) {
    const Agg y = shfl_up_agg(incl, d);
    if (lane >= d) incl = combine(y, incl, runs);
  }
  const Agg tile_agg = shfl_agg(incl, 31);
  unsigned long long* slot = io.tiles + 2 * tile;
  if (lane == 0) publish(slot, tile_agg);
  // the prefix before the tile (unless its first MB starts a slice): the
  // warp reads 32 predecessors' slots at a time, newest on lane 0, and
  // combines those up to the nearest whole one (a slice start's or an
  // inclusive prefix), oldest first
  Agg before_tile = agg_none();
  if (!__shfl_sync(kFull, start, 0)) {
    for (int base = tile - 1;; base -= 32) {
      const int j = base - lane;
      Agg a = j >= 0 ? wait_for(io.tiles + 2 * j) : agg_none();
      const unsigned whole = __ballot_sync(kFull, j >= 0 && a.reset);
      const int stop = whole ? __ffs(whole) - 1 : 32;
      if (lane > stop) a = agg_none();
      for (int d = 1; d < 32; d <<= 1) {
        const Agg y = shfl_down_agg(a, d);
        if (lane + d < 32) a = combine(y, a, runs);
      }
      before_tile = combine(shfl_agg(a, 0), before_tile, runs);
      if (whole) break;
    }
    if (lane == 0 && !tile_agg.reset)
      publish(slot, combine(before_tile, tile_agg, runs));
  }
  Agg ex = shfl_up_agg(incl, 1);
  if (lane == 0) ex = agg_none();
  const Agg x = combine(before_tile, ex, runs);
  const long long before = start ? 0 : x.B;
  const int run = m - (start ? m - 1 : x.l) - 1;
  const int ue = coded && runs ? ue_len(run) : 0;
  const long long after = coded ? before + ue + bits : before;
  if (last) io.nbits[g] = after;
  // pieces: runs of staged MBs in one slice
  const bool direct = stage == -1;
  const bool d_prev = __shfl_up_sync(kFull, direct, 1) && lane > 0;
  const bool d_next = __shfl_down_sync(kFull, direct, 1) && lane < 31;
  const bool p_start = !direct && (lane == 0 || start || d_prev);
  const unsigned starts = __ballot_sync(kFull, p_start);
  const bool s_next = ((starts >> 1) >> lane) & 1;
  const bool p_last = !direct && (lane == 31 || s_next || d_next);
  const unsigned upto = starts & (kFull >> (31 - lane));
  const int first = upto ? 31 - __clz((int)upto) : lane;
  const long long p_begin = __shfl_sync(kFull, before, first);
  const int p_g = __shfl_sync(kFull, g, first);
  int count = 0;
  if (p_last && after > p_begin)
    count = (int)(((after - 1) >> 5) - (p_begin >> 5) + 1);
  int c_incl = count;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, c_incl, d);
    if (lane >= d) c_incl += y;
  }
  const int base = c_incl - count;    // the words of the pieces before
  MbInfo& inf = S.info[lane];
  inf.before = before;
  inf.ue = ue;
  inf.run = run;
  inf.out = direct ? 0 : base * 32 + (int)(before - (p_begin >> 5) * 32);
  if (p_last) S.piece[__popc(upto) - 1] = {p_begin >> 5, base, count, p_g};
  if (lane == 31) {
    S.n_pieces = __popc(starts);
    S.out_words = c_incl;
  }
}

// ---- (b) the slices pass ----
// A block a tile, a warp a MB; the tile's shared memory is dynamic (more
// than the 48 KB of a static allocation).  Two blocks an SM: one tile's
// walk hides the other's scan, look-back and stores, worth the few
// registers spilled to fit.
__global__ void __launch_bounds__(kWarps * 32, 2)
    kv_slices_kernel(Io io, Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  TileShared& S = *reinterpret_cast<TileShared*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = P.wm * P.hm * P.pics;
  const int n_tiles = (n + kTileMbs - 1) / kTileMbs;
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    S.tab[i] = io.tables[i];
  if (threadIdx.x == 0)
    S.tile = (int)atomicAdd((unsigned*)(io.tiles + 2 * n_tiles), 1u);
  __syncthreads();
  const int tile = S.tile;
  const int32_t* tab = S.tab;
  // 1. each warp walks its MBs once, a lane a piece into its buffer,
  // then moves the MB's bits into the warp's stage
  int used = 0;
  for (int k = 0; k < kMbsPerWarp; ++k) {
    const int i = warp * kMbsPerWarp + k;
    const int m = tile * kTileMbs + i;
    MbInfo& inf = S.info[i];
    if (m >= n || ((io.state[(size_t)m * kStateWords + 6] >> 8) & 1)) {
      if (lane == 0) {
        inf.bits = 0;
        inf.stage = -2;
      }
      continue;
    }
    __syncwarp();
    const MbCtx x = mb_ctx(io, P, m, S.u.walk.mb[warp], lane);
    Stage sk{S.u.walk.lane[warp][lane], 0, 0ull, false};
    walk_lane(sk, io, P, tab, x, lane);
    sk.finish();
    int off, total;
    place(sk.pos, lane, off, total);
    const int need = (total + 31) >> 5;
    if (!__any_sync(kFull, sk.bad) && used + need <= kStageWords) {
      uint32_t* st = S.stage[warp] + used;
      for (int w = lane; w < need; w += 32) st[w] = 0u;
      __syncwarp();
      or_words(st, off, sk.buf, (sk.pos + 31) >> 5, 0, 1);
      if (lane == 0) inf.stage = used;
      used += need;
    } else {
      io.lane_off[(size_t)m * 32 + lane] = off;
      if (lane == 0) inf.stage = -1;
    }
    if (lane == 0) inf.bits = total;
  }
  __syncthreads();
  // 2. the tile's scan and look-back
  if (warp == 0) tile_scan(io, P, S, tile, lane);
  __syncthreads();
  // 3. the tile's words: each staged MB's run and bits at their place
  for (int w = threadIdx.x; w < S.out_words; w += blockDim.x)
    S.u.out[w] = 0u;
  __syncthreads();
  for (int k = 0; k < kMbsPerWarp; ++k) {
    const MbInfo inf = S.info[warp * kMbsPerWarp + k];
    if (inf.stage < 0) continue;
    if (lane == 0 && inf.ue > 0)
      or_code(S.u.out, inf.out, (uint32_t)inf.run + 1u, inf.ue);
    or_words(S.u.out, inf.out + inf.ue, S.stage[warp] + inf.stage,
             (inf.bits + 31) >> 5, lane, 32);
  }
  __syncthreads();
  // 4. the words into the slices' rows: plain stores inside a piece, adds
  // on its first and last word, which a neighbour may share
  for (int p = 0; p < S.n_pieces; ++p) {
    const Piece pc = S.piece[p];
    uint32_t* row = io.words + (size_t)pc.g * P.cap;
    for (int k = threadIdx.x; k < pc.count; k += blockDim.x) {
      const long long gw = pc.gw0 + k;
      if (gw >= P.cap) break;
      const uint32_t v = S.u.out[pc.base + k];
      if (k == 0 || k == pc.count - 1) {
        if (v) atomicAdd(row + gw, v);
      } else {
        row[gw] = v;
      }
    }
  }
  __syncthreads();
  // 5. the direct MBs: walk again, adding each code into its words
  for (int k = 0; k < kMbsPerWarp; ++k) {
    const int i = warp * kMbsPerWarp + k;
    const MbInfo inf = S.info[i];
    if (inf.stage != -1) continue;
    const int m = tile * kTileMbs + i;
    __syncwarp();
    const MbCtx x = mb_ctx(io, P, m, S.u.walk.mb[warp], lane);
    const int n1 = P.wm * P.hm;
    const int g = m / n1 * P.n_slices + m % n1 / (P.rh * P.wm);
    Writer w{io.words + (size_t)g * P.cap, P.cap, inf.before, -1, 0u};
    if (inf.ue > 0) {
      if (lane == 0)
        put_ue(w, inf.run);
      else
        w.pos += inf.ue;
    }
    w.pos += io.lane_off[(size_t)m * 32 + lane];
    walk_lane(w, io, P, tab, x, lane);
    w.flush();
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
      p.kind > SL_B || p.wm < 1 || p.hm < 1 || p.hm % p.n_slices != 0)
    return (int)cudaErrorInvalidValue;
  p.rh = p.hm / p.n_slices;
  for (int s = 0; s <= p.n_slices; ++s) {
    p.rows[s] = q[s];
    if (p.rows[s] != s * p.rh) return (int)cudaErrorInvalidValue;
  }
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
  io.lane_off = (int32_t*)a[29];
  io.tiles = (unsigned long long*)a[30];
  io.words = (uint32_t*)a[31];
  io.nbits = (int64_t*)a[32];
  io.skipped = (uint8_t*)a[33];
  return 0;
}

}  // namespace

// `ptrs`: the 34 device pointers of `Io` in its order (a null pointer for
// an input the slice kind does not read; `mvds` (P, B), `mpm`, `state`,
// `lane_off`, `tiles` (16-byte aligned), `words`, `nbits` and, in P and B,
// `skipped` are written); `params`: the host int32 array of
// `kernels/mb_preds.py` `pack_params` (wm, hm, slice kind, t8 mode,
// partitions, P_8x8, n_slices, then the n_slices + 1 row bounds, equal
// slices); `pics` pictures of that layout one after the other in every
// input and output; `cap` words a slice's row.  Launches the state and
// the slices pass; nothing is read back.
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
      io.state == nullptr || io.lane_off == nullptr || io.tiles == nullptr ||
      ((uintptr_t)io.tiles & 15) != 0 || io.words == nullptr ||
      io.nbits == nullptr ||
      (p.kind != SL_I && (io.mvds == nullptr || io.skipped == nullptr)) ||
      (p.kind == SL_P && p.t8_mode && io.t8 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kv_slices_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(TileShared));
  if (attr != cudaSuccess) return (int)attr;
  kv_state_kernel<<<(int)((n + kStateWarps - 1) / kStateWarps),
                    kStateWarps * 32, 0, s>>>(io, p);
  kv_slices_kernel<<<(int)((n + kTileMbs - 1) / kTileMbs), kWarps * 32,
                     sizeof(TileShared), s>>>(io, p);
  return (int)cudaGetLastError();
}
