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
// Here a macroblock is one thread, and its records are what a walk of its
// syntax in the plain version's slot order emits (`walk_mb`, one routine
// for the count and the emit pass, templated on its sink, so the two
// cannot drift apart):
//  (a) `state_kernel`: what a neighbour reads of a macroblock (its kind,
//      coded_block_pattern, coded_block_flag bits, 8x8 flag, chroma
//      prediction bit and the |mvd| of its boundary 4x4 cells), one
//      record of `kStateWords` words a macroblock;
//  (b) `count_kernel`: the walk with a counting sink -> records a
//      macroblock;
//  (c) `scan_kernel`: one block, each slice's exclusive scan of those
//      counts -> each macroblock's offset in its slice, the slices'
//      counts and the largest;
//  (d) `emit_kernel`: the walk with a writing sink at those offsets
//      (kind << 30 | a << 14 | b, as `pack_records`), and zeros from each
//      slice's count to the row's end.
// No slot grid is written.  The host launches (a)-(c), reads the largest
// count, sizes the rows to hold it (at least the caller's cap) and then
// launches (d) (`tpu264_cabac_records`, `emit`).
//
// Exactness: the plain version's record of a macroblock is its valid
// slots in slot order, and the walk visits the syntax elements in that
// order with the same valid conditions (the row order of
// `binarize_frame`; inside a residual block the coded_block_flag, the
// significance / last pairs, then six rows a coefficient from the last
// one down).  Slices are whole macroblock rows, so a left neighbour is
// missing only in column 0 and a top one in a slice's first row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlices = 256;
constexpr int kStateWords = 16;
constexpr int kMbThreads = 32;        // threads (macroblocks) a block
constexpr int kScanThreads = 1024;

// the context tables, `kernels/cabac_records.py` `tables()`: the port's
// `entropy/cabac_ctx.py`, `coding/b_mbtypes.py` and `coding/wavefront.py`
constexpr int T_CBF = 0;              // CBF_CAT_OFF [5]
constexpr int T_SIG = 5;              // SIG_CAT_OFF [5]
constexpr int T_LVL = 10;             // LVL_CAT_OFF [6]
constexpr int T_SIG8 = 16;            // SIG8_MAP [63]
constexpr int T_LAST8 = 79;           // LAST8_MAP[:63]
constexpr int T_COMBO = 142;          // COMBO_IDX [9]
constexpr int T_BLK = 151;            // BLK_ORDER as by * 4 + bx [16]
constexpr int kTableWords = 167;

// macroblock kinds a neighbour reads (`cabac_ctx` K_*)
constexpr int K_SKIP = 0, K_INTER = 1, K_I4 = 2, K_I16 = 3, K_DIRECT = 4;
constexpr int SL_I = 0, SL_P = 1, SL_B = 2;

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
  const int32_t* mvds;                // [n, 2 lists, 4 parts, 2] (P, B)
  const int32_t* mpm;                 // [n, 16]
  const int32_t* tables;              // [kTableWords]
  int32_t* state;                     // [n, kStateWords]
  int32_t* mb_count;                  // [n]
  int32_t* mb_off;                    // [n]
  int32_t* counts;                    // [n_slices + 1]: counts, the largest
};

__device__ __forceinline__ int bitlen_m1(unsigned v) {   // v >= 1
  return 31 - __clz((int)v);
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// ---- the macroblock's own flags (the state pass and the walk) ----

struct Mb {
  bool is_inter, is_direct, sel16, coded, skipped, t8v;
  int cbp_luma, cbp_chroma, cbp, kind;
  int ptype;                          // P: ptype, B: bptype (0 without)
  bool partd;                         // B 16x8 / 8x16
  bool exp[2], exp_b[2];              // B: lists with an explicit mvd
  int btype;
};

__device__ bool any_nz(const int32_t* p, int n) {
  for (int i = 0; i < n; ++i)
    if (p[i] != 0) return true;
  return false;
}

// `st`: the MB's state record, whose coded_block_pattern is the whole one
// (a skipped MB has none); null in the state pass, which derives it
__device__ Mb mb_flags(const Io& io, const Params& P, int m,
                       const int32_t* st) {
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
  int cl, cc;
  if (st != nullptr) {
    cl = (st[0] >> 4) & 15;
    cc = (st[0] >> 8) & 3;
  } else {
    // coded_block_pattern (`compute_cbp`): every position of every block
    const int32_t* lac = io.luma_ac + (size_t)m * 256;
    cl = 0;
    for (int b8 = 0; b8 < 4; ++b8)
      if (any_nz(lac + b8 * 64, 64)) cl |= 1 << b8;
    if (b.sel16 && cl > 0) cl = 15;
    cc = any_nz(io.chroma_ac + (size_t)m * 128, 128) ? 2
         : any_nz(io.chroma_dc + (size_t)m * 8, 8)   ? 1
                                                     : 0;
  }
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

// |mvd| of the partitions of list `l`: a[part][comp], 0 where not coded
struct Amvd {
  int a[4][2];
  bool on[4];
};

__device__ Amvd mvd_abs(const Io& io, const Params& P, const Mb& b, int m,
                        int l) {
  Amvd r;
  const int32_t* d = io.mvds + (size_t)m * 16 + l * 8;
  if (P.kind == SL_P) {
    r.on[0] = b.coded && b.is_inter;
    r.on[1] = r.on[0] && b.ptype > 0;
    r.on[2] = r.on[3] = P.p8x8 && r.on[0] && b.ptype == 3;
  } else {
    r.on[0] = b.coded && b.exp[l];
    r.on[1] = b.coded && b.exp_b[l] && b.partd;
    r.on[2] = r.on[3] = false;
  }
  for (int q = 0; q < 4; ++q)
    for (int c = 0; c < 2; ++c) r.a[q][c] = r.on[q] ? iabs(d[2 * q + c]) : 0;
  return r;
}

// the boundary cells tr, bl, br of a list: the partition covering each
__device__ void cells(const Params& P, const Mb& b, const Amvd& a,
                      int out[3][2]) {
  const int pt = b.ptype;
  for (int c = 0; c < 2; ++c) {
    if (P.kind == SL_P) {
      out[0][c] = (pt == 2 || pt == 3) ? a.a[1][c] : a.a[0][c];
      out[1][c] = pt == 1 ? a.a[1][c] : a.a[0][c];
      out[2][c] = pt > 0 ? a.a[1][c] : a.a[0][c];
      if (P.p8x8 && pt == 3) {
        out[1][c] = a.a[2][c];
        out[2][c] = a.a[3][c];
      }
    } else {
      out[0][c] = pt == 2 ? a.a[1][c] : a.a[0][c];
      out[1][c] = pt == 1 ? a.a[1][c] : a.a[0][c];
      out[2][c] = pt > 0 ? a.a[1][c] : a.a[0][c];
    }
  }
}

// ---- (a) the state pass ----
// word 0: kind | t8v << 3 | cbp_luma << 4 | cbp_chroma << 8 | chroma
//   pred bit << 10 | luma DC cbf << 11 | chroma DC
//   cbf << 12 + comp | chroma AC cbf << 14 + 4 comp + idx;
// word 1: the 16 luma 4x4 cbf bits by position by * 4 + bx;
// words 2 + 6 l + 2 cell + comp: |mvd| of list l's cell (tr, bl, br),
//   at most 255 (its contexts only ask < 3 and <= 32 of a sum).
__global__ void state_kernel(Io io, Params P) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = P.wm * P.hm;
  if (m >= n) return;
  const Mb b = mb_flags(io, P, m, nullptr);
  const int32_t* lac = io.luma_ac + (size_t)m * 256;
  // a skipped MB's cbp is 0: the neighbours' (0 where not coded) and the
  // whole one are the same
  int w0 = b.kind | (b.t8v << 3) | (b.cbp_luma << 4) | (b.cbp_chroma << 8);
  if (!b.is_inter && io.cmode[m] != 0) w0 |= 1 << 10;
  if (b.sel16 && b.coded && any_nz(io.luma_dc + (size_t)m * 16, 16))
    w0 |= 1 << 11;
  for (int comp = 0; comp < 2; ++comp) {
    if (any_nz(io.chroma_dc + (size_t)m * 8 + comp * 4, 4) &&
        b.cbp_chroma >= 1 && b.coded)
      w0 |= 1 << (12 + comp);
    for (int idx = 0; idx < 4; ++idx)
      if (b.cbp_chroma == 2 && b.coded &&
          any_nz(io.chroma_ac + (size_t)m * 128 + (comp * 4 + idx) * 16 + 1,
                 15))
        w0 |= 1 << (14 + 4 * comp + idx);
  }
  int w1 = 0;
  for (int idx = 0; idx < 16; ++idx) {
    const bool bit8 = (b.cbp_luma >> (idx / 4)) & 1;
    bool l4 = b.sel16 ? any_nz(lac + idx * 16 + 1, 15) && b.cbp_luma > 0
                      : any_nz(lac + idx * 16, 16) && bit8;
    l4 = l4 && b.coded;
    if (b.t8v) l4 = bit8;
    if (l4) w1 |= 1 << io.tables[T_BLK + idx];
  }
  int32_t* st = io.state + (size_t)m * kStateWords;
  st[0] = w0;
  st[1] = w1;
  for (int l = 0; l < 2; ++l) {
    int c[3][2] = {{0, 0}, {0, 0}, {0, 0}};
    if (P.kind != SL_I && (l == 0 || P.kind == SL_B))
      cells(P, b, mvd_abs(io, P, b, m, l), c);
    for (int k = 0; k < 3; ++k)
      for (int comp = 0; comp < 2; ++comp)
        st[2 + 6 * l + 2 * k + comp] = min(c[k][comp], 255);
  }
  for (int w = 14; w < kStateWords; ++w) st[w] = 0;
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

// a 4x4-style block of `mc` coefficients at p[0..mc) (`_residual_group`)
template <class S>
__device__ void residual(Emit<S>& e, const int32_t* p, int mc, int sig,
                         int last_b, int lvl, int cbf_ctx, bool coded,
                         bool cdc_inc) {
  uint64_t nz = 0;
  if (coded)
    for (int i = 0; i < mc; ++i)
      if (p[i] != 0) nz |= 1ull << i;
  e.ctx(cbf_ctx, nz != 0, coded);
  if (!coded || nz == 0) return;
  const int last = 63 - __clzll((long long)nz);
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
__device__ void residual8(Emit<S>& e, const int32_t* lac, int b8, bool on,
                          const int32_t* tab) {
  if (!on) return;
  const int32_t* base = lac + b8 * 64;
  auto get = [base](int q) { return base[(q & 3) * 16 + (q >> 2)]; };
  uint64_t nz = 0;
  for (int q = 0; q < 64; ++q)
    if (get(q) != 0) nz |= 1ull << q;
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

struct Nb {
  bool av_l, av_t;
  const int32_t* l;                   // left neighbour's state
  const int32_t* t;                   // top neighbour's state
};

__device__ __forceinline__ int kind_of(int w0) { return w0 & 7; }

// one macroblock's records in the plain version's slot order
template <class S>
__device__ void walk_mb(Emit<S>& e, const Io& io, const Params& P,
                        const int32_t* tab, int m, const Nb& nb,
                        bool last_of_slice) {
  const int32_t* own = io.state + (size_t)m * kStateWords;
  const Mb b = mb_flags(io, P, m, own);
  const int lw0 = nb.av_l ? nb.l[0] : 0, tw0 = nb.av_t ? nb.t[0] : 0;
  const int lk = nb.av_l ? kind_of(lw0) : -1;
  const int tk = nb.av_t ? kind_of(tw0) : -1;
  const bool is_i4 = !b.sel16 && !b.is_inter;
  const bool intra_coded = b.coded && !b.is_inter;
  const int t8_inc = (nb.av_l ? (lw0 >> 3) & 1 : 0) +
                     (nb.av_t ? (tw0 >> 3) & 1 : 0);

  // ---- mb_skip_flag ----
  if (P.kind != SL_I)
    e.ctx((P.kind == SL_B ? 24 : 11) + (nb.av_l && lk != K_SKIP) +
              (nb.av_t && tk != K_SKIP),
          b.skipped, true);

  // ---- mb_type ----
  int first_ctx, rest[5];
  if (P.kind == SL_B) {
    const bool explicit_ = b.coded && !b.is_direct;
    const int nd = (nb.av_l && lk != K_SKIP && lk != K_DIRECT) +
                   (nb.av_t && tk != K_SKIP && tk != K_DIRECT);
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
  e.ctx(64 + (nb.av_l ? (lw0 >> 10) & 1 : 0) + (nb.av_t ? (tw0 >> 10) & 1 : 0),
        cmode != 0, intra_coded);
  e.ctx(67, cmode > 1, intra_coded && cmode != 0);
  e.ctx(67, cmode == 3, intra_coded && cmode > 1);

  // ---- mvds: per list (B: 0 then 1), partition 0, 1, then P_8x8's q2
  // and q3; the contexts sum the |mvd| of the left and top 4x4 cells ----
  if (P.kind != SL_I) {
    for (int l = 0; l < (P.kind == SL_B ? 2 : 1); ++l) {
      const Amvd a = mvd_abs(io, P, b, m, l);
      const int32_t* d = io.mvds + (size_t)m * 16 + l * 8;
      const int* lc = nb.l + 2 + 6 * l;    // left cells tr, bl, br
      const int* tc = nb.t + 2 + 6 * l;
      int s[2];
      for (int c = 0; c < 2; ++c)
        s[c] = (nb.av_l ? lc[0 + c] : 0) + (nb.av_t ? tc[2 + c] : 0);
      mvd_rows(e, d, s, a.on[0]);
      for (int c = 0; c < 2; ++c)
        s[c] = b.ptype == 1 ? (nb.av_l ? lc[4 + c] : 0) + a.a[0][c]
                            : a.a[0][c] + (nb.av_t ? tc[4 + c] : 0);
      mvd_rows(e, d + 2, s, a.on[1]);
      if (P.kind == SL_P && P.p8x8) {
        for (int c = 0; c < 2; ++c)
          s[c] = (nb.av_l ? lc[4 + c] : 0) + a.a[0][c];
        mvd_rows(e, d + 4, s, a.on[2]);
        for (int c = 0; c < 2; ++c) s[c] = a.a[2][c] + a.a[1][c];
        mvd_rows(e, d + 6, s, a.on[3]);
      }
    }
  }

  // ---- coded_block_pattern ----
  const bool on_cbp = b.coded && !b.sel16;
  const int lcl = (lw0 >> 4) & 15, tcl = (tw0 >> 4) & 15;
  auto cond_l = [&](int bit) { return nb.av_l && !((lcl >> bit) & 1); };
  auto cond_t = [&](int bit) { return nb.av_t && !((tcl >> bit) & 1); };
  auto own_z = [&](int bit) { return (int)!((b.cbp >> bit) & 1); };
  e.ctx(73 + cond_l(1) + 2 * cond_t(2), b.cbp & 1, on_cbp);
  e.ctx(73 + own_z(0) + 2 * cond_t(3), (b.cbp >> 1) & 1, on_cbp);
  e.ctx(73 + cond_l(3) + 2 * own_z(0), (b.cbp >> 2) & 1, on_cbp);
  e.ctx(73 + own_z(2) + 2 * own_z(1), (b.cbp >> 3) & 1, on_cbp);
  const int cc = b.cbp >> 4;
  const int lcc = nb.av_l ? (lw0 >> 8) & 3 : 0;
  const int tcc = nb.av_t ? (tw0 >> 8) & 3 : 0;
  e.ctx(77 + (lcc != 0) + 2 * (tcc != 0), cc != 0, on_cbp);
  e.ctx(81 + (lcc == 2) + 2 * (tcc == 2), max(cc - 1, 0), on_cbp && cc != 0);

  // ---- transform_size_8x8_flag of an inter MB ----
  if (P.t8_mode)
    e.ctx(399 + t8_inc, b.t8v, b.coded && b.is_inter && b.cbp_luma > 0);

  // ---- mb_qp_delta (always 0 in this encoder) ----
  e.ctx(60, 0, b.coded && (b.sel16 || b.cbp > 0));

  // ---- residual blocks; an unavailable neighbour counts as coded for an
  // intra MB and as not coded for an inter one ----
  const int ic = !b.is_inter;
  const int32_t* lac = io.luma_ac + (size_t)m * 256;
  {  // I16 luma DC (cat 0)
    const int ca = nb.av_l ? (lk == K_I16 ? (lw0 >> 11) & 1 : 0) : 1;
    const int cb = nb.av_t ? (tk == K_I16 ? (tw0 >> 11) & 1 : 0) : 1;
    residual(e, io.luma_dc + (size_t)m * 16, 16, 105 + tab[T_SIG + 0],
             166 + tab[T_SIG + 0], 227 + tab[T_LVL + 0],
             85 + tab[T_CBF + 0] + ca + 2 * cb, b.coded && b.sel16, false);
  }
  {  // 16 luma blocks in coding order (a t8 MB's come in its 8x8 groups)
    const int cat = b.sel16 ? 1 : 2;
    const int w1 = own[1];
    const int lw1 = nb.av_l ? nb.l[1] : 0, tw1 = nb.av_t ? nb.t[1] : 0;
    for (int idx = 0; idx < 16; ++idx) {
      const int pos = tab[T_BLK + idx];
      const int by = pos >> 2, bx = pos & 3;
      const int ca = bx > 0 ? (w1 >> (pos - 1)) & 1
                     : nb.av_l ? (lw1 >> (by * 4 + 3)) & 1 : ic;
      const int cb = by > 0 ? (w1 >> (pos - 4)) & 1
                     : nb.av_t ? (tw1 >> (12 + bx)) & 1 : ic;
      const bool coded_blk =
          b.coded && !b.t8v &&
          ((b.sel16 && b.cbp_luma > 0) ||
           (!b.sel16 && ((b.cbp_luma >> (idx / 4)) & 1)));
      residual(e, lac + idx * 16 + (b.sel16 ? 1 : 0), b.sel16 ? 15 : 16,
               105 + tab[T_SIG + cat], 166 + tab[T_SIG + cat],
               227 + tab[T_LVL + cat], 85 + tab[T_CBF + cat] + ca + 2 * cb,
               coded_blk, false);
    }
  }
  if (P.t8_mode)
    for (int b8 = 0; b8 < 4; ++b8)
      residual8(e, lac, b8, b.t8v && ((b.cbp_luma >> b8) & 1), tab);
  for (int comp = 0; comp < 2; ++comp) {  // chroma DC (cat 3)
    const int ca = nb.av_l ? (lcc != 0 ? (lw0 >> (12 + comp)) & 1 : 0) : ic;
    const int cb = nb.av_t ? (tcc != 0 ? (tw0 >> (12 + comp)) & 1 : 0) : ic;
    residual(e, io.chroma_dc + (size_t)m * 8 + comp * 4, 4,
             105 + tab[T_SIG + 3], 166 + tab[T_SIG + 3], 227 + tab[T_LVL + 3],
             85 + tab[T_CBF + 3] + ca + 2 * cb,
             b.coded && b.cbp_chroma >= 1, true);
  }
  const int w0 = own[0];
  for (int comp = 0; comp < 2; ++comp) {  // chroma AC (cat 4)
    const int sh = 14 + 4 * comp;
    for (int idx = 0; idx < 4; ++idx) {
      const int by = idx >> 1, bx = idx & 1;
      const int ca = bx > 0 ? (w0 >> (sh + idx - 1)) & 1
                     : nb.av_l ? (lw0 >> (sh + idx + 1)) & 1 : ic;
      const int cb = by > 0 ? (w0 >> (sh + idx - 2)) & 1
                     : nb.av_t ? (tw0 >> (sh + idx + 2)) & 1 : ic;
      residual(e, io.chroma_ac + (size_t)m * 128 + (comp * 4 + idx) * 16 + 1,
               15, 105 + tab[T_SIG + 4], 166 + tab[T_SIG + 4],
               227 + tab[T_LVL + 4], 85 + tab[T_CBF + 4] + ca + 2 * cb,
               b.coded && b.cbp_chroma == 2, false);
    }
  }

  // ---- end_of_slice_flag ----
  e.term(last_of_slice, true);
}

// the slice of MB row r
__device__ int slice_of(const Params& P, int r) {
  int s = 0;
  while (s + 1 < P.n_slices && P.rows[s + 1] <= r) ++s;
  return s;
}

template <class S>
__device__ void walk(S& sink, const Io& io, const Params& P,
                     const int32_t* tab, int m, int s) {
  const int r = m / P.wm, c = m % P.wm;
  Nb nb;
  nb.av_l = c > 0;
  nb.av_t = r > P.rows[s];
  // an unavailable neighbour's state is never read; point at our own
  const int32_t* own = io.state + (size_t)m * kStateWords;
  nb.l = nb.av_l ? own - kStateWords : own;
  nb.t = nb.av_t ? own - (size_t)P.wm * kStateWords : own;
  Emit<S> e{sink};
  walk_mb(e, io, P, tab, m, nb, m == P.rows[s + 1] * P.wm - 1);
}

__device__ const int32_t* load_tables(const Io& io, int32_t* sh) {
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    sh[i] = io.tables[i];
  __syncthreads();
  return sh;
}

// ---- (b) the count pass ----
__global__ void count_kernel(Io io, Params P) {
  __shared__ int32_t tab_s[kTableWords];
  const int32_t* tab = load_tables(io, tab_s);
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= P.wm * P.hm) return;
  Counter cnt;
  walk(cnt, io, P, tab, m, slice_of(P, m / P.wm));
  io.mb_count[m] = cnt.n;
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
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (lane == 31) warp_sums[warp] = x;
      __syncthreads();
      if (warp == 0) {
        int w = warp_sums[lane];
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, w, d);
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
__global__ void emit_kernel(Io io, Params P, int32_t* recs, int stride) {
  __shared__ int32_t tab_s[kTableWords];
  const int32_t* tab = load_tables(io, tab_s);
  const int n = P.wm * P.hm;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < n) {
    const int s = slice_of(P, m / P.wm);
    const int off = io.mb_off[m];
    Writer w{recs + (size_t)s * stride + off, 0, stride - off};
    walk(w, io, P, tab, m, s);
  }
  const size_t total = (size_t)P.n_slices * stride;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int s = (int)(i / stride), k = (int)(i % stride);
    if (k >= io.counts[s]) recs[i] = 0;
  }
}

}  // namespace

// `ptrs`: the `kPtrs` device pointers of `Io` in its order (a null
// pointer for an input the slice kind does not have); `params`: the host
// int32 array of `kernels/cabac_records.py` `pack_params` (wm, hm, slice
// kind, t8 mode, partitions, P_8x8, n_slices, then the n_slices + 1 row
// bounds).  `emit` 0: launch the state, count and scan passes (`recs`
// unused); `emit` 1: launch the emit pass into `recs` [n_slices, stride]
// on the offsets and counts of the last scan, `stride` at least the
// largest count.
extern "C" int tpu264_cabac_records(void* const* ptrs, const int32_t* params,
                                    int32_t* recs, int stride, int emit,
                                    void* stream) {
  Params p;
  const int32_t* q = params;
  p.wm = *q++;
  p.hm = *q++;
  p.kind = *q++;
  p.t8_mode = *q++;
  p.parts = *q++;
  p.p8x8 = *q++;
  p.n_slices = *q++;
  if (p.n_slices < 1 || p.n_slices > kMaxSlices || p.kind < SL_I ||
      p.kind > SL_B || stride < 0)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s <= p.n_slices; ++s) p.rows[s] = q[s];
  if (p.rows[0] != 0 || p.rows[p.n_slices] != p.hm)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < p.n_slices; ++s)
    if (p.rows[s + 1] <= p.rows[s]) return (int)cudaErrorInvalidValue;
  Io io;
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
  io.mvds = (const int32_t*)a[17];
  io.mpm = (const int32_t*)a[18];
  io.tables = (const int32_t*)a[19];
  io.state = (int32_t*)a[20];
  io.mb_count = (int32_t*)a[21];
  io.mb_off = (int32_t*)a[22];
  io.counts = (int32_t*)a[23];
  const int n = p.wm * p.hm;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + kMbThreads - 1) / kMbThreads;
  if (!emit) {
    state_kernel<<<blocks, kMbThreads, 0, s>>>(io, p);
    count_kernel<<<blocks, kMbThreads, 0, s>>>(io, p);
    scan_kernel<<<1, kScanThreads, 0, s>>>(io, p);
    return (int)cudaGetLastError();
  }
  // enough blocks for the zeros too, four words a thread at least
  const long long words = (long long)p.n_slices * stride;
  long long zb = (words / 4 + kMbThreads - 1) / kMbThreads;
  zb = zb > 4096 ? 4096 : zb;
  emit_kernel<<<blocks > zb ? blocks : (int)zb, kMbThreads, 0, s>>>(
      io, p, recs, stride);
  return (int)cudaGetLastError();
}
