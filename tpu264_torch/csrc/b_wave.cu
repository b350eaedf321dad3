// Kernel KB: the B wave body after the Intra4x4 search, for one macroblock
// wave in one launch: the vector prediction of both lists, the B_L0_16x16,
// B_L1_16x16, B_Bi_16x16 and spatial-direct candidates and, on frames that
// allow them, the 16x8 and 8x16 two-partition candidates with an L0, L1 or
// Bi choice for each partition (quarter-pel motion compensation from two
// references, SATD, vector rate, mb_type rate), the Intra16x16 and chroma
// searches, the decision, the chosen residual's transform, quantiser and
// reconstruction, the merge with the Intra4x4 result, the border scatter and
// the writes into both lists' motion-vector maps.
//
// Replaces tpu264/kernels/pallas_kernels.py `_dct_quant_kernel` (K2) and
// `_dct_kernel` (K3) as the B path uses them: the reference's B wave body
// (`tpu264/coding/b_frame.py` `wave_body`) runs K2's function on the inter
// residual (`kt.fdct_quant4x4`) and K3's in its I16x16 and chroma searches
// and residuals (`eval_i16`, `chroma_residual_recon`), between some
// thousand small array operations a wave.  Here all of that is one kernel;
// K2's wave form (`i4x4_wave.cu`) runs just before it on the same stream
// and hands over the Intra4x4 results, as it does for the P wave kernel KP
// (`p_wave.cu`), whose layout this kernel shares (`inter_wave.cuh`,
// `intra_wave.cuh`).
//
// What bounds it on the card: not bytes (a macroblock reads about 10 KB,
// the four 16x16 and up to twelve partition candidates' samples included,
// and writes about 3.5 KB) and not arithmetic, but a chain of dependent
// phases, each ended by a block barrier: context and both lists' vector
// prediction, mode costs, choice, residual, transform, DC transform,
// quantise + reconstruct, store.  Each macroblock lane gets one block of
// 256 threads:
//   costs: thread (blk, p) owns sample p of 4x4 block blk; it forms that
//     sample of the L0, L1, Bi and direct predictions and, where the frame
//     allows partitions, of the L0, L1 and Bi predictions of the 16x8 half
//     and of the 8x16 half it lies in, straight from the two references'
//     half-pel planes (block starts clamped as `jax.lax.dynamic_slice`
//     clamps a block of that size); a 16-lane shuffle Hadamard gives each
//     4x4 block's SATD and a warp holds two blocks of one half of either
//     shape (warps 0-3 the top half, 4-7 the bottom; even warps the left
//     half, odd the right), so a warp sum serves every candidate; the
//     I16x16 and chroma costs are K3's;
//   choice: every thread derives the same decisions from the sums, with
//     the reference's comparisons: the first minimum of L0, L1, Bi, direct
//     and intra; of the three choices of a half; a partition shape wins
//     only if strictly cheaper than the 16x16 choice, the 16x8 shape on a
//     tie between the shapes; a direct candidate over a colocated
//     macroblock whose cells disagree costs 2^30 and is never chosen;
//   residual: an inter lane forms its chroma prediction by eighth-pel
//     bilinear interpolation of the padded U and V planes of the list or
//     lists of its partition; one thread a 4x4 block runs the forward
//     transform; an inter luma block quantises all 16 coefficients with the
//     inter rounding and reconstructs at once, an I16x16 lane and every
//     chroma component go through their DC transforms first.
// Only the chosen path's residual is transformed (the plain version
// computes every candidate and selects).  B macroblocks have no 8x8
// transform and no sub-partitions.  All arithmetic is int32 with arithmetic
// shifts, equal to the plain torch version `b_wave_plain`
// (`tpu264_torch/coding/b_frame.py`) bit for bit.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "inter_wave.cuh"
#include "intra_wave.cuh"
#include "transform4x4.cuh"

namespace {

using iv::Geometry;
using iv::kIntra;
using iv::kPad;
using iv::mv_cost;
using iw::kThreads;

// flags: the encoder weighs partitions; this frame allows them
constexpr int kParts = 1, kAllowParts = 2;
constexpr int32_t kNever = 1 << 30;    // the reference's 2**30 cost

struct BParams {
  iw::QuantSet luma, chroma;
  uint8_t zigzag[16];      // scan position -> raster position
  uint8_t blk_raster[16];  // 4x4 block in coding order -> by * 4 + bx
  int32_t f_inter_luma, f_inter_chroma;   // 2^qbits / 6 of each set
  int32_t lam4, lam24, lam_me;
  int8_t qpel[16][7];      // fy * 4 + fx -> p1 dy1 dx1 p2 dy2 dx2 avg
  int32_t flags;
  int32_t tb_part[2][9];   // ue(mb_type) bits: shape (16x8, 8x16) x c0*3+c1
  int32_t type_bits[3];    // ue(mb_type) bits of B_L0, B_L1, B_Bi_16x16
};

// the pointers of one wave, in the order of the C entry's `ptrs`
struct WaveIo {
  iw::Borders bd;                   // border buffers
  int32_t *mv0_map, *ref0_map;      // list 0: [3,hm+2,wm+2,2], [3,hm+2,wm+2]
  int32_t *mv1_map, *ref1_map;      // list 1
  const int32_t *planes0, *planes1; // [4,hp,wp] G, b, h, j of each list
  const int32_t *c0u, *c0v, *c1u, *c1v;   // [hc,wc] padded chroma
  const int32_t* coords;            // [B,2] (r, c)
  const uint8_t* avail;             // [B,4] top, left, top-left, top-right
  const int32_t *mv_me0, *mv_me1;   // [B,2] quarter-pel (y, x) of each list
  const int32_t *mv_parts0, *mv_parts1;   // [B,4,2] top bot left right
  const uint8_t *colzero, *colmixed;      // [B]
  const int32_t *gy, *gu, *gv;      // source [B,16,16], [B,8,8] x 2
  const int32_t *mb4, *modebuf, *coeffs4, *j4;   // the I4x4 body's results
  // the partitions' results, null without partitions
  int32_t *bptype, *c0, *c1;        // [B] 0 / 1 16x8 / 2 8x16; choices
  int32_t *mv0b, *mv1b;             // [B,2] partition 1's vectors
  int32_t* btype;                   // [B] L0 L1 Bi direct intra partitioned
  int32_t *mv0, *mv1;               // [B,2]
  uint8_t *use0, *use1;             // [B]
  uint8_t* sel16;                   // [B] Intra16x16 chosen
  int32_t *i16mode, *cmode;         // [B]
  int32_t *luma_ac, *luma_dc;       // [B,16,16], [B,16]
  int32_t *chroma_dc, *chroma_ac;   // [B,2,4], [B,2,4,16]
  int32_t *recon_mb, *rec_u, *rec_v;
};
constexpr int kPtrs = 53;

// first minimum of three costs (the lowest choice wins a tie)
__device__ __forceinline__ int first_min3(const int32_t (&j)[3],
                                          int32_t& best) {
  int k = 0;
  best = j[0];
  if (j[1] < best) {
    best = j[1];
    k = 1;
  }
  if (j[2] < best) {
    best = j[2];
    k = 2;
  }
  return k;
}

__global__ void __launch_bounds__(kThreads) b_wave_kernel(WaveIo io,
                                                          BParams prm,
                                                          Geometry g) {
  __shared__ iw::IntraSmem s;
  __shared__ int32_t res[24][16];     // per 4x4 block (16 luma, 4 U, 4 V)
  __shared__ int32_t lev[24][16];
  __shared__ int32_t dcs[16], cdcs[8];   // DC coefficients; dequantised DCs
  __shared__ int32_t dclev[16];
  __shared__ int32_t vec[2][3];       // per list: predicted y, x; a neighbour
                                      // uses the list
  // candidates x warp: L0, L1, Bi, direct; the 16x8 halves' L0, L1, Bi;
  // the 8x16 halves' L0, L1, Bi
  __shared__ int32_t isum[10][8];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int r = io.coords[2 * b], c = io.coords[2 * b + 1];
  const bool at = io.avail[4 * b] != 0, al = io.avail[4 * b + 1] != 0,
             atl = io.avail[4 * b + 2] != 0, atr = io.avail[4 * b + 3] != 0;
  const iw::Lane ln(tid);
  const int blk = ln.blk, p = ln.p, y = ln.y, x = ln.x;
  const int comp = ln.comp, cb = ln.cb;
  const bool parts = prm.flags & kParts;
  const bool allow = parts && (prm.flags & kAllowParts);
  const int32_t* mp0 = io.mv_parts0 + 8 * b;  // the halves' vectors, list 0
  const int32_t* mp1 = io.mv_parts1 + 8 * b;

  // ---- context, source, and (threads 128, 160) each list's prediction
  iw::load_intra_context(s, io.bd, g.wm, r, c, io.gy, io.gu, io.gv, b, tid);
  if (tid == 128 || tid == 160) {
    const int l = tid == 160;
    int32_t ref[3], mv[3][2];
    iv::neighbour_vectors(l ? io.mv1_map : io.mv0_map,
                          l ? io.ref1_map : io.ref0_map, g, r, c, at, al,
                          atl, atr, ref, mv);
    iv::median_prediction(ref, mv, vec[l]);
    vec[l][2] = ref[0] == 0 || ref[1] == 0 || ref[2] == 0;
  }
  __syncthreads();
  iw::intra_context_sums(s, tid);
  __syncthreads();

  // ---- costs: I16x16 and chroma modes; the inter candidates ----
  int32_t pr[4], cpr[4];
  iw::intra_mode_costs(s, ln, at, al, tid, pr, cpr);
  const int32_t p0y = vec[0][0], p0x = vec[0][1];
  const int32_t p1y = vec[1][0], p1x = vec[1][1];
  // spatial direct (spec 8.4.1.2.2): the lists the neighbours use (both
  // when none does), their predictions as vectors, zero where no neighbour
  // uses a list or the colocated block is still
  const bool nb0 = vec[0][2] != 0, nb1 = vec[1][2] != 0;
  const bool zero_pred = !nb0 && !nb1;
  const bool duse0 = zero_pred || nb0, duse1 = zero_pred || nb1;
  const bool dzero = zero_pred || io.colzero[b] != 0;
  const int32_t d0y = dzero ? 0 : p0y, d0x = dzero ? 0 : p0x;
  const int32_t d1y = dzero ? 0 : p1y, d1x = dzero ? 0 : p1x;
  const int32_t me0y = io.mv_me0[2 * b], me0x = io.mv_me0[2 * b + 1];
  const int32_t me1y = io.mv_me1[2 * b], me1x = io.mv_me1[2 * b + 1];
  const int y0 = r * 16 + kPad, x0 = c * 16 + kPad;
  const int32_t s_y = s.src[y * 16 + x];
  int32_t cand[10];
  cand[0] = iv::mc_luma_sample(io.planes0, prm.qpel, g, y0, x0, me0y, me0x,
                               y, x, 16, 16);
  cand[1] = iv::mc_luma_sample(io.planes1, prm.qpel, g, y0, x0, me1y, me1x,
                               y, x, 16, 16);
  cand[2] = (cand[0] + cand[1] + 1) >> 1;
  {
    const int32_t a = iv::mc_luma_sample(io.planes0, prm.qpel, g, y0, x0,
                                         d0y, d0x, y, x, 16, 16);
    const int32_t bb = iv::mc_luma_sample(io.planes1, prm.qpel, g, y0, x0,
                                          d1y, d1x, y, x, 16, 16);
    cand[3] = duse0 && duse1 ? (a + bb + 1) >> 1 : (duse0 ? a : bb);
  }
  int n_cand = 4;
  if (allow) {
    // this sample's 16x8 half h (top, bottom) and 8x16 half v (left, right)
    const int h = y >> 3, v = x >> 3;
    const int32_t* t0 = mp0 + 2 * h;
    const int32_t* t1 = mp1 + 2 * h;
    cand[4] = iv::mc_luma_sample(io.planes0, prm.qpel, g, y0 + 8 * h, x0,
                                 t0[0], t0[1], y - 8 * h, x, 8, 16);
    cand[5] = iv::mc_luma_sample(io.planes1, prm.qpel, g, y0 + 8 * h, x0,
                                 t1[0], t1[1], y - 8 * h, x, 8, 16);
    cand[6] = (cand[4] + cand[5] + 1) >> 1;
    const int32_t* w0 = mp0 + 4 + 2 * v;
    const int32_t* w1 = mp1 + 4 + 2 * v;
    cand[7] = iv::mc_luma_sample(io.planes0, prm.qpel, g, y0, x0 + 8 * v,
                                 w0[0], w0[1], y, x - 8 * v, 16, 8);
    cand[8] = iv::mc_luma_sample(io.planes1, prm.qpel, g, y0, x0 + 8 * v,
                                 w1[0], w1[1], y, x - 8 * v, 16, 8);
    cand[9] = (cand[7] + cand[8] + 1) >> 1;
    n_cand = 10;
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    if (k < n_cand) {                  // uniform over the block
      const int32_t t = iv::warp_satd(s_y - cand[k], p);
      if ((tid & 31) == 0) isum[k][tid >> 5] = t;
    }
  }
  __syncthreads();

  // ---- the choices, by every thread alike ----
  int32_t j16;
  int best16, bestc;
  iw::intra_choices(s, at, al, atl, j16, best16, bestc);
  int32_t satd[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int w = 0; w < 8; ++w) satd[k] += isum[k][w];
  }
  const int32_t rb0 = mv_cost(me0y - p0y, me0x - p0x);
  const int32_t rb1 = mv_cost(me1y - p1y, me1x - p1x);
  const int32_t j4 = io.j4[b];
  const bool sel16 = j16 < j4;
  // L0, L1, Bi (+ their ue(mb_type) bits), direct (1 bit, no mvd),
  // intra (the larger mb_type cost)
  const int32_t jv[5] = {
      satd[0] + prm.lam_me * (rb0 + prm.type_bits[0]),
      satd[1] + prm.lam_me * (rb1 + prm.type_bits[1]),
      satd[2] + prm.lam_me * (rb0 + rb1 + prm.type_bits[2]),
      io.colmixed[b] ? kNever : satd[3] + prm.lam_me,
      (sel16 ? j16 : j4) + prm.lam24};
  int btype = 0;
  int32_t j_best = jv[0];
#pragma unroll
  for (int m = 1; m < 5; ++m) {
    if (jv[m] < j_best) {
      j_best = jv[m];
      btype = m;
    }
  }
  int bptype = 0, ch0 = 0, ch1 = 0;   // the shape; part 0's and 1's choice
  if (allow) {
    // halves k: 0 top, 1 bottom (warps 0-3, 4-7), 2 left, 3 right (even,
    // odd warps); choices L0, L1, Bi, each with its lists' vector bits
    int ch[4];
    int32_t jmin[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = k < 2 ? 4 : 7;
      int32_t sat[3] = {0, 0, 0};
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const bool in = k < 2 ? (w >> 2) == k : (w & 1) == k - 2;
        if (in) {
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) sat[cc] += isum[row + cc][w];
        }
      }
      const int32_t r0h = mv_cost(mp0[2 * k] - p0y, mp0[2 * k + 1] - p0x);
      const int32_t r1h = mv_cost(mp1[2 * k] - p1y, mp1[2 * k + 1] - p1x);
      const int32_t jh[3] = {sat[0] + prm.lam_me * r0h,
                             sat[1] + prm.lam_me * r1h,
                             sat[2] + prm.lam_me * (r0h + r1h)};
      ch[k] = first_min3(jh, jmin[k]);
    }
    const int32_t j_p1 =
        jmin[0] + jmin[1] + prm.lam_me * prm.tb_part[0][ch[0] * 3 + ch[1]];
    const int32_t j_p2 =
        jmin[2] + jmin[3] + prm.lam_me * prm.tb_part[1][ch[2] * 3 + ch[3]];
    if (j_p1 < j_best && j_p1 <= j_p2) {
      bptype = 1;
      ch0 = ch[0];
      ch1 = ch[1];
    } else if (j_p2 < j_best && j_p2 < j_p1) {
      bptype = 2;
      ch0 = ch[2];
      ch1 = ch[3];
    }
    if (bptype) btype = 5;
  }
  const bool is_inter = btype != 4;
  const bool is_direct = btype == 3;
  // the final vectors of each list (partition 0's, and 1's in *b)
  int32_t mv0y = is_direct ? d0y : me0y, mv0x = is_direct ? d0x : me0x;
  int32_t mv1y = is_direct ? d1y : me1y, mv1x = is_direct ? d1x : me1x;
  int32_t mv0by = mv0y, mv0bx = mv0x, mv1by = mv1y, mv1bx = mv1x;
  bool use0, use1, use0b, use1b;
  if (bptype) {
    const int k0 = bptype == 1 ? 0 : 2;
    mv0y = mp0[2 * k0];
    mv0x = mp0[2 * k0 + 1];
    mv1y = mp1[2 * k0];
    mv1x = mp1[2 * k0 + 1];
    mv0by = mp0[2 * k0 + 2];
    mv0bx = mp0[2 * k0 + 3];
    mv1by = mp1[2 * k0 + 2];
    mv1bx = mp1[2 * k0 + 3];
    use0 = ch0 != 1;
    use1 = ch0 != 0;
    use0b = ch1 != 1;
    use1b = ch1 != 0;
  } else {
    use0 = btype == 0 || btype == 2 || (is_direct && duse0);
    use1 = btype == 1 || btype == 2 || (is_direct && duse1);
    use0b = use0;
    use1b = use1;
  }
  const bool luma_tx = is_inter || sel16;        // a luma residual to code
  int32_t ipred;
  if (bptype == 1) {
    ipred = cand[4 + ((y >> 3) ? ch1 : ch0)];
  } else if (bptype == 2) {
    ipred = cand[7 + ((x >> 3) ? ch1 : ch0)];
  } else {
    ipred = cand[btype < 4 ? btype : 0];
  }
  const int32_t lpred = is_inter ? ipred : iw::pick4(pr, best16);
  if (luma_tx) res[blk][p] = s_y - lpred;
  int32_t cpred = 0;
  if (tid < 128) {
    if (is_inter) {
      const int cy = ln.cy, cx = ln.cx;
      const int32_t* pad0 = comp ? io.c0v : io.c0u;
      const int32_t* pad1 = comp ? io.c1v : io.c1u;
      const int cy0 = r * 8 + kPad / 2, cx0 = c * 8 + kPad / 2;
      // this sample's partition: its origin, size, vectors and lists
      int oy = 0, ox = 0, bh = 8, bw = 8;
      int32_t ay = me0y, ax = me0x, by_ = me1y, bx_ = me1x;
      bool u0 = btype != 1, u1 = btype != 0;
      if (bptype) {
        int k, cc;
        if (bptype == 1) {
          oy = cy & 4;
          bh = 4;
          k = oy ? 1 : 0;
          cc = oy ? ch1 : ch0;
        } else {
          ox = cx & 4;
          bw = 4;
          k = ox ? 3 : 2;
          cc = ox ? ch1 : ch0;
        }
        ay = mp0[2 * k];
        ax = mp0[2 * k + 1];
        by_ = mp1[2 * k];
        bx_ = mp1[2 * k + 1];
        u0 = cc != 1;
        u1 = cc != 0;
      } else if (is_direct) {
        ay = d0y;
        ax = d0x;
        by_ = d1y;
        bx_ = d1x;
        u0 = duse0;
        u1 = duse1;
      }
      const int32_t a = iv::mc_chroma_sample(pad0, g, cy0 + oy, cx0 + ox, ay,
                                             ax, cy - oy, cx - ox, bh, bw);
      const int32_t bb = iv::mc_chroma_sample(pad1, g, cy0 + oy, cx0 + ox,
                                              by_, bx_, cy - oy, cx - ox, bh,
                                              bw);
      cpred = u0 && u1 ? (a + bb + 1) >> 1 : (u0 ? a : bb);
    } else {
      cpred = iw::pick4(cpr, bestc);
    }
    res[16 + comp * 4 + cb][p] =
        s.csrc[comp * 64 + ln.cy * 8 + ln.cx] - cpred;
  }
  __syncthreads();
  // ---- forward transform, one thread a 4x4 block; an inter luma block
  // is quantised and reconstructed here (it has no DC transform) ----
  const bool lblk = luma_tx && tid < 16;
  const bool cblk = tid >= 32 && tid < 40;
  const int slot = tid < 16 ? tid : 16 + ((tid - 32) & 7);
  const int32_t fc = is_inter ? prm.f_inter_chroma : prm.chroma.f;
  int32_t w[16];
  if (lblk || cblk) {
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = res[slot][i];
    t4x4::fdct4x4(w);
    if (cblk) {
      cdcs[tid - 32] = w[0];
    } else if (is_inter) {
      const iw::QuantSet& q = prm.luma;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int32_t l =
            t4x4::quant1(w[i], q.mf[i], prm.f_inter_luma, q.qbits, q.lim[i]);
        lev[slot][i] = l;
        w[i] = (l * q.v[i]) << q.qshift;
      }
      t4x4::idct4x4(w);
#pragma unroll
      for (int i = 0; i < 16; ++i) res[slot][i] = w[i];
    } else {
      dcs[tid] = w[0];
    }
  }
  __syncthreads();

  // ---- the DC transforms ----
  if (sel16 && !is_inter && tid == 0) {
    iw::luma_dc_transform(dcs, dclev, prm.luma);
  } else if (tid == 32 || tid == 33) {
    const int cmp = tid - 32;
    iw::chroma_dc_transform(cdcs + 4 * cmp, prm.chroma, fc,
                            io.chroma_dc + (b * 2 + cmp) * 4);
  }
  __syncthreads();

  // ---- AC quantiser, dequantiser, inverse transform ----
  if (lblk && !is_inter) {
    iw::quant_recon(w, prm.luma, prm.luma.f, dcs[tid], lev[slot]);
#pragma unroll
    for (int i = 0; i < 16; ++i) res[slot][i] = w[i];
  } else if (cblk) {
    iw::quant_recon(w, prm.chroma, fc, cdcs[tid - 32], lev[slot]);
#pragma unroll
    for (int i = 0; i < 16; ++i) res[slot][i] = w[i];
  }
  __syncthreads();

  // ---- results: levels, reconstruction, border scatter, maps ----
  {
    // luma_ac [16 blocks in coding order][16 scan positions]
    const int32_t lv = luma_tx ? lev[prm.blk_raster[blk]][prm.zigzag[p]]
                               : io.coeffs4[b * 256 + tid];
    io.luma_ac[b * 256 + tid] = lv;
    const int32_t rec = luma_tx ? iw::clip255(lpred + res[blk][p])
                                : io.mb4[b * 256 + y * 16 + x];
    io.recon_mb[b * 256 + y * 16 + x] = rec;
    iw::store_luma_border(io.bd, g.wm, r, c, y, x, rec);
  }
  if (tid < 128) {
    io.chroma_ac[b * 128 + tid] = lev[16 + comp * 4 + cb][prm.zigzag[p]];
    const int32_t rec = iw::clip255(cpred + res[16 + comp * 4 + cb][p]);
    (comp ? io.rec_v : io.rec_u)[b * 64 + ln.cy * 8 + ln.cx] = rec;
    iw::store_chroma_border(io.bd, g.wm, r, c, comp, ln.cy, ln.cx, rec);
  }
  const bool is_i16 = sel16 && !is_inter;
  if (tid < 16) io.luma_dc[b * 16 + tid] = is_i16 ? dclev[prm.zigzag[tid]] : 0;
  // an inter or I16x16 macroblock shows its neighbours the mode -1
  iw::store_mode_tiles(io.bd, g.wm, r, c, tid, luma_tx, io.modebuf + b * 16);
  if (tid == 96) {
    io.btype[b] = btype;
    io.mv0[2 * b] = mv0y;
    io.mv0[2 * b + 1] = mv0x;
    io.mv1[2 * b] = mv1y;
    io.mv1[2 * b + 1] = mv1x;
    io.use0[b] = use0 ? 1 : 0;
    io.use1[b] = use1 ? 1 : 0;
    io.sel16[b] = is_i16 ? 1 : 0;
    io.i16mode[b] = best16;
    io.cmode[b] = bestc;
    if (io.bptype) {
      io.bptype[b] = bptype;
      io.c0[b] = ch0;
      io.c1[b] = ch1;
      io.mv0b[2 * b] = mv0by;
      io.mv0b[2 * b + 1] = mv0bx;
      io.mv1b[2 * b] = mv1by;
      io.mv1b[2 * b + 1] = mv1bx;
    }
  } else if (tid >= 160 && tid < 166) {
    // the three cells of this macroblock in each list's maps (row hm + 1
    // takes the padding lanes' writes): top-right (A of the right MB;
    // partition 1 of an 8x16 MB), bottom-left (B and C below; partition 1
    // of a 16x8 MB), bottom-right (D below; partition 1 of both); a cell
    // whose partition does not use the list, or an intra MB, holds
    // (0, kIntra)
    const int l = (tid - 160) / 3, ch = (tid - 160) % 3;
    const bool second = ch == 0 ? bptype == 2 : (ch == 1 ? bptype == 1
                                                        : bptype > 0);
    const bool used = is_inter && (l ? (second ? use1b : use1)
                                     : (second ? use0b : use0));
    const int32_t cy = l ? (second ? mv1by : mv1y) : (second ? mv0by : mv0y);
    const int32_t cx = l ? (second ? mv1bx : mv1x) : (second ? mv0bx : mv0x);
    int32_t* mv_map = l ? io.mv1_map : io.mv0_map;
    int32_t* ref_map = l ? io.ref1_map : io.ref0_map;
    const int cell = (ch * (g.hm + 2) + r + 1) * (g.wm + 2) + c + 1;
    mv_map[2 * cell] = used ? cy : 0;
    mv_map[2 * cell + 1] = used ? cx : 0;
    ref_map[cell] = used ? 0 : kIntra;
  }
}

}  // namespace

// `ptrs` holds the device pointers of one wave in the order of `WaveIo`;
// `params` is the host int32 array that `kernels/b_wave.py` packs: K3's
// wave-form table (for luma, then for chroma, mf[16] lim[16] v[16] f qbits
// qshift mf00 v00 lim_dc qp; then zigzag[16] blk_raster[16]), then the
// inter rounding offsets of luma and chroma, lam4, lam24, lam_me, the
// quarter-pel table [16][7], the flags, the partitions' mb_type bits
// [2][9] and those of B_L0, B_L1, B_Bi_16x16 [3].  `geom` is wm, hm, hp, wp, hc, wc.
extern "C" int tpu264_b_wave(void* const* ptrs, const int32_t* params,
                             const int32_t* geom, int n_mbs, void* stream) {
  static_assert(sizeof(WaveIo) == kPtrs * sizeof(void*), "WaveIo layout");
  WaveIo io;
  std::memcpy(&io, ptrs, sizeof(io));
  BParams prm;
  const int32_t* q = params;
  iw::load_quant_set(prm.luma, q);
  iw::load_quant_set(prm.chroma, q);
  for (int i = 0; i < 16; ++i) prm.zigzag[i] = (uint8_t)*q++;
  for (int i = 0; i < 16; ++i) prm.blk_raster[i] = (uint8_t)*q++;
  prm.f_inter_luma = *q++;
  prm.f_inter_chroma = *q++;
  prm.lam4 = *q++;
  prm.lam24 = *q++;
  prm.lam_me = *q++;
  for (int i = 0; i < 16; ++i)
    for (int k = 0; k < 7; ++k) prm.qpel[i][k] = (int8_t)*q++;
  prm.flags = *q++;
  for (int s = 0; s < 2; ++s)
    for (int i = 0; i < 9; ++i) prm.tb_part[s][i] = *q++;
  for (int i = 0; i < 3; ++i) prm.type_bits[i] = *q++;
  const Geometry g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5]};
  if (n_mbs > 0) {
    b_wave_kernel<<<n_mbs, kThreads, 0, (cudaStream_t)stream>>>(io, prm, g);
  }
  return (int)cudaGetLastError();
}
