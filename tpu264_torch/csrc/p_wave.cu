// Kernel KP: the P wave body, all of it, as one launch a P picture (or a
// band of the tiled encoder).  One cooperative launch runs the picture's
// waves in order with a grid-wide barrier between them (`frame_wave.cuh`);
// a macroblock lane is one block of 416 threads, whose first five warps run
// the Intra4x4 search (`i4x4_body.cuh`, K2's wave form) while the other
// eight run motion-vector prediction, the P_Skip and P_L0_16x16 candidates
// and, with the reference's default tools, the P_L0_16x8, P_L0_8x16 and
// P_8x8 candidates (quarter-pel motion compensation, SATD, vector rate;
// every luma prediction weighted by the frame's explicit weight and
// offset), the Intra16x16 and chroma searches; then, after the two groups
// join, the inter-or-intra decision, the chosen residual's transform,
// quantiser and reconstruction (for a 16x16 inter macroblock also the 8x8
// transform, and the choice between the two), the merge with the Intra4x4
// result, the border scatter and the motion-vector map writes.
//
// Replaces tpu264/kernels/pallas_kernels.py `_dct_quant_kernel` (K2) and
// `_dct_kernel` (K3) as the P path uses them: the reference runs K2's
// function in the Intra4x4 search (`eval_i4x4`) and on the inter residual,
// and K3's in the I16x16 and chroma searches and residuals, between about
// 1,300 small array operations a wave (`tpu264/coding/inter_frame.py`
// `wave_body`).  On P pictures this kernel takes the place of K2's wave
// form too, which runs only on I pictures now.  The 8x8 transform of the
// reference (`tpu264/kernels/transform8.py`) is plain array code, not
// Pallas; it runs here because its choice sits in the middle of the wave
// body.
//
// What bounds it on the card: not bytes (a macroblock reads about 7 KB, the
// two 16x16 motion-compensated candidates included, and writes about
// 3.5 KB) and not arithmetic, but chains of dependent steps: a picture's
// waves one after another, and in a wave the Intra4x4 search's 16 block
// steps of two barriers each (about 22 us a wave) beside the inter group's
// context, vector prediction and mode costs, then the decision and the
// transform phases, each ended by a barrier.  Before, each wave was two
// launches (K2's wave form, then this kernel) with about 0.15 ms of host
// work around 34 us of device work.  The design: one launch a picture
// (the host work once a picture), the Intra4x4 chain overlapped with
// everything that does not need it, its results handed over in shared
// memory, and a grid barrier in place of a kernel boundary between waves.
// The inter group keeps its layout of K3's wave form (`intra_wave.cuh`):
//   costs: thread (blk, p) owns sample p of 4x4 block blk; it forms that
//     sample of every inter prediction (two to five) straight from the four
//     half-pel planes (two reads and the rounding average of `QPEL_TABLE`,
//     each block start clamped as `jax.lax.dynamic_slice` clamps a block of
//     that partition's size), and a 16-lane shuffle Hadamard gives each 4x4
//     block's SATD with its DC term (`transform.satd4x4`); the I16x16 and
//     chroma costs are K3's;
//   choice: every thread derives the same decisions from the sums;
//   residual: an inter lane forms its chroma prediction by eighth-pel
//     bilinear interpolation of the padded U and V planes; one thread a
//     4x4 block runs the forward transform; an inter luma block quantises
//     all 16 coefficients with the inter rounding and reconstructs at once,
//     an I16x16 lane and every chroma component go through their DC
//     transforms first;
//   the 8x8 transform, only on a lane that chose a 16x16 inter prediction
//     with the tool on (a branch uniform over the group): eight threads an
//     8x8 block run its rows, then its columns, one thread a coefficient
//     quantises and dequantises, eight threads a block invert it, and a
//     group sum gives both transforms' SSD and coefficient bits.
// Only the chosen path's residual is transformed (the plain version
// computes every candidate and selects).  All arithmetic is int32 with
// arithmetic shifts, equal to the plain torch version `p_frame_plain`
// (`tpu264_torch/coding/inter_frame.py`) bit for bit, but the transform
// choice's cost, SSD + lambda x bits in float32 with one rounding, as the
// reference's fused multiply-add gives it (`__fmaf_rn`).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "frame_wave.cuh"
#include "i4x4_body.cuh"
#include "inter_wave.cuh"
#include "intra_wave.cuh"
#include "transform4x4.cuh"

namespace {

using iv::Geometry;
using iv::kIntra;
using iv::kPad;
using iv::kUnavail;
using iv::mv_cost;

// the tools (`kernels/p_wave.py` `Tools`)
constexpr int kParts = 1, kP8x8 = 2, kT8 = 4;

struct PParams {
  iw::QuantSet luma, chroma;
  uint8_t zigzag[16];      // scan position -> raster position
  uint8_t blk_raster[16];  // 4x4 block in coding order -> by * 4 + bx
  int32_t f_inter_luma, f_inter_chroma;   // 2^qbits / 6 of each set
  int32_t lam4, lam24, lam_me;
  int8_t qpel[16][7];      // fy * 4 + fx -> p1 dy1 dx1 p2 dy2 dx2 avg
  int32_t tools;
  // the 8x8 transform: MF8 and V8 of qp % 6 (raster), the 8x8 zig-zag
  // scan, the inter rounding 2^qbits8 / 6, qbits8 = 16 + qp / 6, qp / 6,
  // and the choice's lambda
  int32_t mf8[64], v8[64];
  uint8_t zigzag8[64];
  int32_t f8, qbits8, qdiv6;
  float lam_ssd;
  // explicit weighted prediction of luma (denominator 6); (64, 0) is none
  int32_t wy, oy;
};

// the pointers of a picture, in the order of the C entry's `ptrs`; the
// per-wave arrays are [n_waves, bmax, ...], lane row b = w * bmax + lane
struct FrameIo {
  iw::Borders bd;                   // border buffers
  int32_t *mv_map, *ref_map;        // [3,hm+2,wm+2,2], [3,hm+2,wm+2]
  const int32_t* planes;            // [4,hp,wp] G, b, h, j
  const int32_t *cu_pad, *cv_pad;   // [hc,wc] each
  const int32_t* coords;            // [.,2] (r, c)
  const uint8_t* avail;             // [.,4] top, left, top-left, top-right
  const int32_t* mv_me;             // [.,2] quarter-pel (y, x)
  const int32_t* mv_parts;          // [.,8,2] top bot left right q0..q3
  const int32_t *gy, *gu, *gv;      // source [.,16,16], [.,8,8] x 2
  // the tools' results, null where the tool is off
  int32_t* ptype;                   // [.] 0 16x16, 1 16x8, 2 8x16, 3 P_8x8
  int32_t *mv2, *mvq;               // [.,2], [.,4,2]
  uint8_t* t8;                      // [.] 8x8 transform chosen
  uint8_t* is_inter;                // [.]
  int32_t *mv, *mv_pred, *mv_skip;  // [.,2]
  uint8_t* sel16;                   // [.] Intra16x16 chosen
  int32_t *i16mode, *modes, *cmode; // [.], [.,16] Intra4x4 modes, [.]
  int32_t *luma_ac, *luma_dc;       // [.,16,16], [.,16]
  int32_t *chroma_dc, *chroma_ac;   // [.,2,4], [.,2,4,16]
  int32_t *recon_mb, *rec_u, *rec_v;
};
constexpr int kPtrs = 39;

// One thread: the lane's median prediction (spec 8.4.1.3) and P_Skip vector
// (spec 8.4.1.1) from the maps -> out = pred y, x, skip y, x.
__device__ void predict_vectors(const FrameIo& io, const Geometry& g, int r,
                                int c, bool at, bool al, bool atl, bool atr,
                                int32_t* out) {
  int32_t ref[3], mv[3][2];
  iv::neighbour_vectors(io.mv_map, io.ref_map, g, r, c, at, al, atl, atr,
                        ref, mv);
  iv::median_prediction(ref, mv, out);
  const bool zero = ref[0] == kUnavail || ref[1] == kUnavail ||
                    (ref[0] == 0 && mv[0][0] == 0 && mv[0][1] == 0) ||
                    (ref[1] == 0 && mv[1][0] == 0 && mv[1][1] == 0);
  out[2] = zero ? 0 : out[0];
  out[3] = zero ? 0 : out[1];
}

// Sample (y, x) of a quarter-pel luma prediction from the reference's
// half-pel planes (`iv::mc_luma_sample` with this kernel's table), weighted
// after interpolation as a decoder weighs it (spec 8.4.2.3.2,
// `inter_frame.weight_luma`): clip(((p * wy + 32) >> 6) + oy); (64, 0)
// gives p back.  Every candidate, and so the SATD, the residuals, the
// transform choice and the reconstruction, sees the weighted sample.
__device__ __forceinline__ int32_t mc_luma_sample(const int32_t* planes,
                                                  const PParams& prm,
                                                  const Geometry& g, int y0,
                                                  int x0, int32_t mvy,
                                                  int32_t mvx, int y, int x,
                                                  int bh, int bw) {
  const int32_t p = iv::mc_luma_sample(planes, prm.qpel, g, y0, x0, mvy,
                                       mvx, y, x, bh, bw);
  return iw::clip255(((p * prm.wy + 32) >> 6) + prm.oy);
}

// One 8-point pass of the JM forward 8x8 transform (`transform8._fwd1d`).
__device__ __forceinline__ void fwd8(int32_t (&b)[8]) {
  int32_t a[4], d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = b[i] + b[7 - i];
    d[i] = b[i] - b[7 - i];
  }
  const int32_t b0 = a[0] + a[3], b1 = a[1] + a[2];
  const int32_t b2 = a[0] - a[3], b3 = a[1] - a[2];
  const int32_t b4 = d[1] + d[2] + ((d[0] >> 1) + d[0]);
  const int32_t b5 = d[0] - d[3] - ((d[2] >> 1) + d[2]);
  const int32_t b6 = d[0] + d[3] - ((d[1] >> 1) + d[1]);
  const int32_t b7 = d[1] - d[2] + ((d[3] >> 1) + d[3]);
  b[0] = b0 + b1;
  b[1] = b4 + (b7 >> 2);
  b[2] = b2 + (b3 >> 1);
  b[3] = b5 + (b6 >> 2);
  b[4] = b0 - b1;
  b[5] = b6 - (b5 >> 2);
  b[6] = (b2 >> 1) - b3;
  b[7] = (b4 >> 2) - b7;
}

// One 8-point pass of the normative inverse 8x8 transform (spec 8.5.12.3).
__device__ __forceinline__ void inv8(int32_t (&d)[8]) {
  const int32_t e0 = d[0] + d[4];
  const int32_t e1 = -d[3] + d[5] - d[7] - (d[7] >> 1);
  const int32_t e2 = d[0] - d[4];
  const int32_t e3 = d[1] + d[7] - d[3] - (d[3] >> 1);
  const int32_t e4 = (d[2] >> 1) - d[6];
  const int32_t e5 = -d[1] + d[7] + d[5] + (d[5] >> 1);
  const int32_t e6 = d[2] + (d[6] >> 1);
  const int32_t e7 = d[3] + d[5] + d[1] + (d[1] >> 1);
  const int32_t f0 = e0 + e6, f1 = e1 + (e7 >> 2);
  const int32_t f2 = e2 + e4, f3 = e3 + (e5 >> 2);
  const int32_t f4 = e2 - e4, f5 = (e3 >> 2) - e5;
  const int32_t f6 = e0 - e6, f7 = e7 - (e1 >> 2);
  d[0] = f0 + f7;
  d[1] = f2 + f5;
  d[2] = f4 + f3;
  d[3] = f6 + f1;
  d[4] = f6 - f1;
  d[5] = f4 - f3;
  d[6] = f2 - f5;
  d[7] = f0 - f7;
}

// the transform choice's rate estimate of one level: 2 bit_length(|l|) + 1
__device__ __forceinline__ int32_t coeff_bits(int32_t l) {
  const int32_t a = iw::iabs(l);
  return a ? 2 * (32 - __clz(a)) + 1 : 0;
}

// The inter group's part of lane row b (tid = 0 .. 255): everything of the
// P wave body but the Intra4x4 search, whose results it reads from `i4o`
// after the join.
__device__ __forceinline__ void p_lane(const FrameIo& io, const PParams& prm,
                                       const Geometry& g,
                                       const fw::I4Out& i4o, int b,
                                       int tid) {
  __shared__ iw::IntraSmem s;
  __shared__ int32_t res[24][16];     // per 4x4 block (16 luma, 4 U, 4 V)
  __shared__ int32_t lev[24][16];
  __shared__ int32_t dcs[16], cdcs[8];   // DC coefficients; dequantised DCs
  __shared__ int32_t dclev[16];
  __shared__ int32_t vec[4];          // predicted vector, skip vector
  // inter candidates (ME, skip, 16x8, 8x16, P_8x8) x warp
  __shared__ int32_t isum[5][8];
  // the 8x8 transform: the inter prediction (raster), one pass's output
  // of the four 8x8 blocks, their coefficients / dequantised values, their
  // levels, their reconstruction (raster), and the choice's sums x warp
  // (4x4 SSD and bits, 8x8 SSD and bits, nonzero 8x8 levels)
  __shared__ int32_t pred8[256], pass8[4][8][8], coef8[256], lev8[256],
      rec8[256], tsum[5][8];

  const int r = io.coords[2 * b], c = io.coords[2 * b + 1];
  const bool at = io.avail[4 * b] != 0, al = io.avail[4 * b + 1] != 0,
             atl = io.avail[4 * b + 2] != 0, atr = io.avail[4 * b + 3] != 0;
  const iw::Lane ln(tid);
  const int blk = ln.blk, p = ln.p, y = ln.y, x = ln.x;
  const int comp = ln.comp, cb = ln.cb;
  const bool parts = prm.tools & kParts, p8x8 = prm.tools & kP8x8;
  const int32_t* mp = io.mv_parts + 16 * b;   // the partitions' vectors

  // ---- context, source, and (thread 128) the vector predictions ----
  iw::load_intra_context(s, io.bd, g.wm, r, c, io.gy, io.gu, io.gv, b, tid);
  if (tid == 128) predict_vectors(io, g, r, c, at, al, atl, atr, vec);
  fw::inter_sync();
  iw::intra_context_sums(s, tid);
  fw::inter_sync();

  // ---- costs: I16x16 and chroma modes; the inter candidates ----
  int32_t pr[4], cpr[4];
  iw::intra_mode_costs(s, ln, at, al, tid, pr, cpr);
  const int32_t mvp_y = vec[0], mvp_x = vec[1];
  const int32_t skip_y = vec[2], skip_x = vec[3];
  const int32_t me_y = io.mv_me[2 * b], me_x = io.mv_me[2 * b + 1];
  const int y0 = r * 16 + kPad, x0 = c * 16 + kPad;
  const int32_t s_y = s.src[y * 16 + x];
  // this thread's sample of each candidate: ME, skip, 16x8 (half y / 8),
  // 8x16 (half x / 8), P_8x8 (its quadrant)
  int32_t cand[5];
  cand[0] = mc_luma_sample(io.planes, prm, g, y0, x0, me_y, me_x, y, x, 16,
                           16);
  cand[1] = mc_luma_sample(io.planes, prm, g, y0, x0, skip_y, skip_x, y, x,
                           16, 16);
  int n_cand = 2;
  if (parts) {
    const int h = y >> 3, v = x >> 3;
    cand[2] = mc_luma_sample(io.planes, prm, g, y0 + 8 * h, x0, mp[2 * h],
                             mp[2 * h + 1], y - 8 * h, x, 8, 16);
    cand[3] = mc_luma_sample(io.planes, prm, g, y0, x0 + 8 * v,
                             mp[4 + 2 * v], mp[5 + 2 * v], y, x - 8 * v, 16,
                             8);
    n_cand = 4;
    if (p8x8) {
      const int q = 2 * h + v;
      cand[4] = mc_luma_sample(io.planes, prm, g, y0 + 8 * h, x0 + 8 * v,
                               mp[8 + 2 * q], mp[9 + 2 * q], y & 7, x & 7, 8,
                               8);
      n_cand = 5;
    }
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k < n_cand) {                  // uniform over the block
      const int32_t t = iv::warp_satd(s_y - cand[k], p);
      if ((tid & 31) == 0) isum[k][tid >> 5] = t;
    }
  }
  fw::inter_sync();

  // ---- the choices, by every thread alike ----
  int32_t j16;
  int best16, bestc;
  iw::intra_choices(s, at, al, atl, j16, best16, bestc);
  int32_t satd[5] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k < n_cand) {
#pragma unroll
      for (int w = 0; w < 8; ++w) satd[k] += isum[k][w];
    }
  }
  const int32_t j_me =
      satd[0] + prm.lam_me * mv_cost(me_y - mvp_y, me_x - mvp_x);
  // bias skip slightly (its true rate is ~0 when the residual is empty)
  const int32_t j_skip =
      satd[1] + prm.lam_me * mv_cost(skip_y - mvp_y, skip_x - mvp_x) -
      prm.lam4;
  const bool use_skip = j_skip < j_me;
  int32_t mv_y = use_skip ? skip_y : me_y;
  int32_t mv_x = use_skip ? skip_x : me_x;
  int32_t j_inter = use_skip ? j_skip : j_me;
  int32_t ipred = use_skip ? cand[1] : cand[0];
  int ptype = 0;
  int32_t mv2_y = mv_y, mv2_x = mv_x;
  if (parts) {
    // 16x8 / 8x16: part0 rated against the MB predictor, part1 against
    // part0, + ue(mb_type); the 16x8 shape wins a tie between the two
    const int32_t j_16x8 =
        satd[2] + prm.lam_me * (mv_cost(mp[0] - mvp_y, mp[1] - mvp_x) +
                                mv_cost(mp[2] - mp[0], mp[3] - mp[1]) + 3);
    const int32_t j_8x16 =
        satd[3] + prm.lam_me * (mv_cost(mp[4] - mvp_y, mp[5] - mvp_x) +
                                mv_cost(mp[6] - mp[4], mp[7] - mp[5]) + 3);
    if (j_16x8 < j_inter && j_16x8 <= j_8x16) {
      ptype = 1;
    } else if (j_8x16 < j_inter && j_8x16 < j_16x8) {
      ptype = 2;
    }
    if (ptype) {
      const int32_t* m2 = mp + 4 * (ptype - 1);
      j_inter = ptype == 1 ? j_16x8 : j_8x16;
      ipred = ptype == 1 ? cand[2] : cand[3];
      mv_y = m2[0];
      mv_x = m2[1];
      mv2_y = m2[2];
      mv2_x = m2[3];
    }
    if (p8x8) {
      // P_8x8: q0 against the MB predictor, later quadrants against their
      // raster-order sibling, + ue(mb_type) + 4 ue(sub_mb_type) = 9 bits
      const int32_t* q = mp + 8;
      const int32_t j_p8 =
          satd[4] + prm.lam_me * (mv_cost(q[0] - mvp_y, q[1] - mvp_x) +
                                  mv_cost(q[2] - q[0], q[3] - q[1]) +
                                  mv_cost(q[4] - q[0], q[5] - q[1]) +
                                  mv_cost(q[6] - q[2], q[7] - q[3]) + 9);
      if (j_p8 < j_inter) {
        ptype = 3;
        j_inter = j_p8;
        ipred = cand[4];
        mv_y = q[0];
        mv_x = q[1];
        mv2_y = q[2];
        mv2_x = q[3];
      }
    }
  }
  fw::join();                        // the Intra4x4 results are in i4o
  const int32_t j4 = i4o.j4;
  const bool sel16 = j16 < j4;
  // intra pays the larger mb_type cost in P slices
  const bool is_inter = j_inter < (j16 < j4 ? j16 : j4) + prm.lam24;
  const bool luma_tx = is_inter || sel16;        // a luma residual to code
  // the 8x8 transform is weighed on a 16x16 inter lane only
  const bool t8_lane = (prm.tools & kT8) && is_inter && ptype == 0;
  const int32_t lpred = is_inter ? ipred : iw::pick4(pr, best16);
  if (luma_tx) res[blk][p] = s_y - lpred;
  if (t8_lane) pred8[y * 16 + x] = lpred;
  int32_t cpred = 0;
  if (tid < 128) {
    if (is_inter) {
      // this sample's partition: its origin, vector and block size
      const int cy = ln.cy, cx = ln.cx;
      int oy = 0, ox = 0, bh = 8, bw = 8;
      int32_t my = mv_y, mx = mv_x;
      if (ptype == 1) {
        oy = cy & 4;
        bh = 4;
      } else if (ptype == 2) {
        ox = cx & 4;
        bw = 4;
      } else if (ptype == 3) {
        oy = cy & 4;
        ox = cx & 4;
        bh = bw = 4;
      }
      if (ptype == 3) {
        const int q = (oy >> 1) + (ox >> 2);
        my = mp[8 + 2 * q];
        mx = mp[9 + 2 * q];
      } else if (oy | ox) {
        my = mv2_y;
        mx = mv2_x;
      }
      cpred = iv::mc_chroma_sample(comp ? io.cv_pad : io.cu_pad, g,
                               r * 8 + kPad / 2 + oy, c * 8 + kPad / 2 + ox,
                               my, mx, cy - oy, cx - ox, bh, bw);
    } else {
      cpred = iw::pick4(cpr, bestc);
    }
    res[16 + comp * 4 + cb][p] =
        s.csrc[comp * 64 + ln.cy * 8 + ln.cx] - cpred;
  }
  fw::inter_sync();
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
  fw::inter_sync();

  // ---- the DC transforms ----
  if (sel16 && !is_inter && tid == 0) {
    iw::luma_dc_transform(dcs, dclev, prm.luma);
  } else if (tid == 32 || tid == 33) {
    const int cmp = tid - 32;
    iw::chroma_dc_transform(cdcs + 4 * cmp, prm.chroma, fc,
                            io.chroma_dc + (b * 2 + cmp) * 4);
  }
  fw::inter_sync();

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
  fw::inter_sync();

  // ---- the 8x8 transform and its choice (a 16x16 inter lane) ----
  bool t8_sel = false;
  if (t8_lane) {
    const int k8 = (tid >> 3) & 3, i8 = tid & 7;      // block, row / column
    const int o8 = (k8 >> 1) * 128 + (k8 & 1) * 8;    // its raster origin
    int32_t v[8];
    if (tid < 32) {
      // forward: row i8, then column i8
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at8 = o8 + i8 * 16 + j;
        v[j] = s.src[at8] - pred8[at8];
      }
      fwd8(v);
#pragma unroll
      for (int j = 0; j < 8; ++j) pass8[k8][i8][j] = v[j];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = pass8[k8][j][i8];
      fwd8(v);
#pragma unroll
      for (int j = 0; j < 8; ++j) coef8[k8 * 64 + j * 8 + i8] = v[j];
    }
    fw::inter_sync();
    {
      // quantiser and dequantiser, one thread a coefficient
      const int pos = tid & 63;
      const int32_t w8 = coef8[tid];
      int32_t l = (iw::iabs(w8) * prm.mf8[pos] + prm.f8) >> prm.qbits8;
      l = w8 < 0 ? -l : (w8 > 0 ? l : 0);
      lev8[tid] = l;
      const int32_t lv8 = l * prm.v8[pos];
      coef8[tid] = prm.qdiv6 >= 2
                       ? lv8 << (prm.qdiv6 - 2)
                       : (lv8 + (1 << (1 - prm.qdiv6))) >> (2 - prm.qdiv6);
    }
    fw::inter_sync();
    if (tid < 32) {
      // inverse: row i8, then column i8
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = coef8[k8 * 64 + i8 * 8 + j];
      inv8(v);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) pass8[k8][i8][j] = v[j];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = pass8[k8][j][i8];
      inv8(v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at8 = o8 + j * 16 + i8;
        rec8[at8] = iw::clip255(pred8[at8] + ((v[j] + 32) >> 6));
      }
    }
    fw::inter_sync();
    {
      // this sample's share of both transforms' SSD and bits
      const int32_t d4 = s_y - iw::clip255(lpred + res[blk][p]);
      const int32_t d8 = s_y - rec8[y * 16 + x];
      const int32_t part[4] = {d4 * d4, coeff_bits(lev[tid >> 4][tid & 15]),
                               d8 * d8, coeff_bits(lev8[tid])};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int32_t t = iv::warp_sum(part[k]);
        if ((tid & 31) == 0) tsum[k][tid >> 5] = t;
      }
      const unsigned nz = __ballot_sync(iw::kFull, lev8[tid] != 0);
      if ((tid & 31) == 0) tsum[4][tid >> 5] = nz != 0;
    }
    fw::inter_sync();
    int32_t tot[5] = {0, 0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
#pragma unroll
      for (int w = 0; w < 8; ++w) tot[k] += tsum[k][w];
    }
    // SSD + lambda x bits, rounded once (the reference's multiply-add);
    // the SSDs (< 2^24) and bit sums convert to float32 exactly
    const float j4x4 = __fmaf_rn(prm.lam_ssd, (float)tot[1], (float)tot[0]);
    const float j8x8 = __fmaf_rn(prm.lam_ssd, (float)tot[3], (float)tot[2]);
    t8_sel = j8x8 < j4x4 && tot[4] > 0;
  }

  // ---- results: levels, reconstruction, border scatter, maps ----
  {
    // luma_ac [16 blocks in coding order][16 scan positions]; an 8x8
    // block's scan goes to its four pseudo-4x4 blocks interleaved
    // (coefficient 4n + i of the scan is coefficient n of block i)
    const int n4 = tid >> 4;
    const int32_t lv =
        t8_sel ? lev8[(n4 >> 2) * 64 + prm.zigzag8[4 * p + (n4 & 3)]]
               : (luma_tx ? lev[prm.blk_raster[blk]][prm.zigzag[p]]
                          : i4o.coeffs4[tid]);
    io.luma_ac[b * 256 + tid] = lv;
    const int32_t rec = t8_sel ? rec8[y * 16 + x]
                               : (luma_tx ? iw::clip255(lpred + res[blk][p])
                                          : i4o.mb4[y * 16 + x]);
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
  iw::store_mode_tiles(io.bd, g.wm, r, c, tid, luma_tx, i4o.modebuf);
  if (tid == 96) {
    io.is_inter[b] = is_inter ? 1 : 0;
    io.sel16[b] = is_i16 ? 1 : 0;
    io.i16mode[b] = best16;
    io.cmode[b] = bestc;
    io.mv[2 * b] = mv_y;
    io.mv[2 * b + 1] = mv_x;
    io.mv_pred[2 * b] = mvp_y;
    io.mv_pred[2 * b + 1] = mvp_x;
    io.mv_skip[2 * b] = skip_y;
    io.mv_skip[2 * b + 1] = skip_x;
    if (io.ptype) {
      io.ptype[b] = is_inter ? ptype : 0;
      io.mv2[2 * b] = mv2_y;
      io.mv2[2 * b + 1] = mv2_x;
    }
    if (io.t8) io.t8[b] = t8_sel ? 1 : 0;
  } else if (tid >= 160 && tid < 163) {
    // the three cells of this macroblock in the maps (row hm + 1 takes the
    // padding lanes' writes): top-right (A of the right MB; 16x8 part0,
    // 8x16 part1, quadrant 1), bottom-left (B and C below; 16x8 part1,
    // 8x16 part0, quadrant 2), bottom-right (D below; part1, quadrant 3)
    const int ch = tid - 160;
    const bool second = ch == 0 ? ptype == 2 : (ch == 1 ? ptype == 1
                                                        : ptype > 0);
    int32_t cy = second ? mv2_y : mv_y, cx = second ? mv2_x : mv_x;
    if (ptype == 3) {
      cy = mp[10 + 2 * ch];
      cx = mp[11 + 2 * ch];
    }
    const int cell = (ch * (g.hm + 2) + r + 1) * (g.wm + 2) + c + 1;
    io.mv_map[2 * cell] = is_inter ? cy : 0;
    io.mv_map[2 * cell + 1] = is_inter ? cx : 0;
    io.ref_map[cell] = is_inter ? 0 : kIntra;
  } else if (tid >= 192 && tid < 200 && io.mvq) {
    io.mvq[8 * b + tid - 192] = mp[8 + tid - 192];
  }
}

__global__ void __launch_bounds__(fw::kThreads, 1) p_frame_kernel(
    FrameIo io, PParams prm, i4::Params i4p, Geometry g, int bmax, int w0,
    int w1) {
  __shared__ i4::Smem s4;
  __shared__ fw::I4Out i4o;
  fw::frame_loop(io.bd, g.wm, io.coords, io.avail, io.gy, io.modes, i4p,
                 bmax, w0, w1, s4, i4o, [&](int b, int tid) {
                   p_lane(io, prm, g, i4o, b, tid);
                 });
}

}  // namespace

// `ptrs` holds the device pointers of a picture in the order of `FrameIo`;
// `params` is the host int32 array that `kernels/p_wave.py` packs: K3's
// wave-form table (for luma, then for chroma, mf[16] lim[16] v[16] f qbits
// qshift mf00 v00 lim_dc qp; then zigzag[16] blk_raster[16]), then the
// inter rounding offsets of luma and chroma, lam4, lam24, lam_me, the
// quarter-pel table [16][7], the tools, mf8[64] v8[64] zigzag8[64] f8
// qbits8 qp/6, the bits of the float32 lambda, and the luma weight and
// offset; `i4params` K2's table (`i4::load_params`).  `geom` is wm, hm,
// hp, wp, hc, wc.  Runs waves [w0, w1) of bmax lanes on `grid` blocks (at
// most `tpu264_p_frame_blocks`).
extern "C" int tpu264_p_frame(void* const* ptrs, const int32_t* params,
                              const int32_t* i4params, const int32_t* geom,
                              int bmax, int w0, int w1, int grid,
                              void* stream) {
  static_assert(sizeof(FrameIo) == kPtrs * sizeof(void*), "FrameIo layout");
  static_assert(sizeof(FrameIo) + sizeof(PParams) + sizeof(i4::Params) +
                        sizeof(Geometry) + 3 * sizeof(int) <=
                    4096,
                "kernel parameters");
  FrameIo io;
  std::memcpy(&io, ptrs, sizeof(io));
  PParams prm;
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
  prm.tools = *q++;
  for (int i = 0; i < 64; ++i) prm.mf8[i] = *q++;
  for (int i = 0; i < 64; ++i) prm.v8[i] = *q++;
  for (int i = 0; i < 64; ++i) prm.zigzag8[i] = (uint8_t)*q++;
  prm.f8 = *q++;
  prm.qbits8 = *q++;
  prm.qdiv6 = *q++;
  std::memcpy(&prm.lam_ssd, q++, sizeof(float));
  prm.wy = *q++;
  prm.oy = *q++;
  i4::Params i4p;
  i4::load_params(i4p, i4params);
  Geometry g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5]};
  if (w1 <= w0 || bmax <= 0) return (int)cudaGetLastError();
  void* args[] = {&io, &prm, &i4p, &g, &bmax, &w0, &w1};
  return fw::launch(p_frame_kernel, grid, args, stream);
}

// The most blocks of KP that the card holds at once (0: no cooperative
// launch), the largest grid `tpu264_p_frame` may take.
extern "C" int tpu264_p_frame_blocks(int* blocks) {
  return fw::co_resident(p_frame_kernel, blocks);
}
