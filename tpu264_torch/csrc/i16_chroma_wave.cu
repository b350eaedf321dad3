// Kernel K3, wave form: the Intra16x16 and chroma part of the intra wave
// body, its merge with the Intra4x4 result and the border scatter, for one
// macroblock wave in one launch.
//
// Replaces tpu264/kernels/pallas_kernels.py `_dct_kernel` (K3) as the
// all-intra path uses it: the port ran that forward DCT three times a wave
// (the I16x16 residual, U, V) in the middle of `eval_i16`, `eval_chroma`,
// the I4x4 / I16x16 merge and `update_border_ctx`
// (`tpu264/coding/intra_frame.py`), each of which is tens of small array
// operations.  Here all of that is one kernel, which also reads its
// neighbour context straight from the border buffers and writes its results
// into the frame's per-wave output arrays.
//
// What bounds it on the card: not bytes (a macroblock reads about 3 KB and
// writes about 5 KB) and not arithmetic, but the chain of a few dependent
// phases, each ended by a block barrier: context sums, mode costs, choice,
// transform, DC transform, quantise + reconstruct, store.  There is no
// 16-step chain as in the I4x4 body: once the mode is chosen every 4x4
// block is independent.  The design gives each macroblock lane one block of
// 256 threads:
//   costs: thread (blk, p) owns sample p of 4x4 block blk, so that the 16
//     samples of a block sit in 16 neighbouring lanes; it forms its sample
//     of the four 16x16 predictions, and a 16-lane shuffle Hadamard plus a
//     warp sum give the SATD with the DC term taken out (JM's
//     `find_sad_16x16`); threads 0-127 do the same for the four chroma
//     modes over U and V;
//   transform: one thread a 4x4 block (16 luma, 8 chroma) runs K3's
//     arithmetic (`t4x4::fdct4x4`) in registers; one thread takes the 4x4
//     Hadamard of the luma DCs with its quantiser and inverse, two the 2x2
//     of U and V; the block threads quantise the AC, dequantise, invert and
//     leave the residual in shared memory;
//   store: every thread clips and writes its sample, and the macroblock's
//     last row and column go into the border buffers.
// The I16x16 transform path runs only in a lane that chooses I16x16 (the
// plain version computes it for every lane and discards it).  All
// arithmetic is int32 with arithmetic shifts, equal to the plain torch
// version bit for bit; ties between modes go to the lowest mode number.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "transform4x4.cuh"

namespace {

constexpr int kBig = 1 << 28;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct QuantSet {
  int32_t mf[16];        // MF[qp % 6], raster
  int32_t lim[16];       // AC level limit per position for this qp
  int32_t v[16];         // V[qp % 6], raster (dequant)
  int32_t f, qbits, qshift;    // 2^qbits / 3, 15 + qp / 6, qp / 6
  int32_t mf00, v00;     // the (0, 0) entries, for the DC transforms
  int32_t lim_dc;        // DC level limit (4x4 luma set, 2x2 chroma set)
  int32_t qp;
};

struct BodyParams {
  QuantSet luma, chroma;
  uint8_t zigzag[16];      // scan position -> raster position
  uint8_t blk_raster[16];  // 4x4 block in coding order -> by * 4 + bx
};

// the pointers of one wave, in the order of the C entry's `ptrs`
struct WaveIo {
  int32_t *row_y, *col_y, *row_u, *col_u, *row_v, *col_v;   // border buffers
  int32_t *modes_row, *modes_col;
  const int32_t* coords;            // [B,2] (r, c)
  const uint8_t* avail;             // [B,4] top, left, top-left, top-right
  const int32_t *gy, *gu, *gv;      // source [B,16,16], [B,8,8] x 2
  const int32_t *mb4, *modebuf, *coeffs4, *j4;   // the I4x4 body's results
  uint8_t* sel16;                   // [B]
  int32_t *i16mode, *cmode;         // [B]
  int32_t *luma_ac, *luma_dc;       // [B,16,16], [B,16]
  int32_t *chroma_dc, *chroma_ac;   // [B,2,4], [B,2,4,16]
  int32_t *recon_mb, *rec_u, *rec_v;
};
constexpr int kPtrs = 27;

__device__ __forceinline__ int32_t iabs(int32_t v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int32_t clip255(int32_t v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// DC prediction from the sums of 2^sh samples above and to the left
__device__ __forceinline__ int32_t dc_rule(bool at, bool al, int32_t st,
                                           int32_t sl, int sh) {
  if (at && al) return (st + sl + (1 << sh)) >> (sh + 1);
  if (at) return (st + (1 << (sh - 1))) >> sh;
  if (al) return (sl + (1 << (sh - 1))) >> sh;
  return 128;
}

// 16-point Walsh-Hadamard over 16 neighbouring lanes: the 2-D 4x4 Hadamard
// up to the order of its outputs; lane p = 0 ends with the DC term
__device__ __forceinline__ int32_t wht16(int32_t d, int p) {
#pragma unroll
  for (int s = 1; s < 16; s <<= 1) {
    const int32_t o = __shfl_xor_sync(kFull, d, s);
    d = (p & s) ? o - d : d + o;
  }
  return d;
}

__device__ __forceinline__ int32_t pick4(const int32_t (&v)[4], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

// first minimum of four costs (the lowest mode wins a tie)
__device__ __forceinline__ int first_min4(const int32_t (&j)[4],
                                          int32_t& best_cost) {
  int best = 0;
  best_cost = j[0];
#pragma unroll
  for (int m = 1; m < 4; ++m) {
    if (j[m] < best_cost) {
      best_cost = j[m];
      best = m;
    }
  }
  return best;
}

// AC levels of the transformed block w (position 0 zeroed) into lev_out,
// then dequantise, put the dequantised DC in, invert: w = the residual
__device__ __forceinline__ void quant_recon(int32_t (&w)[16],
                                            const QuantSet& q, int32_t dc_deq,
                                            int32_t* lev_out) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int32_t lev =
        i == 0 ? 0 : t4x4::quant1(w[i], q.mf[i], q.f, q.qbits, q.lim[i]);
    lev_out[i] = lev;
    w[i] = (lev * q.v[i]) << q.qshift;
  }
  w[0] = dc_deq;
  t4x4::idct4x4(w);
}

__global__ void __launch_bounds__(kThreads) i16_chroma_wave_kernel(
    WaveIo io, BodyParams prm, int wm) {
  __shared__ int32_t ltop[25], lleft[16];       // luma context row, column
  __shared__ int32_t ctop[2][9], cleft[2][8];   // U, V
  __shared__ int32_t src[256], csrc[128];
  __shared__ int32_t sums16[4];                 // st, sl, plane H, plane V
  __shared__ int32_t csums[2][6];               // st0 st1 sl0 sl1, plane H V
  __shared__ int32_t wsum[4][8];                // I16 mode x warp
  __shared__ int32_t bsum[4][8];                // chroma mode x 4x4 block
  __shared__ int32_t res[24][16];     // per 4x4 block (16 luma, 4 U, 4 V)
  __shared__ int32_t lev[24][16];
  __shared__ int32_t dcs[16], cdcs[8];   // DC coefficients; dequantised DCs
  __shared__ int32_t dclev[16];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int r = io.coords[2 * b], c = io.coords[2 * b + 1];
  const int rs = 1 + 16 * wm + 8, crs = 1 + 8 * wm + 8, mrs = 1 + 4 * wm + 4;
  const bool at = io.avail[4 * b] != 0, al = io.avail[4 * b + 1] != 0,
             atl = io.avail[4 * b + 2] != 0;
  const bool plane_ok = at && al && atl;

  // ---- the neighbour context from the border buffers, the source ----
  if (tid < 25) {
    ltop[tid] = io.row_y[r * rs + 16 * c + tid];
  } else if (tid >= 32 && tid < 48) {
    lleft[tid - 32] = io.col_y[r * 16 + tid - 32];
  } else if (tid >= 64 && tid < 82) {
    const int comp = (tid - 64) / 9, i = (tid - 64) % 9;
    ctop[comp][i] = (comp ? io.row_v : io.row_u)[r * crs + 8 * c + i];
  } else if (tid >= 96 && tid < 112) {
    const int comp = (tid - 96) >> 3, i = (tid - 96) & 7;
    cleft[comp][i] = (comp ? io.col_v : io.col_u)[r * 8 + i];
  }
  src[tid] = io.gy[b * 256 + tid];
  if (tid < 128) csrc[tid] = (tid < 64 ? io.gu : io.gv)[b * 64 + (tid & 63)];
  __syncthreads();

  // ---- sums of the context, one thread each, in different warps ----
  if (tid == 0 || tid == 32) {
    const int32_t* s = tid == 0 ? ltop + 1 : lleft;
    int32_t acc = 0;
    for (int i = 0; i < 16; ++i) acc += s[i];
    sums16[tid >> 5] = acc;
  } else if (tid == 64) {
    // ltop[k] = p[k - 1, -1]: the corner, then the row above
    int32_t acc = 0;
    for (int i = 1; i <= 8; ++i) acc += i * (ltop[8 + i] - ltop[8 - i]);
    sums16[2] = acc;
  } else if (tid == 96) {
    int32_t acc = 0;
    for (int i = 1; i <= 8; ++i)
      acc += i * (lleft[7 + i] - (i == 8 ? ltop[0] : lleft[7 - i]));
    sums16[3] = acc;
  } else if (tid == 128 || tid == 160) {
    const int comp = (tid - 128) >> 5;
    const int32_t* t = ctop[comp];
    const int32_t* l = cleft[comp];
    csums[comp][0] = t[1] + t[2] + t[3] + t[4];
    csums[comp][1] = t[5] + t[6] + t[7] + t[8];
    csums[comp][2] = l[0] + l[1] + l[2] + l[3];
    csums[comp][3] = l[4] + l[5] + l[6] + l[7];
    int32_t hh = 0, vv = 0;
    for (int i = 1; i <= 4; ++i) {
      hh += i * (t[4 + i] - t[4 - i]);
      vv += i * (l[3 + i] - (i == 4 ? t[0] : l[3 - i]));
    }
    csums[comp][4] = hh;
    csums[comp][5] = vv;
  }
  __syncthreads();

  // ---- I16x16: four predictions of this thread's sample, SATD ----
  const int blk = tid >> 4, p = tid & 15;
  const int y = 4 * (blk >> 2) + (p >> 2), x = 4 * (blk & 3) + (p & 3);
  const int32_t s_y = src[y * 16 + x];
  int32_t pr[4];         // V, H, DC, plane
  {
    pr[0] = ltop[1 + x];
    pr[1] = lleft[y];
    pr[2] = dc_rule(at, al, sums16[0], sums16[1], 4);
    const int32_t a = 16 * (lleft[15] + ltop[16]);
    const int32_t bb = (5 * sums16[2] + 32) >> 6;
    const int32_t cc = (5 * sums16[3] + 32) >> 6;
    pr[3] = clip255((a + bb * (x - 7) + cc * (y - 7) + 16) >> 5);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int32_t d = wht16(s_y - pr[m], p);
    int32_t t = p == 0 ? 0 : iabs(d);       // the block's DC term is left out
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) t += __shfl_xor_sync(kFull, t, s);
    if ((tid & 31) == 0) wsum[m][tid >> 5] = t;
  }

  // ---- chroma (threads 0-127): comp, 4x4 block, sample ----
  const int comp = (tid >> 6) & 1, cb = (tid >> 4) & 3;
  const int cy = 4 * (cb >> 1) + (p >> 2), cx = 4 * (cb & 1) + (p & 3);
  int32_t s_c = 0;
  int32_t cpr[4] = {0, 0, 0, 0};     // DC, H, V, plane
  if (tid < 128) {
    const int32_t* cs = csums[comp];
    s_c = csrc[comp * 64 + cy * 8 + cx];
    const int32_t st = cs[cx >> 2], sl = cs[2 + (cy >> 2)];
    if ((cx >> 2) == (cy >> 2)) {
      cpr[0] = dc_rule(at, al, st, sl, 2);
    } else if (cx >> 2) {              // top right quadrant prefers the top
      cpr[0] = at ? (st + 2) >> 2 : (al ? (sl + 2) >> 2 : 128);
    } else {                           // bottom left prefers the left
      cpr[0] = al ? (sl + 2) >> 2 : (at ? (st + 2) >> 2 : 128);
    }
    cpr[1] = cleft[comp][cy];
    cpr[2] = ctop[comp][1 + cx];
    const int32_t a = 16 * (cleft[comp][7] + ctop[comp][8]);
    const int32_t bb = (17 * cs[4] + 16) >> 5;
    const int32_t cc = (17 * cs[5] + 16) >> 5;
    cpr[3] = clip255((a + bb * (cx - 3) + cc * (cy - 3) + 16) >> 5);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      int32_t t = iabs(wht16(s_c - cpr[m], p));
#pragma unroll
      for (int s = 1; s < 16; s <<= 1) t += __shfl_xor_sync(kFull, t, s);
      if (p == 0) bsum[m][comp * 4 + cb] = (t + 1) >> 1;
    }
  }
  __syncthreads();

  // ---- the choices, by every thread alike ----
  int32_t j16;
  int best16, bestc;
  {
    const bool valid16[4] = {at, al, true, plane_ok};
    const bool validc[4] = {true, al, at, plane_ok};
    int32_t j[4], jc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      int32_t sat = 0, csat = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sat += wsum[m][k];
        csat += bsum[m][k];
      }
      j[m] = valid16[m] ? (sat + 1) >> 1 : kBig;
      jc[m] = validc[m] ? csat : kBig;
    }
    int32_t jcb;
    best16 = first_min4(j, j16);
    bestc = first_min4(jc, jcb);
  }
  const bool sel16 = j16 < io.j4[b];
  const int32_t pred = pick4(pr, best16);
  const int32_t cpred = pick4(cpr, bestc);
  if (sel16) res[blk][p] = s_y - pred;
  if (tid < 128) res[16 + comp * 4 + cb][p] = s_c - cpred;
  __syncthreads();

  // ---- forward transform, one thread a 4x4 block ----
  const bool lblk = sel16 && tid < 16;
  const bool cblk = tid >= 32 && tid < 40;
  const int slot = tid < 16 ? tid : 16 + ((tid - 32) & 7);
  int32_t w[16];
  if (lblk || cblk) {
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = res[slot][i];
    t4x4::fdct4x4(w);
    if (lblk) dcs[tid] = w[0];
    else cdcs[tid - 32] = w[0];
  }
  __syncthreads();

  // ---- the DC transforms ----
  if (sel16 && tid == 0) {
    const QuantSet& q = prm.luma;
    int32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = dcs[i];
    t4x4::hadamard4x4(m);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int32_t l = ((iabs(m[i]) >> 1) * q.mf00 + 2 * q.f) >> (q.qbits + 1);
      l = l < q.lim_dc ? l : q.lim_dc;
      l = m[i] < 0 ? -l : (m[i] > 0 ? l : 0);
      dclev[i] = l;
      m[i] = l;
    }
    t4x4::hadamard4x4(m);
    const int32_t ls = 16 * q.v00;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dcs[i] = q.qp >= 36
                   ? (m[i] * ls) << (q.qshift - 6)
                   : (m[i] * ls + (1 << (5 - q.qshift))) >> (6 - q.qshift);
    }
  } else if (tid == 32 || tid == 33) {
    const QuantSet& q = prm.chroma;
    const int cmp = tid - 32;
    const int32_t a = cdcs[cmp * 4], bq = cdcs[cmp * 4 + 1],
                  cq = cdcs[cmp * 4 + 2], d = cdcs[cmp * 4 + 3];
    int32_t m[4] = {a + bq + cq + d, a - bq + cq - d, a + bq - cq - d,
                    a - bq - cq + d};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int32_t l = (iabs(m[i]) * q.mf00 + 2 * q.f) >> (q.qbits + 1);
      l = l < q.lim_dc ? l : q.lim_dc;
      l = m[i] < 0 ? -l : (m[i] > 0 ? l : 0);
      io.chroma_dc[(b * 2 + cmp) * 4 + i] = l;
      m[i] = l;
    }
    const int32_t f[4] = {m[0] + m[1] + m[2] + m[3], m[0] - m[1] + m[2] - m[3],
                          m[0] + m[1] - m[2] - m[3], m[0] - m[1] - m[2] + m[3]};
    const int32_t ls = 16 * q.v00;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cdcs[cmp * 4 + i] = ((f[i] * ls) << q.qshift) >> 5;
  }
  __syncthreads();

  // ---- AC quantiser, dequantiser, inverse transform ----
  if (lblk) {
    quant_recon(w, prm.luma, dcs[tid], lev[slot]);
#pragma unroll
    for (int i = 0; i < 16; ++i) res[slot][i] = w[i];
  } else if (cblk) {
    quant_recon(w, prm.chroma, cdcs[tid - 32], lev[slot]);
#pragma unroll
    for (int i = 0; i < 16; ++i) res[slot][i] = w[i];
  }
  __syncthreads();

  // ---- results: levels, reconstruction, border scatter ----
  {
    // luma_ac [16 blocks in coding order][16 scan positions]
    const int32_t lv = sel16 ? lev[prm.blk_raster[blk]][prm.zigzag[p]]
                             : io.coeffs4[b * 256 + tid];
    io.luma_ac[b * 256 + tid] = lv;
    const int32_t rec = sel16 ? clip255(pred + res[blk][p])
                              : io.mb4[b * 256 + y * 16 + x];
    io.recon_mb[b * 256 + y * 16 + x] = rec;
    if (y == 15) io.row_y[(r + 1) * rs + 1 + 16 * c + x] = rec;
    if (x == 15) io.col_y[r * 16 + y] = rec;
  }
  if (tid < 128) {
    io.chroma_ac[b * 128 + tid] = lev[16 + comp * 4 + cb][prm.zigzag[p]];
    const int32_t rec = clip255(cpred + res[16 + comp * 4 + cb][p]);
    (comp ? io.rec_v : io.rec_u)[b * 64 + cy * 8 + cx] = rec;
    if (cy == 7)
      (comp ? io.row_v : io.row_u)[(r + 1) * crs + 1 + 8 * c + cx] = rec;
    if (cx == 7) (comp ? io.col_v : io.col_u)[r * 8 + cy] = rec;
  }
  if (tid < 16) io.luma_dc[b * 16 + tid] = sel16 ? dclev[prm.zigzag[tid]] : 0;
  // an I16x16 macroblock shows its neighbours the mode -1
  if (tid >= 32 && tid < 36) {
    const int i = tid - 32;
    io.modes_row[(r + 1) * mrs + 1 + 4 * c + i] =
        sel16 ? -1 : io.modebuf[b * 16 + 12 + i];
  } else if (tid >= 64 && tid < 68) {
    const int i = tid - 64;
    io.modes_col[r * 4 + i] = sel16 ? -1 : io.modebuf[b * 16 + 4 * i + 3];
  } else if (tid == 96) {
    io.sel16[b] = sel16 ? 1 : 0;
    io.i16mode[b] = best16;
    io.cmode[b] = bestc;
  }
}

void load_quant_set(QuantSet& q, const int32_t*& p) {
  for (int i = 0; i < 16; ++i) q.mf[i] = *p++;
  for (int i = 0; i < 16; ++i) q.lim[i] = *p++;
  for (int i = 0; i < 16; ++i) q.v[i] = *p++;
  q.f = *p++;
  q.qbits = *p++;
  q.qshift = *p++;
  q.mf00 = *p++;
  q.v00 = *p++;
  q.lim_dc = *p++;
  q.qp = *p++;
}

}  // namespace

// `ptrs` holds the device pointers of one wave in the order of `WaveIo`;
// `params` is the host int32 array that `kernels/i16_chroma_wave.py` packs:
// for luma, then for chroma, mf[16] lim[16] v[16] f qbits qshift mf00 v00
// lim_dc qp; then zigzag[16] blk_raster[16].  `wm` is the picture's width
// in macroblocks, which fixes the border buffers' row lengths.
extern "C" int tpu264_i16_chroma_wave(void* const* ptrs, const int32_t* params,
                                      int n_mbs, int wm, void* stream) {
  static_assert(sizeof(WaveIo) == kPtrs * sizeof(void*), "WaveIo layout");
  WaveIo io;
  std::memcpy(&io, ptrs, sizeof(io));
  BodyParams prm;
  const int32_t* q = params;
  load_quant_set(prm.luma, q);
  load_quant_set(prm.chroma, q);
  for (int i = 0; i < 16; ++i) prm.zigzag[i] = (uint8_t)*q++;
  for (int i = 0; i < 16; ++i) prm.blk_raster[i] = (uint8_t)*q++;
  if (n_mbs > 0) {
    i16_chroma_wave_kernel<<<n_mbs, kThreads, 0, (cudaStream_t)stream>>>(
        io, prm, wm);
  }
  return (int)cudaGetLastError();
}
