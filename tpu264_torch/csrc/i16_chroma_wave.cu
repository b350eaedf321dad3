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
//   costs: the I16x16 and chroma mode searches of `intra_wave.cuh`, which
//     the P wave kernel (`p_wave.cu`) shares;
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
//
// The batched all-intra entry codes a chunk of F pictures of one geometry
// at once: one launch covers the wave in all F pictures, the picture in
// `blockIdx.y`.  The pictures share the wave's coordinates and
// availability; every other pointer moves by a byte stride a picture that
// the host gives (`FrameStep`, 0 for the shared ones).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "intra_wave.cuh"
#include "transform4x4.cuh"

namespace {

using iw::kThreads;

struct BodyParams {
  iw::QuantSet luma, chroma;
  uint8_t zigzag[16];      // scan position -> raster position
  uint8_t blk_raster[16];  // 4x4 block in coding order -> by * 4 + bx
};

// the pointers of one wave, in the order of the C entry's `ptrs`
struct WaveIo {
  iw::Borders bd;                   // border buffers
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

// byte strides from picture f to picture f + 1 of each pointer of `WaveIo`
struct FrameStep {
  int64_t bytes[kPtrs];
};

// the pointers of picture f of the chunk
__device__ __forceinline__ WaveIo frame_io(const WaveIo& io0,
                                           const FrameStep& fs, int64_t f) {
  char* p[kPtrs];
  memcpy(p, &io0, sizeof(p));
#pragma unroll
  for (int i = 0; i < kPtrs; ++i) p[i] += f * fs.bytes[i];
  WaveIo io;
  memcpy(&io, p, sizeof(io));
  return io;
}

__global__ void __launch_bounds__(kThreads) i16_chroma_wave_kernel(
    WaveIo io0, FrameStep fs, BodyParams prm, int wm) {
  __shared__ iw::IntraSmem s;
  __shared__ int32_t res[24][16];     // per 4x4 block (16 luma, 4 U, 4 V)
  __shared__ int32_t lev[24][16];
  __shared__ int32_t dcs[16], cdcs[8];   // DC coefficients; dequantised DCs
  __shared__ int32_t dclev[16];

  const WaveIo io = frame_io(io0, fs, blockIdx.y);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int r = io.coords[2 * b], c = io.coords[2 * b + 1];
  const bool at = io.avail[4 * b] != 0, al = io.avail[4 * b + 1] != 0,
             atl = io.avail[4 * b + 2] != 0;
  const iw::Lane ln(tid);

  // ---- the neighbour context from the border buffers, the source ----
  iw::load_intra_context(s, io.bd, wm, r, c, io.gy, io.gu, io.gv, b, tid);
  __syncthreads();
  iw::intra_context_sums(s, tid);
  __syncthreads();

  // ---- the four I16x16 and chroma predictions of this thread's samples,
  // and the modes' SATD ----
  int32_t pr[4], cpr[4];
  iw::intra_mode_costs(s, ln, at, al, tid, pr, cpr);
  __syncthreads();

  // ---- the choices, by every thread alike ----
  int32_t j16;
  int best16, bestc;
  iw::intra_choices(s, at, al, atl, j16, best16, bestc);
  const bool sel16 = j16 < io.j4[b];
  const int32_t pred = iw::pick4(pr, best16);
  const int32_t cpred = iw::pick4(cpr, bestc);
  const int blk = ln.blk, p = ln.p, comp = ln.comp, cb = ln.cb;
  if (sel16) res[blk][p] = s.src[ln.y * 16 + ln.x] - pred;
  if (tid < 128)
    res[16 + comp * 4 + cb][p] = s.csrc[comp * 64 + ln.cy * 8 + ln.cx] - cpred;
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
    iw::luma_dc_transform(dcs, dclev, prm.luma);
  } else if (tid == 32 || tid == 33) {
    const int cmp = tid - 32;
    iw::chroma_dc_transform(cdcs + 4 * cmp, prm.chroma, prm.chroma.f,
                            io.chroma_dc + (b * 2 + cmp) * 4);
  }
  __syncthreads();

  // ---- AC quantiser, dequantiser, inverse transform ----
  if (lblk) {
    iw::quant_recon(w, prm.luma, prm.luma.f, dcs[tid], lev[slot]);
#pragma unroll
    for (int i = 0; i < 16; ++i) res[slot][i] = w[i];
  } else if (cblk) {
    iw::quant_recon(w, prm.chroma, prm.chroma.f, cdcs[tid - 32], lev[slot]);
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
    const int y = ln.y, x = ln.x;
    const int32_t rec = sel16 ? iw::clip255(pred + res[blk][p])
                              : io.mb4[b * 256 + y * 16 + x];
    io.recon_mb[b * 256 + y * 16 + x] = rec;
    iw::store_luma_border(io.bd, wm, r, c, y, x, rec);
  }
  if (tid < 128) {
    io.chroma_ac[b * 128 + tid] = lev[16 + comp * 4 + cb][prm.zigzag[p]];
    const int32_t rec = iw::clip255(cpred + res[16 + comp * 4 + cb][p]);
    (comp ? io.rec_v : io.rec_u)[b * 64 + ln.cy * 8 + ln.cx] = rec;
    iw::store_chroma_border(io.bd, wm, r, c, comp, ln.cy, ln.cx, rec);
  }
  if (tid < 16) io.luma_dc[b * 16 + tid] = sel16 ? dclev[prm.zigzag[tid]] : 0;
  // an I16x16 macroblock shows its neighbours the mode -1
  iw::store_mode_tiles(io.bd, wm, r, c, tid, sel16, io.modebuf + b * 16);
  if (tid == 96) {
    io.sel16[b] = sel16 ? 1 : 0;
    io.i16mode[b] = best16;
    io.cmode[b] = bestc;
  }
}

}  // namespace

// `ptrs` holds the device pointers of one wave of the chunk's first
// picture in the order of `WaveIo`, `fstride` (host, int64[27]) the byte
// strides from one picture's to the next's; `params` is the host int32
// array that `kernels/i16_chroma_wave.py` packs: for luma, then for
// chroma, mf[16] lim[16] v[16] f qbits qshift mf00 v00 lim_dc qp; then
// zigzag[16] blk_raster[16].  `wm` is the pictures' width in macroblocks,
// which fixes the border buffers' row lengths.
extern "C" int tpu264_i16_chroma_wave(void* const* ptrs, const int32_t* params,
                                      int n_mbs, int wm, int n_frames,
                                      const int64_t* fstride, void* stream) {
  static_assert(sizeof(WaveIo) == kPtrs * sizeof(void*), "WaveIo layout");
  WaveIo io;
  std::memcpy(&io, ptrs, sizeof(io));
  FrameStep fs;
  std::memcpy(&fs, fstride, sizeof(fs));
  BodyParams prm;
  const int32_t* q = params;
  iw::load_quant_set(prm.luma, q);
  iw::load_quant_set(prm.chroma, q);
  for (int i = 0; i < 16; ++i) prm.zigzag[i] = (uint8_t)*q++;
  for (int i = 0; i < 16; ++i) prm.blk_raster[i] = (uint8_t)*q++;
  if (n_mbs > 0 && n_frames > 0) {
    const dim3 grid(n_mbs, n_frames);
    i16_chroma_wave_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        io, fs, prm, wm);
  }
  return (int)cudaGetLastError();
}
