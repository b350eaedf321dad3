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
// design gives each macroblock lane of the wave one CUDA block of 160
// threads, which runs the lane's search as `i4x4_body.cuh` lays it out
// (the macroblock in shared memory for all 16 steps, two block barriers a
// step).  The same body runs inside the frame kernels KP and KB
// (`p_wave.cu`, `b_wave.cu`) on P and B pictures; this kernel serves the
// I pictures.
//
// Two C entries launch the same kernel: `tpu264_i4x4_wave` takes a lane's
// neighbour context as gathered per-lane arrays, `tpu264_i4x4_wave_bd`
// (what the wave loop calls) lets the lane read it from the loop's border
// buffers at its own coordinates (`CtxLayout`), which saves the gather.

#include <cstdint>
#include <cuda_runtime.h>

#include "i4x4_body.cuh"

namespace {

// Where a lane's context lies.  Without `coords` the four context inputs
// are per-lane arrays ([B,25], [B,16], [B,4], [B,4]).  With `coords` [B,2] =
// (r, c) they are the wave loop's border buffers, and the lane reads what
// `gather_border_ctx` would gather: row_y[r, 16c : 16c + 25], col_y[r],
// modes_row[r, 4c + 1 : 4c + 5], modes_col[r].
struct CtxLayout {
  const int32_t* coords;
  int row_stride, mrow_stride;    // row lengths of row_y and modes_row
};

__global__ void __launch_bounds__(i4::kThreads) i4x4_wave_kernel(
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
    i4::Params prm,
    int32_t* __restrict__ recon,              // [B,16,16]
    int32_t* __restrict__ mode_grid,          // [B,4,4]
    int32_t* __restrict__ modes_zz,           // [B,16]
    int32_t* __restrict__ coeffs,             // [B,16,16]
    int32_t* __restrict__ cost) {             // [B]
  __shared__ i4::Smem s;
  const int b = blockIdx.x;
  i4::Lane ln;
  if (ctx.coords != nullptr) {
    const int mr = ctx.coords[2 * b], mc = ctx.coords[2 * b + 1];
    ln.ltop = ltop + mr * ctx.row_stride + 16 * mc;
    ln.lleft = lleft + mr * 16;
    ln.modes_top = modes_top + mr * ctx.mrow_stride + 4 * mc + 1;
    ln.modes_left = modes_left + mr * 4;
  } else {
    ln.ltop = ltop + b * 25;
    ln.lleft = lleft + b * 16;
    ln.modes_top = modes_top + b * 4;
    ln.modes_left = modes_left + b * 4;
  }
  ln.orig = orig + (int64_t)b * 256;
  ln.at = at[(int64_t)b * at_stride] != 0;
  ln.al = al[(int64_t)b * al_stride] != 0;
  ln.atl = atl[(int64_t)b * atl_stride] != 0;
  ln.atr = atr[(int64_t)b * atr_stride] != 0;
  ln.recon = recon + (int64_t)b * 256;
  ln.mode_grid = mode_grid + b * 16;
  ln.modes_zz = modes_zz + b * 16;
  ln.coeffs = coeffs + (int64_t)b * 256;
  ln.cost = cost + b;
  i4::body(s, prm, ln, threadIdx.x, i4::BlockSync());
}

}  // namespace

// `params` is the host int32 array that `kernels/i4x4_wave.py` packs
// (`i4::load_params`).
static int launch_i4x4_wave(
    const int32_t* orig, const int32_t* ltop, const int32_t* lleft,
    const int32_t* modes_top, const int32_t* modes_left, CtxLayout ctx,
    const uint8_t* at, int at_stride, const uint8_t* al, int al_stride,
    const uint8_t* atl, int atl_stride, const uint8_t* atr, int atr_stride,
    const int32_t* params, int32_t* recon, int32_t* mode_grid,
    int32_t* modes_zz, int32_t* coeffs, int32_t* cost, int n_mbs,
    void* stream) {
  i4::Params prm;
  i4::load_params(prm, params);
  if (n_mbs > 0) {
    i4x4_wave_kernel<<<n_mbs, i4::kThreads, 0, (cudaStream_t)stream>>>(
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
