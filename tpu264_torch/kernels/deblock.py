"""Wavefront deblocking filter (torch), counterpart of
`tpu264.kernels.deblock` — bit-exact with `ref.deblock`.

The normative filter is sequential (each edge reads already-filtered
samples, MB raster order), but MB (r, c) depends only on MBs (r, c-1),
(r-1, c) and (r-1, c+1): the same anti-diagonal wavefront d = 2r + c as
the encode engine.  On the card each wave is one launch of kernel K4 in
its wave form (`deblock_wave.deblock_wave`: every MB of the wave, luma and
chroma, on the raster planes in place).  The plain version, which the CPU
takes, stores MB (r, c) at skewed column c + 2r, so that each wave is one
column strip of MBs, filtered with all MB rows at once in torch.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.ref import deblock as rd
from tpu264_torch.coding.wavefront import WaveSchedule
from tpu264_torch.coding.mvpred import INTRA
from .deblock_lines import filter_luma_lines_plain
from .deblock_wave import deblock_wave
from .transform import I32

ALPHA = [int(v) for v in rd.ALPHA_TABLE]
BETA = [int(v) for v in rd.BETA_TABLE]
TC0 = [tuple(int(v) for v in row) for row in rd.TC0_TABLE]


def _clip3(lo, hi, x):
    return torch.minimum(torch.maximum(x, lo), hi)


def filter_chroma_lines(win, bs, alpha: int, beta: int, tc0_row):
    """win [..., 4] = p1 p0 q0 q1 per line."""
    p1, p0, q0, q1 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    fflag = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
             & ((q1 - q0).abs() < beta) & (bs > 0))
    tc0_row = torch.as_tensor(tc0_row, dtype=I32, device=win.device)
    tc = tc0_row[torch.clamp(bs, 1, 3).long() - 1] + 1
    delta = _clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3)
    use_n = fflag & (bs < 4)
    s4 = fflag & (bs == 4)
    o_p0 = torch.where(use_n, torch.clamp(p0 + delta, 0, 255),
                       torch.where(s4, (2 * p1 + p0 + q1 + 2) >> 2, p0))
    o_q0 = torch.where(use_n, torch.clamp(q0 - delta, 0, 255),
                       torch.where(s4, (2 * q1 + q0 + p1 + 2) >> 2, q0))
    return torch.stack([p1, o_p0, o_q0, q1], dim=-1)


def compute_bs_maps(intra_mb, tc_luma, mv, ref):
    """Boundary strengths (bs_v, bs_h) [4hm, 4wm] for single-list motion
    at MB granularity: mv [hm, wm, 2], ref [hm, wm] (-1 = intra).  The
    two-list (B) and per-4x4 (partitioned) forms of the reference come
    with the P/B slices."""
    hm, wm = intra_mb.shape
    intra4 = intra_mb.repeat_interleave(4, 0).repeat_interleave(4, 1)
    mv4 = mv.repeat_interleave(4, 0).repeat_interleave(4, 1)
    use4 = (ref >= 0).repeat_interleave(4, 0).repeat_interleave(4, 1)
    ref4 = ref.repeat_interleave(4, 0).repeat_interleave(4, 1)
    dev = intra_mb.device

    def edge_bs(p, q, mb_edge):
        either_intra = intra4[p] | intra4[q]
        coeff = (tc_luma[p] > 0) | (tc_luma[q] > 0)
        # spec 8.7.2.1 bS 1 for one list: different reference sets, or a
        # >= 4 quarter-pel component delta of the used motion vectors
        sets_differ = (use4[p] != use4[q]) | (use4[p] & (ref4[p] != ref4[q]))
        mv_p = mv4[p] * use4[p][..., None]
        mv_q = mv4[q] * use4[q][..., None]
        far = ((mv_p - mv_q).abs() >= 4).any(dim=-1)
        return torch.where(either_intra, torch.where(mb_edge, 4, 3),
                           torch.where(coeff, 2,
                                       torch.where(sets_differ | far, 1, 0))
                           ).to(I32)

    h4, w4 = hm * 4, wm * 4
    bs_v = torch.zeros((h4, w4), dtype=I32, device=dev)
    col_edge = torch.as_tensor((np.arange(1, w4) % 4) == 0, device=dev)
    bs_v[:, 1:] = edge_bs(np.s_[:, :-1], np.s_[:, 1:], col_edge[None, :])
    bs_h = torch.zeros((h4, w4), dtype=I32, device=dev)
    row_edge = torch.as_tensor((np.arange(1, h4) % 4) == 0, device=dev)
    bs_h[1:, :] = edge_bs(np.s_[:-1, :], np.s_[1:, :], row_edge[:, None])
    return bs_v, bs_h


def make_deblocker_skewed(sched: WaveSchedule,
                          filter_across_slices: bool = True,
                          plain: bool = False):
    """Wavefront picture deblocker (bit-exact with `ref.deblock`).

    fn(y, u, v, intra_mb, tc_luma, mv, ref, qp, cqp) -> filtered int32
    planes.  CUDA planes go through the wave kernel (K4, one launch a
    wave, or it raises); CPU planes, and any planes when `plain` is set
    (the kernel's checks), through the plain version:

    MB (r, c) is stored at skewed MB column c' = c + 2r, so every 2:1
    anti-diagonal wave becomes one contiguous column strip: a wave step is
    a few slices + edge filters over all MB rows at once.  Neighbor
    windows stay local in skew space (left -> c'-1, top/top-right -> band
    above at c'-2).
    """
    wm, hm = sched.width_mbs, sched.height_mbs
    n_waves = wm + 2 * (hm - 1)
    OF = 3          # left pad in MBs (c'-2 strip reads at c'=0 reach -36px)
    skw = OF + n_waves + 1

    # rows whose top MB edge is never filtered (picture / slice boundary)
    zero_top_rows = {0}
    if not filter_across_slices:
        zero_top_rows |= {int(r) for r in sched.slice_starts.tolist() if r}

    def _skew_cols(mb_px: int, device):
        """Per-pixel-row skewed column of true col x in band b:
        x + (OF + 2b) * mb_px."""
        rows = np.repeat(np.arange(hm), mb_px)
        cols = (np.arange(wm * mb_px)[None, :]
                + (OF + 2 * rows)[:, None] * mb_px)
        return torch.as_tensor(cols, device=device)

    def _skew(plane, mb_px: int):
        """[hm*mb_px, wm*mb_px] -> [hm*mb_px, skw*mb_px] skewed layout."""
        out = torch.zeros((hm * mb_px, skw * mb_px), dtype=I32,
                          device=plane.device)
        rr = torch.arange(hm * mb_px, device=plane.device)[:, None]
        out[rr, _skew_cols(mb_px, plane.device)] = plane.to(I32)
        return out

    def _unskew(buf, mb_px: int):
        rr = torch.arange(hm * mb_px, device=buf.device)[:, None]
        return buf[rr, _skew_cols(mb_px, buf.device)]

    def bs_maps(intra_mb, tc_luma, mv, ref):
        bs_v, bs_h = compute_bs_maps(intra_mb.to(torch.bool),
                                     tc_luma.to(I32), mv.to(I32),
                                     ref.to(I32))
        for r in zero_top_rows:
            bs_h[r * 4, :] = 0
        return bs_v, bs_h

    def deblock(y, u, v, intra_mb, tc_luma, mv, ref, qp: int, cqp: int):
        if plain or y.device.type == "cpu":
            return deblock_plain(y, u, v, intra_mb, tc_luma, mv, ref, qp, cqp)
        bs_v, bs_h = bs_maps(intra_mb, tc_luma, mv, ref)
        # raster planes, filtered in place wave by wave
        yb, ub, vb = (p.to(I32, copy=True).contiguous() for p in (y, u, v))
        for cp in range(n_waves):
            deblock_wave(yb, ub, vb, bs_v, bs_h, cp, qp, cqp)
        return yb, ub, vb

    def deblock_plain(y, u, v, intra_mb, tc_luma, mv, ref, qp: int, cqp: int):
        qi = min(max(int(qp), 0), 51)
        ci = min(max(int(cqp), 0), 51)
        alpha, beta, tc0_row = ALPHA[qi], BETA[qi], TC0[qi]
        calpha, cbeta = ALPHA[ci], BETA[ci]
        ctc0_row = torch.as_tensor(TC0[ci], dtype=I32, device=y.device)
        bs_v, bs_h = bs_maps(intra_mb, tc_luma, mv, ref)
        yb = _skew(y, 16)
        ub = _skew(u, 8)
        vb = _skew(v, 8)
        bvs = _skew(bs_v, 4)
        bhs = _skew(bs_h, 4)
        dev = y.device
        zeros_l = torch.zeros((1, 4, 20), dtype=I32, device=dev)
        zeros_c = torch.zeros((1, 2, 12), dtype=I32, device=dev)

        # the skewed planes are updated in place, one wave strip at a time
        for cp in range(n_waves):
            base = (OF + cp) * 16
            base2 = (OF + cp - 2) * 16
            BV = bvs[:, (OF + cp) * 4:(OF + cp + 1) * 4].reshape(hm, 4, 4)
            BH = bhs[:, (OF + cp) * 4:(OF + cp + 1) * 4].reshape(hm, 4, 4)

            # ---- luma ----
            M = yb[:, base - 4:base + 16].reshape(hm, 16, 20)
            A = yb[:, base2 - 4:base2 + 16].view(hm, 16, 20)
            win = torch.cat([torch.cat([zeros_l, A[:-1, 12:16]], 0), M],
                            1)                            # [hm, 20, 20]
            for k in range(4):
                b_lines = BV[:, :, k].repeat_interleave(4, 1).contiguous()
                e = 4 + 4 * k
                seg = win[:, 4:20, e - 4:e + 4].contiguous()
                win[:, 4:20, e - 4:e + 4] = filter_luma_lines_plain(
                    seg, b_lines, alpha, beta, tc0_row)
            # horizontal: the same filter on the transposed window
            winT = win.transpose(1, 2)                    # a view of win
            for k in range(4):
                b_lines = BH[:, k, :].repeat_interleave(4, 1).contiguous()
                e = 4 + 4 * k
                seg = winT[:, 4:20, e - 4:e + 4].contiguous()
                winT[:, 4:20, e - 4:e + 4] = filter_luma_lines_plain(
                    seg, b_lines, alpha, beta, tc0_row)
            yb[:, base - 4:base + 16] = win[:, 4:20].reshape(hm * 16, 20)
            A[:-1, 12:16] = win[1:, 0:4]      # A views yb: writes through

            # ---- chroma ----
            cb = (OF + cp) * 8
            cb2 = (OF + cp - 2) * 8
            for pb in (ub, vb):
                Mc = pb[:, cb - 4:cb + 8].reshape(hm, 8, 12)
                Ac = pb[:, cb2 - 4:cb2 + 8].view(hm, 8, 12)
                cwin = torch.cat([torch.cat([zeros_c, Ac[:-1, 6:8]], 0), Mc],
                                 1)                       # [hm, 10, 12]
                # vertical chroma edges at local cols 4 (MB) and 8
                for k in (0, 2):
                    b_lines = BV[:, :, k].repeat_interleave(2, 1)
                    e = 4 + 2 * k
                    cwin[:, 2:10, e - 2:e + 2] = filter_chroma_lines(
                        cwin[:, 2:10, e - 2:e + 2], b_lines, calpha, cbeta,
                        ctc0_row)
                cwinT = cwin.transpose(1, 2)              # [hm, 12, 10]
                for k in (0, 2):
                    b_lines = BH[:, k, :].repeat_interleave(2, 1)
                    e = 2 + 2 * k
                    cwinT[:, 4:12, e - 2:e + 2] = filter_chroma_lines(
                        cwinT[:, 4:12, e - 2:e + 2], b_lines, calpha, cbeta,
                        ctc0_row)
                pb[:, cb - 4:cb + 8] = cwin[:, 2:10].reshape(hm * 8, 12)
                Ac[:-1, 6:8] = cwin[1:, 0:2]
        return _unskew(yb, 16), _unskew(ub, 8), _unskew(vb, 8)

    return deblock


def intra_motion(hm: int, wm: int, device):
    """(mv [hm, wm, 2], ref [hm, wm]) of an all-intra picture."""
    return (torch.zeros((hm, wm, 2), dtype=I32, device=device),
            torch.full((hm, wm), INTRA, dtype=I32, device=device))
