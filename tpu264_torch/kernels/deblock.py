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

import functools

import numpy as np
import torch

from tpu264_torch.ref import deblock as rd
from tpu264_torch.coding.wavefront import WaveSchedule
from tpu264_torch.coding.mvpred import INTRA
from .deblock_lines import filter_luma_lines_plain, tc0_lines
from .deblock_wave import deblock_wave
from .transform import I32

ALPHA = [int(v) for v in rd.ALPHA_TABLE]
BETA = [int(v) for v in rd.BETA_TABLE]
TC0 = [tuple(int(v) for v in row) for row in rd.TC0_TABLE]


def _clip3(lo, hi, x):
    return torch.minimum(torch.maximum(x, lo), hi)


def filter_chroma_lines(win, bs, alpha, beta, tc0_row):
    """win [..., 4] = p1 p0 q0 q1 per line; alpha, beta and tc0_row as
    `deblock_lines.filter_luma_lines_plain` takes them."""
    p1, p0, q0, q1 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    fflag = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
             & ((q1 - q0).abs() < beta) & (bs > 0))
    tc = tc0_lines(tc0_row, bs) + 1
    delta = _clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3)
    use_n = fflag & (bs < 4)
    s4 = fflag & (bs == 4)
    o_p0 = torch.where(use_n, torch.clamp(p0 + delta, 0, 255),
                       torch.where(s4, (2 * p1 + p0 + q1 + 2) >> 2, p0))
    o_q0 = torch.where(use_n, torch.clamp(q0 - delta, 0, 255),
                       torch.where(s4, (2 * q1 + q0 + p1 + 2) >> 2, q0))
    return torch.stack([p1, o_p0, o_q0, q1], dim=-1)


def up4(a):
    """[hm, wm, ...] -> [4hm, 4wm, ...]: each MB's value on its 4x4
    blocks."""
    return a.repeat_interleave(4, 0).repeat_interleave(4, 1)


def inter_bs1_two_list(mv_p, pid_p, mv_q, pid_q):
    """bS-1 trigger of inter/inter edges with two-list motion (spec
    8.7.2.1; `ref.deblock.inter_bs1_mask` in torch): different reference
    picture sets or vector counts, or a >= 4 quarter-pel component delta
    under the picture-wise pairing of the vectors.  mv_*: [..., 2, 2]
    (list, then (y, x)); pid_*: [..., 2] picture ids per list, -1 = list
    unused."""
    use_p, use_q = pid_p >= 0, pid_q >= 0
    n_p, n_q = use_p.sum(-1), use_q.sum(-1)
    big = 1 << 20
    lo_p = torch.where(use_p, pid_p, big).amin(-1)
    hi_p = torch.where(use_p, pid_p, -1).amax(-1)
    lo_q = torch.where(use_q, pid_q, big).amin(-1)
    hi_q = torch.where(use_q, pid_q, -1).amax(-1)
    sets_differ = (n_p != n_q) | (lo_p != lo_q) | (hi_p != hi_q)

    def far(d):                      # any component >= 4 quarter-pel
        return (d.abs() >= 4).any(-1)

    # sides using exactly one list: compare the single used vector
    d_one = far((mv_p * use_p[..., None]).sum(-2)
                - (mv_q * use_q[..., None]).sum(-2))

    def by_picture(mv, pid, lo, hi):
        mv_lo = torch.where((pid[..., 0] == lo)[..., None], mv[..., 0, :],
                            mv[..., 1, :])
        mv_hi = torch.where((pid[..., 1] == hi)[..., None], mv[..., 1, :],
                            mv[..., 0, :])
        return mv_lo, mv_hi

    # both bi-predicted from two distinct pictures: pair them by picture
    lo_mp, hi_mp = by_picture(mv_p, pid_p, lo_p, hi_p)
    lo_mq, hi_mq = by_picture(mv_q, pid_q, lo_q, hi_q)
    d_two = far(lo_mp - lo_mq) | far(hi_mp - hi_mq)
    # both bi-predicted from the same picture twice: bS 0 unless both the
    # straight and the crossed pairings have a large delta
    straight = (far(mv_p[..., 0, :] - mv_q[..., 0, :])
                | far(mv_p[..., 1, :] - mv_q[..., 1, :]))
    crossed = (far(mv_p[..., 0, :] - mv_q[..., 1, :])
               | far(mv_p[..., 1, :] - mv_q[..., 0, :]))
    both2 = (n_p == 2) & (n_q == 2)
    same_pic = both2 & (lo_p == hi_p) & (lo_q == hi_q)
    return sets_differ | torch.where(same_pic, straight & crossed,
                                     torch.where(both2, d_two, d_one))


def compute_bs_maps(intra_mb, tc_luma, mv, ref):
    """Boundary strengths (bs_v, bs_h) [4hm, 4wm].  Motion is single-list
    (mv [hm, wm, 2] / ref [hm, wm], ref -1 = intra, as P pictures have it)
    or two-list (mv [hm, wm, 2, 2] / ref [hm, wm, 2]: per list, the
    picture id or -1 where the list is unused, as B pictures have it), at
    MB granularity or per 4x4 block ([4hm, 4wm, ...], as partitioned MBs
    need)."""
    hm, wm = intra_mb.shape
    intra4 = up4(intra_mb)
    if mv.shape[0] == hm:
        mv, ref = up4(mv), up4(ref)
    two_list = mv.dim() == 4
    mv4, ref4, use4 = mv, ref, ref >= 0
    dev = intra_mb.device

    def edge_bs(p, q, mb_edge):
        either_intra = intra4[p] | intra4[q]
        coeff = (tc_luma[p] > 0) | (tc_luma[q] > 0)
        if two_list:
            motion = inter_bs1_two_list(mv4[p], ref4[p], mv4[q], ref4[q])
        else:
            # spec 8.7.2.1 bS 1 for one list: different reference sets, or
            # a >= 4 quarter-pel component delta of the used vectors
            sets_differ = ((use4[p] != use4[q])
                           | (use4[p] & (ref4[p] != ref4[q])))
            mv_p = mv4[p] * use4[p][..., None]
            mv_q = mv4[q] * use4[q][..., None]
            motion = sets_differ | ((mv_p - mv_q).abs() >= 4).any(dim=-1)
        return torch.where(either_intra, torch.where(mb_edge, 4, 3),
                           torch.where(coeff, 2, torch.where(motion, 1, 0))
                           ).to(I32)

    h4, w4 = hm * 4, wm * 4
    bs_v = torch.zeros((h4, w4), dtype=I32, device=dev)
    col_edge = torch.as_tensor((np.arange(1, w4) % 4) == 0, device=dev)
    bs_v[:, 1:] = edge_bs(np.s_[:, :-1], np.s_[:, 1:], col_edge[None, :])
    bs_h = torch.zeros((h4, w4), dtype=I32, device=dev)
    row_edge = torch.as_tensor((np.arange(1, h4) % 4) == 0, device=dev)
    bs_h[1:, :] = edge_bs(np.s_[:-1, :], np.s_[1:, :], row_edge[:, None])
    return bs_v, bs_h


def bs_maps(intra_mb, tc_luma, mv, ref, t8_mb=None, left_ok=None,
            top_ok=None):
    """The deblocker's boundary strengths (bs_v, bs_h) [4hm, 4wm]:
    `compute_bs_maps`, then no internal 4x4 edges in the MBs of `t8_mb`,
    and bS 0 on the MB edges that must not be filtered: the left edge of
    MB (r, c) where left_ok[r, c] is False and its top edge where
    top_ok[r, c] is False ([hm, wm] bool; picture edges, and slice edges
    at disable_deblocking_filter_idc 2).  bS 0 filters nothing, as the
    reference's skipped edge."""
    bs_v, bs_h = compute_bs_maps(intra_mb.to(torch.bool), tc_luma.to(I32),
                                 mv.to(I32), ref.to(I32))
    hm, wm = intra_mb.shape
    if t8_mb is not None:
        # transform-8x8 MBs have no internal 4x4 edges: their luma
        # edges at x/y = 4 and 12 within the MB are not filtered
        t8r = up4(t8_mb.to(torch.bool))
        dev = t8r.device
        odd_c = torch.arange(4 * wm, device=dev) % 2 == 1
        odd_r = torch.arange(4 * hm, device=dev) % 2 == 1
        bs_v = torch.where(t8r & odd_c[None, :], 0, bs_v)
        bs_h = torch.where(t8r & odd_r[:, None], 0, bs_h)
    if left_ok is not None:
        keep = left_ok.to(torch.bool).repeat_interleave(4, 0)
        bs_v[:, ::4] = torch.where(keep, bs_v[:, ::4], 0)
    if top_ok is not None:
        keep = top_ok.to(torch.bool).repeat_interleave(4, 1)
        bs_h[::4, :] = torch.where(keep, bs_h[::4, :], 0)
    return bs_v, bs_h


_TABLES: dict = {}


def edge_params(q, off_a: int = 0, off_b: int = 0):
    """Spec 8.7.2's thresholds at the (averaged) QP grid `q`: alpha and
    the tc0 row [..., 3] at indexA = clip(q + off_a, 0, 51), beta at
    indexB = clip(q + off_b, 0, 51)."""
    dev = q.device
    if dev not in _TABLES:
        _TABLES[dev] = tuple(torch.as_tensor(np.asarray(t), dtype=I32,
                                             device=dev)
                             for t in (ALPHA, BETA, TC0))
    alpha, beta, tc0 = _TABLES[dev]
    ia = torch.clamp(q + off_a, 0, 51).long()
    ib = torch.clamp(q + off_b, 0, 51).long()
    return alpha[ia], beta[ib], tc0[ia]


@functools.lru_cache(maxsize=None)
def make_deblocker(wm: int, hm: int, plain: bool = False):
    """Wavefront picture deblocker of a wm x hm MB picture (bit-exact with
    `ref.deblock.deblock_frame`); one per geometry.

    fn(y, u, v, intra_mb, tc_luma, mv, ref, qp, cqp, t8_mb=None,
    left_ok=None, top_ok=None, off_a=0, off_b=0) -> filtered int32
    planes.  `qp`, `cqp` are the luma and chroma QP, one for the picture
    (an int) or one per MB ([hm, wm]); `t8_mb` [hm, wm] marks the MBs
    coded with the 8x8 transform, whose inner 4x4 luma edges are not
    filtered; `left_ok`, `top_ok` [hm, wm] say which MB edges are filtered
    (`bs_maps`); off_a, off_b are FilterOffsetA/B.  CUDA planes go
    through the wave kernel (K4, one launch a wave, or it raises); CPU
    planes, and any planes when `plain` is set (the kernel's checks),
    through the plain version:

    MB (r, c) is stored at skewed MB column c' = c + 2r, so every 2:1
    anti-diagonal wave becomes one contiguous column strip: a wave step is
    a few slices + edge filters over all MB rows at once.  Neighbor
    windows stay local in skew space (left -> c'-1, top/top-right -> band
    above at c'-2).
    """
    n_waves = wm + 2 * (hm - 1)
    OF = 3          # left pad in MBs (c'-2 strip reads at c'=0 reach -36px)
    skw = OF + n_waves + 1
    cache: dict = {}

    def _skew_cols(mb_px: int, device):
        """Per-pixel-row skewed column of true col x in band b:
        x + (OF + 2b) * mb_px."""
        key = ("cols", mb_px, device)
        if key not in cache:
            rows = np.repeat(np.arange(hm), mb_px)
            cols = (np.arange(wm * mb_px)[None, :]
                    + (OF + 2 * rows)[:, None] * mb_px)
            cache[key] = (torch.arange(hm * mb_px, device=device)[:, None],
                          torch.as_tensor(cols, device=device))
        return cache[key]

    def _skew(plane, mb_px: int):
        """[hm*mb_px, wm*mb_px] -> [hm*mb_px, skw*mb_px] skewed layout."""
        out = torch.zeros((hm * mb_px, skw * mb_px), dtype=I32,
                          device=plane.device)
        rr, cc = _skew_cols(mb_px, plane.device)
        out[rr, cc] = plane.to(I32)
        return out

    def _unskew(buf, mb_px: int):
        rr, cc = _skew_cols(mb_px, buf.device)
        return buf[rr, cc]

    def _grid(q, device):
        """An int QP as a [hm, wm] int32 grid (cached), or the grid."""
        if isinstance(q, torch.Tensor):
            return q.to(device=device, dtype=I32).contiguous()
        key = ("qp", int(q), device)
        if key not in cache:
            cache[key] = torch.full((hm, wm), int(q), dtype=I32,
                                    device=device)
        return cache[key]

    def deblock(y, u, v, intra_mb, tc_luma, mv, ref, qp, cqp, t8_mb=None,
                left_ok=None, top_ok=None, off_a: int = 0, off_b: int = 0):
        bs_v, bs_h = bs_maps(intra_mb, tc_luma, mv, ref, t8_mb, left_ok,
                             top_ok)
        qp_y, qp_c = _grid(qp, y.device), _grid(cqp, y.device)
        if plain or y.device.type == "cpu":
            return deblock_plain(y, u, v, bs_v, bs_h, qp_y, qp_c, off_a,
                                 off_b)
        # raster planes, filtered in place wave by wave
        yb, ub, vb = (p.to(I32, copy=True).contiguous() for p in (y, u, v))
        for cp in range(n_waves):
            deblock_wave(yb, ub, vb, bs_v, bs_h, cp, qp_y, qp_c, off_a,
                         off_b)
        return yb, ub, vb

    def skewed_params(qp_g, off_a: int, off_b: int):
        """Per skewed MB column: (alpha, beta, tc0) of the internal, the
        left and the top MB edges, each [hm, skw] ([hm, skw, 3])."""
        qs = _skew(qp_g, 1)
        q_left = qs.clone()
        q_left[:, 1:] = (qs[:, 1:] + qs[:, :-1] + 1) >> 1
        q_top = qs.clone()
        q_top[1:, 2:] = (qs[1:, 2:] + qs[:-1, :-2] + 1) >> 1
        return [edge_params(q, off_a, off_b) for q in (qs, q_left, q_top)]

    def deblock_plain(y, u, v, bs_v, bs_h, qp_y, qp_c, off_a: int,
                      off_b: int):
        # per MB: (alpha, beta, tc0) of its internal, left and top edges
        lprm = skewed_params(qp_y, off_a, off_b)
        cprm = skewed_params(qp_c, off_a, off_b)
        yb = _skew(y, 16)
        ub = _skew(u, 8)
        vb = _skew(v, 8)
        bvs = _skew(bs_v, 4)
        bhs = _skew(bs_h, 4)
        dev = y.device
        zeros_l = torch.zeros((1, 4, 20), dtype=I32, device=dev)
        zeros_c = torch.zeros((1, 2, 12), dtype=I32, device=dev)

        def at(prm, kind: int, col: int):
            """The wave's parameters, one set a MB row, for its lines."""
            a, b, t = (x[:, col] for x in prm[kind])
            return a[:, None], b[:, None], t[:, None, :]

        # the skewed planes are updated in place, one wave strip at a time
        for cp in range(n_waves):
            base = (OF + cp) * 16
            base2 = (OF + cp - 2) * 16
            col = OF + cp
            BV = bvs[:, (OF + cp) * 4:(OF + cp + 1) * 4].reshape(hm, 4, 4)
            BH = bhs[:, (OF + cp) * 4:(OF + cp + 1) * 4].reshape(hm, 4, 4)
            inner, left, top = (at(lprm, kind, col) for kind in range(3))

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
                    seg, b_lines, *(inner if k else left))
            # horizontal: the same filter on the transposed window
            winT = win.transpose(1, 2)                    # a view of win
            for k in range(4):
                b_lines = BH[:, k, :].repeat_interleave(4, 1).contiguous()
                e = 4 + 4 * k
                seg = winT[:, 4:20, e - 4:e + 4].contiguous()
                winT[:, 4:20, e - 4:e + 4] = filter_luma_lines_plain(
                    seg, b_lines, *(inner if k else top))
            yb[:, base - 4:base + 16] = win[:, 4:20].reshape(hm * 16, 20)
            A[:-1, 12:16] = win[1:, 0:4]      # A views yb: writes through

            # ---- chroma ----
            cinner, cleft, ctop = (at(cprm, kind, col) for kind in range(3))
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
                        cwin[:, 2:10, e - 2:e + 2], b_lines,
                        *(cinner if k else cleft))
                cwinT = cwin.transpose(1, 2)              # [hm, 12, 10]
                for k in (0, 2):
                    b_lines = BH[:, k, :].repeat_interleave(2, 1)
                    e = 2 + 2 * k
                    cwinT[:, 4:12, e - 2:e + 2] = filter_chroma_lines(
                        cwinT[:, 4:12, e - 2:e + 2], b_lines,
                        *(cinner if k else ctop))
                pb[:, cb - 4:cb + 8] = cwin[:, 2:10].reshape(hm * 8, 12)
                Ac[:-1, 6:8] = cwin[1:, 0:2]
        return _unskew(yb, 16), _unskew(ub, 8), _unskew(vb, 8)

    return deblock


def make_deblocker_skewed(sched: WaveSchedule,
                          filter_across_slices: bool = True,
                          plain: bool = False):
    """The encoder's picture deblocker: `make_deblocker` of the schedule's
    geometry at one QP a picture, offsets 0, with the top MB edges of the
    slices' first rows left unfiltered unless `filter_across_slices`
    (idc 2: the encoder's slices are whole MB rows).

    fn(y, u, v, intra_mb, tc_luma, mv, ref, qp, cqp, t8_mb=None) ->
    filtered int32 planes."""
    wm, hm = sched.width_mbs, sched.height_mbs
    deblock = make_deblocker(wm, hm, plain)
    top_ok: dict = {}          # device -> [hm, wm] bool
    ok = np.ones((hm, wm), dtype=bool)
    ok[[int(r) for r in sched.slice_starts.tolist()], :] = False

    def deblock_frame(y, u, v, intra_mb, tc_luma, mv, ref, qp: int,
                      cqp: int, t8_mb=None):
        if filter_across_slices:
            return deblock(y, u, v, intra_mb, tc_luma, mv, ref, qp, cqp,
                           t8_mb)
        if y.device not in top_ok:
            top_ok[y.device] = torch.as_tensor(ok, device=y.device)
        return deblock(y, u, v, intra_mb, tc_luma, mv, ref, qp, cqp, t8_mb,
                       top_ok=top_ok[y.device])

    return deblock_frame


def intra_motion(hm: int, wm: int, device):
    """(mv [hm, wm, 2], ref [hm, wm]) of an all-intra picture."""
    return (torch.zeros((hm, wm, 2), dtype=I32, device=device),
            torch.full((hm, wm), INTRA, dtype=I32, device=device))
