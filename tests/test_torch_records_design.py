"""Kernel KR's passes (`csrc/cabac_records.cu`: CABAC binarize + compact
of a picture) emulated in numpy on the CPU (no card, no reference encoder,
no JAX program): a warp a macroblock.  The state pass derives the mvds
(lanes 0 and 1: the spec 8.4.1.3 predictors, a stencil over the finished
decisions of the MB and its left, top, top-right and top-left neighbours)
and the most probable Intra4x4 modes (lanes 16-31), takes the
coefficients' significance masks from 13 ballots and writes the state;
the count and emit passes walk the MB in 32 pieces, one a lane (the
header, then each residual block), in the CUDA source's branch order,
and a warp exclusive scan of the pieces' counts places each piece; then
the per-slice scan.  The inputs are the MB dict, `tables`
(`kernels/cabac_records.py`; the derive-only pass KD gets the first part,
`kernels/mb_preds.py` `tables`) and `pack_params` (`kernels/mb_preds.py`).

The derived mvds and modes are held to the port's plain version
(`kernels/mb_preds.py` `preds_plain`, which the CAVLC serializers' pass
KD shares; also over two pictures at once, as KD takes a chunk) and that
to the reference's own derivations
(`tpu264/entropy/device_cavlc.py` `_mpm_grid_j`, `_partition_mvds_j`,
`_cell_grids2_j` + `_partition_mvds_core_j`, and `binarize_frame_j`'s
16x16 predictor, `_neighbor_mvs_j` + `predict_mv_jnp`, before it masks
the uncoded ones), also on B pictures without direct MBs.  The records
are held to the reference's numpy binarizer
(`tpu264.entropy.cabac_binarize.binarize_frame` + `slice_records`) slice
by slice, and the packed rows to `records_plain`'s, zeros past each count
included: I slices, P slices with every tool set, B slices with and
without partitions and the 8x8 PPS, one and three slices, and slices over
the record cap.  Tolerance 0."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu264.coding import mvpred as rmv
from tpu264.entropy import cabac_binarize as ocb
from tpu264.entropy import device_cavlc as rdc

from tpu264_torch.coding.wavefront import BLK_ORDER, build_schedule
from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.kernels import cabac_records as kcr
from tpu264_torch.kernels import mb_preds as mp
from tpu264_torch.tools.synth_inputs import random_b_mbs, random_mbs

from torch_util import assert_equal, to_np

WM, HM = 11, 9
M32 = 0xFFFFFFFF

# `T_*` offsets, the MB kinds and the slice kinds of the CUDA source
T_COMBO, T_BLK, T_CBF, T_SIG, T_LVL, T_SIG8, T_LAST8 = 0, 9, 25, 30, 35, \
    41, 104
PRED_TABLE_WORDS, TABLE_WORDS = 25, 167
K_SKIP, K_INTER, K_I4, K_I16, K_DIRECT = 0, 1, 2, 3, 4
SL_I, SL_P, SL_B = 0, 1, 2
UNAVAIL, INTRA = -2, -1
# a macroblock's coefficients in shared memory: luma AC, chroma AC, luma
# DC, chroma DC
C_LAC, C_CAC, C_LDC, C_CDC = 0, 256, 384, 400


def bitlen_m1(v: int) -> int:
    return int(v).bit_length() - 1


def eg_parts(v: int, k: int):
    m = bitlen_m1((v >> k) + 1)
    p = 1 << min(m, 30)
    return (p - 1) << 1, m + 1, v - ((p - 1) << k), k + m


class Counter:
    def __init__(self):
        self.n = 0

    def put(self, k, a, b):
        self.n += 1


class Writer:
    def __init__(self, out, base: int, lim: int):
        self.out, self.base, self.pos, self.lim = out, base, 0, lim

    def put(self, k, a, b):
        if self.pos < self.lim:
            p = ((k << 30) | (a << 14) | b) & M32
            self.out[self.base + self.pos] = p - (1 << 32) if p >> 31 else p
        self.pos += 1


class Emit:
    def __init__(self, s):
        self.s = s

    def ctx(self, c, binv, v):
        if v:
            self.s.put(0, c, (int(binv) & 1) | 2)

    def run(self, c, binv, count, v):
        if v and count > 0:
            self.s.put(0, c, (binv & 1) | (count << 1))

    def byp(self, val, nbits, v):
        if v and nbits > 0:
            self.s.put(1, int(val), nbits)

    def term(self, binv, v):
        if v:
            self.s.put(2, int(binv), 0)


class Cell(tuple):
    """(x, y, ref) of a boundary 4x4 cell, as the CUDA source's `Cell`."""


def cell(x, y, ref):
    return Cell((int(x), int(y), int(ref)))


UNAV = cell(0, 0, UNAVAIL)


def pred_mv(a, b, c):
    """`pred_mv` of the CUDA source (`mvpred.predict_mv`)."""
    only_a = b[2] == UNAVAIL and c[2] == UNAVAIL and a[2] != UNAVAIL
    same = (a[2] == 0) + (b[2] == 0) + (c[2] == 0)
    if only_a or (same == 1 and a[2] == 0):
        return [a[0], a[1]]
    if same == 1:
        return [b[0], b[1]] if b[2] == 0 else [c[0], c[1]]
    return [max(min(max(a[k], b[k]), c[k]), min(a[k], b[k]))
            for k in range(2)]


def zz_of(by, bx):
    return 8 * (by >> 1) + 4 * (bx >> 1) + 2 * (by & 1) + (bx & 1)


class Kr:
    """The kernel on `pics` pictures of one layout (KR takes one): `Io`
    from the MB dict, `Params` parsed from `pack_params`' table as
    `tpu264_cabac_records` parses it.  A
    macroblock is a warp: the state pass derives its mvds (lanes 0 and 1)
    and most probable modes (lanes 16-31), takes its coefficients' masks
    from 13 ballots and writes its state; the count and emit passes walk
    it in 32 pieces, one a lane, placed by a warp exclusive scan."""

    def __init__(self, mb, params, tab, pics=1):
        q = list(params)
        (self.wm, self.hm, self.kind, self.t8_mode, self.parts, self.p8x8,
         self.n_slices) = q[:7]
        self.rows = q[7:8 + self.n_slices]
        assert self.rows[0] == 0 and self.rows[-1] == self.hm
        n = self.wm * self.hm * pics
        self.n = n

        def flat(key, dtype=np.int64):
            return (None if key not in mb
                    else np.asarray(mb[key]).astype(dtype).reshape(-1))
        self.sel16 = flat("sel16")
        self.is_inter = flat("is_inter") if self.kind == SL_P else None
        self.t8 = flat("t8")
        self.luma_ac = flat("luma_ac")
        self.luma_dc = flat("luma_dc")
        self.chroma_dc = flat("chroma_dc")
        self.chroma_ac = flat("chroma_ac")
        self.modes, self.cmode = flat("modes"), flat("cmode")
        self.i16mode = flat("i16mode")
        self.mv, self.mv_skip = flat("mv"), flat("mv_skip")
        self.ptype, self.btype = flat("ptype"), flat("btype")
        self.c0, self.c1, self.bptype = flat("c0"), flat("c1"), flat("bptype")
        self.mv2, self.mvq = flat("mv2"), flat("mvq")
        self.use = [flat("use0"), flat("use1")]
        self.mvl = [flat("mv0"), flat("mv1")]
        self.mvlb = [flat("mv0b"), flat("mv1b")]
        self.tab = [int(x) for x in tab]
        self.mvds = np.zeros(n * 16, np.int64) - 7         # "not written"
        self.mpm = np.zeros(n * 16, np.int64) - 7
        self.state = np.zeros(n * 16, np.int64)
        self.mb_count = np.zeros(n, np.int64)
        self.lane_count = np.zeros((n, 32), np.int64)
        self.lane_off = np.zeros((n, 32), np.int64)
        self.mb_off = np.zeros(n, np.int64)
        self.counts = np.zeros(self.n_slices + 1, np.int64)

    def slice_of(self, r):
        s = 0
        while s + 1 < self.n_slices and self.rows[s + 1] <= r:
            s += 1
        return s

    def top_ok(self, m):
        r = m // self.wm % self.hm
        return r > self.rows[self.slice_of(r)]

    # ---- (a) the derived inputs ----
    def motion_of(self, j, l):
        """(ptype, inter, use_p0, use_p1, quads, p0, p1) of MB j, list l."""
        mv = self.mv if self.kind == SL_P else self.mvl[l]
        p0 = [int(mv[2 * j]), int(mv[2 * j + 1])]
        use = bool(self.is_inter[j] if self.kind == SL_P else self.use[l][j])
        if not self.parts:
            return 0, True, use, False, False, p0, [0, 0]
        mvb = self.mv2 if self.kind == SL_P else self.mvlb[l]
        p1 = [int(mvb[2 * j]), int(mvb[2 * j + 1])]
        if self.kind == SL_P:
            pt = int(self.ptype[j])
            return (pt, use, True, True, bool(self.p8x8) and pt == 3, p0,
                    p1)
        bt, c1 = int(self.btype[j]), int(self.c1[j])
        use_p1 = (c1 != 0 if l else c1 != 1) if bt == 5 else use
        return int(self.bptype[j]), bt != 4, use, use_p1, False, p0, p1

    def cell_of(self, j, l, k):
        pt, inter, use_p0, use_p1, quads, p0, p1 = self.motion_of(j, l)
        sel = pt == 2 if k == 0 else (pt == 1 if k == 1 else pt > 0)
        x, y = p1 if sel else p0
        if quads:
            x, y = self.mvq[8 * j + 2 * (k + 1):8 * j + 2 * (k + 1) + 2]
        if not ((use_p1 if sel else use_p0) and inter):
            return cell(0, 0, INTRA)
        return cell(x, y, 0)

    # neighbour cell i: (dr, dc, cell) of A, B, C, D, the top MB's br and
    # the left MB's br
    NB = ((0, -1, 0), (-1, 0, 1), (-1, 1, 1), (-1, -1, 2), (-1, 0, 2),
          (0, -1, 2))

    def nb_cell(self, m, l, i):
        """What lane 2 + 6 l + i fetches."""
        dr, dc, k = self.NB[i]
        r, c = divmod(m, self.wm)
        rr, cc = r + dr, c + dc
        if rr < 0 or cc < 0 or cc >= self.wm or (dr and not self.top_ok(m)):
            return UNAV
        return self.cell_of(rr * self.wm + cc, l, k)

    def derive_mvds(self, m, l, nb):
        """List l's mvds of MB m in `preds_plain`' layout [4][2] from its
        neighbour cells `nb`."""
        d = [[0, 0] for _ in range(4)]
        if self.kind == SL_P and l == 1:
            return d
        A, B, C, D = nb[:4]
        pt, inter, use_p0, _, _, p0, p1 = self.motion_of(m, l)
        pred16 = pred_mv(A, B, D if C[2] == UNAVAIL else C)
        if not self.parts:
            d[0] = [p0[k] - pred16[k] for k in range(2)]
            return d
        TBR = nb[4]
        C0 = D if TBR[2] == UNAVAIL else TBR
        if pt == 2:
            pred0 = [A[0], A[1]] if A[2] == 0 else pred_mv(A, B, C0)
        elif pt == 1 and B[2] == 0:
            pred0 = [B[0], B[1]]
        else:
            pred0 = pred16
        p0_ref = 0 if inter and use_p0 else INTRA
        own0 = cell(p0[0], p0[1], 0) if p0_ref == 0 else cell(0, 0, p0_ref)
        LBR = nb[5]
        C1 = B if C[2] == UNAVAIL else C
        if pt == 1:
            pred1 = [LBR[0], LBR[1]] if LBR[2] == 0 else \
                pred_mv(LBR, own0, A)
        else:
            pred1 = [C1[0], C1[1]] if C1[2] == 0 else pred_mv(own0, TBR, C1)
        d[0] = [p0[k] - pred0[k] for k in range(2)]
        d[1] = [p1[k] - pred1[k] for k in range(2)]
        if not (self.kind == SL_P and self.p8x8):
            return d
        mq = self.mvq[8 * m:8 * m + 8]
        q = [cell(mq[2 * i], mq[2 * i + 1], 0) for i in range(4)]
        pq = [pred_mv(A, B, C0), pred_mv(q[0], TBR, C1),
              pred_mv(LBR, q[0], q[1]), pred_mv(q[2], q[1], q[0])]
        dq = [[q[i][k] - pq[i][k] for k in range(2)] for i in range(4)]
        if pt == 3:
            d[0], d[1] = dq[0], dq[1]
        d[2], d[3] = dq[2], dq[3]
        return d

    def is_i4_mb(self, j):
        inter = (self.is_inter[j] != 0 if self.kind == SL_P
                 else self.btype[j] != 4 if self.kind == SL_B else False)
        return self.sel16[j] == 0 and not inter

    def mode_at(self, j, by, bx):
        return int(self.modes[16 * j + zz_of(by, bx)]) \
            if self.is_i4_mb(j) else -1

    def mpm_of(self, m, idx):
        pos = self.tab[T_BLK + idx]
        by, bx = pos >> 2, pos & 3
        c = m % self.wm
        left = (self.mode_at(m, by, bx - 1) if bx > 0
                else self.mode_at(m - 1, by, 3) if c > 0 else UNAVAIL)
        top = (self.mode_at(m, by - 1, bx) if by > 0
               else self.mode_at(m - self.wm, 3, bx) if self.top_ok(m)
               else UNAVAIL)
        a = 2 if left == -1 else left
        b = 2 if top == -1 else top
        return 2 if a < 0 or b < 0 else min(a, b)

    # ---- a macroblock's coefficients and their ballots ----
    def coefs(self, m):
        """The shared layout (C_*): luma AC, chroma AC, luma DC, chroma DC
        -> (408 words, 13 mask words, bit `lane` of word k: word 32 k +
        lane is nonzero)."""
        sh = np.concatenate([self.luma_ac[m * 256:(m + 1) * 256],
                             self.chroma_ac[m * 128:(m + 1) * 128],
                             self.luma_dc[m * 16:(m + 1) * 16],
                             self.chroma_dc[m * 8:(m + 1) * 8]])
        nzw = np.zeros(13 * 32, bool)
        nzw[:408] = sh != 0
        mask = [int((nzw[32 * k:32 * k + 32] << np.arange(32)).sum())
                for k in range(13)]
        return sh, mask

    @staticmethod
    def luma_mask(mask, i):
        return (mask[i >> 1] >> (16 * (i & 1))) & 0xFFFF

    @staticmethod
    def cac_mask(mask, j):
        return (mask[8 + (j >> 1)] >> (16 * (j & 1))) & 0xFFFF

    @staticmethod
    def cbp_of(mask):
        cl = sum(1 << b8 for b8 in range(4)
                 if mask[2 * b8] | mask[2 * b8 + 1])
        cc = (2 if mask[8] | mask[9] | mask[10] | mask[11]
              else 1 if (mask[12] >> 16) & 0xFF else 0)
        return cl, cc

    # ---- the macroblock's own flags ----
    def mb_flags(self, m, cl, cc):
        b = dict(btype=0, partd=False, ptype=0, exp=[False, False],
                 exp_b=[False, False], is_direct=False)
        if self.kind == SL_B:
            bt = int(self.btype[m])
            b.update(btype=bt, is_inter=bt != 4, partd=bt == 5,
                     is_direct=bt == 3)
            if self.parts:
                c0, c1 = int(self.c0[m]), int(self.c1[m])
                b["ptype"] = int(self.bptype[m])
                b["exp"] = [c0 != 1 if b["partd"] else bt in (0, 2),
                            c0 != 0 if b["partd"] else bt in (1, 2)]
                b["exp_b"] = [b["partd"] and c1 != 1,
                              b["partd"] and c1 != 0]
            else:
                b["exp"] = [bt in (0, 2), bt in (1, 2)]
        elif self.kind == SL_P:
            b["is_inter"] = self.is_inter[m] != 0
            if self.parts:
                b["ptype"] = int(self.ptype[m])
        else:
            b["is_inter"] = False
        b["sel16"] = self.sel16[m] != 0 and not b["is_inter"]
        if b["sel16"] and cl > 0:
            cl = 15
        b.update(cbp_luma=cl, cbp_chroma=cc, cbp=cl | (cc << 4))
        if self.kind == SL_P:
            b["skipped"] = bool(
                b["is_inter"] and b["ptype"] == 0
                and self.mv[2 * m] == self.mv_skip[2 * m]
                and self.mv[2 * m + 1] == self.mv_skip[2 * m + 1]
                and b["cbp"] == 0)
        elif self.kind == SL_B:
            b["skipped"] = b["is_direct"] and b["cbp"] == 0
        else:
            b["skipped"] = False
        b["coded"] = not b["skipped"]
        b["kind"] = (K_SKIP if b["skipped"] else K_DIRECT if b["is_direct"]
                     else K_INTER if b["is_inter"]
                     else K_I16 if b["sel16"] else K_I4)
        b["t8v"] = bool(self.t8_mode and self.t8 is not None
                        and self.t8[m] != 0 and b["is_inter"] and b["coded"]
                        and b["cbp_luma"] > 0)
        return b

    def mvd_on(self, b, l):
        if self.kind == SL_P:
            on0 = l == 0 and b["coded"] and b["is_inter"]
            return [on0, on0 and b["ptype"] > 0] + \
                [bool(self.p8x8) and on0 and b["ptype"] == 3] * 2
        return [b["coded"] and b["exp"][l],
                b["coded"] and b["exp_b"][l] and b["partd"], False, False]

    def mvd_abs(self, b, l, d):
        on = self.mvd_on(b, l)
        return [[abs(int(d[2 * q + c])) if on[q] else 0 for c in range(2)]
                for q in range(4)]

    def cells(self, b, a):
        pt = b["ptype"]
        out = [[0, 0], [0, 0], [0, 0]]
        for c in range(2):
            if self.kind == SL_P:
                out[0][c] = a[1][c] if pt in (2, 3) else a[0][c]
                out[1][c] = a[1][c] if pt == 1 else a[0][c]
                out[2][c] = a[1][c] if pt > 0 else a[0][c]
                if self.p8x8 and pt == 3:
                    out[1][c], out[2][c] = a[2][c], a[3][c]
            else:
                out[0][c] = a[1][c] if pt == 2 else a[0][c]
                out[1][c] = a[1][c] if pt == 1 else a[0][c]
                out[2][c] = a[1][c] if pt > 0 else a[0][c]
        return out

    # ---- (a) the state pass ----
    def state_mb(self, m, derive_only=False):
        n_lists = {SL_I: 0, SL_P: 1, SL_B: 2}[self.kind]
        cells = [[self.nb_cell(m, l, i) for i in range(6)]   # lanes 2-13
                 for l in range(n_lists)]
        d = [None, None]
        for lane in (0, 1):                       # the mvd lanes
            if self.kind != SL_I:
                nb = cells[lane] if lane < n_lists else None
                d[lane] = [v for q in self.derive_mvds(m, lane, nb)
                           for v in q]
                self.mvds[m * 16 + lane * 8:m * 16 + lane * 8 + 8] = d[lane]
        for lane in range(16, 32):                # the mode lanes
            self.mpm[m * 16 + lane - 16] = self.mpm_of(m, lane - 16)
        if derive_only:
            return
        _, mask = self.coefs(m)
        b = self.mb_flags(m, *self.cbp_of(mask))
        st = self.state[m * 16:(m + 1) * 16]
        for lane in (0, 1):
            c = [[0, 0], [0, 0], [0, 0]]
            if d[lane] is not None:
                c = self.cells(b, self.mvd_abs(b, lane, d[lane]))
            for k in range(3):
                for comp in range(2):
                    st[2 + 6 * lane + 2 * k + comp] = min(c[k][comp], 255)
        w0 = (b["kind"] | (b["t8v"] << 3) | (b["cbp_luma"] << 4)
              | (b["cbp_chroma"] << 8))
        if not b["is_inter"] and self.cmode[m] != 0:
            w0 |= 1 << 10
        if b["sel16"] and b["coded"] and mask[12] & 0xFFFF:
            w0 |= 1 << 11
        for comp in range(2):
            if ((mask[12] >> (16 + 4 * comp)) & 0xF and b["cbp_chroma"] >= 1
                    and b["coded"]):
                w0 |= 1 << (12 + comp)
            for idx in range(4):
                if (b["cbp_chroma"] == 2 and b["coded"]
                        and self.cac_mask(mask, comp * 4 + idx) >> 1):
                    w0 |= 1 << (14 + 4 * comp + idx)
        w1 = 0
        for idx in range(16):
            bit8 = bool((b["cbp_luma"] >> (idx // 4)) & 1)
            blk = self.luma_mask(mask, idx)
            if b["sel16"]:
                l4 = blk >> 1 != 0 and b["cbp_luma"] > 0
            else:
                l4 = blk != 0 and bit8
            l4 = l4 and b["coded"]
            if b["t8v"]:
                l4 = bit8
            if l4:
                w1 |= 1 << self.tab[T_BLK + idx]
        st[0], st[1] = w0, w1
        st[14:] = 0

    # ---- the residual rows ----
    def level_rows(self, e, nz, get, lvl):
        ngt1 = neq1 = 0
        while nz:
            p = nz.bit_length() - 1
            nz &= ~(1 << p)
            c = get(p)
            a = abs(c) - 1
            ctx0 = lvl + (0 if ngt1 > 0 else min(1 + neq1, 4))
            ctxn = lvl + 5 + min(ngt1, 4)
            e.ctx(ctx0, a > 0, True)
            e.run(ctxn, 1, min(a, 14) - 1, a >= 2)
            e.ctx(ctxn, 0, 1 <= a < 14)
            pre, pre_bits, suf, suf_bits = eg_parts(max(a - 14, 0), 0)
            e.byp(pre, pre_bits, a >= 14)
            e.byp(suf, suf_bits, a >= 14)
            e.byp(c < 0, 1, True)
            if a > 0:
                ngt1 += 1
            else:
                neq1 += 1

    def residual(self, e, sh, at, mc, nz, sig, last_b, lvl, cbf_ctx, coded,
                 cdc_inc):
        if not coded:
            nz = 0
        e.ctx(cbf_ctx, nz != 0, coded)
        if not coded or nz == 0:
            return
        last = nz.bit_length() - 1
        i = 0
        while i < 15 and i <= last and i <= mc - 2:
            inc = min(i, 2) if cdc_inc else i
            s = (nz >> i) & 1
            e.ctx(sig + inc, s, True)
            e.ctx(last_b + inc, i == last, s)
            i += 1
        self.level_rows(e, nz, lambda q: int(sh[at + q]), lvl)

    def residual8(self, e, sh, mask, b8, on):
        if not on:
            return
        base = C_LAC + b8 * 64

        def get(q):
            return int(sh[base + (q & 3) * 16 + (q >> 2)])
        sub = [self.luma_mask(mask, 4 * b8 + i) for i in range(4)]
        nz = 0
        for q in range(64):
            nz |= ((sub[q & 3] >> (q >> 2)) & 1) << q
        if nz == 0:
            return
        last = nz.bit_length() - 1
        i = 0
        while i < 63 and i <= last:
            s = (nz >> i) & 1
            e.ctx(402 + self.tab[T_SIG8 + i], s, True)
            e.ctx(417 + self.tab[T_LAST8 + i], i == last, s)
            i += 1
        self.level_rows(e, nz, get, 426)

    def mvd_rows(self, e, d, s, on):
        for comp in (1, 0):
            base = 40 if comp == 1 else 47
            inc = 0 if s[comp] < 3 else (1 if s[comp] <= 32 else 2)
            v = int(d[comp])
            a = abs(v)
            e.ctx(base + inc, a > 0, on)
            for k in (1, 2, 3):
                e.ctx(base + k + 2, a > k, on and a >= k)
            e.run(base + 6, 1, min(a, 9) - 4, on and a >= 5)
            e.ctx(base + 6, 0, on and 4 <= a < 9)
            pre, pre_bits, suf, suf_bits = eg_parts(max(a - 9, 0), 3)
            e.byp(pre, pre_bits, on and a >= 9)
            e.byp(suf, suf_bits, on and a >= 9)
            e.byp(v < 0, 1, on and a > 0)

    # ---- what every lane of the warp knows (`mb_ctx`) ----
    def mb_ctx(self, m, s):
        r, c = divmod(m, self.wm)
        x = dict(m=m, av_l=c > 0, av_t=r > self.rows[s],
                 last_of_slice=m == self.rows[s + 1] * self.wm - 1)
        own = self.state[m * 16:(m + 1) * 16]
        x["own"] = own
        x["l"] = self.state[(m - 1) * 16:m * 16] if x["av_l"] else own
        x["t"] = (self.state[(m - self.wm) * 16:(m - self.wm + 1) * 16]
                  if x["av_t"] else own)
        x["lw0"] = int(x["l"][0]) if x["av_l"] else 0
        x["tw0"] = int(x["t"][0]) if x["av_t"] else 0
        x["lk"] = x["lw0"] & 7 if x["av_l"] else -1
        x["tk"] = x["tw0"] & 7 if x["av_t"] else -1
        w0 = int(own[0])
        x["b"] = self.mb_flags(m, (w0 >> 4) & 15, (w0 >> 8) & 3)
        x["sh"], x["mask"] = self.coefs(m)
        return x

    # ---- lane 0: the header ----
    def walk_header(self, e, x):
        tab, b, m = self.tab, x["b"], x["m"]
        av_l, av_t, lw0, tw0 = x["av_l"], x["av_t"], x["lw0"], x["tw0"]
        lk, tk = x["lk"], x["tk"]
        is_i4 = not b["sel16"] and not b["is_inter"]
        intra_coded = b["coded"] and not b["is_inter"]
        t8_inc = ((lw0 >> 3) & 1 if av_l else 0) + \
            ((tw0 >> 3) & 1 if av_t else 0)
        # mb_skip_flag
        if self.kind != SL_I:
            e.ctx((24 if self.kind == SL_B else 11)
                  + (av_l and lk != K_SKIP) + (av_t and tk != K_SKIP),
                  b["skipped"], True)
        # mb_type
        if self.kind == SL_B:
            explicit = b["coded"] and not b["is_direct"]
            nd = (av_l and lk not in (K_SKIP, K_DIRECT)) \
                + (av_t and tk not in (K_SKIP, K_DIRECT))
            e.ctx(27 + nd, not b["is_direct"], b["coded"])
            one_list = explicit and b["is_inter"] and b["btype"] in (0, 1)
            on11 = b["btype"] == 2 or b["partd"] or not b["is_inter"]
            e.ctx(30, on11, explicit)
            e.ctx(32, b["btype"] == 1, one_list)
            tail = explicit and on11
            bits13 = 0 if b["is_inter"] else 13
            mbt = 0
            if self.parts and b["partd"]:
                mbt = 4 + 2 * tab[T_COMBO + int(self.c0[m]) * 3
                                  + int(self.c1[m])] + (b["ptype"] == 2)
                bits13 = (mbt - 3 if mbt <= 10 else 14 if mbt == 11
                          else (mbt + 4) // 2)
            e.ctx(31, (bits13 >> 3) & 1, tail)
            for sh in (2, 1, 0):
                e.ctx(32, (bits13 >> sh) & 1, tail)
            if self.parts:
                e.ctx(32, mbt & 1, tail and b["partd"] and mbt >= 12)
            first_ctx, rest = 32, (33, 34, 34, 35, 35)
        elif self.kind == SL_P:
            e.ctx(14, not b["is_inter"], b["coded"])
            inter_coded = b["coded"] and b["is_inter"]
            pb1 = b["ptype"] in (1, 2)
            e.ctx(15, pb1, inter_coded)
            e.ctx(17 if pb1 else 16, b["ptype"] in (1, 3), inter_coded)
            if self.p8x8:
                for _ in range(4):
                    e.ctx(21, 1, inter_coded and b["ptype"] == 3)
            first_ctx, rest = 17, (18, 19, 19, 20, 20)
        else:
            first_ctx = 3 + (lk == K_I16) + (tk == K_I16)
            rest = (6, 7, 8, 9, 10)
        e.ctx(first_ctx, b["sel16"], intra_coded)
        on16 = intra_coded and b["sel16"]
        i16mode = int(self.i16mode[m])
        e.term(0, on16)
        e.ctx(rest[0], b["cbp_luma"] > 0, on16)
        e.ctx(rest[1], b["cbp_chroma"] != 0, on16)
        e.ctx(rest[2], max(b["cbp_chroma"] - 1, 0),
              on16 and b["cbp_chroma"] != 0)
        e.ctx(rest[3], i16mode >> 1, on16)
        e.ctx(rest[4], i16mode & 1, on16)
        # Intra4x4 prediction modes, against the state pass's mpm
        on_i4 = b["coded"] and is_i4
        if self.t8_mode:
            e.ctx(399 + t8_inc, 0, on_i4)
        if on_i4:
            for idx in range(16):
                md, pm = int(self.modes[m * 16 + idx]), \
                    int(self.mpm[m * 16 + idx])
                is_mpm = md == pm
                e.ctx(68, is_mpm, True)
                rem = md - (md > pm)
                e.ctx(69, rem & 1, not is_mpm)
                e.ctx(69, (rem >> 1) & 1, not is_mpm)
                e.ctx(69, (rem >> 2) & 1, not is_mpm)
        # intra_chroma_pred_mode
        cmode = int(self.cmode[m])
        e.ctx(64 + ((lw0 >> 10) & 1 if av_l else 0)
              + ((tw0 >> 10) & 1 if av_t else 0), cmode != 0, intra_coded)
        e.ctx(67, cmode > 1, intra_coded and cmode != 0)
        e.ctx(67, cmode == 3, intra_coded and cmode > 1)
        # mvds, the state pass's
        if self.kind != SL_I:
            for l in range(2 if self.kind == SL_B else 1):
                d = self.mvds[m * 16 + l * 8:m * 16 + l * 8 + 8]
                on = self.mvd_on(b, l)
                a = self.mvd_abs(b, l, d)
                lc = x["l"][2 + 6 * l:8 + 6 * l]
                tc = x["t"][2 + 6 * l:8 + 6 * l]
                s = [(lc[0 + c] if av_l else 0) + (tc[2 + c] if av_t else 0)
                     for c in range(2)]
                self.mvd_rows(e, d[0:2], s, on[0])
                s = [((lc[4 + c] if av_l else 0) + a[0][c])
                     if b["ptype"] == 1
                     else (a[0][c] + (tc[4 + c] if av_t else 0))
                     for c in range(2)]
                self.mvd_rows(e, d[2:4], s, on[1])
                if self.kind == SL_P and self.p8x8:
                    s = [(lc[4 + c] if av_l else 0) + a[0][c]
                         for c in range(2)]
                    self.mvd_rows(e, d[4:6], s, on[2])
                    s = [a[2][c] + a[1][c] for c in range(2)]
                    self.mvd_rows(e, d[6:8], s, on[3])
        # coded_block_pattern
        cbp = b["cbp"]
        on_cbp = b["coded"] and not b["sel16"]
        lcl, tcl = (lw0 >> 4) & 15, (tw0 >> 4) & 15

        def cond_l(bit):
            return av_l and not (lcl >> bit) & 1

        def cond_t(bit):
            return av_t and not (tcl >> bit) & 1

        def own_z(bit):
            return int(not (cbp >> bit) & 1)
        e.ctx(73 + cond_l(1) + 2 * cond_t(2), cbp & 1, on_cbp)
        e.ctx(73 + own_z(0) + 2 * cond_t(3), (cbp >> 1) & 1, on_cbp)
        e.ctx(73 + cond_l(3) + 2 * own_z(0), (cbp >> 2) & 1, on_cbp)
        e.ctx(73 + own_z(2) + 2 * own_z(1), (cbp >> 3) & 1, on_cbp)
        cc = cbp >> 4
        lcc = (lw0 >> 8) & 3 if av_l else 0
        tcc = (tw0 >> 8) & 3 if av_t else 0
        e.ctx(77 + (lcc != 0) + 2 * (tcc != 0), cc != 0, on_cbp)
        e.ctx(81 + (lcc == 2) + 2 * (tcc == 2), max(cc - 1, 0),
              on_cbp and cc != 0)
        # transform_size_8x8_flag of an inter MB
        if self.t8_mode:
            e.ctx(399 + t8_inc, b["t8v"],
                  b["coded"] and b["is_inter"] and b["cbp_luma"] > 0)
        # mb_qp_delta
        e.ctx(60, 0, b["coded"] and (b["sel16"] or cbp > 0))

    # ---- one lane's piece (`walk_lane`) ----
    def walk_lane(self, sink, x, lane):
        e = Emit(sink)
        if lane == 0:
            self.walk_header(e, x)
            return
        tab, b, sh, mask = self.tab, x["b"], x["sh"], x["mask"]
        av_l, av_t, lw0, tw0 = x["av_l"], x["av_t"], x["lw0"], x["tw0"]
        ic = int(not b["is_inter"])
        if lane == 1:                             # I16 luma DC
            ca = (((lw0 >> 11) & 1 if x["lk"] == K_I16 else 0) if av_l
                  else 1)
            cb = (((tw0 >> 11) & 1 if x["tk"] == K_I16 else 0) if av_t
                  else 1)
            self.residual(e, sh, C_LDC, 16, mask[12] & 0xFFFF,
                          105 + tab[T_SIG], 166 + tab[T_SIG],
                          227 + tab[T_LVL], 85 + tab[T_CBF] + ca + 2 * cb,
                          b["coded"] and b["sel16"], False)
        elif lane < 18:                           # luma 4x4
            idx = lane - 2
            cat = 1 if b["sel16"] else 2
            w1 = int(x["own"][1])
            lw1 = int(x["l"][1]) if av_l else 0
            tw1 = int(x["t"][1]) if av_t else 0
            pos = tab[T_BLK + idx]
            by, bx = pos >> 2, pos & 3
            ca = ((w1 >> (pos - 1)) & 1 if bx > 0
                  else (lw1 >> (by * 4 + 3)) & 1 if av_l else ic)
            cb = ((w1 >> (pos - 4)) & 1 if by > 0
                  else (tw1 >> (12 + bx)) & 1 if av_t else ic)
            coded_blk = (b["coded"] and not b["t8v"] and (
                (b["sel16"] and b["cbp_luma"] > 0)
                or (not b["sel16"] and (b["cbp_luma"] >> (idx // 4)) & 1)))
            nz = self.luma_mask(mask, idx)
            self.residual(e, sh, C_LAC + idx * 16 + (1 if b["sel16"] else 0),
                          15 if b["sel16"] else 16,
                          nz >> 1 if b["sel16"] else nz,
                          105 + tab[T_SIG + cat], 166 + tab[T_SIG + cat],
                          227 + tab[T_LVL + cat],
                          85 + tab[T_CBF + cat] + ca + 2 * cb, coded_blk,
                          False)
        elif lane < 22:                           # luma 8x8
            b8 = lane - 18
            if self.t8_mode:
                self.residual8(e, sh, mask, b8,
                               b["t8v"] and (b["cbp_luma"] >> b8) & 1)
        elif lane < 24:                           # chroma DC
            comp = lane - 22
            lcc = (lw0 >> 8) & 3 if av_l else 0
            tcc = (tw0 >> 8) & 3 if av_t else 0
            ca = (((lw0 >> (12 + comp)) & 1 if lcc != 0 else 0) if av_l
                  else ic)
            cb = (((tw0 >> (12 + comp)) & 1 if tcc != 0 else 0) if av_t
                  else ic)
            self.residual(e, sh, C_CDC + comp * 4, 4,
                          (mask[12] >> (16 + 4 * comp)) & 0xF,
                          105 + tab[T_SIG + 3], 166 + tab[T_SIG + 3],
                          227 + tab[T_LVL + 3],
                          85 + tab[T_CBF + 3] + ca + 2 * cb,
                          b["coded"] and b["cbp_chroma"] >= 1, True)
        else:                                     # chroma AC
            j = lane - 24
            comp, idx = j >> 2, j & 3
            w0 = int(x["own"][0])
            shb = 14 + 4 * comp
            by, bx = idx >> 1, idx & 1
            ca = ((w0 >> (shb + idx - 1)) & 1 if bx > 0
                  else (lw0 >> (shb + idx + 1)) & 1 if av_l else ic)
            cb = ((w0 >> (shb + idx - 2)) & 1 if by > 0
                  else (tw0 >> (shb + idx + 2)) & 1 if av_t else ic)
            self.residual(e, sh, C_CAC + j * 16 + 1, 15,
                          self.cac_mask(mask, j) >> 1,
                          105 + tab[T_SIG + 4], 166 + tab[T_SIG + 4],
                          227 + tab[T_LVL + 4],
                          85 + tab[T_CBF + 4] + ca + 2 * cb,
                          b["coded"] and b["cbp_chroma"] == 2, False)
            if lane == 31:                        # end_of_slice_flag
                e.term(x["last_of_slice"], True)

    # ---- the passes ----
    def lane_counts(self, x):
        out = []
        for lane in range(32):
            cnt = Counter()
            self.walk_lane(cnt, x, lane)
            out.append(cnt.n)
        return np.asarray(out, np.int64)

    def count_pass(self):
        """Each lane counts its piece; the warp's exclusive scan places
        it in the MB, and its total is the MB's count."""
        for m in range(self.n):
            x = self.mb_ctx(m, self.slice_of(m // self.wm))
            cnt = self.lane_counts(x)
            self.lane_count[m] = cnt
            self.lane_off[m] = np.cumsum(cnt) - cnt
            self.mb_count[m] = cnt.sum()

    def scan_pass(self):
        most = 0
        for s in range(self.n_slices):
            lo, hi = self.rows[s] * self.wm, self.rows[s + 1] * self.wm
            carry = 0
            for m in range(lo, hi):
                self.mb_off[m] = carry
                carry += self.mb_count[m]
            self.counts[s] = carry
            most = max(most, carry)
        self.counts[self.n_slices] = most

    def emit_pass(self, recs, stride):
        """The emit pass into rows `stride` wide: each lane writes its
        piece at its MB's offset plus its own, no record past a row's
        end; then zeros from each count to the row's end."""
        for m in range(self.n):
            s = self.slice_of(m // self.wm)
            x = self.mb_ctx(m, s)
            for lane in range(32):
                off = int(self.mb_off[m] + self.lane_off[m, lane])
                self.walk_lane(Writer(recs, s * stride + off, stride - off),
                               x, lane)
        for i in range(self.n_slices * stride):
            if i % stride >= self.counts[i // stride]:
                recs[i] = 0
        return recs.reshape(self.n_slices, stride)

    def derive(self):
        """The CAVLC serializers' pass: the state pass without a state
        buffer -> (mvds [n, 2, 4, 2] or None, mpm [n, 16])."""
        for m in range(self.n):
            self.state_mb(m, derive_only=True)
        return self.derived()

    def derived(self):
        mvds = (None if self.kind == SL_I
                else self.mvds.reshape(self.n, 2, 4, 2))
        return mvds, self.mpm.reshape(self.n, 16)

    def run(self, cap):
        """The wrapper's call: the state, count, scan and emit passes with
        rows `cap` wide, nothing read back; then, where a slice is over
        the cap, the emit pass again into rows as wide as the largest
        count."""
        for m in range(self.n):
            self.state_mb(m)
        self.count_pass()
        self.scan_pass()
        recs = self.emit_pass(np.zeros(self.n_slices * cap, np.int64) - 7,
                              cap)
        if self.counts[-1] > cap:
            stride = int(self.counts[-1])
            recs = self.emit_pass(np.zeros(self.n_slices * stride, np.int64)
                                  - 7, stride)
        return recs, self.counts[:-1].copy()


def _picture(kind, tools, seed):
    """A seeded MB dict (numpy) of slice kind `kind`: P with `tools`; B
    with partitions when "parts" is in `tools`, the 8x8 PPS's zero map
    with "t8"; I with "t8" a zero map."""
    if kind == "p":
        return random_mbs(seed, WM, HM, tools=tools)
    if kind == "b":
        return random_b_mbs(seed, WM, HM, "parts" in tools, "t8" in tools)
    return random_mbs(seed, WM, HM, p_slice=False, tools=tools)


def _model(mb, kind, slices, cap, t8_mode=False):
    """KR's passes on `mb` -> (slice rows, records, counts, the model)."""
    rows = build_schedule(WM, HM, slices).slice_starts.tolist()
    kr = Kr(mb, _params(mb, kind, rows, t8_mode), kcr.tables())
    recs, counts = kr.run(cap)
    return rows, recs, counts, kr


def _params(mb, kind, rows, t8_mode=False):
    parts = {"p": "ptype", "b": "bptype"}.get(kind) in mb
    p8x8 = kind == "p" and parts and "mvq" in mb
    return mp.pack_params(WM, HM, rows, kind, t8_mode or "t8" in mb, parts,
                          p8x8)


def _reference_inputs(mb, kind, rows):
    """The reference's derived inputs in `preds_plain`' layout: the most
    probable modes of `binarize_frame_j`'s mode grid through
    `_mpm_grid_j`; P's mvds from `_partition_mvds_j` or, with one
    partition, `binarize_frame_j`'s `list_mvd`; B's per list from
    `_cell_grids2_j` + `_partition_mvds_core_j` or `list_mvd` (unmasked:
    `binarize_frame_j` then zeroes the uncoded ones)."""
    n = WM * HM
    mb_r, mb_c = np.arange(n) // WM, np.arange(n) % WM
    inter = (mb["is_inter"].astype(bool) if kind == "p"
             else mb["btype"] != 4 if kind == "b" else np.zeros(n, bool))
    is_i4 = ~mb["sel16"].astype(bool) & ~inter
    grid = np.full((HM * 4, WM * 4), -1, np.int32)
    for idx, (by, bx) in enumerate(BLK_ORDER):
        grid[mb_r * 4 + by, mb_c * 4 + bx] = np.where(is_i4,
                                                      mb["modes"][:, idx], -1)
    g = np.asarray(rdc._mpm_grid_j(jnp.asarray(grid), [r * 4 for r in rows]))
    mpm = np.stack([g[mb_r * 4 + by, mb_c * 4 + bx] for by, bx in BLK_ORDER],
                   1)
    if kind == "i":
        return None, mpm
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}

    def list_mvd(mv, use):
        nb = rdc._neighbor_mvs_j(
            jnp.asarray(np.where(use[:, None], mv, 0).reshape(HM, WM, 2)),
            jnp.asarray(np.where(use, 0, rmv.INTRA).reshape(HM, WM)
                        .astype(np.int32)), WM, HM, rows)
        return np.asarray(mv) - np.asarray(rmv.predict_mv_jnp(
            nb["mv_a"], nb["ref_a"], nb["mv_b"], nb["ref_b"], nb["mv_c"],
            nb["ref_c"]))
    mvds = np.zeros((n, 2, 4, 2), np.int64)
    if kind == "p" and "ptype" in mb:
        got = rdc._partition_mvds_j(jmb, WM, HM, rows)
        mvds[:, 0, 0], mvds[:, 0, 1] = got[0], got[1]
        if "mvq" in mb:
            mvds[:, 0, 2], mvds[:, 0, 3] = got[2][:, 2], got[2][:, 3]
    elif kind == "p":
        mvds[:, 0, 0] = list_mvd(mb["mv"], inter)
    for lx in range(2) if kind == "b" else ():
        use = mb[f"use{lx}"].astype(bool)
        if "bptype" not in mb:
            mvds[:, lx, 0] = list_mvd(mb[f"mv{lx}"], use)
            continue
        partd = mb["btype"] == 5
        c1_uses = (mb["c1"] != 0) if lx else (mb["c1"] != 1)
        use_b = np.where(partd, c1_uses, use)
        grids = rdc._cell_grids2_j(
            jmb["bptype"], jmb[f"mv{lx}"], jmb[f"mv{lx}b"], jnp.asarray(use),
            jnp.asarray(use_b), jnp.asarray(inter), WM, HM)
        p0_ref = jnp.asarray(np.where(inter & use, 0, rmv.INTRA)
                             .astype(np.int32))
        d0, d1, _ = rdc._partition_mvds_core_j(
            jmb["bptype"], jmb[f"mv{lx}"], jmb[f"mv{lx}b"], p0_ref, *grids,
            WM, HM, rows)
        mvds[:, lx, 0], mvds[:, lx, 1] = d0, d1
    return mvds, mpm


def _check_derived(mb, kind, rows, kr=None):
    """The derived mvds and most probable modes of the model (`kr`'s state
    pass, and the derive-only pass of the CAVLC serializers, KD) equal the
    port's plain `preds_plain`, and those equal the reference's.  KD over
    two pictures at once (`mb`, then its MBs in reverse order) equals
    each picture's alone, as does `preds_plain` over both."""
    tmb = {k: torch.as_tensor(v) for k, v in mb.items()}
    want = mp.preds_plain(tmb, WM, HM, rows, kind)
    ref = _reference_inputs(mb, kind, rows)
    models = [Kr(mb, _params(mb, kind, rows), mp.tables()).derive()]
    if kr is not None:
        models.append(kr.derived())
    for got in models:
        assert (got[0] is None) == (kind == "i")
        for g, w, r, name in zip(got, want, ref, ("mvds", "mpm")):
            if g is not None:
                assert_equal(w, r, f"plain {name} against the reference")
                assert_equal(g, w, f"the model's {name}")
    rev = {k: v[::-1].copy() for k, v in mb.items()}
    two = {k: np.concatenate([mb[k], rev[k]]) for k in mb}
    each = [want, mp.preds_plain({k: torch.as_tensor(v)
                                  for k, v in rev.items()},
                                 WM, HM, rows, kind)]
    plain2 = mp.preds_plain({k: torch.as_tensor(v) for k, v in two.items()},
                            WM, HM, rows, kind, 2)
    model2 = Kr(two, _params(mb, kind, rows), mp.tables(), pics=2).derive()
    for i, name in enumerate(("mvds", "mpm")):
        if kind == "i" and i == 0:
            assert plain2[0] is None and model2[0] is None
            continue
        whole = torch.cat([e[i] for e in each])
        assert_equal(plain2[i], whole, f"two pictures' plain {name}")
        assert_equal(model2[i], whole, f"two pictures' model {name}")


CASES = [("i", (), 1), ("i", ("t8",), 3),
         ("p", (), 1), ("p", ("ptype",), 3), ("p", ("ptype", "mvq"), 1),
         ("p", ("ptype", "mvq", "t8"), 3), ("p", ("ptype", "mvq", "t8"), 1),
         ("b", (), 3), ("b", ("parts",), 1), ("b", ("parts", "t8"), 3),
         ("b", ("t8",), 1)]


@pytest.mark.parametrize("kind,tools,slices", CASES)
def test_kr_walk_matches_reference_binarizer(kind, tools, slices):
    """Every slice's records from the model of KR's passes equal the
    reference binarizer's, and the packed rows (zeros past each count)
    equal the plain version's; the model's derived mvds and most probable
    modes (also without direct MBs in a B picture) equal the plain
    version's and the reference's; the lanes' pieces, placed by the warp
    scan, make up each MB's count."""
    mb = _picture(kind, tools, 17 * slices + len(tools) + ord(kind))
    cap = WM * HM * 768
    rows, recs, counts, kr = _model(mb, kind, slices, cap)
    k, a, b, v, skipped = ocb.binarize_frame(
        mb, WM, HM, rows, 28, p_slice=kind == "p", b_slice=kind == "b")
    bounds = rows + [HM]
    for s in range(slices):
        want = ocb.slice_records(k, a, b, v, WM, bounds[s], bounds[s + 1])
        assert counts[s] == len(want[0]), s
        got = tcb.unpack_records(recs[s, :counts[s]].astype(np.int32))
        for name, gv, wv in zip(("kind", "a", "b"), got, want):
            assert_equal(gv, wv, f"slice {s} {name}")
    tmb = {key: torch.as_tensor(val) for key, val in mb.items()}
    precs, pcounts = kcr.records_plain(tmb, WM, HM, rows, kind, cap)
    assert_equal(counts, pcounts)
    assert_equal(recs, precs)
    _check_derived(mb, kind, rows, kr)
    if kind == "b":
        nodirect = dict(mb, btype=np.where(mb["btype"] == 3, 2,
                                           mb["btype"]).astype(np.int32))
        _check_derived(nodirect, kind, rows)
    # the warp: the header lane and the block lanes all carry records, and
    # their pieces make up each MB's count
    assert_equal(kr.lane_count.sum(1), kr.mb_count)
    assert (kr.lane_count[:, 0] > 0).all()
    assert kr.lane_count[:, 2:18].any() and kr.lane_count[:, 24:].any()
    if kind == "p" and "t8" in tools:
        assert kr.lane_count[:, 18:22].any()
    # the MB offsets are each slice's exclusive scan of the MB counts
    for s in range(slices):
        lo, hi = bounds[s] * WM, bounds[s + 1] * WM
        assert_equal(kr.mb_off[lo:hi],
                     np.cumsum(kr.mb_count[lo:hi]) - kr.mb_count[lo:hi])
    # what the case covers: skips and coded MBs of every kind the slice
    # allows, and t8 MBs where the PPS has the transform
    kinds = kr.state[0::16] & 7
    want_kinds = {"i": {K_I4, K_I16},
                  "p": {K_SKIP, K_INTER, K_I4, K_I16},
                  "b": {K_SKIP, K_DIRECT, K_INTER, K_I4, K_I16}}[kind]
    assert set(kinds) == want_kinds
    if kind == "p" and "t8" in tools:
        assert ((kr.state[0::16] >> 3) & 1).any()


@pytest.mark.parametrize("kind,slices", [("p", 3), ("i", 1)])
def test_kr_over_cap_emits_every_record(kind, slices):
    """A slice over the record cap: the emit pass writes into rows as
    wide as the largest slice, and every record is kept, as the plain
    version keeps them (the first emit, into rows as wide as the cap,
    writes nothing past a row's end); large levels (QP-0-like) take the
    Exp-Golomb escapes of the levels and the mvds, which the derived
    mvds hold as the plain version's do."""
    mb = _picture(kind, ("ptype", "mvq", "t8") if kind == "p" else (),
                  90 + slices)
    for key in ("luma_ac", "chroma_ac", "luma_dc", "chroma_dc"):
        mb[key] = (mb[key] * 37).astype(np.int32)
    if kind == "p":
        mb["mvq"] = (mb["mvq"] * 9).astype(np.int32)
    cap = 64
    rows, recs, counts, kr = _model(mb, kind, slices, cap)
    assert counts.max() > cap and recs.shape == (slices, counts.max())
    tmb = {key: torch.as_tensor(val) for key, val in mb.items()}
    precs, pcounts = kcr.records_plain(tmb, WM, HM, rows, kind, cap)
    assert_equal(counts, pcounts)
    assert_equal(recs, precs)
    _check_derived(mb, kind, rows, kr)
    kk, _, bb = tcb.unpack_records(precs[0, :pcounts[0]].numpy())
    # the escapes' bypass records (a sign's is one bit) were coded
    assert ((kk == 1) & (bb > 1)).any()


def test_kr_tables_and_params():
    """The kernel's constant table has the layout of the CUDA source's
    `T_*` offsets, `pack_params` the layout of `Params`, the wrappers'
    pointers the order of `Io` (`parse`), and the model's zig-zag inverse
    `BLK_ORDER`'s."""
    from tpu264_torch.coding.b_mbtypes import COMBO_IDX
    from tpu264_torch.coding.wavefront import BLK_ORDER
    from tpu264_torch.entropy.cabac_ctx import (CBF_CAT_OFF, LAST8_MAP,
                                                LVL_CAT_OFF, SIG8_MAP,
                                                SIG_CAT_OFF)
    tab = kcr.tables()
    assert tab.shape == (TABLE_WORDS,) and tab.dtype == np.int32
    assert_equal(mp.tables(), tab[:PRED_TABLE_WORDS])
    for off, want in ((T_CBF, CBF_CAT_OFF), (T_SIG, SIG_CAT_OFF),
                      (T_LVL, LVL_CAT_OFF), (T_SIG8, SIG8_MAP),
                      (T_LAST8, LAST8_MAP[:63]), (T_COMBO, COMBO_IDX),
                      (T_BLK, [by * 4 + bx for by, bx in BLK_ORDER])):
        assert_equal(tab[off:off + len(want)], want)
    src = (kcr.__file__.rsplit("/kernels/", 1)[0]
           + "/csrc/cabac_records.cu")
    text = open(src).read()
    for name, val in (("T_CBF", T_CBF), ("T_SIG", T_SIG), ("T_LVL", T_LVL),
                      ("T_SIG8", T_SIG8), ("T_LAST8", T_LAST8),
                      ("T_COMBO", T_COMBO), ("T_BLK", T_BLK),
                      ("kTableWords", TABLE_WORDS),
                      ("kPredTableWords", PRED_TABLE_WORDS),
                      ("kStateWords", kcr.STATE_WORDS),
                      ("kMaxSlices", mp.MAX_SLICES)):
        assert f"constexpr int {name} = {val};" in text, name
    assert mp.pack_params(11, 9, [0, 3, 6], "b", True, True, False) == \
        [11, 9, 2, 1, 1, 0, 3, 0, 3, 6, 9]
    names = list(mp.INPUTS) + ["tables", "mvds", "mpm", "state",
                                     "mb_count", "mb_off", "lane_off",
                                     "counts"]
    for i, key in enumerate(names):
        assert re.search(rf"io\.{key} = \([^)]*\)a\[{i}\];", text), key
    for idx, (by, bx) in enumerate(BLK_ORDER):
        assert zz_of(by, bx) == idx
