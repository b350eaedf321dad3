"""Kernel KR's passes (`csrc/cabac_records.cu`: CABAC binarize + compact
of a picture) emulated in numpy on the CPU (no card, no reference encoder,
no JAX program): the state pass, the count pass, the per-slice scan and
the emit pass, the count and the emit through one walk of a macroblock's
syntax with two sinks, in the CUDA source's branch order, on the inputs
the wrapper hands the kernel (`kernels/cabac_records.py`: the MB dict,
`inputs`' mvds and most probable modes, `tables`, `pack_params`).  The
records are held to the reference's numpy binarizer
(`tpu264.entropy.cabac_binarize.binarize_frame` + `slice_records`) slice
by slice, and the packed rows to `records_plain`'s, zeros past each count
included: I slices, P slices with every tool set, B slices with and
without partitions and the 8x8 PPS, one and three slices, and slices over
the record cap.  Tolerance 0."""

import numpy as np
import pytest
import torch

from tpu264.entropy import cabac_binarize as ocb

from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.kernels import cabac_records as kcr
from tpu264_torch.tools.synth_inputs import random_b_mbs, random_mbs

from torch_util import assert_equal, to_np

WM, HM = 11, 9
M32 = 0xFFFFFFFF

# `T_*` offsets, the MB kinds and the slice kinds of the CUDA source
T_CBF, T_SIG, T_LVL, T_SIG8, T_LAST8, T_COMBO, T_BLK = 0, 5, 10, 16, 79, \
    142, 151
TABLE_WORDS = 167
K_SKIP, K_INTER, K_I4, K_I16, K_DIRECT = 0, 1, 2, 3, 4
SL_I, SL_P, SL_B = 0, 1, 2


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


class Kr:
    """The kernel on one picture: `Io` from the wrapper's inputs, `Params`
    parsed from `pack_params`' table as `tpu264_cabac_records` parses
    it."""

    def __init__(self, mb, mvds, mpm, params, tab):
        q = list(params)
        (self.wm, self.hm, self.kind, self.t8_mode, self.parts, self.p8x8,
         self.n_slices) = q[:7]
        self.rows = q[7:8 + self.n_slices]
        assert self.rows[0] == 0 and self.rows[-1] == self.hm
        n = self.wm * self.hm
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
        self.mvds = None if mvds is None else to_np(mvds).reshape(-1)
        self.mpm = to_np(mpm).reshape(-1)
        self.tab = [int(x) for x in tab]
        self.state = np.zeros(n * 16, np.int64)
        self.mb_count = np.zeros(n, np.int64)
        self.mb_off = np.zeros(n, np.int64)
        self.counts = np.zeros(self.n_slices + 1, np.int64)

    def any_nz(self, arr, at, n):
        return bool((arr[at:at + n] != 0).any())

    # ---- the macroblock's own flags ----
    def mb_flags(self, m, st):
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
        if st is not None:
            cl, cc = (st >> 4) & 15, (st >> 8) & 3
        else:
            cl = 0
            for b8 in range(4):
                if self.any_nz(self.luma_ac, m * 256 + b8 * 64, 64):
                    cl |= 1 << b8
            if b["sel16"] and cl > 0:
                cl = 15
            cc = (2 if self.any_nz(self.chroma_ac, m * 128, 128)
                  else 1 if self.any_nz(self.chroma_dc, m * 8, 8) else 0)
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

    def mvd_abs(self, b, m, l):
        d = self.mvds[m * 16 + l * 8:m * 16 + l * 8 + 8]
        if self.kind == SL_P:
            on0 = b["coded"] and b["is_inter"]
            on = [on0, on0 and b["ptype"] > 0]
            on += [bool(self.p8x8) and on0 and b["ptype"] == 3] * 2
        else:
            on = [b["coded"] and b["exp"][l],
                  b["coded"] and b["exp_b"][l] and b["partd"], False, False]
        a = [[abs(int(d[2 * q + c])) if on[q] else 0 for c in range(2)]
             for q in range(4)]
        return a, on

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
    def state_mb(self, m):
        b = self.mb_flags(m, None)
        lac = m * 256
        w0 = (b["kind"] | (b["t8v"] << 3) | (b["cbp_luma"] << 4)
              | (b["cbp_chroma"] << 8))
        if not b["is_inter"] and self.cmode[m] != 0:
            w0 |= 1 << 10
        if b["sel16"] and b["coded"] and self.any_nz(self.luma_dc, m * 16,
                                                      16):
            w0 |= 1 << 11
        for comp in range(2):
            if (self.any_nz(self.chroma_dc, m * 8 + comp * 4, 4)
                    and b["cbp_chroma"] >= 1 and b["coded"]):
                w0 |= 1 << (12 + comp)
            for idx in range(4):
                if (b["cbp_chroma"] == 2 and b["coded"] and self.any_nz(
                        self.chroma_ac,
                        m * 128 + (comp * 4 + idx) * 16 + 1, 15)):
                    w0 |= 1 << (14 + 4 * comp + idx)
        w1 = 0
        for idx in range(16):
            bit8 = bool((b["cbp_luma"] >> (idx // 4)) & 1)
            if b["sel16"]:
                l4 = (self.any_nz(self.luma_ac, lac + idx * 16 + 1, 15)
                      and b["cbp_luma"] > 0)
            else:
                l4 = self.any_nz(self.luma_ac, lac + idx * 16, 16) and bit8
            l4 = l4 and b["coded"]
            if b["t8v"]:
                l4 = bit8
            if l4:
                w1 |= 1 << self.tab[T_BLK + idx]
        st = self.state[m * 16:(m + 1) * 16]
        st[0], st[1] = w0, w1
        for l in range(2):
            c = [[0, 0], [0, 0], [0, 0]]
            if self.kind != SL_I and (l == 0 or self.kind == SL_B):
                c = self.cells(b, self.mvd_abs(b, m, l)[0])
            for k in range(3):
                for comp in range(2):
                    st[2 + 6 * l + 2 * k + comp] = min(c[k][comp], 255)
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

    def residual(self, e, arr, at, mc, sig, last_b, lvl, cbf_ctx, coded,
                 cdc_inc):
        nz = 0
        if coded:
            for i in range(mc):
                if arr[at + i] != 0:
                    nz |= 1 << i
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
        self.level_rows(e, nz, lambda q: int(arr[at + q]), lvl)

    def residual8(self, e, m, b8, on):
        if not on:
            return
        base = m * 256 + b8 * 64

        def get(q):
            return int(self.luma_ac[base + (q & 3) * 16 + (q >> 2)])
        nz = 0
        for q in range(64):
            if get(q) != 0:
                nz |= 1 << q
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

    # ---- one macroblock's records ----
    def walk_mb(self, e, m, av_l, av_t, lst, tst, last_of_slice):
        tab = self.tab
        own = self.state[m * 16:(m + 1) * 16]
        b = self.mb_flags(m, int(own[0]))
        lw0 = int(lst[0]) if av_l else 0
        tw0 = int(tst[0]) if av_t else 0
        lk = lw0 & 7 if av_l else -1
        tk = tw0 & 7 if av_t else -1
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
        # Intra4x4 prediction modes
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
        # mvds
        if self.kind != SL_I:
            for l in range(2 if self.kind == SL_B else 1):
                a, on = self.mvd_abs(b, m, l)
                d = self.mvds[m * 16 + l * 8:m * 16 + l * 8 + 8]
                lc = lst[2 + 6 * l:8 + 6 * l]
                tc = tst[2 + 6 * l:8 + 6 * l]
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
        # residual blocks
        ic = int(not b["is_inter"])
        ca = (((lw0 >> 11) & 1 if lk == K_I16 else 0) if av_l else 1)
        cb = (((tw0 >> 11) & 1 if tk == K_I16 else 0) if av_t else 1)
        self.residual(e, self.luma_dc, m * 16, 16, 105 + tab[T_SIG],
                      166 + tab[T_SIG], 227 + tab[T_LVL],
                      85 + tab[T_CBF] + ca + 2 * cb,
                      b["coded"] and b["sel16"], False)
        cat = 1 if b["sel16"] else 2
        w1 = int(own[1])
        lw1 = int(lst[1]) if av_l else 0
        tw1 = int(tst[1]) if av_t else 0
        for idx in range(16):
            pos = tab[T_BLK + idx]
            by, bx = pos >> 2, pos & 3
            ca = ((w1 >> (pos - 1)) & 1 if bx > 0
                  else (lw1 >> (by * 4 + 3)) & 1 if av_l else ic)
            cb = ((w1 >> (pos - 4)) & 1 if by > 0
                  else (tw1 >> (12 + bx)) & 1 if av_t else ic)
            coded_blk = (b["coded"] and not b["t8v"] and (
                (b["sel16"] and b["cbp_luma"] > 0)
                or (not b["sel16"] and (b["cbp_luma"] >> (idx // 4)) & 1)))
            self.residual(e, self.luma_ac,
                          m * 256 + idx * 16 + (1 if b["sel16"] else 0),
                          15 if b["sel16"] else 16, 105 + tab[T_SIG + cat],
                          166 + tab[T_SIG + cat], 227 + tab[T_LVL + cat],
                          85 + tab[T_CBF + cat] + ca + 2 * cb, coded_blk,
                          False)
        if self.t8_mode:
            for b8 in range(4):
                self.residual8(e, m, b8,
                               b["t8v"] and (b["cbp_luma"] >> b8) & 1)
        for comp in range(2):
            ca = (((lw0 >> (12 + comp)) & 1 if lcc != 0 else 0) if av_l
                  else ic)
            cb = (((tw0 >> (12 + comp)) & 1 if tcc != 0 else 0) if av_t
                  else ic)
            self.residual(e, self.chroma_dc, m * 8 + comp * 4, 4,
                          105 + tab[T_SIG + 3], 166 + tab[T_SIG + 3],
                          227 + tab[T_LVL + 3],
                          85 + tab[T_CBF + 3] + ca + 2 * cb,
                          b["coded"] and b["cbp_chroma"] >= 1, True)
        w0 = int(own[0])
        for comp in range(2):
            sh = 14 + 4 * comp
            for idx in range(4):
                by, bx = idx >> 1, idx & 1
                ca = ((w0 >> (sh + idx - 1)) & 1 if bx > 0
                      else (lw0 >> (sh + idx + 1)) & 1 if av_l else ic)
                cb = ((w0 >> (sh + idx - 2)) & 1 if by > 0
                      else (tw0 >> (sh + idx + 2)) & 1 if av_t else ic)
                self.residual(e, self.chroma_ac,
                              m * 128 + (comp * 4 + idx) * 16 + 1, 15,
                              105 + tab[T_SIG + 4], 166 + tab[T_SIG + 4],
                              227 + tab[T_LVL + 4],
                              85 + tab[T_CBF + 4] + ca + 2 * cb,
                              b["coded"] and b["cbp_chroma"] == 2, False)
        # end_of_slice_flag
        e.term(last_of_slice, True)

    def slice_of(self, r):
        s = 0
        while s + 1 < self.n_slices and self.rows[s + 1] <= r:
            s += 1
        return s

    def walk(self, sink, m, s):
        r, c = divmod(m, self.wm)
        av_l, av_t = c > 0, r > self.rows[s]
        own = self.state[m * 16:(m + 1) * 16]
        lst = self.state[(m - 1) * 16:m * 16] if av_l else own
        tst = self.state[(m - self.wm) * 16:(m - self.wm + 1) * 16] \
            if av_t else own
        self.walk_mb(Emit(sink), m, av_l, av_t, lst, tst,
                     m == self.rows[s + 1] * self.wm - 1)

    # ---- the passes ----
    def count_pass(self):
        for m in range(self.n):
            cnt = Counter()
            self.walk(cnt, m, self.slice_of(m // self.wm))
            self.mb_count[m] = cnt.n

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

    def emit_pass(self, stride):
        recs = np.zeros(self.n_slices * stride, np.int64) - 7   # "empty"
        for m in range(self.n):
            s = self.slice_of(m // self.wm)
            off = int(self.mb_off[m])
            self.walk(Writer(recs, s * stride + off, stride - off), m, s)
        for i in range(self.n_slices * stride):
            if i % stride >= self.counts[i // stride]:
                recs[i] = 0
        return recs.reshape(self.n_slices, stride)

    def run(self, cap):
        """The wrapper's call: the state, count and scan passes, the
        host's read of the largest count, and the emit pass into rows as
        wide as `cap` or, where a slice is over it, the largest count."""
        for m in range(self.n):
            self.state_mb(m)
        self.count_pass()
        self.scan_pass()
        recs = self.emit_pass(max(cap, int(self.counts[-1])))
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
    """KR's passes on `mb` with the wrapper's inputs -> (records, counts,
    the model)."""
    rows = build_schedule(WM, HM, slices).slice_starts.tolist()
    tmb = {k: torch.as_tensor(v) for k, v in mb.items()}
    mvds, mpm = kcr.inputs(tmb, WM, HM, rows, kind)
    parts = {"p": "ptype", "b": "bptype"}.get(kind) in mb
    p8x8 = kind == "p" and parts and "mvq" in mb
    params = kcr.pack_params(WM, HM, rows, kind, t8_mode or "t8" in mb,
                             parts, p8x8)
    kr = Kr(mb, mvds, mpm, params, kcr.tables())
    recs, counts = kr.run(cap)
    return rows, recs, counts, kr


CASES = [("i", (), 1), ("i", ("t8",), 3),
         ("p", (), 1), ("p", ("ptype",), 3), ("p", ("ptype", "mvq"), 1),
         ("p", ("ptype", "mvq", "t8"), 3), ("p", ("ptype", "mvq", "t8"), 1),
         ("b", (), 3), ("b", ("parts",), 1), ("b", ("parts", "t8"), 3),
         ("b", ("t8",), 1)]


@pytest.mark.parametrize("kind,tools,slices", CASES)
def test_kr_walk_matches_reference_binarizer(kind, tools, slices):
    """Every slice's records from the model of KR's passes equal the
    reference binarizer's, and the packed rows (zeros past each count)
    equal the plain version's."""
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
    version keeps them; large levels (QP-0-like) take the Exp-Golomb
    escapes of the levels and the mvds."""
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
    kk, _, bb = tcb.unpack_records(precs[0, :pcounts[0]].numpy())
    # the escapes' bypass records (a sign's is one bit) were coded
    assert ((kk == 1) & (bb > 1)).any()


def test_kr_tables_and_params():
    """The kernel's constant table has the layout of the CUDA source's
    `T_*` offsets, and `pack_params` the layout of `Params`."""
    from tpu264_torch.coding.b_mbtypes import COMBO_IDX
    from tpu264_torch.coding.wavefront import BLK_ORDER
    from tpu264_torch.entropy.cabac_ctx import (CBF_CAT_OFF, LAST8_MAP,
                                                LVL_CAT_OFF, SIG8_MAP,
                                                SIG_CAT_OFF)
    tab = kcr.tables()
    assert tab.shape == (TABLE_WORDS,) and tab.dtype == np.int32
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
                      ("kStateWords", kcr.STATE_WORDS),
                      ("kMaxSlices", kcr.MAX_SLICES)):
        assert f"constexpr int {name} = {val};" in text, name
    assert kcr.pack_params(11, 9, [0, 3, 6], "b", True, True, False) == \
        [11, 9, 2, 1, 1, 0, 3, 0, 3, 6, 9]
