"""Kernel KV's passes (`csrc/cavlc_slices.cu`: CAVLC serialize + pack of a
picture or of a chunk of all-intra pictures) emulated in numpy on the CPU
(no card, no reference encoder, no JAX program): a warp a macroblock.
The state pass takes the coefficients' significance masks from 13
ballots, the coded_block_pattern, the skip flag and the TotalCoeff of
every luma and chroma AC block; the count and emit passes walk the MB in
28 pieces, one a lane (the header, then the 27 residual blocks in the
plain version's slot order: coeff_token, trailing-one signs, levels with
the suffix-length adaptation and the escapes, total_zeros, run_before),
in the CUDA source's branch order, and a warp exclusive scan of the
pieces' lengths places each piece; the scan pass takes, a block a slice
in tiles of 512 threads, each coded MB's mb_skip_run (a max-scan of the
coded MBs' positions) and the exclusive scan of the MBs' bits; the emit
pass adds each code's two parts into its slice's words modulo 2^32 and
drops the words at or past the cap.  The inputs are the MB dict, the
mvds and most probable modes of KD (`kernels/mb_preds.py` `preds_plain`,
which `tests/test_torch_records_design.py` holds to KD's model and to
the reference), `tables` (`kernels/cavlc_slices.py`) and `pack_params`
(`kernels/mb_preds.py`).

The words (32 bits each), bit counts and skip maps are held to the
reference's jnp serializer and packer
(`tpu264/entropy/device_cavlc.py` `serialize_frame_j`,
`serialize_frame_p_j`, `serialize_frame_b_j` + `pack_slices_j`) and to
the port's plain version (`kernels/cavlc_slices.py` `serialize_plain`)
on QCIF pictures: I slices with one and three slices and the 8x8 PPS, a
chunk of three I pictures, P slices with the tools off, with 16x8/8x16
and with every tool (P_8x8, the 8x8 transform), B slices with and
without partitions and the 8x8 PPS, dense QP-0-like blocks that reach
the level escapes, and slices over the word cap.  Tolerance 0."""

import re

import numpy as np
import torch

import jax.numpy as jnp

from tpu264.entropy import device_cavlc as rdc

from tpu264_torch.coding.b_mbtypes import COMBO_IDX
from tpu264_torch.coding.wavefront import BLK_ORDER, build_schedule
from tpu264_torch.entropy import cavlc_tables as ct
from tpu264_torch.entropy import mb_syntax
from tpu264_torch.kernels import cavlc_slices as kcv
from tpu264_torch.kernels import mb_preds as mp
from tpu264_torch.tools.synth_inputs import random_b_mbs, random_mbs

from torch_util import assert_equal, to_np

M32 = 0xFFFFFFFF
SL_I, SL_P, SL_B = 0, 1, 2
# `T_*` offsets and sizes of the CUDA source
T_CT, T_CCT, T_CTZ, T_TZ, T_RB = 0, 272, 292, 304, 560
T_CBPI, T_CBPP, T_COMBO, T_BLK = 672, 720, 768, 777
TABLE_WORDS, STATE_WORDS, SCAN_THREADS = 793, 8, 512
# a macroblock's coefficients in shared memory: luma AC, chroma AC, luma
# DC, chroma DC
C_LAC, C_CAC, C_LDC, C_CDC = 0, 256, 384, 400
COEF_WORDS = 408


def bitlen_m1(v: int) -> int:
    return int(v).bit_length() - 1


def zz_of(by, bx):
    return 8 * (by >> 1) + 4 * (bx >> 1) + 2 * (by & 1) + (bx & 1)


def popc(v: int) -> int:
    return bin(v).count("1")


class Counter:
    def __init__(self):
        self.n = 0

    def put(self, v, length):
        self.n += length


class Lengths(Counter):
    """A counting sink that also counts the 28-bit codes (the level
    escapes)."""

    def __init__(self):
        super().__init__()
        self.escapes = 0

    def put(self, v, length):
        self.escapes += length == 28
        self.n += length


class Writer:
    """`Writer` of the CUDA source: each code's hi and lo parts added to
    their words, a word's sum kept until the lane moves on."""

    def __init__(self, words, row: int, cap: int, pos: int):
        self.words, self.row, self.cap, self.pos = words, row, cap, pos
        self.cw, self.acc = -1, 0

    def flush(self):
        if 0 <= self.cw < self.cap and self.acc:
            w = self.words
            w[self.row, self.cw] = (w[self.row, self.cw] + self.acc) & M32

    def add(self, w, v):
        if w != self.cw:
            self.flush()
            self.cw, self.acc = w, 0
        self.acc = (self.acc + v) & M32

    def put(self, v, length):
        if length <= 0:
            return
        v = int(v) & M32
        off, w = self.pos & 31, self.pos >> 5
        take = min(length, 32 - off)
        rem = length - take
        self.add(w, ((v >> rem) << (32 - off - take)) & M32)
        if rem > 0:
            self.add(w + 1, ((v & ((1 << rem) - 1)) << (32 - rem)) & M32)
        self.pos += length


def put_ue(s, v):
    s.put(v + 1, 2 * bitlen_m1(v + 1) + 1)


def se_to_ue(v):
    return 2 * v - 1 if v > 0 else -2 * v


def put_tab(s, e):
    s.put(e & 0xFFFF, e >> 16)


def put_level(s, lc, sl):
    if sl == 0:
        if lc < 14:
            s.put(1, lc + 1)
        elif lc < 30:
            s.put((1 << 4) | (lc - 14), 19)
        else:
            s.put((1 << 12) | (lc - 30), 28)
        return
    prefix = lc >> sl
    if prefix < 15:
        s.put((1 << sl) | (lc & ((1 << sl) - 1)), prefix + 1 + sl)
    else:
        s.put((1 << 12) | (lc - (15 << sl)), 28)


def residual(s, p, mc, nc, tab):
    """`residual` of the CUDA source: one block of `mc` scan-order
    coefficients `p`, nC `nc` (-1: chroma DC)."""
    lev, idx = [], []
    for i in range(mc - 1, -1, -1):
        if p[i] != 0:
            lev.append(int(p[i]))
            idx.append(i)
    tc = len(lev)
    t1 = 0
    while t1 < 3 and t1 < tc and abs(lev[t1]) == 1:
        t1 += 1
    c = 4 * tc + t1
    if nc == -1:
        put_tab(s, tab[T_CCT + min(c, 19)])
    else:
        tsel = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
        put_tab(s, tab[T_CT + tsel * 68 + c])
    for k in range(t1):
        s.put(int(lev[k] < 0), 1)
    sl = 1 if tc > 10 and t1 < 3 else 0
    for k in range(t1, tc):
        v = lev[k]
        a = abs(v)
        lc = 2 * a - 2 if v > 0 else 2 * a - 1
        if k == t1 and t1 < 3:
            lc -= 2
        put_level(s, lc, sl)
        if sl == 0:
            sl = 1
        if a > (3 << (sl - 1)) and sl < 6:
            sl += 1
    if tc == 0:
        return
    tz = idx[0] + 1 - tc
    if tc < mc:
        if mc == 4:
            put_tab(s, tab[T_CTZ + min(tc - 1, 2) * 4 + min(max(tz, 0), 3)])
        else:
            put_tab(s, tab[T_TZ + (tc - 1) * 16 + min(max(tz, 0), 15)])
    zl = tz
    k = 0
    while k < tc - 1 and k + 1 < mc and zl > 0:
        run = idx[k] - idx[k + 1] - 1
        row = min(max(min(zl, 7) - 1, 0), 6)
        put_tab(s, tab[T_RB + row * 16 + min(max(run, 0), 15)])
        zl -= run
        k += 1


class Mb:
    pass


class Kv:
    """KV's four passes on a picture (or chunk) in numpy, from the MB dict
    `mb`, `pack_params` `params`, `tables` `tab`, KD's `mvds` [n, 16] and
    `mpm` [n, 16]."""

    def __init__(self, mb, params, tab, mvds, mpm, pics, cap):
        q = list(params)
        (self.wm, self.hm, self.kind, self.t8_mode, self.parts, self.p8x8,
         self.n_slices) = q[:7]
        self.rows = q[7:8 + self.n_slices]
        assert self.rows[0] == 0 and self.rows[-1] == self.hm
        self.pics, self.cap = pics, cap
        self.mb, self.tab = mb, [int(v) for v in tab]
        self.mvds, self.mpm = mvds, mpm
        self.n = self.wm * self.hm * pics
        self.state = np.zeros((self.n, STATE_WORDS), np.int64)
        self.mb_count = np.zeros(self.n, np.int64)
        self.mb_off = np.zeros(self.n, np.int64)
        self.run = np.zeros(self.n, np.int64)
        self.lane_off = np.zeros((self.n, 32), np.int64)
        self.lane_count = np.zeros((self.n, 32), np.int64)
        g = pics * self.n_slices
        self.words = np.full((g, cap), 7, np.int64)    # not yet zeroed
        self.nbits = np.zeros(g, np.int64)
        self.skipped = np.zeros(self.n, bool)

    # ---- helpers of the CUDA source ----
    def slice_of(self, r):
        s = 0
        while s + 1 < self.n_slices and self.rows[s + 1] <= r:
            s += 1
        return s

    def load_mb(self, m):
        """The warp's coalesced load and its 13 ballots."""
        mb = self.mb
        coef = np.concatenate([mb["luma_ac"][m].ravel(),
                               mb["chroma_ac"][m].ravel(),
                               mb["luma_dc"][m].ravel(),
                               mb["chroma_dc"][m].ravel()]).astype(np.int64)
        assert coef.size == COEF_WORDS
        padded = np.concatenate([coef, np.zeros(13 * 32 - COEF_WORDS,
                                                np.int64)])
        mask = [int(((padded[32 * k:32 * k + 32] != 0)
                     << np.arange(32)).sum()) for k in range(13)]
        return coef, mask

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
        cc = 2 if mask[8] | mask[9] | mask[10] | mask[11] else \
            1 if (mask[12] >> 16) & 0xFF else 0
        return cl, cc

    def mb_flags(self, m, cl, cc):
        mb, b = self.mb, Mb()
        b.btype, b.partd, b.ptype = 0, False, 0
        b.exp, b.exp_b = [False, False], [False, False]
        b.is_direct = False
        if self.kind == SL_B:
            bt = int(mb["btype"][m])
            b.btype = bt
            b.is_inter, b.partd, b.is_direct = bt != 4, bt == 5, bt == 3
            if self.parts:
                c0, c1 = int(mb["c0"][m]), int(mb["c1"][m])
                b.ptype = int(mb["bptype"][m])
                b.exp = [c0 != 1 if b.partd else bt in (0, 2),
                         c0 != 0 if b.partd else bt in (1, 2)]
                b.exp_b = [b.partd and c1 != 1, b.partd and c1 != 0]
            else:
                b.exp = [bt in (0, 2), bt in (1, 2)]
        elif self.kind == SL_P:
            b.is_inter = bool(mb["is_inter"][m])
            if self.parts:
                b.ptype = int(mb["ptype"][m])
        else:
            b.is_inter = False
        b.sel16 = bool(mb["sel16"][m]) and not b.is_inter
        if b.sel16 and cl > 0:
            cl = 15
        b.cbp_luma, b.cbp_chroma, b.cbp = cl, cc, cl | (cc << 4)
        skipped = False
        if self.kind == SL_P:
            skipped = (b.is_inter and b.ptype == 0
                       and (mb["mv"][m] == mb["mv_skip"][m]).all()
                       and b.cbp == 0)
        elif self.kind == SL_B:
            skipped = b.is_direct and b.cbp == 0
        b.coded = not skipped
        b.is_i4 = b.coded and not b.is_inter and not b.sel16
        return b

    # ---- (a) the state pass ----
    def state_pass(self):
        for m in range(self.n):
            _, mask = self.load_mb(m)
            b = self.mb_flags(m, *self.cbp_of(mask))
            st = self.state[m]
            for lane in range(6):
                w = 0
                for k in range(4):
                    i = 4 * lane + k
                    if lane < 4:
                        tc = (popc(self.luma_mask(mask, i))
                              if (b.cbp_luma >> (i >> 2)) & 1 else 0)
                    else:
                        tc = (popc(self.cac_mask(mask, i - 16))
                              if b.cbp_chroma == 2 else 0)
                    w |= tc << (8 * k)
                st[lane] = w
            st[6] = b.cbp_luma | (b.cbp_chroma << 4) | \
                (int(not b.coded) << 8)
            st[7] = 0
            self.skipped[m] = not b.coded

    # ---- the walk ----
    def header(self, s, x):
        b, m, tab, mb = x.b, x.m, self.tab, self.mb
        if not b.coded:
            return
        mbt_intra = (1 + int(mb["i16mode"][m]) + 4 * b.cbp_chroma
                     + 12 * (b.cbp_luma > 0)) if b.sel16 else 0
        if self.kind == SL_I:
            put_ue(s, mbt_intra)
        elif self.kind == SL_P:
            put_ue(s, b.ptype if b.is_inter else 5 + mbt_intra)
            if self.p8x8 and b.is_inter and b.ptype == 3:
                s.put(15, 4)
        else:
            mbt = 0 if b.is_direct else \
                b.btype + 1 if b.is_inter else 23 + mbt_intra
            if self.parts and b.partd:
                mbt = (4 + 2 * tab[T_COMBO + int(mb["c0"][m]) * 3
                                   + int(mb["c1"][m])] + (b.ptype == 2))
            put_ue(s, int(mbt))
        if self.t8_mode and b.is_i4:
            s.put(0, 1)
        if b.is_i4:
            for k in range(16):
                md, pm = int(mb["modes"][m, k]), int(self.mpm[m, k])
                if md == pm:
                    s.put(1, 1)
                else:
                    s.put(md - (md > pm), 4)
        if not b.is_inter:
            put_ue(s, int(mb["cmode"][m]))
        d = None if self.mvds is None else self.mvds[m]

        def mvd(at):
            put_ue(s, se_to_ue(int(d[at + 1])))
            put_ue(s, se_to_ue(int(d[at])))

        if self.kind == SL_P and b.is_inter:
            mvd(0)
            if self.parts and b.ptype > 0:
                mvd(2)
            if self.p8x8 and b.ptype == 3:
                mvd(4)
                mvd(6)
        elif self.kind == SL_B:
            for lx in range(2):
                if b.exp[lx]:
                    mvd(8 * lx)
                if self.parts and b.exp_b[lx]:
                    mvd(8 * lx + 2)
        if b.is_inter:
            put_ue(s, int(tab[T_CBPP + b.cbp]))
        elif b.is_i4:
            put_ue(s, int(tab[T_CBPI + b.cbp]))
        if self.t8_mode and self.kind != SL_I and b.is_inter \
                and b.cbp_luma > 0:
            s.put(int(self.kind == SL_P and bool(mb["t8"][m])), 1)
        if b.sel16 or b.cbp > 0:
            s.put(1, 1)

    @staticmethod
    def tc_at(st, i):
        return (int(st[i >> 2]) >> (8 * (i & 3))) & 0xFF

    def nc_of(self, x, idx, chroma, comp):
        if chroma:
            by, bx, w = idx >> 1, idx & 1, 2
        else:
            pos = int(self.tab[T_BLK + idx])
            by, bx, w = pos >> 2, pos & 3, 4

        def at(st, yy, xx):
            return (self.tc_at(st, 16 + 4 * comp + 2 * yy + xx) if chroma
                    else self.tc_at(st, zz_of(yy, xx)))
        av_a = bx > 0 or x.av_l
        av_b = by > 0 or x.av_t
        na = 0 if not av_a else at(x.own, by, bx - 1) if bx > 0 \
            else at(x.left, by, w - 1)
        nb = 0 if not av_b else at(x.own, by - 1, bx) if by > 0 \
            else at(x.top, w - 1, bx)
        if av_a and av_b:
            return (na + nb + 1) >> 1
        return na if av_a else nb

    def walk_lane(self, s, x, lane):
        b, sh, tab = x.b, x.sh, self.tab
        if lane == 0:
            self.header(s, x)
        elif lane == 1:
            if b.sel16:
                residual(s, sh[C_LDC:C_LDC + 16], 16,
                         self.nc_of(x, 0, False, 0), tab)
        elif lane < 18:
            k = lane - 2
            if (b.cbp_luma >> (k >> 2)) & 1:
                at = C_LAC + 16 * k + (1 if b.sel16 else 0)
                mc = 15 if b.sel16 else 16
                residual(s, sh[at:at + mc], mc, self.nc_of(x, k, False, 0),
                         tab)
        elif lane < 20:
            if b.cbp_chroma >= 1:
                at = C_CDC + 4 * (lane - 18)
                residual(s, sh[at:at + 4], 4, -1, tab)
        elif lane < 28:
            j = lane - 20
            if b.cbp_chroma == 2:
                at = C_CAC + 16 * j + 1
                residual(s, sh[at:at + 15], 15,
                         self.nc_of(x, j & 3, True, j >> 2), tab)

    def mb_ctx(self, m):
        x = Mb()
        x.m = m
        x.sh, _ = self.load_mb(m)
        loc = m % (self.wm * self.hm)
        r, c = loc // self.wm, loc % self.wm
        x.av_l = c > 0
        x.av_t = r > self.rows[self.slice_of(r)]
        x.own = self.state[m]
        x.left = self.state[m - 1] if x.av_l else x.own
        x.top = self.state[m - self.wm] if x.av_t else x.own
        w6 = int(x.own[6])
        x.b = self.mb_flags(m, w6 & 15, (w6 >> 4) & 3)
        return x

    # ---- (b) the count pass and the zero fill ----
    def count_pass(self):
        self.words[:] = 0
        for m in range(self.n):
            if (self.state[m, 6] >> 8) & 1:
                self.mb_count[m] = 0
                continue
            x = self.mb_ctx(m)
            for lane in range(32):
                cnt = Counter()
                self.walk_lane(cnt, x, lane)
                self.lane_count[m, lane] = cnt.n
            incl = np.cumsum(self.lane_count[m])     # the warp scan
            self.lane_off[m] = incl - self.lane_count[m]
            self.mb_count[m] = incl[31]

    # ---- (c) the scan pass: a block a slice, tiles of 512 threads ----
    def scan_pass(self):
        n1 = self.wm * self.hm
        for g in range(self.pics * self.n_slices):
            pic, s = divmod(g, self.n_slices)
            lo = pic * n1 + self.rows[s] * self.wm
            hi = pic * n1 + self.rows[s + 1] * self.wm
            last, carry = lo - 1, 0
            for base in range(lo, hi, SCAN_THREADS):
                m = np.arange(base, min(base + SCAN_THREADS, hi))
                coded = ~((self.state[m, 6] >> 8) & 1).astype(bool)
                incl = np.maximum.accumulate(np.where(coded, m, -1))
                prev = np.maximum(np.concatenate([[-1], incl[:-1]]), last)
                bits = np.where(coded, self.mb_count[m], 0)
                if self.kind != SL_I:
                    run = m - prev - 1
                    self.run[m[coded]] = run[coded]
                    bits = bits + np.where(coded, 2 * np.array(
                        [bitlen_m1(r + 1) for r in run]) + 1, 0)
                self.mb_off[m] = carry + np.cumsum(bits) - bits
                carry += int(bits.sum())
                last = max(last, int(incl[-1]))
            self.nbits[g] = carry

    # ---- (d) the emit pass ----
    def emit_pass(self):
        n1 = self.wm * self.hm
        for m in range(self.n):
            if (self.state[m, 6] >> 8) & 1:
                continue
            x = self.mb_ctx(m)
            pic, loc = divmod(m, n1)
            g = pic * self.n_slices + self.slice_of(loc // self.wm)
            for lane in range(32):
                w = Writer(self.words, g, self.cap, int(self.mb_off[m]))
                if self.kind != SL_I:
                    run = int(self.run[m])
                    if lane == 0:
                        put_ue(w, run)
                    else:
                        w.pos += 2 * bitlen_m1(run + 1) + 1
                w.pos += int(self.lane_off[m, lane])
                start = w.pos
                self.walk_lane(w, x, lane)
                assert w.pos - start == self.lane_count[m, lane]
                w.flush()

    def run_all(self):
        self.state_pass()
        self.count_pass()
        self.scan_pass()
        self.emit_pass()
        return self.words, self.nbits, self.skipped


def _model(mb, kind, wm, hm, rows, cap, t8_mode=False, pics=1):
    """KV's passes on the numpy MB dict `mb` -> the model after its run."""
    tmb = {k: torch.as_tensor(v) for k, v in mb.items()}
    mvds, mpm = mp.preds_plain(tmb, wm, hm, rows, kind, pics)
    parts, p8x8 = mp.modes_of(mb, kind)
    params = mp.pack_params(wm, hm, rows, kind,
                            kcv.t8_of(mb, kind, t8_mode), parts, p8x8)
    kv = Kv(mb, params, kcv.tables(), None if mvds is None
            else to_np(mvds).reshape(-1, 16), to_np(mpm), pics, cap)
    kv.run_all()
    return kv


def _reference(mb, kind, wm, hm, rows, cap, t8_mode=False):
    """The reference's jnp serializer and packer on one picture -> (words
    uint32, nbits, skipped or None)."""
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}
    skipped = None
    if kind == "i":
        v, ln = rdc.serialize_frame_j(jmb, wm, hm, rows, t8_mode=t8_mode)
    elif kind == "p":
        v, ln, skipped = rdc.serialize_frame_p_j(jmb, wm, hm, rows)
    else:
        v, ln, skipped = rdc.serialize_frame_b_j(jmb, wm, hm, rows)
    words, nbits = rdc.pack_slices_j(v, ln, len(rows), cap)
    return (np.asarray(words).astype(np.int64), np.asarray(nbits),
            None if skipped is None else np.asarray(skipped))


def _picture(kind, tools, seed, wm, hm, scale=1):
    """A seeded MB dict (numpy) of slice kind `kind` with `tools`, its
    levels scaled by `scale` (QP-0-like where large)."""
    if kind == "b":
        mb = random_b_mbs(seed, wm, hm, "parts" in tools, "t8" in tools)
    else:
        mb = random_mbs(seed, wm, hm, p_slice=kind == "p", tools=tools)
    for key in ("luma_ac", "luma_dc", "chroma_dc", "chroma_ac"):
        mb[key] = (mb[key] * scale).astype(np.int32)
    return mb


def _check(mb, kind, wm, hm, slices, cap, t8_mode=False, what=""):
    """The model against the reference and the plain version on one
    picture -> the model."""
    rows = build_schedule(wm, hm, slices).slice_starts.tolist()
    kv = _model(mb, kind, wm, hm, rows, cap, t8_mode)
    want_w, want_n, want_s = _reference(mb, kind, wm, hm, rows, cap, t8_mode)
    assert_equal(kv.nbits, want_n, f"{what} nbits")
    assert_equal(kv.words & M32, want_w, f"{what} words")
    if kind != "i":
        assert_equal(kv.skipped, want_s, f"{what} skipped")
    tmb = {k: torch.as_tensor(v) for k, v in mb.items()}
    pw, pn, ps = kcv.serialize_plain(tmb, wm, hm, rows, kind, cap, t8_mode)
    assert_equal(kv.words & M32, to_np(pw) & M32, f"{what} plain words")
    assert_equal(kv.nbits, pn, f"{what} plain nbits")
    if kind != "i":
        assert_equal(kv.skipped, ps, f"{what} plain skipped")
    # the lanes' pieces make up each coded MB's bits, and the MB offsets
    # are each slice's exclusive scan of the MBs' bits with their runs
    assert_equal(kv.lane_count.sum(1), kv.mb_count, f"{what} pieces")
    assert (kv.lane_count[:, 28:] == 0).all()
    return kv


# (kind, tools, slices, t8_mode): the slice layouts and tool sets share
# the reference's compiled operations with the other cases where they can
# (one QCIF geometry; the I and dense cases of three slices take the 8x8
# PPS, as the chunk does)
CASES = [("i", (), 1, False), ("i", (), 3, True),
         ("p", (), 1, False), ("p", ("ptype",), 3, False),
         ("p", ("ptype", "mvq", "t8"), 3, False),
         ("b", (), 3, False), ("b", ("parts", "t8"), 1, False)]
WM, HM = 11, 9


def test_kv_model_matches_reference_serializer():
    """Every case of `CASES`: the model's words (32 bits each, zero past
    each slice's bits), bit counts and skip maps equal the reference's jnp
    serializer + packer and the plain version; each case has the MB kinds
    of its slice kind (I4x4 and I16x16; P and B: skips and coded inter
    MBs, partitions and 8x8 MBs where the tools allow them)."""
    for i, (kind, tools, slices, t8_mode) in enumerate(CASES):
        mb = _picture(kind, tools, 31 + 7 * i, WM, HM)
        what = f"{kind} {tools} {slices} slices"
        kv = _check(mb, kind, WM, HM, slices, WM * HM * 100, t8_mode, what)
        coded = ~kv.skipped
        sel16 = mb["sel16"].astype(bool)
        assert (sel16 & coded).any() and (~sel16 & coded).any(), what
        if kind != "i":
            assert kv.skipped.any() and coded.any(), what
            assert (kv.run > 0).any(), what
        if kind == "p" and "ptype" in tools:
            inter = mb["is_inter"].astype(bool) & coded
            assert set(mb["ptype"][inter]) >= (
                {0, 1, 2, 3} if "mvq" in tools else {0, 1, 2}), what
        if kind == "b" and "parts" in tools:
            assert (mb["btype"][coded] == 5).any(), what


def test_kv_model_chunk_escapes_and_cap():
    """A chunk of three I pictures (three slices each, the 8x8 PPS) in one
    run equals each picture's reference alone; dense QP-0-like I and P
    pictures (levels x37) take the level escapes (prefix 15, 28-bit
    codes) and equal the reference; a cap of a few words a slice drops
    the words past it (nothing written there) and keeps every bit in the
    counts."""
    wm, hm = WM, HM
    rows = build_schedule(wm, hm, 3).slice_starts.tolist()
    pics = [_picture("i", ("t8",) if f == 1 else (), 70 + f, wm, hm)
            for f in range(3)]
    chunk = {k: np.concatenate([p[k] for p in pics]) for k in pics[0]
             if all(k in p for p in pics)}
    cap = wm * hm * 100
    kv = _model(chunk, "i", wm, hm, rows, cap, True, pics=3)
    for f, mb in enumerate(pics):
        want_w, want_n, _ = _reference(mb, "i", wm, hm, rows, cap, True)
        assert_equal(kv.nbits[3 * f:3 * f + 3], want_n, f"chunk {f} nbits")
        assert_equal(kv.words[3 * f:3 * f + 3] & M32, want_w,
                     f"chunk {f} words")
    tmb = {k: torch.as_tensor(v) for k, v in chunk.items()}
    pw, pn, _ = kcv.serialize_plain(tmb, wm, hm, rows, "i", cap, True, 3)
    assert_equal(kv.words & M32, to_np(pw) & M32, "chunk plain words")
    assert_equal(kv.nbits, pn, "chunk plain nbits")
    for kind, tools in (("i", ()), ("p", ("ptype", "mvq", "t8"))):
        mb = _picture(kind, tools, 90 + len(tools), wm, hm, scale=37)
        kv = _check(mb, kind, wm, hm, 3, cap, kind == "i", f"dense {kind}")
        # the escapes were taken: level codes of 28 bits
        lengths = Lengths()
        for m in np.flatnonzero(~kv.skipped):
            x = kv.mb_ctx(m)
            for lane in range(1, 28):
                kv.walk_lane(lengths, x, lane)
        assert lengths.escapes > 0, kind
        small = 5
        kv = _check(mb, kind, wm, hm, 3, small, kind == "i",
                    f"dense {kind} capped")
        assert (kv.nbits > 32 * small).all()


def test_kv_tables_and_params():
    """The kernel's constant table has the layout of the CUDA source's
    `T_*` offsets, `pack_params` the layout of `Params`, the wrapper's
    pointers the order of `Io` (`parse`, the first of them
    `mb_preds.INPUTS`' order) and its scratch the model's state size;
    the model's zig-zag inverse is `BLK_ORDER`'s."""
    tab = kcv.tables()
    assert tab.shape == (TABLE_WORDS,) and tab.dtype == np.int32

    def codes(bits, lens):
        return ((np.asarray(lens) << 16) | np.asarray(bits)).ravel()
    for off, want in (
            (T_CT, codes(ct.COEFF_TOKEN_BITS, ct.COEFF_TOKEN_LEN)),
            (T_CCT, codes(ct.CDC_COEFF_TOKEN_BITS, ct.CDC_COEFF_TOKEN_LEN)),
            (T_CTZ, codes(ct.CDC_TOTAL_ZEROS_BITS, ct.CDC_TOTAL_ZEROS_LEN)),
            (T_TZ, codes(ct.TOTAL_ZEROS_BITS, ct.TOTAL_ZEROS_LEN)),
            (T_RB, codes(ct.RUN_BEFORE_BITS, ct.RUN_BEFORE_LEN)),
            (T_CBPI, mb_syntax.CBP_TO_CODENUM_INTRA),
            (T_CBPP, mb_syntax.CBP_TO_CODENUM_INTER),
            (T_COMBO, COMBO_IDX),
            (T_BLK, [by * 4 + bx for by, bx in BLK_ORDER])):
        assert_equal(tab[off:off + len(want)], want)
    src = (kcv.__file__.rsplit("/kernels/", 1)[0] + "/csrc/cavlc_slices.cu")
    text = open(src).read()
    for name, val in (("T_CT", T_CT), ("T_CCT", T_CCT), ("T_CTZ", T_CTZ),
                      ("T_TZ", T_TZ), ("T_RB", T_RB), ("T_CBPI", T_CBPI),
                      ("T_CBPP", T_CBPP), ("T_COMBO", T_COMBO),
                      ("T_BLK", T_BLK), ("kTableWords", TABLE_WORDS),
                      ("kStateWords", STATE_WORDS),
                      ("kScanThreads", SCAN_THREADS),
                      ("kMaxSlices", mp.MAX_SLICES)):
        assert f"constexpr int {name} = {val};" in text, name
    assert dict(kcv.SCRATCH)["state"] == STATE_WORDS
    assert mp.pack_params(11, 9, [0, 3, 6], "p", True, True, True) == \
        [11, 9, 1, 1, 1, 1, 3, 0, 3, 6, 9]
    names = list(mp.INPUTS[:kcv.N_INPUTS]) + [
        "tables", "mvds", "mpm"] + [k for k, _ in kcv.SCRATCH] + [
        "words", "nbits", "skipped"]
    for i, key in enumerate(names):
        assert re.search(rf"io\.{key} = \([^)]*\)a\[{i}\];", text), key
    assert f"the {len(names)} device pointers of `Io`" in text
    read = set(kcv.read_keys({"ptype": 0, "mvq": 0, "t8": 0}, "p", False))
    assert read <= set(mp.INPUTS[:kcv.N_INPUTS])
    for idx, (by, bx) in enumerate(BLK_ORDER):
        assert zz_of(by, bx) == idx
