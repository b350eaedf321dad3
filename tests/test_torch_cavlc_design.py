"""Kernel KV's two passes (`csrc/cavlc_slices.cu`: CAVLC serialize + pack
of a picture or of a chunk of all-intra pictures) emulated in numpy on
the CPU (no card, no reference encoder, no JAX program): a warp a
macroblock.  The state pass derives each MB's mvds and most probable
modes (`csrc/mb_preds.cuh`, KR's derivation, whose model is
`test_torch_records_design.Kr`), takes the coefficients' significance
masks from 13 ballots, the coded_block_pattern, the skip flag and the
TotalCoeff of every luma and chroma AC block.  The slices pass takes
tiles of 32 MBs in any order: its warps walk each MB once in 32 pieces,
one a lane (the header's four parts on lanes 0, 28, 29 and 30, then the
27 residual blocks in the plain version's slot order: coeff_token,
trailing-one signs, levels with the suffix-length adaptation and the
escapes, total_zeros, run_before), each lane staging its piece's words,
a warp scan in bit order placing them in the warp's stage; one warp
scans the tile's (bits, first coded MB, last coded MB) with the
mb_skip_run's ue(v) between tiles and the restart at each slice start,
publishes the aggregate and looks back over its predecessors' slots
(aggregates or inclusive prefixes, whichever a random order left there);
the tile's words are laid out by runs of staged MBs and stored, added on
each run's first and last word; an MB with a code wider than its length
or too many bits for its stage walks again and adds its codes.  The
inputs are the MB dict, `tables` (`kernels/cavlc_slices.py`) and
`pack_params` (`kernels/mb_preds.py`).

The words (32 bits each), bit counts and skip maps are held to the
reference's jnp serializer and packer
(`tpu264/entropy/device_cavlc.py` `serialize_frame_j`,
`serialize_frame_p_j`, `serialize_frame_b_j` + `pack_slices_j`, one
picture of each slice kind) and to the port's plain version
(`kernels/cavlc_slices.py` `serialize_plain`, every case) on QCIF
pictures: I slices with one and three slices and the 8x8 PPS, a chunk of
three I pictures, P slices with the tools off, with 16x8/8x16 and with
every tool (P_8x8, the 8x8 transform), B slices with and without
partitions and the 8x8 PPS, nine slices of one MB row, all-skipped tiles
and slices, dense QP-0-like blocks that reach the level escapes, MBs
over their stage, slices over the word cap, tiles of 8 and 16 MBs, and
the scan's combine on random splits.  The derived mvds and modes are
held to `mb_preds.preds_plain` and the reference's.  Tolerance 0."""

import random
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

from test_torch_records_design import Kr, _reference_inputs
from torch_util import assert_equal, eager_cached, to_np

M32 = 0xFFFFFFFF
SL_I, SL_P, SL_B = 0, 1, 2
# `T_*` offsets and sizes of the CUDA source
T_CT, T_CCT, T_CTZ, T_TZ, T_RB = 0, 272, 292, 304, 560
T_CBPI, T_CBPP, T_COMBO, T_BLK = 672, 720, 768, 777
TABLE_WORDS, STATE_WORDS = 793, 8
# the slices pass: MBs a tile, warps a block, a lane's staged words, a
# warp's stage, the tile's words (where the walk was staged)
TILE_MBS, WARPS, LANE_WORDS, STAGE_WORDS = 32, 32, 8, 80
# a macroblock's coefficients in shared memory: luma AC, chroma AC, luma
# DC, chroma DC
C_LAC, C_CAC, C_LDC, C_CDC = 0, 256, 384, 400
COEF_WORDS = 408
OUT_WORDS = WARPS * 32 * LANE_WORDS + WARPS * (COEF_WORDS + 13)


def bitlen_m1(v: int) -> int:
    return int(v).bit_length() - 1


def ue_len(run: int) -> int:
    return 2 * bitlen_m1(run + 1) + 1


def zz_of(by, bx):
    return 8 * (by >> 1) + 4 * (bx >> 1) + 2 * (by & 1) + (bx & 1)


def popc(v: int) -> int:
    return bin(v).count("1")


class Lengths:
    """A sink that counts the 28-bit codes (the level escapes)."""

    def __init__(self):
        self.n = self.escapes = 0

    def put(self, v, length):
        self.escapes += length == 28
        self.n += length

    put_checked = put


class Stage:
    """`Stage` of the CUDA source: a lane's piece from the top bit of its
    buffer's first word, the codes shifted into a 64-bit register and each
    32 bits stored as they fill; `bad`: a code wider than its length (the
    level escapes, `put_checked`), a code longer than 32 bits, or a piece
    longer than the buffer; `pos` counts every bit."""

    def __init__(self):
        self.buf = [None] * LANE_WORDS
        self.pos, self.acc, self.bad = 0, 0, False

    def store(self, v, w):
        if w < LANE_WORDS:
            self.buf[w] = v
        else:
            self.bad = True

    def put(self, v, length):
        if length <= 0:
            return
        if length > 32:
            self.bad = True
            self.pos += length
            return
        v = int(v)
        pending = (self.pos & 31) + length
        self.acc = ((self.acc << length) | v) & ((1 << 64) - 1)
        self.pos += length
        if pending >= 32:
            self.store((self.acc >> (pending - 32)) & M32,
                       (self.pos >> 5) - 1)

    def put_checked(self, v, length):
        if length < 32 and int(v) >> length:
            self.bad = True
        self.put(v, length)

    def finish(self):
        if self.pos & 31:
            self.store((self.acc << (32 - (self.pos & 31))) & M32,
                       self.pos >> 5)


class Writer:
    """`Writer` of the CUDA source (the direct path): each code's hi and
    lo parts added to their words, a word's sum kept until the lane moves
    on."""

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

    put_checked = put


def or_words(dst, at, src, n, first=0, step=1):
    """`or_words`: words `first`, `first + step`, ... of the `n` words at
    `src` OR-ed into `dst` at bit `at`."""
    s, base = at & 31, at >> 5
    for w in range(first, n, step):
        v = int(src[w])
        dst[base + w] |= v >> s
        if s and (v << (32 - s)) & M32:
            dst[base + w + 1] |= (v << (32 - s)) & M32


def or_code(out, pos, v, length):
    """`or_code`: a code exact in its length OR-ed in at bit `pos`."""
    if length > 32:
        pos, length = pos + length - 32, 32
    off, w = pos & 31, pos >> 5
    take = min(length, 32 - off)
    rem = length - take
    out[w] |= ((v >> rem) << (32 - off - take)) & M32
    if rem:
        out[w + 1] |= ((v & ((1 << rem) - 1)) << (32 - rem)) & M32


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
            s.put_checked((1 << 12) | (lc - 30), 28)
        return
    prefix = lc >> sl
    if prefix < 15:
        s.put((1 << sl) | (lc & ((1 << sl) - 1)), prefix + 1 + sl)
    else:
        s.put_checked((1 << 12) | (lc - (15 << sl)), 28)


def top_bit(m: int) -> int:
    return m.bit_length() - 1


def residual(s, p, nz, mc, nc, tab):
    """`residual` of the CUDA source: one block of `mc` scan-order
    coefficients `p` whose nonzero ones are the bits of `nz`, nC `nc`
    (-1: chroma DC), taken from the last nonzero one down by the mask's
    highest bits."""
    tc = popc(nz)
    t1, rest = 0, nz
    while t1 < 3 and rest:
        i = top_bit(rest)
        if abs(int(p[i])) != 1:
            break
        t1 += 1
        rest &= ~(1 << i)
    c = 4 * tc + t1
    if nc == -1:
        put_tab(s, tab[T_CCT + min(c, 19)])
    else:
        tsel = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
        put_tab(s, tab[T_CT + tsel * 68 + c])
    ones = nz
    for k in range(t1):
        i = top_bit(ones)
        s.put(int(p[i] < 0), 1)
        ones &= ~(1 << i)
    sl = 1 if tc > 10 and t1 < 3 else 0
    for k in range(t1, tc):
        i = top_bit(rest)
        rest &= ~(1 << i)
        v = int(p[i])
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
    prev = top_bit(nz)
    tz = prev + 1 - tc
    if tc < mc:
        if mc == 4:
            put_tab(s, tab[T_CTZ + min(tc - 1, 2) * 4 + min(max(tz, 0), 3)])
        else:
            put_tab(s, tab[T_TZ + (tc - 1) * 16 + min(max(tz, 0), 15)])
    zl, below, k = tz, nz & ~(1 << prev), 0
    while k < tc - 1 and k + 1 < mc and zl > 0:
        cur = top_bit(below)
        below &= ~(1 << cur)
        run = prev - cur - 1
        row = min(max(min(zl, 7) - 1, 0), 6)
        put_tab(s, tab[T_RB + row * 16 + min(max(run, 0), 15)])
        zl -= run
        prev = cur
        k += 1


class Mb:
    pass


# the scan's carry: bits without the first coded MB's run, first and
# last coded MB, whether it restarts at a slice's first MB, whether it is
# more than the identity
class Agg(tuple):
    __slots__ = ()

    def __new__(cls, B=0, f=-1, l=-1, reset=False, coded=False):
        return tuple.__new__(cls, (B, f, l, reset, coded))

    B = property(lambda a: a[0])
    f = property(lambda a: a[1])
    l = property(lambda a: a[2])
    reset = property(lambda a: a[3])
    coded = property(lambda a: a[4])


NONE = Agg()


def combine(x, y, runs):
    """`combine` of the CUDA source: x then y."""
    if y.reset or not x.coded:
        return y
    if not y.coded:
        return x
    return Agg(x.B + y.B + (ue_len(y.f - x.l - 1) if runs else 0), x.f, y.l,
               x.reset, True)


def warp_scan(elems, runs):
    """The warp's inclusive scan of `combine` (Hillis-Steele, as the
    shuffles run it)."""
    incl, d = list(elems), 1
    while d < len(incl):
        incl = [combine(incl[i - d], incl[i], runs) if i >= d else incl[i]
                for i in range(len(incl))]
        d <<= 1
    return incl


def rank_of(lane):
    return 0 if lane == 0 else lane - 27 if lane >= 28 else lane + 4


def lane_of(rank):
    return 0 if rank == 0 else rank + 27 if rank <= 4 else rank - 4


def place(lens):
    """`place`: the warp's exclusive scan of the pieces' lengths in bit
    order (the header's parts, lane 31, lanes 1-27) -> (each lane's
    offset in its MB, the MB's bits)."""
    v = np.array([lens[lane_of(k)] for k in range(32)])
    incl = np.cumsum(v)
    return [int(incl[rank_of(lane)] - v[rank_of(lane)])
            for lane in range(32)], int(incl[31])


class Kv:
    """KV's two passes on a picture (or chunk) in numpy, from the MB dict
    `mb`, `pack_params` `params` and `tables` `tab`; `tile_mbs` MBs a tile
    (the kernel's 32, or 8 or 16 to move the tiles' edges), `stage_words`
    a warp's stage, the tiles taken in an order shuffled by `seed`."""

    def __init__(self, mb, params, tab, pics, cap, tile_mbs=TILE_MBS,
                 stage_words=STAGE_WORDS, seed=0):
        q = list(params)
        (self.wm, self.hm, self.kind, self.t8_mode, self.parts, self.p8x8,
         self.n_slices) = q[:7]
        self.rows = q[7:8 + self.n_slices]
        self.rh = self.hm // self.n_slices
        assert self.rows == [s * self.rh for s in range(self.n_slices + 1)]
        self.pics, self.cap = pics, cap
        self.tile_mbs, self.stage_words = tile_mbs, stage_words
        self.rng = random.Random(seed)
        self.mb, self.tab = mb, [int(v) for v in tab]
        self.params = params
        self.n = self.wm * self.hm * pics
        self.n_tiles = -(-self.n // tile_mbs)
        self.state = np.zeros((self.n, STATE_WORDS), np.int64)
        self.lane_len = np.zeros((self.n, 32), np.int64)
        self.lane_off = np.full((self.n, 32), -7, np.int64)
        self.mb_bits = np.zeros(self.n, np.int64)
        self.run = np.zeros(self.n, np.int64)
        self.direct = np.zeros(self.n, bool)
        g = pics * self.n_slices
        self.words = np.full((g, cap), 7, np.int64)    # not yet zeroed
        self.nbits = np.full(g, -7, np.int64)
        self.skipped = np.zeros(self.n, bool)
        self.slots = ["garbage"] * self.n_tiles
        self.most_out = self.n_pieces = 0
        self.mvds = self.mpm = None

    # ---- helpers of the CUDA source ----
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
        """The derivation (`mb_preds.cuh`, as KR's model runs it), the
        state words and the skip map; the words and the look-back slots
        zero-filled."""
        kr = Kr(self.mb, self.params, mp.tables(), self.pics)
        for m in range(self.n):
            kr.state_mb(m, derive_only=True)
        mvds, mpm = kr.derived()
        self.derived = mvds, mpm
        self.mvds = None if mvds is None else mvds.reshape(self.n, 16)
        self.mpm = mpm
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
        self.words[:] = 0
        self.slots = [None] * self.n_tiles

    # ---- the walk ----
    def header(self, s, x, part):
        """The header's part `part` (`walk_header`)."""
        b, m, tab, mb = x.b, x.m, self.tab, self.mb
        if not b.coded:
            return
        if part == 0:
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
        elif part == 1:
            if b.is_i4:
                for k in range(16):
                    md, pm = int(mb["modes"][m, k]), int(self.mpm[m, k])
                    if md == pm:
                        s.put(1, 1)
                    else:
                        s.put(md - (md > pm), 4)
        elif part == 2:
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
        else:
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
        b, sh, mask, tab = x.b, x.sh, x.mask, self.tab
        if lane == 0 or lane >= 28:
            if lane < 31:
                self.header(s, x, 0 if lane == 0 else lane - 27)
        elif lane == 1:
            if b.sel16:
                residual(s, sh[C_LDC:C_LDC + 16], mask[12] & 0xFFFF, 16,
                         self.nc_of(x, 0, False, 0), tab)
        elif lane < 18:
            k = lane - 2
            nz = self.luma_mask(mask, k)
            if (b.cbp_luma >> (k >> 2)) & 1:
                at = C_LAC + 16 * k + (1 if b.sel16 else 0)
                mc = 15 if b.sel16 else 16
                residual(s, sh[at:at + mc], nz >> 1 if b.sel16 else nz, mc,
                         self.nc_of(x, k, False, 0), tab)
        elif lane < 20:
            comp = lane - 18
            if b.cbp_chroma >= 1:
                at = C_CDC + 4 * comp
                residual(s, sh[at:at + 4], (mask[12] >> (16 + 4 * comp))
                         & 0xF, 4, -1, tab)
        else:
            j = lane - 20
            if b.cbp_chroma == 2:
                at = C_CAC + 16 * j + 1
                residual(s, sh[at:at + 15], self.cac_mask(mask, j) >> 1, 15,
                         self.nc_of(x, j & 3, True, j >> 2), tab)

    def mb_ctx(self, m):
        x = Mb()
        x.m = m
        x.sh, x.mask = self.load_mb(m)
        loc = m % (self.wm * self.hm)
        r, c = loc // self.wm, loc % self.wm
        x.av_l = c > 0
        x.av_t = r % self.rh != 0
        x.own = self.state[m]
        x.left = self.state[m - 1] if x.av_l else x.own
        x.top = self.state[m - self.wm] if x.av_t else x.own
        w6 = int(x.own[6])
        x.b = self.mb_flags(m, w6 & 15, (w6 >> 4) & 3)
        return x

    def slice_row(self, m):
        n1 = self.wm * self.hm
        return m // n1 * self.n_slices + m % n1 // (self.rh * self.wm)

    # ---- (b) the slices pass, a tile at a time ----
    def walk_tile(self, t):
        """Step 1: each warp walks its MBs once and stages their bits ->
        (the tile's MB infos, the warps' stages)."""
        info = [dict(bits=0, stage=-2) for _ in range(self.tile_mbs)]
        warps = min(WARPS, self.tile_mbs)
        stage = np.full((warps, self.stage_words), 0x5A5A5A5A, np.int64)
        per_warp = self.tile_mbs // warps
        for warp in range(warps):
            used = 0
            for k in range(per_warp):
                i = warp * per_warp + k
                m = t * self.tile_mbs + i
                if m >= self.n or (self.state[m, 6] >> 8) & 1:
                    continue
                x = self.mb_ctx(m)
                sinks = []
                for lane in range(32):
                    sk = Stage()
                    self.walk_lane(sk, x, lane)
                    sk.finish()
                    sinks.append(sk)
                lens = [sk.pos for sk in sinks]
                offs, total = place(lens)
                self.lane_len[m], self.mb_bits[m] = lens, total
                need = (total + 31) >> 5
                if not any(sk.bad for sk in sinks) and \
                        used + need <= self.stage_words:
                    stage[warp, used:used + need] = 0
                    for lane, sk in enumerate(sinks):
                        or_words(stage[warp], 32 * used + offs[lane], sk.buf,
                                 (sk.pos + 31) >> 5)
                    info[i] = dict(bits=total, stage=used)
                    used += need
                else:
                    self.lane_off[m] = offs
                    self.direct[m] = True
                    info[i] = dict(bits=total, stage=-1)
        return info, stage

    def tile_aggregate(self, t, info):
        """Step 2's scan: each MB's carry, the warp's inclusive scan, the
        tile's aggregate published -> the scan."""
        n1, runs = self.wm * self.hm, self.kind != SL_I
        slice_mbs = self.rh * self.wm
        elems = []
        for i in range(self.tile_mbs):
            m = t * self.tile_mbs + i
            coded = m < self.n and info[i]["stage"] != -2
            bits = info[i]["bits"]
            if m < self.n and m % n1 % slice_mbs == 0:
                elems.append(Agg((1 if runs else 0) + bits if coded else 0,
                                 m, m if coded else m - 1, True, True))
            elif coded:
                elems.append(Agg(bits, m, m, False, True))
            else:
                elems.append(NONE)
        incl = warp_scan(elems, runs)
        self.slots[t] = incl[-1]
        return incl

    def tile_layout(self, t, info, incl):
        """Step 2's look-back and layout: the prefix before the tile
        from its predecessors' slots, its inclusive prefix published, each
        MB's first bit, run and place in `out`, the slices' bit counts, the
        pieces (runs of staged MBs in one slice) -> (per-MB layout,
        pieces, `out`'s words)."""
        n1, runs = self.wm * self.hm, self.kind != SL_I
        slice_mbs = self.rh * self.wm
        T = self.tile_mbs
        ms = [t * T + i for i in range(T)]
        exists = [m < self.n for m in ms]
        start = [e and m % n1 % slice_mbs == 0 for m, e in zip(ms, exists)]
        last = [e and (m % n1 + 1) % slice_mbs == 0
                for m, e in zip(ms, exists)]
        before_tile = NONE
        if not start[0]:
            # the warp's look-back: 32 slots at a time, newest on lane 0,
            # up to the nearest whole one, reduced oldest first
            base = t - 1
            while True:
                window = [self.slots[base - lane] if base - lane >= 0
                          else NONE for lane in range(32)]
                assert all(isinstance(a, Agg) for a in window), t
                whole = [base - lane >= 0 and a.reset
                         for lane, a in enumerate(window)]
                stop = whole.index(True) if any(whole) else 32
                a = [w if lane <= stop else NONE
                     for lane, w in enumerate(window)]
                d = 1
                while d < 32:
                    a = [combine(a[i + d], a[i], runs) if i + d < 32
                         else a[i] for i in range(32)]
                    d <<= 1
                before_tile = combine(a[0], before_tile, runs)
                if any(whole):
                    break
                base -= 32
            assert before_tile.reset
            if not incl[-1].reset:
                self.slots[t] = combine(before_tile, incl[-1], runs)
        lay = []
        for i, m in enumerate(ms):
            coded = exists[i] and info[i]["stage"] != -2
            x = combine(before_tile, incl[i - 1] if i else NONE, runs)
            before = 0 if start[i] else x.B
            run = m - (m - 1 if start[i] else x.l) - 1
            ue = ue_len(run) if coded and runs else 0
            after = before + ue + info[i]["bits"] if coded else before
            if last[i]:
                self.nbits[self.slice_row(m)] = after
            if coded:
                self.run[m] = run
            lay.append(dict(before=before, after=after, ue=ue, run=run,
                            g=self.slice_row(m) if exists[i] else 0))
        direct = [info[i]["stage"] == -1 for i in range(T)]
        p_start = [not direct[i] and (i == 0 or start[i] or direct[i - 1])
                   for i in range(T)]
        p_last = [not direct[i] and (i == T - 1 or p_start[i + 1]
                                     or direct[i + 1]) for i in range(T)]
        pieces, first, words = [], 0, 0
        for i in range(T):
            if p_start[i]:
                first = i
            if direct[i]:
                continue
            p_begin = lay[first]["before"]
            lay[i]["out"] = 32 * words + lay[i]["before"] - 32 * (p_begin >> 5)
            if p_last[i]:
                end = lay[i]["after"]
                count = ((end - 1) >> 5) - (p_begin >> 5) + 1 \
                    if end > p_begin else 0
                pieces.append(dict(gw0=p_begin >> 5, base=words, count=count,
                                   g=lay[first]["g"]))
                words += count
        assert words <= OUT_WORDS, (words, OUT_WORDS)
        self.most_out = max(self.most_out, words)
        self.n_pieces += len(pieces)
        return lay, pieces, words

    def tile_write(self, t, info, stage, lay, pieces, out_words):
        """Steps 3-5: the staged MBs' runs and bits into `out`, `out` into
        the rows (stores inside a piece, adds on its first and last word),
        then the direct MBs walk again and add their codes."""
        out = np.full(OUT_WORDS, 0x3C3C3C3C, np.int64)
        out[:out_words] = 0
        per_warp = self.tile_mbs // min(WARPS, self.tile_mbs)
        for i in range(self.tile_mbs):
            if info[i]["stage"] < 0:
                continue
            at, ue = lay[i]["out"], lay[i]["ue"]
            if ue:
                or_code(out, at, lay[i]["run"] + 1, ue)
            or_words(out, at + ue, stage[i // per_warp][info[i]["stage"]:],
                     (info[i]["bits"] + 31) >> 5)
        for pc in pieces:
            for k in range(pc["count"]):
                gw = pc["gw0"] + k
                if gw >= self.cap:
                    break
                v = int(out[pc["base"] + k])
                if k == 0 or k == pc["count"] - 1:
                    self.words[pc["g"], gw] = \
                        (self.words[pc["g"], gw] + v) & M32
                else:
                    self.words[pc["g"], gw] = v
        for i in range(self.tile_mbs):
            if info[i]["stage"] != -1:
                continue
            m = t * self.tile_mbs + i
            x = self.mb_ctx(m)
            for lane in range(32):
                w = Writer(self.words, self.slice_row(m), self.cap,
                           lay[i]["before"])
                if lay[i]["ue"]:
                    if lane == 0:
                        put_ue(w, lay[i]["run"])
                    else:
                        w.pos += lay[i]["ue"]
                w.pos += int(self.lane_off[m, lane])
                start = w.pos
                self.walk_lane(w, x, lane)
                assert w.pos - start == self.lane_len[m, lane]
                w.flush()

    def run_all(self):
        """The state pass, then the slices pass's tiles: every tile's
        walk and aggregate in one shuffled order, then every tile's
        look-back, layout and stores in another, so that a look-back
        meets aggregates and inclusive prefixes alike and the stores of
        neighbouring tiles come in any order."""
        self.state_pass()
        order = list(range(self.n_tiles))
        self.rng.shuffle(order)
        walked = {}
        for t in order:
            info, stage = self.walk_tile(t)
            walked[t] = (info, stage, self.tile_aggregate(t, info))
        self.rng.shuffle(order)
        for t in order:
            info, stage, incl = walked[t]
            lay, pieces, out_words = self.tile_layout(t, info, incl)
            self.tile_write(t, info, stage, lay, pieces, out_words)
        return self.words, self.nbits, self.skipped


def _model(mb, kind, wm, hm, rows, cap, t8_mode=False, pics=1, **kw):
    """KV's passes on the numpy MB dict `mb` -> the model after its run."""
    parts, p8x8 = mp.modes_of(mb, kind)
    params = mp.pack_params(wm, hm, rows, kind,
                            kcv.t8_of(mb, kind, t8_mode), parts, p8x8)
    kv = Kv(mb, params, kcv.tables(), pics, cap, **kw)
    kv.run_all()
    return kv


def _reference(mb, kind, wm, hm, rows, caps, t8_mode=False):
    """The reference's jnp serializer on one picture, packed at each cap
    of `caps` -> [(words uint32, nbits)], skipped or None."""
    with eager_cached():
        return _reference_packed(mb, kind, wm, hm, rows, caps, t8_mode)


def _reference_packed(mb, kind, wm, hm, rows, caps, t8_mode):
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}
    skipped = None
    if kind == "i":
        v, ln = rdc.serialize_frame_j(jmb, wm, hm, rows, t8_mode=t8_mode)
    elif kind == "p":
        v, ln, skipped = rdc.serialize_frame_p_j(jmb, wm, hm, rows)
    else:
        v, ln, skipped = rdc.serialize_frame_b_j(jmb, wm, hm, rows)
    packed = []
    for cap in caps:
        words, nbits = rdc.pack_slices_j(v, ln, len(rows), cap)
        packed.append((np.asarray(words).astype(np.int64),
                       np.asarray(nbits)))
    return packed, None if skipped is None else np.asarray(skipped)


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


def _skip(mb, kind, lo, hi):
    """MBs lo..hi-1 of `mb` made skipped (P_Skip: 16x16 inter at the skip
    vector; B_Skip: direct), with no coefficients."""
    mb = {k: v.copy() for k, v in mb.items()}
    sel = slice(lo, hi)
    for key in ("luma_ac", "luma_dc", "chroma_dc", "chroma_ac"):
        mb[key][sel] = 0
    if kind == "p":
        mb["is_inter"][sel] = 1
        mb["mv"][sel] = mb["mv_skip"][sel]
        if "ptype" in mb:
            mb["ptype"][sel] = 0
    else:
        mb["btype"][sel] = 3
        if "bptype" in mb:
            mb["bptype"][sel] = 0
    return mb


def _check_model(kv, want, what):
    """The model's words (32 bits), bit counts and skip map against
    (words, nbits, skipped or None)."""
    assert_equal(kv.nbits, want[1], f"{what} nbits")
    assert_equal(kv.words & M32, to_np(want[0]) & M32, f"{what} words")
    if want[2] is not None:
        assert_equal(kv.skipped, want[2], f"{what} skipped")
    # the lanes' pieces make up each MB's bits; lane 31 has none
    assert_equal(kv.lane_len.sum(1), kv.mb_bits, f"{what} pieces")
    assert (kv.lane_len[:, 31] == 0).all()


def _check(mb, kind, wm, hm, slices, cap, t8_mode=False, what="",
           reference=False, variants=(), caps=()):
    """The model against the plain version (and, with `reference`, the
    reference) on one picture, at cap `cap` and the caps `caps`, and its
    `variants` (keyword sets of `Kv`) against the same -> the model."""
    rows = build_schedule(wm, hm, slices).slice_starts.tolist()
    tmb = {k: torch.as_tensor(v) for k, v in mb.items()}
    wants = [kcv.serialize_plain(tmb, wm, hm, rows, kind, c, t8_mode)
             for c in (cap,) + tuple(caps)]
    if reference:
        packed, skipped = _reference(mb, kind, wm, hm, rows,
                                     (cap,) + tuple(caps), t8_mode)
        for (rw, rn), pw in zip(packed, wants):
            assert_equal(rn, pw[1], f"{what} reference nbits")
            assert_equal(rw, to_np(pw[0]) & M32, f"{what} reference words")
            if skipped is not None:
                assert_equal(skipped, pw[2], f"{what} reference skipped")
    kv = None
    for c, want in zip((cap,) + tuple(caps), wants):
        for kw in ({},) + tuple(variants):
            got = _model(mb, kind, wm, hm, rows, c, t8_mode, **kw)
            _check_model(got, want, f"{what} cap {c} {kw}")
            kv = kv or got
    return kv


# (kind, tools, slices, t8_mode, held to the reference): the slice layouts
# and tool sets share the reference's compiled operations with the other
# cases where they can (one QCIF geometry; the I and dense cases of three
# slices take the 8x8 PPS, as the chunk does)
CASES = [("i", (), 1, False, False), ("i", (), 3, True, True),
         ("p", (), 1, False, False), ("p", ("ptype",), 3, False, False),
         ("p", ("ptype", "mvq", "t8"), 3, False, True),
         ("b", (), 3, False, False), ("b", ("parts", "t8"), 1, False, True)]
WM, HM = 11, 9
# the model's other tiles and a stage too small for many MBs, whose MBs
# then take the direct path
VARIANTS = ({"tile_mbs": 8, "seed": 1}, {"tile_mbs": 16, "seed": 2},
            {"stage_words": 6, "seed": 3})


def _check_derived(kv, mb, kind, rows, reference):
    """The state pass's derived mvds and most probable modes equal
    `preds_plain` and, with `reference`, the reference's."""
    tmb = {k: torch.as_tensor(v) for k, v in mb.items()}
    want = mp.preds_plain(tmb, WM, HM, rows, kind, kv.pics)
    refs = (None, None)
    if reference:
        with eager_cached():
            refs = _reference_inputs(mb, kind, rows)
    for got, w, r, name in zip(kv.derived, want, refs, ("mvds", "mpm")):
        assert (got is None) == (w is None), name
        if got is not None:
            assert_equal(got, w, f"derived {name}")
            if r is not None:
                assert_equal(got, r, f"reference {name}")


def _check_combine(rng, kv):
    """The scan's carry over the model's picture: each slice's MBs folded
    in order give its bit count, and so does any split of them into runs
    folded alone and then combined, in any bracketing."""
    n1, runs = kv.wm * kv.hm, kv.kind != SL_I
    slice_mbs = kv.rh * kv.wm
    elems = []
    for m in range(kv.n):
        coded = not kv.skipped[m]
        bits = int(kv.mb_bits[m]) if coded else 0
        if m % n1 % slice_mbs == 0:
            elems.append(Agg((1 if runs else 0) + bits if coded else 0, m,
                             m if coded else m - 1, True, True))
        else:
            elems.append(Agg(bits, m, m, False, True) if coded else NONE)
    for _ in range(4):
        cuts = sorted(rng.sample(range(1, kv.n), rng.randint(1, 12)))
        parts = []
        for lo, hi in zip([0] + cuts, cuts + [kv.n]):
            acc = NONE
            for e in elems[lo:hi]:
                acc = combine(acc, e, runs)
            parts.append((lo, hi, acc))
        while len(parts) > 1:           # a random bracketing
            k = rng.randrange(len(parts) - 1)
            (lo, _, a), (_, hi, b) = parts[k], parts[k + 1]
            parts[k:k + 2] = [(lo, hi, combine(a, b, runs))]
        whole = NONE
        for e in elems:
            whole = combine(whole, e, runs)
        assert parts[0][2] == whole
        # each slice's count is the fold up to its last MB
        for g in range(kv.pics * kv.n_slices):
            acc = NONE
            for e in elems[:(g + 1) * slice_mbs]:
                acc = combine(acc, e, runs)
            assert acc.B == kv.nbits[g], g


def test_kv_model_matches_reference_serializer():
    """Every case of `CASES`: the model's words (32 bits each, zero past
    each slice's bits), bit counts and skip maps equal the plain version
    (each slice kind's fullest case also the reference's jnp serializer +
    packer, and the plain version equals it there), also with tiles of 8
    and 16 MBs in shuffled orders and with a stage too small for many
    MBs; each case has the MB kinds of its slice kind (I4x4 and I16x16;
    P and B: skips and coded inter MBs, partitions and 8x8 MBs where the
    tools allow them); the derived mvds and modes equal the plain
    version's (and, where the case is held to the reference, the
    reference's); the scan's combine is associative on random splits.
    Then P and B pictures with all-skipped tiles and an all-skipped slice,
    and nine slices of one MB row each."""
    rng = random.Random(5)
    for i, (kind, tools, slices, t8_mode, ref) in enumerate(CASES):
        mb = _picture(kind, tools, 31 + 7 * i, WM, HM)
        what = f"{kind} {tools} {slices} slices"
        kv = _check(mb, kind, WM, HM, slices, WM * HM * 100, t8_mode, what,
                    reference=ref, variants=VARIANTS)
        rows = build_schedule(WM, HM, slices).slice_starts.tolist()
        _check_derived(kv, mb, kind, rows, ref and kind != "i")
        _check_combine(rng, kv)
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
    # all-skipped tiles (MBs 30-72: tile 1 whole) and, with three slices,
    # the all-skipped middle slice; nine slices of one MB row
    for kind, tools in (("p", ("ptype", "mvq", "t8")), ("b", ("parts",))):
        base = _picture(kind, tools, 61 + len(tools), WM, HM)
        for slices, lo, hi in ((1, 30, 73), (3, 33, 66)):
            mb = _skip(base, kind, lo, hi)
            kv = _check(mb, kind, WM, HM, slices, WM * HM * 100,
                        what=f"{kind} skipped {lo}-{hi}, {slices} slices",
                        variants=VARIANTS[:1])
            assert kv.skipped[lo:hi].all() and not kv.skipped[lo - 1]
            if slices == 3:
                assert kv.nbits[1] == 0
        kv = _check(base, kind, WM, HM, 9, WM * 100, what=f"{kind} 9 slices",
                    variants=VARIANTS[:2])
        assert (kv.nbits > 0).all()


def test_kv_model_chunk_escapes_and_cap():
    """A chunk of three I pictures (three slices each, the 8x8 PPS) in one
    run equals each picture's plain version alone (the t8 picture also
    the reference); dense QP-0-like I and P pictures (levels x37) take the
    level escapes (prefix 15, 28-bit codes; P's levels x160, some codes
    wider than their length, down the direct path) and equal the
    reference; a cap of a few words a
    slice drops the words past it (nothing written there) and keeps every
    bit in the counts."""
    wm, hm = WM, HM
    rows = build_schedule(wm, hm, 3).slice_starts.tolist()
    pics = [_picture("i", ("t8",) if f == 1 else (), 70 + f, wm, hm)
            for f in range(3)]
    chunk = {k: np.concatenate([p[k] for p in pics]) for k in pics[0]
             if all(k in p for p in pics)}
    cap = wm * hm * 100
    for kw in ({}, {"tile_mbs": 8, "seed": 4}):
        kv = _model(chunk, "i", wm, hm, rows, cap, True, pics=3, **kw)
        for f, mb in enumerate(pics):
            want = kcv.serialize_plain(
                {k: torch.as_tensor(v) for k, v in mb.items()}, wm, hm, rows,
                "i", cap, True)
            assert_equal(kv.nbits[3 * f:3 * f + 3], want[1], f"chunk {f}")
            assert_equal(kv.words[3 * f:3 * f + 3] & M32,
                         to_np(want[0]) & M32, f"chunk {f} words")
            if f == 1:
                (rw, rn), = _reference(mb, "i", wm, hm, rows, (cap,), True)[0]
                assert_equal(rn, want[1], "chunk reference nbits")
                assert_equal(rw, to_np(want[0]) & M32, "chunk reference")
        tmb = {k: torch.as_tensor(v) for k, v in chunk.items()}
        pw, pn, _ = kcv.serialize_plain(tmb, wm, hm, rows, "i", cap, True, 3)
        assert_equal(kv.words & M32, to_np(pw) & M32, "chunk plain words")
        assert_equal(kv.nbits, pn, "chunk plain nbits")
    _check_derived(kv, chunk, "i", rows, False)
    for kind, tools, scale in (("i", (), 37), ("p", ("ptype", "mvq", "t8"),
                                             160)):
        mb = _picture(kind, tools, 90 + len(tools), wm, hm, scale=scale)
        small = 5
        kv = _check(mb, kind, wm, hm, 3, cap, kind == "i", f"dense {kind}",
                    reference=True, caps=(small,))
        # the escapes were taken: level codes of 28 bits (x160: some wider
        # than their length, on the direct path)
        lengths = Lengths()
        for m in np.flatnonzero(~kv.skipped):
            x = kv.mb_ctx(m)
            for lane in range(1, 28):
                kv.walk_lane(lengths, x, lane)
        assert lengths.escapes > 0, kind
        assert kv.direct.any() or kind == "i", kind
        assert (kv.nbits > 32 * small).all()


def test_kv_tables_and_params():
    """The kernel's constant table has the layout of the CUDA source's
    `T_*` offsets, `pack_params` the layout of `Params`, the wrapper's
    pointers the order of `Io` (`parse`: `mb_preds.INPUTS`, then the
    tables, the scratch and the outputs), its scratch the model's state
    size and 16-byte aligned look-back slots, the tiles' constants the
    model's, `read_keys` what the walk and the derivation read; the
    derivation is `mb_preds.cuh`'s in both KR and KV, and KD has no entry
    point of its own; the model's zig-zag inverse is `BLK_ORDER`'s."""
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
    csrc = kcv.__file__.rsplit("/kernels/", 1)[0] + "/csrc/"
    text = open(csrc + "cavlc_slices.cu").read()
    for name, val in (("T_CT", T_CT), ("T_CCT", T_CCT), ("T_CTZ", T_CTZ),
                      ("T_TZ", T_TZ), ("T_RB", T_RB), ("T_CBPI", T_CBPI),
                      ("T_CBPP", T_CBPP), ("T_COMBO", T_COMBO),
                      ("T_BLK", T_BLK), ("kTableWords", TABLE_WORDS),
                      ("kStateWords", STATE_WORDS),
                      ("kTileMbs", TILE_MBS), ("kWarps", WARPS),
                      ("kLaneWords", LANE_WORDS),
                      ("kStageWords", STAGE_WORDS),
                      ("kCoefWords", COEF_WORDS),
                      ("kMaxSlices", mp.MAX_SLICES)):
        assert f"constexpr int {name} = {val};" in text, name
    assert OUT_WORDS >= WARPS * STAGE_WORDS + 4 * TILE_MBS
    assert dict(kcv.SCRATCH)["state"] == STATE_WORDS
    assert kcv.TILE_MBS == TILE_MBS
    offs, size = kcv.scratch_words(WM * HM * 3)
    assert offs["tiles"] % 4 == 0 and \
        size - offs["tiles"] == kcv.TILE_WORDS * (-(-WM * HM * 3 // 32) + 1)
    assert mp.pack_params(11, 9, [0, 3, 6], "p", True, True, True) == \
        [11, 9, 1, 1, 1, 1, 3, 0, 3, 6, 9]
    names = list(mp.INPUTS) + ["tables"] + [k for k, _ in kcv.SCRATCH] + [
        "tiles", "words", "nbits", "skipped"]
    for i, key in enumerate(names):
        assert re.search(rf"io\.{key} = \([^)]*\)a\[{i}\];", text), key
    assert f"the {len(names)} device pointers of `Io`" in text
    for kind, mb in (("p", {"ptype": 0, "mvq": 0, "t8": 0}),
                     ("b", {"bptype": 0})):
        read = kcv.read_keys(mb, kind, False)
        assert set(read) <= set(mp.INPUTS) and len(set(read)) == len(read)
        assert set(mp.derive_keys(mb, kind)) <= set(read)
    for src in ("cavlc_slices.cu", "cabac_records.cu"):
        body = open(csrc + src).read()
        assert '#include "mb_preds.cuh"' in body, src
        assert "mb_preds::derive_warp(" in body, src
        assert "tpu264_mb_preds" not in body, src
    for idx, (by, bx) in enumerate(BLK_ORDER):
        assert zz_of(by, bx) == idx
