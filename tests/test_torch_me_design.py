"""The arithmetic of the motion search's CUDA kernels, emulated in numpy
on the CPU (no card, no reference encoder): KF's packed-byte squared
differences (`csrc/me_search.cu`: `__vabsdiffu4` then `__dp4a`), KS's
SATD on 16-bit lane pairs (`csrc/inter_wave.cuh` `satd4x4_packed`), and
KF's choice as the minimum of one (cost, candidate) key (`key_of`)
against the reference's sequential strict-less rule.  Each
emulation follows its kernel's steps one instruction at a time, with
32-bit wrap-around; the kernels' thread and shared-memory layouts are
emulated whole (`_emulate_kf`, `_emulate_ks`) and held to the plain
versions that the CUDA kernels are held to on the card, on pictures that
reach the extremes: 0/255 checkerboards, flat pictures (every cost tied),
vectors at +-16 on the border macroblocks, and planes whose padding is too
narrow, so that KS reads some blocks unstaged.  Tolerance 0."""

import numpy as np
import pytest
import torch

from tpu264.kernels import transform as rkt

from tpu264_torch.coding.intra_frame import LAMBDA_TABLE
from tpu264_torch.kernels import interp as tki
from tpu264_torch.kernels import me as tme
from tpu264_torch.kernels import me_search as kfs
from tpu264_torch.kernels import me_subpel as ksp
from tpu264_torch.kernels import transform as tkt

from torch_util import assert_equal, t32

M32 = 0xFFFFFFFF
BIAS = 4096
BIAS2 = BIAS * 0x10001


# ---- the CUDA intrinsics on uint32 words (numpy int64 arrays) ----

def _bytes(x):
    return [(x >> (8 * i)) & 0xFF for i in range(4)]


def _lanes(x):
    return x & 0xFFFF, x >> 16


def byte_perm(x, y, sel: int):
    b = _bytes(x) + _bytes(y)
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def funnelshift_r(lo, hi, sh):
    return ((hi << 32 | lo) >> (sh & 31)) & M32


def vabsdiffu4(a, b):
    return sum(np.abs(x - y) << (8 * i)
               for i, (x, y) in enumerate(zip(_bytes(a), _bytes(b))))


def dp4a(a, b, c):
    return (c + sum(x * y for x, y in zip(_bytes(a), _bytes(b)))) & M32


def vavgu4(a, b):
    return sum((x + y + 1) >> 1 << (8 * i)
               for i, (x, y) in enumerate(zip(_bytes(a), _bytes(b))))


def vmaxu2(a, b):
    (a0, a1), (b0, b1) = _lanes(a), _lanes(b)
    return np.maximum(a0, b0) | np.maximum(a1, b1) << 16


def vminu2(a, b):
    (a0, a1), (b0, b1) = _lanes(a), _lanes(b)
    return np.minimum(a0, b0) | np.minimum(a1, b1) << 16


def dp2a_lo(a, b, c):
    (a0, a1), b = _lanes(a), _bytes(b)
    return (c + a0 * b[0] + a1 * b[1]) & M32


def pack4(s):
    """[..., 4] samples -> words, first sample in the low byte."""
    s = np.asarray(s, np.int64)
    return s[..., 0] | s[..., 1] << 8 | s[..., 2] << 16 | s[..., 3] << 24


def bytes4(words, o):
    """`inter_wave.cuh` `bytes4`: words [..., n], byte offsets o [...]."""
    w0 = np.take_along_axis(words, (o >> 2)[..., None], -1)[..., 0]
    w1 = np.take_along_axis(words, (o >> 2)[..., None] + 1, -1)[..., 0]
    return funnelshift_r(w0, w1, 8 * (o & 3))


def key_of(cost, c):
    """`me_search.cu` `key_of`: uint64 keys."""
    hi = ((np.asarray(cost, np.int64) & M32) ^ 0x80000000).astype(np.uint64)
    return hi << np.uint64(32) | np.asarray(c, np.int64).astype(np.uint64)


def key_index(key):
    return (key & np.uint64(M32)).astype(np.int64)


def key_cost(key):
    """The signed cost of keys."""
    c = (key >> np.uint64(32)).astype(np.int64) ^ 0x80000000
    return np.where(c >= 1 << 31, c - (1 << 32), c)


# ---- KS's SATD ----

def satd4x4_packed(src, pred, lanes_seen=None):
    """`satd4x4_packed` on source and prediction row words [..., 4]; with
    `lanes_seen` (a list), every intermediate word is checked against the
    lanes it stands for, computed apart in int64, and kept there."""
    def butterfly(a, b):
        (va, wa), (vb, wb) = a, b
        s = ((va + vb - BIAS2) & M32,
             (wa[0] + wb[0] - BIAS, wa[1] + wb[1] - BIAS))
        d = ((va - vb + BIAS2) & M32,
             (wa[0] - wb[0] + BIAS, wa[1] - wb[1] + BIAS))
        return check(s), check(d)

    def check(x):
        v, (lo, hi) = x
        if lanes_seen is not None:
            lanes_seen.append((lo, hi))
            assert (lo >= 0).all() and (lo < 1 << 16).all()
            assert (hi >= 0).all() and (hi < 1 << 16).all()
            assert_equal(v, lo | hi << 16, "a word and its lanes")
        return x

    d = [[None, None] for _ in range(4)]
    for r in range(4):
        for e, sel in enumerate((0x4240, 0x4341)):
            s = byte_perm(src[..., r], 0, sel) + BIAS2
            p = byte_perm(pred[..., r], 0, sel)
            (s0, s1), (p0, p1) = _lanes(s), _lanes(p)
            d[r][e] = check(((s - p) & M32, (s0 - p0, s1 - p1)))
        d[r][0], d[r][1] = butterfly(d[r][0], d[r][1])
    for e in range(2):
        d[0][e], d[1][e] = butterfly(d[0][e], d[1][e])
        d[2][e], d[3][e] = butterfly(d[2][e], d[3][e])
        d[0][e], d[2][e] = butterfly(d[0][e], d[2][e])
        d[1][e], d[3][e] = butterfly(d[1][e], d[3][e])
    acc = 0
    for r in range(4):
        x = byte_perm(d[r][0][0], d[r][1][0], 0x5410)
        y = byte_perm(d[r][0][0], d[r][1][0], 0x7632)
        m = vmaxu2(vmaxu2(x, y), (2 * BIAS2 - vminu2(x, y)) & M32)
        acc = dp2a_lo(m, 0x0101, acc)
    return acc - 8 * BIAS


def _satd_both(s, p):
    """The packed SATD of blocks s, p [B, 4, 4] (0..255) and the port's
    and the reference's `satd4x4` of s - p."""
    got = satd4x4_packed(pack4(s), pack4(p))
    d = (s.astype(np.int64) - p).astype(np.int32)
    return (got, tkt.satd4x4(torch.as_tensor(d)).numpy(),
            np.asarray(rkt.satd4x4(d)))


def test_packed_satd_lanes_stay_in_16_bits_on_the_worst_blocks():
    """Every 4x4 block whose differences are all +-255 (source and
    prediction 0/255, all 2^16 sign patterns, the extremes of every
    butterfly stage): each lane of each intermediate word stays in [0,
    2^16), and the SATD equals `transform.satd4x4`'s (port and
    reference)."""
    bits = (np.arange(1 << 16)[:, None] >> np.arange(16)) & 1
    s = (255 * bits).reshape(-1, 4, 4)
    p = 255 - s
    seen = []
    got = satd4x4_packed(pack4(s), pack4(p), seen)
    d = (s - p).astype(np.int32)
    want = tkt.satd4x4(torch.as_tensor(d)).numpy()
    assert_equal(got, want)
    assert_equal(got, np.asarray(rkt.satd4x4(d)))
    hi = max(int(max(lo.max(), h.max())) for lo, h in seen)
    lo = min(int(min(lo.min(), h.min())) for lo, h in seen)
    assert (lo, hi) == (BIAS - 8 * 255, BIAS + 8 * 255)
    assert got.max() == 16 * 1020 // 2   # a bent pattern: every |c| 1020


@pytest.mark.parametrize("kind", ["random", "equal", "one_sided"])
def test_packed_satd_equals_satd4x4(kind):
    """The packed SATD on random blocks, on equal blocks (0) and on blocks
    where one side is 0 or 255 throughout."""
    rng = np.random.default_rng(5)
    s = rng.integers(0, 256, (4096, 4, 4))
    p = {"random": rng.integers(0, 256, (4096, 4, 4)), "equal": s,
         "one_sided": np.where(rng.random((4096, 1, 1)) < 0.5, 0, 255)
         + 0 * s}[kind]
    got, port, ref = _satd_both(s, p)
    assert_equal(got, port)
    assert_equal(got, ref)


# ---- KF's squared differences ----

@pytest.mark.parametrize("kind", ["extremes", "equal", "random"])
def test_packed_squared_difference_equals_int32_ssd(kind):
    """`__vabsdiffu4` then `__dp4a(d, d, acc)` over four-sample words sum
    the squared differences exactly: words of 0 against 255, equal words,
    random words, summed over a quadrant's 16 words to the largest sum a
    quadrant can reach."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (2048, 16, 4))
    b = {"extremes": 255 - 255 * (a > 127), "equal": a,
         "random": rng.integers(0, 256, (2048, 16, 4))}[kind]
    if kind == "extremes":
        a = 255 * (a > 127)
        a[0], b[0] = 0, 255
    acc = np.zeros(2048, np.int64)
    for j in range(16):
        d = vabsdiffu4(pack4(a[:, j]), pack4(b[:, j]))
        acc = dp4a(d, d, acc)
    want = ((a - b) ** 2).sum(axis=(1, 2))
    assert_equal(acc, want)
    if kind == "extremes":
        assert acc[0] == 64 * 255 ** 2


# ---- the choice ----

def test_packed_key_minimum_equals_strict_less_choice():
    """The minimum of key_of(cost, k) over the 9 candidates equals
    `subpel_refine`'s choice (centre first, a neighbour only where
    strictly cheaper) with ties forced at every candidate index, and
    negative costs; KF's per-thread strict-less runs then the key minimum
    across threads equal the first minimum in raster order."""
    rng = np.random.default_rng(2)
    costs = rng.integers(-3, 3, (20000, 9))
    for k in range(9):                   # a tie of the minimum at k
        costs[k::9, k] = costs[k::9].min(axis=1)
    keys = np.stack([key_of(costs[:, k], k) for k in range(9)], 1)
    got = key_index(keys.min(axis=1))
    want = np.zeros(len(costs), np.int64)
    best = costs[:, 0].copy()
    for k in range(1, 9):
        better = costs[:, k] < best
        want = np.where(better, k, want)
        best = np.minimum(best, costs[:, k])
    assert_equal(got, want)
    assert_equal(key_cost(keys.min(axis=1)), costs.min(axis=1))
    # KF: 33 x 33 candidates, runs of 4 dx a thread, a strict-less scan
    # a thread, then the key minimum over the threads
    c = rng.integers(0, 4, (500, 33, 33))
    c[::2] = 7                               # all tied
    flat = c.reshape(500, -1)
    thread_best = []
    for dy in range(33):
        for dx0 in range(0, 33, 4):
            best, at = np.full(500, 2 ** 31 - 1), np.full(500, dy * 33 + dx0)
            for dx in range(dx0, min(dx0 + 4, 33)):
                better = c[:, dy, dx] < best
                best = np.where(better, c[:, dy, dx], best)
                at = np.where(better, dy * 33 + dx, at)
            thread_best.append(key_of(best, at))
    got = key_index(np.stack(thread_best, 1).min(axis=1))
    assert_equal(got, flat.argmin(axis=1))


# ---- the kernels' layouts, emulated whole ----

def _candidate(k: int, s: int):
    j = 4 if k == 0 else (k - 1 if k <= 4 else k)
    return (j // 3 - 1) * s, (j % 3 - 1) * s


def _clamp(s, size: int, dim: int):
    s = np.where(s < 0, s + dim, s)
    return np.clip(s, 0, dim - size)


def _mv_cost(v):
    k = np.where(v > 0, 2 * v - 1, -2 * v) + 1
    bits = np.floor(np.log2(k)).astype(np.int64)
    return (2 * bits + 1).sum(axis=-1)


def _emulate_kf(orig, ref_pad, pad, r, lam, wm, hm, names):
    """`me_search_kernel` for every MB at once: windows of 13-word rows,
    threads (dy, run of 4 dx), their quadrant sums, strict-less runs and
    the key minimum -> [len(names), n, 2]."""
    orig, ref = np.asarray(orig, np.int64), np.asarray(ref_pad, np.int64)
    n_mb = wm * hm
    mr, mc = np.divmod(np.arange(n_mb), wm)
    n, span = 16 + 2 * r, 2 * r + 1
    wy = _clamp(mr * 16 + pad - r, n, ref.shape[0])
    wx = _clamp(mc * 16 + pad - r, n, ref.shape[1])
    rows = ref[wy[:, None, None] + np.arange(n)[None, :, None],
               wx[:, None, None] + np.arange(n)[None, None, :]]
    rows = np.pad(rows, ((0, 0), (0, 0), (0, 52 - n)))
    win = pack4(rows.reshape(n_mb, n, 13, 4))             # [n_mb, n, 13]
    sy = _clamp(mr * 16, 16, orig.shape[0])
    sx = _clamp(mc * 16, 16, orig.shape[1])
    src = pack4(orig[sy[:, None, None] + np.arange(16)[None, :, None],
                     sx[:, None, None] + np.arange(16)[None, None, :]]
                .reshape(n_mb, 16, 4, 4))                  # [n_mb, 16, 4]
    runs = (span + 3) // 4
    t = np.arange(span * runs)
    dy, dx0 = t % span, 4 * (t // span)
    q = np.zeros((4, 4, n_mb, len(t)), np.int64)
    for y in range(16):
        w = [win[:, dy + y, (dx0 >> 2) + j] for j in range(5)]
        for k in range(4):
            for j in range(4):
                c = w[j] if k == 0 else funnelshift_r(w[j], w[j + 1], 8 * k)
                d = vabsdiffu4(c, src[:, y, j][:, None])
                q[k, 2 * (y >> 3) + (j >> 1)] = dp4a(
                    d, d, q[k, 2 * (y >> 3) + (j >> 1)])
    out = []
    for name in names:
        parts = tme.SEARCH_BLOCKS[name]
        best = np.full((n_mb, len(t)), 2 ** 31 - 1)
        at = np.broadcast_to(dy * span + dx0, best.shape).copy()
        for k in range(4):
            dx = dx0 + k
            ok = dx < span
            rate = lam * _mv_cost(np.stack([dy - r, dx - r], -1))
            cost = sum(q[k, i] for i in parts) + rate
            better = ok & (cost < best)
            best = np.where(better, cost, best)
            at = np.where(better, dy * span + dx, at)
        c = key_index(key_of(best, at).min(axis=1))
        out.append(np.stack([c // span - r, c % span - r], -1))
    return np.stack(out)


def _emulate_ks(orig, planes, pad, mv_int, lam, wm, hm, shape_list):
    """`me_subpel_kernel` for every MB at once: the MB's source and each
    name's staged plane rows as bytes (5 words a row), the table word of
    each position, each (4x4 block, candidate)'s prediction rows (from the
    staged bytes, or unstaged where a start is clamped), the packed SATD,
    the name's sums and the strict-less choice, step 1 keeping the step-2
    winner's cost -> [len(names), n, 2]."""
    orig, pl = np.asarray(orig, np.int64), np.asarray(planes, np.int64)
    mv_int = np.asarray(mv_int, np.int64)
    n_mb = wm * hm
    mr, mc = np.divmod(np.arange(n_mb), wm)
    hp, wp = pl.shape[1:]
    sy0 = _clamp(mr * 16, 16, orig.shape[0])
    sx0 = _clamp(mc * 16, 16, orig.shape[1])
    src = pack4(orig[sy0[:, None, None] + np.arange(16)[None, :, None],
                     sx0[:, None, None] + np.arange(16)[None, None, :]]
                .reshape(n_mb, 64, 4))
    src = np.concatenate([src, np.zeros((n_mb, 1), np.int64)], 1)
    qt = tki.QPEL_TABLE.numpy().astype(np.int64)
    qtab = (qt[:, 0] | qt[:, 1] << 2 | qt[:, 2] << 3 | qt[:, 3] << 4
            | qt[:, 4] << 6 | qt[:, 5] << 7 | qt[:, 6] << 8)
    out = []
    for (oy, ox, bh, bw), v in zip(ksp.shape_table(shape_list), mv_int):
        wy = mr * 16 + oy + pad + v[:, 0] - 1
        wx = mc * 16 + ox + pad + v[:, 1] - 1
        fast = ((wy >= 0) & (wy + bh + 2 <= hp) & (wx >= 0)
                & (wx + bw + 2 <= wp))
        rb = 20                         # a staged row: 5 words
        yy = np.clip(wy[:, None, None] + np.arange(bh + 2)[None, :, None],
                     0, hp - 1)
        xx = np.clip(wx[:, None, None] + np.arange(rb)[None, None, :],
                     0, wp - 1)
        staged = pl[:, yy, xx].transpose(1, 0, 2, 3)       # [n, 4, bh+2, rb]
        staged[..., bw + 2:] = 0
        win = pack4(staged.reshape(n_mb, -1, 4))
        sy = _clamp(mr * 16 + oy, bh, orig.shape[0]) - sy0
        sx = _clamp(mc * 16 + ox, bw, orig.shape[1]) - sx0
        y0, x0 = mr * 16 + oy + pad, mc * 16 + ox + pad
        centre = 4 * v
        for step in (2, 1):
            costs = []
            for kc in range(9):
                dy, dx = _candidate(kc, step)
                mv = centre + [dy, dx]
                if step == 1 and kc == 0:
                    costs.append(best)
                    continue
                full = tki.mc_luma(torch.as_tensor(planes), t32(y0), t32(x0),
                                   t32(mv), bh=bh, bw=bw).numpy()
                e = qtab[(mv[:, 0] & 3) * 4 + (mv[:, 1] & 3)]
                pb = (bh + 2) * rb
                total = 0
                for by4 in range(bh // 4):
                    for bx4 in range(bw // 4):
                        y = (mv[:, 0] >> 2) - v[:, 0] + 1 + 4 * by4
                        x = (mv[:, 1] >> 2) - v[:, 1] + 1 + 4 * bx4
                        oa = ((e & 3) * pb + (y + (e >> 2 & 1)) * rb + x
                              + (e >> 3 & 1))
                        ob = ((e >> 4 & 3) * pb + (y + (e >> 6 & 1)) * rb + x
                              + (e >> 7 & 1))
                        pred, s = [], []
                        for r in range(4):
                            a = bytes4(win, oa + r * rb)
                            a = np.where(e >> 8 & 1,
                                         vavgu4(a, bytes4(win, ob + r * rb)),
                                         a)
                            slow = pack4(full[:, 4 * by4 + r,
                                              4 * bx4:4 * bx4 + 4])
                            pred.append(np.where(fast, a, slow))
                            s.append(bytes4(src, (sy + 4 * by4 + r) * 16 + sx
                                            + 4 * bx4))
                        total = total + satd4x4_packed(np.stack(s, -1),
                                                       np.stack(pred, -1))
                costs.append(total + lam * _mv_cost(mv))
            # every lane of the name: the strict-less choice in order
            best, bk = costs[0], np.zeros(n_mb, np.int64)
            for kc in range(1, 9):
                better = costs[kc] < best
                best = np.where(better, costs[kc], best)
                bk = np.where(better, kc, bk)
            centre = centre + np.array([_candidate(i, step) for i in bk])
        out.append(centre)
    return np.stack(out)


W, H = 96, 64
WM, HM = W // 16, H // 16


def _picture(kind: str):
    """(source, reference) of kind: a 0/255 checkerboard against its
    complement, flat, or seeded noise shifted by (3, -5)."""
    rng = np.random.default_rng(17)
    if kind == "checker":
        yy, xx = np.mgrid[:H, :W]
        ref = 255 * ((yy + xx) & 1)
        return 255 - ref, ref
    if kind == "flat":
        return np.full((H, W), 128), np.full((H, W), 128)
    ref = rng.integers(0, 256, (H, W))
    return np.clip(np.roll(ref, (3, -5), (0, 1))
                   + rng.integers(-6, 7, (H, W)), 0, 255), ref


@pytest.mark.parametrize("qp", [0, 51])
@pytest.mark.parametrize("kind", ["checker", "flat", "noise"])
@pytest.mark.parametrize("pad,r", [(24, 16), (24, 5), (3, 16)],
                         ids=["pad24_r16", "pad24_r5", "pad3_clamped"])
def test_emulated_kf_equals_plain(pad, r, kind, qp):
    """`_emulate_kf` on every block of `me.SEARCH_BLOCKS` equals KF's
    plain version, with the encoders' padding and range, a short range
    (span not a multiple of 4) and a padding so narrow that the windows
    are clamped."""
    cur, ref = _picture(kind)
    ref_pad = tki.pad_plane(t32(ref), pad)
    lam = LAMBDA_TABLE[qp][2]
    names = list(tme.SEARCH_BLOCKS)
    want = kfs.full_search_plain(t32(cur), ref_pad, pad, r, lam, WM, HM,
                                 names)
    got = _emulate_kf(cur, ref_pad.numpy(), pad, r, lam, WM, HM, names)
    assert_equal(got, want)
    if kind == "flat":
        assert not got.any()


@pytest.mark.parametrize("qp", [0, 51])
@pytest.mark.parametrize("kind", ["checker", "flat", "noise"])
@pytest.mark.parametrize("pad", [24, 3], ids=["pad24", "pad3_unstaged"])
def test_emulated_ks_equals_plain(pad, kind, qp):
    """`_emulate_ks` on every block shape equals KS's plain version, from
    seeded full-pel vectors over the search range with +-16 forced on the
    border macroblocks (so that the staged windows reach their edges), and,
    with padding 3, blocks whose starts are clamped (read unstaged)."""
    cur, ref = _picture(kind)
    planes = tki.luma_planes(tki.pad_plane(t32(ref), pad))
    shapes = ksp.shapes(True, True)
    rng = np.random.default_rng(4)
    mv = rng.integers(-16, 17, (9, WM * HM, 2))
    mr, mc = np.divmod(np.arange(WM * HM), WM)
    mv[:, mr == 0, 0], mv[:, mr == HM - 1, 0] = -16, 16
    mv[:, mc == 0, 1], mv[:, mc == WM - 1, 1] = -16, 16
    lam = LAMBDA_TABLE[qp][2]
    want = ksp.subpel_plain(t32(cur), planes, pad, t32(mv), lam, WM, HM,
                            shapes)
    got = _emulate_ks(cur, planes.numpy(), pad, mv, lam, WM, HM, shapes)
    assert_equal(got, want)


@pytest.mark.parametrize("wy,oy", [(64, 0), (127, 127), (1, -128),
                                   (-128, 127)])
def test_kernel_inputs_are_bytes(wy, oy):
    """What the encoders pass KF and KS fits their bytes: the reference
    weighted by `inter_frame.weight_luma` (any weight and offset) and the
    half-pel planes of a 0..255 reference (0/255 checkerboards and noise,
    the 6-tap filters' extremes) are all 0..255."""
    from tpu264_torch.coding import inter_frame as tinter
    rng = np.random.default_rng(wy & 0xFF)
    yy, xx = np.mgrid[:40, :48]
    for ref in (255 * ((yy + xx) & 1), 255 * (xx & 1), 255 * ((yy >> 1) & 1),
                rng.integers(0, 256, (40, 48))):
        ref_pad = tinter.weight_luma(tki.pad_plane(t32(ref), 24), wy, oy)
        planes = tki.luma_planes(ref_pad)
        for t in (ref_pad, planes):
            assert 0 <= int(t.min()) and int(t.max()) <= 255
