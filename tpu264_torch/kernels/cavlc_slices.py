"""Kernel KV: CAVLC serialize + pack of a picture, or of a chunk of
all-intra pictures, in one run of two launches (`csrc/cavlc_slices.cu`):
a state pass that also derives the mvds and most probable modes (KD's
function, `csrc/mb_preds.cuh`), then one pass that walks every MB once
and scans the slices' bits across tiles with a decoupled look-back.

`serialize` is what the encoders' `serialize` runs: a picture's raster MB
dict (I, P or B slices; a chunk of `pics` I pictures, their MBs picture
after picture) -> (words [pics S, cap_words], the 32-bit words of every
slice in big-endian bit order, zero past each slice's bits; nbits [pics
S] int64, every bit counted, also those past `cap_words`, which are
dropped; skipped [pics n] bool, the P_Skip / B_Skip MBs whose trailing
run the host appends, None in I).  For CPU tensors it runs the plain
version `serialize_plain`, the port's `device_cavlc.serialize_frame*` +
`pack_slices` (held to the reference's jnp serializer and packer; its
mvds and most probable modes are `mb_preds.preds_plain`), whose words
are int64 holding 32-bit values; for CUDA tensors it launches KV or
raises, with no fallback.  KV writes its words as int32: the same 32
bits, so `words & 0xFFFFFFFF` equals the plain version's.

KV reads nothing back: its two passes run behind each other on the
stream, the state pass zero-fills the words and the slices pass stores
each tile's words (`csrc/cavlc_slices.cu`).  No slot grid is built on
the card.  Slices are equal runs of MB rows, as the encoders code them
and as the plain packer splits them.

No single PyTorch call computes CAVLC, so the kernel has no library
yardstick.

`launches["KV"]` counts KV's runs, one a picture, a band or a chunk;
`launches["KD"]` the derivations of the mvds and most probable modes
that they launch (one a run, inside its state pass).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu264_torch.coding.b_mbtypes import COMBO_IDX
from tpu264_torch.coding.wavefront import BLK_ORDER
from tpu264_torch.entropy import cavlc_tables as ct
from tpu264_torch.entropy import device_cavlc as dcav
from tpu264_torch.entropy import mb_syntax
from . import _build
from . import mb_preds as mp
from .transform import constant

I32 = torch.int32
# what KV reads of a picture's MB dict: every kind's coefficients and
# modes, then each slice kind's own
CODED = ("sel16", "luma_ac", "luma_dc", "chroma_dc", "chroma_ac", "modes",
         "cmode", "i16mode")
KIND_KEYS = {"i": (), "p": ("is_inter", "mv", "mv_skip"), "b": ("btype",)}
PART_KEYS = {"p": ("ptype",), "b": ("bptype", "c0", "c1")}
# KV's scratch, one int32 allocation a run: (name, int32 words a MB),
# each part starting on a 128-byte boundary; then the tiles' look-back
# slots (TILE_WORDS a tile of TILE_MBS MBs) and the tile counter
SCRATCH = (("mvds", 16), ("mpm", 16), ("state", 8), ("lane_off", 32))
TILE_MBS, TILE_WORDS = 32, 4
ALIGN = 32

launches = {"KV": 0, "KD": 0}


def tables() -> np.ndarray:
    """KV's tables, in the layout of the CUDA source's `T_*` offsets: each
    coeff_token, chroma DC coeff_token, chroma DC total_zeros,
    total_zeros and run_before entry as length << 16 | code, then
    CBP_TO_CODENUM_INTRA, CBP_TO_CODENUM_INTER, COMBO_IDX and BLK_ORDER
    as by * 4 + bx."""
    def codes(bits, lens):
        return (np.asarray(lens, np.int64) << 16 | np.asarray(bits)).ravel()
    return np.concatenate([
        codes(ct.COEFF_TOKEN_BITS, ct.COEFF_TOKEN_LEN),
        codes(ct.CDC_COEFF_TOKEN_BITS, ct.CDC_COEFF_TOKEN_LEN),
        codes(ct.CDC_TOTAL_ZEROS_BITS, ct.CDC_TOTAL_ZEROS_LEN),
        codes(ct.TOTAL_ZEROS_BITS, ct.TOTAL_ZEROS_LEN),
        codes(ct.RUN_BEFORE_BITS, ct.RUN_BEFORE_LEN),
        mb_syntax.CBP_TO_CODENUM_INTRA, mb_syntax.CBP_TO_CODENUM_INTER,
        COMBO_IDX, [by * 4 + bx for by, bx in BLK_ORDER]]).astype(np.int32)


def t8_of(mbd, kind: str, t8_mode: bool) -> bool:
    """Whether a picture's PPS has the 8x8 transform as the serializers
    see it: `t8_mode` for I slices, a "t8" map in the dict for P and B."""
    return bool(t8_mode) if kind == "i" else "t8" in mbd


def read_keys(mbd, kind: str, t8_mode: bool) -> tuple:
    """The keys of MB dict `mbd` that KV reads: what it codes, and what
    its state pass derives the mvds and most probable modes from
    (`mb_preds.derive_keys`)."""
    parts, _ = mp.modes_of(mbd, kind)
    keys = (CODED + KIND_KEYS[kind] + (PART_KEYS[kind] if parts else ())
            + (("t8",) if kind == "p" and t8_of(mbd, kind, t8_mode)
               else ()))
    return keys + tuple(k for k in mp.derive_keys(mbd, kind)
                        if k not in keys)


def scratch_words(n: int) -> tuple:
    """({part: its first int32 word}, the int32 words) of KV's scratch for
    `n` MBs: `SCRATCH`, then "tiles"."""
    offs, at = {}, 0
    for name, words in SCRATCH:
        offs[name] = at
        at += -(-n * words // ALIGN) * ALIGN
    offs["tiles"] = at
    at += TILE_WORDS * (-(-n // TILE_MBS) + 1)
    return offs, at


def serialize_plain(mbd, wm: int, hm: int, rows, kind: str, cap_words: int,
                    t8_mode: bool = False, pics: int = 1):
    """KV's plain version: `serialize_frame` / `_p` / `_b` +
    `pack_slices`, eager torch on any device -> (words [pics S,
    cap_words] int64, nbits [pics S] int64, skipped [n] bool or None)."""
    rows = list(rows)
    if kind == "b":
        v, ln, skipped = dcav.serialize_frame_b(mbd, wm, hm, rows)
    elif kind == "p":
        v, ln, skipped = dcav.serialize_frame_p(mbd, wm, hm, rows)
    else:
        v, ln = dcav.serialize_frame(mbd, wm, hm, rows, t8_mode=t8_mode,
                                     frames=pics)
        skipped = None
    words, nbits = dcav.pack_slices(v, ln, pics * len(rows), cap_words)
    return words, nbits, skipped


def check_layout(who: str, hm: int, rows, kind: str, pics: int,
                 cap_words: int) -> list:
    """`mb_preds.check_layout`, and raise unless the slices are of equal
    height, `pics` is a count (a chunk is all-intra) and `cap_words` is
    not negative."""
    rows = mp.check_layout(who, hm, rows, kind)
    if rows != list(range(0, hm, hm // len(rows))) or hm % len(rows):
        raise ValueError(f"{who}: slice rows {rows} are not equal slices "
                         f"of {hm} MB rows")
    if pics < 1 or (pics > 1 and kind != "i"):
        raise ValueError(f"{who}: {pics} pictures of kind {kind!r} (a "
                         f"chunk is all-intra)")
    if cap_words < 0:
        raise ValueError(f"{who}: negative cap {cap_words}")
    return rows


def serialize(mbd, wm: int, hm: int, rows, kind: str, cap_words: int,
              t8_mode: bool = False, pics: int = 1, derived=None):
    """CAVLC serialize + pack `pics` pictures of slice kind `kind` ("i",
    "p" or "b"; several only in "i"), each `hm` MB rows high with equal
    slices starting at the MB rows `rows`, from their raster MB dict ->
    (words [pics S, cap_words], nbits [pics S] int64, skipped [pics n]
    bool or None).  `t8_mode`: the PPS of an I picture has the 8x8
    transform (P and B: a "t8" map in the dict).  CPU tensors: the plain
    version (int64 words); CUDA tensors: KV, two launches, nothing read
    back (int32 words).  `derived`, a dict, receives on the card the
    mvds [pics n, 2, 4, 2] (None in I) and most probable modes [pics n,
    16] that KV's state pass derived, in `mb_preds.preds_plain`'s
    layout."""
    dev = mbd["luma_ac"].device
    if dev.type == "cpu":
        return serialize_plain(mbd, wm, hm, rows, kind, cap_words, t8_mode,
                               pics)
    who = "cavlc_slices"
    if dev.type != "cuda":
        raise ValueError(f"{who}: CUDA or CPU tensors expected, got {dev}")
    rows = check_layout(who, hm, rows, kind, pics, cap_words)
    n = wm * hm * pics
    t8 = t8_of(mbd, kind, t8_mode)
    ptrs = mp.input_pointers(who, mbd, read_keys(mbd, kind, t8_mode), kind,
                             n, dev)
    offs, size = scratch_words(n)
    work = torch.empty(size, dtype=I32, device=dev)
    g = pics * len(rows)
    words = torch.empty((g, cap_words), dtype=I32, device=dev)
    nbits = torch.empty(g, dtype=torch.int64, device=dev)
    skipped = (None if kind == "i"
               else torch.empty(n, dtype=torch.bool, device=dev))
    base = work.data_ptr()
    ptrs.append(constant(("kv_tables",), dev, tables).data_ptr())
    ptrs += [0 if kind == "i" and name == "mvds" else base + 4 * offs[name]
             for name, _ in SCRATCH]
    ptrs += [base + 4 * offs["tiles"], words.data_ptr(), nbits.data_ptr(),
             0 if skipped is None else skipped.data_ptr()]
    parts, p8x8 = mp.modes_of(mbd, kind)
    launches["KV"] += 1
    launches["KD"] += 1
    _build.check(_build.launch(
        "tpu264_cavlc_slices", words, (ctypes.c_void_p * len(ptrs))(*ptrs),
        mp.params(wm, hm, rows, kind, t8, parts, p8x8), pics, cap_words),
        who)
    if derived is not None:
        def part(name, shape):
            at = offs[name]
            return work[at:at + n * 16].view(n, *shape)
        derived["mvds"] = None if kind == "i" else part("mvds", (2, 4, 2))
        derived["mpm"] = part("mpm", (16,))
    return words, nbits, skipped
