"""The port's on-device CAVLC coder (`entropy.device_cavlc`) against the
JAX reference's: token grids of random blocks, the bit packer, and the
I-frame serializer on the MB dict of a QCIF intra frame.  Tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu264.entropy import device_cavlc as rdc
from tpu264.media.synth import synth_frame

from tpu264_torch.bits.bitwriter import BitSink
from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.entropy import device_cavlc as tdc

from torch_util import assert_equal, t32, to_np

W, H = 176, 144


def _blocks(kind: str, n: int, mc: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros((n, mc), np.int32)
    if kind == "sparse":
        lev = rng.integers(-3, 4, (n, mc))
        return (lev * (rng.random((n, mc)) < 0.2)).astype(np.int32)
    if kind == "dense":
        lev = rng.integers(-40, 41, (n, mc))
        return (lev * (rng.random((n, mc)) < 0.9)).astype(np.int32)
    # escape: magnitudes through every level_prefix range up to the
    # 28-bit escape codes, with runs of +-1 so trailing ones occur
    lev = rng.choice([0, 1, -1, 2, -7, 15, -16, 31, -32, 300, -2063, 2063,
                      4000, -6000], (n, mc))
    return lev.astype(np.int32)


def _ncs(n: int, mc: int, seed: int) -> np.ndarray:
    if mc == 4:
        return np.full(n, -1, np.int32)
    rng = np.random.default_rng(seed + 1)
    return rng.choice([0, 1, 2, 3, 4, 7, 8, 16], n).astype(np.int32)


@pytest.mark.parametrize("kind", ["zero", "sparse", "dense", "escape"])
@pytest.mark.parametrize("mc", [16, 15, 4])
def test_encode_blocks_matches_reference(mc, kind):
    n = 257
    scanned = _blocks(kind, n, mc, seed=mc * 10 + len(kind))
    nc = _ncs(n, mc, seed=mc)
    want_v, want_l = rdc.encode_blocks_j(jnp.asarray(scanned),
                                         jnp.asarray(nc), mc)
    got_v, got_l = tdc.encode_blocks(t32(scanned), t32(nc), mc)
    assert got_v.dtype == torch.int32 and got_l.dtype == torch.int32
    assert_equal(got_l, want_l, "lengths")
    assert_equal(got_v, want_v, "values")


def test_ue_code_and_se_to_ue_match_reference():
    v = np.concatenate([np.arange(0, 70), [254, 255, 256, 8190, 8191, 8192,
                                           32766, 32767, 32768, 2 ** 30]])
    wc, wl = rdc.ue_code_j(jnp.asarray(v, jnp.int32))
    gc, gl = tdc.ue_code(t32(v))
    assert_equal(gc, np.asarray(wc).astype(np.int64))
    assert_equal(gl, wl)
    s = np.arange(-300, 301)
    assert_equal(tdc.se_to_ue(t32(s)), rdc.se_to_ue_j(jnp.asarray(s)))


def _pack_case(case: str):
    rng = np.random.default_rng(5)
    n, slots = 12, 9
    if case == "mixed":
        lens = rng.integers(0, 32, (n, slots))
    elif case == "edges":
        lens = rng.choice([0, 31], (n, slots))
    elif case == "empty_slice":
        lens = rng.integers(0, 32, (n, slots))
        lens[4:8] = 0                       # the middle slice of 3 is empty
    else:                                   # straddle: 31-bit codes from an
        lens = np.full((n, slots), 31)      # odd offset cross every word
        lens[:, 0] = 7
    vals = rng.integers(0, 2 ** 31, (n, slots)) & ((1 << lens) - 1)
    return vals.astype(np.int32), lens.astype(np.int32)


@pytest.mark.parametrize("n_slices", [1, 3])
@pytest.mark.parametrize("case", ["mixed", "edges", "empty_slice",
                                  "straddle"])
def test_pack_slices_matches_reference(case, n_slices):
    vals, lens = _pack_case(case)
    cap = 128
    want_w, want_n = rdc.pack_slices_j(jnp.asarray(vals), jnp.asarray(lens),
                                       n_slices, cap)
    got_w, got_n = tdc.pack_slices(t32(vals), t32(lens), n_slices, cap)
    assert_equal(got_n, want_n, "nbits")
    assert_equal(got_w, np.asarray(want_w).astype(np.int64), "words")


def test_pack_slices_drops_bits_past_the_cap():
    """A stream longer than `cap_words` keeps its first words and drops
    the rest, as the reference's scatter does."""
    vals, lens = _pack_case("straddle")
    cap = 20
    want_w, want_n = rdc.pack_slices_j(jnp.asarray(vals), jnp.asarray(lens),
                                       1, cap)
    got_w, got_n = tdc.pack_slices(t32(vals), t32(lens), 1, cap)
    assert int(got_n[0]) > 32 * cap
    assert_equal(got_n, want_n)
    assert_equal(got_w, np.asarray(want_w).astype(np.int64))


def test_words_to_rbsp_matches_reference():
    from tpu264.bits.bitwriter import BitSink as RefSink
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2 ** 32, 9, dtype=np.uint64).astype(np.uint32)
    for nbits, tail in ((0, None), (1, None), (63, 3), (64, None),
                        (200, 7), (288, None)):
        a, b = BitSink(), RefSink()
        for s in (a, b):
            s.put(0b1011, 4)
        got = tdc.words_to_rbsp(words.astype(np.int64), nbits, a,
                                final_skip_run=tail)
        want = rdc.words_to_rbsp(words, nbits, b, final_skip_run=tail)
        assert got == want, (nbits, tail)


@pytest.fixture(scope="module")
def intra_mbd():
    """Raster MB dict of a QCIF intra frame from the port's encoder (held
    to the reference's in test_torch_intra), per slice count."""
    cache = {}

    def get(slices):
        if slices not in cache:
            sched = build_schedule(W // 16, H // 16, slices)
            planes = synth_frame(W, H, t=2, seed=3)
            _, ys = tif.make_intra_encoder(sched)(
                *(torch.as_tensor(p) for p in planes), 28)
            cache[slices] = (sched, tif.reorder_wave_outputs(sched, ys))
        return cache[slices]
    return get


@pytest.mark.parametrize("slices", [1, 3])
def test_serialize_frame_matches_reference(intra_mbd, slices):
    sched, mbd = intra_mbd(slices)
    rows = sched.slice_starts.tolist()
    wm, hm = W // 16, H // 16
    want_v, want_l = rdc.serialize_frame_j(
        {k: jnp.asarray(to_np(v)) for k, v in mbd.items()}, wm, hm, rows)
    got_v, got_l = tdc.serialize_frame(mbd, wm, hm, rows)
    assert tuple(got_v.shape) == (wm * hm, tdc.MB_SLOTS)
    assert_equal(got_l, want_l, "lengths")
    assert_equal(got_v, want_v, "values")
    # and both types of MB are in the frame
    sel16 = to_np(mbd["sel16"]).astype(bool)
    assert sel16.any() and (~sel16).any()


@pytest.mark.parametrize("slices", [1, 3])
def test_serialize_frame_with_t8_mode(intra_mbd, slices):
    """In a PPS with the 8x8 transform (IPPP with the default tools), an
    I_NxN MB carries transform_size_8x8_flag = 0 right after mb_type."""
    sched, mbd = intra_mbd(slices)
    rows = sched.slice_starts.tolist()
    wm, hm = W // 16, H // 16
    want_v, want_l = rdc.serialize_frame_j(
        {k: jnp.asarray(to_np(v)) for k, v in mbd.items()}, wm, hm, rows,
        t8_mode=True)
    got_v, got_l = tdc.serialize_frame(mbd, wm, hm, rows, t8_mode=True)
    assert tuple(got_v.shape) == (wm * hm, tdc.MB_SLOTS + 1)
    assert_equal(got_l, want_l, "lengths")
    assert_equal(got_v, want_v, "values")
    assert_equal(got_l[:, 1], ~mbd["sel16"].to(torch.bool), "flag slot")
