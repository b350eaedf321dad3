"""The port's decoder (`tpu264_torch.decode`, deblocking on the CPU)
against the reference decoder on x264 streams of P pictures, both entropy
coders: multiple references with partitions, the 8x8 transform with
adaptive per-MB QPs and deblocking offsets, explicit weighted prediction.
Frames equal array for array, SEI messages field for field
(`torch_util.decode_both`).  QCIF; the B streams are in
`test_torch_decode_x264_b.py`."""

import numpy as np
import pytest

from x264_util import x264_encode

from torch_util import QCIF_H, QCIF_W, decode_both

BASE = ("cabac={ec}:bframes=0:weightp=0:trellis=0:slices=1:scenecut=0"
        ":aq-mode=0")


def x264_frames(n, seed=5, fade=False):
    """A pan with a noise band refreshed at the left edge (skips, vectors
    and intra MBs), luma faded by 8 % a frame when `fade`."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 255, (QCIF_H, QCIF_W)).astype(np.uint8)
    out = []
    for t in range(n):
        y = np.roll(y, 2, axis=1)
        y[:, :8] = rng.randint(0, 255, (QCIF_H, 8))
        u = rng.randint(0, 255, (QCIF_H // 2, QCIF_W // 2)).astype(np.uint8)
        v = rng.randint(0, 255, (QCIF_H // 2, QCIF_W // 2)).astype(np.uint8)
        yt = ((y.astype(np.float32) * (1 - 0.08 * t)).astype(np.uint8)
              if fade else y.copy())
        out.append((yt, u, v))
    return out


# x264 adapts the QP per MB (aq-mode) only under a rate control mode such
# as CRF: `crf` after x264_util's `qp` selects it.
CASES = {
    "multiref_partitions": (x264_frames(5), 24,
                            ":8x8dct=0:ref=3:partitions=p8x8:keyint=4"),
    "t8_aq_deblock_offsets": (x264_frames(4), 26,
                              ":8x8dct=1:ref=2:partitions=all:keyint=30"
                              ":aq-mode=1:deblock=-2,1:crf=26"),
    "weighted_p": (x264_frames(4, fade=True), 28,
                   ":8x8dct=0:ref=2:partitions=p8x8:keyint=30"
                   ":weightp=2"),
}


@pytest.mark.parametrize("ec", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_x264_p_stream_decodes_as_reference(case, ec):
    frames, qp, extra = CASES[case]
    stream = x264_encode(frames, qp=qp, params=BASE.format(ec=ec) + extra)
    got, _, pics = decode_both(stream)
    assert len(got) == len(frames) == len(pics)
    if "aq" in case:
        assert max(n for n, _, _ in pics) > 1        # per-MB QPs
        assert {off for _, off, _ in pics} == {(-4, 2)}
