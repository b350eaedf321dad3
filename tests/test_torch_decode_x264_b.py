"""The port's decoder against the reference decoder on x264 streams with
B pictures, both entropy coders: a B pyramid with MMCO, implicit weighted
bi-prediction, and B pictures with the 8x8 transform, adaptive per-MB
QPs, deblocking offsets and two slices a picture.  Frames equal array
for array, SEI messages field for field (`torch_util.decode_both`).
QCIF."""

import pytest

from x264_util import x264_encode

from test_torch_decode_x264 import x264_frames
from torch_util import decode_both

B = ("cabac={ec}:b-adapt=0:weightp=0:trellis=0:scenecut=0:keyint=30"
     ":no-mbtree=1:direct=spatial")

CASES = {
    # six frames: the strict pyramid's last P picture carries an MMCO 1
    "pyramid_mmco": (x264_frames(6), 28,
                     ":bframes=3:b-pyramid=strict:ref=2:partitions=none"
                     ":no-weightb=1:8x8dct=0:aq-mode=0:slices=1"),
    "implicit_weighted_b": (x264_frames(4, fade=True), 28,
                            ":bframes=2:b-pyramid=none:ref=1"
                            ":partitions=none:weightb=1:8x8dct=0"
                            ":aq-mode=0:slices=1"),
    "t8_aq_offsets_slices": (x264_frames(4), 26,
                             ":bframes=2:b-pyramid=normal:ref=2"
                             ":partitions=all:8x8dct=1:aq-mode=1"
                             ":deblock=1,-2:slices=2:crf=26"),
}


@pytest.mark.parametrize("ec", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_x264_b_stream_decodes_as_reference(case, ec):
    frames, qp, extra = CASES[case]
    stream = x264_encode(frames, qp=qp, params=B.format(ec=ec) + extra)
    got, _, pics = decode_both(stream)
    assert len(got) == len(frames) == len(pics)
    if "aq" in case:                 # x264's AQ needs CRF, as `crf=26`
        assert max(n for n, _, _ in pics) > 1
        assert {off for _, off, _ in pics} == {(2, -4)}
