"""Explicit weighted prediction of IPPP P frames on the CPU: the port
against the JAX reference, tolerance 0.

- Streams: five frames of a fade to black (`fade_frames`, the input of
  `tests/test_ippp.py::test_weighted_prediction_emission_fade`) at 112x80,
  QP 30, the reference's default P tools, CAVLC and CABAC: the bytes, every
  recon plane, and every P frame's (weight, offset), at least one of which
  is not the default (64, 0).  The geometry is that of
  `tests/test_ippp.py::test_p8x8_sub_mb_tree_roundtrip`; the reference's
  encodes are pinned (`torch_util.reference_run`).
- One weighted P wave: `wave_body_plain` (the gather, the I4x4 search and
  `p_wave_plain`, which KP is held to on the card) against the reference's
  weighted wave body composed eagerly from its parts
  (`test_torch_p_wave._ref_p_wave_body`), weights (58, -7) and (71, 12),
  the P tools off and on, on seeded waves whose source tiles are faded by
  the same weights; no encoder is compiled.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch


from tpu264_torch.coding import inter_frame as tinter
from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig
from tpu264_torch.kernels import p_wave as kp
from tpu264_torch.ref.transform import chroma_qp

from test_torch_p_wave import HM, _ref_p_wave_body, _wave, _wave_tools
from torch_util import (assert_decodes_to_recon, assert_equal,
                        assert_same_encode, reference_run, to_np)

FULL = kp.Tools(True, True, True)


@pytest.mark.parametrize("symbol_mode", ["CAVLC", "CABAC"])
def test_weighted_stream_equals_reference(symbol_mode):
    run = reference_run(f"wp/{symbol_mode.lower()}")
    cfg, frames, ref, ref_wp, want = (run.cfg, run.frames, run.enc, run.wp,
                                      run.stream)
    assert ref.wp_mode and ref.partitions and ref.t8_mode
    port = Encoder(EncoderConfig.from_reference(dataclasses.asdict(cfg)),
                   device="cpu")
    assert port.wp_mode and port.pps.weighted_pred_flag == 1
    got = port.encode_sequence(frames)
    assert_same_encode(ref, want, port, got)
    assert [s.wp for s in port.stats] == [None] + ref_wp
    assert len(ref_wp) == 4 and any(w != (64, 0) for w in ref_wp), ref_wp
    assert_decodes_to_recon(port, got, len(frames))


@pytest.mark.parametrize("tools", [kp.NO_TOOLS, FULL])
@pytest.mark.parametrize("wy,oy", [(58, -7), (71, 12)])
def test_weighted_p_wave_matches_reference(wy, oy, tools):
    qp = 28
    cqp = chroma_qp(qp)
    lam4, lam24, lam_me = tif.LAMBDA_TABLE[qp]
    if tools.partitions:
        *case, mvp = _wave_tools(400 + wy + oy)
    else:
        case, mvp = _wave(400 + wy + oy), None
    (planes, cu, cv, bd, mv_map, ref_map, coords, avail, mv_me, gy, gu,
     gv) = case
    # the source faded as the weights say: the lanes that the unweighted
    # reference predicts, its weighted samples predict
    gy = tinter.weight_luma(gy, wy, oy)
    j32 = lambda t: jnp.asarray(to_np(t), jnp.int32)
    want_bd, want_mv, want_ref, want = _ref_p_wave_body(
        j32(planes), j32(cu), j32(cv), qp, cqp, lam4, lam24, lam_me,
        {k: j32(v) for k, v in bd.items()},
        j32(mv_map[:, :HM + 1]), j32(ref_map[:, :HM + 1]), j32(coords),
        jnp.asarray(to_np(avail)), j32(mv_me), j32(gy), j32(gu), j32(gv),
        None if mvp is None else j32(mvp), tools, wy, oy)
    args = (planes, cu, cv, qp, cqp, lam4, lam24, lam_me)
    xs = (coords, avail, mv_me, gy, gu, gv, mvp, tools)
    plain = tinter.wave_body(*args, {k: v.clone() for k, v in bd.items()},
                             mv_map.clone(), ref_map.clone(), *xs)
    got = tinter.wave_body(*args, bd, mv_map, ref_map, *xs, wy=wy, oy=oy)
    assert list(got) == list(kp.outputs(tools))
    for k in kp.outputs(tools):
        assert_equal(got[k], want[k], k)
    for k in want_bd:
        assert_equal(bd[k], want_bd[k], k)
    assert_equal(mv_map[:, :HM + 1], want_mv, "mv_map")
    assert_equal(ref_map[:, :HM + 1], want_ref, "ref_map")
    # the weights changed the wave, and it still mixes inter and intra
    n = int((coords[:, 0] < HM).sum())
    assert not torch.equal(got["recon_mb"][:n], plain["recon_mb"][:n])
    inter = to_np(got["is_inter"])[:n].astype(bool)
    assert inter.any() and (~inter).any()


def test_weight_luma_is_the_reference_formula():
    """`weight_luma` against the spec's formula on every sample value, and
    (64, 0) leaves a prediction as it is."""
    p = torch.arange(256, dtype=torch.int32)
    for wy, oy in ((1, -128), (58, -7), (64, 0), (71, 12), (127, 127)):
        want = np.clip(((np.arange(256) * wy + 32) >> 6) + oy, 0, 255)
        assert_equal(tinter.weight_luma(p, wy, oy), want, f"{wy}, {oy}")
    assert tinter.weight_luma(p, 64, 0) is p
