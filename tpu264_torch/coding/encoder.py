"""Sequence-level encoder (torch), counterpart of
`tpu264.coding.encoder` for all-intra, IPPP and hierarchical-B GOPs,
CABAC or CAVLC, with the reference's default P tools (16x8/8x16 and P_8x8
partitions, the 8x8 transform), the B 16x8/8x16 partitions, explicit
weighted prediction of IPPP P frames, SEI messages, and JVT-G012 frame
rate control.

Parameter-set emission, per-frame device encode (wavefront mode decision
with kernels K2/K3, motion search and the P or B wave body, the wavefront
deblocker with K4, then either CABAC binarization and the range coder K1
or the CAVLC serializer and bit packer), Annex-B assembly and per-frame
stats.  All-intra CAVLC sequences at a fixed QP go through the batched
entry, which codes a chunk of frames through each stage at once: one
launch of each wave kernel a wave for the whole chunk, one serializer and
packer pass, one deblocking pass and one pull.
The encoder runs on the CUDA card unless the caller asks for
`device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import warnings

import numpy as np
import torch

from tpu264_torch.bits import nal, sei
from tpu264_torch.bits.params import PPS, SPS
from tpu264_torch.bits.slicehdr import SLICE_B, SLICE_I, SLICE_P, SliceHeader
from tpu264_torch.config import EncoderConfig
from tpu264_torch.entropy import cabac_engine_cuda as k1
from tpu264_torch.entropy import device_cavlc as dcav
from tpu264_torch.entropy.device_cavlc import compute_cbp, luma_tc_grid
from tpu264_torch.entropy.slice_writer import trailing_skip_run
from tpu264_torch.kernels import cabac_records as kcr
from tpu264_torch.kernels import cavlc_slices as kcv
from tpu264_torch.kernels.deblock import make_deblocker_skewed, up4
from tpu264_torch.ref.transform import chroma_qp
from tpu264_torch.runtime.ratectl import RateController
from . import mvpred
from .b_frame import make_b_encoder
from .inter_frame import make_inter_encoder
from .intra_frame import make_intra_encoder, reorder_wave_outputs
from .wavefront import build_schedule

RECORDS_PER_MB = 768        # record cap per MB of a slice (binarizer output)
WORDS_PER_MB = 100          # 3200 bits/MB ceiling (spec A.3.1)


@dataclasses.dataclass
class FrameStats:
    frame: int
    slice_type: str
    bits: int
    psnr_y: float
    psnr_u: float
    psnr_v: float
    seconds: float
    qp: int             # the slice QP (rate control's choice where it runs)
    wp: tuple | None = None   # (luma weight, offset) of a weighted P frame


def build_bgop_plan(nfr: int, num_b: int, intra_period: int):
    """Coding-order plan of a B-GOP sequence (the reference's
    `build_bgop_plan`): a list of (display, kind, ref0, ref1, layer), kind
    "I" / "P" anchors (layer 0), "Bref" pyramid midpoints, "B" leaves;
    layer is the pyramid depth (1 = directly between anchors).  num_b >= 2
    builds the dyadic hierarchy; the IDR cadence counts display frames,
    with chained-P tails before each closed-GOP IDR."""
    step = num_b + 1
    hier = num_b >= 2
    anchors = list(range(0, nfr, step))
    if anchors[-1] != nfr - 1:
        anchors.append(nfr - 1)

    def fill_gap(lo, hi, plan, depth):
        if hi - lo <= 1:
            return
        if not hier:
            for d in range(lo + 1, hi):
                plan.append((d, "B", lo, hi, depth))
            return
        mid = (lo + hi) // 2
        is_ref = (mid - lo > 1) or (hi - mid > 1)
        plan.append((mid, "Bref" if is_ref else "B", lo, hi, depth))
        fill_gap(lo, mid, plan, depth + 1)
        fill_gap(mid, hi, plan, depth + 1)

    plan = []
    prev = None
    last_idr = 0
    for ai, a in enumerate(anchors):
        is_idr = ai == 0 or (intra_period > 1
                             and a - last_idr >= intra_period)
        if is_idr:
            last_idr = a
        if prev is None:
            plan.append((a, "I", None, None, 0))
        elif is_idr:
            # closed GOP: an IDR flushes the DPB, so the gap frames before
            # it go out as a chained-P tail in display order, then the IDR
            for d in range(prev + 1, a):
                plan.append((d, "P", d - 1, None, 0))
            plan.append((a, "I", None, None, 0))
        else:
            plan.append((a, "P", prev, None, 0))
            fill_gap(prev, a, plan, 1)
        prev = a
    return plan


def build_params(cfg: EncoderConfig, gop_mode: str = "intra",
                 t8: bool = False, wp: bool = False):
    """SPS/PPS of an all-intra, IPPP or B-GOP stream (the parameter sets
    the reference's `build_params` writes) -> (sps, pps, cabac).  A B GOP
    has display-order POC (type 0), is signalled as Main where the config
    says Baseline, and keeps 4 (pyramid) or 2 reference frames and 2 or 1
    reorder frames.
    `t8`: the 8x8 transform is used, which needs High profile and
    transform_8x8_mode_flag.  `wp`: P slices carry explicit weights
    (weighted_pred_flag)."""
    if gop_mode not in ("intra", "ippp", "bgop"):
        raise ValueError(f"build_params: unknown gop_mode {gop_mode!r}")
    bgop = gop_mode == "bgop"
    sps = SPS(
        profile_idc=(77 if bgop and cfg.profile_idc == 66
                     else cfg.profile_idc),
        constraint_flags=(0xC0 if cfg.profile_idc == 66 and not bgop
                          else 0),
        level_idc=cfg.level_idc,
        pic_order_cnt_type=0 if bgop else 2,
        max_num_ref_frames=max((4 if cfg.num_b_frames >= 2 else 2)
                               if bgop else 1, cfg.num_ref_frames),
        pic_width_in_mbs=cfg.width_mbs,
        pic_height_in_map_units=cfg.height_mbs,
        num_reorder_frames=((2 if cfg.num_b_frames >= 2 else 1)
                            if bgop else None),
    )
    cabac = cfg.symbol_mode.upper() == "CABAC"
    if cabac and sps.profile_idc == 66:
        # CABAC requires Main/High (spec A.2.1); signal Main instead
        sps.profile_idc = 77
        sps.constraint_flags = 0
    if t8:
        sps.profile_idc = 100            # High (transform_8x8 needs it)
        sps.constraint_flags = 0
    pps = PPS(
        entropy_coding_mode_flag=1 if cabac else 0,
        pic_init_qp=26,
        deblocking_filter_control_present_flag=1,
        transform_8x8_mode_flag=1 if t8 else 0,
        weighted_pred_flag=1 if wp else 0,
    )
    return sps, pps, cabac


def colstate_of(mbd):
    """Per-MB colocated state for spatial direct (spec 8.4.1.2.2) from a P
    frame's raster results -> (colzero, colmixed) [n] bool.  colzero:
    every 4x4 cell of the MB has colZeroFlag = 1 (inter, ref 0, |mv| <= 1
    in both components); colmixed: the cells disagree, so a later B frame
    must not choose direct there.  16x16 MBs are never mixed; 16x8 / 8x16
    weigh both partitions' vectors, P_8x8 all four quadrants'."""
    is_inter = mbd["is_inter"].to(torch.bool)

    def cz(m):
        return (m.to(torch.int32).abs() <= 1).all(dim=-1)

    c0 = cz(mbd["mv"])
    all_c = any_c = c0
    if "ptype" in mbd:
        pt = mbd["ptype"].to(torch.int32)
        c1 = cz(mbd["mv2"])
        two = (pt == 1) | (pt == 2)
        all_c = torch.where(two, c0 & c1, all_c)
        any_c = torch.where(two, c0 | c1, any_c)
        if "mvq" in mbd:
            cq = cz(mbd["mvq"])                         # [n, 4]
            all_c = torch.where(pt == 3, cq.all(dim=1), all_c)
            any_c = torch.where(pt == 3, cq.any(dim=1), any_c)
    return is_inter & all_c, is_inter & any_c & ~all_c


def b_colstate(mbd):
    """A B picture's colocated state as a later list-1 reference ->
    (colzero, colmixed) [n] bool: inter MBs whose used list's vector is
    within +-1 quarter-pel; a B picture that is referenced has no
    partitions, so no cell disagrees."""
    use0 = mbd["use0"].to(torch.bool)
    use1 = mbd["use1"].to(torch.bool)
    mv = torch.where(use0[:, None], mbd["mv0"], mbd["mv1"])
    return ((use0 | use1) & (mv.abs() <= 1).all(dim=1),
            torch.zeros_like(use0))


def gop_mode_of(cfg: EncoderConfig) -> str:
    """The reference's default GOP mode of a config."""
    if cfg.num_b_frames > 0 and cfg.intra_period != 1:
        return "bgop"
    return "intra" if cfg.intra_period == 1 else "ippp"


def tools_of(cfg: EncoderConfig, gop_mode: str):
    """The reference's tool rules -> (partitions, t8_mode, b_partitions):
    16x8/8x16 and P_8x8 and the 8x8 transform are on for IPPP and for the P
    anchors of B GOPs unless the config says False (asked for in an
    all-intra GOP, a warning); the B 16x8/8x16 on the non-reference B
    frames of a B GOP likewise.  B slices code the 4x4 transform only."""
    inter = gop_mode in ("ippp", "bgop")
    for field in ("inter_partitions", "transform_8x8"):
        if getattr(cfg, field) and not inter:
            warnings.warn(f"{field} requested but only supported for "
                          "IPPP / B GOPs; encoding without it",
                          stacklevel=3)
    return (inter and cfg.inter_partitions is not False,
            inter and cfg.transform_8x8 is not False,
            gop_mode == "bgop" and cfg.inter_partitions is not False)


def _psnr3(sse, sizes):
    return tuple(99.99 if s == 0 else
                 10 * np.log10(255.0 ** 2 * npx / float(s))
                 for s, npx in zip(sse, sizes))


# ---- the stages of one coded picture after its wave loop.  `Encoder`
# codes a frame through them, the tiled encoder (`runtime/tiled.py`) each
# band of a frame.

@dataclasses.dataclass(frozen=True)
class Picture:
    """A coded picture's geometry: `wm` x `hm` MBs on `device`, coded as
    slices of equal height that start at the MB rows `rows`; `t8_mode`:
    the PPS has the 8x8 transform."""
    wm: int
    hm: int
    rows: tuple
    t8_mode: bool
    device: torch.device

    @property
    def n_mbs(self) -> int:
        return self.wm * self.hm


def cabac_records(pic: Picture, mbd, kind: str, cap: int):
    """Binarize + compact a picture of slice kind `kind` ("i", "p" or "b")
    -> packed records [S, width], counts [S]: on the card kernel KR
    (`kernels/cabac_records.py`), queued with nothing read back (a
    `Queued`, which unpacks to the pair once the host waits for it), on
    the CPU its plain version.

    In a PPS with the 8x8 transform, I_NxN MBs of I slices carry its flag
    too (a zero t8 map; B MBs send it as 0).  A slice over the record cap
    `cap` (pathological content) keeps every record: the rows are then as
    wide as the largest slice, so the stream is the one an unbounded
    buffer gives (the reference re-binarizes such a picture on the
    host)."""
    return kcr.queue(mbd, pic.wm, pic.hm, list(pic.rows), kind, cap,
                     pic.t8_mode)


def cabac_payloads(recs, counts, qp: int, kind: str, cap_words: int) -> list:
    """CABAC slice payloads through the range coder (kernel K1, one launch
    for all slices), with the contexts of init table 0 in an I slice and
    of table 1 (cabac_init_idc 0) in a P or B slice."""
    table = 0 if kind == "i" else 1
    init = torch.as_tensor(k1.init_packed_states(table, qp),
                           device=recs.device)
    words, nbytes = k1.encode_slices(recs, counts, init, cap_words)
    return k1.payloads_from_words(words, nbytes)


def cabac_nalus(payloads, hdr, nal_ref_idc, nal_type) -> list:
    """One picture's NAL units: each slice's payload after its header
    `hdr(s)` and the alignment bits."""
    nalus = []
    for s, payload in enumerate(payloads):
        sink = hdr(s)
        sink.cabac_align()
        nalus.append(nal.make_nalu(nal_ref_idc, nal_type,
                                   sink.to_bytes() + payload))
    return nalus


def _flat(mbd) -> dict:
    """A chunk's raster MB dict [F, n, ...] as one of F n MBs."""
    return {k: v.flatten(0, 1) for k, v in mbd.items()}


def serialize(pic: Picture, mbd, kind: str, cap_words: int,
              frames: int | None = None):
    """CAVLC serialize + pack on device a picture of slice kind `kind`
    ("i", "p" or "b") -> (words, nbits, skipped): on the card KD and
    kernel KV (`kernels/cavlc_slices.py`, int32 words), nothing read
    back; on the CPU its plain version (int64 words).  In a PPS with the
    8x8 transform, I_NxN MBs of I slices carry its flag too.  `frames`: a
    chunk of that many I pictures (`mbd` [F, n, ...]) in one pass ->
    words [F, S, cap_words], nbits [F, S], None."""
    rows = list(pic.rows)
    if frames is None:
        return kcv.serialize(mbd, pic.wm, pic.hm, rows, kind, cap_words,
                             pic.t8_mode)
    if kind != "i":
        raise ValueError("serialize: a chunk of pictures is all-intra")
    words, nbits, _ = kcv.serialize(_flat(mbd), pic.wm, pic.hm, rows, "i",
                                    cap_words, pic.t8_mode, frames)
    return (words.unflatten(0, (frames, -1)),
            nbits.unflatten(0, (frames, -1)), None)


def cavlc_nalus(pic: Picture, words_np, nbits_np, skipped_np, hdr,
                nal_ref_idc, nal_type) -> list:
    """One picture's NAL units from its pulled slice words [S, W] and bit
    counts [S]; `hdr(s)` gives slice s's header sink, `skipped_np` [n] (P
    and B slices) the MBs whose trailing run the host appends."""
    per_slice = pic.n_mbs // len(pic.rows)
    nalus = []
    for s in range(len(pic.rows)):
        tail = None
        if skipped_np is not None:
            tail = trailing_skip_run(skipped_np, s * per_slice,
                                     (s + 1) * per_slice)
        nb = int(nbits_np[s])
        rbsp = dcav.words_to_rbsp(words_np[s, :(nb + 31) // 32], nb,
                                  hdr(s), final_skip_run=tail)
        nalus.append(nal.make_nalu(nal_ref_idc, nal_type, rbsp))
    return nalus


def queue_entropy(pic: Picture, mbd, kind: str, cabac: bool,
                  records_cap: int, cap_words: int):
    """The device half of a picture's entropy coding: its CABAC records
    (`cabac_records`) or its packed CAVLC words (`serialize`)."""
    if cabac:
        return cabac_records(pic, mbd, kind, records_cap)
    return serialize(pic, mbd, kind, cap_words)


def entropy_nalus(pic: Picture, queued, qp: int, kind: str, cabac: bool,
                  cap_words: int, hdr, nal_ref_idc, nal_type) -> list:
    """The host half of `queue_entropy`: K1 on the records (CABAC; on the
    card once KR's largest count has reached the host) or the pull of
    the words and the skip map (CAVLC) -> the picture's NAL units, each
    slice after its header `hdr(s)`."""
    if cabac:
        return cabac_nalus(cabac_payloads(*queued, qp, kind, cap_words), hdr,
                           nal_ref_idc, nal_type)
    words, nbits, skipped = queued
    nbits_np = nbits.cpu().numpy()
    return cavlc_nalus(pic, _pull_words(words, nbits_np), nbits_np,
                       None if skipped is None else skipped.cpu().numpy(),
                       hdr, nal_ref_idc, nal_type)


def deblock_inputs(pic: Picture, mbd, kind: str, frames: int | None = None):
    """The deblocker's bS inputs (intra_mb, tc_luma, mv, ref, t8_mb),
    derived on device from the raster MB dict of a picture of slice kind
    `kind` ("i", "p" or "b"): a P picture's single-list motion from its
    "is_inter" and "mv", per 4x4 block where it has partitions ("ptype",
    "mv2", "mvq"); a B picture's two-list motion (`b_motion`); an
    all-intra picture has none.  The coefficient condition of an
    8x8-transform MB counts the covering 8x8 block's coefficients on every
    4x4 block.  `frames`: `mbd` holds a chunk of that many pictures
    ([F, n, ...]), and so does each input ([F, ...]); every input is an MB's
    or a 4x4 block's own, so the chunk is derived as one picture of F hm
    MB rows and cut back into pictures."""
    if frames is not None:
        tall = dataclasses.replace(pic, hm=pic.hm * frames)
        return tuple(None if t is None else t.unflatten(0, (frames, -1))
                     for t in deblock_inputs(tall, _flat(mbd), kind))
    wm, hm, n, dev = pic.wm, pic.hm, pic.n_mbs, pic.device
    if kind == "b":
        is_inter = mbd["btype"].to(torch.int32) != 4
    elif kind == "p":
        is_inter = mbd["is_inter"].to(torch.bool)
    else:
        is_inter = torch.zeros(n, dtype=torch.bool, device=dev)
    cbp_luma, _, _ = compute_cbp(mbd["sel16"].to(torch.bool),
                                 mbd["luma_ac"], mbd["chroma_dc"],
                                 mbd["chroma_ac"])
    tc = luma_tc_grid(mbd, cbp_luma, wm, hm)
    t8_mb = None
    if "t8" in mbd:
        t8_mb = mbd["t8"].to(torch.bool).reshape(hm, wm)
        tc8 = tc.reshape(hm * 2, 2, wm * 2, 2).sum(dim=(1, 3),
                                                   dtype=torch.int32)
        tc = torch.where(up4(t8_mb), tc8.repeat_interleave(2, 0)
                         .repeat_interleave(2, 1), tc)
    if kind == "b":
        mv_grid, ref_grid = b_motion(pic, mbd, is_inter)
        return (~is_inter).reshape(hm, wm), tc, mv_grid, ref_grid, t8_mb
    mv = (mbd["mv"].to(torch.int32) if kind == "p"
          else torch.zeros((n, 2), dtype=torch.int32, device=dev))
    mv_grid = torch.where(is_inter[:, None], mv, 0).reshape(hm, wm, 2)
    ref_grid = torch.where(is_inter, 0, mvpred.INTRA).to(torch.int32) \
        .reshape(hm, wm)
    if kind == "p" and "ptype" in mbd:
        # partitions: per-4x4 grids (part1 covers the bottom rows of a
        # 16x8 MB, the right columns of an 8x16 one; a P_8x8 MB's blocks
        # take their quadrant's vector)
        pt4 = up4(mbd["ptype"].to(torch.int32).reshape(hm, wm))
        rsel = (torch.arange(hm * 4, device=dev) % 4 >= 2)[:, None]
        csel = (torch.arange(wm * 4, device=dev) % 4 >= 2)[None, :]
        use2 = torch.where(pt4 == 1, rsel, (pt4 == 2) & csel)
        mv2 = torch.where(is_inter[:, None], mbd["mv2"].to(torch.int32),
                          0).reshape(hm, wm, 2)
        mv_grid = torch.where(use2[..., None], up4(mv2), up4(mv_grid))
        if "mvq" in mbd:
            mq = torch.where(is_inter[:, None, None],
                             mbd["mvq"].to(torch.int32), 0)
            q4 = up4(mq.reshape(hm, wm, 4, 2))       # [4hm, 4wm, 4, 2]
            qsel = (rsel.long() * 2 + csel.long()).expand(hm * 4, wm * 4)
            mvq_grid = torch.gather(
                q4, 2, qsel[..., None, None].expand(-1, -1, 1, 2))[..., 0, :]
            mv_grid = torch.where((pt4 == 3)[..., None], mvq_grid, mv_grid)
        ref_grid = up4(ref_grid)
    return (~is_inter).reshape(hm, wm), tc, mv_grid, ref_grid, t8_mb


def b_motion(pic: Picture, mbd, is_inter):
    """A B picture's two-list motion for the bS derivation: (mv [hm, wm, 2,
    2], picture ids [hm, wm, 2]) per MB (list 0's picture is 0, list 1's
    is 1, -1 where a list is unused), or per 4x4 block ([4hm, 4wm, ...])
    where the picture has partitions ("bptype"; part 1 covers the bottom
    rows of a 16x8 MB, the right columns of an 8x16 one)."""
    wm, hm, dev = pic.wm, pic.hm, pic.device
    use0 = mbd["use0"].to(torch.bool)
    use1 = mbd["use1"].to(torch.bool)
    mv0 = mbd["mv0"].to(torch.int32)
    mv1 = mbd["mv1"].to(torch.int32)
    if "bptype" not in mbd:
        mv = torch.stack([torch.where(use0[:, None], mv0, 0),
                          torch.where(use1[:, None], mv1, 0)], dim=1)
        pid = torch.stack([torch.where(use0, 0, -1),
                           torch.where(use1, 1, -1)], dim=1)
        return (mv.reshape(hm, wm, 2, 2),
                pid.to(torch.int32).reshape(hm, wm, 2))
    partd = mbd["btype"].to(torch.int32) == 5
    c1 = mbd["c1"].to(torch.int64)
    use0b = torch.where(partd, c1 != 1, use0)
    use1b = torch.where(partd, c1 != 0, use1)
    bt4 = up4(mbd["bptype"].to(torch.int32).reshape(hm, wm))
    rsel = (torch.arange(hm * 4, device=dev) % 4 >= 2)[:, None]
    csel = (torch.arange(wm * 4, device=dev) % 4 >= 2)[None, :]
    p1cell = torch.where(bt4 == 1, rsel, (bt4 == 2) & csel)

    def list_grids(mvp0, up0, mvp1, up1, pid):
        grids = []
        for mvp, up in ((mvp0, up0), (mvp1, up1)):
            on = up & is_inter
            grids.append((
                up4(torch.where(on[:, None], mvp.to(torch.int32), 0)
                    .reshape(hm, wm, 2)),
                up4(torch.where(on, pid, -1).to(torch.int32)
                    .reshape(hm, wm))))
        (m0, r0), (m1, r1) = grids
        return (torch.where(p1cell[..., None], m1, m0),
                torch.where(p1cell, r1, r0))

    mvl0, refl0 = list_grids(mv0, use0, mbd["mv0b"], use0b, 0)
    mvl1, refl1 = list_grids(mv1, use1, mbd["mv1b"], use1b, 1)
    return (torch.stack([mvl0, mvl1], dim=2),
            torch.stack([refl0, refl1], dim=2))


def recon_planes(deblock, pic: Picture, dev_out, mbd, qp: int,
                 kind: str = "i", frames: int | None = None):
    """The picture (of slice kind `kind`) that is output and referenced,
    uint8 on the device: filtered by the wavefront deblocker `deblock`
    where there is one.  `frames`: a chunk of that many pictures
    (planes [F, H, W], `mbd` [F, n, ...]) in one deblocking pass."""
    if deblock is None:
        return tuple(dev_out[k].to(torch.uint8)
                     for k in ("recon_y", "recon_u", "recon_v"))
    *inputs, t8_mb = deblock_inputs(pic, mbd, kind, frames)
    fy, fu, fv = deblock(dev_out["recon_y"], dev_out["recon_u"],
                         dev_out["recon_v"], *inputs, qp, chroma_qp(qp),
                         t8_mb=t8_mb)
    return (fy.to(torch.uint8), fu.to(torch.uint8), fv.to(torch.uint8))


def sse3(orig, recon):
    """[SSE Y, SSE U, SSE V, sum |Y - Y'|] of a picture, an int64 tensor on
    its device (the last entry is the rate controller's MAD numerator);
    of each picture of a chunk, [F, 4], for planes [F, H, W]."""
    d = [(o.to(torch.int64) - r.to(torch.int64)).flatten(-2)
         for o, r in zip(orig, recon)]
    return torch.stack([(x * x).sum(-1) for x in d] + [d[0].abs().sum(-1)],
                       dim=-1)


class Encoder:
    """H.264 encoder: all-intra, IPPP and hierarchical-B GOPs with CABAC or
    CAVLC (P_Skip / P_L0_16x16 / P_L0_16x8 / P_L0_8x16 / P_8x8 / I16x16 /
    I4x4 per P MB, full-search ME with quarter-pel refinement for the MB
    and each partition, the 8x8 transform of 16x16 inter MBs; B_L0 / B_L1
    / B_Bi_16x16, spatial direct, 16x8 / 8x16 and intra per B MB, both
    lists searched; periodic IDR), optional in-loop deblocking, 1 or
    several slices, and JVT-G012 rate control when `cfg.rate_control`
    and `cfg.bitrate > 0`.

    `gop_mode`: "intra" = every frame IDR; "ippp" = first frame IDR, rest
    P (`cfg.intra_period > 1` inserts periodic IDR frames); "bgop" = P
    anchors `cfg.num_b_frames + 1` frames apart with B frames between
    them (`build_bgop_plan`).  The default follows `cfg.intra_period` and
    `cfg.num_b_frames` as in the reference, and so do the tools:
    `cfg.inter_partitions` (16x8/8x16 and P_8x8; the B 16x8/8x16 on
    non-reference B frames) and `cfg.transform_8x8` are on for IPPP and
    B GOPs unless the config says False.
    `device`: where the frame encode runs: "cuda" (the default) runs the
    CUDA kernels and raises where there is no card; "cpu", which a caller
    must ask for, runs every kernel's plain torch version.
    `records_per_mb`: room of a slice's CABAC record buffer per MB; a
    slice that needs more is compacted again at its true size.
    `intra_batch`: frames in a chunk of the batched all-intra entry
    (CAVLC; 1 turns it off).
    """

    def __init__(self, cfg: EncoderConfig, gop_mode: str | None = None,
                 device="cuda", records_per_mb: int = RECORDS_PER_MB,
                 intra_batch: int = 4):
        cfg.validate()
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Encoder: device {str(self.device)!r} asked for, but "
                "torch.cuda.is_available() is False; pass device=\"cpu\" to "
                "run the plain torch versions on the CPU")
        if gop_mode is None:
            gop_mode = gop_mode_of(cfg)
        # as in the reference, rate control runs only with a target
        # bitrate; without one the encode is at fixed QP
        rc_on = cfg.rate_control and cfg.bitrate > 0
        if gop_mode not in ("intra", "ippp", "bgop"):
            raise ValueError(f"unknown gop_mode {gop_mode!r}")
        self.gop_mode = gop_mode
        self.intra_batch = max(1, int(intra_batch))
        self.sched = build_schedule(cfg.width_mbs, cfg.height_mbs,
                                    cfg.slices_per_frame)
        self.partitions, self.t8_mode, self.b_partitions = tools_of(
            cfg, gop_mode)
        self.p8x8 = self.partitions
        # explicit weighted prediction, as in the reference: IPPP only (a B
        # GOP and its P anchors encode without it)
        self.wp_mode = bool(cfg.weighted_pred) and gop_mode == "ippp"
        self._last_wp = None        # the last P frame's (weight, offset)
        self.sps, self.pps, self.cabac = build_params(
            cfg, gop_mode, t8=self.t8_mode, wp=self.wp_mode)
        self.pic = Picture(cfg.width_mbs, cfg.height_mbs,
                           tuple(self.sched.slice_starts.tolist()),
                           self.t8_mode, self.device)
        self._encode_frame = make_intra_encoder(self.sched)
        self._encode_p = self._encode_b = None
        if gop_mode != "intra":
            self._encode_p = make_inter_encoder(
                self.sched, search_range=cfg.search_range,
                partitions=self.partitions, t8=self.t8_mode,
                weighted=self.wp_mode, p8x8=self.p8x8)
        if gop_mode == "bgop":
            self._encode_b = make_b_encoder(
                self.sched, search_range=cfg.search_range,
                partitions=self.b_partitions)
        # in-loop deblocking: idc 0 (on) single-slice, idc 2 (slice-local)
        # multi-slice, idc 1 (off) when disabled
        self.deblock_idc = (1 if not cfg.deblock
                            else (0 if cfg.slices_per_frame == 1 else 2))
        self._deblock = None
        if cfg.deblock:
            self._deblock = make_deblocker_skewed(
                self.sched, filter_across_slices=(self.deblock_idc == 0))
        # rate control (JVT-G012 quadratic model, host side)
        self.rc = None
        if rc_on:
            self.rc = RateController(
                bitrate=cfg.bitrate, frame_rate=cfg.frame_rate,
                n_mbs=cfg.width_mbs * cfg.height_mbs, init_qp=cfg.qp)
        self.stats: list[FrameStats] = []
        per_slice = (cfg.width_mbs * cfg.height_mbs) // cfg.slices_per_frame
        self._cabac_cap = per_slice * records_per_mb
        self._cap_words = per_slice * WORDS_PER_MB

    def _slice_header(self, s: int, slice_type: int, qp: int, **kw):
        """The BitSink holding slice `s`'s header."""
        cfg = self.cfg
        rows_per_slice = cfg.height_mbs // cfg.slices_per_frame
        hdr = SliceHeader(
            first_mb_in_slice=s * rows_per_slice * cfg.width_mbs,
            slice_type=slice_type, slice_qp=qp,
            disable_deblocking_filter_idc=self.deblock_idc, **kw)
        return hdr.write_rbsp_head(self.sps, self.pps)

    def _header_nalus(self) -> list:
        """SPS + PPS (+ with `cfg.sei_messages` one SEI NAL unit: the
        encoder tag and a recovery point, Annex D, as the reference writes
        them) that open every stream."""
        out = [nal.make_nalu(3, nal.NAL_SPS, self.sps.write_rbsp()),
               nal.make_nalu(3, nal.NAL_PPS, self.pps.write_rbsp())]
        if self.cfg.sei_messages:
            rbsp = sei.make_sei_rbsp(
                sei.write_user_data(f"tpu264 - {self.gop_mode} "
                                    f"{self.cfg.symbol_mode.upper()}"),
                sei.write_recovery_point(0))
            out.append(nal.make_nalu(0, nal.NAL_SEI, rbsp))
        return out

    def _encode_sequence_intra_batched(self, frames, batch: int) -> bytes:
        """All-IDR CAVLC sequence in chunks of `batch` frames; the stream
        is identical to the per-frame path's.

        A chunk of F frames goes through each stage once, as the
        reference's vmapped program does: one upload of its planes
        [F, H, W], one wave loop whose every wave is one launch each of K2
        and K3 for all F frames' lanes, one serializer and packer pass
        over its F S slices, one deblocking pass (one K4 launch a wave for
        the chunk), one SSE, and one pull each of the bit counts, the
        packed words and the SSEs.  `FrameStats.seconds` is the chunk's
        time over its frames.  The reference pads a short last chunk with
        copies of its last frame to keep one compiled shape and drops
        their output; there is no shape to keep here, so a short chunk
        encodes just its frames."""
        cfg = self.cfg
        qp = cfg.qp
        out = self._header_nalus()
        self.recons = []
        it = iter(frames)
        c0 = 0
        while True:
            chunk = list(itertools.islice(it, batch))
            if not chunk:
                break
            t0 = time.monotonic()
            nf = len(chunk)
            orig = tuple(torch.as_tensor(
                np.stack([np.asarray(f[k]) for f in chunk]),
                device=self.device) for k in range(3))
            dev_out, ys = self._encode_frame(*orig, qp)
            mbd = reorder_wave_outputs(self.sched, ys, frames=True)
            words, nbits, _ = serialize(self.pic, mbd, "i", self._cap_words,
                                        frames=nf)
            recon = recon_planes(self._deblock, self.pic, dev_out, mbd, qp,
                                 frames=nf)
            self.recons.extend(zip(*recon))
            nbits_np = nbits.cpu().numpy()            # syncs the device
            sse_np = sse3(orig, recon).cpu().numpy()
            words_np = _pull_words(words, nbits_np)
            per_frame_s = (time.monotonic() - t0) / nf
            for b, (y, u, v) in enumerate(chunk):
                i = c0 + b
                nalus = cavlc_nalus(
                    self.pic, words_np[b], nbits_np[b], None,
                    lambda s: self._slice_header(
                        s, SLICE_I, qp, frame_num=0, idr_pic_id=i % 2,
                        is_idr=True),
                    3, nal.NAL_IDR)
                out.extend(nalus)
                bits = sum(8 * len(x) for x in nalus)
                ps = _psnr3(sse_np[b], (y.size, u.size, v.size))
                self.stats.append(FrameStats(
                    i, "IDR", bits, ps[0], ps[1], ps[2], per_frame_s, qp))
            c0 += len(chunk)
        return b"".join(out)

    def encode_sequence(self, frames) -> bytes:
        """frames: iterable of (y, u, v) uint8 planes. Returns Annex-B."""
        if (self.gop_mode == "intra" and self.rc is None and not self.cabac
                and self.intra_batch > 1):
            # batched entry: consume the iterable in chunks (frames stay
            # streamed); a single frame takes the per-frame path
            it = iter(frames)
            head = list(itertools.islice(it, 2))
            if len(head) > 1:
                return self._encode_sequence_intra_batched(
                    itertools.chain(head, it), self.intra_batch)
            frames = head
        if self.gop_mode == "bgop":
            return self._encode_sequence_bgop(frames)
        out = self._header_nalus()
        self.recons = []
        frame_num = 0
        idr_count = 0
        # frame pipelining: the entropy pull + NAL assembly of frame k
        # runs after frame k+1's device work has been queued.  Not under
        # rate control: frame k's bits choose frame k+1's QP.
        pipeline = self.rc is None
        pending = None  # (index, is_idr, qp, wp, finish, sse, sizes, t0)

        def drain():
            nonlocal pending
            if pending is None:
                return
            i0, idr0, qp0, wp0, fin, sse, sizes, t0 = pending
            pending = None
            nalus = fin()
            out.extend(nalus)
            bits = sum(8 * len(b) for b in nalus)
            st = sse.tolist()
            if self.rc is not None:
                self.rc.update("I" if idr0 else "P", bits,
                               float(st[3]) / sizes[0])
            ps = _psnr3(st, sizes)
            self.stats.append(FrameStats(
                i0, "IDR" if idr0 else "P", bits, ps[0], ps[1], ps[2],
                time.monotonic() - t0, qp0, wp0))

        period = self.cfg.intra_period
        for i, (y, u, v) in enumerate(frames):
            t0 = time.monotonic()
            is_idr = (self.gop_mode == "intra" or i == 0
                      or (period > 1 and i % period == 0))
            if self.rc is not None:
                qp = self.rc.frame_qp("I" if is_idr else "P")
            else:
                qp = self.cfg.qp if is_idr else self.cfg.qp_inter
            if is_idr:
                fin, recon = self.encode_intra_frame(
                    y, u, v, idr_pic_id=idr_count % 2, qp=qp)
                idr_count += 1
                frame_num = 1
            else:
                fin, recon = self.encode_p_frame(
                    y, u, v, self.recons[-1], frame_num=frame_num, qp=qp)
                frame_num = (frame_num + 1) % (
                    1 << self.sps.log2_max_frame_num)
            self.recons.append(recon)
            sse = sse3(self._dev_orig, recon)
            if pipeline:
                drain()
            pending = (i, is_idr, qp, None if is_idr else self._last_wp, fin,
                       sse, (y.size, u.size, v.size), t0)
            if not pipeline:
                drain()
        drain()
        return b"".join(out)

    def _encode_sequence_bgop(self, frames) -> bytes:
        """B-GOP sequence (display-order POC type 0, closed GOPs), as the
        reference's `_encode_sequence_bgop` codes it.

        num_b_frames == 1: IbPbP.  num_b_frames >= 2: the dyadic pyramid,
        each anchor gap's midpoint a reference B (layer 1), recursing into
        the halves down to non-reference leaves.  P anchors after a
        reference B carry a ref_pic_list_modification so that list0[0]
        stays the previous anchor.  B QPs follow the pyramid layer
        (QPBSlice + layer - 1); with rate control the anchors take the
        JVT-G012 QP and the Bs ride it (anchor + 2 + layer - 1).  Each
        frame's entropy finish runs before the next frame is queued; the
        stats are kept in display order."""
        cfg = self.cfg
        frames = list(frames)
        nfr = len(frames)
        plan = build_bgop_plan(nfr, cfg.num_b_frames, cfg.intra_period)
        hier = cfg.num_b_frames >= 2
        out = self._header_nalus()
        self.recons = [None] * nfr
        stats = [None] * nfr
        fn = 0
        idr_count = 0
        disp_base = 0
        fn_of = {}                     # display index -> frame_num (refs)
        col_of = {}                    # display index -> (colzero, colmixed)
        last_ref_fn = 0
        max_lsb = 1 << self.sps.log2_max_pic_order_cnt_lsb
        max_fn = 1 << self.sps.log2_max_frame_num
        anchor_qp = cfg.qp_inter
        for disp, kind, r0, r1, layer in plan:
            t0 = time.monotonic()
            y, u, v = frames[disp]
            if kind == "I":
                qp = self.rc.frame_qp("I") if self.rc else cfg.qp
                anchor_qp = qp
                disp_base = disp
                fin, recon = self.encode_intra_frame(
                    y, u, v, frame_num=0, idr_pic_id=idr_count % 2,
                    poc_lsb=0, qp=qp)
                idr_count += 1
                fn_of[disp] = last_ref_fn = 0
                fn = 1
            elif kind == "P":
                qp = (self.rc.frame_qp("P", num_b=cfg.num_b_frames)
                      if self.rc else cfg.qp_inter)
                anchor_qp = qp
                reorder = ()
                if hier and fn_of.get(r0) is not None \
                        and last_ref_fn != fn_of[r0]:
                    # point list0[0] back at the previous anchor
                    reorder = ((0, (fn - fn_of[r0]) % max_fn - 1),)
                fin, recon = self.encode_p_frame(
                    y, u, v, self.recons[r0], frame_num=fn,
                    poc_lsb=(2 * (disp - disp_base)) % max_lsb,
                    reorder_l0=reorder, qp=qp)
                fn_of[disp] = last_ref_fn = fn
                fn = (fn + 1) % max_fn
            else:
                # the pyramid QP ladder: QPBSlice at layer 1, +1 a layer
                # below; with rate control it rides the anchor QP
                base_b = (min(anchor_qp + 2, 51) if self.rc
                          else cfg.qp_bslice)
                qp = min(base_b + layer - 1, 51)
                is_ref = kind == "Bref"
                fin, recon = self.encode_b_frame(
                    y, u, v, self.recons[r0], self.recons[r1],
                    frame_num=fn, poc_lsb=(2 * (disp - disp_base)) % max_lsb,
                    is_ref=is_ref, col=col_of.get(r1), qp=qp)
                if is_ref:
                    fn_of[disp] = last_ref_fn = fn
                    fn = (fn + 1) % max_fn
            col_of[disp] = self._last_col
            self.recons[disp] = recon
            sse = sse3(self._dev_orig, recon)
            nalus = fin()
            out.extend(nalus)
            bits = sum(8 * len(b) for b in nalus)
            st = sse.tolist()
            if self.rc is not None:
                self.rc.update("B" if kind.startswith("B") else kind, bits,
                               float(st[3]) / y.size)
            ps = _psnr3(st, (y.size, u.size, v.size))
            stats[disp] = FrameStats(
                disp, "IDR" if kind == "I" else kind, bits, ps[0], ps[1],
                ps[2], time.monotonic() - t0, qp)
        self.stats.extend(st for st in stats if st is not None)
        return b"".join(out)

    def _queue(self, dev_out, mbd, qp: int, kind: str, hdr, nal_ref_idc,
               nal_type):
        """Queue a frame's entropy device work and its in-loop filter ->
        (finish, recon): `finish()` runs K1 (CABAC) or pulls the packed
        words and the skip map (CAVLC) and returns the frame's NAL
        units."""
        queued = queue_entropy(self.pic, mbd, kind, self.cabac,
                               self._cabac_cap, self._cap_words)
        recon = recon_planes(self._deblock, self.pic, dev_out, mbd, qp, kind)

        def finish():
            return entropy_nalus(self.pic, queued, qp, kind, self.cabac,
                                 self._cap_words, hdr, nal_ref_idc, nal_type)

        return finish, recon

    def _to_device(self, y, u, v):
        return tuple(torch.as_tensor(np.asarray(p), device=self.device)
                     for p in (y, u, v))

    def encode_intra_frame(self, y, u, v, frame_num: int = 0,
                           idr_pic_id: int = 0, qp: int | None = None,
                           poc_lsb: int = 0):
        """Queue one IDR frame's device work -> (finish, (recY, recU, recV)).

        `finish()` runs K1 (CABAC) or pulls the packed words (CAVLC) and
        returns the frame's NAL units; `encode_sequence` calls it after
        the next frame is queued."""
        cfg = self.cfg
        if qp is None:
            qp = cfg.qp
        self._dev_orig = self._to_device(y, u, v)
        dev_out, ys = self._encode_frame(*self._dev_orig, qp)

        def hdr_sink(s):
            return self._slice_header(
                s, SLICE_I, qp, frame_num=frame_num, idr_pic_id=idr_pic_id,
                pic_order_cnt_lsb=poc_lsb, is_idr=True)

        mbd = reorder_wave_outputs(self.sched, ys)
        if self.gop_mode == "bgop":
            # an all-intra picture never sets colZeroFlag (refIdxCol -1)
            zero = torch.zeros(cfg.width_mbs * cfg.height_mbs,
                               dtype=torch.bool, device=self.device)
            self._last_col = (zero, zero)
        return self._queue(dev_out, mbd, qp, "i", hdr_sink, 3, nal.NAL_IDR)

    @staticmethod
    def _estimate_wp(y, ref_y) -> tuple:
        """A P frame's explicit luma weight and offset (denominator 6):
        the least-squares gain and offset of the frame `y` against the
        reference recon `ref_y`, collapsed to (64, 0) near identity, as
        the reference's `_estimate_wp` computes them.  It runs in numpy on
        the host, on purpose: its float64 means and Python rounding (half
        to even) decide the integers, and a sum in another order could
        move one across a .5 and change every byte after it."""
        a = np.asarray(y).astype(np.float64)
        rf = (ref_y.cpu().numpy() if isinstance(ref_y, torch.Tensor)
              else np.asarray(ref_y)).astype(np.float64)
        var = rf.var()
        gain = 1.0 if var < 1e-3 else float(
            ((a - a.mean()) * (rf - rf.mean())).mean() / var)
        w = int(np.clip(round(gain * 64), 1, 127))
        o = int(np.clip(round(a.mean() - w * rf.mean() / 64.0), -128, 127))
        if abs(w - 64) < 2 and abs(o) < 2:
            return 64, 0
        return w, o

    def encode_p_frame(self, y, u, v, ref, frame_num: int,
                       qp: int | None = None, poc_lsb: int = 0,
                       reorder_l0: tuple = (), mmco: tuple = ()):
        """Queue one P frame's device work against `ref` = (y, u, v) recon
        planes -> (finish, recon).  `finish()` runs K1 (CABAC) or pulls the
        packed words and the skip map (CAVLC) and returns the frame's NAL
        units.  `reorder_l0` and `mmco` go into the slice header as given
        (a B GOP's P anchors after a reference B carry a reordering).
        With weighted prediction the frame's (weight, offset) is estimated
        first (`_estimate_wp`, which pulls the reference's luma to the
        host), kept in `_last_wp` and written into the slice header."""
        cfg = self.cfg
        if qp is None:
            qp = cfg.qp_inter
        self._dev_orig = self._to_device(y, u, v)
        ref = tuple(torch.as_tensor(p, device=self.device) for p in ref)
        wp, pred_weights = (), None
        self._last_wp = None
        if self.wp_mode:
            self._last_wp = wp = self._estimate_wp(y, ref[0])
            pred_weights = (6, 6, [(*wp, 64, 0, 64, 0)], [])
        dev_out, ys = self._encode_p(*self._dev_orig, *ref, qp, *wp)

        def hdr_sink(s):
            return self._slice_header(
                s, SLICE_P, qp, frame_num=frame_num,
                pic_order_cnt_lsb=poc_lsb, is_idr=False, nal_ref_idc=2,
                reorder_l0=reorder_l0, mmco=mmco, pred_weights=pred_weights)

        mbd = reorder_wave_outputs(self.sched, ys)
        if self.gop_mode == "bgop":
            self._last_col = colstate_of(mbd)
        return self._queue(dev_out, mbd, qp, "p", hdr_sink, 2, nal.NAL_SLICE)

    def encode_b_frame(self, y, u, v, ref0, ref1, frame_num: int,
                       poc_lsb: int, qp: int | None = None,
                       is_ref: bool = False, col=None):
        """Queue one B frame's device work against the (past, future)
        recon planes `ref0`, `ref1` -> (finish, recon), in-loop deblocked
        per the config with the two-list bS.  `col` = (colzero, colmixed)
        [n_mbs] bool: the colocated state of the list-1 reference
        (`colstate_of` of a P anchor; None: all false).  A reference B
        (`is_ref`, nal_ref_idc 2) weighs no partitions.  `finish()` runs
        K1 (CABAC) or pulls the packed words and the skip map (CAVLC) and
        returns the frame's NAL units."""
        cfg = self.cfg
        n_mbs = cfg.width_mbs * cfg.height_mbs
        if qp is None:
            qp = cfg.qp_inter
        if col is None:
            zero = torch.zeros(n_mbs, dtype=torch.bool, device=self.device)
            col = (zero, zero)
        self._dev_orig = self._to_device(y, u, v)
        refs = [torch.as_tensor(p, device=self.device)
                for p in (*ref0, *ref1)]
        dev_out, ys = self._encode_b(*self._dev_orig, *refs, *col, qp,
                                     allow_parts=not is_ref)
        nal_ref_idc = 2 if is_ref else 0

        def hdr_sink(s):
            return self._slice_header(
                s, SLICE_B, qp, frame_num=frame_num,
                pic_order_cnt_lsb=poc_lsb, is_idr=False,
                nal_ref_idc=nal_ref_idc)

        mbd = reorder_wave_outputs(self.sched, ys)
        if self.t8_mode:
            # B MBs code the 4x4 transform: the flag goes out as 0
            mbd["t8"] = torch.zeros(n_mbs, dtype=torch.bool,
                                    device=self.device)
        self._last_col = b_colstate(mbd)
        return self._queue(dev_out, mbd, qp, "b", hdr_sink, nal_ref_idc,
                           nal.NAL_SLICE)


def _pull_words(words, nbits_np) -> np.ndarray:
    """Device->host transfer of packed slice words [..., cap] (int32 from
    the card's KV, int64 from the plain version; 32 bits each), cut to the
    word count that covers the longest slice (the reference rounds that
    up to a power of two to bound its number of compiled slice
    programs; there are none here)."""
    need = (int(nbits_np.max()) + 31) // 32
    return words[..., :need].cpu().numpy().astype(np.uint32)
