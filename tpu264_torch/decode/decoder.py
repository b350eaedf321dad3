"""Scalar reference H.264 decoder, counterpart of `tpu264.decode.decoder`.

JM `ldecod` parity (SURVEY.md §3.2): Annex-B NALU parse → SPS/PPS
activation → slice header → serial CAVLC or CABAC macroblock parse →
reconstruction via the `tpu264_torch.ref` scalar oracles.  All of that is
numpy on the host, as in the reference: the macroblock loop is serial in
the bitstream.  The one picture-wide stage, the in-loop deblocking filter,
runs on the decoder's device (`Decoder(device=...)`, the CUDA card unless
the caller asks for the CPU): one launch of kernel K4 a macroblock wave,
with the picture's per-MB QPs and filter offsets (`_deblock_picture`).
Output equals the reference decoder's frame for frame.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.bits import nal
from tpu264_torch.bits.bitreader import BitReader
from tpu264_torch.bits.expgolomb import read_se, read_ue
from tpu264_torch.bits.params import PPS, SPS
from tpu264_torch.bits.slicehdr import SLICE_B, SLICE_I, SLICE_P, SliceHeader
from tpu264_torch.coding import mvpred
from tpu264_torch.coding.wavefront import BLK_ORDER, TR_UNAVAIL_IN_MB
from tpu264_torch.entropy import cavlc, mb_syntax
from tpu264_torch.kernels.deblock import make_deblocker, up4
from tpu264_torch.ref import interp as rip
from tpu264_torch.ref import intra as ri
from tpu264_torch.ref import transform as rt

REF_PAD = 24


class RefPic:
    """One DPB entry: reconstructed planes + interpolation pads on demand
    (JM `mbuffer.c` StorablePicture — SURVEY.md §2a #8)."""

    def __init__(self, y, u, v, frame_num: int, poc: int, uid: int = 0,
                 col_mv=None, col_ref=None, col_pid=None):
        self.y, self.u, self.v = y, u, v
        self.frame_num = frame_num
        self.poc = poc
        self.uid = uid            # unique picture id (deblock bS identity)
        self.short_term = True    # flips on MMCO long-term marking
        self.long_term_idx = -1
        # colocated motion for B direct derivation (spec 8.4.1.2.2):
        # per-4x4 mvCol / refIdxCol (intra blocks stored as 0 / 0)
        self.col_mv = col_mv
        self.col_ref = col_ref
        self.col_pid = col_pid    # uid of the picture the col block refs
        self._planes = None
        self._u_pad = None
        self._v_pad = None

    @property
    def planes(self):
        if self._planes is None:
            g_pad = rip.pad_plane(self.y, REF_PAD)
            self._planes = (g_pad,) + rip.half_pel_planes(g_pad)
        return self._planes

    @property
    def u_pad(self):
        if self._u_pad is None:
            self._u_pad = rip.pad_plane(self.u, REF_PAD // 2)
        return self._u_pad

    @property
    def v_pad(self):
        if self._v_pad is None:
            self._v_pad = rip.pad_plane(self.v, REF_PAD // 2)
        return self._v_pad


class PictureState:
    """Per-picture decoding state: planes, per-block maps, slice ids."""

    def __init__(self, sps: SPS):
        self.w, self.h = sps.width, sps.height
        self.wm, self.hm = sps.pic_width_in_mbs, sps.pic_height_in_map_units
        self.y = np.zeros((self.h, self.w), dtype=np.int64)
        self.u = np.zeros((self.h // 2, self.w // 2), dtype=np.int64)
        self.v = np.zeros((self.h // 2, self.w // 2), dtype=np.int64)
        # per-4x4 maps
        self.modes = np.full((self.hm * 4, self.wm * 4), -1, dtype=np.int64)
        self.luma_tc = np.zeros((self.hm * 4, self.wm * 4), dtype=np.int64)
        self.chroma_tc = np.zeros((2, self.hm * 2, self.wm * 2), dtype=np.int64)
        # slice id per MB (-1 = not yet decoded)
        self.slice_id = np.full((self.hm, self.wm), -1, dtype=np.int64)
        # transform_size_8x8_flag per MB (deblock: no internal 4x4 edges,
        # coeff condition per 8x8 block)
        self.t8 = np.zeros((self.hm, self.wm), dtype=bool)
        # deblock coefficient condition per 4x4 (== luma_tc for 4x4-
        # transform MBs; the 8x8 block's count replicated for t8 MBs)
        self.luma_tc_db = np.zeros((self.hm * 4, self.wm * 4),
                                   dtype=np.int64)
        self.deblock_idc = None    # uniform across the picture's slices
        self.db_off = None         # (FilterOffsetA, FilterOffsetB)
        self.qp = None
        # per-4x4-block motion state (qpel; ref: -2 unavail/undecoded,
        # -1 intra or not-using-this-list, >=0 inter ref idx); axis 0 is
        # the reference list (JM mv_info — SURVEY.md §2a #12)
        self.mv4 = np.zeros((2, self.hm * 4, self.wm * 4, 2),
                            dtype=np.int64)
        self.ref4 = np.full((2, self.hm * 4, self.wm * 4), mvpred.UNAVAIL,
                            dtype=np.int64)
        # per-list reference-PICTURE uid per 4x4 (-1 = list unused /
        # intra); feeds the two-list deblock bS (spec 8.7.2.1)
        self.pid4 = np.full((2, self.hm * 4, self.wm * 4), -1,
                            dtype=np.int64)
        self.n_decoded = 0
        self.cabac_state = None
        self.qp_mb = np.full((self.hm, self.wm), -1, dtype=np.int64)
        self.poc = 0
        self.frame_num = 0
        self.is_ref = True
        self.mmco = ()            # dec_ref_pic_marking ops (spec 8.2.5.4)
        self.lt_flag = 0          # IDR long_term_reference_flag

    def set_motion(self, lx, g4r, g4c, h4b, w4b, mv, ref, pid: int = -1):
        self.mv4[lx, g4r:g4r + h4b, g4c:g4c + w4b] = mv
        self.ref4[lx, g4r:g4r + h4b, g4c:g4c + w4b] = ref
        self.pid4[lx, g4r:g4r + h4b, g4c:g4c + w4b] = pid

    def set_intra_mb(self, mr, mc):
        self.mv4[:, mr * 4:mr * 4 + 4, mc * 4:mc * 4 + 4] = 0
        self.ref4[:, mr * 4:mr * 4 + 4, mc * 4:mc * 4 + 4] = mvpred.INTRA
        self.pid4[:, mr * 4:mr * 4 + 4, mc * 4:mc * 4 + 4] = -1


class Decoder:
    """`conceal=True` enables JM `erc_*`-style error concealment: slice
    parse failures are caught and the missing macroblocks synthesized
    (temporal zero-mv copy when a reference exists, spatial neighbor
    fill otherwise) instead of aborting the decode.  `device` is where
    the deblocking filter runs: the CUDA card when None (it raises
    without one), or "cpu" for its plain version."""

    def __init__(self, conceal: bool = False, trace=None,
                 device=None) -> None:
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Decoder: device {str(self.device)!r} asked for, but "
                "torch.cuda.is_available() is False; pass device=\"cpu\" "
                "to deblock with the plain torch version on the CPU")
        self.conceal = conceal
        self.errors: list[str] = []
        # syntax trace sink (JM TRACE parity): a file-like object that
        # receives one line per slice header / macroblock with the key
        # syntax values — diffable against another decoder's trace
        self.trace = trace
        self.sps: SPS | None = None
        self.pps: PPS | None = None
        # parsed SEI messages (Annex D) in stream order
        self.sei: list = []
        self.frames: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._out: list[tuple[int, int, int, tuple]] = []  # epoch, poc, seq
        self._pic: PictureState | None = None
        self._slice_counter = 0
        # DPB: short-term reference pictures in decode order (sliding
        # window marking, spec 8.2.5.3)
        self._dpb: list[RefPic] = []
        self._list0: list[RefPic] = []
        self._list1: list[RefPic] = []
        self._epoch = 0               # IDR count (POC restarts)
        self._seq = 0                 # decode-order tiebreak for poc ties
        self._next_uid = 0            # RefPic uid allocator
        # poc type 0 state (spec 8.2.1.1)
        self._prev_poc_msb = 0
        self._prev_poc_lsb = 0
        # poc type 1 state (spec 8.2.1.2)
        self._prev_frame_num_offset = 0
        self._prev_frame_num = 0

    # ------------------------------------------------------------- NAL

    def decode(self, stream: bytes):
        for ref_idc, ntype, rbsp in nal.split_annexb(stream):
            if ntype == nal.NAL_SPS:
                self.sps = SPS.parse_rbsp(rbsp)
                self._activate_scaling()
            elif ntype == nal.NAL_PPS:
                self.pps = PPS.parse_rbsp(rbsp, self.sps)
                self._activate_scaling()
            elif ntype in (nal.NAL_SLICE, nal.NAL_IDR):
                if self.conceal:
                    try:
                        self._decode_slice(rbsp, ntype, ref_idc)
                    except Exception as e:   # conceal the broken slice
                        self.errors.append(f"slice: {type(e).__name__}:"
                                           f" {e}")
                else:
                    self._decode_slice(rbsp, ntype, ref_idc)
            elif ntype == nal.NAL_SEI:
                from tpu264_torch.bits import sei as _sei
                self.sei.extend(_sei.parse_sei_rbsp(rbsp))
            elif ntype in (nal.NAL_AUD, nal.NAL_FILLER):
                continue
            else:
                raise NotImplementedError(f"nal_unit_type {ntype}")
        self._finish_picture()
        self._out.sort(key=lambda t: t[:3])       # output (display) order
        self.frames = [t[3] for t in self._out]
        return self.frames

    def _finish_picture(self):
        pic = self._pic
        if pic is not None and pic.n_decoded > 0:
            if pic.n_decoded != pic.wm * pic.hm:
                if not self.conceal:
                    raise ValueError(
                        f"picture incomplete: {pic.n_decoded}/"
                        f"{pic.wm * pic.hm} MBs")
                self._conceal_missing(pic)
            if pic.deblock_idc in (0, 2):
                self._deblock_picture(pic)
            planes = (pic.y.astype(np.uint8), pic.u.astype(np.uint8),
                      pic.v.astype(np.uint8))
            out_planes = planes
            if self.sps.crop is not None:
                # frame cropping applies to OUTPUT only (references stay
                # full-size); 4:2:0 frame: luma units = 2x chroma units
                cl, cr, ct, cb = self.sps.crop

                def cropped(p, s):
                    hh, ww = p.shape
                    return p[s * ct: hh - s * cb, s * cl: ww - s * cr]

                out_planes = (cropped(planes[0], 2),
                              cropped(planes[1], 1),
                              cropped(planes[2], 1))
            # poc type 2: output order == decode order (poc key = seq)
            key = self._seq if self.sps.pic_order_cnt_type == 2 else pic.poc
            self._out.append((self._epoch, key, self._seq, out_planes))
            self._seq += 1
            if pic.is_ref:
                # colocated motion (spec 8.4.1.2.2): list0 where used,
                # else list1; intra blocks -> mvCol = 0, refIdxCol = -1
                # (colZeroFlag is never set over intra colocated blocks)
                use0 = pic.ref4[0] >= 0
                use1 = pic.ref4[1] >= 0
                col_mv = np.where(use0[..., None], pic.mv4[0],
                                  np.where(use1[..., None], pic.mv4[1], 0))
                col_ref = np.where(use0, pic.ref4[0],
                                   np.where(use1, pic.ref4[1], -1))
                col_pid = np.where(use0, pic.pid4[0],
                                   np.where(use1, pic.pid4[1], -1))
                rp = RefPic(planes[0], planes[1], planes[2],
                            pic.frame_num, pic.poc, uid=self._next_uid,
                            col_mv=col_mv, col_ref=col_ref,
                            col_pid=col_pid)
                self._next_uid += 1
                self._mark_references(pic, rp)
        self._pic = None

    def _mark_references(self, pic, rp: RefPic):
        """dec_ref_pic_marking (spec 8.2.5): MMCO ops or sliding window."""
        max_fn = 1 << self.sps.log2_max_frame_num
        if pic.lt_flag:                    # IDR marked long-term
            rp.short_term = False
            rp.long_term_idx = 0
        if pic.mmco:
            for op in pic.mmco:
                if op[0] == 1:             # unmark a short-term ref
                    pic_num = (pic.frame_num - (op[1] + 1)) % max_fn
                    self._dpb = [r for r in self._dpb
                                 if not (r.short_term
                                         and r.frame_num % max_fn
                                         == pic_num)]
                elif op[0] == 2:           # unmark a long-term ref
                    self._dpb = [r for r in self._dpb
                                 if r.short_term
                                 or r.long_term_idx != op[1]]
                elif op[0] == 3:           # short-term -> long-term idx
                    pic_num = (pic.frame_num - (op[1] + 1)) % max_fn
                    self._dpb = [r for r in self._dpb
                                 if r.short_term
                                 or r.long_term_idx != op[2]]
                    for r in self._dpb:
                        if r.short_term and r.frame_num % max_fn \
                                == pic_num:
                            r.short_term = False
                            r.long_term_idx = op[2]
                elif op[0] == 4:           # MaxLongTermFrameIdx
                    self._dpb = [r for r in self._dpb
                                 if r.short_term
                                 or r.long_term_idx <= op[1] - 1]
                elif op[0] == 5:           # reset: unmark ALL refs
                    # spec 8.2.5.4.5: every reference unmarked; the
                    # current picture is inferred to have frame_num 0
                    # and its POC shifted so PicOrderCnt becomes 0
                    self._dpb.clear()
                    rp.frame_num = 0
                    rp.poc = 0
                elif op[0] == 6:           # current -> long-term idx
                    self._dpb = [r for r in self._dpb
                                 if r.short_term
                                 or r.long_term_idx != op[1]]
                    rp.short_term = False
                    rp.long_term_idx = op[1]
            self._dpb.append(rp)
            # capacity guard: a conforming stream's MMCO ops keep the DPB
            # within max_num_ref_frames; a hostile one (endless long-term
            # marks, no releases) must not grow it unboundedly
            while len(self._dpb) > max(1, self.sps.max_num_ref_frames):
                for i, r in enumerate(self._dpb[:-1]):
                    if r.short_term:
                        self._dpb.pop(i)
                        break
                else:
                    raise ValueError(
                        "DPB overflow: more long-term references than "
                        "max_num_ref_frames (non-conforming stream)")
        else:
            self._dpb.append(rp)
            # sliding window: evict the oldest SHORT-TERM ref
            while len(self._dpb) > max(1, self.sps.max_num_ref_frames):
                for i, r in enumerate(self._dpb):
                    if r.short_term:
                        self._dpb.pop(i)
                        break
                else:
                    break

    def _tr(self, msg: str) -> None:
        if self.trace is not None:
            self.trace.write(msg + "\n")

    def _trace_mb(self, pic, addr: int) -> None:
        """One trace line per decoded MB from the final picture state
        (mode, per-list ref/mv at the top-left cell, qp, coeff count)."""
        mr, mc = addr // pic.wm, addr % pic.wm
        g4r, g4c = mr * 4, mc * 4
        intra = (pic.ref4[0, g4r, g4c] == mvpred.INTRA
                 and pic.ref4[1, g4r, g4c] == mvpred.INTRA)
        parts = []
        for lx in (0, 1):
            if int(pic.ref4[lx, g4r, g4c]) >= 0:
                mv = pic.mv4[lx, g4r, g4c]
                parts.append(f"l{lx}=({int(pic.ref4[lx, g4r, g4c])},"
                             f"{int(mv[0])},{int(mv[1])})")
        tc = int(pic.luma_tc[g4r:g4r + 4, g4c:g4c + 4].sum())
        self._tr(f"MB {addr} ({mr},{mc}) {'I' if intra else 'P'}"
                 f" qp={int(pic.qp_mb[mr, mc])}"
                 f" t8={int(pic.t8[mr, mc])} tc={tc} "
                 + " ".join(parts))

    def _conceal_missing(self, pic):
        """Error concealment (JM `erc_do_i`/`erc_do_p` capability): MBs
        never decoded (lost/corrupt slices) are synthesized — temporal
        zero-mv copy from the most recent reference when one exists,
        else spatial fill from the row above (128 at the top)."""
        ref = self._dpb[-1] if self._dpb else None
        cid = -2                              # concealed-slice marker
        for mr in range(pic.hm):
            for mc in range(pic.wm):
                if pic.slice_id[mr, mc] >= 0:
                    continue
                y0, x0 = mr * 16, mc * 16
                c0, d0 = mr * 8, mc * 8
                if ref is not None:
                    pic.y[y0:y0 + 16, x0:x0 + 16] = \
                        ref.y[y0:y0 + 16, x0:x0 + 16]
                    pic.u[c0:c0 + 8, d0:d0 + 8] = \
                        ref.u[c0:c0 + 8, d0:d0 + 8]
                    pic.v[c0:c0 + 8, d0:d0 + 8] = \
                        ref.v[c0:c0 + 8, d0:d0 + 8]
                elif mr > 0:
                    pic.y[y0:y0 + 16, x0:x0 + 16] = pic.y[y0 - 1,
                                                          x0:x0 + 16]
                    pic.u[c0:c0 + 8, d0:d0 + 8] = pic.u[c0 - 1,
                                                        d0:d0 + 8]
                    pic.v[c0:c0 + 8, d0:d0 + 8] = pic.v[c0 - 1,
                                                        d0:d0 + 8]
                else:
                    pic.y[y0:y0 + 16, x0:x0 + 16] = 128
                    pic.u[c0:c0 + 8, d0:d0 + 8] = 128
                    pic.v[c0:c0 + 8, d0:d0 + 8] = 128
                pic.slice_id[mr, mc] = cid
                pic.set_intra_mb(mr, mc)
                pic.n_decoded += 1

    # --------------------------------------------------------- POC / lists

    def _compute_poc(self, hdr) -> int:
        """PicOrderCnt for poc type 0 (spec 8.2.1.1), type 1 (8.2.1.2)
        and type 2 (decode order proxy)."""
        if self.sps.pic_order_cnt_type == 1:
            return self._compute_poc1(hdr)
        if self.sps.pic_order_cnt_type != 0:
            return 0
        max_lsb = 1 << self.sps.log2_max_pic_order_cnt_lsb
        lsb = hdr.pic_order_cnt_lsb
        if hdr.is_idr:
            self._prev_poc_msb, self._prev_poc_lsb = 0, 0
        if lsb < self._prev_poc_lsb and \
                (self._prev_poc_lsb - lsb) >= max_lsb // 2:
            msb = self._prev_poc_msb + max_lsb
        elif lsb > self._prev_poc_lsb and \
                (lsb - self._prev_poc_lsb) > max_lsb // 2:
            msb = self._prev_poc_msb - max_lsb
        else:
            msb = self._prev_poc_msb
        if hdr.nal_ref_idc != 0:
            self._prev_poc_msb, self._prev_poc_lsb = msb, lsb
        return msb + lsb

    def _compute_poc1(self, hdr) -> int:
        """PicOrderCnt for poc type 1 (spec 8.2.1.2), frame pictures."""
        sps = self.sps
        max_fn = 1 << sps.log2_max_frame_num
        if hdr.is_idr:
            offset = 0
        elif self._prev_frame_num > hdr.frame_num:
            offset = self._prev_frame_num_offset + max_fn
        else:
            offset = self._prev_frame_num_offset
        self._prev_frame_num_offset = offset
        self._prev_frame_num = hdr.frame_num
        cycle = sps.offsets_for_ref_frame
        n_cycle = len(cycle)
        abs_fn = offset + hdr.frame_num if n_cycle else 0
        if hdr.nal_ref_idc == 0 and abs_fn > 0:
            abs_fn -= 1
        if abs_fn > 0:
            per_cycle = sum(cycle)
            cycles = (abs_fn - 1) // n_cycle
            in_cycle = (abs_fn - 1) % n_cycle
            expected = cycles * per_cycle + sum(cycle[:in_cycle + 1])
        else:
            expected = 0
        if hdr.nal_ref_idc == 0:
            expected += sps.offset_for_non_ref_pic
        return expected + hdr.delta_pic_order_cnt0

    def _build_ref_lists(self, hdr, poc: int):
        """Default reference list construction (spec 8.2.4.2: short-term
        ordering then long-term by LongTermPicNum) + modification
        commands (8.2.4.3, incl. long-term), truncated to
        num_ref_idx_active."""
        st = [r for r in self._dpb if r.short_term]
        lt = sorted((r for r in self._dpb if not r.short_term),
                    key=lambda r: r.long_term_idx)
        if hdr.slice_type == SLICE_P:
            # list0: descending FrameNumWrap == most recent decode order
            l0 = list(reversed(st)) + lt
            l1 = []
        else:
            past = sorted((r for r in st if r.poc <= poc),
                          key=lambda r: -r.poc)
            futr = sorted((r for r in st if r.poc > poc),
                          key=lambda r: r.poc)
            l0 = past + futr + lt
            l1 = futr + past + lt
            if len(l1) > 1 and l1 == l0:
                l1[0], l1[1] = l1[1], l1[0]
        max_pic = 1 << self.sps.log2_max_frame_num
        for lst, cmds in ((l0, hdr.reorder_l0), (l1, hdr.reorder_l1)):
            if not cmds:
                continue
            pred = hdr.frame_num
            idx = 0
            for idc, val in cmds:
                if idc == 2:               # long_term_pic_num
                    def match(rr, val=val):
                        return (not rr.short_term
                                and rr.long_term_idx == val)
                else:
                    pred = (pred - (val + 1)) % max_pic if idc == 0 \
                        else (pred + (val + 1)) % max_pic
                    def match(rr, pred=pred):
                        return (rr.short_term
                                and rr.frame_num % max_pic == pred)
                target = next(r for r in self._dpb if match(r))
                # spec 8-26/8-27: insert at idx, then drop LATER entries
                # of the same picture — commanding a picture twice
                # yields a genuine duplicate entry (x264 weightp dup
                # refs rely on this)
                lst.insert(idx, target)
                idx += 1
                j = idx
                while j < len(lst):
                    if match(lst[j]):
                        del lst[j]
                    else:
                        j += 1
        self._list0 = l0[:hdr.num_ref_idx_l0_active]
        self._list1 = l1[:hdr.num_ref_idx_l1_active]

    # ----------------------------------------------------------- slice

    def _decode_slice(self, rbsp: bytes, ntype: int, ref_idc: int):
        assert self.sps is not None and self.pps is not None
        r = BitReader(rbsp)
        hdr = SliceHeader.parse(r, self.sps, self.pps, ntype, ref_idc)
        if hdr.first_mb_in_slice == 0:
            self._finish_picture()
        if self._pic is None:
            if hdr.is_idr:
                self._epoch += 1
                self._dpb.clear()
            self._pic = PictureState(self.sps)
            self._pic.poc = self._compute_poc(hdr)
            self._pic.frame_num = hdr.frame_num
            self._pic.is_ref = hdr.nal_ref_idc != 0
            self._pic.mmco = hdr.mmco
            self._pic.lt_flag = (hdr.long_term_reference_flag
                                 if hdr.is_idr else 0)
        if hdr.slice_type in (SLICE_P, SLICE_B):
            self._build_ref_lists(hdr, self._pic.poc)
        # weighted prediction state for this slice (spec 8.4.2.3)
        self._wp = None
        self._wp_implicit = False
        if hdr.slice_type == SLICE_B \
                and self.pps.weighted_bipred_idc == 2:
            self._wp_implicit = True
        elif getattr(hdr, "pred_weights", None) is not None:
            self._wp = hdr.pred_weights
        if hdr.slice_type == SLICE_B:
            # direct mode flavor: spatial (flag 1, 8.4.1.2.2) or temporal
            # (flag 0, 8.4.1.2.3 via _direct_temporal_motion)
            self._direct_spatial = bool(
                getattr(hdr, "direct_spatial_mv_pred_flag", 0))
        self._slice_counter += 1
        sid = self._slice_counter
        pic = self._pic
        qp = hdr.slice_qp
        if self.trace is not None:
            self._tr(f"SLICE sid={sid} type={hdr.slice_type} "
                     f"first_mb={hdr.first_mb_in_slice} "
                     f"frame_num={hdr.frame_num} poc={pic.poc} qp={qp} "
                     f"idr={int(hdr.is_idr)} "
                     f"deblock_idc={hdr.disable_deblocking_filter_idc} "
                     f"nref=({hdr.num_ref_idx_l0_active},"
                     f"{hdr.num_ref_idx_l1_active}) "
                     f"mmco={list(hdr.mmco)}")
        idc = (hdr.disable_deblocking_filter_idc
               if self.pps.deblocking_filter_control_present_flag else 0)
        if pic.deblock_idc not in (None, idc):
            raise NotImplementedError(
                "mixed per-slice deblock idc within one picture")
        db_off = (2 * hdr.slice_alpha_c0_offset_div2,
                  2 * hdr.slice_beta_offset_div2)
        if getattr(pic, "db_off", None) not in (None, db_off):
            raise NotImplementedError(
                "mixed per-slice deblock alpha/beta offsets")
        pic.db_off = db_off
        pic.deblock_idc = idc
        pic.qp = qp
        addr = hdr.first_mb_in_slice
        n_mbs = pic.wm * pic.hm
        if self.pps.entropy_coding_mode_flag:
            self._decode_slice_cabac(r, rbsp, hdr, sid)
            return
        if hdr.slice_type == SLICE_I:
            while True:
                qp = self._decode_mb_i(r, pic, addr, qp, sid)
                if self.trace is not None:
                    self._trace_mb(pic, addr)
                addr += 1
                pic.n_decoded += 1
                if addr >= n_mbs or not r.more_rbsp_data():
                    break
        else:
            assert self._list0, "P/B slice without reference"
            is_b = hdr.slice_type == SLICE_B
            while addr < n_mbs and r.more_rbsp_data():
                run = read_ue(r)
                for _ in range(run):
                    if is_b:
                        self._decode_mb_b_direct(r, pic, addr, qp, sid,
                                                 skip=True)
                    else:
                        self._decode_mb_skip(pic, addr, sid, qp)
                    if self.trace is not None:
                        self._trace_mb(pic, addr)
                    addr += 1
                    pic.n_decoded += 1
                if addr >= n_mbs or not r.more_rbsp_data():
                    break
                if is_b:
                    qp = self._decode_mb_b(r, pic, addr, qp, sid)
                else:
                    qp = self._decode_mb_p(r, pic, addr, qp, sid)
                if self.trace is not None:
                    self._trace_mb(pic, addr)
                addr += 1
                pic.n_decoded += 1

    # ------------------------------------------------------ CABAC slices

    def _decode_slice_cabac(self, r, rbsp: bytes, hdr, sid: int):
        from tpu264_torch.decode.cabac_parse import CabacSliceParser
        from tpu264_torch.entropy import cabac_ctx as cs
        pic = self._pic
        if getattr(pic, "cabac_state", None) is None:
            pic.cabac_state = cs.CabacFrameState(pic.wm, pic.hm)
            pic.cabac_state.slice_id = pic.slice_id   # shared availability
        p_slice = hdr.slice_type == SLICE_P
        b_slice = hdr.slice_type == SLICE_B
        table = (1 + hdr.cabac_init_idc) if (p_slice or b_slice) else 0
        parser = CabacSliceParser(
            rbsp, r.pos, table, hdr.slice_qp, pic.cabac_state, sid,
            p_slice=p_slice, b_slice=b_slice,
            nref0=hdr.num_ref_idx_l0_active if (p_slice or b_slice) else 1,
            nref1=hdr.num_ref_idx_l1_active if b_slice else 1,
            t8_mode=bool(self.pps.transform_8x8_mode_flag),
            direct8=bool(self.sps.direct_8x8_inference_flag))
        dec = self

        class IntraCB:
            def mpm(self, gr, gc):
                return dec._mpm(pic, gr, gc, sid)

            def set(self, gr, gc, mode):
                pic.modes[gr, gc] = mode

            def set8(self, gr, gc, mode):
                pic.modes[gr:gr + 2, gc:gc + 2] = mode

        cb = IntraCB()
        addr = hdr.first_mb_in_slice
        n_mbs = pic.wm * pic.hm
        qp = hdr.slice_qp
        while True:
            mr, mc = addr // pic.wm, addr % pic.wm
            pic.slice_id[mr, mc] = sid
            if (p_slice or b_slice) and parser.mb_skip(mr, mc, b_slice):
                parser.note_skip(mr, mc)
                if b_slice:
                    self._decode_mb_b_direct(None, pic, addr, qp, sid,
                                             skip=True)
                else:
                    self._decode_mb_skip(pic, addr, sid, qp)
            else:
                mbv = parser.parse_mb(mr, mc, p_slice, cb,
                                      b_slice=b_slice)
                qp = qp + mbv["qp_delta"]
                self._recon_mb_cabac(pic, mr, mc, qp, mbv, sid,
                                     b_slice=b_slice)
                pic.qp_mb[mr, mc] = qp
            if self.trace is not None:
                self._trace_mb(pic, addr)
            pic.n_decoded += 1
            addr += 1
            if parser.end_of_slice():
                break
            if addr >= n_mbs:
                raise ValueError("CABAC slice overruns picture")

    def _recon_mb_cabac(self, pic, mr, mc, qp, mbv, sid,
                        b_slice: bool = False):
        at = self._avail_mb(pic, mr, mc, -1, 0, sid)
        al = self._avail_mb(pic, mr, mc, 0, -1, sid)
        atl = self._avail_mb(pic, mr, mc, -1, -1, sid)
        atr = self._avail_mb(pic, mr, mc, -1, 1, sid)

        if "pcm" in mbv:                 # I_PCM (spec 8.3.5)
            y16, u8, v8 = mbv["pcm"]
            pic.set_intra_mb(mr, mc)
            pic.y[mr * 16:mr * 16 + 16, mc * 16:mc * 16 + 16] = y16
            pic.u[mr * 8:mr * 8 + 8, mc * 8:mc * 8 + 8] = u8
            pic.v[mr * 8:mr * 8 + 8, mc * 8:mc * 8 + 8] = v8
            pic.luma_tc[mr * 4:mr * 4 + 4, mc * 4:mc * 4 + 4] = 16
            pic.luma_tc_db[mr * 4:mr * 4 + 4, mc * 4:mc * 4 + 4] = 16
            pic.chroma_tc[:, mr * 2:mr * 2 + 2, mc * 2:mc * 2 + 2] = 16
            return

        if mbv.get("direct"):
            preds = self._direct_mc_store(pic, mr, mc, sid)
            self._recon_inter_tail_vals(pic, mr, mc, qp, preds, mbv)
            return

        if mbv["inter"] and b_slice:
            preds = self._recon_b_motion_cabac(pic, mr, mc, mbv, sid)
            self._recon_inter_tail_vals(pic, mr, mc, qp, preds, mbv)
            return

        if mbv["inter"]:
            preds = self._recon_p_motion_cabac(pic, mr, mc, mbv, sid)
            self._recon_inter_tail_vals(pic, mr, mc, qp, preds, mbv)
            return

        self._check_bypass(qp)
        pic.set_intra_mb(mr, mc)
        if mbv["mb_type"] == 0 and "modes8" in mbv:   # Intra_8x8
            from tpu264_torch.ref import transform8 as rt8
            pic.t8[mr, mc] = True

            def res_cb(b8, coded):
                g2r = mr * 4 + (b8 // 2) * 2
                g2c = mc * 4 + (b8 % 2) * 2
                scanned = (mbv["luma8"][b8] if coded
                           else np.zeros(64, dtype=np.int64))
                cnt = int((scanned != 0).sum())
                pic.luma_tc[g2r:g2r + 2, g2c:g2c + 2] = cnt
                pic.luma_tc_db[g2r:g2r + 2, g2c:g2c + 2] = cnt
                coeff = np.zeros(64, dtype=np.int64)
                coeff[rt8.ZIGZAG_8x8] = scanned
                return coeff.reshape(8, 8)

            self._recon_i8(res_cb, pic, mr, mc, qp, mbv["modes8"],
                           mbv["cbp_luma"], at, al, atl, atr, sid)
        elif mbv["mb_type"] == 0:        # Intra_4x4
            modes = mbv["modes"]
            for idx, (by, bx) in enumerate(BLK_ORDER):
                gr, gc = mr * 4 + by, mc * 4 + bx
                scanned = mbv["luma4"][idx]
                pic.luma_tc[gr, gc] = (scanned != 0).sum()
                top8, left4, tl, b_at, b_al, b_atl = self._luma_neighbors(
                    pic, mr, mc, by, bx, at, al, atl, atr)
                pred = ri.predict_4x4(int(modes[idx]), top8, left4, tl,
                                      b_at, b_al, b_atl)
                coeff = np.zeros(16, dtype=np.int64)
                coeff[rt.ZIGZAG_4x4] = scanned
                res = rt.residual_block_recon(coeff.reshape(4, 4), qp, ws=self._ws4(0))
                y0, x0 = mr * 16 + by * 4, mc * 16 + bx * 4
                pic.y[y0:y0 + 4, x0:x0 + 4] = rt.clip1(pred + res)
        else:                            # Intra_16x16
            y0, x0 = mr * 16, mc * 16
            top = (pic.y[y0 - 1, x0:x0 + 16] if at
                   else np.zeros(16, dtype=np.int64))
            left = (pic.y[y0:y0 + 16, x0 - 1] if al
                    else np.zeros(16, dtype=np.int64))
            tl = int(pic.y[y0 - 1, x0 - 1]) if atl else 0
            pred = ri.predict_16x16(mbv["i16mode"], top, left, tl,
                                    at, al, atl)
            dc = np.zeros(16, dtype=np.int64)
            dc[rt.ZIGZAG_4x4] = mbv["luma_dc"]
            dc_deq = rt.hadamard4x4_inv_dequant_dc(dc.reshape(4, 4), qp,
                                                   w00=self._w00(0))
            recon = np.zeros((16, 16), dtype=np.int64)
            for idx, (by, bx) in enumerate(BLK_ORDER):
                ac = mbv["luma_ac15"][idx]
                pic.luma_tc[mr * 4 + by, mc * 4 + bx] = (ac != 0).sum()
                coeff = np.zeros(16, dtype=np.int64)
                coeff[rt.ZIGZAG_4x4[1:]] = ac
                res = rt.residual_block_recon(coeff.reshape(4, 4), qp, ws=self._ws4(0),
                                              dc=int(dc_deq[by, bx]))
                recon[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = res
            pic.y[y0:y0 + 16, x0:x0 + 16] = rt.clip1(pred + recon)

        # chroma (intra)
        cqp = rt.chroma_qp(qp, self.pps.chroma_qp_index_offset)
        y0, x0 = mr * 8, mc * 8
        planes = (pic.u, pic.v)
        for comp in range(2):
            plane = planes[comp]
            top = (plane[y0 - 1, x0:x0 + 8] if at
                   else np.zeros(8, dtype=np.int64))
            left = (plane[y0:y0 + 8, x0 - 1] if al
                    else np.zeros(8, dtype=np.int64))
            tl = int(plane[y0 - 1, x0 - 1]) if atl else 0
            pred = ri.predict_chroma8x8(mbv["cmode"], top, left, tl,
                                        at, al, atl)
            plane[y0:y0 + 8, x0:x0 + 8] = self._chroma_comp_recon(
                pic, mr, mc, cqp, mbv, comp, pred, intra=True)

    def _chroma_comp_recon(self, pic, mr, mc, cqp, mbv, comp, pred,
                           intra: bool = False):
        lidx = (1 if intra else 4) + comp
        dc_deq = rt.hadamard2x2_inv_dequant_dc(
            mbv["chroma_dc"][comp].reshape(2, 2), cqp,
            w00=self._w00(lidx))
        recon = np.zeros((8, 8), dtype=np.int64)
        for idx in range(4):
            by, bx = idx // 2, idx % 2
            ac = mbv["chroma_ac"][comp, idx]
            pic.chroma_tc[comp, mr * 2 + by, mc * 2 + bx] = (ac != 0).sum()
            coeff = np.zeros(16, dtype=np.int64)
            coeff[rt.ZIGZAG_4x4[1:]] = ac
            recon[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = \
                rt.residual_block_recon(coeff.reshape(4, 4), cqp,
                                        dc=int(dc_deq[by, bx]),
                                        ws=self._ws4(lidx))
        return rt.clip1(pred + recon)

    def _recon_chroma_vals(self, pic, mr, mc, qp, mbv, preds):
        cqp = rt.chroma_qp(qp, self.pps.chroma_qp_index_offset)
        y0, x0 = mr * 8, mc * 8
        planes = (pic.u, pic.v)
        for comp in range(2):
            planes[comp][y0:y0 + 8, x0:x0 + 8] = self._chroma_comp_recon(
                pic, mr, mc, cqp, mbv, comp, preds[comp])

    def _recon_inter_tail_vals(self, pic, mr, mc, qp, preds, mbv):
        """Inter-MB residual add from parsed values (CABAC twin of
        _parse_inter_residual): 4x4 or 8x8-transform luma + chroma."""
        self._check_bypass(qp)
        pred_y, pred_u, pred_v = preds
        recon = np.zeros((16, 16), dtype=np.int64)
        if mbv.get("t8"):
            from tpu264_torch.ref import transform8 as rt8
            pic.t8[mr, mc] = True
            for b8 in range(4):
                by, bx = b8 // 2, b8 % 2
                scanned = mbv["luma8"][b8]
                cnt = int((scanned != 0).sum())
                g2r, g2c = mr * 4 + by * 2, mc * 4 + bx * 2
                pic.luma_tc[g2r:g2r + 2, g2c:g2c + 2] = cnt
                pic.luma_tc_db[g2r:g2r + 2, g2c:g2c + 2] = cnt
                coeff = np.zeros(64, dtype=np.int64)
                coeff[rt8.ZIGZAG_8x8] = scanned
                recon[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] = rt8.idct8x8(
                    rt8.dequant8x8(coeff.reshape(8, 8), qp,
                                   ws=self._ws8(1)))
        else:
            for idx, (by, bx) in enumerate(BLK_ORDER):
                scanned = mbv["luma4"][idx]
                pic.luma_tc[mr * 4 + by, mc * 4 + bx] = (scanned != 0).sum()
                coeff = np.zeros(16, dtype=np.int64)
                coeff[rt.ZIGZAG_4x4] = scanned
                recon[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = \
                    rt.residual_block_recon(coeff.reshape(4, 4), qp,
                                            ws=self._ws4(3))
        pic.y[mr * 16:mr * 16 + 16, mc * 16:mc * 16 + 16] = \
            rt.clip1(pred_y + recon)
        self._recon_chroma_vals(pic, mr, mc, qp, mbv, (pred_u, pred_v))

    def _recon_p_motion_cabac(self, pic, mr, mc, mbv, sid):
        """P-MB motion from parsed CABAC values (16x16/16x8/8x16 +
        P_8x8 sub tree) → stored motion + weighted MC prediction."""
        g4r, g4c = mr * 4, mc * 4
        pic.set_motion(1, g4r, g4c, 4, 4, 0, mvpred.INTRA)
        pred_y = np.zeros((16, 16), dtype=np.int64)
        pred_u = np.zeros((8, 8), dtype=np.int64)
        pred_v = np.zeros((8, 8), dtype=np.int64)

        def mc_into(dr4, dc4, h4b, w4b, mv, ref_idx):
            py, pu, pv = self._weight_uni(self._mc_part(
                pic, mr * 16 + dr4 * 4, mc * 16 + dc4 * 4,
                h4b * 4, w4b * 4, mv, self._list0[ref_idx]), 0, ref_idx)
            pred_y[dr4 * 4:(dr4 + h4b) * 4, dc4 * 4:(dc4 + w4b) * 4] = py
            pred_u[dr4 * 2:(dr4 + h4b) * 2, dc4 * 2:(dc4 + w4b) * 2] = pu
            pred_v[dr4 * 2:(dr4 + h4b) * 2, dc4 * 2:(dc4 + w4b) * 2] = pv

        ptype = mbv["ptype"]
        refs, mvds = mbv["refs"], mbv["mvds"]
        if ptype in (0, 1, 2):
            for (dr4, dc4, h4b, w4b), ref_idx, (mvd_y, mvd_x) in zip(
                    self._P_PARTS[ptype], refs, mvds):
                pred = self._mv_pred_part(pic, 0, ref_idx, g4r + dr4,
                                          g4c + dc4, h4b, w4b, sid)
                mv = pred + np.array([mvd_y, mvd_x], dtype=np.int64)
                pic.set_motion(0, g4r + dr4, g4c + dc4, h4b, w4b, mv,
                               ref_idx, pid=self._list0[ref_idx].uid)
                mc_into(dr4, dc4, h4b, w4b, mv, ref_idx)
        else:                            # P_8x8 / P_8x8ref0
            subs = mbv["subs"]
            for b8 in range(4):
                br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                for (dr4, dc4, h4b, w4b), (mvd_y, mvd_x) in zip(
                        self._SUB_PARTS[subs[b8]], mvds[b8]):
                    pred = self._mv_pred_part(
                        pic, 0, refs[b8], g4r + br4 + dr4,
                        g4c + bc4 + dc4, h4b, w4b, sid)
                    mv = pred + np.array([mvd_y, mvd_x], dtype=np.int64)
                    pic.set_motion(0, g4r + br4 + dr4, g4c + bc4 + dc4,
                                   h4b, w4b, mv, refs[b8],
                                   pid=self._list0[refs[b8]].uid)
                    mc_into(br4 + dr4, bc4 + dc4, h4b, w4b, mv, refs[b8])
        return pred_y, pred_u, pred_v

    def _recon_b_motion_cabac(self, pic, mr, mc, mbv, sid):
        """B-MB motion from parsed CABAC values (16x16 / two-partition /
        B_8x8 sub tree incl. B_Direct_8x8)."""
        g4r, g4c = mr * 4, mc * 4
        btype = mbv["btype"]
        if btype <= 3:                   # one 16x16 partition
            refs = mbv.get("refs", [0, 0])
            preds = []
            used = []
            for lx, use in ((0, mbv["use0"]), (1, mbv["use1"])):
                if not use:
                    pic.set_motion(lx, g4r, g4c, 4, 4, 0, mvpred.INTRA)
                    continue
                mvd_y, mvd_x = mbv[f"mvd{lx}"]
                pred = self._mv_pred_part(pic, lx, refs[lx], g4r, g4c,
                                          4, 4, sid)
                mv = pred + np.array([mvd_y, mvd_x], dtype=np.int64)
                reflist = self._list0 if lx == 0 else self._list1
                pic.set_motion(lx, g4r, g4c, 4, 4, mv, refs[lx],
                               pid=reflist[refs[lx]].uid)
                preds.append(self._mc_recon(pic, mr, mc, mv,
                                            reflist[refs[lx]]))
                used.append(lx)
            if len(preds) == 2:
                return self._weight_bi(preds[0], refs[0],
                                       preds[1], refs[1])
            lx = used[0]
            return self._weight_uni(preds[0], lx, refs[lx])

        pred_y = np.zeros((16, 16), dtype=np.int64)
        pred_u = np.zeros((8, 8), dtype=np.int64)
        pred_v = np.zeros((8, 8), dtype=np.int64)

        def put(dr4, dc4, h4b, w4b, planes):
            py, pu, pv = planes
            pred_y[dr4 * 4:(dr4 + h4b) * 4, dc4 * 4:(dc4 + w4b) * 4] = py
            pred_u[dr4 * 2:(dr4 + h4b) * 2, dc4 * 2:(dc4 + w4b) * 2] = pu
            pred_v[dr4 * 2:(dr4 + h4b) * 2, dc4 * 2:(dc4 + w4b) * 2] = pv

        if btype <= 21:                  # two-partition 16x8 / 8x16
            part_uses = mbv["part_pred"]
            geom = (self._P_PARTS[1] if btype % 2 == 0
                    else self._P_PARTS[2])
            refs, mvds = mbv["refs"], mbv["mvds"]
            for p, (dr4, dc4, h4b, w4b) in enumerate(geom):
                for lx in (0, 1):
                    if not part_uses[p][lx]:
                        pic.set_motion(lx, g4r + dr4, g4c + dc4, h4b,
                                       w4b, 0, mvpred.INTRA)
            mvs = [[None, None], [None, None]]
            for lx in (0, 1):
                for p, (dr4, dc4, h4b, w4b) in enumerate(geom):
                    if not part_uses[p][lx]:
                        continue
                    mvd_y, mvd_x = mvds[lx][p]
                    pred = self._mv_pred_part(pic, lx, refs[lx][p],
                                              g4r + dr4, g4c + dc4,
                                              h4b, w4b, sid)
                    mvs[lx][p] = pred + np.array([mvd_y, mvd_x],
                                                 dtype=np.int64)
                    lst = self._list0 if lx == 0 else self._list1
                    pic.set_motion(lx, g4r + dr4, g4c + dc4, h4b, w4b,
                                   mvs[lx][p], refs[lx][p],
                                   pid=lst[refs[lx][p]].uid)
            for p, (dr4, dc4, h4b, w4b) in enumerate(geom):
                put(dr4, dc4, h4b, w4b, self._b_mc_part(
                    pic, mr * 16 + dr4 * 4, mc * 16 + dc4 * 4,
                    h4b * 4, w4b * 4,
                    [mvs[0][p], mvs[1][p]], [refs[0][p], refs[1][p]],
                    part_uses[p]))
            return pred_y, pred_u, pred_v

        # B_8x8: direct subs stored first (derivation order, 8.4.1)
        subs = mbv["subs"]
        refs, mvds = mbv["refs"], mbv["mvds"]
        direct = None
        if any(s == 0 for s in subs):
            direct = self._direct_motion(pic, mr, mc, sid)
            for b8 in range(4):
                if subs[b8] != 0:
                    continue
                r0d, r1d, dmv0, dmv1 = direct[b8]
                br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                for lx, ri, mv in ((0, r0d, dmv0), (1, r1d, dmv1)):
                    lst = self._list0 if lx == 0 else self._list1
                    if ri >= 0:
                        pic.set_motion(lx, g4r + br4, g4c + bc4, 2, 2,
                                       mv, ri, pid=lst[ri].uid)
                    else:
                        pic.set_motion(lx, g4r + br4, g4c + bc4, 2, 2,
                                       0, mvpred.INTRA)
        for b8 in range(4):
            if subs[b8] == 0:
                continue
            for lx in (0, 1):
                if not self._B_SUB[subs[b8]][0][lx]:
                    br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                    pic.set_motion(lx, g4r + br4, g4c + bc4, 2, 2,
                                   0, mvpred.INTRA)
        mvs = [[[] for _ in range(4)], [[] for _ in range(4)]]
        for lx in (0, 1):
            for b8 in range(4):
                if subs[b8] == 0:
                    continue
                uses, gkey = self._B_SUB[subs[b8]]
                if not uses[lx]:
                    continue
                br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                lst = self._list0 if lx == 0 else self._list1
                for (dr4, dc4, h4b, w4b), (mvd_y, mvd_x) in zip(
                        self._SUB_PARTS[gkey], mvds[lx][b8]):
                    pred = self._mv_pred_part(
                        pic, lx, refs[lx][b8], g4r + br4 + dr4,
                        g4c + bc4 + dc4, h4b, w4b, sid)
                    mv = pred + np.array([mvd_y, mvd_x], dtype=np.int64)
                    mvs[lx][b8].append(mv)
                    pic.set_motion(lx, g4r + br4 + dr4, g4c + bc4 + dc4,
                                   h4b, w4b, mv, refs[lx][b8],
                                   pid=lst[refs[lx][b8]].uid)
        for b8 in range(4):
            br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
            if subs[b8] == 0:            # B_Direct_8x8
                r0, r1, dmv0, dmv1 = direct[b8]
                parts = []
                for lx, ri, mv in ((0, r0, dmv0), (1, r1, dmv1)):
                    lst = self._list0 if lx == 0 else self._list1
                    if ri >= 0:
                        pic.set_motion(lx, g4r + br4, g4c + bc4, 2, 2,
                                       mv, ri, pid=lst[ri].uid)
                        parts.append((lx, ri, self._mc_part(
                            pic, mr * 16 + br4 * 4, mc * 16 + bc4 * 4,
                            8, 8, mv, lst[ri])))
                    else:
                        pic.set_motion(lx, g4r + br4, g4c + bc4, 2, 2,
                                       0, mvpred.INTRA)
                if len(parts) == 2:
                    planes = self._weight_bi(parts[0][2], parts[0][1],
                                             parts[1][2], parts[1][1])
                else:
                    lx, ri, pl = parts[0]
                    planes = self._weight_uni(pl, lx, ri)
                put(br4, bc4, 2, 2, planes)
                continue
            uses, gkey = self._B_SUB[subs[b8]]
            for pi, (dr4, dc4, h4b, w4b) in enumerate(
                    self._SUB_PARTS[gkey]):
                put(br4 + dr4, bc4 + dc4, h4b, w4b, self._b_mc_part(
                    pic, mr * 16 + (br4 + dr4) * 4,
                    mc * 16 + (bc4 + dc4) * 4, h4b * 4, w4b * 4,
                    [mvs[0][b8][pi] if uses[0] else None,
                     mvs[1][b8][pi] if uses[1] else None],
                    [refs[0][b8], refs[1][b8]], uses))
        return pred_y, pred_u, pred_v

    # ------------------------------------------------------ macroblock

    def _avail_mb(self, pic, mr, mc, dr, dc, sid):
        """Neighbor MB availability: exists and in the same slice."""
        r, c = mr + dr, mc + dc
        if r < 0 or c < 0 or r >= pic.hm or c >= pic.wm:
            return False
        return pic.slice_id[r, c] == sid

    def _activate_scaling(self):
        """Effective weightScale lists (spec 8.5.9): PPS matrices win
        over SPS matrices; both absent = flat (fast dequant paths)."""
        self._w4 = self._w8 = None
        for ps in (self.sps, self.pps):
            if ps is not None and getattr(ps, "scaling_w4", None) is not None:
                self._w4 = ps.scaling_w4
                self._w8 = ps.scaling_w8

    def _ws4(self, i):
        return None if getattr(self, "_w4", None) is None else self._w4[i]

    def _ws8(self, i):
        return None if getattr(self, "_w8", None) is None else self._w8[i]

    def _w00(self, i):
        w = self._ws4(i)
        return 16 if w is None else int(w[0, 0])

    def _check_bypass(self, qp: int):
        """Lossless transform-bypass MBs (High 4:4:4 Predictive with
        QP'Y == 0, spec 8.5.15 — what x264 emits at qp 0) are not
        reconstructed; fail loudly instead of producing wrong pixels."""
        if qp == 0 and getattr(self.sps,
                               "qpprime_y_zero_transform_bypass_flag", 0):
            raise NotImplementedError(
                "transform bypass (lossless, QP'Y=0) not supported")

    def _decode_mb_i(self, r: BitReader, pic: PictureState, addr: int,
                     qp: int, sid: int, mb_type: int | None = None):
        mr, mc = addr // pic.wm, addr % pic.wm
        pic.slice_id[mr, mc] = sid
        pic.set_intra_mb(mr, mc)
        at = self._avail_mb(pic, mr, mc, -1, 0, sid)
        al = self._avail_mb(pic, mr, mc, 0, -1, sid)
        atl = self._avail_mb(pic, mr, mc, -1, -1, sid)
        atr = self._avail_mb(pic, mr, mc, -1, 1, sid)

        if mb_type is None:
            mb_type = read_ue(r)
        if mb_type != 25:
            self._check_bypass(qp)
        if mb_type == 25:              # I_PCM (spec 7.3.5, 8.3.5)
            r.align_byte()
            y0, x0 = mr * 16, mc * 16
            pic.y[y0:y0 + 16, x0:x0 + 16] = np.array(
                [r.read(8) for _ in range(256)]).reshape(16, 16)
            c0r, c0c = mr * 8, mc * 8
            for plane in (pic.u, pic.v):
                plane[c0r:c0r + 8, c0c:c0c + 8] = np.array(
                    [r.read(8) for _ in range(64)]).reshape(8, 8)
            # nC counts as 16 for neighbor derivation (spec 9.2.1)
            pic.luma_tc[mr * 4:mr * 4 + 4, mc * 4:mc * 4 + 4] = 16
            pic.chroma_tc[:, mr * 2:mr * 2 + 2, mc * 2:mc * 2 + 2] = 16
            pic.qp_mb[mr, mc] = qp
            return qp
        if mb_type > 25:
            raise ValueError(f"bad I mb_type {mb_type}")

        if mb_type == 0:     # Intra_4x4 / Intra_8x8 (I_NxN)
            t8 = 0
            if self.pps.transform_8x8_mode_flag:
                t8 = r.read(1)                # transform_size_8x8_flag
            if t8:
                pic.t8[mr, mc] = True
                modes = self._parse_i8_modes(r, pic, mr, mc, sid)
                cmode = read_ue(r)
                cbp = int(mb_syntax.CODENUM_TO_CBP_INTRA[read_ue(r)])
                cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
                if cbp > 0:
                    qp = qp + read_se(r)      # mb_qp_delta
                self._recon_i8(
                    lambda b8, coded: self._read_luma8x8_cavlc(
                        r, pic, mr, mc, b8, sid, coded),
                    pic, mr, mc, qp, modes, cbp_luma,
                    at, al, atl, atr, sid)
                self._recon_chroma(r, pic, mr, mc, qp, cmode, cbp_chroma,
                                   at, al, atl)
                pic.qp_mb[mr, mc] = qp
                return qp
            modes = self._parse_i4_modes(r, pic, mr, mc, sid)
            cmode = read_ue(r)
            cbp = int(mb_syntax.CODENUM_TO_CBP_INTRA[read_ue(r)])
            cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
            if cbp > 0:
                qp = qp + read_se(r)          # mb_qp_delta
            self._recon_i4(r, pic, mr, mc, qp, modes, cbp_luma,
                           at, al, atl, atr, sid)
        else:                # Intra_16x16
            t = mb_type - 1
            i16mode = t % 4
            cbp_chroma = (t // 4) % 3
            cbp_luma = 15 if t >= 12 else 0
            cmode = read_ue(r)
            qp = qp + read_se(r)              # mb_qp_delta (always present)
            self._recon_i16(r, pic, mr, mc, qp, i16mode, cbp_luma,
                            at, al, atl)
        self._recon_chroma(r, pic, mr, mc, qp, cmode, cbp_chroma, at, al, atl)
        pic.qp_mb[mr, mc] = qp
        return qp

    # ------------------------------------------------- syntax helpers

    def _parse_i4_modes(self, r, pic, mr, mc, sid):
        modes = np.zeros(16, dtype=np.int64)
        for idx, (by, bx) in enumerate(BLK_ORDER):
            gr, gc = mr * 4 + by, mc * 4 + bx
            pm = self._mpm(pic, gr, gc, sid)
            if r.read(1):
                m = pm
            else:
                rem = r.read(3)
                m = rem + (rem >= pm)
            modes[idx] = m
            pic.modes[gr, gc] = m
        return modes

    def _parse_i8_modes(self, r, pic, mr, mc, sid):
        """rem_intra8x8_pred_mode for the 4 8x8 blocks; each block's mode
        fills its 4 4x4 mode cells (neighbor MPM derivation then works
        at 4x4 granularity for both i4 and i8 neighbors, spec 8.3.2.1)."""
        modes = np.zeros(4, dtype=np.int64)
        for b8 in range(4):
            gr = mr * 4 + (b8 // 2) * 2
            gc = mc * 4 + (b8 % 2) * 2
            pm = self._mpm(pic, gr, gc, sid)
            if r.read(1):
                m = pm
            else:
                rem = r.read(3)
                m = rem + (rem >= pm)
            modes[b8] = m
            pic.modes[gr:gr + 2, gc:gc + 2] = m
        return modes

    def _read_luma8x8_cavlc(self, r, pic, mr, mc, b8, sid, coded):
        """One 8x8 luma residual: 4 interleaved CAVLC 4x4 blocks
        (coefficient k of sub-block i -> 8x8 scan position 4k + i,
        spec 7.4.5.3.3); returns the dequantized coeff array positions
        filled in raster [8, 8] scan-domain."""
        from tpu264_torch.ref import transform8 as rt8
        scan64 = np.zeros(64, dtype=np.int64)
        counts = 0
        for i in range(4):
            idx = b8 * 4 + i
            by, bx = BLK_ORDER[idx]
            gr, gc = mr * 4 + by, mc * 4 + bx
            if coded:
                ncv = self._nc_luma(pic, gr, gc, sid)
                sub = cavlc.decode_block(r, ncv, 16)
                pic.luma_tc[gr, gc] = (sub != 0).sum()
                counts += int((sub != 0).sum())
                scan64[4 * np.arange(16) + i] = sub
            else:
                pic.luma_tc[gr, gc] = 0
        g2r, g2c = mr * 4 + (b8 // 2) * 2, mc * 4 + (b8 % 2) * 2
        pic.luma_tc_db[g2r:g2r + 2, g2c:g2c + 2] = counts
        coeff = np.zeros(64, dtype=np.int64)
        coeff[rt8.ZIGZAG_8x8] = scan64
        return coeff.reshape(8, 8)

    def _recon_i8(self, residual_cb, pic, mr, mc, qp, modes, cbp_luma,
                  at, al, atl, atr, sid):
        """Intra_8x8 luma reconstruction (spec 8.3.2 + 8.5.13);
        residual_cb(b8, coded) yields the 8x8 dequant-input coeff
        array (entropy-mode specific)."""
        from tpu264_torch.ref import transform8 as rt8
        for b8 in range(4):
            by, bx = b8 // 2, b8 % 2
            y0, x0 = mr * 16 + by * 8, mc * 16 + bx * 8
            # per-8x8 neighbor availability inside the MB
            b_at = at if by == 0 else True
            b_al = al if bx == 0 else True
            b_atl = (atl, at, al, True)[b8]
            b_atr = (at, atr, True, False)[b8]
            top16 = np.zeros(16, dtype=np.int64)
            left8 = np.zeros(8, dtype=np.int64)
            tl = 0
            if b_at:
                top16[0:8] = pic.y[y0 - 1, x0:x0 + 8]
                if b_atr:
                    top16[8:16] = pic.y[y0 - 1, x0 + 8:x0 + 16]
                else:
                    top16[8:16] = top16[7]
            if b_al:
                left8[:] = pic.y[y0:y0 + 8, x0 - 1]
            if b_atl:
                tl = int(pic.y[y0 - 1, x0 - 1])
            pred = ri.predict_8x8(int(modes[b8]), top16, left8, tl,
                                  b_at, b_al, b_atl)
            coded = (cbp_luma >> b8) & 1
            d = residual_cb(b8, coded)
            res = rt8.idct8x8(rt8.dequant8x8(d, qp, ws=self._ws8(0)))
            pic.y[y0:y0 + 8, x0:x0 + 8] = rt.clip1(pred + res)

    def _mpm(self, pic, gr, gc, sid):
        """spec 8.3.1.1: either neighbor unavailable → DC; available
        non-Intra_4x4 neighbor counts as DC on its side."""
        def side(r_, c_):
            if r_ < 0 or c_ < 0:
                return -1                  # unavailable
            if pic.slice_id[r_ // 4, c_ // 4] != sid:
                return -1
            m = pic.modes[r_, c_]
            return 2 if m < 0 else int(m)
        a, b = side(gr, gc - 1), side(gr - 1, gc)
        return 2 if min(a, b) < 0 else min(a, b)

    def _nc_luma(self, pic, gr, gc, sid):
        na = nb = None
        if gc > 0 and pic.slice_id[gr // 4, (gc - 1) // 4] == sid:
            na = int(pic.luma_tc[gr, gc - 1])
        if gr > 0 and pic.slice_id[(gr - 1) // 4, gc // 4] == sid:
            nb = int(pic.luma_tc[gr - 1, gc])
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    def _nc_chroma(self, pic, comp, gr, gc, sid):
        na = nb = None
        if gc > 0 and pic.slice_id[gr // 2, (gc - 1) // 2] == sid:
            na = int(pic.chroma_tc[comp, gr, gc - 1])
        if gr > 0 and pic.slice_id[(gr - 1) // 2, gc // 2] == sid:
            nb = int(pic.chroma_tc[comp, gr - 1, gc])
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    # ------------------------------------------------- reconstruction

    def _luma_neighbors(self, pic, mr, mc, by, bx, at, al, atl, atr):
        """Assemble (top8, left4, tl, avail flags) for a 4x4 luma block."""
        y0, x0 = mr * 16 + by * 4, mc * 16 + bx * 4
        idx = BLK_ORDER.index((by, bx))
        b_at = at if by == 0 else True
        b_al = al if bx == 0 else True
        if by == 0 and bx == 0:
            b_atl = atl
        elif by == 0:
            b_atl = at
        elif bx == 0:
            b_atl = al
        else:
            b_atl = True
        if by == 0:
            b_atr = atr if bx == 3 else at
        else:
            b_atr = idx not in TR_UNAVAIL_IN_MB
        top8 = np.zeros(8, dtype=np.int64)
        left4 = np.zeros(4, dtype=np.int64)
        tl = 0
        if b_at:
            top8[0:4] = pic.y[y0 - 1, x0:x0 + 4]
            if b_atr:
                top8[4:8] = pic.y[y0 - 1, x0 + 4:x0 + 8]
            else:
                top8[4:8] = top8[3]
        if b_al:
            left4[:] = pic.y[y0:y0 + 4, x0 - 1]
        if b_atl:
            tl = int(pic.y[y0 - 1, x0 - 1])
        return top8, left4, tl, b_at, b_al, b_atl

    def _recon_i4(self, r, pic, mr, mc, qp, modes, cbp_luma,
                  at, al, atl, atr, sid):
        for idx, (by, bx) in enumerate(BLK_ORDER):
            gr, gc = mr * 4 + by, mc * 4 + bx
            coded = (cbp_luma >> (idx // 4)) & 1
            if coded:
                ncv = self._nc_luma(pic, gr, gc, sid)
                scanned = cavlc.decode_block(r, ncv, 16)
                pic.luma_tc[gr, gc] = (scanned != 0).sum()
            else:
                scanned = np.zeros(16, dtype=np.int64)
                pic.luma_tc[gr, gc] = 0
            top8, left4, tl, b_at, b_al, b_atl = self._luma_neighbors(
                pic, mr, mc, by, bx, at, al, atl, atr)
            pred = ri.predict_4x4(int(modes[idx]), top8, left4, tl,
                                  b_at, b_al, b_atl)
            coeff = np.zeros(16, dtype=np.int64)
            coeff[rt.ZIGZAG_4x4] = scanned
            res = rt.residual_block_recon(coeff.reshape(4, 4), qp,
                                          ws=self._ws4(0))
            y0, x0 = mr * 16 + by * 4, mc * 16 + bx * 4
            pic.y[y0:y0 + 4, x0:x0 + 4] = rt.clip1(pred + res)

    def _recon_i16(self, r, pic, mr, mc, qp, i16mode, cbp_luma, at, al, atl):
        y0, x0 = mr * 16, mc * 16
        top = pic.y[y0 - 1, x0:x0 + 16] if at else np.zeros(16, dtype=np.int64)
        left = pic.y[y0:y0 + 16, x0 - 1] if al else np.zeros(16, dtype=np.int64)
        tl = int(pic.y[y0 - 1, x0 - 1]) if atl else 0
        pred = ri.predict_16x16(i16mode, top, left, tl, at, al, atl)
        # DC block (nC as for luma block 0)
        sid = int(pic.slice_id[mr, mc])
        ncv = self._nc_luma(pic, mr * 4, mc * 4, sid)
        dc_scan = cavlc.decode_block(r, ncv, 16)
        dc = np.zeros(16, dtype=np.int64)
        dc[rt.ZIGZAG_4x4] = dc_scan
        dc_deq = rt.hadamard4x4_inv_dequant_dc(dc.reshape(4, 4), qp,
                                               w00=self._w00(0))
        recon = np.zeros((16, 16), dtype=np.int64)
        for idx, (by, bx) in enumerate(BLK_ORDER):
            gr, gc = mr * 4 + by, mc * 4 + bx
            if cbp_luma:
                ncv = self._nc_luma(pic, gr, gc, sid)
                ac = cavlc.decode_block(r, ncv, 15)
                pic.luma_tc[gr, gc] = (ac != 0).sum()
            else:
                ac = np.zeros(15, dtype=np.int64)
                pic.luma_tc[gr, gc] = 0
            coeff = np.zeros(16, dtype=np.int64)
            coeff[rt.ZIGZAG_4x4[1:]] = ac
            res = rt.residual_block_recon(coeff.reshape(4, 4), qp,
                                          dc=int(dc_deq[by, bx]),
                                          ws=self._ws4(0))
            recon[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = res
        pic.y[y0:y0 + 16, x0:x0 + 16] = rt.clip1(pred + recon)

    def _recon_chroma(self, r, pic, mr, mc, qp, cmode, cbp_chroma,
                      at, al, atl):
        cqp = rt.chroma_qp(qp, self.pps.chroma_qp_index_offset)
        sid = int(pic.slice_id[mr, mc])
        y0, x0 = mr * 8, mc * 8
        planes = (pic.u, pic.v)
        # parse DC for both components first (bitstream order: cb DC, cr DC,
        # then cb AC blocks, then cr AC blocks)
        dcs = []
        for comp in range(2):
            if cbp_chroma >= 1:
                dc_scan = cavlc.decode_block(r, -1, 4)
            else:
                dc_scan = np.zeros(4, dtype=np.int64)
            dcs.append(dc_scan.reshape(2, 2))
        acs = [[None] * 4 for _ in range(2)]
        for comp in range(2):
            for idx in range(4):
                by, bx = idx // 2, idx % 2
                gr, gc = mr * 2 + by, mc * 2 + bx
                if cbp_chroma == 2:
                    ncv = self._nc_chroma(pic, comp, gr, gc, sid)
                    ac = cavlc.decode_block(r, ncv, 15)
                    pic.chroma_tc[comp, gr, gc] = (ac != 0).sum()
                else:
                    ac = np.zeros(15, dtype=np.int64)
                    pic.chroma_tc[comp, gr, gc] = 0
                acs[comp][idx] = ac
        for comp in range(2):
            plane = planes[comp]
            top = plane[y0 - 1, x0:x0 + 8] if at else np.zeros(8, dtype=np.int64)
            left = plane[y0:y0 + 8, x0 - 1] if al else np.zeros(8, dtype=np.int64)
            tl = int(plane[y0 - 1, x0 - 1]) if atl else 0
            pred = ri.predict_chroma8x8(cmode, top, left, tl, at, al, atl)
            dc_deq = rt.hadamard2x2_inv_dequant_dc(
                dcs[comp], cqp, w00=self._w00(1 + comp))
            recon = np.zeros((8, 8), dtype=np.int64)
            for idx in range(4):
                by, bx = idx // 2, idx % 2
                coeff = np.zeros(16, dtype=np.int64)
                coeff[rt.ZIGZAG_4x4[1:]] = acs[comp][idx]
                res = rt.residual_block_recon(coeff.reshape(4, 4), cqp,
                                              dc=int(dc_deq[by, bx]),
                                              ws=self._ws4(1 + comp))
                recon[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = res
            plane[y0:y0 + 8, x0:x0 + 8] = rt.clip1(pred + recon)


    # ------------------------------------------------------ deblocking

    def _deblock_picture(self, pic: PictureState):
        """Apply the in-loop filter to a completed picture (spec 8.7),
        two-list bS derivation (B-aware, 8.7.2.1), on `self.device`: the
        picture's planes and per-MB state go there, bS, the QP grids and
        the edge masks are built there, the wavefront deblocker filters
        (K4, one launch a wave, on the card), and the planes come back."""
        dev = self.device

        def on(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int32)).to(dev)

        # intra MBs mark BOTH lists INTRA; an inter MB always uses >= 1
        # list (a list-unused marker alone is not intra)
        ref4 = on(pic.ref4[:, ::4, ::4])
        intra_mb = (ref4[0] == mvpred.INTRA) & (ref4[1] == mvpred.INTRA)
        left_ok = torch.zeros((pic.hm, pic.wm), dtype=torch.bool, device=dev)
        top_ok = torch.zeros_like(left_ok)
        left_ok[:, 1:] = True
        top_ok[1:, :] = True
        if pic.deblock_idc == 2:   # do not filter across slice boundaries
            sid = on(pic.slice_id)
            left_ok[:, 1:] &= sid[:, 1:] == sid[:, :-1]
            top_ok[1:, :] &= sid[1:, :] == sid[:-1, :]
        qp_mb = on(pic.qp_mb)
        qp_g = torch.where(qp_mb >= 0, qp_mb, int(pic.qp))
        cqp_tab = on([rt.chroma_qp(q, self.pps.chroma_qp_index_offset)
                      for q in range(52)])
        cqp_g = cqp_tab[torch.clamp(qp_g, 0, 51).long()]
        mv2 = on(pic.mv4).permute(1, 2, 0, 3)    # [h4, w4, 2(list), 2]
        pid2 = on(pic.pid4).permute(1, 2, 0)     # [h4, w4, 2]
        # coeff condition per 8x8 block for transform-8x8 MBs
        t8 = on(pic.t8).to(torch.bool)
        tc_eff = torch.where(up4(t8), on(pic.luma_tc_db), on(pic.luma_tc))
        off_a, off_b = pic.db_off or (0, 0)
        deblock = make_deblocker(pic.wm, pic.hm)
        planes = deblock(on(pic.y), on(pic.u), on(pic.v), intra_mb, tc_eff,
                         mv2, pid2, qp_g, cqp_g, t8_mb=t8, left_ok=left_ok,
                         top_ok=top_ok, off_a=off_a, off_b=off_b)
        pic.y, pic.u, pic.v = (p.cpu().numpy().astype(np.int64)
                               for p in planes)

    # ------------------------------------------------------ P slices

    def _get4(self, pic, lx, rr, cc, sid):
        """list-lx motion of the 4x4 block at (rr, cc), availability-
        checked (outside frame / other slice -> UNAVAIL)."""
        if rr < 0 or cc < 0 or cc >= pic.wm * 4 \
                or pic.slice_id[rr // 4, cc // 4] != sid:
            return np.zeros(2, np.int64), mvpred.UNAVAIL
        return pic.mv4[lx, rr, cc].copy(), int(pic.ref4[lx, rr, cc])

    def _mv_neighbors(self, pic, lx, g4r, g4c, w4b, sid):
        """(A, B, C) neighbor motion for a partition with top-left 4x4
        block (g4r, g4c) spanning w4b block columns (C -> D subst)."""
        mv_a, ref_a = self._get4(pic, lx, g4r, g4c - 1, sid)
        mv_b, ref_b = self._get4(pic, lx, g4r - 1, g4c, sid)
        mv_c, ref_c = self._get4(pic, lx, g4r - 1, g4c + w4b, sid)
        if ref_c == mvpred.UNAVAIL:
            mv_c, ref_c = self._get4(pic, lx, g4r - 1, g4c - 1, sid)
        return (mv_a, ref_a), (mv_b, ref_b), (mv_c, ref_c)

    def _mv_pred_part(self, pic, lx, cur_ref, g4r, g4c, h4b, w4b, sid):
        """Partition MV predictor (spec 8.4.1.3): median with same-ref
        directional shortcuts for 16x8 / 8x16 partitions."""
        (mv_a, ref_a), (mv_b, ref_b), (mv_c, ref_c) = self._mv_neighbors(
            pic, lx, g4r, g4c, w4b, sid)
        if w4b == 4 and h4b == 2:            # 16x8
            if g4r % 4 == 0 and ref_b == cur_ref:
                return mv_b
            if g4r % 4 == 2 and ref_a == cur_ref:
                return mv_a
        elif w4b == 2 and h4b == 4:          # 8x16
            if g4c % 4 == 0 and ref_a == cur_ref:
                return mv_a
            if g4c % 4 == 2 and ref_c == cur_ref:
                return mv_c
        if ref_b == mvpred.UNAVAIL and ref_c == mvpred.UNAVAIL \
                and ref_a != mvpred.UNAVAIL:
            return mv_a
        same = [ref_a == cur_ref, ref_b == cur_ref, ref_c == cur_ref]
        if sum(same) == 1:
            return (mv_a, mv_b, mv_c)[same.index(True)]
        return np.stack([
            np.median([mv_a[0], mv_b[0], mv_c[0]]),
            np.median([mv_a[1], mv_b[1], mv_c[1]])]).astype(np.int64)

    def _mv_pred(self, pic, mr, mc, sid, lx=0, cur_ref=0):
        return self._mv_pred_part(pic, lx, cur_ref, mr * 4, mc * 4, 4, 4,
                                  sid)

    def _skip_mv(self, pic, mr, mc, sid):
        (mv_a, ref_a), (mv_b, ref_b), _ = self._mv_neighbors(
            pic, 0, mr * 4, mc * 4, 4, sid)
        pred = self._mv_pred(pic, mr, mc, sid)
        return mvpred.skip_mv_np(pred, mv_a, ref_a, mv_b, ref_b)

    # ------------------------------------------------- weighted prediction

    def _weight_uni(self, preds, lx: int, ref_idx: int):
        """Explicit unidirectional weighting (spec 8.4.2.3.2); identity
        when no pred_weight_table is active."""
        if self._wp is None:
            return preds
        ld, cd, wl0, wl1 = self._wp
        wy, oy, wcb, ocb, wcr, ocr = (wl0 if lx == 0 else wl1)[ref_idx]

        def w1(p, w, o, d):
            if d > 0:
                v = ((p * w + (1 << (d - 1))) >> d) + o
            else:
                v = p * w + o
            return np.clip(v, 0, 255)

        py, pu, pv = preds
        return (w1(py, wy, oy, ld), w1(pu, wcb, ocb, cd),
                w1(pv, wcr, ocr, cd))

    def _weight_bi(self, p0, r0, p1, r1):
        """Bi-prediction combine: default average, explicit (idc 1) or
        implicit POC-distance weights (idc 2, spec 8.4.2.3.1)."""
        if self._wp_implicit:
            pic0, pic1 = self._list0[r0], self._list1[r1]
            w0 = w1_ = 32
            td = int(np.clip(pic1.poc - pic0.poc, -128, 127))
            if td != 0 and pic0.short_term and pic1.short_term:
                tb = int(np.clip(self._pic.poc - pic0.poc, -128, 127))
                tx = (16384 + abs(td) // 2) // td
                dsf = int(np.clip((tb * tx + 32) >> 6, -1024, 1023))
                if -64 <= (dsf >> 2) <= 128:
                    w1_ = dsf >> 2
                    w0 = 64 - w1_
            return tuple(
                np.clip((a * w0 + b * w1_ + 32) >> 6, 0, 255)
                for a, b in zip(p0, p1))
        if self._wp is not None:
            ld, cd, wl0, wl1 = self._wp
            wa = wl0[r0]
            wb = wl1[r1]

            def w2(a, b, i, d):
                w0_, o0 = wa[i], wa[i + 1]
                w1x, o1 = wb[i], wb[i + 1]
                v = ((a * w0_ + b * w1x + (1 << d)) >> (d + 1)) \
                    + ((o0 + o1 + 1) >> 1)
                return np.clip(v, 0, 255)

            py = w2(p0[0], p1[0], 0, ld)
            pu = w2(p0[1], p1[1], 2, cd)
            pv = w2(p0[2], p1[2], 4, cd)
            return py, pu, pv
        return tuple((a + b + 1) >> 1 for a, b in zip(p0, p1))

    def _mc_recon(self, pic, mr, mc, mv, ref: RefPic | None = None):
        """Luma + chroma MC prediction for a 16x16 MB at qpel mv."""
        if ref is None:
            ref = self._list0[0]
        y0, x0 = mr * 16 + REF_PAD, mc * 16 + REF_PAD
        pred_y = rip.mc_luma_block(ref.planes, y0, x0,
                                   int(mv[0]), int(mv[1]))
        cy0, cx0 = mr * 8 + REF_PAD // 2, mc * 8 + REF_PAD // 2
        pred_u = rip.mc_chroma_block(ref.u_pad, cy0, cx0,
                                     int(mv[0]), int(mv[1]))
        pred_v = rip.mc_chroma_block(ref.v_pad, cy0, cx0,
                                     int(mv[0]), int(mv[1]))
        return pred_y, pred_u, pred_v

    # ------------------------------------------------------ B slices

    def _direct_spatial_motion(self, pic, mr, mc, sid):
        """Spatial direct motion for one MB (spec 8.4.1.2.2), per-8x8
        colZeroFlag with direct_8x8_inference (corner 4x4 colocated
        blocks in RefPicList1[0]).

        Returns (ref0, ref1, mv0_8 [4, 2], mv1_8 [4, 2]); refX = -1 when
        list X is unused."""
        if not getattr(self, "_direct_spatial", True):
            # temporal direct returns the same (r0, r1, mv0_8, mv1_8)
            # shape with r0 replaced per-8x8 via _direct_motion
            raise RuntimeError("use _direct_motion for temporal slices")
        refidx = []
        for lx in (0, 1):
            (_, ra), (_, rb), (_, rc) = self._mv_neighbors(
                pic, lx, mr * 4, mc * 4, 4, sid)
            cand = [x for x in (ra, rb, rc) if x >= 0]
            refidx.append(min(cand) if cand else -1)
        r0, r1 = refidx
        mv0 = np.zeros((4, 2), dtype=np.int64)
        mv1 = np.zeros((4, 2), dtype=np.int64)
        if r0 < 0 and r1 < 0:          # directZeroPredictionFlag
            return 0, 0, mv0, mv1
        mvp = [np.zeros(2, np.int64), np.zeros(2, np.int64)]
        for lx, ri in ((0, r0), (1, r1)):
            if ri >= 0:
                mvp[lx] = self._mv_pred_part(pic, lx, ri, mr * 4, mc * 4,
                                             4, 4, sid)
        col = self._list1[0]
        for b8 in range(4):
            cr = mr * 4 + (0 if b8 < 2 else 3)
            cc = mc * 4 + (0 if b8 % 2 == 0 else 3)
            colzero = (col.short_term and int(col.col_ref[cr, cc]) == 0
                       and (np.abs(col.col_mv[cr, cc]) <= 1).all())
            if r0 >= 0 and not (r0 == 0 and colzero):
                mv0[b8] = mvp[0]
            if r1 >= 0 and not (r1 == 0 and colzero):
                mv1[b8] = mvp[1]
        return r0, r1, mv0, mv1

    def _direct_temporal_motion(self, pic, mr, mc, sid):
        """Temporal direct motion (spec 8.4.1.2.3): per-8x8 refIdxL0 is
        the colocated block's reference mapped into the current list0;
        MVs scale by POC distances.  Returns per-8x8 lists
        (ref0[4], ref1=0, mv0 [4, 2], mv1 [4, 2])."""
        col = self._list1[0]
        refs0 = np.zeros(4, dtype=np.int64)
        mv0 = np.zeros((4, 2), dtype=np.int64)
        mv1 = np.zeros((4, 2), dtype=np.int64)
        uid_to_idx = {}
        for i, rr in enumerate(self._list0):
            uid_to_idx.setdefault(rr.uid, i)
        for b8 in range(4):
            cr = mr * 4 + (0 if b8 < 2 else 3)
            cc = mc * 4 + (0 if b8 % 2 == 0 else 3)
            col_pid = int(col.col_pid[cr, cc])
            mv_col = col.col_mv[cr, cc].astype(np.int64)
            if col_pid < 0:            # intra colocated: mv 0, ref 0
                mv_col = np.zeros(2, np.int64)
                r0 = 0
            else:
                r0 = uid_to_idx.get(col_pid, 0)
            refs0[b8] = r0
            pic0 = self._list0[r0]
            td = int(np.clip(col.poc - pic0.poc, -128, 127))
            if not pic0.short_term or td == 0:
                mv0[b8] = mv_col
                mv1[b8] = 0
            else:
                tb = int(np.clip(self._pic.poc - pic0.poc, -128, 127))
                tx = (16384 + abs(td) // 2) // td
                dsf = int(np.clip((tb * tx + 32) >> 6, -1024, 1023))
                mv0[b8] = (dsf * mv_col + 128) >> 8
                mv1[b8] = mv0[b8] - mv_col
        return refs0, mv0, mv1

    def _direct_motion(self, pic, mr, mc, sid):
        """Direct motion for one MB → per-8x8 tuples
        [(ref0, ref1, mv0, mv1)], spatial or temporal per the slice
        flag.  refX = -1 means list X unused."""
        if getattr(self, "_direct_spatial", True):
            r0, r1, mv0, mv1 = self._direct_spatial_motion(pic, mr, mc,
                                                           sid)
            return [(r0, r1, mv0[b8], mv1[b8]) for b8 in range(4)]
        refs0, mv0, mv1 = self._direct_temporal_motion(pic, mr, mc, sid)
        return [(int(refs0[b8]), 0, mv0[b8], mv1[b8]) for b8 in range(4)]

    def _direct_mc_store(self, pic, mr, mc, sid):
        """Direct-mode motion derivation + MC for one MB: stores the
        per-8x8 motion into the picture maps and returns the prediction
        planes (pred_y 16x16, pred_u/v 8x8)."""
        per8 = self._direct_motion(pic, mr, mc, sid)
        pred_y = np.zeros((16, 16), dtype=np.int64)
        pred_u = np.zeros((8, 8), dtype=np.int64)
        pred_v = np.zeros((8, 8), dtype=np.int64)
        for b8 in range(4):
            r0, r1, bmv0, bmv1 = per8[b8]
            dr4, dc4 = (b8 // 2) * 2, (b8 % 2) * 2
            preds = []
            for lx, ri, mv in ((0, r0, bmv0), (1, r1, bmv1)):
                lst = self._list0 if lx == 0 else self._list1
                if ri >= 0:
                    pic.set_motion(lx, mr * 4 + dr4, mc * 4 + dc4, 2, 2,
                                   mv, ri, pid=lst[ri].uid)
                    preds.append(self._mc_part(
                        pic, mr * 16 + dr4 * 4, mc * 16 + dc4 * 4, 8, 8,
                        mv, lst[ri]))
                else:
                    pic.set_motion(lx, mr * 4 + dr4, mc * 4 + dc4, 2, 2,
                                   0, mvpred.INTRA)
            if len(preds) == 2:
                py, pu, pv = self._weight_bi(preds[0], r0, preds[1], r1)
            elif r0 >= 0:
                py, pu, pv = self._weight_uni(preds[0], 0, r0)
            else:
                py, pu, pv = self._weight_uni(preds[0], 1, r1)
            pred_y[dr4 * 4:dr4 * 4 + 8, dc4 * 4:dc4 * 4 + 8] = py
            pred_u[dr4 * 2:dr4 * 2 + 4, dc4 * 2:dc4 * 2 + 4] = pu
            pred_v[dr4 * 2:dr4 * 2 + 4, dc4 * 2:dc4 * 2 + 4] = pv
        return pred_y, pred_u, pred_v

    def _decode_mb_b_direct(self, r, pic, addr: int, qp: int, sid: int,
                            skip: bool):
        """B_Skip (skip=True) / B_Direct_16x16: spatial direct motion,
        optional residual."""
        mr, mc = addr // pic.wm, addr % pic.wm
        pic.slice_id[mr, mc] = sid
        pred_y, pred_u, pred_v = self._direct_mc_store(pic, mr, mc, sid)
        if skip:
            pic.y[mr * 16:mr * 16 + 16, mc * 16:mc * 16 + 16] = pred_y
            pic.u[mr * 8:mr * 8 + 8, mc * 8:mc * 8 + 8] = pred_u
            pic.v[mr * 8:mr * 8 + 8, mc * 8:mc * 8 + 8] = pred_v
            pic.luma_tc[mr * 4:mr * 4 + 4, mc * 4:mc * 4 + 4] = 0
            pic.chroma_tc[:, mr * 2:mr * 2 + 2, mc * 2:mc * 2 + 2] = 0
            pic.qp_mb[mr, mc] = qp
            return qp
        return self._parse_inter_residual(
            r, pic, mr, mc, qp, (pred_y, pred_u, pred_v), sid)

    def _parse_inter_residual(self, r, pic, mr, mc, qp, preds, sid,
                              allow_t8: bool = True):
        """Shared inter-MB tail: cbp, transform_size_8x8_flag,
        mb_qp_delta, luma residual (4x4 or 8x8), chroma residual, plane
        store.  Returns the (possibly updated) qp."""
        self._check_bypass(qp)
        cbp = int(mb_syntax.CODENUM_TO_CBP_INTER[read_ue(r)])
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        t8 = 0
        if self.pps.transform_8x8_mode_flag and cbp_luma > 0 \
                and allow_t8:
            t8 = r.read(1)
        if cbp > 0:
            qp = qp + read_se(r)
        pred_y, pred_u, pred_v = preds
        recon = np.zeros((16, 16), dtype=np.int64)
        if t8:
            from tpu264_torch.ref import transform8 as rt8
            pic.t8[mr, mc] = True
            for b8 in range(4):
                by, bx = b8 // 2, b8 % 2
                coded = (cbp_luma >> b8) & 1
                d = self._read_luma8x8_cavlc(r, pic, mr, mc, b8, sid,
                                             coded)
                recon[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] = \
                    rt8.idct8x8(rt8.dequant8x8(d, qp, ws=self._ws8(1)))
        else:
            for idx, (by, bx) in enumerate(BLK_ORDER):
                gr, gc = mr * 4 + by, mc * 4 + bx
                if (cbp_luma >> (idx // 4)) & 1:
                    ncv = self._nc_luma(pic, gr, gc, sid)
                    scanned = cavlc.decode_block(r, ncv, 16)
                    pic.luma_tc[gr, gc] = (scanned != 0).sum()
                else:
                    scanned = np.zeros(16, dtype=np.int64)
                    pic.luma_tc[gr, gc] = 0
                coeff = np.zeros(16, dtype=np.int64)
                coeff[rt.ZIGZAG_4x4] = scanned
                recon[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = \
                    rt.residual_block_recon(coeff.reshape(4, 4), qp,
                                            ws=self._ws4(3))
        pic.y[mr * 16:mr * 16 + 16, mc * 16:mc * 16 + 16] = \
            rt.clip1(pred_y + recon)
        self._recon_chroma_inter(r, pic, mr, mc, qp, cbp_chroma,
                                 (pred_u, pred_v), sid)
        pic.qp_mb[mr, mc] = qp
        return qp

    def _decode_mb_b(self, r: BitReader, pic: PictureState, addr: int,
                     qp: int, sid: int):
        """B macroblock (16x16 L0/L1/Bi + intra; Table 7-14)."""
        mb_type = read_ue(r)
        if mb_type >= 23:
            return self._decode_mb_i(r, pic, addr, qp, sid,
                                     mb_type=mb_type - 23)
        if mb_type == 0:               # B_Direct_16x16
            return self._decode_mb_b_direct(r, pic, addr, qp, sid,
                                            skip=False)
        if 4 <= mb_type <= 21:         # 16x8 / 8x16 two-partition types
            return self._decode_mb_b_parts(r, pic, addr, qp, sid,
                                           mb_type)
        if mb_type == 22:              # B_8x8
            return self._decode_mb_b8x8(r, pic, addr, qp, sid)
        if mb_type not in (1, 2, 3):
            raise NotImplementedError(f"B mb_type {mb_type}")
        mr, mc = addr // pic.wm, addr % pic.wm
        pic.slice_id[mr, mc] = sid
        use0 = mb_type in (1, 3)
        use1 = mb_type in (2, 3)
        # syntax order (spec 7.3.5.1): ref_idx_l0, ref_idx_l1, then mvds
        refs = [0, 0]
        for lx, use, lst in ((0, use0, self._list0),
                             (1, use1, self._list1)):
            if use:
                refs[lx] = self._read_te(r, len(lst) - 1)
        mvs = [None, None]
        for lx, use in ((0, use0), (1, use1)):
            if not use:
                continue
            mvd_x = read_se(r)
            mvd_y = read_se(r)
            pred = self._mv_pred_part(pic, lx, refs[lx], mr * 4, mc * 4,
                                      4, 4, sid)
            mvs[lx] = pred + np.array([mvd_y, mvd_x], dtype=np.int64)
        pic.set_motion(0, mr * 4, mc * 4, 4, 4,
                       mvs[0] if use0 else 0,
                       refs[0] if use0 else mvpred.INTRA,
                       pid=self._list0[refs[0]].uid if use0 else -1)
        pic.set_motion(1, mr * 4, mc * 4, 4, 4,
                       mvs[1] if use1 else 0,
                       refs[1] if use1 else mvpred.INTRA,
                       pid=self._list1[refs[1]].uid if use1 else -1)

        if use0 and use1:
            p0 = self._mc_recon(pic, mr, mc, mvs[0], self._list0[refs[0]])
            p1 = self._mc_recon(pic, mr, mc, mvs[1], self._list1[refs[1]])
            preds = self._weight_bi(p0, refs[0], p1, refs[1])
        elif use0:
            preds = self._weight_uni(
                self._mc_recon(pic, mr, mc, mvs[0], self._list0[refs[0]]),
                0, refs[0])
        else:
            preds = self._weight_uni(
                self._mc_recon(pic, mr, mc, mvs[1], self._list1[refs[1]]),
                1, refs[1])
        return self._parse_inter_residual(r, pic, mr, mc, qp, preds, sid)

    # B partition pred modes: (use0, use1) per partition for mb_type
    # 4..21 (Table 7-14 B_X_Y_16x8 / 8x16 pairs)
    _B_PART_PRED = [((1, 0), (1, 0)), ((0, 1), (0, 1)),
                    ((1, 0), (0, 1)), ((0, 1), (1, 0)),
                    ((1, 0), (1, 1)), ((0, 1), (1, 1)),
                    ((1, 1), (1, 0)), ((1, 1), (0, 1)),
                    ((1, 1), (1, 1))]

    def _b_mc_part(self, pic, y0, x0, bh, bw, mvs, refs, uses):
        """Weighted MC for one B partition (per-list mvs/refs/use)."""
        parts = []
        for lx, lst in ((0, self._list0), (1, self._list1)):
            if uses[lx]:
                parts.append(self._mc_part(pic, y0, x0, bh, bw,
                                           mvs[lx], lst[refs[lx]]))
        if len(parts) == 2:
            return self._weight_bi(parts[0], refs[0], parts[1], refs[1])
        lx = 0 if uses[0] else 1
        return self._weight_uni(parts[0], lx, refs[lx])

    def _decode_mb_b_parts(self, r, pic, addr: int, qp: int, sid: int,
                           mb_type: int):
        """B_X_Y_16x8 / 8x16 (mb_type 4..21, Table 7-14)."""
        mr, mc = addr // pic.wm, addr % pic.wm
        pic.slice_id[mr, mc] = sid
        g4r, g4c = mr * 4, mc * 4
        pred0, pred1 = self._B_PART_PRED[(mb_type - 4) // 2]
        geom = (self._P_PARTS[1] if mb_type % 2 == 0
                else self._P_PARTS[2])     # even = 16x8, odd = 8x16
        part_uses = (pred0, pred1)
        # syntax order: all ref_idx_l0, all ref_idx_l1, all mvd_l0, l1
        refs = [[0, 0], [0, 0]]            # [lx][part]
        for lx, lst in ((0, self._list0), (1, self._list1)):
            for p in range(2):
                if part_uses[p][lx]:
                    refs[lx][p] = self._read_te(r, len(lst) - 1)
        # partitions not using a list are "available, refIdx -1" for the
        # within-MB MV prediction of later partitions — mark them now
        for p, (dr4, dc4, h4b, w4b) in enumerate(geom):
            for lx in (0, 1):
                if not part_uses[p][lx]:
                    pic.set_motion(lx, g4r + dr4, g4c + dc4, h4b, w4b,
                                   0, mvpred.INTRA)
        mvs = [[None, None], [None, None]]
        for lx in (0, 1):
            for p, (dr4, dc4, h4b, w4b) in enumerate(geom):
                if not part_uses[p][lx]:
                    continue
                mvd_x = read_se(r)
                mvd_y = read_se(r)
                pred = self._mv_pred_part(pic, lx, refs[lx][p],
                                          g4r + dr4, g4c + dc4,
                                          h4b, w4b, sid)
                mvs[lx][p] = pred + np.array([mvd_y, mvd_x],
                                             dtype=np.int64)
                lst = self._list0 if lx == 0 else self._list1
                pic.set_motion(lx, g4r + dr4, g4c + dc4, h4b, w4b,
                               mvs[lx][p], refs[lx][p],
                               pid=lst[refs[lx][p]].uid)
        pred_y = np.zeros((16, 16), dtype=np.int64)
        pred_u = np.zeros((8, 8), dtype=np.int64)
        pred_v = np.zeros((8, 8), dtype=np.int64)
        for p, (dr4, dc4, h4b, w4b) in enumerate(geom):
            py, pu, pv = self._b_mc_part(
                pic, mr * 16 + dr4 * 4, mc * 16 + dc4 * 4,
                h4b * 4, w4b * 4,
                [mvs[0][p], mvs[1][p]], [refs[0][p], refs[1][p]],
                part_uses[p])
            pred_y[dr4 * 4:(dr4 + h4b) * 4, dc4 * 4:(dc4 + w4b) * 4] = py
            pred_u[dr4 * 2:(dr4 + h4b) * 2, dc4 * 2:(dc4 + w4b) * 2] = pu
            pred_v[dr4 * 2:(dr4 + h4b) * 2, dc4 * 2:(dc4 + w4b) * 2] = pv
        return self._parse_inter_residual(
            r, pic, mr, mc, qp, (pred_y, pred_u, pred_v), sid)

    # B sub_mb_type (Table 7-18): (use0, use1, sub-part geometry key)
    _B_SUB = {1: ((1, 0), 0), 2: ((0, 1), 0), 3: ((1, 1), 0),
              4: ((1, 0), 1), 5: ((1, 0), 2), 6: ((0, 1), 1),
              7: ((0, 1), 2), 8: ((1, 1), 1), 9: ((1, 1), 2),
              10: ((1, 0), 3), 11: ((0, 1), 3), 12: ((1, 1), 3)}

    def _decode_mb_b8x8(self, r, pic, addr: int, qp: int, sid: int):
        """B_8x8 (mb_type 22): per-8x8 sub_mb_type incl. B_Direct_8x8."""
        mr, mc = addr // pic.wm, addr % pic.wm
        pic.slice_id[mr, mc] = sid
        g4r, g4c = mr * 4, mc * 4
        subs = [read_ue(r) for _ in range(4)]
        if any(s > 12 for s in subs):
            raise ValueError(f"bad B sub_mb_type {subs}")
        # MB-level spatial-direct derivation feeds any B_Direct_8x8 subs;
        # their motion is stored NOW so later sub-blocks' MV prediction
        # inside this MB sees it (derivation order, spec 8.4.1)
        direct = None
        if any(s == 0 for s in subs):
            direct = self._direct_motion(pic, mr, mc, sid)
            for b8 in range(4):
                if subs[b8] != 0:
                    continue
                r0d, r1d, dmv0, dmv1 = direct[b8]
                br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                for lx, ri, mv in ((0, r0d, dmv0), (1, r1d, dmv1)):
                    lst = self._list0 if lx == 0 else self._list1
                    if ri >= 0:
                        pic.set_motion(lx, g4r + br4, g4c + bc4, 2, 2,
                                       mv, ri, pid=lst[ri].uid)
                    else:
                        pic.set_motion(lx, g4r + br4, g4c + bc4, 2, 2,
                                       0, mvpred.INTRA)
        # syntax: ref_idx_l0 per 8x8, ref_idx_l1 per 8x8, mvd_l0, mvd_l1
        refs = [[0] * 4, [0] * 4]
        for lx, lst in ((0, self._list0), (1, self._list1)):
            for b8 in range(4):
                if subs[b8] != 0 and self._B_SUB[subs[b8]][0][lx]:
                    refs[lx][b8] = self._read_te(r, len(lst) - 1)
        mvs = [[[] for _ in range(4)], [[] for _ in range(4)]]
        for b8 in range(4):
            if subs[b8] == 0:
                continue
            for lx in (0, 1):
                if not self._B_SUB[subs[b8]][0][lx]:
                    br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                    pic.set_motion(lx, g4r + br4, g4c + bc4, 2, 2,
                                   0, mvpred.INTRA)
        for lx in (0, 1):
            for b8 in range(4):
                if subs[b8] == 0:
                    continue
                uses, gkey = self._B_SUB[subs[b8]]
                if not uses[lx]:
                    continue
                br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                lst = self._list0 if lx == 0 else self._list1
                for dr4, dc4, h4b, w4b in self._SUB_PARTS[gkey]:
                    mvd_x = read_se(r)
                    mvd_y = read_se(r)
                    pred = self._mv_pred_part(
                        pic, lx, refs[lx][b8], g4r + br4 + dr4,
                        g4c + bc4 + dc4, h4b, w4b, sid)
                    mv = pred + np.array([mvd_y, mvd_x], dtype=np.int64)
                    mvs[lx][b8].append(mv)
                    pic.set_motion(lx, g4r + br4 + dr4, g4c + bc4 + dc4,
                                   h4b, w4b, mv, refs[lx][b8],
                                   pid=lst[refs[lx][b8]].uid)
        pred_y = np.zeros((16, 16), dtype=np.int64)
        pred_u = np.zeros((8, 8), dtype=np.int64)
        pred_v = np.zeros((8, 8), dtype=np.int64)

        def put(dr4, dc4, h4b, w4b, planes):
            py, pu, pv = planes
            pred_y[dr4 * 4:(dr4 + h4b) * 4, dc4 * 4:(dc4 + w4b) * 4] = py
            pred_u[dr4 * 2:(dr4 + h4b) * 2, dc4 * 2:(dc4 + w4b) * 2] = pu
            pred_v[dr4 * 2:(dr4 + h4b) * 2, dc4 * 2:(dc4 + w4b) * 2] = pv

        for b8 in range(4):
            br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
            if subs[b8] == 0:          # B_Direct_8x8
                r0, r1, dmv0, dmv1 = direct[b8]
                parts = []
                for lx, ri, mv in ((0, r0, dmv0), (1, r1, dmv1)):
                    lst = self._list0 if lx == 0 else self._list1
                    if ri >= 0:
                        pic.set_motion(lx, g4r + br4, g4c + bc4, 2, 2,
                                       mv, ri, pid=lst[ri].uid)
                        parts.append((lx, ri, self._mc_part(
                            pic, mr * 16 + br4 * 4, mc * 16 + bc4 * 4,
                            8, 8, mv, lst[ri])))
                    else:
                        pic.set_motion(lx, g4r + br4, g4c + bc4, 2, 2,
                                       0, mvpred.INTRA)
                if len(parts) == 2:
                    planes = self._weight_bi(parts[0][2], parts[0][1],
                                             parts[1][2], parts[1][1])
                else:
                    lx, ri, pl = parts[0]
                    planes = self._weight_uni(pl, lx, ri)
                put(br4, bc4, 2, 2, planes)
                continue
            uses, gkey = self._B_SUB[subs[b8]]
            for pi, (dr4, dc4, h4b, w4b) in enumerate(
                    self._SUB_PARTS[gkey]):
                planes = self._b_mc_part(
                    pic, mr * 16 + (br4 + dr4) * 4,
                    mc * 16 + (bc4 + dc4) * 4, h4b * 4, w4b * 4,
                    [mvs[0][b8][pi] if uses[0] else None,
                     mvs[1][b8][pi] if uses[1] else None],
                    [refs[0][b8], refs[1][b8]], uses)
                put(br4 + dr4, bc4 + dc4, h4b, w4b, planes)
        allow_t8 = all(s == 0 or self._B_SUB[s][1] == 0 for s in subs)
        return self._parse_inter_residual(
            r, pic, mr, mc, qp, (pred_y, pred_u, pred_v), sid,
            allow_t8=allow_t8)

    def _decode_mb_skip(self, pic, addr: int, sid: int,
                        qp: int | None = None):
        mr, mc = addr // pic.wm, addr % pic.wm
        pic.slice_id[mr, mc] = sid
        if qp is not None:
            pic.qp_mb[mr, mc] = qp
        mv = self._skip_mv(pic, mr, mc, sid)
        pic.set_motion(0, mr * 4, mc * 4, 4, 4, mv, 0,
                       pid=self._list0[0].uid)
        pic.set_motion(1, mr * 4, mc * 4, 4, 4, 0, mvpred.INTRA)
        pred_y, pred_u, pred_v = self._weight_uni(
            self._mc_recon(pic, mr, mc, mv), 0, 0)
        pic.y[mr * 16:mr * 16 + 16, mc * 16:mc * 16 + 16] = pred_y
        pic.u[mr * 8:mr * 8 + 8, mc * 8:mc * 8 + 8] = pred_u
        pic.v[mr * 8:mr * 8 + 8, mc * 8:mc * 8 + 8] = pred_v
        pic.luma_tc[mr * 4:mr * 4 + 4, mc * 4:mc * 4 + 4] = 0
        pic.chroma_tc[:, mr * 2:mr * 2 + 2, mc * 2:mc * 2 + 2] = 0

    def _read_te(self, r: BitReader, cmax: int) -> int:
        """te(v): 1-bit inverted flag when cmax == 1, ue(v) otherwise."""
        if cmax == 0:
            return 0
        if cmax == 1:
            return 1 - r.read(1)
        return read_ue(r)

    def _mc_part(self, pic, y0, x0, bh, bw, mv, ref: RefPic):
        """Luma + chroma MC for an arbitrary partition at luma (y0, x0)."""
        py = rip.mc_luma_block(ref.planes, y0 + REF_PAD, x0 + REF_PAD,
                               int(mv[0]), int(mv[1]), bh, bw)
        pu = rip.mc_chroma_block(ref.u_pad, y0 // 2 + REF_PAD // 2,
                                 x0 // 2 + REF_PAD // 2,
                                 int(mv[0]), int(mv[1]), bh // 2, bw // 2)
        pv = rip.mc_chroma_block(ref.v_pad, y0 // 2 + REF_PAD // 2,
                                 x0 // 2 + REF_PAD // 2,
                                 int(mv[0]), int(mv[1]), bh // 2, bw // 2)
        return py, pu, pv

    # P partition geometry: mb_type -> list of (dr4, dc4, h4b, w4b)
    _P_PARTS = {
        0: [(0, 0, 4, 4)],
        1: [(0, 0, 2, 4), (2, 0, 2, 4)],          # 16x8 top, bottom
        2: [(0, 0, 4, 2), (0, 2, 4, 2)],          # 8x16 left, right
    }
    # sub_mb_type -> list of (dr4, dc4, h4b, w4b) within the 8x8
    _SUB_PARTS = {
        0: [(0, 0, 2, 2)],
        1: [(0, 0, 1, 2), (1, 0, 1, 2)],          # 8x4
        2: [(0, 0, 2, 1), (0, 1, 2, 1)],          # 4x8
        3: [(0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1)],
    }

    def _decode_mb_p(self, r: BitReader, pic: PictureState, addr: int,
                     qp: int, sid: int):
        mb_type = read_ue(r)
        if mb_type >= 5:
            return self._decode_mb_i(r, pic, addr, qp, sid,
                                     mb_type=mb_type - 5)
        mr, mc = addr // pic.wm, addr % pic.wm
        pic.slice_id[mr, mc] = sid
        g4r, g4c = mr * 4, mc * 4
        nref = len(self._list0)
        pic.set_motion(1, g4r, g4c, 4, 4, 0, mvpred.INTRA)
        pred_y = np.zeros((16, 16), dtype=np.int64)
        pred_u = np.zeros((8, 8), dtype=np.int64)
        pred_v = np.zeros((8, 8), dtype=np.int64)

        def mc_into(dr4, dc4, h4b, w4b, mv, ref_idx):
            py, pu, pv = self._weight_uni(self._mc_part(
                pic, mr * 16 + dr4 * 4, mc * 16 + dc4 * 4,
                h4b * 4, w4b * 4, mv, self._list0[ref_idx]), 0, ref_idx)
            pred_y[dr4 * 4:(dr4 + h4b) * 4, dc4 * 4:(dc4 + w4b) * 4] = py
            pred_u[dr4 * 2:(dr4 + h4b) * 2, dc4 * 2:(dc4 + w4b) * 2] = pu
            pred_v[dr4 * 2:(dr4 + h4b) * 2, dc4 * 2:(dc4 + w4b) * 2] = pv

        allow_t8 = True
        if mb_type in (0, 1, 2):
            parts = self._P_PARTS[mb_type]
            refs = [self._read_te(r, nref - 1) for _ in parts]
            for (dr4, dc4, h4b, w4b), ref_idx in zip(parts, refs):
                mvd_x = read_se(r)
                mvd_y = read_se(r)
                pred = self._mv_pred_part(pic, 0, ref_idx, g4r + dr4,
                                          g4c + dc4, h4b, w4b, sid)
                mv = pred + np.array([mvd_y, mvd_x], dtype=np.int64)
                pic.set_motion(0, g4r + dr4, g4c + dc4, h4b, w4b, mv,
                               ref_idx, pid=self._list0[ref_idx].uid)
                mc_into(dr4, dc4, h4b, w4b, mv, ref_idx)
        else:                          # 3 / 4: P_8x8 / P_8x8ref0
            subs = [read_ue(r) for _ in range(4)]
            if any(s > 3 for s in subs):
                raise ValueError(f"bad sub_mb_type {subs}")
            allow_t8 = all(s == 0 for s in subs)
            if mb_type == 3:
                refs = [self._read_te(r, nref - 1) for _ in range(4)]
            else:
                refs = [0, 0, 0, 0]
            for b8 in range(4):
                br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                for dr4, dc4, h4b, w4b in self._SUB_PARTS[subs[b8]]:
                    mvd_x = read_se(r)
                    mvd_y = read_se(r)
                    pred = self._mv_pred_part(
                        pic, 0, refs[b8], g4r + br4 + dr4,
                        g4c + bc4 + dc4, h4b, w4b, sid)
                    mv = pred + np.array([mvd_y, mvd_x], dtype=np.int64)
                    pic.set_motion(0, g4r + br4 + dr4, g4c + bc4 + dc4,
                                   h4b, w4b, mv, refs[b8],
                                   pid=self._list0[refs[b8]].uid)
                    mc_into(br4 + dr4, bc4 + dc4, h4b, w4b, mv, refs[b8])

        return self._parse_inter_residual(
            r, pic, mr, mc, qp, (pred_y, pred_u, pred_v), sid,
            allow_t8=allow_t8)

    def _recon_chroma_inter(self, r, pic, mr, mc, qp, cbp_chroma, preds, sid):
        cqp = rt.chroma_qp(qp, self.pps.chroma_qp_index_offset)
        y0, x0 = mr * 8, mc * 8
        dcs = []
        for comp in range(2):
            if cbp_chroma >= 1:
                dc_scan = cavlc.decode_block(r, -1, 4)
            else:
                dc_scan = np.zeros(4, dtype=np.int64)
            dcs.append(dc_scan.reshape(2, 2))
        acs = [[None] * 4 for _ in range(2)]
        for comp in range(2):
            for idx in range(4):
                by, bx = idx // 2, idx % 2
                gr, gc = mr * 2 + by, mc * 2 + bx
                if cbp_chroma == 2:
                    ncv = self._nc_chroma(pic, comp, gr, gc, sid)
                    ac = cavlc.decode_block(r, ncv, 15)
                    pic.chroma_tc[comp, gr, gc] = (ac != 0).sum()
                else:
                    ac = np.zeros(15, dtype=np.int64)
                    pic.chroma_tc[comp, gr, gc] = 0
                acs[comp][idx] = ac
        planes = (pic.u, pic.v)
        for comp in range(2):
            dc_deq = rt.hadamard2x2_inv_dequant_dc(
                dcs[comp], cqp, w00=self._w00(4 + comp))
            recon = np.zeros((8, 8), dtype=np.int64)
            for idx in range(4):
                by, bx = idx // 2, idx % 2
                coeff = np.zeros(16, dtype=np.int64)
                coeff[rt.ZIGZAG_4x4[1:]] = acs[comp][idx]
                recon[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = \
                    rt.residual_block_recon(coeff.reshape(4, 4), cqp,
                                            dc=int(dc_deq[by, bx]),
                                            ws=self._ws4(4 + comp))
            planes[comp][y0:y0 + 8, x0:x0 + 8] = \
                rt.clip1(preds[comp] + recon)


def decode_annexb(stream: bytes, conceal: bool = False, device=None):
    """Decode an Annex-B byte stream → list of (y, u, v) uint8 frames;
    the deblocking filter runs on `device` (the card when None)."""
    return Decoder(conceal=conceal, device=device).decode(stream)
