"""Sequence-level encoder (torch), counterpart of
`tpu264.coding.encoder` for all-intra GOPs (CABAC or CAVLC) and for IPPP
GOPs with CAVLC and the 16x16 partition.

Parameter-set emission, per-frame device encode (wavefront mode decision
with kernels K2/K3, motion search and the P wave body, the wavefront
deblocker with K4, then either CABAC binarization and the range coder K1
or the CAVLC serializer and bit packer), Annex-B assembly and per-frame
stats.  All-intra CAVLC sequences go through the batched entry, which
pulls a chunk of frames' payloads from the device at once.  The encoder
runs on the CUDA card unless the caller asks for `device="cpu"`.

Not ported yet; the constructor raises `NotImplementedError` naming the
ROADMAP item that brings each: IPPP with CABAC, the default IPPP tools
(16x8/8x16 and P_8x8 partitions, the 8x8 transform, weighted
prediction), B GOPs, rate control and SEI messages.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from tpu264_torch.bits import nal
from tpu264_torch.bits.params import PPS, SPS
from tpu264_torch.bits.slicehdr import SLICE_I, SLICE_P, SliceHeader
from tpu264_torch.config import EncoderConfig
from tpu264_torch.entropy import cabac_binarize as cbz
from tpu264_torch.entropy import cabac_engine_cuda as k1
from tpu264_torch.entropy import device_cavlc as dcav
from tpu264_torch.entropy.device_cavlc import compute_cbp, luma_tc_grid
from tpu264_torch.entropy.slice_writer import trailing_skip_run
from tpu264_torch.kernels.deblock import make_deblocker_skewed
from tpu264_torch.ref.transform import chroma_qp
from . import mvpred
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


def build_params(cfg: EncoderConfig, gop_mode: str = "intra"):
    """SPS/PPS of an all-intra or IPPP stream (the parameter sets the
    reference's `build_params` writes for these GOP modes without the 8x8
    transform and weighted prediction) -> (sps, pps, cabac)."""
    if gop_mode not in ("intra", "ippp"):
        raise NotImplementedError(
            f"build_params: gop_mode {gop_mode!r} is not ported yet "
            "(ROADMAP Queue 1: hierarchical-B GOPs)")
    sps = SPS(
        profile_idc=cfg.profile_idc,
        constraint_flags=0xC0 if cfg.profile_idc == 66 else 0,
        level_idc=cfg.level_idc,
        pic_order_cnt_type=2,
        max_num_ref_frames=max(1, cfg.num_ref_frames),
        pic_width_in_mbs=cfg.width_mbs,
        pic_height_in_map_units=cfg.height_mbs,
    )
    cabac = cfg.symbol_mode.upper() == "CABAC"
    if cabac and sps.profile_idc == 66:
        # CABAC requires Main/High (spec A.2.1); signal Main instead
        sps.profile_idc = 77
        sps.constraint_flags = 0
    pps = PPS(
        entropy_coding_mode_flag=1 if cabac else 0,
        pic_init_qp=26,
        deblocking_filter_control_present_flag=1,
    )
    return sps, pps, cabac


def _psnr3(sse, sizes):
    return tuple(99.99 if s == 0 else
                 10 * np.log10(255.0 ** 2 * npx / float(s))
                 for s, npx in zip(sse, sizes))


class Encoder:
    """H.264 encoder: all-intra GOPs with CABAC or CAVLC, IPPP GOPs with
    CAVLC (P_Skip / P_L0_16x16 / I16x16 / I4x4 per MB, full-search ME
    with quarter-pel refinement, periodic IDR), optional in-loop
    deblocking, 1 or several slices.

    `gop_mode`: "intra" = every frame IDR; "ippp" = first frame IDR, rest
    P (`cfg.intra_period > 1` inserts periodic IDR frames).  The default
    follows `cfg.intra_period` as in the reference.  IPPP needs
    `cfg.inter_partitions=False` and `cfg.transform_8x8=False` (the
    reference turns both on by default for IPPP) and no weighted
    prediction, until those tools are ported.
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
            if cfg.num_b_frames > 0 and cfg.intra_period != 1:
                gop_mode = "bgop"
            else:
                gop_mode = "intra" if cfg.intra_period == 1 else "ippp"
        cabac = cfg.symbol_mode.upper() == "CABAC"
        if gop_mode not in ("intra", "ippp"):
            raise NotImplementedError(
                f"gop_mode {gop_mode!r}: B GOPs are not ported yet "
                "(ROADMAP Queue 1: hierarchical-B GOPs)")
        if gop_mode == "ippp":
            if cabac:
                raise NotImplementedError(
                    "IPPP with CABAC is not ported yet (ROADMAP Queue 1: "
                    "CABAC P path); IPPP runs with symbol_mode=\"CAVLC\"")
            # the reference's defaults for IPPP: partitions and the 8x8
            # transform on unless the config says False
            unported = [name for name, on in (
                ("inter_partitions", cfg.inter_partitions is not False),
                ("transform_8x8", cfg.transform_8x8 is not False),
                ("weighted_pred", bool(cfg.weighted_pred))) if on]
            if unported:
                raise NotImplementedError(
                    f"IPPP with {', '.join(unported)} on is not ported yet "
                    "(ROADMAP Queue 1: default IPPP tools).  The reference "
                    "turns inter_partitions and transform_8x8 on by default "
                    "for IPPP: pass inter_partitions=False, "
                    "transform_8x8=False (and weighted_pred=False)")
        if cfg.rate_control:
            raise NotImplementedError(
                "rate control is not ported yet (ROADMAP Queue 1: "
                "hierarchical-B GOPs with rate control)")
        if cfg.sei_messages:
            raise NotImplementedError(
                "SEI messages are not ported yet (ROADMAP Queue 1: host "
                "runtime and CLI)")
        self.gop_mode = gop_mode
        self.intra_batch = max(1, int(intra_batch))
        self.sched = build_schedule(cfg.width_mbs, cfg.height_mbs,
                                    cfg.slices_per_frame)
        self.sps, self.pps, self.cabac = build_params(cfg, gop_mode)
        self._encode_frame = make_intra_encoder(self.sched)
        self._encode_p = None
        if gop_mode == "ippp":
            self._encode_p = make_inter_encoder(
                self.sched, search_range=cfg.search_range)
        # in-loop deblocking: idc 0 (on) single-slice, idc 2 (slice-local)
        # multi-slice, idc 1 (off) when disabled
        self.deblock_idc = (1 if not cfg.deblock
                            else (0 if cfg.slices_per_frame == 1 else 2))
        self._deblock = None
        if cfg.deblock:
            self._deblock = make_deblocker_skewed(
                self.sched, filter_across_slices=(self.deblock_idc == 0))
        self.stats: list[FrameStats] = []
        per_slice = (cfg.width_mbs * cfg.height_mbs) // cfg.slices_per_frame
        self._cabac_cap = per_slice * records_per_mb
        self._cap_words = per_slice * WORDS_PER_MB

    def _cabac_records(self, mbd):
        """Binarize + compact on device: packed records [S, cap], counts.

        A slice over the record cap (pathological content) keeps every
        record: the same record grids are compacted again with room for
        the largest slice, so the stream is the one an unbounded buffer
        gives (the reference re-binarizes such a frame on the host)."""
        cfg = self.cfg
        rows = self.sched.slice_starts.tolist()
        k, a, b, v = cbz.binarize_frame(mbd, cfg.width_mbs, cfg.height_mbs,
                                        rows)
        recs, counts = cbz.compact_slices(k, a, b, v, cfg.width_mbs, rows,
                                          cfg.height_mbs, self._cabac_cap)
        need = int(counts.max())
        if need > self._cabac_cap:
            recs, counts = cbz.compact_slices(k, a, b, v, cfg.width_mbs,
                                              rows, cfg.height_mbs, need)
        return recs, counts

    def _cabac_payloads(self, recs, counts, qp: int) -> list:
        """CABAC slice payloads through the range coder (kernel K1)."""
        init = torch.as_tensor(k1.init_packed_states(0, qp),
                               device=recs.device)
        words, nbytes = k1.encode_slices(recs, counts, init, self._cap_words)
        return k1.payloads_from_words(words, nbytes)

    def _deblock_inputs(self, mbd, is_inter=None, mv=None):
        """The deblocker's bS inputs (intra_mb, tc_luma, mv, ref), derived
        on device from the raster MB dict; `is_inter` [n] and `mv` [n, 2]
        give a P picture's single-list motion (an all-intra picture
        without them)."""
        cfg = self.cfg
        wm, hm = cfg.width_mbs, cfg.height_mbs
        n = wm * hm
        if is_inter is None:
            is_inter = torch.zeros(n, dtype=torch.bool, device=self.device)
        if mv is None:
            mv = torch.zeros((n, 2), dtype=torch.int32, device=self.device)
        cbp_luma, _, _ = compute_cbp(mbd["sel16"].to(torch.bool),
                                     mbd["luma_ac"], mbd["chroma_dc"],
                                     mbd["chroma_ac"])
        tc = luma_tc_grid(mbd, cbp_luma, wm, hm)
        mv_grid = torch.where(is_inter[:, None], mv, 0).reshape(hm, wm, 2)
        ref_grid = torch.where(is_inter, 0, mvpred.INTRA).to(torch.int32) \
            .reshape(hm, wm)
        return (~is_inter).reshape(hm, wm), tc, mv_grid, ref_grid

    def _apply_deblock(self, dev_out, mbd, qp: int, is_inter=None, mv=None):
        """In-loop filter of a picture; the filtered planes stay on
        device."""
        fy, fu, fv = self._deblock(
            dev_out["recon_y"], dev_out["recon_u"], dev_out["recon_v"],
            *self._deblock_inputs(mbd, is_inter, mv), qp, chroma_qp(qp))
        return (fy.to(torch.uint8), fu.to(torch.uint8), fv.to(torch.uint8))

    def _recon(self, dev_out, mbd, qp: int, is_inter=None, mv=None):
        """The picture that is output and referenced: deblocked where the
        config asks for it."""
        if self.cfg.deblock:
            return self._apply_deblock(dev_out, mbd, qp, is_inter, mv)
        return tuple(dev_out[k].to(torch.uint8)
                     for k in ("recon_y", "recon_u", "recon_v"))

    def _serialize(self, mbd, p_slice: bool):
        """CAVLC serialize + pack on device -> (words, nbits, skipped)."""
        cfg = self.cfg
        rows = self.sched.slice_starts.tolist()
        if p_slice:
            v, ln, skipped = dcav.serialize_frame_p(
                mbd, cfg.width_mbs, cfg.height_mbs, rows)
        else:
            v, ln = dcav.serialize_frame(mbd, cfg.width_mbs, cfg.height_mbs,
                                         rows)
            skipped = None
        words, nbits = dcav.pack_slices(v, ln, cfg.slices_per_frame,
                                        self._cap_words)
        return words, nbits, skipped

    def _slice_header(self, s: int, slice_type: int, qp: int, **kw):
        """The BitSink holding slice `s`'s header."""
        cfg = self.cfg
        rows_per_slice = cfg.height_mbs // cfg.slices_per_frame
        hdr = SliceHeader(
            first_mb_in_slice=s * rows_per_slice * cfg.width_mbs,
            slice_type=slice_type, slice_qp=qp,
            disable_deblocking_filter_idc=self.deblock_idc, **kw)
        return hdr.write_rbsp_head(self.sps, self.pps)

    def _cavlc_nalus(self, words_np, nbits_np, skipped_np, hdr, nal_ref_idc,
                     nal_type):
        """One frame's NAL units from its pulled slice words [S, W] and
        bit counts [S]; `hdr(s)` gives slice s's header sink, `skipped_np`
        [n] (P slices) the MBs whose trailing run the host appends."""
        cfg = self.cfg
        per_slice = (cfg.width_mbs * cfg.height_mbs) // cfg.slices_per_frame
        nalus = []
        for s in range(cfg.slices_per_frame):
            tail = None
            if skipped_np is not None:
                tail = trailing_skip_run(skipped_np, s * per_slice,
                                         (s + 1) * per_slice)
            nb = int(nbits_np[s])
            rbsp = dcav.words_to_rbsp(words_np[s, :(nb + 31) // 32], nb,
                                      hdr(s), final_skip_run=tail)
            nalus.append(nal.make_nalu(nal_ref_idc, nal_type, rbsp))
        return nalus

    @staticmethod
    def _sse3(orig, recon):
        """[SSE Y, SSE U, SSE V] of the frame, an int64 tensor on the
        device."""
        return torch.stack([((o.to(torch.int64) - r.to(torch.int64)) ** 2)
                            .sum() for o, r in zip(orig, recon)])

    def _header_nalus(self) -> list:
        """SPS + PPS that open every stream."""
        return [nal.make_nalu(3, nal.NAL_SPS, self.sps.write_rbsp()),
                nal.make_nalu(3, nal.NAL_PPS, self.pps.write_rbsp())]

    def _encode_sequence_intra_batched(self, frames, batch: int) -> bytes:
        """All-IDR CAVLC sequence in chunks of `batch` frames; the stream
        is identical to the per-frame path's.

        A chunk's frames go through the per-frame device path one after
        another (wave launches that carry several frames' lanes are not
        built yet); what the chunk shares is the pull: one transfer each
        of the bit counts, the packed words and the SSEs of all its
        frames, after the device work of all of them is queued.
        `FrameStats.seconds` is the chunk's time over its frames.  The
        reference pads a short last chunk with copies of its last frame to
        keep one compiled shape and drops their output; there is no shape
        to keep here, so a short chunk encodes just its frames."""
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
            words, nbits, sse = [], [], []
            for y, u, v in chunk:
                orig = self._to_device(y, u, v)
                dev_out, ys = self._encode_frame(*orig, qp)
                mbd = reorder_wave_outputs(self.sched, ys)
                w, nb, _ = self._serialize(mbd, p_slice=False)
                recon = self._recon(dev_out, mbd, qp)
                words.append(w)
                nbits.append(nb)
                sse.append(self._sse3(orig, recon))
                self.recons.append(recon)
            nbits_np = torch.stack(nbits).cpu().numpy()   # syncs the device
            sse_np = torch.stack(sse).cpu().numpy()
            words_np = _pull_words(torch.stack(words), nbits_np)
            per_frame_s = (time.monotonic() - t0) / len(chunk)
            for b, (y, u, v) in enumerate(chunk):
                i = c0 + b
                nalus = self._cavlc_nalus(
                    words_np[b], nbits_np[b], None,
                    lambda s: self._slice_header(
                        s, SLICE_I, qp, frame_num=0, idr_pic_id=i % 2,
                        is_idr=True),
                    3, nal.NAL_IDR)
                out.extend(nalus)
                bits = sum(8 * len(x) for x in nalus)
                ps = _psnr3(sse_np[b], (y.size, u.size, v.size))
                self.stats.append(FrameStats(
                    i, "IDR", bits, ps[0], ps[1], ps[2], per_frame_s))
            c0 += len(chunk)
        return b"".join(out)

    def encode_sequence(self, frames) -> bytes:
        """frames: iterable of (y, u, v) uint8 planes. Returns Annex-B."""
        if (self.gop_mode == "intra" and not self.cabac
                and self.intra_batch > 1):
            # batched entry: consume the iterable in chunks (frames stay
            # streamed); a single frame takes the per-frame path
            it = iter(frames)
            head = list(itertools.islice(it, 2))
            if len(head) > 1:
                return self._encode_sequence_intra_batched(
                    itertools.chain(head, it), self.intra_batch)
            frames = head
        out = self._header_nalus()
        self.recons = []
        frame_num = 0
        idr_count = 0
        # frame pipelining: the entropy pull + NAL assembly of frame k
        # runs after frame k+1's device work has been queued
        pending = None     # (index, is_idr, finish, sse, sizes, t0)

        def drain():
            nonlocal pending
            if pending is None:
                return
            i0, idr0, fin, sse, sizes, t0 = pending
            pending = None
            nalus = fin()
            out.extend(nalus)
            bits = sum(8 * len(b) for b in nalus)
            ps = _psnr3(sse.tolist(), sizes)
            self.stats.append(FrameStats(
                i0, "IDR" if idr0 else "P", bits, ps[0], ps[1], ps[2],
                time.monotonic() - t0))

        period = self.cfg.intra_period
        for i, (y, u, v) in enumerate(frames):
            t0 = time.monotonic()
            is_idr = (self.gop_mode == "intra" or i == 0
                      or (period > 1 and i % period == 0))
            if is_idr:
                fin, recon = self.encode_intra_frame(
                    y, u, v, idr_pic_id=idr_count % 2)
                idr_count += 1
                frame_num = 1
            else:
                fin, recon = self.encode_p_frame(
                    y, u, v, self.recons[-1], frame_num=frame_num)
                frame_num = (frame_num + 1) % (
                    1 << self.sps.log2_max_frame_num)
            self.recons.append(recon)
            sse = self._sse3(self._dev_orig, recon)
            drain()
            pending = (i, is_idr, fin, sse, (y.size, u.size, v.size), t0)
        drain()
        return b"".join(out)

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
        if self.cabac:
            recs, counts = self._cabac_records(mbd)
        else:
            words, nbits, _ = self._serialize(mbd, p_slice=False)
        recon = self._recon(dev_out, mbd, qp)

        def finish():
            if not self.cabac:
                nbits_np = nbits.cpu().numpy()
                return self._cavlc_nalus(_pull_words(words, nbits_np),
                                         nbits_np, None, hdr_sink, 3,
                                         nal.NAL_IDR)
            payloads = self._cabac_payloads(recs, counts, qp)
            nalus = []
            for s in range(cfg.slices_per_frame):
                sink = hdr_sink(s)
                sink.cabac_align()
                nalus.append(nal.make_nalu(
                    3, nal.NAL_IDR, sink.to_bytes() + payloads[s]))
            return nalus

        return finish, recon

    def encode_p_frame(self, y, u, v, ref, frame_num: int,
                       qp: int | None = None, poc_lsb: int = 0,
                       reorder_l0: tuple = (), mmco: tuple = ()):
        """Queue one P frame's device work against `ref` = (y, u, v) recon
        planes -> (finish, recon).  `finish()` pulls the packed words and
        the skip map and returns the frame's NAL units.  `reorder_l0` and
        `mmco` go into the slice header as given (B GOPs will use them)."""
        cfg = self.cfg
        if qp is None:
            qp = cfg.qp_inter
        self._dev_orig = self._to_device(y, u, v)
        ref = tuple(torch.as_tensor(p, device=self.device) for p in ref)
        dev_out, ys = self._encode_p(*self._dev_orig, *ref, qp)

        def hdr_sink(s):
            return self._slice_header(
                s, SLICE_P, qp, frame_num=frame_num,
                pic_order_cnt_lsb=poc_lsb, is_idr=False, nal_ref_idc=2,
                reorder_l0=reorder_l0, mmco=mmco)

        mbd = reorder_wave_outputs(self.sched, ys)
        words, nbits, skipped = self._serialize(mbd, p_slice=True)
        recon = self._recon(dev_out, mbd, qp,
                            is_inter=mbd["is_inter"].to(torch.bool),
                            mv=mbd["mv"].to(torch.int32))

        def finish():
            nbits_np = nbits.cpu().numpy()
            return self._cavlc_nalus(_pull_words(words, nbits_np), nbits_np,
                                     skipped.cpu().numpy(), hdr_sink, 2,
                                     nal.NAL_SLICE)

        return finish, recon


def _pull_words(words, nbits_np) -> np.ndarray:
    """Device->host transfer of packed slice words [..., cap], cut to the
    word count that covers the longest slice (the reference rounds that
    up to a power of two to bound its number of compiled slice
    programs; there are none here)."""
    need = (int(nbits_np.max()) + 31) // 32
    return words[..., :need].cpu().numpy().astype(np.uint32)
