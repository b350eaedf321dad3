"""Sequence-level encoder (torch), counterpart of
`tpu264.coding.encoder` restricted to all-intra GOPs with CABAC.

Parameter-set emission, per-frame device encode (wavefront mode decision
with kernels K2/K3, the wavefront deblocker with K4, CABAC binarization and
the range coder K1), Annex-B assembly and per-frame stats.  The encoder
runs on the CUDA card unless the caller asks for `device="cpu"`.

Not ported yet; the constructor raises `NotImplementedError` naming the
ROADMAP item that brings each: P and B GOPs, CAVLC (and with it the
batched all-intra path, which the reference takes only for CAVLC), rate
control and SEI messages.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpu264_torch.bits import nal
from tpu264_torch.bits.params import PPS, SPS
from tpu264_torch.bits.slicehdr import SLICE_I, SliceHeader
from tpu264_torch.config import EncoderConfig
from tpu264_torch.entropy import cabac_binarize as cbz
from tpu264_torch.entropy import cabac_engine_cuda as k1
from tpu264_torch.entropy.device_cavlc import compute_cbp, luma_tc_grid
from tpu264_torch.kernels.deblock import intra_motion, make_deblocker_skewed
from tpu264_torch.ref.transform import chroma_qp
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


def build_params(cfg: EncoderConfig):
    """SPS/PPS of an all-intra stream (the parameter sets the reference's
    `build_params` writes for `gop_mode == "intra"`)."""
    sps = SPS(
        profile_idc=cfg.profile_idc,
        constraint_flags=0xC0 if cfg.profile_idc == 66 else 0,
        level_idc=cfg.level_idc,
        pic_order_cnt_type=2,
        max_num_ref_frames=max(1, cfg.num_ref_frames),
        pic_width_in_mbs=cfg.width_mbs,
        pic_height_in_map_units=cfg.height_mbs,
    )
    if sps.profile_idc == 66:
        # CABAC requires Main/High (spec A.2.1); signal Main instead
        sps.profile_idc = 77
        sps.constraint_flags = 0
    pps = PPS(
        entropy_coding_mode_flag=1,
        pic_init_qp=26,
        deblocking_filter_control_present_flag=1,
    )
    return sps, pps


class Encoder:
    """All-intra CABAC H.264 encoder with optional in-loop deblocking.

    `device`: where the frame encode runs: "cuda" (the default) runs the
    CUDA kernels and raises where there is no card; "cpu", which a caller
    must ask for, runs every kernel's plain torch version.
    `records_per_mb`: room of a slice's CABAC record buffer per MB; a
    slice that needs more is compacted again at its true size.
    """

    def __init__(self, cfg: EncoderConfig, gop_mode: str | None = None,
                 device="cuda", records_per_mb: int = RECORDS_PER_MB):
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
        if gop_mode != "intra":
            raise NotImplementedError(
                f"gop_mode {gop_mode!r}: P and B GOPs are not ported yet "
                "(ROADMAP Queue 1: IPPP, then hierarchical-B GOPs)")
        if cfg.symbol_mode.upper() != "CABAC":
            raise NotImplementedError(
                "CAVLC and the batched all-intra path are not ported yet "
                "(ROADMAP Queue 1: CAVLC I path, then the batched intra "
                "path)")
        if cfg.rate_control:
            raise NotImplementedError(
                "rate control is not ported yet (ROADMAP Queue 1: "
                "hierarchical-B GOPs with rate control)")
        if cfg.sei_messages:
            raise NotImplementedError(
                "SEI messages are not ported yet (ROADMAP Queue 1: host "
                "runtime and CLI)")
        self.sched = build_schedule(cfg.width_mbs, cfg.height_mbs,
                                    cfg.slices_per_frame)
        self.sps, self.pps = build_params(cfg)
        self._encode_frame = make_intra_encoder(self.sched)
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

    def _deblock_inputs(self, mbd):
        """The deblocker's bS inputs (intra_mb, tc_luma, mv, ref) of an
        all-intra picture, derived on device from the raster MB dict."""
        cfg = self.cfg
        wm, hm = cfg.width_mbs, cfg.height_mbs
        cbp_luma, _, _ = compute_cbp(mbd["sel16"].to(torch.bool),
                                     mbd["luma_ac"], mbd["chroma_dc"],
                                     mbd["chroma_ac"])
        tc = luma_tc_grid(mbd, cbp_luma, wm, hm)
        intra_mb = torch.ones((hm, wm), dtype=torch.bool, device=self.device)
        return (intra_mb, tc, *intra_motion(hm, wm, self.device))

    def _apply_deblock(self, dev_out, mbd, qp: int):
        """In-loop filter of an all-intra picture; the filtered planes stay
        on device."""
        fy, fu, fv = self._deblock(
            dev_out["recon_y"], dev_out["recon_u"], dev_out["recon_v"],
            *self._deblock_inputs(mbd), qp, chroma_qp(qp))
        return (fy.to(torch.uint8), fu.to(torch.uint8), fv.to(torch.uint8))

    @staticmethod
    def _sse3(orig, recon):
        """[SSE Y, SSE U, SSE V] of the frame as host ints."""
        return [int(((o.to(torch.int64) - r.to(torch.int64)) ** 2).sum())
                for o, r in zip(orig, recon)]

    def _header_nalus(self) -> list:
        """SPS + PPS that open every stream."""
        return [nal.make_nalu(3, nal.NAL_SPS, self.sps.write_rbsp()),
                nal.make_nalu(3, nal.NAL_PPS, self.pps.write_rbsp())]

    def encode_sequence(self, frames) -> bytes:
        """frames: iterable of (y, u, v) uint8 planes. Returns Annex-B."""
        out = self._header_nalus()
        self.recons = []
        # frame pipelining: the entropy pull + NAL assembly of frame k
        # runs after frame k+1's device work has been queued
        pending = None     # (index, finish, orig, recon, sizes, t0)

        def drain():
            nonlocal pending
            if pending is None:
                return
            i0, fin, orig, recon, sizes, t0 = pending
            pending = None
            nalus = fin()
            out.extend(nalus)
            bits = sum(8 * len(b) for b in nalus)
            ps = tuple(
                99.99 if s == 0 else
                10 * np.log10(255.0 ** 2 * npx / float(s))
                for s, npx in zip(self._sse3(orig, recon), sizes))
            self.stats.append(FrameStats(
                i0, "IDR", bits, ps[0], ps[1], ps[2],
                time.monotonic() - t0))

        for i, (y, u, v) in enumerate(frames):
            t0 = time.monotonic()
            fin, recon = self.encode_intra_frame(y, u, v, idr_pic_id=i % 2)
            self.recons.append(recon)
            drain()
            pending = (i, fin, self._dev_orig, recon,
                       (y.size, u.size, v.size), t0)
        drain()
        return b"".join(out)

    def encode_intra_frame(self, y, u, v, idr_pic_id: int = 0):
        """Queue one IDR frame's device work -> (finish, (recY, recU, recV)).

        `finish()` runs K1, pulls the payloads and returns the frame's NAL
        units; `encode_sequence` calls it after the next frame is queued."""
        cfg = self.cfg
        qp = cfg.qp
        dev = self.device
        yd, ud, vd = (torch.as_tensor(np.asarray(p), device=dev)
                      for p in (y, u, v))
        self._dev_orig = (yd, ud, vd)
        dev_out, ys = self._encode_frame(yd, ud, vd, qp)
        rows_per_slice = cfg.height_mbs // cfg.slices_per_frame

        def hdr_sink(s):
            hdr = SliceHeader(
                first_mb_in_slice=s * rows_per_slice * cfg.width_mbs,
                slice_type=SLICE_I,
                frame_num=0,
                idr_pic_id=idr_pic_id,
                slice_qp=qp,
                disable_deblocking_filter_idc=self.deblock_idc,
                is_idr=True,
            )
            return hdr.write_rbsp_head(self.sps, self.pps)

        mbd = reorder_wave_outputs(self.sched, ys)
        recs, counts = self._cabac_records(mbd)
        if cfg.deblock:
            recon = self._apply_deblock(dev_out, mbd, qp)
        else:
            recon = tuple(dev_out[k].to(torch.uint8)
                          for k in ("recon_y", "recon_u", "recon_v"))

        def finish():
            payloads = self._cabac_payloads(recs, counts, qp)
            nalus = []
            for s in range(cfg.slices_per_frame):
                sink = hdr_sink(s)
                sink.cabac_align()
                nalus.append(nal.make_nalu(
                    3, nal.NAL_IDR, sink.to_bytes() + payloads[s]))
            return nalus

        return finish, recon
