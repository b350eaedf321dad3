"""Band-tiled frame encoding over a grid of devices, counterpart of
`tpu264.runtime.tiled`.

Each device of a `tile` row owns a horizontal band of MB rows and encodes
it as an independent H.264 slice: slice boundaries cut the intra, vector
prediction and deblocking dependencies, so the only traffic between bands
is the reference halo (`PAD` = 24 luma and 12 chroma rows of each
neighbour band) that motion search reads across a band edge.  The `gop`
axis carries independent sequences.  One host process drives every band,
as the reference's single-controller program does: a band's step (wave
loop, in-loop deblock, entropy coding) runs on the band's device, the
reference's `ppermute` of the halo rows is a copy to that device, and
the colocated state of spatial direct stays on each band's device between
frames.  A device may appear in the grid more than once; its bands then
share it.

Covers what the reference's tiled path covers: all-intra, IPPP and
hierarchical-B GOPs, CAVLC and CABAC, JVT-G012 rate control per sequence
lane, in-loop deblocking inside each band (`disable_deblocking_filter_idc`
2, also with one band).  Each lane's stream is byte-identical to the
reference's `TiledEncoder` on the same mesh shape, and so to a
single-device encode with `slices_per_frame` = the number of bands where
the reference's two encoders agree.  As in the reference, the tiled path
writes no SEI and no weighted prediction.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu264_torch.bits import nal
from tpu264_torch.bits.slicehdr import SLICE_B, SLICE_I, SLICE_P, SliceHeader
from tpu264_torch.coding import encoder
from tpu264_torch.coding.b_frame import make_b_encoder
from tpu264_torch.coding.encoder import (FrameStats, Picture, _psnr3,
                                         b_colstate, build_bgop_plan,
                                         build_params, colstate_of,
                                         gop_mode_of, tools_of)
from tpu264_torch.coding.inter_frame import PAD, make_inter_encoder
from tpu264_torch.coding.intra_frame import (make_intra_encoder,
                                             reorder_wave_outputs)
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.kernels.deblock import make_deblocker_skewed
from tpu264_torch.runtime.ratectl import RateController


class Mesh:
    """A [gop, tile] grid of torch devices (axis names "gop" and "tile"),
    the counterpart of the reference's `jax.sharding.Mesh`."""

    axis_names = ("gop", "tile")

    def __init__(self, devices):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.shape = {"gop": len(self.devices),
                      "tile": len(self.devices[0])}


def make_mesh(n_devices: int | None = None, gop: int | None = None,
              devices=None) -> Mesh:
    """Default 2-axis mesh (gop x tile) over the first `n_devices` of
    `devices` (default: the visible cards; without one it raises).  A
    device may be listed more than once, e.g. `["cpu"] * 3` for three
    bands on the CPU or `["cuda:0"] * 4` for four bands on one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card (torch.cuda.is_available() is "
                "False); pass devices=[\"cpu\"] * n to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} devices asked for, "
                         f"{len(devices)} given")
    if gop is None:
        gop = 2 if n % 2 == 0 and n > 1 else 1
    if n % gop:
        raise ValueError(f"make_mesh: {n} devices are not {gop} lanes")
    tile = n // gop
    return Mesh([devices[g * tile:(g + 1) * tile] for g in range(gop)])


def band_halo(planes, t: int, pad: int, device):
    """Band `t` of `planes` (one plane of each band, top to bottom)
    extended by `pad` rows of its neighbour bands, copied to `device` (the
    frame's top and bottom edges replicate), then edge-padded by `pad`
    columns at the sides: the rows of the whole plane, edge-padded by
    `pad`, that the band's motion search reads."""
    band = planes[t]
    top = planes[t - 1][-pad:] if t > 0 else band[:1].expand(pad, -1)
    bot = (planes[t + 1][:pad] if t + 1 < len(planes)
           else band[-1:].expand(pad, -1))
    ext = torch.cat([top.to(device), band, bot.to(device)])
    return torch.cat([ext[:, :1].expand(-1, pad), ext,
                      ext[:, -1:].expand(-1, pad)], dim=1)


def band_refs(bands, t: int, device):
    """Band `t`'s PAD-extended reference planes (Y, U, V) from a picture's
    bands [(y, u, v), ...]."""
    return tuple(band_halo([b[c] for b in bands], t, pad, device)
                 for c, pad in ((0, PAD), (1, PAD // 2), (2, PAD // 2)))


class TiledEncoder:
    """Mesh-tiled encoder: `tile` axis = frame bands (H.264 slices), `gop`
    axis = independent sequences.

    `encode_sequence(seqs)` takes `G` sequences (lists of (y, u, v)
    uint8 planes) and returns `G` Annex-B streams.  After it, `stats[g]`
    holds lane g's `FrameStats` and `recons[g]` its reconstructed frames
    (the bands joined on the lane's first device), both in display
    order.  A mesh of CUDA devices needs a card and raises without one;
    a CPU mesh runs every kernel's plain torch version.
    """

    def __init__(self, cfg, mesh: Mesh):
        cfg.validate()
        for d in (d for row in mesh.devices for d in row):
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"TiledEncoder: device {str(d)!r} in the mesh, but "
                    "torch.cuda.is_available() is False; make the mesh of "
                    "\"cpu\" devices to run on the CPU")
        self.cfg, self.mesh = cfg, mesh
        self.gop_size = mesh.shape["gop"]
        self.n_tiles = n_tiles = mesh.shape["tile"]
        if cfg.height_mbs % n_tiles:
            raise ValueError(f"bands must be whole MB rows: {cfg.height_mbs} "
                             f"MB rows in {n_tiles} bands")
        self.band_hm = cfg.height_mbs // n_tiles
        # the halo of PAD luma rows must come from one neighbour band
        if self.band_hm < 2:
            raise ValueError(f"tile bands need >= 2 MB rows, not "
                             f"{self.band_hm}")
        wm = self.wm = cfg.width_mbs
        self.band_sched = build_schedule(wm, self.band_hm, 1)
        self.gop_mode = gop_mode_of(cfg)
        self.partitions, self.t8_mode, self.b_partitions = tools_of(
            cfg, self.gop_mode)
        self.sps, self.pps, self.cabac = build_params(cfg, self.gop_mode,
                                                      t8=self.t8_mode)
        self._enc_i = make_intra_encoder(self.band_sched)
        self._enc_p = make_inter_encoder(
            self.band_sched, search_range=cfg.search_range,
            ref_prepadded=True, partitions=self.partitions, t8=self.t8_mode,
            p8x8=self.partitions)
        self._enc_b = None
        if self.gop_mode == "bgop":
            self._enc_b = make_b_encoder(
                self.band_sched, search_range=cfg.search_range,
                ref_prepadded=True, partitions=self.b_partitions)
        # the bands are slices that filter only inside themselves
        self.deblock_idc = 1 if not cfg.deblock else 2
        self._deblock = None
        if cfg.deblock:
            self._deblock = make_deblocker_skewed(self.band_sched,
                                                  filter_across_slices=False)
        self.rcs = None
        if cfg.rate_control and cfg.bitrate > 0:
            self.rcs = [RateController(
                bitrate=cfg.bitrate, frame_rate=cfg.frame_rate,
                n_mbs=wm * cfg.height_mbs, init_qp=cfg.qp)
                for _ in range(self.gop_size)]
        band_n = wm * self.band_hm
        self._cabac_cap = band_n * encoder.RECORDS_PER_MB
        self._cap_words = band_n * encoder.WORDS_PER_MB
        self.pics = [[Picture(wm, self.band_hm, (0,), self.t8_mode, d)
                      for d in row] for row in mesh.devices]

    # ------------------------------------------------------------ a band

    def _band(self, g: int, t: int, kind: str, frame, refs, col, qp: int,
              allow_parts: bool):
        """Queue band `t` of lane `g`'s picture of slice kind `kind` on the
        band's device: `frame` the lane's (y, u, v) host planes, `refs`
        the reference pictures' bands (none for "i", list 0's for "p",
        both lists' for "b"), `col` the list-1 reference's colocated
        state of this band -> (queued entropy, recon planes, colocated
        state, sse3)."""
        pic = self.pics[g][t]
        dev = pic.device
        rows = self.band_hm * 16
        orig = tuple(
            torch.as_tensor(np.ascontiguousarray(p[t * r:(t + 1) * r]),
                            device=dev)
            for p, r in zip(frame, (rows, rows // 2, rows // 2)))
        if kind == "i":
            dev_out, ys = self._enc_i(*orig, qp)
        elif kind == "p":
            dev_out, ys = self._enc_p(*orig, *band_refs(refs[0], t, dev), qp)
        else:
            dev_out, ys = self._enc_b(*orig, *band_refs(refs[0], t, dev),
                                      *band_refs(refs[1], t, dev), *col, qp,
                                      allow_parts=allow_parts)
        mbd = reorder_wave_outputs(self.band_sched, ys)
        col_out = None
        if kind == "b":
            if self.t8_mode:
                # B MBs code the 4x4 transform: the flag goes out as 0
                mbd["t8"] = torch.zeros(pic.n_mbs, dtype=torch.bool,
                                        device=dev)
            col_out = b_colstate(mbd)
        elif self.gop_mode == "bgop":
            zero = torch.zeros(pic.n_mbs, dtype=torch.bool, device=dev)
            col_out = colstate_of(mbd) if kind == "p" else (zero, zero)
        queued = encoder.queue_entropy(pic, mbd, kind, self.cabac,
                                       self._cabac_cap, self._cap_words)
        recon = encoder.recon_planes(self._deblock, pic, dev_out, mbd, qp,
                                     kind)
        return queued, recon, col_out, encoder.sse3(orig, recon)

    # ------------------------------------------------------------ a frame

    def _frame(self, frames, kind: str, qps, refs=(), cols=None,
               allow_parts: bool = True, nal_ref_idc: int = 2, **hdr):
        """Code one frame of every lane, band by band (`frames[g]` lane
        g's planes, `refs` its reference pictures' bands per list and lane,
        `cols[g]` the list-1 reference's colocated state per band; `hdr`
        the slice header's frame fields) -> per lane (NAL units, recon
        bands, colocated state per band, [SSE Y, U, V, sum |Y - Y'|])."""
        G, T = self.gop_size, self.n_tiles
        steps = [[self._band(g, t, kind, frames[g],
                             [r[g] for r in refs],
                             None if cols is None else cols[g][t],
                             int(qps[g]), allow_parts)
                  for t in range(T)] for g in range(G)]
        slice_type = {"i": SLICE_I, "p": SLICE_P, "b": SLICE_B}[kind]
        is_idr = kind == "i"
        band_mbs = self.band_hm * self.wm
        out = []
        for g in range(G):
            nalus = []
            for t, (queued, *_) in enumerate(steps[g]):
                def head(s, t=t):
                    return SliceHeader(
                        first_mb_in_slice=t * band_mbs, slice_type=slice_type,
                        slice_qp=int(qps[g]), is_idr=is_idr,
                        disable_deblocking_filter_idc=self.deblock_idc,
                        nal_ref_idc=nal_ref_idc, **hdr,
                    ).write_rbsp_head(self.sps, self.pps)
                nalus += encoder.entropy_nalus(
                    self.pics[g][t], queued, int(qps[g]), kind, self.cabac,
                    self._cap_words, head, 3 if is_idr else nal_ref_idc,
                    nal.NAL_IDR if is_idr else nal.NAL_SLICE)
            sse = torch.stack([s[3].cpu() for s in steps[g]]).sum(0).tolist()
            out.append((nalus, [s[1] for s in steps[g]],
                        [s[2] for s in steps[g]], sse))
        return out

    # ------------------------------------------------------------ sequence

    def encode_sequence(self, seqs) -> list[bytes]:
        """seqs: G sequences of (y, u, v) frames. Returns G streams."""
        if len(seqs) != self.gop_size:
            raise ValueError(f"{len(seqs)} sequences for "
                             f"{self.gop_size} gop lanes")
        seqs = [[tuple(np.asarray(p) for p in f) for f in s] for s in seqs]
        nfr = len(seqs[0])
        if any(len(s) != nfr for s in seqs):
            raise ValueError("the lanes' sequences differ in length")
        head = [nal.make_nalu(3, nal.NAL_SPS, self.sps.write_rbsp()),
                nal.make_nalu(3, nal.NAL_PPS, self.pps.write_rbsp())]
        self._outs = [list(head) for _ in seqs]
        self.stats = [[None] * nfr for _ in seqs]
        self.recons = [[None] * nfr for _ in seqs]
        if self.gop_mode == "bgop":
            self._encode_bgop(seqs, nfr)
        else:
            self._encode_ip(seqs, nfr)
        return [b"".join(o) for o in self._outs]

    def _rc_qps(self, ftype: str, num_b: int = 0) -> list:
        cfg = self.cfg
        if self.rcs is None:
            base = cfg.qp if ftype == "I" else cfg.qp_inter
            return [base] * self.gop_size
        return [rc.frame_qp(ftype, num_b=num_b) for rc in self.rcs]

    def _finish(self, seqs, disp: int, stype: str, qps, coded, t0) -> list:
        """Append a coded frame's NAL units to each lane's stream, update
        the lane's rate controller (bits of the frame's NAL units, MAD over
        the frame's luma samples), keep its stats and its recon (the bands
        joined) -> the recon bands of every lane."""
        secs = time.monotonic() - t0
        for g, (nalus, bands, _, sse) in enumerate(coded):
            self._outs[g] += nalus
            bits = sum(8 * len(b) for b in nalus)
            y, u, v = seqs[g][disp]
            if self.rcs is not None:
                self.rcs[g].update("B" if stype.startswith("B") else stype,
                                   bits, float(sse[3]) / y.size)
            ps = _psnr3(sse, (y.size, u.size, v.size))
            self.stats[g][disp] = FrameStats(
                disp, "IDR" if stype == "I" else stype, bits, ps[0], ps[1],
                ps[2], secs, int(qps[g]))
            dev = bands[0][0].device
            self.recons[g][disp] = tuple(
                torch.cat([b[c].to(dev) for b in bands]) for c in range(3))
        return [c[1] for c in coded]

    def _encode_ip(self, seqs, nfr: int):
        period = self.cfg.intra_period
        recon = None
        frame_num = 0
        idr_count = 0
        for i in range(nfr):
            t0 = time.monotonic()
            frames = [s[i] for s in seqs]
            is_idr = i == 0 or period == 1 or (period > 1 and i % period == 0)
            qps = self._rc_qps("I" if is_idr else "P")
            if is_idr:
                coded = self._frame(frames, "i", qps, frame_num=0,
                                    idr_pic_id=idr_count % 2)
                idr_count += 1
                frame_num = 1
            else:
                coded = self._frame(frames, "p", qps, refs=(recon,),
                                    frame_num=frame_num)
                frame_num = (frame_num + 1) % (
                    1 << self.sps.log2_max_frame_num)
            recon = self._finish(seqs, i, "I" if is_idr else "P", qps, coded,
                                 t0)

    def _encode_bgop(self, seqs, nfr: int):
        """Hierarchical-B coding over the mesh: the plan, headers and QP
        ladder of `Encoder`'s B GOPs, a rate controller per lane."""
        cfg = self.cfg
        plan = build_bgop_plan(nfr, cfg.num_b_frames, cfg.intra_period)
        hier = cfg.num_b_frames >= 2
        G = self.gop_size
        recons = {}                    # display -> recon bands per lane
        col_of = {}                    # display -> colocated state
        fn = 0
        idr_count = 0
        disp_base = 0
        fn_of = {}
        last_ref_fn = 0
        max_lsb = 1 << self.sps.log2_max_pic_order_cnt_lsb
        max_fn = 1 << self.sps.log2_max_frame_num
        anchor_qp = [cfg.qp_inter] * G
        # the last plan position that references each picture
        needed_until = {}
        for pi, (_, _, r0, r1, _) in enumerate(plan):
            for r in (r0, r1):
                if r is not None:
                    needed_until[r] = pi
        for pi, (disp, kind, r0, r1, layer) in enumerate(plan):
            t0 = time.monotonic()
            frames = [s[disp] for s in seqs]
            poc = (2 * (disp - disp_base)) % max_lsb
            if kind == "I":
                qps = anchor_qp = self._rc_qps("I")
                disp_base = disp
                coded = self._frame(frames, "i", qps, frame_num=0,
                                    idr_pic_id=idr_count % 2,
                                    pic_order_cnt_lsb=0)
                idr_count += 1
                fn_of[disp] = last_ref_fn = 0
                fn = 1
            elif kind == "P":
                qps = anchor_qp = self._rc_qps("P", num_b=cfg.num_b_frames)
                reorder = ()
                if hier and fn_of.get(r0) is not None \
                        and last_ref_fn != fn_of[r0]:
                    # point list0[0] back at the previous anchor
                    reorder = ((0, (fn - fn_of[r0]) % max_fn - 1),)
                coded = self._frame(frames, "p", qps, refs=(recons[r0],),
                                    frame_num=fn, pic_order_cnt_lsb=poc,
                                    reorder_l0=reorder)
                fn_of[disp] = last_ref_fn = fn
                fn = (fn + 1) % max_fn
            else:
                # the pyramid QP ladder: QPBSlice at layer 1, +1 a layer
                # below; with rate control it rides the lane's anchor QP
                base_b = ([min(q + 2, 51) for q in anchor_qp] if self.rcs
                          else [cfg.qp_bslice] * G)
                qps = [min(b + layer - 1, 51) for b in base_b]
                is_ref = kind == "Bref"
                coded = self._frame(
                    frames, "b", qps, refs=(recons[r0], recons[r1]),
                    cols=col_of[r1], allow_parts=not is_ref, frame_num=fn,
                    pic_order_cnt_lsb=poc, nal_ref_idc=2 if is_ref else 0)
                if is_ref:
                    fn_of[disp] = last_ref_fn = fn
                    fn = (fn + 1) % max_fn
            recons[disp] = self._finish(seqs, disp, kind, qps, coded, t0)
            col_of[disp] = [c[2] for c in coded]
            # free the pictures that no later plan entry references
            for r in list(recons):
                if needed_until.get(r, -1) <= pi and r != disp:
                    del recons[r]
                    col_of.pop(r, None)
