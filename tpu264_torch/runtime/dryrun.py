"""Top-level entry points of the port, counterpart of the reference's
`__graft_entry__.py`: a one-frame check of the all-intra QCIF path
(`entry`) and the multi-device dry run of the band-tiled config-4
pipeline with a decode of every stream (`dryrun_multichip`).

On one card, `dryrun_multichip(4, devices=["cuda"] * 4)` lays the
[gop, tile] mesh over that card:

    python -c "from tpu264_torch.runtime.dryrun import dryrun_multichip; \
dryrun_multichip(4, devices=['cuda'] * 4)"

Both default to the card and raise where there is none; the CPU runs them
only when asked (`entry("cpu")`, `devices=["cpu"] * n`).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig
from tpu264_torch.decode.decoder import decode_annexb
from tpu264_torch.media.synth import synth_frame
from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh

ENTRY_W, ENTRY_H, ENTRY_QP = 176, 144, 28
DRYRUN_FRAMES = 5               # frames a lane
DRYRUN_LANE_STRIDE = 7          # lane g takes synth_frame(w, h, t + 7 g)


def dryrun_config(width: int, tile: int) -> EncoderConfig:
    """The dry run's config: config 4's tools (hierarchical B with two B
    frames, CABAC, deblocking, rate control at 2 Mb/s) on a picture
    `width` wide and 4 MB rows a band high."""
    return EncoderConfig(width=width, height=64 * tile, qp=30,
                         intra_period=0, num_b_frames=2, symbol_mode="CABAC",
                         deblock=True, rate_control=True, bitrate=2_000_000)


def entry(device="cuda"):
    """One all-intra QCIF frame at QP 28 (`synth_frame(176, 144, 0)`)
    through the port's I-frame path on `device` -> (fn, args).

    `fn(*args)` -> (Annex-B stream, (recon Y, U, V)): the wave loop (K2 +
    K3 a wave), the in-loop deblocking (K4 a wave) and CAVLC of `Encoder`
    (the default config: CAVLC, deblocking on).  A torch program is not
    compiled, so the check is the call itself on the device given."""
    enc = Encoder(EncoderConfig(width=ENTRY_W, height=ENTRY_H, qp=ENTRY_QP),
                  device=device)

    def fn(y, u, v, qp):
        finish, recon = enc.encode_intra_frame(y, u, v, qp=int(qp))
        return b"".join(enc._header_nalus() + finish()), recon

    y, u, v = synth_frame(ENTRY_W, ENTRY_H, 0)
    return fn, (y, u, v, np.int32(ENTRY_QP))


def _sync(devices) -> None:
    for d in {d for row in devices for d in row if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def dryrun_multichip(n_devices: int, devices=None, width: int = 1280) -> dict:
    """The band-tiled config-4 pipeline over an `n_devices` [gop, tile]
    mesh (`make_mesh(n_devices, devices=devices)`: two lanes where
    `n_devices` is even), each lane 5 frames of `width` x (64 x bands),
    hierarchical B, CABAC, rate control, deblocking, halos; then every
    lane's stream decoded on the lane's first device.  Raises unless each
    lane decodes to 5 frames equal to the tiled encoder's recons.

    `devices` defaults to the visible cards (it raises without one);
    `["cuda"] * n` lays the mesh over one card, `["cpu"] * n` over the
    CPU.  `width` (default 1280, the reference's) exists so that a test
    can run a narrower picture.  Prints the reference's summary line ->
    {"mesh", "width", "height", "frames", "lanes": [{"bytes", "sha256",
    "frame_bits", "frame_qps"}], "encode_seconds", "decode_seconds"}."""
    mesh = make_mesh(n_devices, devices=devices)
    gop, tile = mesh.shape["gop"], mesh.shape["tile"]
    cfg = dryrun_config(width, tile)
    te = TiledEncoder(cfg, mesh)
    seqs = [[synth_frame(cfg.width, cfg.height, t + DRYRUN_LANE_STRIDE * g)
             for t in range(DRYRUN_FRAMES)] for g in range(gop)]
    _sync(mesh.devices)
    t0 = time.monotonic()
    streams = te.encode_sequence(seqs)
    _sync(mesh.devices)
    encode_s = time.monotonic() - t0
    if len(streams) != gop:
        raise RuntimeError(f"dryrun: {len(streams)} streams for {gop} lanes")
    t0 = time.monotonic()
    for g, s in enumerate(streams):
        frames = decode_annexb(s, device=mesh.devices[g][0])
        if len(frames) != DRYRUN_FRAMES:
            raise RuntimeError(f"dryrun: lane {g} decodes to {len(frames)} "
                               f"frames, not {DRYRUN_FRAMES}")
        for i, (dec, rec) in enumerate(zip(frames, te.recons[g])):
            for c, a, b in zip("YUV", dec, rec):
                if not np.array_equal(a, b.cpu().numpy()):
                    raise RuntimeError(
                        f"dryrun: lane {g} frame {i} {c} decodes to other "
                        f"samples than the encoder's recon")
    decode_s = time.monotonic() - t0
    print(f"dryrun_multichip ok: mesh={dict(mesh.shape)}, "
          f"streams={[len(s) for s in streams]} bytes, "
          f"config-4 pipeline (hier-B + CABAC + RC + deblock + halos), "
          f"decoded {gop}x{DRYRUN_FRAMES} frames")
    return {"mesh": [gop, tile], "width": cfg.width, "height": cfg.height,
            "frames": DRYRUN_FRAMES,
            "lanes": [{"bytes": len(s),
                       "sha256": hashlib.sha256(s).hexdigest(),
                       "frame_bits": [st.bits for st in te.stats[g]],
                       "frame_qps": [st.qp for st in te.stats[g]]}
                      for g, s in enumerate(streams)],
            "encode_seconds": encode_s, "decode_seconds": decode_s}
