"""Encoder CLI (JM `lencod` parity: `-d config.cfg -p Key=Value`),
counterpart of `tpu264.cli.encode`.

Usage:
  python -m tpu264_torch.cli.encode -d encoder.cfg [-p Key=Value ...]
  python -m tpu264_torch.cli.encode -p SourceWidth=176 -p SourceHeight=144 \\
      -p InputFile=in.yuv -p FramesToBeEncoded=10 -p OutputFile=out.264
  python -m tpu264_torch.cli.encode --tiles 4 ...   (four frame bands)

The encode runs on the CUDA card (`--device cuda`, the default; it raises
without one) unless `--device cpu` asks for the CPU.  With `--tiles N`
the frame is cut into N bands, one slice each (`TiledEncoder`): over N
cards where there are that many, else all on the one device named.
"""

from __future__ import annotations

import argparse
import sys

import torch

from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig, load_cfg, parse_cfg_text
from tpu264_torch.media.synth import synth_sequence
from tpu264_torch.media.yuv_io import read_yuv420, write_yuv420


def tile_devices(device: str, n: int) -> list:
    """The devices of N bands: N cards where `device` is "cuda" and there
    are that many, else `device` N times."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() >= n):
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu264_torch-encode")
    ap.add_argument("-d", "--config", help="JM-style .cfg file")
    ap.add_argument("-p", "--param", action="append", default=[],
                    help="Key=Value override (JM key names)")
    ap.add_argument("--synthetic", action="store_true",
                    help="use generated test content instead of InputFile")
    ap.add_argument("--metrics", help="write per-frame JSONL metrics here")
    ap.add_argument("--checkpoint", action="store_true",
                    help="GOP-granular checkpoint/resume (<out>.ckpt)")
    ap.add_argument("--tiles", type=int, default=0,
                    help="encode band-tiled with N frame bands (BASELINE "
                         "config 4 path)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card; raises without one) or "
                         "cpu")
    args = ap.parse_args(argv)

    cfg = load_cfg(args.config) if args.config else EncoderConfig()
    if args.param:
        cfg = parse_cfg_text("\n".join(args.param), base=cfg)

    if args.synthetic or not cfg.input_file:
        frames = synth_sequence(cfg.width, cfg.height, max(1, cfg.frames))
    else:
        frames = list(read_yuv420(cfg.input_file, cfg.width, cfg.height,
                                  cfg.frames))
    if args.tiles:
        import time
        from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh
        mesh = make_mesh(args.tiles, gop=1,
                         devices=tile_devices(args.device, args.tiles))
        enc = TiledEncoder(cfg, mesh)
        t0 = time.monotonic()
        stream = enc.encode_sequence([frames])[0]
        dt = time.monotonic() - t0
        with open(cfg.output_file, "wb") as f:
            f.write(stream)
        print(f"tiled encode: {len(frames)} frames, {8 * len(stream)} "
              f"bits, {len(frames) / dt:.3f} fps -> {cfg.output_file}")
        return 0
    enc = Encoder(cfg, device=args.device)
    if args.checkpoint:
        from tpu264_torch.runtime.checkpoint import encode_gops
        stream = encode_gops(enc, frames, cfg.output_file)
    else:
        stream = enc.encode_sequence(frames)
        with open(cfg.output_file, "wb") as f:
            f.write(stream)
    if cfg.recon_file:
        write_yuv420(cfg.recon_file, [tuple(p.cpu().numpy() for p in r)
                                      for r in enc.recons])

    log = None
    if args.metrics:
        from tpu264_torch.runtime.metrics import JsonlLogger
        log = JsonlLogger(args.metrics)
    for st in enc.stats:
        if log:
            log.log_frame(st, qp=st.qp)
        print(f"frame {st.frame:4d} {st.slice_type}  bits {st.bits:8d}  "
              f"snr_y {st.psnr_y:6.2f}  snr_u {st.psnr_u:6.2f}  "
              f"snr_v {st.psnr_v:6.2f}  time {st.seconds * 1000:7.1f} ms")
    if log:
        log.close({"config": cfg.output_file})
    total_bits = sum(s.bits for s in enc.stats)
    n = len(enc.stats)
    print(f"encoded {n} frames, {total_bits} bits, "
          f"avg PSNR-Y {sum(s.psnr_y for s in enc.stats) / n:.2f} dB "
          f"-> {cfg.output_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
