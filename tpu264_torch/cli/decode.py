"""Decoder CLI (JM `ldecod` parity), counterpart of `tpu264.cli.decode`.

Usage: python -m tpu264_torch.cli.decode in.264 out.yuv [--md5]
       [--conceal] [--trace FILE] [--device cuda|cpu]

The deblocking filter runs on the CUDA card (`--device cuda`, the
default; it raises without one) unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import sys

from tpu264_torch.decode import Decoder, decode_annexb
from tpu264_torch.media.yuv_io import write_yuv420


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu264_torch-decode")
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--md5", action="store_true",
                    help="print MD5 of the decoded YUV (conformance check)")
    ap.add_argument("--conceal", action="store_true",
                    help="conceal lost/corrupt slices (JM erc parity) "
                         "instead of aborting")
    ap.add_argument("--trace", help="write a per-slice/per-MB syntax "
                                    "trace here (JM TRACE parity)")
    ap.add_argument("--device", default="cuda",
                    help="where the deblocking filter runs: cuda (default: "
                         "the card; raises without one) or cpu")
    args = ap.parse_args(argv)

    with open(args.input, "rb") as f:
        stream = f.read()
    if args.trace:
        with open(args.trace, "w") as tf:
            frames = Decoder(conceal=args.conceal, trace=tf,
                             device=args.device).decode(stream)
    else:
        frames = decode_annexb(stream, conceal=args.conceal,
                               device=args.device)
    if args.output:
        write_yuv420(args.output, frames)
    if args.md5:
        h = hashlib.md5()
        for y, u, v in frames:
            h.update(y.tobytes()); h.update(u.tobytes()); h.update(v.tobytes())
        print(h.hexdigest())
    print(f"decoded {len(frames)} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
