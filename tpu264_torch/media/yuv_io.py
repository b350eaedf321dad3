"""Planar YUV 4:2:0 file I/O (JM `img_io.c`/`io_raw.c` parity —
SURVEY.md §2a #2): memory-mapped reads so large sequences stream without
copies before they go to the device.  A copy of `tpu264.media.yuv_io`."""

from __future__ import annotations

import numpy as np


def read_yuv420(path: str, width: int, height: int, n_frames: int | None = None):
    """Yield (y, u, v) uint8 planes from a raw planar 4:2:0 file."""
    frame_bytes = width * height * 3 // 2
    data = np.memmap(path, dtype=np.uint8, mode="r")
    total = data.size // frame_bytes
    count = total if n_frames is None else min(total, n_frames)
    cw, ch = width // 2, height // 2
    for i in range(count):
        f = data[i * frame_bytes:(i + 1) * frame_bytes]
        y = f[:width * height].reshape(height, width)
        u = f[width * height:width * height + cw * ch].reshape(ch, cw)
        v = f[width * height + cw * ch:].reshape(ch, cw)
        yield np.array(y), np.array(u), np.array(v)


def write_yuv420(path: str, frames) -> None:
    with open(path, "wb") as f:
        for y, u, v in frames:
            f.write(np.asarray(y, dtype=np.uint8).tobytes())
            f.write(np.asarray(u, dtype=np.uint8).tobytes())
            f.write(np.asarray(v, dtype=np.uint8).tobytes())
