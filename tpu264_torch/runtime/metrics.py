"""Per-frame metrics logging (SURVEY.md §5 observability).

JM prints a per-frame log line (frame no, bits, QP, SnrY/U/V, time) and
an end-of-run summary.  We reproduce that schema plus a machine-readable
JSONL stream: one record per frame, one trailer record per run, with
frames/s/chip (the north-star metric) in the trailer.  A copy of
`tpu264.runtime.metrics`.
"""

from __future__ import annotations

import json
import time


def frame_record(stats, qp: int | None = None) -> dict:
    """FrameStats -> JSONL record (JM log-line schema)."""
    return {
        "frame": stats.frame,
        "type": stats.slice_type,
        "bits": stats.bits,
        "qp": qp,
        "snr_y": round(stats.psnr_y, 4),
        "snr_u": round(stats.psnr_u, 4),
        "snr_v": round(stats.psnr_v, 4),
        "seconds": round(stats.seconds, 5),
    }


def format_frame_line(rec: dict) -> str:
    """Human-readable per-frame line (lencod-style)."""
    return (f"{rec['frame']:05d}({rec['type']:>4s})  bits {rec['bits']:8d} "
            f"QP {rec['qp'] if rec['qp'] is not None else '--':>2}  "
            f"SnrY {rec['snr_y']:7.3f}  SnrU {rec['snr_u']:7.3f}  "
            f"SnrV {rec['snr_v']:7.3f}  time {rec['seconds']*1000:7.1f}ms")


class JsonlLogger:
    """Append-only JSONL metrics stream with a run trailer."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")
        self._t0 = time.monotonic()
        self._frames = 0
        self._bits = 0

    def log_frame(self, stats, qp: int | None = None) -> dict:
        rec = frame_record(stats, qp)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self._frames += 1
        self._bits += stats.bits
        return rec

    def close(self, extra: dict | None = None) -> dict:
        wall = time.monotonic() - self._t0
        trailer = {
            "run_summary": True,
            "frames": self._frames,
            "total_bits": self._bits,
            "wall_s": round(wall, 3),
            "fps": round(self._frames / wall, 3) if wall > 0 else None,
        }
        if extra:
            trailer.update(extra)
        self._f.write(json.dumps(trailer) + "\n")
        self._f.close()
        return trailer
