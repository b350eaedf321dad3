"""Checkpoint / resume and GOP-level failure recovery (SURVEY.md §5).

JM has no in-run checkpointing; IDR points make streams seekable.  Here
closed GOPs (IDR-delimited) are the recovery unit: after each completed
GOP the orchestrator records {next display frame, byte offset, rate-
control state} as JSON next to the output file.  Resume truncates the
stream at the recorded offset, restores the rate-controller model, and
re-encodes from the next GOP boundary — byte-identical to an
uninterrupted run.
`encode_gops` also retries a failed GOP once (transient-failure model:
the GOP is re-dispatched, matching the multi-host recovery story where a
lost host's GOPs are re-run elsewhere).  A copy of
`tpu264.runtime.checkpoint`, for the port's `Encoder`.
"""

from __future__ import annotations

import json
import os


def gop_starts(n_frames: int, intra_period: int) -> list[int]:
    """Display indices of IDR-led closed GOP starts."""
    if intra_period <= 1:
        return list(range(n_frames)) if intra_period == 1 else [0]
    return list(range(0, n_frames, intra_period))


def encode_gops(enc, frames, out_path: str, ckpt_path: str | None = None,
                max_retries: int = 1) -> bytes:
    """Encode `frames` as independent closed GOPs with checkpointing.

    Each GOP is encoded with a fresh encoder state (closed GOPs carry no
    cross-GOP prediction); the checkpoint file records progress after
    every GOP.  On resume, completed GOPs are kept from `out_path` and
    encoding continues at the first incomplete GOP.
    """
    frames = list(frames)
    cfg = enc.cfg
    starts = gop_starts(len(frames), cfg.intra_period)
    bounds = starts + [len(frames)]
    ckpt_path = ckpt_path or out_path + ".ckpt"

    done_gop = 0
    offset = 0
    if os.path.exists(ckpt_path) and os.path.exists(out_path):
        with open(ckpt_path) as f:
            ck = json.load(f)
        if ck.get("n_frames") == len(frames) and \
                ck.get("intra_period") == cfg.intra_period:
            done_gop = ck["done_gops"]
            offset = ck["byte_offset"]
            if enc.rc is not None and ck.get("rc_state") is not None:
                enc.rc.set_state(ck["rc_state"])

    mode = "r+b" if offset else "wb"
    if not os.path.exists(out_path):
        mode = "wb"
    with open(out_path, mode) as f:
        f.truncate(offset)
        f.seek(offset)
        for g in range(done_gop, len(bounds) - 1):
            lo, hi = bounds[g], bounds[g + 1]
            chunk = None
            err = None
            stats_base = len(enc.stats)
            rc_base = enc.rc.get_state() if enc.rc is not None else None
            for _ in range(1 + max_retries):
                try:
                    # retry resets this GOP's partial stats/RC state only;
                    # earlier GOPs' stats keep accumulating
                    del enc.stats[stats_base:]
                    if rc_base is not None:
                        enc.rc.set_state(rc_base)
                    chunk = enc.encode_sequence(frames[lo:hi])
                    break
                except Exception as e:          # transient-failure model
                    err = e
            if chunk is None:
                raise RuntimeError(f"GOP {g} failed after retries") from err
            f.write(chunk)
            f.flush()
            offset += len(chunk)
            with open(ckpt_path + ".tmp", "w") as cf:
                json.dump({"n_frames": len(frames),
                           "intra_period": cfg.intra_period,
                           "done_gops": g + 1,
                           "byte_offset": offset,
                           "rc_state": (enc.rc.get_state()
                                        if enc.rc is not None else None)},
                          cf)
            os.replace(ckpt_path + ".tmp", ckpt_path)
    with open(out_path, "rb") as f:
        return f.read()
