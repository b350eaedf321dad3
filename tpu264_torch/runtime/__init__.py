"""Host runtime: frame rate control, the band-tiled encoder over a grid of
devices, GOP-parallel encoding across hosts, GOP checkpointing and
per-frame metrics."""

from .gop_scheduler import (GopScheduler, encode_host_share,  # noqa: F401
                            gather_streams, init_distributed,
                            scaling_harness)
