"""Host runtime: frame rate control, the band-tiled encoder over a grid of
devices, GOP checkpointing and per-frame metrics."""
