"""Host runtime: frame rate control."""
