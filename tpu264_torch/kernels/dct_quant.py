"""Kernels K2 (fused forward 4x4 DCT + quant, standalone entry over slabs
of blocks) and K3 (forward 4x4 DCT).

Counterparts of `tpu264.kernels.pallas_kernels.fdct_quant4x4` and
`fdct4x4`.  Both run the CUDA kernel in `csrc/dct_quant.cu` (K3 is K2
with quantisation off) for CUDA tensors; for CPU tensors they run the
plain torch versions `quant4x4(fdct4x4(x))` and `fdct4x4(x)`.  There is
no fallback from the card to the plain version: a kernel that does not
build or launch raises.

On the main paths both run inside the wave kernels: K2 in `i4x4_wave.py`
(the whole I4x4 body of a wave, DCT + quant included, in one launch), K3
in `i16_chroma_wave.py` (the I16x16 and chroma part of the intra wave
body), and both in `p_wave.py` and `b_wave.py` (the P and B wave bodies,
one launch a picture).
The entries here, for whole slabs of blocks, have no caller on a main
path; `chip_smoke.py` and the `cuda` tests hold them to their plain
versions.

`launches` counts kernel launches (not plain-version calls): "K2_blocks"
`fdct_quant4x4`'s, "K3_blocks" `fdct4x4`'s.  The wave kernels keep their
own counts, `i4x4_wave.launches["K2"]`, `i16_chroma_wave.launches["K3"]`,
`p_wave.launches["KP"]` and `b_wave.launches["KB"]`.
"""

from __future__ import annotations

import torch

from . import _build
from . import transform as kt

launches = {"K2_blocks": 0, "K3_blocks": 0}


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"dct_quant: int32 blocks expected, got {x.dtype}")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (4, 4):
        raise ValueError(f"dct_quant: [..., 4, 4] expected, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("dct_quant: blocks must be contiguous")


def _launch(x: torch.Tensor, qp: int | None, intra: bool) -> torch.Tensor:
    if x.data_ptr() % 16:
        raise ValueError("dct_quant: blocks must be 16-byte aligned")
    out = torch.empty_like(x)
    n = x.numel() // 16
    if qp is None:
        args = (None, None, 0, 0)
    else:
        qbits = 15 + qp // 6
        args = (_build.host_i32(kt.MF_TABLE[qp % 6].reshape(16).tolist()),
                _build.host_i32(kt.LIMIT_AC[qp].reshape(16).tolist()),
                (1 << qbits) // (3 if intra else 6), qbits)
    err = _build.lib().tpu264_dct_quant(
        _build.ptr(x), _build.ptr(out), n, int(qp is not None), *args,
        _build.stream_of(x))
    _build.check(err, "tpu264_dct_quant")
    return out


def fdct_quant4x4(x: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    """Levels of W = Cf X Cf^T over [..., 4, 4] int32 blocks (kernel K2,
    standalone entry)."""
    _check(x)
    if x.device.type == "cpu":
        return fdct_quant4x4_plain(x, qp, intra)
    if x.device.type != "cuda":
        raise ValueError(f"dct_quant: unsupported device {x.device}")
    launches["K2_blocks"] += 1
    return _launch(x, qp, intra)


def fdct4x4(x: torch.Tensor) -> torch.Tensor:
    """W = Cf X Cf^T over [..., 4, 4] int32 blocks (kernel K3, the entry on
    slabs of blocks)."""
    _check(x)
    if x.device.type == "cpu":
        return fdct4x4_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"dct_quant: unsupported device {x.device}")
    launches["K3_blocks"] += 1
    return _launch(x, None, True)


def fdct_quant4x4_plain(x: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    return kt.quant4x4(kt.fdct4x4(x), qp, intra=intra)


def fdct4x4_plain(x: torch.Tensor) -> torch.Tensor:
    return kt.fdct4x4(x)
