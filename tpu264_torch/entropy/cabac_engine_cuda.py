"""Kernel K1: the per-slice CABAC range coder over packed records.

Counterpart of `tpu264.entropy.cabac_pallas` (`make_slice_encoder`,
`init_packed_states`).  `encode_slices` runs the CUDA kernel in
`csrc/cabac_engine.cu` for CUDA tensors and the plain version (a Python
loop over the unpacked records, spec 9.3.4, bit by bit) for CPU tensors.
The coder is serial within a slice: on the card a slice is one coding
thread, fed through shared memory by the rest of its block, that writes
whole bytes with carry propagation; the plain version is what holds
that byte-wise output to the spec's bit-wise procedure.

Record format (see `cabac_binarize`): kind << 30 | a << 14 | b with
  kind 0: a = ctxIdx, b = bin | (count << 1)   — count bins, same ctx
  kind 1: a = bypass value (MSB first), b = nbits <= 16
  kind 2: a = terminate bin; a != 0 flushes and writes the stop bit

Every slice's records end with a terminate bin 1 and hold no other
(`tests/test_torch_cabac.py` holds the binarizer to that).  The plain
version keeps the spec's and the reference kernel's behaviour for records
that follow one all the same (it goes on coding after the stop bit); the
CUDA kernel refuses such a slice with nbytes = -2, as it reports a payload
that overflows the word buffer with nbytes = -1, and `payloads_from_words`
raises on both.

`launches["K1"]` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.kernels import _build
from . import cabac_tables as tbl

N_CTX = 460
_RANGE_LPS = [int(v) for v in np.asarray(tbl.RANGE_TAB_LPS).reshape(-1)]
_TRANS_MPS = [int(v) for v in tbl.TRANS_IDX_MPS]
_TRANS_LPS = [int(v) for v in tbl.TRANS_IDX_LPS]

launches = {"K1": 0}


def init_packed_states(table: int, slice_qp: int) -> np.ndarray:
    """[460] int32 context init (spec 9.3.1.1): state | mps << 8."""
    state, mps = tbl.init_states(table, slice_qp)
    return (state.astype(np.int32) | (mps.astype(np.int32) << 8))


def encode_slices(records: torch.Tensor, counts: torch.Tensor,
                  init: torch.Tensor, out_cap_words: int):
    """records [S, cap] packed int32, counts [S] int32, init [460] int32
    -> (words [S, out_cap_words] int32, big-endian: the first stream bit
    is the MSB of word 0, zero past the payload; nbytes [S] int32)."""
    for name, t in (("records", records), ("counts", counts),
                    ("init", init)):
        if t.dtype != torch.int32:
            raise TypeError(f"encode_slices: {name} must be int32")
        if not t.is_contiguous():
            raise ValueError(f"encode_slices: {name} must be contiguous")
        if t.device != records.device:
            raise ValueError("encode_slices: tensors on different devices")
    n_slices = records.shape[0]
    if records.dim() != 2 or tuple(counts.shape) != (n_slices,) \
            or tuple(init.shape) != (N_CTX,):
        raise ValueError("encode_slices: records [S, cap], counts [S], "
                         "init [460] expected")
    if records.device.type == "cpu":
        words, nbytes = encode_slices_plain(records, counts, init,
                                            out_cap_words)
    elif records.device.type == "cuda":
        words = torch.empty((n_slices, out_cap_words), dtype=torch.int32,
                            device=records.device)
        nbytes = torch.empty(n_slices, dtype=torch.int32,
                             device=records.device)
        launches["K1"] += 1
        err = _build.launch(
            "tpu264_cabac_engine", records,
            _build.ptr(records), records.shape[1], _build.ptr(counts),
            _build.ptr(init),
            _build.host_i32(_RANGE_LPS + _TRANS_MPS + _TRANS_LPS),
            _build.ptr(words), out_cap_words, _build.ptr(nbytes), n_slices)
        _build.check(err, "tpu264_cabac_engine")
    else:
        raise ValueError(f"encode_slices: unsupported device "
                         f"{records.device}")
    return words, nbytes


def _encode_records(recs: list, state: list, mps: list) -> list:
    """Spec 9.3.4 encoder over one slice's packed records -> output bits
    (flush included; the caller pads to whole bytes)."""
    rlps_tab, tmps, tlps = _RANGE_LPS, _TRANS_MPS, _TRANS_LPS
    bits: list = []
    low, rng, outst = 0, 510, 0
    first = True

    def put_bit(b):
        nonlocal first, outst
        if first:
            first = False
        else:
            bits.append(b)
        if outst:
            bits.extend([1 - b] * outst)
            outst = 0

    def renorm():
        nonlocal low, rng, outst
        while rng < 256:
            if low >= 512:
                low -= 512
                put_bit(1)
            elif low < 256:
                put_bit(0)
            else:
                low -= 256
                outst += 1
            rng <<= 1
            low <<= 1

    for p in recs:
        kind = (p >> 30) & 3
        a = (p >> 14) & 0xFFFF
        b = p & 0x3FFF
        if kind == 0:
            binv = b & 1
            for _ in range(b >> 1):
                st = state[a]
                rlps = rlps_tab[(st << 2) | ((rng >> 6) & 3)]
                rng -= rlps
                if binv != mps[a]:
                    low += rng
                    rng = rlps
                    if st == 0:
                        mps[a] ^= 1
                    state[a] = tlps[st]
                else:
                    state[a] = tmps[st]
                renorm()
        elif kind == 1:
            for k in range(b - 1, -1, -1):
                low = (low << 1) + (rng if (a >> k) & 1 else 0)
                if low >= 1024:
                    put_bit(1)
                    low -= 1024
                elif low < 512:
                    put_bit(0)
                else:
                    low -= 512
                    outst += 1
        else:
            rng -= 2
            if a:
                low += rng
                rng = 2
                renorm()
                put_bit((low >> 9) & 1)
                bits.append((low >> 8) & 1)
                bits.append(1)          # doubles as the rbsp stop bit
            else:
                renorm()
    return bits


def encode_slices_plain(records: torch.Tensor, counts: torch.Tensor,
                        init: torch.Tensor, out_cap_words: int):
    """Plain version of K1 (same contract as `encode_slices`)."""
    n_slices = records.shape[0]
    init_l = init.cpu().tolist()
    words = np.zeros((n_slices, out_cap_words), np.uint32)
    nbytes = np.zeros(n_slices, np.int32)
    for s, c in enumerate(counts.cpu().tolist()):
        recs = records[s, :c].cpu().tolist()
        bits = _encode_records(recs, [v & 0xFF for v in init_l],
                               [(v >> 8) & 1 for v in init_l])
        payload = np.packbits(np.asarray(bits, np.uint8))
        nbytes[s] = len(payload)
        pad = np.zeros(-(-len(payload) // 4) * 4, np.uint8)
        pad[:len(payload)] = payload
        w = pad.view(">u4")
        if len(w) > out_cap_words:
            nbytes[s] = -1
            w = w[:out_cap_words]
        words[s, :len(w)] = w
    return (torch.from_numpy(words.view(np.int32)).to(records.device),
            torch.from_numpy(nbytes).to(records.device))


def payloads_from_words(words: torch.Tensor, nbytes: torch.Tensor) -> list:
    """Per-slice payload bytes from `encode_slices` output."""
    nb = nbytes.cpu().tolist()
    if min(nb) == -2:
        raise ValueError("CABAC records follow a slice's final terminate bin")
    if min(nb) < 0:
        raise RuntimeError("CABAC payload overflowed its word buffer")
    need = -(-max(nb) // 4)
    w = words[:, :need].cpu().numpy()
    return [w[s].astype(">u4").tobytes()[:nb[s]] for s in range(len(nb))]
