"""Build and load the port's CUDA kernel library.

All kernels (K1 CABAC engine, K2 I4x4 wave body, K3 I16x16 + chroma wave
body, KP P wave body and KB B wave body (one launch a picture each), K4
deblock wave, KF integer full search and KS sub-pel refinement (one launch
a list of a picture each), KR CABAC binarize + compact (four launches a
picture) and KV CAVLC serialize + pack (two launches a picture or
chunk), both deriving their mvds and most probable modes with KD's
device code (`mb_preds.cuh`), and the K2/K3 DCT +
quant and K4 luma line filter entries on slabs) are CUDA C++ under
`tpu264_torch/csrc/` with a plain C interface.  At first use `nvcc` compiles each source to an object
file, all sources at once in parallel, links them into one shared library,
`build/tpu264_torch/libtpu264_kernels_<hash>.so` beside the package, keyed
by a hash of the sources and flags, and `ctypes` loads it.  Only the
sources in the repository are compiled; nothing else is needed.

Each C entry point takes device pointers and the CUDA stream as
`c_void_p` and returns `cudaGetLastError()`; `check` raises on nonzero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu264_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (x, out, n_blocks, quantize, mf16*, lim16*, f, qbits, stream)
    "tpu264_dct_quant": [P, P, I, I, P, P, I, I, P],
    # (orig, ltop, lleft, modes_top, modes_left, 4 x (flag, stride), params*,
    #  recon, mode_grid, modes_zz, coeffs, cost, n_mbs, stream)
    "tpu264_i4x4_wave": [P, P, P, P, P, P, I, P, I, P, I, P, I, P,
                         P, P, P, P, P, I, P],
    # (orig, row_y, col_y, modes_row, modes_col, coords, avail, wm, params*,
    #  recon, mode_grid, modes_zz, coeffs, cost, n_mbs, n_frames,
    #  frame strides*, stream)
    "tpu264_i4x4_wave_bd": [P, P, P, P, P, P, P, I, P, P, P, P, P, P, I, I, P,
                            P],
    # (ptrs[27]*, params*, n_mbs, wm, n_frames, frame strides*, stream)
    "tpu264_i16_chroma_wave": [P, P, I, I, I, P, P],
    # (ptrs[39]*, params*, i4params*, geom*, bmax, w0, w1, grid, stream)
    "tpu264_p_frame": [P, P, P, P, I, I, I, I, P],
    # (blocks*)
    "tpu264_p_frame_blocks": [P],
    # (ptrs[50]*, params*, i4params*, geom*, bmax, w0, w1, grid, stream)
    "tpu264_b_frame": [P, P, P, P, I, I, I, I, P],
    "tpu264_b_frame_blocks": [P],
    # (y, u, v, bs_v, bs_h, qp_y, qp_c, wm, hm, cp, r0, n_rows, n_frames,
    #  off_a, off_b, stream)
    "tpu264_deblock_wave": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    # (win, bs, out, n_lines, alpha, beta, tc0_3*, stream)
    "tpu264_deblock_luma": [P, P, P, I, I, I, P, P],
    # (records, rec_stride, counts, init, tables*, words, out_cap, nbytes,
    #  n_slices, stream)
    "tpu264_cabac_engine": [P, I, P, P, P, P, I, P, I, P],
    # (orig, ref_pad, out, params*, stream)
    "tpu264_me_search": [P, P, P, P, P],
    # (ptrs[33]*, params*, recs, stride, emit_only, stream)
    "tpu264_cabac_records": [P, P, P, I, I, P],
    # (orig, planes, mv_int, out, params*, stream)
    "tpu264_me_subpel": [P, P, P, P, P, P],
    # (ptrs[34]*, params*, pics, cap, stream)
    "tpu264_cavlc_slices": [P, P, I, I, P],
}

_LIB = None
build_seconds: float | None = None      # wall time of the last build
# what `ptxas -v` said of each source's kernels (registers, spills, shared
# memory), by source stem, when this process built the library
ptxas_log: dict = {}
_CO_RESIDENT: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpu264_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.monotonic()
    # one nvcc per source, all started together, then one link
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((src, cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for src, cmd, _, proc in jobs:
        so, se = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{so}\n{se}")
        ptxas_log[src.stem] = so + se
    objs = [obj for _, _, obj, _ in jobs]
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        if failures:
            raise RuntimeError("\n".join(failures))
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)       # atomic: a concurrent loader sees all or none
    build_seconds = time.monotonic() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = so
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


class FrameArgs(NamedTuple):
    """What the host hands a frame kernel (KP, KB) for one launch: the
    tensors in the order of the kernel's `FrameIo` (None: a null
    pointer), its two tables (its own and K2's), the geometry, the lanes
    a wave and the wave range."""
    tensors: list
    params: ctypes.Array
    i4params: ctypes.Array
    geom: list
    bmax: int
    waves: tuple


def launch_frame(entry: str, a: FrameArgs, like) -> None:
    """One cooperative launch of frame kernel `entry` with the layout `a`
    on the card and stream of tensor `like`; raises if the card refuses
    it."""
    grid, _ = frame_grid(a.bmax, co_resident(entry, like.device))
    ptrs = [0 if t is None else t.data_ptr() for t in a.tensors]
    err = launch(entry, like, (ctypes.c_void_p * len(ptrs))(*ptrs),
                 a.params, a.i4params, host_i32(a.geom), a.bmax, *a.waves,
                 grid)
    check(err, entry)


def frame_grid(bmax: int, co_resident: int) -> tuple:
    """A frame kernel's cooperative grid for waves of `bmax` lanes on a card
    that holds `co_resident` of its blocks at once -> (blocks, lanes a
    block takes a wave at most)."""
    if co_resident < 1:
        raise RuntimeError("the card runs no cooperative launch of the frame "
                           "kernel (0 co-resident blocks)")
    grid = max(1, min(bmax, co_resident))
    return grid, -(-bmax // grid)


def co_resident(entry: str, dev) -> int:
    """The most blocks of a frame kernel (`entry` + "_blocks" reports them)
    that card `dev` holds at once; asked once a card."""
    import torch
    key = (entry, dev.index if dev.index is not None
           else torch.cuda.current_device())
    if key not in _CO_RESIDENT:
        n = ctypes.c_int(0)
        with torch.cuda.device(key[1]):
            check(getattr(lib(), entry + "_blocks")(ctypes.byref(n)),
                  entry + "_blocks")
        _CO_RESIDENT[key] = n.value
    return _CO_RESIDENT[key]


def check_tensor(who: str, name: str, t, shape, dtype, dev) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `dev`."""
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{who}: {name} is on {t.device}, not {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def check_frames(who: str, name: str, t, n_frames, shape, dtype,
                 dev) -> int:
    """Raise unless `t` is a `dtype` tensor on `dev` of `shape`
    (`n_frames` None) or of (n_frames,) + `shape` with each picture's part
    contiguous (the pictures may lie any fixed stride apart) -> the
    element stride from one picture to the next (0 for one picture)."""
    if n_frames is None:
        check_tensor(who, name, t, shape, dtype, dev)
        return 0
    if tuple(t.shape) != (n_frames, *shape):
        raise ValueError(f"{who}: {name} must be {(n_frames, *shape)}, got "
                         f"{tuple(t.shape)}")
    check_tensor(who, f"{name}[0]", t[0], shape, dtype, dev)
    return t.stride(0)


def host_i64(values) -> ctypes.Array:
    """A host int64 array for a by-value table argument."""
    vals = [int(v) for v in values]
    return (ctypes.c_int64 * len(vals))(*vals)


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(entry: str, like, *args) -> int:
    """Call the library's `entry` with `args` and then the current stream
    of the card that tensor `like` lies on, with that card current: CUDA
    refuses a launch into another card's stream, and what an entry sets
    on its own (a kernel's shared-memory attribute) belongs to the current
    card -> the entry's error code."""
    import torch
    with torch.cuda.device(like.device):
        return getattr(lib(), entry)(*args, stream_of(like))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def host_i32(values) -> ctypes.Array:
    """A host int32 array for a by-value table argument."""
    vals = [int(v) for v in values]
    return (ctypes.c_int32 * len(vals))(*vals)
