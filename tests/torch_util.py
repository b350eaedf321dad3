"""Helpers shared by the `tpu264_torch` equivalence tests.

The tests run the JAX reference (`tpu264`, on the CPU backend) and the
PyTorch port on the same inputs, made from a seed with numpy, and hand
data between them as numpy arrays.  Equality is exact: every stage is
integer math with deterministic decisions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.entropy import cabac_engine_cuda as k1
from tpu264_torch.tools.synth_inputs import (  # noqa: F401  (re-exported)
    carry_records, long_run_records, random_i4x4_lanes, random_records)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t32(x, device="cpu") -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)


def assert_equal(got, want, what: str = "") -> None:
    np.testing.assert_array_equal(to_np(got).astype(np.int64),
                                  to_np(want).astype(np.int64), err_msg=what)


def cuda_device() -> torch.device:
    """The card for a `cuda`-marked test; skips the test without one.
    Decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def run_engine(slices, table, qp, pad=5, out_cap=8192, device="cpu"):
    """Pack (k, a, b) per slice into [S, cap] and run K1's wrapper on
    `device` -> (words, nbytes, payload bytes per slice)."""
    cap = max(len(k) for k, _, _ in slices) + pad
    recs = np.zeros((len(slices), cap), np.int32)
    for s, (k, a, b) in enumerate(slices):
        recs[s, :len(k)] = to_np(tcb.pack_records(t32(k), t32(a), t32(b)))
    counts = np.array([len(k) for k, _, _ in slices], np.int32)
    init = k1.init_packed_states(table, qp)
    words, nbytes = k1.encode_slices(t32(recs, device), t32(counts, device),
                                     t32(init, device), out_cap)
    return words, nbytes, k1.payloads_from_words(words, nbytes)
