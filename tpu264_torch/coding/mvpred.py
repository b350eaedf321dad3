"""Motion vector prediction (spec 8.4.1.3) and P_Skip motion inference
(spec 8.4.1.1), counterpart of `tpu264.coding.mvpred`.

16x16-partition, single-reference form (ref_idx 0).  Neighbour coding in
the ref maps: -2 = unavailable (outside slice), -1 = intra MB (available),
0 = inter with ref_idx 0.

Two implementations sharing the same rules: a batched torch form
(`predict_mv`, `skip_mv`) used inside the wavefront engine and the
serializer, and a numpy form (`*_np`), the oracle the tests hold it to.
"""

from __future__ import annotations

import numpy as np
import torch

UNAVAIL = -2
INTRA = -1


def _median3(a, b, c):
    return np.maximum(np.minimum(np.maximum(a, b), c), np.minimum(a, b))


def predict_mv_np(mv_a, ref_a, mv_b, ref_b, mv_c, ref_c):
    """Scalar/array median MV predictor (components already D-substituted
    for C).  mv_*: (..., 2) arrays; ref_*: (...) ints per the map coding.
    """
    mv_a, mv_b, mv_c = (np.asarray(m, dtype=np.int64) for m in (mv_a, mv_b, mv_c))
    ref_a, ref_b, ref_c = (np.asarray(r) for r in (ref_a, ref_b, ref_c))
    # unavailable or intra neighbors contribute mv 0 (their map mv is 0)
    only_a = (ref_b == UNAVAIL) & (ref_c == UNAVAIL) & (ref_a != UNAVAIL)
    same_a = ref_a == 0
    same_b = ref_b == 0
    same_c = ref_c == 0
    n_same = same_a.astype(int) + same_b.astype(int) + same_c.astype(int)
    exactly_one = n_same == 1
    one_mv = (mv_a * same_a[..., None] + mv_b * same_b[..., None]
              + mv_c * same_c[..., None])
    med = _median3(mv_a, mv_b, mv_c)
    pred = np.where(only_a[..., None], mv_a,
                    np.where(exactly_one[..., None], one_mv, med))
    return pred


def predict_mv(mv_a, ref_a, mv_b, ref_b, mv_c, ref_c):
    """Median MV predictor over int32 tensors: mv_* [..., 2], ref_* [...]
    (C already D-substituted)."""
    only_a = (ref_b == UNAVAIL) & (ref_c == UNAVAIL) & (ref_a != UNAVAIL)
    same_a = ref_a == 0
    same_b = ref_b == 0
    same_c = ref_c == 0
    n_same = same_a.to(torch.int32) + same_b.to(torch.int32) \
        + same_c.to(torch.int32)
    exactly_one = n_same == 1
    one_mv = (mv_a * same_a[..., None] + mv_b * same_b[..., None]
              + mv_c * same_c[..., None])
    med = torch.maximum(torch.minimum(torch.maximum(mv_a, mv_b), mv_c),
                        torch.minimum(mv_a, mv_b))
    return torch.where(only_a[..., None], mv_a,
                       torch.where(exactly_one[..., None], one_mv, med))


def skip_mv_np(pred, mv_a, ref_a, mv_b, ref_b):
    """P_Skip motion (spec 8.4.1.1): zero if an edge/zero-mv condition
    holds, else the median predictor."""
    zero = ((ref_a == UNAVAIL) | (ref_b == UNAVAIL)
            | ((ref_a == 0) & (np.asarray(mv_a) == 0).all(axis=-1))
            | ((ref_b == 0) & (np.asarray(mv_b) == 0).all(axis=-1)))
    return np.where(zero[..., None], 0, pred)


def skip_mv(pred, mv_a, ref_a, mv_b, ref_b):
    """P_Skip motion (torch form of `skip_mv_np`)."""
    zero = ((ref_a == UNAVAIL) | (ref_b == UNAVAIL)
            | ((ref_a == 0) & (mv_a == 0).all(dim=-1))
            | ((ref_b == 0) & (mv_b == 0).all(dim=-1)))
    return torch.where(zero[..., None], 0, pred)


def neighbor_mvs_np(mv_map, ref_map, wm, hm, slice_start_rows):
    """Per-MB neighbor (A, B, C-with-D-substitution) mv/ref arrays from
    final frame maps — used by the serializer and tests.

    mv_map: [hm, wm, 2]; ref_map: [hm, wm].
    Returns dict with mv_a, ref_a, mv_b, ref_b, mv_c, ref_c ([n,2]/[n]).
    """
    starts = set(int(s) for s in slice_start_rows)
    n = wm * hm
    out = {k: np.zeros((n, 2), dtype=np.int64) for k in ("mv_a", "mv_b", "mv_c")}
    for k in ("ref_a", "ref_b", "ref_c"):
        out[k] = np.full(n, UNAVAIL, dtype=np.int64)
    for i in range(n):
        r, c = divmod(i, wm)
        top_ok = r not in starts

        def get(rr, cc):
            if cc < 0 or cc >= wm or rr < 0:
                return np.zeros(2, np.int64), UNAVAIL
            return mv_map[rr, cc], int(ref_map[rr, cc])

        if c > 0:
            out["mv_a"][i], out["ref_a"][i] = get(r, c - 1)
        if top_ok:
            out["mv_b"][i], out["ref_b"][i] = get(r - 1, c)
            # C = top-right; D = top-left substitution
            if c + 1 < wm:
                out["mv_c"][i], out["ref_c"][i] = get(r - 1, c + 1)
            elif c > 0:
                out["mv_c"][i], out["ref_c"][i] = get(r - 1, c - 1)
    return out
