"""B-slice mb_type tables (spec Table 7-14), shared by the B engine
(`b_frame`, which names them as the reference does), its kernel's
by-value parameters (`kernels.b_wave.pack_params`) and both entropy
coders."""

from __future__ import annotations

import numpy as np

# ue(mb_type) bit lengths for B_L0/B_L1/B_Bi_16x16 (Table 7-14 mb_type 1,
# 2, 3 -> codewords '010', '011', '00100')
TYPE_BITS = (3, 3, 5)

# (c0, c1) with c in {0 = L0, 1 = L1, 2 = Bi} -> Table 7-14 combination
# index ((mb_type - 4) // 2); flat index c0 * 3 + c1
COMBO_IDX = np.array([0, 2, 4, 3, 1, 5, 6, 7, 8], dtype=np.int32)


def _ue_len(v: int) -> int:
    return 2 * (int(v) + 1).bit_length() - 1


def part_mb_type(c0, c1, shape8x16):
    """Spec Table 7-14 mb_type of a two-partition B MB."""
    return 4 + 2 * COMBO_IDX[c0 * 3 + c1] + shape8x16


# ue(mb_type) lengths per shape (0 = 16x8, 1 = 8x16) and (c0, c1)
TB_PART = np.array(
    [[_ue_len(part_mb_type(c0, c1, s)) for c0 in range(3)
      for c1 in range(3)] for s in range(2)], dtype=np.int32)
