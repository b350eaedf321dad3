"""Vectorized CAVLC residual-block encoding (spec 9.2; JM `vlc.c`
writeCoeff4x4_CAVLC — SURVEY.md §2a #5).

Encodes batches of zig-zag-scanned 4x4 (or chroma-DC 2x2) coefficient
blocks into fixed-shape (value, length) element grids: every block emits
exactly `SLOTS_PER_BLOCK` elements, absent elements having length 0, so a
whole slice serializes with zero per-block Python control flow.

Element slot layout per block:
  [0]      coeff_token
  [1:4]    trailing-one sign flags (reverse scan order)
  [4:20]   levels (reverse scan order; prefix+suffix fused into one code)
  [20]     total_zeros
  [21:36]  run_before
"""

from __future__ import annotations

import numpy as np

from . import cavlc_tables as tbl

SLOTS_PER_BLOCK = 36


def nc_to_table(nc: np.ndarray) -> np.ndarray:
    """nC → coeff_token table index (spec 9.2.1): 0-1→0, 2-3→1, 4-7→2, ≥8→3."""
    nc = np.asarray(nc)
    return np.where(nc < 2, 0, np.where(nc < 4, 1, np.where(nc < 8, 2, 3)))


def encode_blocks(scanned: np.ndarray, nc: np.ndarray, max_coeff: int):
    """Encode N scanned coefficient blocks.

    Args:
      scanned: [N, max_coeff] int coefficients in scan order (lowest freq
        first).
      nc: [N] nC context values; -1 selects the chroma-DC table.
      max_coeff: 16 (luma/DC), 15 (AC), or 4 (chroma DC).

    Returns:
      values [N, 36] uint64, lengths [N, 36] int64, total_coeff [N] int64.
    """
    scanned = np.asarray(scanned, dtype=np.int64)
    n, mc = scanned.shape
    assert mc == max_coeff
    nc = np.broadcast_to(np.asarray(nc, dtype=np.int64), (n,))
    values = np.zeros((n, SLOTS_PER_BLOCK), dtype=np.uint64)
    lengths = np.zeros((n, SLOTS_PER_BLOCK), dtype=np.int64)

    nz = scanned != 0
    total_coeff = nz.sum(axis=1)
    # reverse-scan ordering of nonzero coefficients: argsort on scan index,
    # nonzeros (tagged with their index) first, descending
    idx = np.arange(mc, dtype=np.int64)[None, :]
    key = np.where(nz, idx, -1)
    order = np.argsort(-key, axis=1, kind="stable")      # [N, mc]
    lev = np.take_along_axis(scanned, order, axis=1)     # k-th nonzero from end
    lev_idx = np.take_along_axis(key, order, axis=1)     # its scan index (-1 pad)
    karange = np.arange(mc, dtype=np.int64)[None, :]
    valid = karange < total_coeff[:, None]
    lev = np.where(valid, lev, 0)

    # trailing ones: leading run of |lev|==1 in reverse order, capped at 3
    is_one = (np.abs(lev) == 1) & valid
    run1 = np.cumprod(is_one[:, :3], axis=1)
    t1 = run1.sum(axis=1)

    # --- coeff_token ---
    ct_idx = 4 * total_coeff + t1
    tsel = nc_to_table(nc)
    is_cdc = nc == -1
    reg_bits = tbl.COEFF_TOKEN_BITS[np.where(is_cdc, 0, tsel), ct_idx]
    reg_len = tbl.COEFF_TOKEN_LEN[np.where(is_cdc, 0, tsel), ct_idx]
    cdc_bits = tbl.CDC_COEFF_TOKEN_BITS[np.minimum(ct_idx, 19)]
    cdc_len = tbl.CDC_COEFF_TOKEN_LEN[np.minimum(ct_idx, 19)]
    values[:, 0] = np.where(is_cdc, cdc_bits, reg_bits).astype(np.uint64)
    lengths[:, 0] = np.where(is_cdc, cdc_len, reg_len)
    assert (lengths[:, 0] > 0).all(), "invalid coeff_token combination"

    # --- trailing one signs: 1 = negative ---
    for k in range(3):
        on = k < t1
        values[:, 1 + k] = np.where(on, (lev[:, k] < 0).astype(np.int64), 0).astype(np.uint64)
        lengths[:, 1 + k] = np.where(on, 1, 0)

    # --- levels (spec 9.2.2.1 inverse) ---
    sl = np.where((total_coeff > 10) & (t1 < 3), 1, 0).astype(np.int64)
    first_coded = t1.copy()  # index (in reverse order) of first non-T1 level
    for k in range(16):
        if k >= mc:
            break
        on = (karange[0, k] >= t1) & (k < total_coeff)
        v = lev[:, k]
        absv = np.abs(v)
        level_code = np.where(v > 0, 2 * absv - 2, 2 * absv - 1)
        level_code = np.where(on & (k == first_coded) & (t1 < 3),
                              level_code - 2, level_code)
        # encode level_code with suffix length sl
        code, ln = _encode_level(level_code, sl)
        values[:, 4 + k] = np.where(on, code, 0).astype(np.uint64)
        lengths[:, 4 + k] = np.where(on, ln, 0)
        # suffix length adaptation (spec 9.2.2.1): first bump 0→1, then —
        # independently — bump on magnitude (both can fire for one level;
        # validated bit-exact against the ffmpeg decoder)
        sl_new = np.where(sl == 0, 1, sl)
        sl_new = np.where((absv > (3 << np.maximum(sl_new - 1, 0))) & (sl_new < 6),
                          sl_new + 1, sl_new)
        sl = np.where(on, sl_new, sl)

    # --- total_zeros ---
    highest = lev_idx[:, 0]  # scan index of last nonzero (-1 if none)
    total_zeros = np.where(total_coeff > 0, highest + 1 - total_coeff, 0)
    tz_on = (total_coeff > 0) & (total_coeff < max_coeff)
    tz_row = np.clip(total_coeff - 1, 0, 15)
    tz_col = np.clip(total_zeros, 0, 15)
    if max_coeff == 4:
        tzb = tbl.CDC_TOTAL_ZEROS_BITS[np.clip(tz_row, 0, 2), np.clip(tz_col, 0, 3)]
        tzl = tbl.CDC_TOTAL_ZEROS_LEN[np.clip(tz_row, 0, 2), np.clip(tz_col, 0, 3)]
    else:
        tzb = tbl.TOTAL_ZEROS_BITS[tz_row, tz_col]
        tzl = tbl.TOTAL_ZEROS_LEN[tz_row, tz_col]
    values[:, 20] = np.where(tz_on, tzb, 0).astype(np.uint64)
    lengths[:, 20] = np.where(tz_on, tzl, 0)
    assert (lengths[:, 20][tz_on] > 0).all(), "invalid total_zeros entry"

    # --- run_before ---
    zeros_left = total_zeros.copy()
    for k in range(15):
        if k + 1 >= mc:
            break
        on = (k < total_coeff - 1) & (zeros_left > 0)
        run = np.where(on, lev_idx[:, k] - lev_idx[:, k + 1] - 1, 0)
        row = np.clip(np.minimum(zeros_left, 7) - 1, 0, 6)
        rb = tbl.RUN_BEFORE_BITS[row, np.clip(run, 0, 15)]
        rl = tbl.RUN_BEFORE_LEN[row, np.clip(run, 0, 15)]
        values[:, 21 + k] = np.where(on, rb, 0).astype(np.uint64)
        lengths[:, 21 + k] = np.where(on, rl, 0)
        assert (rl[on] > 0).all(), "invalid run_before entry"
        zeros_left = zeros_left - run
    return values, lengths, total_coeff


def _encode_level(level_code: np.ndarray, sl: np.ndarray):
    """Fused level prefix+suffix code for given suffixLength state.

    Returns (code, length) arrays; the inverse of spec 9.2.2.1 parsing with
    level_prefix <= 15 (JM range; |level| beyond that raises).
    """
    lc = level_code
    code = np.zeros_like(lc)
    ln = np.zeros_like(lc)

    # sl == 0 cases
    c0_short = lc < 14
    code0 = np.where(c0_short, 1, 0)
    len0 = np.where(c0_short, lc + 1, 0)
    c0_esc14 = (lc >= 14) & (lc < 30)
    code0 = np.where(c0_esc14, (1 << 4) | (lc - 14), code0)
    len0 = np.where(c0_esc14, 15 + 4, len0)
    c0_esc15 = lc >= 30
    code0 = np.where(c0_esc15, (1 << 12) | (lc - 30), code0)
    len0 = np.where(c0_esc15, 16 + 12, len0)

    # sl > 0 cases
    sl1 = np.maximum(sl, 1)
    prefix = lc >> sl1
    suffix = lc & ((1 << sl1) - 1)
    cs_short = prefix < 15
    code1 = np.where(cs_short, (1 << sl1) | suffix, 0)
    len1 = np.where(cs_short, prefix + 1 + sl1, 0)
    cs_esc = prefix >= 15
    esc_val = lc - (15 << sl1)
    code1 = np.where(cs_esc, (1 << 12) | esc_val, code1)
    len1 = np.where(cs_esc, 16 + 12, len1)

    code = np.where(sl == 0, code0, code1)
    ln = np.where(sl == 0, len0, len1)
    if np.any((lc >= 30 + 4096) & (sl == 0)) or np.any((esc_val >= 4096) & cs_esc & (sl > 0)):
        raise ValueError("level magnitude exceeds single-escape CAVLC range")
    return code, ln


def _build_decode_map(bits_tbl, len_tbl, entries):
    """(length, code) → index decode map for one VLC table."""
    m = {}
    for i in entries:
        ln = int(len_tbl[i])
        if ln > 0:
            m[(ln, int(bits_tbl[i]))] = i
    return m


class _DecodeMaps:
    def __init__(self) -> None:
        ct_entries = [4 * tc + t1 for tc in range(17)
                      for t1 in range(min(3, tc) + 1)]
        self.coeff_token = [
            _build_decode_map(tbl.COEFF_TOKEN_BITS[t], tbl.COEFF_TOKEN_LEN[t],
                              ct_entries) for t in range(4)]
        cdc_entries = [4 * tc + t1 for tc in range(5)
                       for t1 in range(min(3, tc) + 1)]
        self.cdc_coeff_token = _build_decode_map(
            tbl.CDC_COEFF_TOKEN_BITS, tbl.CDC_COEFF_TOKEN_LEN, cdc_entries)
        self.total_zeros = [
            _build_decode_map(tbl.TOTAL_ZEROS_BITS[i], tbl.TOTAL_ZEROS_LEN[i],
                              range(16)) for i in range(16)]
        self.cdc_total_zeros = [
            _build_decode_map(tbl.CDC_TOTAL_ZEROS_BITS[i],
                              tbl.CDC_TOTAL_ZEROS_LEN[i], range(4))
            for i in range(3)]
        self.run_before = [
            _build_decode_map(tbl.RUN_BEFORE_BITS[i], tbl.RUN_BEFORE_LEN[i],
                              range(16)) for i in range(7)]


_MAPS = _DecodeMaps()


def _read_vlc(r, m: dict) -> int:
    code = 0
    for ln in range(1, 29):
        code = (code << 1) | r.read(1)
        if (ln, code) in m:
            return m[(ln, code)]
    raise ValueError("invalid VLC code in bitstream")


def decode_block(r, nc: int, max_coeff: int) -> np.ndarray:
    """Scalar CAVLC block parse (spec 9.2) → scanned coefficients.

    Inverse of `encode_blocks` for one block; used by the reference
    decoder (JM `ldecod` readCoeff4x4_CAVLC parity).
    """
    if nc == -1:
        idx = _read_vlc(r, _MAPS.cdc_coeff_token)
    else:
        idx = _read_vlc(r, _MAPS.coeff_token[int(nc_to_table(nc))])
    total_coeff, t1 = idx // 4, idx % 4
    coeffs = np.zeros(max_coeff, dtype=np.int64)
    if total_coeff == 0:
        return coeffs
    levels = []
    for k in range(t1):
        levels.append(-1 if r.read(1) else 1)
    sl = 1 if (total_coeff > 10 and t1 < 3) else 0
    for k in range(t1, total_coeff):
        lc = decode_level(r, sl)
        if k == t1 and t1 < 3:
            lc += 2
        level = (lc + 2) >> 1 if lc % 2 == 0 else -((lc + 1) >> 1)
        levels.append(level)
        if sl == 0:
            sl = 1
        if abs(level) > (3 << (sl - 1)) and sl < 6:
            sl += 1
    if total_coeff < max_coeff:
        if max_coeff == 4:
            tz = _read_vlc(r, _MAPS.cdc_total_zeros[total_coeff - 1])
        else:
            tz = _read_vlc(r, _MAPS.total_zeros[total_coeff - 1])
    else:
        tz = 0
    zeros_left = tz
    runs = []
    for k in range(total_coeff - 1):
        if zeros_left > 0:
            run = _read_vlc(r, _MAPS.run_before[min(zeros_left, 7) - 1])
        else:
            run = 0
        runs.append(run)
        zeros_left -= run
    runs.append(zeros_left)  # zeros before the lowest-frequency coefficient
    pos = tz + total_coeff - 1
    for k in range(total_coeff):
        coeffs[pos] = levels[k]
        pos -= runs[k] + 1
    return coeffs


def decode_level(r, sl: int) -> int:
    """Scalar level decode (spec 9.2.2.1) for the reference decoder."""
    prefix = r.count_leading_zeros(limit=32)
    r.read(1)
    if prefix == 14 and sl == 0:
        suffix_size = 4
    elif prefix >= 15:
        suffix_size = prefix - 3
    else:
        suffix_size = sl
    suffix = r.read(suffix_size) if suffix_size else 0
    level_code = (min(prefix, 15) << sl) + suffix
    if prefix >= 15 and sl == 0:
        level_code += 15
    if prefix >= 16:
        level_code += (1 << (prefix - 3)) - 4096
    return level_code
