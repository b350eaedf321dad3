"""CABAC slice-syntax parser (decoder side of `entropy.cabac_slice`).

Parses one CABAC slice's macroblock layer into plain per-MB value dicts
(spec 7.3.5/9.3.3; JM `mb_read.c` CABAC branches — SURVEY.md §3.2), using
the same paired element coders and `CabacFrameState` as the encoder so
context derivation cannot diverge between the two.

Round 5: full decode trees for external conformance — P/B partition
mb_types with per-partition ref_idx/mvd (per-4x4 context state,
9.3.3.1.1.6/7), P/B sub-macroblock trees, I_PCM with engine re-init,
transform_size_8x8_flag and the cat-5 8x8 residual.  A copy of
`tpu264.decode.cabac_parse` for the port.
"""

from __future__ import annotations

import numpy as np

from tpu264_torch.coding.wavefront import BLK_ORDER
from tpu264_torch.entropy import cabac_ctx as cs
from tpu264_torch.entropy.cabac_engine import CabacDecoder

# partition geometry (dr4, dc4, h4b, w4b) — mirrors decoder._P_PARTS
P_PARTS = {
    0: [(0, 0, 4, 4)],
    1: [(0, 0, 2, 4), (2, 0, 2, 4)],          # 16x8 top, bottom
    2: [(0, 0, 4, 2), (0, 2, 4, 2)],          # 8x16 left, right
}
SUB_PARTS = {
    0: [(0, 0, 2, 2)],
    1: [(0, 0, 1, 2), (1, 0, 1, 2)],          # 8x4
    2: [(0, 0, 2, 1), (0, 1, 2, 1)],          # 4x8
    3: [(0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1)],
}
# B two-partition prediction uses per mb_type 4..21 (Table 7-14)
B_PART_PRED = [((1, 0), (1, 0)), ((0, 1), (0, 1)),
               ((1, 0), (0, 1)), ((0, 1), (1, 0)),
               ((1, 0), (1, 1)), ((0, 1), (1, 1)),
               ((1, 1), (1, 0)), ((1, 1), (0, 1)),
               ((1, 1), (1, 1))]
# B sub_mb_type (Table 7-18): value -> ((use0, use1), geometry key)
B_SUB = {1: ((1, 0), 0), 2: ((0, 1), 0), 3: ((1, 1), 0),
         4: ((1, 0), 1), 5: ((1, 0), 2), 6: ((0, 1), 1),
         7: ((0, 1), 2), 8: ((1, 1), 1), 9: ((1, 1), 2),
         10: ((1, 0), 3), 11: ((0, 1), 3), 12: ((1, 1), 3)}


class CabacSliceParser:
    def __init__(self, rbsp: bytes, bit_offset: int, table: int, qp: int,
                 state: cs.CabacFrameState, sid: int, *,
                 p_slice: bool = False, b_slice: bool = False,
                 nref0: int = 1, nref1: int = 1, t8_mode: bool = False,
                 direct8: bool = True):
        # slice data starts byte-aligned after cabac_alignment_one_bit
        start = (bit_offset + 7) // 8 * 8
        self.eng = CabacDecoder(table, qp, rbsp, bitpos=start)
        self.st = state
        self.sid = sid
        self.p_slice = p_slice
        self.b_slice = b_slice
        self.nref = (nref0, nref1)
        self.t8_mode = t8_mode
        self.direct8 = direct8
        self.st.prev_qp_delta_nz = 0

    # ------------------------------------------------------------ MB level
    def mb_skip(self, mr, mc, b_slice: bool = False) -> bool:
        self.st.start_mb(mr, mc, self.sid)
        skip = self.eng.decode(
            self.st.ctx_mb_skip(mr, mc, self.sid, b_slice))
        return bool(skip)

    def end_of_slice(self) -> bool:
        return bool(self.eng.decode_terminate())

    def note_skip(self, mr, mc):
        self.st.set_skip(mr, mc)

    # ------------------------------------------------------- inter helpers
    def _ref(self, lx: int, g4r: int, g4c: int, h4b: int, w4b: int) -> int:
        """Decode one ref_idx (if present) and record its cells."""
        if self.nref[lx] > 1:
            ref = cs.decode_ref_idx(
                self.eng, self.st.ctx_ref_idx(g4r, g4c, self.sid, lx))
        else:
            ref = 0
        self.st.set_refidx(lx, g4r, g4c, h4b, w4b, ref)
        return ref

    def _mvd(self, lx: int, g4r: int, g4c: int, h4b: int, w4b: int):
        """Decode one mvd pair (x then y, compIdx order) and record the
        partition's |mvd| cells."""
        mvd_x = cs.decode_mvd(self.eng, self.st, g4r, g4c, self.sid, 1, lx)
        mvd_y = cs.decode_mvd(self.eng, self.st, g4r, g4c, self.sid, 0, lx)
        self.st.set_absmvd(lx, g4r, g4c, h4b, w4b,
                           abs(mvd_y), abs(mvd_x))
        return (mvd_y, mvd_x)

    def _read_ipcm(self):
        """I_PCM samples: byte-aligned raw bytes, then engine re-init
        (spec 7.3.5 / 9.3.1.2).  See CabacDecoder.reinit for the
        position invariant."""
        eng = self.eng
        byte0 = (eng.pos + 7) // 8
        raw = eng.data[byte0:byte0 + 384]
        if len(raw) < 384:
            raise ValueError("truncated I_PCM samples")
        y = np.frombuffer(raw[:256], np.uint8).astype(np.int64)
        u = np.frombuffer(raw[256:320], np.uint8).astype(np.int64)
        v = np.frombuffer(raw[320:384], np.uint8).astype(np.int64)
        eng.reinit((byte0 + 384) * 8)
        return y.reshape(16, 16), u.reshape(8, 8), v.reshape(8, 8)

    def _note_ipcm(self, mr, mc):
        """Context state for an I_PCM MB: counts as Intra_16x16-class
        with all coded_block_flags inferred 1 (spec 9.3.3.1.1)."""
        st = self.st
        st.kind[mr, mc] = cs.K_I16
        st.cpm[mr, mc] = 0
        st.cbp_luma[mr, mc] = 15
        st.cbp_chroma[mr, mc] = 2
        st.cbf_ldc[mr, mc] = 1
        st.cbf_l4[mr * 4:mr * 4 + 4, mc * 4:mc * 4 + 4] = 1
        st.cbf_cdc[:, mr, mc] = 1
        st.cbf_cac[:, mr * 2:mr * 2 + 2, mc * 2:mc * 2 + 2] = 1
        st.t8[mr, mc] = False
        st.prev_qp_delta_nz = 0

    # ------------------------------------------------------------ parse_mb
    def parse_mb(self, mr, mc, p_slice=None, intra_cb=None,
                 b_slice=None):
        """Parse one (non-skip) macroblock → value dict.

        intra_cb.mpm(gr4, gc4) returns the most-probable intra mode for
        a global 4x4 block position; intra_cb.set(gr4, gc4, mode) records
        a just-parsed mode; intra_cb.set8(gr4, gc4, mode) records an
        8x8 mode over its 2x2 cells.
        """
        eng, st, sid = self.eng, self.st, self.sid
        p_slice = self.p_slice if p_slice is None else p_slice
        b_slice = self.b_slice if b_slice is None else b_slice
        use0 = use1 = False
        direct = False
        btype = None
        ptype = None
        if b_slice:
            mbt = cs.decode_mb_type_b(eng, st.ctx_mb_type_b(mr, mc, sid))
            btype = mbt
            inter = mbt < 23
            if mbt == 0:               # B_Direct_16x16
                direct = True
            elif inter and mbt <= 3:
                use0 = mbt in (1, 3)
                use1 = mbt in (2, 3)
            elif not inter:
                mbt -= 23
        elif not p_slice:
            st.start_mb(mr, mc, sid)
            mbt = cs.decode_mb_type_intra(
                eng, st.ctx_mb_type_i(mr, mc, sid), cs.I_REST)
            inter = False
        else:
            mbt = cs.decode_mb_type_p(eng)
            inter = mbt < 5
            if inter:
                ptype = mbt
            else:
                mbt -= 5
        out = {"mb_type": mbt, "inter": inter, "btype": btype,
               "ptype": ptype, "use0": use0, "use1": use1,
               "direct": direct}
        if not inter and mbt == 25:    # I_PCM
            out["pcm"] = self._read_ipcm()
            out["qp_delta"] = 0
            self._note_ipcm(mr, mc)
            return out

        if direct:
            kind = cs.K_DIRECT
        elif inter:
            kind = cs.K_INTER
        elif mbt == 0:
            kind = cs.K_I4
        else:
            kind = cs.K_I16
        st.kind[mr, mc] = kind
        intra = not inter
        t8 = False

        # ---- prediction syntax
        if kind == cs.K_I4:
            if self.t8_mode:
                t8 = bool(cs.decode_t8_flag(eng, st, mr, mc, sid))
            else:
                st.t8[mr, mc] = False
            if t8:
                modes8 = np.zeros(4, dtype=np.int64)
                for b8 in range(4):
                    gr = mr * 4 + (b8 // 2) * 2
                    gc = mc * 4 + (b8 % 2) * 2
                    m = cs.decode_i4_mode(eng, intra_cb.mpm(gr, gc))
                    intra_cb.set8(gr, gc, m)
                    modes8[b8] = m
                out["modes8"] = modes8
            else:
                modes = np.zeros(16, dtype=np.int64)
                for idx, (by, bx) in enumerate(BLK_ORDER):
                    gr, gc = mr * 4 + by, mc * 4 + bx
                    m = cs.decode_i4_mode(eng, intra_cb.mpm(gr, gc))
                    intra_cb.set(gr, gc, m)
                    modes[idx] = m
                out["modes"] = modes
        if intra:
            cpm = cs.decode_cpm(eng, st.ctx_cpm(mr, mc, sid))
            st.cpm[mr, mc] = cpm
            out["cmode"] = cpm
            if kind == cs.K_I16:
                st.t8[mr, mc] = False

        allow_t8 = True
        if kind == cs.K_DIRECT:
            st.clear_inter_mb(mr, mc)
            allow_t8 = self.direct8
        elif kind == cs.K_INTER and b_slice:
            st.clear_inter_mb(mr, mc)
            if btype <= 3:             # 16x16 one-partition types
                refs = [0, 0]
                for lx, use in ((0, use0), (1, use1)):
                    if use:
                        refs[lx] = self._ref(lx, mr * 4, mc * 4, 4, 4)
                out["refs"] = refs
                for lx, use in ((0, use0), (1, use1)):
                    if use:
                        out[f"mvd{lx}"] = self._mvd(lx, mr * 4, mc * 4,
                                                    4, 4)
            elif btype <= 21:          # two-partition 16x8 / 8x16
                pred = B_PART_PRED[(btype - 4) // 2]
                geom = P_PARTS[1] if btype % 2 == 0 else P_PARTS[2]
                refs = [[0, 0], [0, 0]]        # [lx][part]
                for lx in (0, 1):
                    for p, (dr4, dc4, h4b, w4b) in enumerate(geom):
                        if pred[p][lx]:
                            refs[lx][p] = self._ref(
                                lx, mr * 4 + dr4, mc * 4 + dc4, h4b, w4b)
                mvds = [[None, None], [None, None]]
                for lx in (0, 1):
                    for p, (dr4, dc4, h4b, w4b) in enumerate(geom):
                        if pred[p][lx]:
                            mvds[lx][p] = self._mvd(
                                lx, mr * 4 + dr4, mc * 4 + dc4, h4b, w4b)
                out["part_pred"] = pred
                out["refs"] = refs
                out["mvds"] = mvds
            else:                      # B_8x8
                subs = [cs.decode_sub_mb_type_b(eng) for _ in range(4)]
                out["subs"] = subs
                refs = [[0] * 4, [0] * 4]
                for lx in (0, 1):
                    for b8 in range(4):
                        if subs[b8] != 0 and B_SUB[subs[b8]][0][lx]:
                            br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                            refs[lx][b8] = self._ref(
                                lx, mr * 4 + br4, mc * 4 + bc4, 2, 2)
                mvds = [[[] for _ in range(4)], [[] for _ in range(4)]]
                for lx in (0, 1):
                    for b8 in range(4):
                        if subs[b8] == 0:
                            continue
                        uses, gkey = B_SUB[subs[b8]]
                        if not uses[lx]:
                            continue
                        br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                        for dr4, dc4, h4b, w4b in SUB_PARTS[gkey]:
                            mvds[lx][b8].append(self._mvd(
                                lx, mr * 4 + br4 + dr4,
                                mc * 4 + bc4 + dc4, h4b, w4b))
                out["refs"] = refs
                out["mvds"] = mvds
                allow_t8 = all(
                    (s == 0 and self.direct8)
                    or (s != 0 and B_SUB[s][1] == 0) for s in subs)
        elif kind == cs.K_INTER:       # P macroblock
            st.clear_inter_mb(mr, mc)
            if ptype in (0, 1, 2):
                geom = P_PARTS[ptype]
                refs = []
                for dr4, dc4, h4b, w4b in geom:
                    refs.append(self._ref(0, mr * 4 + dr4, mc * 4 + dc4,
                                          h4b, w4b))
                mvds = []
                for p, (dr4, dc4, h4b, w4b) in enumerate(geom):
                    mvds.append(self._mvd(0, mr * 4 + dr4, mc * 4 + dc4,
                                          h4b, w4b))
                out["refs"] = refs
                out["mvds"] = mvds
                if ptype == 0:
                    out["mvd"] = mvds[0]   # back-compat for own streams
            else:                      # P_8x8 / P_8x8ref0
                subs = [cs.decode_sub_mb_type_p(eng) for _ in range(4)]
                out["subs"] = subs
                allow_t8 = all(s == 0 for s in subs)
                refs = []
                for b8 in range(4):
                    br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                    if ptype == 3:
                        refs.append(self._ref(0, mr * 4 + br4,
                                              mc * 4 + bc4, 2, 2))
                    else:
                        refs.append(0)
                        self.st.set_refidx(0, mr * 4 + br4, mc * 4 + bc4,
                                           2, 2, 0)
                mvds = [[] for _ in range(4)]
                for b8 in range(4):
                    br4, bc4 = (b8 // 2) * 2, (b8 % 2) * 2
                    for dr4, dc4, h4b, w4b in SUB_PARTS[subs[b8]]:
                        mvds[b8].append(self._mvd(
                            0, mr * 4 + br4 + dr4, mc * 4 + bc4 + dc4,
                            h4b, w4b))
                out["refs"] = refs
                out["mvds"] = mvds

        # ---- coded_block_pattern + transform size + qp delta
        if kind == cs.K_I16:
            t = mbt - 1
            out["i16mode"] = t % 4
            cbp_c = (t // 4) % 3
            cbp_l = 15 if t >= 12 else 0
        else:
            cbp = cs.decode_cbp(eng, st, mr, mc, sid)
            cbp_l, cbp_c = cbp & 15, cbp >> 4
        st.cbp_luma[mr, mc] = cbp_l
        st.cbp_chroma[mr, mc] = cbp_c
        out["cbp_luma"], out["cbp_chroma"] = cbp_l, cbp_c

        if inter or kind == cs.K_DIRECT:
            if self.t8_mode and cbp_l > 0 and allow_t8:
                t8 = bool(cs.decode_t8_flag(eng, st, mr, mc, sid))
            else:
                st.t8[mr, mc] = False
        out["t8"] = t8

        out["qp_delta"] = 0
        if cbp_l or cbp_c or kind == cs.K_I16:
            out["qp_delta"] = cs.decode_qp_delta(eng, st)
        else:
            # mb_qp_delta absent -> inferred 0; the NEXT MB's ctx sees 0
            st.prev_qp_delta_nz = 0

        # ---- residuals
        if kind == cs.K_I16:
            dc, cbf = cs.decode_residual(
                eng, 16, 0, st.ctx_cbf_luma_dc(mr, mc, sid, intra))
            st.cbf_ldc[mr, mc] = cbf
            out["luma_dc"] = dc
            acs = np.zeros((16, 15), dtype=np.int64)
            if cbp_l:
                for idx, (by, bx) in enumerate(BLK_ORDER):
                    g4r, g4c = mr * 4 + by, mc * 4 + bx
                    acs[idx], cbf = cs.decode_residual(
                        eng, 15, 1,
                        st.ctx_cbf_luma4(g4r, g4c, sid, intra, 1))
                    st.cbf_l4[g4r, g4c] = cbf
            out["luma_ac15"] = acs
        elif t8:
            blocks8 = np.zeros((4, 64), dtype=np.int64)
            for b8 in range(4):
                g2r = mr * 4 + (b8 // 2) * 2
                g2c = mc * 4 + (b8 % 2) * 2
                if (cbp_l >> b8) & 1:
                    blocks8[b8], _ = cs.decode_residual(eng, 64, 5, None)
                    # neighbors consult the covering 8x8 block's cbf
                    # (spec 9.3.3.1.1.9); cat-5 presence == cbp bit
                    st.cbf_l4[g2r:g2r + 2, g2c:g2c + 2] = 1
                else:
                    st.cbf_l4[g2r:g2r + 2, g2c:g2c + 2] = 0
            out["luma8"] = blocks8
        else:
            blocks = np.zeros((16, 16), dtype=np.int64)
            for idx, (by, bx) in enumerate(BLK_ORDER):
                if (cbp_l >> (idx // 4)) & 1:
                    g4r, g4c = mr * 4 + by, mc * 4 + bx
                    blocks[idx], cbf = cs.decode_residual(
                        eng, 16, 2,
                        st.ctx_cbf_luma4(g4r, g4c, sid, intra, 2))
                    st.cbf_l4[g4r, g4c] = cbf
                else:
                    st.cbf_l4[mr * 4 + by, mc * 4 + bx] = 0
            out["luma4"] = blocks

        cdc = np.zeros((2, 4), dtype=np.int64)
        if cbp_c >= 1:
            for comp in range(2):
                cdc[comp], cbf = cs.decode_residual(
                    eng, 4, 3,
                    st.ctx_cbf_chroma_dc(mr, mc, sid, intra, comp))
                st.cbf_cdc[comp, mr, mc] = cbf
        out["chroma_dc"] = cdc
        cac = np.zeros((2, 4, 15), dtype=np.int64)
        if cbp_c == 2:
            for comp in range(2):
                for idx in range(4):
                    by, bx = idx // 2, idx % 2
                    g2r, g2c = mr * 2 + by, mc * 2 + bx
                    cac[comp, idx], cbf = cs.decode_residual(
                        eng, 15, 4,
                        st.ctx_cbf_chroma_ac(g2r, g2c, sid, intra, comp))
                    st.cbf_cac[comp, g2r, g2c] = cbf
        out["chroma_ac"] = cac
        return out
