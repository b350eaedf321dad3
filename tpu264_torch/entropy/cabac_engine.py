"""CABAC arithmetic engine: encoder (spec 9.3.4, JM `biariencode.c`) and
decoder (spec 9.3.3.2, JM `biaridecod.c`) — SURVEY.md §2a #6, §3.5.

This is the scalar reference engine used by the host entropy path: the
per-bin loop is inherently serial within a slice (§3.5 — the one loop
that cannot be data-parallelized), so slices are the parallel axis.  A
batch front-end (`encode_stream`) consumes precomputed (ctx, bin, kind)
tensors produced by the vectorized binarizers, which keeps the Python
overhead to one tight loop per slice.  A copy of
`tpu264.entropy.cabac_engine` for the port: its `CabacDecoder` parses
for the decoder (`decode/cabac_parse.py`).
"""

from __future__ import annotations

from . import cabac_tables as tbl

# stream record kinds
KIND_CTX = 0        # context-coded decision
KIND_BYPASS = 1
KIND_TERMINATE = 2


class CabacEncoder:
    """Arithmetic encoding engine per spec 9.3.4.

    Context state lives in `self.state`/`self.mps` (uint8[460]) initialized
    per slice QP and init table (9.3.1.1).
    """

    def __init__(self, table: int, slice_qp: int):
        self.state, self.mps = tbl.init_states(table, slice_qp)
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        self.out = bytearray()
        self._byte = 0
        self._nbits = 0
        self.bin_count = 0

    # --- raw bit output -------------------------------------------------
    def _write_bit(self, b: int):
        self._byte = (self._byte << 1) | b
        self._nbits += 1
        if self._nbits == 8:
            self.out.append(self._byte)
            self._byte = 0
            self._nbits = 0

    def _put_bit(self, b: int):
        if self.first_bit:
            self.first_bit = False
        else:
            self._write_bit(b)
        while self.bits_outstanding > 0:
            self._write_bit(1 - b)
            self.bits_outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low >= 512:
                self.low -= 512
                self._put_bit(1)
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.range <<= 1
            self.low <<= 1

    # --- bin coding -----------------------------------------------------
    def encode(self, ctx: int, bin_val: int):
        state = self.state[ctx]
        r_lps = int(tbl.RANGE_TAB_LPS[state, (self.range >> 6) & 3])
        self.range -= r_lps
        if bin_val != self.mps[ctx]:
            self.low += self.range
            self.range = r_lps
            if state == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = tbl.TRANS_IDX_LPS[state]
        else:
            self.state[ctx] = tbl.TRANS_IDX_MPS[state]
        self._renorm()
        self.bin_count += 1

    def encode_bypass(self, bin_val: int):
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1
        self.bin_count += 1

    def encode_terminate(self, bin_val: int):
        self.range -= 2
        if bin_val:
            self.low += self.range
            self._flush()
        else:
            self._renorm()
        self.bin_count += 1

    def _flush(self):
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        # WriteBits(((codILow >> 7) & 3) | 1, 2): final 1 doubles as the
        # rbsp stop bit
        self._write_bit((self.low >> 8) & 1)
        self._write_bit(1)

    def get_bytes(self) -> bytes:
        """Byte-aligned output after encode_terminate(1); pads alignment
        zero bits (rbsp_trailing after the flush-embedded stop bit)."""
        while self._nbits:
            self._write_bit(0)
        return bytes(self.out)


class CabacDecoder:
    """Arithmetic decoding engine per spec 9.3.3.2."""

    def __init__(self, table: int, slice_qp: int, data: bytes, bitpos: int = 0):
        self.state, self.mps = tbl.init_states(table, slice_qp)
        self.data = data
        self.pos = bitpos
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._read_bit()

    def _read_bit(self) -> int:
        byte = self.data[self.pos >> 3] if (self.pos >> 3) < len(self.data) else 0
        b = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def decode(self, ctx: int) -> int:
        state = self.state[ctx]
        r_lps = int(tbl.RANGE_TAB_LPS[state, (self.range >> 6) & 3])
        self.range -= r_lps
        if self.offset >= self.range:
            bin_val = 1 - self.mps[ctx]
            self.offset -= self.range
            self.range = r_lps
            if state == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = tbl.TRANS_IDX_LPS[state]
        else:
            bin_val = int(self.mps[ctx])
            self.state[ctx] = tbl.TRANS_IDX_MPS[state]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return bin_val

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0

    def reinit(self, bitpos: int):
        """Re-initialize the arithmetic engine mid-slice at a byte-
        aligned position (after I_PCM samples, spec 9.3.1.2); context
        states persist — only the register state resets.

        Position invariant used by the I_PCM reader: when
        decode_terminate() returns 1, `self.pos` equals the exact bit
        length of the encoder's arithmetic output including its flush
        (init reads 9 bits = the encoder's 9-bit flush tail plus the
        skipped first bit; every renormalization shift afterwards maps
        1:1 to one encoder output bit)."""
        self.pos = bitpos
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._read_bit()
