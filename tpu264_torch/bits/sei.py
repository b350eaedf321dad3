"""SEI message syntax (spec 7.3.2.3 + Annex D) — parse and write.

JM writes buffering-period / picture-timing / recovery-point SEI from
`sei.c`; x264 emits a user_data_unregistered message carrying its
options string on every stream.  We parse the generic payload framing
(ff-escaped type/size bytes) for ANY message, decode the payloads we
know (recovery_point, user_data_unregistered, buffering_period shell),
and can write recovery_point + user_data_unregistered.  A copy of
`tpu264.bits.sei` for the port.
"""

from __future__ import annotations

import dataclasses

from .bitreader import BitReader
from .bitwriter import BitSink
from .expgolomb import read_ue, write_ue

# Annex D payload types
BUFFERING_PERIOD = 0
PIC_TIMING = 1
USER_DATA_UNREGISTERED = 5
RECOVERY_POINT = 6


@dataclasses.dataclass
class SEIMessage:
    payload_type: int
    payload: bytes            # raw payload bytes (RBSP, unescaped)
    # decoded views (filled for known types)
    text: str | None = None           # user_data_unregistered tail
    recovery_frame_cnt: int | None = None


def parse_sei_rbsp(rbsp: bytes) -> list[SEIMessage]:
    """Split one SEI NALU RBSP into messages (spec 7.3.2.3.1)."""
    out = []
    i = 0
    n = len(rbsp)
    while i < n:
        if rbsp[i] == 0x80 and i == n - 1:
            break                     # rbsp_trailing_bits
        ptype = 0
        while i < n and rbsp[i] == 0xFF:
            ptype += 255
            i += 1
        if i >= n:
            break
        ptype += rbsp[i]
        i += 1
        size = 0
        while i < n and rbsp[i] == 0xFF:
            size += 255
            i += 1
        if i >= n:
            break
        size += rbsp[i]
        i += 1
        payload = rbsp[i:i + size]
        i += size
        msg = SEIMessage(ptype, payload)
        if ptype == USER_DATA_UNREGISTERED and size >= 16:
            try:
                msg.text = payload[16:].decode("utf-8", "replace")
            except Exception:
                msg.text = None
        elif ptype == RECOVERY_POINT and size:
            r = BitReader(payload)
            msg.recovery_frame_cnt = read_ue(r)
        out.append(msg)
    return out


def _payload_header(ptype: int, size: int) -> bytes:
    b = bytearray()
    while ptype >= 255:
        b.append(0xFF)
        ptype -= 255
    b.append(ptype)
    while size >= 255:
        b.append(0xFF)
        size -= 255
    b.append(size)
    return bytes(b)


def write_recovery_point(recovery_frame_cnt: int = 0) -> bytes:
    """One recovery_point SEI message (Annex D.1.8): decoding can start
    at this access unit (exact_match for our closed-GOP IDRs)."""
    s = BitSink()
    write_ue(s, recovery_frame_cnt)
    s.put(1, 1)                       # exact_match_flag
    s.put(0, 1)                       # broken_link_flag
    s.put(0, 2)                       # changing_slice_group_idc
    s.rbsp_trailing_bits()            # sei payload bit alignment
    payload = s.to_bytes()
    return _payload_header(RECOVERY_POINT, len(payload)) + payload


_UUID = bytes(range(16))              # fixed deterministic uuid


def write_user_data(text: str) -> bytes:
    """One user_data_unregistered SEI message (Annex D.1.6) — encoder
    tag, like x264's options string."""
    payload = _UUID + text.encode()
    return _payload_header(USER_DATA_UNREGISTERED, len(payload)) \
        + payload


def make_sei_rbsp(*messages: bytes) -> bytes:
    """Concatenate SEI messages into one sei_rbsp (trailing stop bit)."""
    return b"".join(messages) + b"\x80"
