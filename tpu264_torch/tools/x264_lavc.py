"""x264 (through libavcodec's libx264 encoder) and libavcodec's H.264
decoder, reached through ctypes: the RD harness's external anchors.

A copy of the ctypes bindings of the repository's test helpers
(`tests/x264_util.py`, `tests/lavc_util.py`), which the port does not
import.  The libraries are loaded at the first call, not at import;
where one does not load, the call raises naming it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

LIBAVCODEC = "libavcodec.so.59"
LIBAVUTIL = "libavutil.so.57"
AV_OPT_SEARCH_CHILDREN = 1
AV_CODEC_ID_H264 = 27


class AVFrame(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p * 8),
                ("linesize", ctypes.c_int * 8),
                ("extended_data", ctypes.c_void_p),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("nb_samples", ctypes.c_int), ("format", ctypes.c_int)]


class AVPacket(ctypes.Structure):
    _fields_ = [("buf", ctypes.c_void_p), ("pts", ctypes.c_int64),
                ("dts", ctypes.c_int64),
                ("data", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_int)]


def _bind(lib, name, restype, *argtypes):
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = restype, list(argtypes)


@functools.cache
def libs():
    """(libavcodec, libavutil) with every function used here declared;
    raises RuntimeError naming the library that does not load."""
    loaded = []
    for name in (LIBAVCODEC, LIBAVUTIL):
        try:
            loaded.append(ctypes.CDLL(name))
        except OSError as e:
            raise RuntimeError(f"{name} does not load ({e}): x264 and "
                               f"libavcodec are not available") from e
    lavc, lavu = loaded
    vp, ip, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    frame_p, pkt_p = ctypes.POINTER(AVFrame), ctypes.POINTER(AVPacket)
    for name in ("avcodec_find_encoder_by_name",
                 "avcodec_find_decoder_by_name"):
        _bind(lavc, name, vp, cp)
    _bind(lavc, "avcodec_alloc_context3", vp, vp)
    _bind(lavc, "avcodec_open2", ip, vp, vp, vp)
    _bind(lavc, "avcodec_send_frame", ip, vp, frame_p)
    _bind(lavc, "avcodec_receive_packet", ip, vp, pkt_p)
    _bind(lavc, "avcodec_send_packet", ip, vp, pkt_p)
    _bind(lavc, "avcodec_receive_frame", ip, vp, frame_p)
    _bind(lavc, "av_packet_alloc", pkt_p)
    _bind(lavc, "av_packet_unref", None, pkt_p)
    _bind(lavc, "avcodec_free_context", None, ctypes.POINTER(vp))
    _bind(lavc, "av_parser_init", vp, ip)
    _bind(lavc, "av_parser_parse2", ip, vp, vp, ctypes.POINTER(vp),
          ctypes.POINTER(ip), vp, ip, ctypes.c_int64, ctypes.c_int64,
          ctypes.c_int64)
    _bind(lavc, "av_parser_close", None, vp)
    _bind(lavu, "av_frame_alloc", frame_p)
    _bind(lavu, "av_frame_get_buffer", ip, frame_p, ip)
    _bind(lavu, "av_frame_make_writable", ip, frame_p)
    _bind(lavu, "av_opt_set", ip, vp, cp, cp, ip)
    return lavc, lavu


def _check(r: int, what: str) -> None:
    if r != 0:
        raise RuntimeError(f"{what} -> {r}")


def x264_encode(frames, qp: int = 28, params: str = "",
                preset: str = "medium") -> bytes:
    """(y, u, v) uint8 frames -> x264's Annex-B stream at fixed `qp`, with
    `params` appended to its x264-params string."""
    lavc, lavu = libs()
    h, w = frames[0][0].shape
    codec = lavc.avcodec_find_encoder_by_name(b"libx264")
    if not codec:
        raise RuntimeError(f"{LIBAVCODEC} has no libx264 encoder")
    ctx = lavc.avcodec_alloc_context3(codec)
    x264p = f"qp={qp}:threads=1:sliced-threads=0" + (
        ":" + params if params else "")
    for k, v in (("video_size", f"{w}x{h}"), ("pixel_format", "yuv420p"),
                 ("time_base", "1/25"), ("preset", preset), ("threads", 1),
                 ("x264-params", x264p)):
        _check(lavu.av_opt_set(ctx, k.encode(), str(v).encode(),
                               AV_OPT_SEARCH_CHILDREN), f"av_opt_set {k}")
    _check(lavc.avcodec_open2(ctx, codec, None), "avcodec_open2")
    frame = lavu.av_frame_alloc()
    frame.contents.width, frame.contents.height = w, h
    frame.contents.format = 0                       # AV_PIX_FMT_YUV420P
    _check(lavu.av_frame_get_buffer(frame, 32), "av_frame_get_buffer")
    pkt = lavc.av_packet_alloc()
    out = bytearray()

    def drain():
        while lavc.avcodec_receive_packet(ctx, pkt) == 0:
            out.extend(ctypes.string_at(pkt.contents.data,
                                        pkt.contents.size))
            lavc.av_packet_unref(pkt)

    for i, planes in enumerate(frames):
        _check(lavu.av_frame_make_writable(frame), "av_frame_make_writable")
        f = frame.contents
        for p, src in enumerate(planes):
            src = np.ascontiguousarray(src)
            ph, pw = src.shape
            ls = f.linesize[p]
            buf = (ctypes.c_uint8 * (ls * ph)).from_address(f.data[p])
            np.frombuffer(buf, np.uint8).reshape(ph, ls)[:, :pw] = src
        f.nb_samples = 0
        # AVFrame.pts sits at byte 136 in libavutil 57's layout
        ctypes.c_int64.from_address(ctypes.addressof(f) + 136).value = i
        _check(lavc.avcodec_send_frame(ctx, frame), "avcodec_send_frame")
        drain()
    lavc.avcodec_send_frame(ctx, None)              # flush
    drain()
    lavc.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
    return bytes(out)


def lavc_decode(stream: bytes) -> list:
    """Annex-B H.264 stream -> libavcodec's decoded (y, u, v) uint8
    frames."""
    lavc, lavu = libs()
    codec = lavc.avcodec_find_decoder_by_name(b"h264")
    if not codec:
        raise RuntimeError(f"{LIBAVCODEC} has no h264 decoder")
    ctx = lavc.avcodec_alloc_context3(codec)
    _check(lavc.avcodec_open2(ctx, codec, None), "avcodec_open2")
    pkt = lavc.av_packet_alloc()
    frame = lavu.av_frame_alloc()
    parser = lavc.av_parser_init(AV_CODEC_ID_H264)
    frames = []

    def drain():
        while lavc.avcodec_receive_frame(ctx, frame) == 0:
            f = frame.contents
            w, h = f.width, f.height
            planes = []
            for p, (ph, pw) in enumerate(((h, w), (h // 2, w // 2),
                                          (h // 2, w // 2))):
                ls = f.linesize[p]
                raw = (ctypes.c_uint8 * (ls * ph)).from_address(f.data[p])
                planes.append(np.frombuffer(raw, np.uint8)
                              .reshape(ph, ls)[:, :pw].copy())
            frames.append(tuple(planes))

    buf = ctypes.create_string_buffer(bytes(stream), len(stream) + 64)
    out_data, out_size = ctypes.c_void_p(), ctypes.c_int()

    def parse(at, n):
        used = lavc.av_parser_parse2(parser, ctx, ctypes.byref(out_data),
                                     ctypes.byref(out_size), at, n, 0, 0, -1)
        if out_size.value > 0:
            pkt.contents.data = ctypes.cast(out_data,
                                            ctypes.POINTER(ctypes.c_uint8))
            pkt.contents.size = out_size.value
            lavc.avcodec_send_packet(ctx, pkt)
            drain()
        return used

    pos = 0
    while pos < len(stream):
        n = parse(ctypes.addressof(buf) + pos, len(stream) - pos)
        if n < 0:
            break
        pos += n
    parse(None, 0)                                  # flush the parser
    lavc.avcodec_send_packet(ctx, None)             # flush the decoder
    drain()
    lavc.av_parser_close(parser)
    lavc.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
    return frames
