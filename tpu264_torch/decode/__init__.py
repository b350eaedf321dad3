"""H.264 decoder: bitstream parse (host) + reconstruction, counterpart of
`tpu264.decode`; the in-loop deblocking runs on the card (kernel K4).

Parity target: JM `ldecod` (SURVEY.md §3.2).  Entropy parsing is
inherently serial per slice and runs on the host; reconstruction uses the
scalar reference math (`tpu264_torch.ref`) for the oracle path.  Decoder output
must be bit-exact with the encoder-side reconstruction for our own
streams, and with JM/ffmpeg for any conforming stream (BASELINE.json:4).
"""

from .decoder import Decoder, decode_annexb
