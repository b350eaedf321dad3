"""Batched torch kernels for the codec hot loops, and the wrappers of
the hand-written CUDA kernels: the wave kernels K2 (`i4x4_wave`), K3
(`i16_chroma_wave`) and K4 (`deblock_wave`), the frame kernels KP
(`p_wave`) and KB (`b_wave`), the motion search's KF (`me_search`) and
KS (`me_subpel`), and the entries on slabs (`dct_quant`, `deblock_lines`); K1 lives in
`entropy/cabac_engine_cuda.py`.

All codec math is int32 tensors with explicit shifts.
"""
