"""Entropy coding: CAVLC serializer and packer, CABAC tables, the I- and
P-slice binarizer and the range coder (kernel K1)."""
