"""Whole-pass share of the card's peak over the encode window: the least
time of the passages' int8 dense products (1,979 TOP/s) and bf16
attention (989 TFLOP/s), counted from the padded chunks, over the
window's wall time. Moves ``encode_passages_per_s``."""


def read(view):
    return view.peak_percent()
