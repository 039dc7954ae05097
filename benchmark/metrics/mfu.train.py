"""Whole-step share of the card's peak over the co-training window: the
least time of the window's model operations (bf16 products at 989
TFLOP/s, the int8 teacher's at 1,979 TOP/s; counted from the cell's
padded shapes, backward twice the forward, no remat recompute) over the
window's wall time. Moves ``train_step_ms``."""


def read(view):
    return view.peak_percent()
