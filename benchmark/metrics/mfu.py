"""The whole step's share of the card's bf16 dense peak, in %: the FLOPs of
the work done in the window (``roofline/stackgan.py``) over the window's
length times the peak."""


def read(r, name):
    return r.mfu("stackgan")
