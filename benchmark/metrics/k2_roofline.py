"""K2's share of its roofline over the traced window, in %: the sum of its
launches' least times (``roofline/k2_gru_fwd.py``) over the
sum of their device times in the profiler's trace. None where the window
launched none."""


def read(r, name):
    return r.roofline_share("k2_gru_fwd")
