"""Share of the device's idle time in the window that passes while the host
is inside an optimizer span (``gan.d_opt``, ``gan.g_opt``, ``gan.ema``,
``encoder.opt``), in %: the measure of (idle ∩ optimizer spans) over the
measure of idle (``harness/program_spans.py``)."""

from harness import program_spans


def read(r, name):
    s = program_spans.of(r, name)
    return None if s is None else s.optimizer_idle_pct()
