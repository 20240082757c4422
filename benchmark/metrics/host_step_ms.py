"""Host milliseconds a step spends issuing its work: the summed durations of
the window's root spans of the port (the steps, and ``audio.featurize``
before each) over the steps (``harness/program_spans.py``)."""

from harness import program_spans


def read(r, name):
    s = program_spans.of(r, name)
    return None if s is None else s.host_step_ms()
