"""Host milliseconds a step spends in autograd's backward: the summed
durations of the spans ``gan.d_backward``, ``gan.g_backward`` and
``encoder.backward`` over the steps (``harness/program_spans.py``)."""

from harness import program_spans


def read(r, name):
    s = program_spans.of(r, name)
    return None if s is None else s.per_step_ms(program_spans.BACKWARD)
