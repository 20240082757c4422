"""Host milliseconds a step spends in the optimizers: the summed durations
of the spans ``gan.d_opt``, ``gan.g_opt``, ``gan.ema`` and ``encoder.opt``
(``zero_grad``, ``step``, the EMA update) over the steps
(``harness/program_spans.py``)."""

from harness import program_spans


def read(r, name):
    s = program_spans.of(r, name)
    return None if s is None else s.per_step_ms(program_spans.OPTIMIZER)
