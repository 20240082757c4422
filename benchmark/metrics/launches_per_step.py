"""Launches a step: the CUDA runtime calls named ``cudaLaunch*``,
``cudaMemcpyAsync`` or ``cudaMemsetAsync`` that start inside one of the
window's root spans of the port, on any thread, over the steps
(``harness/program_spans.py``). Driver-API launches (``cuLaunchKernel``)
are not in the trace's host calls and not counted."""

from harness import program_spans


def read(r, name):
    s = program_spans.of(r, name)
    return None if s is None else s.launches_per_step()
