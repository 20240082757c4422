"""The share of the traced window's ``gan.step`` roots whose ``graph``
attribute is ``replay`` (the step replayed from its CUDA graphs), in %.
None where no step of the kind carries the attribute: a program that does
not say how its step ran (``harness/program_spans.py``)."""

from harness import program_spans


def read(r, name):
    s = program_spans.of(r, name)
    if s is None:
        return None
    kind = name.rsplit(".", 1)[-1]
    said = [rec.attrs["graph"] for rec in s.spans
            if rec.name == program_spans.STEPS[kind] and rec.parent is None and "graph" in rec.attrs]
    return 100.0 * said.count("replay") / len(said) if said else None
