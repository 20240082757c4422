"""The kernel wrappers that count their kernel launches (``fn.launches``).

Each wrapper registers itself with :func:`counted` as its module loads. A
CUDA graph that holds launches of registered wrappers adds what it holds to
their counters on every replay (``train.gan.CapturedStep``), so a counter
counts executions whether the launch was issued or replayed.
"""

WRAPPERS: list = []  # every counted wrapper, in the order they registered


def counted(fn):
    """Give ``fn`` a counter of its kernel launches since the last reset
    (``fn.launches``) and register it. Returns ``fn``."""
    fn.launches = 0
    WRAPPERS.append(fn)
    return fn
