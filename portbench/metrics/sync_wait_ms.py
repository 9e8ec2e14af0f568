"""Mean milliseconds a query waits at the program's device->host syncs in
the window: its ``sync:<site>`` spans (``obs.trace.sync``) under the
``execute`` and ``collect`` phases, summed (``portbench/spans.py``).
Nothing where the program has no sync spans."""

from portbench.spans import mean_of


def read(rec):
    v = mean_of(rec, lambda q: q["sync_s"])
    return None if v is None else 1e3 * v
