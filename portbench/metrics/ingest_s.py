"""Seconds to bring the run's graph into the program: the person and KNOWS
tables built from host arrays (``Table.from_arrays``, the device copies)
and the graph assembled, host clock, synchronized."""


def read(rec):
    return rec["setup"]["ingest_s"]
