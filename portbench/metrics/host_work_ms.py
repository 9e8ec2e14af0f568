"""Mean milliseconds of the host's own work a query in the window: its
``execute`` and ``collect`` phase spans less its waits at the device syncs
(``sync_wait_ms``), so the two add up to the phases by construction. The
device is idle where this work, and not a sync, holds it. Nothing where
the program has no sync spans."""

from portbench.spans import mean_of


def read(rec):
    def work(q):
        if q["sync_s"] is None:
            return None
        return q["execute_s"] + q["collect_s"] - q["sync_s"]

    v = mean_of(rec, work)
    return None if v is None else 1e3 * v
