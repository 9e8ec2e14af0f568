"""Mean milliseconds of the program's ``execute`` phase span per query in
the window (host clock; planning is a plan-cache hit after warm-up, and the
one-row decode is the ``collect`` phase)."""


def read(rec):
    xs = [q["execute_s"] for q in rec["queries"]]
    return 1e3 * sum(xs) / len(xs) if xs else None
