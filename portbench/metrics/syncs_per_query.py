"""Device-to-host syncs per query, counted under torch's sync debug mode in
a sub-window of its own after the timed one: each query of the mix once."""


def read(rec):
    s = rec["syncs"]
    return s["count"] / s["queries"] if s and s["queries"] else None
