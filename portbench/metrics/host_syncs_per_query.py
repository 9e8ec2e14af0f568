"""Device->host syncs per query in the timed window, as the program counts
them: its ``sync:<site>`` spans under the ``execute`` and ``collect``
phases (each also counted in ``tpu_cypher_host_sync_total``). Nothing
where the program has no sync spans."""

from portbench.spans import mean_of


def read(rec):
    return mean_of(rec, lambda q: q["syncs"])
