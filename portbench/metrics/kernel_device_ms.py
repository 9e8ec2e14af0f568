"""Mean device milliseconds of the hand-written kernels a query in the
window: the CUDA timing events the program records around each
``kernel``-tier launch, on its ``kernel:<name>`` spans, summed. Nothing
where the program keeps no device time on its spans."""

from portbench.spans import mean_of


def read(rec):
    v = mean_of(rec, lambda q: q["kernel_device_s"])
    return None if v is None else 1e3 * v
