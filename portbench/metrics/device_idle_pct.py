"""Share of the traced window in which no operation ran on the device
(``torch.profiler``: kernels, copies and memsets, their union)."""


def read(rec):
    dev = rec["device"]
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
