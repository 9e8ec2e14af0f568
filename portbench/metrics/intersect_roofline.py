"""``intersect``'s share of its roofline over the traced window: the bytes the
window's queries need it to move (each query kind's ``work``), at the
card's published memory rate, over the device time of its kernels by name
(``roofline/kernels.json``). Nothing where it did not launch."""

KERNEL = "intersect"


def read(rec):
    dev = rec["device"]
    if not dev or dev["kernel_s"].get(KERNEL, 0.0) <= 0.0:
        return None
    return 100.0 * rec["work_s"].get(KERNEL, 0.0) / dev["kernel_s"][KERNEL]
