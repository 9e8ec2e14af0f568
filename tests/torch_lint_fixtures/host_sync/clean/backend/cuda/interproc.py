"""known-clean: cross-module device values sync only under fault_point,
and host-valued helper returns never count as syncs."""
from runtime.faults import fault_point

from .helpers import device_total, row_count, total_and_rows


def guarded_cross_module(mask):
    fault_point("compact")
    return int(device_total(mask))


def host_helper_is_not_a_sync(x):
    return int(row_count(x))


def host_element_of_a_tuple(x):
    _, n = total_and_rows(x)  # element-wise: the host count
    return int(n)
