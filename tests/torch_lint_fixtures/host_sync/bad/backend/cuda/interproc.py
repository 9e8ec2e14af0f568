"""known-bad: syncs on device values produced in ANOTHER module.

No torch-prefixed call appears in this file, so the sync argument only
classifies as device-valued through the cross-module return-summary
taint.
"""
from .helpers import device_total, device_total_indirect


def sync_one_deep(mask):
    return int(device_total(mask))


def sync_two_deep(mask):
    return int(device_total_indirect(mask))


def sync_item_on_helper_value(mask):
    total = device_total(mask)
    return total.item()
