"""device-valued helpers — no syncs here; the callers are the bugs."""
import torch


def device_total(mask):
    return torch.sum(mask)


def device_total_indirect(mask):
    # one more hop: callers of this are TWO calls from the torch reduction
    return device_total(mask)
