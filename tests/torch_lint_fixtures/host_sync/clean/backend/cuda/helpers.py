"""known-clean helpers: one device-valued, one host-valued return."""
import torch


def device_total(mask):
    return torch.sum(mask)


def row_count(x):
    return int(x.shape[0])  # static metadata: a HOST value


def total_and_rows(x):
    return torch.sum(x), int(x.shape[0])  # a device total, a host count
