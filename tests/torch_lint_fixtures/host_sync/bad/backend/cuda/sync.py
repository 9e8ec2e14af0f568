"""known-bad: device->host syncs in functions with no fault_point."""
import torch


def unguarded_count(mask):
    # int() of a device reduction with no fault_point in scope
    return int(torch.sum(mask))


def unguarded_chained(mask):
    total_dev = torch.sum(mask)
    total = int(total_dev)  # chased through the local assignment
    return total


def unguarded_item(x):
    got = torch.max(x)
    return got.item()


def unguarded_synchronize(x):
    torch.cuda.synchronize()
    return x
