"""known-bad: the torch sync kinds beyond int() and .item(), each outside
a fault_point."""
import numpy as np
import torch


def unguarded_tolist(x):
    return torch.cumsum(x, 0).tolist()


def unguarded_cpu(x):
    return torch.cumsum(x, 0).cpu()


def unguarded_to_cpu(x):
    return torch.cumsum(x, 0).to("cpu")


def unguarded_asarray(x):
    return np.asarray(torch.cumsum(x, 0))


def unguarded_unpacked(x):
    values, counts = torch.unique(x, return_counts=True)
    return bool(torch.any(counts > 1))


def unguarded_event(start, end):
    end.synchronize()
    return start.elapsed_time(end)
