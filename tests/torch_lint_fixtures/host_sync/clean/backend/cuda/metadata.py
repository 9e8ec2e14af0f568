"""known-clean: host metadata and host memory — none of it syncs."""
import numpy as np
import torch


def allocator_statistics(dev):
    peak = int(torch.cuda.max_memory_allocated(dev))
    now = int(torch.cuda.memory_allocated(dev))
    return peak, now, torch.cuda.device_count(), torch.cuda.get_device_name(0)


def tensor_metadata(x):
    y = torch.cumsum(x, 0)
    return (int(y.numel()), int(y.dim()), int(y.element_size()), int(y.shape[0]),
            y.dtype, y.device, bool(y.is_cuda), int(torch.iinfo(torch.int64).max))


def host_tensors(values):
    t = torch.tensor(values)  # no device: a CPU tensor
    c = torch.zeros(4, device="cpu")
    return int(t.sum()), float(c.sum()), int(torch.from_numpy(np.ones(3)).sum())


def narrowed(arr):
    if isinstance(arr, np.ndarray):
        return arr.item()
    return None
