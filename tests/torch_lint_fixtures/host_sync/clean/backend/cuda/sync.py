"""known-clean: syncs behind fault_point; shape reads are not syncs."""
import torch

from runtime.faults import fault_point


def guarded_count(mask):
    fault_point("compact")
    return int(torch.sum(mask))


def guarded_nested(mask):
    fault_point("join")

    def final():
        # lexically under the fault-pointed function
        return int(torch.sum(mask))

    return final()


def shape_reads_are_host(x):
    n = int(x.shape[0])  # static metadata, not a sync
    return n + int(len(x))


def host_arithmetic(a, b):
    return int(a) + float(b)  # unclassified params never flag
