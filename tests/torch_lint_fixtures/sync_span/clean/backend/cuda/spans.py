"""known-clean: every sync inside an obs.trace.sync span, however the
file imports it; shape reads and host values are not syncs."""
import torch

import tpu_cypher_torch.obs.trace as OT
from tpu_cypher_torch.obs import trace as _obs_trace
from tpu_cypher_torch.obs.trace import sync
from tpu_cypher_torch.obs.trace import sync as host_sync


def wrapped(mask):
    with sync("compact"):
        return int(torch.sum(mask))


def module_alias(x):
    with _obs_trace.sync("agg"):
        return torch.sum(x).tolist()


def import_alias(x):
    with OT.sync("fence"):
        torch.cuda.synchronize()
    return x


def renamed_among_others(x):
    with torch.no_grad(), host_sync("expand"):
        total = int(torch.sum(x))
    return total


def inside_a_block_of_the_span(x):
    with host_sync("expr"):
        if x.numel():
            return bool(torch.any(x))
    return False


def nested_function_with_its_own_span(mask):
    def final():
        with sync("expand_count"):
            return torch.sum(mask).item()

    return final()


def shape_reads_are_host(x):
    return int(x.shape[0]) + int(len(x))
