"""known-bad: device->host syncs outside an obs.trace.sync span."""
import torch

from tpu_cypher_torch.obs import trace as T
from tpu_cypher_torch.obs.trace import sync


def unwrapped_count(mask):
    return int(torch.sum(mask))


def span_in_the_caller(mask):
    with sync("agg"):
        return helper(mask)


def helper(mask):
    # the caller's span is not lexically around this read
    return int(torch.sum(mask))


def span_around_a_definition(mask):
    with sync("agg"):
        def final():
            return torch.sum(mask).item()
    return final()


def another_context(mask):
    with torch.no_grad():
        return bool(torch.any(mask))


def after_the_span(x):
    with sync("expand"):
        n = int(torch.sum(x))
    return n, torch.sum(x).cpu()


def a_plain_span(x):
    with T.span("expand"):
        torch.cuda.synchronize()
    return x
