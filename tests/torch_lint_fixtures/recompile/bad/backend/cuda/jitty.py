"""known-bad: per-call wrappers, kernel-impl env reads, unhashable memo keys."""
import functools
import os

import torch

from backend.cuda.hopper import dispatch

dispatch.register(
    "k", "kernel_k", replaces="pallas/k.py:1", source="csrc/k.cu",
    impls=("_launch_env", "_launch_flag"),
)


def fresh_compile_per_call(x):
    # a new compiled callable (and its cache) every invocation
    return torch.compile(lambda v: v + 1)(x)


def _launch_env(x):
    # the env value keys the launch below the gate, per call
    scale = float(os.environ.get("SOME_SCALE", "1.0"))
    return x * scale


def _launch_flag(x):
    from utils.config import BUCKET_MODE

    if BUCKET_MODE.get() == "pow2":  # keyed below the gate, out of sight
        return x * 2
    return x


@functools.lru_cache(maxsize=None)
def unhashable_memo_default(n, sizes=[8, 16]):
    return n * len(sizes)
