"""known-clean: module-level wrappers, memoized factories, host-side reads."""
import functools
import os

import torch

_STEP_CACHE = {}


@torch.compile
def module_level(x):
    return x + 1


@functools.lru_cache(maxsize=None)
def hashable_memo_default(n, size=128):
    return n * size


def memoized_factory(n):
    # the sanctioned idiom: compile once per key, stored in a module cache
    f = _STEP_CACHE.get(n)
    if f is None:
        f = torch.compile(lambda v: v * n)
        _STEP_CACHE[n] = f
    return f


def host_side_env_read():
    # env reads OUTSIDE kernel impls are fine (registry rules aside)
    return os.environ.get("SOME_SCALE", "1.0")
