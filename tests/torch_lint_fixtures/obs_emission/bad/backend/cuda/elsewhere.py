"""known-bad: a raw launch outside backend/cuda/hopper/, in a function
whose name a hopper module registers (the allowlist is per module)."""
from .hopper import _build


def _registered_lib():
    return _build.lib("rogue")
