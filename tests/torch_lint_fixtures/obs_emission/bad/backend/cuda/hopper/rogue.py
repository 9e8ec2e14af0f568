"""known-bad: raw launches outside any registered impl, plus a
module-global counter dict."""
import ctypes

from . import _build, dispatch

# the pre-obs counter shape: invisible to scopes, export, and reset
ROGUE_COUNTS = {"hits": 0, "misses": 0}

dispatch.register(
    "rogue_kernel",
    "kernel_rogue",
    replaces="pallas/rogue.py:1",
    source="csrc/rogue.cu",
    impls=("_registered_lib",),
)


def _registered_lib():
    return _build.lib("rogue")  # the registered impl: allowed


def _rogue_launch_wrapper(x):
    # not in the register(..) impls tuple: loads the library itself
    lib = _build.lib("rogue")
    lib.rogue_launch.restype = ctypes.c_int
    return lib.rogue_launch(x.data_ptr())
