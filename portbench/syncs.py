"""Device->host syncs, counted under torch's sync debug mode: a frozen copy
of the recorder in ``tpu_cypher_torch/analysis/synctrace.py``
(``cuda_sync_trace``), counting where that one keeps stacks."""

from __future__ import annotations

import contextlib
import warnings
from typing import Iterator, List

_SYNC_WARNING = "synchronizing CUDA operation"


@contextlib.contextmanager
def cuda_sync_count(torch, sink: List[int]) -> Iterator[None]:
    """Append 1 to ``sink`` for every synchronizing CUDA call made inside
    the block; the mode and the warning filters are restored on exit,
    however the block ends."""

    def hook(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING in str(message):
            sink.append(1)
        else:
            shown(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
