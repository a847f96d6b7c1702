"""Profiler annotations for the serving hot path.

The engine and scheduler wrap their dispatch sites (a prefill chunk, a
class step's replay) in `annotation(name)` contexts.  With profiling off —
the default — the hook returns one shared ``nullcontext`` instance: no
object allocation and nothing in the dispatch path.  With profiling on,
each site becomes a ``torch.profiler.record_function`` range (seen by a
``torch.profiler`` capture) and, on the card, a ``torch.cuda.nvtx`` range
as well, named exactly like the `obs.trace` span names.

The annotations wrap only host-side dispatch: a captured decode step is
the same graph whether profiling is on or off.

Usage::

    from repro_torch.obs import Observability
    obs = Observability(profile=True)
    with torch.profiler.profile() as prof:
        scheduler.run()                  # a scheduler built with obs=obs
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["annotation"]

_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def _ranges(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


def annotation(name: str, enabled: bool = True):
    """A named profiler range; the shared no-op when disabled."""
    if not enabled:
        return _NULL
    return _ranges(name)
