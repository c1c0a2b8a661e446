"""Profiler ranges on the port's query and build paths.

``span(name)`` opens a range in the running ``torch.profiler`` trace, so
the program's phases sit on the same clock as the device's kernels and
copies: an idle stretch of the device can be put down to the phase the
host was in, and a kernel to the phase that launched it.  With no
profiler running it returns one shared ``nullcontext`` after a single
check (``torch.autograd._profiler_enabled``, a fraction of a
microsecond), so the untraced query path pays only that check per site.

The ranges are host ops (the profiler's ``cpu_op`` kind, through
``torch._C._profiler._RecordFunctionFast``), not ``record_function``'s
user annotations: the profiler makes no device copy of them, so a union
of device activity over the trace does not count them as device work,
and each costs a few microseconds while profiling against about fifteen.

The names (``SPANS``), outermost first; the spans of one batch nest
under its ``hlsh.query``, whose direct children are the batch's phases:

  ``hlsh.query``          ``HybridLSHIndex.query`` / ``DynamicHybridIndex
                          .query``: the whole call
  ``hlsh.hash``           the query bucket ids (``family.bucket_ids``)
  ``hlsh.estimate``       ``QueryEngine.estimate``: K3, the other
                          segments' terms, ``finalize_route``
  ``hlsh.delta.counts``   the delta's exact counts (``collision_stats``),
                          inside ``hlsh.estimate`` or a traced batch's
                          candidate count
  ``hlsh.route``          the route decision to the host and the split
  ``hlsh.search.lsh``,    one routed group: its query indices to the
  ``hlsh.search.linear``  device and ``search_group``
  ``hlsh.delta.search``   the delta's LSH route, inside ``hlsh.search
                          .lsh`` (its linear route is its part of
                          ``ops.grouped_linear_scan``)
  ``hlsh.build``          Algorithm 1 (both indexes' ``build``)
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["span", "SPANS"]

SPANS = ("hlsh.query", "hlsh.hash", "hlsh.estimate", "hlsh.delta.counts",
         "hlsh.route", "hlsh.search.lsh", "hlsh.search.linear",
         "hlsh.delta.search", "hlsh.build")

_NULL = contextlib.nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A profiler range named ``name`` while a profiler runs, else the
    shared null context."""
    if _profiling():
        return _RANGE(name)
    return _NULL
