"""The program's spans on ``torch.profiler``'s timeline.

``span(name)`` marks a step of the planner, the executor or a kernel launch as
a range named ``repro_torch.<name>`` in the profiler's record, and only while
a profiler records: run the program under ``torch.profiler`` to get them.
They sit on the profiler's clock beside the device's events, each nested in
the span that encloses it on the calling thread.  With no profiler recording,
``span`` costs one check of the profiler's flag and returns one shared
do-nothing context manager.  While one records, a span is a
``_RecordFunctionFast`` range: a ``record_function`` range without its op
dispatch and its range on the device's timeline, at about a tenth of its host
cost (1.95 us against 14.76 us a span under a CPU + CUDA profiler, on the
host of an NVIDIA H100 80GB HBM3).
"""
from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``repro_torch.<name>`` while a profiler
    records, and does nothing otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(PREFIX + name)
