"""Spans at the port's layer boundaries, on ``torch.profiler``'s clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records on the calling thread, and one shared no-op context
otherwise: the check costs ~0.2 us where an ungated range costs ~15 us.
The spans thus show in any caller's ``torch.profiler.profile`` trace (the
training CLI's ``--profile`` among them), beside the device's kernels on
the same clock, and cost nothing without one. Every name starts with
``pointvs.``. A profiler records only the thread that started it, so the
loader's producer thread has no spans; the consumer's wait for it does
(``pointvs.train.next_batch``).

While a profiler records, each closed span is also kept as ``(name,
start_ns, end_ns)`` on ``time.perf_counter_ns`` (the newest ``KEPT``);
``take_spans`` hands them over and forgets them, as the kernels' launch
counters are read in the process that ran them. ``count(name, value)``
keeps a count the same way, only while a profiler records, and
``take_counts`` hands the counts over.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque

import torch
from torch.autograd import _profiler_enabled

KEPT = 1 << 16
NO_SPAN = contextlib.nullcontext()
_closed: deque = deque(maxlen=KEPT)
_counts: deque = deque(maxlen=KEPT)


class _Span:
    """One recorded range, kept when it closes."""

    __slots__ = ('name', 'range', 'start')

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)
        self.start = 0

    def __enter__(self):
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _closed.append((self.name, self.start, end))
        return False


def span(name: str):
    """A range named ``name`` while a profiler records on this thread;
    ``NO_SPAN`` otherwise."""
    return _Span(name) if _profiler_enabled() else NO_SPAN


def take_spans() -> list:
    """The spans closed while a profiler recorded, oldest first, as
    ``(name, start_ns, end_ns)``; forgotten here once taken."""
    out = list(_closed)
    _closed.clear()
    return out


def count(name: str, value: int) -> None:
    """Keep ``(name, value)`` while a profiler records on this thread;
    nothing otherwise."""
    if _profiler_enabled():
        _counts.append((name, value))


def take_counts() -> list:
    """The counts kept while a profiler recorded, oldest first, as
    ``(name, value)``; forgotten here once taken."""
    out = list(_counts)
    _counts.clear()
    return out
