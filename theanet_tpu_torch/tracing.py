"""Spans of the port's own work: in memory on the host clock, and in a
``torch.profiler`` trace on the profiler's clock.

``span(name)`` is a context manager around work the port does once an
epoch or once a test boundary (never once a step). Off (the default) it
returns one shared no-op context: a flag test and a return, no clock read
and no profiler call. On, each span

  * appends a record ``(name, start_ns, end_ns, parent)`` to a bounded
    buffer, with times from ``time.perf_counter_ns()`` and ``parent`` the
    index of the enclosing span in the same buffer, or -1; a span's self
    time is its length less its children's (``self_ns``);
  * while a ``torch.profiler`` session records, opens
    ``torch.profiler.record_function("theanet." + name)``, so the trace
    carries the span on the same clock as the device's kernels. Without a
    session nothing would record the range, and opening one costs tens of
    times what the record does, so a span then opens none.

``enable(on)`` switches the process's recorder, ``take()`` returns its
records and clears them. Records beyond the buffer's cap are dropped and
counted in ``dropped``. The recorder is not thread-safe: the Trainer's
calls come from one thread.
"""

from __future__ import annotations

import time

import torch

__all__ = ["Recorder", "RECORDER", "span", "enable", "take", "self_ns"]

PREFIX = "theanet."
CAP = 1 << 16           # records a buffer holds between two take() calls
_profiling = torch._C._autograd._profiler_enabled


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "name", "record", "func")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.func = None
        if _profiling():
            self.func = torch.profiler.record_function(PREFIX + self.name)
            self.func.__enter__()
        records = rec._records
        if len(records) < CAP:
            self.record = [self.name, 0, None,
                           rec._open[-1] if rec._open else -1]
            rec._open.append(len(records))
            records.append(self.record)
            self.record[1] = time.perf_counter_ns()
        else:
            # a full buffer stays full until take(), so the children of a
            # dropped span are dropped too
            rec._open.append(-1)
            rec.dropped += 1
            self.record = None
        return self

    def __exit__(self, *exc):
        if self.record is not None:
            self.record[2] = time.perf_counter_ns()
        self.rec._open.pop()
        if self.func is not None:
            self.func.__exit__(*exc)
        return False


class Recorder:
    """A span buffer: off until ``enable(True)``; holds at most ``CAP``
    records between two ``take()`` calls and counts the rest in
    ``dropped``."""

    def __init__(self):
        self.on = False
        self.dropped = 0
        self._records = []
        self._open = []     # buffer indices of the open spans, -1: dropped

    def span(self, name):
        if not self.on:
            return _NULL
        return _Span(self, name)

    def enable(self, on=True):
        """Switch recording; switching it on resets ``dropped``."""
        if on and not self.on:
            self.dropped = 0
        self.on = bool(on)

    def take(self):
        """The records ``(name, start_ns, end_ns, parent)`` since the last
        call, in the order the spans opened; the buffer is cleared. A span
        still open has ``end_ns`` None, and its children opened after this
        call record parent -1."""
        out = [tuple(r) for r in self._records]
        self._records = []
        self._open = [-1] * len(self._open)
        return out


def self_ns(records):
    """Each record's self time: its length less its children's."""
    out = [end - start for _, start, end, _ in records]
    for _, start, end, parent in records:
        if parent >= 0:
            out[parent] -= end - start
    return out


RECORDER = Recorder()
span, enable, take = RECORDER.span, RECORDER.enable, RECORDER.take
