"""Spans of the program's host phases, recorded while a torch profiler runs.

``span(name)`` marks a phase of a search and ``wait(site, nbytes)`` a call
at which the host blocks on the device: a pageable copy up, a read back, a
scalar read. Both are context managers and record only while a torch
profiler runs (``torch.autograd._profiler_enabled()``); there is no other
switch. Off, each is one call that returns a shared null context. On, each
enters ``torch.profiler.record_function(name)``, so an exported Chrome
trace shows the phase nested under the caller's ranges, on the clock of the
device operations, and appends one ``Span`` to a bounded list, timed by
``time.perf_counter_ns()``:

- ``index``: its number in the order spans were entered; ``parent``: the
  index of the span it was entered in, None at a root;
- ``rid``: the request id of its search. A root takes a new one, or the
  one of the handle it is given (``of``: a collect takes its submit's);
  every other span its parent's;
- ``name``, ``start_ns``, ``end_ns``; ``nbytes``: the bytes a wait moves,
  None for a span.

The first span recorded after one found the profiler off empties the list,
so it holds the newest profiling session's spans (a session that follows
another with no span between them adds to it). ``spans()`` returns them
in the order they were entered and ``dropped()`` counts those past
``MAX_SPANS``. A search hands its request id to its collect through
``handle(tag, state)``, which is the plain tuple (tag, state) while the
profiler is off.
"""

from __future__ import annotations

import threading
import time
from collections import namedtuple

import torch

MAX_SPANS = 1 << 20

Span = namedtuple("Span", "index parent rid name start_ns end_ns nbytes")

_enabled = torch.autograd._profiler_enabled
_local = threading.local()
_lock = threading.Lock()
_was_off = True  # a span found the profiler off since the list was last emptied


class _Null:
    """The shared context of every span while the profiler is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL = _Null()


class _Book:
    """The recorder: the newest session's spans and its counters."""

    spans: list = []
    next_index = 0
    next_rid = 0
    dropped = 0


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """One span while it is open."""

    __slots__ = ("name", "rid", "nbytes", "index", "parent", "start", "rf")

    def __init__(self, name, rid, nbytes):
        self.name, self.rid, self.nbytes = name, rid, nbytes

    def __enter__(self):
        global _was_off
        with _lock:
            if _was_off:
                _Book.spans = []
                _was_off = False
                _Book.dropped = 0
                _Book.next_index = 0
            self.index = _Book.next_index
            _Book.next_index += 1
            stack = _stack()
            if stack:
                self.parent, self.rid = stack[-1].index, stack[-1].rid
            else:
                self.parent = None
                if self.rid is None:
                    self.rid = _Book.next_rid
                    _Book.next_rid += 1
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _stack().pop()
        rec = Span(self.index, self.parent, self.rid, self.name, self.start, end,
                   self.nbytes)
        with _lock:
            if len(_Book.spans) < MAX_SPANS:
                _Book.spans.append(rec)
            else:
                _Book.dropped += 1
        return False


def span(name, of=None):
    """A phase of the program; ``of``, a root's search_submit handle, gives
    it that submit's request id."""
    global _was_off
    if not _enabled():
        _was_off = True
        return _NULL
    return _Open(name, getattr(of, "rid", None), None)


def wait(site, nbytes):
    """A blocking host-device call at ``site`` that moves ``nbytes``."""
    global _was_off
    if not _enabled():
        _was_off = True
        return _NULL
    return _Open(site, None, int(nbytes))


class Handle(tuple):
    """A search_submit handle (tag, state) that carries its spans' request
    id to the collect."""

    rid = None


def handle(tag, state):
    """(tag, state), with the request id of the innermost open span while
    the profiler runs."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return (tag, state)
    h = Handle((tag, state))
    h.rid = stack[-1].rid
    return h


def spans():
    """The newest session's spans, in the order they were entered."""
    with _lock:
        return sorted(_Book.spans)


def dropped():
    """Spans of the newest session left out past ``MAX_SPANS``."""
    return _Book.dropped
