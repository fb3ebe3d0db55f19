"""Cooperative cancellation (counterpart of faiss_tpu/callbacks.py;
reference: faiss/impl/AuxIndexStructures.h:138 InterruptCallback /
TimeoutCallback).

The graph builds of models/hnsw.py and models/nsg.py poll
``InterruptCallback`` from a watchdog thread and forward an interruption
into the native loop, which stops at its next node; a CUDA kernel is not
interruptible mid-launch (the granularity of one OpenMP region in the
reference)."""

from __future__ import annotations

import time
from typing import Callable, Optional


class InterruptedException(RuntimeError):
    pass


class InterruptCallback:
    """reference: AuxIndexStructures.h:138."""

    instance: Optional["InterruptCallback"] = None

    def want_interrupt(self) -> bool:
        return False

    @classmethod
    def check(cls) -> None:
        if cls.instance is not None and cls.instance.want_interrupt():
            raise InterruptedException("computation interrupted")

    @classmethod
    def is_interrupted(cls) -> bool:
        return cls.instance is not None and cls.instance.want_interrupt()

    @classmethod
    def clear_instance(cls) -> None:
        cls.instance = None


class TimeoutCallback(InterruptCallback):
    """Interrupt after a deadline (reference: AuxIndexStructures.h:167)."""

    def __init__(self, timeout_s: float):
        self.deadline = time.time() + timeout_s

    def want_interrupt(self) -> bool:
        return time.time() > self.deadline

    @classmethod
    def reset_timeout(cls, timeout_s: float) -> "TimeoutCallback":
        cb = cls(timeout_s)
        InterruptCallback.instance = cb
        return cb


class PythonInterruptCallback(InterruptCallback):
    """Delegate to a python predicate (reference: python_callbacks.h)."""

    def __init__(self, fn: Callable[[], bool]):
        self.fn = fn

    def want_interrupt(self) -> bool:
        return bool(self.fn())
