"""Spans of the collective path: where a call's host time goes, and when
the device reached each of its rounds.

A span is a named stretch of host time, on ``time.perf_counter_ns()``, with
a parent (the innermost span open on the same thread when it opened) and
attributes (counts and bytes).  The collective path opens four kinds:

* ``collective`` — one call: ``op`` (``all_reduce`` … ``all_to_all``, or
  the fused ``mm_rs`` and ``ar_rmsnorm``), ``algorithm``, ``n`` and
  ``bytes`` (the collective's operand).  A fused seam's fallback opens its
  collective inside the seam's, as a child.
* ``plan`` — finding or building a schedule or its tables: the session's
  plan cache (``Communicator.axis_schedule``), ``compile_schedule``,
  ``compile_all_to_all``, ``device_tables``, ``stream_program`` and the
  fused matmul → reduce-scatter's table upload.
* ``round`` — one round of a compiled schedule on the rank-stacked buffer:
  ``index``, ``reduce``, ``bytes`` (the rows the round's gather reads:
  ranks × chunks × chunk bytes in the buffer's dtype), and ``wire="int8"``
  on the ``ring_ef8`` wire.
* ``tile`` — one step of the fused matmul → reduce-scatter: the gather of
  every rank's tile, K1 and the store (``step``).

``round`` and ``tile`` are leaves.  On a CUDA tensor they also record a
CUDA event at each end, on the tensor's current stream; :func:`records`
puts those events on the host clock (``device_start_ns``,
``device_end_ns``), so ``device_start_ns - start_ns`` is how far the device
trailed the host when the span opened.  The events are recorded through
``libcuda`` (``cuEventRecord``), not the CUDA runtime: ``torch.profiler``
records runtime calls, and one made outside any torch op (as an event
record here would be) can be handed the kernels of an unrelated op whose
id it shares, which a trace reduction that sums an annotation's children
counts twice.

**On and off.**  Spans record while a ``torch.profiler`` session records,
or inside :func:`tracing` (with the profiler off).  Otherwise
:func:`span` tests two flags and returns one shared no-op context: no span
object, no event, no lock.  Turning tracing on after it was off starts a
new session and drops the old record: :func:`tracing` does so on entry, and
under the profiler the first span after the record was read with tracing
off (or after :func:`tracing` ended) does.  A session keeps at most
:data:`LIMIT` spans and counts those it drops (:func:`dropped`).

Reading::

    from repro_torch import spans

    with spans.tracing():
        comm.all_reduce(x)
    for s in spans.records():
        print(s.name, s.parent, (s.end_ns - s.start_ns) / 1e3, s.attrs)
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["LIMIT", "Span", "dropped", "enabled", "records", "span", "tracing"]

#: Spans a session keeps; those opened beyond it are counted, not kept.
LIMIT = 10**6

_LOCK = threading.Lock()
_tracing = False   # inside tracing()
_live = False      # a session is recording; a span opened while False starts one
_record: List["Span"] = []
_dropped = 0
_session = 0
_open = threading.local()  # .stack: this thread's open spans, innermost last


@dataclass(eq=False)
class Span:
    """One span of the newest session.  ``parent`` and ``root`` index
    :func:`records` (``root`` is the outermost span the span lies in, the
    span itself when it has no parent).  Device times are on the host
    clock, None where the span recorded no CUDA event."""

    name: str
    attrs: dict
    on: Optional[torch.Tensor] = field(default=None, repr=False)
    parent: Optional[int] = None
    root: Optional[int] = None
    start_ns: int = 0
    end_ns: Optional[int] = None
    device_start_ns: Optional[int] = None
    device_end_ns: Optional[int] = None
    _index: Optional[int] = field(default=None, repr=False)
    _session: int = field(default=-1, repr=False)
    _events: Optional[list] = field(default=None, repr=False)

    def set(self, **attrs) -> None:
        """Add or replace attributes while the span is open."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        global _dropped
        stack = _stack()
        with _LOCK:
            if not _live:
                _begin()
            if len(_record) >= LIMIT:
                _dropped += 1
                return self
            top = stack[-1] if stack else None
            if top is not None and top._session == _session:
                self.parent, self.root = top._index, top.root
            self._index, self._session = len(_record), _session
            if self.root is None:
                self.root = self._index
            _record.append(self)
        stack.append(self)
        if self.on is not None and self.on.is_cuda:
            index = self.on.device.index
            stream = (index, torch._C._cuda_getCurrentRawStream(index))
            self._events = [stream, _libcuda().record(stream[1]), None]
        self.start_ns = time.perf_counter_ns()  # once the start event is enqueued
        return self

    def __exit__(self, *exc) -> None:
        if self._index is None:
            return
        if self._events is not None:
            self._events[2] = _libcuda().record(self._events[0][1])
        self.end_ns = time.perf_counter_ns()
        self.on = None
        _stack().pop()


class _Off:
    """The context :func:`span` returns while tracing is off."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def span(name: str, on: Optional[torch.Tensor] = None, **attrs):
    """A span named ``name`` with ``attrs``, as a context manager.  ``on``
    (a leaf span's operand) names the CUDA stream its events go on."""
    if not (_tracing or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, attrs, on)


def enabled() -> bool:
    """Whether spans record now."""
    return _tracing or _profiler._is_profiler_enabled


@contextmanager
def tracing() -> Iterator[None]:
    """Record spans inside the block, with the profiler off: a new session
    starts on entry."""
    global _tracing, _live
    with _LOCK:
        outer = _tracing
        _tracing = True
        if not outer:
            _begin()
    try:
        yield
    finally:
        with _LOCK:
            _tracing = outer
            if not outer:
                _live = False


def records() -> List[Span]:
    """The newest session's spans in the order they opened, with their
    device times on the host clock.  Read with tracing off, it also ends
    the session: the next span opened with tracing on starts another."""
    global _live
    with _LOCK:
        if not enabled():
            _live = False
        out = list(_record)
        _resolve(out)
    return out


def dropped() -> int:
    """Spans the newest session opened beyond :data:`LIMIT`."""
    return _dropped


def _begin() -> None:
    """A new session (the caller holds ``_LOCK``); the events of the old
    record's closed spans that were never read go back to the pool."""
    global _record, _dropped, _session, _live
    for s in _record:
        if s._events is not None and s._events[2] is not None:
            _libcuda().release(s._events[1:])
            s._events = None
    _record = []  # lint-ok: every caller holds _LOCK
    _dropped = 0
    _session += 1
    _live = True


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _LibCuda:
    """CUDA events through ``libcuda``, kept in a pool for reuse."""

    def __init__(self) -> None:
        lib = ctypes.CDLL("libcuda.so.1")
        ptr = ctypes.c_void_p
        for name, args in (("cuEventCreate", [ctypes.POINTER(ptr), ctypes.c_uint]),
                           ("cuEventRecord", [ptr, ptr]),
                           ("cuEventSynchronize", [ptr]),
                           ("cuEventElapsedTime", [ctypes.POINTER(ctypes.c_float), ptr, ptr])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        self.lib = lib
        self.free: List[int] = []

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    def record(self, stream: int) -> int:
        """An event recorded on the raw ``stream`` (timing on: flags 0)."""
        try:
            ev = self.free.pop()
        except IndexError:
            handle = ctypes.c_void_p()
            self._check(self.lib.cuEventCreate(ctypes.byref(handle), 0), "cuEventCreate")
            ev = handle.value
        self._check(self.lib.cuEventRecord(ev, stream), "cuEventRecord")
        return ev

    def synchronize(self, ev: int) -> None:
        self._check(self.lib.cuEventSynchronize(ev), "cuEventSynchronize")

    def elapsed_ms(self, start: int, end: int) -> float:
        ms = ctypes.c_float()
        self._check(self.lib.cuEventElapsedTime(ctypes.byref(ms), start, end),
                    "cuEventElapsedTime")
        return ms.value

    def release(self, events) -> None:
        self.free.extend(events)


@functools.cache
def _libcuda() -> _LibCuda:
    return _LibCuda()


def _resolve(spans: List[Span]) -> None:
    """Put closed spans' events on the host clock and return them to the
    pool.  Per stream, after a synchronise, one anchor event (already
    created, so its record is one enqueue) is recorded on the idle stream at
    a host time ``h``; an event ``e`` happened on the device at ``h`` less
    the time from ``e`` to the anchor."""
    by_stream = {}
    for s in spans:
        if s._events is not None and s._events[2] is not None:
            by_stream.setdefault(s._events[0], []).append(s)
    drv = _libcuda() if by_stream else None
    for (index, stream), group in by_stream.items():
        drv.release([drv.record(stream)])  # the anchor's event exists before it is timed
        torch.cuda.synchronize(index)
        t0 = time.perf_counter_ns()
        anchor = drv.record(stream)
        t1 = time.perf_counter_ns()
        drv.synchronize(anchor)
        h = (t0 + t1) // 2
        for s in group:
            _, start, end = s._events
            s.device_start_ns = h - round(drv.elapsed_ms(start, anchor) * 1e6)
            s.device_end_ns = h - round(drv.elapsed_ms(end, anchor) * 1e6)
            drv.release((start, end))
            s._events = None
        drv.release([anchor])
