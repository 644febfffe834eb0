"""Stage spans and work counters inside the receivers, timed on the device.

Spans record only while a ``torch.profiler`` profile runs or inside
:func:`capture`.  Otherwise :func:`span` is one flag test and one
``torch.autograd._profiler_enabled()`` call and returns a shared no-op
context manager (no allocation, no event, no ``record_function``), and
:func:`stage`, :func:`count` and :func:`recording` are one flag test.

A recording span

* enters ``torch.profiler.record_function(name)``, so it shows in the
  profiler's trace on the clock of the device operations, nested under
  the spans around it;
* when ``on`` names a CUDA device (a tensor, a ``torch.device`` or a
  device string), records a timing ``torch.cuda.Event`` on that device's
  current stream at enter and at exit;
* keeps the name, the host duration and the event pair in memory.

:func:`stage` splits the innermost open span of the thread into
consecutive stages: ``stage("rx.equalize")`` ends the stage running in it
(if any) and starts a new one, a child span that ends at the next
``stage`` or with the enclosing span.  Consecutive stages share their
boundary event, so a call of six stages records six events::

    with spans.span("rx.call", x):
        spans.stage("rx.sync")
        ...
        spans.stage("rx.equalize")
        ...

Nothing is written out during a run.  :func:`totals` resolves the event
pairs (after the caller has drained the card) into per-name sums::

    with spans.capture():
        out = rx_pipeline(x, 54)
    torch.cuda.synchronize()
    t = spans.totals()
    t["spans"]["rx.sync"]     # {"calls", "device_ms", "host_ms"}
    t["counters"]["viterbi.steps_run"]
    spans.reset()

``device_ms`` is the summed event-to-event time on the stream, the
stage's device work and any wait for the host inside it (None for a name
no span of which timed a device); ``host_ms`` the summed host time from
enter to exit.  :func:`count` adds to a counter while a span records on
the calling thread.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import torch
from torch.autograd import _profiler_enabled

_capturing = 0               # depth of open capture() blocks
_open = 0                    # recording spans open on any thread
_tls = threading.local()     # .top: this thread's innermost open span
_lock = threading.Lock()
_pending = []                # (name, host_s, start event, end event)
_spans = {}                  # name -> [calls, device_ms or None, host_ms]
_counters = {}
_FOLD_AT = 4096              # pending records before the finished fold


class _Off:
    """The shared context manager of a span that does not record."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def _stream(on):
    if on is None:
        return None
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type != "cuda":
        return None
    return torch.cuda.current_stream(dev)


def _mark(stream):
    """A timing event recorded now on ``stream`` (None without one)."""
    if stream is None:
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record(stream)
    return e


def _keep(name: str, host_s: float, e0, e1) -> None:
    with _lock:
        _pending.append((name, host_s, e0, e1))
        if len(_pending) >= _FOLD_AT:
            _fold(finished_only=True)


class _Span:
    __slots__ = ("name", "stream", "rf", "t0", "e0", "up", "sub")

    def __init__(self, name: str, on):
        self.name = name
        self.stream = _stream(on)
        self.sub = None

    def __enter__(self):
        global _open
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.e0 = _mark(self.stream)
        self.t0 = time.perf_counter()
        self.up = getattr(_tls, "top", None)
        _tls.top = self
        with _lock:
            _open += 1
        return None

    def stage(self, name: str) -> None:
        t = time.perf_counter()
        if self.sub is None:
            e = self.e0              # nothing ran since this span began
            t0 = self.t0
        else:
            e = self._end_sub(t)
            t0 = t
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self.sub = (name, rf, t0, e)

    def _end_sub(self, t: float):
        name, rf, t0, e0 = self.sub
        e1 = _mark(self.stream)
        rf.__exit__(None, None, None)
        _keep(name, t - t0, e0, e1)
        self.sub = None
        return e1

    def __exit__(self, *exc):
        global _open
        t = time.perf_counter()
        e1 = self._end_sub(t) if self.sub is not None else _mark(self.stream)
        self.rf.__exit__(*exc)
        _keep(self.name, t - self.t0, self.e0, e1)
        _tls.top = self.up
        with _lock:
            _open -= 1
        return None


def span(name: str, on=None):
    """A context manager around one stage or call; ``on`` says which
    device's stream the device time is taken on (None: host time only)."""
    if _capturing or _profiler_enabled():
        return _Span(name, on)
    return _OFF


def stage(name: str) -> None:
    """End the current stage of this thread's innermost recording span
    and start stage ``name`` in it; nothing when no span records."""
    if _open:
        top = getattr(_tls, "top", None)
        if top is not None:
            top.stage(name)


def recording() -> bool:
    """Whether a span records on this thread (so :func:`count` counts)."""
    return bool(_open) and getattr(_tls, "top", None) is not None


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a span records on this thread."""
    if recording():
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


@contextmanager
def capture():
    """Spans and counters record inside this block without a profiler
    running.  It neither clears nor reads them: see :func:`totals` and
    :func:`reset`."""
    global _capturing
    with _lock:
        _capturing += 1
    try:
        yield
    finally:
        with _lock:
            _capturing -= 1


def _fold(finished_only: bool = False) -> None:
    """Move pending records into the per-name sums (the caller holds
    ``_lock``); with ``finished_only`` stop at the first record whose end
    event has not completed."""
    done = 0
    for name, host_s, e0, e1 in _pending:
        if e1 is not None:
            if finished_only and not e1.query():
                break
            e1.synchronize()
        row = _spans.setdefault(name, [0, None, 0.0])
        row[0] += 1
        row[2] += host_s * 1e3
        if e0 is not None:
            row[1] = (row[1] or 0.0) + e0.elapsed_time(e1)
        done += 1
    del _pending[:done]


def totals() -> dict:
    """``{"spans": {name: {"calls", "device_ms", "host_ms"}}, "counters":
    {name: n}}`` over everything recorded since the last :func:`reset`.
    Waits for the recorded end events, so drain the card first where the
    wait matters."""
    with _lock:
        _fold()
        return {"spans": {n: {"calls": c, "device_ms": d, "host_ms": h}
                          for n, (c, d, h) in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    """Clear every span record and counter (waits for the recorded end
    events, as :func:`totals` does)."""
    with _lock:
        _fold()
        _spans.clear()
        _counters.clear()
