"""Declarative finite-state-machine helper.
(The port's own copy of ``sora_tpu.mac.fsm``.)

Python equivalent of the reference's FSM macro DSL
(kernel/core/src/_fsm.h:21-60, _fsm.c): states are named, transitions are
(state, event) -> (action, next_state), with entry hooks and an explicit
trace of taken transitions for observability.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Transition:
    src: str
    event: str
    dst: str
    action: Callable[..., Any] | None = None


class Fsm:
    """A tiny table-driven FSM.

    >>> m = Fsm("idle")
    >>> m.on("idle", "go", "run")
    >>> m.fire("go")
    'run'
    """

    def __init__(self, initial: str, name: str = "fsm",
                 trace_depth: int = 64):
        self.name = name
        self.state = initial
        self._table: dict[tuple[str, str], Transition] = {}
        self._entry: dict[str, Callable[[], None]] = {}
        self.trace: list[tuple[str, str, str]] = []
        self._trace_depth = trace_depth

    def on(self, src: str, event: str, dst: str,
           action: Callable[..., Any] | None = None) -> None:
        self._table[(src, event)] = Transition(src, event, dst, action)

    def on_enter(self, state: str, hook: Callable[[], None]) -> None:
        self._entry[state] = hook

    def can(self, event: str) -> bool:
        return (self.state, event) in self._table

    def fire(self, event: str, *args, **kw) -> str:
        t = self._table.get((self.state, event))
        if t is None:
            raise ValueError(
                f"{self.name}: no transition for ({self.state!r}, "
                f"{event!r})")
        self.trace.append((t.src, event, t.dst))
        if len(self.trace) > self._trace_depth:
            del self.trace[0]
        if t.action is not None:
            t.action(*args, **kw)
        if t.dst != self.state:
            self.state = t.dst
            hook = self._entry.get(t.dst)
            if hook is not None:
                hook()
        return self.state
