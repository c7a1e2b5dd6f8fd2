"""Event-counter registry with scoped reset (port of `repro.instrument`).

A module records evidence that a code path ran into a named `EventList`:
`serve.paging.GATHER_EVENTS` (stream "gather") holds one entry for every
call of the legacy gather/scatter paged decode's `PageLayout.gather` /
`scatter`. An entry is appended per Python call, so per eager dispatch or
per CUDA-graph capture, never per replay: native paged decode appends
none, and tests assert that.

The JAX package's two other streams, "skinny_m" and "paged_attn", record
Pallas trace-time events. The port has no trace time; its evidence that a
kernel ran is `kernels.ops.launch_counts()`, which counts every launch, a
graph replay's captured launches included.

The lists are `list` subclasses, and every mutation happens in place, so a
module-global alias (`from ... import GATHER_EVENTS`) stays the registry's
own object:

  * `REGISTRY.scoped(...)` snapshots the named lists (all by default),
    clears them, runs the body and restores the prior contents on exit,
    so a test sees only the events of its own block;
  * `REGISTRY.reset(...)` clears, `REGISTRY.snapshot()` copies (name ->
    tuple of events).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Tuple


class EventList(list):
    """A named, registry-owned event list; a `list` for every caller."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"EventList({self.name!r}, {list(self)!r})"


class EventRegistry:
    """Named event-list store; all mutation is in place (aliases stay live)."""

    def __init__(self) -> None:
        self._lists: Dict[str, EventList] = {}
        self._lock = threading.Lock()

    def event_list(self, name: str) -> EventList:
        """Get or create the named list; repeat calls return the same
        object."""
        with self._lock:
            if name not in self._lists:
                self._lists[name] = EventList(name)
            return self._lists[name]

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._lists))

    def reset(self, *names: str) -> None:
        """Clear the named lists (all registered lists when none given)."""
        for n in names or self.names():
            self.event_list(n).clear()

    def snapshot(self) -> Dict[str, Tuple]:
        """name -> tuple copy of current contents."""
        return {n: tuple(self.event_list(n)) for n in self.names()}

    @contextlib.contextmanager
    def scoped(self, *names: str) -> Iterator[Dict[str, EventList]]:
        """Snapshot and clear the named lists (default: all) in place;
        restore the prior contents in place on exit. Yields name -> list."""
        use = names or self.names()
        stash: Dict[str, List] = {}
        for n in use:
            lst = self.event_list(n)
            stash[n] = list(lst)
            lst.clear()
        try:
            yield {n: self.event_list(n) for n in use}
        finally:
            for n in use:
                lst = self.event_list(n)
                lst.clear()
                lst.extend(stash[n])


REGISTRY = EventRegistry()
