"""The port's own record of where a frame's host time goes: spans and counters.

One module-level registry, `REGISTRY`, holds both.

* **Spans.** `with span(name, **attrs):` keeps, when the block ends, the
  span in a ring of the last `CAPACITY` spans; a reader gets each as a
  record `(id, parent_id, name, frame, t0_ns, t1_ns, attrs)`: `id` is unique
  among the records and their parents, `parent_id` is the innermost span
  open when this one opened (-1 for none), `frame` is `REGISTRY.frame` (the
  Renderer sets it to the index of the frame it issues, and between frames
  to the next one, so a scene update is stamped with the frame it
  prepares), and the times are `time.perf_counter_ns()`. `attrs` holds
  small integers (`depth`, `lanes`, `bytes`) and a kernel's name, or None.
  The record is plain Python on the host: a span never synchronises, reads
  a tensor back or launches anything. While a `torch.profiler` is active
  each span also opens `torch.profiler.record_function(label)`, so the
  spans sit in the profiler's trace on the device operations' clock. The
  label is the name, but for a kernel span `kernel/<its LAUNCHES key>`: the
  profiler's trace export renames an annotation called `kernel`.
* **Counters.** Named dicts of integers (`counter`): each kernel module's
  `LAUNCHES` (card launches by kernel name: the six trace dicts, K3's
  `launches.sortpos`, and ReSTIR's `launches.restir`, the sort key's
  `launches.sortkey` (by variant: treelet, morton, octant), hit shading's
  `launches.shade` and the bounce kernels' `launches.bounce` (`scatter`,
  `resolve`: one each a bounce), which have no `kernel` span: their
  launches sit in the integrator's `restir`, `sort`, `shade` and `bounce`
  spans), `parallel/sharding.py`'s `GATHER_BYTES`, and `LANES`, the lanes
  handed to each kernel's dispatch wrapper (`kernel`), on the card and on
  the CPU alike.

`snapshot()` hands readers a copy of both. Nothing is written to a file:
the profiler exports its own trace. The frame loop is driven from one
thread; the registry takes no lock.
"""

from __future__ import annotations

import functools
import time

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

CAPACITY = 1 << 16  # records: a 40 s window of ~300 frames x ~50 spans, with room

_now = time.perf_counter_ns


class Registry:
    """The ring of closed spans, the innermost open span and the counters."""

    __slots__ = ("capacity", "ring", "written", "open", "frame", "counters")

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.ring: list = [None] * capacity
        self.written = 0  # spans ever closed; past `capacity` the oldest are gone
        self.open: span | None = None
        self.frame = 0  # stamped on every span as it closes
        self.counters: dict[str, dict] = {}

    def records(self) -> list[tuple]:
        """The records of the spans the ring still holds, oldest first. A
        span holds its parent, so an id (the object's `id()`) stays unique."""
        n, cap = self.written, self.capacity
        spans = self.ring[:n] if n <= cap else self.ring[n % cap:] + self.ring[:n % cap]
        return [(id(s), -1 if s.parent is None else id(s.parent), s.name, s.frame, s.t0,
                 s.t1, s.attrs) for s in spans]


REGISTRY = Registry()


class span:
    """Context manager of one span; see the module's docstring. `add`
    attaches attributes known only inside the block (a byte count)."""

    __slots__ = ("name", "attrs", "parent", "frame", "t0", "t1", "_rf")

    def __init__(self, name: str, /, **attrs):
        self.name = name
        self.attrs = attrs or None

    @property
    def label(self) -> str:
        """The profiler's name for the span."""
        return self.name

    def add(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self) -> "span":
        r = REGISTRY
        self.parent = r.open
        r.open = self
        self._rf = (record_function(self.label).__enter__()
                    if _autograd_profiler._is_profiler_enabled else None)
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.t1 = _now()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        r = REGISTRY
        r.open = self.parent
        self.frame = r.frame
        i = r.written
        r.ring[i % r.capacity] = self
        r.written = i + 1

    @property
    def seconds(self) -> float:
        """The closed span's duration."""
        return (self.t1 - self.t0) * 1e-9


def spanned(name: str):
    """Decorator: the function's every call runs inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)

        return inner

    return wrap


def counter(name: str, **start: int) -> dict:
    """A new dict of counters registered under `name`; the module that
    counts keeps it as its attribute, so readers and the registry share
    one object."""
    d = dict(start)
    REGISTRY.counters[name] = d
    return d


# lanes handed to each kernel's dispatch wrapper, by its LAUNCHES key
LANES = counter("lanes")


class kernel(span):
    """The span of one call of a kernel's dispatch wrapper: `key` is the
    kernel's LAUNCHES key, `lanes` the rays or keys it is handed
    (o.shape[0]), also added to LANES. Its name is `kernel` and its
    attributes {"name": key, "lanes": lanes}, made only when read."""

    __slots__ = ("key", "lanes")
    name = "kernel"

    def __init__(self, key: str, lanes: int):
        LANES[key] = LANES.get(key, 0) + lanes
        self.key = key
        self.lanes = lanes

    @property
    def attrs(self) -> dict:
        return {"name": self.key, "lanes": self.lanes}

    @property
    def label(self) -> str:
        return "kernel/" + self.key


def snapshot() -> dict:
    """A copy for readers: `records` (oldest first), `written`, `capacity`
    and `counters` (name -> a copy of its dict)."""
    r = REGISTRY
    return {"records": r.records(), "written": r.written, "capacity": r.capacity,
            "counters": {k: dict(v) for k, v in r.counters.items()}}
