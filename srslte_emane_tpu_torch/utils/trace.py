"""The port's tracing: host spans, device stage spans and the ring buffer
that keeps them.

Reference behavior: `lib/include/srslte/common/trace.h:38-79` —
`srslte::trace<T>`, a fixed-size ring of timed samples with a binary dump;
per-call `meas_time_en` timing in PDSCH/PUSCH cfg.

Tracing is off by default (`enabled` False).  While it is off, `span`,
`stage` and `group` test their flags and hand back a context that does
nothing, and `phase` records nothing.  Turn it on with `enable(True)`; read the
spans with `spans()`, or write them with
`dump(path)` and read the file back with `Trace.load(path)`.

* `span(name)` is a host span, on the host clock (`time.perf_counter_ns`).
  Under an active `torch.profiler` it is also a range of the profiler's
  host timeline, beside the card's kernels, with the store off too.  The
  range is a plain record function (`_RecordFunctionFast`), not a user
  annotation (`torch.profiler.record_function`): the profiler copies a
  user annotation onto the device's timeline as an event as long as the
  work launched inside it, which a reader of the device's busy time would
  take for device work.
* `stage(name, device)` is a device stage span, and `phase(name)` a child
  of the innermost open stage that runs until the stage's next phase or
  its end, so that a stage's steps may begin in the functions it calls.
  On the card each records a timing `torch.cuda.Event` on the current
  stream at its start and at its end.  While a `StepGraph` captures
  (`capturing`), the events are external event-record nodes of the graph:
  every replay records them again, and the graph hands them to `replayed`
  after each replay.  Eagerly they are plain events.  The times are
  resolved later (`Group`), as offsets on the device's clock from the
  first event of their group (a replay's, or an eager stage's own),
  before the group's events are recorded again, at `spans()`, or once
  more than `PENDING` newer groups wait, whichever comes first.  Off the
  card a stage is timed on the host clock.  A capture that keeps no
  stages (`capturing(None)`, or any capture outside `graphs`) and a
  graph's warm-up (`muted`) record none.
* `request(i)` stamps request id i on every span opened inside it.

Every program span's name starts with its layer: `graphs.`, `link.`,
`tx.`, `rx.`.
"""

from __future__ import annotations

import contextlib
import struct
import time
import typing

import numpy as np
import torch
import torch.autograd.profiler as _profiler

CLOCKS = ("host", "device")
HOST, DEVICE = 0, 1


class Span(typing.NamedTuple):
    id: int
    name: str
    parent: int  # the parent span's id, -1 for none
    request: int  # -1 outside any `request`
    clock: str  # "host" or "device"
    start_ns: int  # -1 until the span is resolved
    end_ns: int


_RECORD = struct.Struct("<qiqqbqq")  # id, name index, parent, request, clock, start, end


class Trace:
    """A fixed-capacity ring of span records: the newest `capacity` of
    them are kept.  A record's id is its sequence number; `open` hands one
    out, `close` and `resolve` fill in its times while it is still kept."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self.name = np.zeros(capacity, dtype=np.int32)
        self.parent = np.zeros(capacity, dtype=np.int64)
        self.request = np.zeros(capacity, dtype=np.int64)
        self.clock = np.zeros(capacity, dtype=np.int8)
        self.start = np.zeros(capacity, dtype=np.int64)
        self.end = np.zeros(capacity, dtype=np.int64)
        self.names, self._name_ids = [], {}
        self.n = 0  # records ever opened
        self.first = 0  # the first id that `clear` kept

    def _kept(self, rid: int) -> bool:
        return max(self.first, self.n - self.capacity) <= rid < self.n

    def open(self, name: str, parent: int = -1, request: int = -1, clock: int = HOST,
             start_ns: int = -1) -> int:
        i = self._name_ids.get(name)
        if i is None:
            i = self._name_ids[name] = len(self.names)
            self.names.append(name)
        rid, j = self.n, self.n % self.capacity
        self.name[j], self.parent[j], self.request[j] = i, parent, request
        self.clock[j], self.start[j], self.end[j] = clock, start_ns, -1
        self.n += 1
        return rid

    def close(self, rid: int, end_ns: int) -> None:
        if self._kept(rid):
            self.end[rid % self.capacity] = end_ns

    def resolve(self, rid: int, start_ns: int, end_ns: int) -> None:
        if self._kept(rid):
            j = rid % self.capacity
            self.start[j], self.end[j] = start_ns, end_ns

    def clear(self) -> None:
        self.first = self.n

    def records(self) -> list:
        """The kept records, oldest first, as `Span`s."""
        out = []
        for rid in range(max(self.first, self.n - self.capacity), self.n):
            j = rid % self.capacity
            out.append(Span(rid, self.names[self.name[j]], int(self.parent[j]),
                            int(self.request[j]), CLOCKS[self.clock[j]], int(self.start[j]),
                            int(self.end[j])))
        return out

    def dump(self, path: str) -> None:
        """Binary dump: the names (u32 count, then u16 length and UTF-8
        bytes each), then the records (u32 count, then i64 id, i32 name
        index, i64 parent, i64 request, i8 clock, i64 start, i64 end)."""
        recs = self.records()
        with open(path, "wb") as f:
            f.write(struct.pack("<I", len(self.names)))
            for name in self.names:
                b = name.encode()
                f.write(struct.pack("<H", len(b)) + b)
            f.write(struct.pack("<I", len(recs)))
            for r in recs:
                f.write(_RECORD.pack(r.id, self._name_ids[r.name], r.parent, r.request,
                                     CLOCKS.index(r.clock), r.start_ns, r.end_ns))

    @staticmethod
    def load(path: str) -> list:
        """The `Span`s of a dump."""
        with open(path, "rb") as f:
            (n_names,) = struct.unpack("<I", f.read(4))
            names = []
            for _ in range(n_names):
                (k,) = struct.unpack("<H", f.read(2))
                names.append(f.read(k).decode())
            (k,) = struct.unpack("<I", f.read(4))
            out = []
            for _ in range(k):
                rid, name, parent, req, clock, start, end = _RECORD.unpack(f.read(_RECORD.size))
                out.append(Span(rid, names[name], parent, req, CLOCKS[clock], start, end))
        return out


enabled = False
_store = Trace()
_stack = []  # the open spans' ids, innermost last: the next span's parent
_request = -1
_muted = 0
_capture = None  # the `Capture` of a StepGraph that is capturing
_group = None  # the `Group` that eager stages on the card join
_pending = []  # groups whose times are not resolved yet


def enable(on: bool = True) -> None:
    global enabled
    enabled = bool(on)


@contextlib.contextmanager
def request(i: int):
    """Every span opened inside has request id i."""
    global _request
    was, _request = _request, int(i)
    try:
        yield
    finally:
        _request = was


def _parent() -> int:
    return _stack[-1] if _stack else -1


class _Null:
    def __enter__(self):
        return -1

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _HostSpan:
    """A span on the host clock, in the store when tracing is on and not
    muted, and a range of the profiler's host timeline under an active
    profiler."""

    def __init__(self, name: str, profiled: bool):
        self.name, self.range, self.rid = name, None, -1
        if profiled:
            self.range = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if enabled and not _muted and _capture is None:
            self.rid = _store.open(self.name, _parent(), _request, HOST, time.perf_counter_ns())
            _stack.append(self.rid)
        return self.rid

    def __exit__(self, *exc):
        if self.rid >= 0:
            _store.close(self.rid, time.perf_counter_ns())
            _stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A host span (a context; `with` gives its id, -1 when it records
    nothing)."""
    profiled = _profiler._is_profiler_enabled
    if not (enabled or profiled):
        return _NULL
    return _HostSpan(name, profiled)


class Capture:
    """The stage events that a graph's capture recorded, in the order they
    opened: [name, index of the enclosing stage or -1, start, end]."""

    def __init__(self):
        self.stages, self.open = [], []


class Group:
    """Device spans whose events lie on one stream, timed from its first
    event: [(record id, start event, end event)].  As a context (`group`),
    the group that the eager device stages inside, and the captured stages
    handed to `replayed`, join."""

    def __init__(self):
        self.items, self.base, self.done, self.was = [], None, False, None

    def add(self, rid: int, start, end) -> None:
        if self.base is None:
            self.base = start
        self.items.append((rid, start, end))

    def resolve(self) -> None:
        """The spans' times, once their events are done (a wait on the last
        one: none in a loop whose calls are waited for)."""
        if self.done:
            return
        self.done = True
        if self in _pending:
            _pending.remove(self)
        if not self.items:
            return
        self.items[-1][2].synchronize()
        ns = lambda ev: int(round(self.base.elapsed_time(ev) * 1e6))
        for rid, a, b in self.items:
            _store.resolve(rid, ns(a), ns(b))

    def __enter__(self):
        global _group
        self.was, _group = _group, self
        return self

    def __exit__(self, *exc):
        global _group
        _group = self.was
        if self.items:
            _hold(self)
        else:
            self.done = True
        return False


PENDING = 64  # the most groups left unresolved: beyond it the oldest is resolved


def _hold(g: Group) -> None:
    """g waits to be resolved; the oldest waiting group is resolved once
    more than PENDING wait (its events are long done in a loop)."""
    _pending.append(g)
    if len(_pending) > PENDING:
        _pending[0].resolve()


def _event(external: bool = False):
    return torch.cuda.Event(enable_timing=True, external=external)


HOST_CLOCK, CAPTURED, EAGER = range(3)  # how a stage is timed


class _Stage:
    """A stage span, timed as `mode` says: on the host clock
    (HOST_CLOCK), as a pair of external events in the capture (CAPTURED),
    or as a pair of plain events on the card (EAGER).  It holds at most one
    open phase (`phase`), which its end ends."""

    def __init__(self, name: str, mode: int):
        self.name, self.mode, self.phase, self.rid, self.own = name, mode, None, -1, None

    def begin(self) -> None:
        global _group
        if self.mode == HOST_CLOCK:
            self.rid = _store.open(self.name, _parent(), _request, HOST, time.perf_counter_ns())
            _stack.append(self.rid)
            return
        self.start = _event(self.mode == CAPTURED)
        self.start.record()
        if self.mode == CAPTURED:
            cap = _capture
            cap.stages.append([self.name, cap.open[-1] if cap.open else -1, self.start, None])
            cap.open.append(len(cap.stages) - 1)
        else:
            self.rid = _store.open(self.name, _parent(), _request, DEVICE)
            _stack.append(self.rid)
            if _group is None:  # an eager stage outside a replay: a group of its own
                self.own = _group = Group()
                self.own.base = self.start

    def end(self) -> None:
        global _group
        if self.phase is not None:
            self.phase.end()
            self.phase = None
        if self.mode == HOST_CLOCK:
            _store.close(_stack.pop(), time.perf_counter_ns())
            return
        stop = _event(self.mode == CAPTURED)
        stop.record()
        if self.mode == CAPTURED:
            _capture.stages[_capture.open.pop()][3] = stop
            return
        _stack.pop()
        _group.add(self.rid, self.start, stop)
        if self.own is not None:
            _group = None
            _hold(self.own)

    def __enter__(self):
        self.begin()
        _stages.append(self)
        return self.rid

    def __exit__(self, *exc):
        _stages.pop()
        self.end()
        return False


_stages = []  # the open stages (`with stage`), innermost last: they hold the phases


def stage(name: str, device=None):
    """A stage span over the work that the block enqueues on `device` (a
    context; see the module's docstring)."""
    if not enabled or _muted:
        return _NULL
    if device is None or torch.device(device).type != "cuda":
        return _NULL if _capture is not None else _Stage(name, HOST_CLOCK)
    if _capture is not None:
        return _Stage(name, CAPTURED)
    if torch.cuda.is_current_stream_capturing():
        return _NULL
    return _Stage(name, EAGER)


def phase(name: str) -> None:
    """Ends the innermost open stage's phase, if it has one, and begins its
    phase `name`, a child span timed as the stage is: a stage's phases
    follow one another, each from its `phase` call to the next one or to
    the stage's end, across the functions that the stage calls.  Outside
    every stage, nothing."""
    if not _stages:
        return
    holder = _stages[-1]
    if holder.phase is not None:
        holder.phase.end()
    holder.phase = _Stage(name, holder.mode)
    holder.phase.begin()


@contextlib.contextmanager
def muted():
    """Nothing is recorded inside (a graph's warm-up)."""
    global _muted
    _muted += 1
    try:
        yield
    finally:
        _muted -= 1


@contextlib.contextmanager
def capturing(capture):
    """A capture: device stages go into `capture` (a `Capture`) as graph
    nodes, and no span enters the store; with None, no stage records."""
    global _capture, _muted
    was, _capture = _capture, capture
    _muted += capture is None
    try:
        yield
    finally:
        _capture = was
        _muted -= capture is None


class _NoGroup(_Null):
    def __enter__(self):
        return None


_NO_GROUP = _NoGroup()


def group(device):
    """A replay's group (a context that gives the `Group`): the eager
    device stages inside, and the captured stages handed to `replayed`, are
    timed from its first event.  When tracing is off or `device` is not a
    card, a context that gives None."""
    if not enabled or _muted or torch.device(device).type != "cuda":
        return _NO_GROUP
    return Group()


def replayed(capture, parent: int) -> None:
    """A replay of a graph whose capture recorded `capture`'s stages (a
    `Capture`, or None for a graph captured with tracing off): their spans,
    under `parent`, join the open group."""
    if _group is None or capture is None or not capture.stages:
        return
    rids = []
    for name, up, start, end in capture.stages:
        rid = _store.open(name, parent if up < 0 else rids[up], _request, DEVICE)
        rids.append(rid)
        _group.add(rid, start, end)


def spans() -> list:
    """Every kept span, oldest first, with the device spans resolved."""
    for g in list(_pending):
        g.resolve()
    return _store.records()


def reset() -> None:
    """Drop every span, and the device spans not resolved yet."""
    for g in _pending:
        g.done = True
    _pending.clear()
    _store.clear()


def dump(path: str) -> None:
    """`spans()` written to `path` (`Trace.dump`)."""
    spans()
    _store.dump(path)
