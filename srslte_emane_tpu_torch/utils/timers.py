"""TTI-stepped timers and resumable procedures.

Reference behavior: `lib/include/srslte/common/timers.h` (timer wheel with
unique-timer handles, run/stop/expiry callbacks stepped once per TTI) and
`lib/include/srslte/common/stack_procedure.h` (the coroutine-style
resumable-procedure framework the UE RRC builds its cell-selection /
connection / reestablishment procedures on).

TPU-framework design: plain-Python host constructs (the control plane never
runs on device).  Procedures are real Python generators — `yield` suspends
until the next `step()`, `yield t` (a Timer) suspends until that timer
expires or is stopped — which is the idiomatic counterpart of the
reference's hand-rolled `then()/react()` state machines.
"""

from __future__ import annotations

import collections
import heapq


class Timer:
    """One timer slot (timers.h `unique_timer`)."""

    __slots__ = ("_hdl", "id", "duration", "_deadline", "_running",
                 "_expired", "callback")

    def __init__(self, hdl: "TimerHandler", tid: int):
        self._hdl = hdl
        self.id = tid
        self.duration = 0
        self._deadline = None
        self._running = False
        self._expired = False
        self.callback = None

    def set(self, duration_ttis: int, callback=None):
        self.duration = int(duration_ttis)
        if callback is not None:
            self.callback = callback
        return self

    def run(self):
        self._running = True
        self._expired = False
        self._deadline = self._hdl.now + self.duration
        heapq.heappush(self._hdl._pq,
                       (self._deadline, self._hdl._next_tie(), self))
        return self

    def stop(self):
        self._running = False
        self._deadline = None

    @property
    def is_running(self) -> bool:
        return self._running

    @property
    def is_expired(self) -> bool:
        return self._expired

    def time_elapsed(self) -> int:
        if self._deadline is None:
            return self.duration
        return self.duration - max(0, self._deadline - self._hdl.now)

    def _fire(self):
        self._running = False
        self._expired = True
        if self.callback is not None:
            self.callback(self.id)


class TimerHandler:
    """TTI-stepped timer wheel (timers.h `timer_handler`): O(log n) via a
    deadline heap; stopped timers are lazily discarded at their slot."""

    def __init__(self):
        self.now = 0
        self._pq = []
        # plain int counters (not itertools.count): checkpoint snapshots
        # pickle the wheel, and iterator pickling is going away (3.14)
        self._tie = 0
        self._next_id = 0

    def _next_tie(self) -> int:
        self._tie += 1
        return self._tie

    def get_unique_timer(self) -> Timer:
        self._next_id += 1
        return Timer(self, self._next_id)

    def step(self, n: int = 1):
        for _ in range(n):
            self.now += 1
            while self._pq and self._pq[0][0] <= self.now:
                deadline, _, t = heapq.heappop(self._pq)
                if t._running and t._deadline == deadline:
                    t._fire()


class Procedure:
    """Resumable procedure (stack_procedure.h `proc_t`): wraps a generator.

    The generator yields:
      - ``None``  -> resume on the next `step()` (proc_outcome_t::yield)
      - a Timer   -> resume once that timer expires or stops
      - another Procedure -> resume when it completes (sub-procedure launch)
    and `return value` completes the procedure.  `then(cb)` registers
    completion callbacks receiving the result (complete() handlers).
    """

    def __init__(self, gen):
        self._gen = gen
        self._waiting_on = None
        self._done = False
        self.result = None
        self._then = []

    @property
    def is_complete(self) -> bool:
        return self._done

    def then(self, cb):
        if self._done:
            cb(self.result)
        else:
            self._then.append(cb)
        return self

    def step(self):
        """Advance until the next suspension point; returns is_complete."""
        if self._done:
            return True
        w = self._waiting_on
        if w is not None:
            if isinstance(w, Timer) and w.is_running:
                return False
            if isinstance(w, Procedure):
                w.step()
                if not w.is_complete:
                    return False
            self._waiting_on = None
        try:
            self._waiting_on = self._gen.send(None)
        except StopIteration as stop:
            self._done = True
            self.result = stop.value
            for cb in self._then:
                cb(self.result)
        return self._done


class ProcManager:
    """Steps a set of live procedures each TTI (stack_procedure.h
    `proc_manager_list_t`); completed procedures drop out."""

    def __init__(self):
        self._procs = collections.deque()

    def launch(self, gen_or_proc) -> Procedure:
        p = (gen_or_proc if isinstance(gen_or_proc, Procedure)
             else Procedure(gen_or_proc))
        self._procs.append(p)
        return p

    def step(self):
        for _ in range(len(self._procs)):
            p = self._procs.popleft()
            if not p.step():
                self._procs.append(p)

    def __len__(self):
        return len(self._procs)
