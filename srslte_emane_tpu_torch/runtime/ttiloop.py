"""TTI loop driving a whole emulated network — the txrx.cc / sync.cc clock.

Reference behavior: eNB `txrx` thread (txrx.cc:105-145) and UE `sync` thread
pace one TTI per ms, RX->TX turnaround 4 ms (TX_DELAY, common.h:45).

Here one loop steps every node each TTI (faster than real time unless the bus
is paced); nodes are the phy adapters which pull/push through their stacks.

Deployment-scale design: the loop is EVENT-DRIVEN over sleeping nodes.  A
node that schedules a sleep window (`_sleep_until`, the DRX-like dormant
stride of the UE phy adapter) is removed from the per-TTI run list and
re-inserted by a wake calendar at its wake TTI — or immediately when the bus
delivers it a frame (paging, a grant, a neighbor subframe).  Per-TTI cost is
O(active + woken), not O(nodes): at 200+ registered-idle UEs almost the
whole population is asleep almost every TTI.  Wake times are tracked on an
absolute (non-wrapping) clock so the 10240-TTI wrap cannot stall a sleeper.
"""

from __future__ import annotations

import collections


class Network:
    def __init__(self, bus):
        self.bus = bus
        self.nodes = []  # phy adapters with .run_tti(tti)

    def add(self, node):
        self.nodes.append(node)
        return node

    def run(self, n_ttis: int):
        bus = self.bus
        step = bus.step_tti
        take_woken = getattr(bus, "take_woken", None)
        # nodes without sleep support (eNB adapters) run every TTI
        always = [n for n in self.nodes if not hasattr(n, "_sleep_until")]
        sleepers = [n for n in self.nodes if hasattr(n, "_sleep_until")]
        by_id = {n.node_id: n for n in sleepers}
        # external events between run() calls (gw_send app traffic) must be
        # seen: everyone starts awake and re-sleeps if still dormant.
        # The BUS registry must agree — a stale sleep entry would keep
        # suppressing deliveries (RARs, grants) to a now-running UE
        clear_sleep = getattr(bus, "clear_sleep", None)
        active = list(sleepers)
        for n in active:
            if n._sleep_until and clear_sleep is not None:
                clear_sleep(n.node_id)
            n._sleep_until = 0
            n._asleep = False
        calendar = collections.defaultdict(list)
        for abs_t in range(n_ttis):
            tti = bus.curr_tti
            for n in always:
                n.run_tti(tti)
            for n in calendar.pop(abs_t, ()):
                if n._asleep:  # not already woken early by a delivery
                    n._asleep = False
                    active.append(n)
            still = []
            for n in active:
                n.run_tti(tti)
                su = n._sleep_until
                if su > tti + 1:  # sleeps through at least the next TTI
                    n._asleep = True
                    calendar[abs_t + (su - tti)].append(n)
                else:
                    still.append(n)
            active = still
            step()
            if take_woken is not None:
                for nid in take_woken():
                    n = by_id.get(nid)
                    if n is not None and n._asleep:
                        # delivery while sleeping: stale calendar entry may
                        # fire later as a harmless spurious wake
                        n._asleep = False
                        n._sleep_until = 0
                        active.append(n)
