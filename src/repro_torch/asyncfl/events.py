"""Deterministic event schedule for buffered-async federation (numpy
only, a copy of the JAX package's ``asyncfl/events.py``).

The async runtime is a discrete-event simulation over in-flight client
uploads. Each of the K slots (slot == client vid under the dense fleet)
carries a pending upload with a simulated ``arrival_time`` and the global
``seq`` number of its dispatch (the latency stream id — see
:mod:`repro_torch.asyncfl.clock`). A *flush* pops the B earliest arrivals,
advances the virtual clock to the latest of them, aggregates, and
immediately redispatches those B slots with fresh latency draws.

Because latency draws are pure functions of ``(seed, vid, seq)`` and pops
are ordered by ``(arrival_time, seq)`` (seq breaks timestamp ties, so
simultaneous arrivals pop in dispatch order — this is what makes the
zero-latency-spread degenerate schedule pop ``idx == arange(K)`` and
reduce bit-for-bit to the sync barrier), the entire schedule is a
deterministic function of the initial state. :class:`EventView` exploits
that: a host-side replica of the schedule that the chunked driver rolls
forward to pre-build whole chunks of (idx, flush time, latencies) rows
ahead of execution, exactly like the sync driver pre-builds round
batches.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def earliest_arrivals(arrival_time: np.ndarray, seq: np.ndarray,
                      k: int) -> np.ndarray:
    """Indices of the ``k`` earliest pending uploads, orderd by
    ``(arrival_time, seq)``: earliest timestamp first, dispatch order
    among ties. Returned in pop order (ascending sort order)."""
    order = np.lexsort((np.asarray(seq), np.asarray(arrival_time)))
    return np.ascontiguousarray(order[:k])


@dataclass
class EventView:
    """Mutable host replica of the in-flight arrival schedule.

    ``pop(b, latency_model)`` advances it by one flush: selects the B
    earliest arrivals, moves the clock to the last of them, and replaces
    the popped slots with fresh dispatches (new seqs, new latency draws)
    timed from the flush instant. Rolling a view forward replays exactly
    the schedule the live runtime will realize, because nothing here
    depends on model state — only on the latency model and the counters.
    """
    arrival_time: np.ndarray   # (K,) float64 pending arrival timestamps
    seq: np.ndarray            # (K,) int64  dispatch seq of each pending upload
    next_seq: int              # global dispatch counter
    clock: float               # virtual time of the last flush

    def __post_init__(self):
        self.arrival_time = np.array(self.arrival_time, np.float64)
        self.seq = np.array(self.seq, np.int64)

    def copy(self) -> "EventView":
        return EventView(self.arrival_time.copy(), self.seq.copy(),
                         int(self.next_seq), float(self.clock))

    def pop(self, b: int, latency_model):
        """Advance by one flush of ``b`` arrivals.

        Returns ``(idx, flush_time, new_seqs, new_latency)``: the popped
        slot indices in pop order, the virtual-clock instant of the
        flush, and the seq numbers / latency draws of the replacement
        dispatches (whose arrivals are scheduled at
        ``flush_time + new_latency``).
        """
        if not 1 <= b <= self.arrival_time.size:
            raise ValueError(f"flush size must be in [1, "
                             f"{self.arrival_time.size}], got {b}")
        idx = earliest_arrivals(self.arrival_time, self.seq, b)
        flush_time = float(self.arrival_time[idx].max())
        new_seqs = self.next_seq + np.arange(b, dtype=np.int64)
        new_latency = np.asarray(latency_model(idx, new_seqs), np.float64)
        self.arrival_time[idx] = flush_time + new_latency
        self.seq[idx] = new_seqs
        self.next_seq = int(self.next_seq) + b
        self.clock = flush_time
        return idx, flush_time, new_seqs, new_latency
