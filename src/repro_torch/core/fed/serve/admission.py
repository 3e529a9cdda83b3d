"""Continuous-batching admission over a FIXED slot grid (the port's own
copy of ``repro.core.fed.serve.admission``: plain Python and numpy).

The decode scheduler's serving idiom applied to federation sessions: a
group owns S slots (the stacked buffers the slots index into are
allocated once, at the grid's first admission), queued sessions
claim idle slots each tick in FIFO order, and a finished session frees
its slot IMMEDIATELY for the next queued one — no waiting for the
whole stack to drain.

Admission is deterministic by construction: the queue is FIFO and idle
slots are claimed lowest-index-first, so replaying the same submission
sequence reproduces the same (session -> slot, tick) assignment —
which is what makes stacked serving runs replayable and the slot-reuse
test in ``tests/test_torch_fed_serve.py`` exact.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np


class SlotGrid:
    """Slot bookkeeping: who occupies which slot, who waits.

    ``n_slots`` starts at 0 and MATERIALIZES at the first ``admit`` as
    ``min(cap, queue length)`` — a group serving 100 tenants on a
    512-cap server gets a 100-wide grid, not 512 slots of masked-out
    garbage compute (idle slots still run the stacked round; an
    oversized grid taxes every tick for the group's whole lifetime).
    Once materialized the width is frozen: the stacked buffers are
    allocated once per group and later arrivals queue for freed slots.

    Pure host-side accounting — the stacked tensors the slots index
    into live with the group (``repro_torch.core.fed.serve.groups``).
    """

    def __init__(self, cap: int):
        if cap < 1:
            raise ValueError(f"need cap >= 1, got {cap}")
        self.cap = cap
        self.n_slots = 0                        # set at first admit
        self.sid: List[Optional[str]] = []
        self.queue: Deque[str] = deque()

    # -- submission / admission ----------------------------------------
    def submit(self, sid: str) -> None:
        """Enqueue a session for admission (FIFO)."""
        if sid in self.queue or sid in self.sid:
            raise ValueError(f"session {sid!r} already queued or seated")
        self.queue.append(sid)

    def admit(self) -> List[Tuple[int, str]]:
        """Claim idle slots for queued sessions — lowest slot index
        first, queue order preserved. Returns the (slot, sid) claims
        made this call. The first call sizes the grid to the queue
        present (capped)."""
        if self.n_slots == 0:
            if not self.queue:
                return []
            self.n_slots = min(self.cap, len(self.queue))
            self.sid = [None] * self.n_slots
        claims: List[Tuple[int, str]] = []
        for i in range(self.n_slots):
            if not self.queue:
                break
            if self.sid[i] is None:
                sid = self.queue.popleft()
                self.sid[i] = sid
                claims.append((i, sid))
        return claims

    # -- release --------------------------------------------------------
    def free(self, slot: int) -> str:
        """Release a slot (its session finished or was preempted)."""
        sid = self.sid[slot]
        if sid is None:
            raise ValueError(f"slot {slot} is already free")
        self.sid[slot] = None
        return sid

    def slot_of(self, sid: str) -> Optional[int]:
        try:
            return self.sid.index(sid)
        except ValueError:
            return None

    # -- views ----------------------------------------------------------
    def active_mask(self) -> np.ndarray:
        """(S,) bool — which slots hold a live session."""
        return np.asarray([s is not None for s in self.sid], bool)

    @property
    def n_active(self) -> int:
        return int(self.active_mask().sum())

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    @property
    def idle(self) -> bool:
        return self.n_active == 0 and not self.queue
