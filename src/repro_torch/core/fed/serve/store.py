"""``CheckpointStore`` — where sessions live when they are not running
(the port of ``repro.core.fed.serve.store``).

A serving deployment holds far more tenants than fit in memory at once,
so the store keeps an LRU-bounded working set of live
``FederationSession`` objects and PARKS the overflow to disk through
``session.save`` / ``FederationSession.resume``: the port's atomic,
torn-file-detecting npz checkpoints, so a parked tenant revived mid-run
is BIT-exact with one that never left memory
(``tests/test_torch_fed_serve.py``). A revived session is rebuilt on
the device it was parked from, its data from the spec's recipe, as the
reference's store does.

Pinning protects the sessions whose state currently lives in a group's
stacked device buffers: those session objects are stale by design
(truth is on the device until retirement syncs it back), so parking
them would checkpoint the wrong state. The server pins at seat time and
unpins at retirement; pinned sessions are skipped by eviction no matter
how cold they look.
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Set

import torch

from repro_torch.core.fed.api.session import FederationSession

_SID_RE = re.compile(r"^[\w.-]+$")


def _check_sid(sid: str) -> str:
    if not _SID_RE.match(sid):
        raise ValueError(f"session id {sid!r} is not filesystem-safe "
                         "(use letters, digits, '_', '-', '.')")
    return sid


class CheckpointStore:
    """LRU session residency: live dict up front, checkpoints behind.

    capacity=None (default) never auto-parks — ``park`` stays explicit;
    with a capacity, adding or reviving past it parks the
    least-recently-used UNPINNED session first.
    """

    def __init__(self, root: str, capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"need capacity >= 1, got {capacity}")
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.capacity = capacity
        self._live: "OrderedDict[str, FederationSession]" = OrderedDict()
        # sid -> (checkpoint path, device the session is revived on)
        self._parked: Dict[str, tuple] = {}
        self._pinned: Set[str] = set()
        self.parks = 0                          # eviction counters
        self.revives = 0

    def path(self, sid: str) -> str:
        return os.path.join(self.root, f"{_check_sid(sid)}.npz")

    # -- membership ------------------------------------------------------
    def __contains__(self, sid: str) -> bool:
        return sid in self._live or sid in self._parked

    def sids(self) -> Iterable[str]:
        return list(self._live) + list(self._parked)

    def is_parked(self, sid: str) -> bool:
        return sid in self._parked

    @property
    def n_live(self) -> int:
        return len(self._live)

    # -- residency -------------------------------------------------------
    def add(self, sid: str, session: FederationSession) -> None:
        if sid in self:
            raise ValueError(f"session {sid!r} already in store")
        _check_sid(sid)
        self._live[sid] = session
        self._live.move_to_end(sid)
        self._evict_over()

    def get(self, sid: str) -> FederationSession:
        """The session, revived from its checkpoint if parked; touches
        LRU recency either way."""
        if sid in self._live:
            self._live.move_to_end(sid)
            return self._live[sid]
        if sid in self._parked:
            path, device = self._parked.pop(sid)
            session = FederationSession.resume(path, device=device)
            self.revives += 1
            self._live[sid] = session
            self._evict_over()
            return session
        raise KeyError(f"unknown session {sid!r}")

    def remove(self, sid: str) -> None:
        self._live.pop(sid, None)
        parked = self._parked.pop(sid, None)
        if parked is not None and os.path.exists(parked[0]):
            os.unlink(parked[0])
        self._pinned.discard(sid)

    # -- pinning (state temporarily lives on the device) -----------------
    def pin(self, sid: str) -> None:
        if sid not in self._live:
            raise KeyError(f"cannot pin non-live session {sid!r}")
        self._pinned.add(sid)

    def unpin(self, sid: str) -> None:
        self._pinned.discard(sid)
        self._evict_over()

    # -- parking ---------------------------------------------------------
    def park(self, sid: str) -> str:
        """Checkpoint a live session to disk and drop the object."""
        if sid in self._pinned:
            raise ValueError(f"session {sid!r} is pinned (its state is "
                             "resident in a serving group)")
        session = self._live.pop(sid, None)
        if session is None:
            if sid in self._parked:
                return self._parked[sid][0]
            raise KeyError(f"unknown session {sid!r}")
        path = self.path(sid)
        session.save(path)
        self._parked[sid] = (path, torch.device(session.substrate.device))
        self.parks += 1
        return path

    def _evict_over(self) -> None:
        if self.capacity is None:
            return
        while len(self._live) > self.capacity:
            victim = next((s for s in self._live if s not in self._pinned),
                          None)
            if victim is None:
                return  # everything resident is pinned; over-capacity OK
            self.park(victim)
