"""Continuous-batching serving scheduler (the port of
``repro.serving.scheduler``).

Requests queue up over a FIXED grid of slots: an idle slot claims the
next request and teacher-forces its prompt one decode step a token with
only that slot active (prefill-by-decode keeps a single step function),
every slot then decodes in lock-step at its own position, and a finished
sequence (EOS, its budget, or the cache's end) frees its slot in the same
tick for the next queued request.

Per-slot positions: the step hands ``Model.decode_step`` a (B,)
``cur_len`` tensor, so RoPE / M-RoPE, the cache write and the mask are
each slot's own. The port's decode writes its caches in place (k/v at
each slot's index; the recurrent states conv / h and shift_tm / shift_cm
/ wkv whole), so the reference's "compute every slot, keep the old
values where a slot is idle" becomes: before the step, copy what the
step will overwrite in the idle slots (their k/v rows at their own
``cur``, their recurrent rows, any other entry's rows), and put it back
after. Idle slots' entries come out bit for bit as they went in, and the
k/v cache is never copied whole.

One departure from the reference: a slot claimed by a new request has
its recurrent entries zeroed first (the reference only resets its
``cur``, so a reused slot of a recurrent arch would start from the last
request's state). Its k/v need no reset: the mask hides every key at or
past ``cur + 1``. And a slot freed at the cache's end (``cur`` = max_len)
idles at max_len - 1, so that its row's k/v write and its snapshot stay
inside the cache; the reference's idles at max_len, where its scatter
drops the write. Only an MoE arch, whose idle rows compete for expert
capacity, could see the difference.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model

# entries of a slot's recurrent state (the rec and rwkv block kinds)
RECURRENT_KEYS = ("conv", "h", "shift_tm", "shift_cm", "wkv")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32 token ids
    max_new_tokens: int = 16
    eos_id: int = -1              # -1 = never
    # filled by the scheduler
    generated: Optional[List[int]] = None
    done: bool = False


def _slot_major(key: str, t: torch.Tensor) -> torch.Tensor:
    """A cache entry as a view with the slot axis first: "stack/" entries
    are (n_cycles, B, ...), "rem/" entries (B, ...)."""
    return t.movedim(1, 0) if key.startswith("stack/") else t


def _is_kv(key: str) -> bool:
    return key.rsplit("/", 1)[-1] in ("k", "v")


def snapshot_idle(cache: Dict[str, torch.Tensor], idle: torch.Tensor,
                  cur: torch.Tensor):
    """Copies of what a decode step writes in the ``idle`` slots' entries:
    each k/v row at the slot's own ``cur`` (the step's only write to a
    k/v entry), every other entry's rows whole."""
    if idle.numel() == 0:
        return []
    at = cur[idle].long()
    saved = []
    for key, t in cache.items():
        view = _slot_major(key, t)
        if _is_kv(key):
            saved.append((view, (idle, slice(None), at)
                          if key.startswith("stack/") else (idle, at)))
        else:
            saved.append((view, (idle,)))
    return [(view, index, view[index].clone()) for view, index in saved]


def restore_(saved) -> None:
    """Put ``snapshot_idle``'s copies back, in place."""
    for view, index, value in saved:
        view[index] = value


def make_slot_step(model: Model):
    """One lock-step decode over all slots with PER-SLOT positions:
    ``step(params, cache, tokens, cur, active) -> (next_tok, logits, cur,
    cache)`` for tokens (B, 1) int and cur (B,) int on the cache's device
    and ``active`` (B,) bool on the host. Every slot computes; the idle
    slots' cache entries are restored after the step and their ``cur``
    stays, the fixed-shape price of continuous batching. Greedy."""

    @torch.no_grad()
    def step(params, cache, tokens, cur, active):
        active = np.asarray(active, dtype=bool)
        idle = torch.as_tensor(np.flatnonzero(~active), device=cur.device)
        saved = snapshot_idle(cache, idle, cur)
        logits, cache = model.decode_step(params, {"tokens": tokens}, cache,
                                          cur)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        restore_(saved)
        step_on = torch.as_tensor(active, device=cur.device)
        cur = torch.where(step_on, cur + 1, cur)
        return next_tok, logits, cur, cache

    return step


class ContinuousBatcher:
    """Slot-based continuous batching around a Model (token inputs), on
    ``device`` (the card unless the CPU is asked for), where the params
    must already be."""

    def __init__(self, model: Model, params, n_slots: int = 4,
                 max_len: int = 128, device="cuda"):
        if model.cfg.input_kind != "tokens":
            raise ValueError(
                f"{model.cfg.name}: input_kind {model.cfg.input_kind!r}; the "
                "batcher serves token prompts only (as the reference's, "
                "whose token prompts cannot drive an embedding-input arch)")
        self.device = resolve_device(device)
        for path, v in params.items():
            if v.device.type != self.device.type or (
                    self.device.index is not None
                    and v.device.index != self.device.index):
                raise ValueError(f"param {path} is on {v.device}, the "
                                 f"batcher on {self.device}")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.remaining = np.zeros(n_slots, np.int32)
        self.cache = model.init_cache(n_slots, max_len, device=self.device)
        self.cur = torch.zeros((n_slots,), dtype=torch.int32,
                               device=self.device)
        self.tokens = np.zeros((n_slots, 1), np.int32)
        self.step_fn = make_slot_step(model)
        self.completed: Dict[int, Request] = {}
        self.steps_run = 0

    def submit(self, req: Request) -> None:
        n = len(req.prompt)
        if not 0 < n < self.max_len:
            raise ValueError(f"request {req.uid}: a prompt of {n} tokens; "
                             f"needs 1 to {self.max_len - 1} (max_len "
                             f"{self.max_len})")
        req.generated = []
        self.queue.append(req)

    def _reset_slot(self, i: int) -> None:
        """Zero slot i's recurrent entries and its position."""
        for key, t in self.cache.items():
            if key.rsplit("/", 1)[-1] in RECURRENT_KEYS:
                _slot_major(key, t)[i].zero_()
        self.cur[i] = 0

    def _run_step(self, active: np.ndarray) -> np.ndarray:
        tokens = torch.as_tensor(self.tokens, device=self.device)
        nxt, _, self.cur, self.cache = self.step_fn(
            self.params, self.cache, tokens, self.cur, active)
        self.steps_run += 1
        return nxt.cpu().numpy()

    def _admit(self) -> None:
        """Claim idle slots: teacher-force the prompt token by token
        (prefill-by-decode keeps a single step function)."""
        for i in range(self.n_slots):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            self.slots[i] = req
            self.remaining[i] = req.max_new_tokens
            self._reset_slot(i)
            # feed prompt tokens through the shared step with only this
            # slot active
            active = np.zeros(self.n_slots, bool)
            active[i] = True
            for tok in req.prompt:
                self.tokens[i, 0] = int(tok)
                nxt = self._run_step(active)
            first = int(nxt[i])
            req.generated.append(first)
            self.remaining[i] -= 1           # the prefill's token counts
            if (req.eos_id >= 0 and first == req.eos_id) \
                    or self.remaining[i] <= 0:
                req.done = True
                self.completed[req.uid] = req
                self.slots[i] = None
                continue
            self.tokens[i, 0] = first

    def step(self) -> int:
        """One scheduler tick: admit, decode one token on active slots,
        retire finished requests. Returns number of active slots."""
        self._admit()
        active = np.array([s is not None for s in self.slots])
        if not active.any():
            return 0
        nxt = self._run_step(active)
        cur = self.cur.cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.generated.append(tok)
            self.remaining[i] -= 1
            hit_eos = (req.eos_id >= 0 and tok == req.eos_id)
            out_of_budget = (self.remaining[i] <= 0
                             or cur[i] >= self.max_len - 1)
            if hit_eos or out_of_budget:
                req.done = True
                self.completed[req.uid] = req
                self.slots[i] = None           # slot freed THIS step
            else:
                self.tokens[i, 0] = tok
        if cur.max() >= self.max_len:
            # a slot freed at the cache's end idles at its last index, so
            # that the next steps' writes and snapshots stay in the cache
            self.cur.clamp_(max=self.max_len - 1)
        return int(active.sum())

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and all(s is None for s in self.slots):
                return
            self.step()
        raise RuntimeError("scheduler did not drain")
