"""Step pump: batches queued across calls, joined into one launch.

Port of `gubernator_tpu/core/pump.py`.  The engine submits each batch's
packed rounds (`ops.bucket_kernel.PackedRounds`, general or uniform
format) instead of launching them; the pump launches what is queued
when a caller fetches a result, when MAX_GROUP submissions wait, or
when anything else is about to touch the state.

The reference stacks up to 16 equal-shape round buffers into one
`lax.scan` program, padded to R ∈ {2, 4, 8, 16} with no-op rounds.  K1
and K4 already take ragged rounds of any number and width, so here a
flush joins a run of up to MAX_GROUP queued submissions of one format
into ONE launch: their pins side by side along the lanes (each round
keeps its own header, so batches at different `now` mix freely), their
round and clear offsets shifted into one `round_off` / `clear_off`, and
their clears concatenated.  No shape ladder, no padding rounds.  A
synchronous caller submits one batch and fetches it, so its batch is
one launch; asynchronous batches share launches.

Ordering contract (the reference's): the queue's order is the launch
order, and inside a launch rounds run in order, so per-slot sequential
semantics are those of launching each batch on its own.  Any OTHER
access to the state — the collapsed step, a clear, reading the state,
`close` — calls `flush_locked()` first, under the engine lock.  A fetch
flushes its ticket's group.  `now_ms` rides in each round's header, so
a late launch cannot shift timestamps.

With queueing off (GUBER_PUMP=0, and the CPU's default) `submit`
flushes at once: the same launch path, one launch per batch.  A batch's
buffer goes to the device when its group is flushed: one `non_blocking`
copy from pinned memory, queued on the stream ahead of the launch.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from gubernator_tpu_torch.ops.bucket_kernel import PackedRounds, split_rounds
from gubernator_tpu_torch.utils.metrics import DurationStat

MAX_GROUP = 16


class PumpTicket:
    """One queued submission.  `fetch()` → its host output [rows, L]."""

    __slots__ = ("pump", "packed", "rows", "group", "lo", "hi", "error", "t_submit")

    def __init__(self, pump: "StepPump", packed: PackedRounds) -> None:
        self.pump = pump
        self.t_submit = time.monotonic()
        self.packed: Optional[PackedRounds] = packed  # until launched
        self.rows = packed.pin.shape[0]  # the format: 16 rows general, 2 uniform
        self.group = None  # the launch's readback Ticket, set last
        self.lo = self.hi = 0  # this submission's lanes in the launch's output
        self.error: Optional[BaseException] = None

    def fetch(self) -> np.ndarray:
        if self.group is None and self.error is None:
            self.pump.flush_for(self)
        if self.error is not None:
            raise self.error
        return self.group.fetch()[:, self.lo : self.hi]


class StepPump:
    """Per-engine queue of submissions awaiting a joined launch.  Shared
    state rides the engine's RLock: launch order = queue order."""

    def __init__(self, engine, queueing: bool) -> None:
        self.engine = engine
        # False: every submission is launched as it is submitted.
        self.queueing = queueing
        self._queue: List[PumpTicket] = []
        # Telemetry: submissions, launches, rounds run by those launches.
        self.submitted = 0
        self.flushes = 0
        self.fused_rounds = 0
        # Submit → launch wait of each submission (the service's
        # device.window_wait stage; reference :147).
        self.window_wait = DurationStat()

    # -- engine-lock-held API --------------------------------------------

    def submit(self, packed: PackedRounds) -> PumpTicket:
        """Queue one batch's packed rounds (either format).  Caller holds
        the engine lock."""
        t = PumpTicket(self, packed)
        self._queue.append(t)
        self.submitted += 1
        if not self.queueing or len(self._queue) >= MAX_GROUP:
            self.flush_locked()
        return t

    def flush_locked(self) -> None:
        """Launch everything queued, in order: each maximal run of one
        format, up to MAX_GROUP submissions, is one launch.  Caller
        holds the engine lock."""
        q, self._queue = self._queue, []
        i = 0
        while i < len(q):
            j = i + 1
            while j < len(q) and j - i < MAX_GROUP and q[j].rows == q[i].rows:
                j += 1
            try:
                self._flush_group(q[i:j])
            except BaseException as e:
                # The state may have taken part of the failed launch: this
                # group and every one behind it fails closed.
                for t in q[i:]:
                    if t.group is None and t.error is None:
                        t.error = e
                raise
            i = j

    def _flush_group(self, group: List[PumpTicket]) -> None:
        eng = self.engine
        t0 = time.monotonic()
        for t in group:
            self.window_wait.observe(max(t0 - t.t_submit, 0.0))
        packs = [t.packed for t in group]
        rows = packs[0].pin.shape[0]
        widths = [p.pin.shape[1] for p in packs]
        n_rounds = sum(len(p.round_off) - 1 for p in packs)
        devs = [eng._stage(p.buf) for p in packs]
        if len(group) == 1:
            pin, round_off, clear_off, clear_slots = split_rounds(
                devs[0], widths[0], n_rounds, rows
            )
        else:
            pin = torch.cat(
                [split_rounds(d, w, len(p.round_off) - 1, rows)[0]
                 for d, w, p in zip(devs, widths, packs)],
                dim=1,
            )
            round_off, clear_off, clear_slots = self._join_offsets(packs, widths)
        pout = eng._launch_rounds(pin, round_off, clear_off, clear_slots,
                                  max(p.widest for p in packs))
        eng.round_duration.observe(time.monotonic() - t0)
        ticket = eng.readback.register(pout)
        self.flushes += 1
        self.fused_rounds += n_rounds
        lo = 0
        for t, w in zip(group, widths):
            t.lo, t.hi = lo, lo + w
            t.packed = None
            t.group = ticket  # last: fetch() reads `group` without the lock
            lo += w

    def _join_offsets(self, packs: List[PackedRounds], widths: List[int]):
        """The joined round_off / clear_off / clear_slots of several
        submissions, copied to the device in one buffer."""
        lane_base = np.cumsum([0] + widths)
        n_real = [int(p.clear_off[-1]) for p in packs]
        clear_base = np.cumsum([0] + n_real)
        round_off = np.concatenate(
            [p.round_off[:-1] + b for p, b in zip(packs, lane_base)] + [lane_base[-1:]]
        )
        clear_off = np.concatenate(
            [p.clear_off[:-1] + b for p, b in zip(packs, clear_base)] + [clear_base[-1:]]
        )
        slots = [p.clear_slots[:k] for p, k in zip(packs, n_real)]
        if clear_base[-1] == 0:
            slots = [packs[0].clear_slots[:1]]  # one out-of-range slot: clears nothing
        flat = np.concatenate([round_off, clear_off, *slots]).astype(np.int32)
        dev = self.engine._stage(flat)
        r = len(round_off)
        return dev[:r], dev[r : 2 * r], dev[2 * r :]

    # -- lock-free API -----------------------------------------------------

    def flush_for(self, ticket: PumpTicket) -> None:
        """Called from fetch() without the engine lock."""
        with self.engine._lock:
            if ticket.group is None and ticket.error is None:
                self.flush_locked()
