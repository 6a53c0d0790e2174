"""Self-healing serving: engine supervision (a copy of
``EngineSupervisor`` from ``nos_tpu/models/supervision.py`` for the
port; the reference's chaos seams, ``FaultInjector`` and
``ChaosEngine``, are its benches' and stay there).

``EngineSupervisor`` is the restart brain behind ``ServingLoop``'s
recovery path. On engine failure the loop — instead of dying terminally
— asks the supervisor whether a restart is still inside the budget,
captures every live request's resumable state from the dead engine
(``engine.capture_resumable()``, when the engine has it), rebuilds the
engine through the factory after an exponential-backoff-with-jitter
delay, and restores the captured requests at the front of the fresh
engine's queue (``engine.restore``). Jitter is drawn from a seeded
``random.Random`` so a restart timeline is reproducible.
"""
from __future__ import annotations

import inspect
import random
import time
from typing import Callable, Dict, List, Tuple

__all__ = ["EngineSupervisor"]


class EngineSupervisor:
    """Restart policy + capture/restore orchestration for one serving
    loop. Thread-compatibility contract: the owning loop serializes
    every call (its condition lock choreographs capture/restore; the
    backoff/build phase runs on exactly one recovery thread at a time),
    so the supervisor itself keeps no lock."""

    def __init__(self, factory: Callable[[], object], *,
                 restart_budget: int = 2, backoff_s: float = 0.5,
                 backoff_max_s: float = 10.0, jitter_frac: float = 0.25,
                 seed: int = 0):
        if restart_budget < 0:
            raise ValueError(
                f"restart_budget must be >= 0, got {restart_budget}")
        if backoff_s < 0 or backoff_max_s < 0:
            raise ValueError("backoff delays must be >= 0")
        self.factory = factory
        self.restart_budget = restart_budget
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.jitter_frac = jitter_frac
        self._rng = random.Random(seed)
        # counters the loop mirrors into metrics/stats
        self.attempts = 0           # build attempts consumed (<= budget)
        self.restarts = 0           # successful engine rebuilds
        self.resumed = {"swap": 0, "recompute": 0}
        self.lost = 0
        self.episodes: List[dict] = []

    # -- policy ---------------------------------------------------------
    def can_restart(self) -> bool:
        return self.attempts < self.restart_budget

    def note_attempt(self) -> int:
        """Consume one unit of restart budget; returns the attempt
        index (0-based) the backoff schedule keys on."""
        i = self.attempts
        self.attempts += 1
        return i

    def backoff_delay(self, attempt: int) -> float:
        """Exponential backoff with seeded jitter: base * 2^attempt,
        capped, +/- jitter_frac drawn from the supervisor's own RNG —
        deterministic for a given seed and attempt sequence."""
        base = min(self.backoff_s * (2 ** attempt), self.backoff_max_s)
        if base <= 0:
            return 0.0
        jitter = 1.0 + self.jitter_frac * (2.0 * self._rng.random() - 1.0)
        return base * jitter

    def build(self):
        """One factory call — a fresh engine (fresh compile). Raises
        whatever the factory raises; the caller decides whether budget
        remains for another try."""
        return self.factory()

    # -- capture / restore ---------------------------------------------
    def capture(self, engine, device_ok: bool = True) -> List[dict]:
        """Every live request's resumable state from a (likely dead)
        engine, in original arrival order. Guarded: an engine without
        ``capture_resumable`` (bare stubs) or one whose capture raises
        (host bookkeeping corrupted by the fault) yields [] — those
        requests are drained as ``failed``, never left dangling.
        ``device_ok=False`` (watchdog trips: the device is declared
        wedged, a blocking copy could hang) asks the engine to skip
        device reads — swap snapshots — and capture host state only;
        engines without the parameter (stubs) are called bare."""
        cap = getattr(engine, "capture_resumable", None)
        if cap is None:
            return []
        # signature inspection, NOT a TypeError retry: an internal
        # TypeError from a device_ok-aware capture must not be
        # mistaken for "unsupported kwarg" and retried with device
        # reads re-enabled — that would defeat the wedged-device
        # protection the flag exists for
        try:
            supports = "device_ok" in inspect.signature(cap).parameters
        except (TypeError, ValueError):
            supports = False
        try:
            return list(cap(device_ok=device_ok) if supports else cap())
        except Exception:
            return []

    def restore(self, engine, state: dict) -> Tuple[int, str]:
        """Re-admit one captured request into a fresh engine. Returns
        (new rid, mode) where mode is ``swap`` (byte-exact KV restore)
        or ``recompute`` (re-prefill from the tokens). Raises when the
        engine cannot take it (the loop accounts that request lost)."""
        rid = engine.restore(state)
        mode = "swap" if (state.get("swap") is not None
                          and getattr(engine, "paged", False)) \
            else "recompute"
        return rid, mode

    def note_recovered(self, cause: str, t_fail: float,
                       resumed: Dict[str, int], lost: int) -> None:
        """Record one completed restart episode (the chaos bench's MTTR
        source). ``t_fail`` is the monotonic instant the failure was
        detected; recovery ends now."""
        self.restarts += 1
        for mode, n in resumed.items():
            self.resumed[mode] += n
        self.lost += lost
        self.episodes.append({
            "cause": cause,
            "t_fail": t_fail,       # monotonic failure-detection stamp:
            #                         bench_chaos_serve correlates it
            #                         with the injector's event log to
            #                         split detection from recovery
            "mttr_s": max(0.0, time.monotonic() - t_fail),
            "resumed": dict(resumed),
            "lost": lost,
        })

    def stats(self) -> dict:
        return {
            "restart_budget": self.restart_budget,
            "attempts": self.attempts,
            "restarts": self.restarts,
            "resumed": dict(self.resumed),
            "lost": self.lost,
            "episodes": [dict(e) for e in self.episodes],
        }
