"""Self-healing serving: engine supervision and the serving-chaos
seams (a copy of ``nos_tpu/models/supervision.py`` for the port;
torch-free as well).

``EngineSupervisor`` is the restart brain behind ``ServingLoop``'s
recovery path. On engine failure the loop — instead of dying terminally
— asks the supervisor whether a restart is still inside the budget,
captures every live request's resumable state from the dead engine
(``engine.capture_resumable()``: committed tokens, sampling params and,
under ``kv_swap``, a best-effort swap-to-host KV snapshot), rebuilds the
engine through the factory after an exponential-backoff-with-jitter
delay, and restores the captured requests at the front of the fresh
engine's queue (``engine.restore``): byte-exact swap restore, or
recompute re-prefill of ``prompt + out[:-1]``. Jitter is drawn from a
seeded ``random.Random`` so a restart timeline is reproducible.

``FaultInjector`` / ``ChaosEngine`` are a deterministic, seeded fault
schedule hooked into the engine's step seams by a transparent proxy
(``injector.wrap(engine)``), firing at loop-tick boundaries (one tick =
one ``step``/``step_begin`` call): ``error`` raises from the dispatch
phase (the device-fault stand-in), ``nofreeblocks`` raises
``kvblocks.NoFreeBlocks`` from it, ``hang`` and ``slow`` sleep inside
the blocking wait, ``hbm_spike`` pins the engine's admission-time memory
snapshot near full. The faults are raised in Python: a real sticky CUDA
error poisons the process's CUDA context, which no in-process rebuild
can reach. The schedule is explicit ``{tick_index: kind}`` or drawn per
tick from a seeded RNG; every injection is recorded in ``injected``.
"""
from __future__ import annotations

import inspect
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from nos_tpu_torch.models.kvblocks import NoFreeBlocks

__all__ = ["EngineSupervisor", "FaultInjector", "ChaosEngine"]


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


class FaultInjector:
    """Deterministic seeded fault schedule for the serving-chaos
    harness. One tick = one serving-loop quantum (a ``step`` or
    ``step_begin`` call on the wrapped engine)."""

    KINDS = ("error", "nofreeblocks", "hang", "slow", "hbm_spike")

    def __init__(self, schedule: Optional[Dict[int, str]] = None, *,
                 seed: int = 0, p_error: float = 0.0,
                 p_hang: float = 0.0, p_slow: float = 0.0,
                 hang_s: float = 1.0, slow_s: float = 0.05,
                 spike_s: float = 0.5):
        if schedule:
            bad = {k for k in schedule.values() if k not in self.KINDS}
            if bad:
                raise ValueError(f"unknown fault kinds {sorted(bad)}; "
                                 f"choose from {self.KINDS}")
        self.schedule = dict(schedule or {})
        self._rng = random.Random(seed)
        self.p_error = p_error
        self.p_hang = p_hang
        self.p_slow = p_slow
        self.hang_s = hang_s
        self.slow_s = slow_s
        self.spike_s = spike_s
        self.tick = 0
        self.injected: List[dict] = []      # {"tick", "kind", "t"}
        self._pending_wait: Optional[str] = None
        self._lock = threading.Lock()

    def wrap(self, engine) -> "ChaosEngine":
        return ChaosEngine(engine, self)

    # -- seams (called by ChaosEngine) ---------------------------------
    def _decide(self) -> Optional[str]:
        kind = self.schedule.get(self.tick)
        if kind is None and (self.p_error or self.p_hang or self.p_slow):
            # one draw sequence per tick, independent of which faults
            # fire: keeps a seed's schedule stable across kinds
            r = self._rng.random()
            if r < self.p_error:
                kind = "error"
            elif r < self.p_error + self.p_hang:
                kind = "hang"
            elif r < self.p_error + self.p_hang + self.p_slow:
                kind = "slow"
        return kind

    def before_dispatch(self, inner) -> None:
        with self._lock:
            kind = self._decide()
            tick = self.tick
            self.tick += 1
            if kind is None:
                return
            self.injected.append({"tick": tick, "kind": kind,
                                  "t": time.monotonic()})
            if kind in ("hang", "slow"):
                self._pending_wait = kind
                return
        if kind == "error":
            raise RuntimeError(
                f"injected engine fault (chaos tick {tick})")
        if kind == "nofreeblocks":
            raise NoFreeBlocks(
                f"injected block-pool squeeze (chaos tick {tick})")
        if kind == "hbm_spike":
            # pin the paged engine's admission-time HBM snapshot near
            # the limit so memory-aware admission defers (guarded: a
            # slot-static engine has no such seam and just ignores it)
            if hasattr(inner, "hbm") and hasattr(inner, "_hbm_next"):
                inner.hbm = {"device": "chaos:0",
                             "in_use": 999, "limit": 1000}
                inner._hbm_next = time.perf_counter() + self.spike_s
                inner._hbm_dead = False

    def before_wait(self) -> None:
        with self._lock:
            kind, self._pending_wait = self._pending_wait, None
        if kind == "hang":
            time.sleep(self.hang_s)
        elif kind == "slow":
            time.sleep(self.slow_s)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.injected:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out


class ChaosEngine:
    """Transparent engine proxy: every attribute delegates to the
    wrapped engine (so the serving loop's protocol sniffing — split
    step, cancel, ledger, paged — sees exactly the inner engine's
    surface), with the injector spliced into the tick seams."""

    def __init__(self, inner, injector: FaultInjector):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_injector", injector)

    def __setattr__(self, name, value):
        # writes delegate too: the serving loop ASSIGNS engine
        # attributes (e.g. ``engine.compile_events = []`` to drain the
        # compile ledger) — shadowing them on the proxy would silently
        # fork state from the wrapped engine
        setattr(self.__dict__["_inner"], name, value)

    def __getattr__(self, name):
        inner = self.__dict__["_inner"]
        inj = self.__dict__["_injector"]
        attr = getattr(inner, name)         # AttributeError propagates:
        if name == "step_begin":            # hasattr mirrors the inner
            def step_begin(*a, **kw):
                inj.before_dispatch(inner)
                return attr(*a, **kw)
            return step_begin
        if name == "step_wait":
            def step_wait(*a, **kw):
                inj.before_wait()
                return attr(*a, **kw)
            return step_wait
        if name == "step":
            def step(*a, **kw):
                # step-only engines: dispatch + wait seams collapse
                # into the one call (a hang here is unrecoverable by
                # design — the loop holds its lock through step())
                inj.before_dispatch(inner)
                inj.before_wait()
                return attr(*a, **kw)
            return step
        return attr
