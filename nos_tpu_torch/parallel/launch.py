"""The ranks of a layout as processes: rank 0 runs in the caller's
process, ranks 1..N-1 in processes forked from a fork server.

The fork server is one process started fresh (not forked from the
caller, whose CUDA state a fork cannot carry) at the first run, with
the caller's ``sys.path``; it imports ``PRELOAD`` once and never
touches a device, and every rank of every later run is a fork of it,
so a rank starts without importing torch again (a ``spawn``ed rank
imports it, and whatever its first step loads lazily, anew). A rank
runs with the caller's environment as it is at the call.

The ranks meet through a file store in a temporary directory (parallel
runs race for no port). Each rank sends back its result, or its
traceback, through a queue. Rank 0's stop event, signal handlers,
profiler, metrics and return value stay in the caller's process.

A run is bounded in time: ``timeout_s`` is every collective's limit
(``parallel/mesh.py::init_train_mesh``) and, once rank 0 has returned,
how long the other ranks have to report. A rank still running then is
killed and the run raises, so a deadlocked collective fails rather than
hangs.
"""
from __future__ import annotations

import atexit
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch.multiprocessing as mp

__all__ = ["run_ranks"]

# how long the other ranks have to end once rank 0 has raised
FAILED_GRACE_S = 30.0
# what the fork server imports: a trainer rank's modules, and
# torch._dynamo, which a rank's first checkpointed layer would import
PRELOAD = ("torch._dynamo", "torch.distributed", "nos_tpu_torch.cmd.trainer",
           "nos_tpu_torch.parallel.launch", "nos_tpu_torch.parallel.mesh",
           "nos_tpu_torch.models.transformer", "nos_tpu_torch.train.optim",
           "nos_tpu_torch.train.checkpoint", "nos_tpu_torch.train.data",
           "nos_tpu_torch.ops.attention", "nos_tpu_torch.ops._kernels")


def _stop_fork_server() -> None:
    """Close the fork server and wait for it to end (at exit: a caller
    leaves no process behind it)."""
    from multiprocessing import forkserver

    stop = getattr(forkserver._forkserver, "_stop", None)
    if stop is not None:
        stop()


def _child(child: Callable, rank: int, store: str, args: Sequence,
           results, env: dict) -> None:
    os.environ.clear()
    os.environ.update(env)
    try:
        out = child(rank, store, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def run_ranks(rank0: Callable[[str], Any], child: Callable[..., Any],
              args: Sequence, world: int, timeout_s: float) -> List[Any]:
    """Run ``child(rank, store, *args)`` for ranks 1..world-1 in forked
    processes and ``rank0(store)`` here (``store``: the file store's
    path); returns every rank's result in rank order. ``child`` and
    ``args`` are pickled (a module-level function, picklable values).
    Raises when a rank raises, dies, or has not reported ``timeout_s``
    after rank 0 returned; every rank's process has ended on return."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    atexit.unregister(_stop_fork_server)
    atexit.register(_stop_fork_server)
    env = dict(os.environ)
    with tempfile.TemporaryDirectory(prefix="nos-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_child, name=f"rank-{r}", daemon=True,
                             args=(child, r, store, args, results, env))
                 for r in range(1, world)]
        for p in procs:
            p.start()
        failure = None
        first = None
        try:
            first = rank0(store)
        except BaseException as e:          # re-raised below
            failure = e
        deadline = time.monotonic() + (min(FAILED_GRACE_S, timeout_s)
                                       if failure is not None else timeout_s)
        got = {}
        # drain the queue before joining: a writer blocks until read
        while len(got) < world - 1:
            try:
                rank, ok, value = results.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                break
            got[rank] = (ok, value)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.01))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        errors = [f"rank {r} raised:\n{v}"
                  for r, (ok, v) in sorted(got.items()) if not ok]
        errors += [f"rank {r} ended (exit code {p.exitcode}) without a "
                   f"result within {timeout_s} s"
                   for r, p in enumerate(procs, 1) if r not in got]
        if failure is not None:
            if errors:
                raise RuntimeError("a layout's ranks failed:\n"
                                   + "\n".join(errors)) from failure
            raise failure
        if errors:
            raise RuntimeError("a layout's ranks failed:\n"
                               + "\n".join(errors))
        return [first] + [got[r][1] for r in range(1, world)]
