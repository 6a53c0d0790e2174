"""The ranks of a layout as processes: a host's first rank runs in the
caller's process, its other ranks in processes forked from a fork
server.

The fork server is one process started fresh (not forked from the
caller, whose CUDA state a fork cannot carry) at the first run, with
the caller's ``sys.path``; it imports ``PRELOAD`` once and never
touches a device, and every rank of every later run is a fork of it,
so a rank starts without importing torch again (a ``spawn``ed rank
imports it, and whatever its first step loads lazily, anew). A rank
runs with the caller's environment as it is at the call.

On one host the ranks meet through a file store in a temporary
directory (parallel runs race for no port); several hosts meet at a TCP
store that global rank 0 serves (``cmd/trainer.py``'s
``COORDINATOR_ADDRESS``). Each rank sends back its result, or its
traceback, through a queue. The first rank's stop event, signal
handlers, profiler, metrics and return value stay in the caller's
process.

A run is bounded in time: ``timeout_s`` is the rendezvous's and every
collective's limit (``parallel/mesh.py::init_train_mesh``) and, once the
caller's rank has returned, how long the host's other ranks have to
report. A rank still running then is killed and the run raises, so a
deadlocked collective, or a host that never joins, fails rather than
hangs.
"""
from __future__ import annotations

import atexit
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

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
              args: Sequence, world: int, timeout_s: float,
              ranks: Optional[Sequence[int]] = None,
              store: Optional[str] = None) -> List[Any]:
    """Run this host's ranks: ``rank0(store)`` here and
    ``child(rank, store, *args)`` for the others in forked processes;
    returns their results in rank order. ``ranks`` are this host's
    global ranks, the first the caller's (default: all of ``world``,
    0..world-1, one host); ``store`` the rendezvous every host meets at
    (``tcp://host:port``; default: a file store in a temporary
    directory, which one host only can share). ``child`` and ``args``
    are pickled (a module-level function, picklable values). Raises
    when a rank raises, dies, or has not reported ``timeout_s`` after
    the caller's rank returned; every rank's process has ended on
    return."""
    ranks = list(range(world)) if ranks is None else list(ranks)
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    atexit.unregister(_stop_fork_server)
    atexit.register(_stop_fork_server)
    env = dict(os.environ)
    with tempfile.TemporaryDirectory(prefix="nos-ranks-") as tmp:
        if store is None:
            store = os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = {r: ctx.Process(target=_child, name=f"rank-{r}", daemon=True,
                                args=(child, r, store, args, results, env))
                 for r in ranks[1:]}
        for p in procs.values():
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
        while len(got) < len(procs):
            try:
                rank, ok, value = results.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                break
            got[rank] = (ok, value)
        for p in procs.values():
            p.join(timeout=max(deadline - time.monotonic(), 0.01))
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        errors = [f"rank {r} raised:\n{v}"
                  for r, (ok, v) in sorted(got.items()) if not ok]
        errors += [f"rank {r} ended (exit code {p.exitcode}) without a "
                   f"result within {timeout_s} s"
                   for r, p in procs.items() if r not in got]
        if failure is not None:
            if errors:
                raise RuntimeError("a layout's ranks failed:\n"
                                   + "\n".join(errors)) from failure
            raise failure
        if errors:
            raise RuntimeError("a layout's ranks failed:\n"
                               + "\n".join(errors))
        return [first] + [got[r][1] for r in ranks[1:]]
