"""Port parity: the trainer's lifecycle notice watcher
(``nos_tpu_torch/lifecycle/events.py``, ``nos_tpu_torch/kube/``, and
``cmd/trainer.py::main`` with ``node_name``/``lifecycle_api``) against
the reference's (``nos_tpu/lifecycle/events.py``, ``nos_tpu/kube/``).

The reference's two watcher tests run on the port's copies; the port's
HTTP client reads the reference's ``ApiHttpServer`` and the reference's
client the port's, so a notice stamped through either wire stops the
other side's watcher; and ``main()`` trains on the CPU with the watcher
on, stops after the step in flight when a notice lands on its node,
banks that step, exits cleanly, and a resumed run ends with every
checkpointed leaf bit-equal to an uninterrupted run's.
"""
import json
import logging
import os
import threading

import pytest

from nos_tpu_torch.cmd import trainer as ttr
from nos_tpu_torch.kube import serial
from nos_tpu_torch.kube.apiserver import ApiServer
from nos_tpu_torch.kube.client import Client
from nos_tpu_torch.kube.controller import Manager
from nos_tpu_torch.kube.httpapi import ApiHttpServer, RemoteApiServer
from nos_tpu_torch.kube.objects import Node, NodeStatus, ObjectMeta, Taint
from nos_tpu_torch.lifecycle.events import (
    deliver_maintenance_notice, deliver_preemption_notice,
    preemption_deadline, preemption_signal_controller,
)

TINY = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=32, steps=6, batch_size=2, seq_len=16,
            log_every=1, bf16=False)


class Clock:
    """A clock of the test's own: wall-clock seconds the test advances."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _node(name="w0"):
    return Node(metadata=ObjectMeta(name=name),
                status=NodeStatus(allocatable={"cpu": 1}))


# ---------------------------------------------------------------------------
# tests/test_lifecycle_controller.py's watcher cases, on the port's copies
# ---------------------------------------------------------------------------

def test_preemption_signal_sets_trainer_stop_event():
    """A notice on the worker's node sets the very stop event train()
    consumes for checkpoint banking."""
    server = ApiServer()
    client = Client(server)
    server.create(_node())
    stop = threading.Event()
    seen = []
    mgr = Manager(server)
    mgr.add_controller(preemption_signal_controller(
        "w0", stop, on_notice=lambda kind, dl: seen.append((kind, dl))))
    mgr.run_until_idle()
    assert not stop.is_set()
    deliver_preemption_notice(client, "w0", 1234.5)
    mgr.run_until_idle()
    assert stop.is_set()
    assert seen == [("preemption", 1234.5)]


def test_preemption_signal_respects_maintenance_lead():
    """A maintenance notice an hour out does NOT stop the trainer; one
    inside the lead window does."""
    clock = Clock()
    server = ApiServer(clock=clock)
    client = Client(server)
    server.create(_node())
    stop = threading.Event()
    mgr = Manager(server, clock=clock)
    mgr.add_controller(preemption_signal_controller(
        "w0", stop, maintenance_lead_s=60.0, clock=clock))
    mgr.run_until_idle()

    deliver_maintenance_notice(client, "w0", clock() + 3600.0)
    mgr.run_until_idle()
    assert not stop.is_set(), "fired an hour before the window"
    # time passes until the window is inside the lead; the controller's
    # delayed requeue re-checks
    for _ in range(80):
        clock.advance(60.0)
        mgr.run_until_idle()
        if stop.is_set():
            break
    assert stop.is_set(), "never fired as the window approached"


def test_deleted_node_stops_the_trainer():
    """The node object gone (the host torn down) is as urgent as a
    preemption."""
    server = ApiServer()
    server.create(_node())
    stop = threading.Event()
    seen = []
    mgr = Manager(server)
    mgr.add_controller(preemption_signal_controller(
        "w0", stop, on_notice=lambda kind, dl: seen.append(kind)))
    mgr.run_until_idle()
    server.delete("Node", "w0")
    mgr.run_until_idle()
    assert stop.is_set() and seen == ["node-deleted"]


def test_another_nodes_notice_is_ignored():
    server = ApiServer()
    client = Client(server)
    server.create(_node("w0"))
    server.create(_node("w1"))
    stop = threading.Event()
    mgr = Manager(server)
    mgr.add_controller(preemption_signal_controller("w0", stop))
    deliver_preemption_notice(client, "w1", 99.0)
    mgr.run_until_idle()
    assert not stop.is_set()


# ---------------------------------------------------------------------------
# the wire: the reference's server and client against the port's
# ---------------------------------------------------------------------------

def _wait(event: threading.Event, mgr, timeout=10.0) -> bool:
    t = threading.Thread(target=mgr.run, kwargs={"poll_interval_s": 0.01},
                         daemon=True)
    t.start()
    try:
        return event.wait(timeout)
    finally:
        # the loop ends before its stream is closed
        mgr._stop.set()
        t.join(timeout=5)
        mgr.stop()


def test_port_client_reads_the_reference_server():
    """The port's watcher over ``RemoteApiServer`` against the
    reference's ``ApiHttpServer``, beside the reference's other kinds
    (a Pod, a ConfigMap, which the port's stream skips): the node reads
    back field for field, and a notice the reference's client stamps
    there sets the port's stop event."""
    pytest.importorskip("jax")
    from nos_tpu.kube import objects as jobj
    from nos_tpu.kube.apiserver import ApiServer as JApiServer
    from nos_tpu.kube.client import Client as JClient
    from nos_tpu.kube.httpapi import ApiHttpServer as JApiHttpServer
    from nos_tpu.lifecycle import events as jevents

    jserver = JApiServer()
    jserver.create(jobj.Node(
        metadata=jobj.ObjectMeta(name="w0", labels={"pool": "a"}),
        spec=jobj.NodeSpec(taints=[jobj.Taint(key="google.com/tpu",
                                              value="present")]),
        status=jobj.NodeStatus(allocatable={"cpu": 4.0})))
    jserver.create(jobj.ConfigMap(metadata=jobj.ObjectMeta(
        name="cm", namespace="x"), data={"a": "b"}))
    httpd = JApiHttpServer(jserver).start()
    try:
        remote = RemoteApiServer(httpd.address)
        node = remote.get("Node", "w0")
        assert serial.to_wire(node) == \
            __import__("nos_tpu.kube.serial", fromlist=["x"]).to_wire(
                jserver.get("Node", "w0"))
        assert node.spec.taints == [Taint(key="google.com/tpu",
                                          value="present")]
        stop = threading.Event()
        mgr = Manager(remote)
        mgr.add_controller(preemption_signal_controller("w0", stop))
        jserver.create(jobj.Pod(metadata=jobj.ObjectMeta(
            name="p", namespace="x")))
        jevents.deliver_preemption_notice(JClient(jserver), "w0", 42.0)
        assert _wait(stop, mgr)
        assert preemption_deadline(remote.get("Node", "w0")) == 42.0
    finally:
        httpd.stop()


def test_reference_client_reads_the_port_server():
    """The other way round: the reference's watcher over its
    ``RemoteApiServer`` against the port's ``ApiHttpServer``, and a
    notice stamped through the port's client."""
    pytest.importorskip("jax")
    from nos_tpu.kube.controller import Manager as JManager
    from nos_tpu.kube.httpapi import RemoteApiServer as JRemote
    from nos_tpu.lifecycle import events as jevents

    server = ApiServer()
    server.create(_node())
    httpd = ApiHttpServer(server).start()
    try:
        stop = threading.Event()
        mgr = JManager(JRemote(httpd.address))
        mgr.add_controller(jevents.preemption_signal_controller("w0", stop))
        deliver_preemption_notice(RemoteApiServer(httpd.address), "w0", 7.0)
        assert _wait(stop, mgr)
        assert jevents.preemption_deadline(
            JRemote(httpd.address).get("Node", "w0")) == 7.0
    finally:
        httpd.stop()


# ---------------------------------------------------------------------------
# main(): the watcher, the stop, the save, the resume
# ---------------------------------------------------------------------------

def _config(tmp_path, name, **kw):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(dict(TINY, **kw)))
    return str(path)


def _step_files(d, step):
    root = os.path.join(d, str(step))
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))}


class _OnStep(logging.Handler):
    """Calls ``fn`` on the training thread when ``step k/n`` is logged."""

    def __init__(self, k, fn):
        super().__init__()
        self.tag, self.fn, self.losses = f"step {k}/", fn, []
        self.final = None

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("step ") and " loss " in msg:
            self.losses.append(msg.split(" loss ")[1].split()[0])
        if msg.startswith("training done, final loss "):
            self.final = msg.rsplit(" ", 1)[1]
        if msg.startswith(self.tag):
            self.fn()


@pytest.mark.parametrize("k", [2, 4])
def test_main_stops_on_a_notice_and_resumes_bit_equal(tmp_path, monkeypatch,
                                                      k):
    """``main()`` with the watcher on a CPU run: a preemption notice
    stamped on its node after step k's loss is logged stops the run
    after the step in flight (k + 1), which it banks; ``main`` returns
    (exit code 0), the watcher is stopped, and a resumed run's last
    checkpoint equals an uninterrupted run's leaf for leaf, bit for
    bit, with the same losses."""
    server = ApiServer()
    server.create(_node("w0"))
    httpd = ApiHttpServer(server).start()
    logger = logging.getLogger("nos_tpu_torch.trainer")
    events, managers = [], []
    real_train, real_stop = ttr.train, Manager.stop

    def spy_train(cfg, stop_event=None, device=None):
        events.append(stop_event)
        return real_train(cfg, stop_event=stop_event, device=device)

    def spy_stop(mgr):
        managers.append(mgr)
        real_stop(mgr)

    def notice():
        deliver_preemption_notice(Client(server), "w0", 1e12)
        # the watcher sets the event while this step's successor runs
        assert events[-1].wait(10.0)

    monkeypatch.setattr(ttr, "train", spy_train)
    monkeypatch.setattr(Manager, "stop", spy_stop)
    stopped = _OnStep(k, notice)
    logger.addHandler(stopped)
    try:
        ckpt = str(tmp_path / "ckpt")
        ttr.main(["--config", _config(
            tmp_path, "watched", checkpoint_dir=ckpt, checkpoint_every=100,
            node_name="w0", lifecycle_api=httpd.address)], device="cpu")
    finally:
        logger.removeHandler(stopped)
        httpd.stop()
    assert events[0] is not None and events[0].is_set()
    assert managers and managers[0]._stop.is_set()
    from nos_tpu_torch.train.checkpoint import CheckpointManager

    assert CheckpointManager(ckpt).all_steps() == [k + 1]

    resumed = _OnStep(0, lambda: None)
    logger.addHandler(resumed)
    try:
        ttr.main(["--config", _config(tmp_path, "resume",
                                      checkpoint_dir=ckpt)], device="cpu")
        straight_dir = str(tmp_path / "straight")
        straight = _OnStep(0, lambda: None)
        logger.removeHandler(resumed)
        logger.addHandler(straight)
        ttr.main(["--config", _config(tmp_path, "straight",
                                      checkpoint_dir=straight_dir)],
                 device="cpu")
    finally:
        logger.removeHandler(resumed)
        logger.removeHandler(straight)
    steps = TINY["steps"]
    # the banked step's loss is the interrupted run's last
    assert stopped.losses + [stopped.final] + resumed.losses \
        == straight.losses
    assert len(straight.losses) == steps
    assert _step_files(ckpt, steps) == _step_files(straight_dir, steps)


def test_main_without_a_notice_trains_to_the_end(tmp_path):
    """The watcher on and no notice: the run is the plain one."""
    server = ApiServer()
    server.create(_node("w0"))
    httpd = ApiHttpServer(server).start()
    try:
        ckpt = str(tmp_path / "ckpt")
        ttr.main(["--config", _config(
            tmp_path, "watched", steps=3, checkpoint_dir=ckpt,
            node_name="w0", lifecycle_api=httpd.address)], device="cpu")
    finally:
        httpd.stop()
    from nos_tpu_torch.train.checkpoint import CheckpointManager

    assert CheckpointManager(ckpt).latest() == 3


def test_multi_host_still_refused_with_the_watcher_set(monkeypatch):
    """With the watcher's knobs set, a malformed multi-host environment
    (an address without a port) is still refused by name."""
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1")
    cfg = ttr.TrainerConfig(**TINY, node_name="n0",
                            lifecycle_api="http://127.0.0.1:9")
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        ttr.train(cfg, device="cpu")
