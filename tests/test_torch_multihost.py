"""The trainer across hosts (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``, the gang manifests' contract) on the CPU.

Two "hosts" on this machine, each with 2 local ranks over gloo: host 0
is this process's ``train`` (its second rank forked), host 1 a child
process's; they meet at a TCP store on 127.0.0.1. At dp 2 x tp 2, f32,
2 steps, every step's loss and the step-2 checkpoint (every leaf whole,
gathered to global rank 0) equal the one-host run's of the same layout
bit for bit: the ranks, their devices and their collectives are the
same, only the rendezvous differs. Host 1's ``train`` returns the same
final loss. A malformed environment is refused, naming the variable,
before any rank starts.
"""
import json
import logging
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nos_tpu_torch.cmd import trainer as ttr
from nos_tpu_torch.models import transformer as tt
from nos_tpu_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parent.parent
MODEL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_seq=32)
RUN = dict(MODEL, batch_size=4, seq_len=16, bf16=False, log_every=1,
           steps=2, learning_rate=1e-3, dp=2, tp=2, checkpoint_every=2)
TIMEOUT_S = 120.0
GANG = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")

# host 1: the same trainer in another process, its final loss on stdout
HOST = """
import json, sys
import torch
torch.set_num_threads(1)
from nos_tpu_torch.cmd import trainer as ttr
ttr.RANK_TIMEOUT_S = {timeout}
loss = ttr.train(ttr.TrainerConfig(**json.loads(sys.argv[1])), device="cpu")
print(json.dumps({{"loss": loss}}), flush=True)
"""


@pytest.fixture(autouse=True)
def _one_host_env(monkeypatch):
    monkeypatch.setattr(ttr, "RANK_TIMEOUT_S", TIMEOUT_S)
    for name in GANG:
        monkeypatch.delenv(name, raising=False)


class _Losses(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = []

    def emit(self, record):
        if record.msg.startswith("step %d/%d loss"):
            self.losses.append(record.args[2])


def _train(cfg):
    """(final loss, logged step losses) of ``train(cfg)`` on CPU ranks."""
    log = _Losses()
    tlog = logging.getLogger("nos_tpu_torch.trainer")
    level = tlog.level
    tlog.setLevel(logging.INFO)
    tlog.addHandler(log)
    try:
        return ttr.train(cfg, device="cpu"), log.losses
    finally:
        tlog.removeHandler(log)
        tlog.setLevel(level)


def _leaves(directory):
    mgr = CheckpointManager(directory)
    try:
        params = mgr.restore_params(
            RUN["steps"], device="cpu", params_template=tt.abstract_params(
                tt.TransformerConfig(dtype=torch.float32, **MODEL)))
    finally:
        mgr.close()
    return [t.numpy() for t in tt.param_leaves(params)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_hosts_train_as_one(tmp_path, monkeypatch):
    one_dir, gang_dir = str(tmp_path / "one"), str(tmp_path / "gang")
    want_loss, want = _train(ttr.TrainerConfig(**RUN, checkpoint_dir=one_dir))

    address = f"127.0.0.1:{_free_port()}"
    cfg = dict(RUN, checkpoint_dir=gang_dir)
    env = dict(os.environ, COORDINATOR_ADDRESS=address, NUM_PROCESSES="2",
               PROCESS_ID="1", PYTHONPATH=str(ROOT))
    host1 = subprocess.Popen(
        [sys.executable, "-c", HOST.format(timeout=TIMEOUT_S),
         json.dumps(cfg)], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        monkeypatch.setenv("COORDINATOR_ADDRESS", address)
        monkeypatch.setenv("NUM_PROCESSES", "2")
        monkeypatch.setenv("PROCESS_ID", "0")
        got_loss, got = _train(ttr.TrainerConfig(**cfg))
        out, err = host1.communicate(timeout=TIMEOUT_S)
    finally:
        if host1.poll() is None:
            host1.kill()
            host1.communicate()
    assert host1.returncode == 0, err[-4000:]
    assert len(want) == RUN["steps"] and got == want
    assert got_loss == want_loss
    assert json.loads(out.strip().splitlines()[-1])["loss"] == want_loss
    for a, b in zip(_leaves(gang_dir), _leaves(one_dir)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("env, name", [
    (dict(COORDINATOR_ADDRESS="10.0.0.1"), "COORDINATOR_ADDRESS"),
    (dict(COORDINATOR_ADDRESS="10.0.0.1:1234", NUM_PROCESSES="2",
          PROCESS_ID="-1"), "PROCESS_ID"),
    (dict(COORDINATOR_ADDRESS="10.0.0.1:1234", NUM_PROCESSES="3"),
     "NUM_PROCESSES"),
    (dict(COORDINATOR_ADDRESS="10.0.0.1:1234", NUM_PROCESSES="two"),
     "NUM_PROCESSES"),
], ids=["no_port", "process_id_range", "layout_not_divided", "not_int"])
def test_refused_environment_names_the_variable(env, name, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=f"^{name}"):
        ttr.train(ttr.TrainerConfig(**RUN), device="cpu")
