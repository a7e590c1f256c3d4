"""The port's profiling module against the JAX package's, and the Trainer's
profile window, on the CPU; the process-group join's device default.

`utils/profiling.py::profile_window_from_env` parses NS2VC_PROFILE_AT as
`ns2vc_tpu/utils/profiling.py`'s does (the same value, the same message
for a malformed one); `trace` writes a Chrome trace; a 3-step CPU Trainer
run under NS2VC_PROFILE_AT=1:1 writes one trace into the run dir's
`profile/`, and a window the run ends inside is written at its end. `parallel.mesh.maybe_initialize_distributed` takes the card
unless told otherwise: without one it raises, and "cpu" joins gloo.
"""

import json
import os
import socket

import pytest
import torch
import torch.distributed as dist

from ns2vc_tpu.utils import profiling as jprofiling
from ns2vc_tpu_torch.parallel import mesh
from ns2vc_tpu_torch.train import trainer as ttrainer
from ns2vc_tpu_torch.utils import profiling
from test_torch_train import _trainer_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests: their models are small,
    and the suite's test workers share the host's cores, where several
    OpenMP teams per core stall at their barriers (on an 8-core CPU host,
    alone, 1 thread runs `test_torch_f0.py::test_trainer_serves_a_
    predictor_checkpoint` in 14.7 s against 45.3 with 8)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("spec", [None, "", "100:5", "0:1", "7:0", "-2:3",
                                  " 3 : 4 ", "100", "1:2:3", "a:b", "5:",
                                  ":5", "1.5:2"])
def test_profile_window_parses_as_jax(spec, monkeypatch, capsys):
    if spec is None:
        monkeypatch.delenv("NS2VC_PROFILE_AT", raising=False)
    else:
        monkeypatch.setenv("NS2VC_PROFILE_AT", spec)
    want = jprofiling.profile_window_from_env()
    want_out = capsys.readouterr().out
    got = profiling.profile_window_from_env()
    assert got == want
    assert capsys.readouterr().out == want_out
    assert ("ignoring malformed" in want_out) == (
        spec not in (None, "") and want is None)


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with profiling.annotate("ns2vc_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (name,) = os.listdir(logdir)
    assert name.startswith(f"trace_{os.getpid()}_") and name.endswith(".json")
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "ns2vc_region" in names and any(
        str(n).startswith("aten::") for n in names)


def test_trainer_profile_window_writes_one_trace(tmp_path, monkeypatch):
    """NS2VC_PROFILE_AT=1:1 over 3 steps: the window opens before the
    second step and closes before the third, one trace; then 3:5 over one
    more step: a window the run ends inside is written when the loop
    ends."""
    cfg = _trainer_config(str(tmp_path), save_and_sample_every=10 ** 9)
    monkeypatch.setenv("NS2VC_PROFILE_AT", "1:1")
    logs = str(tmp_path / "run")
    tr = ttrainer.Trainer(cfg, logs_folder=logs, device="cpu")
    opened, stopped = [], []
    start, stop = profiling.Window.start, profiling.Window.stop

    def recorded_start(self):
        opened.append(tr.step)
        return start(self)

    def recorded_stop(self):
        stopped.append(tr.step)
        return stop(self)
    monkeypatch.setattr(profiling.Window, "start", recorded_start)
    monkeypatch.setattr(profiling.Window, "stop", recorded_stop)
    tr.train()
    assert tr.step == 3 and opened == [1] and stopped == [2]
    traces = os.listdir(os.path.join(logs, "profile"))
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(logs, "profile", traces[0])) as f:
        assert json.load(f)["traceEvents"]
    monkeypatch.setenv("NS2VC_PROFILE_AT", "3:5")
    tr.train(num_steps=4)
    tr.close()
    assert tr.step == 4 and opened == [1, 3] and stopped == [2, 4]
    assert len(os.listdir(os.path.join(logs, "profile"))) == 2


def _group_env(monkeypatch):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("NS2VC_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("NS2VC_NUM_PROCESSES", "1")
    monkeypatch.setenv("NS2VC_PROCESS_ID", "0")


def test_initialize_distributed_defaults_to_the_card(monkeypatch):
    """No device given means the card; without one it raises before any
    group is joined, as Svc and the Trainer do."""
    _group_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.maybe_initialize_distributed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.maybe_initialize_distributed("cuda")
    assert not dist.is_initialized()


def test_initialize_distributed_on_the_cpu_joins_gloo(monkeypatch):
    _group_env(monkeypatch)
    assert not dist.is_initialized()
    try:
        assert mesh.maybe_initialize_distributed("cpu")
        assert dist.get_backend() == "gloo" and mesh.world() == (0, 1)
        assert mesh.maybe_initialize_distributed()   # already up
    finally:
        dist.destroy_process_group()
    for name in ("NS2VC_COORDINATOR", "NS2VC_NUM_PROCESSES",
                 "NS2VC_PROCESS_ID"):
        monkeypatch.delenv(name)
    assert not mesh.maybe_initialize_distributed("cpu")
