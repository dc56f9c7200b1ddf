# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's multi-process path: a real two-process gloo group on the CPU,
mirroring tests/test_distributed.py.

* Two workers (tests/torch_distributed_worker.py) join a group through
  ``initialize_distributed``, shard one state over a ``(2, 2)`` mesh, and
  each checks its local shards of the sharded forward step against the
  single-process step, bitwise.
* The NL driver's ``--distributed`` in two processes: each validates its
  own column block against the goldens (HOORAY from both).
* ``initialize_distributed`` refuses half its arguments and a process id
  out of range, and without them outside a launcher forms no group.

Every subprocess has a 180 s limit and its own free port.
"""
import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from cloudsc2_tpu_torch.parallel.mesh import initialize_distributed, process_count_and_index

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(argv_of):
    """Run two processes (``argv_of(process_id)``), each within TIMEOUT;
    returns their ``(returncode, output)``."""
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(argv_of(pid), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def test_two_process_group_forward_step():
    port = _free_port()
    results = _run_pair(lambda pid: [sys.executable, os.path.join(HERE, "torch_distributed_worker.py"),
                                     str(port), str(pid), "2"])
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"worker {pid} failed:\n{out}"
        assert f"DISTRIBUTED-OK pid={pid} shards=4 checked=22 verdicts=[22, 22]" in out, out


def test_run_nonlinear_driver_distributed():
    port = _free_port()
    results = _run_pair(lambda pid: [
        sys.executable, os.path.join(REPO, "drivers", "run_nonlinear_torch.py"), "--device", "cpu",
        "--num-cols", "256", "--precision", "double", "--distributed", "--coordinator", f"127.0.0.1:{port}",
        "--process-id", str(pid), "--num-processes", "2"])
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"driver process {pid} failed:\n{out}"
        assert "HOORAY" in out, out
        assert f"holds columns [{128 * pid}, {128 * (pid + 1)}) of 256" in out, out
    assert "Exit codes of the 2 processes: [0, 0]" in results[0][1]


def test_initialize_distributed_refuses_and_defaults(monkeypatch):
    with pytest.raises(ValueError, match="go together"):
        initialize_distributed(coordinator_address="127.0.0.1:1", num_processes=2)
    with pytest.raises(ValueError, match="not in"):
        initialize_distributed(coordinator_address="127.0.0.1:1", num_processes=2, process_id=2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_distributed()
    assert not dist.is_initialized() and process_count_and_index() == (1, 0)
