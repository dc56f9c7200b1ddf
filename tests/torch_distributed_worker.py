# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Worker process of the port's two-process test (tests/test_torch_distributed.py).

Each worker is one node of a two-process gloo group on the CPU: it joins
the group through :func:`cloudsc2_tpu_torch.parallel.mesh.initialize_distributed`,
builds the ``('node', 'device')`` mesh of 2 shards a process, places its
columns of the same full state, runs the sharded forward step, and checks
each of its local shards against the port's single-process step on the
whole state, bitwise (the columns are independent, and every shard runs
the same plain code).  The verdicts of both go through the group.  Imports
the port only.

Invoked as:  python tests/torch_distributed_worker.py <port> <process_id> <num_processes>
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

SHARDS_PER_PROCESS = 2
NLEV, COLS_PER_SHARD = 20, 4


def main() -> int:
    import torch
    import torch.distributed as dist

    from cloudsc2_tpu_torch import iox
    from cloudsc2_tpu_torch.params import make_constants
    from cloudsc2_tpu_torch.parallel.mesh import column_mesh, initialize_distributed, shard_state
    from cloudsc2_tpu_torch.parallel.step import forward_step, make_sharded_forward_step
    from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
    from cloudsc2_tpu_torch.state import state_from_numpy

    torch.set_num_threads(1)
    port, pid, nproc = (int(a) for a in sys.argv[1:4])
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    assert (dist.get_world_size(), dist.get_rank()) == (nproc, pid)
    mesh = column_mesh(SHARDS_PER_PROCESS * nproc, device="cpu")
    if mesh.shape != (nproc, SHARDS_PER_PROCESS) or mesh.first_shard != pid * SHARDS_PER_PROCESS:
        raise AssertionError(f"mesh {mesh}")

    ncols = COLS_PER_SHARD * mesh.size
    _, state_np, dt = iox.synthesize_input(ncols=ncols, nlev=NLEV, seed=0)
    c = make_constants(lphylin=True, ldrain1d=False)
    state = state_from_numpy(state_np, torch.device("cpu"), torch.float64)
    state["eta"] = eta_levels(state["ap"], state["aph"])
    tends, diags = make_sharded_forward_step(mesh, dt=dt, c=c)(shard_state(state, mesh))
    want = {k: v for d in forward_step(state, dt, c) for k, v in d.items()}

    checked = 0
    for name, out in {**tends, **diags}.items():
        for d, shard in enumerate(out.shards):
            start, stop = mesh.columns(ncols, d)
            if not torch.equal(shard, want[name][:, start:stop]):
                raise AssertionError(f"{name} shard {d} differs from the single-process step")
            checked += 1
    if not want["t"].abs().max() > 0:
        raise AssertionError("dead step: all tendencies zero")
    verdicts = [None] * nproc
    dist.all_gather_object(verdicts, checked)
    dist.destroy_process_group()
    print(f"DISTRIBUTED-OK pid={pid} shards={mesh.size} checked={checked} verdicts={verdicts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
