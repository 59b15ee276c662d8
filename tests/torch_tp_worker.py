"""One rank of the multi-process tensor-parallel checks in
tests/test_torch_tp.py, on the CPU over gloo:

    python tests/torch_tp_worker.py RANK WORLD INPUTS OUT_DIR

INPUTS is a torch.save'd list of jobs the test wrote.  Each job names a
config, a full TrainState, a global batch, every dp rank's injected draws
for each step and a tp size; the rank makes the (dp, tp) mesh over all
WORLD ranks, shards the state, and for each step records the gradients
of its dp rank's rows (gathered over tp), runs `make_sharded_train_step`,
and records the metrics, the gathered state and its own replicated
leaves.  A job with "checkpoint" set also restores a replicated
checkpoint into the mesh, saves the sharded state after one step, and
runs `fit` under the mesh.  Everything the rank holds goes to
OUT_DIR/rank<RANK>.pt.  Rank 0 serves the TCP store on a port the system
gives it and publishes it in OUT_DIR/port.  It imports torch and the
port only.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch.distributed as dist  # noqa: E402

from diffab_pytorch_tpu_torch.parallel.mesh import (  # noqa: E402
    batch_sharding,
    make_mesh,
    param_sharding,
    put_global,
)
from diffab_pytorch_tpu_torch.parallel.tp import (  # noqa: E402
    gather_params,
    gather_state,
    head_shard,
    make_sharded_train_step,
    shard_state,
    tp_harness,
)
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from diffab_pytorch_tpu_torch.train.harness import DiffAb  # noqa: E402
from diffab_pytorch_tpu_torch.train.trainer import fit  # noqa: E402
from torch_parallel_worker import connect  # noqa: E402


def detached(d):
    return None if d is None else {k: v.detach().clone() for k, v in d.items()}


def run_job(job: dict) -> dict:
    harness = DiffAb(job["config"], device="cpu")
    mesh = make_mesh(job["tp"])
    heads = head_shard(harness.config.model, mesh)
    local = tp_harness(harness, heads) if heads else harness
    state = shard_state(job["state"], mesh)
    rows = put_global(job["batch"], batch_sharding(mesh.dp_group))
    step = make_sharded_train_step(harness, mesh)
    splits = param_sharding(state.params, mesh)
    out = dict(steps=[], local_shapes={k: tuple(v.shape) for k, v in state.params.items()})
    for draws in job["draws"]:
        d = draws[mesh.dp_rank]
        _, _, grads = local.loss_and_grads(state.params, rows, d, state.step)
        grads = gather_params([grads], mesh)[0]
        state, metrics = step(state, rows, d)
        full = gather_state(state, mesh)
        out["steps"].append(dict(
            grads=detached(grads), metrics={k: v.clone() for k, v in metrics.items()},
            params=detached(full.params), ema=detached(full.ema_params),
            mu=detached(full.opt_state.mu), nu=detached(full.opt_state.nu),
            replicated={k: v.detach().clone() for k, v in state.params.items()
                        if splits[k] is None}))
    if job.get("checkpoint"):
        out.update(checkpoints(job, harness, mesh, rows))
    return out


def checkpoints(job: dict, harness: DiffAb, mesh, rows) -> dict:
    """Restore the test's replicated checkpoint into the mesh, take one
    step, save the sharded state; then `fit` under the mesh from a fresh
    state to a checkpoint of its own."""
    root = job["checkpoint"]
    restored = ckpt.restore_checkpoint(os.path.join(root, "replicated"), "cpu", mesh=mesh)
    parts = dict(params=detached(restored.params), mu=detached(restored.opt_state.mu),
                 nu=detached(restored.opt_state.nu), ema=detached(restored.ema_params),
                 step=restored.step, count=restored.opt_state.count)
    step = make_sharded_train_step(harness, mesh)
    state, metrics = step(restored, rows, job["draws"][0][mesh.dp_rank])
    ckpt.save_checkpoint(os.path.join(root, "sharded"), state, mesh=mesh)
    full = gather_state(state, mesh)
    fitted = fit(harness, [job["batch"]], epochs=2, seed=3,
                 checkpoint_dir=os.path.join(root, "fit"), mesh=mesh)
    return dict(restored=parts, ckpt_metrics={k: v.clone() for k, v in metrics.items()},
                ckpt_state=dict(params=detached(full.params), mu=detached(full.opt_state.mu),
                                nu=detached(full.opt_state.nu), ema=detached(full.ema_params),
                                step=full.step, count=full.opt_state.count),
                fit_step=fitted.step)


def main(rank: int, world: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=connect(rank, world, out_dir), rank=rank,
                            world_size=world)
    try:
        jobs = torch.load(inputs, weights_only=False)
        results = {job["name"]: run_job(job) for job in jobs}
        if "jax" in sys.modules:
            raise RuntimeError("the worker imported jax")
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
