"""One rank of the two-process data-parallel check in
tests/test_torch_parallel.py, on the CPU over gloo:

    python tests/torch_parallel_worker.py RANK WORLD INPUTS OUT_DIR

INPUTS is a torch.save'd dict the test wrote (the config, the replicated
state and target, the global batch, and every rank's injected draws).  The
rank runs `make_dp_train_step` on its rows for each step's draws,
`sample_fanout_sharded` and `score_fanout_sharded` with its injected
noise, and writes what it holds to OUT_DIR/rank<RANK>.pt.  Rank 0 serves
the TCP store on a port it is given by the system and publishes the port
in OUT_DIR/port.  It imports torch and the port only.
"""

import datetime
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from diffab_pytorch_tpu_torch.parallel.dp import (  # noqa: E402
    make_dp_train_step,
    sample_fanout_sharded,
    score_fanout_sharded,
)
from diffab_pytorch_tpu_torch.parallel.mesh import batch_sharding, put_global  # noqa: E402
from diffab_pytorch_tpu_torch.train.harness import DiffAb  # noqa: E402


def connect(rank: int, world: int, out_dir: str) -> dist.TCPStore:
    timeout = datetime.timedelta(seconds=60)
    port_file = os.path.join(out_dir, "port")
    if rank == 0:
        store = dist.TCPStore("127.0.0.1", 0, world, True, timeout=timeout,
                              wait_for_workers=False)
        with open(port_file + ".tmp", "w") as f:
            f.write(str(store.port))
        os.replace(port_file + ".tmp", port_file)
        return store
    deadline = time.monotonic() + timeout.total_seconds()
    while not os.path.exists(port_file):
        if time.monotonic() > deadline:
            raise TimeoutError("rank 0 published no store port")
        time.sleep(0.05)
    with open(port_file) as f:
        return dist.TCPStore("127.0.0.1", int(f.read()), world, False, timeout=timeout)


def main(rank: int, world: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=connect(rank, world, out_dir), rank=rank,
                            world_size=world)
    try:
        x = torch.load(inputs, weights_only=False)
        harness = DiffAb(x["config"], device="cpu")
        state = x["state"]
        step = make_dp_train_step(harness)
        rows = put_global(x["batch"], batch_sharding())
        metrics, params = [], []
        for draws in x["step_draws"][rank]:
            state, m = step(state, rows, draws)
            metrics.append({k: v.clone() for k, v in m.items()})
            params.append({k: v.detach().clone() for k, v in state.params.items()})
        gen = torch.Generator().manual_seed(0)  # every draw below is injected
        init, steps = x["sample_noise"][rank]
        designs = sample_fanout_sharded(harness, x["params"], x["target"], gen, None,
                                        x["n_designs"], init_noise=init,
                                        step_noise=steps.__getitem__, **x["sample_opts"])
        scores = score_fanout_sharded(harness, x["params"], x["target"], designs, gen,
                                      draws=x["score_draws"][rank], **x["score_opts"])
        if "jax" in sys.modules:
            raise RuntimeError("the worker imported jax")
        torch.save(dict(metrics=metrics, params=params, designs=designs, scores=scores),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
