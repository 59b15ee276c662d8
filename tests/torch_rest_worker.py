"""One rank of the two-process `sample_sharded` check in
tests/test_torch_rest_parallel.py, on the CPU over gloo:

    python tests/torch_rest_worker.py RANK WORLD INPUTS OUT_DIR

INPUTS is a torch.save'd dict the test wrote (the config, the replicated
parameters, the global batch of targets, every rank's injected sampling
noise and the sampler options).  The rank runs `sample_sharded` with its
injected noise, then with a seeded generator (to every rank, and to rank 0
only), and writes what it holds to OUT_DIR/rank<RANK>.pt.  It imports
torch and the port only.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from diffab_pytorch_tpu_torch.parallel import sample_sharded  # noqa: E402
from diffab_pytorch_tpu_torch.train.harness import DiffAb  # noqa: E402
from torch_parallel_worker import connect  # noqa: E402


def main(rank: int, world: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=connect(rank, world, out_dir), rank=rank,
                            world_size=world)
    try:
        x = torch.load(inputs, weights_only=False)
        harness = DiffAb(x["config"], device="cpu")
        init, steps = x["sample_noise"][rank]
        injected = sample_sharded(harness, x["params"], x["batch"], torch.Generator(), None,
                                  init_noise=init, step_noise=steps.__getitem__,
                                  **x["sample_opts"])
        gen = lambda: torch.Generator().manual_seed(x["seed"])
        drawn = sample_sharded(harness, x["params"], x["batch"], gen(), None,
                               return_trajectory=True, **x["sample_opts"])
        to_rank0 = sample_sharded(harness, x["params"], x["batch"], gen(), None, to_rank0=True,
                                  **x["sample_opts"])
        if "jax" in sys.modules:
            raise RuntimeError("the worker imported jax")
        torch.save(dict(injected=injected, drawn=drawn, to_rank0=to_rank0),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
