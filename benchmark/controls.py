"""The readings that the correctness limits are set from.

    python3 benchmark/controls.py --workload <cell> --seeds 11,12,13 [--seconds 5] [--control fp8]

For each seed, one run of the cell at its own size and load (set-up and a
short window, no trace), then the check's numbers twice: the port's, and
the control's, the reference one precision below the configuration's (the
cell's limits file names it: "tf32" for float32 with TF32 off, "fp8" for
bfloat16; `--control` names another, for a number the cell's own control
moves too little to bound) computed in the port's place from the same
inputs.  One JSON line
per seed on stdout: {"seed", "port", "control", "faults", "limits"}, where
"faults" holds the readings of faults planted in the reference put in the
port's place (a training cell's half batch).
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def readings(workload: str, seeds, seconds: float, device=None, edit=None, control=None):
    """Yield (seed, port readings, control readings, limits) per seed."""
    from benchmark import run
    from benchmark.lib import env

    env.set_cache_dirs()
    entry, conf, mix, limits_file, _ = run.resolve(workload, edit)
    import torch

    device = device or torch.device("cuda", 0)
    driver = run.load_module(HERE / "drivers" / f"{mix['driver']}.py", "ctl_" + mix["driver"])
    spec = run.load_json(HERE / "limits" / f"{workload}.json")
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="diffab-bench-") as tmp:
            cell = run.Cell(workload, conf, mix, limits_file, seed, seconds, False,
                            device, tmp)
            r = driver.Run(cell)
            r.setup()
            cell.mark_setup_done()
            r.window()
            r.free()
            port, ctrl, faults = r.control(control or spec["control"])
        yield seed, port, ctrl, faults, limits_file


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", choices=("tf32", "fp8"), default=None,
                   help="the precision in the port's place (default: the cell's limits file's)")
    args = p.parse_args(argv)
    for seed, port, ctrl, faults, limits in readings(
            args.workload, [int(s) for s in args.seeds.split(",")], args.seconds,
            control=args.control):
        print(json.dumps({"seed": seed, "port": port, "control": ctrl, "faults": faults,
                          "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
