"""Run one cell of the benchmark of `diffab_pytorch_tpu_torch` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(`configs[].file`) and a traffic mix (`benchmark/traffic/<traffic>.json`),
whose "driver" names the code that runs it (`benchmark/drivers/<driver>.py`);
the cell's correctness limits are in `benchmark/limits/<cell>.json`, and
each per-layer metric is read by `benchmark/metrics/<metric>.py`.  All are
found by name, so a cell, mix, driver or metric is added as a file.

Set-up (kernel build or load, inputs and weights from the seed, warm-up and
graph capture) runs first and is timed from process start as setup_s; the
window then runs the cell's work for --seconds.  With --trace 1 the window
runs the same, then a short slice is profiled and the cell's per-layer
metrics are printed instead of the end-to-end ones.  Last, the reference
checks the outputs: the numbers compared are printed beside their limits
as the last lines on stderr and under "checks", last in the result line,
the last line on stdout.  Without a card, or with JAX loaded, the run exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """What a driver is given: the cell, its configuration, mix and limits,
    the run's arguments, device and scratch directory."""

    def __init__(self, name, conf, mix, limits, seed, seconds, trace, device, tmp):
        self.name = name
        self.conf, self.mix, self.limits = conf, mix, limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.tmp = device, tmp
        self.setup_s = None

    def mark_setup_done(self) -> None:
        self.setup_s = time.perf_counter() - T_START


def resolve(name: str, edit=None):
    """(workload entry, configuration, mix, limits, BENCHMARK.json) of cell
    `name`; `edit(conf, mix, limits)` may return changed copies (tests)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    conf = load_json(ROOT / config["file"])
    mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")["limits"]
    if edit is not None:
        conf, mix, limits = edit(conf, mix, limits)
    return entry, conf, mix, limits, bench


def cell_metrics(bench: dict, entry: dict, trace: bool) -> list:
    """The cell's metrics: with trace, the per-layer metrics that list the
    cell (or, listing none, move one of the cell's end-to-end metrics);
    else the end-to-end metrics that list the cell or list none."""
    name = entry["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (name in cells) if cells is not None else (m["moves"] in moves):
            out.append(m)
    return out


def read_per_layer(metric: dict, record: dict):
    path = HERE / "metrics" / f"{metric['name']}.py"
    mod = load_module(path, "bench_metric_" + metric["name"].replace(".", "_").replace("-", "_"))
    return mod.read(record)


def main(argv=None, *, device=None, edit=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark.lib import env

    env.set_cache_dirs()
    entry, conf, mix, limits, bench = resolve(args.workload, edit)

    import torch

    if device is None:
        count = env.card_count()
        if count < int(entry["chips"]):
            print(f"error: the cell needs {entry['chips']} CUDA device(s); "
                  f"{count} available", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    driver = load_module(HERE / "drivers" / f"{mix['driver']}.py", "bench_driver_" + mix["driver"])
    with tempfile.TemporaryDirectory(prefix="diffab-bench-") as tmp:
        cell = Cell(args.workload, conf, mix, limits, args.seed, args.seconds,
                    bool(args.trace), device, tmp)
        out = driver.run(cell)

    found = env.forbidden_loaded()
    if found:
        print(f"error: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3

    record = out["record"]
    metrics = {}
    for m in cell_metrics(bench, entry, bool(args.trace)):
        if args.trace:
            value = read_per_layer(m, record)
        else:
            value = cell.setup_s if m["name"] == "setup_s" else out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = env.device_info(device, int(entry["chips"]))
    dev["memory_peak_bytes"] = int(out["peak_bytes"])
    result = {"correct": out["checks"].correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    prof = record.get("profile")
    if args.trace and prof is not None:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = out["checks"].table()
    print(f"card: {env.card_line() if device.type == 'cuda' else 'cpu'}", file=sys.stderr)
    out["checks"].report(sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
