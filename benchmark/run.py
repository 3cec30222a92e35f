"""The benchmark of ``dsgan_tpu_torch`` on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell named in ``BENCHMARK.json``: its configuration file, its
traffic mix and driver (``drivers/<kind>.py``), its correctness limits;
with ``--trace 0`` prints its end-to-end metrics, with ``--trace 1`` its
per-layer metrics (``metrics/<metric>.py``) read from a traced stretch.
The last line of standard output is one JSON object; the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error and the last key of that object. Exits 2 without a CUDA
card, and 3 if JAX or the JAX package was loaded.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, device, root=ROOT, clock0=None):
    """Run the cell on ``device``; returns the result object. The command
    line reaches it only with a card; tests drive it on the CPU."""
    import importlib

    from benchmark import common, correct

    common.nested_env()
    cell = common.load_cell(args.workload, root)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     CLOCK0 if clock0 is None else clock0)
    ok, checks = correct.judge(run["numbers"], cell.limits)
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = common.metric_reader(root, m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = dict(run["info"])
    result = {"correct": ok, "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": device_info}
    if args.trace and run["trace"] is not None:
        device_info.update(busy_s=run["trace"].busy_s, window_s=run["trace"].window_s)
        result["breakdown"] = common.breakdown(run["trace"])
    result["where"] = dict(run["where"], **{f"{k} (not compared)": v
                                            for k, v in run["numbers"].items()
                                            if k not in cell.limits})
    result["checks"] = checks
    return result


def main(argv=None):
    args = parse(argv)
    import torch

    from benchmark import common, correct

    chips = common.load_cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s): the benchmark measures the card "
              "only", file=sys.stderr)
        return 2

    result = execute(args, torch.device("cuda", 0))
    found = common.banned_modules()
    if found:
        print(f"run.py: loaded {found}: the benchmark runs without JAX", file=sys.stderr)
        return 3
    correct.report(result["checks"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
