"""The readings that the correctness limits are set from, on the card at the
cell's own sizes, one seed after another in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 ... [--controls 3]

For each seed one JSON line: the program's numbers against the reference
(a sound run's, the lower reading), and for the first ``--controls`` seeds
the control's (the reference with every convolution's and linear layer's
products in 8-bit floats, ``nets.Float8``, a precision below the
configuration's bfloat16) and each planted fault's, against the same
reference. Training reads the first three steps and the checked chunk of
replayed steps, as a run's set-up makes them (no window); serving the
requests a run would sample, served one after another. The benchmark's own
runs never run the control or the faults. ``--norms FILE``: training
also writes each leaf's norms there, one JSON line a seed.

Faults: training, half of the batch left out and the mean taken over the
rest (the reference on the first half of each batch, from the start and
from the checked chunk's state); a step that returns its state unchanged
reads 1 on ``change_gap`` and ``replay_change_gap`` by construction and
is not run. Serving, half of each request's images left out (returned as zeros)
and one image of each request altered (inverted).
"""

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import common, correct  # noqa: E402
from benchmark.drivers import serve, train  # noqa: E402
from benchmark.reference.nets import Float8  # noqa: E402


def _norms(tensors, names):
    return [float(torch.linalg.vector_norm(tensors[k].double())) for k in names]


def _in_program_place(reading, checked):
    """A reference reading (``drivers/train.follow``) put where the
    program's first steps and checked chunk go."""
    first = {"losses": reading["start"]["losses"], "grads": reading["start"]["grads"],
             "params": reading["start"]["params"]}
    chunk = {"losses": reading["chunk"]["losses"], "params": reading["chunk"]["params"],
             "state": checked["state"]}
    return first, chunk


def train_readings(cell, seed, device, controls):
    """The program's numbers against the reference, each leaf's norms (for
    the record of which leaves move), and the control's and the half
    batch's numbers."""
    k = cell.traffic["steps_per_dispatch"]
    prog = train.Program(cell, seed, device)
    first = prog.first_steps()
    train.warm_up(prog, k)
    checked = prog.checked_chunk(k)
    side_a, side_b, batch = prog.side_a, prog.side_b, prog.batch
    del prog
    common.free(device)
    ref = train.follow(cell, seed, device, side_a, side_b, first, checked)
    names = sorted(ref["start"]["grads"])
    kernel = common.reference_module(cell).KERNEL_LEAVES

    def change(params, init):
        return {n: params[n] - init[n] for n in names}

    def leaf_norms(f, c):
        return {"grad": _norms(f["grads"], names),
                "change": _norms(change(f["params"], ref["start_init"]), names),
                "replay_change": _norms(change(c["params"], c["state"]["params"]), names)}

    out = {"program": correct.train_numbers(first, checked, ref, kernel)}
    norms = {"leaves": names, "reference": leaf_norms(*_in_program_place(ref, checked)),
             "program": leaf_norms(first, checked)}
    out["program"][1]["replayed"] = checked["replayed"]
    if controls:
        faults = {"control": dict(precision=Float8)}
        if batch > 1:  # a batch of one image has no half to leave out
            faults["half_batch"] = dict(images=batch // 2)
        for name, kw in faults.items():
            reading = train.follow(cell, seed, device, side_a, side_b, first, checked, **kw)
            f, c = _in_program_place(reading, checked)
            out[name] = correct.train_numbers(f, c, ref, kernel)
            norms[name] = leaf_norms(f, c)
    return out, norms


def serve_readings(cell, seed, device, controls, requests_per_run):
    tr = cell.traffic
    every = tr["sample_every"]
    offset = random.Random(int(seed)).randrange(every)
    ids = list(range(offset, requests_per_run, every))
    prog = serve.Program(cell, seed, device)
    kept = {i: prog.request(i)[0] for i in ids}
    requests = prog.requests
    del prog
    common.free(device)
    ref = serve.reference_outputs(cell, seed, device, requests, ids)

    def gap(outs):
        return {"pixel_gap": max(correct.pixel_gap(outs[i], ref[i]) for i in ids)}

    out = {"program": [gap(kept), {"compared_requests": len(ids)}]}
    if controls:
        ctl = serve.reference_outputs(cell, seed, device, requests, ids, precision=Float8)
        out["control"] = [gap(ctl), {}]
        half = {i: torch.cat([kept[i][: len(kept[i]) // 2],
                              torch.zeros_like(kept[i][len(kept[i]) // 2:])]) for i in ids}
        out["half_batch"] = [gap(half), {}]
        altered = {}
        for i in ids:
            t = kept[i].clone()
            t[0] = 255 - t[0]
            altered[i] = t
        out["altered_answer"] = [gap(altered), {}]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--program_dtype", default=None,
                    help="run the program in this dtype in place of the configuration's (a "
                         "second witness: float32 runs the kernels' float32 builds)")
    ap.add_argument("--norms", default=None, help="training: write each leaf's norms here")
    ap.add_argument("--requests_per_run", type=int, default=600,
                    help="serving: the requests a run's window holds, whose sample is compared")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = common.load_cell(args.workload)
    if args.program_dtype:
        cell.config["options"]["dtype"] = args.program_dtype
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        controls = n < args.controls
        if cell.traffic["kind"] == "train":
            out, norms = train_readings(cell, seed, device, controls)
            if args.norms:
                with open(args.norms, "a") as f:
                    f.write(json.dumps({"workload": args.workload, "seed": seed, **norms}) + "\n")
        else:
            out = serve_readings(cell, seed, device, controls, args.requests_per_run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          **{k: {"numbers": v[0], "where": v[1]} for k, v in out.items()}}),
              flush=True)
        common.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
