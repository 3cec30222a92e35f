"""What every driver shares: the cell's files found by name, the seeded
weights and inputs, the traced stretch and what is read from it, and the
result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``configs/<config>.json``, and a traffic mix,
``workloads/<traffic>.json``, whose ``kind`` names the driver module
``drivers/<kind>.py``; the configuration's ``reference`` key names its
plain reference, ``reference/<reference>.py``, and its ``program`` key where
the program keeps its networks, optimizers and pools; the cell's
correctness limits are ``limits/<cell>.json``; each per-layer metric is
``metrics/<metric>.py``. Nothing here names a cell, a configuration, a
recipe or a metric.
"""

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "dsgan_tpu")
PROFILE_SETTLE_S = 0.05  # a trace loses the device work of its first milliseconds


def read_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell of the benchmark with everything its files say."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, root=ROOT):
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    root = Path(root)
    spec = read_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload [{name}] in BENCHMARK.json")
    config_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, entry=entry,
        config=read_json(root / config_entry["file"]),
        traffic=read_json(root / "benchmark" / "workloads" / f"{entry['traffic']}.json"),
        limits=read_json(root / "benchmark" / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)], root=root)


def load_module(path, name):
    """A module loaded from ``path`` under ``name`` (metric files carry
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(cell):
    """The plain reference that the cell's configuration names,
    ``reference/<reference>.py``."""
    name = cell.config["reference"]
    return load_module(Path(cell.root) / "benchmark" / "reference" / f"{name}.py",
                       "benchmark_reference_" + name.replace(".", "_").replace("-", "_"))


def attribute(obj, path):
    """``obj``'s attribute at the dotted ``path`` (``state.opt_G``)."""
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def metric_reader(root, name):
    return load_module(Path(root) / "benchmark" / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_").replace("-", "_"))


# -- seeded data ------------------------------------------------------------

def _generator(device, seed, stream):
    return torch.Generator(device=device).manual_seed((int(seed) * 7919 + stream) % (2 ** 63))


def seeded_weights(nets, seed, device):
    """{net: state_dict} for the meta-device reference networks ``nets``,
    as the recipes initialise them (yglbgyx/DS-GAN ``init_weights``,
    ``normal``, gain 0.02): every conv and linear weight N(0, 0.02), every
    bias 0, every PReLU slope 0.25. The normal draws of all the networks
    come from one call of a generator on ``device`` seeded from ``seed``,
    in float32, in the networks' sorted order."""
    leaves = []
    for key in sorted(nets):
        net = nets[key]
        prelu = {f"{m}.weight" for m, mod in net.named_modules()
                 if isinstance(mod, torch.nn.PReLU)}
        for name, t in net.state_dict().items():
            kind = "prelu" if name in prelu else ("normal" if t.dim() >= 2 else "zero")
            leaves.append((key, name, tuple(t.shape), kind))
    n = sum(torch.Size(s).numel() for _, _, s, k in leaves if k == "normal")
    draws = torch.randn(n, generator=_generator(device, seed, 0), device=device) * 0.02
    out, at = {key: {} for key in nets}, 0
    for key, name, shape, kind in leaves:
        if kind == "normal":
            size = torch.Size(shape).numel()
            out[key][name] = draws[at:at + size].view(shape)
            at += size
        else:
            out[key][name] = torch.full(shape, 0.25 if kind == "prelu" else 0.0, device=device)
    return out


def seeded_images(count, batch, height, width, seed, stream, device):
    """``count`` batches of uint8 (batch, height, width, 3) images drawn
    uniformly on ``device`` from ``seed``, as one host array."""
    g = _generator(device, seed, stream)
    x = torch.randint(0, 256, (count, batch, height, width, 3), generator=g, device=device,
                      dtype=torch.uint8)
    return x.cpu().numpy()


# -- tracing ----------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """A traced stretch: its length on the host clock, the device's busy
    seconds within it, each device operation's seconds by name, and the
    idle gaps with the host operation running when each began."""
    window_s: float
    busy_s: float
    ops: dict
    gaps: list

    def seconds_of(self, needles):
        """Device seconds of the operations whose names hold any of ``needles``."""
        return sum(s for name, s in self.ops.items() if any(k in name for k in needles))


def traced(fn, device):
    """Run ``fn()`` under torch.profiler after a short settle, inside a
    ``bench_window`` range; returns (fn's result, Trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        time.sleep(PROFILE_SETTLE_S)
        with record_function("bench_window"):
            out = fn()
            sync(device)
    return out, read_trace(prof.events(), device)


def read_trace(events, device):
    host, dev, window = [], [], None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name == "bench_window":
            if not on_device:
                window = (start, end)
        elif on_device:
            if not getattr(e, "is_user_annotation", False):  # a range's shadow is no work
                dev.append((start, end, e.name))
        else:
            host.append((start, end, e.name))
    if window is None:
        raise RuntimeError("the trace holds no bench_window range")
    w0, w1 = window
    spans, ops = [], {}
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            spans.append((s, e))
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    spans.sort()
    busy, gaps, cur = 0.0, [], None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        inner = [h for h in host if h[0] <= g0 <= h[1]]
        what = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "no host operation"
        named.append((what, (g1 - g0) / 1e6))
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, ops=ops, gaps=named)


def breakdown(trace):
    top = sorted(trace.ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in trace.gaps]}


# -- the run ----------------------------------------------------------------

def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def device_info(device):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def free(device):
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def scratch_dir():
    """A directory for the program's option echo, under the run's TMPDIR."""
    import tempfile

    return tempfile.mkdtemp(prefix="bench_")


def plain_precision():
    """float32 matrix products and convolutions without TF32, as the
    reference computes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def nested_env():
    """Cache directories of anything the run builds, inside the checkout at
    fixed paths (the program's nvcc builds already land in its own
    ``_build`` directory there)."""
    cache = ROOT / "benchmark" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
