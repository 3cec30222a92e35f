import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import json  # noqa: E402
import shutil  # noqa: E402

import pytest  # noqa: E402

TINY_TRAFFIC = dict(batch=2, distinct_batches=4, steps_per_dispatch=2, trace_chunks=1,
                    reference_micro=1, trace_requests=2, sample_every=2, warmup_requests=1)


def make_tiny_root(dest, size=32, dtype="float32"):
    """A copy of the benchmark's files at ``dest`` whose configurations run
    at ``size`` x ``size`` in ``dtype`` and whose traffic is a few batches
    of two images: the same drivers, references and checks, small enough
    for a CPU."""
    dest = Path(dest)
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        for k in ("loadSize_h", "loadSize_w", "fineSize_h", "fineSize_w"):
            cfg["options"][k] = size
        cfg["options"]["dtype"] = dtype
        path.write_text(json.dumps(cfg))
    for path in (dest / "benchmark" / "workloads").glob("*.json"):
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **TINY_TRAFFIC)))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
