"""The train CLI's runtime flags on the CPU: SIGTERM preemption (as
tests/test_cli_e2e.py:214 drives the JAX CLI's), ``--profile_dir`` /
``--profile_steps`` and ``--debug_nans``.

A ``python -m dsgan_tpu_torch.train --platform cpu`` subprocess gets
SIGTERM after its first logged step: it writes the ``preempt`` checkpoint
and exits 0. ``--continue_train --which_epoch preempt`` then resumes it
in-process, and the run ends where an uninterrupted run with the same
flags ends: the last epoch checkpoint bit for bit, and the same
``result.csv`` and ``each_epoch.csv`` rows, whichever step the signal
fell on."""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

from dsgan_tpu_torch.train import main as train_main

COMMON = ["--platform", "cpu", "--dtype", "float32", "--loadSize_w", "36", "--loadSize_h", "36",
          "--fineSize_w", "32", "--fineSize_h", "32", "--nThreads", "2", "--ndf", "8",
          "--batchSize", "2", "--pool_size", "3", "--w_vgg", "0", "--print_freq", "1",
          "--steps_per_dispatch", "2"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """10 pairs: 5 steps an epoch at batch 2, random crops and flips."""
    root = tmp_path_factory.mktemp("preempt")
    d = root / "train_all"
    d.mkdir()
    rng = np.random.default_rng(1)
    for side in "ab":
        for i in range(10):
            Image.fromarray(rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)).save(
                d / f"{side}_{i}.png")
    return root


def _run(argv, root):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        model, steps = train_main(argv, dataset_path=str(root))
    return model, steps, out.getvalue()


def test_sigterm_checkpoints_and_the_resume_ends_where_an_unbroken_run_ends(dataroot, tmp_path):
    ckpts = tmp_path / "checkpoints"
    flags = COMMON + ["--dataroot", str(dataroot), "--checkpoints_dir", str(ckpts),
                      "--niter", "4", "--niter_decay", "0"]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-m", "dsgan_tpu_torch.train", *flags, "--name", "pre"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    log = ckpts / "pre" / "loss_log.txt"
    deadline = time.time() + 300
    while time.time() < deadline:  # until one step has logged (the header is line 1)
        if log.is_file() and len(log.read_text().splitlines()) >= 2:
            break
        if proc.poll() is not None:
            raise AssertionError("trainer exited early:\n" + proc.stdout.read().decode())
        time.sleep(0.05)
    else:
        proc.kill()
        raise AssertionError("trainer never reached a training step")
    proc.send_signal(signal.SIGTERM)
    text = proc.stdout.read().decode()
    assert proc.wait(timeout=300) == 0, text
    assert "checkpointing 'preempt' state" in text, text
    state = torch.load(ckpts / "pre" / "epoch_preempt" / "state.pt", weights_only=True)
    done = state["run"]["batches"] + 5 * (state["run"]["epoch"] - 1)
    assert 1 <= done < 20 and int(state["step"]) == done

    model, steps, _ = _run(flags + ["--name", "pre", "--continue_train", "--which_epoch", "preempt"],
                           dataroot)
    assert len(steps) == 20 - done and int(model.state.step) == 20
    whole, _, _ = _run(flags + ["--name", "whole"], dataroot)
    for f in ("result.csv", "each_epoch.csv"):
        assert (ckpts / "pre" / f).read_text() == (ckpts / "whole" / f).read_text(), f
    got = torch.load(ckpts / "pre" / "epoch_4" / "state.pt", weights_only=True)
    want = torch.load(ckpts / "whole" / "epoch_4" / "state.pt", weights_only=True)
    assert got.keys() == want.keys()
    for key in ("netG", "netD", "pool_images", "pool_generator", "step", "lr_last_epoch"):
        a, b = got[key], want[key]
        assert all(torch.equal(a[k], b[k]) for k in a) if isinstance(a, dict) else (
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), key
    for key in ("opt_G", "opt_D"):
        for a, b in zip(got[key]["state"].values(), want[key]["state"].values()):
            assert all(torch.equal(a[k], b[k]) for k in a), key


def test_profile_dir_writes_a_trace_of_the_step_range(dataroot, tmp_path):
    prof = tmp_path / "prof"
    _, steps, out = _run(COMMON + ["--checkpoints_dir", str(tmp_path), "--name", "prof",
                                   "--niter", "1", "--niter_decay", "0", "--profile_dir",
                                   str(prof), "--profile_steps", "1:2"], dataroot)
    path = prof / "trace_steps_1_2.json"
    assert len(steps) == 5 and f"profiler trace written to {path}" in out
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_debug_nans_runs_eager_steps_under_anomaly_mode(dataroot, tmp_path, monkeypatch):
    """The steps run with anomaly detection on, one at a time whatever
    --steps_per_dispatch says; the mode is off again after the run."""
    from dsgan_tpu_torch.models import pix2pix

    seen = []
    step = pix2pix.make_train_step

    def spy(cfg):
        inner = step(cfg)

        def run(*args):
            seen.append(torch.is_anomaly_enabled())
            return inner(*args)
        return run

    monkeypatch.setattr(pix2pix, "make_train_step", spy)
    model, steps, out = _run(COMMON + ["--checkpoints_dir", str(tmp_path), "--name", "nan",
                                       "--niter", "1", "--niter_decay", "0", "--debug_nans"],
                             dataroot)
    assert "anomaly detection is on" in out and len(steps) == 5
    assert seen == [True] * 5 and not torch.is_anomaly_enabled()
    assert model._chained.counts["eager"] == 0  # the single-step path ran every step
