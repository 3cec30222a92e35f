"""``--steps_per_dispatch`` on the CPU (``ChainedStep``,
``Pix2PixModel.set_input_chunk`` / ``optimize_parameters_chunk``), as
tests/test_chained_step.py:165 pins the JAX package's: a train-CLI run at
k = 2 and k = 3 writes the same ``result.csv`` (print_freq 1, so every
step's row, from inside a chunk too), ``each_epoch.csv``, checkpoints and
step rows as k = 1, bit for bit, with an epoch tail shorter than k; the
chunk methods equal as many single steps; the optimizer state loads
across the card's and the CPU's Adam modes. On the CPU no graph exists:
every step of a chunk is eager. The capture and replay on the card are
tests/test_torch_cuda.py's and chip_smoke.py's."""

import contextlib
import copy
import io

import numpy as np
import pytest
import torch
from PIL import Image

from dsgan_tpu_torch.models import create_model
from dsgan_tpu_torch.models.base_model import ChainedStep
from dsgan_tpu_torch.models.pix2pix import load_adam, make_adam
from dsgan_tpu_torch.options.train_options import TrainOptions
from dsgan_tpu_torch.train import main as train_main

SIZE = 32
COMMON = ["--platform", "cpu", "--dtype", "float32", "--loadSize_w", "36", "--loadSize_h", "36",
          "--fineSize_w", str(SIZE), "--fineSize_h", str(SIZE), "--nThreads", "2", "--ndf", "8",
          "--batchSize", "2", "--pool_size", "3", "--w_vgg", "0"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """10 pairs of 36x36 PNGs: 5 steps an epoch at batch 2, random crops and
    flips."""
    root = tmp_path_factory.mktemp("chained")
    d = root / "train_all"
    d.mkdir()
    rng = np.random.default_rng(0)
    for side in "ab":
        for i in range(10):
            Image.fromarray(rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)).save(
                d / f"{side}_{i}.png")
    return root


def _train(root, k, name):
    out = root / f"out_{name}"
    with contextlib.redirect_stdout(io.StringIO()):
        model, steps = train_main(COMMON + ["--name", name, "--niter", "1", "--niter_decay", "1",
                                            "--print_freq", "1", "--steps_per_dispatch", str(k)],
                                  dataset_path=str(root), out_path=str(out))
    return model, steps, out


@pytest.fixture(scope="module")
def plain(dataroot):
    return _train(dataroot, 1, "k1")


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("k", [2, 3])
def test_cli_chunks_equal_single_steps(dataroot, plain, k):
    model1, steps1, out1 = plain
    model, steps, out = _train(dataroot, k, f"k{k}")
    assert model._chained.counts == dict(eager=10, captured=0, replayed=0)
    assert [r[:2] for r in steps] == [r[:2] for r in steps1] and len(steps) == 10
    for f in ("result.csv", "each_epoch.csv"):
        assert (out / f).read_text() == (out1 / f).read_text(), f
    assert len((out / "result.csv").read_text().splitlines()) == 10
    for epoch in (1, 2):
        got = torch.load(out / "checkpoints" / f"k{k}" / f"epoch_{epoch}" / "state.pt",
                         weights_only=True)
        want = torch.load(out1 / "checkpoints" / "k1" / f"epoch_{epoch}" / "state.pt",
                          weights_only=True)
        assert _equal(got, want), epoch


def _model(root, name):
    opt = TrainOptions().parse(str(root), str(root / f"m_{name}"),
                               COMMON + ["--name", name, "--steps_per_dispatch", "3"])
    with contextlib.redirect_stdout(io.StringIO()):
        model = create_model(opt)
        model.setup(opt)
    return model


def test_chunk_methods_equal_single_steps(dataroot):
    """Three staged batches through the chunk methods: each step's metrics,
    the last fake and the state equal three optimize_parameters calls; the
    visuals and image_paths show the last batch."""
    rng = np.random.default_rng(5)
    data = [{"A": rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8),
             "B": rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8),
             "A_paths": [f"a{i}_0", f"a{i}_1"]} for i in range(3)]
    single, chunked = _model(dataroot, "single"), _model(dataroot, "chunked")
    want = []
    for d in data:
        single.set_input(d)
        single.optimize_parameters()
        want.append(single.get_current_metrics())
    chunked.set_input_chunk(data)
    chunked.optimize_parameters_chunk()
    assert len(chunked._metrics_seq) == 3
    for m, w in zip(chunked._metrics_seq, want):
        chunked.use_metrics(m)
        assert chunked.get_current_metrics() == w
    assert chunked._metrics is chunked._metrics_seq[-1]
    assert torch.equal(chunked.fake_B, single.fake_B)
    assert _equal(chunked.state.state_dict(), single.state.state_dict())
    assert chunked.image_paths == ["a2_0", "a2_1"]
    assert np.array_equal(chunked.get_current_visuals()["real_A"], data[2]["A"][0])


def test_chained_step_on_cpu_runs_every_step_eagerly():
    """The generic helper on a toy step: (k, n) metrics in ``keys`` order,
    the last out, every step eager, ``ready`` and ``warmup`` moot."""
    def step(state, x, lr):
        state["w"] -= lr * x.sum()
        return {"w": state["w"].clone(), "x": x.mean()}, x * 2

    chained = ChainedStep(step, ready=lambda s: True, warmup=0)
    state = {"w": torch.zeros(())}
    xs = torch.arange(12, dtype=torch.float32).reshape(3, 2, 2)
    seq, out = chained(state, xs, 0.5)
    assert chained.keys == ["w", "x"] and seq.shape == (3, 2)
    assert seq[:, 0].tolist() == [-3.0, -14.0, -33.0] and seq[:, 1].tolist() == [1.5, 5.5, 9.5]
    assert torch.equal(out, xs[2] * 2)
    assert chained.counts == dict(eager=3, captured=0, replayed=0)


def test_adam_state_loads_across_modes():
    """A state dict written by the card's capturable Adam (a 0-d tensor
    rate, capturable groups, f32 step counts) loads into the CPU's: the
    CPU optimizer keeps its float rate and its mode, the moments and step
    counts arrive, and its next step is the one an unbroken run takes."""
    torch.manual_seed(0)
    params = [torch.randn(4, 3, requires_grad=True) for _ in range(2)]
    card_like = make_adam(params, 0.5)
    for p in params:
        p.grad = torch.randn_like(p)
    card_like.step()
    sd = copy.deepcopy(card_like.state_dict())
    for g in sd["param_groups"]:
        g["lr"], g["capturable"] = torch.tensor(3e-4), True
    for st in sd["state"].values():
        st["step"] = st["step"].float()
    twin = [p.detach().clone().requires_grad_(True) for p in params]
    cpu = make_adam(twin, 0.5)
    load_adam(cpu, sd)
    assert all(g["lr"] == 0.0 and not g["capturable"] for g in cpu.param_groups)
    for a, b in zip(card_like.state.values(), cpu.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
        assert b["step"].device.type == "cpu"
    for opt, ps in ((card_like, params), (cpu, twin)):
        for g in opt.param_groups:
            g["lr"] = 2e-4
        for p in ps:
            p.grad = torch.ones_like(p)
        opt.step()
    assert all(torch.equal(a, b) for a, b in zip(params, twin))
