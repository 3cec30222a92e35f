"""The comparison that decides ``correct`` fails what it must fail, at a size
a CPU holds (32 x 32, float32 configurations, batches of two), with each
cell's own limits:

- the control: the reference with every convolution's and linear layer's
  products in 8-bit floats (``nets.Float8``), put in the program's place;
- a run driven through ``run.execute`` with the timed path broken
  underneath: a step that returns its state unchanged, half of the batch
  left out (the mean taken over the rest), an answer altered where it is
  produced. One card holds these cells, so no exchange between cards can
  be left out.

A sound run of the same size passes, so each failure is the fault's."""

import pytest
import torch

from benchmark import calibrate, common, correct
from benchmark import run as bench_run
from benchmark.drivers import serve, train
from benchmark.reference.nets import Float8

CPU = torch.device("cpu")
SEED = 3000000053
TRAIN_CELLS = ["pix2pix-train-b16", "cyclegan-train-b16"]


def _execute(root, cell):
    args = bench_run.parse(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
                            "--trace", "0"])
    return bench_run.execute(args, CPU, root=root)


@pytest.fixture(scope="module")
def readings(tiny_root):
    """A cell's program readings and the reference's, as a run makes them."""
    made = {}

    def get(cell):
        if cell not in made:
            c = common.load_cell(cell, tiny_root)
            prog = train.Program(c, SEED, CPU)
            first = prog.first_steps()
            while any(pool.count < pool.pool_size for pool in prog.pools):
                prog.chunk(c.traffic["steps_per_dispatch"])
            checked = prog.checked_chunk(c.traffic["steps_per_dispatch"])
            ref = train.follow(c, SEED, CPU, prog.side_a, prog.side_b, first, checked)
            made[cell] = (c, prog.side_a, prog.side_b, first, checked, ref)
        return made[cell]
    return get


@pytest.mark.parametrize("cell", TRAIN_CELLS + ["pix2pix-train-b1"])
def test_train_control_is_not_correct(readings, cell):
    c, side_a, side_b, first, checked, ref = readings(cell)
    ctl = train.follow(c, SEED, CPU, side_a, side_b, first, checked, precision=Float8)
    numbers, _ = correct.train_numbers(*calibrate._in_program_place(ctl, checked), ref,
                                       common.reference_module(c).KERNEL_LEAVES)
    assert correct.judge(numbers, c.limits)[0] is False


def test_serve_control_is_not_correct(tiny_root):
    c = common.load_cell("pix2pix-serve-b16", tiny_root)
    requests = common.seeded_images(2, 2, 32, 32, SEED, 1, CPU)
    ref = serve.reference_outputs(c, SEED, CPU, requests, [0, 1])
    ctl = serve.reference_outputs(c, SEED, CPU, requests, [0, 1], precision=Float8)
    numbers = {"pixel_gap": max(correct.pixel_gap(ctl[i], ref[i]) for i in ref)}
    assert correct.judge(numbers, c.limits)[0] is False


@pytest.mark.parametrize("cell", TRAIN_CELLS + ["pix2pix-train-b1", "pix2pix-serve-b16"])
def test_sound_run_is_correct(tiny_root, cell):
    assert _execute(tiny_root, cell)["correct"] is True


class _Frozen(torch.optim.Adam):
    """Adam whose step leaves the parameters as they are."""

    def step(self, closure=None):
        return None


def _frozen_adam(params, beta1):
    return _Frozen(list(params), lr=0.0, betas=(beta1, 0.999), eps=1e-8)


def _half_batch(set_input_chunk):
    def halved(self, inputs):
        return set_input_chunk(self, [{k: v[: len(v) // 2] for k, v in d.items()}
                                      for d in inputs])
    return halved


@pytest.mark.parametrize("cell", TRAIN_CELLS + ["pix2pix-train-b1"])
def test_state_left_unchanged_is_not_correct(tiny_root, cell, monkeypatch):
    from dsgan_tpu_torch.models import cycle_gan, pix2pix

    monkeypatch.setattr(pix2pix, "make_adam", _frozen_adam)
    monkeypatch.setattr(cycle_gan, "make_adam", _frozen_adam)
    res = _execute(tiny_root, cell)
    assert res["correct"] is False and res["checks"]["change_gap"]["value"] == 1.0
    for number in ("replay_change_gap", "kernel_grad_gap", "kernel_replay_change_gap"):
        assert res["checks"][number]["value"] == 1.0


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_batch_is_not_correct(tiny_root, cell, monkeypatch):
    from dsgan_tpu_torch.models.pix2pix import Pix2PixModel

    monkeypatch.setattr(Pix2PixModel, "set_input_chunk",
                        _half_batch(Pix2PixModel.set_input_chunk))
    assert _execute(tiny_root, cell)["correct"] is False


def _broken_serving(fault):
    from dsgan_tpu_torch import serve as program_serve

    original = program_serve.serving_fn

    def serving_fn(net):
        fn = original(net)

        def broken(x):
            y = fn(x).clone()
            if fault == "half_batch":
                y[len(y) // 2:] = 0
            else:
                y[0] = 255 - y[0]
            return y
        return broken
    return serving_fn


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_serve_fault_is_not_correct(tiny_root, fault, monkeypatch):
    from dsgan_tpu_torch import serve as program_serve

    monkeypatch.setattr(program_serve, "serving_fn", _broken_serving(fault))
    assert _execute(tiny_root, "pix2pix-serve-b16")["correct"] is False
