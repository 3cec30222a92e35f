"""Full-state checkpoint and resume of the port (dsgan_tpu_torch.utils.
checkpoint, Pix2PixModel.save_networks / load_networks), as
tests/test_resume.py pins them for the JAX package: on the CPU in f32,
6 uninterrupted steps equal 3 steps, a save and 3 resumed steps bit for bit
(parameters, Adam moments and steps, the replay pool's images, count and
generator, the step counter); the LR position survives; retention; the
anomaly dump. The VGG term is off: it adds cost and no state."""

import os

import numpy as np
import pytest
import torch

from dsgan_tpu_torch.models import create_model
from dsgan_tpu_torch.models.base_model import AnomalyDetected
from dsgan_tpu_torch.options.train_options import TrainOptions
from dsgan_tpu_torch.utils import checkpoint as ckpt

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs one process per core group, and
    more threads than cores slow every process down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_model(root, name, *extra):
    argv = ["--platform", "cpu", "--dtype", "float32", "--batchSize", "2", "--pool_size", "3",
            "--loadSize_w", str(SIZE), "--fineSize_w", str(SIZE), "--loadSize_h", str(SIZE),
            "--fineSize_h", str(SIZE), "--ndf", "8", "--w_vgg", "0",
            "--checkpoints_dir", str(root), "--name", name, *extra]
    opt = TrainOptions().parse(argv=argv)
    model = create_model(opt)
    model.setup(opt)
    return model


def batches(n):
    rng = np.random.default_rng(3)
    return [{k: rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8) for k in "AB"}
            for _ in range(n)]


def run(model, data):
    for b in data:
        model.set_input(b)
        model.optimize_parameters()


def _tensors(obj, prefix=""):
    """Every tensor in a nested dict / list, by path."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    items = obj.items() if isinstance(obj, dict) else enumerate(obj) \
        if isinstance(obj, (list, tuple)) else ()
    out = {}
    for k, v in items:
        out.update(_tensors(v, f"{prefix}/{k}"))
    return out


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    data = batches(6)
    whole = make_model(root, "whole")
    run(whole, data)

    first = make_model(root, "split")
    run(first, data[:3])
    first.save_networks(1)
    second = make_model(root, "split", "--continue_train", "--which_epoch", "1")
    assert second.state.step == 3 and second.state.pool.count == 3
    run(second, data[3:])
    return whole, second


@pytest.mark.parametrize("part", ["netG", "netD", "opt_G", "opt_D", "pool_images",
                                  "pool_generator"])
def test_resumed_run_equals_uninterrupted_run(resumed, part):
    whole, second = (m._checkpoint_state()[part] for m in resumed)
    got, want = _tensors(second), _tensors(whole)
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert torch.equal(got[k], want[k]), (part, k)


def test_resumed_counters_and_metrics(resumed):
    whole, second = resumed
    assert whole.state.step == second.state.step == 6
    assert whole.state.pool.count == second.state.pool.count == 3
    assert whole.get_current_metrics() == second.get_current_metrics()
    # the Adam moments are there and moved
    assert any(s["exp_avg"].abs().sum() > 0 for s in second.state.opt_G.state.values())


def test_lr_position_restored(tmp_path):
    m = make_model(tmp_path, "lr")
    for _ in range(12):  # into the decay region
        m.update_learning_rate()
    m.save_networks(12)
    back = make_model(tmp_path, "lr", "--continue_train", "--which_epoch", "latest")
    assert back._last_epoch == 12 and back.lr == m.lr and 0 < m.lr < 2e-4


def test_plateau_resume_follows_jax_schedule(tmp_path):
    """Under --lr_policy plateau, a save after a reduction and a resume: the
    resumed LR sequence is the JAX shell's, whose checkpoint holds no
    plateau state (dsgan_tpu/models/pix2pix.py:540-550), so that its resume
    starts the policy afresh at opt.lr. The save carries a "plateau" entry,
    as earlier checkpoints of the port do: it is ignored."""
    import types

    from dsgan_tpu.models.base_model import BaseModel as JaxBaseModel

    m = make_model(tmp_path, "plat", "--lr_policy", "plateau")
    for _ in range(7):  # the first epoch sets the best, six more without gain reduce
        m.update_learning_rate(1.0)
    assert m.lr == pytest.approx(2e-4 * 0.2)
    m.save_networks(7, extra={"plateau": [m._plateau_best, m._plateau_bad, m._plateau_scale]})
    back = make_model(tmp_path, "plat", "--lr_policy", "plateau", "--continue_train",
                      "--which_epoch", "7")
    jax = JaxBaseModel()
    jax.initialize(types.SimpleNamespace(
        isTrain=True, checkpoints_dir=str(tmp_path), name="plat_jax", lr=2e-4,
        lr_policy="plateau", lr_decay_iters=50, niter=10, niter_decay=10, epoch_count=1,
        data_axis=1, platform="cpu"))
    jax._last_epoch = 7  # what its checkpoint restores: lr_last_epoch only
    jax._set_lr_from_schedule()
    got, want = [back.lr], [jax.lr]
    for v in [0.9, 0.95, 0.9, 0.91, 0.92, 0.93, 0.94, 0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]:
        back.update_learning_rate(v)
        jax.update_learning_rate(v)
        got.append(back.lr)
        want.append(jax.lr)
    assert got == want and got[0] == 2e-4 and len(set(got)) > 1


def test_eval_model_takes_the_generator_from_a_train_checkpoint(tmp_path):
    from dsgan_tpu_torch.options.test_options import TestOptions

    m = make_model(tmp_path, "g")
    run(m, batches(1))
    m.save_networks(1)
    opt = TestOptions().parse(argv=["--platform", "cpu", "--dtype", "float32",
                                    "--checkpoints_dir", str(tmp_path), "--name", "g",
                                    "--which_epoch", "1"])
    ev = create_model(opt)
    ev.setup(opt)
    for k, v in m.netG.state_dict().items():
        assert torch.equal(ev.netG.state_dict()[k], v), k


def test_keep_latest_and_latest_epoch(tmp_path):
    for e in range(1, 6):
        ckpt.save_state(str(tmp_path), e, {"x": torch.full((2,), float(e))})
    ckpt.save_state(str(tmp_path), "anomaly", {"x": torch.zeros(1)})
    assert ckpt.latest_epoch(str(tmp_path)) == 5
    ckpt.keep_latest(str(tmp_path), 2)
    left = sorted(d for d in os.listdir(tmp_path) if d.startswith("epoch_"))
    assert left == ["epoch_4", "epoch_5", "epoch_anomaly"]
    assert float(ckpt.restore_state(str(tmp_path), 5)["x"][0]) == 5.0
    ckpt.keep_latest(str(tmp_path), 0)  # 0: retention off
    assert ckpt.latest_epoch(str(tmp_path)) == 5
    ckpt.keep_latest(str(tmp_path), 0, keep_none_ok=True)
    assert ckpt.latest_epoch(str(tmp_path)) is None
    assert ckpt.latest_epoch(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(str(tmp_path), 5)


def test_keep_ckpts_through_save_networks(tmp_path):
    m = make_model(tmp_path, "keep", "--keep_ckpts", "1")
    for e in (1, 2, 3):
        m.save_networks(e)
    assert sorted(d for d in os.listdir(tmp_path / "keep") if d.startswith("epoch_")) == \
        ["epoch_3"]


def test_check_anomaly_dumps_and_raises(tmp_path):
    m = make_model(tmp_path, "nan")
    run(m, batches(1))
    m.check_anomaly("clean")  # finite: nothing happens
    m._metrics["loss_G"] = torch.tensor(float("nan"))
    m._host_metrics = None
    with pytest.raises(AnomalyDetected) as e:
        m.check_anomaly("forced")
    assert e.value.bad_metrics == ["loss_G"]
    dump = tmp_path / "nan" / "anomaly"
    assert (dump / "real_A.npy").is_file() and (dump / "report.txt").is_file()
    assert "forced" in (dump / "report.txt").read_text()
    assert ckpt.restore_state(str(tmp_path / "nan"), "anomaly")["step"] == 1
