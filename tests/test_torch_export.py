"""The port's serving artifact (dsgan_tpu_torch.export) on the CPU: the
round trip against the live serving function, bit for bit; a batch-
polymorphic artifact; the MixConvNeXtML artifact, whose graph holds the
registered K1 / K3 ops, against the JAX package's export_generator
artifact (<= 1 level on <= 1e-3 of pixels, tests/test_export.py's
allowance); the registered ops' fake implementations against the real
ones; the export CLI after a train-CLI run; and the default device."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dsgan_tpu.export import export_generator as jax_export_generator
from dsgan_tpu.export import load_artifact as jax_load_artifact
from dsgan_tpu.export import save_artifact as jax_save_artifact
from dsgan_tpu.models import define_G as jax_define_G
from dsgan_tpu_torch import export, serve
from dsgan_tpu_torch.kernels import block_core as bc
from dsgan_tpu_torch.models import define_G, init_params

CL = torch.channels_last


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _resnet(norm="instance"):
    """A tiny resnet_6blocks (ngf 8, f32), with BatchNorm running statistics
    moved off their start values by one train-mode forward."""
    net = define_G(3, 3, 8, "resnet_6blocks", norm=norm, dtype=torch.float32, device="cpu",
                   seed=0, train=True)
    if norm == "batch":
        with torch.no_grad():
            net(torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(1)))
    return net.eval()


def _u8(b, size=32, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3), dtype=np.uint8)


def _saved(net, path, **kw):
    program, meta = export.export_generator(net, 32, 32, 3, **kw)
    return export.save_artifact(str(path), program, meta), meta


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The tiny resnet's serving artifact, instance norm and BatchNorm:
    {norm: (net, path, meta)}, exported once for the tests below."""
    out = {}
    for norm in ("instance", "batch"):
        net = _resnet(norm)
        out[norm] = (net, *_saved(net, tmp_path_factory.mktemp(norm) / "g.pt2"))
    return out


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_roundtrip_matches_live_serving_fn(artifacts, norm):
    net, path, meta = artifacts[norm]
    call, meta2 = export.load_artifact(path, device="cpu")
    assert meta2 == meta and meta2["uint8_io"] is True and meta2["platforms"] == ["cuda", "cpu"]
    x = _u8(2)
    got = call(x)
    assert got.dtype == torch.uint8 and got.shape == (2, 32, 32, 3)
    want = serve.serving_fn(net)(torch.from_numpy(x))
    assert torch.equal(got, want)


def test_batch_polymorphic_artifact(artifacts):
    _, path, meta = artifacts["instance"]
    assert meta["batch"] == "polymorphic" and meta["input"].startswith("uint8 NHWC [b,32,32,3]")
    call, _ = export.load_artifact(path, device="cpu")
    for b in (1, 3):
        assert call(np.zeros((b, 32, 32, 3), np.uint8)).shape == (b, 32, 32, 3)


def test_fixed_batch_and_float_io(tmp_path):
    program, meta = export.export_generator(_resnet(), 32, 32, 3, batch=2, uint8_io=False)
    assert meta["batch"] == 2 and meta["output"].startswith("float NHWC")
    x = torch.from_numpy(_u8(2)).float() / 127.5 - 1.0
    got = program.module()(x)
    with torch.no_grad():
        want = _resnet()(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_mixconvnext_artifact_matches_jax_and_holds_the_kernels(tmp_path):
    params = init_params(1)
    net = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.float32, device="cpu", params=params)
    program, meta = export.export_generator(net, 32, 32, 3)
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.dsgan.block_core.default) == 5
    assert ops.count(torch.ops.dsgan.block_core2.default) == 4
    path = export.save_artifact(str(tmp_path / "g.pt2"), program, meta)
    call, _ = export.load_artifact(path, device="cpu")
    x = _u8(2, seed=2)
    got = call(x)
    assert torch.equal(got, serve.serving_fn(net)(torch.from_numpy(x)))

    g = jax_define_G(3, 3, 32, "MixConvNeXtML", dtype=None, inference=True)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    blob, jmeta = jax_export_generator(g, variables, 32, 32, 3, platforms=("cpu",))
    jpath = jax_save_artifact(str(tmp_path / "g.stablehlo"), blob, jmeta)
    jcall, _ = jax_load_artifact(jpath)
    want = np.asarray(jcall(x)).astype(np.int32)
    assert {k: v for k, v in meta.items() if k != "platforms"} == \
        {k: v for k, v in jmeta.items() if k != "platforms"}
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (int(diff.max()), (diff > 0).mean())


def test_registered_ops_fake_matches_the_real_output():
    """The fake implementations give what the CPU implementations give:
    shape, dtype and channels_last strides (torch.library.opcheck)."""
    rng = np.random.default_rng(3)

    def act(c):
        a = torch.from_numpy(rng.standard_normal((2, 5, 6, c)).astype(np.float32))
        return a.permute(0, 3, 1, 2)

    def weights(c, p):
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) * 0.1
                for s in ((c, 4 * c), (4 * c,), (4 * c, p), (p,), (c, p))]

    h, x = act(12), act(12)
    pk = bc.pack_weights(*weights(12, 20), torch.float32)
    args = (h, x, *bc.instance_stats(h), *bc._op_weights(pk), "erf")
    torch.library.opcheck(torch.ops.dsgan.block_core.default, args)
    out = torch.ops.dsgan.block_core(*args)
    assert out.shape == (2, 20, 5, 6) and out.is_contiguous(memory_format=CL)
    ha, hb, xa, xb = act(8), act(8), act(8), act(8)
    pk2 = bc.pack_weights(*weights(16, 24), torch.float32, c1=8)
    args2 = (ha, hb, xa, xb, *bc.instance_stats(ha), *bc.instance_stats(hb),
             *bc._op_weights(pk2), "tanh")
    torch.library.opcheck(torch.ops.dsgan.block_core2.default, args2)
    # the CPU implementation is the plain version on the unpacked weights
    want = bc.block_core2_reference(ha, hb, xa, xb, *bc.instance_stats(ha),
                                    *bc.instance_stats(hb), *bc._unpack(pk2, 8), gelu="tanh")
    assert torch.equal(torch.ops.dsgan.block_core2(*args2), want)


def test_export_cli_after_training(tmp_path):
    from dsgan_tpu_torch.train import main as train_main

    rng = np.random.default_rng(0)
    d = tmp_path / "data" / "train_all"
    d.mkdir(parents=True)
    for i in range(2):
        for pfx in "ab":
            Image.fromarray(rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)).save(
                d / f"{pfx}_{i}.png")
    common = ["--which_model_netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
              "--norm", "batch", "--loadSize_w", "32", "--loadSize_h", "32", "--fineSize_w", "32",
              "--fineSize_h", "32", "--dtype", "float32", "--nThreads", "1", "--name", "exp",
              "--platform", "cpu"]
    out = str(tmp_path / "out")
    train_main(common + ["--batchSize", "2", "--w_vgg", "0", "--pool_size", "2", "--niter", "1",
                         "--niter_decay", "0", "--print_freq", "8"],
               dataset_path=str(tmp_path / "data"), out_path=out)

    # the eval CLI takes the same zoo flags and the checkpoint's statistics
    from dsgan_tpu_torch.test import main as eval_main

    results = tmp_path / "results"
    _, rows = eval_main(common + ["--which_epoch", "1", "--phase", "train_all/", "--how_many",
                                  "2", "--results_dir", str(results)],
                        dataset_path=str(tmp_path / "data"), out_path=out)
    assert len(rows) == 2
    assert (results / "exp" / "train_all" / "_1" / "metrics.csv").is_file()

    art = str(tmp_path / "g.pt2")
    export.main(common + ["--which_epoch", "1", "--out", art], dataset_path=str(tmp_path / "data"),
                out_path=out)
    assert os.path.isfile(art) and os.path.isfile(art + ".json")
    meta = json.load(open(art + ".json"))
    assert meta["height"] == 32 and meta["input_nc"] == 3 and meta["quantize"] == "none"
    call, _ = export.load_artifact(art, device="cpu")
    x = _u8(1)
    y = call(x)
    assert y.shape == (1, 32, 32, 3) and y.dtype == torch.uint8

    # the artifact is the checkpoint's generator with its running statistics
    state = torch.load(os.path.join(out, "checkpoints", "exp", "epoch_1", "state.pt"),
                       weights_only=True)["netG"]
    assert any(k.endswith("running_var") for k in state)
    net = define_G(3, 3, 8, "resnet_6blocks", norm="batch", use_dropout=True,
                   dtype=torch.float32, device="cpu")
    net.load_state_dict(state)
    assert torch.equal(y, serve.serving_fn(net)(torch.from_numpy(x)))


def test_load_artifact_needs_a_card_unless_cpu_is_asked(artifacts):
    _, path, _ = artifacts["instance"]
    assert export.load_artifact(path, device="cpu")[0](_u8(1)).shape == (1, 32, 32, 3)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.load_artifact(path)
