"""Variants of the bf16 block-core kernels on the card, in one process:

    python -m dsgan_tpu_torch.kernel_variants [--iters N] [--part sources|routes|all]

``routes``: the bf16 forward's routes (``kernels/block_core.py::fwd_plan``)
side by side wherever more than one can take a site of the 256x256
generator, at batch 1 and 16: c1 narrow vs fused, c4, c5 and uc1 fused vs
two_pass, and the fused route's 64- vs 128-row tiles at c2 and uc3; each
timed by CUDA events in turns (a, b, b, a) with its rel-L2 to the plain
PyTorch version.

``sources``: variants of the bf16 K3 / K4 kernels against the committed
sources at the decoder's four sites (batch 16, 256x256). Each variant is
a text edit of ``csrc/block_core2_fwd_sm90.cu`` or
``csrc/block_core2_bwd_sm90.cu``, built beside the committed library and
timed by CUDA events in turns (every variant, then every variant in the
reverse order), with its rel-L2 to the plain PyTorch version. Variants:

  base        the committed source
  approx      tanh.approx.f32 for the GELU's tanh
  per_item    one block per work item instead of one persistent block a SM
  nostore     K4 without the ag / dg1 scratch stores (a diagnostic: its
              results are wrong; it shows what those stores cost)

Prints one JSON line per site and kernel. Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

TANH = ("tanhf(k0 * (v + k1 * v * v * v))", "tanh_approx(k0 * (v + k1 * v * v * v))")
TANH_FN = ("namespace {\n", "namespace {\n__device__ __forceinline__ float tanh_approx(float x) {\n"
           "  float y;\n  asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n  return y;\n}\n")
VARIANTS = {
    "block_core2_fwd_sm90": {
        "base": [],
        "approx": [TANH, TANH_FN],
        "per_item": [("kernel<<<(unsigned)(items < sms ? items : sms),", "kernel<<<(unsigned)items,")],
    },
    "block_core2_bwd_sm90": {
        "base": [],
        "approx": [TANH, TANH_FN],
        "per_item": [("return (unsigned)(items < sms ? items : sms);", "return (unsigned)items;")],
        "nostore": [("          if (ok) {\n", "          if (ok && a.HW < 0) {\n")],
    },
}
# (site, H = W, channels of each part, P) of the decoder at 256x256
SITES = [("uc1", 32, 512, 512), ("uc2", 64, 256, 256), ("uc3", 128, 128, 128), ("uc4", 256, 64, 64)]
# (site, H = W, parts, P, the routes that can take it) for ``routes``
ROUTE_SITES = [("c1", 256, (3,), 64, ("narrow", "fused")),
               ("c2", 128, (64,), 128, ("fused64", "fused128")),
               ("c4", 32, (256,), 512, ("fused", "two_pass")),
               ("c5", 16, (512,), 1024, ("fused", "two_pass")),
               ("uc1", 32, (512, 512), 512, ("fused", "two_pass")),
               ("uc3", 128, (128, 128), 128, ("fused64", "fused128"))]


def build_variants(build, out_dir):
    """{(source, variant): loaded library}, every variant compiled in parallel."""
    jobs = []
    for name, variants in VARIANTS.items():
        for variant, edits in variants.items():
            text = (build.SRC_DIR / f"{name}.cu").read_text()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"variant {variant} of {name}: the source no longer has {old!r}")
                text = text.replace(old, new, 1)
            src = Path(out_dir) / f"{name}-{variant}.cu"
            src.write_text(text.replace('#include "sm90.cuh"', f'#include "{build.SRC_DIR}/sm90.cuh"'))
            lib = src.with_suffix(".so")
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
            jobs.append((name, variant, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, variant, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {variant}:\n{log}")
        libs[(name, variant)] = ctypes.CDLL(str(lib))
    return libs


def entries(bc, lib, name):
    """The wrapper's C entries with this library in place of ``name``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = getattr(lib, name)
    fn.restype = i
    base = bc._lib()
    if name == "block_core2_fwd_sm90":
        fn.argtypes = [i] + [p] * 14 + [ll] + [i] * 13 + [p]
        two_pass, narrow = lib.block_core_fwd_sm90_two_pass, lib.block_core_fwd_narrow
        two_pass.argtypes, narrow.argtypes = base.fwd_two_pass.argtypes, base.fwd_narrow.argtypes
        two_pass.restype = narrow.restype = i
        return base._replace(fwd2_sm90=fn, fwd_two_pass=two_pass, fwd_narrow=narrow)
    fn.argtypes = [i] + [p] * 27 + [i] * 11 + [p, ctypes.POINTER(ctypes.c_ulonglong), p]
    return base._replace(bwd2_sm90=fn)


def rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30))


def time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def routes(torch, bc, instance_stats, iters):
    """Every route that can take a site, on the same inputs, in turns."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    for batch in (1, 16):
        for site, side, parts, p, names in ROUTE_SITES:
            c = sum(parts)

            def act(ch):
                t = torch.randn((batch, ch, side, side), generator=gen, device="cuda")
                return t.to(dt).contiguous(memory_format=torch.channels_last)

            w = [(torch.randn(s, generator=gen, device="cuda") * k).to(dt) for s, k in (
                ((c, 4 * c), 0.05), ((4 * c,), 1.0), ((4 * c, p), 0.05), ((p,), 1.0), ((c, p), 0.05))]
            hs, xs = [act(ci) for ci in parts], [act(ci) for ci in parts]
            stats = [s for h in hs for s in instance_stats(h)]
            fwd_parts = [(h, x, stats[2 * i], stats[2 * i + 1]) for i, (h, x) in enumerate(zip(hs, xs))]
            packed = bc.pack_weights(*w, dt, c1=parts[0])
            m, (cp, h4p), pp = batch * side * side, packed.w1.shape, packed.w2.shape[1]
            fused = bc._fused_plan(m, cp, pp)
            plans = {"narrow": bc.FwdPlan("narrow", 0, 0, 0, 0, 0, 1, 0), "fused": fused,
                     "fused64": fused._replace(nwg=1), "fused128": fused._replace(nwg=2),
                     "two_pass": bc._two_pass_plan(m, cp, h4p, pp)}
            if len(parts) == 1:
                want = bc.block_core_reference(hs[0], xs[0], *stats, *w, "tanh")
            else:
                want = bc.block_core2_reference(*hs, *xs, *stats, *w, "tanh")
            row = dict(site=site, batch=batch, chosen=bc.fwd_plan(m, parts[0], sum(parts[1:]), h4p,
                                                                  pp).route,
                       plans={n: plans[n]._asdict() for n in names}, ms={}, rel_l2={})
            with torch.inference_mode():
                for name in names + names[::-1]:
                    call = lambda: bc._launch_fwd_sm90(fwd_parts, packed, "tanh", plans[name])
                    row["rel_l2"][name] = rel_l2(call(), want)
                    row["ms"].setdefault(name, []).append(time_ms(torch, call, iters))
            print(json.dumps(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Variants of the bf16 block-core kernels on the card")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--part", choices=("sources", "routes", "all"), default="all")
    args = ap.parse_args(argv)

    import torch

    from dsgan_tpu_torch.device import card_info
    from dsgan_tpu_torch.kernels import _build
    from dsgan_tpu_torch.kernels import block_core as bc
    from dsgan_tpu_torch.ops import instance_stats

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    print(card_info())
    if args.part in ("routes", "all"):
        routes(torch, bc, instance_stats, args.iters)
    if args.part == "routes":
        return
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(_build, tmp)
        gen = torch.Generator(device="cuda").manual_seed(0)
        dt, batch = torch.bfloat16, 16

        for site, side, c1, p in SITES:
            c = 2 * c1

            def act(ch):
                t = torch.randn((batch, ch, side, side), generator=gen, device="cuda")
                return t.to(dt).contiguous(memory_format=torch.channels_last)

            w = [(torch.randn(s, generator=gen, device="cuda") * k).to(dt) for s, k in (
                ((c, 4 * c), 0.05), ((4 * c,), 1.0), ((4 * c, p), 0.05), ((p,), 1.0), ((c, p), 0.05))]
            hs, xs, g = [act(c1), act(c1)], [act(c1), act(c1)], act(p)
            stats = [s for h in hs for s in instance_stats(h)]
            packed = bc.pack_weights(*w, dt, c1=c1)
            calls = {
                "block_core2_fwd_sm90": (
                    lambda: bc.block_core2(*hs, *xs, *stats, *w, "tanh", packed),
                    bc.block_core2_reference(*hs, *xs, *stats, *w, "tanh")),
                "block_core2_bwd_sm90": (
                    lambda: bc.block_core2_bwd(*hs, *xs, *stats, g, w[0], w[1], w[2], w[4], "tanh",
                                               packed),
                    bc.block_core2_bwd_reference(*hs, *xs, *stats, g, w[0], w[1], w[2], w[4],
                                                 "tanh"))}
            for name, (call, want) in calls.items():
                row = dict(site=site, kernel="K3" if "fwd" in name else "K4", batch=batch, ms={},
                           rel_l2={})
                order = [v for (n, v) in libs if n == name]
                real = bc._lib
                for variant in order + order[::-1]:
                    fixed = entries(bc, libs[(name, variant)], name)
                    bc._lib = lambda fixed=fixed: fixed
                    try:
                        with torch.no_grad():
                            got = call()
                            torch.cuda.synchronize()
                            if isinstance(want, tuple):
                                err = max(rel_l2(a, b) for a, b in zip(got, want))
                            else:
                                err = rel_l2(got, want)
                            row["ms"].setdefault(variant, []).append(time_ms(torch, call, args.iters))
                            row["rel_l2"][variant] = err
                    finally:
                        bc._lib = real
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
