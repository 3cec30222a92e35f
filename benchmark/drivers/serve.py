"""Serving traffic: a closed loop of one client sending uint8 batches to the
generator's serving function (``serve.serving_fn``) and waiting for each
uint8 result on the host, as ``serve.serve_requests`` times it.

Set-up builds the serving generator (``models.define_G``'s serving build,
from the configuration's options), loads into it the seeded weights of the
network its reference (``reference/<reference>.py``) names ``SERVED``,
makes ``distinct_batches`` seeded uint8 requests and sends
``warmup_requests`` of them. The window sends requests,
cycling through the batches, until ``--seconds`` have passed; each is timed
from its host batch to its host result, with a sync before it. A sample of
the window's requests, every ``sample_every``-th from an offset drawn from
the seed, keeps its result; once the window has closed and the program is
freed, the reference serves the same inputs and the check compares.
"""

import random
import statistics
import time

import torch

from benchmark import common, correct
from benchmark.reference import steps


def _served(cell, device):
    """The reference's served network on ``device`` (uninitialised) and its
    seeded weights' key."""
    ref = common.reference_module(cell)
    return ref.build_nets(cell.config["options"], device)[ref.SERVED], ref.SERVED


class Program:
    def __init__(self, cell, seed, device):
        from dsgan_tpu_torch.models import define_G
        from dsgan_tpu_torch.serve import serving_fn

        opts, tr = cell.config["options"], cell.traffic
        self.batch = tr["batch"]
        dtype = getattr(torch, opts["dtype"])
        self.netG = define_G(opts.get("input_nc", 3), opts.get("output_nc", 3), opts["ngf"],
                             opts["which_model_netG"], norm=opts.get("norm", "instance"),
                             dtype=dtype, device=device, seed=int(seed) % (2 ** 31))
        shape, key = _served(cell, "meta")
        self.netG.load_state_dict(common.seeded_weights({key: shape}, seed, device)[key])
        self.fn = serving_fn(self.netG)
        self.requests = common.seeded_images(tr["distinct_batches"], self.batch,
                                             opts["fineSize_h"], opts["fineSize_w"], seed, 1,
                                             device)
        self.device = device

    def request(self, i):
        """Request ``i``: (its result on the host, its latency s, the host
        time from the call to the return of the serving function)."""
        host = self.requests[i % len(self.requests)]
        common.sync(self.device)
        t0 = time.perf_counter()
        x = torch.from_numpy(host).to(self.device)
        t1 = time.perf_counter()
        y = self.fn(x)
        t2 = time.perf_counter()
        out = y.cpu()
        return out, time.perf_counter() - t0, t2 - t1


def p95(values):
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def run(cell, seed, seconds, trace, device, clock0):
    tr = cell.traffic
    prog = Program(cell, seed, device)
    common.reset_peak(device)
    for i in range(tr["warmup_requests"]):
        prog.request(i)
    common.sync(device)

    every = tr["sample_every"]
    offset = random.Random(int(seed)).randrange(every)
    kept, lat, enqueue, i = {}, [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        out, total, call = prog.request(i)
        lat.append(total)
        enqueue.append(call)
        if i % every == offset:
            kept[i] = out
        i += 1
    window_s = time.perf_counter() - t0
    setup_s = t0 - clock0

    traced = None
    if trace:
        _, traced = common.traced(
            lambda: [prog.request(i + j) for j in range(tr["trace_requests"])], device)
    info = common.device_info(device)
    requests, batch = prog.requests, prog.batch
    del prog
    common.free(device)
    numbers = {"pixel_gap": pixel_gap(cell, seed, device, requests, kept)}
    flops, sites = count(cell, batch)
    return dict(
        kind="serve", attempted=i, failed=0, info=info, numbers=numbers,
        where={"compared_requests": len(kept)},
        end_to_end={"serve_img_per_s": i * batch / window_s, "serve_p95_ms": p95(lat) * 1e3,
                    "peak_mem_gib": info["memory_peak_bytes"] / 2 ** 30, "setup_s": setup_s},
        units=i, window_s=window_s, dispatch_s=enqueue, dispatch_units=1,
        trace=traced, traced_units=tr["trace_requests"], flops_per_unit=flops, fwd_sites=sites,
        bwd_sites=[], dtype=cell.config["options"]["dtype"])


def reference_outputs(cell, seed, device, requests, ids, precision=None):
    """{request id: the reference's uint8 result} from the seeded weights."""
    from benchmark.reference.nets import set_precision

    common.plain_precision()
    net, key = _served(cell, device)
    shape, _ = _served(cell, "meta")
    net.load_state_dict(common.seeded_weights({key: shape}, seed, device)[key])
    net.eval()
    if precision is not None:
        set_precision(net, precision)
    out = {i: steps.serve(net, torch.from_numpy(requests[i % len(requests)]).to(device)).cpu()
           for i in ids}
    del net
    common.free(device)
    return out


def pixel_gap(cell, seed, device, requests, kept):
    if not kept:
        return None
    ref = reference_outputs(cell, seed, device, requests, sorted(kept))
    return max(correct.pixel_gap(kept[i], ref[i]) for i in kept)


def count(cell, batch):
    """Model FLOPs of one request and its block-core calls."""
    from benchmark import roofline

    opts = cell.config["options"]
    net, _ = _served(cell, "meta")
    return roofline.count_step(
        lambda: net(torch.empty(batch, 3, opts["fineSize_h"], opts["fineSize_w"],
                                device="meta")))
