"""The comparison that decides ``correct``: the numbers a run reads against
the plain reference, each held to its limit from ``limits/<cell>.json``.

Training compares two stretches of the timed object, each run through the
window's own call (``drivers/train.py``): its first three steps, from the
seeded weights while the replay pool fills, and one chunk of replayed
steps (the captured CUDA graph, the pool full), from a copy of the state
before it. The reference follows the first from the same weights and
batches and the second from the copied state with the same pool picks.

- ``loss_gap``: the largest |program - reference| / |reference| of each
  of the first three steps' losses;
- ``grad_gap``: per leaf, the gap between the norm of the program's first
  gradient, as its Adam state holds it after one step, and the
  reference's, over the larger of the reference's norm of that leaf and of
  its network's median leaf; the median leaf of each network, the largest
  over the networks;
- ``change_gap``: the same of the parameters' change over the three
  steps;
- ``replay_loss_gap``, ``replay_change_gap``: the same of the checked
  chunk's steps' losses and of the parameters' change over the chunk;
- ``replay_first_loss_gap``: the largest loss gap of the chunk's first
  step alone, which both sides take from the same state: the later steps'
  gaps grow as the two sides' Adam steps part, and swing from seed to
  seed (``PERF.md``);
- ``kernel_grad_gap``, ``kernel_replay_change_gap``: the worst leaf of the
  first gradient and of the chunk's change over the leaves the
  reference's ``KERNEL_LEAVES`` names (the weights of the block core's
  matrix products and of the discriminators), so that a fault confined to
  a few leaves, such as a wrong weight gradient out of K2 / K4, shows.

The median and not the worst leaf over the rest: the worst is a leaf whose
gradient is mostly the rounding of sums that cancel (the MixConvNeXtML
local stream's biases and narrow weights in front of its channel gates and
InstanceNorms); in bfloat16 it reads up to thousands of times its
network's median, and it moves from seed to seed (``PERF.md``). Every gap
leaves out the leaves whose reference first gradient is under
``NULL_SHARE`` of their network's median leaf's (a bias in front of an
InstanceNorm has a gradient of nought, and Adam moves it by round-off
alone). Each gap's worst leaf, and each loss gap's step and loss, are kept
in the record (``where``).

Serving (a sample of the window's requests, drawn from the seed; the
reference serves the same inputs):

- ``pixel_gap``: the largest mean |program - reference| over the sample's
  images, in uint8 levels.
"""

import re
import statistics
import sys

import torch

NULL_SHARE = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _by_net(names):
    nets = {}
    for k in names:
        nets.setdefault(k.split(".", 1)[0], []).append(k)
    return nets


def leaf_gaps(prog, ref, keep):
    """{leaf: |‖prog‖ - ‖ref‖| / max(‖ref‖, its network's median ‖ref‖)}
    over the leaves in ``keep``."""
    pn, rn = _norms(prog), _norms(ref)
    gaps = {}
    for names in _by_net(rn).values():
        med = statistics.median(rn[k] for k in names)
        gaps.update({k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names if k in keep})
    return gaps


def moved_leaves(ref_grads):
    """The leaves whose reference gradient norm is at least ``NULL_SHARE``
    of their network's median leaf's."""
    rn = _norms(ref_grads)
    keep = set()
    for names in _by_net(rn).values():
        med = statistics.median(rn[k] for k in names)
        keep |= {k for k in names if rn[k] >= NULL_SHARE * med}
    return keep


def median_leaf(gaps):
    """The largest over the networks of each one's median leaf's gap."""
    return max(statistics.median(gaps[k] for k in names) for names in _by_net(gaps).values())


def step_loss_gaps(prog_losses, ref_losses):
    """Per step, {loss: |program - reference| / |reference|}."""
    return [{k: abs(p[k] - r[k]) / max(abs(r[k]), 1e-12) for k in r}
            for p, r in zip(prog_losses, ref_losses)]


def loss_gap(prog_losses, ref_losses):
    return max(g for step in step_loss_gaps(prog_losses, ref_losses) for g in step.values())


def worst_loss(prog_losses, ref_losses):
    """[step, loss, gap, program's value, reference's value] of the
    largest gap, for the record."""
    gaps = step_loss_gaps(prog_losses, ref_losses)
    i, k = max(((i, k) for i, step in enumerate(gaps) for k in step),
               key=lambda ik: gaps[ik[0]][ik[1]])
    return [i + 1, k, gaps[i][k], prog_losses[i][k], ref_losses[i][k]]


def _change(params, init):
    return {k: params[k] - init[k] for k in init}


def train_numbers(first, checked, ref, kernel_leaves):
    """``first``: the program's first three steps ({"losses": [per step
    {name: float}], "grads": {leaf: first gradient}, "params": {leaf: after
    the steps}}); ``checked``: its checked chunk ({"losses", "params",
    "state": the state it started from}); ``ref``: the reference's readings
    (``drivers/train.follow``); ``kernel_leaves``: a pattern of the leaf
    names the ``kernel_`` numbers take. Returns the numbers and, for the
    record, each gap's worst leaf, each loss gap's worst step and loss, the
    checked chunk's largest loss gap a step, and how many leaves were
    compared."""
    start, chunk = ref["start"], ref["chunk"]
    keep = moved_leaves(start["grads"])
    gaps = {
        "grad": leaf_gaps(first["grads"], start["grads"], keep),
        "change": leaf_gaps(_change(first["params"], ref["start_init"]),
                            _change(start["params"], ref["start_init"]), keep),
        "replay_change": leaf_gaps(_change(checked["params"], checked["state"]["params"]),
                                   _change(chunk["params"], ref["chunk_init"]), keep),
    }
    kernel = re.compile(kernel_leaves)
    numbers = {"loss_gap": loss_gap(first["losses"], start["losses"]),
               "replay_loss_gap": loss_gap(checked["losses"], chunk["losses"]),
               "replay_first_loss_gap": loss_gap(checked["losses"][:1], chunk["losses"][:1])}
    record = {"leaves_compared": len(keep), "leaves": len(start["grads"]),
              "loss_worst": worst_loss(first["losses"], start["losses"]),
              "replay_loss_worst": worst_loss(checked["losses"], chunk["losses"]),
              "replay_loss_steps": [max(step.values()) for step in
                                    step_loss_gaps(checked["losses"], chunk["losses"])]}
    for name, g in gaps.items():
        numbers[f"{name}_gap"] = median_leaf(g)
        record[f"{name}_worst_leaf"] = list(max(g.items(), key=lambda kv: kv[1]))
    for name in ("grad", "replay_change"):
        worst = max(((k, v) for k, v in gaps[name].items() if kernel.match(k)),
                    key=lambda kv: kv[1])
        numbers[f"kernel_{name}_gap"] = worst[1]
        record[f"kernel_{name}_worst_leaf"] = worst[0]
    return numbers, record


def pixel_gap(prog_u8, ref_u8):
    """The largest per-image mean |program - reference| in uint8 levels of
    two (B, H, W, C) batches."""
    d = (prog_u8.to(torch.int16) - ref_u8.to(torch.int16)).abs().float()
    return float(d.flatten(1).mean(1).max())


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}): every number that has a
    limit at most it; a limit with no number fails. A number with no
    limit is read but not compared (``PERF.md`` says why)."""
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in sorted(limits.items())}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def report(checks):
    """Each number beside its limit, as the last lines on stderr."""
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
