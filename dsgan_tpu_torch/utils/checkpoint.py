"""Full-state checkpoints (port of ``dsgan_tpu/utils/checkpoint.py``; the
reference's save_networks / load_networks, DSGAN/models/base_model.py:
92-148, with one path per epoch for both).

Layout: ``save_dir/epoch_{N}/state.pt``, one ``torch.save`` of a dict of
tensors and numbers (the model decides what it holds: parameters,
optimizer states, the replay pool and its generator, the step, the LR
schedule's position), so ``--continue_train`` resumes the trajectory
exactly. A save is synchronous and lands whole: it is written beside the
epoch directory and renamed into place. ``keep_latest`` prunes all but
the newest epochs (``--keep_ckpts``). The JAX package's Orbax checkpoints
are not read; generator weights cross over as a params ``.npz``
(``utils.convert.load_params_npz``).
"""

import os
import shutil

import torch

_FILE = "state.pt"


def _epoch_dir(save_dir, epoch):
    return os.path.abspath(os.path.join(save_dir, f"epoch_{epoch}"))


def save_state(save_dir, epoch, state):
    """Write ``state`` as the ``epoch`` checkpoint, replacing any there;
    returns its directory."""
    path = _epoch_dir(save_dir, epoch)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, _FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    return path


def wait_for_saves():
    """Saves are synchronous: nothing is ever in flight. Kept for the
    JAX package's interface."""


def restore_state(save_dir, epoch):
    """The ``epoch`` checkpoint's dict, its tensors on the CPU."""
    path = os.path.join(_epoch_dir(save_dir, epoch), _FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def _epochs(save_dir):
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in os.listdir(save_dir):
        if name.startswith("epoch_") and name[6:].isdigit():
            out.append(int(name[6:]))
    return sorted(out)


def keep_latest(save_dir, k, keep_none_ok=False):
    """Delete all but the k newest numbered epoch checkpoints. k <= 0 does
    nothing unless ``keep_none_ok``, where 0 deletes them all."""
    if k < 0 or (k == 0 and not keep_none_ok):
        return
    epochs = _epochs(save_dir)
    for e in epochs[:len(epochs) - k] if k > 0 else epochs:
        shutil.rmtree(_epoch_dir(save_dir, e), ignore_errors=True)


def latest_epoch(save_dir):
    """The highest epoch number in ``save_dir``, or None."""
    epochs = _epochs(save_dir)
    return epochs[-1] if epochs else None
