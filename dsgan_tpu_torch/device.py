"""The port's one default-device rule.

Entry points take ``device=None``, which means the CUDA card. Without a
card they raise and name the way out (``device="cpu"``); they never fall
back to the CPU quietly, so a number measured through them is always a
number from the device the caller asked for.
"""

import subprocess

import torch


def card_info():
    """``name, power.limit`` of the first card as nvidia-smi prints it, or
    None where nvidia-smi is absent: a card set below its full power
    limit runs slower under load, so every timing carries this line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def resolve_device(device=None):
    """``None`` -> ``cuda``; raise if CUDA is asked for and not present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (on the train and "
            "eval command lines: --platform cpu) to run the plain PyTorch path "
            "on the CPU"
        )
    return dev


def platform_device(platform=""):
    """The CLIs' ``--platform``: empty, ``gpu`` or ``cuda`` is the card
    (``resolve_device`` raises without one), ``cpu`` the CPU."""
    name = (platform or "").lower()
    if name in ("", "gpu", "cuda"):
        return resolve_device(None)
    if name == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"--platform {platform!r}: the port runs on 'gpu' (or 'cuda') or 'cpu'")
