"""Device selection (counterpart of control_toolkit_tpu/utils/device.py).

The controller config's ``device`` key picks the ``torch.device`` every
tensor of a controller lives on.  Without one a controller runs on the
card, as the JAX package's runs on its process's default backend (the TPU
on a TPU host); a caller that wants the CPU says ``"device": "cpu"``.
Unlike the JAX package, an unavailable device is an error, never a silent
fall back to the CPU: a controller asked to run on the card must not
quietly run somewhere else.
"""
from __future__ import annotations

import torch


def resolve_device(spec) -> torch.device:
    """Resolve a config ``device`` value to a ``torch.device``.

    ``None``, ``""`` and ``"default"`` give the card, ``cuda:0``, as the
    JAX package's ``None`` gives the process's default backend.  ``"gpu"``
    is accepted as a name for ``"cuda"``.  Raises ``ValueError`` on a
    malformed spec and ``RuntimeError`` when a CUDA device is asked for,
    by name or by default, that this process does not have.
    """
    s = "cuda:0" if spec in (None, "", "default") else str(spec).strip().lower()
    if s == "gpu" or s.startswith("gpu:"):
        s = "cuda" + s[3:]
    try:
        dev = torch.device(s)
    except RuntimeError as e:
        raise ValueError(f"malformed device spec {spec!r}") from e
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {spec!r} requested but CUDA is not available")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {spec!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {spec!r} (cpu | cuda[:i])")
    return dev


def place(tree, device: torch.device):
    """``tree`` (dicts, tuples and lists of numbers, arrays or tensors) with
    every leaf a float32 tensor on ``device``.  A leaf that already is one
    is returned as it is, not copied."""
    if isinstance(tree, dict):
        return {k: place(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(place(v, device) for v in tree)
    return torch.as_tensor(tree, dtype=torch.float32, device=device)
