"""Seed handling (counterpart of control_toolkit_tpu/utils/rng.py).

``derive_seed`` keeps the reference policy (seed ``None`` => a seed derived
from the current datetime).  ``make_key`` becomes ``make_generator``: an
explicit, seeded ``torch.Generator`` on the device that draws the noise.
torch's generators and ``jax.random`` give different numbers from the same
seed, so parity tests feed both packages the same draws.  ``slot_seed``
is ``fold_in``'s counterpart: the seed of a batched controller's slot.
"""
from __future__ import annotations

import logging
from datetime import datetime
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def derive_seed(seed: Optional[int], context: str = "") -> int:
    if seed is not None:
        return int(seed)
    now = datetime.now()
    derived = int((now.timestamp() * 1e6) % (2**31 - 1))
    logger.info(f"{context}: seed=None, derived seed {derived} from datetime")
    return derived


def make_generator(seed: Optional[int], device: torch.device,
                   context: str = "") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``derive_seed(seed)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, context))
    return gen


_MASK64 = (1 << 64) - 1


def slot_seed(seed: int, slot: int) -> int:
    """The seed of slot ``slot`` under the optimizer seed ``seed`` (the
    counterpart of ``jax.random.fold_in(key, slot)``): the splitmix64
    finalizer of both, so each slot's stream is a fixed function of the
    two and neighbouring slots' streams are unrelated."""
    z = ((int(seed) << 32) + int(slot) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1
