"""Seed handling (counterpart of control_toolkit_tpu/utils/rng.py).

``derive_seed`` keeps the reference policy (seed ``None`` => a seed derived
from the current datetime).  ``make_key`` becomes ``make_generator``: an
explicit, seeded ``torch.Generator`` on the device that draws the noise.
torch's generators and ``jax.random`` give different numbers from the same
seed, so parity tests feed both packages the same draws.
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
