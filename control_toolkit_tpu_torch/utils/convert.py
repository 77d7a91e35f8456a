"""Carry the JAX package's values across to the port.

Both functions take numpy arrays (or Python numbers), as a caller gets
them from the JAX package with ``np.asarray``, and build the port's
tensors on ``device``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(v, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32), device=device)


def params_from_numpy(params: Dict, device: torch.device) -> Dict:
    """The ``{"dyn", "cost", "attrs"}`` params tree of
    ``MPCController._assemble_params`` as float32 tensors."""
    return {
        part: {k: _tensor(v, device) for k, v in params[part].items()}
        for part in ("dyn", "cost", "attrs")
    }


def mppi_state_from_numpy(u_nom, u_prev, generator: torch.Generator):
    """An ``MPPIState`` from the JAX state's ``u_nom [1,H,U]`` and
    ``u_prev [U]``.  The PRNG key is not carried (the two packages'
    generators differ); the port's state takes ``generator`` instead, on
    the device the tensors go to."""
    from control_toolkit_tpu_torch.optimizers.mppi import MPPIState

    device = generator.device
    return MPPIState(generator=generator, u_nom=_tensor(u_nom, device),
                     u_prev=_tensor(u_prev, device))
