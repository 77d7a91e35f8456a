"""Carry the JAX package's values across to the port.

The functions take numpy arrays (or Python numbers), as a caller gets
them from the JAX package with ``np.asarray``, and build the port's
tensors on ``device``.  An optimizer state's PRNG key is not carried (the
two packages' generators differ): the port's state takes ``generator``
instead, on the device the tensors go to.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(v, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32), device=device)


def _tree(v, device: torch.device):
    """Dicts and tuples kept, every leaf a float32 tensor (a 0-d array or a
    number a 0-d tensor)."""
    if isinstance(v, dict):
        return {k: _tree(x, device) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return tuple(_tree(x, device) for x in v)
    return _tensor(v, device)


def params_from_numpy(params: Dict, device: torch.device) -> Dict:
    """The ``{"dyn", "cost", "attrs"}`` params tree of
    ``MPCController._assemble_params`` as float32 tensors, ``dyn`` of any
    nesting: an ODE's flat constants, a learned net's ``{"net"[,
    "hidden"]}``, a residual predictor's ``{"base", "res"}``, a GP's
    ``{"gp"}`` (its ``variance`` a 0-d tensor)."""
    return {part: _tree(params[part], device) for part in ("dyn", "cost", "attrs")}


def neural_params_from_numpy(net: Dict, hidden=None, device: torch.device = torch.device("cpu")):
    """A learned predictor's ``dyn`` params: the JAX net dict (``w{i}``,
    ``b{i}``, ``norm_*``, or nested ``cell{i}`` dicts with ``wo``/``bo``)
    and, for a recurrent net, its hidden tuple, as float32 tensors.
    Returns ``{"net": ...}`` or ``{"net": ..., "hidden": (...)}``."""
    dyn = {"net": _tree(net, device)}
    if hidden is not None:
        dyn["hidden"] = _tree(tuple(hidden), device)
    return dyn


def ensemble_params_from_numpy(net: Dict, device: torch.device = torch.device("cpu")) -> Dict:
    """An ensemble predictor's ``dyn`` params, ``{"net": ...}``, from the
    JAX package's stacked net (``w{i}`` [E, in, out], ``b{i}`` [E, out],
    optional ``norm_*`` [E, n]) as float32 tensors; raises unless every
    leaf has the same leading member axis."""
    members = {np.shape(v)[0] if np.ndim(v) else None for v in net.values()}
    if len(members) != 1 or None in members:
        raise ValueError(f"stacked ensemble leaves need one leading member axis, got "
                         f"{ {k: np.shape(v) for k, v in net.items()} }")
    return {"net": _tree(net, device)}


def value_params_from_numpy(net: Dict, device: torch.device = torch.device("cpu")) -> Dict:
    """A learned terminal value's net (``costs/value_terminal.py``): the
    JAX package's ``{w0, b0, ...}`` MLP dict (``mlp_init`` or
    ``fit_value_mlp``'s, ``w_i [in, out]``) as float32 tensors on
    ``device``."""
    return _tree(net, device)


def mppi_state_from_numpy(u_nom, u_prev, generator: torch.Generator):
    """An ``MPPIState`` from the JAX state's ``u_nom [1,H,U]`` and
    ``u_prev [U]``."""
    from control_toolkit_tpu_torch.optimizers.mppi import MPPIState

    device = generator.device
    return MPPIState(generator=generator, u_nom=_tensor(u_nom, device),
                     u_prev=_tensor(u_prev, device))


def mppi_slot_states_from_numpy(u_nom, u_prev, generators):
    """A batched-mpc fleet's stacked ``MPPIState`` from the JAX fleet's
    ``u_nom [B,1,H,U]`` and ``u_prev [B,U]``; ``generators`` holds the B
    slots' generators (or ``None`` each, where only ``update_from_eps``
    runs), the tensors go to ``device`` of the first one or the CPU."""
    from control_toolkit_tpu_torch.optimizers.mppi import MPPIState

    device = next((g.device for g in generators if g is not None), torch.device("cpu"))
    return MPPIState(generator=tuple(generators), u_nom=_tensor(u_nom, device),
                     u_prev=_tensor(u_prev, device))


def slot_hidden_from_numpy(hidden, device: torch.device):
    """A recurrent fleet's per-slot hidden (``slot_hidden``: one ``[B, 1,
    Hi]`` leaf a cell, the LSTM's ``Hi`` its [h, c]) from the JAX fleet's
    ``slot_hidden``."""
    return tuple(_tensor(h, device) for h in hidden)


def _adam(m, v, adam_step, device):
    from control_toolkit_tpu_torch.ops.common import AdamState

    return AdamState(step=int(adam_step), m=_tensor(m, device), v=_tensor(v, device))


def rpgd_state_from_numpy(Q, m, v, adam_step, ages, count, u_prev, generator: torch.Generator):
    """An ``RPGDState`` from the JAX state's population ``Q [K,H,U]``, Adam
    moments and step, ``trajectory_ages [K]``, tick ``count`` and
    ``u_prev [U]``."""
    from control_toolkit_tpu_torch.optimizers.rpgd import RPGDState

    device = generator.device
    return RPGDState(generator=generator, Q=_tensor(Q, device),
                     adam=_adam(m, v, adam_step, device),
                     trajectory_ages=_tensor(ages, device), count=int(count),
                     u_prev=_tensor(u_prev, device))


def gradient_state_from_numpy(Q, m, v, adam_step, count, u_prev, generator: torch.Generator):
    """A ``GradientState`` from the JAX state's population, Adam moments
    and step, tick ``count`` and ``u_prev``."""
    from control_toolkit_tpu_torch.optimizers.gradient import GradientState

    device = generator.device
    return GradientState(generator=generator, Q=_tensor(Q, device),
                         adam=_adam(m, v, adam_step, device), count=int(count),
                         u_prev=_tensor(u_prev, device))


def _slot_adam(m, v, adam_step, device):
    from control_toolkit_tpu_torch.ops.common import AdamState

    return AdamState(step=np.asarray(adam_step, np.int64).reshape(-1), m=_tensor(m, device),
                     v=_tensor(v, device))


def _slot_device(generators) -> torch.device:
    return next((g.device for g in generators if g is not None), torch.device("cpu"))


def rpgd_slot_states_from_numpy(Q, m, v, adam_step, ages, count, u_prev, generators):
    """A batched-mpc RPGD fleet's stacked ``RPGDState`` from the JAX fleet's
    ``Q [B,K,H,U]``, Adam moments and per-session steps ``[B]``,
    ``trajectory_ages [B,K]``, tick counts ``[B]`` and ``u_prev [B,U]``;
    ``generators`` holds the B slots' generators (or ``None`` each, where
    only ``update`` runs), the tensors go to the first one's device or the
    CPU."""
    from control_toolkit_tpu_torch.optimizers.rpgd import RPGDState

    device = _slot_device(generators)
    return RPGDState(generator=tuple(generators), Q=_tensor(Q, device),
                     adam=_slot_adam(m, v, adam_step, device),
                     trajectory_ages=_tensor(ages, device),
                     count=np.asarray(count, np.int64).reshape(-1),
                     u_prev=_tensor(u_prev, device))


def gradient_slot_states_from_numpy(Q, m, v, adam_step, count, u_prev, generators):
    """A batched-mpc gradient-tf fleet's stacked ``GradientState`` from the
    JAX fleet's population ``[B,K,H,U]``, Adam moments and per-session
    steps, tick counts ``[B]`` and ``u_prev [B,U]``; ``generators`` as
    ``rpgd_slot_states_from_numpy``'s."""
    from control_toolkit_tpu_torch.optimizers.gradient import GradientState

    device = _slot_device(generators)
    return GradientState(generator=tuple(generators), Q=_tensor(Q, device),
                         adam=_slot_adam(m, v, adam_step, device),
                         count=np.asarray(count, np.int64).reshape(-1),
                         u_prev=_tensor(u_prev, device))

