"""Optimizer, controller and fleet checkpoints (counterpart of
control_toolkit_tpu/utils/checkpoint.py).

A state (nested dicts, tuples, lists and NamedTuple records of tensors,
numpy arrays, numbers and ``torch.Generator``s) is flattened to an ``.npz``
in the JAX package's file format: ``leaf_{i}`` in depth-first order,
``__n_leaves`` and ``__paths`` (the leaves' paths as JAX's ``keystr``
writes them, ``['key']``, ``[i]``, ``.field``).  A generator is saved as
its ``get_state()`` bytes and restored with ``set_state`` on its device, so
a resumed controller or fleet steps exactly as the uninterrupted one would.
A checkpoint whose structure differs from the template's is refused.  A
JAX checkpoint does not load here (its random streams are PRNG keys where
the port's are generators), nor a port's there.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np
import torch


def _is_record(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr path, leaf)]`` depth first; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in tree for pl in _flatten(tree[k], f"{path}[{k!r}]")]
    if _is_record(tree):
        return [pl for f, v in zip(tree._fields, tree) for pl in _flatten(v, f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree) for pl in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _as_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _restore(arr: np.ndarray, template):
    """``arr`` as a leaf of ``template``'s kind, dtype and device."""
    if isinstance(template, torch.Generator):
        gen = torch.Generator(device=template.device)
        gen.set_state(torch.from_numpy(np.ascontiguousarray(arr)))
        return gen
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=template.device)
    if isinstance(template, np.ndarray):
        return np.array(arr)
    if isinstance(template, (bool, int, float, np.generic)):
        return type(template)(arr.item())
    return arr


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves) for k, v in template.items()}
    if _is_record(template):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def save_state(path, state: Any) -> None:
    """Save a state tree to an ``.npz`` file, with the leaf count and the
    leaves' paths, so that a checkpoint of a different structure (another
    optimizer whose leading leaves share shapes) is refused on load."""
    flat = _flatten(state)
    payload = {f"leaf_{i}": _as_array(leaf) for i, (_, leaf) in enumerate(flat)}
    payload["__n_leaves"] = np.asarray(len(flat), np.int64)
    payload["__paths"] = np.frombuffer(json.dumps([p for p, _ in flat]).encode("utf-8"), np.uint8)
    np.savez(path, **payload)


def load_state(path, template: Any) -> Any:
    """Load a tree saved by ``save_state``, shaped like ``template`` (its
    leaves' kinds, dtypes and devices)."""
    # np.savez appends '.npz' to a path without it, np.load does not.
    if not os.path.exists(path) and not str(path).endswith(".npz"):
        path = f"{path}.npz"
    data = np.load(path)
    flat = _flatten(template)
    n_saved = int(data["__n_leaves"])
    if n_saved != len(flat):
        raise ValueError(f"checkpoint has {n_saved} leaves but template has {len(flat)}: "
                         "refusing to load a structurally different state")
    saved_paths = json.loads(bytes(data["__paths"]).decode("utf-8"))
    tmpl_paths = [p for p, _ in flat]
    if saved_paths != tmpl_paths:
        raise ValueError("checkpoint structure does not match the template:\n"
                         f"  saved:    {saved_paths}\n  template: {tmpl_paths}")
    leaves = []
    for i, (_, t_leaf) in enumerate(flat):
        arr, t_arr = data[f"leaf_{i}"], _as_array(t_leaf)
        if arr.shape != t_arr.shape:
            raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != template {t_arr.shape}")
        # Kind-compatible casts only: i<->u, else the same kind.
        k_saved, k_tmpl = arr.dtype.kind, t_arr.dtype.kind
        if not (k_saved == k_tmpl or {k_saved, k_tmpl} <= {"i", "u"}):
            raise ValueError(f"checkpoint leaf {i} dtype {arr.dtype} is not compatible with "
                             f"template dtype {t_arr.dtype}")
        leaves.append(_restore(arr.astype(t_arr.dtype), t_leaf))
    return _unflatten(template, iter(leaves))


def save_optimizer(path, optimizer) -> None:
    """Checkpoint an optimizer's warm-start state (plans, distribution
    moments, Adam moments, generator, counters, u_prev)."""
    if optimizer.opt_state is None:
        raise RuntimeError("optimizer not configured; call configure() first")
    save_state(path, optimizer.opt_state)


def load_optimizer(path, optimizer) -> None:
    if optimizer.opt_state is None:
        raise RuntimeError("optimizer not configured; call configure() first")
    optimizer.opt_state = load_state(path, optimizer.opt_state)


def _fleet_payload(controller):
    if getattr(controller, "slot_states", None) is None:
        raise RuntimeError("controller not configured; call configure() first")
    return {
        "slot_states": controller.slot_states,
        "slot_hidden": tuple(getattr(controller, "slot_hidden", ()) or ()),
        "slot_attrs": dict(controller.slot_attrs),
        "slot_dyn": dict(controller.slot_dyn),
    }


def save_fleet(path, controller) -> None:
    """Checkpoint a ``batched-mpc`` controller's whole fleet: every slot's
    warm-start state, a recurrent model's per-slot hidden, the per-slot
    attributes and dynamics constants, so that a stopped server resumes
    with every session's warm start intact."""
    save_state(path, _fleet_payload(controller))


def load_fleet(path, controller) -> None:
    """Restore a ``save_fleet`` checkpoint into an identically configured
    ``batched-mpc`` controller (optimizer, predictor, ``num_slots``,
    ``per_slot_dyn``)."""
    payload = load_state(path, _fleet_payload(controller))
    controller.slot_states = payload["slot_states"]
    if payload["slot_hidden"]:
        controller.slot_hidden = tuple(payload["slot_hidden"])
    # Host [B] rows that update_slot_* write in place: writable copies.
    controller.slot_attrs = {k: np.array(v) for k, v in payload["slot_attrs"].items()}
    controller.slot_dyn = {k: np.array(v) for k, v in payload["slot_dyn"].items()}


def save_controller(path, controller) -> None:
    """Checkpoint an ``mpc`` controller: the optimizer's state and the
    environment attributes."""
    save_state(path, {"opt_state": controller.optimizer.opt_state,
                      "attrs": dict(controller.variable_parameters)})


def load_controller(path, controller) -> None:
    if getattr(controller.optimizer, "opt_state", None) is None:
        raise RuntimeError("controller not configured; call configure() first")
    template = {"opt_state": controller.optimizer.opt_state,
                "attrs": dict(controller.variable_parameters)}
    payload = load_state(path, template)
    controller.optimizer.opt_state = payload["opt_state"]
    controller.update_attributes(payload["attrs"])
