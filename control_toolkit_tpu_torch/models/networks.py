"""Network evaluators: MLP and stacked GRU/LSTM (counterpart of
control_toolkit_tpu/models/networks.py:1-241).

Networks are plain functions over explicit parameter dicts of tensors, so
a net's weights are data the optimizer step reads, never code it is built
from.  The parameter layout is the JAX package's: an MLP is ``w{i}`` [in,
out] and ``b{i}`` [out] (plus optional ``norm_in_*`` / ``norm_out_*``); a
recurrent net is ``cell{i}`` dicts of ``wi`` [in, G*Hd], ``wh`` [Hd, G*Hd],
``bi``, ``bh`` [G*Hd] and a head ``wo`` [Hd, out], ``bo`` [out], with the
gates in the order r, z, n (GRU) or i, f, g, o (LSTM).  An LSTM layer's
state is one tensor ``[..., 2*Hd]`` = concat(h, c).

``save_net`` / ``load_net`` write and read the JAX package's npz layout
(flat ``cell0/wi``-style keys, the meta dict as JSON bytes under
``__meta``), so a checkpoint written by either package loads in the other.

Architecture names follow the reference's scheme:
  "mlp-32-32"              2 hidden layers of 32, tanh
  "GRU-6IN-32H1-32H2-5OUT" GRU with 2 stacked cells (32, 32)

The initializers take a ``torch.Generator`` and keep the JAX package's
scales (and the LSTM forget-gate bias of 1.0); they do not reproduce its
draws, so tests that compare the packages pass JAX's weights across.
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _normal(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    return scale * torch.randn(shape, generator=generator, dtype=torch.float32)


# ---------------------------------------------------------------- MLP
def mlp_init(generator: torch.Generator, sizes: Sequence[int]) -> Dict:
    """Glorot-scaled MLP params for layer sizes [in, h1, ..., out]."""
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = _normal(generator, (fan_in, fan_out), math.sqrt(2.0 / (fan_in + fan_out)))
        params[f"b{i}"] = torch.zeros(fan_out)
    return params


def mlp_apply(params: Dict, x: torch.Tensor, activation=torch.tanh) -> torch.Tensor:
    n = sum(1 for k in params if k.startswith("w"))
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = activation(x)
    return x


# ---------------------------------------------------------------- GRU
def gru_cell_init(generator: torch.Generator, in_dim: int, hidden: int) -> Dict:
    return {
        "wi": _normal(generator, (in_dim, 3 * hidden), math.sqrt(1.0 / in_dim)),
        "wh": _normal(generator, (hidden, 3 * hidden), math.sqrt(1.0 / hidden)),
        "bi": torch.zeros(3 * hidden),
        "bh": torch.zeros(3 * hidden),
    }


def gru_cell_apply(p: Dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Standard GRU cell: x [..., I], h [..., H] -> h' [..., H]."""
    gi = x @ p["wi"] + p["bi"]
    gh = h @ p["wh"] + p["bh"]
    H = h.shape[-1]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def _stack_init(cell_init, generator, in_dim, hiddens, out_dim) -> Dict:
    params: Dict = {}
    d = in_dim
    for i, h in enumerate(hiddens):
        params[f"cell{i}"] = cell_init(generator, d, h)
        d = h
    params["wo"] = _normal(generator, (d, out_dim), math.sqrt(1.0 / d))
    params["bo"] = torch.zeros(out_dim)
    return params


def gru_init(generator: torch.Generator, in_dim: int, hiddens: Sequence[int],
             out_dim: int) -> Dict:
    return _stack_init(gru_cell_init, generator, in_dim, hiddens, out_dim)


def gru_apply(params: Dict, x: torch.Tensor, hs: Tuple[torch.Tensor, ...]):
    """One step through stacked GRU cells: x [..., I], hs per-layer
    [..., H_i] -> (output [..., O], new hs)."""
    new_hs = []
    inp = x
    for i in range(len(hs)):
        inp = gru_cell_apply(params[f"cell{i}"], inp, hs[i])
        new_hs.append(inp)
    return inp @ params["wo"] + params["bo"], tuple(new_hs)


def gru_init_state(hiddens: Sequence[int], batch: int, device=None) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.zeros(batch, h, device=device) for h in hiddens)


# ---------------------------------------------------------------- LSTM
def lstm_cell_init(generator: torch.Generator, in_dim: int, hidden: int) -> Dict:
    bi = torch.zeros(4 * hidden)
    bi[hidden:2 * hidden] = 1.0  # the standard forget-gate bias (gates i, f, g, o)
    return {
        "wi": _normal(generator, (in_dim, 4 * hidden), math.sqrt(1.0 / in_dim)),
        "wh": _normal(generator, (hidden, 4 * hidden), math.sqrt(1.0 / hidden)),
        "bi": bi,
        "bh": torch.zeros(4 * hidden),
    }


def lstm_cell_apply(p: Dict, x: torch.Tensor, hc: torch.Tensor):
    """x [..., I], hc [..., 2H] -> (h' [..., H], hc' [..., 2H])."""
    H = hc.shape[-1] // 2
    h, c = hc[..., :H], hc[..., H:]
    g = x @ p["wi"] + p["bi"] + h @ p["wh"] + p["bh"]
    i = torch.sigmoid(g[..., :H])
    f = torch.sigmoid(g[..., H:2 * H])
    gg = torch.tanh(g[..., 2 * H:3 * H])
    o = torch.sigmoid(g[..., 3 * H:])
    c_new = f * c + i * gg
    h_new = o * torch.tanh(c_new)
    return h_new, torch.cat([h_new, c_new], dim=-1)


def lstm_init(generator: torch.Generator, in_dim: int, hiddens: Sequence[int],
              out_dim: int) -> Dict:
    return _stack_init(lstm_cell_init, generator, in_dim, hiddens, out_dim)


def lstm_apply(params: Dict, x: torch.Tensor, hs: Tuple[torch.Tensor, ...]):
    """One step through stacked LSTM cells; hs entries are [..., 2H_i]."""
    new_hs = []
    inp = x
    for i in range(len(hs)):
        inp, hc_new = lstm_cell_apply(params[f"cell{i}"], inp, hs[i])
        new_hs.append(hc_new)
    return inp @ params["wo"] + params["bo"], tuple(new_hs)


def lstm_init_state(hiddens: Sequence[int], batch: int, device=None) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.zeros(batch, 2 * h, device=device) for h in hiddens)


RECURRENT_FNS = {
    # kind -> (param_init, apply, init_state)
    "gru": (gru_init, gru_apply, gru_init_state),
    "lstm": (lstm_init, lstm_apply, lstm_init_state),
}


# ------------------------------------------------ architecture strings
def parse_net_name(name: str) -> Dict:
    """Parse a reference-style network name into an architecture spec."""
    low = name.lower()
    if low.startswith("mlp"):
        hiddens = [int(x) for x in re.findall(r"-(\d+)", name)]
        return {"kind": "mlp", "hiddens": hiddens or [32, 32]}
    if low.startswith("gru") or low.startswith("lstm"):
        in_m = re.search(r"(\d+)in", low)
        out_m = re.search(r"(\d+)out", low)
        hiddens = [int(h) for h in re.findall(r"(\d+)h\d", low)]
        return {
            "kind": "lstm" if low.startswith("lstm") else "gru",
            "in_dim": int(in_m.group(1)) if in_m else None,
            "out_dim": int(out_m.group(1)) if out_m else None,
            "hiddens": hiddens or [32],
        }
    raise ValueError(f"Cannot parse network name {name!r}")


# ------------------------------------------------ checkpoint I/O
def _flatten_params(params: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten_params(v, prefix=f"{key}/"))
        else:
            flat[key] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return flat


def _unflatten_params(flat: Dict[str, torch.Tensor]) -> Dict:
    nested: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = nested
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return nested


def save_net(path, params: Dict, meta: Optional[Dict] = None) -> None:
    flat = _flatten_params(params)
    if meta:
        flat["__meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **flat)


def load_net(path, device=None) -> Tuple[Dict, Dict]:
    """(params as tensors on ``device``, meta dict)."""
    meta, flat = {}, {}
    with np.load(path) as data:
        for k in data.files:
            if k == "__meta":
                meta = json.loads(bytes(data[k]).decode("utf-8"))
            else:
                flat[k] = torch.as_tensor(data[k], device=device)
    return _unflatten_params(flat), meta
