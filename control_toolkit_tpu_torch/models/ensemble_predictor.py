"""Probabilistic-ensemble dynamics predictor with trajectory sampling (PETS)
(counterpart of control_toolkit_tpu/models/ensemble_predictor.py).

An ensemble of E delta-dynamics MLPs whose parameter leaves carry a leading
member axis (``w{i}`` [E, in, out], ``b{i}`` [E, out], optional
``norm_*`` [E, n]), the layout ``fit_ensemble_mlp_dynamics`` writes.
Evaluating the members is one batched matmul over that axis.
Trajectory-sampling modes:

- ``ts="inf"`` (default, PETS TS-infinity): with K divisible by E the
  population splits into E contiguous blocks of K/E rollouts and block e
  runs member e for the whole horizon.  This is the function that the
  member-block forms of K11 and K8 compute on the card
  (``kernel_families/ensemble.py``).
- ``ts="1"`` (PETS TS-1): each rollout re-draws its member every step from
  a counter hash of (rollout, step); every member evaluates the whole
  batch.

Batches that do not split over the members (the batch-1 replay, an odd
batch) take the ensemble-mean dynamics.  ``probabilistic`` members output a
Gaussian head (mean and a soft-bounded log-variance) and rollouts add
``std * eps`` with ``eps`` from ``counter_normal``; their ``single_step`` is
None, as is a TS-1 predictor's, so that every cost path takes the full
``rollout``.

The hashes are uint32 arithmetic in the JAX package; here they ride in
int64 masked to 32 bits (``ops/counter_prng.py:mul32``), so a member index
or a counter equals the JAX package's bit for bit.  The weights are tensors
on the predictor's ``device``, read by the optimizer step from
``params["dyn"]["net"]``: a re-fit or a checkpoint swap rebuilds nothing.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from control_toolkit_tpu_torch.models import networks as nets
from control_toolkit_tpu_torch.models.dynamics import DYNAMICS
from control_toolkit_tpu_torch.models.predictors import Predictor
from control_toolkit_tpu_torch.ops.counter_prng import MASK, mul32
from control_toolkit_tpu_torch.ops.neural_rollout import member_blocks
from control_toolkit_tpu_torch.utils import registry
from control_toolkit_tpu_torch.utils.device import place, resolve_device

logger = logging.getLogger(__name__)

# Knuth multiplicative and golden-ratio constants of the TS-1 member hash.
_HASH_K = 2654435761
_HASH_T = 0x9E3779B9
_HASH_D = 0x85EBCA6B
_HASH_S = 0xC2B2AE35


def bound_logvar(raw: torch.Tensor, lo: float = -8.0, hi: float = 2.0) -> torch.Tensor:
    """Soft-bound a raw log-variance head to [lo, hi] (softplus squashing)."""
    lv = hi - F.softplus(hi - raw)
    return lo + F.softplus(lv - lo)


def _mul32_int(x: int, c: int) -> int:
    """``x * c mod 2^32`` of a Python int, as uint32."""
    return ((int(x) & MASK) * c) & MASK


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = mul32(h, _HASH_D)
    h = h ^ (h >> 13)
    h = mul32(h, _HASH_S)
    return h ^ (h >> 16)


def counter_normal(rows: torch.Tensor, t: int, dims: int, seed: int) -> torch.Tensor:
    """Standard normals from a counter hash, one per (row, t, dim): rows
    ``[B]`` (global rollout indices), step ``t``, ``dims`` draws a row ->
    ``[B, dims]`` float32.  Box-Muller on two 24-bit uniforms."""
    r = (rows.to(torch.int64) & MASK)[:, None]
    d = torch.arange(dims, dtype=torch.int64, device=rows.device)[None, :]
    base = mul32(r, _HASH_K) ^ _mul32_int(t, _HASH_T) ^ mul32(d, _HASH_D) ^ (int(seed) & MASK)
    h1 = _mix32(base)
    h2 = _mix32(base ^ 0x6A09E667)
    u1 = (h1 >> 8).to(torch.float32) * (2.0 ** -24) + 2.0 ** -25
    u2 = (h2 >> 8).to(torch.float32) * (2.0 ** -24)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * torch.pi * u2)


def ts1_members(K: int, t: int, n_members: int, device=None) -> torch.Tensor:
    """The member each of K rollouts runs at step ``t`` under TS-1: ``[K]``
    int64 in [0, E)."""
    k = torch.arange(K, dtype=torch.int64, device=device)
    return _mix32(mul32(k, _HASH_K) ^ _mul32_int(t, _HASH_T)) % n_members


def ensemble_checkpoint_name(net_name: str, n_members: int) -> str:
    return f"ensemble-{net_name}-x{n_members}.npz"


@registry.predictors.register("ensemble")
class EnsemblePredictor(Predictor):
    """Ensemble of delta-dynamics MLPs with trajectory sampling."""

    def __init__(
        self,
        environment_name: str = "cartpole",
        dt: float = 0.02,
        net_name: str = "mlp-32-32",
        n_members: int = 5,
        num_states: Optional[int] = None,
        num_control_inputs: Optional[int] = None,
        path_to_models: Optional[str] = None,
        predict_delta: bool = True,
        seed: int = 0,
        params: Optional[Dict] = None,
        ts: str = "inf",
        probabilistic: bool = False,
        noise_seed: int = 0,
        device: Optional[torch.device] = None,
        **kwargs,
    ):
        self.environment_name = environment_name.lower()
        if num_states is None or num_control_inputs is None:
            _, _, num_states, num_control_inputs = DYNAMICS[self.environment_name]
        self.num_states = int(num_states)
        self.num_control_inputs = int(num_control_inputs)
        self.dt = float(dt)
        self.net_name = net_name
        self.n_members = int(n_members)
        if self.n_members < 1:
            raise ValueError(f"n_members must be >= 1, got {n_members}")
        self.predict_delta = bool(predict_delta)
        if ts not in ("inf", "1"):
            raise ValueError(f"ts must be 'inf' or '1', got {ts!r}")
        self.ts = ts
        self.probabilistic = bool(probabilistic)
        self.noise_seed = int(noise_seed)
        self.device = resolve_device(device)
        self.arch = nets.parse_net_name(net_name)
        if self.arch["kind"] != "mlp":
            raise ValueError(
                "EnsemblePredictor supports MLP members only (recurrent ensembles would "
                f"need per-member hidden threading); got {net_name!r}"
            )

        in_dim = self.num_states + self.num_control_inputs
        out_dim = 2 * self.num_states if self.probabilistic else self.num_states
        sizes = [in_dim] + list(self.arch["hiddens"]) + [out_dim]
        if params is not None:
            self.net_params = place(params, self.device)
            self._validate_member_axis()
            return
        ckpt = Path(path_to_models or ".") / ensemble_checkpoint_name(net_name, self.n_members)
        if ckpt.is_file():
            net, meta = nets.load_net(ckpt)
            self.net_params = place(net, self.device)
            self.predict_delta = bool(meta.get("predict_delta", predict_delta))
            if bool(meta.get("probabilistic", self.probabilistic)) != self.probabilistic:
                raise ValueError(
                    f"checkpoint {ckpt} probabilistic={meta.get('probabilistic')} but "
                    f"predictor configured probabilistic={self.probabilistic} (add/remove "
                    "the ':prob' spec token)"
                )
            if int(meta.get("n_members", self.n_members)) != self.n_members:
                raise ValueError(f"checkpoint {ckpt} holds {meta.get('n_members')} members, "
                                 f"predictor configured for {self.n_members}")
            self._validate_member_axis()
            logger.info(f"loaded ensemble {net_name} x{self.n_members} from {ckpt}")
        else:
            generator = torch.Generator().manual_seed(int(seed))
            members = [nets.mlp_init(generator, sizes) for _ in range(self.n_members)]
            self.net_params = place({k: torch.stack([m[k] for m in members])
                                     for k in members[0]}, self.device)
            logger.warning(f"no checkpoint for ensemble {net_name} x{self.n_members}; "
                           "random init")

    def _validate_member_axis(self) -> None:
        for k, v in self.net_params.items():
            if v.ndim < 1 or v.shape[0] != self.n_members:
                raise ValueError(f"ensemble param leaf {k!r} has shape {tuple(v.shape)}; "
                                 f"expected leading member axis of size {self.n_members}")

    def default_params(self) -> Dict:
        return {"net": self.net_params}

    def copy(self) -> "EnsemblePredictor":
        return EnsemblePredictor(
            environment_name=self.environment_name, dt=self.dt, net_name=self.net_name,
            n_members=self.n_members, num_states=self.num_states,
            num_control_inputs=self.num_control_inputs, predict_delta=self.predict_delta,
            params=self.net_params, ts=self.ts, probabilistic=self.probabilistic,
            noise_seed=self.noise_seed, device=self.device,
        )

    # ---- member-local transitions over a member axis --------------------------
    def _member_heads(self, net: Dict, x: torch.Tensor, u: torch.Tensor):
        """Raw heads ``(mean, std)`` in target space (delta or absolute) of
        ``x [E, B, S]``, ``u [E, B, U]``, row e under member e of the
        stacked ``net``; std is None for deterministic members."""
        S = self.num_states
        net = member_blocks(net)
        inp = torch.cat([x, u], dim=-1)
        if "norm_in_mean" in net:
            inp = (inp - net["norm_in_mean"]) / net["norm_in_std"]
        out = nets.mlp_apply({k: v for k, v in net.items() if not k.startswith("norm_")}, inp)
        if not self.probabilistic:
            if "norm_out_mean" in net:
                out = out * net["norm_out_std"] + net["norm_out_mean"]
            return out, None
        mean, raw_lv = out[..., :S], out[..., S:]
        std = torch.exp(0.5 * bound_logvar(raw_lv))
        if "norm_out_mean" in net:
            mean = mean * net["norm_out_std"] + net["norm_out_mean"]
            std = std * net["norm_out_std"]
        return mean, std

    def _member_step(self, net: Dict, x, u, eps=None) -> torch.Tensor:
        """One transition of ``x [E, B, S]`` under each row's member: the
        mean, plus ``std * eps`` where ``eps`` is given (probabilistic)."""
        mean, std = self._member_heads(net, x, u)
        out = mean if eps is None else mean + std * eps
        return x + out if self.predict_delta else out

    def _all_members(self, net: Dict, x, u, eps=None) -> torch.Tensor:
        """Every member's transition of the same ``x [B, S]``: ``[E, B, S]``."""
        E = self.n_members
        return self._member_step(net, x.expand(E, *x.shape), u.expand(E, *u.shape),
                                 None if eps is None else eps.expand(E, *eps.shape))

    def _blocks(self, net: Dict, x, u, eps=None) -> torch.Tensor:
        """Block e of B/E rows of ``x [B, S]`` under member e: ``[B, S]``."""
        E, B = self.n_members, x.shape[0]
        xn = self._member_step(net, x.reshape(E, B // E, -1), u.reshape(E, B // E, -1),
                               None if eps is None else eps.reshape(E, B // E, -1))
        return xn.reshape(B, -1)

    # ---- Predictor protocol --------------------------------------------------
    @property
    def single_step(self):
        """``(x, u, params) -> x_next`` for the fused cost paths: blockwise
        TS-inf for batches that split over the members, the ensemble mean
        otherwise; None for probabilistic and TS-1 predictors (a step has no
        (rollout, step) counter for their draws)."""
        if self.probabilistic or self.ts == "1":
            return None
        return self._mean_step

    def _mean_step(self, x, u, p):
        net, E, B = p["net"], self.n_members, x.shape[0]
        if E == 1 or (B % E == 0 and B > 1):
            return self._blocks(net, x, u)
        return self._all_members(net, x, u).mean(dim=0)

    def rollout(self, s0, Q, params=None):
        p = self.default_params() if params is None else params
        net = p["net"]
        K, S = s0.shape
        E = self.n_members
        rows = torch.arange(K, device=s0.device)

        def eps(t):
            return counter_normal(rows, t, S, self.noise_seed) if self.probabilistic else None

        if self.ts == "1" and K > 1 and E > 1:
            def step(x, u, t):
                xn_all = self._all_members(net, x, u, eps(t))              # [E, K, S]
                return xn_all[ts1_members(K, t, E, s0.device), rows]
        elif K % E == 0 and (K > 1 or E == 1):
            def step(x, u, t):
                return self._blocks(net, x, u, eps(t))
        else:
            # The ensemble mean, noise-free even for probabilistic members.
            def step(x, u, t):
                return self._mean_step(x, u, p)

        x, xs = s0, [s0]
        for t in range(Q.shape[1]):
            x = step(x, Q[:, t, :], t)
            xs.append(x)
        return torch.stack(xs, dim=1)

    # ---- diagnostics ----------------------------------------------------------
    def rollout_all_members(self, s0, Q, params=None) -> torch.Tensor:
        """Every member rolls the same batch: ``[E, K, H+1, S]``."""
        p = self.default_params() if params is None else params
        E = self.n_members
        x = s0.expand(E, *s0.shape)
        xs = [x]
        for t in range(Q.shape[1]):
            x = self._member_step(p["net"], x, Q[:, t, :].expand(E, *Q[:, t, :].shape))
            xs.append(x)
        return torch.stack(xs, dim=2)

    def disagreement(self, s0, Q, params=None) -> torch.Tensor:
        """Per-rollout epistemic uncertainty: the mean over horizon and
        states of the cross-member (population) std of the trajectory ->
        ``[K]``."""
        trajs = self.rollout_all_members(s0, Q, params)
        return torch.std(trajs, dim=0, correction=0).mean(dim=(1, 2))
