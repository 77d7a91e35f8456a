"""K14: rollout + trajectory cost under sparse-GP dynamics — the
counterpart of control_toolkit_tpu/ops/pallas_neural.py:
build_gp_cost_rollout_kernel (with ``flatten_gp_weights``).

``gp_cost_rollout(model, s0 [K,S], Q [K,H,U], pvec [N], ops) -> cost
[K]`` with the semantics of K11 (ops/neural_rollout.py): the stage cost of
(x_h, u_h, u_{h-1}) accrues before the step, the terminal cost is taken at
x_H, the sum is divided by H+1; ``pvec`` holds the cost's part of the
packed layout only.  The step is models/gp_predictor.py's
``GPPredictor.single_step`` over the precomputed operands ``ops``
(``flatten_gp_weights``), as the Pallas kernel computes it:

    an = ([x, u] - in_mean) * inv_in                   (D = S + U)
    d2_m = max(|an|^2 - 2 Zs_m . an + zn2_m, 0)        (m < M)
    k_m = var * exp(-0.5 d2_m)
    x' = x + (sum_m alphaT[:, m] k_m) * out_std + out_mean

``flatten_gp_weights`` folds the input normalization and the lengthscales
into one affine transform (``Zs = Z / ls``, ``inv_in = 1 / (in_std *
ls)``); a re-fit is a new set of tensors, never a rebuild.

Its session-row (``slot_keys``) form ``gp_cost_rollout_cols`` (the
batched-mpc fleet's) scores B sessions' rollouts in one launch of the same
kernel, every lane of rollout b*K + k reading row b of ``pvec_b [B,N]``;
the GP's operands are shared.

Its ``emit_terminal`` form (pallas_neural.py:657), ``gp_cost_rollout_emit``
and its session-row form ``gp_cost_rollout_cols_emit``, also returns the
terminal states ``x_H`` in the costs' rollout order (``[K, S]``; ``[B, K,
S]``), on which a learned value terminal is evaluated outside the kernel;
its costs are K14's, the same body.

The CUDA kernel is ``csrc/gp_rollout.cu``, each rollout's step split
over the lanes of a warp as K10's is (``gp_cost_rollout_lanes`` picks
their number; its source note says what bounds it on the card);
``gp_cost_rollout_plain`` is the same function in PyTorch, the first
output of the emit form's plain version.  A wrapper runs its plain version
only when every operand lies on the CPU; for CUDA operands it launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.neural_rollout import (
    check_cols_shapes, check_shapes, plain_cost_emit_loop, session_rows,
)


def flatten_gp_weights(gp: Dict) -> Dict[str, torch.Tensor]:
    """The kernels' operands (``kernels.GP_OPERANDS``) from a GPPredictor's
    params: Zs [M,D] (inducing inputs over the lengthscales), zn2 [M] (their
    squared norms), alphaT [S,M], in_mean [D], inv_in [D], out_mean [S],
    out_std [S], var [] (pallas_neural.py:623-644)."""
    ls = gp["lengthscales"].float()
    Zs = gp["Z"].float() / ls
    return {
        "Zs": Zs.contiguous(),
        "zn2": torch.sum(Zs * Zs, dim=1),
        "alphaT": gp["alpha"].float().T.contiguous(),
        "in_mean": gp["in_mean"].float().reshape(-1),
        "inv_in": (1.0 / (gp["in_std"].float() * ls)).reshape(-1),
        "out_mean": gp["out_mean"].float().reshape(-1),
        "out_std": gp["out_std"].float().reshape(-1),
        "var": gp["variance"].float().reshape(()),
    }


def gp_step(ops: Dict[str, torch.Tensor], x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One GP transition on ``x [K,S]``, ``u [K,U]`` (pallas_neural.py:697-709)."""
    an = (torch.cat([x, u], dim=1) - ops["in_mean"]) * ops["inv_in"]
    d2 = torch.sum(an * an, dim=1, keepdim=True) - 2.0 * (an @ ops["Zs"].T) + ops["zn2"]
    k = ops["var"] * torch.exp(-0.5 * torch.maximum(d2, torch.zeros_like(d2)))
    return x + ((k @ ops["alphaT"].T) * ops["out_std"] + ops["out_mean"])


def gp_cost_rollout_plain(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                          pvec: torch.Tensor, ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K14's arithmetic in PyTorch (pallas_neural.py:677-723)."""
    return gp_cost_rollout_emit_plain(model, s0, Q, pvec, ops)[0]


def gp_cost_rollout_emit_plain(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                               pvec: torch.Tensor, ops: Dict[str, torch.Tensor]):
    """K14's emit_terminal form in PyTorch: ``(cost [K], x_H [K, S])``."""
    return plain_cost_emit_loop(model, s0, Q, pvec, lambda x, u: gp_step(ops, x, u))


def gp_cost_rollout(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                    pvec: torch.Tensor, ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K14: per-rollout trajectory cost ``[K]`` under the GP; see the module
    docstring."""
    return gp_cost_rollout_lanes(model, s0, Q, pvec, ops, 0)


def gp_cost_rollout_lanes(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                          pvec: torch.Tensor, ops: Dict[str, torch.Tensor], lanes: int
                          ) -> torch.Tensor:
    """K14 with ``lanes`` lanes a rollout (1, 2, 4, 8 or 16; 0 for the
    kernel's own, which ``gp_cost_rollout`` takes): the split's measurement
    (chip_smoke.py phase 20).  Counted as K14's launches.  Over a cost other
    than cartpole's, lanes 0 alone (``kernels.require_lanes`` raises for
    another)."""
    check_shapes("gp_cost_rollout", s0, Q, pvec)
    if lanes not in (0, 1, 2, 4, 8, 16):
        raise ValueError(f"gp_cost_rollout: {lanes} lanes a rollout (1, 2, 4, 8 or 16; 0: the "
                         "kernel's)")
    kernels.require_lanes("K14", model.plant, lanes)
    if kernels.on_cpu(s0, Q, pvec, *ops.values()):
        return gp_cost_rollout_plain(model, s0, Q, pvec, ops)
    cost = _launch("gp_cost_rollout", model, s0, Q, pvec, ops, s0.shape[0], lanes)
    gp_cost_rollout.launches += 1
    return cost


gp_cost_rollout.launches = 0


def gp_cost_rollout_emit(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                         pvec: torch.Tensor, ops: Dict[str, torch.Tensor]):
    """K14's emit_terminal form: ``(cost [K], x_H [K, S])``; see the
    module docstring."""
    check_shapes("gp_cost_rollout_emit", s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec, *ops.values()):
        return gp_cost_rollout_emit_plain(model, s0, Q, pvec, ops)
    x_term = torch.empty_like(s0)
    cost = _launch("gp_cost_rollout_emit", model, s0, Q, pvec, ops, s0.shape[0], 0, x_term)
    gp_cost_rollout_emit.launches += 1
    return cost, x_term


gp_cost_rollout_emit.launches = 0


def gp_cost_rollout_cols_plain(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                               pvec_b: torch.Tensor, ops: Dict[str, torch.Tensor]
                               ) -> torch.Tensor:
    """K14's session-row form in PyTorch: K14's plain version over the B*K
    rollouts, each scored under its session's row of ``pvec_b``;
    ``[B, K]``."""
    return gp_cost_rollout_cols_emit_plain(model, s0, Q, pvec_b, ops)[0]


def gp_cost_rollout_cols_emit_plain(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                                    pvec_b: torch.Tensor, ops: Dict[str, torch.Tensor]):
    """K14's session-row emit_terminal form in PyTorch: ``(cost [B, K],
    x_H [B, K, S])``."""
    B = pvec_b.shape[0]
    K = s0.shape[0] // B
    cost, x = gp_cost_rollout_emit_plain(model, s0, Q, session_rows(pvec_b, K).T, ops)
    return cost.reshape(B, K), x.reshape(B, K, -1)


def gp_cost_rollout_cols(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                         pvec_b: torch.Tensor, ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K14's session-row (``slot_keys``) form: the costs ``[B, K]`` of B
    sessions' rollouts in one launch, ``s0 [B*K,S]`` and ``Q [B*K,H,U]``
    session by session, every lane of rollout b*K + k reading session b's
    row of ``pvec_b [B,N]``; the GP's operands are shared."""
    K = check_cols_shapes("gp_cost_rollout_cols", s0, Q, pvec_b)
    if kernels.on_cpu(s0, Q, pvec_b, *ops.values()):
        return gp_cost_rollout_cols_plain(model, s0, Q, pvec_b, ops)
    cost = _launch("gp_cost_rollout_cols", model, s0, Q, pvec_b, ops, K, 0)
    gp_cost_rollout_cols.launches += 1
    return cost.reshape(pvec_b.shape[0], K)


gp_cost_rollout_cols.launches = 0


def gp_cost_rollout_cols_emit(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                              pvec_b: torch.Tensor, ops: Dict[str, torch.Tensor]):
    """K14's session-row form's emit_terminal form: ``(cost [B, K], x_H
    [B, K, S])`` of B sessions' rollouts in one launch, laid out as
    ``gp_cost_rollout_cols``'."""
    K = check_cols_shapes("gp_cost_rollout_cols_emit", s0, Q, pvec_b)
    if kernels.on_cpu(s0, Q, pvec_b, *ops.values()):
        return gp_cost_rollout_cols_emit_plain(model, s0, Q, pvec_b, ops)
    x_term = torch.empty_like(s0)
    cost = _launch("gp_cost_rollout_cols_emit", model, s0, Q, pvec_b, ops, K, 0, x_term)
    gp_cost_rollout_cols_emit.launches += 1
    B = pvec_b.shape[0]
    return cost.reshape(B, K), x_term.reshape(B, K, -1)


gp_cost_rollout_cols_emit.launches = 0


def _launch(name: str, model: kernels.GPModel, s0, Q, pvec, ops, ks: int, lanes: int,
            x_term=None):
    """Check the operands and launch K14 with ``lanes`` lanes a rollout over
    sessions of ``ks`` rollouts, ``pvec``'s rows, or, with ``x_term [K,
    S]``, its emit_terminal form, which writes the terminal states there;
    returns the costs."""
    args, tensors = model.gp_args(ops)
    terminal = {} if x_term is None else {"x_term": x_term}
    device = kernels.check_cuda_operands(name, s0=s0, Q=Q, pvec=pvec, **terminal, **tensors)
    K, S = s0.shape
    H, U = Q.shape[1], Q.shape[2]
    model.check_launch_shape(name, S, U, K, H, pvec.shape[-1])
    cost = torch.empty(K, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = kernels.load().ctt_gp_cost_rollout(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), Q.data_ptr(), pvec.data_ptr(),
            cost.data_ptr(), None if x_term is None else x_term.data_ptr(), K, ks, H,
            model.max_cost, lanes, args,
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, f"{name} (M={args.M} inducing points)")
    return cost
