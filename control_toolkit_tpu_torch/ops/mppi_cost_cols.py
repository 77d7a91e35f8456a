"""K4: the semi-fused MPPI cost of B sessions in one launch — the
counterpart of control_toolkit_tpu/ops/pallas_mppi.py:make_cost_run_cols
(``make_run.cols``, body ``kernel1_cols``).

``mppi_cost_cols(model, s0 [B,S], u_nom [B,H,U], pvec_b [B,N], eps
[B,P,U,K], W [P,H], low [U], high [U], cc_weight, R, NU) -> cost [B,K]``:
for each session b, K2's function (``ops/mppi_cost.py``) of its own
initial state, shifted nominal plan ``u_nom[b]``, packed parameters
``pvec_b[b]`` (``optimizers/base.py:make_slot_packer``) and noise
``eps[b]``.  The JAX kernel lays session b's rollouts out as lane columns
of its tiles; its rollout ``(r, cw)`` (sublane r, session-local column cw)
is ``k = r*(K/8) + cw`` here, the order of the JAX step's ``costs [B, K]``,
so its ``eps [T, U, P*8, C]`` maps to ``eps[b, p, j, r*(K/8) + cw]``
(``eps_from_tiles``).

The CUDA kernel is ``csrc/mppi_cost_cols.cu``.  ``mppi_cost_cols_plain``
is the same function in PyTorch: K2's plain version over the B*K rollouts
with every operand given per rollout.  The wrapper runs it only when every
operand lies on the CPU; for CUDA operands it launches the kernel or
raises.

Its ``emit_terminal`` form (``kernel1_cols_emit``, pallas_mppi.py:350;
``make_cost_run_cols(..., emit_terminal)``, :586) ``mppi_cost_cols_emit``
also returns the terminal states ``x_H [B, K, S]``, ``[b, k]`` the rollout
of ``cost[b, k]`` (the JAX kernel's ``xterm [S, ROWS, B*K/8]`` holds it at
``[:, r, b*K/8 + cw]``, ``k = r*(K/8) + cw``: ``xterm_from_tiles``); the
batched step adds each session's ``V(x_H)/(H+1)`` before its softmax.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.counter_prng import ROWS
from control_toolkit_tpu_torch.ops.mppi_cost import _corr_consts, mppi_cost_emit_plain


def eps_from_tiles(eps_tiles: torch.Tensor, B: int) -> torch.Tensor:
    """The JAX kernel's noise ``[T, U, P*8, C]`` (session b in lane
    columns ``[b*K/8, (b+1)*K/8)`` of the global column order) as
    ``[B, P, U, K]``, rollout ``k = r*(K/8) + cw``."""
    T, U, PR, C = eps_tiles.shape
    P, cps = PR // ROWS, (T * C) // B
    return (eps_tiles.reshape(T, U, P, ROWS, C).permute(2, 1, 3, 0, 4)
            .reshape(P, U, ROWS, B, cps).permute(3, 0, 1, 2, 4).reshape(B, P, U, ROWS * cps))


def per_rollout(t: torch.Tensor, K: int) -> torch.Tensor:
    """``[B, ...]`` per-session rows as ``[..., B*K]``: each session's row
    repeated for its K rollouts, the rollout index last."""
    return t.reshape(t.shape[0], -1).T.repeat_interleave(K, dim=1).reshape(*t.shape[1:], -1)


def xterm_from_tiles(xterm: torch.Tensor, B: int) -> torch.Tensor:
    """The JAX emit_terminal kernel's terminal states ``[S, 8, B*K/8]``
    as ``[B, K, S]``, rollout ``k = r*(K/8) + cw`` of session b."""
    S, R, cols = xterm.shape
    return xterm.reshape(S, R, B, cols // B).permute(2, 1, 3, 0).reshape(B, R * (cols // B), S)


def mppi_cost_cols_plain(model: kernels.RolloutModel, s0, u_nom, pvec_b, eps, W, low, high,
                         cc_weight: float, R: float, NU: float) -> torch.Tensor:
    """K2's plain version over the B*K rollouts, each operand per rollout."""
    return mppi_cost_cols_emit_plain(model, s0, u_nom, pvec_b, eps, W, low, high, cc_weight,
                                     R, NU)[0]


def mppi_cost_cols_emit_plain(model: kernels.RolloutModel, s0, u_nom, pvec_b, eps, W, low,
                              high, cc_weight: float, R: float, NU: float):
    """K4's emit_terminal form in PyTorch: ``(cost [B, K], x_H [B, K, S])``."""
    B, P, U, K = eps.shape
    cost, x_term = mppi_cost_emit_plain(
        model, per_rollout(s0, K), per_rollout(u_nom, K), per_rollout(pvec_b, K),
        eps.permute(1, 2, 0, 3).reshape(P, U, B * K), W, low, high, cc_weight, R, NU)
    return cost.reshape(B, K), x_term.reshape(B, K, -1)


def mppi_cost_cols(model: kernels.RolloutModel, s0: torch.Tensor, u_nom: torch.Tensor,
                   pvec_b: torch.Tensor, eps: torch.Tensor, W: torch.Tensor,
                   low: torch.Tensor, high: torch.Tensor,
                   cc_weight: float, R: float, NU: float) -> torch.Tensor:
    """Per-session, per-rollout MPPI cost ``[B, K]``; see the module
    docstring."""
    operands = (model, s0, u_nom, pvec_b, eps, W, low, high, cc_weight, R, NU)
    if kernels.on_cpu(s0, u_nom, pvec_b, eps, W, low, high):
        _check_shapes("mppi_cost_cols", *operands[1:8])
        return mppi_cost_cols_plain(*operands)
    cost = _launch("mppi_cost_cols", *operands)
    mppi_cost_cols.launches += 1
    return cost


mppi_cost_cols.launches = 0


def mppi_cost_cols_emit(model: kernels.RolloutModel, s0: torch.Tensor, u_nom: torch.Tensor,
                        pvec_b: torch.Tensor, eps: torch.Tensor, W: torch.Tensor,
                        low: torch.Tensor, high: torch.Tensor,
                        cc_weight: float, R: float, NU: float):
    """K4's emit_terminal form: ``(cost [B, K], x_H [B, K, S])``; see the
    module docstring."""
    operands = (model, s0, u_nom, pvec_b, eps, W, low, high, cc_weight, R, NU)
    if kernels.on_cpu(s0, u_nom, pvec_b, eps, W, low, high):
        _check_shapes("mppi_cost_cols_emit", *operands[1:8])
        return mppi_cost_cols_emit_plain(*operands)
    B, _, _, K = eps.shape
    x_term = torch.empty(B, K, s0.shape[1], dtype=torch.float32, device=s0.device)
    cost = _launch("mppi_cost_cols_emit", *operands, x_term=x_term)
    mppi_cost_cols_emit.launches += 1
    return cost, x_term


mppi_cost_cols_emit.launches = 0


def _check_shapes(name, s0, u_nom, pvec_b, eps, W, low, high) -> None:
    if (s0.ndim != 2 or u_nom.ndim != 3 or pvec_b.ndim != 2 or eps.ndim != 4
            or W.ndim != 2 or s0.shape[0] != u_nom.shape[0]
            or pvec_b.shape[0] != s0.shape[0] or eps.shape[0] != s0.shape[0]
            or W.shape != (eps.shape[1], u_nom.shape[1]) or eps.shape[2] != u_nom.shape[2]
            or low.shape != (u_nom.shape[2],) or high.shape != low.shape):
        raise ValueError(
            f"{name}: expected s0 [B,S], u_nom [B,H,U], pvec_b [B,N], eps [B,P,U,K], "
            f"W [P,H], low/high [U]; got {tuple(s0.shape)}, {tuple(u_nom.shape)}, "
            f"{tuple(pvec_b.shape)}, {tuple(eps.shape)}, {tuple(W.shape)}, "
            f"{tuple(low.shape)}, {tuple(high.shape)}"
        )


def _launch(name, model, s0, u_nom, pvec_b, eps, W, low, high, cc_weight, R, NU,
            x_term=None) -> torch.Tensor:
    """Check the operands and launch K4, or, with ``x_term [B, K, S]``, its
    emit_terminal form, which writes the terminal states there; returns the
    costs ``[B, K]``."""
    _check_shapes(name, s0, u_nom, pvec_b, eps, W, low, high)
    kernels.require("K4" if x_term is None else "K4's emit_terminal form", model.plant)
    device = kernels.check_cuda_operands(name, s0=s0, u_nom=u_nom, pvec_b=pvec_b,
                                         eps=eps, W=W, low=low, high=high)
    B, P, U, K = eps.shape
    H = u_nom.shape[1]
    model.check_launch_shape(name, s0.shape[1], U, B * K, H, pvec_b.shape[1])
    cost = torch.empty(B, K, dtype=torch.float32, device=device)
    lib = kernels.load()
    with torch.cuda.device(device):
        rc = lib.ctt_mppi_cost_cols(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), u_nom.data_ptr(), pvec_b.data_ptr(),
            eps.data_ptr(), W.data_ptr(), low.data_ptr(), high.data_ptr(), cost.data_ptr(),
            None if x_term is None else x_term.data_ptr(),
            B, K, H, P, *model.step_args(), model.max_cost, *_corr_consts(cc_weight, R, NU),
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, name)
    return cost
