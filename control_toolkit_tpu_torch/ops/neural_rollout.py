"""K11 and K13: network rollout + trajectory cost — the counterparts of
control_toolkit_tpu/ops/pallas_neural.py:build_neural_cost_rollout_kernel
(MLP) and build_recurrent_cost_rollout_kernel (stacked GRU/LSTM).

``neural_cost_rollout(model, s0 [K,S], Q [K,H,U], pvec [N], net) -> [K]``
and ``recurrent_cost_rollout(model, s0, Q, pvec, net, hidden) -> [K]``,
with pallas_neural.py's semantics: the stage cost of (x_h, u_h, u_{h-1})
accrues before the step, the terminal cost is taken at x_H, and the sum is
divided by H+1; u_{-1} is the packed ``__u_prev_*``.  ``pvec`` holds the
cost's part of the packed layout only (``kernels.COST_PARAM_KEYS``).

The MLP step is NeuralPredictor.single_step: ``[x, u]`` through
``norm_in`` (``(a - mean) / std``), the layers ``a @ W + b`` with tanh on
all but the last, ``norm_out`` (``a * std + mean``), then ``x + a``
(``predict_delta``) or ``a``.  The recurrent step runs ``[x, u]`` through
the stacked cells (gates r, z, n for the GRU; i, f, g, o for the LSTM,
whose state is ``[h, c]``) from the live batch-1 ``hidden`` broadcast to
the K rollouts, and the head ``h @ wo + bo`` gives the delta or the next
state.

The kernels take the net's tensors as they are stored (``w{i}`` [in,
out], ``cell{i}/wi`` [in, G*Hd]); a new weight tensor is a new pointer,
never a rebuild.

Their session-row (``slot_keys``) forms, ``neural_cost_rollout_cols`` and
``recurrent_cost_rollout_cols`` (the batched-mpc fleet's), score B
sessions' rollouts in one launch of the same kernel: ``s0 [B*K,S]`` and
``Q [B*K,H,U]`` session by session, rollout b*K + k reading row b of
``pvec_b [B,N]`` (``optimizers/base.py:make_slot_packer``) and, for K13,
starting from row b of each cell's hidden (``hidden_per_lane``); the
costs come back ``[B, K]``.  The JAX kernels lay a session's rows out as
lane columns ``[n_slot, B*K]`` (pallas_neural.py:191-197), a TPU layout;
here each rollout reads its session's row by index, and a 16-rollout group
may straddle two sessions.  K11's member-block (``n_members``, pallas_neural.py:173) form,
``neural_cost_rollout_ens`` (the PETS ensemble's,
``kernel_families/ensemble.py``), runs a stacked net of E members (every
leaf with a leading member axis) over K rollouts in one launch, rollout k
under member k // (K/E): PETS TS-inf blockwise.  The JAX kernel fetched
member ``tile // tiles_per_member``'s weights per grid tile; here each
block stages its member's weights, so a 16-rollout group never straddles
two members.  The CUDA kernels are ``csrc/neural_rollout.cu`` (its
source note says what bounds them on the card); the ``*_plain`` functions
are the same functions in PyTorch.  A wrapper runs its plain version only
when every operand lies on the CPU; for CUDA operands it launches its
kernel or raises.

Their ``emit_terminal`` forms (pallas_neural.py:174, :466), the ``*_emit``
wrappers (``neural_cost_rollout_emit``, ``neural_cost_rollout_cols_emit``,
``neural_cost_rollout_ens_emit``, ``recurrent_cost_rollout_emit``), also
return the terminal states ``x_H`` in the costs' rollout order (``[K, S]``;
the session-row form ``[B, K, S]``), on which a learned value terminal is
evaluated outside the kernel (``costs/value_terminal.py``); their costs are
the kernels', the same body.  Each plain version is written once, as its
emit form (``plain_cost_emit_loop``), the unvalued one its first output.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from control_toolkit_tpu_torch.models.networks import RECURRENT_FNS
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.kernels import check_cols_shapes, session_rows


def mlp_layer_count(net: Dict) -> int:
    return sum(1 for k in net if k.startswith("w"))


def mlp_step(net: Dict, x: torch.Tensor, u: torch.Tensor, predict_delta: bool) -> torch.Tensor:
    """One MLP transition on ``x [K,S]``, ``u [K,U]`` (pallas_neural.py:234-241);
    also on ``[E, K/E, S]`` blocks under a stacked net whose vectors
    broadcast over the block (``member_block_step``)."""
    a = torch.cat([x, u], dim=-1)
    if "norm_in_mean" in net:
        a = (a - net["norm_in_mean"]) / net["norm_in_std"]
    n = mlp_layer_count(net)
    for i in range(n):
        a = a @ net[f"w{i}"] + net[f"b{i}"]
        if i < n - 1:
            a = torch.tanh(a)
    if "norm_out_mean" in net:
        a = a * net["norm_out_std"] + net["norm_out_mean"]
    return x + a if predict_delta else a


def _cols(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return tuple(t[:, i] for i in range(t.shape[1]))


def plain_cost_loop(model: kernels.NetModel, s0, Q, pvec, step) -> torch.Tensor:
    """The plain versions' loop, over any ``step(x [K,S], u [K,U]) -> x'``."""
    return plain_cost_emit_loop(model, s0, Q, pvec, step)[0]


def plain_cost_emit_loop(model: kernels.NetModel, s0, Q, pvec, step):
    """``plain_cost_loop``'s emit_terminal form: ``(cost [K], x_H [K, S])``."""
    p = model.unpack(pvec)
    K, H, U = s0.shape[0], Q.shape[1], Q.shape[2]
    x = s0
    prev_us = tuple(p[f"__u_prev_{j}"].expand(K) for j in range(U))
    acc = torch.zeros(K, dtype=s0.dtype, device=s0.device)
    for h in range(H):
        u = Q[:, h, :]
        us = _cols(u)
        acc = acc + model.stage(_cols(x), us, prev_us, p)
        x = step(x, u)
        prev_us = us
    return (acc + model.terminal(_cols(x), p)) / (H + 1), x


def neural_cost_rollout_plain(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                              pvec: torch.Tensor, net: Dict) -> torch.Tensor:
    """K11's arithmetic in PyTorch (pallas_neural.py:205-255)."""
    return neural_cost_rollout_emit_plain(model, s0, Q, pvec, net)[0]


def neural_cost_rollout_emit_plain(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                   pvec: torch.Tensor, net: Dict):
    """K11's emit_terminal form in PyTorch: ``(cost [K], x_H [K, S])``."""
    return plain_cost_emit_loop(model, s0, Q, pvec,
                                lambda x, u: mlp_step(net, x, u, model.predict_delta))


def ensemble_members(name: str, net: Dict, K: int) -> int:
    """E, the leading member axis of a stacked MLP (``w{i}`` [E, in, out]);
    raises unless it divides the K rollouts into member blocks."""
    E = int(net["w0"].shape[0]) if net["w0"].ndim == 3 else 0
    if E < 1 or K % E:
        raise ValueError(f"{name}: a stacked net of E members with K % E == 0, got w0 "
                         f"{tuple(net['w0'].shape)} over K={K}")
    return E


def member_blocks(net: Dict) -> Dict:
    """A stacked net whose vectors (biases, norms: ``[E, n]``) broadcast over
    a batch axis, so that its layers run ``[E, B, in]`` under each member's
    weights as one batched matmul."""
    return {k: v[:, None, :] if v.ndim == 2 else v for k, v in net.items()}


def member_block_step(net: Dict, x: torch.Tensor, u: torch.Tensor,
                      predict_delta: bool) -> torch.Tensor:
    """PETS TS-inf blockwise: block e of the K/E rollouts of ``x [K,S]``
    steps under member e of the stacked ``net`` (``mlp_step`` over
    ``[E, K/E, S]``)."""
    E, K = int(net["w0"].shape[0]), x.shape[0]
    return mlp_step(member_blocks(net), x.reshape(E, K // E, -1), u.reshape(E, K // E, -1),
                    predict_delta).reshape(K, -1)


def neural_cost_rollout_ens_plain(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                  pvec: torch.Tensor, net: Dict) -> torch.Tensor:
    """K11's member-block form in PyTorch (pallas_neural.py:157,
    ``n_members``): block e of K/E rollouts under member e's weights."""
    return neural_cost_rollout_ens_emit_plain(model, s0, Q, pvec, net)[0]


def neural_cost_rollout_ens_emit_plain(model: kernels.NetModel, s0: torch.Tensor,
                                       Q: torch.Tensor, pvec: torch.Tensor, net: Dict):
    """The member-block form's emit_terminal form in PyTorch: ``(cost [K],
    x_H [K, S])``."""
    return plain_cost_emit_loop(model, s0, Q, pvec,
                                lambda x, u: member_block_step(net, x, u, model.predict_delta))


def _ens_members(name: str, model: kernels.NetModel, s0, Q, pvec, net: Dict) -> int:
    check_shapes(name, s0, Q, pvec)
    if model.kind != "mlp":
        raise ValueError(f"{name}: an MLP ensemble, not a {model.kind}")
    return ensemble_members(name, net, s0.shape[0])


def neural_cost_rollout_ens(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                            pvec: torch.Tensor, net: Dict) -> torch.Tensor:
    """K11's member-block (``n_members``) form: the costs ``[K]`` of K
    rollouts under a stacked MLP of E members (``w{i}`` [E, in, out],
    ``b{i}`` [E, out], ``norm_*`` [E, n]), rollout k under member k //
    (K/E), PETS TS-inf blockwise; one launch, each block staging its
    member's weights."""
    E = _ens_members("neural_cost_rollout_ens", model, s0, Q, pvec, net)
    if kernels.on_cpu(s0, Q, pvec, *net.values()):
        return neural_cost_rollout_ens_plain(model, s0, Q, pvec, net)
    cost = _launch("ctt_neural_cost_rollout_ens", "neural_cost_rollout_ens", model, s0, Q, pvec,
                   net, None, ks=s0.shape[0] // E, members=E)
    neural_cost_rollout_ens.launches += 1
    return cost


neural_cost_rollout_ens.launches = 0


def neural_cost_rollout_ens_emit(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                 pvec: torch.Tensor, net: Dict):
    """The member-block form's emit_terminal form (pallas_neural.py:173-174,
    ``n_members`` with ``emit_terminal``): ``(cost [K], x_H [K, S])``."""
    E = _ens_members("neural_cost_rollout_ens_emit", model, s0, Q, pvec, net)
    if kernels.on_cpu(s0, Q, pvec, *net.values()):
        return neural_cost_rollout_ens_emit_plain(model, s0, Q, pvec, net)
    x_term = torch.empty_like(s0)
    cost = _launch("ctt_neural_cost_rollout_ens", "neural_cost_rollout_ens_emit", model, s0, Q,
                   pvec, net, None, ks=s0.shape[0] // E, members=E, x_term=x_term)
    neural_cost_rollout_ens_emit.launches += 1
    return cost, x_term


neural_cost_rollout_ens_emit.launches = 0


def recurrent_cost_rollout_plain(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                 pvec: torch.Tensor, net: Dict, hidden) -> torch.Tensor:
    """K13's arithmetic in PyTorch (pallas_neural.py:496-589)."""
    return recurrent_cost_rollout_emit_plain(model, s0, Q, pvec, net, hidden)[0]


def recurrent_cost_rollout_emit_plain(model: kernels.NetModel, s0: torch.Tensor,
                                      Q: torch.Tensor, pvec: torch.Tensor, net: Dict, hidden):
    """K13's emit_terminal form in PyTorch: ``(cost [K], x_H [K, S])``."""
    apply = RECURRENT_FNS[model.kind][1]
    K = s0.shape[0]
    hs = [tuple(h.expand(K, h.shape[-1]) for h in hidden)]

    def step(x, u):
        out, hs[0] = apply(net, torch.cat([x, u], dim=1), hs[0])
        return x + out if model.predict_delta else out

    return plain_cost_emit_loop(model, s0, Q, pvec, step)


def check_shapes(name: str, s0: torch.Tensor, Q: torch.Tensor, pvec: torch.Tensor) -> None:
    if s0.ndim != 2 or Q.ndim != 3 or Q.shape[0] != s0.shape[0] or pvec.ndim != 1:
        raise ValueError(
            f"{name}: expected s0 [K,S], Q [K,H,U], pvec [N]; got "
            f"{tuple(s0.shape)}, {tuple(Q.shape)}, {tuple(pvec.shape)}"
        )


def _launch(entry: str, name: str, model: kernels.NetModel, s0, Q, pvec, net, hidden,
            extra=(), ks: int = 0, rows: int = 1, members: int = 0, x_term=None):
    """Check the operands and launch the C entry point ``entry`` over
    sessions of ``ks`` rollouts (0: one session) whose rows ``pvec`` and
    ``hidden`` hold, or over blocks of ``ks`` rollouts a member of a
    stacked net of ``members`` members, with ``extra`` arguments before the
    net's, or, with ``x_term [K, S]``, the entry's emit_terminal form, which
    writes the terminal states there; returns the costs."""
    args, tensors = model.net_args(net, hidden, rows, members)
    terminal = {} if x_term is None else {"x_term": x_term}
    device = kernels.check_cuda_operands(name, s0=s0, Q=Q, pvec=pvec, **terminal, **tensors)
    K, S = s0.shape
    H, U = Q.shape[1], Q.shape[2]
    model.check_launch_shape(name, S, U, K, H, pvec.shape[-1])
    cost = torch.empty(K, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = getattr(kernels.load(), entry)(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), Q.data_ptr(), pvec.data_ptr(),
            cost.data_ptr(), None if x_term is None else x_term.data_ptr(), K, ks or K, H,
            model.max_cost, *extra, args,
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, name)
    return cost


def neural_cost_rollout(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                        pvec: torch.Tensor, net: Dict) -> torch.Tensor:
    """K11: per-rollout trajectory cost ``[K]`` under an MLP; see the module
    docstring."""
    return neural_cost_rollout_warps(model, s0, Q, pvec, net, 0)


def neural_cost_rollout_warps(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                              pvec: torch.Tensor, net: Dict, warps: int) -> torch.Tensor:
    """K11 with ``warps`` warps a 16-rollout group (1, 2 or 4; 0 for the
    layout's own, which ``neural_cost_rollout`` takes): the split's
    measurement (chip_smoke.py phase 11).  Counted as K11's launches."""
    _check_mlp("neural_cost_rollout", model, s0, Q, pvec)
    if warps not in (0, 1, 2, 4):
        raise ValueError(f"neural_cost_rollout: {warps} warps a group (1, 2 or 4; 0: the plan's)")
    if kernels.on_cpu(s0, Q, pvec, *net.values()):
        return neural_cost_rollout_plain(model, s0, Q, pvec, net)
    cost = _launch("ctt_neural_cost_rollout", "neural_cost_rollout", model, s0, Q, pvec, net,
                   None, (warps,))
    neural_cost_rollout.launches += 1
    return cost


neural_cost_rollout.launches = 0


def _check_mlp(name: str, model: kernels.NetModel, s0, Q, pvec) -> None:
    check_shapes(name, s0, Q, pvec)
    if model.kind != "mlp":
        raise ValueError(f"{name}: an MLP, not a {model.kind}")


def neural_cost_rollout_emit(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                             pvec: torch.Tensor, net: Dict):
    """K11's emit_terminal form (pallas_neural.py:174): ``(cost [K], x_H
    [K, S])``; see the module docstring."""
    _check_mlp("neural_cost_rollout_emit", model, s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec, *net.values()):
        return neural_cost_rollout_emit_plain(model, s0, Q, pvec, net)
    x_term = torch.empty_like(s0)
    cost = _launch("ctt_neural_cost_rollout", "neural_cost_rollout_emit", model, s0, Q, pvec,
                   net, None, (0,), x_term=x_term)
    neural_cost_rollout_emit.launches += 1
    return cost, x_term


neural_cost_rollout_emit.launches = 0


def neural_cost_rollout_cols_plain(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                   pvec_b: torch.Tensor, net: Dict) -> torch.Tensor:
    """K11's session-row form in PyTorch: K11's plain version over the B*K
    rollouts, each with its session's row of ``pvec_b``; ``[B, K]``."""
    return neural_cost_rollout_cols_emit_plain(model, s0, Q, pvec_b, net)[0]


def neural_cost_rollout_cols_emit_plain(model: kernels.NetModel, s0: torch.Tensor,
                                        Q: torch.Tensor, pvec_b: torch.Tensor, net: Dict):
    """K11's session-row emit_terminal form in PyTorch: ``(cost [B, K],
    x_H [B, K, S])``."""
    B = pvec_b.shape[0]
    K = s0.shape[0] // B
    cost, x = neural_cost_rollout_emit_plain(model, s0, Q, session_rows(pvec_b, K).T, net)
    return cost.reshape(B, K), x.reshape(B, K, -1)


def neural_cost_rollout_cols(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                             pvec_b: torch.Tensor, net: Dict) -> torch.Tensor:
    """K11's session-row (``slot_keys``) form: the costs ``[B, K]`` of B
    sessions' rollouts in one launch, ``s0 [B*K,S]`` and ``Q [B*K,H,U]``
    session by session, rollout b*K + k reading session b's row of
    ``pvec_b [B,N]`` (``optimizers/base.py:make_slot_packer``); the net's
    weights are shared."""
    K = check_cols_shapes("neural_cost_rollout_cols", s0, Q, pvec_b)
    if model.kind != "mlp":
        raise ValueError(f"neural_cost_rollout_cols: an MLP, not a {model.kind}")
    if kernels.on_cpu(s0, Q, pvec_b, *net.values()):
        return neural_cost_rollout_cols_plain(model, s0, Q, pvec_b, net)
    cost = _launch("ctt_neural_cost_rollout", "neural_cost_rollout_cols", model, s0, Q, pvec_b,
                   net, None, (0,), ks=K)
    neural_cost_rollout_cols.launches += 1
    return cost.reshape(pvec_b.shape[0], K)


neural_cost_rollout_cols.launches = 0


def neural_cost_rollout_cols_emit(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                  pvec_b: torch.Tensor, net: Dict):
    """K11's session-row form's emit_terminal form (``slot_keys`` with
    ``emit_terminal``): ``(cost [B, K], x_H [B, K, S])`` of B sessions'
    rollouts in one launch, laid out as ``neural_cost_rollout_cols``'."""
    K = check_cols_shapes("neural_cost_rollout_cols_emit", s0, Q, pvec_b)
    if model.kind != "mlp":
        raise ValueError(f"neural_cost_rollout_cols_emit: an MLP, not a {model.kind}")
    if kernels.on_cpu(s0, Q, pvec_b, *net.values()):
        return neural_cost_rollout_cols_emit_plain(model, s0, Q, pvec_b, net)
    x_term = torch.empty_like(s0)
    cost = _launch("ctt_neural_cost_rollout", "neural_cost_rollout_cols_emit", model, s0, Q,
                   pvec_b, net, None, (0,), ks=K, x_term=x_term)
    neural_cost_rollout_cols_emit.launches += 1
    B = pvec_b.shape[0]
    return cost.reshape(B, K), x_term.reshape(B, K, -1)


neural_cost_rollout_cols_emit.launches = 0


def _net_leaves(net: Dict) -> list:
    return [v for cell in net.values() for v in (cell.values() if isinstance(cell, dict)
                                                 else (cell,))]


def recurrent_cost_rollout(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                           pvec: torch.Tensor, net: Dict, hidden) -> torch.Tensor:
    """K13: per-rollout trajectory cost ``[K]`` under a stacked GRU/LSTM
    from the live batch-1 ``hidden``; see the module docstring."""
    _check_recurrent("recurrent_cost_rollout", model, s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec, *_net_leaves(net), *hidden):
        return recurrent_cost_rollout_plain(model, s0, Q, pvec, net, hidden)
    cost = _launch("ctt_recurrent_cost_rollout", "recurrent_cost_rollout", model, s0, Q, pvec,
                   net, hidden)
    recurrent_cost_rollout.launches += 1
    return cost


recurrent_cost_rollout.launches = 0


def _check_recurrent(name: str, model: kernels.NetModel, s0, Q, pvec) -> None:
    check_shapes(name, s0, Q, pvec)
    if model.kind not in RECURRENT_FNS:
        raise ValueError(f"{name}: a GRU or LSTM, not a {model.kind}")


def recurrent_cost_rollout_emit(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                pvec: torch.Tensor, net: Dict, hidden):
    """K13's emit_terminal form (pallas_neural.py:466): ``(cost [K], x_H
    [K, S])`` from the live batch-1 ``hidden``; see the module docstring."""
    _check_recurrent("recurrent_cost_rollout_emit", model, s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec, *_net_leaves(net), *hidden):
        return recurrent_cost_rollout_emit_plain(model, s0, Q, pvec, net, hidden)
    x_term = torch.empty_like(s0)
    cost = _launch("ctt_recurrent_cost_rollout", "recurrent_cost_rollout_emit", model, s0, Q,
                   pvec, net, hidden, x_term=x_term)
    recurrent_cost_rollout_emit.launches += 1
    return cost, x_term


recurrent_cost_rollout_emit.launches = 0


def recurrent_cost_rollout_cols_plain(model: kernels.NetModel, s0: torch.Tensor,
                                      Q: torch.Tensor, pvec_b: torch.Tensor, net: Dict,
                                      hidden_b) -> torch.Tensor:
    """K13's session-row form in PyTorch: K13's plain version over the B*K
    rollouts, each with its session's row of ``pvec_b`` and starting from
    its session's row of each cell's hidden (``hidden_b``: ``[B, Hd]`` a
    cell, ``[B, 2 Hd]`` for the LSTM's [h, c]); ``[B, K]``."""
    B = pvec_b.shape[0]
    K = s0.shape[0] // B
    return recurrent_cost_rollout_plain(
        model, s0, Q, session_rows(pvec_b, K).T, net,
        tuple(session_rows(h, K) for h in hidden_b)).reshape(B, K)


def recurrent_cost_rollout_cols(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                pvec_b: torch.Tensor, net: Dict, hidden_b) -> torch.Tensor:
    """K13's session-row (``slot_keys`` + ``hidden_per_lane``) form: the
    costs ``[B, K]`` of B sessions' rollouts in one launch, as
    ``neural_cost_rollout_cols``, each rollout starting from its session's
    row of each cell's hidden ``hidden_b`` (``[B, Hd]``, the LSTM's
    ``[B, 2 Hd]``); the cells' and head's weights are shared."""
    K = check_cols_shapes("recurrent_cost_rollout_cols", s0, Q, pvec_b)
    if model.kind not in RECURRENT_FNS:
        raise ValueError(f"recurrent_cost_rollout_cols: a GRU or LSTM, not a {model.kind}")
    if kernels.on_cpu(s0, Q, pvec_b, *_net_leaves(net), *hidden_b):
        return recurrent_cost_rollout_cols_plain(model, s0, Q, pvec_b, net, hidden_b)
    cost = _launch("ctt_recurrent_cost_rollout", "recurrent_cost_rollout_cols", model, s0, Q,
                   pvec_b, net, hidden_b, ks=K, rows=pvec_b.shape[0])
    recurrent_cost_rollout_cols.launches += 1
    return cost.reshape(pvec_b.shape[0], K)


recurrent_cost_rollout_cols.launches = 0
