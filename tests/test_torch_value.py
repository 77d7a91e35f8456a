"""The torch port's learned value terminal against the JAX package.

``ValueTerminalCost`` and ``attach_value_terminal`` (the wrapper's
semantics, the persistent wrap hook, hot swaps); the emit_terminal forms
of K1, K2 and K4 and K7's value_spec form (their plain versions against the
JAX package's Pallas kernels in interpret mode, and the hand-written tanh
MLP VJP against ``torch.autograd`` in float64); one update of semi-fused
and modular MPPI, CEM, iCEM, rpgd-tf, gradient-tf and the MPPI fleet with
V, each fed the JAX draws; the gates that send a valued cost to those
forms and the refusals of the forms not ported; the committed value net;
and — on a machine with a card only — each CUDA form against its plain
version.

Both packages get the same value net (JAX-initialised, as numpy, through
``value_params_from_numpy``), the same inputs made with numpy from a seed
and the same noise.

    PYTHONPATH=. python tests/test_torch_value.py

from the repository's root regenerates the committed value net
(``make_assets``);

    PYTHONPATH=. python tests/test_torch_value.py --loop

runs the JAX package's valued MPPI loops from chip_smoke.py's start
(``jax_value_loops``).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.costs import value_terminal as jvt
from control_toolkit_tpu.models import networks as jnets
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.costs.cartpole import CartpoleQuadraticCost
from control_toolkit_tpu_torch.costs.value_terminal import (
    ValueTerminalCost, attach_value_terminal, update_value_params,
)
from control_toolkit_tpu_torch.models import networks as nets
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.adjoints import value_mlp_vjp
from control_toolkit_tpu_torch.ops.cost_rollout import (
    cost_rollout, cost_rollout_emit, cost_rollout_emit_plain, cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout_plain, grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.mppi_cost import (
    mppi_cost, mppi_cost_emit, mppi_cost_emit_plain, mppi_cost_plain,
)
from control_toolkit_tpu_torch.ops.mppi_cost_cols import (
    eps_from_tiles, mppi_cost_cols, mppi_cost_cols_emit, mppi_cost_cols_emit_plain,
    mppi_cost_cols_plain, xterm_from_tiles,
)
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.utils.convert import params_from_numpy, value_params_from_numpy
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import (
    CPU, COST_TOL, LIMITS, UNOM_TOL, jax_next_draw, jax_params_numpy, optimizer_config,
    port_noise, set_shared_state,
)

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "control_toolkit_tpu_torch" / "assets" / "cartpole"
VALUE_FILE = "value-mlp-32-32.npz"
# The committed net's recipe: the JAX package's MPPI at chip_smoke.py's
# main-path configuration with K cut to VALUE_K for the CPU, VALUE_TICKS
# ticks from each start of a grid (position, angle, angular velocity) of
# VALUE_STARTS, wider than the JAX CartpoleEnv's own starts (0.05 sigma),
# so that V is fitted off upright too; the realized stage costs'
# discounted cost-to-go (gamma VALUE_GAMMA) fitted by
# fit_value_mlp(hiddens=(32, 32)).
VALUE_K, VALUE_TICKS, VALUE_GAMMA = 2048, 150, 0.97
VALUE_STARTS = tuple((x, 0.0, a, w) for x in (-0.6, 0.0, 0.6) for a in (-0.25, -0.1, 0.1, 0.25)
                     for w in (-0.5, 0.5))
VALUE_FIT = dict(hiddens=(32, 32), epochs=2000, learning_rate=3e-3, seed=0)
MAIN_CONFIG = {"seed": 0, "mpc_timestep": 0.02, "mpc_horizon": 50, "num_rollouts": VALUE_K,
               "cc_weight": 1.0, "R": 1.0, "LBD": 100.0, "NU": 1000.0, "SQRTRHOINV": 0.03,
               "period_interpolation_inducing_points": 10}
# The state chip_smoke.py's valued loops start from (its LEARNED_START: the
# JAX CartpoleEnv(seed=0)'s).
LOOP_START = np.array([-0.12212279, -0.10178403, 0.01027721, -0.01767751], np.float32)
# Rollouts: test_torch_kernels.py's K1/K2 bound (float32 sums over 20 rk4
# steps); the terminal states to the same bound; K7's J and dQ to
# test_torch_grad.py's (test_pallas_grad.py's accumulation-order bound).
STATE_TOL = dict(rtol=3e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=5e-4)
K, H, TILE = 256, 20, 128


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_value_net(seed: int, hiddens=(8,), S: int = 4) -> dict:
    """A JAX ``mlp_init`` value net ``S -> hiddens -> 1`` as numpy."""
    net = jnets.mlp_init(jax.random.PRNGKey(seed), [S, *hiddens, 1])
    return jax.tree_util.tree_map(np.asarray, net)


def port_net(jnet: dict) -> dict:
    return value_params_from_numpy(jnet, CPU)


def attach_both(jctrl, pctrl, jnet: dict, scale: float = 3.0):
    """The same value net attached to a JAX and a port controller."""
    jvt.attach_value_terminal(jctrl, jax.tree_util.tree_map(jnp.asarray, jnet), value_scale=scale)
    return attach_value_terminal(pctrl, port_net(jnet), value_scale=scale)


def both_params(jctrl):
    tree = jctrl._assemble_params()
    return (jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree),
            params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), CPU))


def mppi_pair(K_=K, H_=H, **extra):
    from test_torch_mppi import make_jax_ctrl, make_port_ctrl

    return make_jax_ctrl(K_, H_, **extra), make_port_ctrl(K_, H_, **extra)


# ---- the wrapper's semantics ------------------------------------------------------
def jax_cartpole_cost():
    from control_toolkit_tpu.costs.cartpole import CartpoleQuadraticCost as JaxCartpoleCost

    return JaxCartpoleCost()


def test_terminal_adds_scaled_value_net():
    """terminal = base + scale * V, as the JAX wrapper's; the stage cost,
    the kernels' terminal (the base's alone) and the post hook (V)."""
    jnet = jax_value_net(0)
    jw = jvt.ValueTerminalCost(jax_cartpole_cost(), jnet, value_scale=2.5)
    pw = ValueTerminalCost(CartpoleQuadraticCost(), port_net(jnet), value_scale=2.5)
    jp, pp = jw.current_params(), pw.current_params()
    x = np.random.default_rng(1).normal(size=(16, 4)).astype(np.float32)
    u = np.random.default_rng(2).uniform(-1, 1, (16, 1)).astype(np.float32)
    xt, xj = torch.tensor(x), jnp.asarray(x)
    np.testing.assert_allclose(pw.get_terminal_cost(xt, pp).numpy(),
                               np.asarray(jw.get_terminal_cost(xj, jp)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pw.post_terminal_cost(xt, pp).numpy(),
                               np.asarray(jw.post_terminal_cost(xj, jp)), rtol=1e-5, atol=1e-5)
    xs = tuple(xt.unbind(1))
    assert torch.equal(pw.kernel_terminal_soa(xs, pp), pw.base.terminal_cost_soa(xs, pp))
    assert torch.equal(pw.terminal_cost_soa(xs, pp),
                       pw.base.terminal_cost_soa(xs, pp) + pw.post_terminal_cost(xt, pp))
    assert torch.equal(pw.stage_cost_step(xt, torch.tensor(u), None, pp),
                       pw.base.stage_cost_step(xt, torch.tensor(u), None, pp))


def test_trajectory_cost_shifts_by_value_over_h_plus_1():
    jnet = jax_value_net(2)
    jw = jvt.ValueTerminalCost(jax_cartpole_cost(), jnet)
    pw = ValueTerminalCost(CartpoleQuadraticCost(), port_net(jnet))
    rng = np.random.default_rng(3)
    Hh = 7
    traj = rng.normal(size=(5, Hh + 1, 4)).astype(np.float32)
    us = rng.normal(size=(5, Hh, 1)).astype(np.float32)
    got = (pw.get_trajectory_cost(torch.tensor(traj), torch.tensor(us), params=pw.current_params())
           - pw.base.get_trajectory_cost(torch.tensor(traj), torch.tensor(us),
                                         params=pw.base.current_params()))
    ref = (jw.get_trajectory_cost(jnp.asarray(traj), jnp.asarray(us), params=jw.current_params())
           - jw.base.get_trajectory_cost(jnp.asarray(traj), jnp.asarray(us),
                                         params=jw.base.current_params()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    want = nets.mlp_apply(port_net(jnet), torch.tensor(traj[:, -1]))[:, 0] / (Hh + 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


def test_wrapper_delegates_gates_and_the_cost_only_path():
    """A valued cost keeps K1's family (its emit_terminal form) and, with a
    plain tanh MLP V, K7's value_spec form; the batched gates refuse the
    hook unless their kernel carries it (post_ok); the cost-only path
    equals the trajectory path and the JAX package's fused loop."""
    from control_toolkit_tpu_torch.optimizers.base import batched_kernel_core_ok

    jctrl, pctrl = mppi_pair(64, 6)
    attach_both(jctrl, pctrl, jax_value_net(4))
    popt = pctrl.optimizer
    assert popt._post_terminal_fn() is not None
    assert popt._value_grad_spec() == {"n_layers": 2}
    assert ode.can_use_cost(popt) and ode.can_use_grad(popt)
    assert not batched_kernel_core_ok(popt, force_scan=False)
    assert batched_kernel_core_ok(popt, force_scan=False, post_ok=True)
    assert not batched_kernel_core_ok(popt, force_scan=True, post_ok=True)
    jparams, params = both_params(jctrl)
    rng = np.random.default_rng(5)
    s_tiled = np.tile(np.array([[1.0, -0.5, 0.2, 0.1]], np.float32), (64, 1))
    Q = rng.uniform(-1, 1, (64, 6, 1)).astype(np.float32)
    u_prev = np.zeros(1, np.float32)
    a = popt._make_cost_only()(torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev),
                               params)
    b = popt._rollout_and_cost(torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev),
                               params)[0]
    ref = jctrl.optimizer._fused_cost(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev),
                                      jparams)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **COST_TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref), **COST_TOL)


def test_wrapper_preserves_aos_overrides():
    """A base that overrides ``_get_stage_cost`` and ``get_terminal_cost``
    keeps both under the wrapper (JAX test_value_terminal.py:276): the
    port's wrapper and the JAX package's over the same override agree."""
    from control_toolkit_tpu.costs.base import CostFunction as JaxCostFunction

    from control_toolkit_tpu_torch.costs.base import CostFunction

    def tracked(Base, lib):
        class Tracking(Base):
            def _get_stage_cost(self, states, inputs, previous_input, params):
                steps = lib.arange(states.shape[1], dtype=states.dtype)
                return (states[..., 0] - 0.1 * steps[None]) ** 2 + 0.1 * inputs[..., 0] ** 2

            def get_terminal_cost(self, terminal_states, params):
                return 3.0 * (terminal_states ** 2).sum(-1)

        return Tracking()

    jnet = jax_value_net(10)
    jw = jvt.ValueTerminalCost(tracked(JaxCostFunction, jnp), jnet, value_scale=2.0)
    pw = ValueTerminalCost(tracked(CostFunction, torch), port_net(jnet), value_scale=2.0)
    assert pw.supports_fused_rollout == pw.base.supports_fused_rollout is False
    rng = np.random.default_rng(4)
    states = rng.normal(size=(8, 5, 4)).astype(np.float32)
    inputs = rng.normal(size=(8, 5, 1)).astype(np.float32)
    term = rng.normal(size=(8, 4)).astype(np.float32)
    pp, jp = pw.current_params(), jw.current_params()
    np.testing.assert_allclose(
        pw._get_stage_cost(torch.tensor(states), torch.tensor(inputs), None, pp).numpy(),
        np.asarray(jw._get_stage_cost(jnp.asarray(states), jnp.asarray(inputs), None, jp)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pw.get_terminal_cost(torch.tensor(term), pp).numpy(),
                               np.asarray(jw.get_terminal_cost(jnp.asarray(term), jp)),
                               rtol=1e-5, atol=1e-5)


def test_attach_twice_updates_instead_of_nesting():
    _, pctrl = mppi_pair(32, 8)
    jnet = jax_value_net(14)
    w1 = attach_value_terminal(pctrl, port_net(jnet), value_scale=1.0)
    epoch = pctrl.optimizer._build_epoch
    w2 = attach_value_terminal(pctrl, {k: 0.5 * v for k, v in port_net(jnet).items()},
                               value_scale=2.0)
    assert w1 is w2 and not isinstance(w2.base, ValueTerminalCost)
    assert w2.value_scale == 2.0 and pctrl._cost_params is None
    assert pctrl.optimizer._build_epoch == epoch  # updated in place: nothing rebuilt
    with pytest.raises(ValueError, match="nest"):
        ValueTerminalCost(w2, port_net(jnet))


def test_hot_reload_flag_delegates_through_wrapper():
    """The YAML watcher raises the flag on the base it registered before
    the wrap; the CostFunctionWrapper sees and consumes it through V."""
    _, pctrl = mppi_pair(32, 8)
    vt = attach_value_terminal(pctrl, port_net(jax_value_net(30)))
    assert pctrl.cost_function.update_cost_parameters_from_config() is False
    vt.base.reload_cost_parameters_from_config_flag = True
    assert vt.reload_cost_parameters_from_config_flag is True
    assert pctrl.cost_function.update_cost_parameters_from_config() is True
    assert vt.base.reload_cost_parameters_from_config_flag is False


def test_value_survives_reconfigure_with_latest_net():
    """configure() builds a new cost; the hook wraps it with the current
    net (after update_value_params) and scale, and a second attach's."""
    from test_torch_mppi import optimizer_config

    _, pctrl = mppi_pair(32, 8)
    net1 = port_net(jax_value_net(31))
    attach_value_terminal(pctrl, net1, value_scale=2.0)
    net2 = {k: v + 1.0 for k, v in net1.items()}
    update_value_params(pctrl, net2)
    pctrl.configure(optimizer_name="mppi", optimizer_config=optimizer_config(32, 8))
    inner = pctrl.cost_function.cost_function
    assert isinstance(inner, ValueTerminalCost) and inner.value_scale == 2.0
    assert all(torch.equal(inner.value_params[k], net2[k]) for k in net2)
    net3 = {k: v - 0.25 for k, v in net1.items()}
    attach_value_terminal(pctrl, net3, value_scale=1.5)
    pctrl.configure(optimizer_name="mppi", optimizer_config=optimizer_config(32, 8))
    inner = pctrl.cost_function.cost_function
    assert inner.value_scale == 1.5
    assert all(torch.equal(inner.value_params[k], net3[k]) for k in net3)
    assert pctrl.optimizer._post_terminal_fn() is not None


def test_attach_and_hot_swap_on_controller():
    """attach builds the step once; update_value_params swaps a re-fit in
    with nothing rebuilt, and the new net reaches the next step."""
    _, pctrl = mppi_pair(64, 10)
    popt = pctrl.optimizer
    s = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    epoch, builds = popt._build_epoch, kernels.build.count
    net = port_net(jax_value_net(8))
    attach_value_terminal(pctrl, net, value_scale=5.0)
    assert popt._build_epoch == epoch + 1
    state = popt.opt_state
    u1 = pctrl.step(s)
    popt.opt_state = popt.opt_state._replace(u_nom=state.u_nom, u_prev=state.u_prev)
    update_value_params(pctrl, {k: v + 0.5 for k, v in net.items()})
    eps = popt.sample_noise(popt.opt_state)
    popt.sample_noise = lambda st: eps
    u2 = pctrl.step(s)
    assert popt._build_epoch == epoch + 1 and kernels.build.count == builds
    assert np.all(np.isfinite(u1)) and np.all(np.isfinite(u2)) and not np.allclose(u1, u2)
    _, plain = mppi_pair(32, 8)
    with pytest.raises(ValueError, match="attach_value_terminal first"):
        update_value_params(plain, net)


def batched_fleet(**extra):
    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"device": "cpu", "optimizer": "mppi",
                                        "controller_logging": False})
    ctrl.configure(optimizer_name="mppi", optimizer_config=optimizer_config(32, 8, **extra),
                   num_slots=2)
    return ctrl


def test_attach_value_terminal_batched_controller():
    """On a batched-mpc controller attach configures again from the stashed
    call (the batched step is built against V, K4's emit_terminal form),
    V reaches the fleet's objective and survives a re-configure."""
    plain, valued = batched_fleet(), batched_fleet()
    vt = attach_value_terminal(valued, port_net(jax_value_net(13)), value_scale=8.0)
    assert isinstance(vt, ValueTerminalCost) and valued.cost_function.cost_function is vt
    assert valued._batched_kernel_eligible()
    s = np.tile(np.array([0.4, 0.0, 0.3, 0.0], np.float32), (2, 1))
    u_plain, u_valued = plain.step_batch(s), valued.step_batch(s)
    assert np.all(np.isfinite(u_valued)) and not np.allclose(u_plain, u_valued)
    args, kwargs = valued._configure_stash
    valued.configure(*args, **kwargs)
    assert isinstance(valued.cost_function.cost_function, ValueTerminalCost)
    np.testing.assert_allclose(valued.step_batch(s), u_valued, atol=1e-6)


# ---- the forms' plain versions against the JAX kernels (interpret mode) -------------
@pytest.fixture(scope="module")
def valued_pair():
    """JAX and port MPPI controllers (K=256, H=20) with one value net."""
    jctrl, pctrl = mppi_pair()
    attach_both(jctrl, pctrl, jax_value_net(6, hiddens=(16, 8)))
    return (jctrl, pctrl) + both_params(jctrl)


def operands(seed: int, K_=K, H_=H):
    rng = np.random.default_rng(seed)
    s_tiled = np.tile(rng.uniform(-0.3, 0.3, (1, 4)).astype(np.float32), (K_, 1))
    Q = rng.uniform(-1.0, 1.0, (K_, H_, 1)).astype(np.float32)
    return s_tiled, Q, np.array([0.25], np.float32)


def test_k1_emit_plain_matches_pallas_interpret(valued_pair):
    """K1's emit_terminal form: its plain version's costs and terminal states
    against the JAX kernel's (``emit_terminal=True``, interpret mode), and
    the valued cost (V outside the kernel) against the JAX package's
    kernel path and its fused loop (test_value_terminal.py:154)."""
    from control_toolkit_tpu.ops.pallas_rollout import build_cost_rollout_kernel

    jctrl, pctrl, jparams, params = valued_pair
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    keys, jpack, derivs, stage, terminal, jpred = jopt._soa_bindings()
    kernel = build_cost_rollout_kernel(
        derivs, stage, terminal, num_states=4, num_controls=1, horizon=H, dt=jpred.dt,
        param_keys=keys, integrator=jpred.integrator, intermediate_steps=jpred.intermediate_steps,
        tile_k=TILE, interpret=True, emit_terminal=True)
    s_tiled, Q, u_prev = operands(11)
    ref_cost, ref_x = kernel(jnp.asarray(s_tiled), jnp.asarray(Q),
                             jpack(jparams, jnp.asarray(u_prev)))
    model, pack = ode.rollout_model(popt)
    before = cost_rollout_emit.launches
    cost, x = cost_rollout_emit(model, torch.tensor(s_tiled), torch.tensor(Q),
                                pack(params, torch.tensor(u_prev)))
    assert cost_rollout_emit.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **COST_TOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), **STATE_TOL)
    assert torch.equal(cost, cost_rollout_plain(model, torch.tensor(s_tiled), torch.tensor(Q),
                                                pack(params, torch.tensor(u_prev))))
    got = ode.build_cost(popt)(torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev),
                               params)
    j_kernel = jopt._build_pallas_cost(interpret=True, tile_k=TILE)
    for ref in (j_kernel(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev), jparams),
                jopt._fused_cost(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev),
                                 jparams)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **COST_TOL)


def test_k2_emit_plain_matches_pallas_semi_fused_interpret(valued_pair):
    """K2's emit_terminal form against the JAX kernel ``kernel1_ext_emit``
    (``make_run.external(K, emit_terminal=True)``): the tiles' rollout
    t*tile + r*C + c is the port's rollout k, its x_H row k."""
    from control_toolkit_tpu.ops.pallas_mppi import ROWS

    jctrl, pctrl, jparams, params = valued_pair
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    _, jpack, _ = jopt._build_fused_mppi(interpret=True, tile_k=TILE, build_step=False)
    run = jopt._last_fused_make_run.external(K, emit_terminal=True)
    P, U, S = jopt.interp.number_of_interpolation_inducing_points, 1, 4
    T, C = K // TILE, TILE // ROWS
    rng = np.random.default_rng(5)
    eps_tiles = (rng.standard_normal((T, U, P * ROWS, C)) * jopt.SQRTRHODTINV).astype(np.float32)
    s0 = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_nom = rng.uniform(-0.3, 0.3, (H, U)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    costs2d, xterm = run(jnp.asarray(s0), jnp.asarray(u_nom), jpack(jparams, jnp.asarray(u_prev)),
                         jnp.asarray(eps_tiles))
    ref = np.asarray(costs2d).reshape(ROWS, T, C).transpose(1, 0, 2).reshape(K)
    ref_x = np.asarray(xterm).reshape(S, ROWS, T, C).transpose(2, 1, 3, 0).reshape(K, S)
    eps = eps_tiles.reshape(T, U, P, ROWS, C).transpose(2, 1, 0, 3, 4).reshape(P, U, K)
    model, pack = ode.rollout_model(popt)
    args = (model, torch.tensor(s0), torch.tensor(u_nom), pack(params, torch.tensor(u_prev)),
            torch.tensor(eps), popt.interp.matrix, popt.action_low, popt.action_high,
            popt.cc_weight, popt.R, popt.NU)
    cost, x = mppi_cost_emit(*args)
    np.testing.assert_allclose(cost.numpy(), ref, **COST_TOL)
    np.testing.assert_allclose(x.numpy(), ref_x, **STATE_TOL)
    assert torch.equal(cost, mppi_cost_plain(*args))


@pytest.mark.parametrize("extra,semi_fused", [({}, True), ({"semi_fused": False}, False),
                                              ({"fully_fused": True}, True),
                                              ({"weighting": "rank:0.3"}, True)])
def test_one_valued_mppi_step_matches_jax(extra, semi_fused):
    """One MPPI update with V fed JAX's draw: semi-fused over K2's
    emit_terminal form (V before the weights), modular over K1's, and a
    valued fully-fused MPPI on the semi-fused path, as the JAX gate sends
    it (test_value_terminal.py:207)."""
    jctrl, pctrl = mppi_pair(**extra)
    attach_both(jctrl, pctrl, jax_value_net(9), scale=4.0)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    popt.fused_tile_k = 128
    popt._build()
    assert popt._uses_semi_fused() == semi_fused and not popt._can_fully_fuse()
    set_shared_state(jopt, popt)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    delta = jax_next_draw(jopt)
    u_jax = jctrl.step(s)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    before = (mppi_cost_emit.launches, cost_rollout_emit.launches)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                                 port_noise(popt, delta))
    assert (mppi_cost_emit.launches, cost_rollout_emit.launches) == before
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


def test_valued_fully_fused_mppi_leaves_k3():
    """Unvalued, the fully-fused gate admits K3 (at a 128-rollout tile);
    with V it does not, and the step is semi-fused (JAX mppi.py:362-365)."""
    _, pctrl = mppi_pair(256, 10, fully_fused=True)
    popt = pctrl.optimizer
    popt.fused_tile_k = 128
    popt._build()
    assert popt._can_fully_fuse()
    attach_value_terminal(pctrl, port_net(jax_value_net(1)))
    assert not popt._can_fully_fuse() and popt._uses_semi_fused()
    assert popt._noise_shape is not None


@pytest.mark.parametrize("fused", [False, True])
def test_one_valued_cem_step_matches_jax(fused):
    """One CEM step with V fed JAX's draws: modular over K1's emit_terminal
    form; with ``fully_fused`` too, as the JAX gate leaves K5 for a valued
    cost (cem.py:162)."""
    from test_torch_cem import cem_config, jax_draws
    from test_torch_cem import make_pair as cem_pair
    from test_torch_cem import set_shared_state as cem_state

    jctrl, pctrl = cem_pair(**cem_config(fully_fused=fused))
    attach_both(jctrl, pctrl, jax_value_net(12), scale=3.0)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    popt.fused_tile_k = 64
    popt._build()
    assert not popt._fused and not jopt._can_fully_fuse()
    cem_state(jopt, popt, 1)
    draws = jax_draws(jopt, 2, False)
    jparams, params = both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]),
                               **COST_TOL)
    np.testing.assert_allclose(st.dist_mue.numpy(), np.asarray(st_j.dist_mue), **UNOM_TOL)
    np.testing.assert_allclose(st.stdev.numpy(), np.asarray(st_j.stdev), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)


def test_one_valued_icem_step_matches_jax():
    from control_toolkit_tpu_torch.optimizers.icem import ICEMState
    from test_torch_cem import make_pair as cem_pair
    from test_torch_zoo import icem_config, jax_white

    jctrl, pctrl = cem_pair("icem-tf", **icem_config())
    attach_both(jctrl, pctrl, jax_value_net(15), scale=3.0)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    Hh, n_keep, n_fresh = popt.mpc_horizon, popt.n_keep, popt._n_fresh
    rng = np.random.default_rng(4)
    mue = rng.uniform(-0.4, 0.4, (1, Hh, 1)).astype(np.float32)
    std = rng.uniform(0.2, 0.6, (1, Hh, 1)).astype(np.float32)
    elites = rng.uniform(-0.8, 0.8, (n_keep, Hh, 1)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    jopt.opt_state = jopt.opt_state._replace(
        dist_mue=jnp.asarray(mue), stdev=jnp.asarray(std), elites=jnp.asarray(elites),
        count=jnp.asarray(1, jnp.int32), u_prev=jnp.asarray(u_prev))
    popt.opt_state = ICEMState(popt.opt_state.generator, torch.tensor(mue), torch.tensor(std),
                               torch.tensor(elites), 1, torch.tensor(u_prev))
    key, draws = jopt.opt_state.key, []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(torch.tensor(jax_white(sub, Hh, (n_fresh, 1))))
    jparams, params = both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]),
                               **COST_TOL)
    for name in ("dist_mue", "stdev", "elites"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)


@pytest.mark.parametrize("count", [10, 7])
def test_one_valued_rpgd_update_matches_jax(count):
    """One rpgd-tf update with V (a resample tick, a keep tick): the port's
    gradient is K7's value_spec form (its plain version), the JAX step's
    jax.grad through the rollout with V in it."""
    from test_torch_rpgd import (
        assert_rpgd_states_match, jax_rpgd_draw, port_params, rpgd_config, set_rpgd_state,
    )
    from test_torch_rpgd import make_pair as rpgd_pair

    jctrl, pctrl = rpgd_pair("rpgd-tf", rpgd_config())
    attach_both(jctrl, pctrl, jax_value_net(21), scale=3.0)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert ode.can_use_grad(popt) and popt._value_grad_spec() == {"n_layers": 2}
    set_rpgd_state(jopt, popt, count)
    s = np.array([0.1, -0.05, 0.2, 0.3], np.float32)
    draw = torch.as_tensor(jax_rpgd_draw(jopt)) if count % 10 == 0 else None
    u_jax = jctrl.step(s)
    before = grad_cost_rollout_value.launches
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], port_params(jctrl),
                                 draw)
    assert grad_cost_rollout_value.launches == before
    assert_rpgd_states_match(jopt, state, diag, u, u_jax)


def test_one_valued_gradient_update_matches_jax():
    from test_torch_rpgd import (
        Q_TOL, gradient_config, jax_adam, jax_resample_key, port_params, shared_population,
    )
    from test_torch_rpgd import COST_TOL as RPGD_COST_TOL
    from test_torch_rpgd import MOMENT_TOL
    from test_torch_rpgd import make_pair as rpgd_pair

    from control_toolkit_tpu_torch.utils.convert import gradient_state_from_numpy

    jctrl, pctrl = rpgd_pair("gradient-tf", gradient_config())
    attach_both(jctrl, pctrl, jax_value_net(22), scale=3.0)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    st = shared_population(jopt, seed=4)
    jopt.opt_state = jopt.opt_state._replace(Q=jnp.asarray(st["Q"]), adam=jax_adam(st),
                                             count=jnp.int32(5),
                                             u_prev=jnp.asarray(st["u_prev"]))
    popt.opt_state = gradient_state_from_numpy(st["Q"], st["m"], st["v"], st["adam_step"], 5,
                                               st["u_prev"], popt.opt_state.generator)
    Kg = jopt.num_rollouts
    tail = np.array(jax.random.uniform(jax_resample_key(jopt), (Kg, 1, 1),
                                       minval=jopt.action_low, maxval=jopt.action_high,
                                       dtype=jnp.float32))
    s = np.array([0.1, -0.05, 0.2, 0.3], np.float32)
    u_jax = jctrl.step(s)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], port_params(jctrl),
                                 torch.as_tensor(tail))
    js = jopt.opt_state
    np.testing.assert_allclose(diag["J_logged"].numpy(), jopt.logging_values["J_logged"],
                               **RPGD_COST_TOL)
    np.testing.assert_allclose(state.Q.numpy(), np.asarray(js.Q), **Q_TOL)
    np.testing.assert_allclose(state.adam.m.numpy(), np.asarray(js.adam.m), **MOMENT_TOL)
    np.testing.assert_allclose(state.adam.v.numpy(), np.asarray(js.adam.v), **MOMENT_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **Q_TOL)


def test_k7_value_plain_matches_pallas_grad_interpret():
    """K7's value_spec form against the JAX gradient kernel with V in it
    (interpret mode), then the same port function after a hot swap of V
    (test_value_terminal.py:663): J and dQ to the gradient bound."""
    from test_torch_rpgd import make_pair as rpgd_pair
    from test_torch_rpgd import rpgd_config

    jctrl, pctrl = rpgd_pair("rpgd-tf", rpgd_config())
    attach_both(jctrl, pctrl, jax_value_net(23), scale=3.0)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    jkernel, kernel = jopt._build_pallas_grad(interpret=True, tile_k=TILE), ode.build_grad(popt)
    s_tiled, Q, u_prev = operands(12, jopt.num_rollouts, jopt.mpc_horizon)
    args = (jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev))

    def check():
        jparams, params = both_params(jctrl)
        ref_cost, ref_dq = jkernel(*args, jparams)
        cost, dq = kernel(torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev), params)
        np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **COST_TOL)
        np.testing.assert_allclose(dq.numpy(), np.asarray(ref_dq), **GRAD_TOL)
        return dq

    dq1 = check()
    swapped = jax_value_net(24)
    jvt.update_value_params(jctrl, jax.tree_util.tree_map(jnp.asarray, swapped))
    update_value_params(pctrl, port_net(swapped))
    assert not torch.allclose(dq1, check())


def test_value_grad_spec_rejects_exotic_nets_and_autograd_takes_them():
    """Only a plain w*/b* net rides K7's value_spec form; a net with norms
    takes torch.autograd through the fused loop, where V takes part, and
    its gradient is the JAX package's XLA-AD one (test_value_terminal.py:704)."""
    from test_torch_rpgd import make_pair as rpgd_pair
    from test_torch_rpgd import rpgd_config

    jctrl, pctrl = rpgd_pair("rpgd-tf", rpgd_config())
    jnet = dict(jax_value_net(25), norm_in_mean=np.zeros(4, np.float32))
    attach_both(jctrl, pctrl, jnet)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt._value_grad_spec() is None and jopt._value_grad_spec() is None
    assert ode.can_use_cost(popt) and not ode.can_use_grad(popt)
    grad_fn, _ = popt._make_grad_and_cost_only()
    s_tiled, Q, u_prev = operands(13, jopt.num_rollouts, jopt.mpc_horizon)
    jparams, params = both_params(jctrl)
    ref = jax.grad(lambda q: jnp.sum(jopt._fused_cost(jnp.asarray(s_tiled), q,
                                                      jnp.asarray(u_prev), jparams)))(
        jnp.asarray(Q))
    before = grad_cost_rollout_value.launches
    got = grad_fn(torch.tensor(Q), torch.tensor(s_tiled), torch.tensor(u_prev), params)
    assert grad_cost_rollout_value.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


def test_value_mlp_vjp_matches_autograd_in_float64():
    """The hand-written tanh-MLP VJP of K7's value_spec form (V and ct *
    dV/dx) against torch.autograd, in float64, for one, two and three
    layers."""
    g = torch.Generator().manual_seed(0)
    for dims in ((4, 1), (4, 16, 1), (4, 32, 8, 1)):
        ops = []
        for fi, fo in zip(dims[:-1], dims[1:]):
            ops += [torch.randn(fi, fo, generator=g, dtype=torch.float64),
                    torch.randn(fo, generator=g, dtype=torch.float64)]
        x = torch.randn(32, 4, generator=g, dtype=torch.float64, requires_grad=True)
        ct = 1.0 / 51
        net = {f"{c}{i}": ops[2 * i + (c == "b")] for i in range(len(ops) // 2) for c in "wb"}
        v_ref = nets.mlp_apply(net, x)[:, 0]
        (g_ref,) = torch.autograd.grad(v_ref.sum() * ct, x)
        v, gx = value_mlp_vjp(ops, x.detach(), ct)
        torch.testing.assert_close(v, v_ref.detach(), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(gx, g_ref, rtol=1e-12, atol=1e-12)


def test_k7_value_plain_gradient_matches_autograd_through_k1_emit():
    """K7's value_spec plain version's J and dQ against torch.autograd
    through K1's emit_terminal plain version plus V over H+1, in float64."""
    _, pctrl = mppi_pair(64, 12)
    model, pack = ode.rollout_model(pctrl.optimizer)
    g = torch.Generator().manual_seed(1)
    s0 = 0.1 * torch.randn(64, 4, generator=g, dtype=torch.float64)
    Q = (2 * torch.rand(64, 12, 1, generator=g, dtype=torch.float64) - 1).requires_grad_(True)
    pvec = pack(pctrl._assemble_params(), torch.tensor([0.1])).double()
    ops = [t.double() for t in (torch.randn(4, 8, generator=g), torch.randn(8, generator=g),
                                torch.randn(8, 1, generator=g), torch.randn(1, generator=g))]
    net = {"w0": ops[0], "b0": ops[1], "w1": ops[2], "b1": ops[3]}
    cost, x = cost_rollout_emit_plain(model, s0, Q, pvec)
    ref = cost + nets.mlp_apply(net, x)[:, 0] / 13
    (ref_dq,) = torch.autograd.grad(ref.sum(), Q)
    got, dq = grad_cost_rollout_plain(model, s0, Q.detach(), pvec, ops)
    torch.testing.assert_close(got, ref.detach(), rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dq, ref_dq, rtol=1e-9, atol=1e-9)


# ---- the fleet --------------------------------------------------------------------
def test_valued_fleet_update_and_k4_emit_match_jax():
    """K4's emit_terminal form's plain version against the JAX kernel
    ``kernel1_cols_emit`` (``make_run.cols(B*K, emit_terminal=True)``,
    interpret mode, its x_H through ``xterm_from_tiles``), and one batched
    MPPI update with V against JAX's, fed the same noise: each session's
    V(x_H)/(H+1) joins its costs before its softmax (test_value_terminal.py:472)."""
    from test_torch_fleet import B as FB
    from test_torch_fleet import COST_TOL as FLEET_COST_TOL
    from test_torch_fleet import H as FH
    from test_torch_fleet import K as FK
    from test_torch_fleet import ROWS, fleet_inputs, jax_params
    from test_torch_fleet import TILE as FTILE
    from test_torch_fleet import UNOM_TOL as FLEET_UNOM_TOL
    from test_torch_fleet import port_params as fleet_port_params

    from control_toolkit_tpu.optimizers.base import make_slot_packer as jax_slot_packer
    from control_toolkit_tpu.optimizers.mppi import MPPIState as JaxMPPIState
    from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
    from control_toolkit_tpu_torch.optimizers.mppi import MPPIState

    jctrl, pctrl = mppi_pair(FK, FH)
    attach_both(jctrl, pctrl, jax_value_net(41), scale=4.0)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = fleet_inputs(jopt, seed=13)
    cps, T, C = FK // ROWS, (FB * FK) // FTILE, FTILE // ROWS
    _, _, make_run = jopt._build_fused_mppi(build_step=False, interpret=True, tile_k=FTILE,
                                            slot_extra_keys=("d_L",))
    jp = jax_params(jctrl)
    jpack = jax_slot_packer(make_run.shared_keys, make_run.slot_keys,
                            jopt.cost_function.cost_function.attr_defaults, FB)
    pvec, rows = jpack(jnp.asarray(x["u_prev"]), dict(jp["dyn"], L=jnp.asarray(x["L"])),
                       jp["cost"], {"target_position": jnp.asarray(x["target"])})

    def expand_cols(vals):
        return jnp.repeat(vals, cps, axis=0).reshape(T, C, vals.shape[1]).transpose(0, 2, 1)

    u_nom = np.concatenate([x["u_nom"][:, 0, 1:], x["u_nom"][:, 0, -1:]], axis=1)
    costs2d, xterm = make_run.cols(FB * FK, emit_terminal=True)(
        pvec, expand_cols(jnp.asarray(x["s"][:, 0])),
        expand_cols(jnp.asarray(u_nom.transpose(0, 2, 1).reshape(FB, -1))), expand_cols(rows),
        jnp.asarray(x["eps"]))
    ref = np.asarray(costs2d).reshape(ROWS, FB, cps).transpose(1, 0, 2).reshape(FB, FK)
    model, _ = ode.rollout_model(popt)
    _, slot_keys = split_slot_keys(model.param_keys, ("L",))
    pp = fleet_port_params(jctrl)
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, FB, CPU)(
        torch.tensor(x["u_prev"]), dict(pp["dyn"], L=torch.tensor(x["L"])), pp["cost"],
        {"target_position": torch.tensor(x["target"])})
    eps = eps_from_tiles(torch.tensor(x["eps"]), FB)
    args = (model, torch.tensor(x["s"][:, 0]), torch.tensor(u_nom), pvec_b, eps,
            popt.interp.matrix, popt.action_low, popt.action_high, popt.cc_weight, popt.R, popt.NU)
    cost, xh = mppi_cost_cols_emit(*args)
    np.testing.assert_allclose(cost.numpy(), ref, **FLEET_COST_TOL)
    np.testing.assert_allclose(xh.numpy(),
                               xterm_from_tiles(torch.tensor(np.asarray(xterm)), FB).numpy(),
                               **STATE_TOL)
    assert torch.equal(cost, mppi_cost_cols_plain(*args))

    _, jupdate = jopt._make_batched_semi_fused_step(FB, interpret=True, tile_k=FTILE,
                                                    per_slot_dyn=("L",))
    _, update = popt._make_batched_semi_fused_step(FB, per_slot_dyn=("L",))
    jstates = JaxMPPIState(key=jnp.zeros((FB, 2), jnp.uint32), u_nom=jnp.asarray(x["u_nom"]),
                           u_prev=jnp.asarray(x["u_prev"]))
    u_ref, c_ref = jupdate(jstates, jnp.asarray(x["s"]), dict(jp["dyn"], L=jnp.asarray(x["L"])),
                           jp["cost"], {"target_position": jnp.asarray(x["target"])},
                           jnp.asarray(x["eps"]))
    states = MPPIState(generator=(None,) * FB, u_nom=torch.tensor(x["u_nom"]),
                       u_prev=torch.tensor(x["u_prev"]))
    before = mppi_cost_cols_emit.launches
    u_new, costs = update(states, torch.tensor(x["s"]), dict(pp["dyn"], L=torch.tensor(x["L"])),
                          pp["cost"], {"target_position": torch.tensor(x["target"])}, eps)
    assert mppi_cost_cols_emit.launches == before
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_ref), **FLEET_COST_TOL)
    np.testing.assert_allclose(u_new.numpy(), np.asarray(u_ref), **FLEET_UNOM_TOL)
    assert not np.allclose(costs.numpy(), ref)  # V reached the fleet's costs


def test_xterm_from_tiles_follows_the_session_columns():
    """Session b's rollout k = r*(K/8) + cw reads the JAX layout's x_H at
    [:, r, b*K/8 + cw]."""
    Bc, Kc, S = 3, 16, 4
    cps = Kc // 8
    xt = torch.arange(S * 8 * Bc * cps, dtype=torch.float32).reshape(S, 8, Bc * cps)
    x = xterm_from_tiles(xt, Bc)
    for b, r, cw, i in ((0, 0, 0, 0), (1, 7, 1, 3), (2, 3, 0, 2)):
        assert x[b, r * cps + cw, i] == xt[i, r, b * cps + cw]


# ---- the gates and the refusals ------------------------------------------------------
LEARNED = {
    "mlp": ("neural:mlp-16", "neural", "K8's value_spec form"),
    "gru": ("neural:GRU-5IN-8H1-4OUT", "neural", None),
    "gp": (f"SGP_128:{ASSETS}/SGP_128.npz", "gp", "K10's value_spec form"),
    "residual": ("ODE+res", "residual", "K9's value_spec form"),
    "ensemble": (f"ensemble:mlp-32-32:4:{ASSETS}", "ensemble",
                 "value_spec form of K8's member-block"),
}


@pytest.mark.parametrize("kind", list(LEARNED))
def test_a_valued_learned_model_raises_naming_the_form(kind):
    """A learned model under a cost with a post hook: MPPI builds its
    family's emit_terminal form (tests/test_torch_value_learned.py holds it
    to the JAX kernel), whose valued cost equals the trajectory path's with
    V in its terminal cost; rpgd-tf's gradient gate admits the plain tanh-MLP
    V and builds the family's value_spec form (the value form named in the
    table), whose gradient equals the JAX package's (jax.grad through its
    rollout with V in the terminal cost, from the JAX controller's weights),
    except over a recurrent net, whose gradient takes autograd as the JAX
    package's takes XLA-AD."""
    from control_toolkit_tpu_torch.optimizers import kernel_families

    spec, family, grad_form = LEARNED[kind]
    jnet = jax_value_net(3)
    net = port_net(jnet)
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": 8, "num_rollouts": 32,
           "period_interpolation_inducing_points": 4}
    for optimizer, form in (("mppi", None), ("rpgd-tf", grad_form)):
        ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                             config={"device": "cpu", "optimizer": optimizer,
                                     "controller_logging": False})
        ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                       optimizer_config=cfg)
        popt = ctrl.optimizer
        fam = getattr(kernel_families, family)
        rng = np.random.default_rng(6)
        s_tiled = torch.tensor(rng.uniform(-0.2, 0.2, (1, 4)), dtype=torch.float32).expand(32, 4)
        Q = torch.tensor(rng.uniform(-1, 1, (32, 8, 1)), dtype=torch.float32)
        u_prev = torch.tensor([0.1])
        if form is not None:
            jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.0},
                           config={"optimizer": optimizer, "controller_logging": False})
            jctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                            optimizer_config=cfg)
            attach_both(jctrl, ctrl, jnet)
            assert fam.can_use_grad(popt) and popt._value_grad_spec() == {"n_layers": 2}
            jparams, params = both_params(jctrl)
            jopt = jctrl.optimizer
            ref = jax.grad(lambda q: jnp.sum(jopt._fused_cost(
                jnp.asarray(s_tiled.numpy()), q, jnp.asarray(u_prev.numpy()), jparams)))(
                jnp.asarray(Q.numpy()))
            got = popt._make_grad_and_cost_only()[0](Q, s_tiled, u_prev, params)
            # The GP's gradients: its kernel tests' bound (test_torch_gp.py GRAD_TOL).
            tol = dict(rtol=2e-3, atol=5e-4) if kind == "gp" else GRAD_TOL
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
            continue
        attach_value_terminal(ctrl, net)
        if optimizer == "rpgd-tf":  # a recurrent net's gradient takes autograd, V in it
            assert not fam.can_use_grad(popt)
            continue
        assert fam.can_use_cost(popt)
        params = ctrl._assemble_params()
        got = popt._make_cost_only()(s_tiled, Q, u_prev, params)
        ref = popt._rollout_and_cost(s_tiled, Q, u_prev, params)[0]
        # The committed GP's mean cancels in float32: the GP kernel tests'
        # own bound (tests/test_torch_gp.py COST_TOL).
        tol = dict(rtol=1e-3, atol=1e-5) if kind == "gp" else COST_TOL
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **tol)


FLEET_CONFIGS = {
    "cem-tf": {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": 8, "num_rollouts": 64,
               "cem_outer_it": 2, "cem_best_k": 8, "cem_initial_action_stdev": 0.5,
               "cem_stdev_min": 0.01, "warmup": False, "fully_fused": True},
    "rpgd-tf": {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": 8, "num_rollouts": 32,
                "outer_its": 2, "SAMPLING_DISTRIBUTION": "uniform",
                "period_interpolation_inducing_points": 4, "learning_rate": 0.05,
                "gradmax_clip": 5, "opt_keep_k_ratio": 0.25, "resamp_per": 10,
                "sample_stdev": 0.5, "warmup": False},
    "gradient-tf": {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": 8, "num_rollouts": 32,
                    "gradient_steps": 2, "learning_rate": 0.05, "gradmax_clip": 5,
                    "warmup": False},
}


def fleet(optimizer="mppi", spec="ODE"):
    cfg = FLEET_CONFIGS.get(optimizer) or optimizer_config(32, 8)
    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"device": "cpu", "optimizer": optimizer,
                                        "controller_logging": False})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config=dict(cfg), num_slots=2)
    return ctrl


@pytest.mark.parametrize("kind,match", [
    ("cem_fused", "CEM fleet"), ("gru", "vmapped per-slot"),
    ("rpgd", "vmapped per-slot"), ("gradient", "recurrent predictors")])
def test_valued_fleets_without_their_form_are_refused(kind, match):
    """A valued gradient-tf fleet over a recurrent net is the JAX binder's
    ValueError, and the batched steps without a value form refuse a value
    terminal as JAX's do (K6's fused CEM step, K13's recurrent MPPI step, the
    RPGD binder under a V with norms).  Those fleets (a valued fully-fused
    CEM fleet, a valued MPPI fleet over a recurrent net, as
    batched_mpc.py:500-504 sends it, an RPGD fleet whose post hook is not a
    plain tanh-MLP V, as batched_mpc.py:578-582 sends it) take the per-slot
    step, each active slot equal to its single-session controller bit for
    bit; the MPPI fleets over the ODE (test_attach_value_terminal_batched_controller),
    the MLP, "ODE+res" and the GP (tests/test_torch_value_learned.py) and
    the gradient fleets with a plain V (tests/test_torch_value_grad.py) take
    their value forms."""
    from test_torch_fleet_per_slot import assert_slots_equal_single

    if kind == "gradient":
        ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                             config={"device": "cpu", "optimizer": "gradient-tf",
                                     "controller_logging": False})
        ctrl.configure(optimizer_name="gradient-tf",
                       predictor_specification="neural:GRU-5IN-8H1-4OUT",
                       optimizer_config=dict(FLEET_CONFIGS["gradient-tf"]))
        attach_value_terminal(ctrl, port_net(jax_value_net(3)))
        with pytest.raises(ValueError, match=match):
            ctrl.optimizer._make_batched_gradient_step(2)
        return
    builds = {"cem_fused": lambda: fleet("cem-tf"),
              "gru": lambda: fleet(spec="neural:GRU-5IN-8H1-4OUT"),
              "rpgd": lambda: fleet("rpgd-tf")}
    ctrl = builds[kind]()
    net = jax_value_net(3)
    if kind == "rpgd":
        net = dict(net, norm_in_mean=np.zeros(4, np.float32))
    attach_value_terminal(ctrl, port_net(net))
    assert ctrl._per_slot and ctrl._kernel_kind() is None
    own_step = {"cem_fused": lambda opt: opt._make_batched_fused_cem_step(2),
                "gru": lambda opt: opt._make_batched_recurrent_step(2),
                "rpgd": lambda opt: opt._make_batched_rpgd_step(2)}[kind]
    with pytest.raises(NotImplementedError, match=match if kind != "cem_fused" else "value"):
        own_step(ctrl.optimizer)
    assert_slots_equal_single(ctrl)


# ---- the committed value net ------------------------------------------------------------
def test_committed_value_net_loads_in_both_packages():
    """The committed 4-32-32-1 V (fitted by the JAX package, make_assets):
    its meta records the recipe, the seed and the fit's MSE, and the
    port's V equals the JAX package's on the same states."""
    pnet, meta = nets.load_net(ASSETS / VALUE_FILE)
    jnet, jmeta = jnets.load_net(ASSETS / VALUE_FILE)
    assert meta == jmeta and {"recipe", "seed", "mse"} <= set(meta)
    assert [tuple(pnet[f"w{i}"].shape) for i in range(3)] == [(4, 32), (32, 32), (32, 1)]
    x = np.random.default_rng(0).normal(0.0, 0.3, (64, 4)).astype(np.float32)
    got = nets.mlp_apply({k: v.float() for k, v in pnet.items()}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnets.mlp_apply(jnet, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)


# ---- on a card -------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("form", ["k1_emit", "k2_emit", "k4_emit", "k7_value"])
def test_cuda_value_forms_match_plain_versions(valued_pair, cuda_device, form):
    """Each value form on the card against its plain version on the same
    card tensors (chip_smoke.py's bounds: KERNEL_TOL on costs, X_TOL on
    x_H, K7's dQ bound), its costs equal to its kernel's bit for bit."""
    from chip_smoke import DQ_ATOL_FRAC, DQ_RTOL, KERNEL_TOL, X_TOL, close, seeded_value

    _, pctrl, _, params = valued_pair
    popt = pctrl.optimizer
    model, pack = ode.rollout_model(popt)
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    Kc = 1000
    pvec = pack({k: v for k, v in params.items()}, torch.tensor([0.1])).to(dev)
    s0 = 0.05 * torch.randn(Kc, 4, generator=g, device=dev)
    Q = torch.clamp(0.3 * torch.randn(Kc, H, 1, generator=g, device=dev), -1.0, 1.0)
    if form == "k7_value":
        ops = seeded_value(dev)
        (c, d), (rc, rd) = (grad_cost_rollout_value(model, s0, Q, pvec, ops),
                            grad_cost_rollout_plain(model, s0, Q, pvec, ops))
        assert torch.allclose(c, rc, **KERNEL_TOL) and close(d, rd, DQ_RTOL, DQ_ATOL_FRAC)
        return
    if form == "k1_emit":
        args, emit, kernel, plain = ((model, s0, Q, pvec), cost_rollout_emit, cost_rollout,
                                     cost_rollout_emit_plain)
    else:
        P = popt.interp.number_of_interpolation_inducing_points
        W, low, high = (t.to(dev) for t in (popt.interp.matrix, popt.action_low,
                                            popt.action_high))
        u_nom = torch.clamp(0.2 * torch.randn(H, 1, generator=g, device=dev), -1.0, 1.0)
        consts = (W, low, high, popt.cc_weight, popt.R, popt.NU)
        if form == "k2_emit":
            eps = 0.3 * torch.randn(P, 1, Kc, generator=g, device=dev)
            args, emit, kernel, plain = ((model, s0[0].contiguous(), u_nom, pvec, eps) + consts,
                                         mppi_cost_emit, mppi_cost, mppi_cost_emit_plain)
        else:
            Bc = 3
            eps = 0.3 * torch.randn(Bc, P, 1, Kc, generator=g, device=dev)
            args, emit, kernel, plain = (
                (model, s0[:Bc].contiguous(), u_nom.expand(Bc, -1, -1).contiguous(),
                 pvec.expand(Bc, -1).contiguous(), eps) + consts,
                mppi_cost_cols_emit, mppi_cost_cols, mppi_cost_cols_emit_plain)
    (cost, x), (rc, rx) = emit(*args), plain(*args)
    assert torch.equal(cost, kernel(*args))
    assert torch.allclose(cost, rc, **KERNEL_TOL) and torch.allclose(x, rx, **X_TOL)


def make_assets(out_dir: Path = ASSETS) -> float:
    """Fit the committed value net with the JAX package (see VALUE_FIT) and
    save it with its ``save_net`` as ``value-mlp-32-32.npz``, the recipe,
    its seed and the fit's MSE in the meta; returns the MSE."""
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
    from control_toolkit_tpu.models.training import discounted_cost_to_go, fit_value_mlp

    states, targets = [], []
    for start in VALUE_STARTS:
        ctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.0},
                      config={"optimizer": "mppi", "controller_logging": False})
        ctrl.configure(optimizer_name="mppi", optimizer_config=dict(MAIN_CONFIG))
        cf = ctrl.cost_function.cost_function
        env = JaxCartpoleEnv(batch_size=1, dt=0.02, seed=0)
        env.reset()
        s = np.asarray([start], np.float32)
        env.state = jnp.asarray(s)
        u_prev, ep_states, ep_costs = np.zeros(1, np.float32), [], []
        for _ in range(VALUE_TICKS):
            u = np.asarray(ctrl.step(s[0]), np.float32)
            p = ctrl._assemble_params()
            ep_costs.append(float(cf.stage_cost_step(
                jnp.asarray(s[:1]), jnp.asarray(u[None]), jnp.asarray(u_prev[None]),
                {"cost": p["cost"], "attrs": p["attrs"]})[0]))
            ep_states.append(s[0].copy())
            s, *_ = env.step(u[None])
            s, u_prev = np.asarray(s, np.float32), u
        states.append(np.stack(ep_states))
        targets.append(discounted_cost_to_go(np.asarray(ep_costs), gamma=VALUE_GAMMA))
    params, mse = fit_value_mlp(np.concatenate(states), np.concatenate(targets), **VALUE_FIT)
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = {"recipe": "JAX MPPI (chip_smoke.py main-path config, K=%d) %d ticks from each "
                      "start (pos, 0, angle, angleD) of %s; discounted_cost_to_go(gamma=%g); "
                      "fit_value_mlp(%s)" % (VALUE_K, VALUE_TICKS, list(VALUE_STARTS),
                                             VALUE_GAMMA, VALUE_FIT),
            "seed": VALUE_FIT["seed"], "mse": float(mse),
            "n_samples": int(sum(len(x) for x in states))}
    jnets.save_net(out_dir / VALUE_FILE, jax.tree_util.tree_map(np.asarray, params), meta=meta)
    return float(mse)


def jax_value_loops(ticks: int = 100) -> dict:
    """The JAX package's MPPI over the committed value net from LOOP_START
    on the CPU, at chip_smoke.py's H=50 and H=10 configurations (K cut to
    VALUE_K): the largest |angle| over ``ticks`` ticks of each."""
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv

    net, _ = jnets.load_net(ASSETS / VALUE_FILE)
    out = {}
    for horizon in (50, 10):
        ctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.0},
                      config={"optimizer": "mppi", "controller_logging": False})
        ctrl.configure(optimizer_name="mppi",
                       optimizer_config=dict(MAIN_CONFIG, mpc_horizon=horizon))
        jvt.attach_value_terminal(ctrl, net)
        env = JaxCartpoleEnv(batch_size=1, dt=0.02, seed=0)
        env.reset()
        env.state = jnp.asarray(LOOP_START[None])
        s, worst = LOOP_START[None], 0.0
        for _ in range(ticks):
            s, *_ = env.step(np.asarray(ctrl.step(np.asarray(s)[0]))[None])
            worst = max(worst, abs(float(np.asarray(s)[0, 2])))
        out[f"H{horizon}_max_abs_angle"] = worst
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if "--loop" in sys.argv[1:]:
        print("jax_value_loops:", jax_value_loops())
    else:
        print("value net mse:", make_assets())
