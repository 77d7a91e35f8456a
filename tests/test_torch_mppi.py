"""The torch port's MPPI step and controller against the JAX package.

Both packages get the same inputs, made with numpy from a seed, and the
same noise: the JAX draws are taken by re-splitting the JAX optimizer's key
exactly as its modular step does (optimizers/mppi.py step_fn), and fed to
the port's ``update(state, s, params, eps)``.  On the CPU the JAX step is
its modular path over the fused scan; the port's semi-fused update (K2's
plain version) equals it by the linearity of interpolation, its modular
update (K1's plain version) term for term.  Parity is per step: long loops
diverge between float-different paths, so no test compares them.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.utils.convert import mppi_state_from_numpy, params_from_numpy

LIMITS = (np.array([-1.0], np.float32), np.array([1.0], np.float32))
CPU = torch.device("cpu")
# Costs: float32 sums over 20 rk4 steps; the update: softmax-weighted means.
COST_TOL = dict(rtol=3e-5, atol=1e-4)
UNOM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def optimizer_config(K=256, H=20, **extra):
    cfg = {
        "seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K,
        "cc_weight": 1.0, "R": 1.0, "LBD": 100.0, "NU": 1000.0,
        "SQRTRHOINV": 0.05, "period_interpolation_inducing_points": 5,
    }
    cfg.update(extra)
    return cfg


def make_jax_ctrl(K=256, H=20, logging=False, **extra):
    ctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.3},
                  config={"optimizer": "mppi", "controller_logging": logging})
    ctrl.configure(optimizer_name="mppi", optimizer_config=optimizer_config(K, H, **extra))
    return ctrl


def make_port_ctrl(K=256, H=20, logging=False, **extra):
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                         config={"device": "cpu",
                                 "optimizer": "mppi", "controller_logging": logging})
    ctrl.configure(optimizer_name="mppi", optimizer_config=optimizer_config(K, H, **extra))
    return ctrl


def jax_params_numpy(jctrl):
    return jax.tree_util.tree_map(np.asarray, jctrl._assemble_params())


def jax_next_draw(jopt):
    """The [K, P, U] noise the JAX modular step will draw next."""
    _, sample_key = jax.random.split(jopt.opt_state.key)
    K, U = jopt.num_rollouts, jopt.num_control_inputs
    P = jopt.interp.number_of_interpolation_inducing_points
    return np.asarray(
        jax.random.normal(sample_key, (K, P, U), dtype=jnp.float32) * jopt.SQRTRHODTINV
    )


def port_noise(popt, delta):
    """JAX's [K, P, U] draw in the layout the port's update reads."""
    eps = delta if popt._noise_shape == delta.shape else np.transpose(delta, (1, 2, 0))
    return torch.tensor(np.ascontiguousarray(eps))


def set_shared_state(jopt, popt, seed=0):
    """Both optimizers at one nonzero nominal plan and applied control."""
    rng = np.random.default_rng(seed)
    H, U = jopt.mpc_horizon, jopt.num_control_inputs
    u_nom = rng.uniform(-0.5, 0.5, (1, H, U)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    jopt.opt_state = jopt.opt_state._replace(u_nom=jnp.asarray(u_nom), u_prev=jnp.asarray(u_prev))
    popt.opt_state = mppi_state_from_numpy(u_nom, u_prev, popt.opt_state.generator)


@pytest.mark.parametrize("extra,semi_fused", [
    ({}, True),
    ({"semi_fused": False}, False),
    ({"bounded_update": True}, False),
    ({"weighting": "rank:0.3"}, True),
    ({"weighting": "topk", "semi_fused": False}, False),
])
def test_one_mppi_step_matches_jax(extra, semi_fused):
    jctrl, pctrl = make_jax_ctrl(**extra), make_port_ctrl(**extra)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt._uses_semi_fused() == semi_fused
    set_shared_state(jopt, popt)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    delta = jax_next_draw(jopt)

    u_jax = jctrl.step(s)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                                 port_noise(popt, delta))

    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)
    np.testing.assert_array_equal(state.u_prev.numpy(), u.numpy())


@pytest.mark.parametrize("weighting", ["softmax", "rank", "rank:0.25", "topk", "topk:0.5"])
def test_weight_fn_matches_jax(weighting):
    from control_toolkit_tpu.optimizers.mppi import make_weight_fn as jax_weight_fn
    from control_toolkit_tpu_torch.optimizers.mppi import make_weight_fn

    S = np.random.default_rng(4).uniform(0.0, 300.0, (3, 64)).astype(np.float32)
    for axes in ((1,), (0, 1)):
        ref = np.asarray(jax_weight_fn(weighting, 100.0)(jnp.asarray(S), axes))
        got = make_weight_fn(weighting, 100.0)(torch.as_tensor(S), axes).numpy()
        # exp/log of XLA and of torch differ by an ulp or two.
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)
    with pytest.raises(ValueError):
        make_weight_fn(weighting + ":2.0" if ":" not in weighting else "bogus", 100.0)


def test_controller_ticks_match_jax():
    """A few ticks through both controllers' step(), each fed the same state
    and the same noise; the plans carry over from tick to tick."""
    jctrl, pctrl = make_jax_ctrl(), make_port_ctrl()
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    rng = np.random.default_rng(1)
    for t in range(3):
        s = (0.05 * rng.standard_normal(4)).astype(np.float32)
        eps = port_noise(popt, jax_next_draw(jopt))
        popt.sample_noise = lambda state, eps=eps: eps
        u_jax = jctrl.step(s)
        u_port = pctrl.step(s)
        np.testing.assert_allclose(u_port, u_jax, **UNOM_TOL)
        np.testing.assert_allclose(popt.opt_state.u_nom.numpy(),
                                   np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)


def test_logging_contract_shapes_match_jax():
    K, H, n = 64, 10, 3
    jctrl, pctrl = make_jax_ctrl(K, H, logging=True), make_port_ctrl(K, H, logging=True)
    assert not pctrl.optimizer._uses_semi_fused()  # logging takes the modular path
    s = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    for _ in range(n):
        jctrl.step(s)
        pctrl.step(s)
    jout, pout = jctrl.get_outputs(), pctrl.get_outputs()
    assert set(pout) == set(jout)
    for key in jout:
        if jout[key] is None:
            assert pout[key] is None, key
        else:
            assert pout[key].shape == jout[key].shape, key
    assert pout["rollout_trajectories_logged"].shape == (n, K, H + 1, 4)


def test_changed_target_and_weight_change_cost_without_rebuild():
    pctrl = make_port_ctrl(64, 10)
    popt = pctrl.optimizer
    epoch = popt._build_epoch
    s = torch.tensor([[0.0, 0.0, 0.1, 0.0]])
    eps = torch.randn(popt._noise_shape, generator=torch.Generator().manual_seed(0)) * 0.1

    def costs():
        return popt.update(popt.opt_state, s, pctrl._assemble_params(), eps)[2]["J_logged"]

    base = costs()
    pctrl.update_attributes({"target_position": -0.4})
    moved = costs()
    pctrl._cost_params["ep_weight"] = torch.tensor(5000.0)
    reweighted = costs()
    assert not torch.allclose(base, moved) and not torch.allclose(moved, reweighted)
    pctrl.step(s[0].numpy(), updated_attributes={"target_position": 0.1})
    assert popt._build_epoch == epoch


def test_cost_yaml_hot_reload_reaches_next_step(tmp_path, monkeypatch):
    cfg = tmp_path / "config_cost_function.yml"
    text = ("cost_function_name_default: default\ncartpole:\n  default:\n"
            "    dd_weight: 120.0\n    ep_weight: {ep}\n    ekp_weight: 10.0\n"
            "    cc_weight: 1.0\n    ccrc_weight: 1.0\n    R: 1.0\n")
    cfg.write_text(text.format(ep=10000.0))
    monkeypatch.setenv("CONTROL_TOOLKIT_ASF_DIR", str(tmp_path))
    pctrl = make_port_ctrl(64, 10)
    epoch = pctrl.optimizer._build_epoch
    s = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    pctrl.step(s)
    assert float(pctrl._cost_params["ep_weight"]) == 10000.0

    cfg.write_text(text.format(ep=2500.0))
    os.utime(cfg, (time.time() + 5, time.time() + 5))
    deadline = time.time() + 10.0
    while not pctrl.cost_function.cost_function.reload_cost_parameters_from_config_flag:
        assert time.time() < deadline, "cost config change not picked up"
        time.sleep(0.05)
    pctrl.step(s)
    assert float(pctrl._cost_params["ep_weight"]) == 2500.0
    assert pctrl.optimizer._build_epoch == epoch


def test_controller_reset_zeroes_u_and_restarts_noise():
    pctrl = make_port_ctrl(32, 10)
    s = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    first = pctrl.step(s)
    pctrl.step(s)
    pctrl.controller_reset()
    assert np.all(pctrl.u == 0.0)
    np.testing.assert_array_equal(pctrl.step(s), first)


def test_nan_guard_commands_zero_and_resets(monkeypatch):
    pctrl = make_port_ctrl(32, 10)
    popt = pctrl.optimizer
    s = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    pctrl.step(s)
    nan = torch.full(popt._noise_shape, float("nan"))
    monkeypatch.setattr(popt, "sample_noise", lambda state: nan)
    u = pctrl.step(s)
    np.testing.assert_array_equal(u, np.zeros(1, np.float32))
    assert torch.all(popt.opt_state.u_nom == 0.0)


def test_refinement_and_remat_build_as_in_jax():
    # optim_steps (mppi-optimize) and remat build in both packages.
    for extra in ({"optim_steps": 2}, {"remat": True}):
        jopt = make_jax_ctrl(32, 10, **extra).optimizer
        popt = make_port_ctrl(32, 10, **extra).optimizer
        assert (popt.optim_steps, popt.remat) == (jopt.optim_steps, jopt.remat)
        assert (popt._make_refine() is not None) == (jopt.optim_steps > 0)
    # risk_weight is ported (PETS ensembles): over the ODE, as in the JAX
    # package, it needs a predictor with a disagreement.
    with pytest.raises(ValueError, match="disagreement"):
        make_port_ctrl(32, 10, risk_weight=0.5)
