"""What only the quadrotor2d, quadrotor3d, car and arm2 plants need, beside
their cases in test_torch_plants.py: the thirteen registry names, the
3-D quadrotor's clamped secant at its ties, its K7 plain version against
``jax.vjp`` of the JAX scan (the JAX package's own interpret test of that
kernel is marked slow), arm2's mirrored link lengths, one MPPI update with
``bounded_update`` over each plant, and the four-input paths' contiguous
operands.

Tolerances, each with its reason:

* the secant's ties to ``torch.autograd`` in float64 to F64_TOL (rounding
  only) and to ``jax.vjp`` in float32 to TIE_TOL (XLA's and torch's sin
  and cos differ by an ulp, the products round alike);
* the K7 plain version and the MPPI step to the bounds of the cartpole
  tests they follow (test_torch_grad.py, test_torch_mppi.py).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.models import dynamics as jdyn
from control_toolkit_tpu.utils import registry as jregistry
from control_toolkit_tpu_torch.costs.arm2 import Arm2ReachCost
from control_toolkit_tpu_torch.models import dynamics as pdyn
from control_toolkit_tpu_torch.ops import adjoints, kernels
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout_plain
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.utils import registry
from control_toolkit_tpu_torch.utils.convert import params_from_numpy
from test_torch_grad import GRAD_TOL
from test_torch_mppi import CPU, COST_TOL, UNOM_TOL, jax_next_draw, jax_params_numpy, port_noise
from test_torch_plants import (
    CONTIGUITY_PATHS, F64_TOL, PLANTS, controls, limits, make_pair, mppi_config, port_ctrl,
    rpgd_config, set_mppi_state, states,
)

NEW_PLANTS = ("quadrotor2d", "quadrotor3d", "car", "car_obstacles", "arm2")
TIE_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_registry_resolves_the_thirteen_new_names():
    """The nine cost names and four environments resolve, each cost name to
    the class of its JAX counterpart's name, each cost to its device plant."""
    registry._load_builtins()
    jregistry._load_builtins()
    names = {"quadrotor2d/default": "quadrotor2d", "quadrotor2d/waypoint": "quadrotor2d",
             "quadrotor3d/default": "quadrotor3d", "quadrotor3d/waypoint": "quadrotor3d",
             "car/default": "car", "car/waypoint": "car", "car/obstacles": "car_obstacles",
             "arm2/default": "arm2", "arm2/reach": "arm2"}
    for name, plant in names.items():
        cls = registry.cost_functions.get(name)
        assert cls.__name__ == jregistry.cost_functions.get(name).__name__
        env = name.split("/")[0]
        assert ode.DEVICE_COSTS[env][cls] == plant
    for env in ("quadrotor2d", "quadrotor3d", "car", "arm2"):
        penv = registry.environments.get(env)
        jenv = jregistry.environments.get(env)
        assert penv.__name__ == jenv.__name__
        np.testing.assert_array_equal(penv.action_low, jenv.action_low)
        np.testing.assert_array_equal(penv.action_high, jenv.action_high)


def _tie_sincos(theta0, c0, lib):
    """A trig whose cosine at ``theta0`` is ``c0`` exactly (cos(a) - cos(theta0)
    + c0), its derivatives exact trig's, to put the secant clamp on a tie."""
    if lib is torch:
        def sincos_d(a):
            return a.sin(), a.cos() - theta0.cos() + c0, a.cos(), a.sin()
        return sincos_d
    return lambda a: (jnp.sin(a), jnp.cos(a) - jnp.cos(theta0) + c0)


@pytest.mark.parametrize("c0", [0.15, -0.15, 0.0, 0.3, -0.05])
def test_secant_clamp_ties_match_jax_vjp_and_autograd(c0):
    """The 3-D quadrotor's clamped secant at c_th = 0.15 and -0.15 (the
    maximum's and minimum's ties: half the cotangent), at 0 (``where``'s
    first branch, the clamp holding) and off the ties: its Jacobian against
    torch.autograd in float64 and its VJP against jax.vjp of the JAX
    dynamics in float32, over a trig that lands cos(theta) on c0 exactly."""
    safe, d = adjoints.secant_clamp_d(torch.tensor([c0], dtype=torch.float32))
    expect = {0.15: 0.5, -0.15: 0.5, 0.0: 0.0, 0.3: 1.0, -0.05: 0.0}[c0]
    assert float(d) == expect and float(safe) == np.float32(
        max(c0, 0.15) if c0 >= 0 else min(c0, -0.15))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 12))
    u = rng.uniform(0.0, 1.0, (4, 4))
    dyn = dict(pdyn.QUADROTOR3D_DEFAULTS)
    p64 = {f"d_{k}": torch.tensor(v, dtype=torch.float64) for k, v in dyn.items()}
    # float64: the Jacobian against autograd through the port's dynamics
    x64, u64 = torch.tensor(x), torch.tensor(u)
    theta0 = x64[:, 7].clone()
    sincos_d = _tie_sincos(theta0, c0, torch)
    xu = torch.cat([x64, u64], 1).requires_grad_(True)
    f = pdyn._quadrotor3d_derivs(tuple(xu[:, i] for i in range(12)),
                                 tuple(xu[:, 12 + j] for j in range(4)),
                                 {k: torch.tensor(v, dtype=torch.float64) for k, v in dyn.items()},
                                 lambda a: sincos_d(a)[:2])
    auto = torch.stack([torch.autograd.grad(fi.sum(), xu, retain_graph=True)[0] for fi in f], 1)
    _, J = adjoints.quadrotor3d_derivs_jac(tuple(x64.unbind(1)), tuple(u64.unbind(1)), p64,
                                           sincos_d)
    torch.testing.assert_close(J, auto, **F64_TOL)
    # float32: the VJP against jax.vjp of the JAX dynamics
    x32, u32 = x.astype(np.float32), u.astype(np.float32)
    lam = rng.standard_normal((4, 12)).astype(np.float32)
    jsincos = _tie_sincos(jnp.asarray(x32[:, 7]), np.float32(c0), jnp)

    def jf(xu_):
        out = jdyn._quadrotor3d_derivs(tuple(xu_[:, i] for i in range(12)),
                                       tuple(xu_[:, 12 + j] for j in range(4)),
                                       {k: jnp.float32(v) for k, v in dyn.items()}, jsincos)
        return jnp.stack(out, 1)

    _, vjp = jax.vjp(jf, jnp.asarray(np.concatenate([x32, u32], 1)))
    (ref,) = vjp(jnp.asarray(lam))
    t32 = torch.tensor(x32[:, 7])
    p32 = {k: v.float() for k, v in p64.items()}
    sd32 = _tie_sincos(t32, torch.tensor(np.float32(c0)), torch)
    dx, du = adjoints._vjp_from_jac(
        lambda xs, us, p: adjoints.quadrotor3d_derivs_jac(xs, us, p, sd32),
        tuple(torch.tensor(x32).unbind(1)), tuple(torch.tensor(u32).unbind(1)), p32,
        tuple(torch.tensor(lam).unbind(1)))
    np.testing.assert_allclose(torch.stack(dx + du, 1).numpy(), np.asarray(ref), **TIE_TOL)


def test_quadrotor3d_k7_plain_matches_jax_vjp_of_the_scan():
    """K7's plain version over the 3-D quadrotor (12 states, 4 inputs, the
    clamped secant reached by the seeded pitches) against jax.grad of the
    summed costs of the JAX package's fused scan, and against
    torch.autograd through K1's plain version in float64."""
    Kg, Hg = 128, 15
    jctrl, pctrl = make_pair("quadrotor3d", "rpgd-tf", rpgd_config(num_rollouts=Kg,
                                                                     mpc_horizon=Hg),
                             jax_logging=True)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    rng = np.random.default_rng(4)
    s0 = states("quadrotor3d", rng, Kg)
    Q = controls("quadrotor3d", rng, (Kg, Hg, 4))
    u_prev = np.full(4, 0.45, np.float32)
    jparams = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                     jctrl._assemble_params())
    args = (jnp.asarray(s0), jnp.asarray(u_prev), jparams)
    ref_cost = np.asarray(jopt._fused_cost(args[0], jnp.asarray(Q), *args[1:]))
    ref_grad = np.asarray(jax.grad(
        lambda q: jnp.sum(jopt._fused_cost(args[0], q, *args[1:])))(jnp.asarray(Q)))
    assert ode.can_use_grad(popt)
    model, pack = ode.rollout_model(popt)
    assert model.plant == "quadrotor3d"
    pvec = pack(params_from_numpy(jax_params_numpy(jctrl), CPU), torch.as_tensor(u_prev))
    cost, dQ = grad_cost_rollout(model, torch.as_tensor(s0), torch.as_tensor(Q), pvec)
    np.testing.assert_allclose(cost.numpy(), ref_cost, **COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), ref_grad, **GRAD_TOL)
    Q64 = torch.tensor(Q, dtype=torch.float64, requires_grad=True)
    s64, p64 = torch.tensor(s0, dtype=torch.float64), pvec.double()
    (auto,) = torch.autograd.grad(cost_rollout_plain(model, s64, Q64, p64).sum(), Q64)
    _, dQ64 = grad_cost_rollout_plain(model, s64, Q64.detach(), p64)
    torch.testing.assert_close(dQ64, auto, rtol=1e-9, atol=1e-9)


def test_arm2_sync_with_dynamics(caplog):
    """arm2/default's link lengths mirror the dynamics': unset ones are
    seeded from the predictor (as the JAX package seeds them), an explicit
    one that differs is kept with a warning, and the device plant then
    reads the seeded values."""
    cost = Arm2ReachCost({"l1": 0.5})
    with caplog.at_level(logging.WARNING):
        cost.sync_with_dynamics({"l1": 0.7, "l2": 0.4})
    assert (cost.config["l1"], cost.config["l2"]) == (0.5, 0.4)
    assert "differs from the dynamics l1=0.7" in caplog.text
    params = {"params": {"l1": 0.6, "l2": 0.45}}
    cfg = mppi_config(num_rollouts=16, mpc_horizon=5)
    ctrl = port_ctrl("arm2", cfg=cfg, predictor_config=params)
    jctrl = JaxMPC("arm2", limits("arm2"), dict(PLANTS["arm2"][3]),
                   config={"optimizer": "mppi", "controller_logging": False})
    jctrl.configure(optimizer_name="mppi", optimizer_config=cfg, predictor_config=params)
    for k in ("l1", "l2"):
        assert ctrl.cost_function.cost_function.config[k] == params["params"][k]
        assert jctrl.cost_function.cost_function.config[k] == params["params"][k]
    model, pack = ode.rollout_model(ctrl.optimizer)
    p = model.unpack(pack(ctrl._assemble_params(), torch.zeros(2)))
    assert float(p["c_l1"]) == np.float32(0.6) and float(p["d_l1"]) == np.float32(0.6)


@pytest.mark.parametrize("label", NEW_PLANTS)
def test_one_bounded_mppi_update_matches_jax(label):
    """The modular MPPI step with ``bounded_update`` (the quadrotors' demo
    form: the nominal is set to the clipped weighted controls, K1's plain
    version scoring them) fed the JAX step's noise."""
    jctrl, pctrl = make_pair(label, cfg=mppi_config(bounded_update=True))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt.bounded_update and not popt._uses_semi_fused() and ode.can_use_cost(popt)
    set_mppi_state(jopt, popt)
    s = states(label, np.random.default_rng(9), 1)[0]
    delta = jax_next_draw(jopt)
    u_jax = jctrl.step(s)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                                 port_noise(popt, delta))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)
    lo, hi = limits(PLANTS[label][0])
    assert np.all(u.numpy() >= lo) and np.all(u.numpy() <= hi)


@pytest.mark.parametrize("path", sorted(CONTIGUITY_PATHS))
def test_four_input_paths_give_the_kernels_contiguous_operands(path, monkeypatch):
    """Over the 3-D quadrotor's four inputs (controls in [0, 1]) every
    optimizer hands its kernels contiguous operands, which the CUDA
    wrappers require; on the CPU each wrapper's ``kernels.on_cpu`` sees the
    same operands."""
    seen = []
    on_cpu = kernels.on_cpu

    def checked(*tensors):
        seen.append(all(t.is_contiguous() for t in tensors))
        return on_cpu(*tensors)

    monkeypatch.setattr(kernels, "on_cpu", checked)
    name = path.split("-modular")[0].split("-fused")[0]
    base = rpgd_config(num_rollouts=64, mpc_horizon=10) if name in ("rpgd-tf", "gradient-tf") \
        else mppi_config(num_rollouts=64, mpc_horizon=10)
    ctrl = port_ctrl("quadrotor3d", name, {**base, **CONTIGUITY_PATHS[path]})
    if path == "mppi-fused":
        ctrl.optimizer.fused_tile_k = 64
        ctrl.optimizer._build()
        assert ctrl.optimizer._can_fully_fuse()
    s = states("quadrotor3d", np.random.default_rng(0), 1)[0]
    for _ in range(2):
        u = ctrl.step(s)
        assert np.all(u >= 0.0) and np.all(u <= 1.0)
        s = s + 0.01 * u.sum()
    assert seen and all(seen)


def jax_demo(label: str, opt_seed: int, obs_noise: float = 0.0) -> dict:
    """The JAX package's run of chip_smoke.py's REST_DEMOS loop ``label``
    (a JAX test's closed loop) on the CPU with optimizer seed ``opt_seed``,
    judged by chip_smoke.py's ``demo_criterion``; ``obs_noise``: the
    controller sees each state plus that much seeded normal noise (the
    loop's sensitivity to perturbations of float32 rounding's size)."""
    import chip_smoke as cs

    jregistry._load_builtins()
    env_seed, start, plant, cfg, ticks, attrs, cost_cfg = cs.REST_DEMOS[label]
    env_name, spec, _ = cs.ALL_CASES[plant]
    jenv = jregistry.environments.get(env_name)(batch_size=1, dt=cfg["mpc_timestep"],
                                                seed=env_seed)
    ctrl = JaxMPC(env_name, (jenv.action_low, jenv.action_high), dict(attrs),
                  config={"optimizer": "mppi", "controller_logging": False,
                          "cost_function_specification": spec})
    ctrl.configure(optimizer_name="mppi", optimizer_config={**cfg, "seed": opt_seed})
    ctrl.cost_function.cost_function.config.update(cost_cfg)
    s, _ = jenv.reset()
    if start is not None:
        jenv.state = jnp.asarray(np.asarray([start], np.float32))
        s = np.asarray(jenv.state)
    visited, rng = [], np.random.default_rng(opt_seed)
    for _ in range(ticks):
        obs = np.asarray(s[0]) + obs_noise * rng.standard_normal(len(s[0]))
        s, *_ = jenv.step(ctrl.step(obs.astype(np.float32)))
        visited.append(np.asarray(s[0]))
    met, out = cs.demo_criterion(label, np.array(visited))
    return {"label": label, "seed": opt_seed, "met": met, **out}


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_plants_rest.py --demo <label> <seed>
    # [obs_noise]: one JAX run of chip_smoke.py's REST_DEMOS loop on the CPU,
    # one JSON line (chip_smoke.py's REST_DEMO_JAX_MET counts them over
    # DEMO_SEEDS).
    import json
    import sys

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--demo"]:
        noise = float(sys.argv[4]) if len(sys.argv) > 4 else 0.0
        print(json.dumps(jax_demo(sys.argv[2], int(sys.argv[3]), noise)), flush=True)
