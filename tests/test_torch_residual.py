"""The torch port's residual (``"ODE+res"``) path against the JAX package:
the predictor and its spec, the three nested-``dyn`` repairs (the
controller's params cache, the packed vector, the numpy carry-over), K12's
and K9's plain versions (``ops/residual_rollout.py``,
``ops/residual_grad_cost_rollout.py``) against the JAX package's Pallas
kernels in interpret mode, the residual step's hand-written adjoint
against ``torch.autograd``, a sysid install through the same built step,
one MPPI and one rpgd-tf controller tick, the checkpoint across packages,
K9's and K12's tensor-core arithmetic (3xTF32; K12 with K5's base step)
rehearsed on the CPU, and — on a machine with a card only — each CUDA
kernel against its plain version.

Both packages get the same residual weights (JAX's, made nonzero as
``bench_scale.py:build_residual_ctrl`` makes them) and the same inputs and
noise, made with numpy from a seed or drawn from the JAX key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.models.residual_predictor import ResidualPredictor as JaxResidual
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.models.dynamics import cartpole_derivs_soa
from control_toolkit_tpu_torch.models.predictors import PredictorWrapper
from control_toolkit_tpu_torch.models.residual_predictor import ResidualPredictor
from control_toolkit_tpu_torch.ops.adjoints import (
    PLANT_ADJOINTS, integrator_vjp, residual_step_vjp,
)
from control_toolkit_tpu_torch.ops.grad_cost_rollout import plain_grad_loop
from control_toolkit_tpu_torch.ops.neural_rollout import mlp_step, plain_cost_loop
from control_toolkit_tpu_torch.ops.residual_grad_cost_rollout import (
    residual_grad_cost_rollout, residual_grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.residual_rollout import (
    residual_cost_rollout, residual_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.soa_integrators import make_soa_stepper, tadd
from control_toolkit_tpu_torch.optimizers.kernel_families import gp, neural, ode, residual
from control_toolkit_tpu_torch.utils.convert import params_from_numpy
from test_torch_mppi import (
    CPU, LIMITS, UNOM_TOL, jax_next_draw, jax_params_numpy, optimizer_config, port_noise,
)
from test_torch_neural_grad import distances, mlp_step_with, mlp_vjp_with, mm_3xtf32, mm_tf32
from test_torch_rpgd import jax_rpgd_draw, rpgd_config, set_rpgd_state

K, H = 256, 10
F64_TOL = dict(rtol=1e-9, atol=1e-9)
# The JAX residual kernel tests' own bounds (test_pallas_residual.py:78-79,
# 94-97): the rk4 base rounds alike, the MLP's matmuls sum in other orders.
COST_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=5e-4)
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bench_residual(template: dict, seed: int = 11) -> dict:
    """Nonzero residual weights as bench_scale.py:218-222 makes them from
    the JAX residual ``template``: each weight 0.02 * a normal draw from
    ``fold_in(PRNGKey(seed), i)``, biases kept; numpy arrays."""
    key = jax.random.PRNGKey(seed)
    return {k: np.asarray(0.02 * jax.random.normal(jax.random.fold_in(key, i), v.shape)
                          if k.startswith("w") else v, np.float32)
            for i, (k, v) in enumerate(sorted(template.items()))}


def make_pair(optimizer="mppi", config=None, jax_logging=False, spec="ODE+res"):
    """The JAX and the port controller over "ODE+res", each with the same
    nonzero residual installed."""
    cfg = config or optimizer_config(K, H)
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.3},
                   config={"optimizer": optimizer, "controller_logging": jax_logging})
    jctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                    optimizer_config=dict(cfg))
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                          config={"device": "cpu",
                                  "optimizer": optimizer, "controller_logging": False})
    pctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                    optimizer_config=dict(cfg))
    jpred = jctrl.optimizer.predictor.predictor
    res = bench_residual(jpred._res)
    jpred.set_residual(res)
    jctrl._dyn_params = None
    pctrl.optimizer.predictor.predictor.set_residual(res)
    return jctrl, pctrl


def inputs(seed, lo=-0.8, hi=0.8):
    rng = np.random.default_rng(seed)
    s_tiled = np.tile(np.array([[0.1, -0.2, 0.3, 0.05]], np.float32), (K, 1))
    Q = rng.uniform(lo, hi, (K, H, 1)).astype(np.float32)
    return s_tiled, Q, np.array([0.25], np.float32)


# ---- the predictor ---------------------------------------------------------------
def test_fresh_predictor_equals_its_base_exactly():
    pred = ResidualPredictor("cartpole", dt=0.02, device="cpu", seed=4)
    rng = np.random.default_rng(1)
    s0 = torch.tensor(rng.uniform(-0.4, 0.4, (8, 4)).astype(np.float32))
    Q = torch.tensor(rng.uniform(-1, 1, (8, 15, 1)).astype(np.float32))
    torch.testing.assert_close(pred.rollout(s0, Q), pred.base.rollout(s0, Q), rtol=0, atol=0)
    assert not pred._res["w2"].any() and pred._res["w0"].any()
    assert set(pred.default_params()) == {"base", "res"}


def test_rollout_matches_jax_with_its_weights():
    jpred = JaxResidual("cartpole", dt=0.02, hiddens=(16, 8))
    res = bench_residual(jpred._res)
    jpred.set_residual(res)
    pred = ResidualPredictor("cartpole", dt=0.02, device="cpu", hiddens=(16, 8))
    pred.set_residual(res)
    rng = np.random.default_rng(2)
    s0 = (0.1 * rng.standard_normal((6, 4))).astype(np.float32)
    Q = rng.uniform(-1.0, 1.0, (6, H, 1)).astype(np.float32)
    np.testing.assert_allclose(pred.rollout(torch.tensor(s0), torch.tensor(Q)).numpy(),
                               np.asarray(jpred.rollout(jnp.asarray(s0), jnp.asarray(Q))),
                               rtol=1e-5, atol=1e-6)


def test_spec_grammar():
    w = PredictorWrapper()
    w.configure(device="cpu", dt=0.02, predictor_specification="ODE+res:euler:2", hiddens=(8,))
    pred = w.predictor
    assert isinstance(pred, ResidualPredictor) and pred.environment_name == "cartpole"
    assert (pred.integrator, pred.intermediate_steps, pred.hiddens) == ("euler", 2, (8,))
    assert (w.num_states, w.num_control_inputs) == (4, 1)
    assert tuple(pred._res["w0"].shape) == (5, 8) and tuple(pred._res["w1"].shape) == (8, 4)
    w.configure(device="cpu", dt=0.02, predictor_specification="ODE+res")
    assert (w.predictor.integrator, w.predictor.hiddens) == ("rk4", (32, 32))
    # ported: the fast base plant (tests/test_torch_fastmath.py)
    w.configure(device="cpu", dt=0.02, predictor_specification="ODE+res:rk4:1:fast")
    assert w.predictor.fast_math and w.predictor.base.fast_math


def test_checkpoint_round_trips_across_packages(tmp_path):
    jpred = JaxResidual("cartpole", dt=0.02, hiddens=(16, 8))
    jpred.set_residual(bench_residual(jpred._res, seed=3))
    jpred.save_residual(tmp_path / "from_jax.npz")
    pred = ResidualPredictor("cartpole", dt=0.02, device="cpu")
    pred.load_residual(tmp_path / "from_jax.npz")
    assert pred.hiddens == (16, 8)
    for k, v in jpred._res.items():
        np.testing.assert_array_equal(pred._res[k].numpy(), np.asarray(v))
    pred.set_residual({k: 1.5 * v for k, v in pred._res.items()})
    pred.save_residual(tmp_path / "from_port.npz")
    back = JaxResidual("cartpole", dt=0.02)
    back.load_residual(tmp_path / "from_port.npz")
    assert back.hiddens == (16, 8)
    for k, v in pred._res.items():
        np.testing.assert_array_equal(np.asarray(back._res[k]), v.numpy())
    with pytest.raises(ValueError, match="num_states"):
        JaxResidual("pendulum", dt=0.02).load_residual(tmp_path / "from_port.npz")


# ---- the three repairs --------------------------------------------------------------
def test_assemble_params_caches_by_value_and_by_object():
    """Repair 1: the controller's params cache takes a nested dyn; the base's
    constants are compared by value, the residual re-placed only when its
    dict changes (set_residual, load_residual)."""
    _, pctrl = make_pair()
    pred = pctrl.optimizer.predictor.predictor
    first = pctrl._assemble_params()["dyn"]
    assert set(first) == {"base", "res"} and first["base"]["m_pole"].ndim == 0
    again = pctrl._assemble_params()["dyn"]
    assert again["base"] is first["base"] and again["res"] is first["res"]
    new = {k: 2.0 * v for k, v in pred._res.items()}
    pred.set_residual(new)
    installed = pctrl._assemble_params()["dyn"]
    assert installed["base"] is first["base"]
    assert all(installed["res"][k] is v for k, v in pred._res.items())  # placed, not copied
    torch.testing.assert_close(installed["res"]["w0"], new["w0"])
    pred.base._defaults["m_pole"] = 0.4
    changed = pctrl._assemble_params()["dyn"]
    assert float(changed["base"]["m_pole"]) == pytest.approx(0.4)
    assert changed["res"] is installed["res"]


def test_packed_vector_equals_jax():
    """Repair 2: the packed layout and vector of an "ODE+res" optimizer are
    the JAX package's: the base's constants (d_*), the cost, u_prev."""
    jctrl, pctrl = make_pair()
    jkeys, jpack = jctrl.optimizer._soa_bindings()[:2]
    pkeys, ppack, derivs = pctrl.optimizer._soa_bindings()[:3]
    assert list(pkeys) == list(jkeys) and pkeys[0] == "d_L" and derivs is not None
    u_prev = np.array([0.25], np.float32)
    ref = np.asarray(jpack(jctrl._assemble_params(), jnp.asarray(u_prev)))
    np.testing.assert_array_equal(ppack(pctrl._assemble_params(), torch.tensor(u_prev)).numpy(),
                                  ref)
    np.testing.assert_array_equal(
        ppack(params_from_numpy(jax_params_numpy(jctrl), CPU), torch.tensor(u_prev)).numpy(), ref)


def test_params_from_numpy_carries_nested_dyn():
    """Repair 3: a residual's {"base", "res"} and a GP's {"gp"} (its 0-d
    variance) cross as float32 tensors of the same nesting and shapes."""
    jctrl, _ = make_pair()
    tree = jax_params_numpy(jctrl)
    params = params_from_numpy(tree, CPU)
    assert set(params["dyn"]) == {"base", "res"}
    for k, v in tree["dyn"]["res"].items():
        np.testing.assert_array_equal(params["dyn"]["res"][k].numpy(), v)
    assert params["dyn"]["base"]["g"].dtype == torch.float32
    gp_tree = {"dyn": {"gp": {"Z": np.ones((3, 5)), "variance": np.float32(2.0)}},
               "cost": {"R": 1.0}, "attrs": {"target_position": 0.1}}
    gp_params = params_from_numpy(gp_tree, CPU)
    assert gp_params["dyn"]["gp"]["variance"].shape == () and gp_params["cost"]["R"].ndim == 0
    assert tuple(gp_params["dyn"]["gp"]["Z"].shape) == (3, 5)


# ---- the adjoint ------------------------------------------------------------------
@pytest.mark.parametrize("rk4,substeps", [(True, 1), (False, 2), (True, 2)])
def test_residual_step_vjp_matches_autograd_float64(rk4, substeps):
    jpred = JaxResidual("cartpole", dt=0.02, hiddens=(12, 7))
    net = {k: torch.tensor(v, dtype=torch.float64)
           for k, v in bench_residual(jpred._res, seed=5).items()}
    p = {f"d_{k}": torch.tensor(v, dtype=torch.float64)
         for k, v in {"m_cart": 1.0, "m_pole": 0.1, "L": 0.5, "g": 9.81, "u_max": 10.0,
                      "friction_cart": 0.1, "friction_pole": 0.05}.items()}

    def derivs(xs, us, pp):
        return cartpole_derivs_soa(xs, us, {k[2:]: v for k, v in pp.items()})

    step = make_soa_stepper(derivs, "rk4" if rk4 else "euler", 0.02, substeps)
    rng = np.random.default_rng(6)
    x = torch.tensor(0.3 * rng.standard_normal((16, 4)), requires_grad=True)
    u = torch.tensor(rng.uniform(-1.0, 1.0, (16, 1)), requires_grad=True)
    lam = torch.tensor(rng.standard_normal((16, 4)))
    out = torch.stack(step(tuple(x.unbind(1)), tuple(u.unbind(1)), p), 1) + mlp_step(net, x, u,
                                                                                   False)
    (out * lam).sum().backward()
    dxs, dus = residual_step_vjp(derivs, PLANT_ADJOINTS["cartpole"][0], tuple(x.detach().T),
                                 tuple(u.detach().T), p, net, tuple(lam.T), rk4, substeps, 0.02)
    torch.testing.assert_close(torch.stack(dxs, 1), x.grad, **F64_TOL)
    torch.testing.assert_close(torch.stack(dus, 1), u.grad, **F64_TOL)


# ---- K12 and K9 against the Pallas kernels ---------------------------------------------
def test_k12_plain_matches_pallas_interpret():
    jctrl, pctrl = make_pair()
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert residual.can_use_cost(popt)
    assert not (ode.can_use_cost(popt) or neural.can_use_cost(popt) or gp.can_use_cost(popt))
    s_tiled, Q, u_prev = inputs(3)
    pallas = jopt._build_pallas_residual_cost(interpret=True, tile_k=64)
    ref = np.asarray(pallas(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev),
                            jctrl._assemble_params()))
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    assert float(params["dyn"]["res"]["w0"].abs().max()) > 0
    before = residual_cost_rollout.launches
    got = popt._make_cost_only()(torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev),
                                 params)
    assert residual_cost_rollout.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), ref, **COST_TOL)


@pytest.mark.parametrize("ccrc", [None, 5.0])
def test_k9_plain_matches_pallas_interpret_and_autograd(ccrc):
    """Also turns the control-change term up so the gprev carry shows."""
    jctrl, pctrl = make_pair("rpgd-tf", rpgd_config(num_rollouts=K, mpc_horizon=H))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert residual.can_use_grad(popt)
    s_tiled, Q, u_prev = inputs(4)
    jparams = jctrl._assemble_params()
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    if ccrc is not None:
        jparams = dict(jparams, cost=dict(jparams["cost"], ccrc_weight=jnp.float32(ccrc)))
        params["cost"]["ccrc_weight"] = torch.tensor(ccrc)
    pallas = jopt._build_pallas_residual_grad(interpret=True, tile_k=64)
    ref_cost, ref_dq = pallas(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev), jparams)
    model, pack = residual.residual_model(popt)
    args = (model, torch.tensor(s_tiled), torch.tensor(Q), pack(params, torch.tensor(u_prev)),
            params["dyn"]["res"])
    before = residual_grad_cost_rollout.launches
    cost, dQ = residual_grad_cost_rollout(*args)
    assert residual_grad_cost_rollout.launches == before
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), np.asarray(ref_dq), **GRAD_TOL)
    Qv = args[2].clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(
        residual_cost_rollout_plain(args[0], args[1], Qv, *args[3:]).sum(), Qv)
    torch.testing.assert_close(dQ, auto, **GRAD_TOL)


def test_a_sysid_install_reaches_the_next_call_without_rebuild():
    _, pctrl = make_pair("rpgd-tf", rpgd_config(num_rollouts=K, mpc_horizon=H))
    popt, pred = pctrl.optimizer, pctrl.optimizer.predictor.predictor
    cost_fn, epoch = popt._make_cost_only(), popt._build_epoch
    grad_fn, _ = popt._make_grad_and_cost_only()
    s = torch.tensor([[0.1, 0.0, 0.2, 0.0]]).expand(K, 4)
    Q = torch.full((K, H, 1), 0.3)
    u_prev = torch.tensor([0.0])
    first = cost_fn(s, Q, u_prev, pctrl._assemble_params())
    first_dq = grad_fn(Q, s, u_prev, pctrl._assemble_params())
    pred.set_residual({k: 3.0 * v for k, v in pred._res.items()})
    params = pctrl._assemble_params()
    swapped = cost_fn(s, Q, u_prev, params)
    assert not torch.allclose(first, swapped)
    assert not torch.allclose(first_dq, grad_fn(Q, s, u_prev, params))
    model, pack = residual.residual_model(popt)
    torch.testing.assert_close(swapped, residual_cost_rollout_plain(
        model, s, Q, pack(params, u_prev), pred._res))
    assert popt._build_epoch == epoch


# ---- the controller -------------------------------------------------------------------
def test_mppi_controller_ticks_match_jax():
    """A few MPPI ticks through both controllers' step(), each fed the same
    state and the same noise; the plans carry over."""
    jctrl, pctrl = make_pair()
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert not popt._uses_semi_fused()  # the semi-fused K2 takes an ODE only
    rng = np.random.default_rng(7)
    for _ in range(3):
        s = (0.05 * rng.standard_normal(4)).astype(np.float32)
        eps = port_noise(popt, jax_next_draw(jopt))
        popt.sample_noise = lambda state, eps=eps: eps
        np.testing.assert_allclose(pctrl.step(s), jctrl.step(s), **UNOM_TOL)
        np.testing.assert_allclose(popt.opt_state.u_nom.numpy(), np.asarray(jopt.opt_state.u_nom),
                                   **UNOM_TOL)


def test_rpgd_controller_ticks_match_jax():
    """rpgd-tf ticks (a resample tick, then keep ticks) through both
    controllers, each fed the same state and draw: the port's K9 and K12
    plain versions against the JAX package's autograd through its scan."""
    jctrl, pctrl = make_pair("rpgd-tf", rpgd_config(num_rollouts=K, mpc_horizon=H),
                             jax_logging=True)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    set_rpgd_state(jopt, popt, count=0, seed=5)
    captured, step_fn = [], popt._step_fn
    popt._step_fn = lambda st, s, p: captured.append(step_fn(st, s, p)) or captured[-1]
    rng = np.random.default_rng(8)
    for _ in range(3):
        s = (0.05 * rng.standard_normal(4)).astype(np.float32)
        draw = jax_rpgd_draw(jopt) if int(jopt.opt_state.count) % 10 == 0 else None
        popt.sample_resample = lambda state, d=draw: None if d is None else torch.as_tensor(d)
        u_jax, u_port = jctrl.step(s), pctrl.step(s)
        jcost, pcost = jopt.logging_values["J_logged"], captured[-1][2]["J_logged"].numpy()
        np.testing.assert_allclose(pcost, jcost, **COST_TOL)
        if int(np.argmin(jcost)) == int(np.argmin(pcost)):
            np.testing.assert_allclose(u_port, u_jax, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(popt.opt_state.Q.numpy(), np.asarray(jopt.opt_state.Q),
                               rtol=1e-4, atol=1e-5)


def test_gates_and_wrappers():
    _, pctrl = make_pair(config=optimizer_config(K, H, force_scan=True))
    assert not residual.can_use_cost(pctrl.optimizer)
    assert pctrl.optimizer._make_cost_only() == pctrl.optimizer._fused_cost
    _, pctrl = make_pair()
    model, _ = residual.residual_model(pctrl.optimizer)
    net = pctrl._assemble_params()["dyn"]["res"]
    args, tensors = model.net_args(net)
    assert list(args.dims)[:4] == [5, 32, 32, 4] and args.predict_delta == 0
    assert set(tensors) == set(net)
    with pytest.raises(ValueError, match="norm"):
        model.net_args({**net, "norm_in_mean": torch.zeros(5), "norm_in_std": torch.ones(5)})
    meta = dict(device="meta")
    before = residual_cost_rollout.launches, residual_grad_cost_rollout.launches
    for fn in (residual_cost_rollout, residual_grad_cost_rollout):
        with pytest.raises(ValueError, match="several devices"):
            fn(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
               torch.empty(15, **meta), net)
        with pytest.raises(ValueError, match="CUDA"):
            fn(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
               torch.empty(15, **meta), {k: torch.empty(v.shape, **meta) for k, v in net.items()})
    assert (residual_cost_rollout.launches, residual_grad_cost_rollout.launches) == before


def test_k9_3xtf32_arithmetic_stays_within_the_kernel_bounds(record_property):
    """K9's residual MLP products in 3xTF32 (forward, re-run and transposed
    step; the rk4 base in FP32), emulated over a nonzero 5-32-32-4 residual
    (chip_smoke.py's: 0.02 N(0, 1) weights, torch seed 11) at K=256, H=50,
    stay within chip_smoke.py's bounds of the FP32 plain version; one-pass
    TF32's distance is recorded."""
    K_, H_ = 256, 50
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": "cpu", "optimizer": "rpgd-tf",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name="rpgd-tf", predictor_specification="ODE+res",
                   optimizer_config=rpgd_config(num_rollouts=K_, mpc_horizon=H_),
                   cost_function_config=COST_WEIGHTS)
    pred = ctrl.optimizer.predictor.predictor
    gen = torch.Generator().manual_seed(11)
    pred.set_residual({k: 0.02 * torch.randn(v.shape, generator=gen) if k.startswith("w") else v
                       for k, v in pred._res.items()})
    model, pack = residual.residual_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    pvec, net = pack(params, torch.tensor([0.1])), params["dyn"]["res"]
    rng = np.random.default_rng(9)
    s0 = torch.tensor(0.05 * rng.standard_normal((K_, 4)), dtype=torch.float32)
    Q = torch.tensor(rng.uniform(-1.0, 1.0, (K_, H_, 1)), dtype=torch.float32)
    p, derivs_vjp = model.unpack(pvec), PLANT_ADJOINTS[model.plant][0]
    one_step = make_soa_stepper(model.derivs, model.integrator, model.dt, model.intermediate_steps)

    def run(mm):
        def step(x, u):
            base = torch.stack(one_step(tuple(x.unbind(1)), tuple(u.unbind(1)), p), dim=1)
            return base + mlp_step_with(mm, net, x, u, False)

        def step_vjp(xs, us, lam):
            dx, du = integrator_vjp(model.derivs, derivs_vjp, xs, us, p, lam,
                                    model.integrator == "rk4", model.intermediate_steps, model.dt)
            dx_res, du_res = mlp_vjp_with(mm, xs, us, net, False, lam)
            return tadd(dx, dx_res), tadd(du, du_res)

        return plain_grad_loop(model, s0, Q, pvec, step, step_vjp)

    ref = residual_grad_cost_rollout_plain(model, s0, Q, pvec, net)
    found = {name: distances(*run(mm), *ref)
             for name, mm in (("3xtf32", mm_3xtf32), ("one_pass_tf32", mm_tf32))}
    record_property("k9_tf32_distances", found)
    assert found["3xtf32"]["within_bounds"], found


def residual_problem(Kc: int, H_: int = 50):
    """chip_smoke.py phase 18's operands at Kc rollouts on the CPU: the MPPI
    controller over "ODE+res" (its cost, pvec, rk4 base), the seeded
    5-32-32-4 residual (0.02 N(0, 1) weights, torch seed 11, zero biases),
    s0 0.05 N(0, 1) and Q 0.3 N(0, 1) clipped to [-1, 1] (numpy, seed 12)."""
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": "cpu", "optimizer": "mppi",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name="mppi", predictor_specification="ODE+res",
                   optimizer_config=optimizer_config(Kc, H_), cost_function_config=COST_WEIGHTS)
    pred = ctrl.optimizer.predictor.predictor
    gen = torch.Generator().manual_seed(11)
    pred.set_residual({k: 0.02 * torch.randn(v.shape, generator=gen) if k.startswith("w") else v
                       for k, v in pred._res.items()})
    model, pack = residual.residual_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    rng = np.random.default_rng(12)
    s0 = torch.tensor(0.05 * rng.standard_normal((Kc, 4)), dtype=torch.float32)
    Q = torch.tensor(np.clip(0.3 * rng.standard_normal((Kc, H_, 1)), -1, 1), dtype=torch.float32)
    return model, s0, Q, pack(params, torch.tensor([0.1])), params["dyn"]["res"]


@pytest.mark.parametrize("Kc", [1000, 8])
@pytest.mark.parametrize("net_case", ["seeded", "wide"])
def test_k12_3xtf32_arithmetic_stays_within_net_tol(net_case, Kc, record_property):
    """K12's arithmetic emulated in float32 — the residual MLP's products in
    3xTF32 with a partial sum a k-block, added in k order (csrc/mlp_units.cuh's
    order), the base step K5's (csrc/short_step.cuh: derivs_short), then
    x' = base + a — over the seeded 5-32-32-4 residual and phase 18's wide
    5-72-72-4 one (chip_smoke.py wide_net, no norms, scale 0.02), at K=1000
    and 8, H=50, stays within NET_TOL of the float64 plain version."""
    from chip_smoke import NET_TOL, RES_WIDE_SCALE, wide_net
    from test_torch_cem import short_step_fn
    from test_torch_neural import mm_3xtf32_partials

    model, s0, Q, pvec, net = residual_problem(Kc)
    if net_case == "wide":
        net = wide_net(False, RES_WIDE_SCALE, "cpu")
    base = short_step_fn(model, pvec)
    got = plain_cost_loop(model, s0, Q, pvec, lambda x, u: base(x, u) + mlp_step_with(
        mm_3xtf32_partials, net, x, u, False))
    ref = residual_cost_rollout_plain(model, s0.double(), Q.double(), pvec.double(),
                                      {k: v.double() for k, v in net.items()})
    err = (got.double() - ref).abs()
    found = {"max_abs_err": float(err.max()), "max_rel_err": float((err / ref.abs()).max()),
             "fp32_plain_max_abs_err": float(
                 (residual_cost_rollout_plain(model, s0, Q, pvec, net).double() - ref).abs().max())}
    record_property("k12_emulation_distance", found)
    assert torch.allclose(got.double(), ref, **NET_TOL), found


def test_k12_wide_net_bound_rejects_a_lost_unit_tile(record_property):
    """Over phase 18's wide 5-72-72-4 residual (chip_smoke.py wide_net, scale
    RES_WIDE_SCALE), whose last hidden layer K12 splits into unit tiles 4+4+1,
    NET_TOL rejects the plain arithmetic with that layer's last unit tile
    (the one-tile tail's 8 columns) lost, at K=1000, H=50."""
    from chip_smoke import NET_TOL, RES_WIDE_SCALE, net_mutants, wide_net

    model, s0, Q, pvec, _ = residual_problem(1000)
    wide = wide_net(False, RES_WIDE_SCALE, "cpu")
    ref = residual_cost_rollout_plain(model, s0, Q, pvec, wide)
    lost = residual_cost_rollout_plain(model, s0, Q, pvec,
                                       net_mutants(wide)["last_hidden_unit_tile_lost"])
    ratio = float(((lost - ref).abs() / (NET_TOL["atol"] + NET_TOL["rtol"] * ref.abs())).max())
    record_property("k12_wide_unit_tile_lost_err_over_net_tol", ratio)
    assert not torch.allclose(lost, ref, **NET_TOL), ratio


# ---- on the card ------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True])
def test_cuda_kernels_match_plain_versions(grad):
    """K12 and K9 with a nonzero residual against their plain versions on the same
    card tensors at K=1000 (ragged), H=50: the costs to the forward network
    kernels' bound, dQ to K7's (rtol 2e-5 plus 5e-6 of its largest
    entry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    optimizer = "rpgd-tf" if grad else "mppi"
    cfg = rpgd_config(num_rollouts=1000, mpc_horizon=50) if grad else optimizer_config(1000, 50)
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": optimizer, "controller_logging": False,
                                 "device": "cuda"})
    ctrl.configure(optimizer_name=optimizer, predictor_specification="ODE+res",
                   optimizer_config=cfg, cost_function_config=COST_WEIGHTS)
    pred = ctrl.optimizer.predictor.predictor
    gen = torch.Generator(device=dev).manual_seed(11)
    pred.set_residual({k: 0.02 * torch.randn(v.shape, generator=gen, device=dev)
                       if k.startswith("w") else v for k, v in pred._res.items()})
    model, pack = residual.residual_model(ctrl.optimizer)
    s0 = 0.05 * torch.randn(1000, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(1000, 50, 1, generator=gen, device=dev), -1.0, 1.0)
    params = ctrl._assemble_params()
    pvec, net = pack(params, torch.tensor([0.1], device=dev)), params["dyn"]["res"]
    if not grad:
        torch.testing.assert_close(residual_cost_rollout(model, s0, Q, pvec, net),
                                   residual_cost_rollout_plain(model, s0, Q, pvec, net),
                                   rtol=5e-5, atol=1e-3)
        return
    cost, dQ = residual_grad_cost_rollout(model, s0, Q, pvec, net)
    ref_cost, ref_dQ = residual_grad_cost_rollout_plain(model, s0, Q, pvec, net)
    torch.testing.assert_close(cost, ref_cost, rtol=5e-5, atol=1e-3)
    torch.testing.assert_close(dQ, ref_dQ, rtol=2e-5, atol=5e-6 * float(ref_dQ.abs().max()))
