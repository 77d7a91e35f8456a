"""The port's polynomial-trig path against the JAX package: ``ops/fastmath.py``,
the fast counter normals (``fast_sampling``), the ``:fast`` cartpole plant
and its adjoints, the fast forms' plain versions (K3, K5, K6 over the fast
normals; K1, K2, K4, K7, K12, K9 over the fast plant) and one step of each
optimizer over ``"ODE:rk4:1:fast"`` and ``"ODE+res:rk4:1:fast"``.

Tolerances, each with its reason:

* the polynomials: the same float32 operations in the same order as
  ``control_toolkit_tpu/ops/fastmath.py``; held to one float32 ulp of 1
  (FAST_ATOL) and reported bit for bit (``bit_equal``: equal on this CPU);
  their derivatives to ``jax.grad``'s to DERIV_ATOL (autodiff sums the
  Horner terms in another order);
* the fast normals to NORMAL_ATOL, as the exact ones (test_torch_prng.py):
  torch's CPU sqrt and XLA's differ by an ulp;
* the fast plant's adjoint to ``jax.vjp`` of the JAX fast derivs in float64
  to F64_TOL (rounding only), a bound that rejects the adjoint taking
  ``cos``/``-sin`` in place of the polynomials' derivatives by orders of
  magnitude (``record_property`` shows the distances);
* the kernels' plain versions and the optimizer steps to the bounds of the
  exact path's tests that they reuse (test_torch_cem.py, test_torch_fused_mppi.py,
  test_torch_fleet*.py, test_torch_rpgd.py, test_torch_value.py,
  test_torch_residual.py): the fast forms change the trig, not the sums.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cem as cem_tests
import test_torch_fleet as fleet_tests
import test_torch_fleet_cem as fleet_cem_tests
import test_torch_residual as residual_tests
from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.models import dynamics as jdyn
from control_toolkit_tpu.models.predictors import ODEPredictor as JaxODEPredictor
from control_toolkit_tpu.ops import fastmath as jfast
from control_toolkit_tpu.ops.pallas_cem import build_fused_cem_cols
from control_toolkit_tpu.ops.pallas_mppi import _normals_from_counter
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.models.dynamics import CARTPOLE_DEFAULTS, cartpole_dynamics
from control_toolkit_tpu_torch.models.predictors import ODEPredictor, PredictorWrapper
from control_toolkit_tpu_torch.models.residual_predictor import ResidualPredictor
from control_toolkit_tpu_torch.ops import fastmath, kernels
from control_toolkit_tpu_torch.ops.adjoints import (
    PLANT_ADJOINTS, cartpole_derivs_vjp, cartpole_fast_derivs_jac, cartpole_fast_derivs_vjp,
)
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout, cost_rollout_plain
from control_toolkit_tpu_torch.ops.counter_prng import _INV_2_24, normals_from_counter, splitmix32
from control_toolkit_tpu_torch.ops.fused_cem import (
    fused_cem_costs, fused_cem_costs_plain, regen_controls,
)
from control_toolkit_tpu_torch.ops.fused_cem_cols import regen_cols
from control_toolkit_tpu_torch.ops.fused_mppi import fused_mppi_step, mppi_noise
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.residual_grad_cost_rollout import residual_grad_cost_rollout
from control_toolkit_tpu_torch.ops.residual_rollout import residual_cost_rollout
from control_toolkit_tpu_torch.optimizers.kernel_families import ode, residual
from control_toolkit_tpu_torch.utils.convert import mppi_state_from_numpy, params_from_numpy
from test_torch_fused_mppi import K3_COST_TOL, step_inputs
from test_torch_grad import COST_TOL as K7_COST_TOL, GRAD_TOL, H as GH, K as GK, TILE as GT
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import (
    CPU, COST_TOL, LIMITS, UNOM_TOL, jax_next_draw, jax_params_numpy, optimizer_config,
    port_noise, set_shared_state,
)
from test_torch_prng import NORMAL_ATOL
from test_torch_rpgd import (
    assert_rpgd_states_match, jax_rpgd_draw, port_params, rpgd_config, set_rpgd_state,
)
from test_torch_value import attach_both, jax_value_net

FAST, RES_FAST = "ODE:rk4:1:fast", "ODE+res:rk4:1:fast"
FAST_ATOL = 1.2e-7    # one float32 ulp of 1.0
DERIV_ATOL = 2e-6
F64_TOL = dict(rtol=1e-10, atol=1e-10)
# JAX's own bound on a fast rollout's distance from the exact one
# (tests/test_fastmath.py test_fast_rollout_tracks_exact).
ROLLOUT_ATOL = 5e-3
# The counter whose u1 is 1.0 exactly (tests/test_fastmath.py:35-46).
U1_ONE = 30524660
K, H, TILE = 256, 20, 64


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_pair(optimizer="mppi", cfg=None, spec=FAST, jax_logging=False, target=0.3):
    """The JAX and the port controller over ``spec`` with one config."""
    cfg = dict(cfg or optimizer_config(K, H))
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": target},
                   config={"optimizer": optimizer, "controller_logging": jax_logging})
    jctrl.configure(optimizer_name=optimizer, predictor_specification=spec, optimizer_config=cfg)
    pctrl = MPCController("cartpole", LIMITS, {"target_position": target},
                          config={"device": "cpu", "optimizer": optimizer,
                                  "controller_logging": False})
    pctrl.configure(optimizer_name=optimizer, predictor_specification=spec, optimizer_config=cfg)
    return jctrl, pctrl


def with_params(jctrl, pctrl):
    return (jctrl, pctrl) + cem_tests.both_params(jctrl)


# ---- ops/fastmath.py -------------------------------------------------------------
def test_fast_trig_and_log_match_jax(record_property):
    x = np.linspace(-50.0, 50.0, 200001).astype(np.float32)
    u = np.concatenate([np.linspace(2.0**-25, 1.0, 100001),
                        np.logspace(-30, 30, 2001)]).astype(np.float32)
    pairs = {
        "sin": (fastmath.fast_sincos(torch.tensor(x))[0], jfast.fast_sincos(jnp.asarray(x))[0]),
        "cos": (fastmath.fast_sincos(torch.tensor(x))[1], jfast.fast_sincos(jnp.asarray(x))[1]),
        "fast_sin": (fastmath.fast_sin(torch.tensor(x)), jfast.fast_sin(jnp.asarray(x))),
        "fast_cos": (fastmath.fast_cos(torch.tensor(x)), jfast.fast_cos(jnp.asarray(x))),
        "log": (fastmath.fast_log(torch.tensor(u)), jfast.fast_log(jnp.asarray(u))),
    }
    bit_equal = {}
    for name, (got, ref) in pairs.items():
        got, ref = got.numpy(), np.asarray(ref)
        assert got.dtype == np.float32
        bit_equal[name] = bool(np.array_equal(got, ref))
        np.testing.assert_allclose(got, ref, rtol=FAST_ATOL, atol=FAST_ATOL, err_msg=name)
    record_property("bit_equal", bit_equal)
    # The approximations themselves (the JAX tests' bounds).
    s, c = fastmath.fast_sincos(torch.tensor(x))
    assert np.abs(s.numpy() - np.sin(x.astype(np.float64))).max() < 2e-5
    assert np.abs(c.numpy() - np.cos(x.astype(np.float64))).max() < 2e-5
    ref = np.log(u.astype(np.float64))
    bound = 5e-6 + np.float32(1.2e-7) * np.abs(ref)
    assert np.max(np.abs(fastmath.fast_log(torch.tensor(u)).numpy() - ref) - bound) < 0


def test_reduction_rounds_half_to_even():
    """x / 2pi at exactly k + 1/2 rounds to the even k, as jnp.round does."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5], dtype=torch.float64) * fastmath._TWO_PI
    got = fastmath._reduce(x) / fastmath._TWO_PI
    np.testing.assert_allclose(got.numpy(), [0.5, -0.5, 0.5, -0.5, 0.5], atol=1e-12)


def test_fast_derivatives_are_the_polynomials_own():
    """``fast_sincos_d``'s derivatives against ``jax.grad`` through the JAX
    polynomials, and against torch.autograd in float64 (round has a zero
    gradient); they are not cos and -sin."""
    x = np.linspace(-50.0, 50.0, 100001).astype(np.float32)
    ds_ref = jax.vmap(jax.grad(lambda v: jfast.fast_sincos(v)[0]))(jnp.asarray(x))
    dc_ref = jax.vmap(jax.grad(lambda v: jfast.fast_sincos(v)[1]))(jnp.asarray(x))
    s, c, ds, ndc = fastmath.fast_sincos_d(torch.tensor(x))
    np.testing.assert_array_equal(s.numpy(), fastmath.fast_sin(torch.tensor(x)).numpy())
    np.testing.assert_array_equal(c.numpy(), fastmath.fast_cos(torch.tensor(x)).numpy())
    np.testing.assert_allclose(ds.numpy(), np.asarray(ds_ref), rtol=0, atol=DERIV_ATOL)
    np.testing.assert_allclose(ndc.numpy(), -np.asarray(dc_ref), rtol=0, atol=DERIV_ATOL)
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    s64, c64 = fastmath.fast_sincos(x64)
    (g_s,) = torch.autograd.grad(s64.sum(), x64, retain_graph=True)
    (g_c,) = torch.autograd.grad(c64.sum(), x64)
    _, _, ds64, ndc64 = fastmath.fast_sincos_d(x64.detach())
    torch.testing.assert_close(ds64, g_s, **F64_TOL)
    torch.testing.assert_close(ndc64, -g_c, **F64_TOL)
    assert np.abs(ds.numpy() - np.cos(x.astype(np.float64))).max() > 1e-4


# ---- the fast counter normals ------------------------------------------------------
def test_fast_normals_match_jax():
    counters = np.concatenate([np.arange(1 << 16, dtype=np.uint64) * 2654435761 % 2**32,
                               [U1_ONE, 0, 2**32 - 1]]).astype(np.uint32)
    ref = np.asarray(_normals_from_counter(jnp.asarray(counters), fast=True))
    got = normals_from_counter(torch.tensor(counters.astype(np.int64)), fast=True).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=NORMAL_ATOL)
    exact = normals_from_counter(torch.tensor(counters.astype(np.int64))).numpy()
    assert not np.array_equal(got, exact) and np.abs(got - exact).max() < 1e-3
    assert abs(got.mean()) < 0.02 and abs(got.std() - 1.0) < 0.02


def test_the_clamp_keeps_u1_equal_one_finite():
    """u1 = 1.0: fast_log lands at +2e-6, so -2 log u1 < 0 and the sqrt
    would be NaN without the clamp at 0."""
    c = torch.tensor([U1_ONE])
    u1 = ((splitmix32(c) >> 8).to(torch.float32) + 1.0) * _INV_2_24
    assert float(u1) == 1.0 and float(fastmath.fast_log(u1)) > 0
    z = normals_from_counter(c, fast=True)
    assert torch.isfinite(z).all() and float(z) == 0.0
    np.testing.assert_allclose(z.numpy(), np.asarray(_normals_from_counter(
        jnp.asarray([U1_ONE], jnp.uint32), fast=True)), atol=NORMAL_ATOL)


# ---- the fast plant --------------------------------------------------------------
def plant_inputs(seed, n=512):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, 4)) * [1.0, 2.0, 3.0, 3.0]).astype(np.float32)
    u = rng.uniform(-1.0, 1.0, (n, 1)).astype(np.float32)
    return x, u


def test_fast_plant_derivs_and_rollout_match_jax():
    """The fast derivs and the scan rollout of ODEPredictor(fast_math=True)
    against the JAX package's; both differ from the exact plant's, within
    JAX's rollout bound."""
    assert cartpole_dynamics.fast is not cartpole_dynamics
    x, u = plant_inputs(0)
    p = dict(CARTPOLE_DEFAULTS, friction_cart=0.3, friction_pole=0.05)
    got = cartpole_dynamics.fast(torch.tensor(x), torch.tensor(u), p).numpy()
    ref = np.asarray(jdyn.cartpole_dynamics.fast(jnp.asarray(x), jnp.asarray(u), p))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(1)
    s0 = (0.3 * rng.standard_normal((16, 4))).astype(np.float32)
    Q = rng.uniform(-1, 1, (16, 50, 1)).astype(np.float32)
    fast, exact = ODEPredictor(dt=0.02, fast_math=True), ODEPredictor(dt=0.02)
    assert fast.fast_math and fast.dynamics is cartpole_dynamics.fast
    a = fast.rollout(torch.tensor(s0), torch.tensor(Q)).numpy()
    b = exact.rollout(torch.tensor(s0), torch.tensor(Q)).numpy()
    ref = np.asarray(JaxODEPredictor("cartpole", dt=0.02, fast_math=True).rollout(
        jnp.asarray(s0), jnp.asarray(Q)))
    np.testing.assert_allclose(a, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(a, b, atol=ROLLOUT_ATOL)
    assert not np.array_equal(a, b)


def port_p(dtype=torch.float64):
    p = dict(CARTPOLE_DEFAULTS, friction_cart=0.3, friction_pole=0.05)
    return {f"d_{k}": torch.tensor(v, dtype=dtype) for k, v in p.items()}


def test_fast_adjoint_matches_jax_vjp_in_float64(record_property):
    """``cartpole_fast_derivs_vjp`` against ``jax.vjp`` of the JAX fast
    derivs, both in float64; the bound rejects an adjoint that takes the
    fast values with the exact derivatives (cos, -sin)."""
    x, u = plant_inputs(2)
    rng = np.random.default_rng(3)
    lam = rng.standard_normal((x.shape[0], 4))
    jp = dict(CARTPOLE_DEFAULTS, friction_cart=0.3, friction_pole=0.05)
    with jax.enable_x64(True):
        xs = tuple(jnp.asarray(x[:, i], jnp.float64) for i in range(4))
        us = (jnp.asarray(u[:, 0], jnp.float64),)
        _, vjp = jax.vjp(lambda a, b: jdyn.cartpole_derivs_soa_fast(a, b, jp), xs, us)
        rx, ru = vjp(tuple(jnp.asarray(lam[:, i]) for i in range(4)))
        ref = np.stack([np.asarray(v) for v in rx + ru], axis=1)
    txs = tuple(torch.tensor(x[:, i], dtype=torch.float64) for i in range(4))
    tus = (torch.tensor(u[:, 0], dtype=torch.float64),)
    tlam = tuple(torch.tensor(lam[:, i]) for i in range(4))
    p = port_p()

    def stacked(vjp_fn, **kw):
        dx, du = vjp_fn(txs, tus, p, tlam, **kw)
        return torch.stack(dx + du, dim=1).numpy()

    got = stacked(cartpole_fast_derivs_vjp)
    mutant = stacked(cartpole_derivs_vjp, sincos_d=lambda th: (
        *fastmath.fast_sincos(th), th.cos(), th.sin()))
    bound = F64_TOL["atol"] + F64_TOL["rtol"] * np.abs(ref)
    record_property("adjoint_f64_distances", {
        "fast_max_abs_err": float(np.abs(got - ref).max()),
        "mutant_max_abs_err": float(np.abs(mutant - ref).max()),
        "bound_max": float(bound.max())})
    assert np.all(np.abs(got - ref) <= bound)
    assert np.abs(mutant - ref).max() > 1e3 * bound.max()
    assert PLANT_ADJOINTS["cartpole_fast"][0] is cartpole_fast_derivs_vjp


def test_fast_jacobian_matches_autograd_in_float64():
    """``cartpole_fast_derivs_jac`` (K7's forward-mode Jacobians over the
    fast plant) against torch.autograd through the fast derivs."""
    x, u = plant_inputs(4, n=64)
    xs = tuple(torch.tensor(x[:, i], dtype=torch.float64, requires_grad=True) for i in range(4))
    us = (torch.tensor(u[:, 0], dtype=torch.float64, requires_grad=True),)
    p = {k[2:]: v for k, v in port_p().items()}
    f_ref = cartpole_dynamics.fast.soa(xs, us, p)
    f, J = cartpole_fast_derivs_jac(xs, us, port_p())
    for i in range(4):
        torch.testing.assert_close(f[i], f_ref[i].detach(), **F64_TOL)
        grads = torch.autograd.grad(f_ref[i].sum(), xs + us, retain_graph=True, allow_unused=True)
        for n, g in enumerate(grads):
            ref = torch.zeros(64, dtype=torch.float64) if g is None else g
            torch.testing.assert_close(J[:, i, n], ref, **F64_TOL)


# ---- the spec grammar and the plant key ------------------------------------------------
def test_spec_grammar_and_plant_key():
    w = PredictorWrapper()
    w.configure(device="cpu", dt=0.02, predictor_specification=FAST)
    pred = w.predictor
    assert pred.fast_math and (pred.integrator, pred.intermediate_steps) == ("rk4", 1)
    assert kernels.plant_key(pred) == "cartpole_fast"
    w.configure(device="cpu", dt=0.02, predictor_specification="ODE:euler:2")
    assert not w.predictor.fast_math and w.predictor.intermediate_steps == 2
    assert kernels.plant_key(w.predictor) == "cartpole"
    w.configure(device="cpu", dt=0.02, predictor_specification="ODE:fast:euler")
    assert w.predictor.fast_math and w.predictor.integrator == "euler"
    w.configure(device="cpu", dt=0.02, predictor_specification=RES_FAST)
    res = w.predictor
    assert isinstance(res, ResidualPredictor) and res.fast_math and res.base.fast_math
    assert kernels.plant_key(res) == "cartpole_fast"
    assert res.base.dynamics is cartpole_dynamics.fast


def test_a_plant_without_a_fast_variant_keeps_exact_trig(caplog):
    def double_integrator(x, u, p):
        return torch.stack([x[..., 1], u[..., 0]], dim=-1)

    pred = ODEPredictor(dynamics=double_integrator, num_states=2, num_control_inputs=1,
                        fast_math=True)
    assert pred.dynamics is double_integrator
    assert "no .fast variant" in caplog.text


def test_fast_plant_layout_and_unknown_plants():
    """The fast plant keeps cartpole's dims and packed layout; a plant the
    device does not have is refused before any launch."""
    assert kernels.PLANT_DIMS["cartpole_fast"] == kernels.PLANT_DIMS["cartpole"]
    assert kernels.PLANT_PARAM_KEYS["cartpole_fast"] == kernels.PLANT_PARAM_KEYS["cartpole"]
    assert kernels.PLANT_IDS["cartpole_fast"] != kernels.PLANT_IDS["cartpole"]
    _, pctrl = make_pair()
    model, _ = ode.rollout_model(pctrl.optimizer)
    assert model.plant == "cartpole_fast" and model.fast_math
    with pytest.raises(ValueError, match="no device plant"):
        dataclasses.replace(model, plant="segway_fast")


def test_exact_specs_stay_exact():
    """Nothing exact turns fast: the exact spec's model, draws and adjoint."""
    w = PredictorWrapper()
    w.configure(device="cpu", dt=0.02, predictor_specification="ODE")
    assert not w.predictor.fast_math and kernels.plant_key(w.predictor) == "cartpole"
    _, pctrl = cem_tests.make_pair(**cem_tests.cem_config())
    model, _ = ode.rollout_model(pctrl.optimizer)
    assert model.plant == "cartpole" and not model.fast_math


# ---- the fast forms' plain versions against the JAX kernels in interpret mode ------------
@pytest.fixture(scope="module")
def cem_pair():
    return with_params(*make_pair("cem-tf", cem_tests.cem_config()))


@pytest.mark.parametrize("seed2", [(77, 0), (123456, 7)])
def test_k5_fast_plain_matches_pallas_interpret(cem_pair, seed2):
    """K5's fast_sampling form (``_build_fused_cem`` takes it from the fast
    predictor) against the port's K5 plain version over the fast plant."""
    assert cem_pair[1].optimizer.predictor.predictor.fast_math
    cem_tests.test_k5_plain_matches_pallas_interpret(cem_pair, seed2)


def test_fast_regen_controls_match_jax_regen(cem_pair):
    jctrl, pctrl, jparams, params = cem_pair
    _, regen, jpack = jctrl.optimizer._build_fused_cem(interpret=True, tile_k=cem_tests.TILE)
    s0, mue, std, u_prev, sd = cem_tests.k5_inputs((5, 0))
    std = 2.0 * std
    Kc = cem_tests.K
    idx = np.random.default_rng(0).permutation(Kc)[:40]
    ref = np.asarray(regen(jnp.asarray(sd), jnp.asarray(idx), jnp.asarray(mue),
                           jnp.asarray(std), Kc))
    popt = pctrl.optimizer
    args = (torch.tensor(sd), torch.tensor(idx), torch.tensor(mue), torch.tensor(std),
            popt.action_low, popt.action_high, Kc, cem_tests.TILE)
    got = regen_controls(*args, fast=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=cem_tests.Q_ATOL)
    assert not np.array_equal(got, regen_controls(*args, fast=False).numpy())
    # The fast K5 plain version is K1's plain version over its fast rows.
    model, pack = ode.rollout_model(popt)
    pvec = pack(params, torch.tensor(u_prev))
    full = regen_controls(torch.tensor(sd), torch.arange(Kc), torch.tensor(mue),
                          torch.tensor(std), popt.action_low, popt.action_high, Kc,
                          cem_tests.TILE, fast=True)
    np.testing.assert_array_equal(
        fused_cem_costs_plain(model, torch.tensor(s0), torch.tensor(mue), torch.tensor(std),
                              pvec, torch.tensor(sd), popt.action_low, popt.action_high, Kc,
                              cem_tests.TILE).numpy(),
        cost_rollout_plain(model, torch.tensor(s0).expand(Kc, -1), full, pvec).numpy())


def fused_mppi_pair():
    jctrl, pctrl = make_pair()
    kernel_step, jpack, _ = jctrl.optimizer._build_fused_mppi(interpret=True, tile_k=TILE)
    return jctrl, pctrl, kernel_step, jpack


@pytest.mark.parametrize("seed", [1234567, 2**31 - 2])
def test_k3_fast_plain_matches_pallas_interpret(seed):
    """K3's fast_sampling form: both passes over the fast normals, pass 1
    over the fast plant (K3_COST_TOL and UNOM_TOL of test_torch_fused_mppi)."""
    jctrl, pctrl, kernel_step, jpack = fused_mppi_pair()
    popt = pctrl.optimizer
    jparams = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                     jctrl._assemble_params())
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    s0, u_nom, u_prev = step_inputs()
    un_j, c_j = kernel_step(jnp.asarray(s0), jnp.asarray(u_nom),
                            jpack(jparams, jnp.asarray(u_prev)), jnp.array([seed], jnp.int32))
    model, pack = ode.rollout_model(popt)
    args = (model, torch.tensor(s0), torch.tensor(u_nom), pack(params, torch.tensor(u_prev)),
            torch.tensor([seed, 0], dtype=torch.int32), popt.interp.matrix, popt.action_low,
            popt.action_high, popt.cc_weight, popt.R, popt.NU, popt.LBD, popt.SQRTRHODTINV, K,
            TILE)
    un_p, c_p = fused_mppi_step(*args)
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j), **K3_COST_TOL)
    np.testing.assert_allclose(un_p.numpy(), np.asarray(un_j), **UNOM_TOL)
    # Over the exact normals the same step is another one.
    exact = dataclasses.replace(model, plant="cartpole")
    assert not torch.equal(fused_mppi_step(exact, *args[1:])[1], c_p)
    noise = mppi_noise(args[4], K, args[5].shape[0], 1, TILE, fast=True)
    assert not torch.equal(noise, mppi_noise(args[4], K, args[5].shape[0], 1, TILE, fast=False))


@pytest.fixture(scope="module")
def fleet_cem_pair():
    return with_params(*make_pair("cem-tf", cem_tests.cem_config(
        K=fleet_cem_tests.K, H=fleet_cem_tests.H, fully_fused=True)))


@pytest.mark.parametrize("B", [2, 4])
def test_k6_fast_plain_matches_pallas_cols(fleet_cem_pair, B, monkeypatch):
    """K6's fast_sampling form: the JAX ``build_fused_cem_cols`` with
    ``fast_sampling=True`` (as the JAX fleet step builds it over a fast
    predictor) against the port's K6 plain version over the fast plant."""
    monkeypatch.setattr(fleet_cem_tests, "build_fused_cem_cols",
                        functools.partial(build_fused_cem_cols, fast_sampling=True))
    fleet_cem_tests.test_k6_plain_matches_pallas_cols(fleet_cem_pair, B)


def test_fast_regen_cols_match_jax(fleet_cem_pair, monkeypatch):
    jctrl, pctrl, _, _ = fleet_cem_pair
    monkeypatch.setattr(fleet_cem_tests, "build_fused_cem_cols",
                        functools.partial(build_fused_cem_cols, fast_sampling=True))
    B, Kc = 4, fleet_cem_tests.K
    x = fleet_cem_tests.sessions(B, seed=5)
    idx = np.stack([np.random.default_rng(b).permutation(Kc)[:24] for b in range(B)])
    _, regen, _, _ = fleet_cem_tests.jax_cols(jctrl.optimizer, B)
    popt = pctrl.optimizer
    std = 3.0 * x["std"]
    args = (torch.tensor(x["seed"]), torch.tensor(idx), torch.tensor(x["mue"]), torch.tensor(std),
            popt.action_low, popt.action_high, Kc)
    Q = regen_cols(*args, fast=True).numpy()
    for b in range(B):
        ref = np.asarray(regen(jnp.asarray(x["seed"][b]), jnp.asarray(idx[b]),
                               jnp.asarray(x["mue"][b]), jnp.asarray(std[b])))
        np.testing.assert_allclose(Q[b], ref, rtol=0, atol=NORMAL_ATOL)
    assert not np.array_equal(Q, regen_cols(*args, fast=False).numpy())


def test_k7_fast_plain_matches_pallas_grad_interpret_and_autograd():
    """K7's plain version over the fast plant (its adjoint takes the
    polynomials' derivatives) against the JAX gradient kernel over the
    fast predictor in interpret mode (test_torch_grad.py's bounds), and
    against torch.autograd through K1's fast plain version in float64."""
    jctrl, pctrl = make_pair("rpgd-tf", rpgd_config(num_rollouts=GK, mpc_horizon=GH))
    rng = np.random.default_rng(4)
    s0 = (0.2 * rng.standard_normal((GK, 4))).astype(np.float32)
    Q = rng.uniform(-0.8, 0.8, (GK, GH, 1)).astype(np.float32)
    u_prev = np.array([0.1], np.float32)
    kernel = jctrl.optimizer._build_pallas_grad(interpret=True, tile_k=GT)
    ref_cost, ref_grad = map(np.asarray, kernel(jnp.asarray(s0), jnp.asarray(Q),
                                                jnp.asarray(u_prev), jctrl._assemble_params()))
    popt = pctrl.optimizer
    assert ode.can_use_grad(popt)
    model, pack = ode.rollout_model(popt)
    pvec = pack(params_from_numpy(jax_params_numpy(jctrl), CPU), torch.as_tensor(u_prev))
    before = grad_cost_rollout.launches
    cost, dQ = grad_cost_rollout(model, torch.as_tensor(s0), torch.as_tensor(Q), pvec)
    assert grad_cost_rollout.launches == before
    np.testing.assert_allclose(cost.numpy(), ref_cost, **K7_COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), ref_grad, **GRAD_TOL)
    Q64 = torch.tensor(Q, dtype=torch.float64, requires_grad=True)
    s64, p64 = torch.tensor(s0, dtype=torch.float64), pvec.double()
    (auto,) = torch.autograd.grad(cost_rollout_plain(model, s64, Q64, p64).sum(), Q64)
    _, dQ64 = grad_cost_rollout_plain(model, s64, Q64.detach(), p64)
    torch.testing.assert_close(dQ64, auto, **F64_TOL)


# ---- one step of each optimizer over the fast plant, fed the JAX draws ---------------------
@pytest.mark.parametrize("extra,semi_fused", [({}, True), ({"semi_fused": False}, False)])
def test_one_fast_mppi_step_matches_jax(extra, semi_fused):
    """Semi-fused (K2's plain version) and modular (K1's) MPPI over the fast
    plant, fed the JAX step's noise."""
    jctrl, pctrl = make_pair(cfg=optimizer_config(K, H, **extra))
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


def test_one_fully_fused_fast_mppi_step_matches_jax():
    """The optimizer's fully-fused update over the fast plant (K3's
    fast_sampling form), fed the JAX step's seed."""
    jctrl, pctrl = make_pair(cfg=optimizer_config(K, H, fully_fused=True))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    jopt._can_fully_fuse = lambda: True
    build = jopt._build_fused_mppi
    jopt._build_fused_mppi = lambda **kw: build(interpret=True, tile_k=TILE, **kw)
    jopt._build()
    popt.fused_tile_k = TILE
    popt._build()
    assert popt._can_fully_fuse() and not popt._uses_semi_fused()
    rng = np.random.default_rng(2)
    u_nom = rng.uniform(-0.5, 0.5, (1, H, 1)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    jopt.opt_state = jopt.opt_state._replace(u_nom=jnp.asarray(u_nom), u_prev=jnp.asarray(u_prev))
    popt.opt_state = mppi_state_from_numpy(u_nom, u_prev, popt.opt_state.generator)
    _, sub = jax.random.split(jopt.opt_state.key)
    seed = int(jax.random.randint(sub, (1,), 0, 2**31 - 1, dtype=jnp.int32)[0])
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_jax = jctrl.step(s)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    u, _, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params,
                             torch.tensor([seed, 0], dtype=torch.int32))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


def test_one_fused_fast_cem_step_matches_jax():
    """One fused CEM step over the fast plant (K5's fast_sampling form and
    the fast elite regeneration), fed the JAX seeds."""
    jctrl, pctrl = make_pair("cem-tf", cem_tests.cem_config(fully_fused=True))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    cem_tests.use_fused(jctrl, pctrl, TILE)
    cem_tests.set_shared_state(jopt, popt, 1)
    draws = cem_tests.jax_draws(jopt, 2, fused=True)
    jparams, params = cem_tests.both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]),
                               **COST_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    np.testing.assert_allclose(st.dist_mue.numpy(), np.asarray(st_j.dist_mue), **UNOM_TOL)
    np.testing.assert_allclose(st.stdev.numpy(), np.asarray(st_j.stdev), **UNOM_TOL)


@pytest.mark.parametrize("count", [0, 7])
def test_one_fast_rpgd_update_matches_jax(count):
    """rpgd-tf over the fast plant (K7's and K1's plain versions), on a
    resample tick and a keep tick, fed the JAX draw."""
    jctrl, pctrl = make_pair("rpgd-tf", rpgd_config(), jax_logging=True)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert ode.can_use_grad(popt) and ode.rollout_model(popt)[0].plant == "cartpole_fast"
    set_rpgd_state(jopt, popt, count)
    s = np.array([0.1, -0.05, 0.2, 0.3], np.float32)
    draw = torch.as_tensor(jax_rpgd_draw(jopt)) if count % 10 == 0 else None
    u_jax = jctrl.step(s)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], port_params(jctrl), draw)
    assert_rpgd_states_match(jopt, state, diag, u, u_jax)


def test_one_valued_fast_mppi_step_matches_jax():
    """Semi-fused MPPI with a learned value terminal over the fast plant
    (K2's emit_terminal form's plain version)."""
    jctrl, pctrl = make_pair()
    attach_both(jctrl, pctrl, jax_value_net(9), scale=4.0)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt._uses_semi_fused()
    set_shared_state(jopt, popt)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    delta = jax_next_draw(jopt)
    u_jax = jctrl.step(s)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    u, _, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                             port_noise(popt, delta))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


@pytest.fixture(scope="module")
def fleet_pair():
    return make_pair(cfg=optimizer_config(fleet_tests.K, fleet_tests.H), target=0.1)


def test_fast_k4_plain_and_fleet_update_match_jax(fleet_pair):
    """K4's plain version and the batched MPPI update (per-slot pole
    lengths) over the fast plant, fed the same noise."""
    assert ode.rollout_model(fleet_pair[1].optimizer)[0].plant == "cartpole_fast"
    fleet_tests.test_k4_plain_matches_pallas_cols(fleet_pair)
    fleet_tests.test_update_from_eps_matches_jax(fleet_pair)


def test_one_fast_fleet_cem_step_matches_jax(fleet_cem_pair):
    """One batched fused CEM step over the fast plant (K6's fast_sampling
    form and regen_cols(fast)), fed the JAX seeds."""
    fleet_cem_tests.test_one_batched_fused_cem_step_matches_jax(fleet_cem_pair)


def test_fast_residual_mppi_and_rpgd_ticks_match_jax():
    """MPPI (K12's plain version) and rpgd-tf (K9's and K12's) over
    ``"ODE+res:rk4:1:fast"`` with a nonzero residual, as
    test_torch_residual.py's ticks; the base is the fast plant."""
    jctrl, pctrl = residual_tests.make_pair(spec=RES_FAST)
    popt = pctrl.optimizer
    model, _ = residual.residual_model(popt)
    assert model.plant == "cartpole_fast" and residual.can_use_cost(popt)
    rng = np.random.default_rng(7)
    for _ in range(2):
        s = (0.05 * rng.standard_normal(4)).astype(np.float32)
        eps = port_noise(popt, jax_next_draw(jctrl.optimizer))
        popt.sample_noise = lambda state, eps=eps: eps
        np.testing.assert_allclose(pctrl.step(s), jctrl.step(s), **UNOM_TOL)
    jctrl, pctrl = residual_tests.make_pair(
        "rpgd-tf", rpgd_config(num_rollouts=residual_tests.K, mpc_horizon=residual_tests.H),
        jax_logging=True, spec=RES_FAST)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert residual.can_use_grad(popt)
    set_rpgd_state(jopt, popt, count=0, seed=5)
    captured, step_fn = [], popt._step_fn
    popt._step_fn = lambda st, s, p: captured.append(step_fn(st, s, p)) or captured[-1]
    s = np.array([0.02, -0.01, 0.05, 0.03], np.float32)
    draw = jax_rpgd_draw(jopt)
    popt.sample_resample = lambda state, d=draw: torch.as_tensor(d)
    jctrl.step(s)
    pctrl.step(s)
    np.testing.assert_allclose(captured[-1][2]["J_logged"].numpy(),
                               jopt.logging_values["J_logged"], **residual_tests.COST_TOL)
    np.testing.assert_allclose(popt.opt_state.Q.numpy(), np.asarray(jopt.opt_state.Q),
                               rtol=1e-4, atol=1e-5)


# ---- on the card --------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_fast_forms_match_plain_versions(cem_pair, cuda_device):
    """K1 and K5 over the fast plant against their plain versions on the
    card; K5's costs equal K1's over the controls regen_controls(fast) draws
    again (the fast normals drawn bit for bit)."""
    _, pctrl, _, params = cem_pair
    popt = pctrl.optimizer
    model, pack = ode.rollout_model(popt)
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)
    Kc, Hc = 2048, 50
    pvec = pack(params, torch.tensor([0.1])).to(dev)
    s0 = 0.05 * torch.randn(Kc, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(Kc, Hc, 1, generator=gen, device=dev), -1.0, 1.0)
    torch.testing.assert_close(cost_rollout(model, s0, Q, pvec),
                               cost_rollout_plain(model, s0, Q, pvec), rtol=1e-4, atol=1e-3)
    mue = torch.zeros(Hc, 1, device=dev)
    std = torch.full((Hc, 1), 0.5, device=dev)
    seed2 = torch.tensor([77, 0], dtype=torch.int32, device=dev)
    lim = torch.ones(1, device=dev)
    got = fused_cem_costs(model, s0[0], mue, std, pvec, seed2, -lim, lim, Kc, Kc)
    rows = regen_controls(seed2, torch.arange(Kc, device=dev), mue, std, -lim, lim, Kc, Kc,
                          fast=True)
    assert torch.equal(got, cost_rollout(model, s0[:1].expand(Kc, -1).contiguous(), rows, pvec))


def test_k12_and_k9_fast_plain_match_pallas_interpret():
    """K12's and K9's plain versions over the fast base plant (a nonzero
    residual) against the JAX residual kernels over the fast predictor in
    interpret mode (test_torch_residual.py's bounds)."""
    jctrl, pctrl = residual_tests.make_pair(
        "rpgd-tf", rpgd_config(num_rollouts=residual_tests.K, mpc_horizon=residual_tests.H),
        spec=RES_FAST)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert residual.can_use_grad(popt)
    s_tiled, Q, u_prev = residual_tests.inputs(4)
    jparams = jctrl._assemble_params()
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    ref = np.asarray(jopt._build_pallas_residual_cost(interpret=True, tile_k=64)(
        jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev), jparams))
    ref_cost, ref_dq = jopt._build_pallas_residual_grad(interpret=True, tile_k=64)(
        jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev), jparams)
    model, pack = residual.residual_model(popt)
    assert model.plant == "cartpole_fast"
    args = (model, torch.tensor(s_tiled), torch.tensor(Q), pack(params, torch.tensor(u_prev)),
            params["dyn"]["res"])
    np.testing.assert_allclose(residual_cost_rollout(*args).numpy(), ref,
                               **residual_tests.COST_TOL)
    cost, dQ = residual_grad_cost_rollout(*args)
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **residual_tests.COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), np.asarray(ref_dq), **residual_tests.GRAD_TOL)
