"""The port's mppi-optimize (MPPI with ``optim_steps`` Adam steps on the
nominal plan) against the JAX package.

The refinement's objective is JAX's ``nom_cost`` (``mppi.py:907-913``):
the nominal plan's ``_fused_cost`` from ``s[:1]``, without the risk term
and the robust aggregate.  Its gradient in the port is the model family's
gradient kernel at one rollout (K7, K7-fast, K8; on CPU tensors their
plain versions), held here to ``jax.grad`` of the JAX optimizer's
``_fused_cost`` and the JAX ``clip_by_norm``, ``adam_update`` and clip
loop from the same plan.  The modular step is held to the JAX step, which
is the path the JAX package takes on the CPU, fed the same draws.

Adam's first steps are about ``lr * sign(g)`` whatever ``|g|``, so a
float32 difference in a gradient entry near 0 could grow to ``2 lr``; the
refined plans below are held at the MPPI tolerance directly, and where an
entry's gradient is that small the test says so (``tiny_grad_entries``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.ops.common import adam_init as jax_adam_init
from control_toolkit_tpu.ops.common import adam_update as jax_adam_update
from control_toolkit_tpu.ops.common import clip_by_norm as jax_clip_by_norm
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.utils.config import load_optimizer_config
from control_toolkit_tpu_torch.utils.convert import params_from_numpy

from test_torch_mppi import (
    CPU, LIMITS, UNOM_TOL, jax_next_draw, jax_params_numpy, optimizer_config, port_noise,
    set_shared_state,
)

REPO_ASSETS = __import__("pathlib").Path(__file__).resolve().parent.parent / \
    "control_toolkit_tpu_torch" / "assets" / "cartpole"
MLP_SPEC = f"neural:mlp-64-64:{REPO_ASSETS}"
ENSEMBLE_SPEC = f"ensemble:mlp-32-32:4:{REPO_ASSETS}"
K, H, STEPS = 64, 15, 5
# The refinement's gradient against jax.grad on the same plan: float32
# sums over H rk4 steps and their adjoints.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# A gradient entry this small relative to the largest is one whose Adam
# step's sign float32 rounding may decide (see the module docstring).
TINY_GRAD = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def refine_config(**extra):
    cfg = dict(optim_steps=STEPS, mppi_LR=0.05, adam_beta_1=0.4, adam_beta_2=0.8,
               adam_epsilon=1e-7, gradmax_clip=1000.0)
    cfg.update(extra)
    return optimizer_config(K, H, **cfg)


def controllers(env="cartpole", spec="ODE", attrs=None, limits=LIMITS, **extra):
    """The JAX and the port mppi-optimize controllers on one configuration."""
    attrs = {"target_position": 0.3} if attrs is None else attrs
    cfg = refine_config(**extra)
    jctrl = JaxMPC(env, limits, dict(attrs),
                   config={"optimizer": "mppi-optimize-tf", "controller_logging": False})
    jctrl.configure(optimizer_name="mppi-optimize-tf", predictor_specification=spec,
                    optimizer_config=dict(cfg))
    pctrl = MPCController(env, limits, dict(attrs),
                          config={"device": "cpu", "optimizer": "mppi-optimize-tf",
                                  "controller_logging": False})
    pctrl.configure(optimizer_name="mppi-optimize-tf", predictor_specification=spec,
                    optimizer_config=dict(cfg))
    return jctrl, pctrl


def both_params(jctrl):
    tree = jctrl._assemble_params()
    return (jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree),
            params_from_numpy(jax_params_numpy(jctrl), CPU))


def jax_refine(jopt, u_nom, s, u_prev, jparams):
    """JAX's refinement arithmetic (mppi.py:899-928) from ``u_nom``."""
    def nom_cost(un):
        return jnp.sum(jopt._fused_cost(jnp.asarray(s[None]), un, jnp.asarray(u_prev), jparams))

    grad = jax.grad(nom_cost)
    un, ad = jnp.asarray(u_nom), jax_adam_init(u_nom.shape)
    for _ in range(jopt.optim_steps):
        g = jax_clip_by_norm(grad(un), jopt.gradmax_clip, axes=(1, 2))
        ad, delta = jax_adam_update(ad, g, jopt.mppi_LR, jopt.adam_beta_1, jopt.adam_beta_2,
                                    jopt.adam_epsilon)
        un = jnp.clip(un - delta, jopt.action_low, jopt.action_high)
    return np.asarray(un), np.asarray(grad(jnp.asarray(u_nom)))


def no_autograd(monkeypatch):
    """``torch.autograd.grad`` raising: the refinement must take a kernel."""
    def refuse(*a, **k):
        raise AssertionError("the refinement took torch.autograd")

    monkeypatch.setattr(torch.autograd, "grad", refuse)


# ---- the modular step -------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["ODE", "ODE:rk4:1:fast"])
def test_modular_step_matches_jax(spec):
    """One modular mppi-optimize step (the MPPI update, then STEPS Adam
    steps on nom_cost through K7's plain version) against the JAX step on
    the CPU, fed the same draws: u_nom to the MPPI tolerance
    (rtol 1e-4, atol 1e-5)."""
    jctrl, pctrl = controllers(spec=spec, semi_fused=False)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert not popt._uses_semi_fused() and popt.optim_steps == jopt.optim_steps == STEPS
    set_shared_state(jopt, popt)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    delta = jax_next_draw(jopt)
    u_jax = jctrl.step(s)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                                 port_noise(popt, delta))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom),
                               **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)
    np.testing.assert_array_equal(state.u_prev.numpy(), u.numpy())


# ---- the refinement ----------------------------------------------------------------------
CASES = {
    "cartpole": dict(env="cartpole", spec="ODE"),
    "cartpole_fast": dict(env="cartpole", spec="ODE:rk4:1:fast"),
    "pendulum": dict(env="pendulum", spec="ODE", attrs={}),
    "mlp": dict(env="cartpole", spec=MLP_SPEC),
}
STARTS = {"cartpole": np.array([0.1, -0.05, 0.3, 0.2], np.float32),
          "pendulum": np.array([2.5, 0.4], np.float32)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_refinement_matches_jax_arithmetic(case, monkeypatch):
    """The port's refinement from a seeded plan against jax.grad of the
    JAX optimizer's _fused_cost, its clip_by_norm, adam_update and clip:
    the first gradient to GRAD_TOL (rtol 1e-4, atol 1e-5), the refined
    plan to the MPPI tolerance; the gradient is the family's kernel (K7,
    K7-fast, K8 plain versions), never torch.autograd.  The ODE cases
    take the semi-fused path (K2), the MLP the modular one (K11)."""
    kw = CASES[case]
    jctrl, pctrl = controllers(**kw)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt._uses_semi_fused() == (kw["spec"] != MLP_SPEC)
    s = STARTS[kw["env"]]
    rng = np.random.default_rng(11)
    u0 = rng.uniform(-0.6, 0.6, (1, H, 1)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    jparams, pparams = both_params(jctrl)
    want, g_jax = jax_refine(jopt, u0, s, u_prev, jparams)

    no_autograd(monkeypatch)
    s_t, up = torch.as_tensor(s)[None], torch.as_tensor(u_prev)
    g = popt._make_nominal_grad()(torch.tensor(u0), s_t, up, pparams)
    got = popt._make_refine()(torch.tensor(u0), s_t, up, pparams)
    np.testing.assert_allclose(g.numpy(), g_jax, **GRAD_TOL)
    assert np.abs(g_jax).min() > TINY_GRAD * np.abs(g_jax).max(), "tiny_grad_entries"
    np.testing.assert_allclose(got.numpy(), want, **UNOM_TOL)
    assert not np.allclose(want, u0)  # the refinement moved the plan


def test_semi_fused_step_refines_the_k2_update():
    """A semi-fused mppi-optimize update is the semi-fused MPPI update
    followed by the refinement from its plan, and the applied control is
    the refined plan's first action."""
    jctrl, pctrl = controllers()
    popt = pctrl.optimizer
    plain = controllers(optim_steps=0)[1].optimizer
    set_shared_state(jctrl.optimizer, popt)
    plain.opt_state = popt.opt_state
    s = torch.tensor([[0.1, -0.05, 0.3, 0.2]])
    params = both_params(jctrl)[1]
    eps = torch.tensor(np.random.default_rng(2).standard_normal(popt._noise_shape),
                       dtype=torch.float32) * popt.SQRTRHODTINV
    u, state, diag = popt.update(popt.opt_state, s, params, eps)
    _, _, mppi_diag = plain.update(plain.opt_state, s, params, eps)
    want = popt._make_refine()(mppi_diag["u_nom"], s, popt.opt_state.u_prev, params)
    torch.testing.assert_close(diag["u_nom"], want, rtol=0, atol=0)
    torch.testing.assert_close(u, want[0, 0], rtol=0, atol=0)
    torch.testing.assert_close(diag["J_logged"], mppi_diag["J_logged"], rtol=0, atol=0)


# ---- the rest ----------------------------------------------------------------------------
def test_refined_plan_is_no_worse():
    """Counterpart of JAX tests/test_mppi.py:88: from the same seed and
    state, mppi-optimize's nominal plan costs no more than plain MPPI's
    (to 1e-3)."""
    def make(**extra):
        ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                             config={"device": "cpu", "optimizer": "mppi",
                                     "controller_logging": False})
        ctrl.configure(optimizer_name="mppi",
                       optimizer_config=optimizer_config(128, 20, **extra))
        return ctrl

    base, refined = make(), make(optim_steps=5, mppi_LR=0.05)
    s = np.array([0.0, 0.0, 0.3, 0.0], np.float32)
    for _ in range(3):
        base.step(s)
        refined.step(s)

    def nom_cost(ctrl):
        o = ctrl.optimizer
        return float(o._fused_cost(torch.tensor(s[None]), o.optimal_control_sequence,
                                   o.opt_state.u_prev, ctrl._assemble_params())[0])

    assert nom_cost(refined) <= nom_cost(base) + 1e-3, (nom_cost(refined), nom_cost(base))


def test_defaults_build_and_tick():
    """mppi-optimize-tf from the port's config_defaults (K=400, H=35, 10
    Adam steps; the JAX package's config_optimizers.yml:272-288) builds
    and ticks on the CPU, its refinement on K7 (plain version here)."""
    cfg = load_optimizer_config("mppi-optimize-tf")
    assert cfg["optim_steps"] == 10 and cfg["num_rollouts"] == 400
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": "cpu", "optimizer": "mppi-optimize-tf",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name="mppi-optimize-tf",
                   cost_function_config={"dd_weight": 120.0, "ep_weight": 10000.0,
                                         "ekp_weight": 10.0, "cc_weight": 1.0,
                                         "ccrc_weight": 1.0, "R": 1.0})
    opt = ctrl.optimizer
    assert opt.optim_steps == 10 and opt._uses_semi_fused() and ode.can_use_grad(opt)
    for s in (np.array([0.0, 0.0, 0.1, 0.0], np.float32),
              np.array([0.05, 0.1, 0.05, -0.2], np.float32)):
        u = ctrl.step(s)
        assert u.shape == (1,) and np.all(np.isfinite(u)) and abs(float(u[0])) <= 1.0


def test_fully_fused_takes_the_semi_fused_path_and_refines():
    """JAX mppi.py:350-359: fully_fused with optim_steps (or the optimal
    trajectory) fails K3's gate, so the step is the semi-fused one and the
    refinement runs."""
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                         config={"device": "cpu", "optimizer": "mppi",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name="mppi", optimizer_config=refine_config(
        num_rollouts=2048, fully_fused=True))
    opt = ctrl.optimizer
    assert not opt._can_fully_fuse() and opt._uses_semi_fused() and opt._noise_shape is not None
    opt.optim_steps = 0
    assert opt._can_fully_fuse()  # the refinement alone closed K3's gate
    opt.calculate_optimal_trajectory = True
    assert not opt._can_fully_fuse()
    opt.optim_steps, opt.calculate_optimal_trajectory = STEPS, False
    refine = opt._make_refine()
    s = torch.tensor([[0.1, -0.05, 0.3, 0.2]])
    params = ctrl._assemble_params()
    eps = opt.sample_noise(opt.opt_state)
    _, _, diag = opt.update(opt.opt_state, s, params, eps)
    plain = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                          config={"device": "cpu", "optimizer": "mppi",
                                  "controller_logging": False})
    plain.configure(optimizer_name="mppi", optimizer_config=refine_config(
        num_rollouts=2048, optim_steps=0))
    _, _, mppi_diag = plain.optimizer.update(opt.opt_state, s, params, eps)
    torch.testing.assert_close(
        diag["u_nom"], refine(mppi_diag["u_nom"], s, opt.opt_state.u_prev, params),
        rtol=0, atol=0)


def test_fleet_raises_the_vmapped_step_refusal():
    """An mppi-optimize fleet takes the JAX package's vmapped per-slot step
    (batched_mpc.py:478): no batched kernel step carries the refinement.
    The port's per-slot step serves it, each active slot equal to its
    single-session controller bit for bit."""
    from test_torch_fleet_per_slot import assert_slots_equal_single

    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"device": "cpu", "optimizer": "mppi",
                                        "controller_logging": False})
    ctrl.configure(optimizer_name="mppi", num_slots=2,
                   optimizer_config=refine_config(num_rollouts=64))
    assert ctrl._per_slot and not ctrl._plain_mppi()
    assert_slots_equal_single(ctrl)


def test_mppi_var_ignores_optim_steps(caplog):
    """mppi-var drops optim_steps with a warning (JAX mppi_var.py:90-94):
    its step has no refinement."""
    from test_torch_mppi_var import port_ctrl, var_config

    ctrl = port_ctrl("mppi-var-tf", var_config(optim_steps=5))
    assert "'optim_steps'" in caplog.text
    assert ctrl.optimizer.optim_steps == 0 and ctrl.optimizer._make_refine() is None


def test_risk_weight_is_left_out_and_the_lone_rollout_takes_the_mean(monkeypatch):
    """Over the committed ensemble (E=4, which has single_step), with
    risk_weight 0.5: the refinement's objective is JAX's nom_cost, the
    fused cost of the lone rollout under the members' mean step
    (ensemble_predictor.py single_step at K=1), with no risk term.  Held
    to jax.grad of the JAX optimizer's _fused_cost (GRAD_TOL) and the
    JAX refinement loop (the MPPI tolerance); the same gradient with
    risk_weight 0."""
    jctrl, pctrl = controllers(spec=ENSEMBLE_SPEC, risk_weight=0.5)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt.risk_weight == jopt.risk_weight == 0.5
    s = STARTS["cartpole"]
    u0 = np.random.default_rng(4).uniform(-0.6, 0.6, (1, H, 1)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    jparams, pparams = both_params(jctrl)
    want, g_jax = jax_refine(jopt, u0, s, u_prev, jparams)
    s_t, up = torch.as_tensor(s)[None], torch.as_tensor(u_prev)
    g = popt._make_nominal_grad()(torch.tensor(u0), s_t, up, pparams)
    np.testing.assert_allclose(g.numpy(), g_jax, **GRAD_TOL)
    got = popt._make_refine()(torch.tensor(u0), s_t, up, pparams)
    np.testing.assert_allclose(got.numpy(), want, **UNOM_TOL)
    # No risk term: the same gradient as without risk_weight.
    popt.risk_weight = 0.0
    torch.testing.assert_close(popt._make_nominal_grad()(torch.tensor(u0), s_t, up, pparams), g,
                               rtol=0, atol=0)
    # The lone rollout's step is the members' mean in both packages.
    x, u = torch.tensor(s)[None], torch.tensor(u0[:, 0])
    jstep = jopt.predictor.single_step(jnp.asarray(s)[None], jnp.asarray(u0[:, 0]),
                                       jparams["dyn"])
    np.testing.assert_allclose(popt.predictor.single_step(x, u, pparams["dyn"]).numpy(),
                               np.asarray(jstep), rtol=1e-5, atol=1e-6)
