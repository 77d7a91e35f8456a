"""The port's MPPI-var (``optimizers/mppi_var.py``) and its fleet against
the JAX package.

* ``LR = 0`` is the port's MPPI step bit for bit, semi-fused (K2's plain
  version) and modular (K1's), on the same raw normals (MPPI's draw is
  the raw draw times ``SQRTRHOINV/sqrt(dt)``; JAX asserts the same of
  itself, tests/test_mppi_var.py:45).
* One adapting step (LR > 0, sigma away from its bounds) is fed the JAX
  step's draw (on the CPU the JAX step is its modular path; the
  semi-fused update equals it by linearity, as tests/test_torch_mppi.py
  holds MPPI): the plan to UNOM_TOL, sigma to SIGMA_TOL, over the ODE,
  the ``:fast`` plant and under a seeded value terminal.
* The batched step (``_make_batched_var_step``, K4's plain version) at
  B=3 with per-slot pole lengths, fed JAX's per-slot draws (each slot's
  key split as the JAX step splits it; rollout k = r*K/8 + c reads JAX's
  row p*8 + r, column c), against JAX's ``_make_batched_var_step`` (its
  kernel in interpret mode, tile 128), unvalued and under a seeded value
  terminal: costs to the fleet's COST_TOL, the plans to its UNOM_TOL,
  sigma to SIGMA_TOL.  The controller's slot semantics (a frozen slot
  bit for bit, independence from the other slots' masks) and the
  fleets the per-slot step serves.

    PYTHONPATH=. python tests/test_torch_mppi_var.py --fleet

from the repository's root runs both packages' mppi-var fleets on the CPU
at chip_smoke.py's phase-71 configuration and counts the slots that keep
the pole (``fleet_poles``).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.optimizers.mppi_var import MPPIVarState as JaxVarState
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout
from control_toolkit_tpu_torch.ops.mppi_cost import mppi_cost
from control_toolkit_tpu_torch.ops.mppi_cost_cols import mppi_cost_cols
from control_toolkit_tpu_torch.optimizers.mppi import MPPIState
from control_toolkit_tpu_torch.optimizers.mppi_var import MPPIVarOptimizer, MPPIVarState
from control_toolkit_tpu_torch.utils.convert import params_from_numpy
from control_toolkit_tpu_torch.utils.registry import (
    import_controller_by_name, import_optimizer_by_name,
)
from test_torch_fastmath import make_pair
from test_torch_fleet import COST_TOL as FLEET_COST_TOL
from test_torch_fleet import COST_WEIGHTS, ROWS
from test_torch_fleet import UNOM_TOL as FLEET_UNOM_TOL
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import CPU, LIMITS, UNOM_TOL, jax_params_numpy
from test_torch_value import attach_both, jax_value_net

K, H, P_PERIOD = 256, 20, 5
# sigma after one step: LR times a mean over K of products of costs (~1e2)
# and normals' squares, each side's float32 sums in their own order.
SIGMA_TOL = dict(rtol=1e-4, atol=1e-6)
FB, FK, FH, TILE = 3, 128, 10, 128


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def var_config(K_=K, H_=H, **extra):
    cfg = {"seed": 7, "mpc_timestep": 0.02, "mpc_horizon": H_, "num_rollouts": K_,
           "period_interpolation_inducing_points": P_PERIOD, "cc_weight": 1.0, "R": 1.0,
           "LBD_mc": 100.0, "SQRTRHOINV_mc": 0.05, "NU_mc": 1000.0, "LR": 2e-3,
           "STDEV_min": 0.01, "STDEV_max": 10.0, "max_grad_norm": 1000.0}
    cfg.update(extra)
    return cfg


def mppi_config_of(cfg: dict) -> dict:
    """The plain-MPPI config an mppi-var config forwards to MPPI."""
    out = {k: v for k, v in cfg.items()
           if k not in ("LBD_mc", "SQRTRHOINV_mc", "NU_mc", "LR", "STDEV_min", "STDEV_max",
                        "max_grad_norm")}
    out.update(LBD=cfg["LBD_mc"], SQRTRHOINV=cfg["SQRTRHOINV_mc"], NU=cfg["NU_mc"])
    return out


def port_ctrl(optimizer: str, cfg: dict) -> MPCController:
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                         config={"device": "cpu", "optimizer": optimizer,
                                 "controller_logging": False})
    ctrl.configure(optimizer_name=optimizer, optimizer_config=dict(cfg))
    return ctrl


def shared_plan(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (1, H, 1)).astype(np.float32), np.array([0.2], np.float32))


@pytest.mark.parametrize("semi_fused", [True, False])
def test_lr_zero_is_bitwise_the_port_mppi_step(semi_fused):
    cfg = var_config(LR=0.0, semi_fused=semi_fused)
    var, mppi = port_ctrl("mppi-var-tf", cfg), port_ctrl("mppi", mppi_config_of(cfg))
    vopt, mopt = var.optimizer, mppi.optimizer
    assert vopt._uses_semi_fused() == mopt._uses_semi_fused() == semi_fused
    assert vopt._noise_shape == mopt._noise_shape
    u_nom, u_prev = shared_plan()
    vs = MPPIVarState(None, torch.tensor(u_nom), torch.tensor(u_prev), vopt.opt_state.stdev)
    ms = MPPIState(None, torch.tensor(u_nom), torch.tensor(u_prev))
    assert float(vs.stdev[0]) == np.float32(mopt.SQRTRHODTINV)
    params = var._assemble_params()
    gen = torch.Generator().manual_seed(3)
    s = torch.tensor([[0.1, -0.2, 0.15, 0.3]])
    for _ in range(3):
        raw = torch.randn(vopt._noise_shape, generator=gen)
        u_v, vs, _ = vopt.update(vs, s, params, raw)
        u_m, ms, _ = mopt.update(ms, s, params, raw * mopt.SQRTRHODTINV)
        assert torch.equal(u_v, u_m) and torch.equal(vs.u_nom, ms.u_nom)
        assert float(vs.stdev[0]) == np.float32(mopt.SQRTRHODTINV)
        s = s + 0.01


def jax_var_draw(jopt) -> np.ndarray:
    """The raw normals ``[K, P, U]`` the JAX step (its modular path on the
    CPU) draws next (mppi_var.py:318-324)."""
    _, sample_key = jax.random.split(jopt.opt_state.key)
    P = jopt.interp.number_of_interpolation_inducing_points
    return np.asarray(jax.random.normal(sample_key, (jopt.num_rollouts, P, 1), jnp.float32))


@pytest.mark.parametrize("spec,semi_fused,valued", [
    ("ODE", True, False), ("ODE", False, False), ("ODE:rk4:1:fast", True, False),
    ("ODE", True, True), ("ODE", False, True)])
def test_one_adapting_step_matches_jax(spec, semi_fused, valued):
    jctrl, pctrl = make_pair("mppi-var-tf", var_config(semi_fused=semi_fused), spec=spec)
    if valued:
        attach_both(jctrl, pctrl, jax_value_net(9), scale=4.0)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt._uses_semi_fused() == semi_fused
    u_nom, u_prev = shared_plan()
    stdev = np.array([0.5], np.float32)
    jopt.opt_state = jopt.opt_state._replace(u_nom=jnp.asarray(u_nom), u_prev=jnp.asarray(u_prev),
                                             stdev=jnp.asarray(stdev))
    popt.opt_state = MPPIVarState(popt.opt_state.generator, torch.tensor(u_nom),
                                  torch.tensor(u_prev), torch.tensor(stdev))
    raw = jax_var_draw(jopt)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j = jctrl.step(s)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    eps = raw if not semi_fused else np.ascontiguousarray(np.transpose(raw, (1, 2, 0)))
    before = (mppi_cost.launches, cost_rollout.launches)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, torch.tensor(eps))
    assert (mppi_cost.launches, cost_rollout.launches) == before  # CPU: the plain versions
    js = jopt.opt_state
    np.testing.assert_allclose(st.u_nom.numpy(), np.asarray(js.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_j, **UNOM_TOL)
    np.testing.assert_allclose(st.stdev.numpy(), np.asarray(js.stdev), **SIGMA_TOL)
    np.testing.assert_array_equal(diag["stdev_logged"].numpy(), st.stdev.numpy())
    moved = abs(float(st.stdev[0]) - 0.5)
    assert 1e-4 < moved and 0.01 < float(st.stdev[0]) < 10.0  # adapted, within the bounds


def test_stdev_update_clips_the_norm_and_the_bounds():
    """``_apply_stdev_update`` against JAX's: one session and a fleet's
    rows, each clipped by its own gradient norm."""
    jctrl, pctrl = make_pair("mppi-var-tf", var_config(LR=0.5, max_grad_norm=2.0,
                                                        STDEV_max=1.0), spec="ODE")
    rng = np.random.default_rng(1)
    stdev = rng.uniform(0.1, 0.9, (4, 2)).astype(np.float32)
    grad = (rng.standard_normal((4, 2)) * np.array([[0.5], [3.0], [10.0], [0.01]])).astype(
        np.float32)
    got = pctrl.optimizer._apply_stdev_update(torch.tensor(stdev), torch.tensor(grad)).numpy()
    for b in range(4):
        ref = np.asarray(jctrl.optimizer._apply_stdev_update(jnp.asarray(stdev[b]),
                                                             jnp.asarray(grad[b])))
        np.testing.assert_allclose(got[b], ref, rtol=1e-6, atol=1e-7)
    assert got.min() >= 0.01 and got.max() <= 1.0


def test_names_resolve_keys_drop_and_options_are_taken(caplog):
    for name in ("mppi-var", "mppi-var-tf"):
        assert import_optimizer_by_name(name) is MPPIVarOptimizer
        assert import_controller_by_name(name) is MPCController
    with caplog.at_level(logging.WARNING):
        ctrl = port_ctrl("mppi-var-tf", var_config(LBD=5.0, fully_fused=True, optim_steps=3,
                                                   SQRTRHOINV_mc=1e-4, STDEV_min=0.02))
    opt = ctrl.optimizer
    assert "ignores config key 'LBD'" in caplog.text and "'optim_steps'" in caplog.text
    assert opt.LBD == 100.0 and not opt.fully_fused
    # The initial stdev 1e-4/sqrt(0.02) is clamped into [STDEV_min, STDEV_max].
    assert float(opt.opt_state.stdev[0]) == np.float32(0.02)
    before = mppi_cost.launches
    u = ctrl.step(np.array([0.0, 0.0, 0.1, 0.0], np.float32))
    assert np.all(np.isfinite(u)) and mppi_cost.launches == before  # CPU: K2's plain version
    # The policy warm start (MPPI's hook) and remat are taken, as in JAX.
    for extra in ({"initial_guess_policy": lambda x, p: x[2:3]}, {"remat": True}):
        opt = port_ctrl("mppi-var-tf", var_config(**extra)).optimizer
        assert opt._policy_seed_pending == ("initial_guess_policy" in extra)
        assert opt.remat == ("remat" in extra)
    # calculate_optimal_trajectory takes the modular path (JAX mppi_var.py:243).
    opt_traj = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                             config={"device": "cpu", "optimizer": "mppi-var-tf",
                                     "controller_logging": False,
                                     "calculate_optimal_trajectory": True})
    opt_traj.configure(optimizer_name="mppi-var-tf", optimizer_config=var_config())
    assert not opt_traj.optimizer._uses_semi_fused()
    assert opt_traj.step(np.array([0.0, 0.0, 0.1, 0.0], np.float32)).shape == (1,)
    assert opt_traj.optimizer.optimal_trajectory.shape == (1, H + 1, 4)


# ---- the fleet ------------------------------------------------------------------
def var_fleet(num_slots=FB, per_slot_dyn=("L",), device="cpu", **extra):
    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"optimizer": "mppi-var-tf", "device": device,
                                        "controller_logging": False})
    ctrl.configure(optimizer_name="mppi-var-tf",
                   optimizer_config=var_config(FK, FH, **extra), cost_function_config=COST_WEIGHTS,
                   num_slots=num_slots, per_slot_dyn=per_slot_dyn)
    return ctrl


def jax_var_pair(valued: bool):
    from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC

    cfg = var_config(FK, FH)
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.1},
                   config={"optimizer": "mppi-var-tf", "controller_logging": False})
    jctrl.configure(optimizer_name="mppi-var-tf", optimizer_config=dict(cfg))
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.1},
                          config={"device": "cpu", "optimizer": "mppi-var-tf",
                                  "controller_logging": False})
    pctrl.configure(optimizer_name="mppi-var-tf", optimizer_config=dict(cfg))
    if valued:
        attach_both(jctrl, pctrl, jax_value_net(41), scale=4.0)
    return jctrl, pctrl


def jax_slot_draws(keys, P: int) -> np.ndarray:
    """JAX's per-slot raw draws (mppi_var.py:185-190) in the port's layout
    ``[B, P, U, K]``: rollout k = r*K/8 + c is JAX's row p*8 + r, column c."""
    cps = FK // ROWS
    sample = jax.vmap(lambda k: jax.random.split(k))(keys)[:, 1]
    raw = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (1, P * ROWS, cps), jnp.float32))(
        sample))                                                   # [B, U, P*8, cps]
    return np.ascontiguousarray(raw.reshape(FB, 1, P, ROWS, cps).transpose(0, 2, 1, 3, 4)
                                .reshape(FB, P, 1, FK))


@pytest.mark.parametrize("valued", [False, True])
def test_batched_var_update_matches_jax(valued):
    """One batched mppi-var update at B=3 with per-slot pole lengths and
    targets, fed JAX's per-slot draws, against JAX's batched step; under a
    value terminal each session's V joins its costs before its softmax and
    its adaptation."""
    jctrl, pctrl = jax_var_pair(valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    P = popt.interp.number_of_interpolation_inducing_points
    rng = np.random.default_rng(17)
    x = {"s": rng.uniform(-0.3, 0.3, (FB, 1, 4)).astype(np.float32),
         "target": np.linspace(-0.5, 0.5, FB).astype(np.float32),
         "L": np.linspace(0.35, 0.65, FB).astype(np.float32),
         "u_prev": rng.uniform(-0.5, 0.5, (FB, 1)).astype(np.float32),
         "u_nom": rng.uniform(-0.4, 0.4, (FB, 1, FH, 1)).astype(np.float32),
         "stdev": np.array([[0.3], [0.5], [1.2]], np.float32)}
    keys = jax.random.split(jax.random.PRNGKey(5), FB)
    jstep = jopt._make_batched_var_step(FB, interpret=True, tile_k=TILE, per_slot_dyn=("L",))
    jtree = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), jctrl._assemble_params())
    jstates = JaxVarState(key=keys, u_nom=jnp.asarray(x["u_nom"]), u_prev=jnp.asarray(x["u_prev"]),
                          stdev=jnp.asarray(x["stdev"]))
    u_j, st_j, c_j = jstep(jstates, jnp.asarray(x["s"]), dict(jtree["dyn"], L=jnp.asarray(x["L"])),
                           jtree["cost"], {"target_position": jnp.asarray(x["target"])})
    _, update = popt._make_batched_var_step(FB, per_slot_dyn=("L",))
    pp = params_from_numpy(jax_params_numpy(jctrl), CPU)
    states = MPPIVarState((None,) * FB, torch.tensor(x["u_nom"]), torch.tensor(x["u_prev"]),
                          torch.tensor(x["stdev"]))
    before = mppi_cost_cols.launches
    u, st, costs = update(states, torch.tensor(x["s"]), dict(pp["dyn"], L=torch.tensor(x["L"])),
                          pp["cost"], {"target_position": torch.tensor(x["target"])},
                          torch.tensor(jax_slot_draws(keys, P)))
    assert mppi_cost_cols.launches == before  # CPU: K4's plain version
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_j), **FLEET_COST_TOL)
    np.testing.assert_allclose(st.u_nom.numpy(), np.asarray(st_j.u_nom), **FLEET_UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **FLEET_UNOM_TOL)
    np.testing.assert_allclose(st.stdev.numpy(), np.asarray(st_j.stdev), **SIGMA_TOL)
    assert not np.allclose(st.stdev.numpy(), x["stdev"])  # each session adapted


def test_var_fleet_takes_k4_and_freezes_idle_slots():
    """The fleet builds on K4; a masked-off slot keeps its plan, control,
    sigma and random stream bit for bit and commands 0; an active slot's
    controls do not depend on the other slots' masks or on B."""
    ctrl, ref, small = var_fleet(), var_fleet(), var_fleet(num_slots=2)
    assert ctrl._batched_var_eligible() and not ctrl._batched_kernel_eligible()
    s = np.random.default_rng(3).uniform(-0.2, 0.2, (FB, 4)).astype(np.float32)
    for c in (ctrl, ref):
        c.step_batch(s)
    small.step_batch(s[:2])
    before = ctrl.slot_states
    gen1 = ctrl.slot_states.generator[1].get_state()
    mask = np.array([True, False, True])
    u = ctrl.step_batch(s, mask)
    u_all = ref.step_batch(s)
    u_small = small.step_batch(s[:2])
    after = ctrl.slot_states
    assert u[1] == 0.0
    np.testing.assert_array_equal(u[mask], u_all[mask])
    np.testing.assert_allclose(u_small, u_all[:2], atol=1e-6)
    for name in ("u_nom", "u_prev", "stdev"):
        assert torch.equal(getattr(after, name)[1], getattr(before, name)[1])
    assert torch.equal(ctrl.slot_states.generator[1].get_state(), gen1)
    assert not torch.equal(after.stdev[0], before.stdev[0])


@pytest.mark.parametrize("optimizer,config", [
    ("mppi-var-tf", {"semi_fused": False}),
    ("cem-gmm-tf", {"cem_outer_it": 1, "cem_best_k": 8}),
    ("cma-es-tf", {"cma_outer_it": 1}),
    ("cem-naive-grad-tf", {"cem_best_k": 8}),
    ("cem-grad-bharadhwaj-tf", {"cem_best_k": 8}),
])
def test_unserved_fleets_raise_naming_the_vmapped_step(optimizer, config):
    """A modular mppi-var fleet, and every cem-gmm, cma-es, cem-naive-grad
    and cem-grad-bharadhwaj fleet, take the JAX package's vmapped per-slot
    step, the port's per-slot step: each active slot equals its
    single-session controller bit for bit."""
    from test_torch_fleet_per_slot import assert_slots_equal_single

    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"optimizer": optimizer, "device": "cpu",
                                        "controller_logging": False})
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": FH, "num_rollouts": FK, **config}
    ctrl.configure(optimizer_name=optimizer, optimizer_config=cfg,
                   cost_function_config=COST_WEIGHTS, num_slots=2)
    assert ctrl._per_slot
    assert_slots_equal_single(ctrl)


@pytest.mark.cuda
def test_cuda_var_updates_match_cpu(cuda_device):
    """One single-session and one batched update on the card against the
    CPU's on the same draws."""
    for semi_fused in (True, False):
        cfg = var_config(semi_fused=semi_fused)
        cpu = port_ctrl("mppi-var-tf", cfg)
        card = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                             config={"device": str(cuda_device), "optimizer": "mppi-var-tf",
                                     "controller_logging": False})
        card.configure(optimizer_name="mppi-var-tf", optimizer_config=cfg)
        opt = card.optimizer
        raw = opt.sample_noise(opt.opt_state)
        s = torch.tensor([[0.1, -0.05, 0.3, 0.2]])
        u, st, _ = opt.update(opt.opt_state, s.to(cuda_device), card._assemble_params(), raw)
        u_c, st_c, _ = cpu.optimizer.update(cpu.optimizer.opt_state, s, cpu._assemble_params(),
                                            raw.cpu())
        torch.testing.assert_close(st.u_nom.cpu(), st_c.u_nom, rtol=0, atol=1e-4)
        torch.testing.assert_close(st.stdev.cpu(), st_c.stdev, **SIGMA_TOL)
    fleet, fleet_c = var_fleet(device=str(cuda_device)), var_fleet()
    _, update = fleet.optimizer._make_batched_var_step(FB, per_slot_dyn=("L",))
    _, update_c = fleet_c.optimizer._make_batched_var_step(FB, per_slot_dyn=("L",))
    raw = fleet.optimizer._slot_normals(fleet.slot_states.generator, np.ones(FB, bool))
    s = torch.rand(FB, 1, 4, generator=torch.Generator().manual_seed(0)) * 0.2 - 0.1
    out = []
    for ctrl, upd, dev in ((fleet, update, cuda_device), (fleet_c, update_c, CPU)):
        p = ctrl._assemble_params()
        st = ctrl.slot_states
        out.append(upd(st, s.to(dev), ctrl._dyn_with_slots(p["dyn"]), p["cost"],
                       {k: torch.as_tensor(v, device=dev) for k, v in ctrl.slot_attrs.items()},
                       raw.to(dev)))
    (u, st, costs), (u_c, st_c, costs_c) = out
    torch.testing.assert_close(costs.cpu(), costs_c, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(st.u_nom.cpu(), st_c.u_nom, rtol=0, atol=1e-4)
    torch.testing.assert_close(st.stdev.cpu(), st_c.stdev, **SIGMA_TOL)


def fleet_poles(B: int = 128, ticks: int = 50) -> dict:
    """The JAX package's and the port's mppi-var fleets on the CPU at
    chip_smoke.py's phase-71 configuration (FLEET_VAR_CONFIG: K=512, H=35,
    LR 1000; per-slot pole lengths over FLEET_L, slot i against its own
    CartpoleEnv seed 10+i, every slot active): how many of the B slots keep
    the pole for ``ticks`` ticks.  Prints one line for each and returns
    the counts."""
    from chip_smoke import DT, FLEET_L, FLEET_VAR_CONFIG
    from control_toolkit_tpu.controllers.batched_mpc import BatchedMPCController as JaxBatched
    from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv

    counts = {}
    jctrl = JaxBatched("cartpole", LIMITS, {"target_position": 0.0},
                       config={"optimizer": "mppi-var-tf", "controller_logging": False})
    jctrl.configure(optimizer_name="mppi-var-tf", optimizer_config=dict(FLEET_VAR_CONFIG),
                    num_slots=B, per_slot_dyn=("L",))
    pctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                 config={"optimizer": "mppi-var-tf", "device": "cpu",
                                         "controller_logging": False})
    pctrl.configure(optimizer_name="mppi-var-tf", optimizer_config=dict(FLEET_VAR_CONFIG),
                    cost_function_config=COST_WEIGHTS, num_slots=B, per_slot_dyn=("L",))
    for label, ctrl in (("jax", jctrl), ("port", pctrl)):
        Ls = np.linspace(*FLEET_L, B)
        envs = [CartpoleEnv(batch_size=1, dt=DT, seed=10 + i, params={"L": float(L)})
                for i, L in enumerate(Ls)]
        s = np.stack([env.reset()[0][0] for env in envs])
        for i, L in enumerate(Ls):
            ctrl.update_slot_dyn(i, {"L": float(L)})
        max_angle = np.zeros(B)
        for _ in range(ticks):
            u = np.asarray(ctrl.step_batch(s))
            for i in range(B):
                s[i] = envs[i].step(u[i])[0][0]
            max_angle = np.maximum(max_angle, np.abs(s[:, 2]))
        counts[label] = int((max_angle < 0.5).sum())
        print(f"{label}: {counts[label]} of {B} slots kept the pole for {ticks} ticks",
              flush=True)
    return counts


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(8)
    if "--fleet" in sys.argv[1:]:
        fleet_poles()
