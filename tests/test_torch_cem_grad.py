"""The port's gradient CEMs (``optimizers/cem_naive_grad.py``,
``optimizers/cem_grad_bharadhwaj.py``) against the JAX package.

Both packages start from the same state, made with numpy from a seed, and
get the same normals, re-split from the JAX key as its step splits it
(cem_naive_grad.py:80-82; cem_grad_bharadhwaj.py:103-106, :133-136).  On
the CPU the JAX step differentiates its rollout with ``jax.grad``; the
port's takes the plain versions of K7 (over the ODE and the ``:fast``
plant) and K8 (over the committed mlp-64-64), and of K1 and K11 for the
costs.  Costs to COST_TOL; the refit mean and std, the Adam moments and
the control to UNOM_TOL (one or two gradient steps whose gradients agree
to the gradient kernels' bounds, tests/test_torch_grad.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.ops import common as jcommon
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops.common import AdamState
from control_toolkit_tpu_torch.ops.grad_cost_rollout import grad_cost_rollout
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import neural_grad_cost_rollout
from control_toolkit_tpu_torch.optimizers.cem import CEMState, cem_trip_count
from control_toolkit_tpu_torch.optimizers.cem_grad_bharadhwaj import (
    CEMGradBharadhwajOptimizer, CEMGradState,
)
from control_toolkit_tpu_torch.optimizers.cem_naive_grad import CEMNaiveGradOptimizer
from control_toolkit_tpu_torch.optimizers.kernel_families import neural, ode
from control_toolkit_tpu_torch.utils.registry import (
    import_controller_by_name, import_optimizer_by_name,
)
from test_torch_cem import both_params
from test_torch_fastmath import make_pair
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import COST_TOL, LIMITS, UNOM_TOL
from test_torch_neural import ASSETS, MLP_ASSET

K, H = 128, 16
MLP = f"neural:{MLP_ASSET}:{ASSETS}"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def naive_config(**extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K,
           "cem_outer_it": 1, "cem_initial_action_stdev": 0.5, "cem_stdev_min": 0.1,
           "cem_best_k": 16, "learning_rate": 0.1, "gradmax_clip": 10}
    cfg.update(extra)
    return cfg


def bharadhwaj_config(**extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K,
           "cem_outer_it": 2, "cem_initial_action_stdev": 2.0, "cem_stdev_min": 1e-6,
           "cem_best_k": 8, "learning_rate": 0.05, "adam_beta_1": 0.9, "adam_beta_2": 0.999,
           "adam_epsilon": 1e-8, "gradmax_clip": 5, "warmup": False, "warmup_iterations": 3}
    cfg.update(extra)
    return cfg


def shared_distribution(seed=1):
    rng = np.random.default_rng(seed)
    return {"mue": rng.uniform(-0.4, 0.4, (1, H, 1)).astype(np.float32),
            "std": rng.uniform(0.2, 0.6, (1, H, 1)).astype(np.float32),
            "u_prev": np.array([0.2], np.float32)}


def jax_normals(key, shapes) -> list:
    """One normal draw per shape, each from the next split of ``key``."""
    out = []
    for shape in shapes:
        key, sub = jax.random.split(key)
        out.append(torch.tensor(np.asarray(jax.random.normal(sub, shape, jnp.float32))))
    return out


def step_both(jctrl, popt, draws):
    jopt = jctrl.optimizer
    jparams, params = both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    launches = (grad_cost_rollout.launches, neural_grad_cost_rollout.launches)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    assert (grad_cost_rollout.launches, neural_grad_cost_rollout.launches) == launches
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]), **COST_TOL)
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(diag_j["u_nom"]), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    for name in ("dist_mue", "stdev"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   **UNOM_TOL, err_msg=name)
    np.testing.assert_array_equal(st.u_prev.numpy(), u.numpy())
    assert st.count == int(st_j.count)
    return st, st_j


def gate_of(popt, spec: str) -> bool:
    """The gradient path the spec's family takes: K7 over an ODE, K8 over
    the MLP."""
    return (neural.can_use_grad(popt) if spec == MLP else ode.can_use_grad(popt))


@pytest.mark.parametrize("spec,its", [("ODE", 1), ("ODE", 2), ("ODE:rk4:1:fast", 1), (MLP, 1)])
def test_naive_grad_step_matches_jax(spec, its):
    jctrl, pctrl = make_pair("cem-naive-grad-tf", naive_config(cem_outer_it=its), spec=spec)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert gate_of(popt, spec)
    d = shared_distribution()
    jopt.opt_state = jopt.opt_state._replace(dist_mue=jnp.asarray(d["mue"]),
                                             stdev=jnp.asarray(d["std"]),
                                             u_prev=jnp.asarray(d["u_prev"]))
    popt.opt_state = CEMState(popt.opt_state.generator, torch.tensor(d["mue"]),
                              torch.tensor(d["std"]), 0, torch.tensor(d["u_prev"]))
    draws = jax_normals(jopt.opt_state.key, [(K, H, 1)] * its)
    assert [t.shape for t in popt.sample_draws(popt.opt_state)] == [t.shape for t in draws]
    step_both(jctrl, popt, draws)


def shared_adam(seed=2):
    rng = np.random.default_rng(seed)
    return {"m": (0.05 * rng.standard_normal((K, H, 1))).astype(np.float32),
            "v": (0.01 * rng.uniform(0.1, 1.0, (K, H, 1))).astype(np.float32), "step": 4}


@pytest.mark.parametrize("spec,count,warm", [("ODE", 3, False), ("ODE", 0, True),
                                             ("ODE:rk4:1:fast", 3, False), (MLP, 3, False)])
def test_bharadhwaj_step_matches_jax(spec, count, warm):
    """From a nontrivial distribution and Adam state (count 0 with warmup on:
    warmup_iterations Adam steps), fed the elite seed's and each
    iteration's normals."""
    jctrl, pctrl = make_pair("cem-grad-bharadhwaj-tf", bharadhwaj_config(warmup=warm),
                             spec=spec)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert gate_of(popt, spec)
    d, a = shared_distribution(), shared_adam()
    jopt.opt_state = jopt.opt_state._replace(
        dist_mue=jnp.asarray(d["mue"]), stdev=jnp.asarray(d["std"]),
        adam=jcommon.AdamState(step=jnp.int32(a["step"]), m=jnp.asarray(a["m"]),
                               v=jnp.asarray(a["v"])),
        count=jnp.int32(count), u_prev=jnp.asarray(d["u_prev"]))
    popt.opt_state = CEMGradState(popt.opt_state.generator, torch.tensor(d["mue"]),
                                  torch.tensor(d["std"]),
                                  AdamState(a["step"], torch.tensor(a["m"]), torch.tensor(a["v"])),
                                  count, torch.tensor(d["u_prev"]))
    its = cem_trip_count(popt, count)
    assert its == (3 if warm else 2)
    # The elite seed's draw comes from the step's first split, the
    # iterations' from the splits of the key that split left.
    key, sub = jax.random.split(jopt.opt_state.key)
    seed = torch.tensor(np.asarray(jax.random.normal(sub, (8, H, 1), jnp.float32)))
    draws = [seed] + jax_normals(key, [(K - 8, H, 1)] * its)
    assert [t.shape for t in popt.sample_draws(popt.opt_state)] == [t.shape for t in draws]
    st, st_j = step_both(jctrl, popt, draws)
    assert st.adam.step == int(st_j.adam.step) == a["step"] + its
    np.testing.assert_allclose(st.adam.m.numpy(), np.asarray(st_j.adam.m), **UNOM_TOL)
    np.testing.assert_allclose(st.adam.v.numpy(), np.asarray(st_j.adam.v), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name,cls", [("cem-naive-grad", CEMNaiveGradOptimizer),
                                      ("cem-naive-grad-tf", CEMNaiveGradOptimizer),
                                      ("cem-grad-bharadhwaj", CEMGradBharadhwajOptimizer),
                                      ("cem-grad-bharadhwaj-tf", CEMGradBharadhwajOptimizer)])
def test_names_resolve_and_unported_options_raise(name, cls):
    assert import_optimizer_by_name(name) is cls
    assert import_controller_by_name(name) is MPCController
    config = (naive_config if "naive" in name else bharadhwaj_config)
    _, pctrl = make_pair(name, config(), spec="ODE")
    before = grad_cost_rollout.launches
    u = pctrl.step(np.array([0.0, 0.0, 0.1, 0.0], np.float32))
    assert np.all(np.isfinite(u)) and grad_cost_rollout.launches == before  # CPU: plain K7
    for bad in (config(cem_best_k=K + 1),):
        with pytest.raises(ValueError):
            make_pair(name, bad, spec="ODE")
    for bad in (config(initial_guess_policy="zero"), config(remat=True)):
        with pytest.raises(NotImplementedError):
            make_pair(name, bad, spec="ODE")


def test_stdev_cap_is_the_reference_10():
    """The gradient CEMs clip sigma to [cem_stdev_min, 10.0] at the shift
    (the reference's cap for these variants; plain CEM's is 1e8)."""
    _, pctrl = make_pair("cem-naive-grad-tf", naive_config(cem_initial_action_stdev=50.0),
                         spec="ODE")
    popt = pctrl.optimizer
    wide = torch.full((K, H, 1), 1e3)
    u, st, _ = popt.update(popt.opt_state, torch.tensor([[0.0, 0.0, 0.1, 0.0]]),
                           pctrl._assemble_params(), [wide])
    assert float(st.stdev[0, :-1].max()) <= 10.0 and float(st.stdev[0, -1, 0]) == 50.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cem-naive-grad-tf", "cem-grad-bharadhwaj-tf"])
def test_cuda_grad_cem_update_matches_cpu(name, cuda_device):
    """One update on the card (K7 and K1) against the CPU's on the same
    draws."""
    config = (naive_config if "naive" in name else bharadhwaj_config)()
    _, cpu = make_pair(name, config, spec="ODE")
    card = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                         config={"device": str(cuda_device), "optimizer": name,
                                 "controller_logging": False})
    card.configure(optimizer_name=name, optimizer_config=config)
    opt, copt = card.optimizer, cpu.optimizer
    draws = opt.sample_draws(opt.opt_state)
    s = torch.tensor([[0.1, -0.05, 0.3, 0.2]])
    u, st, diag = opt.update(opt.opt_state, s.to(cuda_device), card._assemble_params(), draws)
    u_c, st_c, diag_c = copt.update(copt.opt_state, s, cpu._assemble_params(),
                                    [d.cpu() for d in draws])
    torch.testing.assert_close(diag["J_logged"].cpu(), diag_c["J_logged"], rtol=1e-3, atol=1e-2)
    torch.testing.assert_close(st.dist_mue.cpu(), st_c.dist_mue, rtol=1e-3, atol=1e-3)
