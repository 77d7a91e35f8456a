"""The port's CEM-GMM (``optimizers/cem_gmm.py``) against the JAX package.

``gmm_cluster_refit`` is held to the JAX function (random elites, ties and
an empty cluster) and to the recorded TF fixture that
tests/test_tf_parity.py reads (its tolerances).  One CEM-GMM step of each
path is fed the JAX step's draws, re-split from its key as its step splits
it: the component draw's Gumbel noise (``jax.random.categorical`` is the
argmax of ``gumbel(k_comp, (K, 2)) + log(probs + 1e-9)``) and the normals.
The costs to COST_TOL, the components, the mixture weights and the control
to UNOM_TOL, over the ODE and the ``:fast`` plant.  On a machine with a
card, one update on the card is held to the CPU's on the same draws.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.optimizers.cem_gmm import gmm_cluster_refit as jax_refit
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout
from control_toolkit_tpu_torch.optimizers.cem_gmm import (
    CEMGMMOptimizer, CEMGMMState, gmm_cluster_refit,
)
from control_toolkit_tpu_torch.utils.registry import (
    import_controller_by_name, import_optimizer_by_name,
)
from test_torch_cem import both_params
from test_torch_fastmath import make_pair
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import COST_TOL, LIMITS, UNOM_TOL

K, H = 128, 16
GOLDEN = Path(__file__).parent / "golden" / "cartpole_golden.npz"
# The refit's means and stds: float32 einsums in another order.
REFIT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def gmm_config(**extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K,
           "cem_outer_it": 2, "cem_initial_action_stdev": 0.5, "cem_stdev_min": 0.01,
           "cem_best_k": 16}
    cfg.update(extra)
    return cfg


def refit_both(elites, std_min=0.02):
    ref = jax_refit(jnp.asarray(elites), std_min)
    got = gmm_cluster_refit(torch.tensor(elites), std_min)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("case", ["random", "two_modes", "tie", "empty_cluster_1"])
def test_gmm_cluster_refit_matches_jax(case):
    """Random elites; two well-separated modes; elite j at equal distance
    from elites 0 and 1 (a tie goes to cluster 0); every other elite equal
    to elite 0 (cluster 1 holds elite 1 alone: its std is std_min)."""
    rng = np.random.default_rng(5)
    e = rng.uniform(-1.0, 1.0, (12, 6, 2)).astype(np.float32)
    if case == "two_modes":
        e[1::2] += 3.0
    elif case == "tie":
        e[0], e[1] = 0.0, 1.0
        e[5] = np.full((6, 2), 0.5, np.float32)
    elif case == "empty_cluster_1":
        e[2:] = e[0]
    ref, got = refit_both(e)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, **REFIT_TOL)
    if case == "tie":
        _, _, probs = got
        assert probs[0] * 12 == 11  # the tied elite joined cluster 0
    if case == "empty_cluster_1":
        np.testing.assert_array_equal(got[1][1], np.full((6, 2), 0.02, np.float32))


def test_gmm_cluster_refit_matches_tf_fixture():
    """The recorded TF reference (tests/test_tf_parity.py::test_cem_gmm_clustering_parity,
    optimizer_cem_gmm_tf.py:73-90) at its tolerances."""
    g = np.load(GOLDEN)
    mue, std, probs = gmm_cluster_refit(torch.tensor(g["gmm_elites"]), float(g["gmm_std_min"]))
    np.testing.assert_allclose(mue.numpy(), g["gmm_mue"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std.numpy(), g["gmm_std"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(probs[0]), float(g["gmm_prob1"]), atol=1e-6)


def jax_draws(jopt, its: int) -> list:
    """The JAX step's draws (cem_gmm.py:135-141), one per outer iteration."""
    key, draws = jopt.opt_state.key, []
    for _ in range(its):
        key, k_comp, k_norm = jax.random.split(key, 3)
        draws.append((torch.tensor(np.asarray(jax.random.gumbel(k_comp, (K, 2), jnp.float32))),
                      torch.tensor(np.asarray(jax.random.normal(k_norm, (K, H, 1),
                                                                jnp.float32)))))
    return draws


def set_shared_state(jopt, popt, seed=2):
    rng = np.random.default_rng(seed)
    mue = rng.uniform(-0.4, 0.4, (2, H, 1)).astype(np.float32)
    std = rng.uniform(0.2, 0.6, (2, H, 1)).astype(np.float32)
    probs = np.array([0.3, 0.7], np.float32)
    u_prev = np.array([0.2], np.float32)
    jopt.opt_state = jopt.opt_state._replace(comp_mue=jnp.asarray(mue), comp_std=jnp.asarray(std),
                                             mix_probs=jnp.asarray(probs),
                                             u_prev=jnp.asarray(u_prev))
    popt.opt_state = CEMGMMState(popt.opt_state.generator, torch.tensor(mue), torch.tensor(std),
                                 torch.tensor(probs), torch.tensor(u_prev))


@pytest.mark.parametrize("spec,its", [("ODE", 1), ("ODE", 3), ("ODE:rk4:1:fast", 2)])
def test_cem_gmm_step_matches_jax(spec, its):
    jctrl, pctrl = make_pair("cem-gmm-tf", gmm_config(cem_outer_it=its), spec=spec)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    set_shared_state(jopt, popt)
    draws = jax_draws(jopt, its)
    assert [tuple(t.shape) for d in popt.sample_draws(popt.opt_state) for t in d] == \
        [tuple(t.shape) for d in draws for t in d]
    jparams, params = both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]), **COST_TOL)
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(diag_j["u_nom"]), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    for name in ("comp_mue", "comp_std", "mix_probs"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   **UNOM_TOL)
    np.testing.assert_array_equal(st.u_prev.numpy(), u.numpy())


def test_component_draw_is_gumbel_max_of_the_mixture():
    """The card's draw: Gumbel noise from exponentials, so that argmax(g +
    log(probs + 1e-9)) picks component 1 with probability probs[1]."""
    _, pctrl = make_pair("cem-gmm-tf", gmm_config(num_rollouts=4096, cem_outer_it=1), spec="ODE")
    popt = pctrl.optimizer
    ((g, z),) = popt.sample_draws(popt.opt_state)
    assert g.shape == (4096, 2) and z.shape == (4096, H, 1) and torch.isfinite(g).all()
    probs = torch.tensor([0.25, 0.75])
    share = float(torch.argmax(g + torch.log(probs + 1e-9), dim=1).float().mean())
    assert abs(share - 0.75) < 0.03
    # The Gumbel's mean is Euler's gamma; its std pi/sqrt(6) gives 5 sigma ~0.07.
    assert abs(float(g.mean()) - 0.5772) < 0.07


def test_names_resolve_the_step_rides_k1_and_bad_configs_raise():
    for name in ("cem-gmm", "cem-gmm-tf"):
        assert import_optimizer_by_name(name) is CEMGMMOptimizer
        assert import_controller_by_name(name) is MPCController
    _, pctrl = make_pair("cem-gmm-tf", gmm_config(), spec="ODE")
    before = cost_rollout.launches
    u = pctrl.step(np.array([0.0, 0.0, 0.1, 0.0], np.float32))
    assert np.all(np.isfinite(u)) and cost_rollout.launches == before  # CPU: K1's plain version
    for bad in (gmm_config(cem_best_k=1), gmm_config(cem_best_k=K + 1)):
        with pytest.raises(ValueError):
            make_pair("cem-gmm-tf", bad, spec="ODE")
    # A policy warm start and remat are taken, as the JAX package takes them.
    for extra in ({"initial_guess_policy": lambda x, p: x[2:3]}, {"remat": True}):
        jctrl, pctrl = make_pair("cem-gmm-tf", gmm_config(**extra), spec="ODE")
        for opt in (jctrl.optimizer, pctrl.optimizer):
            assert opt._policy_seed_pending == ("initial_guess_policy" in extra)
            assert opt.remat == ("remat" in extra)


@pytest.mark.cuda
def test_cuda_cem_gmm_update_matches_cpu(cuda_device):
    """One update on the card against the CPU's on the same draws: the
    costs to the kernel bound, the refit to UNOM_TOL where the elites
    agree."""
    from test_torch_cem import make_pair as cpu_pair

    jctrl, cpu = cpu_pair("cem-gmm-tf", **gmm_config())
    card = MPCController("cartpole", LIMITS, {"target_position": 0.1},
                         config={"device": str(cuda_device), "optimizer": "cem-gmm-tf",
                                 "controller_logging": False})
    card.configure(optimizer_name="cem-gmm-tf", optimizer_config=gmm_config())
    opt, copt = card.optimizer, cpu.optimizer
    draws = opt.sample_draws(opt.opt_state)
    s = torch.tensor([[0.1, -0.05, 0.3, 0.2]])
    u, st, diag = opt.update(opt.opt_state, s.to(cuda_device), card._assemble_params(), draws)
    u_c, st_c, diag_c = copt.update(copt.opt_state, s, cpu._assemble_params(),
                                    [tuple(t.cpu() for t in d) for d in draws])
    torch.testing.assert_close(diag["J_logged"].cpu(), diag_c["J_logged"], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(st.comp_mue.cpu(), st_c.comp_mue, **UNOM_TOL)
    torch.testing.assert_close(u.cpu(), u_c, **UNOM_TOL)
