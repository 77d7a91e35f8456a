"""The port's CMA-ES (``optimizers/cma_es.py``) against the JAX package.

The strategy constants are held to JAX's ``_constants`` (full and
diagonal mode, and at chip_smoke.py's K=16384, mu=8192, H=50): the
weights to 1e-6 (both normalize them in float32), every constant to rel
1e-6.  The generation's two halves are held apart, because an eigenvector
may come back from ``torch.linalg.eigh`` with the opposite sign from
``jnp.linalg.eigh`` (and from cuSOLVER's on the card), so the same normals
may give another sample:

* ``sample`` at a covariance with distinct eigenvalues, fed JAX's normals
  with each coordinate's sign flipped where the two libraries' eigenvector
  differs in sign: JAX's population to SAMPLE_TOL; the sign-free
  ``B diag(D) B^T`` (C's symmetric root) and ``C^{-1/2} y`` to the same;
* ``refit`` from JAX's own population (drawn on the CPU from the JAX
  step's key by its formula, cma_es.py:165-186) and JAX's elites against
  the JAX step: mean, sigma, C, both paths, the counters and the control
  to UNOM_TOL.  The port's costs of that population are held to COST_TOL
  and its own elites to a top-mu of JAX's costs within that bound: two
  costs may tie exactly in float32 (rows 93 and 103 over the ``:fast``
  plant here), and ``lax.top_k`` puts the lower index first where
  ``torch.topk`` need not.

At ``C = I`` (the first generation) both libraries return the eigenvalues
1 and ``B = I`` exactly (checked below), so a whole first-generation step
fed JAX's normals agrees with the JAX step; the diagonal mode takes no
eigendecomposition and its whole multi-generation step is held to JAX's.

    PYTHONPATH=. python tests/test_torch_cma_es.py --loops

from the repository's root runs the JAX package's cma-es at chip_smoke.py's
configurations on the CPU (``jax_loops``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.ops.common import elite_indices as jax_elite_indices
from control_toolkit_tpu.optimizers.cma_es import CMAESState as JaxCMAESState
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops.common import elite_indices
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout
from control_toolkit_tpu_torch.optimizers.cma_es import CMAESOptimizer, CMAESState
from control_toolkit_tpu_torch.utils.registry import (
    import_controller_by_name, import_optimizer_by_name,
)
from test_torch_cem import both_params
from test_torch_fastmath import make_pair
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import COST_TOL, LIMITS, UNOM_TOL

K, H = 128, 12
N = H
# A sample mean + sigma * (z*D) @ B^T: float32 eigenvectors are determined
# to ~eps * max eigenvalue / min gap (1.6e-6 at spd's gaps of 0.15), times
# |z| up to ~4 and sigma 0.4, summed over N=12 terms in each library's order.
SAMPLE_TOL = dict(rtol=1e-5, atol=1e-5)
CONST_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cma_config(**extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K,
           "cma_outer_it": 1, "cma_initial_step_size": 0.3, "cma_step_size_min": 0.01,
           "cma_step_size_max": 1.0e8, "cma_diagonal": False, "cma_add_mean_sample": True,
           "warmup": False, "warmup_iterations": 3}
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("extra", [{}, {"cma_diagonal": True}, {"cma_mu": 20},
                                   {"num_rollouts": 16384, "cma_mu": 8192, "mpc_horizon": 50},
                                   {"num_rollouts": 16384, "cma_mu": 8192, "mpc_horizon": 50,
                                    "cma_diagonal": True}])
def test_constants_match_jax(extra):
    jctrl, pctrl = make_pair("cma-es-tf", cma_config(**extra), spec="ODE")
    ref, got = jctrl.optimizer._constants(), pctrl.optimizer._constants()
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-9)
    assert got[1].dtype == torch.float32
    for name, g, r in zip(("mu_eff", "c_s", "d_s", "c_c", "c_1", "c_mu", "chiN"), got[2:], ref[2:]):
        assert math.isclose(g, r, rel_tol=CONST_RTOL), (name, g, r)


def spd(seed: int, n: int = N) -> np.ndarray:
    """A covariance with distinct eigenvalues, evenly spread over [0.3, 2]
    (gaps of 0.15), in a random orthonormal basis."""
    Qm, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    C = (Qm * np.linspace(0.3, 2.0, n)) @ Qm.T
    return (0.5 * (C + C.T)).astype(np.float32)


def shared_state(jopt, popt, diagonal: bool, seed: int = 4, gen: int = 5, count: int = 2):
    """Both optimizers at one nontrivial state."""
    rng = np.random.default_rng(seed)
    st = {"mean": rng.uniform(-0.5, 0.5, N).astype(np.float32),
          "sigma": np.float32(0.4),
          "C": (rng.uniform(0.3, 1.5, N).astype(np.float32) if diagonal else spd(seed)),
          "p_sigma": (0.3 * rng.standard_normal(N)).astype(np.float32),
          "p_c": (0.3 * rng.standard_normal(N)).astype(np.float32),
          "u_prev": np.array([0.2], np.float32)}
    jopt.opt_state = JaxCMAESState(key=jopt.opt_state.key, gen=jnp.int32(gen),
                                   count=jnp.int32(count),
                                   **{k: jnp.asarray(v) for k, v in st.items()})
    popt.opt_state = CMAESState(generator=popt.opt_state.generator, gen=gen, count=count,
                                **{k: torch.tensor(v) for k, v in st.items()})


def jax_normals(jopt, its: int) -> list:
    """The JAX step's normals, one ``[K - add_mean, N]`` per generation."""
    key, out = jopt.opt_state.key, []
    for _ in range(its):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k1, (jopt.num_rollouts - int(jopt.add_mean), N),
                                                jnp.float32)))
    return out


def jax_population(jopt, z: np.ndarray) -> tuple:
    """JAX's sample of one full-covariance generation (cma_es.py:171-182)
    from its state, with its eigendecomposition."""
    s = jopt.opt_state
    evals, B = jnp.linalg.eigh(0.5 * (s.C + s.C.T))
    D = jnp.sqrt(jnp.clip(evals, 1e-12, None))
    x = s.mean + s.sigma * ((jnp.asarray(z) * D) @ B.T)
    x = jnp.concatenate([x, s.mean[None]], axis=0)
    X = jnp.clip(x, jnp.tile(jopt.action_low, (H,)), jnp.tile(jopt.action_high, (H,)))
    return np.asarray(X), np.asarray(D), np.asarray(B)


def assert_states_match(st, st_j, u, u_j):
    for name in ("mean", "sigma", "C", "p_sigma", "p_c"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   **UNOM_TOL, err_msg=name)
    assert (st.gen, st.count) == (int(st_j.gen), int(st_j.count))
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    np.testing.assert_array_equal(st.u_prev.numpy(), u.numpy())


def test_first_generation_step_matches_jax():
    """From the initial state (C = I) the whole step, fed JAX's normals:
    at the identity both libraries return B = I exactly, so the samples
    agree with no sign to align."""
    jctrl, pctrl = make_pair("cma-es-tf", cma_config(), spec="ODE")
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    evals_j, B_j = jnp.linalg.eigh(jnp.eye(N, dtype=jnp.float32))
    evals_t, B_t = torch.linalg.eigh(torch.eye(N))
    for B in (np.asarray(B_j), B_t.numpy()):
        np.testing.assert_array_equal(B, np.eye(N, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(evals_j), evals_t.numpy())
    (z,) = jax_normals(jopt, 1)
    jparams, params = both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, [torch.tensor(z)])
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]), **COST_TOL)
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(diag_j["u_nom"]), **UNOM_TOL)
    assert_states_match(st, st_j, u, u_j)


@pytest.mark.parametrize("spec,its,count", [("ODE", 2, 2), ("ODE", 3, 0),
                                            ("ODE:rk4:1:fast", 2, 2)])
def test_diagonal_step_matches_jax(spec, its, count):
    """sep-CMA takes no eigendecomposition: its whole step over several
    generations (count 0 with warmup on: warmup_iterations of them), fed
    JAX's normals, from a nontrivial state."""
    warm = count == 0
    jctrl, pctrl = make_pair("cma-es-tf", cma_config(cma_diagonal=True, cma_outer_it=its,
                                                     warmup=warm, warmup_iterations=its),
                             spec=spec)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    shared_state(jopt, popt, diagonal=True, count=count)
    draws = [torch.tensor(z) for z in jax_normals(jopt, its)]
    assert [d.shape for d in popt.sample_draws(popt.opt_state)] == [d.shape for d in draws]
    jparams, params = both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]), **COST_TOL)
    assert_states_match(st, st_j, u, u_j)


def aligned(B_t: torch.Tensor, B_j: np.ndarray) -> torch.Tensor:
    """Each eigenvector's sign in the port's decomposition relative to
    JAX's (+1 or -1 a column)."""
    s = torch.sign(torch.sum(B_t * torch.tensor(B_j), dim=0))
    assert bool((s != 0).all())
    return s


def test_sample_matches_jax_with_aligned_signs():
    """At a C with distinct eigenvalues: the port's eigenvalues to JAX's,
    its sample fed JAX's normals with each coordinate flipped where its
    eigenvector's sign differs from JAX's, and the sign-free root
    ``B diag(D) B^T`` (whose square is C) and ``C^{-1/2} y``."""
    jctrl, pctrl = make_pair("cma-es-tf", cma_config(), spec="ODE")
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    shared_state(jopt, popt, diagonal=False)
    (z,) = jax_normals(jopt, 1)
    X_j, D_j, B_j = jax_population(jopt, z)
    eig = popt.decompose(popt.opt_state.C)
    D_t, B_t = eig
    assert float(torch.diff(D_t**2).min()) > 0.1  # distinct: each eigenvector is defined to a sign
    np.testing.assert_allclose(D_t.numpy(), D_j, **SAMPLE_TOL)
    signs = aligned(B_t, B_j)
    carry = {"mean": popt.opt_state.mean, "sigma": popt.opt_state.sigma}
    X = popt.sample(carry, torch.tensor(z) * signs, eig)
    np.testing.assert_allclose(X.numpy(), X_j, **SAMPLE_TOL)
    root, root_j = B_t @ torch.diag(D_t) @ B_t.T, B_j @ np.diag(D_j) @ B_j.T
    np.testing.assert_allclose(root.numpy(), root_j, **SAMPLE_TOL)
    np.testing.assert_allclose((root @ root).numpy(), np.asarray(jopt.opt_state.C), rtol=1e-4,
                               atol=1e-5)
    y = torch.tensor(np.random.default_rng(6).standard_normal(N).astype(np.float32))
    inv = B_t @ ((B_t.T @ y) / D_t)
    inv_j = B_j @ ((B_j.T @ y.numpy()) / D_j)
    np.testing.assert_allclose(inv.numpy(), inv_j, **SAMPLE_TOL)


@pytest.mark.parametrize("spec", ["ODE", "ODE:rk4:1:fast"])
def test_refit_from_jax_population_matches_jax_step(spec):
    """A full-covariance generation from a nontrivial state: JAX's own
    population (its key, its eigenvectors) scored by the port's K1 plain
    version, and refit by the port from JAX's elites (C^{-1/2} from the
    port's own decomposition, which no sign changes) against the JAX step."""
    jctrl, pctrl = make_pair("cma-es-tf", cma_config(), spec=spec)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    shared_state(jopt, popt, diagonal=False)
    (z,) = jax_normals(jopt, 1)
    X_j, _, _ = jax_population(jopt, z)
    jparams, params = both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    ps = popt.opt_state
    X = torch.tensor(X_j)
    cost = popt._make_cost_only()(torch.tensor(s)[None].expand(K, -1).contiguous(),
                                  X.reshape(K, H, 1), ps.u_prev, params)
    cost_j = np.asarray(diag_j["J_logged"])
    np.testing.assert_allclose(cost.numpy(), cost_j, **COST_TOL)
    mu = popt.mu
    kth = np.sort(cost_j)[mu - 1]
    own = elite_indices(cost, mu).numpy()
    assert cost_j[own].max() - kth <= COST_TOL["atol"] + COST_TOL["rtol"] * abs(kth)
    carry = {"mean": ps.mean, "sigma": ps.sigma, "C": ps.C, "p_sigma": ps.p_sigma, "p_c": ps.p_c,
             "gen": ps.gen}
    idx = torch.tensor(np.asarray(jax_elite_indices(jnp.asarray(cost_j), mu)))
    new = popt.refit(carry, X, idx, popt.decompose(ps.C))
    m2 = new["mean"].reshape(H, 1)
    u = new["best"][0]
    st = ps._replace(mean=torch.cat([m2[1:], m2[-1:]]).reshape(N), sigma=new["sigma"],
                     C=new["C"], p_sigma=new["p_sigma"], p_c=new["p_c"], gen=new["gen"],
                     count=ps.count + 1, u_prev=u)
    assert_states_match(st, st_j, u, u_j)


def test_names_resolve_the_step_rides_k1_and_bad_configs_raise():
    for name in ("cma-es", "cma-es-tf"):
        assert import_optimizer_by_name(name) is CMAESOptimizer
        assert import_controller_by_name(name) is MPCController
    _, pctrl = make_pair("cma-es-tf", cma_config(cma_outer_it=2), spec="ODE")
    popt = pctrl.optimizer
    before = cost_rollout.launches
    u = pctrl.step(np.array([0.0, 0.0, 0.1, 0.0], np.float32))
    assert np.all(np.isfinite(u)) and cost_rollout.launches == before  # CPU: K1's plain version
    assert (popt.opt_state.gen, popt.opt_state.count) == (2, 1)
    assert popt.trip_count(0) == 2 and len(popt.sample_draws(popt.opt_state)) == 2
    for bad in (cma_config(cma_mu=0), cma_config(cma_mu=K + 1),
                cma_config(num_rollouts=1, cma_mu=1)):
        with pytest.raises(ValueError):
            make_pair("cma-es-tf", bad, spec="ODE")
    # The policy warm start is taken, as the JAX package takes it.
    jctrl, pctrl = make_pair("cma-es-tf", cma_config(initial_guess_policy=lambda x, p: x[2:3]),
                             spec="ODE")
    assert jctrl.optimizer._policy_seed_pending and pctrl.optimizer._policy_seed_pending


@pytest.mark.cuda
def test_cuda_cma_refit_and_decomposition_match_cpu(cuda_device):
    """cuSOLVER's decomposition against LAPACK's on the sign-free
    quantities, and one refit on the card from the CPU's population
    against the CPU's."""
    _, cpu = make_pair("cma-es-tf", cma_config(), spec="ODE")
    card = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                         config={"device": str(cuda_device), "optimizer": "cma-es-tf",
                                 "controller_logging": False})
    card.configure(optimizer_name="cma-es-tf", optimizer_config=cma_config())
    opt, copt = card.optimizer, cpu.optimizer
    C = torch.tensor(spd(8))
    (D, B), (D_c, B_c) = opt.decompose(C.to(cuda_device)), copt.decompose(C)
    root, root_c = B @ torch.diag(D) @ B.T, B_c @ torch.diag(D_c) @ B_c.T
    torch.testing.assert_close(root.cpu(), root_c, **SAMPLE_TOL)
    ps = copt.opt_state._replace(C=C)
    z = torch.randn(K - 1, N, generator=torch.Generator().manual_seed(1))
    carry = {"mean": ps.mean, "sigma": ps.sigma, "C": C, "p_sigma": ps.p_sigma, "p_c": ps.p_c,
             "gen": 3}
    X = copt.sample(carry, z, (D_c, B_c))
    idx = torch.randperm(K, generator=torch.Generator().manual_seed(2))[:copt.mu]
    new_c = copt.refit(carry, X, idx, (D_c, B_c))
    to = {k: (v.to(cuda_device) if torch.is_tensor(v) else v) for k, v in carry.items()}
    new = opt.refit(to, X.to(cuda_device), idx.to(cuda_device), (D, B))
    for k in ("mean", "sigma", "C", "p_sigma", "p_c"):
        torch.testing.assert_close(new[k].cpu(), new_c[k], **UNOM_TOL)


def jax_loops() -> dict:
    """The JAX package's cma-es alone on the CPU at chip_smoke.py's
    configurations (K=16384, H=50, full and diagonal), ZOO_TICKS closed-loop
    ticks against its CartpoleEnv from the state the port's
    CartpoleEnv(seed=0) starts from: prints the max |angle| and the step
    size sigma every 10 ticks and at the end (full CMA-ES's sigma grows
    without bound on this task: the repaired samples keep the evolution
    path long), and returns the final sigmas."""
    from chip_smoke import CMA_CONFIG, CMA_DIAG_CONFIG, DT, ZOO_TICKS
    from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
    from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv

    start = CartpoleEnv(batch_size=1, dt=DT, seed=0).reset()[0][0]
    out = {}
    for label, cfg in (("full", CMA_CONFIG), ("diagonal", CMA_DIAG_CONFIG)):
        ctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.0},
                      config={"optimizer": "cma-es-tf", "controller_logging": False})
        ctrl.configure(optimizer_name="cma-es-tf", optimizer_config=dict(cfg))
        env = JaxCartpoleEnv(batch_size=1, dt=DT, seed=0)
        env.reset()
        env.state = jnp.asarray(np.asarray(start, np.float32)[None])
        s, max_angle, sigmas = np.asarray(env.state), 0.0, []
        for _ in range(ZOO_TICKS):
            s, *_ = env.step(ctrl.step(s[0]))
            max_angle = max(max_angle, abs(float(s[0, 2])))
            sigmas.append(float(ctrl.optimizer.opt_state.sigma))
        out[label] = sigmas[-1]
        print(f"{label}: max |angle| {max_angle}, sigma every 10 ticks {sigmas[::10]}, "
              f"final {sigmas[-1]}", flush=True)
    return out


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    if "--loops" in sys.argv[1:]:
        jax_loops()
