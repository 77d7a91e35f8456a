"""The port's random-action and iCEM optimizers and its colored noise
against the JAX package, each fed the JAX step's draws (re-split from its
key as its step splits it): the population, its costs, the refit and the
applied control to COST_TOL and UNOM_TOL; the noise shaping to 1e-5 (the
two inverse rFFTs' float32 rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.ops.colored_noise import powerlaw_psd_gaussian as jax_powerlaw
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops.colored_noise import (
    powerlaw_psd_gaussian, powerlaw_shape, powerlaw_white,
)
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout
from control_toolkit_tpu_torch.optimizers.icem import ICEMState
from control_toolkit_tpu_torch.optimizers.random_action import RandomActionState
from test_torch_cem import both_params, make_pair
from test_torch_mppi import COST_TOL, LIMITS, UNOM_TOL

K, H = 128, 16
SHAPE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_white(key, n, shape):
    """The white normals the JAX ``powerlaw_psd_gaussian(key, .., n, shape)``
    draws, in ``powerlaw_white``'s layout."""
    if n < 2:
        return np.asarray(jax.random.normal(key, (*shape, n), jnp.float32))
    kr, ki = jax.random.split(key)
    F = n // 2 + 1
    return np.stack([np.asarray(jax.random.normal(k, (*shape, F), jnp.float32)) for k in (kr, ki)])


@pytest.mark.parametrize("n", [1, 2, 7, 16, 50])
@pytest.mark.parametrize("beta", [0.0, 1.0, 2.0])
def test_powerlaw_shaping_matches_jax(n, beta):
    key = jax.random.PRNGKey(n)
    ref = np.asarray(jax_powerlaw(key, beta, n, (6, 2)))
    got = powerlaw_shape(torch.tensor(jax_white(key, n, (6, 2))), beta, n).numpy()
    assert got.shape == (6, 2, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **SHAPE_TOL)


def test_powerlaw_noise_has_unit_variance():
    gen = torch.Generator().manual_seed(0)
    assert powerlaw_white(gen, 20, (3,)).shape == (2, 3, 11)
    y = powerlaw_psd_gaussian(gen, 2.0, 20, (20000,)).double()
    assert abs(float(y.var()) - 1.0) < 0.03 and abs(float(y.mean())) < 0.05


def zoo_config(**extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K}
    cfg.update(extra)
    return cfg


def test_random_action_step_matches_jax():
    jctrl, pctrl = make_pair("random-action-tf", **zoo_config())
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    u_prev = np.array([0.3], np.float32)
    jopt.opt_state = jopt.opt_state._replace(u_prev=jnp.asarray(u_prev))
    popt.opt_state = RandomActionState(popt.opt_state.generator, torch.tensor(u_prev))
    _, sample_key = jax.random.split(jopt.opt_state.key)
    Q = np.asarray(jax.random.uniform(sample_key, (K, H, 1), minval=jopt.action_low,
                                      maxval=jopt.action_high, dtype=jnp.float32))
    drawn = popt.sample_actions(popt.opt_state)
    assert drawn.shape == (K, H, 1) and float(drawn.min()) >= -1.0 and float(drawn.max()) < 1.0
    jparams, params = both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, _ = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, torch.tensor(Q))
    assert diag == {}
    np.testing.assert_array_equal(u.numpy(), np.asarray(u_j))  # the same row of the same Q
    np.testing.assert_array_equal(st.u_prev.numpy(), np.asarray(st_j.u_prev))


def icem_config(**extra):
    return zoo_config(**{"cem_outer_it": 2, "cem_initial_action_stdev": 0.5,
                         "cem_stdev_min": 0.01, "cem_best_k": 20, "icem_colored_noise_beta": 2.0,
                         "icem_keep_elites_frac": 0.3, "icem_add_mean_sample": True,
                         "warmup": False, "warmup_iterations": 3, **extra})


@pytest.mark.parametrize("extra", [{}, {"icem_keep_elites_frac": 0.0, "icem_add_mean_sample": False},
                                   {"warmup": True}])
def test_icem_step_matches_jax(extra):
    jctrl, pctrl = make_pair("icem-tf", **icem_config(**extra))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    n_keep, n_fresh = popt.n_keep, popt._n_fresh
    assert (n_keep, n_fresh) == (jopt.n_keep, jopt._n_fresh)
    count = 0 if extra.get("warmup") else 1
    rng = np.random.default_rng(4)
    mue = rng.uniform(-0.4, 0.4, (1, H, 1)).astype(np.float32)
    std = rng.uniform(0.2, 0.6, (1, H, 1)).astype(np.float32)
    elites = rng.uniform(-0.8, 0.8, (n_keep, H, 1)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    jopt.opt_state = jopt.opt_state._replace(
        dist_mue=jnp.asarray(mue), stdev=jnp.asarray(std), elites=jnp.asarray(elites),
        count=jnp.asarray(count, jnp.int32), u_prev=jnp.asarray(u_prev))
    popt.opt_state = ICEMState(popt.opt_state.generator, torch.tensor(mue), torch.tensor(std),
                               torch.tensor(elites), count, torch.tensor(u_prev))
    key, draws = jopt.opt_state.key, []
    for _ in range(3 if count == 0 else 2):
        key, sub = jax.random.split(key)
        draws.append(torch.tensor(jax_white(sub, H, (n_fresh, 1))))
    assert [d.shape for d in popt.sample_draws(popt.opt_state)] == [d.shape for d in draws]
    jparams, params = both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]), **COST_TOL)
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(diag_j["u_nom"]), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    for name in ("dist_mue", "stdev", "elites"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   **UNOM_TOL)
    assert st.count == count + 1


def test_icem_population_rides_k1_and_rejects_bad_configs():
    _, pctrl = make_pair("icem-tf", **icem_config())
    popt = pctrl.optimizer
    before = cost_rollout.launches
    s = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    u = pctrl.step(s)
    assert np.all(np.isfinite(u)) and cost_rollout.launches == before  # CPU: K1's plain version
    assert popt.opt_state.elites.shape == (popt.n_keep, H, 1)
    for bad, match in ((icem_config(icem_keep_elites_frac=1.5), "frac"),
                       (icem_config(num_rollouts=6, cem_best_k=5, icem_keep_elites_frac=1.0),
                        "no room")):
        ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.1},
                             config={"device": "cpu",
                                     "optimizer": "icem-tf", "controller_logging": False})
        with pytest.raises(ValueError, match=match):
            ctrl.configure(optimizer_name="icem-tf", optimizer_config=bad)


def jax_loops() -> dict:
    """The JAX package alone on the CPU, at ``chip_smoke.py``'s sampling
    configurations (K=16384, H=50): modular CEM for 200 ticks with the
    target change at tick 100, iCEM and random-action for 50 ticks, each
    closed loop against its own CartpoleEnv from the state the port's
    CartpoleEnv(seed=0) starts from (``chip_smoke.py closed_loop``'s
    start).  Prints one JSON line per loop and returns the max |angle| of
    each."""
    import json

    from chip_smoke import CEM_CONFIG, CEM_TICKS, ICEM_CONFIG, NEW_TARGET, RANDOM_CONFIG
    from chip_smoke import RETARGET_AT, ZOO_TICKS
    from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
    from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv

    start = CartpoleEnv(batch_size=1, dt=0.02, seed=0).reset()[0][0]
    angles = {}
    for name, opt, cfg, ticks, retarget in (
            ("cem", "cem-tf", CEM_CONFIG, CEM_TICKS, RETARGET_AT),
            ("icem", "icem-tf", ICEM_CONFIG, ZOO_TICKS, None),
            ("random_action", "random-action-tf", RANDOM_CONFIG, ZOO_TICKS, None)):
        ctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.0},
                      config={"optimizer": opt, "controller_logging": False})
        ctrl.configure(optimizer_name=opt, optimizer_config=cfg)
        env = JaxCartpoleEnv(batch_size=1, dt=0.02, seed=0)
        env.reset()
        env.state = jnp.asarray(np.asarray(start, np.float32)[None])
        s, max_angle, fell_at = np.asarray(env.state), 0.0, None
        for t in range(ticks):
            attrs = {"target_position": NEW_TARGET} if t == retarget else None
            s, *_ = env.step(ctrl.step(s[0], updated_attributes=attrs))
            max_angle = max(max_angle, abs(float(s[0, 2])))
            if fell_at is None and max_angle >= 0.5:
                fell_at = t
        angles[name] = max_angle
        print(json.dumps({"loop": name, "ticks": ticks, "max_abs_angle": max_angle,
                          "fell_at_tick": fell_at, "final_state": [float(v) for v in s[0]]}),
              flush=True)
    return angles


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    if "--loops" in sys.argv[1:]:
        print(jax_loops())
