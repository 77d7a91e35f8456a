"""The torch port's online system identification
(``models/online_sysid.py``) against the JAX package's: the fit fed JAX's
minibatch draws gives JAX's weights and losses, the Adam moments persist
and drop by the same rules, an under-filled buffer is refused, the fit
reduces the one-step error of a mismatched plant, and an install reaches
the controller's next step with nothing rebuilt.

Both packages observe the same transitions of the "true" plant (cartpole
with a heavier, longer pole: tests/test_online_sysid.py's), made with
numpy from a seed, and start from the same residual weights (JAX's zero-
output-layer init).

    PYTHONPATH=. python tests/test_torch_sysid.py

from the repository's root times the two packages' fits (``fit_times``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.models.online_sysid import OnlineSysId as JaxSysId
from control_toolkit_tpu.models.predictors import ODEPredictor as JaxODE
from control_toolkit_tpu.models.residual_predictor import ResidualPredictor as JaxResidual
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.models.online_sysid import OnlineSysId
from control_toolkit_tpu_torch.models.residual_predictor import ResidualPredictor
from test_torch_mppi import LIMITS, optimizer_config

TRUE_PARAMS = {"m_pole": 0.4, "L": 0.6}
# Adam's float32 update computed in another operation order (torch.optim.Adam
# vs optax) over tens of steps: weights move by up to lr * steps = 0.15 and
# agree to ~1e-6 of that.
WEIGHT_TOL = dict(rtol=1e-4, atol=2e-6)
LOSS_TOL = dict(rtol=1e-4, atol=1e-9)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def true_transitions(n, seed=0):
    """Random-control transitions of the true plant around upright."""
    rng = np.random.default_rng(seed)
    plant = JaxODE("cartpole", dt=0.02, params=TRUE_PARAMS)
    xs = rng.uniform(-0.5, 0.5, size=(n, 4)).astype(np.float32)
    us = rng.uniform(-1.0, 1.0, size=(n, 1)).astype(np.float32)
    sn = np.asarray(plant.single_step(jnp.asarray(xs), jnp.asarray(us), plant.default_params()))
    return xs, us, sn


def sysid_pair(n, capacity=512, batch=64, lr=3e-3, seed=1, hiddens=(16, 16)):
    """A JAX and a port OnlineSysId over residual predictors with the same
    (JAX-initialised) weights, both fed the same ``n`` transitions."""
    jpred = JaxResidual("cartpole", dt=0.02, seed=0, hiddens=hiddens)
    pred = ResidualPredictor("cartpole", dt=0.02, device="cpu", hiddens=hiddens)
    pred.set_residual({k: np.asarray(v) for k, v in jpred._res.items()})
    jsys = JaxSysId(predictor=jpred, capacity=capacity, batch_size=batch, learning_rate=lr,
                    seed=seed)
    psys = OnlineSysId(predictor=pred, capacity=capacity, batch_size=batch, learning_rate=lr,
                       seed=seed)
    for row in zip(*true_transitions(n)):
        jsys.observe(*row)
        psys.observe(*row)
    return jsys, psys


def jax_draws(sysid, steps):
    """The [steps, batch] rows the JAX fit draws next (online_sysid.py:
    128-129), from a copy of its key."""
    key, rows = sysid._key, []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.randint(sub, (sysid.batch_size,), 0,
                                                  jnp.int32(len(sysid)))))
    return np.stack(rows)


def assert_weights_match(psys, jsys):
    for k, v in jsys.predictor._res.items():
        np.testing.assert_allclose(psys.predictor._res[k].numpy(), np.asarray(v), **WEIGHT_TOL)


def test_fit_with_jax_draws_gives_jax_weights_and_losses():
    """Two fit -> apply rounds (the second continuing Adam's moments) and
    a ring buffer that has wrapped."""
    jsys, psys = sysid_pair(700)
    assert len(psys) == len(jsys) == 512
    for steps in (40, 25):
        rows = jax_draws(jsys, steps)
        jdiag = jsys.fit_and_apply(steps=steps)
        pdiag = psys.fit_and_apply(steps=steps, indices=rows)
        assert pdiag["fitted"] == jdiag["fitted"] == 1.0 and pdiag["count"] == 512.0
        for key in ("loss_before", "loss_after"):
            np.testing.assert_allclose(pdiag[key], jdiag[key], **LOSS_TOL)
        assert pdiag["loss_after"] < pdiag["loss_before"]
        assert_weights_match(psys, jsys)
    np.testing.assert_allclose(psys.one_step_mse(True), jsys.one_step_mse(True), **LOSS_TOL)
    np.testing.assert_allclose(psys.one_step_mse(False), jsys.one_step_mse(False), rtol=1e-5)


def test_a_discarded_fit_drops_the_moments():
    """fit() without apply() abandons that weight trajectory: the next fit
    restarts Adam from the installed weights, while an applied fit's
    moments carry on (50 + 50 steps on the counter, the discarded fit's 50
    dropped), as the JAX package's do: the same weights at the end."""
    jsys, psys = sysid_pair(512)

    def fit_both(steps=50):
        rows = jax_draws(jsys, steps)
        jsys.fit(steps=steps)
        psys.fit(steps=steps, indices=rows)

    fit_both()
    assert psys._pending
    discarded = psys._adam
    fit_both()
    assert psys._adam is not discarded
    jsys.apply()
    psys.apply()
    assert not psys._pending
    applied = psys._adam
    fit_both()
    assert psys._adam is applied
    assert all(int(st["step"]) == 100 for st in psys._adam.state.values())
    jsys.apply()
    psys.apply()
    assert_weights_match(psys, jsys)
    installed = psys.predictor._res
    psys.apply()  # one-shot: nothing is installed twice
    assert psys.predictor._res is installed


def test_underfilled_buffer_is_refused_and_a_non_residual_predictor_too():
    pred = ResidualPredictor("cartpole", dt=0.02, device="cpu")
    sysid = OnlineSysId(predictor=pred, capacity=128, batch_size=64)
    sysid.observe(np.zeros(4), np.zeros(1), np.zeros(4))
    before = pred._res
    assert sysid.fit(steps=10) == {"fitted": 0.0, "count": 1.0}
    sysid.apply()
    assert pred._res is before and np.isnan(OnlineSysId(predictor=pred).one_step_mse())
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": "cpu", "optimizer": "mppi", "controller_logging": False})
    ctrl.configure(optimizer_name="mppi", optimizer_config=optimizer_config(32, 8))
    with pytest.raises(TypeError, match="ResidualPredictor"):
        OnlineSysId(ctrl)
    with pytest.raises(ValueError, match="indices"):
        psys = sysid_pair(128)[1]
        psys.fit(steps=3, indices=np.zeros((2, 64), np.int64))


def test_fit_reduces_the_one_step_error():
    _, psys = sysid_pair(2048, capacity=2048, batch=256, hiddens=(32, 32))
    base_mse = psys.one_step_mse(use_residual=False)
    diag = psys.fit_and_apply(steps=600)
    assert diag["fitted"] == 1.0 and diag["loss_after"] < diag["loss_before"]
    assert psys.one_step_mse(use_residual=True) < 0.25 * base_mse


def test_an_install_reaches_the_controllers_next_step_without_rebuild():
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": "cpu", "optimizer": "mppi", "controller_logging": False})
    ctrl.configure(optimizer_name="mppi", predictor_specification="ODE+res",
                   optimizer_config=optimizer_config(64, 10))
    sysid = OnlineSysId(ctrl, capacity=256, batch_size=32, learning_rate=3e-3, seed=2)
    plant = JaxODE("cartpole", dt=0.02, params=TRUE_PARAMS)
    epoch, s = ctrl.optimizer._build_epoch, np.array([0.0, 0.0, 0.2, 0.0], np.float32)
    for _ in range(40):
        u = ctrl.step(s)
        s_next = np.asarray(plant.single_step(jnp.asarray(s[None]), jnp.asarray(u[None]),
                                              plant.default_params()))[0]
        sysid.observe(s, u, s_next)
        s = s_next
    base = sysid.one_step_mse(False)
    assert sysid.fit_and_apply(steps=200)["fitted"] == 1.0
    assert sysid.one_step_mse(True) < 0.5 * base
    ctrl.step(s)
    res = ctrl._dyn_params["res"]
    for k, v in ctrl.predictor.predictor._res.items():
        assert res[k] is v
    assert ctrl.optimizer._build_epoch == epoch


def fit_times(steps: int = 300, rounds: int = 5, transitions: int = 200) -> dict:
    """Wall seconds of ``rounds`` successive ``fit_and_apply(steps)`` calls
    at ``chip_smoke.py``'s adaptive configuration (hiddens (32, 32),
    capacity 1024, batch 32, lr 3e-3) over ``transitions`` transitions of
    the mismatched plant: the JAX package's OnlineSysId (one jitted
    ``fori_loop``, which its first call compiles) on the CPU, and the
    port's (``steps`` Adam steps dispatched from Python) on the CPU and, on
    a machine with one, on the card."""
    import time

    def timed(sysid, sync=lambda: None):
        out = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            sysid.fit_and_apply(steps=steps)
            sync()
            out.append(time.perf_counter() - t0)
        return out

    jpred = JaxResidual("cartpole", dt=0.02, seed=0, hiddens=(32, 32))
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    runs = {"jax_cpu": JaxSysId(predictor=jpred, capacity=1024, batch_size=32,
                                learning_rate=3e-3, seed=1)}
    for dev in devices:
        pred = ResidualPredictor("cartpole", dt=0.02, hiddens=(32, 32), device=dev)
        pred.set_residual({k: np.asarray(v) for k, v in jpred._res.items()})
        runs[f"port_{dev}"] = OnlineSysId(predictor=pred, capacity=1024, batch_size=32,
                                          learning_rate=3e-3, seed=1)
    for row in zip(*true_transitions(transitions)):
        for sysid in runs.values():
            sysid.observe(*row)
    return {"steps": steps, "transitions": transitions, "seconds": {
        name: timed(sysid, torch.cuda.synchronize if name == "port_cuda" else lambda: None)
        for name, sysid in runs.items()}}


if __name__ == "__main__":
    import json

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(fit_times()))
