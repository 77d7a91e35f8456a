"""The torch port's dynamics, predictor, costs, interpolation and fused
rollout loop against the JAX package (CPU) and the recorded TensorFlow
fixture.  Inputs are made with numpy from a seed and given to both."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.costs.cartpole import CartpoleQuadraticCost as JaxCost
from control_toolkit_tpu.models.predictors import ODEPredictor as JaxODE
from control_toolkit_tpu.ops.interpolation import Interpolator as JaxInterpolator
from control_toolkit_tpu.ops.interpolation import interpolation_matrix as jax_interp_matrix
from control_toolkit_tpu.ops.rollout import scan_cost_rollout as jax_scan_cost_rollout
from control_toolkit_tpu_torch.costs.cartpole import CartpoleQuadraticCost
from control_toolkit_tpu_torch.models.dynamics import state_indices
from control_toolkit_tpu_torch.models.predictors import ODEPredictor, PredictorWrapper
from control_toolkit_tpu_torch.ops.interpolation import Interpolator, interpolation_matrix
from control_toolkit_tpu_torch.ops.rollout import scan_cost_rollout
from control_toolkit_tpu_torch.utils.convert import params_from_numpy

GOLDEN = Path(__file__).parent / "golden" / "cartpole_golden.npz"
CPU = torch.device("cpu")
# float32 through 20-25 rk4 steps of the same expressions; the recorded TF
# fixture keeps the JAX package's own tolerance (test_tf_parity.py).
ROLLOUT_TOL = dict(rtol=1e-5, atol=1e-5)
GOLDEN_TOL = dict(rtol=2e-4, atol=2e-4)
COST_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def inputs(B=64, H=20, seed=0):
    rng = np.random.default_rng(seed)
    s0 = (0.1 * rng.standard_normal((B, 4))).astype(np.float32)
    Q = rng.uniform(-1.0, 1.0, (B, H, 1)).astype(np.float32)
    return s0, Q


def cost_params(target=0.3):
    """The cost's params tree for the JAX package and for the port."""
    jp = JaxCost().current_params({"target_position": jnp.float32(target)})
    return jp, params_from_numpy({"dyn": {}, "cost": jp["cost"], "attrs": jp["attrs"]}, CPU)


@pytest.mark.parametrize("spec", ["ODE", "ODE:euler", "ODE:rk4:2"])
def test_predictor_rollout_matches_jax(spec):
    s0, Q = inputs()
    pw = PredictorWrapper()
    pw.configure(device="cpu", dt=0.02, predictor_specification=spec, environment_name="cartpole")
    parts = spec.split(":")
    jpred = JaxODE("cartpole", dt=0.02, integrator=parts[1] if len(parts) > 1 else "rk4",
                   intermediate_steps=int(parts[2]) if len(parts) > 2 else 1)
    ref = np.asarray(jpred.rollout(jnp.asarray(s0), jnp.asarray(Q)))
    got = pw.rollout(torch.as_tensor(s0), torch.as_tensor(Q)).numpy()
    assert got.shape == (64, 21, 4)
    np.testing.assert_allclose(got, ref, **ROLLOUT_TOL)


def test_predictor_rollout_matches_tf_fixture():
    g = np.load(GOLDEN)
    pred = ODEPredictor("cartpole", dt=float(g["dt"]))
    got = pred.rollout(torch.as_tensor(g["s0"]), torch.as_tensor(g["Q"])).numpy()
    np.testing.assert_allclose(got, g["traj"], **GOLDEN_TOL)


def test_stage_terminal_and_trajectory_cost_match_jax():
    s0, Q = inputs(B=32, H=15, seed=1)
    traj = np.array(JaxODE("cartpole").rollout(jnp.asarray(s0), jnp.asarray(Q)))
    u_prev = np.array([0.4], np.float32)
    jcf, cf = JaxCost(), CartpoleQuadraticCost()
    jp, p = cost_params()
    t_traj, t_Q, t_up = map(torch.as_tensor, (traj, Q, u_prev))
    pairs = [
        (cf.get_stage_cost(t_traj[:, :-1], t_Q, t_up, p),
         jcf.get_stage_cost(jnp.asarray(traj[:, :-1]), jnp.asarray(Q), jnp.asarray(u_prev), jp)),
        (cf.get_terminal_cost(t_traj[:, -1], p),
         jcf.get_terminal_cost(jnp.asarray(traj[:, -1]), jp)),
        (cf.get_trajectory_cost(t_traj, t_Q, t_up, p),
         jcf.get_trajectory_cost(jnp.asarray(traj), jnp.asarray(Q), jnp.asarray(u_prev), jp)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **COST_TOL)


def test_trajectory_cost_matches_tf_fixture():
    g = np.load(GOLDEN)
    _, p = cost_params(float(g["target"]))
    traj = ODEPredictor("cartpole", dt=float(g["dt"])).rollout(
        torch.as_tensor(g["s0"]), torch.as_tensor(g["Q"]))
    got = CartpoleQuadraticCost().get_trajectory_cost(
        traj, torch.as_tensor(g["Q"]), torch.tensor([float(g["u_prev"])]), p)
    np.testing.assert_allclose(got.numpy(), g["costs"], rtol=5e-4, atol=5e-3)


@pytest.mark.parametrize("H,period", [(50, 10), (20, 5), (43, 10), (7, 1)])
def test_interpolation_matrix_bit_equal_and_apply(H, period):
    np.testing.assert_array_equal(interpolation_matrix(H, period), jax_interp_matrix(H, period))
    interp, jinterp = Interpolator.build(H, period, CPU), JaxInterpolator.build(H, period)
    P = interp.number_of_interpolation_inducing_points
    y = np.random.default_rng(H).standard_normal((16, P, 2)).astype(np.float32)
    np.testing.assert_allclose(interp.interpolate(torch.as_tensor(y)).numpy(),
                               np.asarray(jinterp.interpolate(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)


def loop_cost(scan, pred, cf, dyn, cp, s0, Q, u_prev):
    step = pred.single_step
    return scan(lambda x, u, _: step(x, u, dyn),
                lambda x, u, up, _: cf.stage_cost_step(x, u, up, cp),
                lambda x, _: cf.get_terminal_cost(x, cp),
                s0, Q, u_prev, None)[0]


def test_scan_cost_rollout_matches_jax_and_checks_u_prev():
    s0, Q = inputs(B=32, H=12, seed=2)
    jp, p = cost_params()
    jpred, pred = JaxODE("cartpole"), ODEPredictor("cartpole")
    ref = loop_cost(jax_scan_cost_rollout, jpred, JaxCost(),
                    {k: jnp.float32(v) for k, v in jpred.default_params().items()}, jp,
                    jnp.asarray(s0), jnp.asarray(Q), jnp.asarray([0.1], jnp.float32))
    got = loop_cost(scan_cost_rollout, pred, CartpoleQuadraticCost(),
                    {k: torch.tensor(float(v)) for k, v in pred.default_params().items()}, p,
                    torch.as_tensor(s0), torch.as_tensor(Q), torch.tensor([0.1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **COST_TOL)
    with pytest.raises(ValueError, match="exactly U=1"):
        loop_cost(scan_cost_rollout, pred, CartpoleQuadraticCost(), {}, p,
                  torch.as_tensor(s0), torch.as_tensor(Q), torch.zeros(32))


def test_custom_dynamics_and_unported_specs():
    def double_integrator(x, u, p):
        return torch.stack([x[..., 1], u[..., 0]], dim=-1)

    pred = ODEPredictor(dynamics=double_integrator, num_states=2, num_control_inputs=1,
                        dt=0.1, integrator="euler")
    assert pred.environment_name is None  # no device plant: never kernel-eligible
    traj = pred.rollout(torch.zeros(3, 2), torch.ones(3, 4, 1))
    np.testing.assert_allclose(traj[0, :, 1].numpy(), [0.0, 0.1, 0.2, 0.3, 0.4], atol=1e-6)
    pw = PredictorWrapper()
    # ported: the polynomial-trig plant (tests/test_torch_fastmath.py)
    pw.configure(device="cpu", predictor_specification="ODE:rk4:1:fast")
    assert pw.predictor.fast_math and pw.predictor.dynamics is not ODEPredictor().dynamics
    with pytest.raises(KeyError):
        pw.configure(device="cpu", predictor_specification="transformer:8")
    # ported: the PETS ensemble, five members by default (a random init)
    pw.configure(device="cpu", predictor_specification="ensemble:mlp-32-32")
    assert pw.predictor.n_members == 5 and tuple(pw.predictor.net_params["w0"].shape) == (5, 5, 32)
    with pytest.raises(ValueError, match="checkpoint"):
        pw.configure(device="cpu", predictor_specification="SGP_30")  # ported: needs a fitted GP
    # ported: the base ODE and a residual
    pw.configure(device="cpu", predictor_specification="ODE+res")
    assert set(pw.default_params()) == {"base", "res"}
    pw.configure(device="cpu", predictor_specification="neural:mlp-32-32")  # ported: a random init
    assert pw.predictor.arch == {"kind": "mlp", "hiddens": [32, 32]}
    copy = pw.copy()
    assert copy.predictor is not pw.predictor and copy.num_states == 4
    assert copy.predictor.net_params["w0"] is pw.predictor.net_params["w0"]  # shared, not copied
    assert not copy.is_stateful


def test_state_indices_and_unknown_environment():
    assert state_indices("cartpole") == {"position": 0, "positionD": 1, "angle": 2, "angleD": 3}
    with pytest.raises(KeyError):
        state_indices("nope")
