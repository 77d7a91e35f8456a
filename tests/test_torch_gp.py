"""The torch port's sparse-GP path against the JAX package: the fit, the
GPPredictor and its spec, K14's and K10's plain versions
(``ops/gp_rollout.py``, ``ops/gp_grad_cost_rollout.py``) against the JAX
package's Pallas kernels in interpret mode, the GP step's hand-written
adjoint against ``torch.autograd``, a re-fit through the same built step,
one MPPI and one rpgd-tf controller tick, the committed GP, K10's
and K14's lane-split sum order emulated on the CPU against the bounds the
card's kernels are held to, and — on a machine with a card only — each
CUDA kernel against its plain version.

Both packages get the same GP (a JAX fit, written with the JAX
``GPPredictor.save``) and the same inputs and noise, made with numpy from
a seed or drawn from the JAX key.

    PYTHONPATH=. python tests/test_torch_gp.py

from the repository's root regenerates the committed GP (``make_assets``);

    PYTHONPATH=. python tests/test_torch_gp.py --starts

runs the JAX package's MPPI over the committed GP from the start states
of ``chip_smoke.py --starts`` (``jax_start_sweep``).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
from control_toolkit_tpu.models import gp_predictor as jgp
from control_toolkit_tpu.models.training import collect_transitions as jax_collect
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.models import gp_predictor as pgp
from control_toolkit_tpu_torch.models.predictors import PredictorWrapper
from control_toolkit_tpu_torch.models.training import collect_transitions
from control_toolkit_tpu_torch.ops.adjoints import gp_step_vjp
from control_toolkit_tpu_torch.ops.gp_grad_cost_rollout import (
    gp_grad_cost_rollout, gp_grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.grad_cost_rollout import plain_grad_loop
from control_toolkit_tpu_torch.ops.gp_rollout import (
    flatten_gp_weights, gp_cost_rollout, gp_cost_rollout_lanes, gp_cost_rollout_plain, gp_step,
)
from control_toolkit_tpu_torch.ops.neural_rollout import plain_cost_loop
from control_toolkit_tpu_torch.optimizers.kernel_families import gp, neural, ode, residual
from control_toolkit_tpu_torch.utils.convert import params_from_numpy
from test_torch_mppi import (
    CPU, LIMITS, UNOM_TOL, jax_next_draw, jax_params_numpy, optimizer_config, port_noise,
)
from test_torch_rpgd import jax_rpgd_draw, rpgd_config, set_rpgd_state

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "control_toolkit_tpu_torch" / "assets" / "cartpole"
GP_ASSET = "SGP_128.npz"
K, H, M = 256, 10, 16
F64_TOL = dict(rtol=1e-9, atol=1e-9)
# The JAX GP kernel tests' own bounds (test_pallas_gp.py:66-67, 176-177):
# the affine input transform and the matmul orders differ between the
# plain version and the Pallas kernel, and exp(-0.5 d2) amplifies the
# reassociation over the rollout (conditioning, not semantics).
COST_TOL = dict(rtol=1e-3, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=5e-4)
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_assets(out_dir: Path = ASSETS) -> dict:
    """Fit the committed GP with the JAX package as ``bench_scale.py:
    _gp_checkpoint`` fits it: ``collect_transitions(CartpoleEnv(16,
    seed=0), 200, seed=0)`` (3200 random-policy transitions),
    ``fit_gp_dynamics(num_inducing=128, seed=0)``, written with the JAX
    ``GPPredictor.save``.  Returns the fit's normalized MSE."""
    out_dir.mkdir(parents=True, exist_ok=True)
    x, u, xn = jax_collect(JaxCartpoleEnv(batch_size=16, dt=0.02, seed=0), 200, seed=0)
    params, mse = jgp.fit_gp_dynamics(x, u, xn, num_inducing=128, seed=0)
    jgp.GPPredictor("cartpole", dt=0.02, params=params).save(out_dir / GP_ASSET)
    return {"gp_normalized_mse": mse}


@pytest.fixture(scope="module")
def gp_ckpt(tmp_path_factory):
    """A small GP (M=16) fitted by the JAX package, saved with its ``save``."""
    x, u, xn = jax_collect(JaxCartpoleEnv(batch_size=8, dt=0.02, seed=0), 40, seed=0)
    params, _ = jgp.fit_gp_dynamics(x, u, xn, num_inducing=M, seed=0)
    path = tmp_path_factory.mktemp("gp") / "sgp.npz"
    jgp.GPPredictor("cartpole", dt=0.02, params=params).save(path)
    return str(path)


def make_pair(ckpt, optimizer="mppi", config=None, jax_logging=False):
    """The JAX and the port controller over one GP checkpoint."""
    spec = f"SGP_{M}:{ckpt}"
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
    return jctrl, pctrl


def inputs(seed, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    s_tiled = np.tile(np.array([[0.1, -0.2, 0.3, 0.05]], np.float32), (K, 1))
    Q = rng.uniform(lo, hi, (K, H, 1)).astype(np.float32)
    return s_tiled, Q, np.array([0.25], np.float32)


# ---- the fit and the predictor --------------------------------------------------
def test_fit_gp_dynamics_equals_jax_exactly():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0.5, (300, 4)).astype(np.float32)
    u = rng.uniform(-1.0, 1.0, (300, 1)).astype(np.float32)
    xn = (x + 0.02 * rng.standard_normal((300, 4))).astype(np.float32)
    for m, seed in ((32, 0), (64, 3)):
        port, pmse = pgp.fit_gp_dynamics(x, u, xn, num_inducing=m, seed=seed)
        ref, jmse = jgp.fit_gp_dynamics(x, u, xn, num_inducing=m, seed=seed)
        assert pmse == jmse and set(port) == set(ref) == set(pgp.GP_KEYS)
        for k in pgp.GP_KEYS:
            assert port[k].dtype == np.asarray(ref[k]).dtype == np.float32
            np.testing.assert_array_equal(port[k], np.asarray(ref[k]))


def test_collect_transitions_shapes_and_restarts():
    x, u, xn = collect_transitions(CartpoleEnv(batch_size=4, dt=0.02, seed=0), 30, seed=0,
                                   episode_length=10)
    assert x.shape == xn.shape == (120, 4) and u.shape == (120, 1)
    assert np.all(np.abs(u) <= 1.0) and np.all(np.isfinite(xn))
    np.testing.assert_array_equal(x[4:8], xn[0:4])           # within an episode
    assert not np.array_equal(x[40:44], xn[36:40])           # a restart at step 10


def test_spec_loads_a_jax_checkpoint_and_steps_as_jax(gp_ckpt):
    w = PredictorWrapper()
    w.configure(device="cpu", dt=0.02, predictor_specification=f"SGP_{M}:{gp_ckpt}",
                checkpoint="/nonexistent.npz")  # the spec's path wins
    pred = w.predictor
    assert isinstance(pred, pgp.GPPredictor) and pred.environment_name == "cartpole"
    assert set(pred.gp_params) == set(pgp.GP_KEYS) and pred.gp_params["variance"].ndim == 0
    jpred = jgp.GPPredictor("cartpole", checkpoint=gp_ckpt)
    with np.load(gp_ckpt) as data:
        for k in data.files:
            np.testing.assert_array_equal(pred.gp_params[k].numpy(), data[k])
    w2 = PredictorWrapper()
    w2.configure(device="cpu", dt=0.02, predictor_specification="gp", checkpoint=gp_ckpt)
    assert isinstance(w2.predictor, pgp.GPPredictor)
    rng = np.random.default_rng(1)
    s0 = (0.1 * rng.standard_normal((6, 4))).astype(np.float32)
    Q = rng.uniform(-1.0, 1.0, (6, H, 1)).astype(np.float32)
    # Ten steps of float32 matmuls summed in other orders, through exp.
    np.testing.assert_allclose(pred.rollout(torch.tensor(s0), torch.tensor(Q)).numpy(),
                               np.asarray(jpred.rollout(jnp.asarray(s0), jnp.asarray(Q))),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="params or a checkpoint"):
        pgp.GPPredictor(device="cpu")


def test_save_round_trips_to_jax(gp_ckpt, tmp_path):
    pred = pgp.GPPredictor(device="cpu", checkpoint=gp_ckpt)
    pred.save(tmp_path / "port.npz")
    back = jgp.GPPredictor("cartpole", checkpoint=str(tmp_path / "port.npz"))
    for k, v in pred.gp_params.items():
        np.testing.assert_array_equal(np.asarray(back.gp_params[k]), v.numpy())


# ---- the adjoint ----------------------------------------------------------------
@pytest.mark.parametrize("tie", [False, True])
def test_gp_step_vjp_matches_autograd_float64(gp_ckpt, tie):
    """Against autograd through ``gp_step`` in float64.  ``tie`` puts one
    input exactly on an inducing point (with values that every summation
    order adds exactly), so d2 == 0 before the clip: the max's derivative
    splits the tie, as torch.maximum and jnp.maximum do."""
    ops = {k: v.double() for k, v in flatten_gp_weights(
        pgp.GPPredictor(device="cpu", checkpoint=gp_ckpt).gp_params).items()}
    rng = np.random.default_rng(2)
    x = torch.tensor(0.3 * rng.standard_normal((16, 4)), requires_grad=True)
    u = torch.tensor(rng.uniform(-1.0, 1.0, (16, 1)), requires_grad=True)
    if tie:
        row = torch.tensor([0.5, -0.25, 0.75, 1.0, -0.5], dtype=torch.float64)
        ops.update(in_mean=torch.zeros(5, dtype=torch.float64),
                   inv_in=torch.ones(5, dtype=torch.float64),
                   Zs=torch.cat([row[None], ops["Zs"][1:]]))
        ops["zn2"] = torch.sum(ops["Zs"] * ops["Zs"], dim=1)
        with torch.no_grad():
            x[0], u[0] = row[:4], row[4:]
    lam = torch.tensor(rng.standard_normal((16, 4)))
    if tie:
        an = torch.cat([x, u], 1).detach()
        raw = (an * an).sum(1, keepdim=True) - 2.0 * (an @ ops["Zs"].T) + ops["zn2"]
        assert raw[0, 0] == 0.0
    (gp_step(ops, x, u) * lam).sum().backward()
    dxs, dus = gp_step_vjp(tuple(x.detach().T), tuple(u.detach().T), ops, tuple(lam.T))
    torch.testing.assert_close(torch.stack(dxs, 1), x.grad, **F64_TOL)
    torch.testing.assert_close(torch.stack(dus, 1), u.grad, **F64_TOL)


# ---- K14 and K10 against the Pallas kernels ----------------------------------------
def test_k14_plain_matches_pallas_interpret(gp_ckpt):
    jctrl, pctrl = make_pair(gp_ckpt)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert gp.can_use_cost(popt) and not ode.can_use_cost(popt) and not neural.can_use_cost(popt)
    s_tiled, Q, u_prev = inputs(3)
    pallas = jopt._build_pallas_gp_cost(interpret=True, tile_k=128)
    ref = np.asarray(pallas(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev),
                            jctrl._assemble_params()))
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    before = gp_cost_rollout.launches
    got = popt._make_cost_only()(torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev),
                                 params)
    assert gp_cost_rollout.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), ref, **COST_TOL)


@pytest.mark.parametrize("ccrc", [None, 5.0])
def test_k10_plain_matches_pallas_interpret_and_autograd(gp_ckpt, ccrc):
    """Also turns the control-change term up so the gprev carry shows."""
    jctrl, pctrl = make_pair(gp_ckpt, "rpgd-tf", rpgd_config(num_rollouts=K, mpc_horizon=H))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert gp.can_use_grad(popt)
    s_tiled, Q, u_prev = inputs(4, -0.8, 0.8)
    jparams = jctrl._assemble_params()
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    if ccrc is not None:
        jparams = dict(jparams, cost=dict(jparams["cost"], ccrc_weight=jnp.float32(ccrc)))
        params["cost"]["ccrc_weight"] = torch.tensor(ccrc)
    pallas = jopt._build_pallas_gp_grad(interpret=True, tile_k=64)
    ref_cost, ref_dq = pallas(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev), jparams)
    model, pack = gp.gp_model(popt)
    ops = flatten_gp_weights(params["dyn"]["gp"])
    args = (model, torch.tensor(s_tiled), torch.tensor(Q), pack(params, torch.tensor(u_prev)), ops)
    before = gp_grad_cost_rollout.launches
    cost, dQ = gp_grad_cost_rollout(*args)
    assert gp_grad_cost_rollout.launches == before
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), np.asarray(ref_dq), **GRAD_TOL)
    Qv = args[2].clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(gp_cost_rollout_plain(args[0], args[1], Qv, *args[3:]).sum(), Qv)
    torch.testing.assert_close(dQ, auto, rtol=1e-4, atol=1e-5)


def test_a_refit_reaches_the_next_call_without_rebuild(gp_ckpt):
    _, pctrl = make_pair(gp_ckpt, "rpgd-tf", rpgd_config(num_rollouts=K, mpc_horizon=H))
    popt, pred = pctrl.optimizer, pctrl.optimizer.predictor.predictor
    cost_fn, epoch = popt._make_cost_only(), popt._build_epoch
    grad_fn, _ = popt._make_grad_and_cost_only()
    s = torch.tensor([[0.1, 0.0, 0.2, 0.0]]).expand(K, 4)
    Q = torch.full((K, H, 1), 0.3)
    u_prev = torch.tensor([0.0])
    first = cost_fn(s, Q, u_prev, pctrl._assemble_params())
    first_dq = grad_fn(Q, s, u_prev, pctrl._assemble_params())
    pred.gp_params = {**pred.gp_params, "alpha": 1.5 * pred.gp_params["alpha"]}
    params = pctrl._assemble_params()
    assert params["dyn"]["gp"]["alpha"] is pred.gp_params["alpha"]
    swapped = cost_fn(s, Q, u_prev, params)
    assert not torch.allclose(first, swapped)
    assert not torch.allclose(first_dq, grad_fn(Q, s, u_prev, params))
    model, pack = gp.gp_model(popt)
    torch.testing.assert_close(swapped, gp_cost_rollout_plain(
        model, s, Q, pack(params, u_prev), flatten_gp_weights(pred.gp_params)))
    assert popt._build_epoch == epoch


def test_gp_operands_are_precomputed_once_per_posterior(gp_ckpt, monkeypatch):
    """The cost and gradient calls precompute the GP's operands
    (``flatten_gp_weights``) for a posterior once, not at every tick, and
    again for a re-fit."""
    _, pctrl = make_pair(gp_ckpt, "rpgd-tf", rpgd_config(num_rollouts=K, mpc_horizon=H))
    calls = []
    monkeypatch.setattr(gp, "flatten_gp_weights",
                        lambda tree: calls.append(tree) or flatten_gp_weights(tree))
    s = np.array([0.1, 0.0, 0.2, 0.0], np.float32)
    for _ in range(3):
        pctrl.step(s)
    assert len(calls) == 2  # K14's cost and K10's gradient
    pred = pctrl.optimizer.predictor.predictor
    pred.gp_params = {**pred.gp_params, "alpha": 1.5 * pred.gp_params["alpha"]}
    pctrl.step(s)
    pctrl.step(s)
    assert len(calls) == 4 and all(t["alpha"] is pred.gp_params["alpha"] for t in calls[2:])


# ---- the controller ---------------------------------------------------------------
def test_mppi_controller_ticks_match_jax(gp_ckpt):
    """A few MPPI ticks through both controllers' step(), each fed the same
    state and the same noise; the plans carry over."""
    jctrl, pctrl = make_pair(gp_ckpt)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert not popt._uses_semi_fused()  # the semi-fused K2 takes an ODE only
    rng = np.random.default_rng(5)
    for _ in range(3):
        s = (0.05 * rng.standard_normal(4)).astype(np.float32)
        eps = port_noise(popt, jax_next_draw(jopt))
        popt.sample_noise = lambda state, eps=eps: eps
        np.testing.assert_allclose(pctrl.step(s), jctrl.step(s), **UNOM_TOL)
        np.testing.assert_allclose(popt.opt_state.u_nom.numpy(), np.asarray(jopt.opt_state.u_nom),
                                   **UNOM_TOL)


def test_rpgd_controller_ticks_match_jax(gp_ckpt):
    """rpgd-tf ticks (a resample tick, then keep ticks) through both
    controllers, each fed the same state and draw: the port's K10 and K14
    plain versions against the JAX package's autograd through its scan."""
    jctrl, pctrl = make_pair(gp_ckpt, "rpgd-tf", rpgd_config(num_rollouts=K, mpc_horizon=H),
                             jax_logging=True)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    set_rpgd_state(jopt, popt, count=0, seed=5)
    captured, step_fn = [], popt._step_fn
    popt._step_fn = lambda st, s, p: captured.append(step_fn(st, s, p)) or captured[-1]
    rng = np.random.default_rng(6)
    for _ in range(3):
        s = (0.05 * rng.standard_normal(4)).astype(np.float32)
        draw = jax_rpgd_draw(jopt) if int(jopt.opt_state.count) % 10 == 0 else None
        popt.sample_resample = lambda state, d=draw: None if d is None else torch.as_tensor(d)
        u_jax, u_port = jctrl.step(s), pctrl.step(s)
        jcost, pcost = jopt.logging_values["J_logged"], captured[-1][2]["J_logged"].numpy()
        np.testing.assert_allclose(pcost, jcost, **COST_TOL)
        if int(np.argmin(jcost)) == int(np.argmin(pcost)):
            np.testing.assert_allclose(u_port, u_jax, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(popt.opt_state.Q.numpy(), np.asarray(jopt.opt_state.Q),
                               rtol=1e-3, atol=1e-4)


def test_gates_and_wrappers(gp_ckpt):
    _, pctrl = make_pair(gp_ckpt, config=optimizer_config(K, H, force_scan=True))
    assert not gp.can_use_cost(pctrl.optimizer) and not residual.can_use_cost(pctrl.optimizer)
    assert pctrl.optimizer._make_cost_only() == pctrl.optimizer._fused_cost
    _, pctrl = make_pair(gp_ckpt)
    model, _ = gp.gp_model(pctrl.optimizer)
    ops = flatten_gp_weights(pctrl._assemble_params()["dyn"]["gp"])
    args, tensors = model.gp_args(ops)
    assert args.M == M and set(tensors) == set(ops)
    with pytest.raises(ValueError, match="zn2"):
        model.gp_args({**ops, "zn2": ops["zn2"][:-1]})
    meta = dict(device="meta")
    before = gp_cost_rollout.launches, gp_grad_cost_rollout.launches
    for fn in (gp_cost_rollout, gp_grad_cost_rollout):
        with pytest.raises(ValueError, match="several devices"):
            fn(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
               torch.empty(8, **meta), ops)
        with pytest.raises(ValueError, match="CUDA"):
            fn(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
               torch.empty(8, **meta), {k: torch.empty(v.shape, **meta) for k, v in ops.items()})
    assert (gp_cost_rollout.launches, gp_grad_cost_rollout.launches) == before


# ---- the committed GP ---------------------------------------------------------------
def test_committed_gp_is_what_the_generator_documents():
    path = ASSETS / GP_ASSET
    shapes = {"Z": (128, 5), "alpha": (128, 4), "lengthscales": (5,), "variance": (),
              "in_mean": (5,), "in_std": (5,), "out_mean": (4,), "out_std": (4,)}
    with np.load(path) as data:
        assert {k: data[k].shape for k in data.files} == shapes
        assert all(data[k].dtype == np.float32 for k in data.files)
    pred = pgp.GPPredictor(device="cpu", checkpoint=str(path))
    jpred = jgp.GPPredictor("cartpole", checkpoint=str(path))
    x, u, xn = jax_collect(JaxCartpoleEnv(batch_size=16, dt=0.02, seed=7), 50, seed=7)
    got = pred.single_step(torch.tensor(x), torch.tensor(u), pred.default_params()).numpy()
    ref = np.asarray(jpred.single_step(jnp.asarray(x), jnp.asarray(u), jpred.default_params()))
    # The fitted posterior's large weights cancel: either package's float32
    # step is 2-3e-4 from a float64 evaluation of the same step.
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    # The one-step error on fresh transitions, normalized by the deltas' spread.
    err = float(np.mean(((got - xn) / np.asarray(jpred.gp_params["out_std"])) ** 2))
    assert err < 0.1, err


# ---- K10's lane split, on the CPU ---------------------------------------------------
GP_CASES = ["committed", "well_conditioned", "well_conditioned_m100"]


def gp_grad_problem(case: str, K_: int = 64, H_: int = 50):
    """chip_smoke.py phase 21's operands at K_ rollouts on the CPU: the
    rpgd-tf controller over the committed SGP_128 (its cost, pvec and GP),
    s0 0.05 N(0, 1) and Q uniform on [-1, 1] (numpy, seed 21), and the GP's
    operands: the committed GP, the well-conditioned one of its widths
    (``well_conditioned_gp``), or that of its first GP_FEW_POINTS (100)
    inducing points."""
    from chip_smoke import GP_FEW_POINTS, RES_RPGD_CONFIG, make_controller, well_conditioned_gp

    ctrl = make_controller("cpu", "rpgd-tf", {**RES_RPGD_CONFIG, "num_rollouts": K_,
                                              "mpc_horizon": H_},
                           spec=f"SGP_128:{ASSETS / GP_ASSET}")
    model, pack = gp.gp_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    fitted = params["dyn"]["gp"]
    if case == "well_conditioned_m100":
        fitted = {**fitted, "Z": fitted["Z"][:GP_FEW_POINTS],
                  "alpha": fitted["alpha"][:GP_FEW_POINTS]}
    ops = flatten_gp_weights(fitted if case == "committed" else well_conditioned_gp(fitted))
    rng = np.random.default_rng(21)
    s0 = torch.tensor(0.05 * rng.standard_normal((K_, 4)), dtype=torch.float32)
    Q = torch.tensor(rng.uniform(-1.0, 1.0, (K_, H_, 1)), dtype=torch.float32)
    return model, s0, Q, pack(params, torch.tensor([0.1])), ops


def fma(a, b, c):
    """fmaf(a, b, c) on float32 tensors: the product is exact in float64,
    so a * b + c there, rounded to float32, rounds once."""
    return (a.double() * b.double() + c.double()).float()


def butterfly(parts: torch.Tensor) -> torch.Tensor:
    """csrc/gp_core.cuh lane_sum over the last axis, the L lanes of one
    rollout: log2 L rounds, each lane adding the value of the lane that
    differs in one bit.  Returns every lane's result."""
    L, mask = parts.shape[-1], 1
    while mask < L:
        parts = parts + parts[..., torch.arange(L) ^ mask]
        mask <<= 1
    return parts


def lane_split_sum(coef: torch.Tensor, term: torch.Tensor, L: int) -> torch.Tensor:
    """sum_m coef[..., m] * term[..., m] over the M inducing points (last
    axis) as K10 takes it: lane r of L from 0, fmaf over m = r, r + L, ..
    in order, then the butterfly; all L lanes must end with the same bits."""
    M = coef.shape[-1]
    acc = torch.zeros(*coef.shape[:-1], L)
    for m0 in range(0, M, L):
        n = min(L, M - m0)
        acc[..., :n] = fma(coef[..., m0:m0 + n], term[..., m0:m0 + n], acc[..., :n])
    acc = butterfly(acc)
    assert torch.equal(acc, acc[..., :1].expand_as(acc))
    return acc[..., 0]


def gp_point_terms(ops, xs, us):
    """Per rollout and inducing point, as the kernel's loop computes them:
    an (the affine input), raw d2 = (|an|^2 - 2 Zs_m . an) + zn2_m with
    the sums as fmaf chains in input order, and k_m = var exp(-0.5 max(raw,
    0))."""
    a = torch.stack([*xs, *us], dim=1)
    an = (a - ops["in_mean"]) * ops["inv_in"]
    an2, gdot = torch.zeros(a.shape[0]), torch.zeros(a.shape[0], ops["Zs"].shape[0])
    for d in range(a.shape[1]):
        an2 = fma(an[:, d], an[:, d], an2)
        gdot = fma(ops["Zs"][:, d], an[:, d:d + 1], gdot)
    raw = (an2[:, None] - 2.0 * gdot) + ops["zn2"]
    return an, raw, ops["var"] * torch.exp(-0.5 * torch.clamp_min(raw, 0.0))


def k10_lane_split(ops, L: int):
    """(step, step_vjp) of K10 with L lanes a rollout, for plain_grad_loop:
    the GP step and its VJP (csrc/gp_core.cuh gp_step, gp_step_vjp) with
    each sum over the inducing points in the lane split's order."""
    def step(x, u):
        _, _, k = gp_point_terms(ops, x.unbind(1), u.unbind(1))
        acc = torch.stack([lane_split_sum(ops["alphaT"][s].expand_as(k), k, L)
                           for s in range(x.shape[1])], dim=1)
        return x + fma(acc, ops["out_std"], ops["out_mean"])

    def step_vjp(xs, us, lam):
        S = len(xs)
        an, raw, k = gp_point_terms(ops, xs, us)
        kbar = torch.zeros_like(k)
        for s in range(S):
            kbar = fma((lam[s] * ops["out_std"][s])[:, None], ops["alphaT"][s], kbar)
        clip = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0))
        d2bar = -0.5 * kbar * k * clip
        anbar = [lane_split_sum(d2bar, 2.0 * an[:, d:d + 1] - 2.0 * ops["Zs"][:, d], L)
                 for d in range(an.shape[1])]
        abar = [fma(anbar[d], ops["inv_in"][d], torch.zeros(())) for d in range(an.shape[1])]
        return tuple(lam[i] + abar[i] for i in range(S)), tuple(abar[S:])

    return step, step_vjp


@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
@pytest.mark.parametrize("case", GP_CASES)
def test_k10_lane_split_sum_order_stays_within_the_kernel_bounds(case, lanes, record_property):
    """K10's sums over the inducing points taken in its lane split's order
    (per-lane fmaf partial sums over m = lane mod L, then the xor butterfly),
    emulated in float32 over chip_smoke.py phase 21's GPs at H=50, stay
    within the bounds phase 21 holds the card's K10 to: over a
    well-conditioned GP (M=128, and M=100, not a multiple of L) J to
    KERNEL_TOL and dQ to DQ_RTOL plus DQ_ATOL_FRAC of max|dQ|; over the
    committed GP, each no further from the float64 plain version than
    GP_F64_FACTOR times the float32 plain version's distance, plus 1e-6 of
    its largest entry."""
    from chip_smoke import DQ_ATOL_FRAC, DQ_RTOL, GP_F64_FACTOR, KERNEL_TOL, close

    model, s0, Q, pvec, ops = gp_grad_problem(case)
    got = plain_grad_loop(model, s0, Q, pvec, *k10_lane_split(ops, lanes))
    plain = gp_grad_cost_rollout_plain(model, s0, Q, pvec, ops)
    found = {name: float((g - p).abs().max()) for name, g, p in zip(("J", "dQ"), got, plain)}
    if case == "committed":
        ref64 = gp_grad_cost_rollout_plain(model, s0.double(), Q.double(), pvec.double(),
                                           {k: v.double() for k, v in ops.items()})
        for name, g, p, r in zip(("J", "dQ"), got, plain, ref64):
            dist, plain_dist = (float((t.double() - r).abs().max()) for t in (g, p))
            found[f"{name}_f64"], found[f"{name}_plain_f64"] = dist, plain_dist
            assert dist <= GP_F64_FACTOR * plain_dist + 1e-6 * float(r.abs().max()), found
    else:
        assert torch.allclose(got[0], plain[0], **KERNEL_TOL), found
        assert close(got[1], plain[1], DQ_RTOL, DQ_ATOL_FRAC), found
    record_property("k10_lane_split_distances", found)


@pytest.mark.parametrize("lanes", [2, 4, 8, 16])
@pytest.mark.parametrize("case", GP_CASES)
def test_k14_lane_split_sum_order_stays_within_the_kernel_bounds(case, lanes, record_property):
    """K14's sums over the inducing points taken in its lane split's order
    (its forward step is K10's: per-lane fmaf partial sums over m = lane
    mod L, then the xor butterfly, whatever the lanes' stride in the
    warp), emulated in float32 over chip_smoke.py phase 20's GPs at H=50,
    stay within the bounds phase 20 holds the card's K14 to: over a
    well-conditioned GP (M=128, and M=100, not a multiple of 8 or 16) the
    cost to NET_TOL; over the committed GP, no further from the float64
    plain version than GP_F64_FACTOR times the float32 plain version's
    distance, plus 1e-6 of its largest cost, over 512 rollouts: over 64 the
    plain version's largest distance is too noisy a yardstick (0.38 there,
    where the emulation at 2 lanes is 0.93; over 512, 0.84 and 0.77)."""
    from chip_smoke import GP_F64_FACTOR, NET_TOL

    model, s0, Q, pvec, ops = gp_grad_problem(case, K_=512 if case == "committed" else 64)
    got = plain_cost_loop(model, s0, Q, pvec, k10_lane_split(ops, lanes)[0])
    plain = gp_cost_rollout_plain(model, s0, Q, pvec, ops)
    found = {"cost": float((got - plain).abs().max())}
    if case == "committed":
        ref64 = gp_cost_rollout_plain(model, s0.double(), Q.double(), pvec.double(),
                                      {k: v.double() for k, v in ops.items()})
        dist, plain_dist = (float((t.double() - ref64).abs().max()) for t in (got, plain))
        found["cost_f64"], found["cost_plain_f64"] = dist, plain_dist
        assert dist <= GP_F64_FACTOR * plain_dist + 1e-6 * float(ref64.abs().max()), found
    else:
        assert torch.allclose(got, plain, **NET_TOL), found
    record_property("k14_lane_split_distances", found)


# ---- on the card ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("Kc,M", [(1000, 128), (8, 128), (1000, 100)])
@pytest.mark.parametrize("grad,lanes", [(False, 0), (False, 1), (False, 2), (False, 4),
                                        (False, 8), (False, 16), (True, 0)])
def test_cuda_kernels_match_plain_versions(grad, lanes, Kc, M):
    """K14 (at its own lanes a rollout and at each of 1-16) and K10 against
    their plain versions on the same card tensors, at K=1000 (ragged) and
    K=8 (below one warp of the kernels' lanes), H=50 (chip_smoke.py phases
    20-21), over the committed GP's M=128 inducing points or its first 100
    (not a multiple of 8 or 16 lanes).  Over a
    well-conditioned GP of the committed one's widths (its alpha drawn
    N(0, 1), so the mean does not cancel in float32), to K11's and K7's
    bounds: the cost to rtol 5e-5 (K14) or 1e-4 (K10) plus 1e-3, dQ to rtol
    2e-5 plus 5e-6 * max|dQ|, which a dQ without the control-change term's
    carry to the previous step (gprev) exceeds.  Over the committed GP,
    whose large posterior weights cancel (in float32 the plain version and
    the kernel both sit ~1e-3 of the cost's scale from a float64
    evaluation), each output no further from the float64 plain version than
    twice the plain version's own largest distance over KREF=1000 rollouts
    (the kernel's K among them), plus 1e-6 of its largest entry: a largest
    distance over 8 rollouts is too noisy a yardstick (a mere reordering of
    the sums, emulated on the CPU, exceeds twice it for 3 of 8 seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    Hc = 50
    optimizer = "rpgd-tf" if grad else "mppi"
    cfg = (rpgd_config(num_rollouts=Kc, mpc_horizon=Hc) if grad
           else optimizer_config(Kc, Hc))
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": optimizer, "controller_logging": False,
                                 "device": "cuda"})
    ctrl.configure(optimizer_name=optimizer,
                   predictor_specification=f"SGP_128:{ASSETS / GP_ASSET}",
                   optimizer_config=cfg, cost_function_config=COST_WEIGHTS)
    model, pack = gp.gp_model(ctrl.optimizer)
    gen = torch.Generator(device=dev).manual_seed(0)
    Kref = max(Kc, 1000)
    s0_ref = 0.05 * torch.randn(Kref, 4, generator=gen, device=dev)
    Q_ref = torch.clamp(0.3 * torch.randn(Kref, Hc, 1, generator=gen, device=dev), -1.0, 1.0)
    s0, Q = s0_ref[:Kc].contiguous(), Q_ref[:Kc].contiguous()
    params = ctrl._assemble_params()
    pvec = pack(params, torch.tensor([0.1], device=dev))
    fitted = params["dyn"]["gp"]
    fitted = {**fitted, "Z": fitted["Z"][:M], "alpha": fitted["alpha"][:M]}
    alpha = torch.randn(fitted["alpha"].shape, generator=gen, device=dev)
    well = flatten_gp_weights({**fitted, "alpha": alpha})
    if grad:
        cost, dQ = gp_grad_cost_rollout(model, s0, Q, pvec, well)
        ref_cost, ref_dQ = gp_grad_cost_rollout_plain(model, s0, Q, pvec, well)
        torch.testing.assert_close(cost, ref_cost, rtol=1e-4, atol=1e-3)
        dq_tol = dict(rtol=2e-5, atol=5e-6 * float(ref_dQ.abs().max()))
        torch.testing.assert_close(dQ, ref_dQ, **dq_tol)
        p = model.unpack(pvec)
        prev = torch.cat([p["__u_prev_0"].expand(Kc, 1, 1), Q[:, :-1]], dim=1)
        change = 2.0 * p["c_ccrc_weight"] * (Q - prev) / (Hc + 1)
        no_gprev = dQ.clone()
        no_gprev[:, :-1] += change[:, 1:]
        assert not torch.allclose(no_gprev, ref_dQ, **dq_tol)
    else:
        torch.testing.assert_close(gp_cost_rollout_lanes(model, s0, Q, pvec, well, lanes),
                                   gp_cost_rollout_plain(model, s0, Q, pvec, well),
                                   rtol=5e-5, atol=1e-3)
    ops = flatten_gp_weights(fitted)
    ops64 = {k: v.double() for k, v in ops.items()}
    args64 = (model, s0_ref.double(), Q_ref.double(), pvec.double(), ops64)
    if grad:
        outs = zip(gp_grad_cost_rollout(model, s0, Q, pvec, ops),
                   gp_grad_cost_rollout_plain(model, s0_ref, Q_ref, pvec, ops),
                   gp_grad_cost_rollout_plain(*args64))
    else:
        outs = [(gp_cost_rollout_lanes(model, s0, Q, pvec, ops, lanes),
                 gp_cost_rollout_plain(model, s0_ref, Q_ref, pvec, ops),
                 gp_cost_rollout_plain(*args64))]
    for got, plain, ref64 in outs:
        bound = (2.0 * float((plain.double() - ref64).abs().max())
                 + 1e-6 * float(ref64.abs().max()))
        assert float((got.double() - ref64[:Kc]).abs().max()) <= bound


@pytest.mark.cuda
def test_cuda_kernels_refuse_inducing_points_past_shared_memory():
    """M=5000 inducing points take 5000 rows of 12 floats (240 KB), more
    than the 227 KB a block may stage: both entry points refuse the launch
    (cudaErrorInvalidValue) and the wrappers raise naming M; nothing is
    counted as launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and run only there")
    dev = torch.device("cuda")
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": "mppi", "controller_logging": False,
                                 "device": "cuda"})
    ctrl.configure(optimizer_name="mppi", predictor_specification=f"SGP_128:{ASSETS / GP_ASSET}",
                   optimizer_config=optimizer_config(256, 10), cost_function_config=COST_WEIGHTS)
    model, pack = gp.gp_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    gen = torch.Generator(device=dev).manual_seed(0)
    Zs = torch.randn(5000, 5, generator=gen, device=dev)
    ops = {**flatten_gp_weights(params["dyn"]["gp"]), "Zs": Zs, "zn2": (Zs * Zs).sum(1),
           "alphaT": torch.randn(4, 5000, generator=gen, device=dev)}
    s0, Q = torch.zeros(256, 4, device=dev), torch.zeros(256, 10, 1, device=dev)
    pvec = pack(params, torch.tensor([0.0], device=dev))
    before = gp_cost_rollout.launches, gp_grad_cost_rollout.launches
    for fn in (gp_cost_rollout, gp_grad_cost_rollout):
        with pytest.raises(RuntimeError, match="M=5000 inducing points"):
            fn(model, s0, Q, pvec, ops)
    assert (gp_cost_rollout.launches, gp_grad_cost_rollout.launches) == before


def jax_start_sweep(ticks: int = 200) -> dict:
    """The JAX package alone on the CPU: its MPPI over the committed GP at
    ``chip_smoke.py``'s configuration (K=16384, H=50, inducing period 10,
    SQRTRHOINV 0.05), closed loop against its own CartpoleEnv for ``ticks``
    ticks or until |angle| >= 0.5, from the start states of ``chip_smoke.py
    --starts`` (the JAX CartpoleEnv(seed=0) state, then the port's
    CartpoleEnv seeds 0-7), with optimizer seeds 0 and 1.  Prints one JSON
    line per run and returns the count of runs that kept the pole up."""
    import json

    starts = [np.asarray(JaxCartpoleEnv(batch_size=1, dt=0.02, seed=0).reset()[0][0])]
    starts += [CartpoleEnv(batch_size=1, dt=0.02, seed=k).reset()[0][0] for k in range(8)]
    held = []
    for seed in (0, 1):
        for i, start in enumerate(starts):
            ctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.0},
                          config={"optimizer": "mppi", "controller_logging": False})
            ctrl.configure(optimizer_name="mppi",
                           predictor_specification=f"SGP_128:{ASSETS / GP_ASSET}",
                           optimizer_config=optimizer_config(
                               16384, 50, seed=seed, period_interpolation_inducing_points=10))
            env = JaxCartpoleEnv(batch_size=1, dt=0.02, seed=0)
            env.reset()
            env.state = jnp.asarray(np.asarray(start, np.float32)[None])
            s, max_angle, fell_at = np.asarray(env.state), 0.0, None
            for t in range(ticks):
                s, *_ = env.step(ctrl.step(s[0]))
                max_angle = max(max_angle, abs(float(s[0, 2])))
                if max_angle >= 0.5:
                    fell_at = t
                    break
            held.append(fell_at is None)
            print(json.dumps({"seed": seed, "start": i, "start_state": [float(v) for v in start],
                              "max_abs_angle": max_angle, "fell_at_tick": fell_at}), flush=True)
    return {"runs": len(held), "pole_up_runs": sum(held)}


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    print(jax_start_sweep() if "--starts" in sys.argv[1:] else make_assets())
