"""The torch port's PETS ensemble against the JAX package: the
EnsemblePredictor (TS-inf blockwise, TS-1, probabilistic members, the
ensemble-mean fallback, all-member rollouts and disagreement, the spec),
the member-block (``n_members``) forms of K11 and K8 (their plain versions
against the JAX package's Pallas kernels in interpret mode), one MPPI,
rpgd-tf, CEM and iCEM step over an ensemble fed the JAX draws, the
``risk_weight`` and ``robust_eval`` options, the refusals, the committed
ensemble, and — on a machine with a card only — each CUDA form against its
plain version and, member by member, against its single-net kernel.

Both packages get the same weights (JAX's, written with the JAX
``save_net`` and loaded by each package's predictor, or passed through
``ensemble_params_from_numpy``) and the same inputs and noise, made with
numpy from a seed or drawn from the JAX key.

    PYTHONPATH=. python tests/test_torch_ensemble.py

from the repository's root regenerates the committed ensemble
(``make_assets``);

    PYTHONPATH=. python tests/test_torch_ensemble.py --loop

runs the JAX package's MPPI over it from chip_smoke.py's start
(``jax_mppi_loop``).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.models import ensemble_predictor as jens
from control_toolkit_tpu.models import networks as jnets
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.models import ensemble_predictor as pens
from control_toolkit_tpu_torch.models import networks as nets
from control_toolkit_tpu_torch.models.neural_predictor import NeuralPredictor
from control_toolkit_tpu_torch.models.predictors import PredictorWrapper
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_ens, neural_grad_cost_rollout_ens_plain,
)
from control_toolkit_tpu_torch.ops.neural_rollout import (
    neural_cost_rollout, neural_cost_rollout_ens, neural_cost_rollout_ens_plain,
)
from control_toolkit_tpu_torch.optimizers.cem import CEMState
from control_toolkit_tpu_torch.optimizers.icem import ICEMState
from control_toolkit_tpu_torch.optimizers.kernel_families import ensemble, neural
from control_toolkit_tpu_torch.utils.convert import ensemble_params_from_numpy, params_from_numpy
from test_torch_cem import cem_config, jax_draws
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import (
    CPU, LIMITS, UNOM_TOL, jax_next_draw, jax_params_numpy, optimizer_config, port_noise,
    set_shared_state,
)
from test_torch_neural import COST_WEIGHTS
from test_torch_rpgd import assert_rpgd_states_match, jax_rpgd_draw, rpgd_config, set_rpgd_state
from test_torch_zoo import icem_config, jax_white

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "control_toolkit_tpu_torch" / "assets" / "cartpole"
ENS_NET, ENS_MEMBERS = "mlp-32-32", 4
# Rollouts: test_torch_neural.py's bounds (float32 sums over the horizon of
# nets whose matmuls the packages sum in different orders); K11's form
# against the Pallas kernel with test_pallas_neural.py:224's bound; K8's
# with test_torch_neural_grad.py's (test_pallas_neural_grad.py:56-66).
ROLL_TOL = dict(rtol=1e-4, atol=1e-5)
COST_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=5e-4)
# The counter normal: Box-Muller on the same bits in float32, log and cos
# from two libraries.
NORMAL_ATOL = 1e-6
K, H, E = 128, 10, 4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_assets(out_dir: Path = ASSETS) -> np.ndarray:
    """Fit the committed ensemble with the JAX package's
    ``fit_ensemble_mlp_dynamics(n_members=4, hiddens=(32, 32), epochs=2500,
    seed=0)`` on ``collect_transitions(CartpoleEnv(16, seed=0), 400,
    seed=0)`` (tests/test_ensemble.py:38-46) and save it with its
    ``save_net`` as ``ensemble-mlp-32-32-x4.npz`` (meta ``predict_delta``
    and ``n_members``).  Returns the members' normalized MSEs."""
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
    from control_toolkit_tpu.models.training import (
        collect_transitions, fit_ensemble_mlp_dynamics,
    )

    out_dir.mkdir(parents=True, exist_ok=True)
    x, u, xn = collect_transitions(JaxCartpoleEnv(batch_size=16, dt=0.02, seed=0), 400, seed=0)
    params, mses = fit_ensemble_mlp_dynamics(x, u, xn, n_members=ENS_MEMBERS, hiddens=(32, 32),
                                             epochs=2500, seed=0)
    jnets.save_net(out_dir / jens.ensemble_checkpoint_name(ENS_NET, ENS_MEMBERS), params,
                   meta={"predict_delta": True, "n_members": ENS_MEMBERS})
    return np.asarray(mses)


def jax_ensemble(name: str = "mlp-16", members: int = E, seed: int = 0, norms: bool = False,
                 probabilistic: bool = False) -> dict:
    """A JAX-initialised stacked ensemble of ``members`` nets of ``name`` on
    cartpole as numpy arrays; ``norms`` adds per-member checkpoint-style
    statistics."""
    pred = jens.EnsemblePredictor(net_name=name, n_members=members, seed=seed,
                                  probabilistic=probabilistic)
    net = jax.tree_util.tree_map(np.asarray, pred.net_params)
    if norms:
        rng = np.random.default_rng(seed + 100)
        S = 4
        net.update(norm_in_mean=(0.1 * rng.standard_normal((members, S + 1))).astype(np.float32),
                   norm_in_std=rng.uniform(0.8, 1.5, (members, S + 1)).astype(np.float32),
                   norm_out_mean=np.full((members, S), 0.02, np.float32),
                   norm_out_std=rng.uniform(0.5, 1.0, (members, S)).astype(np.float32))
    return net


def constant_members(consts, S=2, U=1, lv_raw=None) -> dict:
    """tests/test_ensemble.py's hand-built members: member e predicts x + c_e
    (zero weights, output bias c_e), with a raw log-variance head ``lv_raw``
    for probabilistic members."""
    sizes = [S + U, 4, S if lv_raw is None else 2 * S]
    net = {}
    for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
        net[f"w{i}"] = np.zeros((len(consts), fi, fo), np.float32)
        net[f"b{i}"] = np.zeros((len(consts), fo), np.float32)
    net["b1"] = np.stack([np.full(S, c, np.float32) if lv_raw is None else
                          np.concatenate([np.full(S, c), np.full(S, lv_raw)]).astype(np.float32)
                          for c in consts])
    return net


def predictor_pair(net: dict, name: str = "mlp-16", S: int = 4, **kw):
    """The JAX and the port EnsemblePredictor over one stacked net."""
    members = net["w0"].shape[0]
    dims = {} if S == 4 else {"num_states": S, "num_control_inputs": 1}
    jpred = jens.EnsemblePredictor(net_name=name, n_members=members,
                                   params=jax.tree_util.tree_map(jnp.asarray, net), **dims, **kw)
    ppred = pens.EnsemblePredictor(net_name=name, n_members=members, device="cpu",
                                   params=ensemble_params_from_numpy(net)["net"], **dims, **kw)
    return jpred, ppred


def rollout_inputs(Kr: int, Hr: int = H, S: int = 4, seed: int = 5):
    rng = np.random.default_rng(seed)
    return ((0.1 * rng.standard_normal((Kr, S))).astype(np.float32),
            rng.uniform(-1.0, 1.0, (Kr, Hr, 1)).astype(np.float32))


def both_rollouts(jpred, ppred, s0, Q):
    return (np.asarray(jpred.rollout(jnp.asarray(s0), jnp.asarray(Q), jpred.default_params())),
            ppred.rollout(torch.tensor(s0), torch.tensor(Q)).numpy())


def make_pair(tmp_path, net: dict, optimizer: str = "mppi", config=None, name: str = "mlp-16",
              predict_delta: bool = True, spec_tail: str = "", jax_logging: bool = False):
    """The JAX and the port controller over one checkpoint of the stacked
    ``net``, written by the JAX ``save_net`` under ``tmp_path``."""
    members = net["w0"].shape[0]
    jnets.save_net(tmp_path / jens.ensemble_checkpoint_name(name, members), net,
                   meta={"predict_delta": predict_delta, "n_members": members})
    spec = f"ensemble:{name}:{members}:{tmp_path}{spec_tail}"
    cfg = dict(config or optimizer_config(K, H))
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.3},
                   config={"optimizer": optimizer, "controller_logging": jax_logging})
    jctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                    optimizer_config=dict(cfg))
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                          config={"device": "cpu", "optimizer": optimizer,
                                  "controller_logging": False})
    pctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                    optimizer_config=dict(cfg))
    return jctrl, pctrl


def cost_inputs(Kc: int, Hc: int, seed: int = 8):
    rng = np.random.default_rng(seed)
    s_tiled = np.tile(np.array([[0.1, -0.2, 0.3, 0.05]], np.float32), (Kc, 1))
    Q = rng.uniform(-0.8, 0.8, (Kc, Hc, 1)).astype(np.float32)
    return s_tiled, Q, np.array([0.25], np.float32)


# ---- the predictor -----------------------------------------------------------------
@pytest.mark.parametrize("norms,delta", [(False, True), (True, True), (True, False)])
def test_tsinf_blockwise_rollout_matches_jax(norms, delta):
    jpred, ppred = predictor_pair(jax_ensemble(seed=1, norms=norms), predict_delta=delta)
    got = both_rollouts(jpred, ppred, *rollout_inputs(8))
    np.testing.assert_allclose(got[1], got[0], **ROLL_TOL)
    # Block e of K/E rollouts runs member e for the whole horizon.
    s0, Q = rollout_inputs(8)
    for e in range(E):
        one = {k: v[e:e + 1] for k, v in jax_ensemble(seed=1, norms=norms).items()}
        _, single = predictor_pair(one, predict_delta=delta)
        rows = slice(2 * e, 2 * e + 2)
        np.testing.assert_allclose(single.rollout(torch.tensor(s0[rows]),
                                                  torch.tensor(Q[rows])).numpy(),
                                   got[1][rows], **ROLL_TOL)


def test_tsinf_blockwise_assignment_of_constant_members():
    _, ppred = predictor_pair(constant_members([1.0, -2.0]), name="mlp-4", S=2)
    traj = ppred.rollout(torch.zeros(4, 2), torch.zeros(4, 3, 1)).numpy()
    np.testing.assert_allclose(traj[0, -1], np.full(2, 3.0), atol=1e-6)
    np.testing.assert_allclose(traj[2, -1], np.full(2, -6.0), atol=1e-6)


@pytest.mark.parametrize("Kr", [1, 3, 6])
def test_ensemble_mean_fallback_for_odd_batches_matches_jax(Kr):
    jpred, ppred = predictor_pair(jax_ensemble(seed=2, norms=True))
    got = both_rollouts(jpred, ppred, *rollout_inputs(Kr))
    np.testing.assert_allclose(got[1], got[0], **ROLL_TOL)
    _, const = predictor_pair(constant_members([1.0, -2.0, 0.5, 0.5]), name="mlp-4", S=2)
    traj = const.rollout(torch.zeros(Kr, 2), torch.zeros(Kr, 3, 1)).numpy()
    np.testing.assert_allclose(traj[:, -1], np.full((Kr, 2), 0.0), atol=1e-6)


def test_ts1_member_indices_are_jax_bit_for_bit():
    for Kr, members in ((37, 4), (64, 5), (9, 8)):
        for t in (0, 1, 7, 49, 2**20 + 3):
            k = jnp.arange(Kr, dtype=jnp.uint32)
            ref = jens._mix32((k * jens._HASH_K) ^ (jnp.uint32(t) * jens._HASH_T)) \
                % jnp.uint32(members)
            np.testing.assert_array_equal(pens.ts1_members(Kr, t, members).numpy(),
                                          np.asarray(ref).astype(np.int64))
    h = np.random.default_rng(0).integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(pens._mix32(torch.tensor(h.astype(np.int64))).numpy(),
                                  np.asarray(jens._mix32(jnp.asarray(h))).astype(np.int64))


@pytest.mark.parametrize("prob", [False, True])
def test_ts1_rollout_matches_jax(prob):
    jpred, ppred = predictor_pair(jax_ensemble(seed=3, norms=True, probabilistic=prob), ts="1",
                                  probabilistic=prob, noise_seed=11)
    assert ppred.single_step is None and jpred.single_step is None
    got = both_rollouts(jpred, ppred, *rollout_inputs(9))
    np.testing.assert_allclose(got[1], got[0], **ROLL_TOL)


def test_ts1_member_hash_is_not_round_robin():
    """tests/test_ensemble.py:730 on the port: a power-of-two E still
    mixes the members over time and over rollouts."""
    _, ppred = predictor_pair(constant_members([1.0, 2.0, 3.0, 4.0]), name="mlp-4", S=2, ts="1")
    traj = ppred.rollout(torch.zeros(8, 2), torch.zeros(8, 16, 1)).numpy()
    members = np.rint(np.diff(traj[:, :, 0], axis=1)).astype(int)
    assert any(not np.array_equal(members[k, :4], members[k, 4:8]) for k in range(8))
    assert any(not np.array_equal(members[k], members[k + 4]) for k in range(4))


def test_counter_normal_matches_jax():
    rows = np.arange(0, 3000, 7)
    for t, dims, seed in ((0, 4, 0), (13, 4, 11), (2**31 + 5, 3, 2**32 - 1)):
        ref = np.asarray(jens.counter_normal(jnp.asarray(rows), t, dims, seed))
        got = pens.counter_normal(torch.tensor(rows), t, dims, seed).numpy()
        assert got.dtype == np.float32 and got.shape == (rows.size, dims)
        np.testing.assert_allclose(got, ref, rtol=0, atol=NORMAL_ATOL)
    draws = pens.counter_normal(torch.arange(20000), 3, 2, 0)
    assert abs(float(draws.mean())) < 0.03 and abs(float(draws.std()) - 1.0) < 0.03


def test_bound_logvar_matches_jax():
    raw = np.linspace(-20.0, 20.0, 101).astype(np.float32)
    np.testing.assert_allclose(pens.bound_logvar(torch.tensor(raw)).numpy(),
                               np.asarray(jens.bound_logvar(jnp.asarray(raw))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("Kr", [8, 3])
def test_probabilistic_rollout_matches_jax(Kr):
    """TS-inf with the aleatoric head sampled per (rollout, step, dim), and
    the noise-free ensemble mean for a batch that does not split."""
    jpred, ppred = predictor_pair(jax_ensemble(seed=4, norms=True, probabilistic=True),
                                  probabilistic=True, noise_seed=7)
    assert ppred.single_step is None
    got = both_rollouts(jpred, ppred, *rollout_inputs(Kr))
    np.testing.assert_allclose(got[1], got[0], **ROLL_TOL)


def test_probabilistic_rollout_propagates_the_noise():
    _, ppred = predictor_pair(constant_members([0.0, 0.0], lv_raw=-2.0), name="mlp-4", S=2,
                              probabilistic=True)
    traj = ppred.rollout(torch.zeros(64, 2), torch.zeros(64, 5, 1)).numpy()
    std = np.exp(0.5 * pens.bound_logvar(torch.tensor(-2.0)).item())
    assert abs(float(np.diff(traj, axis=1).std()) - std) < 0.1 * std
    again = ppred.rollout(torch.zeros(64, 2), torch.zeros(64, 5, 1)).numpy()
    np.testing.assert_array_equal(traj, again)  # key-free: the same draws each call


def test_e1_equals_the_neural_predictor():
    net = jax_ensemble(seed=5, members=1, norms=True)
    _, ppred = predictor_pair(net)
    single = NeuralPredictor(device="cpu", net_name="mlp-16",
                             params={k: torch.tensor(v[0]) for k, v in net.items()})
    s0, Q = rollout_inputs(6)
    torch.testing.assert_close(ppred.rollout(torch.tensor(s0), torch.tensor(Q)),
                               single.rollout(torch.tensor(s0), torch.tensor(Q)),
                               rtol=1e-6, atol=1e-6)


def test_rollout_all_members_and_disagreement_match_jax():
    jpred, ppred = predictor_pair(jax_ensemble(seed=6, norms=True))
    s0, Q = rollout_inputs(5)
    allm = ppred.rollout_all_members(torch.tensor(s0), torch.tensor(Q))
    assert tuple(allm.shape) == (E, 5, H + 1, 4)
    np.testing.assert_allclose(allm.numpy(), np.asarray(jpred.rollout_all_members(s0, Q)),
                               **ROLL_TOL)
    np.testing.assert_allclose(ppred.disagreement(torch.tensor(s0), torch.tensor(Q)).numpy(),
                               np.asarray(jpred.disagreement(s0, Q)), rtol=1e-4, atol=1e-6)
    _, const = predictor_pair(constant_members([1.0, 1.0]), name="mlp-4", S=2)
    assert float(const.disagreement(torch.zeros(3, 2), torch.zeros(3, 4, 1)).abs().max()) == 0.0


def test_spec_parsing_and_the_checkpoint(tmp_path):
    net = jax_ensemble("mlp-8", members=3, seed=7, norms=True)
    jnets.save_net(tmp_path / "ensemble-mlp-8-x3.npz", net,
                   meta={"predict_delta": False, "n_members": 3, "probabilistic": False})
    wrapper = PredictorWrapper()
    wrapper.configure(predictor_specification=f"ensemble:mlp-8:3:{tmp_path}", device="cpu")
    pred = wrapper.predictor
    assert isinstance(pred, pens.EnsemblePredictor) and pred.n_members == 3
    assert not pred.predict_delta and pred.ts == "inf" and not pred.probabilistic
    assert tuple(pred.net_params["w0"].shape) == (3, 5, 8)
    np.testing.assert_array_equal(pred.net_params["norm_out_std"].numpy(), net["norm_out_std"])
    wrapper.configure(predictor_specification=f"ensemble:mlp-8:3:{tmp_path}:ts1", device="cpu")
    assert wrapper.predictor.ts == "1" and wrapper.single_step is None
    wrapper.configure(predictor_specification="ensemble:mlp-8:2:prob", device="cpu")
    assert wrapper.predictor.probabilistic and wrapper.predictor.n_members == 2
    assert tuple(wrapper.predictor.net_params["w1"].shape) == (2, 8, 8)  # mean and log-variance
    wrapper.configure(predictor_specification="ensemble:mlp-8", device="cpu")
    assert wrapper.predictor.n_members == 5  # JAX's default
    random_init = pens.EnsemblePredictor(net_name="mlp-8", n_members=4, device="cpu",
                                         path_to_models=str(tmp_path))  # no x4 file
    assert tuple(random_init.net_params["w0"].shape) == (4, 5, 8)
    with pytest.raises(ValueError, match="member axis of size 3"):
        pens.EnsemblePredictor(net_name="mlp-8", n_members=3, device="cpu",
                               params={k: torch.tensor(v[:2]) for k, v in net.items()})
    jnets.save_net(tmp_path / "ensemble-mlp-8-x2.npz", net, meta={"n_members": 3})
    with pytest.raises(ValueError, match="holds 3 members"):
        pens.EnsemblePredictor(net_name="mlp-8", n_members=2, path_to_models=str(tmp_path),
                               device="cpu")
    with pytest.raises(ValueError, match="prob"):
        pens.EnsemblePredictor(net_name="mlp-8", n_members=3, path_to_models=str(tmp_path),
                               probabilistic=True, device="cpu")
    with pytest.raises(ValueError, match="MLP"):
        pens.EnsemblePredictor(net_name="GRU-5IN-8H1-4OUT", n_members=2, device="cpu")


def test_indivisible_population_raises_at_configure(tmp_path):
    """JAX tests/test_ensemble.py:708 on the port; robust_eval scores every
    plan under every member, so it takes any K."""
    make_pair(tmp_path, jax_ensemble(seed=8))  # writes the checkpoint
    for config in (optimizer_config(50, H), optimizer_config(50, H, robust_eval="mean")):
        ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                             config={"device": "cpu", "optimizer": "mppi",
                                     "controller_logging": False})

        def configure():
            ctrl.configure(optimizer_name="mppi", optimizer_config=config,
                           predictor_specification=f"ensemble:mlp-16:4:{tmp_path}")

        if "robust_eval" in config:
            configure()
            assert np.all(np.isfinite(ctrl.step(np.array([0.0, 0.0, 0.1, 0.0], np.float32))))
        else:
            with pytest.raises(ValueError, match="divide"):
                configure()


# ---- K11's and K8's member-block forms against the Pallas kernels --------------------
@pytest.mark.parametrize("Kc,Hc,members,norms,delta", [
    (256, 20, 4, False, True),
    (128, 10, 2, True, False),
])
def test_k11_ens_plain_matches_pallas_interpret(tmp_path, Kc, Hc, members, norms, delta):
    jctrl, pctrl = make_pair(tmp_path, jax_ensemble(members=members, seed=9, norms=norms),
                             config=optimizer_config(Kc, Hc), predict_delta=delta)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert ensemble.can_use_cost(popt) and not neural.can_use_cost(popt)
    s_tiled, Q, u_prev = cost_inputs(Kc, Hc)
    pallas = jopt._build_pallas_ensemble_cost(interpret=True, tile_k=32)
    ref = np.asarray(pallas(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev),
                            jctrl._assemble_params()))
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    before = neural_cost_rollout_ens.launches
    got = popt._make_cost_only()(torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev),
                                 params)
    assert neural_cost_rollout_ens.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), ref, **COST_TOL)


def test_k8_ens_plain_matches_pallas_interpret(tmp_path):
    Kc, Hc = 256, 10
    jctrl, pctrl = make_pair(tmp_path, jax_ensemble(seed=10, norms=True), optimizer="rpgd-tf",
                             config=rpgd_config(num_rollouts=Kc, mpc_horizon=Hc))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert ensemble.can_use_grad(popt) and not neural.can_use_grad(popt)
    s_tiled, Q, u_prev = cost_inputs(Kc, Hc)
    pallas = jopt._build_pallas_ensemble_grad(interpret=True, tile_k=64)
    ref_cost, ref_dq = pallas(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev),
                              jctrl._assemble_params())
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    model, pack = ensemble.net_model(popt)
    before = neural_grad_cost_rollout_ens.launches
    cost, dQ = neural_grad_cost_rollout_ens(model, torch.tensor(s_tiled), torch.tensor(Q),
                                            pack(params, torch.tensor(u_prev)),
                                            params["dyn"]["net"])
    assert neural_grad_cost_rollout_ens.launches == before
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), np.asarray(ref_dq), **GRAD_TOL)
    grad_fn, cost_only = popt._make_grad_and_cost_only()
    torch.testing.assert_close(grad_fn(torch.tensor(Q), torch.tensor(s_tiled),
                                       torch.tensor(u_prev), params), dQ)


@pytest.mark.parametrize("members", [1, 4])
def test_member_blocks_are_the_single_net_plain_versions(tmp_path, members):
    """Each block of K/E rollouts is the single net's plain version under
    its member (E=1: the whole of K11's), ragged K/E included."""
    _, pctrl = make_pair(tmp_path, jax_ensemble(members=members, seed=11, norms=True))
    model, pack = ensemble.net_model(pctrl.optimizer)
    params = pctrl._assemble_params()
    net = params["dyn"]["net"]
    for Kc in (K, 4 * 37):
        s0, Q = (torch.tensor(a) for a in rollout_inputs(Kc))
        pvec = pack(params, torch.tensor([0.1]))
        cost = neural_cost_rollout_ens(model, s0, Q, pvec, net)
        c1, d1 = neural_grad_cost_rollout_ens(model, s0, Q, pvec, net)
        per = Kc // members
        for e in range(members):
            rows = slice(e * per, (e + 1) * per)
            one = {k: v[e] for k, v in net.items()}
            torch.testing.assert_close(cost[rows], neural_cost_rollout(model, s0[rows], Q[rows],
                                                                       pvec, one),
                                       rtol=1e-5, atol=1e-5)
            c2, d2 = neural_grad_cost_rollout(model, s0[rows], Q[rows], pvec, one)
            torch.testing.assert_close(c1[rows], c2, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(d1[rows], d2, **GRAD_TOL)


def test_form_wrappers_check_the_members_and_never_fall_back(tmp_path):
    _, pctrl = make_pair(tmp_path, jax_ensemble(seed=12))
    model, pack = ensemble.net_model(pctrl.optimizer)
    params = pctrl._assemble_params()
    net, pvec = params["dyn"]["net"], pack(params, torch.tensor([0.0]))
    with pytest.raises(ValueError, match="K % E"):
        neural_cost_rollout_ens(model, torch.zeros(6, 4), torch.zeros(6, 3, 1), pvec, net)
    with pytest.raises(ValueError, match="K % E"):
        neural_grad_cost_rollout_ens(model, torch.zeros(8, 4), torch.zeros(8, 3, 1), pvec,
                                     {k: v[0] for k, v in net.items()})
    meta = dict(device="meta")
    meta_net = {k: torch.empty(v.shape, **meta) for k, v in net.items()}
    before = (neural_cost_rollout_ens.launches, neural_grad_cost_rollout_ens.launches)
    for wrapper in (neural_cost_rollout_ens, neural_grad_cost_rollout_ens):
        with pytest.raises(ValueError, match="several devices"):
            wrapper(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
                    torch.empty(8, **meta), net)
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
                    torch.empty(8, **meta), meta_net)
    assert (neural_cost_rollout_ens.launches, neural_grad_cost_rollout_ens.launches) == before
    args, tensors = model.net_args(net, members=E)
    assert list(args.dims)[:4] == [5, 16, 4, 0] and set(tensors) == set(net)
    with pytest.raises(ValueError, match="w0"):
        model.net_args({**net, "w0": net["w0"][:3]}, members=E)


def test_kernel_family_gates(tmp_path):
    net = jax_ensemble(seed=13)
    _, base = make_pair(tmp_path, net)
    assert ensemble.can_use_cost(base.optimizer) and ensemble.can_use_grad(base.optimizer)
    assert base.optimizer._make_cost_only() is not base.optimizer._fused_cost
    for tail, extra in ((":ts1", {}), ("", {"force_scan": True})):
        _, pctrl = make_pair(tmp_path, net, config=optimizer_config(K, H, **extra),
                             spec_tail=tail)
        assert not ensemble.can_use_cost(pctrl.optimizer)
    _, prob = make_pair(tmp_path, jax_ensemble(seed=13, probabilistic=True), spec_tail=":prob")
    assert not ensemble.can_use_cost(prob.optimizer) and prob.optimizer._make_cost_only() is None
    for extra in ({"risk_weight": 0.5}, {"robust_eval": "worst"}):
        _, pctrl = make_pair(tmp_path, net, optimizer="rpgd-tf",
                             config=rpgd_config(num_rollouts=K, mpc_horizon=H, **extra))
        assert ensemble.can_use_cost(pctrl.optimizer)
        assert not ensemble.can_use_grad(pctrl.optimizer)


def test_a_refit_reaches_the_next_call_without_rebuild(tmp_path):
    _, pctrl = make_pair(tmp_path, jax_ensemble(seed=14, norms=True))
    popt, pred = pctrl.optimizer, pctrl.optimizer.predictor.predictor
    cost_fn, epoch = popt._make_cost_only(), popt._build_epoch
    s, Q = torch.tensor([[0.1, 0.0, 0.2, 0.0]]).expand(K, 4), torch.full((K, H, 1), 0.3)
    first = cost_fn(s, Q, torch.tensor([0.0]), pctrl._assemble_params())
    pred.net_params = {**pred.net_params, "w1": 1.5 * pred.net_params["w1"]}
    params = pctrl._assemble_params()
    assert params["dyn"]["net"]["w1"] is pred.net_params["w1"]
    swapped = cost_fn(s, Q, torch.tensor([0.0]), params)
    assert not torch.allclose(first, swapped) and popt._build_epoch == epoch
    model, pack = ensemble.net_model(popt)
    torch.testing.assert_close(swapped, neural_cost_rollout_ens_plain(
        model, s, Q, pack(params, torch.tensor([0.0])), params["dyn"]["net"]))


# ---- the path: one step of each optimizer over an ensemble --------------------------
@pytest.mark.parametrize("norms", [False, True])
def test_one_mppi_update_over_an_ensemble_matches_jax(tmp_path, norms):
    jctrl, pctrl = make_pair(tmp_path, jax_ensemble(seed=15, norms=norms))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert not popt._uses_semi_fused()
    set_shared_state(jopt, popt)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    delta = jax_next_draw(jopt)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    u_jax = jctrl.step(s)
    u, _, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params,
                             port_noise(popt, delta))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom),
                               **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


@pytest.mark.parametrize("count", [10, 7])
def test_one_rpgd_update_over_an_ensemble_matches_jax(tmp_path, count):
    jctrl, pctrl = make_pair(tmp_path, jax_ensemble(seed=16, norms=True), optimizer="rpgd-tf",
                             config=rpgd_config(num_rollouts=64, mpc_horizon=H),
                             jax_logging=True)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert ensemble.can_use_grad(popt)
    set_rpgd_state(jopt, popt, count)
    s = np.array([0.1, -0.05, 0.2, 0.3], np.float32)
    draw = torch.as_tensor(jax_rpgd_draw(jopt)) if count % 10 == 0 else None
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    u_jax = jctrl.step(s)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params, draw)
    assert_rpgd_states_match(jopt, state, diag, u, u_jax)


def test_one_cem_step_over_an_ensemble_matches_jax(tmp_path):
    jctrl, pctrl = make_pair(tmp_path, jax_ensemble(seed=17, norms=True), optimizer="cem-tf",
                             config=cem_config(K=64, H=H))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    rng = np.random.default_rng(1)
    mue = rng.uniform(-0.4, 0.4, (1, H, 1)).astype(np.float32)
    std = rng.uniform(0.2, 0.6, (1, H, 1)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    jopt.opt_state = jopt.opt_state._replace(
        dist_mue=jnp.asarray(mue), stdev=jnp.asarray(std), count=jnp.asarray(1, jnp.int32),
        u_prev=jnp.asarray(u_prev))
    popt.opt_state = CEMState(popt.opt_state.generator, torch.tensor(mue), torch.tensor(std), 1,
                              torch.tensor(u_prev))
    draws = jax_draws(jopt, 2, False)
    jparams = jctrl._assemble_params()
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    before = neural_cost_rollout_ens.launches
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    assert neural_cost_rollout_ens.launches == before
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]),
                               **COST_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    np.testing.assert_allclose(st.dist_mue.numpy(), np.asarray(st_j.dist_mue), **UNOM_TOL)
    np.testing.assert_allclose(st.stdev.numpy(), np.asarray(st_j.stdev), **UNOM_TOL)


def test_one_icem_step_over_an_ensemble_matches_jax(tmp_path):
    cfg = icem_config(num_rollouts=64, mpc_horizon=H, cem_best_k=16)
    jctrl, pctrl = make_pair(tmp_path, jax_ensemble(seed=18, norms=True), optimizer="icem-tf",
                             config=cfg)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    n_keep, n_fresh = popt.n_keep, popt._n_fresh
    rng = np.random.default_rng(4)
    mue = rng.uniform(-0.4, 0.4, (1, H, 1)).astype(np.float32)
    std = rng.uniform(0.2, 0.6, (1, H, 1)).astype(np.float32)
    elites = rng.uniform(-0.8, 0.8, (n_keep, H, 1)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    jopt.opt_state = jopt.opt_state._replace(
        dist_mue=jnp.asarray(mue), stdev=jnp.asarray(std), elites=jnp.asarray(elites),
        count=jnp.asarray(1, jnp.int32), u_prev=jnp.asarray(u_prev))
    popt.opt_state = ICEMState(popt.opt_state.generator, torch.tensor(mue), torch.tensor(std),
                               torch.tensor(elites), 1, torch.tensor(u_prev))
    key, draws = jopt.opt_state.key, []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(torch.tensor(jax_white(sub, H, (n_fresh, 1))))
    jparams = jctrl._assemble_params()
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]),
                               **COST_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    for name in ("dist_mue", "stdev", "elites"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   **UNOM_TOL)


# ---- risk_weight and robust_eval -------------------------------------------------------
@pytest.mark.parametrize("option", [
    {"risk_weight": 0.7},
    {"robust_eval": "mean"},
    {"robust_eval": "worst"},
    {"robust_eval": "cvar:0.5"},
    {"robust_eval": "worst", "risk_weight": 0.3},
])
def test_risk_and_robust_costs_and_gradients_match_jax(tmp_path, option):
    Kc = 32
    jctrl, pctrl = make_pair(tmp_path, jax_ensemble(seed=19, norms=True), optimizer="rpgd-tf",
                             config=rpgd_config(num_rollouts=Kc, mpc_horizon=H, **option))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    s_tiled, Q, u_prev = cost_inputs(Kc, H, seed=20)
    jparams = jctrl._assemble_params()
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    args_j = (jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev), jparams)
    args_p = (torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev), params)
    np.testing.assert_allclose(popt._make_cost_only()(*args_p).numpy(),
                               np.asarray(jopt._make_cost_only()(*args_j)), **COST_TOL)
    jcost, _ = jopt._rollout_and_cost(*args_j)
    pcost, traj = popt._rollout_and_cost(*args_p)
    np.testing.assert_allclose(pcost.numpy(), np.asarray(jcost), **COST_TOL)
    assert tuple(traj.shape) == (Kc, H + 1, 4)
    jgrad = jopt._make_grad_and_cost_only()[0](args_j[1], args_j[0], args_j[2], jparams)
    pgrad = popt._make_grad_and_cost_only()[0](args_p[1], args_p[0], args_p[2], params)
    np.testing.assert_allclose(pgrad.numpy(), np.asarray(jgrad), **GRAD_TOL)


def test_risk_weight_adds_the_disagreement_to_the_mppi_costs(tmp_path):
    net = jax_ensemble(seed=21, norms=True)
    _, plain = make_pair(tmp_path, net)
    _, risky = make_pair(tmp_path, net, config=optimizer_config(K, H, risk_weight=2.0))
    s_tiled, Q, u_prev = (torch.tensor(a) for a in cost_inputs(K, H, seed=22))
    params = plain._assemble_params()
    j0 = plain.optimizer._make_cost_only()(s_tiled, Q, u_prev, params)
    j2 = risky.optimizer._make_cost_only()(s_tiled, Q, u_prev, params)
    dis = plain.optimizer.predictor.predictor.disagreement(s_tiled, Q, params["dyn"])
    assert float(dis.min()) > 0.0
    torch.testing.assert_close(j2, j0 + 2.0 * dis)


def test_robust_aggregation_matches_manual():
    from control_toolkit_tpu_torch.optimizers.random_action import RandomActionOptimizer

    mc = torch.tensor(np.random.default_rng(0).normal(size=(4, 8)), dtype=torch.float32)

    def aggregate(mode):
        return RandomActionOptimizer(predictor=None, cost_function=None, control_limits=LIMITS,
                                     num_rollouts=8, mpc_horizon=5, seed=0,
                                     robust_eval=mode)._robust_aggregate(mc)

    torch.testing.assert_close(aggregate("mean"), mc.mean(0))
    torch.testing.assert_close(aggregate("worst"), mc.max(0).values)
    torch.testing.assert_close(aggregate("cvar:0.5"), mc.sort(0).values[-2:].mean(0))
    torch.testing.assert_close(aggregate("cvar:1.0"), mc.mean(0))


def test_option_errors_match_jax():
    """JAX tests/test_ensemble.py:260 and :601: the options need an
    ensemble, and robust_eval a known mode; remat and initial_guess_policy
    are taken by both packages."""
    for option, match in (({"risk_weight": 1.0}, "disagreement"),
                          ({"robust_eval": "worst"}, "rollout_all_members")):
        for ctrl_cls in (JaxMPC, MPCController):
            ctrl = ctrl_cls("cartpole", LIMITS, {"target_position": 0.0},
                            config={"optimizer": "mppi", "controller_logging": False,
                                    "device": "cpu"})
            with pytest.raises(ValueError, match=match):
                ctrl.configure(optimizer_name="mppi", predictor_specification="ODE",
                               optimizer_config=optimizer_config(32, 10, **option))
    from control_toolkit_tpu.optimizers.random_action import (
        RandomActionOptimizer as JaxRandomAction,
    )
    from control_toolkit_tpu_torch.optimizers.random_action import RandomActionOptimizer

    for bad in ("median", "cvar:0", "cvar:1.5"):
        for opt_cls in (JaxRandomAction, RandomActionOptimizer):  # both packages refuse it
            with pytest.raises(ValueError, match="robust_eval|cvar"):
                opt_cls(predictor=None, cost_function=None, control_limits=LIMITS,
                        num_rollouts=8, mpc_horizon=5, seed=0, robust_eval=bad)
    # Both packages take remat and the policy; random-action has no hook,
    # so the policy is never armed.
    for option in ({"remat": True}, {"initial_guess_policy": lambda x, p: x[:1]}):
        for opt_cls in (JaxRandomAction, RandomActionOptimizer):
            opt = opt_cls(predictor=None, cost_function=None, control_limits=LIMITS, **option)
            assert opt.remat == ("remat" in option)
            assert opt.initial_guess_policy is option.get("initial_guess_policy")
            assert not hasattr(opt, "_apply_policy_guess")


def test_robust_mppi_closed_loop_ticks(tmp_path):
    _, pctrl = make_pair(tmp_path, jax_ensemble(seed=24, norms=True),
                         config=optimizer_config(64, H, robust_eval="worst", risk_weight=0.1))
    before = neural_cost_rollout_ens.launches
    s = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    for _ in range(3):
        assert np.all(np.isfinite(pctrl.step(s)))
    assert neural_cost_rollout_ens.launches == before


# ---- the fleet ---------------------------------------------------------------------
@pytest.mark.parametrize("optimizer,config", [
    ("mppi", optimizer_config(32, 8)),
    ("rpgd-tf", rpgd_config(num_rollouts=32, mpc_horizon=8, warmup=False)),
])
def test_an_ensemble_fleet_names_the_vmapped_per_slot_step(tmp_path, optimizer, config):
    jnets.save_net(tmp_path / "ensemble-mlp-8-x4.npz", jax_ensemble("mlp-8", seed=25),
                   meta={"predict_delta": True, "n_members": 4})
    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"optimizer": optimizer, "controller_logging": False,
                                        "device": "cpu"})
    # The ensemble kernels have no session-row form in either package: the
    # per-slot step serves the fleet, each active slot equal to its
    # single-session controller bit for bit.
    from test_torch_fleet_per_slot import assert_slots_equal_single

    ctrl.configure(optimizer_name=optimizer, optimizer_config=config, num_slots=3,
                   predictor_specification=f"ensemble:mlp-8:4:{tmp_path}")
    assert ctrl._per_slot
    assert_slots_equal_single(ctrl)


# ---- the committed ensemble ------------------------------------------------------------
def test_committed_ensemble_is_what_the_generator_documents():
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
    from control_toolkit_tpu.models.training import collect_transitions

    path = ASSETS / jens.ensemble_checkpoint_name(ENS_NET, ENS_MEMBERS)
    expected = {"w0": (4, 5, 32), "b0": (4, 32), "w1": (4, 32, 32), "b1": (4, 32),
                "w2": (4, 32, 4), "b2": (4, 4), "norm_in_mean": (4, 5), "norm_in_std": (4, 5),
                "norm_out_mean": (4, 4), "norm_out_std": (4, 4)}
    with np.load(path) as data:
        assert {k: data[k].shape for k in data.files if k != "__meta"} == expected
    jnet, jmeta = jnets.load_net(path)
    pnet, pmeta = nets.load_net(path)
    assert jmeta == pmeta == {"predict_delta": True, "n_members": 4}
    for key in expected:
        np.testing.assert_array_equal(pnet[key].numpy(), np.asarray(jnet[key]))
    w0 = pnet["w0"].numpy()
    assert all(not np.allclose(w0[0], w0[e]) for e in range(1, 4))  # distinct members
    # Each member's one-step error on fresh transitions, normalized as its
    # fit normalizes it.
    pred = pens.EnsemblePredictor(net_name=ENS_NET, n_members=ENS_MEMBERS,
                                  path_to_models=str(ASSETS), device="cpu")
    x, u, xn = collect_transitions(JaxCartpoleEnv(batch_size=16, dt=0.02, seed=7), 100, seed=7)
    x, u, xn = (torch.tensor(np.asarray(a)) for a in (x, u, xn))
    nxt = pred._all_members(pred.net_params, x, u)
    err = (((nxt - xn) / pnet["norm_out_std"][:, None, :]) ** 2).mean(dim=(1, 2))
    assert float(err.max()) < 5e-3, err


# ---- on the card ------------------------------------------------------------------------
def card_operands(device, Kc=4096, Hc=50, members=4):
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": str(device), "optimizer": "rpgd-tf",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name="rpgd-tf",
                   predictor_specification=f"ensemble:{ENS_NET}:{ENS_MEMBERS}:{ASSETS}",
                   optimizer_config=rpgd_config(num_rollouts=Kc, mpc_horizon=Hc),
                   cost_function_config=COST_WEIGHTS)
    model, pack = ensemble.net_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    gen = torch.Generator(device=device).manual_seed(0)
    s0 = 0.05 * torch.randn(Kc, 4, generator=gen, device=device)
    Q = torch.clamp(0.3 * torch.randn(Kc, Hc, 1, generator=gen, device=device), -1.0, 1.0)
    net = {k: v[:members].contiguous() for k, v in params["dyn"]["net"].items()}
    return model, s0, Q, pack(params, torch.tensor([0.1], device=device)), net


@pytest.mark.cuda
@pytest.mark.parametrize("Kc,members", [(4096, 4), (1200, 4), (512, 1)])
def test_cuda_ens_forms_match_plain_and_the_single_net_kernels(cuda_device, Kc, members):
    torch.backends.cuda.matmul.allow_tf32 = False
    model, s0, Q, pvec, net = card_operands(cuda_device, Kc, members=members)
    before = (neural_cost_rollout_ens.launches, neural_grad_cost_rollout_ens.launches)
    cost = neural_cost_rollout_ens(model, s0, Q, pvec, net)
    gcost, dQ = neural_grad_cost_rollout_ens(model, s0, Q, pvec, net)
    assert (neural_cost_rollout_ens.launches, neural_grad_cost_rollout_ens.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = neural_cost_rollout_ens_plain(model, s0, Q, pvec, net)
    ref_cost, ref_dQ = neural_grad_cost_rollout_ens_plain(model, s0, Q, pvec, net)
    torch.testing.assert_close(cost, ref, rtol=5e-5, atol=1e-3)
    torch.testing.assert_close(gcost, ref_cost, rtol=5e-5, atol=1e-3)
    torch.testing.assert_close(dQ, ref_dQ, rtol=2e-5, atol=5e-6 * float(ref_dQ.abs().max()))
    per = Kc // members
    for e in range(members):
        rows = slice(e * per, (e + 1) * per)
        one = {k: v[e].contiguous() for k, v in net.items()}
        assert torch.equal(cost[rows], neural_cost_rollout(model, s0[rows].contiguous(),
                                                           Q[rows].contiguous(), pvec, one))
        c, d = neural_grad_cost_rollout(model, s0[rows].contiguous(), Q[rows].contiguous(), pvec,
                                        one)
        assert torch.equal(gcost[rows], c) and torch.equal(dQ[rows], d)


@pytest.mark.cuda
def test_cuda_ensemble_controllers_run_the_forms(cuda_device):
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": str(cuda_device), "optimizer": "rpgd-tf",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name="rpgd-tf",
                   predictor_specification=f"ensemble:{ENS_NET}:{ENS_MEMBERS}:{ASSETS}",
                   optimizer_config=rpgd_config(num_rollouts=1024, mpc_horizon=20),
                   cost_function_config=COST_WEIGHTS)
    before = (neural_cost_rollout_ens.launches, neural_grad_cost_rollout_ens.launches)
    u = ctrl.step(np.array([0.0, 0.0, 0.1, 0.0], np.float32))
    assert np.all(np.isfinite(u))
    assert (neural_cost_rollout_ens.launches - before[0],
            neural_grad_cost_rollout_ens.launches - before[1]) == (1, 2)


def jax_mppi_loop(seeds=(3, 0), ticks: int = 200) -> list:
    """The JAX package's MPPI over the committed ensemble at chip_smoke.py's
    configuration (bench_scale.py:499's: K=16384, H=50, SQRTRHOINV 0.05,
    inducing period 10) from the port's ``CartpoleEnv(seed=0)`` start, the
    run chip_smoke.py's phase 51 makes on the card: for each optimizer seed,
    the largest |angle| and the tick the pole passed 0.5 rad (None: it
    stayed up).  K=16384: minutes on a CPU."""
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
    from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv

    start = CartpoleEnv(batch_size=1, dt=0.02, seed=0).reset()[0][0]
    out = []
    for seed in seeds:
        ctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.0},
                      config={"optimizer": "mppi", "controller_logging": False})
        ctrl.configure(optimizer_name="mppi",
                       predictor_specification=f"ensemble:{ENS_NET}:{ENS_MEMBERS}:{ASSETS}",
                       optimizer_config={"seed": seed, "mpc_timestep": 0.02, "mpc_horizon": 50,
                                         "num_rollouts": 16384, "cc_weight": 1.0, "R": 1.0,
                                         "LBD": 100.0, "NU": 1000.0, "SQRTRHOINV": 0.05,
                                         "period_interpolation_inducing_points": 10})
        env = JaxCartpoleEnv(batch_size=1, dt=0.02, seed=0)
        env.reset()
        env.state = jnp.asarray(start[None])
        s, max_angle, fell_at = start[None].copy(), 0.0, None
        for t in range(ticks):
            s, *_ = env.step(ctrl.step(s[0]))
            s = np.asarray(s)
            max_angle = max(max_angle, abs(float(s[0, 2])))
            if fell_at is None and max_angle >= 0.5:
                fell_at = t
        out.append({"seed": seed, "max_abs_angle": max_angle, "fell_at_tick": fell_at})
    return out


if __name__ == "__main__":
    import sys

    if "--loop" in sys.argv[1:]:
        print(jax_mppi_loop())
    else:
        print({"member_normalized_mse": make_assets().tolist()})
