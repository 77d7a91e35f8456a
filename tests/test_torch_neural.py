"""The torch port's learned-dynamics path against the JAX package: the
networks, the NeuralPredictor, K11's and K13's plain versions
(``ops/neural_rollout.py``) against the JAX package's Pallas kernels in
interpret mode, one MPPI update over an MLP and over a GRU, the stateful
closed loop, the kernel-family gates, the committed nets, K11's and K13's
tensor-core arithmetic emulated on the CPU against the bounds the card's
kernels are held to, and — on a machine with a card only — each CUDA
kernel against its plain version.

Both packages get the same weights (JAX's, written with the JAX
``save_net`` and loaded by each package's predictor) and the same inputs
and noise, made with numpy from a seed or drawn from the JAX key.

    PYTHONPATH=. python tests/test_torch_neural.py

from the repository's root regenerates the committed nets
(``make_assets``);

    PYTHONPATH=. python tests/test_torch_neural.py --starts

runs the JAX package's MPPI over the committed MLP from the start states
of ``chip_smoke.py --starts`` (``jax_start_sweep``).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.models import networks as jnets
from control_toolkit_tpu.models.neural_predictor import NeuralPredictor as JaxNeural
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.models import networks as nets
from control_toolkit_tpu_torch.models.neural_predictor import NeuralPredictor
from control_toolkit_tpu_torch.ops.neural_rollout import (
    mlp_layer_count, neural_cost_rollout, neural_cost_rollout_plain, plain_cost_loop,
    recurrent_cost_rollout, recurrent_cost_rollout_plain,
)
from control_toolkit_tpu_torch.optimizers.kernel_families import neural, ode
from control_toolkit_tpu_torch.utils.convert import (
    neural_params_from_numpy, params_from_numpy,
)
from test_torch_mppi import (
    CPU, LIMITS, UNOM_TOL, jax_next_draw, jax_params_numpy, optimizer_config, port_noise,
    set_shared_state,
)

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "control_toolkit_tpu_torch" / "assets" / "cartpole"
MLP_ASSET, GRU_ASSET = "mlp-64-64", "GRU-5IN-32H1-32H2-4OUT"
GRU_EPISODES, GRU_EPISODE_LEN = 256, 40


def random_episodes(n: int, length: int, seed: int = 0):
    """``n`` cartpole episodes of ``length`` uniform random controls from
    the JAX environment's upright start: states [n, length+1, 4], controls
    [n, length, 1]."""
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv

    env = JaxCartpoleEnv(batch_size=n, dt=0.02, seed=seed)
    rng = np.random.default_rng(seed)
    s, _ = env.reset(seed=seed)
    xs, us = [np.asarray(s).copy()], []
    for _ in range(length):
        u = rng.uniform(-1.0, 1.0, (n, 1)).astype(np.float32)
        s, *_ = env.step(u)
        xs.append(np.asarray(s).copy())
        us.append(u)
    return np.stack(xs, axis=1).astype(np.float32), np.stack(us, axis=1)


def make_assets(out_dir: Path = ASSETS) -> dict:
    """Fit the committed nets with the JAX package and save them with its
    ``save_net`` (``meta={"predict_delta": true}``):

    - ``mlp-64-64``: ``fit_mlp_dynamics(hiddens=(64, 64), epochs=3000,
      batch_size=4096, learning_rate=3e-3, seed=0)`` on
      ``collect_transitions(CartpoleEnv(16, seed=0), 400, seed=0)``;
    - ``GRU-5IN-32H1-32H2-4OUT``: ``fit_gru_dynamics(hiddens=(32, 32),
      epochs=1500, seed=0)`` on 256 random 40-step episodes
      (``random_episodes``).

    Returns the fits' losses."""
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
    from control_toolkit_tpu.models.training import (
        collect_transitions, fit_gru_dynamics, fit_mlp_dynamics,
    )

    out_dir.mkdir(parents=True, exist_ok=True)
    x, u, xn = collect_transitions(JaxCartpoleEnv(batch_size=16, dt=0.02, seed=0), 400, seed=0)
    mlp, mse = fit_mlp_dynamics(x, u, xn, hiddens=(64, 64), epochs=3000, batch_size=4096,
                                learning_rate=3e-3, seed=0)
    jnets.save_net(out_dir / f"{MLP_ASSET}.npz", mlp, meta={"predict_delta": True})
    xs, us = random_episodes(GRU_EPISODES, GRU_EPISODE_LEN)
    gru, loss = fit_gru_dynamics(xs, us, hiddens=(32, 32), epochs=1500, seed=0)
    jnets.save_net(out_dir / f"{GRU_ASSET}.npz", gru, meta={"predict_delta": True})
    return {"mlp_normalized_mse": mse, "gru_rollout_loss": loss}


# Costs: float32 sums over 10 steps of a net whose matmuls the two
# packages sum in different orders (the JAX neural kernel test's bounds,
# test_pallas_neural.py:60-61).
COST_TOL = dict(rtol=1e-4, atol=1e-4)
# One network evaluation: float32 matmuls of width <= 16 summed in
# different orders.
NET_TOL = dict(rtol=1e-5, atol=1e-6)
K, H = 128, 10
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_net(name: str, seed: int = 0, norms: bool = False) -> dict:
    """A JAX-initialised net of architecture ``name`` on cartpole (5 in, 4
    out) as numpy arrays; ``norms`` adds checkpoint-style statistics."""
    arch = jnets.parse_net_name(name)
    key = jax.random.PRNGKey(seed)
    if arch["kind"] == "mlp":
        net = jnets.mlp_init(key, [5] + arch["hiddens"] + [4])
    else:
        net = jnets.RECURRENT_FNS[arch["kind"]][0](key, 5, arch["hiddens"], 4)
    net = jax.tree_util.tree_map(np.asarray, net)
    if norms:
        rng = np.random.default_rng(seed + 100)
        net.update(norm_in_mean=(0.1 * rng.standard_normal(5)).astype(np.float32),
                   norm_in_std=rng.uniform(0.8, 1.5, 5).astype(np.float32),
                   norm_out_mean=np.full(4, 0.02, np.float32),
                   norm_out_std=rng.uniform(0.5, 1.0, 4).astype(np.float32))
    return net


def make_pair(tmp_path, name, net, optimizer="mppi", config=None, predict_delta=True,
              jax_logging=False):
    """The JAX and the port controller over one checkpoint of ``net``,
    written by the JAX ``save_net`` under ``tmp_path``."""
    jnets.save_net(tmp_path / f"{name}.npz", net, meta={"predict_delta": predict_delta})
    spec = f"neural:{name}:{tmp_path}"
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


def set_hidden(jctrl, pctrl, seed):
    """Both recurrent predictors at one nonzero live hidden."""
    jpred, ppred = jctrl.optimizer.predictor.predictor, pctrl.optimizer.predictor.predictor
    rng = np.random.default_rng(seed)
    hidden = tuple((0.3 * rng.standard_normal(np.shape(h))).astype(np.float32)
                   for h in jpred.hidden)
    jpred.hidden = tuple(jnp.asarray(h) for h in hidden)
    ppred.hidden = tuple(torch.tensor(h) for h in hidden)


# ---- networks -----------------------------------------------------------------
@pytest.mark.parametrize("name", ["mlp-16-8", "GRU-5IN-16H1-8H2-4OUT", "LSTM-5IN-16H1-8H2-4OUT"])
def test_networks_match_jax(name):
    net = jax_net(name, seed=1)
    pnet = neural_params_from_numpy(net)["net"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    kind = jnets.parse_net_name(name)["kind"]
    if kind == "mlp":
        np.testing.assert_allclose(nets.mlp_apply(pnet, torch.tensor(x)).numpy(),
                                   np.asarray(jnets.mlp_apply(net, jnp.asarray(x))), **NET_TOL)
        return
    width = 1 if kind == "gru" else 2
    hs = tuple(rng.standard_normal((8, width * h)).astype(np.float32)
               for h in jnets.parse_net_name(name)["hiddens"])
    out, new = nets.RECURRENT_FNS[kind][1](pnet, torch.tensor(x), tuple(map(torch.tensor, hs)))
    jout, jnew = jnets.RECURRENT_FNS[kind][1](net, jnp.asarray(x), tuple(map(jnp.asarray, hs)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **NET_TOL)
    for a, b in zip(new, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **NET_TOL)
    state0 = nets.RECURRENT_FNS[kind][2]([16, 8], 3)
    assert [tuple(h.shape) for h in state0] == [h.shape for h in
                                                 jnets.RECURRENT_FNS[kind][2]([16, 8], 3)]


def test_parse_net_name_matches_jax():
    for name in ("mlp-32-32", "mlp-16", "mlp", "GRU-6IN-32H1-32H2-5OUT-0",
                 "GRU-5IN-16H1-4OUT", "LSTM-5IN-16H1-7H2-4OUT", "gru"):
        assert nets.parse_net_name(name) == jnets.parse_net_name(name), name
    for parse in (nets.parse_net_name, jnets.parse_net_name):
        with pytest.raises(ValueError):
            parse("transformer-8")


def test_initializers_keep_jax_scales():
    gen = torch.Generator().manual_seed(0)
    mlp = nets.mlp_init(gen, [5, 64, 4])
    assert abs(float(mlp["w0"].std()) - np.sqrt(2.0 / 69)) < 0.03 and not mlp["b0"].any()
    lstm = nets.lstm_init(gen, 5, [16], 4)
    assert lstm["cell0"]["bi"][16:32].eq(1.0).all() and lstm["cell0"]["bi"][:16].eq(0.0).all()
    assert tuple(lstm["cell0"]["wh"].shape) == (16, 64) and tuple(lstm["wo"].shape) == (16, 4)


def test_npz_round_trip_both_ways(tmp_path):
    net = jax_net("GRU-5IN-8H1-4OUT", seed=3)
    jnets.save_net(tmp_path / "from_jax.npz", net, meta={"predict_delta": False})
    loaded, meta = nets.load_net(tmp_path / "from_jax.npz")
    assert meta == {"predict_delta": False}
    nets.save_net(tmp_path / "from_port.npz", loaded, meta={"predict_delta": True, "tag": "x"})
    back, jmeta = jnets.load_net(tmp_path / "from_port.npz")
    assert jmeta == {"predict_delta": True, "tag": "x"}
    for path, leaf in jax.tree_util.tree_flatten_with_path(net)[0]:
        keys = [p.key for p in path]
        port_leaf, jax_leaf = loaded, back
        for k in keys:
            port_leaf, jax_leaf = port_leaf[k], jax_leaf[k]
        np.testing.assert_array_equal(port_leaf.numpy(), leaf)
        np.testing.assert_array_equal(np.asarray(jax_leaf), leaf)


# ---- the predictor -----------------------------------------------------------
@pytest.mark.parametrize("name,norms,delta", [
    ("mlp-16-16", True, True),
    ("mlp-16-16", False, False),
    ("GRU-5IN-16H1-8H2-4OUT", False, True),
    ("LSTM-5IN-16H1-4OUT", False, True),
])
def test_predictor_rollout_and_update_match_jax(name, norms, delta):
    net = jax_net(name, seed=4, norms=norms)
    jpred = JaxNeural(net_name=name, params=jax.tree_util.tree_map(jnp.asarray, net),
                      predict_delta=delta)
    ppred = NeuralPredictor(device="cpu", net_name=name,
                            params=neural_params_from_numpy(net)["net"], predict_delta=delta)
    assert ppred.is_stateful == jpred.is_stateful == ppred.recurrent
    rng = np.random.default_rng(5)
    s0 = (0.1 * rng.standard_normal((6, 4))).astype(np.float32)
    Q = rng.uniform(-1.0, 1.0, (6, H, 1)).astype(np.float32)
    for tick in range(3):
        traj = ppred.rollout(torch.tensor(s0), torch.tensor(Q))
        jtraj = jpred.rollout(jnp.asarray(s0), jnp.asarray(Q), jpred.default_params())
        np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=1e-4, atol=1e-5)
        s, u = s0[tick:tick + 1], Q[tick:tick + 1, :1, :]
        ppred.update(torch.tensor(s), torch.tensor(u))
        jpred.update(jnp.asarray(s), jnp.asarray(u))
        if ppred.recurrent:
            for a, b in zip(ppred.hidden, jpred.hidden):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **NET_TOL)
    if ppred.recurrent:
        copy = ppred.copy()
        assert all(a is b for a, b in zip(copy.hidden, ppred.hidden))
        ppred.reset_state()
        assert all(not h.any() for h in ppred.hidden)


def test_predictor_loads_the_checkpoint_and_its_meta(tmp_path):
    jnets.save_net(tmp_path / "mlp-8.npz", jax_net("mlp-8"), meta={"predict_delta": False})
    pred = NeuralPredictor(device="cpu", net_name="mlp-8", path_to_models=str(tmp_path))
    assert not pred.predict_delta and tuple(pred.net_params["w0"].shape) == (5, 8)
    assert pred.net_params["w0"].dtype == torch.float32
    random_init = NeuralPredictor(device="cpu", net_name="mlp-8",
                                  path_to_models=str(tmp_path / "none"))
    assert random_init.predict_delta and not torch.equal(random_init.net_params["w0"],
                                                         pred.net_params["w0"])
    with pytest.raises(ValueError):
        NeuralPredictor(device="cpu", net_name="mlp-8", compute_dtype="float16")


# ---- K11 and K13 against the Pallas kernels --------------------------------------
@pytest.mark.parametrize("name,norms,delta", [
    ("mlp-16-16", False, True),
    ("mlp-16-16", True, False),
    ("GRU-5IN-16H1-8H2-4OUT", False, True),
    ("LSTM-5IN-16H1-4OUT", False, True),
])
def test_k11_k13_plain_match_pallas_interpret(tmp_path, name, norms, delta):
    jctrl, pctrl = make_pair(tmp_path, name, jax_net(name, seed=6, norms=norms),
                             predict_delta=delta)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    recurrent = popt.predictor.predictor.recurrent
    if recurrent:
        set_hidden(jctrl, pctrl, seed=7)
    assert neural.can_use_cost(popt) and not ode.can_use_cost(popt)
    rng = np.random.default_rng(8)
    s_tiled = np.tile(np.array([[0.1, -0.2, 0.3, 0.05]], np.float32), (K, 1))
    Q = rng.uniform(-1.0, 1.0, (K, H, 1)).astype(np.float32)
    u_prev = np.array([0.25], np.float32)
    jparams = jctrl._assemble_params()
    pallas = jopt._build_pallas_neural_cost(interpret=True, tile_k=64)
    ref = np.asarray(pallas(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev), jparams))
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    assert ("hidden" in params["dyn"]) == recurrent
    wrapper = recurrent_cost_rollout if recurrent else neural_cost_rollout
    before = wrapper.launches
    got = popt._make_cost_only()(torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev),
                                 params)
    assert wrapper.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), ref, **COST_TOL)


def test_a_new_net_or_hidden_reaches_the_next_call_without_rebuild(tmp_path):
    for name in ("mlp-8", "GRU-5IN-8H1-4OUT"):
        _, pctrl = make_pair(tmp_path, name, jax_net(name, seed=9))
        popt, pred = pctrl.optimizer, pctrl.optimizer.predictor.predictor
        cost_fn, epoch = popt._make_cost_only(), popt._build_epoch
        s = torch.tensor([[0.1, 0.0, 0.2, 0.0]]).expand(K, 4)
        Q = torch.full((K, H, 1), 0.3)
        u_prev = torch.tensor([0.0])
        first = cost_fn(s, Q, u_prev, pctrl._assemble_params())
        key = "w0" if name.startswith("mlp") else "wo"
        pred.net_params = {**pred.net_params, key: 1.5 * pred.net_params[key]}
        params = pctrl._assemble_params()
        assert params["dyn"]["net"][key] is pred.net_params[key]
        swapped = cost_fn(s, Q, u_prev, params)
        assert not torch.allclose(first, swapped)
        model, _ = neural.net_model(popt)
        pvec = popt._soa_bindings(include_dyn=False)[1](params, u_prev)
        ref = (neural_cost_rollout_plain(model, s, Q, pvec, params["dyn"]["net"])
               if pred.arch["kind"] == "mlp" else
               recurrent_cost_rollout_plain(model, s, Q, pvec, params["dyn"]["net"],
                                            params["dyn"]["hidden"]))
        torch.testing.assert_close(swapped, ref)
        if pred.recurrent:
            pred.update(torch.tensor([[0.5, 0.1, -0.4, 0.2]]), torch.tensor([[[0.9]]]))
            params = pctrl._assemble_params()
            assert params["dyn"]["hidden"] is pred.hidden
            assert not torch.allclose(cost_fn(s, Q, u_prev, params), swapped)
        assert popt._build_epoch == epoch


# ---- one MPPI update ------------------------------------------------------------
@pytest.mark.parametrize("name,norms", [("mlp-16-16", True), ("GRU-5IN-16H1-4OUT", False)])
def test_one_mppi_update_matches_jax(tmp_path, name, norms):
    jctrl, pctrl = make_pair(tmp_path, name, jax_net(name, seed=10, norms=norms))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert not popt._uses_semi_fused()  # the semi-fused K2 takes an ODE only
    set_shared_state(jopt, popt)
    if popt.predictor.predictor.recurrent:
        set_hidden(jctrl, pctrl, seed=11)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    delta = jax_next_draw(jopt)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)  # the hidden before the step
    u_jax = jctrl.step(s)
    u, state, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params,
                                 port_noise(popt, delta))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


@pytest.mark.parametrize("name,norms", [("mlp-16-16", True), ("GRU-5IN-16H1-4OUT", False)])
def test_learned_controller_ticks_match_jax(tmp_path, name, norms):
    """A few ticks through both controllers' step(), each fed the same state
    and the same noise; the plans, and a GRU's hidden, carry over."""
    jctrl, pctrl = make_pair(tmp_path, name, jax_net(name, seed=15, norms=norms))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    rng = np.random.default_rng(16)
    for _ in range(4):
        s = (0.05 * rng.standard_normal(4)).astype(np.float32)
        eps = port_noise(popt, jax_next_draw(jopt))
        popt.sample_noise = lambda state, eps=eps: eps
        np.testing.assert_allclose(pctrl.step(s), jctrl.step(s), **UNOM_TOL)
        np.testing.assert_allclose(popt.opt_state.u_nom.numpy(), np.asarray(jopt.opt_state.u_nom),
                                   **UNOM_TOL)
    if popt.predictor.is_stateful:
        for a, b in zip(popt.predictor.predictor.hidden, jopt.predictor.predictor.hidden):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **NET_TOL)


# ---- the stateful closed loop ----------------------------------------------------
def test_gru_closed_loop_advances_and_resets_the_hidden(tmp_path, monkeypatch):
    """Each tick advances the live hidden with the applied control (a CPU
    replay of gru_apply agrees); a non-finite control commands zero, resets
    the hidden and advances it from zero with that zero."""
    name = "GRU-5IN-8H1-8H2-4OUT"
    _, pctrl = make_pair(tmp_path, name, jax_net(name, seed=12),
                         config=optimizer_config(64, 8))
    popt, pred = pctrl.optimizer, pctrl.optimizer.predictor.predictor
    net = pred.net_params
    hidden = nets.gru_init_state([8, 8], 1)
    rng = np.random.default_rng(13)
    for _ in range(4):
        s = (0.05 * rng.standard_normal(4)).astype(np.float32)
        u = pctrl.step(s)
        _, hidden = nets.gru_apply(net, torch.cat([torch.tensor(s)[None], torch.tensor(u)[None]], 1),
                                   hidden)
        for a, b in zip(pred.hidden, hidden):
            torch.testing.assert_close(a, b)
    assert float(pred.hidden[0].abs().sum()) > 0.0
    monkeypatch.setattr(popt, "sample_noise",
                        lambda state: torch.full(popt._noise_shape, float("nan")))
    s = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    u = pctrl.step(s)
    np.testing.assert_array_equal(u, np.zeros(1, np.float32))
    _, from_zero = nets.gru_apply(net, torch.tensor([[0.0, 0.0, 0.1, 0.0, 0.0]]),
                                  nets.gru_init_state([8, 8], 1))
    for a, b in zip(pred.hidden, from_zero):
        torch.testing.assert_close(a, b)


# ---- the gates -------------------------------------------------------------------
def test_kernel_family_gates(tmp_path):
    _, ode_ctrl = make_pair(tmp_path, "mlp-8", jax_net("mlp-8"))
    ode_pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                              config={"device": "cpu",
                                      "optimizer": "mppi", "controller_logging": False})
    ode_pctrl.configure(optimizer_name="mppi", optimizer_config=optimizer_config(32, 8))
    mlp_opt = ode_ctrl.optimizer
    assert ode.can_use_cost(ode_pctrl.optimizer) and not neural.can_use_cost(ode_pctrl.optimizer)
    assert neural.can_use_cost(mlp_opt) and not ode.can_use_cost(mlp_opt)
    assert neural.can_use_grad(mlp_opt) and not ode.can_use_grad(mlp_opt)
    _, gru_ctrl = make_pair(tmp_path, "GRU-5IN-8H1-4OUT", jax_net("GRU-5IN-8H1-4OUT"))
    assert neural.can_use_cost(gru_ctrl.optimizer) and not neural.can_use_grad(gru_ctrl.optimizer)
    for spec_tail, extra in ((":bf16", {}), ("", {"force_scan": True})):
        pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                              config={"device": "cpu",
                                      "optimizer": "mppi", "controller_logging": False})
        pctrl.configure(optimizer_name="mppi",
                        predictor_specification=f"neural:mlp-8:{tmp_path}{spec_tail}",
                        optimizer_config=optimizer_config(32, 8, **extra))
        assert not neural.can_use_cost(pctrl.optimizer)
        assert pctrl.optimizer._make_cost_only() == pctrl.optimizer._fused_cost


def test_wrappers_never_run_plain_versions_on_non_cpu_tensors(tmp_path):
    _, pctrl = make_pair(tmp_path, "mlp-8", jax_net("mlp-8"))
    model, _ = neural.net_model(pctrl.optimizer)
    net = pctrl._assemble_params()["dyn"]["net"]
    meta = dict(device="meta")
    before = neural_cost_rollout.launches
    with pytest.raises(ValueError, match="several devices"):
        neural_cost_rollout(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
                            torch.empty(8, **meta), net)
    meta_net = {k: torch.empty(v.shape, **meta) for k, v in net.items()}
    with pytest.raises(ValueError, match="CUDA"):
        neural_cost_rollout(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
                            torch.empty(8, **meta), meta_net)
    assert neural_cost_rollout.launches == before
    _, gctrl = make_pair(tmp_path, "GRU-5IN-8H1-4OUT", jax_net("GRU-5IN-8H1-4OUT"))
    gmodel, _ = neural.net_model(gctrl.optimizer)
    dyn = gctrl._assemble_params()["dyn"]
    with pytest.raises(ValueError, match="several devices"):
        recurrent_cost_rollout(gmodel, torch.zeros(8, 4), torch.zeros(8, 5, 1), torch.zeros(8),
                               dyn["net"], tuple(torch.empty(h.shape, **meta)
                                                 for h in dyn["hidden"]))
    with pytest.raises(ValueError, match="MLP"):
        neural_cost_rollout(gmodel, torch.zeros(8, 4), torch.zeros(8, 5, 1), torch.zeros(8),
                            dyn["net"])


def test_net_model_checks_the_layout_and_the_net(tmp_path):
    _, pctrl = make_pair(tmp_path, "mlp-8", jax_net("mlp-8"))
    model, _ = neural.net_model(pctrl.optimizer)
    from control_toolkit_tpu_torch.ops import kernels

    assert model.param_keys == kernels.COST_PARAM_KEYS["cartpole"]
    assert kernels.PLANT_PARAM_KEYS["cartpole"][len(kernels.DYN_PARAM_KEYS["cartpole"]):] \
        == model.param_keys
    import dataclasses

    with pytest.raises(ValueError, match="layout"):
        dataclasses.replace(model, param_keys=kernels.PLANT_PARAM_KEYS["cartpole"])
    net = pctrl._assemble_params()["dyn"]["net"]
    args, tensors = model.net_args(net)
    assert list(args.dims)[:3] == [5, 8, 4] and args.n_layers == 2 and set(tensors) == set(net)
    with pytest.raises(ValueError, match="b0"):
        model.net_args({**net, "w0": net["w0"][:, :7]})
    with pytest.raises(ValueError, match="output width"):
        model.net_args({**net, "w1": net["w1"][:, :3]})


# ---- the committed nets ------------------------------------------------------------
def test_committed_assets_are_what_the_generator_documents():
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
    from control_toolkit_tpu.models.training import collect_transitions

    shapes = {
        MLP_ASSET: {"w0": (5, 64), "b0": (64,), "w1": (64, 64), "b1": (64,), "w2": (64, 4),
                    "b2": (4,), "norm_in_mean": (5,), "norm_in_std": (5,),
                    "norm_out_mean": (4,), "norm_out_std": (4,)},
        GRU_ASSET: {"cell0/wi": (5, 96), "cell0/wh": (32, 96), "cell0/bi": (96,),
                    "cell0/bh": (96,), "cell1/wi": (32, 96), "cell1/wh": (32, 96),
                    "cell1/bi": (96,), "cell1/bh": (96,), "wo": (32, 4), "bo": (4,)},
    }
    for name, expected in shapes.items():
        path = ASSETS / f"{name}.npz"
        with np.load(path) as data:
            assert {k: data[k].shape for k in data.files if k != "__meta"} == expected
            assert all(data[k].dtype == np.float32 for k in expected)
        jnet, jmeta = jnets.load_net(path)
        pnet, pmeta = nets.load_net(path)
        assert jmeta == pmeta == {"predict_delta": True}
        for key in expected:
            node_j, node_p = jnet, pnet
            for part in key.split("/"):
                node_j, node_p = node_j[part], node_p[part]
            np.testing.assert_array_equal(node_p.numpy(), np.asarray(node_j))
    # The MLP's one-step error on fresh transitions, normalized as its fit
    # (training.py fit_mlp_dynamics) normalizes it.
    jpred = JaxNeural(net_name=MLP_ASSET, path_to_models=str(ASSETS))
    x, u, xn = collect_transitions(JaxCartpoleEnv(batch_size=16, dt=0.02, seed=7), 100, seed=7)
    step = jpred.single_step
    pred = np.asarray(step(jnp.asarray(x), jnp.asarray(u), jpred.default_params()))
    std = np.asarray(jpred.net_params["norm_out_std"])
    err = float(np.mean(((pred - xn) / std) ** 2))
    assert err < 3e-4, err


# ---- K13's bound and its tensor-core arithmetic, on the CPU --------------------------
def recurrent_problem(spec: str, K_: int = 256, H_: int = 50):
    """chip_smoke.py phase 13's operands at K_ rollouts on the CPU: the net
    of ``spec`` from the hidden that ten of its predictor's updates reach,
    s0 0.05 N(0, 1) and Q 0.3 N(0, 1) clipped to [-1, 1] (numpy, seed 13)."""
    from chip_smoke import OPTIMIZER_CONFIG, make_controller

    ctrl = make_controller("cpu", spec=spec,
                           config={**OPTIMIZER_CONFIG, "num_rollouts": K_, "mpc_horizon": H_})
    pred = ctrl.optimizer.predictor.predictor
    rng = np.random.default_rng(13)
    for _ in range(10):
        pred.update(torch.tensor(0.05 * rng.standard_normal((1, 4)), dtype=torch.float32),
                    torch.tensor(np.clip(0.3 * rng.standard_normal((1, 1, 1)), -1, 1),
                                 dtype=torch.float32))
    model, pack = neural.net_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    s0 = torch.tensor(0.05 * rng.standard_normal((K_, 4)), dtype=torch.float32)
    Q = torch.tensor(np.clip(0.3 * rng.standard_normal((K_, H_, 1)), -1, 1), dtype=torch.float32)
    return (model, s0, Q, pack(params, torch.tensor([0.1])), params["dyn"]["net"],
            params["dyn"]["hidden"])


RECURRENT_SPECS = [f"neural:{GRU_ASSET}:{ASSETS}", "neural:LSTM-5IN-32H1-32H2-4OUT"]


@pytest.mark.parametrize("spec", RECURRENT_SPECS)
def test_recurrent_mutants_are_rejected_by_k13_bound(spec, record_property):
    """chip_smoke.py phase 13's wrong K13s — a zero hidden, the first two
    gates swapped, the last cell's second gate's input bias dropped (the
    subtlest dropped bias over the committed GRU; the forget gate's, the
    only nonzero bias of a seeded LSTM) — each moves the plain version's
    costs beyond RNN_TOL."""
    from chip_smoke import RNN_TOL, recurrent_mutants

    model, s0, Q, pvec, net, hidden = recurrent_problem(spec)
    ref = recurrent_cost_rollout_plain(model, s0, Q, pvec, net, hidden)
    rel = {}
    for name, (n, h) in recurrent_mutants(net, hidden, model.kind).items():
        got = recurrent_cost_rollout_plain(model, s0, Q, pvec, n, h)
        rel[name] = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
        assert not torch.allclose(got, ref, **RNN_TOL), (name, rel[name])
    record_property("k13_mutant_max_rel_err", rel)
    assert any(name.endswith("_input_bias_dropped") for name in rel)


def mm_3xtf32_partials(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` as csrc/rnn_mma.cuh computes a gate's (or the head's)
    product: per 8-block of the inner dimension, a_lo w_hi, then a_hi w_lo,
    then a_hi w_hi into a partial sum from zero (a_lo w_lo dropped), each
    partial added to the FP32 sum in k order."""
    from test_torch_neural_grad import split_tf32

    (ahi, alo), (whi, wlo) = split_tf32(a), split_tf32(w)
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        blk = slice(k0, k0 + 8)
        part = alo[:, blk] @ whi[blk]
        part = part + ahi[:, blk] @ wlo[blk]
        acc = acc + (part + ahi[:, blk] @ whi[blk])
    return acc


def recurrent_cost_with(mm, model, s0, Q, pvec, net, hidden):
    """K13's costs with ``mm`` for every product, in csrc/rnn_mma.cuh's
    order: each gate's input and recurrent products apart, the biases added
    as the plain cells add them, then the head."""
    n = sum(1 for k in net if k.startswith("cell"))
    hs = [h.expand(s0.shape[0], h.shape[-1]) for h in hidden]

    def step(x, u):
        inp = torch.cat([x, u], dim=1)
        for i in range(n):
            cell, hd = net[f"cell{i}"], net[f"cell{i}"]["wh"].shape[0]
            h = hs[i][:, :hd]
            g = [mm(inp, cell["wi"]) + cell["bi"], mm(h, cell["wh"])]
            if model.kind == "gru":
                gh = g[1] + cell["bh"]
                r = torch.sigmoid(g[0][:, :hd] + gh[:, :hd])
                z = torch.sigmoid(g[0][:, hd:2 * hd] + gh[:, hd:2 * hd])
                nn = torch.tanh(g[0][:, 2 * hd:] + r * gh[:, 2 * hd:])
                inp = hs[i] = (1.0 - z) * nn + z * h
            else:
                gates = (g[0] + g[1]) + cell["bh"]
                c = (torch.sigmoid(gates[:, hd:2 * hd]) * hs[i][:, hd:]
                     + torch.sigmoid(gates[:, :hd]) * torch.tanh(gates[:, 2 * hd:3 * hd]))
                inp = torch.sigmoid(gates[:, 3 * hd:]) * torch.tanh(c)
                hs[i] = torch.cat([inp, c], dim=1)
        out = mm(inp, net["wo"]) + net["bo"]
        return x + out if model.predict_delta else out

    return plain_cost_loop(model, s0, Q, pvec, step)


@pytest.mark.parametrize("spec", RECURRENT_SPECS)
def test_k13_3xtf32_arithmetic_stays_within_the_kernel_bound(spec, record_property):
    """K13's products in 3xTF32 with a partial sum a k-block (every gate's
    input and recurrent product and the head), emulated over chip_smoke.py
    phase 13's nets at K=256, H=50, stay within RNN_TOL of the FP32 plain
    version; one-pass TF32's distance is recorded beside it."""
    from chip_smoke import RNN_TOL
    from test_torch_neural_grad import mm_tf32

    model, s0, Q, pvec, net, hidden = recurrent_problem(spec)
    ref = recurrent_cost_rollout_plain(model, s0, Q, pvec, net, hidden)
    found = {}
    for name, mm in (("3xtf32", mm_3xtf32_partials), ("one_pass_tf32", mm_tf32)):
        got = recurrent_cost_with(mm, model, s0, Q, pvec, net, hidden)
        err = (got - ref).abs()
        found[name] = {"max_abs_err": float(err.max()),
                       "max_rel_err": float((err / ref.abs().clamp_min(1e-6)).max()),
                       "within_bound": torch.allclose(got, ref, **RNN_TOL)}
    # The emulation with FP32 products is the plain version's arithmetic.
    same = recurrent_cost_with(torch.matmul, model, s0, Q, pvec, net, hidden)
    found["fp32_max_abs_err"] = float((same - ref).abs().max())
    record_property("k13_tf32_distances", found)
    assert found["3xtf32"]["within_bound"], found
    torch.testing.assert_close(same, ref, rtol=1e-5, atol=1e-3)


# ---- K11's bound and its tensor-core arithmetic, on the CPU -------------------------
MLP_CASES = ["committed", "seeded_5-72-72-4"]


def mlp_problem(case: str, K_: int = 256, H_: int = 50):
    """chip_smoke.py phase 11's operands at K_ rollouts on the CPU: the MPPI
    controller over the committed mlp-64-64 (its cost, pvec and delta form)
    and the committed net, or chip_smoke.py's seeded 5-72-72-4 net with
    norms (``wide_net``); s0 0.05 N(0, 1) and Q 0.3 N(0, 1) clipped to
    [-1, 1] (numpy, seed 11)."""
    from chip_smoke import MLP_SPEC, OPTIMIZER_CONFIG, make_controller, wide_net

    ctrl = make_controller("cpu", spec=MLP_SPEC,
                           config={**OPTIMIZER_CONFIG, "num_rollouts": K_, "mpc_horizon": H_})
    model, pack = neural.net_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    net = params["dyn"]["net"] if case == "committed" else wide_net(True, 1.0, "cpu")
    rng = np.random.default_rng(11)
    s0 = torch.tensor(0.05 * rng.standard_normal((K_, 4)), dtype=torch.float32)
    Q = torch.tensor(np.clip(0.3 * rng.standard_normal((K_, H_, 1)), -1, 1), dtype=torch.float32)
    return model, s0, Q, pack(params, torch.tensor([0.1])), net


@pytest.mark.parametrize("case", MLP_CASES)
def test_mlp_mutants_are_rejected_by_k11_bound(case, record_property):
    """chip_smoke.py phase 11's wrong K11s — norm_out dropped, tanh on the
    last layer, and one unit tile of the last hidden layer lost (what a
    warp that skipped its tile would compute) — each moves the plain
    version's costs beyond NET_TOL."""
    from chip_smoke import NET_TOL, net_mutants

    model, s0, Q, pvec, net = mlp_problem(case)
    ref = neural_cost_rollout_plain(model, s0, Q, pvec, net)
    rel = {}
    for name, wrong in net_mutants(net).items():
        got = neural_cost_rollout_plain(model, s0, Q, pvec, wrong)
        rel[name] = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
        assert not torch.allclose(got, ref, **NET_TOL), (name, rel[name])
    record_property("k11_mutant_max_rel_err", rel)
    assert "last_hidden_unit_tile_lost" in rel


def mlp_cost_with(mm, model, s0, Q, pvec, net):
    """K11's costs with ``mm`` for every layer's product, in
    csrc/mlp_units.cuh's order: norm_in, each layer's product plus its bias
    (tanh on all but the last), norm_out, the delta add."""
    n = mlp_layer_count(net)

    def step(x, u):
        a = torch.cat([x, u], dim=1)
        if "norm_in_mean" in net:
            a = (a - net["norm_in_mean"]) / net["norm_in_std"]
        for i in range(n):
            a = mm(a, net[f"w{i}"]) + net[f"b{i}"]
            if i < n - 1:
                a = torch.tanh(a)
        if "norm_out_mean" in net:
            a = a * net["norm_out_std"] + net["norm_out_mean"]
        return x + a if model.predict_delta else a

    return plain_cost_loop(model, s0, Q, pvec, step)


@pytest.mark.parametrize("case", MLP_CASES)
def test_k11_3xtf32_arithmetic_stays_within_the_kernel_bound(case, record_property):
    """K11's products in 3xTF32 with a partial sum a k-block, added in k
    order (every hidden layer's unit tiles and the output's k-block slots),
    emulated over the committed mlp-64-64 and the seeded 5-72-72-4 net at
    K=256, H=50, stay within NET_TOL of the FP32 plain version; one-pass
    TF32's distance is recorded beside it."""
    from chip_smoke import NET_TOL
    from test_torch_neural_grad import mm_tf32

    model, s0, Q, pvec, net = mlp_problem(case)
    ref = neural_cost_rollout_plain(model, s0, Q, pvec, net)
    found = {}
    for name, mm in (("3xtf32", mm_3xtf32_partials), ("one_pass_tf32", mm_tf32)):
        got = mlp_cost_with(mm, model, s0, Q, pvec, net)
        err = (got - ref).abs()
        found[name] = {"max_abs_err": float(err.max()),
                       "max_rel_err": float((err / ref.abs().clamp_min(1e-6)).max()),
                       "within_bound": torch.allclose(got, ref, **NET_TOL)}
    # The emulation with FP32 products is the plain version's arithmetic.
    same = mlp_cost_with(torch.matmul, model, s0, Q, pvec, net)
    found["fp32_max_abs_err"] = float((same - ref).abs().max())
    record_property("k11_tf32_distances", found)
    assert found["3xtf32"]["within_bound"], found
    torch.testing.assert_close(same, ref, rtol=1e-5, atol=1e-3)


# ---- on the card ---------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Kc", [1000, 8])
@pytest.mark.parametrize("name,norms,delta", [
    (MLP_ASSET, None, True), ("mlp-13-6", True, False), ("mlp-13-13", True, True),
    ("mlp-72-72", True, True), ("mlp-40", True, True), (GRU_ASSET, None, True),
    ("GRU-5IN-13H1-6H2-4OUT", False, True),
    ("LSTM-5IN-32H1-32H2-4OUT", False, True),
])
def test_cuda_kernels_match_plain_versions(tmp_path, cuda_device, name, norms, delta, Kc):
    """K11 and K13 against their plain versions on the same card tensors,
    at K=1000 (not a multiple of a block's 16-rollout groups: the edge is
    masked) and K=8 (below one group), H=50, over MLPs of widths that are
    and are not multiples of 8 (K11's unit tiles) and wider than one
    group's four warps take one tile each.  Tolerance: the kernels sum each
    product in 3xTF32 a k-block at a time, the plain version through cuBLAS
    in full float32; over 50 steps of a trained net near upright the costs
    stay within float32 rounding of each other."""
    torch.backends.cuda.matmul.allow_tf32 = False
    path = ASSETS if norms is None else tmp_path
    if norms is not None:
        jnets.save_net(tmp_path / f"{name}.npz", jax_net(name, seed=14, norms=norms),
                       meta={"predict_delta": delta})
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": "mppi", "controller_logging": False,
                                 "device": "cuda"})
    ctrl.configure(optimizer_name="mppi", predictor_specification=f"neural:{name}:{path}",
                   optimizer_config=optimizer_config(Kc, 50), cost_function_config=COST_WEIGHTS)
    model, pack = neural.net_model(ctrl.optimizer)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    Hc = 50
    s0 = 0.05 * torch.randn(Kc, 4, generator=gen, device=cuda_device)
    Q = torch.clamp(0.3 * torch.randn(Kc, Hc, 1, generator=gen, device=cuda_device), -1.0, 1.0)
    params = ctrl._assemble_params()
    pvec = pack(params, torch.tensor([0.1], device=cuda_device))
    net = params["dyn"]["net"]
    if model.kind == "mlp":
        before = neural_cost_rollout.launches
        got = neural_cost_rollout(model, s0, Q, pvec, net)
        ref = neural_cost_rollout_plain(model, s0, Q, pvec, net)
        assert neural_cost_rollout.launches == before + 1
    else:
        hidden = tuple(0.3 * torch.randn(h.shape, generator=gen, device=cuda_device)
                       for h in params["dyn"]["hidden"])
        got = recurrent_cost_rollout(model, s0, Q, pvec, net, hidden)
        ref = recurrent_cost_rollout_plain(model, s0, Q, pvec, net, hidden)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("Kc", [1000, 8])
@pytest.mark.parametrize("delta", [True, False])
def test_cuda_k11_single_layer_net(cuda_device, delta, Kc):
    """K11 over an MLP of one layer, [x, u] @ w0 + b0 (no hidden layer: one
    warp computes the output tile alone, with no barrier), in delta form
    with norms and in absolute form without, against its plain version to
    NET_TOL."""
    import dataclasses
    from chip_smoke import MLP_SPEC, NET_TOL, OPTIMIZER_CONFIG, make_controller

    ctrl = make_controller("cuda", spec=MLP_SPEC,
                           config={**OPTIMIZER_CONFIG, "num_rollouts": Kc, "mpc_horizon": 50})
    model, pack = neural.net_model(ctrl.optimizer)
    model = dataclasses.replace(model, predict_delta=delta)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    net = {"w0": 0.1 * torch.randn(5, 4, generator=gen, device=cuda_device),
           "b0": 0.01 * torch.randn(4, generator=gen, device=cuda_device)}
    if delta:
        committed = ctrl._assemble_params()["dyn"]["net"]
        net.update({k: v for k, v in committed.items() if k.startswith("norm_")})
    s0 = 0.05 * torch.randn(Kc, 4, generator=gen, device=cuda_device)
    Q = torch.clamp(0.3 * torch.randn(Kc, 50, 1, generator=gen, device=cuda_device), -1.0, 1.0)
    pvec = pack(ctrl._assemble_params(), torch.tensor([0.1], device=cuda_device))
    got = neural_cost_rollout(model, s0, Q, pvec, net)
    ref = neural_cost_rollout_plain(model, s0, Q, pvec, net)
    torch.testing.assert_close(got, ref, **NET_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [GRU_ASSET, "GRU-5IN-13H1-6H2-4OUT", "LSTM-5IN-40H1-4OUT"])
def test_cuda_k13_below_one_group(cuda_device, name):
    """K13 at K=8, below one 16-rollout group (its rows past K repeat
    rollout K-1 and write nothing), for the committed GRU, a GRU narrower
    than a group's warps and an LSTM wider than them, to RNN_TOL."""
    from chip_smoke import RNN_TOL

    path = ASSETS if name == GRU_ASSET else None
    spec = f"neural:{name}:{path}" if path else f"neural:{name}"
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": "mppi", "controller_logging": False,
                                 "device": "cuda"})
    ctrl.configure(optimizer_name="mppi", predictor_specification=spec,
                   optimizer_config=optimizer_config(8, 50), cost_function_config=COST_WEIGHTS)
    model, pack = neural.net_model(ctrl.optimizer)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    s0 = 0.05 * torch.randn(8, 4, generator=gen, device=cuda_device)
    Q = torch.clamp(0.3 * torch.randn(8, 50, 1, generator=gen, device=cuda_device), -1.0, 1.0)
    params = ctrl._assemble_params()
    pvec = pack(params, torch.tensor([0.1], device=cuda_device))
    hidden = tuple(0.3 * torch.randn(h.shape, generator=gen, device=cuda_device)
                   for h in params["dyn"]["hidden"])
    got = recurrent_cost_rollout(model, s0, Q, pvec, params["dyn"]["net"], hidden)
    ref = recurrent_cost_rollout_plain(model, s0, Q, pvec, params["dyn"]["net"], hidden)
    torch.testing.assert_close(got, ref, **RNN_TOL)


def jax_start_sweep(ticks: int = 200, retarget_at: int = 100, new_target: float = 0.1) -> dict:
    """The JAX package alone on the CPU: its MPPI controller over the
    committed mlp-64-64 at ``chip_smoke.py``'s configuration (K=16384,
    H=50, inducing period 10, SQRTRHOINV 0.03), closed loop against its own
    CartpoleEnv for ``ticks`` ticks with the target changed at
    ``retarget_at``, from the start states of ``chip_smoke.py --starts``
    (the JAX CartpoleEnv(seed=0) state, then the port's CartpoleEnv seeds
    0-7), with optimizer seeds 0 and 1.  Prints one JSON line per run (max
    |angle|, the first tick at which |angle| >= 0.5 or null) and returns the
    count of runs that kept the pole up."""
    import json
    from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
    from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv

    starts = [np.asarray(JaxCartpoleEnv(batch_size=1, dt=0.02, seed=0).reset()[0][0])]
    starts += [CartpoleEnv(batch_size=1, dt=0.02, seed=k).reset()[0][0] for k in range(8)]
    held = []
    for seed in (0, 1):
        for i, start in enumerate(starts):
            ctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.0},
                          config={"optimizer": "mppi", "controller_logging": False})
            ctrl.configure(optimizer_name="mppi",
                           predictor_specification=f"neural:{MLP_ASSET}:{ASSETS}",
                           optimizer_config=optimizer_config(
                               16384, 50, seed=seed, SQRTRHOINV=0.03,
                               period_interpolation_inducing_points=10))
            env = JaxCartpoleEnv(batch_size=1, dt=0.02, seed=0)
            env.reset()
            env.state = jnp.asarray(np.asarray(start, np.float32)[None])
            s, max_angle, fell_at = np.asarray(env.state), 0.0, None
            for t in range(ticks):
                attrs = {"target_position": new_target} if t == retarget_at else None
                s, *_ = env.step(ctrl.step(s[0], updated_attributes=attrs))
                max_angle = max(max_angle, abs(float(s[0, 2])))
                if fell_at is None and max_angle >= 0.5:
                    fell_at = t
            held.append(fell_at is None)
            print(json.dumps({"seed": seed, "start": i, "start_state": [float(v) for v in start],
                              "max_abs_angle": max_angle, "fell_at_tick": fell_at,
                              "final_state": [float(v) for v in s[0]]}), flush=True)
    return {"runs": len(held), "pole_up_runs": sum(held)}


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    print(jax_start_sweep() if "--starts" in sys.argv[1:] else make_assets())
