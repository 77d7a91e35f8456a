"""K8, the port's gradient kernel over an MLP
(``ops/neural_grad_cost_rollout.py``), and the MLP step's hand-written
adjoint it rests on (``ops/adjoints.py`` mlp_step_vjp).

The adjoint is held against ``torch.autograd`` in float64, where only
rounding separates the two; K8's plain version against the JAX package's
Pallas gradient kernel in interpret mode and against autograd through
K11's plain version; one rpgd-tf update over an MLP against the JAX
package's; and — on a machine with a card only — the CUDA kernel against
its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu_torch.ops.adjoints import mlp_step_vjp
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.neural_rollout import mlp_step, neural_cost_rollout_plain
from control_toolkit_tpu_torch.optimizers.kernel_families import neural
from control_toolkit_tpu_torch.utils.convert import neural_params_from_numpy, params_from_numpy
from test_torch_mppi import CPU, jax_params_numpy
from test_torch_neural import ASSETS, COST_WEIGHTS, MLP_ASSET, jax_net, make_pair
from test_torch_rpgd import assert_rpgd_states_match, jax_rpgd_draw, rpgd_config, set_rpgd_state

K, H = 64, 10
F64_TOL = dict(rtol=1e-9, atol=1e-9)
# The JAX neural gradient test's own bounds (test_pallas_neural_grad.py:
# 56-66): random-init delta nets blow rollouts up, so matmul reassociation
# shows at the extremes.
COST_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=5e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rpgd_over(tmp_path, name, net, predict_delta=True, **extra):
    return make_pair(tmp_path, name, net, optimizer="rpgd-tf",
                     config=rpgd_config(num_rollouts=K, mpc_horizon=H, **extra),
                     predict_delta=predict_delta, jax_logging=True)


@pytest.mark.parametrize("norms,delta", [(False, True), (True, False), (True, True)])
def test_mlp_step_vjp_matches_autograd_float64(norms, delta):
    net = {k: torch.tensor(v, dtype=torch.float64)
           for k, v in jax_net("mlp-12-7", seed=1, norms=norms).items()}
    rng = np.random.default_rng(2)
    x = torch.tensor(0.3 * rng.standard_normal((16, 4)), requires_grad=True)
    u = torch.tensor(rng.uniform(-1.0, 1.0, (16, 1)), requires_grad=True)
    lam = torch.tensor(rng.standard_normal((16, 4)))
    (mlp_step(net, x, u, delta) * lam).sum().backward()
    dxs, dus = mlp_step_vjp(tuple(x.detach().T), tuple(u.detach().T), net, delta, tuple(lam.T))
    torch.testing.assert_close(torch.stack(dxs, 1), x.grad, **F64_TOL)
    torch.testing.assert_close(torch.stack(dus, 1), u.grad, **F64_TOL)


@pytest.mark.parametrize("name,norms,delta,ccrc", [
    ("mlp-16-16", False, True, None),
    ("mlp-16-16", True, False, 5.0),
])
def test_k8_plain_matches_pallas_interpret_and_autograd(tmp_path, name, norms, delta, ccrc):
    """Also turns the control-change term up (as the JAX test does) so the
    backward's gprev carry is exercised."""
    jctrl, pctrl = rpgd_over(tmp_path, name, jax_net(name, seed=3, norms=norms), delta)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    rng = np.random.default_rng(4)
    s_tiled = np.tile(np.array([[0.1, -0.2, 0.3, 0.05]], np.float32), (K, 1))
    Q = rng.uniform(-0.8, 0.8, (K, H, 1)).astype(np.float32)
    u_prev = np.array([0.25], np.float32)
    jparams = jctrl._assemble_params()
    if ccrc is not None:
        jparams = dict(jparams, cost=dict(jparams["cost"], ccrc_weight=jnp.float32(ccrc)))
    pallas = jopt._build_pallas_neural_grad(interpret=True, tile_k=32)
    ref_cost, ref_dq = pallas(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev), jparams)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    if ccrc is not None:
        params["cost"]["ccrc_weight"] = torch.tensor(ccrc)
    model, pack = neural.net_model(popt)
    args = (model, torch.tensor(s_tiled), torch.tensor(Q), pack(params, torch.tensor(u_prev)),
            params["dyn"]["net"])
    before = neural_grad_cost_rollout.launches
    cost, dQ = neural_grad_cost_rollout(*args)
    assert neural_grad_cost_rollout.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), np.asarray(ref_dq), **GRAD_TOL)
    Qv = args[2].clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(neural_cost_rollout_plain(args[0], args[1], Qv, *args[3:]).sum(),
                                  Qv)
    torch.testing.assert_close(dQ, auto, **GRAD_TOL)


def test_k8_is_the_gradient_path_and_agrees_with_autograd(tmp_path):
    """K8 serves rpgd-tf's gradient over an MLP; force_scan takes autograd
    through the fused loop, and a GRU (no K8) autograd through its
    rollout; the MLP's two agree."""
    net = jax_net("mlp-16-16", seed=5, norms=True)
    _, kernel_ctrl = rpgd_over(tmp_path, "mlp-16-16", net)
    _, scan_ctrl = rpgd_over(tmp_path, "mlp-16-16", net, force_scan=True)
    _, gru_ctrl = rpgd_over(tmp_path, "GRU-5IN-8H1-4OUT", jax_net("GRU-5IN-8H1-4OUT"))
    assert neural.can_use_grad(kernel_ctrl.optimizer)
    assert not neural.can_use_grad(scan_ctrl.optimizer) and not neural.can_use_grad(gru_ctrl.optimizer)
    rng = np.random.default_rng(6)
    s_tiled = torch.tensor(np.tile((0.1 * rng.standard_normal((1, 4))).astype(np.float32), (K, 1)))
    Q = torch.tensor(rng.uniform(-1.0, 1.0, (K, H, 1)).astype(np.float32))
    u_prev = torch.tensor([0.1])
    grads = []
    for ctrl in (kernel_ctrl, scan_ctrl):
        grad_fn, cost_only = ctrl.optimizer._make_grad_and_cost_only()
        assert cost_only is not None
        grads.append(grad_fn(Q, s_tiled, u_prev, ctrl._assemble_params()))
    torch.testing.assert_close(grads[0], grads[1], **GRAD_TOL)
    grad_fn, _ = gru_ctrl.optimizer._make_grad_and_cost_only()
    assert torch.isfinite(grad_fn(Q, s_tiled, u_prev, gru_ctrl._assemble_params())).all()


@pytest.mark.parametrize("count", [10, 7])
def test_one_rpgd_update_over_an_mlp_matches_jax(tmp_path, count):
    jctrl, pctrl = rpgd_over(tmp_path, "mlp-16-16", jax_net("mlp-16-16", seed=7, norms=True))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    set_rpgd_state(jopt, popt, count)
    s = np.array([0.1, -0.05, 0.2, 0.3], np.float32)
    draw = torch.as_tensor(jax_rpgd_draw(jopt)) if count % 10 == 0 else None
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    u_jax = jctrl.step(s)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params, draw)
    assert_rpgd_states_match(jopt, state, diag, u, u_jax)


def test_wrapper_never_runs_the_plain_version_on_non_cpu_tensors(tmp_path):
    _, pctrl = rpgd_over(tmp_path, "mlp-8", jax_net("mlp-8"))
    model, _ = neural.net_model(pctrl.optimizer)
    net = pctrl._assemble_params()["dyn"]["net"]
    meta = dict(device="meta")
    before = neural_grad_cost_rollout.launches
    with pytest.raises(ValueError, match="several devices"):
        neural_grad_cost_rollout(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
                                 torch.empty(8, **meta), net)
    with pytest.raises(ValueError, match="CUDA"):
        neural_grad_cost_rollout(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
                                 torch.empty(8, **meta),
                                 {k: torch.empty(v.shape, **meta) for k, v in net.items()})
    assert neural_grad_cost_rollout.launches == before
    assert neural_params_from_numpy(jax_net("mlp-8"))["net"]["w0"].dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("name,norms,delta", [(MLP_ASSET, None, True), ("mlp-13-6", True, False)])
def test_cuda_kernel_matches_plain_version(tmp_path, name, norms, delta):
    """K8 against its plain version on the same card tensors at K=1000
    (ragged), H=50: J to the forward kernels' bound, dQ to rtol 2e-5 plus
    5e-6 of its largest entry (the backward amplifies the forward's
    rounding; K7's bound, test_torch_grad.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and run only there")
    from control_toolkit_tpu.models import networks as jnets
    from control_toolkit_tpu_torch.controllers.mpc import MPCController
    from test_torch_mppi import LIMITS

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    path = ASSETS if norms is None else tmp_path
    if norms is not None:
        jnets.save_net(tmp_path / f"{name}.npz", jax_net(name, seed=8, norms=norms),
                       meta={"predict_delta": delta})
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": "rpgd-tf", "controller_logging": False,
                                 "device": "cuda"})
    ctrl.configure(optimizer_name="rpgd-tf", predictor_specification=f"neural:{name}:{path}",
                   optimizer_config=rpgd_config(num_rollouts=1000, mpc_horizon=50),
                   cost_function_config=COST_WEIGHTS)
    model, pack = neural.net_model(ctrl.optimizer)
    gen = torch.Generator(device=dev).manual_seed(0)
    s0 = 0.05 * torch.randn(1000, 4, generator=gen, device=dev)
    Q = 2.0 * torch.rand(1000, 50, 1, generator=gen, device=dev) - 1.0
    params = ctrl._assemble_params()
    pvec = pack(params, torch.tensor([0.1], device=dev))
    cost, dQ = neural_grad_cost_rollout(model, s0, Q, pvec, params["dyn"]["net"])
    ref_cost, ref_dQ = neural_grad_cost_rollout_plain(model, s0, Q, pvec, params["dyn"]["net"])
    torch.testing.assert_close(cost, ref_cost, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(dQ, ref_dQ, rtol=2e-5, atol=5e-6 * float(ref_dQ.abs().max()))
