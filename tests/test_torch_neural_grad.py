"""K8, the port's gradient kernel over an MLP
(``ops/neural_grad_cost_rollout.py``), and the MLP step's hand-written
adjoint it rests on (``ops/adjoints.py`` mlp_step_vjp).

The adjoint is held against ``torch.autograd`` in float64, where only
rounding separates the two; K8's plain version against the JAX package's
Pallas gradient kernel in interpret mode and against autograd through
K11's plain version; one rpgd-tf update over an MLP against the JAX
package's; and — on a machine with a card only — the CUDA kernel against
its plain version.  The tensor-core kernel's arithmetic (3xTF32 products and
the fragment layouts of csrc/mlp_mma.cuh) is rehearsed here on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops.adjoints import mlp_step_vjp
from control_toolkit_tpu_torch.ops.grad_cost_rollout import plain_grad_loop
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.neural_rollout import (
    mlp_layer_count, mlp_step, neural_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.soa_integrators import tadd
from control_toolkit_tpu_torch.optimizers.kernel_families import neural
from control_toolkit_tpu_torch.utils.convert import neural_params_from_numpy, params_from_numpy
from test_torch_mppi import CPU, LIMITS, jax_params_numpy
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


# ---- the tensor-core kernels' arithmetic, rehearsed on the CPU --------------------------
# chip_smoke.py's bounds on K8 and K9 against their plain versions: J to
# NET_TOL, dQ to rtol 2e-5 plus 5e-6 of its largest entry.
NET_TOL = dict(rtol=5e-5, atol=1e-3)
DQ_RTOL, DQ_ATOL_FRAC = 2e-5, 5e-6


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, on the 13 low mantissa bits (half their
    range added to the magnitude's bits, then the 13 cleared)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor):
    hi = tf32(t)
    return hi, tf32(t - hi)


def mm_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` as csrc/mlp_mma.cuh computes it: per 8-block of the inner
    dimension, a_lo w_hi, then a_hi w_lo, then a_hi w_hi added to an FP32
    sum (a_lo w_lo dropped); an output of one 8-column tile takes each
    8-block's three products into a sum of its own, added in order after."""
    (ahi, alo), (whi, wlo) = split_tf32(a), split_tf32(w)
    one_tile = w.shape[1] <= 8
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        blk = slice(k0, k0 + 8)
        part = torch.zeros_like(acc) if one_tile else acc
        for x, y in ((alo, whi), (ahi, wlo), (ahi, whi)):
            part = part + x[:, blk] @ y[blk]
        acc = acc + part if one_tile else part
    return acc


def mm_tf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One-pass TF32: each operand rounded once (about 10 mantissa bits)."""
    return tf32(a) @ tf32(w)


def mlp_step_with(mm, net, x, u, predict_delta):
    """ops/neural_rollout.py mlp_step with ``mm`` for each layer's product."""
    a = torch.cat([x, u], dim=1)
    if "norm_in_mean" in net:
        a = (a - net["norm_in_mean"]) / net["norm_in_std"]
    n = mlp_layer_count(net)
    for i in range(n):
        a = mm(a, net[f"w{i}"]) + net[f"b{i}"]
        if i < n - 1:
            a = torch.tanh(a)
    if "norm_out_mean" in net:
        a = a * net["norm_out_std"] + net["norm_out_mean"]
    return x + a if predict_delta else a


def mlp_vjp_with(mm, xs, us, net, predict_delta, lam):
    """ops/adjoints.py mlp_step_vjp with ``mm`` for each product: the
    forward re-run's layers and each transposed layer."""
    a = torch.cat([torch.stack(xs, dim=1), torch.stack(us, dim=1)], dim=1)
    if "norm_in_mean" in net:
        a = (a - net["norm_in_mean"]) / net["norm_in_std"]
    n = mlp_layer_count(net)
    acts = []
    for i in range(n - 1):
        a = torch.tanh(mm(a, net[f"w{i}"]) + net[f"b{i}"])
        acts.append(a)
    g = torch.stack(lam, dim=1)
    if "norm_out_mean" in net:
        g = g * net["norm_out_std"]
    for i in reversed(range(n)):
        if i < n - 1:
            g = g * (1.0 - acts[i] * acts[i])
        g = mm(g, net[f"w{i}"].T)
    if "norm_in_mean" in net:
        g = g / net["norm_in_std"]
    S = len(xs)
    dxs = tuple(g[:, i] for i in range(S))
    return (tadd(lam, dxs) if predict_delta else dxs), tuple(g[:, S + j] for j in range(len(us)))


def within_kernel_bounds(cost, dQ, ref_cost, ref_dQ) -> bool:
    return (torch.allclose(cost, ref_cost, **NET_TOL)
            and torch.allclose(dQ, ref_dQ, rtol=DQ_RTOL,
                               atol=DQ_ATOL_FRAC * float(ref_dQ.abs().max())))


def distances(cost, dQ, ref_cost, ref_dQ) -> dict:
    return {"cost_max_abs_err": float((cost - ref_cost).abs().max()),
            "dQ_max_abs_err": float((dQ - ref_dQ).abs().max()),
            "dQ_max_abs": float(ref_dQ.abs().max()),
            "within_bounds": within_kernel_bounds(cost, dQ, ref_cost, ref_dQ)}


def committed_mlp_problem(K_=256, H_=50):
    """chip_smoke.py phase 12's operands at K_ rollouts on the CPU: the
    committed mlp-64-64 under rpgd-tf, s0 0.05 N(0, 1), Q uniform on
    [-1, 1] (numpy, seed 9)."""
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": "rpgd-tf", "controller_logging": False,
                                 "device": "cpu"})
    ctrl.configure(optimizer_name="rpgd-tf",
                   predictor_specification=f"neural:{MLP_ASSET}:{ASSETS}",
                   optimizer_config=rpgd_config(num_rollouts=K_, mpc_horizon=H_),
                   cost_function_config=COST_WEIGHTS)
    model, pack = neural.net_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    rng = np.random.default_rng(9)
    s0 = torch.tensor(0.05 * rng.standard_normal((K_, 4)), dtype=torch.float32)
    Q = torch.tensor(rng.uniform(-1.0, 1.0, (K_, H_, 1)), dtype=torch.float32)
    return model, s0, Q, pack(params, torch.tensor([0.1])), params["dyn"]["net"]


def test_k8_3xtf32_arithmetic_stays_within_the_kernel_bounds(record_property):
    """K8's products in 3xTF32 (every layer of the forward, of the
    backward's re-run and of the transposed step), emulated over the
    committed mlp-64-64 at K=256, H=50, stay within chip_smoke.py's bounds
    of the FP32 plain version; one-pass TF32's distance is recorded."""
    model, s0, Q, pvec, net = committed_mlp_problem()
    ref = neural_grad_cost_rollout_plain(model, s0, Q, pvec, net)
    delta = model.predict_delta
    runs = {name: plain_grad_loop(
        model, s0, Q, pvec, lambda x, u, mm=mm: mlp_step_with(mm, net, x, u, delta),
        lambda xs, us, lam, mm=mm: mlp_vjp_with(mm, xs, us, net, delta, lam))
        for name, mm in (("3xtf32", mm_3xtf32), ("one_pass_tf32", mm_tf32))}
    found = {name: distances(*run, *ref) for name, run in runs.items()}
    record_property("k8_tf32_distances", found)
    assert found["3xtf32"]["within_bounds"], found


def tile_fragments(X: np.ndarray) -> np.ndarray:
    """[16, 8T] -> [T, 32, 4]: X as the C fragments of T tiles, lane
    (g, t) = (lane // 4, lane % 4) holding X[g, 8j+2t], X[g, 8j+2t+1],
    X[g+8, 8j+2t], X[g+8, 8j+2t+1] of tile j (csrc/mlp_mma.cuh)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    return np.stack([np.stack([X[g, 8 * j + 2 * t], X[g, 8 * j + 2 * t + 1],
                               X[g + 8, 8 * j + 2 * t], X[g + 8, 8 * j + 2 * t + 1]], axis=1)
                     for j in range(X.shape[1] // 8)])


def untile_fragments(F: np.ndarray) -> np.ndarray:
    """The inverse of tile_fragments."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    X = np.zeros((16, 8 * F.shape[0]), F.dtype)
    for j, f in enumerate(F):
        X[g, 8 * j + 2 * t], X[g, 8 * j + 2 * t + 1] = f[:, 0], f[:, 1]
        X[g + 8, 8 * j + 2 * t], X[g + 8, 8 * j + 2 * t + 1] = f[:, 2], f[:, 3]
    return X


def mma_m16n8k8(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """d = c + A B for one m16n8k8 product in float64, from and to the
    lanes' fragments as PTX lays them out for .tf32: A [16, 8] at row g
    (a0, a2) or g+8 (a1, a3), column t (a0, a1) or t+4 (a2, a3); B [8, 8]
    at row t (b0) or t+4 (b1), column g; C and D at row g (c0, c1) or g+8
    (c2, c3), column 2t (c0, c2) or 2t+1 (c1, c3)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    A, B, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    B[t, g], B[t + 4, g] = b[:, 0], b[:, 1]
    C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1] = c.T
    D = C + A @ B
    return np.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]], axis=1)


def fragment_layer(F: np.ndarray, W: np.ndarray, split: bool) -> np.ndarray:
    """One layer on C fragments F [kt, 32, 4] as mlp_mma.cuh runs it: each
    fragment read as an A fragment (a0 = c0, a1 = c2, a2 = c1, a3 = c3), W
    [8kt, 8nt] staged in the permuted k order (fragment (kb, j), lane
    (g, t): b0 = W[8kb+2t, 8j+g], b1 = W[8kb+2t+1, 8j+g]), the products
    accumulated over kb (``split``: a_lo b_hi, a_hi b_lo, a_hi b_hi); returns
    the C fragments [nt, 32, 4]."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((W.shape[1] // 8, 32, 4))
    for kb, c in enumerate(F):
        a = c[:, [0, 2, 1, 3]]
        for j in range(out.shape[0]):
            b = np.stack([W[8 * kb + 2 * t, 8 * j + g], W[8 * kb + 2 * t + 1, 8 * j + g]], axis=1)
            if not split:
                out[j] = mma_m16n8k8(a, b, out[j])
                continue
            (ahi, alo), (bhi, blo) = (tuple(v.double().numpy() for v in split_tf32(torch.tensor(x)))
                                      for x in (a, b))
            for x, y in ((alo, bhi), (ahi, blo), (ahi, bhi)):
                out[j] = mma_m16n8k8(x, y, out[j])
    return out


def padded(M: np.ndarray, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((rows, cols), M.dtype)
    out[:M.shape[0], :M.shape[1]] = M
    return out


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("widths", [(5, 64, 64, 4), (5, 13, 6, 4), (5, 72, 20, 4)])
def test_permuted_fragment_layout_gives_the_unpermuted_product(widths, split):
    """The k-permuted staging of csrc/mlp_mma.cuh: chained through each
    layer's C fragments with no re-layout, forward (W) and transposed (W^T,
    staged the same way), the fragment products equal the unpermuted
    products, in float64 or (``split``) in 3xTF32 against the same
    3xTF32 products taken unpermuted."""
    rng = np.random.default_rng(sum(widths))
    Ws = [rng.standard_normal((a, b)).astype(np.float32) for a, b in zip(widths, widths[1:])]
    X = rng.standard_normal((16, widths[0])).astype(np.float32)

    def product(x, w):
        if not split:
            return x.astype(np.float64) @ w.astype(np.float64)
        (xhi, xlo), (whi, wlo) = (tuple(v.double() for v in split_tf32(torch.tensor(m)))
                                  for m in (x, w))
        return (xlo @ whi + xhi @ wlo + xhi @ whi).numpy()

    for chain, mats in (("forward", Ws), ("transposed", [W.T for W in reversed(Ws)])):
        dims = [m.shape[0] for m in mats] + [mats[-1].shape[1]]
        x = X if chain == "forward" else rng.standard_normal((16, dims[0])).astype(np.float32)
        F, ref = tile_fragments(padded(x, 16, -(-dims[0] // 8) * 8)), x
        for m in mats:
            F = fragment_layer(F, padded(m, -(-m.shape[0] // 8) * 8, -(-m.shape[1] // 8) * 8),
                               split)
            # The next layer reads this layer's C fragments as they are; its
            # reference reads the same values, rounded to float32 as the
            # kernel's registers hold them.
            ref = product(ref.astype(np.float32), m)
            np.testing.assert_allclose(untile_fragments(F)[:, :m.shape[1]], ref, rtol=1e-12,
                                       atol=1e-12 * np.abs(ref).max())
            F = F.astype(np.float32).astype(np.float64)
