"""K7, the port's gradient kernel (``ops/grad_cost_rollout.py``), and the
hand-written adjoints it rests on (``ops/adjoints.py``).

The adjoints are held against ``torch.autograd`` in float64, where only
rounding separates the two; the plain version against the JAX package's
Pallas gradient kernel in interpret mode, against autograd through K1's
plain version, against finite differences and against the recorded TF
fixture; the CUDA kernel's time-parallel adjoint (forward-mode per-step
Jacobians, then the linear chain) rehearsed in PyTorch against the plain
version and the Pallas kernel; and — on a machine with a card only — the
CUDA kernel against its plain version.
"""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu_torch.costs.cartpole import CartpoleQuadraticCost
from chip_smoke import stage_term_mutants
from control_toolkit_tpu_torch.ops.adjoints import (
    PLANT_ADJOINTS, cartpole_derivs_jac, cartpole_derivs_vjp, cartpole_stage_vjp,
    cartpole_terminal_grad, integrator_jac, integrator_vjp,
)
from control_toolkit_tpu_torch.ops.common import adam_init, adam_update, clip_by_norm
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout_plain
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.soa_integrators import make_soa_stepper
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.utils.convert import params_from_numpy
from test_torch_mppi import CPU, jax_params_numpy, make_jax_ctrl, make_port_ctrl

K, H, TILE = 128, 15, 64
GOLDEN = Path(__file__).parent / "golden" / "cartpole_golden.npz"
# float64: the hand-written and the automatic adjoint differ by rounding only.
F64_TOL = dict(rtol=1e-9, atol=1e-9)
# The JAX gradient test's own bounds (test_pallas_grad.py:68-71): float32
# through 15 rk4 steps forward and back.
COST_TOL = dict(rtol=3e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=2e-4)
# chip_smoke.py's bound on K7's dQ against its plain version: rtol 2e-5
# plus 5e-6 of max|dQ|.
DQ_RTOL, DQ_ATOL_FRAC = 2e-5, 5e-6
INTEGRATOR_CASES = [("rk4", 1), ("euler", 1), ("rk4", 2), ("euler", 2)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def port():
    """The port's cartpole RolloutModel and pack, from a controller."""
    pctrl = make_port_ctrl(K, H)
    model, pack = ode.rollout_model(pctrl.optimizer)
    return pctrl, model, pack


def p64(model, pack, params, u_prev=0.1, **overrides):
    """Packed parameters in float64, with entries overridden by key."""
    pvec = pack(params, torch.tensor([u_prev])).double()
    for key, value in overrides.items():
        pvec[model.param_keys.index(key)] = value
    return pvec


def components(rng, n, scale, dtype=torch.float64):
    return tuple(torch.tensor(scale[i] * rng.standard_normal(K), dtype=dtype, requires_grad=True)
                 for i in range(n))


def autograd_vjp(outputs, cotangents, inputs):
    loss = sum((o * c).sum() for o, c in zip(outputs, cotangents))
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]


def jacobian_rows(outputs, inputs):
    """Row i: d outputs[i] / d inputs, each [K] tensor's entries independent."""
    rows = []
    for o in outputs:
        grads = torch.autograd.grad(o.sum(), inputs, retain_graph=True, allow_unused=True)
        rows.append([torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)])
    return rows


def assert_close_tuple(got, ref, **tol):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.detach(), r.detach(), **tol)


@pytest.fixture(scope="module")
def frictional(port):
    """float64 parameters with both friction terms on, so every term of
    the cartpole Jacobian is live."""
    pctrl, model, pack = port
    pvec = p64(model, pack, pctrl._assemble_params(), u_prev=0.2,
               d_friction_cart=0.3, d_friction_pole=0.05)
    return model, model.unpack(pvec)


def test_cartpole_derivs_vjp_matches_autograd(frictional):
    model, p = frictional
    rng = np.random.default_rng(0)
    xs = components(rng, 4, (1.0, 2.0, 2.0, 3.0))
    us = components(rng, 1, (0.7,))
    lam = components(rng, 4, (1.0, 1.0, 1.0, 1.0))
    ref = autograd_vjp(model.derivs(xs, us, p), lam, xs + us)
    dxs, dus = cartpole_derivs_vjp(xs, us, p, lam)
    assert_close_tuple(dxs + dus, ref, **F64_TOL)


def test_cartpole_stage_vjp_and_terminal_grad_match_autograd(frictional):
    model, p = frictional
    rng = np.random.default_rng(1)
    xs = components(rng, 4, (1.0, 2.0, 2.0, 3.0))
    us, prev = components(rng, 1, (0.7,)), components(rng, 1, (0.7,))
    ct = 1.0 / (H + 1)
    ones = (torch.full((K,), ct, dtype=torch.float64),)
    ref = autograd_vjp((model.stage(xs, us, prev, p),), ones, xs + us + prev)
    gx, gu, gprev = cartpole_stage_vjp(xs, us, prev, p, ct)
    assert_close_tuple(gx + gu + gprev, ref, **F64_TOL)
    assert_close_tuple(gprev, (-2.0 * p["c_ccrc_weight"] * (us[0] - prev[0]) * ct,), **F64_TOL)
    ref = autograd_vjp((model.terminal(xs, p),), ones, xs)
    assert_close_tuple(cartpole_terminal_grad(xs, p, ct), ref, **F64_TOL)


@pytest.mark.parametrize("integrator,substeps", INTEGRATOR_CASES)
def test_integrator_vjp_matches_autograd(frictional, integrator, substeps):
    model, p = frictional
    rng = np.random.default_rng(2)
    xs = components(rng, 4, (1.0, 2.0, 2.0, 3.0))
    us = components(rng, 1, (0.7,))
    lam = components(rng, 4, (1.0, 1.0, 1.0, 1.0))
    step = make_soa_stepper(model.derivs, integrator, 0.02, substeps)
    ref = autograd_vjp(step(xs, us, p), lam, xs + us)
    dxs, dus = integrator_vjp(model.derivs, cartpole_derivs_vjp, xs, us, p, lam,
                              integrator == "rk4", substeps, 0.02)
    assert_close_tuple(dxs + dus, ref, **F64_TOL)


def test_cartpole_derivs_jac_matches_autograd(frictional):
    """The Jacobian K7's adjoint launch builds its per-step Jacobians from,
    row by row against autograd, and its f against the plant's derivs."""
    model, p = frictional
    rng = np.random.default_rng(5)
    xs = components(rng, 4, (1.0, 2.0, 2.0, 3.0))
    us = components(rng, 1, (0.7,))
    f, J = cartpole_derivs_jac(xs, us, p)
    ref = model.derivs(xs, us, p)
    assert_close_tuple(f, ref, **F64_TOL)
    for i, row in enumerate(jacobian_rows(ref, xs + us)):
        assert_close_tuple(tuple(J[:, i].unbind(1)), row, **F64_TOL)


@pytest.mark.parametrize("integrator,substeps", INTEGRATOR_CASES)
def test_integrator_jac_matches_autograd(frictional, integrator, substeps):
    """A = d x' / d x and B = d x' / d u of one control period, in forward
    mode, against autograd through the stepper."""
    model, p = frictional
    rng = np.random.default_rng(6)
    xs = components(rng, 4, (1.0, 2.0, 2.0, 3.0))
    us = components(rng, 1, (0.7,))
    step = make_soa_stepper(model.derivs, integrator, 0.02, substeps)
    out = step(xs, us, p)
    A, B = integrator_jac(cartpole_derivs_jac, xs, us, p, integrator == "rk4", substeps, 0.02)
    assert A.shape == (K, 4, 4) and B.shape == (K, 4, 1)
    for i, row in enumerate(jacobian_rows(out, xs + us)):
        assert_close_tuple(tuple(torch.cat([A[:, i], B[:, i]], dim=1).unbind(1)), row, **F64_TOL)


def time_parallel_grad(model, s0, Q, pvec):
    """csrc/grad_cost_rollout.cu's two launches in PyTorch: the forward
    stores x_0..x_H (K1's stepper, K1's cost); then, for every (h, k) at
    once, the period's Jacobians A_h, B_h (``integrator_jac``) and the
    stage terms at (x_h, u_h, u_{h-1}); then the linear chain, last step
    first: dQ_h = (B_h^T lam + gu_h) + gprev_{h+1}, lam = A_h^T lam + gx_h."""
    _, stage_vjp, terminal_grad = PLANT_ADJOINTS[model.plant]
    p = model.unpack(pvec)
    (Kt, S), (H, U) = s0.shape, Q.shape[1:]
    ct = 1.0 / (H + 1)
    step = make_soa_stepper(model.derivs, model.integrator, model.dt, model.intermediate_steps)
    xs = [tuple(s0.unbind(1))]
    for h in range(H):
        xs.append(step(xs[-1], tuple(Q[:, h].unbind(1)), p))
    # The items, h-major: [H*K] components.
    X = tuple(torch.cat([x[i] for x in xs[:H]]) for i in range(S))
    prev = torch.cat([p["__u_prev_0"].expand(Kt, 1, U).to(Q.dtype), Q[:, :-1]], dim=1)
    Us = tuple(Q[:, :, j].T.reshape(-1) for j in range(U))
    Prev = tuple(prev[:, :, j].T.reshape(-1) for j in range(U))
    A, B = integrator_jac(cartpole_derivs_jac, X, Us, p, model.integrator == "rk4",
                          model.intermediate_steps, model.dt)
    gx, gu, gp = (torch.stack(g, dim=1).reshape(H, Kt, -1) for g in stage_vjp(X, Us, Prev, p, ct))
    A, B = A.reshape(H, Kt, S, S), B.reshape(H, Kt, S, U)
    lam = torch.stack(terminal_grad(xs[H], p, ct), dim=1)
    gnext = torch.zeros(Kt, U, dtype=Q.dtype)
    dQ = torch.empty_like(Q)
    for h in reversed(range(H)):
        dQ[:, h] = (torch.einsum("ksu,ks->ku", B[h], lam) + gu[h]) + gnext
        lam = torch.einsum("ksj,ks->kj", A[h], lam) + gx[h]
        gnext = gp[h]
    return cost_rollout_plain(model, s0, Q, pvec), dQ


def within_dq_bound(dQ, ref):
    return torch.allclose(dQ, ref, rtol=DQ_RTOL, atol=DQ_ATOL_FRAC * float(ref.abs().max()))


@pytest.mark.parametrize("integrator,substeps", INTEGRATOR_CASES)
def test_k7_time_parallel_adjoint_matches_plain_and_pallas(port, integrator, substeps,
                                                           record_property):
    """The time-parallel adjoint's arithmetic in float32 (the same linear
    map as the plain version's sweep, summed in another order) against
    the plain version to chip_smoke.py's dQ bound, which still rejects
    each of phase 7's four wrong stage-gradient terms, and against the
    JAX package's Pallas gradient kernel in interpret mode to its own
    test's bounds."""
    from control_toolkit_tpu.models.predictors import make_ode_rollout

    _, model, pack = port
    jctrl = make_jax_ctrl(K, H)
    jpred = jctrl.optimizer.predictor.predictor
    rng = np.random.default_rng(7)
    s0 = (0.2 * rng.standard_normal((K, 4))).astype(np.float32)
    Q = rng.uniform(-1.0, 1.0, (K, H, 1)).astype(np.float32)
    u_prev = np.array([0.1], np.float32)
    saved = jpred.integrator, jpred.intermediate_steps, jpred.rollout_fn
    jpred.integrator, jpred.intermediate_steps = integrator, substeps
    jpred.rollout_fn = make_ode_rollout(jpred.dynamics, jpred.dt, integrator, substeps)
    try:
        kernel = jctrl.optimizer._build_pallas_grad(interpret=True, tile_k=TILE)
        jax_cost, jax_dQ = map(np.asarray, kernel(jnp.asarray(s0), jnp.asarray(Q),
                                                  jnp.asarray(u_prev), jctrl._assemble_params()))
    finally:
        jpred.integrator, jpred.intermediate_steps, jpred.rollout_fn = saved

    model = dataclasses.replace(model, integrator=integrator, intermediate_steps=substeps)
    pvec = pack(params_from_numpy(jax_params_numpy(jctrl), CPU), torch.as_tensor(u_prev))
    s0_t, Q_t = torch.as_tensor(s0), torch.as_tensor(Q)
    cost, dQ = time_parallel_grad(model, s0_t, Q_t, pvec)
    ref_cost, ref_dQ = grad_cost_rollout_plain(model, s0_t, Q_t, pvec)
    mutants = stage_term_mutants(dQ, Q_t, pvec, model)
    record_property("k7_time_parallel_distances", {
        "dQ_max_abs_err": float((dQ - ref_dQ).abs().max()),
        "dQ_max_abs": float(ref_dQ.abs().max()),
        "mutant_max_abs_err": {k: float((m - ref_dQ).abs().max()) for k, m in mutants.items()}})
    torch.testing.assert_close(cost, ref_cost, **COST_TOL)
    assert within_dq_bound(dQ, ref_dQ)
    for name, mutant in mutants.items():
        assert not within_dq_bound(mutant, ref_dQ), name
    np.testing.assert_allclose(cost.numpy(), jax_cost, **COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), jax_dQ, **GRAD_TOL)


@pytest.mark.parametrize("integrator,substeps", INTEGRATOR_CASES)
def test_plain_gradient_matches_autograd_through_k1_plain(frictional, integrator, substeps):
    """The whole backward sweep, control-change coupling included, against
    autograd through K1's plain version — in float64."""
    model, p = frictional
    model = dataclasses.replace(model, integrator=integrator, intermediate_steps=substeps)
    pvec = torch.stack([p[k] for k in model.param_keys])
    rng = np.random.default_rng(3)
    s0 = torch.tensor(0.2 * rng.standard_normal((K, 4)))
    Q = torch.tensor(rng.uniform(-1.0, 1.0, (K, H, 1)), requires_grad=True)
    ref_cost = cost_rollout_plain(model, s0, Q, pvec)
    (ref_grad,) = torch.autograd.grad(ref_cost.sum(), Q)
    cost, dQ = grad_cost_rollout_plain(model, s0, Q.detach(), pvec)
    assert dQ.shape == (K, H, 1) and dQ.dtype == torch.float64
    torch.testing.assert_close(cost, ref_cost.detach(), rtol=0, atol=0)
    torch.testing.assert_close(dQ, ref_grad, **F64_TOL)


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_k7_plain_matches_pallas_grad_interpret(port, integrator):
    from control_toolkit_tpu.models.predictors import make_ode_rollout

    _, model, pack = port
    jctrl = make_jax_ctrl(K, H)
    jopt = jctrl.optimizer
    jpred = jopt.predictor.predictor
    jparams = jctrl._assemble_params()
    rng = np.random.default_rng(4)
    s0 = (0.2 * rng.standard_normal((K, 4))).astype(np.float32)
    Q = rng.uniform(-0.8, 0.8, (K, H, 1)).astype(np.float32)
    u_prev = np.array([0.1], np.float32)
    saved = jpred.integrator, jpred.rollout_fn
    jpred.integrator = integrator
    jpred.rollout_fn = make_ode_rollout(jpred.dynamics, jpred.dt, integrator, 1)
    try:
        kernel = jopt._build_pallas_grad(interpret=True, tile_k=TILE)
        ref_cost, ref_grad = map(np.asarray, kernel(jnp.asarray(s0), jnp.asarray(Q),
                                                    jnp.asarray(u_prev), jparams))
    finally:
        jpred.integrator, jpred.rollout_fn = saved

    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    model = dataclasses.replace(model, integrator=integrator)
    before = grad_cost_rollout.launches
    cost, dQ = grad_cost_rollout(model, torch.as_tensor(s0), torch.as_tensor(Q),
                                 pack(params, torch.as_tensor(u_prev)))
    assert grad_cost_rollout.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(cost.numpy(), ref_cost, **COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), ref_grad, **GRAD_TOL)


def test_control_change_coupling_matches_finite_differences(port):
    """Ported from test_pallas_grad.py's coupling test: the ccrc term ties
    u_h to stage h+1, and u_prev at h = 0; central differences of K1's
    plain version (float64) on one rollout pin the backward carry."""
    pctrl, model, pack = port
    Kc, Hc = 64, 8
    pvec = p64(model, pack, pctrl._assemble_params(), u_prev=0.25, c_ccrc_weight=5.0)
    s0 = torch.tensor([[0.1, 0.0, 0.2, 0.0]], dtype=torch.float64).expand(Kc, 4)
    Q = torch.full((Kc, Hc, 1), 0.3, dtype=torch.float64)
    Q[0, 3, 0] = -0.2
    _, dQ = grad_cost_rollout_plain(model, s0, Q, pvec)
    eps = 1e-6
    for h in (0, 3, Hc - 1):
        Qp, Qm = Q.clone(), Q.clone()
        Qp[0, h, 0] += eps
        Qm[0, h, 0] -= eps
        fd = (cost_rollout_plain(model, s0, Qp, pvec)[0]
              - cost_rollout_plain(model, s0, Qm, pvec)[0]) / (2 * eps)
        # Central differences in float64: truncation ~eps^2, rounding ~1e-16/eps.
        np.testing.assert_allclose(float(dQ[0, h, 0]), float(fd), rtol=1e-6, atol=1e-8)


def test_gradient_clip_adam_match_tf_fixture(port):
    """As test_tf_parity.py's gradient test: K7's gradient of the recorded
    batch, TF's clip_by_norm over axes [1, 2] and one Keras Adam step."""
    pctrl, _, _ = port
    g = np.load(GOLDEN)
    Kg, Hg = g["Q"].shape[:2]
    assert float(g["dt"]) == np.float32(0.02)
    model, pack = ode.rollout_model(make_port_ctrl(Kg, Hg).optimizer)
    params = {"dyn": pctrl._assemble_params()["dyn"],
              "cost": CartpoleQuadraticCost().current_params()["cost"],
              "attrs": {"target_position": float(g["target"])}}
    pvec = pack(params, torch.tensor([float(g["u_prev"])]))
    cost, grad = grad_cost_rollout(model, torch.as_tensor(g["s0"]), torch.as_tensor(g["Q"]), pvec)
    # The JAX package's bounds for the same fixture (test_tf_parity.py).
    np.testing.assert_allclose(cost.numpy(), g["costs"], rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(grad.numpy(), g["grad"], rtol=2e-3, atol=2e-3)
    clipped = clip_by_norm(grad, float(g["grad_clip"]), axes=(1, 2))
    np.testing.assert_allclose(clipped.numpy(), g["grad_clipped"], rtol=2e-3, atol=2e-3)
    state = adam_init(g["Q"].shape, CPU)
    state, delta = adam_update(state, torch.as_tensor(g["grad_clipped"]),
                               float(g["learning_rate"]), 0.9, 0.999, 1e-8)
    assert state.step == 1
    np.testing.assert_allclose((torch.as_tensor(g["Q"]) - delta).numpy(), g["q_after_adam"],
                               rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("integrator,substeps", INTEGRATOR_CASES)
def test_cuda_k7_matches_plain_version(port, cuda_device, integrator, substeps):
    """K7 against its plain version on the same card tensors, at a ragged
    K.  Tolerance: nvcc contracts a*b+c into FMA and the plain version does
    not, and the adjoint amplifies what the forward rounds; from near
    upright, dQ agrees to rtol 2e-5 and atol 5e-6 * max|dQ| (chip_smoke.py's
    bound, which a dropped stage-gradient term exceeds), the cost to K1's
    bounds."""
    pctrl, model, pack = port
    model = dataclasses.replace(model, integrator=integrator, intermediate_steps=substeps)
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)
    Kc, Hc = 1000, 50  # K not a multiple of the block: the edge is masked
    pvec = pack(pctrl._assemble_params(), torch.tensor([0.1])).to(dev)
    s0 = 0.05 * torch.randn(Kc, 4, generator=gen, device=dev)
    Q = 2.0 * torch.rand(Kc, Hc, 1, generator=gen, device=dev) - 1.0
    before = grad_cost_rollout.launches
    cost, dQ = grad_cost_rollout(model, s0, Q, pvec)
    assert grad_cost_rollout.launches == before + 1
    ref_cost, ref_dQ = grad_cost_rollout_plain(model, s0, Q, pvec)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dQ).all())
    torch.testing.assert_close(cost, ref_cost, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(dQ, ref_dQ, rtol=2e-5, atol=5e-6 * float(ref_dQ.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("Kc,Hc", [(8, 50), (33, 70)])
def test_cuda_k7_below_one_block_and_past_one_chunk(port, cuda_device, Kc, Hc):
    """K7 where K is below one adjoint block of rollouts or not a multiple
    of it, and H is more than one chunk of the adjoint's steps, to the
    same bounds as above."""
    pctrl, model, pack = port
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(1)
    pvec = pack(pctrl._assemble_params(), torch.tensor([0.1])).to(dev)
    s0 = 0.05 * torch.randn(Kc, 4, generator=gen, device=dev)
    Q = 2.0 * torch.rand(Kc, Hc, 1, generator=gen, device=dev) - 1.0
    cost, dQ = grad_cost_rollout(model, s0, Q, pvec)
    ref_cost, ref_dQ = grad_cost_rollout_plain(model, s0, Q, pvec)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dQ).all())
    torch.testing.assert_close(cost, ref_cost, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(dQ, ref_dQ, rtol=2e-5, atol=5e-6 * float(ref_dQ.abs().max()))
