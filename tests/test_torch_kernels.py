"""The port's two rollout kernels (K1 ``ops/cost_rollout.py``, K2
``ops/mppi_cost.py``; K7 has tests/test_torch_grad.py): their plain
versions against the JAX package's
Pallas kernels in interpret mode, the wrappers' dispatch rule, K2's
equality with K1 over its controls at cc_weight 0 and the bound that
rejects chip_smoke.py's wrong variants of K2 and K4, and — on a machine
with a CUDA card only — each CUDA kernel against its plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout, cost_rollout_plain
from control_toolkit_tpu_torch.ops.fused_cem import fused_cem_costs
from control_toolkit_tpu_torch.ops.fused_mppi import fused_mppi_costs, fused_mppi_weights
from control_toolkit_tpu_torch.ops.grad_cost_rollout import grad_cost_rollout
from control_toolkit_tpu_torch.ops.interpolation import interpolation_matrix
from control_toolkit_tpu_torch.ops.mppi_cost import (
    mppi_controls_plain, mppi_cost, mppi_cost_plain,
)
from control_toolkit_tpu_torch.ops.mppi_cost_cols import mppi_cost_cols_plain
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.utils.convert import params_from_numpy
from test_torch_mppi import CPU, COST_TOL, jax_params_numpy, make_jax_ctrl, make_port_ctrl

K, H, TILE = 256, 20, 128


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    """The JAX and port controllers with the JAX params tree in both forms."""
    jctrl, pctrl = make_jax_ctrl(K, H), make_port_ctrl(K, H)
    jparams = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                     jctrl._assemble_params())
    return jctrl, pctrl, jparams, params_from_numpy(jax_params_numpy(jctrl), CPU)


def test_packed_params_match_jax_order_and_values(pair):
    jctrl, pctrl, jparams, params = pair
    jkeys, jpack, *_ = jctrl.optimizer._soa_bindings()
    model, pack = ode.rollout_model(pctrl.optimizer)
    assert list(model.param_keys) == list(jkeys)
    u_prev = np.array([0.25], np.float32)
    np.testing.assert_array_equal(pack(params, torch.as_tensor(u_prev)).numpy(),
                                  np.asarray(jpack(jparams, jnp.asarray(u_prev))))


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_k1_plain_matches_pallas_interpret_and_fused_scan(pair, integrator):
    jctrl, pctrl, jparams, params = pair
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    jpred = jopt.predictor.predictor
    rng = np.random.default_rng(0)
    s_tiled = np.tile((0.1 * rng.standard_normal((1, 4))).astype(np.float32), (K, 1))
    Q = rng.uniform(-1.0, 1.0, (K, H, 1)).astype(np.float32)
    u_prev = np.array([0.25], np.float32)

    from control_toolkit_tpu.models.predictors import make_ode_rollout
    saved = jpred.integrator, jpred.rollout_fn
    jpred.integrator = integrator
    jpred.rollout_fn = make_ode_rollout(jpred.dynamics, jpred.dt, integrator, 1)
    try:
        pallas = jopt._build_pallas_cost(interpret=True, tile_k=TILE)
        ref_kernel = np.asarray(pallas(jnp.asarray(s_tiled), jnp.asarray(Q),
                                       jnp.asarray(u_prev), jparams))
        ref_scan = np.asarray(jopt._fused_cost(jnp.asarray(s_tiled), jnp.asarray(Q),
                                               jnp.asarray(u_prev), jparams))
    finally:
        jpred.integrator, jpred.rollout_fn = saved

    model, pack = ode.rollout_model(popt)
    model = dataclasses.replace(model, integrator=integrator)
    got = cost_rollout(model, torch.as_tensor(s_tiled), torch.as_tensor(Q),
                       pack(params, torch.as_tensor(u_prev))).numpy()
    np.testing.assert_allclose(got, ref_kernel, **COST_TOL)
    np.testing.assert_allclose(got, ref_scan, **COST_TOL)


def test_k1_cost_only_is_the_kernel_family_on_cpu(pair):
    _, pctrl, _, params = pair
    popt = pctrl.optimizer
    assert ode.can_use_cost(popt)
    rng = np.random.default_rng(3)
    s_tiled = torch.as_tensor(np.tile((0.1 * rng.standard_normal((1, 4))).astype(np.float32), (K, 1)))
    Q = torch.as_tensor(rng.uniform(-1.0, 1.0, (K, H, 1)).astype(np.float32))
    u_prev = torch.tensor([-0.3])
    before = cost_rollout.launches
    got = popt._make_cost_only()(s_tiled, Q, u_prev, params)
    assert cost_rollout.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), popt._fused_cost(s_tiled, Q, u_prev, params).numpy(),
                               **COST_TOL)


def test_k2_plain_matches_pallas_semi_fused_interpret(pair):
    from control_toolkit_tpu.ops.pallas_mppi import ROWS

    jctrl, pctrl, jparams, params = pair
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    _, jpack, _ = jopt._build_fused_mppi(interpret=True, tile_k=TILE, build_step=False)
    cost_run = jopt._last_fused_make_run.external(K)
    P, U = jopt.interp.number_of_interpolation_inducing_points, 1
    T, C = K // TILE, TILE // ROWS
    rng = np.random.default_rng(5)
    eps_tiles = (rng.standard_normal((T, U, P * ROWS, C)) * jopt.SQRTRHODTINV).astype(np.float32)
    s0 = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_nom = (0.1 * np.ones((H, U))).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    costs2d = np.asarray(cost_run(jnp.asarray(s0), jnp.asarray(u_nom),
                                  jpack(jparams, jnp.asarray(u_prev)), jnp.asarray(eps_tiles)))
    # Tile layout -> rollout order k = t*TILE + r*C + c, and eps -> [P, U, K].
    ref = costs2d.reshape(ROWS, T, C).transpose(1, 0, 2).reshape(K)
    eps = eps_tiles.reshape(T, U, P, ROWS, C).transpose(2, 1, 0, 3, 4).reshape(P, U, K)

    model, pack = ode.rollout_model(popt)
    got = mppi_cost(model, torch.as_tensor(s0), torch.as_tensor(u_nom),
                    pack(params, torch.as_tensor(u_prev)), torch.as_tensor(eps),
                    popt.interp.matrix, popt.action_low, popt.action_high,
                    popt.cc_weight, popt.R, popt.NU).numpy()
    np.testing.assert_allclose(got, ref, **COST_TOL)


def k2_operands(pair, H_: int, cc_weight: float = 1.0, K_: int = K, P1: bool = False,
                device=CPU) -> tuple:
    """K2's operands at horizon H_ (inducing period 10, as chip_smoke.py's:
    P=6 at H=50, P=14 at H=130, three 64-control chunks; ``P1``: the first
    inducing point alone), the noise and u_nom from a seed, the port
    controller's model and pvec."""
    _, pctrl, _, params = pair
    model, pack = ode.rollout_model(pctrl.optimizer)
    W = torch.as_tensor(interpolation_matrix(H_, 10))
    if P1:
        W = W[:1].contiguous()
    rng = np.random.default_rng(H_ + K_)
    eps = torch.tensor(0.3 * rng.standard_normal((W.shape[0], 1, K_)), dtype=torch.float32)
    u_nom = torch.tensor(rng.uniform(-0.5, 0.5, (H_, 1)), dtype=torch.float32)
    lim = torch.ones(1)
    operands = (model, torch.tensor([0.02, -0.1, 0.05, 0.1]), u_nom,
                pack(params, torch.tensor([0.1])), eps, W, -lim, lim, cc_weight, 1.0, 1000.0)
    return tuple(t.to(device) if torch.is_tensor(t) else t for t in operands)


@pytest.mark.parametrize("H_", [50, 130])
def test_k2_plain_at_cc_zero_is_k1_plain_over_its_controls(pair, H_):
    """At cc_weight 0, K2's plain version equals K1's plain version over
    mppi_controls_plain's controls of the same noise, bit for bit: the
    contract that lets chip_smoke.py require the card's K2 to equal K1
    there (share 1.0), at H=50 and over three 64-control chunks."""
    model, s0, u_nom, pvec, eps, W, low, high = k2_operands(pair, H_, cc_weight=0.0)[:8]
    u, _ = mppi_controls_plain(eps, W, u_nom, low, high)
    assert torch.equal(mppi_cost_plain(model, s0, u_nom, pvec, eps, W, low, high, 0.0, 1.0,
                                       1000.0),
                       cost_rollout_plain(model, s0.expand(K, -1), u, pvec))


@pytest.mark.parametrize("kind,H_", [("controls_one_step_early", 50),
                                     ("second_point_dropped", 50),
                                     ("next_rollout_eps", 50),
                                     ("bracket_restarted_each_chunk", 130),
                                     ("next_session_rows", 50)])
def test_k2_k4_mutants_are_rejected_by_the_kernel_bound(pair, kind, H_):
    """chip_smoke.py's wrong variants of K2 (``mppi_mutants``) and K4's
    session offset (``k4_mutants``), built from the plain versions, each
    outside KERNEL_TOL of them: the bound that phases 3 and 35 hold the
    card's kernels to rejects them (the chunk restart, which only a horizon
    past 64 steps shows, at H=130, where chip_smoke.py holds it to float64
    and this bound is the looser)."""
    from chip_smoke import KERNEL_TOL, k4_mutants, mppi_mutants

    args = k2_operands(pair, H_)
    if kind == "next_session_rows":
        model, s0, u_nom, pvec, eps, *consts = args
        B, rng = 4, np.random.default_rng(9)
        pvec_b = torch.stack([pvec] * B)  # the sessions differ in u_prev, s0 and noise
        pvec_b[:, model.param_keys.index("__u_prev_0")] = torch.linspace(-0.5, 0.5, B)
        cols = (model, torch.tensor(0.05 * rng.standard_normal((B, 4)), dtype=torch.float32),
                u_nom.expand(B, -1, -1).contiguous(), pvec_b,
                torch.tensor(0.3 * rng.standard_normal((B, *eps.shape)), dtype=torch.float32),
                *consts)
        ref, wrong = mppi_cost_cols_plain(*cols), k4_mutants(cols, (kind,))[kind]
    else:
        ref, wrong = mppi_cost_plain(*args), mppi_mutants(*args, (kind,))[kind]
    assert wrong.shape == ref.shape and bool(torch.isfinite(wrong).all())
    assert not torch.allclose(wrong, ref, **KERNEL_TOL)


def test_wrappers_never_run_plain_versions_on_non_cpu_tensors(pair):
    _, pctrl, _, _ = pair
    model, _ = ode.rollout_model(pctrl.optimizer)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cost_rollout(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
                     torch.empty(15, **meta))
    with pytest.raises(ValueError, match="several devices"):
        mppi_cost(model, torch.zeros(4), torch.zeros(5, 1), torch.zeros(15),
                  torch.empty(2, 1, 8, **meta), torch.zeros(2, 5), torch.zeros(1),
                  torch.zeros(1), 1.0, 1.0, 1000.0)
    before = grad_cost_rollout.launches
    with pytest.raises(ValueError, match="CUDA"):
        grad_cost_rollout(model, torch.empty(8, 4, **meta), torch.empty(8, 5, 1, **meta),
                          torch.empty(15, **meta))
    with pytest.raises(ValueError, match="several devices"):
        grad_cost_rollout(model, torch.zeros(8, 4), torch.empty(8, 5, 1, **meta),
                          torch.zeros(15))
    assert grad_cost_rollout.launches == before

    lim, seed2 = torch.ones(1), torch.tensor([1, 0], dtype=torch.int32)
    counts = (fused_cem_costs.launches, fused_mppi_costs.launches, fused_mppi_weights.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fused_cem_costs(model, torch.empty(4, **meta), torch.empty(5, 1, **meta),
                        torch.empty(5, 1, **meta), torch.empty(15, **meta),
                        torch.empty(2, dtype=torch.int32, **meta), torch.empty(1, **meta),
                        torch.empty(1, **meta), 16, 8)
    with pytest.raises(ValueError, match="several devices"):
        fused_cem_costs(model, torch.zeros(4), torch.empty(5, 1, **meta), torch.zeros(5, 1),
                        torch.zeros(15), seed2, -lim, lim, 16, 8)
    with pytest.raises(ValueError, match="several devices"):
        fused_mppi_costs(model, torch.zeros(4), torch.zeros(5, 1), torch.zeros(15), seed2,
                         torch.empty(2, 5, **meta), -lim, lim, 1.0, 1.0, 1000.0, 0.2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mppi_weights(torch.empty(2, dtype=torch.int32, **meta), torch.empty(16, **meta),
                           torch.empty(2, **meta), 2, 1, 100.0, 16, 8, fast=False)
    with pytest.raises(ValueError, match="tile_k"):  # K5's function needs K % tile_k == 0
        fused_cem_costs(model, torch.zeros(4), torch.zeros(5, 1), torch.zeros(5, 1),
                        torch.zeros(15), seed2, -lim, lim, 20, 8)
    assert counts == (fused_cem_costs.launches, fused_mppi_costs.launches,
                      fused_mppi_weights.launches)


def test_rollout_model_rejects_a_foreign_parameter_layout(pair):
    _, pctrl, _, _ = pair
    model, _ = ode.rollout_model(pctrl.optimizer)
    with pytest.raises(ValueError, match="layout"):
        dataclasses.replace(model, param_keys=model.param_keys[::-1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("integrator,substeps", [("rk4", 1), ("euler", 1), ("rk4", 2)])
def test_cuda_kernels_match_plain_versions(pair, cuda_device, integrator, substeps):
    """Each CUDA kernel against its plain version on the same card tensors.
    Tolerance: nvcc contracts a*b+c into FMA and the plain version does not;
    near upright the difference stays at float32 rounding level."""
    _, pctrl, _, params = pair
    model, pack = ode.rollout_model(pctrl.optimizer)
    model = dataclasses.replace(model, integrator=integrator, intermediate_steps=substeps)
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)
    Kc, Hc, P = 1000, 50, 6  # K not a multiple of the block: the edge is masked
    pvec = pack(params, torch.tensor([0.1])).to(dev)
    s0 = 0.05 * torch.randn(Kc, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(Kc, Hc, 1, generator=gen, device=dev), -1.0, 1.0)
    got = cost_rollout(model, s0, Q, pvec)
    torch.testing.assert_close(got, cost_rollout_plain(model, s0, Q, pvec), rtol=1e-4, atol=1e-3)

    W = torch.as_tensor(interpolation_matrix(Hc, 10), device=dev)
    eps = 0.2 * torch.randn(P, 1, Kc, generator=gen, device=dev)
    u_nom = torch.clamp(0.2 * torch.randn(Hc, 1, generator=gen, device=dev), -1.0, 1.0)
    lim = torch.ones(1, device=dev)
    args = (model, s0[0].contiguous(), u_nom, pvec, eps, W, -lim, lim, 1.0, 1.0, 1000.0)
    torch.testing.assert_close(mppi_cost(*args), mppi_cost_plain(*args), rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("Kc", [8, 1000])
def test_cuda_k1_at_ragged_k_and_a_long_horizon(pair, cuda_device, Kc):
    """K1 (short_step.cuh's step, its next control loaded ahead) at K below
    one block and not a multiple of it: within KERNEL_TOL of its plain
    version at H=50, and within chip_smoke.py's float64 bound
    (long_horizon_vs_float64) at H=130, where float32 rounding outgrows
    KERNEL_TOL."""
    from chip_smoke import KERNEL_TOL, long_horizon_vs_float64

    _, pctrl, _, params = pair
    model, pack = ode.rollout_model(pctrl.optimizer)
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(1)
    pvec = pack(params, torch.tensor([0.1])).to(dev)
    s0 = 0.05 * torch.randn(Kc, 4, generator=gen, device=dev)
    for Hc in (50, 130):
        Q = torch.clamp(0.3 * torch.randn(Kc, Hc, 1, generator=gen, device=dev), -1.0, 1.0)
        got = cost_rollout(model, s0, Q, pvec)
        if Hc == 50:
            torch.testing.assert_close(got, cost_rollout_plain(model, s0, Q, pvec), **KERNEL_TOL)
        else:
            long_horizon_vs_float64(model, s0, Q, pvec, {"k1": got})


@pytest.mark.cuda
@pytest.mark.parametrize("Kc", [8, 1000])
def test_cuda_k2_at_ragged_k_p1_and_a_long_horizon(pair, cuda_device, Kc):
    """K2 (mppi_ahead.cuh's body over eps) at K below one block and not a
    multiple of it: within KERNEL_TOL of its plain version at H=50, also
    with one inducing point (P=1); at cc_weight 0 equal to K1 over
    mppi_controls_plain's controls at H=50 and H=130 (three 64-control
    chunks); at H=130 within chip_smoke.py's float64 bounds
    (long_horizon_vs_float64, which must reject the bracket restarted at a
    chunk's head, and corr_vs_float64 at cc_weight 1), where float32
    rounding outgrows KERNEL_TOL."""
    from chip_smoke import (
        KERNEL_TOL, as_type, corr_vs_float64, k3_mutant_controls, long_horizon_vs_float64,
    )

    dev = cuda_device
    for P1 in (False, True):
        args = k2_operands(pair, 50, K_=Kc, P1=P1, device=dev)
        torch.testing.assert_close(mppi_cost(*args), mppi_cost_plain(*args), **KERNEL_TOL)
    for H_ in (50, 130):
        model, s0, u_nom, pvec, eps, W, low, high, *rest = k2_operands(pair, H_, 0.0, Kc,
                                                                       device=dev)
        got = mppi_cost(model, s0, u_nom, pvec, eps, W, low, high, *rest)
        u, _ = mppi_controls_plain(eps, W, u_nom, low, high)
        s_tiled = s0.expand(Kc, -1).contiguous()
        via_k1 = cost_rollout(model, s_tiled, u, pvec)
        assert torch.equal(got, via_k1)
        if H_ == 130:
            restarted, _ = k3_mutant_controls(eps, W, u_nom, low, high,
                                              "bracket_restarted_each_chunk")
            long_horizon_vs_float64(model, s_tiled, u, pvec, {"k2": got, "k1": via_k1},
                                    {"bracket_restarted_each_chunk": restarted})
            full = k2_operands(pair, H_, 1.0, Kc, device=dev)
            corr_vs_float64("K2", mppi_cost(*full), mppi_cost_plain(*full),
                            mppi_cost_plain(*as_type(full, torch.float64)))
