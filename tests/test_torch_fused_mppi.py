"""The port's fully-fused MPPI (K3, ``ops/fused_mppi.py``; the
``fully_fused`` path of ``optimizers/mppi.py``) against the JAX package's
two-pass ``kernel_step`` in interpret mode (tile 64), fed the same seed;
and pass 1's controls (``mppi_controls_plain``), its equality with K1's
costs over them at cc_weight 0 and its bound against four wrong variants.

Costs to rtol 1e-5 (the same controls: the interpolation rounds as the
JAX matmul does up to an FMA, over 20 rk4 steps); the new plan elementwise
to UNOM_TOL (the port sums the weighted noise at the inducing points and
interpolates once, the JAX kernel sums the interpolated perturbations).
On a machine with a card, each pass is held to its plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout, cost_rollout_plain
from control_toolkit_tpu_torch.ops.fused_mppi import (
    WEIGHT_BLOCK, fused_mppi_costs, fused_mppi_costs_plain, fused_mppi_step, fused_mppi_step_plain,
    fused_mppi_weights, fused_mppi_weights_plain, mppi_noise,
)
from control_toolkit_tpu_torch.ops.interpolation import interpolation_matrix
from control_toolkit_tpu_torch.ops.mppi_cost import mppi_controls_plain
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.utils.convert import mppi_state_from_numpy, params_from_numpy
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import (
    CPU, UNOM_TOL, jax_params_numpy, make_jax_ctrl, make_port_ctrl, optimizer_config,
)

K, H, TILE = 256, 20, 64
K3_COST_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def step_inputs(seed=0):
    rng = np.random.default_rng(seed)
    s0 = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_nom = rng.uniform(-0.5, 0.5, (H, 1)).astype(np.float32)
    return s0, u_nom, np.array([0.2], np.float32)


def controllers(limits):
    """The JAX and port MPPI controllers of test_torch_mppi.py at ``limits``."""
    if limits is None:
        return make_jax_ctrl(K, H), make_port_ctrl(K, H)
    made = []
    for cls in (JaxMPC, MPCController):
        port = {"device": "cpu"} if cls is MPCController else {}
        ctrl = cls("cartpole", limits, {"target_position": 0.3},
                   config={"optimizer": "mppi", "controller_logging": False, **port})
        ctrl.configure(optimizer_name="mppi", optimizer_config=optimizer_config(K, H))
        made.append(ctrl)
    return made


def jax_and_port_step(limits=None, seed=1234567, u_scale=1.0):
    """One fused step of each package from the same state, params and seed."""
    jctrl, pctrl = controllers(limits)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    kernel_step, jpack, _ = jopt._build_fused_mppi(interpret=True, tile_k=TILE)
    jparams = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), jctrl._assemble_params())
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    s0, u_nom, u_prev = step_inputs()
    u_nom = u_scale * u_nom
    un_j, c_j = kernel_step(jnp.asarray(s0), jnp.asarray(u_nom), jpack(jparams, jnp.asarray(u_prev)),
                            jnp.array([seed], jnp.int32))
    model, pack = ode.rollout_model(popt)
    un_p, c_p = fused_mppi_step(
        model, torch.tensor(s0), torch.tensor(u_nom), pack(params, torch.tensor(u_prev)),
        torch.tensor([seed, 0], dtype=torch.int32), popt.interp.matrix, popt.action_low,
        popt.action_high, popt.cc_weight, popt.R, popt.NU, popt.LBD, popt.SQRTRHODTINV, K, TILE)
    return (np.asarray(un_j), np.asarray(c_j)), (un_p.numpy(), c_p.numpy()), (popt, u_nom)


@pytest.mark.parametrize("seed", [1234567, 2**31 - 2])
def test_fused_step_plain_matches_pallas_interpret(seed):
    (un_j, c_j), (un_p, c_p), (_, u_nom) = jax_and_port_step(seed=seed)
    np.testing.assert_allclose(c_p, c_j, **K3_COST_TOL)
    np.testing.assert_allclose(un_p, un_j, **UNOM_TOL)
    assert np.abs(un_j - u_nom).max() > 1e-3  # the update moved the plan


def test_fused_step_asymmetric_bounds():
    """Bounds [-0.2, 1.0] (test_pallas_mppi.py:131 analog, at cartpole's one
    input): the clip inside pass 1 and the update's clip use them."""
    limits = (np.array([-0.2], np.float32), np.array([1.0], np.float32))
    (un_j, c_j), (un_p, c_p), _ = jax_and_port_step(limits=limits, u_scale=2.0)
    np.testing.assert_allclose(c_p, c_j, **K3_COST_TOL)
    np.testing.assert_allclose(un_p, un_j, **UNOM_TOL)
    assert un_p.min() >= -0.2 and un_p.max() <= 1.0
    assert (un_p == -0.2).any() or (un_p == 1.0).any()


def test_weights_plain_is_the_block_sums_of_the_weighted_noise():
    """Pass 2 in blocks of WEIGHT_BLOCK rollouts (K not a multiple: the last
    block is short), summed: the softmax-weighted noise sum."""
    Kw, P, U, tile = 40 * 8, 3, 1, 40
    seed2 = torch.tensor([31, 0], dtype=torch.int32)
    cost = torch.linspace(5.0, 50.0, Kw)
    rho = cost.min()
    red = torch.stack([rho, torch.exp(-(cost - rho) / 10.0).sum()])
    partials = fused_mppi_weights(seed2, cost, red, P, U, 10.0, Kw, tile, fast=False)
    assert partials.shape == (-(-Kw // WEIGHT_BLOCK), P, U)
    w = torch.exp(-(cost - rho) / 10.0) / red[1]
    ref = (mppi_noise(seed2, Kw, P, U, tile, fast=False) * w).sum(-1)
    torch.testing.assert_close(partials.sum(0), ref, rtol=1e-5, atol=1e-6)


def test_optimizer_fully_fused_step_matches_jax():
    """The optimizer's fused update, fed the JAX step's seed (re-split from
    its key), against the JAX step forced onto its fused path in interpret
    mode; the port's gate admits the tile."""
    jctrl, pctrl = make_jax_ctrl(K, H, fully_fused=True), make_port_ctrl(K, H, fully_fused=True)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert not popt._can_fully_fuse() and popt._uses_semi_fused()  # K % 2048 != 0
    jopt._can_fully_fuse = lambda: True
    build = jopt._build_fused_mppi
    jopt._build_fused_mppi = lambda **kw: build(interpret=True, tile_k=TILE, **kw)
    jopt._build()
    popt.fused_tile_k = TILE
    popt._build()
    assert popt._can_fully_fuse() and not popt._uses_semi_fused()
    _, u_nom, u_prev = step_inputs(2)
    jopt.opt_state = jopt.opt_state._replace(u_nom=jnp.asarray(u_nom[None]),
                                             u_prev=jnp.asarray(u_prev))
    popt.opt_state = mppi_state_from_numpy(u_nom[None], u_prev, popt.opt_state.generator)
    _, sub = jax.random.split(jopt.opt_state.key)
    seed = int(jax.random.randint(sub, (1,), 0, 2**31 - 1, dtype=jnp.int32)[0])
    drawn = popt.sample_noise(popt.opt_state)
    assert drawn.dtype == torch.int32 and drawn.shape == (2,) and int(drawn[1]) == 0
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_jax = jctrl.step(s)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    u, state, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params,
                                 torch.tensor([seed, 0], dtype=torch.int32))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)
    assert diag["J_logged"].shape == (K,)
    np.testing.assert_array_equal(state.u_prev.numpy(), u.numpy())


@pytest.mark.parametrize("extra", [{"weighting": "rank"}, {"bounded_update": True},
                                   {"semi_fused": False}])
def test_fully_fused_gate_takes_the_jax_paths(extra):
    """Where the gate is false, ``fully_fused`` takes the path the JAX gate
    leaves it: rank weighting the semi-fused one, ``bounded_update`` the
    modular one; ``semi_fused: false`` does not stop the fused path."""
    popt = make_port_ctrl(K, H, fully_fused=True, **extra).optimizer
    popt.fused_tile_k = TILE
    popt._build()
    fused = "semi_fused" in extra
    assert popt._can_fully_fuse() == fused
    assert (popt._noise_shape is None) == fused
    if not fused:
        assert popt._uses_semi_fused() == ("weighting" in extra)


def test_fused_controller_ticks_hold_the_pole():
    """A closed loop over the fused path (K3's plain versions), as
    test_pallas_mppi.py:77 runs the JAX kernel step: 50 ticks from
    CartpoleEnv(seed=3), H=25."""
    from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv

    pctrl = make_port_ctrl(K, 25, fully_fused=True)
    pctrl.optimizer.fused_tile_k = TILE
    pctrl.optimizer._build()
    env = CartpoleEnv(batch_size=1, dt=0.02, seed=3)
    s, _ = env.reset()
    for _ in range(50):
        s, *_ = env.step(pctrl.step(s[0]))
    assert abs(float(s[0, 2])) < 0.2, f"fused MPPI lost the pole: {s[0]}"


def pass1_args(H_: int, cc_weight: float = 1.0, K_: int = K, tile: int = TILE, device=CPU):
    """Pass 1's operands at horizon H_ (inducing period 10, as
    chip_smoke.py's: P=6 at H=50, P=14 at H=130, three 64-control chunks):
    the port's controller's model and pvec, u_nom and s0 from a seed."""
    pctrl = make_port_ctrl(64, 10)
    model, pack = ode.rollout_model(pctrl.optimizer)
    rng = np.random.default_rng(H_)
    u_nom = torch.tensor(rng.uniform(-0.5, 0.5, (H_, 1)), dtype=torch.float32, device=device)
    W = torch.as_tensor(interpolation_matrix(H_, 10), device=device)
    lim = torch.ones(1, device=device)
    return (model, torch.tensor([0.02, -0.1, 0.05, 0.1], device=device), u_nom,
            pack(pctrl._assemble_params(), torch.tensor([0.1])).to(device),
            torch.tensor([77, 2], dtype=torch.int32, device=device), W, -lim, lim, cc_weight, 1.0,
            1000.0, 0.2, K_, tile)


@pytest.mark.parametrize("H_", [20, 50, 130])
def test_mppi_controls_plain_reproduces_the_controls_of_the_cost(H_):
    """mppi_controls_plain's (u, d) equal, bit for bit, those of the bracket
    walk that mppi_cost_plain (and so pass 1's plain version) ran inline
    before it was factored out: the left bracket moved right where its
    weight has dropped to zero, d = W[p0,h] eps[p0] + W[p0+1,h] eps[p0+1],
    u = clamp(u_nom + d)."""
    _, _, u_nom, _, seed2, W, low, high, *_ = pass1_args(H_)
    P = W.shape[0]
    eps = mppi_noise(seed2, K, P, 1, TILE, fast=False) * 0.2
    u, d = mppi_controls_plain(eps, W, u_nom, low, high)
    Wl, p0 = W.tolist(), 0
    for h in range(H_):
        while p0 + 1 < P and Wl[p0][h] == 0.0:
            p0 += 1
        ref_d = W[p0, h] * eps[p0, 0]
        if p0 + 1 < P:
            ref_d = ref_d + W[p0 + 1, h] * eps[p0 + 1, 0]
        assert torch.equal(d[:, h, 0], ref_d)
        assert torch.equal(u[:, h, 0], torch.clamp(u_nom[h, 0] + ref_d, low[0], high[0]))
    assert u.shape == d.shape == (K, H_, 1)


@pytest.mark.parametrize("H_", [50, 130])
def test_pass1_plain_at_cc_zero_is_k1_plain_over_its_controls(H_):
    """At cc_weight 0, pass 1's plain version equals K1's plain version over
    mppi_controls_plain's controls of the same noise, bit for bit: the
    contract that lets chip_smoke.py require the card's pass 1 to equal K1
    there (share 1.0), so that check holds the draws and the
    interpolation."""
    args = pass1_args(H_, cc_weight=0.0)
    model, s0, u_nom, pvec, seed2, W, low, high = args[:8]
    u, _ = mppi_controls_plain(mppi_noise(seed2, K, W.shape[0], 1, TILE, fast=False) * 0.2, W,
                               u_nom, low, high)
    assert torch.equal(fused_mppi_costs_plain(*args),
                       cost_rollout_plain(model, s0.expand(K, -1), u, pvec))


@pytest.mark.parametrize("kind,H_", [("controls_one_step_early", 50),
                                     ("second_point_dropped", 50),
                                     ("next_rollout_counters", 50),
                                     ("bracket_restarted_each_chunk", 130)])
def test_pass1_mutants_are_rejected_by_the_kernel_bound(kind, H_):
    """chip_smoke.py's wrong variants of pass 1 (``k3_mutants``), built
    from the plain version, each outside KERNEL_TOL of it: the bound that
    phase 28 holds the card's pass 1 to at H=50 rejects them (the chunk
    restart, which only a horizon past 64 steps shows, at H=130)."""
    from chip_smoke import KERNEL_TOL, k3_mutants

    args = pass1_args(H_)
    ref = fused_mppi_costs_plain(*args)
    wrong = k3_mutants(args, (kind,))[kind]
    assert wrong.shape == ref.shape and bool(torch.isfinite(wrong).all())
    assert not torch.allclose(wrong, ref, **KERNEL_TOL)


@pytest.mark.cuda
def test_cuda_k3_passes_match_plain_versions(cuda_device):
    """Each pass against its plain version on the same card tensors (K not a
    multiple of the block), pass 2 after the block sum, and the whole step;
    pass 1 at cc_weight 0 equal to K1 over mppi_controls_plain's controls,
    at H=50 and at H=130 (three 64-control chunks), and at H=130 within
    twice the float32 plain version's distance from float64 (correct
    float32 drifts past KERNEL_TOL over 130 steps)."""
    pctrl = make_port_ctrl(64, 10)
    model, pack = ode.rollout_model(pctrl.optimizer)
    dev = cuda_device
    Kc, Hc, tile = 1000 * 8, 50, 400
    W = torch.as_tensor(interpolation_matrix(Hc, 10), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    u_nom = torch.clamp(0.2 * torch.randn(Hc, 1, generator=gen, device=dev), -1.0, 1.0)
    pvec = pack(pctrl._assemble_params(), torch.tensor([0.1])).to(dev)
    s0 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=dev)
    seed2 = torch.tensor([77, 2], dtype=torch.int32, device=dev)
    lim = torch.ones(1, device=dev)
    args = (model, s0, u_nom, pvec, seed2, W, -lim, lim, 1.0, 1.0, 1000.0, 0.2, Kc, tile)
    cost = fused_mppi_costs(*args)
    torch.testing.assert_close(cost, fused_mppi_costs_plain(*args), rtol=1e-4, atol=1e-3)
    rho = cost.min()
    red = torch.stack([rho, torch.exp(-(cost - rho) / 100.0).sum()])
    P = W.shape[0]
    got = fused_mppi_weights(seed2, cost, red, P, 1, 100.0, Kc, tile, fast=False)
    torch.testing.assert_close(got.sum(0), fused_mppi_weights_plain(seed2, cost, red, P, 1, 100.0,
                                                                    Kc, tile, fast=False).sum(0),
                               rtol=1e-4, atol=1e-6)
    step = (model, s0, u_nom, pvec, seed2, W, -lim, lim, 1.0, 1.0, 1000.0, 100.0, 0.2, Kc, tile)
    un, c = fused_mppi_step(*step)
    un_p, c_p = fused_mppi_step_plain(*step)
    torch.testing.assert_close(c, c_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(un, un_p, rtol=1e-4, atol=1e-5)
    for H_ in (50, 130):
        for cc_weight in (0.0, 1.0):
            a = pass1_args(H_, cc_weight, Kc, tile, dev)
            got = fused_mppi_costs(*a)
            if cc_weight == 0.0:
                u, _ = mppi_controls_plain(mppi_noise(a[4], Kc, a[5].shape[0], 1, tile,
                                                      fast=False) * 0.2,
                                           a[5], a[2], a[6], a[7])
                assert torch.equal(got, cost_rollout(a[0], a[1].expand(Kc, -1).contiguous(), u,
                                                     a[3]))
            f64 = tuple(t.double() if torch.is_tensor(t) and t.is_floating_point() else t
                        for t in a)
            ref64 = fused_mppi_costs_plain(*f64)
            plain_dist = float((fused_mppi_costs_plain(*a).double() - ref64).abs().max())
            bound = 2.0 * plain_dist + 1e-6 * float(ref64.abs().max())
            assert float((got.double() - ref64).abs().max()) <= bound
