"""The port's fleet CEM path against the JAX package: K6
(``ops/fused_cem_cols.py``), its elite regeneration ``regen_cols`` and the
batched fully-fused CEM step.

K6's plain version is held to the JAX kernel ``build_fused_cem_cols`` in
interpret mode (B sessions, K=128, H=10, JAX tile 128, as
tests/test_pallas_cem.py) with per-session states, distributions,
targets, previous controls, pole lengths and seeds: costs to rtol 3e-5,
atol 1e-4 (test_pallas_cem.py:208).  The counters of ``regen_cols`` equal
the JAX formula's exactly (uint32 arithmetic, pallas_cem.py:321-332), the
controls JAX's ``regen_cols`` to NORMAL_ATOL (an ulp of log or cos).  One
whole batched step fed the JAX seeds is held to the JAX step: u, mue and
std to 2e-4.  K6's step (csrc/short_step.cuh, K1's and K5's) in float32
over regen_cols' controls is held to the plain version's bound at H=35
and to the float64 bound at H=130, and the bound rejects draws made with
the next session's seed.  On a machine with a card, K6 is held to its
plain version, to float64 at H=130, and to K1 over its regenerated
controls, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.ops.pallas_cem import build_fused_cem_cols
from control_toolkit_tpu.optimizers.cem import CEMState as JaxCEMState
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout
from control_toolkit_tpu_torch.ops.counter_prng import FNV, MASK
from control_toolkit_tpu_torch.ops.fused_cem_cols import (
    cols_counters, fused_cem_cols, fused_cem_cols_plain, regen_cols,
)
from control_toolkit_tpu_torch.ops.mppi_cost_cols import per_rollout
from control_toolkit_tpu_torch.ops.neural_rollout import plain_cost_loop
from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
from control_toolkit_tpu_torch.optimizers.cem import CEMState
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from test_torch_cem import both_params, cem_config, make_pair
from test_torch_fleet import fleet, fleet_states
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import CPU
from test_torch_prng import NORMAL_ATOL

K, H, TILE, ROWS = 128, 10, 128, 8
K6_TOL = dict(rtol=3e-5, atol=1e-4)
STEP_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    jctrl, pctrl = make_pair(**cem_config(K=K, H=H, fully_fused=True))
    return (jctrl, pctrl) + both_params(jctrl)


def sessions(B, seed=3):
    """Per-session operands, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    return {
        "s": rng.uniform(-0.3, 0.3, (B, 4)).astype(np.float32),
        "mue": rng.uniform(-0.2, 0.2, (B, H, 1)).astype(np.float32),
        "std": rng.uniform(0.2, 0.6, (B, H, 1)).astype(np.float32),
        "u_prev": rng.uniform(-0.5, 0.5, (B, 1)).astype(np.float32),
        "target": np.linspace(-0.4, 0.4, B).astype(np.float32),
        "L": np.linspace(0.4, 0.6, B).astype(np.float32),
        "seed": np.array([1234, 98765, 2**31 - 2, 7][:B], np.int32),
    }


def port_pvec_b(popt, params, x):
    model, _ = ode.rollout_model(popt)
    _, slot_keys = split_slot_keys(model.param_keys, ("L",))
    B = x["s"].shape[0]
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B, CPU)(
        torch.tensor(x["u_prev"]), dict(params["dyn"], L=torch.tensor(x["L"])), params["cost"],
        {"target_position": torch.tensor(x["target"])})
    return model, pvec_b


def jax_cols(jopt, B):
    param_keys, _, derivs, stage_soa, terminal_soa, pred = jopt._soa_bindings()
    slot_keys = [k for k in param_keys if k.startswith(("a_", "__u_prev_")) or k == "d_L"]
    make_run_cols, regen = build_fused_cem_cols(
        derivs, stage_soa, terminal_soa, num_states=4, num_controls=1, horizon=H,
        param_keys=param_keys, slot_keys=slot_keys, action_low=jopt.action_low,
        action_high=jopt.action_high, k_per_session=K, integrator=pred.integrator,
        intermediate_steps=pred.intermediate_steps, tile_k=TILE, interpret=True)
    return make_run_cols(B * K, pred.dt), regen, param_keys, slot_keys


@pytest.mark.parametrize("B", [2, 4])
def test_k6_plain_matches_pallas_cols(pair, B):
    jctrl, pctrl, jparams, params = pair
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions(B)
    run, _, param_keys, slot_keys = jax_cols(jopt, B)
    cps, T, C = K // ROWS, (B * K) // TILE, TILE // ROWS

    def expand_cols(vals):  # [B, n] -> [T, n, C]
        return jnp.repeat(vals, cps, axis=0).reshape(T, C, vals.shape[1]).transpose(0, 2, 1)

    shared = [k for k in param_keys if k not in slot_keys]
    pvec = jnp.stack([jnp.asarray(jparams["dyn"][k[2:]] if k.startswith("d_")
                                  else jparams["cost"][k[2:]], jnp.float32) for k in shared])
    slot_vals = {"a_target_position": x["target"], "d_L": x["L"], "__u_prev_0": x["u_prev"][:, 0]}
    rows = jnp.stack([jnp.asarray(slot_vals[k]) for k in slot_keys], axis=1)
    seedcw = jnp.stack([jnp.repeat(jnp.asarray(x["seed"]), cps),
                        jnp.tile(jnp.arange(cps, dtype=jnp.int32), B)],
                       axis=1).reshape(T, C, 2).transpose(0, 2, 1)
    costs2d = run(pvec, expand_cols(jnp.asarray(x["s"])),
                  expand_cols(jnp.asarray(x["mue"].reshape(B, H))),
                  expand_cols(jnp.asarray(x["std"].reshape(B, H))), expand_cols(rows), seedcw)
    ref = np.asarray(costs2d).reshape(ROWS, B, cps).transpose(1, 0, 2).reshape(B, K)
    model, pvec_b = port_pvec_b(popt, params, x)
    got = fused_cem_cols(model, torch.tensor(x["s"]), torch.tensor(x["mue"]),
                         torch.tensor(x["std"]), pvec_b, torch.tensor(x["seed"]),
                         popt.action_low, popt.action_high, K)
    assert got.shape == (B, K)
    np.testing.assert_allclose(got.numpy(), ref, **K6_TOL)


def test_regen_cols_counters_and_controls_match_jax(pair):
    """The counters in uint32 as the JAX formula computes them, exactly; the
    controls against JAX's ``regen_cols``; an elite subset a bit-exact
    subset of the full regeneration."""
    jctrl, pctrl, _, _ = pair
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    B = 4
    x = sessions(B, seed=5)
    idx = np.stack([np.random.default_rng(b).permutation(K)[:24] for b in range(B)])
    got = cols_counters(torch.tensor(x["seed"]), torch.tensor(idx), K, H, 1).numpy() & MASK
    cps = np.uint32(K // ROWS)
    r, cw = (idx // cps).astype(np.uint32), (idx % cps).astype(np.uint32)
    h = np.arange(H, dtype=np.uint32)
    with np.errstate(over="ignore"):
        ref = (x["seed"].astype(np.uint32)[:, None, None] * np.uint32(FNV)
               + (h[None, None, :] * np.uint32(ROWS) + r[:, :, None]) * cps + cw[:, :, None])
    np.testing.assert_array_equal(got[..., 0], ref.astype(np.int64))
    _, regen, _, _ = jax_cols(jopt, B)
    std = 3.0 * x["std"]  # heavy clipping: both bounds reached
    Q = regen_cols(torch.tensor(x["seed"]), torch.tensor(idx), torch.tensor(x["mue"]),
                   torch.tensor(std), popt.action_low, popt.action_high, K, fast=False).numpy()
    for b in range(B):
        ref_q = np.asarray(regen(jnp.asarray(x["seed"][b]), jnp.asarray(idx[b]),
                                 jnp.asarray(x["mue"][b]), jnp.asarray(std[b])))
        np.testing.assert_allclose(Q[b], ref_q, rtol=0, atol=NORMAL_ATOL)
    assert Q.min() == -1.0 and Q.max() == 1.0
    full = regen_cols(torch.tensor(x["seed"]), torch.arange(K).expand(B, K),
                      torch.tensor(x["mue"]), torch.tensor(std), popt.action_low,
                      popt.action_high, K, fast=False).numpy()
    np.testing.assert_array_equal(np.take_along_axis(full, idx[:, :, None, None], axis=1), Q)


def test_k6_is_independent_of_b(pair):
    """The first two sessions of a 4-session launch and a 2-session one."""
    _, pctrl, _, params = pair
    popt = pctrl.optimizer
    x4 = sessions(4)
    x2 = {k: v[:2] for k, v in x4.items()}
    costs = []
    for x in (x4, x2):
        model, pvec_b = port_pvec_b(popt, params, x)
        costs.append(fused_cem_cols(model, torch.tensor(x["s"]), torch.tensor(x["mue"]),
                                    torch.tensor(x["std"]), pvec_b, torch.tensor(x["seed"]),
                                    popt.action_low, popt.action_high, K))
    assert torch.equal(costs[0][:2], costs[1])


def test_one_batched_fused_cem_step_matches_jax(pair):
    """One step of the JAX batched fused CEM (K6 in interpret mode) and the
    port's ``update`` fed the JAX seeds: per slot and outer iteration,
    ``key, sub = split(key)`` and a ``randint`` seed, as the JAX step
    draws them."""
    jctrl, pctrl, jparams, params = pair
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    B, its = 4, jopt.cem_outer_it
    x = sessions(B, seed=9)
    jstep = jopt._make_batched_fused_cem_step(B, interpret=True, tile_k=TILE, per_slot_dyn=("L",))
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(2), i) for i in range(B)])
    jstates = JaxCEMState(key=keys, dist_mue=jnp.asarray(x["mue"])[:, None],
                          stdev=jnp.asarray(x["std"])[:, None],
                          count=jnp.ones((B,), jnp.int32), u_prev=jnp.asarray(x["u_prev"]))
    u_j, new_j, costs_j = jstep(jstates, jnp.asarray(x["s"])[:, None],
                                dict(jparams["dyn"], L=jnp.asarray(x["L"])), jparams["cost"],
                                {"target_position": jnp.asarray(x["target"])})
    seeds = np.zeros((its, B), np.int32)
    for b in range(B):
        key = keys[b]
        for i in range(its):
            key, sub = jax.random.split(key)
            seeds[i, b] = int(jax.random.randint(sub, (), 0, 2**31 - 1, jnp.int32))
    _, update = popt._make_batched_fused_cem_step(B, per_slot_dyn=("L",))
    states = CEMState(generator=(None,) * B, dist_mue=torch.tensor(x["mue"])[:, None],
                      stdev=torch.tensor(x["std"])[:, None], count=np.ones(B, np.int64),
                      u_prev=torch.tensor(x["u_prev"]))
    u, new, costs = update(states, torch.tensor(x["s"])[:, None],
                           dict(params["dyn"], L=torch.tensor(x["L"])), params["cost"],
                           {"target_position": torch.tensor(x["target"])}, torch.tensor(seeds))
    np.testing.assert_allclose(costs.numpy(), np.asarray(costs_j), **K6_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(new.dist_mue.numpy(), np.asarray(new_j.dist_mue), rtol=0,
                               atol=STEP_ATOL)
    np.testing.assert_allclose(new.stdev.numpy(), np.asarray(new_j.stdev), rtol=0, atol=STEP_ATOL)
    np.testing.assert_array_equal(new.count, np.asarray(new_j.count))
    np.testing.assert_array_equal(new.u_prev.numpy(), u.numpy())


def cem_fleet(num_slots):
    return fleet(num_slots, optimizer="cem-tf", per_slot_dyn=("L",), fully_fused=True,
                 cem_best_k=16)


def test_cem_fleet_results_do_not_depend_on_b():
    c4, c2 = cem_fleet(4), cem_fleet(2)
    for c in (c4, c2):
        c.update_slot_dyn(1, {"L": 0.6})
        c.update_slot_attributes(0, {"target_position": 0.2})
    s = fleet_states(4)
    for _ in range(2):
        u4, u2 = c4.step_batch(s), c2.step_batch(s[:2])
        np.testing.assert_allclose(u2, u4[:2], atol=1e-6)
        s = s + 0.01


def test_cem_fleet_freezes_masked_slots():
    """A masked-off CEM slot keeps its distribution, tick count, previous
    control and random stream exactly and commands 0."""
    ctrl = cem_fleet(4)
    s = fleet_states(4)
    ctrl.step_batch(s)
    before = ctrl.slot_states
    gens = [g.get_state() for g in before.generator]
    mask = np.array([False, True, True, False])
    u = ctrl.step_batch(s, mask)
    after = ctrl.slot_states
    assert np.all(u[~mask] == 0.0) and np.all(u[mask] != 0.0)
    np.testing.assert_array_equal(after.count, [1, 2, 2, 1])
    for i in (0, 3):
        for field in ("dist_mue", "stdev", "u_prev"):
            assert torch.equal(getattr(after, field)[i], getattr(before, field)[i])
        assert torch.equal(after.generator[i].get_state(), gens[i])
    ctrl.reset_slot(1)
    assert after.count[1] == 2 and ctrl.slot_states.count[1] == 0


def test_batched_fused_cem_needs_k_a_multiple_of_8(pair):
    """K6's counter layout orders a session's rollouts as k = r*(K/8) + cw."""
    _, pctrl = make_pair(**cem_config(K=100, H=H, cem_best_k=8))
    with pytest.raises(ValueError, match="K % 8"):
        pctrl.optimizer._make_batched_fused_cem_step(2)
    popt, params = pair[1].optimizer, pair[3]
    x = sessions(2)
    model, pvec_b = port_pvec_b(popt, params, x)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_cem_cols(model, torch.tensor(x["s"]), torch.tensor(x["mue"]),
                       torch.tensor(x["std"]), pvec_b, torch.tensor(x["seed"]),
                       popt.action_low, popt.action_high, 100)


def k6_step_operands(pair, Hc, B=4, Kc=512):
    """chip_smoke.py phase 36's kind of operands at B sessions of K=Kc over
    a horizon of Hc, made with numpy: states 0.05 N(0, 1), mue 0.2 N(0, 1)
    clipped, std 0.5, per-session pole lengths, targets, previous controls
    and seeds: fused_cem_cols' arguments."""
    _, pctrl, _, params = pair
    popt = pctrl.optimizer
    rng = np.random.default_rng(36)
    x = {"s": (0.05 * rng.standard_normal((B, 4))).astype(np.float32),
         "u_prev": rng.uniform(-1.0, 1.0, (B, 1)).astype(np.float32),
         "target": np.linspace(-0.2, 0.2, B).astype(np.float32),
         "L": np.linspace(0.35, 0.65, B).astype(np.float32)}
    model, pvec_b = port_pvec_b(popt, params, x)
    s0 = torch.tensor(x["s"])
    mue = torch.tensor(np.clip(0.2 * rng.standard_normal((B, Hc, 1)), -1.0, 1.0),
                       dtype=torch.float32)
    std = torch.full((B, Hc, 1), 0.5)
    seed_b = torch.tensor(rng.integers(0, 2**31 - 1, B), dtype=torch.int32)
    return model, s0, mue, std, pvec_b, seed_b, popt.action_low, popt.action_high, Kc


def k6_short_step(args, seed_b=None):
    """K6's step in float32 (test_torch_cem.py short_step_fn: K5's and
    K1's, csrc/short_step.cuh) over the controls regen_cols draws with
    ``seed_b`` (default: the sessions' own), each session's parameters a
    rollout; and the float32 rollout operands."""
    from test_torch_cem import short_step_fn

    model, s0, mue, std, pvec_b, own, low, high, Kc = args
    B, Hc = mue.shape[0], mue.shape[1]
    idx = torch.arange(Kc).expand(B, Kc)
    Q = regen_cols(own if seed_b is None else seed_b, idx, mue, std, low, high, Kc, fast=False)
    s_rows, rows, Q = per_rollout(s0, Kc).T, per_rollout(pvec_b, Kc), Q.reshape(B * Kc, Hc, 1)
    cost = plain_cost_loop(model, s_rows, Q, rows, short_step_fn(model, rows))
    return cost.reshape(B, Kc), (model, s_rows, Q, rows)


def test_k6_short_step_stays_within_the_kernel_bound(pair, record_property):
    """K6's step over regen_cols' controls at the fleet's H=35 (B=4,
    K=512) stays within KERNEL_TOL of fused_cem_cols_plain."""
    from chip_smoke import KERNEL_TOL

    args = k6_step_operands(pair, 35)
    got, _ = k6_short_step(args)
    ref = fused_cem_cols_plain(*args)
    record_property("k6_short_step_max_abs_err", float((got - ref).abs().max()))
    torch.testing.assert_close(got, ref, **KERNEL_TOL)


def test_k6_short_step_at_a_long_horizon_stays_within_the_float64_bound(pair, record_property):
    """K6's step over regen_cols' controls at H=130 (B=4, K=512: two full
    64-control chunks and a partial one in every session) stays within
    chip_smoke.py's float64 bound (long_horizon_vs_float64), which rejects
    both chunk faults."""
    from chip_smoke import long_horizon_vs_float64

    got, (model, s_rows, Q, rows) = k6_short_step(k6_step_operands(pair, 130))
    record_property("k6_long_horizon_vs_float64", long_horizon_vs_float64(
        model, s_rows, Q, rows, {"short_step": got.reshape(-1)}))


def test_k6_bound_rejects_the_next_sessions_seed(pair, record_property):
    """Each session's draws made with session b+1's seed, scored by K6's
    step, fall outside KERNEL_TOL of fused_cem_cols_plain, as phase 36
    checks on the card."""
    from chip_smoke import KERNEL_TOL

    args = k6_step_operands(pair, 35)
    wrong, _ = k6_short_step(args, seed_b=args[5].roll(-1))
    ref = fused_cem_cols_plain(*args)
    record_property("k6_next_seed_max_abs_err", float((wrong - ref).abs().max()))
    assert not torch.allclose(wrong, ref, **KERNEL_TOL)


@pytest.mark.cuda
def test_cuda_k6_matches_plain_version_and_k1(pair, cuda_device):
    """K6 against its plain version on the same card tensors (B*K not a
    multiple of the block: the edge is masked), and K6's costs equal K1's
    over the controls that ``regen_cols`` draws again, session by session."""
    _, pctrl, _, params = pair
    popt = pctrl.optimizer
    dev = cuda_device
    Bc, Kc, Hc = 3, 1000, 50
    gen = torch.Generator(device=dev).manual_seed(0)
    model, _ = ode.rollout_model(popt)
    _, slot_keys = split_slot_keys(model.param_keys, ("L",))
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, Bc, dev)(
        0.3 * torch.randn(Bc, 1, generator=gen, device=dev),
        dict({k: v.to(dev) for k, v in params["dyn"].items()},
             L=torch.tensor([0.35, 0.5, 0.65], device=dev)),
        {k: v.to(dev) for k, v in params["cost"].items()},
        {"target_position": torch.tensor([-0.1, 0.0, 0.2], device=dev)})
    s0 = 0.05 * torch.randn(Bc, 4, generator=gen, device=dev)
    mue = 0.2 * torch.randn(Bc, Hc, 1, generator=gen, device=dev)
    std = torch.full((Bc, Hc, 1), 0.5, device=dev)
    seed_b = torch.tensor([11, 2**31 - 2, 5], dtype=torch.int32, device=dev)
    lim = torch.ones(1, device=dev)
    args = (model, s0, mue, std, pvec_b, seed_b, -lim, lim, Kc)
    got = fused_cem_cols(*args)
    torch.testing.assert_close(got, fused_cem_cols_plain(*args), rtol=1e-4, atol=1e-3)
    Q = regen_cols(seed_b, torch.arange(Kc, device=dev).expand(Bc, Kc), mue, std, -lim, lim, Kc,
                   fast=False)
    for b in range(Bc):
        via_k1 = cost_rollout(model, s0[b].expand(Kc, -1).contiguous(), Q[b].contiguous(),
                              pvec_b[b].contiguous())
        assert torch.equal(got[b], via_k1)


@pytest.mark.cuda
def test_cuda_k6_at_a_long_horizon_stays_within_the_float64_bound(pair, cuda_device):
    """K6 at H=130 (B=4, K=512: two full 64-control chunks and a partial
    one in every session) within chip_smoke.py's float64 bound
    (long_horizon_vs_float64), with K1's costs over regen_cols' controls,
    which equal K6's bit for bit."""
    from chip_smoke import long_horizon_vs_float64

    dev = cuda_device
    args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in k6_step_operands(pair, 130))
    model, s0, mue, std, pvec_b, seed_b, low, high, Kc = args
    B = s0.shape[0]
    got = fused_cem_cols(*args)
    Q = regen_cols(seed_b, torch.arange(Kc, device=dev).expand(B, Kc), mue, std, low, high, Kc,
                   fast=False)
    via_k1 = torch.stack([cost_rollout(model, s0[b].expand(Kc, -1).contiguous(),
                                       Q[b].contiguous(), pvec_b[b].contiguous())
                          for b in range(B)])
    assert torch.equal(got, via_k1)
    long_horizon_vs_float64(model, per_rollout(s0, Kc).T, Q.reshape(B * Kc, 130, 1),
                            per_rollout(pvec_b, Kc), {"k6": got.reshape(-1)})
