"""Drive the torch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

The main paths are the "mpc" controller over the rk4 "ODE" predictor on
the cartpole plant and the cartpole/default cost, closed-loop against
CartpoleEnv at K=16384 rollouts, H=50, inducing period 10, seed 0, with
the "mppi" optimizer (the flagship) and with the gradient optimizers
"rpgd-tf" and "gradient-tf".  Phases, each printing one line of its
numbers:

1. build the CUDA kernels from control_toolkit_tpu_torch/csrc with nvcc;
2. K1 (cost_rollout) and 3. K2 (mppi_cost) against their plain PyTorch
   versions on the card, at the main path's shapes, with CUDA-event times;
   K1 also at ragged K (1000 and 8), with the euler integrator and two rk4
   sub-steps, at H=130 against float64, its bound against the controls
   read one step early and from the next rollout's row, its time at K=16
   to 8192, its registers and the loops of its SASS (``k1_cases``); K2
   also at ragged K and P=1, its bound against the controls read one step
   early, the bracket's second point dropped and the next rollout's noise,
   its costs at cc_weight 0 equal to K1's over mppi_controls_plain's
   controls, at H=130 (P=14, three chunks) equal to K1's there, against
   float64 and its bound against the bracket restarted at a chunk's head,
   its time at K=16 to 8192, its registers and the loops of its SASS
   (``k2_cases``, ``k2_resources``);
4. 200 closed-loop MPPI ticks on the default (semi-fused, K2) path, with a
   target change midway that must not rebuild anything;
5. 50 MPPI ticks with semi_fused=False (the modular path, K1);
6. one MPPI update on the card against the same update on the CPU;
7. K7 (grad_cost_rollout: a forward launch and a time-parallel adjoint
   launch) against its plain version on the card, also at ragged K (1000
   and 8), and the dQ bound against K7's output with one stage-gradient
   term wrong; then its time at K=2048 and 8192, its two launches timed
   apart, and their resources (registers, spills, shared memory, the
   adjoint's blocks per SM);
8. 200 closed-loop rpgd-tf ticks (two K7 launches and one K1 per tick),
   with the target change at tick 100;
9. 50 closed-loop gradient-tf ticks (five K7 launches and one K1 per tick);
10. one rpgd-tf update on the card against the same update on the CPU.

The learned-dynamics paths: the same controllers over the committed nets
(control_toolkit_tpu_torch/assets/cartpole, predictor specification
"neural:<net>:<assets>"), mlp-64-64 and GRU-5IN-32H1-32H2-4OUT:
11. K11 (neural_cost_rollout) against its plain version, and the cost bound
    against the plain version's output with norm_out dropped, with tanh on
    the last layer and with one unit tile (8 units) of the last hidden layer
    lost; K11 also at ragged K and over seeded 5-72-72-4 and 5-13-13-4
    nets; then its time at K=16, 64, 2048 and 8192 and at 1, 2 and 4 warps
    a 16-rollout group, its resources (as K8's, with the warps a group and
    an SM) and its tensor-core bound;
12. K8 (neural_grad_cost_rollout) against its plain version, also at
    ragged K (1000 and 8) and over a seeded MLP wider than its register
    path (5-72-72-4), and the dQ bound against dQ with one layer's tanh'
    dropped, the delta form's identity dropped, and norm_in's scaling
    dropped in the backward; then its resources (registers, spills, shared
    memory, blocks per SM, HMMA instructions in its SASS) and its
    tensor-core bound;
13. K13 (recurrent_cost_rollout) against its plain version, for the GRU
    and for an LSTM of the same widths (seeded random weights), also at
    ragged K, and the cost bound against a zero hidden, the first two
    gates swapped and the last cell's second gate's input bias dropped;
    then each one's time at K=2048 and 8192, its resources (as K8's) and
    its tensor-core bound;
14. 200 closed-loop MPPI ticks over the MLP (one K11 launch per tick), with
    the target change at tick 100;
15. 200 closed-loop rpgd-tf ticks over the MLP (two K8 and one K11);
16. 50 closed-loop MPPI ticks over the GRU (one K13), and the hidden the
    card carried against a CPU replay of the recorded states and controls;
17. one update on the card against the same update on the CPU, for MPPI
    over the MLP, MPPI over the GRU (hidden included) and rpgd-tf over the
    MLP.

The adaptive-MPC and sparse-GP paths (bench_scale.py:build_residual_ctrl
and build_gp_mppi/build_rpgd's configurations, seed 3): the residual
"ODE+res" predictor (hiddens (32, 32)) and the committed SGP_128 GP
(control_toolkit_tpu_torch/assets/cartpole/SGP_128.npz, M=128):
18. K12 (residual_cost_rollout) against its plain version, with a nonzero
    residual, and the cost bound against the plain arithmetic with the
    residual dropped and with the residual added to x in place of the base
    step; K12 also at ragged K and over a seeded 5-72-72-4 residual (whose
    bound must reject the residual with its last hidden unit tile lost),
    then its time at K=16, 64, 2048 and 8192, its resources (as K8's, with
    the warps a group and an SM) and its tensor-core bound;
19. K9 (residual_grad_cost_rollout) against its plain version, also at
    ragged K and over a wide residual net, and the dQ bound against dQ with
    the MLP's VJP dropped; then its resources and tensor-core bound, as
    K8's;
20. K14 (gp_cost_rollout) and 21. K10 (gp_grad_cost_rollout) against their
    plain versions over a well-conditioned GP of the committed one's widths
    (``well_conditioned_gp``), to K11's and K7's bounds, and those bounds
    against out_std dropped, zn2 dropped and one lane's points dropped
    (K14), and the 2·an term dropped and phase 7's wrong stage-gradient
    terms (K10); K14 also at ragged K, at 1, 2, 4, 8 and 16 lanes a
    rollout, each timed and each also over 100 inducing points, equal to
    K10's J at the lanes both take, its time at K=16 to 8192 and its
    resources (``k14_cases``, ``k14_resources``); K10 also at
    ragged K, over a well-conditioned GP of 100 inducing points and at 4,
    8, 16 and 32 lanes a rollout, each timed, then its time at K=16, 64,
    2048 and 8192 and its resources (registers, spills, shared memory,
    blocks and warps an SM, lanes a rollout); then, over the committed GP
    (ill-conditioned in float32), each kernel against a float64
    evaluation, held to the plain version's own float32 distance from it;
22. 200 closed-loop MPPI ticks over "ODE+res" on the mismatched plant of
    examples/adaptive_mpc.py (m_pole 0.4, L 0.6), an OnlineSysId fit of 300
    steps on the card installed every 50 ticks with nothing rebuilt, and
    the adapted model's one-step error against the base's (one K12 a tick);
23. 100 closed-loop rpgd-tf ticks over "ODE+res" with a nonzero residual
    (two K9 and one K12 a tick);
24. 200 closed-loop MPPI ticks over the GP (one K14 a tick), a re-fit on the
    loop's transitions and fresh random ones swapped in with nothing
    rebuilt, and a 50-tick episode over the re-fit GP (no pole check: MPPI
    over this GP loses the pole in both packages, see PERF.md);
25. 100 closed-loop rpgd-tf ticks over the GP (two K10 and one K14);
26. one update on the card against the same update on the CPU for each of
    the four loops (over the GP with the well-conditioned GP swapped in).

The sampling paths over the ODE: CEM at bench_scale.py:build_cem's
configuration (cem_outer_it 2, cem_best_k 256, initial stdev 0.5,
cem_stdev_min 0.01, seed 3), modular (K1) and fully fused (K5); the
flagship MPPI with fully_fused (K3); iCEM at build_icem's (beta 2) and
random-action (seed 3), both on K1:
27. K5 (fused_cem_costs) against its plain version, K5's costs equal to
    K1's over the controls regenerated from its counters (the two share
    their step, so this holds the draws, not the step), the elite rows'
    regeneration an exact subset of the full one, the mean and variance of
    its K*H normals within 5 sigma of 0 and 1, and the cost bound against
    the plain version with the tile term dropped from the counters and with
    the rollout order transposed (r and c swapped); K5 also at H=130 (two
    full chunks of drawn controls and a partial one) against its plain
    version, K1 and float64, its registers, its time at K=16 to 16384,
    and the loops of its SASS (``k5_cases``);
28. K3's pass 1 (fused_mppi_costs) and 29. its pass 2 (fused_mppi_weights)
    against their plain versions; pass 1 also at ragged K and P=1, its bound
    against the controls read one step early, the bracket's second point
    dropped and the next rollout's counters, its costs at cc_weight 0 equal
    to K1's over mppi_controls_plain's controls, at H=130 (P=14, three
    chunks) equal to K1's there, against float64 and its bound against the
    bracket restarted at a chunk's head, its time at K=16 to 8192, its
    registers and the loops of its SASS (``k3_cases``, ``k3_resources``);
    pass 2 after the block sum as [P, U] and
    its bound against the sums unnormalized and from the neighbouring
    inducing point's noise; then the whole fused_mppi_step against
    fused_mppi_step_plain on the same card tensors;
30. 200 closed-loop CEM ticks, modular (two K1 launches a tick), with the
    target change at tick 100 that must not rebuild anything;
31. the same with fully_fused (two K5 launches a tick, no K1);
32. 200 closed-loop fully-fused MPPI ticks (one K3 pass 1 and one pass 2 a
    tick, no K2), with the target change;
33. 50 iCEM ticks and 50 random-action ticks, each one K1 launch an outer
    iteration;
34. one update on the card against the same update on the CPU, fed the same
    draws: modular and fused CEM outer iteration by outer iteration, the
    elites taken by the card's own top-k (which must be a top-k of the
    CPU's costs within the cost bound), and fully-fused MPPI.

The fleet path: the "batched-mpc" controller with per-slot pole lengths
(``per_slot_dyn=("L",)``), semi-fused MPPI at bench_scale.py:345's
configuration (K=512 a session, H=35, inducing period 10, SQRTRHOINV 0.05,
seed 1) over K4, and fully-fused CEM at :356's (cem_outer_it 2,
cem_best_k 40, warmup off, seed 1) over K6:
35. K4 (mppi_cost_cols) against its plain version at 128 sessions with
    per-slot lengths over 0.35-0.65, targets and previous controls, and the
    cost bound against a kernel that reads session b+1's rows and one that
    takes every session's previous control from slot 0; K4 also at a ragged
    B*K (3 sessions of K=1000), equal to K1 per session at cc_weight 0, at
    H=130 against float64 and K1 with the chunk-restart mutant rejected,
    its time at 32 and 128 sessions, its registers and the loops of its
    SASS (``k4_cases``, ``k4_resources``);
36. K6 (fused_cem_cols) against its plain version at 128 sessions, its
    costs against K1's over the controls regen_cols draws again (equal in
    every entry), the elite rows' regeneration an exact subset of the full
    one, and the cost bound against K5's tiled counter, the swap of r and
    cw and the next session's seed; K6 also at a ragged B*K (3 sessions of
    K=1000), at H=130 against float64 and K1, its time at 32 and 128
    sessions, its registers and shared memory (``k6_cases``);
37. 200 closed-loop ticks of a 32-session MPPI fleet, each slot against its
    own CartpoleEnv with its own pole length, a rotating quarter of the
    slots idle each tick, half the targets changed and slot 2's model
    re-identified at tick 100 (examples/fleet_serving.py without ZeroMQ):
    one K4 launch a tick, idle slots bit for bit unchanged, every pole up,
    nothing rebuilt;
38. the same 100 ticks for a 32-session fused CEM fleet (two K6 a tick);
39. one fleet update on the card against the same update on the CPU, fed
    the same draws and seeds, for each path;
40. both paths timed at 32 and 128 sessions: host p50/p99, device span,
    sessions a second, and the host time of the slots' own draws.

The learned fleets: plain MPPI at the fleet's configuration over each
learned model of phases 11-26 (the committed mlp-64-64, GRU and SGP_128,
an LSTM of the GRU's widths with seeded weights, and "ODE+res" with a
seeded nonzero residual and per-slot pole lengths), all sessions' rollouts
in one launch of the model's kernel in its session-row form (rollout b*K+k
reads session b's packed row and, for the recurrent nets, starts from
session b's hidden):
41. each form (K11's, K13's for the GRU and the LSTM, K12's, K14's over a
    well-conditioned GP) against its plain version at 128 sessions of
    K=512, H=35, to its single-session kernel's bound; its costs equal,
    session by session, to the single-session kernel's over the session's
    rows (share 1.0); within the bound at 120 rollouts a session (groups
    straddle sessions); the bound against every session reading the next
    session's row, against every session starting from slot 0's hidden
    (K13) and against the slots' pole lengths rolled by one (K12); its
    time at 32 and 128 sessions, its bounds, registers, spills and blocks
    an SM (``*_cols_cases``);
42. 100 closed-loop ticks of each 32-session learned fleet as phase 37's
    (a rotating quarter idle and checked bit for bit, hidden included; at
    tick 50 half the targets changed, new weight tensors, a GP hot-swap,
    a re-sysid of slot 2's pole length for "ODE+res"): one launch a tick,
    nothing rebuilt; the slots that kept the pole up are counted, not
    required (MPPI over the committed GP loses it in both packages, see
    PERF.md);
43. one update of each learned fleet on the card against the same update
    on the CPU, fed the same draws;
44. each learned fleet timed at 32 and 128 sessions, as phase 40.

The gradient fleets (bench_scale.py:367-390's configurations): rpgd-tf
(seed 7, outer_its 2) and gradient-tf (seed 9, 5 steps) over the ODE at
128 sessions of K=32, H=50 with per-slot pole lengths, and rpgd-tf over
the committed MLP, "ODE+res" (per-slot pole lengths) and the committed GP
at 32 sessions of K=512, each Adam iteration one launch of the session-row
form of K7, K8, K9 or K10 and the final scoring one of K1's, K11's, K12's
or K14's:
45. the session-row forms of K1, K7, K8, K9 and K10 (a GP of the
    committed one's widths, well_conditioned_gp's) against their plain
    versions at 32 sessions of 100 rollouts, H=50 (blocks, K7's adjoint
    blocks and 16-rollout groups straddle sessions), to their
    single-session kernels' bounds; equal, session by session, to the
    single-session kernel over the session's rows (share 1.0); the bounds
    against every session reading the next session's row; each timed at
    128 sessions of 32 rollouts and at 32 of 512, with its bounds (K8's
    and K9's tensor-core bound too), registers, spills and blocks an SM
    (``k*_cols``);
46. 50 closed-loop ticks of each gradient fleet as phase 37's (a rotating
    quarter idle and checked bit for bit, Adam moments, counters, ages and
    generators included; at tick 25 half the targets changed, slot 2's
    pole length re-identified, new MLP weight tensors, a new residual
    install, a GP hot-swap): outer_its (gradient_steps) launches of the
    gradient form and one of the cost form a tick, nothing rebuilt, every
    ODE fleet's pole up (the learned fleets' counted);
47. one update of each gradient fleet on the card against the same update
    on the CPU, with the same draws;
48. each gradient fleet timed at 32 and 128 sessions, as phase 40.

The PETS ensemble (bench_scale.py:499 build_ensemble_mppi and :1419's
rpgd-tf, seed 3): MPPI and rpgd-tf over the committed bootstrap ensemble
of four mlp-32-32 members (control_toolkit_tpu_torch/assets/cartpole/
ensemble-mlp-32-32-x4.npz, predictor specification
"ensemble:mlp-32-32:4:<assets>"), PETS TS-inf blockwise, on the
member-block (n_members) forms of K11 and K8:
49. K11's member-block form (neural_cost_rollout_ens) against its plain
    version at K=16384, H=50, E=4, each member's block of 4,096 rollouts
    equal, bit for bit, to K11 over that block under the member's net, E=1
    equal to K11, the cost bound against every block reading member 0's
    weights and each block reading the next member's; also at a ragged K/E
    (1,200 rollouts, 300 a member), over a seeded ensemble of 8 members with
    norms, a seeded one without norms and in absolute form over two
    members; its registers, spills, shared memory, blocks an SM, HMMA
    count and bounds beside K11's registers (``k11_ens_*``);
50. K8's member-block form (neural_grad_cost_rollout_ens) likewise, against
    autograd through the plain member-block loop, J to NET_TOL and dQ to
    K7's bound (``k8_ens_*``);
51. 200 closed-loop MPPI ticks (one K11 form a tick) and 200 rpgd-tf ticks
    (two K8 forms and one K11 form) over the ensemble from
    CartpoleEnv(seed=0)'s start, the pole counted, not required;
52. one update of each on the card against the same update on the CPU;
53. 20 MPPI ticks with robust_eval "worst" (every plan under every member,
    plain torch on the card: no kernel) and 20 with risk_weight 0.1 (the
    K11 form plus the members' disagreement), each with one update against
    the CPU's.

The learned value terminal on the ODE path (costs/value_terminal.py:
``attach_value_terminal``, V a tanh MLP from the state to a cost-to-go),
over the committed value net (control_toolkit_tpu_torch/assets/cartpole/
value-mlp-32-32.npz, 4-32-32-1, fitted by the JAX package on its MPPI's
realized costs-to-go) on the emit_terminal forms of K1, K2 and K4 and K7's
value_spec form:
54. K1's, K2's and K4's emit_terminal forms (cost_rollout_emit,
    mppi_cost_emit, mppi_cost_cols_emit) against their plain versions at
    phase 2's, 3's and (B=32 of K=512, H=35) 35's operands and at a ragged
    K (1,000; K4: 3 sessions of 1,000): their costs equal, bit for bit, to
    the kernels' own, the terminal states to X_TOL, a bound that must
    reject x_{H-1} in place of x_H and rollout k+1's x_H; each timed beside
    its kernel; the six kernels' registers (``emit_resources``);
55. K7's value_spec form (grad_cost_rollout_value) against its plain
    version over a seeded 4-32-32-1 V at scale 100, J to KERNEL_TOL and dQ
    to K7's bound, which must reject dV/dx_H dropped from the seed, the
    scale left out and V added without the 1/(H+1); also at ragged K and
    over a second V with nothing built; its two launches timed apart, their
    registers and shared memory;
56. from LEARNED_START, 200 semi-fused MPPI ticks (one K2 form a tick), 100
    rpgd-tf ticks (two K7 forms, one K1 form) and 100 MPPI ticks at H=10
    (the short horizon the value is for), the pole recorded, not required;
57. one update of each on the card against the same update on the CPU, and
    a V swap (new weights, new scale) that builds nothing;
58. 50 ticks of a 32-session MPPI fleet with V (phase 40's configuration;
    one K4 form a tick), the poles counted, and one fleet update against
    the CPU's.

The learned value terminal over the learned dynamics, on the
emit_terminal forms of K11 (and its member-block form), K12, K13 and K14:
59. each form (neural_cost_rollout_emit, neural_cost_rollout_ens_emit,
    residual_cost_rollout_emit, recurrent_cost_rollout_emit over the GRU
    and the LSTM, gp_cost_rollout_emit) against its plain version at its
    kernel's phase operands (phases 11, 49, 18, 13 and 20: K=16384, H=50,
    the committed nets, the well-conditioned GP) and at a ragged K (1,000;
    the ensemble 300 a member): its costs equal, bit for bit, to the
    kernel's own, x_H to X_TOL, whose bound must reject x_{H-1} and the
    next rollout's x_H (``compare_emit``); each timed beside its kernel;
    both entries' registers and spills (``learned_emit_resources``);
60. the session-row emit forms of K11, K12 and K14 at phase 41's operands
    (128 sessions of K=512, H=35) against their plain versions, each
    session equal, bit for bit, to the single-session emit form over its
    rows, the next session's row and the next rollout's x_H rejected,
    timed at 32 and 128 sessions beside the session-row kernels;
61. from LEARNED_START, over the committed value net, 100 ticks each of
    MPPI over mlp-64-64, the GRU, "ODE+res" (a seeded residual), SGP_128
    and the ensemble, and of CEM over mlp-64-64: one emit launch a tick
    (CEM: one an outer iteration), the pole recorded, not required (V was
    fitted on states of the ODE's closed loop);
62. one valued update of each on the card against the same update on the
    CPU (the GP's with the well-conditioned GP swapped in) and a V swap
    that builds nothing; then 50 ticks of each valued 32-session MPPI fleet
    (MLP, "ODE+res", GP; one session-row emit launch a tick) and one update
    of each against the CPU's, the valued MLP fleet timed.

The learned value terminal in the gradient kernels over the learned
dynamics and in the gradient fleets, on the value_spec forms of K8 (and
its member-block form), K9 and K10, their session-row forms, K7's
session-row value_spec form and K1's session-row emit_terminal form:
63. each single-session value form (neural_grad_cost_rollout_value,
    neural_grad_cost_rollout_ens_value, residual_grad_cost_rollout_value,
    gp_grad_cost_rollout_value) against its plain version at its kernel's
    phase operands (12, 50, 19, 21: K=16384, H=50) over a seeded 4-32-32-1
    V at scale 100: J to its kernel's bound, dQ to K7's, which must reject
    dV/dx_H dropped, the scale left out and no 1/(H+1); also at ragged K
    and (K8, K9) over phase 12's and 19's wide nets; a V whose last layer
    is zero gives the kernel's outputs bit for bit; over the committed V,
    held to the float64 plain version (``f64_held``); timed beside the
    kernel, with registers, spills, shared memory and blocks per SM;
64. the session-row value forms of K7, K8, K9 and K10 over the committed V
    and K1's session-row emit form at phase 45's operands (32 sessions of
    100): each session equal, bit for bit, to the single-session value
    (emit) form over its rows, the next session's row rejected (K1: also
    x_{H-1} and the next rollout's x_H), timed at 128×32 and 32×512
    beside phase 45's forms;
65. from LEARNED_START over the committed value net, 100 rpgd-tf ticks
    each over mlp-64-64, "ODE+res", SGP_128 and the ensemble (two value
    launches and one emit launch a tick) and 50 gradient-tf ticks over the
    MLP (five and one), the pole recorded, not required; 50 ticks of each
    valued 32-session gradient fleet (rpgd-tf over the ODE, the MLP,
    "ODE+res" and the GP, gradient-tf over the ODE: the session-row value
    form an Adam iteration, the session-row emit form a tick);
66. one valued update of each on the card against the same update on the
    CPU (the GP's with the well-conditioned GP swapped in).

The fast plant (the ":fast" predictors, "ODE:rk4:1:fast" and
"ODE+res:rk4:1:fast": ops/fastmath.py's polynomial trig; every ODE entry's
instance over it, csrc/plants.cuh CartpolePlantT<true>, and the fast
normals of K3, K5 and K6):
67. each fast entry and form (K1, K2, K3's two passes, K4, K5, K6, K7, K12,
    K9; the emit forms of K1, K2, K4, K12, the value forms of K7 and K9,
    the session-row forms of K1, K7, K12, K9 with their emit and value
    forms) against its plain version over the fast plant at its exact
    entry's phase operands and bound, and against the exact entry on the
    same inputs (non-zero, within FAST_FROM_EXACT); K1 also at ragged K,
    K5 at a ragged K of one 1,000-rollout tile; K5-fast and K3-fast pass 1
    (cc_weight 0) equal to K1-fast over the controls that regen_controls
    and mppi_noise with fast=True draw again on the card (share 1.0), the
    fast elite regeneration exact, K6-fast equal to K1-fast per session
    over regen_cols(fast=True); K7-fast's dQ within K7's bound of the fast
    plain adjoint from angles over +-3.1, a bound that must reject the
    adjoint taking cos and -sin as the derivatives;
68. 200 closed-loop ticks of the fast flagship (K2's fast entry) from
    CartpoleEnv(seed=0) with the target change, one update against the
    CPU's, a profiler breakdown of its tick beside the exact flagship's,
    then 20 ticks of each other fast path, counted from 0: modular and
    fully-fused MPPI, modular and fused CEM, iCEM, random-action, rpgd-tf,
    gradient-tf, rpgd-tf over "ODE+res:...:fast",
    the valued MPPI and rpgd-tf over both, 80 adaptive MPPI ticks over
    "ODE+res:...:fast" with a sysid fit every 40, and 32-session fleets:
    MPPI, fused CEM, rpgd-tf over the ODE, MPPI and rpgd-tf over
    "ODE+res:...:fast", the valued MPPI and rpgd-tf fleets.

The rest of the sampling and gradient-CEM zoo on cartpole (no new kernel:
each runs on kernels of the phases above, picked from the model):
69. 50 closed-loop ticks each at K=16384, H=50, seed 3, counted from 0 and
    each gated on its kernel path: cem-gmm (two K1 a tick), cma-es full
    and diagonal (three K1; the full form's torch.linalg.eigh timed),
    semi-fused mppi-var with LR 1000 (one K2), cem-naive-grad (one K7, one
    K1) and cem-grad-bharadhwaj (two K7, two K1);
70. 20 ticks of each over the fast plant (their kernels' fast entries),
    and 20 Bharadhwaj ticks over the committed MLP from LEARNED_START
    (two K8, two K11, the pole recorded, not required);
71. the mppi-var fleet (one K4 a tick, each session its own adaptive
    sigma) at 128 sessions of K=512, H=35, every slot active, 50 ticks
    (the slots that kept the pole counted: a few lose it in both
    packages), and a valued one at 32 sessions over the committed V (K4's
    emit form, a rotating quarter idle, checked bit for bit), 50 ticks;
72. one update of each on the card against the CPU's with the same draws:
    cem-gmm and the gradient CEMs outer iteration by outer iteration from
    the card's carry (``zoo_update_vs_cpu``), cma-es on the sign-free
    quantities (cuSOLVER's eigenvectors may differ in sign from LAPACK's:
    ``cma_update_vs_cpu``), mppi-var and its fleet with sigma held within
    the reach of the cost error (``var_sigma_bound``);
73. the mppi-var fleet timed at 32 and 128 sessions.

The pendulum, acrobot and point-mass plants (a plant is a (dynamics, cost)
pair: csrc/plants.cuh, ops/kernels.py PLANT_IDS; K1, K2, K3 and K7 carry
them in their plain entries, ``PLANT_CASES``):
74. each plant's instance of K1, K2, K3's pass 1 (and the point mass's
    fast-normals instances) and K7 against its plain version at K=16384,
    H=50, timed beside cartpole's entry of phases 2, 3, 30 and 7, at
    ragged K (700) and at H=45 (not a multiple of the point mass's 32-step
    controls-ahead chunk), with its bound, registers, spills, static
    shared memory and blocks per SM (``plant_kernels``); each bound
    rejects the plant's named wrong variant (``plant_mutants``: the point
    mass's two controls swapped, an obstacle dropped, the acrobot's
    sin(t1+t2) read as sin(t1), the pendulum's energy offset dropped; for
    K7's dQ, the point mass's du[1] dropped and the control cost dropped);
75. at K=16384, H=50, PLANT_TICKS closed-loop ticks each against the
    port's environments, counted from 0: MPPI semi-fused (K2), modular
    (K1) and fully fused (K3) and rpgd-tf (K7, K1) over each plant, the
    ``:fast`` pendulum and acrobot and the fast-normals point mass
    (fully fused MPPI over "ODE:rk4:1:fast"); cem-tf, icem-tf,
    random-action-tf, cem-gmm-tf and cma-es-tf (K1), gradient-tf,
    cem-naive-grad-tf and cem-grad-bharadhwaj-tf (K7, K1) over the
    pendulum, the acrobot and the point mass;
76. at each plant's demo configuration (examples/swingup_demo.py:20-25,
    tests/test_obstacle_cost.py:25-28): MPPI swings the pendulum up from
    hanging and holds it (more than 20 ticks within 1 - cos < 0.05, as
    tests/test_mppi.py:60-72 requires), MPPI at K=700 over the acrobot
    (its tip height reported), and rpgd-tf and CEM steer the point mass
    around an obstacle to its target.

Float32 products on the card run in full float32: the script sets
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.
allow_tf32`` to False before any work, so the plain versions' matmuls are
not TF32.

    python3 chip_smoke.py [--starts] [--profile]

``--starts`` adds, after phase 26, 18 closed loops of each of MPPI and
rpgd-tf over the MLP and of MPPI over the GP from other start states and
seeds (``start_sweep``);
``--profile`` a ``torch.profiler`` trace of 20 ticks (after 30 warm-up
ticks) of each path (the sampling paths: cem, cem-fused, mppi-fused and
icem; MPPI and rpgd-tf over the ensemble; the valued MPPI (H=50, H=10) and
rpgd-tf; the valued MPPI over the MLP; the valued rpgd-tf over each
learned model and gradient-tf over the MLP; phase 69's and 70's zoo loops;
the fleet paths at both sizes of phases 40, 44, 48 and 73 and the valued
MLP fleet), printing
per tick the
device busy time, the number of device operations and the costliest
device kernels.

Every kernel's launch count is set to 0 just before each closed loop and
read just after it; launches made to compare a kernel with its plain
version are not counted.  No phase catches its own failure: any mismatch
raises and the exit code is not 0.  Without a card it raises before
printing any result.  The last line is the JSON result; the line before it
lists the kernels, each with its launches over the closed loops, its error
against its plain version, its and its plain version's CUDA-event times,
and its bound: the larger of the bytes it must move over 3.35 TB/s and its
FP32 operations (counted from the shapes, see ``kernel_ops``) over
67 TFLOP/s, the H100 SXM's published peaks.
Imports nothing of JAX and nothing of the JAX package (it passes every
config explicitly, so no config file is read).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.costs.value_terminal import (
    attach_value_terminal, update_value_params,
)
from control_toolkit_tpu_torch.environments.acrobot import AcrobotEnv
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.environments.pendulum import PendulumEnv
from control_toolkit_tpu_torch.environments.pointmass import PointMassEnv
from control_toolkit_tpu_torch.models.dynamics import _acrobot_derivs
from control_toolkit_tpu_torch.models.gp_predictor import fit_gp_dynamics
from control_toolkit_tpu_torch.models.networks import gru_apply, gru_init_state, load_net
from control_toolkit_tpu_torch.models.online_sysid import OnlineSysId
from control_toolkit_tpu_torch.models.training import collect_transitions
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.common import (
    AdamState, adam_update, clip_by_norm, elite_indices,
)
from control_toolkit_tpu_torch.ops.cost_rollout import (
    cost_rollout, cost_rollout_cols, cost_rollout_cols_emit, cost_rollout_cols_emit_plain,
    cost_rollout_cols_plain, cost_rollout_emit, cost_rollout_emit_plain, cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.counter_prng import (
    DEFAULT_TILE_K, ROWS, normals_from_counter, rollout_coords, seed_base,
)
from control_toolkit_tpu_torch.ops.fused_cem import (
    cem_counters, fused_cem_costs, fused_cem_costs_plain, regen_controls,
)
from control_toolkit_tpu_torch.ops.fused_cem_cols import (
    cols_counters, fused_cem_cols, fused_cem_cols_plain, regen_cols,
)
from control_toolkit_tpu_torch.ops.fused_mppi import (
    fused_mppi_costs, fused_mppi_costs_plain, fused_mppi_step, fused_mppi_step_plain,
    fused_mppi_weights, fused_mppi_weights_plain, mppi_noise,
)
from control_toolkit_tpu_torch.ops.gp_grad_cost_rollout import (
    gp_grad_cost_rollout, gp_grad_cost_rollout_cols, gp_grad_cost_rollout_cols_plain,
    gp_grad_cost_rollout_cols_value, gp_grad_cost_rollout_lanes, gp_grad_cost_rollout_plain,
    gp_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.gp_rollout import (
    flatten_gp_weights, gp_cost_rollout, gp_cost_rollout_cols, gp_cost_rollout_cols_emit,
    gp_cost_rollout_cols_emit_plain, gp_cost_rollout_cols_plain, gp_cost_rollout_emit,
    gp_cost_rollout_emit_plain, gp_cost_rollout_lanes, gp_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.adjoints import PLANT_ADJOINTS, integrator_vjp
from control_toolkit_tpu_torch.ops.fastmath import fast_sin, fast_sincos
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_cols, grad_cost_rollout_cols_plain,
    grad_cost_rollout_cols_value, grad_cost_rollout_plain, grad_cost_rollout_value, launch_part,
    plain_grad_loop,
)
from control_toolkit_tpu_torch.ops.interpolation import interpolation_matrix
from control_toolkit_tpu_torch.ops.mppi_cost import (
    mppi_controls_cost_plain, mppi_controls_plain, mppi_cost, mppi_cost_emit,
    mppi_cost_emit_plain, mppi_cost_plain,
)
from control_toolkit_tpu_torch.ops.mppi_cost_cols import (
    mppi_cost_cols, mppi_cost_cols_emit, mppi_cost_cols_emit_plain, mppi_cost_cols_plain,
    per_rollout,
)
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_cols, neural_grad_cost_rollout_cols_plain,
    neural_grad_cost_rollout_cols_value, neural_grad_cost_rollout_ens,
    neural_grad_cost_rollout_ens_plain, neural_grad_cost_rollout_ens_value,
    neural_grad_cost_rollout_ens_value_plain, neural_grad_cost_rollout_plain,
    neural_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.neural_rollout import (
    mlp_layer_count, mlp_step, neural_cost_rollout, neural_cost_rollout_cols,
    neural_cost_rollout_cols_emit, neural_cost_rollout_cols_emit_plain,
    neural_cost_rollout_cols_plain, neural_cost_rollout_emit, neural_cost_rollout_emit_plain,
    neural_cost_rollout_ens, neural_cost_rollout_ens_emit, neural_cost_rollout_ens_emit_plain,
    neural_cost_rollout_ens_plain, neural_cost_rollout_plain, neural_cost_rollout_warps,
    plain_cost_loop, recurrent_cost_rollout, recurrent_cost_rollout_cols,
    recurrent_cost_rollout_cols_plain, recurrent_cost_rollout_emit,
    recurrent_cost_rollout_emit_plain, recurrent_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.residual_grad_cost_rollout import (
    residual_grad_cost_rollout, residual_grad_cost_rollout_cols,
    residual_grad_cost_rollout_cols_plain, residual_grad_cost_rollout_cols_value,
    residual_grad_cost_rollout_plain, residual_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.residual_rollout import (
    residual_cost_rollout, residual_cost_rollout_cols, residual_cost_rollout_cols_emit,
    residual_cost_rollout_cols_emit_plain, residual_cost_rollout_cols_plain,
    residual_cost_rollout_emit, residual_cost_rollout_emit_plain, residual_cost_rollout_plain,
    residual_step_fn,
)
from control_toolkit_tpu_torch.ops.soa_integrators import make_soa_stepper
from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
from control_toolkit_tpu_torch.optimizers.cem import refit
from control_toolkit_tpu_torch.optimizers.kernel_families import (
    ensemble, gp, neural, ode, residual,
)
from control_toolkit_tpu_torch.optimizers.mppi_var import MPPIVarState
from control_toolkit_tpu_torch.utils.convert import (
    gradient_state_from_numpy, mppi_state_from_numpy, rpgd_state_from_numpy,
)
from control_toolkit_tpu_torch.utils.device import place, resolve_device

K, H, PERIOD, SEED, DT = 16384, 50, 10, 0, 0.02
TICKS, MODULAR_TICKS, RETARGET_AT, NEW_TARGET = 200, 50, 100, 0.1
RPGD_TICKS, GRADIENT_TICKS = 200, 50
# config_cost_function.yml, cartpole/default.
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}
OPTIMIZER_CONFIG = {"seed": SEED, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
                    "cc_weight": 1.0, "R": 1.0, "LBD": 100.0, "NU": 1000.0,
                    "SQRTRHOINV": 0.03, "period_interpolation_inducing_points": PERIOD}
# bench_scale.py:build_rpgd's configuration.
RPGD_CONFIG = {"seed": SEED, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
               "outer_its": 2, "SAMPLING_DISTRIBUTION": "uniform",
               "period_interpolation_inducing_points": PERIOD, "learning_rate": 0.05,
               "gradmax_clip": 5, "opt_keep_k_ratio": 0.25, "resamp_per": 10,
               "sample_stdev": 0.5, "warmup": False, "warmup_iterations": 2}
GRADIENT_CONFIG = {"seed": SEED, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
                   "gradient_steps": 5, "learning_rate": 0.05, "gradmax_clip": 5}
LIMITS = (np.array([-1.0], np.float32), np.array([1.0], np.float32))
# Kernel vs plain version on the same card tensors: nvcc contracts a*b+c
# into FMA, the plain version's separate ops do not; from states near
# upright the 50-step rollouts stay within float32 rounding of each other.
KERNEL_TOL = dict(rtol=1e-4, atol=1e-3)
# One full update on the card vs on the CPU (plain versions): costs agree
# to the kernel tolerance, the softmax-weighted plan far tighter.
UNOM_ATOL = 1e-4
# K7 vs its plain version: J to KERNEL_TOL; dQ to rtol 2e-5 plus an
# absolute 5e-6 of its largest entry (0.01 at max|dQ| ~2e3).  The adjoint
# sweep amplifies the forward's rounding (FMA contraction) to ~1e-6 of
# max|dQ|; one term of the stage gradient dropped or put on the wrong step
# moves dQ by up to 2*cc*R/(H+1) = 0.04 (control cost) or 4*ccrc/(H+1) =
# 0.08 (control change), and phase 7 checks that the bound rejects each.
DQ_RTOL, DQ_ATOL_FRAC = 2e-5, 5e-6
# The rpgd-tf update on the card vs on the CPU: its K1 costs are taken at
# populations that already differ by the Adam loop's rounding; they, the
# population and the Adam moments are held to rtol 1e-3 plus 1e-3 of the
# largest entry.
UPDATE_RTOL, UPDATE_ATOL_FRAC = 1e-3, 1e-3
# The rows of that update that may differ, each where the function does not
# determine its Adam step (update_vs_cpu_rpgd): at most this share of K.
UNDETERMINED_MAX = 1e-3
PROFILE_WARMUP, PROFILE_TICKS = 30, 20
COUNTED = {"cost_rollout": cost_rollout, "mppi_cost": mppi_cost,
           "grad_cost_rollout": grad_cost_rollout, "neural_cost_rollout": neural_cost_rollout,
           "recurrent_cost_rollout": recurrent_cost_rollout,
           "neural_grad_cost_rollout": neural_grad_cost_rollout,
           "residual_cost_rollout": residual_cost_rollout,
           "residual_grad_cost_rollout": residual_grad_cost_rollout,
           "gp_cost_rollout": gp_cost_rollout, "gp_grad_cost_rollout": gp_grad_cost_rollout,
           "fused_cem": fused_cem_costs, "fused_mppi_cost": fused_mppi_costs,
           "fused_mppi_weights": fused_mppi_weights, "mppi_cost_cols": mppi_cost_cols,
           "fused_cem_cols": fused_cem_cols, "neural_cost_rollout_cols": neural_cost_rollout_cols,
           "recurrent_cost_rollout_cols": recurrent_cost_rollout_cols,
           "residual_cost_rollout_cols": residual_cost_rollout_cols,
           "gp_cost_rollout_cols": gp_cost_rollout_cols, "cost_rollout_cols": cost_rollout_cols,
           "grad_cost_rollout_cols": grad_cost_rollout_cols,
           "neural_grad_cost_rollout_cols": neural_grad_cost_rollout_cols,
           "residual_grad_cost_rollout_cols": residual_grad_cost_rollout_cols,
           "gp_grad_cost_rollout_cols": gp_grad_cost_rollout_cols,
           "neural_cost_rollout_ens": neural_cost_rollout_ens,
           "neural_grad_cost_rollout_ens": neural_grad_cost_rollout_ens,
           "cost_rollout_emit": cost_rollout_emit, "mppi_cost_emit": mppi_cost_emit,
           "mppi_cost_cols_emit": mppi_cost_cols_emit,
           "grad_cost_rollout_value": grad_cost_rollout_value,
           "neural_cost_rollout_emit": neural_cost_rollout_emit,
           "neural_cost_rollout_ens_emit": neural_cost_rollout_ens_emit,
           "recurrent_cost_rollout_emit": recurrent_cost_rollout_emit,
           "residual_cost_rollout_emit": residual_cost_rollout_emit,
           "gp_cost_rollout_emit": gp_cost_rollout_emit,
           "neural_cost_rollout_cols_emit": neural_cost_rollout_cols_emit,
           "residual_cost_rollout_cols_emit": residual_cost_rollout_cols_emit,
           "gp_cost_rollout_cols_emit": gp_cost_rollout_cols_emit,
           "neural_grad_cost_rollout_value": neural_grad_cost_rollout_value,
           "neural_grad_cost_rollout_ens_value": neural_grad_cost_rollout_ens_value,
           "residual_grad_cost_rollout_value": residual_grad_cost_rollout_value,
           "gp_grad_cost_rollout_value": gp_grad_cost_rollout_value,
           "grad_cost_rollout_cols_value": grad_cost_rollout_cols_value,
           "neural_grad_cost_rollout_cols_value": neural_grad_cost_rollout_cols_value,
           "residual_grad_cost_rollout_cols_value": residual_grad_cost_rollout_cols_value,
           "gp_grad_cost_rollout_cols_value": gp_grad_cost_rollout_cols_value,
           "cost_rollout_cols_emit": cost_rollout_cols_emit}
# The learned-dynamics paths over the committed nets.
ASSETS = kernels.PACKAGE_DIR / "assets" / "cartpole"
MLP_SPEC = f"neural:mlp-64-64:{ASSETS}"
GRU_SPEC = f"neural:GRU-5IN-32H1-32H2-4OUT:{ASSETS}"
LSTM_SPEC = "neural:LSTM-5IN-32H1-32H2-4OUT"  # no checkpoint: seeded random weights
MLP_TICKS, MLP_RPGD_TICKS, GRU_TICKS = 200, 200, 50
# The learned loops start from the state the JAX package's CartpoleEnv(seed=0)
# starts from, the run this configuration was checked with there.  MPPI's
# closed loop over mlp-64-64 is marginal over 200 ticks: over 9 start
# states (that one and this package's CartpoleEnv seeds 0-7) and 2
# optimizer seeds, on an H100, MPPI kept the pole up in 10 of 18 runs (both
# from this start) and drifted off with the net's bias in the others, while
# rpgd-tf kept it up in all 18 (``--starts`` repeats the sweep).  The JAX
# package's MPPI, from the same starts on the CPU, kept it up in 12 of 18
# and lost it from this package's seed-0 start with both seeds
# (``tests/test_torch_neural.py --starts``).
LEARNED_START = np.array([-0.12212279, -0.10178403, 0.01027721, -0.01767751], np.float32)
# K11 and K13 against their plain versions: the kernels sum each product
# in 3xTF32 a k-block at a time, the plain versions through cuBLAS in full
# float32.  On an H100 80GB HBM3 (700 W) the max rel errors at these shapes
# were 1.4e-5 (K11, mlp-64-64; 6.9e-6 when it summed in FP32), 2.7e-4 (K13,
# the GRU from an updated hidden) and 5.6e-5 (the LSTM), on costs up to
# ~6e3; the recurrent nets carry the difference through their hidden.  A
# wrong net (norm_out dropped, tanh on the last layer, one unit tile of the
# last hidden layer lost) moves K11's costs by a rel 9 and more, and phase
# 11 checks that the bound rejects each; a
# zero hidden in place of the live one, or the first two gates swapped,
# moves K13's by a rel 30 and more (LSTM; the GRU 1e3), and phase 13
# checks that its bound rejects each.
NET_TOL = dict(rtol=5e-5, atol=1e-3)
RNN_TOL = dict(rtol=1e-3, atol=1e-3)
# K8's dQ is held to K7's bound (rtol 2e-5 plus 5e-6 of max|dQ|): on the
# H100 its error was 1.6e-3 to 1.8e-3 against max|dQ| 1.6e3 (1.1e-6 of it),
# each of phase 12's wrong backwards at least 480.  K1, K7, K8, K9 and K13
# are also held at ragged K (RAGGED_K: not a multiple of their blocks or
# 16-rollout groups, and below one), K8 and K9 over seeded nets wider than
# their register path (WIDE_HIDDENS, WIDE_SEED), to the same bounds.
RAGGED_K, WIDE_HIDDENS, WIDE_SEED = (1000, 8), (72, 72), 5
# K11 is also held over a seeded net of widths that are not multiples of 8
# (NARROW_HIDDENS) and over the wide one, and timed at each of
# GROUP_WARPS warps a 16-rollout group; K10 over a well-conditioned GP of
# GP_FEW_POINTS inducing points (not a multiple of any lane count) and at
# each of GP_LANES lanes a rollout; K14 at each of GP_COST_LANES, also over
# GP_FEW_POINTS (not a multiple of 8 or 16).
NARROW_HIDDENS, GROUP_WARPS, GP_FEW_POINTS, GP_LANES = (13, 13), (1, 2, 4), 100, (4, 8, 16, 32)
GP_COST_LANES = (1, 2, 4, 8, 16)
# K1's, K2's, K3's, K7's, K8's, K9's, K10's, K11's, K13's and K14's time is also
# taken at these K (ms_at_k); K1's, K2's, K3's, K7's, K10's, K11's, K13's and
# K14's also at SMALL_K: one 16-rollout group alone on an SM, and one block of
# four groups (K7: two and eight adjoint blocks).
K_SCALING, SMALL_K = (2048, 8192), (16, 64)
# K12 is also held at ragged K and over a seeded residual net of
# WIDE_HIDDENS (scale RES_WIDE_SCALE, no norms, as phase 19's); K1-K6 at a
# horizon of CEM_LONG_H (past two of the controls-ahead kernels' 64-control
# chunks, not a multiple of them), K5 timed at each of CEM_K (with tiles of
# min(K, DEFAULT_TILE_K)).  Over 130 steps the pole's float32 rounding
# grows until two correct float32 rollouts differ by more than KERNEL_TOL,
# so there K1-K6 are held to the float64 plain version as the
# committed GP is: within GP_F64_FACTOR times the float32 plain version's
# distance from it, plus 1e-6 of its largest cost.
RES_WIDE_SCALE, CEM_LONG_H, CEM_K = 0.02, 130, (16, 2048, 8192, 16384)
# The hidden the card carried over the GRU loop against the CPU replay.
HIDDEN_ATOL = 1e-4
# The adaptive-MPC and sparse-GP paths: bench_scale.py:build_residual_ctrl's
# and build_gp_mppi's MPPI (seed 3, SQRTRHOINV 0.05) and build_rpgd's
# rpgd-tf (seed 3), over "ODE+res" (hiddens (32, 32)) and the committed GP.
RES_MPPI_CONFIG = {**OPTIMIZER_CONFIG, "seed": 3, "SQRTRHOINV": 0.05}
RES_RPGD_CONFIG = {**RPGD_CONFIG, "seed": 3}
RES_SPEC, GP_SPEC = "ODE+res", f"SGP_128:{ASSETS / 'SGP_128.npz'}"
# examples/adaptive_mpc.py's mismatched plant and its OnlineSysId, with
# tests/test_online_sysid.py's minibatch of 32 so that a fit runs at every
# 50th tick from the first.
TRUE_PARAMS = {"m_pole": 0.4, "L": 0.6}
SYSID = {"capacity": 1024, "batch_size": 32, "learning_rate": 3e-3, "seed": 1}
ADAPT_TICKS, FIT_EVERY, FIT_STEPS = 200, 50, 300
RES_RPGD_TICKS, GP_TICKS, GP_MORE_TICKS, GP_RPGD_TICKS = 100, 200, 50, 100
# The GP re-fit: the loop's transitions plus random-policy ones
# (bench_scale.py:_gp_checkpoint's collection, seed 1).
REFIT_ENVS, REFIT_STEPS = 16, 200
# K14 and K10 are held to K11's and K7's bounds over a GP whose mean does
# not cancel in float32 (``well_conditioned_gp``, seed WELL_GP_SEED).  The
# committed GP's posterior weights are large and cancel, so in float32 the
# plain version and the kernel both sit ~1e-3 of the cost's scale from a
# float64 evaluation of the same arithmetic (the float64 plain version on
# the same card tensors): over it each kernel output is held to
# GP_F64_FACTOR times the plain version's own distance from float64, plus
# 1e-6 of the float64 output's largest entry.
WELL_GP_SEED, GP_F64_FACTOR = 7, 2.0
# The sampling paths: bench_scale.py:build_cem's CEM and build_icem's iCEM
# (seed 3), random-action at the same size, and the flagship MPPI with
# fully_fused (bench.py:177-195).
CEM_CONFIG = {"seed": 3, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
              "cem_outer_it": 2, "cem_initial_action_stdev": 0.5, "cem_stdev_min": 0.01,
              "cem_best_k": 256, "warmup": False, "warmup_iterations": 2}
ICEM_CONFIG = {**CEM_CONFIG, "icem_colored_noise_beta": 2.0}
RANDOM_CONFIG = {"seed": 3, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K}
FUSED_MPPI_CONFIG = {**OPTIMIZER_CONFIG, "fully_fused": True}
CEM_TICKS, FUSED_MPPI_TICKS, ZOO_TICKS = 200, 200, 50
# K3's pass 2 against its plain version: sums over 16384 weighted normals
# in another order, of magnitude <= ~1 (the weights sum to 1).
WEIGHTS_TOL = dict(rtol=1e-4, atol=1e-5)
# The card's and the CPU's regenerated elite controls: logf and cosf on
# the card and on the CPU differ by an ulp of the normal.
REGEN_ATOL = 1e-6
# Device cycles of sleep per timed call in cuda_ms: ~0.1 ms at the H100's
# 1.98 GHz boost clock, more than a wrapper's host time.
SLEEP_CYCLES_PER_CALL = 200_000
# Published H100 SXM peaks (NVIDIA's data sheet), for each kernel's bound;
# the dense TF32 tensor-core rate for the gradient kernels' mma bound.
HBM_BYTES_PER_S, FP32_OPS_PER_S, TF32_OPS_PER_S = 3.35e12, 67e12, 495e12
# FP32 operations per rollout-step of the cartpole plant, counted from
# csrc/plants.cuh and rollout_core.cuh (each add, multiply, divide, sine and
# cosine is one; a lower bound, since a division or a sine costs the card
# several): derivs 30, an rk4 step 172 (four derivs and the stage sums),
# the stage cost 24, K2's interpolation, clip and correction 16, K7's
# transposed rk4 step 437 and stage-cost gradient 26 (+6 to combine).
RK4_STEP_OPS, STAGE_OPS, MPPI_EXTRA_OPS, RK4_VJP_OPS, STAGE_VJP_OPS = 172, 24, 16, 437, 32
# One counter normal (csrc/counter_prng.cuh), integer operations counted
# at the FP32 rate: the counter's add, two splitmix32 hashes (three 32-bit
# multiplies, three shifts and three xors each), the second counter's add,
# two shifts by 8 and two conversions, the uniforms' add and two multiplies,
# -2*log, sqrt, 2*pi*u2, cos and the product: 32.  K5 adds mue + std*z and
# the clip (4) per control, K3 the noise scale (1) per normal in pass 1 and
# the weight's product and sum (2) in pass 2, plus 4 per rollout for the
# weight itself (the difference, scale, exp and division).
NORMAL_OPS, CEM_CONTROL_OPS, WEIGHT_OPS = 32, 4, 4
# The fleet path: bench_scale.py:345's batched MPPI (K=512 a session, H=35,
# inducing period 10, SQRTRHOINV 0.05, seed 1) and :356's batched fully-fused
# CEM (cem_outer_it 2, cem_best_k 40, warmup off, seed 1), B=32 sessions in
# the closed loops (examples/fleet_serving.py:48-99 without ZeroMQ; pole
# half-lengths over FLEET_L) and B=128 in the kernel comparisons; both sizes
# timed.  The K5-layout mutant of phase 36 uses tiles of FLEET_MUTANT_TILE.
FLEET_K, FLEET_H, FLEET_B, FLEET_B_MAX, FLEET_L = 512, 35, 32, 128, (0.35, 0.65)
FLEET_MPPI_CONFIG = {"seed": 1, "mpc_timestep": DT, "mpc_horizon": FLEET_H,
                     "num_rollouts": FLEET_K, "cc_weight": 1.0, "R": 1.0, "LBD": 100.0,
                     "NU": 1000.0, "SQRTRHOINV": 0.05, "period_interpolation_inducing_points": 10}
FLEET_CEM_CONFIG = {"seed": 1, "mpc_timestep": DT, "mpc_horizon": FLEET_H,
                    "num_rollouts": FLEET_K, "cem_outer_it": 2, "cem_best_k": 40,
                    "cem_initial_action_stdev": 0.5, "cem_stdev_min": 0.01, "warmup": False,
                    "fully_fused": True}
FLEET_MPPI_TICKS, FLEET_CEM_TICKS, FLEET_RETARGET_AT, FLEET_TIMING_TICKS = 200, 100, 100, 50
FLEET_MUTANT_TILE = 128
# The learned fleets: plain MPPI at the fleet's configuration over each
# learned model of the single-session phases (the committed MLP, GRU and
# GP, the seeded LSTM, "ODE+res" with a seeded nonzero residual and the
# slots' pole lengths per slot), one launch of the model's session-row
# kernel a tick.  Their kernels are compared at FLEET_B_MAX sessions, also
# at LEARNED_RAGGED_K rollouts a session (16-rollout groups straddle
# sessions); their loops run LEARNED_FLEET_TICKS at FLEET_B, a weight swap
# (the GP's a hot-swap, the residual a re-sysid of slot 2 and a new
# install) at LEARNED_SWAP_AT.
LEARNED_FLEETS = {"mlp": (MLP_SPEC, ()), "gru": (GRU_SPEC, ()), "lstm": (LSTM_SPEC, ()),
                  "residual": (RES_SPEC, ("L",)), "gp": (GP_SPEC, ())}
LEARNED_RAGGED_K, LEARNED_FLEET_TICKS, LEARNED_SWAP_AT = 120, 100, 50
# The gradient fleets, bench_scale.py:367-390's configurations: rpgd-tf
# (seed 7, outer_its 2, lr 0.05, keep 0.25, resamp_per 10, inducing period
# 10, warmup off) and gradient-tf (seed 9, 5 steps, gradmax_clip 5) over the
# ODE at 128 sessions of K=32, H=50 with per-slot pole lengths; rpgd-tf
# over the committed MLP, "ODE+res" (per-slot pole lengths) and the
# committed GP at 32 sessions of K=512 (:1170-1185's learned form).  Each
# Adam iteration is one launch of a gradient kernel's session-row form,
# the final scoring one of its cost kernel's.  The five forms are held to
# their plain versions at GRAD_COLS_B sessions of GRAD_COLS_KS rollouts (a
# multiple of neither 8 nor 16: blocks, K7's 8-rollout adjoint blocks and
# the 16-rollout groups straddle sessions) and timed at GRAD_COLS_SHAPES
# (sessions, rollouts a session); the loops run GRAD_FLEET_TICKS with the
# model changed (a weight swap, a GP hot-swap, a re-sysid) at
# GRAD_FLEET_SWAP_AT.
GRAD_FLEET_H = 50
GRAD_RPGD_CONFIG = {"seed": 7, "mpc_timestep": DT, "mpc_horizon": GRAD_FLEET_H,
                    "num_rollouts": 32, "outer_its": 2, "learning_rate": 0.05,
                    "opt_keep_k_ratio": 0.25, "resamp_per": 10,
                    "period_interpolation_inducing_points": 10, "warmup": False}
GRAD_GRADIENT_CONFIG = {"seed": 9, "mpc_timestep": DT, "mpc_horizon": GRAD_FLEET_H,
                        "num_rollouts": 32, "gradient_steps": 5, "learning_rate": 0.05,
                        "gradmax_clip": 5.0, "warmup": False}
GRAD_LEARNED_CONFIG = {**GRAD_RPGD_CONFIG, "num_rollouts": 512}
# label: (optimizer, config, spec, per_slot_dyn, sessions, the model's kind
# for fleet_swap (None: no swap), the gradient form's and the cost form's
# launch counters).
GRAD_FLEETS = {
    "rpgd_ode": ("rpgd-tf", GRAD_RPGD_CONFIG, "ODE", ("L",), 128, None,
                 "grad_cost_rollout_cols", "cost_rollout_cols"),
    "gradient_ode": ("gradient-tf", GRAD_GRADIENT_CONFIG, "ODE", ("L",), 128, None,
                     "grad_cost_rollout_cols", "cost_rollout_cols"),
    "rpgd_mlp": ("rpgd-tf", GRAD_LEARNED_CONFIG, MLP_SPEC, (), 32, "mlp",
                 "neural_grad_cost_rollout_cols", "neural_cost_rollout_cols"),
    "rpgd_residual": ("rpgd-tf", GRAD_LEARNED_CONFIG, RES_SPEC, ("L",), 32, "residual",
                      "residual_grad_cost_rollout_cols", "residual_cost_rollout_cols"),
    "rpgd_gp": ("rpgd-tf", GRAD_LEARNED_CONFIG, GP_SPEC, (), 32, "gp",
                "gp_grad_cost_rollout_cols", "gp_cost_rollout_cols"),
}
GRAD_COLS_B, GRAD_COLS_KS, GRAD_COLS_SHAPES = 32, 100, ((128, 32), (32, 512))
# K1's and K7's template instances: the single-session kernel (Rows false)
# and the session-row form (Rows true), as their mangled names end.
SINGLE, ROWS_FORM = "Lb0E", "Lb1E"
GRAD_FLEET_TICKS, GRAD_FLEET_SWAP_AT = 50, 25
# The PETS ensemble (bench_scale.py:499 build_ensemble_mppi, used at :1307,
# and :1419's rpgd-tf, both seed 3): MPPI (SQRTRHOINV 0.05) and rpgd-tf
# over the committed bootstrap ensemble of four mlp-32-32 members
# (ensemble-mlp-32-32-x4.npz, fitted by the JAX package), K=16384, H=50,
# from CartpoleEnv(seed=0)'s start: one launch of K11's member-block form
# a tick (rpgd-tf: two of K8's and one of K11's).  The forms are also held
# at ENS_RAGGED_K rollouts over the four members (300 a member: not a
# multiple of 16 or of a block), at E=1, over a seeded ensemble of
# ENS_MANY members with norms, without norms and in absolute form; MPPI
# also runs ENS_OPTION_TICKS with robust_eval "worst" and with
# risk_weight ENS_RISK.
ENS_SPEC = f"ensemble:mlp-32-32:4:{ASSETS}"
ENS_TICKS, ENS_RPGD_TICKS, ENS_OPTION_TICKS = 200, 200, 20
ENS_RAGGED_K, ENS_MANY, ENS_RISK = 1200, 8, 0.1
# The learned value terminal on the ODE path (costs/value_terminal.py; the
# MBVE / TD-MPC recipe, bench_scale.py:858): the emit_terminal forms of
# K1, K2 and K4 and K7's value_spec form are held to their plain versions
# at the main path's shapes (K4: the fleet's) and at VALUE_RAGGED_K, over
# a seeded random V of VALUE_DIMS (seed VALUE_SEED) at VALUE_SCALE, large
# enough that V moves dQ well past K7's bound; the loops run over the
# committed value net (value-mlp-32-32.npz, fitted by the JAX package,
# tests/test_torch_value.py:make_assets) from LEARNED_START: semi-fused
# MPPI VALUE_TICKS, rpgd-tf VALUE_RPGD_TICKS, MPPI at the short horizon
# VALUE_SHORT_H VALUE_SHORT_TICKS, the MPPI fleet (phase 40's) at FLEET_B
# VALUE_FLEET_TICKS.  A V swap (VALUE_SWAP_SEED, VALUE_SWAP_SCALE) rebuilds
# nothing.  The terminal states are held to X_TOL (|x_H| < ~20 over 50
# rk4 steps: FMA contraction against separate rounding), whose bound must
# reject x_{H-1} in place of x_H and rollout k+1's x_H by VALUE_MARGIN
# times its absolute part; so must K7's dQ bound each of its three wrong
# variants.
VALUE_FILE = ASSETS / "value-mlp-32-32.npz"
VALUE_DIMS, VALUE_SEED, VALUE_SCALE, VALUE_SWAP_SEED, VALUE_SWAP_SCALE = (4, 32, 32, 1), 5, \
    100.0, 6, 50.0
VALUE_RAGGED_K, VALUE_MARGIN = 1000, 10.0
VALUE_TICKS, VALUE_RPGD_TICKS, VALUE_SHORT_H, VALUE_SHORT_TICKS, VALUE_FLEET_TICKS = \
    200, 100, 10, 100, 50
X_TOL = dict(rtol=1e-4, atol=1e-4)
# The learned value terminal over the learned dynamics: the loops (MPPI
# over each learned model of the single-session phases at their configs,
# CEM over the MLP) run VALUE_LEARNED_TICKS from LEARNED_START over the
# committed value net, the valued fleets (MLP, "ODE+res", GP at FLEET_B)
# VALUE_LEARNED_FLEET_TICKS.
VALUE_LEARNED_TICKS, VALUE_LEARNED_FLEET_TICKS = 100, 50
# The learned value terminal in the gradient kernels: the value_spec forms
# of K8 (and its member-block form), K9 and K10 at their phase operands
# (12, 50, 19, 21) and their session-row forms, with K7's and K1's emit
# form, at phase 45's; rpgd-tf over each learned model VALUE_GRAD_TICKS
# from LEARNED_START (gradient-tf over the MLP VALUE_GRADIENT_TICKS), the
# valued gradient fleets at FLEET_B sessions VALUE_GRAD_FLEET_TICKS.  Over
# the committed V (slope up to ~1e5 a unit of state) a form is held, as
# the committed GP is (gp_vs_float64), to its float64 plain version:
# no further from it than GP_F64_FACTOR times the float32 plain version.
VALUE_GRAD_TICKS, VALUE_GRADIENT_TICKS, VALUE_GRAD_FLEET_TICKS = 100, 50, 50
# The fast plant (the ":fast" predictors: ops/fastmath.py's polynomial
# trig, csrc/fastmath.cuh; the fully-fused kernels over it draw the fast
# normals).  Each fast entry is held to its plain version at its exact
# entry's bound and to the exact entry on the same inputs: non-zero and
# within FAST_FROM_EXACT, the JAX package's bound on a fast rollout's
# distance from the exact one (tests/test_fastmath.py, atol 5e-3 on the
# states), on the costs (to ~3e3) relative too: on the main path's
# operands the two plain versions' costs differ by rel 3.0e-4 (0.083).
# The fast flagship runs FAST_TICKS from CartpoleEnv(seed=0), every other
# fast path FAST_SHORT_TICKS (the adaptive one FAST_ADAPT_TICKS, a sysid
# fit every FAST_FIT_EVERY).  K7-fast's dQ bound must reject the adjoint
# that takes the fast values with the exact derivatives (cos, -sin): the
# two differ by at most 2.2e-4, most at |angle| near pi, so that check
# runs from angles over +-FAST_WIDE_ANGLE.
FAST_SPEC, RES_FAST_SPEC = "ODE:rk4:1:fast", "ODE+res:rk4:1:fast"
FAST_FROM_EXACT = dict(rtol=5e-3, atol=5e-3)
FAST_TICKS, FAST_SHORT_TICKS, FAST_ADAPT_TICKS, FAST_FIT_EVERY = 200, 20, 80, 40
FAST_WIDE_ANGLE = 3.1
# The rest of the zoo on cartpole (phases 69-73), closed loop at the main
# path's K and H, seed 3, ZOO_TICKS each over the ODE and FAST_SHORT_TICKS
# over the fast plant: cem-gmm at CEM_CONFIG's sizes; cma-es at
# bench_scale.py:build_cma's (cma_outer_it 3, step 0.3, cma_mu K/2), full
# and diagonal; mppi-var semi-fused at OPTIMIZER_CONFIG's MPPI sizes with
# LR 1000; cem-naive-grad and cem-grad-bharadhwaj at their
# config_optimizers.yml defaults with K and H raised to the flagship's
# (and Bharadhwaj over the committed MLP, MLP_ZOO_TICKS from
# LEARNED_START); the mppi-var fleet at
# bench_scale.py:measure_batched_var's configuration (B=128, K=512, H=35,
# SQRTRHOINV_mc 0.05, LR 1000, seed 3), every slot active, and a valued one
# at FLEET_B over the committed V, VAR_FLEET_TICKS each.  At LR 1000 each
# session's sigma runs to a bound within a few ticks, and a few sessions of
# 128 lose the pole in 50 ticks in both packages (on the CPU from these
# starts: the JAX package's fleet 4, the port's 3;
# `PYTHONPATH=. python tests/test_torch_mppi_var.py --fleet`), so the fleet
# loop counts the slots that kept it and does not require them all.
GMM_CONFIG = {"seed": 3, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
              "cem_outer_it": 2, "cem_initial_action_stdev": 0.5, "cem_stdev_min": 0.01,
              "cem_best_k": 256}
CMA_CONFIG = {"seed": 3, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
              "cma_outer_it": 3, "cma_initial_step_size": 0.3, "cma_diagonal": False,
              "warmup": False}
CMA_DIAG_CONFIG = {**CMA_CONFIG, "cma_diagonal": True}
VAR_CONFIG = {"seed": 3, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
              "cc_weight": 1.0, "R": 1.0, "LBD_mc": 100.0, "NU_mc": 1000.0,
              "SQRTRHOINV_mc": 0.03, "period_interpolation_inducing_points": PERIOD,
              "LR": 1000.0}
NAIVE_GRAD_CONFIG = {"seed": 3, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
                     "cem_outer_it": 1, "cem_stdev_min": 0.1, "cem_initial_action_stdev": 0.5,
                     "cem_best_k": 40, "learning_rate": 0.1, "gradmax_clip": 10}
BHARADHWAJ_CONFIG = {"seed": 3, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
                     "learning_rate": 0.05, "adam_beta_1": 0.9, "adam_beta_2": 0.999,
                     "adam_epsilon": 1e-8, "cem_best_k": 8, "cem_outer_it": 2,
                     "cem_initial_action_stdev": 2.0, "cem_stdev_min": 1e-6, "gradmax_clip": 5,
                     "warmup": False, "warmup_iterations": 250}
FLEET_VAR_CONFIG = {"seed": 3, "mpc_timestep": DT, "mpc_horizon": FLEET_H,
                    "num_rollouts": FLEET_K, "cc_weight": 1.0, "R": 1.0, "LBD_mc": 100.0,
                    "NU_mc": 1000.0, "SQRTRHOINV_mc": 0.05,
                    "period_interpolation_inducing_points": 10, "LR": 1000.0}
MLP_ZOO_TICKS, VAR_FLEET_TICKS = 20, 50
# The pendulum, acrobot and point-mass plants (phases 74-76).  Their
# kernels are held at K=16384, H=50 over the demos' costs (the point mass's
# target and obstacles, PM_ATTRS), also at PLANT_RAGGED_K and
# PLANT_ODD_H; their flagship-width loops run PLANT_TICKS at
# OPTIMIZER_CONFIG's and the zoo's configurations.  The demos:
# examples/swingup_demo.py:20-25 (the pendulum at K=512, H=50; the acrobot
# at K=700, H=40, dt 0.05, cc_weight 0) and tests/test_obstacle_cost.py's
# point mass (dt 0.05, H=40, K=512, the obstacle at the origin, from (-1, 0)
# to (1, 0)) under rpgd-tf and CEM; the pendulum and the acrobot start from
# their environments' seed 2 (the demo's).
PLANT_CASES = {  # device plant: (environment, cost specification, predictor)
    "pendulum": ("pendulum", None, "ODE"),
    "pendulum_fast": ("pendulum", None, FAST_SPEC),
    "acrobot": ("acrobot", None, "ODE"),
    "acrobot_fast": ("acrobot", None, FAST_SPEC),
    "pointmass": ("pointmass", None, "ODE"),
    "pointmass_obstacles": ("pointmass", "obstacles", "ODE"),
}
PM_DEMO_ATTRS = {"target_x": 1.0, "target_y": 0.0, "obs0_x": 0.0, "obs0_y": 0.0, "obs0_r": 0.3}
PM_ATTRS = {**PM_DEMO_ATTRS, "obs1_x": 0.35, "obs1_y": -0.3, "obs1_r": 0.1}
PLANT_RAGGED_K, PLANT_ODD_H, PLANT_TICKS = 700, 45, 10
# FP32 operations per rollout-step of each plant (counted from
# csrc/plants.cuh as RK4_STEP_OPS is, a sine or cosine one operation, the
# fast plants' polynomials counted as the exact trig): the rk4 step (four
# derivs and the stage sums: derivs 10 for the pendulum, 65 for the
# acrobot, 9 for the point mass), the stage cost (the obstacles' three
# hinges 12 each), K7's transposed rk4 step (four Jacobian evaluations,
# 15, 115 and 6, the tangent products and the chain's) and the stage-cost
# gradient.
PLANT_OPS = {"pendulum": (66, 27, 128, 20), "acrobot": (312, 24, 660, 30),
             "pointmass": (88, 26, 256, 20), "pointmass_obstacles": (88, 64, 256, 56)}
PLANT_DEMO_MPPI = {
    "pendulum": {"seed": 5, "mpc_timestep": 0.02, "mpc_horizon": 50, "num_rollouts": 512,
                 "cc_weight": 1.0, "R": 1.0, "LBD": 5.0, "NU": 1000.0, "SQRTRHOINV": 0.2,
                 "period_interpolation_inducing_points": 5},
    "acrobot": {"seed": 5, "mpc_timestep": 0.05, "mpc_horizon": 40, "num_rollouts": 700,
                "cc_weight": 0.0, "R": 1.0, "LBD": 20.0, "NU": 1000.0, "SQRTRHOINV": 0.6,
                "period_interpolation_inducing_points": 4},
}
PENDULUM_DEMO_TICKS, ACROBOT_DEMO_TICKS, POINTMASS_DEMO_TICKS = 200, 150, 150
POINTMASS_DEMO = {
    "rpgd-tf": {"seed": 1, "mpc_timestep": 0.05, "mpc_horizon": 40, "num_rollouts": 512,
                "outer_its": 2, "SAMPLING_DISTRIBUTION": "normal", "sample_stdev": 0.5,
                "period_interpolation_inducing_points": 5, "learning_rate": 0.05,
                "gradmax_clip": 5, "opt_keep_k_ratio": 0.25, "resamp_per": 10, "warmup": False,
                "warmup_iterations": 3},
    "cem-tf": {"seed": 1, "mpc_timestep": 0.05, "mpc_horizon": 40, "num_rollouts": 512,
               "cem_outer_it": 2, "cem_best_k": 32, "cem_initial_action_stdev": 0.5,
               "cem_stdev_min": 0.01},
}


def emit(phase: str, numbers: dict) -> None:
    print(f"{phase}: {json.dumps(numbers)}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after warm-up.
    The card first sleeps SLEEP_CYCLES_PER_CALL per call, untimed, while the
    host enqueues the calls, so that a kernel shorter than its wrapper's
    host time (K3's pass 2) is timed back to back on the device and not at
    the host's pace."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, kernel_fn, plain_fn, tol=KERNEL_TOL, extra=None, reduce=None,
            shape=None) -> dict:
    """A kernel against its plain version on the same card tensors, both
    outputs through ``reduce`` (if given) before the comparison; the times
    are the functions' own."""
    got, ref = kernel_fn(), plain_fn()
    if reduce is not None:
        got, ref = reduce(got), reduce(ref)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    numbers = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / ref.abs().clamp_min(1e-6)).max()),
        "finite": bool(torch.isfinite(got).all()),
        "ms": cuda_ms(kernel_fn, 50),
        "plain_ms": cuda_ms(plain_fn, 3),
        **(extra(ref) if extra else {}),
    }
    emit(name, numbers)
    check(numbers["finite"] and got.shape == (shape or (K,)), f"{name}: bad output")
    check(torch.allclose(got, ref, **tol), f"{name}: kernel disagrees with plain {numbers}")
    return numbers


def close(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol_frac: float) -> bool:
    """allclose with the absolute bound a fraction of ref's largest entry."""
    return torch.allclose(got, ref, rtol=rtol, atol=atol_frac * float(ref.abs().max()))


def max_errors(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = (got - ref).abs()
    return float(err.max()), float((err / ref.abs().clamp_min(1e-6)).max())


def make_controller(device: str, optimizer: str = "mppi", config=None, spec: str = "ODE",
                    **extra) -> MPCController:
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": optimizer, "controller_logging": False,
                                 "device": device})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config={**(config or OPTIMIZER_CONFIG), **extra},
                   cost_function_config=COST_WEIGHTS)
    return ctrl


def counted_loop(name: str, ctrl: MPCController, ticks: int, expected: dict, **loop) -> dict:
    """A closed loop with every kernel's launch count set to 0 just before
    it; checks the counts read just after it against ``expected`` (kernel ->
    launches; every other kernel 0) and returns them."""
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    closed_loop(name, ctrl, ticks, **loop)
    counts = {kernel: wrapper.launches for kernel, wrapper in COUNTED.items()}
    check(counts == {kernel: expected.get(kernel, 0) for kernel in COUNTED},
          f"{name}: kernel launches {counts}, expected {expected}")
    return counts


def closed_loop(name: str, ctrl: MPCController, ticks: int, retarget_at=None,
                pole_check: bool = True, trace=None, start=None, env_params=None,
                on_tick=None) -> dict:
    """``ticks`` closed-loop ticks against CartpoleEnv (with ``env_params``
    in place of its defaults), from its seed's state or ``start``; ``trace``
    (a list) receives each tick's (state, applied control), ``on_tick(t, s,
    u, s_next)`` is called after each plant step, outside the timing."""
    env = CartpoleEnv(batch_size=1, dt=DT, seed=SEED, params=env_params)
    s, _ = env.reset()
    if start is not None:
        env.state = torch.tensor(start[None])
        s = start[None].copy()
    builds, epoch = kernels.build.count, ctrl.optimizer._build_epoch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host_ms, device_ms, max_angle, fell_at = [], [], 0.0, None
    for t in range(ticks):
        attrs = {"target_position": NEW_TARGET} if t == retarget_at else None
        start.record()
        t0 = time.perf_counter()
        u = ctrl.step(s[0], updated_attributes=attrs)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
        check(u.shape == (1,) and bool(np.all(np.isfinite(u))) and abs(float(u[0])) <= 1.0,
              f"{name}: tick {t}: bad control {u}")
        if trace is not None:
            trace.append((s[0].copy(), u.copy()))
        s_prev = s
        s, *_ = env.step(u)
        if on_tick is not None:
            on_tick(t, s_prev[0], u, s[0])
        max_angle = max(max_angle, abs(float(s[0, 2])))
        if fell_at is None and max_angle >= 0.5:
            fell_at = t
        check(not pole_check or max_angle < 0.5, f"{name}: tick {t}: the pole fell, state {s[0]}")
    check(kernels.build.count == builds and ctrl.optimizer._build_epoch == epoch,
          f"{name}: something was rebuilt during the loop")
    numbers = {
        "ticks": ticks,
        "step_host_p50_ms": float(np.percentile(host_ms, 50)),
        "step_host_p99_ms": float(np.percentile(host_ms, 99)),
        "step_device_p50_ms": float(np.percentile(device_ms, 50)),
        "step_device_p99_ms": float(np.percentile(device_ms, 99)),
        "max_abs_angle": max_angle,
        "fell_at_tick": fell_at,
        "final_state": [float(v) for v in s[0]],
    }
    emit(name, numbers)
    return numbers


def k1_read_mutants(Q: torch.Tensor) -> dict:
    """Q [K, H, U] read wrongly by K1: ``controls_one_step_early`` (step h
    scores and steps with Q[:, h+1], the last step its own: a prefetch off
    by one) and ``next_rollout_row`` (rollout k reads rollout k+1's row)."""
    return {"controls_one_step_early": torch.cat([Q[:, 1:], Q[:, -1:]], dim=1),
            "next_rollout_row": Q.roll(-1, 0)}


def k1_cases(model, s0, Q, pvec) -> dict:
    """Phase 2's further K1 numbers: the costs at each RAGGED_K, with the
    euler integrator and with two rk4 sub-steps, each to KERNEL_TOL; at a
    horizon of CEM_LONG_H against float64 (long_horizon_vs_float64); the
    bound's distance to the plain version over k1_read_mutants' controls;
    the time at SMALL_K + K_SCALING; its resources and the loops of its
    SASS (the step's instructions)."""
    cases = {f"K{k}": (model, *first_k(k, s0, Q)) for k in RAGGED_K}
    cases["euler"] = (dataclasses.replace(model, integrator="euler"), s0, Q)
    cases["rk4x2"] = (dataclasses.replace(model, intermediate_steps=2), s0, Q)
    numbers = held_to_plain("K1", cost_rollout, cost_rollout_plain,
                            {case: (*a, pvec) for case, a in cases.items()})
    numbers["mutant_max_rel_err"] = rejected(
        "K1", {kind: cost_rollout_plain(model, s0, q, pvec)
               for kind, q in k1_read_mutants(Q).items()}, cost_rollout_plain(model, s0, Q, pvec))
    gen = torch.Generator(device=s0.device).manual_seed(SEED + 1)
    q_long = torch.clamp(0.3 * torch.randn(s0.shape[0], CEM_LONG_H, 1, generator=gen,
                                           device=s0.device), -1.0, 1.0)
    numbers[f"H{CEM_LONG_H}"] = long_horizon_vs_float64(
        model, s0, q_long, pvec, {"k1": cost_rollout(model, s0, q_long, pvec)})
    out = {"cases": numbers,
           "ms_at_k": ms_at_k(lambda k: cost_rollout(model, *first_k(k, s0, Q), pvec),
                              SMALL_K + K_SCALING),
           **ptxas_resources("cost_rollout_kernel", SINGLE),
           "sass": sass_loops("cost_rollout_kernel", SINGLE) or "not measured"}
    emit("k1_cases", out)
    return out


def stage_term_mutants(dQ, Q, pvec, model) -> dict:
    """dQ as a K7 would return it that dropped one term of the stage cost's
    gradient or put the control-change term's ``gprev`` on the wrong step
    (dQ_h holds ct*2*cc*R*u_h + change_h - change_{h+1}, with change_h =
    ct*2*ccrc*(u_h - u_{h-1}) and ct = 1/(H+1))."""
    p = model.unpack(pvec)
    ct = 1.0 / (Q.shape[1] + 1)
    prev = torch.cat([p["__u_prev_0"].expand(Q.shape[0], 1, 1), Q[:, :-1]], dim=1)
    change = ct * 2.0 * p["c_ccrc_weight"] * (Q - prev)
    change_next = torch.cat([change[:, 1:], torch.zeros_like(change[:, :1])], dim=1)
    return {"no_control_cost": dQ - ct * 2.0 * p["c_cc_weight"] * p["c_R"] * Q,
            "no_change_cost": dQ - change + change_next,
            "no_gprev": dQ + change_next,
            "gprev_on_step_h": dQ - change + change_next - change}


def compare_grad(name: str, model, Q, pvec, kernel_fn, plain_fn, reps: int = 50,
                 mutants=None) -> dict:
    """Phases 7 (K7) and 21 (K10): a gradient kernel's ``kernel_fn() ->
    (cost, dQ)`` against its plain version's on the same card tensors, J to
    KERNEL_TOL and dQ to DQ_RTOL plus DQ_ATOL_FRAC of max|dQ|; and that dQ
    bound against the kernel's dQ with one stage-gradient term wrong
    (``stage_term_mutants``) and against ``mutants``, further wrong dQs by
    name."""
    (cost, dQ), (ref_cost, ref_dQ) = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    cost_abs, cost_rel = max_errors(cost, ref_cost)
    dq_abs, _ = max_errors(dQ, ref_dQ)
    wrong = {**stage_term_mutants(dQ, Q, pvec, model), **(mutants or {})}
    numbers = {
        "cost_max_abs_err": cost_abs, "cost_max_rel_err": cost_rel,
        "dQ_max_abs_err": dq_abs, "dQ_max_abs": float(ref_dQ.abs().max()),
        "dQ_atol": DQ_ATOL_FRAC * float(ref_dQ.abs().max()), "dQ_rtol": DQ_RTOL,
        "mutant_max_abs_err": {k: max_errors(m, ref_dQ)[0] for k, m in wrong.items()},
        "max_abs_err": max(cost_abs, dq_abs),
        "finite": bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()),
        "ms": cuda_ms(kernel_fn, reps),
        "plain_ms": cuda_ms(plain_fn, 3),
    }
    emit(name, numbers)
    check(numbers["finite"] and cost.shape == (K,) and dQ.shape == Q.shape, f"{name}: bad output")
    check(torch.allclose(cost, ref_cost, **KERNEL_TOL), f"{name}: cost disagrees with plain {numbers}")
    check(close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC), f"{name}: dQ disagrees with plain {numbers}")
    for k, mutant in wrong.items():
        check(not close(mutant, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC),
              f"{name}: the dQ bound does not reject a dQ with {k} {numbers}")
    return numbers


def k7_cases(model, s0, Q, pvec) -> dict:
    """Phase 7's further K7 numbers: J and dQ at each RAGGED_K to the same
    bounds, the time at K_SCALING, its forward and adjoint launches timed
    apart, and both kernels' resources (ptxas' registers, spills and static
    shared memory, the adjoint's blocks per SM)."""
    cases = {}
    for k in RAGGED_K:
        s, q = first_k(k, s0, Q)
        (cost, dQ), (ref_cost, ref_dQ) = (grad_cost_rollout(model, s, q, pvec),
                                          grad_cost_rollout_plain(model, s, q, pvec))
        torch.cuda.synchronize()
        cases[f"K{k}"] = got = {"cost_max_abs_err": max_errors(cost, ref_cost)[0],
                                "dQ_max_abs_err": max_errors(dQ, ref_dQ)[0],
                                "dQ_max_abs": float(ref_dQ.abs().max())}
        check(bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()) and dQ.shape == q.shape,
              f"K7 K{k}: bad output {got}")
        check(torch.allclose(cost, ref_cost, **KERNEL_TOL), f"K7 K{k}: cost disagrees {got}")
        check(close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC), f"K7 K{k}: dQ disagrees {got}")
    cost, dQ = torch.empty(K, device=s0.device), torch.empty_like(Q)
    xhist = torch.empty(Q.shape[1] + 1, s0.shape[1], K, device=s0.device)
    numbers = {
        "cases": cases,
        "ms_at_k": ms_at_k(lambda k: grad_cost_rollout(model, *first_k(k, s0, Q), pvec),
                           SMALL_K + K_SCALING),
        # The forward first: the adjoint is timed over the states it stored.
        "part_ms": {part: cuda_ms(lambda: launch_part(part, model, s0, Q, pvec, cost, dQ, xhist),
                                  50)
                    for part in ("forward", "adjoint")},
        "forward": ptxas_resources("grad_cost_forward_kernel", SINGLE),
        "adjoint": {**ptxas_resources("grad_cost_adjoint_kernel", SINGLE),
                    "blocks_per_sm": int(kernels.load().ctt_grad_cost_adjoint_blocks_per_sm(0))},
    }
    emit("k7_cases", numbers)
    return numbers


def to_cpu(tree):
    """A params tree (dicts, records such as the Adam state, and tuples of
    tensors) with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_cpu(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(to_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def update_vs_cpu_mppi(name: str, ctrl: MPCController, spec: str = "ODE", config=None,
                       value=None) -> None:
    """Phases 6, 17 and 26: one MPPI update on the card and on the CPU (the
    plain versions) from the card's state and params (a recurrent net's
    live hidden included), with one draw; ``value``: the learned terminal
    value the CPU's controller gets too (phase 58)."""
    opt = ctrl.optimizer
    state = opt.opt_state
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    noise = opt.sample_noise(state)
    params = ctrl._assemble_params()
    _, _, diag = opt.update(state, s_now, params, noise)
    cpu = make_controller("cpu", spec=spec, config=config)
    if value is not None:
        attach_value_terminal(cpu, to_cpu(value))
    cpu_state = mppi_state_from_numpy(state.u_nom.cpu().numpy(), state.u_prev.cpu().numpy(),
                                      torch.Generator())
    _, _, cpu_diag = cpu.optimizer.update(cpu_state, s_now.cpu(), to_cpu(params), noise.cpu())
    numbers = {"u_nom_max_abs_err": float((diag["u_nom"].cpu() - cpu_diag["u_nom"]).abs().max())}
    if "J_logged" in diag:
        numbers["cost_max_abs_err"] = float((diag["J_logged"].cpu() - cpu_diag["J_logged"]).abs().max())
    emit(name, numbers)
    check(numbers["u_nom_max_abs_err"] <= UNOM_ATOL,
          f"{name}: the card's update differs from the CPU's {numbers}")


def update_vs_cpu_rpgd(ctrl: MPCController, name: str = "rpgd_update_vs_cpu",
                       spec: str = "ODE", config=None, value=None) -> None:
    """Phases 10, 17 and 26: one rpgd-tf update on the card and on the CPU
    (the plain versions) from the card's state and params, on a resample
    tick, with one draw; ``value`` as update_vs_cpu_mppi's.

    Adam's step from zero moments is about lr * sign(g) whatever |g|: where
    a gradient entry and its moments' history are both within the dQ
    bound's absolute part of 0 (DQ_ATOL_FRAC of max|g|), the function does
    not determine that step, and the two devices may move the row apart by
    up to 2 lr.  A row of the population whose Q differs beyond the bound
    must be such a row, and at most UNDETERMINED_MAX of K may differ; the
    costs and moments of every other row are held to the bound."""
    opt = ctrl.optimizer
    state = opt.opt_state
    check(state.count % opt.resamp_per == 0, f"tick {state.count} is not a resample tick")
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    draw = opt.sample_resample(state)
    params = ctrl._assemble_params()
    u, new, diag = opt.update(state, s_now, params, draw)

    cpu = make_controller("cpu", "rpgd-tf", config or RPGD_CONFIG, spec=spec)
    if value is not None:
        attach_value_terminal(cpu, to_cpu(value))
    host = [t.cpu().numpy() for t in (state.Q, state.adam.m, state.adam.v,
                                      state.trajectory_ages, state.u_prev)]
    cpu_state = rpgd_state_from_numpy(host[0], host[1], host[2], state.adam.step, host[3],
                                      state.count, host[4], torch.Generator())
    uc, new_c, cdiag = cpu.optimizer.update(cpu_state, s_now.cpu(), to_cpu(params), draw.cpu())

    s_tiled = s_now.expand(K, -1).contiguous()
    g = opt._make_grad_and_cost_only()[0](state.Q, s_tiled, state.u_prev, params).cpu()
    g_c = cpu.optimizer._make_grad_and_cost_only()[0](cpu_state.Q, s_tiled.cpu(),
                                                      cpu_state.u_prev, to_cpu(params))
    noise = DQ_ATOL_FRAC * float(g_c.abs().max())
    undetermined = ((g_c.abs() <= noise) & (cpu_state.adam.v.sqrt() <= noise)).flatten(1).any(1)
    Q_card, Q_cpu = diag["Q_logged"].cpu(), cdiag["Q_logged"]
    atol = UPDATE_ATOL_FRAC * float(Q_cpu.abs().max())
    off = ((Q_card - Q_cpu).abs() > atol + UPDATE_RTOL * Q_cpu.abs()).flatten(1).any(1)
    held = ~off

    # After the surgery the fresh rows' moments are zero on both sides and
    # each elite's row sits where its side ranked it (ties too, so each
    # side's order is its own top-k's); elites are matched by index.
    cost, cost_c = diag["J_logged"].cpu(), cdiag["J_logged"]
    keep, fresh = opt.opt_keep_k, K - opt.opt_keep_k
    rank, rank_c = (torch.full((K,), -1).index_put_((elite_indices(c, keep).cpu(),),
                                                    torch.arange(keep))
                    for c in (diag["J_logged"], cost_c))
    both = (rank >= 0) & (rank_c >= 0) & held
    rows = torch.cat([torch.arange(fresh), fresh + rank[both]])
    rows_c = torch.cat([torch.arange(fresh), fresh + rank_c[both]])
    pairs = {"m": (new.adam.m.cpu()[rows], new_c.adam.m[rows_c]),
             "v": (new.adam.v.cpu()[rows], new_c.adam.v[rows_c]),
             "cost": (cost[held], cost_c[held])}
    same_best = int(torch.argmin(cost)) == int(torch.argmin(cost_c))
    numbers = {"Q_max_abs_err": max_errors(Q_card, Q_cpu)[0],
               "Q_rows_off": int(off.sum()), "Q_rows_off_undetermined": int((off & undetermined).sum()),
               **{f"{k}_max_abs_err": max_errors(*ab)[0] for k, ab in pairs.items()}}
    numbers.update({"cost_max_rel_err": max_errors(*pairs["cost"])[1],
                    "grad_max_abs_err": max_errors(g, g_c)[0],
                    "grad_max_abs": float(g_c.abs().max()),
                    "undetermined_rows": int(undetermined.sum()),
                    "elites_in_both": int(both.sum()), "elites": keep, "same_best": same_best,
                    "u_abs_err": float((u.cpu() - uc).abs().max())})
    emit(name, numbers)
    check(numbers["Q_rows_off"] == numbers["Q_rows_off_undetermined"]
          and numbers["Q_rows_off"] <= UNDETERMINED_MAX * K,
          f"{name}: Q on the card differs from the CPU {numbers}")
    for k, (a, b) in pairs.items():
        check(close(a, b, UPDATE_RTOL, UPDATE_ATOL_FRAC),
              f"{name}: {k} on the card differs from the CPU {numbers}")
    check(not same_best or close(u.cpu(), uc, UPDATE_RTOL, UPDATE_ATOL_FRAC),
          f"{name}: u differs {numbers}")


# ---- bounds ---------------------------------------------------------------------
def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def bound(ops: float, n_bytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def mlp_dims(net) -> list:
    n = mlp_layer_count(net)
    return [net["w0"].shape[0]] + [net[f"w{i}"].shape[1] for i in range(n)]


def mlp_ops(net) -> int:
    """FP32 operations of one MLP step: two per multiply-add and one per bias
    add of each layer, a tanh per hidden unit, two per normalized input and
    output, and the delta add."""
    dims = mlp_dims(net)
    ops = sum(2 * a * b + b for a, b in zip(dims, dims[1:])) + sum(dims[1:-1]) + dims[-1]
    return ops + 2 * dims[0] * ("norm_in_mean" in net) + 2 * dims[-1] * ("norm_out_mean" in net)


def mlp_vjp_ops(net) -> int:
    """The transposed MLP step beyond its forward re-run: two per
    multiply-add of each layer, three per hidden unit for tanh' (a*a, 1 - it,
    times g), one per normalized input and output, and the delta add."""
    dims = mlp_dims(net)
    ops = sum(2 * a * b for a, b in zip(dims, dims[1:])) + 3 * sum(dims[1:-1]) + dims[-1]
    return ops + dims[0] * ("norm_in_mean" in net) + dims[-1] * ("norm_out_mean" in net)


def mlp_forward_tiles(net) -> int:
    """m16n8k8 tiles of one MLP step over 16 rows, each layer's k-blocks
    times its output tiles, widths padded to 8: K11's products
    (csrc/mlp_units.cuh)."""
    tiles = [-(-d // 8) for d in mlp_dims(net)]
    return sum(a * b for a, b in zip(tiles, tiles[1:]))


def mma_tiles(net) -> int:
    """m16n8k8 tiles of one step of the gradient kernels' MLP over a warp's
    16 rows (csrc/mlp_mma.cuh): the forward, the backward's re-run (its last
    layer skipped) and the transposed layers, each layer's widths padded
    to 8."""
    tiles = [-(-d // 8) for d in mlp_dims(net)]
    layers = [a * b for a, b in zip(tiles, tiles[1:])]
    return 2 * sum(layers) + sum(layers[:-1])


def mlp_scalar_ops(net) -> int:
    """The gradient kernels' MLP work outside the products, per step: the
    forward's and the re-run's biases, tanh, norms and delta add, and the
    transposed step's tanh', norms and delta add (mlp_ops and mlp_vjp_ops
    without their multiply-adds)."""
    dims = mlp_dims(net)
    macs = 2 * sum(a * b for a, b in zip(dims, dims[1:]))
    return 2 * (mlp_ops(net) - macs) + (mlp_vjp_ops(net) - macs)


def tc_bound_ms(tiles: int, scalar_ops: int, rollout_steps: int = K * H) -> float:
    """A tensor-core kernel's bound over ``rollout_steps`` rollout-steps (the
    main path's K*H): its split products (``tiles`` m16n8k8 tiles a step of
    16 rollouts, 3 mma a tile, 2 * 16 * 8 * 8 operations each) over the
    TF32 rate plus ``scalar_ops`` a rollout-step over the FP32 rate."""
    mma_ops = rollout_steps * tiles * 3 * 2 * 8 * 8
    return (mma_ops / TF32_OPS_PER_S + rollout_steps * scalar_ops / FP32_OPS_PER_S) * 1e3


def rnn_cells(net) -> list:
    """(input width, hidden width) of each cell."""
    return [(net[f"cell{i}"]["wi"].shape[0], net[f"cell{i}"]["wh"].shape[0])
            for i in range(sum(1 for k in net if k.startswith("cell")))]


def rnn_macs(net, kind: str) -> int:
    """Multiply-adds of one recurrent step: x @ wi and h @ wh of each cell
    and the head."""
    gates = 3 if kind == "gru" else 4
    return sum((d_in + hd) * gates * hd for d_in, hd in rnn_cells(net)) + net["wo"].numel()


def rnn_ops(net, kind: str) -> int:
    """FP32 operations of one recurrent step: two per multiply-add
    (rnn_macs); per cell the two bias adds per gate unit, then per hidden
    unit 17 (GRU: two sigmoids of four, a tanh, the r * gh product and the
    sums, the blend) or 22 (LSTM: three sigmoids, two tanh, the gate sums,
    the c and h updates); the head's bias; the delta add."""
    gates, per_unit = (3, 17) if kind == "gru" else (4, 22)
    S = net["wo"].shape[1]
    return (2 * rnn_macs(net, kind) + sum((2 * gates + per_unit) * hd for _, hd in rnn_cells(net))
            + S + S)


def rnn_mma_tiles(net, kind: str) -> int:
    """m16n8k8 tiles of one step of K13 over a group's 16 rows
    (csrc/rnn_mma.cuh): per cell, each gate's unit tiles times the k-blocks
    of its input and of its hidden, widths padded to 8; the head's one
    output tile times its k-blocks."""
    gates = 3 if kind == "gru" else 4
    tiles = sum(gates * -(-hd // 8) * (-(-d_in // 8) + -(-hd // 8)) for d_in, hd in rnn_cells(net))
    return tiles + -(-net["wo"].shape[0] // 8)


# ---- the learned-dynamics phases ------------------------------------------------
def net_mutants(net) -> dict:
    """The MLP with norm_out dropped; with tanh on its last layer (an
    identity layer appended, so the old last layer gets the tanh); and with
    the last unit tile of its last hidden layer lost (the tile's 8 columns
    of w{n-2} and b{n-2} zeroed, what K11 computes if the warp that owns the
    tile skips it)."""
    n, S = mlp_layer_count(net), net[f"w{mlp_layer_count(net) - 1}"].shape[1]
    dev = net["w0"].device
    w, b = net[f"w{n - 2}"].clone(), net[f"b{n - 2}"].clone()
    tile = slice(8 * ((b.numel() - 1) // 8), None)
    w[:, tile], b[tile] = 0.0, 0.0
    return {"no_norm_out": {k: v for k, v in net.items() if not k.startswith("norm_out")},
            "tanh_on_last_layer": {**net, f"w{n}": torch.eye(S, device=dev),
                                   f"b{n}": torch.zeros(S, device=dev)},
            "last_hidden_unit_tile_lost": {**net, f"w{n - 2}": w, f"b{n - 2}": b}}


def compare_neural(model, s0, Q, pvec, net) -> dict:
    """Phase 11: K11 against its plain version, and the cost bound against
    the plain version's output for a wrong net."""
    ref = neural_cost_rollout_plain(model, s0, Q, pvec, net)
    mutants = {name: neural_cost_rollout_plain(model, s0, Q, pvec, m)
               for name, m in net_mutants(net).items()}
    numbers = compare("k11_neural_cost_rollout", lambda: neural_cost_rollout(model, s0, Q, pvec, net),
                      lambda: neural_cost_rollout_plain(model, s0, Q, pvec, net), tol=NET_TOL,
                      extra=lambda _: {"mutant_max_rel_err": {
                          name: max_errors(m, ref)[1] for name, m in mutants.items()},
                          "smem_bytes": model.smem_bytes(model.net_args(net)[0], False)})
    for name, m in mutants.items():
        check(not torch.allclose(m, ref, **NET_TOL),
              f"K11: the cost bound does not reject a net with {name} {numbers}")
    return numbers


def k11_cases(model, s0, Q, pvec, net) -> dict:
    """Phase 11's further K11 numbers: the costs at each RAGGED_K and, at the
    full K, over seeded nets of WIDE_HIDDENS and NARROW_HIDDENS, each to
    NET_TOL; the time at SMALL_K + K_SCALING; the costs (to NET_TOL) and
    time at each of GROUP_WARPS warps a group; then the resources."""
    cases = {f"K{k}": (*first_k(k, s0, Q), net) for k in RAGGED_K}
    for hiddens in (WIDE_HIDDENS, NARROW_HIDDENS):
        seeded = wide_net(True, 1.0, s0.device, hiddens)
        cases["net_" + "-".join(map(str, mlp_dims(seeded)))] = (s0, Q, seeded)
    numbers = {}
    for case, (s, q, n) in cases.items():
        got, ref = (neural_cost_rollout(model, s, q, pvec, n),
                    neural_cost_rollout_plain(model, s, q, pvec, n))
        torch.cuda.synchronize()
        numbers[case] = errs = {**dict(zip(("max_abs_err", "max_rel_err"), max_errors(got, ref))),
                                "smem_bytes": model.smem_bytes(model.net_args(n)[0], False)}
        check(bool(torch.isfinite(got).all()) and got.shape == (s.shape[0],),
              f"K11 {case}: bad output {errs}")
        check(torch.allclose(got, ref, **NET_TOL), f"K11 {case}: kernel disagrees {errs}")
    args = model.net_args(net)[0]
    ref = neural_cost_rollout_plain(model, s0, Q, pvec, net)
    warps = {}
    for w in GROUP_WARPS:
        got = neural_cost_rollout_warps(model, s0, Q, pvec, net, w)
        torch.cuda.synchronize()
        smem, _, groups = kernels.neural_plan(model.plant, args, w)
        warps[str(w)] = errs = {
            "ms": cuda_ms(lambda: neural_cost_rollout_warps(model, s0, Q, pvec, net, w), 50),
            "max_abs_err": max_errors(got, ref)[0], "smem_bytes": smem, "groups_per_block": groups}
        check(torch.allclose(got, ref, **NET_TOL), f"K11 at {w} warps a group: disagrees {errs}")
    out = {"cases": numbers, "ms_at_warps": warps,
           "ms_at_k": ms_at_k(lambda k: neural_cost_rollout(model, *first_k(k, s0, Q), pvec, net),
                              SMALL_K + K_SCALING)}
    emit("k11_cases", out)
    # The tensor-core bound: the split products, and the scalar work (biases,
    # tanh, norms, the delta add, the stage cost) at the FP32 rate.
    _, group_warps, groups = kernels.neural_plan(model.plant, args)
    macs = sum(a * b for a, b in zip(mlp_dims(net), mlp_dims(net)[1:]))
    mma_resources("k11_resources", "neural_cost_rollout_kernel", args, "neural",
                  tc_bound_ms(mlp_forward_tiles(net), mlp_ops(net) - 2 * macs + STAGE_OPS),
                  extra={"group_warps": group_warps, "groups_per_block": groups,
                         "warps_per_sm": group_warps * groups
                         * kernels.net_blocks_per_sm("neural", args)})
    return out


def autograd_dq(model, s0, Q, pvec, net, defect=None) -> torch.Tensor:
    """dQ by torch.autograd through K11's plain arithmetic, with ``defect``
    in the backward only (the forward values stay K11's): ``tanh_prime``
    (the first layer's tanh passes its cotangent through), ``delta_identity``
    (x' = x + net drops the identity path), ``norm_in_scale`` (norm_in's
    cotangent is not divided by std)."""
    def step(x, u):
        a = torch.cat([x, u], dim=1)
        if "norm_in_mean" in net:
            shifted = a - net["norm_in_mean"]
            a = shifted / net["norm_in_std"]
            if defect == "norm_in_scale":
                a = shifted + (a - shifted).detach()
        n = mlp_layer_count(net)
        for i in range(n):
            z = a @ net[f"w{i}"] + net[f"b{i}"]
            a = z if i == n - 1 else torch.tanh(z)
            if defect == "tanh_prime" and i == 0:
                a = z + (a - z).detach()
        if "norm_out_mean" in net:
            a = a * net["norm_out_std"] + net["norm_out_mean"]
        if not model.predict_delta:
            return a
        return (x.detach() if defect == "delta_identity" else x) + a

    with torch.enable_grad():
        Qv = Q.clone().requires_grad_(True)
        (dq,) = torch.autograd.grad(plain_cost_loop(model, s0, Qv, pvec, step).sum(), Qv)
    return dq


def compare_neural_grad(model, s0, Q, pvec, net) -> dict:
    """Phase 12: K8 against its plain version on the same card tensors (also
    at ragged K and over a wide net), and the dQ bound against dQ with one
    defect in the MLP's backward."""
    check(not torch.backends.cuda.matmul.allow_tf32, "the plain version's products would be TF32")
    (cost, dQ), (ref_cost, ref_dQ) = (neural_grad_cost_rollout(model, s0, Q, pvec, net),
                                      neural_grad_cost_rollout_plain(model, s0, Q, pvec, net))
    torch.cuda.synchronize()
    cost_abs, cost_rel = max_errors(cost, ref_cost)
    dq_abs, _ = max_errors(dQ, ref_dQ)
    mutants = {d: autograd_dq(model, s0, Q, pvec, net, d)
               for d in ("tanh_prime", "delta_identity", "norm_in_scale")}
    numbers = {
        "cost_max_abs_err": cost_abs, "cost_max_rel_err": cost_rel,
        "dQ_max_abs_err": dq_abs, "dQ_max_abs": float(ref_dQ.abs().max()),
        "dQ_atol": DQ_ATOL_FRAC * float(ref_dQ.abs().max()), "dQ_rtol": DQ_RTOL,
        "autograd_dQ_max_abs_err": max_errors(autograd_dq(model, s0, Q, pvec, net), ref_dQ)[0],
        "mutant_max_abs_err": {name: max_errors(m, ref_dQ)[0] for name, m in mutants.items()},
        "smem_bytes": model.smem_bytes(model.net_args(net)[0], True),
        "max_abs_err": max(cost_abs, dq_abs),
        "finite": bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()),
        "ms": cuda_ms(lambda: neural_grad_cost_rollout(model, s0, Q, pvec, net), 20),
        "ms_at_k": ms_at_k(lambda k: neural_grad_cost_rollout(model, *first_k(k, s0, Q), pvec,
                                                                net)),
        "plain_ms": cuda_ms(lambda: neural_grad_cost_rollout_plain(model, s0, Q, pvec, net), 3),
        "cases": grad_cases("K8", neural_grad_cost_rollout, neural_grad_cost_rollout_plain, model,
                            s0, Q, pvec, net, wide_net(True, 1.0, s0.device)),
    }
    emit("k8_neural_grad_cost_rollout", numbers)
    check(numbers["finite"] and cost.shape == (K,) and dQ.shape == Q.shape, "K8: bad output")
    check(torch.allclose(cost, ref_cost, **NET_TOL), f"K8: cost disagrees with plain {numbers}")
    check(close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC), f"K8: dQ disagrees with plain {numbers}")
    for name, mutant in mutants.items():
        check(not close(mutant, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC),
              f"K8: the dQ bound does not reject a dQ with {name} dropped {numbers}")
    return numbers


def wide_net(norms: bool, scale: float, device, hiddens=WIDE_HIDDENS, seed=WIDE_SEED) -> dict:
    """A seeded MLP [S+U, *hiddens, S] (by default WIDE_HIDDENS, wider than
    the gradient kernels' register path): weights ``scale`` N(0, 1) /
    sqrt(fan-in), biases 0.1 N(0, 1), and (``norms``) norm layers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = [5, *hiddens, 4]
    net = {}
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        net[f"w{i}"] = scale * torch.randn(a, b, generator=gen, device=device) / a ** 0.5
        net[f"b{i}"] = 0.1 * torch.randn(b, generator=gen, device=device)
    if norms:
        net["norm_in_mean"] = 0.1 * torch.randn(5, generator=gen, device=device)
        net["norm_in_std"] = 0.5 + torch.rand(5, generator=gen, device=device)
        net["norm_out_mean"] = 0.01 * torch.randn(4, generator=gen, device=device)
        net["norm_out_std"] = 0.01 + 0.09 * torch.rand(4, generator=gen, device=device)
    return net


def grad_cases(label: str, kernel_fn, plain_fn, model, s0, Q, pvec, net, wide) -> dict:
    """Phases 12 and 19's further cases, each to NET_TOL on J and the dQ
    bound: ``net`` at each RAGGED_K, and ``wide`` at the full K."""
    cases = {f"K{k}": (s0[:k].contiguous(), Q[:k].contiguous(), net) for k in RAGGED_K}
    cases["wide_" + "-".join(map(str, mlp_dims(wide)))] = (s0, Q, wide)
    kernel = {"K8": "neural_grad", "K9": "residual_grad"}[label]
    numbers = {}
    for case, (s, q, n) in cases.items():
        (cost, dQ) = kernel_fn(model, s, q, pvec, n)
        ref_cost, ref_dQ = plain_fn(model, s, q, pvec, n)
        torch.cuda.synchronize()
        numbers[case] = got = {
            "cost_max_abs_err": max_errors(cost, ref_cost)[0],
            "dQ_max_abs_err": max_errors(dQ, ref_dQ)[0], "dQ_max_abs": float(ref_dQ.abs().max()),
            "smem_bytes": kernels.net_smem_bytes(model.plant, model.net_args(n)[0], kernel)}
        check(bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all())
              and dQ.shape == q.shape, f"{label} {case}: bad output {got}")
        check(torch.allclose(cost, ref_cost, **NET_TOL), f"{label} {case}: cost disagrees {got}")
        check(close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC), f"{label} {case}: dQ disagrees {got}")
    return numbers


def ms_at_k(run, ks=K_SCALING) -> dict:
    """``run(k)``'s time at each of ``ks``: where a kernel's time stays
    flat while its blocks still fit on the SMs at once, each warp's own
    latency, not the card's throughput, sets it."""
    return {str(k): cuda_ms(lambda: run(k), 20) for k in ks}


def first_k(k: int, *tensors) -> tuple:
    return tuple(t[:k].contiguous() for t in tensors)


def entry_pattern(kernel: str, instance: str = "") -> str:
    """A regex of the mangled entry function of the template ``kernel``,
    its template arguments matching ``instance`` (K13's G = 3: ``Li3E``)."""
    return rf"\d+{kernel}I\w*{instance}"


def ptxas_resources(kernel: str, instance: str = "") -> dict:
    """Registers, spill bytes and static shared memory that ptxas reported
    (phase 1's build log) for the entry function of ``kernel``."""
    entry, found = None, {}
    for line in kernels.build.log.splitlines():
        named = re.search(r"entry function '(\w+)'", line)
        if named:
            entry = named.group(1)
        elif entry and re.search(entry_pattern(kernel, instance), entry):
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spills:
                found["spill_stores"], found["spill_loads"] = int(spills[1]), int(spills[2])
            used = re.search(r"Used (\d+) registers", line)
            if used:
                smem = re.search(r"(\d+) bytes smem", line)
                found["registers"] = int(used[1])
                found["static_smem_bytes"] = int(smem[1]) if smem else 0
    return found


def sass_hmma_counts():
    """HMMA instructions in each entry function's SASS (``cuobjdump -sass``
    of the built library), by mangled name; None without cuobjdump."""
    sass = sass_text()
    if sass is None:
        return None
    counts, fn = {}, None
    for line in sass.splitlines():
        named = re.search(r"Function : (\S+)", line)
        if named:
            fn = named.group(1)
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


def sass_text(library=None) -> str | None:
    """``cuobjdump -sass`` of the built library (or ``library``); None
    without cuobjdump."""
    tool = shutil.which("cuobjdump") or str(Path(kernels._nvcc()).parent / "cuobjdump")
    if not Path(tool).is_file():
        return None
    return _cuobjdump_sass(tool, str(library or kernels.library_path()))


@functools.lru_cache(maxsize=None)
def _cuobjdump_sass(tool: str, library: str) -> str:
    """One disassembly of a library a run (~15 s for the whole library on
    the card's host; the library is built once, before any phase reads it)."""
    return subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True).stdout


def sass_loops(kernel: str, instance: str = "", library=None):
    """The loops of ``kernel``'s entry function in its SASS: for each
    backward branch, its body's first and last address, its instructions
    and the MUFU (special-function unit) instructions in it by kind; also
    the function's instruction count.  None without cuobjdump."""
    sass = sass_text(library)
    if sass is None:
        return None
    found, fn = {}, None
    for line in sass.splitlines():
        named = re.search(r"Function : (\S+)", line)
        if named:
            fn = named.group(1)
            if re.search(entry_pattern(kernel, instance), fn):
                found[fn] = []
            else:
                fn = None
        elif fn:
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", line)
            if ins:
                found[fn].append((int(ins[1], 16), ins[2]))
    out = {}
    for fn, code in found.items():
        loops = []
        for addr, text in code:
            target = re.search(r"\bBRA\b.*\b(0x[0-9a-f]+)$", text)
            if target and int(target[1], 16) < addr:
                body = [t for a, t in code if int(target[1], 16) <= a <= addr]
                mufu = {}
                for t in body:
                    op = re.search(r"MUFU\.(\w+)", t)
                    if op:
                        mufu[op[1]] = mufu.get(op[1], 0) + 1
                loops.append({"first": hex(int(target[1], 16)), "last": hex(addr),
                              "instructions": len(body), "mufu": mufu,
                              "calls": sum("CALL" in t for t in body)})
        out[fn] = {"instructions": len(code), "loops": loops}
    return out


def mma_resources(label: str, kernel: str, args, occupancy: str, tc_ms: float,
                  instance: str = "", extra=None) -> dict:
    """A tensor-core network kernel's resources for the net of ``args``:
    ptxas' registers and spills, the shared memory and blocks per SM of
    ``occupancy`` (kernels.net_smem_bytes' and net_blocks_per_sm's name),
    the HMMA instructions in its SASS (which must be there), its
    tensor-core bound ``tc_ms``, and ``extra``."""
    hmma = sass_hmma_counts()
    numbers = {**ptxas_resources(kernel, instance),
               "smem_bytes": kernels.net_smem_bytes("cartpole", args, occupancy),
               "blocks_per_sm": kernels.net_blocks_per_sm(occupancy, args),
               "hmma": "not measured" if hmma is None else sum(
                   n for fn, n in hmma.items() if re.search(entry_pattern(kernel, instance), fn)),
               "tc_bound_ms": tc_ms, **(extra or {})}
    emit(label, numbers)
    check(hmma is None or numbers["hmma"] > 0, f"{label}: no HMMA in the kernel's SASS {numbers}")
    return numbers


def recurrent_mutants(net, hidden, kind: str) -> dict:
    """(net, hidden) of a wrong K13: the rollouts started from a zero hidden
    in place of the live one; each cell's first two gates swapped (the
    GRU's r and z, the LSTM's i and f, which puts the forget gate on the
    candidate and the input gate on the old c); and the last cell's second
    gate's input bias dropped (the GRU's z, the subtlest dropped bias over
    the committed GRU; the LSTM's forget gate, the only nonzero bias of a
    seeded LSTM)."""
    def swap(t, hd):
        return torch.cat([t[..., hd:2 * hd], t[..., :hd], t[..., 2 * hd:]], dim=-1)

    swapped = {k: {name: swap(t, v["wh"].shape[0]) for name, t in v.items()}
               if k.startswith("cell") else v for k, v in net.items()}
    last = f"cell{len(rnn_cells(net)) - 1}"
    bi, hd = net[last]["bi"], net[last]["wh"].shape[0]
    no_bias = {**net, last: {**net[last], "bi": torch.cat([bi[:hd], torch.zeros_like(bi[hd:2 * hd]),
                                                           bi[2 * hd:]])}}
    gate = "z" if kind == "gru" else "f"
    return {"zero_hidden": (net, tuple(torch.zeros_like(h) for h in hidden)),
            ("r_z_swapped" if kind == "gru" else "i_f_swapped"): (swapped, hidden),
            f"{last}_{gate}_input_bias_dropped": (no_bias, hidden)}


def recurrent_cases(model, s0, Q, pvec, net, hidden) -> dict:
    """K13 against its plain version at each RAGGED_K, to RNN_TOL."""
    cases = {}
    for k in RAGGED_K:
        s, q = first_k(k, s0, Q)
        got = recurrent_cost_rollout(model, s, q, pvec, net, hidden)
        ref = recurrent_cost_rollout_plain(model, s, q, pvec, net, hidden)
        torch.cuda.synchronize()
        cases[f"K{k}"] = errs = dict(zip(("max_abs_err", "max_rel_err"), max_errors(got, ref)))
        check(bool(torch.isfinite(got).all()) and got.shape == (k,), f"K13 K{k}: bad output {errs}")
        check(torch.allclose(got, ref, **RNN_TOL), f"K13 K{k}: kernel disagrees with plain {errs}")
    return cases


def recurrent_operands(spec: str, gen, device) -> tuple:
    """``(model, pvec, net, hidden)`` of the recurrent net of ``spec`` on the
    card, from the hidden that ten of the predictor's own updates reach."""
    ctrl = make_controller("cuda", spec=spec)
    pred = ctrl.optimizer.predictor.predictor
    for _ in range(10):
        pred.update(0.05 * torch.randn(1, 4, generator=gen, device=device),
                    torch.clamp(0.3 * torch.randn(1, 1, 1, generator=gen, device=device), -1, 1))
    model, pack = neural.net_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    return (model, pack(params, torch.tensor([0.1], device=device)), params["dyn"]["net"],
            params["dyn"]["hidden"])


def compare_recurrent(label: str, spec: str, s0, Q, gen) -> tuple:
    """Phase 13: K13 against its plain version for the net of ``spec``, from
    the hidden that ten of the predictor's own updates reach, also at
    ragged K, and the cost bound against the plain version's output for a
    wrong net or hidden; then its time at K_SCALING and its resources."""
    model, pvec, net, hidden = recurrent_operands(spec, gen, s0.device)
    ref = recurrent_cost_rollout_plain(model, s0, Q, pvec, net, hidden)
    mutants = {name: recurrent_cost_rollout_plain(model, s0, Q, pvec, n, h)
               for name, (n, h) in recurrent_mutants(net, hidden, model.kind).items()}
    numbers = compare(label, lambda: recurrent_cost_rollout(model, s0, Q, pvec, net, hidden),
                      lambda: recurrent_cost_rollout_plain(model, s0, Q, pvec, net, hidden),
                      tol=RNN_TOL,
                      extra=lambda _: {"mutant_max_rel_err": {
                          name: max_errors(m, ref)[1] for name, m in mutants.items()},
                          "cases": recurrent_cases(model, s0, Q, pvec, net, hidden),
                          "ms_at_k": ms_at_k(lambda k: recurrent_cost_rollout(
                              model, *first_k(k, s0, Q), pvec, net, hidden),
                              SMALL_K + K_SCALING)})
    for name, m in mutants.items():
        check(not torch.allclose(m, ref, **RNN_TOL),
              f"K13: the cost bound does not reject a rollout with {name} {numbers}")
    numbers.update(bound(K * H * (rnn_ops(net, model.kind) + STAGE_OPS),
                         nbytes(s0, Q, pvec, *leaves(net), *hidden) + 4 * K))
    emit(f"{label}_bound", {k: numbers[k] for k in ("bound_ms", "bound_by")})
    # The tensor-core bound: the split products, and the scalar work (gates,
    # head bias, delta, stage cost) at the FP32 rate.
    scalar = rnn_ops(net, model.kind) - 2 * rnn_macs(net, model.kind) + STAGE_OPS
    mma_resources(f"{label}_resources", "recurrent_cost_rollout_kernel",
                  model.net_args(net, hidden)[0], "recurrent",
                  tc_bound_ms(rnn_mma_tiles(net, model.kind), scalar),
                  instance="Li3E" if model.kind == "gru" else "Li4E")
    return numbers


def gru_hidden_vs_replay(ctrl: MPCController, trace: list) -> None:
    """Phase 16: the hidden the card carried over the loop against a CPU
    replay: a zero hidden advanced with the plain gru_apply over the
    recorded states and applied controls."""
    pred = ctrl.optimizer.predictor.predictor
    net = to_cpu(pred.net_params)
    hidden = gru_init_state(pred.arch["hiddens"], 1)
    for s, u in trace:
        _, hidden = gru_apply(net, torch.tensor(np.concatenate([s, u]))[None], hidden)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(pred.hidden, hidden))
    numbers = {"ticks": len(trace), "hidden_max_abs_err": err,
               "hidden_max_abs": max(float(h.abs().max()) for h in hidden)}
    emit("gru_hidden_vs_cpu_replay", numbers)
    check(err <= HIDDEN_ATOL, f"the GRU hidden on the card differs from the CPU replay {numbers}")


# ---- the adaptive-MPC and sparse-GP phases --------------------------------------
def residual_controller(optimizer: str, config: dict, spec: str = RES_SPEC) -> MPCController:
    """A controller over "ODE+res" (or ``spec``, its fast form) on the card
    with a nonzero residual made as bench_scale.py:218-222 makes it: each
    weight 0.02 times a normal draw (from a seeded torch.Generator), the
    zero biases kept."""
    ctrl = make_controller("cuda", optimizer, config, spec=spec)
    seed_residual(ctrl.optimizer.predictor.predictor)
    return ctrl


def seed_residual(pred) -> None:
    """Install residual_controller's nonzero residual in ``pred``."""
    gen = torch.Generator(device=pred.device).manual_seed(11)
    pred.set_residual({k: 0.02 * torch.randn(v.shape, generator=gen, device=pred.device)
                       if k.startswith("w") else v for k, v in pred._res.items()})


def residual_mutants(model, s0, Q, pvec, net) -> dict:
    """Costs of a wrong K12, by the plain arithmetic: the residual dropped
    (K1's rollout of the base alone), and the residual added to x in place
    of the base's step."""
    return {"residual_dropped": cost_rollout_plain(model, s0, Q, pvec),
            "residual_on_x": plain_cost_loop(model, s0, Q, pvec,
                                             lambda x, u: x + mlp_step(net, x, u, False))}


def compare_residual(model, s0, Q, pvec, net) -> dict:
    """Phase 18: K12 against its plain version, and the cost bound against
    the plain arithmetic of a wrong step."""
    ref = residual_cost_rollout_plain(model, s0, Q, pvec, net)
    mutants = residual_mutants(model, s0, Q, pvec, net)
    numbers = compare("k12_residual_cost_rollout",
                      lambda: residual_cost_rollout(model, s0, Q, pvec, net),
                      lambda: residual_cost_rollout_plain(model, s0, Q, pvec, net), tol=NET_TOL,
                      extra=lambda _: {"mutant_max_rel_err": {
                          name: max_errors(m, ref)[1] for name, m in mutants.items()},
                          "smem_bytes": kernels.net_smem_bytes(model.plant,
                                                               model.net_args(net)[0],
                                                               "residual")})
    for name, m in mutants.items():
        check(not torch.allclose(m, ref, **NET_TOL),
              f"K12: the cost bound does not reject a rollout with {name} {numbers}")
    return numbers


def k12_cases(model, s0, Q, pvec, net) -> dict:
    """Phase 18's further K12 numbers: the costs at each RAGGED_K and over a
    seeded residual net of WIDE_HIDDENS, each to NET_TOL, and over the wide
    net the bound's distance to the plain arithmetic with the last hidden
    layer's last unit tile lost (the wide net's 4+4+1 tile split sends that
    tile through the one-tile tail, which the 32-wide net never takes); the
    time at SMALL_K + K_SCALING; then the resources."""
    wide = wide_net(False, RES_WIDE_SCALE, s0.device)
    wide_name = "wide_" + "-".join(map(str, mlp_dims(wide)))
    cases = {f"K{k}": (*first_k(k, s0, Q), net) for k in RAGGED_K}
    cases[wide_name] = (s0, Q, wide)
    numbers = {}
    for case, (s, q, n) in cases.items():
        got, ref = (residual_cost_rollout(model, s, q, pvec, n),
                    residual_cost_rollout_plain(model, s, q, pvec, n))
        torch.cuda.synchronize()
        numbers[case] = errs = {
            **dict(zip(("max_abs_err", "max_rel_err"), max_errors(got, ref))),
            "smem_bytes": kernels.residual_plan(model.plant, model.net_args(n)[0])[0]}
        check(bool(torch.isfinite(got).all()) and got.shape == (s.shape[0],),
              f"K12 {case}: bad output {errs}")
        check(torch.allclose(got, ref, **NET_TOL), f"K12 {case}: kernel disagrees {errs}")
    ref = residual_cost_rollout_plain(model, s0, Q, pvec, wide)
    lost = residual_cost_rollout_plain(model, s0, Q, pvec,
                                       net_mutants(wide)["last_hidden_unit_tile_lost"])
    numbers[wide_name]["unit_tile_lost"] = mutant = {
        "max_rel_err": max_errors(lost, ref)[1],
        "err_over_net_tol": float(((lost - ref).abs()
                                   / (NET_TOL["atol"] + NET_TOL["rtol"] * ref.abs())).max())}
    check(not torch.allclose(lost, ref, **NET_TOL),
          f"K12: the cost bound does not reject the wide net with its last unit tile lost {mutant}")
    out = {"cases": numbers,
           "ms_at_k": ms_at_k(lambda k: residual_cost_rollout(model, *first_k(k, s0, Q), pvec, net),
                              SMALL_K + K_SCALING)}
    emit("k12_cases", out)
    # The tensor-core bound: the split products, and the scalar work (the
    # rk4 step, biases, tanh, the stage cost) at the FP32 rate.
    args = model.net_args(net)[0]
    _, groups = kernels.residual_plan(model.plant, args)
    macs = sum(a * b for a, b in zip(mlp_dims(net), mlp_dims(net)[1:]))
    mma_resources("k12_resources", "residual_cost_rollout_kernel", args, "residual",
                  tc_bound_ms(mlp_forward_tiles(net),
                              RK4_STEP_OPS + mlp_ops(net) - 2 * macs + STAGE_OPS),
                  extra={"group_warps": 2, "groups_per_block": groups,
                         "warps_per_sm": 2 * groups * kernels.net_blocks_per_sm("residual", args)})
    return out


def residual_autograd_dq(model, s0, Q, pvec, net, drop_mlp_vjp: bool = False) -> torch.Tensor:
    """dQ by torch.autograd through K12's plain arithmetic; ``drop_mlp_vjp``
    detaches the residual MLP's input, so its VJP drops out of the adjoint
    while the forward values stay K12's."""
    step = residual_step_fn(model, pvec, net)
    base = residual_step_fn(model, pvec, {k: torch.zeros_like(v) for k, v in net.items()})

    def wrong(x, u):
        return base(x, u) + mlp_step(net, x.detach(), u.detach(), False)

    with torch.enable_grad():
        Qv = Q.clone().requires_grad_(True)
        (dq,) = torch.autograd.grad(
            plain_cost_loop(model, s0, Qv, pvec, wrong if drop_mlp_vjp else step).sum(), Qv)
    return dq


def compare_residual_grad(model, s0, Q, pvec, net) -> dict:
    """Phase 19: K9 against its plain version on the same card tensors (also
    at ragged K and over a wide residual net), and the dQ bound (K7's)
    against dQ with the MLP's VJP dropped."""
    check(not torch.backends.cuda.matmul.allow_tf32, "the plain version's products would be TF32")
    (cost, dQ), (ref_cost, ref_dQ) = (residual_grad_cost_rollout(model, s0, Q, pvec, net),
                                      residual_grad_cost_rollout_plain(model, s0, Q, pvec, net))
    torch.cuda.synchronize()
    cost_abs, cost_rel = max_errors(cost, ref_cost)
    dq_abs, _ = max_errors(dQ, ref_dQ)
    mutant = residual_autograd_dq(model, s0, Q, pvec, net, drop_mlp_vjp=True)
    numbers = {
        "cost_max_abs_err": cost_abs, "cost_max_rel_err": cost_rel,
        "dQ_max_abs_err": dq_abs, "dQ_max_abs": float(ref_dQ.abs().max()),
        "dQ_atol": DQ_ATOL_FRAC * float(ref_dQ.abs().max()), "dQ_rtol": DQ_RTOL,
        "autograd_dQ_max_abs_err": max_errors(residual_autograd_dq(model, s0, Q, pvec, net),
                                              ref_dQ)[0],
        "mutant_max_abs_err": {"mlp_vjp_dropped": max_errors(mutant, ref_dQ)[0]},
        "smem_bytes": kernels.net_smem_bytes(model.plant, model.net_args(net)[0],
                                             "residual_grad"),
        "max_abs_err": max(cost_abs, dq_abs),
        "finite": bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()),
        "ms": cuda_ms(lambda: residual_grad_cost_rollout(model, s0, Q, pvec, net), 20),
        "ms_at_k": ms_at_k(lambda k: residual_grad_cost_rollout(model, *first_k(k, s0, Q), pvec,
                                                                  net)),
        "plain_ms": cuda_ms(lambda: residual_grad_cost_rollout_plain(model, s0, Q, pvec, net), 3),
        "cases": grad_cases("K9", residual_grad_cost_rollout, residual_grad_cost_rollout_plain,
                            model, s0, Q, pvec, net, wide_net(False, 0.02, s0.device)),
    }
    emit("k9_residual_grad_cost_rollout", numbers)
    check(numbers["finite"] and cost.shape == (K,) and dQ.shape == Q.shape, "K9: bad output")
    check(torch.allclose(cost, ref_cost, **NET_TOL), f"K9: cost disagrees with plain {numbers}")
    check(close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC), f"K9: dQ disagrees with plain {numbers}")
    check(not close(mutant, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC),
          f"K9: the dQ bound does not reject a dQ with the MLP's VJP dropped {numbers}")
    return numbers


def gp_ops(ops) -> int:
    """FP32 operations of one GP step (gp_core.cuh gp_step): the input's
    affine transform and squared norm (4 per input), per inducing point the
    dot product (2 per input), d2, the clip, the exponent and its scale (7)
    and the S multiply-adds, then the output's scale, shift and add (3 per
    state)."""
    M, D = ops["Zs"].shape
    S = ops["out_std"].numel()
    return 4 * D + M * (2 * D + 7 + 2 * S) + 3 * S


def gp_vjp_ops(ops) -> int:
    """The transposed GP step beyond its forward (k_m taken as known), in
    its factored form: the scaled cotangent (S); per inducing point kbar (2
    per state), the clip's derivative and d2bar (4), sum_m d2bar_m (1) and
    sum_m d2bar_m Zs_m (2 per input); then anbar = 2 an sum_m d2bar_m -
    2 sum_m d2bar_m Zs_m (2 per input), abar and the state's identity path
    (D + S).  The kernel (gp_core.cuh gp_step_vjp) spends 4 per input and
    inducing point on anbar; the bound counts what the function needs."""
    M, D = ops["Zs"].shape
    S = ops["out_std"].numel()
    return S + M * (2 * S + 5 + 2 * D) + 2 * D + D + S


def well_conditioned_gp(gp_params: dict) -> dict:
    """A GP of the same widths whose mean does not cancel in float32: the
    inducing points, lengthscales, variance and normalization of
    ``gp_params``, with the posterior weights alpha drawn N(0, 1) from a
    generator seeded WELL_GP_SEED."""
    alpha = gp_params["alpha"]
    gen = torch.Generator(device=alpha.device).manual_seed(WELL_GP_SEED)
    return {**gp_params, "alpha": torch.randn(alpha.shape, generator=gen, device=alpha.device)}


def lane_points_dropped(ops) -> dict:
    """The GP operands without the inducing points m = 3 mod 4: those that
    one lane of four owns in K14's and K10's lane split."""
    keep = torch.arange(ops["Zs"].shape[0], device=ops["Zs"].device) % 4 != 3
    return {**ops, "Zs": ops["Zs"][keep].contiguous(), "zn2": ops["zn2"][keep].contiguous(),
            "alphaT": ops["alphaT"][:, keep].contiguous()}


def compare_gp(model, s0, Q, pvec, ops) -> dict:
    """Phase 20: K14 against its plain version over the well-conditioned
    GP's operands ``ops``, and the cost bound (K11's) against the plain
    version's output with out_std or zn2 dropped, and with one lane's
    points dropped (``lane_points_dropped``)."""
    ref = gp_cost_rollout_plain(model, s0, Q, pvec, ops)
    mutants = {name: gp_cost_rollout_plain(model, s0, Q, pvec, m) for name, m in (
        ("no_out_std", {**ops, "out_std": torch.ones_like(ops["out_std"])}),
        ("no_zn2", {**ops, "zn2": torch.zeros_like(ops["zn2"])}),
        ("lane_points_dropped", lane_points_dropped(ops)))}
    numbers = compare("k14_gp_cost_rollout", lambda: gp_cost_rollout(model, s0, Q, pvec, ops),
                      lambda: gp_cost_rollout_plain(model, s0, Q, pvec, ops), tol=NET_TOL,
                      extra=lambda _: {"mutant_max_rel_err": {
                          name: max_errors(m, ref)[1] for name, m in mutants.items()},
                          "smem_bytes": int(kernels.load().ctt_gp_smem_bytes(
                              4, 1, ops["Zs"].shape[0]))})
    for name, m in mutants.items():
        check(not torch.allclose(m, ref, **NET_TOL),
              f"K14: the cost bound does not reject a GP with {name} {numbers}")
    return numbers


def k14_cases(model, s0, Q, pvec, wops, gops, gp_params) -> dict:
    """Phase 20's further K14 numbers, each case's cost to NET_TOL against
    the plain version over the well-conditioned GP ``wops``: at each
    RAGGED_K, at each of GP_COST_LANES lanes a rollout (each timed), and
    over a well-conditioned GP of the first GP_FEW_POINTS inducing points of
    ``gp_params`` at each of them; the share of K14's costs equal to K10's
    J at each lane count the two take, over ``wops`` and over the committed
    GP ``gops`` (they take the same stage cost and GP step, so it must be
    1.0); the time at SMALL_K + K_SCALING; and the resources (ptxas'
    registers, spills and static shared memory, the dynamic shared memory,
    blocks and warps an SM, lanes a rollout)."""
    few = flatten_gp_weights(well_conditioned_gp(
        {**gp_params, "Z": gp_params["Z"][:GP_FEW_POINTS],
         "alpha": gp_params["alpha"][:GP_FEW_POINTS]}))
    cases = {f"K{k}": (*first_k(k, s0, Q), wops, 0) for k in RAGGED_K}
    for lanes in GP_COST_LANES:
        cases[f"L{lanes}"] = (s0, Q, wops, lanes)
        cases[f"M{GP_FEW_POINTS}_L{lanes}"] = (s0, Q, few, lanes)
    numbers = {}
    for case, (s, q, ops, lanes) in cases.items():
        got, ref = (gp_cost_rollout_lanes(model, s, q, pvec, ops, lanes),
                    gp_cost_rollout_plain(model, s, q, pvec, ops))
        torch.cuda.synchronize()
        numbers[case] = errs = dict(zip(("max_abs_err", "max_rel_err"), max_errors(got, ref)))
        if case.startswith("L"):
            errs["ms"] = cuda_ms(lambda: gp_cost_rollout_lanes(model, s, q, pvec, ops, lanes), 20)
        check(bool(torch.isfinite(got).all()) and got.shape == (s.shape[0],),
              f"K14 {case}: bad output {errs}")
        check(torch.allclose(got, ref, **NET_TOL), f"K14 {case}: cost disagrees {errs}")
    equal = {f"{name}_L{lanes}": float((gp_cost_rollout_lanes(model, s0, Q, pvec, ops, lanes)
                                        == gp_grad_cost_rollout_lanes(model, s0, Q, pvec, ops,
                                                                      lanes)[0]).double().mean())
             for name, ops in (("well_conditioned", wops), ("committed", gops))
             for lanes in sorted(set(GP_COST_LANES) & set(GP_LANES))}
    numbers = {"cases": numbers, "k10_equal_share": equal, "ms_at_k": ms_at_k(
        lambda k: gp_cost_rollout(model, *first_k(k, s0, Q), pvec, wops), SMALL_K + K_SCALING)}
    emit("k14_cases", numbers)
    check(all(share == 1.0 for share in equal.values()),
          f"K14's costs differ from K10's J at the same lanes {equal}")
    M = wops["Zs"].shape[0]
    lanes, threads, blocks = kernels.gp_layout(M, grad=False)
    numbers["resources"] = {**ptxas_resources("gp_cost_rollout_kernel", f"Li{lanes}E"),
                            "smem_bytes": int(kernels.load().ctt_gp_smem_bytes(4, 1, M)),
                            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
                            "lanes": lanes}
    emit("k14_resources", numbers["resources"])
    return numbers


def gp_autograd_dq(model, s0, Q, pvec, ops, drop_2an: bool = False) -> torch.Tensor:
    """dQ by torch.autograd through K14's plain arithmetic; ``drop_2an``
    detaches the input in |an|^2, which drops the 2·an term of d2's
    gradient while the forward values stay K14's."""
    def step(x, u):
        an = (torch.cat([x, u], dim=1) - ops["in_mean"]) * ops["inv_in"]
        sq = an.detach() if drop_2an else an
        d2 = torch.sum(sq * sq, dim=1, keepdim=True) - 2.0 * (an @ ops["Zs"].T) + ops["zn2"]
        k = ops["var"] * torch.exp(-0.5 * torch.maximum(d2, torch.zeros_like(d2)))
        return x + ((k @ ops["alphaT"].T) * ops["out_std"] + ops["out_mean"])

    with torch.enable_grad():
        Qv = Q.clone().requires_grad_(True)
        (dq,) = torch.autograd.grad(plain_cost_loop(model, s0, Qv, pvec, step).sum(), Qv)
    return dq


def k10_cases(model, s0, Q, pvec, wops, gp_params) -> dict:
    """Phase 21's further K10 numbers, each case's J to KERNEL_TOL and dQ to
    DQ_RTOL plus DQ_ATOL_FRAC of max|dQ| against the plain version: over
    the well-conditioned GP ``wops`` at each RAGGED_K and at each of
    GP_LANES lanes a rollout (each timed), and over a well-conditioned GP
    of the first GP_FEW_POINTS inducing points of ``gp_params``; then the
    time at SMALL_K + K_SCALING and the resources (ptxas' registers,
    spills and static shared memory, the dynamic shared memory, blocks and
    warps an SM, lanes a rollout)."""
    few = flatten_gp_weights(well_conditioned_gp(
        {**gp_params, "Z": gp_params["Z"][:GP_FEW_POINTS],
         "alpha": gp_params["alpha"][:GP_FEW_POINTS]}))
    cases = {f"K{k}": (*first_k(k, s0, Q), wops, 0) for k in RAGGED_K}
    cases[f"M{GP_FEW_POINTS}"] = (s0, Q, few, 0)
    cases.update({f"L{lanes}": (s0, Q, wops, lanes) for lanes in GP_LANES})
    numbers = {}
    for case, (s, q, ops, lanes) in cases.items():
        (cost, dQ), (ref_cost, ref_dQ) = (gp_grad_cost_rollout_lanes(model, s, q, pvec, ops, lanes),
                                          gp_grad_cost_rollout_plain(model, s, q, pvec, ops))
        torch.cuda.synchronize()
        numbers[case] = got = {"cost_max_abs_err": max_errors(cost, ref_cost)[0],
                               "dQ_max_abs_err": max_errors(dQ, ref_dQ)[0],
                               "dQ_max_abs": float(ref_dQ.abs().max())}
        if lanes:
            got["ms"] = cuda_ms(lambda: gp_grad_cost_rollout_lanes(model, s, q, pvec, ops, lanes),
                                20)
        check(bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()) and dQ.shape == q.shape,
              f"K10 {case}: bad output {got}")
        check(torch.allclose(cost, ref_cost, **KERNEL_TOL), f"K10 {case}: cost disagrees {got}")
        check(close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC), f"K10 {case}: dQ disagrees {got}")
    numbers = {"cases": numbers, "ms_at_k": ms_at_k(
        lambda k: gp_grad_cost_rollout(model, *first_k(k, s0, Q), pvec, wops), SMALL_K + K_SCALING)}
    emit("k10_cases", numbers)
    M = wops["Zs"].shape[0]
    lanes, threads, blocks = kernels.gp_layout(M)
    numbers["resources"] = {**ptxas_resources("gp_grad_cost_rollout_kernel", f"Li{lanes}E"),
                            "smem_bytes": int(kernels.load().ctt_gp_smem_bytes(4, 1, M)),
                            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
                            "lanes": lanes}
    emit("k10_resources", numbers["resources"])
    return numbers


def gp_vs_float64(model, s0, Q, Qg, pvec, ops) -> None:
    """Phases 20-21 over the committed GP's operands ``ops``: K14's cost
    (at ``Q``) and K10's cost and dQ (at ``Qg``), each no further from the
    float64 plain version than GP_F64_FACTOR times the float32 plain
    version's distance from it, plus 1e-6 of its largest entry."""
    ops64 = {k: v.double() for k, v in ops.items()}
    s64, pvec64 = s0.double(), pvec.double()
    outs = {"k14_cost": (gp_cost_rollout(model, s0, Q, pvec, ops),
                         gp_cost_rollout_plain(model, s0, Q, pvec, ops),
                         gp_cost_rollout_plain(model, s64, Q.double(), pvec64, ops64))}
    for name, triple in zip(("k10_cost", "k10_dQ"), zip(
            gp_grad_cost_rollout(model, s0, Qg, pvec, ops),
            gp_grad_cost_rollout_plain(model, s0, Qg, pvec, ops),
            gp_grad_cost_rollout_plain(model, s64, Qg.double(), pvec64, ops64))):
        outs[name] = triple
    numbers = {}
    for name, (got, plain, ref64) in outs.items():
        p_err = float((plain.double() - ref64).abs().max())
        numbers[name] = {"f64_max_abs_err": float((got.double() - ref64).abs().max()),
                         "plain_f64_max_abs_err": p_err, "max_abs": float(ref64.abs().max()),
                         "bound": GP_F64_FACTOR * p_err + 1e-6 * float(ref64.abs().max())}
    emit("gp_committed_vs_float64", numbers)
    for name, n in numbers.items():
        check(n["f64_max_abs_err"] <= n["bound"],
              f"{name}: further from float64 than the plain version allows {numbers}")


def adaptive_mppi() -> tuple:
    """Phase 22: MPPI over "ODE+res" on the mismatched plant, the residual
    fitted on the card and installed every FIT_EVERY ticks."""
    ctrl = make_controller("cuda", "mppi", RES_MPPI_CONFIG, spec=RES_SPEC)
    check(residual.can_use_cost(ctrl.optimizer) and not ctrl.optimizer._uses_semi_fused(),
          "the adaptive controller did not take K12")
    sysid, fits, fit_ms = OnlineSysId(ctrl, **SYSID), [], []

    def on_tick(t, s, u, s_next):
        sysid.observe(s, u, s_next)
        if (t + 1) % FIT_EVERY == 0:
            t0 = time.perf_counter()
            fits.append(sysid.fit_and_apply(steps=FIT_STEPS))
            torch.cuda.synchronize()
            fit_ms.append((time.perf_counter() - t0) * 1e3)

    counts = counted_loop("slice_adaptive_mppi_residual", ctrl, ADAPT_TICKS,
                          {"residual_cost_rollout": ADAPT_TICKS}, env_params=TRUE_PARAMS,
                          on_tick=on_tick)
    pred = ctrl.optimizer.predictor.predictor
    live = ctrl._assemble_params()["dyn"]["res"]
    base, adapted = sysid.one_step_mse(use_residual=False), sysid.one_step_mse(use_residual=True)
    numbers = {"installs": sum(int(f["fitted"]) for f in fits), "fit_steps": FIT_STEPS,
               "fit_ms": fit_ms, "loss_before_after": [[f.get("loss_before"), f.get("loss_after")]
                                                      for f in fits],
               "one_step_mse_base": base, "one_step_mse_adapted": adapted,
               "adapted_over_base": adapted / base}
    emit("adaptive_sysid", numbers)
    check(numbers["installs"] == ADAPT_TICKS // FIT_EVERY, f"a sysid fit was refused {numbers}")
    check(all(live[k] is v for k, v in pred._res.items()),
          "the last install did not reach the controller's params")
    check(adapted < 0.5 * base, f"the adapted model is not twice as good as the base {numbers}")
    return ctrl, counts


def gp_mppi_with_refit(runs: dict) -> MPCController:
    """Phase 24: MPPI over the GP, a re-fit on the loop's transitions and
    fresh random ones swapped in with nothing rebuilt, then a new episode
    from the same start.  No pole check: at this configuration MPPI over
    the committed GP loses the pole within ~40 ticks from every start
    tried, and so does the JAX package's (PERF.md; ``--starts`` and
    ``tests/test_torch_gp.py --starts`` repeat the sweep)."""
    ctrl = make_controller("cuda", "mppi", RES_MPPI_CONFIG, spec=GP_SPEC)
    check(gp.can_use_cost(ctrl.optimizer) and not ctrl.optimizer._uses_semi_fused(),
          "the GP controller did not take K14")
    builds, epoch = kernels.build.count, ctrl.optimizer._build_epoch
    seen = []
    runs["mppi_gp"] = counted_loop("slice_mppi_gp", ctrl, GP_TICKS, {"gp_cost_rollout": GP_TICKS},
                                   pole_check=False,
                                   on_tick=lambda t, s, u, s_next: seen.append((s, u, s_next)))
    lx, lu, lxn = (np.stack(v).astype(np.float32) for v in zip(*seen))
    x, u, xn = collect_transitions(CartpoleEnv(batch_size=REFIT_ENVS, dt=DT, seed=1), REFIT_STEPS,
                                   seed=1)
    t0 = time.perf_counter()
    params, mse = fit_gp_dynamics(np.concatenate([lx, x]), np.concatenate([lu, u]),
                                  np.concatenate([lxn, xn]), num_inducing=128, seed=0)
    fit_s = time.perf_counter() - t0
    pred = ctrl.optimizer.predictor.predictor
    old = pred.gp_params
    pred.gp_params = place(params, pred.device)
    check(ctrl._assemble_params()["dyn"]["gp"]["alpha"] is pred.gp_params["alpha"],
          "the re-fit GP did not reach the controller's params")

    def loop_mse(gp_params):
        xs, us = torch.tensor(lx, device=pred.device), torch.tensor(lu, device=pred.device)
        pn = pred.single_step(xs, us, {"gp": gp_params})
        return float(torch.mean((pn - torch.tensor(lxn, device=pred.device)) ** 2))

    emit("gp_refit", {"transitions": len(lx) + len(x), "fit_seconds": fit_s,
                      "normalized_mse": mse, "loop_one_step_mse_before": loop_mse(old),
                      "loop_one_step_mse_after": loop_mse(pred.gp_params)})
    ctrl.controller_reset()  # a new episode from the same start, over the re-fit GP
    runs["mppi_gp_refit"] = counted_loop("slice_mppi_gp_refit", ctrl, GP_MORE_TICKS,
                                         {"gp_cost_rollout": GP_MORE_TICKS}, pole_check=False)
    check(kernels.build.count == builds and ctrl.optimizer._build_epoch == epoch,
          "the GP re-fit rebuilt something")
    return ctrl


# ---- the sampling phases --------------------------------------------------------
def layout_mutant_counters(seed2, kind: str) -> torch.Tensor:
    """K5's counters [K, H, 1] with a layout fault: ``tile_term_dropped``
    (every tile reads tile 0's counters) or ``r_c_swapped`` (the rollout
    order transposed: g = c*ROWS + r within the rows)."""
    C, stride = DEFAULT_TILE_K // ROWS, H * DEFAULT_TILE_K
    base, off = seed_base(seed2)
    g = torch.arange(K, dtype=torch.int64, device=seed2.device)
    if kind == "r_c_swapped":
        r, rem = g % ROWS, g // ROWS
        t, c = rem // C, rem % C
    else:
        r, t, c = rollout_coords(g, K, DEFAULT_TILE_K)
        t = torch.zeros_like(t)
    row = base + (off + t) * stride + r * C + c
    h = torch.arange(H, dtype=torch.int64, device=seed2.device)
    return (row[:, None] + h[None, :] * DEFAULT_TILE_K)[:, :, None]


def compare_fused_cem(model, pvec, low, high, gen) -> dict:
    """Phase 27: K5 against its plain version and against K1 over its own
    regenerated controls, the elite regeneration, the normals' moments, and
    the cost bound against two layout faults."""
    device = pvec.device
    s0 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=device)
    mue = torch.clamp(0.2 * torch.randn(H, 1, generator=gen, device=device), -1.0, 1.0)
    std = torch.full((H, 1), 0.5, device=device)
    seed2 = torch.tensor([1234567, 0], dtype=torch.int32, device=device)
    args = (model, s0, mue, std, pvec, seed2, low, high, K, DEFAULT_TILE_K)
    ref = fused_cem_costs_plain(*args)
    s_tiled = s0.expand(K, -1).contiguous()
    mutants = {kind: cost_rollout_plain(model, s_tiled, torch.clamp(
        mue + std * normals_from_counter(layout_mutant_counters(seed2, kind)), low, high), pvec)
        for kind in ("tile_term_dropped", "r_c_swapped")}
    numbers = compare("k5_fused_cem", lambda: fused_cem_costs(*args),
                      lambda: fused_cem_costs_plain(*args),
                      extra=lambda _: {"mutant_max_rel_err": {
                          kind: max_errors(m, ref)[1] for kind, m in mutants.items()}})
    for kind, m in mutants.items():
        check(not torch.allclose(m, ref, **KERNEL_TOL),
              f"K5: the cost bound does not reject the counters with {kind} {numbers}")
    got = fused_cem_costs(*args)
    Q = regen_controls(seed2, torch.arange(K, device=device), mue, std, low, high, K,
                       DEFAULT_TILE_K, fast=False)
    via_k1 = cost_rollout(model, s_tiled, Q, pvec)
    idx = elite_indices(got, CEM_CONFIG["cem_best_k"])
    z = normals_from_counter(cem_counters(seed2, torch.arange(K, device=device), K, H, 1,
                                          DEFAULT_TILE_K)).double()
    n = z.numel()
    extra = {"k1_over_regen_max_abs_err": max_errors(got, via_k1)[0],
             "k1_over_regen_equal_share": float((got == via_k1).double().mean()),
             "elite_regen_exact": bool(torch.equal(
                 regen_controls(seed2, idx, mue, std, low, high, K, DEFAULT_TILE_K, fast=False),
                 Q[idx])),
             "normals_mean_sigmas": float(z.mean()) * n**0.5,
             "normals_var_sigmas": (float(z.var(correction=0)) - 1.0) / (2.0 / n) ** 0.5}
    emit("k5_regeneration", extra)
    # K1, K5 and K6 take one step (short_step.cuh), so this holds K5's draws
    # to the regenerated controls, not its step: the step is held by the
    # comparisons with the plain version and with float64.
    check(extra["k1_over_regen_equal_share"] == 1.0,
          f"K5's costs differ from K1's over its regenerated controls {extra}")
    check(extra["elite_regen_exact"], "the elite regeneration is not a subset of the full one")
    check(abs(extra["normals_mean_sigmas"]) < 5.0 and abs(extra["normals_var_sigmas"]) < 5.0,
          f"K5's normals are not standard {extra}")
    k5_cases(args)
    numbers.update(bound(K * H * (RK4_STEP_OPS + STAGE_OPS + NORMAL_OPS + CEM_CONTROL_OPS),
                         nbytes(s0, mue, std, pvec, seed2, low, high) + 4 * K))
    return numbers


def long_horizon_vs_float64(model, s0, Q, pvec, outs: dict, mutants=None) -> dict:
    """The costs ``outs`` of the controls Q [K, CEM_LONG_H, U] from s0 [K,
    S] against the float64 plain version, each within GP_F64_FACTOR times
    the float32 plain version's distance from it plus 1e-6 of its largest
    cost; the bound must reject two faults of the 64-control chunks that
    K2-K6 compute ahead: the second chunk scored with the
    first's controls, and the last (partial) chunk with the second's; and
    the controls ``mutants`` (name -> controls) too."""
    ref64 = cost_rollout_plain(model, s0.double(), Q.double(), pvec.double())
    p_err = float((cost_rollout_plain(model, s0, Q, pvec).double() - ref64).abs().max())
    bound = GP_F64_FACTOR * p_err + 1e-6 * float(ref64.abs().max())
    stale, last = Q.clone(), Q.clone()
    stale[:, 64:128], last[:, 128:] = Q[:, :64], Q[:, 64:64 + Q.shape[1] - 128]
    numbers = {"plain_f64_max_abs_err": p_err, "bound": bound,
               **{f"{name}_f64_max_abs_err": float((out.double() - ref64).abs().max())
                  for name, out in outs.items()},
               "mutant_f64_max_abs_err": {
                   name: float((cost_rollout_plain(model, s0.double(), q.double(), pvec.double())
                                - ref64).abs().max())
                   for name, q in (("second_chunk_stale", stale), ("last_chunk_stale", last),
                                   *(mutants or {}).items())}}
    for name in outs:
        check(numbers[f"{name}_f64_max_abs_err"] <= bound,
              f"{name} at H={Q.shape[1]}: further from float64 than the plain version allows "
              f"{numbers}")
    for name, err in numbers["mutant_f64_max_abs_err"].items():
        check(err > bound, f"at H={Q.shape[1]}: the bound does not reject {name} {numbers}")
    return numbers


def k5_cases(args: tuple) -> dict:
    """Phase 27's further K5 numbers, over compare_fused_cem's operands
    ``args``: the costs at a horizon of CEM_LONG_H, with K1's over the
    regenerated controls (equal to them), against float64
    (long_horizon_vs_float64); its
    registers; the time at each of CEM_K; and the loops of its SASS (the
    step's instructions)."""
    model, s0, mue, std, pvec, seed2, low, high, k_full, tile_k = args
    gen = torch.Generator(device=s0.device).manual_seed(SEED)
    mue_long = torch.clamp(0.2 * torch.randn(CEM_LONG_H, 1, generator=gen, device=s0.device),
                           -1.0, 1.0)
    long_args = (model, s0, mue_long, std[:1].expand(CEM_LONG_H, -1).contiguous(), *args[4:])
    got = fused_cem_costs(*long_args)
    Q = regen_controls(seed2, torch.arange(k_full, device=s0.device), *long_args[2:4], low, high,
                       k_full, tile_k, fast=False)
    s_tiled = s0.expand(k_full, -1).contiguous()
    via_k1 = cost_rollout(model, s_tiled, Q, pvec)
    check(bool(torch.isfinite(got).all()) and got.shape == (k_full,),
          f"K5 at H={CEM_LONG_H}: bad output")
    long_h = {"plain_max_abs_err": max_errors(got, fused_cem_costs_plain(*long_args))[0],
              "k1_equal_share": float((got == via_k1).double().mean()),
              **long_horizon_vs_float64(model, s_tiled, Q, pvec, {"k5": got, "k1": via_k1})}
    check(long_h["k1_equal_share"] == 1.0,
          f"K5 at H={CEM_LONG_H}: its costs differ from K1's over its regenerated controls {long_h}")
    times = {str(k): cuda_ms(lambda: fused_cem_costs(model, s0, mue, std, pvec, seed2, low, high, k,
                                                     min(k, DEFAULT_TILE_K)), 50) for k in CEM_K}
    ncu = shutil.which("ncu") or Path(kernels._nvcc()).parent / "ncu"
    out = {f"H{CEM_LONG_H}": long_h, **ptxas_resources("fused_cem_kernel"), "ms_at_k": times,
           "sass": sass_loops("fused_cem_kernel") or "not measured",
           "stall_reasons": (f"not measured: {ncu} is on the machine, this script does not run it"
                             if Path(ncu).is_file() else "not measured: no ncu on the machine")}
    emit("k5_cases", out)
    return out


def k3_mutant_controls(eps, W, u_nom, low, high, kind: str) -> tuple:
    """``(u, d)`` [K, H, U] of mppi_controls_plain's bracket walk with one
    fault of K3 pass 1's prologue, which carries the bracket's two noise
    values from step to step: ``second_point_dropped`` (d = W[p0,h] e[p0])
    or ``bracket_restarted_each_chunk`` (at the head of each 64-step chunk
    after the first, the two values taken again from points 0 and 1 while
    p0 carries on)."""
    P, U, K = eps.shape
    Wl, zero = W.tolist(), torch.zeros_like(eps[0])
    p0, e0, e1 = 0, eps[0], eps[1] if P > 1 else zero
    us, ds = [], []
    for h in range(u_nom.shape[0]):
        if kind == "bracket_restarted_each_chunk" and h and h % 64 == 0:
            e0, e1 = eps[0], eps[1] if P > 1 else zero
        while p0 + 1 < P and Wl[p0][h] == 0.0:
            p0 += 1
            e0, e1 = e1, eps[p0 + 1] if p0 + 1 < P else zero
        d = W[p0, h] * e0
        if p0 + 1 < P and kind != "second_point_dropped":
            d = d + W[p0 + 1, h] * e1
        ds.append(d)
        us.append(torch.clamp(u_nom[h][:, None] + d, low[:, None], high[:, None]))
    return tuple(torch.stack(t).permute(2, 0, 1).contiguous() for t in (us, ds))


def mppi_mutants(model, s0, u_nom, pvec, eps, W, low, high, cc_weight, R, NU, kinds) -> dict:
    """The MPPI costs (mppi_controls_cost_plain) of the noise eps [P, U, K]
    with each fault of ``kinds`` in the controls computed ahead of the
    steps: ``controls_one_step_early`` (step h takes the control and
    perturbation of h+1, the last step its own), ``next_rollout_eps``
    (rollout k takes rollout k+1's noise), and k3_mutant_controls' two."""
    out = {}
    for kind in kinds:
        if kind == "next_rollout_eps":
            u, d = mppi_controls_plain(eps.roll(-1, 2), W, u_nom, low, high)
        elif kind == "controls_one_step_early":
            u, d = (torch.cat([t[:, 1:], t[:, -1:]], dim=1)
                    for t in mppi_controls_plain(eps, W, u_nom, low, high))
        else:
            u, d = k3_mutant_controls(eps, W, u_nom, low, high, kind)
        out[kind] = mppi_controls_cost_plain(model, s0, u, d, pvec, cc_weight, R, NU)
    return out


def k3_mutants(args: tuple, kinds) -> dict:
    """K3 pass 1's costs over fused_mppi_costs_plain's operands ``args``
    with each fault of ``kinds``: mppi_mutants' over its counters' noise,
    ``next_rollout_counters`` (rollout g draws rollout g+1's noise) being
    its ``next_rollout_eps``."""
    model, s0, u_nom, pvec, seed2, W, low, high, cc_weight, R, NU, stdev, k, tile_k = args
    eps = mppi_noise(seed2, k, W.shape[0], u_nom.shape[1], tile_k, fast=False) * stdev
    named = {"next_rollout_counters": "next_rollout_eps"}
    out = mppi_mutants(model, s0, u_nom, pvec, eps, W, low, high, cc_weight, R, NU,
                       [named.get(kind, kind) for kind in kinds])
    return {kind: out[named.get(kind, kind)] for kind in kinds}


def mppi_long_horizon(label: str, kernel, plain, model, s0, pvec, eps, W, u_nom, low, high,
                      cc_weight: float) -> dict:
    """An MPPI cost kernel at a horizon of CEM_LONG_H (inducing period
    PERIOD: P=14, two full 64-control chunks and a partial one) over the
    noise eps [P, U, k] of its rollouts from s0 [S]: ``kernel(cc)`` its
    costs at cc_weight cc, ``plain(cc, dtype)`` its plain version's on
    operands of that type.  At cc_weight 0, its costs equal K1's over
    mppi_controls_plain's controls (share 1.0) and both against float64
    (long_horizon_vs_float64, whose bound must also reject
    bracket_restarted_each_chunk); at the path's ``cc_weight``, against
    the float64 plain version within GP_F64_FACTOR times the float32 plain
    version's distance from it plus 1e-6 of its largest cost."""
    k = eps.shape[2]
    u, _ = mppi_controls_plain(eps, W, u_nom, low, high)
    s_tiled = s0.expand(k, -1).contiguous()
    got0, via_k1 = kernel(0.0), cost_rollout(model, s_tiled, u, pvec)
    restarted, _ = k3_mutant_controls(eps, W, u_nom, low, high, "bracket_restarted_each_chunk")
    numbers = {"k1_equal_share": float((got0 == via_k1).double().mean()),
               **long_horizon_vs_float64(model, s_tiled, u, pvec, {label: got0, "k1": via_k1},
                                         {"bracket_restarted_each_chunk": restarted})}
    check(numbers["k1_equal_share"] == 1.0,
          f"{label} at H={CEM_LONG_H}: its costs differ from K1's over its controls {numbers}")
    numbers["corr"] = corr_vs_float64(label, kernel(cc_weight), plain(cc_weight, torch.float32),
                                      plain(cc_weight, torch.float64))
    return numbers


def corr_vs_float64(label: str, got, plain32, ref64) -> dict:
    """An MPPI kernel's costs ``got`` at the path's cc_weight and a long
    horizon against its float64 plain version ``ref64``: within
    GP_F64_FACTOR times the float32 plain version's (``plain32``) distance
    from it plus 1e-6 of its largest cost."""
    p_err = float((plain32.double() - ref64).abs().max())
    numbers = {"f64_max_abs_err": float((got.double() - ref64).abs().max()),
               "plain_f64_max_abs_err": p_err,
               "bound": GP_F64_FACTOR * p_err + 1e-6 * float(ref64.abs().max())}
    check(bool(torch.isfinite(got).all()) and got.shape == ref64.shape
          and numbers["f64_max_abs_err"] <= numbers["bound"],
          f"{label} at H={CEM_LONG_H}: further from float64 than the plain version allows "
          f"{numbers}")
    return numbers


def as_type(operands: tuple, dtype) -> tuple:
    """``operands`` with each floating-point tensor cast to ``dtype``."""
    return tuple(t.to(dtype) if torch.is_tensor(t) and t.is_floating_point() else t
                 for t in operands)


def k3_long_horizon(args: tuple) -> dict:
    """K3's pass 1 at a horizon of CEM_LONG_H over compare_fused_mppi's
    operands ``args`` (mppi_long_horizon)."""
    model, s0, _, pvec, seed2, _, low, high, cc_weight, R, NU, stdev, k, tile_k = args
    gen = torch.Generator(device=s0.device).manual_seed(SEED + 2)
    u_nom = torch.clamp(0.2 * torch.randn(CEM_LONG_H, 1, generator=gen, device=s0.device),
                        -1.0, 1.0)
    W = torch.as_tensor(interpolation_matrix(CEM_LONG_H, PERIOD), device=s0.device)

    def operands(cc):
        return (model, s0, u_nom, pvec, seed2, W, low, high, cc, R, NU, stdev, k, tile_k)

    return mppi_long_horizon(
        "k3", lambda cc: fused_mppi_costs(*operands(cc)),
        lambda cc, dtype: fused_mppi_costs_plain(*as_type(operands(cc), dtype)), model, s0, pvec,
        mppi_noise(seed2, k, W.shape[0], 1, tile_k, fast=False) * stdev, W, u_nom, low, high,
        cc_weight)


def k3_cases(args: tuple) -> dict:
    """Phase 28's further numbers of K3's pass 1 over compare_fused_mppi's
    operands ``args``: the costs at each RAGGED_K (tiles of K) and with one
    inducing point (P=1), each to KERNEL_TOL; the bound against k3_mutants'
    three faults at H; the share of its costs at cc_weight 0 equal to K1's
    over mppi_controls_plain's controls (1.0); k3_long_horizon; the time at
    SMALL_K + K_SCALING; and its resources (registers, spills, static
    shared memory) and the loops of its SASS (the step's instructions)."""
    model, s0, u_nom, pvec, seed2, W, low, high, cc_weight, R, NU, stdev, k_full, tile_k = args
    cases = {f"K{k}": args[:12] + (k, k) for k in RAGGED_K}
    cases["P1"] = args[:5] + (W[:1].contiguous(),) + args[6:]
    numbers = held_to_plain("K3 pass 1", fused_mppi_costs, fused_mppi_costs_plain, cases)
    numbers["mutant_max_rel_err"] = rejected("K3 pass 1", k3_mutants(
        args, ("controls_one_step_early", "second_point_dropped", "next_rollout_counters")),
        fused_mppi_costs_plain(*args))
    eps = mppi_noise(seed2, k_full, W.shape[0], 1, tile_k, fast=False) * stdev
    u, _ = mppi_controls_plain(eps, W, u_nom, low, high)
    got0 = fused_mppi_costs(*args[:8], 0.0, *args[9:])
    numbers["k1_equal_share"] = float(
        (got0 == cost_rollout(model, s0.expand(k_full, -1).contiguous(), u, pvec)).double().mean())
    numbers[f"H{CEM_LONG_H}"] = k3_long_horizon(args)
    check(numbers["k1_equal_share"] == 1.0,
          f"K3 pass 1: its costs at cc_weight 0 differ from K1's over its controls {numbers}")
    out = {"cases": numbers, "ms_at_k": ms_at_k(
        lambda k: fused_mppi_costs(*args[:12], k, min(k, DEFAULT_TILE_K)), SMALL_K + K_SCALING)}
    emit("k3_cases", out)
    out["resources"] = {**ptxas_resources("fused_mppi_cost_kernel"),
                        "sass": sass_loops("fused_mppi_cost_kernel") or "not measured"}
    emit("k3_resources", out["resources"])
    return out


def held_to_plain(label: str, kernel, plain, cases: dict) -> dict:
    """``kernel(*a)`` against ``plain(*a)`` to KERNEL_TOL for the operands
    ``a`` of each case; the errors by case."""
    numbers = {}
    for case, a in cases.items():
        got, ref = kernel(*a), plain(*a)
        torch.cuda.synchronize()
        numbers[case] = errs = dict(zip(("max_abs_err", "max_rel_err"), max_errors(got, ref)))
        check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
              f"{label} {case}: bad output {errs}")
        check(torch.allclose(got, ref, **KERNEL_TOL), f"{label} {case}: kernel disagrees {errs}")
    return numbers


def rejected(label: str, mutants: dict, ref) -> dict:
    """Each mutant's costs outside KERNEL_TOL of the plain version's ``ref``;
    their max rel errors."""
    errs = {kind: max_errors(m, ref)[1] for kind, m in mutants.items()}
    for kind, m in mutants.items():
        check(not torch.allclose(m, ref, **KERNEL_TOL),
              f"{label}: the cost bound does not reject {kind} {errs}")
    return errs


def k2_cases(args: tuple, stdev: float) -> dict:
    """Phase 3's further K2 numbers over its operands ``args`` at the main
    path's shapes (noise of scale ``stdev``): the costs at each RAGGED_K and
    with one inducing point (P=1), each to KERNEL_TOL; the bound against
    mppi_mutants' three faults at H; the share of its costs at cc_weight 0
    equal to K1's over mppi_controls_plain's controls (1.0); at a horizon of
    CEM_LONG_H (mppi_long_horizon, over noise from seed SEED + 3); the time
    at SMALL_K + K_SCALING; and its resources (registers, spills, static
    shared memory) and the loops of its SASS (the step's instructions)."""
    model, s0, u_nom, pvec, eps, W, low, high, cc_weight, R, NU = args
    device, k_full = s0.device, eps.shape[2]
    cases = {f"K{k}": args[:4] + (eps[:, :, :k].contiguous(),) + args[5:] for k in RAGGED_K}
    cases["P1"] = args[:4] + (eps[:1].contiguous(), W[:1].contiguous()) + args[6:]
    numbers = held_to_plain("K2", mppi_cost, mppi_cost_plain, cases)
    numbers["mutant_max_rel_err"] = rejected("K2", mppi_mutants(
        *args[:5], W, low, high, cc_weight, R, NU,
        ("controls_one_step_early", "second_point_dropped", "next_rollout_eps")),
        mppi_cost_plain(*args))
    u, _ = mppi_controls_plain(eps, W, u_nom, low, high)
    got0 = mppi_cost(*args[:8], 0.0, *args[9:])
    numbers["k1_equal_share"] = float(
        (got0 == cost_rollout(model, s0.expand(k_full, -1).contiguous(), u, pvec)).double().mean())
    check(numbers["k1_equal_share"] == 1.0,
          f"K2: its costs at cc_weight 0 differ from K1's over its controls {numbers}")
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    u_long = torch.clamp(0.2 * torch.randn(CEM_LONG_H, 1, generator=gen, device=device),
                         -1.0, 1.0)
    W_long = torch.as_tensor(interpolation_matrix(CEM_LONG_H, PERIOD), device=device)
    eps_long = stdev * torch.randn(W_long.shape[0], 1, k_full, generator=gen, device=device)

    def operands(cc):
        return (model, s0, u_long, pvec, eps_long, W_long, low, high, cc, R, NU)

    numbers[f"H{CEM_LONG_H}"] = mppi_long_horizon(
        "k2", lambda cc: mppi_cost(*operands(cc)),
        lambda cc, dtype: mppi_cost_plain(*as_type(operands(cc), dtype)), model, s0, pvec,
        eps_long, W_long, u_long, low, high, cc_weight)
    ks = SMALL_K + K_SCALING
    first = {k: eps[:, :, :k].contiguous() for k in ks}
    out = {"cases": numbers,
           "ms_at_k": ms_at_k(lambda k: mppi_cost(*args[:4], first[k], *args[5:]), ks)}
    emit("k2_cases", out)
    out["resources"] = {**ptxas_resources("mppi_cost_kernel"),
                        "sass": sass_loops("mppi_cost_kernel") or "not measured"}
    emit("k2_resources", out["resources"])
    return out


def compare_fused_mppi(model, pvec, opt, gen) -> tuple:
    """Phases 28-29: K3's two passes against their plain versions (pass 2
    after the block sum, and its bound against two faults), then the whole
    step against the plain step on the same card tensors."""
    device = pvec.device
    s0 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=device)
    u_nom = torch.clamp(0.2 * torch.randn(H, 1, generator=gen, device=device), -1.0, 1.0)
    seed2 = torch.tensor([7654321, 0], dtype=torch.int32, device=device)
    W, low, high = opt.interp.matrix, opt.action_low, opt.action_high
    P, stdev = W.shape[0], opt.SQRTRHODTINV
    args = (model, s0, u_nom, pvec, seed2, W, low, high, opt.cc_weight, opt.R, opt.NU, stdev, K,
            DEFAULT_TILE_K)
    k3a = compare("k3_fused_mppi_cost", lambda: fused_mppi_costs(*args),
                  lambda: fused_mppi_costs_plain(*args))
    k3a.update(bound(K * H * (RK4_STEP_OPS + STAGE_OPS + MPPI_EXTRA_OPS)
                     + K * P * (NORMAL_OPS + 1), nbytes(s0, u_nom, pvec, seed2, W, low, high)
                     + 4 * K))
    k3_cases(args)
    cost = fused_mppi_costs(*args)
    rho = torch.amin(cost)
    red = torch.stack([rho, torch.sum(torch.exp(-(cost - rho) / opt.LBD))])
    wargs = (seed2, cost, red, P, 1, opt.LBD, K, DEFAULT_TILE_K)
    ref = fused_mppi_weights_plain(*wargs, fast=False).sum(0)
    w = torch.exp(-(cost - rho) * (1.0 / opt.LBD))
    z = mppi_noise(seed2, K, P, 1, DEFAULT_TILE_K, fast=False)
    mutants = {"unnormalized": (z * w).sum(-1), "p_shifted": (torch.roll(z, 1, 0) * w).sum(-1)
               / red[1]}
    k3b = compare("k3_fused_mppi_weights", lambda: fused_mppi_weights(*wargs, fast=False),
                  lambda: fused_mppi_weights_plain(*wargs, fast=False), tol=WEIGHTS_TOL,
                  reduce=lambda t: t.sum(0), shape=(P, 1),
                  extra=lambda _: {"mutant_max_abs_err": {
                      kind: max_errors(m, ref)[0] for kind, m in mutants.items()}})
    for kind, m in mutants.items():
        check(not torch.allclose(m, ref, **WEIGHTS_TOL),
              f"K3 pass 2: the bound does not reject the sums {kind} {k3b}")
    k3b.update(bound(K * (P * (NORMAL_OPS + 2) + WEIGHT_OPS),
                     nbytes(seed2, cost, red) + 4 * P * (-(-K // 128))))
    sargs = args[:11] + (opt.LBD,) + args[11:]
    (un, c), (un_p, c_p) = fused_mppi_step(*sargs), fused_mppi_step_plain(*sargs)
    numbers = {"u_nom_max_abs_err": max_errors(un, un_p)[0], "cost_max_abs_err": max_errors(c, c_p)[0],
               "u_nom_moved": float((un - u_nom).abs().max())}
    emit("k3_fused_mppi_step", numbers)
    check(torch.allclose(c, c_p, **KERNEL_TOL) and numbers["u_nom_max_abs_err"] <= UNOM_ATOL,
          f"the fused MPPI step on the card differs from its plain version {numbers}")
    return k3a, k3b


def value_slack(post, x: torch.Tensor, cost_params: dict, horizon: int) -> torch.Tensor:
    """Per rollout, how far X_TOL's bound on the terminal states ``x``
    [N, S] moves the value term post(x)/(H+1) to first order: |dV/dx| .
    (atol + rtol |x|) / (H+1)."""
    x = x.detach()
    with torch.enable_grad():
        xg = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(post(xg, cost_params).sum(), xg)
    return (g.abs() * (X_TOL["atol"] + X_TOL["rtol"] * x.abs())).sum(1) / (horizon + 1)


def update_vs_cpu_cem(name: str, ctrl: MPCController, config: dict, spec: str = "ODE",
                      value=None) -> None:
    """Phase 34, CEM: one update on the card and on the CPU (the plain
    versions) from the card's state and params with the same draws, outer
    iteration by outer iteration.  Both score the card's mue and std; the
    elites are the card's own top-k, which must be a top-k of the CPU's
    costs within the cost bound (exactly tied or near-tied costs may order
    otherwise on the two devices), and both refit from them.  Then the
    whole update on each device, held to the same where every iteration's
    elite set agreed.  ``spec`` and ``value`` (a learned terminal value
    the CPU's controller gets too) as update_vs_cpu_mppi's (phase 62).  A
    valued cost's V(x_H)/(H+1) moves with the kernel's x_H, which is held
    to X_TOL: its costs get, beside the kernel's bound, ``value_slack``'s
    first-order reach of that bound through V (the committed V's slope
    reaches ~8e4 a unit of state)."""
    opt = ctrl.optimizer
    state = opt.opt_state
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    draws = opt.sample_draws(state)
    params = ctrl._assemble_params()
    cpu = make_controller("cpu", "cem-tf", config, spec=spec)
    if value is not None:
        attach_value_terminal(cpu, to_cpu(value))
    check(cpu.optimizer._fused == opt._fused, f"{name}: the CPU took another path")
    best_k = opt.cem_best_k
    score = opt.prepare(s_now, params, state.u_prev)
    score_c = cpu.optimizer.prepare(s_now.cpu(), to_cpu(params), state.u_prev.cpu())
    mue, std = state.dist_mue, state.stdev
    errs = {"cost": 0.0, "elites": 0.0, "mue": 0.0, "std": 0.0, "topk_excess": 0.0}
    same_sets, slack_max = True, 0.0
    for draw in draws:
        mue_in, std_in = mue.cpu(), std.cpu()
        cost, pick, _ = score(mue, std, draw)
        cost_c, pick_c, _ = score_c(mue_in, std_in, draw.cpu())
        idx = elite_indices(cost, best_k)
        kth = torch.sort(cost_c).values[best_k - 1]
        slack = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * float(kth.abs())
        errs["topk_excess"] = max(errs["topk_excess"], float(cost_c[idx.cpu()].max() - kth))
        check(float(cost_c[idx.cpu()].max() - kth) <= slack,
              f"{name}: the card's elites are not a top-k of the CPU's costs")
        same_sets &= set(idx.tolist()) == set(elite_indices(cost_c, best_k).tolist())
        elites, elites_c = pick(idx), pick_c(idx.cpu())
        mue, std = refit(elites)
        mue_c, std_c = refit(elites_c)
        for k, (a, b) in {"cost": (cost, cost_c), "elites": (elites, elites_c),
                          "mue": (mue, mue_c), "std": (std, std_c)}.items():
            errs[k] = max(errs[k], max_errors(a.cpu(), b)[0])
        slack = 0.0
        if value is not None:
            copt = cpu.optimizer
            traj = copt._rollout_and_cost(s_now.cpu().expand(cost_c.shape[0], -1),
                                          pick_c(torch.arange(cost_c.shape[0])),
                                          state.u_prev.cpu(), to_cpu(params))[1]
            slack = value_slack(copt._post_terminal_fn(), traj[:, -1],
                                copt._cost_params(to_cpu(params)), copt.mpc_horizon)
            slack_max = max(slack_max, float(slack.max()))
        check(bool(((cost.cpu() - cost_c).abs()
                    <= KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * cost_c.abs() + slack).all()),
              f"{name}: costs differ {errs}, value slack {slack_max}")
    u, new, _ = opt.update(state, s_now, params, draws)
    cpu_state = state._replace(generator=torch.Generator(), dist_mue=state.dist_mue.cpu(),
                               stdev=state.stdev.cpu(), u_prev=state.u_prev.cpu())
    uc, new_c, _ = cpu.optimizer.update(cpu_state, s_now.cpu(), to_cpu(params),
                                        [d.cpu() for d in draws])
    numbers = {f"{k}_max_abs_err": v for k, v in errs.items() if k != "topk_excess"}
    numbers.update({"topk_excess": errs["topk_excess"], "iterations": len(draws),
                    "value_slack_max": slack_max,
                    "same_elite_sets": same_sets,
                    "update_u_abs_err": float((u.cpu() - uc).abs().max()),
                    "update_mue_max_abs_err": max_errors(new.dist_mue.cpu(), new_c.dist_mue)[0]})
    emit(name, numbers)
    check(errs["elites"] <= REGEN_ATOL and errs["mue"] <= UNOM_ATOL and errs["std"] <= UNOM_ATOL,
          f"{name}: the card's refit differs from the CPU's {numbers}")
    check(not same_sets or (numbers["update_u_abs_err"] <= UNOM_ATOL
                            and numbers["update_mue_max_abs_err"] <= UNOM_ATOL),
          f"{name}: the card's update differs from the CPU's {numbers}")


# ---- the fleet phases -----------------------------------------------------------
def fleet_controller(device: str, optimizer: str, config: dict, B: int, spec: str = "ODE",
                     per_slot_dyn=("L",)) -> BatchedMPCController:
    """A batched-mpc controller of B slots over ``spec`` (per-slot pole
    lengths by default); over "ODE+res" (or its fast form) with
    residual_controller's seeded nonzero residual."""
    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"optimizer": optimizer, "controller_logging": False,
                                        "device": device})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config=config, cost_function_config=COST_WEIGHTS, num_slots=B,
                   per_slot_dyn=per_slot_dyn)
    if spec.startswith(RES_SPEC):
        seed_residual(ctrl.optimizer.predictor.predictor)
    return ctrl


def learned_fleet(device: str, kind: str, B: int) -> BatchedMPCController:
    """An MPPI fleet of B slots over LEARNED_FLEETS' model ``kind``."""
    spec, per_slot_dyn = LEARNED_FLEETS[kind]
    return fleet_controller(device, "mppi", FLEET_MPPI_CONFIG, B, spec, per_slot_dyn)


def fleet_operands(opt, B: int, gen) -> tuple:
    """K4's and K6's model and per-session operands at B sessions: states
    near upright, per-slot pole lengths over FLEET_L and targets over
    +-0.2, previous controls over [-1, 1]."""
    device = opt.device
    model, _ = ode.rollout_model(opt)
    _, slot_keys = split_slot_keys(model.param_keys, ("L",))
    params = place({"dyn": {k: float(v) for k, v in opt.predictor.default_params().items()},
                    "cost": COST_WEIGHTS}, device)
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B, device)(
        2.0 * torch.rand(B, 1, generator=gen, device=device) - 1.0,
        dict(params["dyn"], L=torch.linspace(*FLEET_L, B, device=device)), params["cost"],
        {"target_position": torch.linspace(-0.2, 0.2, B, device=device)})
    s0 = 0.05 * torch.randn(B, 4, generator=gen, device=device)
    return model, pvec_b, s0


def k4_mutants(args: tuple, kinds) -> dict:
    """K4's costs over mppi_cost_cols_plain's operands ``args`` with each
    fault of ``kinds``: ``next_session_rows`` (session b reads session
    b+1's state, plan, parameters and noise) or ``u_prev_of_slot_0`` (every
    session takes slot 0's previous control)."""
    model, s0, u_nom, pvec_b, eps, *consts = args
    out = {}
    for kind in kinds:
        if kind == "next_session_rows":
            rows = tuple(t.roll(-1, 0) for t in (s0, u_nom, pvec_b, eps))
        else:
            col = model.param_keys.index("__u_prev_0")
            slot0 = pvec_b.clone()
            slot0[:, col] = pvec_b[0, col]
            rows = (s0, u_nom, slot0, eps)
        out[kind] = mppi_cost_cols_plain(model, *rows, *consts)
    return out


def compare_k4(opt, gen) -> dict:
    """Phase 35: K4 against its plain version at B=FLEET_B_MAX sessions,
    and the cost bound against a kernel that reads session b+1's rows and
    one that takes every session's previous control from slot 0; then
    k4_cases."""
    B, K, Hf = FLEET_B_MAX, opt.num_rollouts, opt.mpc_horizon
    model, pvec_b, s0 = fleet_operands(opt, B, gen)
    P = opt.interp.number_of_interpolation_inducing_points
    u_nom = torch.clamp(0.2 * torch.randn(B, Hf, 1, generator=gen, device=opt.device), -1.0, 1.0)
    eps = opt.SQRTRHODTINV * torch.randn(B, P, 1, K, generator=gen, device=opt.device)
    consts = (opt.interp.matrix, opt.action_low, opt.action_high, opt.cc_weight, opt.R, opt.NU)
    args = (model, s0, u_nom, pvec_b, eps) + consts
    ref = mppi_cost_cols_plain(*args)
    mutants = k4_mutants(args, ("next_session_rows", "u_prev_of_slot_0"))
    numbers = compare("k4_mppi_cost_cols", lambda: mppi_cost_cols(*args),
                      lambda: mppi_cost_cols_plain(*args), shape=(B, K),
                      extra=lambda _: {"mutant_max_abs_err": {
                          kind: max_errors(m, ref)[0] for kind, m in mutants.items()}})
    for kind, m in mutants.items():
        check(not torch.allclose(m, ref, **KERNEL_TOL),
              f"K4: the cost bound does not reject {kind} {numbers}")
    k4_cases(args, opt.SQRTRHODTINV)
    numbers.update(bound(B * K * Hf * (RK4_STEP_OPS + STAGE_OPS + MPPI_EXTRA_OPS),
                         nbytes(s0, u_nom, pvec_b, eps, *consts[:3]) + 4 * B * K))
    return numbers


def k4_cases(args: tuple, stdev: float) -> dict:
    """Phase 35's further K4 numbers over compare_k4's operands ``args`` at
    FLEET_B_MAX sessions (noise of scale ``stdev``; further noise from seed
    SEED + 4): the costs at a ragged B*K (3 sessions of K=1000: blocks
    straddle sessions) to KERNEL_TOL; at cc_weight 0 equal to K1's over each
    session's mppi_controls_plain controls (share 1.0); at a horizon of
    CEM_LONG_H (4 sessions; two full 64-control chunks and a partial one),
    equal to K1's there at cc_weight 0, both against float64
    (long_horizon_vs_float64, whose bound must reject
    bracket_restarted_each_chunk), and at the path's cc_weight against the
    float64 plain version (corr_vs_float64); the time at FLEET_B and
    FLEET_B_MAX sessions; its resources and the loops of its SASS."""
    model, s0, u_nom, pvec_b, eps, W, low, high, cc_weight, R, NU = args
    B, P, U, K = eps.shape
    device = s0.device
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    rag = (model, s0[:3], u_nom[:3], pvec_b[:3],
           stdev * torch.randn(3, P, U, 1000, generator=gen, device=device)) + args[5:]
    numbers = held_to_plain("K4", mppi_cost_cols, mppi_cost_cols_plain, {"B3_K1000": rag})

    def controls(e, w, un, kind=None):  # per session: [b, K, H, U]
        return torch.stack([(k3_mutant_controls(e[b], w, un[b], low, high, kind) if kind else
                             mppi_controls_plain(e[b], w, un[b], low, high))[0]
                            for b in range(e.shape[0])])

    got0 = mppi_cost_cols(*args[:8], 0.0, *args[9:])
    numbers["k1_equal_share"] = float(
        (got0 == k1_per_session(model, s0, controls(eps, W, u_nom), pvec_b)).double().mean())
    check(numbers["k1_equal_share"] == 1.0,
          f"K4: its costs at cc_weight 0 differ from K1's over its controls {numbers}")
    Bl = 4
    W_long = torch.as_tensor(interpolation_matrix(CEM_LONG_H, PERIOD), device=device)
    u_long = torch.clamp(0.2 * torch.randn(Bl, CEM_LONG_H, U, generator=gen, device=device),
                         -1.0, 1.0)
    eps_long = stdev * torch.randn(Bl, W_long.shape[0], U, K, generator=gen, device=device)

    def operands(cc):
        return (model, s0[:Bl], u_long, pvec_b[:Bl], eps_long, W_long, low, high, cc, R, NU)

    got = mppi_cost_cols(*operands(0.0)).reshape(-1)
    Q = controls(eps_long, W_long, u_long)
    via_k1 = k1_per_session(model, s0[:Bl], Q, pvec_b[:Bl]).reshape(-1)
    check(bool(torch.isfinite(got).all()), f"K4 at H={CEM_LONG_H}: bad output")
    rows = (CEM_LONG_H, U)
    numbers[f"H{CEM_LONG_H}"] = long_h = {
        "k1_equal_share": float((got == via_k1).double().mean()),
        **long_horizon_vs_float64(
            model, per_rollout(s0[:Bl], K).T, Q.reshape(Bl * K, *rows),
            per_rollout(pvec_b[:Bl], K), {"k4": got, "k1": via_k1},
            {"bracket_restarted_each_chunk": controls(
                eps_long, W_long, u_long, "bracket_restarted_each_chunk").reshape(Bl * K, *rows)}),
        "corr": corr_vs_float64("K4", mppi_cost_cols(*operands(cc_weight)),
                                mppi_cost_cols_plain(*operands(cc_weight)),
                                mppi_cost_cols_plain(*as_type(operands(cc_weight),
                                                              torch.float64)))}
    check(long_h["k1_equal_share"] == 1.0,
          f"K4 at H={CEM_LONG_H}: its costs differ from K1's over its controls {long_h}")
    out = {"cases": numbers,
           "ms_at_b": {str(b): cuda_ms(lambda: mppi_cost_cols(
               model, s0[:b], u_nom[:b], pvec_b[:b], eps[:b], *args[5:]), 50)
               for b in (FLEET_B, FLEET_B_MAX)}}
    emit("k4_cases", out)
    out["resources"] = {**ptxas_resources("mppi_cost_cols_kernel"),
                        "sass": sass_loops("mppi_cost_cols_kernel") or "not measured"}
    emit("k4_resources", out["resources"])
    return out


def k6_mutant_counters(seed_b, K: int, Hf: int, kind: str) -> torch.Tensor:
    """K6's counters [B, K, H, 1] with a layout fault: ``k5_tiled_counter``
    (K5's counter of each session's seed, tiles of FLEET_MUTANT_TILE),
    ``r_cw_swapped`` (rollout k = r*cps + cw reads cw*8 + r's counters) or
    ``next_session_seed`` (session b draws with session b+1's seed)."""
    B = seed_b.shape[0]
    if kind == "k5_tiled_counter":
        return torch.stack([cem_counters(torch.stack([s, torch.zeros_like(s)]),
                                         torch.arange(K, device=seed_b.device), K, Hf, 1,
                                         FLEET_MUTANT_TILE) for s in seed_b])
    k = torch.arange(K, device=seed_b.device)
    if kind == "next_session_seed":
        return cols_counters(seed_b.roll(-1), k.expand(B, K), K, Hf, 1)
    cps = K // ROWS
    swapped = (k % cps) * ROWS + k // cps
    return cols_counters(seed_b, swapped.expand(B, K), K, Hf, 1)


def compare_k6(opt, gen) -> dict:
    """Phase 36: K6 against its plain version at B=FLEET_B_MAX sessions; its
    costs against K1's over the controls regen_cols draws again, session
    by session, equal in every entry; the elite rows' regeneration an exact
    subset of the full one; the cost bound against K5's tiled counter and
    the swap of r and cw and the next session's seed; then k6_cases."""
    B, K, Hf = FLEET_B_MAX, opt.num_rollouts, opt.mpc_horizon
    device = opt.device
    model, pvec_b, s0 = fleet_operands(opt, B, gen)
    mue = torch.clamp(0.2 * torch.randn(B, Hf, 1, generator=gen, device=device), -1.0, 1.0)
    std = torch.full((B, Hf, 1), 0.5, device=device)
    seed_b = torch.randint(0, 2**31 - 1, (B,), generator=gen, dtype=torch.int32, device=device)
    low, high = opt.action_low, opt.action_high
    args = (model, s0, mue, std, pvec_b, seed_b, low, high, K)
    ref = fused_cem_cols_plain(*args)
    rows = per_rollout(pvec_b, K)
    s_rows = per_rollout(s0, K).T
    mutants = {kind: cost_rollout_plain(model, s_rows, torch.clamp(
        mue[:, None] + std[:, None] * normals_from_counter(k6_mutant_counters(seed_b, K, Hf, kind)),
        low, high).reshape(B * K, Hf, 1), rows).reshape(B, K)
        for kind in ("k5_tiled_counter", "r_cw_swapped", "next_session_seed")}
    numbers = compare("k6_fused_cem_cols", lambda: fused_cem_cols(*args),
                      lambda: fused_cem_cols_plain(*args), shape=(B, K),
                      extra=lambda _: {"mutant_max_rel_err": {
                          kind: max_errors(m, ref)[1] for kind, m in mutants.items()}})
    for kind, m in mutants.items():
        check(not torch.allclose(m, ref, **KERNEL_TOL),
              f"K6: the cost bound does not reject {kind} {numbers}")
    got = fused_cem_cols(*args)
    Q = regen_cols(seed_b, torch.arange(K, device=device).expand(B, K), mue, std, low, high, K,
                   fast=False)
    via_k1 = k1_per_session(model, s0, Q, pvec_b)
    idx = elite_indices(got, FLEET_CEM_CONFIG["cem_best_k"])
    extra = {"k1_over_regen_max_abs_err": max_errors(got, via_k1)[0],
             "k1_over_regen_equal_share": float((got == via_k1).double().mean()),
             "elite_regen_exact": bool(torch.equal(
                 regen_cols(seed_b, idx, mue, std, low, high, K, fast=False),
                 torch.take_along_dim(Q, idx[:, :, None, None], dim=1)))}
    emit("k6_regeneration", extra)
    check(extra["k1_over_regen_equal_share"] == 1.0,
          f"K6's costs differ from K1's over its regenerated controls {extra}")
    check(extra["elite_regen_exact"], "K6: the elite regeneration is not a subset of the full one")
    k6_cases(args, gen)
    numbers.update(bound(B * K * Hf * (RK4_STEP_OPS + STAGE_OPS + NORMAL_OPS + CEM_CONTROL_OPS),
                         nbytes(s0, mue, std, pvec_b, seed_b, low, high) + 4 * B * K))
    return numbers


def k1_per_session(model, s0, Q, pvec_b) -> torch.Tensor:
    """K1's costs [B, K] of each session's controls Q [B, K, H, U] from its
    state s0 [B, S] under its parameters pvec_b [B, N]."""
    return torch.stack([cost_rollout(model, s0[b].expand(Q.shape[1], -1).contiguous(),
                                     Q[b].contiguous(), pvec_b[b].contiguous())
                        for b in range(Q.shape[0])])


def k6_cases(args: tuple, gen) -> dict:
    """Phase 36's further K6 numbers, over compare_k6's operands ``args``
    at FLEET_B_MAX sessions: the costs at a ragged B*K (3 sessions of
    K=1000: blocks straddle sessions) to KERNEL_TOL; at a horizon of
    CEM_LONG_H (4 sessions of K=512; two full chunks of drawn controls and
    a partial one) against float64, with K1's over regen_cols' controls,
    and equal to them; the time at FLEET_B and FLEET_B_MAX sessions; its
    registers and shared memory."""
    model, s0, mue, std, pvec_b, seed_b, low, high, K = args
    device = s0.device

    def first(b: int, k: int = K) -> tuple:  # the first b sessions, K=k
        return (model, s0[:b], mue[:b], std[:b], pvec_b[:b], seed_b[:b], low, high, k)

    numbers = held_to_plain("K6", fused_cem_cols, fused_cem_cols_plain,
                            {"B3_K1000": first(3, 1000)})
    Bl, Kl = 4, FLEET_K
    mue_long = torch.clamp(0.2 * torch.randn(Bl, CEM_LONG_H, 1, generator=gen, device=device),
                           -1.0, 1.0)
    std_long = torch.full((Bl, CEM_LONG_H, 1), 0.5, device=device)
    long_args = (model, s0[:Bl], mue_long, std_long, pvec_b[:Bl], seed_b[:Bl], low, high, Kl)
    got = fused_cem_cols(*long_args).reshape(-1)
    Q = regen_cols(seed_b[:Bl], torch.arange(Kl, device=device).expand(Bl, Kl), mue_long,
                   std_long, low, high, Kl, fast=False)
    via_k1 = k1_per_session(model, s0[:Bl], Q, pvec_b[:Bl]).reshape(-1)
    check(bool(torch.isfinite(got).all()), f"K6 at H={CEM_LONG_H}: bad output")
    numbers[f"H{CEM_LONG_H}"] = long_h = {
        "k1_equal_share": float((got == via_k1).double().mean()),
        **long_horizon_vs_float64(model, per_rollout(s0[:Bl], Kl).T,
                                  Q.reshape(Bl * Kl, CEM_LONG_H, 1), per_rollout(pvec_b[:Bl], Kl),
                                  {"k6": got, "k1": via_k1})}
    check(long_h["k1_equal_share"] == 1.0,
          f"K6 at H={CEM_LONG_H}: its costs differ from K1's over regen_cols' controls {long_h}")
    out = {"cases": numbers,
           "ms_at_b": {str(b): cuda_ms(lambda: fused_cem_cols(*first(b)), 50)
                       for b in (FLEET_B, FLEET_B_MAX)},
           **ptxas_resources("fused_cem_cols_kernel")}
    emit("k6_cases", out)
    return out


def slot_snapshot(ctrl: BatchedMPCController, slots) -> dict:
    """The optimizer state of ``slots``: tensors, host values and the
    generators' states, and a recurrent model's hidden."""
    st = ctrl.slot_states
    hidden = ctrl.slot_hidden if ctrl._stateful else ()
    fields = [x for v in st[1:] for x in (v if hasattr(v, "_fields") else (v,))]  # Adam's too
    return {i: [st.generator[i].get_state()]
            + [v[i].clone() if isinstance(v, torch.Tensor) else np.copy(v[i]) for v in fields]
            + [h[i].clone() for h in hidden]
            for i in slots}


def same_snapshot(a: list, b: list) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else np.array_equal(x, y)
               for x, y in zip(a, b))


def fleet_loop(name: str, ctrl: BatchedMPCController, ticks: int, expected: dict,
               retarget_at: int = FLEET_RETARGET_AT, swap=None, pole_check: bool = True,
               rotate_idle: bool = True) -> dict:
    """``ticks`` closed-loop ticks of a fleet: slot i against its own
    CartpoleEnv (seed 10+i) with pole half-length L_i over FLEET_L, each
    slot's model given L_i before the first tick (``update_slot_dyn``, where
    the fleet plans per-slot pole lengths).  A rotating quarter of the
    slots is idle each tick (masked off; its plant waits; none with
    ``rotate_idle`` false); at
    ``retarget_at`` half the slots change target and slot 2's model
    re-sysids to 1.02 L_2 (where it has one), and ``swap()`` runs (a new
    weight tensor, a GP hot-swap).  Checks: idle slots emit 0 and keep their
    state, random stream and hidden bit for bit, every slot's pole stays up
    (``pole_check``; the slots that kept it up are counted either way),
    nothing is rebuilt, and the kernels launched are ``expected`` (every
    count set to 0 just before the loop)."""
    B = ctrl.num_slots
    Ls = np.linspace(*FLEET_L, B)
    envs = [CartpoleEnv(batch_size=1, dt=DT, seed=10 + i, params={"L": float(L)})
            for i, L in enumerate(Ls)]
    s = np.stack([env.reset()[0][0] for env in envs])
    per_slot_L = "L" in ctrl.slot_dyn
    for i, L in enumerate(Ls):
        if per_slot_L:
            ctrl.update_slot_dyn(i, {"L": float(L)})
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    builds, epoch = kernels.build.count, ctrl.optimizer._build_epoch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host_ms, device_ms, frozen_checked = [], [], 0
    slot_max_angle = np.zeros(B)
    for t in range(ticks):
        mask = (np.arange(B) + t) % 4 != 0 if rotate_idle else np.ones(B, bool)
        attrs = [{"target_position": NEW_TARGET} if t == retarget_at and i < B // 2
                 else None for i in range(B)]
        if t == retarget_at:
            if per_slot_L:
                ctrl.update_slot_dyn(2, {"L": float(1.02 * Ls[2])})
            if swap is not None:
                swap()
        idle = np.nonzero(~mask)[0]
        before = slot_snapshot(ctrl, idle)
        start.record()
        t0 = time.perf_counter()
        u = ctrl.step_batch(s, mask, attrs)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
        after = slot_snapshot(ctrl, idle)
        check(np.all(u[~mask] == 0.0) and all(same_snapshot(before[i], after[i]) for i in idle),
              f"{name}: tick {t}: an idle slot moved")
        frozen_checked += len(idle)
        check(bool(np.all(np.isfinite(u))) and float(np.abs(u).max()) <= 1.0,
              f"{name}: tick {t}: bad controls")
        for i in np.nonzero(mask)[0]:
            s[i] = envs[i].step(u[i])[0][0]
        slot_max_angle = np.maximum(slot_max_angle, np.abs(s[:, 2]))
        check(not pole_check or slot_max_angle.max() < 0.5,
              f"{name}: tick {t}: a pole fell, states {s[np.abs(s[:, 2]) >= 0.5]}")
    check(kernels.build.count == builds and ctrl.optimizer._build_epoch == epoch,
          f"{name}: something was rebuilt during the loop")
    counts = {kernel: wrapper.launches for kernel, wrapper in COUNTED.items()}
    check(counts == {kernel: expected.get(kernel, 0) for kernel in COUNTED},
          f"{name}: kernel launches {counts}, expected {expected}")
    emit(name, {"slots": B, "ticks": ticks, "idle_slot_ticks_checked": frozen_checked,
                "step_host_p50_ms": float(np.percentile(host_ms, 50)),
                "step_host_p99_ms": float(np.percentile(host_ms, 99)),
                "step_device_p50_ms": float(np.percentile(device_ms, 50)),
                "max_abs_angle": float(slot_max_angle.max()),
                "pole_up_slots": int((slot_max_angle < 0.5).sum()),
                "slot2_L_model": float(ctrl.slot_dyn["L"][2]) if per_slot_L else None,
                "final_abs_pos_max": float(np.abs(s[:, 0]).max())})
    return counts


def fleet_inputs_now(ctrl: BatchedMPCController, gen) -> tuple:
    """The fleet's current state and params on the card: per-session
    states near upright, the slots' pole lengths and targets."""
    B, device = ctrl.num_slots, ctrl.device
    s = 0.05 * torch.randn(B, 1, 4, generator=gen, device=device)
    params = ctrl._assemble_params()
    dyn = ctrl._dyn_with_slots(params["dyn"])
    attrs = {k: torch.as_tensor(v, device=device) for k, v in ctrl.slot_attrs.items()}
    return s, dyn, params["cost"], attrs


def state_to_cpu(state):
    """A batched optimizer state on the CPU, without its generators (nested
    records such as the Adam state field by field)."""
    return type(state)(*(state_to_cpu(v) if hasattr(v, "_fields")
                         else None if isinstance(v, tuple) else to_cpu(v) for v in state))


def fleet_update_vs_cpu(mppi: BatchedMPCController, cem: BatchedMPCController, gen) -> None:
    """Phase 39: one fleet update on the card against the same update on the
    CPU (the plain versions), from the state each loop left and with the
    same draws.  MPPI: costs to the kernel bound, the new plans to
    UNOM_ATOL.  CEM, outer iteration by outer iteration from the card's
    distribution: costs to the kernel bound, the card's elites (its own
    top-k) a top-k of the CPU's costs within that bound, the refit from
    them to UNOM_ATOL; then the whole update, where the elite sets agreed."""
    B = mppi.num_slots
    opt = mppi.optimizer
    s, dyn, cost, attrs = fleet_inputs_now(mppi, gen)
    eps = opt.sample_slot_noise(mppi.slot_states.generator, np.ones(B, bool))
    _, update = opt._make_batched_semi_fused_step(B, per_slot_dyn=("L",))
    cpu = fleet_controller("cpu", "mppi", FLEET_MPPI_CONFIG, B)
    _, update_c = cpu.optimizer._make_batched_semi_fused_step(B, per_slot_dyn=("L",))
    st = mppi.slot_states
    u_nom, costs = update(st, s, dyn, cost, attrs, eps)
    u_nom_c, costs_c = update_c(state_to_cpu(st), s.cpu(), to_cpu(dyn),
                                to_cpu(cost), to_cpu(attrs), eps.cpu())
    numbers = {"mppi_cost_max_abs_err": max_errors(costs.cpu(), costs_c)[0],
               "mppi_u_nom_max_abs_err": max_errors(u_nom.cpu(), u_nom_c)[0]}
    check(torch.allclose(costs.cpu(), costs_c, **KERNEL_TOL)
          and numbers["mppi_u_nom_max_abs_err"] <= UNOM_ATOL,
          f"the fleet MPPI update on the card differs from the CPU's {numbers}")

    copt = cem.optimizer
    B, K = cem.num_slots, copt.num_rollouts
    s, dyn, cost, attrs = fleet_inputs_now(cem, gen)
    seeds = copt.sample_slot_seeds(cem.slot_states.generator, np.ones(B, bool))
    model, _ = ode.rollout_model(copt)
    _, slot_keys = split_slot_keys(model.param_keys, ("L",))
    st = cem.slot_states
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B, cem.device)(
        st.u_prev, dyn, cost, attrs)
    low, high, best_k = copt.action_low, copt.action_high, copt.cem_best_k
    mue, std = st.dist_mue[:, 0], st.stdev[:, 0]
    same_sets, errs = True, {"cost": 0.0, "mue": 0.0, "std": 0.0, "topk_excess": 0.0}
    for seed_b in seeds:
        c = fused_cem_cols(model, s[:, 0], mue, std, pvec_b, seed_b, low, high, K)
        c_c = fused_cem_cols(model, s[:, 0].cpu(), mue.cpu(), std.cpu(), pvec_b.cpu(),
                             seed_b.cpu(), low.cpu(), high.cpu(), K)
        check(torch.allclose(c.cpu(), c_c, **KERNEL_TOL), f"fleet CEM: costs differ {errs}")
        idx = elite_indices(c, best_k)
        kth = torch.sort(c_c, dim=1).values[:, best_k - 1]
        excess = torch.take_along_dim(c_c, idx.cpu(), dim=1).amax(dim=1) - kth
        slack = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * kth.abs()
        check(bool((excess <= slack).all()), "fleet CEM: the card's elites are not a top-k of "
              "the CPU's costs")
        same_sets &= bool(torch.equal(torch.sort(idx.cpu(), dim=1).values,
                                      torch.sort(elite_indices(c_c, best_k), dim=1).values))
        elite = regen_cols(seed_b, idx, mue, std, low, high, K, fast=False)
        elite_c = regen_cols(seed_b.cpu(), idx.cpu(), mue.cpu(), std.cpu(), low.cpu(),
                             high.cpu(), K, fast=False)
        mue, std = elite.mean(1), elite.std(1, correction=0)
        mue_c, std_c = elite_c.mean(1), elite_c.std(1, correction=0)
        for key, (a, b) in {"cost": (c, c_c), "mue": (mue, mue_c), "std": (std, std_c)}.items():
            errs[key] = max(errs[key], max_errors(a.cpu(), b)[0])
        errs["topk_excess"] = max(errs["topk_excess"], float(excess.max()))
    _, update = copt._make_batched_fused_cem_step(B, per_slot_dyn=("L",))
    cpu = fleet_controller("cpu", "cem-tf", FLEET_CEM_CONFIG, B)
    _, update_c = cpu.optimizer._make_batched_fused_cem_step(B, per_slot_dyn=("L",))
    u, new, _ = update(st, s, dyn, cost, attrs, seeds)
    u_c, new_c, _ = update_c(state_to_cpu(st), s.cpu(), to_cpu(dyn),
                             to_cpu(cost), to_cpu(attrs), seeds.cpu())
    numbers.update({f"cem_{k}_max_abs_err" if k != "topk_excess" else "cem_topk_excess": v
                    for k, v in errs.items()})
    numbers.update({"cem_same_elite_sets": same_sets,
                    "cem_update_u_abs_err": max_errors(u.cpu(), u_c)[0],
                    "cem_update_mue_max_abs_err": max_errors(new.dist_mue.cpu(),
                                                             new_c.dist_mue)[0]})
    emit("fleet_update_vs_cpu", numbers)
    check(errs["mue"] <= UNOM_ATOL and errs["std"] <= UNOM_ATOL,
          f"the fleet CEM refit on the card differs from the CPU's {numbers}")
    check(not same_sets or (numbers["cem_update_u_abs_err"] <= UNOM_ATOL
                            and numbers["cem_update_mue_max_abs_err"] <= UNOM_ATOL),
          f"the fleet CEM update on the card differs from the CPU's {numbers}")


def fleet_timing(name: str, ctrl: BatchedMPCController, gen, draw=None):
    """Phase 40: FLEET_TIMING_TICKS ticks of every slot (after 5 warm-up)
    from states near upright, the plants left out: host p50/p99, the device
    span, sessions served a second at the host p50, and the host time of
    the slots' draws alone (``draw(generators, mask)``; by default the MPPI
    noise or the fused CEM seeds).  Returns the timed tick, which
    ``--profile`` traces after every timing of the run: a host timed after
    a profiler session reads slower."""
    B, device = ctrl.num_slots, ctrl.device
    s = (0.05 * torch.randn(B, 4, generator=gen, device=device)).cpu().numpy()
    mask = np.ones(B, bool)
    for _ in range(5):
        ctrl.step_batch(s, mask)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host_ms, device_ms = [], []
    for _ in range(FLEET_TIMING_TICKS):
        start.record()
        t0 = time.perf_counter()
        ctrl.step_batch(s, mask)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
    opt, gens = ctrl.optimizer, ctrl.slot_states.generator
    if draw is None:
        draw = (opt.sample_slot_noise if hasattr(opt, "sample_slot_noise")
                else opt.sample_slot_seeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FLEET_TIMING_TICKS):
        draw(gens, mask)
    torch.cuda.synchronize()
    numbers = {"slots": B, "ticks": FLEET_TIMING_TICKS,
               "step_host_p50_ms": float(np.percentile(host_ms, 50)),
               "step_host_p99_ms": float(np.percentile(host_ms, 99)),
               "step_device_p50_ms": float(np.percentile(device_ms, 50)),
               "sessions_per_s": B / (float(np.percentile(host_ms, 50)) / 1e3),
               "slot_draws_host_ms": (time.perf_counter() - t0) * 1e3 / FLEET_TIMING_TICKS,
               "slot_draw_launches": B}
    emit(f"fleet_timing_{name}", numbers)
    return lambda: ctrl.step_batch(s, mask)


# ---- the learned fleets' phases --------------------------------------------------
COLS_KERNELS = {"mlp": (neural_cost_rollout_cols, neural_cost_rollout_cols_plain,
                        neural_cost_rollout),
                "gru": (recurrent_cost_rollout_cols, recurrent_cost_rollout_cols_plain,
                        recurrent_cost_rollout),
                "lstm": (recurrent_cost_rollout_cols, recurrent_cost_rollout_cols_plain,
                         recurrent_cost_rollout),
                "residual": (residual_cost_rollout_cols, residual_cost_rollout_cols_plain,
                             residual_cost_rollout),
                "gp": (gp_cost_rollout_cols, gp_cost_rollout_cols_plain, gp_cost_rollout)}


def cols_operands(kind: str, ctrl: BatchedMPCController, B: int, gen) -> tuple:
    """A session-row kernel's operands over ``ctrl``'s model at B sessions of
    the fleet's K and H: ``(model, s0 [B*K,S], Q [B*K,H,U], pvec_b [B,N],
    weights[, hidden_b])``.  The sessions' rows differ from their
    neighbours': targets and previous controls drawn per session, pole
    lengths over FLEET_L drawn per session ("ODE+res"), and each session's
    hidden (the recurrent nets) drawn N(0, 0.3^2); the GP is
    well_conditioned_gp's."""
    opt, device = ctrl.optimizer, ctrl.device
    K, Hf = opt.num_rollouts, opt.mpc_horizon
    params = ctrl._assemble_params()
    dyn, per_slot = params["dyn"], ()
    if kind == "residual":
        model, _ = residual.residual_model(opt)
        lo, hi = FLEET_L
        dyn, per_slot = dict(dyn["base"], L=lo + (hi - lo) * torch.rand(B, generator=gen,
                                                                        device=device)), ("L",)
        weights = params["dyn"]["res"]
    elif kind == "gp":
        model, _ = gp.gp_model(opt)
        weights = flatten_gp_weights(well_conditioned_gp(dyn["gp"]))
    else:
        model, _ = neural.net_model(opt)
        weights = dyn["net"]
    _, slot_keys = split_slot_keys(model.param_keys, per_slot)
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B, device)(
        2.0 * torch.rand(B, 1, generator=gen, device=device) - 1.0, dyn, params["cost"],
        {"target_position": 0.5 * torch.rand(B, generator=gen, device=device) - 0.25})
    s0 = (0.05 * torch.randn(B, 4, generator=gen, device=device)).repeat_interleave(K, dim=0)
    Q = torch.clamp(0.3 * torch.randn(B * K, Hf, 1, generator=gen, device=device), -1.0, 1.0)
    args = (model, s0, Q, pvec_b, weights)
    if kind in ("gru", "lstm"):
        pred = opt.predictor.predictor
        args += (tuple(0.3 * torch.randn(B, h.shape[-1], generator=gen, device=device)
                       for h in pred.hidden),)
    return args


def first_sessions_k(args: tuple, k: int) -> tuple:
    """``args`` (cols_operands') with each session's first k rollouts."""
    model, s0, Q, pvec_b, *rest = args
    B = pvec_b.shape[0]
    return (model, s0.reshape(B, -1, s0.shape[1])[:, :k].reshape(B * k, -1),
            Q.reshape(B, -1, *Q.shape[1:])[:, :k].reshape(B * k, *Q.shape[1:]), pvec_b, *rest)


def session_args(args: tuple, b: int) -> tuple:
    """Session b's operands for the single-session kernel."""
    model, s0, Q, pvec_b, weights, *hidden = args
    K = s0.shape[0] // pvec_b.shape[0]
    rows = slice(b * K, (b + 1) * K)
    extra = (tuple(h[b:b + 1] for h in hidden[0]),) if hidden else ()
    return (model, s0[rows], Q[rows], pvec_b[b].contiguous(), weights, *extra)


def cols_mutants(kind: str, args: tuple) -> dict:
    """Each session-row form's wrong arithmetic, by its plain version: every
    session reading the next session's row of pvec_b; for the recurrent
    nets every session starting from slot 0's hidden; for "ODE+res" the
    slots' pole lengths rolled by one."""
    model, s0, Q, pvec_b, weights, *hidden = args
    plain = COLS_KERNELS[kind][1]
    out = {"next_session_row": plain(model, s0, Q, pvec_b.roll(-1, 0), weights, *hidden)}
    if hidden:
        out["hidden_of_slot_0"] = plain(model, s0, Q, pvec_b, weights,
                                        tuple(h[:1].expand_as(h).contiguous()
                                              for h in hidden[0]))
    if kind == "residual":
        col = model.param_keys.index("d_L")
        rolled = pvec_b.clone()
        rolled[:, col] = pvec_b[:, col].roll(1)
        out["L_rolled"] = plain(model, s0, Q, rolled, weights)
    return out


def cols_bounds(kind: str, args: tuple, extra_bytes: int = 0) -> dict:
    """The form's bound over its B*K rollouts at the fleet's H (the
    single-session kernel's operation count a rollout-step) and, for the
    tensor-core kernels, the tensor-core bound; ``extra_bytes``: an emit
    form's terminal states."""
    model, s0, Q, pvec_b, weights, *hidden = args
    steps = Q.shape[0] * Q.shape[1]
    n_bytes = (nbytes(s0, Q, pvec_b, *leaves(weights), *leaves(tuple(hidden))) + 4 * Q.shape[0]
               + extra_bytes)
    if kind == "gp":
        return bound(steps * (gp_ops(weights) + STAGE_OPS), n_bytes)
    if kind in ("gru", "lstm"):
        ops = rnn_ops(weights, model.kind)
        scalar = ops - 2 * rnn_macs(weights, model.kind) + STAGE_OPS
        tc = tc_bound_ms(rnn_mma_tiles(weights, model.kind), scalar, steps)
        return {**bound(steps * (ops + STAGE_OPS), n_bytes), "tc_bound_ms": tc}
    base = RK4_STEP_OPS if kind == "residual" else 0
    macs = sum(a * b for a, b in zip(mlp_dims(weights), mlp_dims(weights)[1:]))
    tc = tc_bound_ms(mlp_forward_tiles(weights),
                     base + mlp_ops(weights) - 2 * macs + STAGE_OPS, steps)
    return {**bound(steps * (base + mlp_ops(weights) + STAGE_OPS), n_bytes), "tc_bound_ms": tc}


def cols_resources(kind: str, args: tuple) -> dict:
    """The form's kernel (the single-session kernel's binary): ptxas'
    registers, spills and static shared memory, and the blocks an SM holds."""
    model, *_, weights = args[:5]
    if kind == "gp":
        lanes, threads, blocks = kernels.gp_layout(weights["Zs"].shape[0], grad=False)
        return {**ptxas_resources("gp_cost_rollout_kernel", f"Li{lanes}E"),
                "lanes": lanes, "threads_per_block": threads, "blocks_per_sm": blocks}
    hidden = args[5] if len(args) > 5 else None
    net_args = model.net_args(weights, hidden, args[3].shape[0])[0] if hidden else (
        model.net_args(weights)[0])
    kernel, occupancy, instance = {
        "mlp": ("neural_cost_rollout_kernel", "neural", ""),
        "gru": ("recurrent_cost_rollout_kernel", "recurrent", "Li3E"),
        "lstm": ("recurrent_cost_rollout_kernel", "recurrent", "Li4E"),
        "residual": ("residual_cost_rollout_kernel", "residual", "")}[kind]
    return {**ptxas_resources(kernel, instance),
            "smem_bytes": kernels.net_smem_bytes("cartpole", net_args, occupancy),
            "blocks_per_sm": kernels.net_blocks_per_sm(occupancy, net_args)}


def compare_cols(kind: str, ctrl: BatchedMPCController, gen) -> dict:
    """Phase 41: the session-row form of ``kind``'s kernel against its plain
    version at FLEET_B_MAX sessions of the fleet's K and H, to its
    single-session kernel's bound (NET_TOL; the recurrent nets RNN_TOL); its
    costs equal, session by session, to the single-session kernel's over
    that session's rows (share 1.0); within the bound at
    LEARNED_RAGGED_K rollouts a session; the bound against cols_mutants';
    its time at FLEET_B and FLEET_B_MAX sessions; its bounds and resources."""
    cols, plain, single = COLS_KERNELS[kind]
    tol = RNN_TOL if kind in ("gru", "lstm") else NET_TOL
    args = cols_operands(kind, ctrl, FLEET_B_MAX, gen)
    B, K = args[3].shape[0], ctrl.optimizer.num_rollouts
    ref = plain(*args)
    mutants = cols_mutants(kind, args)
    name = {"mlp": "k11", "gru": "k13_gru", "lstm": "k13_lstm", "residual": "k12",
            "gp": "k14"}[kind] + "_cols"
    numbers = compare(name, lambda: cols(*args), lambda: plain(*args), tol=tol, shape=(B, K),
                      extra=lambda _: {"mutant_max_rel_err": {
                          m: max_errors(v, ref)[1] for m, v in mutants.items()}})
    for m, v in mutants.items():
        check(not torch.allclose(v, ref, **tol),
              f"{name}: the bound does not reject {m} {numbers}")
    got = cols(*args)
    per_session = torch.stack([single(*session_args(args, b)) for b in range(B)])
    ragged = first_sessions_k(args, LEARNED_RAGGED_K)
    rag_got, rag_ref = cols(*ragged), plain(*ragged)
    torch.cuda.synchronize()
    cases = {"single_session_equal_share": float((got == per_session).double().mean()),
             f"K{LEARNED_RAGGED_K}": dict(zip(("max_abs_err", "max_rel_err"),
                                             max_errors(rag_got, rag_ref))),
             "ms_at_b": {str(b): cuda_ms(lambda: cols(*session_slice(args, b)), 50)
                         for b in (FLEET_B, FLEET_B_MAX)},
             **cols_bounds(kind, args), "resources": cols_resources(kind, args)}
    emit(f"{name}_cases", cases)
    check(cases["single_session_equal_share"] == 1.0,
          f"{name}: its costs differ from the single-session kernel's {cases}")
    check(bool(torch.isfinite(rag_got).all()) and torch.allclose(rag_got, rag_ref, **tol),
          f"{name} at K={LEARNED_RAGGED_K}: kernel disagrees {cases}")
    numbers.update({k: cases[k] for k in ("bound_ms", "bound_by")})
    return numbers


def session_slice(args: tuple, b: int) -> tuple:
    """``args`` (cols_operands') for the first b sessions."""
    model, s0, Q, pvec_b, weights, *hidden = args
    n = s0.shape[0] // pvec_b.shape[0] * b
    extra = (tuple(h[:b] for h in hidden[0]),) if hidden else ()
    return (model, s0[:n], Q[:n], pvec_b[:b], weights, *extra)


def fleet_swap(kind: str, ctrl: BatchedMPCController):
    """The mid-loop model change of ``kind``'s fleet, none of which may
    rebuild: new weight tensors (the nets; "ODE+res" a new install beside
    the loop's re-sysid of slot 2), a GP hot-swap of the same posterior."""
    pred = ctrl.optimizer.predictor.predictor

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}

    def swap():
        if kind == "residual":
            pred.set_residual(clone(pred._res))
        elif kind == "gp":
            pred.gp_params = clone(pred.gp_params)
        else:
            pred.net_params = clone(pred.net_params)

    return swap


def learned_fleet_update_vs_cpu(kind: str, ctrl: BatchedMPCController, gen, value=None
                                ) -> None:
    """Phases 43 and 62: one update of ``kind``'s fleet on the card against
    the same update on the CPU (the plain versions), from the state its
    loop left, with the same draws and weights (the GP's well-conditioned;
    ``value``: the learned terminal value the CPU's fleet gets too): costs
    to the kernel's bound, the new plans to UNOM_ATOL."""
    B, opt = ctrl.num_slots, ctrl.optimizer
    s, dyn, cost, attrs = fleet_inputs_now(ctrl, gen)
    if kind == "gp":
        dyn = {"gp": well_conditioned_gp(dyn["gp"])}
    delta = opt.sample_slot_noise(ctrl.slot_states.generator, np.ones(B, bool))
    hidden = (ctrl.slot_hidden,) if ctrl._stateful else ()
    cpu = learned_fleet("cpu", kind, B)
    seen = []  # the CPU's terminal states, where the fleet is valued
    if value is not None:
        attach_value_terminal(cpu, to_cpu(value))
        vt = cpu.cost_function.cost_function
        post = vt.post_terminal_cost

        def recorded(x, cost_params):
            seen.append(x)
            return post(x, cost_params)

        vt.post_terminal_cost = recorded
    builders = {"mlp": "_make_batched_neural_step", "gru": "_make_batched_recurrent_step",
                "lstm": "_make_batched_recurrent_step", "residual": "_make_batched_residual_step",
                "gp": "_make_batched_gp_step"}

    def update_of(o):
        kw = {"per_slot_dyn": ("L",)} if kind == "residual" else {}
        return getattr(o, builders[kind])(B, **kw)[1]

    u_nom, costs = update_of(opt)(ctrl.slot_states, s, dyn, cost, attrs, *hidden, delta)
    u_nom_c, costs_c = update_of(cpu.optimizer)(
        state_to_cpu(ctrl.slot_states), s.cpu(), to_cpu(dyn), to_cpu(cost), to_cpu(attrs),
        *to_cpu(hidden), delta.cpu())
    tol = RNN_TOL if kind in ("gru", "lstm") else NET_TOL
    # A valued fleet's costs also get the x_H bound's reach through V (as
    # update_vs_cpu_cem's), at the CPU's terminal states.
    slack = (value_slack(post, seen[-1], {"cost": to_cpu(cost), "attrs": to_cpu(attrs)},
                         opt.mpc_horizon).reshape(costs_c.shape) if seen else 0.0)
    numbers = {"cost_max_abs_err": max_errors(costs.cpu(), costs_c)[0],
               "u_nom_max_abs_err": max_errors(u_nom.cpu(), u_nom_c)[0],
               "value_slack_max": float(torch.as_tensor(slack).max())}
    emit(f"fleet_{kind}{'_value' if value is not None else ''}_update_vs_cpu", numbers)
    check(bool(((costs.cpu() - costs_c).abs()
                <= tol["atol"] + tol["rtol"] * costs_c.abs() + slack).all())
          and numbers["u_nom_max_abs_err"] <= UNOM_ATOL,
          f"the {kind} fleet's update on the card differs from the CPU's {numbers}")


# ---- the gradient fleets' phases -------------------------------------------------
# Each session-row form: (kernel, plain version, single-session kernel, cost bound).
GRAD_COLS = {"k1": (cost_rollout_cols, cost_rollout_cols_plain, cost_rollout, KERNEL_TOL),
             "k7": (grad_cost_rollout_cols, grad_cost_rollout_cols_plain, grad_cost_rollout,
                    KERNEL_TOL),
             "k8": (neural_grad_cost_rollout_cols, neural_grad_cost_rollout_cols_plain,
                    neural_grad_cost_rollout, NET_TOL),
             "k9": (residual_grad_cost_rollout_cols, residual_grad_cost_rollout_cols_plain,
                    residual_grad_cost_rollout, NET_TOL),
             "k10": (gp_grad_cost_rollout_cols, gp_grad_cost_rollout_cols_plain,
                     gp_grad_cost_rollout, KERNEL_TOL)}
# The fleet each form is taken from and timed at for the kernels line (its
# closed loop's shape).
GRAD_COLS_FLEET = {"k1": "rpgd_ode", "k7": "rpgd_ode", "k8": "rpgd_mlp", "k9": "rpgd_residual",
                   "k10": "rpgd_gp"}


def grad_fleet(device: str, label: str, B: int = 0) -> BatchedMPCController:
    """GRAD_FLEETS' fleet ``label`` of B slots (0: its own number)."""
    optimizer, config, spec, per_slot_dyn, sessions = GRAD_FLEETS[label][:5]
    return fleet_controller(device, optimizer, config, B or sessions, spec, per_slot_dyn)


def grad_cols_operands(form: str, ctrl: BatchedMPCController, B: int, ks: int, gen) -> tuple:
    """A session-row form's operands over ``ctrl``'s model at B sessions of
    ks rollouts and the fleet's H: ``(model, s0 [B*ks,S], Q [B*ks,H,U],
    pvec_b [B,N], *weights)``, the sessions' rows differing from their
    neighbours' (targets and previous controls drawn per session, pole
    lengths over FLEET_L for the ODE and "ODE+res"); the controls as
    phase 2's (K1) or phase 7's (the gradient forms); the GP
    well_conditioned_gp's."""
    opt, device = ctrl.optimizer, ctrl.device
    params = ctrl._assemble_params()
    dyn, per_slot = params["dyn"], ()
    lo, hi = FLEET_L
    L = lo + (hi - lo) * torch.rand(B, generator=gen, device=device)
    if form in ("k1", "k7"):
        model, _ = ode.rollout_model(opt)
        dyn, per_slot, weights = dict(dyn, L=L), ("L",), ()
    elif form == "k8":
        model, _ = neural.net_model(opt)
        weights = (dyn["net"],)
    elif form == "k9":
        model, _ = residual.residual_model(opt)
        dyn, per_slot, weights = dict(dyn["base"], L=L), ("L",), (dyn["res"],)
    else:
        model, _ = gp.gp_model(opt)
        weights = (flatten_gp_weights(well_conditioned_gp(dyn["gp"])),)
    _, slot_keys = split_slot_keys(model.param_keys, per_slot)
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B, device)(
        2.0 * torch.rand(B, 1, generator=gen, device=device) - 1.0, dyn, params["cost"],
        {"target_position": 0.5 * torch.rand(B, generator=gen, device=device) - 0.25})
    s0 = (0.05 * torch.randn(B, 4, generator=gen, device=device)).repeat_interleave(ks, dim=0)
    Hf = opt.mpc_horizon
    if form == "k1":
        Q = torch.clamp(0.3 * torch.randn(B * ks, Hf, 1, generator=gen, device=device), -1.0, 1.0)
    else:
        Q = 2.0 * torch.rand(B * ks, Hf, 1, generator=gen, device=device) - 1.0
    return (model, s0, Q, pvec_b, *weights)


def grad_cols_held(form: str, got, ref) -> bool:
    """Within the form's single-session kernel's bounds: the costs to its
    cost bound, dQ to DQ_RTOL plus DQ_ATOL_FRAC of max|dQ|."""
    tol = GRAD_COLS[form][3]
    if form == "k1":
        return torch.allclose(got, ref, **tol)
    return torch.allclose(got[0], ref[0], **tol) and close(got[1], ref[1], DQ_RTOL, DQ_ATOL_FRAC)


def grad_cols_errors(form: str, got, ref) -> dict:
    if form == "k1":
        return dict(zip(("cost_max_abs_err", "cost_max_rel_err"), max_errors(got, ref)))
    return {**dict(zip(("cost_max_abs_err", "cost_max_rel_err"), max_errors(got[0], ref[0]))),
            "dQ_max_abs_err": max_errors(got[1], ref[1])[0],
            "dQ_max_abs": float(ref[1].abs().max())}


def grad_cols_single(form: str, args: tuple, b: int):
    """Session b's outputs from its single-session kernel over its rows."""
    return GRAD_COLS[form][2](*session_slice_grad(args, b))


def session_slice_grad(args: tuple, b: int) -> tuple:
    """Session b's single-session operands of a session-row form's ``args``
    ``(model, s0, Q, pvec_b, *weights)``."""
    model, s0, Q, pvec_b, *weights = args
    ks = s0.shape[0] // pvec_b.shape[0]
    rows = slice(b * ks, (b + 1) * ks)
    return (model, s0[rows], Q[rows], pvec_b[b].contiguous(), *weights)


def grad_cols_bounds(form: str, args: tuple) -> dict:
    """The form's bound over its B*ks rollouts (the single-session kernel's
    operation count a rollout-step; the bytes each input read once and each
    output written once) and, for K8 and K9, its tensor-core bound."""
    model, s0, Q, pvec_b, *weights = args
    steps = Q.shape[0] * Q.shape[1]
    n_bytes = nbytes(s0, Q, pvec_b, *leaves(tuple(weights))) + 4 * Q.shape[0]
    if form == "k1":
        return bound(steps * (RK4_STEP_OPS + STAGE_OPS), n_bytes)
    n_bytes += nbytes(Q)  # dQ
    stage = STAGE_OPS + STAGE_VJP_OPS
    if form == "k7":
        return bound(steps * (RK4_STEP_OPS + RK4_VJP_OPS + stage), n_bytes)
    if form == "k10":
        return bound(steps * (gp_ops(weights[0]) + gp_vjp_ops(weights[0]) + stage), n_bytes)
    net = weights[0]
    base = RK4_STEP_OPS + RK4_VJP_OPS if form == "k9" else 0
    return {**bound(steps * (base + mlp_ops(net) + mlp_vjp_ops(net) + stage), n_bytes),
            "tc_bound_ms": tc_bound_ms(mma_tiles(net), base + mlp_scalar_ops(net) + stage,
                                       steps)}


def grad_cols_resources(form: str, args: tuple) -> dict:
    """The form's kernel (the single-session kernel's binary): ptxas'
    registers, spills and static shared memory, and the blocks an SM
    holds."""
    model, weights = args[0], args[4] if len(args) > 4 else None
    lib = kernels.load()
    if form == "k1":
        return {**ptxas_resources("cost_rollout_kernel", ROWS_FORM),
                "blocks_per_sm": int(lib.ctt_cost_rollout_blocks_per_sm(1))}
    if form == "k7":
        return {"forward": {**ptxas_resources("grad_cost_forward_kernel", ROWS_FORM),
                            "blocks_per_sm": int(lib.ctt_grad_cost_forward_blocks_per_sm(1))},
                "adjoint": {**ptxas_resources("grad_cost_adjoint_kernel", ROWS_FORM),
                            "blocks_per_sm": int(lib.ctt_grad_cost_adjoint_blocks_per_sm(1))}}
    if form == "k10":
        lanes, threads, blocks = kernels.gp_layout(weights["Zs"].shape[0], grad=True)
        return {**ptxas_resources("gp_grad_cost_rollout_kernel", f"Li{lanes}E"),
                "lanes": lanes, "threads_per_block": threads, "blocks_per_sm": blocks}
    kernel, occupancy = {"k8": ("neural_grad_cost_rollout_kernel", "neural_grad"),
                         "k9": ("residual_grad_cost_rollout_kernel", "residual_grad")}[form]
    net_args = model.net_args(weights)[0]
    return {**ptxas_resources(kernel),
            "smem_bytes": kernels.net_smem_bytes("cartpole", net_args, occupancy),
            "blocks_per_sm": kernels.net_blocks_per_sm(occupancy, net_args)}


def compare_grad_cols(form: str, ctrl: BatchedMPCController, gen) -> dict:
    """Phase 45: the session-row form ``form`` (K1's, K7's, K8's, K9's or
    K10's) against its plain version at GRAD_COLS_B sessions of
    GRAD_COLS_KS rollouts, to its single-session kernel's bounds; its
    outputs equal, session by session, to the single-session kernel's over
    that session's rows (share 1.0); the bounds against every session
    reading the next session's row (the plain version's); its time at each
    of GRAD_COLS_SHAPES and its bounds there; its resources.  The kernels
    line takes its time and its plain version's at the shape of the
    fleet's closed loop."""
    cols, plain = GRAD_COLS[form][:2]
    args = grad_cols_operands(form, ctrl, GRAD_COLS_B, GRAD_COLS_KS, gen)
    got, ref = cols(*args), plain(*args)
    mutant = plain(*args[:3], args[3].roll(-1, 0), *args[4:])
    per_session = [grad_cols_single(form, args, b) for b in range(GRAD_COLS_B)]
    torch.cuda.synchronize()
    if form == "k1":
        same = got == torch.stack(per_session)
        finite = bool(torch.isfinite(got).all())
    else:
        same = torch.cat([(got[0] == torch.stack([c for c, _ in per_session])).flatten(),
                          (got[1] == torch.cat([d for _, d in per_session])).flatten()])
        finite = bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    name = f"{form}_cols"
    label = GRAD_COLS_FLEET[form]
    fleet_b = GRAD_FLEETS[label][4]
    fleet_k = GRAD_FLEETS[label][1]["num_rollouts"]
    timed = {}
    for B, ks in GRAD_COLS_SHAPES:
        targs = grad_cols_operands(form, ctrl, B, ks, gen)
        timed[f"B{B}_K{ks}"] = {"ms": cuda_ms(lambda: cols(*targs), 20),
                                **grad_cols_bounds(form, targs)}
        if (B, ks) == (fleet_b, fleet_k):
            row = {"ms": timed[f"B{B}_K{ks}"]["ms"], "plain_ms": cuda_ms(lambda: plain(*targs), 3),
                   **grad_cols_bounds(form, targs)}
    errors = grad_cols_errors(form, got, ref)
    numbers = {**errors, "finite": finite,
               "max_abs_err": max(v for k, v in errors.items() if k.endswith("max_abs_err")),
               "single_session_equal_share": float(same.double().mean()),
               "mutant_next_session_row": grad_cols_errors(form, mutant, ref),
               "sessions": GRAD_COLS_B, "rollouts_a_session": GRAD_COLS_KS, "timed": timed,
               "resources": grad_cols_resources(form, args), **row}
    emit(name, numbers)
    check(finite, f"{name}: bad output {numbers}")
    check(grad_cols_held(form, got, ref), f"{name}: kernel disagrees with plain {numbers}")
    check(numbers["single_session_equal_share"] == 1.0,
          f"{name}: its outputs differ from the single-session kernel's {numbers}")
    check(not grad_cols_held(form, mutant, ref),
          f"{name}: the bound does not reject the next session's row {numbers}")
    return numbers


def grad_fleet_update_vs_cpu(label: str, ctrl: BatchedMPCController, gen) -> None:
    """Phase 47: one update of the gradient fleet ``label`` on the card and
    on the CPU (the plain versions), from the state its loop left, with
    the same params (the GP's well-conditioned) and draws: RPGD on the keep
    branch for every slot (no draw; the resample surgery is the same torch
    ops on both devices, held to the JAX package's by the tests), gradient-tf
    with the slots' tails.  As phase 10: a row of the B*K whose population
    differs beyond rtol UPDATE_RTOL plus UPDATE_ATOL_FRAC of the largest
    entry must be one whose Adam step the function does not determine (its
    gradient and sqrt(v) within the dQ bound's absolute part of 0), at most
    UNDETERMINED_MAX of them; the costs, moments and controls of every
    other row are held to that bound."""
    B, opt = ctrl.num_slots, ctrl.optimizer
    K, Hf = opt.num_rollouts, opt.mpc_horizon
    s, dyn, cost, attrs = fleet_inputs_now(ctrl, gen)
    if GRAD_FLEETS[label][5] == "gp":
        dyn = {"gp": well_conditioned_gp(dyn["gp"])}
    rpgd = label.startswith("rpgd")
    build = "_make_batched_rpgd_step" if rpgd else "_make_batched_gradient_step"
    psd = GRAD_FLEETS[label][3]
    st = ctrl.slot_states
    draws = [None] * B if rpgd else opt.sample_slot_tails(st.generator, np.ones(B, bool))
    cpu = grad_fleet("cpu", label, B)
    u, new, costs = getattr(opt, build)(B, per_slot_dyn=psd)[1](st, s, dyn, cost, attrs, draws)
    u_c, new_c, costs_c = getattr(cpu.optimizer, build)(B, per_slot_dyn=psd)[1](
        state_to_cpu(st), s.cpu(), to_cpu(dyn), to_cpu(cost), to_cpu(attrs),
        draws if rpgd else draws.cpu())
    gcall, _, pack = cpu.optimizer._bind_batched_grad_kernels(B, per_slot_dyn=psd)
    g_c = gcall(s.cpu()[:, 0].repeat_interleave(K, dim=0), st.Q.cpu().reshape(B * K, Hf, 1),
                pack(st.u_prev.cpu(), to_cpu(dyn), to_cpu(cost), to_cpu(attrs)),
                to_cpu(dyn), to_cpu(cost))[1].reshape(B * K, -1)
    noise = DQ_ATOL_FRAC * float(g_c.abs().max())
    v0 = st.adam.v.cpu().reshape(B * K, -1)
    undetermined = ((g_c.abs() <= noise) & (v0.sqrt() <= noise)).any(1)
    Q_card, Q_cpu = new.Q.cpu().reshape(B * K, -1), new_c.Q.reshape(B * K, -1)
    atol = UPDATE_ATOL_FRAC * float(Q_cpu.abs().max())
    off = ((Q_card - Q_cpu).abs() > atol + UPDATE_RTOL * Q_cpu.abs()).any(1)
    held = ~off
    pairs = {"m": (new.adam.m.cpu().reshape(B * K, -1)[held],
                   new_c.adam.m.reshape(B * K, -1)[held]),
             "v": (new.adam.v.cpu().reshape(B * K, -1)[held],
                   new_c.adam.v.reshape(B * K, -1)[held]),
             "cost": (costs.cpu().reshape(-1)[held], costs_c.reshape(-1)[held])}
    same_best = torch.equal(torch.argmin(costs.cpu(), 1), torch.argmin(costs_c, 1))
    numbers = {"sessions": B, "Q_max_abs_err": max_errors(Q_card, Q_cpu)[0],
               "Q_rows_off": int(off.sum()),
               "Q_rows_off_undetermined": int((off & undetermined).sum()),
               "undetermined_rows": int(undetermined.sum()),
               **{f"{k}_max_abs_err": max_errors(*ab)[0] for k, ab in pairs.items()},
               "same_best": same_best, "u_max_abs_err": max_errors(u.cpu(), u_c)[0]}
    emit(f"fleet_{label}_update_vs_cpu", numbers)
    check(numbers["Q_rows_off"] == numbers["Q_rows_off_undetermined"]
          and numbers["Q_rows_off"] <= UNDETERMINED_MAX * B * K,
          f"{label}: the population on the card differs from the CPU's {numbers}")
    for k, (a, b) in pairs.items():
        check(close(a, b, UPDATE_RTOL, UPDATE_ATOL_FRAC),
              f"{label}: {k} on the card differs from the CPU's {numbers}")
    check(not same_best or close(u.cpu(), u_c, UPDATE_RTOL, UPDATE_ATOL_FRAC),
          f"{label}: u on the card differs from the CPU's {numbers}")


def grad_fleet_draw(ctrl: BatchedMPCController):
    """The slots' draws of a tick, for fleet_timing: RPGD's on a resample
    tick (every slot's), gradient-tf's tails."""
    opt = ctrl.optimizer
    if hasattr(opt, "sample_slot_tails"):
        return opt.sample_slot_tails
    st = ctrl.slot_states
    return lambda gens, mask: opt.sample_slot_resample(
        st._replace(generator=gens, count=np.zeros_like(st.count)), mask)


# ---- the PETS ensemble ------------------------------------------------------------
def member_net(net: dict, e: int) -> dict:
    """Member ``e`` of a stacked ensemble, as a single net."""
    return {k: v[e].contiguous() for k, v in net.items()}


def stacked(nets) -> dict:
    """Single nets of one architecture stacked on a leading member axis."""
    return {k: torch.stack([n[k] for n in nets]).contiguous() for k in nets[0]}


def ens_mutants(net: dict) -> dict:
    """A wrong member-block form's weights: every block reading member 0's
    (``all_member_0``), and each block reading the next member's
    (``next_member``)."""
    E = net["w0"].shape[0]
    return {"all_member_0": stacked([member_net(net, 0)] * E),
            "next_member": {k: v.roll(-1, 0).contiguous() for k, v in net.items()}}


def ens_cases(model, s0, Q, net) -> dict:
    """The member-block forms' further cases, ``(model, s0, Q, net)`` each:
    a ragged K/E (ENS_RAGGED_K rollouts over the net's members), E=1 (member
    0), a seeded ensemble of ENS_MANY mlp-32-32 members with norms, a seeded
    one of the net's E members without norms (weights at scale
    RES_WIDE_SCALE: the committed members' deltas need their norms), and the
    absolute form (predict_delta off) over two members
    (tests/test_pallas_neural.py:215-250's cases)."""
    E = net["w0"].shape[0]
    seeded = stacked([wide_net(True, 1.0, s0.device, (32, 32), WIDE_SEED + e)
                      for e in range(ENS_MANY)])
    bare = stacked([wide_net(False, RES_WIDE_SCALE, s0.device, (32, 32), WIDE_SEED + e)
                    for e in range(E)])
    return {f"K{ENS_RAGGED_K}_E{E}": (model, *first_k(ENS_RAGGED_K, s0, Q), net),
            "E1": (model, s0, Q, stacked([member_net(net, 0)])),
            f"E{ENS_MANY}_seeded_norms": (model, s0, Q, seeded),
            f"E{E}_seeded_no_norms": (model, s0, Q, bare),
            "absolute_E2": (dataclasses.replace(model, predict_delta=False), s0, Q,
                            {k: v[:2].contiguous() for k, v in net.items()})}


def member_blocks_equal(form, single, model, s0, Q, pvec, net) -> list:
    """For each member e: the form's outputs over block e of the K rollouts
    equal, bit for bit, the single-net kernel's over that block under
    member e's net (``form`` and ``single`` return a tensor or a tuple)."""
    E = net["w0"].shape[0]
    per = s0.shape[0] // E
    outs = form(model, s0, Q, pvec, net)
    outs = outs if isinstance(outs, tuple) else (outs,)
    equal = []
    for e in range(E):
        rows = slice(e * per, (e + 1) * per)
        ref = single(model, s0[rows].contiguous(), Q[rows].contiguous(), pvec, member_net(net, e))
        ref = ref if isinstance(ref, tuple) else (ref,)
        equal.append(all(torch.equal(a[rows], b) for a, b in zip(outs, ref)))
    return equal


def ens_bound(model, s0, Q, pvec, net, grad: bool) -> dict:
    """A member-block form's bound: one member's MLP operations a
    rollout-step (an E-member rollout costs one net's), the bytes of its
    operands, and its tensor-core bound (tc_bound_ms) as K11's or K8's."""
    one = member_net(net, 0)
    ops = mlp_ops(one) + STAGE_OPS + (mlp_vjp_ops(one) + STAGE_VJP_OPS if grad else 0)
    macs = sum(a * b for a, b in zip(mlp_dims(one), mlp_dims(one)[1:]))
    tc = (tc_bound_ms(mma_tiles(one), mlp_scalar_ops(one) + STAGE_OPS + STAGE_VJP_OPS) if grad
          else tc_bound_ms(mlp_forward_tiles(one), mlp_ops(one) - 2 * macs + STAGE_OPS))
    return {**bound(K * H * ops, nbytes(s0, Q, pvec, *leaves(net), *((Q,) if grad else ()))
                    + 4 * K), "tc_bound_ms": tc}


def compare_ens(model, s0, Q, pvec, net) -> dict:
    """Phase 49: K11's member-block form against its plain version at the
    main path's shapes; each member's block equal, bit for bit, to K11 over
    that block under the member's net, and E=1 to K11; ens_cases' cases to
    NET_TOL; the cost bound against ens_mutants; its resources beside
    K11's."""
    ref = neural_cost_rollout_ens_plain(model, s0, Q, pvec, net)
    mutants = {name: neural_cost_rollout_ens_plain(model, s0, Q, pvec, m)
               for name, m in ens_mutants(net).items()}
    numbers = compare("k11_ens_neural_cost_rollout",
                      lambda: neural_cost_rollout_ens(model, s0, Q, pvec, net),
                      lambda: neural_cost_rollout_ens_plain(model, s0, Q, pvec, net), tol=NET_TOL,
                      extra=lambda _: {**ens_bound(model, s0, Q, pvec, net, grad=False),
                                       "mutant_max_rel_err": {name: max_errors(m, ref)[1]
                                                              for name, m in mutants.items()}})
    for name, m in mutants.items():
        check(not torch.allclose(m, ref, **NET_TOL),
              f"K11's member-block form: the cost bound does not reject {name} {numbers}")
    equal = member_blocks_equal(neural_cost_rollout_ens, neural_cost_rollout, model, s0, Q, pvec,
                                net)
    m0 = member_net(net, 0)
    e1 = torch.equal(neural_cost_rollout_ens(model, s0, Q, pvec, stacked([m0])),
                     neural_cost_rollout(model, s0, Q, pvec, m0))
    cases = {}
    for case, (mdl, s, q, n) in ens_cases(model, s0, Q, net).items():
        got, want = (neural_cost_rollout_ens(mdl, s, q, pvec, n),
                     neural_cost_rollout_ens_plain(mdl, s, q, pvec, n))
        torch.cuda.synchronize()
        cases[case] = errs = dict(zip(("max_abs_err", "max_rel_err"), max_errors(got, want)))
        check(bool(torch.isfinite(got).all()) and got.shape == (s.shape[0],),
              f"K11's member-block form {case}: bad output {errs}")
        check(torch.allclose(got, want, **NET_TOL),
              f"K11's member-block form {case}: disagrees with plain {errs}")
    args = model.net_args(m0)[0]
    _, group_warps, groups = kernels.neural_plan(model.plant, args)
    out = {"members_equal_to_k11": equal, "E1_equal_to_k11": e1, "cases": cases}
    emit("k11_ens_cases", out)
    check(all(equal) and e1, f"K11's member-block form is not K11 member by member {out}")
    numbers["resources"] = mma_resources(
        "k11_ens_resources", "neural_cost_rollout_ens_kernel", args, "neural_ens",
        numbers["tc_bound_ms"],
        extra={"group_warps": group_warps, "groups_per_block": groups,
               "blocks_per_member": -(-(K // net["w0"].shape[0]) // (16 * groups)),
               "k11_single_net": ptxas_resources("neural_cost_rollout_kernel")})
    return numbers


def grad_rejected(cost, dQ, ref_cost, ref_dQ) -> bool:
    """A K8 output outside the bounds: J beyond NET_TOL or dQ beyond the
    dQ bound."""
    return not (torch.allclose(cost, ref_cost, **NET_TOL)
                and close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC))


def compare_ens_grad(model, s0, Q, pvec, net) -> dict:
    """Phase 50: K8's member-block form against its plain version (autograd
    through K11's member-block plain version), J to NET_TOL and dQ to the
    dQ bound; each member's block equal, bit for bit, to K8 over that block
    under the member's net, and E=1 to K8; ens_cases' cases; the bounds
    against ens_mutants; its resources beside K8's."""
    (cost, dQ), (ref_cost, ref_dQ) = (neural_grad_cost_rollout_ens(model, s0, Q, pvec, net),
                                      neural_grad_cost_rollout_ens_plain(model, s0, Q, pvec, net))
    torch.cuda.synchronize()
    cost_abs, cost_rel = max_errors(cost, ref_cost)
    dq_abs, _ = max_errors(dQ, ref_dQ)
    mutants = {name: neural_grad_cost_rollout_ens_plain(model, s0, Q, pvec, m)
               for name, m in ens_mutants(net).items()}
    numbers = {
        "cost_max_abs_err": cost_abs, "cost_max_rel_err": cost_rel,
        "dQ_max_abs_err": dq_abs, "dQ_max_abs": float(ref_dQ.abs().max()),
        "dQ_atol": DQ_ATOL_FRAC * float(ref_dQ.abs().max()), "dQ_rtol": DQ_RTOL,
        "mutant_max_rel_err": {name: max_errors(c, ref_cost)[1] for name, (c, _) in mutants.items()},
        "mutant_dQ_max_abs_err": {name: max_errors(d, ref_dQ)[0]
                                  for name, (_, d) in mutants.items()},
        "max_abs_err": max(cost_abs, dq_abs),
        "finite": bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()),
        "ms": cuda_ms(lambda: neural_grad_cost_rollout_ens(model, s0, Q, pvec, net), 20),
        "plain_ms": cuda_ms(lambda: neural_grad_cost_rollout_ens_plain(model, s0, Q, pvec, net), 3),
        **ens_bound(model, s0, Q, pvec, net, grad=True),
    }
    emit("k8_ens_neural_grad_cost_rollout", numbers)
    check(numbers["finite"] and cost.shape == (K,) and dQ.shape == Q.shape,
          "K8's member-block form: bad output")
    check(not grad_rejected(cost, dQ, ref_cost, ref_dQ),
          f"K8's member-block form disagrees with plain {numbers}")
    for name, (c, d) in mutants.items():
        check(grad_rejected(c, d, ref_cost, ref_dQ),
              f"K8's member-block form: the bounds do not reject {name} {numbers}")
    equal = member_blocks_equal(neural_grad_cost_rollout_ens, neural_grad_cost_rollout, model,
                                s0, Q, pvec, net)
    m0 = member_net(net, 0)
    e1 = all(torch.equal(a, b) for a, b in zip(
        neural_grad_cost_rollout_ens(model, s0, Q, pvec, stacked([m0])),
        neural_grad_cost_rollout(model, s0, Q, pvec, m0)))
    cases = {}
    for case, (mdl, s, q, n) in ens_cases(model, s0, Q, net).items():
        (c, d), (rc, rd) = (neural_grad_cost_rollout_ens(mdl, s, q, pvec, n),
                            neural_grad_cost_rollout_ens_plain(mdl, s, q, pvec, n))
        torch.cuda.synchronize()
        cases[case] = got = {"cost_max_abs_err": max_errors(c, rc)[0],
                             "dQ_max_abs_err": max_errors(d, rd)[0],
                             "dQ_max_abs": float(rd.abs().max())}
        check(bool(torch.isfinite(c).all() and torch.isfinite(d).all()) and d.shape == q.shape,
              f"K8's member-block form {case}: bad output {got}")
        check(not grad_rejected(c, d, rc, rd), f"K8's member-block form {case}: disagrees {got}")
    out = {"members_equal_to_k8": equal, "E1_equal_to_k8": e1, "cases": cases}
    emit("k8_ens_cases", out)
    check(all(equal) and e1, f"K8's member-block form is not K8 member by member {out}")
    numbers["resources"] = mma_resources(
        "k8_ens_resources", "neural_grad_cost_rollout_ens_kernel", model.net_args(m0)[0],
        "neural_grad_ens", numbers["tc_bound_ms"],
        extra={"k8_single_net": ptxas_resources("neural_grad_cost_rollout_kernel")})
    return numbers


# ---- the learned value terminal's phases -----------------------------------------
def seeded_value(device, seed: int = VALUE_SEED, scale: float = VALUE_SCALE) -> list:
    """A seeded random tanh MLP V of VALUE_DIMS as K7's value_spec operands
    ``[w0, b0, ...]`` with ``scale`` folded into its last layer (weights
    N(0, 1/fan_in), biases N(0, 0.01))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ops = []
    for i, (fi, fo) in enumerate(zip(VALUE_DIMS[:-1], VALUE_DIMS[1:])):
        last = i == len(VALUE_DIMS) - 2
        ops += [torch.randn(fi, fo, generator=gen, device=device) * (fi ** -0.5)
                * (scale if last else 1.0),
                0.1 * torch.randn(fo, generator=gen, device=device) * (scale if last else 1.0)]
    return ops


def value_net_ops(dims=VALUE_DIMS) -> float:
    """FP32 operations of V and its VJP at one state: each layer's product
    twice (forward and transposed, a multiply-add two), its bias, and per
    hidden unit its tanh (1) and tanh' (3: the square, the difference and
    the product)."""
    pairs = list(zip(dims[:-1], dims[1:]))
    return sum(4 * fi * fo + fo for fi, fo in pairs) + 4 * sum(dims[1:-1])


def compare_emit(label: str, emit_fn, unvalued_fn, plain_fn, args: tuple, prev_args: tuple,
                 ragged: tuple, n_bytes: float, ops: float, tol=KERNEL_TOL) -> dict:
    """Phases 54 and 59: an emit_terminal form ``emit_fn(*args) -> (cost,
    x_H)`` against its plain version ``plain_fn`` on the same card tensors:
    its costs equal, bit for bit, to the kernel's ``unvalued_fn(*args)``
    (the same body), to the kernel's bound ``tol`` of its plain version;
    x_H to X_TOL, a bound that must reject x_{H-1} emitted in
    its place (``plain_fn(*prev_args)``'s terminal states: the horizon one
    step shorter) and rollout k+1's x_H, each by VALUE_MARGIN times its
    absolute part; both again at the ``ragged`` operands; its time, the
    kernel's and the plain version's."""
    (cost, x), cost_k = emit_fn(*args), unvalued_fn(*args)
    ref_cost, ref_x = plain_fn(*args)
    x_prev = plain_fn(*prev_args)[1]
    torch.cuda.synchronize()
    rows = ref_x.reshape(-1, ref_x.shape[-1])
    mutants = {"x_H_minus_1": x_prev, "next_rollout_x_H": rows.roll(-1, 0).reshape(ref_x.shape)}
    (rc, rx), (gc, gx) = plain_fn(*ragged), emit_fn(*ragged)
    torch.cuda.synchronize()
    numbers = {
        "costs_equal_to_kernel": bool(torch.equal(cost, cost_k)),
        "cost_max_abs_err": max_errors(cost, ref_cost)[0],
        "x_max_abs_err": max_errors(x, ref_x)[0], "x_max_abs": float(ref_x.abs().max()),
        "x_atol": X_TOL["atol"],
        "mutant_x_max_abs_err": {k: max_errors(m, ref_x)[0] for k, m in mutants.items()},
        "ragged": {"costs": max_errors(gc, rc)[0], "x": max_errors(gx, rx)[0],
                   "equal_to_kernel": bool(torch.equal(gc, unvalued_fn(*ragged)))},
        "finite": bool(torch.isfinite(cost).all() and torch.isfinite(x).all()),
        "ms": cuda_ms(lambda: emit_fn(*args), 50),
        "kernel_ms": cuda_ms(lambda: unvalued_fn(*args), 50),
        "plain_ms": cuda_ms(lambda: plain_fn(*args), 3),
        **bound(ops, n_bytes)}
    numbers["max_abs_err"] = max(numbers["cost_max_abs_err"], numbers["x_max_abs_err"])
    emit(label, numbers)
    check(numbers["finite"] and x.shape == ref_x.shape, f"{label}: bad output")
    check(numbers["costs_equal_to_kernel"] and numbers["ragged"]["equal_to_kernel"],
          f"{label}: its costs are not the kernel's {numbers}")
    for got, ref, xs, xr in ((cost, ref_cost, x, ref_x), (gc, rc, gx, rx)):
        check(torch.allclose(got, ref, **tol) and torch.allclose(xs, xr, **X_TOL),
              f"{label}: disagrees with its plain version {numbers}")
    for k, m in mutants.items():
        check(numbers["mutant_x_max_abs_err"][k] >= VALUE_MARGIN * X_TOL["atol"]
              and not torch.allclose(m, ref_x, **X_TOL),
              f"{label}: the x_H bound does not reject {k} by {VALUE_MARGIN}x {numbers}")
    return numbers


def compare_value_grad(model, s0, Qg, pvec) -> dict:
    """Phase 55: K7's value_spec form against its plain version over
    seeded_value's V: J to KERNEL_TOL, dQ to K7's bound; that bound must
    reject, each by VALUE_MARGIN times its absolute part, dV/dx_H dropped
    from the seed (K7's own dQ), the value scale left out and V added
    without the 1/(H+1) (its last layer times H+1); the same at
    VALUE_RAGGED_K; a second V (VALUE_SWAP_SEED at VALUE_SWAP_SCALE) held
    again with nothing built; the two launches timed apart, the host's
    time to enqueue a call of the form and of K7; resources."""
    Hh = Qg.shape[1]
    ops = seeded_value(s0.device)
    unscaled = seeded_value(s0.device, scale=1.0)
    no_inv = ops[:-2] + [ops[-2] * (Hh + 1), ops[-1] * (Hh + 1)]
    got, ref = grad_cost_rollout_value(model, s0, Qg, pvec, ops), \
        grad_cost_rollout_plain(model, s0, Qg, pvec, ops)
    wrong = {"no_dV_in_seed": grad_cost_rollout_plain(model, s0, Qg, pvec)[1],
             "no_value_scale": grad_cost_rollout_plain(model, s0, Qg, pvec, unscaled)[1],
             "no_inv_h1": grad_cost_rollout_plain(model, s0, Qg, pvec, no_inv)[1]}
    torch.cuda.synchronize()
    atol = DQ_ATOL_FRAC * float(ref[1].abs().max())
    numbers = {"cost_max_abs_err": max_errors(got[0], ref[0])[0],
               "dQ_max_abs_err": max_errors(got[1], ref[1])[0],
               "dQ_max_abs": float(ref[1].abs().max()), "dQ_atol": atol,
               "mutant_dQ_max_abs_err": {k: max_errors(m, ref[1])[0] for k, m in wrong.items()},
               "finite": bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())}
    numbers["max_abs_err"] = max(numbers["cost_max_abs_err"], numbers["dQ_max_abs_err"])
    check(numbers["finite"] and torch.allclose(got[0], ref[0], **KERNEL_TOL)
          and close(got[1], ref[1], DQ_RTOL, DQ_ATOL_FRAC),
          f"K7's value_spec form disagrees with its plain version {numbers}")
    for k, m in wrong.items():
        check(numbers["mutant_dQ_max_abs_err"][k] >= VALUE_MARGIN * atol
              and not close(m, ref[1], DQ_RTOL, DQ_ATOL_FRAC),
              f"K7 value_spec: the dQ bound does not reject {k} by {VALUE_MARGIN}x {numbers}")
    cases = {}
    builds = kernels.build.count
    swap = seeded_value(s0.device, VALUE_SWAP_SEED, VALUE_SWAP_SCALE)
    for case, (s, q, v) in {f"K{VALUE_RAGGED_K}": (*first_k(VALUE_RAGGED_K, s0, Qg), ops),
                            "swapped_V": (s0, Qg, swap)}.items():
        (c, d), (rc, rd) = (grad_cost_rollout_value(model, s, q, pvec, v),
                            grad_cost_rollout_plain(model, s, q, pvec, v))
        torch.cuda.synchronize()
        cases[case] = errs = {"cost_max_abs_err": max_errors(c, rc)[0],
                              "dQ_max_abs_err": max_errors(d, rd)[0],
                              "dQ_max_abs": float(rd.abs().max())}
        check(torch.allclose(c, rc, **KERNEL_TOL) and close(d, rd, DQ_RTOL, DQ_ATOL_FRAC),
              f"K7 value_spec {case}: disagrees {errs}")
    cases["swapped_V"]["moved_dQ"] = max_errors(
        grad_cost_rollout_value(model, s0, Qg, pvec, swap)[1], got[1])[0]
    check(kernels.build.count == builds and cases["swapped_V"]["moved_dQ"] > atol,
          f"K7 value_spec: a V swap rebuilt something or did not reach dQ {cases}")
    K_, S = s0.shape
    cost, dQ = torch.empty(K_, device=s0.device), torch.empty_like(Qg)
    xhist = torch.empty(Hh + 1, S, K_, device=s0.device)
    value = (kernels.value_args(ops, S), torch.empty(S, K_, device=s0.device))
    parts = {part: cuda_ms(lambda: launch_part(part, model, s0, Qg, pvec, cost, dQ, xhist,
                                               value=value), 50)
             for part in ("forward", "adjoint")}
    host = {}
    for label, fn in (("k7", lambda: grad_cost_rollout(model, s0, Qg, pvec)),
                      ("value", lambda: grad_cost_rollout_value(model, s0, Qg, pvec, ops))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        host[label] = (time.perf_counter() - t0) * 1e3 / 50
        torch.cuda.synchronize()
    numbers.update({
        "cases": cases, "part_ms": parts, "host_enqueue_ms": host,
        "ms": cuda_ms(lambda: grad_cost_rollout_value(model, s0, Qg, pvec, ops), 50),
        "k7_ms": cuda_ms(lambda: grad_cost_rollout(model, s0, Qg, pvec), 50),
        "plain_ms": cuda_ms(lambda: grad_cost_rollout_plain(model, s0, Qg, pvec, ops), 3),
        "forward": {**ptxas_resources("grad_cost_forward_value_kernel"),
                    "dynamic_smem_bytes": int(kernels.load().ctt_value_smem_bytes(
                        ctypes.byref(value[0]), S))},
        "adjoint": ptxas_resources("grad_cost_adjoint_value_kernel"),
        **bound(K_ * Hh * (RK4_STEP_OPS + STAGE_OPS + RK4_VJP_OPS + STAGE_VJP_OPS)
                + K_ * value_net_ops(), nbytes(s0, Qg, pvec, Qg, *ops) + 4 * K_)})
    emit("k7_value_grad_cost_rollout", numbers)
    return numbers


def value_swap_rebuilds_nothing(ctrl: MPCController, net: dict, label: str = "value_swap"
                                ) -> None:
    """Phases 57 and 62: a V swap on a valued MPPI controller
    (update_value_params with new weights, then attach_value_terminal again
    with a new scale, which updates the wrapper in place) starts no nvcc
    and rebuilds no step; the same draw's costs (or, where the path logs
    none, its plan) move, and a step runs."""
    opt = ctrl.optimizer
    builds, epoch = kernels.build.count, opt._build_epoch
    s_now = torch.tensor(LEARNED_START[None], device=opt.device)
    state, noise = opt.opt_state, opt.sample_noise(opt.opt_state)
    d0 = opt.update(state, s_now, ctrl._assemble_params(), noise)[2]
    # The costs where the path logs them (semi-fused MPPI), else the plan.
    key = "J_logged" if "J_logged" in d0 else "u_nom"
    update_value_params(ctrl, {k: 0.5 * v for k, v in net.items()})
    vt = attach_value_terminal(ctrl, ctrl._value_holder["params"], VALUE_SWAP_SCALE)
    d1 = opt.update(state, s_now, ctrl._assemble_params(), noise)[2]
    u = ctrl.step(LEARNED_START.copy())
    moved = "J_moved" if key == "J_logged" else "u_nom_moved"
    numbers = {"builds": kernels.build.count - builds, "step_builds": opt._build_epoch - epoch,
               "scale": vt.value_scale, moved: max_errors(d1[key], d0[key])[0],
               "u": [float(v) for v in u]}
    emit(label, numbers)
    check(numbers["builds"] == 0 and numbers["step_builds"] == 0 and numbers[moved] > 0.0,
          f"{label}: a V swap rebuilt something or did not reach the costs {numbers}")


def value_fleet_update_vs_cpu(ctrl: BatchedMPCController, net: dict, gen) -> None:
    """Phase 58: one valued fleet update on the card (K4's emit_terminal
    form, each session's V(x_H)/(H+1) before its softmax) against the same
    update on the CPU, with the same draws: costs to the kernel bound, the
    new plans to UNOM_ATOL."""
    B = ctrl.num_slots
    opt = ctrl.optimizer
    s, dyn, cost, attrs = fleet_inputs_now(ctrl, gen)
    eps = opt.sample_slot_noise(ctrl.slot_states.generator, np.ones(B, bool))
    _, update = opt._make_batched_semi_fused_step(B, per_slot_dyn=("L",))
    cpu = fleet_controller("cpu", "mppi", FLEET_MPPI_CONFIG, B)
    attach_value_terminal(cpu, to_cpu(net))
    _, update_c = cpu.optimizer._make_batched_semi_fused_step(B, per_slot_dyn=("L",))
    st = ctrl.slot_states
    u_nom, costs = update(st, s, dyn, cost, attrs, eps)
    u_nom_c, costs_c = update_c(state_to_cpu(st), s.cpu(), to_cpu(dyn), to_cpu(cost),
                                to_cpu(attrs), eps.cpu())
    numbers = {"cost_max_abs_err": max_errors(costs.cpu(), costs_c)[0],
               "u_nom_max_abs_err": max_errors(u_nom.cpu(), u_nom_c)[0]}
    emit("fleet_value_update_vs_cpu", numbers)
    check(torch.allclose(costs.cpu(), costs_c, **KERNEL_TOL)
          and numbers["u_nom_max_abs_err"] <= UNOM_ATOL,
          f"the valued fleet update on the card differs from the CPU's {numbers}")


# ---- the learned value terminal over the learned dynamics --------------------------
# Each learned emit form's entry and its kernel's, by the label of phase
# 59, with the template instance they share (K13's gates, K14's lanes).
LEARNED_EMIT_ENTRIES = {
    "k11": ("neural_cost_rollout", ""), "k11_ens": ("neural_cost_rollout_ens", ""),
    "k12": ("residual_cost_rollout", ""), "k13_gru": ("recurrent_cost_rollout", "Li3E"),
    "k13_lstm": ("recurrent_cost_rollout", "Li4E"), "k14": ("gp_cost_rollout", "Li4E")}
# The session-row emit forms: the form, its plain version and the
# single-session emit form each session is held to.
COLS_EMIT = {"mlp": (neural_cost_rollout_cols_emit, neural_cost_rollout_cols_emit_plain,
                     neural_cost_rollout_emit),
             "residual": (residual_cost_rollout_cols_emit, residual_cost_rollout_cols_emit_plain,
                          residual_cost_rollout_emit),
             "gp": (gp_cost_rollout_cols_emit, gp_cost_rollout_cols_emit_plain,
                    gp_cost_rollout_emit)}


def compare_learned_emit(label: str, emit_fn, kernel_fn, plain_fn, args: tuple, ragged_k: int,
                         tol: dict, ops: float) -> dict:
    """Phase 59: a learned model's emit_terminal form against its plain
    version at ``args`` ``(model, s0, Q, pvec, weights[, hidden])``, by
    compare_emit (x_{H-1}: the plain version over Q without its last step;
    ragged: the first ``ragged_k`` rollouts), its costs to its kernel's
    bound ``tol``; the bound counts the terminal states' bytes."""
    model, s0, Q, *rest = args
    prev = (model, s0, Q[:, :-1].contiguous(), *rest)
    ragged = (model, *first_k(ragged_k, s0, Q), *rest)
    n_bytes = nbytes(s0, Q, *leaves(tuple(rest))) + 4 * s0.shape[0] * (1 + s0.shape[1])
    return compare_emit(label, emit_fn, kernel_fn, plain_fn, args, prev, ragged, n_bytes, ops,
                        tol)


def learned_emit_resources() -> dict:
    """Phase 59: ptxas' registers and spills of each learned emit entry and
    of its kernel (the unvalued entry over the same body); the emit entry
    may take at most 4 registers more and spill no more."""
    numbers = {label: {"kernel": ptxas_resources(f"{name}_kernel", instance),
                       "emit": ptxas_resources(f"{name}_emit_kernel", instance)}
               for label, (name, instance) in LEARNED_EMIT_ENTRIES.items()}
    emit("learned_emit_resources", numbers)
    for label, n in numbers.items():
        check(n["emit"]["registers"] <= n["kernel"]["registers"] + 4
              and n["emit"]["spill_stores"] <= n["kernel"]["spill_stores"],
              f"{label}: the emit entry takes more registers or spills {n}")
    return numbers


def compare_cols_emit(kind: str, ctrl: BatchedMPCController, gen) -> dict:
    """Phase 60: the session-row emit form of ``kind``'s kernel against its
    plain version at phase 41's operands (FLEET_B_MAX sessions of the
    fleet's K and H): its costs equal, bit for bit, to the session-row
    kernel's, to NET_TOL of the plain version, x_H to X_TOL; each session's
    costs and x_H equal, bit for bit, to the single-session emit form's over
    its rows; the cost bound rejects every session reading the next
    session's row, the x_H bound the next rollout's x_H; timed at FLEET_B
    and FLEET_B_MAX sessions beside the kernel."""
    cols, plain, single = COLS_EMIT[kind]
    kernel = COLS_KERNELS[kind][0]
    args = cols_operands(kind, ctrl, FLEET_B_MAX, gen)
    model, s0, Q, pvec_b, weights = args
    B, S = pvec_b.shape[0], s0.shape[1]
    (cost, x), cost_k = cols(*args), kernel(*args)
    ref_cost, ref_x = plain(*args)
    per = [single(*session_args(args, b)) for b in range(B)]
    wrong_cost = plain(model, s0, Q, pvec_b.roll(-1, 0), weights)[0]
    wrong_x = ref_x.reshape(-1, S).roll(-1, 0).reshape(ref_x.shape)
    torch.cuda.synchronize()
    label = {"mlp": "k11", "residual": "k12", "gp": "k14"}[kind] + "_cols_emit"
    numbers = {
        "costs_equal_to_kernel": bool(torch.equal(cost, cost_k)),
        "single_session_equal_share": float(torch.stack([
            (cost[b] == c).all() & (x[b] == v).all() for b, (c, v) in enumerate(per)]).double()
            .mean()),
        "cost_max_abs_err": max_errors(cost, ref_cost)[0],
        "x_max_abs_err": max_errors(x, ref_x)[0], "x_max_abs": float(ref_x.abs().max()),
        "mutant_cost_max_rel_err": {"next_session_row": max_errors(wrong_cost, ref_cost)[1]},
        "mutant_x_max_abs_err": {"next_rollout_x_H": max_errors(wrong_x, ref_x)[0]},
        "finite": bool(torch.isfinite(cost).all() and torch.isfinite(x).all()),
        "ms_at_b": {str(b): cuda_ms(lambda: cols(*session_slice(args, b)), 50)
                    for b in (FLEET_B, FLEET_B_MAX)},
        "kernel_ms_at_b": {str(b): cuda_ms(lambda: kernel(*session_slice(args, b)), 50)
                           for b in (FLEET_B, FLEET_B_MAX)},
        "plain_ms": cuda_ms(lambda: plain(*args), 3),
        **cols_bounds(kind, args, extra_bytes=4 * s0.shape[0] * S)}
    numbers["ms"] = numbers["ms_at_b"][str(FLEET_B_MAX)]
    numbers["max_abs_err"] = max(numbers["cost_max_abs_err"], numbers["x_max_abs_err"])
    emit(label, numbers)
    check(numbers["finite"] and numbers["costs_equal_to_kernel"]
          and numbers["single_session_equal_share"] == 1.0,
          f"{label}: not the session-row kernel's costs or the single-session form's {numbers}")
    check(torch.allclose(cost, ref_cost, **NET_TOL) and torch.allclose(x, ref_x, **X_TOL),
          f"{label}: disagrees with its plain version {numbers}")
    check(not torch.allclose(wrong_cost, ref_cost, **NET_TOL)
          and numbers["mutant_x_max_abs_err"]["next_rollout_x_H"] >= VALUE_MARGIN * X_TOL["atol"]
          and not torch.allclose(wrong_x, ref_x, **X_TOL),
          f"{label}: a bound does not reject a mutant {numbers}")
    return numbers


# ---- the value terminal in the gradient kernels over the learned dynamics ------------
# Phase 63's single-session value forms by label: (form, plain version,
# the kernel, its entry (the form's is <entry>_value_kernel), cost bound).
VALUE_GRAD = {
    "k8": (neural_grad_cost_rollout_value, neural_grad_cost_rollout_plain,
           neural_grad_cost_rollout, "neural_grad_cost_rollout", NET_TOL),
    "k8_ens": (neural_grad_cost_rollout_ens_value, neural_grad_cost_rollout_ens_value_plain,
               neural_grad_cost_rollout_ens, "neural_grad_cost_rollout_ens", NET_TOL),
    "k9": (residual_grad_cost_rollout_value, residual_grad_cost_rollout_plain,
           residual_grad_cost_rollout, "residual_grad_cost_rollout", NET_TOL),
    "k10": (gp_grad_cost_rollout_value, gp_grad_cost_rollout_plain, gp_grad_cost_rollout,
            "gp_grad_cost_rollout", KERNEL_TOL)}
# Phase 64's session-row forms: (form, plain version, the single-session
# value (emit) form each session is held to, phase 45's unvalued form).
VALUE_COLS = {
    "k7": (grad_cost_rollout_cols_value, grad_cost_rollout_cols_plain, grad_cost_rollout_value),
    "k8": (neural_grad_cost_rollout_cols_value, neural_grad_cost_rollout_cols_plain,
           neural_grad_cost_rollout_value),
    "k9": (residual_grad_cost_rollout_cols_value, residual_grad_cost_rollout_cols_plain,
           residual_grad_cost_rollout_value),
    "k10": (gp_grad_cost_rollout_cols_value, gp_grad_cost_rollout_cols_plain,
            gp_grad_cost_rollout_value),
    "k1": (cost_rollout_cols_emit, cost_rollout_cols_emit_plain, cost_rollout_emit)}
# The valued gradient fleets (phase 65) by GRAD_FLEETS label: the gradient
# form's and the cost form's launch counters.
VALUE_FLEETS = {
    "rpgd_ode": ("grad_cost_rollout_cols_value", "cost_rollout_cols_emit"),
    "gradient_ode": ("grad_cost_rollout_cols_value", "cost_rollout_cols_emit"),
    "rpgd_mlp": ("neural_grad_cost_rollout_cols_value", "neural_cost_rollout_cols_emit"),
    "rpgd_residual": ("residual_grad_cost_rollout_cols_value", "residual_cost_rollout_cols_emit"),
    "rpgd_gp": ("gp_grad_cost_rollout_cols_value", "gp_cost_rollout_cols_emit")}


def value_ops_of(net: dict) -> list:
    """A value net's ``[w0, b0, ...]`` at scale 1 (the committed V's)."""
    n = sum(1 for k in net if k.startswith("w"))
    return [net[f"{c}{i}"].float().contiguous() for i in range(n) for c in "wb"]


def as64(args: tuple) -> tuple:
    """Operands in float64 (tensors, dicts and lists of them)."""
    def f(a):
        if isinstance(a, torch.Tensor):
            return a.double()
        if isinstance(a, dict):
            return {k: f(v) for k, v in a.items()}
        if isinstance(a, list):
            return [f(v) for v in a]
        return a
    return tuple(f(a) for a in args)


def f64_err(got, ref64) -> float:
    return float((got.double() - ref64).abs().max())


def f64_held(got, plain, ref64, unvalued=None) -> dict:
    """gp_vs_float64's criterion: ``got`` no further from ``ref64`` than
    GP_F64_FACTOR times ``plain``'s distance from it, plus 1e-6 of its
    largest entry.  ``unvalued``: the same kernel's, plain version's and
    float64 plain version's outputs without V; where the kernel's own
    arithmetic is further from float64 than the plain version's (K8's
    3xTF32 products against cuBLAS's float32), that ratio scales the
    plain version's distance, which V amplifies alike in both."""
    n = {"f64_max_abs_err": f64_err(got, ref64), "plain_f64_max_abs_err": f64_err(plain, ref64),
         "max_abs": float(ref64.abs().max()), "kernel_ratio": 1.0}
    if unvalued is not None:
        k0, p0 = (f64_err(t, unvalued[2]) for t in unvalued[:2])
        n.update(unvalued_f64_max_abs_err={"kernel": k0, "plain": p0},
                 kernel_ratio=max(1.0, k0 / max(p0, 1e-30)))
    n["bound"] = GP_F64_FACTOR * n["plain_f64_max_abs_err"] * n["kernel_ratio"] \
        + 1e-6 * n["max_abs"]
    n["held"] = n["f64_max_abs_err"] <= n["bound"]
    return n


def value_grad_layout(label: str, args: tuple, ops: list) -> dict:
    """The value form's dynamic shared memory and blocks an SM for the net
    of ``args`` and the value net ``ops``."""
    lib, nbytes_ = kernels.load(), ctypes.c_long(0)
    vargs = kernels.value_args(ops, args[1].shape[1])
    if label == "k10":
        blocks = lib.ctt_gp_grad_value_layout(int(args[4]["Zs"].shape[0]), ctypes.byref(vargs),
                                              ctypes.byref(nbytes_))
    elif label == "k9":
        blocks = lib.ctt_residual_grad_value_layout(ctypes.byref(args[0].net_args(args[4])[0]),
                                                    ctypes.byref(vargs), ctypes.byref(nbytes_))
    else:
        ens = label == "k8_ens"
        net_args = args[0].net_args(args[4], members=args[4]["w0"].shape[0] if ens else 0)[0]
        blocks = lib.ctt_neural_grad_value_layout(ctypes.byref(net_args), ctypes.byref(vargs),
                                                  int(ens), ctypes.byref(nbytes_))
    return {"dynamic_smem_bytes": int(nbytes_.value), "blocks_per_sm": int(blocks)}


def compare_value_learned(label: str, args: tuple, ragged: tuple, committed: list,
                          ops: float, n_bytes: float, extra_nets=()) -> dict:
    """Phase 63: ``label``'s value_spec form against its plain version at
    ``args`` ``(model, s0, Qg, pvec, weights)``: over seededs_value's V
    (scale VALUE_SCALE) J to the kernel's bound and dQ to K7's, a bound that
    must reject, each by VALUE_MARGIN times its absolute part, dV/dx_H
    dropped from the seed, the scale left out and V added without the
    1/(H+1); the same at ``ragged`` and over each of ``extra_nets``' weights;
    over a V whose last layer is zero, the kernel's outputs bit for bit;
    over the committed V (``committed``), J and dQ held to the float64
    plain version (f64_held); times beside the kernel's, the enqueue cost,
    resources."""
    form, plain, kernel, entry, tol = VALUE_GRAD[label]
    dev, Hh = args[1].device, args[2].shape[1]
    ops_v = seeded_value(dev)
    zero = ops_v[:-2] + [torch.zeros_like(ops_v[-2]), torch.zeros_like(ops_v[-1])]
    no_inv = ops_v[:-2] + [ops_v[-2] * (Hh + 1), ops_v[-1] * (Hh + 1)]
    got, ref = form(*args, ops_v), plain(*args, ops_v)
    plain0 = plain(*args, zero)  # the plain version without V
    wrong = {"no_dV_in_seed": plain0[1],
             "no_value_scale": plain(*args, seeded_value(dev, scale=1.0))[1],
             "no_inv_h1": plain(*args, no_inv)[1]}
    zero_got, base = form(*args, zero), kernel(*args)
    got_c, plain_c = form(*args, committed), plain(*args, committed)
    args64 = as64(args)
    ref64, ref64_0 = plain(*args64, as64((committed,))[0]), plain(*args64, as64((zero,))[0])
    cases = {f"K{ragged[1].shape[0]}": ragged}
    cases.update({f"net{i}": (*args[:4], net) for i, net in enumerate(extra_nets)})
    outs = {case: (form(*a, ops_v), plain(*a, ops_v)) for case, a in cases.items()}
    torch.cuda.synchronize()
    atol = DQ_ATOL_FRAC * float(ref[1].abs().max())
    numbers = {"cost_max_abs_err": max_errors(got[0], ref[0])[0],
               "cost_max_rel_err": max_errors(got[0], ref[0])[1],
               "dQ_max_abs_err": max_errors(got[1], ref[1])[0],
               "dQ_max_abs": float(ref[1].abs().max()), "dQ_atol": atol,
               "mutant_dQ_max_abs_err": {k: max_errors(m, ref[1])[0] for k, m in wrong.items()},
               "zero_V_equal_to_kernel": bool(torch.equal(zero_got[0], base[0])
                                              and torch.equal(zero_got[1], base[1])),
               "committed_V": {"cost": f64_held(got_c[0], plain_c[0], ref64[0],
                                                (base[0], plain0[0], ref64_0[0])),
                               "dQ": f64_held(got_c[1], plain_c[1], ref64[1],
                                              (base[1], plain0[1], ref64_0[1])),
                               "kernel_vs_plain_dQ_max_abs_err":
                                   max_errors(got_c[1], plain_c[1])[0]},
               "cases": {case: {"cost_max_abs_err": max_errors(g[0], r[0])[0],
                                "dQ_max_abs_err": max_errors(g[1], r[1])[0],
                                "dQ_max_abs": float(r[1].abs().max())}
                         for case, (g, r) in outs.items()},
               "finite": bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
                              and torch.isfinite(got_c[1]).all())}
    numbers["max_abs_err"] = max(numbers["cost_max_abs_err"], numbers["dQ_max_abs_err"])
    host = {}
    for name, fn in (("kernel", lambda: kernel(*args)), ("value", lambda: form(*args, committed))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host[name] = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
    instance = f"Li{kernels.gp_layout(int(args[4]['Zs'].shape[0]), grad=True)[0]}E" \
        if label == "k10" else ""
    numbers.update({
        "ms": cuda_ms(lambda: form(*args, committed), 20),
        "kernel_ms": cuda_ms(lambda: kernel(*args), 20),
        "plain_ms": cuda_ms(lambda: plain(*args, committed), 3),
        "host_enqueue_ms": host,
        "resources": {"value": {**ptxas_resources(f"{entry}_value_kernel", instance),
                                **value_grad_layout(label, args, committed)},
                      "kernel": ptxas_resources(f"{entry}_kernel", instance)},
        **bound(ops, n_bytes)})
    emit(f"{label}_value_grad_cost_rollout", numbers)
    check(numbers["finite"], f"{label} value: bad output {numbers}")
    check(torch.allclose(got[0], ref[0], **tol) and close(got[1], ref[1], DQ_RTOL, DQ_ATOL_FRAC),
          f"{label} value: disagrees with its plain version {numbers}")
    for case, (g, r) in outs.items():
        check(torch.allclose(g[0], r[0], **tol) and close(g[1], r[1], DQ_RTOL, DQ_ATOL_FRAC),
              f"{label} value {case}: disagrees with its plain version {numbers}")
    for k, m in wrong.items():
        check(numbers["mutant_dQ_max_abs_err"][k] >= VALUE_MARGIN * atol
              and not close(m, ref[1], DQ_RTOL, DQ_ATOL_FRAC),
              f"{label} value: the dQ bound does not reject {k} by {VALUE_MARGIN}x {numbers}")
    check(numbers["zero_V_equal_to_kernel"],
          f"{label} value: a zero V does not give the kernel's outputs {numbers}")
    check(numbers["committed_V"]["cost"]["held"] and numbers["committed_V"]["dQ"]["held"],
          f"{label} value: further from float64 than its plain version allows {numbers}")
    res = numbers["resources"]
    check(res["value"].get("spill_stores", 0) <= res["kernel"].get("spill_stores", 0),
          f"{label} value: the value entry spills {res}")
    return numbers


def compare_value_cols(form: str, ctrl: BatchedMPCController, committed: list, gen) -> dict:
    """Phase 64: the session-row value form ``form`` (K7's, K8's, K9's or
    K10's, over the committed V) or K1's session-row emit form against its
    plain version at GRAD_COLS_B sessions of GRAD_COLS_KS rollouts (phase
    45's operands): J and dQ to the single-session kernel's bounds, or,
    where V's slope lifts the difference past them, to the float64 plain
    version (f64_held; K1: its costs to KERNEL_TOL, x_H to X_TOL); each
    session equal, bit for bit, to the single-session value (emit) form
    over its rows; the cost bound rejects every session reading the next
    session's row, K1's x_H bound x_{H-1} and the next rollout's x_H; timed
    at each of GRAD_COLS_SHAPES beside phase 45's form."""
    cols, plain, single = VALUE_COLS[form]
    args = grad_cols_operands(form, ctrl, GRAD_COLS_B, GRAD_COLS_KS, gen)
    vops = () if form == "k1" else (committed,)
    got, ref = cols(*args, *vops), plain(*args, *vops)
    mutant = plain(*args[:3], args[3].roll(-1, 0), *args[4:], *vops)
    per = [single(*session_slice_grad(args, b), *vops) for b in range(GRAD_COLS_B)]
    numbers = {}
    if form == "k1":
        prev_x = plain(args[0], args[1], args[2][:, :-1].contiguous(), args[3])[1]
        torch.cuda.synchronize()
        (c, x), (rc, rx) = got, ref
        same = torch.cat([(c == torch.stack([p[0] for p in per])).flatten(),
                          (x == torch.stack([p[1] for p in per])).flatten()])
        wrong_x = {"x_H_minus_1": prev_x,
                   "next_rollout_x_H": rx.reshape(-1, 4).roll(-1, 0).reshape(rx.shape)}
        numbers.update({
            "costs_equal_to_kernel": bool(torch.equal(c, cost_rollout_cols(*args))),
            "cost_max_abs_err": max_errors(c, rc)[0], "x_max_abs_err": max_errors(x, rx)[0],
            "mutant_cost_max_rel_err": {"next_session_row": max_errors(mutant[0], rc)[1]},
            "mutant_x_max_abs_err": {k: max_errors(m, rx)[0] for k, m in wrong_x.items()},
            "finite": bool(torch.isfinite(c).all() and torch.isfinite(x).all())})
        numbers["max_abs_err"] = max(numbers["cost_max_abs_err"], numbers["x_max_abs_err"])
        held = torch.allclose(c, rc, **KERNEL_TOL) and torch.allclose(x, rx, **X_TOL)
        rejected = (not torch.allclose(mutant[0], rc, **KERNEL_TOL)
                    and all(numbers["mutant_x_max_abs_err"][k] >= VALUE_MARGIN * X_TOL["atol"]
                            and not torch.allclose(m, rx, **X_TOL) for k, m in wrong_x.items()))
        check(numbers["costs_equal_to_kernel"], f"k1_cols_emit: not K1-cols' costs {numbers}")
    else:
        args64 = as64(args)
        ref64 = plain(*args64, as64((committed,))[0])
        base, plain0, ref64_0 = GRAD_COLS[form][0](*args), plain(*args), plain(*args64)
        torch.cuda.synchronize()
        same = torch.cat([(got[0] == torch.stack([p[0] for p in per])).flatten(),
                          (got[1] == torch.cat([p[1] for p in per])).flatten()])
        numbers.update({**grad_cols_errors(form, got, ref),
                        "mutant_next_session_row": grad_cols_errors(form, mutant, ref),
                        "f64": {"cost": f64_held(got[0], ref[0], ref64[0],
                                                 (base[0], plain0[0], ref64_0[0])),
                                "dQ": f64_held(got[1], ref[1], ref64[1],
                                               (base[1], plain0[1], ref64_0[1]))},
                        "finite": bool(torch.isfinite(got[0]).all()
                                       and torch.isfinite(got[1]).all())})
        numbers["max_abs_err"] = max(numbers["cost_max_abs_err"], numbers["dQ_max_abs_err"])
        numbers["within_kernel_bounds"] = grad_cols_held(form, got, ref)
        held = numbers["within_kernel_bounds"] or (numbers["f64"]["cost"]["held"]
                                                   and numbers["f64"]["dQ"]["held"])
        rejected = not grad_cols_held(form, mutant, ref)
    label = GRAD_COLS_FLEET[form]
    fleet_b, fleet_k = GRAD_FLEETS[label][4], GRAD_FLEETS[label][1]["num_rollouts"]
    unvalued = GRAD_COLS[form][0]
    timed = {}
    for B, ks_ in GRAD_COLS_SHAPES:
        targs = grad_cols_operands(form, ctrl, B, ks_, gen)
        timed[f"B{B}_K{ks_}"] = {"ms": cuda_ms(lambda: cols(*targs, *vops), 20),
                                 "kernel_ms": cuda_ms(lambda: unvalued(*targs), 20),
                                 **grad_cols_bounds(form, targs)}
        if (B, ks_) == (fleet_b, fleet_k):
            row = {"ms": timed[f"B{B}_K{ks_}"]["ms"],
                   "plain_ms": cuda_ms(lambda: plain(*targs, *vops), 3),
                   **grad_cols_bounds(form, targs)}
    numbers.update({"single_session_equal_share": float(same.double().mean()),
                    "sessions": GRAD_COLS_B, "rollouts_a_session": GRAD_COLS_KS,
                    "timed": timed, **row})
    name = "k1_cols_emit" if form == "k1" else f"{form}_cols_value"
    emit(name, numbers)
    check(numbers["finite"] and held, f"{name}: disagrees with its plain version {numbers}")
    check(numbers["single_session_equal_share"] == 1.0,
          f"{name}: a session differs from its single-session form {numbers}")
    check(rejected, f"{name}: a bound does not reject a mutant {numbers}")
    return numbers


def adam_steps_vs_cpu(name: str, grad_card, grad_cpu, score_card, score_cpu, Q: torch.Tensor,
                      adam, opt, iterations: int) -> dict:
    """Phase 66: a valued gradient update's Adam steps on the card against
    the CPU's, step by step from the card's iterate, as phase 34 holds CEM
    outer iteration by outer iteration.  At each step both devices'
    gradients at that Q (``grad_card``, ``grad_cpu``: the value forms and
    their plain versions, whose distance is printed; phase 63 holds it),
    then (a) the card's step (per-rollout clip, Adam, clamp) against the
    CPU's from the same state and the card's gradient: Q and the moments to
    rtol UPDATE_RTOL plus UPDATE_ATOL_FRAC of their largest entry; (b)
    against the CPU's step from its own gradient: a row whose Q differs
    beyond that bound must be one whose step the gradients do not
    determine, an entry and its sqrt(v) within the noise of 0 (the larger
    of DQ_ATOL_FRAC of max|g| and the two gradients' distance: the
    committed V's slope carries the kernels' rounding into dQ), at most
    UNDETERMINED_MAX of the rows a step.  Then the scoring at the card's
    last iterate: ``score_card(Q)`` against ``score_cpu(Q)`` (costs with V,
    and the CPU's x_H, post hook, its params and H for ``value_slack``), the
    costs to KERNEL_TOL plus the slack.  Returns the numbers, emitted under
    ``name``."""
    lr, b1, b2, eps = opt.learning_rate, opt.adam_beta_1, opt.adam_beta_2, opt.adam_epsilon
    low, high = opt.action_low, opt.action_high

    def step_from(state, grad, device_low, device_high, Q_now):
        new, delta = adam_update(state, clip_by_norm(grad, opt.gradmax_clip, axes=(-2, -1)), lr,
                                 b1, b2, eps)
        return new, torch.clamp(Q_now - delta, device_low, device_high)

    steps = []
    for i in range(iterations):
        g, g_c = grad_card(Q), grad_cpu(Q.cpu())
        diff = float((g.cpu() - g_c).abs().max())
        noise = max(DQ_ATOL_FRAC * float(g_c.abs().max()), diff)
        adam_c = AdamState(adam.step, adam.m.cpu(), adam.v.cpu())
        a_d, Q_next = step_from(adam, g, low, high, Q)
        a_g, Q_g = step_from(adam_c, g.cpu(), low.cpu(), high.cpu(), Q.cpu())
        _, Q_c = step_from(adam_c, g_c, low.cpu(), high.cpu(), Q.cpu())
        width = Q_c.shape[-2] * Q_c.shape[-1]
        got = Q_next.cpu().reshape(-1, width)
        glue = {"Q": (got, Q_g.reshape(-1, width)),
                **{k: (getattr(a_d, k).cpu().reshape(-1, width),
                       getattr(a_g, k).reshape(-1, width)) for k in ("m", "v")}}
        rows = Q_c.reshape(-1, width)
        atol = UPDATE_ATOL_FRAC * float(rows.abs().max())
        off = ((got - rows).abs() > atol + UPDATE_RTOL * rows.abs()).any(1)
        undetermined = ((g_c.abs() <= noise) & (adam_c.v.sqrt() <= noise)).reshape(
            -1, width).any(1)
        step = {"grad_max_abs_err": diff, "grad_max_abs": float(g_c.abs().max()),
                "noise": noise,
                **{f"same_grad_{k}_max_abs_err": max_errors(*ab)[0] for k, ab in glue.items()},
                "rows_off": int(off.sum()),
                "rows_off_undetermined": int((off & undetermined).sum()),
                "undetermined_rows": int(undetermined.sum()),
                "Q_max_abs_err": max_errors(got, rows)[0]}
        steps.append(step)
        for k, (a, b) in glue.items():
            check(close(a, b, UPDATE_RTOL, UPDATE_ATOL_FRAC),
                  f"{name}: step {i}: {k} from the same gradient differs on the card {step}")
        check(step["rows_off"] == step["rows_off_undetermined"]
              and step["rows_off"] <= UNDETERMINED_MAX * rows.shape[0],
              f"{name}: step {i}: Q on the card differs from the CPU's {step}")
        Q, adam = Q_next, a_d
    cost, (cost_c, x_c, post, post_params, horizon) = score_card(Q).cpu().reshape(-1), \
        score_cpu(Q.cpu())
    cost_c = cost_c.reshape(-1)
    slack = value_slack(post, x_c.reshape(-1, x_c.shape[-1]), post_params, horizon)
    numbers = {"steps": steps, "cost_max_abs_err": max_errors(cost, cost_c)[0],
               "cost_max_rel_err": max_errors(cost, cost_c)[1],
               "value_slack_max": float(slack.max())}
    emit(name, numbers)
    check(bool(((cost - cost_c).abs() <= KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * cost_c.abs()
                + slack).all()), f"{name}: costs on the card differ from the CPU's {numbers}")
    return numbers


def gradient_value_update_vs_cpu(ctrl: MPCController, name: str, spec: str, config: dict,
                                 value: dict) -> dict:
    """Phase 66: one valued gradient-tf update's Adam steps and scoring on
    the card against the CPU's (adam_steps_vs_cpu), from the card's state
    and params."""
    opt = ctrl.optimizer
    state = opt.opt_state
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    params = ctrl._assemble_params()
    cpu = make_controller("cpu", "gradient-tf", config, spec=spec)
    attach_value_terminal(cpu, to_cpu(value))
    copt, params_c = cpu.optimizer, to_cpu(params)
    s_tiled = s_now.expand(opt.num_rollouts, -1).contiguous()
    s_tiled_c, u_prev_c = s_tiled.cpu(), state.u_prev.cpu()
    grad_d, cost_d = opt._make_grad_and_cost_only()
    grad_c, cost_c = copt._make_grad_and_cost_only()

    def score_cpu(Q):
        x = copt._rollout_and_cost(s_tiled_c, Q, u_prev_c, params_c)[1][:, -1]
        return (cost_c(s_tiled_c, Q, u_prev_c, params_c), x, copt._post_terminal_fn(),
                copt._cost_params(params_c), copt.mpc_horizon)

    return adam_steps_vs_cpu(
        name, lambda Q: grad_d(Q, s_tiled, state.u_prev, params),
        lambda Q: grad_c(Q, s_tiled_c, u_prev_c, params_c),
        lambda Q: cost_d(s_tiled, Q, state.u_prev, params), score_cpu, state.Q, state.adam, opt,
        opt.gradient_steps)


def grad_fleet_value_update_vs_cpu(label: str, ctrl: BatchedMPCController, value: dict,
                                   gen) -> dict:
    """Phase 66: one valued gradient fleet update's Adam steps (one launch
    of the session-row value form each) and its scoring (the session-row
    emit form, V outside) on the card against the CPU's
    (adam_steps_vs_cpu), from the state its loop left, with the same
    params (the GP's well-conditioned)."""
    B, opt = ctrl.num_slots, ctrl.optimizer
    K, Hf = opt.num_rollouts, opt.mpc_horizon
    s, dyn, cost, attrs = fleet_inputs_now(ctrl, gen)
    if GRAD_FLEETS[label][5] == "gp":
        dyn = {"gp": well_conditioned_gp(dyn["gp"])}
    psd = GRAD_FLEETS[label][3]
    cpu = grad_fleet("cpu", label, B)
    attach_value_terminal(cpu, to_cpu(value))
    vt = cpu.optimizer.cost_function.cost_function
    post, seen = vt.post_terminal_cost, []

    def recorded(x, cost_params):
        seen.append(x)
        return post(x, cost_params)

    vt.post_terminal_cost = recorded
    copt = cpu.optimizer
    gcall, ccall, pack = opt._bind_batched_grad_kernels(B, per_slot_dyn=psd)
    gcall_c, ccall_c, pack_c = copt._bind_batched_grad_kernels(B, per_slot_dyn=psd)
    st = ctrl.slot_states
    s0 = s[:, 0].repeat_interleave(K, dim=0)
    s0_c, dyn_c, cost_c, attrs_c = s0.cpu(), to_cpu(dyn), to_cpu(cost), to_cpu(attrs)
    pvec_b, pvec_c = pack(st.u_prev, dyn, cost, attrs), pack_c(st.u_prev.cpu(), dyn_c, cost_c,
                                                                attrs_c)

    def score_cpu(Q):
        costs = ccall_c(s0_c, Q.reshape(B * K, Hf, 1), pvec_c, dyn_c, cost_c)
        return costs, seen[-1], post, {"cost": cost_c, "attrs": attrs_c}, Hf

    its = getattr(opt, "outer_its", None) or opt.gradient_steps
    return adam_steps_vs_cpu(
        f"fleet_{label}_value_update_vs_cpu",
        lambda Q: gcall(s0, Q.reshape(B * K, Hf, 1), pvec_b, dyn, cost)[1].reshape(Q.shape),
        lambda Q: gcall_c(s0_c, Q.reshape(B * K, Hf, 1), pvec_c, dyn_c, cost_c)[1].reshape(
            Q.shape),
        lambda Q: ccall(s0, Q.reshape(B * K, Hf, 1), pvec_b, dyn, cost), score_cpu, st.Q,
        st.adam, opt, its)


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def compare_fast(label: str, fast_fn, plain_fn, exact_fn, tols: tuple, ops: float,
                 n_bytes: float, reps: int = 50) -> dict:
    """A fast entry (the fast plant's instance) against its plain version
    on the same card tensors, output by output to ``tols`` (allclose
    keywords, or "dq" for K7's bound), and against the exact entry on the
    same inputs: its first output non-zero from it and within
    FAST_FROM_EXACT; its, its plain version's and the exact entry's times,
    and its bound."""
    got, ref, ex = as_tuple(fast_fn()), as_tuple(plain_fn()), as_tuple(exact_fn())
    torch.cuda.synchronize()
    errs = [max_errors(g, r)[0] for g, r in zip(got, ref)]
    numbers = {"max_abs_err": max(errs), "max_abs_errs": errs,
               "from_exact_max_abs": [max_errors(g, e)[0] for g, e in zip(got, ex)],
               "from_exact_max_rel": max_errors(got[0], ex[0])[1],
               "finite": all(bool(torch.isfinite(g).all()) for g in got),
               "ms": cuda_ms(fast_fn, reps), "exact_ms": cuda_ms(exact_fn, reps),
               "plain_ms": cuda_ms(plain_fn, 2), **bound(ops, n_bytes)}
    emit(label, numbers)
    check(numbers["finite"] and all(g.shape == r.shape for g, r in zip(got, ref)),
          f"{label}: bad output")
    for g, r, tol in zip(got, ref, tols):
        held = close(g, r, DQ_RTOL, DQ_ATOL_FRAC) if tol == "dq" else torch.allclose(g, r, **tol)
        check(held, f"{label}: the fast entry disagrees with its plain version {numbers}")
    check(numbers["from_exact_max_abs"][0] > 0
          and torch.allclose(got[0], ex[0], **FAST_FROM_EXACT),
          f"{label}: the fast entry is not within FAST_FROM_EXACT of the exact one {numbers}")
    return numbers


def fast_k7_adjoint(fmodel, pvec, Qg, gen) -> dict:
    """Phase 67's K7-fast dQ check: from angles over +-FAST_WIDE_ANGLE (where
    the polynomials' derivatives differ most from cos and -sin), K7-fast's
    dQ within K7's bound of the fast plain adjoint, a bound that must reject
    the adjoint taking the fast values with the exact derivatives; both
    also against the float64 fast plain adjoint."""
    from control_toolkit_tpu_torch.ops.adjoints import cartpole_derivs_vjp

    device = Qg.device
    s0 = 0.05 * torch.randn(K, 4, generator=gen, device=device)
    s0[:, 2] = FAST_WIDE_ANGLE * (2.0 * torch.rand(K, generator=gen, device=device) - 1.0)
    p = fmodel.unpack(pvec)
    one = make_soa_stepper(fmodel.derivs, fmodel.integrator, fmodel.dt, fmodel.intermediate_steps)

    def mutant_vjp(xs, us, pp, lam):
        return cartpole_derivs_vjp(xs, us, pp, lam, sincos_d=lambda th: (
            *fast_sincos(th), th.cos(), th.sin()))

    mutant = plain_grad_loop(
        fmodel, s0, Qg, pvec,
        lambda x, u: torch.stack(one(tuple(x.unbind(1)), tuple(u.unbind(1)), p), dim=1),
        lambda xs, us, lam: integrator_vjp(fmodel.derivs, mutant_vjp, xs, us, p, lam,
                                           fmodel.integrator == "rk4",
                                           fmodel.intermediate_steps, fmodel.dt))[1]
    dQ = grad_cost_rollout(fmodel, s0, Qg, pvec)[1]
    ref = grad_cost_rollout_plain(fmodel, s0, Qg, pvec)[1]
    ref64 = grad_cost_rollout_plain(fmodel, s0.double(), Qg.double(), pvec.double())[1]
    torch.cuda.synchronize()
    numbers = {"dQ_max_abs_err": max_errors(dQ, ref)[0], "dQ_max_abs": float(ref.abs().max()),
               "dQ_atol": DQ_ATOL_FRAC * float(ref.abs().max()),
               "exact_trig_mutant_max_abs_err": max_errors(mutant, ref)[0],
               "f64": {"kernel": f64_err(dQ, ref64), "plain": f64_err(ref, ref64),
                       "exact_trig_mutant": f64_err(mutant, ref64)}}
    emit("k7_fast_adjoint", numbers)
    check(close(dQ, ref, DQ_RTOL, DQ_ATOL_FRAC), f"K7-fast's dQ disagrees with plain {numbers}")
    check(not close(mutant, ref, DQ_RTOL, DQ_ATOL_FRAC),
          f"K7's dQ bound does not reject the exact-trig adjoint {numbers}")
    return numbers


def fast_equal_to_k1(fmodel, pvec, opt, gen) -> dict:
    """Phase 67: K5-fast's costs and K3-fast pass 1's (at cc_weight 0) equal
    to K1-fast's over the controls their regenerations draw again
    (regen_controls and mppi_noise with fast=True, on the card, separate
    torch operations): the fast normals bit for bit; the fast elite
    regeneration a subset of the full one bit for bit."""
    device = pvec.device
    s0 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=device)
    s_tiled = s0.expand(K, -1).contiguous()
    low, high = opt.action_low, opt.action_high
    mue = torch.clamp(0.2 * torch.randn(H, 1, generator=gen, device=device), -1.0, 1.0)
    std = torch.full((H, 1), 0.5, device=device)
    seed2 = torch.tensor([1234567, 0], dtype=torch.int32, device=device)
    got = fused_cem_costs(fmodel, s0, mue, std, pvec, seed2, low, high, K, DEFAULT_TILE_K)
    Q = regen_controls(seed2, torch.arange(K, device=device), mue, std, low, high, K,
                       DEFAULT_TILE_K, fast=True)
    via_k1 = cost_rollout(fmodel, s_tiled, Q, pvec)
    idx = elite_indices(got, CEM_CONFIG["cem_best_k"])
    W = opt.interp.matrix
    u_nom = torch.clamp(0.2 * torch.randn(H, 1, generator=gen, device=device), -1.0, 1.0)
    seed3 = torch.tensor([7654321, 0], dtype=torch.int32, device=device)
    pass1 = fused_mppi_costs(fmodel, s0, u_nom, pvec, seed3, W, low, high, 0.0, opt.R, opt.NU,
                             opt.SQRTRHODTINV, K, DEFAULT_TILE_K)
    eps = mppi_noise(seed3, K, W.shape[0], 1, DEFAULT_TILE_K, fast=True) * opt.SQRTRHODTINV
    controls, _ = mppi_controls_plain(eps, W, u_nom, low, high)
    pass1_k1 = cost_rollout(fmodel, s_tiled, controls, pvec)
    exact_q = regen_controls(seed2, torch.arange(K, device=device), mue, std, low, high, K,
                             DEFAULT_TILE_K, fast=False)
    numbers = {"k5_over_k1_equal_share": float((got == via_k1).double().mean()),
               "k5_over_k1_max_abs_err": max_errors(got, via_k1)[0],
               "k3_pass1_over_k1_equal_share": float((pass1 == pass1_k1).double().mean()),
               "k3_pass1_over_k1_max_abs_err": max_errors(pass1, pass1_k1)[0],
               "elite_regen_exact": bool(torch.equal(regen_controls(
                   seed2, idx, mue, std, low, high, K, DEFAULT_TILE_K, fast=True), Q[idx])),
               "fast_controls_from_exact_max_abs": max_errors(Q, exact_q)[0]}
    emit("fast_equal_to_k1", numbers)
    check(numbers["k5_over_k1_equal_share"] == 1.0 and numbers["k3_pass1_over_k1_equal_share"]
          == 1.0, f"K5-fast or K3-fast pass 1 differs from K1-fast over its controls {numbers}")
    check(numbers["elite_regen_exact"], f"the fast elite regeneration is not exact {numbers}")
    check(0 < numbers["fast_controls_from_exact_max_abs"] < 1e-3,
          f"the fast normals are not near the exact ones {numbers}")
    return numbers


def fast_phases(device, ctrl, model, pvec, s0, Q, Qg, k2_args, rmodel, rpvec, rnet,
                vnet) -> tuple:
    """Phases 67-68 (the fast plant) over the main path's operands: ``ctrl``
    the flagship, ``model`` and ``pvec`` its K1 model and packed
    parameters, ``s0``, ``Q``, ``Qg`` and ``k2_args`` phases 2-7's operands,
    ``rmodel``, ``rpvec`` and ``rnet`` phase 18's residual, ``vnet`` the
    committed value net.  Returns each fast entry's numbers and the fast
    loops' launch counts."""
    opt = ctrl.optimizer
    P = opt.interp.number_of_interpolation_inducing_points
    u_nom = k2_args[2]

    # 67. The fast forms (the ":fast" plant's instance of each ODE entry; the
    # fast normals in K3, K5, K6) against their plain versions at the main
    # path's shapes (the forms at their phases' operands), each against its
    # exact entry on the same inputs; K5-fast and K3-fast pass 1 equal to
    # K1-fast over their controls, the fast elite regeneration exact, and
    # K7-fast's dQ bound against the exact-trig adjoint.
    fctrl = make_controller("cuda", spec=FAST_SPEC)
    fmodel, _ = ode.rollout_model(fctrl.optimizer)
    fres = residual_controller("rpgd-tf", RES_RPGD_CONFIG, RES_FAST_SPEC)
    frmodel, _ = residual.residual_model(fres.optimizer)
    check(fmodel.plant == frmodel.plant == "cartpole_fast" and model.plant == "cartpole",
          "the fast controllers did not take the fast plant")
    fgen = torch.Generator(device=device).manual_seed(SEED + 20)
    vops = seeded_value(device)
    k1_ops = K * H * (RK4_STEP_OPS + STAGE_OPS)
    k2_ops = K * H * (RK4_STEP_OPS + STAGE_OPS + MPPI_EXTRA_OPS)
    k7_ops = K * H * (RK4_STEP_OPS + STAGE_OPS + RK4_VJP_OPS + STAGE_VJP_OPS)
    k12_ops = K * H * (RK4_STEP_OPS + mlp_ops(rnet) + STAGE_OPS)
    k9_ops = k12_ops + K * H * (RK4_VJP_OPS + mlp_vjp_ops(rnet) + STAGE_VJP_OPS)
    cost_b, x_b = 4 * K, 4 * K * 4
    fk2_args = (fmodel,) + k2_args[1:]
    fast_k = {
        "k1": compare_fast("k1_fast", lambda: cost_rollout(fmodel, s0, Q, pvec),
                           lambda: cost_rollout_plain(fmodel, s0, Q, pvec),
                           lambda: cost_rollout(model, s0, Q, pvec), (KERNEL_TOL,), k1_ops,
                           nbytes(s0, Q, pvec) + cost_b),
        "k2": compare_fast("k2_fast", lambda: mppi_cost(*fk2_args),
                           lambda: mppi_cost_plain(*fk2_args), lambda: mppi_cost(*k2_args),
                           (KERNEL_TOL,), k2_ops, nbytes(*k2_args[1:8]) + cost_b),
        "k7": compare_fast("k7_fast", lambda: grad_cost_rollout(fmodel, s0, Qg, pvec),
                           lambda: grad_cost_rollout_plain(fmodel, s0, Qg, pvec),
                           lambda: grad_cost_rollout(model, s0, Qg, pvec), (KERNEL_TOL, "dq"),
                           k7_ops, nbytes(s0, Qg, pvec, Qg) + cost_b),
        "k12": compare_fast("k12_fast", lambda: residual_cost_rollout(frmodel, s0, Q, rpvec, rnet),
                            lambda: residual_cost_rollout_plain(frmodel, s0, Q, rpvec, rnet),
                            lambda: residual_cost_rollout(rmodel, s0, Q, rpvec, rnet), (NET_TOL,),
                            k12_ops, nbytes(s0, Q, rpvec, *leaves(rnet)) + cost_b),
        "k9": compare_fast("k9_fast",
                           lambda: residual_grad_cost_rollout(frmodel, s0, Qg, rpvec, rnet),
                           lambda: residual_grad_cost_rollout_plain(frmodel, s0, Qg, rpvec, rnet),
                           lambda: residual_grad_cost_rollout(rmodel, s0, Qg, rpvec, rnet),
                           (NET_TOL, "dq"), k9_ops,
                           nbytes(s0, Qg, rpvec, *leaves(rnet), Qg) + cost_b, reps=20),
        "k1_emit": compare_fast("k1_emit_fast", lambda: cost_rollout_emit(fmodel, s0, Q, pvec),
                                lambda: cost_rollout_emit_plain(fmodel, s0, Q, pvec),
                                lambda: cost_rollout_emit(model, s0, Q, pvec),
                                (KERNEL_TOL, X_TOL), k1_ops, nbytes(s0, Q, pvec) + cost_b + x_b),
        "k2_emit": compare_fast("k2_emit_fast", lambda: mppi_cost_emit(*fk2_args),
                                lambda: mppi_cost_emit_plain(*fk2_args),
                                lambda: mppi_cost_emit(*k2_args), (KERNEL_TOL, X_TOL), k2_ops,
                                nbytes(*k2_args[1:8]) + cost_b + x_b),
        "k7_value": compare_fast(
            "k7_value_fast", lambda: grad_cost_rollout_value(fmodel, s0, Qg, pvec, vops),
            lambda: grad_cost_rollout_plain(fmodel, s0, Qg, pvec, vops),
            lambda: grad_cost_rollout_value(model, s0, Qg, pvec, vops), (KERNEL_TOL, "dq"),
            k7_ops + K * value_net_ops(), nbytes(s0, Qg, pvec, Qg, *vops) + cost_b),
        "k12_emit": compare_fast(
            "k12_emit_fast", lambda: residual_cost_rollout_emit(frmodel, s0, Q, rpvec, rnet),
            lambda: residual_cost_rollout_emit_plain(frmodel, s0, Q, rpvec, rnet),
            lambda: residual_cost_rollout_emit(rmodel, s0, Q, rpvec, rnet), (NET_TOL, X_TOL),
            k12_ops, nbytes(s0, Q, rpvec, *leaves(rnet)) + cost_b + x_b),
        "k9_value": compare_fast(
            "k9_value_fast",
            lambda: residual_grad_cost_rollout_value(frmodel, s0, Qg, rpvec, rnet, vops),
            lambda: residual_grad_cost_rollout_plain(frmodel, s0, Qg, rpvec, rnet, vops),
            lambda: residual_grad_cost_rollout_value(rmodel, s0, Qg, rpvec, rnet, vops),
            (NET_TOL, "dq"), k9_ops + K * value_net_ops(),
            nbytes(s0, Qg, rpvec, *leaves(rnet), Qg, *vops) + cost_b, reps=20)}
    for kc in RAGGED_K:
        compare_fast(f"k1_fast_ragged_k{kc}", lambda: cost_rollout(fmodel, *first_k(kc, s0, Q), pvec),
                     lambda: cost_rollout_plain(fmodel, *first_k(kc, s0, Q), pvec),
                     lambda: cost_rollout(model, *first_k(kc, s0, Q), pvec), (KERNEL_TOL,),
                     kc * H * (RK4_STEP_OPS + STAGE_OPS), 0.0, reps=5)
    # K3's two passes, K5 (also at a ragged K, one tile of 1,000 rollouts).
    fx0 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=device)
    fseed2 = torch.tensor([7654321, 0], dtype=torch.int32, device=device)
    W, low, high = opt.interp.matrix, opt.action_low, opt.action_high
    k3_tail = (fseed2, W, low, high, opt.cc_weight, opt.R, opt.NU, opt.SQRTRHODTINV, K,
               DEFAULT_TILE_K)
    fast_k["k3a"] = compare_fast(
        "k3_pass1_fast", lambda: fused_mppi_costs(fmodel, fx0, u_nom, pvec, *k3_tail),
        lambda: fused_mppi_costs_plain(fmodel, fx0, u_nom, pvec, *k3_tail),
        lambda: fused_mppi_costs(model, fx0, u_nom, pvec, *k3_tail), (KERNEL_TOL,),
        k2_ops + K * P * (NORMAL_OPS + 1), nbytes(fx0, u_nom, pvec, fseed2, W, low, high) + cost_b)
    fcost = fused_mppi_costs(fmodel, fx0, u_nom, pvec, *k3_tail)
    frho = torch.amin(fcost)
    fred = torch.stack([frho, torch.sum(torch.exp(-(fcost - frho) / opt.LBD))])
    wargs = (fseed2, fcost, fred, P, 1, opt.LBD, K, DEFAULT_TILE_K)
    fast_k["k3b"] = compare_fast(
        "k3_pass2_fast", lambda: fused_mppi_weights(*wargs, fast=True).sum(0),
        lambda: fused_mppi_weights_plain(*wargs, fast=True).sum(0),
        lambda: fused_mppi_weights(*wargs, fast=False).sum(0), (WEIGHTS_TOL,),
        K * (P * (NORMAL_OPS + 2) + WEIGHT_OPS),
        nbytes(fseed2, fcost, fred) + 4 * P * (-(-K // 128)))
    fmue = torch.clamp(0.2 * torch.randn(H, 1, generator=fgen, device=device), -1.0, 1.0)
    fstd = torch.full((H, 1), 0.5, device=device)
    for label, kc, tile in (("k5", K, DEFAULT_TILE_K), ("k5_ragged_k1000", 1000, 1000)):
        a5 = (fx0, fmue, fstd, pvec, fseed2, low, high, kc, tile)
        fast_k[label] = compare_fast(
            f"{label}_fast", lambda: fused_cem_costs(fmodel, *a5),
            lambda: fused_cem_costs_plain(fmodel, *a5), lambda: fused_cem_costs(model, *a5),
            (KERNEL_TOL,), kc * H * (RK4_STEP_OPS + STAGE_OPS + NORMAL_OPS + CEM_CONTROL_OPS),
            nbytes(fx0, fmue, fstd, pvec, fseed2, low, high) + 4 * kc)
    fast_equal_to_k1(fmodel, pvec, opt, fgen)
    fast_k7_adjoint(fmodel, pvec, Qg, fgen)
    # K4, K6 and K4-emit at the fleet's 128 sessions.
    ffleet = fleet_controller("cuda", "mppi", FLEET_MPPI_CONFIG, FLEET_B, FAST_SPEC)
    fopt = ffleet.optimizer
    ffm, fpvec_b, fsb = fleet_operands(fopt, FLEET_B_MAX, fgen)
    efm = dataclasses.replace(ffm, plant="cartpole")
    Bf, Kf, Hf, Pf = FLEET_B_MAX, fopt.num_rollouts, fopt.mpc_horizon, fopt.interp.matrix.shape[0]
    fu_b = torch.clamp(0.2 * torch.randn(Bf, Hf, 1, generator=fgen, device=device), -1.0, 1.0)
    feps_b = fopt.SQRTRHODTINV * torch.randn(Bf, Pf, 1, Kf, generator=fgen, device=device)
    a4 = (fsb, fu_b, fpvec_b, feps_b, fopt.interp.matrix, fopt.action_low, fopt.action_high,
          fopt.cc_weight, fopt.R, fopt.NU)
    k4_ops, k4_b = Bf * Kf * Hf * (RK4_STEP_OPS + STAGE_OPS + MPPI_EXTRA_OPS), nbytes(*a4[:7])
    fast_k["k4"] = compare_fast("k4_fast", lambda: mppi_cost_cols(ffm, *a4),
                                lambda: mppi_cost_cols_plain(ffm, *a4),
                                lambda: mppi_cost_cols(efm, *a4), (KERNEL_TOL,), k4_ops,
                                k4_b + 4 * Bf * Kf)
    fast_k["k4_emit"] = compare_fast("k4_emit_fast", lambda: mppi_cost_cols_emit(ffm, *a4),
                                     lambda: mppi_cost_cols_emit_plain(ffm, *a4),
                                     lambda: mppi_cost_cols_emit(efm, *a4), (KERNEL_TOL, X_TOL),
                                     k4_ops, k4_b + 20 * Bf * Kf)
    fmue_b = torch.clamp(0.2 * torch.randn(Bf, Hf, 1, generator=fgen, device=device), -1.0, 1.0)
    fstd_b = torch.full((Bf, Hf, 1), 0.5, device=device)
    fseed_b = torch.randint(0, 2**31 - 1, (Bf,), generator=fgen, dtype=torch.int32, device=device)
    a6 = (fsb, fmue_b, fstd_b, fpvec_b, fseed_b, low, high, Kf)
    fast_k["k6"] = compare_fast(
        "k6_fast", lambda: fused_cem_cols(ffm, *a6), lambda: fused_cem_cols_plain(ffm, *a6),
        lambda: fused_cem_cols(efm, *a6), (KERNEL_TOL,),
        Bf * Kf * Hf * (RK4_STEP_OPS + STAGE_OPS + NORMAL_OPS + CEM_CONTROL_OPS),
        nbytes(*a6[:7]) + 4 * Bf * Kf)
    fq6 = regen_cols(fseed_b, torch.arange(Kf, device=device).expand(Bf, Kf), fmue_b, fstd_b, low,
                     high, Kf, fast=True)
    k6_regen = {"k1_over_regen_equal_share": float(
        (fused_cem_cols(ffm, *a6) == k1_per_session(ffm, fsb, fq6, fpvec_b)).double().mean())}
    emit("k6_fast_regeneration", k6_regen)
    check(k6_regen["k1_over_regen_equal_share"] == 1.0,
          f"K6-fast differs from K1-fast over regen_cols(fast) {k6_regen}")
    # The session-row forms at phase 45's operands (32 sessions of 100).
    fgrad = fleet_controller("cuda", "rpgd-tf", GRAD_RPGD_CONFIG, FLEET_B, FAST_SPEC)
    fresg = fleet_controller("cuda", "rpgd-tf", GRAD_LEARNED_CONFIG, FLEET_B, RES_FAST_SPEC)
    cols_args = {form: grad_cols_operands(form, c, GRAD_COLS_B, GRAD_COLS_KS, fgen)
                 for form, c in (("k1", fgrad), ("k7", fgrad), ("k9", fresg))}
    cols_exact = {"k1": model, "k7": model, "k9": rmodel}
    step_ops = {"k1": RK4_STEP_OPS + STAGE_OPS,
                "k7": RK4_STEP_OPS + STAGE_OPS + RK4_VJP_OPS + STAGE_VJP_OPS,
                "k12": RK4_STEP_OPS + mlp_ops(rnet) + STAGE_OPS,
                "k9": RK4_STEP_OPS + mlp_ops(rnet) + STAGE_OPS + RK4_VJP_OPS + mlp_vjp_ops(rnet)
                + STAGE_VJP_OPS}
    for label, form, fn, plain, extra, tols in (
            ("k1_cols", "k1", cost_rollout_cols, cost_rollout_cols_plain, (), (KERNEL_TOL,)),
            ("k1_cols_emit", "k1", cost_rollout_cols_emit, cost_rollout_cols_emit_plain, (),
             (KERNEL_TOL, X_TOL)),
            ("k7_cols", "k7", grad_cost_rollout_cols, grad_cost_rollout_cols_plain, (),
             (KERNEL_TOL, "dq")),
            ("k7_cols_value", "k7", grad_cost_rollout_cols_value, grad_cost_rollout_cols_plain,
             (vops,), (KERNEL_TOL, "dq")),
            ("k12_cols", "k9", residual_cost_rollout_cols, residual_cost_rollout_cols_plain, (),
             (NET_TOL,)),
            ("k12_cols_emit", "k9", residual_cost_rollout_cols_emit,
             residual_cost_rollout_cols_emit_plain, (), (NET_TOL, X_TOL)),
            ("k9_cols", "k9", residual_grad_cost_rollout_cols,
             residual_grad_cost_rollout_cols_plain, (), (NET_TOL, "dq")),
            ("k9_cols_value", "k9", residual_grad_cost_rollout_cols_value,
             residual_grad_cost_rollout_cols_plain, (vops,), (NET_TOL, "dq"))):
        fm_, *rest = cols_args[form]
        em_ = cols_exact[form]
        n = rest[0].shape[0]
        ops = n * GRAD_FLEET_H * step_ops[label.split("_")[0]]
        fast_k[label] = compare_fast(
            f"{label}_fast", lambda fn=fn, a=rest, e=extra: fn(fm_, *a, *e),
            lambda plain=plain, a=rest, e=extra: plain(fm_, *a, *e),
            lambda fn=fn, a=rest, e=extra, m=em_: fn(m, *a, *e), tols, ops,
            nbytes(*[t for t in rest if torch.is_tensor(t)]) + 4 * n, reps=20)

    # 68. The fast flagship, 200 ticks from CartpoleEnv(seed=0), and its
    # busy time beside the exact flagship's; short loops of the other fast
    # paths, each counted from 0 (fast_runs: the fast entries' launches).
    fast_runs = {}
    check(fctrl.optimizer._uses_semi_fused(), "the fast flagship is not on K2")
    fast_runs["flagship"] = counted_loop("slice_fast_flagship", fctrl, FAST_TICKS,
                                         {"mppi_cost": FAST_TICKS}, retarget_at=RETARGET_AT)
    update_vs_cpu_mppi("fast_update_vs_cpu", fctrl, FAST_SPEC)
    for name, c in (("mppi_fast", fctrl), ("mppi_exact", ctrl)):
        profile_ticks(name, env_tick(c))
    T = FAST_SHORT_TICKS
    short = {
        "modular": (make_controller("cuda", spec=FAST_SPEC, semi_fused=False),
                    {"cost_rollout": T}),
        "fully_fused": (make_controller("cuda", config=FUSED_MPPI_CONFIG, spec=FAST_SPEC),
                        {"fused_mppi_cost": T, "fused_mppi_weights": T}),
        "cem_fused": (make_controller("cuda", "cem-tf", {**CEM_CONFIG, "fully_fused": True},
                                      spec=FAST_SPEC), {"fused_cem": 2 * T}),
        "cem": (make_controller("cuda", "cem-tf", CEM_CONFIG, spec=FAST_SPEC),
                {"cost_rollout": CEM_CONFIG["cem_outer_it"] * T}),
        "icem": (make_controller("cuda", "icem-tf", ICEM_CONFIG, spec=FAST_SPEC),
                 {"cost_rollout": ICEM_CONFIG["cem_outer_it"] * T}),
        "random_action": (make_controller("cuda", "random-action-tf", RANDOM_CONFIG,
                                          spec=FAST_SPEC), {"cost_rollout": T}),
        "gradient": (make_controller("cuda", "gradient-tf", GRADIENT_CONFIG, spec=FAST_SPEC),
                     {"cost_rollout": T,
                      "grad_cost_rollout": GRADIENT_CONFIG["gradient_steps"] * T}),
        "rpgd": (make_controller("cuda", "rpgd-tf", RPGD_CONFIG, spec=FAST_SPEC),
                 {"cost_rollout": T, "grad_cost_rollout": 2 * T}),
        "res_rpgd": (residual_controller("rpgd-tf", RES_RPGD_CONFIG, RES_FAST_SPEC),
                     {"residual_cost_rollout": T, "residual_grad_cost_rollout": 2 * T}),
        "mppi_value": (make_controller("cuda", spec=FAST_SPEC), {"mppi_cost_emit": T}),
        "rpgd_value": (make_controller("cuda", "rpgd-tf", RPGD_CONFIG, spec=FAST_SPEC),
                       {"cost_rollout_emit": T, "grad_cost_rollout_value": 2 * T}),
        "res_mppi_value": (residual_controller("mppi", RES_MPPI_CONFIG, RES_FAST_SPEC),
                           {"residual_cost_rollout_emit": T}),
        "res_rpgd_value": (residual_controller("rpgd-tf", RES_RPGD_CONFIG, RES_FAST_SPEC),
                           {"residual_cost_rollout_emit": T,
                            "residual_grad_cost_rollout_value": 2 * T})}
    for label, (c, expected) in short.items():
        valued = label.endswith("_value")
        if valued:
            attach_value_terminal(c, vnet)
        fast_runs[label] = counted_loop(f"slice_fast_{label}", c, T, expected,
                                        pole_check=not valued,
                                        start=LEARNED_START if valued else None)
    # Adaptive MPPI over the fast base on the mismatched plant, a sysid fit
    # installed every FAST_FIT_EVERY ticks.
    fadapt = make_controller("cuda", "mppi", RES_MPPI_CONFIG, spec=RES_FAST_SPEC)
    fsysid, ffits = OnlineSysId(fadapt, **SYSID), []

    def fit_tick(t, s_, u_, s_next):
        fsysid.observe(s_, u_, s_next)
        if (t + 1) % FAST_FIT_EVERY == 0:
            ffits.append(fsysid.fit_and_apply(steps=FIT_STEPS))

    fast_runs["adaptive"] = counted_loop("slice_fast_adaptive_mppi_residual", fadapt,
                                         FAST_ADAPT_TICKS,
                                         {"residual_cost_rollout": FAST_ADAPT_TICKS},
                                         env_params=TRUE_PARAMS, on_tick=fit_tick)
    check(sum(int(f["fitted"]) for f in ffits) == FAST_ADAPT_TICKS // FAST_FIT_EVERY,
          f"a sysid fit over the fast base was refused {ffits}")
    # The fast fleets at FLEET_B (the valued ones over the committed V).
    fleets = {
        "mppi": (ffleet, {"mppi_cost_cols": T}),
        "cem": (fleet_controller("cuda", "cem-tf", FLEET_CEM_CONFIG, FLEET_B, FAST_SPEC),
                {"fused_cem_cols": 2 * T}),
        "rpgd_ode": (fgrad, {"grad_cost_rollout_cols": 2 * T, "cost_rollout_cols": T}),
        "res_mppi": (fleet_controller("cuda", "mppi", FLEET_MPPI_CONFIG, FLEET_B, RES_FAST_SPEC),
                     {"residual_cost_rollout_cols": T}),
        "rpgd_residual": (fresg, {"residual_grad_cost_rollout_cols": 2 * T,
                                  "residual_cost_rollout_cols": T}),
        "mppi_value": (fleet_controller("cuda", "mppi", FLEET_MPPI_CONFIG, FLEET_B, FAST_SPEC),
                       {"mppi_cost_cols_emit": T}),
        "rpgd_ode_value": (fleet_controller("cuda", "rpgd-tf", GRAD_RPGD_CONFIG, FLEET_B,
                                            FAST_SPEC),
                           {"grad_cost_rollout_cols_value": 2 * T, "cost_rollout_cols_emit": T}),
        "rpgd_residual_value": (fleet_controller("cuda", "rpgd-tf", GRAD_LEARNED_CONFIG,
                                                 FLEET_B, RES_FAST_SPEC),
                                {"residual_grad_cost_rollout_cols_value": 2 * T,
                                 "residual_cost_rollout_cols_emit": T})}
    for label, (c, expected) in fleets.items():
        valued = label.endswith("_value")
        if valued:
            attach_value_terminal(c, vnet)
        fast_runs[f"fleet_{label}"] = fleet_loop(f"slice_fast_fleet_{label}", c, T, expected,
                                                 retarget_at=T // 2, pole_check=not valued)

    return fast_k, fast_runs


# ---- the rest of the zoo (phases 69-73) -----------------------------------------
# Where each sampling CEM of the zoo starts an update: its first carry and
# the draws its outer iterations take (Bharadhwaj's first draw seeds its
# elites).
ZOO_CARRY = {
    "cem-gmm-tf": lambda opt, st, draws: ({"mue": st.comp_mue, "std": st.comp_std,
                                           "probs": st.mix_probs}, draws),
    "cem-naive-grad-tf": lambda opt, st, draws: ({"mue": st.dist_mue, "std": st.stdev}, draws),
    "cem-grad-bharadhwaj-tf": lambda opt, st, draws: (opt.start(st, draws[0]), draws[1:]),
}


def zoo_update_vs_cpu(name: str, ctrl: MPCController, config: dict, spec: str = "ODE") -> dict:
    """Phase 72, cem-gmm and the gradient CEMs: one update on the card and on
    the CPU (the plain versions) with the same draws, outer iteration by
    outer iteration from the card's carry (``iterate``), as
    update_vs_cpu_cem holds CEM: the costs to the kernel bound (the gradient
    CEMs score populations that the gradient step moved on each device),
    the card's elites a top-k of the CPU's costs within that bound, and,
    where both devices took the same elites in the same order, every
    refit quantity: the components and mixture weights, or the Gaussian, to
    UNOM_ATOL; the Adam moments and the kept elites to UPDATE_RTOL plus
    UPDATE_ATOL_FRAC of their largest entry."""
    opt = ctrl.optimizer
    state = opt.opt_state
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    params = ctrl._assemble_params()
    carry, draws = ZOO_CARRY[name](opt, state, opt.sample_draws(state))
    copt = make_controller("cpu", name, config, spec=spec).optimizer
    s_tiled = s_now.expand(opt.num_rollouts, -1).contiguous()
    best_k, same, errs = opt.cem_best_k, 0, {"cost": 0.0, "topk_excess": 0.0}
    for draw in draws:
        new = opt.iterate(carry, s_tiled, state.u_prev, params, draw)
        new_c = copt.iterate(to_cpu(carry), s_tiled.cpu(), state.u_prev.cpu(), to_cpu(params),
                             to_cpu(draw))
        cost, cost_c = new["cost"].cpu(), new_c["cost"]
        errs["cost"] = max(errs["cost"], max_errors(cost, cost_c)[0])
        check(torch.allclose(cost, cost_c, **KERNEL_TOL), f"{name}: costs differ {errs}")
        idx = new["idx"].cpu()
        kth = torch.sort(cost_c).values[best_k - 1]
        excess = float(cost_c[idx].max() - kth)
        errs["topk_excess"] = max(errs["topk_excess"], excess)
        check(excess <= KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * float(kth.abs()),
              f"{name}: the card's elites are not a top-k of the CPU's costs {errs}")
        if torch.equal(idx, new_c["idx"]):
            same += 1
            for key, v in new.items():
                if key in ("cost", "idx"):
                    continue
                pairs = ([(f"adam_{f}", getattr(v, f), getattr(new_c[key], f)) for f in ("m", "v")]
                         if key == "adam" else [(key, v, new_c[key])])
                for label, a, b in pairs:
                    err = max_errors(a.cpu(), b)[0]
                    errs[label] = max(errs.get(label, 0.0), err)
                    held = (close(a.cpu(), b, UPDATE_RTOL, UPDATE_ATOL_FRAC)
                            if label.startswith("adam") or label == "elite_Q" else err <= UNOM_ATOL)
                    check(held, f"{name}: {label} on the card differs from the CPU {errs}")
        carry = new
    numbers = {"iterations": len(draws), "same_elites_iterations": same,
               **{f"{k}_max_abs_err" if k != "topk_excess" else k: v for k, v in errs.items()}}
    emit(f"{name.replace('-', '_')}_update_vs_cpu", numbers)
    return numbers


def cma_update_vs_cpu(label: str, ctrl: MPCController, config: dict) -> dict:
    """Phase 72, cma-es: one generation on the card against the CPU's from
    the card's state.  cuSOLVER's eigenvectors may differ in sign from
    LAPACK's, so the two devices' samples of the same normals may differ:
    the card's decomposition is held to the CPU's on the sign-free root
    ``B diag(D) B^T`` (to UPDATE_RTOL plus UPDATE_ATOL_FRAC of its largest
    entry); the card's population is scored on both devices (the kernel
    bound) and refit on both from the card's elites, each device with its
    own decomposition, which the refit reads only through C^{-1/2}: mean,
    sigma, C and both paths to the same bound."""
    opt = ctrl.optimizer
    st = opt.opt_state
    K_, H_, U = opt.num_rollouts, opt.mpc_horizon, opt.num_control_inputs
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    params = ctrl._assemble_params()
    copt = make_controller("cpu", "cma-es-tf", config).optimizer
    carry = {"mean": st.mean, "sigma": st.sigma, "C": st.C, "p_sigma": st.p_sigma,
             "p_c": st.p_c, "gen": st.gen}
    eig, eig_c = opt.decompose(st.C), copt.decompose(st.C.cpu())
    numbers = {"diagonal": opt.diag, "sigma": float(st.sigma)}
    if not opt.diag:
        (D, B), (D_c, B_c) = eig, eig_c
        root, root_c = (B @ torch.diag(D) @ B.T).cpu(), B_c @ torch.diag(D_c) @ B_c.T
        numbers["root_max_abs_err"] = max_errors(root, root_c)[0]
        numbers["eigvec_sign_flips"] = int((torch.sum(B.cpu() * B_c, dim=0) < 0).sum())
        check(close(root, root_c, UPDATE_RTOL, UPDATE_ATOL_FRAC),
              f"{label}: the card's decomposition differs from the CPU's {numbers}")
    X = opt.sample(carry, opt.sample_draws(st)[0], eig)
    s_tiled = s_now.expand(K_, -1).contiguous()
    cost = opt._make_cost_only()(s_tiled, X.reshape(K_, H_, U), st.u_prev, params)
    cost_c = copt._make_cost_only()(s_tiled.cpu(), X.cpu().reshape(K_, H_, U), st.u_prev.cpu(),
                                    to_cpu(params))
    numbers["cost_max_abs_err"] = max_errors(cost.cpu(), cost_c)[0]
    check(torch.allclose(cost.cpu(), cost_c, **KERNEL_TOL), f"{label}: costs differ {numbers}")
    idx = elite_indices(cost, opt.mu)
    new = opt.refit(carry, X, idx, eig)
    new_c = copt.refit(to_cpu(carry), X.cpu(), idx.cpu(), eig_c)
    for key in ("mean", "sigma", "C", "p_sigma", "p_c"):
        a, b = new[key].cpu(), new_c[key]
        numbers[f"{key}_max_abs_err"] = max_errors(a.reshape(-1), b.reshape(-1))[0]
        check(close(a, b, UPDATE_RTOL, UPDATE_ATOL_FRAC),
              f"{label}: {key} on the card differs from the CPU {numbers}")
    emit(label, numbers)
    return numbers


def eigh_times(opt) -> dict:
    """CMA-ES's eigendecomposition of its [N, N] covariance (N = H*U) on the
    card: CUDA-event time and host wall time a call (torch.linalg.eigh)."""
    C = opt.opt_state.C
    wall = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.decompose(C)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return {"eigh_ms": cuda_ms(lambda: opt.decompose(C), 20),
            "eigh_wall_p50_ms": float(np.percentile(wall, 50)), "N": int(C.shape[0])}


def var_sigma_bound(opt, raw: torch.Tensor, stdev: torch.Tensor, cost_err: float) -> float:
    """How far a cost error ``cost_err`` (per rollout) moves mppi-var's sigma
    step: each advantage moves by at most 2 cost_err, so the gradient by
    2 cost_err mean_k(sum_p eps^2)/sigma, and sigma by LR times that (the
    norm clip and the clamp move it less); raw ``[..., P, U, K]``."""
    sq = (raw.double().cpu() ** 2).sum(dim=-3).mean(dim=-1)               # [..., U]
    return float((opt.LR * 2.0 * cost_err * sq / stdev.double().cpu()).max()) + 1e-6


def var_update_vs_cpu(ctrl: MPCController, config: dict) -> dict:
    """Phase 72, mppi-var: one update on the card and on the CPU (the plain
    versions) from the card's state with one raw draw: the plan to
    UNOM_ATOL, the costs to the kernel bound, sigma within
    ``var_sigma_bound`` of the CPU's."""
    opt = ctrl.optimizer
    st = opt.opt_state
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    raw = opt.sample_noise(st)
    params = ctrl._assemble_params()
    _, new, diag = opt.update(st, s_now, params, raw)
    copt = make_controller("cpu", "mppi-var-tf", config).optimizer
    cst = MPPIVarState(torch.Generator(), st.u_nom.cpu(), st.u_prev.cpu(), st.stdev.cpu())
    _, new_c, diag_c = copt.update(cst, s_now.cpu(), to_cpu(params), raw.cpu())
    numbers = {"u_nom_max_abs_err": max_errors(new.u_nom.cpu(), new_c.u_nom)[0],
               "cost_max_abs_err": max_errors(diag["J_logged"].cpu(), diag_c["J_logged"])[0],
               "stdev": float(new.stdev.max()), "stdev_abs_err": max_errors(new.stdev.cpu(),
                                                                           new_c.stdev)[0]}
    numbers["stdev_bound"] = var_sigma_bound(opt, raw, st.stdev, numbers["cost_max_abs_err"])
    emit("mppi_var_update_vs_cpu", numbers)
    check(torch.allclose(diag["J_logged"].cpu(), diag_c["J_logged"], **KERNEL_TOL)
          and numbers["u_nom_max_abs_err"] <= UNOM_ATOL
          and numbers["stdev_abs_err"] <= numbers["stdev_bound"],
          f"the mppi-var update on the card differs from the CPU's {numbers}")
    return numbers


def fleet_var_update_vs_cpu(ctrl: BatchedMPCController, gen) -> dict:
    """Phase 72, the mppi-var fleet: one batched update on the card against
    the CPU's (the plain versions) from the loop's state, every slot
    drawing: costs to the kernel bound, the plans to UNOM_ATOL, each
    session's sigma within ``var_sigma_bound``."""
    B, opt = ctrl.num_slots, ctrl.optimizer
    s, dyn, cost, attrs = fleet_inputs_now(ctrl, gen)
    raw = opt._slot_normals(ctrl.slot_states.generator, np.ones(B, bool))
    _, update = opt._make_batched_var_step(B, per_slot_dyn=("L",))
    cpu = fleet_controller("cpu", "mppi-var-tf", FLEET_VAR_CONFIG, B)
    _, update_c = cpu.optimizer._make_batched_var_step(B, per_slot_dyn=("L",))
    st = ctrl.slot_states
    _, new, costs = update(st, s, dyn, cost, attrs, raw)
    _, new_c, costs_c = update_c(state_to_cpu(st), s.cpu(), to_cpu(dyn), to_cpu(cost),
                                 to_cpu(attrs), raw.cpu())
    err = (costs.cpu() - costs_c).abs().amax(dim=1)                       # [B]
    bound = torch.tensor([var_sigma_bound(opt, raw[b], st.stdev[b], float(err[b]))
                          for b in range(B)])
    numbers = {"slots": B, "cost_max_abs_err": float(err.max()),
               "u_nom_max_abs_err": max_errors(new.u_nom.cpu(), new_c.u_nom)[0],
               "stdev_max_abs_err": max_errors(new.stdev.cpu(), new_c.stdev)[0],
               "stdev_min": float(new.stdev.min()), "stdev_max": float(new.stdev.max())}
    emit("fleet_var_update_vs_cpu", numbers)
    check(torch.allclose(costs.cpu(), costs_c, **KERNEL_TOL)
          and numbers["u_nom_max_abs_err"] <= UNOM_ATOL
          and bool(((new.stdev.cpu() - new_c.stdev).abs().amax(dim=1) <= bound).all()),
          f"the mppi-var fleet update on the card differs from the CPU's {numbers}")
    return numbers


def zoo_phases(device, gen, vnet) -> tuple:
    """Phases 69-73: the rest of the sampling and gradient-CEM zoo on
    cartpole.  Returns the ODE loops' launch counts (``runs``), the fast
    loops' (``fast_runs``), the controllers to profile and the fleets'
    timed ticks."""
    runs, fast_runs, T, S = {}, {}, ZOO_TICKS, FAST_SHORT_TICKS
    zoo = {  # label: (optimizer, config, launches a tick, the kernel gate)
        "cem_gmm": ("cem-gmm-tf", GMM_CONFIG, {"cost_rollout": 2}, ode.can_use_cost),
        "cma_es": ("cma-es-tf", CMA_CONFIG, {"cost_rollout": 3}, ode.can_use_cost),
        "cma_es_diagonal": ("cma-es-tf", CMA_DIAG_CONFIG, {"cost_rollout": 3}, ode.can_use_cost),
        "mppi_var": ("mppi-var-tf", VAR_CONFIG, {"mppi_cost": 1},
                     lambda opt: opt._uses_semi_fused()),
        "cem_naive_grad": ("cem-naive-grad-tf", NAIVE_GRAD_CONFIG,
                           {"grad_cost_rollout": 1, "cost_rollout": 1},
                           lambda opt: ode.can_use_grad(opt) and ode.can_use_cost(opt)),
        "cem_grad_bharadhwaj": ("cem-grad-bharadhwaj-tf", BHARADHWAJ_CONFIG,
                                {"grad_cost_rollout": 2, "cost_rollout": 2},
                                lambda opt: ode.can_use_grad(opt) and ode.can_use_cost(opt))}

    # 69. Each over the ODE, ZOO_TICKS, counted from 0 (the fused loop and
    # autograd are excluded by the gate and by the counts).
    ctrls = {}
    for label, (name, config, per_tick, gate) in zoo.items():
        c = ctrls[label] = make_controller("cuda", name, config)
        check(gate(c.optimizer) and ode.rollout_model(c.optimizer)[0].plant == "cartpole",
              f"{label}: the controller did not take the kernel path")
        runs[label] = counted_loop(f"slice_{label}", c, T, {k: n * T for k, n in per_tick.items()})
    emit("cma_es_eigh", {**eigh_times(ctrls["cma_es"].optimizer),
                         "eighs_a_tick": CMA_CONFIG["cma_outer_it"]})

    # 70. Each over the fast plant, FAST_SHORT_TICKS; Bharadhwaj over the
    # committed MLP (K8 and K11), MLP_ZOO_TICKS from LEARNED_START.
    for label, (name, config, per_tick, gate) in zoo.items():
        if label == "cma_es_diagonal":
            continue
        c = make_controller("cuda", name, config, spec=FAST_SPEC)
        check(gate(c.optimizer) and ode.rollout_model(c.optimizer)[0].plant == "cartpole_fast",
              f"{label}: the fast controller did not take the fast kernel path")
        fast_runs[f"zoo_{label}"] = counted_loop(f"slice_fast_{label}", c, S,
                                                 {k: n * S for k, n in per_tick.items()})
    mlp = ctrls["cem_grad_bharadhwaj_mlp"] = make_controller(
        "cuda", "cem-grad-bharadhwaj-tf", BHARADHWAJ_CONFIG, spec=MLP_SPEC)
    check(neural.can_use_grad(mlp.optimizer) and neural.can_use_cost(mlp.optimizer),
          "Bharadhwaj over the MLP did not take K8 and K11")
    runs["cem_grad_bharadhwaj_mlp"] = counted_loop(
        "slice_cem_grad_bharadhwaj_mlp", mlp, MLP_ZOO_TICKS,
        {"neural_grad_cost_rollout": 2 * MLP_ZOO_TICKS, "neural_cost_rollout": 2 * MLP_ZOO_TICKS},
        pole_check=False, start=LEARNED_START)

    # 71. The mppi-var fleet: FLEET_B_MAX sessions, every slot active; a
    # valued one at FLEET_B over the committed V (a rotating quarter idle).
    vfleet = fleet_controller("cuda", "mppi-var-tf", FLEET_VAR_CONFIG, FLEET_B_MAX)
    check(vfleet._batched_var_eligible(), "the mppi-var fleet did not take K4")
    runs["fleet_mppi_var"] = fleet_loop("slice_fleet_mppi_var", vfleet, VAR_FLEET_TICKS,
                                        {"mppi_cost_cols": VAR_FLEET_TICKS},
                                        pole_check=False, rotate_idle=False)
    valued = fleet_controller("cuda", "mppi-var-tf", FLEET_VAR_CONFIG, FLEET_B)
    attach_value_terminal(valued, vnet)
    check(valued._batched_var_eligible(), "the valued mppi-var fleet did not take K4's emit form")
    runs["fleet_mppi_var_value"] = fleet_loop("slice_fleet_mppi_var_value", valued,
                                              VAR_FLEET_TICKS,
                                              {"mppi_cost_cols_emit": VAR_FLEET_TICKS},
                                              pole_check=False)

    # 72. One update of each on the card against the CPU's, with the same
    # draws (cma-es on the sign-free quantities).
    for label in ("cem_gmm", "cem_naive_grad", "cem_grad_bharadhwaj"):
        name, config, _, _ = zoo[label]
        zoo_update_vs_cpu(name, ctrls[label], config)
    for label, config in (("cma_es", CMA_CONFIG), ("cma_es_diagonal", CMA_DIAG_CONFIG)):
        cma_update_vs_cpu(f"{label}_update_vs_cpu", ctrls[label], config)
    var_update_vs_cpu(ctrls["mppi_var"], VAR_CONFIG)
    fleet_var_update_vs_cpu(vfleet, gen)

    # 73. The mppi-var fleet timed at FLEET_B and FLEET_B_MAX sessions.
    ticks = {}
    for B in (FLEET_B, FLEET_B_MAX):
        c = fleet_controller("cuda", "mppi-var-tf", FLEET_VAR_CONFIG, B)
        ticks[f"fleet_mppi_var_b{B}"] = fleet_timing(f"mppi_var_b{B}", c, gen,
                                                    draw=c.optimizer._slot_normals)
    return runs, fast_runs, ctrls, ticks

def plant_controller(plant: str, optimizer: str, config: dict, spec: str = None,
                     attrs: dict = None) -> MPCController:
    """An ``mpc`` controller on the card over a PLANT_CASES plant (its
    environment, cost and predictor, ``spec`` in place of the predictor),
    the point mass under ``attrs`` (PM_ATTRS)."""
    env, cost, pred = PLANT_CASES[plant]
    U = 2 if env == "pointmass" else 1
    ctrl = MPCController(env, (-np.ones(U, np.float32), np.ones(U, np.float32)),
                         dict(attrs if attrs is not None else
                              (PM_ATTRS if env == "pointmass" else {})),
                         config={"optimizer": optimizer, "controller_logging": False,
                                 "device": "cuda", "cost_function_specification": cost})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec or pred,
                   optimizer_config=dict(config), cost_function_config={})
    return ctrl


def plant_states(plant: str, k: int, gen) -> torch.Tensor:
    """Seeded start states on the card: the pendulum around hanging, the
    acrobot around rest, the point mass over the obstacles' margins."""
    env, dev = PLANT_CASES[plant][0], gen.device
    if env == "pendulum":
        return torch.stack([math.pi + 0.8 * torch.randn(k, generator=gen, device=dev),
                            2.0 * torch.randn(k, generator=gen, device=dev)], 1)
    if env == "acrobot":
        return 0.6 * torch.randn(k, 4, generator=gen, device=dev)
    return torch.cat([1.2 * torch.rand(k, 2, generator=gen, device=dev) - 0.6,
                      torch.randn(k, 2, generator=gen, device=dev)], 1)


def plant_mutants(plant: str, model, pvec) -> dict:
    """The plant's named wrong variant as ``(model, pvec, swap)``: a plain
    version over it must fall outside the kernel's bound.  ``swap``
    exchanges the controls' columns (the point mass's two inputs)."""
    base = PLANT_CASES[plant][0]
    if plant == "pointmass":
        return {"controls_swapped": (model, pvec, True)}
    if plant == "pointmass_obstacles":
        p = dict(model.unpack(pvec))
        p["a_obs0_r"], p["a_obs0_x"] = torch.zeros_like(p["a_obs0_r"]), p["a_obs0_x"] + 1e6
        return {"obstacle_dropped": (model, torch.stack([p[k] for k in model.param_keys]),
                                     False)}
    if base == "acrobot":
        exact_sin = fast_sin if plant.endswith("_fast") else torch.sin
        sincos = fast_sincos if plant.endswith("_fast") else (lambda a: (a.sin(), a.cos()))

        def derivs(xs, us, p):
            calls = [0]

            def sin(a):  # phi2's sin(t1 + t2), the first call, read as sin(t1)
                calls[0] += 1
                return exact_sin(xs[0]) if calls[0] == 1 else exact_sin(a)

            return _acrobot_derivs(xs, us, {k[2:]: v for k, v in p.items()
                                            if k.startswith("d_")}, sin, sincos)

        return {"sin_t1_for_sin_t1_plus_t2": (dataclasses.replace(model, derivs=derivs), pvec,
                                              False)}

    def stage(xs, us, prev_us, p):  # the energy error without its offset m g L
        angle, angle_d = xs
        m, L, g = p["c_m"], p["c_L"], p["c_g"]
        energy = 0.5 * m * L**2 * angle_d**2 + m * g * L * torch.cos(angle)
        return (model.stage(xs, us, prev_us, p)
                + p["c_energy_weight"] * (energy**2 - (energy - m * g * L) ** 2))

    return {"energy_offset_dropped": (dataclasses.replace(model, stage=stage), pvec, False)}


def plant_resources(plant: str) -> dict:
    """ptxas' registers, spills and static shared memory of the plant's
    instance of K1, K2, K3's pass 1 and K7's two launches, and the blocks an
    SM holds of each."""
    lib, pid = kernels.load(), kernels.PLANT_IDS[plant]
    name = "".join(w.capitalize() for w in plant.replace("obstacles", "obstacle").split("_"))
    inst = f"{len(name) + 5}{name}Plant"
    fast = int(plant.endswith("_fast"))
    return {
        "k1": {**ptxas_resources("cost_rollout_kernel", inst + "E" + SINGLE),
               "blocks_per_sm": int(lib.ctt_cost_rollout_plant_blocks_per_sm(pid))},
        "k2": {**ptxas_resources("mppi_cost_kernel", inst + "EEEv"),
               "blocks_per_sm": int(lib.ctt_mppi_cost_plant_blocks_per_sm(pid))},
        "k3": {**ptxas_resources("fused_mppi_cost_kernel", inst + "EEEv"),
               "blocks_per_sm": int(lib.ctt_fused_mppi_cost_plant_blocks_per_sm(pid, fast))},
        "k7_forward": {**ptxas_resources("grad_cost_forward_kernel", inst + "E" + SINGLE),
                       "blocks_per_sm": int(lib.ctt_grad_cost_plant_blocks_per_sm(pid, 0))},
        "k7_adjoint": {**ptxas_resources("grad_cost_adjoint_kernel", inst + "E" + SINGLE),
                       "blocks_per_sm": int(lib.ctt_grad_cost_plant_blocks_per_sm(pid, 1))},
        **({"k3_fast_normals": {
            **ptxas_resources("fused_mppi_cost_kernel",
                              f"{len(name) + 16}{name}FastNormalsPlantEEEv"),
            "blocks_per_sm": int(lib.ctt_fused_mppi_cost_plant_blocks_per_sm(pid, 1))}}
           if plant in kernels.EXACT_IS_FAST else {}),
    }


def rejects(label: str, got: torch.Tensor, wrong: dict) -> dict:
    """Each wrong variant's largest distance from the kernel's output,
    which the kernel's bound (KERNEL_TOL) must reject."""
    out = {}
    for name, ref in wrong.items():
        out[name] = max_errors(got, ref)[0]
        check(not torch.allclose(got, ref, **KERNEL_TOL),
              f"{label}: the bound does not reject {name} ({out[name]})")
    return out


def plant_grad_mutants(plant: str, model, s0, Q, pvec) -> dict:
    """K7's wrong dQ: for the point mass, the plain version with the
    dynamics' du[1] dropped (the adjoint's second control column)."""
    if not plant.startswith("pointmass"):
        return {}
    p, dvjp = model.unpack(pvec), PLANT_ADJOINTS[plant][0]
    one_step = make_soa_stepper(model.derivs, model.integrator, model.dt,
                                model.intermediate_steps)

    def dropped(xs, us, pp, lam):
        dx, du = dvjp(xs, us, pp, lam)
        return dx, (du[0], torch.zeros_like(du[1]))

    def step(x, u):
        return torch.stack(one_step(tuple(x.unbind(1)), tuple(u.unbind(1)), p), dim=1)

    def step_vjp(xs, us, lam):
        return integrator_vjp(model.derivs, dropped, xs, us, p, lam, model.integrator == "rk4",
                              model.intermediate_steps, model.dt)

    return {"du1_dropped": plain_grad_loop(model, s0, Q, pvec, step, step_vjp)[1]}


def plant_kernels(plant: str, gen, cartpole: dict) -> dict:
    """Phase 74 for one plant: its K1, K2, K3 pass-1 (and fast-normals) and
    K7 instances against their plain versions; returns each kernel's
    numbers for the ``kernels`` line."""
    ctrl = plant_controller(plant, "mppi", OPTIMIZER_CONFIG)
    opt = ctrl.optimizer
    model, pack = ode.rollout_model(opt)
    check(model.plant == plant and ode.can_use_grad(opt), f"{plant}: not the device plant")
    S, U = kernels.PLANT_DIMS[plant]
    dev = gen.device
    pvec = pack(ctrl._assemble_params(), torch.full((U,), 0.1, device=dev))
    s0 = plant_states(plant, K, gen)
    Q = torch.clamp(0.5 * torch.randn(K, H, U, generator=gen, device=dev), -1.0, 1.0)
    rk4_ops, stage_ops, vjp_ops, stage_vjp_ops = PLANT_OPS[plant.replace("_fast", "")]
    mutants = plant_mutants(plant, model, pvec)
    out = {}

    def sw(q, swap):
        return q.flip(-1).contiguous() if swap else q

    # K1, at the main path's shapes, ragged K and H = PLANT_ODD_H.
    k1 = out["cost_rollout"] = compare(f"k1_{plant}", lambda: cost_rollout(model, s0, Q, pvec),
                                       lambda: cost_rollout_plain(model, s0, Q, pvec))
    k1.update(bound(K * H * (rk4_ops + stage_ops), nbytes(s0, Q, pvec) + 4 * K))
    got = cost_rollout(model, s0, Q, pvec)
    k1["rejects"] = rejects(f"k1_{plant}", got, {
        n: cost_rollout_plain(m, s0, sw(Q, swap), pv) for n, (m, pv, swap) in mutants.items()})
    cases = {}
    for k, h in ((PLANT_RAGGED_K, H), (K, PLANT_ODD_H)):
        s, q = s0[:k].contiguous(), Q[:k, :h].contiguous()
        g, r = cost_rollout(model, s, q, pvec), cost_rollout_plain(model, s, q, pvec)
        cases[f"K{k}_H{h}"] = max_errors(g, r)[0]
        check(torch.allclose(g, r, **KERNEL_TOL), f"k1_{plant} K{k} H{h}: disagrees")
    k1["cases"] = cases

    # K2 likewise (the point mass's chunk is 32 steps: H=50 and 45 end mid-chunk).
    P = opt.interp.number_of_interpolation_inducing_points
    eps = opt.SQRTRHODTINV * torch.randn(P, U, K, generator=gen, device=dev)
    u_nom = torch.clamp(0.3 * torch.randn(H, U, generator=gen, device=dev), -1.0, 1.0)
    lim = (opt.action_low, opt.action_high)
    corr = (opt.cc_weight, opt.R, opt.NU)
    args = (model, s0[0].contiguous(), u_nom, pvec, eps, opt.interp.matrix, *lim, *corr)
    k2 = out["mppi_cost"] = compare(f"k2_{plant}", lambda: mppi_cost(*args),
                                    lambda: mppi_cost_plain(*args))
    k2.update(bound(K * H * (rk4_ops + stage_ops + U * MPPI_EXTRA_OPS),
                    nbytes(*args[1:8]) + 4 * K))
    got = mppi_cost(*args)
    k2["rejects"] = rejects(f"k2_{plant}", got, {
        n: mppi_cost_plain(m, args[1], sw(u_nom, swap), pv, sw(eps.transpose(1, 2), swap)
                           .transpose(1, 2).contiguous(), *args[5:])
        for n, (m, pv, swap) in mutants.items()})
    cases = {}
    for k, h in ((PLANT_RAGGED_K, H), (K, PLANT_ODD_H)):
        W = torch.as_tensor(interpolation_matrix(h, PERIOD), device=dev)
        a = (model, args[1], u_nom[:h].contiguous(), pvec,
             eps[:W.shape[0], :, :k].contiguous(), W, *lim, *corr)
        g, r = mppi_cost(*a), mppi_cost_plain(*a)
        cases[f"K{k}_H{h}"] = max_errors(g, r)[0]
        check(torch.allclose(g, r, **KERNEL_TOL), f"k2_{plant} K{k} H{h}: disagrees")
    k2["cases"] = cases

    # K3's pass 1 (the point mass also over its fast-normals instance).
    seed2 = torch.tensor([SEED + 11, 0], dtype=torch.int32, device=dev)
    models = {"fused_mppi_cost": model}
    if plant in kernels.EXACT_IS_FAST:
        models["fused_mppi_cost_fast_normals"] = dataclasses.replace(model, fast_sampling=True)
    stdev, tile = opt.SQRTRHODTINV, opt.fused_tile_k
    for key, m in models.items():
        a = (m, args[1], u_nom, pvec, seed2, opt.interp.matrix, *lim, *corr, stdev, K, tile)
        k3 = out[key] = compare(f"k3_{plant}{key[15:]}", lambda: fused_mppi_costs(*a),
                                lambda: fused_mppi_costs_plain(*a))
        k3.update(bound(K * (H * (rk4_ops + stage_ops + U * MPPI_EXTRA_OPS)
                             + P * U * (NORMAL_OPS + 1)), nbytes(*a[1:4], *a[5:8]) + 4 * K))
        got = fused_mppi_costs(*a)
        k3["rejects"] = rejects(f"k3_{plant}", got, {
            n: fused_mppi_costs_plain(dataclasses.replace(mm, fast_sampling=m.fast_sampling),
                                      a[1], u_nom, pv, *a[4:])
            for n, (mm, pv, swap) in mutants.items() if not swap})
        kr = 11 * 64  # ragged: eleven tiles of 64, the last block half full
        a = (m, args[1], u_nom, pvec, seed2, opt.interp.matrix, *lim, *corr, stdev, kr, 64)
        g, r = fused_mppi_costs(*a), fused_mppi_costs_plain(*a)
        k3["cases"] = {f"K{kr}": max_errors(g, r)[0]}
        check(torch.allclose(g, r, **KERNEL_TOL), f"k3_{plant} K{kr}: disagrees")

    # K7: J to KERNEL_TOL, dQ to DQ_RTOL plus DQ_ATOL_FRAC of max|dQ|.
    Qg = 2.0 * torch.rand(K, H, U, generator=gen, device=dev) - 1.0
    (cost, dQ), (ref_cost, ref_dQ) = (grad_cost_rollout(model, s0, Qg, pvec),
                                      grad_cost_rollout_plain(model, s0, Qg, pvec))
    torch.cuda.synchronize()
    wrong = plant_grad_mutants(plant, model, s0, Qg, pvec)
    k7 = out["grad_cost_rollout"] = {
        "cost_max_abs_err": max_errors(cost, ref_cost)[0],
        "dQ_max_abs_err": max_errors(dQ, ref_dQ)[0], "dQ_max_abs": float(ref_dQ.abs().max()),
        "mutant_max_abs_err": {k: max_errors(m, ref_dQ)[0] for k, m in wrong.items()},
        "ms": cuda_ms(lambda: grad_cost_rollout(model, s0, Qg, pvec), 20),
        "plain_ms": cuda_ms(lambda: grad_cost_rollout_plain(model, s0, Qg, pvec), 2),
        **bound(K * H * (rk4_ops + stage_ops + vjp_ops + stage_vjp_ops),
                nbytes(s0, Qg, pvec, Qg) + 4 * K)}
    k7["max_abs_err"] = max(k7["cost_max_abs_err"], k7["dQ_max_abs_err"])
    check(bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()), f"k7_{plant}: not finite")
    check(torch.allclose(cost, ref_cost, **KERNEL_TOL), f"k7_{plant}: cost disagrees {k7}")
    check(close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC), f"k7_{plant}: dQ disagrees {k7}")
    for k, m in wrong.items():
        check(not close(m, dQ, DQ_RTOL, DQ_ATOL_FRAC), f"k7_{plant}: the dQ bound takes {k}")
    s, q = s0[:PLANT_RAGGED_K].contiguous(), Qg[:PLANT_RAGGED_K, :PLANT_ODD_H].contiguous()
    (c, d), (rc, rd) = grad_cost_rollout(model, s, q, pvec), grad_cost_rollout_plain(model, s, q,
                                                                                      pvec)
    k7["cases"] = {f"K{PLANT_RAGGED_K}_H{PLANT_ODD_H}": max_errors(d, rd)[0]}
    check(torch.allclose(c, rc, **KERNEL_TOL) and close(d, rd, DQ_RTOL, DQ_ATOL_FRAC),
          f"k7_{plant} ragged: disagrees")
    emit(f"k7_{plant}", k7)
    for key, cart in (("cost_rollout", "k1"), ("mppi_cost", "k2"), ("fused_mppi_cost", "k3"),
                      ("grad_cost_rollout", "k7")):
        out[key]["cartpole_ms"] = cartpole[cart]["ms"]
    emit(f"{plant}_cases", {key: {k: v[k] for k in ("cartpole_ms", "bound_ms", "bound_by",
                                                    "rejects", "cases") if k in v}
                            for key, v in out.items()})
    emit(f"{plant}_resources", plant_resources(plant))
    return out


def plant_loop(name: str, ctrl: MPCController, plant: str, ticks: int, expected: dict,
               start=None, dt: float = DT, seed: int = SEED) -> tuple:
    """``ticks`` closed-loop ticks against the plant's environment (seed
    ``seed``, from ``start`` where given), every kernel's launch count set to 0
    just before and checked against ``expected`` (kernel -> launches) just
    after; returns the counts and the visited states."""
    env = {"pendulum": PendulumEnv, "acrobot": AcrobotEnv,
           "pointmass": PointMassEnv}[PLANT_CASES[plant][0]](batch_size=1, dt=dt, seed=seed)
    s, _ = env.reset()
    if start is not None:
        env.state = torch.tensor(np.asarray(start, np.float32)[None])
        s = env.state.numpy()
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    builds, epoch = kernels.build.count, ctrl.optimizer._build_epoch
    host_ms, visited = [], []
    for t in range(ticks):
        t0 = time.perf_counter()
        u = ctrl.step(s[0])
        host_ms.append((time.perf_counter() - t0) * 1e3)
        check(u.shape == (env.num_actions,) and bool(np.all(np.isfinite(u)))
              and bool(np.all(np.abs(u) <= 1.0)), f"{name}: tick {t}: bad control {u}")
        s, *_ = env.step(u)
        visited.append(s[0].copy())
    counts = {kernel: wrapper.launches for kernel, wrapper in COUNTED.items()}
    check(counts == {kernel: expected.get(kernel, 0) for kernel in COUNTED},
          f"{name}: kernel launches {counts}, expected {expected}")
    check(kernels.build.count == builds and ctrl.optimizer._build_epoch == epoch,
          f"{name}: something was rebuilt during the loop")
    return counts, np.array(visited), {"ticks": ticks,
                                       "step_host_p50_ms": float(np.percentile(host_ms, 50)),
                                       "final_state": [float(v) for v in s[0]]}


def plant_phases(gen, cartpole: dict) -> tuple:
    """Phases 74-76: the pendulum, acrobot and point-mass plants.  Returns
    each kernel row's numbers by (wrapper, plant) and the loops' launches
    by plant."""
    rows, runs = {}, {plant: [] for plant in PLANT_CASES}
    # 74. Each instance against its plain version.
    for plant in PLANT_CASES:
        for key, numbers in plant_kernels(plant, gen, cartpole).items():
            rows[key, plant] = numbers

    # 75. The flagship-width loops, PLANT_TICKS each, counted from 0.
    T, its = PLANT_TICKS, RPGD_CONFIG["outer_its"]
    mppi_paths = {  # label: (optimizer, config, launches a tick)
        "mppi": ("mppi", OPTIMIZER_CONFIG, {"mppi_cost": 1}),
        "mppi_modular": ("mppi", {**OPTIMIZER_CONFIG, "semi_fused": False}, {"cost_rollout": 1}),
        "mppi_fused": ("mppi", FUSED_MPPI_CONFIG, {"fused_mppi_cost": 1,
                                                   "fused_mppi_weights": 1}),
        "rpgd": ("rpgd-tf", RPGD_CONFIG, {"cost_rollout": 1, "grad_cost_rollout": its}),
    }
    zoo_paths = {
        "cem": ("cem-tf", CEM_CONFIG, {"cost_rollout": CEM_CONFIG["cem_outer_it"]}),
        "icem": ("icem-tf", ICEM_CONFIG, {"cost_rollout": ICEM_CONFIG["cem_outer_it"]}),
        "random_action": ("random-action-tf", RANDOM_CONFIG, {"cost_rollout": 1}),
        "cem_gmm": ("cem-gmm-tf", GMM_CONFIG, {"cost_rollout": 2}),
        "cma_es": ("cma-es-tf", CMA_CONFIG, {"cost_rollout": 3}),
        "gradient": ("gradient-tf", GRADIENT_CONFIG,
                     {"cost_rollout": 1, "grad_cost_rollout": GRADIENT_CONFIG["gradient_steps"]}),
        "cem_naive_grad": ("cem-naive-grad-tf", NAIVE_GRAD_CONFIG,
                           {"grad_cost_rollout": 1, "cost_rollout": 1}),
        "cem_grad_bharadhwaj": ("cem-grad-bharadhwaj-tf", BHARADHWAJ_CONFIG,
                                {"grad_cost_rollout": 2, "cost_rollout": 2}),
    }
    for plant in PLANT_CASES:
        paths = dict(mppi_paths)
        if plant in ("pendulum", "acrobot", "pointmass"):
            paths.update(zoo_paths)
        for label, (name, config, per_tick) in paths.items():
            c = plant_controller(plant, name, config)
            opt = c.optimizer
            fused = getattr(opt, "_can_fully_fuse", lambda: False)()
            check(ode.rollout_model(opt)[0].plant == plant and ode.can_use_cost(opt)
                  and fused == (label == "mppi_fused")
                  and (label != "mppi" or opt._uses_semi_fused()),
                  f"{plant} {label}: the controller did not take its kernel path")
            counts, _, numbers = plant_loop(f"slice_{plant}_{label}", c, plant, T,
                                            {k: n * T for k, n in per_tick.items()})
            emit(f"slice_{plant}_{label}", numbers)
            runs[plant].append(counts)
    # The point mass's fast-normals K3 (fully fused MPPI over "ODE:rk4:1:fast").
    for plant in ("pointmass", "pointmass_obstacles"):
        c = plant_controller(plant, "mppi", FUSED_MPPI_CONFIG, spec=FAST_SPEC)
        check(c.optimizer._can_fully_fuse() and ode.rollout_model(c.optimizer)[0].fast_math,
              f"{plant}: the fast MPPI did not take K3's fast-normals instance")
        counts, _, numbers = plant_loop(f"slice_{plant}_fast_normals", c, plant, T,
                                        {"fused_mppi_cost": T, "fused_mppi_weights": T})
        emit(f"slice_{plant}_mppi_fused_fast_normals", numbers)
        runs[plant + "_fast_normals"] = [counts]

    # 76. The demos.
    c = plant_controller("pendulum", "mppi", PLANT_DEMO_MPPI["pendulum"])
    counts, visited, numbers = plant_loop("demo_pendulum", c, "pendulum", PENDULUM_DEMO_TICKS,
                                          {"mppi_cost": PENDULUM_DEMO_TICKS}, seed=2)
    held = int(np.sum(1.0 - np.cos(visited[:, 0]) < 0.05))
    emit("demo_pendulum_swingup", {**numbers, "ticks_held_upright": held})
    check(held > 20, f"the pendulum never held upright (held {held} ticks)")
    runs["pendulum"].append(counts)
    cfg = PLANT_DEMO_MPPI["acrobot"]
    c = plant_controller("acrobot", "mppi", cfg)
    counts, visited, numbers = plant_loop("demo_acrobot", c, "acrobot", ACROBOT_DEMO_TICKS,
                                          {"mppi_cost": ACROBOT_DEMO_TICKS},
                                          dt=cfg["mpc_timestep"], seed=2)
    tip = -np.cos(visited[:, 0]) - np.cos(visited[:, 0] + visited[:, 2])
    emit("demo_acrobot", {**numbers, "tip_height_max": float(tip.max()),
                          "tip_height_last": float(tip[-1]), "tip_height_of": 2.0})
    runs["acrobot"].append(counts)
    for name, cfg in POINTMASS_DEMO.items():
        c = plant_controller("pointmass_obstacles", name, cfg, attrs=PM_DEMO_ATTRS)
        per = ({"cost_rollout": 1, "grad_cost_rollout": cfg["outer_its"]} if name == "rpgd-tf"
               else {"cost_rollout": cfg["cem_outer_it"]})
        counts, visited, numbers = plant_loop(
            f"demo_pointmass_{name}", c, "pointmass_obstacles", POINTMASS_DEMO_TICKS,
            {k: n * POINTMASS_DEMO_TICKS for k, n in per.items()}, start=[-1.0, 0.0, 0.0, 0.0],
            dt=cfg["mpc_timestep"])
        min_d = float(np.hypot(visited[:, 0], visited[:, 1]).min())
        err = float(np.hypot(visited[-1, 0] - 1.0, visited[-1, 1]))
        emit(f"demo_pointmass_obstacles_{name}", {**numbers, "min_obstacle_distance": min_d,
                                                  "target_error": err})
        check(min_d > PM_DEMO_ATTRS["obs0_r"] and err < 0.2,
              f"{name}: the point mass did not reach its target around the obstacle "
              f"(min distance {min_d}, error {err})")
        runs["pointmass_obstacles"].append(counts)
    launches = {plant: {kernel: sum(r[kernel] for r in rs) for kernel in COUNTED}
                for plant, rs in runs.items()}
    return rows, launches


def start_sweep() -> None:
    """``--starts``: MPPI and rpgd-tf over the committed MLP (200 ticks with
    the target change) and MPPI over the committed GP (200 ticks), from
    LEARNED_START and from CartpoleEnv seeds 0-7's states, with optimizer
    seeds 0 and 1: how often the pole stays up."""
    starts = [LEARNED_START] + [CartpoleEnv(batch_size=1, dt=DT, seed=k).reset()[0][0]
                                for k in range(8)]
    for label, optimizer, config, spec, retarget in (
            ("mppi", "mppi", OPTIMIZER_CONFIG, MLP_SPEC, RETARGET_AT),
            ("rpgd-tf", "rpgd-tf", RPGD_CONFIG, MLP_SPEC, RETARGET_AT),
            ("mppi_gp", "mppi", RES_MPPI_CONFIG, GP_SPEC, None)):
        held = []
        for seed in (0, 1):
            for i, start in enumerate(starts):
                ctrl = make_controller("cuda", optimizer, {**config, "seed": seed}, spec=spec)
                numbers = closed_loop(f"starts_{label}_seed{seed}_start{i}", ctrl, MLP_TICKS,
                                      retarget_at=retarget, pole_check=False, start=start)
                held.append(numbers["max_abs_angle"] < 0.5)
        emit(f"starts_{label}", {"runs": len(held), "pole_up_runs": sum(held)})


def env_tick(ctrl: MPCController):
    """One closed-loop tick of ``ctrl`` against CartpoleEnv(seed=SEED) a call."""
    env = CartpoleEnv(batch_size=1, dt=DT, seed=SEED)
    s = [env.reset()[0]]

    def tick():
        s[0], *_ = env.step(ctrl.step(s[0][0]))

    return tick


def profile_ticks(name: str, tick) -> None:
    """``torch.profiler`` over PROFILE_TICKS calls of ``tick`` after
    PROFILE_WARMUP: device busy time and device operations per tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_WARMUP):
        tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_TICKS
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in per_kernel.values()) / 1e3 / PROFILE_TICKS
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    emit(f"profile_{name}", {
        "ticks": PROFILE_TICKS, "loop_wall_ms_per_tick": wall_ms,
        "device_busy_ms_per_tick": busy_ms, "busy_share": busy_ms / wall_ms,
        "device_ops_per_tick": sum(n for n, _ in per_kernel.values()) / PROFILE_TICKS,
        "top": [[k[:60], n / PROFILE_TICKS, us / 1e3 / PROFILE_TICKS] for k, (n, us) in top],
    })


def main() -> None:
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    device = resolve_device("cuda")  # raises where there is no card
    # The plain versions' float32 products in full float32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # 1. Build, from the sources even where this checkout built them before.
    kernels.library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    kernels.load()
    regs, entry = {}, None  # ptxas' resource line of each kernel
    for line in kernels.build.log.splitlines():
        named = re.search(r"entry function '_ZN3ctt\d+(\w+?_kernel)", line)
        if named:
            entry = named.group(1)
        elif "Used" in line:
            regs[entry or f"kernel {len(regs)}"] = line.split("ptxas info    : ")[-1]
    emit("build", {"seconds": time.perf_counter() - t0, "nvcc_seconds": kernels.build.seconds,
                   "library": kernels.library_path().name, "ptxas": regs})

    # 2-3. Each kernel against its plain version at the main path's shapes.
    ctrl = make_controller("cuda")
    opt = ctrl.optimizer
    model, pack = ode.rollout_model(opt)
    gen = torch.Generator(device=device).manual_seed(SEED)
    pvec = pack(ctrl._assemble_params(), torch.tensor([0.1], device=device))
    s0 = 0.05 * torch.randn(K, 4, generator=gen, device=device)
    Q = torch.clamp(0.3 * torch.randn(K, H, 1, generator=gen, device=device), -1.0, 1.0)
    k1 = compare("k1_cost_rollout", lambda: cost_rollout(model, s0, Q, pvec),
                 lambda: cost_rollout_plain(model, s0, Q, pvec))
    k1.update(bound(K * H * (RK4_STEP_OPS + STAGE_OPS), nbytes(s0, Q, pvec) + 4 * K))
    k1_cases(model, s0, Q, pvec)
    P = opt.interp.number_of_interpolation_inducing_points
    eps = opt.SQRTRHODTINV * torch.randn(P, 1, K, generator=gen, device=device)
    u_nom = torch.clamp(0.2 * torch.randn(H, 1, generator=gen, device=device), -1.0, 1.0)
    k2_args = (model, s0[0].contiguous(), u_nom, pvec, eps, opt.interp.matrix,
               opt.action_low, opt.action_high, opt.cc_weight, opt.R, opt.NU)
    k2 = compare("k2_mppi_cost", lambda: mppi_cost(*k2_args), lambda: mppi_cost_plain(*k2_args))
    k2.update(bound(K * H * (RK4_STEP_OPS + STAGE_OPS + MPPI_EXTRA_OPS),
                    nbytes(*k2_args[1:8]) + 4 * K))
    k2_cases(k2_args, opt.SQRTRHODTINV)

    # 4-5. The MPPI paths, closed loop, each counted from 0.
    modular = make_controller("cuda", semi_fused=False)
    check(opt._uses_semi_fused() and not modular.optimizer._uses_semi_fused(),
          "the controllers did not take the expected MPPI paths")
    runs = {"semi_fused": counted_loop("slice_semi_fused", ctrl, TICKS, {"mppi_cost": TICKS},
                                       retarget_at=RETARGET_AT)}
    runs["modular"] = counted_loop("slice_modular", modular, MODULAR_TICKS,
                                   {"cost_rollout": MODULAR_TICKS})

    # 6. One update on the card against the same update on the CPU.
    check(float(ctrl.variable_parameters["target_position"]) == np.float32(NEW_TARGET),
          "the target change did not reach the controller")
    update_vs_cpu_mppi("update_vs_cpu", ctrl)

    # 7. K7 against its plain version at the gradient path's shapes.
    Qg = 2.0 * torch.rand(K, H, 1, generator=gen, device=device) - 1.0
    k7 = compare_grad("k7_grad_cost_rollout", model, Qg, pvec,
                      lambda: grad_cost_rollout(model, s0, Qg, pvec),
                      lambda: grad_cost_rollout_plain(model, s0, Qg, pvec))
    k7.update(bound(K * H * (RK4_STEP_OPS + STAGE_OPS + RK4_VJP_OPS + STAGE_VJP_OPS),
                    nbytes(s0, Qg, pvec, Qg) + 4 * K))
    k7_cases(model, s0, Qg, pvec)

    # 8-9. The gradient optimizers, closed loop.
    rpgd = make_controller("cuda", "rpgd-tf", RPGD_CONFIG)
    gradient = make_controller("cuda", "gradient-tf", GRADIENT_CONFIG)
    for c in (rpgd, gradient):
        check(ode.can_use_grad(c.optimizer), f"{c.optimizer.registered_name}: not on K7")
    runs["rpgd"] = counted_loop("slice_rpgd", rpgd, RPGD_TICKS,
                                {"cost_rollout": RPGD_TICKS, "grad_cost_rollout": 2 * RPGD_TICKS},
                                retarget_at=RETARGET_AT)
    runs["gradient"] = counted_loop("slice_gradient", gradient, GRADIENT_TICKS,
                                    {"cost_rollout": GRADIENT_TICKS,
                                     "grad_cost_rollout": 5 * GRADIENT_TICKS})

    # 10. One rpgd-tf update on the card against the same update on the CPU,
    # from the state the loop left, on a resample tick, with the same draw.
    update_vs_cpu_rpgd(rpgd)

    # 11-12. K11 and K8 over the committed MLP, at the learned paths' shapes.
    mlp = make_controller("cuda", spec=MLP_SPEC)
    nmodel, npack = neural.net_model(mlp.optimizer)
    nparams = mlp._assemble_params()
    net, npvec = nparams["dyn"]["net"], npack(nparams, torch.tensor([0.1], device=device))
    check("norm_in_mean" in net and "norm_out_mean" in net, "the committed MLP did not load")
    k11 = compare_neural(nmodel, s0, Q, npvec, net)
    k11.update(bound(K * H * (mlp_ops(net) + STAGE_OPS), nbytes(s0, Q, npvec, *leaves(net)) + 4 * K))
    k11_cases(nmodel, s0, Q, npvec, net)
    k8 = compare_neural_grad(nmodel, s0, Qg, npvec, net)
    # One forward and the transposed layers: K8 re-runs the forward in its
    # backward, but a kernel that kept the activations would not have to.
    k8.update(bound(K * H * (mlp_ops(net) + mlp_vjp_ops(net) + STAGE_OPS + STAGE_VJP_OPS),
                    nbytes(s0, Qg, npvec, *leaves(net), Qg) + 4 * K))
    mma_resources("k8_resources", "neural_grad_cost_rollout_kernel", nmodel.net_args(net)[0],
                  "neural_grad",
                  tc_bound_ms(mma_tiles(net), mlp_scalar_ops(net) + STAGE_OPS + STAGE_VJP_OPS))

    # 13. K13 over the committed GRU and over an LSTM of the same widths.
    k13 = compare_recurrent("k13_recurrent_cost_rollout_gru", GRU_SPEC, s0, Q, gen)
    compare_recurrent("k13_recurrent_cost_rollout_lstm", LSTM_SPEC, s0, Q, gen)

    # 14-16. The learned-dynamics paths, closed loop, each counted from 0.
    mlp_rpgd = make_controller("cuda", "rpgd-tf", RPGD_CONFIG, spec=MLP_SPEC)
    gru = make_controller("cuda", spec=GRU_SPEC)
    check(neural.can_use_cost(mlp.optimizer) and not mlp.optimizer._uses_semi_fused()
          and neural.can_use_grad(mlp_rpgd.optimizer) and neural.can_use_cost(gru.optimizer),
          "the learned-dynamics controllers did not take the network kernels")
    runs["mppi_mlp"] = counted_loop("slice_mppi_mlp", mlp, MLP_TICKS,
                                    {"neural_cost_rollout": MLP_TICKS}, retarget_at=RETARGET_AT,
                                    start=LEARNED_START)
    runs["rpgd_mlp"] = counted_loop("slice_rpgd_mlp", mlp_rpgd, MLP_RPGD_TICKS,
                                    {"neural_cost_rollout": MLP_RPGD_TICKS,
                                     "neural_grad_cost_rollout": 2 * MLP_RPGD_TICKS},
                                    retarget_at=RETARGET_AT, start=LEARNED_START)
    trace = []
    runs["mppi_gru"] = counted_loop("slice_mppi_gru", gru, GRU_TICKS,
                                    {"recurrent_cost_rollout": GRU_TICKS}, pole_check=False,
                                    trace=trace, start=LEARNED_START)
    gru_hidden_vs_replay(gru, trace)

    # 17. One update on the card against the same update on the CPU, from
    # the state each loop left.
    update_vs_cpu_mppi("mlp_update_vs_cpu", mlp, MLP_SPEC)
    update_vs_cpu_mppi("gru_update_vs_cpu", gru, GRU_SPEC)
    update_vs_cpu_rpgd(mlp_rpgd, "rpgd_mlp_update_vs_cpu", MLP_SPEC)

    # 18-19. K12 and K9 with a nonzero residual, at the main path's shapes.
    res_rpgd = residual_controller("rpgd-tf", RES_RPGD_CONFIG)
    rmodel, rpack = residual.residual_model(res_rpgd.optimizer)
    rparams = res_rpgd._assemble_params()
    rnet, rpvec = rparams["dyn"]["res"], rpack(rparams, torch.tensor([0.1], device=device))
    k12 = compare_residual(rmodel, s0, Q, rpvec, rnet)
    k12.update(bound(K * H * (RK4_STEP_OPS + mlp_ops(rnet) + STAGE_OPS),
                     nbytes(s0, Q, rpvec, *leaves(rnet)) + 4 * K))
    k12_cases(rmodel, s0, Q, rpvec, rnet)
    k9 = compare_residual_grad(rmodel, s0, Qg, rpvec, rnet)
    # One forward and the transposed step (K7's rk4 adjoint and the MLP's
    # transposed layers): K9 re-runs the forward in its backward.
    k9.update(bound(K * H * (RK4_STEP_OPS + mlp_ops(rnet) + STAGE_OPS + RK4_VJP_OPS
                             + mlp_vjp_ops(rnet) + STAGE_VJP_OPS),
                    nbytes(s0, Qg, rpvec, *leaves(rnet), Qg) + 4 * K))
    mma_resources("k9_resources", "residual_grad_cost_rollout_kernel", rmodel.net_args(rnet)[0],
                  "residual_grad",
                  tc_bound_ms(mma_tiles(rnet), RK4_STEP_OPS + RK4_VJP_OPS + mlp_scalar_ops(rnet)
                              + STAGE_OPS + STAGE_VJP_OPS))

    # 20-21. K14 and K10 over a well-conditioned GP of the committed one's
    # widths, then over the committed GP against float64.
    gp_rpgd = make_controller("cuda", "rpgd-tf", RES_RPGD_CONFIG, spec=GP_SPEC)
    gmodel, gpack = gp.gp_model(gp_rpgd.optimizer)
    gparams = gp_rpgd._assemble_params()
    gops, gpvec = (flatten_gp_weights(gparams["dyn"]["gp"]),
                   gpack(gparams, torch.tensor([0.1], device=device)))
    wops = flatten_gp_weights(well_conditioned_gp(gparams["dyn"]["gp"]))
    k14 = compare_gp(gmodel, s0, Q, gpvec, wops)
    k14.update(bound(K * H * (gp_ops(gops) + STAGE_OPS),
                     nbytes(s0, Q, gpvec, *gops.values()) + 4 * K))
    k14_cases(gmodel, s0, Q, gpvec, wops, gops, gparams["dyn"]["gp"])
    k10 = compare_grad("k10_gp_grad_cost_rollout", gmodel, Qg, gpvec,
                       lambda: gp_grad_cost_rollout(gmodel, s0, Qg, gpvec, wops),
                       lambda: gp_grad_cost_rollout_plain(gmodel, s0, Qg, gpvec, wops), reps=20,
                       mutants={"no_2an": gp_autograd_dq(gmodel, s0, Qg, gpvec, wops,
                                                         drop_2an=True)})
    k10.update(bound(K * H * (gp_ops(gops) + gp_vjp_ops(gops) + STAGE_OPS + STAGE_VJP_OPS),
                     nbytes(s0, Qg, gpvec, *gops.values(), Qg) + 4 * K))
    k10_cases(gmodel, s0, Qg, gpvec, wops, gparams["dyn"]["gp"])
    gp_vs_float64(gmodel, s0, Q, Qg, gpvec, gops)

    # 22-25. The adaptive-MPC and sparse-GP paths, closed loop, each counted
    # from 0.
    check(residual.can_use_grad(res_rpgd.optimizer) and gp.can_use_grad(gp_rpgd.optimizer),
          "the rpgd-tf controllers did not take K9 and K10")
    adaptive, runs["adaptive_mppi_residual"] = adaptive_mppi()
    runs["rpgd_residual"] = counted_loop("slice_rpgd_residual", res_rpgd, RES_RPGD_TICKS,
                                         {"residual_cost_rollout": RES_RPGD_TICKS,
                                          "residual_grad_cost_rollout": 2 * RES_RPGD_TICKS})
    gp_mppi = gp_mppi_with_refit(runs)
    runs["rpgd_gp"] = counted_loop("slice_rpgd_gp", gp_rpgd, GP_RPGD_TICKS,
                                   {"gp_cost_rollout": GP_RPGD_TICKS,
                                    "gp_grad_cost_rollout": 2 * GP_RPGD_TICKS})

    # 26. One update on the card against the same update on the CPU for each,
    # over the GP with the well-conditioned GP swapped in as a re-fit is (the
    # loop's posterior back after it).
    update_vs_cpu_mppi("residual_update_vs_cpu", adaptive, RES_SPEC, RES_MPPI_CONFIG)
    update_vs_cpu_rpgd(res_rpgd, "rpgd_residual_update_vs_cpu", RES_SPEC, RES_RPGD_CONFIG)
    preds = [c.optimizer.predictor.predictor for c in (gp_mppi, gp_rpgd)]
    fitted = [p.gp_params for p in preds]
    for p, f in zip(preds, fitted):
        p.gp_params = well_conditioned_gp(f)
    update_vs_cpu_mppi("gp_update_vs_cpu", gp_mppi, GP_SPEC, RES_MPPI_CONFIG)
    update_vs_cpu_rpgd(gp_rpgd, "rpgd_gp_update_vs_cpu", GP_SPEC, RES_RPGD_CONFIG)
    for p, f in zip(preds, fitted):
        p.gp_params = f

    # 27-29. K5 and K3's two passes against their plain versions, at the
    # sampling paths' shapes.
    cem = make_controller("cuda", "cem-tf", CEM_CONFIG)
    cem_fused = make_controller("cuda", "cem-tf", {**CEM_CONFIG, "fully_fused": True})
    mppi_fused = make_controller("cuda", "mppi", FUSED_MPPI_CONFIG)
    icem = make_controller("cuda", "icem-tf", ICEM_CONFIG)
    random_action = make_controller("cuda", "random-action-tf", RANDOM_CONFIG)
    check(cem_fused.optimizer._fused and not cem.optimizer._fused
          and mppi_fused.optimizer._can_fully_fuse() and ode.can_use_cost(icem.optimizer)
          and ode.can_use_cost(random_action.optimizer),
          "the sampling controllers did not take the expected paths")
    smodel, spack = ode.rollout_model(cem_fused.optimizer)
    spvec = spack(cem_fused._assemble_params(), torch.tensor([0.1], device=device))
    k5 = compare_fused_cem(smodel, spvec, cem.optimizer.action_low, cem.optimizer.action_high,
                           gen)
    k3a, k3b = compare_fused_mppi(smodel, spvec, mppi_fused.optimizer, gen)

    # 30-33. The sampling paths, closed loop, each counted from 0.
    its = CEM_CONFIG["cem_outer_it"]
    runs["cem"] = counted_loop("slice_cem", cem, CEM_TICKS, {"cost_rollout": its * CEM_TICKS},
                               retarget_at=RETARGET_AT)
    runs["cem_fused"] = counted_loop("slice_cem_fused", cem_fused, CEM_TICKS,
                                     {"fused_cem": its * CEM_TICKS}, retarget_at=RETARGET_AT)
    runs["mppi_fused"] = counted_loop("slice_mppi_fused", mppi_fused, FUSED_MPPI_TICKS,
                                      {"fused_mppi_cost": FUSED_MPPI_TICKS,
                                       "fused_mppi_weights": FUSED_MPPI_TICKS},
                                      retarget_at=RETARGET_AT)
    runs["icem"] = counted_loop("slice_icem", icem, ZOO_TICKS, {"cost_rollout": its * ZOO_TICKS})
    runs["random_action"] = counted_loop("slice_random_action", random_action, ZOO_TICKS,
                                         {"cost_rollout": ZOO_TICKS})

    # 34. One update on the card against the same update on the CPU.
    update_vs_cpu_cem("cem_update_vs_cpu", cem, CEM_CONFIG)
    update_vs_cpu_cem("cem_fused_update_vs_cpu", cem_fused, {**CEM_CONFIG, "fully_fused": True})
    update_vs_cpu_mppi("mppi_fused_update_vs_cpu", mppi_fused, config=FUSED_MPPI_CONFIG)

    # 35-36. K4 and K6 against their plain versions at FLEET_B_MAX sessions.
    fleet_mppi = fleet_controller("cuda", "mppi", FLEET_MPPI_CONFIG, FLEET_B)
    fleet_cem = fleet_controller("cuda", "cem-tf", FLEET_CEM_CONFIG, FLEET_B)
    check(fleet_mppi._batched_kernel_eligible() and fleet_cem._batched_fused_cem_eligible(),
          "the fleet controllers did not take K4 and K6")
    k4 = compare_k4(fleet_mppi.optimizer, gen)
    k6 = compare_k6(fleet_cem.optimizer, gen)

    # 37-38. The fleet paths, closed loop, each counted from 0.
    runs["fleet_mppi"] = fleet_loop("slice_fleet_mppi", fleet_mppi, FLEET_MPPI_TICKS,
                                    {"mppi_cost_cols": FLEET_MPPI_TICKS})
    runs["fleet_cem"] = fleet_loop("slice_fleet_cem", fleet_cem, FLEET_CEM_TICKS,
                                   {"fused_cem_cols": FLEET_CEM_CONFIG["cem_outer_it"]
                                    * FLEET_CEM_TICKS})

    # 39. One fleet update on the card against the same update on the CPU.
    fleet_update_vs_cpu(fleet_mppi, fleet_cem, gen)

    # 40. Both fleet paths timed at FLEET_B and FLEET_B_MAX sessions.
    fleet_ticks = {f"fleet_{label}_b{B}": fleet_timing(
        f"{label}_b{B}", fleet_controller("cuda", optimizer, config, B), gen)
        for B in (FLEET_B, FLEET_B_MAX)
        for label, optimizer, config in (("mppi", "mppi", FLEET_MPPI_CONFIG),
                                         ("cem", "cem-tf", FLEET_CEM_CONFIG))}

    # 41. The learned models' session-row kernels at FLEET_B_MAX sessions.
    learned = {kind: learned_fleet("cuda", kind, FLEET_B) for kind in LEARNED_FLEETS}
    check(all(c._batched_neural_eligible() == (kind == "mlp")
              and c._batched_recurrent_eligible() == (kind in ("gru", "lstm"))
              and c._batched_residual_eligible() == (kind == "residual")
              and c._batched_gp_eligible() == (kind == "gp") for kind, c in learned.items()),
          "the learned fleets did not take their session-row kernels")
    cols_rows = {kind: compare_cols(kind, c, gen) for kind, c in learned.items()}

    # 42. The learned fleets, closed loop, each counted from 0.
    for kind, c in learned.items():
        runs[f"fleet_{kind}"] = fleet_loop(f"slice_fleet_{kind}", c, LEARNED_FLEET_TICKS,
                                           {COLS_KERNELS[kind][0].__name__: LEARNED_FLEET_TICKS},
                                           retarget_at=LEARNED_SWAP_AT, swap=fleet_swap(kind, c),
                                           pole_check=False)

    # 43. One update of each learned fleet on the card against the CPU's.
    for kind, c in learned.items():
        learned_fleet_update_vs_cpu(kind, c, gen)

    # 44. The learned fleets timed at FLEET_B and FLEET_B_MAX sessions.
    fleet_ticks.update({f"fleet_{kind}_b{B}": fleet_timing(
        f"{kind}_b{B}", learned_fleet("cuda", kind, B), gen)
        for B in (FLEET_B, FLEET_B_MAX) for kind in LEARNED_FLEETS})

    # 45. The gradient fleets' session-row forms against their plain versions.
    grad = {label: grad_fleet("cuda", label) for label in GRAD_FLEETS}
    check(all(c._batched_rpgd_eligible() == label.startswith("rpgd")
              and c._batched_gradient_eligible() == label.startswith("gradient")
              for label, c in grad.items()), "the gradient fleets did not take their steps")
    grad_rows = {form: compare_grad_cols(form, grad[GRAD_COLS_FLEET[form]], gen)
                 for form in GRAD_COLS}

    # 46. The gradient fleets, closed loop, each counted from 0: a tick is
    # outer_its (gradient_steps) launches of the gradient form and one of
    # the cost form for all the sessions; the ODE fleets' poles must stay up.
    for label, c in grad.items():
        _, config, _, _, _, kind, gform, cform = GRAD_FLEETS[label]
        its = config.get("outer_its", config.get("gradient_steps"))
        runs[f"fleet_{label}"] = fleet_loop(
            f"slice_fleet_{label}", c, GRAD_FLEET_TICKS,
            {gform: its * GRAD_FLEET_TICKS, cform: GRAD_FLEET_TICKS},
            retarget_at=GRAD_FLEET_SWAP_AT, swap=kind and fleet_swap(kind, c),
            pole_check=kind is None)

    # 47. One update of each gradient fleet on the card against the CPU's.
    for label, c in grad.items():
        grad_fleet_update_vs_cpu(label, c, gen)

    # 48. The gradient fleets timed at FLEET_B and FLEET_B_MAX sessions.
    for B in (FLEET_B, FLEET_B_MAX):
        for label in GRAD_FLEETS:
            c = grad_fleet("cuda", label, B)
            fleet_ticks[f"fleet_{label}_b{B}"] = fleet_timing(f"{label}_b{B}", c, gen,
                                                               grad_fleet_draw(c))

    # 49-50. The member-block forms of K11 and K8 over the committed ensemble.
    ens_mppi = make_controller("cuda", "mppi", RES_MPPI_CONFIG, spec=ENS_SPEC)
    ens_rpgd = make_controller("cuda", "rpgd-tf", RES_RPGD_CONFIG, spec=ENS_SPEC)
    check(ensemble.can_use_cost(ens_mppi.optimizer) and ensemble.can_use_grad(ens_rpgd.optimizer)
          and not ens_mppi.optimizer._uses_semi_fused(),
          "the ensemble controllers did not take the member-block forms")
    emodel, epack = ensemble.net_model(ens_rpgd.optimizer)
    eparams = ens_rpgd._assemble_params()
    enet, epvec = eparams["dyn"]["net"], epack(eparams, torch.tensor([0.1], device=device))
    check(enet["w0"].shape == (4, 5, 32) and "norm_in_mean" in enet,
          "the committed ensemble did not load")
    k11e = compare_ens(emodel, s0, Q, epvec, enet)
    k8e = compare_ens_grad(emodel, s0, Qg, epvec, enet)

    # 51. MPPI and rpgd-tf over the ensemble, closed loop, each counted from 0.
    runs["mppi_ensemble"] = counted_loop("slice_mppi_ensemble", ens_mppi, ENS_TICKS,
                                         {"neural_cost_rollout_ens": ENS_TICKS}, pole_check=False)
    runs["rpgd_ensemble"] = counted_loop("slice_rpgd_ensemble", ens_rpgd, ENS_RPGD_TICKS,
                                         {"neural_cost_rollout_ens": ENS_RPGD_TICKS,
                                          "neural_grad_cost_rollout_ens": 2 * ENS_RPGD_TICKS},
                                         pole_check=False)

    # 52. One update of each on the card against the same update on the CPU.
    update_vs_cpu_mppi("ensemble_update_vs_cpu", ens_mppi, ENS_SPEC, RES_MPPI_CONFIG)
    update_vs_cpu_rpgd(ens_rpgd, "rpgd_ensemble_update_vs_cpu", ENS_SPEC, RES_RPGD_CONFIG)

    # 53. MPPI with robust_eval "worst" (every plan under the four members:
    # plain torch, no kernel) and with risk_weight (K11's member-block form
    # plus the members' disagreement), a few ticks each and one update
    # against the CPU's.
    for label, option, expected in (
            ("robust_worst", {"robust_eval": "worst"}, {}),
            ("risk", {"risk_weight": ENS_RISK}, {"neural_cost_rollout_ens": ENS_OPTION_TICKS})):
        config = {**RES_MPPI_CONFIG, **option}
        c = make_controller("cuda", "mppi", config, spec=ENS_SPEC)
        runs[f"mppi_ensemble_{label}"] = counted_loop(f"slice_mppi_ensemble_{label}", c,
                                                      ENS_OPTION_TICKS, expected,
                                                      pole_check=False)
        update_vs_cpu_mppi(f"ensemble_{label}_update_vs_cpu", c, ENS_SPEC, config)

    # 54. The emit_terminal forms of K1, K2 and K4 against their plain
    # versions (phase 2's, 3's and 35's operands; K4 at the fleet's B=32).
    P, S = opt.interp.number_of_interpolation_inducing_points, s0.shape[1]
    k1e = compare_emit("k1_emit_cost_rollout", cost_rollout_emit, cost_rollout,
                       cost_rollout_emit_plain, (model, s0, Q, pvec),
                       (model, s0, Q[:, :-1].contiguous(), pvec),
                       (model, *first_k(VALUE_RAGGED_K, s0, Q), pvec),
                       nbytes(s0, Q, pvec) + 4 * K * (1 + S), K * H * (RK4_STEP_OPS + STAGE_OPS))
    W = opt.interp.matrix
    k2_prev = (model, k2_args[1], k2_args[2][:-1].contiguous(), pvec, eps,
               W[:, :-1].contiguous()) + k2_args[6:]
    k2_rag = k2_args[:4] + (eps[:, :, :VALUE_RAGGED_K].contiguous(),) + k2_args[5:]
    k2e = compare_emit("k2_emit_mppi_cost", mppi_cost_emit, mppi_cost, mppi_cost_emit_plain,
                       k2_args, k2_prev, k2_rag, nbytes(*k2_args[1:8]) + 4 * K * (1 + S),
                       K * H * (RK4_STEP_OPS + STAGE_OPS + MPPI_EXTRA_OPS))
    fopt = fleet_controller("cuda", "mppi", FLEET_MPPI_CONFIG, FLEET_B).optimizer
    fmodel, pvec_b, fs0 = fleet_operands(fopt, FLEET_B, gen)
    Pf, Kf, Hf = (fopt.interp.number_of_interpolation_inducing_points, fopt.num_rollouts,
                  fopt.mpc_horizon)
    fu = torch.clamp(0.2 * torch.randn(FLEET_B, Hf, 1, generator=gen, device=device), -1.0, 1.0)
    feps = fopt.SQRTRHODTINV * torch.randn(FLEET_B, Pf, 1, Kf, generator=gen, device=device)
    fconsts = (fopt.interp.matrix, fopt.action_low, fopt.action_high, fopt.cc_weight, fopt.R,
               fopt.NU)
    k4_args = (fmodel, fs0, fu, pvec_b, feps) + fconsts
    k4_prev = (fmodel, fs0, fu[:, :-1].contiguous(), pvec_b, feps,
               fconsts[0][:, :-1].contiguous()) + fconsts[1:]
    k4_rag = (fmodel, fs0[:3], fu[:3], pvec_b[:3],
              fopt.SQRTRHODTINV * torch.randn(3, Pf, 1, VALUE_RAGGED_K, generator=gen,
                                              device=device)) + fconsts
    k4e = compare_emit("k4_emit_mppi_cost_cols", mppi_cost_cols_emit, mppi_cost_cols,
                       mppi_cost_cols_emit_plain, k4_args, k4_prev, k4_rag,
                       nbytes(fs0, fu, pvec_b, feps, *fconsts[:3]) + 4 * FLEET_B * Kf * (1 + S),
                       FLEET_B * Kf * Hf * (RK4_STEP_OPS + STAGE_OPS + MPPI_EXTRA_OPS))
    emit("emit_resources", {name: ptxas_resources(kernel, instance) for name, (kernel, instance)
                            in {"k1": ("cost_rollout_kernel", SINGLE),
                                "k1_emit": ("cost_rollout_emit_kernel", ""),
                                "k2": ("mppi_cost_kernel", ""),
                                "k2_emit": ("mppi_cost_emit_kernel", ""),
                                "k4": ("mppi_cost_cols_kernel", ""),
                                "k4_emit": ("mppi_cost_cols_emit_kernel", ""),
                                "k7_forward": ("grad_cost_forward_kernel", SINGLE),
                                "k7_adjoint": ("grad_cost_adjoint_kernel", SINGLE)}.items()})

    # 55. K7's value_spec form against its plain version (phase 7's operands).
    k7v = compare_value_grad(model, s0, Qg, pvec)

    # 56. The valued loops over the committed value net, each counted from
    # 0: semi-fused MPPI (one K2 form a tick), rpgd-tf (two K7 forms and one
    # K1 form) and the short-horizon MPPI.
    vnet = load_net(VALUE_FILE, device)[0]

    def valued(optimizer: str, config: dict) -> MPCController:
        c = make_controller("cuda", optimizer, config)
        attach_value_terminal(c, vnet)
        return c

    vmppi, vrpgd = valued("mppi", OPTIMIZER_CONFIG), valued("rpgd-tf", RPGD_CONFIG)
    short_config = {**OPTIMIZER_CONFIG, "mpc_horizon": VALUE_SHORT_H}
    vshort = valued("mppi", short_config)
    check(vmppi.optimizer._uses_semi_fused() and vshort.optimizer._uses_semi_fused()
          and ode.can_use_grad(vrpgd.optimizer) and vrpgd.optimizer._value_grad_spec(),
          "the valued controllers did not take the value forms")
    runs["mppi_value"] = counted_loop("slice_mppi_value", vmppi, VALUE_TICKS,
                                      {"mppi_cost_emit": VALUE_TICKS}, start=LEARNED_START,
                                      pole_check=False)
    runs["rpgd_value"] = counted_loop("slice_rpgd_value", vrpgd, VALUE_RPGD_TICKS,
                                      {"cost_rollout_emit": VALUE_RPGD_TICKS,
                                       "grad_cost_rollout_value": 2 * VALUE_RPGD_TICKS},
                                      start=LEARNED_START, pole_check=False)
    runs["mppi_value_short"] = counted_loop("slice_mppi_value_h10", vshort, VALUE_SHORT_TICKS,
                                            {"mppi_cost_emit": VALUE_SHORT_TICKS},
                                            start=LEARNED_START, pole_check=False)

    # 57. One update of each on the card against the same update on the
    # CPU; a V swap.
    update_vs_cpu_mppi("mppi_value_update_vs_cpu", vmppi, value=vnet)
    update_vs_cpu_rpgd(vrpgd, "rpgd_value_update_vs_cpu", value=vnet)
    update_vs_cpu_mppi("mppi_value_h10_update_vs_cpu", vshort, config=short_config, value=vnet)
    value_swap_rebuilds_nothing(vshort, vnet)

    # 58. The valued MPPI fleet (phase 40's configuration): one K4 form a
    # tick, counted from 0; one update against the CPU's.
    vfleet = fleet_controller("cuda", "mppi", FLEET_MPPI_CONFIG, FLEET_B)
    attach_value_terminal(vfleet, vnet)
    check(vfleet._batched_kernel_eligible(), "the valued fleet did not take K4's form")
    runs["fleet_mppi_value"] = fleet_loop("slice_fleet_mppi_value", vfleet, VALUE_FLEET_TICKS,
                                          {"mppi_cost_cols_emit": VALUE_FLEET_TICKS},
                                          pole_check=False)
    value_fleet_update_vs_cpu(vfleet, vnet, gen)

    # 59. The learned models' emit_terminal forms against their plain
    # versions, at their kernels' phase operands (phases 11, 49, 18, 13, 20).
    rnn = {kind: recurrent_operands(spec, gen, device)
           for kind, spec in (("gru", GRU_SPEC), ("lstm", LSTM_SPEC))}
    forms = {
        "k11": (neural_cost_rollout_emit, neural_cost_rollout, neural_cost_rollout_emit_plain,
                (nmodel, s0, Q, npvec, net), VALUE_RAGGED_K, NET_TOL, mlp_ops(net)),
        "k11_ens": (neural_cost_rollout_ens_emit, neural_cost_rollout_ens,
                    neural_cost_rollout_ens_emit_plain, (emodel, s0, Q, epvec, enet),
                    ENS_RAGGED_K, NET_TOL, mlp_ops(member_net(enet, 0))),
        "k12": (residual_cost_rollout_emit, residual_cost_rollout,
                residual_cost_rollout_emit_plain, (rmodel, s0, Q, rpvec, rnet), VALUE_RAGGED_K,
                NET_TOL, RK4_STEP_OPS + mlp_ops(rnet)),
        **{f"k13_{kind}": (recurrent_cost_rollout_emit, recurrent_cost_rollout,
                           recurrent_cost_rollout_emit_plain, (m, s0, Q, pv, n, hd),
                           VALUE_RAGGED_K, RNN_TOL, rnn_ops(n, m.kind))
           for kind, (m, pv, n, hd) in rnn.items()},
        "k14": (gp_cost_rollout_emit, gp_cost_rollout, gp_cost_rollout_emit_plain,
                (gmodel, s0, Q, gpvec, wops), VALUE_RAGGED_K, NET_TOL, gp_ops(gops)),
    }
    learned_emit = {label: compare_learned_emit(f"{label}_emit", *form[:6],
                                                K * H * (form[6] + STAGE_OPS))
                    for label, form in forms.items()}
    learned_emit_resources()

    # 60. The session-row emit forms of K11, K12 and K14 at phase 41's
    # operands, each session equal to the single-session emit form.
    cols_emit = {kind: compare_cols_emit(kind, learned[kind], gen) for kind in COLS_EMIT}

    # 61. The valued loops over the learned models from LEARNED_START, each
    # counted from 0: one emit launch a tick (CEM: one an outer iteration).
    vlearned = {"mlp": make_controller("cuda", spec=MLP_SPEC),
                "gru": make_controller("cuda", spec=GRU_SPEC),
                "residual": residual_controller("mppi", RES_MPPI_CONFIG),
                "gp": make_controller("cuda", "mppi", RES_MPPI_CONFIG, spec=GP_SPEC),
                "ensemble": make_controller("cuda", "mppi", RES_MPPI_CONFIG, spec=ENS_SPEC),
                "cem_mlp": make_controller("cuda", "cem-tf", CEM_CONFIG, spec=MLP_SPEC)}
    for c in vlearned.values():
        attach_value_terminal(c, vnet)
    check(neural.can_use_cost(vlearned["mlp"].optimizer)
          and neural.can_use_cost(vlearned["gru"].optimizer)
          and residual.can_use_cost(vlearned["residual"].optimizer)
          and gp.can_use_cost(vlearned["gp"].optimizer)
          and ensemble.can_use_cost(vlearned["ensemble"].optimizer)
          and not vlearned["cem_mlp"].optimizer._fused,
          "the valued learned controllers did not take the emit forms")
    vkernel = {"mlp": "neural_cost_rollout_emit", "gru": "recurrent_cost_rollout_emit",
               "residual": "residual_cost_rollout_emit", "gp": "gp_cost_rollout_emit",
               "ensemble": "neural_cost_rollout_ens_emit"}
    for kind, c in vlearned.items():
        expected = ({"neural_cost_rollout_emit": its * VALUE_LEARNED_TICKS} if kind == "cem_mlp"
                    else {vkernel[kind]: VALUE_LEARNED_TICKS})
        label = "cem_mlp_value" if kind == "cem_mlp" else f"mppi_{kind}_value"
        runs[label] = counted_loop(f"slice_{label}", c, VALUE_LEARNED_TICKS, expected,
                                   start=LEARNED_START, pole_check=False)

    # 62. One valued update of each on the card against the CPU's (the GP's
    # with the well-conditioned GP swapped in as a re-fit is), a V swap;
    # then the valued MLP, "ODE+res" and GP fleets, 50 ticks each counted
    # from 0, one update of each against the CPU's.
    for kind, spec, config in (("mlp", MLP_SPEC, None), ("gru", GRU_SPEC, None),
                               ("residual", RES_SPEC, RES_MPPI_CONFIG),
                               ("gp", GP_SPEC, RES_MPPI_CONFIG),
                               ("ensemble", ENS_SPEC, RES_MPPI_CONFIG)):
        pred = vlearned[kind].optimizer.predictor.predictor
        fitted = pred.gp_params if kind == "gp" else None
        if kind == "gp":
            pred.gp_params = well_conditioned_gp(fitted)
        update_vs_cpu_mppi(f"mppi_{kind}_value_update_vs_cpu", vlearned[kind], spec, config,
                           value=vnet)
        if kind == "gp":
            pred.gp_params = fitted
    update_vs_cpu_cem("cem_mlp_value_update_vs_cpu", vlearned["cem_mlp"], CEM_CONFIG,
                      spec=MLP_SPEC, value=vnet)
    value_swap_rebuilds_nothing(vlearned["mlp"], vnet, "value_swap_mlp")
    vfleets = {kind: learned_fleet("cuda", kind, FLEET_B) for kind in COLS_EMIT}
    for kind, c in vfleets.items():
        attach_value_terminal(c, vnet)
        check(getattr(c, {"mlp": "_batched_neural_eligible",
                          "residual": "_batched_residual_eligible",
                          "gp": "_batched_gp_eligible"}[kind])(),
              f"the valued {kind} fleet did not take its session-row emit form")
        runs[f"fleet_{kind}_value"] = fleet_loop(
            f"slice_fleet_{kind}_value", c, VALUE_LEARNED_FLEET_TICKS,
            {COLS_EMIT[kind][0].__name__: VALUE_LEARNED_FLEET_TICKS}, pole_check=False)
        learned_fleet_update_vs_cpu(kind, c, gen, value=vnet)
    fleet_ticks["fleet_mlp_value_b32"] = fleet_timing("mlp_value_b32", vfleets["mlp"], gen)

    # 63. The value_spec forms of K8, K8's member-block form, K9 and K10
    # against their plain versions at phases 12's, 50's, 19's and 21's
    # operands, over a seeded V and the committed one.
    committed = value_ops_of(vnet)
    vbytes = nbytes(*committed)

    def vgrad_bound(step_ops: float, weights) -> tuple:
        return (K * H * step_ops + K * value_net_ops(),
                nbytes(s0, Qg, *leaves((weights,)), Qg) + vbytes + 4 * K)

    vg = {
        "k8": compare_value_learned(
            "k8", (nmodel, s0, Qg, npvec, net), (nmodel, *first_k(VALUE_RAGGED_K, s0, Qg), npvec,
                                                 net), committed,
            *vgrad_bound(mlp_ops(net) + mlp_vjp_ops(net) + STAGE_OPS + STAGE_VJP_OPS, net),
            extra_nets=(wide_net(True, 1.0, device),)),
        "k8_ens": compare_value_learned(
            "k8_ens", (emodel, s0, Qg, epvec, enet),
            (emodel, *first_k(ENS_RAGGED_K, s0, Qg), epvec, enet), committed,
            *vgrad_bound(mlp_ops(member_net(enet, 0)) + mlp_vjp_ops(member_net(enet, 0))
                         + STAGE_OPS + STAGE_VJP_OPS, enet)),
        "k9": compare_value_learned(
            "k9", (rmodel, s0, Qg, rpvec, rnet),
            (rmodel, *first_k(VALUE_RAGGED_K, s0, Qg), rpvec, rnet), committed,
            *vgrad_bound(RK4_STEP_OPS + mlp_ops(rnet) + STAGE_OPS + RK4_VJP_OPS
                         + mlp_vjp_ops(rnet) + STAGE_VJP_OPS, rnet),
            extra_nets=(wide_net(False, 0.02, device),)),
        "k10": compare_value_learned(
            "k10", (gmodel, s0, Qg, gpvec, wops),
            (gmodel, *first_k(VALUE_RAGGED_K, s0, Qg), gpvec, wops), committed,
            *vgrad_bound(gp_ops(gops) + gp_vjp_ops(gops) + STAGE_OPS + STAGE_VJP_OPS, wops))}

    # 64. The session-row value forms of K7-K10 and K1's session-row emit
    # form at phase 45's operands, each session equal to its single-session
    # form.
    vcols = {form: compare_value_cols(form, grad[GRAD_COLS_FLEET[form]], committed, gen)
             for form in VALUE_COLS}

    # 65. Valued rpgd-tf over each learned model and gradient-tf over the
    # MLP from LEARNED_START, and the valued gradient fleets, each counted
    # from 0: the emit form once a tick, the value form once an Adam
    # iteration.
    vgrad = {"mlp": make_controller("cuda", "rpgd-tf", RPGD_CONFIG, spec=MLP_SPEC),
             "residual": residual_controller("rpgd-tf", RES_RPGD_CONFIG),
             "gp": make_controller("cuda", "rpgd-tf", RES_RPGD_CONFIG, spec=GP_SPEC),
             "ensemble": make_controller("cuda", "rpgd-tf", RES_RPGD_CONFIG, spec=ENS_SPEC),
             "gradient_mlp": make_controller("cuda", "gradient-tf", GRADIENT_CONFIG,
                                             spec=MLP_SPEC)}
    for c in vgrad.values():
        attach_value_terminal(c, vnet)
    check(all(fam.can_use_grad(vgrad[kind].optimizer) and vgrad[kind].optimizer._value_grad_spec()
              for kind, fam in (("mlp", neural), ("residual", residual), ("gp", gp),
                                ("ensemble", ensemble), ("gradient_mlp", neural))),
          "the valued gradient controllers did not take the value forms")
    vgrad_forms = {"mlp": ("neural_cost_rollout_emit", "neural_grad_cost_rollout_value"),
                   "residual": ("residual_cost_rollout_emit", "residual_grad_cost_rollout_value"),
                   "gp": ("gp_cost_rollout_emit", "gp_grad_cost_rollout_value"),
                   "ensemble": ("neural_cost_rollout_ens_emit",
                                "neural_grad_cost_rollout_ens_value"),
                   "gradient_mlp": ("neural_cost_rollout_emit", "neural_grad_cost_rollout_value")}
    for kind, c in vgrad.items():
        gradient_ = kind == "gradient_mlp"
        ticks = VALUE_GRADIENT_TICKS if gradient_ else VALUE_GRAD_TICKS
        its = GRADIENT_CONFIG["gradient_steps"] if gradient_ else RPGD_CONFIG["outer_its"]
        cform, gform = vgrad_forms[kind]
        label = "gradient_mlp_value" if gradient_ else f"rpgd_{kind}_value"
        runs[label] = counted_loop(f"slice_{label}", c, ticks, {cform: ticks, gform: its * ticks},
                                   start=LEARNED_START, pole_check=False)
    vgfleets = {}
    for label, (gform, cform) in VALUE_FLEETS.items():
        c = vgfleets[label] = grad_fleet("cuda", label, FLEET_B)
        attach_value_terminal(c, vnet)
        check(c._batched_rpgd_eligible() == label.startswith("rpgd")
              and c._batched_gradient_eligible() == label.startswith("gradient"),
              f"the valued {label} fleet did not take its gradient step")
        config = GRAD_FLEETS[label][1]
        its = config.get("outer_its", config.get("gradient_steps"))
        runs[f"fleet_{label}_value"] = fleet_loop(
            f"slice_fleet_{label}_value", c, VALUE_GRAD_FLEET_TICKS,
            {gform: its * VALUE_GRAD_FLEET_TICKS, cform: VALUE_GRAD_FLEET_TICKS},
            pole_check=False)

    # 66. One valued update of each on the card against the CPU's (the GP's
    # with the well-conditioned GP swapped in as a re-fit is).
    for kind, spec, config in (("mlp", MLP_SPEC, RPGD_CONFIG), ("residual", RES_SPEC,
                                                                  RES_RPGD_CONFIG),
                               ("gp", GP_SPEC, RES_RPGD_CONFIG),
                               ("ensemble", ENS_SPEC, RES_RPGD_CONFIG)):
        pred = vgrad[kind].optimizer.predictor.predictor
        fitted = pred.gp_params if kind == "gp" else None
        if kind == "gp":
            pred.gp_params = well_conditioned_gp(fitted)
        update_vs_cpu_rpgd(vgrad[kind], f"rpgd_{kind}_value_update_vs_cpu", spec, config,
                           value=vnet)
        if kind == "gp":
            pred.gp_params = fitted
    gradient_value_update_vs_cpu(vgrad["gradient_mlp"], "gradient_mlp_value_update_vs_cpu",
                                 MLP_SPEC, GRADIENT_CONFIG, vnet)
    for label, c in vgfleets.items():
        grad_fleet_value_update_vs_cpu(label, c, vnet, gen)

    # 67-68. The fast plant's forms and loops.
    fast_k, fast_runs = fast_phases(device, ctrl, model, pvec, s0, Q, Qg, k2_args, rmodel,
                                    rpvec, rnet, vnet)
    # 69-73. The rest of the sampling and gradient-CEM zoo on cartpole.
    zoo_runs, zoo_fast_runs, zoo_ctrls, zoo_ticks = zoo_phases(device, gen, vnet)
    runs.update(zoo_runs)
    fast_runs.update(zoo_fast_runs)
    fleet_ticks.update(zoo_ticks)
    fast_launches = {kernel: sum(r[kernel] for r in fast_runs.values()) for kernel in COUNTED}
    launches = {kernel: sum(r[kernel] for r in runs.values()) for kernel in COUNTED}
    # 74-76. The pendulum, acrobot and point-mass plants.
    plant_rows, plant_launches = plant_phases(gen, {"k1": k1, "k2": k2, "k3": k3a, "k7": k7})

    if "--starts" in sys.argv[1:]:
        start_sweep()
    if "--profile" in sys.argv[1:]:
        for name, c in (("mppi", ctrl), ("rpgd-tf", rpgd), ("gradient-tf", gradient),
                        ("mppi-mlp", mlp), ("rpgd-tf-mlp", mlp_rpgd), ("mppi-gru", gru),
                        ("mppi-residual", adaptive), ("rpgd-tf-residual", res_rpgd),
                        ("mppi-gp", gp_mppi), ("rpgd-tf-gp", gp_rpgd), ("cem", cem),
                        ("cem-fused", cem_fused), ("mppi-fused", mppi_fused), ("icem", icem),
                        ("mppi-ensemble", ens_mppi), ("rpgd-tf-ensemble", ens_rpgd),
                        ("mppi-value", vmppi), ("rpgd-tf-value", vrpgd),
                        ("mppi-value-h10", vshort), ("mppi-mlp-value", vlearned["mlp"]),
                        ("rpgd-tf-mlp-value", vgrad["mlp"]),
                        ("rpgd-tf-residual-value", vgrad["residual"]),
                        ("rpgd-tf-gp-value", vgrad["gp"]),
                        ("rpgd-tf-ensemble-value", vgrad["ensemble"]),
                        ("gradient-tf-mlp-value", vgrad["gradient_mlp"]),
                        *((label.replace("_", "-"), c) for label, c in zoo_ctrls.items())):
            profile_ticks(name, env_tick(c))
        for name, tick in fleet_ticks.items():
            profile_ticks(name, tick)

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "control_toolkit_tpu"))
    check(not foreign, f"the port's main path imported {foreign}")

    rows = (
        ("mppi_cost", "mppi_cost.cu", "ops/pallas_mppi.py:501", k2),
        ("cost_rollout", "cost_rollout.cu", "ops/pallas_rollout.py:34", k1),
        ("grad_cost_rollout", "grad_cost_rollout.cu", "ops/pallas_grad.py:335", k7),
        ("neural_cost_rollout", "neural_rollout.cu", "ops/pallas_neural.py:157", k11),
        ("recurrent_cost_rollout", "neural_rollout.cu", "ops/pallas_neural.py:452", k13),
        ("neural_grad_cost_rollout", "neural_grad_rollout.cu", "ops/pallas_grad.py:387", k8),
        ("residual_cost_rollout", "residual_rollout.cu", "ops/pallas_neural.py:351", k12),
        ("residual_grad_cost_rollout", "residual_rollout.cu", "ops/pallas_grad.py:459", k9),
        ("gp_cost_rollout", "gp_rollout.cu", "ops/pallas_neural.py:647", k14),
        ("gp_grad_cost_rollout", "gp_rollout.cu", "ops/pallas_grad.py:515", k10),
        ("fused_cem", "fused_cem.cu", "ops/pallas_cem.py:38", k5),
        ("fused_mppi_cost", "fused_mppi.cu", "ops/pallas_mppi.py:376", k3a),
        ("fused_mppi_weights", "fused_mppi.cu", "ops/pallas_mppi.py:376", k3b),
        ("mppi_cost_cols", "mppi_cost_cols.cu", "ops/pallas_mppi.py:586", k4),
        ("fused_cem_cols", "fused_cem_cols.cu", "ops/pallas_cem.py:168", k6),
        ("neural_cost_rollout_cols", "neural_rollout.cu", "ops/pallas_neural.py:157",
         cols_rows["mlp"]),
        ("recurrent_cost_rollout_cols", "neural_rollout.cu", "ops/pallas_neural.py:452",
         cols_rows["gru"]),
        ("residual_cost_rollout_cols", "residual_rollout.cu", "ops/pallas_neural.py:351",
         cols_rows["residual"]),
        ("gp_cost_rollout_cols", "gp_rollout.cu", "ops/pallas_neural.py:647", cols_rows["gp"]),
        ("cost_rollout_cols", "cost_rollout.cu", "ops/pallas_rollout.py:34", grad_rows["k1"]),
        ("grad_cost_rollout_cols", "grad_cost_rollout.cu", "ops/pallas_grad.py:335",
         grad_rows["k7"]),
        ("neural_grad_cost_rollout_cols", "neural_grad_rollout.cu", "ops/pallas_grad.py:387",
         grad_rows["k8"]),
        ("residual_grad_cost_rollout_cols", "residual_rollout.cu", "ops/pallas_grad.py:459",
         grad_rows["k9"]),
        ("gp_grad_cost_rollout_cols", "gp_rollout.cu", "ops/pallas_grad.py:515",
         grad_rows["k10"]),
        ("neural_cost_rollout_ens", "neural_rollout.cu", "ops/pallas_neural.py:157", k11e),
        ("neural_grad_cost_rollout_ens", "neural_grad_rollout.cu", "ops/pallas_grad.py:387",
         k8e),
        ("cost_rollout_emit", "cost_rollout.cu", "ops/pallas_rollout.py:34", k1e),
        ("mppi_cost_emit", "mppi_cost.cu", "ops/pallas_mppi.py:501", k2e),
        ("mppi_cost_cols_emit", "mppi_cost_cols.cu", "ops/pallas_mppi.py:586", k4e),
        ("grad_cost_rollout_value", "grad_cost_rollout.cu", "ops/pallas_grad.py:335", k7v),
        ("neural_cost_rollout_emit", "neural_rollout.cu", "ops/pallas_neural.py:157",
         learned_emit["k11"]),
        ("neural_cost_rollout_ens_emit", "neural_rollout.cu", "ops/pallas_neural.py:157",
         learned_emit["k11_ens"]),
        ("recurrent_cost_rollout_emit", "neural_rollout.cu", "ops/pallas_neural.py:452",
         learned_emit["k13_gru"]),
        ("residual_cost_rollout_emit", "residual_rollout.cu", "ops/pallas_neural.py:351",
         learned_emit["k12"]),
        ("gp_cost_rollout_emit", "gp_rollout.cu", "ops/pallas_neural.py:647", learned_emit["k14"]),
        ("neural_cost_rollout_cols_emit", "neural_rollout.cu", "ops/pallas_neural.py:157",
         cols_emit["mlp"]),
        ("residual_cost_rollout_cols_emit", "residual_rollout.cu", "ops/pallas_neural.py:351",
         cols_emit["residual"]),
        ("gp_cost_rollout_cols_emit", "gp_rollout.cu", "ops/pallas_neural.py:647",
         cols_emit["gp"]),
        ("neural_grad_cost_rollout_value", "neural_grad_rollout.cu", "ops/pallas_grad.py:387",
         vg["k8"]),
        ("neural_grad_cost_rollout_ens_value", "neural_grad_rollout.cu",
         "ops/pallas_grad.py:387", vg["k8_ens"]),
        ("residual_grad_cost_rollout_value", "residual_rollout.cu", "ops/pallas_grad.py:459",
         vg["k9"]),
        ("gp_grad_cost_rollout_value", "gp_rollout.cu", "ops/pallas_grad.py:515", vg["k10"]),
        ("grad_cost_rollout_cols_value", "grad_cost_rollout.cu", "ops/pallas_grad.py:335",
         vcols["k7"]),
        ("neural_grad_cost_rollout_cols_value", "neural_grad_rollout.cu",
         "ops/pallas_grad.py:387", vcols["k8"]),
        ("residual_grad_cost_rollout_cols_value", "residual_rollout.cu",
         "ops/pallas_grad.py:459", vcols["k9"]),
        ("gp_grad_cost_rollout_cols_value", "gp_rollout.cu", "ops/pallas_grad.py:515",
         vcols["k10"]),
        ("cost_rollout_cols_emit", "cost_rollout.cu", "ops/pallas_rollout.py:34", vcols["k1"]),
    )
    check(all(launches[name] > 0 for name, *_ in rows),
          f"a kernel of the path was launched no time in its loops {launches}")
    # The fast forms (phases 67-68): the fast plant's instance of each entry,
    # its launches from the fast loops.
    fast_rows = tuple(
        (f"{name}_fast", source, replaces, fast_k[key], name)
        for name, source, replaces, key in (
            ("mppi_cost", "mppi_cost.cu", "ops/pallas_mppi.py:501", "k2"),
            ("cost_rollout", "cost_rollout.cu", "ops/pallas_rollout.py:34", "k1"),
            ("fused_mppi_cost", "fused_mppi.cu", "ops/pallas_mppi.py:376", "k3a"),
            ("fused_mppi_weights", "fused_mppi.cu", "ops/pallas_mppi.py:376", "k3b"),
            ("mppi_cost_cols", "mppi_cost_cols.cu", "ops/pallas_mppi.py:586", "k4"),
            ("fused_cem", "fused_cem.cu", "ops/pallas_cem.py:38", "k5"),
            ("fused_cem_cols", "fused_cem_cols.cu", "ops/pallas_cem.py:168", "k6"),
            ("grad_cost_rollout", "grad_cost_rollout.cu", "ops/pallas_grad.py:335", "k7"),
            ("residual_cost_rollout", "residual_rollout.cu", "ops/pallas_neural.py:351", "k12"),
            ("residual_grad_cost_rollout", "residual_rollout.cu", "ops/pallas_grad.py:459",
             "k9"),
            ("cost_rollout_cols", "cost_rollout.cu", "ops/pallas_rollout.py:34", "k1_cols"),
            ("cost_rollout_emit", "cost_rollout.cu", "ops/pallas_rollout.py:34", "k1_emit"),
            ("cost_rollout_cols_emit", "cost_rollout.cu", "ops/pallas_rollout.py:34",
             "k1_cols_emit"),
            ("mppi_cost_emit", "mppi_cost.cu", "ops/pallas_mppi.py:501", "k2_emit"),
            ("mppi_cost_cols_emit", "mppi_cost_cols.cu", "ops/pallas_mppi.py:586", "k4_emit"),
            ("grad_cost_rollout_cols", "grad_cost_rollout.cu", "ops/pallas_grad.py:335",
             "k7_cols"),
            ("grad_cost_rollout_value", "grad_cost_rollout.cu", "ops/pallas_grad.py:335",
             "k7_value"),
            ("grad_cost_rollout_cols_value", "grad_cost_rollout.cu", "ops/pallas_grad.py:335",
             "k7_cols_value"),
            ("residual_cost_rollout_emit", "residual_rollout.cu", "ops/pallas_neural.py:351",
             "k12_emit"),
            ("residual_cost_rollout_cols", "residual_rollout.cu", "ops/pallas_neural.py:351",
             "k12_cols"),
            ("residual_cost_rollout_cols_emit", "residual_rollout.cu",
             "ops/pallas_neural.py:351", "k12_cols_emit"),
            ("residual_grad_cost_rollout_cols", "residual_rollout.cu", "ops/pallas_grad.py:459",
             "k9_cols"),
            ("residual_grad_cost_rollout_value", "residual_rollout.cu",
             "ops/pallas_grad.py:459", "k9_value"),
            ("residual_grad_cost_rollout_cols_value", "residual_rollout.cu",
             "ops/pallas_grad.py:459", "k9_cols_value")))
    check(all(fast_launches[wrapper] > 0 for *_, wrapper in fast_rows),
          f"a fast entry was launched no time in the fast loops {fast_launches}")
    launches.update({name: fast_launches[wrapper] for name, _, _, _, wrapper in fast_rows})
    rows = rows + tuple(row[:4] for row in fast_rows)
    # The plants' instances (phases 74-76): launches from their own loops.
    plant_sources = {"cost_rollout": ("cost_rollout.cu", "ops/pallas_rollout.py:34"),
                     "mppi_cost": ("mppi_cost.cu", "ops/pallas_mppi.py:501"),
                     "fused_mppi_cost": ("fused_mppi.cu", "ops/pallas_mppi.py:376"),
                     "fused_mppi_cost_fast_normals": ("fused_mppi.cu", "ops/pallas_mppi.py:376"),
                     "grad_cost_rollout": ("grad_cost_rollout.cu", "ops/pallas_grad.py:335")}
    for (key, plant), numbers in plant_rows.items():
        if key == "fused_mppi_cost_fast_normals":
            n = plant_launches[plant + "_fast_normals"]["fused_mppi_cost"]
            name = f"fused_mppi_cost_{plant}_fast_normals"
        else:
            n, name = plant_launches[plant][key], f"{key}_{plant}"
        check(n > 0, f"{name}: launched no time in its plant's loops")
        launches[name] = n
        rows = rows + ((name, *plant_sources[key], numbers),)
    # No single PyTorch call computes a rollout's cost, or samples, rolls
    # out and scores: library_ms is null.
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"control_toolkit_tpu_torch/csrc/{source}",
         "replaces": f"control_toolkit_tpu/{replaces}", "launches": launches[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None}
        for name, source, replaces, k in rows
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
