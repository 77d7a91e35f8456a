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
37. 100 closed-loop ticks of a 32-session MPPI fleet, each slot against its
    own CartpoleEnv with its own pole length, a rotating quarter of the
    slots idle each tick, half the targets changed and slot 2's model
    re-identified at tick 50 (examples/fleet_serving.py without ZeroMQ):
    one K4 launch a tick, idle slots bit for bit unchanged, every pole up,
    nothing rebuilt;
38. 100 ticks for a 32-session fused CEM fleet (two K6 a tick);
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
42. 50 closed-loop ticks of each 32-session learned fleet as phase 37's
    (a rotating quarter idle and checked bit for bit, hidden included; at
    tick 25 half the targets changed, new weight tensors, a GP hot-swap,
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
46. 25 closed-loop ticks of each gradient fleet as phase 37's (a rotating
    quarter idle and checked bit for bit, Adam moments, counters, ages and
    generators included; at tick 12 half the targets changed, slot 2's
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
    shared memory and blocks per SM (``plant_kernels``; each plain version
    timed at its one reference call, ``compare_once``); each bound
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

The quadrotor2d, quadrotor3d, car and arm2 plants (ids 8-17, each with its
fast plant, car/obstacles a plant of its own; K1, K2, K3 and K7 carry them
in their plain entries, built in translation units of their own,
``REST_CASES``):
77. each plant's instance of K1, K2, K3's pass 1 and K7 as phase 74 holds
    them, within the plant's control limits ([0, 1] for the quadrotors),
    at K=16384, H=50, ragged K (700) and H=45 (not a multiple of the 3-D
    quadrotor's 16-step controls-ahead chunk), each bound rejecting the
    plant's named wrong variant (``rest_mutants``: the planar quadrotor's
    pitch acceleration with its sign flipped, the 3-D quadrotor's roll and
    pitch torques swapped, the car's tan(steer) read as sin(steer), an
    obstacle of car/obstacles dropped, the arm's damping dropped; for K7's
    dQ, the 3-D quadrotor's du[3] dropped);
78. at K=16384, H=50, PLANT_TICKS closed-loop ticks each against the
    port's environments, counted from 0: MPPI semi-fused (K2), modular
    (K1), fully fused (K3) and rpgd-tf (K7, K1) over each plant, the
    quadrotors' MPPI with ``bounded_update`` (K1), the zoo of phase 75
    over the four exact plants;
79. the JAX tests' closed loops on their criteria (``REST_DEMOS``), each
    under optimizer seeds 1-12 and met under no fewer of them than a
    one-sided Fisher exact test at 5% allows beside the JAX package's
    count over the same seeds (3-10, ``REST_DEMO_JAX_MET``; ``demo_floor``):
    bounded-update MPPI flies the 3-D quadrotor to its waypoint (the mean
    of the last 50 of 250 ticks within 0.25 of it) and the planar one (the
    last state within 0.2 and 0.25), MPPI drives the car to its waypoint
    (best distance < 0.4) and around the disc at K=1024, H=60 (never
    nearer than 0.4 to its center, best < 0.5 from the goal) and reaches
    the arm's fingertip target (best < 0.12).

The options every optimizer takes (no new kernel: mppi-optimize's Adam
refinement of the nominal plan runs the gradient kernels at one rollout):
80. K7 (exact, ``:fast``, its value_spec form over a seeded V, and over the
    pendulum) and K8 over the committed MLP at K=1, H=35, the refinement's
    operating point, against their plain versions: J to KERNEL_TOL (K8:
    NET_TOL), dQ to K7's bound, which must reject K7's dQ with a
    stage-gradient term wrong; each timed with its bound;
81. mppi-optimize-tf at the port's config_defaults (K=400, H=35, 10 Adam
    steps; the one config file the script reads, to hold that its
    constants are the defaults) and at the flagship width (K=16384, H=50),
    50 closed-loop ticks each from CartpoleEnv(seed=0), counted from 0: one
    K2 launch and ``optim_steps`` K7 calls a tick, with torch.autograd
    refused during the loop; the pole recorded, not required; one refined
    update on the card against the CPU's from the same draw; then each in
    turns with plain MPPI at the same K and H (host p50/p99 of each) and a
    profiler breakdown of each tick (device operations a tick);
82. one ``calculate_optimal_trajectory`` step (MPPI at the flagship width)
    against the CPU's from the same draw, and its extra host time a tick,
    in turns with the same MPPI without it;
83. one policy-seeded step (``initial_guess_policy``): the plan and the
    seeded update on the card against the CPU's, and the plan's one-off
    host time;
84. ``profile_latency``'s report over 20 flagship MPPI ticks.

The fleets and fused CEM over the other plants (plant ids 2-17: K4, K5,
K6 and the session-row forms of K1 and K7; each fleet plans one dynamics
constant of its plant per slot, ``FLEET_SLOT_DYN``):
85. each plant's instances against their plain versions: K5 at K=16384,
    H=50 and at K=704 (tiles of 64), H=45; K4 and K6 at 32 sessions of
    the fleet's K=512, H=35 (timed at 128 too); K1's and K7's session-row
    forms at 32 sessions of 100 rollouts, H=50, each session's outputs
    equal to its single-session kernel's, timed at (128, 32) and (32, 512);
    each bound rejecting the plant's named wrong variants (``row_mutants``
    over ``plant_mutants``) and, for the session forms, every session
    reading the next session's rows (arm2's K7 dQ held to float64); K5 and
    K6 equal to K1 over their regenerated controls; the point masses' K5
    and K6 also over their fast-normals instances; each instance's
    registers, spills and blocks per SM;
86. one update of each path on the card against the CPU's over the 3-D
    quadrotor: the MPPI, fused-CEM, mppi-var, rpgd-tf and gradient-tf
    fleets, the modular batched CEM step and single-session fused CEM;
87. closed loops counted from 0 of the MPPI, fused-CEM and rpgd-tf fleets
    (32 slots) and of single-session fused CEM over every plant, 10 ticks
    over the pendulum, the point mass under obstacles, the 3-D quadrotor
    and the car, 4 over the others;
88. 10 ticks of the point masses' fast fused CEM and fast fused-CEM fleet
    (the fast-normals instances of K5 and K6);

and over the same plant ids the learned-value and residual forms:

89. each plant's instances of the emit_terminal forms of K1, K1-cols, K2
    and K4, K7's value_spec forms (V a seeded tanh MLP of the plant's S)
    and K12 and K9 with all their forms (phase 18's seeded residual)
    against their plain versions, the single-session forms at the main
    path's K=16384, H=50 (a fast plant's gradient forms at 16 steps), the
    session-row forms at the fleets' sizes: costs and J to KERNEL_TOL
    (K12's to NET_TOL), the emit forms' costs equal to their kernels', dQ
    to K7's bound (the arm's to float64), x_H to float64 (f64_held; K1-emit
    over the exact plants also at two more draws of 4096 rollouts), each
    bound rejecting x_{H-1},
    the next rollout's x_H or the next session's rows, dV/dx_H dropped and
    the residual dropped; K9's and K12's session-row forms equal per
    session to their single-session forms; each instance's registers,
    spills and blocks per SM;
90. one update of each valued and "ODE+res" path on the card against the
    CPU's over the 3-D quadrotor (the gradient paths at one Adam
    iteration, the single-session rpgd-tf at 2048 rollouts);
91. closed loops counted from 0 of each path over every plant at the main
    path's width (K=16384, H=50; the fleets at 32 slots): valued MPPI
    (semi-fused, modular), valued rpgd-tf, adaptive MPPI over "ODE+res"
    with one dynamics constant 10% off and an OnlineSysId fit every 50
    ticks, rpgd-tf over "ODE+res" (valued too), the valued MPPI and
    rpgd-tf fleets, the "ODE+res" MPPI and rpgd-tf fleets (valued too);

and over the nine costs other than cartpole's (a network or GP kernel's
plant is its cost's) the learned-dynamics kernels:

92. each cost's instances of K11 (plain, emit_terminal, session-row and its
    emit_terminal form, member-block and its emit_terminal form), K13 (GRU
    and LSTM: plain, emit_terminal, session-row; the 3-D quadrotor's on two
    input and two head tiles), K14 (plain, emit_terminal, session-row and
    its emit_terminal form) and K10 (plain, value_spec, session-row and its
    value_spec form) against their plain versions over seeded mlp-64-64,
    GRU and LSTM 32-32, 4 x mlp-32-32 and a GP of 128 inducing points at the
    plant's widths, the single-session forms at K=16384, H=50, the
    session-row ones at 32 sessions of K=512, H=35: costs to the nets'
    bounds or float64, dQ to K7's bound or float64, x_H to float64
    (f64_held, its kernel ratio capped at 3), each bound rejecting the
    controls read a step early, the cost's named stage term dropped (each
    margin printed), x_{H-1} and the next rollout's x_H, the next session's
    rows (and hidden) and dV/dx_H dropped, K13's x_H bound the plain
    version in single-pass TF32; the emit forms' costs equal to their
    kernels'; each instance's CUDA-event time, FP32 and tensor-core bound,
    plain ms, registers, spills and blocks per SM;
93. one update of each path on the card against the CPU's over the 3-D
    quadrotor's cost: MPPI and CEM over the MLP, GRU and LSTM, MPPI over
    the GP and the ensemble, valued MPPI over the MLP and the GP, rpgd-tf
    over the GP (valued too), the MPPI fleets over the MLP, GRU and GP, the
    rpgd-tf fleet over the GP;
94. closed loops counted from 0 of every such path (and the valued MPPI over
    the ensemble, GRU and LSTM, the LSTM fleet, the valued MLP and GP
    fleets and the valued rpgd-tf fleet over the GP) over every cost at the
    main path's width, 2 ticks each;

and K8's six forms over the same nine costs (csrc/neural_grad_plants_<group>.cu):

95. each cost's instances of K8 (plain, value_spec, session-row and its
    value_spec form, member-block and its value_spec form) against their
    plain versions over seeded mlp-64-64 and 4 x mlp-32-32 at the plant's
    widths and phase 89's V, the single-session and member-block forms at
    K=16384, H=50, the session-row ones at 128 x 32 and 32 x 512, H=50,
    each also at K=700 (175 a member, 7 sessions of 100), H=45: J to the
    nets' bound or float64, dQ to K7's bound or float64 (f64_held, its
    kernel ratio J's, capped at 3), each bound rejecting the controls read a
    step early, the cost's named stage term dropped, the next session's
    rows, the next member's weights and, for the value forms' dQ, dV/dx_H
    dropped, V's scale left out and V without its 1/(H+1) (each margin
    printed); each instance's CUDA-event time, FP32 and tensor-core bound,
    plain ms, registers, spills and blocks per SM;
96. one update of each path K8 opens on the card against the CPU's over the
    3-D quadrotor's cost: rpgd-tf over the MLP (valued too) and the
    ensemble (valued too), gradient-tf over the MLP (valued too),
    cem-grad-bharadhwaj over the MLP, mppi-optimize-tf's refinement over the
    MLP, and the rpgd-tf and gradient-tf fleets over the MLP;
97. closed loops counted from 0 of every such path (and cem-naive-grad and
    the valued rpgd-tf fleet over the MLP) over every cost at the main path's
    width, 2 ticks each.

Closed-loop evaluation (control_toolkit_tpu_torch/evaluation), the
batched controller's per-slot step and fleet checkpoints, after the iLQR
phases 98-100:
101. ``ClosedLoop.run`` of the flagship for 100 ticks with actuator noise,
    bit for bit the script's own tick loop (``own_loop``), exactly one K2
    launch a tick, a second episode (``run_device``) under
    ``torch.cuda.set_sync_debug_mode("error")``, its device and host ms a
    tick; 20 ticks over the committed GRU (K13), the hidden written back;
102. ``run_batch``'s kernel sweeps of 32 episodes at the fleets' shapes
    (K4, K6, K7- and K1-cols, K11-cols over mlp-64-64): one launch a tick
    (an iteration) for all episodes, ms a tick, each sweep's first tick its
    fleet's, bit for bit, and held to the CPU port's as phases 39, 43 and 47
    hold the fleets; a per_slot_cost sweep of 4 weights x 8 episodes equal
    row for row to unswept sweeps;
103. 8-slot fleets of cem-gmm-tf, modular cem-tf and rpgd-tf with warmup at
    K=16384, H=50, which take the per-slot step: 3 ticks, 3 slots idle on
    the second, each active slot equal to its single-session controller bit
    for bit, the idle ones unchanged, the launches the single sessions';
104. ``save_fleet`` / ``load_fleet`` of an rpgd-tf fleet (K7-cols) and an
    MPPI fleet over the GRU (K13-cols): a fresh fleet loaded from the
    checkpoint steps 3 ticks equal bit for bit to the uninterrupted one.

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
config explicitly; the one config file it reads is the port's
config_optimizers.yml, in phase 81, to hold MPPI_OPTIMIZE_CONFIG to it).
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
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.costs.value_terminal import (
    attach_value_terminal, update_value_params,
)
from control_toolkit_tpu_torch.environments.acrobot import AcrobotEnv
from control_toolkit_tpu_torch.environments.arm2 import Arm2Env
from control_toolkit_tpu_torch.environments.car import CarEnv
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.environments.pendulum import PendulumEnv
from control_toolkit_tpu_torch.environments.pointmass import PointMassEnv
from control_toolkit_tpu_torch.environments.quadrotor2d import Quadrotor2DEnv
from control_toolkit_tpu_torch.environments.quadrotor3d import Quadrotor3DEnv
from control_toolkit_tpu_torch.evaluation import ClosedLoop
from control_toolkit_tpu_torch.models.dynamics import _acrobot_derivs
from control_toolkit_tpu_torch.models.gp_predictor import fit_gp_dynamics
from control_toolkit_tpu_torch.models.networks import gru_apply, gru_init_state, load_net
from control_toolkit_tpu_torch.models.online_sysid import OnlineSysId
from control_toolkit_tpu_torch.models.training import collect_transitions
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.common import (
    AdamState, adam_init, adam_update, clip_by_norm, elite_indices,
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
from control_toolkit_tpu_torch.optimizers.cem import CEMState, refit
from control_toolkit_tpu_torch.optimizers.kernel_families import (
    ensemble, gp, neural, ode, residual,
)
from control_toolkit_tpu_torch.optimizers.mppi_var import MPPIVarState
from control_toolkit_tpu_torch.utils.convert import (
    gradient_state_from_numpy, mppi_state_from_numpy, rpgd_state_from_numpy,
)
from control_toolkit_tpu_torch.utils.config import load_optimizer_config
from control_toolkit_tpu_torch.utils.checkpoint import _as_array, _flatten, load_fleet, save_fleet
from control_toolkit_tpu_torch.utils.device import place, resolve_device
from control_toolkit_tpu_torch.utils.rng import make_generator

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
T0 = time.perf_counter()  # the script's start, for each phase's at_s
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
FLEET_MPPI_TICKS, FLEET_CEM_TICKS, FLEET_RETARGET_AT, FLEET_TIMING_TICKS = 100, 100, 50, 50
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
LEARNED_RAGGED_K, LEARNED_FLEET_TICKS, LEARNED_SWAP_AT = 120, 50, 25
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
GRAD_FLEET_TICKS, GRAD_FLEET_SWAP_AT = 25, 12
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
PLANT_RAGGED_K, PLANT_ODD_H, PLANT_TICKS = 700, 45, 5
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
# The quadrotor2d, quadrotor3d, car and arm2 plants (phases 77-79), held and
# looped as phases 74-75 hold and loop theirs, under the demos' targets
# (REST_ATTRS); their demos are the JAX tests' closed loops (REST_DEMOS).
REST_CASES = {  # device plant: (environment, cost specification, predictor)
    "quadrotor2d": ("quadrotor2d", None, "ODE"),
    "quadrotor2d_fast": ("quadrotor2d", None, FAST_SPEC),
    "quadrotor3d": ("quadrotor3d", None, "ODE"),
    "quadrotor3d_fast": ("quadrotor3d", None, FAST_SPEC),
    "car": ("car", None, "ODE"),
    "car_fast": ("car", None, FAST_SPEC),
    "car_obstacles": ("car", "obstacles", "ODE"),
    "car_obstacles_fast": ("car", "obstacles", FAST_SPEC),
    "arm2": ("arm2", None, "ODE"),
    "arm2_fast": ("arm2", None, FAST_SPEC),
}
ALL_CASES = {**PLANT_CASES, **REST_CASES}
ENVS = {"pendulum": PendulumEnv, "acrobot": AcrobotEnv, "pointmass": PointMassEnv,
        "quadrotor2d": Quadrotor2DEnv, "quadrotor3d": Quadrotor3DEnv, "car": CarEnv,
        "arm2": Arm2Env}
CAR_OBSTACLE = {"obs0_x": 1.2, "obs0_y": 0.15, "obs0_r": 0.4}
REST_ATTRS = {"quadrotor2d": {"target_x": 0.5, "target_z": 1.5},
              "quadrotor3d": {"target_x": 0.5, "target_y": -0.3, "target_z": 1.5},
              "car": {"target_x": 2.0, "target_y": 1.0},
              "car_obstacles": {"target_x": 2.5, "target_y": 0.0, "obs0_x": 0.0, "obs0_y": 0.0,
                                "obs0_r": 0.3, "obs1_x": 1.2, "obs1_y": 0.15, "obs1_r": 0.4},
              "arm2": {"target_x": 0.6, "target_y": 0.4}}
# Each demo runs under optimizer seeds DEMO_SEEDS and must meet its JAX
# test's criterion under demo_floor(REST_DEMO_JAX_MET[label]) of them.  The
# criteria are seed-fragile in the JAX package too: over seeds 1-12 on the
# CPU it meets them 6, 8, 8, 3 and 10 times (REST_DEMO_JAX_MET: `PYTHONPATH=.
# python tests/test_torch_plants_rest.py --demo <label> <seed>`), and these
# closed loops are chaotic: with its observations perturbed by 1e-5 (`...
# <seed> 1e-5`) its arm meets its criterion 5 times of 12, not 10.  So each
# count is a sample of a success rate, the port's as the JAX package's, and
# the margin is a test of the one against the other: the port fails where
# a one-sided Fisher exact test at DEMO_ALPHA finds its count below the JAX
# package's (floors 2, 4, 4, 1 and 6 of 12; at least 1 always).  A
# controller that met a criterion under 1 seed of 12 where the JAX package
# meets it under 10 fails (p = 0.0003).
DEMO_SEEDS = tuple(range(1, 13))
DEMO_ALPHA = 0.05
REST_DEMO_JAX_MET = {"quadrotor3d": 6, "quadrotor2d": 8, "car": 8, "car_obstacles": 3, "arm2": 10}


def demo_floor(jax_met: int, n: int = len(DEMO_SEEDS), alpha: float = DEMO_ALPHA) -> int:
    """The fewest successes of ``n`` seeds that a one-sided Fisher exact
    test at ``alpha`` does not find below ``jax_met`` of ``n`` (and at
    least 1): the least ``t`` whose lower tail P(X <= t), X hypergeometric
    over the 2n runs with t + jax_met successes, exceeds ``alpha``."""
    def lower_tail(t: int) -> float:
        hits = t + jax_met
        return sum(math.comb(hits, x) * math.comb(2 * n - hits, n - x)
                   for x in range(max(0, hits - n), t + 1)) / math.comb(2 * n, n)
    return max(1, next(t for t in range(n + 1) if lower_tail(t) > alpha))
# FP32 operations per rollout-step (counted from csrc/plants.cuh as
# PLANT_OPS are, a lower bound): the rk4 step (derivs 20, 73, 17 and 64),
# the stage cost, K7's transposed rk4 step (four Jacobian-tangent products
# over S x (S+U) tangents, their rk4 sums and the chain's S x (S+U)
# multiply-adds: the 3-D quadrotor's 12 x 16 dominate) and the stage-cost
# gradient; car/obstacles adds the three hinges.
REST_OPS = {"quadrotor2d": (155, 35, 1050, 35), "quadrotor3d": (439, 63, 7100, 70),
            "car": (119, 28, 700, 34), "car_obstacles": (119, 66, 700, 70),
            "arm2": (307, 36, 1300, 40)}
PLANT_OPS.update(REST_OPS)
# The arm's K7 dQ is held to float64: its determinant M11 M22 - M12^2
# cancels and its double pendulum separates float32 trajectories, so the
# float32 plain version itself lies ~1e-5 of max |dQ| from float64 (1.3e-3
# of 136 at K=4096 on the CPU), beyond DQ_RTOL's reach of two float32
# computations of it.
F64_HELD_PLANTS = ("arm2",)
# The JAX tests' closed loops (label: environment seed, start, plant,
# optimizer config, ticks, controller attributes, cost config).
REST_MPPI = {"seed": 1, "mpc_timestep": 0.02, "mpc_horizon": 40, "num_rollouts": 512,
             "cc_weight": 1.0, "R": 1.0, "NU": 1000.0, "period_interpolation_inducing_points": 5}
REST_DEMOS = {
    # tests/test_quadrotor3d.py:60-85, tests/test_quadrotor2d.py:39-58
    "quadrotor3d": (4, None, "quadrotor3d", {**REST_MPPI, "LBD": 3.0, "SQRTRHOINV": 0.08,
                                             "bounded_update": True}, 250,
                    REST_ATTRS["quadrotor3d"], {}),
    "quadrotor2d": (4, None, "quadrotor2d", {**REST_MPPI, "LBD": 3.0, "SQRTRHOINV": 0.08,
                                             "bounded_update": True}, 250,
                    REST_ATTRS["quadrotor2d"], {}),
    # tests/test_car.py:50-66
    "car": (3, [0.0] * 4, "car", {**REST_MPPI, "LBD": 2.0, "SQRTRHOINV": 0.15}, 300,
            REST_ATTRS["car"], {}),
    # tests/test_obstacle_cost.py:96-136
    "car_obstacles": (0, [0.0] * 4, "car_obstacles",
                      {**REST_MPPI, "mpc_horizon": 60, "num_rollouts": 1024, "LBD": 2.0,
                       "SQRTRHOINV": 0.2}, 400,
                      {"target_x": 2.5, "target_y": 0.0, **CAR_OBSTACLE},
                      {"obstacle_weight": 400.0, "clearance": 0.2}),
    # tests/test_arm2.py:104-122
    "arm2": (3, [0.0] * 4, "arm2", {**REST_MPPI, "LBD": 3.0, "SQRTRHOINV": 0.25}, 200,
             REST_ATTRS["arm2"], {}),
}
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
    """One phase's numbers, a dict with the seconds since the script started."""
    if isinstance(numbers, dict):
        numbers = {**numbers, "at_s": time.perf_counter() - T0}
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
    got = kernel_fn()
    ref, plain_ms = plain_timed(plain_fn)
    if reduce is not None:
        got, ref = reduce(got), reduce(ref)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    numbers = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / ref.abs().clamp_min(1e-6)).max()),
        "finite": bool(torch.isfinite(got).all()),
        "ms": cuda_ms(kernel_fn, 50),
        "plain_ms": plain_ms,
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
    cost, dQ = kernel_fn()
    (ref_cost, ref_dQ), plain_ms = plain_timed(plain_fn)
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
        "plain_ms": plain_ms,
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
                       spec: str = "ODE", config=None, value=None, cpu: MPCController = None,
                       s_now=None) -> None:
    """Phases 10, 17 and 26: one rpgd-tf update on the card and on the CPU
    (the plain versions) from the card's state and params, on a resample
    tick, with one draw; ``value`` as update_vs_cpu_mppi's.

    Adam's step from zero moments is about lr * sign(g) whatever |g|: where
    a gradient entry and its moments' history are both within the dQ
    bound's absolute part of 0 (DQ_ATOL_FRAC of max|g|), the function does
    not determine that step, and the two devices may move the row apart by
    up to 2 lr.  A row of the population whose Q differs beyond the bound
    must be such a row, and at most UNDETERMINED_MAX of K may differ; the
    costs and moments of every other row are held to the bound.  Another
    plant's controller passes its CPU twin ``cpu`` and its state ``s_now
    [1, S]``; its plants have selects (clips, hinges, the 3-D quadrotor's
    secant clamp), so a row whose gradient the card and the CPU put further
    apart than K7's bound (a select decided by a rounding) is undetermined
    too, as grad_fleet_update_vs_cpu counts it."""
    opt = ctrl.optimizer
    state = opt.opt_state
    check(state.count % opt.resamp_per == 0, f"tick {state.count} is not a resample tick")
    plant_given, K = cpu is not None, opt.num_rollouts
    if s_now is None:
        s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    draw = opt.sample_resample(state)
    params = ctrl._assemble_params()
    u, new, diag = opt.update(state, s_now, params, draw)

    if cpu is None:
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
    kinks = 0
    if plant_given:
        kink = ((g - g_c).abs() > DQ_RTOL * g_c.abs() + noise).flatten(1).any(1)
        kinks = int(kink.sum())
        undetermined |= kink
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
                    "undetermined_rows": int(undetermined.sum()), "kink_rows": kinks,
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
    of its input and of its hidden, widths padded to 8; the head's output
    tiles (one; the 3-D quadrotor's two) times its k-blocks."""
    gates = 3 if kind == "gru" else 4
    tiles = sum(gates * -(-hd // 8) * (-(-d_in // 8) + -(-hd // 8)) for d_in, hd in rnn_cells(net))
    return tiles + -(-net["wo"].shape[0] // 8) * -(-net["wo"].shape[1] // 8)


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
                  instance=CART,
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
    cost, dQ = neural_grad_cost_rollout(model, s0, Q, pvec, net)
    (ref_cost, ref_dQ), plain_ms = plain_timed(
        lambda: neural_grad_cost_rollout_plain(model, s0, Q, pvec, net))
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
        "plain_ms": plain_ms,
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


# The mangled template argument of cartpole's cost: K11's, K13's, K14's
# and K10's entries are instances over each cost (phase 92's COST_MANGLED
# names the others'), so cartpole's are picked by it.
CART = "12CartpoleCostE"


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
    functions = sass_functions()
    if functions is None:
        return None
    return {fn: sum("HMMA" in line for line in lines) for fn, lines in functions.items()}


def cuobjdump_tool() -> str | None:
    tool = shutil.which("cuobjdump") or str(Path(kernels._nvcc()).parent / "cuobjdump")
    return tool if Path(tool).is_file() else None


# The built library's disassembly, started as soon as it is built (phase
# 1) so that it runs beside the first phases (it reads the whole library,
# the plants' residual and value instances among it): one cuobjdump a
# cubin (a source's object), all at once, each into a file of its own.
_SASS_PENDING = {}


def start_sass(library=None) -> None:
    """Start ``cuobjdump -sass`` of the built library (or ``library``) in
    the background, one process for each cubin it holds (``-xelf all``;
    the whole library where none is found); sass_functions collects it."""
    tool, lib = cuobjdump_tool(), str(library or kernels.library_path())
    if tool is None or lib in _SASS_PENDING:
        return
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    where = Path(tempfile.mkdtemp(prefix="sass_", dir=kernels.BUILD_DIR))
    subprocess.run([tool, "-xelf", "all", lib], cwd=where, capture_output=True)
    jobs = []
    for i, cubin in enumerate(sorted(where.glob("*.cubin")) or [Path(lib)]):
        out = open(where / f"{i}.sass", "w+")
        jobs.append((subprocess.Popen([tool, "-sass", str(cubin)], stdout=out,
                                      stderr=subprocess.DEVNULL), out))
    _SASS_PENDING[lib] = (where, jobs)


def sass_functions(library=None) -> dict | None:
    """Each entry function's SASS lines (``cuobjdump -sass`` of the built
    library, or ``library``), by mangled name; None without cuobjdump."""
    tool = cuobjdump_tool()
    if tool is None:
        return None
    return _sass_functions(tool, str(library or kernels.library_path()))


@functools.lru_cache(maxsize=None)
def _sass_functions(tool: str, library: str) -> dict:
    """One disassembly of a library a run, split by function."""
    start_sass(library)
    where, jobs = _SASS_PENDING[library]
    out = {}
    for proc, dump in jobs:
        fn = None
        if proc.wait() != 0:
            raise RuntimeError(f"cuobjdump -sass {library} failed ({proc.returncode})")
        dump.seek(0)
        for line in dump:
            named = re.search(r"Function : (\S+)", line)
            if named:
                fn = named.group(1)
                out[fn] = []
            elif fn:
                out[fn].append(line.rstrip("\n"))
        dump.close()
    shutil.rmtree(where, ignore_errors=True)
    return out


def sass_loops(kernel: str, instance: str = "", library=None):
    """The loops of ``kernel``'s entry function in its SASS: for each
    backward branch, its body's first and last address, its instructions
    and the MUFU (special-function unit) instructions in it by kind; also
    the function's instruction count.  None without cuobjdump."""
    functions = sass_functions(library)
    if functions is None:
        return None
    found = {}
    for fn, lines in functions.items():
        if re.search(entry_pattern(kernel, instance), fn):
            found[fn] = []
            for line in lines:
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
                  instance=CART + ("Li3E" if model.kind == "gru" else "Li4E"))
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
    cost, dQ = residual_grad_cost_rollout(model, s0, Q, pvec, net)
    (ref_cost, ref_dQ), plain_ms = plain_timed(
        lambda: residual_grad_cost_rollout_plain(model, s0, Q, pvec, net))
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
        "plain_ms": plain_ms,
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
    numbers["resources"] = {**ptxas_resources("gp_cost_rollout_kernel", f"{CART}Li{lanes}E"),
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
    numbers["resources"] = {**ptxas_resources("gp_grad_cost_rollout_kernel", f"{CART}Li{lanes}E"),
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
    (atol + rtol |x|) / (H+1); zero without a value term (``post`` None)."""
    if post is None:
        return torch.zeros(x.shape[0])
    x = x.detach()
    with torch.enable_grad():
        xg = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(post(xg, cost_params).sum(), xg)
    return (g.abs() * (X_TOL["atol"] + X_TOL["rtol"] * x.abs())).sum(1) / (horizon + 1)


def update_vs_cpu_cem(name: str, ctrl: MPCController, config: dict, spec: str = "ODE",
                      value=None, cpu: MPCController = None, s_now=None,
                      tol: dict = KERNEL_TOL) -> None:
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
    reaches ~8e4 a unit of state).  Another plant's controller passes its
    CPU twin ``cpu`` and a state ``s_now [1, S]``; a recurrent net's costs
    take ``tol`` (RNN_TOL) in place of the kernel's bound."""
    opt = ctrl.optimizer
    state = opt.opt_state
    if s_now is None:
        s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    draws = opt.sample_draws(state)
    params = ctrl._assemble_params()
    if cpu is None:
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
        slack = tol["atol"] + tol["rtol"] * float(kth.abs())
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
                    <= tol["atol"] + tol["rtol"] * cost_c.abs() + slack).all()),
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


def fleet_inputs_now(ctrl: BatchedMPCController, gen, s=None) -> tuple:
    """The fleet's current state and params on the card: per-session
    states near upright (or ``s [B, 1, S]``), the slots' pole lengths (per-slot
    constants) and targets."""
    B, device = ctrl.num_slots, ctrl.device
    if s is None:
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


def fleet_update_vs_cpu(mppi: BatchedMPCController, cem: BatchedMPCController, gen,
                        cpus: tuple = None, s=None, per_slot_dyn=("L",),
                        name: str = "fleet_update_vs_cpu") -> None:
    """Phase 39: one fleet update on the card against the same update on the
    CPU (the plain versions), from the state each loop left and with the
    same draws.  MPPI: costs to the kernel bound, the new plans to
    UNOM_ATOL.  CEM, outer iteration by outer iteration from the card's
    distribution: costs to the kernel bound, the card's elites (its own
    top-k) a top-k of the CPU's costs within that bound, the refit from
    them to UNOM_ATOL; then the whole update, where the elite sets agreed.
    Another plant's fleets pass their CPU twins ``cpus``, the states ``s
    [B, 1, S]`` and their ``per_slot_dyn``."""
    B = mppi.num_slots
    opt = mppi.optimizer
    psd, s_given = per_slot_dyn, s
    s, dyn, cost, attrs = fleet_inputs_now(mppi, gen, s_given)
    eps = opt.sample_slot_noise(mppi.slot_states.generator, np.ones(B, bool))
    _, update = opt._make_batched_semi_fused_step(B, per_slot_dyn=psd)
    cpu = cpus[0] if cpus else fleet_controller("cpu", "mppi", FLEET_MPPI_CONFIG, B)
    _, update_c = cpu.optimizer._make_batched_semi_fused_step(B, per_slot_dyn=psd)
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
    s, dyn, cost, attrs = fleet_inputs_now(cem, gen, s_given)
    seeds = copt.sample_slot_seeds(cem.slot_states.generator, np.ones(B, bool))
    model, _ = ode.rollout_model(copt)
    fast = model.fast_math
    _, slot_keys = split_slot_keys(model.param_keys, psd)
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
        elite = regen_cols(seed_b, idx, mue, std, low, high, K, fast=fast)
        elite_c = regen_cols(seed_b.cpu(), idx.cpu(), mue.cpu(), std.cpu(), low.cpu(),
                             high.cpu(), K, fast=fast)
        mue, std = elite.mean(1), elite.std(1, correction=0)
        mue_c, std_c = elite_c.mean(1), elite_c.std(1, correction=0)
        for key, (a, b) in {"cost": (c, c_c), "mue": (mue, mue_c), "std": (std, std_c)}.items():
            errs[key] = max(errs[key], max_errors(a.cpu(), b)[0])
        errs["topk_excess"] = max(errs["topk_excess"], float(excess.max()))
    _, update = copt._make_batched_fused_cem_step(B, per_slot_dyn=psd)
    cpu = cpus[1] if cpus else fleet_controller("cpu", "cem-tf", FLEET_CEM_CONFIG, B)
    _, update_c = cpu.optimizer._make_batched_fused_cem_step(B, per_slot_dyn=psd)
    u, new, _ = update(st, s, dyn, cost, attrs, seeds)
    u_c, new_c, _ = update_c(state_to_cpu(st), s.cpu(), to_cpu(dyn),
                             to_cpu(cost), to_cpu(attrs), seeds.cpu())
    numbers.update({f"cem_{k}_max_abs_err" if k != "topk_excess" else "cem_topk_excess": v
                    for k, v in errs.items()})
    numbers.update({"cem_same_elite_sets": same_sets,
                    "cem_update_u_abs_err": max_errors(u.cpu(), u_c)[0],
                    "cem_update_mue_max_abs_err": max_errors(new.dist_mue.cpu(),
                                                             new_c.dist_mue)[0]})
    emit(name, numbers)
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
    """Each session-row form's wrong arithmetic, by the form itself over
    wrong operands (the kernel is held to its plain version on the right
    ones): every session reading the next session's row of pvec_b; for the
    recurrent nets every session starting from slot 0's hidden; for
    "ODE+res" the slots' pole lengths rolled by one."""
    model, s0, Q, pvec_b, weights, *hidden = args
    kernel = COLS_KERNELS[kind][0]
    out = {"next_session_row": kernel(model, s0, Q, pvec_b.roll(-1, 0), weights, *hidden)}
    if hidden:
        out["hidden_of_slot_0"] = kernel(model, s0, Q, pvec_b, weights,
                                         tuple(h[:1].expand_as(h).contiguous()
                                               for h in hidden[0]))
    if kind == "residual":
        col = model.param_keys.index("d_L")
        rolled = pvec_b.clone()
        rolled[:, col] = pvec_b[:, col].roll(1)
        out["L_rolled"] = kernel(model, s0, Q, rolled, weights)
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
        return {**ptxas_resources("gp_cost_rollout_kernel", f"{CART}Li{lanes}E"),
                "lanes": lanes, "threads_per_block": threads, "blocks_per_sm": blocks}
    hidden = args[5] if len(args) > 5 else None
    net_args = model.net_args(weights, hidden, args[3].shape[0])[0] if hidden else (
        model.net_args(weights)[0])
    kernel, occupancy, instance = {
        "mlp": ("neural_cost_rollout_kernel", "neural", CART),
        "gru": ("recurrent_cost_rollout_kernel", "recurrent", CART + "Li3E"),
        "lstm": ("recurrent_cost_rollout_kernel", "recurrent", CART + "Li4E"),
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
        return {**ptxas_resources("gp_grad_cost_rollout_kernel", f"{CART}Li{lanes}E"),
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
    reading the next session's row (the form's own over the rolled rows);
    its time at each of GRAD_COLS_SHAPES and its bounds there; its resources.  The kernels
    line takes its time and its plain version's at the shape of the
    fleet's closed loop."""
    cols, plain = GRAD_COLS[form][:2]
    args = grad_cols_operands(form, ctrl, GRAD_COLS_B, GRAD_COLS_KS, gen)
    got, ref = cols(*args), plain(*args)
    mutant = cols(*args[:3], args[3].roll(-1, 0), *args[4:])
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
            row = {"ms": timed[f"B{B}_K{ks}"]["ms"],
                   "plain_ms": plain_timed(lambda: plain(*targs))[1],
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


def grad_fleet_update_vs_cpu(label: str, ctrl: BatchedMPCController, gen,
                             cpu: BatchedMPCController = None, s=None,
                             per_slot_dyn=None) -> None:
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
    other row are held to that bound.  Another plant's fleet passes its CPU
    twin ``cpu``, the states ``s [B, 1, S]`` and its ``per_slot_dyn``; its
    plants have selects (clips, hinges, the 3-D quadrotor's secant clamp), so
    a row whose gradient at the start the card and the CPU put further apart
    than K7's bound (a select decided by a rounding) is undetermined too, and
    its update is one Adam iteration, which that gradient decides."""
    B, opt = ctrl.num_slots, ctrl.optimizer
    K, Hf, U = opt.num_rollouts, opt.mpc_horizon, opt.num_control_inputs
    s, dyn, cost, attrs = fleet_inputs_now(ctrl, gen, s)
    if cpu is None and GRAD_FLEETS[label][5] == "gp":
        dyn = {"gp": well_conditioned_gp(dyn["gp"])}
    rpgd = label.startswith("rpgd")
    build = "_make_batched_rpgd_step" if rpgd else "_make_batched_gradient_step"
    psd = GRAD_FLEETS[label][3] if per_slot_dyn is None else per_slot_dyn
    st = ctrl.slot_states
    draws = [None] * B if rpgd else opt.sample_slot_tails(st.generator, np.ones(B, bool))
    if cpu is None:
        cpu = grad_fleet("cpu", label, B)
    u, new, costs = getattr(opt, build)(B, per_slot_dyn=psd)[1](st, s, dyn, cost, attrs, draws)
    u_c, new_c, costs_c = getattr(cpu.optimizer, build)(B, per_slot_dyn=psd)[1](
        state_to_cpu(st), s.cpu(), to_cpu(dyn), to_cpu(cost), to_cpu(attrs),
        draws if rpgd else draws.cpu())
    gcall, _, pack = cpu.optimizer._bind_batched_grad_kernels(B, per_slot_dyn=psd)
    g_c = gcall(s.cpu()[:, 0].repeat_interleave(K, dim=0), st.Q.cpu().reshape(B * K, Hf, U),
                pack(st.u_prev.cpu(), to_cpu(dyn), to_cpu(cost), to_cpu(attrs)),
                to_cpu(dyn), to_cpu(cost))[1].reshape(B * K, -1)
    noise = DQ_ATOL_FRAC * float(g_c.abs().max())
    v0 = st.adam.v.cpu().reshape(B * K, -1)
    undetermined = ((g_c.abs() <= noise) & (v0.sqrt() <= noise)).any(1)
    kinks = 0
    if per_slot_dyn is not None:
        gcall_card, _, pack_card = opt._bind_batched_grad_kernels(B, per_slot_dyn=psd)
        g = gcall_card(s[:, 0].repeat_interleave(K, dim=0), st.Q.reshape(B * K, Hf, U),
                       pack_card(st.u_prev, dyn, cost, attrs), dyn, cost)[1]
        kink = ((g.cpu().reshape(B * K, -1) - g_c).abs() > DQ_RTOL * g_c.abs() + noise).any(1)
        kinks = int(kink.sum())
        undetermined |= kink
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
               "undetermined_rows": int(undetermined.sum()), "kink_rows": kinks,
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
        numbers["tc_bound_ms"], instance=CART,
        extra={"group_warps": group_warps, "groups_per_block": groups,
               "blocks_per_member": -(-(K // net["w0"].shape[0]) // (16 * groups)),
               "k11_single_net": ptxas_resources("neural_cost_rollout_kernel", CART)})
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
    cost, dQ = neural_grad_cost_rollout_ens(model, s0, Q, pvec, net)
    (ref_cost, ref_dQ), plain_ms = plain_timed(
        lambda: neural_grad_cost_rollout_ens_plain(model, s0, Q, pvec, net))
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
        "plain_ms": plain_ms,
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
                 ragged: tuple, n_bytes: float, ops: float, tol=KERNEL_TOL,
                 x_f64: bool = False) -> dict:
    """Phases 54 and 59: an emit_terminal form ``emit_fn(*args) -> (cost,
    x_H)`` against its plain version ``plain_fn`` on the same card tensors:
    its costs equal, bit for bit, to the kernel's ``unvalued_fn(*args)``
    (the same body), to the kernel's bound ``tol`` of its plain version;
    x_H to X_TOL, a bound that must reject x_{H-1} emitted in
    its place (``plain_fn(*prev_args)``'s terminal states: the horizon one
    step shorter) and rollout k+1's x_H, each by VALUE_MARGIN times its
    absolute part; both again at the ``ragged`` operands; its time, the
    kernel's and the plain version's.  ``x_f64``: x_H held to float64
    instead (f64_held: no further from the float64 plain version than
    GP_F64_FACTOR times the float32 plain version is), the bound rejecting
    the same wrong variants: for a kernel whose float32 plain version
    drifts from float64 as far as the kernel does (K13-GRU's 50 steps,
    k13_emit_vs_float64), X_TOL would hold two such drifts to each other."""
    (cost, x), cost_k = emit_fn(*args), unvalued_fn(*args)
    (ref_cost, ref_x), plain_ms = plain_timed(lambda: plain_fn(*args))
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
        "plain_ms": plain_ms,
        **bound(ops, n_bytes)}
    numbers["max_abs_err"] = max(numbers["cost_max_abs_err"], numbers["x_max_abs_err"])
    if x_f64:
        x64, gx64 = plain_fn(*tree64(args))[1], plain_fn(*tree64(ragged))[1]
        numbers["x_f64"] = held = f64_held(x, ref_x, x64)
        numbers["ragged"]["x_f64"] = f64_held(gx, rx, gx64)
        held["rejects"] = {k: f64_err(m, x64) for k, m in mutants.items()}
    emit(label, numbers)
    check(numbers["finite"] and x.shape == ref_x.shape, f"{label}: bad output")
    check(numbers["costs_equal_to_kernel"] and numbers["ragged"]["equal_to_kernel"],
          f"{label}: its costs are not the kernel's {numbers}")
    for got, ref, xs, xr in ((cost, ref_cost, x, ref_x), (gc, rc, gx, rx)):
        check(torch.allclose(got, ref, **tol)
              and (x_f64 or torch.allclose(xs, xr, **X_TOL)),
              f"{label}: disagrees with its plain version {numbers}")
    if x_f64:
        check(held["held"] and numbers["ragged"]["x_f64"]["held"],
              f"{label}: x_H further from float64 than its bound {numbers}")
        for k, err in held["rejects"].items():
            check(err >= VALUE_MARGIN * held["bound"],
                  f"{label}: the x_H bound does not reject {k} by {VALUE_MARGIN}x {numbers}")
        return numbers
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
    got = grad_cost_rollout_value(model, s0, Qg, pvec, ops)
    ref, plain_ms = plain_timed(lambda: grad_cost_rollout_plain(model, s0, Qg, pvec, ops))
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
        "plain_ms": plain_ms,
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
    "k11": ("neural_cost_rollout", CART), "k11_ens": ("neural_cost_rollout_ens", CART),
    "k12": ("residual_cost_rollout", ""), "k13_gru": ("recurrent_cost_rollout", CART + "Li3E"),
    "k13_lstm": ("recurrent_cost_rollout", CART + "Li4E"),
    "k14": ("gp_cost_rollout", CART + "Li4E")}
# The session-row emit forms: the form, its plain version and the
# single-session emit form each session is held to.
COLS_EMIT = {"mlp": (neural_cost_rollout_cols_emit, neural_cost_rollout_cols_emit_plain,
                     neural_cost_rollout_emit),
             "residual": (residual_cost_rollout_cols_emit, residual_cost_rollout_cols_emit_plain,
                          residual_cost_rollout_emit),
             "gp": (gp_cost_rollout_cols_emit, gp_cost_rollout_cols_emit_plain,
                    gp_cost_rollout_emit)}


def compare_learned_emit(label: str, emit_fn, kernel_fn, plain_fn, args: tuple, ragged_k: int,
                         tol: dict, ops: float, x_f64: bool = False) -> dict:
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
                        tol, x_f64)


def tree64(tree):
    """A tree (dicts, tuples, lists) of tensors in float64."""
    if isinstance(tree, dict):
        return {k: tree64(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree64(v) for v in tree)
    return tree.double() if torch.is_tensor(tree) else tree


def k13_emit_vs_float64(device) -> dict:
    """Phase 59's float64 analysis of K13-GRU's emit form (ROADMAP C): over
    FORMS_F64_SEEDS draws of phase 2's operands (K, H) from recurrent_operands'
    hidden (a generator of its own, so that no later phase's draws move),
    the kernel's x_H and its float32 plain version's against the float64
    plain version's (f64_held), beside X_TOL's check of the kernel against
    the float32 plain version."""
    gen = torch.Generator(device=device).manual_seed(SEED + 59)
    model, pvec, net, hidden = recurrent_operands(GRU_SPEC, gen, device)
    out = {}
    for seed in FORMS_F64_SEEDS:
        g = torch.Generator(device=device).manual_seed(SEED + 59 + seed)
        s0 = 0.05 * torch.randn(K, 4, generator=g, device=device)
        Q = torch.clamp(0.3 * torch.randn(K, H, 1, generator=g, device=device), -1.0, 1.0)
        x = recurrent_cost_rollout_emit(model, s0, Q, pvec, net, hidden)[1]
        xp = recurrent_cost_rollout_emit_plain(model, s0, Q, pvec, net, hidden)[1]
        x64 = recurrent_cost_rollout_emit_plain(model, *tree64((s0, Q, pvec, net, hidden)))[1]
        n = f64_held(x, xp, x64)
        n.update(x_max_abs_err=max_errors(x, xp)[0],
                 x_tol_held=bool(torch.allclose(x, xp, **X_TOL)),
                 x_tol_worst=float(((x - xp).abs() / (X_TOL["atol"] + X_TOL["rtol"] * xp.abs()))
                                   .max()))
        out[str(seed)] = n
    emit("k13_gru_emit_vs_float64", out)
    return out


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
    (ref_cost, ref_x), plain_ms = plain_timed(lambda: plain(*args))
    per = [single(*session_args(args, b)) for b in range(B)]
    wrong_cost = cols(model, s0, Q, pvec_b.roll(-1, 0), weights)[0]
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
        "plain_ms": plain_ms,
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


def f64_held(got, plain, ref64, unvalued=None, cap: float = None) -> dict:
    """gp_vs_float64's criterion: ``got`` no further from ``ref64`` than
    GP_F64_FACTOR times ``plain``'s distance from it, plus 1e-6 of its
    largest entry.  ``unvalued``: the same kernel's, plain version's and
    float64 plain version's outputs without V; where the kernel's own
    arithmetic is further from float64 than the plain version's (K8's
    3xTF32 products against cuBLAS's float32), that ratio scales the
    plain version's distance, which V amplifies alike in both; ``cap``
    bounds the ratio (its uncapped value kept beside it)."""
    n = {"f64_max_abs_err": f64_err(got, ref64), "plain_f64_max_abs_err": f64_err(plain, ref64),
         "max_abs": float(ref64.abs().max()), "kernel_ratio": 1.0}
    if unvalued is not None:
        k0, p0 = (f64_err(t, unvalued[2]) for t in unvalued[:2])
        ratio = max(1.0, k0 / max(p0, 1e-30))
        n.update(unvalued_f64_max_abs_err={"kernel": k0, "plain": p0},
                 kernel_ratio=ratio if cap is None else min(cap, ratio))
        if cap is not None:
            n["kernel_ratio_uncapped"] = ratio
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
        blocks = lib.ctt_gp_grad_value_layout(kernels.PLANT_IDS[args[0].plant],
                                              int(args[4]["Zs"].shape[0]), ctypes.byref(vargs),
                                              ctypes.byref(nbytes_))
    elif label == "k9":
        blocks = lib.ctt_residual_grad_value_layout(ctypes.byref(args[0].net_args(args[4])[0]),
                                                    ctypes.byref(vargs), ctypes.byref(nbytes_))
    else:
        ens = label == "k8_ens"
        net_args = args[0].net_args(args[4], members=args[4]["w0"].shape[0] if ens else 0)[0]
        blocks = lib.ctt_neural_grad_value_layout(kernels.PLANT_IDS[args[0].plant],
                                                  ctypes.byref(net_args), ctypes.byref(vargs),
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
    got_c = form(*args, committed)
    plain_c, plain_ms = plain_timed(lambda: plain(*args, committed))
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
    instance = f"{CART}Li{kernels.gp_layout(int(args[4]['Zs'].shape[0]), grad=True)[0]}E" \
        if label == "k10" else ""
    numbers.update({
        "ms": cuda_ms(lambda: form(*args, committed), 20),
        "kernel_ms": cuda_ms(lambda: kernel(*args), 20),
        "plain_ms": plain_ms,
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
    mutant = cols(*args[:3], args[3].roll(-1, 0), *args[4:], *vops)
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
                   "plain_ms": plain_timed(lambda: plain(*targs, *vops))[1],
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
                                 value: dict, cpu: MPCController = None, s_now=None) -> dict:
    """Phase 66: one valued gradient-tf update's Adam steps and scoring on
    the card against the CPU's (adam_steps_vs_cpu), from the card's state
    and params; another plant's controller (phase 96, with or without V)
    passes its CPU twin ``cpu`` and its state ``s_now [1, S]``."""
    opt = ctrl.optimizer
    state = opt.opt_state
    if s_now is None:
        s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    params = ctrl._assemble_params()
    if cpu is None:
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
    got, ex = as_tuple(fast_fn()), as_tuple(exact_fn())
    ref, plain_ms = plain_timed(plain_fn)
    ref = as_tuple(ref)
    torch.cuda.synchronize()
    errs = [max_errors(g, r)[0] for g, r in zip(got, ref)]
    numbers = {"max_abs_err": max(errs), "max_abs_errs": errs,
               "from_exact_max_abs": [max_errors(g, e)[0] for g, e in zip(got, ex)],
               "from_exact_max_rel": max_errors(got[0], ex[0])[1],
               "finite": all(bool(torch.isfinite(g).all()) for g in got),
               "ms": cuda_ms(fast_fn, reps), "exact_ms": cuda_ms(exact_fn, reps),
               "plain_ms": plain_ms, **bound(ops, n_bytes)}
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


def zoo_update_vs_cpu(name: str, ctrl: MPCController, config: dict, spec: str = "ODE",
                      cpu: MPCController = None, s_now=None) -> dict:
    """Phase 72, cem-gmm and the gradient CEMs: one update on the card and on
    the CPU (the plain versions) with the same draws, outer iteration by
    outer iteration from the card's carry (``iterate``), as
    update_vs_cpu_cem holds CEM: the costs to the kernel bound (the gradient
    CEMs score populations that the gradient step moved on each device),
    the card's elites a top-k of the CPU's costs within that bound, and,
    where both devices took the same elites in the same order, every
    refit quantity: the components and mixture weights, or the Gaussian, to
    UNOM_ATOL; the Adam moments and the kept elites to UPDATE_RTOL plus
    UPDATE_ATOL_FRAC of their largest entry.  Another plant's controller
    passes its CPU twin ``cpu`` and its state ``s_now [1, S]``."""
    opt = ctrl.optimizer
    state = opt.opt_state
    if s_now is None:
        s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    params = ctrl._assemble_params()
    carry, draws = ZOO_CARRY[name](opt, state, opt.sample_draws(state))
    copt = (cpu or make_controller("cpu", name, config, spec=spec)).optimizer
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


def fleet_var_update_vs_cpu(ctrl: BatchedMPCController, gen, cpu: BatchedMPCController = None,
                            s=None, per_slot_dyn=("L",),
                            name: str = "fleet_var_update_vs_cpu") -> dict:
    """Phase 72, the mppi-var fleet: one batched update on the card against
    the CPU's (the plain versions) from the loop's state, every slot
    drawing: costs to the kernel bound, the plans to UNOM_ATOL, each
    session's sigma within ``var_sigma_bound``.  Another plant's fleet
    passes its CPU twin ``cpu``, the states ``s [B, 1, S]`` and its
    ``per_slot_dyn``."""
    B, opt = ctrl.num_slots, ctrl.optimizer
    s, dyn, cost, attrs = fleet_inputs_now(ctrl, gen, s)
    raw = opt._slot_normals(ctrl.slot_states.generator, np.ones(B, bool))
    _, update = opt._make_batched_var_step(B, per_slot_dyn=per_slot_dyn)
    if cpu is None:
        cpu = fleet_controller("cpu", "mppi-var-tf", FLEET_VAR_CONFIG, B)
    _, update_c = cpu.optimizer._make_batched_var_step(B, per_slot_dyn=per_slot_dyn)
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
    emit(name, numbers)
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
                     attrs: dict = None, cost_config: dict = None,
                     device: str = "cuda") -> MPCController:
    """An ``mpc`` controller on the card (or ``device``) over a PLANT_CASES or
    REST_CASES plant (its environment, its control limits, cost and
    predictor, ``spec`` in place of the predictor), under ``attrs`` (the
    point mass: PM_ATTRS, the plants of REST_CASES: REST_ATTRS) and
    ``cost_config``."""
    env, cost, pred = ALL_CASES[plant]
    if attrs is None:
        attrs = PM_ATTRS if env == "pointmass" else REST_ATTRS.get(plant.replace("_fast", ""), {})
    limits = (ENVS[env].action_low, ENVS[env].action_high)
    ctrl = MPCController(env, limits, dict(attrs),
                         config={"optimizer": optimizer, "controller_logging": False,
                                 "device": device, "cost_function_specification": cost})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec or pred,
                   optimizer_config=dict(config), cost_function_config=dict(cost_config or {}))
    return ctrl


def plant_states(plant: str, k: int, gen) -> torch.Tensor:
    """Seeded start states on the card: the pendulum around hanging, the
    acrobot around rest, the point mass over the obstacles' margins."""
    env, dev = ALL_CASES[plant][0], gen.device
    if env == "pendulum":
        return torch.stack([math.pi + 0.8 * torch.randn(k, generator=gen, device=dev),
                            2.0 * torch.randn(k, generator=gen, device=dev)], 1)
    if env in ("acrobot", "arm2"):
        return 0.6 * torch.randn(k, 4, generator=gen, device=dev)
    if env in ("quadrotor2d", "quadrotor3d"):  # around hover; pitches past the secant clamp
        S = 6 if env == "quadrotor2d" else 12
        x = 0.3 * torch.randn(k, S, generator=gen, device=dev)
        x[:, 1 if S == 6 else 2] += 1.0
        if S == 12:
            x[:, 7] = 3.2 * torch.rand(k, generator=gen, device=dev) - 1.6
        return x
    if env == "car":  # the first (K2's and K3's start) inside car/obstacles' first margin
        x = torch.cat([1.2 * torch.rand(k, 2, generator=gen, device=dev) - 0.6,
                       torch.randn(k, 1, generator=gen, device=dev),
                       2.0 * torch.rand(k, 1, generator=gen, device=dev)], 1)
        x[0, :2] = torch.tensor([0.1, -0.05], device=dev)
        return x
    return torch.cat([1.2 * torch.rand(k, 2, generator=gen, device=dev) - 0.6,
                      torch.randn(k, 2, generator=gen, device=dev)], 1)


def plant_mutants(plant: str, model, pvec) -> dict:
    """The plant's named wrong variant as ``(model, pvec, swap)``: a plain
    version over it must fall outside the kernel's bound.  ``swap``
    exchanges the controls' columns (the point mass's two inputs)."""
    base = ALL_CASES[plant][0]
    if base in ("quadrotor2d", "quadrotor3d", "car", "arm2"):
        return rest_mutants(plant, model, pvec)
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


def rest_mutants(plant: str, model, pvec) -> dict:
    """The named wrong variants of the quadrotor, car and arm plants, as
    plant_mutants gives them: the planar quadrotor's pitch acceleration
    with its sign flipped (t1 - t2), the 3-D quadrotor's roll and pitch
    torques swapped, the car's tan(steer) read as sin(steer), an obstacle
    of car/obstacles dropped, the arm's damping b dropped."""
    base, derivs = ALL_CASES[plant][0], model.derivs
    sin = fast_sin if plant.endswith("_fast") else torch.sin
    if base == "arm2":
        p = dict(model.unpack(pvec))
        p["d_b"] = torch.zeros_like(p["d_b"])
        return {"damping_dropped": (model, torch.stack([p[k] for k in model.param_keys]), False)}
    if plant.startswith("car_obstacles"):
        p = dict(model.unpack(pvec))
        p["a_obs0_r"], p["a_obs0_x"] = torch.zeros_like(p["a_obs0_r"]), p["a_obs0_x"] + 1e6
        return {"obstacle_dropped": (model, torch.stack([p[k] for k in model.param_keys]),
                                     False)}

    if base == "quadrotor2d":
        def wrong(xs, us, p):  # alpha = (t1 - t2) * arm / I
            d = derivs(xs, us, p)
            return (*d[:5], -d[5])

        name = "alpha_sign_flipped"
    elif base == "quadrotor3d":
        def wrong(xs, us, p):  # the roll torque arm (t3 - t1), the pitch torque arm (t2 - t4)
            d = derivs(xs, us, p)
            t = [u * p["d_u_max"] for u in us]
            tx, ty = p["d_arm"] * (t[1] - t[3]), p["d_arm"] * (t[2] - t[0])
            return (*d[:9], d[9] + (ty - tx) / p["d_Ix"], d[10] + (tx - ty) / p["d_Iy"], d[11])

        name = "roll_pitch_torques_swapped"
    else:
        def wrong(xs, us, p):  # yaw rate v sin(steer) / wheelbase
            d = derivs(xs, us, p)
            yawd = xs[3] * sin(us[0] * p["d_steer_max"]) / p["d_wheelbase"]
            return (d[0], d[1], yawd, d[3])

        name = "tan_steer_read_as_sin"
    return {name: (dataclasses.replace(model, derivs=wrong), pvec, False)}


def plant_resources(plant: str) -> dict:
    """ptxas' registers, spills and static shared memory of the plant's
    instance of K1, K2, K3's pass 1 and K7's two launches, and the blocks an
    SM holds of each."""
    lib, pid = kernels.load(), kernels.PLANT_IDS[plant]
    name = "".join(w.capitalize() for w in plant.replace("obstacles", "obstacle").split("_"))
    name = name.replace("2d", "2D").replace("3d", "3D")
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
    dynamics' du[1] dropped (the adjoint's second control column); for the
    3-D quadrotor, du[3] (the fourth rotor's)."""
    if plant.startswith("pointmass"):
        col = 1
    elif plant.startswith("quadrotor3d"):
        col = 3
    else:
        return {}
    p, dvjp = model.unpack(pvec), PLANT_ADJOINTS[plant][0]
    one_step = make_soa_stepper(model.derivs, model.integrator, model.dt,
                                model.intermediate_steps)

    def dropped(xs, us, pp, lam):
        dx, du = dvjp(xs, us, pp, lam)
        return dx, tuple(torch.zeros_like(d) if j == col else d for j, d in enumerate(du))

    def step(x, u):
        return torch.stack(one_step(tuple(x.unbind(1)), tuple(u.unbind(1)), p), dim=1)

    def step_vjp(xs, us, lam):
        return integrator_vjp(model.derivs, dropped, xs, us, p, lam, model.integrator == "rk4",
                              model.intermediate_steps, model.dt)

    return {f"du{col}_dropped": plain_grad_loop(model, s0, Q, pvec, step, step_vjp)[1]}


def plant_kernels(plant: str, gen, cartpole: dict) -> dict:
    """Phase 74 for one plant: its K1, K2, K3 pass-1 (and fast-normals) and
    K7 instances against their plain versions, each plain version run and
    timed once (compare_once, plain_timed); returns each kernel's numbers
    for the ``kernels`` line."""
    ctrl = plant_controller(plant, "mppi", OPTIMIZER_CONFIG)
    opt = ctrl.optimizer
    model, pack = ode.rollout_model(opt)
    check(model.plant == plant and ode.can_use_grad(opt), f"{plant}: not the device plant")
    S, U = kernels.PLANT_DIMS[plant]
    dev = gen.device
    pvec = pack(ctrl._assemble_params(), torch.full((U,), 0.1, device=dev))
    s0 = plant_states(plant, K, gen)
    lo, hi = opt.action_low, opt.action_high
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)  # 0 and 1 for controls in [-1, 1]
    Q = torch.clamp(mid + half * (0.5 * torch.randn(K, H, U, generator=gen, device=dev)), lo, hi)
    rk4_ops, stage_ops, vjp_ops, stage_vjp_ops = PLANT_OPS[plant.replace("_fast", "")]
    mutants = plant_mutants(plant, model, pvec)
    out = {}

    def sw(q, swap):
        return q.flip(-1).contiguous() if swap else q

    # K1, at the main path's shapes, ragged K and H = PLANT_ODD_H.
    k1, got, _ = compare_once(f"k1_{plant}", lambda: cost_rollout(model, s0, Q, pvec),
                              lambda: cost_rollout_plain(model, s0, Q, pvec), (K,))
    out["cost_rollout"] = k1
    k1.update(bound(K * H * (rk4_ops + stage_ops), nbytes(s0, Q, pvec) + 4 * K))
    # A variant of the operands alone (controls swapped, a cost term
    # dropped) is the kernel itself over them; one of the model's code, its
    # plain version's.
    k1["rejects"] = rejects(f"k1_{plant}", got, {
        n: (cost_rollout if m is model else cost_rollout_plain)(m, s0, sw(Q, swap), pv)
        for n, (m, pv, swap) in mutants.items()})
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
    u_nom = torch.clamp(mid + half * (0.3 * torch.randn(H, U, generator=gen, device=dev)), lo,
                        hi)
    lim = (opt.action_low, opt.action_high)
    corr = (opt.cc_weight, opt.R, opt.NU)
    args = (model, s0[0].contiguous(), u_nom, pvec, eps, opt.interp.matrix, *lim, *corr)
    k2, got, _ = compare_once(f"k2_{plant}", lambda: mppi_cost(*args),
                              lambda: mppi_cost_plain(*args), (K,))
    out["mppi_cost"] = k2
    k2.update(bound(K * H * (rk4_ops + stage_ops + U * MPPI_EXTRA_OPS),
                    nbytes(*args[1:8]) + 4 * K))
    k2["rejects"] = rejects(f"k2_{plant}", got, {
        n: (mppi_cost if m is model else mppi_cost_plain)(
            m, args[1], sw(u_nom, swap), pv,
            sw(eps.transpose(1, 2), swap).transpose(1, 2).contiguous(), *args[5:])
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
        k3, got, _ = compare_once(f"k3_{plant}{key[15:]}", lambda: fused_mppi_costs(*a),
                                  lambda: fused_mppi_costs_plain(*a), (K,))
        out[key] = k3
        k3.update(bound(K * (H * (rk4_ops + stage_ops + U * MPPI_EXTRA_OPS)
                             + P * U * (NORMAL_OPS + 1)), nbytes(*a[1:4], *a[5:8]) + 4 * K))
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
    Qg = lo + (hi - lo) * torch.rand(K, H, U, generator=gen, device=dev)
    cost, dQ = grad_cost_rollout(model, s0, Qg, pvec)
    (ref_cost, ref_dQ), k7_plain_ms = plain_timed(
        lambda: grad_cost_rollout_plain(model, s0, Qg, pvec))
    wrong = plant_grad_mutants(plant, model, s0, Qg, pvec)
    k7 = out["grad_cost_rollout"] = {
        "cost_max_abs_err": max_errors(cost, ref_cost)[0],
        "dQ_max_abs_err": max_errors(dQ, ref_dQ)[0], "dQ_max_abs": float(ref_dQ.abs().max()),
        "mutant_max_abs_err": {k: max_errors(m, ref_dQ)[0] for k, m in wrong.items()},
        "ms": cuda_ms(lambda: grad_cost_rollout(model, s0, Qg, pvec), 20),
        "plain_ms": k7_plain_ms,
        **bound(K * H * (rk4_ops + stage_ops + vjp_ops + stage_vjp_ops),
                nbytes(s0, Qg, pvec, Qg) + 4 * K)}
    k7["max_abs_err"] = max(k7["cost_max_abs_err"], k7["dQ_max_abs_err"])
    check(bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()), f"k7_{plant}: not finite")
    check(torch.allclose(cost, ref_cost, **KERNEL_TOL), f"k7_{plant}: cost disagrees {k7}")

    def dq_held(label, d, rd, s_, q_):
        """dQ to DQ_RTOL of the plain version's, the arm's to float64
        (F64_HELD_PLANTS): no further from the float64 plain version than
        GP_F64_FACTOR times the float32 plain version is."""
        if not plant.startswith(F64_HELD_PLANTS):
            check(close(d, rd, DQ_RTOL, DQ_ATOL_FRAC), f"{label}: dQ disagrees {k7}")
            return None
        held = f64_held(d, rd, grad_cost_rollout_plain(model, s_.double(), q_.double(),
                                                       pvec.double())[1])
        check(held["held"], f"{label}: dQ further from float64 than its bound {held}")
        return held

    k7["dQ_f64"] = dq_held(f"k7_{plant}", dQ, ref_dQ, s0, Qg)
    for k, m in wrong.items():
        check(not close(m, dQ, DQ_RTOL, DQ_ATOL_FRAC), f"k7_{plant}: the dQ bound takes {k}")
    s, q = s0[:PLANT_RAGGED_K].contiguous(), Qg[:PLANT_RAGGED_K, :PLANT_ODD_H].contiguous()
    (c, d), (rc, rd) = grad_cost_rollout(model, s, q, pvec), grad_cost_rollout_plain(model, s, q,
                                                                                      pvec)
    k7["cases"] = {f"K{PLANT_RAGGED_K}_H{PLANT_ODD_H}": max_errors(d, rd)[0]}
    check(torch.allclose(c, rc, **KERNEL_TOL), f"k7_{plant} ragged: disagrees")
    dq_held(f"k7_{plant} ragged", d, rd, s, q)
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
               start=None, dt: float = DT, seed: int = SEED, env_params=None,
               on_tick=None) -> tuple:
    """``ticks`` closed-loop ticks against the plant's environment (seed
    ``seed``, from ``start`` where given, its constants updated by
    ``env_params``), every kernel's launch count set to 0 just before and
    checked against ``expected`` (kernel -> launches) just after;
    ``on_tick(t, s, u, s_next)`` is called after each tick; returns the
    counts and the visited states."""
    env = ENVS[ALL_CASES[plant][0]](batch_size=1, dt=dt, seed=seed, params=env_params)
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
              and bool(np.all(u >= env.action_low)) and bool(np.all(u <= env.action_high)),
              f"{name}: tick {t}: bad control {u}")
        s_prev = s
        s, *_ = env.step(u)
        visited.append(s[0].copy())
        if on_tick is not None:
            on_tick(t, s_prev[0], u, s[0])
    counts = {kernel: wrapper.launches for kernel, wrapper in COUNTED.items()}
    check(counts == {kernel: expected.get(kernel, 0) for kernel in COUNTED},
          f"{name}: kernel launches {counts}, expected {expected}")
    check(kernels.build.count == builds and ctrl.optimizer._build_epoch == epoch,
          f"{name}: something was rebuilt during the loop")
    return counts, np.array(visited), {"ticks": ticks,
                                       "step_host_p50_ms": float(np.percentile(host_ms, 50)),
                                       "final_state": [float(v) for v in s[0]]}


def plant_paths() -> tuple:
    """The flagship-width paths of phases 75 and 78, label: (optimizer,
    config, launches a tick): MPPI's three forms and rpgd-tf, then the
    zoo."""
    its = RPGD_CONFIG["outer_its"]
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
    return mppi_paths, zoo_paths


def flagship_loops(plant: str, paths: dict, runs: dict) -> None:
    """PLANT_TICKS closed-loop ticks of each path over the plant at
    K=16384, H=50, counted from 0 (runs[plant] gains each loop's counts)."""
    T = PLANT_TICKS
    for label, (name, config, per_tick) in paths.items():
        c = plant_controller(plant, name, config)
        opt = c.optimizer
        fused = getattr(opt, "_can_fully_fuse", lambda: False)()
        check(ode.rollout_model(opt)[0].plant == plant and ode.can_use_cost(opt)
              and fused == (label == "mppi_fused")
              and (label != "mppi" or opt._uses_semi_fused())
              and (label != "mppi_bounded" or (opt.bounded_update
                                               and not opt._uses_semi_fused())),
              f"{plant} {label}: the controller did not take its kernel path")
        counts, _, numbers = plant_loop(f"slice_{plant}_{label}", c, plant, T,
                                        {k: n * T for k, n in per_tick.items()})
        emit(f"slice_{plant}_{label}", numbers)
        runs[plant].append(counts)


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
    mppi_paths, zoo_paths = plant_paths()
    for plant in PLANT_CASES:
        paths = dict(mppi_paths)
        if plant in ("pendulum", "acrobot", "pointmass"):
            paths.update(zoo_paths)
        flagship_loops(plant, paths, runs)
    T = PLANT_TICKS
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


def demo_criterion(label: str, v: np.ndarray) -> tuple:
    """``(met, numbers)``: the JAX test's criterion for REST_DEMOS'
    ``label`` over the loop's visited states ``v`` [ticks, S]."""
    if label == "quadrotor3d":  # the mean of the last 50 ticks, the final tilt
        mean = v[-50:].mean(axis=0)
        out = {"tail_mean_xyz": [float(a) for a in mean[:3]],
               "final_phi_theta": [float(v[-1, 6]), float(v[-1, 7])]}
        ok = (abs(mean[0] - 0.5) < 0.25 and abs(mean[1] + 0.3) < 0.25
              and abs(mean[2] - 1.5) < 0.25 and abs(v[-1, 6]) < 0.4 and abs(v[-1, 7]) < 0.4)
    elif label == "quadrotor2d":
        out = {"final_x_z_theta": [float(v[-1, 0]), float(v[-1, 1]), float(v[-1, 4])]}
        ok = abs(v[-1, 0] - 0.5) < 0.2 and abs(v[-1, 1] - 1.5) < 0.25 and abs(v[-1, 4]) < 0.4
    elif label == "car":
        out = {"best_distance": float(np.hypot(v[:, 0] - 2.0, v[:, 1] - 1.0).min())}
        ok = out["best_distance"] < 0.4
    elif label == "car_obstacles":
        out = {"min_obstacle_distance": float(np.hypot(v[:, 0] - 1.2, v[:, 1] - 0.15).min()),
               "best_distance": float(np.hypot(v[:, 0] - 2.5, v[:, 1]).min())}
        ok = out["min_obstacle_distance"] > 0.4 and out["best_distance"] < 0.5
    else:  # the fingertip (the default link lengths) to (0.6, 0.4)
        ex = 0.5 * np.sin(v[:, 0]) + 0.5 * np.sin(v[:, 0] + v[:, 2])
        ey = -0.5 * np.cos(v[:, 0]) - 0.5 * np.cos(v[:, 0] + v[:, 2])
        out = {"best_distance": float(np.hypot(ex - 0.6, ey - 0.4).min())}
        ok = out["best_distance"] < 0.12
    return bool(ok), out


def rest_plant_phases(gen, cartpole: dict) -> tuple:
    """Phases 77-79: the quadrotor2d, quadrotor3d, car and arm2 plants (ids
    8-17).  Returns each kernel row's numbers by (wrapper, plant) and the
    loops' launches by plant, as plant_phases does."""
    rows, runs = {}, {plant: [] for plant in REST_CASES}
    # 77. Each instance against its plain version.
    for plant in REST_CASES:
        for key, numbers in plant_kernels(plant, gen, cartpole).items():
            rows[key, plant] = numbers

    # 78. The flagship-width loops (rpgd-tf among them), the exact plants
    # also under the zoo and the quadrotors under MPPI's bounded_update.
    mppi_paths, zoo_paths = plant_paths()
    for plant in REST_CASES:
        paths = dict(mppi_paths)
        if plant.startswith("quadrotor"):
            paths["mppi_bounded"] = ("mppi", {**OPTIMIZER_CONFIG, "bounded_update": True},
                                     {"cost_rollout": 1})
        if plant in ("quadrotor2d", "quadrotor3d", "car", "arm2"):
            paths.update(zoo_paths)
        flagship_loops(plant, paths, runs)

    # 79. The JAX tests' closed loops, on their criteria, over optimizer
    # seeds DEMO_SEEDS: met under no fewer than demo_floor of them.
    for label, (seed, start, plant, cfg, ticks, attrs, cost_cfg) in REST_DEMOS.items():
        kernel = "cost_rollout" if cfg.get("bounded_update") else "mppi_cost"
        outs, passed = [], 0
        for opt_seed in DEMO_SEEDS:
            c = plant_controller(plant, "mppi", {**cfg, "seed": opt_seed}, attrs=attrs,
                                 cost_config=cost_cfg)
            counts, v, numbers = plant_loop(f"demo_{label}_seed{opt_seed}", c, plant, ticks,
                                            {kernel: ticks}, start=start, seed=seed)
            runs[plant].append(counts)
            ok, out = demo_criterion(label, v)
            passed += ok
            outs.append({"seed": opt_seed, "met": ok, "step_host_p50_ms":
                         numbers["step_host_p50_ms"], **out})
        floor = demo_floor(REST_DEMO_JAX_MET[label])
        emit(f"demo_{label}", {"met": passed, "of": len(DEMO_SEEDS), "floor": floor,
                               "jax_met": REST_DEMO_JAX_MET[label], "runs": outs})
        check(passed >= floor, f"demo_{label}: the JAX test's criterion met under {passed} "
                               f"seeds of {DEMO_SEEDS}, below the floor {floor} (the JAX "
                               f"package's: {REST_DEMO_JAX_MET[label]}): {outs}")
    launches = {plant: {kernel: sum(r[kernel] for r in rs) for kernel in COUNTED}
                for plant, rs in runs.items()}
    return rows, launches


# ---- the options (phases 80-84) -------------------------------------------------------------
OPTIONS_H, OPTIONS_TICKS, TURN_TICKS, LATENCY_TICKS = 35, 50, 50, 20
# mppi-optimize-tf in the port's config_defaults/config_optimizers.yml,
# the seed fixed; phase 81 holds it to the file.
MPPI_OPTIMIZE_CONFIG = {"seed": SEED, "mpc_timestep": DT, "mppi_LR": 0.02, "adam_beta_1": 0.4,
                        "adam_beta_2": 0.8, "adam_epsilon": 1.0e-7, "gradmax_clip": 1000,
                        "mpc_horizon": 35, "num_rollouts": 400, "cc_weight": 1.0, "R": 1.0,
                        "LBD": 100.0, "NU": 1000.0, "SQRTRHOINV": 0.02,
                        "period_interpolation_inducing_points": 10, "optim_steps": 10}
MPPI_OPTIMIZE_WIDE = {**MPPI_OPTIMIZE_CONFIG, "mpc_horizon": H, "num_rollouts": K}
# The policy plan on the card against the CPU's: OPTIONS_H plain rk4
# steps in float32 on each device (FMA contraction on the card).
PLAN_ATOL = 1e-4


def cartpole_policy(x, params):
    """A saturating linear cartpole policy for the warm start (phase 83)."""
    return torch.stack([4.0 * x[2] + x[3] - 0.8 * (x[0] - params["attrs"]["target_position"])
                        + 0.2 * x[1]])


def lone_grad(name: str, kernel_fn, plain_fn, Q, ops: float, n_bytes: float,
              cost_tol=KERNEL_TOL, mutants=None) -> dict:
    """Phase 80: a gradient kernel at one rollout (``Q [1, H, U]``) against
    its plain version on the same card tensors: J to ``cost_tol``, dQ to
    K7's bound (DQ_RTOL plus DQ_ATOL_FRAC of max|dQ|), which must reject
    each of ``mutants`` (wrong dQs by name); timed with its bound."""
    cost, dQ = kernel_fn()
    (ref_cost, ref_dQ), plain_ms = plain_timed(plain_fn)
    torch.cuda.synchronize()
    cost_abs, _ = max_errors(cost, ref_cost)
    dq_abs, _ = max_errors(dQ, ref_dQ)
    wrong = mutants(dQ) if mutants else {}
    numbers = {"cost_max_abs_err": cost_abs, "dQ_max_abs_err": dq_abs,
               "dQ_max_abs": float(ref_dQ.abs().max()),
               "dQ_atol": DQ_ATOL_FRAC * float(ref_dQ.abs().max()),
               "mutant_max_abs_err": {k: max_errors(m, ref_dQ)[0] for k, m in wrong.items()},
               "max_abs_err": max(cost_abs, dq_abs),
               "finite": bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()),
               "ms": cuda_ms(kernel_fn, 50), "plain_ms": plain_ms,
               **bound(ops, n_bytes)}
    emit(name, numbers)
    check(numbers["finite"] and cost.shape == (1,) and dQ.shape == Q.shape, f"{name}: bad output")
    check(torch.allclose(cost, ref_cost, **cost_tol), f"{name}: cost disagrees {numbers}")
    check(close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC), f"{name}: dQ disagrees {numbers}")
    for k, m in wrong.items():
        check(not close(m, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC),
              f"{name}: the dQ bound does not reject a dQ with {k} {numbers}")
    return numbers


def lone_rollout_kernels(gen) -> dict:
    """Phase 80: K7's forms and K8 at K=1, H=OPTIONS_H."""
    device = gen.device
    rows = {}
    specs = {"k7": ("cartpole", "ODE"), "k7_fast": ("cartpole", FAST_SPEC),
             "k7_pendulum": ("pendulum", "ODE")}
    for label, (plant, spec) in specs.items():
        c = (make_controller("cuda", "mppi", MPPI_OPTIMIZE_CONFIG, spec=spec)
             if plant == "cartpole" else plant_controller(plant, "mppi", MPPI_OPTIMIZE_CONFIG))
        model, pack = ode.rollout_model(c.optimizer)
        pvec = pack(c._assemble_params(), torch.tensor([0.1], device=device))
        s1 = (0.05 * torch.randn(1, 4, generator=gen, device=device) if plant == "cartpole"
              else plant_states(plant, 1, gen))
        Qn = torch.clamp(0.3 * torch.randn(1, OPTIONS_H, 1, generator=gen, device=device),
                         -1.0, 1.0)
        step_ops = ((RK4_STEP_OPS, STAGE_OPS, RK4_VJP_OPS, STAGE_VJP_OPS) if plant == "cartpole"
                    else PLANT_OPS[plant])
        ops, n_bytes = OPTIONS_H * sum(step_ops), nbytes(s1, Qn, pvec, Qn) + 4
        rows[label] = lone_grad(
            f"{label}_lone_rollout", lambda: grad_cost_rollout(model, s1, Qn, pvec),
            lambda: grad_cost_rollout_plain(model, s1, Qn, pvec), Qn, ops, n_bytes,
            mutants=(lambda dQ: stage_term_mutants(dQ, Qn, pvec, model))
            if plant == "cartpole" else None)
        if label == "k7":
            vops = seeded_value(device)
            rows["k7_value"] = lone_grad(
                "k7_value_lone_rollout",
                lambda: grad_cost_rollout_value(model, s1, Qn, pvec, vops),
                lambda: grad_cost_rollout_plain(model, s1, Qn, pvec, vops), Qn,
                ops + value_net_ops(), n_bytes + nbytes(*vops),
                mutants=lambda dQ: {"no_dV_in_seed": grad_cost_rollout_plain(
                    model, s1, Qn, pvec)[1]})
            cartpole = (s1, Qn)
    mlp = make_controller("cuda", "mppi", MPPI_OPTIMIZE_CONFIG, spec=MLP_SPEC)
    nmodel, npack = neural.net_model(mlp.optimizer)
    nparams = mlp._assemble_params()
    net, npvec = nparams["dyn"]["net"], npack(nparams, torch.tensor([0.1], device=device))
    s1, Qn = cartpole
    rows["k8"] = lone_grad(
        "k8_lone_rollout", lambda: neural_grad_cost_rollout(nmodel, s1, Qn, npvec, net),
        lambda: neural_grad_cost_rollout_plain(nmodel, s1, Qn, npvec, net), Qn,
        OPTIONS_H * (mlp_ops(net) + mlp_vjp_ops(net) + STAGE_OPS + STAGE_VJP_OPS),
        nbytes(s1, Qn, npvec, *leaves(net), Qn) + 4, cost_tol=NET_TOL)
    return rows


def no_autograd(run):
    """``run()`` with torch.autograd.grad refused: the refinement must take
    its kernel."""
    def refuse(*a, **k):
        raise AssertionError("torch.autograd ran on the refinement's path")

    grad = torch.autograd.grad
    torch.autograd.grad = refuse
    try:
        return run()
    finally:
        torch.autograd.grad = grad


def in_turns(name: str, ctrls: dict, ticks: int) -> dict:
    """``ticks`` closed-loop ticks of each controller of ``ctrls``, one of
    each in turn, each against its own CartpoleEnv(seed=SEED): the host
    p50/p99 of each controller's step."""
    envs = {k: CartpoleEnv(batch_size=1, dt=DT, seed=SEED) for k in ctrls}
    states = {k: env.reset()[0] for k, env in envs.items()}
    host = {k: [] for k in ctrls}
    for _ in range(ticks):
        for k, c in ctrls.items():
            t0 = time.perf_counter()
            u = c.step(states[k][0])
            host[k].append((time.perf_counter() - t0) * 1e3)
            states[k], *_ = envs[k].step(u)
    numbers = {k: {"step_host_p50_ms": float(np.percentile(v, 50)),
                   "step_host_p99_ms": float(np.percentile(v, 99))} for k, v in host.items()}
    emit(name, numbers)
    return numbers


def options_controller(device: str, config: dict, **controller) -> MPCController:
    """A cartpole ``mpc`` controller running MPPI with controller keys."""
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": "mppi", "controller_logging": False,
                                 "device": device, **controller})
    ctrl.configure(optimizer_name="mppi", optimizer_config=dict(config),
                   cost_function_config=COST_WEIGHTS)
    return ctrl


def seeded_update_vs_cpu(name: str, card: MPCController, cpu: MPCController,
                         policy: bool = False) -> dict:
    """One MPPI update on the card and on the CPU from the card's state,
    params and one draw; with ``policy`` the state is first seeded by each
    device's own plan (held to PLAN_ATOL).  u_nom held to UNOM_ATOL; an
    optimal trajectory to X_TOL of the CPU's replay of the card's u_nom."""
    opt, copt = card.optimizer, cpu.optimizer
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    params = card._assemble_params()
    noise = opt.sample_noise(opt.opt_state)
    state = opt.opt_state
    cstate = mppi_state_from_numpy(state.u_nom.cpu().numpy(), state.u_prev.cpu().numpy(),
                                   torch.Generator())
    numbers = {}
    if policy:
        plan, cplan = opt._policy_plan(s_now, params), copt._policy_plan(s_now.cpu(),
                                                                        to_cpu(params))
        numbers["plan_max_abs_err"] = float((plan.cpu() - cplan).abs().max())
        check(numbers["plan_max_abs_err"] <= PLAN_ATOL, f"{name}: the plans differ {numbers}")
        state, cstate = opt._apply_policy_guess(state, plan), copt._apply_policy_guess(cstate,
                                                                                        cplan)
    _, _, diag = opt.update(state, s_now, params, noise)
    _, _, cdiag = copt.update(cstate, s_now.cpu(), to_cpu(params), noise.cpu())
    numbers["u_nom_max_abs_err"] = float((diag["u_nom"].cpu() - cdiag["u_nom"]).abs().max())
    if "optimal_trajectory" in diag:
        replay = copt.predictor.rollout(s_now.cpu(), diag["u_nom"].cpu(), to_cpu(params)["dyn"])
        got = diag["optimal_trajectory"].cpu()
        numbers["optimal_trajectory_max_abs_err"] = float((got - replay).abs().max())
        check(got.shape == (1, opt.mpc_horizon + 1, 4) and torch.allclose(got, replay, **X_TOL),
              f"{name}: the optimal trajectory differs from the CPU's replay {numbers}")
    emit(name, numbers)
    check(numbers["u_nom_max_abs_err"] <= UNOM_ATOL,
          f"{name}: u_nom on the card differs from the CPU's {numbers}")
    return numbers


def options_phases(gen) -> tuple:
    """Phases 80-84.  Returns K7's and K8's numbers at one rollout and the
    counted loops' launches."""
    lone = lone_rollout_kernels(gen)                                    # 80

    # 81. mppi-optimize-tf at its defaults and at the flagship width.
    defaults = {**load_optimizer_config("mppi-optimize-tf"), "seed": SEED}
    check(defaults == MPPI_OPTIMIZE_CONFIG,
          f"MPPI_OPTIMIZE_CONFIG is not config_defaults' {defaults}")
    runs = {}
    for label, cfg in (("defaults", MPPI_OPTIMIZE_CONFIG), ("wide", MPPI_OPTIMIZE_WIDE)):
        ctrl = make_controller("cuda", "mppi-optimize-tf", cfg)
        opt = ctrl.optimizer
        check(opt._uses_semi_fused() and ode.can_use_grad(opt) and opt.optim_steps == 10,
              f"mppi-optimize {label}: not on K2 and K7")
        ticks, steps = OPTIONS_TICKS, opt.optim_steps
        runs[f"mppi_optimize_{label}"] = counts = no_autograd(lambda: counted_loop(
            f"slice_mppi_optimize_{label}", ctrl, ticks,
            {"mppi_cost": ticks, "grad_cost_rollout": steps * ticks}, pole_check=False))
        emit(f"mppi_optimize_{label}_k7_calls_per_tick",
             {"per_tick": counts["grad_cost_rollout"] / ticks, "optim_steps": steps})
        update_vs_cpu_mppi(f"mppi_optimize_{label}_update_vs_cpu", ctrl, config=cfg)
        plain = {**cfg, "optim_steps": 0}
        in_turns(f"mppi_optimize_{label}_in_turns",
                 {"mppi_optimize": make_controller("cuda", "mppi-optimize-tf", cfg),
                  "mppi": make_controller("cuda", "mppi", plain)}, TURN_TICKS)
        profile_ticks(f"mppi_optimize_{label}", env_tick(make_controller("cuda", "mppi", cfg)))
        profile_ticks(f"mppi_{label}_beside_mppi_optimize",
                      env_tick(make_controller("cuda", "mppi", plain)))

    # 82. calculate_optimal_trajectory at the flagship width.
    traj = options_controller("cuda", OPTIMIZER_CONFIG, calculate_optimal_trajectory=True)
    seeded_update_vs_cpu("optimal_trajectory_update_vs_cpu", traj,
                         options_controller("cpu", OPTIMIZER_CONFIG,
                                            calculate_optimal_trajectory=True))
    turns = in_turns("optimal_trajectory_in_turns",
                     {"with": traj, "without": options_controller("cuda", OPTIMIZER_CONFIG)},
                     TURN_TICKS)
    check(traj.optimizer.optimal_trajectory.shape == (1, H + 1, 4),
          "the optimal trajectory did not reach the host")
    emit("optimal_trajectory_extra_host_ms",
         {"p50": turns["with"]["step_host_p50_ms"] - turns["without"]["step_host_p50_ms"]})

    # 83. The policy warm start.
    pcfg = {**OPTIMIZER_CONFIG, "initial_guess_policy": cartpole_policy}
    seeded = options_controller("cuda", pcfg)
    check(seeded.optimizer._policy_seed_pending, "the policy warm start is not armed")
    seeded_update_vs_cpu("policy_update_vs_cpu", seeded, options_controller("cpu", pcfg),
                         policy=True)
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=gen.device)
    params = seeded._assemble_params()
    plan_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seeded.optimizer._policy_plan(s_now, params)
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
    u = seeded.step(np.array([0.02, -0.1, 0.05, 0.1], np.float32))
    check(not seeded.optimizer._policy_seed_pending and bool(np.all(np.isfinite(u))),
          "the policy seed was not consumed")
    emit("policy_plan_host_ms", {"median": float(np.median(plan_ms)), "runs": plan_ms,
                                 "horizon": H})

    # 84. profile_latency.
    timed = options_controller("cuda", OPTIMIZER_CONFIG, profile_latency=True)
    tick = env_tick(timed)
    for _ in range(LATENCY_TICKS):
        tick()
    check(len(timed.latency) == LATENCY_TICKS, "profile_latency did not time every step")
    emit("profile_latency", {**timed.latency.percentiles(), "report": timed.latency.report()})
    return lone, runs


# ---- the fleets and fused CEM over the other plants (phases 85-88) --------------------------
# Every plant of phases 74-79 (plant ids 2-17) under K4, K5, K6 and the
# session-row forms of K1 and K7.  The fleets plan one dynamics constant of
# each environment per slot (FLEET_SLOT_DYN: a length, a mass or the
# wheelbase; the arm's l1, which its cost mirrors once at configure and
# then keeps shared, as the JAX package does), over 0.9-1.1 of its
# default.  K5 runs at K=16384, H=50 and at K5_RAGGED (eleven tiles of 64,
# the last block half full, at H=45, not a multiple of the 3-D
# quadrotor's 16-step chunk); K4 and K6 at FLEET_B sessions of the
# fleet's K=512, H=35 (timed at FLEET_B_MAX too); K1's and K7's session-row
# forms at GRAD_COLS_B sessions of GRAD_COLS_KS rollouts, H=50, timed there
# and at GRAD_COLS_SHAPES.  Each plain version runs once a shape, its time
# that call's (compare_once, plain_timed).  The loops run
# FLEET_PLANT_TICKS ticks of the MPPI, fused-CEM and rpgd-tf fleets of
# FLEET_B slots and of single-session fused CEM over FLEET_LOOP_PLANTS,
# FLEET_PLANT_SHORT_TICKS over every other plant (every instance launched
# on a path); phase 86's updates are the 3-D quadrotor's, its
# single-session fused CEM at FLEET_CEM_CHECK_K rollouts.
FLEET_SLOT_DYN = {"pendulum": "L", "acrobot": "m2", "pointmass": "mass", "quadrotor2d": "m",
                  "quadrotor3d": "m", "car": "wheelbase", "arm2": "l1"}
K5_RAGGED = (704, 64, 45)  # K, tile, H
FLEET_CEM_CHECK_K = 2048
FLEET_LOOP_PLANTS = ("pendulum", "pointmass_obstacles", "quadrotor3d", "car")
FLEET_PLANT_TICKS, FLEET_PLANT_SHORT_TICKS = 10, 4
FLEET_RPGD_CONFIG = {**GRAD_RPGD_CONFIG, "mpc_horizon": FLEET_H}
FLEET_GRADIENT_CONFIG = {**GRAD_GRADIENT_CONFIG, "mpc_horizon": FLEET_H}
FLEET_MODULAR_CEM_CONFIG = {**FLEET_CEM_CONFIG, "fully_fused": False, "cem_outer_it": 1}
FLEET_PATHS = {  # label: (optimizer, config, launches a tick)
    "mppi": ("mppi", FLEET_MPPI_CONFIG, {"mppi_cost_cols": 1}),
    "fused_cem": ("cem-tf", FLEET_CEM_CONFIG,
                  {"fused_cem_cols": FLEET_CEM_CONFIG["cem_outer_it"]}),
    "rpgd": ("rpgd-tf", FLEET_RPGD_CONFIG,
             {"grad_cost_rollout_cols": FLEET_RPGD_CONFIG["outer_its"], "cost_rollout_cols": 1}),
}


def slot_key(plant: str) -> str:
    return FLEET_SLOT_DYN[ALL_CASES[plant][0]]


def plant_attrs(plant: str) -> dict:
    env = ALL_CASES[plant][0]
    return PM_ATTRS if env == "pointmass" else REST_ATTRS.get(plant.replace("_fast", ""), {})


def plant_fleet(plant: str, optimizer: str, config: dict, B: int, device: str = "cuda",
                spec: str = None) -> BatchedMPCController:
    """A batched-mpc fleet of B slots over a PLANT_CASES or REST_CASES plant
    (its environment, limits, cost, predictor or ``spec``, and attributes),
    planning the plant's FLEET_SLOT_DYN constant per slot."""
    env, cost, pred = ALL_CASES[plant]
    ctrl = BatchedMPCController(env, (ENVS[env].action_low, ENVS[env].action_high),
                                dict(plant_attrs(plant)),
                                config={"optimizer": optimizer, "controller_logging": False,
                                        "device": device, "cost_function_specification": cost})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec or pred,
                   optimizer_config=dict(config), num_slots=B, per_slot_dyn=(slot_key(plant),))
    return ctrl


def plant_rows(plant: str, ctrl: MPCController, model, B: int, gen) -> torch.Tensor:
    """Sessions' packed parameters ``pvec_b [B, N]`` over ``ctrl``'s plant:
    the slot constant over 0.9-1.1 of its default (an "ODE+res" model's in
    its base), targets moved by up to 0.2 a session, previous controls
    within the limits."""
    opt, dev = ctrl.optimizer, gen.device
    key = slot_key(plant)
    params = ctrl._assemble_params()
    base = params["dyn"].get("base", params["dyn"])
    dyn = dict(base, **{key: base[key] * torch.linspace(0.9, 1.1, B, device=dev)})
    attrs = {k: float(torch.as_tensor(v).reshape(-1)[0])
             + (0.4 * torch.rand(B, generator=gen, device=dev) - 0.2
                if k.startswith("target") else 0.0)
             for k, v in ctrl.variable_parameters.items()}
    lo, hi = opt.action_low, opt.action_high
    u_prev = lo + (hi - lo) * torch.rand(B, lo.shape[0], generator=gen, device=dev)
    _, slot_keys = split_slot_keys(model.param_keys, (key,))
    cf = opt.cost_function.cost_function
    return make_slot_packer(model.param_keys, slot_keys, cf.attr_defaults, B, dev)(
        u_prev, dyn, params["cost"], attrs)


def row_mutants(plant: str, model, pvec_b: torch.Tensor) -> dict:
    """The plant's named wrong variants (plant_mutants) over sessions' rows
    ``pvec_b [B, N]`` as ``(model, pvec_b)``: the point mass's swapped
    controls as a model that reads them swapped, in its dynamics and its
    stage cost."""
    out = {}
    for name, (m, pv, swap) in plant_mutants(plant, model, pvec_b.T).items():
        if swap:
            m = dataclasses.replace(
                m, derivs=lambda xs, us, p, d=m.derivs: d(xs, tuple(us)[::-1], p),
                stage=lambda xs, us, prev, p, st=m.stage: st(xs, tuple(us)[::-1],
                                                             tuple(prev)[::-1], p))
        out[name] = (m, pv.T.contiguous())
    return out


def session_resources(plant: str) -> dict:
    """ptxas' registers, spills and static shared memory of the plant's
    instances of K4, K5, K6 (and the point mass's fast-normals instances)
    and of the session-row forms of K1 and K7, and the blocks an SM holds
    of each."""
    lib, pid = kernels.load(), kernels.PLANT_IDS[plant]
    name = "".join(w.capitalize() for w in plant.replace("obstacles", "obstacle").split("_"))
    name = name.replace("2d", "2D").replace("3d", "3D")
    inst = f"{len(name) + 5}{name}Plant"
    fast = int(plant.endswith("_fast"))
    out = {
        "k4": {**ptxas_resources("mppi_cost_cols_kernel", inst + "EEEv"),
               "blocks_per_sm": int(lib.ctt_mppi_cost_cols_plant_blocks_per_sm(pid))},
        "k5": {**ptxas_resources("fused_cem_kernel", inst + "EEEv"),
               "blocks_per_sm": int(lib.ctt_fused_cem_plant_blocks_per_sm(pid, fast))},
        "k6": {**ptxas_resources("fused_cem_cols_kernel", inst + "EEEv"),
               "blocks_per_sm": int(lib.ctt_fused_cem_cols_plant_blocks_per_sm(pid, fast))},
        "k1_cols": {**ptxas_resources("cost_rollout_kernel", inst + "E" + ROWS_FORM),
                    "blocks_per_sm": int(lib.ctt_cost_rollout_rows_plant_blocks_per_sm(pid))},
        "k7_cols_forward": {
            **ptxas_resources("grad_cost_forward_kernel", inst + "E" + ROWS_FORM),
            "blocks_per_sm": int(lib.ctt_grad_cost_rows_plant_blocks_per_sm(pid, 0))},
        "k7_cols_adjoint": {
            **ptxas_resources("grad_cost_adjoint_kernel", inst + "E" + ROWS_FORM),
            "blocks_per_sm": int(lib.ctt_grad_cost_rows_plant_blocks_per_sm(pid, 1))},
    }
    if plant in kernels.EXACT_IS_FAST:
        normals = f"{len(name) + 16}{name}FastNormalsPlantEEEv"
        for key, kernel, entry in (("k5", "fused_cem_kernel", lib.ctt_fused_cem_plant_blocks_per_sm),
                                   ("k6", "fused_cem_cols_kernel",
                                    lib.ctt_fused_cem_cols_plant_blocks_per_sm)):
            out[f"{key}_fast_normals"] = {**ptxas_resources(kernel, normals),
                                          "blocks_per_sm": int(entry(pid, 1))}
    return out


def plain_timed(fn) -> tuple:
    """``(fn(), its CUDA-event ms)`` from one call: a plain version timed at
    the call that gives the reference, for the plants' many instances."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def compare_once(name: str, kernel_fn, plain_fn, shape: tuple) -> tuple:
    """compare() with the plain version run once, its time that call's:
    ``(numbers, the kernel's output, the plain version's)``."""
    got = kernel_fn()
    ref, plain_ms = plain_timed(plain_fn)
    numbers = {**dict(zip(("max_abs_err", "max_rel_err"), max_errors(got, ref))),
               "finite": bool(torch.isfinite(got).all()), "ms": cuda_ms(kernel_fn, 20),
               "plain_ms": plain_ms}
    emit(name, numbers)
    check(numbers["finite"] and got.shape == shape, f"{name}: bad output")
    check(torch.allclose(got, ref, **KERNEL_TOL), f"{name}: kernel disagrees with plain {numbers}")
    return numbers, got, ref


def k1_equal(label: str, got: torch.Tensor, model, s0, Q, pvec_b) -> float:
    """The share of a fused form's costs ``got [B, K]`` equal to K1's over
    its regenerated controls Q [B, K, H, U], session by session; must be
    1.0."""
    share = float((got == k1_per_session(model, s0, Q, pvec_b)).double().mean())
    check(share == 1.0, f"{label}: its costs differ from K1's over its controls ({share})")
    return share


def fleet_plant_kernels(plant: str, gen) -> dict:
    """Phase 85 for one plant: its K5, K4, K6 and session-row K1 and K7
    instances (and the point mass's fast-normals instances of K5 and K6)
    against their plain versions, each bound rejecting the plant's named
    wrong variants and, for the session forms, every session reading the
    next session's rows; K5 and K6 equal to K1 over their regenerated
    controls; returns each kernel's numbers for the kernels line."""
    ctrl = plant_controller(plant, "mppi", OPTIMIZER_CONFIG)
    opt, dev = ctrl.optimizer, gen.device
    model, pack = ode.rollout_model(opt)
    check(model.plant == plant, f"{plant}: not the device plant")
    U = kernels.PLANT_DIMS[plant][1]
    rk4_ops, stage_ops, vjp_ops, stage_vjp_ops = PLANT_OPS[plant.replace("_fast", "")]
    step_ops, draw_ops = rk4_ops + stage_ops, U * (NORMAL_OPS + CEM_CONTROL_OPS)
    lo, hi = opt.action_low, opt.action_high
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    out = {}

    # K5, over the exact normals and (the point mass) its fast-normals instance.
    pvec = pack(ctrl._assemble_params(), mid + 0.3 * half)
    s0 = plant_states(plant, 1, gen)[0].contiguous()
    if plant.startswith(("pointmass_obstacles", "car_obstacles")):  # in the first disc's margin
        s0[:2] = torch.tensor([0.1, -0.05], device=dev)
    mue = torch.clamp(mid + half * (0.3 * torch.randn(H, U, generator=gen, device=dev)), lo, hi)
    std = (0.5 * half).expand(H, U).contiguous()
    seed2 = torch.tensor([SEED + 85, 0], dtype=torch.int32, device=dev)
    tile = opt.fused_tile_k
    single = {"k5": model}
    if plant in kernels.EXACT_IS_FAST:
        single["k5_fast_normals"] = dataclasses.replace(model, fast_sampling=True)
    for key, m in single.items():
        args = (m, s0, mue, std, pvec, seed2, lo, hi, K, tile)
        k5, got, _ = compare_once(f"{key}_{plant}", lambda: fused_cem_costs(*args),
                                  lambda: fused_cem_costs_plain(*args), (K,))
        out[key] = k5
        k5.update(bound(K * H * (step_ops + draw_ops), nbytes(s0, mue, std, pvec, lo, hi)
                        + 8 + 4 * K))
        k5["rejects"] = rejects(f"{key}_{plant}", got, {
            n: fused_cem_costs_plain(dataclasses.replace(mm, fast_sampling=m.fast_sampling),
                                     s0, mue, std, pv[0], seed2, lo, hi, K, tile)
            for n, (mm, pv) in row_mutants(plant, model, pvec[None]).items()})
        Q = regen_controls(seed2, torch.arange(K, device=dev), mue, std, lo, hi, K, tile,
                           fast=m.fast_math)
        k5["k1_equal_share"] = k1_equal(f"{key}_{plant}", got[None], m, s0[None], Q[None],
                                        pvec[None])
        kr, tr, hr = K5_RAGGED
        a = (m, s0, mue[:hr].contiguous(), std[:hr].contiguous(), pvec, seed2, lo, hi, kr, tr)
        k5["cases"] = held_to_plain(f"{key}_{plant}", fused_cem_costs, fused_cem_costs_plain,
                                    {f"K{kr}_H{hr}_tile{tr}": a})

    # K4 and K6 at FLEET_B sessions of the fleet's K and H, timed at
    # FLEET_B_MAX too.
    B, Kf, Hf = FLEET_B_MAX, FLEET_K, FLEET_H
    pvec_b = plant_rows(plant, ctrl, model, B, gen)
    s0b = plant_states(plant, B, gen)
    mutants = row_mutants(plant, model, pvec_b)
    W = torch.as_tensor(interpolation_matrix(Hf, PERIOD), device=dev)
    u_nom = torch.clamp(mid + half * (0.3 * torch.randn(B, Hf, U, generator=gen, device=dev)),
                        lo, hi)
    eps = (0.3 * half[:, None]) * torch.randn(B, W.shape[0], U, Kf, generator=gen, device=dev)
    corr = (FLEET_MPPI_CONFIG["cc_weight"], FLEET_MPPI_CONFIG["R"], FLEET_MPPI_CONFIG["NU"])
    Bc = FLEET_B
    args = (model, s0b, u_nom, pvec_b, eps, W, lo, hi, *corr)
    held = (model, s0b[:Bc], u_nom[:Bc], pvec_b[:Bc], eps[:Bc], W, lo, hi, *corr)
    k4, got, _ = compare_once(f"k4_{plant}", lambda: mppi_cost_cols(*held),
                              lambda: mppi_cost_cols_plain(*held), (Bc, Kf))
    out["k4"] = k4
    k4["rejects"] = rejects(f"k4_{plant}", got, {
        **{n: mppi_cost_cols_plain(m, *held[1:3], pv[:Bc], *held[4:])
           for n, (m, pv) in mutants.items()},
        **k4_mutants(held, ("next_session_rows",))})
    k4["ms_at_b"] = {str(Bc): k4["ms"], str(B): cuda_ms(lambda: mppi_cost_cols(*args), 20)}
    k4.update(bound(Bc * Kf * Hf * (step_ops + U * MPPI_EXTRA_OPS),
                    nbytes(*held[1:8]) + 4 * Bc * Kf))

    mue_b = torch.clamp(mid + half * (0.3 * torch.randn(B, Hf, U, generator=gen, device=dev)),
                        lo, hi)
    std_b = (0.5 * half).expand(B, Hf, U).contiguous()
    seed_b = torch.randint(0, 2**31 - 1, (B,), generator=gen, dtype=torch.int32, device=dev)
    cols = {"k6": model}
    if plant in kernels.EXACT_IS_FAST:
        cols["k6_fast_normals"] = single["k5_fast_normals"]
    for key, m in cols.items():
        args = (m, s0b, mue_b, std_b, pvec_b, seed_b, lo, hi, Kf)
        rows_c = tuple(t[:Bc] for t in (s0b, mue_b, std_b, pvec_b, seed_b))
        held = (m, *rows_c, lo, hi, Kf)
        k6, got, _ = compare_once(f"{key}_{plant}", lambda: fused_cem_cols(*held),
                                  lambda: fused_cem_cols_plain(*held), (Bc, Kf))
        out[key] = k6
        k6["rejects"] = rejects(f"{key}_{plant}", got, {
            **{n: fused_cem_cols_plain(dataclasses.replace(mm, fast_sampling=m.fast_sampling),
                                       *rows_c[:3], pv[:Bc], rows_c[4], lo, hi, Kf)
               for n, (mm, pv) in mutants.items()},
            "next_session_rows": fused_cem_cols(m, *(t.roll(-1, 0) for t in rows_c), lo, hi,
                                                Kf)})
        Q = regen_cols(rows_c[4], torch.arange(Kf, device=dev).expand(Bc, Kf), rows_c[1],
                       rows_c[2], lo, hi, Kf, fast=m.fast_math)
        k6["k1_equal_share"] = k1_equal(f"{key}_{plant}", got, m, rows_c[0], Q, rows_c[3])
        k6["ms_at_b"] = {str(Bc): k6["ms"], str(B): cuda_ms(lambda: fused_cem_cols(*args), 20)}
        k6.update(bound(Bc * Kf * Hf * (step_ops + draw_ops),
                        nbytes(*rows_c, lo, hi) + 4 * Bc * Kf))

    # K1's and K7's session-row forms.
    Hg = GRAD_FLEET_H

    def cols_operands(b: int, ks: int) -> tuple:
        rows = plant_rows(plant, ctrl, model, b, gen)
        s = plant_states(plant, b, gen).repeat_interleave(ks, dim=0)
        Qc = lo + (hi - lo) * torch.rand(b * ks, Hg, U, generator=gen, device=dev)
        return (model, s, Qc, rows)

    forms = {"k1_cols": (cost_rollout_cols, cost_rollout_cols_plain, cost_rollout,
                         step_ops, 0),
             "k7_cols": (grad_cost_rollout_cols, grad_cost_rollout_cols_plain, grad_cost_rollout,
                         step_ops + vjp_ops + stage_vjp_ops, 1)}
    args = cols_operands(GRAD_COLS_B, GRAD_COLS_KS)
    timed_args = {shape: cols_operands(*shape) for shape in GRAD_COLS_SHAPES}
    cmutants = row_mutants(plant, model, args[3])
    for key, (form, plain, single_fn, ops, grad) in forms.items():
        got = form(*args)
        ref, held_plain_ms = plain_timed(lambda: plain(*args))
        # A variant of the operands alone (rows rolled, a cost term dropped)
        # is the form itself over them; one of the model's code, its plain
        # version's.
        wrong = {n: (form if m is model else plain)(m, args[1], args[2], pv)
                 for n, (m, pv) in cmutants.items()}
        wrong["next_session_rows"] = form(*args[:3], args[3].roll(-1, 0))
        per_session = [single_fn(*session_slice_grad(args, b)) for b in range(GRAD_COLS_B)]
        torch.cuda.synchronize()
        if grad:
            single = (torch.stack([c for c, _ in per_session]),
                      torch.cat([d for _, d in per_session]))
            same = torch.cat([(got[0] == single[0]).flatten(), (got[1] == single[1]).flatten()])
            cost_ok = torch.allclose(got[0], ref[0], **KERNEL_TOL)
            numbers = {**grad_cols_errors("k7", got, ref),
                       "finite": bool(torch.isfinite(got[0]).all()
                                      and torch.isfinite(got[1]).all())}
            numbers["max_abs_err"] = max(numbers["cost_max_abs_err"], numbers["dQ_max_abs_err"])
            if plant.startswith(F64_HELD_PLANTS):
                held = numbers["dQ_f64"] = f64_held(got[1], ref[1], plain(
                    model, args[1].double(), args[2].double(), args[3].double())[1])
                dq_ok = held["held"]
            else:
                dq_ok = close(got[1], ref[1], DQ_RTOL, DQ_ATOL_FRAC)
            numbers["rejects"] = {n: grad_cols_errors("k7", w, ref) for n, w in wrong.items()}
            for n, w in wrong.items():
                check(not (torch.allclose(w[0], ref[0], **KERNEL_TOL)
                           and close(w[1], ref[1], DQ_RTOL, DQ_ATOL_FRAC)),
                      f"{key}_{plant}: the bounds do not reject {n} {numbers['rejects'][n]}")
        else:
            same = got == torch.stack(per_session)
            cost_ok, dq_ok = torch.allclose(got, ref, **KERNEL_TOL), True
            numbers = {**grad_cols_errors("k1", got, ref),
                       "finite": bool(torch.isfinite(got).all())}
            numbers["max_abs_err"] = numbers["cost_max_abs_err"]
            numbers["rejects"] = rejects(f"{key}_{plant}", got, wrong)
        numbers["single_session_equal_share"] = float(same.double().mean())
        if grad:  # the adjoint reads its rows from shared memory: held, not equal
            numbers["single_session_errors"] = grad_cols_errors("k7", got, single)
            numbers["single_session_cost_equal_share"] = float(
                (got[0] == single[0]).double().mean())
        numbers["timed"] = {f"B{b}_K{ks}": cuda_ms(lambda: form(*timed_args[b, ks]), 20)
                            for b, ks in GRAD_COLS_SHAPES}
        n = GRAD_COLS_B * GRAD_COLS_KS
        numbers.update(ms=cuda_ms(lambda: form(*args), 20), plain_ms=held_plain_ms,
                       **bound(n * Hg * ops, nbytes(*args[1:]) + 4 * n + grad * nbytes(args[2])))
        emit(f"{key}_{plant}", numbers)
        check(numbers["finite"] and cost_ok and dq_ok,
              f"{key}_{plant}: kernel disagrees with plain {numbers}")
        check(numbers["single_session_equal_share"] == 1.0 if not grad else
              numbers["single_session_cost_equal_share"] == 1.0
              and grad_cols_held("k7", got, single),
              f"{key}_{plant}: its outputs differ from the single-session kernel's {numbers}")
        out[key] = numbers
    emit(f"{plant}_fleet_cases", {key: {k: v[k] for k in (
        "bound_ms", "bound_by", "rejects", "k1_equal_share", "cases", "ms_at_b") if k in v}
        for key, v in out.items() if not key.endswith("_cols")})
    emit(f"{plant}_session_resources", session_resources(plant))
    return out


def plant_fleet_loop(name: str, ctrl: BatchedMPCController, plant: str, ticks: int,
                     expected: dict) -> dict:
    """``ticks`` closed-loop ticks of a fleet against B copies of the plant's
    environment (seed SEED + 87), each slot's constant (where the fleet
    plans one: a learned model has none) over 0.9-1.1 of its default,
    every kernel's launch count set to 0 just before and checked against
    ``expected`` just after; the controls finite and within the limits,
    nothing rebuilt."""
    env_name, B = ALL_CASES[plant][0], ctrl.num_slots
    env = ENVS[env_name](batch_size=B, dt=DT, seed=SEED + 87)
    s, _ = env.reset()
    for key, default in ctrl._slot_dyn_defaults.items():
        for i, f in enumerate(np.linspace(0.9, 1.1, B)):
            ctrl.update_slot_dyn(i, {key: float(f * default)})
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    builds, epoch = kernels.build.count, ctrl.optimizer._build_epoch
    host_ms = []
    for t in range(ticks):
        t0 = time.perf_counter()
        u = ctrl.step_batch(s)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        check(u.shape == (B, env.num_actions) and bool(np.all(np.isfinite(u)))
              and bool(np.all(u >= env.action_low)) and bool(np.all(u <= env.action_high)),
              f"{name}: tick {t}: bad controls")
        s, *_ = env.step(u)
    counts = {kernel: wrapper.launches for kernel, wrapper in COUNTED.items()}
    check(counts == {kernel: expected.get(kernel, 0) for kernel in COUNTED},
          f"{name}: kernel launches {counts}, expected {expected}")
    check(kernels.build.count == builds and ctrl.optimizer._build_epoch == epoch,
          f"{name}: something was rebuilt during the loop")
    emit(name, {"slots": B, "ticks": ticks, "step_host_p50_ms": float(np.percentile(host_ms, 50)),
                "final_state_abs_max": float(np.abs(s).max())})
    return counts


def fleet_plant_phases(gen) -> tuple:
    """Phases 85-88: the fleets and fused CEM over plant ids 2-17.  Returns
    each kernel row's numbers by (row, plant) and the loops' launches by
    plant."""
    rows = {}
    # 85. Each instance against its plain version.
    for plant in ALL_CASES:
        for key, numbers in fleet_plant_kernels(plant, gen).items():
            rows[key, plant] = numbers

    # 86. One update of each path on the card against the CPU's over the 3-D
    # quadrotor (the fleets at FLEET_B slots, the gradient fleets at one Adam
    # iteration: grad_fleet_update_vs_cpu; single-session fused CEM at
    # FLEET_CEM_CHECK_K rollouts).
    plant, B = "quadrotor3d", FLEET_B
    psd, dev = (slot_key(plant),), gen.device
    s = plant_states(plant, B, gen)[:, None]
    paths = {"mppi": ("mppi", FLEET_MPPI_CONFIG), "fused_cem": ("cem-tf", FLEET_CEM_CONFIG),
             "var": ("mppi-var-tf", FLEET_VAR_CONFIG),
             "rpgd": ("rpgd-tf", {**FLEET_RPGD_CONFIG, "outer_its": 1}),
             "gradient": ("gradient-tf", {**FLEET_GRADIENT_CONFIG, "gradient_steps": 1})}
    card, cpu = ({label: plant_fleet(plant, name, cfg, B, device)
                  for label, (name, cfg) in paths.items()} for device in ("cuda", "cpu"))
    fleet_update_vs_cpu(card["mppi"], card["fused_cem"], gen, (cpu["mppi"], cpu["fused_cem"]),
                        s, psd, name=f"fleet_update_vs_cpu_{plant}")
    fleet_var_update_vs_cpu(card["var"], gen, cpu["var"], s, psd,
                            name=f"fleet_var_update_vs_cpu_{plant}")
    for label in ("rpgd", "gradient"):
        grad_fleet_update_vs_cpu(f"{label}_{plant}", card[label], gen, cpu[label], s, psd)
    # The modular batched CEM step (K1's session rows; a fleet controller
    # refuses modular CEM, which the JAX package serves by its vmapped
    # per-slot step), one outer iteration from the same normals.
    mod, mod_c = (plant_controller(plant, "cem-tf", FLEET_MODULAR_CEM_CONFIG, device=d)
                  for d in ("cuda", "cpu"))
    mopt = mod.optimizer
    step, _ = mopt._make_batched_cem_step(B, per_slot_dyn=psd)
    step_c, _ = mod_c.optimizer._make_batched_cem_step(B, per_slot_dyn=psd)
    params = mod._assemble_params()
    dyn = dict(params["dyn"], **{psd[0]: params["dyn"][psd[0]] * torch.linspace(0.9, 1.1, B,
                                                                                  device=dev)})
    attrs = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
             for k, v in mod.variable_parameters.items()}
    gens = tuple(torch.Generator(device=dev).manual_seed(SEED + 86 + b) for b in range(B))
    U = mopt.num_control_inputs
    mid = 0.5 * (mopt.action_low + mopt.action_high)
    st = CEMState(generator=gens, dist_mue=mid.expand(B, 1, FLEET_H, U).contiguous(),
                  stdev=torch.full((B, 1, FLEET_H, U), mopt.cem_initial_action_stdev, device=dev),
                  count=np.zeros(B, np.int64), u_prev=mid.expand(B, U).contiguous())
    draws = mopt.sample_slot_normals(gens, np.ones(B, bool))
    u, new, costs = step(st, s, dyn, params["cost"], attrs, np.ones(B, bool), draws=draws)
    u_c, new_c, costs_c = step_c(state_to_cpu(st), s.cpu(), to_cpu(dyn), to_cpu(params["cost"]),
                                 to_cpu(attrs), np.ones(B, bool), draws=draws.cpu())
    best_k = mopt.cem_best_k
    same_sets = torch.equal(torch.sort(elite_indices(costs, best_k).cpu(), dim=1).values,
                            torch.sort(elite_indices(costs_c, best_k), dim=1).values)
    numbers = {"cost_max_abs_err": max_errors(costs.cpu(), costs_c)[0],
               "same_elite_sets": same_sets, "u_max_abs_err": max_errors(u.cpu(), u_c)[0],
               "mue_max_abs_err": max_errors(new.dist_mue.cpu(), new_c.dist_mue)[0]}
    emit(f"fleet_modular_cem_update_vs_cpu_{plant}", numbers)
    check(torch.allclose(costs.cpu(), costs_c, **KERNEL_TOL),
          f"the modular batched CEM's costs on the card differ from the CPU's {numbers}")
    check(not same_sets or (numbers["u_max_abs_err"] <= UNOM_ATOL
                            and numbers["mue_max_abs_err"] <= UNOM_ATOL),
          f"the modular batched CEM update on the card differs from the CPU's {numbers}")
    # Single-session fully-fused CEM (K5).
    cem_cfg = {**CEM_CONFIG, "fully_fused": True, "num_rollouts": FLEET_CEM_CHECK_K,
               "cem_best_k": 64}
    cem, cem_c = (plant_controller(plant, "cem-tf", cem_cfg, device=d) for d in ("cuda", "cpu"))
    check(cem.optimizer._fused, f"{plant}: CEM did not take K5")
    update_vs_cpu_cem(f"cem_fused_update_vs_cpu_{plant}", cem, cem_cfg, cpu=cem_c,
                      s_now=plant_states(plant, 1, gen))

    # 87. The closed loops, counted from 0: the MPPI, fused-CEM and rpgd-tf
    # fleets and single-session fused CEM, FLEET_PLANT_TICKS over
    # FLEET_LOOP_PLANTS and FLEET_PLANT_SHORT_TICKS over every other plant.
    runs = {plant: [] for plant in ALL_CASES}
    cem_cfg = {**CEM_CONFIG, "fully_fused": True}
    for plant in ALL_CASES:
        T = FLEET_PLANT_TICKS if plant in FLEET_LOOP_PLANTS else FLEET_PLANT_SHORT_TICKS
        for label, (opt_name, cfg, per_tick) in FLEET_PATHS.items():
            c = plant_fleet(plant, opt_name, cfg, FLEET_B)
            runs[plant].append(plant_fleet_loop(f"slice_fleet_{plant}_{label}", c, plant, T,
                                                {k: n * T for k, n in per_tick.items()}))
        c = plant_controller(plant, "cem-tf", cem_cfg)
        check(c.optimizer._fused, f"{plant}: CEM did not take K5")
        counts, _, numbers = plant_loop(f"slice_{plant}_cem_fused", c, plant, T,
                                        {"fused_cem": cem_cfg["cem_outer_it"] * T})
        emit(f"slice_{plant}_cem_fused", numbers)
        runs[plant].append(counts)
    # 88. The point masses' fast CEM and fast fused-CEM fleet ("ODE:rk4:1:fast":
    # the fast-normals instances of K5 and K6), counted from 0.
    T = FLEET_PLANT_TICKS
    for plant in ("pointmass", "pointmass_obstacles"):
        c = plant_controller(plant, "cem-tf", cem_cfg, spec=FAST_SPEC)
        check(c.optimizer._fused and ode.rollout_model(c.optimizer)[0].fast_sampling,
              f"{plant}: the fast CEM did not take K5's fast-normals instance")
        counts, _, numbers = plant_loop(f"slice_{plant}_cem_fused_fast_normals", c, plant, T,
                                        {"fused_cem": cem_cfg["cem_outer_it"] * T})
        emit(f"slice_{plant}_cem_fused_fast_normals", numbers)
        f = plant_fleet(plant, "cem-tf", FLEET_CEM_CONFIG, FLEET_B, spec=FAST_SPEC)
        check(ode.rollout_model(f.optimizer)[0].fast_sampling,
              f"{plant}: the fast CEM fleet did not take K6's fast-normals instance")
        runs[plant + "_fast_normals"] = [counts, plant_fleet_loop(
            f"slice_fleet_{plant}_fused_cem_fast_normals", f, plant, T,
            {"fused_cem_cols": FLEET_CEM_CONFIG["cem_outer_it"] * T})]
    launches = {plant: {kernel: sum(r[kernel] for r in rs) for kernel in COUNTED}
                for plant, rs in runs.items()}
    return rows, launches


# ---- the learned-value and residual forms over plant ids 2-17 (phases 89-91) ----------
# Each plant's instances of K1's, K2's and K4's emit_terminal forms, K7's
# value_spec forms, K12 and K9 (plain, emit / value, and session-row), held
# to their plain versions: costs to KERNEL_TOL (K12's to NET_TOL), dQ to
# K7's bound (the arm's to float64, F64_HELD_PLANTS), x_H to float64 over
# f64_held (no further from the float64 plain version than GP_F64_FACTOR
# times the float32 plain version is: the plants' 50-step states separate
# float32 computations by more than X_TOL's reach, ROADMAP C), each bound
# rejecting its named wrong variants.  V is a seeded tanh MLP of the plant's
# S (FORMS_VALUE_DIMS at FORMS_VALUE_SCALE), the residual phase 18's seeded
# one.  The loops drive each path at the main path's width (K=16384,
# H=50; fleets of FLEET_B at their configurations) FORMS_TICKS ticks over
# the exact plants and FORMS_SHORT_TICKS over the fast ones, every kernel
# counted from 0; the adaptive MPPI runs FORMS_ADAPT_TICKS against the
# plant's environment with its FLEET_SLOT_DYN constant 10% off, an
# OnlineSysId fit installed every FIT_EVERY ticks.
FORMS_VALUE_DIMS, FORMS_VALUE_SCALE, FORMS_VALUE_SEED = (32, 32, 1), 3.0, 89
FORMS_TICKS, FORMS_SHORT_TICKS, FORMS_ADAPT_TICKS = 4, 2, FIT_EVERY + 1
FORMS_MISMATCH = 1.1
# K1-emit's float64 analysis: the main path's operands, and over the exact
# plants FORMS_F64_SEEDS' draws of FORMS_K rollouts.
FORMS_K, FORMS_F64_SEEDS = 4096, (1, 2)
# The fast plants' gradient forms are held and timed at FORMS_FAST_H steps
# (their adjoint chunks: 4 of the 3-D quadrotor's); the single-session
# update on the card against the CPU's at FORMS_CPU_K rollouts.
FORMS_FAST_H, FORMS_CPU_K = 16, 2048
# row: (source, the TPU kernel); {v}, {r}: the plant's group of K7's value
# forms and of K9, as the library dispatches (ctt_grad_value_group,
# ctt_residual_grad_group).
FORMS_SOURCES = {
    "cost_rollout_emit": ("cost_rollout.cu", "ops/pallas_rollout.py:34"),
    "cost_rollout_cols_emit": ("cost_rollout.cu", "ops/pallas_rollout.py:34"),
    "mppi_cost_emit": ("mppi_cost.cu", "ops/pallas_mppi.py:501"),
    "mppi_cost_cols_emit": ("mppi_cost_cols.cu", "ops/pallas_mppi.py:586"),
    "grad_cost_rollout_value": ("grad_value_plants_{v}.cu", "ops/pallas_grad.py:335"),
    "grad_cost_rollout_cols_value": ("grad_value_plants_{v}.cu", "ops/pallas_grad.py:335"),
    "residual_cost_rollout": ("residual_cost_plants.cu", "ops/pallas_neural.py:351"),
    "residual_cost_rollout_emit": ("residual_cost_plants.cu", "ops/pallas_neural.py:351"),
    "residual_cost_rollout_cols": ("residual_cost_plants.cu", "ops/pallas_neural.py:351"),
    "residual_cost_rollout_cols_emit": ("residual_cost_plants.cu", "ops/pallas_neural.py:351"),
    "residual_grad_cost_rollout": ("residual_grad_plants_{r}.cu", "ops/pallas_grad.py:459"),
    "residual_grad_cost_rollout_value": ("residual_grad_plants_{r}.cu", "ops/pallas_grad.py:459"),
    "residual_grad_cost_rollout_cols": ("residual_grad_plants_{r}.cu", "ops/pallas_grad.py:459"),
    "residual_grad_cost_rollout_cols_value": ("residual_grad_plants_{r}.cu",
                                              "ops/pallas_grad.py:459"),
}


def plant_value_net(plant: str, device) -> dict:
    """A seeded tanh MLP V ``S -> FORMS_VALUE_DIMS`` over the plant's states
    (weights N(0, 1/fan_in), biases N(0, 0.01)) as a ``{w0, b0, ...}``
    dict: attach_value_terminal's net."""
    S = kernels.PLANT_DIMS[plant][0]
    gen = torch.Generator(device=device).manual_seed(FORMS_VALUE_SEED + S)
    dims, net = (S, *FORMS_VALUE_DIMS), {}
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        net[f"w{i}"] = torch.randn(fi, fo, generator=gen, device=device) * fi ** -0.5
        net[f"b{i}"] = 0.1 * torch.randn(fo, generator=gen, device=device)
    return net


def plant_value_ops(net: dict, scale: float = FORMS_VALUE_SCALE) -> list:
    """The value_spec forms' ``[w0, b0, ...]`` with ``scale`` folded into the
    last layer (Optimizer._flatten_value_ops)."""
    n = len(net) // 2
    ops = [t for i in range(n) for t in (net[f"w{i}"], net[f"b{i}"])]
    return ops[:-2] + [ops[-2] * scale, ops[-1] * scale]


def res_spec(plant: str) -> str:
    return RES_FAST_SPEC if plant.endswith("_fast") else RES_SPEC


def plant_res_controller(plant: str, optimizer: str, config: dict, device: str = "cuda"
                         ) -> MPCController:
    """plant_controller over ``"ODE+res"`` on the plant's base (its fast
    base for a fast plant) with phase 18's seeded nonzero residual."""
    ctrl = plant_controller(plant, optimizer, config, spec=res_spec(plant), device=device)
    seed_residual(ctrl.optimizer.predictor.predictor)
    return ctrl


def emit_held(label: str, x, ref_x, x64, wrong: dict, unvalued=None, cap: float = None) -> dict:
    """x_H of an emit form to float64 (f64_held, ``unvalued`` its kernel
    ratio's outputs, ``cap`` the ratio's), the bound rejecting each
    ``wrong`` terminal state set."""
    held = f64_held(x, ref_x, x64, unvalued, cap)
    held["rejects"] = {k: f64_err(w, x64) for k, w in wrong.items()}
    check(held["held"], f"{label}: x_H further from float64 than its bound {held}")
    for k, err in held["rejects"].items():
        check(err > held["bound"], f"{label}: the x_H bound does not reject {k} {held}")
    return held


def dq_held_plant(label: str, plant: str, d, rd, ref64_fn, unvalued_fn=None) -> dict:
    """dQ to K7's bound, the arm's to float64 (ref64_fn gives the float64
    plain version's; a value form's unvalued_fn the kernel's, the plain
    version's and the float64 plain version's dQ without V, whose ratio
    scales the bound: f64_held)."""
    if plant.startswith(F64_HELD_PLANTS):
        held = f64_held(d, rd, ref64_fn(), unvalued_fn() if unvalued_fn else None)
        check(held["held"], f"{label}: dQ further from float64 than its bound {held}")
        return held
    check(close(d, rd, DQ_RTOL, DQ_ATOL_FRAC), f"{label}: dQ disagrees "
          f"{max_errors(d, rd)} of {float(rd.abs().max())}")
    return {"dQ_max_abs_err": max_errors(d, rd)[0], "dQ_max_abs": float(rd.abs().max())}


def dq_rejects(label: str, rd, wrong: dict) -> dict:
    out = {k: max_errors(w, rd)[0] for k, w in wrong.items()}
    for k, w in wrong.items():
        check(not close(w, rd, DQ_RTOL, DQ_ATOL_FRAC), f"{label}: the dQ bound takes {k} {out}")
    return out




def forms_plant_kernels(plant: str, gen) -> dict:
    """Phase 89 for one plant: its 14 new instances against their plain
    versions (see the note above); returns each row's numbers."""
    dev = gen.device
    ctrl = plant_controller(plant, "mppi", OPTIMIZER_CONFIG)
    opt = ctrl.optimizer
    model, pack = ode.rollout_model(opt)
    rctrl = plant_res_controller(plant, "mppi", RES_MPPI_CONFIG)
    rmodel, rpack = residual.residual_model(rctrl.optimizer)
    check(model.plant == plant and rmodel.plant == plant, f"{plant}: not the device plant")
    S, U = kernels.PLANT_DIMS[plant]
    lo, hi = opt.action_low, opt.action_high
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    rk4_ops, stage_ops, vjp_ops, stage_vjp_ops = PLANT_OPS[plant.replace("_fast", "")]
    params, rparams = ctrl._assemble_params(), rctrl._assemble_params()
    net = rparams["dyn"]["res"]
    vnet = plant_value_net(plant, dev)
    vops = plant_value_ops(vnet)
    v_ops = value_net_ops((S, *FORMS_VALUE_DIMS))
    u_prev = mid + 0.1 * half
    pvec, rpvec = pack(params, u_prev), rpack(rparams, u_prev)
    out, resources = {}, {}

    def timed(name: str, fn, got_ref: dict) -> dict:
        got_ref.update(ms=cuda_ms(fn, 20))
        emit(f"{name}_{plant}", got_ref)
        out[name] = got_ref
        return got_ref

    # x_H of K1's emit form to float64 over FORMS_F64_SEEDS at FORMS_K
    # rollouts (phase 89's float64 analysis with the main path's operands
    # below; ROADMAP C).
    fast = plant.endswith("_fast")
    f64_seeds = {}
    for seed in () if fast else FORMS_F64_SEEDS:
        g = torch.Generator(device=dev).manual_seed(SEED + 89 + seed)
        s0 = plant_states(plant, FORMS_K, g)
        Q = torch.clamp(mid + half * (0.5 * torch.randn(FORMS_K, H, U, generator=g, device=dev)),
                        lo, hi)
        (c, x), (rc, rx) = cost_rollout_emit(model, s0, Q, pvec), cost_rollout_emit_plain(
            model, s0, Q, pvec)
        x64 = cost_rollout_emit_plain(model, *tree64((s0, Q, pvec)))[1]
        x_prev = cost_rollout_emit(model, s0, Q[:, :-1].contiguous(), pvec)[1]
        f64_seeds[str(seed)] = emit_held(f"k1_emit_{plant} seed {seed}", x, rx, x64,
                                         {"x_H_minus_1": x_prev, "next_rollout_x_H":
                                          x.roll(-1, 0)})
        check(torch.equal(c, cost_rollout(model, s0, Q, pvec))
              and torch.allclose(c, rc, **KERNEL_TOL), f"k1_emit_{plant}: costs disagree")

    # Each single-session form held and timed at the main path's operands
    # (K=16384, H=50; a fast plant's gradient forms at FORMS_FAST_H steps
    # of them).
    sK = plant_states(plant, K, gen)
    QK = torch.clamp(mid + half * (0.5 * torch.randn(K, H, U, generator=gen, device=dev)), lo, hi)
    (c, x) = cost_rollout_emit(model, sK, QK, pvec)
    (rc, rx), plain_ms = plain_timed(lambda: cost_rollout_emit_plain(model, sK, QK, pvec))
    x64 = cost_rollout_emit_plain(model, *tree64((sK, QK, pvec)))[1]
    check(torch.equal(c, cost_rollout(model, sK, QK, pvec))
          and torch.allclose(c, rc, **KERNEL_TOL), f"k1_emit_{plant}: costs disagree")
    timed("cost_rollout_emit", lambda: cost_rollout_emit(model, sK, QK, pvec), {
        "max_abs_err": max(max_errors(c, rc)[0], max_errors(x, rx)[0]),
        "x_f64": emit_held(f"k1_emit_{plant}", x, rx, x64, {
            "x_H_minus_1": cost_rollout_emit(model, sK, QK[:, :-1].contiguous(), pvec)[1],
            "next_rollout_x_H": x.roll(-1, 0)}),
        "x_f64_seeds": f64_seeds, "plain_ms": plain_ms,
        **bound(K * H * (rk4_ops + stage_ops), nbytes(sK, QK, pvec) + 4 * K * (1 + S))})

    # K2's emit form: costs equal to K2's, x_H to float64; x_{H-1} by K1's
    # emit form over its controls without their last step.
    P = opt.interp.number_of_interpolation_inducing_points
    eps = opt.SQRTRHODTINV * torch.randn(P, U, K, generator=gen, device=dev)
    u_nom = torch.clamp(mid + half * (0.3 * torch.randn(H, U, generator=gen, device=dev)), lo, hi)
    corr = (opt.cc_weight, opt.R, opt.NU)
    a2 = (model, sK[0].contiguous(), u_nom, pvec, eps, opt.interp.matrix, lo, hi, *corr)
    (c, x), ((rc, rx), plain_ms) = mppi_cost_emit(*a2), plain_timed(
        lambda: mppi_cost_emit_plain(*a2))
    x64 = mppi_cost_emit_plain(model, *tree64((*a2[1:8],)), *corr)[1]
    Q2 = mppi_controls_plain(eps, a2[5], u_nom, lo, hi)[0]
    x_prev = cost_rollout_emit(model, a2[1].expand(K, -1).contiguous(),
                               Q2[:, :-1].contiguous(), pvec)[1]
    check(torch.equal(c, mppi_cost(*a2)) and torch.allclose(c, rc, **KERNEL_TOL),
          f"k2_emit_{plant}: costs disagree")
    timed("mppi_cost_emit", lambda: mppi_cost_emit(*a2), {
        "max_abs_err": max(max_errors(c, rc)[0], max_errors(x, rx)[0]),
        "x_f64": emit_held(f"k2_emit_{plant}", x, rx, x64, {"x_H_minus_1": x_prev,
                                                            "next_rollout_x_H": x.roll(-1, 0)}),
        "plain_ms": plain_ms,
        **bound(K * H * (rk4_ops + stage_ops + U * MPPI_EXTRA_OPS),
                nbytes(*a2[1:8]) + 4 * K * (1 + S))})

    # K7's value_spec form: J to KERNEL_TOL, dQ to K7's bound, rejecting
    # dV/dx_H dropped from the seed (K7's own dQ).
    Qg = lo + (hi - lo) * torch.rand(K, H, U, generator=gen, device=dev)
    qg = Qg[:, :FORMS_FAST_H].contiguous() if fast else Qg
    hg = qg.shape[1]
    (cv, dv) = grad_cost_rollout_value(model, sK, qg, pvec, vops)
    (rcv, rdv), plain_ms = plain_timed(
        lambda: grad_cost_rollout_plain(model, sK, qg, pvec, value_ops=vops))
    check(torch.allclose(cv, rcv, **KERNEL_TOL), f"k7_value_{plant}: J disagrees")
    held = dq_held_plant(f"k7_value_{plant}", plant, dv, rdv, lambda: grad_cost_rollout_plain(
        model, *tree64((sK, qg, pvec)), value_ops=tree64(vops))[1], lambda: (
            grad_cost_rollout(model, sK, qg, pvec)[1],
            grad_cost_rollout_plain(model, sK, qg, pvec)[1],
            grad_cost_rollout_plain(model, *tree64((sK, qg, pvec)))[1]))
    timed("grad_cost_rollout_value", lambda: grad_cost_rollout_value(model, sK, qg, pvec, vops), {
        "max_abs_err": max(max_errors(cv, rcv)[0], max_errors(dv, rdv)[0]), "dQ": held,
        "H": hg, "rejects": dq_rejects(f"k7_value_{plant}", rdv, {
            "dV_dx_H_dropped": grad_cost_rollout(model, sK, qg, pvec)[1]}),
        "plain_ms": plain_ms,
        **bound(K * (hg * (rk4_ops + stage_ops + vjp_ops + stage_vjp_ops) + v_ops),
                nbytes(sK, qg, pvec, *vops) + 4 * K + 4 * K * hg * U)})

    # K12 and its emit form (the same body: costs equal), rejecting the
    # residual dropped (K1's rollout of the base alone).
    (c12, x12) = residual_cost_rollout_emit(rmodel, sK, QK, rpvec, net)
    (rc12, rx12), plain_ms = plain_timed(
        lambda: residual_cost_rollout_emit_plain(rmodel, sK, QK, rpvec, net))
    x64 = residual_cost_rollout_emit_plain(rmodel, *tree64((sK, QK, rpvec)), tree64(net))[1]
    k12 = residual_cost_rollout(rmodel, sK, QK, rpvec, net)
    base = cost_rollout(model, sK, QK, pvec)
    check(torch.equal(c12, k12) and torch.allclose(k12, rc12, **NET_TOL),
          f"k12_{plant}: costs disagree {max_errors(k12, rc12)}")
    check(not torch.allclose(base, rc12, **NET_TOL), f"k12_{plant}: the bound takes the base")
    k12_ops = K * H * (rk4_ops + stage_ops + mlp_ops(net))
    k12_bytes = nbytes(sK, QK, rpvec, *net.values()) + 4 * K
    timed("residual_cost_rollout", lambda: residual_cost_rollout(rmodel, sK, QK, rpvec, net), {
        "max_abs_err": max_errors(k12, rc12)[0],
        "rejects": {"residual_dropped": max_errors(base, rc12)[0]}, "plain_ms": plain_ms,
        **bound(k12_ops, k12_bytes)})
    x_prev = residual_cost_rollout_emit(rmodel, sK, QK[:, :-1].contiguous(), rpvec, net)[1]
    timed("residual_cost_rollout_emit",
          lambda: residual_cost_rollout_emit(rmodel, sK, QK, rpvec, net), {
              "max_abs_err": max(max_errors(c12, rc12)[0], max_errors(x12, rx12)[0]),
              "x_f64": emit_held(f"k12_emit_{plant}", x12, rx12, x64, {
                  "x_H_minus_1": x_prev, "next_rollout_x_H": x12.roll(-1, 0),
                  "residual_dropped": cost_rollout_emit(model, sK, QK, pvec)[1]}),
              "plain_ms": plain_ms, **bound(k12_ops, k12_bytes + 4 * K * S)})

    # K9 and its value_spec form, each rejecting the residual dropped (K7's
    # forms over the base) and the value form dV/dx_H dropped.  Their ops
    # are one forward and the transposed layers of the MLP (phase 12's
    # convention: a kernel that kept the activations would not re-run the
    # forward).
    mlp_grad_ops = mlp_ops(net) + mlp_vjp_ops(net)
    k9_ops = K * hg * (rk4_ops + stage_ops + vjp_ops + stage_vjp_ops + mlp_grad_ops)
    k9_bytes = nbytes(sK, qg, rpvec, *net.values()) + 4 * K + 4 * K * hg * U
    for name, v in (("residual_grad_cost_rollout", None),
                    ("residual_grad_cost_rollout_value", vops)):
        single = residual_grad_cost_rollout if v is None else functools.partial(
            residual_grad_cost_rollout_value, value_ops=v)
        (c, d) = single(rmodel, sK, qg, rpvec, net)
        (rc, rd), plain_ms = plain_timed(lambda v=v: residual_grad_cost_rollout_plain(
            rmodel, sK, qg, rpvec, net, value_ops=v))
        check(torch.allclose(c, rc, **KERNEL_TOL), f"{name}_{plant}: J disagrees")
        held = dq_held_plant(f"{name}_{plant}", plant, d, rd, lambda v=v: (
            residual_grad_cost_rollout_plain(rmodel, *tree64((sK, qg, rpvec)), tree64(net),
                                             value_ops=None if v is None else tree64(v))[1]),
            None if v is None else (
                lambda: (residual_grad_cost_rollout(rmodel, sK, qg, rpvec, net)[1],
                         residual_grad_cost_rollout_plain(rmodel, sK, qg, rpvec, net)[1],
                         residual_grad_cost_rollout_plain(rmodel, *tree64((sK, qg, rpvec)),
                                                          tree64(net))[1])))
        wrong = {"residual_dropped": (grad_cost_rollout if v is None else functools.partial(
            grad_cost_rollout_value, value_ops=v))(model, sK, qg, pvec)[1]}
        if v is not None:
            wrong["dV_dx_H_dropped"] = residual_grad_cost_rollout(rmodel, sK, qg, rpvec, net)[1]
        timed(name, lambda k=single: k(rmodel, sK, qg, rpvec, net), {
            "max_abs_err": max(max_errors(c, rc)[0], max_errors(d, rd)[0]), "dQ": held,
            "H": hg, "rejects": dq_rejects(f"{name}_{plant}", rd, wrong), "plain_ms": plain_ms,
            **bound(k9_ops + (K * v_ops if v else 0), k9_bytes + nbytes(*(v or [])))})

    # The session-row forms at phase 85's sizes: each bound rejecting every
    # session reading the next session's row.
    Hg, B, ks = GRAD_FLEET_H, GRAD_COLS_B, GRAD_COLS_KS
    hc = FORMS_FAST_H if fast else Hg  # the gradient forms' horizon
    rows = plant_rows(plant, ctrl, model, B, gen)
    rrows = plant_rows(plant, rctrl, rmodel, B, gen)
    sc = plant_states(plant, B, gen).repeat_interleave(ks, dim=0)
    Qc = lo + (hi - lo) * torch.rand(B * ks, Hg, U, generator=gen, device=dev)
    n = B * ks
    step_ops = rk4_ops + stage_ops
    # K1's session-row emit form.
    (c, x), ((rc, rx), plain_ms) = cost_rollout_cols_emit(model, sc, Qc, rows), plain_timed(
        lambda: cost_rollout_cols_emit_plain(model, sc, Qc, rows))
    x64 = cost_rollout_cols_emit_plain(model, *tree64((sc, Qc, rows)))[1]
    check(torch.equal(c, cost_rollout_cols(model, sc, Qc, rows))
          and torch.allclose(c, rc, **KERNEL_TOL), f"k1_cols_emit_{plant}: costs disagree")
    single = torch.stack([cost_rollout_emit(model, sc[b * ks:(b + 1) * ks].contiguous(),
                                            Qc[b * ks:(b + 1) * ks].contiguous(), rows[b])[1]
                          for b in range(B)])
    check(torch.equal(single, x), f"k1_cols_emit_{plant}: x_H differs from K1's emit form's")
    timed("cost_rollout_cols_emit", lambda: cost_rollout_cols_emit(model, sc, Qc, rows), {
        "max_abs_err": max(max_errors(c, rc)[0], max_errors(x, rx)[0]),
        "x_f64": emit_held(f"k1_cols_emit_{plant}", x, rx, x64, {
            "x_H_minus_1": cost_rollout_cols_emit(model, sc, Qc[:, :-1].contiguous(), rows)[1],
            "next_session_rows": cost_rollout_cols_emit(model, sc, Qc, rows.roll(-1, 0))[1]}),
        "single_session_equal": True, "plain_ms": plain_ms,
        **bound(n * Hg * step_ops, nbytes(sc, Qc, rows) + 4 * n * (1 + S))})
    # K7's session-row value form.
    qc = Qc[:, :hc].contiguous()
    (cv, dv), ((rcv, rdv), plain_ms) = grad_cost_rollout_cols_value(model, sc, qc, rows, vops), \
        plain_timed(lambda: grad_cost_rollout_cols_plain(model, sc, qc, rows, value_ops=vops))
    check(torch.allclose(cv, rcv, **KERNEL_TOL), f"k7_cols_value_{plant}: J disagrees")
    held = dq_held_plant(f"k7_cols_value_{plant}", plant, dv, rdv,
                         lambda: grad_cost_rollout_cols_plain(
                             model, *tree64((sc, qc, rows)), value_ops=tree64(vops))[1],
                         lambda: (grad_cost_rollout_cols(model, sc, qc, rows)[1],
                                  grad_cost_rollout_cols_plain(model, sc, qc, rows)[1],
                                  grad_cost_rollout_cols_plain(model,
                                                               *tree64((sc, qc, rows)))[1]))
    timed("grad_cost_rollout_cols_value",
          lambda: grad_cost_rollout_cols_value(model, sc, qc, rows, vops), {
              "max_abs_err": max(max_errors(cv, rcv)[0], max_errors(dv, rdv)[0]), "dQ": held,
              "rejects": dq_rejects(f"k7_cols_value_{plant}", rdv, {
                  "dV_dx_H_dropped": grad_cost_rollout_cols(model, sc, qc, rows)[1],
                  "next_session_rows": grad_cost_rollout_cols_value(
                      model, sc, qc, rows.roll(-1, 0), vops)[1]}),
              "H": hc, "plain_ms": plain_ms,
              **bound(n * (hc * (step_ops + vjp_ops + stage_vjp_ops) + v_ops),
                      nbytes(sc, qc, rows, *vops) + 4 * n + 4 * n * hc * U)})
    # K9's session-row forms, each session's outputs equal to the
    # single-session kernel's, each bound rejecting the next session's rows
    # and the residual dropped (K7's forms over the base).
    for name, v in (("residual_grad_cost_rollout", None),
                    ("residual_grad_cost_rollout_value", vops)):
        cols_name = name.replace("rollout", "rollout_cols")
        kernel = residual_grad_cost_rollout_cols if v is None else functools.partial(
            residual_grad_cost_rollout_cols_value, value_ops=v)
        (c, d) = kernel(rmodel, sc, qc, rrows, net)
        (rc, rd), plain_ms = plain_timed(lambda: residual_grad_cost_rollout_cols_plain(
            rmodel, sc, qc, rrows, net, value_ops=v))
        check(torch.allclose(c, rc, **KERNEL_TOL), f"{cols_name}_{plant}: J disagrees")
        held = dq_held_plant(f"{cols_name}_{plant}", plant, d, rd, lambda v=v: (
            residual_grad_cost_rollout_cols_plain(rmodel, *tree64((sc, qc, rrows)), tree64(net),
                                                  value_ops=None if v is None
                                                  else tree64(v))[1]), None if v is None else (
            lambda: (residual_grad_cost_rollout_cols(rmodel, sc, qc, rrows, net)[1],
                     residual_grad_cost_rollout_cols_plain(rmodel, sc, qc, rrows, net)[1],
                     residual_grad_cost_rollout_cols_plain(rmodel, *tree64((sc, qc, rrows)),
                                                           tree64(net))[1])))
        single = residual_grad_cost_rollout if v is None else functools.partial(
            residual_grad_cost_rollout_value, value_ops=v)
        per = [single(rmodel, sc[b * ks:(b + 1) * ks].contiguous(),
                      qc[b * ks:(b + 1) * ks].contiguous(), rrows[b], net) for b in range(B)]
        same = bool(torch.equal(torch.stack([p[0] for p in per]), c)
                    and torch.equal(torch.cat([p[1] for p in per]), d))
        check(same, f"{cols_name}_{plant}: a session differs from the single-session kernel's")
        wrong = {"next_session_rows": kernel(rmodel, sc, qc, rrows.roll(-1, 0), net)[1],
                 "residual_dropped": (grad_cost_rollout_cols if v is None else functools.partial(
                     grad_cost_rollout_cols_value, value_ops=v))(model, sc, qc, rows)[1]}
        if v is not None:
            wrong["dV_dx_H_dropped"] = residual_grad_cost_rollout_cols(rmodel, sc, qc, rrows,
                                                                       net)[1]
        numbers = {"max_abs_err": max(max_errors(c, rc)[0], max_errors(d, rd)[0]), "dQ": held,
                   "H": hc, "single_session_equal": same,
                   "rejects": dq_rejects(f"{cols_name}_{plant}", rd, wrong), "plain_ms": plain_ms}
        timed(cols_name, lambda k=kernel: k(rmodel, sc, qc, rrows, net), {
            **numbers, **bound(n * hc * (step_ops + vjp_ops + stage_vjp_ops + mlp_grad_ops)
                               + n * (v_ops if v else 0),
                               nbytes(sc, qc, rrows, *net.values()) + 4 * n + 4 * n * hc * U)})

    # K4's emit form and K12's session-row forms at FLEET_B sessions of the
    # fleet's K and H.
    Bf, Kf, Hf = FLEET_B, FLEET_K, FLEET_H
    frows, frrows = rows[:Bf].contiguous(), rrows[:Bf].contiguous()
    s0b = plant_states(plant, Bf, gen)
    W = torch.as_tensor(interpolation_matrix(Hf, PERIOD), device=dev)
    u_nomb = torch.clamp(mid + half * (0.3 * torch.randn(Bf, Hf, U, generator=gen, device=dev)),
                         lo, hi)
    epsb = (0.3 * half[:, None]) * torch.randn(Bf, W.shape[0], U, Kf, generator=gen, device=dev)
    fcorr = (FLEET_MPPI_CONFIG["cc_weight"], FLEET_MPPI_CONFIG["R"], FLEET_MPPI_CONFIG["NU"])
    a4 = (model, s0b, u_nomb, frows, epsb, W, lo, hi, *fcorr)
    (c, x), ((rc, rx), plain_ms) = mppi_cost_cols_emit(*a4), plain_timed(
        lambda: mppi_cost_cols_emit_plain(*a4))
    x64 = mppi_cost_cols_emit_plain(model, *tree64((*a4[1:8],)), *fcorr)[1]
    check(torch.equal(c, mppi_cost_cols(*a4)) and torch.allclose(c, rc, **KERNEL_TOL),
          f"k4_emit_{plant}: costs disagree")
    Q4 = torch.stack([mppi_controls_plain(epsb[b], W, u_nomb[b], lo, hi)[0] for b in range(Bf)])
    x_prev = cost_rollout_cols_emit(model, s0b.repeat_interleave(Kf, dim=0),
                                    Q4.reshape(Bf * Kf, Hf, U)[:, :-1].contiguous(), frows)[1]
    timed("mppi_cost_cols_emit", lambda: mppi_cost_cols_emit(*a4), {
        "max_abs_err": max(max_errors(c, rc)[0], max_errors(x, rx)[0]),
        "x_f64": emit_held(f"k4_emit_{plant}", x, rx, x64, {
            "x_H_minus_1": x_prev,
            "next_session_rows": mppi_cost_cols_emit(model, s0b, u_nomb, frows.roll(-1, 0),
                                                     *a4[4:])[1]}),
        "plain_ms": plain_ms,
        **bound(Bf * Kf * Hf * (step_ops + U * MPPI_EXTRA_OPS),
                nbytes(*a4[1:8]) + 4 * Bf * Kf * (1 + S))})
    sf = s0b.repeat_interleave(Kf, dim=0)
    Qf = Q4.reshape(Bf * Kf, Hf, U).contiguous()
    (c, x), ((rc, rx), plain_ms) = residual_cost_rollout_cols_emit(rmodel, sf, Qf, frrows, net), \
        plain_timed(lambda: residual_cost_rollout_cols_emit_plain(rmodel, sf, Qf, frrows, net))
    x64 = residual_cost_rollout_cols_emit_plain(rmodel, *tree64((sf, Qf, frrows)), tree64(net))[1]
    k12c = residual_cost_rollout_cols(rmodel, sf, Qf, frrows, net)
    check(torch.equal(c, k12c) and torch.allclose(c, rc, **NET_TOL),
          f"k12_cols_{plant}: costs disagree {max_errors(c, rc)}")
    per = [residual_cost_rollout_emit(rmodel, sf[b * Kf:(b + 1) * Kf].contiguous(),
                                      Qf[b * Kf:(b + 1) * Kf].contiguous(), frrows[b], net)
           for b in range(Bf)]
    same = bool(torch.equal(torch.stack([p[0] for p in per]), c)
                and torch.equal(torch.stack([p[1] for p in per]), x))
    check(same, f"k12_cols_emit_{plant}: a session differs from the single-session kernel's")
    wrong = residual_cost_rollout_cols(rmodel, sf, Qf, frrows.roll(-1, 0), net)
    check(not torch.allclose(wrong, rc, **NET_TOL), f"k12_cols_{plant}: the bound takes "
          "the next session's rows")
    k12c_ops = Bf * Kf * Hf * (step_ops + mlp_ops(net))
    k12c_bytes = nbytes(sf, Qf, frrows, *net.values()) + 4 * Bf * Kf
    timed("residual_cost_rollout_cols",
          lambda: residual_cost_rollout_cols(rmodel, sf, Qf, frrows, net), {
              "max_abs_err": max_errors(c, rc)[0], "single_session_equal": same,
              "rejects": {"next_session_rows": max_errors(wrong, rc)[0]}, "plain_ms": plain_ms,
              **bound(k12c_ops, k12c_bytes)})
    timed("residual_cost_rollout_cols_emit",
          lambda: residual_cost_rollout_cols_emit(rmodel, sf, Qf, frrows, net), {
              "max_abs_err": max(max_errors(c, rc)[0], max_errors(x, rx)[0]),
              "single_session_equal": same,
              "x_f64": emit_held(f"k12_cols_emit_{plant}", x, rx, x64, {
                  "x_H_minus_1": residual_cost_rollout_cols_emit(
                      rmodel, sf, Qf[:, :-1].contiguous(), frrows, net)[1],
                  "next_session_rows": residual_cost_rollout_cols_emit(
                      rmodel, sf, Qf, frrows.roll(-1, 0), net)[1]}),
              "plain_ms": plain_ms, **bound(k12c_ops, k12c_bytes + 4 * Bf * Kf * S)})
    emit(f"{plant}_forms_resources", forms_resources(plant, rmodel.net_args(net)[0], vnet))
    return out


def forms_resources(plant: str, args, vnet: dict) -> dict:
    """ptxas' registers, spills and static shared memory of the plant's new
    instances, and the blocks an SM holds of each (the network forms'
    dynamic shared memory for the residual and V)."""
    lib, pid = kernels.load(), kernels.PLANT_IDS[plant]
    name = "".join(w.capitalize() for w in plant.replace("obstacles", "obstacle").split("_"))
    name = name.replace("2d", "2D").replace("3d", "3D")
    inst = f"{len(name) + 5}{name}PlantEEEv"
    vops = plant_value_ops(vnet)
    vargs = kernels.value_args(vops, kernels.PLANT_DIMS[plant][0])
    nbytes_ = ctypes.c_long()
    out = {
        "k1_emit": {**ptxas_resources("cost_rollout_emit_kernel", inst),
                    "blocks_per_sm": int(lib.ctt_cost_rollout_emit_plant_blocks_per_sm(pid, 0))},
        "k1_cols_emit": {**ptxas_resources("cost_rollout_emit_rows_kernel", inst),
                         "blocks_per_sm": int(lib.ctt_cost_rollout_emit_plant_blocks_per_sm(
                             pid, 1))},
        "k2_emit": {**ptxas_resources("mppi_cost_emit_kernel", inst),
                    "blocks_per_sm": int(lib.ctt_mppi_cost_emit_plant_blocks_per_sm(pid))},
        "k4_emit": {**ptxas_resources("mppi_cost_cols_emit_kernel", inst),
                    "blocks_per_sm": int(lib.ctt_mppi_cost_cols_emit_plant_blocks_per_sm(pid))},
        "k12": {**ptxas_resources("residual_cost_rollout_kernel", inst),
                "blocks_per_sm": int(lib.ctt_residual_plant_blocks_per_sm(
                    pid, 0, ctypes.byref(args)))},
        "k12_emit": {**ptxas_resources("residual_cost_rollout_emit_kernel", inst),
                     "blocks_per_sm": int(lib.ctt_residual_plant_blocks_per_sm(
                         pid, 1, ctypes.byref(args)))},
        "k9": {**ptxas_resources("residual_grad_cost_rollout_kernel", inst),
               "blocks_per_sm": int(lib.ctt_residual_grad_plant_layout(
                   pid, ctypes.byref(args), None, ctypes.byref(nbytes_))),
               "smem_bytes": int(nbytes_.value)},
    }
    for key, kernel, adjoint, rows in (
            ("k7_value_forward", "grad_cost_forward_value_kernel", 0, 0),
            ("k7_value_adjoint", "grad_cost_adjoint_value_kernel", 1, 0),
            ("k7_cols_value_forward", "grad_cost_forward_value_rows_kernel", 0, 1),
            ("k7_cols_value_adjoint", "grad_cost_adjoint_value_rows_kernel", 1, 1)):
        out[key] = {**ptxas_resources(kernel, inst),
                    "blocks_per_sm": int(lib.ctt_grad_value_plant_blocks_per_sm(
                        pid, adjoint, rows, ctypes.byref(vargs)))}
    out["k9_value"] = {**ptxas_resources("residual_grad_cost_rollout_value_kernel", inst),
                       "blocks_per_sm": int(lib.ctt_residual_grad_plant_layout(
                           pid, ctypes.byref(args), ctypes.byref(vargs), ctypes.byref(nbytes_))),
                       "smem_bytes": int(nbytes_.value)}
    return out


def forms_mppi_vs_cpu(name: str, card: MPCController, cpu: MPCController, s_now) -> dict:
    """One MPPI update on the card and on the CPU (the plain versions) from
    the card's state and params (its value net and residual among them),
    with one draw: the new plans to UNOM_ATOL."""
    opt = card.optimizer
    state = opt.opt_state
    noise = opt.sample_noise(state)
    params = card._assemble_params()
    _, _, diag = opt.update(state, s_now, params, noise)
    cpu_state = mppi_state_from_numpy(state.u_nom.cpu().numpy(), state.u_prev.cpu().numpy(),
                                      torch.Generator())
    _, _, cdiag = cpu.optimizer.update(cpu_state, s_now.cpu(), to_cpu(params), noise.cpu())
    numbers = {"u_nom_max_abs_err": max_errors(diag["u_nom"].cpu(), cdiag["u_nom"])[0]}
    emit(name, numbers)
    check(numbers["u_nom_max_abs_err"] <= UNOM_ATOL,
          f"{name}: the card's update differs from the CPU's {numbers}")
    return numbers


def forms_fleet_mppi_vs_cpu(name: str, card: BatchedMPCController, cpu: BatchedMPCController,
                            gen, s, psd: tuple, res: bool) -> dict:
    """One fleet MPPI update (K4's emit form under V, or K12's session-row
    form over "ODE+res") on the card against the CPU's from the same state,
    params and draws: costs to the kernel's bound (K12's NET_TOL), the new
    plans to UNOM_ATOL."""
    B, opt = card.num_slots, card.optimizer
    s, dyn, cost, attrs = fleet_inputs_now(card, gen, s)
    noise = opt.sample_slot_noise(card.slot_states.generator, np.ones(B, bool))
    build = "_make_batched_residual_step" if res else "_make_batched_semi_fused_step"
    update, update_c = (getattr(o, build)(B, per_slot_dyn=psd)[1]
                        for o in (opt, cpu.optimizer))
    st = card.slot_states
    u_nom, costs = update(st, s, dyn, cost, attrs, noise)
    u_nom_c, costs_c = update_c(state_to_cpu(st), s.cpu(), to_cpu(dyn), to_cpu(cost),
                                to_cpu(attrs), noise.cpu())
    numbers = {"cost_max_abs_err": max_errors(costs.cpu(), costs_c)[0],
               "u_nom_max_abs_err": max_errors(u_nom.cpu(), u_nom_c)[0]}
    emit(name, numbers)
    check(torch.allclose(costs.cpu(), costs_c, **(NET_TOL if res else KERNEL_TOL))
          and numbers["u_nom_max_abs_err"] <= UNOM_ATOL,
          f"{name}: the fleet update on the card differs from the CPU's {numbers}")
    return numbers


# label: (optimizer, config, "ODE+res", valued, fleet, launches a tick)
FORMS_PATHS = {
    "valued_mppi": ("mppi", OPTIMIZER_CONFIG, False, True, False, {"mppi_cost_emit": 1}),
    "valued_mppi_modular": ("mppi", {**OPTIMIZER_CONFIG, "semi_fused": False}, False, True,
                            False, {"cost_rollout_emit": 1}),
    "valued_rpgd": ("rpgd-tf", RPGD_CONFIG, False, True, False,
                    {"grad_cost_rollout_value": RPGD_CONFIG["outer_its"],
                     "cost_rollout_emit": 1}),
    "adaptive_mppi_residual": ("mppi", RES_MPPI_CONFIG, True, False, False,
                               {"residual_cost_rollout": 1}),
    "rpgd_residual": ("rpgd-tf", RES_RPGD_CONFIG, True, False, False,
                      {"residual_grad_cost_rollout": RES_RPGD_CONFIG["outer_its"],
                       "residual_cost_rollout": 1}),
    "valued_rpgd_residual": ("rpgd-tf", RES_RPGD_CONFIG, True, True, False,
                             {"residual_grad_cost_rollout_value": RES_RPGD_CONFIG["outer_its"],
                              "residual_cost_rollout_emit": 1}),
    "valued_mppi_fleet": ("mppi", FLEET_MPPI_CONFIG, False, True, True,
                          {"mppi_cost_cols_emit": 1}),
    "valued_rpgd_fleet": ("rpgd-tf", FLEET_RPGD_CONFIG, False, True, True,
                          {"grad_cost_rollout_cols_value": FLEET_RPGD_CONFIG["outer_its"],
                           "cost_rollout_cols_emit": 1}),
    "mppi_fleet_residual": ("mppi", FLEET_MPPI_CONFIG, True, False, True,
                            {"residual_cost_rollout_cols": 1}),
    "rpgd_fleet_residual": ("rpgd-tf", FLEET_RPGD_CONFIG, True, False, True,
                            {"residual_grad_cost_rollout_cols": FLEET_RPGD_CONFIG["outer_its"],
                             "residual_cost_rollout_cols": 1}),
    "valued_rpgd_fleet_residual": ("rpgd-tf", FLEET_RPGD_CONFIG, True, True, True,
                                   {"residual_grad_cost_rollout_cols_value":
                                    FLEET_RPGD_CONFIG["outer_its"],
                                    "residual_cost_rollout_cols_emit": 1}),
}


def forms_controller(plant: str, label: str, device: str = "cuda", config: dict = None):
    """The path ``label`` of FORMS_PATHS over the plant: its controller (a
    fleet of FLEET_B) with the plant's V attached and phase 18's residual
    where the path has them."""
    optimizer, cfg, res, valued, fleet, _ = FORMS_PATHS[label]
    cfg = config or cfg
    if fleet:
        ctrl = plant_fleet(plant, optimizer, cfg, FLEET_B, device,
                           spec=res_spec(plant) if res else None)
        if res:
            seed_residual(ctrl.optimizer.predictor.predictor)
    elif res:
        ctrl = plant_res_controller(plant, optimizer, cfg, device)
    else:
        ctrl = plant_controller(plant, optimizer, cfg, device=device)
    if valued:
        attach_value_terminal(ctrl, plant_value_net(plant, torch.device(device)),
                              FORMS_VALUE_SCALE)
    return ctrl


def forms_path_gate(plant: str, label: str, ctrl) -> None:
    """The path took the form it names: the family's gate, the plant."""
    _, _, res, valued, fleet, per_tick = FORMS_PATHS[label]
    opt = ctrl.optimizer
    fam = residual if res else ode
    model = (residual.residual_model if res else ode.rollout_model)(opt)[0]
    ok = model.plant == plant and fam.can_use_cost(opt)
    if label.startswith("valued_mppi") and not fleet:
        ok = ok and opt._uses_semi_fused() == (label == "valued_mppi")
    if "rpgd" in label:
        ok = ok and fam.can_use_grad(opt) and (opt._value_grad_spec() is not None) == valued
    if fleet and label.startswith(("valued_mppi", "mppi")):
        ok = ok and (ctrl._batched_residual_eligible() if res
                     else ctrl._batched_kernel_eligible())
    if fleet and "rpgd" in label:
        ok = ok and ctrl._batched_rpgd_eligible()
    check(ok, f"{plant} {label}: the controller did not take its kernel path")


def forms_update_vs_cpu(gen) -> None:
    """Phase 90: one update of each path over the 3-D quadrotor on the card
    against the CPU's (its plain versions) from the same state, params and
    draws; the gradient paths at one Adam iteration, as phase 86's."""
    plant = "quadrotor3d"
    s_now = plant_states(plant, 1, gen)
    s_b = plant_states(plant, FLEET_B, gen)[:, None]
    psd = (slot_key(plant),)
    for label, (optimizer, cfg, res, valued, fleet, _) in FORMS_PATHS.items():
        if optimizer == "rpgd-tf":
            cfg = {**cfg, "outer_its": 1} if fleet else {**cfg, "outer_its": 1,
                                                          "num_rollouts": FORMS_CPU_K}
        card, cpu = (forms_controller(plant, label, d, cfg) for d in ("cuda", "cpu"))
        forms_path_gate(plant, label, card)
        name = f"forms_{label}_update_vs_cpu_{plant}"
        if fleet and optimizer == "mppi":
            forms_fleet_mppi_vs_cpu(name, card, cpu, gen, s_b, psd, res)
        elif fleet:
            grad_fleet_update_vs_cpu(f"rpgd_forms_{label}_{plant}", card, gen, cpu, s_b, psd)
        elif optimizer == "mppi":
            forms_mppi_vs_cpu(name, card, cpu, s_now)
        else:
            card.optimizer.opt_state = card.optimizer.opt_state._replace(count=0)
            update_vs_cpu_rpgd(card, name, cpu=cpu, s_now=s_now)


def forms_loops(plant: str, gen) -> dict:
    """Phase 91 for one plant: each path of FORMS_PATHS FORMS_TICKS ticks
    (FORMS_SHORT_TICKS over a fast plant) at its width, counted from 0; the
    adaptive MPPI FORMS_ADAPT_TICKS against the plant's environment with
    its FLEET_SLOT_DYN constant FORMS_MISMATCH times the model's, an
    OnlineSysId fit installed every FIT_EVERY ticks (an exact plant)."""
    fast = plant.endswith("_fast")
    runs = []
    for label, (_, _, res, _, fleet, per_tick) in FORMS_PATHS.items():
        T = FORMS_SHORT_TICKS if fast else FORMS_TICKS
        ctrl = forms_controller(plant, label)
        forms_path_gate(plant, label, ctrl)
        name = f"forms_{plant}_{label}"
        if fleet:
            runs.append(plant_fleet_loop(name, ctrl, plant, T,
                                         {k: n * T for k, n in per_tick.items()}))
            continue
        if label != "adaptive_mppi_residual" or fast:
            counts, _, numbers = plant_loop(name, ctrl, plant, T,
                                            {k: n * T for k, n in per_tick.items()})
            emit(name, numbers)
            runs.append(counts)
            continue
        T = FORMS_ADAPT_TICKS
        key = slot_key(plant)
        default = float(ctrl._assemble_params()["dyn"]["base"][key])
        sysid, fits = OnlineSysId(ctrl, **SYSID), []

        def on_tick(t, s, u, s_next):
            sysid.observe(s, u, s_next)
            if (t + 1) % FIT_EVERY == 0:
                fits.append(sysid.fit_and_apply(steps=FIT_STEPS))

        counts, _, numbers = plant_loop(name, ctrl, plant, T,
                                        {k: n * T for k, n in per_tick.items()},
                                        env_params={key: FORMS_MISMATCH * default},
                                        on_tick=on_tick)
        numbers.update(installs=sum(int(f["fitted"]) for f in fits),
                       loss_before_after=[[f.get("loss_before"), f.get("loss_after")]
                                          for f in fits])
        emit(name, numbers)
        check(numbers["installs"] == T // FIT_EVERY, f"{name}: a sysid fit was refused {numbers}")
        runs.append(counts)
    return {kernel: sum(r[kernel] for r in runs) for kernel in COUNTED}


def forms_phases(gen) -> tuple:
    """Phases 89-91: the learned-value and residual forms over plant ids
    2-17.  Returns each kernel row's numbers by (row, plant) and the loops'
    launches by plant."""
    rows, launches = {}, {}
    # 89. Each instance against its plain version.
    for plant in ALL_CASES:
        for key, numbers in forms_plant_kernels(plant, gen).items():
            rows[key, plant] = numbers
    # 90. One update of each path on the card against the CPU's.
    forms_update_vs_cpu(gen)
    # 91. The loops, counted from 0.
    for plant in ALL_CASES:
        launches[plant] = forms_loops(plant, gen)
    return rows, launches


# ---- the learned-dynamics kernels over the nine other costs (phases 92-94) -------------
# A network or GP kernel's plant is its cost's (its dynamics are tensors), so
# each of the nine costs other than cartpole's (NET_COSTS) is an instance of
# each form of K11, K13, K14 and K10.  Phase 92 holds every instance to its
# plain version at the main path's width (K=16384, H=50; the session-row
# forms at FLEET_B sessions of FLEET_K, FLEET_H) over seeded models of the
# committed architectures at the plant's S and U (NETS_SPECS; the GP of
# SGP_128's M with seeded inducing points, nets_gp_params; V phase 89's):
# costs and J to NET_TOL (K13's to RNN_TOL, the GP's to KERNEL_TOL) or, where
# a seeded net's 50 steps carry the two float32 computations further apart,
# to float64 through f64_held; dQ to K7's bound or float64 alike; x_H to
# float64 through f64_held, its kernel ratio the kernel's costs' distance
# from float64 over the plain version's (3xTF32 products against cuBLAS's
# float32 lie further from it, as K8's do), capped at NETS_RATIO_CAP.  Each
# bound rejects the controls read a step early (Q shifted by one step) and
# the cost's named stage term dropped (NETS_DROPPED_TERM's weight zeroed in
# the rows; the emit forms' costs alike): every instance; and the forms'
# own wrong variants: x_{H-1} and the next rollout's (or session's) x_H
# (emit forms), the next session's rows and, K13, hidden (session-row
# forms; the rows' cost weights differ by session), dV/dx_H dropped (K10's
# value form).  Each rejection's margin (the variant's distance over the
# bound's) is printed beside it.  K13's emit x_H bound also rejects a
# control: the plain version with single-pass TF32 products (cuBLAS's),
# held to the same bound, its kernel ratio taken from its own costs.
# Phase 93 holds one update of each path over the 3-D quadrotor on the card
# to the CPU's; phase 94 runs each path NETS_TICKS ticks over every cost at
# its width, every kernel counted from 0.
NET_COSTS = tuple(p for p in kernels.COST_PLANTS if p != "cartpole")
NETS_SPECS = {"mlp": "neural:mlp-64-64", "gru": "neural:GRU-32H1-32H2",
              "lstm": "neural:LSTM-32H1-32H2", "ensemble": "ensemble:mlp-32-32:4", "gp": "gp"}
NETS_GP_M, NETS_GP_SEED, NETS_TICKS, NETS_CPU_K = 128, 92, 2, 1024
# The seeded nets' output layers are scaled by NETS_OUT_SCALE (a step's
# delta ~0.1 of the seeded init's), as a fitted model's small steps are:
# at the init's scale a 50-step rollout of mlp-64-64 is chaotic, and two
# correct float32 evaluations (the kernel's 3xTF32 products, cuBLAS's
# float32) drift apart by more than any bound float64 can give them.
NETS_OUT_SCALE = 0.1
# The most that a kernel's costs' distance from float64, over the plain
# version's, widens its emit form's x_H bound: the largest ratio phase 92
# has read (3.0, the LSTM over quadrotor2d's cost), so that arithmetic that
# drifts cannot widen its own bound further.
NETS_RATIO_CAP = 3.0
# The stage term each cost's instances are held to drop (its weight zeroed
# in the packed rows): the cost's tracking term, and the obstacle term of
# the obstacle costs.
NETS_DROPPED_TERM = {"pendulum": "c_angle_weight", "acrobot": "c_height_weight",
                     "pointmass": "c_pos_weight", "pointmass_obstacles": "c_obstacle_weight",
                     "quadrotor2d": "c_pos_weight", "quadrotor3d": "c_pos_weight",
                     "car": "c_pos_weight", "car_obstacles": "c_obstacle_weight",
                     "arm2": "c_pos_weight"}
# The mangled template argument that names each cost's instances (ptxas'
# entry functions): the point masses' and cars' costs are instances of one
# template each, told apart by their fourth index.
COST_MANGLED = {"pendulum": "12PendulumCostE", "acrobot": "11AcrobotCostE",
                "pointmass": "14PointmassCostTILi0ELi1ELi2ELi3E",
                "pointmass_obstacles": "14PointmassCostTILi0ELi1ELi2ELi5E",
                "quadrotor2d": "15Quadrotor2DCostE", "quadrotor3d": "15Quadrotor3DCostE",
                "car": "8CarCostTILi0ELi1ELi2ELi3E", "car_obstacles": "8CarCostTILi0ELi1ELi2ELi5E",
                "arm2": "8Arm2CostE"}
# row: (source, the TPU kernel, the learned model); {n}, {g}: the cost's
# group of the network and GP instances, as the library dispatches.
NETS_ROWS = {
    "neural_cost_rollout": ("net_plants_{n}.cu", "ops/pallas_neural.py:157", "mlp"),
    "neural_cost_rollout_emit": ("net_plants_{n}.cu", "ops/pallas_neural.py:157", "mlp"),
    "neural_cost_rollout_cols": ("net_plants_{n}.cu", "ops/pallas_neural.py:157", "mlp"),
    "neural_cost_rollout_cols_emit": ("net_plants_{n}.cu", "ops/pallas_neural.py:157", "mlp"),
    "neural_cost_rollout_ens": ("net_plants_{n}.cu", "ops/pallas_neural.py:157", "ensemble"),
    "neural_cost_rollout_ens_emit": ("net_plants_{n}.cu", "ops/pallas_neural.py:157",
                                     "ensemble"),
    **{f"{w}_{kind}": ("net_plants_{n}.cu", "ops/pallas_neural.py:452", kind)
       for w in ("recurrent_cost_rollout", "recurrent_cost_rollout_emit",
                 "recurrent_cost_rollout_cols") for kind in ("gru", "lstm")},
    **{w: ("gp_plants_{g}.cu", "ops/pallas_neural.py:647", "gp")
       for w in ("gp_cost_rollout", "gp_cost_rollout_emit", "gp_cost_rollout_cols",
                 "gp_cost_rollout_cols_emit")},
    **{w: ("gp_plants_{g}.cu", "ops/pallas_grad.py:515", "gp")
       for w in ("gp_grad_cost_rollout", "gp_grad_cost_rollout_value",
                 "gp_grad_cost_rollout_cols", "gp_grad_cost_rollout_cols_value")},
}


def nets_gp_params(S: int, U: int) -> dict:
    """A sparse GP of NETS_GP_M inducing points over [x, u] (the GPPredictor's
    parameter form, numpy), seeded NETS_GP_SEED + S + U: points in [-1, 1]
    after the input's affine transform, a mean that moves a state by ~0.1 a
    step near them."""
    rng = np.random.default_rng(NETS_GP_SEED + S + U)
    D = S + U
    return {"Z": rng.uniform(-1.0, 1.0, (NETS_GP_M, D)).astype(np.float32),
            "lengthscales": rng.uniform(0.8, 1.6, D).astype(np.float32),
            "variance": np.float32(0.8),
            "alpha": (0.05 * rng.standard_normal((NETS_GP_M, S))).astype(np.float32),
            "in_mean": np.zeros(D, np.float32), "in_std": np.full(D, 3.0, np.float32),
            "out_mean": np.full(S, 0.01, np.float32),
            "out_std": rng.uniform(0.5, 1.0, S).astype(np.float32)}


def net_controller(plant: str, kind: str, optimizer: str, config: dict, device: str = "cuda",
                   B: int = 0, valued: bool = False):
    """An ``mpc`` controller (or, with ``B``, a batched-mpc fleet of B
    slots) over the plant's cost and the learned model ``kind``
    (NETS_SPECS; a net's output layer scaled by NETS_OUT_SCALE), with the
    plant's V attached where ``valued``."""
    env, cost, _ = ALL_CASES[plant]
    cls = BatchedMPCController if B else MPCController
    ctrl = cls(env, (ENVS[env].action_low, ENVS[env].action_high), dict(plant_attrs(plant)),
               config={"optimizer": optimizer, "controller_logging": False, "device": device,
                       "cost_function_specification": cost})
    extra = {"num_slots": B} if B else {}
    if kind == "gp":
        extra["predictor_config"] = {"params": nets_gp_params(*kernels.PLANT_DIMS[plant])}
    ctrl.configure(optimizer_name=optimizer, predictor_specification=NETS_SPECS[kind],
                   optimizer_config=dict(config), **extra)
    if kind != "gp":
        net = ctrl.optimizer.predictor.predictor.net_params
        last = ("wo", "bo") if kind in ("gru", "lstm") else (
            f"w{mlp_layer_count(net) - 1}", f"b{mlp_layer_count(net) - 1}")
        for key in last:
            net[key].mul_(NETS_OUT_SCALE)
    if valued:
        attach_value_terminal(ctrl, plant_value_net(plant, torch.device(device)),
                              FORMS_VALUE_SCALE)
    return ctrl


def net_rows(ctrl, model, B: int, gen) -> torch.Tensor:
    """Sessions' packed cost rows ``pvec_b [B, N]``: targets moved by up to
    0.2 a session, previous controls within the limits, the cost's weights
    over 0.8-1.2 of their defaults (a net or a GP has no constant a
    session)."""
    opt, dev = ctrl.optimizer, gen.device
    params = ctrl._assemble_params()
    attrs = {k: float(torch.as_tensor(v).reshape(-1)[0])
             + (0.4 * torch.rand(B, generator=gen, device=dev) - 0.2
                if k.startswith("target") else 0.0)
             for k, v in ctrl.variable_parameters.items()}
    lo, hi = opt.action_low, opt.action_high
    u_prev = lo + (hi - lo) * torch.rand(B, lo.shape[0], generator=gen, device=dev)
    _, slot_keys = split_slot_keys(model.param_keys, ())
    cf = opt.cost_function.cost_function
    rows = make_slot_packer(model.param_keys, slot_keys, cf.attr_defaults, B, dev)(
        u_prev, params["dyn"], params["cost"], attrs)
    weights = [i for i, k in enumerate(model.param_keys) if k.startswith("c_") and "weight" in k]
    rows[:, weights] *= torch.linspace(0.8, 1.2, B, device=dev)[:, None]
    return rows


def step_early(Q: torch.Tensor) -> torch.Tensor:
    """The controls read a step early: step h takes Q[h+1], the last its own."""
    return torch.cat([Q[:, 1:], Q[:, -1:]], dim=1).contiguous()


def term_dropped(model, plant: str, pv: torch.Tensor) -> torch.Tensor:
    """Packed cost rows (one or a session each) with NETS_DROPPED_TERM's
    weight zeroed."""
    out = pv.clone()
    out[..., model.param_keys.index(NETS_DROPPED_TERM[plant])] = 0.0
    return out


class tf32_products:
    """cuBLAS's float32 products in single-pass TF32 while inside."""

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.was


def net_held(label: str, got, ref, ref64_fn, tol, wrong: dict, grad: bool = False,
             ratio_fn=None) -> dict:
    """Costs (or, ``grad``, dQ) of a kernel against its plain version: to
    ``tol`` (dQ: K7's bound), else to float64 through f64_held (where
    ``ratio_fn`` gives the kernel's, the plain version's and the float64
    plain version's costs, their distances' ratio scales the bound, capped
    at NETS_RATIO_CAP); each ``wrong`` output rejected by the same bound,
    its margin (how many times the bound its distance is: over 1 rejected)
    beside it."""
    rtol, atol = (DQ_RTOL, DQ_ATOL_FRAC * float(ref.abs().max())) if grad else (
        tol["rtol"], tol["atol"])

    def near(a) -> bool:
        return torch.allclose(a, ref, rtol=rtol, atol=atol)

    ok = near(got)
    numbers = dict(zip(("max_abs_err", "max_rel_err"), max_errors(got, ref)))
    ref64 = None
    if not ok:
        ref64 = ref64_fn()
        numbers["f64"] = (f64_held(got, ref, ref64) if ratio_fn is None
                          else f64_held(got, ref, ref64, ratio_fn(), NETS_RATIO_CAP))
        check(numbers["f64"]["held"], f"{label}: further from float64 than its bound {numbers}")
    numbers["rejects"] = {k: max_errors(w, ref)[0] for k, w in wrong.items()}
    numbers["reject_margins"] = {}
    for k, w in wrong.items():
        margin = float(torch.nan_to_num((w - ref).abs() / (atol + rtol * ref.abs()),
                                        nan=math.inf).max())
        if ref64 is not None:
            margin = min(margin, f64_err(w, ref64) / numbers["f64"]["bound"])
        numbers["reject_margins"][k] = margin
        check(margin > 1.0, f"{label}: the bound takes {k} {numbers}")
    return numbers


def nets_resources(plant: str, margs: dict, vops: list) -> dict:
    """ptxas' registers and spills of the cost's instances and the blocks
    an SM holds of each plain one (K11, its member-block form and K13 at
    their nets; K14 and K10 at NETS_GP_M points, K10's value form beside
    V)."""
    cost, lib = COST_MANGLED[plant], kernels.load()
    out = {}
    for key, kernel, inst in (
            ("k11", "neural_cost_rollout_kernel", cost),
            ("k11_emit", "neural_cost_rollout_emit_kernel", cost),
            ("k11_ens", "neural_cost_rollout_ens_kernel", cost),
            ("k11_ens_emit", "neural_cost_rollout_ens_emit_kernel", cost),
            ("k13_gru", "recurrent_cost_rollout_kernel", cost + r"(\w*E)?Li3EEEv"),
            ("k13_gru_emit", "recurrent_cost_rollout_emit_kernel", cost + r"(\w*E)?Li3EEEv"),
            ("k13_lstm", "recurrent_cost_rollout_kernel", cost + r"(\w*E)?Li4EEEv"),
            ("k13_lstm_emit", "recurrent_cost_rollout_emit_kernel", cost + r"(\w*E)?Li4EEEv"),
            ("k14", "gp_cost_rollout_kernel", cost),
            ("k14_emit", "gp_cost_rollout_emit_kernel", cost),
            ("k10", "gp_grad_cost_rollout_kernel", cost),
            ("k10_value", "gp_grad_cost_rollout_value_kernel", cost)):
        out[key] = ptxas_resources(kernel, inst)
        check(out[key].get("registers", 0) > 0, f"{plant}: no ptxas line for {kernel}")
    for key, occupancy, arg in (("k11", "neural", margs["mlp"]),
                                ("k11_ens", "neural_ens", margs["ensemble"]),
                                ("k13_gru", "recurrent", margs["gru"]),
                                ("k13_lstm", "recurrent", margs["lstm"])):
        out[key]["blocks_per_sm"] = kernels.net_blocks_per_sm(occupancy, arg, plant)
    for key, grad in (("k14", False), ("k10", True)):
        out[key]["lanes_threads_blocks_per_sm"] = kernels.gp_layout(NETS_GP_M, grad=grad,
                                                                    plant=plant)
    nb = ctypes.c_long(0)
    vargs = kernels.value_args(vops, kernels.PLANT_DIMS[plant][0])
    out["k10_value"]["blocks_per_sm"] = int(lib.ctt_gp_grad_value_layout(
        kernels.PLANT_IDS[plant], NETS_GP_M, ctypes.byref(vargs), ctypes.byref(nb)))
    out["k10_value"]["smem_bytes"] = int(nb.value)
    for key in ("k11", "k11_ens", "k13_gru", "k13_lstm", "k10_value"):
        check(out[key]["blocks_per_sm"] > 0, f"{plant}: {key} fits no block on an SM {out}")
    return out


def nets_plant_kernels(plant: str, gen) -> dict:
    """Phase 92 for one cost: its instances of the forms of K11, K13, K14
    and K10 against their plain versions (see the note above); returns each
    row's numbers."""
    dev = gen.device
    S, U = kernels.PLANT_DIMS[plant]
    _, stage_ops, _, stage_vjp_ops = PLANT_OPS[plant]
    ctrls = {kind: net_controller(plant, kind, "rpgd-tf" if kind == "gp" else "mppi",
                                  RPGD_CONFIG if kind == "gp" else OPTIMIZER_CONFIG)
             for kind in NETS_SPECS}
    opt = ctrls["mlp"].optimizer
    lo, hi = opt.action_low, opt.action_high
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    u_prev = mid + 0.1 * half
    models, margs = {}, {}
    for kind, c in ctrls.items():
        fam = {"gp": gp, "ensemble": ensemble}.get(kind, neural)
        model, pack = (gp.gp_model if kind == "gp" else fam.net_model)(c.optimizer)
        check(model.plant == plant, f"{plant} {kind}: not the cost's plant")
        params = c._assemble_params()
        models[kind] = (model, pack(params, u_prev), params["dyn"])
    vnet = plant_value_net(plant, dev)
    vops = plant_value_ops(vnet)
    v_ops = value_net_ops((S, *FORMS_VALUE_DIMS))
    sK = plant_states(plant, K, gen)
    QK = torch.clamp(mid + half * (0.5 * torch.randn(K, H, U, generator=gen, device=dev)), lo, hi)
    Bf, Kf, Hf = FLEET_B, FLEET_K, FLEET_H
    n = Bf * Kf
    sc = plant_states(plant, Bf, gen).repeat_interleave(Kf, dim=0)
    Qc = lo + (hi - lo) * torch.rand(n, Hf, U, generator=gen, device=dev)
    rows = net_rows(ctrls["mlp"], models["mlp"][0], Bf, gen)
    grows = net_rows(ctrls["gp"], models["gp"][0], Bf, gen)
    dk = "dropped_" + NETS_DROPPED_TERM[plant]
    out = {}

    def timed(name: str, fn, plain_ms: float, numbers: dict, ops: float, n_bytes: float,
              tc_ms: float = None) -> None:
        numbers.update(ms=cuda_ms(fn, 20), plain_ms=plain_ms, **bound(ops, n_bytes))
        if tc_ms is not None:
            numbers["tc_bound_ms"] = tc_ms
        emit(f"{name}_{plant}", numbers)
        out[name] = numbers

    def emit_x(label, x, rx, f64_fn, wrong, costs) -> dict:
        """x_H to float64, the bound scaled by how much further than the
        plain version's the kernel's costs (``costs``: the kernel's, the
        plain version's) lie from the float64 plain version's: the kernel's
        own arithmetic, its 3xTF32 products against cuBLAS's float32, as
        f64_held's kernel ratio takes it."""
        c64, x64 = f64_fn()
        return emit_held(label, x, rx, x64, wrong, (costs[0], costs[1], c64), NETS_RATIO_CAP)

    # K11 over mlp-64-64 (single session, session rows; each with its emit
    # form, whose costs are K11's bit for bit).
    model, pvec, dyn = models["mlp"]
    net = dyn["net"]
    margs["mlp"] = model.net_args(net)[0]
    macs = sum(a * b for a, b in zip(mlp_dims(net), mlp_dims(net)[1:]))
    step_ops = mlp_ops(net) + stage_ops
    for cols in (False, True):
        s0, Q, pv, steps = (sc, Qc, rows, n * Hf) if cols else (sK, QK, pvec, K * H)
        kern = neural_cost_rollout_cols if cols else neural_cost_rollout
        kern_e = neural_cost_rollout_cols_emit if cols else neural_cost_rollout_emit
        plain_e = neural_cost_rollout_cols_emit_plain if cols else neural_cost_rollout_emit_plain
        name = "neural_cost_rollout" + ("_cols" if cols else "")
        c = kern(model, s0, Q, pv, net)
        (rc, rx), plain_ms = plain_timed(lambda: plain_e(model, s0, Q, pv, net))
        wrong = {"controls_a_step_early": kern(model, s0, step_early(Q), pv, net),
                 dk: kern(model, s0, Q, term_dropped(model, plant, pv), net)}
        if cols:
            wrong["next_session_rows"] = kern(model, s0, Q, pv.roll(-1, 0), net)
        f64 = functools.cache(functools.partial(plain_e, model, *tree64((s0, Q, pv)),
                                                tree64(net)))
        numbers = net_held(f"{name}_{plant}", c, rc, lambda: f64()[0], NET_TOL, wrong)
        n_bytes = nbytes(s0, Q, pv, *net.values()) + 4 * c.numel()
        timed(name, lambda: kern(model, s0, Q, pv, net), plain_ms, numbers,
              steps * step_ops, n_bytes, tc_bound_ms(mlp_forward_tiles(net), step_ops - 2 * macs,
                                                     steps))
        ce, x = kern_e(model, s0, Q, pv, net)
        check(torch.equal(ce, c), f"{name}_emit_{plant}: costs differ from the kernel's")
        xw = {"x_H_minus_1": kern_e(model, s0, Q[:, :-1].contiguous(), pv, net)[1],
              ("next_session_x_H" if cols else "next_rollout_x_H"): x.roll(-1, 0)}
        timed(f"{name}_emit", lambda: kern_e(model, s0, Q, pv, net), plain_ms, {
            "max_abs_err": max(max_errors(ce, rc)[0], max_errors(x, rx)[0]),
            "costs": net_held(f"{name}_emit_{plant} costs", ce, rc, lambda: f64()[0], NET_TOL, {
                dk: kern_e(model, s0, Q, term_dropped(model, plant, pv), net)[0]}),
            "x_f64": emit_x(f"{name}_emit_{plant}", x, rx, f64, xw, (ce, rc))},
              steps * step_ops, n_bytes + 4 * x.numel())
    # K11's member-block form over 4 x mlp-32-32 (rollout k under member
    # k // (K/4)), and its emit form.
    model, pvec, dyn = models["ensemble"]
    net = dyn["net"]
    m0 = member_net(net, 0)
    margs["ensemble"] = model.net_args(m0)[0]
    step_ops = mlp_ops(m0) + stage_ops
    macs = sum(a * b for a, b in zip(mlp_dims(m0), mlp_dims(m0)[1:]))
    c = neural_cost_rollout_ens(model, sK, QK, pvec, net)
    (rc, rx), plain_ms = plain_timed(lambda: neural_cost_rollout_ens_emit_plain(
        model, sK, QK, pvec, net))
    f64 = functools.cache(functools.partial(neural_cost_rollout_ens_emit_plain, model,
                                            *tree64((sK, QK, pvec)), tree64(net)))
    pdrop = term_dropped(model, plant, pvec)
    numbers = net_held(f"neural_cost_rollout_ens_{plant}", c, rc, lambda: f64()[0], NET_TOL,
                       {"controls_a_step_early": neural_cost_rollout_ens(
                           model, sK, step_early(QK), pvec, net),
                        dk: neural_cost_rollout_ens(model, sK, QK, pdrop, net)})
    n_bytes = nbytes(sK, QK, pvec, *net.values()) + 4 * K
    timed("neural_cost_rollout_ens", lambda: neural_cost_rollout_ens(model, sK, QK, pvec, net),
          plain_ms, numbers, K * H * step_ops, n_bytes,
          tc_bound_ms(mlp_forward_tiles(m0), step_ops - 2 * macs))
    ce, x = neural_cost_rollout_ens_emit(model, sK, QK, pvec, net)
    check(torch.equal(ce, c), f"neural_cost_rollout_ens_emit_{plant}: costs differ")
    timed("neural_cost_rollout_ens_emit",
          lambda: neural_cost_rollout_ens_emit(model, sK, QK, pvec, net), plain_ms, {
              "max_abs_err": max(max_errors(ce, rc)[0], max_errors(x, rx)[0]),
              "costs": net_held(f"neural_cost_rollout_ens_emit_{plant} costs", ce, rc,
                                lambda: f64()[0], NET_TOL, {
                                    dk: neural_cost_rollout_ens_emit(model, sK, QK, pdrop,
                                                                     net)[0]}),
              "x_f64": emit_x(f"neural_cost_rollout_ens_emit_{plant}", x, rx, f64, {
                  "x_H_minus_1": neural_cost_rollout_ens_emit(
                      model, sK, QK[:, :-1].contiguous(), pvec, net)[1],
                  "next_rollout_x_H": x.roll(-1, 0)}, (ce, rc))},
          K * H * step_ops, n_bytes + 4 * K * S)
    # K13: the GRU and the LSTM, from a seeded nonzero hidden (a row a
    # session for the session-row form), and the emit form.
    for kind in ("gru", "lstm"):
        model, pvec, dyn = models[kind]
        net = dyn["net"]
        hidden = tuple(0.3 * torch.randn(h.shape, generator=gen, device=dev)
                       for h in dyn["hidden"])
        hrows = tuple(0.3 * torch.randn(Bf, h.shape[-1], generator=gen, device=dev)
                      for h in dyn["hidden"])
        margs[kind] = model.net_args(net, hidden)[0]
        step_ops = rnn_ops(net, kind) + stage_ops
        tc = tc_bound_ms(rnn_mma_tiles(net, kind), step_ops - 2 * rnn_macs(net, kind))
        name = f"recurrent_cost_rollout_{kind}"
        c = recurrent_cost_rollout(model, sK, QK, pvec, net, hidden)
        (rc, rx), plain_ms = plain_timed(lambda: recurrent_cost_rollout_emit_plain(
            model, sK, QK, pvec, net, hidden))
        f64 = functools.cache(functools.partial(recurrent_cost_rollout_emit_plain, model,
                                                *tree64((sK, QK, pvec)), tree64(net),
                                                tree64(hidden)))
        pdrop = term_dropped(model, plant, pvec)
        numbers = net_held(f"{name}_{plant}", c, rc, lambda: f64()[0], RNN_TOL, {
            "controls_a_step_early": recurrent_cost_rollout(model, sK, step_early(QK), pvec,
                                                            net, hidden),
            dk: recurrent_cost_rollout(model, sK, QK, pdrop, net, hidden)})
        n_bytes = nbytes(sK, QK, pvec, *leaves(net), *hidden) + 4 * K
        timed(name, lambda: recurrent_cost_rollout(model, sK, QK, pvec, net, hidden), plain_ms,
              numbers, K * H * step_ops, n_bytes, tc)
        ce, x = recurrent_cost_rollout_emit(model, sK, QK, pvec, net, hidden)
        check(torch.equal(ce, c), f"{name}_emit_{plant}: costs differ from the kernel's")
        # The control: the plain version's products in single-pass TF32.
        with tf32_products():
            tc_, tx = recurrent_cost_rollout_emit_plain(model, sK, QK, pvec, net, hidden)
        control = f64_held(tx, rx, f64()[1], (tc_, rc, f64()[0]), NETS_RATIO_CAP)
        control["uncapped_bound"] = GP_F64_FACTOR * control["plain_f64_max_abs_err"] \
            * control["kernel_ratio_uncapped"] + 1e-6 * control["max_abs"]
        check(not control["held"], f"{name}_emit_{plant}: the x_H bound takes the plain "
              f"version in single-pass TF32 {control}")
        timed(f"recurrent_cost_rollout_emit_{kind}",
              lambda: recurrent_cost_rollout_emit(model, sK, QK, pvec, net, hidden), plain_ms, {
                  "max_abs_err": max(max_errors(ce, rc)[0], max_errors(x, rx)[0]),
                  "costs": net_held(f"{name}_emit_{plant} costs", ce, rc, lambda: f64()[0],
                                    RNN_TOL, {dk: recurrent_cost_rollout_emit(
                                        model, sK, QK, pdrop, net, hidden)[0]}),
                  "tf32_control": control,
                  "x_f64": emit_x(f"{name}_emit_{plant}", x, rx, f64, {
                      "x_H_minus_1": recurrent_cost_rollout_emit(
                          model, sK, QK[:, :-1].contiguous(), pvec, net, hidden)[1],
                      "next_rollout_x_H": x.roll(-1, 0)}, (ce, rc))},
              K * H * step_ops, n_bytes + 4 * K * S)
        c = recurrent_cost_rollout_cols(model, sc, Qc, rows, net, hrows)
        rc, plain_ms = plain_timed(lambda: recurrent_cost_rollout_cols_plain(
            model, sc, Qc, rows, net, hrows))
        numbers = net_held(f"recurrent_cost_rollout_cols_{kind}_{plant}", c, rc,
                           lambda: recurrent_cost_rollout_cols_plain(
                               model, *tree64((sc, Qc, rows)), tree64(net), tree64(hrows)),
                           RNN_TOL, {
                               "controls_a_step_early": recurrent_cost_rollout_cols(
                                   model, sc, step_early(Qc), rows, net, hrows),
                               "next_session_rows": recurrent_cost_rollout_cols(
                                   model, sc, Qc, rows.roll(-1, 0), net, hrows),
                               dk: recurrent_cost_rollout_cols(
                                   model, sc, Qc, term_dropped(model, plant, rows), net, hrows),
                               "next_session_hidden": recurrent_cost_rollout_cols(
                                   model, sc, Qc, rows, net,
                                   tuple(h.roll(-1, 0) for h in hrows))})
        timed(f"recurrent_cost_rollout_cols_{kind}",
              lambda: recurrent_cost_rollout_cols(model, sc, Qc, rows, net, hrows), plain_ms,
              numbers, n * Hf * step_ops, nbytes(sc, Qc, rows, *leaves(net), *hrows) + 4 * n,
              tc_bound_ms(rnn_mma_tiles(net, kind), step_ops - 2 * rnn_macs(net, kind), n * Hf))
    # K14 and K10 over the seeded GP, single session and session rows.
    model, pvec, dyn = models["gp"]
    ops = flatten_gp_weights(dyn["gp"])
    k14_ops = gp_ops(ops) + stage_ops
    k10_ops = gp_ops(ops) + gp_vjp_ops(ops) + stage_ops + stage_vjp_ops
    for cols in (False, True):
        s0, Q, pv, steps, nk = (sc, Qc, grows, n * Hf, n) if cols else (sK, QK, pvec, K * H, K)
        kern = gp_cost_rollout_cols if cols else gp_cost_rollout
        kern_e = gp_cost_rollout_cols_emit if cols else gp_cost_rollout_emit
        plain_e = gp_cost_rollout_cols_emit_plain if cols else gp_cost_rollout_emit_plain
        name = "gp_cost_rollout" + ("_cols" if cols else "")
        c = kern(model, s0, Q, pv, ops)
        (rc, rx), plain_ms = plain_timed(lambda: plain_e(model, s0, Q, pv, ops))
        pdrop = term_dropped(model, plant, pv)
        wrong = {"controls_a_step_early": kern(model, s0, step_early(Q), pv, ops),
                 dk: kern(model, s0, Q, pdrop, ops)}
        if cols:
            wrong["next_session_rows"] = kern(model, s0, Q, pv.roll(-1, 0), ops)
        f64 = functools.cache(functools.partial(plain_e, model, *tree64((s0, Q, pv)),
                                                tree64(ops)))
        numbers = net_held(f"{name}_{plant}", c, rc, lambda: f64()[0], KERNEL_TOL, wrong)
        n_bytes = nbytes(s0, Q, pv, *ops.values()) + 4 * c.numel()
        timed(name, lambda: kern(model, s0, Q, pv, ops), plain_ms, numbers, steps * k14_ops,
              n_bytes)
        ce, x = kern_e(model, s0, Q, pv, ops)
        check(torch.equal(ce, c), f"{name}_emit_{plant}: costs differ from the kernel's")
        xw = {"x_H_minus_1": kern_e(model, s0, Q[:, :-1].contiguous(), pv, ops)[1],
              ("next_session_x_H" if cols else "next_rollout_x_H"): x.roll(-1, 0)}
        timed(f"{name}_emit", lambda: kern_e(model, s0, Q, pv, ops), plain_ms, {
            "max_abs_err": max(max_errors(ce, rc)[0], max_errors(x, rx)[0]),
            "costs": net_held(f"{name}_emit_{plant} costs", ce, rc, lambda: f64()[0],
                              KERNEL_TOL, {dk: kern_e(model, s0, Q, pdrop, ops)[0]}),
            "x_f64": emit_x(f"{name}_emit_{plant}", x, rx, f64, xw, (ce, rc))},
              steps * k14_ops, n_bytes + 4 * x.numel())
        # K10 and its value form: J to KERNEL_TOL, dQ to K7's bound.
        for valued in (False, True):
            extra = (vops,) if valued else ()
            gname = "gp_grad_cost_rollout" + ("_cols" if cols else "") + (
                "_value" if valued else "")
            if cols:
                kern_g = gp_grad_cost_rollout_cols_value if valued else gp_grad_cost_rollout_cols
                plain_g = functools.partial(gp_grad_cost_rollout_cols_plain,
                                            value_ops=vops if valued else None)
                plain64 = functools.partial(gp_grad_cost_rollout_cols_plain,
                                            value_ops=tree64(vops) if valued else None)
            else:
                kern_g = gp_grad_cost_rollout_value if valued else gp_grad_cost_rollout
                plain_g = functools.partial(gp_grad_cost_rollout_plain,
                                            value_ops=vops if valued else None)
                plain64 = functools.partial(gp_grad_cost_rollout_plain,
                                            value_ops=tree64(vops) if valued else None)
            cg, dg = kern_g(model, s0, Q, pv, ops, *extra)
            (rcg, rdg), plain_ms = plain_timed(lambda: plain_g(model, s0, Q, pv, ops))
            d64 = functools.cache(functools.partial(plain64, model, *tree64((s0, Q, pv)),
                                                    tree64(ops)))
            cw, dw = kern_g(model, s0, Q, pdrop, ops, *extra)
            wrong = {"controls_a_step_early": kern_g(model, s0, step_early(Q), pv, ops,
                                                     *extra)[1], dk: dw}
            if valued:
                wrong["dV_dx_H_dropped"] = (gp_grad_cost_rollout_cols if cols
                                            else gp_grad_cost_rollout)(model, s0, Q, pv, ops)[1]
            if cols:
                wrong["next_session_rows"] = kern_g(model, s0, Q, pv.roll(-1, 0), ops,
                                                    *extra)[1]
            numbers = {"J": net_held(f"{gname}_{plant} J", cg, rcg, lambda: d64()[0],
                                     KERNEL_TOL, {dk: cw}),
                       "dQ": net_held(f"{gname}_{plant} dQ", dg, rdg, lambda: d64()[1], None,
                                      wrong, grad=True)}
            numbers["max_abs_err"] = max(numbers["J"]["max_abs_err"],
                                         numbers["dQ"]["max_abs_err"])
            timed(gname, lambda k=kern_g, e=extra: k(model, s0, Q, pv, ops, *e), plain_ms,
                  numbers, steps * k10_ops + (nk * v_ops if valued else 0),
                  nbytes(s0, Q, pv, *ops.values(), *(vops if valued else ()))
                  + 4 * nk + 4 * nk * Q.shape[1] * U)
    emit(f"{plant}_nets_resources", nets_resources(plant, margs, vops))
    return out


# label: (optimizer, learned model, config, fleet, valued, launches a tick)
NETS_PATHS = {
    "mppi_mlp": ("mppi", "mlp", OPTIMIZER_CONFIG, False, False, {"neural_cost_rollout": 1}),
    "cem_mlp": ("cem-tf", "mlp", CEM_CONFIG, False, False, {"neural_cost_rollout": 2}),
    "valued_mppi_mlp": ("mppi", "mlp", OPTIMIZER_CONFIG, False, True,
                        {"neural_cost_rollout_emit": 1}),
    "mppi_ensemble": ("mppi", "ensemble", OPTIMIZER_CONFIG, False, False,
                      {"neural_cost_rollout_ens": 1}),
    "valued_mppi_ensemble": ("mppi", "ensemble", OPTIMIZER_CONFIG, False, True,
                             {"neural_cost_rollout_ens_emit": 1}),
    **{f"{p}_{kind}": (opt_, kind, cfg, False, valued, {w: n})
       for kind in ("gru", "lstm")
       for p, opt_, cfg, valued, w, n in (
           ("mppi", "mppi", OPTIMIZER_CONFIG, False, "recurrent_cost_rollout", 1),
           ("cem", "cem-tf", CEM_CONFIG, False, "recurrent_cost_rollout", 2),
           ("valued_mppi", "mppi", OPTIMIZER_CONFIG, True, "recurrent_cost_rollout_emit", 1))},
    "mppi_gp": ("mppi", "gp", OPTIMIZER_CONFIG, False, False, {"gp_cost_rollout": 1}),
    "valued_mppi_gp": ("mppi", "gp", OPTIMIZER_CONFIG, False, True, {"gp_cost_rollout_emit": 1}),
    "rpgd_gp": ("rpgd-tf", "gp", RPGD_CONFIG, False, False,
                {"gp_grad_cost_rollout": RPGD_CONFIG["outer_its"], "gp_cost_rollout": 1}),
    "valued_rpgd_gp": ("rpgd-tf", "gp", RPGD_CONFIG, False, True,
                       {"gp_grad_cost_rollout_value": RPGD_CONFIG["outer_its"],
                        "gp_cost_rollout_emit": 1}),
    "mppi_fleet_mlp": ("mppi", "mlp", FLEET_MPPI_CONFIG, True, False,
                       {"neural_cost_rollout_cols": 1}),
    "valued_mppi_fleet_mlp": ("mppi", "mlp", FLEET_MPPI_CONFIG, True, True,
                              {"neural_cost_rollout_cols_emit": 1}),
    "mppi_fleet_gru": ("mppi", "gru", FLEET_MPPI_CONFIG, True, False,
                       {"recurrent_cost_rollout_cols": 1}),
    "mppi_fleet_lstm": ("mppi", "lstm", FLEET_MPPI_CONFIG, True, False,
                        {"recurrent_cost_rollout_cols": 1}),
    "mppi_fleet_gp": ("mppi", "gp", FLEET_MPPI_CONFIG, True, False, {"gp_cost_rollout_cols": 1}),
    "valued_mppi_fleet_gp": ("mppi", "gp", FLEET_MPPI_CONFIG, True, True,
                             {"gp_cost_rollout_cols_emit": 1}),
    "rpgd_fleet_gp": ("rpgd-tf", "gp", FLEET_RPGD_CONFIG, True, False,
                      {"gp_grad_cost_rollout_cols": FLEET_RPGD_CONFIG["outer_its"],
                       "gp_cost_rollout_cols": 1}),
    "valued_rpgd_fleet_gp": ("rpgd-tf", "gp", FLEET_RPGD_CONFIG, True, True,
                             {"gp_grad_cost_rollout_cols_value": FLEET_RPGD_CONFIG["outer_its"],
                              "gp_cost_rollout_cols_emit": 1}),
}


def nets_path_controller(plant: str, label: str, device: str = "cuda", config: dict = None):
    optimizer, kind, cfg, fleet, valued, _ = NETS_PATHS[label]
    return net_controller(plant, kind, optimizer, config or cfg, device,
                          FLEET_B if fleet else 0, valued)


def nets_path_gate(plant: str, label: str, ctrl) -> None:
    """The path took the form it names: its family's gate over the cost."""
    optimizer, kind, _, fleet, valued, _ = NETS_PATHS[label]
    opt = ctrl.optimizer
    fam = {"gp": gp, "ensemble": ensemble}.get(kind, neural)
    ok = fam.can_use_cost(opt) and (opt._post_terminal_fn() is not None) == valued
    if optimizer == "rpgd-tf":
        ok = ok and fam.can_use_grad(opt) and (opt._value_grad_spec() is not None) == valued
    if fleet and optimizer == "mppi":
        ok = ok and {"mlp": ctrl._batched_neural_eligible, "gp": ctrl._batched_gp_eligible}.get(
            kind, ctrl._batched_recurrent_eligible)()
    if fleet and optimizer == "rpgd-tf":
        ok = ok and ctrl._batched_rpgd_eligible()
    check(ok, f"{plant} {label}: the controller did not take its kernel path")


def nets_tol(kind: str) -> dict:
    """A learned model's cost bound, kernel against plain version: K13's
    RNN_TOL, K11's NET_TOL, the GP's KERNEL_TOL."""
    return {"gru": RNN_TOL, "lstm": RNN_TOL, "gp": KERNEL_TOL}.get(kind, NET_TOL)


def u_nom_bound(cost_err: float, lbd: float, noise: torch.Tensor) -> float:
    """How far two MPPI updates' plans may lie apart when their costs do by
    ``cost_err``: each rollout's softmax weight moves by at most a factor
    exp(2 cost_err / LBD), so the weighted mean of the noise by about
    2 cost_err / LBD times its largest entry; plus UNOM_ATOL."""
    return UNOM_ATOL + 2.0 * cost_err / lbd * float(noise.abs().max())


def nets_mppi_vs_cpu(name: str, card, cpu, s_now, kind: str) -> dict:
    """One MPPI update over ``kind`` on the card and on the CPU (the plain
    versions) from the card's state and params, with one draw: the costs
    to the model's bound (nets_tol), the new plans to u_nom_bound."""
    opt = card.optimizer
    state = opt.opt_state
    noise = opt.sample_noise(state)
    params = card._assemble_params()
    _, _, diag = opt.update(state, s_now, params, noise)
    cpu_state = mppi_state_from_numpy(state.u_nom.cpu().numpy(), state.u_prev.cpu().numpy(),
                                      torch.Generator())
    _, _, cdiag = cpu.optimizer.update(cpu_state, s_now.cpu(), to_cpu(params), noise.cpu())
    costs, costs_c = diag["J_logged"].cpu(), cdiag["J_logged"]
    numbers = {"cost_max_abs_err": max_errors(costs, costs_c)[0],
               "u_nom_max_abs_err": max_errors(diag["u_nom"].cpu(), cdiag["u_nom"])[0]}
    numbers["u_nom_bound"] = u_nom_bound(numbers["cost_max_abs_err"], opt.LBD, noise)
    emit(name, numbers)
    check(torch.allclose(costs, costs_c, **nets_tol(kind))
          and numbers["u_nom_max_abs_err"] <= numbers["u_nom_bound"],
          f"{name}: the card's update differs from the CPU's {numbers}")
    return numbers


def nets_fleet_mppi_vs_cpu(name: str, card, cpu, gen, s, kind: str) -> dict:
    """One fleet MPPI update over ``kind`` (K11's, K13's or K14's session-row
    form) on the card against the CPU's from the same state, params, hidden
    and draws: costs to the model's bound (nets_tol), the new plans to
    u_nom_bound."""
    B, opt = card.num_slots, card.optimizer
    s, dyn, cost, attrs = fleet_inputs_now(card, gen, s)
    noise = opt.sample_slot_noise(card.slot_states.generator, np.ones(B, bool))
    build = {"mlp": "_make_batched_neural_step", "gru": "_make_batched_recurrent_step",
             "lstm": "_make_batched_recurrent_step", "gp": "_make_batched_gp_step"}[kind]
    hidden = (card.slot_hidden,) if card._stateful else ()
    st = card.slot_states
    u_nom, costs = getattr(opt, build)(B)[1](st, s, dyn, cost, attrs, *hidden, noise)
    u_nom_c, costs_c = getattr(cpu.optimizer, build)(B)[1](
        state_to_cpu(st), s.cpu(), to_cpu(dyn), to_cpu(cost), to_cpu(attrs), *to_cpu(hidden),
        noise.cpu())
    numbers = {"cost_max_abs_err": max_errors(costs.cpu(), costs_c)[0],
               "u_nom_max_abs_err": max_errors(u_nom.cpu(), u_nom_c)[0]}
    numbers["u_nom_bound"] = u_nom_bound(numbers["cost_max_abs_err"], opt.LBD, noise)
    emit(name, numbers)
    check(torch.allclose(costs.cpu(), costs_c, **nets_tol(kind))
          and numbers["u_nom_max_abs_err"] <= numbers["u_nom_bound"],
          f"{name}: the fleet update on the card differs from the CPU's {numbers}")
    return numbers


# The paths phase 93 holds card against CPU: each learned model's MPPI and
# CEM, the valued ones, rpgd-tf over the GP and the fleets.
NETS_CPU_PATHS = ("mppi_mlp", "mppi_gru", "mppi_lstm", "cem_mlp", "cem_gru", "cem_lstm",
                  "mppi_gp", "mppi_ensemble", "valued_mppi_mlp", "valued_mppi_gp", "rpgd_gp",
                  "valued_rpgd_gp", "mppi_fleet_mlp", "mppi_fleet_gru", "mppi_fleet_gp",
                  "rpgd_fleet_gp")


def nets_update_vs_cpu(gen) -> None:
    """Phase 93: one update of each path over the 3-D quadrotor's cost on
    the card against the CPU's (the plain versions) from the same state,
    params and draws; the single-session paths at NETS_CPU_K rollouts, the
    gradient ones at one Adam iteration."""
    plant = "quadrotor3d"
    s_now = plant_states(plant, 1, gen)
    s_b = plant_states(plant, FLEET_B, gen)[:, None]
    for label in NETS_CPU_PATHS:
        optimizer, kind, cfg, fleet, valued, _ = NETS_PATHS[label]
        if not fleet:
            cfg = {**cfg, "num_rollouts": NETS_CPU_K}
        if optimizer == "rpgd-tf":
            cfg = {**cfg, "outer_its": 1}
        card, cpu = (nets_path_controller(plant, label, d, cfg) for d in ("cuda", "cpu"))
        nets_path_gate(plant, label, card)
        name = f"nets_{label}_update_vs_cpu_{plant}"
        if fleet and optimizer == "mppi":
            nets_fleet_mppi_vs_cpu(name, card, cpu, gen, s_b, kind)
        elif fleet:
            grad_fleet_update_vs_cpu(f"rpgd_nets_{label}_{plant}", card, gen, cpu, s_b, ())
        elif optimizer == "mppi":
            nets_mppi_vs_cpu(name, card, cpu, s_now, kind)
        elif optimizer == "cem-tf":
            update_vs_cpu_cem(name, card, cfg, cpu=cpu, s_now=s_now, tol=nets_tol(kind))
        else:
            card.optimizer.opt_state = card.optimizer.opt_state._replace(count=0)
            update_vs_cpu_rpgd(card, name, cpu=cpu, s_now=s_now)


def nets_loops(plant: str) -> dict:
    """Phase 94 for one cost: each path of NETS_PATHS NETS_TICKS ticks at its
    width, counted from 0; returns each phase 92 row's launches."""
    runs = {}
    for label, (_, kind, _, fleet, _, per_tick) in NETS_PATHS.items():
        ctrl = nets_path_controller(plant, label)
        nets_path_gate(plant, label, ctrl)
        expected = {k: n * NETS_TICKS for k, n in per_tick.items()}
        name = f"nets_{plant}_{label}"
        if fleet:
            runs[label] = plant_fleet_loop(name, ctrl, plant, NETS_TICKS, expected)
        else:
            counts, _, numbers = plant_loop(name, ctrl, plant, NETS_TICKS, expected)
            emit(name, numbers)
            runs[label] = counts
    launches = {}
    for row, (_, _, kind) in NETS_ROWS.items():
        wrapper = row[:-len(kind) - 1] if row.startswith("recurrent") else row
        launches[row] = sum(counts[wrapper] for label, counts in runs.items()
                            if NETS_PATHS[label][1] == kind)
    emit(f"nets_{plant}_launches", {"ticks_a_path": NETS_TICKS, "launches": launches,
                                    "a_tick": {label: NETS_PATHS[label][5]
                                               for label in NETS_PATHS}})
    return launches


def nets_phases(gen) -> tuple:
    """Phases 92-94: the learned-dynamics kernels over the nine other
    costs.  Returns each row's numbers by (row, plant) and the loops'
    launches by plant."""
    rows, launches = {}, {}
    # 92. Each instance against its plain version.
    for plant in NET_COSTS:
        for key, numbers in nets_plant_kernels(plant, gen).items():
            rows[key, plant] = numbers
    # 93. One update of each path on the card against the CPU's.
    nets_update_vs_cpu(gen)
    # 94. The loops, counted from 0.
    for plant in NET_COSTS:
        launches[plant] = nets_loops(plant)
    return rows, launches


# ---- K8 over the nine other costs (phases 95-97) --------------------------------------------
# K8's plant is its cost's, as K11's is, so each of NET_COSTS is an instance
# of each of its six forms (csrc/neural_grad_plants_<group>.cu).  Phase 95
# holds every instance to its plain version over phase 92's seeded nets
# (mlp-64-64 and 4 x mlp-32-32 at the plant's widths, output layers at
# NETS_OUT_SCALE) and phase 89's V of the plant's S: the single-session and
# member-block forms at the main path's K=16384, H=50, the session-row ones
# at the gradient fleets' GRAD_COLS_SHAPES (H=GRAD_FLEET_H), each form also
# at K8_RAGGED (K=700: 175 rollouts a member, K8_RAGGED_SESSIONS sessions of
# 100; H=45, odd, across the adjoint's history).  J to NET_TOL and dQ to
# K7's bound or, where a seeded net's float32 drift carries the two apart,
# each to float64 through f64_held, dQ's kernel ratio the J's distances'
# from float64 (the kernel's 3xTF32 products against cuBLAS's float32),
# capped at NETS_RATIO_CAP.  Each bound rejects, its margin printed, the
# controls read a step early, NETS_DROPPED_TERM's weight zeroed, the next
# session's rows (session-row forms) and the next member's weights
# (member-block forms); a value form's dQ bound also dV/dx_H dropped (the
# unvalued kernel's dQ), V's scale left out and V without its 1/(H+1).
# Each row records its CUDA-event ms, its plain version's (timed at the
# call that gives its reference), its FP32 and tensor-core bounds, and its
# entry's registers, spills and blocks per SM.  Phase 96 holds one update of
# each path K8 opens over the 3-D quadrotor's cost on the card against the
# CPU's; phase 97 runs each path K8_TICKS ticks over every cost at its
# width, every instance counted from 0.
K8_RAGGED, K8_RAGGED_SESSIONS, K8_TICKS = (700, 45), 7, 2
# row: (wrapper, plain version, learned model, its unvalued form for a value
# form's dV/dx_H-dropped variant, its entry)
K8_ROWS = {
    "neural_grad_cost_rollout": (neural_grad_cost_rollout, neural_grad_cost_rollout_plain, "mlp",
                                 None, "neural_grad_cost_rollout_kernel"),
    "neural_grad_cost_rollout_value": (neural_grad_cost_rollout_value,
                                       neural_grad_cost_rollout_plain, "mlp",
                                       neural_grad_cost_rollout,
                                       "neural_grad_cost_rollout_value_kernel"),
    "neural_grad_cost_rollout_cols": (neural_grad_cost_rollout_cols,
                                      neural_grad_cost_rollout_cols_plain, "mlp", None,
                                      "neural_grad_cost_rollout_kernel"),
    "neural_grad_cost_rollout_cols_value": (neural_grad_cost_rollout_cols_value,
                                            neural_grad_cost_rollout_cols_plain, "mlp",
                                            neural_grad_cost_rollout_cols,
                                            "neural_grad_cost_rollout_value_kernel"),
    "neural_grad_cost_rollout_ens": (neural_grad_cost_rollout_ens,
                                     neural_grad_cost_rollout_ens_plain, "ensemble", None,
                                     "neural_grad_cost_rollout_ens_kernel"),
    "neural_grad_cost_rollout_ens_value": (neural_grad_cost_rollout_ens_value,
                                           neural_grad_cost_rollout_ens_value_plain, "ensemble",
                                           neural_grad_cost_rollout_ens,
                                           "neural_grad_cost_rollout_ens_value_kernel"),
}


def k8_layout(plant: str, args, vops: list, ens: int, valued: bool) -> dict:
    """The blocks an SM holds of the cost's K8 entry (``ens``: the
    member-block form's, over one member's net ``args``; ``valued``: the
    value form's, beside V) and its dynamic shared memory."""
    if not valued:
        occupancy = "neural_grad_ens" if ens else "neural_grad"
        return {"blocks_per_sm": kernels.net_blocks_per_sm(occupancy, args, plant),
                "smem_bytes": kernels.net_smem_bytes(plant, args, occupancy)}
    nb = ctypes.c_long(0)
    vargs = kernels.value_args(vops, kernels.PLANT_DIMS[plant][0])
    blocks = kernels.load().ctt_neural_grad_value_layout(
        kernels.PLANT_IDS[plant], ctypes.byref(args), ctypes.byref(vargs), ens, ctypes.byref(nb))
    return {"blocks_per_sm": int(blocks), "smem_bytes": int(nb.value)}


def k8_plant_kernels(plant: str, gen) -> dict:
    """Phase 95 for one cost: its instances of K8's six forms against their
    plain versions (see the note above); returns each row's numbers."""
    dev = gen.device
    S, U = kernels.PLANT_DIMS[plant]
    _, stage_ops, _, stage_vjp_ops = PLANT_OPS[plant]
    stage = stage_ops + stage_vjp_ops
    vnet = plant_value_net(plant, dev)
    vops, v_ops = plant_value_ops(vnet), value_net_ops((S, *FORMS_VALUE_DIMS))
    models = {}
    for kind in ("mlp", "ensemble"):
        ctrl = net_controller(plant, kind, "rpgd-tf", RPGD_CONFIG)
        fam = ensemble if kind == "ensemble" else neural
        model, pack = fam.net_model(ctrl.optimizer)
        check(model.plant == plant and fam.can_use_grad(ctrl.optimizer),
              f"{plant} {kind}: K8's gate refused the cost")
        lo, hi = ctrl.optimizer.action_low, ctrl.optimizer.action_high
        params = ctrl._assemble_params()
        models[kind] = (ctrl, model, pack(params, 0.5 * (lo + hi) + 0.05 * (hi - lo)),
                        params["dyn"]["net"])
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    sK = plant_states(plant, K, gen)
    QK = torch.clamp(mid + half * (0.5 * torch.randn(K, H, U, generator=gen, device=dev)), lo, hi)
    Kr, Hr = K8_RAGGED
    ctrl, mmodel = models["mlp"][:2]
    fleets = []  # (sessions, rollouts a session, s0, Q, rows), the ragged case last
    for B_, ks in GRAD_COLS_SHAPES:
        fleets.append((B_, ks, plant_states(plant, B_, gen).repeat_interleave(ks, 0),
                       lo + (hi - lo) * torch.rand(B_ * ks, GRAD_FLEET_H, U, generator=gen,
                                                   device=dev), net_rows(ctrl, mmodel, B_, gen)))
    Br = K8_RAGGED_SESSIONS
    fleets.append((Br, Kr // Br, sK[:Kr].contiguous(), QK[:Kr, :Hr].contiguous(),
                   net_rows(ctrl, mmodel, Br, gen)))
    dk = "dropped_" + NETS_DROPPED_TERM[plant]
    out = {}
    for row, (kern, plain, kind, unvalued, entry) in K8_ROWS.items():
        _, model, pvec, net = models[kind]
        valued, members = unvalued is not None, kind == "ensemble"
        one = member_net(net, 0) if members else net
        v = (vops,) if valued else ()
        if "_cols" in row:
            cases = [(f"{b}x{ks}", s, q, r) for b, ks, s, q, r in fleets]
        else:
            cases = [("K16384_H50", sK, QK, pvec), (f"K{Kr}_H{Hr}", sK[:Kr].contiguous(),
                                                     QK[:Kr, :Hr].contiguous(), pvec)]
        held = {}
        for i, (case, s0, Q, pv) in enumerate(cases):
            label = f"{row}_{plant} {case}"
            args = (model, s0, Q, pv, net, *v)
            c, d = kern(*args)
            (rc, rd), plain_ms = plain_timed(lambda a=args: plain(*a))
            f64 = functools.cache(lambda a=args: plain(*as64(a)))
            timed_case = i == len(cases) - 2 if "_cols" in row else i == 0
            wrong, dq_wrong = {}, {}
            if i < len(cases) - 1:  # the wrong variants at the held shapes
                wrong = {"controls_a_step_early": kern(model, s0, step_early(Q), pv, net, *v),
                         dk: kern(model, s0, Q, term_dropped(model, plant, pv), net, *v)}
                if "_cols" in row:
                    wrong["next_session_rows"] = kern(model, s0, Q, pv.roll(-1, 0), net, *v)
                if members:
                    wrong["next_member"] = kern(model, s0, Q, pv, ens_mutants(net)["next_member"],
                                                *v)
                dq_wrong = {k: w[1] for k, w in wrong.items()}
                if valued:
                    Hh = Q.shape[1]
                    dq_wrong.update(
                        dV_dx_H_dropped=unvalued(model, s0, Q, pv, net)[1],
                        value_scale_left_out=kern(model, s0, Q, pv, net,
                                                  plant_value_ops(vnet, 1.0))[1],
                        no_inv_h1=kern(model, s0, Q, pv, net,
                                       vops[:-2] + [vops[-2] * (Hh + 1), vops[-1] * (Hh + 1)])[1])
            numbers = {
                "J": net_held(f"{label} J", c, rc, lambda: f64()[0], NET_TOL,
                              {k: w[0] for k, w in wrong.items()}),
                "dQ": net_held(f"{label} dQ", d, rd, lambda: f64()[1], None, dq_wrong, grad=True,
                               ratio_fn=lambda c=c, rc=rc: (c, rc, f64()[0])),
                "finite": bool(torch.isfinite(c).all() and torch.isfinite(d).all())}
            check(numbers["finite"] and d.shape == Q.shape, f"{label}: bad output")
            numbers["max_abs_err"] = max(numbers["J"]["max_abs_err"], numbers["dQ"]["max_abs_err"])
            if timed_case:
                n, steps = Q.shape[0], Q.shape[0] * Q.shape[1]
                n_bytes = nbytes(s0, Q, pv, *leaves(net), *(vops if valued else ())) \
                    + 4 * n + 4 * Q.numel()
                numbers.update(ms=cuda_ms(lambda a=args: kern(*a), 20), plain_ms=plain_ms,
                               **bound(steps * (mlp_ops(one) + mlp_vjp_ops(one) + stage)
                                       + (n * v_ops if valued else 0), n_bytes),
                               tc_bound_ms=tc_bound_ms(mma_tiles(one),
                                                       mlp_scalar_ops(one) + stage, steps))
            held[case] = numbers
        main = next(c for c in held.values() if "ms" in c)
        args_one = model.net_args(one)[0]
        top = {**main, "cases": {k: n for k, n in held.items() if n is not main},
               "resources": {**ptxas_resources(entry, COST_MANGLED[plant]),
                             **k8_layout(plant, args_one, vops, int(members), valued)}}
        top["max_abs_err"] = max(n["max_abs_err"] for n in held.values())
        check(top["resources"].get("registers", 0) > 0 and top["resources"]["blocks_per_sm"] > 0,
              f"{row}_{plant}: no ptxas line or no block fits an SM {top['resources']}")
        emit(f"{row}_{plant}", top)
        out[row] = top
    return out


# label: (optimizer, learned model, config, fleet, valued, launches a tick)
K8_GRAD_FLEET_CONFIG = {**GRAD_GRADIENT_CONFIG, "num_rollouts": GRAD_LEARNED_CONFIG["num_rollouts"]}
K8_PATHS = {
    **{f"{'valued_' if valued else ''}{p}_{kind}": (
        opt_, kind, cfg, False, valued,
        {"neural_grad_cost_rollout" + ("_ens" if kind == "ensemble" else "")
         + ("_value" if valued else ""): n,
         "neural_cost_rollout" + ("_ens" if kind == "ensemble" else "")
         + ("_emit" if valued else ""): 1})
       for p, opt_, cfg, n, kinds in (
           ("rpgd", "rpgd-tf", RPGD_CONFIG, RPGD_CONFIG["outer_its"], ("mlp", "ensemble")),
           ("gradient", "gradient-tf", GRADIENT_CONFIG, GRADIENT_CONFIG["gradient_steps"],
            ("mlp",)))
       for kind in kinds for valued in (False, True)},
    "cem_naive_grad_mlp": ("cem-naive-grad-tf", "mlp", NAIVE_GRAD_CONFIG, False, False,
                           {"neural_grad_cost_rollout": 1, "neural_cost_rollout": 1}),
    "cem_grad_bharadhwaj_mlp": ("cem-grad-bharadhwaj-tf", "mlp", BHARADHWAJ_CONFIG, False, False,
                                {"neural_grad_cost_rollout": 2, "neural_cost_rollout": 2}),
    "mppi_optimize_mlp": ("mppi-optimize-tf", "mlp", MPPI_OPTIMIZE_WIDE, False, False,
                          {"neural_cost_rollout": 1,
                           "neural_grad_cost_rollout": MPPI_OPTIMIZE_WIDE["optim_steps"]}),
    "rpgd_fleet_mlp": ("rpgd-tf", "mlp", GRAD_LEARNED_CONFIG, True, False,
                       {"neural_grad_cost_rollout_cols": GRAD_LEARNED_CONFIG["outer_its"],
                        "neural_cost_rollout_cols": 1}),
    "valued_rpgd_fleet_mlp": ("rpgd-tf", "mlp", GRAD_LEARNED_CONFIG, True, True,
                              {"neural_grad_cost_rollout_cols_value":
                                   GRAD_LEARNED_CONFIG["outer_its"],
                               "neural_cost_rollout_cols_emit": 1}),
    "gradient_fleet_mlp": ("gradient-tf", "mlp", K8_GRAD_FLEET_CONFIG, True, False,
                           {"neural_grad_cost_rollout_cols": K8_GRAD_FLEET_CONFIG["gradient_steps"],
                            "neural_cost_rollout_cols": 1}),
}


def k8_path_controller(plant: str, label: str, device: str = "cuda", config: dict = None):
    optimizer, kind, cfg, fleet, valued, _ = K8_PATHS[label]
    return net_controller(plant, kind, optimizer, config or cfg, device,
                          FLEET_B if fleet else 0, valued)


def k8_path_gate(plant: str, label: str, ctrl) -> None:
    """The path took the K8 form it names: its family's gradient gate over
    the cost, V's value form where valued, the fleet's batched step."""
    optimizer, kind, _, fleet, valued, _ = K8_PATHS[label]
    opt = ctrl.optimizer
    fam = ensemble if kind == "ensemble" else neural
    ok = fam.can_use_grad(opt) and (opt._value_grad_spec() is not None) == valued
    if fleet:
        ok = ok and (ctrl._batched_rpgd_eligible() if optimizer == "rpgd-tf"
                     else ctrl._batched_gradient_eligible())
    check(ok, f"{plant} {label}: the controller did not take K8's path")


def refine_vs_cpu(name: str, card: MPCController, cpu: MPCController, s_now) -> dict:
    """Phase 96, mppi-optimize-tf: the refinement's Adam steps on the card
    against the CPU's from the card's plan, step by step from the card's
    iterate (adam_steps_vs_cpu: the nominal plan's gradient, K8 at one
    rollout, against its plain version, and the step from it), then the
    refined plan's cost on both."""
    opt, copt = card.optimizer, cpu.optimizer
    state = opt.opt_state
    params = card._assemble_params()
    params_c = to_cpu(params)
    grad_d, grad_c = opt._make_nominal_grad(), copt._make_nominal_grad()
    u_prev, s1 = state.u_prev, s_now[:1].contiguous()
    hyper = types.SimpleNamespace(  # the refinement's Adam, as adam_steps_vs_cpu reads it
        learning_rate=opt.mppi_LR, adam_beta_1=opt.adam_beta_1, adam_beta_2=opt.adam_beta_2,
        adam_epsilon=opt.adam_epsilon, gradmax_clip=opt.gradmax_clip,
        action_low=opt.action_low, action_high=opt.action_high)

    def score_cpu(Q):
        cost = copt._fused_cost(s1.cpu(), Q, u_prev.cpu(), params_c)
        return cost, torch.zeros(1, s1.shape[1]), None, None, copt.mpc_horizon

    return adam_steps_vs_cpu(
        name, lambda Q: grad_d(Q, s1, u_prev, params),
        lambda Q: grad_c(Q, s1.cpu(), u_prev.cpu(), params_c),
        lambda Q: opt._fused_cost(s1, Q, u_prev, params), score_cpu, state.u_nom,
        adam_init(state.u_nom.shape, state.u_nom.device), hyper, opt.optim_steps)


def k8_update_vs_cpu(gen) -> None:
    """Phase 96: one update of each path K8 opens over the 3-D quadrotor's
    cost on the card against the CPU's (the plain versions) from the same
    state, params and draws: rpgd-tf over the MLP (valued too) and the
    ensemble at one Adam iteration, gradient-tf's Adam steps, Bharadhwaj's
    outer iterations, mppi-optimize's refinement, the rpgd-tf and gradient-tf
    fleets; the single-session paths at NETS_CPU_K rollouts, the fleets at
    FLEET_B sessions of FLEET_RPGD_CONFIG's rollouts.  cem-naive-grad
    launches the instance gradient-tf's and Bharadhwaj's steps hold, and
    the valued fleet's form phase 95 holds session by session."""
    plant = "quadrotor3d"
    s_now = plant_states(plant, 1, gen)
    s_b = plant_states(plant, FLEET_B, gen)[:, None]
    for label in K8_PATHS:
        optimizer, kind, cfg, fleet, valued, _ = K8_PATHS[label]
        if label in ("cem_naive_grad_mlp", "valued_rpgd_fleet_mlp"):
            continue
        cfg = ({**cfg, "num_rollouts": FLEET_RPGD_CONFIG["num_rollouts"],
                "mpc_horizon": FLEET_H} if fleet else {**cfg, "num_rollouts": NETS_CPU_K})
        if optimizer == "rpgd-tf":
            cfg = {**cfg, "outer_its": 1}
        card, cpu = (k8_path_controller(plant, label, d, cfg) for d in ("cuda", "cpu"))
        k8_path_gate(plant, label, card)
        name = f"k8_{label}_update_vs_cpu_{plant}"
        if fleet:  # grad_fleet_update_vs_cpu tells RPGD from gradient-tf by the label
            grad_fleet_update_vs_cpu(f"{optimizer[:-3]}_k8_{label}_{plant}", card, gen, cpu,
                                     s_b, ())
        elif optimizer == "rpgd-tf":
            update_vs_cpu_rpgd(card, name, cpu=cpu, s_now=s_now)
        elif optimizer == "gradient-tf":
            gradient_value_update_vs_cpu(card, name, None, cfg, None, cpu=cpu, s_now=s_now)
        elif optimizer == "cem-grad-bharadhwaj-tf":
            zoo_update_vs_cpu(optimizer, card, cfg, cpu=cpu, s_now=s_now)
        else:
            refine_vs_cpu(name, card, cpu, s_now)


def k8_loops(plant: str) -> dict:
    """Phase 97 for one cost: each path of K8_PATHS K8_TICKS ticks at its
    width, counted from 0; returns each phase 95 row's launches."""
    runs = {}
    for label, (_, _, _, fleet, _, per_tick) in K8_PATHS.items():
        ctrl = k8_path_controller(plant, label)
        k8_path_gate(plant, label, ctrl)
        expected = {k: n * K8_TICKS for k, n in per_tick.items()}
        name = f"k8_{plant}_{label}"
        if fleet:
            runs[label] = plant_fleet_loop(name, ctrl, plant, K8_TICKS, expected)
        else:
            counts, _, numbers = plant_loop(name, ctrl, plant, K8_TICKS, expected)
            emit(name, numbers)
            runs[label] = counts
    launches = {row: sum(counts[row] for counts in runs.values()) for row in K8_ROWS}
    emit(f"k8_{plant}_launches", {"ticks_a_path": K8_TICKS, "launches": launches,
                                  "a_tick": {label: K8_PATHS[label][5] for label in K8_PATHS}})
    return launches


def k8_phases(gen) -> tuple:
    """Phases 95-97: K8 over the nine other costs.  Returns each row's
    numbers by (row, plant) and the loops' launches by plant."""
    rows, launches = {}, {}
    # 95. Each instance against its plain version.
    for plant in NET_COSTS:
        for key, numbers in k8_plant_kernels(plant, gen).items():
            rows[key, plant] = numbers
    # 96. One update of each path on the card against the CPU's.
    k8_update_vs_cpu(gen)
    # 97. The loops, counted from 0.
    for plant in NET_COSTS:
        launches[plant] = k8_loops(plant)
    return rows, launches


# ---- the iLQR family (phases 98-100) ---------------------------------------------------------
# optimizers/ilqr.py ("ilqr", "nlp-ilqr", "nlp-forces") launches no kernel of
# the port's: its passes are PyTorch operations on the predictor's
# single_step and the cost's stage and terminal costs, and every count of
# COUNTED stays 0 over its loops.  Each phase holds one step on the card to
# the CPU port's from the same state, params (the card's, copied) and draws
# (ilqr_tick_vs_cpu): u, the plan and J_logged to ILQR_TOL (50 inner
# iterations of float32 passes whose transcendentals and small solves
# round otherwise on the card, cuBLAS and cuSOLVER, than on the CPU); where
# a step is not held, every inner iteration of the card's solve is replayed
# on the CPU from the card's iterate and held to ILQR_ITER_TOL, or, where
# the two line searches accepted differently, their accepted costs tie to
# ILQR_TIE_RTOL: the step is then undetermined, as phase 86's kink rows.
# Phase 98 runs the config_defaults block (ILQR_CONFIG) over cartpole/default
# with the sequential, parallel and six-start solves: each's device
# operations and busy ms a tick (ilqr_tick_profile), then the three in
# turns (ILQR_TURN_TICKS, counted from 0, under
# torch.cuda.set_sync_debug_mode("warn"), the sequential one's step held
# to the CPU's).  Phase 99 holds the
# options at ILQR_OPTION_ITERS iterations: the augmented Lagrangian (a
# velocity box and a terminal set, 4 multiplier updates), six starts from
# the card's draws, the policy's first plan and a failed solve's replay with
# the policy's tail (a NaN cost weight).  Phase 100 runs ILQR_SMALL over
# the nine other costs' ODEs and over cartpole's :fast ODE, the committed
# MLP, a seeded GP, "ODE+res", the committed ensemble and a value terminal:
# ILQR_SMALL_TICKS ticks counted from 0, the first step held to the CPU's.
# config_optimizers.yml's ilqr block as the loader reads it (YAML takes
# "1.0e8" for a string, which the optimizer's float() reads; riccati is
# left to its default, "sequential").
ILQR_CONFIG = {"seed": SEED, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": 1,
               "max_iterations": 50, "tol": 1.0e-6, "regularization_init": 1.0,
               "regularization_max": "1.0e8", "line_search_steps": 8, "state_max": None,
               "terminal_set_width": 0.0, "idx_terminal_set": [], "terminal_set_center": [],
               "al_iterations": 4, "mu_init": 10.0, "mu_growth": 10.0,
               "include_control_change_cost": True, "n_starts": 1}
ILQR_PATHS = {"sequential": {}, "parallel": {"riccati": "parallel"}, "n_starts_6": {"n_starts": 6}}
# Phase 98's ticks of each path in turns, one each: a tick at the defaults
# takes 7-11 s of host beside an H100 (the solve is eager, ~5e5 launches).
ILQR_TURN_TICKS = {"sequential": 1, "parallel": 1, "n_starts_6": 1}
ILQR_OPTION_ITERS, ILQR_SMALL_TICKS = 4, 2
ILQR_PROFILE_ITERS = (1, 2)
ILQR_SMALL = {**ILQR_CONFIG, "mpc_horizon": 20, "max_iterations": 5}
ILQR_CONSTRAINED = {"state_max": ["inf", 0.5, "inf", "inf"], "terminal_set_width": 0.1,
                    "idx_terminal_set": [0], "terminal_set_center": ["target_position"]}
ILQR_TOL = dict(rtol=1e-3, atol=2e-3)
ILQR_ITER_TOL = dict(rtol=1e-4, atol=1e-4)
ILQR_TIE_RTOL = 1e-5
ILQR_START = np.array([0.05, -0.1, 0.15, 0.1], np.float32)


def ilqr_tick_vs_cpu(name: str, card: MPCController, cpu: MPCController, state=None,
                     draws=None, params=None, s_now=ILQR_START, card_out=None) -> dict:
    """One iLQR step of the card's optimizer and of the CPU's from one
    state, params and draws (see the phases' comment above); ``card_out``,
    the card's ``(u, plan)`` of a step already taken from them."""
    opt, copt = card.optimizer, cpu.optimizer
    params = card._assemble_params() if params is None else params
    state = opt.opt_state if state is None else state
    s = torch.tensor(np.asarray(s_now, np.float32)[None], device=opt.device)
    trace, ctrace = [], []
    if card_out is None:
        u, new, diag = opt.update(state, s, params, draws, trace=trace)
        got = {"u": u.cpu(), "plan": new.plan.cpu(), "J": diag["J_logged"].cpu()}
        card_ok, card_j = bool(diag["solver_ok"]), int(new.j)
    else:
        got = {"u": card_out[0].cpu(), "plan": card_out[1].plan.cpu()}
        card_ok, card_j = None, int(card_out[1].j)
    t0 = time.perf_counter()
    cu, cnew, cdiag = copt.update(to_cpu(state), s.cpu(), to_cpu(params),
                                  None if draws is None else draws.cpu(), trace=ctrace)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    ref = {"u": cu, "plan": cnew.plan, "J": cdiag["J_logged"]}
    numbers = {f"{k}_max_abs_err": float((got[k] - ref[k]).abs().nan_to_num().max())
               for k in got}
    held = all(torch.allclose(got[k], ref[k], equal_nan=True, **ILQR_TOL) for k in got) and \
        card_j == int(cnew.j) and card_ok in (None, bool(cdiag["solver_ok"]))
    numbers.update(held=held, solver_ok=bool(cdiag["solver_ok"]), replay_index=card_j,
                   iterations=len(ctrace), cpu_step_ms=cpu_ms)
    if not held:
        if not trace:
            opt.update(state, s, params, draws, trace=trace)
        # The step's start (the policy's plan, a rollout of its own) to
        # phase 83's bound, then each inner iteration from the card's iterate.
        start_err = float((trace[0][0][1].cpu() - ctrace[0][0][1]).abs().max())
        check(start_err <= PLAN_ATOL, f"{name}: the starts differ {start_err}")
        iters_held, ties, worst = 0, 0, 0.0
        for args, out in trace:
            cout = copt.inner_iteration(*to_cpu(args), to_cpu(params))
            if torch.allclose(out[0].cpu(), cout[0], **ILQR_ITER_TOL) and \
                    torch.equal(out[3].cpu(), cout[3]):
                iters_held += 1
                worst = max(worst, float((out[0].cpu() - cout[0]).abs().max()))
                continue
            gap = (out[2].cpu() - cout[2]).abs() / (out[2].cpu().abs() + 1.0)
            check(bool((gap <= ILQR_TIE_RTOL).all()),
                  f"{name}: an inner iteration differs beyond a tie: cost gap {gap.tolist()}")
            ties += 1
        numbers.update(start_max_abs_err=start_err, iterations_held=iters_held,
                       iterations_tied=ties, held_iterations_max_abs_err=worst,
                       undetermined=ties > 0)
    emit(name, numbers)
    return numbers


def ilqr_profile(name: str, tick) -> dict:
    """``torch.profiler`` (device activity) over one call of ``tick``: the
    device busy time and the device operations, read from the trace's
    records (``prof.events()`` takes a minute over a default tick's ~5e5)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ns = per_kernel.get(e.name(), (0, 0))
            per_kernel[e.name()] = (n + 1, ns + e.duration_ns())
    ops = sum(n for n, _ in per_kernel.values())
    check(ops > 0, f"{name}: the trace holds no device operation")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:4]
    return {"tick_wall_ms": wall_ms, "device_ops": ops,
            "device_busy_ms": sum(ns for _, ns in per_kernel.values()) / 1e6,
            "top": [[k[:60], n, ns / 1e6] for k, (n, ns) in top]}


def ilqr_tick_profile(name: str, config: dict) -> dict:
    """The device operations and busy ms of one tick at ``config``'s
    max_iterations, from profiled ticks of one controller (after a warm-up
    tick, from CartpoleEnv(seed=SEED)'s start) at ILQR_PROFILE_ITERS
    iterations, on the line through them: the solve's trip counts are
    fixed, so a tick's operations and busy time grow by an inner
    iteration's at each iteration.  ``probes/ilqr_phases.py --full``
    profiles whole ticks at the defaults, the line's check (PERF.md §6)."""
    ctrl = make_controller("cuda", "ilqr", {**config, "max_iterations": ILQR_PROFILE_ITERS[-1]})
    env_tick(ctrl)()
    reads = {}
    for n in reversed(ILQR_PROFILE_ITERS):
        ctrl.optimizer.max_iterations = n
        ctrl.optimizer._build()
        reads[n] = ilqr_profile(f"{name}_{n}", env_tick(ctrl))
    (n1, r1), (n2, r2) = sorted(reads.items())
    full = config["max_iterations"]
    numbers = {"iterations": full, "profiled": reads}
    for key in ("device_ops", "device_busy_ms"):
        per = (r2[key] - r1[key]) / (n2 - n1)
        numbers[f"{key}_per_iteration"] = per
        numbers[key] = r1[key] + per * (full - n1)
    emit(f"profile_{name}", numbers)
    return numbers


def ilqr_turns(name: str, ctrls: dict, ticks: dict, cpu: MPCController) -> dict:
    """``ticks[k]`` closed-loop ticks of each controller ``k`` in turn
    (in_turns' loop), every kernel's count set to 0 just before and read
    just after (iLQR launches none): the host p50/p99 of each.  Each
    controller's last tick runs under ``torch.cuda.set_sync_debug_mode(
    "warn")`` (its synchronizing calls, by the line that made them; each
    controller's params are placed on the card before, so that none is
    the first placement's), and the first controller's first step is held
    to ``cpu``'s from the same state."""
    import warnings

    envs = {k: CartpoleEnv(batch_size=1, dt=DT, seed=SEED) for k in ctrls}
    states = {k: env.reset()[0] for k, env in envs.items()}
    host, syncs = {k: [] for k in ctrls}, {}
    for c in ctrls.values():
        c._assemble_params()
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    for t in range(max(ticks.values())):
        for k, c in ctrls.items():
            if t >= ticks[k]:
                continue
            last = t == ticks[k] - 1
            state0, s0 = c.optimizer.opt_state, states[k][0].copy()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if last:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    t0 = time.perf_counter()
                    u = c.step(states[k][0])
                    host[k].append((time.perf_counter() - t0) * 1e3)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            if last:
                sites = {}
                for w in caught:
                    if "synchroniz" in str(w.message):
                        site = f"{Path(w.filename).name}:{w.lineno}"
                        sites[site] = sites.get(site, 0) + 1
                syncs[k] = {"synchronizing_calls": sum(sites.values()), "by_site": sites,
                            "in_the_solver": {s_: n for s_, n in sites.items()
                                              if s_.startswith("ilqr.py")}}
            if t == 0 and k == next(iter(ctrls)):
                ilqr_tick_vs_cpu(f"{name}_{k}_step_vs_cpu", c, cpu, state=state0, s_now=s0,
                                 card_out=(c.optimizer.u, c.optimizer.opt_state))
            states[k], *_ = envs[k].step(u)
    counts = {kernel: wrapper.launches for kernel, wrapper in COUNTED.items()}
    check(not any(counts.values()), f"{name}: iLQR launched a kernel {counts}")
    numbers = {k: {"step_host_p50_ms": float(np.percentile(v, 50)),
                   "step_host_p99_ms": float(np.percentile(v, 99)), "ticks": len(v),
                   "sync_debug_tick": syncs[k]} for k, v in host.items()}
    emit(name, numbers)
    return numbers


def ilqr_loop_vs_cpu(name: str, card: MPCController, cpu: MPCController, loop, start) -> dict:
    """``loop(on_tick)`` (a counted closed loop of ``card`` from ``start``),
    its first step held to ``cpu``'s from the same state: the card's read
    from its optimizer after the first tick."""
    opt = card.optimizer
    state0, params0, first = opt.opt_state, card._assemble_params(), []

    def on_tick(t, s, u, s_next):
        if t == 0:
            first.append((opt.u, opt.opt_state))

    counts = loop(on_tick)
    ilqr_tick_vs_cpu(f"{name}_step_vs_cpu", card, cpu, state=state0, params=params0,
                     s_now=start, card_out=first[0])
    return counts


def ilqr_model_controllers(kind: str) -> tuple:
    """Phase 100's cartpole pair (card, CPU) over the learned model or
    option ``kind``: the CPU's weights are the card's, copied (its params
    are the card's in every comparison)."""
    specs = {"fast": FAST_SPEC, "mlp": MLP_SPEC, "gp": "gp", "residual": RES_SPEC,
             "ensemble": ENS_SPEC, "value": "ODE"}
    out = []
    for device in ("cuda", "cpu"):
        ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                             config={"optimizer": "ilqr", "controller_logging": False,
                                     "device": device})
        extra = {"predictor_config": {"params": nets_gp_params(4, 1)}} if kind == "gp" else {}
        ctrl.configure(optimizer_name="ilqr", predictor_specification=specs[kind],
                       optimizer_config=dict(ILQR_SMALL), cost_function_config=COST_WEIGHTS,
                       **extra)
        out.append(ctrl)
    card, cpu = out
    if kind == "residual":
        seed_residual(card.optimizer.predictor.predictor)
    if kind == "value":
        net = plant_value_net("cartpole", torch.device("cuda"))
        attach_value_terminal(card, net, FORMS_VALUE_SCALE)
        attach_value_terminal(cpu, to_cpu(net), FORMS_VALUE_SCALE)
    return card, cpu


def ilqr_phases(gen) -> dict:
    """Phases 98-100.  Returns the host and device numbers of phase 98's
    paths."""
    out = {}
    # 98. The config_defaults block over cartpole/default.
    defaults = {**load_optimizer_config("ilqr"), "seed": SEED}
    check(defaults == ILQR_CONFIG, f"ILQR_CONFIG is not config_defaults' {defaults}")
    ctrls = {label: make_controller("cuda", "ilqr", {**ILQR_CONFIG, **extra})
             for label, extra in ILQR_PATHS.items()}
    check(all(type(c.optimizer).__name__ == "ILQROptimizer" for c in ctrls.values()),
          "the ilqr controllers did not take the iLQR optimizer")
    out["profile"] = {label: ilqr_tick_profile(f"ilqr_{label}", {**ILQR_CONFIG, **extra})
                      for label, extra in ILQR_PATHS.items()}
    out["turns"] = ilqr_turns("ilqr_in_turns", ctrls, ILQR_TURN_TICKS,
                              make_controller("cpu", "ilqr", ILQR_CONFIG))

    # 99. The options on the card.
    opt_cfg = {**ILQR_CONFIG, "max_iterations": ILQR_OPTION_ITERS}
    for label, extra in (("constrained", {**ILQR_CONSTRAINED, "al_iterations": 4}),
                         ("n_starts_6", {"n_starts": 6}),
                         ("policy", {"initial_guess_policy": cartpole_policy})):
        card = make_controller("cuda", "ilqr", {**opt_cfg, **extra})
        cpu = make_controller("cpu", "ilqr", {**opt_cfg, **extra})
        draws = card.optimizer.sample_draws(card.optimizer.opt_state)
        ilqr_tick_vs_cpu(f"ilqr_{label}_step_vs_cpu", card, cpu, draws=draws)
    # A failed solve (a NaN cost weight) from a plan that the card solved:
    # the replay of its next control and the policy's tail.
    card = make_controller("cuda", "ilqr", {**opt_cfg, "initial_guess_policy": cartpole_policy})
    cpu = make_controller("cpu", "ilqr", {**opt_cfg, "initial_guess_policy": cartpole_policy})
    s = torch.tensor(ILQR_START[None], device=gen.device)
    _, solved, _ = card.optimizer.update(card.optimizer.opt_state, s, card._assemble_params())
    bad = card._assemble_params()
    bad = {**bad, "cost": {**bad["cost"], "dd_weight": torch.tensor(float("nan"),
                                                                     device=gen.device)}}
    numbers = ilqr_tick_vs_cpu("ilqr_replay_step_vs_cpu", card, cpu, state=solved, params=bad)
    check(not numbers["solver_ok"] and numbers["replay_index"] == 1 and numbers["held"],
          f"the failed solve was not replayed {numbers}")

    # 100. The other costs and the other predictors at ILQR_SMALL, each
    # loop's first step held to the CPU's.
    launches = {}
    for plant in NET_COSTS:
        card = plant_controller(plant, "ilqr", ILQR_SMALL)
        start = plant_states(plant, 1, gen)[0].cpu().numpy()

        def loop(on_tick, card=card, plant=plant, start=start):
            counts, _, numbers = plant_loop(f"ilqr_{plant}_loop", card, plant, ILQR_SMALL_TICKS,
                                            {}, start=start, on_tick=on_tick)
            emit(f"ilqr_{plant}_loop", numbers)
            return counts

        launches[plant] = ilqr_loop_vs_cpu(
            f"ilqr_{plant}", card, plant_controller(plant, "ilqr", ILQR_SMALL, device="cpu"),
            loop, start)
    for kind in ("fast", "mlp", "gp", "residual", "ensemble", "value"):
        card, cpu = ilqr_model_controllers(kind)
        launches[kind] = ilqr_loop_vs_cpu(
            f"ilqr_{kind}", card, cpu,
            lambda on_tick, card=card, kind=kind: counted_loop(
                f"ilqr_{kind}_loop", card, ILQR_SMALL_TICKS, {}, pole_check=False,
                start=ILQR_START, on_tick=on_tick), ILQR_START)
    out["launches"] = launches
    return out


# ---- closed-loop evaluation, the per-slot step and fleet checkpoints -------------
# Phase 101: ClosedLoop.run of the flagship (K=16384, H=50) for EVAL_TICKS
# from CartpoleEnv(seed=SEED)'s start with actuator noise EVAL_NOISE, and of
# MPPI over the committed GRU for EVAL_GRU_TICKS.  Phase 102: run_batch's
# kernel sweeps of SWEEP_N episodes at the fleets' shapes for SWEEP_TICKS,
# and a per_slot_cost sweep of SWEEP_WEIGHTS x SWEEP_N / 4 episodes.  Phase
# 103: PER_SLOT_B-slot fleets that take the per-slot step, PER_SLOT_TICKS
# ticks with PER_SLOT_FROZEN idle on the second.  Phase 104: save_fleet /
# load_fleet of two fleets, RESUME_TICKS ticks after the load.
EVAL_TICKS, EVAL_GRU_TICKS, EVAL_NOISE, EVAL_NOISE_SEED = 100, 20, 0.05, 4
# The host ms a tick of EVAL_EPISODES episodes of EVAL_PROFILE_TICKS (their
# p50 and p99), and one such episode profiled; a sweep likewise over
# SWEEP_PROFILE_TICKS.
EVAL_EPISODES, EVAL_PROFILE_TICKS, SWEEP_PROFILE_TICKS = 10, 20, 5
SWEEP_N, SWEEP_TICKS, SWEEP_WEIGHTS = 32, 20, (60.0, 120.0, 240.0, 480.0)
# sweep kind: (optimizer, config, spec, the fleet that holds its first tick
# against the CPU's, its launches a tick)
SWEEPS = {
    "ode": ("mppi", FLEET_MPPI_CONFIG, "ODE", {"mppi_cost_cols": 1}),
    "cem-fused": ("cem-tf", FLEET_CEM_CONFIG, "ODE",
                  {"fused_cem_cols": FLEET_CEM_CONFIG["cem_outer_it"]}),
    "rpgd": ("rpgd-tf", GRAD_RPGD_CONFIG, "ODE",
             {"grad_cost_rollout_cols": GRAD_RPGD_CONFIG["outer_its"], "cost_rollout_cols": 1}),
    "neural": ("mppi", FLEET_MPPI_CONFIG, MLP_SPEC, {"neural_cost_rollout_cols": 1}),
}
PER_SLOT_B, PER_SLOT_TICKS, PER_SLOT_FROZEN = 8, 3, (1, 4, 6)
PER_SLOT_FLEETS = {"cem_gmm": ("cem-gmm-tf", GMM_CONFIG),
                   "cem_modular": ("cem-tf", CEM_CONFIG),
                   "rpgd_warmup": ("rpgd-tf", {**RPGD_CONFIG, "warmup": True})}
RESUME_TICKS = 3


def zero_counts() -> None:
    for wrapper in COUNTED.values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {kernel: wrapper.launches for kernel, wrapper in COUNTED.items()}


def expect_counts(name: str, counts: dict, expected: dict) -> None:
    check(counts == {kernel: expected.get(kernel, 0) for kernel in COUNTED},
          f"{name}: kernel launches {counts}, expected {expected}")


def own_loop(ctrl: MPCController, env, s0: np.ndarray, ticks: int, noise=None,
             scale: float = 0.0) -> tuple:
    """The script's own tick loop: ``ctrl.step`` on the host state, the
    actuator noise, the clip and ``env.step_dynamics`` on the card; the
    states, controls and final state as card tensors."""
    device = ctrl.device
    low = torch.as_tensor(env.action_low, device=device)
    high = torch.as_tensor(env.action_high, device=device)
    s, states, controls = torch.as_tensor(s0, device=device)[None], [], []
    for t in range(ticks):
        u = torch.as_tensor(ctrl.step(s[0].cpu().numpy()), device=device)[None]
        if noise is not None:
            u = u + scale * noise[t][None]
        u = torch.clamp(u, low, high)
        states.append(s[0])
        controls.append(u[0])
        s = env.step_dynamics(s, u, env.dt)
    return torch.stack(states), torch.stack(controls), s[0]


def closed_loop_run_phase(device: str = "cuda") -> dict:
    """Phase 101: ``ClosedLoop.run`` of the flagship: bit for bit the
    script's own tick loop from the same state, optimizer generator and
    actuator noise; exactly EVAL_TICKS K2 launches (counted from 0); a
    second episode (``run_device``) under ``set_sync_debug_mode("error")``:
    no synchronizing call; its device and host ms a tick (CUDA events over
    the episode, and the host's wall to its end over the ticks).  Then MPPI
    over the committed GRU (K13): its run against its own loop, the
    hidden written back equal to the loop's predictor's."""
    env = CartpoleEnv(batch_size=1, dt=DT, seed=SEED)
    s0 = env.reset()[0][0]
    device = resolve_device(device)
    noise = torch.randn((EVAL_TICKS, 1), generator=make_generator(EVAL_NOISE_SEED, device),
                        device=device)
    ref_states, ref_controls, ref_final = own_loop(make_controller(str(device)), env, s0,
                                                   EVAL_TICKS, noise, EVAL_NOISE)
    ctrl = make_controller(str(device))
    loop = ClosedLoop(ctrl, env, actuator_noise=EVAL_NOISE, noise_seed=EVAL_NOISE_SEED)
    zero_counts()
    t0 = time.perf_counter()
    out = loop.run(s0, EVAL_TICKS)
    run_wall = time.perf_counter() - t0
    run_counts = read_counts()
    expect_counts("eval_run", run_counts, {"mppi_cost": EVAL_TICKS})
    same = (np.array_equal(out["states"], ref_states.cpu().numpy())
            and np.array_equal(out["controls"], ref_controls.cpu().numpy())
            and np.array_equal(out["final_state"], ref_final.cpu().numpy()))
    # The raw episode, timed, from where the first one ended.
    params = ctrl._assemble_params()
    s_next = torch.as_tensor(out["final_state"], device=device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        start.record()
        episode = loop.run_device(ctrl.optimizer.opt_state, s_next, params, EVAL_TICKS)
        end.record()
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.synchronize()
    wall_s = time.perf_counter() - t0
    stage = episode[4]
    # Host ms a tick: each of EVAL_EPISODES episodes' wall to its end over
    # its ticks; then one episode under the profiler.
    per_tick = []
    for _ in range(EVAL_EPISODES):
        t1 = time.perf_counter()
        loop.run_device(ctrl.optimizer.opt_state, s_next, params, EVAL_PROFILE_TICKS)
        torch.cuda.synchronize()
        per_tick.append((time.perf_counter() - t1) * 1e3 / EVAL_PROFILE_TICKS)
    prof = profile_calls("eval_run", lambda: loop.run_device(ctrl.optimizer.opt_state, s_next,
                                                             params, EVAL_PROFILE_TICKS),
                         1, EVAL_PROFILE_TICKS)
    numbers = {"ticks": EVAL_TICKS, "equal_to_own_loop": same, "k2_launches": EVAL_TICKS,
               "synchronizing_calls_in_episode": 0,
               "device_ms_per_tick": start.elapsed_time(end) / EVAL_TICKS,
               "host_ms_per_tick": wall_s * 1e3 / EVAL_TICKS,
               "host_enqueue_ms_per_tick": enqueue_s * 1e3 / EVAL_TICKS,
               "run_ms_per_tick": run_wall * 1e3 / EVAL_TICKS,
               "episode_host_ms_per_tick_p50": float(np.percentile(per_tick, 50)),
               "episode_host_ms_per_tick_p99": float(np.percentile(per_tick, 99)),
               "device_busy_ms_per_tick": prof["device_busy_ms_per_tick"],
               "device_ops_per_tick": prof["device_ops_per_tick"],
               "mean_cost": out["mean_cost"],
               "max_abs_angle": float(np.abs(out["states"][:, 2]).max()),
               "second_episode_finite": bool(torch.isfinite(stage).all())}
    emit("eval_run", numbers)
    check(same, f"eval_run: ClosedLoop.run differs from the script's own loop {numbers}")
    check(numbers["max_abs_angle"] < 0.5 and numbers["second_episode_finite"],
          f"eval_run: the flagship's episode did not hold the pole {numbers}")

    ref = make_controller(str(device), spec=GRU_SPEC)
    ref_states, ref_controls, _ = own_loop(ref, env, LEARNED_START, EVAL_GRU_TICKS)
    gru = make_controller(str(device), spec=GRU_SPEC)
    gloop = ClosedLoop(gru, env, actuator_noise=0.0)
    zero_counts()
    gout = gloop.run(LEARNED_START, EVAL_GRU_TICKS)
    counts = read_counts()
    expect_counts("eval_run_gru", counts, {"recurrent_cost_rollout": EVAL_GRU_TICKS})
    written = gru.optimizer.predictor.predictor.hidden
    hidden_same = all(torch.equal(a, b) for a, b in
                      zip(written, ref.optimizer.predictor.predictor.hidden))
    gnumbers = {"ticks": EVAL_GRU_TICKS,
                "equal_to_own_loop": bool(np.array_equal(gout["controls"],
                                                          ref_controls.cpu().numpy())),
                "hidden_written_back": hidden_same,
                "hidden_nonzero": bool(any(torch.any(h != 0.0) for h in written))}
    emit("eval_run_gru", gnumbers)
    check(all(gnumbers.values()), f"eval_run_gru: {gnumbers}")
    return {"eval_run": run_counts, "eval_run_gru": counts}


def sweep_loop(kind: str, device: str, weights: dict = None) -> ClosedLoop:
    optimizer, config, spec, _ = SWEEPS[kind]
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": optimizer, "controller_logging": False,
                                 "device": device})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config=config, cost_function_config={**COST_WEIGHTS,
                                                                  **(weights or {})})
    return ClosedLoop(ctrl, CartpoleEnv(batch_size=1, dt=DT, seed=SEED), actuator_noise=0.0)


def sweep_first_tick_vs_cpu(kind: str, s0s: np.ndarray, first_u: np.ndarray, gen,
                            device: str = "cuda") -> None:
    """A sweep's first tick is its fleet's: the fleet of SWEEP_N slots over
    the same configuration (slot n's generator is episode n's) steps the
    same controls, bit for bit; then that fleet's first update against the
    CPU port's, from the same states and draws, as phases 39, 43 and 47 hold
    it (MPPI and K6: ``fleet_update_vs_cpu``; K11: ``learned_fleet_update_vs_cpu``;
    RPGD: ``grad_fleet_update_vs_cpu``, Adam on the keep branch)."""
    optimizer, config, spec, _ = SWEEPS[kind]
    B = SWEEP_N

    def fleet(device):
        return fleet_controller(device, optimizer, config, B, spec, per_slot_dyn=())

    u = fleet(device).step_batch(s0s)
    check(np.array_equal(u, first_u), f"sweep {kind}: its first tick is not its fleet's")
    s = torch.as_tensor(s0s, device=device)[:, None, :]
    if kind == "neural":
        learned_fleet_update_vs_cpu("mlp", fleet(device), gen)
    elif kind == "rpgd":
        grad_fleet_update_vs_cpu("rpgd_ode", fleet(device), gen, cpu=fleet("cpu"), s=s,
                                 per_slot_dyn=())
    elif kind == "ode":
        cem = fleet_controller(device, "cem-tf", FLEET_CEM_CONFIG, B, per_slot_dyn=())
        fleet_update_vs_cpu(fleet(device), cem, gen,
                            cpus=(fleet("cpu"), fleet_controller("cpu", "cem-tf",
                                                                 FLEET_CEM_CONFIG, B,
                                                                 per_slot_dyn=())),
                            s=s, per_slot_dyn=(), name="sweep_update_vs_cpu")


def kernel_sweeps_phase(gen, device: str = "cuda") -> dict:
    """Phase 102: ``run_batch``'s kernel sweeps of SWEEP_N episodes
    (``ode``: K4; ``cem-fused``: K6; ``rpgd``: K7- and K1-cols; ``neural``:
    K11-cols over mlp-64-64), each counted from 0: one session-row launch a
    tick (an iteration) for all episodes; ms a tick; each sweep's first
    tick held to the CPU port's (``sweep_first_tick_vs_cpu``).  Then a
    per_slot_cost sweep of SWEEP_WEIGHTS (dd_weight) x SWEEP_N / 4 episodes
    on K4's rows: row n equal bit for bit to an unswept sweep whose cost
    holds config n's weight."""
    rng = np.random.default_rng(SEED)
    s0s = rng.uniform(-0.05, 0.05, (SWEEP_N, 4)).astype(np.float32)
    runs = {}
    for kind, (_, _, _, per_tick) in SWEEPS.items():
        loop = sweep_loop(kind, device)
        check(loop._sweep_kind() == kind, f"sweep {kind}: took {loop._sweep_kind()}")
        loop.run_batch(s0s, 1)  # builds the batched step
        zero_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = loop.run_batch(s0s, SWEEP_TICKS, return_trajectories=True)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        expect_counts(f"sweep_{kind}", counts,
                      {k: n * SWEEP_TICKS for k, n in per_tick.items()})
        runs[f"sweep_{kind}"] = counts
        numbers = {"episodes": SWEEP_N, "ticks": SWEEP_TICKS,
                   "launches_a_tick": {k: n for k, n in per_tick.items()},
                   "host_ms_per_tick": wall * 1e3 / SWEEP_TICKS,
                   "device_ms_per_tick": start.elapsed_time(end) / SWEEP_TICKS,
                   "episodes_per_s": SWEEP_N * SWEEP_TICKS / wall,
                   "finite": bool(np.isfinite(out["stage_costs"]).all()),
                   "mean_cost": float(out["mean_costs"].mean())}
        emit(f"sweep_{kind}", numbers)
        check(numbers["finite"], f"sweep {kind}: non-finite costs {numbers}")
        per_tick = []
        for _ in range(EVAL_EPISODES):
            t1 = time.perf_counter()
            loop.run_batch(s0s, SWEEP_PROFILE_TICKS)
            per_tick.append((time.perf_counter() - t1) * 1e3 / SWEEP_PROFILE_TICKS)
        prof = profile_calls(f"sweep_{kind}", lambda: loop.run_batch(s0s, SWEEP_PROFILE_TICKS),
                             1, SWEEP_PROFILE_TICKS)
        emit(f"sweep_{kind}_host", {"host_ms_per_tick_p50": float(np.percentile(per_tick, 50)),
                                    "host_ms_per_tick_p99": float(np.percentile(per_tick, 99)),
                                    "device_busy_ms_per_tick": prof["device_busy_ms_per_tick"],
                                    "device_ops_per_tick": prof["device_ops_per_tick"]})
        first = loop.run_batch(s0s, 1, return_trajectories=True)["controls"][:, 0]
        sweep_first_tick_vs_cpu(kind, s0s, first, gen, device)

    per = SWEEP_N // len(SWEEP_WEIGHTS)
    weights = np.repeat(np.asarray(SWEEP_WEIGHTS, np.float32), per)
    loop = sweep_loop("ode", device)
    swept = loop.run_batch(s0s, RESUME_TICKS, return_trajectories=True,
                           sweep_params={"cost": {"dd_weight": weights}})
    check(("ode", SWEEP_N, (), ("dd_weight",)) in loop._kernel_steps,
          "the per_slot_cost sweep did not ride K4's rows")
    equal = []
    for j, w in enumerate(SWEEP_WEIGHTS):
        ref = sweep_loop("ode", device, {"dd_weight": w}).run_batch(s0s, RESUME_TICKS,
                                                                   return_trajectories=True)
        rows = slice(j * per, (j + 1) * per)
        equal.append(bool(np.array_equal(swept["controls"][rows], ref["controls"][rows])
                          and np.array_equal(swept["stage_costs"][rows],
                                             ref["stage_costs"][rows])))
    emit("sweep_per_slot_cost", {"weights": list(SWEEP_WEIGHTS), "episodes_a_weight": per,
                                 "rows_equal": equal})
    check(all(equal), f"the per_slot_cost sweep's rows differ from unswept sweeps {equal}")
    return runs


def state_leaves(state) -> list:
    """A per-slot state's leaves on the host (a generator by its state)."""
    return [_as_array(leaf).copy() for _, leaf in _flatten(state)]


def per_slot_phase(device: str = "cuda") -> dict:
    """Phase 103: PER_SLOT_B-slot fleets of cem-gmm-tf, modular cem-tf and
    rpgd-tf with warmup over the ODE at K=16384, H=50, which take the
    per-slot step, for PER_SLOT_TICKS ticks with PER_SLOT_FROZEN idle on the
    second: each active slot's control equal bit for bit to its
    single-session controller's from the slot's state; a frozen slot
    commands 0 and keeps its state and generator; the fleet's launches (from
    0) equal the single-session steps' (from 0)."""
    runs = {}
    for label, (optimizer, config) in PER_SLOT_FLEETS.items():
        fleet = fleet_controller(device, optimizer, config, PER_SLOT_B, per_slot_dyn=())
        single = make_controller(device, optimizer, config)
        check(fleet._per_slot, f"per_slot {label}: took a kernel step")
        opt = single.optimizer
        refs = [opt._init_state(fleet._slot_generator(i)) for i in range(PER_SLOT_B)]
        rng = np.random.default_rng(SEED + 3)
        masks = [np.ones(PER_SLOT_B, bool) for _ in range(PER_SLOT_TICKS)]
        masks[1][list(PER_SLOT_FROZEN)] = False
        fleet_counts = dict.fromkeys(COUNTED, 0)
        single_counts = dict.fromkeys(COUNTED, 0)
        equal, kept = True, True
        t0 = time.perf_counter()
        for mask in masks:
            s = rng.uniform(-0.05, 0.05, (PER_SLOT_B, 4)).astype(np.float32)
            before = [state_leaves(st) for st in fleet.slot_states]
            zero_counts()
            u = fleet.step_batch(s, mask)
            for k, n in read_counts().items():
                fleet_counts[k] += n
            zero_counts()
            for i in range(PER_SLOT_B):
                if not mask[i]:
                    after = state_leaves(fleet.slot_states[i])
                    kept &= bool(np.all(u[i] == 0.0)) and all(
                        np.array_equal(a, b) for a, b in zip(after, before[i]))
                    continue
                opt.opt_state = refs[i]
                equal &= bool(np.array_equal(u[i], single.step(s[i])))
                refs[i] = opt.opt_state
            for k, n in read_counts().items():
                single_counts[k] += n
        seconds = time.perf_counter() - t0
        numbers = {"slots": PER_SLOT_B, "ticks": PER_SLOT_TICKS, "frozen": list(PER_SLOT_FROZEN),
                   "equal_to_single": equal, "frozen_kept": kept,
                   "launches": {k: n for k, n in fleet_counts.items() if n},
                   "single_launches": {k: n for k, n in single_counts.items() if n},
                   "seconds": seconds}
        emit(f"per_slot_{label}", numbers)
        check(equal and kept and fleet_counts == single_counts and any(fleet_counts.values()),
              f"per_slot {label}: {numbers}")
        runs[f"per_slot_{label}"] = fleet_counts
    return runs


def checkpoint_phase(device: str = "cuda") -> dict:
    """Phase 104: ``save_fleet`` / ``load_fleet`` of an rpgd-tf fleet over
    the ODE (K7- and K1-cols, FLEET_B slots, per-slot pole lengths) and an
    MPPI fleet over the committed GRU (K13-cols, its slots' hiddens), after
    two ticks (a slot idle on the second): a fresh fleet loaded from the
    checkpoint steps the next RESUME_TICKS ticks equal bit for bit to the
    uninterrupted fleet (its launches counted from 0)."""
    runs = {}
    cases = {"rpgd": lambda: grad_fleet(device, "rpgd_ode", FLEET_B),
             "gru": lambda: learned_fleet(device, "gru", FLEET_B)}
    rng = np.random.default_rng(SEED + 4)
    states = [rng.uniform(-0.05, 0.05, (FLEET_B, 4)).astype(np.float32)
              for _ in range(2 + RESUME_TICKS)]
    idle = np.ones(FLEET_B, bool)
    idle[3] = False
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        for label, build in cases.items():
            fleet = build()
            if "L" in fleet.slot_dyn:
                fleet.update_slot_dyn(1, {"L": 0.6})
            fleet.step_batch(states[0])
            fleet.step_batch(states[1], idle)
            path = Path(tmp) / f"{label}.npz"
            save_fleet(path, fleet)
            go_on = [fleet.step_batch(s) for s in states[2:]]
            resumed = build()
            load_fleet(path, resumed)
            zero_counts()
            again = [resumed.step_batch(s) for s in states[2:]]
            counts = read_counts()
            same = bool(np.array_equal(np.stack(go_on), np.stack(again)))
            numbers = {"slots": FLEET_B, "ticks_after_load": RESUME_TICKS, "equal": same,
                       "launches": {k: n for k, n in counts.items() if n},
                       "bytes": path.stat().st_size}
            emit(f"checkpoint_{label}", numbers)
            check(same and any(counts.values()), f"checkpoint {label}: {numbers}")
            runs[f"checkpoint_{label}"] = counts
    return runs


def eval_phases(gen, device: str = "cuda") -> dict:
    """Phases 101-104; each one's launch counts (from 0), by loop."""
    t0 = time.perf_counter()
    runs = closed_loop_run_phase(device)
    seconds = {"101": time.perf_counter() - t0}
    runs.update(kernel_sweeps_phase(gen, device))
    seconds["102"] = time.perf_counter() - t0 - sum(seconds.values())
    runs.update(per_slot_phase(device))
    seconds["103"] = time.perf_counter() - t0 - sum(seconds.values())
    runs.update(checkpoint_phase(device))
    seconds["104"] = time.perf_counter() - t0 - sum(seconds.values())
    emit("eval_phases_seconds", seconds)
    return runs


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
    for _ in range(PROFILE_WARMUP):
        tick()
    profile_calls(name, tick, PROFILE_TICKS, 1)


def profile_calls(name: str, fn, calls: int, ticks_a_call: int) -> dict:
    """``torch.profiler`` over ``calls`` calls of ``fn``, each of
    ``ticks_a_call`` ticks: the loop's wall, device busy time and device
    operations a tick, the busy share and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ticks = calls * ticks_a_call
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in per_kernel.values()) / 1e3 / ticks
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    numbers = {
        "ticks": ticks, "loop_wall_ms_per_tick": wall_ms,
        "device_busy_ms_per_tick": busy_ms, "busy_share": busy_ms / wall_ms,
        "device_ops_per_tick": sum(n for n, _ in per_kernel.values()) / ticks,
        "top": [[k[:60], n / ticks, us / 1e3 / ticks] for k, (n, us) in top],
    }
    emit(f"profile_{name}", numbers)
    return numbers


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
    start_sass()

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
    # K13-GRU's x_H to float64: its float32 plain version drifts from
    # float64 as far as the kernel does (k13_emit_vs_float64, ROADMAP C).
    learned_emit = {label: compare_learned_emit(f"{label}_emit", *form[:6],
                                                K * H * (form[6] + STAGE_OPS),
                                                x_f64=label == "k13_gru")
                    for label, form in forms.items()}
    learned_emit_resources()
    k13_emit_vs_float64(device)

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
    cartpole_rows = {"k1": k1, "k2": k2, "k3": k3a, "k7": k7}
    plant_rows, plant_launches = plant_phases(gen, cartpole_rows)
    # 77-79. The quadrotor2d, quadrotor3d, car and arm2 plants.
    rest_rows, rest_launches = rest_plant_phases(gen, cartpole_rows)
    plant_rows.update(rest_rows)
    plant_launches.update(rest_launches)
    # 80-84. The options: mppi-optimize (K7 and K8 at one rollout), the
    # optimal trajectory, the policy warm start, profile_latency.
    _, option_runs = options_phases(gen)
    for counts in option_runs.values():
        for kernel in COUNTED:
            launches[kernel] += counts[kernel]
    # 85-88. The fleets and fused CEM over plant ids 2-17.
    fleet_rows, fleet_launches = fleet_plant_phases(gen)
    # 89-91. The learned-value and residual forms over plant ids 2-17.
    forms_rows, forms_launches = forms_phases(gen)
    # 92-94. The learned-dynamics kernels over the nine other costs.
    nets_rows, nets_launches = nets_phases(gen)
    # 95-97. K8's six forms over the nine other costs.
    k8_rows, k8_launches = k8_phases(gen)
    # 98-100. The iLQR family (no kernel of the port's).
    ilqr_phases(gen)
    # 101-104. Closed-loop evaluation, run_batch's kernel sweeps, the
    # per-slot fleet step and fleet checkpoints.
    for counts in eval_phases(gen).values():
        for kernel in COUNTED:
            launches[kernel] += counts[kernel]

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
    # Their fleet and fused-CEM instances (phases 85-88): launches from their
    # own loops.
    fleet_sources = {"k5": ("fused_cem", "fused_cem.cu", "ops/pallas_cem.py:38"),
                     "k4": ("mppi_cost_cols", "mppi_cost_cols.cu", "ops/pallas_mppi.py:586"),
                     "k6": ("fused_cem_cols", "fused_cem_cols.cu", "ops/pallas_cem.py:168"),
                     "k1_cols": ("cost_rollout_cols", "cost_rollout.cu",
                                 "ops/pallas_rollout.py:34"),
                     "k7_cols": ("grad_cost_rollout_cols", "grad_cost_rollout.cu",
                                 "ops/pallas_grad.py:335")}
    for (key, plant), numbers in fleet_rows.items():
        normals = key.endswith("_fast_normals")
        wrapper, source, replaces = fleet_sources[key.replace("_fast_normals", "")]
        run = plant + "_fast_normals" if normals else plant
        n, name = fleet_launches[run][wrapper], f"{wrapper}_{run}"
        check(n > 0, f"{name}: launched no time in its plant's loops")
        launches[name] = n
        rows = rows + ((name, source, replaces, numbers),)
    # Their learned-value and residual instances (phases 89-91): launches
    # from their own loops (phase 91).
    for (key, plant), numbers in forms_rows.items():
        n, name = forms_launches[plant][key], f"{key}_{plant}"
        check(n > 0, f"{name}: launched no time in its plant's loops")
        launches[name] = n
        source, replaces = FORMS_SOURCES[key]
        pid, lib = kernels.PLANT_IDS[plant], kernels.load()
        source = source.format(v=lib.ctt_grad_value_group(pid), r=lib.ctt_residual_grad_group(pid))
        rows = rows + ((name, source, replaces, numbers),)
    # Their learned-dynamics instances (phases 92-94): launches from their
    # own loops (phase 94).
    for (key, plant), numbers in nets_rows.items():
        n, name = nets_launches[plant][key], f"{key}_{plant}"
        check(n > 0, f"{name}: launched no time in its cost's loops")
        launches[name] = n
        source, replaces, _ = NETS_ROWS[key]
        pid, lib = kernels.PLANT_IDS[plant], kernels.load()
        source = source.format(n=lib.ctt_net_group(pid), g=lib.ctt_gp_group(pid))
        rows = rows + ((name, source, replaces, numbers),)
    # Their K8 instances (phases 95-97): launches from their own loops (phase
    # 97), the source their cost's group (net_group).
    for (key, plant), numbers in k8_rows.items():
        n, name = k8_launches[plant][key], f"{key}_{plant}"
        check(n > 0, f"{name}: launched no time in its cost's loops")
        launches[name] = n
        group = kernels.load().ctt_net_group(kernels.PLANT_IDS[plant])
        rows = rows + ((name, f"neural_grad_plants_{group}.cu", "ops/pallas_grad.py:387",
                        numbers),)
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
