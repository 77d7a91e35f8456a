"""Build, load and describe the port's CUDA kernels (``csrc/``).

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and bound with ``ctypes``.  The build
runs at first use, goes to ``control_toolkit_tpu_torch/_build/`` (listed
in ``.gitignore``) and is keyed by a hash of the sources and flags; it
writes a temporary file and renames it into place, so an interrupted or
concurrent build never leaves a truncated library behind.  Nothing here
runs at import: the CPU tests import every module, and this machine may
have neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# The plants other than cartpole's take K7's value_spec forms, K12 and K9
# from sources of their own, K7's and K9's in groups of plants
# (grad_value_plants_<group>.cu, residual_cost_plants.cu,
# residual_grad_plants_<group>.cu), and the costs other than cartpole's
# K11's and K13's forms, K8's, K14's and K10's from groups of costs
# (net_plants_<group>.cu, neural_grad_plants_<group>.cu,
# gp_plants_<group>.cu), so that no source's build grows.  The sources are listed heaviest first, by their nvcc's CPU
# seconds (probes/build_times.py on the card's host, PERF.md): build()
# starts them in this order, one a CPU at a time.
SOURCES = ("grad_cost_rollout.cu", "grad_value_plants_1.cu", "residual_grad_plants_3.cu",
           "residual_rollout.cu", "residual_grad_plants_4.cu", "residual_grad_plants_2.cu",
           "residual_grad_plants_0.cu", "neural_grad_rollout.cu", "neural_grad_plants_2.cu",
           "residual_cost_plants.cu", "neural_grad_plants_3.cu", "neural_grad_plants_0.cu",
           "residual_grad_plants_1.cu", "cost_rollout.cu", "grad_value_plants_0.cu",
           "neural_grad_plants_4.cu", "mppi_cost_cols.cu", "mppi_cost.cu",
           "neural_grad_plants_1.cu", "fused_cem.cu", "fused_cem_cols.cu", "fused_mppi.cu",
           "net_plants_2.cu", "net_plants_0.cu", "net_plants_3.cu", "neural_rollout.cu",
           "net_plants_4.cu", "gp_plants_2.cu", "net_plants_1.cu", "gp_rollout.cu",
           "gp_plants_1.cu", "gp_plants_0.cu")
HEADERS = ("rollout_core.cuh", "plants.cuh", "neural_core.cuh", "mlp_mma.cuh", "rnn_mma.cuh",
           "mlp_units.cuh", "gp_core.cuh", "counter_prng.cuh", "cem_core.cuh",
           "short_step.cuh", "mppi_ahead.cuh", "value_mlp.cuh", "grad_core.cuh",
           "residual_core.cuh", "net_rollout.cuh", "gp_kernels.cuh", "neural_grad_core.cuh")
# Per-source compile flags; the objects are then linked with -shared.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Device plants (csrc/plants.cuh): the id each C entry point dispatches on,
# and the packed-parameter order the plant reads — Optimizer._soa_bindings'
# order for its (dynamics, cost) pair: the dynamics' constants, then the
# cost's part.  A plant is such a pair: the environment's dynamics and one
# of the costs its device plants evaluate (kernel_families/ode.py
# DEVICE_COSTS), named after the cost (``pointmass_obstacles`` is the
# pointmass dynamics under pointmass/obstacles).  The network-rollout
# kernels, whose dynamics are weight tensors, read the cost's part alone
# (_soa_bindings(include_dyn=False)).  A fast plant (``<plant>_fast``) is
# its plant's dynamics over the polynomial trig of csrc/fastmath.cuh, with
# the plant's parameter layout and exact cost; the fully-fused kernels
# over it draw their normals with the fast Box-Muller (the JAX
# fast_sampling form), so a fast plant and fast sampling always come
# together, as the JAX optimizers pair them (fast_sampling=pred.fast_math).
# Pointmass has no trig: its exact dynamics double as the fast ones
# (EXACT_IS_FAST), so a ``:fast`` pointmass predictor keeps the exact
# plant, and only the fully-fused kernels (K3, K5, K6), which draw the
# fast normals over it, take the fast flag (``RolloutModel.fast_sampling``).  The car's fast dynamics
# differ from its exact ones, so car/obstacles has a fast plant of its
# own (``car_obstacles_fast``), as every (dynamics, cost) pair over a trig
# plant does.
PLANT_IDS = {"cartpole": 0, "cartpole_fast": 1, "pendulum": 2, "pendulum_fast": 3,
             "acrobot": 4, "acrobot_fast": 5, "pointmass": 6, "pointmass_obstacles": 7,
             "quadrotor2d": 8, "quadrotor2d_fast": 9, "quadrotor3d": 10, "quadrotor3d_fast": 11,
             "car": 12, "car_fast": 13, "car_obstacles": 14, "car_obstacles_fast": 15,
             "arm2": 16, "arm2_fast": 17}
FAST_PLANTS = {"cartpole": "cartpole_fast", "pendulum": "pendulum_fast",
               "acrobot": "acrobot_fast", "quadrotor2d": "quadrotor2d_fast",
               "quadrotor3d": "quadrotor3d_fast", "car": "car_fast",
               "car_obstacles": "car_obstacles_fast", "arm2": "arm2_fast"}  # plant -> fast plant
EXACT_IS_FAST = frozenset({"pointmass", "pointmass_obstacles"})
PLANT_DIMS = {"cartpole": (4, 1), "pendulum": (2, 1), "acrobot": (4, 1),
              "pointmass": (4, 2), "pointmass_obstacles": (4, 2), "quadrotor2d": (6, 2),
              "quadrotor3d": (12, 4), "car": (4, 2), "car_obstacles": (4, 2),
              "arm2": (4, 2)}  # (S, U)
_POINTMASS_DYN = ("d_drag", "d_mass", "d_u_max")
_CAR_DYN = ("d_accel_max", "d_drag", "d_steer_max", "d_v_max", "d_wheelbase")
_OBSTACLE_ATTRS = tuple(f"a_obs{i}_{c}" for i in range(3) for c in ("r", "x", "y"))
DYN_PARAM_KEYS = {
    "cartpole": ("d_L", "d_friction_cart", "d_friction_pole", "d_g", "d_m_cart",
                 "d_m_pole", "d_u_max"),
    "pendulum": ("d_L", "d_damping", "d_g", "d_m", "d_u_max"),
    "acrobot": ("d_I1", "d_I2", "d_g", "d_l1", "d_l2", "d_lc1", "d_lc2", "d_m1", "d_m2",
                "d_u_max"),
    "pointmass": _POINTMASS_DYN,
    "pointmass_obstacles": _POINTMASS_DYN,
    "quadrotor2d": ("d_I", "d_arm", "d_drag", "d_g", "d_m", "d_u_max"),
    "quadrotor3d": ("d_Ix", "d_Iy", "d_Iz", "d_arm", "d_drag", "d_g", "d_k_yaw", "d_m",
                    "d_u_max"),
    "car": _CAR_DYN,
    "car_obstacles": _CAR_DYN,
    "arm2": ("d_I1", "d_I2", "d_b", "d_g", "d_l1", "d_l2", "d_lc1", "d_lc2", "d_m1", "d_m2",
             "d_u_max"),
}
COST_PARAM_KEYS = {
    "cartpole": ("c_R", "c_cc_weight", "c_ccrc_weight", "c_dd_weight", "c_ekp_weight",
                 "c_ep_weight", "a_target_position", "__u_prev_0"),
    "pendulum": ("c_L", "c_angle_weight", "c_control_weight", "c_energy_weight", "c_g", "c_m",
                 "c_velocity_weight", "__u_prev_0"),
    "acrobot": ("c_control_weight", "c_height_weight", "c_l1", "c_l2", "c_velocity_weight",
                "__u_prev_0"),
    "pointmass": ("c_R", "c_cc_weight", "c_ccrc_weight", "c_pos_weight", "c_vel_weight",
                  "a_target_x", "a_target_y", "__u_prev_0", "__u_prev_1"),
    "pointmass_obstacles": (
        "c_R", "c_cc_weight", "c_ccrc_weight", "c_clearance", "c_obstacle_weight",
        "c_pos_weight", "c_vel_weight",
        *_OBSTACLE_ATTRS, "a_target_x", "a_target_y", "__u_prev_0", "__u_prev_1"),
    "quadrotor2d": ("c_cc_weight", "c_ccrc_weight", "c_hover_thrust", "c_pos_weight",
                    "c_rate_weight", "c_tilt_weight", "c_vel_weight", "a_target_x", "a_target_z",
                    "__u_prev_0", "__u_prev_1"),
    "quadrotor3d": ("c_cc_weight", "c_ccrc_weight", "c_hover_thrust", "c_pos_weight",
                    "c_rate_weight", "c_tilt_weight", "c_vel_weight", "c_yaw_weight",
                    "a_target_x", "a_target_y", "a_target_yaw", "a_target_z",
                    *(f"__u_prev_{j}" for j in range(4))),
    "car": ("c_arrive_radius", "c_cc_weight", "c_ccrc_weight", "c_pos_weight",
            "c_steer_weight", "c_vel_weight", "a_target_x", "a_target_y", "__u_prev_0",
            "__u_prev_1"),
    "car_obstacles": (
        "c_arrive_radius", "c_cc_weight", "c_ccrc_weight", "c_clearance", "c_obstacle_weight",
        "c_pos_weight", "c_steer_weight", "c_vel_weight", *_OBSTACLE_ATTRS, "a_target_x",
        "a_target_y", "__u_prev_0", "__u_prev_1"),
    "arm2": ("c_R", "c_cc_weight", "c_ccrc_weight", "c_l1", "c_l2", "c_pos_weight",
             "c_vel_weight", "a_target_x", "a_target_y", "__u_prev_0", "__u_prev_1"),
}
for _env, _fast in FAST_PLANTS.items():
    DYN_PARAM_KEYS[_fast], COST_PARAM_KEYS[_fast] = DYN_PARAM_KEYS[_env], COST_PARAM_KEYS[_env]
    PLANT_DIMS[_fast] = PLANT_DIMS[_env]
PLANT_PARAM_KEYS = {plant: DYN_PARAM_KEYS[plant] + COST_PARAM_KEYS[plant] for plant in PLANT_IDS}

# Which kernel entries carry which plant instances (the C entries' switches
# refuse every other plant id with cudaErrorInvalidValue).  Every gate and
# wrapper consults it (``require``): a path on which the JAX package would
# launch a kernel over a plant that the port's kernel has no instance of
# raises, and never takes the scan or another kernel instead.  The
# network kernels' plant is their cost's (the dynamics are a net or a GP):
# one of COST_PLANTS, the names kernel_families/ode.py ``cost_plant`` gives
# (no learned model has fast dynamics, so no ``_fast`` id); the residual
# kernels' the base's.
CARTPOLE_PLANTS = ("cartpole", "cartpole_fast")
ODE_PLANTS = tuple(PLANT_IDS)
COST_PLANTS = tuple(p for p in PLANT_DIMS if p not in FAST_PLANTS.values())
KERNEL_PLANTS = {
    **{form: ODE_PLANTS for form in (
        "K1", "K2", "K3", "K4", "K5", "K6", "K7", "K1's session-row form",
        "K7's session-row form", "K1's emit_terminal form", "K1's session-row emit_terminal form",
        "K2's emit_terminal form", "K4's emit_terminal form", "K7's value_spec form",
        "K7's session-row value_spec form", "K9", "K9's value_spec form",
        "K9's session-row form", "K9's session-row value_spec form", "K12",
        "K12's emit_terminal form", "K12's session-row form",
        "K12's session-row emit_terminal form")},
    **{form: COST_PLANTS for form in (
        "K10", "K10's value_spec form", "K10's session-row form",
        "K10's session-row value_spec form", "K11", "K11's emit_terminal form",
        "K11's member-block form", "K11's member-block emit_terminal form",
        "K11's session-row form", "K11's session-row emit_terminal form", "K13",
        "K13's emit_terminal form", "K13's session-row form", "K14", "K14's emit_terminal form",
        "K14's session-row form", "K14's session-row emit_terminal form", "K8",
        "K8's value_spec form", "K8's member-block form", "K8's member-block value_spec form",
        "K8's session-row form", "K8's session-row value_spec form")},
}


def require(kernel: str, plant: str) -> None:
    """Raise NotImplementedError, naming the kernel and the plant, unless
    ``kernel`` (a KERNEL_PLANTS entry) carries ``plant``."""
    if plant not in KERNEL_PLANTS[kernel]:
        raise NotImplementedError(
            f"{kernel} over the {plant!r} plant is not ported to control_toolkit_tpu_torch yet "
            f"(ROADMAP; it carries {', '.join(KERNEL_PLANTS[kernel])})")


def require_lanes(kernel: str, plant: str, lanes: int) -> None:
    """Raise NotImplementedError, naming the kernel and the plant, where a
    GP kernel is asked for ``lanes`` lanes a rollout (0: the kernel's own)
    over a cost whose instance is built at the kernel's own count alone
    (every cost but cartpole's; gp_layout reads that count)."""
    if plant != "cartpole" and lanes != 0:
        raise NotImplementedError(
            f"{kernel} at {lanes} lanes a rollout over the {plant!r} plant is not instantiated "
            "(its instances over the costs other than cartpole's take the kernel's own count: "
            "lanes 0)")


def plant_key(pred, cost_plant: str = None) -> str:
    """The device plant of an ODE predictor (a residual predictor's base)
    under the cost whose plant is ``cost_plant`` (kernel_families/ode.py
    ``cost_plant``; None: the environment's default cost): that plant, or
    its fast plant where the predictor runs the polynomial trig
    (``fast_math``) and one exists."""
    base = getattr(pred, "base", pred)
    plant = cost_plant or base.environment_name
    return FAST_PLANTS.get(plant, plant) if getattr(base, "fast_math", False) else plant


# Network forms of the network-rollout kernels (csrc/neural_core.cuh NetKind)
# and the most layers (MLP) or cells (GRU/LSTM) a net may have there.
NET_KINDS = {"mlp": 0, "gru": 1, "lstm": 2}
MAX_LAYERS = 8
# The most layers of a learned terminal value net in the value_spec forms
# of K7-K10 (csrc/value_mlp.cuh kMaxValueLayers).
VALUE_MAX_LAYERS = 8


@dataclass(frozen=True)
class RolloutModel:
    """What a rollout kernel integrates and scores, in both forms: the
    device plant's name for the CUDA kernel, and the component-form
    callables (over a dict of ``param_keys`` -> pvec entries) that the
    plain PyTorch versions run."""

    plant: str
    param_keys: Tuple[str, ...]
    derivs: Callable      # (xs, us, p) -> dxs
    stage: Callable       # (xs, us, prev_us, p) -> [K]; with ccrc and -MAX_COST
    terminal: Callable    # (xs, p) -> [K]
    integrator: str
    dt: float
    intermediate_steps: int
    max_cost: float
    # The fast normals over a plant whose exact dynamics double as the fast
    # ones (EXACT_IS_FAST: a ":fast" pointmass predictor); a fast plant
    # draws them anyway (``fast_math``).
    fast_sampling: bool = False

    def __post_init__(self):
        if self.plant not in PLANT_IDS:
            raise ValueError(f"no device plant {self.plant!r}; known: {sorted(PLANT_IDS)}")
        if self.fast_sampling and self.plant not in EXACT_IS_FAST:
            raise ValueError(f"the {self.plant!r} plant takes no fast_sampling flag (its fast "
                             "plant draws the fast normals)")
        if self.param_keys != PLANT_PARAM_KEYS[self.plant]:
            raise ValueError(
                f"packed parameters {self.param_keys} do not match the "
                f"{self.plant!r} device plant's layout {PLANT_PARAM_KEYS[self.plant]}"
            )
        if self.integrator not in ("rk4", "euler"):
            raise ValueError(f"unknown integrator {self.integrator!r} (rk4 | euler)")

    def check_launch_shape(self, name: str, S: int, U: int, K: int, H: int,
                           N: int) -> None:
        """Raise unless the operands fit the device plant and are non-empty."""
        if (S, U) != PLANT_DIMS[self.plant] or N != len(self.param_keys) or K < 1 or H < 1:
            raise ValueError(
                f"{name}: S={S} U={U} N={N} K={K} H={H} do not fit the "
                f"{self.plant!r} plant (S, U) = {PLANT_DIMS[self.plant]}, "
                f"N = {len(self.param_keys)}"
            )

    def unpack(self, pvec: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: pvec[i] for i, k in enumerate(self.param_keys)}

    @property
    def fast_math(self) -> bool:
        """Fast normals in the fully-fused kernels and their regenerations:
        a fast plant (polynomial trig too), or ``fast_sampling``."""
        return self.plant in FAST_PLANTS.values() or self.fast_sampling

    def step_args(self) -> tuple:
        """(rk4, substeps, sub_dt, half_dt, dt6) for the C entry points:
        float constants computed in double; ctypes rounds them to float."""
        sub_dt = self.dt / self.intermediate_steps
        return (
            int(self.integrator == "rk4"), int(self.intermediate_steps),
            sub_dt, 0.5 * sub_dt, sub_dt / 6.0,
        )


class NetArgs(ctypes.Structure):
    """``csrc/neural_core.cuh`` NetArgs: a net's form and the device
    pointers of its tensors as they are stored (no copy, no transpose)."""

    _fields_ = [
        ("kind", ctypes.c_int), ("n_layers", ctypes.c_int), ("predict_delta", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("w", ctypes.c_void_p * MAX_LAYERS), ("b", ctypes.c_void_p * MAX_LAYERS),
        ("wh", ctypes.c_void_p * MAX_LAYERS), ("bh", ctypes.c_void_p * MAX_LAYERS),
        ("hidden", ctypes.c_void_p * MAX_LAYERS),
        ("wo", ctypes.c_void_p), ("bo", ctypes.c_void_p),
        ("norm_in_mean", ctypes.c_void_p), ("norm_in_std", ctypes.c_void_p),
        ("norm_out_mean", ctypes.c_void_p), ("norm_out_std", ctypes.c_void_p),
    ]


class ValueArgs(ctypes.Structure):
    """``csrc/value_mlp.cuh`` ValueArgs: a learned terminal value's
    tanh MLP, its widths and the device pointers of its layers as stored
    (``w_i [in, out]``, ``b_i [out]``)."""

    _fields_ = [
        ("n_layers", ctypes.c_int), ("dims", ctypes.c_int * (VALUE_MAX_LAYERS + 1)),
        ("w", ctypes.c_void_p * VALUE_MAX_LAYERS), ("b", ctypes.c_void_p * VALUE_MAX_LAYERS),
    ]


def value_args(ops, S: int) -> ValueArgs:
    """``ValueArgs`` of the value net ``ops = [w0, b0, ..., w_{L-1},
    b_{L-1}]`` (``Optimizer._flatten_value_ops``); raises unless it maps S
    states to one number through 1..VALUE_MAX_LAYERS layers of matching
    widths."""
    n = len(ops) // 2
    if len(ops) % 2 or not 1 <= n <= VALUE_MAX_LAYERS:
        raise ValueError(f"a value net of {len(ops)} operands (1..{VALUE_MAX_LAYERS} layers "
                         "of w, b)")
    dims = [S] + [int(ops[2 * i].shape[-1]) for i in range(n)]
    if dims[-1] != 1:
        raise ValueError(f"the value net's output width is {dims[-1]}, not 1")
    args = ValueArgs()
    args.n_layers = n
    for i in range(n):
        w = _expect(f"value w{i}", ops[2 * i], (dims[i], dims[i + 1]))
        b = _expect(f"value b{i}", ops[2 * i + 1], (dims[i + 1],))
        args.w[i], args.b[i] = w.data_ptr(), b.data_ptr()
    for i, d in enumerate(dims):
        args.dims[i] = d
    return args


def value_tensors(ops) -> Dict[str, torch.Tensor]:
    """The value net's operands by name, for ``check_cuda_operands``."""
    return {f"value_op{i}": t for i, t in enumerate(ops)}


def _expect(name: str, t: torch.Tensor, shape: tuple) -> torch.Tensor:
    if tuple(t.shape) != shape:
        raise ValueError(f"net tensor {name}: shape {tuple(t.shape)}, expected {shape}")
    return t


def _net_putter(args: NetArgs, tensors: Dict[str, torch.Tensor]) -> Callable:
    """``put(field, i, name, t, shape)``: check ``t``'s shape, keep it under
    ``name`` and write its device pointer to ``args.field[i]`` (or
    ``args.field`` for ``i`` None)."""
    def put(field, i, name, t, shape):
        tensors[name] = _expect(name, t, shape)
        if i is None:
            setattr(args, field, t.data_ptr())
        else:
            getattr(args, field)[i] = t.data_ptr()

    return put


def mlp_net_args(net: Dict, S: int, U: int, predict_delta: bool,
                 members: int = 0) -> Tuple[NetArgs, Dict[str, torch.Tensor]]:
    """``(NetArgs, tensors by name)`` of an MLP ``[S+U] -> ... -> [S]`` (the
    layers ``w{i}`` [in, out], ``b{i}`` and optional ``norm_*``), or of a
    stacked ensemble of ``members`` such MLPs (every tensor with a leading
    member axis; the pointers are member 0's, member m's leaf lies m times
    the leaf's size further, which the kernels compute from ``dims``);
    raises unless each tensor has the shape its place in the net gives it."""
    args, tensors = NetArgs(), {}
    args.kind, args.predict_delta = NET_KINDS["mlp"], int(predict_delta)
    put_one = _net_putter(args, tensors)
    lead = (members,) if members else ()

    def put(field, i, name, t, shape):
        put_one(field, i, name, t, lead + shape)

    n = sum(1 for k in net if k.startswith("w"))
    if not 1 <= n <= MAX_LAYERS:
        raise ValueError(f"an MLP of {n} layers (1..{MAX_LAYERS} in the kernels)")
    dims = [S + U] + [int(net[f"w{i}"].shape[-1]) for i in range(n)]
    if dims[-1] != S:
        raise ValueError(f"the MLP's output width {dims[-1]} is not the state's {S}")
    for i in range(n):
        put("w", i, f"w{i}", net[f"w{i}"], (dims[i], dims[i + 1]))
        put("b", i, f"b{i}", net[f"b{i}"], (dims[i + 1],))
    for side, width in (("in", S + U), ("out", S)):
        if f"norm_{side}_mean" in net:
            for stat in ("mean", "std"):
                key = f"norm_{side}_{stat}"
                put(key, None, key, net[key], (width,))
    args.n_layers = n
    for i, d in enumerate(dims):
        args.dims[i] = d
    return args, tensors


def neural_plan(plant: str, args: NetArgs, warps: int = 0) -> Tuple[int, int, int]:
    """K11's layout (csrc/mlp_units.cuh) for the MLP of ``args`` with
    ``warps`` warps a 16-rollout group (0: the plan's own): ``(dynamic shared
    memory of a block in bytes, warps a group, groups a block)``, the bytes
    -1 where the kernel refuses the net."""
    S, U = PLANT_DIMS[plant]
    group_warps, groups = ctypes.c_int(), ctypes.c_int()
    nbytes = load().ctt_neural_plan(ctypes.byref(args), S, U, warps, ctypes.byref(group_warps),
                                    ctypes.byref(groups))
    return int(nbytes), group_warps.value, groups.value


def residual_plan(plant: str, args: NetArgs) -> Tuple[int, int]:
    """K12's layout (csrc/residual_rollout.cu) for the residual MLP of
    ``args``, at two warps a 16-rollout group (the MLP's and the base
    step's): ``(dynamic shared memory of a block in bytes, groups a
    block)``, the bytes -1 where the kernel refuses the net."""
    if plant not in PLANT_IDS:
        raise ValueError(f"no device plant {plant!r}; known: {sorted(PLANT_IDS)}")
    groups = ctypes.c_int()
    nbytes = load().ctt_residual_plan(PLANT_IDS[plant], ctypes.byref(args), ctypes.byref(groups))
    return int(nbytes), groups.value


def net_smem_bytes(plant: str, args: NetArgs, kernel: str) -> int:
    """Dynamic shared memory a block of the network kernel ``kernel`` takes
    for the net of ``args``, or -1 where the kernel refuses the net (its
    launch then returns cudaErrorInvalidValue): K11's (``neural``) staged
    hi/lo fragments and per-group slabs (csrc/mlp_units.cuh), K12's
    (``residual``) the same at one MLP warp a group with its exchange slots
    (csrc/residual_rollout.cu), K13's (``recurrent``) staged hi/lo gate
    fragments and per-group slabs (csrc/rnn_mma.cuh), or the gradient
    kernels' (``neural_grad``, ``residual_grad``) staged hi/lo fragments and
    per-warp regions (csrc/mlp_mma.cuh).  The member-block forms of K11 and
    K8 stage one member a block: their blocks take K11's and K8's bytes."""
    S, U = PLANT_DIMS[plant]
    if kernel in ("neural", "recurrent", "neural_ens"):
        return int(load().ctt_net_smem_bytes(ctypes.byref(args), S, U))
    if kernel == "residual":
        return residual_plan(plant, args)[0]
    if kernel in ("neural_grad", "residual_grad", "neural_grad_ens"):
        return int(load().ctt_mma_net_smem_bytes(PLANT_IDS[plant], ctypes.byref(args)))
    raise ValueError(f"no network kernel {kernel!r}")


# The network kernels whose blocks-per-SM entry takes the cost's plant id.
PLANT_OCCUPANCY = ("neural", "neural_ens", "recurrent", "neural_grad", "neural_grad_ens")


def net_blocks_per_sm(kernel: str, args: NetArgs, plant: str = "cartpole") -> int:
    """Blocks of the tensor-core network kernel ``kernel`` (``neural`` for
    K11, ``residual`` for K12, ``neural_grad`` for K8, ``residual_grad`` for
    K9, ``recurrent`` for K13, ``neural_ens`` and ``neural_grad_ens`` for
    K11's and K8's member-block forms) that one SM holds for the net of
    ``args`` (one member's, for the forms), as
    the CUDA runtime's occupancy calculator gives it (0 for a refused
    net); K11's, K8's, their member-block forms' and K13's over the cost
    of ``plant`` (PLANT_OCCUPANCY), the others' over cartpole's."""
    entry = getattr(load(), f"ctt_{kernel}_blocks_per_sm")
    if kernel in PLANT_OCCUPANCY:
        return int(entry(PLANT_IDS[plant], ctypes.byref(args)))
    if plant != "cartpole":
        raise ValueError(f"net_blocks_per_sm: {kernel}'s entry takes cartpole's instance alone")
    return int(entry(ctypes.byref(args)))


@dataclass(frozen=True)
class ResidualModel(RolloutModel):
    """What the residual kernels K12 and K9 integrate and score: K1's
    device plant, packed layout (the base's constants, then the cost's) and
    step constants, plus the residual MLP, which is passed per call as a
    ``NetArgs`` in absolute form without norms."""

    def net_args(self, net: Dict) -> Tuple[NetArgs, Dict[str, torch.Tensor]]:
        if any(k.startswith("norm_") for k in net):
            raise ValueError("the residual MLP has no norm layers")
        S, U = PLANT_DIMS[self.plant]
        return mlp_net_args(net, S, U, predict_delta=False)


@dataclass(frozen=True)
class CostModel:
    """The cost half of a kernel whose dynamics are tensors passed per call
    (a learned net's weights, a GP's posterior): the device plant whose
    cost it evaluates, packed as ``COST_PARAM_KEYS`` (no dynamics
    constants), and the component-form cost callables that the plain
    versions run."""

    plant: str
    param_keys: Tuple[str, ...]
    stage: Callable       # (xs, us, prev_us, p) -> [K]; with ccrc and -MAX_COST
    terminal: Callable    # (xs, p) -> [K]
    max_cost: float

    def __post_init__(self):
        if self.plant not in PLANT_IDS:
            raise ValueError(f"no device plant {self.plant!r}; known: {sorted(PLANT_IDS)}")
        if self.param_keys != COST_PARAM_KEYS[self.plant]:
            raise ValueError(
                f"packed parameters {self.param_keys} do not match the {self.plant!r} "
                f"device cost's layout {COST_PARAM_KEYS[self.plant]}"
            )

    def unpack(self, pvec: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: pvec[i] for i, k in enumerate(self.param_keys)}

    def check_launch_shape(self, name: str, S: int, U: int, K: int, H: int, N: int) -> None:
        if (S, U) != PLANT_DIMS[self.plant] or N != len(self.param_keys) or K < 1 or H < 1:
            raise ValueError(
                f"{name}: S={S} U={U} N={N} K={K} H={H} do not fit the {self.plant!r} "
                f"device cost (S, U) = {PLANT_DIMS[self.plant]}, N = {len(self.param_keys)}"
            )


# The sparse-GP kernels' operands (ops/gp_rollout.py flatten_gp_weights), in
# csrc/gp_core.cuh GPArgs order.
GP_OPERANDS = ("Zs", "zn2", "alphaT", "in_mean", "inv_in", "out_mean", "out_std", "var")


class GPArgs(ctypes.Structure):
    """``csrc/gp_core.cuh`` GPArgs: the number of inducing points and the
    device pointers of the eight precomputed GP tensors."""

    _fields_ = [("M", ctypes.c_int)] + [(name, ctypes.c_void_p) for name in GP_OPERANDS]


def gp_layout(M: int, lanes: int = 0, grad: bool = True,
              plant: str = "cartpole") -> Tuple[int, int, int]:
    """K10's (``grad``) or K14's layout (csrc/gp_rollout.cu) over the cost of
    ``plant`` for M inducing points with ``lanes`` lanes a rollout (0: the
    kernel's own, the only count the costs other than cartpole's take):
    ``(lanes, threads a block, blocks an SM holds)``, zeros where the
    kernel refuses M or ``lanes``."""
    threads, blocks = ctypes.c_int(), ctypes.c_int()
    taken = load().ctt_gp_layout(PLANT_IDS[plant], int(grad), M, lanes, ctypes.byref(threads),
                                 ctypes.byref(blocks))
    return int(taken), threads.value, blocks.value


@dataclass(frozen=True)
class GPModel(CostModel):
    """What the sparse-GP kernels K14 and K10 step and score: the cost half
    (``CostModel``), with the GP's precomputed tensors passed per call as a
    ``GPArgs``."""

    def gp_args(self, ops: Dict[str, torch.Tensor]) -> Tuple[GPArgs, Dict[str, torch.Tensor]]:
        """``(GPArgs, tensors by name)``; raises unless each operand has
        its shape: Zs [M, S+U], zn2 [M], alphaT [S, M], in_mean and inv_in
        [S+U], out_mean and out_std [S], var [] (0-d)."""
        S, U = PLANT_DIMS[self.plant]
        M = int(ops["Zs"].shape[0])
        shapes = {"Zs": (M, S + U), "zn2": (M,), "alphaT": (S, M), "in_mean": (S + U,),
                  "inv_in": (S + U,), "out_mean": (S,), "out_std": (S,), "var": ()}
        args = GPArgs()
        args.M = M
        for name in GP_OPERANDS:
            setattr(args, name, _expect(name, ops[name], shapes[name]).data_ptr())
        return args, {name: ops[name] for name in GP_OPERANDS}


@dataclass(frozen=True)
class NetModel(CostModel):
    """What a network-rollout kernel steps and scores: the cost half
    (``CostModel``), the net's kind and form; the dynamics are the net's
    weight tensors, passed per call."""

    kind: str             # mlp | gru | lstm
    predict_delta: bool

    def __post_init__(self):
        super().__post_init__()
        if self.kind not in NET_KINDS:
            raise ValueError(f"unknown net kind {self.kind!r} ({' | '.join(NET_KINDS)})")

    def net_args(self, net: Dict, hidden=None, rows: int = 1,
                 members: int = 0) -> Tuple[NetArgs, Dict[str, torch.Tensor]]:
        """``(NetArgs, tensors by name)`` for ``net`` and, for a recurrent
        net, its ``hidden``: ``rows`` rows a cell (1, the live batch-1
        hidden; B, one a session for the session-row form); for an MLP
        ensemble (``members``) every tensor stacked on a leading member
        axis; raises unless each tensor has the shape its place in the net
        gives it."""
        S, U = PLANT_DIMS[self.plant]
        if self.kind == "mlp":
            return mlp_net_args(net, S, U, self.predict_delta, members)
        if members:
            raise ValueError(f"an ensemble of {self.kind} nets (MLP members only)")
        args, tensors = NetArgs(), {}
        args.kind, args.predict_delta = NET_KINDS[self.kind], int(self.predict_delta)
        put = _net_putter(args, tensors)
        gates = 3 if self.kind == "gru" else 4
        n = sum(1 for k in net if k.startswith("cell"))
        if not 1 <= n <= MAX_LAYERS or hidden is None or len(hidden) != n:
            raise ValueError(f"a {self.kind} of {n} cells needs 1..{MAX_LAYERS} cells "
                             "and one hidden per cell")
        dims = [S + U] + [int(net[f"cell{i}"]["wh"].shape[0]) for i in range(n)]
        for i in range(n):
            cell, hd = net[f"cell{i}"], dims[i + 1]
            put("w", i, f"cell{i}/wi", cell["wi"], (dims[i], gates * hd))
            put("b", i, f"cell{i}/bi", cell["bi"], (gates * hd,))
            put("wh", i, f"cell{i}/wh", cell["wh"], (hd, gates * hd))
            put("bh", i, f"cell{i}/bh", cell["bh"], (gates * hd,))
            state = hd if self.kind == "gru" else 2 * hd
            put("hidden", i, f"hidden{i}", hidden[i], (rows, state))
        put("wo", None, "wo", net["wo"], (dims[-1], S))
        put("bo", None, "bo", net["bo"], (S,))
        args.n_layers = n
        for i, d in enumerate(dims):
            args.dims[i] = d
        return args, tensors

    def smem_bytes(self, args: NetArgs, grad: bool) -> int:
        """A block's dynamic shared memory for the net of ``args``: K8's
        (``grad``), K11's or K13's."""
        kernel = "neural_grad" if grad else ("neural" if self.kind == "mlp" else "recurrent")
        return net_smem_bytes(self.plant, args, kernel)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libctt_kernels-{h.hexdigest()[:16]}.so"


def compile_sources(nvcc: str, jobs) -> Tuple[Dict[str, str], Dict[str, float],
                                               Dict[str, float]]:
    """Compile ``jobs``, (source, object) pairs in the order given (SOURCES':
    the heaviest first), one ``nvcc`` a source and at most one a CPU running
    at once, so that the longest compiles start first and none waits behind
    a crowd of short ones.  Returns each source's ptxas log, its seconds
    from the start, and the CPU seconds its nvcc and the compilers it ran
    took; raises on the first failure, after stopping the others."""
    slots = max(1, os.cpu_count() or 1)
    pending, running = list(jobs), {}
    logs, seconds, cpu = {}, {}, {}
    t0 = time.perf_counter()
    try:
        while pending or running:
            while pending and len(running) < slots:
                src, obj = pending.pop(0)
                err = tempfile.TemporaryFile("w+")
                proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC_DIR / src)],
                                        stdout=subprocess.DEVNULL, stderr=err)
                running[proc.pid] = (src, proc, err)
            finished = False
            for pid in list(running):
                got, status, usage = os.wait4(pid, os.WNOHANG)
                if got == 0:
                    continue
                finished = True
                src, proc, err = running.pop(pid)
                proc.returncode = os.waitstatus_to_exitcode(status)
                seconds[src] = time.perf_counter() - t0
                cpu[src] = usage.ru_utime + usage.ru_stime
                err.seek(0)
                logs[src] = err.read()
                err.close()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src}:\n{logs[src]}")
            if not finished:
                time.sleep(0.02)
    finally:
        for _, proc, err in running.values():
            proc.kill()
            proc.wait()
            err.close()
    return logs, seconds, cpu


def build() -> Path:
    """Compile ``csrc/`` unless this source hash is built already; return
    the library's path.  Each source compiles in its own ``nvcc``, one a CPU
    at a time in SOURCES' order (``compile_sources``), and the objects are
    linked into one library.  ``build.count`` counts builds in this
    process; ``build.seconds`` (the link included), ``build.compile_seconds``,
    ``build.source_seconds`` and ``build.cpu_seconds`` (each source's from
    the start, and its nvcc's CPU seconds) and ``build.log`` (ptxas'
    register report) describe the last one."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    objs = [f"{tmp}.{Path(src).stem}.o" for src in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        logs, source_seconds, cpu_seconds = compile_sources(nvcc, zip(SOURCES, objs))
        compiled = time.perf_counter() - t0
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    os.replace(tmp, out)
    build.count += 1
    build.seconds = time.perf_counter() - t0
    build.compile_seconds = compiled
    build.source_seconds, build.cpu_seconds = source_seconds, cpu_seconds
    build.log = "".join(logs[src] for src in SOURCES)
    return out


build.count = 0
build.seconds = build.compile_seconds = None
build.source_seconds, build.cpu_seconds = {}, {}
build.log = ""


def load() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once."""
    if load.lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # Each rollout kernel takes K, then ks (the rollouts a session: K for
        # one session, a fleet's K for its session-row form), then H.
        # K1, K2 and K4 take the terminal states' pointer after the costs'
        # (None: the kernel, else its emit_terminal form).
        lib.ctt_cost_rollout.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, f32, f32, f32, ptr,
        ]
        lib.ctt_cost_rollout.restype = i32
        lib.ctt_mppi_cost.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
            i32, i32, f32, f32, f32, f32, f32, f32, f32, f32, ptr,
        ]
        lib.ctt_mppi_cost.restype = i32
        lib.ctt_mppi_cost_cols.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
            i32, i32, f32, f32, f32, f32, f32, f32, f32, f32, ptr,
        ]
        lib.ctt_mppi_cost_cols.restype = i32
        lib.ctt_grad_cost_forward.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, f32, f32, f32, ptr,
        ]
        lib.ctt_grad_cost_forward.restype = i32
        # The adjoint takes the value gradient's pointer after xhist (None:
        # the adjoint, else its value_spec form).
        lib.ctt_grad_cost_adjoint.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, f32, f32, f32, ptr,
        ]
        lib.ctt_grad_cost_adjoint.restype = i32
        # The value_spec forms take the value net's ValueArgs (K8, K9, K10:
        # None for the kernel); K7's forward value form takes ks as K7's.
        value = ctypes.POINTER(ValueArgs)
        lib.ctt_grad_cost_forward_value.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, f32, f32, f32, f32,
            value, ptr,
        ]
        lib.ctt_grad_cost_forward_value.restype = i32
        lib.ctt_value_smem_bytes.argtypes = [value, i32]
        lib.ctt_value_smem_bytes.restype = ctypes.c_long
        net = ctypes.POINTER(NetArgs)
        # K11, K13, K12 and K14 (and K11's member-block form) take the
        # terminal states' pointer after the costs' too.
        lib.ctt_neural_cost_rollout.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32,
                                                i32, net, ptr]
        lib.ctt_neural_cost_rollout.restype = i32
        lib.ctt_recurrent_cost_rollout.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                                   f32, net, ptr]
        lib.ctt_recurrent_cost_rollout.restype = i32
        lib.ctt_neural_plan.argtypes = [net, i32, i32, i32, ctypes.POINTER(i32),
                                        ctypes.POINTER(i32)]
        lib.ctt_neural_plan.restype = ctypes.c_long
        # The member-block forms take ks = K / E, the rollouts a member.
        lib.ctt_neural_cost_rollout_ens.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                                    f32, net, ptr]
        lib.ctt_neural_cost_rollout_ens.restype = i32
        for fn in (lib.ctt_neural_grad_cost_rollout, lib.ctt_neural_grad_cost_rollout_ens):
            fn.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, f32, net, value,
                           ptr]
            fn.restype = i32
        long_p = ctypes.POINTER(ctypes.c_long)
        lib.ctt_neural_grad_value_layout.argtypes = [i32, net, value, i32, long_p]
        lib.ctt_neural_grad_value_layout.restype = i32
        lib.ctt_net_smem_bytes.argtypes = [net, i32, i32]
        lib.ctt_net_smem_bytes.restype = ctypes.c_long
        lib.ctt_mma_net_smem_bytes.argtypes = [i32, net]
        lib.ctt_mma_net_smem_bytes.restype = ctypes.c_long
        for fn in (lib.ctt_residual_blocks_per_sm, lib.ctt_residual_grad_blocks_per_sm):
            fn.argtypes = [net]
            fn.restype = i32
        # K11's, K8's, their member-block forms' and K13's over the cost of a
        # plant id.
        for fn in (lib.ctt_neural_blocks_per_sm, lib.ctt_neural_ens_blocks_per_sm,
                   lib.ctt_recurrent_blocks_per_sm, lib.ctt_neural_grad_blocks_per_sm,
                   lib.ctt_neural_grad_ens_blocks_per_sm):
            fn.argtypes = [i32, net]
            fn.restype = i32
        # rows: 0 for the single-session kernel, 1 for its session-row form.
        for fn in (lib.ctt_cost_rollout_blocks_per_sm, lib.ctt_grad_cost_forward_blocks_per_sm,
                   lib.ctt_grad_cost_adjoint_blocks_per_sm):
            fn.argtypes = [i32]
            fn.restype = i32
        # Blocks per SM of a plant's instance (plant id) of K1, K2, K3's pass 1
        # (and its fast flag) and K7 (0: the forward, 1: the adjoint);
        # K4's, K1's session-row form's, K5's and K6's (and their fast flag)
        # and K7's session-row forms' likewise.
        for fn in (lib.ctt_cost_rollout_plant_blocks_per_sm,
                   lib.ctt_mppi_cost_plant_blocks_per_sm,
                   lib.ctt_mppi_cost_cols_plant_blocks_per_sm,
                   lib.ctt_cost_rollout_rows_plant_blocks_per_sm):
            fn.argtypes = [i32]
            fn.restype = i32
        # The emit_terminal forms of K2 and K4 likewise, K1's (rows 0) and its
        # session-row form's (rows 1); K7's value_spec forward (0) or adjoint
        # (1), one session's (rows 0) or the session-row form's, under V.
        for fn in (lib.ctt_mppi_cost_emit_plant_blocks_per_sm,
                   lib.ctt_mppi_cost_cols_emit_plant_blocks_per_sm):
            fn.argtypes = [i32]
            fn.restype = i32
        lib.ctt_grad_value_plant_blocks_per_sm.argtypes = [i32, i32, i32,
                                                           ctypes.POINTER(ValueArgs)]
        lib.ctt_grad_value_plant_blocks_per_sm.restype = i32
        for fn in (lib.ctt_fused_mppi_cost_plant_blocks_per_sm,
                   lib.ctt_cost_rollout_emit_plant_blocks_per_sm,
                   lib.ctt_grad_cost_plant_blocks_per_sm,
                   lib.ctt_fused_cem_plant_blocks_per_sm,
                   lib.ctt_fused_cem_cols_plant_blocks_per_sm,
                   lib.ctt_grad_cost_rows_plant_blocks_per_sm):
            fn.argtypes = [i32, i32]
            fn.restype = i32
        step = [i32, i32, f32, f32, f32]  # rk4, substeps, sub_dt, half_dt, dt6
        lib.ctt_residual_cost_rollout.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, *step, f32, net, ptr,
        ]
        lib.ctt_residual_cost_rollout.restype = i32
        lib.ctt_residual_plan.argtypes = [i32, net, ctypes.POINTER(i32)]
        lib.ctt_residual_plan.restype = ctypes.c_long
        lib.ctt_residual_grad_cost_rollout.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, *step, f32, f32, net, value, ptr,
        ]
        lib.ctt_residual_grad_cost_rollout.restype = i32
        lib.ctt_residual_grad_value_layout.argtypes = [net, value, long_p]
        lib.ctt_residual_grad_value_layout.restype = i32
        # A base plant's (plant id) K12 (0) or emit_terminal form (1); its K9
        # (no value net) or value_spec form: the blocks per SM, the bytes.
        lib.ctt_residual_plant_blocks_per_sm.argtypes = [i32, i32, net]
        lib.ctt_residual_plant_blocks_per_sm.restype = i32
        lib.ctt_residual_grad_plant_layout.argtypes = [i32, net, value, long_p]
        lib.ctt_residual_grad_plant_layout.restype = i32
        gp = ctypes.POINTER(GPArgs)
        lib.ctt_gp_cost_rollout.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32,
                                            i32, gp, ptr]
        lib.ctt_gp_cost_rollout.restype = i32
        lib.ctt_gp_grad_cost_rollout.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, f32, i32, gp, value, ptr,
        ]
        lib.ctt_gp_grad_cost_rollout.restype = i32
        # The GP layouts take the cost's plant id first.
        lib.ctt_gp_grad_value_layout.argtypes = [i32, i32, value, long_p]
        lib.ctt_gp_grad_value_layout.restype = i32
        lib.ctt_gp_layout.argtypes = [i32, i32, i32, i32, ctypes.POINTER(i32),
                                      ctypes.POINTER(i32)]
        lib.ctt_gp_layout.restype = i32
        lib.ctt_gp_smem_bytes.argtypes = [i32, i32, i32]
        lib.ctt_gp_smem_bytes.restype = ctypes.c_long
        # ..., max_cost, fast (the fast normals), stream
        lib.ctt_fused_cem.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                      *step, f32, i32, ptr]
        lib.ctt_fused_cem.restype = i32
        lib.ctt_fused_cem_cols.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                           i32, *step, f32, i32, ptr]
        lib.ctt_fused_cem_cols.restype = i32
        # ..., stdev, fast (the fast normals), stream
        lib.ctt_fused_mppi_cost.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, *step,
            f32, f32, f32, f32, f32, f32, i32, ptr,
        ]
        lib.ctt_fused_mppi_cost.restype = i32
        # ..., inv_lbd, fast (the fast normals), stream
        lib.ctt_fused_mppi_weights.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, i32,
                                               ptr]
        lib.ctt_fused_mppi_weights.restype = i32
        load.lib = lib
    return load.lib


load.lib = None


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} (1, invalid value: an "
                           "unknown plant, or a net (a dynamics or value net) whose widths or "
                           "shared memory the kernel refuses, or a GP whose inducing points "
                           "exceed a block's shared memory)")


def check_cuda_operands(name: str, **tensors: torch.Tensor) -> torch.device:
    """All operands float32, contiguous and on one CUDA device (which is
    returned); raises otherwise — a kernel never takes a mixed or CPU
    operand, and nothing falls back."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {sorted(map(str, devices))}")
    (device,) = devices
    if device.type != "cuda":
        raise ValueError(f"{name}: kernel operands must be CUDA tensors, got {device}")
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return device


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU: the only case in which a
    wrapper runs its plain version."""
    return all(t.device.type == "cpu" for t in tensors)


def check_cols_shapes(name: str, s0: torch.Tensor, Q: torch.Tensor,
                      pvec_b: torch.Tensor) -> int:
    """The session-row forms' launch shapes: raise unless ``s0 [B*K,S]``,
    ``Q [B*K,H,U]`` and ``pvec_b [B,N]`` fit together; returns K, the
    rollouts a session (the C entries' ``ks``)."""
    if (s0.ndim != 2 or Q.ndim != 3 or Q.shape[0] != s0.shape[0] or pvec_b.ndim != 2
            or pvec_b.shape[0] < 1 or s0.shape[0] % pvec_b.shape[0] or s0.shape[0] == 0):
        raise ValueError(
            f"{name}: expected s0 [B*K,S], Q [B*K,H,U], pvec_b [B,N]; got "
            f"{tuple(s0.shape)}, {tuple(Q.shape)}, {tuple(pvec_b.shape)}"
        )
    return s0.shape[0] // pvec_b.shape[0]


def session_rows(rows: torch.Tensor, K: int) -> torch.Tensor:
    """Per-session rows ``[B, n]`` as per-rollout rows ``[B*K, n]``."""
    return rows.repeat_interleave(K, dim=0)
