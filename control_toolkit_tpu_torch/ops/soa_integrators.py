"""Struct-of-arrays ODE steppers (twin of control_toolkit_tpu/ops/soa_integrators.py).

The plain versions of the rollout kernels step with this; the CUDA core
(``csrc/rollout_core.cuh``) copies its operation order: rk4's
``(k1 + 2*k2) + (2*k3 + k4)`` grouping and ``tscale`` as ``c * x`` with
the Python-float step constants.  The JAX euler stepper's ``x + 0*u``
anchor is a Mosaic layout workaround and is bitwise a no-op, so it is
not carried over.
"""
from __future__ import annotations

from typing import Callable


def tadd(a, b):
    return tuple(x + y for x, y in zip(a, b))


def tscale(a, c):
    return tuple(c * x for x in a)


def make_soa_stepper(
    derivs_soa: Callable,
    integrator: str,
    dt: float,
    intermediate_steps: int = 1,
) -> Callable:
    """Return ``one_step(xs, us, p) -> xs`` advancing the component-tuple
    state by ``dt`` (``intermediate_steps`` sub-steps of euler/rk4)."""
    sub_dt = dt / intermediate_steps

    def euler(xs, us, p):
        return tadd(xs, tscale(derivs_soa(xs, us, p), sub_dt))

    def rk4(xs, us, p):
        k1 = derivs_soa(xs, us, p)
        k2 = derivs_soa(tadd(xs, tscale(k1, 0.5 * sub_dt)), us, p)
        k3 = derivs_soa(tadd(xs, tscale(k2, 0.5 * sub_dt)), us, p)
        k4 = derivs_soa(tadd(xs, tscale(k3, sub_dt)), us, p)
        incr = tadd(tadd(k1, tscale(k2, 2.0)), tadd(tscale(k3, 2.0), k4))
        return tadd(xs, tscale(incr, sub_dt / 6.0))

    if integrator == "rk4":
        base = rk4
    elif integrator == "euler":
        base = euler
    else:
        raise ValueError(f"unknown SOA integrator {integrator!r} (rk4 | euler)")

    def one_step(xs, us, p):
        for _ in range(intermediate_steps):
            xs = base(xs, us, p)
        return xs

    return one_step
