"""Power-law (colored) Gaussian noise (counterpart of
control_toolkit_tpu/ops/colored_noise.py), the sampling distribution of
the iCEM planner (Pinneri et al., CoRL 2020).

Timmer & Koenig 1995 frequency-domain synthesis: independent Gaussian
spectral coefficients scaled by ``f^(-beta/2)`` (the DC bin clamped to the
lowest resolvable frequency), the DC and (even n) Nyquist bins made real
with a sqrt(2) magnitude, an inverse rFFT (``torch.fft.irfft``), and a
division by the analytic output sigma so every element has unit variance.

The draw and the shaping are two functions, so tests can feed the JAX
package's white noise: ``powerlaw_white`` draws ``[2, *shape, F]`` (the
real and imaginary coefficients, ``F = n//2 + 1``), or ``[*shape, n]``
white noise for ``n < 2``, and ``powerlaw_shape`` turns it into
``[*shape, n]``.
"""
from __future__ import annotations

import math

import torch


def powerlaw_white(generator: torch.Generator, n: int, shape: tuple = (),
                   device=None) -> torch.Tensor:
    """The white normals ``powerlaw_shape`` consumes."""
    size = (*shape, n) if n < 2 else (2, *shape, n // 2 + 1)
    return torch.randn(size, generator=generator, dtype=torch.float32, device=device)


def powerlaw_shape(white: torch.Tensor, exponent: float, n: int) -> torch.Tensor:
    """``(1/f)^exponent`` noise ``[*shape, n]``, zero-mean and unit-variance
    per element in expectation, from ``powerlaw_white``'s draw."""
    n = int(n)
    if n < 2:
        return white  # a degenerate horizon: plain white noise
    f = torch.fft.rfftfreq(n, device=white.device).to(torch.float32)   # [F], f[0] = 0
    fmin = 1.0 / n
    s_scale = torch.where(f < fmin, torch.full_like(f, fmin), f) ** (-float(exponent) / 2.0)
    # Each paired bin contributes 4*s^2 to n^2*Var, the real-only DC and
    # (even n) Nyquist bins 2*s^2 after their sqrt(2) fix.
    coef = torch.full_like(f, 4.0)
    coef[0] = 2.0
    if n % 2 == 0:
        coef[-1] = 2.0
    sigma = torch.sqrt(torch.sum(coef * s_scale**2)) / n
    sr, si = white[0] * s_scale, white[1] * s_scale
    si[..., 0] = 0.0
    sr[..., 0] = sr[..., 0] * math.sqrt(2.0)
    if n % 2 == 0:
        si[..., -1] = 0.0
        sr[..., -1] = sr[..., -1] * math.sqrt(2.0)
    y = torch.fft.irfft(torch.complex(sr, si), n=n, dim=-1).to(torch.float32)
    return y / sigma


def powerlaw_psd_gaussian(generator: torch.Generator, exponent: float, n: int,
                          shape: tuple = (), device=None) -> torch.Tensor:
    """Gaussian ``(1/f)^exponent`` noise of length ``n`` on the last axis."""
    return powerlaw_shape(powerlaw_white(generator, n, shape, device), exponent, n)
