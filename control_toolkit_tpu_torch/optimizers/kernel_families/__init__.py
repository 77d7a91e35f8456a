"""Per-model-family kernel providers (counterpart of
control_toolkit_tpu/optimizers/kernel_families/): each family has
``can_use_cost``/``build_cost`` and ``can_use_grad``/``build_grad``, and
the optimizer takes the first family in these orders, the JAX package's,
whose gate admits its model."""
from control_toolkit_tpu_torch.optimizers.kernel_families import (
    ensemble, gp, neural, ode, residual,
)

COST_ORDER = (ode, neural, ensemble, gp, residual)
GRAD_ORDER = (ode, neural, ensemble, gp, residual)
