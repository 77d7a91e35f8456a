"""Per-model-family kernel providers (counterpart of
control_toolkit_tpu/optimizers/kernel_families/): each family has
``can_use_cost``/``build_cost`` and ``can_use_grad``/``build_grad``, and
the optimizer takes the first family in these orders whose gate admits
its model.  The JAX orders without the ensemble family, which is not
ported yet."""
from control_toolkit_tpu_torch.optimizers.kernel_families import gp, neural, ode, residual

COST_ORDER = (ode, neural, gp, residual)
GRAD_ORDER = (ode, neural, gp, residual)
