"""control_toolkit_tpu_torch — the PyTorch/CUDA port of control_toolkit_tpu.

The JAX package ``control_toolkit_tpu`` is the reference; this package is
its counterpart module for module (``controllers/``, ``costs/``,
``environments/``, ``models/``, ``ops/``, ``optimizers/``, ``utils/``)
with the same registry names, config contract and controller API.  Plain
tensor code is PyTorch; every Pallas kernel on the ported path is a CUDA
kernel for Hopper (``csrc/``), built with nvcc at first use and bound
with ctypes (``ops/kernels.py``).

The package imports torch and never jax.  It reads the JAX package's
YAML files (and reuses its jax-free cost-config watcher) only inside the
functions that read a file, so a caller that passes every config
explicitly imports nothing of the JAX package.
"""
__version__ = "0.1.0"

from control_toolkit_tpu_torch.utils.registry import (
    import_controller_by_name as import_controller_by_name,
    import_optimizer_by_name as import_optimizer_by_name,
)
