"""control_toolkit_tpu_torch — the PyTorch/CUDA port of control_toolkit_tpu.

The JAX package ``control_toolkit_tpu`` is the reference; this package is
its counterpart module for module (``controllers/``, ``costs/``,
``environments/``, ``models/``, ``ops/``, ``optimizers/``, ``utils/``)
with the same registry names, config contract and controller API.  Plain
tensor code is PyTorch; every Pallas kernel on the ported path is a CUDA
kernel for Hopper (``csrc/``), built with nvcc at first use and bound
with ctypes (``ops/kernels.py``).

The package imports torch and never jax, and nothing of the JAX package:
its YAML config loader, packaged default configs and cost-config watcher
are its own copies (``utils/config.py``, ``config_defaults/``,
``costs/updater.py``).
"""
__version__ = "0.1.0"

from control_toolkit_tpu_torch.utils.registry import (
    import_controller_by_name as import_controller_by_name,
    import_optimizer_by_name as import_optimizer_by_name,
)
