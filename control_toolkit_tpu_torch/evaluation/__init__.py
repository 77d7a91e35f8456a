from control_toolkit_tpu_torch.evaluation.closed_loop import ClosedLoop
from control_toolkit_tpu_torch.evaluation.tuning import grid_search

__all__ = ["ClosedLoop", "grid_search"]
