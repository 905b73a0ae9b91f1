"""The paper's model in PyTorch: kernel registry, losses, model state,
Algorithm 1's step, the serial fit and prediction."""
from repro_torch.core.dsekl import (  # noqa: F401
    DSEKLConfig, DSEKLState, apply_update, decision_function,
    decision_function_ref, grad_block, init_state, predict_labels,
    step_serial, support_vectors, truncate,
)
from repro_torch.core.kernels_fn import KERNELS, get_kernel  # noqa: F401
from repro_torch.core.losses import LOSSES, get_loss  # noqa: F401
from repro_torch.core.solver import error_rate, fit  # noqa: F401
from repro_torch.core.trainer import FitResult  # noqa: F401
