"""The paper's model in PyTorch: kernel registry, state and prediction."""
from repro_torch.core.dsekl import (  # noqa: F401
    DSEKLConfig, DSEKLState, decision_function, decision_function_ref,
    init_state, predict_labels, support_vectors, truncate,
)
from repro_torch.core.kernels_fn import KERNELS, get_kernel  # noqa: F401
