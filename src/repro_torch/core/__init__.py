"""The paper's model in PyTorch: kernel registry, losses, model state, the
steps of Algorithms 1 and 2 with their EigenPro correction, the serial,
parallel and hosted fits and prediction."""
from repro_torch.core.dsekl import (  # noqa: F401
    DSEKLConfig, DSEKLState, PrecondBlock, apply_update,
    apply_update_parallel, decision_function, decision_function_ref,
    decision_function_source, epoch_parallel, grad_block,
    grad_block_parallel, init_state, precond_correction, predict_labels,
    step_serial, support_vectors, truncate,
)
from repro_torch.core.kernels_fn import KERNELS, get_kernel  # noqa: F401
from repro_torch.core.losses import LOSSES, get_loss  # noqa: F401
from repro_torch.core.precond import (  # noqa: F401
    EigenProPreconditioner, estimate_preconditioner,
)
from repro_torch.core.solver import (  # noqa: F401
    error_rate, fit, train_epoch_hosted,
)
from repro_torch.core.trainer import (  # noqa: F401
    ExecutionPlan, FitResult, HostedPlan, ParallelPlan, SerialPlan, fit_loop,
    make_plan, resolve_execution,
)
