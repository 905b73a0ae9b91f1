"""The paper's model in PyTorch: kernel registry, losses, model state, the
steps of Algorithms 1 and 2 with their EigenPro correction, the serial,
parallel, hosted and BCD fits and prediction; the paper's baselines (RKS,
EmpFix, the batch SVM) and kernel PCA live in ``core.baselines`` and
``core.kpca`` (modules, since kpca's ``init_state`` / ``step`` / ``fit``
would shadow the DSEKL names)."""
from repro_torch.core import baselines, bcd, kpca  # noqa: F401
from repro_torch.core.dsekl import (  # noqa: F401
    DSEKLConfig, DSEKLState, PrecondBlock, apply_update,
    apply_update_parallel, decision_function, decision_function_ref,
    decision_function_source, epoch_parallel, grad_block,
    grad_block_parallel, init_state, precond_correction, predict_labels,
    step_serial, support_vectors, truncate,
)
from repro_torch.core.baselines import (  # noqa: F401
    EmpFixModel, RKSModel, batch_svm_decision, batch_svm_fit,
    emp_fix_decision, emp_fix_init, emp_fix_step, rks_decision,
    rks_features, rks_init, rks_step,
)
from repro_torch.core.kernels_fn import KERNELS, get_kernel  # noqa: F401
from repro_torch.core.losses import LOSSES, get_loss  # noqa: F401
from repro_torch.core.kpca import KPCAConfig, KPCAState  # noqa: F401
from repro_torch.core.precond import (  # noqa: F401
    EigenProPreconditioner, estimate_preconditioner,
)
from repro_torch.core.solver import (  # noqa: F401
    error_rate, fit, train_epoch_hosted,
)
from repro_torch.core.trainer import (  # noqa: F401
    BCDPlan, ExecutionPlan, FitResult, HostedPlan, ParallelPlan, SerialPlan,
    fit_loop, make_plan, resolve_execution,
)
