from repro_torch.kernels.dsekl.block import (  # noqa: F401
    kernel_matvec_cuda, kernel_matvec_plain,
)
from repro_torch.kernels.dsekl.ops import (  # noqa: F401
    kernel_block, kernel_matvec, kernel_matvec_tiled, resolve_impl,
)
