"""Kernel ops of the port: each TPU kernel of ``repro.kernels`` becomes a
hand-written Hopper kernel (sources under ``<op>/csrc/``, built by
``_build.py``) beside a plain-torch version of the same function."""
from repro_torch.kernels.dsekl.block import (  # noqa: F401
    dual_pass_cuda, dual_pass_plain, kernel_matvec_cuda, kernel_matvec_plain,
    kernel_vecmat_cuda, kernel_vecmat_plain, train_pass_cuda,
    train_pass_plain,
)
from repro_torch.kernels.dsekl.ops import (  # noqa: F401
    kernel_block, kernel_dual_pass, kernel_matvec, kernel_matvec_tiled,
    kernel_vecmat, resolve_impl,
)
