"""PyTorch/CUDA port of the DSEKL system (the JAX package ``repro`` is the
reference it is held against; nothing here imports it).

Layout mirrors ``repro``: ``core`` (kernel registry, model state,
prediction), ``kernels/dsekl`` (the kernel ops with their hand-written
Hopper kernel and plain-torch versions), ``serving`` (the prediction
engine), ``data``, ``launch`` and ``convert`` (weights carried across from
the JAX package's states and checkpoints).
"""
