"""LM training: the step and the fault-tolerant loop (port of
``repro/train``)."""
from repro_torch.train.step import (  # noqa: F401
    make_train_step, param_shards, trainable,
)
from repro_torch.train.loop import (  # noqa: F401
    SimulatedFailure, TrainLoopConfig, run_with_restarts, train_loop,
)
