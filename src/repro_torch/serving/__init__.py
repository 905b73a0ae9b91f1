from repro_torch.serving.dsekl_engine import (  # noqa: F401
    DSEKLPredictionEngine, EngineConfig, engine_from_fit)
from repro_torch.serving.engine import ServingEngine  # noqa: F401
