from repro_torch.serving.dsekl_engine import (  # noqa: F401
    DSEKLPredictionEngine, EngineConfig, engine_from_fit)
