from repro_torch.serving.dsekl_engine import (  # noqa: F401
    DSEKLPredictionEngine, EngineConfig, engine_from_fit)
from repro_torch.serving.engine import ServingEngine  # noqa: F401
from repro_torch.serving.online import (  # noqa: F401
    OnlineResponse, OnlineService)
from repro_torch.serving.tenancy import (  # noqa: F401
    QoSConfig, ShedResponse, TenantConfig, TenantFrontDoor, TenantResponse)
