from simplellminference_tpu_torch.core.config import (  # noqa: F401
    EngineConfig,
    KVCacheConfig,
    ModelConfig,
    QuantConfig,
)
