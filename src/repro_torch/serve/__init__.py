"""Async serving front-end: DRR admission, streaming, graceful shedding
over the paged rollout engine."""
from repro_torch.serve.server import (
    AsyncLMServer,
    ServeConfig,
    ServerSaturated,
    TokenStream,
)

__all__ = ["AsyncLMServer", "ServeConfig", "ServerSaturated", "TokenStream"]
