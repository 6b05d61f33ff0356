"""The serving tier (port of tpu3dm/serve): the micro-batching engine and
its TCP JSON-lines front-end."""

from tpu3dm_torch.serve.client import RegistrationClient
from tpu3dm_torch.serve.engine import EngineOverloaded, PairResult, ServeConfig, ServeEngine
from tpu3dm_torch.serve.server import RegistrationServer

__all__ = [
    "EngineOverloaded",
    "PairResult",
    "RegistrationClient",
    "RegistrationServer",
    "ServeConfig",
    "ServeEngine",
]
