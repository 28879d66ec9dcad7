from repro_torch.serve.engine import Engine, GenerationResult
from repro_torch.serve.kv_cache import Request, SlotServer
