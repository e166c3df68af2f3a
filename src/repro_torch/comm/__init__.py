from repro_torch.comm.primitives import Payload, Router, global_router, reset_router  # noqa: F401
from repro_torch.comm.resharding import timed_weight_sync, transfer_stats  # noqa: F401
