from .block_pool import BlockPool, BlockPoolError  # noqa: F401
from .scheduler import (RejectedError, Request, RequestState,  # noqa: F401
                        Scheduler, TERMINAL_STATES)
from .metrics import ServingMetrics  # noqa: F401
from .engine import (RequestOutput, ServingConfig,  # noqa: F401
                     ServingEngine, init_serving)
