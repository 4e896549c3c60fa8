"""Rank-aware logging.

``log_dist`` filters by the ``torch.distributed`` rank (0 when no process
group is initialized).
"""

import logging
import os
import sys
from typing import Iterable, Optional

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


def create_logger(name: str = "deepspeed_tpu_torch",
                  level: int = logging.INFO) -> logging.Logger:
    logger_ = logging.getLogger(name)
    if logger_.handlers:
        return logger_
    logger_.setLevel(level)
    logger_.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger_.addHandler(handler)
    return logger_


logger = create_logger(
    level=LOG_LEVELS.get(os.environ.get("DEEPSPEED_TPU_LOG_LEVEL", "info").lower(), logging.INFO)
)


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given ranks (None or [-1] = all)."""
    rank = _rank()
    should_log = ranks is None or any(r in (-1, rank) for r in ranks)
    if should_log:
        logger.log(level, f"[Rank {rank}] {message}")
