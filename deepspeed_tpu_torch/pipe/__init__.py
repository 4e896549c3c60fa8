from .module import LayerSpec, PipelineModule, TiedLayerSpec  # noqa: F401
from .schedule import (DataParallelSchedule, InferenceSchedule,  # noqa: F401
                       PipeSchedule, TrainSchedule)
from .engine import PipelineEngine  # noqa: F401
