"""Pipeline instruction schedules.

Counterpart of ``deepspeed/runtime/pipe/schedule.py`` (``PipeSchedule`` :6,
``InferenceSchedule`` :129, ``TrainSchedule`` :182, ``DataParallelSchedule``
:292, instruction classes :317-476). In the reference these drive an
imperative interpreter (``_exec_schedule`` ``pipe/engine.py:1359``). A copy
of ``deepspeed_tpu/pipe/schedule.py``: the port's one-stage
``PipelineEngine`` runs the microbatch loop itself, so these generators
serve API parity, schedule analysis and tests, and the bubble and buffer
accounting.
"""

from typing import Iterable, List


# ---------------------------------------------------------------------------
# Instructions (reference schedule.py:317-476)
# ---------------------------------------------------------------------------


class PipeInstruction:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        args = ", ".join(f"{k}={v}" for k, v in self.kwargs.items())
        return f"{type(self).__name__}({args})"

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class BufferOpInstruction(PipeInstruction):
    def __init__(self, buffer_id: int, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    pass


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


class PipeSchedule:
    """ABC (reference :6): yields lists of instructions per step for one
    stage of the grid."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id

    def steps(self) -> Iterable[List[PipeInstruction]]:
        raise NotImplementedError

    def num_pipe_buffers(self) -> int:
        return self.micro_batches

    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.stages - 1

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Forward-only fill-drain (reference :129)."""

    def steps(self):
        total = self.micro_batches + self.stages - 1
        for t in range(total):
            cmds: List[PipeInstruction] = []
            mb = t - self.stage_id
            if 0 <= mb < self.micro_batches:
                buf = mb % self.num_pipe_buffers()
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(buf))
                else:
                    cmds.append(RecvActivation(buf))
                cmds.append(ForwardPass(buf))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buf))
            yield cmds

    def num_pipe_buffers(self) -> int:
        return 2


class TrainSchedule(PipeSchedule):
    """1F1B fill-drain (reference :182): each stage runs
    ``min(stages - stage_id - 1, micro_batches)`` warmup forwards, then
    alternates one-forward-one-backward, then drains backwards. Peak
    in-flight activations per stage = warmup + 1 (the memory advantage over
    GPipe). Ends with ReduceTiedGrads → ReduceGrads → OptimizerStep."""

    def steps(self):
        M = self.micro_batches
        warmup = min(self.stages - self.stage_id - 1, M)
        nbuf = self.num_pipe_buffers()
        fwd_id = bwd_id = 0

        def fwd(mb):
            buf = mb % nbuf
            cmds = [LoadMicroBatch(buf) if self.is_first_stage else RecvActivation(buf),
                    ForwardPass(buf)]
            if not self.is_last_stage:
                cmds.append(SendActivation(buf))
            return cmds

        def bwd(mb):
            buf = mb % nbuf
            cmds = [] if self.is_last_stage else [RecvGrad(buf)]
            cmds.append(BackwardPass(buf))
            if not self.is_first_stage:
                cmds.append(SendGrad(buf))
            return cmds

        for _ in range(warmup):
            yield fwd(fwd_id)
            fwd_id += 1
        while fwd_id < M:
            yield fwd(fwd_id)
            fwd_id += 1
            yield bwd(bwd_id)
            bwd_id += 1
        while bwd_id < M:
            yield bwd(bwd_id)
            bwd_id += 1
        yield [ReduceTiedGrads(), ReduceGrads(), OptimizerStep()]

    def num_pipe_buffers(self) -> int:
        return max(1, min(self.stages - self.stage_id, self.micro_batches))


class DataParallelSchedule(PipeSchedule):
    """Pure-DP schedule (reference :292): forward+backward every microbatch,
    step at the end."""

    def steps(self):
        for mb in range(self.micro_batches):
            yield [LoadMicroBatch(0), ForwardPass(0), BackwardPass(0)]
        yield [ReduceGrads(), OptimizerStep()]

    def num_pipe_buffers(self) -> int:
        return 1


def bubble_fraction(micro_batches: int, stages: int) -> float:
    """Fill-drain bubble of the compiled pipeline: (S-1)/(M+S-1)."""
    return (stages - 1) / (micro_batches + stages - 1)
