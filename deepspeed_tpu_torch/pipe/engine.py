"""The pipeline training engine, for one stage.

Counterpart of ``deepspeed_tpu/pipe/engine.py`` (``PipelineEngine``) on
one device. The batch triangle (train = micro x gas) decides the
microbatch count; the inner engine runs at gas 1 and the pipeline's loss
is the mean of the microbatches' losses, as the JAX fill-drain program
computes it. ``pipeline.time_checkpoint_chunk`` (default ``"auto"``:
max(2, round(sqrt(M + S - 1)))) recomputes each chunk of that many
microbatches in the backward, so only the chunks' losses stay live; 0
keeps every activation. A module of more than one stage needs as many
devices and raises naming ROADMAP item 9; ZeRO stage 3 with a pipeline
raises, as in JAX. Precision, clipping, the optimizer and the captured
step are the inherited engine's.
"""

from typing import Any, Dict, Iterator, Optional

import torch

from ..runtime.config import DeepSpeedConfig
from ..runtime.config_utils import unported
from ..runtime.engine import DeepSpeedEngine, _as_tensor, load_config_dict
from .module import PipelineModule
from .schedule import TrainSchedule, bubble_fraction


def _time_chunk(pipe_cfg: Dict, micro_batches: int, num_stages: int) -> int:
    chunk = pipe_cfg.get("time_checkpoint_chunk", "auto") or 0
    if chunk == "auto":
        chunk = max(2, int(round((micro_batches + num_stages - 1) ** 0.5)))
    chunk = int(chunk)
    if chunk < 0:
        raise ValueError(f"pipeline.time_checkpoint_chunk must be >= 0 or "
                         f"'auto', got {chunk}")
    return chunk


class PipelineEngine(DeepSpeedEngine):
    """See the module docstring. Construct through ``initialize`` with a
    ``PipelineModule``."""

    def __init__(self, model: PipelineModule, config=None, device=None,
                 cuda_graph: bool = True, optimizer=None, lr_scheduler=None):
        if not isinstance(model, PipelineModule):
            raise TypeError("PipelineEngine requires a PipelineModule")
        if model.num_stages > 1:
            raise unported(
                f"a pipeline of {model.num_stages} stages",
                "the distributed and ZeRO slice (item 9): a pipe axis of "
                f"{model.num_stages} stages needs {model.num_stages} devices")
        self.pipe_module = model
        config = dict(load_config_dict(config) or {})
        tri = DeepSpeedConfig(dict(config))
        self.micro_batches = int(tri.gradient_accumulation_steps)
        inner = dict(config)
        inner["train_batch_size"] = tri.train_batch_size
        inner["gradient_accumulation_steps"] = 1
        inner.pop("train_micro_batch_size_per_gpu", None)
        pipe_cfg = dict(config.get("pipeline") or {})
        self.time_checkpoint_chunk = _time_chunk(pipe_cfg, self.micro_batches,
                                                 model.num_stages)
        if int((config.get("zero_optimization") or {}).get("stage", 0)) >= 3:
            raise ValueError("ZeRO stage 3 is incompatible with pipeline "
                             "parallelism; use stage <= 2 (optimizer/grad "
                             "sharding) with PP")
        self.schedule = pipe_cfg.get("schedule", "fill_drain")
        if self.schedule not in ("fill_drain", "1f1b"):
            raise ValueError(f"pipeline.schedule must be 'fill_drain' or "
                             f"'1f1b', got {self.schedule!r}")
        super().__init__(model, config=inner, device=device,
                         cuda_graph=cuda_graph, optimizer=optimizer,
                         lr_scheduler=lr_scheduler,
                         loss_fn=self._pipeline_loss)

    def _pipeline_loss(self, module: PipelineModule, batch, generator):
        """The mean of the microbatches' losses, each chunk of
        ``time_checkpoint_chunk`` microbatches recomputed in the
        backward."""
        inputs, labels = batch["inputs"], batch["labels"]
        M = self.micro_batches
        if inputs.shape[0] % M != 0:
            raise ValueError(f"batch {inputs.shape[0]} must divide into "
                             f"{M} equal microbatches")
        mb = inputs.shape[0] // M

        def chunk_loss(lo, hi):
            def run(x, y):
                total = None
                for m in range(hi - lo):
                    loss = module(x[m * mb:(m + 1) * mb],
                                  y[m * mb:(m + 1) * mb]).float()
                    total = loss if total is None else total + loss
                return total
            return run

        step = self.time_checkpoint_chunk or M
        total = None
        for lo in range(0, M, step):
            hi = min(M, lo + step)
            x, y = inputs[lo * mb:hi * mb], labels[lo * mb:hi * mb]
            if self.time_checkpoint_chunk and torch.is_grad_enabled():
                from ..checkpointing import checkpoint

                part = checkpoint(chunk_loss(lo, hi), x, y)
            else:
                part = chunk_loss(lo, hi)(x, y)
            total = part if total is None else total + part
        return total / M

    @staticmethod
    def _canonical_batch(batch) -> Dict[str, Any]:
        """The reference's ``(inputs, labels)`` or a dict."""
        if isinstance(batch, dict):
            return batch
        inputs, labels = batch
        return {"inputs": inputs, "labels": labels}

    def train_batch(self, data_iter: Optional[Iterator] = None, batch=None):
        """One optimizer step over ``micro_batches`` microbatches; an
        iterator yields microbatches and this pulls that many."""
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs a batch or data iterator")
            micro = [self._canonical_batch(next(data_iter))
                     for _ in range(self.micro_batches)]
            batch = {k: torch.cat([_as_tensor(m[k]) for m in micro])
                     for k in micro[0]}
        return super().train_batch(batch=self._canonical_batch(batch))

    def eval_batch(self, batch):
        return super().eval_batch(self._canonical_batch(batch))

    def train_schedule(self, stage_id: int = 0) -> TrainSchedule:
        """The reference 1F1B instruction schedule at this configuration."""
        return TrainSchedule(self.micro_batches, self.pipe_module.num_stages,
                             stage_id)

    def bubble_fraction(self) -> float:
        return bubble_fraction(self.micro_batches,
                               self.pipe_module.num_stages)

    def is_pipe_parallel(self) -> bool:
        return True
