"""``deepspeed.checkpointing``: the user-callable activation-checkpointing
API.

Counterpart of ``deepspeed_tpu/checkpointing.py``: ``configure(...)`` and
``checkpoint(function, *args)``, a drop-in for ``torch.utils.checkpoint``
around a block. ``checkpoint`` runs ``models.layers.remat`` under the
configured policy: ``checkpoint_in_cpu`` (``cpu_checkpointing`` in the
config block) keeps the block's projection outputs in pinned host memory
(``"offload_dots_no_batch"``), otherwise nothing is kept and the whole
block is recomputed in the backward (``"nothing"``); the recompute
replays the forward's random draws.
``partition_activations``, ``contiguous_checkpointing`` and ``synchronize``
are accepted and change nothing on one device; ``profile`` logs the host
time of each checkpointed call.

The RNG helpers keep Megatron-style integrations working on real
generator states: :class:`CudaRNGStatesTracker` holds named
``torch.Generator`` states (of the CUDA device when there is one, else of
the CPU), and ``fork(name)`` runs its body on that state and keeps where
it left it.
"""

import contextlib
import json
import time
from typing import Any

import torch

from .models.layers import remat
from .utils.logging import log_dist

_config = {
    "configured": False,
    "policy": "nothing",          # classic torch-checkpoint semantics
    "profile": False,
    "num_checkpoints": None,
    "mpu": None,
    "seed": None,
}


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Each knob overwrites the configuration only when given, so
    repeated calls refine it; ``deepspeed_config`` (a dict or a JSON path)
    supplies its ``activation_checkpointing`` block's values for the knobs
    not given."""
    if deepspeed_config is not None:
        from .runtime.config import ActivationCheckpointingConfig

        cfg = deepspeed_config
        if not isinstance(cfg, dict):
            with open(cfg) as f:
                cfg = json.load(f)
        ac = ActivationCheckpointingConfig.from_dict(
            cfg.get("activation_checkpointing"), "activation_checkpointing")
        if checkpoint_in_cpu is None:
            checkpoint_in_cpu = ac.cpu_checkpointing
        if profile is None:
            profile = ac.profile
        if num_checkpoints is None:
            num_checkpoints = ac.number_checkpoints
    _config["configured"] = True
    if mpu_ is not None:
        _config["mpu"] = mpu_
    if num_checkpoints is not None:
        _config["num_checkpoints"] = num_checkpoints
    if profile is not None:
        _config["profile"] = bool(profile)
    if checkpoint_in_cpu is not None:
        _config["policy"] = ("offload_dots_no_batch" if checkpoint_in_cpu
                             else "nothing")


def is_configured() -> bool:
    return _config["configured"]


def reset() -> None:
    _config.update(configured=False, policy="nothing", profile=False,
                   num_checkpoints=None, mpu=None, seed=None)


def checkpoint(function, *args) -> Any:
    """Run ``function(*args)`` now, drop its activations (or keep what
    the policy keeps), recompute them in the backward. The recompute
    draws the forward's random numbers again: it starts from the
    generator states the forward started from (torch's
    ``preserve_rng_state``), and from the tracker's named states as they
    were then, so a ``get_cuda_rng_tracker().fork()`` inside ``function``
    replays its draws too; the tracker keeps the states the forward left."""
    tracker = get_cuda_rng_tracker()
    forward_states = tracker.get_states()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a)
        after = tracker.get_states()
        tracker.set_states(forward_states)
        try:
            return function(*a)
        finally:
            tracker.set_states(after)

    if not _config["profile"]:
        return remat(run, *args, policy=_config["policy"])
    t0 = time.perf_counter()
    out = remat(run, *args, policy=_config["policy"])
    log_dist(f"checkpointing: forward(enqueue) "
             f"{(time.perf_counter() - t0) * 1e3:.2f} ms", ranks=[0])
    return out


# -- RNG tracker -------------------------------------------------------------

_MODEL_PARALLEL_RNG = "model-parallel-rng"


def _rng_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _default_generator() -> torch.Generator:
    dev = _rng_device()
    if dev.type == "cuda":
        return torch.cuda.default_generators[torch.cuda.current_device()]
    return torch.default_generator


def model_parallel_cuda_manual_seed(seed: int) -> None:
    """Seed the CUDA device's default generator (when there is one) and
    register ``seed``'s state in the tracker as ``model-parallel-rng``
    (one device: every tensor-parallel rank is rank 0)."""
    _config["seed"] = int(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed(int(seed))
    _CUDA_RNG_STATE_TRACKER.add(_MODEL_PARALLEL_RNG, seed)


def get_rng_state(*_, **__):
    return {"seed": _config["seed"]}


def model_parallel_reconfigure_tp_seed(seed: int) -> None:
    model_parallel_cuda_manual_seed(seed)


class CudaRNGStatesTracker:
    """Named generator states. ``add(name, seed)`` stores the state of a
    generator seeded with ``seed``; ``fork(name)`` swaps it into the
    device's default generator for its body and stores the advanced state
    on exit, restoring the default generator's own state."""

    def __init__(self):
        self.states = {}
        self.seeds = {}

    def reset(self):
        self.states = {}
        self.seeds = {}

    def add(self, name, seed):
        g = torch.Generator(device=_rng_device())
        g.manual_seed(int(seed))
        self.states[name] = g.get_state()
        self.seeds[name] = int(seed)

    def get_states(self):
        return {name: s.clone() for name, s in self.states.items()}

    def set_states(self, states):
        self.states = {name: s.clone() for name, s in states.items()}

    @contextlib.contextmanager
    def fork(self, name=_MODEL_PARALLEL_RNG):
        if name not in self.states:
            raise KeyError(f"rng state {name!r} is not added")
        gen = _default_generator()
        saved = gen.get_state()
        gen.set_state(self.states[name])
        try:
            yield
        finally:
            self.states[name] = gen.get_state()
            gen.set_state(saved)


_CUDA_RNG_STATE_TRACKER = CudaRNGStatesTracker()


def get_cuda_rng_tracker() -> CudaRNGStatesTracker:
    return _CUDA_RNG_STATE_TRACKER
