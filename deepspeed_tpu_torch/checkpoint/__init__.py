"""Checkpoint subsystem: the save/load engines (``engine.py``), verified
manifests (``manifest.py``), offline TP reshaping (``reshape.py`` —
reference ``deepspeed/checkpoint/`` + ``runtime/state_dict_factory.py``),
universal topology-agnostic checkpoints (``universal.py``, the format the
port's saves are written in) and the flax layout (``from_flax.py``)."""

from .engine import (AsyncCheckpointEngine, CheckpointEngine,
                     TorchCheckpointEngine, load_pytree, load_train_state,
                     save_pytree, save_train_state)
from .manifest import (CheckpointCorruptionError, fsck, last_verified_tag,
                       prune_checkpoints, resolve_load_tag, verify_checkpoint,
                       write_manifest)
from .reshape import (ShardedCheckpointLoader, get_sd_loader, infer_rule,
                      merge_qkv, merge_state_dicts, reshape_tp, split_qkv,
                      split_state_dict)
from .universal import (convert_checkpoint, load_universal, restore_into,
                        save_universal)
