"""Offline tensor-parallel checkpoint reshaping.

A copy of ``deepspeed_tpu/checkpoint/reshape.py`` (numpy only; ``torch`` is
imported where a ``.pt`` shard is read). Counterpart of
``deepspeed/runtime/state_dict_factory.py`` (``SDLoaderFactory`` :20,
``MegatronSDLoader`` :214 — merge/split of MP-sharded state dicts with
version-aware fused-QKV handling) and the offline reshape helpers in
``deepspeed/checkpoint/reshape_utils.py:51-73`` (merge/partition of state
lists) / ``reshape_meg_2d.py``.

Design note: the port's training checkpoints never need this — a universal
checkpoint holds each leaf whole (``checkpoint/universal.py``). What still
needs offline reshaping is the EXTERNAL world: Megatron-style per-rank
checkpoint files (``mp_rank_XX``) being imported at a different TP degree,
or exporting consolidated weights back out as N rank files. This module
does that with plain numpy on host — no device, no engine.

The fused-QKV row layouts handled (reference ``MegatronSDLoader.merge_query_
key_value`` :243 documents the same three):

- version 0:     ``[3 * np * hn, h]``   — Q rows for ALL local heads, then K,
                 then V (q/k/v-major). Merging ranks must interleave blocks.
- version 1.0/2.0: ``[np * (3|hn) * ..., h]`` — rank-major: each rank's rows
                 are self-contained, so merge/split is plain axis-0 concat.
"""

import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

# (pattern, rule) — first match wins. Patterns cover Megatron naming (the
# reference's doc'd key survey, state_dict_factory.py:218-241) plus the HF
# decoder names this framework's module_inject emits.
DEFAULT_RULES = [
    (r"query_key_value", "qkv"),
    (r"(dense_h_to_4h|word_embeddings|gate_proj|up_proj|q_proj|k_proj|v_proj"
     r"|fc_in|wte|lm_head)", "row"),
    (r"(attention\.dense\.weight|dense_4h_to_h\.weight|o_proj\.weight"
     r"|down_proj\.weight|fc_out\.weight)", "col"),
]


def infer_rule(key: str, rules=None) -> str:
    """'qkv' | 'row' (concat axis 0) | 'col' (concat axis 1) | 'replicate'."""
    for pattern, rule in (rules or DEFAULT_RULES):
        if re.search(pattern, key):
            return rule
    return "replicate"


# ---------------------------------------------------------------------------
# fused-QKV (version-aware) merge/split
# ---------------------------------------------------------------------------


def merge_qkv(param_list: Sequence[np.ndarray], version: float = 2.0) -> np.ndarray:
    """Merge per-rank fused-QKV rows into the full parameter.

    Reference semantics (``merge_query_key_value`` :243): version 0 is
    q/k/v-major per rank — split each rank's rows into thirds and
    re-interleave so the merged layout is [Q(all heads), K(all), V(all)];
    versions 1.0/2.0 are rank-major — plain concat.
    """
    if version == 0:
        thirds = []
        for p in param_list:
            if p.shape[0] % 3:
                raise ValueError(f"qkv v0 rows must divide by 3, got {p.shape}")
            thirds.append(np.split(p, 3, axis=0))
        return np.concatenate(
            [np.concatenate([t[i] for t in thirds], axis=0) for i in range(3)],
            axis=0)
    if version in (1.0, 2.0):
        return np.concatenate(list(param_list), axis=0)
    raise ValueError(f"unsupported checkpoint qkv version {version}")


def split_qkv(param: np.ndarray, num_to_split: int, offset: int,
              version: float = 2.0) -> np.ndarray:
    """Extract rank ``offset``'s fused-QKV rows (reference
    ``split_query_key_value`` :281)."""
    if version == 0:
        q, k, v = np.split(param, 3, axis=0)
        if q.shape[0] % num_to_split:
            raise ValueError(f"cannot split {q.shape[0]} rows {num_to_split} ways")
        return np.concatenate(
            [np.split(part, num_to_split, axis=0)[offset] for part in (q, k, v)],
            axis=0)
    if version in (1.0, 2.0):
        return np.split(param, num_to_split, axis=0)[offset]
    raise ValueError(f"unsupported checkpoint qkv version {version}")


# ---------------------------------------------------------------------------
# whole-state-dict merge / split / reshape
# ---------------------------------------------------------------------------


def _as_np(x):
    try:  # torch tensors from .pt shards
        import torch

        if isinstance(x, torch.Tensor):
            return x.detach().to(torch.float32).cpu().numpy() \
                if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    except ImportError:
        pass
    return np.asarray(x)


def merge_state_dicts(sd_list: Sequence[Dict[str, np.ndarray]],
                      version: float = 2.0, rules=None) -> Dict[str, np.ndarray]:
    """Merge N TP-rank state dicts into one (reference ``merge_state_dict``
    :327). Replicated entries are sanity-checked equal across ranks."""
    merged = {}
    for key in sd_list[0]:
        parts = [_as_np(sd[key]) for sd in sd_list]
        rule = infer_rule(key, rules)
        if rule == "qkv":
            merged[key] = merge_qkv(parts, version)
        elif rule == "row":
            merged[key] = np.concatenate(parts, axis=0)
        elif rule == "col" and parts[0].ndim >= 2:
            merged[key] = np.concatenate(parts, axis=1)
        else:
            if not all(p.shape == parts[0].shape for p in parts):
                raise ValueError(f"replicated key {key} differs in shape across ranks")
            merged[key] = parts[0]
    return merged


def split_state_dict(sd: Dict[str, np.ndarray], num_ranks: int, rank: int,
                     version: float = 2.0, rules=None) -> Dict[str, np.ndarray]:
    """Extract TP rank ``rank`` of ``num_ranks`` from a full state dict
    (reference ``split_state_dict`` :374)."""
    out = {}
    for key, value in sd.items():
        value = _as_np(value)
        rule = infer_rule(key, rules)
        if rule == "qkv":
            out[key] = split_qkv(value, num_ranks, rank, version)
        elif rule == "row":
            out[key] = np.split(value, num_ranks, axis=0)[rank]
        elif rule == "col" and value.ndim >= 2:
            out[key] = np.split(value, num_ranks, axis=1)[rank]
        else:
            out[key] = value
    return out


def reshape_tp(sd_list: Sequence[Dict[str, np.ndarray]], target_degree: int,
               version: float = 2.0, rules=None) -> List[Dict[str, np.ndarray]]:
    """N source shards → M target shards (any N, M with compatible divisions).

    Grouped like the reference (``get_merge_state_dicts`` :107 merges
    ``num_ckpt/mp`` files per target rank; ``get_split_state_dict`` :158
    splits one file ``mp/num_ckpt`` ways) so at most ``max(N/M, M/N)`` shards
    are resident at once; incompatible N↔M falls back to full merge + split.
    """
    n = len(sd_list)
    if target_degree == n:
        return list(sd_list)
    if n % target_degree == 0:
        group = n // target_degree
        return [merge_state_dicts(sd_list[r * group:(r + 1) * group], version, rules)
                for r in range(target_degree)]
    if target_degree % n == 0:
        per = target_degree // n
        return [split_state_dict(sd_list[r // per], per, r % per, version, rules)
                for r in range(target_degree)]
    full = merge_state_dicts(sd_list, version, rules)
    return [split_state_dict(full, target_degree, r, version, rules)
            for r in range(target_degree)]


# ---------------------------------------------------------------------------
# file-level loader (SDLoaderFactory / MegatronSDLoader analog)
# ---------------------------------------------------------------------------


class ShardedCheckpointLoader:
    """Load a list of per-rank checkpoint files and serve merged/split state
    dicts at any target MP degree (reference ``SDLoaderBase.load`` :60:
    merge when target < #files, passthrough when equal, split when >).

    Accepts ``.pt``/``.bin`` (torch pickles, loaded on CPU) and ``.npz``
    files. ``version`` selects the fused-QKV layout (see module docstring).
    """

    def __init__(self, ckpt_list: Sequence[str], version: float = 2.0,
                 module_key: Optional[str] = "module"):
        if not ckpt_list:
            raise ValueError("empty checkpoint list")
        self.ckpt_list = list(ckpt_list)
        self.version = version
        self.module_key = module_key

    def _load_file(self, path: str) -> Dict[str, np.ndarray]:
        if path.endswith(".npz"):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        import torch

        sd = torch.load(path, map_location="cpu", weights_only=False)
        if self.module_key and isinstance(sd, dict) and self.module_key in sd:
            sd = sd[self.module_key]  # reference get_module (:205)
        return {k: _as_np(v) for k, v in sd.items()}

    def load(self, mp_world_size: int, mp_rank: int,
             rules=None) -> Dict[str, np.ndarray]:
        n = len(self.ckpt_list)
        if n == mp_world_size:
            return self._load_file(self.ckpt_list[mp_rank])
        if n % mp_world_size == 0:
            group = n // mp_world_size
            shards = [self._load_file(p)
                      for p in self.ckpt_list[mp_rank * group:(mp_rank + 1) * group]]
            return merge_state_dicts(shards, self.version, rules)
        if mp_world_size % n == 0:
            per = mp_world_size // n
            full = self._load_file(self.ckpt_list[mp_rank // per])
            return split_state_dict(full, per, mp_rank % per, self.version, rules)
        shards = [self._load_file(p) for p in self.ckpt_list]
        full = merge_state_dicts(shards, self.version, rules)
        return split_state_dict(full, mp_world_size, mp_rank, self.version, rules)


def get_sd_loader(ckpt_list: Sequence[str], version: float = 2.0,
                  sd_type: str = "Megatron") -> ShardedCheckpointLoader:
    """Factory parity (reference ``SDLoaderFactory.get_sd_loader`` :33)."""
    if sd_type != "Megatron":
        raise ValueError(f"unknown sd_type {sd_type!r} (only 'Megatron' "
                         f"sharded layouts need offline reshaping here)")
    return ShardedCheckpointLoader(ckpt_list, version)
