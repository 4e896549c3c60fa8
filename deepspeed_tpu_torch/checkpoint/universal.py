"""Universal (topology-agnostic) checkpoints.

Counterpart of ``deepspeed_tpu/checkpoint/universal.py``, in the same
layout, so each package reads what the other writes:

    <out_dir>/
      universal_meta.json   {format, step, leaf name -> shape/dtype/file,
                             client_state}
      leaves/NNNN__<name>.npy   ONE file per leaf, keyed by the JAX
                            ``TrainState``'s flat names ("step",
                            "params/<path>", "opt_state/0/mu/<path>", ...)

Floating leaves are stored as fp32 (numpy has no bf16), integer leaves as
they are. Leaves are written one at a time and memory-mapped on load, so a
save or a restore streams through host memory one leaf at a time. The v1
single-``state.npz`` form is still read.

The port writes no orbax: its training checkpoints ARE universal
directories (``checkpoint/engine.py`` writes one per tag), so one reader
takes either package's universal output, and the JAX engine loads a port
save with ``load_checkpoint(<dir>/<tag>, load_universal=True)``.

A state here is a tree of nested dicts (sorted keys, as
``jax.tree_util`` flattens them) whose leaves are torch tensors, numpy
arrays or :class:`~.from_flax.LeafView` s — or a :class:`NamedLeaves`
list of ``(name, leaf)`` pairs, taken in its own order (the training
engine names its state this way). :func:`restore_into` writes a
checkpoint into such a template IN PLACE (``copy_`` for a tensor), so
memory that a captured CUDA graph reads keeps its address.
"""

import json
import os
import re
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .from_flax import LeafView

FORMAT = "deepspeed_tpu_universal_v2"
META_FILE = "universal_meta.json"


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:160]


class NamedLeaves(list):
    """A state given as its ``(name, leaf)`` pairs, in order."""


def iter_leaves(state, prefix: str = ""):
    """``(name, leaf)`` over a state (see the module docstring); ``None``
    leaves are skipped."""
    if isinstance(state, NamedLeaves):
        yield from state
        return
    if not isinstance(state, Mapping):
        if state is not None:
            yield prefix, state
        return
    for key, sub in sorted(state.items(), key=lambda kv: str(kv[0])):
        yield from iter_leaves(sub, f"{prefix}/{key}" if prefix else str(key))


def host_array(leaf) -> np.ndarray:
    """A leaf as a host array; bf16 widened to fp32 (universal =
    plain-numpy readable)."""
    if isinstance(leaf, LeafView):
        leaf = leaf.tensor()
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def save_universal(state, out_dir: str, client_state: Optional[Dict] = None,
                   step: Optional[int] = None) -> None:
    """Write ``state`` as a universal checkpoint, one leaf at a time: peak
    host memory is the largest leaf, not the state."""
    leaf_dir = os.path.join(out_dir, "leaves")
    os.makedirs(leaf_dir, exist_ok=True)
    leaves_meta = {}
    for name, leaf in iter_leaves(state):
        arr = host_array(leaf)
        fname = f"{len(leaves_meta):04d}__{_sanitize(name)}.npy"
        np.save(os.path.join(leaf_dir, fname), arr)
        leaves_meta[name] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                             "file": os.path.join("leaves", fname)}
        del arr
    meta = {
        "format": FORMAT,
        "step": int(step) if step is not None else None,
        "leaves": leaves_meta,
        "client_state": client_state or {},
    }
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)


class LazyLeafDict(Mapping):
    """name -> np.ndarray, loaded lazily (mmap for v2 per-leaf files) so a
    restore streams through bounded host memory."""

    def __init__(self, universal_dir: str, meta: Dict):
        self._dir = universal_dir
        self._meta = meta
        self._npz = None  # v1: one state.npz archive
        if "file" not in next(iter(meta["leaves"].values()), {"file": None}) \
                or meta.get("format") == "deepspeed_tpu_universal_v1":
            self._npz = np.load(os.path.join(universal_dir, "state.npz"))

    def __getitem__(self, name: str) -> np.ndarray:
        if self._npz is not None:
            return self._npz[name]
        rel = self._meta["leaves"][name]["file"]
        return np.load(os.path.join(self._dir, rel), mmap_mode="r")

    def __iter__(self):
        return iter(self._meta["leaves"])

    def __len__(self):
        return len(self._meta["leaves"])


def nest(flat: Mapping) -> Dict[str, Any]:
    """A flat ``name -> array`` mapping as nested dicts, one level for each
    ``/``-separated part of a name."""
    tree: Dict[str, Any] = {}
    for name in flat:
        node = tree
        *parents, leaf = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = flat[name]
    return tree


def load_universal(universal_dir: str) -> Tuple[Mapping, Dict]:
    """(lazy flat state dict, meta) from a universal checkpoint dir."""
    with open(os.path.join(universal_dir, META_FILE)) as f:
        meta = json.load(f)
    if not str(meta.get("format", "")).startswith("deepspeed_tpu_universal_v"):
        raise ValueError(f"{universal_dir} is not a universal checkpoint")
    return LazyLeafDict(universal_dir, meta), meta


def _write(leaf, src: np.ndarray) -> None:
    """Copy ``src`` into ``leaf`` in place."""
    if isinstance(leaf, LeafView):
        leaf.load(src)
    elif torch.is_tensor(leaf):
        with torch.no_grad():
            leaf.copy_(torch.from_numpy(np.array(src)))
    else:
        leaf[...] = src


def restore_into(template_state, universal_dir: str,
                 load_optimizer_states: bool = True):
    """Map a universal checkpoint onto ``template_state`` by leaf NAME,
    writing each leaf in place. With ``load_optimizer_states=False`` the
    ``opt_state/...`` leaves keep their values. A leaf the template has and
    the checkpoint lacks raises ``KeyError``; a shape mismatch raises
    ``ValueError`` (both before anything is written). Returns
    ``(template_state, meta)``."""
    flat, meta = load_universal(universal_dir)
    plan = []
    for name, leaf in iter_leaves(template_state):
        if not load_optimizer_states and name.startswith("opt_state/"):
            continue
        if name not in flat:
            raise KeyError(
                f"universal checkpoint is missing leaf {name!r} (optimizer "
                f"mismatch? pass load_optimizer_states=False to keep the "
                f"engine's fresh optimizer state)")
        src = flat[name]  # memory-mapped: reads only the header here
        if tuple(src.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: checkpoint "
                             f"{tuple(src.shape)} vs engine "
                             f"{tuple(leaf.shape)}")
        plan.append((leaf, src))
    for leaf, src in plan:
        _write(leaf, src)
    return template_state, meta


def convert_checkpoint(ckpt_dir: str, out_dir: str,
                       tag: Optional[str] = None) -> None:
    """Offline: a training checkpoint directory of the port (verified
    through its manifest, with the walk back to the newest verified save)
    -> a universal directory (the ``ds_to_universal`` CLI body; no engine
    or device). The port's tag directory is already universal, so this
    copies its leaves with the save's client state."""
    from .manifest import resolve_load_tag

    tag = resolve_load_tag(ckpt_dir, tag)
    flat, _ = load_universal(os.path.join(ckpt_dir, tag))
    client_state = {}
    cs_path = os.path.join(ckpt_dir, f"{tag}.client_state.json")
    if os.path.exists(cs_path):
        with open(cs_path) as f:
            client_state = json.load(f)
    step = client_state.get("global_steps")
    save_universal(NamedLeaves(flat.items()), out_dir, client_state=client_state,
                   step=step)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a deepspeed_tpu_torch training checkpoint to "
                    "the universal (topology-agnostic per-leaf npy) format")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("output_dir")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)
    convert_checkpoint(args.checkpoint_dir, args.output_dir, args.tag)
    print(f"wrote universal checkpoint to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
