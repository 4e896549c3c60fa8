"""Checkpoint save/load.

Counterpart of ``deepspeed_tpu/checkpoint/engine.py`` (the reference's
``CheckpointEngine`` ABC: create/save/load/commit, plus the training
engine's save/load protocol). The JAX package writes a tag through orbax;
the port cannot, and writes each tag as a universal directory instead
(``checkpoint/universal.py``: one ``.npy`` a leaf under the JAX
``TrainState``'s names), under the same manifest rules
(``checkpoint/manifest.py``). So ``load_universal=True`` reads either
package's universal output with one reader, and the JAX engine loads a
port save with ``load_checkpoint(<dir>/<tag>, load_universal=True)``.
"""

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

from ..utils.fault_injection import (maybe_corrupt_file, maybe_crash,
                                     maybe_fail, maybe_truncate_file,
                                     retry_with_backoff)
from ..utils.logging import log_dist
from .manifest import (atomic_write_json, atomic_write_text, resolve_load_tag,
                       write_manifest)
from .universal import (NamedLeaves, host_array, iter_leaves,
                        load_universal, nest, restore_into, save_universal)

LATEST_FILE = "latest"  # the reference writes the same tag file


class CheckpointEngine:
    """ABC parity (reference ``checkpoint_engine.py:1``)."""

    def __init__(self, config_params=None):
        self.config = config_params

    def create(self, tag: str):
        log_dist(f"[Checkpoint] Saving {tag}...", ranks=[0])

    def save(self, state_dict: Any, path: str,
             client_state: Optional[Dict] = None,
             step: Optional[int] = None):
        raise NotImplementedError

    def load(self, path: str, map_location=None,
             template_state: Any = None,
             load_optimizer_states: bool = True):
        """``template_state`` given: the checkpoint is written into it in
        place (:func:`~.universal.restore_into`) and it is returned;
        otherwise the checkpoint as a nested dict of host arrays."""
        if template_state is not None:
            return restore_into(template_state, path,
                                load_optimizer_states)[0]
        return load_pytree(path)

    def commit(self, tag: str) -> bool:
        return True


class TorchCheckpointEngine(CheckpointEngine):
    """The synchronous engine: streams the state to disk one leaf at a
    time (each leaf copied to the host behind the work already queued on
    the current stream)."""

    def save(self, state_dict: Any, path: str,
             client_state: Optional[Dict] = None,
             step: Optional[int] = None):
        save_universal(state_dict, os.path.abspath(path),
                       client_state=client_state, step=step)


class AsyncCheckpointEngine(CheckpointEngine):
    """Async save (the Nebula analog, ``nebula_checkpoint_engine.py``):
    snapshot the state to host memory, then write it on a thread;
    :meth:`commit` joins the thread (and raises what it raised) before
    the manifest hashes the files."""

    def __init__(self, config_params=None):
        super().__init__(config_params)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state_dict: Any, path: str,
             client_state: Optional[Dict] = None,
             step: Optional[int] = None):
        self._join()  # one write in flight at a time
        snapshot = NamedLeaves((name, host_array(leaf))
                               for name, leaf in iter_leaves(state_dict))

        def write():
            try:
                save_universal(snapshot, os.path.abspath(path),
                               client_state=client_state, step=step)
            except BaseException as e:  # surfaced by commit()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name="ds-async-checkpoint")
        self._thread.start()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def commit(self, tag: str) -> bool:
        self._join()
        return True


def save_pytree(path: str, tree: Any) -> None:
    """Save a bare pytree (e.g. inference weights) as a universal
    directory."""
    TorchCheckpointEngine().save(tree, path)


def load_pytree(path: str, abstract_state: Any = None) -> Any:
    """Load a bare pytree: a nested dict of host arrays (memory-mapped),
    its keys the ``/``-separated parts of each leaf's name; with
    ``abstract_state``, the checkpoint written into that template in place
    instead."""
    if abstract_state is not None:
        return restore_into(abstract_state, path)[0]
    return nest(load_universal(path)[0])


def load_pytree_numpy(path: str) -> Any:
    """The checkpoint as host numpy arrays, with no device: what
    :func:`load_pytree` returns (the port reads every checkpoint to the
    host first)."""
    return load_pytree(path)


# ---------------------------------------------------------------------------
# TrainState save/load used by DeepSpeedEngine
# ---------------------------------------------------------------------------


def save_train_state(save_dir: str, tag: str, state, client_state: Dict,
                     save_latest: bool = True, use_async: bool = False,
                     save_retries: int = 3, retry_backoff_s: float = 0.5,
                     manifest_checksums: bool = True) -> None:
    """Verified atomic save protocol (see ``checkpoint/manifest.py``):
    data → client_state (atomic) → manifest (atomic, LAST) → ``latest``
    (atomic). A death at any point leaves either the previous verified
    save authoritative or this one fully verified — never a half-save a
    resume could trust. The data write is retried with bounded
    exponential backoff."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(save_dir), tag)
    step = client_state.get("global_steps") if client_state else None
    engine = AsyncCheckpointEngine() if use_async else TorchCheckpointEngine()
    engine.create(tag)
    maybe_crash("crash_during_save", step=step, tag=tag, phase="begin")

    def _write():
        maybe_fail("flaky_save", step=step, tag=tag)
        engine.save(state, path, client_state=client_state, step=step)

    retry_with_backoff(_write, retries=save_retries,
                       base_delay=retry_backoff_s,
                       what=f"checkpoint save {tag}",
                       exceptions=(OSError, ValueError))
    atomic_write_json(os.path.join(save_dir, f"{tag}.client_state.json"),
                      client_state)
    engine.commit(tag)  # the async write must land before the manifest
    # injected death AFTER the data commit but BEFORE the manifest/latest:
    # the classic partial save this protocol exists to survive
    maybe_crash("crash_during_save", step=step, tag=tag, phase="commit")
    mpath = write_manifest(save_dir, tag, step=step,
                           checksums=manifest_checksums)
    maybe_corrupt_file("corrupt_manifest", mpath, step=step, tag=tag)
    if save_latest:
        latest_path = os.path.join(save_dir, LATEST_FILE)
        atomic_write_text(latest_path, tag)
        maybe_truncate_file("truncate_latest", latest_path, step=step, tag=tag)


def load_train_state(load_dir: str, tag: Optional[str], template_state,
                     load_optimizer_states: bool = True,
                     verify: bool = True) -> Tuple[Any, Dict]:
    """Write the save ``tag`` (None: ``latest``) into ``template_state`` in
    place; returns it and the save's client state. With ``verify`` the tag
    goes through :func:`~.manifest.resolve_load_tag` (the walk back to the
    newest verified save)."""
    if verify:
        tag = resolve_load_tag(load_dir, tag)
    elif tag is None:
        with open(os.path.join(load_dir, LATEST_FILE)) as f:
            tag = f.read().strip()
    path = os.path.join(os.path.abspath(load_dir), tag)
    restored = TorchCheckpointEngine().load(
        path, template_state=template_state,
        load_optimizer_states=load_optimizer_states)

    client_state: Dict = {}
    cs_path = os.path.join(load_dir, f"{tag}.client_state.json")
    if os.path.exists(cs_path):
        with open(cs_path) as f:
            client_state = json.load(f)
    return restored, client_state
