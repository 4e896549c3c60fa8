"""Checkpoint manifests: verified atomic saves and last-good-fallback loads.

A copy of ``deepspeed_tpu/checkpoint/manifest.py`` (which imports no JAX),
kept word for word in its code so both packages pick the same tag on the
same directory: the manifest does not depend on the file format, and the
port's tag directory (a universal checkpoint, ``checkpoint/universal.py``)
is inventoried as the JAX package's orbax directory is.

The failure this closes: a bare, non-atomic ``latest`` with nothing behind
it — a worker killed mid-save (or a torn ``latest`` write) left the job
pointing at a partial checkpoint, and the next resume either crashed or
silently loaded garbage.

Protocol (write side, ``checkpoint/engine.py::save_train_state``):

1. the tag directory's data is written (one ``.npy`` a leaf, then
   ``universal_meta.json``);
2. the engine-owned ``<tag>.client_state.json`` is written atomically;
3. ``<tag>.manifest.json`` is written LAST via temp-file + ``os.replace``:
   per-item byte sizes for every file in the save, plus sha256 checksums
   over every file small enough to hash cheaply (the metadata, the client
   state, small leaves);
4. ``latest`` is replaced atomically.

A save is *verified* iff its manifest parses and every recorded item exists
with the recorded size/checksum. Any crash between steps leaves either the
previous verified save intact (no manifest yet → the new save is invisible
to recovery) or a fully verified new save — there is no in-between state a
resume can trust by accident.

Read side: ``resolve_load_tag`` verifies before restoring and, when the
requested/latest save is missing, corrupt, or partial, walks back to the
newest save whose manifest verifies — logging loudly — instead of crashing.
Retention (``prune_checkpoints``) keeps the last N saves but never deletes
the newest verified one.
"""

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils.logging import logger

MANIFEST_FORMAT = "deepspeed_tpu_manifest_v1"
MANIFEST_SUFFIX = ".manifest.json"
LATEST_FILE = "latest"

#: files at most this size get a sha256 in the manifest (covers client_state,
#: the universal metadata and small leaves; skips multi-GB leaves, whose
#: byte sizes are still recorded and checked)
CHECKSUM_MAX_BYTES = 4 * 1024 * 1024

#: per-tag sidecar files that belong to a save besides its tag directory
#: (the JAX package's ZeRO-Offload host optimizer banks and ZeRO-Infinity
#: host npz, the client state): kept so both packages inventory one
#: directory alike
SIDECAR_SUFFIXES = (".client_state.json", ".host_optimizer.npz",
                    ".infinity.npz")

_TAG_STEP_RE = re.compile(r"global_step(\d+)$")


class CheckpointCorruptionError(RuntimeError):
    """No loadable checkpoint: the requested save failed verification and no
    fallback verified (or fallback was disallowed)."""


# ---------------------------------------------------------------------------
# Atomic small-file writes
# ---------------------------------------------------------------------------


def atomic_write_text(path: str, text: str) -> None:
    """Temp-file + ``os.replace``: readers see the old content or the new,
    never a torn half-write."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_text(path, json.dumps(obj, indent=1, sort_keys=True))


# ---------------------------------------------------------------------------
# Manifest write / verify
# ---------------------------------------------------------------------------


def manifest_path(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, f"{tag}{MANIFEST_SUFFIX}")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _iter_save_files(save_dir: str, tag: str):
    """(relpath-under-save_dir, abspath) for every file belonging to a save:
    the tag directory tree plus the engine-owned sidecars."""
    tag_dir = os.path.join(save_dir, tag)
    if os.path.isdir(tag_dir):
        for root, _dirs, files in os.walk(tag_dir):
            for name in sorted(files):
                ap = os.path.join(root, name)
                yield os.path.relpath(ap, save_dir), ap
    for suffix in SIDECAR_SUFFIXES:
        ap = os.path.join(save_dir, f"{tag}{suffix}")
        if os.path.exists(ap):
            yield f"{tag}{suffix}", ap


def write_manifest(save_dir: str, tag: str, step: Optional[int] = None,
                   checksums: bool = True) -> str:
    """Snapshot the save's file inventory; committed atomically, LAST."""
    items: Dict[str, Dict[str, Any]] = {}
    for rel, ap in _iter_save_files(save_dir, tag):
        size = os.path.getsize(ap)
        rec: Dict[str, Any] = {"bytes": size}
        if checksums and size <= CHECKSUM_MAX_BYTES:
            rec["sha256"] = _sha256(ap)
        items[rel] = rec
    if not items:
        raise FileNotFoundError(
            f"write_manifest: no files found for save {tag!r} in {save_dir}")
    manifest = {"format": MANIFEST_FORMAT, "tag": tag, "step": step,
                "wallclock": time.time(), "items": items}
    path = manifest_path(save_dir, tag)
    atomic_write_json(path, manifest)
    return path


def read_manifest(save_dir: str, tag: str) -> Dict:
    with open(manifest_path(save_dir, tag)) as f:
        manifest = json.load(f)
    if manifest.get("format") != MANIFEST_FORMAT or "items" not in manifest:
        raise ValueError(f"not a {MANIFEST_FORMAT} manifest")
    return manifest


def verify_checkpoint(save_dir: str, tag: str) -> Tuple[str, str]:
    """(status, detail). Status:

    - ``"verified"``: manifest parses and every item matches size+checksum;
    - ``"legacy"``: no manifest (pre-manifest save) but the data directory
      exists — loadable, just not integrity-checked;
    - ``"bad"``: missing data, unparsable manifest, or any item mismatch.
    """
    mpath = manifest_path(save_dir, tag)
    if not os.path.exists(mpath):
        # pre-manifest saves: a tag directory OR a data sidecar
        # (ZeRO-Infinity saves are a bare <tag>.infinity.npz, no directory)
        if os.path.isdir(os.path.join(save_dir, tag)) or \
                os.path.exists(os.path.join(save_dir, f"{tag}.infinity.npz")):
            return "legacy", f"no manifest for {tag} (pre-manifest save)"
        return "bad", f"save {tag!r} not found in {save_dir}"
    try:
        manifest = read_manifest(save_dir, tag)
    except (OSError, ValueError) as e:
        return "bad", f"manifest for {tag} unreadable: {e}"
    for rel, rec in manifest["items"].items():
        ap = os.path.join(save_dir, rel)
        if not os.path.exists(ap):
            return "bad", f"{tag}: missing item {rel}"
        size = os.path.getsize(ap)
        if size != rec["bytes"]:
            return "bad", (f"{tag}: size mismatch for {rel} "
                           f"({size} != {rec['bytes']})")
        if "sha256" in rec and _sha256(ap) != rec["sha256"]:
            return "bad", f"{tag}: checksum mismatch for {rel}"
    return "verified", f"{tag}: {len(manifest['items'])} items verified"


# ---------------------------------------------------------------------------
# Tag discovery / resolution
# ---------------------------------------------------------------------------


def tag_step(save_dir: str, tag: str) -> Optional[int]:
    m = _TAG_STEP_RE.search(tag)
    if m:
        return int(m.group(1))
    try:
        step = read_manifest(save_dir, tag).get("step")
        return int(step) if step is not None else None
    except (OSError, ValueError):
        return None


def list_tags(save_dir: str) -> List[str]:
    """Every save tag present (data dir or manifest), newest step first;
    step-less tags sort last by mtime."""
    tags = set()
    try:
        names = os.listdir(save_dir)
    except OSError:
        return []
    for name in names:
        if name.endswith(MANIFEST_SUFFIX):
            tags.add(name[:-len(MANIFEST_SUFFIX)])
        elif name.endswith(".infinity.npz") and \
                _TAG_STEP_RE.search(name[:-len(".infinity.npz")]):
            tags.add(name[:-len(".infinity.npz")])
        elif os.path.isdir(os.path.join(save_dir, name)) and \
                _TAG_STEP_RE.search(name):
            tags.add(name)

    def key(tag):
        step = tag_step(save_dir, tag)
        try:
            mtime = os.path.getmtime(os.path.join(save_dir, tag))
        except OSError:
            mtime = 0.0
        return (0, step, mtime) if step is not None else (-1, 0, mtime)

    return sorted(tags, key=key, reverse=True)


def read_latest_tag(save_dir: str) -> Optional[str]:
    """The ``latest`` pointer, or None when missing/unreadable (a torn write
    is data, not an exception, on this path)."""
    try:
        with open(os.path.join(save_dir, LATEST_FILE)) as f:
            tag = f.read().strip()
        return tag or None
    except OSError:
        return None


def last_verified_tag(save_dir: str,
                      exclude: Tuple[str, ...] = ()) -> Optional[str]:
    for tag in list_tags(save_dir):
        if tag in exclude:
            continue
        if verify_checkpoint(save_dir, tag)[0] == "verified":
            return tag
    return None


def _flight_verify_failure(save_dir: str, tag: Optional[str],
                           detail: str) -> None:
    """Post-mortem hook: a checkpoint that fails verification is an
    incident worth evidence even when the load recovers via walk-back.
    Dumps through the process-global flight recorder (armed by
    ``DS_TRACE_DIR`` / ``monitor.tracing.configure``; no-op otherwise) —
    this module has no engine handle, so the global default is the only
    recorder it can reach. Never raises."""
    try:
        from ..monitor.tracing import flight_dump

        flight_dump("checkpoint_verify",
                    {"dir": save_dir, "tag": tag, "detail": detail})
    except Exception:  # tracing must never break a checkpoint load
        pass


def resolve_load_tag(save_dir: str, tag: Optional[str] = None,
                     allow_fallback: bool = True) -> str:
    """Pick the tag a load should restore.

    Explicit ``tag``: verified (or legacy) → returned; failed verification
    raises — the caller asked for that exact save, silently substituting a
    different one would be worse than failing.

    ``tag=None`` (resume-from-latest): the ``latest`` pointer is untrusted
    input — missing/torn/corrupt/partial saves fall back to the newest save
    whose manifest verifies, logged loudly.
    """
    if tag is not None:
        status, detail = verify_checkpoint(save_dir, tag)
        if status == "bad":
            _flight_verify_failure(save_dir, tag, detail)
            raise CheckpointCorruptionError(
                f"checkpoint {tag!r} in {save_dir} failed verification "
                f"({detail}); refusing to load it. Newest verified save: "
                f"{last_verified_tag(save_dir, exclude=(tag,))!r}")
        return tag

    candidate = read_latest_tag(save_dir)
    if candidate is None and not list_tags(save_dir):
        # fresh dir (or no save ever completed): not corruption, no noise
        raise CheckpointCorruptionError(
            f"no checkpoint in {save_dir} (no 'latest' tag and no saves)")
    if candidate is not None:
        status, detail = verify_checkpoint(save_dir, candidate)
        if status in ("verified", "legacy"):
            if status == "legacy":
                logger.info(f"[checkpoint] {detail}; loading unverified")
            return candidate
        logger.error(f"[checkpoint] latest save failed verification "
                     f"({detail})" + ("; falling back to the newest "
                                      "verified save" if allow_fallback
                                      else ""))
        # the walk-back SUCCEEDING still means a save was lost to
        # corruption — leave a post-mortem even though the load recovers
        _flight_verify_failure(save_dir, candidate, detail)
    else:
        logger.error(f"[checkpoint] no readable 'latest' tag in {save_dir}" +
                     ("; falling back to the newest verified save"
                      if allow_fallback else ""))
        # saves exist (the fresh-dir case returned above) but the pointer
        # is unreadable/torn — an incident, dump it like a bad manifest
        _flight_verify_failure(save_dir, None, "no readable 'latest' tag")
    if allow_fallback:
        exclude = (candidate,) if candidate else ()
        fallback = last_verified_tag(save_dir, exclude=exclude)
        if fallback is None:
            # no verified save anywhere — accept the newest LEGACY
            # (pre-manifest) save rather than discarding loadable state;
            # the direct-latest path above loads legacy saves the same way
            fallback = next(
                (t for t in list_tags(save_dir) if t not in exclude and
                 verify_checkpoint(save_dir, t)[0] == "legacy"), None)
            if fallback is not None:
                logger.info(f"[checkpoint] fallback {fallback!r} has no "
                            f"manifest (pre-manifest save); loading "
                            f"unverified")
        if fallback is not None:
            logger.error(f"[checkpoint] RESUMING FROM FALLBACK {fallback!r} "
                         f"(latest={candidate!r} was unusable)")
            return fallback
    raise CheckpointCorruptionError(
        f"no loadable checkpoint in {save_dir}: latest={candidate!r} "
        f"failed verification and no earlier save verifies")


# ---------------------------------------------------------------------------
# Retention
# ---------------------------------------------------------------------------


def remove_save(save_dir: str, tag: str) -> None:
    shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
    for suffix in SIDECAR_SUFFIXES + (MANIFEST_SUFFIX,):
        try:
            os.remove(os.path.join(save_dir, f"{tag}{suffix}"))
        except OSError:
            pass


def prune_checkpoints(save_dir: str, keep: int) -> List[str]:
    """Delete saves beyond the newest ``keep``, but NEVER the newest
    *verified* save — when every newer save is partial/corrupt, that one is
    the job's only way back. Returns the removed tags."""
    tags = list_tags(save_dir)
    protected = last_verified_tag(save_dir)
    removed = []
    for tag in tags[max(keep, 1):]:
        if tag == protected:
            continue
        remove_save(save_dir, tag)
        removed.append(tag)
    return removed


# ---------------------------------------------------------------------------
# fsck (ds_report / ds_elastic checkpoint-verify mode)
# ---------------------------------------------------------------------------


def fsck(save_dir: str) -> Dict[str, Any]:
    """Validate every save in a checkpoint dir. Returns
    ``{"saves": [{tag, step, status, detail}...], "latest": tag_or_None,
    "latest_status": ..., "last_good": tag_or_None}``."""
    saves = []
    for tag in list_tags(save_dir):
        status, detail = verify_checkpoint(save_dir, tag)
        saves.append({"tag": tag, "step": tag_step(save_dir, tag),
                      "status": status, "detail": detail})
    latest = read_latest_tag(save_dir)
    latest_status = verify_checkpoint(save_dir, latest)[0] if latest else None
    return {"saves": saves, "latest": latest, "latest_status": latest_status,
            "last_good": last_verified_tag(save_dir)}
