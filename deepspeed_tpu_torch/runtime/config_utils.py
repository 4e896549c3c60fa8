"""Config plumbing shared by every config block.

Counterpart of ``deepspeed_tpu/runtime/config_utils.py``: the ``"auto"``
sentinel, duplicate-key rejection for JSON files, and a small dataclass
base. The JAX package builds its blocks on pydantic, which the port does
not use; here a block is a dataclass whose ``from_dict`` drops ``"auto"``
values (so defaults apply) and rejects keys it does not know.
"""

import dataclasses
from typing import Any, Dict, Optional

AUTO = "auto"


def unported(what: str, entry: str) -> NotImplementedError:
    """The error for a config option this slice does not implement;
    ``entry`` names the ROADMAP.md Queue 1 item that brings it."""
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with {entry} "
        f"(ROADMAP.md Queue 1)")


def auto_none(v):
    """``None`` for a missing or ``"auto"`` value."""
    return None if (v is None or v == AUTO) else v


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """``object_pairs_hook`` that rejects duplicate keys in the JSON."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter: Dict[Any, int] = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d


class ConfigBlock:
    """Base of the port's config dataclasses."""

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]], name: str = ""):
        """Build from a config dict: ``"auto"`` values fall back to the
        defaults, unknown keys raise ``ValueError``."""
        data = {k: v for k, v in (data or {}).items()
                if not (isinstance(v, str) and v == AUTO)}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(f"{name or cls.__name__}: unknown keys "
                             f"{unknown}; known: {sorted(known)}")
        return cls(**data)
