"""Reconstruct a full fp32 state dict from a training checkpoint.

Counterpart of ``deepspeed_tpu/utils/zero_to_fp32.py`` (reference
``deepspeed/utils/zero_to_fp32.py``: :153 ``get_fp32_state_dict_from_zero
_checkpoint``, :360 CLI). A save of the port is a universal directory a tag
(``checkpoint/engine.py``) whose ``params/...`` leaves are the fp32
masters, whole: consolidation is reading them. The flat names are the JAX
package's (``model/layers/block/self_attn/q_proj/kernel``, stacked
``[L, in, out]`` with scanned layers), so the output equals the JAX
package's on the same weights; ``checkpoint.from_flax`` maps them to the
port's ``state_dict``.

CLI: ``python -m deepspeed_tpu_torch.utils.zero_to_fp32 <ckpt_dir> <out.npz> [tag]``
"""

import os
import sys
from typing import Any, Dict, Optional

import numpy as np

PARAMS = "params/"


def _resolve_tag(checkpoint_dir: str, tag: Optional[str]) -> str:
    if tag is None:
        latest = os.path.join(checkpoint_dir, "latest")
        if not os.path.exists(latest):
            raise FileNotFoundError(f"no 'latest' file in {checkpoint_dir}; pass tag=")
        with open(latest) as f:
            tag = f.read().strip()
    return tag


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict[str, np.ndarray]:
    """→ flat ``{'path/to/param': fp32 ndarray}`` (reference :153)."""
    from ..checkpoint.universal import load_universal

    tag = _resolve_tag(checkpoint_dir, tag)
    flat, _ = load_universal(os.path.join(os.path.abspath(checkpoint_dir),
                                          tag))
    return {n[len(PARAMS):]: np.asarray(flat[n], np.float32) for n in flat
            if n.startswith(PARAMS)}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag: Optional[str] = None) -> None:
    """Reference :287: write the consolidated fp32 dict to one file (.npz)."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    np.savez(output_file, **sd)
    total = sum(v.size for v in sd.values())
    print(f"wrote {len(sd)} tensors / {total:,} params to {output_file}")


def load_state_dict_from_zero_checkpoint(model_params: Any, checkpoint_dir: str,
                                         tag: Optional[str] = None) -> Any:
    """Populate a flax params template (nested dicts of arrays, as
    :func:`~deepspeed_tpu_torch.checkpoint.from_flax.torch_to_flax` gives)
    with checkpoint fp32 values (reference :184
    ``load_state_dict_from_zero_checkpoint``); each leaf keeps the
    template's dtype."""
    flat = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)

    def fill(tree, prefix):
        if isinstance(tree, dict):
            return {k: fill(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        if prefix not in flat:
            raise KeyError(f"checkpoint missing param {prefix}")
        src = flat[prefix]
        if tuple(src.shape) != tuple(np.shape(tree)):
            raise ValueError(f"shape mismatch for {prefix}: ckpt {src.shape} "
                             f"vs model {np.shape(tree)}")
        return src.astype(np.asarray(tree).dtype)

    return fill(model_params, "")


def main():
    if len(sys.argv) < 3:
        print(__doc__)
        sys.exit(1)
    convert_zero_checkpoint_to_fp32_state_dict(
        sys.argv[1], sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else None)


if __name__ == "__main__":
    main()
