"""Device-side run counts of the kernels.

Each counted kernel takes an int32 ``[1]`` on its device and adds one to
it when it runs, so the replays of a captured CUDA graph count and the
capture itself does not. A wrapper's Python ``.launches`` counter ticks
where the wrapper runs, which for a captured graph is once, at capture.
The counters are named after the wrappers (``"flash_attention_fwd"``,
``"paged_decode_attention"``, ...); nothing here runs at import time.
"""

from typing import Dict, Tuple

import torch

_RUNS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def counter(name: str, dev: torch.device) -> torch.Tensor:
    """The int32 ``[1]`` that ``name``'s kernel adds one to on ``dev`` (an
    indexed CUDA device). It is allocated at the first eager launch: a
    capture would record its zero fill and reset it at every replay, so a
    first launch under capture raises. It is never an inference tensor,
    even when that launch runs under ``torch.inference_mode()`` (a serving
    step), so :func:`reset_kernel_runs` may zero it outside one."""
    runs = _RUNS.get((name, dev))
    if runs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: launch the kernel once before "
                               f"capturing it in a CUDA graph (its run "
                               f"counter is allocated then)")
        with torch.inference_mode(False):
            runs = _RUNS[(name, dev)] = torch.zeros(1, dtype=torch.int32,
                                                    device=dev)
    return runs


def _indexed(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", torch.cuda.current_device())


def kernel_runs(name: str, device="cuda") -> int:
    """The runs of ``name``'s kernel on ``device`` since
    :func:`reset_kernel_runs` (0 before its first launch). Waits for the
    device."""
    runs = _RUNS.get((name, _indexed(device)))
    return 0 if runs is None else int(runs.item())


def reset_kernel_runs(name: str, device="cuda") -> None:
    """Set :func:`kernel_runs` of ``name`` to 0 on ``device`` (allocating
    the counter, so a capture that follows may hold the first launch)."""
    counter(name, _indexed(device)).zero_()
