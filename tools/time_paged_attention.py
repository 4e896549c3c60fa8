"""Time the port's paged attention kernels on one CUDA card, for one
checkout of the port: K6 (unified ragged paged attention), K7a (paged
decode) and K7b (paged chunked prefill).

    python3 tools/time_paged_attention.py [--root DIR] [--reps N] [--kernels]
        [--match REGEX]

Imports ``deepspeed_tpu_torch`` and ``chip_smoke.py`` from ``--root``
(default: this checkout), builds the tree's kernels there, and times with
its ``chip_smoke.cuda_time_ms`` (CUDA events, the L2 cache flushed before
each run, the median of ``--reps``): K6 at every ``RAGGED_CASES`` case of
that tree's ``chip_smoke.py`` with a bf16 pool, an int8 pool and a
256-token window, then K7a and K7b at every ``PAGED_CASES`` case (with its
page size where the case names one), each beside its bound
(``ragged_bound`` / ``paged_bound``). The inputs come
from the seeds ``chip_smoke.py`` uses, so every tree sees the same ones.
With ``--kernels`` each case also gets the device time of every kernel
its C call launches (K6: the item layout, the walk, the merge; K7a and
K7b: the walk, the merge), from ``torch.profiler`` over ``--reps`` calls
without the flush, in µs a call. ``--match`` times only the cases whose
name (``ragged_bf16/mixed``, ``paged_prefill/behind_prefix512``, ...)
the regular expression finds. Prints one JSON line per case, with the
tree, the card's name and its power limit.

To compare two trees on one card, run it once per tree in turns in one
command (parent, change, change, parent).
"""

import argparse
import importlib.util
import json
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke(root):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(tree, case, **fields):
    print(json.dumps({"tree": tree, "case": case, **fields}), flush=True)


def kernel_us(fn, reps):
    """``{kernel name: device µs a call}`` of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            name = re.findall(r"(\w+_kernel)", e.key)
            key = name[0] if name else e.key[:40]
            out[key] = out.get(key, 0.0) + us / reps
    return out


def time_ragged(cs, tree, reps, kernels, match):
    from deepspeed_tpu_torch.ops.ragged_attention import \
        ragged_paged_attention

    seed = 0
    for variant, (int8, window) in {"bf16": (False, None),
                                    "int8": (True, None),
                                    "window256": (False, 256)}.items():
        for name, rows in cs.RAGGED_CASES.items():
            seed += 1
            if not re.search(match, f"ragged_{variant}/{name}"):
                continue
            args, kw = cs.ragged_case(rows, int8, seed=seed)
            kw = dict(kw, window=window)
            ms = cs.cuda_time_ms(lambda: ragged_paged_attention(*args, **kw),
                                 reps=reps)
            bound, by = cs.ragged_bound(args, kw, window)
            extra = dict(kernel_us=kernel_us(
                lambda: ragged_paged_attention(*args, **kw), reps)) \
                if kernels else {}
            emit(tree, f"ragged_{variant}/{name}", ms=ms, bound_ms=bound,
                 bound_by=by, **extra)
            del args, kw


def time_paged(cs, tree, reps, kernels, match):
    from deepspeed_tpu_torch.ops import decode_attention as da

    for kind, cases in cs.PAGED_CASES.items():
        for i, (name, (T, Hq, Hkv, Dh, dtype, int8, window, rows, *bs)) in \
                enumerate(cases.items()):
            if not re.search(match, f"paged_{kind}/{name}"):
                continue
            # a case's optional page size (trees before pages of any size
            # have none)
            size = dict(bs=bs[0]) if bs else {}
            q, k, v, bt, cst, cl, scales = cs.paged_case(
                T, Hq, Hkv, Dh, dtype, int8, rows,
                seed=i + (61 if kind == "decode" else 71), **size)
            kw = dict(window=window, **scales)
            if kind == "decode":
                args = (q[:, 0].contiguous(), k, v, bt, cl)
                kernel = da.paged_decode_attention
            else:
                args = (q, k, v, bt, cst, cl)
                kernel = da.paged_prefill_attention
            ms = cs.cuda_time_ms(lambda: kernel(*args, **kw), reps=reps)
            bound, by = cs.paged_bound(T, Hq, Hkv, Dh, dtype, int8, window,
                                       rows, **size)
            extra = dict(kernel_us=kernel_us(lambda: kernel(*args, **kw),
                                             reps)) if kernels else {}
            emit(tree, f"paged_{kind}/{name}", ms=ms, bound_ms=bound,
                 bound_by=by, **extra)
            del q, k, v, args, scales


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--kernels", action="store_true",
                    help="add each case's device µs by kernel")
    ap.add_argument("--match", default="",
                    help="time only the cases this regex finds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_paged_attention: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    tree = os.path.relpath(root, ROOT)
    sys.path.insert(0, root)
    from deepspeed_tpu_torch.ops import _build

    assert _build.__file__.startswith(root)
    cs = _chip_smoke(root)
    print(f"device: {cs.nvidia_smi()} | {torch.cuda.get_device_name(0)} | "
          f"tree {tree}", flush=True)
    _build.build(["ragged_attention", "paged_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    time_ragged(cs, tree, args.reps, args.kernels, args.match)
    time_paged(cs, tree, args.reps, args.kernels, args.match)
    return 0


if __name__ == "__main__":
    sys.exit(main())
