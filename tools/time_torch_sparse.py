"""Time the port's K9 block-sparse kernels, and K1/K2 beside them, on one
CUDA card, for one checkout of the port.

    python3 tools/time_torch_sparse.py [--root DIR] [--cases a,b] [--reps N]

Imports ``deepspeed_tpu_torch`` from ``--root`` (default: this checkout)
and builds its kernels there. Times with ``chip_smoke.cuda_time_ms`` (CUDA
events, the L2 cache flushed before each run, the median of ``--reps``):
K9 fwd, dq and dkv at ``chip_smoke.SPARSE_CASES`` (all by default; the
inputs of each case come from a seed, as in ``chip_smoke.py``), then K1
and K2 at ``chip_smoke.FLASH_CASES``' ``train_bf16`` and ``d128``. Also
times the host work of one ``sparse_attention`` call before its first
launch at each K9 case: the causal cut of the layout and the lookup of its
lists (``_causal_layout`` + ``_indices``, a cache hit). Prints one JSON
line per case, with the tree, the card's name and its power limit.

To compare two trees on one card, run it once per tree in turns in one
command (parent, change, change, parent): each case gets the same inputs
in every run.
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH = ("train_bf16", "d128")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layout_of(bsa, cs, name, Hh, block, T, causal):
    """The case's causally cut layout as the tree's ``sparse_attention``
    holds it (read-only and cached where the tree does so)."""
    cfg = cs.sparse_config(name, Hh, block)
    if hasattr(bsa, "_cut"):
        return bsa._cut(bsa._config_layout(cfg, T), causal)
    return bsa._causal_layout(cfg.make_layout(T), causal)


def lists(bsa, layout, causal, block):
    """``bsa._indices`` of either signature (the block joined it when the
    strips came)."""
    extra = (block,) if "block" in inspect.signature(
        bsa._indices).parameters else ()
    return bsa._indices(layout, causal, "cuda", *extra)


def host_ms(bsa, cs, case, reps=50):
    """Median host ms of the per-call work before the first launch."""
    B, T, Hh, Dh, dtype, block, name, causal = case
    times = []
    for _ in range(reps + 1):
        t = time.perf_counter()
        lists(bsa, layout_of(bsa, cs, name, Hh, block, T, causal), causal,
              block)
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times[1:])


def digest(tensors):
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_sparse(cs, bsa, cases, reps):
    for i, (case, (B, T, Hh, Dh, dtype, block, name, causal)) in \
            enumerate(cs.SPARSE_CASES.items()):
        if case not in cases:
            continue
        g = torch.Generator(device="cuda").manual_seed(i + 91)
        q, k, v, do = (torch.randn(B, T, Hh, Dh, generator=g, device="cuda",
                                   dtype=dtype) for _ in range(4))
        layout = layout_of(bsa, cs, name, Hh, block, T, causal)
        args = (layout, block, causal)
        out, lse = bsa.block_sparse_attention_fwd(q, k, v, *args)
        delta = bsa._delta(out, do)
        dq = bsa.block_sparse_attention_bwd_dq(q, k, v, out, lse, do, *args,
                                               delta=delta)
        dk, dv = bsa.block_sparse_attention_bwd_dkv(q, k, v, out, lse, do,
                                                    *args, delta=delta)
        rec = {"tree": ROOT_ARG, "case": case, "ms": {
            "fwd": cs.cuda_time_ms(
                lambda: bsa.block_sparse_attention_fwd(q, k, v, *args),
                reps=reps),
            "dq": cs.cuda_time_ms(lambda: bsa.block_sparse_attention_bwd_dq(
                q, k, v, out, lse, do, *args, delta=delta), reps=reps),
            "dkv": cs.cuda_time_ms(
                lambda: bsa.block_sparse_attention_bwd_dkv(
                    q, k, v, out, lse, do, *args, delta=delta), reps=reps)},
            "host_ms": host_ms(bsa, cs, cs.SPARSE_CASES[case]),
            "digest": digest((out, lse, dq, dk, dv))}
        print(json.dumps(rec), flush=True)
        del q, k, v, do, out, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()


def time_flash(cs, fa, reps):
    for case in FLASH:
        B, H, Tq, Tk, D, dtype, causal, window = cs.FLASH_CASES[case]
        g = torch.Generator(device="cuda").manual_seed(7)
        q, do = (torch.randn(B, Tq, H, D, generator=g, device="cuda",
                             dtype=dtype) for _ in range(2))
        k, v = (torch.randn(B, Tk, H, D, generator=g, device="cuda",
                            dtype=dtype) for _ in range(2))
        kw = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = fa._delta(out, do)
        rec = {"tree": ROOT_ARG, "case": f"flash_{case}", "ms": {
            "fwd": cs.cuda_time_ms(
                lambda: fa.flash_attention_fwd(q, k, v, **kw), reps=reps),
            "dq": cs.cuda_time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, out, lse, do, delta=delta, **kw), reps=reps),
            "dkv": cs.cuda_time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, out, lse, do, delta=delta, **kw), reps=reps)}}
        print(json.dumps(rec), flush=True)


def main() -> int:
    global ROOT_ARG
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--cases", default=None,
                    help="comma-separated SPARSE_CASES names (default all)")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_sparse: no CUDA device", file=sys.stderr)
        return 1
    ROOT_ARG = os.path.relpath(os.path.abspath(args.root), ROOT)
    sys.path.insert(0, os.path.abspath(args.root))
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa

    assert bsa.__file__.startswith(os.path.abspath(args.root))
    cs = _chip_smoke()
    print(f"device: {cs.nvidia_smi()} | {torch.cuda.get_device_name(0)} | "
          f"tree {ROOT_ARG}", flush=True)
    _build.build([n for n in ("block_sparse_attention",
                              "block_sparse_strips", "flash_attention")
                  if n in _build.sources()])
    cases = set(cs.SPARSE_CASES) if args.cases is None \
        else set(args.cases.split(","))
    time_sparse(cs, bsa, cases, args.reps)
    time_flash(cs, fa, args.reps)
    return 0


ROOT_ARG = "."

if __name__ == "__main__":
    sys.exit(main())
