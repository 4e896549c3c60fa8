"""Time the host side of K9's path for one checkout of the port: building
a layout's active lists and work lists, and finding them again on a call.

    python3 tools/time_sparse_lists.py [--root DIR] [--reps N]

Imports ``deepspeed_tpu_torch`` from ``--root`` (default: this checkout)
and runs on the CPU (the lists are built on the host; here they stay
there). For each case of this checkout's ``chip_smoke.SPARSE_CASES``, and
for two cases at a block of 16 and T 16384 (32 heads x 1024 block rows):

- ``build_ms``: the first ``_indices`` of the causally cut layout, rows'
  and columns' lists and work lists (the median of ``--reps`` builds,
  each on an emptied cache);
- ``lookup_ms``: what each K9 call repeats before its launch, the causal
  cut of the config's layout and the lookup of its lists (a cache hit;
  by the array's identity where the tree keeps its layouts read-only).

The layout itself (``make_layout``) is made once per case and not timed.
Prints one JSON line per case with the tree. To compare two trees, run it
once per tree on the same machine.
"""

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def median_ms(fn, reps):
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    assert bsa.__file__.startswith(os.path.abspath(args.root))
    tree = os.path.relpath(os.path.abspath(args.root), ROOT)
    cs = _chip_smoke()
    cases = {n: (c[1], c[2], c[5], c[6], c[7])
             for n, c in cs.SPARSE_CASES.items()}
    cases["fixed_ds_block16_t16384"] = (16384, 32, 16, "fixed_ds", False)
    cases["bigbird_block16_t16384"] = (16384, 32, 16, "bigbird", True)
    with_block = "block" in inspect.signature(bsa._indices).parameters
    own = hasattr(bsa, "_cut")
    for case, (T, Hh, block, name, causal) in cases.items():
        cfg = cs.sparse_config(name, Hh, block)
        if own:      # sparse_attention's own read-only layouts
            bsa._layout_cache.clear()
            bsa._cut_cache.clear()
            raw = bsa._config_layout(cfg, T)
        else:
            raw = cfg.make_layout(T)
        extra = (block,) if with_block else ()

        def cut():
            return bsa._cut(raw, causal) if own \
                else bsa._causal_layout(raw, causal)

        def build():
            bsa._indices_cache.clear()
            bsa._indices(cut(), causal, "cpu", *extra)

        build_ms = median_ms(build, args.reps)
        lookup_ms = median_ms(
            lambda: bsa._indices(cut(), causal, "cpu", *extra),
            10 * args.reps)
        print(json.dumps({"tree": tree, "case": case, "T": T, "heads": Hh,
                          "block": block, "layout": name, "causal": causal,
                          "block_rows": Hh * (T // block),
                          "build_ms": build_ms, "lookup_ms": lookup_ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
