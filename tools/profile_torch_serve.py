"""Where the port's serving step spends its time on a GPU.

    python3 tools/profile_torch_serve.py [--layers 32]

Builds the serving configuration of ``chip_smoke.py`` (Llama-3-8B at
full width, random bf16 weights from a seed, 8 slots, 16-token pages,
a 256-token prefill budget), warms it with a short run, then serves 8
requests of 1024-token prompts and 48 new tokens under
``torch.profiler`` in two windows: the steps that carry prefill chunks,
and the decode-only steps after them. For each window it prints the
device time per kernel class (the ragged attention kernel, matrix
products, everything else), the steps, the host wall time, and the
device's idle share (1 - union of kernel intervals / window wall time,
profiler overhead included). Writes the summary to
``chiprun_out/serve_profile.json``; needs a CUDA device.
"""

import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CLASSES = (("ragged_attention", re.compile(r"ragged_kernel")),
           ("matmul", re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas",
                                 re.I)))


def _kernel_summary(trace_path, wall_s):
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel" and "dur" in e]
    by_class = {name: 0.0 for name, _ in CLASSES}
    by_class["other"] = 0.0
    top = {}
    for e in events:
        cls = next((n for n, rx in CLASSES if rx.search(e["name"])), "other")
        by_class[cls] += e["dur"] / 1e3
        top[e["name"][:80]] = top.get(e["name"][:80], 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return {"kernel_ms": by_class, "device_busy_ms": busy / 1e3,
            "wall_ms": wall_s * 1e3,
            "idle_share": 1.0 - busy / 1e3 / (wall_s * 1e3),
            "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                   [:8])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from deepspeed_tpu_torch.models import LlamaConfig
    from torch.profiler import ProfilerActivity, profile

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=args.layers)
    scfg = dict(max_batch_size=8, block_size=16, num_blocks=1024,
                max_model_len=2048, prefill_token_budget=256)
    srv, *_ = chip_smoke.serve(cfg, 0, 4, (64, 300), (4, 8), scfg,
                               torch.bfloat16)
    rs = np.random.RandomState(1)
    for _ in range(8):
        srv.submit(rs.randint(0, cfg.vocab_size, 1024), max_new_tokens=48)
    out = {"device": chip_smoke.nvidia_smi(), "layers": args.layers,
           "windows": {}}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    trace = os.path.join(ROOT, "chiprun_out", "serve_trace.json")
    for window in ("prefill", "decode"):
        def busy():
            prefilling = any(r.prefilling for _, r in srv.sched.active()) \
                or srv.sched.queue_depth > 0
            return prefilling if window == "prefill" else srv.has_work()

        steps = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while busy():
                srv.step()
                steps += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(trace)
        summary = _kernel_summary(trace, wall)
        os.remove(trace)
        summary["steps"] = steps
        summary["ms_per_step"] = wall * 1e3 / max(steps, 1)
        out["windows"][window] = summary
        print(f"{window}: {json.dumps(summary)}", flush=True)
    srv.block_pool.check_consistent()
    assert srv.block_pool.used_count == 0
    with open(os.path.join(ROOT, "chiprun_out", "serve_profile.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(out["device"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
