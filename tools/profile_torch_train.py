"""Where the port's training step spends its time on a GPU.

    python3 tools/profile_torch_train.py [--layers 24] [--steps 3] [--graph]

Builds the training configuration of ``chip_smoke.py`` (Llama-400M at
full width, random weights from seed 0, the JAX package's bench config:
batch 8 x 1024, AdamW, bf16, clipping 1.0, remat), warms it with 2 steps,
then runs ``--steps`` steps under ``torch.profiler``. Prints the device
time per step by kernel class (K1 flash forward, K2 flash backward, K3
fused Adam, matrix products, everything else), the host wall time per
step and the device's idle share (1 - union of kernel intervals / window
wall time, profiler overhead included), then times the same number of
steps without the profiler. Also counts, per step, the kernels launched
and the host's CUDA runtime calls by name (launches, copies,
synchronizations): with the device idle most of a step, they say what
the host spends the step on. The step runs uncaptured
(``cuda_graph=False``), or with ``--graph`` as the engine's default, one
replayed CUDA graph a step (its warm-up steps capture it). Writes the
summary to ``chiprun_out/train_profile.json`` (``train_profile_graph.json``
with ``--graph``); needs a CUDA device.
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

from profile_torch_serve import _kernel_summary  # noqa: E402

CLASSES = (("flash_fwd (K1)", re.compile(r"fwd_kernel")),
           ("flash_bwd (K2)", re.compile(r"dq_kernel|dkv_kernel")),
           ("fused_adam (K3)", re.compile(r"adam_kernel")),
           ("matmul", re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas",
                                 re.I)))


def _host_calls(trace_path, steps):
    """Kernels launched and CUDA runtime calls (count and host ms, the 8
    largest by time) per step, from a chrome trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    calls = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            n, ms = calls.get(e["name"], (0, 0.0))
            calls[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    top = sorted(calls.items(), key=lambda kv: -kv[1][1])[:8]
    return {"kernels_per_step": kernels / steps,
            "runtime_calls_per_step": {
                name: {"count": n / steps, "host_ms": ms / steps}
                for name, (n, ms) in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--graph", action="store_true",
                    help="profile the captured step (one CUDA graph a step)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from deepspeed_tpu_torch.models import LlamaConfig
    from torch.profiler import ProfilerActivity, profile

    cfg = LlamaConfig.llama_400m(num_hidden_layers=args.layers,
                                 max_position_embeddings=chip_smoke.TRAIN_SEQ,
                                 remat=True)
    config = chip_smoke.TRAIN_CONFIG
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (config["train_batch_size"],
                            chip_smoke.TRAIN_SEQ)))
    engine, *_ = chip_smoke.train(cfg, config, ids, 0, 2,
                                  graphed=args.graph)
    batch = {"input_ids": ids, "labels": ids}
    out = {"device": chip_smoke.nvidia_smi(), "layers": args.layers,
           "steps": args.steps,
           "route": "captured" if args.graph else "uncaptured"}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    trace = os.path.join(ROOT, "chiprun_out", "train_trace.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace)
    summary = _kernel_summary(trace, wall, CLASSES)
    host = _host_calls(trace, args.steps)
    os.remove(trace)
    per_step = {k: v / args.steps for k, v in summary["kernel_ms"].items()}
    out["profiled"] = dict(summary, kernel_ms_per_step=per_step,
                           ms_per_step=wall * 1e3 / args.steps, **host)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        engine.train_batch(batch=batch)
    torch.cuda.synchronize()
    out["unprofiled_ms_per_step"] = (time.perf_counter() - t0) * 1e3 \
        / args.steps
    print(json.dumps(out), flush=True)
    name = "train_profile_graph.json" if args.graph else "train_profile.json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)
    print(out["device"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
