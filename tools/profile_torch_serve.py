"""Where the port's serving step spends its time on a GPU.

    python3 tools/profile_torch_serve.py [--model llama3_8b|gpt2_125m]
        [--layers N] [--legacy] [--graph]

Builds the serving configuration of ``chip_smoke.py`` (Llama-3-8B, or
GPT-2 125M with ``--model gpt2_125m``, at full width and full depth
unless ``--layers`` cuts it, random bf16 weights from a seed, 8 slots,
16-token pages, a 256-token prefill budget), warms it with a short run,
then serves 8 requests of 1024-token prompts (960 on GPT-2, whose 1024
positions bound prompt and new tokens together) and 48 new tokens under
``torch.profiler`` in two windows: the steps that carry prefill chunks,
and the decode-only steps after them. For each window it prints the
device time per kernel class (the attention kernels, each its own class,
matrix products, everything else) in all and a step, the steps, the
forwards, the host wall
time, and the device's idle share (1 - union of kernel intervals / window
wall time, profiler overhead included). With ``--legacy`` the engine is
the two-program one (``mixed_step=False``, 64-token chunks under the same
budget): its prefill window runs the paged chunked-prefill kernel and its
decode window the paged decode kernel, on the same traffic. With
``--graph`` the unified engine runs with ``enable_cuda_graph`` and
``mixed_step_buckets`` (one CUDA graph per packed width), and the
two-program engine (``--legacy --graph``) with ``enable_cuda_graph`` (its
decode and chunk forwards one CUDA graph each), warmed with the profiled
traffic itself, so every shape it runs is captured before the windows,
which then replay them. Writes the summary to
``chiprun_out/serve_profile.json`` (``serve_profile_legacy.json`` with
``--legacy``, ``serve_profile_graph.json`` with ``--graph``,
``serve_profile_legacy_graph.json`` with both; ``_gpt2_125m`` before
``.json`` for GPT-2); needs a CUDA device.
"""

import argparse
import json
from collections import Counter
import os
import re
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# K6 launches ragged_plan_kernel, ragged_walk_kernel and merge_kernel;
# K7a paged_decode_kernel and merge_kernel; K7b paged_prefill_kernel and
# merge_kernel. A merge_kernel joins the class of the kernel launched just
# before it on the stream (its walk, in the same C call).
CLASSES = (("ragged_attention", re.compile(r"ragged_\w*kernel")),
           ("paged_decode_attention", re.compile(r"paged_decode_kernel")),
           ("paged_prefill_attention", re.compile(r"paged_prefill_kernel")),
           ("matmul", re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas",
                                 re.I)))
MERGE = re.compile(r"\bmerge_kernel")
MODELS = ("llama3_8b", "gpt2_125m")


def model_of(name, layers=None):
    """The port model (a definition on the ``meta`` device) of the
    configuration ``name`` in :data:`MODELS`, at ``layers`` layers or its
    full depth."""
    from deepspeed_tpu_torch.models import (GPT2Config, GPT2LMHeadModel,
                                            LlamaConfig, LlamaForCausalLM)

    if name == "gpt2_125m":
        over = {} if layers is None else {"n_layer": layers}
        return GPT2LMHeadModel(GPT2Config.gpt2_125m(**over))
    over = {} if layers is None else {"num_hidden_layers": layers}
    return LlamaForCausalLM(LlamaConfig.llama3_8b(**over))


def _kernel_summary(trace_path, wall_s, classes=CLASSES):
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel" and "dur" in e]
    events.sort(key=lambda e: e["ts"])
    by_class = {name: 0.0 for name, _ in classes}
    by_class["other"] = 0.0
    top = {}
    cls = "other"
    for e in events:
        if not MERGE.search(e["name"]):
            cls = next((n for n, rx in classes if rx.search(e["name"])),
                       "other")
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
    ap.add_argument("--model", default="llama3_8b", choices=MODELS)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the model's own)")
    ap.add_argument("--legacy", action="store_true",
                    help="profile the two-program engine (mixed_step=False)")
    ap.add_argument("--graph", action="store_true",
                    help="the steps as CUDA graphs (the unified one at "
                    "bucketed widths)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import deepspeed_tpu_torch as dt
    from torch.profiler import ProfilerActivity, profile

    model = model_of(args.model, args.layers)
    vocab = model.config.vocab_size
    limit = model.max_positions or 2048
    prompt_len = min(1024, limit - 64)
    scfg = dict(max_batch_size=8, block_size=16, num_blocks=1024,
                max_model_len=min(2048, limit), prefill_token_budget=256)
    if args.legacy:
        scfg.update(mixed_step=False, prefill_chunk_tokens=64)
    ekw = {}
    if args.graph:
        ekw, skw = chip_smoke.SERVE_GRAPH
        if not args.legacy:
            scfg.update(skw, trace=True)
    engine = dt.init_inference(
        model, params=model.init_params(seed=0, dtype=torch.bfloat16,
                                        device="cuda"),
        dtype=torch.bfloat16, **ekw)
    srv = dt.ServingEngine(engine, dt.ServingConfig(**scfg))
    chip_smoke.serve(None, 0, 0, None, None, scfg, torch.bfloat16, srv=srv,
                     phases=[chip_smoke.seeded_traffic(vocab, 0, 4, (64, 300),
                                                       (4, 8))])

    def traffic():
        rs = np.random.RandomState(1)
        for _ in range(8):
            srv.submit(rs.randint(0, vocab, prompt_len), max_new_tokens=48)

    if args.graph:
        traffic()
        srv.run()
    traffic()
    out = {"device": chip_smoke.nvidia_smi(), "model": args.model,
           "layers": args.layers, "prompt_tokens": prompt_len,
           "engine": ("two-program" if args.legacy else "unified")
           + (", CUDA graphs" if args.graph else "")
           + (" at bucketed widths" if args.graph and not args.legacy
              else ""), "windows": {}}
    if args.graph:
        out["graphs_before_windows"] = len(srv._graphs)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    trace = os.path.join(ROOT, "chiprun_out", "serve_trace.json")
    for window in ("prefill", "decode"):
        def busy():
            prefilling = any(r.prefilling for _, r in srv.sched.active()) \
                or srv.sched.queue_depth > 0
            return prefilling if window == "prefill" else srv.has_work()

        steps = 0
        forwards = srv.decode_calls + srv.prefill_chunk_calls
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
        summary["kernel_ms_per_step"] = {
            name: ms / max(steps, 1)
            for name, ms in summary["kernel_ms"].items()}
        # forwards of the model: one per step on the unified engine
        summary["forwards"] = srv.decode_calls + srv.prefill_chunk_calls \
            - forwards if args.legacy else steps
        summary["ms_per_step"] = wall * 1e3 / max(steps, 1)
        if args.graph:
            summary["graphs"] = len(srv._graphs)
        if args.graph and not args.legacy:
            run = chip_smoke.step_widths(srv)
            summary["steps_at_width"] = {
                str(w): n for w, n in sorted(Counter(
                    run[len(run) - steps:]).items())}
        out["windows"][window] = summary
        print(f"{window}: {json.dumps(summary)}", flush=True)
    srv.block_pool.check_consistent()
    assert srv.block_pool.used_count == 0
    name = "serve_profile" + ("_legacy" if args.legacy else "") + \
        ("_graph" if args.graph else "") + \
        ("" if args.model == "llama3_8b" else "_" + args.model) + ".json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)
    print(out["device"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
