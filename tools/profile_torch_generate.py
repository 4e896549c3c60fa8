"""Where the port's dense generate spends its time on a GPU.

    python3 tools/profile_torch_generate.py [--model llama3_8b|gpt2_125m]
        [--layers N] [--weights bf16 int8] [--graph]

Builds the generate configuration of ``chip_smoke.py`` (Llama-3-8B, or
GPT-2 125M with ``--model gpt2_125m``, at full width and full depth
unless ``--layers`` cuts it, random bf16 weights from seed 0, batch 8,
left-padded prompts of seeded lengths 128-512 bucketed to 512, greedy)
once per weight format, warms it, then runs under ``torch.profiler`` a
``generate`` of one new token (the prefill window: the prompt's forward
and the first sample) and one of 64 new tokens. The decode window is the
difference of the two (63 decode steps). For each window it prints the
device time per kernel class (K4 decode attention, K5 quantized matmul,
other matrix products, everything else), the host wall time, and the
device's idle share (1 - union of kernel intervals / window wall time,
profiler overhead included). With ``--graph`` the engine runs with
``enable_cuda_graph``, warmed with a 64-token generate that captures the
decode step, so the profiled one replays it. Writes the summary to
``chiprun_out/generate_profile.json`` (``generate_profile_graph.json``
with ``--graph``; ``_gpt2_125m`` before ``.json`` for GPT-2); needs a
CUDA device.
"""

import argparse
import gc
import json
import os
import re
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

# first match wins: K5's kernels before cuBLAS's gemm / gemv names
CLASSES = (("quant_matmul", re.compile(
               r"anonymous namespace\)::(wgmma_prefill|ragged|gemv_tc|"
               r"gemv_tf32|fp32_tc|finalize)_kernel")),
           ("decode_attention", re.compile(
               r"anonymous namespace\)::decode_(tc_split|split|merge)"
               r"_kernel")),
           ("matmul", re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas",
                                 re.I)))
NEW = 64


def _profiled(engine, ids, mask, new, trace):
    from profile_torch_serve import _kernel_summary
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(ids, attention_mask=mask, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace)
    summary = _kernel_summary(trace, wall, CLASSES)
    os.remove(trace)
    # the operators that launched the device time, by name
    ops = sorted(prof.key_averages(),
                 key=lambda e: -getattr(e, "self_device_time_total", 0))
    summary["top_ops_device_ms"] = {
        e.key: getattr(e, "self_device_time_total", 0) / 1e3
        for e in ops[:10]}
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama3_8b",
                    choices=("llama3_8b", "gpt2_125m"))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the model's own)")
    ap.add_argument("--weights", nargs="+", default=["bf16", "int8"],
                    choices=["bf16", "int8", "int4"])
    ap.add_argument("--graph", action="store_true",
                    help="the decode step as a captured CUDA graph")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_generate: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import deepspeed_tpu_torch as dt
    from profile_torch_serve import model_of

    torch.backends.cuda.matmul.allow_tf32 = False
    vocab = model_of(args.model, args.layers).config.vocab_size
    ids, mask = chip_smoke.left_padded_prompts(
        vocab, chip_smoke.GEN_B, 128, chip_smoke.GEN_PROMPT, 0)
    out = {"device": chip_smoke.nvidia_smi(), "model": args.model,
           "layers": args.layers,
           "batch": chip_smoke.GEN_B, "prompt_bucket": chip_smoke.GEN_PROMPT,
           "new_tokens": NEW, "enable_cuda_graph": args.graph, "runs": {}}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    trace = os.path.join(ROOT, "chiprun_out", "generate_trace.json")
    for weights in args.weights:
        model = model_of(args.model, args.layers)
        params = model.init_params(seed=0, dtype=torch.bfloat16,
                                   device="cuda")
        engine = dt.init_inference(
            model, params=params, dtype=torch.bfloat16,
            quantize_weights=None if weights == "bf16" else weights,
            enable_cuda_graph=args.graph)
        del params
        engine.generate(ids, attention_mask=mask,
                        max_new_tokens=NEW if args.graph else 4)  # warm
        prefill = _profiled(engine, ids, mask, 1, trace)
        full = _profiled(engine, ids, mask, NEW, trace)
        steps = NEW - 1
        decode = {
            "kernel_ms_per_step": {
                k: (full["kernel_ms"][k] - prefill["kernel_ms"][k]) / steps
                for k in full["kernel_ms"]},
            "device_busy_ms_per_step": (full["device_busy_ms"]
                                        - prefill["device_busy_ms"]) / steps,
            "wall_ms_per_step": (full["wall_ms"] - prefill["wall_ms"]) / steps,
        }
        decode["idle_share"] = 1.0 - decode["device_busy_ms_per_step"] \
            / decode["wall_ms_per_step"]
        out["runs"][weights] = {"prefill": prefill, "full": full,
                                "decode": decode}
        print(f"{weights} prefill: {json.dumps(prefill)}", flush=True)
        print(f"{weights} decode (per step): {json.dumps(decode)}",
              flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    name = "generate_profile" + ("_graph" if args.graph else "") + \
        ("" if args.model == "llama3_8b" else "_" + args.model) + ".json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)
    print(out["device"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
