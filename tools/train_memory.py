"""Where a training step's device memory goes, per remat policy and loss.

    python3 tools/train_memory.py [--micro 8] [--seq 1024] [--gas 1]

Full-width Llama-400M (random weights from seed 0), bf16, at the bench
config. For each route (remat policy, loss chunk) on a fresh engine,
uncaptured: the bytes allocated after the engine is built (masters,
gradient buffers, Adam moments), after the bound bf16 weights and one
micro-batch's forward (the loss and what the forward keeps for the
backward), the peak of that micro-batch's backward, and the peak of one
whole ``train_batch`` step; then the same route captured: the peak over
its first step (eager, then captured) and a replay. Prints one JSON line
per route and writes them all to ``chiprun_out/train_memory.json``.
"""

import argparse
import gc
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROUTES = (("nothing", 0), ("dots", 0), ("dots_no_batch", 0),
          ("nothing", 2048), ("dots", 2048), ("offload_dots_no_batch", 2048))


def gb(n):
    return round(n / 1e9, 4)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_memory: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--gas", type=int, default=1)
    args = ap.parse_args()
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 32000, (args.micro * args.gas, args.seq)))
    batch = {"input_ids": ids, "labels": ids}
    config = {"train_batch_size": args.micro * args.gas,
              "gradient_accumulation_steps": args.gas,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-4, "weight_decay": 0.1}},
              "bf16": {"enabled": True}, "gradient_clipping": 1.0,
              "steps_per_print": 0, "seed": 0}
    rows = []
    for policy, chunk in ROUTES:
        row = {"policy": policy, "loss_chunk": chunk}
        for graphed in (False, True):
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            cfg = LlamaConfig.llama_400m(max_position_embeddings=args.seq,
                                         remat=True, remat_policy=policy,
                                         loss_chunk=chunk)
            # the engine alone: the optimizer returned beside it would
            # outlive it into the next route's measurement
            engine = dt.initialize(model=LlamaForCausalLM(cfg),
                                   config=dict(config), device="cuda",
                                   cuda_graph=graphed)[0]
            state = torch.cuda.memory_allocated() - base
            if not graphed:
                mb = {k: v[:args.micro].cuda() for k, v in batch.items()}
                torch.cuda.reset_peak_memory_stats()
                loss = engine._loss(mb).float()
                row["after_forward"] = gb(torch.cuda.memory_allocated()
                                          - base - state)
                row["forward_peak"] = gb(torch.cuda.max_memory_allocated()
                                         - base - state)
                torch.cuda.reset_peak_memory_stats()
                loss.backward()
                row["backward_peak"] = gb(torch.cuda.max_memory_allocated()
                                          - base - state)
                del loss, mb
                with torch.no_grad():
                    engine._bind_params()
                torch._foreach_zero_(engine._grads)
                torch.cuda.reset_peak_memory_stats()
            engine.train_batch(batch=batch)
            engine.train_batch(batch=batch)
            torch.cuda.synchronize()
            key = "captured" if graphed else "uncaptured"
            row["state"] = gb(state)
            row[f"{key}_step_peak"] = gb(torch.cuda.max_memory_allocated()
                                         - base)
            del engine
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "train_memory.json"), "w") as f:
        json.dump({"micro": args.micro, "seq": args.seq, "gas": args.gas,
                   "routes": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
