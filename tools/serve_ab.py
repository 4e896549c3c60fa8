"""Captured serving step time of two trees of the port, in turns, on one GPU.

    python3 tools/serve_ab.py BASE_TREE CHANGE_TREE [--runs 3] [--layers 32]

Each tree is a checkout of this repository (for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists). The trees run in turns (base, change, change, base), each turn in
a process of its own that imports ``deepspeed_tpu_torch`` from its tree
and builds that tree's kernels. A turn serves the traffic of
``chip_smoke.py``'s serve phases on Llama-3-8B at full width (random bf16
weights from seed 0; ``--layers`` cuts the depth): 16 seeded requests of
64-1536-token prompts and 32-64 new tokens, greedy, on the unified engine
(8 slots, 16-token pages, a 256-token prefill budget) and on the
two-program engine (64-token chunks under the same budget), both with
``enable_cuda_graph`` and every other knob at its default (no watchdog,
no trace). Each engine serves the traffic once to capture its graphs,
then ``--runs`` times timed; a run's mean step is its wall time over its
steps. Then the engine's host work alone: ``--runs`` more runs with its
forwards replaced by an int32 zero tensor of the forward's output size on
the card (every token 0, no flag; the read-back is the engine's own), so
a run's mean step is what the host spends a step around the device work.
Prints each turn's mean steps, the change / base ratio of the means for
each engine, and whether every run of both trees gave the same tokens;
writes it all to ``chiprun_out/serve_ab.json``. Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the engines: the unified step and the two-program engine
ENGINES = {
    "unified": dict(max_batch_size=8, block_size=16, num_blocks=1024,
                    max_model_len=2048, prefill_token_budget=256),
    "two_program": dict(max_batch_size=8, block_size=16, num_blocks=1024,
                        max_model_len=2048, mixed_step=False,
                        prefill_chunk_tokens=64, prefill_token_budget=256),
}


def seeded_traffic(vocab, seed=0, n=16, prompt_range=(64, 1536),
                   new_range=(32, 64)):
    """``chip_smoke.py``'s seeded traffic: ``n`` ``(prompt,
    max_new_tokens)`` requests, lengths uniform in the inclusive ranges."""
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab, int(rs.randint(prompt_range[0],
                                                 prompt_range[1] + 1))),
             int(rs.randint(new_range[0], new_range[1] + 1)))
            for _ in range(n)]


def child(tree, layers, runs, out):
    """One turn: both engines of ``tree``, warmed, then ``runs`` timed
    runs each; writes their mean steps (ms) and tokens to ``out``."""
    sys.path.insert(0, tree)
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    here = os.path.dirname(os.path.abspath(dt.__file__))
    if os.path.dirname(here) != os.path.abspath(tree):
        raise RuntimeError(f"imported {here}, not the tree {tree}")
    cfg = LlamaConfig.llama3_8b(**({"num_hidden_layers": layers}
                                   if layers else {}))
    params = LlamaForCausalLM(cfg).init_params(seed=0, dtype=torch.bfloat16,
                                               device="cuda")
    traffic = seeded_traffic(cfg.vocab_size)
    res = {}
    for name, scfg in ENGINES.items():
        eng = dt.init_inference(LlamaForCausalLM(cfg), params=params,
                                dtype=torch.bfloat16, device="cuda",
                                enable_cuda_graph=True)
        srv = dt.ServingEngine(eng, dt.ServingConfig(**scfg))
        steps_ms, tokens = [], []
        for run in range(runs + 1):
            torch.cuda.synchronize()
            steps0 = srv.metrics.steps
            t0 = time.perf_counter()
            rids = [srv.submit(p, max_new_tokens=n) for p, n in traffic]
            out_ = srv.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if run:       # the first run captures the graphs
                steps_ms.append(1e3 * wall / (srv.metrics.steps - steps0))
            tokens.append([out_[r].tokens for r in rids])
        graphs = len(srv._graphs)
        srv._run_or_replay = lambda key, forward, srv=srv, B=scfg[
            "max_batch_size"]: torch.zeros(
                key + B if isinstance(key, int) else
                2 * srv._legacy_static[key].views["ids"].shape[0],
                dtype=torch.int32, device="cuda")
        host_ms = []
        for run in range(runs):
            torch.cuda.synchronize()
            steps0 = srv.metrics.steps
            t0 = time.perf_counter()
            for p, n in traffic:
                srv.submit(p, max_new_tokens=n)
            srv.run()
            torch.cuda.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t0)
                           / (srv.metrics.steps - steps0))
        res[name] = dict(mean_step_ms=steps_ms, host_ms=host_ms,
                         tokens_identical=all(t == tokens[0]
                                              for t in tokens),
                         tokens=tokens[0], graphs=graphs)
        del srv, eng
        torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump(dict(tree=tree, layers=cfg.num_hidden_layers, **res), f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base")
    ap.add_argument("change")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.base, args.layers, args.runs, args.child)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for i, side in enumerate(("base", "change", "change", "base")):
        tree = os.path.abspath(getattr(args, side))
        path = os.path.join(out_dir, f"serve_ab_turn{i}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), tree,
                        tree, "--runs", str(args.runs), "--layers",
                        str(args.layers), "--child", path], check=True)
        with open(path) as f:
            turn = json.load(f)
        turn["side"] = side
        turns.append(turn)
        print(f"turn {i} {side} ({tree}): " + ", ".join(
            f"{n} mean step {[round(x, 3) for x in turn[n]['mean_step_ms']]}"
            f" ms, host work {[round(x, 4) for x in turn[n]['host_ms']]} ms"
            f" (tokens identical across runs: "
            f"{turn[n]['tokens_identical']}, graphs {turn[n]['graphs']})"
            for n in ENGINES), flush=True)
    summary = dict(card=smi, layers=turns[0]["layers"], runs=args.runs)
    ok = True
    for n in ENGINES:
        mean, host = ({side: statistics.mean(
            x for t in turns if t["side"] == side for x in t[n][key])
            for side in ("base", "change")}
            for key in ("mean_step_ms", "host_ms"))
        same = all(t[n]["tokens"] == turns[0][n]["tokens"] and
                   t[n]["tokens_identical"] for t in turns)
        ok &= same
        summary[n] = dict(base_ms=mean["base"], change_ms=mean["change"],
                          ratio=mean["change"] / mean["base"],
                          base_host_ms=host["base"],
                          change_host_ms=host["change"],
                          tokens_identical=same)
        print(f"{n}: mean step base {mean['base']:.4f} ms, change "
              f"{mean['change']:.4f} ms, change / base "
              f"{mean['change'] / mean['base']:.4f}; host work base "
              f"{host['base']:.4f} ms, change {host['change']:.4f} ms; "
              f"tokens identical in every run of both trees: {same}",
              flush=True)
    summary["turns"] = [{k: v for k, v in t.items() if k != "tokens"}
                        for t in turns]
    for t in summary["turns"]:
        for n in ENGINES:
            t[n] = {k: v for k, v in t[n].items() if k != "tokens"}
    with open(os.path.join(out_dir, "serve_ab.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
