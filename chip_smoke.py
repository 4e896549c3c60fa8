"""Drive deepspeed_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every kernel under deepspeed_tpu_torch/csrc, compiled with nvcc
   in parallel (one process per source);
3. kernel parity: each kernel's wrapper against its plain PyTorch version
   on the same inputs at the serving step's shapes, with times (CUDA
   events, median of 25 runs after warm-up, the L2 cache flushed before
   each run as the serving step finds it cold) and the bound (the larger
   of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s);
4. serve: init_inference + ServingEngine on full-width Llama-3-8B (random
   bf16 weights from a seed, all 32 layers), 16 seeded requests to
   completion; asserts every request finished, no logit was flagged, no
   page leaked, and the kernel ran once per layer per mixed step;
5. a ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and last the
   ``{"ok": true, "device": {...}}`` line.

Exits non-zero without printing a result when no CUDA device is present.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak

# the serving step's attention shapes: Llama-3-8B heads, the ServingEngine
# below (8 slots, 16-token pages, 1024 pages, 2048-token rows, a packed
# batch of 8 - 1 + 256 tokens)
H, HKV, D, BS = 32, 8, 128, 16
N_PAGES, R, NB = 1024, 8, 2048 // 16
T_PACKED = 8 - 1 + 256


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


L2_FLUSH_BYTES = 256 << 20     # over 5x the H100's 50 MB L2


def cuda_time_ms(fn, reps=25, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn()``, each after a
    write of ``L2_FLUSH_BYTES`` that evicts the inputs from L2, so the
    time and an HBM bound measure the same memory level."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernel K6: ragged paged attention
# ---------------------------------------------------------------------------

def ragged_case(rows, int8, seed, device="cuda"):
    """A pool and packed batch on ``device``. ``rows``: R entries of
    ``(query_len, chunk_start)`` (query_len 0 = idle row; decode rows are
    ``(1, context - 1)``). Every row owns distinct pages covering its
    context; the rest of its table is the sentinel ``N_PAGES``. The packed
    batch is padded to ``T_PACKED`` tokens that no row claims."""
    assert len(rows) == R
    g = torch.Generator(device=device).manual_seed(seed)
    bt = torch.full((R, NB), N_PAGES, dtype=torch.int32)
    qs, ql, cs, cl = (torch.zeros(R, dtype=torch.int32) for _ in range(4))
    perm = np.random.RandomState(seed).permutation(N_PAGES)
    used = cursor = 0
    for r, (n, start) in enumerate(rows):
        if n == 0:
            continue
        pages = -(-(start + n) // BS)
        bt[r, :pages] = torch.from_numpy(perm[used:used + pages].astype(np.int32))
        used += pages
        qs[r], ql[r], cs[r], cl[r] = cursor, n, start, start + n
        cursor += n
    assert cursor <= T_PACKED and used <= N_PAGES
    shape = (N_PAGES, HKV, BS, D)
    if int8:
        k = torch.randint(-127, 128, shape, generator=g, device=device,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=device,
                          dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=g, device=device) / 64
        vs = torch.rand(shape[:3], generator=g, device=device) / 64
    else:
        k = torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)
        v = torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)
        ks = vs = None
    q = torch.randn((T_PACKED, H, D), generator=g, device=device,
                    dtype=torch.bfloat16)
    desc = [t.to(device) for t in (bt, qs, ql, cs, cl)]
    return (q, k, v, *desc), dict(k_scale=ks, v_scale=vs)


def ragged_bound(args, kw, window):
    """``(ms, "bytes" | "operations")``: least time for the function on
    these inputs: the larger of the bytes it must move (each visible K/V
    page once per kv head, scales, the q rows that some row claims, the
    whole output, descriptors) over HBM bandwidth and its FLOPs (QK^T and
    PV over visible keys) over the bf16 peak."""
    q, k, v, bt, qs, ql, cs, cl = args
    elem = k.element_size()
    page_bytes = HKV * BS * D * elem * 2 + (HKV * BS * 4 * 2
                                            if kw["k_scale"] is not None
                                            else 0)
    token_bytes = H * D * q.element_size()
    nbytes = (int(ql.sum()) + q.shape[0]) * token_bytes \
        + 4 * (bt.numel() + 4 * R)
    flops = 0
    for n, start, clen in zip(ql.tolist(), cs.tolist(), cl.tolist()):
        if n == 0 or clen == 0:
            continue
        lo = 0 if window is None else max(0, start - window + 1)
        nbytes += (-(-clen // BS) - lo // BS) * page_bytes
        pos = np.arange(start, start + n)
        first = pos - (window - 1) if window is not None else 0 * pos
        keys = np.minimum(pos, clen - 1) - np.maximum(first, 0) + 1
        flops += int(keys.sum()) * H * D * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


RAGGED_CASES = {
    # 8 decode rows, contexts up to 2048
    "decode8": [(1, c - 1) for c in (2048, 1536, 1024, 777, 512, 300, 64,
                                     17)],
    # 7 decode rows + one 256-token chunk at chunk_start 512 (the serving
    # step's mixed shape)
    "mixed": [(1, c - 1) for c in (2048, 1200, 900, 640, 333, 128, 40)]
    + [(256, 512)],
    # prefill chunks only
    "chunks": [(128, 0), (0, 0), (128, 896), (0, 0), (0, 0), (0, 0),
               (0, 0), (0, 0)],
    # idle rows between live ones, sentinel tails, unclaimed padding
    "idle_sentinel": [(0, 0), (1, 99), (0, 0), (40, 1000), (0, 0),
                      (1, 15), (0, 0), (3, 2040)],
}


def check_ragged_attention():
    """K6 against its plain version: bf16 pool, int8 pool, window=256.
    Tolerance: both outputs are bf16 roundings of fp32 results that
    differ only in summation order (~1e-6 relative), so they agree to one
    bf16 ulp: |kernel - plain| <= 2**-7 * |plain| + 1e-3."""
    from deepspeed_tpu_torch.ops.ragged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for variant, (int8, window) in {"bf16": (False, None),
                                    "int8": (True, None),
                                    "window256": (False, 256)}.items():
        for name, rows in RAGGED_CASES.items():
            args, kw = ragged_case(rows, int8, seed=len(results) + 1)
            kw = dict(kw, window=window)
            got = ragged_paged_attention(*args, **kw)
            ref = ragged_paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            ok = bool((err <= 2 ** -7 * ref.float().abs() + 1e-3).all())
            ms = cuda_time_ms(lambda: ragged_paged_attention(*args, **kw))
            plain_ms = cuda_time_ms(
                lambda: ragged_paged_attention_plain(*args, **kw), reps=5,
                warmup=1)
            bound, bound_by = ragged_bound(args, kw, window)
            key = f"{variant}/{name}"
            results[key] = dict(max_abs_err=float(err.max()), ms=ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=bound_by)
            log(f"parity ragged_paged_attention {key}: ok={ok} "
                f"max_abs_err={float(err.max()):.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f}")
            if not ok:
                raise AssertionError(f"ragged_paged_attention {key} "
                                     f"disagrees with its plain version")
    return results


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def serve(cfg, params_seed, n_requests, prompt_range, new_range, scfg,
          dtype, device="cuda"):
    """init_inference + ServingEngine on ``cfg`` with seeded random
    weights; serves seeded traffic to completion and returns the engine,
    the request ids, the outputs, the wall time and the kernel launches
    of the run."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaForCausalLM
    from deepspeed_tpu_torch.ops.ragged_attention import ragged_paged_attention

    model = LlamaForCausalLM(cfg)
    params = model.init_params(seed=params_seed, dtype=dtype, device=device)
    engine = dt.init_inference(model, params=params, dtype=dtype,
                               device=device)
    srv = dt.ServingEngine(engine, dt.ServingConfig(**scfg))
    rs = np.random.RandomState(params_seed)
    rids = []
    for _ in range(n_requests):
        n = int(rs.randint(prompt_range[0], prompt_range[1] + 1))
        rids.append(srv.submit(rs.randint(0, cfg.vocab_size, n),
                               max_new_tokens=int(rs.randint(
                                   new_range[0], new_range[1] + 1))))
    torch.cuda.synchronize()
    ragged_paged_attention.launches = 0
    t0 = time.perf_counter()
    res = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return srv, rids, res, wall, ragged_paged_attention.launches


def check_small_reference():
    """The same seeded traffic through a 2-layer model (head_dim 128, GQA
    group 2) in fp32, once as shipped (the kernel) and once with the
    model's attention swapped for the plain version: greedy tokens must
    be identical (the two differ by fp32 summation order)."""
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.models import llama as llama_mod
    from deepspeed_tpu_torch.ops.ragged_attention import \
        ragged_paged_attention_plain

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1)
    kernel = llama_mod.ragged_paged_attention
    tokens, launches = {}, {}
    for attention in ("kernel", "plain"):
        llama_mod.ragged_paged_attention = kernel \
            if attention == "kernel" else ragged_paged_attention_plain
        try:
            srv, rids, res, _, launches[attention] = serve(
                cfg, 3, 6, (5, 90), (4, 12),
                dict(max_batch_size=4, block_size=16, num_blocks=64,
                     max_model_len=128, prefill_token_budget=32),
                torch.float32)
        finally:
            llama_mod.ragged_paged_attention = kernel
        tokens[attention] = [(res[r].state, res[r].tokens) for r in rids]
    ok = tokens["kernel"] == tokens["plain"] and \
        all(s == "finished" for s, _ in tokens["kernel"]) and \
        launches["kernel"] > 0 and launches["plain"] == 0
    log(f"reference: 2-layer fp32 model, kernel vs plain attention, "
        f"{len(tokens['kernel'])} requests: tokens identical={ok} "
        f"(kernel launches {launches['kernel']} / {launches['plain']})")
    if not ok:
        raise AssertionError("kernel and plain attention served different "
                             "tokens on the small fp32 model")


def check_serving():
    """Full-width Llama-3-8B (all 32 layers, random bf16 weights) serving
    16 seeded requests through the unified mixed step on the kernel."""
    from deepspeed_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.llama3_8b()
    t = time.perf_counter()
    srv, rids, res, wall, launches = serve(
        cfg, 0, 16, (64, 1536), (32, 64),
        dict(max_batch_size=8, block_size=16, num_blocks=1024,
             max_model_len=2048, prefill_token_budget=256, trace=True,
             trace_capacity=1 << 16), torch.bfloat16)
    setup = time.perf_counter() - t - wall
    steps = sum(1 for e in srv.tracer.events() if e["name"] == "mixed_step")
    m = srv.metrics
    snap = m.snapshot()
    finished = sum(res[r].state == "finished" for r in rids)
    log(f"serve: llama3_8b x{cfg.num_hidden_layers} layers bf16, "
        f"{len(rids)} requests, {finished} finished, {steps} mixed steps, "
        f"wall {wall:.3f} s (setup {setup:.1f} s), generated "
        f"{m.tokens_generated} tokens = {m.tokens_generated / wall:.1f} "
        f"tok/s, prefill {m.prefill_tokens} tokens, ttft_p50 "
        f"{snap.get('ttft_p50_s', float('nan')):.3f} s, mean step "
        f"{1e3 * wall / max(steps, 1):.2f} ms, preemptions {m.preemptions}, "
        f"quarantines {m.logit_quarantines}, kernel launches {launches}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    srv.block_pool.check_consistent()
    problems = []
    if finished != len(rids):
        problems.append(f"{len(rids) - finished} requests did not finish")
    if m.logit_quarantines:
        problems.append(f"{m.logit_quarantines} rows flagged NaN/Inf")
    if srv.block_pool.used_count:
        problems.append(f"{srv.block_pool.used_count} pages leaked")
    if launches == 0 or launches != cfg.num_hidden_layers * steps:
        problems.append(f"kernel launches {launches} != "
                        f"{cfg.num_hidden_layers} x {steps} mixed steps")
    if problems:
        raise AssertionError("serve: " + "; ".join(problems))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    from deepspeed_tpu_torch.ops import _build

    t = time.perf_counter()
    _build.build()
    log(f"build: {', '.join(_build.sources())} in "
        f"{time.perf_counter() - t:.1f} s")

    ragged = check_ragged_attention()
    check_small_reference()
    launches = check_serving()

    main_case = ragged["bf16/mixed"]
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/ragged_attention.py:64",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in ragged.values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
