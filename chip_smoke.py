"""Drive deepspeed_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every kernel under deepspeed_tpu_torch/csrc, compiled with nvcc
   in parallel (one process per source);
3. kernel parity: each kernel's wrapper against its plain PyTorch version
   on the same inputs at its main path's shapes (and a few more), with
   times (CUDA events, median of 25 runs after warm-up, the L2 cache
   flushed before each run as the step finds it cold), the bound (the
   larger of bytes / 3.35 TB/s and FLOPs over the type's peak) and, where
   one PyTorch call computes the same function, that call's time:
   K6 ragged paged attention at the serving step's shapes; K7a paged
   decode attention (B 8, H 32, Hkv 8, D 128, 1024 pages of 16 tokens, a
   table 128 wide, seeded contexts up to 2048, bf16, plus an int8 pool, a
   window, idle sentinel rows and fp32; K6's and K7a's lines name the
   route, tensor or CUDA cores, the grid and the key splits, the achieved
   GB/s and the share of the bound) and K7b paged chunked-prefill
   attention (B 1, T 64 on the same pool: chunk_start 0, mid-prompt,
   behind a 512-token prefix, a padded tail, int8, window) of the
   two-program serving engine; K1/K2 flash attention forward, dQ and
   dK/dV at the training step's (B 8, H 16, T 1024, D 64, bf16, causal),
   with gradients through the autograd function, and K1's masked,
   GQA-native forward at the generate prefill's shapes (B 8, T 512, H 32,
   Hkv 8, D 128, bf16, left-padded masks) and at a bucketed serving
   prompt (B 1, T 1024); K3 fused Adam over the whole Llama-400M parameter list; K4
   decode attention at the generate step's shapes (B 8, H 32, Hkv 8,
   D 128, cache 576, bf16, left-padded key masks) and an int8 cache, a
   window, an fp32 case and caches of 2048 and 8192 (each with its split
   count); K5 quantized matmul at Llama-3-8B projection shapes (decode
   M 8 at every projection shape and M 1 at up, prefill M 4096 at the q,
   up and down shapes, int8 per-column and int4 group 64) plus fp32
   cases (the fp32 decode kernel, gemv_tf32, at 8 x 4096 -> 4096 int4 g64,
   int8 and odd N 4099, each also replayed in a CUDA graph) and ragged
   cases (rows TMA cannot address: 264 -> 1000 at M 8 and 37,
   4100 -> 14330 at M 8 int8 and M 512 int4 in groups of 100, asserting
   one ragged-kernel launch each), each with the kernel route it took
   (the decode and ragged kernels' tiles and cluster size), its GB/s and
   share of the bound; K8 per-column int8 matmul (decode up and down, q
   and up prefill, fp32 prefill and decode, a wide ragged decode); K9
   block-sparse attention forward, dQ and dK/dV at the long-context
   path's main shape (B 1, T 16384, H 32, D 128, bf16, causal, block 128,
   BSLongformer and BigBird, the plain versions head by head) and at
   T 4096 / 8192, fp32 D 64 block 64, non-causal BigBird and a per-head
   Fixed layout, with FlexAttention (compiled, on a BlockMask from the
   layout; main shape only) and SDPA with the layout's bool mask as
   yardsticks, and the size of the bf16 kernels' work lists;
4. small references: a 2-layer fp32 model served with K6 (and K5, with
   int8 weights), with their plain versions and captured as CUDA graphs
   at bucketed widths (identical tokens), served
   through the two-program engine with K7a/K7b (chunked, with the prefix
   cache) and with K7a and the masked K1 (monolithic prefill) and with
   their plain versions (identical tokens), generating with K4/K5 and with
   their plain versions (identical tokens; fp32, int8 and int4 weights,
   int8 cache, window 64, and the masked K1 prefill; fp32 and int8 also
   with the decode step captured), and
   trained (captured) 5 steps in fp32 and 10 in fp16 from a loss scale
   that overflows, with K1/K2/K3 and with their plain versions (losses
   within 1e-4 relative, the same skipped steps and loss scale);
5. serve: init_inference + ServingEngine on full-width Llama-3-8B (random
   bf16 weights from a seed, all 32 layers), 16 seeded requests to
   completion, in turns: uncaptured, captured (enable_cuda_graph), both
   again at bucketed widths (mixed_step_buckets), then each captured
   engine again with its graphs warm; asserts every request finished, no
   logit was flagged, no page leaked, every captured run repeated its
   width's uncaptured tokens, and K6 ran once per layer per mixed step
   (counted on the device, replays included); a width witness holds K6
   to the same rows at a narrow packed width and at 263, bit for bit,
   and prints the layer-0 projections' and LM head's differences; then
   the two-program engine (mixed_step=False) on the same model and
   weights: 16 seeded requests, 4 shared 512-token prefixes x 4, suffixes
   64-512, 32-64 new tokens, with the prefix cache and 64-token chunks
   under a 256-token budget (asserts >= 12 prefix hits, K7a launched 32 x
   decode forwards, K7b 32 x chunk forwards, K6 never), then the same
   requests without the cache through the monolithic bucketed prefill
   with prefill_flash_from_empty (asserts the masked K1 launched 32 x
   prefills); each of the two again with enable_cuda_graph (the decode,
   chunk and monolithic forwards replayed as CUDA graphs: the same tokens,
   no leaked page, and, counted on the device over a replayed run, K7a
   and K7b or the masked K1 once per layer per forward; each run's last
   decode_mbu / decode_mfu gauges printed and held in (0, 1.05]);
   robustness and accounting on the same weights: (a) the captured
   unified serve under a 2 s step watchdog with the flight recorder
   armed, in turns with the same captured engine unguarded (identical
   tokens, no trip, no dump, the same graphs; the mean steps, the guard's
   host cost, the mixed_mbu / mixed_mfu gauges on the H100's peaks and
   perf_summary()'s program table printed); (b) chaos on both engines,
   captured (a slow_step past a 0.5 s budget, a corrupt_logits of each
   tag, a flaky_prefill): every request terminal with the expected finish
   reasons, one trip, two quarantines, no leaked page, a fresh request
   served, the graphs unchanged, one flight dump per firing naming its
   request; (c) the serve with TTFT and TPOT SLOs at (a)'s p50s: the
   verdicts sum to the requests;
6. generate: init_inference + InferenceEngine.generate on full-width
   Llama-3-8B (random bf16 weights from seed 0), batch 8, left-padded
   prompts of seeded lengths 128-512 (bucket 512), 64 greedy new tokens,
   once with bf16 weights, once with quantize_weights="int8" (uncaptured,
   then with the decode step captured: identical tokens, both decode-step
   times printed, the capturing warm-up's launches K4 2 x 32 and gemv_tc
   2 x 7 x 32, the replayed run's none) and once with bf16 weights and
   prefill_flash_from_empty; asserts the output
   shape, finite logits, K4 launched 32 x 63 times, with int8 weights K5
   launched 7 x 32 x 64 times (7 x 32 of them, the prefill's, on the
   wgmma kernel, and 7 x 32 x 63, the decode steps', on the gemv_tc
   kernel), and with the flag the masked K1 launched 32 times;
7. train: initialize + train_batch on full-width Llama-400M (random
   weights from seed 0, all 24 layers), the JAX package's bench config
   (batch 8 x 1024, AdamW, bf16, clipping 1.0), uncaptured
   (cuda_graph=False) and captured (the step one CUDA graph), 2 warm-up
   steps each, then 5 timed steps each in turns (uncaptured, captured,
   captured, uncaptured), then one profiled step each; prints step ms,
   tokens/s, model TFLOP/s, idle share and peak memory per route; asserts
   identical, finite, falling losses on the two routes and, counted on
   the device over one profiled step of each, K1 48 (forward and
   recompute), K2 24 + 24 and K3 1 (the captured step's in its replay);
   (d) each route's train_mfu gauge in (0, 1.05] and, over 5 more steps
   each waited for, its train_tflops_per_chip (each step's device time)
   within 5% of the hand count over the host's wall time of the same
   steps;
8. long context: ``ops.sparse_attention.sparse_attention`` forward and
   backward (loss ``(out * dout).sum()``) at T 4096, 8192 and 16384, 32
   heads of 128, bf16, causal, BSLongformer and BigBird at block 128 (the
   layouts of the JAX package's tools/bench_longctx.py), beside causal
   flash attention on the same q/k/v; asserts finite gradients and the
   launch counts (K9 6 x each kernel, K1/K2 once per yardstick), then
   prints one ``long context {...}`` JSON line per length with
   bench_longctx's fields, the backward times and the host time of one
   forward call;
9. a ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and last the
   ``{"ok": true, "device": {...}}`` line. A kernel's ``launches`` are its
   wrapper's count over its path's uncaptured run (a wrapper counts where
   it launches; a graph replays its kernels without it), except K6's,
   counted on the device with the replays. Where a path also ran
   captured, ``graph_launches`` are the kernels' runs counted on the
   device over its replays: K1/K2/K3 in one replayed training step,
   K7a/K7b and the masked K1 in the two-program engines' replayed
   re-serves (item 5). Each of these kernels adds one to its device count
   (``deepspeed_tpu_torch/ops/_runs.py``) when it runs.

Exits non-zero without printing a result when no CUDA device is present.
"""

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12        # H100 SXM dense TF32 tensor-core peak

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
SPIN_CYCLES = 10_000_000       # ~5 ms of device time at the H100's clocks


def cuda_time_ms(fn, reps=25, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn()``, each after a
    write of ``L2_FLUSH_BYTES`` that evicts the inputs from L2, so the
    time and an HBM bound measure the same memory level. A spin on the
    device after the flush keeps it busy while the host runs the wrapper
    up to its launch, so the interval holds device time, not the
    wrapper's host time (a plain version whose host time is longer still
    shows it)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops, flop_rate):
    """``(ms, "bytes" | "operations")``: the larger of the two floors."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


# ---------------------------------------------------------------------------
# kernel K6: ragged paged attention
# ---------------------------------------------------------------------------

def paged_route(q, k_pages):
    """The route K6 / K7a / K7b take for these inputs: a function of q's
    type (bf16 q over a bf16 or int8 pool runs on the tensor cores)."""
    return "tensor cores" if q.dtype == torch.bfloat16 else "CUDA cores"


def achieved(bound_ms, bound_by, ms):
    """The achieved memory rate and the share of the bound, as printed."""
    gbps = f"{bound_ms / ms * HBM_BYTES_PER_S / 1e9:.0f} GB/s, " \
        if bound_by == "bytes" else ""
    return f"{gbps}{100 * bound_ms / ms:.1f}% of the bound"


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
    return bound(nbytes, flops, BF16_FLOP_PER_S)


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
    from deepspeed_tpu_torch.ops.decode_attention import _sm_count
    from deepspeed_tpu_torch.ops.ragged_attention import (
        launch_params, ragged_paged_attention, ragged_paged_attention_plain)

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
            lp = launch_params(T_PACKED, R, NB, HKV, _sm_count(0))
            log(f"parity ragged_paged_attention {key}: ok={ok} "
                f"max_abs_err={float(err.max()):.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} "
                f"({bound_by}) | route {paged_route(args[0], args[1])}, "
                f"grid {lp['grid']} blocks, {lp['splits']} splits of "
                f"{lp['per']} 64-key tiles | {achieved(bound, bound_by, ms)}")
            if not ok:
                raise AssertionError(f"ragged_paged_attention {key} "
                                     f"disagrees with its plain version")
    return results


# ---------------------------------------------------------------------------
# kernels K7a and K7b: paged decode and paged chunked-prefill attention
# ---------------------------------------------------------------------------

PAGED_CHUNK = 64
PAGED_DECODE_MAIN = "bf16"
PAGED_PREFILL_MAIN = "behind_prefix512"
_DECODE_CONTEXTS = (2048, 1536, 1100, 777, 512, 300, 64, 17)
PAGED_CASES = {
    # name: (T, Hq, Hkv, Dh, dtype, int8 pool, window, rows); rows are
    # (chunk_start, context_len) per sequence, None = an idle slot (a
    # sentinel table row with context 1); T == 1 is the decode kernel
    "decode": {
        "bf16": (1, H, HKV, D, torch.bfloat16, False, None,
                 [(c - 1, c) for c in _DECODE_CONTEXTS]),
        "int8": (1, H, HKV, D, torch.bfloat16, True, None,
                 [(c - 1, c) for c in _DECODE_CONTEXTS]),
        "window256": (1, H, HKV, D, torch.bfloat16, False, 256,
                      [(c - 1, c) for c in _DECODE_CONTEXTS]),
        "idle_sentinel": (1, H, HKV, D, torch.bfloat16, False, None,
                          [None, (99, 100), None, (1039, 1040), (0, 0),
                           (15, 16), None, (2047, 2048)]),
        "fp32_d64_g1": (1, 8, 8, 64, torch.float32, False, None,
                        [(c - 1, c) for c in (1000, 333, 16, 1)]),
    },
    "prefill": {
        "start0": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, False, None,
                   [(0, 64)]),
        "mid_prompt": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, False, None,
                       [(960, 1024)]),
        "behind_prefix512": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, False,
                             None, [(512, 576)]),
        "padded_tail": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, False, None,
                        [(1024, 1047)]),
        "int8": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, True, None,
                 [(512, 576)]),
        "window256": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, False, 256,
                      [(960, 1024)]),
        "fp32_d64_b3": (40, 8, 4, 64, torch.float32, False, None,
                        [(0, 40), (100, 117), (2008, 2048)]),
    },
}


def paged_case(T, Hq, Hkv, Dh, dtype, int8, rows, seed):
    """q ``[B, T, Hq, Dh]``, a pool of ``N_PAGES`` pages, a table ``NB``
    wide whose rows own distinct seeded pages covering their context (the
    rest is the sentinel ``N_PAGES``), and the chunk starts and context
    lengths."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(rows)
    bt = torch.full((B, NB), N_PAGES, dtype=torch.int32)
    cs = torch.zeros(B, dtype=torch.int32)
    cl = torch.ones(B, dtype=torch.int32)
    perm = np.random.RandomState(seed).permutation(N_PAGES)
    used = 0
    for b, row in enumerate(rows):
        if row is None:
            continue
        cs[b], cl[b] = row
        pages = -(-row[1] // BS)
        bt[b, :pages] = torch.from_numpy(perm[used:used + pages]
                                         .astype(np.int32))
        used += pages
    assert used <= N_PAGES
    shape = (N_PAGES, Hkv, BS, Dh)
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                              dtype=torch.int8) for _ in range(2))
        scales = {n: torch.rand(shape[:3], generator=g, device="cuda") / 64
                  for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(shape, generator=g, device="cuda", dtype=dtype)
                for _ in range(2))
        scales = {}
    q = torch.randn((B, T, Hq, Dh), generator=g, device="cuda", dtype=dtype)
    return q, k, v, bt.cuda(), cs.cuda(), cl.cuda(), scales


def paged_bound(T, Hq, Hkv, Dh, dtype, int8, window, rows):
    """``(ms, "bytes" | "operations")``: least time for the function on
    these inputs. Bytes: the K/V (and scales) of every key some row of the
    chunk sees, once per kv head, the q rows inside the context, the whole
    output, the table and the descriptors, over HBM bandwidth. FLOPs: 4 D
    per (query head, visible key) of every row, at the peak of q's type."""
    e = torch.tensor([], dtype=dtype).element_size()
    key_bytes = Hkv * (2 * Dh * (1 if int8 else e) + (8 if int8 else 0))
    B = len(rows)
    nbytes = B * T * Hq * Dh * e + 4 * (B * NB + 2 * B)
    pairs = 0
    for row in rows:
        start, clen = row if row is not None else (0, 1)
        pos = start + np.arange(T)
        pos = pos[pos < clen]
        if not len(pos):
            continue
        lo = np.maximum(pos - window + 1, 0) if window is not None \
            else 0 * pos
        pairs += int((pos - lo + 1).sum())
        nbytes += (int(pos[-1]) - int(lo[0]) + 1) * key_bytes \
            + len(pos) * Hq * Dh * e
    return bound(nbytes, 4 * Hq * Dh * pairs,
                 BF16_FLOP_PER_S if dtype == torch.bfloat16
                 else FP32_FLOP_PER_S)


def check_paged_attention():
    """K7a and K7b against their plain versions. Tolerance: fp32 1e-5
    (summation order only); bf16 |kernel - plain| <= 2**-7 * |plain| + 1e-3
    (both are bf16 roundings of fp32 results that differ only in summation
    order: one bf16 ulp). No library yardstick: no single PyTorch call
    reads a paged pool through a block table."""
    from deepspeed_tpu_torch.ops import decode_attention as da

    results = {"decode": {}, "prefill": {}}
    for kind, cases in PAGED_CASES.items():
        for name, (T, Hq, Hkv, Dh, dtype, int8, window, rows) in \
                cases.items():
            q, k, v, bt, cs, cl, scales = paged_case(
                T, Hq, Hkv, Dh, dtype, int8, rows,
                seed=len(results[kind]) + (61 if kind == "decode" else 71))
            kw = dict(window=window, **scales)
            if kind == "decode":
                args = (q[:, 0].contiguous(), k, v, bt, cl)
                kernel, plain = da.paged_decode_attention, \
                    da.paged_decode_attention_plain
            else:
                args = (q, k, v, bt, cs, cl)
                kernel, plain = da.paged_prefill_attention, \
                    da.paged_prefill_attention_plain
            got = kernel(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else \
                (2 ** -7, 1e-3)
            if not bool((err <= rtol * ref.float().abs() + atol).all()) \
                    or not bool(torch.isfinite(got).all()):
                raise AssertionError(
                    f"paged_{kind}_attention {name} disagrees with its "
                    f"plain version (max |err| {float(err.max()):.3e})")
            ms = cuda_time_ms(lambda: kernel(*args, **kw))
            plain_ms = cuda_time_ms(lambda: plain(*args, **kw), reps=5,
                                    warmup=1)
            bms, by = paged_bound(T, Hq, Hkv, Dh, dtype, int8, window, rows)
            results[kind][name] = dict(
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None)
            if kind == "decode":
                splits, per = da.paged_splits(len(rows), Hkv, NB,
                                              da._sm_count(0))
                grid = (len(rows), Hkv, splits)
            else:
                lp = da.prefill_launch(len(rows), T, Hq, Hkv, NB, dtype,
                                       da._sm_count(0))
                splits, per = lp["splits"], lp["per"]
                grid = (len(rows) * lp["tiles"], Hkv, splits)
            launch = (f" | route {paged_route(q, k)}, grid {grid}, {splits} "
                      f"splits of {per} 64-key tiles | "
                      f"{achieved(bms, by, ms)}")
            log(f"parity paged_{kind}_attention {name} (B {len(rows)} T {T} "
                f"H {Hq} Hkv {Hkv} D {Dh} {str(dtype)[6:]} int8 {int8} "
                f"window {window} (chunk_start, context) {rows}): ok "
                f"max_abs_err={float(err.max()):.3e} (tolerance "
                f"{rtol:g}*|plain|+{atol:g}) | kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.3f} bound_ms={bms:.4f} ({by}) "
                f"library_ms=None{launch}")
            del q, k, v, got, ref, args, scales
    return results


# ---------------------------------------------------------------------------
# kernels K1 and K2: flash attention forward, dQ, dK/dV
# ---------------------------------------------------------------------------

# the training step's attention: Llama-400M heads at batch 8 x 1024
FLASH_MAIN = "train_bf16"
FLASH_CASES = {
    # name: (B, H, Tq, Tk, D, dtype, causal, window)
    FLASH_MAIN: (8, 16, 1024, 1024, 64, torch.bfloat16, True, None),
    "fp32": (2, 8, 512, 512, 64, torch.float32, True, None),
    "window256": (4, 16, 1024, 1024, 64, torch.bfloat16, True, 256),
    "d128": (2, 8, 1024, 1024, 128, torch.bfloat16, True, None),
    "uneven_t1000": (2, 8, 1000, 1000, 64, torch.bfloat16, True, None),
    "full_fp32": (2, 4, 300, 300, 64, torch.float32, False, None),
}


# K1's masked, GQA-native forward: the generate prefill's shapes, and a
# serving prompt of 777 tokens in its 1024 bucket
FLASH_MASKED_MAIN = "generate_prefill"
FLASH_MASKED_CASES = {
    # name: (B, Hq, Hkv, T, Dh, dtype, window, real tokens per row, left pad)
    "generate_prefill": (8, H, HKV, 512, D, torch.bfloat16, None,
                         (175, 487, 300, 512, 128, 401, 256, 350), True),
    "serving_bucket1024": (1, H, HKV, 1024, D, torch.bfloat16, None, (777,),
                           False),
    "fp32_window128": (2, 8, 2, 300, 64, torch.float32, 128, (300, 190),
                       True),
}


def check_masked_flash_attention():
    """K1's key-mask mode (un-repeated kv heads, causal, a key mask that
    hides left or right padding) against the plain version. Tolerances as
    for the unmasked forward. Library yardstick: SDPA with a boolean mask
    (causal and key mask) and enable_gqa. Bound: q, k, v, the mask, out
    and lse moved once; 4 D FLOPs per (query head, visible pair)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    results = {}
    for case, (B, Hq, Hkv, T, Dh, dtype, window, lens, left) in \
            FLASH_MASKED_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(len(results) + 81)
        q = torch.randn(B, T, Hq, Dh, generator=g, device="cuda", dtype=dtype)
        k, v = (torch.randn(B, T, Hkv, Dh, generator=g, device="cuda",
                            dtype=dtype) for _ in range(2))
        ar = np.arange(T)[None]
        n = np.asarray(lens)[:, None]
        mask_np = (ar >= T - n) if left else (ar < n)
        mask = torch.from_numpy(mask_np.astype(np.int32)).cuda()
        kw = dict(causal=True, window=window)
        out, lse = fa.flash_attention_fwd_masked(q, k, v, mask, **kw)
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, key_mask=mask,
                                                    **kw)
        torch.cuda.synchronize()
        fp32 = dtype == torch.float32
        rtol, atol = (1e-5, 1e-5) if fp32 else (2 ** -7, 2e-2)
        seen = torch.isfinite(ref_lse)
        errs = {"out": (out.float() - ref_out.float()).abs(),
                "lse": (lse[seen] - ref_lse[seen]).abs()}
        ok = torch.equal(seen, torch.isfinite(lse)) and \
            bool((errs["out"] <= rtol * ref_out.float().abs() + atol).all()) \
            and bool((errs["lse"] <= 1e-5 * ref_lse[seen].abs() + 1e-4).all())
        errs = {name: float(e.max()) for name, e in errs.items()}
        if not ok:
            raise AssertionError(f"masked flash attention {case} disagrees "
                                 f"with the plain version (max |err| {errs})")
        ms = cuda_time_ms(
            lambda: fa.flash_attention_fwd_masked(q, k, v, mask, **kw))
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, key_mask=mask, **kw), reps=5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        i = torch.arange(T, device="cuda")
        am = (i[:, None] >= i[None, :])[None, None] & \
            (mask > 0)[:, None, None, :]
        if window is not None:
            am = am & (i[:, None] - i[None, :] < window)[None, None]
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am, enable_gqa=True))
        pairs = 0
        for row in mask_np:
            vis = np.tril(np.ones((T, T), bool)) & row[None, :]
            if window is not None:
                vis &= (ar.T - ar) < window
            pairs += int(vis.sum())
        e = q.element_size()
        bms, by = bound(2 * B * T * Hq * Dh * e + 2 * B * T * Hkv * Dh * e
                        + B * Hq * T * 4 + B * T * 4, 4 * Hq * Dh * pairs,
                        FP32_FLOP_PER_S if fp32 else BF16_FLOP_PER_S)
        results[case] = dict(max_abs_err=max(errs.values()), ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             library_ms=library_ms)
        log(f"parity flash_attention_fwd_masked {case} (B {B} H {Hq} Hkv "
            f"{Hkv} T {T} D {Dh} {str(dtype)[6:]} window {window} real "
            f"tokens {lens} {'left' if left else 'right'}-padded): ok "
            f"max_abs_err out={errs['out']:.3e} lse={errs['lse']:.3e} "
            f"(tolerance {rtol:g}*|plain|+{atol:g}) | kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.4f} ({by}) "
            f"library_ms={library_ms:.4f}")
        del q, k, v, out, lse, ref_out, ref_lse, qt, kt, vt, am
    return results


def visible_pairs(Tq, Tk, causal, window):
    """(query, key) pairs that the mask lets through, per (batch, head)."""
    i = np.arange(Tq) + (Tk - Tq)
    hi = np.minimum(i, Tk - 1) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0 * i
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bounds(case):
    """Bound of K1, K2-dq and K2-dkv on ``case``: each input read once,
    each output written once; FLOPs over the visible pairs (4 D each for
    the forward's two products, 6 D for dQ's three, 8 D for dK/dV's four),
    at the peak of the inputs' type."""
    B, H, Tq, Tk, D, dtype, causal, window = FLASH_CASES[case]
    e = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes, row_bytes = B * Tq * H * D * e, B * Tk * H * D * e, \
        B * H * Tq * 4
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    f1 = 4 * B * H * D * visible_pairs(Tq, Tk, causal, window)
    return {
        "fwd": bound(2 * q_bytes + 2 * kv_bytes + row_bytes, f1, rate),
        "dq": bound(3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 1.5 * f1,
                    rate),
        "dkv": bound(2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 2 * f1,
                     rate),
    }


def check_flash_attention():
    """K1, K2-dq and K2-dkv against the plain forward and backward on the
    same inputs; for the fp32 cases also the gradients through the
    autograd function against autograd of the plain forward. Tolerance:
    fp32 1e-5 (relative and absolute; summation order only); bf16
    |kernel - plain| <= 2**-7 |plain| + 2e-2 (both are bf16 roundings of
    fp32 results that differ in summation order: one bf16 ulp). Times and
    library yardsticks (SDPA forward, and its autograd backward for both
    K2 kernels) on every case. Then the forward's masked, GQA-native
    cases. Returns ``(results, masked results)``."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    results = {}
    for case, (B, H, Tq, Tk, D, dtype, causal, window) in \
            FLASH_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(len(results) + 7)
        q, do = (torch.randn(B, Tq, H, D, generator=g, device="cuda",
                             dtype=dtype) for _ in range(2))
        k, v = (torch.randn(B, Tk, H, D, generator=g, device="cuda",
                            dtype=dtype) for _ in range(2))
        kw = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, **kw)
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        fp32 = dtype == torch.float32
        rtol, atol = (1e-5, 1e-5) if fp32 else (2 ** -7, 2e-2)
        pairs = {"out": (out, ref_out), "lse": (lse, ref_lse),
                 "dq": (dq, ref[0]), "dk": (dk, ref[1]), "dv": (dv, ref[2])}
        if fp32:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fa.flash_attention(*leaves, **kw).backward(do)
            plain = [t.clone().requires_grad_() for t in (q, k, v)]
            fa.flash_attention_plain(*plain, **kw)[0].backward(do)
            for name, a, b in zip(("grad_q", "grad_k", "grad_v"), leaves,
                                  plain):
                pairs[name] = (a.grad, b.grad)
        torch.cuda.synchronize()
        errs = {}
        for name, (a, b) in pairs.items():
            err = (a.float() - b.float()).abs()
            errs[name] = float(err.max())
            if not bool((err <= rtol * b.float().abs() + atol).all()):
                raise AssertionError(f"flash attention {case}: {name} "
                                     f"disagrees with the plain version "
                                     f"(max |err| {errs[name]:.3e})")
        delta = fa._delta(out, do)
        ms = {
            "fwd": cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw)),
            "dq": cuda_time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, out, lse, do, delta=delta, **kw)),
            "dkv": cuda_time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, out, lse, do, delta=delta, **kw)),
        }
        plain_ms = {
            "fwd": cuda_time_ms(lambda: fa.flash_attention_plain(
                q, k, v, **kw), reps=5, warmup=1),
            # the plain backward computes dQ, dK and dV together: it is
            # the plain version of both K2 kernels
            "dq": cuda_time_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, lse, do, **kw), reps=5, warmup=1),
        }
        plain_ms["dkv"] = plain_ms["dq"]
        library_ms = {"fwd": None, "dq": None, "dkv": None}
        if window is None and Tq == Tk:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            library_ms["fwd"] = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal)
            dot = do.transpose(1, 2).contiguous()
            library_ms["dq"] = library_ms["dkv"] = cuda_time_ms(
                lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                            retain_graph=True))
            del lib_out, qt, kt, vt
        bounds = flash_bounds(case)
        results[case] = {
            part: dict(max_abs_err=max(errs[n] for n in names), ms=ms[part],
                       plain_ms=plain_ms[part], bound_ms=bounds[part][0],
                       bound_by=bounds[part][1],
                       library_ms=library_ms[part])
            for part, names in (("fwd", ("out", "lse")), ("dq", ("dq",)),
                                ("dkv", ("dk", "dv")))}
        log(f"parity flash_attention {case} (B {B} H {H} Tq {Tq} Tk {Tk} "
            f"D {D} {str(dtype)[6:]} causal {causal} window {window}): "
            f"ok max_abs_err " + " ".join(f"{n}={e:.3e}"
                                          for n, e in errs.items())
            + f" (tolerance {rtol:g}*|plain|+{atol:g}) | " + " | ".join(
                f"{part} kernel_ms={r['ms']:.4f} plain_ms="
                f"{r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) library_ms={r['library_ms']}"
                for part, r in results[case].items()))
        del q, k, v, do, out, lse, dq, dk, dv, ref, pairs
    return results, check_masked_flash_attention()


# ---------------------------------------------------------------------------
# kernel K9: block-sparse attention forward, dQ, dK/dV
# ---------------------------------------------------------------------------

def sparse_config(name, H, block):
    """The long-context layouts of the JAX package's
    ``tools/bench_longctx.py`` (BSLongformer window 7 + global block 0,
    BigBird 3 random + window 3 + 1 global), and a per-head Fixed one."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    if name == "bslongformer":
        return sa.BSLongformerSparsityConfig(
            num_heads=H, block=block, num_sliding_window_blocks=7,
            global_block_indices=[0])
    if name == "bigbird":
        return sa.BigBirdSparsityConfig(
            num_heads=H, block=block, num_random_blocks=3,
            num_sliding_window_blocks=3, num_global_blocks=1)
    return sa.FixedSparsityConfig(
        num_heads=H, block=block, num_local_blocks=4, num_global_blocks=1,
        different_layout_per_head=True, num_different_global_patterns=2)


# the long-context path: Llama-3-8B's 32 query heads of 128, block 128
SPARSE_MAIN = "bslongformer_t16384"
SPARSE_CASES = {
    # name: (B, T, H, D, dtype, block, layout, causal)
    SPARSE_MAIN: (1, 16384, H, D, torch.bfloat16, 128, "bslongformer", True),
    "bigbird_t16384": (1, 16384, H, D, torch.bfloat16, 128, "bigbird", True),
    "bslongformer_t4096": (1, 4096, H, D, torch.bfloat16, 128,
                           "bslongformer", True),
    "bigbird_t8192": (1, 8192, H, D, torch.bfloat16, 128, "bigbird", True),
    "fp32_d64_block64": (2, 2048, 8, 64, torch.float32, 64, "bigbird", True),
    "bigbird_noncausal_t4096": (1, 4096, H, D, torch.bfloat16, 128,
                                "bigbird", False),
    "fixed_per_head_t4096": (1, 4096, H, D, torch.bfloat16, 128,
                             "fixed_per_head", True),
}
# FlexAttention (compiled) is timed at the main width only: one compile
SPARSE_FLEX = (SPARSE_MAIN, "bigbird_t16384")


def sparse_pairs(layout, block, causal):
    """(query, key) pairs per batch row that the (causally cut) layout
    lets through: a diagonal block holds block (block + 1) / 2 of them."""
    layout = np.asarray(layout) != 0
    n = int(layout.sum())
    if not causal:
        return n * block * block
    diag = int(np.trace(layout, axis1=1, axis2=2).sum())
    return (n - diag) * block * block + diag * block * (block + 1) // 2


def sparse_bounds(B, T, Hh, Dh, dtype, layout, block, causal):
    """Bound of K9 fwd, dq and dkv: each input read once, each output
    written once; FLOPs over the pairs the layout lets through (4 D each
    for the forward, 6 D for dQ, 8 D for dK/dV), at the type's peak."""
    e = torch.tensor([], dtype=dtype).element_size()
    x, row = B * T * Hh * Dh * e, B * Hh * T * 4
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    f1 = 4 * Dh * B * sparse_pairs(layout, block, causal)
    return {"fwd": bound(4 * x + row, f1, rate),
            "dq": bound(5 * x + 2 * row, 1.5 * f1, rate),
            "dkv": bound(6 * x + 2 * row, 2 * f1, rate)}


def sparse_library(q, k, v, do, out, layout, block, causal, flex):
    """Yardstick times ``{part: ms}`` of one PyTorch call for the same
    function: SDPA with the layout's boolean mask (``[1, 1, T, T]`` when
    every head has the same layout), and with ``flex`` FlexAttention on a
    ``BlockMask`` built from the layout's lists, compiled, its first call
    excluded, its output held against the kernel's ``out``. A yardstick
    that does not run is recorded as None with its error: the port never
    calls either."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    T = q.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    res = {}
    same = bool((layout == layout[:1]).all())
    seen = torch.as_tensor((layout[:1] if same else layout) != 0,
                           device="cuda")
    mask = seen.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        mask &= torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
    mask = mask[None]
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            res["sdpa_fwd"] = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask),
                reps=5)
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask)
            res["sdpa_bwd"] = cuda_time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dot, retain_graph=True), reps=5)
        del lib_out
    except Exception as err:  # a yardstick only: recorded, never gating
        log(f"  sdpa yardstick did not run: {type(err).__name__}: "
            f"{str(err)[:300]}")
    del mask
    if flex:
        try:
            res.update(flex_times(qt, kt, vt, dot, out, layout, block,
                                  causal))
        except Exception as err:  # a yardstick only: recorded, never gating
            log(f"  flex_attention yardstick did not run: "
                f"{type(err).__name__}: {str(err)[:500]}")
    return res


def flex_times(qt, kt, vt, dot, want, layout, block, causal):
    """FlexAttention forward and backward on ``[B, H, T, D]`` tensors with
    a BlockMask from the layout: blocks below the diagonal are full, the
    diagonal block (causal) is partial; the ``mask_mod`` reads the layout
    too, so that the function does not depend on how the blocks are
    visited. Its
    output must agree with ``want`` (the kernel's ``[B, T, H, D]`` out) to
    K1's bf16 tolerance, or the yardstick is not the same function."""
    import torch._functorch.config as functorch_config
    from torch.nn.attention.flex_attention import BlockMask, flex_attention

    # the timed backward runs with retain_graph, which donated buffers
    # forbid
    functorch_config.donated_buffer = False

    B, Hh, T, _ = qt.shape
    nb = T // block
    lay = torch.as_tensor(np.asarray(layout) != 0, device="cuda")
    diag = torch.eye(nb, dtype=torch.bool, device="cuda")[None]
    full, part = (lay & ~diag, lay & diag) if causal else \
        (lay, torch.zeros_like(lay))

    def lists(m):
        cnt = m.sum(-1).to(torch.int32)
        idx = torch.argsort((~m).to(torch.int8), dim=-1, stable=True)
        return (cnt[None].expand(B, -1, -1).contiguous(),
                idx.to(torch.int32)[None].expand(B, -1, -1, -1).contiguous())

    def layout_mod(b, h, q_idx, kv_idx):
        seen = lay[h, q_idx // block, kv_idx // block]
        return seen & (q_idx >= kv_idx) if causal else seen

    kv_num, kv_idx = lists(part)
    full_num, full_idx = lists(full)
    bm = BlockMask.from_kv_blocks(kv_num, kv_idx, full_num, full_idx,
                                  BLOCK_SIZE=block, mask_mod=layout_mod)
    flex = torch.compile(flex_attention, dynamic=False)
    t = time.perf_counter()
    out = flex(qt, kt, vt, block_mask=bm)
    torch.autograd.grad(out, (qt, kt, vt), dot)
    torch.cuda.synchronize()
    err = (out.transpose(1, 2).float() - want.float()).abs()
    log(f"  flex_attention compiled (forward + backward) in "
        f"{time.perf_counter() - t:.1f} s; max |flex - kernel| "
        f"{float(err.max()):.3e}")
    if not bool((err <= 2 ** -7 * want.float().abs() + 2e-2).all()):
        raise ValueError("flex_attention's BlockMask computes another "
                         "function than the layout")
    res = {"flex_fwd": cuda_time_ms(lambda: flex(qt, kt, vt, block_mask=bm),
                                    reps=10)}
    out = flex(qt, kt, vt, block_mask=bm)
    res["flex_bwd"] = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), reps=10)
    return res


def work_list_summary(walks, block):
    """A ``_Walks``' work list in words: its items (one block each per
    64-row slice and batch row), how many of them belong to split walks,
    and the longest item in 64-row tiles."""
    split = int((walks.work[:, 4] >= 0).sum())
    return (f"{walks.work.shape[0]} items ({split} split), longest "
            f"{walks.longest * block // 64} tiles")


def check_block_sparse_attention():
    """K9 forward, dQ and dK/dV against their plain versions on the same
    inputs (the backward ones from the kernel's out and lse), head by head
    (one head's dense fp32 scores at T 16384 are 1 GiB), which computes
    the same function. Tolerance: fp32 2e-5; bf16 2**-7 |plain| + 2e-2,
    as K1's. Times (the plain version once: the head-by-head loop), the
    bound over the pairs the layout lets through, and the yardsticks of
    ``sparse_library``."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    results = {}
    for case, (B, T, Hh, Dh, dtype, block, name, causal) in \
            SPARSE_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(len(results) + 91)
        q, k, v, do = (torch.randn(B, T, Hh, Dh, generator=g, device="cuda",
                                   dtype=dtype) for _ in range(4))
        layout = bsa._causal_layout(
            sparse_config(name, Hh, block).make_layout(T), causal)
        args = (layout, block, causal)
        out, lse = bsa.block_sparse_attention_fwd(q, k, v, *args)
        dq = bsa.block_sparse_attention_bwd_dq(q, k, v, out, lse, do, *args)
        dk, dv = bsa.block_sparse_attention_bwd_dkv(q, k, v, out, lse, do,
                                                    *args)
        got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        ref = {n: torch.empty_like(t) for n, t in got.items()}
        plain_ms = {}
        for part in ("fwd", "dq", "dkv"):
            a, b = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            for h in range(Hh):
                hs = slice(h, h + 1)
                qh, kh, vh, oh, doh = (t[:, :, hs] for t in (q, k, v, out, do))
                lh, hargs = lse[:, hs], (layout[hs], block, causal)
                if part == "fwd":
                    ref["out"][:, :, hs], ref["lse"][:, hs] = \
                        bsa.block_sparse_attention_fwd_plain(qh, kh, vh,
                                                             *hargs)
                elif part == "dq":
                    ref["dq"][:, :, hs] = \
                        bsa.block_sparse_attention_bwd_dq_plain(
                            qh, kh, vh, oh, lh, doh, *hargs)
                else:
                    ref["dk"][:, :, hs], ref["dv"][:, :, hs] = \
                        bsa.block_sparse_attention_bwd_dkv_plain(
                            qh, kh, vh, oh, lh, doh, *hargs)
            b.record()
            b.synchronize()
            plain_ms[part] = a.elapsed_time(b)
        fp32 = dtype == torch.float32
        rtol, atol = (2e-5, 2e-5) if fp32 else (2 ** -7, 2e-2)
        errs = {}
        for n in got:
            x, y = got[n].float(), ref[n].float()
            err = (x - y).abs()
            errs[n] = float(err.max())
            tol = (1e-5, 1e-4) if n == "lse" else (rtol, atol)
            if not bool((err <= tol[0] * y.abs() + tol[1]).all()):
                raise AssertionError(f"block-sparse attention {case}: {n} "
                                     f"disagrees with the plain version "
                                     f"(max |err| {errs[n]:.3e})")
        del ref
        delta = bsa._delta(out, do)
        ms = {
            "fwd": cuda_time_ms(
                lambda: bsa.block_sparse_attention_fwd(q, k, v, *args)),
            "dq": cuda_time_ms(lambda: bsa.block_sparse_attention_bwd_dq(
                q, k, v, out, lse, do, *args, delta=delta)),
            "dkv": cuda_time_ms(lambda: bsa.block_sparse_attention_bwd_dkv(
                q, k, v, out, lse, do, *args, delta=delta)),
        }
        lib = sparse_library(q, k, v, do, out, layout, block, causal,
                             case in SPARSE_FLEX)
        bounds = sparse_bounds(B, T, Hh, Dh, dtype, *args)
        _, cnt = bsa.layout_indices(layout)
        _, qcnt = bsa.layout_indices(np.swapaxes(layout, 1, 2))
        walks = bsa._indices(layout, causal, q.device)
        results[case] = {}
        for part, names in (("fwd", ("out", "lse")), ("dq", ("dq",)),
                            ("dkv", ("dk", "dv"))):
            kind = "fwd" if part == "fwd" else "bwd"
            results[case][part] = dict(
                max_abs_err=max(errs[n] for n in names), ms=ms[part],
                plain_ms=plain_ms[part], bound_ms=bounds[part][0],
                bound_by=bounds[part][1],
                library_ms=lib.get(f"flex_{kind}", lib.get(f"sdpa_{kind}")),
                flex_ms=lib.get(f"flex_{kind}"),
                sdpa_ms=lib.get(f"sdpa_{kind}"))
        log(f"parity block_sparse_attention {case} (B {B} T {T} H {Hh} D {Dh} "
            f"{str(dtype)[6:]} block {block} {name} causal {causal}; block "
            f"degree mean {cnt.mean():.2f} max {cnt.max()}, transposed max "
            f"{qcnt.max()}; {sparse_pairs(layout, block, causal)} pairs per "
            f"batch row; bf16 work lists, C {bsa.SPLIT_BLOCKS} blocks: "
            + ", ".join(f"{kind} {work_list_summary(w, block)}" for kind, w
                        in zip(("rows", "columns"), walks))
            + "): ok max_abs_err " + " ".join(
                f"{n}={e:.3e}" for n, e in errs.items())
            + f" (tolerance {rtol:g}*|plain|+{atol:g}) | " + " | ".join(
                f"{part} kernel_ms={r['ms']:.4f} plain_ms="
                f"{r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) flex_ms={r['flex_ms']} "
                f"sdpa_ms={r['sdpa_ms']}"
                for part, r in results[case].items()))
        del q, k, v, do, out, lse, dq, dk, dv, got, delta
        gc.collect()
        torch.cuda.empty_cache()
    return results


def host_ms(fn, reps=20):
    """Median host ms of ``fn()`` (no gradient) from an idle device to the
    return of its last launch: what a caller's thread spends per call."""
    times = []
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    return statistics.median(times)


LONGCTX_T = (4096, 8192, 16384)
LONGCTX_LAYOUTS = ("bslongformer", "bigbird")


def causal_block_fraction(layout):
    """Share of the causal block grid the layout keeps, as
    ``tools/bench_longctx.py`` counts it: the ceiling of the speedup over
    a causal flash kernel that already skips the upper triangle."""
    nb = layout.shape[-1]
    tril = np.tril(np.ones((nb, nb), bool))
    return float((np.asarray(layout, bool) & tril[None]).sum()) / \
        float(tril.sum() * layout.shape[0])


def check_long_context():
    """The long-context path, a twin of ``tools/bench_longctx.py`` on the
    port: ``sparse_attention`` (bf16, B 1, H 32, D 128, causal, block 128)
    at T 4096, 8192 and 16384 with both layouts, one forward and one
    backward each (loss ``(out * dout).sum()``), beside causal
    ``flash_attention`` (K1/K2) on the same q/k/v. Asserts finite
    gradients and exact launch counts (K9: 6 of each; K1 forward and K2:
    one per yardstick call), then times both forward and backward, and
    the host time of one ``sparse_attention`` forward call. Returns the K9
    launches."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention

    k9 = (bsa.block_sparse_attention_fwd, bsa.block_sparse_attention_bwd_dq,
          bsa.block_sparse_attention_bwd_dkv)
    k12 = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
           fa.flash_attention_bwd_dkv)

    def inputs(T):
        g = torch.Generator(device="cuda").manual_seed(T)
        return [torch.randn(1, T, H, D, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(4)]

    def fwd_bwd(fn, q, k, v, do):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        (fn(*leaves) * do).sum().backward()
        return [t.grad for t in leaves]

    for f in k9 + k12:
        f.launches = 0
    flash_calls = 0
    for T in LONGCTX_T:
        q, k, v, do = inputs(T)
        for name in LONGCTX_LAYOUTS:
            cfg = sparse_config(name, H, 128)
            grads = fwd_bwd(lambda *x: sparse_attention(
                *x, sparsity_config=cfg, causal=True), q, k, v, do)
            if not all(bool(torch.isfinite(g).all()) for g in grads):
                raise AssertionError(f"long context T {T} {name}: a "
                                     f"gradient is not finite")
        grads = fwd_bwd(lambda *x: fa.flash_attention(*x, causal=True),
                        q, k, v, do)
        flash_calls += 1
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"long context T {T} flash: a gradient is "
                                 f"not finite")
        del q, k, v, do, grads
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in k9 + k12}
    runs = len(LONGCTX_T) * len(LONGCTX_LAYOUTS)
    want = {**{f.__name__: runs for f in k9},
            **{f.__name__: flash_calls for f in k12}}
    if launches != want:
        raise AssertionError(f"long context: launches {launches} != {want}")
    log(f"long context: {runs} sparse_attention forward + backward runs, "
        f"{flash_calls} flash yardsticks, launches {launches}")

    for T in LONGCTX_T:
        q, k, v, do = inputs(T)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        reps = 25 if T < 16384 else 5

        def times(fn):
            with torch.no_grad():
                fwd = cuda_time_ms(lambda: fn(q, k, v), reps=reps)
            out = fn(*leaves)
            bwd = cuda_time_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), reps=reps)
            return fwd, bwd

        flash_ms, flash_bwd_ms = times(
            lambda *x: fa.flash_attention(*x, causal=True))
        rec = {"metric": "longctx_attention", "seq": T, "heads": H,
               "head_dim": D, "flash_ms": flash_ms,
               "flash_bwd_ms": flash_bwd_ms, "layouts": {}}
        for name in LONGCTX_LAYOUTS:
            cfg = sparse_config(name, H, 128)
            frac = causal_block_fraction(cfg.make_layout(T))
            sparse_ms, sparse_bwd_ms = times(lambda *x: sparse_attention(
                *x, sparsity_config=cfg, causal=True))
            rec["layouts"][name] = {
                "sparse_ms": sparse_ms, "sparse_bwd_ms": sparse_bwd_ms,
                "sparse_host_ms": host_ms(lambda: sparse_attention(
                    q, k, v, sparsity_config=cfg, causal=True)),
                "sparse_speedup_vs_flash": flash_ms / sparse_ms,
                "sparse_bwd_speedup_vs_flash": flash_bwd_ms / sparse_bwd_ms,
                "causal_nnz_fraction": frac,
                "theoretical_speedup": 1.0 / frac,
                "realization": flash_ms / sparse_ms * frac,
                "bwd_realization": flash_bwd_ms / sparse_bwd_ms * frac}
        log("long context " + json.dumps(rec))
        del q, k, v, do, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return {f.__name__: launches[f.__name__] for f in k9}


# ---------------------------------------------------------------------------
# kernel K3: fused Adam
# ---------------------------------------------------------------------------

def adam_state(cfg, seed):
    """``(params, grads, m, v)`` lists of fp32 tensors shaped like the
    model's parameters, seeded."""
    from deepspeed_tpu_torch.models import LlamaForCausalLM

    shapes = [p.shape for p in LlamaForCausalLM(cfg).state_dict().values()]
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = [torch.randn(s, generator=g, device="cuda") * 0.02
              for s in shapes]
    grads = [torch.randn(s, generator=g, device="cuda") * 1e-3
             for s in shapes]
    return params, grads, [torch.zeros_like(p) for p in params], \
        [torch.zeros_like(p) for p in params]


def check_fused_adam():
    """K3 over the whole Llama-400M parameter list, 3 steps with a device
    clip factor, the step's scalars (``alpha``) and a clear skip flag in
    device memory, in both decay modes, against the plain version on
    copies; then one step with the flag set must leave every tensor
    bit-identical. Tolerance: 1e-6 relative + 1e-7 absolute (the kernel fuses
    multiply-adds that the plain version rounds twice: about one fp32 ulp
    a step). Times one step of each, and torch.optim.AdamW(fused=True)
    on the same tensors as the yardstick."""
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam, fused_adam_plain

    cfg = LlamaConfig.llama_400m()
    b1, b2, eps, wd, lr = 0.9, 0.999, 1e-8, 0.1, 1e-4
    scale = torch.tensor(0.5, device="cuda")

    skip = torch.tensor(False, device="cuda")

    def hyper(t, adam_w_mode):
        alpha = torch.tensor([lr / (1 - b1 ** t), lr,
                              1 / (1 - b2 ** t) ** 0.5], device="cuda")
        return dict(b1=b1, b2=b2, eps=eps, weight_decay=wd,
                    adam_w_mode=adam_w_mode, alpha=alpha, skip=skip,
                    grad_scale=scale)

    max_err = 0.0
    for adam_w_mode in (True, False):
        state = adam_state(cfg, seed=1)
        ref = [[t.clone() for t in lst] for lst in state]
        for t in range(1, 4):
            fused_adam(*state, **hyper(t, adam_w_mode))
            fused_adam_plain(*ref, **hyper(t, adam_w_mode))
        torch.cuda.synchronize()
        for got, want in zip(state, ref):
            for a, b in zip(got, want):
                err = (a - b).abs()
                max_err = max(max_err, float(err.max()))
                if not bool((err <= 1e-6 * b.abs() + 1e-7).all()):
                    raise AssertionError(
                        f"fused_adam (adam_w_mode={adam_w_mode}) disagrees "
                        f"with its plain version (max |err| "
                        f"{float(err.max()):.3e})")
        kept = [[t.clone() for t in lst] for lst in state]
        skip.fill_(True)
        fused_adam(*state, **hyper(4, adam_w_mode))
        skip.fill_(False)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for lst, old in zip(state, kept)
                   for a, b in zip(lst, old)):
            raise AssertionError(f"fused_adam (adam_w_mode={adam_w_mode}) "
                                 f"changed a tensor with skip set")
        del state, ref, kept
    params, grads, m, v = adam_state(cfg, seed=2)
    n = sum(p.numel() for p in params)
    kw = hyper(4, True)
    table = fused_adam(params, grads, m, v, **kw)
    ms = cuda_time_ms(lambda: fused_adam(params, grads, m, v, **kw,
                                         table=table))
    plain_ms = cuda_time_ms(lambda: fused_adam_plain(params, grads, m, v,
                                                     **kw), reps=5, warmup=1)
    # the same function in one PyTorch call (no clip factor: the grads
    # stand for already-clipped ones)
    for p, gr in zip(params, grads):
        p.grad = gr
    lib = torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=wd, fused=True)
    library_ms = cuda_time_ms(lib.step)
    # 16 bytes read (p, g, m, v) and 12 written (p, m, v) per element;
    # ~15 fp32 operations per element
    bound_ms, bound_by = bound(28 * n, 15 * n, FP32_FLOP_PER_S)
    log(f"parity fused_adam: llama_400m list ({len(params)} tensors, {n} "
        f"elements), 3 steps x both decay modes, then a skipped step (bit-"
        f"identical): ok max_abs_err="
        f"{max_err:.3e} (tolerance 1e-6*|plain|+1e-7) | kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}) "
        f"library_ms={library_ms:.4f}")
    del params, grads, m, v, lib
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# kernel K4: decode attention over the contiguous cache
# ---------------------------------------------------------------------------

# the generate step's attention: Llama-3-8B heads, batch 8, prompts
# bucketed to 512 plus 64 new tokens
GEN_B, GEN_PROMPT, GEN_NEW = 8, 512, 64
DECODE_MAIN = "c575"
DECODE_CASES = {
    # name: (B, H, Hkv, S, D, dtype, int8 cache, window, cache_index)
    "c0": (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D, torch.bfloat16, False,
           None, 0),
    "c15": (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D, torch.bfloat16, False,
            None, 15),
    "c300": (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D, torch.bfloat16, False,
             None, 300),
    DECODE_MAIN: (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D, torch.bfloat16,
                  False, None, 575),
    "int8_c575": (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D, torch.bfloat16,
                  True, None, 575),
    "window256_c575": (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D,
                       torch.bfloat16, False, 256, 575),
    "fp32_d64_g1_c777": (4, 8, 8, 1000, 64, torch.float32, False, None, 777),
    # longer caches, the cache index near their end
    "c2040_s2048": (GEN_B, H, HKV, 2048, D, torch.bfloat16, False, None,
                    2040),
    "c8180_s8192": (GEN_B, H, HKV, 8192, D, torch.bfloat16, False, None,
                    8180),
}


def decode_case(B, Hq, Hkv, S, Dh, dtype, int8, seed):
    """q, caches and a key mask with seeded left-padding holes (each row's
    first 0-199 positions masked)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Hq, Dh), generator=g, device="cuda", dtype=dtype)
    shape = (B, Hkv, S, Dh)
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                              dtype=torch.int8) for _ in range(2))
        scales = {n: torch.rand(shape[:3], generator=g, device="cuda") / 64
                  for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(shape, generator=g, device="cuda", dtype=dtype)
                for _ in range(2))
        scales = {}
    pads = np.random.RandomState(seed).randint(0, 200, B)
    mask = (np.arange(S)[None] >= pads[:, None]).astype(np.int32)
    return q, k, v, torch.from_numpy(mask).cuda(), scales


def decode_bound(mask, Hq, Hkv, Dh, elem, int8, window, cidx, q_elem):
    """``(ms, "bytes" | "operations")``: the K/V (and scales) of the keys
    each row can see (inside the filled prefix or window and not masked)
    read once per kv head, the mask's prefix, q and the output, over HBM
    bandwidth; 4 D FLOPs per (query head, visible key) at the bf16 peak."""
    B, S = mask.shape
    hi = min(cidx, S - 1)
    lo = 0 if window is None else max(0, cidx - window + 1)
    prefix = max(0, hi - lo + 1)
    keys = int((mask[:, lo:hi + 1] > 0).sum()) if prefix else 0
    nbytes = Hkv * keys * (2 * Dh * elem + (8 if int8 else 0)) \
        + B * prefix * 4 + 2 * B * Hq * Dh * q_elem
    return bound(nbytes, 4 * Hq * Dh * keys, BF16_FLOP_PER_S)


def check_decode_attention():
    """K4 against its plain version. Tolerance: fp32 1e-5 (summation
    order only); bf16 |kernel - plain| <= 2**-7 * |plain| + 1e-3 (both are
    bf16 roundings of fp32 results that differ only in summation order:
    one bf16 ulp). Library yardstick: SDPA over the filled prefix with a
    boolean key mask and enable_gqa, for the bf16 cases without a window
    or int8 cache."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.decode_attention import (
        _sm_count, decode_attention, decode_attention_plain, decode_splits)

    results = {}
    for name, (B, Hq, Hkv, S, Dh, dtype, int8, window, cidx) in \
            DECODE_CASES.items():
        q, k, v, mask, scales = decode_case(B, Hq, Hkv, S, Dh, dtype, int8,
                                            seed=len(results) + 11)
        ci = torch.tensor(cidx, dtype=torch.int32, device="cuda")
        kw = dict(key_mask=mask, window=window, **scales)
        got = decode_attention(q, k, v, ci, **kw)
        ref = decode_attention_plain(q, k, v, ci, **kw)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else \
            (2 ** -7, 1e-3)
        if not bool((err <= rtol * ref.float().abs() + atol).all()):
            raise AssertionError(f"decode_attention {name} disagrees with "
                                 f"its plain version (max |err| "
                                 f"{float(err.max()):.3e})")
        ms = cuda_time_ms(lambda: decode_attention(q, k, v, ci, **kw))
        plain_ms = cuda_time_ms(
            lambda: decode_attention_plain(q, k, v, ci, **kw), reps=5,
            warmup=1)
        library_ms = None
        if dtype == torch.bfloat16 and window is None and not int8:
            n = min(cidx, S - 1) + 1
            q4 = q[:, :, None]
            kf, vf = k[:, :, :n], v[:, :, :n]
            am = (mask[:, :n] > 0)[:, None, None, :]
            library_ms = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(
                    q4, kf, vf, attn_mask=am, enable_gqa=True))
        bms, by = decode_bound(mask, Hq, Hkv, Dh, k.element_size(), int8,
                               window, cidx, q.element_size())
        results[name] = dict(max_abs_err=float(err.max()), ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             library_ms=library_ms)
        splits = decode_splits(B, Hkv, S, _sm_count(0))
        log(f"parity decode_attention {name} (B {B} H {Hq} Hkv {Hkv} S {S} "
            f"D {Dh} {str(dtype)[6:]} int8 {int8} window {window} "
            f"cache_index {cidx}, {splits} splits): ok max_abs_err="
            f"{float(err.max()):.3e} "
            f"(tolerance {rtol:g}*|plain|+{atol:g}) | kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.4f} ({by}) "
            f"library_ms={library_ms}")
        del q, k, v, mask, scales, got, ref
    return results


# ---------------------------------------------------------------------------
# kernels K5 and K8: quantized matmuls
# ---------------------------------------------------------------------------

# Llama-3-8B projections: gate/up (4096 -> 14336), down (14336 -> 4096),
# q/o (4096 -> 4096); decode M = batch 8, prefill M = 8 x 512
QUANT_MAIN = "decode_up_int8"
QUANT_PREFILL_MAIN = "prefill_q_int8"
QUANT_CASES = {
    # name: (M, K, N, mode, group, dtype)
    "decode_up_int8": (8, 4096, 14336, "int8", 0, torch.bfloat16),
    "decode_up_int4g64": (8, 4096, 14336, "int4", 64, torch.bfloat16),
    "decode_down_int8": (8, 14336, 4096, "int8", 0, torch.bfloat16),
    "decode_down_int4g64": (8, 14336, 4096, "int4", 64, torch.bfloat16),
    "decode_q_int8": (8, 4096, 4096, "int8", 0, torch.bfloat16),
    "decode_q_int4g64": (8, 4096, 4096, "int4", 64, torch.bfloat16),
    "decode_kv_int8": (8, 4096, 1024, "int8", 0, torch.bfloat16),
    "decode_kv_int4g64": (8, 4096, 1024, "int4", 64, torch.bfloat16),
    "decode_up_int8_m1": (1, 4096, 14336, "int8", 0, torch.bfloat16),
    "prefill_q_int8": (4096, 4096, 4096, "int8", 0, torch.bfloat16),
    "prefill_q_int4g64": (4096, 4096, 4096, "int4", 64, torch.bfloat16),
    "prefill_up_int8": (4096, 4096, 14336, "int8", 0, torch.bfloat16),
    "prefill_down_int8": (4096, 14336, 4096, "int8", 0, torch.bfloat16),
    "prefill_up_int4g64": (4096, 4096, 14336, "int4", 64, torch.bfloat16),
    "fp32_m8_int4g64": (8, 4096, 4096, "int4", 64, torch.float32),
    "fp32_m300_int8g128": (300, 4096, 1024, "int8", 128, torch.float32),
    "ragged_m8_int4g8": (8, 264, 1000, "int4", 8, torch.bfloat16),
    "ragged_m37_int8": (37, 264, 1000, "int8", 0, torch.bfloat16),
    # rows TMA cannot address at widths where bytes (decode) and operations
    # (prefill, 41 groups of 100 rows) bound the ragged kernel
    "ragged_wide_m8_int8": (8, 4100, 14330, "int8", 0, torch.bfloat16),
    "ragged_wide_m512_int4g100": (512, 4100, 14330, "int4", 100,
                                  torch.bfloat16),
    # the fp32 decode (gemv_tf32) at per-column int8 and at an odd N (code
    # rows through cp.async windows, not TMA)
    "fp32_m8_int8": (8, 4096, 4096, "int8", 0, torch.float32),
    "fp32_m8_int4g64_n4099": (8, 4096, 4099, "int4", 64, torch.float32),
}
# the fp32 decode's entry of the kernels line
GEMV_TF32_MAIN = "fp32_m8_int4g64"
# the ragged kernel's entries of the kernels line (decode: M <= 8, prefill:
# M > 8), each held at its wide case
RAGGED_MAIN = {"decode": "ragged_wide_m8_int8",
               "prefill": "ragged_wide_m512_int4g100"}
INT8_COL_MAIN = "decode_up"
INT8_COL_CASES = {
    # name: (M, K, N, dtype)
    "decode_up": (8, 4096, 14336, torch.bfloat16),
    "decode_down": (8, 14336, 4096, torch.bfloat16),
    "prefill_q": (4096, 4096, 4096, torch.bfloat16),
    "prefill_up": (4096, 4096, 14336, torch.bfloat16),
    "ragged_m37_fp32": (37, 264, 1000, torch.float32),
    "ragged_wide_m8": (8, 4100, 14330, torch.bfloat16),
    "fp32_m8": (8, 4096, 4096, torch.float32),
}


def _matmul_tolerance(x, w, dtype):
    """Per-element bound on |kernel - plain|: a reordered fp32 sum of K
    products errs by far less than 1e-5 of the sum of their magnitudes
    (|x| @ |W|); a bf16 output adds one bf16 ulp (2**-7 |plain|), as both
    sides round nearly equal fp32 sums."""
    mag = x.float().abs() @ w.float().abs()
    return mag * 1e-5, 2 ** -7 if dtype == torch.bfloat16 else 0.0


def _quant_route(qm, M, K, N, mode, dtype):
    """The route a quantized matmul takes, with the gemv_tc kernel's column
    tiles and cluster size, the ragged kernel's row and column tiles and
    cluster size, or the fp32 route's grid and K splits, on this card."""
    route = qm.kernel_route(M, K, N, dtype)
    if route == "gemv_tc":
        tiles, cluster = qm.gemv_tc_grid(K, N, mode, qm._sm_count(0))
        route += f" {tiles} tiles x cluster {cluster}"
    elif route == "ragged":
        mt, wn, ct, rt, cluster = qm.ragged_grid(M, K, N, qm._sm_count(0))
        route += (f" {rt} x {ct} tiles of {8 * mt} rows x "
                  f"{qm.ragged_warp_cols(mt) * wn} columns x cluster "
                  f"{cluster}")
    elif route == "fp32":
        grid = qm.fp32_grid(M, K, N, qm._sm_count(0))
        route += (f" tensor cores (x as two TF32 parts), grid {grid}, "
                  f"{grid[2]} K splits")
    elif route == "gemv_tf32":
        tiles, cluster = qm.gemv_tf32_grid(K, N, qm._sm_count(0))
        route += (f" tensor cores (x as two TF32 parts), {tiles} tiles x "
                  f"cluster {cluster}, codes by "
                  f"{'TMA' if N % 16 == 0 and K % 4 == 0 else 'cp.async'}")
    return route


def _matmul_bound(qm, M, K, N, dtype, nbytes):
    """``(ms, by, note)``: the bound of a quantized matmul for the
    arithmetic its route runs. bf16: 2 M K N operations at the bf16 peak.
    fp32 (both routes, M > 8 and the decode) runs every product twice on
    the tensor cores (x as two TF32 parts): 4 M K N at the TF32 peak, with
    the CUDA-core bound of 2 M K N at the fp32 peak in ``note``."""
    flops = 2 * M * K * N
    if dtype == torch.bfloat16:
        return (*bound(nbytes, flops, BF16_FLOP_PER_S), "")
    cuda_core = bound(nbytes, flops, FP32_FLOP_PER_S)[0]
    return (*bound(nbytes, 2 * flops, TF32_FLOP_PER_S),
            f" (CUDA-core bound {cuda_core:.4f})")


def check_graph_replay(call, plain, x, tol, name, g):
    """A CUDA graph captured around ``call(x)``, replayed over two new x
    values written into the captured input, must match ``plain`` within
    ``tol(x)`` each time (the launch reads no device value and allocates
    nothing outside the graph)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call(x)
    for _ in range(2):
        x.copy_(torch.randn(x.shape, generator=g, device="cuda",
                            dtype=x.dtype))
        graph.replay()
        ref = plain(x)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= tol(x)).all()):
            raise AssertionError(f"{name}: the CUDA-graph replay disagrees "
                                 f"with the plain version (max |err| "
                                 f"{float(err.max()):.3e})")
    del graph


def check_quant_matmul():
    """K5 against its plain version at Llama-3-8B projection shapes (and
    fp32, ragged cases), then K8 likewise. Library yardstick: torch.matmul
    on the pre-dequantized weight in x's type (it reads 2x the int8 or 4x
    the int4 weight bytes)."""
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    results = {}
    for name, (M, K, N, mode, group, dtype) in QUANT_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(len(results) + 21)
        x = torch.randn((M, K), generator=g, device="cuda", dtype=dtype)
        w = torch.randn((K, N), generator=g, device="cuda") * 0.02
        codes, scale = qm.quantize_linear_weight(w, mode, group)
        del w
        ragged = qm.quant_matmul.ragged_launches
        got = qm.quant_matmul(x, codes, scale, mode)
        ragged = qm.quant_matmul.ragged_launches - ragged
        if ragged != int(qm.kernel_route(M, K, N, dtype) == "ragged"):
            raise AssertionError(f"quant_matmul {name}: {ragged} ragged "
                                 f"kernel launches")
        ref = qm.quant_matmul_plain(x, codes, scale, mode)
        wd = qm.dequantize_linear_weight(codes, scale, mode, dtype)
        abs_tol, rel = _matmul_tolerance(x, wd, dtype)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= rel * ref.float().abs() + abs_tol).all()):
            raise AssertionError(f"quant_matmul {name} disagrees with its "
                                 f"plain version (max |err| "
                                 f"{float(err.max()):.3e})")
        del abs_tol
        replay = ""
        if qm.kernel_route(M, K, N, dtype) == "gemv_tf32":
            check_graph_replay(
                lambda xx: qm.quant_matmul(xx, codes, scale, mode),
                lambda xx: qm.quant_matmul_plain(xx, codes, scale, mode),
                x.clone(), lambda xx: _matmul_tolerance(xx, wd, dtype)[0],
                f"quant_matmul {name}", g)
            replay = ", CUDA-graph replay ok"
        ms = cuda_time_ms(lambda: qm.quant_matmul(x, codes, scale, mode))
        plain_ms = cuda_time_ms(
            lambda: qm.quant_matmul_plain(x, codes, scale, mode), reps=5,
            warmup=1)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, wd))
        nbytes = codes.numel() + scale.numel() * 4 \
            + (M * K + M * N) * x.element_size()
        bms, by, note = _matmul_bound(qm, M, K, N, dtype, nbytes)
        results[name] = dict(max_abs_err=float(err.max()), ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             library_ms=library_ms)
        log(f"parity quant_matmul {name} (M {M} K {K} N {N} {mode} group "
            f"{K // scale.shape[0]} {str(dtype)[6:]}, route "
            f"{_quant_route(qm, M, K, N, mode, dtype)}): ok max_abs_err="
            f"{float(err.max()):.3e} (tolerance {rel:g}*|plain|+1e-5*"
            f"(|x|@|W|)){replay} | kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={bms:.4f} ({by}){note} library_ms="
            f"{library_ms:.4f} (torch.matmul on the pre-dequantized weight) | "
            f"{nbytes / ms / 1e6:.1f} GB/s, {bms / ms:.1%} of the bound")
        del x, codes, scale, got, ref, wd
    col = {}
    for name, (M, K, N, dtype) in INT8_COL_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(len(col) + 41)
        x = torch.randn((M, K), generator=g, device="cuda", dtype=dtype)
        codes, scale = qm.quantize_weight_per_col(
            torch.randn((K, N), generator=g, device="cuda") * 0.02)
        ragged = qm.int8_matmul.ragged_launches
        got = qm.int8_matmul(x, codes, scale)
        ragged = qm.int8_matmul.ragged_launches - ragged
        if ragged != int(qm.kernel_route(M, K, N, dtype) == "ragged"):
            raise AssertionError(f"int8_matmul {name}: {ragged} ragged "
                                 f"kernel launches")
        ref = qm.int8_matmul_plain(x, codes, scale)
        wd = (codes.float() * scale).to(dtype)
        abs_tol, rel = _matmul_tolerance(x, wd, dtype)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= rel * ref.float().abs() + abs_tol).all()):
            raise AssertionError(f"int8_matmul {name} disagrees with its "
                                 f"plain version (max |err| "
                                 f"{float(err.max()):.3e})")
        replay = ""
        if qm.kernel_route(M, K, N, dtype) == "gemv_tf32":
            check_graph_replay(
                lambda xx: qm.int8_matmul(xx, codes, scale),
                lambda xx: qm.int8_matmul_plain(xx, codes, scale),
                x.clone(), lambda xx: _matmul_tolerance(xx, wd, dtype)[0],
                f"int8_matmul {name}", g)
            replay = ", CUDA-graph replay ok"
        ms = cuda_time_ms(lambda: qm.int8_matmul(x, codes, scale))
        plain_ms = cuda_time_ms(lambda: qm.int8_matmul_plain(x, codes, scale),
                                reps=5, warmup=1)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, wd))
        nbytes = codes.numel() + N * 4 + (M * K + M * N) * x.element_size()
        bms, by, note = _matmul_bound(qm, M, K, N, dtype, nbytes)
        col[name] = dict(max_abs_err=float(err.max()), ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=library_ms)
        log(f"parity int8_matmul {name} (M {M} K {K} N {N} "
            f"{str(dtype)[6:]}, route "
            f"{_quant_route(qm, M, K, N, 'int8_col', dtype)}): "
            f"ok max_abs_err={float(err.max()):.3e}{replay} | "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms="
            f"{bms:.4f} ({by}){note} library_ms={library_ms:.4f} | "
            f"{nbytes / ms / 1e6:.1f} GB/s, {bms / ms:.1%} of the bound")
        del x, codes, scale, got, ref, wd
    return results, col


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def serving_kernels():
    """The wrappers of the serving paths' attention kernels, by name: K6,
    K7a, K7b and the masked K1."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops.flash_attention import \
        flash_attention_fwd_masked
    from deepspeed_tpu_torch.ops.ragged_attention import ragged_paged_attention

    return {"ragged_paged_attention": ragged_paged_attention,
            "paged_decode_attention": da.paged_decode_attention,
            "paged_prefill_attention": da.paged_prefill_attention,
            "flash_attention_fwd_masked": flash_attention_fwd_masked}


def serve(cfg, params_seed, n_requests, prompt_range, new_range, scfg,
          dtype, device="cuda", quantize_weights=None, phases=None,
          params=None, engine_kw=None, srv=None):
    """init_inference + ServingEngine on ``cfg`` with seeded random
    weights (or ``params``, a state_dict already on the device; the
    inference config takes ``engine_kw`` too), or ``srv``, an engine
    already built; serves seeded traffic to completion and returns the
    engine, the request ids, the outputs, the wall time and the launches
    of each serving kernel in the run (the wrappers' counts; K6's on the
    device, which replays of CUDA graphs add to, from
    ``ragged_attention.kernel_runs()`` after it). ``phases``, a list of
    lists of ``(prompt, max_new_tokens)``, replaces the seeded traffic:
    each phase is submitted together and drained before the next."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaForCausalLM
    from deepspeed_tpu_torch.ops import ragged_attention as ra

    if srv is None:
        model = LlamaForCausalLM(cfg)
        if params is None:
            params = model.init_params(seed=params_seed, dtype=dtype,
                                       device=device)
        engine = dt.init_inference(model, params=params, dtype=dtype,
                                   device=device,
                                   quantize_weights=quantize_weights,
                                   **(engine_kw or {}))
        srv = dt.ServingEngine(engine, dt.ServingConfig(**scfg))
    if phases is None:
        phases = [seeded_traffic(cfg.vocab_size, params_seed, n_requests,
                                 prompt_range, new_range)]
    if device == "cuda":
        torch.cuda.synchronize()
        ra.reset_kernel_runs()
    kernels = serving_kernels()
    for fn in kernels.values():
        fn.launches = 0
    rids, res = [], {}
    t0 = time.perf_counter()
    for phase in phases:
        rids += [srv.submit(prompt, max_new_tokens=n) for prompt, n in phase]
        res = srv.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return srv, rids, res, wall, {n: fn.launches for n, fn in kernels.items()}


def seeded_traffic(vocab, seed, n, prompt_range, new_range):
    """``n`` seeded ``(prompt, max_new_tokens)`` requests: prompt lengths
    and token budgets uniform in their (inclusive) ranges."""
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab, int(rs.randint(prompt_range[0],
                                                 prompt_range[1] + 1))),
             int(rs.randint(new_range[0], new_range[1] + 1)))
            for _ in range(n)]


def step_widths(srv, since=0):
    """The packed width of each unified step the engine's tracer holds,
    from its ``since``-th on."""
    return [e["args"]["width"] for e in srv.tracer.events()
            if e["name"] == "mixed_step"][since:]


#: the small fp32 reference model: 2 layers, head_dim 128, GQA group 2
SMALL_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=1)


class plain_route:
    """Inside the block, the model's kernel wrappers are swapped for their
    plain versions (K6, K7a, K7b, K4, K5 and masked K1 calls run the plain
    PyTorch code)."""

    def __enter__(self):
        from deepspeed_tpu_torch.models import layers as layers_mod
        from deepspeed_tpu_torch.models import llama as llama_mod
        from deepspeed_tpu_torch.ops import decode_attention as da
        from deepspeed_tpu_torch.ops import flash_attention as fa
        from deepspeed_tpu_torch.ops import quant_matmul as qm
        from deepspeed_tpu_torch.ops import ragged_attention as ra

        def masked_plain(q, k, v, causal=True, sm_scale=None, window=None,
                         key_mask=None):
            return fa.flash_attention_plain(q, k, v, causal, sm_scale,
                                            window, key_mask=key_mask)[0]

        self.saved = [(llama_mod, "ragged_paged_attention",
                       ra.ragged_paged_attention_plain),
                      (llama_mod, "paged_decode_attention",
                       da.paged_decode_attention_plain),
                      (llama_mod, "paged_prefill_attention",
                       da.paged_prefill_attention_plain),
                      (llama_mod, "decode_attention",
                       da.decode_attention_plain),
                      (layers_mod, "flash_attention", masked_plain),
                      (layers_mod, "quant_matmul", qm.quant_matmul_plain)]
        self.saved = [(mod, name, getattr(mod, name), plain)
                      for mod, name, plain in self.saved]
        for mod, name, _, plain in self.saved:
            setattr(mod, name, plain)

    def __exit__(self, *exc):
        for mod, name, kernel, _ in self.saved:
            setattr(mod, name, kernel)


def check_small_reference():
    """The same seeded traffic through a 2-layer model (head_dim 128, GQA
    group 2) in fp32, with fp32 and with int8 weights, each once as
    shipped (the kernels), once with the model's kernel wrappers swapped
    for their plain versions, and once as shipped with enable_cuda_graph
    and mixed_step_buckets (every width captured, then replayed): greedy
    tokens must be identical (the kernel and plain routes differ by fp32
    summation order), and the captured run must run K6 once per layer per
    step on the device."""
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    cfg = LlamaConfig(**SMALL_CFG)
    scfg = dict(max_batch_size=4, block_size=16, num_blocks=64,
                max_model_len=128, prefill_token_budget=32, trace=True)
    for weights in (None, "int8"):
        tokens, launches = {}, {}
        for route in ("kernel", "plain", "captured"):
            quant_matmul.launches = 0
            ekw, skw = SERVE_GRAPH if route == "captured" else ({}, {})
            with plain_route() if route == "plain" else \
                    contextlib.nullcontext():
                srv, rids, res, _, counts = serve(
                    cfg, 3, 6, (5, 90), (4, 12), dict(scfg, **skw),
                    torch.float32, quantize_weights=weights, engine_kw=ekw)
            steps = len(step_widths(srv))
            launches[route] = (counts["ragged_paged_attention"],
                               quant_matmul.launches, kernel_runs(),
                               cfg.num_hidden_layers * steps)
            tokens[route] = [(res[r].state, res[r].tokens) for r in rids]
        ok = tokens["kernel"] == tokens["plain"] == tokens["captured"] and \
            all(s == "finished" for s, _ in tokens["kernel"]) and \
            launches["kernel"][0] > 0 and \
            (launches["kernel"][1] > 0) == (weights is not None) and \
            launches["plain"][:3] == (0, 0, 0) and \
            launches["kernel"][2] == launches["kernel"][3] and \
            launches["captured"][2] == launches["captured"][3] > 0
        log(f"reference: 2-layer fp32 model served, weights "
            f"{weights or 'fp32'}, kernels vs plain versions vs captured "
            f"with bucketed widths, {len(tokens['kernel'])} requests: tokens "
            f"identical={ok} (K6, K5 wrapper launches, K6 device runs, "
            f"layers x steps: {launches['kernel']} / {launches['plain']} / "
            f"{launches['captured']})")
        if not ok:
            raise AssertionError(f"kernels, plain versions and the captured "
                                 f"step served different tokens on the "
                                 f"small fp32 model (weights "
                                 f"{weights or 'fp32'}) or K6 ran the wrong "
                                 f"number of times")


def shared_prefix_phases(vocab, n_prefixes, per_prefix, prefix_len,
                         suffix_range, new_range, seed):
    """Seeded shared-prefix traffic in two phases: the first request of
    every prefix, then all the others (pages index as chunks land, so a
    request hits only what an earlier one has written). Each prompt is its
    group's ``prefix_len`` tokens plus a unique suffix."""
    rs = np.random.RandomState(seed)
    prefixes = [rs.randint(0, vocab, prefix_len) for _ in range(n_prefixes)]
    reqs = [(np.concatenate([prefixes[g], rs.randint(0, vocab, int(
        rs.randint(suffix_range[0], suffix_range[1] + 1)))]),
        int(rs.randint(new_range[0], new_range[1] + 1)))
        for _ in range(per_prefix) for g in range(n_prefixes)]
    return [reqs[:n_prefixes], reqs[n_prefixes:]]


def check_small_legacy_reference(device="cuda"):
    """The two-program engine on the 2-layer fp32 model, once as shipped
    (the kernels) and once with the model's kernel wrappers swapped for
    their plain versions: identical greedy tokens. Two configurations:
    chunked prefill with the prefix cache on shared-prefix traffic (K7a
    and K7b), and the monolithic prefill with prefill_flash_from_empty
    (K7a and the masked K1)."""
    from deepspeed_tpu_torch.models import LlamaConfig

    phases = shared_prefix_phases(SMALL_CFG["vocab_size"], 2, 3, 32, (3, 40),
                                  (4, 12), 5)
    base = dict(max_batch_size=4, block_size=16, num_blocks=64,
                max_model_len=128, mixed_step=False)
    cases = {
        "chunked+prefix_cache": (
            {}, dict(base, prefix_cache=True, prefill_chunk_tokens=16,
                     prefill_token_budget=32),
            ("paged_decode_attention", "paged_prefill_attention")),
        "monolithic+flash": (
            {"prefill_flash_from_empty": True}, base,
            ("paged_decode_attention", "flash_attention_fwd_masked")),
    }
    for name, (over, scfg, expected) in cases.items():
        cfg = LlamaConfig(**SMALL_CFG, **over)
        tokens, launches, hits = {}, {}, {}
        for route in ("kernel", "plain"):
            with plain_route() if route == "plain" else \
                    contextlib.nullcontext():
                srv, rids, res, _, launches[route] = serve(
                    cfg, 3, 0, None, None, scfg, torch.float32,
                    device=device, phases=phases)
            tokens[route] = [(res[r].state, res[r].tokens) for r in rids]
            hits[route] = srv.metrics.prefix_hits
            srv.block_pool.check_consistent()
            if srv.block_pool.used_count:
                raise AssertionError(f"small two-program serve {name}: "
                                     f"{srv.block_pool.used_count} pages "
                                     f"leaked")
        ran = {n for n, c in launches["kernel"].items() if c}
        ok = tokens["kernel"] == tokens["plain"] and \
            all(st == "finished" for st, _ in tokens["kernel"]) and \
            ran == set(expected) and not any(launches["plain"].values()) \
            and hits["kernel"] == hits["plain"] and \
            (hits["kernel"] >= 4) == scfg.get("prefix_cache", False)
        log(f"reference: 2-layer fp32 model served by the two-program "
            f"engine, {name}, kernels vs plain versions, "
            f"{len(tokens['kernel'])} requests: tokens identical="
            f"{tokens['kernel'] == tokens['plain']} ok={ok} (prefix hits "
            f"{hits['kernel']}, launches {launches['kernel']} / "
            f"{launches['plain']})")
        if not ok:
            raise AssertionError(f"small two-program serve {name}: kernels "
                                 f"and plain versions disagree or a route "
                                 f"launched the wrong kernels")


# ---------------------------------------------------------------------------
# the dense generate path
# ---------------------------------------------------------------------------

def left_padded_prompts(vocab, batch, lo, hi, seed):
    """``(ids, mask)`` int numpy ``[batch, max_len]``: seeded prompt
    lengths in ``[lo, hi]``, left-padded with 0 (mask 0)."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(lo, hi + 1, batch)
    T = int(lens.max())
    ids = np.zeros((batch, T), np.int64)
    mask = np.zeros((batch, T), np.int32)
    for b, n in enumerate(lens):
        ids[b, T - n:] = rs.randint(1, vocab, n)
        mask[b, T - n:] = 1
    return ids, mask


def generate_run(cfg, dtype, quantize_weights, ids, mask, max_new_tokens,
                 device="cuda", kv_cache_int8=False, engine_kw=None):
    """init_inference on seeded random weights (seed 0; the inference
    config takes ``engine_kw`` too), two ``generate`` calls of one token
    (prefill and the first sample; the first pays the engine's first-use
    costs, the second's time is the prefill's), with ``enable_cuda_graph``
    one of ``max_new_tokens`` (its first decode step runs eagerly and is
    then captured as the graph that the counted run replays; a call
    without a decode step keeps it), then the counted ``generate``: the
    kernel counts are set to 0 just before it (the wrappers count where
    they run, so a captured run's counts are its prefill's and none of
    its replays'). Returns the tokens, the engine, the prefill and total
    seconds, the launches of K4, K5, the masked K1, K5's wgmma prefill
    kernel, its gemv_tc decode kernel, its ragged kernel, K8 and K5's fp32
    decode kernel (gemv_tf32) in the counted run, the same counts over
    the capturing warm-up (the prefill, the eager step and the capture,
    each once; None without ``enable_cuda_graph``), and whether every
    logit of the counted run was finite."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaForCausalLM
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.flash_attention import \
        flash_attention_fwd_masked
    from deepspeed_tpu_torch.ops.quant_matmul import int8_matmul, quant_matmul

    model = LlamaForCausalLM(cfg)
    params = model.init_params(seed=0, dtype=dtype, device=device)
    engine = dt.init_inference(model, params=params, dtype=dtype,
                               device=device,
                               quantize_weights=quantize_weights,
                               kv_cache_int8=kv_cache_int8,
                               **(engine_kw or {}))
    del params
    def zero():
        decode_attention.launches = quant_matmul.launches = 0
        flash_attention_fwd_masked.launches = quant_matmul.wgmma_launches = 0
        quant_matmul.gemv_tc_launches = quant_matmul.ragged_launches = 0
        int8_matmul.launches = quant_matmul.gemv_tf32_launches = 0

    def counts():
        return (decode_attention.launches, quant_matmul.launches,
                flash_attention_fwd_masked.launches,
                quant_matmul.wgmma_launches, quant_matmul.gemv_tc_launches,
                quant_matmul.ragged_launches, int8_matmul.launches,
                quant_matmul.gemv_tf32_launches)

    finite = []
    engine.module.register_forward_hook(
        lambda mod, args, out: finite.append(torch.isfinite(out[0]).all()))
    engine.generate(ids, attention_mask=mask, max_new_tokens=1)
    capture = None
    if engine.config.enable_cuda_graph:
        zero()
        engine.generate(ids, attention_mask=mask,
                        max_new_tokens=max_new_tokens)
        capture = counts()
    engine.profile_model_time()
    engine.generate(ids, attention_mask=mask, max_new_tokens=1)
    finite.clear()
    zero()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = engine.generate(ids, attention_mask=mask,
                          max_new_tokens=max_new_tokens)
    prefill_s, total_s = engine.model_times()
    return out, engine, prefill_s, total_s, counts(), capture, \
        bool(torch.stack(finite).all())


def check_small_generate_reference(device="cuda"):
    """A 2-layer fp32 model (head_dim 128, GQA group 2) generating 24
    greedy tokens for 4 left-padded prompts, once through the kernels and
    once with the model's kernel wrappers swapped for their plain
    versions: tokens must be identical (fp32 summation order is the only
    difference), the kernel route must launch K4 (and K5 with quantized
    weights, the masked K1 once per layer with the flash prefill), the
    plain route nothing. Cases: fp32 weights, int8 and int4 weights, an
    int8 cache, window 64, prefill_flash_from_empty."""
    from deepspeed_tpu_torch.models import LlamaConfig

    ids, mask = left_padded_prompts(SMALL_CFG["vocab_size"], 4, 5, 90, 7)
    cases = {"fp32": ({}, {}), "int8": ({}, {"quantize_weights": "int8"}),
             "int4": ({}, {"quantize_weights": "int4"}),
             "kv_int8": ({}, {"kv_cache_int8": True}),
             "window64": ({"sliding_window": 64}, {}),
             "flash_prefill": ({"prefill_flash_from_empty": True}, {})}
    tf32_launches = 0
    for name, (over, kw) in cases.items():
        cfg = LlamaConfig(**SMALL_CFG, **over)
        got = {}
        routes = ("kernel", "plain", "captured") if name in ("fp32", "int8") \
            else ("kernel", "plain")
        for route in routes:
            with plain_route() if route == "plain" else \
                    contextlib.nullcontext():
                out, _, _, _, launches, capture, finite = generate_run(
                    cfg, torch.float32, kw.get("quantize_weights"), ids,
                    mask, 24, device=device,
                    kv_cache_int8=kw.get("kv_cache_int8", False),
                    engine_kw=dict(enable_cuda_graph=route == "captured"))
            got[route] = (out.cpu().tolist(), launches, finite, capture)
        quant = "quantize_weights" in kw
        L = cfg.num_hidden_layers
        flash = L * cfg.prefill_flash_from_empty
        # fp32 x: the quantized decode steps run K5's fp32 decode kernel;
        # the captured graph holds K4 and (quantized) gemv_tf32 once per
        # layer and projection: the warm-up runs the prefill (K5 on the
        # fp32 tile route), the eager step and the capture, and the
        # counted run's replays add nothing to the wrappers' counts
        ok = got["kernel"][0] == got["plain"][0] and got["kernel"][2] and \
            got["kernel"][1][0] > 0 and \
            (got["kernel"][1][1] > 0) == quant and \
            (got["kernel"][1][7] > 0) == quant and \
            got["kernel"][1][2] == flash and \
            got["plain"][1] == (0,) * 8
        if "captured" in got:
            k5 = 7 * L if quant else 0
            ok = ok and got["captured"][0] == got["kernel"][0] and \
                got["captured"][2] and \
                got["captured"][3] == (2 * L, 3 * k5, 0, 0, 0, 0, 0,
                                       2 * k5) and \
                got["captured"][1] == (0, k5, 0, 0, 0, 0, 0, 0)
        if name == "int8":
            tf32_launches = got["kernel"][1][7]
        log(f"reference: 2-layer fp32 model generate {name}, kernels vs "
            f"plain versions{' vs the captured decode step' if len(routes) == 3 else ''}, "
            f"4 prompts x 24 tokens: tokens identical="
            f"{got['kernel'][0] == got['plain'][0]} ok={ok} (K4, K5, masked "
            f"K1, wgmma K5, gemv_tc K5, ragged K5, K8, gemv_tf32 K5 launches "
            f"{got['kernel'][1]} / "
            f"{got['plain'][1]}"
            f"{'; captured: warm-up (prefill, eager step, capture) ' + str(got['captured'][3]) + ', replayed run ' + str(got['captured'][1]) if 'captured' in got else ''})")
        if not ok:
            raise AssertionError(f"small generate {name}: kernels, plain "
                                 f"versions and the captured step disagree "
                                 f"or a route launched the wrong kernels")
    return tf32_launches


def check_generate():
    """Full-width Llama-3-8B (all 32 layers, random bf16 weights from seed
    0) through init_inference -> generate: batch 8, left-padded prompts of
    seeded lengths 128-512 (bucketed to 512), 64 greedy new tokens, no
    EOS; once with bf16 weights, once with int8 weights, then the int8
    weights again with enable_cuda_graph (the decode step one CUDA graph,
    captured in a warm-up generate and replayed by the counted one: its
    tokens must be the uncaptured run's), and once with bf16 weights and
    prefill_flash_from_empty (the prefill through the masked K1 instead of
    the plain cached attention)."""
    from deepspeed_tpu_torch.models import LlamaConfig

    L = LlamaConfig.llama3_8b().num_hidden_layers
    ids, mask = left_padded_prompts(LlamaConfig.llama3_8b().vocab_size,
                                    GEN_B, 128, GEN_PROMPT, 0)
    launches, tokens, decode = {}, {}, {}
    for weights, flash, graph in ((None, False, False),
                                  ("int8", False, False),
                                  ("int8", False, True),
                                  (None, True, False)):
        cfg = LlamaConfig.llama3_8b(prefill_flash_from_empty=flash)
        name = (weights or "bf16") + ("_flash" if flash else "") + \
            ("_graph" if graph else "")
        t = time.perf_counter()
        out, engine, prefill_s, total_s, counts, capture, finite = \
            generate_run(cfg, torch.bfloat16, weights, ids, mask, GEN_NEW,
                         engine_kw=dict(enable_cuda_graph=graph))
        k4, k5, k1m, k5w, k5g, k5r, k8, k5f = counts
        setup = time.perf_counter() - t - prefill_s - total_s
        decode_ms = 1e3 * (total_s - prefill_s) / (GEN_NEW - 1)
        decode[name] = decode_ms
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"generate: llama3_8b x{L} layers, weights {weights or 'bf16'}, "
            f"prefill_flash_from_empty {flash}, enable_cuda_graph {graph}, "
            f"batch {GEN_B}, prompts {int(mask.sum(1).min())}-"
            f"{int(mask.sum(1).max())} tokens (bucket {GEN_PROMPT}), "
            f"{GEN_NEW} new tokens: prefill {1e3 * prefill_s:.2f} ms, mean "
            f"decode step {decode_ms:.3f} ms, total {1e3 * total_s:.2f} ms "
            f"= {GEN_B * GEN_NEW / total_s:.1f} tokens/s, peak memory "
            f"{peak:.1f} GiB, setup {setup:.1f} s, launches K4 {k4} K5 {k5} "
            f"(wgmma prefill {k5w}, gemv_tc decode {k5g}, ragged {k5r}, "
            f"gemv_tf32 {k5f}) masked K1 {k1m} K8 {k8}"
            f"{' (the wrappers count where they run: the replayed decode steps add none; the capturing warm-up (prefill, eager step, capture) ' + str(capture) + ')' if graph else ''}, "
            f"quant {engine.quant_summary or None}")
        # K5's prefill: the 7 projections of each layer on the wgmma
        # kernel; its decode steps on the gemv_tc kernel (replays of the
        # captured step are not counted by the wrappers); every Llama-3-8B
        # projection's rows are TMA-addressable, so none takes the ragged
        # kernel; no projection has K8's per-column scales
        steps = 0 if graph else GEN_NEW - 1
        want = (L * steps, 7 * L * (steps + 1) if weights else 0,
                L if flash else 0, 7 * L if weights else 0,
                7 * L * steps if weights else 0, 0, 0, 0)
        problems = []
        if tuple(out.shape) != (GEN_B, GEN_NEW):
            problems.append(f"output shape {tuple(out.shape)}")
        if not finite:
            problems.append("a logit is not finite")
        if counts != want:
            problems.append(f"launches K4, K5, masked K1, wgmma K5, "
                            f"gemv_tc K5, ragged K5, K8, gemv_tf32 K5 "
                            f"{counts} != {want}")
        # the graph holds the decode step's kernels: the warm-up ran the
        # prefill, one eager step and the capture, so K4 twice a layer and
        # gemv_tc twice a projection
        k5 = 7 * L if weights else 0
        want_capture = (2 * L, 3 * k5, 0, k5, 2 * k5, 0, 0, 0) if graph \
            else None
        if capture != want_capture:
            problems.append(f"capturing warm-up launches {capture} != "
                            f"{want_capture}")
        tokens[name] = out.cpu().tolist()
        if graph and tokens[name] != tokens["int8"]:
            problems.append("the captured decode's tokens differ from the "
                            "uncaptured run's")
        if problems:
            raise AssertionError(f"generate {name}: " + "; ".join(problems))
        launches[name] = counts
        del out, engine
        gc.collect()
        torch.cuda.empty_cache()
    log(f"generate int8 decode step: uncaptured {decode['int8']:.3f} ms, "
        f"captured {decode['int8_graph']:.3f} ms (tokens identical)")
    return launches, decode


#: the unified engine's full-width run: 8 slots, 16-token pages, 1024
#: pages, 2048-token rows, a 256-token prefill budget
SERVE_SCFG = dict(max_batch_size=8, block_size=16, num_blocks=1024,
                  max_model_len=2048, prefill_token_budget=256, trace=True,
                  trace_capacity=1 << 16)
#: the captured engine: enable_cuda_graph (the inference config) with the
#: bucketed widths 8, 16, ..., 256, 263
SERVE_GRAPH = (dict(enable_cuda_graph=True), dict(mixed_step_buckets=True))
#: check_serving's runs in turns: (name, enable_cuda_graph,
#: mixed_step_buckets, the run whose tokens it must repeat); "_again" runs
#: reuse the engine of the run they name (every graph already captured)
SERVE_RUNS = (("uncaptured", False, False, None),
              ("captured", True, False, "uncaptured"),
              ("uncaptured_buckets", False, True, None),
              ("captured_buckets", True, True, "uncaptured_buckets"),
              ("captured_again", True, False, "uncaptured"),
              ("captured_buckets_again", True, True, "uncaptured_buckets"))


def check_width_witness(module):
    """One packed step's pieces at two packed widths, the same tokens in
    front: K6 on a full-width pool (H 32, Hkv 8, D 128, 1024 pages of
    16; 8 decode rows at widths 8 and 263; 7 decode rows and a 120-token
    chunk at widths 128 and 263) must give the same rows bit for bit (its
    work items do not depend on the width); Llama-3-8B's layer-0
    projections and LM head (``module``'s, bf16, through cuBLAS) on the
    same rows at the same widths are printed, not gated. Returns the
    largest difference of each, by (piece, narrow width)."""
    from deepspeed_tpu_torch.ops.ragged_attention import ragged_paged_attention

    rs = np.random.RandomState(5)
    ctx = [int(c) for c in rs.randint(64, 1536, R)]
    cases = {"decode": ([(1, c - 1) for c in ctx], 8),
             "mixed": ([(1, c - 1) for c in ctx[:-1]] + [(120, ctx[-1])],
                       128)}
    diffs = {}
    for name, (rows, width) in cases.items():
        (q, k, v, *desc), _ = ragged_case(rows, False, 11)
        full = ragged_paged_attention(q, k, v, *desc)
        narrow = ragged_paged_attention(q[:width].contiguous(), k, v, *desc)
        diffs[f"K6 {name}", width] = float(
            (full[:width].float() - narrow.float()).abs().max())
    attn, mlp = module.model.layers[0].self_attn, module.model.layers[0].mlp
    projections = {"q_proj": attn.q_proj, "k_proj": attn.k_proj,
                   "v_proj": attn.v_proj, "o_proj": attn.o_proj,
                   "gate_proj": mlp.gate_proj, "up_proj": mlp.up_proj,
                   "down_proj": mlp.down_proj, "lm_head": module.lm_head}
    g = torch.Generator(device="cuda").manual_seed(12)
    with torch.inference_mode():
        for name, proj in projections.items():
            x = torch.randn((1, T_PACKED, proj.in_features), generator=g,
                            device="cuda", dtype=torch.bfloat16)
            full = proj(x)
            for width in (8, 128):
                narrow = proj(x[:, :width])
                diffs[name, width] = float(
                    (full[:, :width].float() - narrow.float()).abs().max())
    # the whole step: 8 decode tokens packed at widths 263 and 8 through
    # the model on a random pool; each leaf module's rows are compared in
    # the order the step runs them, so the first that differs is where
    # the step's rows start to depend on the width
    from deepspeed_tpu_torch.models.layers import paged_cache_index

    rows = cases["decode"][0]
    (_, _, _, bt, qs, ql, cs, cl), _ = ragged_case(rows, False, 11)
    pool = module.init_paged_cache(N_PAGES, BS, dtype=torch.bfloat16,
                                   device="cuda")
    for t in pool.values():
        t.normal_(generator=g)
    leaves = [(n, m) for n, m in module.named_modules()
              if not any(True for _ in m.children())]
    seen = {}

    def hook(name):
        def fn(mod, args, out):
            out = out[0] if isinstance(out, tuple) else out
            seen.setdefault(name, []).append(out[..., :R, :].float().clone()
                                             if out.dim() == 3 else None)
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in leaves]
    tok = torch.randint(1, module.config.vocab_size, (R,), generator=g,
                        device="cuda")
    logits = {}
    with torch.inference_mode():
        for width in (T_PACKED, R):
            ids = torch.zeros((1, width), dtype=torch.long, device="cuda")
            ids[0, :R] = tok
            trow = np.full((1, width), -1, np.int32)
            trow[0, :R] = np.arange(R)
            pos = np.full((1, width), -1, np.int32)
            pos[0, :R] = cs.cpu().numpy()
            idx = paged_cache_index(bt, pos, cl, chunk_start=cs,
                                    token_rows=trow, query_start=qs,
                                    query_len=ql, device="cuda")
            out, _ = module(ids, cache=pool, cache_index=idx)
            logits[width] = out[0, :R].float()
    for h in handles:
        h.remove()
    first = next(((n, float((v[0] - v[1]).abs().max()))
                  for n, v in seen.items() if v[0] is not None and
                  len(v) == 2 and not torch.equal(v[0], v[1])), None)
    diffs["logits, whole step", R] = float(
        (logits[T_PACKED] - logits[R]).abs().max())
    del pool
    log("serve width witness (the same packed rows at a narrow width and "
        f"at 263; max |difference| of the narrow width's rows; the whole "
        f"step's first leaf module whose rows differ: "
        f"{first[0] + f' ({first[1]:.6g})' if first else 'none'}): " +
        ", ".join(f"{n} at {w}: {d:.6g}" for (n, w), d in diffs.items()))
    bad = {k: d for k, d in diffs.items() if k[0].startswith("K6") and d}
    if bad:
        raise AssertionError(f"K6's rows depend on the packed width: {bad}")
    return diffs


def check_serving():
    """Full-width Llama-3-8B (all 32 layers, random bf16 weights) serving
    16 seeded requests through the unified mixed step on the kernel, in
    turns on one set of weights (``SERVE_RUNS``): uncaptured at the full
    packed width (as every earlier run), captured (enable_cuda_graph: each
    width's first step eager, then captured and replayed), uncaptured and
    captured at bucketed widths (mixed_step_buckets), then each captured
    engine again on the same requests (every graph replayed). A captured
    run must repeat its uncaptured twin's tokens and finish reasons
    exactly; the bucketed runs are held to the bucketed uncaptured run,
    not to the full width: a row's logits change in their last bits with
    the packed width, and greedy decoding on random weights amplifies
    that (PERF.md), so how many requests keep the full width's tokens is
    printed, not gated. Where the step's rows change is read by
    :func:`check_width_witness` on this model, which fails if K6's do.
    Every run must finish every request, leak no page, flag no row and
    run K6 once per layer per step, counted on the device (replays
    included) and, uncaptured, by the wrapper too. Returns the first
    run's K6 launches and each run's summary."""
    from collections import Counter

    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    cfg = LlamaConfig.llama3_8b()
    L = cfg.num_hidden_layers
    t = time.perf_counter()
    params = LlamaForCausalLM(cfg).init_params(seed=0, dtype=torch.bfloat16,
                                               device="cuda")
    setup = time.perf_counter() - t
    engines, tokens, runs = {}, {}, {}
    for name, captured, buckets, twin in SERVE_RUNS:
        ekw = dict(enable_cuda_graph=captured)
        skw = dict(mixed_step_buckets=buckets)
        key = name.replace("_again", "")
        before = len(step_widths(engines[key])) if key in engines else 0
        srv, rids, res, wall, launches = serve(
            cfg, 0, 16, (64, 1536), (32, 64), dict(SERVE_SCFG, **skw),
            torch.bfloat16, params=params, engine_kw=ekw,
            srv=engines.get(key))
        engines[key] = srv
        runs_k6 = kernel_runs()
        widths = step_widths(srv, before)
        steps = len(widths)
        tokens[name] = [(res[r].state, res[r].finish_reason, res[r].tokens)
                        for r in rids]
        generated = sum(len(res[r].tokens) for r in rids)
        ttft = float(np.median([res[r].ttft_s for r in rids]))
        finished = sum(res[r].state == "finished" for r in rids)
        summary = dict(tok_s=generated / wall, ttft_p50_s=ttft,
                       mean_step_ms=1e3 * wall / max(steps, 1), steps=steps,
                       wall_s=wall, widths=dict(sorted(Counter(widths)
                                                       .items())),
                       k6_runs=runs_k6, graphs=len(srv._graphs))
        runs[name] = summary
        same = "" if twin is None else \
            f", tokens identical to {twin}: {tokens[name] == tokens[twin]}"
        log(f"serve {name}: llama3_8b x{L} layers bf16, "
            f"enable_cuda_graph {captured}, mixed_step_buckets {buckets}, "
            f"{len(rids)} requests, {finished} finished, {steps} mixed "
            f"steps, wall {wall:.3f} s (weights {setup:.1f} s), generated "
            f"{generated} tokens = {generated / wall:.1f} tok/s, ttft_p50 "
            f"{ttft:.3f} s, mean step {1e3 * wall / max(steps, 1):.2f} ms, "
            f"steps at each width {summary['widths']}, graphs captured "
            f"{len(srv._graphs)}, preemptions {srv.metrics.preemptions}, "
            f"quarantines {srv.metrics.logit_quarantines}, K6 runs on the "
            f"device {runs_k6}, wrapper launches {launches}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB{same}")
        srv.block_pool.check_consistent()
        problems = []
        if finished != len(rids):
            problems.append(f"{len(rids) - finished} requests did not finish")
        if twin is not None and tokens[name] != tokens[twin]:
            problems.append(f"tokens or finish reasons differ from {twin}")
        if srv.metrics.logit_quarantines:
            problems.append(f"{srv.metrics.logit_quarantines} rows flagged "
                            f"NaN/Inf")
        if srv.block_pool.used_count:
            problems.append(f"{srv.block_pool.used_count} pages leaked")
        if runs_k6 == 0 or runs_k6 != L * steps:
            problems.append(f"K6 ran {runs_k6} times on the device, not "
                            f"{L} x {steps} mixed steps")
        k6 = launches["ragged_paged_attention"]
        if not captured and (k6 != L * steps or sum(launches.values()) != k6):
            problems.append(f"kernel launches {launches} != {L} x {steps} "
                            f"mixed steps of K6 alone")
        if set(widths) - set(srv.mixed_step_widths):
            problems.append(f"widths {sorted(set(widths))} outside "
                            f"{srv.mixed_step_widths}")
        if problems:
            raise AssertionError(f"serve {name}: " + "; ".join(problems))
        runs[name]["wrapper_k6"] = k6
    kept = sum(a == b for a, b in zip(tokens["uncaptured"],
                                      tokens["uncaptured_buckets"]))
    log(f"serve: bucketed widths vs the full width, uncaptured: {kept} of "
        f"{len(tokens['uncaptured'])} requests with identical tokens")
    check_width_witness(engines["uncaptured"].engine.module)
    plain = engines.pop("captured")
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    guarded, rids, runs["guarded"] = check_guarded_serve(
        cfg, params, plain, tokens["captured"])
    del plain
    runs["slo"] = check_slo_serve(cfg, params, guarded, rids)
    del guarded
    gc.collect()
    torch.cuda.empty_cache()
    runs["chaos"] = check_chaos_serve(
        "unified", cfg, params, SERVE_SCFG, [[(np.arange(300), 4)]],
        [seeded_traffic(cfg.vocab_size, 0, 16, (64, 1536), (32, 64))])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs["uncaptured"]["wrapper_k6"], runs


# ---------------------------------------------------------------------------
# serving robustness and accounting
# ---------------------------------------------------------------------------

#: the chaos phase's DS_FAULT: one slow_step past the 0.5 s budget at the
#: engine's ``step`` (20 steps into the traffic, where decode rows run and
#: the other faults have fired: a trip fails the whole step, so a fault
#: that fired on the same step would not show), one corrupt_logits of each
#: tag, one flaky_prefill
CHAOS_SPEC = ("slow_step:seconds=1.5:fails=1:step={step},"
              "corrupt_logits:fails=1:tag=serving_step,"
              "corrupt_logits:fails=1:tag=serving_prefill,"
              "flaky_prefill:fails=1")
#: the finish reason and flight-recorder triggers each of its faults makes
CHAOS_REASONS = ("step_watchdog", "corrupt_logits",
                 "prefill_error:RuntimeError")
CHAOS_DUMPS = {"watchdog_trip": 1, "fault_slow_step": 1,
               "logit_quarantine": 2, "fault_corrupt_logits": 2,
               "fault_flaky_prefill": 1}


def flight_dumps(trace_dir):
    """The flight recorder's dump headers in ``trace_dir``, by trigger."""
    out = {}
    for f in sorted(os.listdir(trace_dir)):
        if f.startswith("flight_") and f.endswith(".jsonl"):
            with open(os.path.join(trace_dir, f)) as fh:
                header = json.loads(fh.readline())
            out.setdefault(header["trigger"], []).append(header)
    return out


def utilization_problems(where, **readings):
    """Every MFU/MBU reading must lie in (0, 1.05]."""
    return [f"{where}: {k} = {v} outside (0, 1.05]"
            for k, v in readings.items() if v is None or not 0 < v <= 1.05]


def request_times(srv, rids):
    """Each request's TTFT and mean time per output token after the first
    (seconds), from the engine's records."""
    ttft, tpot = [], []
    for r in rids:
        req = srv._requests[r]
        ttft.append(req.ttft)
        if len(req.tokens) > 1:
            tpot.append((req.finish_time - req.first_token_time)
                        / (len(req.tokens) - 1))
    return ttft, tpot


def check_guarded_serve(cfg, params, plain, want):
    """Phase (a): the captured serve of check_serving under a 2 s step
    watchdog with the flight recorder armed (``trace_dir``), against the
    same captured engine unguarded (``plain``, warm), in turns (plain,
    guarded, guarded, plain) on the same 16 requests after one warm-up
    run of the guarded engine (its capture). Gates: the captured run's
    tokens (``want``) on every run, no trip, no skip, no flight dump, the
    plain engine's graph count, the H100's peaks found, the gauges in (0,
    1.05]. Prints each run's mean step and the guarded / plain ratio, the
    gauges, the program table, and what one watermark read costs on the
    host. Returns the guarded engine, its last run's request ids and the
    summary."""
    trace_dir = tempfile.mkdtemp(prefix="flight_")
    scfg = dict(SERVE_SCFG, step_watchdog_s=2.0, trace_dir=trace_dir)
    guarded, *_ = serve(cfg, 0, 16, (64, 1536), (32, 64), scfg,
                        torch.bfloat16, params=params,
                        engine_kw=dict(enable_cuda_graph=True))
    steps = {"plain": [], "guarded": []}
    problems = []
    for name in ("plain", "guarded", "guarded", "plain"):
        srv = guarded if name == "guarded" else plain
        before = len(step_widths(srv))
        _, rids, res, wall, _ = serve(cfg, 0, 16, (64, 1536), (32, 64),
                                      None, torch.bfloat16, srv=srv)
        if srv is guarded:
            guarded_rids = rids
        n = len(step_widths(srv, before))
        steps[name].append(1e3 * wall / n)
        got = [(res[r].state, res[r].finish_reason, res[r].tokens)
               for r in rids]
        if got != want:
            problems.append(f"{name}: tokens or finish reasons differ from "
                            f"the captured run's")
        srv.block_pool.check_consistent()
        if srv.block_pool.used_count:
            problems.append(f"{name}: {srv.block_pool.used_count} pages "
                            f"leaked")
    m = guarded.metrics
    plain_ms = statistics.mean(steps["plain"])
    guard_ms = statistics.mean(steps["guarded"])
    mem_cost = host_ms(guarded.perf.memory_watermarks, reps=200)
    summary = guarded.perf_summary()
    mean_mbu = summary["programs"][0]["bytes_accessed"] / (
        guard_ms / 1e3 * guarded.perf.peak_hbm_bw) \
        if guarded.perf.peak_hbm_bw else None
    log(f"serve guarded: step_watchdog_s 2.0 + trace_dir, captured, "
        f"mean step plain {[round(x, 3) for x in steps['plain']]} ms, "
        f"guarded {[round(x, 3) for x in steps['guarded']]} ms "
        f"(guarded / plain {guard_ms / plain_ms:.4f}), tokens identical "
        f"to the captured run: {not problems}, watchdog trips "
        f"{m.watchdog_trips}, skips {m.watchdog_skips}, flight dumps "
        f"{len(flight_dumps(trace_dir))}, graphs {len(guarded._graphs)} "
        f"(plain {len(plain._graphs)}), one watermark read "
        f"{1e3 * mem_cost:.1f} us, last step "
        f"mixed_mbu {m.mixed_mbu}, mixed_mfu {m.mixed_mfu}, tokens/s "
        f"{m.mixed_tokens_per_sec_per_chip}, the mean guarded step's MBU "
        f"{mean_mbu}, hbm in use {m.hbm_bytes_in_use}, peak "
        f"{m.hbm_peak_bytes}, peaks {summary['peak_flops_per_chip']} "
        f"FLOP/s {summary['peak_hbm_bytes_per_s_per_chip']} B/s for "
        f"{summary['device_kind']!r}")
    log(f"serve guarded perf_summary programs: {summary['programs']}")
    if m.watchdog_trips or m.watchdog_skips:
        problems.append(f"{m.watchdog_trips} trips, {m.watchdog_skips} skips")
    if flight_dumps(trace_dir):
        problems.append(f"flight dumps {sorted(flight_dumps(trace_dir))}")
    if len(guarded._graphs) != len(plain._graphs):
        problems.append(f"graphs {len(guarded._graphs)} != plain's "
                        f"{len(plain._graphs)}")
    if guarded.perf.peak_flops is None:
        problems.append(f"no peaks for {summary['device_kind']!r}")
    problems += utilization_problems("serve guarded", mixed_mbu=m.mixed_mbu,
                                     mixed_mfu=m.mixed_mfu,
                                     mean_mbu=mean_mbu)
    if problems:
        raise AssertionError("serve guarded: " + "; ".join(problems))
    return guarded, guarded_rids, dict(plain_ms=steps["plain"],
                               guarded_ms=steps["guarded"],
                               mixed_mbu=m.mixed_mbu, mixed_mfu=m.mixed_mfu,
                               mean_mbu=mean_mbu)


def check_slo_serve(cfg, params, guarded, rids):
    """Phase (c): a captured engine with ``ttft_slo_s`` / ``tpot_slo_s``
    at the p50s of the guarded run (``guarded``'s requests ``rids``),
    warmed by one request, then the same 16 requests: the verdicts of the
    16 must sum to them. Prints the split. Returns it."""
    ttft, tpot = request_times(guarded, rids)
    slo = dict(ttft_slo_s=float(np.median(ttft)),
               tpot_slo_s=float(np.median(tpot)))
    srv, *_ = serve(cfg, 0, 0, None, None, dict(SERVE_SCFG, **slo),
                    torch.bfloat16, params=params,
                    engine_kw=dict(enable_cuda_graph=True),
                    phases=[[(np.arange(100), 4)]])
    verdicts = ("good", "ttft_miss", "tpot_miss", "shed", "failed")
    before = {v: getattr(srv.metrics, f"slo_{v}") for v in verdicts}
    _, rids, res, _, _ = serve(cfg, 0, 16, (64, 1536), (32, 64), None,
                               torch.bfloat16, srv=srv)
    split = {v: getattr(srv.metrics, f"slo_{v}") - before[v]
             for v in verdicts}
    terminal = sum(res[r].state != "queued" and res[r].state != "running"
                   for r in rids)
    log(f"serve slo: ttft_slo_s {slo['ttft_slo_s']:.4f} and tpot_slo_s "
        f"{slo['tpot_slo_s']:.5f} (the guarded run's p50s), verdicts of "
        f"{len(rids)} requests {split}, goodput tokens "
        f"{srv.metrics.goodput_tokens}")
    if sum(split.values()) != terminal or terminal != len(rids):
        raise AssertionError(f"serve slo: verdicts {split} do not sum to "
                             f"{terminal} terminal of {len(rids)} requests")
    del srv
    return dict(slo, **split)


def check_chaos_serve(name, cfg, params, scfg, warm, traffic):
    """Phase (b): ``CHAOS_SPEC`` armed over a captured engine (``scfg``
    with a 0.5 s budget and the flight recorder), warmed by ``warm`` (a
    phase list) so every graph of ``traffic`` is captured first. Gates, as
    the JAX chaos invariant: every request terminal, each expected finish
    reason, one trip, two quarantines, no leaked page, a consistent pool,
    a fresh request served afterwards, the graphs and program table
    unchanged, and one flight dump per firing whose header names the
    request it hit. The survivors' tokens are not gated: failing requests
    changes the packed widths, and the bf16 products' rows change in
    their last bits with the width. Returns the summary."""
    from deepspeed_tpu_torch.utils import fault_injection as faults

    trace_dir = tempfile.mkdtemp(prefix="flight_")
    scfg = dict(scfg, step_watchdog_s=0.5, trace_dir=trace_dir)
    srv, *_ = serve(cfg, 0, 0, None, None, scfg, torch.bfloat16,
                    params=params, engine_kw=dict(enable_cuda_graph=True),
                    phases=warm)
    graphs = (sorted(map(str, srv._graphs)),
              [(r["name"], r["compiles"]) for r in srv.perf.programs.table()])
    spec = CHAOS_SPEC.format(step=srv._step_no + 20)
    os.environ[faults.ENV_VAR] = spec
    faults.reset()
    try:
        _, rids, res, wall, _ = serve(cfg, 0, 0, None, None, None,
                                      torch.bfloat16, srv=srv,
                                      phases=traffic)
    finally:
        del os.environ[faults.ENV_VAR]
        faults.reset()
    if srv._wedged is not None:
        srv._wedged.join()
    _, fresh, fres, _, _ = serve(cfg, 0, 0, None, None, None, torch.bfloat16,
                                 srv=srv, phases=[[(np.arange(40), 3)]])
    srv.flight.disarm()
    m = srv.metrics
    reasons = {}
    for r in rids:
        reasons.setdefault(res[r].finish_reason, []).append(r)
    dumps = flight_dumps(trace_dir)
    log(f"serve chaos {name}: DS_FAULT={spec}, {len(rids)} requests "
        f"in {wall:.3f} s, finish reasons "
        f"{ {k: len(v) for k, v in reasons.items()} }, watchdog trips "
        f"{m.watchdog_trips}, skips {m.watchdog_skips}, quarantines "
        f"{m.logit_quarantines}, failed {m.requests_failed}, flight dumps "
        f"{ {k: [h['detail'] for h in v] for k, v in dumps.items()} }, "
        f"graphs {len(srv._graphs)}, recompiles {srv.perf.recompile_total}")
    problems = []
    if any(res[r].state in ("queued", "running") for r in rids):
        problems.append("a request is not terminal")
    for reason in CHAOS_REASONS:
        if reason not in reasons:
            problems.append(f"no request ended {reason}")
    if (m.watchdog_trips, m.logit_quarantines) != (1, 2):
        problems.append(f"trips {m.watchdog_trips}, quarantines "
                        f"{m.logit_quarantines} != 1, 2")
    srv.block_pool.check_consistent()
    if srv.block_pool.used_count:
        problems.append(f"{srv.block_pool.used_count} pages leaked")
    if fres[fresh[0]].state != "finished":
        problems.append("the fresh request did not finish")
    if (sorted(map(str, srv._graphs)),
            [(r["name"], r["compiles"])
             for r in srv.perf.programs.table()]) != graphs:
        problems.append("the chaos changed the captured graphs")
    if {k: len(v) for k, v in dumps.items()} != CHAOS_DUMPS:
        problems.append(f"flight dumps {sorted(dumps)} != {CHAOS_DUMPS}")
    else:
        tripped = reasons.get("step_watchdog", [])
        named = {
            "watchdog_trip": [set(h["detail"]["rids"]) == set(tripped)
                              for h in dumps["watchdog_trip"]],
            "fault_slow_step": [set(h["detail"]["rids"]) == set(tripped)
                                for h in dumps["fault_slow_step"]],
            "logit_quarantine": [h["detail"]["rid"] in reasons.get(
                "corrupt_logits", []) for h in dumps["logit_quarantine"]],
            "fault_corrupt_logits": [bool(set(h["detail"]["rids"]) & set(
                reasons.get("corrupt_logits", [])))
                for h in dumps["fault_corrupt_logits"]],
            "fault_flaky_prefill": [h["detail"]["rids"] == reasons.get(
                "prefill_error:RuntimeError") for h in
                dumps["fault_flaky_prefill"]]}
        bad = [k for k, ok in named.items() if not all(ok)]
        if bad:
            problems.append(f"dumps {bad} do not name the request they hit")
    if problems:
        raise AssertionError(f"serve chaos {name}: " + "; ".join(problems))
    del srv
    return {k: len(v) for k, v in reasons.items()}


#: the two-program engine's full-width run: slots, pages and lengths of
#: check_serving, 64-token chunks under a 256-token budget
LEGACY_SCFG = dict(max_batch_size=8, block_size=16, num_blocks=1024,
                   max_model_len=2048, mixed_step=False, trace=True,
                   trace_capacity=1 << 16)


def check_serving_legacy():
    """Full-width Llama-3-8B (all 32 layers, random bf16 weights from seed
    0) through the two-program engine: 16 seeded requests, 4 shared
    512-token prefixes x 4 requests, unique suffixes of 64-512 tokens,
    32-64 new tokens. First with the prefix cache, 64-token chunks and a
    256-token budget (K7a and K7b; the first request of each prefix is
    served before the other twelve arrive, so those hit its pages), then
    the same requests at once without the cache through the monolithic
    bucketed prefill with prefill_flash_from_empty (K7a and the masked
    K1). Each configuration runs uncaptured, then with enable_cuda_graph
    (the decode, the chunk and each monolithic bucket one CUDA graph),
    which must serve the same tokens; the captured engine then serves the
    first group's prompts again under the profiler, and K7a (and K7b, or
    the masked K1) must run once per layer per replayed forward, counted
    on the device.
    Returns the wrappers' launches of each uncaptured run and the kernels
    of each captured engine's profiled replays, by configuration."""
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    base = LlamaConfig.llama3_8b()
    L = base.num_hidden_layers
    phases = shared_prefix_phases(base.vocab_size, 4, 4, 512, (64, 512),
                                  (32, 64), 0)
    params = LlamaForCausalLM(base).init_params(
        seed=0, dtype=torch.bfloat16, device="cuda")
    runs = {
        "chunked+prefix_cache": (
            base, dict(LEGACY_SCFG, prefix_cache=True,
                       prefill_chunk_tokens=PAGED_CHUNK,
                       prefill_token_budget=256), phases),
        "monolithic+flash": (
            LlamaConfig.llama3_8b(prefill_flash_from_empty=True),
            LEGACY_SCFG, [phases[0] + phases[1]]),
    }
    out, replayed = {}, {}
    for name, (cfg, scfg, traffic) in runs.items():
        cached = scfg.get("prefix_cache", False)
        kernel = "paged_prefill_attention" if cached else \
            "flash_attention_fwd_masked"
        tokens = {}
        for graphed in (False, True):
            run = f"{name} {'captured' if graphed else 'uncaptured'}"
            torch.cuda.reset_peak_memory_stats()
            srv, rids, res, wall, launches = serve(
                cfg, 0, 0, None, None, scfg, torch.bfloat16, phases=traffic,
                params=params, engine_kw=dict(enable_cuda_graph=graphed))
            tokens[graphed] = [(res[r].state, res[r].tokens) for r in rids]
            m = srv.metrics
            snap = m.snapshot()
            finished = sum(res[r].state == "finished" for r in rids)
            log(f"serve two-program {run}: llama3_8b x{L} layers bf16, "
                f"{len(rids)} requests (4 x 4 sharing 512-token prefixes), "
                f"{finished} finished, {m.steps} steps, {srv.decode_calls} "
                f"decode forwards, {srv.prefill_chunk_calls} chunk forwards, "
                f"{srv.prefill_calls} monolithic prefills, wall {wall:.3f} "
                f"s, generated {m.tokens_generated} tokens = "
                f"{m.tokens_generated / wall:.1f} tok/s, prefill "
                f"{m.prefill_tokens} tokens ({m.prefill_tokens_computed} "
                f"computed, {m.cached_prefill_tokens} cached, hit rate "
                f"{m.prefix_hit_rate:.3f}, {m.prefix_hits} prefix hits, "
                f"{m.cow_copies} page copies), ttft_p50 "
                f"{snap.get('ttft_p50_s', float('nan')):.3f} s, mean step "
                f"{1e3 * wall / max(m.steps, 1):.2f} ms, preemptions "
                f"{m.preemptions}, quarantines {m.logit_quarantines}, "
                f"graphs {len(srv._graphs)}, wrapper launches {launches}, "
                f"peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
                f"last decode step decode_mbu {m.decode_mbu}, decode_mfu "
                f"{m.decode_mfu}, tokens/s "
                f"{m.decode_tokens_per_sec_per_chip}")
            srv.block_pool.check_consistent()
            problems = utilization_problems(
                f"serve two-program {run}", decode_mbu=m.decode_mbu,
                decode_mfu=m.decode_mfu)
            if finished != len(rids):
                problems.append(f"{len(rids) - finished} requests did not "
                                f"finish")
            if m.logit_quarantines:
                problems.append(f"{m.logit_quarantines} rows flagged NaN/Inf")
            if srv.block_pool.used_count:
                problems.append(f"{srv.block_pool.used_count} pages leaked")
            if cached and m.prefix_hits < 12:
                problems.append(f"{m.prefix_hits} prefix hits < 12")
            if not graphed:
                want = {"ragged_paged_attention": 0,
                        "paged_decode_attention": L * srv.decode_calls,
                        "paged_prefill_attention":
                            L * srv.prefill_chunk_calls,
                        "flash_attention_fwd_masked": L * srv.prefill_calls}
                if launches != want or not srv.decode_calls or \
                        bool(srv.prefill_chunk_calls) != cached or \
                        bool(srv.prefill_calls) == cached:
                    problems.append(f"launches {launches} != {want}")
                out[name] = launches
            else:
                # the first group's prompts again (their prefixes cached),
                # on graphs captured in the run above: the kernels of each
                # replayed forward, counted on the device
                if tokens[True] != tokens[False]:
                    problems.append("the captured run's tokens differ from "
                                    "the uncaptured run's")
                calls = (srv.decode_calls, srv.prefill_chunk_calls,
                         srv.prefill_calls)
                counts, busy, prof_wall = profiled(lambda: serve(
                    cfg, 0, 0, None, None, scfg, torch.bfloat16,
                    phases=[[(p, 8) for p, _ in traffic[0]]], srv=srv),
                    ("paged_decode_attention", kernel))
                dec, chunk, mono = (a - b for a, b in zip(
                    (srv.decode_calls, srv.prefill_chunk_calls,
                     srv.prefill_calls), calls))
                want = {"paged_decode_attention": L * dec,
                        kernel: L * (chunk if cached else mono)}
                log(f"serve two-program {run} replays: {dec} decode, "
                    f"{chunk} chunk and {mono} monolithic forwards, kernels "
                    f"{counts} (want {want}), device busy {busy:.1f} of "
                    f"{prof_wall:.1f} ms profiled (idle share "
                    f"{1 - busy / max(prof_wall, 1e-9):.3f})")
                if counts != want or not dec:
                    problems.append(f"replayed kernels {counts} != {want}")
                replayed[name] = counts
                if srv.block_pool.used_count:
                    problems.append(f"{srv.block_pool.used_count} pages "
                                    f"leaked after the replays")
            if problems:
                raise AssertionError(f"serve two-program {run}: "
                                     + "; ".join(problems))
            del srv, res
            gc.collect()
            torch.cuda.empty_cache()
    check_chaos_serve(
        "two-program", base, params,
        dict(LEGACY_SCFG, prefix_cache=True, prefill_chunk_tokens=PAGED_CHUNK,
             prefill_token_budget=256), [[(np.arange(200), 4)]], phases)
    return out, replayed


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def model_flops_per_step(n_params, batch, seq, n_layer, hidden):
    """fwd+bwd FLOPs: 6 N tokens + attention 12 L B T^2 H (the JAX
    package's bench formula, PaLM appendix B)."""
    return 6.0 * n_params * batch * seq + 12.0 * n_layer * batch * seq \
        * seq * hidden


def train_kernels():
    """The wrappers of the training step's kernels, by name: K1 (forward
    and recompute), K2 (dQ, dK/dV), K3."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam

    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "fused_adam": fused_adam}


def profiled(fn, names):
    """Run ``fn()`` once under torch.profiler (then synchronize). Returns
    the runs of each kernel of ``names`` (wrapper names), counted on the
    device by the kernel itself (CUDA-graph replays included; a trace may
    drop a kernel's record, the count does not), the device busy time
    (union of the trace's kernel intervals, ms) and the profiled wall
    time (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.ops import _runs

    torch.cuda.synchronize()
    for n in names:
        _runs.reset_kernel_runs(n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's events, less its copies, fills and annotation spans
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))
               and not getattr(e, "is_user_annotation", False)]
    counts = {n: _runs.kernel_runs(n) for n in names}
    busy, end = 0.0, -1.0
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    return counts, busy / 1e3, wall * 1e3


def train(cfg, config, ids, steps, warmup, device="cuda", graphed=True,
          engine=None):
    """initialize + train_batch on ``cfg`` with weights from seed
    ``config["seed"]`` (or more steps on ``engine``): ``warmup`` steps,
    then the kernel counts set to 0 and ``steps`` steps on the same batch.
    ``graphed`` False runs the step uncaptured (``cuda_graph=False``). The
    counts are the wrappers' (a captured step adds to them when it is
    captured, not when it is replayed). Returns the engine, every step's
    loss (device scalars), the wall time of the counted steps and their
    launches per kernel."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaForCausalLM

    counted = train_kernels()
    if engine is None:
        engine, *_ = dt.initialize(model=LlamaForCausalLM(cfg),
                                   config=dict(config), device=device,
                                   cuda_graph=graphed)
    batch = {"input_ids": ids, "labels": ids}
    losses = [engine.train_batch(batch=batch) for _ in range(warmup)]
    if device == "cuda":
        torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses += [engine.train_batch(batch=batch) for _ in range(steps)]
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return engine, losses, wall, {n: fn.launches for n, fn in counted.items()}


#: the JAX package's training bench config (bench.py), one device
TRAIN_CONFIG = {"train_batch_size": 8,
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 1e-4, "weight_decay": 0.1}},
                "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                "steps_per_print": 0, "seed": 0}
TRAIN_SEQ = 1024

#: the small reference's runs: fp32, and fp16 whose first steps overflow
#: (a loss scale of 2**26, hysteresis 1: halved each overflow until the
#: steps train)
SMALL_TRAIN_RUNS = {
    "fp32": ({}, 0),
    "fp16": ({"fp16": {"enabled": True, "initial_scale_power": 26,
                       "hysteresis": 1}}, 1),
}


def check_small_train_reference(device="cuda"):
    """A 2-layer model (D 64, MHA) trained 5 steps in fp32, and 10 steps
    in fp16 from a loss scale that overflows its first steps, each twice from
    the same weights (captured): with the kernels, and with the model's
    attention and the optimizer's sweep swapped for their plain versions.
    Losses agree to 1e-4 relative (fp32: summation order only; fp16: the
    attention runs the fp32 kernels on exactly widened inputs in both
    routes, the fp16 rounding of the rest is the same), the fp16 runs skip
    the same steps at the same loss scales."""
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.models import layers as layers_mod
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as adam_mod
    from deepspeed_tpu_torch.ops import optimizers as opt_mod

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=4, max_position_embeddings=256)
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size, (4, 256))
    kernels = (layers_mod.flash_attention, opt_mod.fused_adam)

    def plain_flash(q, k, v, causal=True, sm_scale=None, window=None):
        return fa.flash_attention_plain(q, k, v, causal, sm_scale,
                                        window)[0]

    def plain_adam(*lists, table=None, **kw):
        # the plain version reads no table, so it returns none to keep
        adam_mod.fused_adam_plain(*lists, **kw)

    for name, (over, min_skips) in SMALL_TRAIN_RUNS.items():
        config = dict(TRAIN_CONFIG, train_batch_size=4,
                      bf16={"enabled": False}, **over,
                      optimizer={"type": "AdamW",
                                 "params": {"lr": 1e-3, "weight_decay": 0.1}})
        steps = 10 if over else 5
        losses, launches, state = {}, {}, {}
        for route in ("kernel", "plain"):
            if route == "plain":
                layers_mod.flash_attention = plain_flash
                opt_mod.fused_adam = plain_adam
            try:
                engine, out, _, launches[route] = train(cfg, config, ids,
                                                        steps, 0, device)
            finally:
                layers_mod.flash_attention, opt_mod.fused_adam = kernels
            losses[route] = [float(x) for x in out]
            state[route] = (engine.get_skipped_steps(), engine.loss_scale)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"],
                                                      losses["plain"]))
        ok = rel <= 1e-4 and all(launches["kernel"].values()) and \
            not any(launches["plain"].values()) and \
            state["kernel"] == state["plain"] and \
            state["kernel"][0] >= min_skips and \
            all(np.isfinite(losses["kernel"]))
        log(f"reference: 2-layer {name} model trained {steps} steps "
            f"(captured), kernels vs plain versions: losses "
            f"{losses['kernel']} vs {losses['plain']}, max relative "
            f"difference {rel:.3e} (tolerance 1e-4), skipped steps and "
            f"loss scale {state['kernel']} / {state['plain']}, ok={ok} "
            f"(launches {launches['kernel']} / {launches['plain']})")
        if not ok:
            raise AssertionError(f"small {name} training: the losses or the "
                                 f"skipped steps disagree, or a route "
                                 f"launched the wrong kernels")


def gauge_turn(engine, batch, steps):
    """``steps`` + 1 more steps on ``engine``, each waited for
    (``perf_summary()``): after each step but the first, the engine's
    ``train_tflops_per_chip`` gauge (that step's device time, from the
    previous step's end to its end on CUDA events) and the host's wall
    time between the same two step ends. Returns the losses, the gauges
    and the wall times."""
    losses = [engine.train_batch(batch=batch)]
    engine.perf_summary()
    t = time.perf_counter()
    gauges, walls = [], []
    for _ in range(steps):
        losses.append(engine.train_batch(batch=batch))
        engine.perf_summary()
        now = time.perf_counter()
        gauges.append(engine.registry.snapshot()["train_tflops_per_chip"])
        walls.append(now - t)
        t = now
    return losses, gauges, walls


def check_training(cfg=None, device="cuda"):
    """Full-width Llama-400M (all 24 layers, random weights from seed 0)
    through initialize -> train_batch at the bench config, twice from the
    same weights: uncaptured (``cuda_graph=False``) and captured (one CUDA
    graph a step), each 2 warm-up steps, then 5 timed steps each in turns
    (uncaptured, captured, captured, uncaptured), then 6 steps each
    waited for (:func:`gauge_turn`: the engine's gauge against the hand
    count over the last 5, within 5%) and one profiled step each. The
    losses of the two routes must be identical step for step,
    finite and falling; each route's profiled step must run K1 2 x layers
    (forward and recompute), K2 layers + layers and K3 once (the captured
    one in its replay), counted on the device. Returns the uncaptured
    route's launches over its timed steps (the wrappers' counts) and the
    kernels' runs in the captured route's profiled replay."""
    from deepspeed_tpu_torch.models import LlamaConfig

    cfg = cfg or LlamaConfig.llama_400m(max_position_embeddings=TRAIN_SEQ,
                                        remat=True)
    warmup, turn = 2, 5
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_CONFIG["train_batch_size"], TRAIN_SEQ)))
    L = cfg.num_hidden_layers
    routes = {}
    for graphed in (False, True):
        if device == "cuda":
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        engine, losses, _, _ = train(cfg, TRAIN_CONFIG, ids, 0, warmup,
                                     device, graphed)
        peak = torch.cuda.max_memory_allocated() - base \
            if device == "cuda" else 0
        routes[graphed] = dict(engine=engine, losses=losses, wall=0.0,
                               launches={}, setup=time.perf_counter() - t,
                               peak=peak)
    for graphed in (False, True, True, False):
        r = routes[graphed]
        _, more, wall, launches = train(cfg, TRAIN_CONFIG, ids, turn, 0,
                                        device, engine=r["engine"])
        r["losses"] += more
        r["wall"] += wall
        for n, c in launches.items():
            r["launches"][n] = r["launches"].get(n, 0) + c
    batch = {"input_ids": ids, "labels": ids}
    steps = 2 * turn
    n_params = sum(p.numel() for p in routes[False]["engine"].master.values())
    tokens = TRAIN_CONFIG["train_batch_size"] * TRAIN_SEQ
    flops = model_flops_per_step(n_params, TRAIN_CONFIG["train_batch_size"],
                                 TRAIN_SEQ, L, cfg.hidden_size)
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "fused_adam": 1}
    problems = []
    for graphed in (False, True):
        r = routes[graphed]
        engine = r["engine"]
        name = "captured" if graphed else "uncaptured"
        step_s = r["wall"] / steps
        # the engine's own gauge against the hand count over the same
        # steps: `turn` more steps, each waited for, the gauge read after
        # each (device time on CUDA events) and the host's wall time
        # between the same step ends; both as total work over total time
        more, tflops, walls = gauge_turn(engine, batch, turn)
        r["losses"] += more
        gauges = engine.registry.snapshot()
        r["train_mfu"] = gauges.get("train_mfu")
        ok = all(g is not None for g in tflops)
        r["train_tflops"] = len(tflops) / sum(1 / g for g in tflops) \
            if ok else None
        hand_tflops = flops / (sum(walls) / turn) / 1e12
        log(f"train {name} gauges: train_tflops_per_chip over {turn} "
            f"waited steps {[round(g, 3) for g in tflops] if ok else tflops} "
            f"(each step's device time, the previous step's end to its end "
            f"on CUDA events; {r['train_tflops']} over the {turn}), hand "
            f"count {hand_tflops:.3f} TFLOP/s over the host's wall time "
            f"between the same step ends ({[round(1e3 * w, 3) for w in walls]}"
            f" ms), last train_mfu {r['train_mfu']}; the timed steps: "
            f"{flops / step_s / 1e12:.3f} TFLOP/s over all {steps} = "
            f"{flops / step_s / BF16_FLOP_PER_S:.4f} of 989, train_batch_s "
            f"p50 {gauges.get('train_batch_s_p50')} s, program "
            f"{engine.perf.programs.table()}")
        if device == "cuda":
            problems += utilization_problems(f"train {name}",
                                             train_mfu=r["train_mfu"])
            if r["train_tflops"] is None or \
                    abs(r["train_tflops"] / hand_tflops - 1) > 0.05:
                problems.append(f"{name}: train_tflops_per_chip "
                                f"{r['train_tflops']} over {turn} steps not "
                                f"within 5% of the hand count "
                                f"{hand_tflops:.3f} over the same steps")
        if device == "cuda":
            losses = r["losses"]
            replayed, busy, prof_wall = profiled(
                lambda: losses.append(engine.train_batch(batch=batch)),
                want)
        else:
            replayed, busy, prof_wall = {}, 0.0, 0.0
        r["replayed"] = replayed
        r["losses"] = [float(x) for x in r["losses"]]
        log(f"train {name}: llama_400m x{L} layers ({n_params} params) "
            f"bf16, batch {TRAIN_CONFIG['train_batch_size']} x {TRAIN_SEQ}, "
            f"{warmup} warm-up + {steps} timed steps (in turns), step "
            f"{1e3 * step_s:.2f} ms, {tokens / step_s:.1f} tokens/s, model "
            f"{flops / step_s / 1e12:.2f} TFLOP/s = "
            f"{flops / step_s / BF16_FLOP_PER_S:.4f} of 989, device busy "
            f"{busy:.2f} ms of a profiled step of {prof_wall:.2f} ms (idle "
            f"share {1 - busy / max(prof_wall, 1e-9):.3f} profiled, "
            f"{1 - busy / (1e3 * step_s):.3f} of the unprofiled step), "
            f"losses {[round(x, 4) for x in r['losses']]}, grad norm "
            f"{engine.get_global_grad_norm():.4f}, setup {r['setup']:.1f} s, "
            f"peak memory {r['peak'] / 2**30:.1f} GiB, wrapper launches "
            f"over the timed steps {r['launches']}, kernel runs in the profiled "
            f"step {replayed}")
        losses = r["losses"]
        if not all(np.isfinite(losses)):
            problems.append(f"{name}: a loss is not finite")
        if not losses[-1] < losses[0]:
            problems.append(f"{name}: the loss did not fall ({losses[0]} -> "
                            f"{losses[-1]})")
        if device == "cuda" and replayed != want:
            problems.append(f"{name}: kernels of a step {replayed} != {want}")
    if routes[False]["launches"] != {n: c * steps for n, c in want.items()}:
        problems.append(f"uncaptured wrapper launches "
                        f"{routes[False]['launches']} != {want} x {steps}")
    if routes[True]["losses"] != routes[False]["losses"]:
        problems.append("the captured and uncaptured losses differ")
    if problems:
        raise AssertionError("train: " + "; ".join(problems))
    return routes[False]["launches"], routes[True]["replayed"]


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ragged = check_ragged_attention()
    paged = check_paged_attention()
    flash, flash_masked = check_flash_attention()
    adam = check_fused_adam()
    decode = check_decode_attention()
    quant, int8_col = check_quant_matmul()
    sparse = check_block_sparse_attention()
    check_small_reference()
    check_small_legacy_reference()
    tf32_launches = check_small_generate_reference()
    check_small_train_reference()
    serve_launches, serve_runs = check_serving()
    gc.collect()
    torch.cuda.empty_cache()
    legacy_launches, legacy_replayed = check_serving_legacy()
    gc.collect()
    torch.cuda.empty_cache()
    gen_launches, gen_decode = check_generate()
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_replayed = check_training()
    gc.collect()
    torch.cuda.empty_cache()
    sparse_launches = check_long_context()

    main_case = ragged["bf16/mixed"]
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/ragged_attention.py:64",
        "launches": serve_launches,
        "max_abs_err": max(r["max_abs_err"] for r in ragged.values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
    }]
    # K7a and K7b: launches of the two-program serve with the prefix cache;
    # graph_launches: their runs in its captured engine's profiled replays
    decode_src = "deepspeed_tpu/ops/pallas/decode_attention.py"
    for name, kind, main_name, line in (
            ("paged_decode_attention", "decode", PAGED_DECODE_MAIN, 254),
            ("paged_prefill_attention", "prefill", PAGED_PREFILL_MAIN, 425)):
        kernels.append(dict(
            name=name, route="cuda",
            source="deepspeed_tpu_torch/csrc/paged_attention.cu",
            replaces=f"{decode_src}:{line}",
            launches=legacy_launches["chunked+prefix_cache"][name],
            graph_launches=legacy_replayed["chunked+prefix_cache"][name],
            **dict(paged[kind][main_name], max_abs_err=max(
                r["max_abs_err"] for r in paged[kind].values()))))
    flash_src = "deepspeed_tpu/ops/pallas/flash_attention.py"
    # K1's masked mode: launches of the two-program serve's monolithic
    # prefills (the 8B generate with the flag adds one per layer)
    kernels.append(dict(
        name="flash_attention_fwd_masked", route="cuda",
        source="deepspeed_tpu_torch/csrc/flash_attention.cu",
        replaces=f"{flash_src}:41",
        launches=legacy_launches["monolithic+flash"][
            "flash_attention_fwd_masked"],
        graph_launches=legacy_replayed["monolithic+flash"][
            "flash_attention_fwd_masked"],
        **dict(flash_masked[FLASH_MASKED_MAIN], max_abs_err=max(
            r["max_abs_err"] for r in flash_masked.values()))))
    for name, part, line in (("flash_attention_fwd", "fwd", 41),
                             ("flash_attention_bwd_dq", "dq", 175),
                             ("flash_attention_bwd_dkv", "dkv", 221)):
        kernels.append(dict(
            name=name, route="cuda",
            source="deepspeed_tpu_torch/csrc/flash_attention.cu",
            replaces=f"{flash_src}:{line}", launches=train_launches[name],
            graph_launches=train_replayed[name],
            **dict(flash[FLASH_MAIN][part], max_abs_err=max(
                r[part]["max_abs_err"] for r in flash.values()))))
    kernels.append(dict(
        name="fused_adam", route="cuda",
        source="deepspeed_tpu_torch/csrc/fused_adam.cu",
        replaces="deepspeed_tpu/ops/pallas/fused_adam.py:37",
        launches=train_launches["fused_adam"],
        graph_launches=train_replayed["fused_adam"], **adam))
    # K4, K5 and K8: launches of the int8-weight 8B generate (K4 runs the
    # same count in the bf16 run; K5's prefill kernel,
    # wgmma_prefill_kernel, is its own entry at the prefill shape; no
    # projection of the path has K8's per-column scales)
    for name, csrc, replaces, results, main_name, launches in (
            ("decode_attention", "decode_attention", "decode_attention.py:36",
             decode, DECODE_MAIN, gen_launches["int8"][0]),
            ("quant_matmul", "quant_matmul", "quant_matmul.py:151", quant,
             QUANT_MAIN, gen_launches["int8"][1]),
            ("quant_matmul_prefill", "quant_matmul", "quant_matmul.py:151",
             quant, QUANT_PREFILL_MAIN, gen_launches["int8"][3]),
            ("int8_matmul", "quant_matmul", "int8_matmul.py:41", int8_col,
             INT8_COL_MAIN, gen_launches["int8"][6])):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"deepspeed_tpu_torch/csrc/{csrc}.cu",
            replaces=f"deepspeed_tpu/ops/pallas/{replaces}",
            launches=launches,
            **dict(results[main_name], max_abs_err=max(
                r["max_abs_err"] for r in results.values()))))
    # K5/K8's ragged kernel (rows TMA cannot address): its launches in the
    # int8-weight 8B generate (0: every Llama-3-8B projection is aligned);
    # its decode (M <= 8) and prefill entries are held at the wide ragged
    # cases, each with the worst error of its cases
    from deepspeed_tpu_torch.ops.quant_matmul import GEMV_MAX_ROWS, \
        kernel_route

    def ragged_part(M, K, N, dt):
        if kernel_route(M, K, N, dt) != "ragged":
            return None
        return "decode" if M <= GEMV_MAX_ROWS else "prefill"

    for part, main_name in RAGGED_MAIN.items():
        errs = [quant[n]["max_abs_err"] for n, (M, K, N, _, _, dt)
                in QUANT_CASES.items() if ragged_part(M, K, N, dt) == part]
        errs += [int8_col[n]["max_abs_err"] for n, (M, K, N, dt)
                 in INT8_COL_CASES.items()
                 if ragged_part(M, K, N, dt) == part]
        kernels.append(dict(
            name=f"quant_matmul_ragged_{part}", route="cuda",
            source="deepspeed_tpu_torch/csrc/quant_matmul.cu",
            replaces="deepspeed_tpu/ops/pallas/quant_matmul.py:151",
            launches=gen_launches["int8"][5],
            **dict(quant[main_name], max_abs_err=max(errs))))
    # K5/K8's fp32 decode (gemv_tf32_kernel): no full-width path runs fp32
    # x, so its launches are the small fp32 reference generate's with int8
    # weights (the kernel route's decode steps); held at its int4 case, with
    # the worst error of every fp32 decode case of K5 and K8
    errs = [quant[n]["max_abs_err"] for n, (M, K, N, _, _, dt)
            in QUANT_CASES.items() if kernel_route(M, K, N, dt) == "gemv_tf32"]
    errs += [int8_col[n]["max_abs_err"] for n, (M, K, N, dt)
             in INT8_COL_CASES.items()
             if kernel_route(M, K, N, dt) == "gemv_tf32"]
    kernels.append(dict(
        name="quant_matmul_gemv_tf32", route="cuda",
        source="deepspeed_tpu_torch/csrc/quant_matmul.cu",
        replaces="deepspeed_tpu/ops/pallas/quant_matmul.py:151",
        launches=tf32_launches,
        **dict(quant[GEMV_TF32_MAIN], max_abs_err=max(errs))))
    # K9: launches of the long-context path's six forward + backward runs
    sparse_src = "deepspeed_tpu/ops/pallas/block_sparse_attention.py"
    for name, part, line in (("block_sparse_attention_fwd", "fwd", 55),
                             ("block_sparse_attention_bwd_dq", "dq", 103),
                             ("block_sparse_attention_bwd_dkv", "dkv", 143)):
        main_case = dict(sparse[SPARSE_MAIN][part])
        for extra in ("flex_ms", "sdpa_ms"):
            main_case.pop(extra)
        main_case["max_abs_err"] = max(r[part]["max_abs_err"]
                                       for r in sparse.values())
        kernels.append(dict(
            name=name, route="cuda",
            source="deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
            replaces=f"{sparse_src}:{line}", launches=sparse_launches[name],
            **main_case))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
