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
   K6 ragged paged attention at the serving step's shapes; K1/K2 flash
   attention forward, dQ and dK/dV at the training step's (B 8, H 16,
   T 1024, D 64, bf16, causal), with gradients through the autograd
   function; K3 fused Adam over the whole Llama-400M parameter list;
4. small references: a 2-layer fp32 model served with K6 and with its
   plain version (identical tokens), and trained 5 steps with K1/K2/K3
   and with their plain versions (losses within 1e-4 relative);
5. serve: init_inference + ServingEngine on full-width Llama-3-8B (random
   bf16 weights from a seed, all 32 layers), 16 seeded requests to
   completion; asserts every request finished, no logit was flagged, no
   page leaked, and the kernel ran once per layer per mixed step;
6. train: initialize + train_batch on full-width Llama-400M (random
   weights from seed 0, all 24 layers), the JAX package's bench config
   (batch 8 x 1024, AdamW, bf16, clipping 1.0), 2 warm-up and 10 timed
   steps on one batch; asserts finite, falling losses and the launch
   counts of K1 (forward and recompute), K2 and K3;
7. a ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and last the
   ``{"ok": true, "device": {...}}`` line.

Exits non-zero without printing a result when no CUDA device is present.
"""

import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores

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
    K2 kernels) on every case."""
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
    return results


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
    clip factor, in both decay modes, against the plain version on
    copies. Tolerance: 1e-6 relative + 1e-7 absolute (the kernel fuses
    multiply-adds that the plain version rounds twice: about one fp32 ulp
    a step). Times one step of each, and torch.optim.AdamW(fused=True)
    on the same tensors as the yardstick."""
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam, fused_adam_plain

    cfg = LlamaConfig.llama_400m()
    b1, b2, eps, wd, lr = 0.9, 0.999, 1e-8, 0.1, 1e-4
    scale = torch.tensor(0.5, device="cuda")

    def hyper(t, adam_w_mode):
        return dict(b1=b1, b2=b2, eps=eps, weight_decay=wd,
                    adam_w_mode=adam_w_mode, step_size=lr / (1 - b1 ** t),
                    lr=lr, inv_bc2=1 / (1 - b2 ** t) ** 0.5,
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
        del state, ref
    params, grads, m, v = adam_state(cfg, seed=2)
    n = sum(p.numel() for p in params)
    kw = hyper(4, True)
    ms = cuda_time_ms(lambda: fused_adam(params, grads, m, v, **kw))
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
        f"elements), 3 steps x both decay modes: ok max_abs_err="
        f"{max_err:.3e} (tolerance 1e-6*|plain|+1e-7) | kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}) "
        f"library_ms={library_ms:.4f}")
    del params, grads, m, v, lib
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


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


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def model_flops_per_step(n_params, batch, seq, n_layer, hidden):
    """fwd+bwd FLOPs: 6 N tokens + attention 12 L B T^2 H (the JAX
    package's bench formula, PaLM appendix B)."""
    return 6.0 * n_params * batch * seq + 12.0 * n_layer * batch * seq \
        * seq * hidden


def train(cfg, config, ids, steps, warmup, device="cuda"):
    """initialize + train_batch on ``cfg`` with weights from seed
    ``config["seed"]``: ``warmup`` steps, then the kernel counts set to 0
    and ``steps`` steps on the same batch. Returns the engine, every
    step's loss (device scalars), the wall time of the counted steps and
    their launches per kernel."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaForCausalLM
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam

    counted = {"flash_attention_fwd": fa.flash_attention_fwd,
               "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
               "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
               "fused_adam": fused_adam}
    engine, *_ = dt.initialize(model=LlamaForCausalLM(cfg),
                               config=dict(config), device=device)
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


def check_small_train_reference(device="cuda"):
    """A 2-layer fp32 model (D 64, MHA) trained 5 steps twice from the same
    weights: with the kernels, and with the model's attention and the
    optimizer's sweep swapped for their plain versions. Losses agree to
    1e-4 relative (fp32 summation order only)."""
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.models import layers as layers_mod
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as adam_mod
    from deepspeed_tpu_torch.ops import optimizers as opt_mod

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=4, max_position_embeddings=256)
    config = dict(TRAIN_CONFIG, train_batch_size=4, bf16={"enabled": False},
                  optimizer={"type": "AdamW",
                             "params": {"lr": 1e-3, "weight_decay": 0.1}})
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size, (4, 256))
    kernels = (layers_mod.flash_attention, opt_mod.fused_adam)
    losses, launches = {}, {}
    for route in ("kernel", "plain"):
        if route == "plain":
            layers_mod.flash_attention = \
                lambda *a, **kw: fa.flash_attention_plain(*a, **kw)[0]
            opt_mod.fused_adam = adam_mod.fused_adam_plain
        try:
            _, out, _, launches[route] = train(cfg, config, ids, 5, 0,
                                               device)
        finally:
            layers_mod.flash_attention, opt_mod.fused_adam = kernels
        losses[route] = [float(x) for x in out]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"],
                                                  losses["plain"]))
    ok = rel <= 1e-4 and all(launches["kernel"].values()) and \
        not any(launches["plain"].values())
    log(f"reference: 2-layer fp32 model trained 5 steps, kernels vs plain "
        f"versions: losses {losses['kernel']} vs {losses['plain']}, max "
        f"relative difference {rel:.3e} (tolerance 1e-4), ok={ok} "
        f"(launches {launches['kernel']} / {launches['plain']})")
    if not ok:
        raise AssertionError("small fp32 training: the losses disagree or "
                             "a route launched the wrong kernels")


def check_training(cfg=None, device="cuda"):
    """Full-width Llama-400M (all 24 layers, random weights from seed 0)
    through initialize -> train_batch at the bench config: 2 warm-up and
    10 timed steps on one seeded batch."""
    from deepspeed_tpu_torch.models import LlamaConfig

    cfg = cfg or LlamaConfig.llama_400m(max_position_embeddings=TRAIN_SEQ,
                                        remat=True)
    steps, warmup = 10, 2
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_CONFIG["train_batch_size"], TRAIN_SEQ)))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    engine, losses, wall, launches = train(cfg, TRAIN_CONFIG, ids, steps,
                                           warmup, device)
    setup = time.perf_counter() - t - wall
    losses = [float(x) for x in losses]
    n_params = sum(p.numel() for p in engine.master.values())
    tokens = TRAIN_CONFIG["train_batch_size"] * TRAIN_SEQ
    step_s = wall / steps
    flops = model_flops_per_step(n_params, TRAIN_CONFIG["train_batch_size"],
                                 TRAIN_SEQ, cfg.num_hidden_layers,
                                 cfg.hidden_size)
    L = cfg.num_hidden_layers
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    log(f"train: llama_400m x{L} layers ({n_params} params) bf16, batch "
        f"{TRAIN_CONFIG['train_batch_size']} x {TRAIN_SEQ}, {warmup} warm-up "
        f"+ {steps} timed steps, step {1e3 * step_s:.2f} ms, "
        f"{tokens / step_s:.1f} tokens/s, model {flops / step_s / 1e12:.2f} "
        f"TFLOP/s = {flops / step_s / BF16_FLOP_PER_S:.4f} of 989, losses "
        f"{[round(x, 4) for x in losses]}, grad norm "
        f"{engine.get_global_grad_norm():.4f}, setup {setup:.1f} s, peak "
        f"memory {peak / 2**30:.1f} GiB, launches {launches}")
    want = {"flash_attention_fwd": 2 * L * steps,
            "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dkv": L * steps, "fused_adam": steps}
    problems = []
    if not all(np.isfinite(losses)):
        problems.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        problems.append(f"the loss did not fall ({losses[0]} -> "
                        f"{losses[-1]})")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if problems:
        raise AssertionError("train: " + "; ".join(problems))
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ragged = check_ragged_attention()
    flash = check_flash_attention()
    adam = check_fused_adam()
    check_small_reference()
    check_small_train_reference()
    serve_launches = check_serving()
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = check_training()

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
    flash_src = "deepspeed_tpu/ops/pallas/flash_attention.py"
    for name, part, line in (("flash_attention_fwd", "fwd", 41),
                             ("flash_attention_bwd_dq", "dq", 175),
                             ("flash_attention_bwd_dkv", "dkv", 221)):
        kernels.append(dict(
            name=name, route="cuda",
            source="deepspeed_tpu_torch/csrc/flash_attention.cu",
            replaces=f"{flash_src}:{line}", launches=train_launches[name],
            **dict(flash[FLASH_MAIN][part], max_abs_err=max(
                r[part]["max_abs_err"] for r in flash.values()))))
    kernels.append(dict(
        name="fused_adam", route="cuda",
        source="deepspeed_tpu_torch/csrc/fused_adam.cu",
        replaces="deepspeed_tpu/ops/pallas/fused_adam.py:37",
        launches=train_launches["fused_adam"], **adam))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
