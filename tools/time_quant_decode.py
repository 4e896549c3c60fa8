"""Time the port's K4 decode attention and K5/K8 quantized matmuls on one
CUDA card, for one checkout of the port.

    python3 tools/time_quant_decode.py [--root DIR] [--reps N] [--generate]
        [--match REGEX] [--kernels]

Imports ``deepspeed_tpu_torch`` from ``--root`` (default: this checkout)
and builds its kernels there. Times with ``chip_smoke.cuda_time_ms`` (CUDA
events, the L2 cache flushed before each run, the median of ``--reps``):
K4 at every ``chip_smoke.DECODE_CASES`` case beside SDPA on the filled
prefix (bf16 cases without a window or int8 cache), then K5 at every
``chip_smoke.QUANT_CASES`` case and K8 at every
``chip_smoke.INT8_COL_CASES`` case, each beside ``torch.matmul`` on the
pre-dequantized weight and its bound (``chip_smoke._matmul_bound``: for
the fp32 route, two TF32 passes at the tensor-core peak). ``--match``
times only the cases whose name (``decode_...``, ``quant_...``,
``int8_col_...``) the regular expression finds: ``--match fp32`` takes
K5's and K8's fp32 cases, ``--match ragged`` the cases whose rows TMA
cannot address. With ``--kernels`` each matmul case also gets the device
µs a call of every kernel it launches, from ``torch.profiler`` over
``--reps`` calls (L2 warm). The inputs come from the seeds
``chip_smoke.py`` uses, so every tree sees the same ones. With
``--generate`` it also runs ``chip_smoke.py``'s int8-weight Llama-3-8B
``generate`` (batch 8, prompts bucketed to 512, 64 new tokens) and prints
its prefill and mean decode-step ms. Prints one JSON line per case, with
the tree, the card's name and its power limit.

To compare two trees on one card, run it once per tree in turns in one
command (parent, change, change, parent).
"""

import argparse
import importlib.util
import json
import os
import re
import sys

import torch

from time_paged_attention import kernel_us

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(tree, case, **fields):
    print(json.dumps({"tree": tree, "case": case, **fields}), flush=True)


def time_decode(cs, tree, reps, match):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.decode_attention import decode_attention

    for i, (case, (B, Hq, Hkv, S, Dh, dtype, int8, window, cidx)) in \
            enumerate(cs.DECODE_CASES.items()):
        if not re.search(match, f"decode_{case}"):
            continue
        q, k, v, mask, scales = cs.decode_case(B, Hq, Hkv, S, Dh, dtype, int8,
                                               seed=i + 11)
        ci = torch.tensor(cidx, dtype=torch.int32, device="cuda")
        kw = dict(key_mask=mask, window=window, **scales)
        ms = cs.cuda_time_ms(lambda: decode_attention(q, k, v, ci, **kw),
                             reps=reps)
        sdpa = None
        if dtype == torch.bfloat16 and window is None and not int8:
            n = min(cidx, S - 1) + 1
            am = (mask[:, :n] > 0)[:, None, None, :]
            sdpa = cs.cuda_time_ms(
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None], k[:, :, :n], v[:, :, :n], attn_mask=am,
                    enable_gqa=True), reps=reps)
        emit(tree, f"decode_{case}", ms=ms, sdpa_ms=sdpa)
        del q, k, v, mask, scales


def _bound_ms(cs, qm, x, codes, scale, N):
    """``chip_smoke.py``'s bound of a quantized matmul: each input byte
    read once and the output written once over the card's memory rate,
    or its operations over the peak of the arithmetic its route runs,
    whichever is longer."""
    M, K = x.shape
    nbytes = codes.numel() + scale.numel() * 4 \
        + (M * K + M * N) * x.element_size()
    return cs._matmul_bound(qm, M, K, N, x.dtype, nbytes)[0]


def time_matmuls(cs, tree, reps, match, kernels):
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    for i, (case, (M, K, N, mode, group, dtype)) in \
            enumerate(cs.QUANT_CASES.items()):
        if not re.search(match, f"quant_{case}"):
            continue
        g = torch.Generator(device="cuda").manual_seed(i + 21)
        x = torch.randn((M, K), generator=g, device="cuda", dtype=dtype)
        codes, scale = qm.quantize_linear_weight(
            torch.randn((K, N), generator=g, device="cuda") * 0.02, mode,
            group)
        wd = qm.dequantize_linear_weight(codes, scale, mode, dtype)
        call = lambda: qm.quant_matmul(x, codes, scale, mode)  # noqa: E731
        emit(tree, f"quant_{case}", ms=cs.cuda_time_ms(call, reps=reps),
             library_ms=cs.cuda_time_ms(lambda: torch.matmul(x, wd),
                                        reps=reps),
             bound_ms=_bound_ms(cs, qm, x, codes, scale, N),
             **({"kernel_us": kernel_us(call, reps)} if kernels else {}))
        del x, codes, scale, wd
    for i, (case, (M, K, N, dtype)) in enumerate(cs.INT8_COL_CASES.items()):
        if not re.search(match, f"int8_col_{case}"):
            continue
        g = torch.Generator(device="cuda").manual_seed(i + 41)
        x = torch.randn((M, K), generator=g, device="cuda", dtype=dtype)
        codes, scale = qm.quantize_weight_per_col(
            torch.randn((K, N), generator=g, device="cuda") * 0.02)
        wd = (codes.float() * scale).to(dtype)
        call = lambda: qm.int8_matmul(x, codes, scale)  # noqa: E731
        emit(tree, f"int8_col_{case}", ms=cs.cuda_time_ms(call, reps=reps),
             library_ms=cs.cuda_time_ms(lambda: torch.matmul(x, wd),
                                        reps=reps),
             bound_ms=_bound_ms(cs, qm, x, codes, scale, N),
             **({"kernel_us": kernel_us(call, reps)} if kernels else {}))
        del x, codes, scale, wd


def time_generate(cs, tree):
    from deepspeed_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.llama3_8b()
    ids, mask = cs.left_padded_prompts(cfg.vocab_size, cs.GEN_B, 128,
                                       cs.GEN_PROMPT, 0)
    # a tree's generate_run may return the capturing warm-up's counts
    # before the last item
    res = cs.generate_run(cfg, torch.bfloat16, "int8", ids, mask, cs.GEN_NEW)
    out, engine, prefill_s, total_s, launches = res[:5]
    finite = res[-1]
    emit(tree, "generate_int8", prefill_ms=1e3 * prefill_s,
         decode_step_ms=1e3 * (total_s - prefill_s) / (cs.GEN_NEW - 1),
         tokens_per_s=cs.GEN_B * cs.GEN_NEW / total_s, launches=launches,
         finite=finite)
    del out, engine
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--generate", action="store_true",
                    help="also time the int8-weight 8B generate")
    ap.add_argument("--match", default="",
                    help="time only the cases this regex finds")
    ap.add_argument("--kernels", action="store_true",
                    help="also print each matmul kernel's device us a call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_quant_decode: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.relpath(os.path.abspath(args.root), ROOT)
    sys.path.insert(0, os.path.abspath(args.root))
    from deepspeed_tpu_torch.ops import _build

    assert _build.__file__.startswith(os.path.abspath(args.root))
    cs = _chip_smoke()
    print(f"device: {cs.nvidia_smi()} | {torch.cuda.get_device_name(0)} | "
          f"tree {tree}", flush=True)
    _build.build(["decode_attention", "quant_matmul"])
    torch.backends.cuda.matmul.allow_tf32 = False
    time_decode(cs, tree, args.reps, args.match)
    time_matmuls(cs, tree, args.reps, args.match, args.kernels)
    if args.generate:
        time_generate(cs, tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
