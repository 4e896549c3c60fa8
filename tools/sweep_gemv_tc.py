"""Sweep the decode kernel of K5/K8 (``gemv_tc_kernel``) on one CUDA card.

    python3 tools/sweep_gemv_tc.py [--reps N]

Builds ``csrc/quant_matmul.cu`` as it is and in two variants, each into
its own library under ``deepspeed_tpu_torch/build/sweep/``:

- ``no_products``: the consumers wait for and release every stage but
  skip the dequantization and the products (wrong results: it times the
  code stream and the reduction alone);
- ``no_evict_first``: the codes are loaded with the default L2 policy.

For each Llama-3-8B decode projection (M 8) in int8 and int4 g64 it
times the C entry at every cluster size 1, 2, 4, 8 (the launch
``quant_matmul`` would make, with the cluster size forced), with
``chip_smoke.cuda_time_ms`` (L2 flushed by a write, as every other
timing of the port), and, at ``gemv_tc_grid``'s cluster size, also after
a flush that leaves L2 holding clean lines (a 256 MB read after the
write), beside ``torch.matmul`` on the dequantized weight timed the same
two ways. Then the fixed cost of a launch: an empty ``fill_``, and one
stage of codes (8 x 128 -> 1024) beside ``torch.matmul``. Prints one
JSON line per case, after the card's name and power limit.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: (name, [(old, new), ...]) source substitutions of each variant
VARIANTS = (
    ("as_is", []),
    ("no_products", [("      gt_step<MODE, PER_ROW>(acc,",
                      "      if (K < 0) gt_step<MODE, PER_ROW>(acc,")]),
    ("no_evict_first", [("hopper::tma_load_2d_hint(", "tma_plain("),
                        ("full(s), evict_first);", "full(s));")]),
)
#: a plain load under the hint's name, for the no_evict_first variant
PLAIN = ("#define tma_plain(dst, map, c0, c1, bar) "
         "hopper::tma_load_2d(dst, map, c0, c1, bar)\n")
CASES = {"up": (8, 4096, 14336), "down": (8, 14336, 4096),
         "q": (8, 4096, 4096), "kv": (8, 4096, 1024)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants():
    """One library per variant, built in parallel; returns their entries."""
    from deepspeed_tpu_torch.ops import _build

    csrc = _build.CSRC
    out = os.path.join(_build.BUILD, "sweep")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(csrc, "quant_matmul.cu")) as f:
        src = f.read()
    procs = {}
    for name, subs in VARIANTS:
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        if name == "no_evict_first":
            text = text.replace('#include "hopper_common.cuh"\n',
                                '#include "hopper_common.cuh"\n' + PLAIN)
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), _build.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", csrc, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        fn = ctypes.CDLL(lib).quant_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def clean_flush_ms(cs, fn, reps):
    """``cuda_time_ms`` with a 256 MB read after the flush's write, so L2
    holds clean lines when ``fn`` starts."""
    clean = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        clean.max()
        torch.cuda._sleep(cs.SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_gemv_tc: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    cs = _chip_smoke()
    print(f"device: {cs.nvidia_smi()} | {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    entries = build_variants()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(entry, x, codes, scale, out, mode, C):
        M, K = x.shape
        N = out.shape[1]

        def call():
            rc = entry(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), out.data_ptr(), M, K, N,
                       scale.shape[0], qm._KERNEL_MODE[mode], 1, C, stream)
            if rc:
                raise RuntimeError(f"launch failed with CUDA error {rc}")
        return call

    for case, (M, K, N) in CASES.items():
        for mode, group in (("int8", 0), ("int4", 64)):
            g = torch.Generator(device="cuda").manual_seed(1)
            x = torch.randn((M, K), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            codes, scale = qm.quantize_linear_weight(
                torch.randn((K, N), generator=g, device="cuda") * 0.02, mode,
                group)
            wd = qm.dequantize_linear_weight(codes, scale, mode,
                                             torch.bfloat16)
            out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
            rule = qm.gemv_tc_grid(K, N, mode, sms)[1]
            row = {"case": f"{case}_{mode}", "M": M, "K": K, "N": N,
                   "cluster_rule": rule,
                   "torch_matmul_ms": cs.cuda_time_ms(
                       lambda: torch.matmul(x, wd), reps=args.reps),
                   "torch_matmul_clean_ms": clean_flush_ms(
                       cs, lambda: torch.matmul(x, wd), args.reps)}
            for name, entry in entries.items():
                for C in (1, 2, 4, 8):
                    if C <= -(-K // 128):
                        row[f"{name}_c{C}_ms"] = cs.cuda_time_ms(
                            launcher(entry, x, codes, scale, out, mode, C),
                            reps=args.reps)
            row["as_is_clean_ms"] = clean_flush_ms(
                cs, launcher(entries["as_is"], x, codes, scale, out, mode,
                             rule), args.reps)
            print(json.dumps(row), flush=True)
            del x, codes, scale, wd, out

    e = torch.empty(1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((8, 128), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    codes, scale = qm.quantize_linear_weight(
        torch.randn((128, 1024), generator=g, device="cuda") * 0.02, "int8")
    wd = qm.dequantize_linear_weight(codes, scale, "int8", torch.bfloat16)
    print(json.dumps({
        "case": "fixed_cost", "empty_fill_ms": cs.cuda_time_ms(
            lambda: e.fill_(1.0), reps=args.reps),
        "one_stage_8x128x1024_ms": cs.cuda_time_ms(
            lambda: qm.quant_matmul(x, codes, scale, "int8"),
            reps=args.reps),
        "one_stage_torch_matmul_ms": cs.cuda_time_ms(
            lambda: torch.matmul(x, wd), reps=args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
