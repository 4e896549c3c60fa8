"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with the reason) where no CUDA device is
present. On a machine with one, run them with
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
Tolerance: fp32 inputs differ only by summation order (1e-5; 2e-5 for
the block-sparse kernels, whose rows sum up to 128 blocks of keys); bf16
outputs are roundings of nearly equal fp32 values, so they agree to one
bf16 ulp (2**-7 relative). The quantized matmuls' absolute slack is
1e-5 of the sum of the products' magnitudes (|x| @ |W|).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import _runs
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import quant_matmul as qm
from deepspeed_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_plain, paged_decode_attention,
    paged_decode_attention_plain, paged_prefill_attention,
    paged_prefill_attention_plain)
from deepspeed_tpu_torch.ops.fused_adam import fused_adam, fused_adam_plain
from deepspeed_tpu_torch.ops import ragged_attention as ra
from deepspeed_tpu_torch.ops.ragged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain)
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, FixedSparsityConfig,
    sparse_attention)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K6 layouts: (N pages, table width nb, rows of (query_len, chunk_start))
RAGGED_LAYOUTS = {
    # decode rows, chunk rows, a narrow row of 3 tokens, idle rows,
    # sentinel tails
    "small": (40, 8, [(1, 70), (0, 0), (37, 20), (20, 0), (1, 127),
                      (3, 40)]),
    # a 2048-token decode row (many key splits), a 256-token chunk behind
    # 512 cached tokens, short decode rows
    "long": (224, 128, [(1, 2047), (0, 0), (256, 512), (1, 300), (1, 0)]),
}


def _ragged_tables(layout_rows, N, nb, rs, bs=16):
    """Block tables and descriptors for rows of (query_len, chunk_start):
    each live row owns distinct seeded pages of ``bs`` tokens covering its
    context (never page N - 1), the rest of its table is the sentinel N."""
    R = len(layout_rows)
    bt = np.full((R, nb), N, np.int32)
    qs, ql, cs, cl = (np.zeros(R, np.int32) for _ in range(4))
    pages, cursor = iter(rs.permutation(N - 1)), 0
    for r, (n, start) in enumerate(layout_rows):
        if n:
            for i in range(-(-(start + n) // bs)):
                bt[r, i] = next(pages)
            qs[r], ql[r], cs[r], cl[r] = cursor, n, start, start + n
            cursor += n
    return bt, qs, ql, cs, cl, cursor


def _pool(dev, dtype, int8, N, Hkv, D, g, owned=None, bs=16):
    """A seeded pool of ``N`` pages of ``bs`` tokens; pages outside
    ``owned`` (page N - 1, where sentinel entries clamp, stays finite) hold
    NaN, or NaN scales in an int8 pool, so a kernel that reads a page it
    must not poisons its rows."""
    shape = (N, Hkv, bs, D)
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8) for _ in range(2))
        scales = {n: torch.rand(shape[:3], generator=g, device=dev) / 64
                  for n in ("k_scale", "v_scale")}
        poison = list(scales.values())
    else:
        k, v = (torch.randn(shape, generator=g, device=dev, dtype=dtype)
                for _ in range(2))
        scales = {}
        poison = [k, v]
    if owned is not None:
        free = torch.ones(N, dtype=torch.bool, device=dev)
        free[torch.as_tensor(np.append(owned, N - 1), device=dev).long()] = \
            False
        for t in poison:
            t[free] = float("nan")
    return k, v, scales


def _case(dev, dtype, int8, D, Hkv, G, seed=0, layout="small", bs=16):
    """Decode rows, chunk rows, idle rows, sentinel tails, padding, and a
    pool whose unused pages hold NaN. Pages of ``bs`` tokens: the table
    keeps the layout's ``nb * 16`` keys, the pool 8 pages beyond the rows'."""
    rs = np.random.RandomState(seed)
    N, nb, rows = RAGGED_LAYOUTS[layout]
    if bs != 16:
        nb = -(-nb * 16 // bs)
        N = sum(-(-(start + n) // bs) for n, start in rows if n) + 8
    bt, qs, ql, cs, cl, cursor = _ragged_tables(rows, N, nb, rs, bs)
    g = torch.Generator(device=dev).manual_seed(seed)
    k, v, scales = _pool(dev, dtype, int8, N, Hkv, D, g, owned=bt[bt < N],
                         bs=bs)
    q = torch.randn((cursor + 5, Hkv * G, D), generator=g, device=dev,
                    dtype=dtype)
    desc = [torch.from_numpy(a).to(dev) for a in (bt, qs, ql, cs, cl)]
    return (q, k, v, *desc), scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8pool"])
@pytest.mark.parametrize("D,Hkv,G", [(128, 2, 4), (64, 3, 1), (128, 1, 8)])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("layout", sorted(RAGGED_LAYOUTS))
def test_ragged_kernel_matches_plain(cuda, dtype, int8, D, Hkv, G, window,
                                     layout):
    """K6 against its plain version on both layouts, with NaN in every
    page no row owns; tokens no row claims come back as zeros."""
    args, scales = _case(cuda, dtype, int8, D, Hkv, G, layout=layout)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args, window=window, **scales)
    ref = ragged_paged_attention_plain(*args, window=window, **scales)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=1e-5 if dtype == torch.float32 else 1e-3)
    assert torch.isfinite(got).all() and not got[-5:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [64, 128, 80, 96, 256])
@pytest.mark.parametrize("B,H,Tq,Tk,causal,window", [
    (2, 3, 256, 256, True, None), (2, 3, 200, 200, True, None),
    (2, 3, 100, 100, False, None), (2, 3, 256, 256, True, 48),
    (2, 3, 40, 130, True, None), (2, 3, 130, 40, True, None),
    (2, 3, 1000, 1000, True, None), (2, 3, 1024, 1024, True, None),
    (1, 2, 1000, 1000, False, None), (2, 3, 1000, 1000, True, 16),
    (2, 3, 300, 100, True, None), (12, 12, 512, 512, True, None)],
    ids=["causal", "uneven", "full", "window", "tq<tk", "tq>tk",
         "tiles+tail1000", "tiles1024", "full1000", "window16",
         "tq>tk_tiles", "grid_wraps"])
def test_flash_kernels_match_plain(cuda, dtype, D, B, H, Tq, Tk, causal,
                                   window):
    """K1 and both K2 kernels against the plain forward and backward on the
    same inputs: several full tiles with and without a ragged tail, rows
    that see no key (Tq > Tk), a window narrower than one tile, and a
    grid of more blocks than the card holds at once."""
    g = torch.Generator(device=cuda).manual_seed(D + Tq)
    q, do = (torch.randn(B, Tq, H, D, generator=g, device=cuda, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Tk, H, D, generator=g, device=cuda, dtype=dtype)
            for _ in range(2))
    counts = [f.launches for f in (fa.flash_attention_fwd,
                                   fa.flash_attention_bwd_dq,
                                   fa.flash_attention_bwd_dkv)]
    out, lse = fa.flash_attention_fwd(q, k, v, causal, window=window)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal,
                                                window=window)
    dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, causal,
                                   window=window)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, causal,
                                        window=window)
    # both backward versions from the kernel's forward: the same inputs
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                       window=window)
    torch.cuda.synchronize()
    assert [f.launches for f in (fa.flash_attention_fwd,
                                 fa.flash_attention_bwd_dq,
                                 fa.flash_attention_bwd_dkv)] == \
        [c + 1 for c in counts]
    fp32 = dtype == torch.float32
    tol = dict(rtol=1e-5 if fp32 else 2 ** -7, atol=1e-5 if fp32 else 2e-2)
    torch.testing.assert_close(out.float(), ref_out.float(), **tol)
    seen = torch.isfinite(ref_lse)
    assert torch.equal(seen, torch.isfinite(lse))
    torch.testing.assert_close(lse[seen], ref_lse[seen], rtol=1e-5,
                               atol=1e-4)
    for got, want in zip((dq, dk, dv), ref):
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("write_update", [False, True])
def test_fused_adam_kernel_matches_plain(cuda, adam_w_mode, write_update):
    """K3 over a list of odd-sized tensors (tails, several chunks), three
    steps with a device clip factor, device scalars (``alpha``) and a
    clear device ``skip`` flag, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(3,), (1000, 7), (70001,), (64, 1024), (5, 3)]
    state = [[torch.randn(s, generator=g, device=cuda) for _ in range(4)]
             for s in shapes]
    for quad in state:
        quad[3].abs_()
    ref = [[t.clone() for t in quad] for quad in state]
    scale = torch.tensor(0.5, device=cuda)
    before = fused_adam.launches
    for t in range(1, 4):
        alpha = torch.tensor([1e-3 / (1 - 0.9 ** t), 1e-3,
                              1 / (1 - 0.999 ** t) ** 0.5], device=cuda)
        kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1,
                  adam_w_mode=adam_w_mode, alpha=alpha,
                  skip=torch.tensor(False, device=cuda), grad_scale=scale,
                  write_update=write_update)
        fused_adam(*zip(*state), **kw)
        fused_adam_plain(*zip(*ref), **kw)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + 3
    for got, want in zip(state, ref):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["cache", "int8cache"])
@pytest.mark.parametrize("D,Hkv,G", [(128, 2, 4), (64, 3, 1), (128, 1, 8),
                                     (80, 2, 3), (96, 1, 24), (256, 1, 8),
                                     (256, 2, 16), (64, 1, 71)])
@pytest.mark.parametrize("S,cidx,window", [
    (200, 0, None), (200, 130, None), (77, 76, None), (300, 250, 64),
    (2048, 1023, None), (2048, 1024, None), (2048, 1025, None),
    (2048, 2000, 300)],
    ids=["first", "mid_tile", "uneven_full", "window", "split_edge_minus1",
         "split_edge", "split_edge_plus1", "window_empties_splits"])
def test_decode_kernel_matches_plain(cuda, dtype, int8, D, Hkv, G, S, cidx,
                                     window):
    """K4 against its plain version: GQA groups, left-padding holes (row 0
    sees no key at position 0), a cache index mid-tile, S no multiple of
    the tile, a window, an int8 cache; at S 2048 (32 or 16 key splits) a
    cache index on a split boundary and either side of it, a window that
    leaves whole splits empty, and a row whose every key is masked."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    B = 3
    q = torch.randn(B, Hkv * G, D, generator=g, device=cuda, dtype=dtype)
    shape = (B, Hkv, S, D)
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, device=cuda,
                              dtype=torch.int8) for _ in range(2))
        scales = {n: torch.rand(shape[:3], generator=g, device=cuda) / 64
                  for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(shape, generator=g, device=cuda, dtype=dtype)
                for _ in range(2))
        scales = {}
    mask = torch.ones(B, S, dtype=torch.int32, device=cuda)
    mask[0, :5] = 0
    mask[1, 40:43] = 0
    if S == 2048:
        mask[2] = 0             # a row that sees no key: zeros
    ci = torch.tensor(cidx, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, ci, key_mask=mask, window=window,
                           **scales)
    ref = decode_attention_plain(q, k, v, ci, key_mask=mask, window=window,
                                 **scales)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    fp32 = dtype == torch.float32
    torch.testing.assert_close(got.float(), ref.float(),
                               rtol=1e-5 if fp32 else 2 ** -7,
                               atol=1e-5 if fp32 else 1e-3)
    if S == 2048:
        assert not got[2].float().abs().sum()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_decode_kernel_launch_is_independent_of_cache_index(cuda, dtype):
    """K4's launch does not depend on the value of ``cache_index``: one
    CUDA graph captured around a call replays correctly for every value of
    the device scalar (split boundaries, the first and the last key, a
    window)."""
    B, Hkv, G, S, D, window = 2, 2, 4, 1000, 128, 200
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(B, Hkv * G, D, generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn(B, Hkv, S, D, generator=g, device=cuda, dtype=dtype)
            for _ in range(2))
    mask = torch.ones(B, S, dtype=torch.int32, device=cuda)
    mask[1, :37] = 0
    ci = torch.zeros((), dtype=torch.int32, device=cuda)
    for w in (None, window):
        decode_attention(q, k, v, ci, key_mask=mask, window=w)  # warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = decode_attention(q, k, v, ci, key_mask=mask, window=w)
        for cidx in (0, 36, 63, 64, 65, 511, 512, 998, 999):
            ci.fill_(cidx)
            graph.replay()
            ref = decode_attention_plain(q, k, v, ci, key_mask=mask,
                                         window=w)
            torch.cuda.synchronize()
            fp32 = dtype == torch.float32
            torch.testing.assert_close(got.float(), ref.float(),
                                       rtol=1e-5 if fp32 else 2 ** -7,
                                       atol=1e-5 if fp32 else 1e-3)


def test_quant_prefill_and_decode_kernels_are_deterministic(cuda):
    """Repeated calls give bitwise equal outputs: K5's wgmma prefill and
    its decode (the gemv_tc kernel's warps and cluster ranks summed in
    order), K8's prefill, and K4's split walk and merge (no atomics
    anywhere)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for M, K, N, mode, group in ((300, 1024, 768, "int8", 0),
                                 (300, 1024, 768, "int4", 64),
                                 (8, 4096, 1024, "int8", 0),
                                 (8, 4096, 1024, "int4", 64)):
        x = torch.randn(M, K, generator=g, device=cuda, dtype=torch.bfloat16)
        codes, scale = qm.quantize_linear_weight(
            torch.randn(K, N, generator=g, device=cuda) * 0.02, mode, group)
        first = qm.quant_matmul(x, codes, scale, mode)
        second = qm.quant_matmul(x, codes, scale, mode)
        torch.cuda.synchronize()
        assert torch.equal(first, second), (M, K, N, mode)
    codes, scale = qm.quantize_weight_per_col(
        torch.randn(1024, 768, generator=g, device=cuda))
    x = torch.randn(300, 1024, generator=g, device=cuda, dtype=torch.bfloat16)
    assert torch.equal(qm.int8_matmul(x, codes, scale),
                       qm.int8_matmul(x, codes, scale))
    q = torch.randn(8, 32, 128, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(8, 8, 2048, 128, generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    ci = torch.tensor(1900, dtype=torch.int32, device=cuda)
    assert torch.equal(decode_attention(q, k, v, ci),
                       decode_attention(q, k, v, ci))


def test_wgmma_route_is_the_c_entrys(cuda):
    """``kernel_route`` (what the CPU tests check) is the rule the C entry
    applies before it launches, for the wgmma prefill, the gemv_tc decode
    kernel and the ragged kernel."""
    lib = qm._build.load("quant_matmul")
    for route, c_route in (("wgmma", lib.quant_matmul_wgmma_route),
                           ("gemv_tc", lib.quant_matmul_gemv_tc_route),
                           ("ragged", lib.quant_matmul_ragged_route)):
        for M in (1, 5, 8, 9, 129, 4096):
            for K in (131, 264, 1000, 1024, 4100, 14336):
                for N in (768, 1000, 1024, 4104, 14330, 14336):
                    for dtype in (torch.bfloat16, torch.float32):
                        want = qm.kernel_route(M, K, N, dtype) == route
                        got = c_route(M, K, N, int(dtype == torch.bfloat16))
                        assert bool(got) == want, (route, M, K, N, dtype)


@pytest.mark.parametrize("rows", [(0, 128, 256), (0, 16, 32)],
                         ids=["cluster_ranks", "warps"])
def test_gemv_tc_sums_in_a_fixed_order(cuda, rows):
    """Products 2**24, 1 and -2**24 in column 0 at K rows that fall to
    cluster ranks 0, 1, 2 (K 384: three K tiles, a cluster of 3) or to
    warps 0, 1, 2 of one stage (K 128): summed in the kernel's order the
    1 is lost (2**24 + 1 rounds to 2**24), so the result is exactly 0;
    any other order or a partial summed twice or not at all gives 1, -1
    or more. The CPU emulation is held to the same inputs."""
    K, N = (384 if rows[1] == 128 else 128), 128
    codes = torch.zeros(K, N, dtype=torch.int8, device=cuda)
    scale = torch.full((1, N), 2.0, device=cuda)
    x = torch.zeros(1, K, device=cuda)
    for r, c, v in zip(rows, (64, 1, -64), (2.0 ** 17, 0.5, 2.0 ** 17)):
        codes[r, 0], x[0, r] = c, v
    assert qm.gemv_tc_grid(K, N, "int8", 132)[1] == (3 if K == 384 else 1)
    got = qm.quant_matmul(x.bfloat16(), codes, scale, "int8")
    torch.cuda.synchronize()
    assert got[0, 0].item() == 0.0 and not got[0, 1:].any()


def test_quant_decode_is_one_launch_and_graph_safe(cuda):
    """Every Llama-3-8B decode projection (K5 int8 and int4 g64, K8) runs
    as exactly one kernel (``gemv_tc_kernel``: no finalize pass, no
    scratch), and a CUDA graph captured around one call, replayed over new
    x values written into the captured input, matches the plain version
    each time (the launch reads no device value and allocates nothing)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(9)
    for M, (K, N) in ((8, (4096, 1024)), (1, (14336, 4096))):
        w = torch.randn(K, N, generator=g, device=cuda) * 0.02
        calls = [(mode, *qm.quantize_linear_weight(w, mode, group))
                 for mode, group in (("int8", 0), ("int4", 64))]
        calls.append(("int8_col", *qm.quantize_weight_per_col(w)))
        for mode, codes, scale in calls:
            def call(x):
                if mode == "int8_col":
                    return qm.int8_matmul(x, codes, scale)
                return qm.quant_matmul(x, codes, scale, mode)

            def plain(x):
                if mode == "int8_col":
                    return qm.int8_matmul_plain(x, codes, scale)
                return qm.quant_matmul_plain(x, codes, scale, mode)

            x = torch.randn(M, K, generator=g, device=cuda,
                            dtype=torch.bfloat16)
            call(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call(x)
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if e.device_type.name == "CUDA"
                       and "memcpy" not in e.name.lower()
                       and "memset" not in e.name.lower()]
            assert len(kernels) == 1 and "gemv_tc_kernel" in kernels[0], \
                (mode, M, K, N, kernels)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = call(x)
            for _ in range(3):
                x.copy_(torch.randn(M, K, generator=g, device=cuda,
                                    dtype=torch.bfloat16))
                graph.replay()
                ref = plain(x)
                torch.cuda.synchronize()
                wd = (codes.float() * scale).to(torch.bfloat16) \
                    if mode == "int8_col" else \
                    qm.dequantize_linear_weight(codes, scale, mode,
                                                torch.bfloat16)
                _assert_matmul_close(got, ref, x, wd)


def test_ragged_decode_is_one_launch_and_graph_safe(cuda):
    """A bf16 decode whose rows TMA cannot address (K5 int8, int4 in
    groups of 8 and 100, K8) runs as exactly one kernel
    (``ragged_kernel``: no finalize pass, no scratch), and a CUDA graph
    captured around one call, replayed over new x values written into the
    captured input, matches the plain version each time."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(19)
    for M, (K, N), group in ((8, (264, 1000), 8), (1, (4100, 14330), 100)):
        assert qm.kernel_route(M, K, N, torch.bfloat16) == "ragged"
        w = torch.randn(K, N, generator=g, device=cuda) * 0.02
        calls = [(mode, *qm.quantize_linear_weight(w, mode, grp))
                 for mode, grp in (("int8", 0), ("int4", group))]
        calls.append(("int8_col", *qm.quantize_weight_per_col(w)))
        for mode, codes, scale in calls:
            def call(x):
                if mode == "int8_col":
                    return qm.int8_matmul(x, codes, scale)
                return qm.quant_matmul(x, codes, scale, mode)

            def plain(x):
                if mode == "int8_col":
                    return qm.int8_matmul_plain(x, codes, scale)
                return qm.quant_matmul_plain(x, codes, scale, mode)

            x = torch.randn(M, K, generator=g, device=cuda,
                            dtype=torch.bfloat16)
            call(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call(x)
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if e.device_type.name == "CUDA"
                       and "memcpy" not in e.name.lower()
                       and "memset" not in e.name.lower()]
            assert len(kernels) == 1 and "ragged_kernel" in kernels[0], \
                (mode, M, K, N, kernels)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = call(x)
            wd = (codes.float() * scale).to(torch.bfloat16) \
                if mode == "int8_col" else \
                qm.dequantize_linear_weight(codes, scale, mode,
                                            torch.bfloat16)
            for _ in range(3):
                x.copy_(torch.randn(M, K, generator=g, device=cuda,
                                    dtype=torch.bfloat16))
                graph.replay()
                ref = plain(x)
                torch.cuda.synchronize()
                _assert_matmul_close(got, ref, x, wd)


@pytest.mark.parametrize("case",
                         ["ranks", "warps", "warps_two_steps", "stages"])
def test_ragged_sums_in_a_fixed_order(cuda, case):
    """Products 2**24, 1 and -2**24 in column 0 (the CPU test's
    ``ragged_order_case``) at the first K rows of cluster ranks 0, 1, 2
    (K 264, N 1000: the ranks of this card's cluster), of warps 0, 1, 2 of
    one stage (8-row tiles: steps 0, 1, 2; 64-row tiles, M 37: steps 0, 2,
    4), or of warp 0's stages 0, 1, 2 (N 16900: 265 or 133 column tiles,
    a cluster of 1): summed in the kernel's order the 1 is lost, so the
    result is exactly 0; any other order, or a partial summed twice or
    not at all, gives 1, -1 or more."""
    M = 37 if case == "warps_two_steps" else 1
    if case == "ranks":
        K, N = 264, 1000
        _, _, _, _, c = qm.ragged_grid(M, K, N, qm._sm_count(0))
        assert c >= 3
        rows = tuple(16 * (r * 17 // c) for r in range(3))
    else:
        K, N = (384 if case == "stages" else 264), 16900
        assert qm.ragged_grid(M, K, N, qm._sm_count(0))[4] == 1
        rows = {"warps": (0, 16, 32), "warps_two_steps": (0, 32, 64),
                "stages": (0, 128, 256)}[case]
    codes = torch.zeros(K, N, dtype=torch.int8, device=cuda)
    scale = torch.full((1, N), 2.0, device=cuda)
    x = torch.zeros(M, K, device=cuda)
    for r, c, v in zip(rows, (64, 1, -64), (2.0 ** 17, 0.5, 2.0 ** 17)):
        codes[r, 0], x[0, r] = c, v
    got = qm.quant_matmul(x.bfloat16(), codes, scale, "int8")
    torch.cuda.synchronize()
    assert got[0, 0].item() == 0.0 and not got[0, 1:].any()
    assert not got[1:].any()


@pytest.mark.parametrize("M,K,N", [(8, 4096, 4096), (1, 264, 1001),
                                   (5, 263, 33), (8, 14336, 4096),
                                   (8, 4096, 14336)])
def test_gemv_tf32_is_one_launch_matches_plain_and_replays(cuda, M, K, N):
    """K5's and K8's fp32 decode (``gemv_tf32_kernel``) for int8, int4 in
    groups of 64 and 6, and K8's per-column mode: one kernel a call (no
    finalize, no scratch), within |kernel - plain| <= 1e-5 (|x| @ |W|) at
    aligned N (TMA) and odd N (cp.async windows), bitwise repeatable, and
    a CUDA graph captured around one call and replayed over new x values
    matches the plain version each time."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    w = torch.randn(K, N, generator=g, device=cuda) * 0.02
    calls = [(mode, *qm.quantize_linear_weight(w, mode, group))
             for mode, group in (("int8", 0), ("int8", 64), ("int4", 64),
                                 ("int4", 6))
             if mode == "int8" or K % 2 == 0]
    calls.append(("int8_col", *qm.quantize_weight_per_col(w)))
    assert qm.kernel_route(M, K, N, torch.float32) == "gemv_tf32"
    for mode, codes, scale in calls:
        def call(x):
            if mode == "int8_col":
                return qm.int8_matmul(x, codes, scale)
            return qm.quant_matmul(x, codes, scale, mode)

        def check(got, x):
            if mode == "int8_col":
                ref = qm.int8_matmul_plain(x, codes, scale)
                dense = codes.float() * scale
            else:
                ref = qm.quant_matmul_plain(x, codes, scale, mode)
                dense = qm.dequantize_linear_weight(codes, scale, mode)
            torch.cuda.synchronize()
            _assert_matmul_close(got, ref, x, dense)

        x = torch.randn(M, K, generator=g, device=cuda)
        got = call(x)
        check(got, x)
        assert torch.equal(got, call(x)), mode
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call(x)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type.name == "CUDA"
                   and "memcpy" not in e.name.lower()
                   and "memset" not in e.name.lower()]
        assert len(kernels) == 1 and "gemv_tf32_kernel" in kernels[0], \
            (mode, kernels)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = call(x)
        for _ in range(3):
            x.copy_(torch.randn(M, K, generator=g, device=cuda))
            graph.replay()
            check(got, x)


@pytest.mark.parametrize("across_ranks", [True, False],
                         ids=["cluster_ranks", "warps"])
def test_gemv_tf32_sums_in_a_fixed_order(cuda, across_ranks):
    """The CPU test's ``gemv_tf32_order_case`` on the card (N 128, a
    cluster of 8): int8 codes and per-column scales of 1, row 0 of x zero
    but for 2**25, -2**25 and 1 at the first K row of ranks 0, 1, 2 (K 384:
    6 steps a rank) or of warps 0, 1, 2 of rank 0 (K 1024: 4 steps a
    warp). Every warp's sum is exact, and only the kernel's order gives
    exactly 1 (the reverse gives 0)."""
    K, N = (384 if across_ranks else 1024), 128
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    C = qm.gemv_tf32_grid(K, N, sms)[1]
    assert C == 8
    n8 = K // 8

    def first(r, w):     # the first step of warp w (of 4) of rank r
        s0, n = r * n8 // C, (r + 1) * n8 // C - r * n8 // C
        return s0 + w * n // 4

    firsts = [first(i, 0) for i in range(3)] if across_ranks else \
        [first(0, i) for i in range(3)]
    x = torch.zeros(2, K, device=cuda)
    for s, v in zip(firsts, (2.0 ** 25, -2.0 ** 25, 1.0)):
        x[0, 8 * s] = v
    codes = torch.ones(K, N, dtype=torch.int8, device=cuda)
    got = qm.quant_matmul(x, codes, torch.ones(1, N, device=cuda), "int8")
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.ones(N, device=cuda))
    assert not got[1].any()


def _assert_matmul_close(got, ref, x, w):
    mag = x.float().abs() @ w.float().abs()
    rel = 0.0 if x.dtype == torch.float32 else 2 ** -7
    err = (got.float() - ref.float()).abs()
    assert bool((err <= rel * ref.float().abs() + 1e-5 * mag).all()), \
        float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode,group", [("int8", 0), ("int8", 64),
                                        ("int4", 64), ("int4", 8)])
@pytest.mark.parametrize("M,K,N", [(1, 512, 768), (8, 2048, 1000),
                                   (5, 264, 1000), (37, 264, 1000),
                                   (300, 1024, 520), (129, 264, 1024),
                                   (4097, 4096, 14336), (8, 4096, 1024),
                                   (8, 4096, 14336), (1, 14336, 4096),
                                   (8, 4100, 14330), (512, 4100, 14330),
                                   (16, 264, 1000), (24, 264, 1000)])
def test_quant_matmul_kernel_matches_plain(cuda, dtype, mode, group, M, K,
                                           N):
    """K5's decode paths (M <= 8: gemv_tc where TMA can address the rows,
    at Llama-3-8B's k/v, up and down shapes too; the ragged kernel at
    ragged N and K; gemv_tf32 for fp32) and tiled paths (M > 8,
    ragged M/N/K tails) against the plain version. bf16 rows TMA cannot
    address take the ragged kernel at N 1000 (M 16 and 24: its 16- and
    32-row tiles, the latter two k16 steps a warp), 520 and 14330 (code
    rows on 2-byte boundaries, K 4100: x rows on 8-byte ones; groups of
    50 and 4 rows there), the wgmma kernel at (129, 264, 1024), where groups
    of 44 or 8 rows cross the 64-row TMA tile and K ends 8 rows into a
    tile, and at Llama-3-8B's MLP shape with one row past a 128-row
    tile."""
    g = torch.Generator(device=cuda).manual_seed(M * K + N)
    x = torch.randn(M, K, generator=g, device=cuda, dtype=dtype)
    codes, scale = qm.quantize_linear_weight(
        torch.randn(K, N, generator=g, device=cuda) * 0.02, mode, group)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    before = qm.quant_matmul.launches
    got = qm.quant_matmul(x, codes, scale, mode)
    ref = qm.quant_matmul_plain(x, codes, scale, mode)
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == before + 1
    _assert_matmul_close(got, ref, x,
                         qm.dequantize_linear_weight(codes, scale, mode,
                                                     dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(8, 4096, 1024), (3, 264, 1000),
                                   (130, 640, 384), (4096, 4096, 4096),
                                   (8, 4096, 14336), (1, 14336, 4096),
                                   (8, 4100, 14330), (16, 264, 1000),
                                   (24, 264, 1000)])
def test_int8_matmul_kernel_matches_plain(cuda, dtype, M, K, N):
    """K8 (the per-column epilogue) against its plain version."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=cuda, dtype=dtype)
    codes, scale = qm.quantize_weight_per_col(
        torch.randn(K, N, generator=g, device=cuda))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    before = qm.int8_matmul.launches
    got = qm.int8_matmul(x, codes, scale)
    ref = qm.int8_matmul_plain(x, codes, scale)
    torch.cuda.synchronize()
    assert qm.int8_matmul.launches == before + 1
    _assert_matmul_close(got, ref, x, (codes.float() * scale).to(dtype))


@pytest.mark.parametrize("mode,group,M,K,N", [
    ("int8", 128, 300, 4096, 1024), ("int8_col", 0, 37, 264, 1000),
    ("int4", 64, 77, 1000, 1001), ("int8", 44, 129, 264, 1000),
    ("int4", 6, 65, 96, 136), ("int8", 0, 50, 263, 136),
    ("int8_col", 0, 4097, 4096, 4096)],
    ids=["fp32_m300_int8g128", "ragged_m37_fp32", "odd_k_n_int4",
         "straddling_groups", "int4_g6", "odd_k_x", "prefill_k8"])
def test_fp32_route_matches_plain(cuda, mode, group, M, K, N):
    """K5's and K8's fp32 route (M > 8: the tensor cores on x split in two
    TF32 parts, K split over blocks) against the plain version under the
    rule |kernel - plain| <= 1e-5 (|x| @ |W|): chip_smoke's
    fp32_m300_int8g128 (6 K splits) and ragged_m37_fp32 (N 1000: 8-byte
    code copies), K and N off the tiles (N 1001: byte copies; K 263:
    4-byte copies of x), groups of 44 and 6 rows that straddle the
    kernel's 8-row steps, a prefill-sized K8; and two calls agree bit for
    bit."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=cuda)
    w = torch.randn(K, N, generator=g, device=cuda) * 0.02
    assert qm.kernel_route(M, K, N, torch.float32) == "fp32"
    if mode == "int8_col":
        codes, scale = qm.quantize_weight_per_col(w)
        call = lambda: qm.int8_matmul(x, codes, scale)  # noqa: E731
        ref = qm.int8_matmul_plain(x, codes, scale)
        dense = codes.float() * scale
    else:
        codes, scale = qm.quantize_linear_weight(w, mode, group)
        call = lambda: qm.quant_matmul(x, codes, scale, mode)  # noqa: E731
        ref = qm.quant_matmul_plain(x, codes, scale, mode)
        dense = qm.dequantize_linear_weight(codes, scale, mode)
    got = call()
    torch.cuda.synchronize()
    _assert_matmul_close(got, ref, x, dense)
    assert torch.equal(got, call())


def test_fp32_route_sums_splits_in_order(cuda):
    """The CPU test's ``fp32_order_case`` on the card, at the route's own
    split count (M 16, K 4096, N 128: 16 splits of 256 rows): int8 codes
    and scales of 1, row 0 of x zero but for 2**25, -2**25 and 1 at the
    first rows of splits 0, 1 and 2. Each split's sum is exact, and only
    the split order gives exactly 1 (the reverse gives 0)."""
    M, K, N = 16, 4096, 128
    splits = qm.fp32_splits(M, K, N, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert splits >= 3
    per = -(-(-(-K // qm.FP32_CHUNK)) // splits) * qm.FP32_CHUNK
    x = torch.zeros(M, K, device=cuda)
    for s, v in enumerate((2.0 ** 25, -2.0 ** 25, 1.0)):
        x[0, s * per] = v
    codes = torch.ones(K, N, dtype=torch.int8, device=cuda)
    got = qm.quant_matmul(x, codes, torch.ones(1, N, device=cuda), "int8")
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.ones(N, device=cuda))
    assert not got[1:].any()


def _paged_case(dev, dtype, int8, D, Hkv, G, T, seed=0, nb=10, bs=16):
    """A pool whose unused pages hold NaN (a kernel that touches a page it
    must not read poisons its row), a table with sentinel tails, and
    sequences with a partial last page, a mid-prompt chunk, an idle row
    (context 1 behind a sentinel row: it reads the clamped last page), an
    empty row and a row that fills the table (nb * bs keys: 2048 at
    nb 128 of 16)."""
    rs = np.random.RandomState(seed)
    #            (chunk_start, context_len) per sequence
    rows = [(0, T), (70, 70 + T), (33, 33 + max(1, T // 2)), (0, 1), (0, 0),
            (nb * bs - T, nb * bs)]
    N = max(nb + 38, sum(-(-c // bs) for _, c in rows) + 8)
    B = len(rows)
    bt = np.full((B, nb), N, np.int32)
    pages = iter(rs.permutation(N - 1))     # page N - 1 stays unowned
    used = [N - 1]
    for r, (_, clen) in enumerate(rows):
        if r == 3:
            continue                        # the idle row keeps its sentinels
        for i in range(-(-clen // bs)):
            bt[r, i] = next(pages)
            used.append(bt[r, i])
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (N, Hkv, bs, D)
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8) for _ in range(2))
        scales = {n: torch.rand(shape[:3], generator=g, device=dev) / 64
                  for n in ("k_scale", "v_scale")}
        free = torch.ones(N, dtype=torch.bool, device=dev)
        free[torch.as_tensor(np.array(used), device=dev)] = False
        for t in scales.values():
            t[free] = float("nan")
    else:
        k, v = (torch.randn(shape, generator=g, device=dev, dtype=dtype)
                for _ in range(2))
        free = torch.ones(N, dtype=torch.bool, device=dev)
        free[torch.as_tensor(np.array(used), device=dev)] = False
        k[free] = float("nan")
        v[free] = float("nan")
        scales = {}
    q = torch.randn((B, T, Hkv * G, D), generator=g, device=dev, dtype=dtype)
    cs, cl = (torch.tensor([r[i] for r in rows], dtype=torch.int32,
                           device=dev) for i in (0, 1))
    return q, k, v, torch.from_numpy(bt).to(dev), cs, cl, scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8pool"])
@pytest.mark.parametrize("D,Hkv,G", [(128, 2, 4), (64, 3, 1), (128, 1, 8)])
@pytest.mark.parametrize("window", [None, 24, 100])
@pytest.mark.parametrize("nb", [10, 128], ids=["nb10", "nb128"])
def test_paged_decode_kernel_matches_plain(cuda, dtype, int8, D, Hkv, G,
                                           window, nb):
    """K7a against its plain version: ragged contexts with a partial last
    page, a full table (a 2048-token context at nb 128: many key splits),
    an idle sentinel row, an empty row, windows that start mid-tile, an
    int8 pool."""
    q, k, v, bt, _, cl, scales = _paged_case(cuda, dtype, int8, D, Hkv, G, 1,
                                             nb=nb)
    before = paged_decode_attention.launches
    got = paged_decode_attention(q[:, 0], k, v, bt, cl, window=window,
                                 **scales)
    ref = paged_decode_attention_plain(q[:, 0], k, v, bt, cl, window=window,
                                       **scales)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert torch.isfinite(got).all() and not got[4].any()
    fp32 = dtype == torch.float32
    torch.testing.assert_close(got.float(), ref.float(),
                               rtol=1e-5 if fp32 else 2 ** -7,
                               atol=1e-5 if fp32 else 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8pool"])
@pytest.mark.parametrize("D,Hkv,G", [(128, 2, 4), (64, 3, 1), (128, 1, 8)])
@pytest.mark.parametrize("T,window", [(64, None), (37, None), (64, 24),
                                      (1, None)])
@pytest.mark.parametrize("nb", [10, 128], ids=["nb10", "nb128"])
def test_paged_prefill_kernel_matches_plain(cuda, dtype, int8, D, Hkv, G, T,
                                            window, nb):
    """K7b against its plain version: chunks at 0, at mid-page starts
    behind a prefix (70 and 33: pages hold 16 keys) and at the table's end
    (2048 keys at nb 128: several key splits to merge), a padded tail
    (zeros), rows with no context, a chunk length that is no multiple of
    the query tile, a window, an int8 pool, and the chunk of one token (the
    decode kernel's function)."""
    q, k, v, bt, cs, cl, scales = _paged_case(cuda, dtype, int8, D, Hkv, G, T,
                                              nb=nb)
    before = paged_prefill_attention.launches
    got = paged_prefill_attention(q, k, v, bt, cs, cl, window=window,
                                  **scales)
    ref = paged_prefill_attention_plain(q, k, v, bt, cs, cl, window=window,
                                        **scales)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == before + 1
    assert torch.isfinite(got).all()
    assert not got[2, max(1, T // 2):].any(), "padded tail rows are zeros"
    fp32 = dtype == torch.float32
    torch.testing.assert_close(got.float(), ref.float(),
                               rtol=1e-5 if fp32 else 2 ** -7,
                               atol=1e-5 if fp32 else 1e-3)
    if T == 1:
        dec = paged_decode_attention(q[:, 0], k, v, bt, cl, window=window,
                                     **scales)
        torch.testing.assert_close(dec.float(), got[:, 0].float(),
                                   rtol=1e-5 if fp32 else 2 ** -7,
                                   atol=1e-5 if fp32 else 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8pool"])
def test_paged_walks_are_deterministic(cuda, dtype, int8):
    """K6 and K7a give bitwise equal outputs on repeated calls: their key
    splits merge in split order, with no atomics."""
    args, scales = _case(cuda, dtype, int8, 128, 2, 4, layout="long")
    first = ragged_paged_attention(*args, window=None, **scales)
    for _ in range(3):
        again = ragged_paged_attention(*args, window=None, **scales)
        assert torch.equal(first, again)
    q, k, v, bt, _, cl, sc = _paged_case(cuda, dtype, int8, 128, 2, 4, 1,
                                         nb=128)
    first = paged_decode_attention(q[:, 0], k, v, bt, cl, **sc)
    for _ in range(3):
        assert torch.equal(first, paged_decode_attention(q[:, 0], k, v, bt,
                                                         cl, **sc))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8pool"])
@pytest.mark.parametrize("window", [None, 100])
def test_paged_prefill_is_deterministic(cuda, dtype, int8, window):
    """K7b gives bitwise equal outputs on repeated calls: its key splits
    (a 128-page table, chunks up to the table's end) merge in split order,
    with no atomics."""
    q, k, v, bt, cs, cl, sc = _paged_case(cuda, dtype, int8, 128, 2, 4, 64,
                                          nb=128)
    first = paged_prefill_attention(q, k, v, bt, cs, cl, window=window, **sc)
    for _ in range(3):
        assert torch.equal(first, paged_prefill_attention(
            q, k, v, bt, cs, cl, window=window, **sc))


# packed layouts of one width (R 5 rows, T 300 tokens, nb 128) that one
# captured K6 graph replays over
RAGGED_REPLAYS = [
    [(1, 2047), (0, 0), (256, 512), (1, 300), (1, 0)],
    [(37, 100), (1, 5), (1, 1500), (0, 0), (200, 0)],
    [(0, 0), (0, 0), (1, 63), (0, 0), (0, 0)],
    [(1, 64), (1, 65), (128, 1900), (60, 3), (1, 1023)],
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("window", [None, 200])
def test_paged_walks_replay_in_a_cuda_graph(cuda, dtype, window):
    """K6's, K7a's and K7b's launches do not depend on the descriptors'
    values: one CUDA graph captured around a call replays correctly after
    new block tables, query starts and lengths, chunk starts and context
    lengths are written into the captured tensors. Each kernel counts its
    runs on the device: every replay adds one, the capture none."""
    N, nb, T, Hkv, G, D = 224, 128, 300, 2, 4, 128
    g = torch.Generator(device=cuda).manual_seed(3)
    k, v, _ = _pool(cuda, dtype, False, N, Hkv, D, g)
    q = torch.randn((T, Hkv * G, D), generator=g, device=cuda, dtype=dtype)
    tables = [_ragged_tables(rows, N, nb, np.random.RandomState(i))
              for i, rows in enumerate(RAGGED_REPLAYS)]
    desc = [torch.from_numpy(a).to(cuda) for a in tables[0][:5]]
    ragged_paged_attention(q, k, v, *desc, window=window)   # warm-up
    torch.cuda.synchronize()
    before = ragged_paged_attention.launches
    ra.reset_kernel_runs()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ragged_paged_attention(q, k, v, *desc, window=window)
    assert ragged_paged_attention.launches == before + 1
    assert ra.kernel_runs() == 0, "a capture runs nothing"
    fp32 = dtype == torch.float32
    tol = dict(rtol=1e-5 if fp32 else 2 ** -7, atol=1e-5 if fp32 else 1e-3)
    for t in tables[1:] + tables[:1]:
        for dst, src in zip(desc, t[:5]):
            dst.copy_(torch.from_numpy(src))
        graph.replay()
        ref = ragged_paged_attention_plain(q, k, v, *desc, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **tol)
        assert not got[t[5]:].any(), "unclaimed tokens are zeros"
    assert ra.kernel_runs() == len(tables), "each replay ran K6 once"

    # K7a: the sequences of each layout, one token at context_len - 1
    B = len(RAGGED_REPLAYS[0])
    qd = q[:B].contiguous()
    bt = desc[0].clone()
    cl = desc[4].clone()
    paged_decode_attention(qd, k, v, bt, cl, window=window)  # warm-up
    torch.cuda.synchronize()
    _runs.reset_kernel_runs("paged_decode_attention")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = paged_decode_attention(qd, k, v, bt, cl, window=window)
    for t in tables:
        bt.copy_(torch.from_numpy(t[0]))
        cl.copy_(torch.from_numpy(t[4]))
        graph.replay()
        ref = paged_decode_attention_plain(qd, k, v, bt, cl, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **tol)
    assert _runs.kernel_runs("paged_decode_attention") == len(tables), \
        "each replay ran K7a once, the capture none"

    # K7b: a 64-token chunk of each sequence at its layout's chunk start
    # (context clipped to the table), padded tails and empty rows included
    qc = torch.randn((B, 64, Hkv * G, D), generator=g, device=cuda,
                     dtype=dtype)
    cs = desc[3].clone()
    paged_prefill_attention(qc, k, v, bt, cs, cl, window=window)  # warm-up
    torch.cuda.synchronize()
    before = paged_prefill_attention.launches
    _runs.reset_kernel_runs("paged_prefill_attention")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = paged_prefill_attention(qc, k, v, bt, cs, cl, window=window)
    assert paged_prefill_attention.launches == before + 1
    for t in tables[1:] + tables[:1]:
        bt.copy_(torch.from_numpy(t[0]))
        cs.copy_(torch.from_numpy(t[3]))
        cl.copy_(torch.from_numpy(t[4]))
        graph.replay()
        ref = paged_prefill_attention_plain(qc, k, v, bt, cs, cl,
                                            window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **tol)
    assert _runs.kernel_runs("paged_prefill_attention") == len(tables), \
        "each replay ran K7b once, the capture none"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_paged_walks_merge_splits_in_order(cuda, dtype):
    """The inputs of the CPU tests' ``order_sensitive_pool`` on the card:
    q = 0 over V rows that are zero but for 2**25, -2**25 and 1 at the
    first key of tiles 0, 1 and 2 of a 192-key context, one tile a split
    (R 1, Hkv 1, nb 128). Every in-split sum is exact, and only the split
    order gives ((2**25 - 2**25) + 1) / 192: K6's and K7a's merges must
    produce exactly that (rounded to bf16 for bf16 q), and K7b's a chunk
    at positions 188..191 exactly 1 / (position + 1)."""
    H, D, keys, nb = 4, 128, 192, 128
    n_pages = keys // 16
    k = torch.randn(n_pages + 1, 1, 16, D, device=cuda).to(dtype)
    v = torch.zeros(n_pages + 1, 1, 16, D, device=cuda, dtype=dtype)
    for tile, x in enumerate((2.0 ** 25, -2.0 ** 25, 1.0)):
        v[tile * 4, :, 0] = x
    bt = torch.full((1, nb), n_pages + 1, dtype=torch.int32, device=cuda)
    bt[0, :n_pages] = torch.arange(n_pages, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    cl = torch.full((1,), keys, dtype=torch.int32, device=cuda)
    want = torch.full((1, H, D), 1 / 192, device=cuda).to(dtype)
    got = ragged_paged_attention(torch.zeros(1, H, D, device=cuda,
                                             dtype=dtype), k, v, bt,
                                 one * 0, one, cl - 1, cl)
    assert torch.equal(got, want)
    got = paged_decode_attention(torch.zeros(1, H, D, device=cuda,
                                             dtype=dtype), k, v, bt, cl)
    assert torch.equal(got, want)
    # K7b: a chunk of 4 tokens at 188..191, each exactly 1 / (position + 1)
    got = paged_prefill_attention(torch.zeros(1, 4, H, D, device=cuda,
                                              dtype=dtype), k, v, bt,
                                  cl - 4, cl)
    want = (1 / torch.arange(keys - 3, keys + 1, device=cuda,
                             dtype=torch.float32)).to(dtype)
    assert torch.equal(got, want[None, :, None, None].expand_as(got))


def test_paged_wrappers_count_one_launch_per_call(cuda):
    """Each call of the K6, K7a and K7b wrappers adds exactly one to its
    ``launches``, whatever the number of kernels its C call starts (K6:
    the item layout, the walk, the merge; K7a and K7b: the walk, the
    merge)."""
    args, scales = _case(cuda, torch.bfloat16, False, 128, 2, 4,
                         layout="long")
    q, k, v, bt, _, cl, _ = _paged_case(cuda, torch.bfloat16, False, 128, 2,
                                        4, 1, nb=128)
    qc, _, _, _, cs, _, _ = _paged_case(cuda, torch.bfloat16, False, 128, 2,
                                        4, 64, nb=128)
    for n in range(1, 4):
        before = (ragged_paged_attention.launches,
                  paged_decode_attention.launches,
                  paged_prefill_attention.launches)
        for _ in range(n):
            ragged_paged_attention(*args, **scales)
            paged_decode_attention(q[:, 0], k, v, bt, cl)
            paged_prefill_attention(qc, k, v, bt, cs, cl)
        assert (ragged_paged_attention.launches,
                paged_decode_attention.launches,
                paged_prefill_attention.launches) == \
            (before[0] + n, before[1] + n, before[2] + n)


# the rest of the JAX kernels' domain on the card: (D, Hkv, G, page size):
# Gemma-7B's and Gemma-2B's D 256, Qwen2's groups of 7 and 6, Phi-2's D
# 80, GPT-NeoX-20B's D 96, a group of 64 and one of 71 (head chunks on
# both routes), a group of 16 at D 256, pages of 1 to 128 tokens that
# divide 64, are multiples of it, or neither (12, 24)
PAGED_DOMAIN = [(256, 2, 1, 16), (256, 1, 8, 16), (256, 2, 2, 8),
                (256, 1, 16, 24), (80, 2, 1, 24), (96, 2, 8, 32),
                (128, 2, 7, 12), (128, 1, 6, 64), (128, 1, 64, 16),
                (64, 1, 71, 128), (64, 2, 4, 1), (128, 2, 7, 8)]
PAGED_DOMAIN_IDS = [f"d{D}_kv{Hkv}_g{G}_bs{bs}"
                    for D, Hkv, G, bs in PAGED_DOMAIN]


def _tol(dtype):
    fp32 = dtype == torch.float32
    return dict(rtol=1e-5 if fp32 else 2 ** -7, atol=1e-5 if fp32 else 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8pool"])
@pytest.mark.parametrize("D,Hkv,G,bs", PAGED_DOMAIN, ids=PAGED_DOMAIN_IDS)
@pytest.mark.parametrize("window", [None, 24])
def test_ragged_kernel_takes_the_whole_domain(cuda, dtype, int8, D, Hkv, G,
                                              bs, window):
    """K6 against its plain version at every head dim, group and page size
    of the domain (the small layout's rows: decode rows, chunk rows, a
    narrow row of 3 tokens, idle rows, sentinel tails), with NaN in every
    page no row owns."""
    args, scales = _case(cuda, dtype, int8, D, Hkv, G, bs=bs)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args, window=window, **scales)
    ref = ragged_paged_attention_plain(*args, window=window, **scales)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
    assert torch.isfinite(got).all() and not got[-5:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8pool"])
@pytest.mark.parametrize("D,Hkv,G,bs", PAGED_DOMAIN, ids=PAGED_DOMAIN_IDS)
@pytest.mark.parametrize("window", [None, 24])
def test_paged_kernels_take_the_whole_domain(cuda, dtype, int8, D, Hkv, G,
                                             bs, window):
    """K7a and K7b against their plain versions at every head dim, group
    and page size of the domain: a table of about 320 keys, chunks at 0,
    mid-page behind a prefix and at the table's end, a padded tail, an
    idle and an empty row, the chunk of one token (K7a's function)."""
    nb = max(2, -(-320 // bs))
    q, k, v, bt, cs, cl, scales = _paged_case(cuda, dtype, int8, D, Hkv, G,
                                              37, nb=nb, bs=bs)
    before = (paged_decode_attention.launches,
              paged_prefill_attention.launches)
    dec = paged_decode_attention(q[:, 0].contiguous(), k, v, bt, cl,
                                 window=window, **scales)
    ref = paged_decode_attention_plain(q[:, 0].contiguous(), k, v, bt, cl,
                                       window=window, **scales)
    got = paged_prefill_attention(q, k, v, bt, cs, cl, window=window,
                                  **scales)
    pref = paged_prefill_attention_plain(q, k, v, bt, cs, cl, window=window,
                                         **scales)
    one = paged_prefill_attention(q[:, :1].contiguous(), k, v, bt, cl - 1,
                                  cl, window=window, **scales)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches,
            paged_prefill_attention.launches) == (before[0] + 1,
                                                  before[1] + 2)
    for out in (dec, got, one):
        assert torch.isfinite(out).all()
    assert not dec[4].any() and not got[2, 18:].any()
    torch.testing.assert_close(dec.float(), ref.float(), **_tol(dtype))
    torch.testing.assert_close(got.float(), pref.float(), **_tol(dtype))
    torch.testing.assert_close(one[:, 0].float(), dec.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D,Hkv,G,bs", [(256, 2, 1, 8), (128, 2, 7, 24),
                                        (64, 1, 71, 16)],
                         ids=["d256_bs8", "g7_bs24", "g71_bs16"])
def test_paged_walks_of_the_domain_are_deterministic_and_replay(
        cuda, dtype, D, Hkv, G, bs):
    """At D 256, a group of 7 with pages of 24 and a group of 71 (head
    chunks), K6, K7a and K7b give bitwise equal outputs on repeated calls,
    and one captured CUDA graph of each replays for new descriptors."""
    args, scales = _case(cuda, dtype, False, D, Hkv, G, layout="long",
                         bs=bs)
    first = ragged_paged_attention(*args)
    assert torch.equal(first, ragged_paged_attention(*args))
    nb = -(-2048 // bs)
    q, k, v, bt, cs, cl, _ = _paged_case(cuda, dtype, False, D, Hkv, G, 64,
                                         nb=nb, bs=bs)
    qd = q[:, 0].contiguous()
    for call in (lambda: paged_decode_attention(qd, k, v, bt, cl),
                 lambda: paged_prefill_attention(q, k, v, bt, cs, cl)):
        a = call()
        assert torch.equal(a, call())
    torch.cuda.synchronize()
    graphs = []
    for call in (lambda: paged_decode_attention(qd, k, v, bt, cl),
                 lambda: paged_prefill_attention(q, k, v, bt, cs, cl)):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        graphs.append((graph, out))
    cs.copy_(torch.clamp(cs - 40, min=0))
    cl.copy_(torch.clamp(cl - 40, min=0))
    for (graph, out), plain in zip(graphs, (
            lambda: paged_decode_attention_plain(qd, k, v, bt, cl),
            lambda: paged_prefill_attention_plain(q, k, v, bt, cs, cl))):
        graph.replay()
        torch.testing.assert_close(out.float(), plain().float(),
                                   **_tol(dtype))



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D,Hkv,G", [(128, 2, 4), (64, 3, 1), (64, 1, 8),
                                     (80, 1, 3), (96, 2, 2), (256, 2, 4),
                                     (64, 1, 71)])
@pytest.mark.parametrize("T,window,pad", [
    (256, None, 70), (200, None, 70), (130, 48, 70), (1000, None, 300),
    (1024, 16, 200)])
def test_masked_flash_kernel_matches_plain(cuda, dtype, D, Hkv, G, T, window,
                                           pad):
    """K1's key-mask mode against the plain version: un-repeated kv heads,
    left padding that hides one or more whole key tiles (rows that see no
    key return zeros and lse = -inf), a hole inside a row, a window (one
    narrower than a key tile)."""
    g = torch.Generator(device=cuda).manual_seed(D + T)
    B = 3
    q = torch.randn(B, T, Hkv * G, D, generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn(B, T, Hkv, D, generator=g, device=cuda, dtype=dtype)
            for _ in range(2))
    mask = torch.ones(B, T, dtype=torch.int32, device=cuda)
    mask[0, :pad] = 0
    mask[1, :5] = 0
    mask[1, 90:93] = 0
    before = fa.flash_attention_fwd_masked.launches
    out, lse = fa.flash_attention_fwd_masked(q, k, v, mask, True,
                                             window=window)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, True, window=window,
                                                key_mask=mask)
    same = fa.flash_attention(q, k, v, window=window, key_mask=mask)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_masked.launches == before + 2
    assert torch.equal(same, out)
    assert not out[0, :pad].any()
    fp32 = dtype == torch.float32
    torch.testing.assert_close(out.float(), ref_out.float(),
                               rtol=1e-5 if fp32 else 2 ** -7,
                               atol=1e-5 if fp32 else 2e-2)
    seen = torch.isfinite(ref_lse)
    assert torch.equal(seen, torch.isfinite(lse))
    torch.testing.assert_close(lse[seen], ref_lse[seen], rtol=1e-5,
                               atol=1e-4)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_attention(q.requires_grad_(), k, v, key_mask=mask)


def _bigbird(H, block):
    return BigBirdSparsityConfig(num_heads=H, block=block,
                                 num_random_blocks=1,
                                 num_sliding_window_blocks=3,
                                 num_global_blocks=1)


def _sparse_layout(name, H, block, T):
    cfg = {
        "bslongformer": lambda: BSLongformerSparsityConfig(
            num_heads=H, block=block, num_sliding_window_blocks=3,
            global_block_indices=[0]),
        "bigbird": lambda: _bigbird(H, block),
        "bigbird_split": lambda: _bigbird(H, block),
        "fixed_per_head": lambda: FixedSparsityConfig(
            num_heads=H, block=block, num_local_blocks=2, num_global_blocks=1,
            different_layout_per_head=True, num_different_global_patterns=2),
    }[name]()
    return cfg.make_layout(T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", ["bslongformer", "bigbird",
                                  "fixed_per_head", "bigbird_split"])
def test_block_sparse_kernels_match_plain(cuda, dtype, D, block, causal,
                                          name):
    """K9 forward, dQ and dK/dV against their plain versions on the same
    inputs (the backward ones from the kernel's out and lse). Non-causal
    BigBird has global rows and columns of degree nb; the per-head Fixed
    layout differs between heads. ``bigbird_split`` is BigBird at nb =
    4 C (C = ``SPLIT_BLOCKS``): its global row and column are cut into
    work items whose partials the bf16 kernels merge. Tolerance: fp32
    2e-5, bf16 as K1's."""
    nb = 4 * bsa.SPLIT_BLOCKS if name == "bigbird_split" else 8
    B, H, T = 2, 3, nb * block
    layout = _sparse_layout(name, H, block, T)
    if causal:
        layout = layout * np.tril(np.ones(layout.shape[1:], np.int64))
    if name == "bigbird_split":
        rows, cols = bsa._indices(layout, causal, cuda, block)
        assert rows.slots > 0 and cols.slots > 0
    g = torch.Generator(device=cuda).manual_seed(D + block + int(causal))
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device=cuda,
                               dtype=dtype) for _ in range(4))
    kernels = (bsa.block_sparse_attention_fwd,
               bsa.block_sparse_attention_bwd_dq,
               bsa.block_sparse_attention_bwd_dkv)
    counts = [f.launches for f in kernels]
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, layout, block, causal)
    dq = bsa.block_sparse_attention_bwd_dq(q, k, v, out, lse, do, layout,
                                           block, causal)
    dk, dv = bsa.block_sparse_attention_bwd_dkv(q, k, v, out, lse, do, layout,
                                                block, causal)
    ref_out, ref_lse = bsa.block_sparse_attention_fwd_plain(q, k, v, layout,
                                                            block, causal)
    ref_dq = bsa.block_sparse_attention_bwd_dq_plain(q, k, v, out, lse, do,
                                                     layout, block, causal)
    ref_dk, ref_dv = bsa.block_sparse_attention_bwd_dkv_plain(
        q, k, v, out, lse, do, layout, block, causal)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [c + 1 for c in counts]
    fp32 = dtype == torch.float32
    tol = dict(rtol=2e-5 if fp32 else 2 ** -7, atol=2e-5 if fp32 else 2e-2)
    torch.testing.assert_close(out.float(), ref_out.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("block", [16, 32, 48, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_block_sparse_kernels_take_the_whole_domain(cuda, dtype, D, block,
                                                    causal):
    """The rest of the TPU kernel's domain: blocks of 16, 32 and 48 (the
    16-row strips in bf16, 16-row CUDA-core tiles in fp32), 256 (four
    64-row slices) at every head dim, against the plain versions (BigBird,
    8 blocks; at a block of 16 also C + 8 blocks, so that the strips'
    walks of the global column are split in two and merged). Tolerance:
    fp32 2e-5, bf16 as K1's; it holds one element, not a sum's length:
    at 4 C blocks (a column summing 8192 bf16-rounded products) one near-
    zero dK element of 3.1M exceeded it by 0.0025, within the bf16 noise
    of such a sum, so the split is held at the shortest walk that
    splits."""
    B, H = 2, 3
    for nb in (8, bsa._split(block) + 8) if block == 16 else (8,):
        T = nb * block
        layout = _sparse_layout("bigbird", H, block, T)
        if causal:
            layout = layout * np.tril(np.ones(layout.shape[1:], np.int64))
        g = torch.Generator(device=cuda).manual_seed(D + block + nb)
        q, k, v, do = (torch.randn(B, T, H, D, generator=g, device=cuda,
                                   dtype=dtype) for _ in range(4))
        route = bsa.kernel_route(dtype, block)
        routes = [f.route_launches[route] for f in (
            bsa.block_sparse_attention_fwd, bsa.block_sparse_attention_bwd_dq,
            bsa.block_sparse_attention_bwd_dkv)]
        out, lse = bsa.block_sparse_attention_fwd(q, k, v, layout, block,
                                                  causal)
        dq = bsa.block_sparse_attention_bwd_dq(q, k, v, out, lse, do, layout,
                                               block, causal)
        dk, dv = bsa.block_sparse_attention_bwd_dkv(q, k, v, out, lse, do,
                                                    layout, block, causal)
        ref_out, ref_lse = bsa.block_sparse_attention_fwd_plain(
            q, k, v, layout, block, causal)
        ref_dq = bsa.block_sparse_attention_bwd_dq_plain(
            q, k, v, out, lse, do, layout, block, causal)
        ref_dk, ref_dv = bsa.block_sparse_attention_bwd_dkv_plain(
            q, k, v, out, lse, do, layout, block, causal)
        torch.cuda.synchronize()
        assert [f.route_launches[route] for f in (
            bsa.block_sparse_attention_fwd, bsa.block_sparse_attention_bwd_dq,
            bsa.block_sparse_attention_bwd_dkv)] == [c + 1 for c in routes]
        fp32 = dtype == torch.float32
        tol = dict(rtol=2e-5 if fp32 else 2 ** -7,
                   atol=2e-5 if fp32 else 2e-2)
        torch.testing.assert_close(out.float(), ref_out.float(), **tol)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
        for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
            torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_block_sparse_kernels_are_deterministic(cuda, D, block):
    """Two runs of the bf16 fwd, dq and dkv kernels on split walks
    (non-causal BigBird at nb = 4 C) give bitwise equal outputs: the split
    items write their own partials and the merge sums them in a fixed
    order, with no atomics."""
    T = 4 * bsa._split(block) * block
    layout = _sparse_layout("bigbird", 2, block, T)
    g = torch.Generator(device=cuda).manual_seed(D + block)
    q, k, v, do = (torch.randn(1, T, 2, D, generator=g, device=cuda,
                               dtype=torch.bfloat16) for _ in range(4))

    def run():
        out, lse = bsa.block_sparse_attention_fwd(q, k, v, layout, block,
                                                  False)
        dq = bsa.block_sparse_attention_bwd_dq(q, k, v, out, lse, do, layout,
                                               block, False)
        return (out, lse, dq) + bsa.block_sparse_attention_bwd_dkv(
            q, k, v, out, lse, do, layout, block, False)

    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("out", "lse", "dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_sparse_attention_gradients_through_the_kernels(cuda, causal):
    """``sparse_attention`` on CUDA tensors: one launch of each K9 kernel
    per forward and backward, and gradients equal to autograd through the
    plain forward (fp32, 2e-5)."""
    B, H, D, block = 2, 3, 64, 64
    T = 8 * block
    cfg = BigBirdSparsityConfig(num_heads=H, block=block,
                                num_random_blocks=1,
                                num_sliding_window_blocks=3,
                                num_global_blocks=1)
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device=cuda)
                   for _ in range(4))
    kernels = (bsa.block_sparse_attention_fwd,
               bsa.block_sparse_attention_bwd_dq,
               bsa.block_sparse_attention_bwd_dkv)
    counts = [f.launches for f in kernels]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sparse_attention(*leaves, sparsity_config=cfg, causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [c + 1 for c in counts]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    layout = cfg.make_layout(T)
    if causal:
        layout = layout * np.tril(np.ones(layout.shape[1:], np.int64))
    ref, _ = bsa.block_sparse_attention_fwd_plain(*plain, layout, block,
                                                  causal)
    ref.backward(do)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=2e-5, atol=2e-5)


def test_block_sparse_kernels_refuse_what_they_do_not_cover(cuda):
    """Head dims, blocks and dtypes outside the kernels' range raise on
    CUDA tensors (a head dim of 72, a block of 8); nothing falls back to
    the plain version."""
    ones = lambda H, nb: np.ones((H, nb, nb), np.int64)
    q = torch.zeros(1, 256, 2, 72, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        bsa.block_sparse_attention_fwd(q, q, q, ones(2, 4), 64)
    q = torch.zeros(1, 256, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        bsa.block_sparse_attention_fwd(q, q, q, ones(2, 32), 8)
    with pytest.raises(ValueError, match="bf16 or"):
        h = q.half()
        bsa.block_sparse_attention_fwd(h, h, h, ones(2, 4), 64)


#: a 2-layer fp32 Llama whose heads the kernels take (head_dim 128, GQA
#: group 2), as chip_smoke.py's small reference
SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=1)


@pytest.mark.parametrize("weights", [None, "int8"], ids=["fp32", "int8"])
def test_serving_step_replays_as_cuda_graphs(cuda, weights):
    """The unified serving step with enable_cuda_graph and bucketed widths
    (each width's first step eager, then captured; later steps replay)
    serves the uncaptured engine's tokens on the card, leaks no page, and
    K6 runs once per layer per step on the device."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**SMALL)
    params = LlamaForCausalLM(cfg).init_params(seed=3, device=cuda)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 512, int(n)) for n in (5, 90, 33, 17, 60, 8)]
    outs = []
    for graphed in (False, True):
        eng = dt.init_inference(LlamaForCausalLM(cfg), params=params,
                                dtype="fp32", quantize_weights=weights,
                                enable_cuda_graph=graphed)
        srv = dt.ServingEngine(eng, dt.ServingConfig(
            max_batch_size=4, block_size=16, num_blocks=64,
            max_model_len=128, prefill_token_budget=32, trace=True,
            mixed_step_buckets=graphed))
        rids = [srv.submit(p, max_new_tokens=10) for p in prompts]
        ra.reset_kernel_runs()
        res = srv.run()
        steps = sum(e["name"] == "mixed_step" for e in srv.tracer.events())
        assert ra.kernel_runs() == cfg.num_hidden_layers * steps
        assert srv.block_pool.used_count == 0
        outs.append([(res[r].state, res[r].tokens) for r in rids])
        if graphed:
            assert len(srv._graphs) == srv.compile_counts["mixed_step"] > 1
    assert outs[0] == outs[1]


@pytest.mark.parametrize("gen_kw", [dict(), dict(eos_token_id=-7),
                                    dict(do_sample=True, top_k=20, seed=5)],
                         ids=["greedy", "eos", "sampled"])
def test_generate_decode_replays_as_a_cuda_graph(cuda, gen_kw):
    """generate with enable_cuda_graph (the decode step one captured graph
    for the last shape, replayed once a token) gives the uncaptured loop's tokens
    on the card, on a second call too (the graph replayed from the
    start), greedy, with an EOS, and sampled; a call at another batch
    replaces the graph, and the first shape is then captured again."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**SMALL)
    params = LlamaForCausalLM(cfg).init_params(seed=3, device=cuda)
    rs = np.random.RandomState(6)
    ids = rs.randint(1, 512, (3, 40))
    mask = np.ones_like(ids)
    mask[0, :30] = 0
    kw = dict(gen_kw, max_new_tokens=20)
    engines = [dt.init_inference(LlamaForCausalLM(cfg), params=params,
                                 dtype="fp32", quantize_weights="int8",
                                 enable_cuda_graph=graphed)
               for graphed in (False, True)]
    want = engines[0].generate(ids, attention_mask=mask, **{
        **kw, "eos_token_id": None})
    if "eos_token_id" in kw:
        kw["eos_token_id"] = int(want[0, 3])
        want = engines[0].generate(ids, attention_mask=mask, **kw)
    for _ in range(2):
        got = engines[1].generate(ids, attention_mask=mask, **kw)
        assert torch.equal(got, want)
    assert "graph" in next(iter(engines[1]._decode_graphs.values()))
    # another batch releases the graph; the first shape is captured anew
    other = engines[1].generate(ids[:2], attention_mask=mask[:2], **kw)
    assert torch.equal(other, engines[0].generate(ids[:2],
                                                  attention_mask=mask[:2],
                                                  **kw))
    assert torch.equal(engines[1].generate(ids, attention_mask=mask, **kw),
                       want)
    assert len(engines[1]._decode_graphs) == 1


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked_prefix_cache", "monolithic_flash"])
def test_two_program_forwards_replay_as_cuda_graphs(cuda, chunked):
    """The two-program engine with enable_cuda_graph (the decode over all
    slots, the [1, chunk] prefill and each monolithic bucket one captured
    graph, replayed after its first forward) serves the uncaptured
    engine's tokens on the card, with the prefix cache and with the masked
    flash prefill, and leaks no page. On both routes K7a runs once per
    layer per decode forward and K7b (or the masked K1) once per layer per
    chunk (or monolithic) forward, counted on the device."""
    import dataclasses

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**SMALL, prefill_flash_from_empty=not chunked)
    params = LlamaForCausalLM(cfg).init_params(seed=3, device=cuda)
    rs = np.random.RandomState(5)
    prefix = list(rs.randint(0, 512, 32))
    phases = [[prefix + list(rs.randint(0, 512, 5))],
              [prefix + list(rs.randint(0, 512, int(n)))
               for n in (3, 40, 17, 9, 60)]]
    scfg = dict(max_batch_size=4, block_size=16, num_blocks=64,
                max_model_len=128, mixed_step=False)
    if chunked:
        scfg.update(prefix_cache=True, prefill_chunk_tokens=16,
                    prefill_token_budget=32)
    prefill = "paged_prefill_attention" if chunked else \
        "flash_attention_fwd_masked"
    L = cfg.num_hidden_layers
    outs = []
    for graphed in (False, True):
        eng = dt.init_inference(LlamaForCausalLM(dataclasses.replace(cfg)),
                                params=params, dtype="fp32",
                                enable_cuda_graph=graphed)
        srv = dt.ServingEngine(eng, dt.ServingConfig(**scfg))
        for name in ("paged_decode_attention", prefill):
            _runs.reset_kernel_runs(name)
        tokens = []
        for phase in phases:
            rids = [srv.submit(p, max_new_tokens=10) for p in phase]
            res = srv.run()
            tokens += [(res[r].state, res[r].tokens) for r in rids]
        assert srv.block_pool.used_count == 0
        forwards = srv.prefill_chunk_calls if chunked else srv.prefill_calls
        assert (_runs.kernel_runs("paged_decode_attention"),
                _runs.kernel_runs(prefill)) == \
            (L * srv.decode_calls, L * forwards)
        outs.append((tokens, srv.decode_calls, srv.prefill_chunk_calls,
                     srv.prefill_calls))
        if graphed:
            kinds = {k[0] for k in srv._graphs}
            assert kinds == ({"decode", "chunk"} if chunked
                             else {"decode", "prefill"})
    assert outs[0] == outs[1]
