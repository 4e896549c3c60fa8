"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with the reason) where no CUDA device is
present. On a machine with one, run them with
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
Tolerance: fp32 inputs differ only by summation order (1e-5); bf16
outputs are roundings of nearly equal fp32 values, so they agree to one
bf16 ulp (2**-7 relative).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.ragged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, dtype, int8, D, Hkv, G, seed=0):
    """Decode rows, chunk rows, idle rows, sentinel tails, padding."""
    rs = np.random.RandomState(seed)
    N, bs, R, nb = 40, 16, 5, 8
    rows = [(1, 70), (0, 0), (37, 20), (20, 0), (1, 127)]  # (qlen, start)
    bt = np.full((R, nb), N, np.int32)
    qs, ql, cs, cl = (np.zeros(R, np.int32) for _ in range(4))
    pages, cursor = iter(rs.permutation(N)), 0
    for r, (n, start) in enumerate(rows):
        if n:
            for i in range(-(-(start + n) // bs)):
                bt[r, i] = next(pages)
            qs[r], ql[r], cs[r], cl[r] = cursor, n, start, start + n
            cursor += n
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (N, Hkv, bs, D)
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8) for _ in range(2))
        scales = {n: torch.rand(shape[:3], generator=g, device=dev) / 64
                  for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(shape, generator=g, device=dev, dtype=dtype)
                for _ in range(2))
        scales = {}
    q = torch.randn((cursor + 5, Hkv * G, D), generator=g, device=dev,
                    dtype=dtype)
    desc = [torch.from_numpy(a).to(dev) for a in (bt, qs, ql, cs, cl)]
    return (q, k, v, *desc), scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8pool"])
@pytest.mark.parametrize("D,Hkv,G", [(128, 2, 4), (64, 3, 1), (128, 1, 8)])
@pytest.mark.parametrize("window", [None, 24])
def test_ragged_kernel_matches_plain(cuda, dtype, int8, D, Hkv, G, window):
    args, scales = _case(cuda, dtype, int8, D, Hkv, G)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args, window=window, **scales)
    ref = ragged_paged_attention_plain(*args, window=window, **scales)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=1e-5 if dtype == torch.float32 else 1e-3)
