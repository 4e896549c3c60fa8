"""The generic transformer's kernels on the card against their plain
versions and the same model on the CPU.

Marked ``cuda``: each test skips (with the reason) where no CUDA device is
present. On a machine with one, run them with
``python -m pytest --noconftest tests/test_torch_cuda_generic.py -m cuda``.

- K1/K2 non-causal in bf16 at head dim 64, BERT-Large's shape (the two
  sequence lengths of the BERT tutorial's phases at reduced batch): the
  forward and the gradients through ``flash_attention`` against the plain
  versions at the bf16 tolerance of the flash parity cases.
- A small NeoX-style generic decoder (rotary on a quarter of head dim 64,
  the parallel residual; fp32, seeded weights) generates on the card
  through K4 and, with ``prefill_flash_from_empty``, the masked K1, and on
  the CPU through their plain versions: identical greedy tokens, and the
  wrappers launched once per layer per decode step and per prefill.
- A BLOOM-style config (ALiBi) generates on the card with neither wrapper
  launched (the plain cached attention under its composite bias),
  uncaptured and with the decode step captured.
- One engine with ``enable_cuda_graph`` captures the decode step at one
  shape, then another (the first graph released), then the first again:
  the tokens of each equal the uncaptured engine's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLMHeadModel)
from deepspeed_tpu_torch.ops.decode_attention import decode_attention
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_fwd, flash_attention_fwd_masked, flash_attention_plain)

pytestmark = pytest.mark.cuda

NEOX = TransformerConfig(vocab_size=512, hidden_size=256,
                         intermediate_size=1024, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=512,
                         pos_embedding="rope", rotary_pct=0.25,
                         parallel_residual=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,T", [(8, 128), (2, 512)])
def test_noncausal_bf16_flash_at_bert_large_heads(cuda, B, T):
    g = torch.Generator(device=cuda).manual_seed(T)
    q, k, v, do = (torch.randn(B, T, 16, 64, device=cuda, generator=g,
                               dtype=torch.bfloat16) for _ in range(4))
    before = (flash_attention_fwd.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(qg, kg, vg, causal=False)
    out.backward(do)
    assert (flash_attention_fwd.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    want = flash_attention_plain(qf, kf, vf, causal=False)[0]
    want.backward(do.float())
    torch.testing.assert_close(out.float(), want, atol=2e-2, rtol=2e-2)
    for got, ref in ((qg, qf), (kg, kf), (vg, vf)):
        torch.testing.assert_close(got.grad.float(), ref.grad, atol=5e-2,
                                   rtol=5e-2)


def _prompts(lens, seed, vocab=512):
    rs = np.random.RandomState(seed)
    T = max(lens)
    ids = np.zeros((len(lens), T), np.int64)
    mask = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        ids[b, T - n:] = rs.randint(1, vocab, n)
        mask[b, T - n:] = 1
    return ids, mask


@pytest.mark.parametrize("flash", [False, True])
def test_generic_generate_through_k4_and_the_masked_k1(cuda, flash):
    cfg = dataclasses.replace(NEOX, prefill_flash_from_empty=flash)
    params = TransformerLMHeadModel(cfg).init_params(seed=0)
    ids, mask = _prompts((40, 17, 64), seed=1)
    cpu = dt.init_inference(TransformerLMHeadModel(cfg), params=params,
                            dtype="fp32", device="cpu")
    want = cpu.generate(ids, attention_mask=mask, max_new_tokens=8)
    card = dt.init_inference(TransformerLMHeadModel(cfg), params=params,
                             dtype="fp32", device=cuda)
    k4, k1m = decode_attention.launches, flash_attention_fwd_masked.launches
    got = card.generate(ids, attention_mask=mask, max_new_tokens=8)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    L = cfg.num_hidden_layers
    assert decode_attention.launches - k4 == L * 7
    assert flash_attention_fwd_masked.launches - k1m == (L if flash else 0)


def test_alibi_generate_launches_neither_kernel(cuda):
    cfg = dataclasses.replace(NEOX, pos_embedding="alibi",
                              parallel_residual=False,
                              prefill_flash_from_empty=True)
    params = TransformerLMHeadModel(cfg).init_params(seed=2)
    ids, mask = _prompts((9, 30), seed=3)
    cpu = dt.init_inference(TransformerLMHeadModel(cfg), params=params,
                            dtype="fp32", device="cpu")
    want = cpu.generate(ids, attention_mask=mask, max_new_tokens=6)
    for graphed in (False, True):
        card = dt.init_inference(TransformerLMHeadModel(cfg), params=params,
                                 dtype="fp32", device=cuda,
                                 enable_cuda_graph=graphed)
        k4, k1m = decode_attention.launches, \
            flash_attention_fwd_masked.launches
        got = card.generate(ids, attention_mask=mask, max_new_tokens=6)
        assert (decode_attention.launches,
                flash_attention_fwd_masked.launches) == (k4, k1m)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_captures_at_two_shapes_in_turn_on_one_engine(cuda):
    """With ``enable_cuda_graph``, a decode at a second shape releases the
    first shape's graph (the only one in the engine's pool) and captures
    its own: the tokens of each equal the uncaptured engine's."""
    params = TransformerLMHeadModel(NEOX).init_params(seed=4)
    plain = dt.init_inference(TransformerLMHeadModel(NEOX), params=params,
                              dtype="fp32", device=cuda)
    graphed = dt.init_inference(TransformerLMHeadModel(NEOX), params=params,
                                dtype="fp32", device=cuda,
                                enable_cuda_graph=True)
    for lens, new in (((12, 30), 6), ((5, 7, 9), 5), ((12, 30), 6)):
        ids, mask = _prompts(lens, seed=len(lens))
        want = plain.generate(ids, attention_mask=mask, max_new_tokens=new)
        got = graphed.generate(ids, attention_mask=mask, max_new_tokens=new)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert len(graphed._decode_graphs) == 1
