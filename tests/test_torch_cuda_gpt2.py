"""GPT-2's paths on the card against the same model on the CPU.

Marked ``cuda``: each test skips (with the reason) where no CUDA device is
present. On a machine with one, run them with
``python -m pytest --noconftest tests/test_torch_cuda_gpt2.py -m cuda``.

A small GPT-2 (2 layers, 4 heads of 64: GPT-2's head dim; fp32, seeded
weights) runs ``generate`` and both serving engines on the card, through
K4, the masked K1, K5 (int8 weights), K6, K7a and K7b, and on the CPU,
through their plain versions: the greedy tokens must be identical (in
fp32 the two sides differ only in summation order), and each kernel's
wrapper must have launched. An HF ``GPT2LMHeadModel`` injected on the
card gives HF's own greedy tokens.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.ops.decode_attention import (decode_attention,
                                                      paged_decode_attention,
                                                      paged_prefill_attention)
from deepspeed_tpu_torch.ops.flash_attention import \
    flash_attention_fwd_masked
from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul
from deepspeed_tpu_torch.ops.ragged_attention import ragged_paged_attention

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=512, n_positions=256, n_embd=256, n_layer=2,
             n_head=4)
WRAPPERS = {"K4": decode_attention, "K1m": flash_attention_fwd_masked,
            "K5": quant_matmul, "K6": ragged_paged_attention,
            "K7a": paged_decode_attention, "K7b": paged_prefill_attention}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def _prompts(lens, seed):
    rs = np.random.RandomState(seed)
    T = max(lens)
    ids = np.zeros((len(lens), T), np.int64)
    mask = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        ids[b, T - n:] = rs.randint(1, SMALL["vocab_size"], n)
        mask[b, T - n:] = 1
    return ids, mask


GENERATE = {
    # name: (model overrides, engine kw, the kernels the card must launch)
    "fp32": ({}, {}, ("K4",)),
    "flash_prefill": ({"prefill_flash_from_empty": True}, {}, ("K4", "K1m")),
    "int8_weights": ({}, {"quantize_weights": "int8"}, ("K4", "K5")),
}


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_generate_on_the_card_gives_the_plain_tokens(cuda, case):
    over, engine_kw, kernels = GENERATE[case]
    cfg = GPT2Config(**SMALL, **over)
    params = GPT2LMHeadModel(cfg).init_params(seed=0)
    ids, mask = _prompts((40, 17, 64, 5), seed=1)
    out = {}
    for dev in ("cpu", "cuda"):
        engine = dt.init_inference(GPT2LMHeadModel(cfg), params=params,
                                   dtype="fp32", device=dev, **engine_kw)
        before = _launches()
        out[dev] = engine.generate(ids, attention_mask=mask,
                                   max_new_tokens=12).cpu()
        launched = {k: _launches()[k] - before[k] for k in WRAPPERS}
    assert torch.equal(out["cuda"], out["cpu"])
    assert all(launched[k] > 0 for k in kernels), launched


SERVE = {
    # name: (model overrides, serving config, the kernels launched)
    "unified": ({}, dict(mixed_step=True, prefill_token_budget=32), ("K6",)),
    "two_program_chunked_prefix": (
        {}, dict(mixed_step=False, prefix_cache=True, prefill_chunk_tokens=16),
        ("K7a", "K7b")),
    "two_program_flash": ({"prefill_flash_from_empty": True},
                          dict(mixed_step=False), ("K7a", "K1m")),
}


@pytest.mark.parametrize("case", sorted(SERVE))
def test_serving_on_the_card_gives_the_plain_tokens(cuda, case):
    over, scfg, kernels = SERVE[case]
    cfg = GPT2Config(**SMALL, **over)
    params = GPT2LMHeadModel(cfg).init_params(seed=0)
    rs = np.random.RandomState(2)
    prefix = list(rs.randint(1, 512, 32))
    prompts = [prefix + list(rs.randint(1, 512, n)) for n in (9, 40, 3, 70)]
    out = {}
    for dev in ("cpu", "cuda"):
        engine = dt.init_inference(GPT2LMHeadModel(cfg), params=params,
                                   dtype="fp32", device=dev)
        srv = dt.ServingEngine(engine, dt.ServingConfig(
            max_batch_size=4, block_size=16, num_blocks=64, max_model_len=256,
            **scfg))
        before = _launches()
        first = srv.submit(prompts[0], max_new_tokens=8)
        srv.run()
        rids = [first] + [srv.submit(p, max_new_tokens=8)
                          for p in prompts[1:]]
        res = srv.run()
        launched = {k: _launches()[k] - before[k] for k in WRAPPERS}
        out[dev] = [(res[r].state, res[r].tokens) for r in rids]
        assert srv.block_pool.used_count == 0
    assert out["cuda"] == out["cpu"]
    assert all(state == "finished" for state, _ in out["cuda"])
    assert all(launched[k] > 0 for k in kernels), launched


def test_an_injected_hf_gpt2_gives_hf_greedy_tokens_on_the_card(cuda):
    import transformers

    torch.manual_seed(0)
    with torch.device("cuda"):
        hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=512, n_positions=256, n_embd=256, n_layer=2,
            n_head=4)).eval()
    engine = dt.init_inference(hf, dtype="fp32")
    ids = np.random.RandomState(3).randint(0, 512, (4, 32))
    eos = hf.config.eos_token_id
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(ids).cuda(),
                           attention_mask=torch.ones((4, 32), dtype=torch.long,
                                                     device="cuda"),
                           max_new_tokens=10, do_sample=False,
                           pad_token_id=eos, eos_token_id=eos)[:, 32:]
    want = torch.nn.functional.pad(want, (0, 10 - want.shape[1]), value=eos)
    got = engine.generate(ids, max_new_tokens=10, eos_token_id=eos)
    assert torch.equal(got.cpu(), want.cpu())
