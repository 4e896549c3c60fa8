"""The legacy grouped int8 quantization (``init_inference(quantize=True)``,
``dtype="int8"``, ``dequant_per_step``, ``quantize_groups``) of the port
against the JAX package's.

- ``quantize_params``: the codes, scales and zeros of every leaf equal the
  JAX ones bit for bit on the same tree (a scanned and an unscanned tiny
  Llama, a GPT-2 and a generic OPT-style tree), the port's leaves read
  through ``checkpoint.from_flax.flax_leaves`` (the JAX leaf's layout, so
  each group holds the same elements); the grouped ``quantize`` /
  ``dequantize`` match JAX's for symmetric and asymmetric codes.
- ``generate`` is token-identical to the JAX engine's with ``quantize``
  (fp32 compute) and with ``dequant_per_step``, also through the static
  decode loop that a CUDA device captures (uncaptured here). With
  ``dtype="int8"`` (bf16 compute in both) the teacher-forced logits agree
  within 0.05 and the greedy tokens are identical up to the first JAX
  near-tie (a top-2 gap within 0.1; on these seeds one bf16 tie, at the
  last token of one row).
- Both serving engines (the unified step and the two-program engine) serve
  the JAX engine's tokens with ``quantize=True``, no page leaked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.compression import quantization as jq
from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.models import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2
from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models import transformer as jt
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import (flax_leaves,
                                                      flax_to_torch_state_dict)
from deepspeed_tpu_torch.compression import quantization as tq
from deepspeed_tpu_torch.models import (GPT2Config, LlamaConfig,
                                        LlamaForCausalLM)
from deepspeed_tpu_torch.models import transformer as tt
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, which only
    contend for the cores with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(model, T=8):
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"])


def _trees(case):
    """``(flax params, port config)`` of one tree."""
    if case.startswith("llama"):
        scan = case == "llama_scanned"
        model = JaxLlama(JaxConfig.tiny(remat=False, scan_layers=scan))
        return _init(model), LlamaConfig.tiny(scan_layers=scan)
    if case == "gpt2":
        kw = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                  n_head=4)
        return _init(JaxGPT2(JaxGPT2Config(**kw))), GPT2Config(**kw)
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=64, pos_offset=2, activation="relu")
    return _init(jt.TransformerLMHeadModel(jt.TransformerConfig(**kw))), \
        tt.TransformerConfig(**kw)


def _path(keys):
    return "/".join(str(k.key) for k in keys)


@pytest.mark.parametrize("groups", [32, 7])
@pytest.mark.parametrize("case", ["llama_scanned", "llama_unscanned", "gpt2",
                                  "opt_generic"])
def test_quantize_params_codes_are_bit_identical_to_jax(case, groups):
    params, cfg = _trees(case)
    jqp, jmeta = jq.quantize_params(params, groups)
    want = {_path(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(jqp)}
    want_meta = {_path(p): m for p, m in
                 jax.tree_util.tree_leaves_with_path(
                     jmeta, is_leaf=lambda x: x is None or "scale" in x)}
    leaves = flax_leaves(flax_to_torch_state_dict(params, cfg), cfg)
    qp, meta = tq.quantize_params({p: v.tensor() for p, v in leaves}, groups)
    assert [p for p, _ in leaves] == list(want)      # the JAX leaf order
    n_quantized = 0
    for path, codes in qp.items():
        np.testing.assert_array_equal(codes.numpy(), want[path])
        key = "".join(f"['{k}']" for k in path.split("/"))
        jm = jmeta[key]
        assert (meta[path] is None) == (jm is None), path
        if jm is None:
            continue
        n_quantized += 1
        assert codes.dtype == torch.int8
        for field in ("scale", "zero"):
            np.testing.assert_array_equal(meta[path][field].numpy(),
                                          np.asarray(jm[field]))
        assert meta[path]["shape"] == tuple(jm["shape"])
    assert n_quantized >= 3
    assert set(want_meta)  # the JAX metas were read
    # and back: dequantize_params equals JAX's at fp32 and bf16
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        back = tq.dequantize_params(qp, meta, dtype)
        jback = {_path(p): np.asarray(a.astype(jnp.float32)) for p, a in
                 jax.tree_util.tree_leaves_with_path(
                     jq.dequantize_params(jqp, jmeta, jdtype))}
        for path, t in back.items():
            assert t.dtype == dtype or not t.is_floating_point()
            np.testing.assert_array_equal(t.float().numpy(), jback[path])


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("shape,groups", [((4, 64, 96), 32), ((5000,), 7)])
def test_grouped_quantize_matches_jax(shape, groups, symmetric):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) * 3
    want = jq.quantize(jnp.asarray(x), 8, groups, symmetric)
    got = tq.quantize(torch.from_numpy(x), 8, groups, symmetric)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tuple(got[3]) == tuple(want[3])
    np.testing.assert_array_equal(
        tq.dequantize(*got).numpy(),
        np.asarray(jq.dequantize(*want, dtype=jnp.float32)))
    out = torch.empty(shape)
    tq.dequantize(*got, out=out)
    np.testing.assert_array_equal(out.numpy(), tq.dequantize(*got).numpy())
    if symmetric:
        # no zero point: one multiply a group, rounded as it is stored
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            want_d = np.asarray(jq.dequantize(*want, dtype=jdtype).astype(
                jnp.float32))
            out = torch.empty(shape, dtype=dtype)
            tq.dequantize(got[0], got[1], None, got[3], dtype, out=out)
            np.testing.assert_array_equal(out.float().numpy(), want_d)
            np.testing.assert_array_equal(
                tq.dequantize(got[0], got[1], None, got[3], dtype
                              ).float().numpy(), want_d)


@pytest.fixture(scope="module")
def tiny():
    model = JaxLlama(JaxConfig.tiny(remat=False))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params, flax_to_torch_state_dict(jax.device_get(params),
                                                   LlamaConfig.tiny())


def _prompts(lens, seed=0, vocab=256):
    rs = np.random.RandomState(seed)
    T = max(lens)
    ids = np.zeros((len(lens), T), np.int32)
    mask = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        ids[b, T - n:] = rs.randint(1, vocab, n)
        mask[b, T - n:] = 1
    return ids, mask


GENERATE = {
    # name: engine kwargs (both packages), port-only kwargs
    "quantize_fp32": (dict(quantize=True, dtype="fp32"), {}),
    "quantize_groups_8": (dict(quantize=True, quantize_groups=8,
                               dtype="fp32"), {}),
    "dtype_int8_bf16_compute": (dict(dtype="int8"), {}),
    "dequant_per_step": (dict(quantize=True, dtype="fp32",
                              dequant_per_step=True), {}),
    "dequant_per_step_static_loop": (
        dict(quantize=True, dtype="fp32", dequant_per_step=True),
        dict(enable_cuda_graph=True)),
}


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_generate_tokens_identical_to_jax(tiny, case):
    jmodel, jparams, sd = tiny
    kw, port_kw = GENERATE[case]
    ids, mask = _prompts((5, 11, 3), seed=len(case))
    jeng = jds.init_inference(jmodel, params=jparams, **kw)
    want = np.asarray(jeng.generate(jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask),
                                    max_new_tokens=12))
    teng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()), params=sd,
                             device="cpu", **kw, **port_kw)
    assert teng.compute_dtype == (torch.bfloat16 if kw["dtype"] == "int8"
                                  else torch.float32)
    assert teng.config.quantize
    got = teng.generate(ids, attention_mask=mask, max_new_tokens=12).numpy()
    if teng.compute_dtype == torch.float32:
        np.testing.assert_array_equal(got, want)
    else:
        _assert_bf16_tokens_agree(jeng, teng, ids, mask, got, want)
    # the bound weights are the dequantized codes
    w = teng.module.model.layers[1].mlp.up_proj.weight
    assert w.dtype == teng.compute_dtype
    q = float((w.float() - torch.from_numpy(np.array(
        jparams["model"]["layers"]["block"]["mlp"]["up_proj"]["kernel"][1]
    )).T).abs().max())
    assert 0 < q < 0.01


#: bf16 logits of the two packages on the same dequantized weights (each
#: projection rounds to bf16, in other places inside a matmul)
BF16_LOGIT_TOL = 0.05


def _assert_bf16_tokens_agree(jeng, teng, ids, mask, got, want):
    """bf16 compute: teacher-forced on the JAX tokens, the port's logits
    are within ``BF16_LOGIT_TOL`` of the JAX engine's; the free-running
    tokens are the JAX ones in every row up to the first step whose JAX
    logits have a top-2 gap within twice that (a near tie, which either
    package may break either way; one is a bf16 tie here), and
    only there may they part."""
    full = np.concatenate([ids, want], 1)
    fmask = np.concatenate([mask, np.ones_like(want)], 1)
    jl = np.asarray(jeng.forward(jnp.asarray(full), attention_mask=jnp.asarray(
        fmask)).astype(jnp.float32))[:, ids.shape[1] - 1:-1]
    tl = teng.forward(full, attention_mask=torch.from_numpy(fmask)
                      ).float().numpy()[:, ids.shape[1] - 1:-1]
    np.testing.assert_allclose(tl, jl, atol=BF16_LOGIT_TOL, rtol=0)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    for b in range(want.shape[0]):
        differ = np.nonzero(got[b] != want[b])[0]
        if differ.size:
            assert gap[b, differ[0]] <= 2 * BF16_LOGIT_TOL, \
                (b, differ[0], gap[b, differ[0]])


@pytest.mark.parametrize("kw", [
    dict(quantize=True, dtype="fp32"),
    dict(quantize=True, dtype="fp32", dequant_per_step=True),
    dict(quantize=True, dtype="fp32", quantize_groups=7),
    dict(dtype="int8")], ids=["fp32", "dequant_per_step", "groups_7",
                              "int8"])
def test_bound_weights_are_the_jax_dequantized_codes(tiny, kw):
    """The engine binds JAX's ``dequantize_params(quantize_params(w))`` bit
    for bit, every leaf (the small ones cast as they are), in the compute
    dtype; ``dequant_per_step`` binds the same weights."""
    _, jparams, sd = tiny
    teng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()), params=sd,
                             device="cpu", **kw)
    jdtype = jnp.bfloat16 if kw["dtype"] == "int8" else jnp.float32
    want = {_path(p): np.asarray(a.astype(jnp.float32)) for p, a in
            jax.tree_util.tree_leaves_with_path(jq.dequantize_params(
                *jq.quantize_params(jax.device_get(jparams),
                                    kw.get("quantize_groups", 32)),
                dtype=jdtype))}
    got = flax_leaves(teng.module.state_dict(), teng.module.config)
    assert [p for p, _ in got] == list(want)
    for path, view in got:
        t = view.tensor()
        assert t.dtype == teng.compute_dtype, path
        np.testing.assert_array_equal(t.float().numpy(), want[path],
                                      err_msg=path)


def test_config_sets_and_refuses_as_jax():
    model = LlamaForCausalLM(LlamaConfig.tiny())
    params = model.init_params()
    eng = dt.init_inference(model, params=params, device="cpu", dtype="int8")
    assert eng.config.quantize and eng.config.dtype == torch.int8
    for bad in ({"quantize": True, "quantize_weights": "int8"},
                {"dtype": "int8", "quantize_weights": "int4"},
                {"quantize": True, "quantize_groups": 0}):
        with pytest.raises(ValueError):
            dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()),
                              params=params, device="cpu", **bad)
        jbad = dict(bad, quantize_groups=1) if "quantize_groups" in bad \
            else bad
        if "quantize_groups" not in bad:
            with pytest.raises(ValueError):
                jds.init_inference(
                    JaxLlama(JaxConfig.tiny()), params=jax.device_get(
                        JaxLlama(JaxConfig.tiny()).init(
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))["params"]),
                    **jbad)


SERVE = dict(max_batch_size=4, block_size=8, num_blocks=48, max_model_len=64,
             prefill_chunk_tokens=8, prefill_token_budget=16)


@pytest.mark.parametrize("engine_kind", ["unified", "two_program",
                                         "unified_static_graph_buffers"])
def test_serving_tokens_identical_to_jax(tiny, engine_kind):
    jmodel, jparams, sd = tiny
    kw = dict(quantize=True, dtype="fp32")
    jeng = jds.init_inference(jmodel, params=jparams, **kw)
    port_kw = dict(enable_cuda_graph=True) \
        if engine_kind.endswith("graph_buffers") else {}
    teng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()), params=sd,
                             device="cpu", **kw, **port_kw)
    scfg = dict(SERVE, mixed_step=engine_kind != "two_program")
    jsrv = JaxServingEngine(jeng, JaxServingConfig(**scfg))
    tsrv = dt.ServingEngine(teng, dt.ServingConfig(**scfg))
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, 256, n) for n in (3, 18, 11, 25, 7)]
    new = (5, 9, 4, 7, 6)

    def serve(srv):
        rids = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
        res = srv.run()
        return [(res[r].state, res[r].finish_reason, res[r].tokens)
                for r in rids]

    want = serve(jsrv)
    got = serve(tsrv)
    assert got == want
    assert all(state == "finished" for state, _, _ in got)
    tsrv.block_pool.check_consistent()
    assert tsrv.block_pool.used_count == 0
