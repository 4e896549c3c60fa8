"""The port's ``DeepSpeedTransformerLayer`` against the JAX layer.

The cases of the JAX package's ``tests/unit/ops/test_transformer_layer.py``
(forward with masking, gradients and remat parity, post-LN, ``fp16``,
``return_tuple``, the init range, dropout when not deterministic), each
run on both layers from one set of flax params (the JAX ``layer.init``,
through ``checkpoint.from_flax``) and numpy-seeded inputs. Tolerances:
fp32 1e-5 (outputs) and 1e-4 (gradients); ``fp16`` (bf16 compute in both)
3e-2, about two bf16 roundings of values of order one. Dropout draws
differ between the frameworks (``jax.random`` against torch's
generator), so the dropout case holds the port to its own statistics: the
draws change the output, two draws differ, and the deterministic forward
is the ratio-free layer's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import DeepSpeedTransformerConfig as JaxConfig
from deepspeed_tpu.ops import DeepSpeedTransformerLayer as JaxLayer
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.ops import (DeepSpeedTransformerConfig,
                                     DeepSpeedTransformerLayer)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, which only
    contend for the cores with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(pre_ln=True, **kw):
    return dict(dict(batch_size=2, hidden_size=32, heads=4,
                     intermediate_size=64, num_hidden_layers=2,
                     pre_layer_norm=pre_ln), **kw)


def _pair(pre_ln=True, seed=0, x=None, **kw):
    """The JAX layer with its params and the port's with the same."""
    jl = JaxLayer(JaxConfig(**_kw(pre_ln, **kw)))
    if x is None:
        x = np.zeros((2, 8, 32), np.float32)
    params = jl.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                     jnp.ones(x.shape[:2], jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = DeepSpeedTransformerConfig(**_kw(pre_ln, **kw))
    tl = DeepSpeedTransformerLayer(cfg, device="cpu")
    tl.load_state_dict(flax_to_torch_state_dict(params, cfg), strict=True)
    return jl, params, tl


def test_config_fields_and_block_config_match_jax():
    assert [f.name for f in dataclasses.fields(JaxConfig)] == \
        [f.name for f in dataclasses.fields(DeepSpeedTransformerConfig)]
    for kw in ({}, {"fp16": True, "gelu_checkpoint": True,
                    "intermediate_size": -1}):
        j = JaxConfig(**_kw(**kw)).to_block_config()
        t = DeepSpeedTransformerConfig(**_kw(**kw)).to_block_config()
        for f in dataclasses.fields(j):
            jv, tv = getattr(j, f.name), getattr(t, f.name)
            if f.name == "compute_dtype":
                assert (jv is None) == (tv is None)
                assert tv in (None, torch.bfloat16)
            else:
                assert jv == tv, f.name


def test_forward_shape_and_masking():
    rs = np.random.RandomState(0)
    h = rs.randn(2, 10, 32).astype(np.float32)
    jl, params, tl = _pair(x=h)
    mask = np.ones((2, 10), np.int32)
    mask2 = mask.copy()
    mask2[:, -3:] = 0
    h2 = h.copy()
    h2[:, -3:] = 100.0
    for m in (mask, mask2):
        want = np.asarray(jl.apply({"params": params}, jnp.asarray(h),
                                   jnp.asarray(m)))
        with torch.no_grad():
            got = tl(torch.from_numpy(h), torch.from_numpy(m))
        assert got.shape == h.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # masked key positions do not reach unmasked queries
    with torch.no_grad():
        o1 = tl(torch.from_numpy(h), torch.from_numpy(mask2))
        o2 = tl(torch.from_numpy(h2), torch.from_numpy(mask2))
    np.testing.assert_allclose(o1[:, :7].numpy(), o2[:, :7].numpy(),
                               atol=1e-5)
    # an additive bias and no mask at all (the flash route's plain version)
    bias = np.where(mask2[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(h),
                               jnp.asarray(bias)))
    with torch.no_grad():
        got = tl(torch.from_numpy(h), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(h)))
    with torch.no_grad():
        got = tl(torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [True, False])
def test_grads_and_remat_parity(masked):
    rs = np.random.RandomState(1)
    h = rs.randn(2, 8, 32).astype(np.float32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 6:] = 0
    args = (jnp.asarray(mask),) if masked else ()
    targs = (torch.from_numpy(mask),) if masked else ()
    jl, params, tl = _pair(x=h)

    def loss(p, x):
        return jl.apply({"params": p}, x, *args).sum()

    jg, jx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(h))
    want = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, jg),
                                    tl.config)
    remat = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(
        **_kw(gelu_checkpoint=True)), device="cpu")
    remat.load_state_dict(tl.state_dict())
    for layer in (tl, remat):
        x = torch.from_numpy(h).requires_grad_(True)
        layer.zero_grad()
        layer(x, *targs).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jx),
                                   atol=1e-4, rtol=1e-4)
        for n, p in layer.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=n)
    with torch.no_grad():
        np.testing.assert_allclose(tl(torch.from_numpy(h), *targs).numpy(),
                                   remat(torch.from_numpy(h), *targs).numpy(),
                                   atol=1e-6)


def test_post_ln_fp16_and_tuple():
    rs = np.random.RandomState(2)
    h = rs.randn(2, 6, 32).astype(np.float32)
    mask = np.ones((2, 6), np.int32)
    kw = dict(fp16=True, return_tuple=True)
    jl, params, tl = _pair(pre_ln=False, seed=1, x=h, **kw)
    (want,) = jl.apply({"params": params}, jnp.asarray(h), jnp.asarray(mask))
    with torch.no_grad():
        (got,) = tl(torch.from_numpy(h), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.shape == h.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=0)
    fp32 = np.asarray(_pair(pre_ln=False, seed=1, x=h)[0].apply(
        {"params": params}, jnp.asarray(h), jnp.asarray(mask)))
    assert np.abs(fp32 - np.asarray(want.astype(jnp.float32))).max() > 1e-3


def test_dropout_applies_when_not_deterministic():
    rs = np.random.RandomState(3)
    h = torch.from_numpy(rs.randn(2, 8, 32).astype(np.float32))
    mask = torch.ones((2, 8), dtype=torch.int32)
    _, _, tl = _pair(attn_dropout_ratio=0.2, hidden_dropout_ratio=0.2)
    with torch.no_grad():
        det = tl(h, mask)
        torch.manual_seed(1)
        d1 = tl(h, mask, deterministic=False)
        torch.manual_seed(2)
        d2 = tl(h, mask, deterministic=False)
        torch.manual_seed(1)
        d1_again = tl(h, mask, deterministic=False)
    assert not torch.allclose(det, d1)
    assert not torch.allclose(d1, d2)
    torch.testing.assert_close(d1, d1_again, rtol=0, atol=0)
    # the deterministic path does not see the ratios
    _, _, base = _pair()
    base.load_state_dict(tl.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(det, base(h, mask), rtol=0, atol=1e-6)


def test_initializer_range_applied():
    cfg = DeepSpeedTransformerConfig(**dict(_kw(), hidden_size=256,
                                            intermediate_size=512, seed=5))
    sd = DeepSpeedTransformerLayer(cfg, device="cpu").state_dict()
    q = sd["layer.attn.q_proj.weight"]
    o = sd["layer.attn.o_proj.weight"]
    assert 0.018 < float(q.std()) < 0.022
    # residual-output projections scaled by 1/sqrt(2 * num_hidden_layers)
    assert 0.018 / 2 < float(o.std()) < 0.022 / 2
    # the JAX layer's init has the same spread
    jl = JaxLayer(JaxConfig(**dict(_kw(), hidden_size=256,
                                   intermediate_size=512)))
    p = jl.init(jax.random.PRNGKey(5), jnp.zeros((2, 8, 256)),
                jnp.ones((2, 8), jnp.int32))["params"]["layer"]
    assert 0.018 < float(np.std(p["attn"]["q_proj"]["kernel"])) < 0.022
    assert 0.018 / 2 < float(np.std(p["attn"]["o_proj"]["kernel"])) < \
        0.022 / 2


def test_layer_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**_kw()))
