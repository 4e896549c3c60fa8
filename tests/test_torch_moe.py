"""The port's GShard MoE layer (``deepspeed_tpu_torch/moe``) against the
JAX package's (``deepspeed_tpu/moe``).

Every single-device case of ``tests/unit/test_moe.py`` runs on both
packages on the same numpy-seeded inputs, in fp32, and the results are
compared: gate math (combine weights, dispatch masks, ``exp_counts`` and
``l_aux`` to 1e-6), the modules' outputs to 1e-5 (the JAX params carried
over: a flax ``kernel [.., in, out]`` is the port's ``weight [.., out,
in]``, the stacked experts' too, expert for expert), and training losses
to 1e-4. The two packages draw their random numbers from different
generators (``jax.random`` keys, ``torch.Generator``s), so where a case
needs noise (RTS priorities, jitter, Gumbel top-2) the test patches the
port's draws (``sharded_moe.uniform_rsample`` / ``gumbel_rsample``) to
return JAX's values for the same keys, in JAX's order of splits. The
deliberate differences have their own tests: the port's eval top-2 draws
from a generator seeded 0 (JAX: ``PRNGKey(0)``), and ``ep_size > 1``
raises.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu import moe as jmoe
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.parallel import topology
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import moe
from deepspeed_tpu_torch.moe import sharded_moe as sm
from deepspeed_tpu_torch.moe.layer import set_gating_generator
from torch_threads import one_torch_thread  # noqa: F401

#: fp32 gate math and module outputs, and training losses
GATE_TOL, OUT_TOL, TRAIN_TOL = 1e-6, 1e-5, 1e-4


def _logits(s=32, e=4, seed=0):
    return np.random.RandomState(seed).randn(s, e).astype(np.float32)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same_gating(got, want, tol=GATE_TOL):
    """``(l_aux, combine, dispatch, exp_counts)`` of both packages."""
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    np.testing.assert_array_equal(_np(got[3]), _np(want[3]))
    assert got[3].dtype == torch.int32


class _JaxDraws:
    """Patches the port's draws to JAX's: each call of ``uniform_rsample``
    / ``gumbel_rsample`` returns the JAX draw for the next key of
    ``keys`` (the keys JAX's gating splits off, in order)."""

    def __init__(self, monkeypatch, keys):
        self.keys = list(keys)
        monkeypatch.setattr(sm, "uniform_rsample", self.uniform)
        monkeypatch.setattr(sm, "gumbel_rsample", self.gumbel)

    def _next(self):
        return self.keys.pop(0)

    def uniform(self, generator, shape, device=None):
        return torch.from_numpy(np.asarray(jax.random.uniform(
            self._next(), tuple(shape), jnp.float32)))

    def gumbel(self, generator, shape, device=None):
        return torch.from_numpy(np.asarray(jsm.gumbel_rsample(
            self._next(), tuple(shape))))


def _rts_keys(rng, rsample=False, jitter=False):
    """The keys JAX's ``TopKGate`` / ``top1gating`` split off ``rng``:
    jitter's, RSample's, then RTS's."""
    keys = []
    for on in (jitter, rsample, True):
        if on:
            rng, sub = jax.random.split(rng)
            keys.append(sub)
    return keys


# ---------------------------------------------------------------------------
# gating math
# ---------------------------------------------------------------------------

def test_top1_dispatch_matches_jax():
    logits = _logits()
    want = jsm.top1gating(jnp.asarray(logits), capacity_factor=2.0,
                          min_capacity=1, use_rts=False)
    got = sm.top1gating(torch.from_numpy(logits), capacity_factor=2.0,
                        min_capacity=1, use_rts=False)
    _same_gating(got, want)
    _, combine, dispatch, counts = got
    assert dispatch.sum(dim=(1, 2)).max() <= 1
    gates = torch.from_numpy(logits).softmax(dim=1)
    routed = dispatch.sum(dim=(1, 2)) > 0
    np.testing.assert_allclose(
        _np(torch.where(routed, gates.amax(dim=1), 0.0)),
        _np(combine.sum(dim=(1, 2))), rtol=1e-6)
    assert int(counts.sum()) <= logits.shape[0]
    assert float(got[0]) > 0


@pytest.mark.parametrize("drop_tokens", [True, False])
def test_top1_capacity_drops_keep_the_lowest_token_indices(drop_tokens):
    """Every token prefers expert 0, so the capacity cut ranks 16 equal
    priorities: both packages keep tokens 0..capacity-1 (without
    ``drop_tokens`` all 16)."""
    logits = np.tile(np.array([[10.0, 0.0, 0.0, 0.0]], np.float32), (16, 1))
    want = jsm.top1gating(jnp.asarray(logits), 1.0, 1, use_rts=False,
                          drop_tokens=drop_tokens)
    got = sm.top1gating(torch.from_numpy(logits), 1.0, 1, use_rts=False,
                        drop_tokens=drop_tokens)
    _same_gating(got, want)
    kept = _np(got[2].sum(dim=(1, 2)) > 0)
    n = 4 if drop_tokens else 16
    np.testing.assert_array_equal(kept, np.arange(16) < n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keep_top_tokens_breaks_ties_as_jax_top_k(seed):
    """0/1 priorities over 64 tokens and 8 experts at capacity 3: every
    expert's kept tokens are its lowest-indexed routed ones, as
    ``jax.lax.top_k`` orders equals."""
    rs = np.random.RandomState(seed)
    mask = np.eye(8, dtype=np.float32)[rs.randint(0, 8, 64)]
    priority = mask.copy()
    priority[rs.rand(64) < 0.25] *= 0.5     # a second tier of equals
    want = np.asarray(jsm._keep_top_tokens(jnp.asarray(mask),
                                           jnp.asarray(priority), 3))
    got = _np(sm._keep_top_tokens(torch.from_numpy(mask),
                                  torch.from_numpy(priority), 3))
    np.testing.assert_array_equal(got, want)
    # with the mask as its own priority, each expert keeps its first three
    plain = _np(sm._keep_top_tokens(torch.from_numpy(mask),
                                    torch.from_numpy(mask), 3))
    for e in range(8):
        np.testing.assert_array_equal(np.nonzero(plain[:, e])[0],
                                      np.nonzero(mask[:, e])[0][:3])


def test_top1_rts_needs_a_generator_and_matches_jax_on_its_draws(
        monkeypatch):
    logits = _logits()
    with pytest.raises(ValueError):
        jsm.top1gating(jnp.asarray(logits), 1.0, 1, use_rts=True)
    with pytest.raises(ValueError):
        sm.top1gating(torch.from_numpy(logits), 1.0, 1, use_rts=True)
    rng = jax.random.PRNGKey(7)
    want = jsm.top1gating(jnp.asarray(logits), 1.0, 1, use_rts=True,
                          rng=rng)
    _JaxDraws(monkeypatch, _rts_keys(rng))
    got = sm.top1gating(torch.from_numpy(logits), 1.0, 1, use_rts=True,
                        generator=torch.Generator())
    _same_gating(got, want)


def test_top1_rsample_noise_then_rts_match_jax(monkeypatch):
    logits = _logits(s=48, e=6, seed=3)
    rng = jax.random.PRNGKey(11)
    want = jsm.top1gating(jnp.asarray(logits), 1.0, 1,
                          noisy_gate_policy="RSample", use_rts=True, rng=rng)
    _JaxDraws(monkeypatch, _rts_keys(rng, rsample=True))
    got = sm.top1gating(torch.from_numpy(logits), 1.0, 1,
                        noisy_gate_policy="RSample", use_rts=True,
                        generator=torch.Generator())
    _same_gating(got, want)


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_top2_combine_weights_match_jax(monkeypatch, capacity_factor):
    """Ample capacity: every token keeps both experts and its weights sum
    to 1; at 0.5 the second choices overflow and drop as in JAX."""
    logits = _logits(s=64, e=4, seed=1)
    rng = jax.random.PRNGKey(0)
    want = jsm.top2gating(jnp.asarray(logits), capacity_factor, 1, rng=rng)
    _JaxDraws(monkeypatch, [rng])
    got = sm.top2gating(torch.from_numpy(logits), capacity_factor, 1,
                        generator=torch.Generator())
    _same_gating(got, want)
    if capacity_factor == 4.0:
        np.testing.assert_allclose(_np(got[1].sum(dim=(1, 2))),
                                   np.ones(64), rtol=1e-5)
        assert int(got[2].sum()) == 2 * 64
    with pytest.raises(ValueError):
        sm.top2gating(torch.from_numpy(logits), 1.0, 1)


def test_used_token_masks_dispatch_as_in_jax():
    logits = _logits()
    used = np.array([1.0] * 16 + [0.0] * 16, np.float32)
    want = jsm.top1gating(jnp.asarray(logits), 4.0, 1,
                          used_token=jnp.asarray(used), use_rts=False)
    got = sm.top1gating(torch.from_numpy(logits), 4.0, 1,
                        used_token=torch.from_numpy(used), use_rts=False)
    _same_gating(got, want)
    assert int(got[2][16:].sum()) == 0
    assert int(got[3].sum()) <= 16


def test_capacity_is_jax_capacity():
    for args in [(32, 4, 1.0, 4), (7, 3, 1.5, 1), (100, 128, 1.0, 4),
                 (8192, 128, 2.0, 4)]:
        assert sm._capacity(*args) == jsm._capacity(*args)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _port_moe_state(params):
    """A flax ``MoE`` (or ``Experts``) params tree as the port's
    ``state_dict``: ``kernel [.., in, out]`` -> ``weight [.., out, in]``;
    the JAX layer's ``experts`` (a child of ``MoE`` itself) is the port's
    ``deepspeed_moe.experts``."""
    sd = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + [key])
                continue
            parts = list(path)
            if parts and parts[0] == "experts" and "deepspeed_moe" in params:
                parts = ["deepspeed_moe"] + parts
            a = torch.from_numpy(np.array(value))
            if key == "kernel":
                sd[".".join(parts + ["weight"])] = \
                    a.transpose(-1, -2).contiguous()
            else:
                sd[".".join(parts + [key])] = a

    walk(params, [])
    return sd


def _pair(k=1, use_residual=False, noisy=None, use_rts=True, E=4, M=8):
    """The JAX and the port ``MoE`` at one configuration, the port on the
    JAX layer's params."""
    kw = dict(num_experts=E, k=k, capacity_factor=2.0, min_capacity=1,
              use_residual=use_residual, noisy_gate_policy=noisy,
              use_rts=use_rts)
    jl = jmoe.MoE(hidden_size=M, expert=jmoe.ExpertMLP(
        hidden_size=M, intermediate_size=2 * M), **kw)
    x = np.random.RandomState(0).randn(2, 6, M).astype(np.float32)
    params = jl.init({"params": jax.random.PRNGKey(0),
                      "gating": jax.random.PRNGKey(1)}, jnp.asarray(x))
    pl = moe.MoE(M, moe.ExpertMLP(M, 2 * M), **kw)
    pl.load_state_dict(_port_moe_state(params["params"]), strict=True)
    return jl, params, pl, x


@pytest.mark.parametrize("k,use_residual,noisy", [
    (1, False, None), (1, True, None), (1, False, "Jitter"),
    (1, False, "RSample"), (2, False, None), (2, True, None)])
def test_moe_layer_forward_matches_jax(monkeypatch, k, use_residual, noisy):
    """Training-mode forward (RTS on for top-1): outputs, ``l_aux`` and
    ``exp_counts`` equal JAX's on its draws."""
    jl, params, pl, x = _pair(k, use_residual, noisy)
    rng = jax.random.PRNGKey(2)
    out_j, aux_j, counts_j = jl.apply(params, jnp.asarray(x),
                                      rngs={"gating": rng})
    gate_rng = _gate_rng(jl, params, rng)
    if k == 1:
        keys = _rts_keys(gate_rng, rsample=noisy == "RSample",
                         jitter=noisy == "Jitter")
    else:
        keys = [gate_rng]
    _JaxDraws(monkeypatch, keys)
    pl.deepspeed_moe.gate.generator = torch.Generator()
    out, aux, counts = pl(torch.from_numpy(x))
    assert out.shape == x.shape and counts.shape == (4,)
    np.testing.assert_allclose(_np(out), np.asarray(out_j), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=OUT_TOL)
    np.testing.assert_array_equal(_np(counts), np.asarray(counts_j))


def _gate_rng(jl, params, rng):
    """The key JAX's gate draws from inside ``MoE.apply(rngs={'gating':
    rng})``: ``make_rng('gating')`` at the gate's scope, read by running
    the layer with the gate's call recording it."""
    seen = []
    orig = jsm.TopKGate._gating_rng

    def record(self):
        key = orig(self)
        seen.append(key)
        return key

    jsm.TopKGate._gating_rng = record
    try:
        jl.apply(params, jnp.zeros((2, 6, jl.hidden_size)),
                 rngs={"gating": rng})
    finally:
        jsm.TopKGate._gating_rng = orig
    return seen[0]


def test_moe_eval_matches_jax_without_draws_for_top1():
    jl, params, pl, x = _pair(k=1)
    out_j, aux_j, counts_j = jl.apply(params, jnp.asarray(x),
                                      deterministic=True)
    out, aux, counts = pl(torch.from_numpy(x), deterministic=True)
    np.testing.assert_allclose(_np(out), np.asarray(out_j), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_array_equal(_np(counts), np.asarray(counts_j))


def test_eval_top2_draws_from_a_generator_seeded_zero():
    """Deliberate difference: in eval the port's top-2 Gumbel noise comes
    from ``torch.Generator().manual_seed(0)`` on every call (JAX:
    ``PRNGKey(0)``), so two eval calls agree and equal ``top2gating`` on
    such a generator."""
    _, _, pl, x = _pair(k=2)
    tokens = torch.from_numpy(x).reshape(-1, x.shape[-1])
    gate = pl.deepspeed_moe.gate
    first = gate(tokens, deterministic=True)
    second = gate(tokens, deterministic=True)
    logits = torch.nn.functional.linear(tokens, gate.wg.weight)
    want = sm.top2gating(logits, gate.eval_capacity_factor,
                         gate.min_capacity,
                         torch.Generator().manual_seed(0))
    for a, b, c in zip(first, second, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        gate(tokens)          # training-mode top-2 without a generator


def test_moe_forward_raises_without_a_generator_for_rts():
    _, _, pl, x = _pair(k=1)
    with pytest.raises(ValueError, match="Random Token Selection"):
        pl(torch.from_numpy(x))


def test_gate_refuses_k_above_two_and_ep_size_raises():
    with pytest.raises(ValueError, match="top-1 and top-2"):
        moe.TopKGate(8, 4, k=3)
    # deliberate difference: one device, no expert axis
    with pytest.raises(NotImplementedError, match="item 9"):
        moe.MoE(8, moe.ExpertMLP(8, 16), num_experts=4, ep_size=2)
    with pytest.raises(AssertionError):
        moe.MoE(8, moe.ExpertMLP(8, 16), noisy_gate_policy="Bogus")


def test_experts_are_independent_and_match_jax():
    jx = jmoe.Experts(expert=jmoe.ExpertMLP(hidden_size=4,
                                            intermediate_size=8),
                      num_experts=3)
    x = np.random.RandomState(2).randn(3, 5, 4).astype(np.float32)
    params = jx.init(jax.random.PRNGKey(0), jnp.asarray(x))
    px = moe.Experts(moe.ExpertMLP(4, 8), num_experts=3)
    # a fresh bank: distinct weights per expert, stacked on dim 0
    assert all(p.shape[0] == 3 for p in px.parameters())
    ones = px(torch.ones(3, 5, 4))
    assert not torch.allclose(ones[0], ones[1])
    px.load_state_dict(_port_moe_state(params["params"]), strict=True)
    np.testing.assert_allclose(
        _np(px(torch.from_numpy(x))),
        np.asarray(jx.apply(params, jnp.asarray(x))), rtol=OUT_TOL,
        atol=OUT_TOL)
    with pytest.raises(ValueError, match="leading expert dim"):
        px(torch.ones(2, 5, 4))


class _TupleExpert(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 4)

    def forward(self, x):
        return self.fc(x), "ignored"


def test_experts_keep_a_tuple_outputs_first_element():
    bank = moe.Experts(_TupleExpert(), num_experts=2)
    out = bank(torch.ones(2, 3, 4))
    w, b = bank.stacked.fc.weight, bank.stacked.fc.bias
    want = torch.stack([torch.ones(3, 4) @ w[e].T + b[e] for e in range(2)])
    torch.testing.assert_close(out, want)


# ---------------------------------------------------------------------------
# the parameter utilities
# ---------------------------------------------------------------------------

class _SimpleMoEModel(torch.nn.Module):
    """The port twin of ``tests/unit/simple_model.py``'s
    ``SimpleMoEModel``: linear, ReLU, MoE, linear, MSE + 0.01 aux."""

    def __init__(self, hidden_dim=16, num_experts=4, k=1, use_rts=True):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(hidden_dim, hidden_dim)
        self.MoE_0 = moe.MoE(hidden_dim, moe.ExpertMLP(hidden_dim,
                                                       hidden_dim * 2),
                             num_experts=num_experts, k=k,
                             capacity_factor=2.0, min_capacity=1,
                             use_rts=use_rts)
        self.Dense_1 = torch.nn.Linear(hidden_dim, 1)

    def forward(self, x, y):
        h = torch.relu(self.Dense_0(x))
        h, l_aux, _ = self.MoE_0(h)
        out = self.Dense_1(h)
        return ((out.squeeze(-1) - y) ** 2).mean() + 0.01 * l_aux


def test_moe_param_utils_label_as_jax():
    from tests.unit.simple_model import SimpleMoEModel, batch_of

    jm = SimpleMoEModel(hidden_dim=16, num_experts=4)
    b = batch_of(4)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "gating": jax.random.PRNGKey(1)},
                     jnp.asarray(b["x"]), jnp.asarray(b["y"]))["params"]
    want = {"/".join(str(getattr(k, "key", k)) for k in path): label
            for path, label in jax.tree_util.tree_leaves_with_path(
                jmoe.split_params_into_moe_groups(params))}
    got = moe.split_params_into_moe_groups(_SimpleMoEModel())
    assert sorted(v for v in got.values()) == sorted(want.values())
    assert {n for n, v in got.items() if v == "moe"} == {
        f"MoE_0.deepspeed_moe.experts.stacked.{m}.{a}"
        for m in ("fc1", "fc2") for a in ("weight", "bias")}
    for path in ("MoE_0/deepspeed_moe/experts/stacked/fc1/kernel",
                 "Dense_0/kernel", "MoE_0.deepspeed_moe.experts.stacked.fc1"
                 ".weight", "MoE_0.deepspeed_moe.gate.wg.weight"):
        assert moe.is_moe_param(path) == jmoe.is_moe_param(
            path.replace(".", "/"))
    x = torch.ones(3, 4)
    from deepspeed_tpu_torch.moe.utils import drop_tokens, gather_tokens
    assert gather_tokens(drop_tokens(x)) is x


# ---------------------------------------------------------------------------
# training through the engine
# ---------------------------------------------------------------------------

class _JaxMoENet(fnn.Module):
    """The JAX side of the training comparison: ``SimpleMoEModel`` with
    ``use_rts`` as a field (off: no draw, so both packages take the same
    steps)."""

    k: int = 1

    @fnn.compact
    def __call__(self, x, y):
        h = fnn.relu(fnn.Dense(16, name="Dense_0")(x))
        h, l_aux, _ = jmoe.MoE(hidden_size=16, expert=jmoe.ExpertMLP(
            hidden_size=16, intermediate_size=32), num_experts=4, k=self.k,
            capacity_factor=2.0, min_capacity=1, use_rts=False,
            name="MoE_0")(h, deterministic=self.k == 2)
        out = fnn.Dense(1, name="Dense_1")(h)
        return jnp.mean((out.squeeze(-1) - y) ** 2) + 0.01 * l_aux


class _DeterministicTop2(_SimpleMoEModel):
    def forward(self, x, y):
        h = torch.relu(self.Dense_0(x))
        h, l_aux, _ = self.MoE_0(h, deterministic=True)
        return ((self.Dense_1(h).squeeze(-1) - y) ** 2).mean() + \
            0.01 * l_aux


def _port_net_state(params):
    sd = {}
    for name in ("Dense_0", "Dense_1"):
        sd[f"{name}.weight"] = torch.from_numpy(
            np.array(params[name]["kernel"])).T.contiguous()
        sd[f"{name}.bias"] = torch.from_numpy(np.array(params[name]["bias"]))
    for name, t in _port_moe_state(params["MoE_0"]).items():
        sd[f"MoE_0.{name}"] = t
    return sd


@pytest.mark.parametrize("k", [1, 2])
def test_moe_model_trains_as_the_jax_engine(k):
    """Adam, fp32, 4 steps: without RTS (top-1) or in eval gating (top-2,
    the port's seeded-0 draw patched to JAX's ``PRNGKey(0)`` Gumbel) the
    two engines take the same steps: losses within 1e-4."""
    from tests.unit.simple_model import batch_of

    config = {"train_batch_size": 32, "steps_per_print": 0,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    saved = topology.get_mesh(), topology.get_topology()
    mesh = topology.build_mesh(devices=jax.devices()[:1])
    try:
        jm = _JaxMoENet(k=k)
        b = batch_of(2)
        params = jax.device_get(jm.init(
            {"params": jax.random.PRNGKey(0),
             "gating": jax.random.PRNGKey(1)},
            jnp.asarray(b["x"]), jnp.asarray(b["y"]))["params"])
        jeng, *_ = jds.initialize(model=jm, config=dict(config),
                                  model_parameters=params, mesh=mesh)
        net = (_DeterministicTop2 if k == 2 else _SimpleMoEModel)(
            k=k, use_rts=False)
        net.load_state_dict(_port_net_state(params), strict=True)
        peng, *_ = dt.initialize(model=net, config=dict(config),
                                 device="cpu")
        assert peng.gating_generator is not None
        assert net.MoE_0.deepspeed_moe.gate.generator is \
            peng.gating_generator
        gumbel = np.asarray(jsm.gumbel_rsample(jax.random.PRNGKey(0),
                                               (32, 4)))
        orig = sm.gumbel_rsample
        sm.gumbel_rsample = lambda g, shape, device=None: \
            torch.from_numpy(gumbel)
        try:
            for i in range(4):
                batch = batch_of(32, seed=i)
                want = float(jeng.train_batch(batch=batch))
                got = float(peng.train_batch(batch={
                    key: torch.from_numpy(np.asarray(v, np.float32))
                    for key, v in batch.items()}))
                np.testing.assert_allclose(got, want, rtol=TRAIN_TOL)
        finally:
            sm.gumbel_rsample = orig
    finally:
        topology.set_mesh(*saved)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_model_trains_with_the_engines_gating_generator(k):
    """RTS (top-1) and Gumbel top-2 draw from the engine's gating
    generator: the losses fall, and two engines on one seed take the same
    steps while another seed draws otherwise."""
    from tests.unit.simple_model import batch_of

    def run(seed):
        torch.manual_seed(0)
        net = _SimpleMoEModel(k=k)
        eng, *_ = dt.initialize(model=net, config={
            "train_batch_size": 32, "steps_per_print": 0, "seed": seed,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}},
            device="cpu")
        assert set_gating_generator(net, eng.gating_generator) == 1
        return [float(eng.train_batch(batch={
            key: torch.from_numpy(np.asarray(v, np.float32))
            for key, v in batch_of(32, seed=i).items()}))
            for i in range(15)]

    a, b, c = run(0), run(0), run(5)
    assert np.isfinite(a).all()
    assert np.mean(a[-3:]) < np.mean(a[:3]), a
    assert a == b and a != c


def test_the_moe_config_block_is_accepted_as_in_jax():
    for block in ({"replicate_tokens": True}, {"replicate_tokens": False},
                  {}):
        dt.DeepSpeedConfig({"train_batch_size": 2, "moe": block})
