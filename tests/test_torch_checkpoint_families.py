"""Checkpoints of the Mixtral and generic models across the two packages.

As ``tests/test_torch_checkpoint.py`` does for the Llama: one engine
trains 2 steps and saves, the other package's fresh engine (built on
other weights) loads the save, and both take the next step on the same
batch. JAX -> port: JAX ``save_checkpoint`` + ``convert_checkpoint``,
then the port's ``load_checkpoint(..., load_universal=True)``; port ->
JAX: the port's ``save_checkpoint``, then JAX ``load_checkpoint(<dir>/
<tag>, load_universal=True)``. Right after the load the two states hold
the same leaves (names, shapes, dtypes) with equal values, and the next
step's losses agree to 1e-6 (fp32). Cases: Mixtral (stacked expert
leaves ``[L, E, ...]``) on AdamW with scanned layers and on LAMB with
unscanned ones, and BERT MLM (``TransformerForMaskedLM``) on LAMB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu as ds
from deepspeed_tpu.checkpoint import universal as jax_universal
from deepspeed_tpu.models import layers as jlayers
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from deepspeed_tpu.parallel import topology
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint import universal
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.models import MixtralConfig, MixtralForCausalLM
from deepspeed_tpu_torch.models import layers as tlayers
from deepspeed_tpu_torch.models import transformer as tt
from tests.test_torch_train import BERT, _mlm_batches
from torch_threads import one_torch_thread  # noqa: F401

#: the next step's loss after a cross-package load (fp32)
LOSS_TOL = 1e-6
SAVED_AT = 2
BATCH, SEQ = 4, 16

_ADAMW = {"train_batch_size": BATCH, "steps_per_print": 0,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 3e-3, "weight_decay": 0.1}},
          "gradient_clipping": 1.0}
_LAMB = {"train_batch_size": BATCH, "steps_per_print": 0,
         "optimizer": {"type": "Lamb",
                       "params": {"lr": 3e-3, "weight_decay": 0.01}},
         "gradient_clipping": 0.05}

#: case -> (family, config overrides, engine config)
CASES = {
    "mixtral_adamw_scanned": ("mixtral", {"scan_layers": True}, _ADAMW),
    "mixtral_lamb_unscanned": ("mixtral", {"scan_layers": False}, _LAMB),
    "bert_mlm_lamb": ("bert", {}, _LAMB),
}


@pytest.fixture
def one_device_mesh():
    saved = topology.get_mesh(), topology.get_topology()
    mesh = topology.build_mesh(devices=jax.devices()[:1])
    yield mesh
    topology.set_mesh(*saved)


def _bert_losses():
    def jax_loss(p, batch, rng, model):
        logits = model.apply({"params": p}, batch["input_ids"],
                             batch["attention_mask"],
                             batch["token_type_ids"])
        return jlayers.cross_entropy_loss(logits, batch["labels"]), ()

    def port_loss(module, batch, generator):
        logits = module(batch["input_ids"], batch["attention_mask"],
                        batch["token_type_ids"])
        return tlayers.cross_entropy_loss(logits, batch["labels"]), ()

    return jax_loss, port_loss


def _engines(case, mesh, jax_seed, port_seed):
    """The JAX engine on seeded flax params and the port engine on
    another seed's (bridged), plus the case's batches."""
    family, over, config = CASES[case]
    if family == "mixtral":
        jmodel = JaxMixtral(JaxMixtralConfig.tiny(remat=False, **over))
        cfg = MixtralConfig.tiny(remat=False, **over)
        port_model = MixtralForCausalLM(cfg)
        rs = np.random.RandomState(0)
        batches = []
        for _ in range(SAVED_AT + 1):
            ids = rs.randint(0, cfg.vocab_size, (BATCH, SEQ)).astype(
                np.int32)
            batches.append({"input_ids": ids, "labels": ids})
        jkw, pkw = {}, {}
    else:
        jmodel = jt.TransformerForMaskedLM(jt.TransformerConfig(**BERT))
        cfg = tt.TransformerConfig(**BERT)
        port_model = tt.TransformerForMaskedLM(cfg)
        batches = _mlm_batches(cfg.vocab_size, n=SAVED_AT + 1)
        jax_loss, port_loss = _bert_losses()
        jkw = {"loss_fn": lambda p, b, r: jax_loss(p, b, r, jmodel)}
        pkw = {"loss_fn": port_loss}

    def params(seed):
        return jax.device_get(jax.jit(jmodel.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])

    jeng, *_ = ds.initialize(model=jmodel, config=dict(config),
                             model_parameters=params(jax_seed), mesh=mesh,
                             **jkw)
    peng, *_ = dt.initialize(
        model=port_model, config=dict(config),
        model_parameters=flax_to_torch_state_dict(params(port_seed), cfg),
        device="cpu", **pkw)
    return jeng, peng, batches


def _step(eng, batch):
    return float(eng.train_batch(batch=dict(batch)))


def _assert_same_state(jeng, peng, tmp_path):
    jax_universal.save_universal(jeng.state, str(tmp_path / "want"))
    peng.save_checkpoint(str(tmp_path / "got"), tag="now")
    want, _ = jax_universal.load_universal(str(tmp_path / "want"))
    got, _ = universal.load_universal(str(tmp_path / "got" / "now"))
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_jax_save_resumes_in_the_port(case, one_device_mesh, tmp_path):
    jeng, peng, batches = _engines(case, one_device_mesh, 0, 7)
    for batch in batches[:SAVED_AT]:
        _step(jeng, batch)
    jeng.save_checkpoint(str(tmp_path / "jax"))
    jax_universal.convert_checkpoint(str(tmp_path / "jax"),
                                     str(tmp_path / "universal"))
    _, client_state = peng.load_checkpoint(str(tmp_path / "universal"),
                                           load_universal=True)
    assert client_state["global_steps"] == SAVED_AT == peng.global_steps
    _assert_same_state(jeng, peng, tmp_path)
    want, got = _step(jeng, batches[SAVED_AT]), _step(peng,
                                                      batches[SAVED_AT])
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_port_save_resumes_in_the_jax_engine(case, one_device_mesh,
                                               tmp_path):
    jeng, peng, batches = _engines(case, one_device_mesh, 3, 0)
    for batch in batches[:SAVED_AT]:
        _step(peng, batch)
    peng.save_checkpoint(str(tmp_path))
    _, client_state = jeng.load_checkpoint(
        str(tmp_path / f"global_step{SAVED_AT}"), load_universal=True)
    assert client_state["global_steps"] == SAVED_AT == jeng.global_steps
    _assert_same_state(jeng, peng, tmp_path)
    want, got = _step(jeng, batches[SAVED_AT]), _step(peng,
                                                      batches[SAVED_AT])
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
