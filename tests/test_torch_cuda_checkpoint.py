"""Checkpoints of the port's captured training step on the card.

Marked ``cuda``: each test skips (with the reason) where no CUDA device is
present. On a machine with one, run them with
``python -m pytest --noconftest tests/test_torch_cuda_checkpoint.py -m cuda``.

- A captured engine (one CUDA graph, its first step taken) loads a save
  of another engine in place: every tensor the graph reads keeps its
  address (masters, gradients, moments, count, loss scale, skip count;
  K3's table is the same object), no graph is recaptured, the replays
  run K3 once each (counted on the device), and the losses, counts and
  masters continue bit for bit as the run that never stopped — in bf16
  and in fp16 through overflow skips.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

#: chip_smoke.py's small training model: 2 layers, 4 heads of 64, MHA
SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, max_position_embeddings=256)
BATCH, SEQ = 4, 128

PRECISIONS = {
    "bf16": {"bf16": {"enabled": True}},
    # 2**24 overflows the first steps' fp16 backward; hysteresis 1 halves
    # the scale each time until the steps train
    "fp16": {"fp16": {"enabled": True, "initial_scale_power": 24,
                      "hysteresis": 1, "loss_scale_window": 3}},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _engine(precision, seed):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    config = {"train_batch_size": BATCH,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.1}},
              "scheduler": {"type": "WarmupDecayLR",
                            "params": {"warmup_min_lr": 1e-4,
                                       "warmup_max_lr": 1e-3,
                                       "warmup_num_steps": 3,
                                       "total_num_steps": 12}},
              "gradient_clipping": 1.0, "steps_per_print": 0, "seed": seed,
              **PRECISIONS[precision]}
    engine, *_ = dt.initialize(model=LlamaForCausalLM(LlamaConfig(**SMALL)),
                               config=config, device="cuda")
    return engine


def _batches(n, device):
    rs = np.random.RandomState(1)
    return [{"input_ids": ids, "labels": ids} for ids in (
        torch.from_numpy(rs.randint(0, SMALL["vocab_size"], (BATCH, SEQ)))
        .to(device) for _ in range(n))]


def _tensors(engine):
    opt = engine.optimizer
    out = [opt.count, engine._skipped] + list(engine.master.values()) + \
        engine._grads + opt.exp_avg + opt.exp_avg_sq
    if engine.loss_scaler is not None:
        s = engine.loss_scaler
        out += [s.cur_scale, s.cur_iter, s.cur_hysteresis]
    return out


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_a_captured_engine_loads_in_place_and_continues_bitwise(
        cuda, precision, tmp_path):
    from deepspeed_tpu_torch.ops import _runs

    batches = _batches(8, cuda)
    a = _engine(precision, seed=0)
    want = []
    for i, x in enumerate(batches):
        want.append(a.train_batch(batch=x))
        if i == 3:
            a.save_checkpoint(str(tmp_path))
    want = [float(x) for x in want]

    b = _engine(precision, seed=5)
    b.train_batch(batch=batches[0])
    assert len(b._graphs) == 1
    entry = next(iter(b._graphs.values()))
    ptrs = [t.data_ptr() for t in _tensors(b)]
    table = b.optimizer.table
    b.load_checkpoint(str(tmp_path))
    assert [t.data_ptr() for t in _tensors(b)] == ptrs
    assert b.optimizer.table is table
    assert b.global_steps == 4
    torch.cuda.synchronize()
    _runs.reset_kernel_runs("fused_adam")
    got = [float(b.train_batch(batch=x)) for x in batches[4:]]
    torch.cuda.synchronize()
    assert _runs.kernel_runs("fused_adam") == len(batches) - 4
    assert len(b._graphs) == 1 and \
        next(iter(b._graphs.values())) is entry, "recaptured"
    assert got == want[4:]
    assert (int(b.optimizer.count), b.get_skipped_steps(), b.loss_scale,
            b.get_lr()) == (int(a.optimizer.count), a.get_skipped_steps(),
                            a.loss_scale, a.get_lr())
    for name, p in a.module_state_dict().items():
        assert torch.equal(b.module_state_dict()[name], p), name
    if precision == "fp16":
        assert a.get_skipped_steps() > 0
