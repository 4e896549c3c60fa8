"""The port's device-resident training step on the card.

Marked ``cuda``: each test skips (with the reason) where no CUDA device is
present. On a machine with one, run them with
``python -m pytest tests/test_torch_cuda_train.py -m cuda``.

- bf16, fp16 and fp32 steps of a small Llama, uncaptured and replayed,
  run under ``torch.cuda.set_sync_debug_mode("error")``: nothing in a
  step reads back to the host (the first step of an engine builds K3's
  table and, captured, the graph, which do);
- ten captured steps give bit-identical losses, norms, skip counts, loss
  scales and masters to ten uncaptured ones from the same weights; on a
  difference the message names each kernel of the step (K1, K2 dQ, K2
  dK/dV, K3, the cuBLAS product) whose output differs between an eager
  run and a graph replay on the same inputs;
- a captured step keeps K3's table: twenty other tables built and
  dropped between replays leave ten captured steps bit-identical to ten
  uncaptured ones;
- K3 with ``skip`` set replays in a graph and leaves its buffers
  bit-identical; with it clear the same graph moves them, reading the
  scalars of ``alpha`` from device memory at each replay;
- K1, K2 and K3 count their runs on the device: an uncaptured step's
  counts equal its wrappers' launches, and each replay of a captured step
  adds the same counts (the capture adds none), skipped steps included.
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
    "fp32": {},
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


def _engine(precision, graphed, gas=1):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    config = {"train_batch_size": BATCH, "gradient_accumulation_steps": gas,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.1}},
              "scheduler": {"type": "WarmupDecayLR",
                            "params": {"warmup_min_lr": 1e-4,
                                       "warmup_max_lr": 1e-3,
                                       "warmup_num_steps": 3,
                                       "total_num_steps": 12}},
              "gradient_clipping": 1.0, "steps_per_print": 0, "seed": 0,
              **PRECISIONS[precision]}
    engine, *_ = dt.initialize(model=LlamaForCausalLM(LlamaConfig(**SMALL)),
                               config=config, device="cuda",
                               cuda_graph=graphed)
    return engine


def _batches(n, device):
    rs = np.random.RandomState(1)
    return [{"input_ids": ids, "labels": ids} for ids in (
        torch.from_numpy(rs.randint(0, SMALL["vocab_size"], (BATCH, SEQ)))
        .to(device) for _ in range(n))]


@pytest.mark.parametrize("graphed", [False, True],
                         ids=["uncaptured", "captured"])
@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_train_step_reads_nothing_back(cuda, precision, graphed):
    engine = _engine(precision, graphed)
    batches = _batches(6, cuda)
    losses = [engine.train_batch(batch=b) for b in batches[:2]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses += [engine.train_batch(batch=b) for b in batches[2:]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(np.isfinite(float(x)) for x in losses)
    assert len(engine._graphs) == int(graphed)
    assert engine.global_steps == 6


def _replayed(fn):
    """``fn()``'s outputs from an eager run and from a CUDA graph replay,
    on the same inputs (``fn`` rebuilds them from a seed)."""
    eager = [t.clone() for t in fn()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    graph.replay()
    torch.cuda.synchronize()
    return eager, [t.clone() for t in outs]


def _kernels_that_differ(device):
    """The step's kernels whose outputs differ between an eager run and a
    graph replay on the same inputs, at the small model's shapes."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam

    g = torch.Generator(device=device).manual_seed(0)
    H, D = SMALL["num_attention_heads"], 64
    q, k, v, do = (torch.randn(BATCH, SEQ, H, D, generator=g, device=device,
                               dtype=torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, True, D ** -0.5, None)
    a = torch.randn(BATCH * SEQ, 256, generator=g, device=device)
    w = torch.randn(256, 512, generator=g, device=device)
    shapes = [(512, 256), (256,), (70001,)]
    state = [[torch.randn(s, generator=g, device=device) for s in shapes]
             for _ in range(4)]
    for t in state[3]:
        t.abs_()
    alpha = torch.tensor([1e-3, 1e-3, 1.0], device=device)
    work = [[t.clone() for t in lst] for lst in state]
    table = fused_adam(*work, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1,
                       adam_w_mode=True, alpha=alpha)

    def adam():
        for lst, src in zip(work, state):
            for t, s in zip(lst, src):
                t.copy_(s)
        fused_adam(*work, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1,
                   adam_w_mode=True, alpha=alpha, table=table)
        return [t for lst in work for t in lst]

    cases = {
        "K1 flash_attention_fwd": lambda: fa.flash_attention_fwd(
            q, k, v, True, D ** -0.5, None),
        "K2 flash_attention_bwd_dq": lambda: [fa.flash_attention_bwd_dq(
            q, k, v, out, lse, do, True, D ** -0.5, None)],
        "K2 flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, out, lse, do, True, D ** -0.5, None),
        "K3 fused_adam": adam,
        "cuBLAS matmul": lambda: [a @ w],
    }
    differ = []
    for name, fn in cases.items():
        eager, replayed = _replayed(fn)
        if not all(torch.equal(x, y) for x, y in zip(eager, replayed)):
            differ.append(name)
    return differ


@pytest.mark.parametrize("precision,gas", [("bf16", 1), ("bf16", 2),
                                           ("fp32", 1), ("fp16", 1)],
                         ids=["bf16", "bf16_gas2", "fp32", "fp16"])
def test_captured_steps_repeat_the_uncaptured_ones(cuda, precision, gas):
    """Ten steps on each route from the same weights and batches: losses,
    norms, skip counts, loss scales and masters bit for bit; one graph
    for the one batch shape; a returned loss is a copy that a later
    replay does not overwrite."""
    batches = _batches(10, cuda)
    runs = {}
    for graphed in (False, True):
        engine = _engine(precision, graphed, gas)
        trace = []
        for b in batches:
            loss = engine.train_batch(batch=b)
            trace.append((float(loss), engine.get_global_grad_norm(),
                          engine.get_skipped_steps(), engine.loss_scale,
                          engine.get_lr()[0]))
        runs[graphed] = (trace, engine.module_state_dict(), engine)
    (want, want_p, _), (got, got_p, engine) = runs[False], runs[True]
    same = got == want and all(torch.equal(got_p[n], p)
                               for n, p in want_p.items())
    if not same:
        step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
            if got != want else None
        raise AssertionError(
            f"captured and uncaptured steps differ (first at step {step}; "
            f"kernels whose graph replay differs from their eager run: "
            f"{_kernels_that_differ(cuda) or 'none'}): {got} vs {want}")
    assert len(engine._graphs) == 1
    if precision == "fp16":
        assert want[-1][2] > 0, "the fp16 case overflows"
    first = engine.train_batch(batch=batches[0])
    kept = first.clone()
    second = engine.train_batch(batch=batches[1])
    assert first.data_ptr() != second.data_ptr()
    assert torch.equal(first, kept)


def test_a_captured_step_keeps_its_adam_table(cuda):
    """A replay reads K3's table by address. Twenty other tables of the
    same size, built over lists that are all alive at once and then
    dropped, go through the allocator between the steps; the captured
    engine still repeats the uncaptured one bit for bit."""
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam

    batches = _batches(10, cuda)
    runs = {}
    for graphed in (False, True):
        engine = _engine("bf16", graphed)
        alpha = torch.tensor([1e-3, 1e-3, 1.0], device=cuda)
        losses = []
        for i, b in enumerate(batches):
            losses.append(float(engine.train_batch(batch=b)))
            if i in (0, 4):
                others = [[[torch.zeros_like(t) for t in engine._trainable]
                           for _ in range(4)] for _ in range(20)]
                for lists in others:
                    fused_adam(*lists, b1=0.9, b2=0.999, eps=1e-8,
                               weight_decay=0.0, adam_w_mode=True,
                               alpha=alpha)
                del others
        runs[graphed] = (losses, engine.module_state_dict())
        assert len(engine._graphs) == int(graphed)
    (want, want_p), (got, got_p) = runs[False], runs[True]
    assert got == want
    assert all(torch.equal(got_p[n], p) for n, p in want_p.items())


def test_skipped_fused_adam_replays_in_a_graph(cuda):
    """K3 captured once over device ``alpha`` and ``skip``: with the flag
    set a replay leaves params and moments bit-identical; cleared, the
    same graph applies the step that the eager kernel applies with the
    ``alpha`` written before the replay."""
    from deepspeed_tpu_torch.ops._runs import kernel_runs, reset_kernel_runs
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam

    g = torch.Generator(device=cuda).manual_seed(2)
    shapes = [(3,), (1000, 7), (70001,)]
    state = [[torch.randn(s, generator=g, device=cuda) for s in shapes]
             for _ in range(4)]
    for t in state[3]:
        t.abs_()
    alpha = torch.tensor([1e-3, 1e-3, 1.0], device=cuda)
    skip = torch.tensor(False, device=cuda)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1,
              adam_w_mode=True, alpha=alpha, skip=skip)
    ref = [[t.clone() for t in lst] for lst in state]
    reset_kernel_runs("fused_adam")
    table = fused_adam(*state, **kw)    # eager: builds the table
    fused_adam(*ref, **dict(kw, skip=None))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fused_adam(*state, **kw, table=table)
    assert kernel_runs("fused_adam") == 2, "the capture runs nothing"
    skip.fill_(True)
    kept = [[t.clone() for t in lst] for lst in state]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for lst, old in zip(state, kept)
               for a, b in zip(lst, old))
    assert kernel_runs("fused_adam") == 3, "a skipped replay counts"
    skip.fill_(False)
    alpha.copy_(torch.tensor([2e-3, 1e-3, 1.0007], device=cuda))
    graph.replay()
    fused_adam(*ref, **dict(kw, skip=None))
    torch.cuda.synchronize()
    for lst, want in zip(state, ref):
        for a, b in zip(lst, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("precision", ["bf16", "fp16"])
def test_each_replay_runs_the_step_kernels_once(cuda, precision):
    """The kernels' device counts: one uncaptured step runs K1, K2 and K3
    as often as their wrappers launch them; a captured engine adds nothing
    at capture and exactly those counts at each of three replays (the fp16
    case skips its first steps, and a skipped K3 still runs)."""
    from deepspeed_tpu_torch.ops import _runs
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam

    wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "fused_adam": fused_adam}

    def counted(engine, batches):
        for name, fn in wrappers.items():
            _runs.reset_kernel_runs(name)
            fn.launches = 0
        for b in batches:
            engine.train_batch(batch=b)
        torch.cuda.synchronize()
        return ({n: _runs.kernel_runs(n) for n in wrappers},
                {n: fn.launches for n, fn in wrappers.items()})

    batches = _batches(4, cuda)
    eager = _engine(precision, False)
    runs, launches = counted(eager, batches[:1])
    L = SMALL["num_hidden_layers"]
    assert runs == launches and runs["fused_adam"] == 1 \
        and runs["flash_attention_bwd_dq"] == L, runs
    graphed = _engine(precision, True)
    first, _ = counted(graphed, batches[:1])     # eager, then the capture
    assert first == runs, "the capture ran the step's kernels"
    replays, _ = counted(graphed, batches[1:4])
    assert replays == {n: 3 * c for n, c in runs.items()}, replays
