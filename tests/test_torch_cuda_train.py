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
  adds the same counts (the capture adds none), skipped steps included;
- the rest of the training subset: selective checkpointing under each
  remat policy (the offload policy over pinned host buffers that its
  eager first step allocates and every replay reuses), the chunked loss
  and a padded batch, captured, repeat the uncaptured steps bit for bit;
  the chunked loss on bf16 operands keeps its logits in fp32 (value and
  gradients against fp64, at limits that bf16-rounded logits miss);
  the offload stash raises in a capture that would allocate; PLD's
  generator advances at each replay (theta on the device count, gates
  that change, as an uncaptured engine draws them); a client optimizer
  that is not capturable is refused under ``cuda_graph``, a capturable
  one trains captured.
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


# ---------------------------------------------------------------------------
# the rest of the training subset: remat policies, the chunked loss,
# padded batches, PLD, a client optimizer
# ---------------------------------------------------------------------------

def _subset_engine(graphed, model_over=None, seed=0, **config_over):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    config = {"train_batch_size": BATCH, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.1}},
              "gradient_clipping": 1.0, "steps_per_print": 0, "seed": seed,
              "bf16": {"enabled": True}, **config_over}
    cfg = LlamaConfig(**SMALL, **(model_over or {}))
    engine, *_ = dt.initialize(model=LlamaForCausalLM(cfg), config=config,
                               device="cuda", cuda_graph=graphed)
    return engine


def _padded_batches(n, device, pad):
    rs = np.random.RandomState(2)
    out = []
    for _ in range(n):
        ids = torch.from_numpy(rs.randint(0, SMALL["vocab_size"],
                                          (BATCH, SEQ)))
        mask = torch.ones_like(ids)
        if pad:
            lengths = torch.from_numpy(rs.randint(SEQ // 2, SEQ + 1, BATCH))
            mask = (torch.arange(SEQ)[None] < lengths[:, None]).long()
        b = {"input_ids": ids, "labels": torch.where(mask > 0, ids, -100)}
        if pad:
            b["attention_mask"] = mask
        out.append({k: v.to(device) for k, v in b.items()})
    return out


SUBSET_ROUTES = {
    "dots": ({"remat_policy": "dots"}, False),
    "dots_no_batch_chunked": ({"remat_policy": "dots_no_batch",
                               "loss_chunk": 128}, False),
    "offload_chunked": ({"remat_policy": "offload_dots_no_batch",
                         "loss_chunk": 128}, False),
    "padded_dots": ({"remat_policy": "dots"}, True),
}


@pytest.mark.parametrize("route", sorted(SUBSET_ROUTES))
def test_selective_checkpointing_replays_the_uncaptured_steps(cuda, route):
    """Each remat policy (the offload one over its host stash, whose
    pinned buffers the eager first step allocates and every replay reuses),
    the chunked loss and a padded batch: six captured steps give the
    losses, norms and masters of six uncaptured ones, bit for bit."""
    over, pad = SUBSET_ROUTES[route]
    batches = _padded_batches(6, cuda, pad)
    runs = {}
    for graphed in (False, True):
        eng = _subset_engine(graphed, over)
        out = [(eng.train_batch(batch=b), eng._last_grad_norm)
               for b in batches]
        runs[graphed] = ([(float(a), float(n)) for a, n in out],
                         {k: v.clone() for k, v in
                          eng.module_state_dict().items()}, eng)
    assert runs[True][0] == runs[False][0]
    for name, p in runs[False][1].items():
        assert torch.equal(runs[True][1][name], p), name
    eng = runs[True][2]
    assert len(eng._graphs) == 1
    if over["remat_policy"].startswith("offload"):
        stashes = eng.module.model._stashes
        assert all(len(s.buffers) == 7 for s in stashes)
        assert all(b.is_pinned() for s in stashes
                   for b in s.buffers.values())


def _nll64(hidden, w, labels, round_logits):
    """The token-mean NLL of ``hidden @ w`` in fp64 (the logits rounded to
    bf16 with ``round_logits``, the gradient passing straight through),
    its value and gradients."""
    h = hidden.double().reshape(-1, hidden.shape[-1]).requires_grad_(True)
    wd = w.double().requires_grad_(True)
    logits = h @ wd
    if round_logits:
        logits = logits + (logits.bfloat16().double() - logits).detach()
    ys = labels.reshape(-1)
    mask = ys != -100
    gold = logits.gather(-1, torch.where(mask, ys, 0)[:, None])[:, 0]
    loss = ((torch.logsumexp(logits, -1) - gold) * mask).sum() / mask.sum()
    gh, gw = torch.autograd.grad(loss, (h, wd))
    return float(loss), gh.reshape(hidden.shape), gw


def test_chunked_loss_accumulates_bf16_logits_in_fp32(cuda):
    """bf16 operands, 600 tokens in chunks of 256 (a ragged tail), every
    seventh label ignored, logits of magnitude ~16: the value within 1e-4
    of the fp64 loss of the same bf16 operands, each gradient within 4e-3
    of fp64's in relative norm (its own bf16 rounding is ~2e-3). Logits
    rounded to bf16 before the softmax miss both limits (the check below
    holds the limits to that)."""
    from deepspeed_tpu_torch.models.layers import chunked_cross_entropy_loss

    rs = np.random.RandomState(0)
    n, h, v = 600, 256, 4000
    hidden = torch.from_numpy(rs.randn(1, n, h).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w = torch.from_numpy(rs.randn(h, v).astype(np.float32)).to(
        cuda, torch.bfloat16)
    labels = torch.from_numpy(rs.randint(0, v, (1, n))).to(cuda)
    labels[0, ::7] = -100
    hh = hidden.clone().requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    loss = chunked_cross_entropy_loss(hh, ww, labels, chunk=256)
    gh, gw = torch.autograd.grad(loss, (hh, ww))
    assert loss.dtype == torch.float32
    assert gh.dtype == gw.dtype == torch.bfloat16

    def errors(value, grads, ref):
        return (abs(value - ref[0]),
                *(float((g.double() - r).norm() / r.norm())
                  for g, r in zip(grads, ref[1:])))

    ref = _nll64(hidden, w, labels, False)
    rounded = _nll64(hidden, w, labels, True)
    ours = errors(float(loss), (gh, gw), ref)
    worse = errors(rounded[0], rounded[1:], ref)
    limits = (1e-4, 4e-3, 4e-3)
    assert all(e <= lim for e, lim in zip(ours, limits)), ours
    assert all(e > lim for e, lim in zip(worse, limits)), worse


def test_offload_stash_raises_when_a_capture_would_allocate(cuda):
    """A capture with no eager step of its shape before it finds no host
    buffer and raises, naming ``cuda_graph=False``."""
    from deepspeed_tpu_torch.models import layers

    stash = layers.HostStash()
    x = torch.ones(4, 4, device=cuda)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="cuda_graph=False"):
        with torch.cuda.graph(graph):
            stash.slot(0, x)


def test_pld_generator_advances_each_replay(cuda):
    """Twelve replays at theta 0.5, gamma 0.5: theta follows the device
    count, the gate vectors differ between replays and equal an
    uncaptured engine's on the same generator seed."""
    import math

    pld = {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                      "gamma": 0.5}}
    batch = _padded_batches(1, cuda, False)[0]
    runs = {}
    for graphed in (False, True):
        eng = _subset_engine(graphed, seed=3, **pld)
        thetas, gates = [], []
        for _ in range(12):
            eng.train_batch(batch=batch)
            thetas.append(float(eng.pld_theta))
            gates.append(eng.module.model.last_pld_gates.float().cpu())
        runs[graphed] = (thetas, torch.stack(gates))
    for step, theta in enumerate(runs[True][0]):
        assert abs(theta - (0.5 * math.exp(-0.5 * step) + 0.5)) < 1e-6
    gates = runs[True][1]
    assert len({tuple(g.tolist()) for g in gates[4:]}) > 1
    assert torch.equal(gates, runs[False][1])


def test_non_capturable_client_optimizer_raises_under_capture(cuda):
    import deepspeed_tpu_torch as dt

    model = torch.nn.Linear(8, 1)

    class Wrapped(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = model

        def forward(self, x, y):
            return ((self.lin(x.to(self.lin.weight.dtype)).squeeze(-1).float()
                     - y) ** 2).mean()

    net = Wrapped()
    with pytest.raises(ValueError, match="capturable"):
        dt.initialize(model=net, config={"train_batch_size": 4},
                      optimizer=torch.optim.AdamW(net.parameters()),
                      device="cuda")
    eng, opt, _, _ = dt.initialize(
        model=net, config={"train_batch_size": 4, "steps_per_print": 0},
        optimizer=torch.optim.AdamW(net.parameters(), capturable=True),
        device="cuda")
    x, y = torch.randn(4, 8, device=cuda), torch.randn(4, device=cuda)
    losses = [float(eng.train_batch(batch={"x": x, "y": y}))
              for _ in range(4)]
    assert len(eng._graphs) == 1 and int(eng.step_count) == 4
    assert losses[-1] < losses[0]
