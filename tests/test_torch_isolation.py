"""The PyTorch port stands alone.

``deepspeed_tpu_torch`` and ``chip_smoke.py`` import neither JAX, flax,
optax nor pydantic, and nothing of the JAX package (checked on the source
with ``ast``: the test process itself imports JAX, so ``sys.modules``
proves nothing). The card's machine has none of them installed. Its entry points
run on CUDA unless the caller asks for the CPU, and its kernel wrapper
raises instead of falling back when it cannot serve a call.
"""

import ast
import os

import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.inference import engine as engine_mod
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.ragged_attention import ragged_paged_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "flax", "optax", "pydantic", "deepspeed_tpu"}


def _port_sources():
    pkg = os.path.join(ROOT, "deepspeed_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = list(_port_sources())
    assert len(files) > 15
    bad = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f))
                                            & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}
    # the training subset's host modules, the module-injection slice, the
    # serving engine's drafter and host KV tier, the generic transformer,
    # its layer, the legacy quantization, Mixtral, the MoE layer, the host
    # ops, the pipeline container and engine, ZeRO-Offload and
    # ZeRO-Infinity are among the files checked
    for mod in ("checkpointing.py", "runtime/dataloader.py",
                "models/mixtral.py", "moe/__init__.py", "moe/experts.py",
                "moe/layer.py", "moe/sharded_moe.py", "moe/utils.py",
                "version.py",
                "inference/serving/speculative.py",
                "inference/serving/kv_tiers.py",
                "runtime/progressive_layer_drop.py", "monitor/monitor.py",
                "models/gpt2.py", "module_inject/replace_policy.py",
                "module_inject/replace_module.py", "models/transformer.py",
                "ops/transformer.py", "compression/__init__.py",
                "compression/quantization.py", "ops/_host.py",
                "ops/adam/cpu_adam.py", "ops/adagrad/cpu_adagrad.py",
                "ops/aio/handle.py", "pipe/module.py", "pipe/schedule.py",
                "pipe/engine.py", "runtime/zero/offload.py",
                "runtime/zero/infinity.py"):
        assert os.path.join("deepspeed_tpu_torch", mod) in bad, mod
    # the exact-name rule: the port's own name starts with the JAX
    # package's and must not trip it
    assert "deepspeed_tpu_torch" not in FORBIDDEN


def _tiny():
    model = LlamaForCausalLM(LlamaConfig.tiny())
    return model, model.init_params(seed=0)


def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, params = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dt.init_inference(model, params=params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dt.init_serving(model, params=params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_mod.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dt.initialize(model=model, config={"train_batch_size": 2})
    srv = dt.init_serving(model, params=params, device="cpu",
                          serving_config=dt.ServingConfig(
                              block_size=8, num_blocks=8, max_model_len=32))
    assert srv.device.type == "cpu" and srv.pool["k"].device.type == "cpu"


def test_offload_pipeline_and_infinity_engines_need_cuda_unless_cpu(
        monkeypatch):
    """ZeRO-Offload, the one-stage ``PipelineEngine`` and the
    ``ZeroInfinityEngine`` run on the card unless ``device="cpu"``."""
    from deepspeed_tpu_torch.models.layers import cross_entropy_loss
    from deepspeed_tpu_torch.pipe import LayerSpec, PipelineModule
    from torch_pipe_twins import Block, EmbedIn, HeadOut

    def module():
        return PipelineModule([LayerSpec(EmbedIn, 16, 8),
                               *[LayerSpec(Block, 8) for _ in range(2)],
                               LayerSpec(HeadOut, 16, 8)],
                              num_stages=1, loss_fn=cross_entropy_loss)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = {"train_batch_size": 2, "optimizer": {"type": "AdamW"}}
    offload = dict(base, zero_optimization={
        "stage": 2, "offload_optimizer": {"device": "cpu"}})
    stream = dict(base, zero_optimization={
        "offload_param": {"device": "cpu", "block_layers": 1}})
    for model, config in ((_tiny()[0], offload), (module(), base),
                          (module(), stream)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dt.initialize(model=model, config=config)
    engine, *_ = dt.initialize(model=module(), config=stream, device="cpu")
    assert type(engine).__name__ == "ZeroInfinityEngine"
    assert engine.device.type == "cpu"


def test_kernel_wrapper_raises_instead_of_falling_back(monkeypatch, tmp_path):
    def args(dev):
        f = dict(device=dev)
        return (torch.zeros(4, 8, 64, **f), torch.zeros(6, 2, 16, 64, **f),
                torch.zeros(6, 2, 16, 64, **f),
                torch.zeros(2, 3, dtype=torch.int32, **f),
                *(torch.zeros(2, dtype=torch.int32, **f) for _ in range(4)))

    before = ragged_paged_attention.launches
    # a device that is neither cuda nor cpu
    with pytest.raises(ValueError, match="not on meta"):
        ragged_paged_attention(*args("meta"))
    # tensors on two devices
    mixed = list(args("cpu"))
    mixed[1] = mixed[1].to("meta")
    with pytest.raises(ValueError, match="every tensor must be on"):
        ragged_paged_attention(*mixed)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        ragged_paged_attention(*args("cpu"), k_scale=torch.zeros(6, 2, 16))
    assert ragged_paged_attention.launches == before
    # no nvcc: building the kernel raises, it does not fall back
    monkeypatch.setattr(_build, "BUILD", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["ragged_attention"])


def test_build_target_changes_with_a_shared_header(monkeypatch, tmp_path):
    """A kernel's library name is a digest of its source and of every
    ``csrc/*.cuh`` header, so an edited header never loads a stale build
    (no nvcc needed: only the name is computed)."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// first\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(build))
    assert _build.sources() == ["kern"]
    names = [_build._target("kern")]
    (csrc / "shared.cuh").write_text("// second\n")
    names.append(_build._target("kern"))
    (csrc / "kern.cu").write_text('#include "shared.cuh"\n// edited\n')
    names.append(_build._target("kern"))
    (csrc / "other.cuh").write_text("// a new header\n")
    names.append(_build._target("kern"))
    assert len(set(names)) == 4
    assert all(os.path.dirname(n) == str(build) for n in names)
    (csrc / "other.cuh").unlink()
    assert _build._target("kern") == names[2]
