"""The port's top-level API against the JAX package's
(``deepspeed_tpu/__init__.py``): ``add_config_arguments`` adds the same
arguments to a parser, and every name the JAX package exports that the
port has ported resolves (``zero``, ``pipe``, ``init_distributed`` and
the pipeline classes come with later slices)."""

import argparse

import pytest

import deepspeed_tpu as jds
import deepspeed_tpu_torch as dt

#: JAX exports the port does not have yet (ROADMAP.md Queue 1, items 9
#: and 10)
LATER = {"zero", "pipe", "init_distributed", "PipelineEngine",
         "PipelineModule", "comm", "parallel"}


def _actions(package):
    parser = argparse.ArgumentParser()
    package.add_config_arguments(parser)
    return [(a.dest, a.option_strings, a.default, a.type, a.help,
             type(a).__name__) for a in parser._actions]


def test_add_config_arguments_matches_jax():
    assert _actions(dt) == _actions(jds)
    parser = dt.add_config_arguments(argparse.ArgumentParser())
    args = parser.parse_args(["--deepspeed", "--deepspeed_config", "c.json"])
    assert args.deepspeed and args.deepspeed_config == "c.json"
    assert dt.argparse_suppress() == jds.argparse_suppress() == \
        argparse.SUPPRESS


@pytest.mark.parametrize("name", sorted(set(dir(jds)) - LATER - {
    n for n in dir(jds) if n.startswith("_") and n != "__version__"}))
def test_each_exported_name_resolves(name):
    assert getattr(dt, name) is not None
    if name in ("moe", "module_inject", "ops", "checkpointing"):
        assert getattr(dt, name).__name__ == f"deepspeed_tpu_torch.{name}"


def test_version_logger_and_inference_engine_state_dict():
    import torch

    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    assert dt.__version__ == jds.__version__
    assert dt.logger.name == "deepspeed_tpu_torch"
    assert issubclass(dt.RejectedError, Exception)
    model = LlamaForCausalLM(LlamaConfig.tiny())
    params = model.init_params()
    eng = dt.init_inference(model, params=params, dtype="fp32",
                            device="cpu")
    assert isinstance(eng, dt.InferenceEngine)
    got = eng.module_state_dict()
    assert set(got) == set(params)
    for name, t in params.items():
        assert torch.equal(got[name], t)
