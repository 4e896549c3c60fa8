"""The port's verified-save protocol, fault helpers, reshape and tracer
against the JAX package's.

- The manifest protocol on the port's ``save_train_state`` /
  ``load_train_state``, as ``tests/unit/test_fault_tolerance.py`` checks
  the JAX one: a verified manifest and an atomic ``latest``; a tampered
  file fails verification; a corrupt manifest, a truncated or a missing
  ``latest`` walk back to the previous verified save; an explicit bad tag
  raises; a partial save is invisible to a resume; nothing loadable
  raises; retention never deletes the newest verified save; ``fsck``;
  ``flaky_save`` retries (and gives up past its bound); the
  ``corrupt_manifest`` and ``truncate_latest`` chaos points; and
  ``crash_during_save`` in both phases, in a subprocess. The training
  engine walks back the same way.
- Both packages' ``resolve_load_tag`` pick the same tag (or both raise)
  on the same damaged directories.
- The four fault helpers added for checkpoints do to a file what JAX's
  do under the same specs, ``p=`` draws included.
- ``reshape`` equals JAX's on seeded arrays.
- ``DS_TRACE_DIR``: a verify failure with no fallback leaves one flight
  dump; a traced save records a ``checkpoint_save`` span.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint import manifest as JM
from deepspeed_tpu.checkpoint import reshape as JR
from deepspeed_tpu.utils import fault_injection as JFI
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint import manifest as M
from deepspeed_tpu_torch.checkpoint import reshape as R
from deepspeed_tpu_torch.checkpoint.engine import (load_train_state,
                                                   save_train_state)
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.monitor import tracing
from deepspeed_tpu_torch.utils import fault_injection as FI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leaked_faults(monkeypatch):
    monkeypatch.delenv(FI.ENV_VAR, raising=False)
    monkeypatch.delenv(tracing.ENV_TRACE_DIR, raising=False)
    FI.reset()
    JFI.reset()
    tracing.reset_default()
    yield
    FI.reset()
    JFI.reset()
    tracing.reset_default()


def _state(scale=1.0):
    return {"w": torch.arange(8.0) * scale, "b": torch.ones(3) * scale}


def _save(d, step, scale=None, **kw):
    save_train_state(d, f"global_step{step}",
                     _state(scale if scale is not None else float(step)),
                     {"global_steps": step}, **kw)


def _load(d, tag=None, **kw):
    return load_train_state(d, tag, {"w": torch.zeros(8),
                                     "b": torch.zeros(3)}, **kw)


def _scribble(path, data=b"XX"):
    with open(path, "r+b") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# the manifest protocol
# ---------------------------------------------------------------------------


def test_save_writes_a_verified_manifest_and_an_atomic_latest(tmp_path):
    d = str(tmp_path)
    _save(d, 1)
    status, detail = M.verify_checkpoint(d, "global_step1")
    assert status == "verified", detail
    assert M.read_latest_tag(d) == "global_step1"
    man = M.read_manifest(d, "global_step1")
    assert man["step"] == 1
    assert "sha256" in man["items"]["global_step1.client_state.json"]
    assert "global_step1/universal_meta.json" in man["items"]
    restored, cs = _load(d)
    assert cs == {"global_steps": 1}
    assert torch.equal(restored["w"], torch.arange(8.0))


def test_a_tampered_file_fails_verification(tmp_path):
    d = str(tmp_path)
    _save(d, 1)
    man = M.read_manifest(d, "global_step1")
    victim = next(rel for rel in man["items"] if "/leaves/" in rel)
    with open(os.path.join(d, victim), "ab") as f:
        f.write(b"!")
    status, detail = M.verify_checkpoint(d, "global_step1")
    assert status == "bad" and victim in detail


def test_a_corrupt_manifest_walks_back_to_the_previous_save(tmp_path):
    d = str(tmp_path)
    _save(d, 1, scale=10.0)
    _save(d, 2, scale=20.0)
    _scribble(M.manifest_path(d, "global_step2"), b"\x00garbage")
    restored, cs = _load(d)
    assert cs["global_steps"] == 1
    assert torch.equal(restored["w"], torch.arange(8.0) * 10.0)


def test_a_truncated_or_missing_latest_walks_back(tmp_path):
    d = str(tmp_path / "truncated")
    _save(d, 7)
    with open(os.path.join(d, "latest"), "r+b") as f:
        f.truncate(4)
    assert _load(d)[1]["global_steps"] == 7
    d = str(tmp_path / "missing")
    _save(d, 3)
    os.remove(os.path.join(d, "latest"))
    assert _load(d)[1]["global_steps"] == 3


def test_an_explicit_bad_tag_raises(tmp_path):
    d = str(tmp_path)
    _save(d, 1)
    _save(d, 2)
    _scribble(M.manifest_path(d, "global_step2"))
    with pytest.raises(M.CheckpointCorruptionError):
        _load(d, tag="global_step2")


def test_a_partial_save_is_invisible_to_a_resume(tmp_path):
    d = str(tmp_path)
    _save(d, 1)
    os.makedirs(os.path.join(d, "global_step2"))
    with open(os.path.join(d, "global_step2", "junk.bin"), "wb") as f:
        f.write(b"partial")
    assert _load(d)[1]["global_steps"] == 1


def test_nothing_loadable_raises(tmp_path):
    with pytest.raises(M.CheckpointCorruptionError):
        M.resolve_load_tag(str(tmp_path / "empty"))


def test_retention_and_fsck(tmp_path):
    d = str(tmp_path / "keep")
    for step in (1, 2, 3, 4):
        _save(d, step)
    assert sorted(M.prune_checkpoints(d, keep=2)) == ["global_step1",
                                                      "global_step2"]
    assert not os.path.exists(os.path.join(d, "global_step1"))
    assert not os.path.exists(M.manifest_path(d, "global_step1"))
    assert M.verify_checkpoint(d, "global_step3")[0] == "verified"

    d = str(tmp_path / "protect")
    for step in (1, 2, 3):
        _save(d, step)
    for step in (2, 3):
        _scribble(M.manifest_path(d, f"global_step{step}"))
    assert "global_step1" not in M.prune_checkpoints(d, keep=1)
    assert M.last_verified_tag(d) == "global_step1"
    report = M.fsck(d)
    assert report["latest"] == "global_step3"
    assert report["latest_status"] == "bad"
    assert report["last_good"] == "global_step1"


def test_flaky_save_retries_and_gives_up_past_its_bound(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv(FI.ENV_VAR, "flaky_save:fails=2")
    FI.reset()
    _save(str(tmp_path / "ok"), 1, save_retries=3, retry_backoff_s=0.0)
    assert M.verify_checkpoint(str(tmp_path / "ok"),
                               "global_step1")[0] == "verified"
    monkeypatch.setenv(FI.ENV_VAR, "flaky_save:fails=5")
    FI.reset()
    with pytest.raises(OSError):
        _save(str(tmp_path / "bad"), 1, save_retries=2, retry_backoff_s=0.0)


def test_the_corrupt_manifest_and_truncate_latest_chaos_points(tmp_path,
                                                               monkeypatch):
    d = str(tmp_path / "manifest")
    _save(d, 1)
    monkeypatch.setenv(FI.ENV_VAR, "corrupt_manifest")
    FI.reset()
    _save(d, 2)
    assert M.verify_checkpoint(d, "global_step2")[0] == "bad"
    monkeypatch.delenv(FI.ENV_VAR)
    FI.reset()
    assert _load(d)[1]["global_steps"] == 1

    d = str(tmp_path / "latest")
    monkeypatch.setenv(FI.ENV_VAR, "truncate_latest")
    FI.reset()
    _save(d, 12)
    monkeypatch.delenv(FI.ENV_VAR)
    FI.reset()
    assert M.read_latest_tag(d) != "global_step12"
    assert _load(d)[1]["global_steps"] == 12


def test_the_async_engine_lands_a_verified_save(tmp_path):
    d = str(tmp_path)
    _save(d, 1, use_async=True)
    assert M.verify_checkpoint(d, "global_step1")[0] == "verified"
    assert torch.equal(_load(d)[0]["b"], torch.ones(3))


_CRASH_SCRIPT = textwrap.dedent("""\
    import torch
    from deepspeed_tpu_torch.checkpoint.engine import save_train_state
    d = {ckpt_dir!r}
    for step in (1, 2, 3):
        state = {{"w": torch.arange(8.0) * step, "b": torch.ones(3) * step}}
        save_train_state(d, f"global_step{{step}}", state,
                         {{"global_steps": step}})
        print("saved", step, flush=True)
    """)


@pytest.mark.parametrize("spec,saved,resumed", [
    ("crash_during_save:step=3", 2, 2),
    ("crash_during_save:step=2:phase=begin", 1, 1)],
    ids=["commit", "begin"])
def test_a_crash_during_save_resumes_the_last_verified_save(
        spec, saved, resumed, tmp_path):
    d = str(tmp_path / "ckpt")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["DS_FAULT"] = spec
    out = subprocess.run([sys.executable, "-c",
                          _CRASH_SCRIPT.format(ckpt_dir=d)],
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == FI.CRASH_EXIT_CODE == JFI.CRASH_EXIT_CODE, \
        out.stdout + out.stderr
    assert f"saved {saved}" in out.stdout
    assert f"saved {saved + 1}" not in out.stdout
    assert M.verify_checkpoint(d, f"global_step{saved + 1}")[0] != "verified"
    restored, cs = _load(d)
    assert cs["global_steps"] == resumed
    assert torch.equal(restored["w"], torch.arange(8.0) * resumed)
    assert JM.resolve_load_tag(d) == M.resolve_load_tag(d)


def test_the_training_engine_walks_back_past_a_bad_save(tmp_path):
    cfg = LlamaConfig.tiny()
    config = {"train_batch_size": 2, "steps_per_print": 0,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    eng, *_ = dt.initialize(model=LlamaForCausalLM(cfg), config=config,
                            device="cpu")
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8))
    d = str(tmp_path)
    eng.train_batch(batch={"input_ids": ids, "labels": ids})
    eng.save_checkpoint(d)
    want = {n: p.clone() for n, p in eng.module_state_dict().items()}
    eng.train_batch(batch={"input_ids": ids, "labels": ids})
    eng.save_checkpoint(d)
    _scribble(M.manifest_path(d, "global_step2"))
    other, *_ = dt.initialize(model=LlamaForCausalLM(cfg),
                              config=dict(config, seed=3), device="cpu")
    _, cs = other.load_checkpoint(d)
    assert cs["global_steps"] == 1 == other.global_steps
    for name, p in want.items():
        assert torch.equal(other.module_state_dict()[name], p), name
    with pytest.raises(M.CheckpointCorruptionError):
        other.load_checkpoint(d, tag="global_step2")


# ---------------------------------------------------------------------------
# both packages pick the same tag
# ---------------------------------------------------------------------------


def _damage(d, case):
    """Saves 1-3 in ``d``, then ``case``'s damage; returns the explicit tag
    to ask for (None: resume from ``latest``)."""
    for step in (1, 2, 3):
        _save(d, step)
    if case == "corrupt_manifest":
        _scribble(M.manifest_path(d, "global_step3"), b"\x00garbage")
    elif case == "truncated_latest":
        with open(os.path.join(d, "latest"), "r+b") as f:
            f.truncate(4)
    elif case == "missing_latest":
        os.remove(os.path.join(d, "latest"))
    elif case == "tampered_leaf":
        with open(os.path.join(d, "global_step3", "leaves",
                               sorted(os.listdir(os.path.join(
                                   d, "global_step3", "leaves")))[0]),
                  "ab") as f:
            f.write(b"!")
    elif case == "two_bad_saves":
        for step in (2, 3):
            _scribble(M.manifest_path(d, f"global_step{step}"))
    elif case == "partial_newest":
        os.makedirs(os.path.join(d, "global_step4"))
        with open(os.path.join(d, "latest"), "w") as f:
            f.write("global_step4")
    elif case == "legacy_only":
        for step in (1, 2, 3):
            os.remove(M.manifest_path(d, f"global_step{step}"))
    elif case == "nothing_verifies":
        for step in (1, 2, 3):
            _scribble(M.manifest_path(d, f"global_step{step}"))
    elif case == "explicit_bad_tag":
        _scribble(M.manifest_path(d, "global_step2"))
        return "global_step2"
    elif case == "explicit_good_tag":
        return "global_step2"
    return None


DAMAGE = ("clean", "corrupt_manifest", "truncated_latest", "missing_latest",
          "tampered_leaf", "two_bad_saves", "partial_newest", "legacy_only",
          "nothing_verifies", "explicit_bad_tag", "explicit_good_tag")


def _resolve(resolve, d, tag):
    try:
        return resolve(d, tag)
    except Exception as e:
        return type(e).__name__


@pytest.mark.parametrize("case", DAMAGE)
def test_both_packages_resolve_the_same_tag(case, tmp_path):
    d = str(tmp_path)
    tag = _damage(d, case)
    got = _resolve(M.resolve_load_tag, d, tag)
    assert got == _resolve(JM.resolve_load_tag, d, tag)
    assert M.fsck(d) == JM.fsck(d)
    if case in ("clean", "explicit_good_tag"):
        assert got == ("global_step2" if tag else "global_step3")
    if case == "nothing_verifies":
        assert got == "CheckpointCorruptionError"


# ---------------------------------------------------------------------------
# the fault helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "corrupt_manifest", "corrupt_manifest:step=2", "truncate_latest:fails=1",
    "truncate_latest:p=0.5", "corrupt_manifest:p=0.3",
    "corrupt_manifest:tag=global_step3"])
def test_the_file_faults_do_what_the_jax_ones_do(spec, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv(FI.ENV_VAR, spec)
    monkeypatch.setenv("DS_FAULT_SEED", "5")
    results = []
    for pkg in (FI, JFI):
        pkg.reset()
        fired = []
        cb = lambda name, ctx: fired.append((name, ctx))
        pkg.add_listener(cb)
        out = []
        try:
            for step in range(1, 13):
                path = str(tmp_path / f"{pkg.__name__}_{step}")
                with open(path, "wb") as f:
                    f.write(b"0123456789abcdef" * 4)
                pkg.maybe_corrupt_file("corrupt_manifest", path, step=step,
                                       tag=f"global_step{step}")
                pkg.maybe_truncate_file("truncate_latest", path, step=step,
                                        tag=f"global_step{step}")
                # no file, no firing (a draw is still taken)
                pkg.maybe_corrupt_file("corrupt_manifest",
                                       path + ".absent", step=step)
                with open(path, "rb") as f:
                    out.append(f.read())
        finally:
            pkg.remove_listener(cb)
        results.append((out, [(n, {k: v for k, v in c.items()
                                   if k != "path"}) for n, c in fired]))
    assert results[0] == results[1]
    assert results[0][1], "the spec never fired"


def test_retry_with_backoff_and_a_silent_crash_probe():
    for pkg in (FI, JFI):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("transient")
            return "ok"

        assert pkg.retry_with_backoff(flaky, retries=3, base_delay=0.0) \
            == "ok"
        assert calls["n"] == 3

        def always():
            raise OSError("permanent")

        with pytest.raises(OSError):
            pkg.retry_with_backoff(always, retries=2, base_delay=0.0)
        with pytest.raises(ValueError):  # not retried
            pkg.retry_with_backoff(lambda: int("x"), retries=2,
                                   base_delay=0.0)
        pkg.maybe_crash("crash_during_save", step=1, phase="commit")


# ---------------------------------------------------------------------------
# reshape
# ---------------------------------------------------------------------------


def _full_sd(seed=0, H=32):
    rs = np.random.RandomState(seed)
    return {
        "transformer.layers.0.attention.query_key_value.weight":
            rs.randn(3 * H, H).astype(np.float32),
        "transformer.layers.0.attention.query_key_value.bias":
            rs.randn(3 * H).astype(np.float32),
        "transformer.layers.0.attention.dense.weight":
            rs.randn(H, H).astype(np.float32),
        "transformer.layers.0.mlp.dense_h_to_4h.weight":
            rs.randn(4 * H, H).astype(np.float32),
        "model.layers.0.self_attn.o_proj.weight":
            rs.randn(H, H).astype(np.float32),
        "transformer.layers.0.input_layernorm.weight":
            rs.randn(H).astype(np.float32),
        "word_embeddings.weight": rs.randn(128, H).astype(np.float32),
    }


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("version", [0, 1.0, 2.0])
def test_reshape_matches_jax(version, tmp_path):
    full = _full_sd(seed=int(version * 10))
    for n in (2, 4):
        for r in range(n):
            _same(R.split_state_dict(full, n, r, version),
                  JR.split_state_dict(full, n, r, version))
        shards = [R.split_state_dict(full, n, r, version) for r in range(n)]
        _same(R.merge_state_dicts(shards, version),
              JR.merge_state_dicts(shards, version))
        qkv = full["transformer.layers.0.attention.query_key_value.weight"]
        assert np.array_equal(R.split_qkv(qkv, n, 1, version),
                              JR.split_qkv(qkv, n, 1, version))
        parts = [R.split_qkv(qkv, n, r, version) for r in range(n)]
        assert np.array_equal(R.merge_qkv(parts, version),
                              JR.merge_qkv(parts, version))
    for got, want in zip(R.reshape_tp([full], 4, version),
                         JR.reshape_tp([full], 4, version)):
        _same(got, want)
    for name in full:
        assert R.infer_rule(name) == JR.infer_rule(name), name
    paths = []
    for r, sd in enumerate(R.split_state_dict(full, 2, r, version)
                           for r in range(2)):
        paths.append(str(tmp_path / f"mp_rank_{r:02d}.npz"))
        np.savez(paths[-1], **sd)
    torch.save({"module": {k: torch.from_numpy(v) for k, v in full.items()}},
               str(tmp_path / "full.pt"))
    for loader, want in (
            (R.get_sd_loader(paths, version), JR.get_sd_loader(paths, version)),
            (R.ShardedCheckpointLoader([str(tmp_path / "full.pt")], version),
             JR.ShardedCheckpointLoader([str(tmp_path / "full.pt")],
                                        version))):
        for world, rank in ((1, 0), (4, 3)):
            _same(loader.load(world, rank), want.load(world, rank))


# ---------------------------------------------------------------------------
# the process-global tracer
# ---------------------------------------------------------------------------


def test_ds_trace_dir_arms_the_global_recorder_once(tmp_path, monkeypatch):
    traces = tmp_path / "traces"
    monkeypatch.setenv(tracing.ENV_TRACE_DIR, str(traces))
    tracing.reset_default()
    assert tracing.get_tracer().enabled
    assert tracing.default_flight_recorder() is not None
    cfg = LlamaConfig.tiny()
    eng, *_ = dt.initialize(model=LlamaForCausalLM(cfg), config={
        "train_batch_size": 2, "steps_per_print": 0}, device="cpu")
    d = str(tmp_path / "ckpt")
    eng.save_checkpoint(d)
    names = [e["name"] for e in tracing.get_tracer().events()]
    assert names.count("checkpoint_save") == 1
    assert all(tracing.validate_event(e) is None
               for e in tracing.get_tracer().events())
    assert eng.registry.snapshot()["checkpoint_save_s_count"] == 1.0
    tag = M.read_latest_tag(d)
    _scribble(M.manifest_path(d, tag), b"XXgarbage")
    with pytest.raises(M.CheckpointCorruptionError):
        eng.load_checkpoint(d, tag=tag)
    dumps = [p.name for p in traces.iterdir()
             if "checkpoint_verify" in p.name]
    assert len(dumps) == 1, dumps


def test_the_global_tracer_is_off_without_ds_trace_dir(tmp_path):
    assert not tracing.get_tracer().enabled
    assert tracing.default_flight_recorder() is None
    assert tracing.flight_dump("checkpoint_verify", {"tag": "x"}) is None
    tracing.configure(trace_dir=str(tmp_path))
    path = tracing.flight_dump("checkpoint_verify", {"tag": "x"})
    assert path is not None and os.path.exists(path)
