"""Inference engine: a model definition bound to its weights on one device.

Counterpart of ``deepspeed_tpu/inference/engine.py``: ``init_inference``
quantizes the projection weights when ``quantize_weights`` asks for it,
casts the rest to ``dtype``, and binds them to the model on the chosen
device. The engine runs the dense forward (``forward``), autoregressive
generation over a contiguous KV cache (``generate``), and hands itself to
the serving layer. The entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a CUDA device they raise rather than
quietly running on the CPU.

PyTorch runs eagerly, so ``generate`` is a Python loop of one prefill and
one forward per new token where the JAX engine compiles one program per
shape bucket; the bucketing itself (pow2 prompt and token counts above
``bucket_min``) is kept, so both engines see the same shapes and pads.
With ``enable_cuda_graph`` the decode step is one CUDA graph, kept for
the last shape and replayed once a token (see
:meth:`InferenceEngine.generate`).
"""

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..monitor.perf import (PerfAccounting, estimate_decode_step_bytes,
                             estimate_decode_step_flops, param_bytes,
                             transformer_flops_per_token)
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << max(0, (n - 1).bit_length())


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device is present); any
    explicit device is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _sample_logits(logits, generator: Optional[torch.Generator],
                   do_sample: bool, temperature: float, top_k: int,
                   top_p: float):
    """Greedy / temperature / top-k / top-p sampling over the last axis;
    the random draw comes from ``generator``."""
    if not do_sample:
        return logits.argmax(dim=-1)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = logits.topk(top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -1e9)
    if top_p and top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        probs = sorted_logits.softmax(dim=-1)
        cum = probs.cumsum(dim=-1)
        # keep tokens whose prefix mass (exclusive) is < top_p; the cutoff
        # is the smallest KEPT logit
        cutoff = torch.where((cum - probs) >= top_p,
                             torch.full_like(sorted_logits, float("inf")),
                             sorted_logits).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, -1e9)
    probs = logits.softmax(dim=-1).reshape(-1, logits.shape[-1])
    return torch.multinomial(probs, 1, generator=generator).reshape(
        logits.shape[:-1])


class InferenceEngine:
    """A model with its weights (quantized where asked, the rest cast to
    ``config.dtype``) on ``device``. Construct via :func:`init_inference`."""

    def __init__(self, module: nn.Module, params: Dict[str, torch.Tensor],
                 config: DeepSpeedInferenceConfig, device=None):
        self.device = resolve_device(device)
        self.config = config
        dtype = config.dtype
        self.quant_report = None
        self.quant_summary: Dict[str, Any] = {}
        qw = config.quantize_weights
        if qw:
            from .quant import quant_report_summary, quantize_state_dict

            mcfg = getattr(module, "config", None)
            if not dataclasses.is_dataclass(mcfg) or \
                    not hasattr(mcfg, "quantize_weights") or \
                    not hasattr(module, "quantizable_projections"):
                raise ValueError(
                    f"quantize_weights needs a model whose config carries "
                    f"the quant knobs and which declares its quantizable "
                    f"projections (the Llama family), got "
                    f"{type(module).__name__}")
            module = type(module)(dataclasses.replace(
                mcfg, quantize_weights=qw,
                quantize_group_size=config.quantize_group_size,
                quantize_row_shards=1))
            # quantized one tensor at a time on the engine's device
            params, self.quant_report = quantize_state_dict(
                {n: p.to(self.device) for n, p in params.items()}, module,
                qw, config.quantize_group_size)
            self.quant_summary = quant_report_summary(self.quant_report)
            log_dist(
                f"quantize_weights={qw}: {self.quant_summary['leaves']} "
                f"projection weights -> "
                f"{self.quant_summary['quant_weight_bytes']} B "
                f"({self.quant_summary['bytes_ratio']:.2f}x of bf16), max "
                f"rel err {self.quant_summary['max_rel_err']:.3e} "
                f"({self.quant_summary['worst_param']})", ranks=[0])

        def cast(name, p):
            # codes keep their integer type; scales stay fp32 (they carry
            # the whole range of their codes)
            if name.endswith("wscale"):
                to = torch.float32
            else:
                to = dtype if p.is_floating_point() else p.dtype
            return p.to(device=self.device, dtype=to)

        module.load_state_dict({n: cast(n, p) for n, p in params.items()},
                               strict=True, assign=True)
        module.eval().requires_grad_(False)
        self.module = module
        self._profile_model_time = False
        self._model_times = []
        #: enable_cuda_graph: the decode loop's tensors and captured graph
        #: of the last (batch, prompt bucket, new tokens, sampling, EOS),
        #: at most one entry, and the memory pool of every graph captured
        #: on this engine
        self._decode_graphs: Dict[Any, Dict[str, Any]] = {}
        self._graph_pool = None
        #: program registry of ``generate``: one prefill program per
        #: (batch, prompt bucket) and one decode step (the captured graph
        #: with ``enable_cuda_graph``) per (batch, prompt bucket, new
        #: tokens), each with its hand cost estimate
        self.perf = PerfAccounting(scope="inference", device=self.device)
        log_dist(f"InferenceEngine: device={self.device}, dtype={dtype}, "
                 f"quantize_weights={qw}", ranks=[0])

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.config.dtype

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(device=self.device, dtype=dtype)

    def forward(self, input_ids, **kwargs):
        """The dense forward: ``input_ids [B, T]`` -> logits (kernels K1
        and, with quantized weights, K5 on the card)."""
        with torch.inference_mode():
            return self.module(self._tensor(input_ids, torch.long), **kwargs)

    __call__ = forward

    # ------------------------------------------------------------------

    def generate(self, input_ids, attention_mask=None,
                 max_new_tokens: int = 32, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 **_ignored) -> torch.Tensor:
        """Autoregressive generation: ``[B, max_new_tokens]`` token ids.

        Prompts of differing lengths must be LEFT-padded
        (``attention_mask`` zeros on the left), so the last column is each
        row's newest token; positions and key masking handle the pads.
        The prefill attends through the plain cached attention, or, when
        the model's ``prefill_flash_from_empty`` is set, through the flash
        kernel's masked forward over the fresh K/V (kernel K1). Sampling
        draws from a ``torch.Generator`` seeded with ``seed``
        (it cannot reproduce ``jax.random``'s draws).

        The decode loop updates its tensors in place (the cache, key
        mask, last token, cache index, EOS flags and output), so a step
        has fixed inputs. With the config's ``enable_cuda_graph`` they are
        kept between calls for the last shape that decodes (batch, prompt
        bucket, new tokens, sampling, EOS id); a decoding call at another
        shape releases them.
        On a CUDA device that shape's first decode step then runs eagerly
        and is captured as one CUDA graph (greedy: the forward, the token
        and the bookkeeping; sampling: the forward, the draw following
        eagerly with the generator), which every later step replays; on
        the CPU nothing is captured. The prefill is never captured. The
        tokens do not depend on the switch."""
        ids = self._tensor(input_ids, torch.long)
        if ids.dim() == 1:
            ids = ids[None]
        B, T = ids.shape
        mask = torch.ones((B, T), dtype=torch.int32, device=self.device) \
            if attention_mask is None \
            else self._tensor(attention_mask, torch.int32).reshape(B, T)

        # pow2 shape buckets above bucket_min, as the JAX engine compiles
        # them: prompts pad on the left, extra new tokens are trimmed
        requested_new = max_new_tokens
        if self.config.bucket_shapes:
            lo = max(1, self.config.bucket_min)
            Tb = T if T <= lo else next_pow2(T)
            if max_new_tokens > lo:
                max_new_tokens = next_pow2(max_new_tokens)
            if Tb > T:
                ids = torch.nn.functional.pad(ids, (Tb - T, 0))
                mask = torch.nn.functional.pad(mask, (Tb - T, 0))
                T = Tb
        self._observe_generate(ids, mask, max_new_tokens, (
            do_sample, temperature, top_k, top_p, eos_token_id))
        if self._profile_model_time:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
        with torch.inference_mode():
            out = self._generate(ids, mask, max_new_tokens, do_sample,
                                 temperature, top_k, top_p, eos_token_id,
                                 seed)
        if self._profile_model_time:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._model_times.append(time.perf_counter() - t0)
        return out[:, :requested_new]

    def _observe_generate(self, ids, mask, max_new_tokens, sampler):
        """Register one ``generate`` call's programs at its bucketed shape
        (a new shape is a new program, so bucket churn shows as a growing
        table; a changed fingerprint within one trips the sentinel)."""
        B, T = ids.shape
        cfg = getattr(self.module, "config", None)
        params = self.perf.cached_spec("params", self.module)
        name = f"prefill[b{B},t{T}]"
        self.perf.observe_call(name, params=params, input_ids=ids,
                               attention_mask=mask, sampler=sampler)
        self.perf.capture_cost(name, lambda: {
            "flops": B * T * transformer_flops_per_token(cfg, T)})
        if max_new_tokens < 2:
            return
        name = f"decode[b{B},t{T},n{max_new_tokens}]"
        cache_len = T + max_new_tokens
        self.perf.observe_call(name, params=params, tokens=(B, 1),
                               cache_len=cache_len, sampler=sampler)
        kv = 1 if self.config.kv_cache_int8 else \
            torch.empty((), dtype=self.compute_dtype).element_size()
        self.perf.capture_cost(name, lambda: {
            "flops": estimate_decode_step_flops(cfg, B, cache_len),
            "bytes_accessed": estimate_decode_step_bytes(
                cfg, B, cache_len, param_bytes(self.module),
                kv_bytes_per_elem=kv)})

    def _generate(self, ids, mask, max_new_tokens, do_sample, temperature,
                  top_k, top_p, eos_token_id, seed):
        module, dev = self.module, self.device
        B, T = ids.shape
        cache_len = T + max_new_tokens
        # with enable_cuda_graph the decode tensors (and, on a CUDA device,
        # the captured step) of the last shape that decodes are kept for
        # the next call; a decoding call at another shape releases them
        # first, a call without a decode step leaves them be
        graphed = self.config.enable_cuda_graph and max_new_tokens > 1
        key = (B, T, max_new_tokens, do_sample, eos_token_id)
        st = self._decode_graphs.get(key) if graphed else None
        if st is None:
            if graphed:
                self._decode_graphs.clear()
            st = {"cache": module.init_cache(
                B, cache_len, dtype=torch.int8 if self.config.kv_cache_int8
                else self.compute_dtype, device=dev),
                "key_mask": torch.zeros((B, cache_len), dtype=torch.int32,
                                        device=dev)}
            if graphed:
                self._decode_graphs[key] = st
        else:
            for t in st["cache"].values():
                t.zero_()
            st["key_mask"].zero_()
        cache, key_mask = st["cache"], st["key_mask"]
        key_mask[:, :T] = mask
        # left-padding-aware positions: pads get 0, real tokens 0..n-1
        positions = (mask.cumsum(dim=-1) - 1).clamp_min(0)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def sample(lg):
            return _sample_logits(lg, gen, do_sample, temperature, top_k,
                                  top_p)

        # the cache index lives on the device, so no step waits on the host
        cache_index = torch.zeros((), dtype=torch.int32, device=dev)
        logits, cache = module(ids, cache=cache, cache_index=cache_index,
                               positions=positions, attention_mask=key_mask)
        tok = sample(logits[:, -1])
        eos = eos_token_id if eos_token_id is not None else -1
        done = tok == eos if eos_token_id is not None else \
            torch.zeros((B,), dtype=torch.bool, device=dev)
        out = torch.full((B, max_new_tokens), eos, dtype=torch.long,
                         device=dev)
        out[:, 0] = tok
        st.update(out=out, tok=tok, done=done, cache_index=cache_index + T,
                  col=torch.ones((1,), dtype=torch.long, device=dev))
        early_exit = self.config.decode_loop == "while" and \
            eos_token_id is not None
        return self._decode(st, sample, do_sample, eos_token_id, early_exit,
                            graphed and dev.type == "cuda")

    def _decode(self, st, sample, do_sample, eos_token_id, early_exit,
                capture):
        """``generate``'s decode loop over the tensors of ``st``: each step
        updates the cache, key mask, last token, cache index and EOS flags
        in place and writes its tokens into the output at a device column
        index, so the step has fixed inputs. With ``capture`` the first
        step runs eagerly and is then captured as a CUDA graph, kept in
        ``st`` and replayed by every later step of this and later calls
        (the inputs of a later call are copied into the captured ones)."""
        graph = st.get("graph")
        if graph is not None:
            for name in ("out", "tok", "done", "cache_index", "col"):
                st["graph_in"][name].copy_(st[name])
            st.update(st["graph_in"])
        module, cache, key_mask = self.module, st["cache"], st["key_mask"]
        tok, done, out, ci, col = (st["tok"], st["done"], st["out"],
                                   st["cache_index"], st["col"])
        eos = eos_token_id if eos_token_id is not None else -1

        def forward():
            key_mask.index_fill_(1, ci.long().reshape(1), 1)
            pos = key_mask.sum(dim=-1, keepdim=True) - 1
            logits, _ = module(tok[:, None], cache=cache, cache_index=ci,
                               positions=pos, attention_mask=key_mask)
            return logits[:, 0]

        def advance(lg):
            nxt = sample(lg)
            if eos_token_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                done.logical_or_(nxt == eos)
            out.index_copy_(1, col, nxt[:, None])
            tok.copy_(nxt)
            ci.add_(1)
            col.add_(1)

        def step():
            if do_sample:
                return forward()     # the draw follows, eagerly
            advance(forward())
            return None

        for _ in range(1, out.shape[1]):
            if early_exit and bool(done.all()):
                break           # the tail keeps its EOS fill
            graph = st.get("graph")
            if graph is not None:
                graph.replay()
                lg = st["graph_out"]
            else:
                lg = step()
                if capture:
                    st["graph"], st["graph_out"] = self.capture(step)
                    st["graph_in"] = dict(out=out, tok=tok, done=done,
                                          cache_index=ci, col=col)
            if do_sample:
                advance(lg)
        return out.clone()

    def capture(self, fn):
        """``(graph, output)``: ``fn()`` captured as a CUDA graph. Every
        graph of the engine, and of a serving engine built on it, shares
        one memory pool (one runs at a time). A capture that fails
        raises."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool):
            res = fn()
        return graph, res

    def profile_model_time(self, use_cuda_events: bool = True) -> None:
        """Start collecting per-``generate`` wall latencies, fenced with
        ``torch.cuda.synchronize`` on the card (``use_cuda_events`` is
        accepted for parity with the JAX engine)."""
        self._profile_model_time = True
        self._model_times = []

    def model_times(self):
        """Latencies collected since :meth:`profile_model_time`, in
        seconds; returns and resets them."""
        times, self._model_times = list(self._model_times), []
        return times


def init_inference(model=None, config=None, mp_size: Optional[int] = None,
                   dtype=None, checkpoint: Optional[str] = None, params=None,
                   quantize: Optional[bool] = None, device=None,
                   **kwargs) -> InferenceEngine:
    """Bind ``params`` (a ``state_dict``) to ``model`` (a port model such as
    :class:`~deepspeed_tpu_torch.models.llama.LlamaForCausalLM`). ``config``
    may be a dict or a :class:`DeepSpeedInferenceConfig`; keyword arguments
    override it. Runs on ``cuda`` unless ``device`` says otherwise."""
    if isinstance(config, DeepSpeedInferenceConfig):
        cfg = config
    else:
        merged = dict(config or {})
        for k, v in [("mp_size", mp_size), ("dtype", dtype),
                     ("checkpoint", checkpoint), ("quantize", quantize)]:
            if v is not None:
                merged[k] = v
        merged.update(kwargs)
        known = {f.name for f in
                 DeepSpeedInferenceConfig.__dataclass_fields__.values()}
        unknown = sorted(set(merged) - known)
        if unknown:
            raise TypeError(f"init_inference: unknown options {unknown}")
        cfg = DeepSpeedInferenceConfig(**merged)
    device = resolve_device(device)
    if not isinstance(model, nn.Module) or \
            not hasattr(model, "init_paged_cache"):
        raise NotImplementedError(
            "init_inference takes a port model (deepspeed_tpu_torch.models); "
            "HF module injection arrives with the module-injection slice of "
            "the port (ROADMAP.md Queue 1, item 4)")
    if params is None:
        raise ValueError("init_inference needs params (a state_dict)")
    return InferenceEngine(model, params, cfg, device=device)
