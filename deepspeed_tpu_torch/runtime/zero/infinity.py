"""ZeRO-Infinity: the body's parameters live on the host (or NVMe) and
stream through the card a block at a time.

Counterpart of ``deepspeed_tpu/runtime/zero/infinity.py``
(``ZeroInfinityEngine``) on one device. The model is a ``PipelineModule``
with ``num_stages=1``; the unit of swap is a block of ``block_layers``
body layers:

- the body's bf16 weights are pre-stacked per block in host staging
  buffers (``[block_layers, ...]`` per parameter; pinned host memory, or
  memory-mapped files for ``offload_param.device: nvme``), so a block's
  copy to the card is one contiguous copy a parameter;
- the card holds the edges (prefix, suffix, tied modules, bf16) and two
  block slots. The forward copies block b+1 into the free slot on a copy
  stream while block b computes; CUDA events order the copy after the
  slot's last reader and the compute after the copy (the JAX engine's
  ``_fetch`` thread). ``prefetch = False`` copies on the compute stream;
- only the block-boundary activations are kept. The backward re-streams
  the blocks in reverse and recomputes each block under autograd, and
  each block's gradients leave for host fp32 buffers (added up over
  gradient-accumulation microbatches);
- the host optimizer (``runtime/zero/offload.py``: SIMD Adam/Adagrad,
  the moments on NVMe for ``offload_optimizer.device: nvme``) steps fp32
  masters and writes the new bf16 weights in place into the staging
  blocks, then the edges go back to the card. With both offload devices
  ``nvme`` (full-NVMe mode) the masters and the gradient buffers are
  memory-mapped files too.

The data-parallel sharding of the streamed blocks needs more than one
device and raises naming ROADMAP item 9. The compute dtype is bf16.
"""

import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...inference.engine import resolve_device
from ...pipe.module import PipelineModule
from ...utils.logging import log_dist
from ..config import DeepSpeedConfig
from ..config_utils import unported
from ..engine import _bind
from .config import offload_on
from ...ops._host import host_buffers
from .offload import HostOffloadOptimizer, memmap_alloc

BF16 = torch.bfloat16


class ZeroInfinityEngine:
    """Block-streaming training engine (see the module docstring)."""

    def __init__(self, module: PipelineModule, config: Optional[Dict] = None,
                 lr_scheduler=None, device=None, mesh=None):
        if module.num_stages != 1:
            raise ValueError("ZeroInfinityEngine streams a num_stages=1 "
                             "layer list")
        if not module.body_specs:
            raise ValueError("ZeroInfinityEngine needs a homogeneous body "
                             "to stream")
        if mesh is not None:
            raise unported("ZeroInfinityEngine's data-parallel sharding of "
                           "the streamed blocks",
                           "the distributed and ZeRO slice (item 9)")
        self.device = resolve_device(device)
        self.module = module
        self._config = DeepSpeedConfig(dict(config or {}))
        self.gas = int(self._config.gradient_accumulation_steps)
        zcfg = self._config.zero_config
        pcfg = zcfg.offload_param
        if not offload_on(pcfg):
            raise ValueError("ZeroInfinityEngine requires "
                             "zero_optimization.offload_param")
        self.block_layers = int(pcfg.block_layers)
        self._nvme_dir = None
        if pcfg.device == "nvme":
            # a fixed default would let two engines clobber each other's
            # block files
            self._nvme_dir = pcfg.nvme_path or tempfile.mkdtemp(
                prefix="ds_param_swap_")
        self.L = len(module.body_specs)
        if self.L % self.block_layers != 0:
            raise ValueError(
                f"offload_param.block_layers={self.block_layers} must divide "
                f"the body layer count ({self.L}); adjust block_layers")
        self.n_blocks = self.L // self.block_layers
        self.global_steps = 0
        self.prefetch = True
        self.loss_scale = 1.0
        #: when True, ``train_batch`` records the card's peak allocated
        #: bytes over the step (on the CPU: the bytes of the tensors the
        #: engine keeps on the device)
        self.track_device_memory = False
        self.last_peak_device_bytes = 0
        self.micro_batch_size = self._config.train_micro_batch_size_per_gpu
        self.dp_world_size = 1
        self._cuda = self.device.type == "cuda"
        self.timings: Dict[str, float] = {}
        #: the bytes copied to the card in the last step
        self.h2d_bytes = 0

        # ---- the edges: on the device, bf16 -----------------------------
        for part in (module.tied, module.prefix, module.suffix):
            part.to(device=self.device, dtype=BF16)
        self._edge_names = [n for n, _ in module.named_parameters()
                            if not n.startswith("body.")]
        params = dict(module.named_parameters())
        self._edges = [params[n] for n in self._edge_names]

        # ---- the body: pre-stacked bf16 staging blocks ------------------
        k = self.block_layers
        self._names = sorted(n for n, _ in module.body[0].named_parameters())
        pin = self._cuda and self._nvme_dir is None
        self.host_blocks: List[Dict[str, torch.Tensor]] = []
        for b in range(self.n_blocks):
            layers = [dict(module.body[b * k + i].named_parameters())
                      for i in range(k)]
            blk = {}
            for li, n in enumerate(self._names):
                stacked = torch.stack([l[n].detach().to(BF16)
                                       for l in layers])
                blk[n] = self._place(stacked, f"block{b}_leaf{li}.bin", pin)
            self.host_blocks.append(blk)
        # the first block_layers layers compute every block on the device
        # (their parameters bound to slot views); the rest hold nothing
        self._layers = list(module.body[:k])
        for layer in self._layers:
            layer.to(device=self.device, dtype=BF16)
        for layer in module.body[k:]:
            layer.to("meta")
        self._slots = [{n: torch.empty_like(self.host_blocks[0][n],
                                            device=self.device)
                        for n in self._names} for _ in range(2)]
        self._resident = [None, None]
        self._ready = [None, None]
        self._free = [None, None]
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self._cuda else None

        # ---- the host optimizer over every fp32 master ------------------
        ocfg = zcfg.offload_optimizer
        self._full_nvme = self._nvme_dir is not None and \
            ocfg is not None and ocfg.device == "nvme"
        leaves = [blk[n].float() for blk in self.host_blocks
                  for n in self._names]
        leaves += [p.detach().float().cpu() for p in self._edges]
        opt_cfg = self._config.optimizer
        sched = self._config.scheduler
        if lr_scheduler is None and sched is not None and \
                sched.type is not None:
            from ..lr_schedules import get_lr_schedule

            lr_scheduler = get_lr_schedule(sched.type, sched.params)
        self.lr_scheduler = lr_scheduler
        self._host_opt = HostOffloadOptimizer(
            leaves, opt_cfg.type if opt_cfg else "AdamW",
            dict(opt_cfg.params or {}) if opt_cfg else {}, ocfg,
            gradient_clipping=self._config.gradient_clipping,
            lr_scheduler=lr_scheduler,
            spill_masters_dir=os.path.join(self._nvme_dir, "masters")
            if self._full_nvme else None)
        del leaves
        self.optimizer = self._host_opt
        #: host bf16 staging of the edges' new weights
        self._edges_staging = [torch.empty(p.shape, dtype=BF16)
                               for p in self._edges]
        self._grad_blocks: Optional[List[Dict[str, torch.Tensor]]] = None
        self._last_grad_norm = None
        log_dist(f"ZeRO-Infinity: {self.L} body layers on host "
                 f"({self.body_param_bytes() / 1e6:.1f} MB bf16), streamed "
                 f"in {self.n_blocks} blocks of {self.block_layers}; device "
                 f"holds 2 blocks + edges; gas={self.gas}", ranks=[0])

    # ------------------------------------------------------------------
    # host staging
    # ------------------------------------------------------------------

    def _place(self, t: torch.Tensor, name: str, pin: bool) -> torch.Tensor:
        """A bf16 staging buffer holding ``t``: pinned host memory, plain
        host memory, or (``nvme``) a memory-mapped file."""
        if self._nvme_dir is not None:
            mm = memmap_alloc(self._nvme_dir, name, np.int16, t.shape,
                              init=t.cpu().view(torch.int16).numpy())
            return torch.from_numpy(mm).view(BF16)
        out = torch.empty(t.shape, dtype=BF16, pin_memory=pin)
        return out.copy_(t)

    @property
    def host_body(self) -> List[Dict[str, torch.Tensor]]:
        """The body's host weights, a ``{name: tensor}`` a layer (views of
        the staging blocks)."""
        return [{n: blk[n][i] for n in self._names}
                for blk in self.host_blocks for i in range(self.block_layers)]

    def body_param_bytes(self) -> int:
        """The bf16 bytes of the streamed body (the host-resident model
        size, which may exceed device memory)."""
        return sum(t.numel() * 2 for blk in self.host_blocks
                   for t in blk.values())

    def device_resident_bytes(self) -> int:
        """The bytes of the tensors the engine keeps on the device: the
        edges and the two block slots."""
        return sum(p.numel() * p.element_size() for p in self._edges) + \
            sum(t.numel() * t.element_size() for s in self._slots
                for t in s.values())

    # ------------------------------------------------------------------
    # streaming
    # ------------------------------------------------------------------

    def _fetch(self, b: int, slot: int, prefetch: bool) -> None:
        """Copy block b into ``slot``: on the copy stream, after the slot's
        last reader, when prefetching; else on the compute stream."""
        host, dev = self.host_blocks[b], self._slots[slot]
        self._resident[slot] = b
        if self._cuda and prefetch:
            stream = self._copy_stream
            if self._free[slot] is not None:
                stream.wait_event(self._free[slot])
            with torch.cuda.stream(stream):
                for n in self._names:
                    dev[n].copy_(host[n], non_blocking=True)
            self._ready[slot] = torch.cuda.Event()
            self._ready[slot].record(stream)
        else:
            for n in self._names:
                dev[n].copy_(host[n], non_blocking=self._cuda)
            self._ready[slot] = None
        self.h2d_bytes += sum(t.numel() * 2 for t in host.values())

    def _use(self, slot: int) -> Dict[str, torch.Tensor]:
        if self._ready[slot] is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._ready[slot])
            self._ready[slot] = None
        return self._slots[slot]

    def _release(self, slot: int) -> None:
        if self._cuda:
            self._free[slot] = torch.cuda.Event()
            self._free[slot].record(torch.cuda.current_stream(self.device))

    def _slot_of(self, b: int, prefetch: bool) -> int:
        """The slot holding block b (copied in if neither does)."""
        if b in self._resident:
            return self._resident.index(b)
        slot = self._resident.index(None) if None in self._resident else 0
        self._fetch(b, slot, prefetch)
        return slot

    def _run_block(self, tensors: Dict[str, torch.Tensor], h):
        for i, layer in enumerate(self._layers):
            _bind(layer, {n: t[i] for n, t in tensors.items()})
        return self.module.apply_stage(self._layers, h)

    def _mark(self) -> None:
        if not self.track_device_memory:
            return
        if self._cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
        else:
            peak = self.device_resident_bytes()
        self.last_peak_device_bytes = max(self.last_peak_device_bytes, peak)

    def _grad_target_blocks(self) -> List[Dict[str, torch.Tensor]]:
        """The fp32 gradient buffers mirroring the staging blocks, made at
        the first step and kept: pinned host memory on CUDA (the block's
        gradients land there asynchronously), memory-mapped files in
        full-NVMe mode."""
        if self._grad_blocks is None:
            pin = self._cuda and not self._full_nvme
            shapes = [(b, li, n, tuple(blk[n].shape))
                      for b, blk in enumerate(self.host_blocks)
                      for li, n in enumerate(self._names)]
            flat = [None] * len(shapes) if self._full_nvme else host_buffers(
                [int(np.prod(sh)) for *_, sh in shapes], torch.float32, pin)
            bufs = [{} for _ in self.host_blocks]
            for (b, li, n, shape), buf in zip(shapes, flat):
                bufs[b][n] = torch.from_numpy(memmap_alloc(
                    self._nvme_dir, f"grad_block{b}_leaf{li}.bin",
                    np.float32, shape)) if self._full_nvme else buf.view(shape)
            self._grad_blocks = bufs
            self._edge_grads = [b.view(p.shape) for b, p in zip(
                host_buffers([p.numel() for p in self._edges], torch.float32,
                             pin), self._edges)]
        return self._grad_blocks

    def _land(self, dst: torch.Tensor, g: Optional[torch.Tensor],
              accumulate: bool) -> None:
        """A device gradient into its host fp32 buffer: copied (without
        waiting, into pinned memory) or added."""
        if g is None:
            if not accumulate:
                dst.zero_()
        elif accumulate:
            dst.add_(g.to("cpu", torch.float32))
        else:
            dst.copy_(g, non_blocking=self._cuda)

    def _micro_grads(self, x, labels, accumulate: bool):
        """One microbatch: the streamed forward, the loss, the
        reverse-streamed backward. Returns the loss; the body's and the
        edges' gradients land in the host fp32 buffers (added when
        accumulating)."""
        module, prefetch = self.module, self.prefetch
        nb = self.n_blocks
        with torch.no_grad():
            h = module.apply_prefix(x)
            boundaries = [h]
            slot = self._slot_of(0, prefetch)
            for b in range(nb):
                if b + 1 < nb and prefetch and \
                        b + 1 not in self._resident:
                    self._fetch(b + 1, 1 - slot, True)
                h = self._run_block(self._use(slot), h)
                self._release(slot)
                boundaries.append(h)
                self._mark()
                if b + 1 < nb:
                    if not prefetch and b + 1 not in self._resident:
                        self._fetch(b + 1, 1 - slot, False)
                    slot = 1 - slot
        # the loss and the suffix's (and tied modules') gradients
        h_last = boundaries[-1].detach().requires_grad_()
        loss = module.loss_fn(module.apply_suffix(h_last), labels).float()
        *g_suffix, g_h = torch.autograd.grad(loss, self._edges + [h_last],
                                             allow_unused=True)
        targets = self._grad_target_blocks()
        for b in reversed(range(nb)):
            slot = self._slot_of(b, prefetch)
            if b > 0 and prefetch and b - 1 not in self._resident:
                self._fetch(b - 1, 1 - slot, True)
            leaves = {n: t.detach().requires_grad_()
                      for n, t in self._use(slot).items()}
            hb = boundaries[b].detach().requires_grad_()
            with torch.enable_grad():
                out = self._run_block(leaves, hb)
            *g_block, g_h = torch.autograd.grad(
                out, [leaves[n] for n in self._names] + [hb],
                grad_outputs=g_h)
            self._release(slot)
            self._mark()
            for n, g in zip(self._names, g_block):
                self._land(targets[b][n], g, accumulate)
            del g_block, leaves, out
            if b > 0 and not prefetch and b - 1 not in self._resident:
                self._fetch(b - 1, 1 - slot, False)
        with torch.enable_grad():
            g_prefix = torch.autograd.grad(
                module.apply_prefix(x), self._edges, grad_outputs=g_h,
                allow_unused=True)
        for dst, a, c in zip(self._edge_grads, g_suffix, g_prefix):
            self._land(dst, a if c is None else c if a is None else a + c,
                       accumulate)
        return loss

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    @staticmethod
    def _as_xy(batch):
        if not isinstance(batch, dict):
            batch = {"inputs": batch[0], "labels": batch[1]}
        return torch.as_tensor(batch["inputs"]), torch.as_tensor(
            batch["labels"])

    def train_batch(self, batch=None, data_iter=None):
        """One optimizer step: ``gas`` microbatches (an iterator yields
        them; a batch carries the whole step and is split here), the host
        step, the new weights into the staging blocks and the edges."""
        t0 = time.perf_counter()
        self.last_peak_device_bytes = 0
        self.h2d_bytes = 0
        if self.track_device_memory and self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        if batch is None:
            micros = [self._as_xy(next(data_iter)) for _ in range(self.gas)]
        else:
            inputs, labels = self._as_xy(batch)
            n = inputs.shape[0]
            if n % self.gas != 0:
                raise ValueError(
                    f"batch leading dim {n} must be divisible by "
                    f"gradient_accumulation_steps={self.gas}")
            m = n // self.gas
            micros = [(inputs[g * m:(g + 1) * m], labels[g * m:(g + 1) * m])
                      for g in range(self.gas)]
        loss_sum = 0.0
        for g, (x, y) in enumerate(micros):
            loss = self._micro_grads(x.to(self.device), y.to(self.device),
                                     accumulate=g > 0)
            loss_sum += float(loss.detach())
        if self._cuda:
            # the last block's and the edges' copies to the host
            torch.cuda.synchronize(self.device)
        t_stream = time.perf_counter()
        grads_body = self._grad_target_blocks()
        grads_edges = self._edge_grads
        if self.gas > 1:
            for t in grads_edges:
                t.div_(self.gas)
            for blk in grads_body:
                for t in blk.values():
                    t.div_(self.gas)
        loss = loss_sum / self.gas if self.gas > 1 else loss.detach()
        # the optimizer's leaves: the body's (block by block, by name),
        # then the edges'; each new master goes into its bf16 target
        targets = [blk[n] for blk in self.host_blocks
                   for n in self._names] + self._edges_staging
        grads = [blk[n] for blk in grads_body for n in self._names] + \
            grads_edges

        def writeback(li, master):
            targets[li].copy_(master)

        _, overflow, self._last_grad_norm = self._host_opt.step(
            grads, loss_scale=self.loss_scale, writeback=writeback)
        if not overflow:
            with torch.no_grad():
                for p, s in zip(self._edges, self._edges_staging):
                    p.copy_(s, non_blocking=self._cuda)
            # the slots hold the old weights
            self._resident = [None, None]
        if self._cuda:
            torch.cuda.synchronize(self.device)
        self.global_steps += 1
        t_end = time.perf_counter()
        self.timings = {"stream": t_stream - t0, "host_step": t_end - t_stream,
                        "step": t_end - t0}
        return loss

    # ------------------------------------------------------------------
    # checkpoints: the host state as one npz a save (the JAX format)
    # ------------------------------------------------------------------

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        save_latest: bool = True):
        from ...checkpoint.manifest import atomic_write_text, write_manifest

        tag = tag or f"global_step{self.global_steps}"
        os.makedirs(save_dir, exist_ok=True)
        sd = self._host_opt.state_dict()
        arrays = {"step": np.asarray(sd["step"]),
                  "global_steps": np.asarray(self.global_steps)}
        for i, m in enumerate(sd["master"]):
            arrays[f"master_{i}"] = m.numpy()
        for mi, bank in enumerate(sd["moments"]):
            for li, buf in enumerate(bank):
                arrays[f"moment_{mi}_{li}"] = buf.numpy()
        # atomic: "latest" never points at a torn npz
        path = os.path.join(save_dir, f"{tag}.infinity.npz")
        with open(path + ".tmp", "wb") as f:
            np.savez(f, **arrays)
        os.replace(path + ".tmp", path)
        write_manifest(save_dir, tag, step=self.global_steps)
        if save_latest:
            atomic_write_text(os.path.join(save_dir, "latest"), tag)
        return True

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True, **_):
        from ...checkpoint.manifest import (CheckpointCorruptionError,
                                            list_tags, resolve_load_tag,
                                            verify_checkpoint)

        def has_npz(t):
            return os.path.exists(os.path.join(load_dir, f"{t}.infinity.npz"))

        # the walk back to the newest verified save takes Infinity saves
        # only
        tag = resolve_load_tag(load_dir, tag)
        if not has_npz(tag):
            candidates = [t for t in list_tags(load_dir) if has_npz(t) and
                          verify_checkpoint(load_dir, t)[0] in ("verified",
                                                                "legacy")]
            if not candidates:
                raise CheckpointCorruptionError(
                    f"no loadable ZeRO-Infinity checkpoint in {load_dir} "
                    f"(newest verified save {tag!r} is not an infinity npz)")
            tag = candidates[0]
        z = np.load(os.path.join(load_dir, f"{tag}.infinity.npz"))
        opt = self._host_opt
        n = len(opt.master)
        opt.load_state_dict({
            "step": int(z["step"]) if load_optimizer_states else 0,
            "master": [z[f"master_{i}"] for i in range(n)],
            "moments": [[z[f"moment_{mi}_{li}"] if load_optimizer_states
                         else np.zeros(opt.master[li].numel(), np.float32)
                         for li in range(n)]
                        for mi in range(len(opt._moments))]})
        # the working copies from the restored masters
        targets = [blk[name] for blk in self.host_blocks
                   for name in self._names] + self._edges_staging
        for t, m in zip(targets, opt.master):
            t.copy_(m.view(t.shape))
        with torch.no_grad():
            for p, s in zip(self._edges, self._edges_staging):
                p.copy_(s)
        self._resident = [None, None]
        self.global_steps = int(z["global_steps"])
        return load_dir, {"global_steps": self.global_steps}

    def get_global_grad_norm(self):
        return self._last_grad_norm
