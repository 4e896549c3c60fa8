"""ZeRO-Offload: the fp32 masters and the optimizer state in host memory
(or on NVMe).

Counterpart of ``deepspeed_tpu/runtime/zero/offload.py`` (``memmap_alloc``,
``HostOffloadOptimizer``), with its semantics kept exactly:

- the card holds only compute-dtype weights; its step computes the
  gradients and the loss, and no optimizer runs there;
- the fp32 masters and the Adam (or Adagrad) state live on the host as
  flat CPU tensors and are stepped by the SIMD kernels of
  ``csrc/host/`` at memory bandwidth (``ops/adam``, ``ops/adagrad``);
- the global norm is taken on the host a leaf at a time, an fp16 overflow
  (a non-finite norm) skips the step, the unscale and clip factor ``clip /
  (norm + 1e-6)`` scales the gradients in place, and the lr comes from the
  count before the increment;
- ``device: nvme`` spills the moments to disk through the async-IO handle
  between steps, fetching leaf i+1 and spilling leaf i-1 while leaf i
  steps (double-buffered handles), so host memory holds a few leaves'
  moments at a time;
- ``writeback`` hands each updated master to the caller a leaf at a time
  (the full-NVMe mode of ``runtime/zero/infinity.py``).

The leaves are a list in the caller's order (the JAX optimizer flattens a
pytree; the engines here pass their leaves in the JAX tree's order).
"""

import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops._host import host_tensor
from ...utils.logging import log_dist


def memmap_alloc(dir_: str, name: str, dtype, shape, init=None) -> np.memmap:
    """A disk-backed buffer (masters, body blocks and grad buffers of the
    full-NVMe mode all use it)."""
    os.makedirs(dir_, exist_ok=True)
    m = np.memmap(os.path.join(dir_, name), dtype=dtype, mode="w+",
                  shape=tuple(shape))
    if init is not None:
        m[...] = init
    return m


def _flat32(x) -> torch.Tensor:
    """A flat fp32 CPU tensor over ``x`` (a view where it is one)."""
    return host_tensor(x).reshape(-1)


def _flat(x) -> torch.Tensor:
    """A flat CPU tensor over ``x``: a contiguous bf16 / fp16 / fp32 CPU
    tensor as it is (a view), anything else as fp32."""
    if torch.is_tensor(x) and x.device.type == "cpu" and x.is_contiguous() \
            and x.dtype in (torch.bfloat16, torch.float16, torch.float32):
        return x.view(-1)
    return _flat32(x)


class HostOffloadOptimizer:
    """Host-side Adam/AdamW/Adagrad over the flattened leaves."""

    def __init__(self, leaves: Sequence, opt_type: str, opt_params: Dict,
                 offload_config=None, gradient_clipping: Optional[float] = None,
                 lr_scheduler: Optional[Callable] = None,
                 spill_masters_dir: Optional[str] = None):
        leaves = [l.detach().cpu() if torch.is_tensor(l) else np.asarray(l)
                  for l in leaves]
        self._shapes = [tuple(l.shape) for l in leaves]
        # spill_masters_dir (the full-NVMe mode of ZeRO-Infinity): the
        # masters live in memory-mapped files, which the SIMD kernel
        # updates in place and the OS pages to disk
        self._masters_dir = spill_masters_dir
        if spill_masters_dir is not None:
            self.master: List[torch.Tensor] = [
                torch.from_numpy(memmap_alloc(
                    spill_masters_dir, f"master_{li}.bin", np.float32,
                    (int(np.prod(shape)),),
                    init=np.asarray(torch.as_tensor(l).float()).ravel()))
                for li, (l, shape) in enumerate(zip(leaves, self._shapes))]
        else:
            # contiguous fp32 CPU tensors are taken over (the engines hand
            # over fresh host copies, so the masters never exist twice in
            # memory); anything else is copied
            self.master = [
                l.reshape(-1) if torch.is_tensor(l) and
                l.is_contiguous() and l.dtype == torch.float32 else
                torch.as_tensor(np.array(l) if isinstance(l, np.ndarray)
                                else l).to(torch.float32).reshape(-1).clone()
                for l in leaves]
        #: the fp32 widening of a bf16 / fp16 gradient leaf (``step``)
        self._scratch = torch.empty(0, dtype=torch.float32)
        self.clip = gradient_clipping
        self.lr_scheduler = lr_scheduler
        self.base_lr = float(opt_params.get("lr", 1e-3))
        self.step_count = 0

        kind = (opt_type or "adamw").lower()
        betas = tuple(opt_params.get("betas", (0.9, 0.999)))
        eps = float(opt_params.get("eps", 1e-8))
        wd = float(opt_params.get("weight_decay", 0.0))
        if kind == "adagrad":
            from ...ops.adagrad import DeepSpeedCPUAdagrad

            self._opt = DeepSpeedCPUAdagrad(self.master, lr=self.base_lr,
                                            eps=eps, weight_decay=wd)
            self._moments = [self._opt.sum_sq]
        elif kind in ("adam", "adamw", "fusedadam"):
            from ...ops.adam import DeepSpeedCPUAdam

            # adamw_mode for 'Adam' too, as the device path's FusedAdam
            # defaults adam_w_mode=True
            self._opt = DeepSpeedCPUAdam(self.master, lr=self.base_lr,
                                         betas=betas, eps=eps,
                                         weight_decay=wd, adamw_mode=True)
            self._moments = [self._opt.exp_avg, self._opt.exp_avg_sq]
        else:
            raise ValueError(
                f"offload_optimizer supports Adam/AdamW/Adagrad on the host "
                f"CPU kernels, got {opt_type!r}")
        self.master = self._opt.params

        self._nvme_dir = None
        if offload_config is not None and offload_config.device == "nvme":
            # a fixed default would let two optimizers clobber each other's
            # moment files
            self._nvme_dir = offload_config.nvme_path or tempfile.mkdtemp(
                prefix="ds_swap_")
            os.makedirs(self._nvme_dir, exist_ok=True)
            from ...ops.aio import aio_handle

            self._aio = aio_handle(num_threads=2)
            # two fetch and two spill handles alternate by leaf: leaf i+1's
            # reads and leaf i-1's writes run while leaf i steps
            self._fetch_aio = [aio_handle(num_threads=1) for _ in range(2)]
            self._spill_aio = [aio_handle(num_threads=1) for _ in range(2)]
            self._spill_all()
        log_dist(f"ZeRO-Offload: {len(self.master)} partitions, "
                 f"{sum(m.numel() for m in self.master) * 4 / 1e6:.1f} MB "
                 f"master, device="
                 f"{'nvme:' + self._nvme_dir if self._nvme_dir else 'cpu'}",
                 ranks=[0])

    # -- nvme spill ------------------------------------------------------

    def _moment_path(self, mi: int, li: int) -> str:
        return os.path.join(self._nvme_dir, f"moment{mi}_leaf{li}.bin")

    def _spill_all(self):
        """Write every moment buffer to disk and free the host copies."""
        for mi, bank in enumerate(self._moments):
            for li, buf in enumerate(bank):
                if buf is not None:
                    self._aio.async_pwrite(buf, self._moment_path(mi, li))
        self._aio.wait()
        for bank in self._moments:
            for li in range(len(bank)):
                bank[li] = None

    # -- step ------------------------------------------------------------

    def current_lr(self) -> float:
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self.step_count))
        return self.base_lr

    def step(self, grads: Sequence, loss_scale: float = 1.0,
             writeback: Optional[Callable] = None,
             bf16_out: Optional[List[torch.Tensor]] = None
             ) -> Tuple[Optional[List[torch.Tensor]], bool, float]:
        """One host optimizer step. Returns (the flat masters, overflow,
        grad norm); on an overflow nothing changes and the masters are
        None.

        ``writeback(li, master_view)``: the caller takes each updated leaf
        in place (the full-NVMe path) and the first return value is None.
        ``bf16_out``: per-leaf two-byte buffers that the kernel fills with
        the updated masters rounded to bf16 (the fused copy-back); a leaf's
        buffer may be its own bf16 gradient, which is read before it is
        written. Flat fp32 CPU gradients are scaled in place (they are the
        caller's per-step scratch); bf16 or fp16 ones are widened a leaf at
        a time into one fp32 scratch buffer, so the step holds no fp32
        copy of the model."""
        g_leaves = [_flat(g) for g in grads]
        narrow = max((g.numel() for g in g_leaves
                      if g.dtype != torch.float32), default=0)
        if narrow > self._scratch.numel():
            # kept across steps: a fresh buffer would fault in its pages
            # every step
            self._scratch = torch.empty(narrow, dtype=torch.float32)

        def as32(g):
            if g.dtype == torch.float32:
                return g
            return self._scratch[:g.numel()].copy_(g)

        sq = 0.0
        for g in g_leaves:
            f = as32(g).numpy()
            sq += float(np.dot(f, f))
        inv = 1.0 / loss_scale
        sq *= inv * inv
        if not np.isfinite(sq):
            return None, True, float("inf")
        norm = float(np.sqrt(sq))
        combined = inv
        if self.clip and norm > self.clip:
            combined *= self.clip / (norm + 1e-6)
        factor = torch.tensor(combined, dtype=torch.float32)
        # the lr from the count before the increment (optax's schedules)
        lr = self.current_lr()
        self.step_count += 1

        def step_leaf(li, moments):
            g = as32(g_leaves[li])
            if combined != 1.0:
                # fp32 x fp32, as numpy's in-place multiply (on every core)
                g.mul_(factor)
            out = None if bf16_out is None else bf16_out[li]
            if len(moments) == 2:
                # every leaf takes the same global step's bias correction
                self._opt.step_leaf(self.master[li], g, *moments,
                                    self.step_count, lr, out)
            else:
                self._opt.step_leaf(self.master[li], g, *moments, lr, out)

        if self._nvme_dir is None:
            for li in range(len(g_leaves)):
                step_leaf(li, [bank[li] for bank in self._moments])
        else:
            self._pipelined_nvme_step(len(g_leaves), step_leaf)
        if hasattr(self._opt, "step_count"):
            self._opt.step_count = self.step_count
        if writeback is not None:
            for li, (m, shape) in enumerate(zip(self.master, self._shapes)):
                writeback(li, m.view(shape))
            return None, False, norm
        return self.master, False, norm

    def _pipelined_nvme_step(self, L: int, step_leaf: Callable) -> None:
        """Double-buffered fetch -> step -> spill: leaf i+1's moment reads
        and leaf i-1's writes overlap leaf i's step; at most ~4 leaves'
        moments are in memory."""
        if L == 0:
            return

        def issue_fetch(li):
            h = self._fetch_aio[li % 2]
            for mi, bank in enumerate(self._moments):
                bank[li] = torch.empty(self.master[li].numel(),
                                       dtype=torch.float32)
                h.async_pread(bank[li], self._moment_path(mi, li))

        def issue_spill(li):
            h = self._spill_aio[li % 2]
            # this handle's previous spill must be durable before its
            # buffers are freed
            h.wait()
            if li >= 2:
                for bank in self._moments:
                    bank[li - 2] = None
            for mi, bank in enumerate(self._moments):
                h.async_pwrite(bank[li], self._moment_path(mi, li))

        issue_fetch(0)
        for li in range(L):
            self._fetch_aio[li % 2].wait()
            if li + 1 < L:
                issue_fetch(li + 1)
            step_leaf(li, [bank[li] for bank in self._moments])
            issue_spill(li)
        for h in self._spill_aio:
            h.wait()
        for bank in self._moments:
            for li in range(L):
                bank[li] = None

    def swap_io(self) -> Dict[str, float]:
        """The moment swap's IO so far (``device: nvme``): the bytes that
        the fetch handles read and the spill handles wrote, with each
        side's seconds in flight and blocked in ``wait``
        (``AsyncIOHandle``'s counts)."""
        out = {}
        for side, handles, done in (("read", self._fetch_aio, "bytes_read"),
                                    ("write", self._spill_aio,
                                     "bytes_written")):
            out[f"{side}_bytes"] = sum(getattr(h, done) for h in handles)
            out[f"{side}_inflight_s"] = sum(h.inflight_s for h in handles)
            out[f"{side}_wait_s"] = sum(h.wait_s for h in handles)
        return out

    # -- checkpoint ------------------------------------------------------

    def state_dict(self) -> Dict:
        if self._nvme_dir is not None:
            moments = []
            for mi, bank in enumerate(self._moments):
                rows = []
                for li in range(len(bank)):
                    buf = torch.empty(self.master[li].numel(),
                                      dtype=torch.float32)
                    self._aio.async_pread(buf, self._moment_path(mi, li))
                    self._aio.wait()
                    rows.append(buf)
                moments.append(rows)
        else:
            moments = self._moments
        return {"step": self.step_count, "master": self.master,
                "moments": moments}

    def reset_optimizer_state(self, master_leaves=None):
        """A fresh optimizer: every moment zeroed, the count 0; the masters
        overwritten from ``master_leaves`` when given (any float dtype, in
        leaf order, e.g. a universal checkpoint's fp32 arrays)."""
        if master_leaves is not None:
            for dst, src in zip(self.master, master_leaves):
                dst.copy_(_flat32(src))
        self.step_count = 0
        if hasattr(self._opt, "step_count"):
            self._opt.step_count = 0
        for bank in self._moments:
            for li in range(len(bank)):
                if bank[li] is None:  # nvme: spilled
                    bank[li] = torch.zeros(self.master[li].numel(),
                                           dtype=torch.float32)
                else:
                    bank[li].zero_()
        if self._nvme_dir is not None:
            self._spill_all()

    def load_state_dict(self, sd: Dict):
        self.step_count = int(sd["step"])
        for dst, src in zip(self.master, sd["master"]):
            dst.copy_(_flat32(src))
        for dbank, sbank in zip(self._moments, sd["moments"]):
            for li, src in enumerate(sbank):
                src = _flat32(src)
                if dbank[li] is None:  # nvme: spilled
                    dbank[li] = src.clone()
                else:
                    dbank[li].copy_(src)
        if hasattr(self._opt, "step_count"):
            self._opt.step_count = self.step_count
        if self._nvme_dir is not None:
            self._spill_all()
