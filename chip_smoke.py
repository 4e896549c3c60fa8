"""Drive deepspeed_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every kernel under deepspeed_tpu_torch/csrc, compiled with nvcc
   in parallel (one process per source);
3. kernel parity: each kernel's wrapper against its plain PyTorch version
   on the same inputs at its main path's shapes (and a few more), with
   times (CUDA events, median of 25 runs after warm-up, the L2 cache
   flushed before each run as the step finds it cold), the bound (the
   larger of bytes / 3.35 TB/s and FLOPs over the type's peak) and, where
   one PyTorch call computes the same function, that call's time:
   K6 ragged paged attention at the serving step's shapes; K7a paged
   decode attention (B 8, H 32, Hkv 8, D 128, 1024 pages of 16 tokens, a
   table 128 wide, seeded contexts up to 2048, bf16, plus an int8 pool, a
   window, idle sentinel rows and fp32; K6's and K7a's lines name the
   route, tensor or CUDA cores, the grid and the key splits, the achieved
   GB/s and the share of the bound) and K7b paged chunked-prefill
   attention (B 1, T 64 on the same pool: chunk_start 0, mid-prompt,
   behind a 512-token prefix, a padded tail, int8, window) of the
   two-program serving engine; K1/K2 flash attention forward, dQ and
   dK/dV at the training step's (B 8, H 16, T 1024, D 64, bf16, causal),
   with gradients through the autograd function, and K1's masked,
   GQA-native forward at the generate prefill's shapes (B 8, T 512, H 32,
   Hkv 8, D 128, bf16, left-padded masks) and at a bucketed serving
   prompt (B 1, T 1024), and non-causal at BERT-Large's heads (16 of 64,
   bf16) at 64 x 128 and 16 x 512; K3 fused Adam over the whole Llama-400M parameter list; K4
   decode attention at the generate step's shapes (B 8, H 32, Hkv 8,
   D 128, cache 576, bf16, left-padded key masks) and an int8 cache, a
   window, an fp32 case and caches of 2048 and 8192 (each with its split
   count); K5 quantized matmul at Llama-3-8B projection shapes (decode
   M 8 at every projection shape and M 1 at up, prefill M 4096 at the q,
   up and down shapes, int8 per-column and int4 group 64) plus fp32
   cases (the fp32 decode kernel, gemv_tf32, at 8 x 4096 -> 4096 int4 g64,
   int8 and odd N 4099, each also replayed in a CUDA graph) and ragged
   cases (rows TMA cannot address: 264 -> 1000 at M 8 and 37,
   4100 -> 14330 at M 8 int8 and M 512 int4 in groups of 100, asserting
   one ragged-kernel launch each), each with the kernel route it took
   (the decode and ragged kernels' tiles and cluster size), its GB/s and
   share of the bound; K8 per-column int8 matmul (decode up and down, q
   and up prefill, fp32 prefill and decode, a wide ragged decode); K9
   block-sparse attention forward, dQ and dK/dV at the long-context
   path's main shape (B 1, T 16384, H 32, D 128, bf16, causal, block 128,
   BSLongformer and BigBird, the plain versions head by head) and at
   T 4096 / 8192, fp32 D 64 block 64, non-causal BigBird and a per-head
   Fixed layout, with FlexAttention (compiled, on a BlockMask from the
   layout; main shape only) and SDPA with the layout's bool mask as
   yardsticks, and the size of the bf16 kernels' work lists; and GPT-2
   125M's shapes (12 heads of 64, no GQA; the ``gpt2_*`` cases): K6 on
   every packed case, K7a at contexts up to 1024, K7b behind a 512-token
   prefix, the masked K1 at the generate prefill, K4 at cache 576, K5 at
   the decode projections (768 -> 2304, 768 -> 3072, 3072 -> 768) and the
   768 -> 3072 prefill, int8;
4. small references: a 2-layer fp32 model served with K6 (and K5, with
   int8 weights), with their plain versions and captured as CUDA graphs
   at bucketed widths (identical tokens), served
   through the two-program engine with K7a/K7b (chunked, with the prefix
   cache) and with K7a and the masked K1 (monolithic prefill) and with
   their plain versions (identical tokens), generating with K4/K5 and with
   their plain versions (identical tokens; fp32, int8 and int4 weights,
   int8 cache, window 64, and the masked K1 prefill; fp32 and int8 also
   with the decode step captured), and
   trained (captured) 5 steps in fp32 and 10 in fp16 from a loss scale
   that overflows, with K1/K2/K3 and with their plain versions (losses
   within 1e-4 relative, the same skipped steps and loss scale);
5. serve: init_inference + ServingEngine on full-width Llama-3-8B (random
   bf16 weights from a seed, all 32 layers), 16 seeded requests to
   completion, in turns: uncaptured, captured (enable_cuda_graph), both
   again at bucketed widths (mixed_step_buckets), then each captured
   engine again with its graphs warm; asserts every request finished, no
   logit was flagged, no page leaked, every captured run repeated its
   width's uncaptured tokens, and K6 ran once per layer per mixed step
   (counted on the device, replays included); a width witness holds K6
   to the same rows at a narrow packed width and at 263, bit for bit,
   and prints the layer-0 projections' and LM head's differences; then
   the two-program engine (mixed_step=False) on the same model and
   weights: 16 seeded requests, 4 shared 512-token prefixes x 4, suffixes
   64-512, 32-64 new tokens, with the prefix cache and 64-token chunks
   under a 256-token budget (asserts >= 12 prefix hits, K7a launched 32 x
   decode forwards, K7b 32 x chunk forwards, K6 never), then the same
   requests without the cache through the monolithic bucketed prefill
   with prefill_flash_from_empty (asserts the masked K1 launched 32 x
   prefills); each of the two again with enable_cuda_graph (the decode,
   chunk and monolithic forwards replayed as CUDA graphs: the same tokens,
   no leaked page, and, counted on the device over a replayed run, K7a
   and K7b or the masked K1 once per layer per forward; each run's last
   decode_mbu / decode_mfu gauges printed and held in (0, 1.05]);
   robustness and accounting on the same weights: (a) the captured
   unified serve under a 2 s step watchdog with the flight recorder
   armed, in turns with the same captured engine unguarded (identical
   tokens, no trip, no dump, the same graphs; the mean steps, the guard's
   host cost, the mixed_mbu / mixed_mfu gauges on the H100's peaks and
   perf_summary()'s program table printed); (b) chaos on both engines,
   captured (a slow_step past a 0.5 s budget, a corrupt_logits of each
   tag, a flaky_prefill): every request terminal with the expected finish
   reasons, one trip, two quarantines, no leaked page, a fresh request
   served, the graphs unchanged, one flight dump per firing naming its
   request; (c) the serve with TTFT and TPOT SLOs at (a)'s p50s: the
   verdicts sum to the requests; (d) spec serve: speculative decoding
   (4 prompt-lookup drafts a verify row) on the unified engine, captured
   at bucketed widths, over the 16 requests plus 8 whose 256-1024 token
   prompts repeat a 64-token segment: after a 2-layer fp32 reference
   (speculation off, prompt lookup and an oracle drafter: identical
   tokens, every oracle draft accepted), the uncaptured and captured 8B
   runs (identical tokens), then speculation off and on in turns; every
   request finished, no page leaked, verify rows packed, no width outside
   the bucket set, K6 once per layer per step (device count); tokens/s,
   mean step, steps, TTFT p50, accept rate and tokens per verify row
   printed for each run; (e) kv tier: the host KV tier on a 320-page
   pool, 8 distinct 1024-token prefixes asked twice, so the first
   round's are demoted into a 512-page (1 GiB) pinned host tier and
   promoted back; with the tier, with ``sync_promote`` and without the
   tier (recompute), captured, and once through the two-program engine
   uncaptured (K7a/K7b); host hits in each tiered second round, every
   promoted page equal to its demoted payload bit for bit, both tiers
   consistent, no page leaked, no graph captured again, the pool's
   ``data_ptr``s unchanged; demotion ms and GB/s a wave, promotion ms
   and GB/s and the second round's TTFT p50 printed (``kv tier {...}``
   JSON lines);
6. generate: init_inference + InferenceEngine.generate on full-width
   Llama-3-8B (random bf16 weights from seed 0), batch 8, left-padded
   prompts of seeded lengths 128-512 (bucket 512), 64 greedy new tokens,
   once with bf16 weights, once with quantize_weights="int8" (uncaptured,
   then with the decode step captured: identical tokens, both decode-step
   times printed, the capturing warm-up's launches K4 2 x 32 and gemv_tc
   2 x 7 x 32, the replayed run's none) and once with bf16 weights and
   prefill_flash_from_empty; asserts the output
   shape, finite logits, K4 launched 32 x 63 times, with int8 weights K5
   launched 7 x 32 x 64 times (7 x 32 of them, the prefill's, on the
   wgmma kernel, and 7 x 32 x 63, the decode steps', on the gemv_tc
   kernel), and with the flag the masked K1 launched 32 times;
7. train: initialize + train_batch on full-width Llama-400M (random
   weights from seed 0, all 24 layers), the JAX package's bench config
   (batch 8 x 1024, AdamW, bf16, clipping 1.0), uncaptured
   (cuda_graph=False) and captured (the step one CUDA graph), 2 warm-up
   steps each, then 5 timed steps each in turns (uncaptured, captured,
   captured, uncaptured), then one profiled step each; prints step ms,
   tokens/s, model TFLOP/s, idle share and peak memory per route; asserts
   identical, finite, falling losses on the two routes and, counted on
   the device over one profiled step of each, K1 48 (forward and
   recompute), K2 24 + 24 and K3 1 (the captured step's in its replay);
   (d) each route's train_mfu gauge in (0, 1.05] and, over 5 more steps
   each waited for, its train_tflops_per_chip (each step's device time)
   within 5% of the hand count over the host's wall time of the same
   steps;
7b. train subset: the rest of the training path on the same Llama-400M
   cut to 12 of its 24 layers (bench config, captured): (a) micro-batch 8 x 1024, gas 8, under the
   remat policies and losses of bench.py's leading candidates (nothing;
   dots; dots with loss_chunk 2048; offload_dots_no_batch with
   loss_chunk 2048), 2 warm-up + 3 timed steps and one profiled step
   each: step ms, tokens/s, model TFLOP/s, peak memory and idle share per
   route; asserts nothing's step-1 loss equals dots' bit for bit, the
   chunked loss within 1e-3 of the plain one, finite falling losses, the
   chunked loss >= 0.5 GB below the plain loss's peak, offload's peak
   below dots', and K1 2 x 24, K2 24 + 24 per micro-batch and K3 once a
   step (device counts); (b) right-padded micro-batches (pads 0-512 from
   seed 1, labels -100): 5 steps uncaptured, 5 captured, identical
   falling losses, K1/K2 never, K3 once a step (the plain attention
   under the padding bias); (c) progressive layer drop (theta 0.5, gamma
   0.1): 20 replays of one graph, theta on the device count within 1e-6
   of the host formula, gates that change between replays, keep rates
   within 4 sigma of p_l, K1 48 a replay; (d) a 4 x 4096 MLP, batch
   4096, through training_data (DeepSpeedDataLoader), a loss_fn drawing
   dropout from the engine's generator and csv_monitor, with the
   config's AdamW (K3 once a step) and a client AdamW(capturable=True)
   (K3 never): captured losses equal uncaptured ones, the CSV files carry
   the JAX engine's event names;
8. checkpoint: train -> save -> resume -> serve on the same Llama-400M at
   the bench config, captured: engine A (seed 0) takes 2 steps, saves
   (``save_checkpoint``: a universal directory under the JAX
   ``TrainState``'s leaf names, the client state, a verified manifest,
   ``latest``), then 3 more; engine B (seed 1) takes a step, loads the
   save and takes the same 3 steps. Asserts B's losses equal A's bit for
   bit, the same global steps, skipped steps and lr, every tensor B's
   graph reads at its old address and one graph, K3 once per replay
   (counted on the device), and B's masters right after the load equal
   ``zero_to_fp32`` of the save. Then B's weights are written as bf16
   (``save_pytree``) and 8 seeded requests are served through
   ``init_inference(checkpoint=...)`` on the captured unified engine:
   tokens identical to ``params=`` B's weights, K6 once per layer per
   mixed step (counted on the device). Fails (never skips) when the
   temporary directory cannot hold the save (~6 GB); removes it at the
   end. Prints one ``checkpoint {...}`` JSON line (state GB, save,
   manifest, load and verify seconds, save and load GB/s);
9. long context: ``ops.sparse_attention.sparse_attention`` forward and
   backward (loss ``(out * dout).sum()``) at T 4096, 8192 and 16384, 32
   heads of 128, bf16, causal, BSLongformer and BigBird at block 128 (the
   layouts of the JAX package's tools/bench_longctx.py), beside causal
   flash attention on the same q/k/v; asserts finite gradients and the
   launch counts (K9 6 x each kernel, K1/K2 once per yardstick), then
   prints one ``long context {...}`` JSON line per length with
   bench_longctx's fields, the backward times and the host time of one
   forward call;
10. hf inject: module injection from HF models and HF checkpoint
   directories (nothing downloaded; seeded random weights built from HF
   config classes). (a) The serve phase's Llama-3-8B weights (seed 0,
   bf16) written under HF's names as an HF directory (``config.json``,
   8 safetensors shards of at most 2 GiB, the index) in a temporary
   directory, then ``init_inference(checkpoint=dir, dtype=bfloat16)`` and
   the serve phase's 16 requests on the unified engine: the uncaptured
   serve's tokens and finish reasons, K6 once per layer per mixed step,
   no page leaked, the host's resident set while loading under 8 GiB
   above its start (sampled every 2 ms); prints the load's seconds and
   GB/s (a warm read: the files were just written), the resident set,
   ``ru_maxrss`` and the device peak; fails (never skips) when the
   temporary directory cannot hold the weights, and removes it. (b) An
   HF ``LlamaForCausalLM`` at Llama-3-8B's widths with 2 layers, fp32, on
   the card, through ``init_inference(hf_model)``: logits within 1e-4 of
   HF's. (c) An HF ``GPT2LMHeadModel(GPT2Config())`` (GPT-2 125M, 12
   heads of 64) through ``init_inference(hf_model)``: fp32 greedy tokens
   equal to HF's ``generate`` (4 prompts of 64, 16 new); ``generate`` at
   the generate phase's shapes with bf16 weights, int8 weights and the
   flash prefill (K4 12 x 63, K5 4 x 12 x 64 with int8 weights, the
   masked K1 12); the unified engine (16 requests, prompts 64-960) and
   the two-program engine with the prefix cache (4 x 4 on 512-token
   prefixes, suffixes 64-448), both at 1024 positions: every request
   finished, no page leaked, K6 / K7a / K7b once per layer per forward,
   >= 12 prefix hits; tokens/s, TTFT and mean step printed;
11. generic families: the generic transformer (``models/transformer.py``)
   and ``DeepSpeedTransformerLayer`` at full width, nothing downloaded
   (configs from ``transformers``' config classes, seeded random weights).
   (a) Pythia-6.9B (EleutherAI pythia-6.9b's GPT-NeoX widths, all 32
   layers, bf16, through ``HFGPTNeoXLayerPolicy``'s config) generates at
   the generate phase's shapes uncaptured, with the decode step captured
   and with ``prefill_flash_from_empty``: K4 32 x 63 and the masked K1 32
   launched, the captured run's tokens equal to the uncaptured run's, the
   flash run's prefill logits within 0.125 of the plain run's (first tokens
   equal but at near ties), the decode step's ms printed. (b) OPT (opt-6.7b), BLOOM (bloom-7b1),
   GPT-NeoX (pythia-6.9b), BERT (bert-large-uncased), GPT-Neo
   (gpt-neo-2.7B), GPT-J, Phi and Falcon (at the widest widths the
   kernels take, which the line names), 2 layers in fp32 through
   ``init_inference(hf_model)``: logits within 1e-4 of HF's, greedy
   tokens equal to HF's ``generate`` for the causal families (4 prompts
   of 64, 16 new), K4 launched exactly where the config is eligible. (c)
   BERT-Large MLM (``TransformerForMaskedLM``) on LAMB, bf16, clipping
   1.0, 15% of positions labelled, at 64 x 128 and 16 x 512, unpadded
   (the non-causal K1/K2), uncaptured and captured (equal losses), then
   right-padded with BERT's dropouts 0.1 (the plain attention): finite
   falling losses, per step K1 24, K2 24 + 24 (none padded) and K3 once
   (device counts); step ms, samples/s, model TFLOP/s and peak memory
   printed. (d) 24 ``DeepSpeedTransformerLayer``s (BERT-Large, pre-LN,
   ``fp16``), the twin of the JAX package's tools/bench_bert_layer.py, at
   (128, 64) and (512, 16), with the bench's all-ones mask and without a
   mask (K1/K2): ``bert layer {...}`` JSON lines with its TFLOP/s. (e) The
   legacy quantization on Llama-3-8B (the serve phase's weights):
   ``quantize=True`` generate with and without ``dequant_per_step``,
   uncaptured and captured, the captured unified engine and the
   two-program engine (K6, K7a/K7b once per layer per forward, no page
   leaked), each run's tokens equal to a bf16 engine's on
   ``dequantize_params(quantize_params(w))``; peak memory and mean step
   printed beside the bf16 engine's; then the serving families
   (``check_families``: Gemma-7B and Qwen2-7B on both engines, PR 22);
12. megatron: Megatron-LM's GPT-345M (24 layers, hidden 1024, 16 heads of
   64, 1024 positions, vocabulary 50304) with random bf16 weights under
   Megatron's names, written as two TP shards (``mp_rank_00`` /
   ``mp_rank_01``, version 2.0) and loaded through
   ``MegatronLayerPolicy.from_megatron_checkpoint`` onto the generic
   decoder with ``prefill_flash_from_empty``: ``generate`` at batch 8,
   prompts 128-512, 32 greedy new tokens; the weights and tokens equal
   those of the model converted from the unsharded state dict; K4 24 x 31
   and the masked K1 24 launched;
13. mixtral: Mixtral-8x7B at full width, 8 of its 32 layers (random bf16
   weights, 23.6 GB), through ``init_inference`` -> ``generate`` with the
   flash prefill, batch 8, prompts 128-512, 32 greedy new tokens,
   uncaptured and captured (identical tokens; K4 8 x 31, the masked K1 8);
   the cached decode against a full forward (bf16, positions whose
   routing flipped at a near-tie counted and left out); the two MoE
   routes on layer 0 at T 1 against each other; the decode step with each
   route (touched experts, JAX's rule; dense, forced) at B 1 and B 8,
   captured; prefill ms, decode step ms and peak memory printed;
14. moe train: (a) Mixtral-8x7B widths at 2 layers, 1 x 2048 tokens, AdamW
   in bf16, captured: 5 steps, K1 2 x 2 x 2, K2 2 x 2 + 2 x 2 and K3 2 in
   the first (eager warm-up and capture), K1 4 / K2 2 + 2 / K3 1 on the
   device in a replay, finite losses, a positive aux term; step ms, model
   TFLOP/s and peak memory printed; (b) two ``moe.MoE`` layers at
   DeepSpeed-MoE 350M+MoE-128's widths (hidden 1024, FFN 4096, 128
   experts, capacity factor 1.0), 8192 tokens a step, with k 1 (RTS) and
   k 2, captured: ``exp_counts`` summing to k x tokens, no expert over its
   capacity, finite losses, K3 once a replay;
15. host ops: the host libraries (``csrc/host/``, built with g++ beside
   the kernels) on one 4096 x 14336 fp32 leaf: the SIMD AdamW step (with
   its bf16 output) and Adagrad step against their plain versions (max
   error within 1e-6 of the largest value), timed beside them with the
   host's torch copy rate as the bound; the aio handle's pwrite / pread
   (O_DIRECT) beside a plain write / read of the same bytes;
16. offload train: Llama-3-8B's widths through ``initialize`` ->
   ``train_batch`` with ``offload_optimizer: cpu`` (AdamW on the host,
   stage 2, bf16, clipping 1.0, 1 x 2048 tokens, the ``dots`` remat, the
   device grad step captured): all 32 layers if the host holds 14 bytes a
   parameter, else the deepest whole-layer cut that fits (printed); 3
   steps, finite falling losses, the first loss equal to the same grad
   step run uncaptured, one leaf's new master equal to the plain AdamW's,
   K1 4L / K2 2L + 2L in the first step and K1 2L / K2 L + L on the device
   in a replay, K3 none; the step split (grad step, D2H, host step, H2D),
   the copies' GB/s, the host step's GB/s, the device peak (under 80 GB)
   and the resident set printed;
17. infinity: ``ZeroInfinityEngine`` through ``initialize`` on a
   ``PipelineModule`` (embedding, N Llama-3-8B-width decoder layers, the
   head) with ``offload_param: cpu`` in blocks of 2 at N 4 and N 8: steps
   with and without the copy stream's prefetch, a block's H2D GB/s, the
   device peak at N 8 within 5% of N 4's, K1 2N / K2 N + N a step; then
   one full-NVMe step at N 4 on the local disk (the swap files' bytes,
   the moments' bytes each way counted at the aio handles, a lower bound
   on their GB/s);
18. a ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and last the
   ``{"ok": true, "device": {...}}`` line. A kernel's ``launches`` are its
   wrapper's count over its path's uncaptured run (a wrapper counts where
   it launches; a graph replays its kernels without it), except K6's,
   counted on the device with the replays. Where a path also ran
   captured, ``graph_launches`` are the kernels' runs counted on the
   device over its replays: K1/K2/K3 in one replayed training step plus
   the train subset's captured routes (``graph_launches_by_phase``),
   K7a/K7b and the masked K1 in the two-program engines' replayed
   re-serves (item 5); ``hf_inject_launches`` are the wrappers' counts
   of each hf inject run that ran the kernel (GPT-2's at head dim 64);
   ``spec_serve_launches`` and ``kv_tier_launches`` are K6's, K7a's and
   K7b's wrapper counts over those phases' uncaptured runs (item 5 (d),
   (e)) and, for K6, its device runs over all their runs;
   ``generic_launches`` are the wrappers' counts of each generic families
   run that ran the kernel (item 11); ``megatron_launches``,
   ``mixtral_launches`` and ``moe_train_launches`` those of items 12-14,
   ``offload_launches`` (the first step's) and ``infinity_launches`` (by
   run) those of items 16-17. Each of these kernels adds one to its device count
   (``deepspeed_tpu_torch/ops/_runs.py``) when it runs.

Exits non-zero without printing a result when no CUDA device is present.
"""

import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12        # H100 SXM dense TF32 tensor-core peak

# the serving step's attention shapes: Llama-3-8B heads, the ServingEngine
# below (8 slots, 16-token pages, 1024 pages, 2048-token rows, a packed
# batch of 8 - 1 + 256 tokens)
H, HKV, D, BS = 32, 8, 128, 16
N_PAGES, R, NB = 1024, 8, 2048 // 16
T_PACKED = 8 - 1 + 256


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


L2_FLUSH_BYTES = 256 << 20     # over 5x the H100's 50 MB L2
SPIN_CYCLES = 10_000_000       # ~5 ms of device time at the H100's clocks


def cuda_time_ms(fn, reps=25, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn()``, each after a
    write of ``L2_FLUSH_BYTES`` that evicts the inputs from L2, so the
    time and an HBM bound measure the same memory level. A spin on the
    device after the flush keeps it busy while the host runs the wrapper
    up to its launch, so the interval holds device time, not the
    wrapper's host time (a plain version whose host time is longer still
    shows it)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops, flop_rate):
    """``(ms, "bytes" | "operations")``: the larger of the two floors."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


# ---------------------------------------------------------------------------
# kernel K6: ragged paged attention
# ---------------------------------------------------------------------------

def paged_route(q, k_pages):
    """The route K6 / K7a / K7b take for these inputs: a function of q's
    type (bf16 q over a bf16 or int8 pool runs on the tensor cores)."""
    return "tensor cores" if q.dtype == torch.bfloat16 else "CUDA cores"


def achieved(bound_ms, bound_by, ms):
    """The achieved memory rate and the share of the bound, as printed."""
    gbps = f"{bound_ms / ms * HBM_BYTES_PER_S / 1e9:.0f} GB/s, " \
        if bound_by == "bytes" else ""
    return f"{gbps}{100 * bound_ms / ms:.1f}% of the bound"


def pool_shape(bs):
    """``(pages, table width)`` of a pool of ``bs``-token pages holding the
    serving cell's ``N_PAGES * BS`` tokens, its rows ``NB * BS`` keys."""
    return N_PAGES * BS // bs, -(-NB * BS // bs)


def ragged_case(rows, int8, seed, device="cuda", heads=(H, HKV, D), bs=BS,
                dtype=torch.bfloat16):
    """A pool and packed batch on ``device``. ``rows``: R entries of
    ``(query_len, chunk_start)`` (query_len 0 = idle row; decode rows are
    ``(1, context - 1)``). Every row owns distinct pages covering its
    context; the rest of its table is the sentinel (the pool's page
    count). The packed batch is padded to ``T_PACKED`` tokens that no row
    claims. ``heads``: (query heads, kv heads, head dim), Llama-3-8B's by
    default; pages of ``bs`` tokens (:func:`pool_shape`); q and a float
    pool in ``dtype``."""
    Hq, Hkv, Dh = heads
    n_pages, nb = pool_shape(bs)
    assert len(rows) == R
    g = torch.Generator(device=device).manual_seed(seed)
    bt = torch.full((R, nb), n_pages, dtype=torch.int32)
    qs, ql, cs, cl = (torch.zeros(R, dtype=torch.int32) for _ in range(4))
    perm = np.random.RandomState(seed).permutation(n_pages)
    used = cursor = 0
    for r, (n, start) in enumerate(rows):
        if n == 0:
            continue
        pages = -(-(start + n) // bs)
        bt[r, :pages] = torch.from_numpy(perm[used:used + pages].astype(np.int32))
        used += pages
        qs[r], ql[r], cs[r], cl[r] = cursor, n, start, start + n
        cursor += n
    assert cursor <= T_PACKED and used <= n_pages
    shape = (n_pages, Hkv, bs, Dh)
    if int8:
        k = torch.randint(-127, 128, shape, generator=g, device=device,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=device,
                          dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=g, device=device) / 64
        vs = torch.rand(shape[:3], generator=g, device=device) / 64
    else:
        k = torch.randn(shape, generator=g, device=device, dtype=dtype)
        v = torch.randn(shape, generator=g, device=device, dtype=dtype)
        ks = vs = None
    q = torch.randn((T_PACKED, Hq, Dh), generator=g, device=device,
                    dtype=dtype)
    desc = [t.to(device) for t in (bt, qs, ql, cs, cl)]
    return (q, k, v, *desc), dict(k_scale=ks, v_scale=vs)


def ragged_bound(args, kw, window):
    """``(ms, "bytes" | "operations")``: least time for the function on
    these inputs: the larger of the bytes it must move (each visible K/V
    page once per kv head, at the pool's page size, scales, the q rows that
    some row claims, the whole output, descriptors) over HBM bandwidth and
    its FLOPs (QK^T and PV over visible keys) over the peak of q's type."""
    q, k, v, bt, qs, ql, cs, cl = args
    Hq, Hkv, bs, Dh = q.shape[1], k.shape[1], k.shape[2], k.shape[3]
    elem = k.element_size()
    page_bytes = Hkv * bs * Dh * elem * 2 + (Hkv * bs * 4 * 2
                                             if kw["k_scale"] is not None
                                             else 0)
    token_bytes = Hq * Dh * q.element_size()
    nbytes = (int(ql.sum()) + q.shape[0]) * token_bytes \
        + 4 * (bt.numel() + 4 * R)
    flops = 0
    for n, start, clen in zip(ql.tolist(), cs.tolist(), cl.tolist()):
        if n == 0 or clen == 0:
            continue
        lo = 0 if window is None else max(0, start - window + 1)
        nbytes += (-(-clen // bs) - lo // bs) * page_bytes
        pos = np.arange(start, start + n)
        first = pos - (window - 1) if window is not None else 0 * pos
        keys = np.minimum(pos, clen - 1) - np.maximum(first, 0) + 1
        flops += int(keys.sum()) * Hq * Dh * 4
    return bound(nbytes, flops, BF16_FLOP_PER_S
                 if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S)


RAGGED_CASES = {
    # 8 decode rows, contexts up to 2048
    "decode8": [(1, c - 1) for c in (2048, 1536, 1024, 777, 512, 300, 64,
                                     17)],
    # 7 decode rows + one 256-token chunk at chunk_start 512 (the serving
    # step's mixed shape)
    "mixed": [(1, c - 1) for c in (2048, 1200, 900, 640, 333, 128, 40)]
    + [(256, 512)],
    # prefill chunks only
    "chunks": [(128, 0), (0, 0), (128, 896), (0, 0), (0, 0), (0, 0),
               (0, 0), (0, 0)],
    # idle rows between live ones, sentinel tails, unclaimed padding
    "idle_sentinel": [(0, 0), (1, 99), (0, 0), (40, 1000), (0, 0),
                      (1, 15), (0, 0), (3, 2040)],
}


#: K6's variants: (int8 pool, window, (query heads, kv heads, head dim)[,
#: page size, dtype of q and a float pool]); gpt2_d64 has GPT-2 125M's
#: heads (12 of 64, no GQA); the rest of the JAX kernel's domain:
#: Gemma-7B's (16 of 256) and Gemma-2B's (8 of 256 on 1) heads, Qwen2-7B's
#: group of 7 (28 on 4), Phi-2's D 80, GPT-NeoX-20B-like D 96 at a group
#: of 8, fp32 and int8 at D 256, pages of 8, 32 and 24
RAGGED_VARIANTS = {"bf16": (False, None, (H, HKV, D)),
                   "int8": (True, None, (H, HKV, D)),
                   "window256": (False, 256, (H, HKV, D)),
                   "gpt2_d64": (False, None, (12, 12, 64)),
                   "gemma7b_d256": (False, None, (16, 16, 256)),
                   "qwen2_7b_g7": (False, None, (28, 4, 128)),
                   "gemma2b_d256_g8": (False, None, (8, 1, 256)),
                   "d80": (False, None, (32, 32, 80)),
                   "d96_g8": (False, None, (64, 8, 96)),
                   "fp32_d256": (False, None, (16, 16, 256), BS,
                                 torch.float32),
                   "int8_d256": (True, None, (16, 16, 256)),
                   "bs8": (False, None, (H, HKV, D), 8),
                   "bs32": (False, None, (H, HKV, D), 32),
                   "bs24": (False, None, (H, HKV, D), 24)}


def parity_tolerance(dtype):
    """``(rtol, atol)`` of a paged kernel against its plain version: fp32
    1e-5 (summation order only); bf16 one bf16 ulp (both are bf16 roundings
    of fp32 results that differ only in summation order)."""
    return (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-3)


def check_ragged_attention():
    """K6 against its plain version on every ``RAGGED_VARIANTS`` variant
    at every ``RAGGED_CASES`` case. Tolerance: :func:`parity_tolerance`
    (bf16: |kernel - plain| <= 2**-7 * |plain| + 1e-3)."""
    from deepspeed_tpu_torch.ops.decode_attention import _sm_count
    from deepspeed_tpu_torch.ops.ragged_attention import (
        launch_params, ragged_paged_attention, ragged_paged_attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for variant, (int8, window, heads, *rest) in RAGGED_VARIANTS.items():
        bs, dtype = (list(rest) + [BS, torch.bfloat16][len(rest):])[:2]
        rtol, atol = parity_tolerance(dtype)
        for name, rows in RAGGED_CASES.items():
            args, kw = ragged_case(rows, int8, seed=len(results) + 1,
                                   heads=heads, bs=bs, dtype=dtype)
            kw = dict(kw, window=window)
            got = ragged_paged_attention(*args, **kw)
            ref = ragged_paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            ok = bool((err <= rtol * ref.float().abs() + atol).all()) and \
                bool(torch.isfinite(got).all())
            ms = cuda_time_ms(lambda: ragged_paged_attention(*args, **kw))
            plain_ms = cuda_time_ms(
                lambda: ragged_paged_attention_plain(*args, **kw), reps=5,
                warmup=1)
            bound, bound_by = ragged_bound(args, kw, window)
            key = f"{variant}/{name}"
            results[key] = dict(max_abs_err=float(err.max()), ms=ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=bound_by)
            lp = launch_params(T_PACKED, R, args[3].shape[1], bs, heads[1],
                               _sm_count(0))
            log(f"parity ragged_paged_attention {key} (H {heads[0]} Hkv "
                f"{heads[1]} D {heads[2]} pages of {bs} "
                f"{str(dtype)[6:]}): ok={ok} "
                f"max_abs_err={float(err.max()):.3e} (tolerance "
                f"{rtol:g}*|plain|+{atol:g}) kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} "
                f"({bound_by}) | route {paged_route(args[0], args[1])}, "
                f"grid up to {lp['grid']} blocks, {lp['splits']} splits of "
                f"{lp['per']} 64-key tiles | {achieved(bound, bound_by, ms)}")
            if not ok:
                raise AssertionError(f"ragged_paged_attention {key} "
                                     f"disagrees with its plain version")
    return results


# ---------------------------------------------------------------------------
# kernels K7a and K7b: paged decode and paged chunked-prefill attention
# ---------------------------------------------------------------------------

PAGED_CHUNK = 64
PAGED_DECODE_MAIN = "bf16"
PAGED_PREFILL_MAIN = "behind_prefix512"
_DECODE_CONTEXTS = (2048, 1536, 1100, 777, 512, 300, 64, 17)
#: the rest of the JAX paged kernels' domain, as decode and prefill
#: cases: name: ((Hq, Hkv, Dh, dtype, int8 pool, window), (page size,) or
#: () for 16)
_PAGED_DOMAIN = {
    "gemma7b_d256": ((16, 16, 256, torch.bfloat16, False, None), ()),
    "qwen2_7b_g7": ((28, 4, 128, torch.bfloat16, False, None), ()),
    "gemma2b_d256_g8": ((8, 1, 256, torch.bfloat16, False, None), ()),
    "d80": ((32, 32, 80, torch.bfloat16, False, None), ()),
    "d96_g8": ((64, 8, 96, torch.bfloat16, False, None), ()),
    "g64": ((64, 1, 128, torch.bfloat16, False, None), ()),
    "fp32_d256": ((16, 16, 256, torch.float32, False, None), ()),
    "int8_d256": ((16, 16, 256, torch.bfloat16, True, None), ()),
    "int8_bs12": ((H, HKV, D, torch.bfloat16, True, None), (12,)),
    "window256_d256": ((16, 16, 256, torch.bfloat16, False, 256), ()),
    "bs8": ((H, HKV, D, torch.bfloat16, False, None), (8,)),
    "bs32": ((H, HKV, D, torch.bfloat16, False, None), (32,)),
    "bs24": ((H, HKV, D, torch.bfloat16, False, None), (24,)),
}
PAGED_CASES = {
    # name: (T, Hq, Hkv, Dh, dtype, int8 pool, window, rows); rows are
    # (chunk_start, context_len) per sequence, None = an idle slot (a
    # sentinel table row with context 1); T == 1 is the decode kernel
    "decode": {
        "bf16": (1, H, HKV, D, torch.bfloat16, False, None,
                 [(c - 1, c) for c in _DECODE_CONTEXTS]),
        "int8": (1, H, HKV, D, torch.bfloat16, True, None,
                 [(c - 1, c) for c in _DECODE_CONTEXTS]),
        "window256": (1, H, HKV, D, torch.bfloat16, False, 256,
                      [(c - 1, c) for c in _DECODE_CONTEXTS]),
        "idle_sentinel": (1, H, HKV, D, torch.bfloat16, False, None,
                          [None, (99, 100), None, (1039, 1040), (0, 0),
                           (15, 16), None, (2047, 2048)]),
        "fp32_d64_g1": (1, 8, 8, 64, torch.float32, False, None,
                        [(c - 1, c) for c in (1000, 333, 16, 1)]),
        # GPT-2 125M's heads, contexts up to its 1024 positions
        "gpt2_d64": (1, 12, 12, 64, torch.bfloat16, False, None,
                     [(c - 1, c) for c in (1024, 960, 777, 512, 300, 128,
                                           64, 17)]),
        **{name: (1, *shape, [(c - 1, c) for c in _DECODE_CONTEXTS], *bs)
           for name, (shape, bs) in _PAGED_DOMAIN.items()},
    },
    "prefill": {
        "start0": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, False, None,
                   [(0, 64)]),
        "mid_prompt": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, False, None,
                       [(960, 1024)]),
        "behind_prefix512": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, False,
                             None, [(512, 576)]),
        "padded_tail": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, False, None,
                        [(1024, 1047)]),
        "int8": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, True, None,
                 [(512, 576)]),
        "window256": (PAGED_CHUNK, H, HKV, D, torch.bfloat16, False, 256,
                      [(960, 1024)]),
        "fp32_d64_b3": (40, 8, 4, 64, torch.float32, False, None,
                        [(0, 40), (100, 117), (2008, 2048)]),
        "gpt2_d64_behind_prefix512": (PAGED_CHUNK, 12, 12, 64,
                                      torch.bfloat16, False, None,
                                      [(512, 576)]),
        **{name: (PAGED_CHUNK, *shape, [(512, 576)], *bs)
           for name, (shape, bs) in _PAGED_DOMAIN.items()},
    },
}


def paged_case(T, Hq, Hkv, Dh, dtype, int8, rows, seed, bs=BS):
    """q ``[B, T, Hq, Dh]``, a pool of ``bs``-token pages and a table whose
    rows own distinct seeded pages covering their context (the rest is the
    sentinel, the pool's page count; sizes from :func:`pool_shape`), and
    the chunk starts and context lengths."""
    n_pages, nb = pool_shape(bs)
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(rows)
    bt = torch.full((B, nb), n_pages, dtype=torch.int32)
    cs = torch.zeros(B, dtype=torch.int32)
    cl = torch.ones(B, dtype=torch.int32)
    perm = np.random.RandomState(seed).permutation(n_pages)
    used = 0
    for b, row in enumerate(rows):
        if row is None:
            continue
        cs[b], cl[b] = row
        pages = -(-row[1] // bs)
        bt[b, :pages] = torch.from_numpy(perm[used:used + pages]
                                         .astype(np.int32))
        used += pages
    assert used <= n_pages
    shape = (n_pages, Hkv, bs, Dh)
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                              dtype=torch.int8) for _ in range(2))
        scales = {n: torch.rand(shape[:3], generator=g, device="cuda") / 64
                  for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(shape, generator=g, device="cuda", dtype=dtype)
                for _ in range(2))
        scales = {}
    q = torch.randn((B, T, Hq, Dh), generator=g, device="cuda", dtype=dtype)
    return q, k, v, bt.cuda(), cs.cuda(), cl.cuda(), scales


def paged_bound(T, Hq, Hkv, Dh, dtype, int8, window, rows, bs=BS):
    """``(ms, "bytes" | "operations")``: least time for the function on
    these inputs. Bytes: the K/V (and scales) of every key some row of the
    chunk sees, once per kv head, the q rows inside the context, the whole
    output, the table (its width at ``bs``-token pages) and the
    descriptors, over HBM bandwidth. FLOPs: 4 D per (query head, visible
    key) of every row, at the peak of q's type."""
    e = torch.tensor([], dtype=dtype).element_size()
    key_bytes = Hkv * (2 * Dh * (1 if int8 else e) + (8 if int8 else 0))
    B = len(rows)
    nbytes = B * T * Hq * Dh * e + 4 * (B * pool_shape(bs)[1] + 2 * B)
    pairs = 0
    for row in rows:
        start, clen = row if row is not None else (0, 1)
        pos = start + np.arange(T)
        pos = pos[pos < clen]
        if not len(pos):
            continue
        lo = np.maximum(pos - window + 1, 0) if window is not None \
            else 0 * pos
        pairs += int((pos - lo + 1).sum())
        nbytes += (int(pos[-1]) - int(lo[0]) + 1) * key_bytes \
            + len(pos) * Hq * Dh * e
    return bound(nbytes, 4 * Hq * Dh * pairs,
                 BF16_FLOP_PER_S if dtype == torch.bfloat16
                 else FP32_FLOP_PER_S)


def check_paged_attention():
    """K7a and K7b against their plain versions. Tolerance: fp32 1e-5
    (summation order only); bf16 |kernel - plain| <= 2**-7 * |plain| + 1e-3
    (both are bf16 roundings of fp32 results that differ only in summation
    order: one bf16 ulp). No library yardstick: no single PyTorch call
    reads a paged pool through a block table."""
    from deepspeed_tpu_torch.ops import decode_attention as da

    results = {"decode": {}, "prefill": {}}
    for kind, cases in PAGED_CASES.items():
        for name, (T, Hq, Hkv, Dh, dtype, int8, window, rows, *bs) in \
                cases.items():
            bs = bs[0] if bs else BS
            q, k, v, bt, cs, cl, scales = paged_case(
                T, Hq, Hkv, Dh, dtype, int8, rows,
                seed=len(results[kind]) + (61 if kind == "decode" else 71),
                bs=bs)
            kw = dict(window=window, **scales)
            if kind == "decode":
                args = (q[:, 0].contiguous(), k, v, bt, cl)
                kernel, plain = da.paged_decode_attention, \
                    da.paged_decode_attention_plain
            else:
                args = (q, k, v, bt, cs, cl)
                kernel, plain = da.paged_prefill_attention, \
                    da.paged_prefill_attention_plain
            got = kernel(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            rtol, atol = parity_tolerance(dtype)
            if not bool((err <= rtol * ref.float().abs() + atol).all()) \
                    or not bool(torch.isfinite(got).all()):
                raise AssertionError(
                    f"paged_{kind}_attention {name} disagrees with its "
                    f"plain version (max |err| {float(err.max()):.3e})")
            ms = cuda_time_ms(lambda: kernel(*args, **kw))
            plain_ms = cuda_time_ms(lambda: plain(*args, **kw), reps=5,
                                    warmup=1)
            bms, by = paged_bound(T, Hq, Hkv, Dh, dtype, int8, window, rows,
                                  bs)
            results[kind][name] = dict(
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None)
            nb = bt.shape[1]
            if kind == "decode":
                lp = da.decode_launch(len(rows), Hq, Hkv, nb, bs, dtype,
                                      da._sm_count(0))
                grid = (len(rows), Hkv * lp["chunks"], lp["splits"])
            else:
                lp = da.prefill_launch(len(rows), T, Hq, Hkv, nb, bs, dtype,
                                       da._sm_count(0))
                grid = (len(rows) * lp["tiles"], Hkv * lp["chunks"],
                        lp["splits"])
            splits, per = lp["splits"], lp["per"]
            launch = (f" | route {paged_route(q, k)}, grid {grid}, {splits} "
                      f"splits of {per} 64-key tiles | "
                      f"{achieved(bms, by, ms)}")
            log(f"parity paged_{kind}_attention {name} (B {len(rows)} T {T} "
                f"H {Hq} Hkv {Hkv} D {Dh} {str(dtype)[6:]} int8 {int8} "
                f"pages of {bs} window {window} (chunk_start, context) "
                f"{rows}): ok "
                f"max_abs_err={float(err.max()):.3e} (tolerance "
                f"{rtol:g}*|plain|+{atol:g}) | kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.3f} bound_ms={bms:.4f} ({by}) "
                f"library_ms=None{launch}")
            del q, k, v, got, ref, args, scales
    return results


# ---------------------------------------------------------------------------
# kernels K1 and K2: flash attention forward, dQ, dK/dV
# ---------------------------------------------------------------------------

# the training step's attention: Llama-400M heads at batch 8 x 1024
FLASH_MAIN = "train_bf16"
FLASH_CASES = {
    # name: (B, H, Tq, Tk, D, dtype, causal, window)
    FLASH_MAIN: (8, 16, 1024, 1024, 64, torch.bfloat16, True, None),
    "fp32": (2, 8, 512, 512, 64, torch.float32, True, None),
    "window256": (4, 16, 1024, 1024, 64, torch.bfloat16, True, 256),
    "d128": (2, 8, 1024, 1024, 128, torch.bfloat16, True, None),
    "uneven_t1000": (2, 8, 1000, 1000, 64, torch.bfloat16, True, None),
    "full_fp32": (2, 4, 300, 300, 64, torch.float32, False, None),
    # BERT-Large's heads (16 of 64), non-causal bf16, at the BERT
    # tutorial's phase-1 and phase-2 shapes
    "bert128_noncausal": (64, 16, 128, 128, 64, torch.bfloat16, False, None),
    "bert512_noncausal": (16, 16, 512, 512, 64, torch.bfloat16, False, None),
    # the published head dims past 64 and 128, causal, at the training
    # runs' batch of 4 x 1024: Phi-2 (32 heads of 80), GPT-NeoX-20B (64 of
    # 96), GPT-J-6B (16 of 256); fp32 at D 80 and 256
    "phi2_d80": (4, 32, 1024, 1024, 80, torch.bfloat16, True, None),
    "neox20b_d96": (4, 64, 1024, 1024, 96, torch.bfloat16, True, None),
    "gptj_d256": (4, 16, 1024, 1024, 256, torch.bfloat16, True, None),
    "fp32_d80": (1, 8, 512, 512, 80, torch.float32, True, None),
    "fp32_d256_window": (1, 4, 512, 512, 256, torch.float32, True, 128),
}


# K1's masked, GQA-native forward: the generate prefill's shapes, and a
# serving prompt of 777 tokens in its 1024 bucket
FLASH_MASKED_MAIN = "generate_prefill"
FLASH_MASKED_CASES = {
    # name: (B, Hq, Hkv, T, Dh, dtype, window, real tokens per row, left pad)
    "generate_prefill": (8, H, HKV, 512, D, torch.bfloat16, None,
                         (175, 487, 300, 512, 128, 401, 256, 350), True),
    "serving_bucket1024": (1, H, HKV, 1024, D, torch.bfloat16, None, (777,),
                           False),
    "fp32_window128": (2, 8, 2, 300, 64, torch.float32, 128, (300, 190),
                       True),
    # GPT-2 125M's generate prefill (12 heads of 64, no GQA)
    "gpt2_generate_prefill_d64": (8, 12, 12, 512, 64, torch.bfloat16, None,
                                  (175, 487, 300, 512, 128, 401, 256, 350),
                                  True),
    # Pythia-6.9B's generate prefill (32 heads of 128, no GQA) at the
    # prompt lengths of left_padded_prompts(..., 128, 512, seed 0)
    "pythia_generate_prefill": (8, 32, 32, 512, 128, torch.bfloat16, None,
                                (300, 175, 245, 320, 451, 379, 323, 487),
                                True),
    # GPT-J-6B's (16 heads of 256) and Falcon-7B's (71 query heads on one
    # kv head, D 64) generate prefills at the same prompt lengths
    "gptj_generate_prefill": (8, 16, 16, 512, 256, torch.bfloat16, None,
                              (300, 175, 245, 320, 451, 379, 323, 487),
                              True),
    "falcon7b_generate_prefill": (8, 71, 1, 512, 64, torch.bfloat16, None,
                                  (300, 175, 245, 320, 451, 379, 323, 487),
                                  True),
    "phi2_d80_fp32": (2, 32, 32, 300, 80, torch.float32, None, (300, 190),
                      True),
}


def check_masked_flash_attention():
    """K1's key-mask mode (un-repeated kv heads, causal, a key mask that
    hides left or right padding) against the plain version. Tolerances as
    for the unmasked forward. Library yardstick: SDPA with a boolean mask
    (causal and key mask) and enable_gqa. Bound: q, k, v, the mask, out
    and lse moved once; 4 D FLOPs per (query head, visible pair)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    results = {}
    for case, (B, Hq, Hkv, T, Dh, dtype, window, lens, left) in \
            FLASH_MASKED_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(len(results) + 81)
        q = torch.randn(B, T, Hq, Dh, generator=g, device="cuda", dtype=dtype)
        k, v = (torch.randn(B, T, Hkv, Dh, generator=g, device="cuda",
                            dtype=dtype) for _ in range(2))
        ar = np.arange(T)[None]
        n = np.asarray(lens)[:, None]
        mask_np = (ar >= T - n) if left else (ar < n)
        mask = torch.from_numpy(mask_np.astype(np.int32)).cuda()
        kw = dict(causal=True, window=window)
        out, lse = fa.flash_attention_fwd_masked(q, k, v, mask, **kw)
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, key_mask=mask,
                                                    **kw)
        torch.cuda.synchronize()
        fp32 = dtype == torch.float32
        rtol, atol = (1e-5, 1e-5) if fp32 else (2 ** -7, 2e-2)
        seen = torch.isfinite(ref_lse)
        errs = {"out": (out.float() - ref_out.float()).abs(),
                "lse": (lse[seen] - ref_lse[seen]).abs()}
        ok = torch.equal(seen, torch.isfinite(lse)) and \
            bool((errs["out"] <= rtol * ref_out.float().abs() + atol).all()) \
            and bool((errs["lse"] <= 1e-5 * ref_lse[seen].abs() + 1e-4).all())
        errs = {name: float(e.max()) for name, e in errs.items()}
        if not ok:
            raise AssertionError(f"masked flash attention {case} disagrees "
                                 f"with the plain version (max |err| {errs})")
        ms = cuda_time_ms(
            lambda: fa.flash_attention_fwd_masked(q, k, v, mask, **kw))
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, key_mask=mask, **kw), reps=5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        i = torch.arange(T, device="cuda")
        am = (i[:, None] >= i[None, :])[None, None] & \
            (mask > 0)[:, None, None, :]
        if window is not None:
            am = am & (i[:, None] - i[None, :] < window)[None, None]
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am, enable_gqa=True))
        pairs = 0
        for row in mask_np:
            vis = np.tril(np.ones((T, T), bool)) & row[None, :]
            if window is not None:
                vis &= (ar.T - ar) < window
            pairs += int(vis.sum())
        e = q.element_size()
        bms, by = bound(2 * B * T * Hq * Dh * e + 2 * B * T * Hkv * Dh * e
                        + B * Hq * T * 4 + B * T * 4, 4 * Hq * Dh * pairs,
                        FP32_FLOP_PER_S if fp32 else BF16_FLOP_PER_S)
        results[case] = dict(max_abs_err=max(errs.values()), ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             library_ms=library_ms)
        log(f"parity flash_attention_fwd_masked {case} (B {B} H {Hq} Hkv "
            f"{Hkv} T {T} D {Dh} {str(dtype)[6:]} window {window} real "
            f"tokens {lens} {'left' if left else 'right'}-padded): ok "
            f"max_abs_err out={errs['out']:.3e} lse={errs['lse']:.3e} "
            f"(tolerance {rtol:g}*|plain|+{atol:g}) | kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.4f} ({by}) "
            f"library_ms={library_ms:.4f}")
        del q, k, v, out, lse, ref_out, ref_lse, qt, kt, vt, am
    return results


def visible_pairs(Tq, Tk, causal, window):
    """(query, key) pairs that the mask lets through, per (batch, head)."""
    i = np.arange(Tq) + (Tk - Tq)
    hi = np.minimum(i, Tk - 1) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0 * i
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bounds(case):
    """Bound of K1, K2-dq and K2-dkv on ``case``: each input read once,
    each output written once; FLOPs over the visible pairs (4 D each for
    the forward's two products, 6 D for dQ's three, 8 D for dK/dV's four),
    at the peak of the inputs' type."""
    B, H, Tq, Tk, D, dtype, causal, window = FLASH_CASES[case]
    e = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes, row_bytes = B * Tq * H * D * e, B * Tk * H * D * e, \
        B * H * Tq * 4
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    f1 = 4 * B * H * D * visible_pairs(Tq, Tk, causal, window)
    return {
        "fwd": bound(2 * q_bytes + 2 * kv_bytes + row_bytes, f1, rate),
        "dq": bound(3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 1.5 * f1,
                    rate),
        "dkv": bound(2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 2 * f1,
                     rate),
    }


def check_flash_attention():
    """K1, K2-dq and K2-dkv against the plain forward and backward on the
    same inputs; for the fp32 cases also the gradients through the
    autograd function against autograd of the plain forward. Tolerance:
    fp32 1e-5 (relative and absolute; summation order only); bf16
    |kernel - plain| <= 2**-7 |plain| + 2e-2 (both are bf16 roundings of
    fp32 results that differ in summation order: one bf16 ulp). Times and
    library yardsticks (SDPA forward, and its autograd backward for both
    K2 kernels) on every case. Then the forward's masked, GQA-native
    cases. Returns ``(results, masked results)``."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    results = {}
    for case, (B, H, Tq, Tk, D, dtype, causal, window) in \
            FLASH_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(len(results) + 7)
        q, do = (torch.randn(B, Tq, H, D, generator=g, device="cuda",
                             dtype=dtype) for _ in range(2))
        k, v = (torch.randn(B, Tk, H, D, generator=g, device="cuda",
                            dtype=dtype) for _ in range(2))
        kw = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, **kw)
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        fp32 = dtype == torch.float32
        rtol, atol = (1e-5, 1e-5) if fp32 else (2 ** -7, 2e-2)
        pairs = {"out": (out, ref_out), "lse": (lse, ref_lse),
                 "dq": (dq, ref[0]), "dk": (dk, ref[1]), "dv": (dv, ref[2])}
        if fp32:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fa.flash_attention(*leaves, **kw).backward(do)
            plain = [t.clone().requires_grad_() for t in (q, k, v)]
            fa.flash_attention_plain(*plain, **kw)[0].backward(do)
            for name, a, b in zip(("grad_q", "grad_k", "grad_v"), leaves,
                                  plain):
                pairs[name] = (a.grad, b.grad)
        torch.cuda.synchronize()
        errs = {}
        for name, (a, b) in pairs.items():
            err = (a.float() - b.float()).abs()
            errs[name] = float(err.max())
            if not bool((err <= rtol * b.float().abs() + atol).all()):
                raise AssertionError(f"flash attention {case}: {name} "
                                     f"disagrees with the plain version "
                                     f"(max |err| {errs[name]:.3e})")
        delta = fa._delta(out, do)
        ms = {
            "fwd": cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw)),
            "dq": cuda_time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, out, lse, do, delta=delta, **kw)),
            "dkv": cuda_time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, out, lse, do, delta=delta, **kw)),
        }
        plain_ms = {
            "fwd": cuda_time_ms(lambda: fa.flash_attention_plain(
                q, k, v, **kw), reps=5, warmup=1),
            # the plain backward computes dQ, dK and dV together: it is
            # the plain version of both K2 kernels
            "dq": cuda_time_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, lse, do, **kw), reps=5, warmup=1),
        }
        plain_ms["dkv"] = plain_ms["dq"]
        library_ms = {"fwd": None, "dq": None, "dkv": None}
        if window is None and Tq == Tk:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            library_ms["fwd"] = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal)
            dot = do.transpose(1, 2).contiguous()
            library_ms["dq"] = library_ms["dkv"] = cuda_time_ms(
                lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                            retain_graph=True))
            del lib_out, qt, kt, vt
        bounds = flash_bounds(case)
        results[case] = {
            part: dict(max_abs_err=max(errs[n] for n in names), ms=ms[part],
                       plain_ms=plain_ms[part], bound_ms=bounds[part][0],
                       bound_by=bounds[part][1],
                       library_ms=library_ms[part])
            for part, names in (("fwd", ("out", "lse")), ("dq", ("dq",)),
                                ("dkv", ("dk", "dv")))}
        log(f"parity flash_attention {case} (B {B} H {H} Tq {Tq} Tk {Tk} "
            f"D {D} {str(dtype)[6:]} causal {causal} window {window}): "
            f"ok max_abs_err " + " ".join(f"{n}={e:.3e}"
                                          for n, e in errs.items())
            + f" (tolerance {rtol:g}*|plain|+{atol:g}) | " + " | ".join(
                f"{part} kernel_ms={r['ms']:.4f} plain_ms="
                f"{r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) library_ms={r['library_ms']}"
                for part, r in results[case].items()))
        del q, k, v, do, out, lse, dq, dk, dv, ref, pairs
    return results, check_masked_flash_attention()


# ---------------------------------------------------------------------------
# kernel K9: block-sparse attention forward, dQ, dK/dV
# ---------------------------------------------------------------------------

def sparse_config(name, H, block):
    """The long-context layouts of the JAX package's
    ``tools/bench_longctx.py`` (BSLongformer window 7 + global block 0,
    BigBird 3 random + window 3 + 1 global), a per-head Fixed one, and
    ``fixed_ds``: DeepSpeed's default sparse-attention config (Fixed, 4
    local blocks and 1 global one, bidirectional, one pattern for every
    head; DeepSpeed's JSON block defaults to a block of 16)."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    if name == "bslongformer":
        return sa.BSLongformerSparsityConfig(
            num_heads=H, block=block, num_sliding_window_blocks=7,
            global_block_indices=[0])
    if name == "bigbird":
        return sa.BigBirdSparsityConfig(
            num_heads=H, block=block, num_random_blocks=3,
            num_sliding_window_blocks=3, num_global_blocks=1)
    if name == "fixed_ds":
        return sa.FixedSparsityConfig(num_heads=H, block=block,
                                      num_local_blocks=4, num_global_blocks=1)
    return sa.FixedSparsityConfig(
        num_heads=H, block=block, num_local_blocks=4, num_global_blocks=1,
        different_layout_per_head=True, num_different_global_patterns=2)


# the long-context path: Llama-3-8B's 32 query heads of 128, block 128
SPARSE_MAIN = "bslongformer_t16384"
# DeepSpeed's default config at BERT-Large's 16 heads of 64: the main case
# of the 16-row strips (blocks that are not a multiple of 64)
SPARSE_STRIPS = "fixed_ds_default_t4096"
SPARSE_CASES = {
    # name: (B, T, H, D, dtype, block, layout, causal)
    SPARSE_MAIN: (1, 16384, H, D, torch.bfloat16, 128, "bslongformer", True),
    "bigbird_t16384": (1, 16384, H, D, torch.bfloat16, 128, "bigbird", True),
    "bslongformer_t4096": (1, 4096, H, D, torch.bfloat16, 128,
                           "bslongformer", True),
    "bigbird_t8192": (1, 8192, H, D, torch.bfloat16, 128, "bigbird", True),
    "fp32_d64_block64": (2, 2048, 8, 64, torch.float32, 64, "bigbird", True),
    "bigbird_noncausal_t4096": (1, 4096, H, D, torch.bfloat16, 128,
                                "bigbird", False),
    "fixed_per_head_t4096": (1, 4096, H, D, torch.bfloat16, 128,
                             "fixed_per_head", True),
    # fine blocks (the strips), block 256, and the head dims of K1/K2
    SPARSE_STRIPS: (4, 4096, 16, 64, torch.bfloat16, 16, "fixed_ds", False),
    "bigbird_block32_t16384": (1, 16384, H, D, torch.bfloat16, 32, "bigbird",
                               True),
    "bslongformer_block48_t6144": (1, 6144, H, D, torch.bfloat16, 48,
                                   "bslongformer", True),
    "bslongformer_block256_t16384": (1, 16384, H, D, torch.bfloat16, 256,
                                     "bslongformer", True),
    "d80_phi2_t8192": (1, 8192, 32, 80, torch.bfloat16, 64, "bslongformer",
                       True),
    "d96_neox_t8192": (1, 8192, 64, 96, torch.bfloat16, 128, "bigbird",
                       False),
    "d256_gemma_t8192": (1, 8192, 16, 256, torch.bfloat16, 128,
                         "bslongformer", True),
    "fp32_d256_block16": (1, 2048, 8, 256, torch.float32, 16,
                          "fixed_per_head", True),
    "fp32_d80_block32": (2, 2048, 8, 80, torch.float32, 32, "bigbird", False),
}
# FlexAttention (compiled) is timed at the main width and at DeepSpeed's
# default config only: a compile each (the others time SDPA)
SPARSE_FLEX = (SPARSE_MAIN, "bigbird_t16384", SPARSE_STRIPS)


def sparse_pairs(layout, block, causal):
    """(query, key) pairs per batch row that the (causally cut) layout
    lets through: a diagonal block holds block (block + 1) / 2 of them."""
    layout = np.asarray(layout) != 0
    n = int(layout.sum())
    if not causal:
        return n * block * block
    diag = int(np.trace(layout, axis1=1, axis2=2).sum())
    return (n - diag) * block * block + diag * block * (block + 1) // 2


def sparse_bounds(B, T, Hh, Dh, dtype, layout, block, causal):
    """Bound of K9 fwd, dq and dkv: each input read once, each output
    written once; FLOPs over the pairs the layout lets through (4 D each
    for the forward, 6 D for dQ, 8 D for dK/dV), at the type's peak."""
    e = torch.tensor([], dtype=dtype).element_size()
    x, row = B * T * Hh * Dh * e, B * Hh * T * 4
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    f1 = 4 * Dh * B * sparse_pairs(layout, block, causal)
    return {"fwd": bound(4 * x + row, f1, rate),
            "dq": bound(5 * x + 2 * row, 1.5 * f1, rate),
            "dkv": bound(6 * x + 2 * row, 2 * f1, rate)}


def sparse_library(q, k, v, do, out, layout, block, causal, flex):
    """Yardstick times ``{part: ms}`` of one PyTorch call for the same
    function: SDPA with the layout's boolean mask (``[1, 1, T, T]`` when
    every head has the same layout), and with ``flex`` FlexAttention on a
    ``BlockMask`` built from the layout's lists, compiled, its first call
    excluded, its output held against the kernel's ``out``. A yardstick
    that does not run is recorded as None with its error: the port never
    calls either."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    T = q.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    res = {}
    same = bool((layout == layout[:1]).all())
    seen = torch.as_tensor((layout[:1] if same else layout) != 0,
                           device="cuda")
    mask = seen.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        mask &= torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
    mask = mask[None]
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            res["sdpa_fwd"] = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask),
                reps=5)
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask)
            res["sdpa_bwd"] = cuda_time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dot, retain_graph=True), reps=5)
        del lib_out
    except Exception as err:  # a yardstick only: recorded, never gating
        log(f"  sdpa yardstick did not run: {type(err).__name__}: "
            f"{str(err)[:300]}")
    del mask
    if flex:
        try:
            res.update(flex_times(qt, kt, vt, dot, out, layout, block,
                                  causal))
        except Exception as err:  # a yardstick only: recorded, never gating
            log(f"  flex_attention yardstick did not run: "
                f"{type(err).__name__}: {str(err)[:500]}")
    return res


def flex_times(qt, kt, vt, dot, want, layout, block, causal):
    """FlexAttention forward and backward on ``[B, H, T, D]`` tensors with
    a BlockMask from the layout: blocks below the diagonal are full, the
    diagonal block (causal) is partial; the ``mask_mod`` reads the layout
    too, so that the function does not depend on how the blocks are
    visited. Its
    output must agree with ``want`` (the kernel's ``[B, T, H, D]`` out) to
    K1's bf16 tolerance, or the yardstick is not the same function."""
    import torch._functorch.config as functorch_config
    from torch.nn.attention.flex_attention import BlockMask, flex_attention

    # the timed backward runs with retain_graph, which donated buffers
    # forbid
    functorch_config.donated_buffer = False

    B, Hh, T, _ = qt.shape
    lay = torch.as_tensor(np.asarray(layout) != 0, device="cuda")
    # FlexAttention's kernels take blocks of 128: a finer layout's blocks
    # are grouped into 128 x 128 ones, full where every fine block of one
    # is seen (and it is off the diagonal), partial where some are, and
    # its mask_mod reads the fine layout
    coarse = block if block % 128 == 0 else 128
    if coarse % block or T % coarse:
        raise ValueError(f"block {block} does not group into FlexAttention "
                         f"blocks of {coarse} over T {T}")
    f = coarse // block
    nc = T // coarse
    if f > 1:
        grid = lay.reshape(Hh, nc, f, nc, f)
        seen_any, seen_all = grid.any(4).any(2), grid.all(4).all(2)
    else:
        seen_any = seen_all = lay
    diag = torch.eye(nc, dtype=torch.bool, device="cuda")[None]
    full = seen_all & ~diag if causal else seen_all
    part = seen_any & ~full

    def lists(m):
        cnt = m.sum(-1).to(torch.int32)
        idx = torch.argsort((~m).to(torch.int8), dim=-1, stable=True)
        return (cnt[None].expand(B, -1, -1).contiguous(),
                idx.to(torch.int32)[None].expand(B, -1, -1, -1).contiguous())

    def layout_mod(b, h, q_idx, kv_idx):
        seen = lay[h, q_idx // block, kv_idx // block]
        return seen & (q_idx >= kv_idx) if causal else seen

    kv_num, kv_idx = lists(part)
    full_num, full_idx = lists(full)
    bm = BlockMask.from_kv_blocks(kv_num, kv_idx, full_num, full_idx,
                                  BLOCK_SIZE=coarse, mask_mod=layout_mod)
    flex = torch.compile(flex_attention, dynamic=False)
    t = time.perf_counter()
    out = flex(qt, kt, vt, block_mask=bm)
    torch.autograd.grad(out, (qt, kt, vt), dot)
    torch.cuda.synchronize()
    err = (out.transpose(1, 2).float() - want.float()).abs()
    log(f"  flex_attention compiled (forward + backward) in "
        f"{time.perf_counter() - t:.1f} s; max |flex - kernel| "
        f"{float(err.max()):.3e}")
    if not bool((err <= 2 ** -7 * want.float().abs() + 2e-2).all()):
        raise ValueError("flex_attention's BlockMask computes another "
                         "function than the layout")
    res = {"flex_fwd": cuda_time_ms(lambda: flex(qt, kt, vt, block_mask=bm),
                                    reps=10)}
    out = flex(qt, kt, vt, block_mask=bm)
    res["flex_bwd"] = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), reps=10)
    return res


def work_list_summary(walks, block):
    """A ``_Walks``' work list in words: its items (one block each per
    64-row slice and batch row, or one warp each per 16-row strip), how
    many of them belong to split walks, and the longest item in keys."""
    split = int((walks.work[:, 4] >= 0).sum())
    return (f"{walks.work.shape[0]} items ({split} split), longest "
            f"{walks.longest * block} keys")


def check_block_sparse_attention():
    """K9 forward, dQ and dK/dV against their plain versions on the same
    inputs (the backward ones from the kernel's out and lse), head by head
    (one head's dense fp32 scores at T 16384 are 1 GiB), which computes
    the same function. Tolerance: fp32 2e-5; bf16 2**-7 |plain| + 2e-2,
    as K1's. Times (the plain version once: the head-by-head loop), the
    bound over the pairs the layout lets through, and the yardsticks of
    ``sparse_library``."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    results = {}
    for case, (B, T, Hh, Dh, dtype, block, name, causal) in \
            SPARSE_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(len(results) + 91)
        q, k, v, do = (torch.randn(B, T, Hh, Dh, generator=g, device="cuda",
                                   dtype=dtype) for _ in range(4))
        # the layout as sparse_attention holds it: made once, cut once,
        # read-only, so the wrappers find its lists by identity
        layout = bsa._cut(bsa._config_layout(sparse_config(name, Hh, block),
                                             T), causal)
        args = (layout, block, causal)
        route = bsa.kernel_route(dtype, block)
        out, lse = bsa.block_sparse_attention_fwd(q, k, v, *args)
        dq = bsa.block_sparse_attention_bwd_dq(q, k, v, out, lse, do, *args)
        dk, dv = bsa.block_sparse_attention_bwd_dkv(q, k, v, out, lse, do,
                                                    *args)
        got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        ref = {n: torch.empty_like(t) for n, t in got.items()}
        plain_ms = {}
        for part in ("fwd", "dq", "dkv"):
            a, b = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            for h in range(Hh):
                hs = slice(h, h + 1)
                qh, kh, vh, oh, doh = (t[:, :, hs] for t in (q, k, v, out, do))
                lh, hargs = lse[:, hs], (layout[hs], block, causal)
                if part == "fwd":
                    ref["out"][:, :, hs], ref["lse"][:, hs] = \
                        bsa.block_sparse_attention_fwd_plain(qh, kh, vh,
                                                             *hargs)
                elif part == "dq":
                    ref["dq"][:, :, hs] = \
                        bsa.block_sparse_attention_bwd_dq_plain(
                            qh, kh, vh, oh, lh, doh, *hargs)
                else:
                    ref["dk"][:, :, hs], ref["dv"][:, :, hs] = \
                        bsa.block_sparse_attention_bwd_dkv_plain(
                            qh, kh, vh, oh, lh, doh, *hargs)
            b.record()
            b.synchronize()
            plain_ms[part] = a.elapsed_time(b)
        fp32 = dtype == torch.float32
        rtol, atol = (2e-5, 2e-5) if fp32 else (2 ** -7, 2e-2)
        errs = {}
        for n in got:
            x, y = got[n].float(), ref[n].float()
            err = (x - y).abs()
            errs[n] = float(err.max())
            tol = (1e-5, 1e-4) if n == "lse" else (rtol, atol)
            if not bool((err <= tol[0] * y.abs() + tol[1]).all()):
                raise AssertionError(f"block-sparse attention {case}: {n} "
                                     f"disagrees with the plain version "
                                     f"(max |err| {errs[n]:.3e})")
        del ref
        delta = bsa._delta(out, do)
        ms = {
            "fwd": cuda_time_ms(
                lambda: bsa.block_sparse_attention_fwd(q, k, v, *args)),
            "dq": cuda_time_ms(lambda: bsa.block_sparse_attention_bwd_dq(
                q, k, v, out, lse, do, *args, delta=delta)),
            "dkv": cuda_time_ms(lambda: bsa.block_sparse_attention_bwd_dkv(
                q, k, v, out, lse, do, *args, delta=delta)),
        }
        lib = sparse_library(q, k, v, do, out, layout, block, causal,
                             case in SPARSE_FLEX)
        bounds = sparse_bounds(B, T, Hh, Dh, dtype, *args)
        _, cnt = bsa.layout_indices(layout)
        _, qcnt = bsa.layout_indices(np.swapaxes(layout, 1, 2))
        walks = bsa._indices(layout, causal, q.device, block)
        results[case] = {}
        for part, names in (("fwd", ("out", "lse")), ("dq", ("dq",)),
                            ("dkv", ("dk", "dv"))):
            kind = "fwd" if part == "fwd" else "bwd"
            results[case][part] = dict(
                route=route, max_abs_err=max(errs[n] for n in names),
                ms=ms[part],
                plain_ms=plain_ms[part], bound_ms=bounds[part][0],
                bound_by=bounds[part][1],
                library_ms=lib.get(f"flex_{kind}", lib.get(f"sdpa_{kind}")),
                flex_ms=lib.get(f"flex_{kind}"),
                sdpa_ms=lib.get(f"sdpa_{kind}"))
        log(f"parity block_sparse_attention {case} (B {B} T {T} H {Hh} D {Dh} "
            f"{str(dtype)[6:]} block {block} {name} causal {causal}; route "
            f"{route}; block degree mean {cnt.mean():.2f} max {cnt.max()}, "
            f"transposed max {qcnt.max()}; "
            f"{sparse_pairs(layout, block, causal)} pairs per batch row; "
            f"bf16 work lists, C {bsa._split(block)} blocks: "
            + ", ".join(f"{kind} {work_list_summary(w, block)}" for kind, w
                        in zip(("rows", "columns"), walks))
            + "): ok max_abs_err " + " ".join(
                f"{n}={e:.3e}" for n, e in errs.items())
            + f" (tolerance {rtol:g}*|plain|+{atol:g}) | " + " | ".join(
                f"{part} kernel_ms={r['ms']:.4f} plain_ms="
                f"{r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) flex_ms={r['flex_ms']} "
                f"sdpa_ms={r['sdpa_ms']}"
                for part, r in results[case].items()))
        del q, k, v, do, out, lse, dq, dk, dv, got, delta
        gc.collect()
        torch.cuda.empty_cache()
    return results


def host_ms(fn, reps=20):
    """Median host ms of ``fn()`` (no gradient) from an idle device to the
    return of its last launch: what a caller's thread spends per call."""
    times = []
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    return statistics.median(times)


LONGCTX_T = (4096, 8192, 16384)
LONGCTX_LAYOUTS = ("bslongformer", "bigbird")
# the fine-block runs (the 16-row strips): DeepSpeed's default config at
# BERT-Large's heads, non-causal as its bidirectional layout is, beside
# non-causal flash; BigBird at a block of 32 at Llama-3-8B's heads
LONGCTX_FINE = {
    # name: (B, T, H, D, block, layout, causal)
    SPARSE_STRIPS: (4, 4096, 16, 64, 16, "fixed_ds", False),
    "bigbird_block32_t16384": (1, 16384, H, D, 32, "bigbird", True),
}


def causal_block_fraction(layout):
    """Share of the causal block grid the layout keeps, as
    ``tools/bench_longctx.py`` counts it: the ceiling of the speedup over
    a causal flash kernel that already skips the upper triangle."""
    nb = layout.shape[-1]
    tril = np.tril(np.ones((nb, nb), bool))
    return float((np.asarray(layout, bool) & tril[None]).sum()) / \
        float(tril.sum() * layout.shape[0])


def check_long_context():
    """The long-context path, a twin of ``tools/bench_longctx.py`` on the
    port: ``sparse_attention`` (bf16, B 1, H 32, D 128, causal, block 128)
    at T 4096, 8192 and 16384 with both layouts, one forward and one
    backward each (loss ``(out * dout).sum()``), beside causal
    ``flash_attention`` (K1/K2) on the same q/k/v; then the
    ``LONGCTX_FINE`` runs at blocks of 16 and 32, each beside flash with
    its causality. Asserts finite gradients and exact launch counts (K9:
    one of each pass a run, 6 on the 64-row slices and 2 on the strips;
    K1 forward and K2: one per yardstick call), then times both forward and
    backward, and the host time of one ``sparse_attention`` forward call.
    Returns the K9 launches of each route."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention

    k9 = (bsa.block_sparse_attention_fwd, bsa.block_sparse_attention_bwd_dq,
          bsa.block_sparse_attention_bwd_dkv)
    k12 = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
           fa.flash_attention_bwd_dkv)

    def inputs(B, T, Hh, Dh):
        g = torch.Generator(device="cuda").manual_seed(T + Hh + Dh)
        return [torch.randn(B, T, Hh, Dh, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(4)]

    def fwd_bwd(fn, q, k, v, do):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        (fn(*leaves) * do).sum().backward()
        return [t.grad for t in leaves]

    # every run: (label, (B, T, H, D), block, layout, causal)
    runs = [(f"T {T} {name}", (1, T, H, D), 128, name, True)
            for T in LONGCTX_T for name in LONGCTX_LAYOUTS]
    runs += [(case, (B, T, Hh, Dh), block, name, causal)
             for case, (B, T, Hh, Dh, block, name, causal)
             in LONGCTX_FINE.items()]
    for f in k9 + k12:
        f.launches = 0
    for f in k9:
        f.route_launches.clear()
    flash_calls = 0
    flash_shapes = []
    for label, shape, block, name, causal in runs:
        q, k, v, do = inputs(*shape)
        cfg = sparse_config(name, shape[2], block)
        grads = fwd_bwd(lambda *x: sparse_attention(
            *x, sparsity_config=cfg, causal=causal), q, k, v, do)
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"long context {label}: a gradient is not "
                                 f"finite")
        if (shape, causal) not in flash_shapes:
            flash_shapes.append((shape, causal))
            grads = fwd_bwd(lambda *x: fa.flash_attention(*x, causal=causal),
                            q, k, v, do)
            flash_calls += 1
            if not all(bool(torch.isfinite(g).all()) for g in grads):
                raise AssertionError(f"long context {label} flash: a "
                                     f"gradient is not finite")
        del q, k, v, do, grads
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in k9 + k12}
    routes = {f.__name__: dict(f.route_launches) for f in k9}
    want = {**{f.__name__: len(runs) for f in k9},
            **{f.__name__: flash_calls for f in k12}}
    want_routes = {f.__name__: {"tiles": len(runs) - len(LONGCTX_FINE),
                                "strips": len(LONGCTX_FINE)} for f in k9}
    if launches != want or routes != want_routes:
        raise AssertionError(f"long context: launches {launches}, routes "
                             f"{routes} != {want}, {want_routes}")
    log(f"long context: {len(runs)} sparse_attention forward + backward "
        f"runs, {flash_calls} flash yardsticks, launches {launches}, K9 "
        f"routes {routes}")

    def timed(label, shape, block, name, causal, reps, flash=None):
        """``(flash_ms, flash_bwd_ms, sparse record)`` of one run: forward
        and backward ms of ``sparse_attention`` (and of flash unless
        given), the host ms of one forward call."""
        q, k, v, do = inputs(*shape)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def times(fn):
            with torch.no_grad():
                fwd = cuda_time_ms(lambda: fn(q, k, v), reps=reps)
            out = fn(*leaves)
            bwd = cuda_time_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), reps=reps)
            return fwd, bwd

        if flash is None:
            flash = times(lambda *x: fa.flash_attention(*x, causal=causal))
        cfg = sparse_config(name, shape[2], block)
        layout = cfg.make_layout(shape[1])
        frac = causal_block_fraction(layout) if causal else \
            float(np.asarray(layout, bool).mean())
        sparse_ms, sparse_bwd_ms = times(lambda *x: sparse_attention(
            *x, sparsity_config=cfg, causal=causal))
        rec = {"sparse_ms": sparse_ms, "sparse_bwd_ms": sparse_bwd_ms,
               "sparse_host_ms": host_ms(lambda: sparse_attention(
                   q, k, v, sparsity_config=cfg, causal=causal)),
               "sparse_speedup_vs_flash": flash[0] / sparse_ms,
               "sparse_bwd_speedup_vs_flash": flash[1] / sparse_bwd_ms,
               ("causal_nnz_fraction" if causal else "nnz_fraction"): frac,
               "theoretical_speedup": 1.0 / frac,
               "realization": flash[0] / sparse_ms * frac,
               "bwd_realization": flash[1] / sparse_bwd_ms * frac}
        del q, k, v, do, leaves
        gc.collect()
        torch.cuda.empty_cache()
        return flash, rec

    for T in LONGCTX_T:
        reps = 25 if T < 16384 else 5
        flash = None
        rec = {"metric": "longctx_attention", "seq": T, "heads": H,
               "head_dim": D, "layouts": {}}
        for name in LONGCTX_LAYOUTS:
            flash, rec["layouts"][name] = timed(
                f"T {T} {name}", (1, T, H, D), 128, name, True, reps, flash)
        rec["flash_ms"], rec["flash_bwd_ms"] = flash
        log("long context " + json.dumps(rec))
    for case, (B, T, Hh, Dh, block, name, causal) in LONGCTX_FINE.items():
        flash, sparse = timed(case, (B, T, Hh, Dh), block, name, causal,
                              25 if T < 16384 else 5)
        log("long context " + json.dumps(
            {"metric": "longctx_attention", "case": case, "batch": B,
             "seq": T, "heads": Hh, "head_dim": Dh, "block": block,
             "layout": name, "causal": causal, "flash_ms": flash[0],
             "flash_bwd_ms": flash[1], "layouts": {name: sparse}}))
    return routes


# ---------------------------------------------------------------------------
# kernel K3: fused Adam
# ---------------------------------------------------------------------------

def adam_state(cfg, seed):
    """``(params, grads, m, v)`` lists of fp32 tensors shaped like the
    model's parameters, seeded."""
    from deepspeed_tpu_torch.models import LlamaForCausalLM

    shapes = [p.shape for p in LlamaForCausalLM(cfg).state_dict().values()]
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = [torch.randn(s, generator=g, device="cuda") * 0.02
              for s in shapes]
    grads = [torch.randn(s, generator=g, device="cuda") * 1e-3
             for s in shapes]
    return params, grads, [torch.zeros_like(p) for p in params], \
        [torch.zeros_like(p) for p in params]


def check_fused_adam():
    """K3 over the whole Llama-400M parameter list, 3 steps with a device
    clip factor, the step's scalars (``alpha``) and a clear skip flag in
    device memory, in both decay modes, against the plain version on
    copies; then one step with the flag set must leave every tensor
    bit-identical. Tolerance: 1e-6 relative + 1e-7 absolute (the kernel fuses
    multiply-adds that the plain version rounds twice: about one fp32 ulp
    a step). Times one step of each, and torch.optim.AdamW(fused=True)
    on the same tensors as the yardstick."""
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam, fused_adam_plain

    cfg = LlamaConfig.llama_400m()
    b1, b2, eps, wd, lr = 0.9, 0.999, 1e-8, 0.1, 1e-4
    scale = torch.tensor(0.5, device="cuda")

    skip = torch.tensor(False, device="cuda")

    def hyper(t, adam_w_mode):
        alpha = torch.tensor([lr / (1 - b1 ** t), lr,
                              1 / (1 - b2 ** t) ** 0.5], device="cuda")
        return dict(b1=b1, b2=b2, eps=eps, weight_decay=wd,
                    adam_w_mode=adam_w_mode, alpha=alpha, skip=skip,
                    grad_scale=scale)

    max_err = 0.0
    for adam_w_mode in (True, False):
        state = adam_state(cfg, seed=1)
        ref = [[t.clone() for t in lst] for lst in state]
        for t in range(1, 4):
            fused_adam(*state, **hyper(t, adam_w_mode))
            fused_adam_plain(*ref, **hyper(t, adam_w_mode))
        torch.cuda.synchronize()
        for got, want in zip(state, ref):
            for a, b in zip(got, want):
                err = (a - b).abs()
                max_err = max(max_err, float(err.max()))
                if not bool((err <= 1e-6 * b.abs() + 1e-7).all()):
                    raise AssertionError(
                        f"fused_adam (adam_w_mode={adam_w_mode}) disagrees "
                        f"with its plain version (max |err| "
                        f"{float(err.max()):.3e})")
        kept = [[t.clone() for t in lst] for lst in state]
        skip.fill_(True)
        fused_adam(*state, **hyper(4, adam_w_mode))
        skip.fill_(False)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for lst, old in zip(state, kept)
                   for a, b in zip(lst, old)):
            raise AssertionError(f"fused_adam (adam_w_mode={adam_w_mode}) "
                                 f"changed a tensor with skip set")
        del state, ref, kept
    params, grads, m, v = adam_state(cfg, seed=2)
    n = sum(p.numel() for p in params)
    kw = hyper(4, True)
    table = fused_adam(params, grads, m, v, **kw)
    ms = cuda_time_ms(lambda: fused_adam(params, grads, m, v, **kw,
                                         table=table))
    plain_ms = cuda_time_ms(lambda: fused_adam_plain(params, grads, m, v,
                                                     **kw), reps=5, warmup=1)
    # the same function in one PyTorch call (no clip factor: the grads
    # stand for already-clipped ones)
    for p, gr in zip(params, grads):
        p.grad = gr
    lib = torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=wd, fused=True)
    library_ms = cuda_time_ms(lib.step)
    # 16 bytes read (p, g, m, v) and 12 written (p, m, v) per element;
    # ~15 fp32 operations per element
    bound_ms, bound_by = bound(28 * n, 15 * n, FP32_FLOP_PER_S)
    log(f"parity fused_adam: llama_400m list ({len(params)} tensors, {n} "
        f"elements), 3 steps x both decay modes, then a skipped step (bit-"
        f"identical): ok max_abs_err="
        f"{max_err:.3e} (tolerance 1e-6*|plain|+1e-7) | kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}) "
        f"library_ms={library_ms:.4f}")
    del params, grads, m, v, lib
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# kernel K4: decode attention over the contiguous cache
# ---------------------------------------------------------------------------

# the generate step's attention: Llama-3-8B heads, batch 8, prompts
# bucketed to 512 plus 64 new tokens
GEN_B, GEN_PROMPT, GEN_NEW = 8, 512, 64
DECODE_MAIN = "c575"
DECODE_CASES = {
    # name: (B, H, Hkv, S, D, dtype, int8 cache, window, cache_index)
    "c0": (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D, torch.bfloat16, False,
           None, 0),
    "c15": (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D, torch.bfloat16, False,
            None, 15),
    "c300": (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D, torch.bfloat16, False,
             None, 300),
    DECODE_MAIN: (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D, torch.bfloat16,
                  False, None, 575),
    "int8_c575": (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D, torch.bfloat16,
                  True, None, 575),
    "window256_c575": (GEN_B, H, HKV, GEN_PROMPT + GEN_NEW, D,
                       torch.bfloat16, False, 256, 575),
    "fp32_d64_g1_c777": (4, 8, 8, 1000, 64, torch.float32, False, None, 777),
    # GPT-2 125M's generate decode (12 heads of 64, no GQA)
    "gpt2_d64_c575": (GEN_B, 12, 12, GEN_PROMPT + GEN_NEW, 64,
                      torch.bfloat16, False, None, 575),
    # Pythia-6.9B's generate decode (32 heads of 128, no GQA)
    "pythia_d128_g1_c575": (GEN_B, 32, 32, GEN_PROMPT + GEN_NEW, 128,
                            torch.bfloat16, False, None, 575),
    # longer caches, the cache index near their end
    "c2040_s2048": (GEN_B, H, HKV, 2048, D, torch.bfloat16, False, None,
                    2040),
    "c8180_s8192": (GEN_B, H, HKV, 8192, D, torch.bfloat16, False, None,
                    8180),
    # Falcon-7B's decode: 71 query heads on one kv head, D 64 (the
    # multi-tile tensor-core kernel; fp32 and the int8 cache on the CUDA
    # cores, 8 heads a block)
    "falcon7b_g71_c575": (GEN_B, 71, 1, GEN_PROMPT + GEN_NEW, 64,
                          torch.bfloat16, False, None, 575),
    "falcon7b_g71_fp32_c575": (GEN_B, 71, 1, GEN_PROMPT + GEN_NEW, 64,
                               torch.float32, False, None, 575),
    "falcon7b_g71_int8_c575": (GEN_B, 71, 1, GEN_PROMPT + GEN_NEW, 64,
                               torch.bfloat16, True, None, 575),
    # Gemma-2B's decode: 8 query heads on one kv head, D 256
    "gemma2b_g8_d256_c575": (GEN_B, 8, 1, GEN_PROMPT + GEN_NEW, 256,
                             torch.bfloat16, False, None, 575),
    # GPT-J-6B (16 of 256), Phi-2 (32 of 80), GPT-NeoX-20B (64 of 96)
    "gptj_d256_c575": (GEN_B, 16, 16, GEN_PROMPT + GEN_NEW, 256,
                       torch.bfloat16, False, None, 575),
    "phi2_d80_c575": (GEN_B, 32, 32, GEN_PROMPT + GEN_NEW, 80,
                      torch.bfloat16, False, None, 575),
    "neox20b_d96_c575": (GEN_B, 64, 64, GEN_PROMPT + GEN_NEW, 96,
                         torch.bfloat16, False, None, 575),
    "gptj_d256_fp32_c575": (4, 16, 16, GEN_PROMPT + GEN_NEW, 256,
                            torch.float32, False, None, 575),
}


def decode_case(B, Hq, Hkv, S, Dh, dtype, int8, seed):
    """q, caches and a key mask with seeded left-padding holes (each row's
    first 0-199 positions masked)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Hq, Dh), generator=g, device="cuda", dtype=dtype)
    shape = (B, Hkv, S, Dh)
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                              dtype=torch.int8) for _ in range(2))
        scales = {n: torch.rand(shape[:3], generator=g, device="cuda") / 64
                  for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(shape, generator=g, device="cuda", dtype=dtype)
                for _ in range(2))
        scales = {}
    pads = np.random.RandomState(seed).randint(0, 200, B)
    mask = (np.arange(S)[None] >= pads[:, None]).astype(np.int32)
    return q, k, v, torch.from_numpy(mask).cuda(), scales


def decode_bound(mask, Hq, Hkv, Dh, elem, int8, window, cidx, q_elem):
    """``(ms, "bytes" | "operations")``: the K/V (and scales) of the keys
    each row can see (inside the filled prefix or window and not masked)
    read once per kv head, the mask's prefix, q and the output, over HBM
    bandwidth; 4 D FLOPs per (query head, visible key) at the bf16 peak."""
    B, S = mask.shape
    hi = min(cidx, S - 1)
    lo = 0 if window is None else max(0, cidx - window + 1)
    prefix = max(0, hi - lo + 1)
    keys = int((mask[:, lo:hi + 1] > 0).sum()) if prefix else 0
    nbytes = Hkv * keys * (2 * Dh * elem + (8 if int8 else 0)) \
        + B * prefix * 4 + 2 * B * Hq * Dh * q_elem
    return bound(nbytes, 4 * Hq * Dh * keys, BF16_FLOP_PER_S)


def check_decode_attention():
    """K4 against its plain version. Tolerance: fp32 1e-5 (summation
    order only); bf16 |kernel - plain| <= 2**-7 * |plain| + 1e-3 (both are
    bf16 roundings of fp32 results that differ only in summation order:
    one bf16 ulp). Library yardstick: SDPA over the filled prefix with a
    boolean key mask and enable_gqa, for the bf16 cases without a window
    or int8 cache."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.decode_attention import (
        _sm_count, decode_attention, decode_attention_plain, decode_splits)

    results = {}
    for name, (B, Hq, Hkv, S, Dh, dtype, int8, window, cidx) in \
            DECODE_CASES.items():
        q, k, v, mask, scales = decode_case(B, Hq, Hkv, S, Dh, dtype, int8,
                                            seed=len(results) + 11)
        ci = torch.tensor(cidx, dtype=torch.int32, device="cuda")
        kw = dict(key_mask=mask, window=window, **scales)
        got = decode_attention(q, k, v, ci, **kw)
        ref = decode_attention_plain(q, k, v, ci, **kw)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else \
            (2 ** -7, 1e-3)
        if not bool((err <= rtol * ref.float().abs() + atol).all()):
            raise AssertionError(f"decode_attention {name} disagrees with "
                                 f"its plain version (max |err| "
                                 f"{float(err.max()):.3e})")
        ms = cuda_time_ms(lambda: decode_attention(q, k, v, ci, **kw))
        plain_ms = cuda_time_ms(
            lambda: decode_attention_plain(q, k, v, ci, **kw), reps=5,
            warmup=1)
        library_ms = None
        if dtype == torch.bfloat16 and window is None and not int8:
            n = min(cidx, S - 1) + 1
            q4 = q[:, :, None]
            kf, vf = k[:, :, :n], v[:, :, :n]
            am = (mask[:, :n] > 0)[:, None, None, :]
            library_ms = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(
                    q4, kf, vf, attn_mask=am, enable_gqa=True))
        bms, by = decode_bound(mask, Hq, Hkv, Dh, k.element_size(), int8,
                               window, cidx, q.element_size())
        results[name] = dict(max_abs_err=float(err.max()), ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             library_ms=library_ms)
        splits = decode_splits(B, Hkv, S, _sm_count(0))
        log(f"parity decode_attention {name} (B {B} H {Hq} Hkv {Hkv} S {S} "
            f"D {Dh} {str(dtype)[6:]} int8 {int8} window {window} "
            f"cache_index {cidx}, {splits} splits): ok max_abs_err="
            f"{float(err.max()):.3e} "
            f"(tolerance {rtol:g}*|plain|+{atol:g}) | kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.4f} ({by}) "
            f"library_ms={library_ms}")
        del q, k, v, mask, scales, got, ref
    return results


# ---------------------------------------------------------------------------
# kernels K5 and K8: quantized matmuls
# ---------------------------------------------------------------------------

# Llama-3-8B projections: gate/up (4096 -> 14336), down (14336 -> 4096),
# q/o (4096 -> 4096); decode M = batch 8, prefill M = 8 x 512
QUANT_MAIN = "decode_up_int8"
QUANT_PREFILL_MAIN = "prefill_q_int8"
QUANT_CASES = {
    # name: (M, K, N, mode, group, dtype)
    "decode_up_int8": (8, 4096, 14336, "int8", 0, torch.bfloat16),
    "decode_up_int4g64": (8, 4096, 14336, "int4", 64, torch.bfloat16),
    "decode_down_int8": (8, 14336, 4096, "int8", 0, torch.bfloat16),
    "decode_down_int4g64": (8, 14336, 4096, "int4", 64, torch.bfloat16),
    "decode_q_int8": (8, 4096, 4096, "int8", 0, torch.bfloat16),
    "decode_q_int4g64": (8, 4096, 4096, "int4", 64, torch.bfloat16),
    "decode_kv_int8": (8, 4096, 1024, "int8", 0, torch.bfloat16),
    "decode_kv_int4g64": (8, 4096, 1024, "int4", 64, torch.bfloat16),
    "decode_up_int8_m1": (1, 4096, 14336, "int8", 0, torch.bfloat16),
    "prefill_q_int8": (4096, 4096, 4096, "int8", 0, torch.bfloat16),
    "prefill_q_int4g64": (4096, 4096, 4096, "int4", 64, torch.bfloat16),
    "prefill_up_int8": (4096, 4096, 14336, "int8", 0, torch.bfloat16),
    "prefill_down_int8": (4096, 14336, 4096, "int8", 0, torch.bfloat16),
    "prefill_up_int4g64": (4096, 4096, 14336, "int4", 64, torch.bfloat16),
    "fp32_m8_int4g64": (8, 4096, 4096, "int4", 64, torch.float32),
    "fp32_m300_int8g128": (300, 4096, 1024, "int8", 128, torch.float32),
    "ragged_m8_int4g8": (8, 264, 1000, "int4", 8, torch.bfloat16),
    "ragged_m37_int8": (37, 264, 1000, "int8", 0, torch.bfloat16),
    # rows TMA cannot address at widths where bytes (decode) and operations
    # (prefill, 41 groups of 100 rows) bound the ragged kernel
    "ragged_wide_m8_int8": (8, 4100, 14330, "int8", 0, torch.bfloat16),
    "ragged_wide_m512_int4g100": (512, 4100, 14330, "int4", 100,
                                  torch.bfloat16),
    # the fp32 decode (gemv_tf32) at per-column int8 and at an odd N (code
    # rows through cp.async windows, not TMA)
    "fp32_m8_int8": (8, 4096, 4096, "int8", 0, torch.float32),
    "fp32_m8_int4g64_n4099": (8, 4096, 4099, "int4", 64, torch.float32),
    # GPT-2 125M's projections (c_attn 768 -> 2304, mlp c_fc 768 -> 3072,
    # mlp c_proj 3072 -> 768) in its int8 generate
    "gpt2_decode_attn_int8": (8, 768, 2304, "int8", 0, torch.bfloat16),
    "gpt2_decode_fc_int8": (8, 768, 3072, "int8", 0, torch.bfloat16),
    "gpt2_decode_proj_int8": (8, 3072, 768, "int8", 0, torch.bfloat16),
    "gpt2_prefill_fc_int8": (4096, 768, 3072, "int8", 0, torch.bfloat16),
}
# the fp32 decode's entry of the kernels line
GEMV_TF32_MAIN = "fp32_m8_int4g64"
# the ragged kernel's entries of the kernels line (decode: M <= 8, prefill:
# M > 8), each held at its wide case
RAGGED_MAIN = {"decode": "ragged_wide_m8_int8",
               "prefill": "ragged_wide_m512_int4g100"}
INT8_COL_MAIN = "decode_up"
INT8_COL_CASES = {
    # name: (M, K, N, dtype)
    "decode_up": (8, 4096, 14336, torch.bfloat16),
    "decode_down": (8, 14336, 4096, torch.bfloat16),
    "prefill_q": (4096, 4096, 4096, torch.bfloat16),
    "prefill_up": (4096, 4096, 14336, torch.bfloat16),
    "ragged_m37_fp32": (37, 264, 1000, torch.float32),
    "ragged_wide_m8": (8, 4100, 14330, torch.bfloat16),
    "fp32_m8": (8, 4096, 4096, torch.float32),
}


def _matmul_tolerance(x, w, dtype):
    """Per-element bound on |kernel - plain|: a reordered fp32 sum of K
    products errs by far less than 1e-5 of the sum of their magnitudes
    (|x| @ |W|); a bf16 output adds one bf16 ulp (2**-7 |plain|), as both
    sides round nearly equal fp32 sums."""
    mag = x.float().abs() @ w.float().abs()
    return mag * 1e-5, 2 ** -7 if dtype == torch.bfloat16 else 0.0


def _quant_route(qm, M, K, N, mode, dtype):
    """The route a quantized matmul takes, with the gemv_tc kernel's column
    tiles and cluster size, the ragged kernel's row and column tiles and
    cluster size, or the fp32 route's grid and K splits, on this card."""
    route = qm.kernel_route(M, K, N, dtype)
    if route == "gemv_tc":
        tiles, cluster = qm.gemv_tc_grid(K, N, mode, qm._sm_count(0))
        route += f" {tiles} tiles x cluster {cluster}"
    elif route == "ragged":
        mt, wn, ct, rt, cluster = qm.ragged_grid(M, K, N, qm._sm_count(0))
        route += (f" {rt} x {ct} tiles of {8 * mt} rows x "
                  f"{qm.ragged_warp_cols(mt) * wn} columns x cluster "
                  f"{cluster}")
    elif route == "fp32":
        grid = qm.fp32_grid(M, K, N, qm._sm_count(0))
        route += (f" tensor cores (x as two TF32 parts), grid {grid}, "
                  f"{grid[2]} K splits")
    elif route == "gemv_tf32":
        tiles, cluster = qm.gemv_tf32_grid(K, N, qm._sm_count(0))
        route += (f" tensor cores (x as two TF32 parts), {tiles} tiles x "
                  f"cluster {cluster}, codes by "
                  f"{'TMA' if N % 16 == 0 and K % 4 == 0 else 'cp.async'}")
    return route


def _matmul_bound(qm, M, K, N, dtype, nbytes):
    """``(ms, by, note)``: the bound of a quantized matmul for the
    arithmetic its route runs. bf16: 2 M K N operations at the bf16 peak.
    fp32 (both routes, M > 8 and the decode) runs every product twice on
    the tensor cores (x as two TF32 parts): 4 M K N at the TF32 peak, with
    the CUDA-core bound of 2 M K N at the fp32 peak in ``note``."""
    flops = 2 * M * K * N
    if dtype == torch.bfloat16:
        return (*bound(nbytes, flops, BF16_FLOP_PER_S), "")
    cuda_core = bound(nbytes, flops, FP32_FLOP_PER_S)[0]
    return (*bound(nbytes, 2 * flops, TF32_FLOP_PER_S),
            f" (CUDA-core bound {cuda_core:.4f})")


def check_graph_replay(call, plain, x, tol, name, g):
    """A CUDA graph captured around ``call(x)``, replayed over two new x
    values written into the captured input, must match ``plain`` within
    ``tol(x)`` each time (the launch reads no device value and allocates
    nothing outside the graph)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call(x)
    for _ in range(2):
        x.copy_(torch.randn(x.shape, generator=g, device="cuda",
                            dtype=x.dtype))
        graph.replay()
        ref = plain(x)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= tol(x)).all()):
            raise AssertionError(f"{name}: the CUDA-graph replay disagrees "
                                 f"with the plain version (max |err| "
                                 f"{float(err.max()):.3e})")
    del graph


def check_quant_matmul():
    """K5 against its plain version at Llama-3-8B projection shapes (and
    fp32, ragged cases), then K8 likewise. Library yardstick: torch.matmul
    on the pre-dequantized weight in x's type (it reads 2x the int8 or 4x
    the int4 weight bytes)."""
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    results = {}
    for name, (M, K, N, mode, group, dtype) in QUANT_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(len(results) + 21)
        x = torch.randn((M, K), generator=g, device="cuda", dtype=dtype)
        w = torch.randn((K, N), generator=g, device="cuda") * 0.02
        codes, scale = qm.quantize_linear_weight(w, mode, group)
        del w
        ragged = qm.quant_matmul.ragged_launches
        got = qm.quant_matmul(x, codes, scale, mode)
        ragged = qm.quant_matmul.ragged_launches - ragged
        if ragged != int(qm.kernel_route(M, K, N, dtype) == "ragged"):
            raise AssertionError(f"quant_matmul {name}: {ragged} ragged "
                                 f"kernel launches")
        ref = qm.quant_matmul_plain(x, codes, scale, mode)
        wd = qm.dequantize_linear_weight(codes, scale, mode, dtype)
        abs_tol, rel = _matmul_tolerance(x, wd, dtype)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= rel * ref.float().abs() + abs_tol).all()):
            raise AssertionError(f"quant_matmul {name} disagrees with its "
                                 f"plain version (max |err| "
                                 f"{float(err.max()):.3e})")
        del abs_tol
        replay = ""
        if qm.kernel_route(M, K, N, dtype) == "gemv_tf32":
            check_graph_replay(
                lambda xx: qm.quant_matmul(xx, codes, scale, mode),
                lambda xx: qm.quant_matmul_plain(xx, codes, scale, mode),
                x.clone(), lambda xx: _matmul_tolerance(xx, wd, dtype)[0],
                f"quant_matmul {name}", g)
            replay = ", CUDA-graph replay ok"
        ms = cuda_time_ms(lambda: qm.quant_matmul(x, codes, scale, mode))
        plain_ms = cuda_time_ms(
            lambda: qm.quant_matmul_plain(x, codes, scale, mode), reps=5,
            warmup=1)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, wd))
        nbytes = codes.numel() + scale.numel() * 4 \
            + (M * K + M * N) * x.element_size()
        bms, by, note = _matmul_bound(qm, M, K, N, dtype, nbytes)
        results[name] = dict(max_abs_err=float(err.max()), ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             library_ms=library_ms)
        log(f"parity quant_matmul {name} (M {M} K {K} N {N} {mode} group "
            f"{K // scale.shape[0]} {str(dtype)[6:]}, route "
            f"{_quant_route(qm, M, K, N, mode, dtype)}): ok max_abs_err="
            f"{float(err.max()):.3e} (tolerance {rel:g}*|plain|+1e-5*"
            f"(|x|@|W|)){replay} | kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={bms:.4f} ({by}){note} library_ms="
            f"{library_ms:.4f} (torch.matmul on the pre-dequantized weight) | "
            f"{nbytes / ms / 1e6:.1f} GB/s, {bms / ms:.1%} of the bound")
        del x, codes, scale, got, ref, wd
    col = {}
    for name, (M, K, N, dtype) in INT8_COL_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(len(col) + 41)
        x = torch.randn((M, K), generator=g, device="cuda", dtype=dtype)
        codes, scale = qm.quantize_weight_per_col(
            torch.randn((K, N), generator=g, device="cuda") * 0.02)
        ragged = qm.int8_matmul.ragged_launches
        got = qm.int8_matmul(x, codes, scale)
        ragged = qm.int8_matmul.ragged_launches - ragged
        if ragged != int(qm.kernel_route(M, K, N, dtype) == "ragged"):
            raise AssertionError(f"int8_matmul {name}: {ragged} ragged "
                                 f"kernel launches")
        ref = qm.int8_matmul_plain(x, codes, scale)
        wd = (codes.float() * scale).to(dtype)
        abs_tol, rel = _matmul_tolerance(x, wd, dtype)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= rel * ref.float().abs() + abs_tol).all()):
            raise AssertionError(f"int8_matmul {name} disagrees with its "
                                 f"plain version (max |err| "
                                 f"{float(err.max()):.3e})")
        replay = ""
        if qm.kernel_route(M, K, N, dtype) == "gemv_tf32":
            check_graph_replay(
                lambda xx: qm.int8_matmul(xx, codes, scale),
                lambda xx: qm.int8_matmul_plain(xx, codes, scale),
                x.clone(), lambda xx: _matmul_tolerance(xx, wd, dtype)[0],
                f"int8_matmul {name}", g)
            replay = ", CUDA-graph replay ok"
        ms = cuda_time_ms(lambda: qm.int8_matmul(x, codes, scale))
        plain_ms = cuda_time_ms(lambda: qm.int8_matmul_plain(x, codes, scale),
                                reps=5, warmup=1)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, wd))
        nbytes = codes.numel() + N * 4 + (M * K + M * N) * x.element_size()
        bms, by, note = _matmul_bound(qm, M, K, N, dtype, nbytes)
        col[name] = dict(max_abs_err=float(err.max()), ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=library_ms)
        log(f"parity int8_matmul {name} (M {M} K {K} N {N} "
            f"{str(dtype)[6:]}, route "
            f"{_quant_route(qm, M, K, N, 'int8_col', dtype)}): "
            f"ok max_abs_err={float(err.max()):.3e}{replay} | "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms="
            f"{bms:.4f} ({by}){note} library_ms={library_ms:.4f} | "
            f"{nbytes / ms / 1e6:.1f} GB/s, {bms / ms:.1%} of the bound")
        del x, codes, scale, got, ref, wd
    return results, col


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def serving_kernels():
    """The wrappers of the serving paths' attention kernels, by name: K6,
    K7a, K7b and the masked K1."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops.flash_attention import \
        flash_attention_fwd_masked
    from deepspeed_tpu_torch.ops.ragged_attention import ragged_paged_attention

    return {"ragged_paged_attention": ragged_paged_attention,
            "paged_decode_attention": da.paged_decode_attention,
            "paged_prefill_attention": da.paged_prefill_attention,
            "flash_attention_fwd_masked": flash_attention_fwd_masked}


def serve(cfg, params_seed, n_requests, prompt_range, new_range, scfg,
          dtype, device="cuda", quantize_weights=None, phases=None,
          params=None, engine_kw=None, srv=None):
    """init_inference + ServingEngine on ``cfg`` with seeded random
    weights (or ``params``, a state_dict already on the device; the
    inference config takes ``engine_kw`` too), or ``srv``, an engine
    already built; serves seeded traffic to completion and returns the
    engine, the request ids, the outputs, the wall time and the launches
    of each serving kernel in the run (the wrappers' counts; K6's on the
    device, which replays of CUDA graphs add to, from
    ``ragged_attention.kernel_runs()`` after it). ``phases``, a list of
    lists of ``(prompt, max_new_tokens)``, replaces the seeded traffic:
    each phase is submitted together and drained before the next."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaForCausalLM
    from deepspeed_tpu_torch.ops import ragged_attention as ra

    if srv is None:
        model = LlamaForCausalLM(cfg)
        if params is None:
            params = model.init_params(seed=params_seed, dtype=dtype,
                                       device=device)
        engine = dt.init_inference(model, params=params, dtype=dtype,
                                   device=device,
                                   quantize_weights=quantize_weights,
                                   **(engine_kw or {}))
        srv = dt.ServingEngine(engine, dt.ServingConfig(**scfg))
    if phases is None:
        phases = [seeded_traffic(cfg.vocab_size, params_seed, n_requests,
                                 prompt_range, new_range)]
    if device == "cuda":
        torch.cuda.synchronize()
        ra.reset_kernel_runs()
    kernels = serving_kernels()
    for fn in kernels.values():
        fn.launches = 0
    rids, res = [], {}
    t0 = time.perf_counter()
    for phase in phases:
        rids += [srv.submit(prompt, max_new_tokens=n) for prompt, n in phase]
        res = srv.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return srv, rids, res, wall, {n: fn.launches for n, fn in kernels.items()}


def seeded_traffic(vocab, seed, n, prompt_range, new_range):
    """``n`` seeded ``(prompt, max_new_tokens)`` requests: prompt lengths
    and token budgets uniform in their (inclusive) ranges."""
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab, int(rs.randint(prompt_range[0],
                                                 prompt_range[1] + 1))),
             int(rs.randint(new_range[0], new_range[1] + 1)))
            for _ in range(n)]


def step_widths(srv, since=0):
    """The packed width of each unified step the engine's tracer holds,
    from its ``since``-th on."""
    return [e["args"]["width"] for e in srv.tracer.events()
            if e["name"] == "mixed_step"][since:]


#: the small fp32 reference model: 2 layers, head_dim 128, GQA group 2
SMALL_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=1)


class plain_route:
    """Inside the block, the model's kernel wrappers are swapped for their
    plain versions (K6, K7a, K7b, K4, K5 and masked K1 calls run the plain
    PyTorch code)."""

    def __enter__(self):
        from deepspeed_tpu_torch.models import layers as layers_mod
        from deepspeed_tpu_torch.ops import decode_attention as da
        from deepspeed_tpu_torch.ops import flash_attention as fa
        from deepspeed_tpu_torch.ops import quant_matmul as qm
        from deepspeed_tpu_torch.ops import ragged_attention as ra

        def masked_plain(q, k, v, causal=True, sm_scale=None, window=None,
                         key_mask=None):
            return fa.flash_attention_plain(q, k, v, causal, sm_scale,
                                            window, key_mask=key_mask)[0]

        self.saved = [(layers_mod, "ragged_paged_attention",
                       ra.ragged_paged_attention_plain),
                      (layers_mod, "paged_decode_attention",
                       da.paged_decode_attention_plain),
                      (layers_mod, "paged_prefill_attention",
                       da.paged_prefill_attention_plain),
                      (layers_mod, "decode_attention",
                       da.decode_attention_plain),
                      (layers_mod, "flash_attention", masked_plain),
                      (layers_mod, "quant_matmul", qm.quant_matmul_plain)]
        self.saved = [(mod, name, getattr(mod, name), plain)
                      for mod, name, plain in self.saved]
        for mod, name, _, plain in self.saved:
            setattr(mod, name, plain)

    def __exit__(self, *exc):
        for mod, name, kernel, _ in self.saved:
            setattr(mod, name, kernel)


def check_small_reference():
    """The same seeded traffic through a 2-layer model (head_dim 128, GQA
    group 2) in fp32, with fp32 and with int8 weights, each once as
    shipped (the kernels), once with the model's kernel wrappers swapped
    for their plain versions, and once as shipped with enable_cuda_graph
    and mixed_step_buckets (every width captured, then replayed): greedy
    tokens must be identical (the kernel and plain routes differ by fp32
    summation order), and the captured run must run K6 once per layer per
    step on the device."""
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    cfg = LlamaConfig(**SMALL_CFG)
    scfg = dict(max_batch_size=4, block_size=16, num_blocks=64,
                max_model_len=128, prefill_token_budget=32, trace=True)
    for weights in (None, "int8"):
        tokens, launches = {}, {}
        for route in ("kernel", "plain", "captured"):
            quant_matmul.launches = 0
            ekw, skw = SERVE_GRAPH if route == "captured" else ({}, {})
            with plain_route() if route == "plain" else \
                    contextlib.nullcontext():
                srv, rids, res, _, counts = serve(
                    cfg, 3, 6, (5, 90), (4, 12), dict(scfg, **skw),
                    torch.float32, quantize_weights=weights, engine_kw=ekw)
            steps = len(step_widths(srv))
            launches[route] = (counts["ragged_paged_attention"],
                               quant_matmul.launches, kernel_runs(),
                               cfg.num_hidden_layers * steps)
            tokens[route] = [(res[r].state, res[r].tokens) for r in rids]
        ok = tokens["kernel"] == tokens["plain"] == tokens["captured"] and \
            all(s == "finished" for s, _ in tokens["kernel"]) and \
            launches["kernel"][0] > 0 and \
            (launches["kernel"][1] > 0) == (weights is not None) and \
            launches["plain"][:3] == (0, 0, 0) and \
            launches["kernel"][2] == launches["kernel"][3] and \
            launches["captured"][2] == launches["captured"][3] > 0
        log(f"reference: 2-layer fp32 model served, weights "
            f"{weights or 'fp32'}, kernels vs plain versions vs captured "
            f"with bucketed widths, {len(tokens['kernel'])} requests: tokens "
            f"identical={ok} (K6, K5 wrapper launches, K6 device runs, "
            f"layers x steps: {launches['kernel']} / {launches['plain']} / "
            f"{launches['captured']})")
        if not ok:
            raise AssertionError(f"kernels, plain versions and the captured "
                                 f"step served different tokens on the "
                                 f"small fp32 model (weights "
                                 f"{weights or 'fp32'}) or K6 ran the wrong "
                                 f"number of times")


def shared_prefix_phases(vocab, n_prefixes, per_prefix, prefix_len,
                         suffix_range, new_range, seed):
    """Seeded shared-prefix traffic in two phases: the first request of
    every prefix, then all the others (pages index as chunks land, so a
    request hits only what an earlier one has written). Each prompt is its
    group's ``prefix_len`` tokens plus a unique suffix."""
    rs = np.random.RandomState(seed)
    prefixes = [rs.randint(0, vocab, prefix_len) for _ in range(n_prefixes)]
    reqs = [(np.concatenate([prefixes[g], rs.randint(0, vocab, int(
        rs.randint(suffix_range[0], suffix_range[1] + 1)))]),
        int(rs.randint(new_range[0], new_range[1] + 1)))
        for _ in range(per_prefix) for g in range(n_prefixes)]
    return [reqs[:n_prefixes], reqs[n_prefixes:]]


def check_small_legacy_reference(device="cuda"):
    """The two-program engine on the 2-layer fp32 model, once as shipped
    (the kernels) and once with the model's kernel wrappers swapped for
    their plain versions: identical greedy tokens. Two configurations:
    chunked prefill with the prefix cache on shared-prefix traffic (K7a
    and K7b), and the monolithic prefill with prefill_flash_from_empty
    (K7a and the masked K1)."""
    from deepspeed_tpu_torch.models import LlamaConfig

    phases = shared_prefix_phases(SMALL_CFG["vocab_size"], 2, 3, 32, (3, 40),
                                  (4, 12), 5)
    base = dict(max_batch_size=4, block_size=16, num_blocks=64,
                max_model_len=128, mixed_step=False)
    cases = {
        "chunked+prefix_cache": (
            {}, dict(base, prefix_cache=True, prefill_chunk_tokens=16,
                     prefill_token_budget=32),
            ("paged_decode_attention", "paged_prefill_attention")),
        "monolithic+flash": (
            {"prefill_flash_from_empty": True}, base,
            ("paged_decode_attention", "flash_attention_fwd_masked")),
    }
    for name, (over, scfg, expected) in cases.items():
        cfg = LlamaConfig(**SMALL_CFG, **over)
        tokens, launches, hits = {}, {}, {}
        for route in ("kernel", "plain"):
            with plain_route() if route == "plain" else \
                    contextlib.nullcontext():
                srv, rids, res, _, launches[route] = serve(
                    cfg, 3, 0, None, None, scfg, torch.float32,
                    device=device, phases=phases)
            tokens[route] = [(res[r].state, res[r].tokens) for r in rids]
            hits[route] = srv.metrics.prefix_hits
            srv.block_pool.check_consistent()
            if srv.block_pool.used_count:
                raise AssertionError(f"small two-program serve {name}: "
                                     f"{srv.block_pool.used_count} pages "
                                     f"leaked")
        ran = {n for n, c in launches["kernel"].items() if c}
        ok = tokens["kernel"] == tokens["plain"] and \
            all(st == "finished" for st, _ in tokens["kernel"]) and \
            ran == set(expected) and not any(launches["plain"].values()) \
            and hits["kernel"] == hits["plain"] and \
            (hits["kernel"] >= 4) == scfg.get("prefix_cache", False)
        log(f"reference: 2-layer fp32 model served by the two-program "
            f"engine, {name}, kernels vs plain versions, "
            f"{len(tokens['kernel'])} requests: tokens identical="
            f"{tokens['kernel'] == tokens['plain']} ok={ok} (prefix hits "
            f"{hits['kernel']}, launches {launches['kernel']} / "
            f"{launches['plain']})")
        if not ok:
            raise AssertionError(f"small two-program serve {name}: kernels "
                                 f"and plain versions disagree or a route "
                                 f"launched the wrong kernels")


# ---------------------------------------------------------------------------
# the dense generate path
# ---------------------------------------------------------------------------

def left_padded_prompts(vocab, batch, lo, hi, seed):
    """``(ids, mask)`` int numpy ``[batch, max_len]``: seeded prompt
    lengths in ``[lo, hi]``, left-padded with 0 (mask 0)."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(lo, hi + 1, batch)
    T = int(lens.max())
    ids = np.zeros((batch, T), np.int64)
    mask = np.zeros((batch, T), np.int32)
    for b, n in enumerate(lens):
        ids[b, T - n:] = rs.randint(1, vocab, n)
        mask[b, T - n:] = 1
    return ids, mask


def generate_run(cfg, dtype, quantize_weights, ids, mask, max_new_tokens,
                 device="cuda", kv_cache_int8=False, engine_kw=None,
                 engine=None):
    """init_inference on seeded random weights (seed 0; the inference
    config takes ``engine_kw`` too; or ``engine``, an inference engine
    already built), two ``generate`` calls of one token
    (prefill and the first sample; the first pays the engine's first-use
    costs, the second's time is the prefill's), with ``enable_cuda_graph``
    one of ``max_new_tokens`` (its first decode step runs eagerly and is
    then captured as the graph that the counted run replays; a call
    without a decode step keeps it), then the counted ``generate``: the
    kernel counts are set to 0 just before it (the wrappers count where
    they run, so a captured run's counts are its prefill's and none of
    its replays'). Returns the tokens, the engine, the prefill and total
    seconds, the launches of K4, K5, the masked K1, K5's wgmma prefill
    kernel, its gemv_tc decode kernel, its ragged kernel, K8 and K5's fp32
    decode kernel (gemv_tf32) in the counted run, the same counts over
    the capturing warm-up (the prefill, the eager step and the capture,
    each once; None without ``enable_cuda_graph``), and whether every
    logit of the counted run was finite."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaForCausalLM
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.flash_attention import \
        flash_attention_fwd_masked
    from deepspeed_tpu_torch.ops.quant_matmul import int8_matmul, quant_matmul

    if engine is None:
        model = LlamaForCausalLM(cfg)
        params = model.init_params(seed=0, dtype=dtype, device=device)
        engine = dt.init_inference(model, params=params, dtype=dtype,
                                   device=device,
                                   quantize_weights=quantize_weights,
                                   kv_cache_int8=kv_cache_int8,
                                   **(engine_kw or {}))
        del params

    def zero():
        decode_attention.launches = quant_matmul.launches = 0
        flash_attention_fwd_masked.launches = quant_matmul.wgmma_launches = 0
        quant_matmul.gemv_tc_launches = quant_matmul.ragged_launches = 0
        int8_matmul.launches = quant_matmul.gemv_tf32_launches = 0

    def counts():
        return (decode_attention.launches, quant_matmul.launches,
                flash_attention_fwd_masked.launches,
                quant_matmul.wgmma_launches, quant_matmul.gemv_tc_launches,
                quant_matmul.ragged_launches, int8_matmul.launches,
                quant_matmul.gemv_tf32_launches)

    finite = []
    engine.module.register_forward_hook(
        lambda mod, args, out: finite.append(torch.isfinite(out[0]).all()))
    engine.generate(ids, attention_mask=mask, max_new_tokens=1)
    capture = None
    if engine.config.enable_cuda_graph:
        zero()
        engine.generate(ids, attention_mask=mask,
                        max_new_tokens=max_new_tokens)
        capture = counts()
    engine.profile_model_time()
    engine.generate(ids, attention_mask=mask, max_new_tokens=1)
    finite.clear()
    zero()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = engine.generate(ids, attention_mask=mask,
                          max_new_tokens=max_new_tokens)
    prefill_s, total_s = engine.model_times()
    return out, engine, prefill_s, total_s, counts(), capture, \
        bool(torch.stack(finite).all())


def check_small_generate_reference(device="cuda"):
    """A 2-layer fp32 model (head_dim 128, GQA group 2) generating 24
    greedy tokens for 4 left-padded prompts, once through the kernels and
    once with the model's kernel wrappers swapped for their plain
    versions: tokens must be identical (fp32 summation order is the only
    difference), the kernel route must launch K4 (and K5 with quantized
    weights, the masked K1 once per layer with the flash prefill), the
    plain route nothing. Cases: fp32 weights, int8 and int4 weights, an
    int8 cache, window 64, prefill_flash_from_empty."""
    from deepspeed_tpu_torch.models import LlamaConfig

    ids, mask = left_padded_prompts(SMALL_CFG["vocab_size"], 4, 5, 90, 7)
    cases = {"fp32": ({}, {}), "int8": ({}, {"quantize_weights": "int8"}),
             "int4": ({}, {"quantize_weights": "int4"}),
             "kv_int8": ({}, {"kv_cache_int8": True}),
             "window64": ({"sliding_window": 64}, {}),
             "flash_prefill": ({"prefill_flash_from_empty": True}, {})}
    tf32_launches = 0
    for name, (over, kw) in cases.items():
        cfg = LlamaConfig(**SMALL_CFG, **over)
        got = {}
        routes = ("kernel", "plain", "captured") if name in ("fp32", "int8") \
            else ("kernel", "plain")
        for route in routes:
            with plain_route() if route == "plain" else \
                    contextlib.nullcontext():
                out, _, _, _, launches, capture, finite = generate_run(
                    cfg, torch.float32, kw.get("quantize_weights"), ids,
                    mask, 24, device=device,
                    kv_cache_int8=kw.get("kv_cache_int8", False),
                    engine_kw=dict(enable_cuda_graph=route == "captured"))
            got[route] = (out.cpu().tolist(), launches, finite, capture)
        quant = "quantize_weights" in kw
        L = cfg.num_hidden_layers
        flash = L * cfg.prefill_flash_from_empty
        # fp32 x: the quantized decode steps run K5's fp32 decode kernel;
        # the captured graph holds K4 and (quantized) gemv_tf32 once per
        # layer and projection: the warm-up runs the prefill (K5 on the
        # fp32 tile route), the eager step and the capture, and the
        # counted run's replays add nothing to the wrappers' counts
        ok = got["kernel"][0] == got["plain"][0] and got["kernel"][2] and \
            got["kernel"][1][0] > 0 and \
            (got["kernel"][1][1] > 0) == quant and \
            (got["kernel"][1][7] > 0) == quant and \
            got["kernel"][1][2] == flash and \
            got["plain"][1] == (0,) * 8
        if "captured" in got:
            k5 = 7 * L if quant else 0
            ok = ok and got["captured"][0] == got["kernel"][0] and \
                got["captured"][2] and \
                got["captured"][3] == (2 * L, 3 * k5, 0, 0, 0, 0, 0,
                                       2 * k5) and \
                got["captured"][1] == (0, k5, 0, 0, 0, 0, 0, 0)
        if name == "int8":
            tf32_launches = got["kernel"][1][7]
        log(f"reference: 2-layer fp32 model generate {name}, kernels vs "
            f"plain versions{' vs the captured decode step' if len(routes) == 3 else ''}, "
            f"4 prompts x 24 tokens: tokens identical="
            f"{got['kernel'][0] == got['plain'][0]} ok={ok} (K4, K5, masked "
            f"K1, wgmma K5, gemv_tc K5, ragged K5, K8, gemv_tf32 K5 launches "
            f"{got['kernel'][1]} / "
            f"{got['plain'][1]}"
            f"{'; captured: warm-up (prefill, eager step, capture) ' + str(got['captured'][3]) + ', replayed run ' + str(got['captured'][1]) if 'captured' in got else ''})")
        if not ok:
            raise AssertionError(f"small generate {name}: kernels, plain "
                                 f"versions and the captured step disagree "
                                 f"or a route launched the wrong kernels")
    return tf32_launches


def check_generate():
    """Full-width Llama-3-8B (all 32 layers, random bf16 weights from seed
    0) through init_inference -> generate: batch 8, left-padded prompts of
    seeded lengths 128-512 (bucketed to 512), 64 greedy new tokens, no
    EOS; once with bf16 weights, once with int8 weights, then the int8
    weights again with enable_cuda_graph (the decode step one CUDA graph,
    captured in a warm-up generate and replayed by the counted one: its
    tokens must be the uncaptured run's), and once with bf16 weights and
    prefill_flash_from_empty (the prefill through the masked K1 instead of
    the plain cached attention)."""
    from deepspeed_tpu_torch.models import LlamaConfig

    L = LlamaConfig.llama3_8b().num_hidden_layers
    ids, mask = left_padded_prompts(LlamaConfig.llama3_8b().vocab_size,
                                    GEN_B, 128, GEN_PROMPT, 0)
    launches, tokens, decode = {}, {}, {}
    for weights, flash, graph in ((None, False, False),
                                  ("int8", False, False),
                                  ("int8", False, True),
                                  (None, True, False)):
        cfg = LlamaConfig.llama3_8b(prefill_flash_from_empty=flash)
        name = (weights or "bf16") + ("_flash" if flash else "") + \
            ("_graph" if graph else "")
        t = time.perf_counter()
        out, engine, prefill_s, total_s, counts, capture, finite = \
            generate_run(cfg, torch.bfloat16, weights, ids, mask, GEN_NEW,
                         engine_kw=dict(enable_cuda_graph=graph))
        k4, k5, k1m, k5w, k5g, k5r, k8, k5f = counts
        setup = time.perf_counter() - t - prefill_s - total_s
        decode_ms = 1e3 * (total_s - prefill_s) / (GEN_NEW - 1)
        decode[name] = decode_ms
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"generate: llama3_8b x{L} layers, weights {weights or 'bf16'}, "
            f"prefill_flash_from_empty {flash}, enable_cuda_graph {graph}, "
            f"batch {GEN_B}, prompts {int(mask.sum(1).min())}-"
            f"{int(mask.sum(1).max())} tokens (bucket {GEN_PROMPT}), "
            f"{GEN_NEW} new tokens: prefill {1e3 * prefill_s:.2f} ms, mean "
            f"decode step {decode_ms:.3f} ms, total {1e3 * total_s:.2f} ms "
            f"= {GEN_B * GEN_NEW / total_s:.1f} tokens/s, peak memory "
            f"{peak:.1f} GiB, setup {setup:.1f} s, launches K4 {k4} K5 {k5} "
            f"(wgmma prefill {k5w}, gemv_tc decode {k5g}, ragged {k5r}, "
            f"gemv_tf32 {k5f}) masked K1 {k1m} K8 {k8}"
            f"{' (the wrappers count where they run: the replayed decode steps add none; the capturing warm-up (prefill, eager step, capture) ' + str(capture) + ')' if graph else ''}, "
            f"quant {engine.quant_summary or None}")
        # K5's prefill: the 7 projections of each layer on the wgmma
        # kernel; its decode steps on the gemv_tc kernel (replays of the
        # captured step are not counted by the wrappers); every Llama-3-8B
        # projection's rows are TMA-addressable, so none takes the ragged
        # kernel; no projection has K8's per-column scales
        steps = 0 if graph else GEN_NEW - 1
        want = (L * steps, 7 * L * (steps + 1) if weights else 0,
                L if flash else 0, 7 * L if weights else 0,
                7 * L * steps if weights else 0, 0, 0, 0)
        problems = []
        if tuple(out.shape) != (GEN_B, GEN_NEW):
            problems.append(f"output shape {tuple(out.shape)}")
        if not finite:
            problems.append("a logit is not finite")
        if counts != want:
            problems.append(f"launches K4, K5, masked K1, wgmma K5, "
                            f"gemv_tc K5, ragged K5, K8, gemv_tf32 K5 "
                            f"{counts} != {want}")
        # the graph holds the decode step's kernels: the warm-up ran the
        # prefill, one eager step and the capture, so K4 twice a layer and
        # gemv_tc twice a projection
        k5 = 7 * L if weights else 0
        want_capture = (2 * L, 3 * k5, 0, k5, 2 * k5, 0, 0, 0) if graph \
            else None
        if capture != want_capture:
            problems.append(f"capturing warm-up launches {capture} != "
                            f"{want_capture}")
        tokens[name] = out.cpu().tolist()
        if graph and tokens[name] != tokens["int8"]:
            problems.append("the captured decode's tokens differ from the "
                            "uncaptured run's")
        if problems:
            raise AssertionError(f"generate {name}: " + "; ".join(problems))
        launches[name] = counts
        del out, engine
        gc.collect()
        torch.cuda.empty_cache()
    log(f"generate int8 decode step: uncaptured {decode['int8']:.3f} ms, "
        f"captured {decode['int8_graph']:.3f} ms (tokens identical)")
    return launches, decode


#: the unified engine's full-width run: 8 slots, 16-token pages, 1024
#: pages, 2048-token rows, a 256-token prefill budget
SERVE_SCFG = dict(max_batch_size=8, block_size=16, num_blocks=1024,
                  max_model_len=2048, prefill_token_budget=256, trace=True,
                  trace_capacity=1 << 16)
#: the captured engine: enable_cuda_graph (the inference config) with the
#: bucketed widths 8, 16, ..., 256, 263
SERVE_GRAPH = (dict(enable_cuda_graph=True), dict(mixed_step_buckets=True))
#: check_serving's runs in turns: (name, enable_cuda_graph,
#: mixed_step_buckets, the run whose tokens it must repeat); "_again" runs
#: reuse the engine of the run they name (every graph already captured)
SERVE_RUNS = (("uncaptured", False, False, None),
              ("captured", True, False, "uncaptured"),
              ("uncaptured_buckets", False, True, None),
              ("captured_buckets", True, True, "uncaptured_buckets"),
              ("captured_again", True, False, "uncaptured"),
              ("captured_buckets_again", True, True, "uncaptured_buckets"))


def check_width_witness(module):
    """One packed step's pieces at two packed widths, the same tokens in
    front: K6 on a full-width pool (H 32, Hkv 8, D 128, 1024 pages of
    16; 8 decode rows at widths 8 and 263; 7 decode rows and a 120-token
    chunk at widths 128 and 263) must give the same rows bit for bit (its
    work items do not depend on the width); Llama-3-8B's layer-0
    projections and LM head (``module``'s, bf16, through cuBLAS) on the
    same rows at the same widths are printed, not gated. Returns the
    largest difference of each, by (piece, narrow width)."""
    from deepspeed_tpu_torch.ops.ragged_attention import ragged_paged_attention

    rs = np.random.RandomState(5)
    ctx = [int(c) for c in rs.randint(64, 1536, R)]
    cases = {"decode": ([(1, c - 1) for c in ctx], 8),
             "mixed": ([(1, c - 1) for c in ctx[:-1]] + [(120, ctx[-1])],
                       128)}
    diffs = {}
    for name, (rows, width) in cases.items():
        (q, k, v, *desc), _ = ragged_case(rows, False, 11)
        full = ragged_paged_attention(q, k, v, *desc)
        narrow = ragged_paged_attention(q[:width].contiguous(), k, v, *desc)
        diffs[f"K6 {name}", width] = float(
            (full[:width].float() - narrow.float()).abs().max())
    attn, mlp = module.model.layers[0].self_attn, module.model.layers[0].mlp
    projections = {"q_proj": attn.q_proj, "k_proj": attn.k_proj,
                   "v_proj": attn.v_proj, "o_proj": attn.o_proj,
                   "gate_proj": mlp.gate_proj, "up_proj": mlp.up_proj,
                   "down_proj": mlp.down_proj, "lm_head": module.lm_head}
    g = torch.Generator(device="cuda").manual_seed(12)
    with torch.inference_mode():
        for name, proj in projections.items():
            x = torch.randn((1, T_PACKED, proj.in_features), generator=g,
                            device="cuda", dtype=torch.bfloat16)
            full = proj(x)
            for width in (8, 128):
                narrow = proj(x[:, :width])
                diffs[name, width] = float(
                    (full[:, :width].float() - narrow.float()).abs().max())
    # the whole step: 8 decode tokens packed at widths 263 and 8 through
    # the model on a random pool; each leaf module's rows are compared in
    # the order the step runs them, so the first that differs is where
    # the step's rows start to depend on the width
    from deepspeed_tpu_torch.models.layers import paged_cache_index

    rows = cases["decode"][0]
    (_, _, _, bt, qs, ql, cs, cl), _ = ragged_case(rows, False, 11)
    pool = module.init_paged_cache(N_PAGES, BS, dtype=torch.bfloat16,
                                   device="cuda")
    for t in pool.values():
        t.normal_(generator=g)
    leaves = [(n, m) for n, m in module.named_modules()
              if not any(True for _ in m.children())]
    seen = {}

    def hook(name):
        def fn(mod, args, out):
            out = out[0] if isinstance(out, tuple) else out
            seen.setdefault(name, []).append(out[..., :R, :].float().clone()
                                             if out.dim() == 3 else None)
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in leaves]
    tok = torch.randint(1, module.config.vocab_size, (R,), generator=g,
                        device="cuda")
    logits = {}
    with torch.inference_mode():
        for width in (T_PACKED, R):
            ids = torch.zeros((1, width), dtype=torch.long, device="cuda")
            ids[0, :R] = tok
            trow = np.full((1, width), -1, np.int32)
            trow[0, :R] = np.arange(R)
            pos = np.full((1, width), -1, np.int32)
            pos[0, :R] = cs.cpu().numpy()
            idx = paged_cache_index(bt, pos, cl, chunk_start=cs,
                                    token_rows=trow, query_start=qs,
                                    query_len=ql, device="cuda")
            out, _ = module(ids, cache=pool, cache_index=idx)
            logits[width] = out[0, :R].float()
    for h in handles:
        h.remove()
    first = next(((n, float((v[0] - v[1]).abs().max()))
                  for n, v in seen.items() if v[0] is not None and
                  len(v) == 2 and not torch.equal(v[0], v[1])), None)
    diffs["logits, whole step", R] = float(
        (logits[T_PACKED] - logits[R]).abs().max())
    del pool
    log("serve width witness (the same packed rows at a narrow width and "
        f"at 263; max |difference| of the narrow width's rows; the whole "
        f"step's first leaf module whose rows differ: "
        f"{first[0] + f' ({first[1]:.6g})' if first else 'none'}): " +
        ", ".join(f"{n} at {w}: {d:.6g}" for (n, w), d in diffs.items()))
    bad = {k: d for k, d in diffs.items() if k[0].startswith("K6") and d}
    if bad:
        raise AssertionError(f"K6's rows depend on the packed width: {bad}")
    return diffs


def check_serving():
    """Full-width Llama-3-8B (all 32 layers, random bf16 weights) serving
    16 seeded requests through the unified mixed step on the kernel, in
    turns on one set of weights (``SERVE_RUNS``): uncaptured at the full
    packed width (as every earlier run), captured (enable_cuda_graph: each
    width's first step eager, then captured and replayed), uncaptured and
    captured at bucketed widths (mixed_step_buckets), then each captured
    engine again on the same requests (every graph replayed). A captured
    run must repeat its uncaptured twin's tokens and finish reasons
    exactly; the bucketed runs are held to the bucketed uncaptured run,
    not to the full width: a row's logits change in their last bits with
    the packed width, and greedy decoding on random weights amplifies
    that (PERF.md), so how many requests keep the full width's tokens is
    printed, not gated. Where the step's rows change is read by
    :func:`check_width_witness` on this model, which fails if K6's do.
    Every run must finish every request, leak no page, flag no row and
    run K6 once per layer per step, counted on the device (replays
    included) and, uncaptured, by the wrapper too. Returns the first
    run's K6 launches and each run's summary."""
    from collections import Counter

    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    cfg = LlamaConfig.llama3_8b()
    L = cfg.num_hidden_layers
    t = time.perf_counter()
    params = LlamaForCausalLM(cfg).init_params(seed=0, dtype=torch.bfloat16,
                                               device="cuda")
    setup = time.perf_counter() - t
    engines, tokens, runs = {}, {}, {}
    for name, captured, buckets, twin in SERVE_RUNS:
        ekw = dict(enable_cuda_graph=captured)
        skw = dict(mixed_step_buckets=buckets)
        key = name.replace("_again", "")
        before = len(step_widths(engines[key])) if key in engines else 0
        srv, rids, res, wall, launches = serve(
            cfg, 0, 16, (64, 1536), (32, 64), dict(SERVE_SCFG, **skw),
            torch.bfloat16, params=params, engine_kw=ekw,
            srv=engines.get(key))
        engines[key] = srv
        runs_k6 = kernel_runs()
        widths = step_widths(srv, before)
        steps = len(widths)
        tokens[name] = [(res[r].state, res[r].finish_reason, res[r].tokens)
                        for r in rids]
        generated = sum(len(res[r].tokens) for r in rids)
        ttft = float(np.median([res[r].ttft_s for r in rids]))
        finished = sum(res[r].state == "finished" for r in rids)
        summary = dict(tok_s=generated / wall, ttft_p50_s=ttft,
                       mean_step_ms=1e3 * wall / max(steps, 1), steps=steps,
                       wall_s=wall, widths=dict(sorted(Counter(widths)
                                                       .items())),
                       k6_runs=runs_k6, graphs=len(srv._graphs),
                       tokens=tokens[name])
        runs[name] = summary
        same = "" if twin is None else \
            f", tokens identical to {twin}: {tokens[name] == tokens[twin]}"
        log(f"serve {name}: llama3_8b x{L} layers bf16, "
            f"enable_cuda_graph {captured}, mixed_step_buckets {buckets}, "
            f"{len(rids)} requests, {finished} finished, {steps} mixed "
            f"steps, wall {wall:.3f} s (weights {setup:.1f} s), generated "
            f"{generated} tokens = {generated / wall:.1f} tok/s, ttft_p50 "
            f"{ttft:.3f} s, mean step {1e3 * wall / max(steps, 1):.2f} ms, "
            f"steps at each width {summary['widths']}, graphs captured "
            f"{len(srv._graphs)}, preemptions {srv.metrics.preemptions}, "
            f"quarantines {srv.metrics.logit_quarantines}, K6 runs on the "
            f"device {runs_k6}, wrapper launches {launches}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB{same}")
        srv.block_pool.check_consistent()
        problems = []
        if finished != len(rids):
            problems.append(f"{len(rids) - finished} requests did not finish")
        if twin is not None and tokens[name] != tokens[twin]:
            problems.append(f"tokens or finish reasons differ from {twin}")
        if srv.metrics.logit_quarantines:
            problems.append(f"{srv.metrics.logit_quarantines} rows flagged "
                            f"NaN/Inf")
        if srv.block_pool.used_count:
            problems.append(f"{srv.block_pool.used_count} pages leaked")
        if runs_k6 == 0 or runs_k6 != L * steps:
            problems.append(f"K6 ran {runs_k6} times on the device, not "
                            f"{L} x {steps} mixed steps")
        k6 = launches["ragged_paged_attention"]
        if not captured and (k6 != L * steps or sum(launches.values()) != k6):
            problems.append(f"kernel launches {launches} != {L} x {steps} "
                            f"mixed steps of K6 alone")
        if set(widths) - set(srv.mixed_step_widths):
            problems.append(f"widths {sorted(set(widths))} outside "
                            f"{srv.mixed_step_widths}")
        if problems:
            raise AssertionError(f"serve {name}: " + "; ".join(problems))
        runs[name]["wrapper_k6"] = k6
    kept = sum(a == b for a, b in zip(tokens["uncaptured"],
                                      tokens["uncaptured_buckets"]))
    log(f"serve: bucketed widths vs the full width, uncaptured: {kept} of "
        f"{len(tokens['uncaptured'])} requests with identical tokens")
    check_width_witness(engines["uncaptured"].engine.module)
    plain = engines.pop("captured")
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    guarded, rids, runs["guarded"] = check_guarded_serve(
        cfg, params, plain, tokens["captured"])
    del plain
    runs["slo"] = check_slo_serve(cfg, params, guarded, rids)
    del guarded
    gc.collect()
    torch.cuda.empty_cache()
    runs["chaos"] = check_chaos_serve(
        "unified", cfg, params, SERVE_SCFG, [[(np.arange(300), 4)]],
        [seeded_traffic(cfg.vocab_size, 0, 16, (64, 1536), (32, 64))])
    gc.collect()
    torch.cuda.empty_cache()
    runs["spec"] = check_spec_serve(cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    runs["tier"] = check_kv_tier(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs["uncaptured"]["wrapper_k6"], runs


# ---------------------------------------------------------------------------
# serving robustness and accounting
# ---------------------------------------------------------------------------

#: the chaos phase's DS_FAULT: one slow_step past the 0.5 s budget at the
#: engine's ``step`` (20 steps into the traffic, where decode rows run and
#: the other faults have fired: a trip fails the whole step, so a fault
#: that fired on the same step would not show), one corrupt_logits of each
#: tag, one flaky_prefill
CHAOS_SPEC = ("slow_step:seconds=1.5:fails=1:step={step},"
              "corrupt_logits:fails=1:tag=serving_step,"
              "corrupt_logits:fails=1:tag=serving_prefill,"
              "flaky_prefill:fails=1")
#: the finish reason and flight-recorder triggers each of its faults makes
CHAOS_REASONS = ("step_watchdog", "corrupt_logits",
                 "prefill_error:RuntimeError")
CHAOS_DUMPS = {"watchdog_trip": 1, "fault_slow_step": 1,
               "logit_quarantine": 2, "fault_corrupt_logits": 2,
               "fault_flaky_prefill": 1}


def flight_dumps(trace_dir):
    """The flight recorder's dump headers in ``trace_dir``, by trigger."""
    out = {}
    for f in sorted(os.listdir(trace_dir)):
        if f.startswith("flight_") and f.endswith(".jsonl"):
            with open(os.path.join(trace_dir, f)) as fh:
                header = json.loads(fh.readline())
            out.setdefault(header["trigger"], []).append(header)
    return out


def utilization_problems(where, **readings):
    """Every MFU/MBU reading must lie in (0, 1.05]."""
    return [f"{where}: {k} = {v} outside (0, 1.05]"
            for k, v in readings.items() if v is None or not 0 < v <= 1.05]


def request_times(srv, rids):
    """Each request's TTFT and mean time per output token after the first
    (seconds), from the engine's records."""
    ttft, tpot = [], []
    for r in rids:
        req = srv._requests[r]
        ttft.append(req.ttft)
        if len(req.tokens) > 1:
            tpot.append((req.finish_time - req.first_token_time)
                        / (len(req.tokens) - 1))
    return ttft, tpot


def check_guarded_serve(cfg, params, plain, want):
    """Phase (a): the captured serve of check_serving under a 2 s step
    watchdog with the flight recorder armed (``trace_dir``), against the
    same captured engine unguarded (``plain``, warm), in turns (plain,
    guarded, guarded, plain) on the same 16 requests after one warm-up
    run of the guarded engine (its capture). Gates: the captured run's
    tokens (``want``) on every run, no trip, no skip, no flight dump, the
    plain engine's graph count, the H100's peaks found, the gauges in (0,
    1.05]. Prints each run's mean step and the guarded / plain ratio, the
    gauges, the program table, and what one watermark read costs on the
    host. Returns the guarded engine, its last run's request ids and the
    summary."""
    trace_dir = tempfile.mkdtemp(prefix="flight_")
    scfg = dict(SERVE_SCFG, step_watchdog_s=2.0, trace_dir=trace_dir)
    guarded, *_ = serve(cfg, 0, 16, (64, 1536), (32, 64), scfg,
                        torch.bfloat16, params=params,
                        engine_kw=dict(enable_cuda_graph=True))
    steps = {"plain": [], "guarded": []}
    problems = []
    for name in ("plain", "guarded", "guarded", "plain"):
        srv = guarded if name == "guarded" else plain
        before = len(step_widths(srv))
        _, rids, res, wall, _ = serve(cfg, 0, 16, (64, 1536), (32, 64),
                                      None, torch.bfloat16, srv=srv)
        if srv is guarded:
            guarded_rids = rids
        n = len(step_widths(srv, before))
        steps[name].append(1e3 * wall / n)
        got = [(res[r].state, res[r].finish_reason, res[r].tokens)
               for r in rids]
        if got != want:
            problems.append(f"{name}: tokens or finish reasons differ from "
                            f"the captured run's")
        srv.block_pool.check_consistent()
        if srv.block_pool.used_count:
            problems.append(f"{name}: {srv.block_pool.used_count} pages "
                            f"leaked")
    m = guarded.metrics
    plain_ms = statistics.mean(steps["plain"])
    guard_ms = statistics.mean(steps["guarded"])
    mem_cost = host_ms(guarded.perf.memory_watermarks, reps=200)
    summary = guarded.perf_summary()
    mean_mbu = summary["programs"][0]["bytes_accessed"] / (
        guard_ms / 1e3 * guarded.perf.peak_hbm_bw) \
        if guarded.perf.peak_hbm_bw else None
    log(f"serve guarded: step_watchdog_s 2.0 + trace_dir, captured, "
        f"mean step plain {[round(x, 3) for x in steps['plain']]} ms, "
        f"guarded {[round(x, 3) for x in steps['guarded']]} ms "
        f"(guarded / plain {guard_ms / plain_ms:.4f}), tokens identical "
        f"to the captured run: {not problems}, watchdog trips "
        f"{m.watchdog_trips}, skips {m.watchdog_skips}, flight dumps "
        f"{len(flight_dumps(trace_dir))}, graphs {len(guarded._graphs)} "
        f"(plain {len(plain._graphs)}), one watermark read "
        f"{1e3 * mem_cost:.1f} us, last step "
        f"mixed_mbu {m.mixed_mbu}, mixed_mfu {m.mixed_mfu}, tokens/s "
        f"{m.mixed_tokens_per_sec_per_chip}, the mean guarded step's MBU "
        f"{mean_mbu}, hbm in use {m.hbm_bytes_in_use}, peak "
        f"{m.hbm_peak_bytes}, peaks {summary['peak_flops_per_chip']} "
        f"FLOP/s {summary['peak_hbm_bytes_per_s_per_chip']} B/s for "
        f"{summary['device_kind']!r}")
    log(f"serve guarded perf_summary programs: {summary['programs']}")
    if m.watchdog_trips or m.watchdog_skips:
        problems.append(f"{m.watchdog_trips} trips, {m.watchdog_skips} skips")
    if flight_dumps(trace_dir):
        problems.append(f"flight dumps {sorted(flight_dumps(trace_dir))}")
    if len(guarded._graphs) != len(plain._graphs):
        problems.append(f"graphs {len(guarded._graphs)} != plain's "
                        f"{len(plain._graphs)}")
    if guarded.perf.peak_flops is None:
        problems.append(f"no peaks for {summary['device_kind']!r}")
    problems += utilization_problems("serve guarded", mixed_mbu=m.mixed_mbu,
                                     mixed_mfu=m.mixed_mfu,
                                     mean_mbu=mean_mbu)
    if problems:
        raise AssertionError("serve guarded: " + "; ".join(problems))
    return guarded, guarded_rids, dict(plain_ms=steps["plain"],
                               guarded_ms=steps["guarded"],
                               mixed_mbu=m.mixed_mbu, mixed_mfu=m.mixed_mfu,
                               mean_mbu=mean_mbu)


def check_slo_serve(cfg, params, guarded, rids):
    """Phase (c): a captured engine with ``ttft_slo_s`` / ``tpot_slo_s``
    at the p50s of the guarded run (``guarded``'s requests ``rids``),
    warmed by one request, then the same 16 requests: the verdicts of the
    16 must sum to them. Prints the split. Returns it."""
    ttft, tpot = request_times(guarded, rids)
    slo = dict(ttft_slo_s=float(np.median(ttft)),
               tpot_slo_s=float(np.median(tpot)))
    srv, *_ = serve(cfg, 0, 0, None, None, dict(SERVE_SCFG, **slo),
                    torch.bfloat16, params=params,
                    engine_kw=dict(enable_cuda_graph=True),
                    phases=[[(np.arange(100), 4)]])
    verdicts = ("good", "ttft_miss", "tpot_miss", "shed", "failed")
    before = {v: getattr(srv.metrics, f"slo_{v}") for v in verdicts}
    _, rids, res, _, _ = serve(cfg, 0, 16, (64, 1536), (32, 64), None,
                               torch.bfloat16, srv=srv)
    split = {v: getattr(srv.metrics, f"slo_{v}") - before[v]
             for v in verdicts}
    terminal = sum(res[r].state != "queued" and res[r].state != "running"
                   for r in rids)
    log(f"serve slo: ttft_slo_s {slo['ttft_slo_s']:.4f} and tpot_slo_s "
        f"{slo['tpot_slo_s']:.5f} (the guarded run's p50s), verdicts of "
        f"{len(rids)} requests {split}, goodput tokens "
        f"{srv.metrics.goodput_tokens}")
    if sum(split.values()) != terminal or terminal != len(rids):
        raise AssertionError(f"serve slo: verdicts {split} do not sum to "
                             f"{terminal} terminal of {len(rids)} requests")
    del srv
    return dict(slo, **split)


def check_chaos_serve(name, cfg, params, scfg, warm, traffic):
    """Phase (b): ``CHAOS_SPEC`` armed over a captured engine (``scfg``
    with a 0.5 s budget and the flight recorder), warmed by ``warm`` (a
    phase list) so every graph of ``traffic`` is captured first. Gates, as
    the JAX chaos invariant: every request terminal, each expected finish
    reason, one trip, two quarantines, no leaked page, a consistent pool,
    a fresh request served afterwards, the graphs and program table
    unchanged, and one flight dump per firing whose header names the
    request it hit. The survivors' tokens are not gated: failing requests
    changes the packed widths, and the bf16 products' rows change in
    their last bits with the width. Returns the summary."""
    from deepspeed_tpu_torch.utils import fault_injection as faults

    trace_dir = tempfile.mkdtemp(prefix="flight_")
    scfg = dict(scfg, step_watchdog_s=0.5, trace_dir=trace_dir)
    srv, *_ = serve(cfg, 0, 0, None, None, scfg, torch.bfloat16,
                    params=params, engine_kw=dict(enable_cuda_graph=True),
                    phases=warm)
    graphs = (sorted(map(str, srv._graphs)),
              [(r["name"], r["compiles"]) for r in srv.perf.programs.table()])
    spec = CHAOS_SPEC.format(step=srv._step_no + 20)
    os.environ[faults.ENV_VAR] = spec
    faults.reset()
    try:
        _, rids, res, wall, _ = serve(cfg, 0, 0, None, None, None,
                                      torch.bfloat16, srv=srv,
                                      phases=traffic)
    finally:
        del os.environ[faults.ENV_VAR]
        faults.reset()
    if srv._wedged is not None:
        srv._wedged.join()
    _, fresh, fres, _, _ = serve(cfg, 0, 0, None, None, None, torch.bfloat16,
                                 srv=srv, phases=[[(np.arange(40), 3)]])
    srv.flight.disarm()
    m = srv.metrics
    reasons = {}
    for r in rids:
        reasons.setdefault(res[r].finish_reason, []).append(r)
    dumps = flight_dumps(trace_dir)
    log(f"serve chaos {name}: DS_FAULT={spec}, {len(rids)} requests "
        f"in {wall:.3f} s, finish reasons "
        f"{ {k: len(v) for k, v in reasons.items()} }, watchdog trips "
        f"{m.watchdog_trips}, skips {m.watchdog_skips}, quarantines "
        f"{m.logit_quarantines}, failed {m.requests_failed}, flight dumps "
        f"{ {k: [h['detail'] for h in v] for k, v in dumps.items()} }, "
        f"graphs {len(srv._graphs)}, recompiles {srv.perf.recompile_total}")
    problems = []
    if any(res[r].state in ("queued", "running") for r in rids):
        problems.append("a request is not terminal")
    for reason in CHAOS_REASONS:
        if reason not in reasons:
            problems.append(f"no request ended {reason}")
    if (m.watchdog_trips, m.logit_quarantines) != (1, 2):
        problems.append(f"trips {m.watchdog_trips}, quarantines "
                        f"{m.logit_quarantines} != 1, 2")
    srv.block_pool.check_consistent()
    if srv.block_pool.used_count:
        problems.append(f"{srv.block_pool.used_count} pages leaked")
    if fres[fresh[0]].state != "finished":
        problems.append("the fresh request did not finish")
    if (sorted(map(str, srv._graphs)),
            [(r["name"], r["compiles"])
             for r in srv.perf.programs.table()]) != graphs:
        problems.append("the chaos changed the captured graphs")
    if {k: len(v) for k, v in dumps.items()} != CHAOS_DUMPS:
        problems.append(f"flight dumps {sorted(dumps)} != {CHAOS_DUMPS}")
    else:
        tripped = reasons.get("step_watchdog", [])
        named = {
            "watchdog_trip": [set(h["detail"]["rids"]) == set(tripped)
                              for h in dumps["watchdog_trip"]],
            "fault_slow_step": [set(h["detail"]["rids"]) == set(tripped)
                                for h in dumps["fault_slow_step"]],
            "logit_quarantine": [h["detail"]["rid"] in reasons.get(
                "corrupt_logits", []) for h in dumps["logit_quarantine"]],
            "fault_corrupt_logits": [bool(set(h["detail"]["rids"]) & set(
                reasons.get("corrupt_logits", [])))
                for h in dumps["fault_corrupt_logits"]],
            "fault_flaky_prefill": [h["detail"]["rids"] == reasons.get(
                "prefill_error:RuntimeError") for h in
                dumps["fault_flaky_prefill"]]}
        bad = [k for k, ok in named.items() if not all(ok)]
        if bad:
            problems.append(f"dumps {bad} do not name the request they hit")
    if problems:
        raise AssertionError(f"serve chaos {name}: " + "; ".join(problems))
    del srv
    return {k: len(v) for k, v in reasons.items()}


# ---------------------------------------------------------------------------
# speculative decoding and the host KV tier
# ---------------------------------------------------------------------------

#: speculative decoding on the captured serve: prompt lookup, 4 drafts a row
SPEC_SCFG = dict(SERVE_SCFG, mixed_step_buckets=True, spec_tokens=4)


def repeat_traffic(vocab, seed, n, prompt_range, new_range, period=64):
    """``n`` seeded requests whose prompts repeat a ``period``-token segment
    of their own up to a length in ``prompt_range``."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        segment = rs.randint(0, vocab, period)
        length = int(rs.randint(prompt_range[0], prompt_range[1] + 1))
        out.append((np.resize(segment, length),
                    int(rs.randint(new_range[0], new_range[1] + 1))))
    return out


def spec_counts(srv):
    m = srv.metrics
    return dict(drafted=m.spec_drafted, accepted=m.spec_accepted,
                committed=m.spec_committed, verify_rows=m.spec_verify_rows,
                pages_dropped=m.spec_pages_dropped)


def oracle_drafter(table):
    """A drafter that replays known tokens of each prompt (``table``,
    ``[(prompt tuple, tokens)]``; its ``table`` may be replaced between
    runs): where the run's own tokens are those, every draft is right."""
    from deepspeed_tpu_torch.inference.serving.speculative import Drafter

    class Oracle(Drafter):
        kind = "oracle"

        def draft(self, history, k):
            h = tuple(int(t) for t in history)
            for prompt, toks in self.table:
                if h[:len(prompt)] == prompt:
                    done = len(h) - len(prompt)
                    return list(toks[done:done + k])
            return []

    oracle = Oracle()
    oracle.table = table
    return oracle


def check_spec_small_reference(device="cuda"):
    """The 2-layer fp32 model served captured at bucketed widths with
    speculation off, with the prompt-lookup drafter (4 drafts) and with
    an oracle drafter: identical tokens, every oracle draft accepted, K6
    once per layer per step on the device."""
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    cfg = LlamaConfig(**SMALL_CFG)
    scfg = dict(max_batch_size=4, block_size=16, num_blocks=64,
                max_model_len=256, prefill_token_budget=32, trace=True,
                mixed_step_buckets=True)
    traffic = seeded_traffic(512, 3, 6, (5, 90), (8, 24)) + \
        repeat_traffic(512, 4, 4, (32, 128), (8, 24), period=16)
    tokens, stats, problems = {}, {}, []
    for name in ("off", "prompt_lookup", "oracle"):
        over = {}
        if name != "off":
            over["spec_tokens"] = 4
        if name == "oracle":
            over["drafter"] = oracle_drafter(
                [(tuple(int(t) for t in p), toks)
                 for (p, _), (_, toks) in zip(traffic, tokens["off"])])
        srv, rids, res, _, _ = serve(
            cfg, 3, 0, None, None, dict(scfg, **over), torch.float32,
            device=device, engine_kw=dict(enable_cuda_graph=True),
            phases=[traffic])
        tokens[name] = [(res[r].state, res[r].tokens) for r in rids]
        steps = len(step_widths(srv))
        stats[name] = dict(spec_counts(srv), steps=steps,
                           k6_runs=kernel_runs())
        if kernel_runs() != cfg.num_hidden_layers * steps:
            problems.append(f"{name}: K6 ran {kernel_runs()} times, not "
                            f"{cfg.num_hidden_layers} x {steps}")
        srv.block_pool.check_consistent()
        if srv.block_pool.used_count:
            problems.append(f"{name}: {srv.block_pool.used_count} pages "
                            f"leaked")
    same = tokens["off"] == tokens["prompt_lookup"] == tokens["oracle"]
    oracle = stats["oracle"]
    log(f"spec reference: 2-layer fp32 model, captured, bucketed widths, "
        f"{len(traffic)} requests, speculation off / prompt lookup / "
        f"oracle: tokens identical={same}, {stats}")
    if not same:
        problems.append("speculation changed the fp32 tokens")
    if not all(s == "finished" for s, _ in tokens["off"]):
        problems.append("a request did not finish")
    if not oracle["drafted"] or oracle["accepted"] != oracle["drafted"]:
        problems.append(f"the oracle's drafts were not all accepted "
                        f"({oracle['accepted']} of {oracle['drafted']})")
    if problems:
        raise AssertionError("spec reference: " + "; ".join(problems))
    return stats


#: check_spec_serve's runs in turns: (name, drafter, captured) with the
#: drafter None (speculation off), "prompt_lookup" or "oracle" (replays the
#: tokens of the previous oracle run, the first time captured_plain's);
#: the first ``SPEC_SETUP`` make the engines (the captured ones capture
#: their widths) and let the oracle settle, the rest are the measured
#: turns on warm graphs
SPEC_SETUP = 6
SPEC_RUNS = (("uncaptured_spec", "prompt_lookup", False),
             ("captured_spec", "prompt_lookup", True),
             ("captured_plain", None, True),
             ("captured_oracle", "oracle", True),
             ("captured_oracle", "oracle", True),
             ("captured_oracle", "oracle", True),
             ("captured_plain", None, True),
             ("captured_spec", "prompt_lookup", True),
             ("captured_oracle", "oracle", True),
             ("captured_oracle", "oracle", True),
             ("captured_spec", "prompt_lookup", True),
             ("captured_plain", None, True))


class timed_method:
    """Inside the block, the host seconds spent in ``obj.name`` add up in
    ``self.seconds``."""

    def __init__(self, obj, name):
        self.obj, self.name, self.seconds = obj, name, 0.0

    def __enter__(self):
        fn = getattr(self.obj, self.name)

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t

        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        delattr(self.obj, self.name)


def check_spec_serve(cfg, params, device="cuda"):
    """Speculative decoding on full-width Llama-3-8B (the serve phase's
    bf16 weights, the unified engine at bucketed widths, 4 drafts a
    verify row): the serve phase's 16 requests plus 8 whose 256-1024
    token prompts repeat a 64-token segment. Runs (``SPEC_RUNS``): the
    uncaptured engine with the prompt-lookup drafter, the captured one
    (its tokens must equal the uncaptured run's: the same widths in the
    same order, replayed), then in turns the captured engine with
    speculation off, with prompt lookup and with an oracle drafter that
    replays the tokens of its own previous run (the first time those of
    speculation off): bf16 rows change with the packed width, so the
    speculating run's tokens part from the plain run's, and the oracle
    converges on its own run's tokens over the setup runs, where every
    draft is right — what speculation buys when the drafts land. Each
    run must finish every request, leak no page, stay
    within the bucket set and run K6 once per layer per step on the
    device; the drafting runs must pack verify rows, the oracle's must
    accept drafts. Prints tokens/s, mean step ms, steps, TTFT p50, the
    accept rate, tokens per verify row and the host ms a step spent
    drafting of each run. Returns the summary with K6's wrapper count
    (the uncaptured run) and device count (every run)."""
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    small = check_spec_small_reference(device)
    L = cfg.num_hidden_layers
    traffic = seeded_traffic(cfg.vocab_size, 0, 16, (64, 1536), (32, 64)) \
        + repeat_traffic(cfg.vocab_size, 1, 8, (256, 1024), (32, 64))
    engines, tokens, runs, problems = {}, {}, [], []
    launches = dict(wrapper=0, device=0)
    for name, drafter, captured in SPEC_RUNS:
        srv = engines.get(name)
        before = len(step_widths(srv)) if srv else 0
        counts0 = spec_counts(srv) if srv else {}
        scfg = dict(SPEC_SCFG, spec_tokens=4 if drafter else 0)
        if drafter == "oracle":
            replayed = tokens.get("captured_oracle", tokens["captured_plain"])
            table = [(tuple(int(t) for t in p), toks) for (p, _), (_, _, toks)
                     in zip(traffic, replayed)]
            if srv is None:
                scfg["drafter"] = oracle_drafter(table)
            else:
                srv._drafter.table = table
        with contextlib.ExitStack() as stack:
            plan = None
            if srv is not None:
                plan = stack.enter_context(
                    timed_method(srv, "_plan_speculation"))
            srv, rids, res, wall, counts = serve(
                cfg, 0, 0, None, None, scfg, torch.bfloat16, device=device,
                params=params, engine_kw=dict(enable_cuda_graph=captured),
                srv=srv, phases=[traffic])
        engines[name] = srv
        widths = step_widths(srv, before)
        steps = len(widths)
        k6 = kernel_runs()
        launches["device"] += k6
        if not captured:
            launches["wrapper"] += counts["ragged_paged_attention"]
            if sum(counts.values()) != counts["ragged_paged_attention"]:
                problems.append(f"{name}: kernels other than K6 ran: "
                                f"{counts}")
        got = [(res[r].state, res[r].finish_reason, res[r].tokens)
               for r in rids]
        if drafter == "oracle":
            tokens[name] = got
        tokens.setdefault(name, got)
        c = {k: v - counts0.get(k, 0) for k, v in spec_counts(srv).items()}
        generated = sum(len(res[r].tokens) for r in rids)
        run = dict(name=name, tok_s=generated / wall,
                   mean_step_ms=1e3 * wall / max(steps, 1), steps=steps,
                   ttft_p50_s=float(np.median([res[r].ttft_s
                                               for r in rids])),
                   accept_rate=c["accepted"] / c["drafted"]
                   if c["drafted"] else None,
                   tokens_per_verify=c["committed"] / c["verify_rows"]
                   if c["verify_rows"] else None,
                   plan_ms_per_step=1e3 * plan.seconds / max(steps, 1)
                   if plan else None, k6_runs=k6, **c)
        if drafter == "oracle":
            run["tokens_as_replayed"] = got == replayed
        runs.append(run)
        log(f"spec serve {name}: llama3_8b x{L} bf16, drafter {drafter}, "
            f"{len(rids)} requests, "
            f"{sum(s == 'finished' for s, _, _ in got)} finished, "
            f"{generated} tokens in {wall:.3f} s = {run['tok_s']:.1f} tok/s, "
            f"{steps} steps, mean step {run['mean_step_ms']:.2f} ms, ttft_p50 "
            f"{run['ttft_p50_s']:.3f} s, drafted {c['drafted']}, accepted "
            f"{c['accepted']} (rate {run['accept_rate']}), verify rows "
            f"{c['verify_rows']}, tokens per verify "
            f"{run['tokens_per_verify']}, pages dropped "
            f"{c['pages_dropped']}, drafting {run['plan_ms_per_step']} ms a "
            f"step, K6 runs {k6}, graphs {len(srv._graphs)}"
            + (f", tokens as the oracle replayed {run['tokens_as_replayed']}"
               if drafter == "oracle" else ""))
        srv.block_pool.check_consistent()
        if any(s != "finished" for s, _, _ in got):
            problems.append(f"{name}: a request did not finish")
        if srv.block_pool.used_count:
            problems.append(f"{name}: {srv.block_pool.used_count} pages "
                            f"leaked")
        if k6 != L * steps:
            problems.append(f"{name}: K6 ran {k6} times, not {L} x {steps}")
        if set(widths) - set(srv.mixed_step_widths):
            problems.append(f"{name}: widths {sorted(set(widths))} outside "
                            f"{srv.mixed_step_widths}")
        if drafter and not c["verify_rows"]:
            problems.append(f"{name}: no verify row was packed")
        if drafter == "oracle":
            if not c["accepted"]:
                problems.append(f"{name}: no oracle draft was accepted")
        elif got != tokens[name]:
            problems.append(f"{name}: a warm run's tokens changed")
    if tokens["captured_spec"] != tokens["uncaptured_spec"]:
        problems.append("the captured run's tokens differ from the "
                        "uncaptured run's")
    kept = {n: sum(a == b for a, b in zip(tokens[n],
                                          tokens["captured_plain"]))
            for n in ("captured_spec", "captured_oracle")}
    names = ("captured_plain", "captured_spec", "captured_oracle")
    mean = {n: {k: statistics.mean(r[k] for r in runs[SPEC_SETUP:]
                                   if r["name"] == n)
                for k in ("tok_s", "mean_step_ms", "ttft_p50_s", "steps",
                          "drafted", "accepted", "verify_rows")}
            for n in names}
    ratio = {n: mean[n]["tok_s"] / mean["captured_plain"]["tok_s"]
             for n in ("captured_spec", "captured_oracle")}
    log(f"spec serve: warm turns {json.dumps(mean)}; tok/s over "
        f"speculation off: prompt lookup {ratio['captured_spec']:.4f}, "
        f"oracle {ratio['captured_oracle']:.4f}; requests whose bf16 "
        f"tokens match speculation off: {kept} of "
        f"{len(traffic)} (not gated: the packed width changes bf16 rows)")
    if problems:
        raise AssertionError("spec serve: " + "; ".join(problems))
    for srv in engines.values():
        srv.block_pool.drop_cached()
    return dict(runs=runs, warm=mean, small=small, launches=launches)


#: the tier phase's engine: the serve phase's slots and lengths, a 320-page
#: pool (five 1024-token prefixes), the prefix cache, captured at bucketed
#: widths; the modes add a 512-page (1 GiB) host tier, synchronous folds,
#: or no tier (the evicted prefixes are recomputed), and the two-program
#: engine with the tier, uncaptured (K7a/K7b's wrapper counts), checked
#: once and not timed: (ServingConfig overrides, enable_cuda_graph)
TIER_SCFG = dict(SERVE_SCFG, num_blocks=320, prefix_cache=True,
                 mixed_step_buckets=True)
TIER_MODES = {"tier": (dict(host_cache_blocks=512), True),
              "sync_promote": (dict(host_cache_blocks=512,
                                    sync_promote=True), True),
              "off": ({}, True),
              "two_program": (dict(host_cache_blocks=512, mixed_step=False,
                                   mixed_step_buckets=False), False)}
#: the measured turns, after one checked warm-up run of each mode
TIER_TURNS = ("tier", "sync_promote", "off", "off", "sync_promote", "tier")


def tier_rounds(vocab, seed, n=8, prefix=1024, suffix=4, new=8):
    """Two rounds over ``n`` distinct ``prefix``-token prefixes, each with a
    fresh ``suffix``; prompt and answer stay inside the prefix's pages and
    one more, so a round indexes exactly ``n`` x 64 pages."""
    rs = np.random.RandomState(seed)
    prefixes = [rs.randint(0, vocab, prefix) for _ in range(n)]
    return [[(np.concatenate([p, rs.randint(0, vocab, suffix)]), new)
             for p in prefixes] for _ in range(2)]


class TierProbe:
    """Inside the block, times ``srv``'s demotion waves (its pool's page
    reader: one gather per pool tensor and the copies into pinned memory,
    waited for) and each promotion's copy to the device (CUDA events on
    the promotion stream around ``upload_paged_blocks``, so any wait for
    the compute stream is included); with ``check`` every fold is held
    against its host payloads bit for bit (a read-back per fold)."""

    def __init__(self, srv, check):
        from deepspeed_tpu_torch.inference.serving import engine as se

        self.se, self.srv, self.check = se, srv, check
        self.waves, self.uploads, self.payloads = [], [], {}
        self.folds = 0
        self.mismatches = []

    def __enter__(self):
        se, pool = self.se, self.srv.block_pool
        self.saved = (se.upload_paged_blocks, se.insert_paged_block,
                      pool.page_reader)
        upload, insert, reader = self.saved

        def timed_reader(bids):
            t = time.perf_counter()
            out = reader(bids)
            self.waves.append((len(bids), time.perf_counter() - t))
            return out

        def timed_upload(payloads, device, stream=None):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            leaves, event = upload(payloads, device, stream)
            end.record(stream)
            self.uploads.append((len(payloads), start, end))
            if self.check:
                self.payloads[id(leaves)] = payloads
            return leaves, event

        def checked_insert(pool_tensors, dst_ids, leaves):
            insert(pool_tensors, dst_ids, leaves)
            self.folds += 1
            payloads = self.payloads.pop(id(leaves), None)
            if payloads is not None:
                for n, t in pool_tensors.items():
                    want = torch.cat([p[n] for p in payloads], dim=1)
                    if not torch.equal(t[:, dst_ids].cpu(), want):
                        self.mismatches.append((list(dst_ids), n))

        se.upload_paged_blocks = timed_upload
        se.insert_paged_block = checked_insert
        pool.page_reader = timed_reader
        return self

    def __exit__(self, *exc):
        se = self.se
        se.upload_paged_blocks, se.insert_paged_block, \
            self.srv.block_pool.page_reader = self.saved

    def summary(self, page_bytes):
        torch.cuda.synchronize()
        out = {}
        if self.waves:
            pages = sum(n for n, _ in self.waves)
            secs = sum(s for _, s in self.waves)
            out.update(demotion_waves=len(self.waves), demoted_pages=pages,
                       demotion_ms_per_wave=1e3 * secs / len(self.waves),
                       demotion_gb_s=pages * page_bytes / secs / 1e9)
        if self.uploads:
            pages = sum(n for n, _, _ in self.uploads)
            ms = sum(s.elapsed_time(e) for _, s, e in self.uploads)
            out.update(promotions=len(self.uploads), promoted_pages=pages,
                       promotion_ms=ms / len(self.uploads),
                       promotion_gb_s=pages * page_bytes / ms / 1e6)
        return out


def pinned_stats():
    """The caching host allocator's counters (pinned memory), where torch
    has them."""
    fn = getattr(torch.cuda, "host_memory_stats", None)
    try:
        return dict(fn()) if fn is not None else {}
    except RuntimeError:
        return {}


def pinned_delta(before):
    """The pinned-allocation counters that moved since ``before``."""
    after = pinned_stats()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if "alloc" in k and isinstance(v, (int, float))
            and v != before.get(k, 0)}


def check_kv_tier(cfg, params, device="cuda"):
    """The host KV tier on full-width Llama-3-8B (the serve phase's bf16
    weights; unified engine, captured at bucketed widths, the prefix
    cache, a 320-page device pool): a first round of 8 requests on
    distinct 1024-token prefixes, then a second round on the same
    prefixes with new suffixes. The pool holds five prefixes, so the
    first round's are evicted before the second asks again: demoted into
    a 512-page (1 GiB) host tier and promoted back, folded synchronously
    (``sync_promote``), or recomputed (no tier); and once through the
    two-program engine with the tier, uncaptured (K7a/K7b, whose wrapper
    counts it adds). One checked warm-up run per mode, then measured
    turns (``TIER_TURNS``) of the unified modes on fresh prefixes,
    each after ``drop_cached`` (a cold start of both tiers). Gates: host
    hits in every tiered second round, every promoted page equal to its
    demoted payload bit for bit (warm-up runs), both tiers consistent, no
    page leaked, no graph captured again and the pool's ``data_ptr``s
    unchanged after the warm-up, K6 once per layer per step (device
    count), every request finished. Prints each run's demotion ms and
    GB/s a wave, promotion ms and GB/s, and the second round's TTFT
    p50. Returns the summary."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaForCausalLM
    from deepspeed_tpu_torch.ops import ragged_attention as ra

    L = cfg.num_hidden_layers
    engines, problems, runs = {}, [], []
    launches = dict(wrapper={n: 0 for n in serving_kernels()}, device=0)
    for mode, (over, captured) in TIER_MODES.items():
        engine = dt.init_inference(LlamaForCausalLM(cfg), params=params,
                                   dtype=torch.bfloat16, device=device,
                                   enable_cuda_graph=captured)
        engines[mode] = dt.ServingEngine(engine, dt.ServingConfig(
            **dict(TIER_SCFG, **over)))
    srv0 = engines["tier"]
    page_bytes = sum(t[:, :1].nbytes for t in srv0.pool.values())
    ptrs = {m: {n: t.data_ptr() for n, t in s.pool.items()}
            for m, s in engines.items()}
    graphs = {}
    for i, mode in enumerate(tuple(TIER_MODES) + TIER_TURNS):
        srv = engines[mode]
        warmup = i < len(TIER_MODES)
        srv.block_pool.drop_cached()
        rounds = tier_rounds(cfg.vocab_size, 100 + i)
        m0 = (srv.metrics.kv_host_hits, srv.metrics.kv_pages_promoted,
              srv.metrics.prefix_hits)
        before = len(step_widths(srv))
        pinned0 = pinned_stats()
        with TierProbe(srv, check=warmup) as probe:
            srv, rids, res, wall, counts = serve(
                cfg, 0, 0, None, None, None, torch.bfloat16, device=device,
                srv=srv, phases=rounds)
        k6 = ra.kernel_runs()
        launches["device"] += k6
        if not TIER_MODES[mode][1]:
            for n, c in counts.items():
                launches["wrapper"][n] += c
        steps = len(step_widths(srv, before))
        second = rids[len(rounds[0]):]
        m = srv.metrics
        run = dict(mode=mode, warmup=warmup, wall_s=wall, steps=steps,
                   ttft_p50_s_round2=float(np.median(
                       [res[r].ttft_s for r in second])),
                   ttft_p50_s_round1=float(np.median(
                       [res[r].ttft_s for r in rids[:len(second)]])),
                   host_hits=m.kv_host_hits - m0[0],
                   pages_promoted=m.kv_pages_promoted - m0[1],
                   prefix_hits=m.prefix_hits - m0[2],
                   folds_checked=probe.folds if warmup else 0,
                   pinned=pinned_delta(pinned0),
                   **probe.summary(page_bytes))
        runs.append(run)
        log(f"kv tier {json.dumps(run)}")
        srv.block_pool.check_consistent()
        if any(res[r].state != "finished" for r in rids):
            problems.append(f"{mode}: a request did not finish")
        if srv.block_pool.used_count:
            problems.append(f"{mode}: {srv.block_pool.used_count} pages "
                            f"leaked")
        if k6 != L * steps:
            problems.append(f"{mode}: K6 ran {k6} times, not {L} x {steps}")
        if mode == "two_program" and not (
                counts["paged_decode_attention"]
                and counts["paged_prefill_attention"]):
            problems.append(f"{mode}: K7a / K7b did not run: {counts}")
        if srv.host_tier is not None and not run["host_hits"]:
            problems.append(f"{mode}: no host hit in the second round")
        if probe.mismatches:
            problems.append(f"{mode}: promoted pages differ from their "
                            f"payloads: {probe.mismatches[:4]}")
        if warmup and srv.host_tier is not None and not probe.folds:
            problems.append(f"{mode}: no fold was checked")
        if warmup:
            graphs[mode] = dict(srv._graphs)
        elif any(srv._graphs.get(k) is not g
                 for k, g in graphs[mode].items()):
            problems.append(f"{mode}: a graph was captured again")
        if {n: t.data_ptr() for n, t in srv.pool.items()} != ptrs[mode]:
            problems.append(f"{mode}: a pool tensor moved")
    for mode, s in engines.items():
        if s.host_tier is not None:
            log(f"kv tier {mode} tier_status {json.dumps(s.tier_status())}")
    measured = {mode: [r for r in runs if r["mode"] == mode
                       and not r["warmup"]] for mode in set(TIER_TURNS)}
    mean = {mode: {k: statistics.mean(r[k] for r in rs)
                   for k in rs[0] if isinstance(rs[0][k], float)}
            for mode, rs in measured.items()}
    log(f"kv tier: measured means {json.dumps(mean)}")
    if problems:
        raise AssertionError("kv tier: " + "; ".join(problems))
    for s in engines.values():
        s.block_pool.drop_cached()
    del engines
    return dict(runs=runs, mean=mean, launches=launches)



#: the two-program engine's full-width run: slots, pages and lengths of
#: check_serving, 64-token chunks under a 256-token budget
LEGACY_SCFG = dict(max_batch_size=8, block_size=16, num_blocks=1024,
                   max_model_len=2048, mixed_step=False, trace=True,
                   trace_capacity=1 << 16)


def check_serving_legacy():
    """Full-width Llama-3-8B (all 32 layers, random bf16 weights from seed
    0) through the two-program engine: 16 seeded requests, 4 shared
    512-token prefixes x 4 requests, unique suffixes of 64-512 tokens,
    32-64 new tokens. First with the prefix cache, 64-token chunks and a
    256-token budget (K7a and K7b; the first request of each prefix is
    served before the other twelve arrive, so those hit its pages), then
    the same requests at once without the cache through the monolithic
    bucketed prefill with prefill_flash_from_empty (K7a and the masked
    K1). Each configuration runs uncaptured, then with enable_cuda_graph
    (the decode, the chunk and each monolithic bucket one CUDA graph),
    which must serve the same tokens; the captured engine then serves the
    first group's prompts again under the profiler, and K7a (and K7b, or
    the masked K1) must run once per layer per replayed forward, counted
    on the device.
    Returns the wrappers' launches of each uncaptured run and the kernels
    of each captured engine's profiled replays, by configuration."""
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    base = LlamaConfig.llama3_8b()
    L = base.num_hidden_layers
    phases = shared_prefix_phases(base.vocab_size, 4, 4, 512, (64, 512),
                                  (32, 64), 0)
    params = LlamaForCausalLM(base).init_params(
        seed=0, dtype=torch.bfloat16, device="cuda")
    runs = {
        "chunked+prefix_cache": (
            base, dict(LEGACY_SCFG, prefix_cache=True,
                       prefill_chunk_tokens=PAGED_CHUNK,
                       prefill_token_budget=256), phases),
        "monolithic+flash": (
            LlamaConfig.llama3_8b(prefill_flash_from_empty=True),
            LEGACY_SCFG, [phases[0] + phases[1]]),
    }
    out, replayed = {}, {}
    for name, (cfg, scfg, traffic) in runs.items():
        cached = scfg.get("prefix_cache", False)
        kernel = "paged_prefill_attention" if cached else \
            "flash_attention_fwd_masked"
        tokens = {}
        for graphed in (False, True):
            run = f"{name} {'captured' if graphed else 'uncaptured'}"
            torch.cuda.reset_peak_memory_stats()
            srv, rids, res, wall, launches = serve(
                cfg, 0, 0, None, None, scfg, torch.bfloat16, phases=traffic,
                params=params, engine_kw=dict(enable_cuda_graph=graphed))
            tokens[graphed] = [(res[r].state, res[r].tokens) for r in rids]
            m = srv.metrics
            snap = m.snapshot()
            finished = sum(res[r].state == "finished" for r in rids)
            log(f"serve two-program {run}: llama3_8b x{L} layers bf16, "
                f"{len(rids)} requests (4 x 4 sharing 512-token prefixes), "
                f"{finished} finished, {m.steps} steps, {srv.decode_calls} "
                f"decode forwards, {srv.prefill_chunk_calls} chunk forwards, "
                f"{srv.prefill_calls} monolithic prefills, wall {wall:.3f} "
                f"s, generated {m.tokens_generated} tokens = "
                f"{m.tokens_generated / wall:.1f} tok/s, prefill "
                f"{m.prefill_tokens} tokens ({m.prefill_tokens_computed} "
                f"computed, {m.cached_prefill_tokens} cached, hit rate "
                f"{m.prefix_hit_rate:.3f}, {m.prefix_hits} prefix hits, "
                f"{m.cow_copies} page copies), ttft_p50 "
                f"{snap.get('ttft_p50_s', float('nan')):.3f} s, mean step "
                f"{1e3 * wall / max(m.steps, 1):.2f} ms, preemptions "
                f"{m.preemptions}, quarantines {m.logit_quarantines}, "
                f"graphs {len(srv._graphs)}, wrapper launches {launches}, "
                f"peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
                f"last decode step decode_mbu {m.decode_mbu}, decode_mfu "
                f"{m.decode_mfu}, tokens/s "
                f"{m.decode_tokens_per_sec_per_chip}")
            srv.block_pool.check_consistent()
            problems = utilization_problems(
                f"serve two-program {run}", decode_mbu=m.decode_mbu,
                decode_mfu=m.decode_mfu)
            if finished != len(rids):
                problems.append(f"{len(rids) - finished} requests did not "
                                f"finish")
            if m.logit_quarantines:
                problems.append(f"{m.logit_quarantines} rows flagged NaN/Inf")
            if srv.block_pool.used_count:
                problems.append(f"{srv.block_pool.used_count} pages leaked")
            if cached and m.prefix_hits < 12:
                problems.append(f"{m.prefix_hits} prefix hits < 12")
            if not graphed:
                want = {"ragged_paged_attention": 0,
                        "paged_decode_attention": L * srv.decode_calls,
                        "paged_prefill_attention":
                            L * srv.prefill_chunk_calls,
                        "flash_attention_fwd_masked": L * srv.prefill_calls}
                if launches != want or not srv.decode_calls or \
                        bool(srv.prefill_chunk_calls) != cached or \
                        bool(srv.prefill_calls) == cached:
                    problems.append(f"launches {launches} != {want}")
                out[name] = launches
            else:
                # the first group's prompts again (their prefixes cached),
                # on graphs captured in the run above: the kernels of each
                # replayed forward, counted on the device
                if tokens[True] != tokens[False]:
                    problems.append("the captured run's tokens differ from "
                                    "the uncaptured run's")
                calls = (srv.decode_calls, srv.prefill_chunk_calls,
                         srv.prefill_calls)
                counts, busy, prof_wall = profiled(lambda: serve(
                    cfg, 0, 0, None, None, scfg, torch.bfloat16,
                    phases=[[(p, 8) for p, _ in traffic[0]]], srv=srv),
                    ("paged_decode_attention", kernel))
                dec, chunk, mono = (a - b for a, b in zip(
                    (srv.decode_calls, srv.prefill_chunk_calls,
                     srv.prefill_calls), calls))
                want = {"paged_decode_attention": L * dec,
                        kernel: L * (chunk if cached else mono)}
                log(f"serve two-program {run} replays: {dec} decode, "
                    f"{chunk} chunk and {mono} monolithic forwards, kernels "
                    f"{counts} (want {want}), device busy {busy:.1f} of "
                    f"{prof_wall:.1f} ms profiled (idle share "
                    f"{1 - busy / max(prof_wall, 1e-9):.3f})")
                if counts != want or not dec:
                    problems.append(f"replayed kernels {counts} != {want}")
                replayed[name] = counts
                if srv.block_pool.used_count:
                    problems.append(f"{srv.block_pool.used_count} pages "
                                    f"leaked after the replays")
            if problems:
                raise AssertionError(f"serve two-program {run}: "
                                     + "; ".join(problems))
            del srv, res
            gc.collect()
            torch.cuda.empty_cache()
    check_chaos_serve(
        "two-program", base, params,
        dict(LEGACY_SCFG, prefix_cache=True, prefill_chunk_tokens=PAGED_CHUNK,
             prefill_token_budget=256), [[(np.arange(200), 4)]], phases)
    return out, replayed


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def model_flops_per_step(n_params, batch, seq, n_layer, hidden):
    """fwd+bwd FLOPs: 6 N tokens + attention 12 L B T^2 H (the JAX
    package's bench formula, PaLM appendix B)."""
    return 6.0 * n_params * batch * seq + 12.0 * n_layer * batch * seq \
        * seq * hidden


def train_kernels():
    """The wrappers of the training step's kernels, by name: K1 (forward
    and recompute), K2 (dQ, dK/dV), K3."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam

    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "fused_adam": fused_adam}


def profiled(fn, names):
    """Run ``fn()`` once under torch.profiler (then synchronize). Returns
    the runs of each kernel of ``names`` (wrapper names), counted on the
    device by the kernel itself (CUDA-graph replays included; a trace may
    drop a kernel's record, the count does not), the device busy time
    (union of the trace's kernel intervals, ms) and the profiled wall
    time (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.ops import _runs

    torch.cuda.synchronize()
    for n in names:
        _runs.reset_kernel_runs(n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's events, less its copies, fills and annotation spans
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))
               and not getattr(e, "is_user_annotation", False)]
    counts = {n: _runs.kernel_runs(n) for n in names}
    busy, end = 0.0, -1.0
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    return counts, busy / 1e3, wall * 1e3


def train(cfg, config, ids, steps, warmup, device="cuda", graphed=True,
          engine=None):
    """initialize + train_batch on ``cfg`` with weights from seed
    ``config["seed"]`` (or more steps on ``engine``): ``warmup`` steps,
    then the kernel counts set to 0 and ``steps`` steps on the same batch.
    ``graphed`` False runs the step uncaptured (``cuda_graph=False``). The
    counts are the wrappers' (a captured step adds to them when it is
    captured, not when it is replayed). Returns the engine, every step's
    loss (device scalars), the wall time of the counted steps and their
    launches per kernel."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaForCausalLM

    counted = train_kernels()
    if engine is None:
        engine, *_ = dt.initialize(model=LlamaForCausalLM(cfg),
                                   config=dict(config), device=device,
                                   cuda_graph=graphed)
    batch = {"input_ids": ids, "labels": ids}
    losses = [engine.train_batch(batch=batch) for _ in range(warmup)]
    if device == "cuda":
        torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses += [engine.train_batch(batch=batch) for _ in range(steps)]
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return engine, losses, wall, {n: fn.launches for n, fn in counted.items()}


#: the JAX package's training bench config (bench.py), one device
TRAIN_CONFIG = {"train_batch_size": 8,
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 1e-4, "weight_decay": 0.1}},
                "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                "steps_per_print": 0, "seed": 0}
TRAIN_SEQ = 1024

#: the small reference's runs: fp32, and fp16 whose first steps overflow
#: (a loss scale of 2**26, hysteresis 1: halved each overflow until the
#: steps train)
SMALL_TRAIN_RUNS = {
    "fp32": ({}, 0),
    "fp16": ({"fp16": {"enabled": True, "initial_scale_power": 26,
                       "hysteresis": 1}}, 1),
}


def check_small_train_reference(device="cuda"):
    """A 2-layer model (D 64, MHA) trained 5 steps in fp32, and 10 steps
    in fp16 from a loss scale that overflows its first steps, each twice from
    the same weights (captured): with the kernels, and with the model's
    attention and the optimizer's sweep swapped for their plain versions.
    Losses agree to 1e-4 relative (fp32: summation order only; fp16: the
    attention runs the fp32 kernels on exactly widened inputs in both
    routes, the fp16 rounding of the rest is the same), the fp16 runs skip
    the same steps at the same loss scales."""
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.models import layers as layers_mod
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as adam_mod
    from deepspeed_tpu_torch.ops import optimizers as opt_mod

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=4, max_position_embeddings=256)
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size, (4, 256))
    kernels = (layers_mod.flash_attention, opt_mod.fused_adam)

    def plain_flash(q, k, v, causal=True, sm_scale=None, window=None):
        return fa.flash_attention_plain(q, k, v, causal, sm_scale,
                                        window)[0]

    def plain_adam(*lists, table=None, **kw):
        # the plain version reads no table, so it returns none to keep
        adam_mod.fused_adam_plain(*lists, **kw)

    for name, (over, min_skips) in SMALL_TRAIN_RUNS.items():
        config = dict(TRAIN_CONFIG, train_batch_size=4,
                      bf16={"enabled": False}, **over,
                      optimizer={"type": "AdamW",
                                 "params": {"lr": 1e-3, "weight_decay": 0.1}})
        steps = 10 if over else 5
        losses, launches, state = {}, {}, {}
        for route in ("kernel", "plain"):
            if route == "plain":
                layers_mod.flash_attention = plain_flash
                opt_mod.fused_adam = plain_adam
            try:
                engine, out, _, launches[route] = train(cfg, config, ids,
                                                        steps, 0, device)
            finally:
                layers_mod.flash_attention, opt_mod.fused_adam = kernels
            losses[route] = [float(x) for x in out]
            state[route] = (engine.get_skipped_steps(), engine.loss_scale)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"],
                                                      losses["plain"]))
        ok = rel <= 1e-4 and all(launches["kernel"].values()) and \
            not any(launches["plain"].values()) and \
            state["kernel"] == state["plain"] and \
            state["kernel"][0] >= min_skips and \
            all(np.isfinite(losses["kernel"]))
        log(f"reference: 2-layer {name} model trained {steps} steps "
            f"(captured), kernels vs plain versions: losses "
            f"{losses['kernel']} vs {losses['plain']}, max relative "
            f"difference {rel:.3e} (tolerance 1e-4), skipped steps and "
            f"loss scale {state['kernel']} / {state['plain']}, ok={ok} "
            f"(launches {launches['kernel']} / {launches['plain']})")
        if not ok:
            raise AssertionError(f"small {name} training: the losses or the "
                                 f"skipped steps disagree, or a route "
                                 f"launched the wrong kernels")


def gauge_turn(engine, batch, steps):
    """``steps`` + 1 more steps on ``engine``, each waited for
    (``perf_summary()``): after each step but the first, the engine's
    ``train_tflops_per_chip`` gauge (that step's device time, from the
    previous step's end to its end on CUDA events) and the host's wall
    time between the same two step ends. Returns the losses, the gauges
    and the wall times."""
    losses = [engine.train_batch(batch=batch)]
    engine.perf_summary()
    t = time.perf_counter()
    gauges, walls = [], []
    for _ in range(steps):
        losses.append(engine.train_batch(batch=batch))
        engine.perf_summary()
        now = time.perf_counter()
        gauges.append(engine.registry.snapshot()["train_tflops_per_chip"])
        walls.append(now - t)
        t = now
    return losses, gauges, walls


def check_training(cfg=None, device="cuda"):
    """Full-width Llama-400M (all 24 layers, random weights from seed 0)
    through initialize -> train_batch at the bench config, twice from the
    same weights: uncaptured (``cuda_graph=False``) and captured (one CUDA
    graph a step), each 2 warm-up steps, then 5 timed steps each in turns
    (uncaptured, captured, captured, uncaptured), then 6 steps each
    waited for (:func:`gauge_turn`: the engine's gauge against the hand
    count over the last 5, within 5%) and one profiled step each. The
    losses of the two routes must be identical step for step,
    finite and falling; each route's profiled step must run K1 2 x layers
    (forward and recompute), K2 layers + layers and K3 once (the captured
    one in its replay), counted on the device. Returns the uncaptured
    route's launches over its timed steps (the wrappers' counts) and the
    kernels' runs in the captured route's profiled replay."""
    from deepspeed_tpu_torch.models import LlamaConfig

    cfg = cfg or LlamaConfig.llama_400m(max_position_embeddings=TRAIN_SEQ,
                                        remat=True)
    warmup, turn = 2, 5
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_CONFIG["train_batch_size"], TRAIN_SEQ)))
    L = cfg.num_hidden_layers
    routes = {}
    for graphed in (False, True):
        if device == "cuda":
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        engine, losses, _, _ = train(cfg, TRAIN_CONFIG, ids, 0, warmup,
                                     device, graphed)
        peak = torch.cuda.max_memory_allocated() - base \
            if device == "cuda" else 0
        routes[graphed] = dict(engine=engine, losses=losses, wall=0.0,
                               launches={}, setup=time.perf_counter() - t,
                               peak=peak)
    for graphed in (False, True, True, False):
        r = routes[graphed]
        _, more, wall, launches = train(cfg, TRAIN_CONFIG, ids, turn, 0,
                                        device, engine=r["engine"])
        r["losses"] += more
        r["wall"] += wall
        for n, c in launches.items():
            r["launches"][n] = r["launches"].get(n, 0) + c
    batch = {"input_ids": ids, "labels": ids}
    steps = 2 * turn
    n_params = sum(p.numel() for p in routes[False]["engine"].master.values())
    tokens = TRAIN_CONFIG["train_batch_size"] * TRAIN_SEQ
    flops = model_flops_per_step(n_params, TRAIN_CONFIG["train_batch_size"],
                                 TRAIN_SEQ, L, cfg.hidden_size)
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "fused_adam": 1}
    problems = []
    for graphed in (False, True):
        r = routes[graphed]
        engine = r["engine"]
        name = "captured" if graphed else "uncaptured"
        step_s = r["wall"] / steps
        # the engine's own gauge against the hand count over the same
        # steps: `turn` more steps, each waited for, the gauge read after
        # each (device time on CUDA events) and the host's wall time
        # between the same step ends; both as total work over total time
        more, tflops, walls = gauge_turn(engine, batch, turn)
        r["losses"] += more
        gauges = engine.registry.snapshot()
        r["train_mfu"] = gauges.get("train_mfu")
        ok = all(g is not None for g in tflops)
        r["train_tflops"] = len(tflops) / sum(1 / g for g in tflops) \
            if ok else None
        hand_tflops = flops / (sum(walls) / turn) / 1e12
        log(f"train {name} gauges: train_tflops_per_chip over {turn} "
            f"waited steps {[round(g, 3) for g in tflops] if ok else tflops} "
            f"(each step's device time, the previous step's end to its end "
            f"on CUDA events; {r['train_tflops']} over the {turn}), hand "
            f"count {hand_tflops:.3f} TFLOP/s over the host's wall time "
            f"between the same step ends ({[round(1e3 * w, 3) for w in walls]}"
            f" ms), last train_mfu {r['train_mfu']}; the timed steps: "
            f"{flops / step_s / 1e12:.3f} TFLOP/s over all {steps} = "
            f"{flops / step_s / BF16_FLOP_PER_S:.4f} of 989, train_batch_s "
            f"p50 {gauges.get('train_batch_s_p50')} s, program "
            f"{engine.perf.programs.table()}")
        if device == "cuda":
            problems += utilization_problems(f"train {name}",
                                             train_mfu=r["train_mfu"])
            if r["train_tflops"] is None or \
                    abs(r["train_tflops"] / hand_tflops - 1) > 0.05:
                problems.append(f"{name}: train_tflops_per_chip "
                                f"{r['train_tflops']} over {turn} steps not "
                                f"within 5% of the hand count "
                                f"{hand_tflops:.3f} over the same steps")
        if device == "cuda":
            losses = r["losses"]
            replayed, busy, prof_wall = profiled(
                lambda: losses.append(engine.train_batch(batch=batch)),
                want)
        else:
            replayed, busy, prof_wall = {}, 0.0, 0.0
        r["replayed"] = replayed
        r["losses"] = [float(x) for x in r["losses"]]
        log(f"train {name}: llama_400m x{L} layers ({n_params} params) "
            f"bf16, batch {TRAIN_CONFIG['train_batch_size']} x {TRAIN_SEQ}, "
            f"{warmup} warm-up + {steps} timed steps (in turns), step "
            f"{1e3 * step_s:.2f} ms, {tokens / step_s:.1f} tokens/s, model "
            f"{flops / step_s / 1e12:.2f} TFLOP/s = "
            f"{flops / step_s / BF16_FLOP_PER_S:.4f} of 989, device busy "
            f"{busy:.2f} ms of a profiled step of {prof_wall:.2f} ms (idle "
            f"share {1 - busy / max(prof_wall, 1e-9):.3f} profiled, "
            f"{1 - busy / (1e3 * step_s):.3f} of the unprofiled step), "
            f"losses {[round(x, 4) for x in r['losses']]}, grad norm "
            f"{engine.get_global_grad_norm():.4f}, setup {r['setup']:.1f} s, "
            f"peak memory {r['peak'] / 2**30:.1f} GiB, wrapper launches "
            f"over the timed steps {r['launches']}, kernel runs in the profiled "
            f"step {replayed}")
        losses = r["losses"]
        if not all(np.isfinite(losses)):
            problems.append(f"{name}: a loss is not finite")
        if not losses[-1] < losses[0]:
            problems.append(f"{name}: the loss did not fall ({losses[0]} -> "
                            f"{losses[-1]})")
        if device == "cuda" and replayed != want:
            problems.append(f"{name}: kernels of a step {replayed} != {want}")
    if routes[False]["launches"] != {n: c * steps for n, c in want.items()}:
        problems.append(f"uncaptured wrapper launches "
                        f"{routes[False]['launches']} != {want} x {steps}")
    if routes[True]["losses"] != routes[False]["losses"]:
        problems.append("the captured and uncaptured losses differ")
    if problems:
        raise AssertionError("train: " + "; ".join(problems))
    return routes[False]["launches"], routes[True]["replayed"]


# ---------------------------------------------------------------------------
# the rest of the training subset (remat policies, the chunked loss, padded
# batches, progressive layer drop, a generic module with a client optimizer)
# ---------------------------------------------------------------------------

#: (a): micro-batch 8 x 1024, gas 8 (bench.py's ``m8xgas8``), the routes
#: of bench.py's leading candidates and their neighbours: (name, remat
#: policy, loss chunk)
SUBSET_MICRO, SUBSET_GAS = 8, 8
#: the train subset runs Llama-400M cut to 12 of its 24 layers, so that the
#: script with its offload phases stays inside its time (the full depth
#: trains in the ``train`` phase)
SUBSET_LAYERS = 12
SUBSET_ROUTES = (("nothing", "nothing", 0), ("dots", "dots", 0),
                 ("dots,lc2048", "dots", 2048),
                 ("offload_dots_no_batch,lc2048", "offload_dots_no_batch",
                  2048))
SUBSET_WARMUP, SUBSET_TIMED = 2, 3
#: (c): progressive layer drop's settings and replays
PLD_THETA, PLD_GAMMA, PLD_REPLAYS = 0.5, 0.1, 20
#: (d): the generic module: layers x width, batch, steps per run
MLP_LAYERS, MLP_WIDTH, MLP_BATCH, MLP_STEPS = 4, 4096, 4096, 6


def subset_engine(cfg, cfg_over, config_over, device, graphed=True,
                  model=None, **kw):
    """initialize on ``cfg`` (weights from seed 0) at the bench config
    with ``cfg_over`` on the model and ``config_over`` on the config (or
    on ``model``)."""
    import dataclasses

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaForCausalLM

    if model is None:
        model = LlamaForCausalLM(dataclasses.replace(cfg, **cfg_over))
    return dt.initialize(model=model, config={**TRAIN_CONFIG, **config_over},
                         device=device, cuda_graph=graphed, **kw)


def device_runs(names):
    from deepspeed_tpu_torch.ops import _runs

    return {n: _runs.kernel_runs(n) for n in names}


def reset_device_runs(names):
    from deepspeed_tpu_torch.ops import _runs

    for n in names:
        _runs.reset_kernel_runs(n)


def steady_state(fn, n, device, base, names=()):
    """``n`` calls of ``fn`` (a training step each) timed together, then
    one more under the profiler. Returns (s a step, device busy ms,
    profiled wall ms, peak bytes above ``base`` since the last peak
    reset, the device runs of the kernels ``names`` in the profiled
    call)."""
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    if device == "cuda":
        torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / n
    if device != "cuda":
        fn()
        return step_s, 0.0, 0.0, 0, {}
    runs, busy, wall = profiled(fn, list(names))
    return step_s, busy, wall, torch.cuda.max_memory_allocated() - base, runs


def memory_base(device):
    """Bytes allocated now, the peak counter reset (0 off the card)."""
    gc.collect()
    if device != "cuda":
        return 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def subset_remat_routes(cfg, device):
    """(a) Each route of ``SUBSET_ROUTES`` on its own engine (seed 0,
    captured): ``SUBSET_WARMUP`` steps, then :func:`steady_state` over
    ``SUBSET_TIMED`` timed steps and one profiled step (device counts,
    busy time). Returns per route: losses,
    step s, peak bytes, profiled counts, busy and profiled wall ms."""
    L = cfg.num_hidden_layers
    names = list(train_kernels())
    batch_size = SUBSET_MICRO * SUBSET_GAS
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch_size, TRAIN_SEQ)))
    batch = {"input_ids": ids, "labels": ids}
    config = {"train_batch_size": batch_size,
              "gradient_accumulation_steps": SUBSET_GAS}
    out = {}
    for name, policy, chunk in SUBSET_ROUTES:
        base = memory_base(device)
        # keep no other part of initialize's result: the optimizer would
        # outlive the engine into the next route's measurement
        engine = subset_engine(cfg, dict(remat_policy=policy,
                                         loss_chunk=chunk), config,
                               device)[0]
        losses = []

        def step():
            losses.append(engine.train_batch(batch=batch))

        for _ in range(SUBSET_WARMUP):
            step()
        step_s, busy, wall, peak, runs = steady_state(
            step, SUBSET_TIMED, device, base, names)
        stash = sum(s.nbytes for s in engine.module.model._stashes)
        out[name] = dict(losses=[float(x) for x in losses], step_s=step_s,
                         peak=peak, runs=runs, busy=busy, wall=wall,
                         stash=stash, graphs=len(engine._graphs))
        del engine, step
    want = {"flash_attention_fwd": 2 * L * SUBSET_GAS,
            "flash_attention_bwd_dq": L * SUBSET_GAS,
            "flash_attention_bwd_dkv": L * SUBSET_GAS, "fused_adam": 1}
    return out, want


def subset_padded(cfg, device):
    """(b) Right-padded micro-batches (8 x 1024, pad lengths uniform in
    0-512 from seed 1, labels -100 on the pads): 5 steps uncaptured, then
    5 captured on a second engine from the same weights, then the
    captured engine's steady state (:func:`steady_state`, 3 steps).
    Returns both routes' losses and the kernels' counts over the 5 steps
    (the wrappers' uncaptured, the device's over the captured replays),
    and the steady state."""
    names = list(train_kernels())
    rs = np.random.RandomState(1)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                      (TRAIN_CONFIG["train_batch_size"],
                                       TRAIN_SEQ)))
    pads = rs.randint(0, TRAIN_SEQ // 2 + 1, TRAIN_CONFIG["train_batch_size"])
    mask = (torch.arange(TRAIN_SEQ)[None] <
            torch.from_numpy(TRAIN_SEQ - pads)[:, None]).long()
    batch = {"input_ids": ids, "labels": torch.where(mask > 0, ids, -100),
             "attention_mask": mask}
    counted = train_kernels()
    out = {}
    for graphed in (False, True):
        base = memory_base(device)
        engine = subset_engine(cfg, {}, {}, device, graphed=graphed)[0]
        for fn in counted.values():
            fn.launches = 0
        if device == "cuda":
            torch.cuda.synchronize()
            reset_device_runs(names)
        t = time.perf_counter()
        losses = [engine.train_batch(batch=batch) for _ in range(5)]
        losses = [float(x) for x in losses]
        wall = time.perf_counter() - t
        out[graphed] = dict(
            losses=losses, wall=wall,
            launches={n: fn.launches for n, fn in counted.items()},
            runs=device_runs(names) if device == "cuda" else {})
        if graphed:
            out[graphed]["steady"] = steady_state(
                lambda: engine.train_batch(batch=batch), 3, device, base)
        del engine
        gc.collect()
    return out, pads


def subset_pld(cfg, device):
    """(c) PLD at theta ``PLD_THETA``, gamma ``PLD_GAMMA`` on a captured
    engine: one step (eager, then captured), then ``PLD_REPLAYS``
    replays, each one's theta and gates read back, then the steady state
    (:func:`steady_state`, 3 replays). Returns thetas, gates, losses, the
    kernels' device runs over the 20 replays and the steady state."""
    names = list(train_kernels())
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (TRAIN_CONFIG["train_batch_size"], TRAIN_SEQ)))
    batch = {"input_ids": ids, "labels": ids}
    base = memory_base(device)
    engine = subset_engine(cfg, {}, {"progressive_layer_drop": {
        "enabled": True, "theta": PLD_THETA, "gamma": PLD_GAMMA}}, device)[0]
    engine.train_batch(batch=batch)
    if device == "cuda":
        torch.cuda.synchronize()
        reset_device_runs(names)
    thetas, gates, losses, steps = [], [], [], []
    for _ in range(PLD_REPLAYS):
        steps.append(int(engine.step_count))
        losses.append(float(engine.train_batch(batch=batch)))
        thetas.append(float(engine.pld_theta))
        gates.append(engine.module.model.last_pld_gates.float().cpu())
    runs = device_runs(names) if device == "cuda" else {}
    graphs = len(engine._graphs)
    steady = steady_state(lambda: engine.train_batch(batch=batch), 3,
                          device, base)
    del engine
    return dict(thetas=thetas, gates=torch.stack(gates), losses=losses,
                steps=steps, runs=runs, graphs=graphs, steady=steady)


class _MLP(torch.nn.Module):
    """(d)'s generic module: ``MLP_LAYERS`` Linear(width, width) with GELU
    between, the mean squared error against ``y``; it casts its input to
    the bound weights' dtype."""

    def __init__(self):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            torch.nn.Linear(MLP_WIDTH, MLP_WIDTH) for _ in range(MLP_LAYERS))

    def forward(self, x, y):
        h = x.to(self.layers[0].weight.dtype)
        for i, layer in enumerate(self.layers):
            h = layer(h)
            if i < MLP_LAYERS - 1:
                h = torch.nn.functional.gelu(h)
        return ((h.float() - y) ** 2).mean()


class _Rows:
    """A dataset of ``(x, y)`` rows as dict samples over two arrays."""

    def __init__(self, n, seed):
        rs = np.random.RandomState(seed)
        self.x = rs.randn(n, MLP_WIDTH).astype(np.float32)
        self.y = np.tanh(self.x[:, ::-1] * 0.5).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def _mlp_loss(module, batch, generator):
    """(d)'s loss_fn: the module's loss on inputs with 10% of their
    entries dropped by draws from the engine's generator."""
    x = batch["x"]
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= 0.1
    loss = module(x=torch.where(keep, x / 0.9, torch.zeros_like(x)),
                  y=batch["y"])
    return loss, ()


def subset_generic(device):
    """(d) The MLP through ``training_data`` (the port's
    ``DeepSpeedDataLoader``), ``loss_fn`` and ``csv_monitor``: with the
    config's AdamW and with a client ``torch.optim.AdamW(capturable=
    True)``, each uncaptured and captured from the same weights over the
    same batches, then each captured engine's steady state
    (:func:`steady_state`, 3 steps, the loader's collate included).
    Returns per (optimizer, route) the losses, K3's runs over the steps,
    the CSV files written, the step ms, the FLOPs a step the engine
    counted and the steady state."""
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    data = _Rows(MLP_BATCH * 4, seed=3)
    out = {}
    tmp = tempfile.mkdtemp(prefix="csv_monitor_")
    try:
        for opt in ("config", "client"):
            for graphed in (False, True):
                base = memory_base(device)
                torch.manual_seed(0)
                model = _MLP()
                kw = {}
                config = {"train_batch_size": MLP_BATCH,
                          "csv_monitor": {"enabled": True,
                                          "output_path": tmp,
                                          "job_name": f"{opt}_{graphed}"}}
                if opt == "client":
                    kw["optimizer"] = torch.optim.AdamW(
                        model.parameters(), lr=1e-4, weight_decay=0.1,
                        capturable=device == "cuda")
                    config["optimizer"] = None
                built = subset_engine(
                    None, {}, config, device, graphed=graphed, model=model,
                    training_data=data, collate_fn=None, loss_fn=_mlp_loss,
                    **kw)
                engine, loader = built[0], built[2]
                del built
                it = iter(RepeatingLoader(loader))
                engine.train_batch(data_iter=it)
                if device == "cuda":
                    torch.cuda.synchronize()
                    reset_device_runs(["fused_adam"])
                t = time.perf_counter()
                losses = [float(engine.train_batch(data_iter=it))
                          for _ in range(MLP_STEPS - 1)]
                ms = 1e3 * (time.perf_counter() - t) / (MLP_STEPS - 1)
                job = os.path.join(tmp, f"{opt}_{graphed}")
                files = sorted(os.listdir(job))
                with open(os.path.join(job,
                                       "Train_Samples_train_loss.csv")) as f:
                    rows = f.read().split()
                out[(opt, graphed)] = dict(
                    losses=losses, ms=ms, files=files, loss_rows=rows,
                    runs=device_runs(["fused_adam"])["fused_adam"]
                    if device == "cuda" else None,
                    graphs=len(engine._graphs), loader=type(loader).__name__,
                    flops=engine.perf.programs.program("train_step").flops)
                if graphed:
                    out[(opt, graphed)]["steady"] = steady_state(
                        lambda: engine.train_batch(data_iter=it), 3, device,
                        base)
                del engine
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return out


def steady_line(steady, flops):
    """The steady state of :func:`steady_state` in the phase's words."""
    step_s, busy, wall, peak, _ = steady
    tflops = flops / step_s / 1e12 if flops else None
    return (f"steady state: step {1e3 * step_s:.2f} ms, model "
            f"{tflops if tflops is None else round(tflops, 2)} TFLOP/s, "
            f"peak memory {peak / 1e9:.3f} GB, device busy {busy:.2f} ms of "
            f"a profiled step of {wall:.2f} ms (idle share "
            f"{1 - busy / max(wall, 1e-9):.3f})")


def check_train_subset(cfg=None, device="cuda"):
    """The ``train subset`` phase: (a) remat policies and the chunked loss,
    (b) a padded batch, (c) progressive layer drop, (d) a generic module
    with a client optimizer (see :func:`subset_remat_routes`,
    :func:`subset_padded`, :func:`subset_pld`, :func:`subset_generic`).
    Returns the kernels' device runs per route (for the ``kernels``
    line's ``graph_launches``)."""
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = cfg or LlamaConfig.llama_400m(max_position_embeddings=TRAIN_SEQ,
                                        remat=True,
                                        num_hidden_layers=SUBSET_LAYERS)
    L = cfg.num_hidden_layers
    problems, graph_runs = [], {}
    cuda = device == "cuda"

    # (a) remat policies and the chunked loss
    routes, want = subset_remat_routes(cfg, device)
    batch_size = SUBSET_MICRO * SUBSET_GAS
    tokens = batch_size * TRAIN_SEQ
    n_params = sum(p.numel() for p in LlamaForCausalLM(cfg).parameters())
    flops = model_flops_per_step(n_params, batch_size, TRAIN_SEQ, L,
                                 cfg.hidden_size)
    for name, r in routes.items():
        step_ms = 1e3 * r["step_s"]
        idle = 1 - r["busy"] / max(r["wall"], 1e-9)
        log(f"train subset (a) {name}: micro {SUBSET_MICRO} x {TRAIN_SEQ}, "
            f"gas {SUBSET_GAS}, captured ({r['graphs']} graph), step "
            f"{step_ms:.2f} ms, {tokens / r['step_s']:.1f} tokens/s, model "
            f"{flops / r['step_s'] / 1e12:.2f} TFLOP/s = "
            f"{flops / r['step_s'] / BF16_FLOP_PER_S:.4f} of 989, peak "
            f"memory {r['peak'] / 1e9:.3f} GB, host stash "
            f"{r['stash'] / 1e9:.3f} GB, device busy {r['busy']:.2f} ms of a "
            f"profiled step of {r['wall']:.2f} ms (idle share {idle:.3f}), "
            f"kernel runs in the profiled step {r['runs']}, losses "
            f"{[round(x, 5) for x in r['losses']]}")
        r.update(step_ms=step_ms, tflops=flops / r["step_s"] / 1e12,
                 idle=idle)
        graph_runs[f"train subset (a) {name}"] = r["runs"]
        losses = r["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            problems.append(f"(a) {name}: losses not finite and falling "
                            f"{losses}")
        if cuda and r["runs"] != want:
            problems.append(f"(a) {name}: kernel runs a step {r['runs']} != "
                            f"{want}")
    a = routes
    # same weights, batch and kernels: what a policy keeps changes where a
    # backward operand comes from (kept, recomputed, copied back from the
    # host), never its bits, so every step's loss is the same
    for kept, other in (("dots", "nothing"),
                        ("offload_dots_no_batch,lc2048", "dots,lc2048")):
        log(f"train subset (a) {kept} vs {other} losses: "
            f"{a[kept]['losses']!r} vs {a[other]['losses']!r}")
        if a[kept]["losses"] != a[other]["losses"]:
            problems.append(f"(a) the losses of {kept} and {other} differ")
    rel = abs(a["dots,lc2048"]["losses"][0] / a["dots"]["losses"][0] - 1)
    log(f"train subset (a) chunked vs plain loss at step 1: "
        f"{a['dots,lc2048']['losses'][0]!r} vs {a['dots']['losses'][0]!r}, "
        f"relative {rel:.3e} (tolerance 1e-3); peak memory drop "
        f"{(a['dots']['peak'] - a['dots,lc2048']['peak']) / 1e9:.3f} GB "
        f"(>= 0.5), offload vs dots peak "
        f"{a['offload_dots_no_batch,lc2048']['peak'] / 1e9:.3f} vs "
        f"{a['dots']['peak'] / 1e9:.3f} GB")
    if rel > 1e-3:
        problems.append(f"(a) chunked loss {rel:.3e} from the plain one")
    if cuda:
        if a["dots"]["peak"] - a["dots,lc2048"]["peak"] < 0.5e9:
            problems.append("(a) lc2048 saves < 0.5 GB of peak memory")
        if not a["offload_dots_no_batch,lc2048"]["peak"] < a["dots"]["peak"]:
            problems.append("(a) offload's peak is not below dots'")
        if not a["offload_dots_no_batch,lc2048"]["stash"] > 0:
            problems.append("(a) the offload route kept nothing on the host")

    # (b) a padded batch (model FLOPs at the train phase's batch: every
    # position is computed, padded or not)
    step_flops = model_flops_per_step(
        n_params, TRAIN_CONFIG["train_batch_size"], TRAIN_SEQ, L,
        cfg.hidden_size)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    padded, pads = subset_padded(cfg, device)
    for graphed, r in padded.items():
        route = "captured" if graphed else "uncaptured"
        log(f"train subset (b) padded {route}: micro "
            f"{TRAIN_CONFIG['train_batch_size']} x {TRAIN_SEQ}, pads "
            f"{pads.tolist()}, losses {r['losses']}, "
            f"{1e3 * r['wall'] / 5:.2f} ms a step (first step included), "
            f"wrapper launches {r['launches']}, device runs {r['runs']}"
            + (f"; {steady_line(r['steady'], step_flops)}" if graphed
               else ""))
    graph_runs["train subset (b) padded"] = padded[True]["runs"]
    if padded[True]["losses"] != padded[False]["losses"]:
        problems.append("(b) captured and uncaptured padded losses differ")
    losses = padded[False]["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"(b) padded losses not finite and falling {losses}")
    flash = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    if any(padded[False]["launches"][n] for n in flash) or \
            padded[False]["launches"]["fused_adam"] != 5:
        problems.append(f"(b) uncaptured launches {padded[False]['launches']}")
    if cuda and (any(padded[True]["runs"][n] for n in flash) or
                 padded[True]["runs"]["fused_adam"] != 5):
        problems.append(f"(b) captured device runs {padded[True]['runs']}")

    # (c) progressive layer drop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    pld = subset_pld(cfg, device)
    host = [(1 - PLD_THETA) * np.exp(-PLD_GAMMA * s) + PLD_THETA
            for s in pld["steps"]]
    theta_err = max(abs(a - b) for a, b in zip(pld["thetas"], host))
    gates = pld["gates"]
    kept = (gates > 0).sum(0).numpy()
    depth = (np.arange(L) + 1) / L
    p = np.array([[1 - d * (1 - th) for d in depth] for th in host])
    expect, sigma = p.sum(0), np.sqrt((p * (1 - p)).sum(0))
    worst = float(np.max(np.abs(kept - expect) / (sigma + 1e-9)))
    distinct = len({tuple(g.tolist()) for g in gates})
    log(f"train subset (c) pld theta {PLD_THETA} gamma {PLD_GAMMA}: "
        f"{PLD_REPLAYS} replays of {pld['graphs']} graph at steps "
        f"{pld['steps'][0]}..{pld['steps'][-1]}, theta max error "
        f"{theta_err:.2e} (tolerance 1e-6), {distinct} distinct gate "
        f"vectors, keeps per layer {kept.tolist()} against expected "
        f"{np.round(expect, 2).tolist()} (worst {worst:.2f} sigma), losses "
        f"{[round(x, 4) for x in pld['losses']]}, device runs "
        f"{pld['runs']}; {steady_line(pld['steady'], step_flops)}")
    graph_runs["train subset (c) pld"] = pld["runs"]
    if theta_err > 1e-6:
        problems.append(f"(c) theta off the host formula by {theta_err}")
    if distinct < 2:
        problems.append("(c) the gates did not change between replays")
    if worst > 4.0:
        problems.append(f"(c) a layer's keep rate is {worst:.2f} sigma off")
    if not all(np.isfinite(pld["losses"])):
        problems.append("(c) a PLD loss is not finite")
    if cuda and pld["runs"].get("flash_attention_fwd") != \
            2 * L * PLD_REPLAYS:
        problems.append(f"(c) K1 ran {pld['runs']} in {PLD_REPLAYS} "
                        f"replays, not {2 * L} each")

    # (d) a generic module with a client optimizer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    generic = subset_generic(device)
    for (opt, graphed), r in generic.items():
        log(f"train subset (d) mlp {MLP_LAYERS} x {MLP_WIDTH}, batch "
            f"{MLP_BATCH}, {opt} optimizer, "
            f"{'captured' if graphed else 'uncaptured'} ({r['graphs']} "
            f"graph), {r['loader']}: losses {r['losses']}, {r['ms']:.2f} ms "
            f"a step (data loading included), K3 runs {r['runs']}, csv "
            f"files {r['files']}, {r['flops']} FLOPs a step (counted)"
            + (f"; {steady_line(r['steady'], r['flops'])}" if graphed
               else ""))
    for opt, k3 in (("config", MLP_STEPS - 1), ("client", 0)):
        c, u = generic[(opt, True)], generic[(opt, False)]
        if c["losses"] != u["losses"]:
            problems.append(f"(d) {opt}: captured losses differ from "
                            f"uncaptured")
        if not all(np.isfinite(c["losses"])):
            problems.append(f"(d) {opt}: a loss is not finite")
        if cuda and c["runs"] != k3:
            problems.append(f"(d) {opt}: K3 ran {c['runs']} times, not {k3}")
        names = {"Train_Samples_train_loss.csv", "Train_Samples_lr.csv",
                 "Train_Samples_grad_norm.csv",
                 "Train_Registry_train_batch_s_p50.csv"}
        if not names <= set(c["files"]) or \
                c["loss_rows"][0] != "step,Train/Samples/train_loss" or \
                len(c["loss_rows"]) != MLP_STEPS + 1:
            problems.append(f"(d) {opt}: csv files {c['files']} / "
                            f"{c['loss_rows'][:2]}")
    graph_runs["train subset (d) mlp config"] = {
        "fused_adam": generic[("config", True)]["runs"]}
    if problems:
        raise AssertionError("train subset: " + "; ".join(problems))
    return graph_runs, routes


#: the checkpoint phase: engine A takes CKPT_SAVED steps, saves, then
#: CKPT_MORE more; engine B (other weights) takes one step, loads A's save
#: and takes the same CKPT_MORE
CKPT_SAVED, CKPT_MORE = 2, 3
#: the serve from the saved weights: 8 seeded requests on the Llama-400M
CKPT_SERVE = dict(n=8, prompts=(64, 512), new=(16, 32))


def check_checkpoint(cfg=None, device="cuda"):
    """Train -> save -> resume -> serve at full width: Llama-400M (all 24
    layers) at the bench config, captured. Engine A (seed 0) takes
    ``CKPT_SAVED`` steps, saves (``save_checkpoint``: every leaf under the
    JAX ``TrainState``'s names, then the client state, the manifest and
    ``latest``), then ``CKPT_MORE`` more. Engine B (seed 1) takes one step
    (so its graph is captured), loads A's save and takes the same
    ``CKPT_MORE`` steps. Gates: B's losses equal A's bit for bit; the
    global steps, skipped steps and lr equal; every tensor B's graph reads
    keeps its address across the load and B keeps its one graph; K3 runs
    once a replay (counted on the device); right after the load B's
    masters equal ``zero_to_fp32`` of the save exactly. Then B's weights
    go to disk as bf16 (``save_pytree``) and 8 seeded requests are served
    through ``init_inference(checkpoint=...)`` on the captured unified
    engine: the tokens must equal the same engine's fed ``params=`` B's
    weights, every request finish and K6 run once per layer per mixed
    step (counted on the device). Fails, never skips, when the temporary
    directory cannot hold the save. Prints one ``checkpoint {...}`` JSON
    line: state GB, save / manifest / load / verify seconds and the save
    and load rates. Returns the line's dict."""
    import shutil

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.checkpoint import manifest
    from deepspeed_tpu_torch.checkpoint.engine import save_pytree
    from deepspeed_tpu_torch.checkpoint.from_flax import \
        flax_to_torch_state_dict
    from deepspeed_tpu_torch.checkpoint.universal import load_universal, nest
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops import _runs
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint

    cfg = cfg or LlamaConfig.llama_400m(max_position_embeddings=TRAIN_SEQ,
                                        remat=True)
    L = cfg.num_hidden_layers
    rs = np.random.RandomState(7)
    batches = [{"input_ids": ids, "labels": ids} for ids in (
        torch.from_numpy(rs.randint(0, cfg.vocab_size, (
            TRAIN_CONFIG["train_batch_size"], TRAIN_SEQ))).to(device)
        for _ in range(CKPT_SAVED + CKPT_MORE))]

    def engine(seed):
        return dt.initialize(model=LlamaForCausalLM(cfg),
                             config=dict(TRAIN_CONFIG, seed=seed),
                             device=device)[0]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    a = engine(0)
    n_params = sum(p.numel() for p in a.master.values())
    # fp32 masters + two fp32 moments, then the bf16 weights (stored fp32)
    need = 4 * n_params * 4 + (64 << 20)
    tmp = tempfile.mkdtemp(prefix="ds_checkpoint_")
    problems = []
    try:
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise AssertionError(
                f"checkpoint: {tmp} has {free} bytes free; the save and the "
                f"weights need {need}")
        ckpt = os.path.join(tmp, "ckpt")
        losses_a = [a.train_batch(batch=b) for b in batches[:CKPT_SAVED]]
        sync()
        t = time.perf_counter()
        a.save_checkpoint(ckpt)
        save_s = time.perf_counter() - t
        tag = manifest.read_latest_tag(ckpt)
        _, meta = load_universal(os.path.join(ckpt, tag))
        state_bytes = sum(int(np.prod(m["shape"], dtype=np.int64))
                          * np.dtype(m["dtype"]).itemsize
                          for m in meta["leaves"].values())
        # the manifest step alone: inventory and hash the save again
        t = time.perf_counter()
        manifest.write_manifest(ckpt, tag, step=CKPT_SAVED)
        manifest_s = time.perf_counter() - t
        t = time.perf_counter()
        status, detail = manifest.verify_checkpoint(ckpt, tag)
        verify_s = time.perf_counter() - t
        if status != "verified":
            problems.append(f"the save does not verify: {detail}")
        losses_a += [a.train_batch(batch=b) for b in batches[CKPT_SAVED:]]

        b = engine(1)
        b.train_batch(batch=batches[0])
        sync()
        opt = b.optimizer
        held = [opt.count, b._skipped] + list(b.master.values()) + \
            b._grads + opt.exp_avg + opt.exp_avg_sq
        ptrs = [x.data_ptr() for x in held]
        graphs = list(b._graphs.values())
        table = opt.table
        t = time.perf_counter()
        b.load_checkpoint(ckpt)
        sync()
        load_s = time.perf_counter() - t
        in_place = [x.data_ptr() for x in held] == ptrs and \
            opt.table is table and \
            len(b._graphs) == 1 and list(b._graphs.values())[0] is graphs[0]
        z2f = flax_to_torch_state_dict(
            nest(get_fp32_state_dict_from_zero_checkpoint(ckpt)), cfg)
        masters = {n: p.detach().cpu() for n, p in b.master.items()}
        z2f_equal = set(z2f) == set(masters) and all(
            torch.equal(z2f[n], masters[n]) for n in masters)
        del z2f, masters
        if device == "cuda":
            _runs.reset_kernel_runs("fused_adam")
        losses_b = [b.train_batch(batch=x) for x in batches[CKPT_SAVED:]]
        sync()
        k3 = _runs.kernel_runs("fused_adam") if device == "cuda" else None
        want = [float(x) for x in losses_a[CKPT_SAVED:]]
        got = [float(x) for x in losses_b]
        state = [(e.global_steps, e.get_skipped_steps(), e.get_lr())
                 for e in (a, b)]
        if got != want:
            problems.append(f"resumed losses {got} != {want}")
        if state[0] != state[1]:
            problems.append(f"(global steps, skipped, lr) {state[1]} != "
                            f"{state[0]}")
        if not in_place:
            problems.append("the load moved a tensor the graph reads, or "
                            "the engine recaptured")
        if not z2f_equal:
            problems.append("the masters right after the load differ from "
                            "zero_to_fp32 of the save")
        if device == "cuda" and k3 != CKPT_MORE:
            problems.append(f"K3 ran {k3} times in {CKPT_MORE} replays")
        log(f"checkpoint train: llama_400m x{L} layers ({n_params} params), "
            f"A {CKPT_SAVED} steps + save + {CKPT_MORE} steps, B (other "
            f"weights) 1 step + load + {CKPT_MORE} steps: losses A "
            f"{[float(x) for x in losses_a]}, B {got} (bitwise equal: "
            f"{got == want}), (global steps, skipped, lr) A {state[0]} B "
            f"{state[1]}, in place {in_place} (graphs {len(b._graphs)}), "
            f"zero_to_fp32 equal {z2f_equal}, K3 runs in the replays {k3}, "
            f"save {tag} {state_bytes} bytes in {save_s:.3f} s "
            f"({detail})")

        weights = b._consolidated_16bit_state_dict()
        wdir = os.path.join(tmp, "weights")
        t = time.perf_counter()
        save_pytree(wdir, weights)
        weights_s = time.perf_counter() - t
        del a, b, losses_a, losses_b
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        scfg = dict(SERVE_SCFG, max_model_len=TRAIN_SEQ)
        served = {}
        for name, kw in (("params", dict(params=weights)),
                         ("checkpoint", dict(checkpoint=wdir))):
            eng = dt.init_inference(LlamaForCausalLM(cfg),
                                    dtype=torch.bfloat16, device=device,
                                    enable_cuda_graph=True, **kw)
            srv = dt.ServingEngine(eng, dt.ServingConfig(**scfg))
            srv, rids, res, wall, _ = serve(
                cfg, 3, CKPT_SERVE["n"], CKPT_SERVE["prompts"],
                CKPT_SERVE["new"], scfg, torch.bfloat16, device=device,
                srv=srv)
            steps = len(step_widths(srv))
            runs_k6 = _runs.kernel_runs("ragged_paged_attention") \
                if device == "cuda" else None
            served[name] = dict(
                tokens=[(res[r].state, res[r].tokens) for r in rids],
                steps=steps, k6=runs_k6, wall=wall, graphs=len(srv._graphs),
                finished=sum(res[r].state == "finished" for r in rids),
                leaked=srv.block_pool.used_count)
            if device == "cuda" and runs_k6 != L * steps:
                problems.append(f"serve {name}: K6 ran {runs_k6} times, not "
                                f"{L} x {steps} mixed steps")
            if served[name]["finished"] != len(rids) or \
                    served[name]["leaked"]:
                problems.append(f"serve {name}: {served[name]['finished']} "
                                f"of {len(rids)} finished, "
                                f"{served[name]['leaked']} pages leaked")
            del eng, srv
            gc.collect()
        same = served["checkpoint"]["tokens"] == served["params"]["tokens"]
        if not same:
            problems.append("init_inference(checkpoint=) served other tokens "
                            "than params=")
        log(f"checkpoint serve: init_inference(checkpoint=) vs params= on "
            f"the captured unified engine, llama_400m bf16, "
            f"{CKPT_SERVE['n']} requests: tokens identical {same}, "
            + ", ".join(f"{n}: {v['finished']} finished, {v['steps']} mixed "
                        f"steps, K6 runs on the device {v['k6']}, graphs "
                        f"{v['graphs']}, wall {v['wall']:.3f} s"
                        for n, v in served.items())
            + f"; weights written in {weights_s:.3f} s")
        line = {"state_gb": state_bytes / 1e9, "save_s": save_s,
                "save_gb_s": state_bytes / 1e9 / save_s,
                "manifest_s": manifest_s, "load_s": load_s,
                "load_gb_s": state_bytes / 1e9 / load_s,
                "verify_s": verify_s, "weights_save_s": weights_s,
                "resume_bitwise": got == want, "in_place": in_place,
                "k3_replays": k3, "served_identical": same,
                "k6_runs": served["checkpoint"]["k6"],
                "mixed_steps": served["checkpoint"]["steps"]}
        print("checkpoint " + json.dumps(line), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        raise AssertionError("checkpoint: " + "; ".join(problems))
    return line


# ---------------------------------------------------------------------------
# module injection: HF models and HF checkpoint directories
# ---------------------------------------------------------------------------

#: (a)'s Llama-3-8B directory: safetensors shards of at most this many
#: bytes (8 shards of the 16 GB model)
HF_SHARD_BYTES = 2 << 30
#: (a)'s gate on the host's resident set while the directory loads
HF_RSS_LIMIT = 8 << 30
#: (b)'s fp32 tolerance against HF's logits (the CPU tests hold 1e-5; here
#: cuBLAS and HF's SDPA sum in other orders over K up to 14336)
HF_LOGIT_TOL = 1e-4
#: (c) GPT-2 125M serving: the serve phase's engines cut to its 1024
#: positions
GPT2_SCFG = dict(SERVE_SCFG, max_model_len=1024)
GPT2_LEGACY_SCFG = dict(LEGACY_SCFG, max_model_len=1024, prefix_cache=True,
                        prefill_chunk_tokens=PAGED_CHUNK,
                        prefill_token_budget=256)


def _rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class RssPeak:
    """The process's resident set over a block: sampled every 2 ms on a
    thread (``/proc/self/statm``); ``start`` and ``peak`` in bytes."""

    def __enter__(self):
        import threading

        self.start = self.peak = _rss_bytes()
        self._stop = threading.Event()

        def run():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, _rss_bytes())

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())


def write_hf_directory(path, hf_config, params):
    """``params`` (a state_dict under HF's names, on the card) written as
    an HF checkpoint directory: ``config.json`` and sharded safetensors
    (``model-0000i-of-0000n.safetensors`` of at most ``HF_SHARD_BYTES``
    and ``model.safetensors.index.json``), one shard on the host at a
    time. Returns the bytes of weights and the shard count."""
    from safetensors.torch import save_file

    hf_config.save_pretrained(path)
    groups, size = [[]], 0
    for name, t in params.items():
        n = t.numel() * t.element_size()
        if groups[-1] and size + n > HF_SHARD_BYTES:
            groups.append([])
            size = 0
        groups[-1].append(name)
        size += n
    weight_map, total = {}, 0
    for i, names in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        shard = {n: params[n].contiguous().cpu() for n in names}
        total += sum(t.numel() * t.element_size() for t in shard.values())
        save_file(shard, os.path.join(path, fname), metadata={"format": "pt"})
        weight_map.update({n: fname for n in names})
        del shard
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return total, len(groups)


def hf_llama3_8b_config(**over):
    """``transformers.LlamaConfig`` at the serve phase's Llama-3-8B widths
    (``LlamaConfig.llama3_8b``)."""
    import transformers

    return transformers.LlamaConfig(**{**dict(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=8192, rope_theta=500000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False), **over})


def check_hf_checkpoint_dir(serve_tokens, cfg=None, hf_config=None,
                            device="cuda"):
    """(a) Llama-3-8B from an HF checkpoint directory: the serve phase's
    seeded bf16 weights written under HF's names as sharded safetensors in
    a temporary directory, then ``init_inference(checkpoint=dir,
    dtype=bfloat16)`` and the serve phase's unified traffic. Asserts the
    serve phase's uncaptured tokens and finish reasons (``serve_tokens``),
    K6 once per layer per mixed step (wrapper and device counts), no page
    leaked, and the host's resident set while loading under
    ``HF_RSS_LIMIT`` above where it started. Fails (never skips) when the
    temporary directory cannot hold the weights; removes it at the end.
    ``cfg`` / ``hf_config`` (the port's and HF's config of one model) and
    ``device`` default to Llama-3-8B on the card (a CPU rehearsal passes
    small ones). Returns K6's launches."""
    import resource
    import shutil

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    cfg = cfg or LlamaConfig.llama3_8b()
    L = cfg.num_hidden_layers
    params = LlamaForCausalLM(cfg).init_params(seed=0, dtype=torch.bfloat16,
                                               device=device)
    need = sum(t.numel() * t.element_size() for t in params.values())
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    if free < need + (1 << 30):
        raise AssertionError(f"hf inject (a): {tmp} has {free} bytes free, "
                             f"the directory needs {need} + 1 GiB")
    path = tempfile.mkdtemp(prefix="hf_llama3_8b_")
    try:
        t = time.perf_counter()
        nbytes, shards = write_hf_directory(
            path, hf_config or hf_llama3_8b_config(), params)
        write_s = time.perf_counter() - t
        del params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        maxrss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        with RssPeak() as rss:
            t = time.perf_counter()
            engine = dt.init_inference(checkpoint=path, dtype=torch.bfloat16,
                                       device=device)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
        maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        dev_peak = torch.cuda.max_memory_allocated()
        srv, rids, res, wall, launches = serve(
            cfg, 0, 0, None, None, SERVE_SCFG, torch.bfloat16,
            phases=[seeded_traffic(cfg.vocab_size, 0, 16, (64, 1536),
                                   (32, 64))], device=device,
            srv=dt.ServingEngine(engine, dt.ServingConfig(**SERVE_SCFG)))
        runs_k6 = kernel_runs()
        steps = len(step_widths(srv))
        tokens = [(res[r].state, res[r].finish_reason, res[r].tokens)
                  for r in rids]
        generated = sum(len(res[r].tokens) for r in rids)
        log(f"hf inject (a) llama3_8b from an HF directory: "
            f"{type(engine.module).__name__} x{L} layers bf16, {shards} "
            f"safetensors shards, {nbytes / 1e9:.3f} GB written in "
            f"{write_s:.2f} s, loaded in {load_s:.3f} s = "
            f"{nbytes / 1e9 / load_s:.3f} GB/s (warm: the files were just "
            f"written), host resident set {rss.start / 2**30:.2f} GiB -> "
            f"peak {rss.peak / 2**30:.2f} GiB while loading (ru_maxrss "
            f"{maxrss_before / 2**20:.2f} -> {maxrss / 2**20:.2f} GiB), "
            f"device peak {dev_peak / 2**30:.2f} GiB; served "
            f"{len(rids)} requests, {steps} mixed steps, wall {wall:.3f} s, "
            f"{generated / wall:.1f} tok/s, K6 runs on the device "
            f"{runs_k6}, wrapper launches {launches}, tokens identical to "
            f"params=: {tokens == serve_tokens}")
        srv.block_pool.check_consistent()
        problems = []
        if tokens != serve_tokens:
            problems.append("tokens or finish reasons differ from the "
                            "params= serve")
        if srv.block_pool.used_count:
            problems.append(f"{srv.block_pool.used_count} pages leaked")
        k6 = launches["ragged_paged_attention"]
        if runs_k6 != L * steps or k6 != L * steps or \
                sum(launches.values()) != k6:
            problems.append(f"K6 ran {runs_k6} times on the device, wrapper "
                            f"launches {launches}, not {L} x {steps} mixed "
                            f"steps of K6 alone")
        if rss.peak - rss.start > HF_RSS_LIMIT:
            problems.append(f"the host's resident set rose by "
                            f"{(rss.peak - rss.start) / 2**30:.2f} GiB while "
                            f"loading, over {HF_RSS_LIMIT / 2**30:.0f} GiB")
        if problems:
            raise AssertionError("hf inject (a): " + "; ".join(problems))
        return k6
    finally:
        shutil.rmtree(path, ignore_errors=True)


def check_hf_llama_module(hf_config=None, device="cuda"):
    """(b) An HF ``LlamaForCausalLM`` at Llama-3-8B's widths with 2
    layers, fp32, built on the card from seed 0 (or ``hf_config`` on
    ``device``), through ``init_inference(hf_model)``: the port's logits
    against HF's on two seeded 128-token prompts, within ``HF_LOGIT_TOL``
    (absolute and relative)."""
    import transformers

    import deepspeed_tpu_torch as dt

    torch.manual_seed(0)
    hc = hf_config or hf_llama3_8b_config(num_hidden_layers=2)
    with torch.device(device):
        hf = transformers.LlamaForCausalLM(hc).eval()
    engine = dt.init_inference(hf, dtype=torch.float32, device=device)
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, hc.vocab_size, (2, 128))).to(device)
    with torch.no_grad():
        want = hf(ids).logits
    got = engine(ids)
    err = (got - want).abs()
    ok = bool((err <= HF_LOGIT_TOL + HF_LOGIT_TOL * want.abs()).all())
    log(f"hf inject (b) HF LlamaForCausalLM x2 layers at llama3_8b widths, "
        f"fp32, init_inference(hf_model) -> "
        f"{type(engine.module).__name__}: logits {list(got.shape)} max "
        f"|port - HF| {float(err.max()):.3e} (tolerance {HF_LOGIT_TOL:g} "
        f"absolute and relative): ok={ok}")
    if not ok:
        raise AssertionError("hf inject (b): the port's logits differ from "
                             "HF's")
    del hf, engine, want, got, err


def check_hf_gpt2(hf_config=None, device="cuda"):
    """(c) GPT-2 125M: an HF ``GPT2LMHeadModel(GPT2Config())`` built on the
    card from seed 0 through ``init_inference(hf_model)``. fp32 greedy
    tokens of 4 seeded 64-token prompts, 16 new, must equal HF's own
    ``generate``; then generate at the generate phase's shapes (batch 8,
    prompts 128-512 left-padded, 64 new) with bf16 weights, int8 weights
    and bf16 with prefill_flash_from_empty (the converted state_dict bound
    to ``GPT2LMHeadModel`` with the flag), asserting K4, K5 and masked K1
    counts at D 64; then unified serving (the serve phase's 16 requests,
    prompts 64-960, 32-64 new) and two-program serving with the prefix
    cache (4 x 4 requests on 512-token prefixes, suffixes 64-448) on
    1024-position engines: every request finished, no page leaked, K6 /
    K7a / K7b once per layer per forward. ``hf_config`` and ``device``
    default to GPT-2 125M on the card. Returns the launches by run."""
    import transformers

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import GPT2LMHeadModel
    from deepspeed_tpu_torch.module_inject import replace_transformer_layer
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    torch.manual_seed(0)
    with torch.device(device):
        hf = transformers.GPT2LMHeadModel(
            hf_config or transformers.GPT2Config()).eval()
    eos = hf.config.eos_token_id
    L = hf.config.n_layer
    out = {}
    # fp32: HF's own greedy tokens
    engine = dt.init_inference(hf, dtype=torch.float32, device=device)
    ids = np.random.RandomState(6).randint(0, hf.config.vocab_size, (4, 64))
    t = time.perf_counter()
    got = engine.generate(ids, max_new_tokens=16, eos_token_id=eos)
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t
    with torch.no_grad():
        ref = hf.generate(torch.from_numpy(ids).to(device),
                          attention_mask=torch.ones_like(
                              torch.from_numpy(ids)).to(device),
                          max_new_tokens=16, do_sample=False,
                          pad_token_id=eos, eos_token_id=eos)[:, 64:]
    ref = torch.nn.functional.pad(ref, (0, 16 - ref.shape[1]), value=eos)
    same = torch.equal(got.cpu(), ref.cpu())
    log(f"hf inject (c) gpt2_125m fp32 init_inference(hf_model) generate, 4 "
        f"prompts of 64, 16 new: tokens identical to HF's generate: {same} "
        f"({port_s:.3f} s)")
    if not same:
        raise AssertionError("hf inject (c): the fp32 greedy tokens differ "
                             "from HF's generate")
    del engine
    model, sd = replace_transformer_layer(hf)
    del hf
    gen_ids, mask = left_padded_prompts(model.config.vocab_size, GEN_B, 128,
                                        GEN_PROMPT, 0)
    for name, weights, flash in (("bf16", None, False),
                                 ("int8", "int8", False),
                                 ("bf16_flash", None, True)):
        cfg = dataclasses.replace(model.config,
                                  prefill_flash_from_empty=flash)
        engine = dt.init_inference(GPT2LMHeadModel(cfg), params=sd,
                                   dtype=torch.bfloat16, device=device,
                                   quantize_weights=weights)
        tokens, engine, prefill_s, total_s, counts, _, finite = \
            generate_run(None, torch.bfloat16, weights, gen_ids, mask,
                         GEN_NEW, device=device, engine=engine)
        steps = GEN_NEW - 1
        w = 4 * L if weights else 0
        want = (L * steps, w * (steps + 1), L if flash else 0, w, w * steps,
                0, 0, 0)
        decode_ms = 1e3 * (total_s - prefill_s) / steps
        log(f"hf inject (c) gpt2_125m generate {name}: batch {GEN_B}, "
            f"prompts {int(mask.sum(1).min())}-{int(mask.sum(1).max())} "
            f"(bucket {GEN_PROMPT}), {GEN_NEW} new: prefill "
            f"{1e3 * prefill_s:.2f} ms, mean decode step {decode_ms:.3f} ms, "
            f"{GEN_B * GEN_NEW / total_s:.1f} tokens/s, launches K4, K5, "
            f"masked K1, wgmma K5, gemv_tc K5, ragged K5, K8, gemv_tf32 K5 "
            f"{counts} (want {want})")
        if counts != want or not finite or \
                tuple(tokens.shape) != (GEN_B, GEN_NEW):
            raise AssertionError(f"hf inject (c) generate {name}: launches "
                                 f"{counts} != {want}, finite {finite}, "
                                 f"shape {tuple(tokens.shape)}")
        out[f"generate_{name}"] = dict(zip(
            ("decode_attention", "quant_matmul",
             "flash_attention_fwd_masked"), counts[:3]))
        del engine, tokens
        gc.collect()
        torch.cuda.empty_cache()
    engine = dt.init_inference(GPT2LMHeadModel(model.config), params=sd,
                               dtype=torch.bfloat16, device=device)
    vocab = model.config.vocab_size
    for name, scfg, phases in (
            ("unified", GPT2_SCFG,
             [seeded_traffic(vocab, 0, 16, (64, 960), (32, 64))]),
            ("two-program chunked+prefix_cache", GPT2_LEGACY_SCFG,
             shared_prefix_phases(vocab, 4, 4, 512, (64, 448), (32, 64),
                                  0))):
        srv, rids, res, wall, launches = serve(
            None, 0, 0, None, None, scfg, torch.bfloat16, phases=phases,
            device=device,
            srv=dt.ServingEngine(engine, dt.ServingConfig(**scfg)))
        runs_k6 = kernel_runs()
        m = srv.metrics
        finished = sum(res[r].state == "finished" for r in rids)
        ttft = float(np.median([res[r].ttft_s for r in rids]))
        log(f"hf inject (c) gpt2_125m serve {name}: {len(rids)} requests, "
            f"{finished} finished, {m.steps} steps, wall {wall:.3f} s, "
            f"generated {m.tokens_generated} tokens = "
            f"{m.tokens_generated / wall:.1f} tok/s, ttft_p50 {ttft:.3f} s, "
            f"mean step {1e3 * wall / max(m.steps, 1):.2f} ms, prefix hits "
            f"{m.prefix_hits}, preemptions {m.preemptions}, K6 runs on the "
            f"device {runs_k6}, wrapper launches {launches}")
        srv.block_pool.check_consistent()
        if scfg.get("mixed_step", True):
            steps = len([e for e in srv.tracer.events()
                         if e["name"] == "mixed_step"])
            want = {"ragged_paged_attention": L * steps,
                    "paged_decode_attention": 0,
                    "paged_prefill_attention": 0,
                    "flash_attention_fwd_masked": 0}
            device_ok = runs_k6 == L * steps
        else:
            want = {"ragged_paged_attention": 0,
                    "paged_decode_attention": L * srv.decode_calls,
                    "paged_prefill_attention": L * srv.prefill_chunk_calls,
                    "flash_attention_fwd_masked": 0}
            device_ok = srv.decode_calls > 0 and srv.prefill_chunk_calls > 0 \
                and m.prefix_hits >= 12
        if finished != len(rids) or srv.block_pool.used_count or \
                m.logit_quarantines or launches != want or not device_ok:
            raise AssertionError(
                f"hf inject (c) serve {name}: {finished} of {len(rids)} "
                f"finished, {srv.block_pool.used_count} pages leaked, "
                f"{m.logit_quarantines} quarantines, launches {launches} "
                f"(want {want}), K6 device runs {runs_k6}, prefix hits "
                f"{m.prefix_hits}")
        out[f"serve {name}"] = launches
        del srv, res
    del engine, sd, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_hf_inject(serve_tokens):
    """The ``hf inject`` phase: (a) :func:`check_hf_checkpoint_dir`, (b)
    :func:`check_hf_llama_module`, (c) :func:`check_hf_gpt2`. Returns the
    launches of each run by name."""
    launches = {"llama3_8b_from_hf_dir": {
        "ragged_paged_attention": check_hf_checkpoint_dir(serve_tokens)}}
    gc.collect()
    torch.cuda.empty_cache()
    check_hf_llama_module()
    gc.collect()
    torch.cuda.empty_cache()
    launches.update({f"gpt2_{k}": v for k, v in check_hf_gpt2().items()})
    return launches


# ---------------------------------------------------------------------------
# generic families: the generic transformer (models/transformer.py) and
# DeepSpeedTransformerLayer at full width, and the legacy quantization
# ---------------------------------------------------------------------------

#: (a) EleutherAI pythia-6.9b's GPT-NeoX widths
PYTHIA_6_9B = dict(vocab_size=50432, hidden_size=4096,
                   intermediate_size=16384, num_hidden_layers=32,
                   num_attention_heads=32, max_position_embeddings=2048,
                   rotary_pct=0.25, rotary_emb_base=10000,
                   use_parallel_residual=True, layer_norm_eps=1e-5,
                   hidden_act="gelu", tie_word_embeddings=False)
#: (a') EleutherAI gpt-j-6b's widths: 16 heads of 256, rotary on 64 dims
GPTJ_6B = dict(vocab_size=50400, n_embd=4096, n_layer=28, n_head=16,
               rotary_dim=64, n_positions=2048, layer_norm_epsilon=1e-5,
               activation_function="gelu_new", tie_word_embeddings=False)
#: (a') tiiuae falcon-7b's widths: 71 query heads of 64 on one kv head
#: (multi-query), parallel attention, no bias
FALCON_7B = dict(vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
                 num_attention_heads=71, multi_query=True, parallel_attn=True,
                 bias=False, alibi=False, new_decoder_architecture=False,
                 layer_norm_epsilon=1e-5)
#: the Falcon-7B layers (a') runs: all 32 (a smaller count cuts the
#: script's time)
FALCON_LAYERS = 32
#: (b) microsoft/phi-2's widths: 32 heads of 80, rotary on 32 of them
PHI_2 = dict(vocab_size=51200, hidden_size=2560, intermediate_size=10240,
             num_hidden_layers=32, num_attention_heads=32,
             partial_rotary_factor=0.4, max_position_embeddings=2048,
             layer_norm_eps=1e-5)
#: (b) EleutherAI gpt-neox-20b's widths: 64 heads of 96
GPT_NEOX_20B = dict(vocab_size=50432, hidden_size=6144,
                    intermediate_size=24576, num_hidden_layers=44,
                    num_attention_heads=64, max_position_embeddings=2048,
                    rotary_pct=0.25, rotary_emb_base=10000,
                    use_parallel_residual=True, layer_norm_eps=1e-5,
                    hidden_act="gelu", tie_word_embeddings=False)
#: (b) the families' greedy check: prompts, their length, new tokens
FAMILY_PROMPTS, FAMILY_T, FAMILY_NEW = 4, 64, 16
#: (c) BERT-Large (bert-large-uncased's widths) and the phases of the
#: reference's BERT tutorial (batch, sequence)
BERT_LARGE = dict(vocab_size=30522, hidden_size=1024, num_hidden_layers=24,
                  num_attention_heads=16, intermediate_size=4096,
                  max_position_embeddings=512, type_vocab_size=2)
BERT_SHAPES = ((64, 128), (16, 512))
BERT_CONFIG = {"optimizer": {"type": "Lamb",
                             "params": {"lr": 2e-3, "weight_decay": 0.01}},
               "bf16": {"enabled": True}, "gradient_clipping": 1.0,
               "steps_per_print": 0, "seed": 0}
BERT_STEPS, BERT_WARMUP = 5, 2
#: (d) the BERT layer stack of tools/bench_bert_layer.py: hidden,
#: intermediate, heads, layers
BERT_LAYER = (1024, 4096, 16, 24)


def hf_family_configs():
    """(b) Each family at its published widths, 2 layers, by name:
    ``(HF model class, HF config, the widths' source)``."""
    import transformers as tr

    return {
        "opt": (tr.OPTForCausalLM, tr.OPTConfig(
            vocab_size=50272, hidden_size=4096, ffn_dim=16384,
            num_hidden_layers=2, num_attention_heads=32,
            max_position_embeddings=2048, dropout=0.0,
            attention_dropout=0.0), "facebook/opt-6.7b"),
        "bloom": (tr.BloomForCausalLM, tr.BloomConfig(
            vocab_size=250880, hidden_size=4096, n_layer=2, n_head=32,
            hidden_dropout=0.0, attention_dropout=0.0),
            "bigscience/bloom-7b1"),
        "gpt_neox": (tr.GPTNeoXForCausalLM, tr.GPTNeoXConfig(
            **dict(PYTHIA_6_9B, num_hidden_layers=2),
            attention_dropout=0.0, hidden_dropout=0.0),
            "EleutherAI/pythia-6.9b"),
        "bert": (tr.BertForMaskedLM, tr.BertConfig(
            **dict(BERT_LARGE, num_hidden_layers=2),
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
            "bert-large-uncased"),
        "gpt_neo": (tr.GPTNeoForCausalLM, tr.GPTNeoConfig(
            vocab_size=50257, hidden_size=2560, num_layers=2, num_heads=20,
            attention_types=[[["global", "local"], 1]], window_size=256,
            max_position_embeddings=2048, resid_dropout=0.0,
            embed_dropout=0.0, attention_dropout=0.0),
            "EleutherAI/gpt-neo-2.7B"),
        "gptj": (tr.GPTJForCausalLM, tr.GPTJConfig(
            **dict(GPTJ_6B, n_layer=2), resid_pdrop=0.0, embd_pdrop=0.0,
            attn_pdrop=0.0), "EleutherAI/gpt-j-6b"),
        "phi": (tr.PhiForCausalLM, tr.PhiConfig(
            **dict(PHI_2, num_hidden_layers=2), attention_dropout=0.0,
            resid_pdrop=0.0, embd_pdrop=0.0), "microsoft/phi-2"),
        "falcon": (tr.FalconForCausalLM, tr.FalconConfig(
            **dict(FALCON_7B, num_hidden_layers=2), attention_dropout=0.0,
            hidden_dropout=0.0), "tiiuae/falcon-7b"),
        "gpt_neox_20b": (tr.GPTNeoXForCausalLM, tr.GPTNeoXConfig(
            **dict(GPT_NEOX_20B, num_hidden_layers=2),
            attention_dropout=0.0, hidden_dropout=0.0),
            "EleutherAI/gpt-neox-20b"),
    }


def generic_kernels():
    """The wrappers the generic paths run, by name: K1 (forward, masked
    forward), K2, K3 and K4."""
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention

    return dict(train_kernels(), decode_attention=decode_attention,
                flash_attention_fwd_masked=serving_kernels()[
                    "flash_attention_fwd_masked"])


def zero_generic_launches():
    for fn in generic_kernels().values():
        fn.launches = 0


def generic_launches():
    return {n: fn.launches for n, fn in generic_kernels().items()}


#: (a) Pythia-6.9B's last-position prefill logits (bf16, about 1.0 in
#: standard deviation on seeded weights) through the masked K1 against the
#: plain cached attention: the two round at other points in each of the 32
#: layers (0.0625 apart at most on an H100); a wrong mask, head or group
#: mapping moves them by the logits' own scale
PYTHIA_PREFILL_LOGIT_TOL = 0.125


def prefill_logits(engine, ids, mask):
    """``generate``'s prefill on ``engine`` (the prompts left-padded to the
    generate phase's bucket, a cache of ``GEN_PROMPT + GEN_NEW`` from
    empty, positions from the mask, as ``generate`` runs it): the last
    position's logits, fp32 ``[B, V]``."""
    pad = GEN_PROMPT - ids.shape[1]
    ids_t = torch.nn.functional.pad(torch.as_tensor(ids, device="cuda"),
                                    (pad, 0))
    mask_t = torch.nn.functional.pad(torch.as_tensor(
        mask, dtype=torch.int32, device="cuda"), (pad, 0))
    B, S = ids_t.shape[0], GEN_PROMPT + GEN_NEW
    key_mask = torch.zeros((B, S), dtype=torch.int32, device="cuda")
    key_mask[:, :GEN_PROMPT] = mask_t
    with torch.inference_mode():
        cache = engine.module.init_cache(B, S, dtype=torch.bfloat16,
                                         device="cuda")
        logits, _ = engine.module(
            ids_t, cache=cache,
            cache_index=torch.zeros((), dtype=torch.int32, device="cuda"),
            positions=(mask_t.cumsum(dim=-1) - 1).clamp_min(0),
            attention_mask=key_mask)
    return logits[:, -1].float()


#: (a') GPT-J-6B's and Falcon-7B's flash prefill logits against the plain
#: prefill's, in units of the plain logits' standard deviation: reasoned as
#: PYTHIA_PREFILL_LOGIT_TOL (each layer rounds at other points in the two
#: prefills; Pythia's 32 layers part by at most 0.0625 of a unit-std logit
#: on an H100), and a wrong mask, head or group mapping moves the logits
#: by their own scale
GENERIC_PREFILL_LOGIT_TOL = 0.125


def check_pythia_generate():
    """(a) Pythia-6.9B (the port's ``TransformerLMHeadModel`` built by
    ``HFGPTNeoXLayerPolicy`` from the HF config; bf16 weights from seed 0)
    through ``generate``: :func:`check_generic_generate`, with the flash
    prefill's logits within ``PYTHIA_PREFILL_LOGIT_TOL``."""
    import transformers

    from deepspeed_tpu_torch.module_inject.replace_policy import \
        HFGPTNeoXLayerPolicy

    return check_generic_generate(
        "pythia-6.9b", HFGPTNeoXLayerPolicy,
        transformers.GPTNeoXConfig(**PYTHIA_6_9B),
        lambda cfg: (cfg.head_dim, cfg.rotary_dim, cfg.rope_theta,
                     cfg.parallel_residual, cfg.tie_word_embeddings)
        == (128, 32, 10000.0, True, False),
        PYTHIA_PREFILL_LOGIT_TOL, relative=False)


def check_gptj_falcon_generate():
    """(a') GPT-J-6B at full width and depth (16 heads of 256: K4 and the
    masked K1 at D 256) and Falcon-7B at full width, ``FALCON_LAYERS``
    layers (71 query heads on one kv head: K4's multi-tile kernel,
    the masked K1 at a group of 71), each through
    :func:`check_generic_generate` with the flash prefill's logits within
    ``GENERIC_PREFILL_LOGIT_TOL`` of the plain logits' std. Returns the
    launches and decode ms by model and run."""
    import transformers

    from deepspeed_tpu_torch.module_inject.replace_policy import (
        HFFalconLayerPolicy, HFGPTJLayerPolicy)

    out = {}
    out["gptj_6b"] = check_generic_generate(
        "gpt-j-6b", HFGPTJLayerPolicy, transformers.GPTJConfig(**GPTJ_6B),
        lambda cfg: (cfg.head_dim, cfg.kv_heads, cfg.rotary_dim,
                     cfg.num_hidden_layers) == (256, 16, 64, 28),
        GENERIC_PREFILL_LOGIT_TOL, relative=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["falcon_7b"] = check_generic_generate(
        "falcon-7b", HFFalconLayerPolicy, transformers.FalconConfig(
            **dict(FALCON_7B, num_hidden_layers=FALCON_LAYERS)),
        lambda cfg: (cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads,
                     cfg.hidden_size) == (64, 71, 1, 4544),
        GENERIC_PREFILL_LOGIT_TOL, relative=True)
    return out


def check_generic_generate(label, policy, hc, config_ok, tol, relative):
    """A generic decoder (the port's ``TransformerLMHeadModel`` built by
    ``policy`` from the HF config ``hc``; bf16 weights from seed 0)
    through ``generate`` at the generate phase's shapes: uncaptured, with
    the decode step captured, and with ``prefill_flash_from_empty``.
    Asserts that ``config_ok(cfg)``, K4 L x 63 and (flagged) the masked K1
    L in the counted runs, the captured run's tokens equal to the
    uncaptured run's, finite logits, and the flash run's prefill logits
    (:func:`prefill_logits`, run after the counted ``generate``) within
    ``tol`` (times the plain logits' std when ``relative``) of the plain
    run's, its first tokens the plain run's in every row whose top-2 gap
    there is wider than twice the tolerance (bf16: the two prefills round
    at other points, so the tokens may part at a near tie). Returns the
    launches and the decode-step ms by run."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.transformer import TransformerLMHeadModel

    model = policy.build(hc)
    cfg = model.config
    L = cfg.num_hidden_layers
    if not config_ok(cfg):
        raise AssertionError(f"generic {label}: the policy's config is not "
                             f"the published one: {cfg}")
    t = time.perf_counter()
    params = model.init_params(seed=0, dtype=torch.bfloat16, device="cuda")
    n_params = sum(p.numel() for p in params.values())
    init_s = time.perf_counter() - t
    ids, mask = left_padded_prompts(cfg.vocab_size, GEN_B, 128, GEN_PROMPT,
                                    0)
    tokens, launches, decode, prefill = {}, {}, {}, {}
    for name, flash, graph in (("bf16", False, False),
                               ("bf16_graph", False, True),
                               ("bf16_flash", True, False)):
        run_cfg = dataclasses.replace(cfg, prefill_flash_from_empty=flash)
        engine = dt.init_inference(TransformerLMHeadModel(run_cfg),
                                   params=params, dtype=torch.bfloat16,
                                   device="cuda", enable_cuda_graph=graph)
        out, engine, prefill_s, total_s, counts, capture, finite = \
            generate_run(None, torch.bfloat16, None, ids, mask, GEN_NEW,
                         engine=engine)
        k4, k1m = counts[0], counts[2]
        decode[name] = 1e3 * (total_s - prefill_s) / (GEN_NEW - 1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tokens[name] = out.cpu()
        steps = 0 if graph else GEN_NEW - 1
        want = (L * steps, L if flash else 0)
        same = torch.equal(tokens[name], tokens["bf16"])
        log(f"generic (a) {label} x{L} layers ({cfg.num_attention_heads} "
            f"heads of {cfg.head_dim}, {cfg.kv_heads} kv heads, "
            f"{n_params / 1e9:.2f} B params, bf16, init {init_s:.1f} s) "
            f"generate {name}: batch "
            f"{GEN_B}, prompts {int(mask.sum(1).min())}-"
            f"{int(mask.sum(1).max())} (bucket {GEN_PROMPT}), {GEN_NEW} new: "
            f"prefill {1e3 * prefill_s:.2f} ms, mean decode step "
            f"{decode[name]:.3f} ms, total {1e3 * total_s:.2f} ms = "
            f"{GEN_B * GEN_NEW / total_s:.1f} tokens/s, peak memory "
            f"{peak:.1f} GiB, launches K4 {k4} masked K1 {k1m} (want "
            f"{want}){' capturing warm-up ' + str(capture[:3]) if graph else ''}"
            f", tokens as the uncaptured run's: {same}")
        problems = []
        if (k4, k1m) != want:
            problems.append(f"launches K4, masked K1 {(k4, k1m)} != {want}")
        if graph and capture[:3] != (2 * L, 0, 0):
            problems.append(f"capturing warm-up {capture[:3]}")
        if not finite or tuple(out.shape) != (GEN_B, GEN_NEW):
            problems.append("a logit is not finite or the shape is wrong")
        if graph and not same:
            problems.append("the captured run's tokens differ from the "
                            "uncaptured run's")
        if problems:
            raise AssertionError(f"generic (a) {label} {name}: "
                                 + "; ".join(problems))
        launches[name] = {"decode_attention": k4,
                          "flash_attention_fwd_masked": k1m}
        if not graph:
            prefill[name] = prefill_logits(engine, ids, mask)
        del engine, out
        gc.collect()
        torch.cuda.empty_cache()
    rows = int((tokens["bf16_flash"] == tokens["bf16"]).all(1).sum())
    plain, flash = prefill["bf16"], prefill["bf16_flash"]
    err = (flash - plain).abs()
    std = float(plain.std())
    bound = tol * std if relative else tol
    top2 = plain.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    first_differs = tokens["bf16_flash"][:, 0] != tokens["bf16"][:, 0]
    untied = gap.cpu() > 2 * bound
    log(f"generic (a) {label}: prefill logits flash vs plain max |err| "
        f"{float(err.max()):.4f} mean {float(err.mean()):.3e} (tolerance "
        f"{bound:.4g}{f' = {tol:g} x std' if relative else ''}; plain "
        f"logits std {std:.3f}, top-2 gaps "
        f"{[round(float(x), 4) for x in gap]}); first tokens differ in rows "
        f"{first_differs.nonzero().flatten().tolist()}; the flash run's "
        f"tokens equal the plain run's in {rows} of {GEN_B} rows; decode "
        f"step uncaptured {decode['bf16']:.3f} ms, captured "
        f"{decode['bf16_graph']:.3f} ms")
    if not bool(torch.isfinite(flash).all()) or \
            float(err.max()) > bound or \
            bool((first_differs & untied).any()):
        raise AssertionError(
            f"generic (a) {label}: the flash prefill's logits are "
            f"{float(err.max())} from the plain prefill's (tolerance "
            f"{bound}) or a first token differs where the plain top-2 gap "
            f"is wider than twice that")
    del params
    return launches, decode


def check_generic_families():
    """(b) Each family of ``hf_family_configs``: an HF model (2 layers,
    fp32, seed 0, built on the card) through ``init_inference(hf_model)``:
    logits of 2 seeded 128-token prompts within ``HF_LOGIT_TOL`` of HF's
    (BERT's MLM logits with a padding mask and token types), and for the
    causal families fp32 greedy tokens of ``FAMILY_PROMPTS`` prompts of
    ``FAMILY_T`` equal to HF's ``generate`` (``FAMILY_NEW`` new); K4 ran
    once per layer per decode step where the config is eligible (no ALiBi,
    no ``attention_layers``) and never elsewhere. Returns K4's launches by
    family."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention

    out = {}
    for name, (cls, hc, source) in hf_family_configs().items():
        torch.manual_seed(0)
        t = time.perf_counter()
        with torch.device("cuda"):
            hf = cls(hc).eval()
        engine = dt.init_inference(hf, dtype=torch.float32, device="cuda")
        cfg = engine.module.config
        build_s = time.perf_counter() - t
        rs = np.random.RandomState(8)
        ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 128))).cuda()
        kw = {}
        if not cfg.causal:
            mask = torch.ones_like(ids)
            mask[1, 100:] = 0
            kw = dict(attention_mask=mask,
                      token_type_ids=(torch.arange(128, device="cuda")
                                      >= 64).long().expand(2, 128))
        with torch.no_grad():
            want = hf(ids, **kw).logits
        got = engine(ids, **kw)
        err = (got - want).abs()
        ok = bool((err <= HF_LOGIT_TOL + HF_LOGIT_TOL * want.abs()).all())
        line = (f"generic (b) {name} ({source}; {cfg.num_attention_heads} "
                f"heads of {cfg.head_dim}, {cfg.kv_heads} kv heads, x2 "
                f"layers, fp32, built in {build_s:.1f} s) -> "
                f"{type(engine.module).__name__}: logits max |port - HF| "
                f"{float(err.max()):.3e} (tolerance {HF_LOGIT_TOL:g})")
        problems = [] if ok else ["logits"]
        if cfg.causal:
            eos = hf.generation_config.eos_token_id
            eos = eos[0] if isinstance(eos, list) else eos
            gen = rs.randint(0, cfg.vocab_size, (FAMILY_PROMPTS, FAMILY_T))
            decode_attention.launches = 0
            got_tokens = engine.generate(gen, max_new_tokens=FAMILY_NEW,
                                         eos_token_id=eos).cpu()
            k4 = decode_attention.launches
            with torch.no_grad():
                ref = hf.generate(
                    torch.from_numpy(gen).cuda(),
                    attention_mask=torch.ones((FAMILY_PROMPTS, FAMILY_T),
                                              dtype=torch.long,
                                              device="cuda"),
                    max_new_tokens=FAMILY_NEW, do_sample=False,
                    pad_token_id=eos, eos_token_id=eos)[:, FAMILY_T:].cpu()
            ref = torch.nn.functional.pad(
                ref, (0, FAMILY_NEW - ref.shape[1]),
                value=-1 if eos is None else eos)
            same = torch.equal(got_tokens, ref)
            eligible = cfg.pallas_decode_eligible(1)
            want_k4 = cfg.num_hidden_layers * (FAMILY_NEW - 1) \
                if eligible else 0
            line += (f"; greedy tokens of {FAMILY_PROMPTS} prompts of "
                     f"{FAMILY_T}, {FAMILY_NEW} new, equal to HF's generate: "
                     f"{same}; K4 {k4} (eligible {eligible}, want {want_k4})")
            if not same:
                problems.append("greedy tokens")
            if k4 != want_k4:
                problems.append(f"K4 launches {k4} != {want_k4}")
            out[name] = k4
        log(line)
        if problems:
            raise AssertionError(f"generic (b) {name}: " + ", ".join(problems))
        del hf, engine, want, got, err
        gc.collect()
        torch.cuda.empty_cache()
    return out


def bert_batch(cfg, batch, seq, seed, padded):
    """A BERT MLM batch: seeded ids, 15% of the positions labelled (the
    others -100), token types 0 then 1; ``padded`` right-pads each row
    by a seeded 0-``seq / 2`` tokens (their labels -100) and adds the
    ``attention_mask``."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1000, cfg.vocab_size, (batch, seq))
    labels = np.where(rs.rand(batch, seq) < 0.15, ids, -100)
    types = (np.arange(seq)[None] >= seq // 2).repeat(batch, 0)
    out = {"input_ids": ids, "token_type_ids": types.astype(np.int64)}
    if padded:
        mask = np.ones((batch, seq), np.int64)
        for b, pad in enumerate(rs.randint(0, seq // 2 + 1, batch)):
            mask[b, seq - pad:] = 0
        labels[mask == 0] = -100
        out["attention_mask"] = mask
    out["labels"] = labels
    return {k: torch.from_numpy(v).cuda() for k, v in out.items()}


def mlm_loss(module, batch, generator):
    """BERT's MLM loss: the token-mean cross entropy over labelled
    positions; dropout (when the config has it) in training mode."""
    from deepspeed_tpu_torch.models.layers import cross_entropy_loss

    logits = module(batch["input_ids"], batch.get("attention_mask"),
                    batch["token_type_ids"],
                    deterministic=module.config.attn_dropout == 0 and
                    module.config.hidden_dropout == 0)
    return cross_entropy_loss(logits, batch["labels"]), ()


def check_bert_training():
    """(c) BERT-Large MLM (``TransformerForMaskedLM`` from
    ``HFBertLayerPolicy``'s config; seed 0) on LAMB (K3), bf16, clipping
    1.0, at the BERT tutorial's phase-1 and phase-2 shapes: unpadded with
    dropout 0 (the non-causal K1/K2), uncaptured and captured, each
    ``BERT_WARMUP`` + ``BERT_STEPS`` steps on one batch; then right-padded
    batches with BERT's dropouts 0.1 (the plain attention), uncaptured.
    Asserts finite falling losses, captured losses equal to uncaptured,
    and per step K1 24, K2 24 + 24 (never under padding) and K3 once,
    counted on the device. Prints step ms, samples/s, model TFLOP/s and
    peak memory. Returns the wrappers' launches of each uncaptured run."""
    import transformers

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.transformer import TransformerForMaskedLM
    from deepspeed_tpu_torch.module_inject.replace_policy import \
        HFBertLayerPolicy

    cfg = HFBertLayerPolicy.convert_config(
        transformers.BertConfig(**BERT_LARGE))
    L, Hd = cfg.num_hidden_layers, cfg.hidden_size
    names = list(train_kernels())
    out = {}
    runs = [(f"{b}x{s}_{'captured' if graphed else 'uncaptured'}", b, s,
             False, graphed) for b, s in BERT_SHAPES
            for graphed in (False, True)]
    runs.append((f"{BERT_SHAPES[0][0]}x{BERT_SHAPES[0][1]}_padded_dropout",
                 BERT_SHAPES[0][0], BERT_SHAPES[0][1], True, False))
    losses = {}
    for name, B, S, padded, graphed in runs:
        run_cfg = dataclasses.replace(cfg, attn_dropout=0.1,
                                      hidden_dropout=0.1) if padded else cfg
        base = memory_base("cuda")
        engine, *_ = dt.initialize(
            model=TransformerForMaskedLM(run_cfg),
            config=dict(BERT_CONFIG, train_batch_size=B), loss_fn=mlm_loss,
            device="cuda", cuda_graph=graphed)
        n_params = sum(p.numel() for p in engine.master.values())
        batch = bert_batch(cfg, B, S, seed=S, padded=padded)
        ls = [engine.train_batch(batch=batch) for _ in range(BERT_WARMUP)]
        torch.cuda.synchronize()
        zero_generic_launches()
        reset_device_runs(names)
        t = time.perf_counter()
        ls += [engine.train_batch(batch=batch) for _ in range(BERT_STEPS)]
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t) / BERT_STEPS
        runs_dev = {n: v / BERT_STEPS for n, v in device_runs(names).items()}
        wrappers = {n: generic_launches()[n] for n in names}
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        ls = [float(x) for x in ls]
        losses[name] = ls
        flops = model_flops_per_step(n_params, B, S, L, Hd)
        want = {"flash_attention_fwd": 0 if padded else L,
                "flash_attention_bwd_dq": 0 if padded else L,
                "flash_attention_bwd_dkv": 0 if padded else L,
                "fused_adam": 1}
        log(f"generic (c) bert-large MLM {name} ("
            f"{n_params / 1e6:.1f} M params, LAMB, bf16, clip 1.0, dropout "
            f"{run_cfg.hidden_dropout}): step {1e3 * step_s:.2f} ms, "
            f"{B / step_s:.1f} samples/s, model "
            f"{flops / step_s / 1e12:.1f} TFLOP/s, peak memory {peak:.2f} "
            f"GiB, losses {[round(x, 4) for x in ls]}, device runs a step "
            f"{runs_dev} (want {want})")
        problems = []
        if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
            problems.append("losses not finite and falling")
        if runs_dev != want:
            problems.append(f"device runs a step {runs_dev} != {want}")
        if graphed and ls != losses[name.replace("captured",
                                                 "uncaptured")]:
            problems.append("captured losses differ from uncaptured ones")
        if problems:
            raise AssertionError(f"generic (c) {name}: " + "; ".join(problems))
        if not graphed:
            out[name] = wrappers
        del engine, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


#: (f) the causal training runs at the new head dims: batch, sequence,
#: the AdamW config, warm-up and timed steps
CAUSAL_TRAIN_SHAPE = (4, 1024)
CAUSAL_TRAIN_CONFIG = {"optimizer": {"type": "AdamW",
                                     "params": {"lr": 1e-4,
                                                "weight_decay": 0.01}},
                       "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                       "steps_per_print": 0, "seed": 0}
CAUSAL_TRAIN_STEPS, CAUSAL_TRAIN_WARMUP = 3, 2


def check_causal_training():
    """(f) The generic decoder at Phi-2's widths (32 heads of 80) and at
    GPT-J-6B's (16 heads of 256), 2 layers each (the policies' configs,
    seed 0), AdamW, bf16, clipping 1.0, ``CAUSAL_TRAIN_SHAPE``: uncaptured
    and captured, each ``CAUSAL_TRAIN_WARMUP`` + ``CAUSAL_TRAIN_STEPS``
    steps on one batch. Asserts finite falling losses, captured losses
    equal to uncaptured, and per step K1 2, K2 2 + 2 and K3 once, counted
    on the device (the D 256 dK/dV call's two passes count once). Prints
    step ms, model TFLOP/s and peak memory. Returns the wrappers' launches
    of each uncaptured run."""
    import transformers

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.transformer import TransformerLMHeadModel
    from deepspeed_tpu_torch.module_inject.replace_policy import (
        HFGPTJLayerPolicy, HFPhiLayerPolicy)

    models = {
        "phi2_d80": HFPhiLayerPolicy.convert_config(transformers.PhiConfig(
            **dict(PHI_2, num_hidden_layers=2))),
        "gptj_d256": HFGPTJLayerPolicy.convert_config(
            transformers.GPTJConfig(**dict(GPTJ_6B, n_layer=2))),
    }
    names = list(train_kernels())
    B, S = CAUSAL_TRAIN_SHAPE
    out, losses = {}, {}
    for model_name, cfg in models.items():
        L, Hd = cfg.num_hidden_layers, cfg.hidden_size
        ids = np.random.RandomState(S).randint(0, cfg.vocab_size, (B, S))
        batch = {"input_ids": ids, "labels": ids}
        for graphed in (False, True):
            name = f"{model_name}_{'captured' if graphed else 'uncaptured'}"
            base = memory_base("cuda")
            engine, *_ = dt.initialize(
                model=TransformerLMHeadModel(cfg),
                config=dict(CAUSAL_TRAIN_CONFIG, train_batch_size=B),
                device="cuda", cuda_graph=graphed)
            n_params = sum(p.numel() for p in engine.master.values())
            ls = [engine.train_batch(batch=batch)
                  for _ in range(CAUSAL_TRAIN_WARMUP)]
            torch.cuda.synchronize()
            zero_generic_launches()
            reset_device_runs(names)
            t = time.perf_counter()
            ls += [engine.train_batch(batch=batch)
                   for _ in range(CAUSAL_TRAIN_STEPS)]
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t) / CAUSAL_TRAIN_STEPS
            runs_dev = {n: v / CAUSAL_TRAIN_STEPS
                        for n, v in device_runs(names).items()}
            wrappers = {n: generic_launches()[n] for n in names}
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            ls = [float(x) for x in ls]
            losses[name] = ls
            flops = model_flops_per_step(n_params, B, S, L, Hd)
            want = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                    "flash_attention_bwd_dkv": L, "fused_adam": 1}
            log(f"generic (f) causal train {name} ({cfg.num_attention_heads}"
                f" heads of {cfg.head_dim}, x{L} layers, "
                f"{n_params / 1e6:.1f} M params, AdamW, bf16, clip 1.0, "
                f"{B} x {S}): step {1e3 * step_s:.2f} ms, model "
                f"{flops / step_s / 1e12:.1f} TFLOP/s, peak memory "
                f"{peak:.2f} GiB, losses {[round(x, 4) for x in ls]}, device "
                f"runs a step {runs_dev} (want {want})")
            problems = []
            if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
                problems.append("losses not finite and falling")
            if runs_dev != want:
                problems.append(f"device runs a step {runs_dev} != {want}")
            if graphed and ls != losses[name.replace("captured",
                                                     "uncaptured")]:
                problems.append("captured losses differ from uncaptured ones")
            if problems:
                raise AssertionError(f"generic (f) {name}: "
                                     + "; ".join(problems))
            if not graphed:
                out[name] = wrappers
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    return out


def check_bert_layer():
    """(d) The twin of the JAX package's ``tools/bench_bert_layer.py``: 24
    ``DeepSpeedTransformerLayer``s at BERT-Large's shape (pre-LN,
    ``fp16=True``: bf16 compute), forward and forward + backward (loss
    ``sum(out ** 2)``) at (seq 128, batch 64) and (seq 512, batch 16), with
    the bench's all-ones ``[B, S]`` mask (the plain attention, as the JAX
    layer's biased attention takes XLA) and without a mask (the non-causal
    K1/K2). TFLOP/s from the bench's FLOP count; one ``bert layer {...}``
    JSON line per point."""
    from deepspeed_tpu_torch.ops import (DeepSpeedTransformerConfig,
                                         DeepSpeedTransformerLayer)

    Hd, inter, heads, L = BERT_LAYER
    smi = nvidia_smi()
    for B, S in BERT_SHAPES:
        cfg = DeepSpeedTransformerConfig(batch_size=B, hidden_size=Hd,
                                         intermediate_size=inter,
                                         heads=heads, num_hidden_layers=L,
                                         fp16=True, pre_layer_norm=True)
        layers = [DeepSpeedTransformerLayer(dataclasses.replace(cfg, seed=i),
                                            device="cuda") for i in range(L)]
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(B, S, Hd, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        for masked in (True, False):
            mask = torch.ones((B, S), dtype=torch.int32, device="cuda") \
                if masked else None

            def stack():
                h = x
                for layer in layers:
                    h = layer(h, mask)
                return h

            def fwdbwd():
                loss = (stack().float() ** 2).sum()
                loss.backward()

            with torch.no_grad():
                fwd_ms = cuda_time_ms(stack, reps=5, warmup=2)
            zero_generic_launches()
            fwdbwd()
            k1 = generic_launches()["flash_attention_fwd"]
            fb_ms = cuda_time_ms(fwdbwd, reps=5, warmup=1)
            p_layer = 4 * Hd * Hd + 2 * Hd * inter
            fb_flops = 6.0 * p_layer * L * B * S + 12.0 * L * B * S * S * Hd
            rec = {"batch": B, "seq": S, "layers": L, "hidden": Hd,
                   "mask": masked, "fwd_ms": fwd_ms, "fwdbwd_ms": fb_ms,
                   "fwd_tflops": fb_flops / 3 / fwd_ms / 1e9,
                   "fwdbwd_tflops": fb_flops / fb_ms / 1e9,
                   "samples_per_sec": B / fb_ms * 1e3,
                   "k1_launches_fwdbwd": k1, "device": smi}
            print("bert layer " + json.dumps(rec), flush=True)
            if k1 != (0 if masked else L):
                raise AssertionError(f"generic (d) bert layer B {B} S {S} "
                                     f"mask {masked}: K1 launched {k1}")
            for layer in layers:
                layer.zero_grad(set_to_none=True)
        del layers, x
        gc.collect()
        torch.cuda.empty_cache()


def legacy_quant_engine_runs(engine, label, ids, mask, L, cfg):
    """(e) On one inference engine: ``generate`` at the generate phase's
    shapes (with and without ``dequant_per_step`` when the engine is
    quantized, each uncaptured and captured), the unified engine captured
    and the two-program engine on the serve phase's 16 requests. Returns
    the tokens, the decode-step ms, the mean steps and the peak memory by
    run."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    tokens, ms, peaks = {}, {}, {}
    per_step = (False, True) if engine.config.quantize else (False,)
    for dps in per_step:
        for graph in (False, True):
            run = f"generate{'_per_step' if dps else ''}" \
                f"{'_graph' if graph else ''}"
            engine.config.dequant_per_step = dps
            engine.config.enable_cuda_graph = graph
            engine._decode_graphs.clear()
            out, _, prefill_s, total_s, counts, _, finite = generate_run(
                None, torch.bfloat16, None, ids, mask, GEN_NEW,
                engine=engine)
            ms[run] = 1e3 * (total_s - prefill_s) / (GEN_NEW - 1)
            peaks[run] = torch.cuda.max_memory_allocated() / 2 ** 30
            tokens[run] = out.cpu()
            want = 0 if graph else L * (GEN_NEW - 1)
            log(f"generic (e) llama3_8b {label} {run}: mean decode step "
                f"{ms[run]:.3f} ms, prefill {1e3 * prefill_s:.2f} ms, peak "
                f"memory {peaks[run]:.1f} GiB, K4 {counts[0]} (want {want})")
            if counts[0] != want or not finite:
                raise AssertionError(f"generic (e) {label} {run}: K4 "
                                     f"{counts[0]} != {want} or a logit is "
                                     f"not finite")
    engine._decode_graphs.clear()
    traffic = [seeded_traffic(cfg.vocab_size, 0, 16, (64, 1536), (32, 64))]
    for kind, graph, scfg in (
            ("serve_unified_captured", True, SERVE_SCFG),
            ("serve_two_program", False,
             dict(LEGACY_SCFG, prefix_cache=True,
                  prefill_chunk_tokens=PAGED_CHUNK,
                  prefill_token_budget=256))):
        engine.config.enable_cuda_graph = graph
        torch.cuda.reset_peak_memory_stats()
        srv = dt.ServingEngine(engine, dt.ServingConfig(**scfg))
        srv, rids, res, wall, launches = serve(
            cfg, 0, 0, None, None, scfg, torch.bfloat16, phases=traffic,
            srv=srv)
        tokens[kind] = [(res[r].state, res[r].tokens) for r in rids]
        m = srv.metrics
        ms[kind] = 1e3 * wall / max(m.steps, 1)
        peaks[kind] = torch.cuda.max_memory_allocated() / 2 ** 30
        finished = sum(res[r].state == "finished" for r in rids)
        if graph:
            got = {"ragged_paged_attention": kernel_runs()}
            want = {"ragged_paged_attention": L * m.steps}
        else:
            got = {n: launches[n] for n in ("paged_decode_attention",
                                            "paged_prefill_attention")}
            want = {"paged_decode_attention": L * srv.decode_calls,
                    "paged_prefill_attention": L * srv.prefill_chunk_calls}
        log(f"generic (e) llama3_8b {label} {kind}: {len(rids)} requests, "
            f"{finished} finished, {m.steps} steps, mean step "
            f"{ms[kind]:.2f} ms, {m.tokens_generated / wall:.1f} tok/s, "
            f"peak memory {peaks[kind]:.1f} GiB, kernels {got} (want "
            f"{want}), pages in use {srv.block_pool.used_count}")
        srv.block_pool.check_consistent()
        if finished != len(rids) or got != want or \
                srv.block_pool.used_count:
            raise AssertionError(f"generic (e) {label} {kind}: unfinished "
                                 f"requests, kernels {got} != {want} or "
                                 f"leaked pages")
        del srv, res
        gc.collect()
        torch.cuda.empty_cache()
    engine.config.enable_cuda_graph = False
    return tokens, ms, peaks


def check_legacy_quant():
    """(e) The legacy grouped quantization on Llama-3-8B (the serve and
    generate phases' weights, seed 0, bf16): ``init_inference(quantize=
    True)`` (32 groups a leaf, bound dequantized into bf16 at init),
    then a bf16 engine on ``dequantize_params(quantize_params(w))`` (the
    same codes dequantized once, written into the weights in the JAX
    leaves' layout), each through :func:`legacy_quant_engine_runs`: every
    quantized run's tokens must equal the bf16 engine's. Prints the peak
    device memory and the mean step of each beside the other's."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.checkpoint.from_flax import flax_leaves
    from deepspeed_tpu_torch.compression.quantization import (dequantize,
                                                              quantize_leaf)
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama3_8b()
    L = cfg.num_hidden_layers
    ids, mask = left_padded_prompts(cfg.vocab_size, GEN_B, 128, GEN_PROMPT, 0)
    params = LlamaForCausalLM(cfg).init_params(seed=0, dtype=torch.bfloat16,
                                               device="cuda")
    t = time.perf_counter()
    engine = dt.init_inference(LlamaForCausalLM(cfg), params=params,
                               dtype=torch.bfloat16, device="cuda",
                               quantize=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t
    # the reference weights, dequantize_params(quantize_params(w)), made
    # in place in w (the quantized engine holds its own copy) through the
    # JAX formula q * scale + zero, leaf by leaf in the JAX layout
    with torch.no_grad():
        for path, view in flax_leaves(params, cfg):
            leaf, meta = quantize_leaf(view.tensor(), 32)
            if meta is None:
                continue
            out = torch.empty(meta["shape"], dtype=torch.bfloat16,
                              device="cuda")
            dequantize(leaf, meta["scale"], meta["zero"], meta["shape"],
                       torch.bfloat16, out=out)
            view.write(out)
            del leaf, out
    held = sum(p.numel() * p.element_size() for p in params.values()) \
        / 2 ** 30
    log(f"generic (e) llama3_8b quantize=True: init (each large leaf "
        f"quantized and bound dequantized) {quant_s:.1f} s; the peaks of "
        f"its runs include the reference's {held:.2f} GiB of weights, which "
        f"the harness holds meanwhile")
    q_tokens, q_ms, q_peaks = legacy_quant_engine_runs(
        engine, "quantize", ids, mask, L, cfg)
    q_peaks = {run: peak - held for run, peak in q_peaks.items()}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = dt.init_inference(LlamaForCausalLM(cfg), params=params,
                               dtype=torch.bfloat16, device="cuda")
    del params
    b_tokens, b_ms, b_peaks = legacy_quant_engine_runs(
        engine, "bf16_on_dequantized", ids, mask, L, cfg)
    problems = []
    for run, toks in q_tokens.items():
        ref = b_tokens[run.replace("_per_step", "")]
        same = torch.equal(toks, ref) if torch.is_tensor(toks) else \
            toks == ref
        base = run.replace("_per_step", "")
        log(f"generic (e) {run}: quantize tokens equal the bf16 engine's on "
            f"the dequantized weights: {same}; mean step {q_ms[run]:.3f} ms "
            f"(bf16 {b_ms[base]:.3f} ms), peak memory less the harness's "
            f"reference weights {q_peaks[run]:.1f} GiB (bf16 "
            f"{b_peaks[base]:.1f} GiB)")
        if not same:
            problems.append(run)
    if problems:
        raise AssertionError(f"generic (e): tokens differ in {problems}")
    del engine
    return q_ms, b_ms


def check_generic():
    """The ``generic families`` phase: (a) :func:`check_pythia_generate`
    and :func:`check_gptj_falcon_generate`, (b)
    :func:`check_generic_families`, (c) :func:`check_bert_training`, (d)
    :func:`check_bert_layer`, (e) :func:`check_legacy_quant`, (f)
    :func:`check_causal_training`. Returns the launches by run."""
    launches = {}
    pythia, _ = check_pythia_generate()
    launches.update({f"pythia_6_9b_{k}": v for k, v in pythia.items()})
    gc.collect()
    torch.cuda.empty_cache()
    for model, (runs, _) in check_gptj_falcon_generate().items():
        launches.update({f"{model}_{k}": v for k, v in runs.items()})
    gc.collect()
    torch.cuda.empty_cache()
    families = check_generic_families()
    launches.update({f"family_{k}_fp32": {"decode_attention": v}
                     for k, v in families.items()})
    gc.collect()
    torch.cuda.empty_cache()
    bert = check_bert_training()
    launches.update({f"bert_large_mlm_{k}": v for k, v in bert.items()})
    gc.collect()
    torch.cuda.empty_cache()
    check_bert_layer()
    gc.collect()
    torch.cuda.empty_cache()
    check_legacy_quant()
    gc.collect()
    torch.cuda.empty_cache()
    causal = check_causal_training()
    launches.update({f"causal_train_{k}": v for k, v in causal.items()})
    return launches


# ---------------------------------------------------------------------------
# the serving families: Gemma-7B and Qwen2-7B on both engines
# ---------------------------------------------------------------------------

#: Gemma-7B's published configuration (google/gemma-7b config.json): 28
#: layers, hidden 3072, 16 heads of 256 on 16 kv heads, FFN 24576, vocab
#: 256000, GeGLU (tanh), tied embeddings scaled by sqrt(hidden)
GEMMA_7B = dict(vocab_size=256000, hidden_size=3072, intermediate_size=24576,
                num_hidden_layers=28, num_attention_heads=16,
                num_key_value_heads=16, head_dim_override=256,
                mlp_activation="gelu_tanh", embed_scale=3072 ** 0.5,
                tie_word_embeddings=True, max_position_embeddings=8192,
                rms_norm_eps=1e-6)
#: Qwen2-7B's (Qwen/Qwen2-7B config.json): 28 layers, hidden 3584, 28 heads
#: of 128 on 4 kv heads (a group of 7), FFN 18944, vocab 152064, q/k/v
#: biases, rope_theta 1e6
QWEN2_7B = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                num_hidden_layers=28, num_attention_heads=28,
                num_key_value_heads=4, attention_qkv_bias=True,
                rope_theta=1e6, max_position_embeddings=32768,
                rms_norm_eps=1e-6)
#: the runs of each family: (name, mixed_step, enable_cuda_graph, page
#: size, prefix cache, traffic: "serve" (the serve cell's 16 requests) or
#: "shared" (4 x 4 requests on shared 512-token prefixes), the run whose
#: tokens it must repeat)
FAMILY_RUNS = {
    "gemma_7b": (GEMMA_7B, (
        ("unified_uncaptured", True, False, 16, False, "serve", None),
        ("unified_captured", True, True, 16, False, "serve",
         "unified_uncaptured"),
        ("two_program", False, False, 16, True, "shared", None))),
    "qwen2_7b": (QWEN2_7B, (
        ("unified_uncaptured_bs32", True, False, 32, True, "shared", None),
        ("unified_captured_bs32", True, True, 32, True, "shared",
         "unified_uncaptured_bs32"),
        ("two_program_bs8", False, False, 8, True, "shared", None))),
}


def family_scfg(mixed, block_size, prefix_cache):
    """The serving cell's engine (8 slots, 2048-token rows, the serve
    cell's 16384 tokens of pool, a 256-token budget) at ``block_size``:
    bucketed widths on the unified step, 64-token chunks on the
    two-program engine."""
    scfg = dict(max_batch_size=8, block_size=block_size,
                num_blocks=N_PAGES * BS // block_size, max_model_len=2048,
                prefill_token_budget=256, trace=True, trace_capacity=1 << 16,
                prefix_cache=prefix_cache, mixed_step=mixed)
    if mixed:
        scfg["mixed_step_buckets"] = True
    else:
        scfg["prefill_chunk_tokens"] = PAGED_CHUNK
    return scfg


def family_run(label, cfg, params, run, device="cuda"):
    """One of ``FAMILY_RUNS``' runs: serve its traffic, log tokens/s, TTFT
    p50, mean step ms and peak memory, check the gates (every request
    finished, no page leaked, no row flagged, K6 = layers x steps on the
    device, or K7a = layers x decode forwards and K7b = layers x chunk
    forwards; with the prefix cache at least 12 hits). Returns the tokens
    and the kernels' launches."""
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    name, mixed, graphed, bs, cached, traffic, _ = run
    L = cfg.num_hidden_layers
    phases = None
    if traffic == "shared":
        phases = shared_prefix_phases(cfg.vocab_size, 4, 4, 512, (64, 512),
                                      (32, 64), 0)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    srv, rids, res, wall, launches = serve(
        cfg, 0, 16, (64, 1536), (32, 64), family_scfg(mixed, bs, cached),
        torch.bfloat16, device=device, params=params, phases=phases,
        engine_kw=dict(enable_cuda_graph=graphed))
    m = srv.metrics
    steps = len(step_widths(srv)) if mixed else m.steps
    tokens = [(res[r].state, res[r].finish_reason, res[r].tokens)
              for r in rids]
    finished = sum(st == "finished" for st, _, _ in tokens)
    generated = sum(len(t) for _, _, t in tokens)
    ttft = float(np.median([res[r].ttft_s for r in rids]))
    runs_k6 = kernel_runs(device) if device == "cuda" else 0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if device == "cuda" else float("nan")
    log(f"families {label} {name}: x{L} layers bf16, "
        f"{'unified' if mixed else 'two-program'} engine, enable_cuda_graph "
        f"{graphed}, pages of {bs}, prefix_cache {cached}, {len(rids)} "
        f"requests, {finished} finished, {steps} steps, wall {wall:.3f} s, "
        f"generated {generated} tokens = {generated / wall:.1f} tok/s, "
        f"ttft_p50 {ttft:.3f} s, mean step {1e3 * wall / max(steps, 1):.2f} "
        f"ms, prefix hits {m.prefix_hits} ({m.cached_prefill_tokens} cached "
        f"tokens), graphs {len(srv._graphs)}, K6 runs on the device "
        f"{runs_k6}, wrapper launches {launches}, peak memory {peak:.1f} GiB")
    srv.block_pool.check_consistent()
    problems = []
    if finished != len(rids):
        problems.append(f"{len(rids) - finished} requests did not finish")
    if srv.block_pool.used_count:
        problems.append(f"{srv.block_pool.used_count} pages leaked")
    if m.logit_quarantines:
        problems.append(f"{m.logit_quarantines} rows flagged NaN/Inf")
    if cached and m.prefix_hits < 12:
        problems.append(f"{m.prefix_hits} prefix hits < 12")
    if mixed:
        want = {"ragged_paged_attention": L * steps}
        if device == "cuda" and runs_k6 != L * steps:
            problems.append(f"K6 ran {runs_k6} times on the device, not "
                            f"{L} x {steps} steps")
        if not graphed and launches["ragged_paged_attention"] != L * steps:
            problems.append(f"K6 launches {launches} != {want}")
        launches = {"ragged_paged_attention": runs_k6 if device == "cuda"
                    else launches["ragged_paged_attention"]}
    else:
        want = {"ragged_paged_attention": 0,
                "paged_decode_attention": L * srv.decode_calls,
                "paged_prefill_attention": L * srv.prefill_chunk_calls,
                "flash_attention_fwd_masked": 0}
        if launches != want or not srv.decode_calls or \
                not srv.prefill_chunk_calls:
            problems.append(f"launches {launches} != {want}")
        launches = {k: v for k, v in launches.items() if v}
    if problems:
        raise AssertionError(f"families {label} {name}: "
                             + "; ".join(problems))
    del srv, res
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return tokens, launches


def check_family_twin(label, over, device="cuda"):
    """A 2-layer fp32 twin of a family at its published width, served as
    ``check_small_reference`` serves its model (6 seeded requests) by the
    unified engine and by the two-program engine with the prefix cache
    (shared-prefix traffic), each once on the kernels and once with the
    model's kernel wrappers swapped for their plain versions: identical
    greedy tokens, and the kernel route's K6 (device), K7a and K7b runs."""
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.ragged_attention import kernel_runs

    cfg = LlamaConfig(**dict(over, num_hidden_layers=2))
    params = LlamaForCausalLM(cfg).init_params(seed=3, dtype=torch.float32,
                                               device=device)
    phases = shared_prefix_phases(cfg.vocab_size, 2, 3, 48, (3, 40), (4, 12),
                                  5)
    bs = 16 if label == "gemma_7b" else 32
    engines = {
        "unified": dict(max_batch_size=4, block_size=bs, num_blocks=1024 // bs,
                        max_model_len=128, prefill_token_budget=32),
        "two_program": dict(max_batch_size=4, block_size=8, num_blocks=128,
                            max_model_len=128, mixed_step=False,
                            prefix_cache=True, prefill_chunk_tokens=16,
                            prefill_token_budget=32),
    }
    launches = {}
    for engine, scfg in engines.items():
        tokens, counts = {}, {}
        for route in ("kernel", "plain"):
            with plain_route() if route == "plain" else \
                    contextlib.nullcontext():
                kwargs = dict(phases=phases) if engine == "two_program" \
                    else {}
                srv, rids, res, _, counts[route] = serve(
                    cfg, 3, 6, (5, 90), (4, 12), dict(scfg, trace=True),
                    torch.float32, device=device, params=params, **kwargs)
            tokens[route] = [(res[r].state, res[r].tokens) for r in rids]
            if route == "kernel" and device == "cuda":
                counts[route]["ragged_paged_attention"] = kernel_runs(device)
            srv.block_pool.check_consistent()
            if srv.block_pool.used_count:
                raise AssertionError(f"families {label} fp32 twin {engine}: "
                                     f"{srv.block_pool.used_count} pages "
                                     f"leaked")
        ran = {n for n, c in counts["kernel"].items() if c}
        expected = {"ragged_paged_attention"} if engine == "unified" else \
            {"paged_decode_attention", "paged_prefill_attention"}
        ok = tokens["kernel"] == tokens["plain"] and \
            all(st == "finished" for st, _ in tokens["kernel"]) and \
            ran == expected and not any(counts["plain"].values())
        log(f"families {label} fp32 twin (2 layers at published width), "
            f"{engine} engine, kernels vs plain versions, "
            f"{len(tokens['kernel'])} requests: tokens identical="
            f"{tokens['kernel'] == tokens['plain']} ok={ok} (launches "
            f"{counts['kernel']} / {counts['plain']})")
        if not ok:
            raise AssertionError(f"families {label} fp32 twin {engine}: "
                                 f"kernels and plain versions disagree or a "
                                 f"route launched the wrong kernels")
        launches[f"{label}_fp32_twin_{engine}"] = {
            k: v for k, v in counts["kernel"].items() if v}
    del params
    return launches


def check_families(device="cuda"):
    """The ``families`` phase: (g) Gemma-7B and (h) Qwen2-7B at their
    published widths and depths from random bf16 weights (seed 0), each
    through ``FAMILY_RUNS`` (the unified engine uncaptured and captured at
    bucketed widths, whose tokens must be equal, and the two-program
    engine with the prefix cache; Qwen2 at pages of 32 and 8), then its
    2-layer fp32 twin (:func:`check_family_twin`). Returns the launches of
    each serving kernel by run."""
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    launches = {}
    for label, (over, runs) in FAMILY_RUNS.items():
        cfg = LlamaConfig(**over)
        t = time.perf_counter()
        params = LlamaForCausalLM(cfg).init_params(
            seed=0, dtype=torch.bfloat16, device=device)
        log(f"families {label}: {sum(p.numel() for p in params.values()):,} "
            f"parameters made in {time.perf_counter() - t:.1f} s")
        tokens = {}
        for run in runs:
            tokens[run[0]], launches[f"{label}_{run[0]}"] = family_run(
                label, cfg, params, run, device)
            twin = run[6]
            if twin is not None and tokens[run[0]] != tokens[twin]:
                raise AssertionError(f"families {label} {run[0]}: tokens or "
                                     f"finish reasons differ from {twin}")
            if twin is not None:
                log(f"families {label} {run[0]}: tokens identical to {twin}")
        del params
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        launches.update(check_family_twin(label, over, device))
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Megatron-LM, Mixtral-8x7B and the GShard MoE layer
# ---------------------------------------------------------------------------

#: Megatron-LM's GPT-345M (the Megatron-LM README's 345M GPT): 24 layers,
#: hidden 1024, 16 heads of 64, 1024 positions, GPT-2's vocabulary padded
#: to 50304
MEGATRON_345M = dict(layers=24, hidden=1024, heads=16, positions=1024,
                     vocab=50304)
#: the generate runs of the MoE phases: batch, prompt lengths, new tokens
MOE_GEN_B, MOE_GEN_PROMPT, MOE_GEN_NEW = 8, (128, 512), 32


def megatron_state_dict(layers, hidden, heads, positions, vocab, seed=0,
                        device="cuda"):
    """A Megatron GPT state dict under Megatron's names (version 2.0: the
    fused QKV rows head-interleaved ``[H, 3, D]``), random bf16 weights
    N(0, 0.02) from a seeded generator, LayerNorms 1 and biases 0, on the
    host."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.empty(shape, dtype=torch.bfloat16,
                           device=device).normal_(0.0, 0.02, generator=g)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.bfloat16, device=device)

    emb, tp = "language_model.embedding.", "language_model.transformer."
    sd = {f"{emb}word_embeddings.weight": normal(vocab, hidden),
          f"{emb}position_embeddings.weight": normal(positions, hidden),
          f"{tp}final_layernorm.weight": ones(hidden),
          f"{tp}final_layernorm.bias": zeros(hidden)}
    for i in range(layers):
        p = f"{tp}layers.{i}."
        sd.update({
            f"{p}input_layernorm.weight": ones(hidden),
            f"{p}input_layernorm.bias": zeros(hidden),
            f"{p}attention.query_key_value.weight": normal(3 * hidden,
                                                           hidden),
            f"{p}attention.query_key_value.bias": normal(3 * hidden),
            f"{p}attention.dense.weight": normal(hidden, hidden),
            f"{p}attention.dense.bias": zeros(hidden),
            f"{p}post_attention_layernorm.weight": ones(hidden),
            f"{p}post_attention_layernorm.bias": zeros(hidden),
            f"{p}mlp.dense_h_to_4h.weight": normal(4 * hidden, hidden),
            f"{p}mlp.dense_h_to_4h.bias": normal(4 * hidden),
            f"{p}mlp.dense_4h_to_h.weight": normal(hidden, 4 * hidden),
            f"{p}mlp.dense_4h_to_h.bias": zeros(hidden)})
    return {k: v.cpu() for k, v in sd.items()}


def check_megatron(device="cuda"):
    """The ``megatron`` phase: GPT-345M's random bf16 weights written as
    two TP shards (``mp_rank_00`` / ``mp_rank_01``, Megatron's names,
    version 2.0) in a temporary directory, loaded through
    ``MegatronLayerPolicy.from_megatron_checkpoint`` (the reshape loader
    merges them) onto the generic decoder with
    ``prefill_flash_from_empty``, and served by ``init_inference(...).
    generate``: batch 8, left-padded prompts of 128-512 tokens, 32 greedy
    new tokens. Held to the same model converted from the unsharded state
    dict: identical weights and tokens. The launch counts are set to 0
    just before the sharded model's counted generate and read just after:
    K4 24 x 31, the masked K1 24. Returns them."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.checkpoint.reshape import split_state_dict
    from deepspeed_tpu_torch.models.transformer import TransformerLMHeadModel
    from deepspeed_tpu_torch.module_inject.replace_policy import \
        MegatronLayerPolicy

    m = MEGATRON_345M
    t0 = time.perf_counter()
    full = megatron_state_dict(m["layers"], m["hidden"], m["heads"],
                               m["positions"], m["vocab"], device=device)
    tmp = tempfile.mkdtemp(prefix="megatron_")
    try:
        files = []
        as_np = {k: v.float().numpy() for k, v in full.items()}
        for rank in range(2):
            shard = split_state_dict(as_np, num_ranks=2, rank=rank)
            path = os.path.join(tmp, f"mp_rank_{rank:02d}_model_states.pt")
            torch.save({"module": {k: torch.from_numpy(v).to(torch.bfloat16)
                                   for k, v in shard.items()}}, path)
            files.append(path)
        del as_np
        write_s = time.perf_counter() - t0
        t = time.perf_counter()
        model, sd = MegatronLayerPolicy.from_megatron_checkpoint(
            files, num_attention_heads=m["heads"], dtype=torch.bfloat16,
            device=device)
        load_s = time.perf_counter() - t
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    ref_model, ref_sd = MegatronLayerPolicy.convert_state_dict(
        m["heads"], full, dtype=torch.bfloat16, device=device)
    del full
    cfg = dataclasses.replace(model.config, prefill_flash_from_empty=True)
    problems = []
    if (cfg.num_hidden_layers, cfg.hidden_size, cfg.head_dim,
            cfg.max_position_embeddings, cfg.vocab_size) != (
            m["layers"], m["hidden"], m["hidden"] // m["heads"],
            m["positions"], m["vocab"]):
        problems.append(f"inferred config {cfg}")
    if set(sd) != set(ref_sd) or not all(torch.equal(sd[n], ref_sd[n])
                                         for n in sd):
        problems.append("the sharded load's weights differ from the "
                        "unsharded state dict's")
    ids, mask = left_padded_prompts(m["vocab"], MOE_GEN_B, *MOE_GEN_PROMPT,
                                    seed=24)
    tokens, runs = {}, {}
    for name, weights in (("sharded", sd), ("unsharded", ref_sd)):
        engine = dt.init_inference(TransformerLMHeadModel(cfg),
                                   params=weights, dtype=torch.bfloat16,
                                   device=device)
        engine.generate(ids, attention_mask=mask, max_new_tokens=1)
        engine.profile_model_time()
        engine.generate(ids, attention_mask=mask, max_new_tokens=1)
        zero_generic_launches()
        out = engine.generate(ids, attention_mask=mask,
                              max_new_tokens=MOE_GEN_NEW)
        launches = generic_launches()
        prefill_s, total_s = engine.model_times()
        tokens[name] = out.cpu().tolist()
        runs[name] = dict(launches=launches, prefill_ms=1e3 * prefill_s,
                          decode_ms=1e3 * (total_s - prefill_s)
                          / (MOE_GEN_NEW - 1))
        del engine
    L = cfg.num_hidden_layers
    got = runs["sharded"]["launches"]
    want = dict(got, decode_attention=L * (MOE_GEN_NEW - 1),
                flash_attention_fwd_masked=L)
    if got != want:
        problems.append(f"launches {got} != {want}")
    if tokens["sharded"] != tokens["unsharded"]:
        problems.append("tokens differ from the unsharded model's")
    if np.asarray(tokens["sharded"]).shape != (MOE_GEN_B, MOE_GEN_NEW):
        problems.append("output shape")
    log(f"megatron: GPT-345M ({L} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads of {cfg.head_dim}, "
        f"{cfg.max_position_embeddings} positions, vocab {cfg.vocab_size}, "
        f"bf16) from two TP shards (written {write_s:.1f} s, loaded "
        f"{load_s:.1f} s): generate batch {MOE_GEN_B}, prompts "
        f"{int(mask.sum(1).min())}-{int(mask.sum(1).max())}, "
        f"{MOE_GEN_NEW} new: prefill {runs['sharded']['prefill_ms']:.2f} "
        f"ms, decode step {runs['sharded']['decode_ms']:.3f} ms, tokens "
        f"identical to the unsharded state dict's="
        f"{tokens['sharded'] == tokens['unsharded']}, launches "
        f"{ {k: v for k, v in got.items() if v} }")
    if problems:
        raise AssertionError("megatron: " + "; ".join(problems))
    return got


def dense_combine(topk_w, topk_idx, E):
    """``[B, E]`` combine weights of a top-k routing, zero outside it."""
    onehot = topk_idx[..., None] == torch.arange(E, device=topk_idx.device)
    return (topk_w[..., None] * onehot.float()).sum(dim=1)


def route_forcing(dense):
    """A context that sends one-token-a-row MoE blocks down the dense
    route (``dense``) or leaves JAX's rule (the touched-expert route)."""
    from deepspeed_tpu_torch.models import mixtral

    @contextlib.contextmanager
    def ctx():
        if not dense:
            yield
            return
        touched = mixtral.touched_experts

        def every(x, w1, w3, w2, topk_w, topk_idx):
            return mixtral.every_expert(
                x, w1, w3, w2, dense_combine(topk_w, topk_idx, w1.shape[0]))

        mixtral.touched_experts = every
        try:
            yield
        finally:
            mixtral.touched_experts = touched
    return ctx()


#: (mixtral) the cached decode against the full forward, bf16: each
#: position's logits within this relative L2 error (over the vocabulary)
#: of the full forward's, at every position whose routing (each layer's
#: top-2) was the same on both paths. bf16 keeps 8 significant bits; a
#: layer rounds the residual stream's update at about ten points
#: (attention, the experts' h and y, the combine, the norms), so 8 layers
#: make some 80 roundings of ~2^-9 in a random walk, ~2% of the hidden
#: state; a wrong cache row, mask or expert moves the logits by their own
#: size
MIXTRAL_LOGIT_REL = 0.05
#: the two MoE routes on one layer at T 1, bf16: max |diff| over the
#: dense route's max |out| (each sums its experts in another order)
MIXTRAL_ROUTE_TOL = 2e-2


def routing_recorder(model):
    """Hooks on every layer's MoE block recording its router's top-k
    expert sets ``[B, T, K]`` (sorted) in call order; returns (records,
    handles)."""
    records = []

    def hook(mod, args):
        logits = torch.nn.functional.linear(args[0], mod.gate.weight)
        records.append(logits.float().topk(mod.top_k, dim=-1).indices.sort(
            dim=-1).values)

    handles = [layer.block_sparse_moe.register_forward_pre_hook(hook)
               for layer in model.model.layers]
    return records, handles


def check_mixtral_decode_parity(engine, cfg, device="cuda"):
    """The cached decode's logits against a full forward over the same
    tokens (the JAX test's check, at full width and bf16): 2 prompts of
    96 tokens, 8 decode steps, the decode's MoE blocks on JAX's route
    (touched experts) and again forced onto the dense one. A position
    where some layer routed the token to another expert pair on the two
    paths (a bf16 near-tie) is counted and left out; at least half must
    route alike, and the rest be within ``MIXTRAL_LOGIT_REL``."""
    model = engine.module
    B, P, N = 2, 96, 8
    rs = np.random.RandomState(5)
    ids = torch.as_tensor(rs.randint(1, cfg.vocab_size, (B, P + N)),
                          device=device)
    L = cfg.num_hidden_layers
    with torch.inference_mode():
        rec, handles = routing_recorder(model)
        full = model(ids)
        full_routes = torch.stack(rec)             # [L, B, P + N, K]
        want = full[:, P - 1:P + N - 1].float()    # the compared positions
        del full
        problems = []
        for route in ("touched", "dense"):
            rec.clear()
            with route_forcing(route == "dense"):
                cache = model.init_cache(B, P + N, dtype=torch.bfloat16,
                                         device=device)
                key_mask = torch.zeros((B, P + N), dtype=torch.int32,
                                       device=device)
                key_mask[:, :P] = 1
                logits, cache = model(
                    ids[:, :P], cache=cache,
                    cache_index=torch.tensor(0, device=device),
                    attention_mask=key_mask)
                cached = [logits[:, -1]]
                for t in range(P, P + N - 1):
                    key_mask[:, t] = 1
                    step, cache = model(
                        ids[:, t:t + 1], cache=cache,
                        cache_index=torch.tensor(t, device=device),
                        attention_mask=key_mask)
                    cached.append(step[:, 0])
            routes = torch.cat([torch.stack(rec[:L])] + [
                torch.stack(rec[L * (s + 1):L * (s + 2)])
                for s in range(N - 1)], dim=2)     # [L, B, P + N - 1, K]
            same = (routes == full_routes[:, :, :P + N - 1]).all(dim=-1) \
                .all(dim=0)                        # [B, P + N - 1]
            alike = same[:, P - 1:]
            got = torch.stack(cached, dim=1).float()
            rel = (got - want).norm(dim=-1) / want.norm(dim=-1)  # [B, N]
            worst = float(rel[alike].max()) if alike.any() else float("nan")
            max_abs = float((got - want).abs().amax(dim=-1)[alike].max()) \
                if alike.any() else float("nan")
            ok = float(alike.float().mean()) >= 0.5 and \
                worst <= MIXTRAL_LOGIT_REL
            log(f"mixtral parity ({route} route in the decode): cached "
                f"decode vs full forward (2 prompts x 96 tokens, 8 steps, "
                f"bf16): relative L2 error {worst:.4f} at most (tol "
                f"{MIXTRAL_LOGIT_REL}), max |diff| {max_abs:.4f} (logit std "
                f"{float(want.std()):.4f}), at {int(alike.sum())} of "
                f"{alike.numel()} positions routed alike (prompt positions "
                f"{int(same[:, :P].sum())} of {same[:, :P].numel()}); "
                f"ok={ok}")
            if not ok:
                problems.append(route)
        for h in handles:
            h.remove()
    if problems:
        raise AssertionError(f"mixtral: cached decode disagrees with the "
                             f"full forward ({', '.join(problems)} route)")


def check_mixtral_routes(engine, cfg, device="cuda"):
    """The two MoE routes on layer 0's experts at T 1, B 8, on one
    routing: the touched-expert route's output within
    ``MIXTRAL_ROUTE_TOL`` of the dense route's; then each route's time at
    B 1 and B 8 (CUDA events, L2 flushed). Returns the times."""
    from deepspeed_tpu_torch.models import mixtral

    moe = engine.module.model.layers[0].block_sparse_moe
    E, K, H = cfg.num_local_experts, cfg.num_experts_per_tok, \
        cfg.hidden_size
    out = {}
    g = torch.Generator(device=device).manual_seed(3)
    for B in (1, 8):
        x = torch.randn((B, H), generator=g, device=device,
                        dtype=torch.bfloat16)
        with torch.inference_mode():
            probs = torch.nn.functional.linear(x, moe.gate.weight).float() \
                .softmax(dim=-1)
            topk_w, topk_idx = probs.topk(K, dim=-1)
            topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)
            combine = dense_combine(topk_w, topk_idx, E)

            def touched():
                return mixtral.touched_experts(x, moe.w1, moe.w3, moe.w2,
                                               topk_w, topk_idx)

            def dense():
                return mixtral.every_expert(x, moe.w1, moe.w3, moe.w2,
                                            combine)

            a, b = touched(), dense()
            rel = float((a.float() - b.float()).abs().max()
                        / b.float().abs().max())
            out[B] = dict(touched_ms=cuda_time_ms(touched, reps=10),
                          dense_ms=cuda_time_ms(dense, reps=10),
                          rel_err=rel)
        log(f"mixtral routes: layer 0, T 1, B {B}: touched-expert "
            f"{out[B]['touched_ms']:.3f} ms, dense {out[B]['dense_ms']:.3f} "
            f"ms, max |diff| / max |dense| {rel:.2e} (tol "
            f"{MIXTRAL_ROUTE_TOL})")
        if not rel <= MIXTRAL_ROUTE_TOL:
            raise AssertionError(f"mixtral: the MoE routes disagree at "
                                 f"B {B}")
    return out


#: (mixtral) Mixtral-8x7B's depth on the card: 8 of its 32 layers (23.7
#: GB of bf16 weights; all 32 need about 93 GB)
MIXTRAL_LAYERS = 8


def check_mixtral(device="cuda"):
    """The ``mixtral`` phase: Mixtral-8x7B at full width
    (``MixtralConfig.mixtral_8x7b``), ``MIXTRAL_LAYERS`` layers, random
    bf16 weights from seed 0, with ``prefill_flash_from_empty``, through
    ``init_inference`` -> ``generate``: batch 8, left-padded prompts of
    128-512 tokens (bucket 512), 32 greedy new tokens, uncaptured and with
    the decode step captured (identical tokens). The launch counts are set
    to 0 just before the uncaptured counted generate and read just after:
    K4 L x 31, the masked K1 L. Then the cached decode against the full
    forward, the two MoE routes against each other, and the decode step
    with each route (JAX's rule: touched experts; forced: dense) at B 1
    and B 8, captured. Prints prefill ms, decode step ms and peak memory.
    Returns the counted launches."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import MixtralConfig, MixtralForCausalLM

    cfg = MixtralConfig.mixtral_8x7b(num_hidden_layers=MIXTRAL_LAYERS,
                                     prefill_flash_from_empty=True)
    L = cfg.num_hidden_layers
    base = memory_base(device)
    t = time.perf_counter()
    params = MixtralForCausalLM(cfg).init_params(seed=0,
                                                 dtype=torch.bfloat16,
                                                 device=device)
    n_params = sum(p.numel() for p in params.values())
    log(f"mixtral: 8x7B widths x{L} layers, {n_params:,} parameters "
        f"({2 * n_params / 1e9:.1f} GB bf16) made in "
        f"{time.perf_counter() - t:.1f} s")
    engines = {graph: dt.init_inference(
        MixtralForCausalLM(cfg), params=params, dtype=torch.bfloat16,
        device=device, enable_cuda_graph=graph) for graph in (False, True)}
    del params
    ids, mask = left_padded_prompts(cfg.vocab_size, MOE_GEN_B,
                                    *MOE_GEN_PROMPT, seed=8)
    runs, problems = {}, []
    for graph, engine in engines.items():
        name = "captured" if graph else "uncaptured"
        zero_generic_launches()
        out, _, prefill_s, total_s, counts, capture, finite = generate_run(
            cfg, torch.bfloat16, None, ids, mask, MOE_GEN_NEW,
            device=device, engine=engine)
        runs[name] = dict(tokens=out.cpu().tolist(), prefill_ms=1e3 *
                          prefill_s, decode_ms=1e3 * (total_s - prefill_s)
                          / (MOE_GEN_NEW - 1), counts=counts,
                          capture=capture, finite=finite)
        if not finite or tuple(out.shape) != (MOE_GEN_B, MOE_GEN_NEW):
            problems.append(f"{name}: shape {tuple(out.shape)} or a "
                            f"logit not finite")
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30 \
        if device == "cuda" else 0.0
    k4, k1m = runs["uncaptured"]["counts"][0], runs["uncaptured"]["counts"][2]
    launches = {"decode_attention": k4, "flash_attention_fwd_masked": k1m}
    if (k4, k1m) != (L * (MOE_GEN_NEW - 1), L):
        problems.append(f"uncaptured launches K4 {k4}, masked K1 {k1m} != "
                        f"{L * (MOE_GEN_NEW - 1)}, {L}")
    if runs["captured"]["capture"][0] != 2 * L:
        problems.append(f"capturing warm-up K4 "
                        f"{runs['captured']['capture'][0]} != {2 * L}")
    if runs["captured"]["tokens"] != runs["uncaptured"]["tokens"]:
        problems.append("captured tokens differ from uncaptured ones")
    log(f"mixtral generate: batch {MOE_GEN_B}, prompts "
        f"{int(mask.sum(1).min())}-{int(mask.sum(1).max())} (bucket 512), "
        f"{MOE_GEN_NEW} new: prefill {runs['uncaptured']['prefill_ms']:.2f}"
        f" ms, decode step uncaptured {runs['uncaptured']['decode_ms']:.3f} "
        f"ms, captured {runs['captured']['decode_ms']:.3f} ms, peak memory "
        f"{peak:.1f} GiB (weights {2 * n_params / 2 ** 30:.1f} GiB), "
        f"tokens identical={runs['captured']['tokens'] == runs['uncaptured']['tokens']}, "
        f"launches K4 {k4} masked K1 {k1m}")
    if problems:
        raise AssertionError("mixtral: " + "; ".join(problems))
    check_mixtral_decode_parity(engines[False], cfg, device)
    route_ms = check_mixtral_routes(engines[False], cfg, device)
    # the decode step with each route, captured, at B 1 and B 8 (an
    # engine a route, so each captures its own step; the weights shared)
    steps = {}
    weights = engines[False].module.state_dict()
    for B in (1, 8):
        for dense in (False, True):
            with route_forcing(dense):
                engine = dt.init_inference(
                    MixtralForCausalLM(cfg), params=weights,
                    dtype=torch.bfloat16, device=device,
                    enable_cuda_graph=True)
                b_ids, b_mask = ids[:B], mask[:B]
                engine.generate(b_ids, attention_mask=b_mask,
                                max_new_tokens=MOE_GEN_NEW)
                engine.profile_model_time()
                engine.generate(b_ids, attention_mask=b_mask,
                                max_new_tokens=1)
                engine.generate(b_ids, attention_mask=b_mask,
                                max_new_tokens=MOE_GEN_NEW)
                prefill_s, total_s = engine.model_times()
                steps[(B, "dense" if dense else "touched")] = \
                    1e3 * (total_s - prefill_s) / (MOE_GEN_NEW - 1)
                del engine
                gc.collect()
        log(f"mixtral decode step, captured, B {B}: touched-expert route "
            f"{steps[(B, 'touched')]:.3f} ms, dense route "
            f"{steps[(B, 'dense')]:.3f} ms (layer 0 alone: "
            f"{route_ms[B]['touched_ms']:.3f} / "
            f"{route_ms[B]['dense_ms']:.3f} ms)")
    del engines, weights
    return launches


#: (moe train a) Mixtral-8x7B widths, 2 layers, one micro-batch of 2048
#: tokens, AdamW in bf16 with clipping
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2, 2048, 4
MOE_TRAIN_CONFIG = {"train_batch_size": 1, "bf16": {"enabled": True},
                    "optimizer": {"type": "AdamW",
                                  "params": {"lr": 1e-4,
                                             "weight_decay": 0.1}},
                    "gradient_clipping": 1.0, "steps_per_print": 0}
#: (moe train b) DeepSpeed-MoE's 350M+MoE-128 widths (Rajbhandari et al.
#: 2022): hidden 1024, FFN 4096, 128 experts, capacity factor 1.0; tokens
#: a step
MOE_LAYER = dict(hidden=1024, ffn=4096, experts=128, tokens=8192)
MOE_LAYER_STEPS = 3


def check_mixtral_training(device="cuda"):
    """(a) Mixtral-8x7B widths at ``MOE_TRAIN_LAYERS`` layers (seed 0)
    through ``initialize`` -> ``train_batch``, captured: one micro-batch
    of ``MOE_TRAIN_SEQ`` tokens, ``MOE_TRAIN_STEPS`` steps; the wrappers'
    counts are set to 0 before the first step (which runs eagerly and is
    captured) and read after it: K1 2 L (forward and recompute), K2 L + L,
    K3 2 (once a pass); a replayed step's device runs: K1 2 L, K2 L + L,
    K3 1. Finite losses, a positive aux term. Prints the step ms, model
    TFLOP/s (6 N tokens with N every expert's weights, the dense route's
    count, plus attention) and peak memory."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import MixtralConfig, MixtralForCausalLM

    cfg = MixtralConfig.mixtral_8x7b(num_hidden_layers=MOE_TRAIN_LAYERS)
    L = cfg.num_hidden_layers
    names = list(train_kernels())
    base = memory_base(device)
    engine, *_ = dt.initialize(model=MixtralForCausalLM(cfg),
                               config=dict(MOE_TRAIN_CONFIG), device=device)
    n_params = sum(p.numel() for p in engine.master.values())
    rs = np.random.RandomState(2)
    ids = rs.randint(0, cfg.vocab_size, (1, MOE_TRAIN_SEQ))
    batch = {"input_ids": ids, "labels": ids}
    zero_generic_launches()
    losses = [engine.train_batch(batch=batch)]
    if device == "cuda":
        torch.cuda.synchronize()
    wrappers = {n: generic_launches()[n] for n in names}
    step_s, busy, wall, peak, runs = steady_state(
        lambda: losses.append(engine.train_batch(batch=batch)),
        MOE_TRAIN_STEPS - 1, device, base, names)
    aux = []
    hook = engine.module.model.register_forward_hook(
        lambda mod, args, out: aux.append(float(out[1])))
    engine.eval_batch({k: torch.as_tensor(v) for k, v in batch.items()})
    hook.remove()
    losses = [float(x) for x in losses]
    flops = model_flops_per_step(n_params, 1, MOE_TRAIN_SEQ, L,
                                 cfg.hidden_size)
    want_wrappers = {"flash_attention_fwd": 2 * 2 * L,
                     "flash_attention_bwd_dq": 2 * L,
                     "flash_attention_bwd_dkv": 2 * L, "fused_adam": 2}
    want_runs = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                 "flash_attention_bwd_dkv": L, "fused_adam": 1}
    log(f"moe train (a): mixtral 8x7B widths x{L} layers "
        f"({n_params / 1e9:.2f} B params, AdamW, bf16, clip 1.0, captured), "
        f"1 x {MOE_TRAIN_SEQ} tokens: step {1e3 * step_s:.2f} ms, model "
        f"{flops / step_s / 1e12:.1f} TFLOP/s (every expert counted, the "
        f"dense route's FLOPs), device busy {busy:.1f} of {wall:.1f} ms, "
        f"peak memory {peak / 2 ** 30:.1f} GiB, losses "
        f"{[round(x, 4) for x in losses]}, aux {aux[0]:.4f}, launches "
        f"(first step: eager warm-up + capture) {wrappers}, device runs of "
        f"a replay {runs}")
    problems = []
    if not all(np.isfinite(losses)) or not aux[0] > 0:
        problems.append("a loss not finite or the aux term not positive")
    if wrappers != want_wrappers:
        problems.append(f"launches {wrappers} != {want_wrappers}")
    if device == "cuda" and runs != want_runs:
        problems.append(f"device runs {runs} != {want_runs}")
    if problems:
        raise AssertionError("moe train (a): " + "; ".join(problems))
    del engine
    return wrappers


class MoENet(torch.nn.Module):
    """A small model with two GShard ``MoE`` layers (the shape of the JAX
    tests' ``SimpleMoEModel``): linear, ReLU, MoE, MoE, linear, MSE plus
    0.01 of each layer's aux loss."""

    def __init__(self, hidden, ffn, experts, k, dtype):
        super().__init__()
        from deepspeed_tpu_torch import moe

        self.inp = torch.nn.Linear(hidden, hidden)
        self.moes = torch.nn.ModuleList(
            moe.MoE(hidden, moe.ExpertMLP(hidden, ffn, dtype=dtype),
                    num_experts=experts, k=k, capacity_factor=1.0,
                    eval_capacity_factor=1.0, min_capacity=4, use_rts=True)
            for _ in range(2))
        self.out = torch.nn.Linear(hidden, 1)

    def forward(self, x, y):
        # the engine binds its weights in the compute dtype
        h = torch.relu(self.inp(x.to(self.inp.weight.dtype)))
        aux = 0.0
        for layer in self.moes:
            h, l_aux, _ = layer(h)
            aux = aux + l_aux
        loss = ((self.out(h).squeeze(-1).float() - y) ** 2).mean()
        return loss + 0.01 * aux


def check_moe_layer_training(device="cuda"):
    """(b) ``moe.MoE`` at DeepSpeed-MoE 350M+MoE-128's widths: ``MoENet``
    (two MoE layers, 128 ``ExpertMLP`` experts each, bf16) through
    ``initialize`` -> ``train_batch`` on AdamW, captured, with k 1 (RTS
    on) and k 2, ``MOE_LAYER_STEPS`` steps of ``MOE_LAYER['tokens']``
    tokens each. The wrappers' counts are set to 0 before the first step
    (eager warm-up + capture) and read after it: K3 2; a replay's device
    runs: K3 1. Then one eager forward with the gate's outputs recorded:
    ``exp_counts`` sum to the routed tokens (k x tokens), no expert's
    dispatched tokens exceed its capacity, and the losses are finite.
    Returns the launches by k."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.moe import TopKGate
    from deepspeed_tpu_torch.moe.sharded_moe import _capacity

    m = MOE_LAYER
    S = m["tokens"]
    out = {}
    for k in (1, 2):
        base = memory_base(device)
        with torch.device(device):
            net = MoENet(m["hidden"], m["ffn"], m["experts"], k,
                         torch.bfloat16)
        engine, *_ = dt.initialize(model=net, config={
            "train_batch_size": S, "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "steps_per_print": 0}, device=device)
        n_params = sum(p.numel() for p in engine.master.values())
        g = torch.Generator(device=device).manual_seed(k)
        batch = {"x": torch.randn((S, m["hidden"]), generator=g,
                                  device=device),
                 "y": torch.randn((S,), generator=g, device=device)}
        zero_generic_launches()
        losses = [engine.train_batch(batch=batch)]
        if device == "cuda":
            torch.cuda.synchronize()
        wrappers = {"fused_adam": generic_launches()["fused_adam"]}
        step_s, busy, wall, peak, runs = steady_state(
            lambda: losses.append(engine.train_batch(batch=batch)),
            MOE_LAYER_STEPS - 1, device, base, ["fused_adam"])
        # one eager forward, the gates' outputs recorded
        gated = []
        hooks = [mod.register_forward_hook(
            lambda mod, args, res: gated.append(res))
            for mod in net.modules() if isinstance(mod, TopKGate)]
        engine.eval_batch(batch)
        for h in hooks:
            h.remove()
        losses = [float(x) for x in losses]
        capacity = _capacity(S, m["experts"], 1.0 * k, 4)
        problems = []
        for l_aux, combine, dispatch, counts in gated:
            held = dispatch.sum(dim=(0, 2))
            if int(counts.sum()) != k * S or int(held.max()) > capacity or \
                    not bool(torch.isfinite(l_aux)):
                problems.append(f"exp_counts sum {int(counts.sum())} (want "
                                f"{k * S}), most held {int(held.max())} "
                                f"(capacity {capacity})")
        if len(gated) != 2:
            problems.append(f"{len(gated)} gates ran, not 2")
        if not all(np.isfinite(losses)):
            problems.append("a loss is not finite")
        if wrappers != {"fused_adam": 2} or (
                device == "cuda" and runs != {"fused_adam": 1}):
            problems.append(f"K3 launches {wrappers}, device runs {runs}")
        log(f"moe train (b): moe.MoE x2 at 350M+MoE-128 widths (hidden "
            f"{m['hidden']}, FFN {m['ffn']}, {m['experts']} experts, k {k}"
            f"{', RTS' if k == 1 else ''}, capacity factor 1.0: capacity "
            f"{capacity}; {n_params / 1e9:.2f} B params, AdamW, bf16, "
            f"captured), {S} tokens a step: step {1e3 * step_s:.2f} ms, "
            f"device busy {busy:.1f} of {wall:.1f} ms, peak memory "
            f"{peak / 2 ** 30:.1f} GiB, losses "
            f"{[round(x, 4) for x in losses]}, most tokens an expert held "
            f"{[int(r[2].sum(dim=(0, 2)).max()) for r in gated]}, K3 "
            f"launches {wrappers['fused_adam']}, device runs of a replay "
            f"{runs}")
        if problems:
            raise AssertionError(f"moe train (b) k {k}: "
                                 + "; ".join(problems))
        out[k] = wrappers
        del engine, net, gated
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def check_moe_train(device="cuda"):
    """The ``moe train`` phase: (a) then (b). Returns the launches of (a)
    and of (b) by k."""
    a = check_mixtral_training(device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"mixtral": a, "moe_layer": check_moe_layer_training(device)}


# ---------------------------------------------------------------------------
# ZeRO-Offload, ZeRO-Infinity and the host ops (items 15-17)
# ---------------------------------------------------------------------------

def host_info():
    """The host's CPU model, core count and memory (``/proc``): the
    numbers every host-side figure stands beside."""
    model = "unknown"
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    return {"cpu": model, "cores": os.cpu_count(),
            "mem_total_gib": round(_meminfo("MemTotal") / 2 ** 30, 2)}


def _meminfo(key):
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise KeyError(key)


def host_memory_available():
    """Bytes the process may still take: ``MemAvailable``, or less where
    the cgroup's limit (v2 ``memory.max`` less ``memory.current``) is
    lower. Returns (bytes, {source: bytes})."""
    seen = {"MemAvailable": _meminfo("MemAvailable")}
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            limit = f.read().strip()
        with open("/sys/fs/cgroup/memory.current") as f:
            used = int(f.read().strip())
        if limit != "max":
            seen["cgroup"] = int(limit) - used
    except OSError:
        pass
    return min(seen.values()), seen


def host_copy_gbs(nbytes=2 ** 30, reps=5):
    """The host's memory rate as a torch copy of ``nbytes`` fp32 (GB/s of
    bytes read plus bytes written, the best of ``reps``)."""
    src = torch.randn(nbytes // 4)
    dst = torch.empty_like(src)
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        dst.copy_(src)
        best = min(best, time.perf_counter() - t)
    return 2 * nbytes / best / 1e9


#: one fp32 leaf of Llama-3-8B's MLP (4096 x 14336), the host ops' shape
HOST_LEAF = (4096, 14336)
HOST_OPS_RTOL = 1e-6
HOST_OPS_REPS = 3


def _close(got, want, rtol):
    """max |got - want| within ``rtol`` of max |want| (an elementwise
    relative bound fails where a value crosses 0)."""
    err = float((got - want).abs().max())
    return err, err <= rtol * float(want.abs().max())


def check_host_ops():
    """(c) The host libraries on one ``HOST_LEAF`` fp32 leaf: a
    ``DeepSpeedCPUAdam`` step (AdamW, with the fused bf16 output) and a
    ``DeepSpeedCPUAdagrad`` step against their plain versions on the same
    inputs (max error within 1e-6 of the largest value; the bf16 outputs
    within one bf16 step), timed (best of ``HOST_OPS_REPS``) beside the
    plain versions, with their bytes over the host's measured copy rate as
    the bound; then the async-IO handle's ``pwrite`` / ``pread`` of the
    leaf (O_DIRECT where the file system takes it; the bytes read back
    bitwise) beside a plain Python write / read of the same bytes. Returns
    the host copy rate (GB/s) and the lines' numbers."""
    from deepspeed_tpu_torch.ops.adagrad import (DeepSpeedCPUAdagrad,
                                                 cpu_adagrad_step_plain)
    from deepspeed_tpu_torch.ops.adam import (DeepSpeedCPUAdam,
                                              cpu_adam_step_plain)
    from deepspeed_tpu_torch.ops.aio import aio_handle, uring_available

    info = host_info()
    copy_gbs = host_copy_gbs()
    log(f"host ops: host {json.dumps(info)}; torch copy {copy_gbs:.2f} GB/s "
        f"(read + write, 1 GiB fp32)")
    n = HOST_LEAF[0] * HOST_LEAF[1]
    gen = torch.Generator().manual_seed(5)
    p0 = torch.randn(n, generator=gen) * 0.02
    g0 = torch.randn(n, generator=gen) * 1e-3
    out = {}
    problems = []

    def best(fn, reps=HOST_OPS_REPS):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return min(times)

    # Adam: 16 bytes read (p, g, m, v), 14 written (p, m, v, bf16)
    adam_kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1)
    p, m, v = p0.clone(), torch.zeros(n), torch.zeros(n)
    bf = torch.empty(n, dtype=torch.bfloat16)
    opt = DeepSpeedCPUAdam([p], adamw_mode=True, **adam_kw)
    opt.step_leaf(p, g0, m, v, 1, adam_kw["lr"], bf)
    pp, pm, pv = p0.clone(), torch.zeros(n), torch.zeros(n)
    pbf = torch.empty(n, dtype=torch.bfloat16)
    cpu_adam_step_plain(pp, g0, pm, pv, 1, adam_kw["lr"], adam_kw["betas"],
                        adam_kw["eps"], adam_kw["weight_decay"], True, pbf)
    checks = {"adam p": _close(p, pp, HOST_OPS_RTOL),
              "adam m": _close(m, pm, HOST_OPS_RTOL),
              "adam v": _close(v, pv, HOST_OPS_RTOL),
              "adam bf16": _close(bf.float(), pbf.float(), 2 ** -8)}
    s_c = best(lambda: opt.step_leaf(p, g0, m, v, 2, adam_kw["lr"], bf))
    s_p = best(lambda: cpu_adam_step_plain(
        pp, g0, pm, pv, 2, adam_kw["lr"], adam_kw["betas"], adam_kw["eps"],
        adam_kw["weight_decay"], True, pbf), 1)
    nbytes = 30 * n
    out["cpu_adam"] = {"ms": 1e3 * s_c, "plain_ms": 1e3 * s_p,
                       "bytes": nbytes, "gbs": nbytes / s_c / 1e9,
                       "bound_ms": 1e3 * nbytes / (copy_gbs * 1e9),
                       "max_abs_err": checks["adam p"][0]}
    # Adagrad: 12 bytes read (p, g, h), 10 written (p, h, bf16)
    h = torch.zeros(n)
    p = p0.clone()
    ada = DeepSpeedCPUAdagrad([p], lr=1e-2, eps=1e-10, weight_decay=0.1,
                              num_threads=os.cpu_count())
    ada.step_leaf(p, g0, h, 1e-2, bf)
    pp, ph = p0.clone(), torch.zeros(n)
    cpu_adagrad_step_plain(pp, g0, ph, 1e-2, 1e-10, 0.1, pbf)
    checks.update({"adagrad p": _close(p, pp, HOST_OPS_RTOL),
                   "adagrad h": _close(h, ph, HOST_OPS_RTOL),
                   "adagrad bf16": _close(bf.float(), pbf.float(), 2 ** -8)})
    s_c = best(lambda: ada.step_leaf(p, g0, h, 1e-2, bf))
    s_p = best(lambda: cpu_adagrad_step_plain(pp, g0, ph, 1e-2, 1e-10, 0.1,
                                              pbf), 1)
    nbytes = 22 * n
    out["cpu_adagrad"] = {"ms": 1e3 * s_c, "plain_ms": 1e3 * s_p,
                          "bytes": nbytes, "gbs": nbytes / s_c / 1e9,
                          "bound_ms": 1e3 * nbytes / (copy_gbs * 1e9),
                          "max_abs_err": checks["adagrad p"][0]}
    problems += [f"{k}: max error {e:.3g}" for k, (e, ok) in checks.items()
                 if not ok]
    # aio: the leaf to a file and back
    d = tempfile.mkdtemp(prefix="chip_smoke_aio_")
    path = os.path.join(d, "leaf.bin")
    nbytes = 4 * n
    try:
        handle = aio_handle(block_size=1 << 20, queue_depth=32,
                            num_threads=4, use_o_direct=True)
        back = torch.empty(n)
        s_w = best(lambda: handle.pwrite(p0, path))
        s_r = best(lambda: handle.pread(back, path))
        if not torch.equal(back, p0):
            problems.append("aio read back other bytes")
        plain_path = os.path.join(d, "plain.bin")
        raw = p0.numpy().tobytes()

        def write_plain():
            with open(plain_path, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())

        buf = bytearray(nbytes)

        def read_plain():
            with open(plain_path, "rb") as f:
                f.readinto(buf)

        s_pw, s_pr = best(write_plain), best(read_plain)
        out["aio"] = {"backend": handle.backend,
                      "uring_available": uring_available(),
                      "o_direct": True, "bytes": nbytes,
                      "pwrite_ms": 1e3 * s_w, "pread_ms": 1e3 * s_r,
                      "pwrite_gbs": nbytes / s_w / 1e9,
                      "pread_gbs": nbytes / s_r / 1e9,
                      "plain_write_fsync_ms": 1e3 * s_pw,
                      "plain_read_ms": 1e3 * s_pr,
                      "plain_write_gbs": nbytes / s_pw / 1e9,
                      "plain_read_gbs": nbytes / s_pr / 1e9}
        handle.close()
    finally:
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    for name, rec in out.items():
        log(f"host ops {name} {json.dumps(rec)}")
    if problems:
        raise AssertionError("host ops: " + "; ".join(problems))
    return copy_gbs, out


#: (a) ZeRO-Offload on Llama-3-8B's widths: AdamW on the host, stage 2,
#: bf16, clipping 1.0, one sequence of OFFLOAD_SEQ tokens a step, captured
OFFLOAD_CONFIG = {
    "train_batch_size": 1,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 1e-4, "weight_decay": 0.1}},
    "bf16": {"enabled": True}, "gradient_clipping": 1.0,
    "zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "cpu", "pin_memory": True}},
    "steps_per_print": 0, "seed": 0}
OFFLOAD_SEQ = 2048
OFFLOAD_STEPS = 3
#: host bytes a trained parameter takes under offload at gas 1: the fp32
#: master, two fp32 moments and one pinned bf16 buffer (the gradient, then
#: the new weight)
OFFLOAD_HOST_BYTES = 14
#: host memory left to the rest of the process (the runtime, the host
#: step's fp32 scratch of the largest leaf, earlier phases' leftovers)
OFFLOAD_HOST_RESERVE = 12 * 2 ** 30
#: the leaf held against the plain host Adam
OFFLOAD_LEAF = "model.layers.0.self_attn.q_proj.weight"


def llama_param_split(cfg):
    """(parameters of one decoder layer, parameters outside the layers) of
    a Llama config, counted on the meta device."""
    from deepspeed_tpu_torch.models import LlamaForCausalLM

    one = LlamaForCausalLM(dataclasses.replace(cfg, num_hidden_layers=1))
    layer = edges = 0
    for name, p in one.named_parameters():
        if ".layers.0." in name:
            layer += p.numel()
        else:
            edges += p.numel()
    return layer, edges


def offload_depth(cfg, available):
    """The deepest whole-layer cut of ``cfg`` whose offload state fits in
    ``available`` host bytes (``cfg``'s own depth when all fit)."""
    layer, edges = llama_param_split(cfg)
    room = available - OFFLOAD_HOST_RESERVE - OFFLOAD_HOST_BYTES * edges
    return max(0, min(cfg.num_hidden_layers,
                      int(room // (OFFLOAD_HOST_BYTES * layer))))


def check_offload_train(copy_gbs, device="cuda"):
    """(a) ``initialize`` -> ``train_batch`` on Llama-3-8B's widths with
    ``offload_optimizer: cpu``: all 32 layers if the host holds ~14 bytes
    a parameter, else the deepest whole-layer cut that fits (printed).
    The device grad step (K1 forward and recompute, K2) is captured; the
    gradients go to pinned host buffers, the host AdamW steps the fp32
    masters and writes the bf16 weights the card reads back. The first
    step's loss is held to the same grad step run uncaptured (1e-4
    relative), one leaf's new master to the plain AdamW on the gradient
    the host took (1e-6 of its largest value); the losses finite and
    falling over ``OFFLOAD_STEPS`` steps; K1 4L / K2 2L + 2L launched in
    the first step (eager warm-up and capture), K1 2L / K2 L + L on the
    device in each replay, K3 never. Prints the step split (device grad
    step, D2H, host optimizer, H2D), each copy's GB/s, the host step's GB/s
    beside the host's copy rate, the device peak and the resident set."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.adam import cpu_adam_step_plain

    full = LlamaConfig.llama3_8b(remat_policy="dots")
    available, seen = host_memory_available()
    L = offload_depth(full, available)
    layer, edges = llama_param_split(full)
    log(f"offload train: host memory available {available / 2 ** 30:.1f} "
        f"GiB ({ {k: round(v / 2 ** 30, 1) for k, v in seen.items()} }); "
        f"{OFFLOAD_HOST_BYTES} B a parameter: {L} of "
        f"{full.num_hidden_layers} layers fit "
        f"({(edges + L * layer) / 1e9:.2f} B parameters; all 32 would take "
        f"{OFFLOAD_HOST_BYTES * (edges + 32 * layer) / 2 ** 30:.1f} GiB)")
    if L < 1:
        raise AssertionError("offload train: the host holds no layer")
    cfg = dataclasses.replace(full, num_hidden_layers=L)
    names = ["flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv", "fused_adam"]
    base = memory_base(device)
    with RssPeak() as rss:
        t0 = time.perf_counter()
        engine, *_ = dt.initialize(model=LlamaForCausalLM(cfg),
                                   config=dict(OFFLOAD_CONFIG), device=device)
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in engine._trainable)
        rs = np.random.RandomState(7)
        ids = rs.randint(0, cfg.vocab_size, (1, OFFLOAD_SEQ))
        batch = {"input_ids": ids, "labels": ids}
        # the same grad step, uncaptured, before the first train step
        (plain_loss,) = engine._offload_grad_step(engine._shape_batch(batch))
        plain_loss = float(plain_loss)
        li = engine._trainable_names.index(OFFLOAD_LEAF)
        opt = engine._host_opt
        seen_leaf = {}
        host_step = opt.step

        def spy(grads, **kw):
            if not seen_leaf:
                seen_leaf["g"] = grads[li].float().clone()
                seen_leaf["m"] = opt.master[li].clone()
            return host_step(grads, **kw)

        opt.step = spy
        cuda = device == "cuda"
        zero_generic_launches()
        losses, times = [], []
        for s in range(OFFLOAD_STEPS):
            losses.append(float(engine.train_batch(batch=batch)))
            times.append(dict(engine.offload_times))
            if s == 0:
                first = {n: generic_launches()[n] for n in names}
                first_norm = engine.get_global_grad_norm()
                first_master = opt.master[li].clone()
                if cuda:
                    reset_device_runs(names)
        replay_runs = {n: r / (OFFLOAD_STEPS - 1)
                       for n, r in device_runs(names).items()} if cuda \
            else {}
        opt.step = host_step
        peak = torch.cuda.max_memory_allocated() - base \
            if device == "cuda" else 0
    # the plain AdamW on the leaf's gradient as the host took it
    clip = OFFLOAD_CONFIG["gradient_clipping"]
    g = seen_leaf["g"]
    if first_norm > clip:
        g = torch.from_numpy(g.numpy() * np.float32(
            clip / (first_norm + 1e-6)))
    want = seen_leaf["m"].clone()
    kw = OFFLOAD_CONFIG["optimizer"]["params"]
    cpu_adam_step_plain(want, g, torch.zeros_like(want),
                        torch.zeros_like(want), 1, kw["lr"],
                        weight_decay=kw["weight_decay"], adamw_mode=True)
    leaf_err, leaf_ok = _close(first_master, want, HOST_OPS_RTOL)
    steady = {k: statistics.mean(t[k] for t in times[1:])
              for k in times[0]}
    grad_bytes = 2 * n_params
    host_bytes = 30 * n_params
    rec = {"layers": L, "of_layers": full.num_hidden_layers,
           "params_b": n_params / 1e9, "init_s": init_s,
           "losses": losses, "uncaptured_first_loss": plain_loss,
           "step_s": sum(steady.values()),
           "split_s": steady, "first_step_split_s": times[0],
           "d2h_gbs": grad_bytes / steady["d2h"] / 1e9,
           "h2d_gbs": grad_bytes / steady["h2d"] / 1e9,
           "host_step_gbs": host_bytes / steady["host_step"] / 1e9,
           "host_copy_gbs": copy_gbs,
           "device_peak_gib": peak / 2 ** 30,
           "rss_peak_gib": rss.peak / 2 ** 30,
           "rss_start_gib": rss.start / 2 ** 30,
           "leaf_max_abs_err": leaf_err,
           "first_step_launches": first, "replay_device_runs": replay_runs}
    log(f"offload train {json.dumps(rec)}")
    problems = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"losses not finite and falling: {losses}")
    if abs(losses[0] - plain_loss) > 1e-4 * abs(plain_loss):
        problems.append(f"first loss {losses[0]} != the uncaptured "
                        f"{plain_loss}")
    if not leaf_ok:
        problems.append(f"{OFFLOAD_LEAF}: the host step is {leaf_err:.3g} "
                        f"from the plain AdamW")
    want_first = {"flash_attention_fwd": 4 * L,
                  "flash_attention_bwd_dq": 2 * L,
                  "flash_attention_bwd_dkv": 2 * L, "fused_adam": 0}
    if first != want_first:
        problems.append(f"launches {first} != {want_first}")
    want_runs = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                 "flash_attention_bwd_dkv": L, "fused_adam": 0}
    if device == "cuda" and replay_runs != want_runs:
        problems.append(f"device runs a replay {replay_runs} != {want_runs}")
    if device == "cuda" and peak >= 80e9:
        problems.append(f"device peak {peak / 1e9:.1f} GB")
    if problems:
        raise AssertionError("offload train: " + "; ".join(problems))
    del engine
    gc.collect()
    return {"layers": L, "launches": first, "replay_device_runs": replay_runs}


class InfinityEmbed(torch.nn.Module):
    """The token embedding of a streamed Llama."""

    def __init__(self, vocab, hidden):
        super().__init__()
        self.embed_tokens = torch.nn.Embedding(vocab, hidden)

    def forward(self, ids):
        return self.embed_tokens(ids)


class InfinityLayer(torch.nn.Module):
    """The port's ``LlamaBlock`` as a pipeline layer: it computes its
    positions (0 .. T - 1) and their RoPE tables from its input."""

    def __init__(self, cfg):
        super().__init__()
        from deepspeed_tpu_torch.models.llama import LlamaBlock

        self.cfg = cfg
        self.block = LlamaBlock(cfg)

    def forward(self, x):
        from deepspeed_tpu_torch.models.layers import rotary_embedding

        B, T, _ = x.shape
        pos = torch.arange(T, device=x.device)[None].expand(B, T)
        cos, sin = rotary_embedding(pos, self.cfg.head_dim,
                                    self.cfg.rope_theta, dtype=x.dtype)
        return self.block(x, cos, sin, None, None)


class InfinityHead(torch.nn.Module):
    """The final norm and the LM head."""

    def __init__(self, cfg):
        super().__init__()
        from deepspeed_tpu_torch.models.layers import RMSNorm

        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = torch.nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                       bias=False)

    def forward(self, x):
        return self.lm_head(self.norm(x))


#: (b) ZeRO-Infinity: the body streamed from pinned host memory in blocks
#: of two layers; AdamW on the host; one sequence of INFINITY_SEQ tokens
INFINITY_CONFIG = {
    "train_batch_size": 1,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 1e-4, "weight_decay": 0.1}},
    "bf16": {"enabled": True}, "gradient_clipping": 1.0,
    "zero_optimization": {"stage": 3, "offload_param": {
        "device": "cpu", "pin_memory": True, "block_layers": 2},
        "offload_optimizer": {"device": "cpu"}},
    "steps_per_print": 0, "seed": 0}
INFINITY_SEQ = 2048
INFINITY_DEPTHS = (4, 8)
#: the device peak at the deeper body within this share of the shallower
INFINITY_PEAK_TOL = 0.05


def infinity_engine(cfg, n_layers, config, device="cuda"):
    """A ``ZeroInfinityEngine`` through ``initialize`` on a
    ``PipelineModule`` of the embedding, ``n_layers`` ``InfinityLayer``s
    and the head (random weights from seed 0, made on the device)."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.layers import cross_entropy_loss
    from deepspeed_tpu_torch.pipe import LayerSpec, PipelineModule

    torch.manual_seed(0)
    with torch.device(device):
        module = PipelineModule(
            [LayerSpec(InfinityEmbed, cfg.vocab_size, cfg.hidden_size),
             *[LayerSpec(InfinityLayer, cfg) for _ in range(n_layers)],
             LayerSpec(InfinityHead, cfg)],
            num_stages=1, loss_fn=cross_entropy_loss)
    engine, *_ = dt.initialize(model=module, config=dict(config),
                               device=device)
    del module
    gc.collect()
    return engine


def infinity_steps(engine, batch, n, prefetch):
    """``n`` steps; returns the losses, each step's timings and the h2d
    bytes, and the device peak over them."""
    engine.prefetch = prefetch
    engine.track_device_memory = True
    losses, timings, peak = [], [], 0
    for _ in range(n):
        losses.append(float(engine.train_batch(batch=batch)))
        timings.append(dict(engine.timings, h2d_bytes=engine.h2d_bytes))
        peak = max(peak, engine.last_peak_device_bytes)
    return losses, timings, peak


def check_infinity(device="cuda"):
    """(b) ``ZeroInfinityEngine`` (through ``initialize`` with a
    ``PipelineModule``) on Llama-3-8B's widths: an embedding, N decoder
    layers and the head, ``offload_param: cpu`` with blocks of 2, at N in
    ``INFINITY_DEPTHS``: 2 steps with the copy stream's prefetch (the first
    a warm-up), 1 without; finite losses, the device peak at the deepest N
    within 5% of the shallowest's (the streamed body's size does not reach
    the card). Then one full-NVMe step at the shallowest N (both offload
    devices ``nvme`` on the local disk under ``TMPDIR``): the moments'
    bytes read and written, counted at the aio handles (both moments of
    every master, each way), with a lower bound on their GB/s, and the
    swap files' size. K1 (forward and
    recompute) and K2 launched N times each a step. Returns the wrappers'
    counts by run."""
    from deepspeed_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.llama3_8b()
    rs = np.random.RandomState(8)
    ids = rs.randint(0, cfg.vocab_size, (1, INFINITY_SEQ))
    batch = {"inputs": torch.as_tensor(ids), "labels": torch.as_tensor(ids)}
    names = ["flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv"]
    runs, peaks, problems = {}, {}, []
    for N in INFINITY_DEPTHS:
        t0 = time.perf_counter()
        engine = infinity_engine(cfg, N, INFINITY_CONFIG, device)
        init_s = time.perf_counter() - t0
        zero_generic_launches()
        on_losses, on_t, on_peak = infinity_steps(engine, batch, 2, True)
        counts = {n: generic_launches()[n] for n in names}
        off_losses, off_t, off_peak = infinity_steps(engine, batch, 1, False)
        # one block's copy to the card alone: the pinned H2D rate
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        sync()
        t = time.perf_counter()
        engine._fetch(0, 0, False)
        sync()
        block_s = time.perf_counter() - t
        block_bytes = sum(x.numel() * x.element_size()
                          for x in engine.host_blocks[0].values())
        losses = on_losses + off_losses
        peaks[N] = max(on_peak, off_peak)
        runs[f"n{N}"] = counts
        rec = {"layers": N, "block_layers": engine.block_layers,
               "body_gb": engine.body_param_bytes() / 1e9,
               "resident_gb": engine.device_resident_bytes() / 1e9,
               "init_s": init_s, "losses": losses,
               "step_prefetch": on_t[1], "step_no_prefetch": off_t[0],
               "h2d_block_gbs": block_bytes / block_s / 1e9,
               "streamed_bytes_a_step": on_t[1]["h2d_bytes"],
               "device_peak_gib": peaks[N] / 2 ** 30,
               "peak_prefetch_gib": on_peak / 2 ** 30,
               "peak_no_prefetch_gib": off_peak / 2 ** 30,
               "launches_2_steps": counts, "rss_gib": _rss_bytes() / 2 ** 30}
        log(f"infinity {json.dumps(rec)}")
        if not all(np.isfinite(losses)):
            problems.append(f"N {N}: losses {losses}")
        want = {n: 2 * 2 * N if n == "flash_attention_fwd" else 2 * N
                for n in names}
        if counts != want:
            problems.append(f"N {N}: launches {counts} != {want}")
        del engine
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    lo, hi = peaks[INFINITY_DEPTHS[0]], peaks[INFINITY_DEPTHS[-1]]
    log(f"infinity peak N {INFINITY_DEPTHS[0]} {lo / 2 ** 30:.3f} GiB, N "
        f"{INFINITY_DEPTHS[-1]} {hi / 2 ** 30:.3f} GiB: ratio {hi / lo:.4f}")
    if hi > (1 + INFINITY_PEAK_TOL) * lo:
        problems.append(f"device peak grew {hi / lo:.3f}x with the body")
    # full NVMe: the body, the masters, the moments and the grads on disk
    swap = tempfile.mkdtemp(prefix="chip_smoke_nvme_")
    try:
        config = json.loads(json.dumps(INFINITY_CONFIG))
        zc = config["zero_optimization"]
        zc["offload_param"].update(device="nvme", nvme_path=swap)
        zc["offload_optimizer"] = {"device": "nvme",
                                   "nvme_path": os.path.join(swap, "opt")}
        N = INFINITY_DEPTHS[0]
        t0 = time.perf_counter()
        engine = infinity_engine(cfg, N, config, device)
        init_s = time.perf_counter() - t0
        zero_generic_launches()
        io0 = engine._host_opt.swap_io()
        losses, t, peak = infinity_steps(engine, batch, 1, True)
        io = {k: v - io0[k] for k, v in engine._host_opt.swap_io().items()}
        runs["nvme"] = {n: generic_launches()[n] for n in names}
        n_all = sum(m.numel() for m in engine._host_opt.master)
        n_body = engine.body_param_bytes() // 2
        on_disk = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(swap) for f in fs)
        # the moments' IO, counted at the aio handles: bytes over the
        # seconds from submission to the fencing wait (a lower bound on
        # the rate: the ops end inside that span). The memory-mapped
        # masters, the body's fp32 grads and its bf16 staging go through
        # the page cache, which this file system gives no counts for: their
        # bytes are the layout's (masters read and written, grads written
        # then read, staging read by the stream and rewritten), no rate
        mapped = 8 * n_all + 8 * n_body + 4 * n_body
        rec = {"layers": N, "init_s": init_s, "losses": losses,
               "step": t[0], "swap_bytes_on_disk": on_disk,
               "moment_io": io,
               "moment_read_gbs_at_least":
                   io["read_bytes"] / io["read_inflight_s"] / 1e9,
               "moment_write_gbs_at_least":
                   io["write_bytes"] / io["write_inflight_s"] / 1e9,
               "memmap_bytes_touched_layout": mapped,
               "device_peak_gib": peak / 2 ** 30,
               "launches": runs["nvme"]}
        log(f"infinity full nvme {json.dumps(rec)}")
        if not all(np.isfinite(losses)):
            problems.append(f"full nvme: losses {losses}")
        if io["read_bytes"] != 8 * n_all or io["write_bytes"] != 8 * n_all:
            problems.append(f"full nvme: moment io {io} != {8 * n_all} "
                            f"bytes each way")
        del engine
        gc.collect()
    finally:
        import shutil

        shutil.rmtree(swap, ignore_errors=True)
    if problems:
        raise AssertionError("infinity: " + "; ".join(problems))
    return runs


def check_offload():
    """Items 15-17: the host ops, ZeRO-Offload on Llama-3-8B's widths,
    ZeRO-Infinity. Returns the K1/K2 launches of (a) and (b) and the host
    ops' numbers."""
    copy_gbs, host = check_host_ops()
    gc.collect()
    a = check_offload_train(copy_gbs)
    gc.collect()
    torch.cuda.empty_cache()
    b = check_infinity()
    return {"offload": a, "infinity": b, "host_ops": host}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    from deepspeed_tpu_torch.ops import _build

    t = time.perf_counter()
    _build.build()
    log(f"build: {', '.join(_build.sources())} in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _build.build_host()
    log(f"build host: {', '.join(_build.HOST_LIBS)} (g++) in "
        f"{time.perf_counter() - t:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()

    def phase(fn, *args):
        """``fn(*args)``, its seconds logged; the card's cache emptied
        after it."""
        t = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s "
            f"(script {time.perf_counter() - start:.1f} s)")
        return out

    ragged = phase(check_ragged_attention)
    paged = phase(check_paged_attention)
    flash, flash_masked = phase(check_flash_attention)
    adam = phase(check_fused_adam)
    decode = phase(check_decode_attention)
    quant, int8_col = phase(check_quant_matmul)
    sparse = phase(check_block_sparse_attention)
    phase(check_small_reference)
    phase(check_small_legacy_reference)
    tf32_launches = phase(check_small_generate_reference)
    phase(check_small_train_reference)
    serve_launches, serve_runs = phase(check_serving)
    legacy_launches, legacy_replayed = phase(check_serving_legacy)
    gen_launches, gen_decode = phase(check_generate)
    train_launches, train_replayed = phase(check_training)
    subset_runs, _ = phase(check_train_subset)
    phase(check_checkpoint)
    sparse_launches = phase(check_long_context)
    hf_runs = phase(check_hf_inject, serve_runs["uncaptured"]["tokens"])
    generic_runs = phase(check_generic)
    family_runs = phase(check_families)
    megatron_runs = phase(check_megatron)
    mixtral_runs = phase(check_mixtral)
    moe_runs = phase(check_moe_train)
    offload_runs = phase(check_offload)

    def generic_run_launches(name):
        """A kernel's launches in each generic families run that ran it."""
        return {run: counts[name] for run, counts in generic_runs.items()
                if counts.get(name)}

    def hf_inject_launches(name):
        """A kernel's launches in each hf inject run that ran it."""
        return {run: counts[name] for run, counts in hf_runs.items()
                if counts.get(name)}

    def phase_launches(name):
        """A serving kernel's launches in the spec serve and kv tier
        phases: the wrappers' counts over their uncaptured runs (the spec
        serve's first, the two-program tier run) and, for K6, its device
        runs over every run, replays included."""
        spec, tier = serve_runs["spec"]["launches"], \
            serve_runs["tier"]["launches"]
        out = {"spec_serve_launches": {
            "wrapper": spec["wrapper"] if name == "ragged_paged_attention"
            else 0},
            "kv_tier_launches": {"wrapper": tier["wrapper"][name]}}
        if name == "ragged_paged_attention":
            out["spec_serve_launches"]["device"] = spec["device"]
            out["kv_tier_launches"]["device"] = tier["device"]
        return out

    main_case = ragged["bf16/mixed"]
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/ragged_attention.py:64",
        "launches": serve_launches,
        "max_abs_err": max(r["max_abs_err"] for r in ragged.values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
        "hf_inject_launches": hf_inject_launches("ragged_paged_attention"),
        **phase_launches("ragged_paged_attention"),
    }]
    # K7a and K7b: launches of the two-program serve with the prefix cache;
    # graph_launches: their runs in its captured engine's profiled replays
    decode_src = "deepspeed_tpu/ops/pallas/decode_attention.py"
    for name, kind, main_name, line in (
            ("paged_decode_attention", "decode", PAGED_DECODE_MAIN, 254),
            ("paged_prefill_attention", "prefill", PAGED_PREFILL_MAIN, 425)):
        kernels.append(dict(
            name=name, route="cuda",
            source="deepspeed_tpu_torch/csrc/paged_attention.cu",
            replaces=f"{decode_src}:{line}",
            launches=legacy_launches["chunked+prefix_cache"][name],
            graph_launches=legacy_replayed["chunked+prefix_cache"][name],
            hf_inject_launches=hf_inject_launches(name),
            **phase_launches(name),
            **dict(paged[kind][main_name], max_abs_err=max(
                r["max_abs_err"] for r in paged[kind].values()))))
    flash_src = "deepspeed_tpu/ops/pallas/flash_attention.py"
    # K1's masked mode: launches of the two-program serve's monolithic
    # prefills (the 8B generate with the flag adds one per layer)
    kernels.append(dict(
        name="flash_attention_fwd_masked", route="cuda",
        source="deepspeed_tpu_torch/csrc/flash_attention.cu",
        replaces=f"{flash_src}:41",
        launches=legacy_launches["monolithic+flash"][
            "flash_attention_fwd_masked"],
        graph_launches=legacy_replayed["monolithic+flash"][
            "flash_attention_fwd_masked"],
        hf_inject_launches=hf_inject_launches("flash_attention_fwd_masked"),
        **dict(flash_masked[FLASH_MASKED_MAIN], max_abs_err=max(
            r["max_abs_err"] for r in flash_masked.values()))))
    # K1/K2/K3's graph_launches: their device runs in the train phase's
    # profiled replay plus those of the train subset's captured routes
    # (graph_launches_by_phase names each)
    def train_graph_runs(name):
        by_phase = {"train": train_replayed[name]}
        by_phase.update({phase: runs.get(name, 0)
                         for phase, runs in subset_runs.items()})
        return dict(graph_launches=sum(by_phase.values()),
                    graph_launches_by_phase=by_phase)

    for name, part, line in (("flash_attention_fwd", "fwd", 41),
                             ("flash_attention_bwd_dq", "dq", 175),
                             ("flash_attention_bwd_dkv", "dkv", 221)):
        kernels.append(dict(
            name=name, route="cuda",
            source="deepspeed_tpu_torch/csrc/flash_attention.cu",
            replaces=f"{flash_src}:{line}", launches=train_launches[name],
            **train_graph_runs(name),
            **dict(flash[FLASH_MAIN][part], max_abs_err=max(
                r[part]["max_abs_err"] for r in flash.values()))))
    kernels.append(dict(
        name="fused_adam", route="cuda",
        source="deepspeed_tpu_torch/csrc/fused_adam.cu",
        replaces="deepspeed_tpu/ops/pallas/fused_adam.py:37",
        launches=train_launches["fused_adam"],
        **train_graph_runs("fused_adam"), **adam))
    # K4, K5 and K8: launches of the int8-weight 8B generate (K4 runs the
    # same count in the bf16 run; K5's prefill kernel,
    # wgmma_prefill_kernel, is its own entry at the prefill shape; no
    # projection of the path has K8's per-column scales)
    for name, csrc, replaces, results, main_name, launches in (
            ("decode_attention", "decode_attention", "decode_attention.py:36",
             decode, DECODE_MAIN, gen_launches["int8"][0]),
            ("quant_matmul", "quant_matmul", "quant_matmul.py:151", quant,
             QUANT_MAIN, gen_launches["int8"][1]),
            ("quant_matmul_prefill", "quant_matmul", "quant_matmul.py:151",
             quant, QUANT_PREFILL_MAIN, gen_launches["int8"][3]),
            ("int8_matmul", "quant_matmul", "int8_matmul.py:41", int8_col,
             INT8_COL_MAIN, gen_launches["int8"][6])):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"deepspeed_tpu_torch/csrc/{csrc}.cu",
            replaces=f"deepspeed_tpu/ops/pallas/{replaces}",
            launches=launches, hf_inject_launches=hf_inject_launches(name),
            **dict(results[main_name], max_abs_err=max(
                r["max_abs_err"] for r in results.values()))))
    # K5/K8's ragged kernel (rows TMA cannot address): its launches in the
    # int8-weight 8B generate (0: every Llama-3-8B projection is aligned);
    # its decode (M <= 8) and prefill entries are held at the wide ragged
    # cases, each with the worst error of its cases
    from deepspeed_tpu_torch.ops.quant_matmul import GEMV_MAX_ROWS, \
        kernel_route

    def ragged_part(M, K, N, dt):
        if kernel_route(M, K, N, dt) != "ragged":
            return None
        return "decode" if M <= GEMV_MAX_ROWS else "prefill"

    for part, main_name in RAGGED_MAIN.items():
        errs = [quant[n]["max_abs_err"] for n, (M, K, N, _, _, dt)
                in QUANT_CASES.items() if ragged_part(M, K, N, dt) == part]
        errs += [int8_col[n]["max_abs_err"] for n, (M, K, N, dt)
                 in INT8_COL_CASES.items()
                 if ragged_part(M, K, N, dt) == part]
        kernels.append(dict(
            name=f"quant_matmul_ragged_{part}", route="cuda",
            source="deepspeed_tpu_torch/csrc/quant_matmul.cu",
            replaces="deepspeed_tpu/ops/pallas/quant_matmul.py:151",
            launches=gen_launches["int8"][5],
            **dict(quant[main_name], max_abs_err=max(errs))))
    # K5/K8's fp32 decode (gemv_tf32_kernel): no full-width path runs fp32
    # x, so its launches are the small fp32 reference generate's with int8
    # weights (the kernel route's decode steps); held at its int4 case, with
    # the worst error of every fp32 decode case of K5 and K8
    errs = [quant[n]["max_abs_err"] for n, (M, K, N, _, _, dt)
            in QUANT_CASES.items() if kernel_route(M, K, N, dt) == "gemv_tf32"]
    errs += [int8_col[n]["max_abs_err"] for n, (M, K, N, dt)
             in INT8_COL_CASES.items()
             if kernel_route(M, K, N, dt) == "gemv_tf32"]
    kernels.append(dict(
        name="quant_matmul_gemv_tf32", route="cuda",
        source="deepspeed_tpu_torch/csrc/quant_matmul.cu",
        replaces="deepspeed_tpu/ops/pallas/quant_matmul.py:151",
        launches=tf32_launches,
        **dict(quant[GEMV_TF32_MAIN], max_abs_err=max(errs))))
    # K9: launches of the long-context path's eight forward + backward
    # runs, by route: the 64-row slices (six runs at block 128; with the
    # fp32 kernels of the same source, held at the main case) and the
    # 16-row strips (two runs at blocks of 16 and 32, held at DeepSpeed's
    # default config)
    sparse_src = "deepspeed_tpu/ops/pallas/block_sparse_attention.py"
    for route, case, source in (
            ("tiles", SPARSE_MAIN, "block_sparse_attention.cu"),
            ("strips", SPARSE_STRIPS, "block_sparse_strips.cu")):
        for name, part, line in (
                ("block_sparse_attention_fwd", "fwd", 55),
                ("block_sparse_attention_bwd_dq", "dq", 103),
                ("block_sparse_attention_bwd_dkv", "dkv", 143)):
            main_case = dict(sparse[case][part])
            for extra in ("flex_ms", "sdpa_ms", "route"):
                main_case.pop(extra)
            main_case["max_abs_err"] = max(
                r[part]["max_abs_err"] for r in sparse.values()
                if (r[part]["route"] == "strips") == (route == "strips"))
            kernels.append(dict(
                name=name if route == "tiles"
                else name.replace("attention", "strips"),
                route="cuda", source=f"deepspeed_tpu_torch/csrc/{source}",
                replaces=f"{sparse_src}:{line}",
                launches=sparse_launches[name].get(route, 0), **main_case))
    for entry in kernels:
        entry["generic_launches"] = generic_run_launches(entry["name"])
        entry["families_launches"] = {
            run: counts[entry["name"]] for run, counts in family_runs.items()
            if counts.get(entry["name"])}
        # the MoE phases' paths: Megatron's and Mixtral's generate (the
        # masked K1, K4), Mixtral's training (K1, K2, K3) and the moe.MoE
        # training by k (K3)
        name = entry["name"]
        entry["megatron_launches"] = megatron_runs.get(name, 0)
        entry["mixtral_launches"] = mixtral_runs.get(name, 0)
        entry["moe_train_launches"] = {
            "mixtral": moe_runs["mixtral"].get(name, 0),
            **{f"moe_layer_k{k}": runs.get(name, 0)
               for k, runs in moe_runs["moe_layer"].items()}}
        # ZeRO-Offload's first step (eager warm-up and capture) and
        # ZeRO-Infinity's runs (N 4, N 8: two steps each; full NVMe: one)
        entry["offload_launches"] = \
            offload_runs["offload"]["launches"].get(name, 0)
        entry["infinity_launches"] = {
            run: counts.get(name, 0)
            for run, counts in offload_runs["infinity"].items()}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
