#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the fleet monitor, the
control loop that acts on it, the control plane under faults (scenario
matrix, chaos pipeline, QoS soak, fleet rate tracking, data pipeline),
the serving paths of internlm2-1.8b and mamba2-2.7b at full width, the
training path of internlm2-1.8b at full width, the encoder-decoder
(whisper-large-v3, full width) and MoE (phi3.5-moe, published widths at
8 of 32 layers) families, the hybrid (zamba2-7b) and the capped,
windowed attention (gemma2-2b), both at full width, the vlm
(qwen2-vl-72b, published widths at 20 of 80 layers) with M-RoPE, the
sharded step, and the contract analyzer with its lock witness over the
control plane.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with the card and the CUDA
toolkit.  It builds the port's kernels from ``src/repro_torch`` with nvcc
(one nvcc per source, started together), then runs these phases (any
failed check raises and exits non-zero):

1. the card's name and power limit, and the kernels' build time;
2. ``batched_monitor`` at Q = 2e5 windows of w = 32, f32 and bf16, against
   its plain PyTorch version (rtol 1e-4 / 2e-2, atol 500x that);
3. ``monitor_fleet`` at S = 2e5 streams x T = 4096 periods (chunk 256,
   state mode) against the plain version on the card (epochs equal on
   >= 99.9% of streams and never more than 1 apart -- f32 rounding order
   next to the exact convergence test -- and last q-bar to rtol 1e-4
   where epochs agree), against the float64 HostMonitor on 64 sampled
   streams (exact epochs and last q-bar to rtol 1e-4, except where f32
   crosses the exact convergence threshold apart from f64 and the f32
   per-queue run_monitor agrees with the kernel), and in full mode on a
   4096-stream slice against the plain version; then at the service's
   dispatch shape (S, 32) from that mid-stream state, on the time-major
   tile the service passes and on the row-major form, each against the
   plain version (window and fill bit-equal, epochs on >= 99.9%, q-bar
   to 1e-4) and the two layouts bit-equal to each other;
4. the main path: ``FleetMonitorService`` over 1e5 InstrumentedQueues with
   ends="both" (S = 2e5) in one CounterArena for 640 ticks, counts written
   into the arena each tick; it must recover every configured rate within
   5%, converge every stream, and launch ``monitor_fleet`` once per
   dispatch plus the warm-up; then the device time of one dispatch in the
   service's form (the (32, S) staging uploaded as it is and read as its
   time-major view) and, on the host clock, the transpose-copies of that
   staging the service no longer makes;
(a) the control loop at full width: a ``ControlLoop`` over that service
   (the replica, buffer and admission policies, a recording actuator,
   the decision's "jit" form: one CUDA graph, replayed) ticked once after
   each of 10 more dispatches.  Every tick the same sensed operands go
   through the "numpy" form from the same state: every boolean field and
   the replica targets equal, capacity targets only +/-1 slot apart where
   the continuous exponent sits within 1e-5 (relative) of an integer, on
   <= 0.1% of queues; the converged replica targets equal
   clip(ceil(1.2 lam / mu), 1, 64) of the service's gated estimates;
   scale actions fire, no error record, no degradation to numpy, one
   graph build; the loop tick's host time, the decision's device time by
   graph replay and the numpy form's host time;
(b) a ``Pipeline`` on the card: the closed-loop demo (12 000 items through
   a stage that sleeps 0.4 ms an item, control=True, window 16): all items
   come out as x + 1, the stage is scaled (> 1 live replica, an applied
   replicas/scale record), ``monitor_fleet`` launched once per dispatch
   plus the warm-up, no worker crash, no degradation;
5. the per-tick path: ``fleet_monitor_step`` over 2e5 windows for 64 ticks,
   one ``batched_monitor`` launch per tick;
6. ``flash_attention`` against its plain version on the card: the JAX
   package's kernel-test shapes in f32, causal and not (2e-4), and in
   bf16 (the tensor-core kernel; 1e-3) the serving path's shape with
   S = 1000, a masked tail, every head dim, S and T that no tile divides
   with S < T and S > T, GQA groups 1-4, and large scores (q x 4, scale
   1); then timed at the path's shape in turns with PyTorch's
   scaled_dot_product_attention (the kernel must take at most 3x its
   time), and the f32 instance at that shape;
7. the full-width model: internlm2-1.8b (24 layers, d 2048, 16/8 heads,
   hd 128, d_ff 8192, vocab 92 672) with random bf16 weights from
   ``--seed``; a prefill of 8 prompts of 1024 tokens through the kernel
   and again through the plain attention (relative L2 of the last
   logits <= 1e-2, 24 kernel launches per prefill);
8. the serving path: ``serve.Engine`` with the default (blocking,
   nonblocking) lanes answers 16 requests (prompts of 512-1536 tokens,
   16 new tokens each) with no worker crash, ``flash_attention``
   launched 24 times per prefill round and ``monitor_fleet`` on the
   lanes; one request served alone equals a direct prefill + greedy
   decode of its round (the request replicated to the batch of 8); a
   torch.profiler trace of one round splits the device time;
(c) the same 16 requests through ``serve.Engine(control=True)``: each is
   answered or refused with a logged admission record, 24
   ``flash_attention`` launches per prefill round, the loop ticks, no
   error record, no crash, no degradation;
(d) the scenario x policy x fault matrix: ``workloads.run_matrix`` at
   the scenarios' full horizons (24 cells, 94 800 periods), each
   controlled cell a ``ControlGroup`` on the card (``monitor_fleet`` on
   every dispatch, the decision's CUDA graph on every tick): >= 12 cells,
   controlled availability >= 0.9, fault-free vs_static >= 0.95, storm
   vs_static >= 1.2, one graph build per policy config; every cell
   recorded, and the 8 controlled storm cells' traces replayed on the
   host (numpy decision): every boolean and replica target equal,
   capacity targets +/-1 slot on <= 0.1% of decisions;
(e) the supervised chaos pipeline (``control_bench.chaos_recovery``'s
   full mode: 4000 items paced at 1100/s, a 1.5 ms stage of 2 replicas,
   3 seeded kills and a monitor-thread death, a ``ReplicaSupervisor``):
   throughput back to 70% of the fault-free median within 20 windows,
   availability >= 0.9, no unhandled death, no graph recapture;
(f) the QoS soak (``control_bench.qos_soak``'s quick phases) against
   ``Engine(control=True)`` on the card: blocking availability >= 0.9,
   storm p99 <= 2.5x pre-storm, respawns >= crashes, recovered, the
   control log drained to JSONL under ``build/chip_smoke/``;
(g) ``ft.FleetRateTracker`` over 2048 hosts with 16 stragglers (0.3x
   from period 200), as the kernel, the rounds form and the plain
   version on the card: no healthy host ever flagged, exactly the
   stragglers by period 1200, the kernel's state bit-equal to the plain
   version's, ``FaultToleranceManager.assess`` dropping exactly them;
(h) ``data.DataPipeline`` (seq 256, batch 8, vocab 92 672, 64 batches)
   with its links' service on the card: the batches equal a CPU run's,
   the readout the gated formula's;
9. ``ssd_chunk`` against its plain version on the card: the chunked op
   on the JAX package's kernel-test shapes and chunks and the chunk
   kernel at odd shapes (rtol = atol = 1e-4), then at the mamba2
   prefill's shape (B 8, c 4, Q 256, H 80, P 64, N 128) and zamba2's
   (H 112, P 64, N 64), with the test's draws and Mamba-2's init, where
   each output's error is at most 1e-4 of its (b, c, h) slice's largest
   |plain| (decay: of |plain| itself);
10. the full-width ssm model: mamba2-2.7b (64 layers, d 2560, d_inner
   5120, 80 SSD heads x 64, N 128, conv 4, chunk 256, vocab 50 432,
   tied embeddings) with random bf16 weights from ``--seed``; a prefill
   of 8 x 1024 tokens through the kernel and again through the plain
   SSD (relative L2 of the last logits <= 1e-3 in f32, 64 kernel
   launches per prefill), then greedy decode at batch 8;
11. the ssm serving path: phase 8's traffic through ``serve.Engine`` on
   mamba2-2.7b, with ``ssd_chunk`` launched 64 times per prefill round
   and the same checks, and its trace (SSD kernel, GEMMs, conv, copies,
   other);
(i) the training path: ``flash_attention_bwd`` against
   ``attention_bwd_ref`` by relative L2 per output (bf16 at the training
   shape B 2, S = T 4096, H 16, K 8, hd 128, causal, and at every head
   dim with GQA 1-4, S != T both ways, ragged and non-causal, 1e-2;
   float32 at every head dim, non-causal, S != T, tails and an explicit
   scale, 1e-4; the forward's lse against ``attention_lse_ref``; two
   calls equal to the bit; two controls the gate must fail; no ptxas
   spills in its tensor-core kernels at hd 128) and timed in turns with
   SDPA's backward, with a profiler split over its three kernels; the
   gradients of internlm2-1.8b at published widths (random float32
   master weights, B 2 x 1024, remat "full") through the kernels against
   the plain attention (loss rel 1e-3; the backward kernel against the
   plain backward under the same forward, every leaf rel L2 2e-2;
   float32 compute 1e-4; bf16 end to end within 1.5x two 1-ulp controls,
   the bf16 noise floor); ``Trainer.fit`` on the same model with AdamW,
   remat "dots", seq 4096, 2 microbatches of 2 rows from
   ``DataPipeline(SyntheticLMSource)``, 8 steps on one repeated batch
   (finite losses and grad norms, the loss down >= 10%, the history and
   the FT rate monitor fed, one forward and one backward launch a layer
   a microbatch; step ms, tokens/s, MFU, peak memory and a profiler
   split of one step); and a checkpoint resumed at a 2-layer cut with
   AdamW8bit (the step-3 loss equal to the uninterrupted run's, a
   corrupted leaf refused), printed as one ``{"train": ...}`` line;
(j) the encoder-decoder and MoE families.  (j.1) whisper-large-v3 at
   published widths (32 + 32 layers, d 1280, 20 heads x 64, d_ff 5120,
   vocab 51 968) with random bf16 weights and stub frames (8, 1536,
   1280) from ``--seed``, through ``Model.prefill``/``decode_step``: the
   encoder (32 flash launches) and a 4-token prefill (96: encoder,
   decoder self, cross with S 4 != T 1536) through the kernel and the
   plain attention -- encoder states and last logits within rel L2 1e-4
   in float32 compute (the kernel at 1.02 x its scale must miss), and
   in bf16 within max(1e-2, 1.5x a 1-ulp control of the plain path);
   decode agrees with prefill in float32 at full depth (same token,
   logits 1e-4); 64 greedy tokens at batch 8 (encoder, prefill and
   decode ms, tokens/s); the flash forward against the plain version
   (1e-3) at (8, 1536, 20, 20, 64) non-causal, at the cross shape and
   at the decoder's causal self shapes (8 x 4 and 2 x 448, G 1), the
   encoder's timed in turns with SDPA (bound 0.0977 ms by operations).
   (j.2) one gradient of ``whisper_loss`` at published widths (float32
   master weights, frames 2 x 1536, 2 x 448 targets, remat "full") under
   phase (i.2)'s gates and controls: 192 forward and 96 backward launches,
   the backward at hd 64, non-causal, S != T.  (j.3) phi3.5-moe (d 4096,
   32/8 heads x 128, 16 experts top-2 of d_ff 6400, vocab 32 064) cut
   to 8 layers (10.7 B parameters, 21.3 GB bf16): the flash forward
   against the plain version (1e-3) at (8, 1024, 32, 8, 128) causal and
   at a ragged round of 8 x 1479; an 8 x 1024 prefill through the
   kernel and the plain attention (bf16 rel L2 and the
   share of flipped routes reported; gated in float32 at a 2-layer cut,
   rel L2 1e-4, the 1.02 x scale kernel must miss), then phase 8's
   traffic through ``serve.Engine`` (8 flash launches a prefill round,
   ``monitor_fleet`` on the lanes, engine tokens == direct decode) with
   a trace split into flash, GEMMs, sort, gather/scatter, copies and
   other.  One ``{"serve": ...}`` line per model; Whisper's prefill and
   the MoE rounds count into ``flash_attention``'s launches, Whisper's
   gradient into ``flash_attention_bwd``'s;
(k) the hybrid family and the capped, windowed attention.  (k.1) the
   forward's new instances against the plain version (bf16 1e-3, f32
   2e-4): hd 112 at zamba2's (8, 1024, 32, 32, 112) causal and a ragged
   8 x 1479, timed in turns with SDPA (bound 0.0876 ms by bytes); hd 256
   at gemma2's (2, 8192, 8, 4, 256) causal with softcap 50, windowed
   (4096; bound 0.417 ms by operations) and not (0.556 ms), beside SDPA
   without cap or window (not the same function); the kernel at 1.02 x
   scale, with its window off and with its softcap off must miss the
   gate; ptxas must report no spills in the tensor-core forward.
   (k.2) zamba2-7b at published widths (81 layers as 9 x (8 mamba + the
   shared block), d 3584, 32 x 112 heads, d_ff 14 336; 6.05 B
   parameters, 12.1 GB bf16) with random bf16 weights: an
   8 x 1024 prefill through the kernels (9 flash, 72 SSD launches) and
   the plain versions, gated in float32 at a 2-group cut (rel L2 1e-3,
   and 1e-4 with the SSD plain on both sides, which the flash kernel at
   1.02 x scale must miss), then phase 8's traffic
   through ``serve.Engine`` (engine tokens == direct decode,
   ``monitor_fleet`` on the lanes); init and prefill peak memory.
   (k.3) gemma2-2b at published widths (26 layers, d 2304, 8/4 heads x
   256, d_ff 9216, vocab 256 000) through ``Model.prefill``/
   ``decode_step``: a 2 x 8192 prefill through the kernel and the plain
   attention (26 flash launches, 13 windowed), gated in float32 at a
   2-layer cut (rel L2 1e-4; window-off and 1.02 x scale controls must
   miss), f32 decode vs a prefill one token longer (same token, 1e-4),
   16 greedy tokens in bf16.  The zamba2 and gemma2 launches count into
   ``flash_attention``'s and ``ssd_chunk``'s, one ``{"serve": ...}``
   line each, the instances' times in a ``{"flash_instances": ...}``
   line;
(l) the vlm family: qwen2-vl-72b at published widths (d 8192, 64/8
   heads x 128, d_ff 29 568, vocab 152 064, M-RoPE sections (16, 24, 24)
   of 64, theta 1e6) cut to 20 of 80 layers (20.04 B parameters, 40.1 GB
   bf16), random weights and stub patch embeddings (8, 1024, 8192) from
   ``--seed``.  The flash forward against the plain version (1e-3) at its
   (8, 1024, 64, 8, 128) causal and a ragged 8 x 1479; (l.1) layer 0's
   attention over a 32 x 32 patch grid and 256 text tokens, its (t, h,
   w) streams distinct, kernel vs plain rel L2 <= 1e-3 in bf16 and
   <= 2e-4 in float32, the h and w streams swapped must miss; (l.2) an
   8 x 1024 prefill from the embeddings through the kernel (20 launches)
   and the plain attention, gated in float32 at a 2-layer cut (rel L2
   1e-4, the 1.02 x scale control must miss), decode after it against a
   prefill one row longer (same token, 1e-4); (l.3) phase 8's traffic on
   text prompts through ``serve.Engine``; init and prefill peak memory;
   one ``{"serve": ...}`` line, its launches counted into
   ``flash_attention``'s.  The prefill's and phase (i)'s training step's
   ``roofline.analysis.roofline_report`` over ``roofline.analytic``'s
   FLOPs and bytes (compute and memory terms at the H100's peaks, the
   dominant one, and the measured time as a share of the bound) in a
   ``{"roofline": ...}`` line; the trainer's MFU takes its numerator from
   ``roofline.analysis.model_flops`` and its peak from its ``HW``;
(m) the sharded step: (m.1) ``launch.dryrun.lower_cell`` on the host
   for internlm2-1.8b x train_4k x single pod (256 ranks), phi3.5-moe x
   prefill_32k x single (the MoE mesh, through ``moe_block_ep``) and
   qwen2-vl-72b x decode_32k x multi-pod (512 ranks), each on a fake
   world and meta DTensors: all three must be ok; per cell the peak GB a
   rank, the dominant term, the roofline fraction and the collective
   bytes by op; (m.2) on an NCCL world of one rank, a (data 1, model 1)
   mesh: phase 7's internlm2 prefill (8 x 1024, random bf16 weights)
   with DTensor parameters placed by ``placements_for``, ``constrain``
   live (74 calls on DTensors) and the flash kernel on the local shards
   through the operator's registered sharding: last logits within rel
   L2 1e-6 of the unsharded prefill in the same process, the same 24
   flash launches, none under ``kernel_impl="plain"``, timed in turns
   with the unsharded prefill; (m.3) ``moe_block_ep`` against
   ``moe_block`` on a (1, 1, 1) MoE mesh at phi3.5-moe's published
   widths, one layer, float32, capacity_factor 4.0: y within 1e-4 and
   the probs within 1e-5 max-abs at (8, 1024) and at decode (8, 1), its
   NCCL all-reduce counted, device times beside ``moe_block``'s.  One
   ``{"sharded": ...}`` line; (m.2)'s launches count into
   ``flash_attention``'s;
(n) the contract analyzer and the lock witness: (n.1) ``python -m
   repro_torch.analysis -q src/repro_torch`` in this process
   (``analysis.__main__.main``) must return 0 against the shipped
   baseline, its summary line printed; (n.2) a ``LockWitness`` activated
   before anything of the phase is built, over one storm cell of the
   matrix through ``workloads.harness.run_cell`` (a ``ControlGroup``,
   ``ControlLoop``, ``FleetMonitorService``, ``CounterArena``,
   ``monitor_fleet`` on each dispatch, the decision's CUDA graph on each
   tick) and one supervised chaos pipeline of ``chaos_runs`` at
   ``WITNESS_CHAOS_ITEMS`` items: it must record no hazard, must have
   wrapped locks of every rank 0-4 (printed per level), and must record
   the control -- an arena-rank lock of the run taken, then a
   service-rank one.  Not armed over the timed phases (d)-(f).  One
   ``{"analysis": ...}`` line; (n.2)'s launches count into
   ``monitor_fleet``'s;
12. each kernel timed with CUDA events at its path's shape beside its plain
   version, its bound, the PyTorch library call where there is one and
   its launches, as one JSON line; the two monitor kernels, whose device
   time is near or below a call's host cost from Python, by the replay of
   a CUDA graph of many calls on inputs that together exceed the L2
   cache (``graph_ms``), with the row-major form, the SASS issue
   estimate of the fold, bf16, warm-cache and per-call times in the
   ``service`` line; phases (a)-(c) in the ``control`` line, (d)-(h) in
   the ``faults`` line, and ``monitor_fleet``'s launches summed over
   phase 4, (d)-(h) and (n.2); before them a ``{"wall_s": ...}`` line with each
   group of phases' wall time (host clock) and the total.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Inputs come from ``--seed`` through numpy.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bandwidth, the
# float32 rate outside the tensor cores and the bf16 and TF32 tensor-core
# rates
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12

N_STREAMS = 200_000          # the repo's realistic fleet size (ends)
N_PERIODS = 4096
CHUNK = 256
SVC_CHUNK = 32
SVC_TICKS = 640
CTL_TICKS = 320              # the control phase: 10 more dispatches
PIPE_ITEMS = 12_000          # the closed-loop pipeline demo's items
STEP_TICKS = 64
WINDOW_Q = 200_000

ARCH = "internlm2-1.8b"      # the model of the JAX package's serving test
SERVE_B = 8                  # batch of a generation round
PREFILL_S = 1024             # prompt length of the model phase
SERVE_MAX_SEQ = 2048
SERVE_REQS = 16              # half per QoS class
SERVE_NEW = 16               # new tokens per request
PROMPT_LENS = (512, 1536)    # served prompt lengths, uniform
PROFILE_STEPS = 4            # decode steps in a serving path's trace (8
                             # until phase (l) came: the run's time)
FLASH_SHAPE = (8, 1024, 16, 8, 128)   # the prefill's attention (B,S,H,K,hd)
SSM_ARCH = "mamba2-2.7b"     # the repo's pure-ssm configuration
SSD_SHAPE = (8, 4, 256, 80, 64, 128)  # its prefill's chunk step (B,c,Q,H,P,N)
CHAOS_ITEMS = 4000           # the chaos pipeline's items (bench full mode)
CHAOS_MAX_REPLICAS = 16      # run_cell's own replica cap (see chaos_runs)
WITNESS_CHAOS_ITEMS = 2500   # phase (n.2)'s chaos run: ~2.3 s a run, past
#                              the plan's last fault (crashes by 2.0 s)
SOAK_PHASES = (1.2, 1.6, 1.2)  # the soak's pre/storm/post s (bench quick)
TRACKER_HOSTS = 2048         # a 16 384-GPU cluster at 8 GPUs a host
TRACKER_PERIODS = 1200       # the phase change at 200, then 1000 periods
TRACKER_CHANGE = 200
TRACKER_STRAGGLERS = 16
DATA_SEQ, DATA_BATCH = 256, 8   # examples/train_lm.py's defaults
DATA_VOCAB = 92_672          # internlm2's vocabulary
DATA_BATCHES = 64
BWD_SHAPE = (2, 4096, 16, 8, 128)  # the training path's attention (B,S,H,K,hd)
GRAD_B, GRAD_S = 2, 1024     # the model-gradient check (remat full)
TRAIN_SEQ = 4096             # SHAPES["train_4k"]'s length
TRAIN_MICRO, TRAIN_ROWS = 2, 2   # global batch 4 (train_4k's 256, cut)
TRAIN_STEPS = 8
CKPT_B, CKPT_S = 2, 512      # the checkpoint-resume cut (2 layers)
WHISPER_ARCH = "whisper-large-v3"
WHISPER_PROMPT = 4           # decoder prompt tokens of the serving check
WHISPER_NEW = 64             # greedy tokens after the prompt
WHISPER_MAX_SEQ = 448        # Whisper's decoder context (n_text_ctx)
WHISPER_GRAD_B, WHISPER_GRAD_S = 2, 448   # the gradient check's targets
WHISPER_FLASH_SHAPE = (8, 1536, 20, 20, 64)  # its encoder's attention
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 8               # of 32: 21.3 GB of bf16 weights (16 until
                             # phase (l) came: the run's time)
MOE_ROUND_S = 1479           # a ragged round length (prompts 512-1536)
MOE_F32_LAYERS = 2           # the float32 gate's cut (10.5 GB of weights)
ZAMBA_ARCH = "zamba2-7b"
ZAMBA_FLASH_SHAPE = (8, 1024, 32, 32, 112)   # its shared attention's prefill
ZAMBA_SSD_SHAPE = (8, 4, 256, 112, 64, 64)   # its prefill's chunk step
ZAMBA_F32_GROUPS = 2         # the float32 gate's cut (16 mamba layers)
GEMMA_ARCH = "gemma2-2b"
GEMMA_FLASH_SHAPE = (2, 8192, 8, 4, 256)     # 2 x its published context
GEMMA_NEW = 16               # decode steps after the 8192-token prefill
GEMMA_F32_LAYERS = 2         # the float32 gate's cut: one local, one global
VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 20              # of 80: 40.1 GB of bf16 weights, room left for
                             # the init's f32 draw of a stacked leaf (19.4 GB)
VLM_F32_LAYERS = 2           # the float32 gate's cut (17 GB of weights)
VLM_GRID = (32, 32)          # (l.1)'s patch grid, then VLM_TEXT text tokens
VLM_TEXT = 256
# (m.1) the dry run's cells: (arch, shape, multi-pod)
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k", False),
                ("phi3.5-moe-42b-a6.6b", "prefill_32k", False),
                ("qwen2-vl-72b", "decode_32k", True))
MOE_EP_SHAPES = ((8, 1024), (8, 1))   # (m.3) (B, S): prefill, decode


class CheckFailed(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def noisy_streams(rng, Q, T, p_block=0.06):
    """The recipe of the monitor's parity tests, at scale: Poisson counts
    at per-stream rates uniform on 100-400 items/period, 6% blocked."""
    base = rng.uniform(100, 400, (Q, 1)).astype(np.float32)
    tc = rng.poisson(base, (Q, T)).astype(np.float32)
    blocked = rng.random((Q, T), dtype=np.float32) < p_block
    return tc, blocked


def noisy_streams_on_card(torch, seed, Q, T, dev, p_block=0.06):
    """``noisy_streams``' recipe drawn on the card from ``seed``: a numpy
    draw of 8e8 Poisson counts takes about a minute of host time."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.rand((Q, 1), generator=g, device=dev) * 300.0 + 100.0
    tc = torch.poisson(base.expand(Q, T).contiguous(), generator=g)
    blocked = torch.rand((Q, T), generator=g, device=dev) < p_block
    return tc, blocked


def event_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(torch, fns, reps: int) -> float:
    """Mean device time of a call: ``reps`` calls, taking the functions
    ``fns`` in turn, captured in one CUDA graph and replayed, so the
    host's cost of each call from Python (the wrapper's checks,
    allocations and the launch) does not enter.  Functions on inputs
    that together exceed the 50 MB L2 cache find them in device memory,
    as the bound assumes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:                        # build, load, allocate
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def clone_state(state):
    return type(state)(*(a.clone() for a in state))


# ---------------------------------------------------------------------------

def phase_batched(torch, K, ref, rng, dev):
    """Kernel vs plain version at the per-tick path's shape."""
    win = rng.uniform(0, 500, (WINDOW_Q, 32)).astype(np.float32)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.as_tensor(win, device=dev).to(dtype)
        got = K.batched_monitor(x)
        want = ref.batched_monitor_ref(x)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            d = (g - w).abs()
            bound = tol * 500 + tol * w.abs()
            check(bool((d <= bound).all()),
                  f"batched_monitor {dtype} disagrees: max err "
                  f"{float(d.max())}")
            err = max(err, float(d.max()))
        errs[str(dtype).split(".")[-1]] = err
        log(f"batched_monitor {dtype}: max abs err {err:.3e} "
            f"(tol rtol {tol} atol {tol * 500})")
    return errs


def phase_fleet(torch, K, M, ref, rng, dev, seed):
    """Fused scan at S = 2e5 x T = 4096 against the plain version on the
    card, the float64 host monitor, and full mode on a slice."""
    cfg = M.MonitorConfig()
    tc_d, blk_d = noisy_streams_on_card(torch, seed, N_STREAMS, N_PERIODS,
                                        dev)
    t0 = time.perf_counter()
    st_k, _ = M.run_monitor_fleet(cfg, tc_d, blk_d, chunk_t=CHUNK,
                                  impl="cuda", mode="state", device=dev)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_r, _ = M.run_monitor_fleet(cfg, tc_d, blk_d, chunk_t=CHUNK,
                                  impl="scan", mode="state", device=dev)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    ep_k, ep_r = st_k.epoch.cpu().numpy(), st_r.epoch.cpu().numpy()
    agree = ep_k == ep_r
    frac = float(agree.mean())
    worst = int(np.abs(ep_k - ep_r).max())
    lk, lr = st_k.last_qbar.cpu().numpy(), st_r.last_qbar.cpu().numpy()
    rel = np.abs(lk - lr)[agree] / np.maximum(np.abs(lr[agree]), 1e-30)
    log(f"monitor_fleet S={N_STREAMS} T={N_PERIODS}: kernel {t_kernel:.3f} s,"
        f" plain {t_plain:.3f} s (host clock, incl. compaction); epochs "
        f"equal on {frac * 100:.4f}% (max diff {worst}); mean epoch "
        f"{ep_k.mean():.2f}; last q-bar max rel err {rel.max():.3e}")
    check(frac >= 0.999, f"epochs agree on only {frac:.5f} of streams")
    check(worst <= 1, f"epochs differ by {worst}")
    check(float(rel.max()) <= 1e-4, f"last q-bar rel err {rel.max()}")
    check(ep_k.min() >= 1, "a stream never converged")

    # float64 host oracle on 64 sampled streams: exact epochs and last
    # q-bar to rtol 1e-4.  Over 4096 periods a stream can cross the exact
    # convergence threshold in float32 one step apart from float64 (the
    # JAX package's own f32 scan does so on stream 184271 of the numpy
    # draw of seed 0: 56 epochs against the host's 57).  Such a stream
    # passes only if an independent f32 implementation -- the per-queue
    # run_monitor on the host -- lands on the kernel's epoch count and
    # estimate.
    pick = rng.choice(N_STREAMS, 64, replace=False)
    rows = torch.as_tensor(pick, device=dev)
    tc, blocked = (dict(zip(pick, t[rows].cpu().numpy()))
                   for t in (tc_d, blk_d))
    f32_only = []
    for q in pick:
        hm = M.HostMonitor(cfg)
        for t, b in zip(tc[q], blocked[q]):
            hm.update(float(t), bool(b))
        if (hm.epoch == int(ep_k[q])
                and abs(float(lk[q]) - hm.last_qbar)
                <= 1e-4 * abs(hm.last_qbar)):
            continue
        out = M.run_monitor(cfg, tc[q], blocked[q], device="cpu")
        e32, l32 = int(out.epoch[-1]), float(out.estimate[-1])
        check(e32 == int(ep_k[q]) and abs(hm.epoch - e32) <= 1
              and abs(float(lk[q]) - l32) <= 1e-4 * abs(l32),
              f"stream {q}: kernel epoch {ep_k[q]} q-bar {lk[q]}, host "
              f"f64 {hm.epoch} {hm.last_qbar}, run_monitor f32 {e32} {l32}")
        f32_only.append((int(q), int(ep_k[q]), hm.epoch))
    log(f"monitor_fleet vs float64 HostMonitor on 64 streams: "
        f"{64 - len(f32_only)} exact; {len(f32_only)} where f32 crosses the "
        f"threshold apart from f64 and the f32 run_monitor agrees with the "
        f"kernel {f32_only}")

    # full mode on a 4096-stream slice
    n = 4096
    _, out_k = M.run_monitor_fleet(cfg, tc_d[:n], blk_d[:n], chunk_t=CHUNK,
                                   impl="cuda", mode="full", device=dev)
    _, out_r = M.run_monitor_fleet(cfg, tc_d[:n], blk_d[:n], chunk_t=CHUNK,
                                   impl="scan", mode="full", device=dev)
    same = (out_k.epoch == out_r.epoch).all(dim=1)
    check(float(same.float().mean()) >= 0.999,
          "full mode: epoch planes differ on > 0.1% of streams")
    check(bool((out_k.converged[same] == out_r.converged[same]).all()),
          "full mode: convergence flags differ")
    for name in ("q", "qbar", "estimate"):
        a, b = getattr(out_k, name)[same], getattr(out_r, name)[same]
        check(bool(((a - b).abs() <= 1e-3 + 1e-4 * b.abs()).all()),
              f"full mode: {name} plane disagrees")
    log(f"monitor_fleet full mode, {n} streams: planes agree on "
        f"{float(same.float().mean()) * 100:.3f}% of streams")
    return st_k


def fleet_bound(Q, T, m, W, CW):
    """Least bytes and operations of one state-mode dispatch on these
    inputs: streams with a valid sample read their tile row, m and the
    state once and write the state once; the rest read only m."""
    m = m.cpu().numpy()
    live = int((m > 0).sum())
    state_bytes = 4 * (W + 2 * CW + 2 + 6)
    nbytes = live * (4 * T + 2 * state_bytes) + 4 * Q
    # per valid step: 5-tap stencil (9), centring (1), two ladder sums of
    # N=W-4 terms (2N-2 adds, N squares), mean/var/sd/q (7), Welford (7),
    # q-bar window std (2*CW + 2*CW + 4), LoG response (5), max|.| (CW),
    # tolerance and test (4); plus the centring pass: 9 per filtered value
    n_win = W - 4
    per_step = 9 + 1 + (3 * n_win - 2) + 7 + 7 + (4 * CW + 4) + 5 + CW + 4
    flops = float(m.sum()) * per_step + live * (W + T - 4) * 9
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def sass_step_instructions(lib, kernel):
    """Static SASS instructions of one step of the fleet kernel's fold:
    the innermost loop of ``kernel`` (a substring of its mangled name)
    that holds a square root, counted from ``cuobjdump -sass`` of the
    built library.  Every branch of the step is in the count (the
    ready/converged paths included), the out-of-line slow paths of
    division and square root are not.  None where cuobjdump is missing
    or the loop is not found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs if f.split("\n", 1)[0].find(kernel) >= 0),
                None)
    if body is None:
        return None
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    sqrt_at = [a for a, op in ins if "MUFU.RSQ" in op or "MUFU.SQRT" in op]
    best = None
    for a, op in ins:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
        if not m or int(m.group(1), 16) >= a:
            continue
        lo = int(m.group(1), 16)
        if not any(lo <= x <= a for x in sqrt_at):
            continue
        if best is None or a - lo < best[1] - best[0]:
            best = (lo, a)
    if best is None:
        return None
    return sum(1 for a, _ in ins if best[0] <= a <= best[1])


def issue_ms(torch, instructions, steps):
    """Least time to issue ``instructions`` per step over ``steps``
    queue-steps: one warp instruction per scheduler per cycle, 4
    schedulers an SM, at the card's maximum SM clock."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return instructions * steps / 32 / (sms * 4 * mhz * 1e6) * 1e3


def _fleet_gate(torch, what, st_k, carry, win_r):
    """The kernel's state after one dispatch against the plain version's:
    window and fill bit-equal, epochs equal on >= 99.9% of streams, q-bar
    within 1e-4 of the largest |q-bar| where epochs agree.  Returns the
    largest error."""
    (s_fill, count, mean, m2, qh, sh, rh, epoch, last) = carry
    agree = (st_k.epoch == epoch)
    check(float(agree.float().mean()) >= 0.999,
          f"{what}: epochs differ on > 0.1% of streams")
    check(bool(torch.equal(st_k.win, win_r)), f"{what}: window carry differs")
    check(bool(torch.equal(st_k.s_fill, s_fill)), f"{what}: s_fill differs")
    err = max(float((st_k.mean - mean)[agree].abs().max()),
              float((st_k.last_qbar - last)[agree].abs().max()))
    tol = 1e-4 * float(mean.abs().max())
    check(err <= tol, f"{what}: q-bar err {err} > {tol}")
    log(f"monitor_fleet {what}: max abs err {err:.3e} (tol {tol:.3e})")
    return err


def _staged_tile(torch, ops, rng, T, dev):
    """A (S, T) tile as the service stages it -- (T, S) on the card --
    compacted as the service's time-major view and as a row-major copy."""
    tc, blocked = noisy_streams(rng, N_STREAMS, T)
    tc_s = torch.as_tensor(np.ascontiguousarray(tc.T), device=dev)
    blk_s = torch.as_tensor(np.ascontiguousarray(blocked.T), device=dev)
    time_major = ops._compact(tc_s.T, blk_s.T)
    row_major = ops._compact(tc_s.T.contiguous(), blk_s.T.contiguous())
    check(time_major[0].stride(0) == 1 and row_major[0].stride(1) == 1,
          "compaction lost the tile's layout")
    check(bool(torch.equal(time_major[1], row_major[1])),
          "the two layouts' valid counts differ")
    return time_major[:2], row_major[:2]


def kernel_fleet_at_path(torch, K, M, ref, ops, st_seed, rng, dev, sass,
                         seed):
    """The service's dispatch shape: the kernel on the time-major tile
    the service passes (the .T of its (32, S) staging) and on the
    row-major form, each against its plain version on the same tile from
    a mid-stream state, the two layouts bit-equal to each other; then
    both timed, and at T = 256."""
    cfg = M.MonitorConfig()
    (comp_t, m), (comp_r, _) = _staged_tile(torch, ops, rng, SVC_CHUNK, dev)
    carry, _ = ref.monitor_fleet_ref(cfg, st_seed, comp_r, m)
    win_r = ref.window_carry(st_seed.win, comp_r, m)
    st_t, st_r = clone_state(st_seed), clone_state(st_seed)
    K.monitor_fleet(cfg, st_t, comp_t, m, full=False)
    K.monitor_fleet(cfg, st_r, comp_r, m, full=False)
    torch.cuda.synchronize()
    err = max(_fleet_gate(torch, f"time-major ({N_STREAMS}, {SVC_CHUNK})",
                          st_t, carry, win_r),
              _fleet_gate(torch, f"row-major ({N_STREAMS}, {SVC_CHUNK})",
                          st_r, carry, win_r))
    check(all(bool(torch.equal(a, b)) for a, b in zip(st_t, st_r)),
          "monitor_fleet: the time-major and row-major tiles disagree")

    # device time by graph replay over two (state, tile) pairs, 2 x 107
    # MB, past the 50 MB L2; then the time of one call from Python, as
    # back-to-back calls give it (the wrapper's host work included).  The
    # second tile draws from a generator of its own, so the later phases'
    # inputs do not depend on how many tiles are timed here.
    own = np.random.default_rng((seed, 17))
    tiles = [((comp_t, m), (comp_r, m)),
             tuple(_staged_tile(torch, ops, own, SVC_CHUNK, dev))]
    works = [clone_state(st_seed) for _ in tiles]

    def timed(layout, pairs, reps):
        return graph_ms(torch, [
            lambda w=w, t=t: K.monitor_fleet(cfg, w, *t[layout], full=False)
            for w, t in zip(works, pairs)], reps)

    ms, ms_row = timed(0, tiles, 20), timed(1, tiles, 20)
    call_ms = event_ms(torch, lambda: K.monitor_fleet(
        cfg, works[0], comp_t, m, full=False), reps=20)
    plain_ms = event_ms(torch, lambda: (
        ref.monitor_fleet_ref(cfg, st_seed, comp_r, m),
        ref.window_carry(st_seed.win, comp_r, m)), reps=3, warm=1)
    bound_ms, bound_by, nbytes, flops = fleet_bound(
        N_STREAMS, SVC_CHUNK, m, cfg.window, cfg.conv_window)
    steps = int(m.sum())
    est = None if sass is None else issue_ms(torch, sass, steps)
    # the same at T = 256, the fleet phase's chunk, for the record
    t256 = [tuple(_staged_tile(torch, ops, rng, CHUNK, dev))]
    ms256, ms256_row = timed(0, t256, 6), timed(1, t256, 6)
    b256 = fleet_bound(N_STREAMS, CHUNK, t256[0][0][1], cfg.window,
                       cfg.conv_window)
    log(f"monitor_fleet timing (state mode, {N_STREAMS} streams, device "
        f"time by graph replay): T={SVC_CHUNK} time-major {ms:.4f} ms, "
        f"row-major {ms_row:.4f} ms (bound {bound_ms:.4f} ms by "
        f"{bound_by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; issue "
        "estimate " + ("not measured" if est is None else
                       f"{est:.4f} ms from {sass} SASS instructions a step "
                       f"x {steps} steps") + f"); one call from Python "
        f"{call_ms:.4f} ms; plain {plain_ms:.2f} ms; T={CHUNK} time-major "
        f"{ms256:.4f} ms, row-major {ms256_row:.4f} ms (bound "
        f"{b256[0]:.4f} ms, {b256[2] / 1e6:.1f} MB)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ms_row_major": ms_row,
            "call_ms": call_ms, "sass_step_instructions": sass,
            "issue_ms": est, "ms_T256": ms256, "ms_T256_row_major": ms256_row,
            "bound_ms_T256": b256[0]}


def kernel_batched_at_path(torch, K, ref, rng, dev, err, seed):
    """Device time by graph replay over 6 inputs (154 MB in f32, 77 MB in
    bf16: past the L2), warm on one input, and one call from Python.  The
    first input comes from ``rng``, the other five from a generator of
    their own (the later phases' inputs stay as they were)."""
    own = np.random.default_rng((seed, 18))
    xs = [torch.as_tensor(gen.uniform(0, 500, (WINDOW_Q, 32)).astype(
        np.float32), device=dev) for gen in [rng] + [own] * 5]
    xbs = [x.to(torch.bfloat16) for x in xs]

    def timed(ins):
        return graph_ms(torch, [lambda x=x: K.batched_monitor(x)
                                for x in ins], 48)

    ms, ms_bf16, ms_warm = timed(xs), timed(xbs), timed(xs[:1])
    call_ms = event_ms(torch, lambda: K.batched_monitor(xs[0]), reps=50)
    plain_ms = event_ms(torch, lambda: ref.batched_monitor_ref(xs[0]),
                        reps=20)
    n_out = 32 - 4
    flops = WINDOW_Q * (2 * n_out * 9 + 3 * n_out + 6)
    t_o = flops / PEAK_F32_FLOPS * 1e3

    def bound(size):
        return max(WINDOW_Q * (32 * size + 3 * 4) / PEAK_BYTES_S * 1e3, t_o)

    t_b = bound(4)
    log(f"batched_monitor timing ({WINDOW_Q}, 32), device time by graph "
        f"replay: f32 {ms:.4f} ms (bound {t_b:.4f} ms; warm in L2 "
        f"{ms_warm:.4f} ms), bf16 {ms_bf16:.4f} ms (bound {bound(2):.4f} "
        f"ms); one call from Python {call_ms:.4f} ms; plain f32 "
        f"{plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": t_b, "bound_by": "bytes" if t_b > t_o
            else "operations", "ms_bf16": ms_bf16, "bound_ms_bf16": bound(2),
            "ms_warm": ms_warm, "call_ms": call_ms}


def phase_service(torch, K, M, S, dev):
    """The main path: the fleet monitor service over an arena of 1e5
    queues with both ends monitored."""
    cfg = M.MonitorConfig()
    nq = N_STREAMS // 2
    # a fresh, co-allocated fleet never fragments; with the threshold at
    # 0 each slot attach skips the O(live slots) fragmentation scan, which
    # makes building 2e5 ends quadratic (minutes) otherwise
    arena = S.CounterArena(capacity=N_STREAMS, defrag_threshold=0.0)
    t0 = time.perf_counter()
    queues = [S.InstrumentedQueue(2, arena=arena) for _ in range(nq)]
    t_build = time.perf_counter() - t0
    heads = np.array([q.head.slot for q in queues], np.intp)
    tails = np.array([q.tail.slot for q in queues], np.intp)
    i = np.arange(nq)
    mu = (50 + i % 350).astype(np.float64)           # items/period
    lam = (50 + (7 * i) % 350).astype(np.float64)

    K.reset_launch_counts()
    svc = S.FleetMonitorService(queues, cfg, period_s=1e-3,
                                chunk_t=SVC_CHUNK, scale_to_period=False,
                                ends="both", device=dev)
    t0 = time.perf_counter()
    svc.warmup()
    t_warm = time.perf_counter() - t0
    tick_us, dispatch_us = [], []
    for _ in range(SVC_TICKS):
        with arena.lock:
            arena.tc[heads] = mu
            arena.tc[tails] = lam
        before = svc.dispatches
        t0 = time.perf_counter()
        svc.sample()
        dt = (time.perf_counter() - t0) * 1e6
        (dispatch_us if svc.dispatches > before else tick_us).append(dt)
    svc.flush()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    svc_rates = svc.service_rates() * svc.period_s
    arr_rates = svc.arrival_rates() * svc.period_s
    epochs = svc.epochs()
    check(launches["monitor_fleet"] == svc.dispatches + 1,
          f"monitor_fleet launches {launches['monitor_fleet']} != "
          f"dispatches {svc.dispatches} + warm-up")
    check(int(epochs.min()) >= 1, "a stream never converged")
    check(bool(np.all(np.abs(svc_rates - mu) <= 0.05 * mu)),
          "service rates off by more than 5%")
    check(bool(np.all(np.abs(arr_rates - lam) <= 0.05 * lam)),
          "arrival rates off by more than 5%")
    err = max(float(np.max(np.abs(svc_rates - mu) / mu)),
              float(np.max(np.abs(arr_rates - lam) / lam)))
    log(f"service S={svc.n_streams}: {nq} queues built in {t_build:.2f} s, "
        f"warm-up (build + first launch) {t_warm:.2f} s, {SVC_TICKS} ticks, "
        f"{svc.dispatches} dispatches, min epoch {int(epochs.min())}, "
        f"max rate error {err:.2e}")
    log(f"collector: {np.mean(tick_us):.1f} us/tick (median "
        f"{np.median(tick_us):.1f}), dispatch ticks {np.mean(dispatch_us):.1f}"
        f" us (median {np.median(dispatch_us):.1f}), host clock")

    # device time of one dispatch's work at this shape, CUDA events, in
    # the service's form: the (32, S) staging up as it is, its time-major
    # view compacted and scanned, the state updated in place, unpadded
    rates = np.concatenate([mu, lam])
    stage = np.repeat(rates[None, :], SVC_CHUNK, axis=0)      # f64, as staged
    stage_blk = np.zeros(stage.shape, dtype=bool)
    tc_h = torch.from_numpy(stage.astype(np.float32)).pin_memory()
    blk_h = torch.from_numpy(stage_blk).pin_memory()
    state = M.fleet_monitor_init(cfg, svc.n_streams, device=dev)

    def one_dispatch():
        tcd = tc_h.to(dev, non_blocking=True)
        bd = blk_h.to(dev, non_blocking=True)
        M.run_monitor_fleet(cfg, tcd.T, bd.T, state=state, chunk_t=SVC_CHUNK,
                            mode="state", donate=True, pad_q=False,
                            device=dev)

    d_ms = event_ms(torch, one_dispatch, reps=5)
    # the host transpose-copies the service made before each dispatch
    # until it read the time-major tile, timed alone on this host
    t0 = time.perf_counter()
    for _ in range(5):
        np.ascontiguousarray(stage.T)
        np.ascontiguousarray(stage_blk.T)
    transpose_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"dispatch device time (H2D + compaction + kernel): {d_ms:.3f} ms; "
        f"the host transpose of the ({SVC_CHUNK}, {svc.n_streams}) staging "
        f"it no longer makes: {transpose_ms:.3f} ms (host clock)")
    # the service goes on, converged, into the control phase
    path = {"svc": svc, "arena": arena, "heads": heads, "tails": tails,
            "mu": mu, "lam": lam}
    return launches["monitor_fleet"], {
        "collector_us_per_tick": float(np.mean(tick_us)),
        "dispatch_tick_us": float(np.mean(dispatch_us)),
        "dispatch_ms": d_ms, "transpose_ms_removed": transpose_ms,
        "max_rate_err": err}, path


class RecordingActuator:
    """The control phase's actuator: every queue reports one replica, a
    capacity of 64 and an empty queue; each verb is counted and applied
    nowhere, so the estimates (and the replica basis of the decision)
    stay those of the configured rates."""

    def __init__(self, nq):
        self.nq = nq
        self.counts = {"scale": 0, "resize": 0, "admit": 0}

    def replicas(self):
        return np.ones(self.nq, np.int64)

    def capacities(self):
        return np.full(self.nq, 64, np.int64)

    def occupancy(self):
        return np.zeros(self.nq)

    def scale(self, i, n):
        self.counts["scale"] += 1
        return "applied"

    def resize(self, i, cap):
        self.counts["resize"] += 1
        return "applied"

    def admit(self, i, shed):
        self.counts["admit"] += 1
        return "applied"


def capacity_exponent(lam, mu, cv2, f=0.99):
    """The continuous exponent behind each queue's capacity target, in
    float32 as ``control.policy._capacity_targets`` takes it: K for
    M/M/1/K, (K + 1) / 2 for M/D/1/K (cv2 < 0.5)."""
    lam = np.asarray(lam, np.float32)
    mu = np.asarray(mu, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = lam / np.where(mu > 0, mu, np.float32(1))
        xstar = np.where(rho < 1, np.float32(1 - f) / (1 - f * rho),
                         (1 - np.float32(f) / rho) / np.float32(1 - f))
        ke = np.log(xstar) / np.log(rho)
    return np.where(np.asarray(cv2) >= 0.5, ke, (ke + 1) / 2)


def check_loop_health(loop, what):
    h = loop.health()
    check(not h["impl_degraded"] and h["jit_failures"] == 0,
          f"{what}: the decision degraded to numpy: {h}")
    check(h["tick_errors"] == 0 and h["actuation_errors"] == 0
          and h["quarantined"] == 0 and h["monitor_restarts"] == 0,
          f"{what}: loop faults {h}")
    bad = [r for r in loop.log.records() if r.error]
    check(not bad, f"{what}: error records {bad[:3]}")
    return h


def phase_control(torch, K, CT, CL, CP, path, dev):
    """(a) The control loop at full width: a ``ControlLoop`` over phase
    4's service (1e5 queues, S = 2e5) with the replica, buffer and
    admission policies, the decision's "jit" form (one CUDA graph),
    ticked once after each dispatch.  Every tick the same sensed
    operands also go through the "numpy" form from the same state."""
    svc, arena = path["svc"], path["arena"]
    heads, tails, mu, lam = (path["heads"], path["tails"], path["mu"],
                             path["lam"])
    nq = len(mu)
    act = RecordingActuator(nq)
    ps = CT.PolicySet(replica=CT.ReplicaPolicy(), buffer=CT.BufferPolicy(),
                      admission=CT.AdmissionPolicy())
    builds0 = CT.control_decide_trace_count()
    loop = CT.ControlLoop(svc, ps, act, impl="jit")
    t0 = time.perf_counter()
    loop.warmup()                        # the decision's graph capture
    t_capture = time.perf_counter() - t0

    real = CL.control_decide
    seen = {"ticks": 0, "shadow_s": 0.0, "decide_us": [],
            "boundary": set(), "last": None}

    def checked(cfg, state, **kw):
        check(kw.get("impl") == "jit", f"decision form {kw.get('impl')}")
        t0 = time.perf_counter()
        st_in = CP.ControlState(*(CP._host(a).copy() for a in state))
        t1 = time.perf_counter()
        new, dec = real(cfg, state, **kw)
        t2 = time.perf_counter()
        _, dn = real(cfg, st_in, **{**kw, "impl": "numpy", "device": None})
        t = seen["ticks"]
        for name in dec._fields:
            a, b = np.asarray(getattr(dec, name)), getattr(dn, name)
            if name == "target_caps":
                diff = np.nonzero(a != b)[0]
                if diff.size:
                    e = capacity_exponent(kw["lam"][diff], kw["mu"][diff],
                                          np.broadcast_to(kw["cv2"], (nq,))
                                          [diff])
                    edge = (np.abs(a[diff].astype(np.int64) - b[diff]) == 1) \
                        & (np.abs(e - np.rint(e))
                           <= 1e-5 * np.maximum(1, np.abs(e)))
                    check(bool(edge.all()),
                          f"tick {t}: target_caps jit {a[diff][:4]} numpy "
                          f"{b[diff][:4]} off a +/-1-slot boundary "
                          f"(exponents {e[:4]})")
                    seen["boundary"].update(diff.tolist())
                continue
            check(np.array_equal(a, b),
                  f"tick {t}: {name} differs between jit and numpy at "
                  f"{np.nonzero(a != b)[0][:4]}")
        seen["ticks"] += 1
        seen["decide_us"].append((t2 - t1) * 1e6)
        seen["last"] = (kw, dec, st_in)
        seen["shadow_s"] += (t1 - t0) + (time.perf_counter() - t2)
        return new, dec

    CL.control_decide = checked
    K.reset_launch_counts()
    d0 = svc.dispatches
    tick_us, dispatch_us = [], []
    try:
        for _ in range(CTL_TICKS):
            with arena.lock:
                arena.tc[heads] = mu
                arena.tc[tails] = lam
            before = svc.dispatches
            t0 = time.perf_counter()
            svc.sample()
            if svc.dispatches > before:
                dispatch_us.append((time.perf_counter() - t0) * 1e6)
                s0 = seen["shadow_s"]
                t0 = time.perf_counter()
                loop.tick()
                tick_us.append((time.perf_counter() - t0
                                - (seen["shadow_s"] - s0)) * 1e6)
        svc.flush()
        torch.cuda.synchronize()
    finally:
        CL.control_decide = real
    launches = K.launch_counts()["monitor_fleet"]
    dispatches = svc.dispatches - d0
    check(launches == dispatches,
          f"monitor_fleet launches {launches} != dispatches {dispatches}")
    builds = CT.control_decide_trace_count() - builds0
    check(builds == 1, f"{builds} decision graph builds, not 1")
    check(len(tick_us) == dispatches and seen["ticks"] == dispatches,
          f"{seen['ticks']} decisions for {dispatches} dispatches")
    h = check_loop_health(loop, "control phase")
    check(act.counts["scale"] > 0, "no scale action fired")
    n_boundary = len(seen["boundary"])
    check(n_boundary <= 1e-3 * nq,
          f"{n_boundary} queues on a capacity boundary (> 0.1%)")

    # converged: each ready queue's replica target is the formula's
    kw, dec, st_in = seen["last"]
    ready = np.asarray(kw["ready"], bool)
    check(bool(ready.all()), f"{int((~ready).sum())} queues not ready")
    lam_e = np.asarray(kw["lam"], np.float32)
    mu_e = np.asarray(kw["mu"], np.float32)
    want = np.clip(np.ceil(np.float32(1.2) * lam_e / mu_e), 1,
                   loop.cfg.max_replicas).astype(np.int32)
    bad = np.nonzero(np.asarray(dec.target_replicas)[ready] != want[ready])[0]
    check(bad.size == 0, f"replica targets off the formula at {bad[:4]}")

    # the decision alone: device time by graph replay, the numpy form on
    # the host clock, on the last tick's operands
    qp = -(-nq // loop.cfg.block_q) * loop.cfg.block_q
    step = CP._decide_step(loop.cfg, qp, dev)
    replay_ms = event_ms(torch, step.graph.replay, reps=50)
    ops = {k: v for k, v in kw.items() if k not in ("impl", "device")}
    t0 = time.perf_counter()
    for _ in range(5):
        real(loop.cfg, st_in, impl="numpy", **ops)
    numpy_us = (time.perf_counter() - t0) / 5 * 1e6
    log(f"control: ControlLoop over S={svc.n_streams} ({nq} queues), "
        f"{dispatches} ticks, graph capture {t_capture * 1e3:.1f} ms, "
        f"{builds} build; actions {act.counts}; jit == numpy on every "
        f"boolean and replica target, {n_boundary} queues on a +/-1-slot "
        f"capacity boundary; loop tick (sense + decide + act) mean "
        f"{np.mean(tick_us):.0f} us, median {np.median(tick_us):.0f} us, "
        f"decide {np.median(seen['decide_us']):.0f} us (host clock); "
        f"decision by graph replay {replay_ms:.4f} ms (device), numpy form "
        f"{numpy_us:.0f} us (host clock); beside the dispatch tick it "
        f"follows, mean {np.mean(dispatch_us):.0f} us (host clock)")
    return {"loop_tick_us": float(np.mean(tick_us)),
            "loop_tick_median_us": float(np.median(tick_us)),
            "decide_host_us": float(np.median(seen["decide_us"])),
            "decide_replay_ms": replay_ms, "decide_numpy_us": numpy_us,
            "dispatch_tick_us": float(np.mean(dispatch_us)),
            "graph_capture_ms": t_capture * 1e3,
            "capacity_boundary_queues": n_boundary,
            "control_ticks": dispatches, "actions": dict(act.counts),
            "log_counts": loop.log.counts(), "health": h}


def phase_pipeline(torch, K, CT, S, M, dev):
    """(b) The closed-loop demo on the card: a source feeds a stage that
    sleeps 0.4 ms an item, and the pipeline's own ControlLoop scales it
    while the items flow."""
    def heavy(x):
        time.sleep(4e-4)
        return x + 1

    pipe = S.Pipeline([S.Stage("src", source=range(PIPE_ITEMS)),
                       S.Stage("heavy", fn=heavy)],
                      capacity=64, base_period_s=1e-3, control=True,
                      monitor_cfg=M.MonitorConfig(window=16,
                                                  min_q_samples=16),
                      device=dev)
    pipe.control.warmup()                # the decision's graph capture
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.run_collect(timeout_s=300)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = K.launch_counts()["monitor_fleet"]
    check(len(out) == PIPE_ITEMS
          and sorted(out) == list(range(1, PIPE_ITEMS + 1)),
          f"pipeline lost or changed items: {len(out)} out")
    stats = pipe.stats()
    check(stats["crash_count"] == 0, f"worker crashed: {stats['crashes']}")
    live = pipe.live_replicas("heavy")
    scales = [(r.tick, r.value) for r in pipe.control.log.records()
              if r.policy == "replicas" and r.outcome == "applied"]
    check(scales, "no applied replicas/scale record")
    check(live > 1, f"live replicas of 'heavy' {live}, scales {scales}")
    check(launches == pipe.fleet.dispatches + 1,
          f"monitor_fleet launches {launches} != dispatches "
          f"{pipe.fleet.dispatches} + warm-up")
    h = check_loop_health(pipe.control, "pipeline")
    log(f"pipeline: {PIPE_ITEMS} items in {wall:.2f} s ({PIPE_ITEMS / wall:.0f}"
        f" items/s, host clock), live replicas of 'heavy' {live}, scale "
        f"records (tick, replicas) {scales}, {pipe.fleet.dispatches} "
        f"dispatches, {launches} monitor_fleet launches, {h['ticks']} "
        f"loop ticks")
    return {"pipeline_items_per_s": PIPE_ITEMS / wall,
            "pipeline_wall_s": wall, "pipeline_live_replicas": live,
            "pipeline_scales": scales,
            "pipeline_dispatches": pipe.fleet.dispatches,
            "pipeline_loop_ticks": h["ticks"]}


def phase_serve_control(torch, KK, kname, MK, serve, model, params,
                        prompts, dev):
    """(c) ``serve.Engine(control=True)``: phase 8's requests again,
    with the engine's ControlLoop (buffer + admission policies) over its
    lanes."""
    eng = serve.Engine(model, params, serve.ServeConfig(
        batch_size=SERVE_B, max_seq=SERVE_MAX_SEQ, queue_capacity=64),
        control=True, device=dev)
    rounds = []
    prefill = eng._prefill

    def counted_prefill(p, batch):
        rounds.append(batch["tokens"].shape)
        return prefill(p, batch)

    eng._prefill = counted_prefill
    reqs = [serve.Request(rid=i, tokens=t, max_new=SERVE_NEW,
                          qos=("blocking", "nonblocking")[i % 2])
            for i, t in enumerate(prompts)]
    KK.reset_launch_counts()
    MK.reset_launch_counts()
    eng.start()
    t0 = time.perf_counter()
    admitted = [eng.submit(r, timeout=60.0) for r in reqs]
    for r, ok in zip(reqs, admitted):
        if ok:
            check(r.done.wait(timeout=600), f"request {r.rid} timed out")
    wall = time.perf_counter() - t0
    deadline = time.monotonic() + 30
    while eng.control.ticks == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    crashes = list(eng._crashes)
    eng.stop()
    launched = KK.launch_counts()[kname]
    monitor = MK.launch_counts()["monitor_fleet"]
    check(not crashes, f"serve worker crashed: {crashes}")
    for r, ok in zip(reqs, admitted):
        if ok:
            check(r.out is not None and r.out.shape == (SERVE_NEW,),
                  f"request {r.rid} answered {r.out}")
    refused = len(reqs) - sum(admitted)
    sheds = [r for r in eng.control.log.records()
             if r.policy == "admission" and r.action == "shed"]
    check(refused == 0 or sheds,
          f"{refused} requests refused with no admission record")
    check(launched == model.cfg.n_layers * len(rounds),
          f"{kname} launched {launched} times in {len(rounds)} rounds")
    h = check_loop_health(eng.control, "engine")
    check(h["ticks"] >= 1, "the engine's loop never ticked")
    check(monitor > 0, "monitor_fleet never launched on the lanes")
    log(f"serve with control: {len(reqs)} requests, {sum(admitted)} "
        f"answered, {refused} refused, {len(rounds)} rounds, {wall:.2f} s "
        f"wall (host clock), {kname} launches {launched}, monitor_fleet "
        f"launches {monitor}, loop ticks {h['ticks']}, log "
        f"{eng.control.log.counts()}")
    return {"control_serve_wall_s": wall, "control_rounds": len(rounds),
            "control_answered": sum(admitted), "control_refused": refused,
            "control_loop_ticks": h["ticks"],
            "control_log_counts": eng.control.log.counts()}


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_matrix(torch, K, CT, W, dev, seed):
    """(d) The scenario x policy x fault matrix at full width: the port's
    ``run_matrix`` at the scenarios' full horizons, every controlled cell
    a ``ControlGroup`` on the card (``monitor_fleet`` on each dispatch,
    the decision's CUDA graph on each tick).  Each cell is recorded and
    the storm cells' traces are replayed on the host (numpy decision, CPU
    monitor): every scenario and policy, under the faults."""
    from repro_torch.workloads import harness as H
    cells, walls = [], []
    real = H.run_cell

    def recorded(*a, **kw):           # run_matrix's cells, traces kept
        t0 = time.perf_counter()
        c = real(*a, **{**kw, "record": True})
        walls.append(time.perf_counter() - t0)
        cells.append(c)
        return c

    builds0 = CT.control_decide_trace_count()
    H.run_cell = recorded
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        m = W.run_matrix(seed=seed, quick=False, impl="jit", device=dev)
    finally:
        H.run_cell = real
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = K.launch_counts()["monitor_fleet"]
    builds = CT.control_decide_trace_count() - builds0

    rows = m["cells"]
    ctl = [c for c in rows if c["policy"] != "static"]
    min_avail = min(c["availability"] for c in ctl)
    min_noharm = min(c["vs_static"] for c in ctl if c["fault"] == "none")
    min_storm = min(c["vs_static"] for c in ctl if c["fault"] != "none")
    for c, w in zip(rows, walls):
        log("  matrix " + json.dumps({**c, "wall_s": round(w, 3)}))
    check(m["n_cells"] == 24, f"{m['n_cells']} matrix cells, not 24")
    check(min_avail >= 0.9, f"controlled availability {min_avail} < 0.9")
    check(min_noharm >= 0.95, f"fault-free vs_static {min_noharm} < 0.95")
    check(min_storm >= 1.2, f"storm vs_static {min_storm} < 1.2")
    check(launches > 0, "monitor_fleet never launched in the matrix")
    configs = {c["policy"] for c in ctl}
    check(builds <= len(configs),
          f"{builds} decision graph builds for {len(configs)} configs")

    # the replay gate: each controlled storm cell's recorded sensing
    # stream through the port's replay on the host, numpy decision (the
    # fault-free half, another 20 s of host time, is cut for time)
    t0 = time.perf_counter()
    n_dec = boundary = 0
    replayed = [c for c in cells if c.policy != "static"
                and c.fault != "none"]
    for c in replayed:
        tr = c.trace
        out = W.replay(tr, W.make_policies(
            c.policy, decide_every=tr.meta["decide_every"]),
            impl="numpy", device="cpu")
        what = f"{c.scenario}/{c.policy}/{c.fault}"
        check(out["ticks"] == len(tr.tick_at),
              f"{what}: replay ticked {out['ticks']} of {len(tr.tick_at)}")
        for f in W.DECISION_FIELDS:
            a, b = np.asarray(out[f]), np.asarray(tr.decisions[f])
            if f == "target_caps":
                d = np.abs(a.astype(np.int64) - b.astype(np.int64))
                check(bool((d <= 1).all()),
                      f"{what}: capacity targets {d.max()} slots apart")
                boundary += int((d == 1).sum())
                n_dec += d.size
                continue
            check(np.array_equal(a, b),
                  f"{what}: replay differs on {f} at "
                  f"{np.argwhere(a != b)[:4].tolist()}")
    replay_s = time.perf_counter() - t0
    check(boundary <= 1e-3 * max(n_dec, 1),
          f"{boundary} of {n_dec} capacity decisions +/-1 apart (> 0.1%)")

    # one controlled cell again on this machine's CPU, for the split of
    # the matrix's wall time between the card's path and the host's
    t0 = time.perf_counter()
    W.run_cell("step", "full", "storm", seed=seed, quick=False,
               impl="numpy", device="cpu")
    cpu_cell_s = time.perf_counter() - t0
    card_cell_s = next(w for c, w in zip(cells, walls)
                       if (c.scenario, c.policy, c.fault)
                       == ("step", "full", "storm"))
    static_s = [w for c, w in zip(cells, walls) if c.policy == "static"]
    ctl_s = [w for c, w in zip(cells, walls) if c.policy != "static"]
    periods = sum(c.periods for c in cells)
    log(f"matrix: {m['n_cells']} cells, {periods} periods, {wall:.2f} s "
        f"wall ({wall / m['n_cells']:.3f} s a cell; static cells "
        f"{np.mean(static_s):.3f} s, controlled {np.mean(ctl_s):.3f} s; "
        f"host clock), {launches} monitor_fleet launches, {builds} "
        f"decision graph builds; controlled availability >= "
        f"{min_avail:.4f}, fault-free vs_static >= {min_noharm:.3f}, storm "
        f"vs_static >= {min_storm:.3f}; replay of {len(replayed)} storm "
        f"cells on the host in {replay_s:.2f} s: every boolean and replica "
        f"target "
        f"equal, {boundary} of {n_dec} capacity decisions +/-1 slot; "
        f"step/full/storm {card_cell_s:.3f} s on the card's path, "
        f"{cpu_cell_s:.3f} s with the monitor and decision on the CPU")
    return launches, {
        "matrix_cells": m["n_cells"], "matrix_wall_s": wall,
        "matrix_cell_wall_s": wall / m["n_cells"],
        "matrix_static_cell_s": float(np.mean(static_s)),
        "matrix_controlled_cell_s": float(np.mean(ctl_s)),
        "matrix_min_availability": min_avail,
        "matrix_min_vs_static_faultfree": min_noharm,
        "matrix_min_vs_static_storm": min_storm,
        "matrix_replay_boundary_decisions": boundary,
        "matrix_replay_decisions": n_dec, "matrix_replay_s": replay_s,
        "matrix_graph_builds": builds, "matrix_launches": launches,
        "matrix_step_full_storm_card_s": card_cell_s,
        "matrix_step_full_storm_cpu_s": cpu_cell_s}


def chaos_runs(torch, K, CT, S, M, FT, dev, seed,
               max_replicas=None, items=CHAOS_ITEMS):
    """The supervised chaos pipeline (the shape of the JAX package's
    ``control_bench.chaos_recovery``, full mode): a paced source feeds a
    two-replica work stage under closed-loop control; a seeded plan
    kills three replicas and the monitor thread once, and a
    ``ReplicaSupervisor`` respawns them.  Run fault-free first for the
    baseline.  The replica leg is capped at ``max_replicas``
    (``CHAOS_MAX_REPLICAS`` by default): the replica law reads a starved
    consumer's service rate as about its arrival rate and scales the
    stage on every confirmation (as the JAX package's does), and at the
    default 64 the threads' per-replica host work (idle polls,
    heartbeats, the supervisor's Algorithm-1 rate leg) starves the paced
    source.  ``items`` is the source's length.  Returns what was
    measured; ``phase_chaos`` gates it."""
    from repro_torch.core.controller import (BufferAutotuner,
                                             ParallelismController)
    cap = CHAOS_MAX_REPLICAS if max_replicas is None else max_replicas
    pace_s, work_s, window_s = 1.0 / 1100.0, 1.5e-3, 0.05
    mcfg = M.MonitorConfig(window=16, min_q_samples=16)

    def build(plan):
        def src():
            for i in range(items):
                time.sleep(pace_s)
                yield i

        def work(x):
            time.sleep(work_s)
            return x

        policies = CT.PolicySet(
            replica=CT.ReplicaPolicy(ParallelismController(
                max_replicas=cap)),
            buffer=CT.BufferPolicy(BufferAutotuner(current=64)))
        pipe = S.Pipeline([S.Stage("src", source=src()),
                           S.Stage("work", fn=work, replicas=2)],
                          capacity=64, arena=S.CounterArena(16),
                          control=True, policies=policies, monitor_cfg=mcfg,
                          fault_plan=plan, device=dev)
        pipe.control.warmup()          # the decision's graph, if not cached
        return pipe

    def run(pipe, plan=None):
        done = threading.Event()

        def go():
            pipe.run_collect(timeout_s=300)
            done.set()

        t = threading.Thread(target=go, daemon=True)
        t0 = time.monotonic()
        if plan is not None:
            plan.arm(t0)
        t.start()
        windows, last = [], 0
        while not done.is_set():
            done.wait(window_s)
            n = len(pipe.sink)
            windows.append((time.monotonic() - t0, n - last))
            last = n
        t.join(timeout=30)
        check(not t.is_alive(), "the chaos pipeline did not finish")
        return windows, time.monotonic() - t0

    K.reset_launch_counts()
    base_pipe = build(None)
    warm = CT.control_decide_trace_count()
    base_wins, t_base = run(base_pipe)
    base_counts = np.array([c for _, c in base_wins[2:-2]], float)
    base_med = float(np.median(base_counts)) if base_counts.size else 1.0

    plan = FT.FaultPlan.chaos(seed=seed, targets=["work"], n_crashes=3,
                              window_s=(0.5, 2.0), monitor_death_at=1.2)
    pipe = build(plan)
    sup = FT.ReplicaSupervisor(pipe, poll_s=0.01, backoff_base_s=0.01)
    sup.start()
    try:
        wins, t_chaos = run(pipe, plan)
    finally:
        sup.stop()
    check(not sup.is_alive(), "the supervisor thread did not stop")
    _sync(torch, dev)
    launches = K.launch_counts()["monitor_fleet"]
    grown = CT.control_decide_trace_count() - warm

    fired = plan.fired()
    crash_ts = [t for t, e in fired if e.kind == "crash"]
    mon_fired = any(e.kind == "monitor_death" for _, e in fired)
    recovery = -1
    if crash_ts:
        last_rel = max(crash_ts) - plan._t0
        after = [c for end, c in wins if end > last_rel]
        recovery = next((k for k, c in enumerate(after)
                         if c >= 0.7 * base_med), -1)
    st = pipe.stats()
    health = pipe.control.health()
    unhandled = max(0, len(crash_ts) - st["crash_count"])
    if mon_fired and health["monitor_restarts"] == 0:
        unhandled += 1
    peak = {name: max([2] + [r.value for r in p.control.log.records()
                             if r.policy == "replicas"
                             and r.outcome == "applied"])
            for name, p in (("fault-free", base_pipe), ("chaos", pipe))}
    audit = [(round(r.t - plan._t0, 3), r.policy, r.action, r.value,
              r.outcome) for r in pipe.control.log.records()
             if r.policy in ("supervisor", "watchdog", "replicas")]
    return {"cap": cap, "t_base": t_base, "t_chaos": t_chaos,
            "base_med": base_med, "base_wins": [c for _, c in base_wins],
            "wins": [c for _, c in wins], "recovery": recovery,
            "availability": min(1.0, t_base / max(t_chaos, 1e-9)),
            "fired": [(round(t - plan._t0, 3), e.kind) for t, e in fired],
            "crashes": len(crash_ts), "monitor_death": mon_fired,
            "unhandled": unhandled, "grown": grown,
            "respawns": sup.respawns, "health": health,
            "out": len(pipe.sink), "peak": peak, "audit": audit,
            "launches": launches}


def phase_chaos(torch, K, CT, S, M, FT, dev, seed):
    """(e) The supervised chaos pipeline on the card (``chaos_runs``),
    gated as the JAX package's bench gates it."""
    r = chaos_runs(torch, K, CT, S, M, FT, dev, seed)

    # the faulty operand must not recapture the decision's graph
    tcfg = CT.ControlConfig(confirm_ticks=1, block_q=16, cooldown_ticks=13)

    def dispatch(q, f):
        CT.control_decide(tcfg, CT.control_init(tcfg, q, device=dev),
                          lam=np.full(q, 100.0), mu=np.full(q, 50.0),
                          ready=np.ones(q, bool), replicas=np.ones(q),
                          caps=np.full(q, 64), faulty=f, impl="jit",
                          donate=True, device=dev)

    dispatch(3, None)
    w2 = CT.control_decide_trace_count()
    dispatch(3, np.array([True, False, True]))
    dispatch(5, np.ones(5, bool))
    retraces = CT.control_decide_trace_count() - w2

    health = r["health"]
    log(f"chaos: {CHAOS_ITEMS} items paced at 1100/s, replicas capped at "
        f"{r['cap']} (peak {r['peak']}), fault-free {r['t_base']:.2f} s "
        f"({r['base_med']:.0f} items a 0.05 s window), chaos "
        f"{r['t_chaos']:.2f} s, {r['out']} items out; {r['fired']} -> "
        f"recovered in {r['recovery']} windows, availability "
        f"{r['availability']:.4f}, {r['respawns']} respawns, "
        f"{health['monitor_restarts']} monitor restarts, "
        f"{r['unhandled']} unhandled deaths, {r['grown'] + retraces} graph "
        f"recaptures, {r['launches']} monitor_fleet launches (host clock)")
    log(f"  chaos windows (items a 0.05 s): fault-free {r['base_wins']}; "
        f"chaos {r['wins']}; audit (s after arm, policy, action, value, "
        f"outcome) {r['audit']}")
    check(r["crashes"] == 3 and r["monitor_death"],
          f"faults fired: {r['fired']}")
    check(0 <= r["recovery"] <= 20,
          f"throughput recovered in {r['recovery']} windows (> 20 or never)")
    check(r["availability"] >= 0.9,
          f"chaos availability {r['availability']} < 0.9")
    check(r["unhandled"] == 0, f"{r['unhandled']} unhandled thread deaths")
    check(r["grown"] == 0 and retraces == 0,
          f"decision graph recaptured: {r['grown']} in the runs, "
          f"{retraces} on the faulty operand")
    check(health["tick_errors"] == 0 and not health["impl_degraded"],
          f"chaos loop faults {health}")
    check(r["launches"] > 0, "monitor_fleet never launched in the chaos runs")
    return r["launches"], {
        "chaos_recovery_windows": r["recovery"],
        "chaos_availability": r["availability"],
        "chaos_faultfree_s": r["t_base"], "chaos_s": r["t_chaos"],
        "chaos_respawns": r["respawns"],
        "chaos_monitor_restarts": health["monitor_restarts"],
        "chaos_items_out": r["out"], "chaos_peak_replicas": r["peak"],
        "chaos_launches": r["launches"]}


def phase_soak(torch, K, SV, S, FT, W, dev, seed):
    """(f) The QoS soak (the shape of the JAX package's
    ``control_bench.qos_soak``, its quick phases): a diurnal two-class
    load against ``Engine(control=True)`` on the card with the bench's
    model-free serve round, a nonblocking-lane crash storm, a stall, a
    monitor death and a blocking flash crowd, under a
    ``ReplicaSupervisor``, the ``ControlLog`` drained to JSONL."""
    pre_s, storm_s, post_s = SOAK_PHASES
    T = pre_s + storm_s + post_s
    nb_env = W.Diurnal(base=4000.0, amplitude=1500.0, period=T)
    b_env = (W.Diurnal(base=200.0, amplitude=60.0, period=T / 2)
             + W.FlashCrowd(peak=600.0, at=pre_s + 0.5 * storm_s,
                            rise=0.2 * storm_s, fall=0.15 * storm_s))
    work_s, deadline_s, tick_s = 4e-3, 0.25, 5e-3
    toks = np.arange(4)
    plan = FT.FaultPlan.chaos(
        seed=seed, targets=[SV.NONBLOCKING], n_crashes=2,
        window_s=(pre_s + 0.1 * storm_s, pre_s + 0.6 * storm_s),
        n_stalls=1, stall_s=0.15, monitor_death_at=pre_s + 0.7 * storm_s)

    class _Work(SV.Engine):
        """Model-free engine: a round burns work_s and completes."""

        def _serve_batch(self, batch):
            time.sleep(work_s)
            for r in batch:
                r.out = np.zeros(1, np.int32)
                r.done.set()
                self.served += 1

    scfg = SV.ServeConfig(batch_size=8, queue_capacity=64, bulkheads=(1, 2))
    eng = _Work(None, None, scfg, arena=S.CounterArena(8), control=True,
                fault_plan=plan, device=dev)
    eng.control.period_s = 0.01        # react within the storm
    eng.control.warmup()
    sup = FT.ReplicaSupervisor(engines=[eng], poll_s=0.01)
    drain_path = HERE / "build" / "chip_smoke" / "control_log.jsonl"
    drain_path.parent.mkdir(parents=True, exist_ok=True)
    drain_path.unlink(missing_ok=True)
    K.reset_launch_counts()
    eng.start()
    sup.start()
    drains, blocking, rid = 0, [], 0
    owed_b = owed_nb = 0.0
    last = last_drain = 0.0
    t0 = time.monotonic()
    plan.arm(t0)
    try:
        while True:
            now = time.monotonic() - t0
            if now >= T:
                break
            dt, last = now - last, now
            owed_b += b_env.rate(now) * dt
            owed_nb += nb_env.rate(now) * dt
            while owed_b >= 1.0:
                owed_b -= 1.0
                r = SV.Request(rid=rid, tokens=toks, max_new=1,
                               qos=SV.BLOCKING, deadline_s=deadline_s)
                rid += 1
                blocking.append((now, r, eng.submit(r, timeout=0.02)))
            while owed_nb >= 1.0:
                owed_nb -= 1.0
                eng.submit(SV.Request(rid=rid, tokens=toks, max_new=1,
                                      qos=SV.NONBLOCKING), timeout=0.0)
                rid += 1
            if now - last_drain >= 0.5:    # mid-soak flight-recorder drain
                eng.control.log.drain_jsonl(drain_path)
                drains += 1
                last_drain = now
            time.sleep(tick_s)
        time.sleep(2 * deadline_s)         # let in-flight tails land
    finally:
        sup.stop()
        eng.stop()
    _sync(torch, dev)
    launches = K.launch_counts()["monitor_fleet"]
    eng.control.log.drain_jsonl(drain_path)
    drained_lines = len(drain_path.read_text().splitlines())

    lat = {"pre": [], "storm": [], "post": []}
    ok_within = 0
    for ts, r, sub_ok in blocking:
        p = ("pre" if ts < pre_s
             else "storm" if ts < pre_s + storm_s else "post")
        if sub_ok and r.done.is_set() and r.out is not None:
            d = r.t_done - r.t_submit
            lat[p].append(d)
            ok_within += d <= deadline_s
    p99 = {p: (float(np.percentile(v, 99)) if v else 0.0)
           for p, v in lat.items()}
    availability = ok_within / max(len(blocking), 1)
    p99_ratio = p99["storm"] / max(p99["pre"], 1e-9)
    fired = plan.fired()
    crash_ts = [t - t0 for t, e in fired if e.kind == "crash"]
    win, recovery_s = 0.4, -1.0
    if crash_ts:
        last_c, k = max(crash_ts), 0
        while last_c + (k + 1) * win <= T + 2 * deadline_s:
            lo, hi = last_c + k * win, last_c + (k + 1) * win
            sub = [(r, s) for ts, r, s in blocking if lo <= ts < hi]
            good = sum(1 for r, s in sub
                       if s and r.done.is_set() and r.out is not None
                       and (r.t_done - r.t_submit) <= deadline_s)
            if sub and good / len(sub) >= 0.9:
                recovery_s = k * win
                break
            k += 1
    health = eng.control.health()
    log(f"soak ({T:.1f} s, phases {SOAK_PHASES}): {len(blocking)} "
        f"blocking requests, availability {availability:.4f}, p99 ms "
        f"{ {p: round(v * 1e3, 3) for p, v in p99.items()} }, storm/pre "
        f"{p99_ratio:.3f}x, {len(crash_ts)} crashes -> {sup.respawns} "
        f"respawns, recovered in {recovery_s:.1f} s, "
        f"{health['monitor_restarts']} monitor restarts, {drained_lines} "
        f"log lines in {drains + 1} drains, {launches} monitor_fleet "
        f"launches (host clock)")
    check(len(crash_ts) == 2, f"soak crashes fired: {crash_ts}")
    check(availability >= 0.9, f"soak availability {availability} < 0.9")
    check(p99_ratio <= 2.5, f"storm p99 {p99_ratio:.2f}x pre-storm > 2.5x")
    check(sup.respawns >= len(crash_ts),
          f"{sup.respawns} respawns for {len(crash_ts)} crashes")
    check(recovery_s >= 0, "the blocking lane never recovered")
    check(not sup.is_alive(), "the supervisor thread did not stop")
    check(drained_lines > 0, "nothing drained from the control log")
    check(not health["impl_degraded"], f"soak loop degraded: {health}")
    check(launches > 0, "monitor_fleet never launched in the soak")
    return launches, {
        "soak_availability": availability, "soak_p99_ms":
            {p: v * 1e3 for p, v in p99.items()},
        "soak_p99_storm_over_pre": p99_ratio, "soak_recovery_s": recovery_s,
        "soak_respawns": sup.respawns,
        "soak_monitor_restarts": health["monitor_restarts"],
        "soak_log_lines": drained_lines, "soak_launches": launches}


def phase_rate_tracker(torch, K, FT, M, dev, seed):
    """(g) ``FleetRateTracker`` at training-fleet scale: 2048 hosts (a
    16 384-GPU cluster at 8 GPUs a host), step counts of the JAX
    package's fleet test, 16 hosts phase-changing to 0.3x at period 200;
    the kernel, the rounds form and the plain version, all on the card.
    A host's epoch that spans the change re-converges only once its
    running q-bar settles, some 400-500 periods later, so the run goes on
    to 1200 periods: no healthy host may ever be flagged, and by the end
    exactly the injected hosts are; the period by which all were found
    is the detection latency."""
    rng = np.random.default_rng(seed)
    Q, T = TRACKER_HOSTS, TRACKER_PERIODS
    steps = np.full((Q, T), 100.0) + rng.normal(0, 1.0, (Q, T))
    slow = np.sort(rng.choice(Q, TRACKER_STRAGGLERS, replace=False))
    steps[slow, TRACKER_CHANGE:] *= 0.3
    hosts = [f"host{i}" for i in range(Q)]
    want = sorted(hosts[i] for i in slow)
    cfg = M.MonitorConfig(window=16, min_q_samples=16)
    tiles = [(t0, min(t0 + 100, T)) for t0 in range(0, T, 100)]
    trackers, tile_ms, found, launches = {}, {}, {}, 0
    for impl in ("cuda", "rounds", "scan"):
        tr = FT.FleetRateTracker(hosts, cfg, period_s=1.0, chunk_t=16,
                                 impl=impl, device=dev)
        if impl == "cuda":
            K.reset_launch_counts()
        times, flagged = [], []
        for a, b in tiles:
            t0 = time.perf_counter()
            tr.record_tile(steps[:, a:b])         # reads its rates back
            times.append((time.perf_counter() - t0) * 1e3)
            got = sorted(tr.stragglers())
            check(set(got) <= set(want),
                  f"{impl}: healthy hosts flagged by period {b}: "
                  f"{sorted(set(got) - set(want))[:8]}")
            flagged.append((b, len(got)))
        if impl == "cuda":
            launches = K.launch_counts()["monitor_fleet"]
        trackers[impl], tile_ms[impl] = tr, float(np.median(times[1:]))
        found[impl] = flagged
    chunks = sum(-(-(b - a) // 16) for a, b in tiles)
    check(launches == chunks,
          f"monitor_fleet launches {launches} != {chunks} chunks")
    latency = {}
    for impl in ("cuda", "rounds"):
        got = trackers[impl].stragglers()
        check(sorted(got) == want,
              f"{impl}: stragglers {sorted(got)[:8]} != injected {want[:8]}")
        latency[impl] = next(b for b, n in found[impl]
                             if n == len(want)) - TRACKER_CHANGE
    ks, ps = trackers["cuda"]._state, trackers["scan"]._state
    for name, a, b in zip(ks._fields, ks, ps):
        check(torch.equal(a, b), f"kernel state {name} != plain version's")
    ftm = FT.FaultToleranceManager(n_hosts=Q, chips_per_host=8)
    for h in hosts:
        ftm.heartbeats.beat(h)
    ftm.rates = trackers["cuda"]
    plan = ftm.assess(latest_ckpt_step=T)
    check(plan is not None and plan.dropped_hosts == want,
          f"assess dropped {None if plan is None else plan.dropped_hosts}")

    # one dispatch alone at (Q, 16), state mode, by CUDA events
    st = M.fleet_monitor_init(cfg, Q, device=dev)
    tile = torch.as_tensor(steps[:, :16], dtype=torch.float32, device=dev)

    def one(impl):
        return lambda: M.run_monitor_fleet(
            cfg, tile, None, state=st, chunk_t=16, impl=impl, mode="state",
            block_q=64, donate=True, device=dev)

    d_ms = {impl: event_ms(torch, one(impl), reps=20)
            for impl in ("cuda", "rounds")}
    log(f"rate tracker: {Q} hosts x {T} periods, stragglers {want} found "
        f"by the kernel and the rounds form, none healthy ever flagged; "
        f"flagged (period, count) {found['cuda']}; all found "
        f"{latency} periods after the change; kernel state bit-equal to "
        f"the plain version's; assess drops exactly them ({plan.n_chips} "
        f"of {Q * 8} chips left, {plan.new_shape}); record_tile of 100 "
        f"periods median {tile_ms} ms (host clock, readout included); one "
        f"({Q}, 16) dispatch {d_ms} ms (device); {launches} monitor_fleet "
        f"launches")
    return launches, {"tracker_hosts": Q, "tracker_tile_ms": tile_ms,
                      "tracker_dispatch_ms": d_ms,
                      "tracker_flagged": found["cuda"],
                      "tracker_latency_periods": latency,
                      "tracker_launches": launches}


def phase_data(torch, K, D, S, dev, seed):
    """(h) ``DataPipeline`` at ``examples/train_lm.py``'s defaults (seq
    256, batch 8) over internlm2's vocabulary, its two links' monitor
    service on the card, against the same seed with the service on the
    CPU."""
    def run(device):
        src = D.SyntheticLMSource(vocab_size=DATA_VOCAB, doc_len=512,
                                  seed=seed)
        dp = D.DataPipeline(src, seq_len=DATA_SEQ, batch_size=DATA_BATCH,
                            max_batches=DATA_BATCHES,
                            arena=S.CounterArena(8), device=device)
        t0 = time.perf_counter()
        dp.start()
        try:
            batches = list(dp)
        finally:
            dp.stop()
        return batches, dp, time.perf_counter() - t0

    K.reset_launch_counts()
    got, dp, wall = run(dev)
    _sync(torch, dev)
    launches = K.launch_counts()["monitor_fleet"]
    want, _, cpu_wall = run(torch.device("cpu"))
    check(len(got) == len(want) == DATA_BATCHES,
          f"{len(got)} / {len(want)} batches, not {DATA_BATCHES}")
    for i, (b, r) in enumerate(zip(got, want)):
        check(b["tokens"].shape == (DATA_BATCH, DATA_SEQ)
              and np.array_equal(b["tokens"], r["tokens"])
              and np.array_equal(b["targets"], r["targets"]),
              f"batch {i} differs from the CPU run")
    rates = dp.rates()
    st = dp.fleet.state_snapshot()
    cfg = dp.fleet.cfg
    gated = np.where(st.epoch > 0, st.last_qbar,
                     np.where(st.count >= cfg.min_q_samples, st.mean, 0.0))
    gated = gated / dp.fleet.period_s
    for i, (name, r) in enumerate(rates.items()):
        check(np.isclose(r["service_rate"], gated[i], rtol=1e-12, atol=0)
              and np.isclose(r["arrival_rate"], gated[2 + i], rtol=1e-12,
                             atol=0),
              f"{name}: readout {r} off the gated formula")
    check(launches > 0, "monitor_fleet never launched on the data links")
    links = {k: (round(v["service_rate"], 1), v["epochs"])
             for k, v in rates.items()}
    log(f"data: {DATA_BATCHES} batches of {DATA_BATCH} x {DATA_SEQ} "
        f"(vocab {DATA_VOCAB}) in {wall:.2f} s with the service on the "
        f"card, {cpu_wall:.2f} s on the CPU (host clock), equal; links "
        f"{links} (items/s, epochs), {dp.fleet.dispatches} dispatches, "
        f"{launches} monitor_fleet launches")
    return launches, {"data_wall_s": wall, "data_cpu_wall_s": cpu_wall,
                      "data_rates": rates, "data_launches": launches}


def phase_step_path(torch, K, O, M, rng, dev):
    """The per-tick path: hand-maintained windows through
    ``fleet_monitor_step`` once per tick."""
    cfg = M.MonitorConfig()
    win = torch.as_tensor(rng.poisson(200.0, (WINDOW_Q, 32)).astype(
        np.float32), device=dev)
    fresh = torch.as_tensor(rng.poisson(200.0, (STEP_TICKS, WINDOW_Q))
                            .astype(np.float32), device=dev)
    K.reset_launch_counts()
    st = O.fleet_step_init(cfg, WINDOW_Q, device=dev)
    for t in range(STEP_TICKS):
        win = torch.cat([win[:, 1:], fresh[t][:, None]], dim=1)
        q, st, sigma = O.fleet_monitor_step(win, st, cfg=cfg)
    torch.cuda.synchronize()
    launches = K.launch_counts()["batched_monitor"]
    check(launches == STEP_TICKS, f"batched_monitor launched {launches} "
          f"times in {STEP_TICKS} ticks")
    qbar = st.welford.mean
    check(bool(torch.isfinite(qbar).all()), "non-finite q-bar")
    check(bool(((qbar > 150) & (qbar < 300)).all()),
          "per-tick q-bar outside the plausible band")
    check(bool(torch.isfinite(sigma).all()), "non-finite sigma")
    log(f"per-tick path: {STEP_TICKS} ticks over {WINDOW_Q} windows, "
        f"q-bar mean {float(qbar.mean()):.2f}")
    return launches


# ---------------------------------------------------------------------------
# the serving path: flash attention, the full-width model, the engine


def _qkv(torch, rng, shape, dtype, dev, T=None, qmul=1.0):
    B, S, H, K, hd = shape
    T = S if T is None else T
    mk = lambda *sh: torch.as_tensor(  # noqa: E731
        rng.standard_normal(sh).astype(np.float32), device=dev)
    return ((mk(B, S, H, hd) * qmul).to(dtype), mk(B, T, K, hd).to(dtype),
            mk(B, T, K, hd).to(dtype))


def phase_flash(torch, AK, AR, rng, dev, seed):
    """Kernel against its plain version on the card: the JAX package's
    kernel-test shapes in f32 (2e-4); in bf16 (1e-3: the same bf16
    inputs on both sides) the path's shape with a masked tail, every
    head dim, ragged S != T both ways, GQA groups 1-4 and large scores
    (q x 4 at scale 1, so the running max moves between tiles).  The
    cases after the path's draw from a generator of their own, so the
    later phases' requests do not depend on how many run here."""
    f32, bf16 = torch.float32, torch.bfloat16
    own = np.random.default_rng((seed, 6))
    # (shape (B,S,H,K,hd), T or None for S, dtype, tol, q multiplier, rng)
    cases = [((1, 128, 2, 2, 32), None, f32, 2e-4, 1.0, rng),
             ((2, 256, 4, 2, 32), None, f32, 2e-4, 1.0, rng),
             ((1, 256, 8, 8, 64), None, f32, 2e-4, 1.0, rng),
             ((8, 1000, 16, 8, 128), None, bf16, 1e-3, 1.0, rng),
             ((2, 77, 4, 2, 16), 1341, bf16, 1e-3, 1.0, own),
             ((2, 1341, 4, 1, 32), 77, bf16, 1e-3, 1.0, own),
             ((1, 1341, 8, 4, 64), None, bf16, 1e-3, 1.0, own),
             ((2, 1000, 16, 8, 128), None, bf16, 1e-3, 4.0, own)]
    path_err = 0.0
    for shape, T, dtype, tol, qmul, gen in cases:
        q, k, v = _qkv(torch, gen, shape, dtype, dev, T, qmul)
        scale = 1.0 if qmul != 1.0 else None
        for causal in (True, False):
            got = AK.flash_attention(q, k, v, causal=causal, scale=scale)
            want = AR.attention_ref(q, k, v, causal=causal, scale=scale)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"flash_attention {shape}: non-finite output")
            err = float((got - want).abs().max())
            what = (f"flash_attention {shape} T={T or shape[1]} "
                    f"{str(dtype)[6:]} causal={causal} scale="
                    f"{scale or 'hd^-0.5'}")
            check(bool(((got - want).abs() <= tol + tol * want.abs()).all()),
                  f"{what}: max abs err {err} over tol {tol}")
            log(f"{what}: max abs err {err:.3e} (tol {tol})")
            if dtype == bf16:
                path_err = max(path_err, err)
    return path_err


def flash_bound(shape, causal=True, window=0):
    """Least time of one GQA forward at ``shape`` (S = T; bf16 in, f32
    out): each input read once and the output written once, against the
    FLOPs of the unmasked score pairs (QK^T and P.V, 2 each; a causal
    row q keeps min(q + 1, window) keys under a window)."""
    B, S, H, K, hd = shape
    nbytes = 2 * (B * S * H * hd + 2 * B * S * K * hd) + 4 * B * S * H * hd
    if causal and window:
        w = min(window, S)
        pairs = w * (w + 1) // 2 + (S - w) * w
    else:
        pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * B * H * hd * pairs
    t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), \
        nbytes, flops


def flash_tile_flops(shape):
    """The bf16 kernel's own tensor-core work at ``shape`` (causal, S =
    T): QK^T and the split P.V (two bf16 products) over whole 64 x 64
    tiles (its q and kv blocks) up to the diagonal."""
    B, S, H, K, hd = shape
    tiles = sum(-(-min(q0 + 64, S) // 64) for q0 in range(0, S, 64))
    return 3 * 2.0 * 64 * 64 * hd * tiles * B * H


def kernel_flash_at_path(torch, AK, AR, rng, dev, err):
    """The prefill's attention at B 8, S = T 1024, bf16 in, causal: the
    kernel and PyTorch's scaled_dot_product_attention (the library
    yardstick, never called by the port) timed in turns (kernel, SDPA,
    SDPA, kernel), the plain version, and the f32 instance at the same
    shape."""
    import torch.nn.functional as F
    q, k, v = _qkv(torch, rng, FLASH_SHAPE, torch.bfloat16, dev)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kern = lambda: AK.flash_attention(q, k, v)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    turns = [event_ms(torch, fn, reps=50) for fn in (kern, sdpa, sdpa, kern)]
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    plain_ms = event_ms(torch, lambda: AR.attention_ref(q, k, v), reps=5)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_ms = event_ms(torch, lambda: AK.flash_attention(q32, k32, v32),
                      reps=5)
    bound_ms, bound_by, nbytes, flops = flash_bound(FLASH_SHAPE)
    tile_flops = flash_tile_flops(FLASH_SHAPE)
    log(f"flash_attention timing {FLASH_SHAPE} bf16 causal, in turns "
        f"kernel/SDPA/SDPA/kernel: {turns[0]:.4f} / {turns[1]:.4f} / "
        f"{turns[2]:.4f} / {turns[3]:.4f} ms")
    log(f"flash_attention {FLASH_SHAPE} bf16 causal: {ms:.4f} ms (bound "
        f"{bound_ms:.4f} ms by {bound_by}, {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP: {flops / ms / 1e9:.1f} TFLOP/s; the "
        f"kernel's own tensor-core work {tile_flops / 1e9:.2f} GFLOP: "
        f"{tile_flops / ms / 1e9:.1f} TFLOP/s), SDPA {lib_ms:.4f} ms "
        f"({flops / lib_ms / 1e9:.1f} TFLOP/s, kernel/SDPA "
        f"{ms / lib_ms:.2f}), plain {plain_ms:.4f} ms, the f32 instance "
        f"{f32_ms:.4f} ms")
    check(ms <= 3 * lib_ms, f"flash_attention {ms:.4f} ms is over 3x "
          f"SDPA's {lib_ms:.4f} ms: the tensor-core path is not running")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "turns_ms": turns, "f32_ms": f32_ms,
            "tflops": flops / ms / 1e9, "tile_tflops": tile_flops / ms / 1e9}


def _sync_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def perturbed_plain_attention(torch, ops, rel, seed, dev):
    """The plain attention with its float32 output multiplied by
    1 + u, u uniform in [-rel, rel]: a control for how far a difference
    of that size in the attention alone moves the model's logits."""
    orig = ops.attention_ref
    g = torch.Generator(device=dev).manual_seed(seed)

    def noisy(*a, **k):
        out = orig(*a, **k)
        u = torch.rand(out.shape, generator=g, device=out.device)
        return out * (1.0 + rel * (2.0 * u - 1.0))

    ops.attention_ref = noisy
    try:
        yield
    finally:
        ops.attention_ref = orig


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_model(torch, AK, AO, cfgs, models, rng, seed, dev):
    """The full-width model: random weights, a prefill of 8 x 1024 tokens
    through the kernel and through the plain attention, in bf16 (the
    path) and in float32 on the same weights."""
    cfg = cfgs.get_config(ARCH)
    model = models.build_model(cfg, torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (SERVE_B, PREFILL_S)), device=dev)
    batch = {"tokens": toks}
    plain = models.build_model(cfg, torch.bfloat16, kernel_impl="plain")
    with torch.inference_mode():
        model.prefill(params, batch)                      # warm-up
        AK.reset_launch_counts()
        (lk, cache), ms_k = _sync_ms(torch, lambda: model.prefill(params,
                                                                  batch))
        launches = AK.launch_counts()["flash_attention"]
        (lp, _), ms_p = _sync_ms(torch, lambda: plain.prefill(params, batch))
        with perturbed_plain_attention(torch, AO, 2.0 ** -23, seed, dev):
            lc, _ = plain.prefill(params, batch)
        # float32 on the same (bf16-valued) weights: the kernel's f32 path
        p32 = _map(params, lambda t: t.float())
        m32 = models.build_model(cfg, torch.float32)
        plain32 = models.build_model(cfg, torch.float32, kernel_impl="plain")
        lk32, _ = m32.prefill(p32, batch)
        lp32, _ = plain32.prefill(p32, batch)
        del p32
    check(launches == cfg.n_layers,
          f"flash_attention launched {launches} times in a "
          f"{cfg.n_layers}-layer prefill")
    check(bool(torch.isfinite(lk).all() and torch.isfinite(lk32).all()),
          "non-finite prefill logits")
    rel16, ctrl16 = _rel_l2(lk, lp), _rel_l2(lc, lp)
    rel32 = _rel_l2(lk32, lp32)
    check(rel32 <= 1e-2, f"f32 prefill logits: kernel vs plain attention "
          f"rel L2 {rel32}")
    kv_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    log(f"model {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.padded_vocab}; weights {w_bytes / 1e9:.3f} "
        f"GB bf16 (init {t_init:.1f} s)")
    log(f"prefill {SERVE_B} x {PREFILL_S}: kernel {ms_k:.1f} ms, plain "
        f"attention {ms_p:.1f} ms (host clock, synchronized), "
        f"{launches} flash launches; KV cache {kv_bytes / 1e6:.1f} MB")
    log(f"last logits, kernel vs plain attention: rel L2 {rel32:.3e} in f32 "
        f"(gate 1e-2), {rel16:.3e} in bf16; control: the bf16 plain path "
        f"with its attention output moved by <= 1 f32 ulp (2^-23 "
        f"relative) differs from itself by {ctrl16:.3e}")
    return model, params, {"prefill_8x1024_ms": ms_k,
                           "prefill_8x1024_plain_attn_ms": ms_p,
                           "logits_rel_l2_f32": rel32,
                           "logits_rel_l2_bf16": rel16,
                           "logits_rel_l2_bf16_1ulp_control": ctrl16,
                           "weight_bytes": w_bytes,
                           "kv_bytes_8x1024": kv_bytes}


def _map(tree, fn):
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def decode_cache(model, c, B, L, dev, max_seq=SERVE_MAX_SEQ):
    """The cache a round decodes from, as the engine builds it: the KV
    cache padded to max_seq (dense, and the hybrid's k/v), the prefill's
    conv and SSM states as they are (ssm and hybrid: the round's prompt
    length is neither ssm_conv - 1, H nor B)."""
    if model.cfg.family == "ssm":
        return c
    cache = model.init_cache(B, max_seq, device=dev)
    for n in cache:
        if n in ("k", "v"):
            cache[n][:, :, :L] = c[n]
        else:
            cache[n].copy_(c[n])
    return cache


def cache_bytes(model, batch, max_seq):
    spec, _ = model.cache_spec(batch, max_seq)
    return sum(int(np.prod(shape)) * dtype.itemsize
               for shape, dtype in spec.values())


def direct_generate(torch, model, params, rows, dev):
    """Greedy prefill + decode of one round, as the engine runs it (the
    rows at equal length here): (tokens (B, SERVE_NEW), prefill ms,
    decode ms per token)."""
    B, L = rows.shape
    with torch.inference_mode():
        (logits, c), pre_ms = _sync_ms(torch, lambda: model.prefill(
            params, {"tokens": torch.as_tensor(rows, device=dev)}))
        cache = decode_cache(model, c, B, L, dev)
        cur = torch.argmax(logits[:, -1], -1).to(torch.int32)
        pos = torch.full((B,), L, device=dev)
        outs = [cur]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_NEW - 1):
            cur, cache = model.decode_step(params, cache, cur, pos)
            pos = pos + 1
            outs.append(cur)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / (SERVE_NEW - 1)
    return torch.stack(outs, 1).cpu().numpy(), pre_ms, dec_ms


_CATEGORIES = (("flash_attention", ("flash_fwd",)),
               ("ssd_chunk", ("ssd_chunk_kernel",)),
               ("gemm", ("gemm", "gemv", "xmma", "nvjet", "cutlass")),
               ("softmax", ("softmax",)),
               ("copy", ("memcpy", "memset", "copy")),
               ("reduce", ("reduce",)))


CONV_SPAN = "repro.causal_conv"     # profiler range around the ssm conv


@contextlib.contextmanager
def conv_spans(torch, ssm):
    """Wrap the mamba block's depthwise conv (prefill and decode) in a
    profiler range, so that a trace can attribute its kernels."""
    orig = ssm.causal_conv1d, ssm.conv_decode_step

    def spanned(fn):
        def run(*a, **k):
            with torch.profiler.record_function(CONV_SPAN):
                return fn(*a, **k)
        return run

    ssm.causal_conv1d, ssm.conv_decode_step = map(spanned, orig)
    try:
        yield
    finally:
        ssm.causal_conv1d, ssm.conv_decode_step = orig


def _span_kernels(torch, events, span):
    """(name, µs) of the device kernels launched inside ``span`` ranges:
    the kernels of every CPU op below such a range."""
    cpu = torch.autograd.DeviceType.CPU
    out, stack = [], [e for e in events
                      if e.device_type == cpu and e.name == span]
    while stack:
        e = stack.pop()
        out.extend((k.name, k.duration) for k in e.kernels)
        stack.extend(e.cpu_children)
    return out


def _category(name: str, categories=_CATEGORIES) -> str:
    name = name.lower()
    return next((c for c, keys in categories
                 if any(k in name for k in keys)), "other")


def _trace_split(torch, prof, wall_ms, steps, categories=_CATEGORIES,
                 span=(CONV_SPAN, "conv")):
    """Device time per kernel category from a torch.profiler trace, per
    step: the sum of kernel durations (one stream), their count, and the
    card's idle share of the host wall time (the profiler's own overhead
    included in the wall).  Kernels launched inside a ``span[0]`` range
    move from their category to ``span[1]``; the range's own device
    annotation is no kernel."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    split = {c: 0.0 for c, _ in categories}
    split[span[1]] = split["other"] = 0.0
    n = 0
    for e in events:
        if e.device_type != cuda or e.name == span[0]:
            continue
        n += 1
        split[_category(e.name, categories)] += \
            e.time_range.elapsed_us() / 1e3
    for name, us in _span_kernels(torch, events, span[0]):
        split[_category(name, categories)] -= us / 1e3
        split[span[1]] += us / 1e3
    if n == 0:
        return None
    busy = sum(split.values())
    return {"wall_ms": wall_ms / steps, "device_ms": busy / steps,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "kernels": n / steps,
            **{f"{c}_ms": v / steps for c, v in split.items()}}


def phase_profile(torch, model, params, rows, dev, categories=_CATEGORIES):
    """One prefill round and ``PROFILE_STEPS`` decode steps of the
    serving path under torch.profiler: where the device time goes (by
    ``categories``), and how idle the card is."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    B, L = rows.shape
    toks = torch.as_tensor(rows, device=dev)
    out = {}
    with torch.inference_mode():
        model.prefill(params, {"tokens": toks})            # warm-up
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            (logits, c), ms = _sync_ms(torch, lambda: model.prefill(
                params, {"tokens": toks}))
        out["prefill"] = _trace_split(torch, prof, ms, 1, categories)
        cache = decode_cache(model, c, B, L, dev)
        cur = torch.argmax(logits[:, -1], -1).to(torch.int32)
        pos = torch.full((B,), L, device=dev)
        cur, cache = model.decode_step(params, cache, cur, pos)   # warm-up
        steps = PROFILE_STEPS

        def decode():
            nonlocal cur, cache, pos
            for _ in range(steps):
                pos = pos + 1
                cur, cache = model.decode_step(params, cache, cur, pos)

        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            _, ms = _sync_ms(torch, decode)
        out["decode_step"] = _trace_split(torch, prof, ms, steps,
                                          categories)
    for k, v in out.items():
        if v is None:
            log(f"profile {k}: no device events in the trace (not measured)")
        else:
            log(f"profile {k} ({B} x {L}, cache {SERVE_MAX_SEQ}): "
                + ", ".join(f"{n} {x:.3f}" for n, x in v.items()))
    return out


def phase_serve(torch, KK, kname, MK, serve, model, params, rng, dev,
                spans=contextlib.nullcontext, prompts=None,
                categories=_CATEGORIES, per_round=None, also=()):
    """A serving path: requests through the engine's QoS lanes, batched
    prefill through the kernel ``kname`` of module ``KK`` (``per_round``
    launches a round, default one per layer), greedy decode.  ``also``
    holds further (module, kernel, launches a round) the rounds must
    launch, counted into the stats.  ``spans`` wraps the trace, which
    splits by ``categories``; the requests' prompts are appended to
    ``prompts`` when given."""
    t_phase = time.perf_counter()
    per_round = per_round or model.cfg.n_layers
    eng = serve.Engine(model, params, serve.ServeConfig(
        batch_size=SERVE_B, max_seq=SERVE_MAX_SEQ, queue_capacity=64),
        device=dev)
    rounds = []
    prefill = eng._prefill

    def counted_prefill(p, batch):
        rounds.append(batch["tokens"].shape)
        return prefill(p, batch)

    eng._prefill = counted_prefill
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, SERVE_REQS)
    reqs = [serve.Request(rid=i, tokens=rng.integers(
        0, model.cfg.vocab_size, int(n)).astype(np.int32), max_new=SERVE_NEW,
        qos=("blocking", "nonblocking")[i % 2]) for i, n in enumerate(lens)]
    if prompts is not None:
        prompts.extend(r.tokens for r in reqs)
    KK.reset_launch_counts()
    MK.reset_launch_counts()
    for mod, _, _ in also:
        mod.reset_launch_counts()
    eng.start()
    t0 = time.perf_counter()
    for r in reqs:
        check(eng.submit(r, timeout=60.0), f"request {r.rid} not admitted")
    for r in reqs:
        check(r.done.wait(timeout=600), f"request {r.rid} timed out")
    wall = time.perf_counter() - t0
    n_rounds = len(rounds)
    launched = KK.launch_counts()[kname]
    also_launched = {name: mod.launch_counts()[name]
                     for mod, name, _ in also}
    crashes = list(eng._crashes)
    check(not crashes, f"serve worker crashed: {crashes}")
    for r in reqs:
        check(r.out is not None and r.out.shape == (SERVE_NEW,),
              f"request {r.rid} answered {r.out}")
    for name, got, per in ((kname, launched, per_round),) + tuple(
            (name, also_launched[name], per) for _, name, per in also):
        check(got == per * n_rounds,
              f"{name} launched {got} times in {n_rounds} rounds")
    # one request alone: its round is the request replicated to the batch
    solo = serve.Request(rid=SERVE_REQS, tokens=reqs[0].tokens,
                         max_new=SERVE_NEW)
    check(eng.submit(solo, timeout=60.0), "solo request not admitted")
    check(solo.done.wait(timeout=600), "solo request timed out")
    time.sleep(0.5)                # let the lanes' monitor dispatch again
    rates = eng.class_rates()
    monitor = MK.launch_counts()["monitor_fleet"]
    crashes = list(eng._crashes)
    eng.stop()
    check(not crashes, f"serve worker crashed: {crashes}")
    check(monitor > 0, "monitor_fleet never launched on the lanes")
    check(all(np.isfinite(v) for d in rates.values() for v in d.values()),
          f"class_rates not finite: {rates}")
    rows = np.repeat(solo.tokens[None], SERVE_B, axis=0)
    direct, pre_ms, dec_ms = direct_generate(torch, model, params, rows, dev)
    with spans():
        trace = phase_profile(torch, model, params, rows, dev, categories)
    check(np.array_equal(solo.out, direct[0]),
          f"engine tokens {solo.out} != direct decode {direct[0]}")
    new_tokens = SERVE_REQS * SERVE_NEW
    c_bytes = cache_bytes(model, SERVE_B, SERVE_MAX_SEQ)
    log(f"serve: {SERVE_REQS} requests (prompts {int(lens.min())}-"
        f"{int(lens.max())} tokens, {SERVE_NEW} new each) in {n_rounds} "
        f"rounds {[tuple(s) for s in rounds[:n_rounds]]}, {wall:.2f} s wall, "
        f"{new_tokens / wall:.1f} new tokens/s, "
        f"{int(lens.sum() + new_tokens) / wall:.0f} prompt+new tokens/s; "
        f"{kname} launches {launched}, monitor_fleet launches {monitor}, "
        f"no crash; class rates {rates}")
    log(f"round of {SERVE_B} x {len(solo.tokens)}: prefill {pre_ms:.1f} ms, "
        f"decode {dec_ms:.2f} ms per token (host clock, synchronized); "
        f"cache {c_bytes / 1e9:.3f} GB at max_seq {SERVE_MAX_SEQ}; "
        f"engine tokens equal the direct decode")
    return launched, {"serve_wall_s": wall, "serve_rounds": n_rounds,
                   **{f"{name}_launches": n
                      for name, n in also_launched.items()},
                   "new_tokens_per_s": new_tokens / wall,
                   "round_prefill_ms": pre_ms, "round_prompt_len":
                   len(solo.tokens), "decode_ms_per_token": dec_ms,
                   "cache_bytes": c_bytes, "monitor_launches": monitor,
                   "trace": trace,
                   "serve_phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the ssm serving path: the SSD chunk kernel, mamba2 at full width


def _ssd_inputs(torch, rng, lead, H, P, N, dev, init=False):
    """Drawn as the JAX package's SSD kernel test draws them: normal x, B
    and C; softplus-normal dt; A = -exp(normal).  With ``init`` dt and A
    come from Mamba-2's published initialisation instead (dt log-uniform
    on [1e-3, 0.1], A uniform on [-16, -1]), whose chunk decays stay in
    float32's normal range."""
    mk = lambda a: torch.as_tensor(a.astype(np.float32),  # noqa: E731
                                   device=dev)
    x = rng.standard_normal(lead + (H, P))
    if init:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), lead + (H,)))
        A = -rng.uniform(1.0, 16.0, H)
    else:
        dt = np.log1p(np.exp(rng.standard_normal(lead + (H,))))
        A = -np.exp(rng.standard_normal(H))
    return (mk(x), mk(dt), mk(A), mk(rng.standard_normal(lead + (N,))),
            mk(rng.standard_normal(lead + (N,))))


# per output of the chunk step, the dims of one (b, c, h) slice: y and
# state are gated against their own slice's largest value, decay entry by
# entry, so a head whose values are small is held as tightly as any other
_SSD_SLICE = (("y", (2, 4)), ("state", (3, 4)), ("decay", ()))


def phase_ssd(torch, SK, SR, SO, rng, dev):
    """Kernel against its plain version on the card: the chunked op on
    the JAX package's kernel-test shapes and chunks, and the chunk kernel
    at odd shapes (rtol = atol = 1e-4); then at the paths' shapes
    (mamba2's and zamba2's chunk steps), with the test's draws and with
    Mamba-2's initialisation, where each
    output's error is at most 1e-4 of the largest |plain| in its
    (b, c, h) slice (y, state) or of |plain| itself (decay; entries
    below 1e-30 are held to 1e-34 absolute)."""
    tol = 1e-4
    for shape in ((1, 32, 2, 8, 8), (2, 64, 4, 8, 16), (2, 128, 2, 16, 32)):
        B, S, H, P, N = shape
        ins = _ssd_inputs(torch, rng, (B, S), H, P, N, dev)
        for chunk in (8, 16, 32):
            got = SO.ssd_chunked(*ins, chunk, impl="kernel")
            want = SO.ssd_chunked(*ins, chunk, impl="plain")
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                check(bool(((g - w).abs() <= tol + tol * w.abs()).all()),
                      f"ssd_chunked {shape} chunk {chunk}: max abs err "
                      f"{float((g - w).abs().max())}")
        log(f"ssd_chunked {shape} chunks 8/16/32: kernel = plain within "
            f"{tol}")
    for lead, H, P, N in (((2, 3, 37), 3, 32, 16), ((1, 2, 100), 9, 64, 64),
                          ((1, 1, 1), 2, 8, 8)):
        ins = _ssd_inputs(torch, rng, lead, H, P, N, dev)
        for g, w in zip(SK.ssd_chunk(*ins), SR.ssd_chunk_batched_ref(*ins)):
            check(bool(((g - w).abs() <= tol + tol * w.abs()).all()),
                  f"ssd_chunk {lead} H {H} P {P} N {N}: max abs err "
                  f"{float((g - w).abs().max())}")
    err = 0.0
    for shape, init in itertools.product((SSD_SHAPE, ZAMBA_SSD_SHAPE),
                                         (False, True)):
        B, c, Q, H, P, N = shape
        draw = "Mamba-2 init" if init else "test draws"
        ins = _ssd_inputs(torch, rng, (B, c, Q), H, P, N, dev, init=init)
        got = SK.ssd_chunk(*ins)
        want = SR.ssd_chunk_batched_ref(*ins)
        torch.cuda.synchronize()
        for (name, dims), g, w in zip(_SSD_SLICE, got, want):
            check(bool(torch.isfinite(g).all()),
                  f"ssd_chunk {name}: non-finite")
            d = (g - w).abs()
            scale = (w.abs().amax(dim=dims, keepdim=True) if dims
                     else w.abs()).clamp_min(1e-30)
            rel = float((d / scale).max())
            e = float(d.max())
            check(rel <= tol, f"ssd_chunk {name} at {shape} ({draw}): "
                  f"error {rel} of its scale > {tol} (max abs err {e})")
            live = float((w.abs() > 1e-30).float().mean())
            log(f"ssd_chunk {name} at {shape} ({draw}): max abs err "
                f"{e:.3e}, {rel:.3e} of its scale (gate {tol}); "
                f"{live:.4f} of |plain| above 1e-30")
            err = max(err, e)
    return err


def ssd_bound(shape):
    """Least time of one chunk step at ``shape`` (float32 in and out):
    each input read once and each output written once, against the
    least work -- C.B^T once per chunk and the causal half of the
    products (2 FLOP per multiply-add) -- at the fastest rate that holds
    every SSD gate: 3xTF32 on the tensor cores, three TF32 products per
    float32 product at 495 TFLOP/s (a bf16 split with three products
    misses the element-wise 1e-4 gate: tests/test_torch_ssd.py)."""
    B, c, Q, H, P, N = shape
    rows, pairs = B * c * Q, B * c * Q * (Q + 1) // 2
    nbytes = 4 * (rows * H * P * 2 + rows * H + H + 2 * rows * N
                  + B * c * H * P * N + B * c * H)
    flops = 2.0 * (pairs * N + pairs * H * P + rows * H * P * N)
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = 3 * flops / PEAK_TF32_FLOPS * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), \
        nbytes, flops


def ssd_kernel_flops(shape):
    """The kernel's own tensor-core work at ``shape``, as ssd.cu issues
    it: scores over whole 64 x 64 tiles up to the diagonal once per
    group of 8 heads, y over 8-row k-steps up to each 32-row warp tile's
    last row, the states over 8-row k-steps, P padded to 16 rows and N
    to 64 columns; three TF32 products each, 2 FLOP per multiply-add."""
    B, c, Q, H, P, N = shape
    nb, groups = -(-Q // 64), -(-H // 8)
    k_n = sum(-(-min(32, N - n0) // 8) * 8 for n0 in range(0, N, 32))
    scores = sum(ib + 1 for ib in range(nb)) * 64 * 64 * k_n * groups
    y = 0
    for ib in range(nb):
        for jt in range(ib + 1):
            ks = -(-min(64, Q - 64 * jt) // 8)
            y += sum(min(ks, 4 * w + 4) if jt == ib else ks
                     for w in range(2)) * 8 * 32 * P
    state = -(-Q // 8) * 8 * max(P, 16) * 64 * -(-N // 64)
    return 3 * 2.0 * B * c * (scores + H * (y + state))


def kernel_ssd_at_path(torch, SK, SR, rng, dev, err):
    """The prefill's chunk step at B 8, S 1024 (Q 256, c 4), H 80, P 64,
    N 128: the kernel and its plain version, the kernel's rate of its
    own 3xTF32 work and its registers and spills as ptxas reported them.
    No single PyTorch call computes this function."""
    from repro_torch.kernels._build import ptxas_report
    B, c, Q, H, P, N = SSD_SHAPE
    ins = _ssd_inputs(torch, rng, (B, c, Q), H, P, N, dev)
    ms = event_ms(torch, lambda: SK.ssd_chunk(*ins), reps=10)
    plain_ms = event_ms(torch, lambda: SR.ssd_chunk_batched_ref(*ins),
                        reps=3, warm=1)
    bound_ms, bound_by, nbytes, flops = ssd_bound(SSD_SHAPE)
    own = ssd_kernel_flops(SSD_SHAPE)
    log(f"ssd_chunk timing {SSD_SHAPE} f32: {ms:.4f} ms (bound "
        f"{bound_ms:.4f} ms by {bound_by}: {nbytes / 1e6:.1f} MB is "
        f"{nbytes / PEAK_BYTES_S * 1e3:.4f} ms, {flops / 1e9:.2f} GFLOP is "
        f"{3 * flops / PEAK_TF32_FLOPS * 1e3:.4f} ms as 3xTF32 tensor-core "
        f"products, {flops / PEAK_F32_FLOPS * 1e3:.4f} ms at the f32 rate; "
        f"{flops / ms / 1e9:.1f} TFLOP/s of the function; the kernel's own "
        f"3xTF32 work {own / 1e9:.2f} GFLOP: {own / ms / 1e9:.1f} "
        f"TFLOP/s), plain {plain_ms:.4f} ms")
    for r in ptxas_report(Path(str(SK.build()) + ".log").read_text()):
        log(f"ssd_chunk ptxas {r['kernel']}: {r['registers']} registers, "
            f"{r['spill_stores']}/{r['spill_loads']} B spill stores/loads")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "tflops": flops / ms / 1e9, "own_tflops": own / ms / 1e9}


@contextlib.contextmanager
def perturbed_plain_ssd(torch, ops, rel, seed, dev):
    """The plain SSD chunk step with its float32 outputs multiplied by
    1 + u, u uniform in [-rel, rel]: a control for how far a difference
    of that size in the SSD alone moves the model's logits."""
    orig = ops.ssd_chunk_batched_ref
    g = torch.Generator(device=dev).manual_seed(seed)

    def noisy(*a, **k):
        return tuple(o * (1.0 + rel * (2.0 * torch.rand(
            o.shape, generator=g, device=o.device) - 1.0))
            for o in orig(*a, **k))

    ops.ssd_chunk_batched_ref = noisy
    try:
        yield
    finally:
        ops.ssd_chunk_batched_ref = orig


def mamba2_decay_init(torch, blocks, g):
    """Mamba-2's published initialisation of the decay parameters, in
    place: A uniform on [1, 16] (A_log = log A) and dt log-uniform on
    [1e-3, 0.1] (dt_bias = softplus^-1(dt)).  The model's own init
    leaves both zero, so A = -1, dt ~ softplus(projection) and every
    chunk of 256 tokens decays its state to about exp(-200): the SSD's
    carried state would then not reach the logits at all."""
    A, bias = blocks["A_log"], blocks["dt_bias"]
    u = lambda t: torch.rand(t.shape, generator=g,  # noqa: E731
                             device=t.device)
    A.copy_(torch.log(1.0 + 15.0 * u(A)))
    dt = torch.exp(np.log(1e-3) + (np.log(0.1) - np.log(1e-3)) * u(bias))
    bias.copy_(dt + torch.log(-torch.expm1(-dt)))


def phase_ssm_model(torch, SK, SO, cfgs, models, rng, seed, dev):
    """mamba2-2.7b at its published widths: random bf16 weights with
    Mamba-2's decay initialisation, a prefill of 8 x 1024 tokens through
    the SSD kernel and through the plain SSD, in bf16 (the path) and in
    float32 on the same weights, then greedy decode steps at batch 8."""
    cfg = cfgs.get_config(SSM_ARCH)
    model = models.build_model(cfg, torch.bfloat16)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(g, torch.bfloat16, device=dev)
    mamba2_decay_init(torch, params["blocks"], g)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (SERVE_B, PREFILL_S)), device=dev)
    batch = {"tokens": toks}
    plain = models.build_model(cfg, torch.bfloat16, kernel_impl="plain")
    with torch.inference_mode():
        model.prefill(params, batch)                      # warm-up
        SK.reset_launch_counts()
        (lk, cache), ms_k = _sync_ms(torch, lambda: model.prefill(params,
                                                                  batch))
        launches = SK.launch_counts()["ssd_chunk"]
        (lp, _), ms_p = _sync_ms(torch, lambda: plain.prefill(params, batch))
        with perturbed_plain_ssd(torch, SO, 2.0 ** -23, seed, dev):
            lc, _ = plain.prefill(params, batch)
        cur = torch.argmax(lk[:, -1], -1).to(torch.int32)
        pos = torch.full((SERVE_B,), PREFILL_S, device=dev)
        cur, cache = model.decode_step(params, cache, cur, pos)   # warm-up
        steps = 8

        def decode():
            nonlocal cur, cache, pos
            for _ in range(steps):
                pos = pos + 1
                cur, cache = model.decode_step(params, cache, cur, pos)

        _, dec_ms = _sync_ms(torch, decode)
        dec_ms /= steps
        state_bytes = sum(t.numel() * t.element_size()
                          for t in cache.values())
        del cache
        # float32 on the same (bf16-valued) weights: the kernel's f32 path
        p32 = _map(params, lambda t: t.float())
        m32 = models.build_model(cfg, torch.float32)
        plain32 = models.build_model(cfg, torch.float32, kernel_impl="plain")
        lk32, _ = m32.prefill(p32, batch)
        lp32, _ = plain32.prefill(p32, batch)
        del p32
    check(launches == cfg.n_layers,
          f"ssd_chunk launched {launches} times in a {cfg.n_layers}-layer "
          f"prefill")
    check(bool(torch.isfinite(lk).all() and torch.isfinite(lk32).all()),
          "non-finite prefill logits")
    rel16, ctrl16 = _rel_l2(lk, lp), _rel_l2(lc, lp)
    rel32 = _rel_l2(lk32, lp32)
    check(rel32 <= 1e-3, f"f32 prefill logits: SSD kernel vs plain rel L2 "
          f"{rel32}")
    log(f"model {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, {cfg.ssm_nheads} SSD heads x "
        f"{cfg.ssm_headdim}, N {cfg.ssm_state}, conv {cfg.ssm_conv}, chunk "
        f"{cfg.ssm_chunk}, vocab {cfg.padded_vocab}; {n_params / 1e9:.3f} B "
        f"parameters, {w_bytes / 1e9:.3f} GB (init {t_init:.1f} s)")
    log(f"prefill {SERVE_B} x {PREFILL_S}: SSD kernel {ms_k:.1f} ms, plain "
        f"SSD {ms_p:.1f} ms (host clock, synchronized), {launches} "
        f"ssd_chunk launches; decode {dec_ms:.2f} ms per token at batch "
        f"{SERVE_B}; state {state_bytes / 1e9:.3f} GB")
    log(f"last logits, SSD kernel vs plain: rel L2 {rel32:.3e} in f32 "
        f"(gate 1e-3), {rel16:.3e} in bf16; control: the bf16 plain path "
        f"with its SSD outputs moved by <= 1 f32 ulp (2^-23 relative) "
        f"differs from itself by {ctrl16:.3e}")
    return model, params, {"prefill_8x1024_ms": ms_k,
                           "prefill_8x1024_plain_ssd_ms": ms_p,
                           "decode_ms_per_token_8x1024": dec_ms,
                           "logits_rel_l2_f32": rel32,
                           "logits_rel_l2_bf16": rel16,
                           "logits_rel_l2_bf16_1ulp_control": ctrl16,
                           "n_params": n_params, "weight_bytes": w_bytes,
                           "state_bytes": state_bytes}



# ---------------------------------------------------------------------------
# phase (i): the training path


def flash_bwd_bound(shape):
    """Least time of one causal GQA backward at ``shape``: bf16 q, k, v
    and float32 o, dO and lse read once, float32 dq, dk and dv written
    once, against the five bf16 products (QK^T, dO.V^T, P^T.dO, dS.K,
    dS^T.Q) over the unmasked score pairs at 989 TFLOP/s."""
    B, S, H, K, hd = shape
    nbytes = (2 * (B * S * H * hd + 2 * B * S * K * hd)
              + 4 * (2 * B * S * H * hd + B * H * S)
              + 4 * (B * S * H * hd + 2 * B * S * K * hd))
    pairs = S * (S + 1) // 2
    flops = 5 * 2.0 * B * H * hd * pairs
    t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), \
        nbytes, flops


def flash_bwd_tile_flops(shape):
    """The backward kernels' own tensor-core work at ``shape`` (causal,
    S = T): the five products over whole 64 x 64 tiles, masked halves of
    the diagonal tiles included (the dK/dV kernel's QK^T, dO.V^T, P^T.dO
    and dS^T.Q; the dQ kernel's QK^T, dO.V^T and dS.K: seven in all)."""
    B, S, H, K, hd = shape
    blocks = -(-S // 64)
    tiles = blocks * (blocks + 1) // 2
    return 7 * 2.0 * 64 * 64 * hd * tiles * B * H


def _bwd_errs(got, want):
    return ([_rel_l2(g, w) for g, w in zip(got, want)],
            max(float((g - w).abs().max()) for g, w in zip(got, want)))


def phase_flash_bwd(torch, AK, AR, rng, dev, seed):
    """(i.1) The backward kernel against ``attention_bwd_ref`` on the
    card, each output by relative L2: bf16 at the training path's shape
    and at every head dim with GQA 1, 2 and 4, S != T both ways, S and T
    off the 64-row blocks, causal or not (1e-2), float32 at every head
    dim, non-causal, S != T, tails and an explicit scale (1e-4); the
    forward's lse against ``attention_lse_ref``; two calls give equal
    bits; two controls that the gate fails: the kernel fed a natural-log
    lse (the base-2 hazard) and the plain version at a scale 2% off.  Then
    timed at the path's shape in turns with SDPA's backward (autograd
    through ``scaled_dot_product_attention``, its forward outside the
    timed window), and the time split over its three kernels by a
    profiler trace."""
    import torch.nn.functional as F
    f32, bf16 = torch.float32, torch.bfloat16
    own = np.random.default_rng((seed, 9))
    cases = [(BWD_SHAPE, None, bf16, True, None, 1e-2, rng)]
    cases += [((2, 300, 4, 2, hd), None, f32, True, None, 1e-4, own)
              for hd in AK.BWD_HEAD_DIMS]
    cases += [((2, 300, 4, 2, 128), None, f32, False, 0.3, 1e-4, own),
              ((1, 1000, 8, 2, 64), None, f32, True, None, 1e-4, own),
              ((1, 1000, 8, 2, 64), None, f32, False, None, 1e-4, own),
              ((1, 77, 4, 2, 32), 250, f32, True, 0.2, 1e-4, own),
              ((1, 250, 4, 1, 32), 77, f32, False, None, 1e-4, own),
              ((2, 1000, 16, 8, 128), None, bf16, False, 0.1, 1e-2, own)]
    # the tensor-core kernels: (B, S, H, K, hd), T, causal, scale
    cases += [(shape, T, bf16, causal, scale, 1e-2, own)
              for shape, T, causal, scale in (
                  ((2, 300, 4, 4, 16), None, True, None),
                  ((1, 77, 4, 2, 16), 250, True, None),
                  ((1, 250, 8, 2, 32), 77, False, 0.2),
                  ((2, 333, 8, 8, 32), 520, True, None),
                  ((1, 520, 8, 2, 64), 333, True, None),
                  ((2, 190, 4, 1, 64), 300, False, None),
                  ((1, 300, 8, 4, 128), 190, True, None),
                  ((1, 130, 4, 1, 128), 700, True, 0.1),
                  ((2, 700, 8, 2, 128), 130, False, None))]
    path_err, controls = 0.0, {}
    for shape, T, dtype, causal, scale, tol, gen in cases:
        B, S, H, K, hd = shape
        q, k, v = _qkv(torch, gen, shape, dtype, dev, T)
        do = torch.as_tensor(gen.standard_normal((B, S, H, hd)).astype(
            np.float32), device=dev)
        with torch.no_grad():
            o, lse = AK.flash_attention(q, k, v, causal=causal, scale=scale,
                                        return_lse=True)
            got = AK.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         scale=scale)
            want = AR.attention_bwd_ref(q, k, v, o, do, causal=causal,
                                        scale=scale)
            lse_err = float((lse - AR.attention_lse_ref(
                q, k, causal=causal, scale=scale)).abs().max())
        torch.cuda.synchronize()
        rels, err = _bwd_errs(got, want)
        what = (f"flash_attention_bwd {shape} T={T or S} {str(dtype)[6:]} "
                f"causal={causal} scale={scale or 'hd^-0.5'}")
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{what}: non-finite gradients")
        check(lse_err <= 1e-3, f"{what}: forward lse off by {lse_err}")
        check(max(rels) <= tol, f"{what}: rel L2 dq/dk/dv {rels} over "
              f"{tol}")
        log(f"{what}: rel L2 dq {rels[0]:.3e} dk {rels[1]:.3e} dv "
            f"{rels[2]:.3e} (gate {tol}), max abs err {err:.3e}, forward "
            f"lse max abs err {lse_err:.3e}")
        if shape == BWD_SHAPE:
            path_err = err
            with torch.no_grad():
                again = AK.flash_attention_bwd(q, k, v, o, do, lse,
                                               causal=causal, scale=scale)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{what}: two calls differ")
            log(f"{what}: two calls give equal bits")
            del again
            with torch.no_grad():
                wrong = AK.flash_attention_bwd(q, k, v, o, do,
                                               lse / AR.LOG2E)
                off = AR.attention_bwd_ref(q, k, v, o, do, scale=1.02
                                           * hd ** -0.5)
            controls = {"natural_log_lse": max(_bwd_errs(wrong,
                                                         want)[0]),
                        "scale_2pct_off": max(_bwd_errs(off,
                                                        want)[0])}
            for name, c in controls.items():
                check(c > tol, f"control {name}: rel L2 {c} within the "
                      f"gate {tol}, so the gate could not fail")
            log(f"controls at {shape}: the kernel fed a natural-log lse "
                f"rel L2 {controls['natural_log_lse']:.3e}, the plain "
                f"version at 1.02 x scale {controls['scale_2pct_off']:.3e}"
                f" (both must miss {tol})")
            del wrong, off
        del got, want
        torch.cuda.empty_cache()

    B, S, H, K, hd = BWD_SHAPE
    q, k, v = _qkv(torch, rng, BWD_SHAPE, bf16, dev)
    do = torch.as_tensor(rng.standard_normal((B, S, H, hd)).astype(
        np.float32), device=dev)
    with torch.no_grad():
        o, lse = AK.flash_attention(q, k, v, return_lse=True)
    kern = lambda: AK.flash_attention_bwd(q, k, v, o, do, lse)  # noqa: E731
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    gt = do.transpose(1, 2).to(bf16).contiguous()
    sdpa = lambda: torch.autograd.grad(  # noqa: E731
        out, (qt, kt, vt), gt, retain_graph=True)
    turns = [event_ms(torch, fn, reps=20) for fn in (kern, sdpa, sdpa, kern)]
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    with torch.no_grad():
        plain_ms = event_ms(torch, lambda: AR.attention_bwd_ref(
            q, k, v, o, do), reps=3, warm=1)
        fwd_ms = event_ms(torch, lambda: AK.flash_attention(q, k, v),
                          reps=20)
        fwd_lse_ms = event_ms(torch, lambda: AK.flash_attention(
            q, k, v, return_lse=True), reps=20)
    split = bwd_kernel_split(torch, kern)
    del out
    torch.cuda.empty_cache()
    bound_ms, bound_by, nbytes, flops = flash_bwd_bound(BWD_SHAPE)
    tile_flops = flash_bwd_tile_flops(BWD_SHAPE)
    log(f"flash_attention_bwd timing {BWD_SHAPE} bf16 causal, in turns "
        f"kernel/SDPA/SDPA/kernel: " + " / ".join(f"{t:.4f}" for t in turns)
        + " ms")
    log(f"flash_attention_bwd {BWD_SHAPE}: {ms:.4f} ms (bound {bound_ms:.4f}"
        f" ms by {bound_by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP:"
        f" {flops / ms / 1e9:.1f} TFLOP/s; its own seven products over "
        f"whole tiles {tile_flops / 1e9:.1f} GFLOP: "
        f"{tile_flops / ms / 1e9:.1f} TFLOP/s), SDPA's backward "
        f"{lib_ms:.4f} ms "
        f"(kernel/SDPA {ms / lib_ms:.2f}), plain {plain_ms:.4f} ms; the "
        f"forward at this shape {fwd_ms:.4f} ms, with its lse "
        f"{fwd_lse_ms:.4f} ms")
    log("flash_attention_bwd kernels (profiler, ms a call): " + (", ".join(
        f"{k} {v:.4f}" for k, v in split.items()) if split else
        "not measured"))
    return {"max_abs_err": path_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "turns_ms": turns, "tflops": flops / ms / 1e9,
            "tile_tflops": tile_flops / ms / 1e9, "fwd_ms": fwd_ms, "fwd_lse_ms": fwd_lse_ms,
            "controls_rel_l2": controls, "kernels_ms": split}


def bwd_kernel_split(torch, fn, calls=5):
    """Device ms a launch of each of the backward's kernels (prep, dK/dV,
    dQ) from a profiler trace of ``calls`` calls (the mean over the
    launches the trace holds); {} when the trace has no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(flash_bwd_\w+?)_(?:wgmma_)?kernel", e.key)
        if m and e.count:
            t = getattr(e, "device_time_total", None)
            t = e.cuda_time_total if t is None else t
            out[m.group(1)] = t / e.count / 1e3
    return out


def _model_grads(torch, model, params, batch, remat):
    from repro_torch.ckpt.manager import _flatten
    leaves, _ = _flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss(params, batch, remat_policy=remat)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return float(loss.detach()), grads


@contextlib.contextmanager
def plain_attention_backward(torch, AK, AR):
    """The flash op's backward replaced by ``attention_bwd_ref`` (float32,
    explicit formulas): the kernel's forward with an exact backward."""
    orig = AK.flash_attention_bwd

    def plain(q, k, v, o, do, lse, *, causal=True, scale=None, **kw):
        del lse
        return AR.attention_bwd_ref(q, k, v, o, do, causal=causal,
                                    scale=scale, **kw)
    AK.flash_attention_bwd = plain
    try:
        yield
    finally:
        AK.flash_attention_bwd = orig


@contextlib.contextmanager
def scaled_attention_backward(torch, AK, factor):
    """The backward kernel run at ``factor`` times the forward's scale: a
    wrong backward under the right forward, the control for the gate of
    the backward kernel against the plain backward."""
    orig = AK.flash_attention_bwd

    def off(q, k, v, o, do, lse, *, causal=True, scale=None, **kw):
        scale = factor * (scale or q.shape[-1] ** -0.5)
        return orig(q, k, v, o, do, lse, causal=causal, scale=scale, **kw)
    off.launches = 0          # the wrapper counts on the module's name
    AK.flash_attention_bwd = off
    try:
        yield
    finally:
        AK.flash_attention_bwd = orig


def _rels(names, got, want):
    return {n: _rel_l2(a, b) for n, a, b in zip(names, got, want)}


def phase_train_grads(torch, AK, AR, AO, cfgs, models, rng, seed, dev):
    """(i.2) internlm2-1.8b at published widths, random float32 master
    weights from ``--seed``, B 2 x S 1024, each layer rematerialised
    ("full", so the plain attention fits): the loss and every parameter's
    gradient through the kernels against the plain attention (autograd
    through ``attention_ref``).

    In bf16 compute a 24-layer model amplifies any change of the
    attention's output, down to one float32 ulp, to ~2.5e-2 in the
    gradients (two seeded 1-ulp controls of the plain path measure that
    floor), so the kernels' own error shows only where that floor is
    taken away: (a) the loss, rel 1e-3; (b) the backward kernel against
    the plain backward under the kernel's own forward (the gradients
    differ by the backward's bf16 products alone), every leaf rel L2
    2e-2; (c) the whole path against plain in float32 compute (the
    kernels' f32 instances), every leaf rel L2 1e-4; (d) the whole path
    against plain in bf16 within 1.5x the controls' worst leaf.  The
    backward kernel at 1.02 times the scale must miss (b).  The kernel's
    forward with the plain backward, against plain, is reported: it
    shows how much of (d) the backward kernel adds."""
    cfg = cfgs.get_config(ARCH)
    params = models.build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed), torch.float32,
        device=dev)
    toks = rng.integers(0, cfg.vocab_size, (GRAD_B, GRAD_S + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
             "targets": torch.as_tensor(toks[:, 1:], device=dev)}
    _, stats = grad_gates(torch, AK, AR, AO, models, cfg, params, batch,
                          cfg.n_layers, seed, dev,
                          f"B {GRAD_B} x S {GRAD_S}")
    return stats


def grad_gates(torch, AK, AR, AO, models, cfg, params, batch, n_attn, seed,
               dev, what):
    """The gradient gates (a)-(d) of ``phase_train_grads`` on ``cfg``'s
    model with float32 master weights ``params`` and ``batch``, each
    layer rematerialised ("full"); ``n_attn`` attention layers, so a
    gradient launches the forward kernel twice and the backward once for
    each.  Returns (the backward's launches in the kernel run, the
    stats)."""
    from repro_torch.ckpt.manager import _flatten
    names = _flatten(params)[1]

    def grads(dtype, impl):
        model = models.build_model(cfg, dtype, kernel_impl=impl)
        return _model_grads(torch, model, params, batch, "full")

    AK.reset_launch_counts()
    (lk, gk), ms_k = _sync_ms(torch, lambda: grads(torch.bfloat16,
                                                    "kernel"))
    launches = AK.launch_counts()
    (lp, gp), ms_p = _sync_ms(torch, lambda: grads(torch.bfloat16, "plain"))
    end_to_end = _rels(names, gk, gp)
    controls = []
    for s in (seed, seed + 1):
        with perturbed_plain_attention(torch, AO, 2.0 ** -23, s, dev):
            lc, gc = grads(torch.bfloat16, "plain")
        controls.append(_rels(names, gc, gp))
        del gc
    with plain_attention_backward(torch, AK, AR):
        _, gkp = grads(torch.bfloat16, "kernel")
    backward = _rels(names, gk, gkp)
    plain_bwd = _rels(names, gkp, gp)
    del gk, gp
    with scaled_attention_backward(torch, AK, 1.02):
        _, gks = grads(torch.bfloat16, "kernel")
    backward_control = _rels(names, gks, gkp)
    del gks, gkp
    torch.cuda.empty_cache()
    (l32, g32) = grads(torch.float32, "kernel")
    (lp32, gp32) = grads(torch.float32, "plain")
    f32 = _rels(names, g32, gp32)
    del g32, gp32, params
    torch.cuda.empty_cache()

    def worst(rels):
        n = max(rels, key=rels.get)
        return n, rels[n]
    floor = max(worst(c)[1] for c in controls)
    check(launches["flash_attention"] == 2 * n_attn
          and launches["flash_attention_bwd"] == n_attn,
          f"grads with full remat launched {launches}, expected "
          f"{2 * n_attn} forwards and {n_attn} backwards")
    check(np.isfinite(lk) and abs(lk - lp) <= 1e-3 * abs(lp),
          f"loss through the kernels {lk} vs plain {lp}")
    check(worst(backward)[1] <= 2e-2, f"backward kernel vs plain backward "
          f"under the same forward: {worst(backward)} over 2e-2")
    check(worst(backward_control)[1] > 2e-2, f"control: the backward kernel "
          f"at 1.02 x scale {worst(backward_control)} within 2e-2, so gate "
          f"(b) could not fail")
    check(worst(f32)[1] <= 1e-4, f"f32 grads, kernels vs plain: "
          f"{worst(f32)} over 1e-4")
    check(worst(end_to_end)[1] <= 1.5 * floor,
          f"bf16 grads, kernels vs plain: {worst(end_to_end)} over 1.5x "
          f"the 1-ulp controls' {floor}")
    log(f"model grads {cfg.name} {what}, remat full: loss "
        f"kernel {lk:.6f} plain {lp:.6f} (rel {abs(lk - lp) / abs(lp):.3e},"
        f" gate 1e-3), f32 {l32:.6f} / {lp32:.6f}; worst leaf rel L2: "
        f"backward kernel vs plain backward (same forward, bf16) "
        f"{worst(backward)[0]} {worst(backward)[1]:.3e} (gate 2e-2; the "
        f"kernel at 1.02 x scale {worst(backward_control)[0]} "
        f"{worst(backward_control)[1]:.3e} must miss it); f32 "
        f"kernels vs plain {worst(f32)[0]} {worst(f32)[1]:.3e} (gate 1e-4);"
        f" bf16 kernels vs plain {worst(end_to_end)[0]} "
        f"{worst(end_to_end)[1]:.3e} against the 1-ulp controls' "
        f"{', '.join(f'{worst(c)[1]:.3e}' for c in controls)} (gate 1.5x)"
        f" and the kernel's forward with the plain backward's "
        f"{worst(plain_bwd)[1]:.3e};"
        f" {ms_k:.0f} ms with the kernels, {ms_p:.0f} ms plain (host "
        f"clock); launches {launches}")
    return launches["flash_attention_bwd"], {
            "loss_kernel": lk, "loss_plain": lp, "loss_1ulp_control": lc,
            "loss_f32_kernel": l32, "loss_f32_plain": lp32,
            "grad_rel_l2_bf16": end_to_end,
            "grad_rel_l2_bf16_1ulp_controls": controls,
            "grad_rel_l2_bwd_kernel_vs_plain_bwd": backward,
            "grad_rel_l2_bwd_kernel_scale_2pct_off_vs_plain_bwd":
                backward_control,
            "grad_rel_l2_kernel_fwd_plain_bwd_vs_plain": plain_bwd,
            "grad_rel_l2_f32": f32, "ms_kernel": ms_k, "ms_plain": ms_p}


_TRAIN_CATEGORIES = (("flash_bwd", ("flash_bwd",)),
                     ("flash_fwd", ("flash_fwd",)),
                     ("gemm", ("gemm", "gemv", "xmma", "nvjet", "cutlass")),
                     ("copy", ("memcpy", "memset", "copy")),
                     ("elementwise", ("elementwise", "vectorized",
                                      "unrolled", "reduce", "softmax",
                                      "index", "scatter", "gather", "cat")))
OPT_SPAN = "repro.opt_update"       # profiler range around opt_update


@contextlib.contextmanager
def opt_spans(torch, TS):
    """Wrap the train step's optimizer update in a profiler range, so a
    trace can attribute its kernels."""
    orig = TS.opt_update

    def spanned(*a, **k):
        with torch.profiler.record_function(OPT_SPAN):
            return orig(*a, **k)

    TS.opt_update = spanned
    try:
        yield
    finally:
        TS.opt_update = orig


def _repeat_first(pipe):
    """The pipeline's first batch, yielded once for every batch the
    pipeline delivers: the consumer drains the monitored links at the
    step rate while the trainer sees one repeated batch."""
    first = None
    for batch in pipe:
        if first is None:
            first = batch
        yield first


def phase_trainer(torch, AK, K, cfgs, models, TS, D, dev, seed):
    """(i.3) ``Trainer.fit`` at internlm2-1.8b's published widths: AdamW,
    ``TrainConfig``'s default remat ("dots"), seq 4096 (train_4k's
    length), a global batch of 4 as 2 microbatches of 2 rows, fed by
    ``DataPipeline(SyntheticLMSource)`` with its links on the card, 8
    steps on one repeated batch, ``log_every=2``.  The links' monitor
    must launch ``monitor_fleet`` during the fit.  Then one more step
    under torch.profiler."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.roofline import analysis as RN
    from repro_torch.roofline import analytic as RA
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = cfgs.get_config(ARCH)
    model = models.build_model(cfg, torch.bfloat16)
    n_params = sum(int(np.prod(s)) for s in _leaves(model.param_shapes()))
    n_embed = cfg.padded_vocab * cfg.d_model
    state_gb = 16 * n_params / 1e9          # f32 params, grads, m and v
    log(f"trainer memory reckoned before the run: {n_params / 1e9:.4f} B "
        f"parameters x 16 B (f32 params, grads, m, v) = {state_gb:.2f} GB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainerConfig(
        train=TrainConfig(opt=OptConfig(lr_peak=1e-3, lr_min=1e-4,
                                        warmup_steps=2, total_steps=100),
                          microbatches=TRAIN_MICRO),
        log_every=2)
    t0 = time.perf_counter()
    trainer = Trainer(model, tcfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    step_ms, seen = [], {}
    orig_step = trainer.step_fn

    def timed(state, batch):
        t = time.perf_counter()
        out = orig_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        seen["batch"] = batch
        return out
    trainer.step_fn = timed
    gb = TRAIN_MICRO * TRAIN_ROWS
    pipe = D.DataPipeline(D.SyntheticLMSource(cfg.vocab_size,
                                              doc_len=TRAIN_SEQ, seed=seed),
                          seq_len=TRAIN_SEQ, batch_size=gb,
                          queue_capacity=4, max_batches=TRAIN_STEPS + 1,
                          device=dev).start()
    AK.reset_launch_counts()
    K.reset_launch_counts()
    try:
        hist = trainer.fit(_repeat_first(pipe), steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        launches = AK.launch_counts()
        monitor_launches = K.launch_counts()["monitor_fleet"]
        rates = pipe.rates()
        heads = pipe.fleet.state_snapshot()
    finally:
        pipe.stop()
    heads = {queue.name: {
        "epoch": int(heads.epoch[i]),
        "last_qbar_per_s": float(heads.last_qbar[i]) / pipe.fleet.period_s,
        "running_mean_per_s": float(heads.mean[i]) / pipe.fleet.period_s}
        for i, queue in enumerate(pipe.fleet.queues)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    per_step = TRAIN_MICRO * cfg.n_layers    # one a layer a microbatch
    check(len(hist) == TRAIN_STEPS // tcfg.log_every,
          f"trainer.history holds {len(hist)} records")
    check(all(np.isfinite([h["loss"], h["grad_norm"]]).all()
              for h in hist), f"non-finite loss or grad norm: {hist}")
    check(losses[-1] <= 0.9 * losses[0],
          f"loss on the repeated batch fell from {losses[0]} to "
          f"{losses[-1]}, less than 10%")
    check("host0" in trainer.ft.rates.monitors,
          "ft.rates received no step stream")
    check(monitor_launches > 0, "the pipeline's links launched no "
          "monitor_fleet during the fit")
    check(launches["flash_attention"] >= per_step * TRAIN_STEPS
          and launches["flash_attention_bwd"] == per_step * TRAIN_STEPS,
          f"launches {launches} in {TRAIN_STEPS} steps, expected "
          f"{per_step} of each kernel a step (more forwards under remat)")
    med = float(np.median(step_ms[1:]))
    tokens = gb * TRAIN_SEQ
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn_flops = (3 * 4.0 * gb * cfg.n_heads * cfg.head_dim * pairs
                  * cfg.n_layers)
    model_flops = RN.model_flops(n_params - n_embed, tokens,
                                 "train") + attn_flops
    mfu = model_flops / (med / 1e3) / RN.HW["peak_flops_bf16"]
    roof = roofline_line(RA, RN, cfg, ShapeConfig("train_step", TRAIN_SEQ,
                                                  gb, "train"), med / 1e3,
                         remat_policy="dots")

    # one more step under the profiler, the optimizer's kernels in a range
    from torch.profiler import ProfilerActivity, profile
    with opt_spans(torch, TS), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, ms = _sync_ms(torch, lambda: orig_step(trainer.state,
                                                   seen["batch"]))
    trace = _trace_split(torch, prof, ms, 1, _TRAIN_CATEGORIES,
                         (OPT_SPAN, "optimizer"))
    del trainer
    torch.cuda.empty_cache()
    log(f"trainer {cfg.name}: {TRAIN_STEPS} steps of {gb} x {TRAIN_SEQ} "
        f"({TRAIN_MICRO} microbatches), remat dots, AdamW: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; grad norms " + ", ".join(f"{h['grad_norm']:.3f}" for h in hist)
        + f"; init {t_init:.1f} s")
    log(f"trainer step ms " + ", ".join(f"{t:.1f}" for t in step_ms)
        + f"; median of steps 2-{TRAIN_STEPS} {med:.1f} ms, "
        f"{tokens / med * 1e3:.0f} tokens/s, MFU {mfu:.4f} (6 N tokens with "
        f"N {(n_params - n_embed) / 1e9:.4f} B (the embedding table's "
        f"gather excluded) + attention {attn_flops / 1e12:.2f} TFLOP, over "
        f"{RN.HW['peak_flops_bf16'] / 1e12:g} TFLOP/s); peak memory "
        f"{peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated; reckoned state {state_gb:.2f} "
        f"GB); launches {launches}, monitor_fleet {monitor_launches}; "
        f"pipeline rates {rates}; link heads (consumer side, items/s) "
        f"{heads}")
    log(f"trainer step roofline (analytic, remat dots, H100 peaks): "
        f"compute {roof['compute_s'] * 1e3:.1f} ms, memory "
        f"{roof['memory_s'] * 1e3:.1f} ms, {roof['dominant']} bound, "
        f"measured {med:.1f} ms = {roof['bound_share']:.3f} of the bound")
    if trace is None:
        log("trainer profile: no device events in the trace (not measured)")
    else:
        log("trainer profile (one step): " + ", ".join(
            f"{n} {x:.3f}" for n, x in trace.items()))
    return launches["flash_attention_bwd"], {
        "arch": ARCH, "seq": TRAIN_SEQ, "global_batch": gb,
        "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS,
        "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
        "step_ms": step_ms, "step_ms_median": med,
        "tokens_per_s": tokens / med * 1e3, "mfu": mfu,
        "model_tflop_per_step": model_flops / 1e12,
        "peak_memory_gb": peak_gb, "reckoned_state_gb": state_gb,
        "n_params": n_params, "launches": launches,
        "monitor_fleet_launches": monitor_launches, "pipeline_rates": rates,
        "pipeline_heads": heads, "trace": trace, "init_s": t_init,
        "roofline": roof}


def phase_ckpt_resume(torch, cfgs, models, rng, dev, seed):
    """(i.4) Checkpoint and resume at a 2-layer cut of internlm2 at its
    published widths with AdamW8bit, in a temporary directory deleted
    afterwards: saved at step 2, a fresh ``Trainer``'s ``maybe_restore``
    returns 2 and its step-3 loss equals the uninterrupted run's to rel
    1e-6; a corrupted leaf raises.  Bytes on disk and a blocking save's
    seconds."""
    import dataclasses
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(cfgs.get_config(ARCH), n_layers=2,
                              name=f"{ARCH}-2layer")
    model = models.build_model(cfg, torch.bfloat16)
    toks = rng.integers(0, cfg.vocab_size, (3, CKPT_B, CKPT_S + 1))
    batches = [{"tokens": t[:, :-1], "targets": t[:, 1:]} for t in toks]
    train = TrainConfig(opt=OptConfig(name="adamw8bit", lr_peak=1e-3,
                                      warmup_steps=2, total_steps=100))
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        tmp = Path(tmp)
        whole = Trainer(model, TrainerConfig(train=train, log_every=1),
                        seed=seed, device=dev)
        want = whole.fit(iter(batches), steps=3)[2]["loss"]
        del whole
        tcfg = TrainerConfig(train=train, ckpt_dir=str(tmp / "run"),
                             ckpt_every=2, log_every=1)
        first = Trainer(model, tcfg, seed=seed, device=dev)
        first.fit(iter(batches[:2]), steps=2)
        del first
        fresh = Trainer(model, tcfg, seed=seed + 1, device=dev)
        restored = fresh.maybe_restore()
        check(restored == 2, f"maybe_restore returned {restored}, not 2")
        got = fresh.fit(iter(batches[2:]), steps=1)[0]["loss"]
        check(abs(got - want) <= 1e-6 * abs(want),
              f"resumed step-3 loss {got} vs uninterrupted {want}")
        t0 = time.perf_counter()
        CheckpointManager(str(tmp / "timed")).save(3, fresh.state,
                                                   blocking=True)
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in (tmp / "timed" / "step_3")
                   .iterdir())
        latest = fresh.ckpt.latest_step()
        leaf = tmp / "run" / f"step_{latest}" / "leaf_0.npy"
        arr = np.load(leaf)
        arr.flat[0] += 1
        np.save(leaf, arr)
        try:
            fresh.maybe_restore()
        except IOError as e:
            corrupt = str(e)
        else:
            corrupt = None
        check(corrupt is not None and "corrupt" in corrupt,
              "a corrupted leaf restored without an error")
        del fresh
    torch.cuda.empty_cache()
    equal = got == want
    how = ("bit for bit" if equal else
           f"not bit for bit, rel {abs(got - want) / abs(want):.3e}")
    log(f"checkpoint resume {cfg.name} (adamw8bit, {CKPT_B} x {CKPT_S}): "
        f"maybe_restore -> {restored}; step-3 loss resumed {got!r} vs "
        f"uninterrupted {want!r} ({how}); a blocking save {save_s:.3f} s, "
        f"{disk / 1e9:.3f} GB on disk; corrupted leaf: {corrupt}")
    return {"restored_step": restored, "loss_resumed": got,
            "loss_uninterrupted": want, "bit_equal": equal,
            "save_s": save_s, "disk_bytes": disk}


# ---------------------------------------------------------------------------
# (j) the encoder-decoder and MoE families: whisper-large-v3, phi3.5-moe


@contextlib.contextmanager
def scaled_flash_forward(torch, AK, factor, **change):
    """The forward kernel run at ``factor`` times the model's scale, with
    ``change`` (``softcap=None``, ``window=0``) over the arguments it is
    given: a wrong attention, the control that the kernel-vs-plain gates
    of the model phases must fail."""
    orig = AK.flash_attention

    def off(q, k, v, *, causal=True, scale=None, return_lse=False, **kw):
        scale = factor * (scale or q.shape[-1] ** -0.5)
        return orig(q, k, v, causal=causal, scale=scale,
                    return_lse=return_lse, **{**kw, **change})
    off.launches = 0          # the wrapper counts on the module's name
    AK.flash_attention = off
    try:
        yield
    finally:
        AK.flash_attention = orig


def phase_whisper(torch, AK, AO, WH, cfgs, models, rng, seed, dev):
    """(j.1) whisper-large-v3 at published widths (32 + 32 layers, d 1280,
    20 heads x 64, d_ff 5120, vocab 51 968 padded), random bf16 weights
    and stub frames (8, 1536, 1280) from ``--seed``, served through
    ``Model.prefill`` and ``Model.decode_step`` (the reference serves
    Whisper through ``Model`` only: its ``Engine`` takes no frames).

    A prompt of 4 tokens at batch 8: the encoder (32 flash launches) and
    the prefill (96: 32 encoder, 32 decoder self, 32 cross with S 4 != T
    1536), through the kernel and through the plain attention.  Gates:
    in float32 compute on the same weights (the kernels' f32 instances)
    the encoder states and the last logits within rel L2 1e-4 of plain
    (1e-2 would pass an attention error the model can see), and the
    kernel at 1.02 x its scale must miss; in bf16 within 1.5x a 1-ulp
    control of the plain path (the bf16 floor of a 64-layer stack, as in
    phase (i)).  Decode agrees with prefill in float32 at full depth
    (prefill 3 tokens, decode the 4th over the caches: the 4-token
    prefill's token, logits within 1e-4).  Then 64 greedy tokens at
    batch 8 in bf16, self cache 448 (Whisper's decoder context)."""
    cfg = cfgs.get_config(WHISPER_ARCH)
    bf16, f32 = torch.bfloat16, torch.float32
    model = models.build_model(cfg, bf16)
    plain = models.build_model(cfg, bf16, kernel_impl="plain")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               bf16, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    B, P = SERVE_B, WHISPER_PROMPT
    frames = torch.as_tensor(rng.standard_normal(
        (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32), device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                           device=dev)
    batch = {"frames": frames, "tokens": toks}

    def encode(m, p):
        return WH.whisper_encode(p, cfg, frames, m.compute_dtype,
                                 kernel_impl=m.kernel_impl)

    def runs(m, p, pl):
        """(encoder, last logits) through the kernel, the plain
        attention, the plain attention 1 ulp off, the kernel at 1.02 x
        scale."""
        out = {"kernel": (encode(m, p), m.prefill(p, batch)[0]),
               "plain": (encode(pl, p), pl.prefill(p, batch)[0])}
        with perturbed_plain_attention(torch, AO, 2.0 ** -23, seed, dev):
            out["ulp"] = (encode(pl, p), pl.prefill(p, batch)[0])
        with scaled_flash_forward(torch, AK, 1.02):
            out["scaled"] = (encode(m, p), m.prefill(p, batch)[0])
        return {k: {"enc": _rel_l2(v[0], out["plain"][0]),
                    "logits": _rel_l2(v[1], out["plain"][1])}
                for k, v in out.items() if k != "plain"}, out["kernel"]

    with torch.inference_mode():
        encode(model, params)                              # warm-up
        model.prefill(params, batch)
        AK.reset_launch_counts()
        enc, enc_ms = _sync_ms(torch, lambda: encode(model, params))
        enc_launches = AK.launch_counts()["flash_attention"]
        AK.reset_launch_counts()
        (lk, cache), pre_ms = _sync_ms(torch, lambda: model.prefill(params,
                                                                    batch))
        launches = AK.launch_counts()["flash_attention"]
        rel16, _ = runs(model, params, plain)
        p32 = _map(params, lambda t: t.float())
        m32 = models.build_model(cfg, f32)
        rel32, (_, l32) = runs(m32, p32, models.build_model(
            cfg, f32, kernel_impl="plain"))
        # decode agrees with prefill: P - 1 tokens, then the P-th
        _, c = m32.prefill(p32, {"frames": frames, "tokens": toks[:, :-1]})
        c = {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1))
             if n in ("k", "v") else t for n, t in c.items()}
        ld, _ = WH.whisper_forward(
            p32, cfg, tokens=toks[:, -1:], cache=c,
            pos_offset=torch.full((B,), P - 1, device=dev), mode="decode",
            compute_dtype=f32, logits_mode="last")
        dec_rel = _rel_l2(ld, l32)
        dec_same = bool(torch.equal(ld[:, -1].argmax(-1),
                                    l32[:, -1].argmax(-1)))
        del p32, c
        torch.cuda.empty_cache()
        # greedy decode in bf16 over the self cache and the static cross
        cache_d = model.init_cache(B, WHISPER_MAX_SEQ, device=dev)
        for n in ("k", "v"):
            cache_d[n][:, :, :P] = cache[n]
        for n in ("ck", "cv"):
            cache_d[n].copy_(cache[n])
        del cache
        cur = torch.argmax(lk[:, -1], -1).to(torch.int32)
        pos = torch.full((B,), P, device=dev)
        model.decode_step(params, cache_d, cur, pos)       # warm-up, same
        outs = [cur]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WHISPER_NEW - 1):
            cur, cache_d = model.decode_step(params, cache_d, cur, pos)
            pos = pos + 1
            outs.append(cur)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / (WHISPER_NEW - 1)
        gen = torch.stack(outs, 1).cpu().numpy()
        c_bytes = sum(t.numel() * t.element_size() for t in cache_d.values())
    del model, plain, params, cache_d
    torch.cuda.empty_cache()
    n_attn = cfg.encoder_layers + 2 * cfg.n_layers
    floor = {k: 1.5 * v for k, v in rel16["ulp"].items()}
    check(enc_launches == cfg.encoder_layers and launches == n_attn,
          f"flash_attention launched {enc_launches} times in the encoder "
          f"and {launches} in a prefill, expected {cfg.encoder_layers} and "
          f"{n_attn}")
    check(bool(torch.isfinite(lk).all() and torch.isfinite(enc).all()),
          "non-finite whisper encoder states or prefill logits")
    for k in ("enc", "logits"):
        check(rel32["kernel"][k] <= 1e-4, f"whisper f32 {k}: kernel vs "
              f"plain rel L2 {rel32['kernel'][k]} over 1e-4")
        check(rel32["scaled"][k] > 1e-4, f"control: whisper f32 {k} with "
              f"the kernel at 1.02 x scale {rel32['scaled'][k]} within "
              f"1e-4, so the gate could not fail")
        check(rel16["kernel"][k] <= max(1e-2, floor[k]),
              f"whisper bf16 {k}: kernel vs plain rel L2 "
              f"{rel16['kernel'][k]} over 1e-2 and 1.5x the 1-ulp "
              f"control's {rel16['ulp'][k]}")
    check(dec_same and dec_rel <= 1e-4, f"whisper f32 decode vs prefill: "
          f"same token {dec_same}, logits rel L2 {dec_rel}")
    check(gen.shape == (B, WHISPER_NEW)
          and bool(((gen >= 0) & (gen < cfg.padded_vocab)).all()),
          f"whisper greedy tokens {gen.shape}")
    tok_s = B * 1e3 / dec_ms
    log(f"model {cfg.name}: {cfg.encoder_layers} + {cfg.n_layers} layers, "
        f"d {cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.padded_vocab}; weights "
        f"{w_bytes / 1e9:.3f} GB bf16 (init {t_init:.1f} s)")
    log(f"whisper: encoder {B} x {cfg.encoder_seq} {enc_ms:.1f} ms "
        f"({enc_launches} flash launches), prefill with a {P}-token prompt "
        f"{pre_ms:.1f} ms ({launches} flash launches), decode "
        f"{dec_ms:.2f} ms a token at batch {B} ({tok_s:.1f} tokens/s, "
        f"{WHISPER_NEW} tokens, caches {c_bytes / 1e6:.1f} MB) (host "
        f"clock, synchronized)")
    log(f"whisper kernel vs plain attention, rel L2 (encoder / last "
        f"logits): f32 {rel32['kernel']['enc']:.3e} / "
        f"{rel32['kernel']['logits']:.3e} (gate 1e-4; the kernel at 1.02 x "
        f"scale {rel32['scaled']['enc']:.3e} / "
        f"{rel32['scaled']['logits']:.3e} must miss it); bf16 "
        f"{rel16['kernel']['enc']:.3e} / {rel16['kernel']['logits']:.3e} "
        f"against the 1-ulp control's {rel16['ulp']['enc']:.3e} / "
        f"{rel16['ulp']['logits']:.3e} (gate max(1e-2, 1.5x)); decode vs "
        f"prefill f32 logits {dec_rel:.3e}, same token {dec_same}")
    return launches, {"weight_bytes": w_bytes, "encoder_ms": enc_ms,
                      "prefill_ms": pre_ms, "prompt_len": P,
                      "decode_ms_per_token": dec_ms,
                      "decode_tokens_per_s": tok_s, "new_tokens": WHISPER_NEW,
                      "cache_bytes": c_bytes, "rel_l2_f32": rel32,
                      "rel_l2_bf16": rel16, "decode_vs_prefill_rel_l2":
                      dec_rel, "encoder_launches": enc_launches}


def flash_cases(torch, AK, AR, cases, dev, what):
    """The bf16 kernel against its plain version at each (shape
    (B,S,H,K,hd), T or None for S, causal, generator): 1e-3, as phase 6.
    Returns the largest abs error."""
    err = 0.0
    for shape, T, causal, gen in cases:
        q, k, v = _qkv(torch, gen, shape, torch.bfloat16, dev, T)
        got = AK.flash_attention(q, k, v, causal=causal)
        want = AR.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        name = (f"flash_attention {what} {shape} T={T or shape[1]} bf16 "
                f"causal={causal}")
        check(bool(torch.isfinite(got).all()
                   and ((got - want).abs() <= 1e-3 + 1e-3 * want.abs()).all()),
              f"{name}: max abs err {e} over tol 1e-3")
        log(f"{name}: max abs err {e:.3e} (tol 1e-3)")
        err = max(err, e)
    return err


def kernel_flash_whisper(torch, AK, AR, rng, dev, seed):
    """The flash forward at Whisper's shapes, bf16, against the plain
    version (1e-3, as phase 6): the encoder's (8, 1536, 20, 20, 64)
    non-causal, the prefill's cross-attention (S 4, T 1536), the
    decoder's causal self-attention (G 1) at the prefill's S 4 and the
    gradient's (2, 448); then the encoder's timed in turns with SDPA
    (kernel, SDPA, SDPA, kernel)."""
    import torch.nn.functional as F
    B, S, H, K, hd = WHISPER_FLASH_SHAPE
    own = np.random.default_rng((seed, 10))
    err = flash_cases(torch, AK, AR, [
        (WHISPER_FLASH_SHAPE, None, False, rng),
        ((B, WHISPER_PROMPT, H, K, hd), S, False, rng),
        ((B, WHISPER_PROMPT, H, K, hd), None, True, own),
        ((WHISPER_GRAD_B, WHISPER_GRAD_S, H, K, hd), None, True, own)],
        dev, "whisper")
    q, k, v = _qkv(torch, rng, WHISPER_FLASH_SHAPE, torch.bfloat16, dev)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kern = lambda: AK.flash_attention(q, k, v, causal=False)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=False)
    turns = [event_ms(torch, fn, reps=50) for fn in (kern, sdpa, sdpa, kern)]
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    plain_ms = event_ms(torch, lambda: AR.attention_ref(q, k, v,
                                                        causal=False), reps=5)
    bound_ms, bound_by, nbytes, flops = flash_bound(WHISPER_FLASH_SHAPE,
                                                    causal=False)
    log(f"flash_attention {WHISPER_FLASH_SHAPE} bf16 non-causal, in turns "
        f"kernel/SDPA/SDPA/kernel: " + " / ".join(f"{t:.4f}" for t in turns)
        + f" ms; {ms:.4f} ms (bound {bound_ms:.4f} ms by {bound_by}, "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP: "
        f"{flops / ms / 1e9:.1f} TFLOP/s), SDPA {lib_ms:.4f} ms "
        f"(kernel/SDPA {ms / lib_ms:.2f}), plain {plain_ms:.4f} ms; max abs "
        f"err {err:.3e} (tol 1e-3)")
    return {"shape": WHISPER_FLASH_SHAPE, "ms": ms, "library_ms": lib_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "turns_ms": turns, "max_abs_err": err,
            "tflops": flops / ms / 1e9}


def kernel_flash_moe(torch, AK, AR, dev, seed):
    """The flash forward at phi3.5-moe's shapes, bf16, causal, GQA 4 at
    hd 128, against the plain version (1e-3, as phase 6): the 8 x 1024
    prefill and a ragged Engine round of 8 x 1479 (the serve phase's
    rounds pad to their longest prompt of 512-1536 tokens)."""
    own = np.random.default_rng((seed, 11))
    return flash_cases(torch, AK, AR, [
        ((SERVE_B, PREFILL_S, 32, 8, 128), None, True, own),
        ((SERVE_B, MOE_ROUND_S, 32, 8, 128), None, True, own)], dev, "moe")


def phase_whisper_grads(torch, AK, AR, AO, cfgs, models, rng, seed, dev):
    """(j.2) one gradient of ``whisper_loss`` at published widths: random
    float32 master weights from ``--seed``, frames (2, 1536, 1280) and
    B 2 x 448 target tokens, remat "full", under phase (i.2)'s gates
    (``grad_gates``): the flash backward at hd 64, non-causal, S 448 !=
    T 1536 in cross-attention, 96 launches a gradient."""
    cfg = cfgs.get_config(WHISPER_ARCH)
    params = models.build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed + 1), torch.float32,
        device=dev)
    toks = rng.integers(0, cfg.vocab_size,
                        (WHISPER_GRAD_B, WHISPER_GRAD_S + 1))
    batch = {"frames": torch.as_tensor(rng.standard_normal(
                 (WHISPER_GRAD_B, cfg.encoder_seq, cfg.d_model),
                 dtype=np.float32), device=dev),
             "tokens": torch.as_tensor(toks[:, :-1], device=dev),
             "targets": torch.as_tensor(toks[:, 1:], device=dev)}
    out = grad_gates(torch, AK, AR, AO, models, cfg, params, batch,
                     cfg.encoder_layers + 2 * cfg.n_layers, seed, dev,
                     f"frames {WHISPER_GRAD_B} x {cfg.encoder_seq}, targets "
                     f"{WHISPER_GRAD_B} x {WHISPER_GRAD_S}")
    del params
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def moe_routes(torch, TF):
    """Record each MoE layer's chosen experts (sorted per token) from the
    router probabilities ``moe_block`` returns."""
    orig, routes = TF.moe_block, []

    def rec(x, p, cfg, compute_dtype=torch.bfloat16):
        y, probs = orig(x, p, cfg, compute_dtype=compute_dtype)
        routes.append(torch.topk(probs, cfg.n_experts_active,
                                 dim=-1).indices.sort(-1).values)
        return y, probs
    TF.moe_block = rec
    try:
        yield routes
    finally:
        TF.moe_block = orig


def flipped_share(a, b):
    """Share of (layer, token) whose expert set differs between two
    ``moe_routes`` records."""
    return sum(float((x != y).any(-1).float().mean())
               for x, y in zip(a, b)) / max(len(a), 1)


_MOE_CATEGORIES = (("flash_attention", ("flash_fwd",)),
                   ("gemm", ("gemm", "gemv", "xmma", "nvjet", "cutlass")),
                   ("sort", ("sort", "topk")),
                   ("gather_scatter", ("gather", "scatter", "index")),
                   ("copy", ("memcpy", "memset", "copy")),
                   ("reduce", ("reduce",)))


def phase_moe(torch, AK, AO, MK, serve, TF, cfgs, models, rng, seed, dev):
    """(j.3) phi3.5-moe at published widths (d 4096, 32/8 heads x 128, 16
    experts top-2 of d_ff 6400, vocab 32 064), cut to 8 of its 32
    layers: 10.7 B parameters, 21.3 GB of random bf16 weights from
    ``--seed``.

    A prefill of 8 x 1024 through the kernel and through the plain
    attention in bf16: the rel L2 of the last logits and the share of
    (layer, token) routes that flip between the two are reported, not
    gated (a ~1e-3 change of a hidden state that flips a token's top-2
    moves its output a lot).  The gate is in float32 compute at a
    2-layer cut of the same weights: last logits within rel L2 1e-4 of
    plain, and the kernel at 1.02 x scale must miss.  Then phase 8's
    traffic through ``serve.Engine`` (8 flash launches a prefill round,
    ``monitor_fleet`` on the lanes, the engine's tokens equal to a direct
    decode) and a trace split into flash, GEMMs, the dispatch's sort and
    gather/scatter, copies and other."""
    import dataclasses
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = dataclasses.replace(cfgs.get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    model = models.build_model(cfg, bf16)
    plain = models.build_model(cfg, bf16, kernel_impl="plain")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               bf16, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_B, PREFILL_S)), device=dev)}
    with torch.inference_mode():
        model.prefill(params, batch)                      # warm-up
        AK.reset_launch_counts()
        with moe_routes(torch, TF) as rk:
            (lk, _), ms_k = _sync_ms(torch, lambda: model.prefill(params,
                                                                  batch))
        launches = AK.launch_counts()["flash_attention"]
        with moe_routes(torch, TF) as rp:
            (lp, _), ms_p = _sync_ms(torch, lambda: plain.prefill(params,
                                                                  batch))
        with perturbed_plain_attention(torch, AO, 2.0 ** -23, seed, dev):
            lc, _ = plain.prefill(params, batch)
        rel16, ctrl16 = _rel_l2(lk, lp), _rel_l2(lc, lp)
        flip16 = flipped_share(rk, rp)
        del rk, rp
        # float32 at a 2-layer cut of the same weights
        c32 = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS)
        p32 = {k: _map(v, lambda t: t[:MOE_F32_LAYERS].float())
               if k == "blocks" else
               (_map(v, lambda t: t.float()) if isinstance(v, dict)
                else v.float()) for k, v in params.items()}
        m32 = models.build_model(c32, f32)
        with moe_routes(torch, TF) as rk32:
            l32k, _ = m32.prefill(p32, batch)
        with moe_routes(torch, TF) as rp32:
            l32p, _ = models.build_model(c32, f32, kernel_impl="plain"
                                         ).prefill(p32, batch)
        with scaled_flash_forward(torch, AK, 1.02):
            l32s, _ = m32.prefill(p32, batch)
        rel32, rel32s = _rel_l2(l32k, l32p), _rel_l2(l32s, l32p)
        flip32 = flipped_share(rk32, rp32)
        del p32, rk32, rp32
    torch.cuda.empty_cache()
    check(launches == cfg.n_layers, f"flash_attention launched {launches} "
          f"times in a {cfg.n_layers}-layer MoE prefill")
    check(bool(torch.isfinite(lk).all() and torch.isfinite(l32k).all()),
          "non-finite MoE prefill logits")
    check(rel32 <= 1e-4, f"MoE f32 logits ({MOE_F32_LAYERS} layers): kernel "
          f"vs plain rel L2 {rel32} over 1e-4")
    check(rel32s > 1e-4, f"control: MoE f32 logits with the kernel at 1.02 x"
          f" scale {rel32s} within 1e-4, so the gate could not fail")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"model {cfg.name} cut to {cfg.n_layers} of 32 layers: d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
        f"{cfg.head_dim}, {cfg.n_experts} experts top-"
        f"{cfg.n_experts_active} of d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab}; {n_params / 1e9:.3f} B parameters, "
        f"{w_bytes / 1e9:.3f} GB bf16 (init {t_init:.1f} s)")
    log(f"MoE prefill {SERVE_B} x {PREFILL_S}: kernel {ms_k:.1f} ms, plain "
        f"attention {ms_p:.1f} ms (host clock, synchronized), {launches} "
        f"flash launches; last logits kernel vs plain: bf16 rel L2 "
        f"{rel16:.3e} with {flip16:.4%} of routes flipped (1-ulp control "
        f"{ctrl16:.3e}), f32 at {MOE_F32_LAYERS} layers {rel32:.3e} with "
        f"{flip32:.4%} flipped (gate 1e-4; the kernel at 1.02 x scale "
        f"{rel32s:.3e} must miss it)")
    serve_launches, stats = phase_serve(torch, AK, "flash_attention", MK,
                                        serve, model, params, rng, dev,
                                        categories=_MOE_CATEGORIES)
    del model, plain, params
    torch.cuda.empty_cache()
    return serve_launches, {
        "layers": cfg.n_layers, "parameters": n_params,
        "weight_bytes": w_bytes, "prefill_8x1024_ms": ms_k,
        "prefill_8x1024_plain_attn_ms": ms_p, "logits_rel_l2_bf16": rel16,
        "logits_rel_l2_bf16_1ulp_control": ctrl16,
        "routes_flipped_bf16": flip16, "logits_rel_l2_f32": rel32,
        "logits_rel_l2_f32_scaled_control": rel32s,
        "routes_flipped_f32": flip32, **stats}


# ---------------------------------------------------------------------------
# phase (k): the hybrid family and the capped, windowed attention


def _qkv_on_card(torch, g, shape, dtype, dev, qmul=1.0):
    """``_qkv``'s normal draws, made on the card from the generator ``g``:
    numpy takes seconds of host time for the ~5e8 values of phase
    (k.1)'s shapes."""
    B, S, H, K, hd = shape
    mk = lambda *sh: torch.randn(sh, generator=g, device=dev)  # noqa: E731
    return ((mk(B, S, H, hd) * qmul).to(dtype), mk(B, S, K, hd).to(dtype),
            mk(B, S, K, hd).to(dtype))


def _flash_gate(torch, AK, AR, q, k, v, kw, tol, off=None):
    """(max abs err, within tol) of the kernel against the plain version
    under ``kw``; ``off`` changes the kernel's arguments only (a
    control)."""
    got = AK.flash_attention(q, k, v, **{**kw, **(off or {})})
    want = AR.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    d = (got - want).abs()
    ok = bool(torch.isfinite(got).all() and (d <= tol + tol * want.abs()).all())
    return float(d.max()), ok


def kernel_flash_k(torch, AK, AR, dev, seed):
    """(k.1) The new forward instances against the plain version (bf16
    1e-3, f32 2e-4): hd 112 at zamba2's prefill (8, 1024, 32, 32, 112)
    causal and a ragged round of 8 x 1479; hd 256 at gemma2's (2, 8192,
    8, 4, 256) causal with softcap 50 (q x 8, so that the cap bends the
    scores), windowed (4096) and not.  Controls
    that must miss the gate: the kernel at 1.02 x scale, with its window
    taken off, with its softcap taken off.  Timed with CUDA events: hd
    112 in turns with SDPA (causal, the same function); hd 256 beside
    SDPA causal without cap or window (not the same function: no single
    PyTorch call caps the scores), the plain version and the f32
    instance."""
    import torch.nn.functional as F
    own = torch.Generator(device=dev).manual_seed(seed + 12)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S, H, K, hd = ZAMBA_FLASH_SHAPE
    gemma = dict(causal=True, softcap=50.0)
    win = dict(gemma, window=4096)
    # (name, shape, dtype, arguments, tol, q multiplier): q x 8 at hd 256,
    # so that the scores (sd 8) reach the softcap's bend
    cases = [("hd112", ZAMBA_FLASH_SHAPE, bf16, dict(causal=True), 1e-3, 1),
             ("hd112 ragged", (B, MOE_ROUND_S, H, K, hd), bf16,
              dict(causal=True), 1e-3, 1),
             ("hd112 f32", ZAMBA_FLASH_SHAPE, f32, dict(causal=True), 2e-4,
              1),
             ("hd256 window", GEMMA_FLASH_SHAPE, bf16, win, 1e-3, 8),
             ("hd256", GEMMA_FLASH_SHAPE, bf16, gemma, 1e-3, 8),
             ("hd256 window f32", GEMMA_FLASH_SHAPE, f32, win, 2e-4, 8)]
    errs, controls, qkv = {}, {}, {}
    for name, shape, dtype, kw, tol, qmul in cases:
        q, k, v = _qkv_on_card(torch, own, shape, dtype, dev, qmul)
        e, ok = _flash_gate(torch, AK, AR, q, k, v, kw, tol)
        what = f"flash_attention {name} {shape} {str(dtype)[6:]} {kw}"
        check(ok, f"{what}: max abs err {e} over tol {tol}")
        log(f"{what}: max abs err {e:.3e} (tol {tol})")
        errs[name] = e
        if dtype == bf16 and name in ("hd112", "hd256 window"):
            qkv[name] = (q, k, v)
            scale = shape[-1] ** -0.5
            offs = {"scale x 1.02": dict(scale=1.02 * scale)}
            if "window" in kw:
                offs.update({"window off": dict(window=0),
                             "softcap off": dict(softcap=None)})
            for cname, off in offs.items():
                ce, cok = _flash_gate(torch, AK, AR, q, k, v, kw, tol, off)
                check(not cok, f"control: {what} with {cname} within tol "
                      f"{tol} (max abs err {ce}), so the gate could not "
                      "fail")
                controls[f"{name}, {cname}"] = ce
        del q, k, v
    log("flash_attention controls (max abs err, each must miss 1e-3): "
        + ", ".join(f"{n} {e:.3e}" for n, e in controls.items()))
    out = {"max_abs_err": max(v for n, v in errs.items() if "f32" not in n),
           "max_abs_err_f32": max(v for n, v in errs.items() if "f32" in n),
           "controls_max_abs_err": controls}
    # SDPA computes the same function only without a cap
    for name, shape, kw, same in (
            ("hd112", ZAMBA_FLASH_SHAPE, dict(causal=True), True),
            ("hd256 window", GEMMA_FLASH_SHAPE, win, False),
            ("hd256", GEMMA_FLASH_SHAPE, gemma, False)):
        q, k, v = qkv.get(name) or qkv["hd256 window"]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kern = lambda: AK.flash_attention(q, k, v, **kw)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        reps = 50 if name == "hd112" else 10
        turns = [event_ms(torch, fn, reps=reps)
                 for fn in (kern, sdpa, sdpa, kern)]
        ms, sdpa_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        plain_ms = event_ms(torch, lambda: AR.attention_ref(q, k, v, **kw),
                            reps=2, warm=1)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        f32_ms = event_ms(torch, lambda: AK.flash_attention(
            q32, k32, v32, **kw), reps=3, warm=1)
        del q32, k32, v32
        bound_ms, bound_by, nbytes, flops = flash_bound(
            shape, window=kw.get("window", 0))
        log(f"flash_attention {name} {shape} bf16 {kw}, in turns kernel/"
            f"SDPA/SDPA/kernel: " + " / ".join(f"{t:.4f}" for t in turns)
            + f" ms; {ms:.4f} ms (bound {bound_ms:.4f} ms by {bound_by}, "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP: "
            f"{flops / ms / 1e9:.1f} TFLOP/s), SDPA causal {sdpa_ms:.4f} ms"
            + ("" if same else " (no cap, no window: not the same "
               "function)") + f", plain {plain_ms:.4f} ms, the f32 instance "
            f"{f32_ms:.4f} ms")
        out[name] = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": sdpa_ms if same else None,
                     "sdpa_uncapped_ms": None if same else sdpa_ms,
                     "turns_ms": turns, "f32_ms": f32_ms,
                     "tflops": flops / ms / 1e9}
    del qkv
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def counted_flash(torch, AK):
    """Count the forward's calls with a window on top of its launches
    (the wrapper counts on the module's name, as in
    ``scaled_flash_forward``)."""
    orig = AK.flash_attention

    def counting(*a, **kw):
        if kw.get("window"):
            counting.windowed += 1
        return orig(*a, **kw)
    counting.launches, counting.windowed = 0, 0
    AK.flash_attention = counting
    try:
        yield counting
    finally:
        AK.flash_attention = orig


def _f32_cut(params, tree_key, n):
    """``params`` in float32 with the stacked leaves under ``tree_key``
    cut to their first ``n`` layers."""
    return {k: (_map(v, lambda t: t[:n].float()) if k == tree_key else
                (_map(v, lambda t: t.float()) if isinstance(v, dict)
                 else v.float())) for k, v in params.items()}


@contextlib.contextmanager
def plain_ssd_chunk(SK, SR):
    """The SSD op's chunk step on its plain version while the model's
    other kernels run: the flash kernel's own gate in a hybrid model."""
    orig = SK.ssd_chunk
    SK.ssd_chunk = SR.ssd_chunk_batched_ref
    try:
        yield
    finally:
        SK.ssd_chunk = orig


def phase_zamba2(torch, AK, SK, SR, MK, serve, cfgs, models, rng, seed,
                 dev):
    """(k.2) zamba2-7b at published widths (81 layers as 9 groups of 8
    mamba layers and one application of the shared attention+MLP block,
    d 3584, 32 x 112 heads, d_ff 14 336, SSD H 112 x P 64, N 64, chunk
    256): random bf16 weights from ``--seed``, Mamba-2's decay init.

    An 8 x 1024 prefill through the kernels (9 flash, 72 SSD launches)
    and through the plain versions (bf16 rel L2 reported); the gates in
    float32 at a 2-group cut of the same weights: the last logits with
    both kernels within rel L2 1e-3 of plain (the SSD's model gate), and
    with the flash kernel alone (the SSD plain on both sides) within
    1e-4, which the flash kernel at 1.02 x scale must miss (it moves the
    logits less than 1e-3: the SSD's gate cannot see it).  Then phase
    8's traffic through ``serve.Engine``
    (9 flash and 72 SSD launches a round, ``monitor_fleet`` on the
    lanes, engine tokens == direct decode)."""
    import dataclasses
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = cfgs.get_config(ZAMBA_ARCH)
    G, per = cfg.n_layers // (cfg.hybrid_group + 1), cfg.hybrid_group
    model = models.build_model(cfg, bf16)
    plain = models.build_model(cfg, bf16, kernel_impl="plain")
    gc.collect()               # an earlier phase's engine holds its weights
    torch.cuda.empty_cache()   # in a reference cycle until collected
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(g, bf16, device=dev)
    mamba2_decay_init(torch, params["mamba"], g)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_B, PREFILL_S)), device=dev)}
    with torch.inference_mode():
        model.prefill(params, batch)                      # warm-up
        AK.reset_launch_counts()
        SK.reset_launch_counts()
        (lk, _), ms_k = _sync_ms(torch, lambda: model.prefill(params,
                                                              batch))
        launches = (AK.launch_counts()["flash_attention"],
                    SK.launch_counts()["ssd_chunk"])
        (lp, _), ms_p = _sync_ms(torch, lambda: plain.prefill(params, batch))
        rel16 = _rel_l2(lk, lp)
        c32 = dataclasses.replace(cfg, n_layers=ZAMBA_F32_GROUPS * (per + 1))
        p32 = _f32_cut(params, "mamba", ZAMBA_F32_GROUPS * per)
        m32 = models.build_model(c32, f32)
        l32k, _ = m32.prefill(p32, batch)
        l32p, _ = models.build_model(c32, f32, kernel_impl="plain").prefill(
            p32, batch)
        with plain_ssd_chunk(SK, SR):
            l32a, _ = m32.prefill(p32, batch)
            with scaled_flash_forward(torch, AK, 1.02):
                l32s, _ = m32.prefill(p32, batch)
        rel32, rel32a = _rel_l2(l32k, l32p), _rel_l2(l32a, l32p)
        rel32s = _rel_l2(l32s, l32p)
        del p32
    prefill_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    check(launches == (G, G * per), f"zamba2 prefill launched "
          f"flash_attention/ssd_chunk {launches} times, expected "
          f"{(G, G * per)}")
    check(bool(torch.isfinite(lk).all() and torch.isfinite(l32k).all()),
          "non-finite zamba2 prefill logits")
    check(rel32 <= 1e-3, f"zamba2 f32 logits ({ZAMBA_F32_GROUPS} groups): "
          f"kernels vs plain rel L2 {rel32} over 1e-3")
    check(rel32a <= 1e-4, f"zamba2 f32 logits ({ZAMBA_F32_GROUPS} groups): "
          f"the flash kernel vs plain attention rel L2 {rel32a} over 1e-4")
    check(rel32s > 1e-4, f"control: zamba2 f32 logits with the flash kernel "
          f"at 1.02 x scale {rel32s} within 1e-4, so the gate could not fail")
    log(f"model {cfg.name}: {cfg.n_layers} layers as {G} x ({per} mamba + "
        f"the shared block), d {cfg.d_model}, {cfg.n_heads} heads x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, SSD {cfg.ssm_nheads} x "
        f"{cfg.ssm_headdim}, N {cfg.ssm_state}, vocab {cfg.padded_vocab}; "
        f"{n_params / 1e9:.3f} B parameters, {w_bytes / 1e9:.3f} GB bf16 "
        f"(init {t_init:.1f} s, peak {init_peak / 1e9:.2f} GB over "
        f"{base / 1e9:.2f} GB held when the phase began)")
    log(f"zamba2 prefill {SERVE_B} x {PREFILL_S}: kernels {ms_k:.1f} ms, "
        f"plain {ms_p:.1f} ms (host clock, synchronized), {launches[0]} "
        f"flash and {launches[1]} SSD launches; last logits kernels vs "
        f"plain: bf16 rel L2 {rel16:.3e}, f32 at {ZAMBA_F32_GROUPS} groups "
        f"{rel32:.3e} (gate 1e-3), the flash kernel alone {rel32a:.3e} "
        f"(gate 1e-4; at 1.02 x scale {rel32s:.3e} must miss it); peak "
        f"{prefill_peak / 1e9:.2f} GB")
    serve_launches, stats = phase_serve(
        torch, AK, "flash_attention", MK, serve, model, params, rng, dev,
        per_round=G, also=((SK, "ssd_chunk", G * per),))
    del model, plain, params
    gc.collect()
    torch.cuda.empty_cache()
    return serve_launches, stats["ssd_chunk_launches"], {
        "layers": cfg.n_layers, "parameters": n_params,
        "weight_bytes": w_bytes, "base_bytes": base,
        "init_peak_bytes": init_peak,
        "prefill_peak_bytes": prefill_peak, "prefill_8x1024_ms": ms_k,
        "prefill_8x1024_plain_ms": ms_p, "logits_rel_l2_bf16": rel16,
        "logits_rel_l2_f32": rel32, "logits_rel_l2_f32_flash_only": rel32a,
        "logits_rel_l2_f32_scaled_control": rel32s, **stats}


def phase_gemma2(torch, AK, TF, cfgs, models, rng, seed, dev):
    """(k.3) gemma2-2b at published widths (26 layers alternating local
    (window 4096) and global from layer 0, d 2304, 8/4 heads x 256, d_ff
    9216, vocab 256 000, tied and scaled embedding, softcaps 50/30):
    random bf16 weights from ``--seed``, through ``Model.prefill`` and
    ``Model.decode_step`` at its 8192-token context, where the window
    masks.

    A 2 x 8192 prefill through the kernel and the plain attention (26
    flash launches, 13 windowed; bf16 rel L2 reported); the gate in
    float32 at a 2-layer cut (one local, one global) at 2 x 8192: last
    logits within rel L2 1e-4 of plain, and the kernel with its window
    off and at 1.02 x scale must miss.  Decode at the cut agrees with a
    prefill one token longer (same token, logits 1e-4: the plain decode
    window against the kernel's).  Then 16 greedy tokens at batch 2
    after the 8192-token prefill in bf16, every step's window live."""
    import dataclasses
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = cfgs.get_config(GEMMA_ARCH)
    B, S = GEMMA_FLASH_SHAPE[:2]
    model = models.build_model(cfg, bf16)
    plain = models.build_model(cfg, bf16, kernel_impl="plain")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               bf16, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 1)),
                           device=dev)
    batch = {"tokens": toks[:, :S]}
    with torch.inference_mode():
        model.prefill(params, batch)                      # warm-up
        with counted_flash(torch, AK) as fc:
            (lk, cache), ms_k = _sync_ms(torch, lambda: model.prefill(
                params, batch))
        launches, windowed = fc.launches, fc.windowed
        (lp, _), ms_p = _sync_ms(torch, lambda: plain.prefill(params, batch))
        rel16 = _rel_l2(lk, lp)
        # float32 at a 2-layer cut: one local and one global layer
        c32 = dataclasses.replace(cfg, n_layers=GEMMA_F32_LAYERS)
        p32 = _f32_cut(params, "blocks", GEMMA_F32_LAYERS)
        m32 = models.build_model(c32, f32)
        l32k, c32k = m32.prefill(p32, batch)
        l32p, _ = models.build_model(c32, f32, kernel_impl="plain").prefill(
            p32, batch)
        with scaled_flash_forward(torch, AK, 1.0, window=0):
            l32w, _ = m32.prefill(p32, batch)
        with scaled_flash_forward(torch, AK, 1.02):
            l32s, _ = m32.prefill(p32, batch)
        rel32 = _rel_l2(l32k, l32p)
        ctrl = {"window off": _rel_l2(l32w, l32p),
                "scale x 1.02": _rel_l2(l32s, l32p)}
        # decode the (S+1)-th token at the cut against a prefill of S + 1
        c = decode_cache(m32, c32k, B, S, dev, max_seq=S + 1)
        ld, _, _ = TF.lm_forward(
            p32, c32, tokens=toks[:, S:], cache=c,
            pos_offset=torch.full((B,), S, device=dev), mode="decode",
            compute_dtype=f32, logits_mode="last")
        lf, _ = m32.prefill(p32, {"tokens": toks})
        dec_rel = _rel_l2(ld, lf)
        dec_same = bool(torch.equal(ld[:, -1].argmax(-1), lf[:, -1].argmax(-1)))
        del p32, c32k, c
        torch.cuda.empty_cache()
        # 16 greedy tokens in bf16 after the 8192-token prefill
        cache_d = decode_cache(model, cache, B, S, dev,
                               max_seq=S + GEMMA_NEW)
        del cache
        cur = torch.argmax(lk[:, -1], -1).to(torch.int32)
        pos = torch.full((B,), S, device=dev)
        model.decode_step(params, cache_d, cur, pos)       # warm-up, same
        outs = [cur]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GEMMA_NEW - 1):
            cur, cache_d = model.decode_step(params, cache_d, cur, pos)
            pos = pos + 1
            outs.append(cur)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / (GEMMA_NEW - 1)
        gen = torch.stack(outs, 1).cpu().numpy()
        c_bytes = sum(t.numel() * t.element_size() for t in cache_d.values())
    del model, plain, params, cache_d
    torch.cuda.empty_cache()
    n_local = sum(1 for i in range(cfg.n_layers) if TF._is_local(cfg, i))
    check(launches == cfg.n_layers and windowed == n_local,
          f"gemma2 prefill: {launches} flash launches, {windowed} windowed, "
          f"expected {cfg.n_layers} and {n_local}")
    check(bool(torch.isfinite(lk).all() and torch.isfinite(l32k).all()),
          "non-finite gemma2 prefill logits")
    check(rel32 <= 1e-4, f"gemma2 f32 logits ({GEMMA_F32_LAYERS} layers): "
          f"kernel vs plain rel L2 {rel32} over 1e-4")
    for name, r in ctrl.items():
        check(r > 1e-4, f"control: gemma2 f32 logits with the kernel's "
              f"{name} {r} within 1e-4, so the gate could not fail")
    check(dec_same and dec_rel <= 1e-4, f"gemma2 f32 decode vs prefill: "
          f"same token {dec_same}, logits rel L2 {dec_rel}")
    check(gen.shape == (B, GEMMA_NEW)
          and bool(((gen >= 0) & (gen < cfg.padded_vocab)).all()),
          f"gemma2 greedy tokens {gen.shape}")
    tok_s = B * 1e3 / dec_ms
    log(f"model {cfg.name}: {cfg.n_layers} layers ({n_local} local, window "
        f"{cfg.sliding_window}), d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab}; {n_params / 1e9:.3f} B parameters, "
        f"{w_bytes / 1e9:.3f} GB bf16 (init {t_init:.1f} s)")
    log(f"gemma2 prefill {B} x {S}: kernel {ms_k:.1f} ms, plain attention "
        f"{ms_p:.1f} ms (host clock, synchronized), {launches} flash "
        f"launches ({windowed} windowed); last logits kernel vs plain: bf16 "
        f"rel L2 {rel16:.3e}, f32 at {GEMMA_F32_LAYERS} layers {rel32:.3e} "
        f"(gate 1e-4; the controls " + ", ".join(
            f"{n} {r:.3e}" for n, r in ctrl.items()) + " must miss it); "
        f"f32 decode vs prefill logits {dec_rel:.3e}, same token "
        f"{dec_same}; decode {dec_ms:.2f} ms a token at batch {B} "
        f"({tok_s:.1f} tokens/s, {GEMMA_NEW} tokens, cache "
        f"{c_bytes / 1e6:.1f} MB)")
    return launches, {
        "layers": cfg.n_layers, "parameters": n_params,
        "weight_bytes": w_bytes, "prefill_2x8192_ms": ms_k,
        "prefill_2x8192_plain_attn_ms": ms_p, "flash_launches": launches,
        "flash_launches_windowed": windowed, "logits_rel_l2_bf16": rel16,
        "logits_rel_l2_f32": rel32, "logits_rel_l2_f32_controls": ctrl,
        "decode_vs_prefill_rel_l2": dec_rel, "decode_ms_per_token": dec_ms,
        "decode_tokens_per_s": tok_s, "new_tokens": GEMMA_NEW,
        "cache_bytes": c_bytes}

# ---------------------------------------------------------------------------
# phase (l): the vlm family, M-RoPE


def vision_positions(torch, B, grid, text, dev):
    """Qwen2-VL's (3, B, S) M-RoPE streams for one image then text: the
    patches of a ``grid`` at t = 0, h their row, w their column; the
    ``text`` tokens after them at t = h = w, counting up from the
    largest patch position + 1."""
    gh, gw = grid
    t = torch.zeros(gh * gw, dtype=torch.int32)
    h = torch.arange(gh, dtype=torch.int32).repeat_interleave(gw)
    w = torch.arange(gw, dtype=torch.int32).repeat(gh)
    txt = torch.arange(text, dtype=torch.int32) + max(gh, gw)
    pos = torch.stack([torch.cat([x, txt]) for x in (t, h, w)])
    return pos[:, None].expand(3, B, pos.shape[1]).contiguous().to(dev)


def kernel_flash_vlm(torch, AK, AR, dev, seed):
    """The flash forward at qwen2-vl's head layout (64 q heads over 8 kv
    heads x 128: GQA 8), bf16, causal, against the plain version (1e-3,
    as phase 6): the 8 x 1024 prefill and a ragged Engine round of
    8 x 1479."""
    own = np.random.default_rng((seed, 12))
    return flash_cases(torch, AK, AR, [
        ((SERVE_B, PREFILL_S, 64, 8, 128), None, True, own),
        ((SERVE_B, MOE_ROUND_S, 64, 8, 128), None, True, own)], dev, "vlm")


def vlm_attention_gates(torch, AT, cfg, params, g, dev):
    """(l.1) M-RoPE with distinct streams at the attention op: layer 0's
    ``attention`` (qwen2-vl's weights) on inputs over a 32 x 32 patch
    grid and 256 text tokens at batch 8, through the kernel and the
    plain version, rel L2 of the output <= 1e-3 in bf16 and <= 2e-4 in
    float32; the kernel run with the h and w streams swapped must miss
    the gate (the streams reach the rotation)."""
    lp = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    pos = vision_positions(torch, SERVE_B, VLM_GRID, VLM_TEXT, dev)
    x = torch.randn((SERVE_B, pos.shape[-1], cfg.d_model), generator=g,
                    device=dev)
    out = {}
    with torch.inference_mode():
        for dt, tol in ((torch.bfloat16, 1e-3), (torch.float32, 2e-4)):
            p = {k: v.to(dt) for k, v in lp.items()}
            xd = x.to(dt)

            def run(impl, streams):
                return AT.attention(p, xd, streams, cfg, compute_dtype=dt,
                                    impl=impl)[0]
            want = run("plain", pos)
            rel = _rel_l2(run("kernel", pos), want)
            rel_sw = _rel_l2(run("kernel", pos[[0, 2, 1]]), want)
            name = str(dt).removeprefix("torch.")
            check(rel <= tol, f"qwen2-vl attention with vision streams "
                  f"{name}: kernel vs plain rel L2 {rel} over {tol}")
            check(rel_sw > tol, f"control: qwen2-vl attention with the h "
                  f"and w streams swapped {name} {rel_sw} within {tol}, so "
                  f"the gate could not fail")
            out[name] = {"rel_l2": rel, "hw_swapped_rel_l2": rel_sw,
                         "gate": tol}
            del p, xd, want
    log(f"qwen2-vl attention, layer 0, {SERVE_B} x {pos.shape[-1]} "
        f"({VLM_GRID[0]} x {VLM_GRID[1]} patches, then {VLM_TEXT} text), "
        f"M-RoPE streams distinct: kernel vs plain " + "; ".join(
            f"{n} rel L2 {r['rel_l2']:.3e} (gate {r['gate']:g}; h and w "
            f"swapped {r['hw_swapped_rel_l2']:.3e} must miss it)"
            for n, r in out.items()))
    return out


def roofline_line(RA, RN, cfg, shape, measured_s, remat_policy="full"):
    """``roofline_report`` of one step on one card from the analytic
    FLOPs and bytes, with the measured time as a share of its bound."""
    fl = RA.analytic_flops(cfg, shape, remat_policy)
    by = RA.analytic_bytes(cfg, shape)
    rep = RN.roofline_report(flops_per_dev=fl["compiled"],
                             bytes_per_dev=by["traffic"],
                             coll=RN.CollectiveStats({}, {}), n_chips=1,
                             model_flops_total=fl["model_flops"])
    out = {k: rep[k] for k in ("compute_s", "memory_s", "dominant",
                               "step_lower_bound_s")}
    out.update(flops=fl["compiled"], bytes=by["traffic"],
               measured_s=measured_s,
               bound_share=rep["step_lower_bound_s"] / measured_s)
    return out


def phase_vlm(torch, AK, AT, TF, MK, serve, cfgs, models, rng, seed, dev):
    """(l) qwen2-vl-72b at published widths (d 8192, 64/8 heads x 128,
    d_ff 29 568, vocab 152 064, M-RoPE sections (16, 24, 24) of 64,
    theta 1e6) cut to 20 of its 80 layers: 20.04 B parameters, 40.1 GB
    of random bf16 weights from ``--seed`` (5.0 GB of them the embedding
    and unembedding); stub patch embeddings (8, 1024, 8192) bf16 from
    the seed.

    (l.1) ``vlm_attention_gates``.  (l.2) An 8 x 1024 prefill from the
    embeddings through the kernel (20 flash launches) and the plain
    attention (bf16 rel L2 reported); the gate in float32 at a 2-layer
    cut of the same weights: last logits within rel L2 1e-4 of plain,
    and the kernel at 1.02 x scale must miss; decoding one token after
    that prefill agrees with a prefill one row longer (that token's
    embedding): the same token, logits 1e-4.  (l.3) The prefill's time,
    then phase 8's traffic on text prompts through ``serve.Engine`` (20
    flash launches a round, ``monitor_fleet`` on the lanes, engine
    tokens == direct decode); init and prefill peak memory."""
    import dataclasses

    from repro_torch.configs import ShapeConfig
    from repro_torch.roofline import analysis as RN
    from repro_torch.roofline import analytic as RA
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = dataclasses.replace(cfgs.get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    model = models.build_model(cfg, bf16)
    plain = models.build_model(cfg, bf16, kernel_impl="plain")
    gc.collect()               # an earlier phase's engine holds its weights
    torch.cuda.empty_cache()   # in a reference cycle until collected
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(g, bf16, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    B, S = SERVE_B, PREFILL_S
    embeds = torch.randn((B, S, cfg.d_model), generator=g,
                         device=dev).to(bf16)
    batch = {"embeds": embeds}
    attn_gates = vlm_attention_gates(torch, AT, cfg, params, g, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        model.prefill(params, batch)                      # warm-up
        AK.reset_launch_counts()
        (lk, _), ms_k = _sync_ms(torch, lambda: model.prefill(params,
                                                              batch))
        launches = AK.launch_counts()["flash_attention"]
        prefill_peak = torch.cuda.max_memory_allocated(dev)
        (lp, _), ms_p = _sync_ms(torch, lambda: plain.prefill(params, batch))
        rel16 = _rel_l2(lk, lp)
        # float32 at a 2-layer cut of the same weights
        c32 = dataclasses.replace(cfg, n_layers=VLM_F32_LAYERS)
        p32 = _f32_cut(params, "blocks", VLM_F32_LAYERS)
        m32 = models.build_model(c32, f32)
        l32k, c32k = m32.prefill(p32, batch)
        l32p, _ = models.build_model(c32, f32, kernel_impl="plain").prefill(
            p32, batch)
        with scaled_flash_forward(torch, AK, 1.02):
            l32s, _ = m32.prefill(p32, batch)
        rel32, rel32s = _rel_l2(l32k, l32p), _rel_l2(l32s, l32p)
        # decode a token after the prefill against a prefill one row
        # longer, whose last row is that token's embedding
        tok = torch.argmax(l32k[:, -1], -1)
        c = decode_cache(m32, c32k, B, S, dev, max_seq=S + 1)
        ld, _, _ = TF.lm_forward(
            p32, c32, tokens=tok[:, None], cache=c,
            pos_offset=torch.full((B,), S, device=dev), mode="decode",
            compute_dtype=f32, logits_mode="last")
        long = torch.cat([embeds.float(), p32["embed"][tok][:, None]], 1)
        lf, _ = m32.prefill(p32, {"embeds": long})
        dec_rel = _rel_l2(ld, lf)
        dec_same = bool(torch.equal(ld[:, -1].argmax(-1),
                                    lf[:, -1].argmax(-1)))
        del p32, c32k, c, long
    torch.cuda.empty_cache()
    check(launches == cfg.n_layers, f"flash_attention launched {launches} "
          f"times in a {cfg.n_layers}-layer qwen2-vl prefill")
    check(bool(torch.isfinite(lk).all() and torch.isfinite(l32k).all()),
          "non-finite qwen2-vl prefill logits")
    check(rel32 <= 1e-4, f"qwen2-vl f32 logits ({VLM_F32_LAYERS} layers): "
          f"kernel vs plain rel L2 {rel32} over 1e-4")
    check(rel32s > 1e-4, f"control: qwen2-vl f32 logits with the kernel at "
          f"1.02 x scale {rel32s} within 1e-4, so the gate could not fail")
    check(dec_same and dec_rel <= 1e-4, f"qwen2-vl f32 decode vs prefill: "
          f"same token {dec_same}, logits rel L2 {dec_rel}")
    roof = roofline_line(RA, RN, cfg, ShapeConfig("vlm_prefill", S, B,
                                                  "prefill"), ms_k / 1e3)
    log(f"model {cfg.name} cut to {cfg.n_layers} of 80 layers: d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}, M-RoPE "
        f"theta {cfg.rope_theta:g}; {n_params / 1e9:.3f} B parameters, "
        f"{w_bytes / 1e9:.3f} GB bf16 (init {t_init:.1f} s, peak "
        f"{init_peak / 1e9:.2f} GB over {base / 1e9:.2f} GB held when the "
        f"phase began)")
    log(f"qwen2-vl prefill {B} x {S} from embeddings: kernel {ms_k:.1f} ms, "
        f"plain attention {ms_p:.1f} ms (host clock, synchronized), "
        f"{launches} flash launches, peak {prefill_peak / 1e9:.2f} GB; last "
        f"logits kernel vs plain: bf16 rel L2 {rel16:.3e}, f32 at "
        f"{VLM_F32_LAYERS} layers {rel32:.3e} (gate 1e-4; the kernel at "
        f"1.02 x scale {rel32s:.3e} must miss it); f32 decode vs a prefill "
        f"one row longer: logits {dec_rel:.3e}, same token {dec_same}")
    log(f"qwen2-vl prefill roofline (analytic, H100 peaks): compute "
        f"{roof['compute_s'] * 1e3:.1f} ms, memory "
        f"{roof['memory_s'] * 1e3:.1f} ms, {roof['dominant']} bound, "
        f"measured {ms_k:.1f} ms = {roof['bound_share']:.3f} of the bound")
    serve_launches, stats = phase_serve(torch, AK, "flash_attention", MK,
                                        serve, model, params, rng, dev)
    del model, plain, params, embeds
    gc.collect()
    torch.cuda.empty_cache()
    return launches + serve_launches, roof, {
        "layers": cfg.n_layers, "parameters": n_params,
        "weight_bytes": w_bytes, "base_bytes": base,
        "init_peak_bytes": init_peak, "init_s": t_init,
        "prefill_peak_bytes": prefill_peak,
        "prefill_8x1024_embeds_ms": ms_k,
        "prefill_8x1024_embeds_plain_attn_ms": ms_p,
        "prefill_flash_launches": launches, "attention_gates": attn_gates,
        "logits_rel_l2_bf16": rel16, "logits_rel_l2_f32": rel32,
        "logits_rel_l2_f32_scaled_control": rel32s,
        "decode_vs_prefill_rel_l2": dec_rel, **stats}



def phase_dryrun(DR):
    """(m.1) ``launch.dryrun.lower_cell`` on the host for the three
    ``DRYRUN_CELLS``: each traces one rank's step over a fake 256- or
    512-rank world on meta DTensors (no card).  One line a cell: status,
    peak GB a rank, the dominant roofline term, the roofline fraction,
    the collective bytes by op.  Every cell must be ok."""
    out = {}
    for arch, shape, multi in DRYRUN_CELLS:
        tag = f"{arch} {shape} {'multi' if multi else 'single'}"
        t0 = time.perf_counter()
        res = DR.lower_cell(arch, shape, multi)
        wall = time.perf_counter() - t0
        check(res["status"] == "ok", f"dry run {tag}: {res}")
        rf, mem = res["roofline"], res["memory"]
        out[tag] = {
            "status": res["status"], "n_chips": res["n_chips"],
            "peak_gb_per_rank": mem["peak_bytes_per_dev"] / 1e9,
            "argument_gb_per_rank": mem["argument_bytes_per_dev"] / 1e9,
            "fits_hbm": mem["fits_hbm"], "dominant": rf["dominant"],
            "roofline_fraction": rf["roofline_fraction"],
            "collective_bytes_by_op": rf["collective_bytes_by_op"],
            "collective_count_by_op": rf["collective_count_by_op"],
            "flops_per_rank": res["cost"]["flops"], "wall_s": wall}
        log(f"dry run {tag}: " + json.dumps(out[tag]))
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def nccl_world(torch, dev):
    """A process group of one rank on the card (NCCL), torn down after."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def counted_constrain(torch, modules):
    """Count the model's ``constrain`` calls that get a DTensor (the
    sites the sharding context reaches), by wrapping each model
    module's imported name."""
    from torch.distributed.tensor import DTensor
    origs = [m.constrain for m in modules]

    def counting(x, axes, _orig=origs[0]):
        counting.calls += isinstance(x, DTensor)
        return _orig(x, axes)
    counting.calls = 0
    for m in modules:
        m.constrain = counting
    try:
        yield counting
    finally:
        for m, o in zip(modules, origs):
            m.constrain = o


def phase_sharded_prefill(torch, AK, DA, DS, LM, sites, cfgs, models, rng,
                          seed, dev):
    """(m.2) internlm2-1.8b at full width, random bf16 weights, an
    8 x 1024 prefill under a sharding context on an NCCL world of one:
    a (data 1, model 1) mesh, the parameters and tokens DTensors placed
    by ``placements_for``, ``constrain`` live, the flash kernel on the
    local shards through the operator's registered sharding.  Gated
    against the unsharded prefill in the same process (last logits rel
    L2 <= 1e-6, the same 24 flash launches); the plain attention under
    the same context launches none.  Timed in turns (unsharded, sharded,
    sharded, unsharded; host clock, synchronized)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    cfg = cfgs.get_config(ARCH)
    model = models.build_model(cfg, torch.bfloat16)
    plain = models.build_model(cfg, torch.bfloat16, kernel_impl="plain")
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               torch.bfloat16, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (SERVE_B, PREFILL_S)), device=dev)
    mesh = LM.make_local_mesh(1, 1, device=dev.type)
    rules = DS.act_rules("prefill")
    specs = DS.param_specs_tree(model.param_axes(),
                                model.abstract_params(torch.bfloat16), mesh,
                                DS.param_rules())
    dparams = _map2(params, specs, lambda t, s: distribute_tensor(
        t, mesh, DS.placements_for(s, mesh), src_data_rank=None))
    dtoks = distribute_tensor(toks, mesh, DS.placements_for(DS.spec_for(
        tuple(toks.shape), ("batch", "seq"), rules, mesh), mesh),
        src_data_rank=None)
    ctx = DA.ShardingContext(mesh, rules, DS.param_rules())

    def unsharded():
        return model.prefill(params, {"tokens": toks})

    def sharded(m=model):
        with DA.use_sharding(ctx):
            return m.prefill(dparams, {"tokens": dtoks})

    with torch.no_grad():
        unsharded(), sharded()                            # warm-up
        AK.reset_launch_counts()
        (lu, _), _ = _sync_ms(torch, unsharded)
        n_u = AK.launch_counts()["flash_attention"]
        AK.reset_launch_counts()
        with counted_constrain(torch, sites) as cc:
            (ls, cache), _ = _sync_ms(torch, sharded)
        n_s = AK.launch_counts()["flash_attention"]
        AK.reset_launch_counts()
        sharded(plain)
        n_p = AK.launch_counts()["flash_attention"]
        turns = {"unsharded": [], "sharded": []}
        for name in ("unsharded", "sharded", "sharded", "unsharded"):
            _, ms = _sync_ms(torch, unsharded if name == "unsharded"
                             else sharded)
            turns[name].append(ms)
    check(isinstance(ls, DTensor) and isinstance(cache["k"], DTensor),
          "the sharded prefill did not return DTensors")
    rel = _rel_l2(ls.full_tensor(), lu)
    check(rel <= 1e-6, f"sharded prefill logits vs unsharded: rel L2 {rel}")
    check(n_s == n_u == cfg.n_layers, f"flash launches: sharded {n_s}, "
          f"unsharded {n_u}, {cfg.n_layers} layers")
    check(n_p == 0, f"the plain attention launched flash {n_p} times")
    check(cc.calls == 2 + 3 * cfg.n_layers, f"{cc.calls} constrain calls "
          f"saw a DTensor")
    ms_u, ms_s = (sum(v) / len(v) for v in (turns["unsharded"],
                                            turns["sharded"]))
    stats = {"prefill_8x1024_unsharded_ms": ms_u,
             "prefill_8x1024_sharded_ms": ms_s,
             "sharded_over_unsharded": ms_s / ms_u,
             "turns_ms": turns, "logits_rel_l2": rel,
             "flash_launches": n_s, "plain_flash_launches": n_p,
             "constrain_calls": cc.calls}
    log(f"(m.2) sharded prefill {SERVE_B} x {PREFILL_S}: {ms_s:.1f} ms vs "
        f"{ms_u:.1f} ms unsharded; logits rel L2 {rel:.3e}; {n_s} flash "
        f"launches ({n_p} under plain); {cc.calls} constrain calls on "
        f"DTensors")
    del model, plain, params, dparams, cache
    gc.collect()
    torch.cuda.empty_cache()
    return n_s, stats


def _map2(tree, other, fn):
    return {k: (_map2(v, other[k], fn) if isinstance(v, dict)
                else fn(v, other[k])) for k, v in tree.items()}


def phase_moe_ep(torch, MOE, LL, RC, cfgs, seed, dev):
    """(m.3) ``moe_block_ep`` against ``moe_block`` on an NCCL world of
    one, a (1, 1, 1) (data, expert, tp) mesh: phi3.5-moe's published
    widths at one layer (d 4096, 16 experts top 2, d_ff 6400, SwiGLU),
    random float32 weights, capacity_factor 4.0 so that nothing drops
    (the reference's EP test); at (8, 1024) and at decode (8, 1).  y
    within 1e-4 max-abs and the router probs within 1e-5 (the
    reference's gates); the NCCL all-reduce runs for real (counted).
    Device times by CUDA events."""
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    cfg = dataclasses.replace(cfgs.get_config(MOE_ARCH), capacity_factor=4.0)
    mesh = init_device_mesh(dev.type, (1, 1, 1),
                            mesh_dim_names=("data", "expert", "tp"))
    g = torch.Generator(device=dev).manual_seed(seed)
    p = MOE.moe_param_defs(LL.init_creator(g, torch.float32, device=dev),
                           "moe", cfg)
    out = {}
    for B, S in MOE_EP_SHAPES:
        decode = S == 1
        x = torch.randn(B, S, cfg.d_model, generator=g, device=dev)

        def dense():
            return MOE.moe_block(x, p, cfg, compute_dtype=torch.float32)

        def ep():
            return MOE.moe_block_ep(x, p, cfg, mesh,
                                    compute_dtype=torch.float32,
                                    decode=decode)
        with torch.no_grad():
            y0, p0 = dense()
            (y1, p1), coll, _ = RC.count_collectives(ep)
            ms_ep = event_ms(torch, ep, reps=5)
            ms_dense = event_ms(torch, dense, reps=5)
        ey = float((y1 - y0).abs().max())
        ep_ = float((p1 - p0).abs().max())
        check(float(y0.abs().max()) > 0, "moe_block gave zeros")
        check(ey <= 1e-4 and ep_ <= 1e-5, f"moe_block_ep vs moe_block at "
              f"({B}, {S}): y {ey}, probs {ep_}")
        check(coll.count_by_op.get("all-reduce", 0) >= 1,
              f"no all-reduce in moe_block_ep: {coll.count_by_op}")
        out[f"{B}x{S}"] = {"y_max_abs": ey, "probs_max_abs": ep_,
                           "ep_ms": ms_ep, "dense_ms": ms_dense,
                           "collectives": coll.count_by_op}
        log(f"(m.3) moe_block_ep ({B}, {S}, {cfg.d_model}) decode={decode}: "
            f"{ms_ep:.3f} ms vs moe_block {ms_dense:.3f} ms; max-abs y "
            f"{ey:.2e}, probs {ep_:.2e}; collectives {coll.count_by_op}")
    del p
    torch.cuda.empty_cache()
    return out


def phase_analysis(AM):
    """(n.1) The contract analyzer over the port's sources, in this
    process: ``python -m repro_torch.analysis -q src/repro_torch``
    against the shipped baseline must return 0 (it prints its summary
    line)."""
    t0 = time.perf_counter()
    rc = AM.main(["-q", str(SRC / "repro_torch")])
    check(rc == 0, f"repro_torch.analysis returned {rc} over src/repro_torch")
    return {"analyzer_rc": rc, "analyzer_s": time.perf_counter() - t0}


def phase_witness(torch, K, CT, S, M, FT, W, WT, LO, dev, seed):
    """(n.2) The runtime lock witness over the control plane on the card.
    A ``LockWitness`` is activated before anything of the phase is built
    (it wraps the locks created while it is active, classified by their
    creation site, and the package's module-level ones such as the
    decision-step cache's), then one storm cell of the matrix runs through
    ``workloads.harness.run_cell`` (step/full/storm: a ``ControlGroup``,
    its ``ControlLoop``, ``FleetMonitorService`` and ``CounterArena``,
    ``monitor_fleet`` on each dispatch, the decision's CUDA graph on each
    tick), then one supervised chaos pipeline (``chaos_runs`` at
    ``WITNESS_CHAOS_ITEMS``).  The witness must record no hazard and
    must have wrapped locks of every rank 0-4.  The control: an
    arena-rank lock of the run taken, then a service-rank one, must be
    recorded as an inversion."""
    witness = WT.LockWitness().activate()
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        cell = W.run_cell("step", "full", "storm", seed=seed, quick=True,
                          impl="jit", device=dev)
        _sync(torch, dev)
        cell_s = time.perf_counter() - t0
        cell_launches = K.launch_counts()["monitor_fleet"]
        t0 = time.perf_counter()
        chaos = chaos_runs(torch, K, CT, S, M, FT, dev, seed,
                           items=WITNESS_CHAOS_ITEMS)
        chaos_s = time.perf_counter() - t0
    finally:
        witness.deactivate()
    hazards = witness.report()
    wrapped = witness.wrapped()
    per_level = {lv.name: wrapped.get(lv.rank, 0) for lv in LO.LOCK_ORDER}
    log(f"witness: storm cell {cell_s:.2f} s (availability "
        f"{cell.availability:.4f}, {cell.actions} actions, faults "
        f"{cell.faults_fired}, {cell_launches} monitor_fleet launches), "
        f"chaos pipeline {chaos_s:.2f} s ({chaos['out']} items out, "
        f"{chaos['fired']} fired, {chaos['respawns']} respawns, "
        f"{chaos['launches']} monitor_fleet launches); locks wrapped per "
        f"level {per_level}; hazards {hazards}")
    check(not hazards, f"the lock witness recorded hazards: {hazards}")
    missing = [lv.name for lv in LO.LOCK_ORDER
               if lv.rank <= 4 and not wrapped.get(lv.rank)]
    check(not missing, f"the witness wrapped no lock of level(s) {missing}")
    check(cell_launches > 0 and chaos["launches"] > 0,
          "monitor_fleet never launched under the witness")
    check(chaos["unhandled"] == 0,
          f"{chaos['unhandled']} unhandled deaths in the chaos run")

    # the control: two wrapped locks of the run, taken against the order
    by_rank = {}
    for lock in witness.locks():
        by_rank.setdefault(lock.level.rank, lock)
    arena, service = by_rank[LO.RANK["arena"]], by_rank[LO.RANK["service"]]
    check(arena.acquire(timeout=5.0), f"{arena.desc} is held")
    try:
        check(service.acquire(timeout=5.0), f"{service.desc} is held")
        service.release()
    finally:
        arena.release()
    control = witness.report()
    log(f"witness control (arena {arena.desc}, then service "
        f"{service.desc}): {control}")
    check(len(control) == 1 and control[0].startswith("inversion")
          and "arena" in control[0] and "service" in control[0],
          f"the forced inversion was not recorded as one: {control}")
    return cell_launches + chaos["launches"], {
        "witness_locks_per_level": per_level, "witness_hazards": hazards,
        "witness_control": control, "witness_cell_s": cell_s,
        "witness_chaos_s": chaos_s,
        "witness_cell_availability": cell.availability,
        "witness_chaos_fired": chaos["fired"],
        "witness_chaos_respawns": chaos["respawns"],
        "witness_launches": cell_launches + chaos["launches"]}


@contextlib.contextmanager
def _wall(walls, name):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        walls[name] = time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    start = time.perf_counter()
    if not (SRC / "repro_torch" / "kernels" / "monitor" / "csrc"
            / "monitor.cu").exists():
        print("chip_smoke.py: the repro_torch sources are not beside this "
              "script; run it from the repository root", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import configs as C
    from repro_torch import control as CT
    from repro_torch import data as D
    from repro_torch import ft as FT
    from repro_torch import workloads as W
    from repro_torch.control import loop as CL
    from repro_torch.control import policy as CP
    from repro_torch import models as MD
    from repro_torch import serve as SV
    from repro_torch.core import monitor as M
    from repro_torch import streams as S
    from repro_torch.kernels._build import ptxas_report
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.attention import ops as AO
    from repro_torch.kernels.attention import ref as AR
    from repro_torch.kernels.monitor import kernel as K
    from repro_torch.kernels.monitor import ops as O
    from repro_torch.kernels.monitor import ref as R
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ops as SO
    from repro_torch.kernels.ssd import ref as SR
    from repro_torch.models import attention as AT
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TF
    from repro_torch.models import whisper as WH
    from repro_torch.train import step as TS
    from repro_torch.dist import api as DA
    from repro_torch.dist import sharding as DS
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as LM
    from repro_torch.models import layers as LL
    from repro_torch.models import moe as MOE
    from repro_torch.roofline import counters as RC
    from repro_torch.analysis import __main__ as AM
    from repro_torch.analysis import lock_order as LO
    from repro_torch.analysis import witness as WT

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:       # one nvcc per source, together
        libs = list(pool.map(lambda build: build(),
                             (K.build, AK.build, AK.build_bwd, SK.build)))
    log(f"kernels built in {time.perf_counter() - t0:.1f} s -> "
        f"{[lib.name for lib in libs]}")
    for lib in libs:
        for r in ptxas_report(Path(str(lib) + ".log").read_text()):
            log(f"  ptxas {lib.name.split('-')[0][3:]} {r['kernel']}: "
                f"{r['registers']} registers, {r['spill_stores']}/"
                f"{r['spill_loads']} B spill stores/loads, {r['stack']} B "
                f"stack, {r['smem']} B static smem")
    spills = [r for r in ptxas_report(Path(str(libs[2]) + ".log").read_text())
              if "wgmma" in r["kernel"]
              and r["kernel"].split("<")[1].startswith("128,")
              and (r["spill_stores"] or r["spill_loads"])]
    check(not spills, f"flash_attention_bwd's tensor-core kernels spill at "
          f"hd 128: {spills}")
    spills = [r for r in ptxas_report(Path(str(libs[1]) + ".log").read_text())
              if "wgmma" in r["kernel"]
              and (r["spill_stores"] or r["spill_loads"])]
    check(not spills, f"flash_attention's tensor-core kernels spill: "
          f"{spills}")
    sass = sass_step_instructions(libs[0], "monitor_fleet_kernelILi32ELi16E"
                                  "Li2ELb0ELb1E")
    log(f"  monitor_fleet (state mode, time-major, 32/16/2): dynamic smem "
        f"{K.fleet_shared_memory_bytes(M.MonitorConfig())} B a CTA, "
        f"{sass if sass is not None else 'not measured'} SASS "
        f"instructions in one step of the fold")
    log("  flash_attention dynamic smem (B): " + ", ".join(
        f"hd {hd} bf16 {AK.shared_memory_bytes(hd, torch.bfloat16)} f32 "
        f"{AK.shared_memory_bytes(hd, torch.float32)}"
        for hd in AK.HEAD_DIMS))
    log("  flash_attention_bwd dynamic smem (B): " + ", ".join(
        f"hd {hd} bf16 "
        f"{AK.shared_memory_bytes_bwd(hd, torch.bfloat16)} f32 "
        f"{AK.shared_memory_bytes_bwd(hd, torch.float32)}"
        for hd in AK.BWD_HEAD_DIMS))

    walls = {"start, build": time.perf_counter() - start}

    def wall(name):
        """Time a phase of the run into ``walls`` (host clock)."""
        return _wall(walls, name)

    with wall("1-4 monitor kernels, service"):
        b_err = phase_batched(torch, K, R, rng, dev)
        st_seed = phase_fleet(torch, K, M, R, rng, dev, args.seed)
        fleet = kernel_fleet_at_path(torch, K, M, R, O, st_seed, rng, dev,
                                     sass, args.seed)
        del st_seed
        fleet_launches, svc, path = phase_service(torch, K, M, S, dev)
    with wall("a-b control, pipeline"):
        control = phase_control(torch, K, CT, CL, CP, path, dev)
        path["svc"].stop()
        del path
        control.update(phase_pipeline(torch, K, CT, S, M, dev))
        step_launches = phase_step_path(torch, K, O, M, rng, dev)
        batched = kernel_batched_at_path(torch, K, R, rng, dev,
                                         max(b_err.values()), args.seed)
    with wall("5-6 flash"):
        flash_err = phase_flash(torch, AK, AR, rng, dev, args.seed)
        flash = kernel_flash_at_path(torch, AK, AR, rng, dev, flash_err)
    with wall("7-8 internlm2, c serve control"):
        model, params, model_stats = phase_model(torch, AK, AO, C, MD, rng,
                                                 args.seed, dev)
        prompts = []
        flash_launches, serve_stats = phase_serve(
            torch, AK, "flash_attention", K, SV, model, params, rng, dev,
            prompts=prompts)
        control.update(phase_serve_control(torch, AK, "flash_attention", K,
                                           SV, model, params, prompts, dev))
        del model, params
        torch.cuda.empty_cache()
    fault_launches, faults = {}, {}
    for ph, fn in (("d", lambda: phase_matrix(torch, K, CT, W, dev,
                                              args.seed)),
                   ("e", lambda: phase_chaos(torch, K, CT, S, M, FT, dev,
                                             args.seed)),
                   ("f", lambda: phase_soak(torch, K, SV, S, FT, W, dev,
                                            args.seed)),
                   ("g", lambda: phase_rate_tracker(torch, K, FT, M, dev,
                                                    args.seed)),
                   ("h", lambda: phase_data(torch, K, D, S, dev,
                                            args.seed))):
        with wall(ph):
            fault_launches[ph], stats = fn()
        faults.update(stats)
        faults[f"phase_{ph}_wall_s"] = walls[ph]
    with wall("9-11 ssd, mamba2"):
        ssd_err = phase_ssd(torch, SK, SR, SO, rng, dev)
        ssd = kernel_ssd_at_path(torch, SK, SR, rng, dev, ssd_err)
        model, params, ssm_model_stats = phase_ssm_model(
            torch, SK, SO, C, MD, rng, args.seed, dev)
        ssd_launches, ssm_serve_stats = phase_serve(
            torch, SK, "ssd_chunk", K, SV, model, params, rng, dev,
            spans=lambda: conv_spans(torch, SSM))
        del model, params
        torch.cuda.empty_cache()
    with wall("i.1 flash backward"):
        bwd = phase_flash_bwd(torch, AK, AR, rng, dev, args.seed)
    with wall("i.2-i.4 grads, trainer, ckpt"):
        train = {"grads": phase_train_grads(torch, AK, AR, AO, C, MD, rng,
                                            args.seed, dev)}
        bwd_launches, train["fit"] = phase_trainer(torch, AK, K, C, MD, TS,
                                                   D, dev, args.seed)
        train["ckpt"] = phase_ckpt_resume(torch, C, MD, rng, dev, args.seed)
        torch.cuda.empty_cache()
    with wall("j.1 whisper serve"):
        whisper_launches, whisper = phase_whisper(torch, AK, AO, WH, C, MD,
                                                  rng, args.seed, dev)
        whisper["flash"] = kernel_flash_whisper(torch, AK, AR, rng, dev,
                                                args.seed)
    with wall("j.2 whisper gradient"):
        wbwd_launches, whisper["grads"] = phase_whisper_grads(
            torch, AK, AR, AO, C, MD, rng, args.seed, dev)
    with wall("j.3 moe"):
        moe_flash_err = kernel_flash_moe(torch, AK, AR, dev, args.seed)
        moe_launches, moe = phase_moe(torch, AK, AO, K, SV, TF, C, MD, rng,
                                      args.seed, dev)
    with wall("k.1 flash hd 112, 256"):
        flash_k = kernel_flash_k(torch, AK, AR, dev, args.seed)
    with wall("k.2 zamba2"):
        zamba_launches, zamba_ssd, zamba = phase_zamba2(
            torch, AK, SK, SR, K, SV, C, MD, rng, args.seed, dev)
    with wall("k.3 gemma2"):
        gemma_launches, gemma = phase_gemma2(torch, AK, TF, C, MD, rng,
                                             args.seed, dev)
    with wall("l vlm"):
        vlm_flash_err = kernel_flash_vlm(torch, AK, AR, dev, args.seed)
        vlm_launches, vlm_roof, vlm = phase_vlm(
            torch, AK, AT, TF, K, SV, C, MD, rng, args.seed, dev)
    with wall("m.1 dry runs"):
        sharded = {"dryrun": phase_dryrun(DR)}
    with wall("m.2-m.3 sharded prefill, moe_block_ep"):
        with nccl_world(torch, dev):
            sharded_launches, sharded["prefill"] = phase_sharded_prefill(
                torch, AK, DA, DS, LM, (TF, AT, MOE, WH), C, MD, rng,
                args.seed, dev)
            sharded["moe_ep"] = phase_moe_ep(torch, MOE, LL, RC, C,
                                             args.seed, dev)
    with wall("n.1 analyzer"):
        analysis = phase_analysis(AM)
    with wall("n.2 witness"):
        witness_launches, witness = phase_witness(
            torch, K, CT, S, M, FT, W, WT, LO, dev, args.seed)
    analysis.update(witness, n1_wall_s=walls["n.1 analyzer"],
                    n2_wall_s=walls["n.2 witness"])

    src = "src/repro_torch/kernels/monitor/csrc/monitor.cu"
    kernels = [
        {"name": "monitor_fleet", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/monitor/kernel.py:120",
         "launches": (fleet_launches + sum(fault_launches.values())
                      + train["fit"]["monitor_fleet_launches"]
                      + witness_launches),
         "max_abs_err": fleet["max_abs_err"],
         "ms": fleet["ms"], "plain_ms": fleet["plain_ms"],
         "bound_ms": fleet["bound_ms"], "bound_by": fleet["bound_by"],
         "library_ms": None},
        {"name": "batched_monitor", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/monitor/kernel.py:54",
         "launches": step_launches, "max_abs_err": batched["max_abs_err"],
         "ms": batched["ms"], "plain_ms": batched["plain_ms"],
         "bound_ms": batched["bound_ms"], "bound_by": batched["bound_by"],
         "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/attention/csrc/attention.cu",
         "replaces": "src/repro/kernels/attention/kernel.py:25",
         "launches": (flash_launches + whisper_launches + moe_launches
                      + zamba_launches + gemma_launches + vlm_launches
                      + sharded_launches),
         "max_abs_err": max(flash["max_abs_err"],
                            whisper["flash"]["max_abs_err"], moe_flash_err,
                            flash_k["max_abs_err"], vlm_flash_err),
         "ms": flash["ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": flash["library_ms"]},
        {"name": "ssd_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd/kernel.py:25",
         "launches": ssd_launches + zamba_ssd,
         "max_abs_err": ssd["max_abs_err"],
         "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
         "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
         "library_ms": ssd["library_ms"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/attention/csrc/attention_bwd.cu",
         "replaces": "src/repro/train/step.py:54 (jax.value_and_grad of "
                     "src/repro/models/attention.py)",
         "launches": bwd_launches + wbwd_launches,
         "max_abs_err": bwd["max_abs_err"],
         "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
         "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
         "library_ms": bwd["library_ms"]},
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    log(json.dumps({"flash": {k: flash[k] for k in (
        "ms", "library_ms", "turns_ms", "f32_ms", "tflops", "tile_tflops")}}))
    log(json.dumps({"flash_instances": flash_k}))
    log(json.dumps({"ssd": {k: ssd[k] for k in (
        "ms", "bound_ms", "plain_ms", "tflops", "own_tflops")}}))
    extra = {"monitor_fleet_row_major_ms": fleet["ms_row_major"],
             "monitor_fleet_call_ms": fleet["call_ms"],
             "batched_monitor_warm_ms": batched["ms_warm"],
             "batched_monitor_call_ms": batched["call_ms"],
             "monitor_fleet_sass_step_instructions":
                 fleet["sass_step_instructions"],
             "monitor_fleet_issue_ms": fleet["issue_ms"],
             "monitor_fleet_T256_ms": fleet["ms_T256"],
             "monitor_fleet_T256_row_major_ms": fleet["ms_T256_row_major"],
             "monitor_fleet_T256_bound_ms": fleet["bound_ms_T256"],
             "batched_monitor_bf16_ms": batched["ms_bf16"],
             "batched_monitor_bf16_bound_ms": batched["bound_ms_bf16"],
             **svc}
    log(json.dumps({"service": extra}))
    log(json.dumps({"control": control}))
    log(json.dumps({"faults": {**faults, "monitor_fleet_launches": {
        "service": fleet_launches, **fault_launches,
        "train": train["fit"]["monitor_fleet_launches"]}}}))
    log(json.dumps({"serve": {"arch": ARCH, **model_stats, **serve_stats}}))
    log(json.dumps({"serve": {"arch": SSM_ARCH, **ssm_model_stats,
                              **ssm_serve_stats}}))
    log(json.dumps({"serve": {"arch": WHISPER_ARCH, **whisper}}))
    log(json.dumps({"serve": {"arch": MOE_ARCH, **moe}}))
    log(json.dumps({"serve": {"arch": ZAMBA_ARCH, **zamba}}))
    log(json.dumps({"serve": {"arch": GEMMA_ARCH, **gemma}}))
    log(json.dumps({"serve": {"arch": VLM_ARCH, **vlm}}))
    log(json.dumps({"sharded": sharded}))
    log(json.dumps({"analysis": analysis}))
    log(json.dumps({"roofline": {
        f"{VLM_ARCH} prefill {SERVE_B}x{PREFILL_S} ({VLM_LAYERS} layers)":
            vlm_roof,
        f"{ARCH} train step {TRAIN_MICRO * TRAIN_ROWS}x{TRAIN_SEQ}":
            train["fit"]["roofline"]}}))
    walls["total"] = time.perf_counter() - start
    log(json.dumps({"wall_s": walls}))
    log(json.dumps({"train": {"flash_attention_bwd": {k: bwd[k] for k in (
        "ms", "library_ms", "turns_ms", "tflops", "tile_tflops", "fwd_ms",
        "fwd_lse_ms", "controls_rel_l2")}, **train}}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
