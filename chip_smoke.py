"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

(``--profile`` adds one more run of the quantized serving path, one
more training call and two ResNet-50 steps under ``torch.profiler`` and
prints where the device time goes. ``--old-source FILE``, which may be
given more than once, builds FILE beside the port's kernels and times it
before and after the port's own: an earlier source of the float32
forward's C entry ``flash_fwd_f32`` (for example the scalar design,
``git show 1b5748f:paddle_tpu_torch/kernels/csrc/flash_attention.cu``) in
the flash times phase, or an earlier ``ragged_attention.cuh`` (for
example the SIMT page walk, ``git show 73a9031:paddle_tpu_torch/kernels/
csrc/ragged_attention.cuh``; its page types' libraries are built from it)
in the ragged times phase, or an earlier decode kernel
``paged_attention.cu`` (for example the SIMT walk, ``git show
6afcada:paddle_tpu_torch/kernels/csrc/paged_attention.cu``, with its
``paged_walk.cuh`` extracted beside it: a source's ``#include "..."`` is
found beside it first, then in ``csrc/``) in the per-tier times phase.)

It builds every CUDA kernel of the port from the sources in
``paddle_tpu_torch/kernels/csrc`` and the user kernel
``paddle_tpu_torch/utils/csrc/my_triple.cu`` (into
``paddle_tpu_torch/kernels/build``, one ``nvcc`` per source, all at
once), holds each kernel against its plain PyTorch version at the
paths' shapes, and drives each path with the launch counts reset just
before and read just after:

- the float serving path: ``GenerationEngine`` over a GPT-2-small-width
  ``TorchLM`` (float32 pages), unsplit and with the KV split;
- speculative decoding: the same engine and model with ``spec_tokens``
  4 and then 0 on the float path's traffic plus four prompts that repeat
  a motif (tokens equal with speculation on and off), and the per-tier
  graphs (``lm_chunk_prefill`` in 512-token chunks, then ``lm_verify``
  or ``lm_decode``) through the decode and mixed kernels, request by
  request, teacher-forced on the engine's tokens against the same loop
  on the plain attention (the mixed kernel is also held to its plain
  version with its key walk split, the host's schedule, and unsplit);
- quantized long-context serving: GPT-3 XL widths at full depth,
  2048-token context, int8 KV pages, int8 weights and the KV split
  (16-page chunks), then the same traffic unsplit;
- the async pipeline on the quantized long-context path: the same
  model and traffic at async depths 0, 1 and 2, each with CUDA graphs
  (one per step signature, replayed) off and then on; equal tokens in
  all six, launches layers x steps through the replays, the captured
  graphs within the engine's bound, and each run's ms per step,
  tokens/s, busy share and peak memory beside the card's name and
  power limit (``phase_async_serving``);
- preemption and the host swap tier: GPT-2-small widths, float32
  pages, async depth 1 with graphs, a pool too small for every request
  at once, three priority classes, a tenant slot quota and a deadline
  (``phase_preempt_swap``): high-priority arrivals preempt, pages swap
  out and back in, the quota defers, the deadline times out, and every
  surviving request's tokens equal its uncontended run;
- the request journal and the device-fault boundary at GPT-2-small
  widths, async depth 1, graphs on (``phase_faults_journal``): a
  journaled run killed at a fixed step and restored into a fresh engine
  gives the uninterrupted run's tokens; seeded NaN rows and seeded
  dispatch faults are counted as retried once (at depth 1 the boundary
  quarantines without a re-run, as the JAX engine does) and end their
  requests ``device_fault`` (retries = injections), every
  other request's tokens equal the clean run, no page leaks; and under
  overload (a queue of 8, the four-level brownout ladder) the ladder
  climbs to shedding, every shed request and ``Overloaded`` rejection
  carries a retry-after above 0, and the ladder descends once the load
  stops;
- observability on the main path (``phase_observability``): the
  quantized long-context engine at async depth 1 with graphs, its
  timed batch with observability on and then off (tokens identical,
  and identical to the async phase's); ms/step on and off, the step
  profiler's phases, its event-timed device-idle share beside
  ``torch.profiler``'s busy share and the graphed path's device time
  by kernel, the SLO digest's TTFT / ITL / queue-wait percentiles, the
  cost ledger's modelled bytes and FLOPs per step against the measured
  device time, and the graph captures against ``graph_bound``;
- quantized serving, the rest: the int8 weight matmul and its row
  quantizer bit-equal to their plain versions at GPT-3 XL's four
  products (M 1 to 512), timed beside their bounds and
  ``torch._int_mm`` (``phase_int8_matmul``); the ragged pair with
  float16/bfloat16 scale pools against its plain version
  (``phase_narrow_kernels``) and the main path with bfloat16 scale
  pools (``phase_narrow_serving``); the main path at depth 1 with graphs,
  ``weight_matmul`` off and then int8 (ms/step, device busy, GEMM and
  dequantization shares, tokens identical across engines and chunk
  budgets, teacher-forced logits within the JAX quality bar of the
  dequant-first route and of float: ``phase_weight_matmul``);
- the replicated serving fabric (``phase_fabric``): two replicas of
  that engine with the int8 matmul on one card, a two-tenant
  shared-prefix burst, outputs equal to one engine's colocated, after
  a mid-burst kill, disaggregated and with tracing off (partings only
  where each run drew its token from its own logits and the two runs'
  logits differ by arithmetic route alone), affinity placement,
  memory released across the kill, and a burn-rate alert fired by a
  slow step and cleared after healing;
- fp8 KV pages at GPT-3 XL widths, four layers, split and unsplit;
- training: ``bench.py``'s configuration (GPT-2-small, batch 16 x 1024
  tokens, AdamW under AMP O2 bf16, ``TrainStep`` of 8 steps per call)
  through the flash attention kernels, after a 2-layer float32 parity
  run of the kernel route against the plain attention route; then the
  same widths and batch in float32 (no AMP, 2 steps per call), where the
  float32 flash kernels (3xTF32 forward, dK/dV and dQ) run at full width;
- training as users configure it (``phase_train_dropout``, this
  slice's main path): ``bench.py``'s configuration with GPTConfig's
  default dropouts 0.1 / 0.1 through the dropout kernel (a threefry
  hash per element, bit-equal to its plain version at the hidden and
  attention-probability shapes, a broadcast mask and float16:
  ``phase_dropout_kernel``), a linear warmup into a cosine decay and
  global-norm clipping, every dropout launch counted and the flash
  kernels idle; AMP O2 float16 with a ``GradScaler`` through the float16
  flash kernels, skipped steps leaving the parameters bit-unchanged
  (``phase_train_fp16``); the remat policies (``phase_remat``); Adam's
  low-memory tiers at GPT-3 XL widths, 4 layers (``phase_adam_lowmem``);
  ``generate`` on GPT-2-small, greedy against a teacher-forced forward
  and sampled twice from one seed (``phase_generate``);
- the Paddle-API core, the main path of the fifth slice: ``custom_op``
  programs on the card, the user kernel ``my_triple`` through
  ``cuda_op`` (the counterpart of ``pallas_op``) at [4, 8] and
  [8192, 8192], bit-equal to ``x * 3.0``; ResNet-50 float32 on the card
  against the port's CPU path (TF32 off, 3 Momentum steps), and in
  float64 through two free-running steps (gradients and updates); and
  ``perf/resnet_bench.py``'s configuration with no cut (resnet50,
  batch 256 x 224^2, Momentum under AMP O2 bf16, ``TrainStep``)
  through ``nn.Layer``, cuDNN convolutions and BatchNorm.

It checks that each path went through its kernels and no other, holds
the float32 flash kernels' outputs (o and lse, the gradients) and their
plain versions' against the same arithmetic in float64 (the kernel's
error within 10x the plain version's), times every kernel beside its
bound, its plain version and a library call (the ragged kernels also
beside the bound of the tensor-core arithmetic they run, with their
launches on each engine path split into decode-only steps and steps
with a chunk or prefix row),
and prints a JSON object of per-kernel numbers and the JSON result
line last. The weights are random, from a seed. Any failed phase
raises; there is no CPU fallback: without CUDA it exits non-zero and
prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

import numpy as np

from paddle_tpu_torch.inference.llm import (CacheConfig, FabricConfig,
                                            GenerationEngine, ModelSpec,
                                            PagedKVCache, QueueFull,
                                            SamplingParams, SchedulerConfig,
                                            ServingFabric, TorchLM,
                                            ngram_draft)
from paddle_tpu_torch.inference.llm.model import (init_lm_params,
                                                  lm_chunk_prefill, lm_decode,
                                                  lm_prefill, lm_ragged_step,
                                                  lm_verify)
from paddle_tpu_torch.inference.llm.engine import _sample_traced
import paddle_tpu_torch.inference.llm.engine as engine_mod
from paddle_tpu_torch.inference.llm.threefry import fold_in, gumbel, prng_key
from paddle_tpu_torch.inference.llm.quant import (QuantConfig,
                                                  align_cache_config,
                                                  prepare_model, quantize_kv)
from paddle_tpu_torch.inference.llm.faults import (EngineKilled, FaultConfig,
                                                   FaultInjector,
                                                   set_default_injector)
from paddle_tpu_torch.inference.llm.journal import RequestJournal
from paddle_tpu_torch.inference.llm.scheduler import Overloaded
from paddle_tpu_torch import observability as obs
import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.amp import GradScaler, decorate
from paddle_tpu_torch.core import random as trng
from paddle_tpu_torch.core import threefry
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import attention as attn
from paddle_tpu_torch.kernels import dropout as dk
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import int8 as i8
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Dropout
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay, LinearWarmup
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.utils import ShapeDtypeStruct, cuda_op, custom_op
from paddle_tpu_torch.utils.custom_op import LAUNCHES as OP_LAUNCHES
from paddle_tpu_torch.vision.models import resnet50

# ~1 ms of device sleep (H100 SM clock up to 1.98 GHz) ahead of each
# timed run, to cover the host's enqueueing of it
SLEEP_CYCLES = 2_000_000
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and dense
# float32 outside the tensor cores, the unit the paged kernels' arithmetic
# uses
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# and dense bf16 and TF32 on the tensor cores: the peaks for the flash
# kernels' bf16 inputs and, three TF32 products to one float32-accurate
# product (3xTF32, as the float32 backward kernels compute), for their
# float32 inputs: 165 TFLOP/s, 2.5x the float32 rate outside them
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
# and dense int8 on the tensor cores: the int8 weight matmul's unit
INT8_OPS_PER_S = 1979e12

# the JAX package's own tolerance for its Pallas tier against the lax
# tier (tests/test_ragged_attention.py), float32 against float32
ATTN_TOL = 2e-5
# the float step with the kernel against the step with the plain
# attention: every matmul is shared, the two attentions sum in
# different orders (~1e-6 apart), and that difference compounds through
# the layers; the CPU parity tests hold the port's step to the JAX step
# at the same 1e-4
STEP_TOL = 1e-4
# the quantized step, kernel against plain attention: the two sides'
# attention outputs differ by float32 summation order (~1e-7), the next
# layer's K/V then differ by as much, and where such a value straddles
# a rounding boundary its stored code moves by one step (~1 % of the
# position's absmax); that is a real difference in the cache, not a
# kernel fault, and it reaches the logits through the later layers.
# Codes must agree to within one step, with flips a small share of the
# codes written; the logits are held to STEP_TOL all the same
MAX_FLIP_SHARE = 1e-3

# the float path: GPT-2-small heads, 8 slots over a 1024-token
# context (paddle_tpu/text/gpt.py GPTConfig.gpt2_small)
GPT2_SMALL = ModelSpec(vocab=50304, d_model=768, num_layers=12,
                       num_heads=12, head_dim=64, max_seq_len=1024)
# this slice's configuration: GPTConfig.gpt3_1p3b (GPT-3 XL) widths at
# full depth and the longest context any preset defines
GPT3_XL = ModelSpec(vocab=50304, d_model=2048, num_layers=24, num_heads=32,
                    head_dim=64, max_seq_len=2048)
GPT3_XL_4L = ModelSpec(vocab=50304, d_model=2048, num_layers=4,
                       num_heads=32, head_dim=64, max_seq_len=2048)
PAGE, SLOTS = 16, 8
SPLIT = 16             # kv_split_pages of the main path
CHUNK = 512            # chunk_tokens of the main path
NEW_TOKENS = 32
MODES = ("f32", "int8", "fp8")
SOURCES = {"f32": "paddle_tpu_torch/kernels/csrc/ragged_attention.cu",
           "int8": "paddle_tpu_torch/kernels/csrc/ragged_attention_int8.cu",
           "fp8": "paddle_tpu_torch/kernels/csrc/ragged_attention_fp8.cu"}
DTYPES = {"f32": torch.float32, "int8": torch.int8,
          "fp8": torch.float8_e4m3fn}
REPLACES = {False: "paddle_tpu/kernels/paged_attention.py:465",
            True: "paddle_tpu/kernels/paged_attention.py:539"}
# rows of at most this many queries take the ragged kernels' decode walk
# (float32 FMAs), longer rows their tensor-core tile (kDecodeMaxQ in
# csrc/ragged_attention.cuh)
DECODE_MAX_Q = 1
# the async phase's tokens of each batch (every run's), filled by
# phase_async_serving and held against by phase_observability
ASYNC_TOKENS: list = []
# the ragged kernels' launches on each engine path by step class, filled
# by drive_path: path label -> {"kernel", "decode", "mix"}
LAUNCHES_BY_STEP: dict = {}
# the per-tier graphs' kernels (the fourth slice)
SPEC_TOKENS = 4        # spec_tokens of the speculative path
PER_TIER = {
    pa.PAGED_KERNEL: ("paddle_tpu_torch/kernels/csrc/paged_attention.cu",
                      "paddle_tpu/kernels/paged_attention.py:102"),
    pa.MIXED_KERNEL: ("paddle_tpu_torch/kernels/csrc/mixed_attention.cu",
                      "paddle_tpu/kernels/paged_attention.py:219")}
# the async pipeline's depths, each run with CUDA graphs off and on
ASYNC_DEPTHS = (0, 1, 2)
# the preemption path: usable pages (too few for every request at
# once), the step the priority-0 requests arrive at, the slot quota of
# tenant "bulk", and the priority-1 request's total deadline (it asks
# for 600 tokens)
PREEMPT_PAGES = 170
PREEMPT_ARRIVAL = 12
PREEMPT_TENANT_SLOTS = 3
PREEMPT_DEADLINE_S = 0.3
# the fault and journal phase: the step the journaled run is killed at,
# the seeded NaN-row and dispatch-fault injections (rate, seed), and the
# overload: a queue of OVERLOAD_QUEUE, OVERLOAD_ARRIVALS submits a step
# for OVERLOAD_STEPS steps, then at most OVERLOAD_CALM steps to descend
FAULT_KILL_STEP = 30
FAULT_NAN = (0.005, 75)
FAULT_DISPATCH = (0.02, 192)
OVERLOAD_QUEUE = 8
OVERLOAD_ARRIVALS = 3
OVERLOAD_STEPS = 120
OVERLOAD_CALM = 400
# the int8 weight matmul: GPT-3 XL's four per-layer
# products as (K, N) (wqkv flattened to N = 3 * H * D, wo, wfc, wproj),
# at M rows from one decode row to a 512-token chunk; the decode
# bucket of eight slots is the kernels line's headline shape
INT8_SHAPES = (("wqkv", 2048, 6144), ("wo", 2048, 2048),
               ("wfc", 2048, 8192), ("wproj", 8192, 2048))
INT8_ROWS = (1, 8, 9, 64, 512)
INT8_HEADLINE_M = 8
INT8_SOURCE = "paddle_tpu_torch/kernels/csrc/int8_matmul.cu"
# the JAX package's quantized-serving quality bar (mean absolute logit
# error, tests/test_coll_quant.py), and the teacher-forced prompt's length
QUANT_MAE_MAX = 0.05
TEACHER_TOKENS = 256
# narrow scale pools: (code mode, scale dtype) pairs of the ragged pair
NARROW = (("int8", torch.float16), ("int8", torch.bfloat16),
          ("fp8", torch.float16), ("fp8", torch.bfloat16))
NARROW_SOURCES = {
    (m, sd): f"paddle_tpu_torch/kernels/csrc/ragged_attention_{m}_"
             f"{'f16' if sd == torch.float16 else 'bf16'}.cu"
    for m, sd in NARROW}
# the fabric phase: replicas, a burst of FABRIC_BURST requests per
# tenant over one shared FABRIC_PREFIX-token prefix each (tails of 4 to
# FABRIC_TAIL tokens, 8 new tokens each), the fabric step the kill lands
# on, the share of prefix-hit pages that must be placed by affinity, and
# the slow-step fault (ms of sleep a replica step) against the alert's
# inter-token objective (ms)
FABRIC_REPLICAS = 2
FABRIC_BURST = 8
FABRIC_PREFIX = 512
FABRIC_TAIL = 64
FABRIC_KILL_STEP = 6
FABRIC_AFFINITY_MIN = 0.9
FABRIC_FAULT_MS = 400
FABRIC_ITL_MS = 300
# rows of a LogitsTap's device ring: every row a compared fabric run
# samples (padding included) must fit
TAP_ROWS = 2048
# the phases' share of a step's wall time the profiler's phases must
# account for
PHASE_SUM_TOL = 0.05
# a token decision closer than this (the two best candidates' scores)
# may fall either way between two float32 computations that agree to
# ~1e-5 (GEMMs of other shapes, attention summed in another order): such
# a near-tie is counted and ends the comparison of that request
NEAR_TIE = 1e-4

# the training path: bench.py's configuration (bench.py:33-55, 66-87)
TRAIN_CFG = dict(vocab_size=50304, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=1024, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0, use_recompute=False,
                 loss_chunks=8)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_K = 16, 1024, 8
TRAIN_LR = 1e-4
TRAIN_CALLS = 3             # timed calls, after one warm call
# the float32 training path: the same widths and batch without AMP,
# where the float32 flash kernels run at full width
TRAIN_F32_K, TRAIN_F32_CALLS = 2, 2
PARITY_LAYERS, PARITY_BATCH, PARITY_STEPS = 2, 4, 3
# the Paddle-API core (the fifth slice): the JAX package's one user
# kernel, ``x * 3`` over float32, as a cuda_op, at the extension test's
# shape and at 256 MiB in / 256 MiB out
TRIPLE_SOURCE = "paddle_tpu_torch/utils/csrc/my_triple.cu"
TRIPLE_REPLACES = "paddle_tpu/utils/custom_op.py:75"
TRIPLE_SHAPES = ((4, 8), (8192, 8192))
# my_triple's threads a block (triple_grid, triple_op)
TRIPLE_BLOCK = 128
# ResNet-50 training: perf/resnet_bench.py:29-63's configuration and
# protocol (resnet50, 1000 classes, Momentum(0.1, 0.9), AMP O2 bf16,
# TrainStep, batch 256 at 224 x 224, 3 warm-up then 10 timed steps)
RESNET_CLASSES, RESNET_SIZE = 1000, 224
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_BATCH, RESNET_WARMUP, RESNET_STEPS = 256, 3, 10
RESNET_PLAIN_STEPS = 5      # more steps with the Tensor subclass's hook off
# ResNet-50 float32 on the card (TF32 off) against the port's CPU path:
# the same weights and inputs, batch 4, 3 Momentum steps, each from the
# CPU's state. Convolutions sum in other orders on cuDNN and on the CPU
# (~1e-6 relative each); 50 layers carry that to ~3e-5 of the logits'
# scale (measured): the logits within 1e-4 of max |logit|, the losses
# at 1e-3 relative, the BatchNorm running statistics (averages over
# every position, forward-only) within 1e-4 of each buffer's largest
# value. A randomly initialised ResNet-50's gradients are
# ill-conditioned in float32 itself (the CPU's float32 against its
# float64: up to ~0.2 of a tensor's largest value), so the backward
# pass and the Momentum update are held in float64 on both sides, two
# steps running freely: every loss, gradient, parameter update and
# running statistic within 1e-6 of its tensor's largest value (float64
# rounding carried through the same ill-conditioning stays ~1e-8)
RESNET_PARITY_BATCH, RESNET_PARITY_STEPS = 4, 3
RESNET_LOGIT_TOL, RESNET_LOSS_RTOL, RESNET_STAT_TOL = 1e-4, 1e-3, 1e-4
RESNET_F64_STEPS, RESNET_F64_TOL = 2, 1e-6
# the flash kernels' shapes: the training path's attention [B, H, S, D]
# and a GPT-3 XL head layout at its 2048-token context
FLASH_TRAIN = (16, 12, 1024, 1024, 64)
FLASH_XL = (2, 32, 2048, 2048, 64)
# each flash kernel's source: bf16 (the training main path's) and float32
# each the forward, and the dK/dV and dQ kernels together
_FLASH_CSRC = "paddle_tpu_torch/kernels/csrc/"
FLASH_SOURCES = {"flash_attention_fwd": _FLASH_CSRC + "flash_fwd_bf16.cu",
                 "flash_attention_bwd_dkdv": _FLASH_CSRC + "flash_bwd_bf16.cu",
                 "flash_attention_bwd_dq": _FLASH_CSRC + "flash_bwd_bf16.cu"}
FLASH_SOURCES_F32 = {
    "flash_attention_fwd": _FLASH_CSRC + "flash_fwd_f32.cu",
    "flash_attention_bwd_dkdv": _FLASH_CSRC + "flash_bwd_f32.cu",
    "flash_attention_bwd_dq": _FLASH_CSRC + "flash_bwd_f32.cu"}
FLASH_REPLACES = {
    "flash_attention_fwd": "paddle_tpu/kernels/flash_attention.py:61",
    "flash_attention_bwd_dkdv": "paddle_tpu/kernels/flash_attention.py:167",
    "flash_attention_bwd_dq": "paddle_tpu/kernels/flash_attention.py:227"}
# flash kernel against its plain version: float32 o and lse at the JAX
# package's Pallas-tier 2e-5, gradients (sums of up to S such terms) at
# 1e-4. bf16: both sides round p and dS to bf16 before their products (a
# step of 2^-8 = 3.9e-3 relative), the kernel against the running row
# max and the plain version against the final one, and round the output
# to bf16 once more, so outputs and gradients are held at 2e-2; lse is
# float32 from the same float32 products in both: 2e-5
FLASH_TOL = {torch.float32: {"o": 2e-5, "lse": 2e-5, "grad": 1e-4},
             torch.bfloat16: {"o": 2e-2, "lse": 2e-5, "grad": 2e-2}}
# the float32 flash kernels (3xTF32 tensor-core products) and their plain
# versions (float32 products) against the same arithmetic in float64: the
# kernel's error at most this many times the plain version's, so that
# agreement with the plain version cannot come from an identical order of
# float32 sums alone
FLASH_F64_RATIO = 10.0
# each float32 flash kernel's outputs, as check_f64 names them
FLASH_F64_OUTPUTS = (("flash_attention_fwd", ("o", "lse")),
                     ("flash_attention_bwd_dkdv", ("dk", "dv")),
                     ("flash_attention_bwd_dq", ("dq",)))
# training, kernel route against plain route (float32, 2 layers): the
# losses at 1e-4 relative; AdamW moves each parameter by about lr a step
# whatever its gradient's size, so where a gradient lies within float32
# noise of 0 the two routes may move it lr apart in either direction:
# every parameter within 2 lr per step, and at most 1e-4 of them more
# than 1e-6 apart
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_CLOSE, TRAIN_MAX_FAR_SHARE = 1e-6, 1e-4
# float16 flash kernels against their plain versions: both round p and
# dS to float16 (a step of 2^-11 = 4.9e-4 relative; the kernel against
# the running row max, the plain version against the final one) and the
# result once more: outputs and gradients at 1e-2, no looser than bf16's
# 2e-2; lse is float32 from the same float32 products: 2e-5
FLASH_TOL[torch.float16] = {"o": 1e-2, "lse": 2e-5, "grad": 1e-2}
FLASH_SOURCES_F16 = {
    "flash_attention_fwd": _FLASH_CSRC + "flash_fwd_f16.cu",
    "flash_attention_bwd_dkdv": _FLASH_CSRC + "flash_bwd_f16.cu",
    "flash_attention_bwd_dq": _FLASH_CSRC + "flash_bwd_f16.cu"}

# training as users configure it (this slice's main path): bench.py's
# configuration with GPTConfig's default dropouts, AdamW under a linear
# warmup into a cosine decay, global-norm clipping, AMP O2 bf16
TRAIN_DROPOUT = 0.1
TRAIN_WARMUP_STEPS, TRAIN_DECAY_STEPS, TRAIN_CLIP = 16, 1000, 1.0
TRAIN_DROPOUT_CALLS = 2     # timed calls, after one warm call
# the dropout kernel: bench.py's hidden dropout (bf16 [B, S, d]) and its
# attention-probability dropout (float32 [B, H, S, S]), a broadcast mask
# (dropout2d's: one draw per (sample, channel)) and float16
DROPOUT_P = 0.1
DROPOUT_HIDDEN = (16, 1024, 768)
DROPOUT_ATTN = (16, 12, 1024, 1024)
DROPOUT_AXIS = ((16, 12, 1024, 64), (16, 12, 1, 1))
# the plain version holds ~a dozen int64 temporaries of its size: at the
# attention shape (201M draws) it is compared over flat slices this long
DROPOUT_PLAIN_SLICE = 16 << 20
# the kept share of a case with at least this many draws within 1e-3 of
# 1 - p (a million draws: a binomial standard deviation of 3e-4)
DROPOUT_KEPT_TOL, DROPOUT_KEPT_MIN_DRAWS = 1e-3, 1 << 20
DROPOUT_SOURCE = "paddle_tpu_torch/kernels/csrc/dropout.cu"
DROPOUT_REPLACES = ("none (paddle_tpu/ops/nn_ops.py:273 dropout and "
                    "paddle_tpu/kernels/attention.py:54: jax.random."
                    "bernoulli and a jnp.where that XLA fuses)")
# the card's peak rate of 32-bit integer and logic operations: its
# instruction issue rate, one warp instruction (32 lanes) a clock on each
# of an SM's four schedulers, x 132 SMs x 1.98 GHz (33.4 T/s; the INT32
# units alone, 64 an SM, give half that, but adds also issue to the FMA
# pipe as IMAD: the kernel ran above that half rate); the dropout
# kernel's integer operations a draw, counted from csrc/dropout.cu's hash
INT32_OPS_PER_S = 4 * 32 * 132 * 1.98e9
DROPOUT_INT_OPS = 84
# float16 O2 with a GradScaler: eager steps from a scale at which the
# loss gradient overflows float16 (its largest entries are about scale /
# 16384 tokens = 2^16 > 65504 as they are cast to float16 in the loss's
# backward), halved at every overflow
FP16_STEPS, FP16_INIT_SCALE = 16, 2.0 ** 30
FP16_FINITE_TAIL = 3        # the last steps that must not overflow
# the remat policies at bench.py's configuration: one warm and one timed
# call each
REMAT_POLICIES = (False, True, "dots", "names:qkv,mlp1", "dots+names:attn")
# Adam's low-memory tiers at GPT-3 XL widths (GPTConfig.gpt3_1p3b) cut to
# 4 layers, a batch of 2 x 2048 tokens, against the full tier
ADAM_XL_CFG = dict(vocab_size=50304, hidden_size=2048, num_hidden_layers=4,
                   num_attention_heads=32, intermediate_size=8192,
                   max_position_embeddings=2048, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0, loss_chunks=8)
ADAM_XL_BATCH, ADAM_XL_SEQ, ADAM_XL_K = 2, 2048, 2
ADAM_LOWMEM = dict(moment_dtype="bfloat16", factored_moment2=True,
                   beta1=0.0, update_rms_clip=1.0)
# generate: GPT-2-small at full width and depth, float32
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 64
GEN_SAMPLING = dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.8,
                    seed=5)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------ ragged mixes


def _geometry(spec):
    return spec.num_heads, spec.head_dim, -(-spec.max_seq_len // PAGE)


def ragged_mix(kind: str, seed: int, device, spec=GPT3_XL, mode="f32"):
    """A ragged attention input at a main path's shapes, with pools of
    ``mode`` pages (float32, or int8/fp8 codes quantized from the same
    float values, with their scale pools).

    At GPT-3 XL geometry (H 32, D 64, page 16, 128 pages per row):
    ``decode`` is eight decode rows at contexts 1900-2047; ``mix`` a
    512-token chunk row at context 1536, a prefix-cache-hit row (100 new
    tokens over 512 cached ones), five decode rows near 2000, an idle
    slot, and bucket padding to 640 flat tokens. At GPT-2-small geometry
    (the float path's shapes: H 12, 64 pages per row): ``decode`` eight
    decode rows near 1000; ``mix`` a 600-token whole-prompt row, a
    100-over-256
    prefix-hit row, five decode rows near 1000, an idle slot and padding
    to 1024. Returns (args, scale kwargs, max q_len, tokens used)."""
    H, D, pps = _geometry(spec)
    g = torch.Generator().manual_seed(seed)
    long_ctx = spec.max_seq_len == 2048
    if kind == "mix" and long_ctx:
        q_lens = [512, 100, 1, 1, 1, 1, 1, 0]
        kv_lens = [1536, 612, 2000, 1990, 2047, 2013, 1999, 0]
        width = 640
    elif kind == "mix":
        q_lens = [600, 100, 1, 1, 1, 1, 1, 0]
        kv_lens = [600, 356, 1000, 997, 1010, 990, 1023, 0]
        width = 1024
    elif long_ctx:
        q_lens = [1] * SLOTS
        kv_lens = [1900, 2047, 1950, 2000, 1999, 2010, 1923, 2040]
        width = SLOTS
    else:
        q_lens = [1] * SLOTS
        kv_lens = [1000, 997, 1010, 990, 1023, 1001, 1005, 999]
        width = SLOTS
    n_pages = SLOTS * pps + 1                # page 0 is the garbage page
    perm = torch.randperm(n_pages - 1, generator=g) + 1
    page_table = perm.reshape(SLOTS, pps).to(torch.int32)
    gd = torch.Generator(device=device).manual_seed(seed)
    k_pool = torch.randn(n_pages, PAGE, H, D, generator=gd, device=device)
    v_pool = torch.randn(n_pages, PAGE, H, D, generator=gd, device=device)
    q = torch.randn(width, H, D, generator=g)
    scales = {}
    if mode != "f32":
        k_pool, k_s = quantize_kv(k_pool, mode)
        v_pool, v_s = quantize_kv(v_pool, mode)
        scales = dict(k_scale=k_s, v_scale=v_s)
    q_starts, start = [], 0
    for ql in q_lens:
        q_starts.append(start)
        start += ql
    i32 = dict(dtype=torch.int32, device=device)
    args = dict(q=q.to(device), k_pool=k_pool, v_pool=v_pool,
                page_table=page_table.to(device),
                kv_lens=torch.tensor(kv_lens, **i32),
                q_starts=torch.tensor(q_starts, **i32),
                q_lens=torch.tensor(q_lens, **i32))
    return args, scales, max(q_lens), start


def attention_work(args, quant: bool, scale_bytes: int = 4):
    """Bytes the function must move (q read, out written, every K and V
    position a row can see read once: float32 values, or 1-byte codes
    plus a ``scale_bytes``-byte scale per position and head) and the
    float32
    operations it does (QK and PV: 4 * D per visible (query, key) pair
    per head; dequantization: one multiply per K and V element of each
    visible position)."""
    _, H, D = args["q"].shape
    q_lens = args["q_lens"].tolist()
    kv_lens = args["kv_lens"].tolist()
    n_tok = sum(q_lens)
    positions = sum(kv for ql, kv in zip(q_lens, kv_lens) if ql > 0)
    per_pos = H * (D + scale_bytes) if quant else H * D * 4
    nbytes = positions * per_pos * 2 + n_tok * H * D * 4 * 2
    pairs = sum((kv - ql + t + 1) for ql, kv in zip(q_lens, kv_lens)
                for t in range(ql))
    flops = pairs * H * 4 * D + (positions * H * D * 2 if quant else 0)
    return nbytes, flops


def bound(args, quant: bool, scale_bytes: int = 4):
    nbytes, flops = attention_work(args, quant, scale_bytes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tc_bound(args, quant: bool, scale_bytes: int = 4):
    """(ms, "bytes" or "operations") for the arithmetic the kernels run:
    the bytes of ``attention_work``; the (query, key) pairs of rows of at
    most DECODE_MAX_Q queries on float32 FMAs (67 TFLOP/s), those of
    longer rows on the TF32 tensor cores at three products (float32
    pages, 3xTF32) or two (codes: only q and p x scale are split) per
    operation (495 TFLOP/s), and dequantization's one operation per K
    and V element of each visible position at 67."""
    nbytes, _ = attention_work(args, quant, scale_bytes)
    _, H, D = args["q"].shape
    q_lens = args["q_lens"].tolist()
    kv_lens = args["kv_lens"].tolist()
    pairs = {True: 0, False: 0}
    for ql, kv in zip(q_lens, kv_lens):
        pairs[ql > DECODE_MAX_Q] += sum(kv - ql + t + 1 for t in range(ql))
    positions = sum(kv for ql, kv in zip(q_lens, kv_lens) if ql > 0)
    t_ops = (pairs[True] * H * 4 * D * (2 if quant else 3)
             / TF32_FLOPS_PER_S
             + (pairs[False] * H * 4 * D
                + (positions * H * D * 2 if quant else 0))
             / FP32_FLOPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def plain(args, scales, split: int):
    """The kernel's plain PyTorch version on the same inputs."""
    if split:
        return pa.ragged_attention_ref_split(**args, split_pages=split,
                                             **scales)
    return pa.ragged_attention(**args, tier="ref", **scales)


# ---------------------------------------------------------------- phases


def phase_build(user_op, others=None) -> None:
    """Every kernel library of the port, the user kernel of ``user_op``
    (a ``cuda_op``) and the ``others`` (library name -> CUDA source
    text), one nvcc each, all at once."""
    t0 = time.perf_counter()
    built = _build.build(_build.KERNELS,
                         {**user_op.build_sources, **(others or {})})
    log(f"[build] {len(built)} kernel librar(y/ies) compiled in "
        f"{time.perf_counter() - t0:.1f}s (one nvcc per source, in "
        "parallel); each nvcc's seconds: "
        + ", ".join(f"{name} {sec:.1f}" for name, (_, sec) in built.items())
        + f"; their sum {sum(sec for _, sec in built.values()):.1f}")
    for name, (text, _) in built.items():
        entry = None
        spill = ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and entry:
                regs = re.search(r"Used (\d+) registers", line)
                log(f"[build] {name}: {entry}: "
                    f"{regs.group(1) if regs else '?'} registers; {spill}")
                entry = None


def phase_kernels(device) -> dict:
    """Every kernel against its plain version at the main path's
    shapes: {f32, int8, fp8} x {unsplit, split 16} x {decode, mix} at
    GPT-3 XL geometry, and the float kernel at GPT-2-small geometry.
    Also: bucket padding exactly 0, the split kernel against the unsplit
    kernel, and the split kernel twice giving identical bits. Returns
    the worst error against the plain version per kernel."""
    worst: dict = {}
    cases = [(GPT3_XL, mode, kind) for mode in MODES
             for kind in ("decode", "mix")]
    cases += [(GPT2_SMALL, "f32", kind) for kind in ("decode", "mix")]
    for seed, (spec, mode, kind) in enumerate(cases):
        args, scales, max_q, n_used = ragged_mix(kind, seed, device, spec,
                                                 mode)
        splits = (0, SPLIT) if spec is GPT3_XL else (0,)
        outs = {}
        for split in splits:
            name = pa.kernel_name(DTYPES[mode], split > 0)
            out = pa.ragged_attention(**args, tier="kernel", max_q_len=max_q,
                                      split_pages=split, **scales)
            torch.cuda.synchronize()
            ref = plain(args, scales, split)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            torch.testing.assert_close(out, ref, rtol=ATTN_TOL, atol=ATTN_TOL)
            if n_used < out.shape[0] and out[n_used:].abs().max().item() != 0:
                raise AssertionError(f"{name}: bucket padding is not exact 0")
            worst[name] = max(worst.get(name, 0.0), err)
            outs[split] = out
            note = ""
            if split:
                again = pa.ragged_attention(**args, tier="kernel",
                                            max_q_len=max_q,
                                            split_pages=split, **scales)
                if not torch.equal(again, out):
                    raise AssertionError(f"{name}: two runs differ")
                torch.testing.assert_close(out, outs[0], rtol=ATTN_TOL,
                                           atol=ATTN_TOL)
                vs_unsplit = (out - outs[0]).abs().max().item()
                note = (f"; vs unsplit kernel {vs_unsplit:.3e}; a second "
                        "run bit-identical")
            log(f"[kernel] {name} {kind} (H {spec.num_heads}): max_abs_err "
                f"vs plain {err:.3e} (tol {ATTN_TOL}), padding exact 0{note}")
    return worst


def per_tier_mix(kind: str, seed: int, device):
    """A decode or mixed attention input at the per-tier path's shapes,
    GPT-2-small geometry (H 12, D 64, 16-token pages, 64 per row):
    ``decode`` eight slots at 900-1023 tokens and one at 0 (exact zeros);
    ``chunk`` one slot, 512 queries after 512 resident tokens;
    ``verify`` eight slots of 1 + 4 query rows near 1000 tokens, with
    q_lens 0 to 5 (padding rows included)."""
    H, D, pps = _geometry(GPT2_SMALL)
    if kind == "decode":
        seq, q_lens, T = [900, 1023, 950, 1000, 999, 1010, 923, 1015, 0], \
            None, 1
    elif kind == "chunk":
        seq, q_lens, T = [1024], [512], 512
    else:
        seq, q_lens, T = [1000, 990, 950, 1023, 1001, 977, 1012, 960], \
            [5, 1, 0, 3, 5, 2, 4, 5], 1 + SPEC_TOKENS
    B = len(seq)
    g = torch.Generator(device=device).manual_seed(seed)
    n_pages = B * pps + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    i32 = dict(dtype=torch.int32, device=device)
    args = dict(q=torch.randn((B, T, H, D) if q_lens else (B, H, D),
                              generator=g, device=device),
                k_pool=torch.randn(n_pages, PAGE, H, D, generator=g,
                                   device=device),
                v_pool=torch.randn(n_pages, PAGE, H, D, generator=g,
                                   device=device),
                page_table=perm.reshape(B, pps).to(**i32),
                seq_lens=torch.tensor(seq, **i32))
    if q_lens:
        args["q_lens"] = torch.tensor(q_lens, **i32)
    return args


def per_tier_call(args, tier, split=None):
    """The decode or mixed attention of ``args`` on ``tier``; ``split``
    forces the mixed kernel's key-walk split (0: unsplit; None: the
    host's own schedule, ``pa.mixed_plan``)."""
    if "q_lens" in args:
        if split is not None and tier == "kernel":
            return pa.mixed_attention_cuda(**args, split_blocks=split)
        return pa.mixed_attention(**args, tier=tier)
    return pa.paged_attention(**args, tier=tier)


def mixed_schedule(args) -> str:
    """The host's schedule for the mixed kernel at ``args``'s shape."""
    B, T, H, _ = args["q"].shape
    n_sm = (torch.cuda.get_device_properties(0).multi_processor_count
            if torch.cuda.is_available() else 132)
    rows, split, n_split = pa.mixed_plan(B, T, H, args["k_pool"].shape[1],
                                         args["page_table"].shape[1], n_sm)
    return (f"{rows}-row tiles, " + (f"key walk split in {n_split} chunks "
            f"of {split} key blocks" if n_split > 1 else "unsplit"))


PER_TIER_SHAPES = (("decode", pa.PAGED_KERNEL), ("chunk", pa.MIXED_KERNEL),
                   ("verify", pa.MIXED_KERNEL))


def phase_per_tier_kernels(device) -> dict:
    """The decode and mixed kernels against their plain versions at the
    three per-tier shapes, rtol = atol = ATTN_TOL, every row (padding
    rows of the mixed shape included); a zero-length slot exact 0; a
    second run bit-identical. The mixed kernel runs both on the host's
    schedule (its key walk split where the grid would leave SMs idle)
    and unsplit. Returns the worst error per kernel."""
    worst: dict = {}
    for seed, (kind, name) in enumerate(PER_TIER_SHAPES):
        args = per_tier_mix(kind, 40 + seed, device)
        ref = per_tier_call(args, "ref")
        zero = ((args["seq_lens"] == 0).nonzero().flatten().tolist())
        for split in ((None, 0) if name == pa.MIXED_KERNEL else (None,)):
            out = per_tier_call(args, "kernel", split)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, rtol=ATTN_TOL,
                                       atol=ATTN_TOL)
            err = (out - ref).abs().max().item()
            worst[name] = max(worst.get(name, 0.0), err)
            if zero and out[zero].abs().max().item() != 0:
                raise AssertionError(f"{name} {kind}: a slot at seq_len 0 "
                                     "is not exact 0")
            if not torch.equal(per_tier_call(args, "kernel", split), out):
                raise AssertionError(f"{name} {kind}: two runs differ")
            how = ("" if name != pa.MIXED_KERNEL else
                   f" ({mixed_schedule(args)})" if split is None else
                   " (unsplit)")
            log(f"[kernel] {name} {kind} {list(args['q'].shape)}{how}: "
                f"max_abs_err vs plain {err:.3e} (tol {ATTN_TOL}), every row"
                + (", the seq_len-0 slot exact 0" if zero else "")
                + "; a second run bit-identical")
    return worst


def _code_steps(a, b):
    """Per-element distance in code steps of two code pools: int8 by
    value, e4m3 along the number line (sign-magnitude bytes)."""
    if a.dtype == torch.int8:
        return (a.to(torch.int32) - b.to(torch.int32)).abs()
    a = a.view(torch.uint8).to(torch.int32)
    b = b.view(torch.uint8).to(torch.int32)
    same = (a >> 7) == (b >> 7)
    return torch.where(same, ((a & 0x7F) - (b & 0x7F)).abs(),
                       (a & 0x7F) + (b & 0x7F))


def phase_step_float(device, params) -> None:
    """The float step: ``lm_ragged_step`` at full GPT-2-small width on the
    mix layout, through the kernel and through the plain attention, from
    identical float pools."""
    spec = GPT2_SMALL
    args, _, max_q, n_used = ragged_mix("mix", 2, device, spec)
    g = torch.Generator(device=device).manual_seed(3)
    shape = (spec.num_layers,) + tuple(args["k_pool"].shape)
    k_pool = torch.randn(shape, generator=g, device=device)
    v_pool = torch.randn(shape, generator=g, device=device)
    tokens = torch.randint(0, spec.vocab, (args["q"].shape[0],),
                           generator=g, device=device, dtype=torch.int32)
    outs = {}
    for tier in ("kernel", "ref"):
        kp, vp = k_pool.clone(), v_pool.clone()
        logits = lm_ragged_step(params, spec, tokens, args["q_starts"],
                                args["q_lens"], args["kv_lens"], kp, vp,
                                args["page_table"], attn_tier=tier,
                                max_q_len=max_q)
        torch.cuda.synchronize()
        outs[tier] = (logits[:n_used], kp, vp)
    (lk, kk, vk), (lr, kr, vr) = outs["kernel"], outs["ref"]
    if not torch.isfinite(lk).all():
        raise AssertionError("non-finite logits from the kernel step")
    torch.testing.assert_close(lk, lr, rtol=STEP_TOL, atol=STEP_TOL)
    # page 0 (the garbage page) takes every padding token's K/V, and a
    # scatter with duplicate indices keeps an arbitrary one: it is never
    # read unmasked, so only the real pages are compared
    torch.testing.assert_close(kk[:, 1:], kr[:, 1:], rtol=STEP_TOL,
                               atol=STEP_TOL)
    torch.testing.assert_close(vk[:, 1:], vr[:, 1:], rtol=STEP_TOL,
                               atol=STEP_TOL)
    log(f"[step] GPT-2-small float lm_ragged_step kernel vs plain: logits "
        f"max_abs_err={(lk - lr).abs().max().item():.3e} over {n_used} "
        f"tokens x {spec.vocab} (tol {STEP_TOL}), pools agree")


def phase_step_quant(device, params) -> dict:
    """``lm_ragged_step`` at GPT-3 XL widths, all 24 layers, int8 KV,
    int8 weights, split 16, on the mix layout over a pool already
    holding random int8 pages: once through the split-int8 kernel and
    once through the plain attention, from identical pools. Codes are
    held to one step with the flips counted, scales and logits to the
    stated tolerances."""
    spec = GPT3_XL
    quant = QuantConfig(kv="int8", weights="int8")
    args, _, max_q, n_used = ragged_mix("mix", 4, device, spec)
    g = torch.Generator(device=device).manual_seed(5)
    shape = (spec.num_layers,) + tuple(args["k_pool"].shape)
    k_pool, k_scale = quantize_kv(torch.randn(shape, generator=g,
                                              device=device), "int8")
    v_pool, v_scale = quantize_kv(torch.randn(shape, generator=g,
                                              device=device), "int8")
    tokens = torch.randint(0, spec.vocab, (args["q"].shape[0],),
                           generator=g, device=device, dtype=torch.int32)
    outs = {}
    for tier in ("kernel", "ref"):
        pools = [t.clone() for t in (k_pool, v_pool, k_scale, v_scale)]
        logits = lm_ragged_step(params, spec, tokens, args["q_starts"],
                                args["q_lens"], args["kv_lens"], pools[0],
                                pools[1], args["page_table"], attn_tier=tier,
                                max_q_len=max_q, k_scale=pools[2],
                                v_scale=pools[3], quant=quant,
                                kv_split_pages=SPLIT)
        torch.cuda.synchronize()
        outs[tier] = (logits[:n_used], pools)
    (lk, pk), (lr, pr) = outs["kernel"], outs["ref"]
    if not torch.isfinite(lk).all():
        raise AssertionError("non-finite logits from the kernel step")
    err = (lk - lr).abs().max().item()
    flips, scale_err = 0, 0.0
    written = 2 * n_used * spec.num_layers * spec.num_heads * spec.head_dim
    for i in (0, 1):       # real pages only (page 0 takes padding)
        steps = _code_steps(pk[i][:, 1:], pr[i][:, 1:])
        if steps.max().item() > 1:
            raise AssertionError("kernel and plain steps stored codes more "
                                 "than one step apart")
        flips += int((steps == 1).sum().item())
    for i in (2, 3):
        scale_err = max(scale_err,
                        (pk[i][:, 1:] - pr[i][:, 1:]).abs().max().item())
    log(f"[step] GPT-3 XL int8-KV int8-weight split-{SPLIT} lm_ragged_step, "
        f"{spec.num_layers} layers, kernel vs plain: logits max_abs_err="
        f"{err:.3e} over {n_used} tokens x {spec.vocab} (tol "
        f"{STEP_TOL}); codes within one step, {flips} of {written} "
        f"written codes one step apart; scales max_abs_err {scale_err:.3e}")
    if flips > MAX_FLIP_SHARE * written:
        raise AssertionError(f"{flips} code flips exceed "
                             f"{MAX_FLIP_SHARE:.0e} of {written}")
    torch.testing.assert_close(lk, lr, rtol=STEP_TOL, atol=STEP_TOL)
    torch.testing.assert_close(pk[2][:, 1:], pr[2][:, 1:], rtol=STEP_TOL,
                               atol=STEP_TOL)
    torch.testing.assert_close(pk[3][:, 1:], pr[3][:, 1:], rtol=STEP_TOL,
                               atol=STEP_TOL)
    return {"logits_max_abs_err": err, "code_flips": flips,
            "codes_written": written}


def requests_gpt2(seed: int, vocab: int = GPT2_SMALL.vocab):
    """The float path's traffic: eight requests, prompts from 17 to 900 tokens;
    the second and third share a 256-token prefix; six greedy and two
    sampled with fixed seeds."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda n: torch.randint(0, vocab, (n,),  # noqa: E731
                                   generator=g).tolist()
    shared = rand(256)
    prompts = [rand(900), shared + rand(44), shared + rand(131), rand(17),
               rand(600), rand(333), rand(64), rand(750)]
    return _with_sampling(prompts, (4, 6))


def requests_long(seed: int, vocab: int):
    """This slice's traffic: eight requests with prompts of 1000-1990
    tokens; the second and third share a 512-token prefix; six greedy
    and two sampled with fixed seeds."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda n: torch.randint(0, vocab, (n,),  # noqa: E731
                                   generator=g).tolist()
    shared = rand(512)
    prompts = [rand(1990), shared + rand(700), shared + rand(1100),
               rand(1000), rand(1500), rand(1234), rand(1750), rand(1024)]
    return _with_sampling(prompts, (3, 6))


def _with_sampling(prompts, sampled_idx):
    seeds = (1234, 5678)
    sampled = {i: SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                                 seed=s) for i, s in zip(sampled_idx, seeds)}
    return [(p, sampled.get(i)) for i, p in enumerate(prompts)]


def make_engine(model, quant=None, split=0, chunk=0, spec_tokens=0,
                async_depth=0, cuda_graphs=None, swap_pages=None):
    """The smoke's serving engine: SLOTS slots, PAGE-token pages, a pool
    that holds every slot's whole context. ``cuda_graphs=None`` takes
    the engine's default (on, on the card); ``swap_pages=None`` the
    cache's."""
    spec = model.spec
    pps = -(-spec.max_seq_len // PAGE)
    swap = {} if swap_pages is None else {"swap_pages": swap_pages}
    return GenerationEngine(
        model,
        cache_config=CacheConfig(
            num_layers=spec.num_layers, num_heads=spec.num_heads,
            head_dim=spec.head_dim, num_pages=SLOTS * pps + 1,
            page_size=PAGE, max_slots=SLOTS, max_seq_len=spec.max_seq_len,
            **swap),
        scheduler_config=SchedulerConfig(max_slots=SLOTS,
                                         max_seq_len=spec.max_seq_len,
                                         chunk_tokens=chunk,
                                         kv_split_pages=split,
                                         spec_tokens=spec_tokens,
                                         async_depth=async_depth),
        quant=quant, device=model.device, cuda_graphs=cuda_graphs)


def assert_no_faults(engine, label: str) -> None:
    """A phase that injects no fault: no retry of the device-fault
    boundary and no ``device_fault`` termination, so a failing kernel
    cannot hide behind the retry."""
    st = engine.scheduler.stats
    if any(engine.fault_retries.values()) or st["n_device_faults"]:
        raise AssertionError(f"{label}: device-fault retries "
                             f"{engine.fault_retries}, "
                             f"{st['n_device_faults']} device_fault "
                             "terminations in a phase that injects none")


def serve(engine, requests, tenants=("default",)):
    """Submit ``requests`` (tenants taken in turn) and run the engine
    dry; returns (outputs, wall seconds from the first step to the
    device's last work)."""
    rids = [engine.submit(p, NEW_TOKENS, sp, tenant=tenants[i % len(tenants)])
            for i, (p, sp) in enumerate(requests)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    return [engine.output_of(r) for r in rids], time.perf_counter() - t0


def run_engine(model, requests, quant=None, split=0, chunk=0, spec_tokens=0):
    engine = make_engine(model, quant, split, chunk, spec_tokens)
    outputs, wall = serve(engine, requests)
    return engine, outputs, wall


def drive_path(label, model, requests, kernel, quant=None, split=0, chunk=0,
               min_prefix_pages=0, rerun=False, spec_tokens=0):
    """One engine path: launch counts reset just before the run and read
    just after. Every request must deliver NEW_TOKENS tokens, ``kernel``
    must have launched exactly layers x steps times and no other
    attention kernel at all, the prefix cache must have served the
    shared prefix, and the cache must end with its invariants holding
    and every page free. ``rerun`` runs the same traffic again and
    requires identical tokens. Returns (launches, ms per step, the
    engine, the outputs)."""
    pa.LAUNCHES.clear()
    engine, outputs, wall = run_engine(model, requests, quant, split, chunk,
                                       spec_tokens)
    launches = dict(pa.LAUNCHES)
    steps = engine.steps_dispatched
    by_step = launches_by_step(engine)
    for (prompt, _), out in zip(requests, outputs):
        if len(out) != NEW_TOKENS:
            raise AssertionError(f"{label}: a {len(prompt)}-token prompt "
                                 f"finished with {len(out)} tokens")
    want = {kernel: model.spec.num_layers * steps}
    if launches != want:
        raise AssertionError(f"{label}: attention launches {launches}, "
                             f"expected {want} (layers x steps)")
    if sum(by_step.values()) != launches[kernel]:
        raise AssertionError(f"{label}: launches by step class {by_step} "
                             f"do not add up to {launches[kernel]}")
    LAUNCHES_BY_STEP[label] = {"kernel": kernel, "decode": by_step["decode"],
                               "mix": by_step["mix"]}
    if engine.cache.prefix_hits < min_prefix_pages:
        raise AssertionError(f"{label}: the prefix cache served "
                             f"{engine.cache.prefix_hits} pages, fewer than "
                             f"the {min_prefix_pages} of the shared prefix")
    engine.cache.check_invariants()
    if engine.cache.pages_in_use:
        raise AssertionError(f"{label}: {engine.cache.pages_in_use} pages "
                             "still mapped after every request finished")
    assert_no_faults(engine, label)
    n_tok = sum(len(o) for o in outputs)
    ms_step = 1e3 * wall / steps
    log(f"[engine] {label}: {len(outputs)} requests x {NEW_TOKENS} tokens in "
        f"{steps} steps, {wall:.3f}s: {n_tok / wall:.1f} tokens/s, "
        f"{ms_step:.2f} ms/step; {kernel} launches {want[kernel]} = "
        f"layers x steps ({by_step['decode']} in decode-only steps, "
        f"{by_step['mix']} in steps with a chunk or prefix row), no other "
        f"attention kernel; prefix-cache hits {engine.cache.prefix_hits} "
        "pages")
    if rerun:
        _, again, wall2 = run_engine(model, requests, quant, split, chunk,
                                     spec_tokens)
        if again != outputs:
            raise AssertionError(f"{label}: a second identical run gave "
                                 "other tokens")
        ms_step = 1e3 * wall2 / steps
        log(f"[engine] {label}: rerun identical; {n_tok / wall2:.1f} "
            f"tokens/s, {ms_step:.2f} ms/step (warm)")
    return launches, ms_step, engine, outputs


def launches_by_step(engine) -> dict:
    """The ragged kernels' launches on an engine path by step class, one
    a layer per step: "decode" for steps whose rows are all of at most
    DECODE_MAX_Q queries (the tile kernel does not launch), "mix" for
    steps with a chunk, a prefix hit or drafts. From the engine's count
    of steps by class, since a CUDA-graph replay runs no Python."""
    layers = engine.model.spec.num_layers
    return {k: layers * engine.steps_by_class.get(k, 0)
            for k in ("decode", "mix")}


def log_split_agreement(label, requests, outs) -> None:
    """Log how many greedy requests gave the same tokens with the KV split
    on and off (``outs``: split pages -> outputs). Not a check: the two
    schedules sum in other orders, and a near-tie among the top logits may
    fall either way."""
    greedy = [i for i, (_, sp) in enumerate(requests) if sp is None]
    same = sum(outs[0][i] == outs[SPLIT][i] for i in greedy)
    log(f"[engine] {label}: greedy tokens equal with the split on and off "
        f"for {same} of {len(greedy)} requests")


def requests_spec():
    """The speculative path's traffic: the float path's eight requests
    plus four prompts that repeat a 24-token motif (96 to 588 tokens,
    one over a chunk), greedy, so that n-gram drafts are proposed and
    accepted."""
    g = torch.Generator().manual_seed(99)
    rand = lambda n: torch.randint(0, GPT2_SMALL.vocab, (n,),  # noqa: E731
                                   generator=g).tolist()
    motif = rand(24)
    prompts = [motif * 4, rand(40) + motif * 6, motif * 10,
               rand(300) + motif * 12]
    return requests_gpt2(7) + [(p, None) for p in prompts]


def decision_scores(logits, sp, index: int):
    """The scores, one per token id, whose first argmax is the engine's
    sampler's decision for output token ``index`` from one row of
    logits. Greedy: the logits. Sampled: the temperature-scaled logits,
    top-k / top-p masked to -inf on their stable descending sort, plus
    the Gumbel noise of the key fold_in(PRNGKey(seed), index) at each
    token's rank. A sampled request's ``seed`` must be the one it was
    served with (``served_sampling``), never None."""
    if sp is None or sp.temperature <= 0:
        return logits.float()
    if sp.seed is None:
        raise ValueError("a sampled decision needs the seed the request "
                         "was served with; seed=None was never used")
    scaled = logits.float() / max(sp.temperature, 1e-6)
    order = torch.argsort(-scaled, stable=True)
    s = scaled[order]
    V = s.shape[0]
    rank = torch.arange(V, device=s.device)
    keep = rank < (V if sp.top_k <= 0 else sp.top_k)
    p = torch.softmax(s, dim=-1)
    keep &= (torch.cumsum(p, dim=-1) - p) < sp.top_p
    keep[0] = True
    masked = torch.where(keep, s, torch.full_like(s, -torch.inf))
    key = fold_in(prng_key(torch.tensor([sp.seed], dtype=torch.int32,
                                        device=s.device)),
                  torch.tensor([index], dtype=torch.int32, device=s.device))
    ranked = masked + gumbel(key, V)[0]
    return torch.empty_like(ranked).scatter_(0, order, ranked)


def score_scale(sp) -> float:
    """How far the sampler's scores move per unit of logits: 1 greedy,
    1 / temperature sampled."""
    if sp is None or sp.temperature <= 0:
        return 1.0
    return 1.0 / max(sp.temperature, 1e-6)


def decision_gap(logits, sp, index: int) -> float:
    """The margin of the sampler's decision for output token ``index``
    from one row of logits: the gap between the two best candidates'
    scores (``decision_scores``)."""
    top = decision_scores(logits, sp, index).topk(2).values
    return (top[0] - top[1]).item()


def phase_spec_engine(model, requests):
    """The engine with speculative decoding on (spec_tokens 4) and off,
    same traffic: ragged launches layers x steps in each run, drafts
    proposed and accepted with it on, every request 32 tokens, no page
    left mapped; each run is repeated (identical tokens) and its warm
    rerun timed. Returns (launches of the spec-on run, its outputs, the
    first index where each request's spec-on and spec-off tokens differ
    (None where equal))."""
    name = pa.kernel_name(torch.float32, False)
    runs = {}
    for spec_tokens in (SPEC_TOKENS, 0):
        runs[spec_tokens] = drive_path(
            f"GPT-2-small float, spec_tokens {spec_tokens}", model, requests,
            name, chunk=CHUNK, min_prefix_pages=256 // PAGE,
            spec_tokens=spec_tokens, rerun=True)
    launches, ms_on, engine, on = runs[SPEC_TOKENS]
    _, ms_off, engine_off, off = runs[0]
    st = engine.scheduler.stats
    if not st["n_spec_drafted"] or not st["n_spec_accepted"]:
        raise AssertionError(f"speculative run drafted "
                             f"{st['n_spec_drafted']} and accepted "
                             f"{st['n_spec_accepted']} tokens: not driven")
    diverge = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                    None) for x, y in zip(on, off)]
    log(f"[spec] engine spec_tokens {SPEC_TOKENS}: {st['n_spec_steps']} "
        f"verify steps, {st['n_spec_slot_steps']} slot-steps, drafted "
        f"{st['n_spec_drafted']}, accepted {st['n_spec_accepted']} "
        f"({st['n_spec_accepted'] / st['n_spec_drafted']:.3f}), emitted "
        f"{st['n_spec_emitted']}; warm ms/step on {ms_on:.2f} over "
        f"{engine.steps_dispatched} steps, off {ms_off:.2f} over "
        f"{engine_off.steps_dispatched}; requests whose tokens differ with "
        f"it off: "
        f"{sum(d is not None for d in diverge)} (checked for near-ties in "
        "the per-tier phase)")
    return launches, on, diverge


def _single_slot_cache(spec, n_tokens, device):
    pps = -(-spec.max_seq_len // PAGE)
    cache = PagedKVCache(CacheConfig(
        num_layers=spec.num_layers, num_heads=spec.num_heads,
        head_dim=spec.head_dim, num_pages=pps + 1, page_size=PAGE,
        max_slots=1, max_seq_len=spec.max_seq_len), device=device)
    if not cache.allocate(0, n_tokens):
        raise AssertionError("a single-slot cache refused its request")
    return cache


def per_tier_request(model, prompt, teacher, sp, counts, gap_at):
    """One request through the per-tier graphs, teacher-forced on the
    engine's tokens ``teacher``, in lockstep on two single-slot caches:
    the kernels (``attn_tier="kernel"``) and the plain attention
    (``"ref"``). The prompt goes in 512-token ``lm_chunk_prefill``
    chunks; then each step runs ``lm_verify`` on the pending token and
    its n-gram drafts when there are any, else ``lm_decode``, and
    advances by the drafts the teacher agrees with plus one. Every valid
    logits row of the two routes must agree within STEP_TOL. For a
    greedy request each row's argmax must be the teacher's token (the
    loop running free would emit the same tokens) unless the decision is
    a near-tie, which is counted and ends the token comparison. Returns
    the worst logits difference, the near-tie count and the decision
    gap of output index ``gap_at`` (None when not asked)."""
    spec, dev = model.spec, model.device
    caches = {t: _single_slot_cache(spec, len(prompt) + len(teacher), dev)
              for t in ("kernel", "ref")}
    row = torch.from_numpy(caches["kernel"].page_table[0].copy()).to(dev)
    table = row[None]
    state = {"err": 0.0, "ties": 0, "stop": sp is not None, "gap": None}

    def check(lk, lr, rows, first_index):
        """Logits of both routes on every row; then rows ``rows`` of the
        kernel route predict output tokens ``first_index``, ..."""
        if not torch.isfinite(lk).all():
            raise AssertionError("non-finite per-tier logits")
        torch.testing.assert_close(lk, lr, rtol=STEP_TOL, atol=STEP_TOL)
        state["err"] = max(state["err"], (lk - lr).abs().max().item())
        for index, i in enumerate(rows, first_index):
            if index == gap_at:
                state["gap"] = decision_gap(lk[i], sp, index)
            if state["stop"]:
                continue
            if int(lk[i].argmax()) != teacher[index]:
                gap = decision_gap(lk[i], sp, index)
                if gap >= NEAR_TIE:
                    raise AssertionError(
                        f"per-tier greedy token {index} differs from the "
                        f"engine's with a decision gap {gap:.3e}")
                state["ties"] += 1
                state["stop"] = True

    P = len(prompt)
    i32 = dict(dtype=torch.int32, device=dev)
    for start in range(0, P, CHUNK):
        n = min(CHUNK, P - start)
        toks = torch.zeros(CHUNK, **i32)
        toks[:n] = torch.tensor(prompt[start:start + n], **i32)
        lk, lr = [lm_chunk_prefill(model.params, spec, toks, start, n,
                                   caches[t].k_pool, caches[t].v_pool, row,
                                   attn_tier=t) for t in ("kernel", "ref")]
        counts["chunks"] += 1
        check(lk[:n], lr[:n], [n - 1] if start + n == P else [], 0)
    out, seq = [teacher[0]], P
    while len(out) < len(teacher):
        draft = ngram_draft(np.asarray(prompt + out, np.int32),
                            min(SPEC_TOKENS, len(teacher) - len(out) - 1))
        if draft:
            T = 1 + len(draft)
            tokens = torch.tensor([[out[-1]] + draft], **i32)
            lk, lr = [lm_verify(model.params, spec, tokens,
                                torch.tensor([seq], **i32),
                                torch.tensor([T], **i32), caches[t].k_pool,
                                caches[t].v_pool, table, attn_tier=t)[0]
                      for t in ("kernel", "ref")]
            acc = 0
            while acc < len(draft) and draft[acc] == teacher[len(out) + acc]:
                acc += 1
            check(lk, lr, range(acc + 1), len(out))
            counts["verify"] += 1
        else:
            acc = 0
            lk, lr = [lm_decode(model.params, spec,
                                torch.tensor([out[-1]], **i32),
                                torch.tensor([seq], **i32), caches[t].k_pool,
                                caches[t].v_pool, table, attn_tier=t)
                      for t in ("kernel", "ref")]
            check(lk, lr, [0], len(out))
            counts["decode"] += 1
        seq += acc + 1
        out += teacher[len(out):len(out) + acc + 1]
    return state["err"], state["ties"], state["gap"]


def phase_per_tier(model, requests, teacher, diverge) -> dict:
    """The per-tier path: every request of the speculative traffic
    through :func:`per_tier_request`, launch counts reset just before
    and read just after: the mixed kernel must have launched layers x
    (chunks + verify steps), the decode kernel layers x decode steps,
    and no other attention kernel. Then each request whose tokens
    differed between the spec-on and spec-off engine runs must differ at
    a near-tie. Returns the launches."""
    counts = {"chunks": 0, "verify": 0, "decode": 0}
    err, ties, gaps = 0.0, 0, []
    pa.LAUNCHES.clear()
    t0 = time.perf_counter()
    for (prompt, sp), out, j in zip(requests, teacher, diverge):
        e, t, gap = per_tier_request(model, prompt, out, sp, counts, j)
        err, ties = max(err, e), ties + t
        if j is not None:
            gaps.append(gap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.LAUNCHES)
    L = model.spec.num_layers
    want = {pa.MIXED_KERNEL: L * (counts["chunks"] + counts["verify"]),
            pa.PAGED_KERNEL: L * counts["decode"]}
    if launches != want:
        raise AssertionError(f"per-tier launches {launches}, expected "
                             f"{want} = layers x (chunks + verify steps) "
                             "and layers x decode steps")
    log(f"[per-tier] {len(requests)} requests teacher-forced on the spec "
        f"engine's tokens: {counts['chunks']} chunks, {counts['verify']} "
        f"verify steps, {counts['decode']} decode steps in {wall:.3f}s "
        f"(kernel and plain routes in lockstep); logits kernel vs plain "
        f"max_abs_err {err:.3e} (tol {STEP_TOL}); greedy tokens equal the "
        f"engine's, near-ties (gap < {NEAR_TIE}) {ties}; launches "
        f"{launches} = layers x (chunks + verify), layers x decode, no "
        "other attention kernel")
    far = [g for g in gaps if g >= NEAR_TIE]
    log(f"[spec] spec on vs off: {len(gaps)} requests differ, each at a "
        f"decision gap of {[round(g, 7) for g in gaps]} (near-tie below "
        f"{NEAR_TIE}); the other {len(requests) - len(gaps)} equal")
    if far:
        raise AssertionError("spec on and off tokens differ beyond a "
                             f"near-tie: gaps {far}")
    return launches


def log_device_profile(prof, label: str, wall: float, steps: int,
                       top: int, group=None) -> None:
    """Print the device's busy share of ``wall`` and the ``top`` device
    operations by time per step, from a finished ``torch.profiler``
    run over ``steps`` steps; ``group`` = (name, substrings) also prints
    the summed time and share of the operations whose names hold one of
    the substrings."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only (kernels, copies, memsets): the host ops
    # that launched them report the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in events)
    if total == 0:
        log("[profile] the profiler recorded no device time: device busy "
            "share not measured")
        return
    log(f"[profile] {label}, {steps} steps, wall {wall:.3f}s with the "
        f"profiler on; device busy {total / 1e6:.3f}s = "
        f"{100 * total / 1e6 / wall:.1f}% of wall; "
        f"{total / 1e3 / steps:.3f} ms device per step")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(f"[profile]   {dev_us(e) / 1e3 / steps:8.4f} ms/step "
            f"{100 * dev_us(e) / total:5.1f}%  x{e.count:<6d} {e.key[:90]}")
    if group is not None:
        name, keys = group
        part = sum(dev_us(e) for e in events
                   if any(k in e.key for k in keys))
        log(f"[profile] {name}: {part / 1e3 / steps:.4f} ms/step, "
            f"{100 * part / total:.1f}% of device time")


def _device_busy(prof):
    """Device time (ms) a finished ``torch.profiler`` run recorded:
    kernels, copies and memsets, graph replays' kernels included."""
    from torch.autograd import DeviceType
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def device_busy_s(engine, commits: int, label: str) -> float:
    """The device time of an engine's committed steps since its last
    ``reset_step_profile``: the sum of the step profiler's CUDA-event
    spans around each step (net of the gaps between steps), every
    committed step counted. Fails unless the profiler is on and timed
    exactly ``commits`` steps."""
    summ = engine.stepprof.summary()
    if not (engine.stepprof.enabled and engine.obs_registry.enabled):
        raise AssertionError(f"{label}: the step profiler is off "
                             "(PD_OBS_DISABLED or PD_OBS_STEPPROF=0)")
    if summ["device_busy_steps"] != commits:
        raise AssertionError(f"{label}: the step profiler timed "
                             f"{summ['device_busy_steps']} steps of "
                             f"{commits} committed")
    return summ["device_busy_s"]


def phase_async_serving(model, batches=None) -> list:
    """The quantized long-context path (int8 KV and weights, the KV
    split of SPLIT pages, CHUNK-token chunks) through the async pipeline
    at each of ASYNC_DEPTHS, with CUDA graphs off and then on: six
    engines. Each serves three batches of traffic (by default
    ``requests_long`` with seeds 11, 13 and 17): a warm one (the first
    step of each signature captures its graph), a timed one (launches
    reset before it) and one under ``torch.profiler``. All six must give the same tokens in every
    batch; the timed batch must launch the split int8 kernel layers x
    steps times and no other attention kernel, and no engine may need
    more step signatures (captured graphs) than its ``graph_bound``.
    Prints, for each engine, ms per step and tokens/s of the timed
    batch, its stream's busy share from the step profiler's CUDA events
    (the device's time in the steps, net of the gaps between them, over
    the batch's wall time), the profiled batch's device busy share, and
    peak device memory.
    The swap tier is off here (no preemption on this path), so the
    timed batch's evictions of the warm batch's parked pages copy
    nothing to the host."""
    from torch.profiler import ProfilerActivity, profile

    quant = QuantConfig(kv="int8", weights="int8")
    kernel = pa.kernel_name(torch.int8, True)
    layers = model.spec.num_layers
    if batches is None:
        batches = [requests_long(s, model.spec.vocab) for s in (11, 13, 17)]
    card = card_identity()
    want, rows = None, []
    for depth in ASYNC_DEPTHS:
        for graphs in (False, True):
            label = f"depth {depth}, graphs {'on' if graphs else 'off'}"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            engine = make_engine(model, quant, SPLIT, CHUNK,
                                 async_depth=depth, cuda_graphs=graphs,
                                 swap_pages=0)
            outs = [serve(engine, batches[0])[0]]
            steps0 = engine.steps_dispatched
            commits0 = engine.steps_committed
            classes0 = dict(engine.steps_by_class)
            graphs0 = engine.xla_compiles
            engine.reset_step_profile()
            pa.LAUNCHES.clear()
            got, wall = serve(engine, batches[1])
            outs.append(got)
            steps = engine.steps_dispatched - steps0
            stream_ms = 1e3 * device_busy_s(
                engine, engine.steps_committed - commits0, f"[async] {label}")
            launches = dict(pa.LAUNCHES)
            if launches != {kernel: layers * steps}:
                raise AssertionError(
                    f"[async] {label}: launches {launches}, expected "
                    f"{ {kernel: layers * steps} } (layers x steps)")
            by_class = {k: layers * (engine.steps_by_class.get(k, 0)
                                     - classes0.get(k, 0))
                        for k in ("decode", "mix")}
            if sum(by_class.values()) != launches[kernel]:
                raise AssertionError(f"[async] {label}: launches by step "
                                     f"class {by_class} do not add up")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                got, wall_prof = serve(engine, batches[2])
            outs.append(got)
            busy_ms = _device_busy(prof)
            if engine.xla_compiles > engine.graph_bound:
                raise AssertionError(
                    f"[async] {label}: {engine.xla_compiles} step "
                    f"signatures, above the bound {engine.graph_bound}")
            captured = sum(g is not None for g in engine._graphs.values())
            if captured != (engine.xla_compiles if engine.cuda_graphs
                            else 0):
                raise AssertionError(f"[async] {label}: {captured} graphs "
                                     f"for {engine.xla_compiles} signatures")
            engine.cache.check_invariants()
            if engine.cache.pages_in_use or engine.pipeline_depth:
                raise AssertionError(f"[async] {label}: pages or steps "
                                     "left in flight")
            assert_no_faults(engine, f"[async] {label}")
            if want is None:
                want = outs
            elif outs != want:
                raise AssertionError(f"[async] {label}: tokens differ from "
                                     "depth 0 with graphs off")
            n_tok = sum(len(o) for o in outs[1])
            row = {"depth": depth, "graphs": graphs, "steps": steps,
                   "ms_per_step": 1e3 * wall / steps,
                   "tokens_per_s": n_tok / wall,
                   "stream_busy": stream_ms / (1e3 * wall),
                   "device_busy": (busy_ms / (1e3 * wall_prof)
                                   if busy_ms else None),
                   "graphs_captured": captured,
                   "signatures": engine.xla_compiles,
                   "graph_bound": engine.graph_bound,
                   "graphs_in_timed_batch": engine.xla_compiles - graphs0,
                   "peak_alloc_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "peak_reserved_gib":
                       torch.cuda.max_memory_reserved() / 2**30,
                   "rollbacks": engine.async_rollbacks,
                   "occupancy": list(engine.occupancy_hist)}
            rows.append(row)
            busy = ("not measured (the profiler recorded no device time)"
                    if row["device_busy"] is None
                    else f"{100 * row['device_busy']:.1f}%")
            log(f"[async] {label}: {steps} steps, {wall:.3f}s: "
                f"{row['ms_per_step']:.2f} ms/step, "
                f"{row['tokens_per_s']:.1f} tokens/s; stream busy "
                f"{100 * row['stream_busy']:.1f}% (the step profiler's CUDA "
                f"events), device busy {busy} (profiled batch, "
                f"{wall_prof:.3f}s); {captured} graphs captured, "
                f"{engine.xla_compiles} signatures <= bound "
                f"{engine.graph_bound} ({row['graphs_in_timed_batch']} new "
                f"in the timed batch); {kernel} launches "
                f"{launches[kernel]} = layers x steps ({by_class['decode']} "
                f"decode-only, {by_class['mix']} mix); peak "
                f"{row['peak_alloc_gib']:.2f} GiB allocated, "
                f"{row['peak_reserved_gib']:.2f} GiB reserved; "
                f"occupancy {row['occupancy']}; {card}")
            del engine, prof
    log(f"[async] the {len(rows)} runs gave the same tokens in all "
        f"{len(batches)} batches ({card})")
    print(json.dumps({"async_serving": rows, "card": card}))
    ASYNC_TOKENS[:] = want
    return rows


def requests_contended(seed: int, vocab: int):
    """The preemption path's traffic (``phase_preempt_swap``), as
    (arrival step, prompt, new tokens, sampling, priority, tenant,
    deadline_s): five low-priority requests of tenant "bulk" and one of
    priority 1 with a total deadline it cannot meet at step 0, three
    priority-0 requests of two tenants at step PREEMPT_ARRIVAL; two
    bulk and one vip request sampled."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda n: torch.randint(0, vocab, (n,),  # noqa: E731
                                   generator=g).tolist()

    def sampled(s):
        return SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=s)

    reqs = [(0, rand(n), 48, sampled(300 + i) if i in (1, 3) else None, 2,
             "bulk", 0.0) for i, n in enumerate((700, 520, 610, 450, 380))]
    reqs.append((0, rand(96), 600, None, 1, "mid", PREEMPT_DEADLINE_S))
    reqs += [(PREEMPT_ARRIVAL, rand(n), 24, sampled(400) if i == 1 else None,
              0, f"vip{i % 2}", 0.0) for i, n in enumerate((480, 600, 500))]
    return reqs


def compare_with_ties(model, label, prompts, samplings, got, want) -> int:
    """Each request's tokens ``got`` against ``want``: equal, or the
    first differing token a near-tie (the sampler's decision gap, from a
    dense prefill of the common context, below NEAR_TIE), which ends the
    comparison of that request. Raises otherwise; returns the
    near-ties."""
    ties = 0
    for prompt, sp, a, b in zip(prompts, samplings, got, want):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            if len(a) != len(b):
                raise AssertionError(f"{label}: {len(a)} tokens, the "
                                     f"reference {len(b)}")
            continue
        ctx = torch.tensor([prompt + b[:j]], dtype=torch.int32,
                           device=model.device)
        logits = lm_prefill(model.params, model.spec, ctx)[0][0, -1]
        gap = decision_gap(logits, sp, j)
        if gap >= NEAR_TIE:
            raise AssertionError(f"{label}: token {j} of a "
                                 f"{len(prompt)}-token prompt differs from "
                                 f"the reference with a decision gap "
                                 f"{gap:.3e}")
        ties += 1
    return ties


def phase_preempt_swap(model) -> dict:
    """Priority admission with preemption, tenant quotas, deadlines and
    the host swap tier at GPT-2-small widths (float32 pages), async
    depth 1, CUDA graphs on (the engine's default on the card): the
    ``requests_contended`` traffic on a pool of PREEMPT_PAGES usable
    pages, too small for every request at once, tenant "bulk" held to
    PREEMPT_TENANT_SLOTS slots. The priority-0 arrivals must preempt
    (swapping pages out and back in), the quota must defer, the
    priority-1 request must time out, and every other request's tokens
    must equal its uncontended run (all of them at priority 0 on a pool
    that holds every slot's whole context), outside counted near-ties;
    the ragged kernel launches layers x steps, and the cache ends with
    its invariants holding and every page free."""
    spec = model.spec
    reqs = requests_contended(5, spec.vocab)
    kernel = pa.kernel_name(torch.float32, False)
    engine = GenerationEngine(
        model,
        cache_config=CacheConfig(
            num_layers=spec.num_layers, num_heads=spec.num_heads,
            head_dim=spec.head_dim, num_pages=PREEMPT_PAGES + 1,
            page_size=PAGE, max_slots=SLOTS, max_seq_len=spec.max_seq_len),
        scheduler_config=SchedulerConfig(
            max_slots=SLOTS, max_seq_len=spec.max_seq_len, chunk_tokens=CHUNK,
            async_depth=1, tenant_max_slots=PREEMPT_TENANT_SLOTS),
        device=model.device)
    pa.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids, step = [], 0
    for arrive, prompt, new, sp, prio, tenant, deadline in sorted(
            reqs, key=lambda r: r[0]):
        while step < arrive:
            engine.step()
            step += 1
        rids.append(engine.submit(prompt, new, sp, priority=prio,
                                  tenant=tenant, deadline_s=deadline))
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.LAUNCHES)
    steps = engine.steps_dispatched
    sch, cache = engine.scheduler, engine.cache
    if launches != {kernel: spec.num_layers * steps}:
        raise AssertionError(f"[preempt] launches {launches}, expected "
                             f"{spec.num_layers} x {steps}")
    reqs = sorted(reqs, key=lambda r: r[0])
    final = {r: sch.requests[r] for r in rids}
    timed_out = [r for r in rids if final[r].finish_reason == "timeout"]
    survivors = [i for i, r in enumerate(rids) if r not in timed_out]
    if [reqs[i][6] > 0 for i in range(len(rids))] != \
            [r in timed_out for r in rids]:
        raise AssertionError(f"[preempt] finish reasons "
                             f"{[final[r].finish_reason for r in rids]}: "
                             "the deadline request must time out, no "
                             "other")
    if any(final[rids[i]].finish_reason != "max_new_tokens"
           for i in survivors):
        raise AssertionError("[preempt] a survivor did not finish")
    st = sch.stats
    for name, n in (("preemptions", st["n_preemptions"]),
                    ("quota deferrals", st["n_quota_deferred"]),
                    ("pages swapped out", cache.swapped_out_pages),
                    ("pages swapped in", cache.swapped_in_pages)):
        if n <= 0:
            raise AssertionError(f"[preempt] no {name}: the path was not "
                                 "driven")
    cache.check_invariants()
    if cache.pages_in_use or cache.num_free_pages != PREEMPT_PAGES:
        raise AssertionError("[preempt] pages left mapped at the end")
    assert_no_faults(engine, "[preempt]")
    # the uncontended runs: every survivor at priority 0, all at once
    ref = make_engine(model, async_depth=1, chunk=CHUNK)
    ref_rids = [ref.submit(reqs[i][1], reqs[i][2], reqs[i][3])
                for i in survivors]
    ref.run()
    want = [ref.output_of(r) for r in ref_rids]
    got = [final[rids[i]].output for i in survivors]
    ties = compare_with_ties(model, "[preempt]",
                             [reqs[i][1] for i in survivors],
                             [reqs[i][3] for i in survivors], got, want)
    resumed = sum(final[r].preemptions > 0 for r in rids)
    captured = sum(g is not None for g in engine._graphs.values())
    log(f"[preempt] {len(rids)} requests in {steps} steps, {wall:.3f}s "
        f"(async depth 1, {captured} CUDA graphs captured): "
        f"{st['n_preemptions']} preemptions of {resumed} requests "
        f"({st['n_resumed']} resumed), {st['n_quota_deferred']} quota "
        f"deferrals, {len(timed_out)} timed out; swap out "
        f"{cache.swapped_out_pages} / in {cache.swapped_in_pages} pages "
        f"({cache.demoted_pages} demoted); {len(survivors)} survivors "
        f"equal to their uncontended runs outside {ties} near-ties; "
        f"{kernel} launches {launches[kernel]} = layers x steps; every "
        "page free, invariants hold")
    return {"preemptions": st["n_preemptions"], "ties": ties,
            "swapped_in": cache.swapped_in_pages}


def _phase_shares(records) -> float:
    """The largest gap between a step record's wall time and the sum of
    its phases, as a share of the wall time."""
    worst = 0.0
    for r in records:
        if r.dur > 0:
            worst = max(worst, abs(sum(r.phases.values()) - r.dur) / r.dur)
    return worst


def phase_observability(model, batches) -> dict:
    """Observability on the main path: the quantized long-context engine
    of ``phase_async_serving`` (int8 KV and weights, split SPLIT, chunk
    CHUNK) at async depth 1 with CUDA graphs, its warm batch and then its
    timed batch (tenants "a" and "b" in turn), once with observability on
    (the default: registry, recorder, SLO digest, step profiler, cost
    ledger) and once off (``obs.disable()`` and no ledger); then one more
    batch under ``torch.profiler`` with it on. Tokens must be identical
    on and off and equal to the async phase's. Checks: the step
    profiler has one record per committed step (no record commits more
    than one) whose phases sum to within PHASE_SUM_TOL of its wall time,
    the ledger's per-tenant sums equal its totals, its graph misses equal
    the engine's signatures within ``graph_bound``, and no retry or
    device fault happened. Prints ms/step on and off, the profiler's
    mean ms per phase, its event-timed device-idle share beside the
    profiler's busy share and the graphed path's device time by kernel,
    the SLO digest's percentiles, and the modelled bytes per step over
    the measured device time as a share of HBM_BYTES_PER_S."""
    from torch.profiler import ProfilerActivity, profile

    quant = QuantConfig(kv="int8", weights="int8")
    card = card_identity()
    tenants = ("a", "b")
    runs = {}
    for on in (True, False):
        if on:
            obs.enable()
        else:
            obs.disable()
        digest = obs.SLODigest()
        prev_digest = obs.set_default_slo_digest(digest)
        torch.cuda.empty_cache()
        engine = make_engine(model, quant, SPLIT, CHUNK, async_depth=1,
                             swap_pages=0)
        obs.set_default_slo_digest(prev_digest)
        if not on:
            engine.ledger = None
        warm, _ = serve(engine, batches[0], tenants)
        engine.reset_step_profile()
        digest.clear()
        led = engine.ledger
        led0 = ((led.total_hbm_bytes, led.total_flops, led.steps_accounted)
                if led is not None else None)
        steps0, commits0 = engine.steps_dispatched, engine.steps_committed
        got, wall = serve(engine, batches[1], tenants)
        steps = engine.steps_dispatched - steps0
        row = {"on": on, "steps": steps, "ms_per_step": 1e3 * wall / steps,
               "tokens": [warm, got]}
        if on:
            prof = engine.stepprof
            recs = prof.records()
            commits = engine.steps_committed - commits0
            if (sum(r.commits for r in recs) != commits
                    or max(r.commits for r in recs) > 1):
                raise AssertionError(
                    f"[obs] {len(recs)} step records hold "
                    f"{sum(r.commits for r in recs)} commits (at most one "
                    f"each) for {commits} committed steps")
            worst = _phase_shares(recs)
            if worst > PHASE_SUM_TOL:
                raise AssertionError(f"[obs] a step's phases miss "
                                     f"{100 * worst:.1f}% of its wall time")
            summ = prof.summary()
            row["phase_ms"] = {ph: 1e3 * v / len(recs)
                               for ph, v in sorted(summ["phase_s"].items())}
            row["idle_share"] = summ["idle_share"]
            row["device_ms_per_step"] = (
                1e3 * device_busy_s(engine, commits, "[obs]") / commits)
            row["slo"] = digest.snapshot()
            d_bytes = led.total_hbm_bytes - led0[0]
            d_flops = led.total_flops - led0[1]
            d_steps = led.steps_accounted - led0[2]
            row["bytes_per_step"] = d_bytes / d_steps
            row["flops_per_step"] = d_flops / d_steps
            row["hbm_share"] = (row["bytes_per_step"]
                                / (row["device_ms_per_step"] / 1e3)
                                / HBM_BYTES_PER_S)
            if (sum(led.tenant_hbm_bytes.values()) != led.total_hbm_bytes
                    or sum(led.tenant_flops.values()) != led.total_flops):
                raise AssertionError("[obs] per-tenant ledger sums differ "
                                     "from its totals")
            misses = sum(led.cache_misses.values())
            if misses != engine.xla_compiles or \
                    engine.xla_compiles > engine.graph_bound:
                raise AssertionError(
                    f"[obs] {misses} graph misses for "
                    f"{engine.xla_compiles} signatures (bound "
                    f"{engine.graph_bound})")
            row["captures"] = len(led.captures)
            row["capture_s"] = sum(c["compile_seconds"]
                                   for c in led.captures.values())
            row["signatures"] = engine.xla_compiles
            row["graph_bound"] = engine.graph_bound
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as tprof:
                got3, wall3 = serve(engine, batches[2], tenants)
            row["tokens"].append(got3)
            busy_ms = _device_busy(tprof)
            row["profiler_busy"] = (busy_ms / (1e3 * wall3)
                                    if busy_ms else None)
            log_device_profile(tprof, "graphed main path, async depth 1, "
                               "observability on", wall3,
                               engine.steps_dispatched - steps0 - steps, 16,
                               group=("ragged attention", ("ragged",)))
        else:
            if len(engine.stepprof) or engine.ledger is not None:
                raise AssertionError("[obs] the profiler or the ledger ran "
                                     "with observability off")
        assert_no_faults(engine, f"[obs] observability "
                         f"{'on' if on else 'off'}")
        engine.cache.check_invariants()
        runs[on] = row
        del engine
    obs.enable()
    on, off = runs[True], runs[False]
    if on["tokens"][:2] != off["tokens"]:
        raise AssertionError("[obs] tokens differ with observability on "
                             "and off")
    if ASYNC_TOKENS and on["tokens"] != ASYNC_TOKENS:
        raise AssertionError("[obs] tokens differ from the async phase's")
    over = on["ms_per_step"] - off["ms_per_step"]
    log(f"[obs] depth 1, graphs on, {on['steps']} steps: "
        f"{on['ms_per_step']:.3f} ms/step with observability on, "
        f"{off['ms_per_step']:.3f} off: overhead {over:+.3f} ms/step "
        f"({100 * over / off['ms_per_step']:+.2f}%); tokens identical on, "
        f"off and in the async phase; {card}")
    log("[obs] step profiler, mean ms per step: " + ", ".join(
        f"{ph} {ms:.4f}" for ph, ms in on["phase_ms"].items()))
    busy = ("not measured (the profiler recorded no device time)"
            if on["profiler_busy"] is None
            else f"{100 * on['profiler_busy']:.1f}%")
    log(f"[obs] device idle share {100 * on['idle_share']:.2f}% "
        f"(CUDA events around each step, timed batch); device busy {busy} "
        f"(torch.profiler, next batch); {on['device_ms_per_step']:.3f} "
        f"device ms per step")
    for metric, rows in sorted(on["slo"].items()):
        for r in rows:
            log(f"[obs] SLO {metric} tenant {r['tenant']} priority "
                f"{r['priority']}: n {r['count']}, p50 "
                f"{1e3 * r['p50']:.3f} ms, p99 {1e3 * r['p99']:.3f} ms")
    log(f"[obs] cost ledger: {on['bytes_per_step']:.0f} modelled bytes and "
        f"{on['flops_per_step']:.0f} FLOPs per step; bytes / measured "
        f"device time = {100 * on['hbm_share']:.1f}% of "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {on['captures']} graph "
        f"captures ({on['capture_s']:.3f} s) for {on['signatures']} "
        f"signatures, bound {on['graph_bound']}; {card}")
    out = {k: v for k, v in on.items() if k != "tokens"}
    out["ms_per_step_off"] = off["ms_per_step"]
    print(json.dumps({"observability": out, "card": card}))
    return out


class _RecordingInjector(FaultInjector):
    """A seeded injector that remembers the requests it poisoned."""

    def __init__(self, config):
        super().__init__(config)
        self.nan_rids = []

    def nan_row(self, rid=None):
        hit = super().nan_row(rid)
        if hit:
            self.nan_rids.append(rid)
        return hit


def _fault_engine(model, injector=None, journal=None, **sched):
    """The fault phase's engine (GPT-2-small widths, chunk CHUNK, async
    depth 1, graphs by default), built with ``injector`` as the process
    default fault injector (it binds at construction)."""
    prev = set_default_injector(injector or FaultInjector(FaultConfig()))
    try:
        spec = model.spec
        pps = -(-spec.max_seq_len // PAGE)
        return GenerationEngine(
            model,
            cache_config=CacheConfig(
                num_layers=spec.num_layers, num_heads=spec.num_heads,
                head_dim=spec.head_dim, num_pages=SLOTS * pps + 1,
                page_size=PAGE, max_slots=SLOTS,
                max_seq_len=spec.max_seq_len),
            scheduler_config=SchedulerConfig(
                max_slots=SLOTS, max_seq_len=spec.max_seq_len,
                chunk_tokens=CHUNK, async_depth=1, **sched),
            device=model.device, journal=journal)
    finally:
        set_default_injector(prev)


def _survivors_equal(model, label, requests, rids, engine, clean) -> tuple:
    """Requests of ``rids`` not ended ``device_fault`` against the clean
    run's tokens (counted near-ties allowed); returns (survivors,
    ties)."""
    sch = engine.scheduler
    keep = [i for i, r in enumerate(rids)
            if sch.requests[r].finish_reason != "device_fault"]
    for i in keep:
        if sch.requests[rids[i]].finish_reason != "max_new_tokens":
            raise AssertionError(f"{label}: a survivor ended "
                                 f"{sch.requests[rids[i]].finish_reason}")
    ties = compare_with_ties(model, label, [requests[i][0] for i in keep],
                             [requests[i][1] for i in keep],
                             [sch.requests[rids[i]].output for i in keep],
                             [clean[i] for i in keep])
    return keep, ties


def _check_pool(engine, label) -> None:
    engine.cache.check_invariants()
    if engine.cache.pages_in_use or engine.pipeline_depth:
        raise AssertionError(f"{label}: pages or steps left in flight")


def phase_faults_journal(model) -> dict:
    """The request journal, the device-fault boundary and brownout at
    GPT-2-small widths (float32 pages), async depth 1, graphs on, on
    the float path's traffic (``requests_gpt2``):

    1. a clean run; then the same requests journaled, the engine killed
       (``EngineKilled``) at step FAULT_KILL_STEP, the journal restored
       into a fresh engine: every request's tokens equal the clean
       run's;
    2. seeded NaN rows (FAULT_NAN): the poisoned requests end
       ``device_fault``, every other request equals the clean run, one
       retry per injected row, no page leaks;
    3. seeded dispatch faults (FAULT_DISPATCH): the same, one retry per
       injected fault, the faulted steps' requests ``device_fault``;
    4. overload: a queue of OVERLOAD_QUEUE and ``brownout_levels=4``
       under OVERLOAD_ARRIVALS submits a step: the ladder climbs to
       level 4 (shedding), every shed request and every ``Overloaded``
       rejection carries a retry-after above 0, and once the load stops
       the ladder descends to 0.
    The clean and restored runs inject nothing and must show no retry
    and no device fault."""
    import tempfile

    requests = requests_gpt2(7, model.spec.vocab)
    label = "[faults]"
    clean_eng = _fault_engine(model)
    clean, _ = serve(clean_eng, requests)
    assert_no_faults(clean_eng, f"{label} clean run")
    del clean_eng
    report = {}

    # 1. journal, kill, restore
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "requests.pdj")
        journal = RequestJournal(path)
        doomed = _fault_engine(model, FaultInjector(FaultConfig(
            kill_step=FAULT_KILL_STEP)), journal=journal)
        rids = [doomed.submit(p, NEW_TOKENS, sp) for p, sp in requests]
        steps = 0
        try:
            while True:
                doomed.step()
                steps += 1
        except EngineKilled:
            pass
        if steps != FAULT_KILL_STEP - 1:
            raise AssertionError(f"{label} the kill landed after {steps} "
                                 f"steps, not {FAULT_KILL_STEP - 1}")
        before = {r: list(doomed.scheduler.requests[r].output)
                  for r in rids}
        delivered = sum(len(o) for o in before.values())
        journal.close()
        del doomed
        fresh = _fault_engine(model)
        mapping = fresh.restore(path)
        fresh.run()
        if not mapping:
            raise AssertionError(f"{label} every request finished before "
                                 "the kill: nothing was restored")
        # a request that finished before the kill keeps its tokens
        restored = [fresh.scheduler.requests[mapping[r]].output
                    if r in mapping else before[r] for r in rids]
        ties = compare_with_ties(model, f"{label} restore",
                                 [p for p, _ in requests],
                                 [sp for _, sp in requests], restored, clean)
        assert_no_faults(fresh, f"{label} restore")
        _check_pool(fresh, f"{label} restore")
        report["restore"] = {"killed_at": FAULT_KILL_STEP,
                             "delivered_before": delivered,
                             "restored": len(mapping), "ties": ties}
        log(f"{label} journaled run killed at step {FAULT_KILL_STEP} "
            f"({delivered} tokens delivered), {len(mapping)} requests "
            f"restored into a fresh engine: "
            f"{'bit-exact with' if not ties else 'equal to'} the "
            f"uninterrupted run ({ties} near-ties); no retry, no device "
            "fault")
        del fresh

    # 2. NaN rows; 3. dispatch faults
    for kind, (rate, seed) in (("nan", FAULT_NAN),
                               ("dispatch", FAULT_DISPATCH)):
        cfg = (FaultConfig(nan_rate=rate, seed=seed) if kind == "nan"
               else FaultConfig(dispatch_rate=rate, seed=seed))
        inj = _RecordingInjector(cfg)
        # the engine's own flight recorder (bound at construction)
        rec = obs.FlightRecorder()
        prev_rec = obs.set_default_recorder(rec)
        engine = _fault_engine(model, inj)
        obs.set_default_recorder(prev_rec)
        got, _ = serve(engine, requests)
        sch = engine.scheduler
        injected = inj.counts.get(kind, 0)
        faulted = {r for r, req in sch.requests.items()
                   if req.finish_reason == "device_fault"}
        if not injected or not faulted:
            raise AssertionError(f"{label} {kind}: {injected} injected, "
                                 f"{len(faulted)} device faults: the path "
                                 "was not driven")
        if engine.fault_retries[kind] != injected:
            raise AssertionError(f"{label} {kind}: "
                                 f"{engine.fault_retries[kind]} retries "
                                 f"for {injected} injections")
        if kind == "nan":
            if faulted != set(inj.nan_rids):
                raise AssertionError(f"{label} nan: device_fault requests "
                                     f"{sorted(faulted)}, poisoned "
                                     f"{sorted(inj.nan_rids)}")
        else:
            steps_failed = [e for e in rec.snapshot()
                            if e.name == "device_fault_step"]
            if len(steps_failed) != injected:
                raise AssertionError(f"{label} dispatch: {len(steps_failed)}"
                                     f" steps quarantined for {injected} "
                                     "injections")
        rids = [r for r in sorted(sch.requests)]
        keep, ties = _survivors_equal(model, f"{label} {kind}", requests,
                                      rids, engine, clean)
        _check_pool(engine, f"{label} {kind}")
        if engine.cache.num_free_pages != engine.cache.config.num_pages - 1:
            raise AssertionError(f"{label} {kind}: pages leaked")
        report[kind] = {"injected": injected, "retries":
                        engine.fault_retries[kind],
                        "device_faults": len(faulted),
                        "survivors": len(keep), "ties": ties}
        log(f"{label} {kind} faults (rate {rate}, seed {seed}): {injected} "
            f"injected, {engine.fault_retries[kind]} retries recorded "
            f"(quarantined with no re-run at depth 1), {len(faulted)} "
            "requests ended device_fault; "
            f"{len(keep)} survivors equal to the clean run ({ties} "
            "near-ties); invariants hold, every page free")
        del engine

    # 4. overload and the brownout ladder
    engine = _fault_engine(model, max_queue=OVERLOAD_QUEUE,
                           brownout_levels=4)
    g = torch.Generator().manual_seed(3)
    levels, overloaded, rejected = [], [], 0
    for step in range(OVERLOAD_STEPS):
        for i in range(OVERLOAD_ARRIVALS):
            prompt = torch.randint(0, model.spec.vocab, (24 + 8 * i,),
                                   generator=g).tolist()
            try:
                engine.submit(prompt, 8, priority=2 if i else 1)
            except Overloaded as e:
                overloaded.append(e.retry_after_s)
            except QueueFull:
                rejected += 1
        engine.step()
        levels.append(engine.brownout.level)
    steps = 0
    while (engine.brownout.level > 0 or engine.scheduler.has_work
           or engine.pipeline_depth) and steps < OVERLOAD_CALM:
        engine.step()
        levels.append(engine.brownout.level)
        steps += 1
    sch = engine.scheduler
    shed = [r for r in sch.requests.values() if r.finish_reason == "shed"]
    if max(levels) != 4 or not (shed or overloaded):
        raise AssertionError(f"{label} overload: the ladder reached "
                             f"{max(levels)}, {len(shed)} shed, "
                             f"{len(overloaded)} Overloaded")
    if any(r.retry_after_s <= 0 for r in shed) or \
            any(v <= 0 for v in overloaded):
        raise AssertionError(f"{label} overload: a shed without a "
                             "retry-after")
    if engine.brownout.level != 0:
        raise AssertionError(f"{label} overload: the ladder stayed at "
                             f"{engine.brownout.level} after the load")
    _check_pool(engine, f"{label} overload")
    assert_no_faults(engine, f"{label} overload")
    up = levels.index(4)
    report["overload"] = {"top_level_at_step": up,
                          "transitions": engine.brownout.transitions,
                          "shed": len(shed), "overloaded": len(overloaded),
                          "queue_full": rejected,
                          "retry_after_s": [min(overloaded + [r.retry_after_s
                                                              for r in shed]),
                                            max(overloaded + [r.retry_after_s
                                                              for r in shed])],
                          "calm_steps": steps}
    log(f"{label} overload (queue {OVERLOAD_QUEUE}, {OVERLOAD_ARRIVALS} "
        f"submits a step for {OVERLOAD_STEPS} steps): the ladder reached "
        f"level 4 at step {up}, {engine.brownout.transitions} transitions; "
        f"{len(shed)} queued requests shed, {len(overloaded)} submits "
        f"Overloaded, {rejected} QueueFull; retry-after "
        f"{report['overload']['retry_after_s'][0]:.3f}-"
        f"{report['overload']['retry_after_s'][1]:.3f} s; back to level 0 "
        f"{steps} steps after the load stopped")
    print(json.dumps({"faults_journal": report}))
    return report


# ------------------------------------------------ the int8 weight matmul


def int8_inputs(M: int, K: int, N: int, seed: int, device):
    """Seeded activations ``[M, K]`` and the int8 codes of a ``[K, N]``
    weight (N(0, 0.02), per-output-channel absmax, as
    ``quantize_lm_weights``), their transposed ``[N, K]`` layout and
    their scales."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=device)
    w = 0.02 * torch.randn(K, N, generator=g, device=device)
    wq, ws = i8.quantize_absmax(w, axis=0)
    return x, wq, wq.t().contiguous(), ws


def int8_bounds(M: int, K: int, N: int) -> dict:
    """Least times (ms) of the int8 matmul and of the row quantizer at
    one shape: bytes (each input read once, each output written once)
    over HBM_BYTES_PER_S against operations over their peak (the
    product's 2 M N K on the int8 tensor cores, the quantizer's absmax,
    divide and round of each value at the float32 rate)."""
    mm = (M * K + K * N + 4 * (M + N + M * N)) / HBM_BYTES_PER_S, \
        2 * M * N * K / INT8_OPS_PER_S
    qr = (4 * M * K + M * K + 4 * M) / HBM_BYTES_PER_S, \
        3 * M * K / FP32_FLOPS_PER_S
    return {"bound_ms": max(mm) * 1e3,
            "bound_by": "bytes" if mm[0] >= mm[1] else "operations",
            "q_bound_ms": max(qr) * 1e3,
            "q_bound_by": "bytes" if qr[0] >= qr[1] else "operations"}


def phase_int8_matmul(device) -> dict:
    """The int8 weight matmul and its row quantizer against their plain
    versions at GPT-3 XL's four per-layer products (INT8_SHAPES) and M
    in INT8_ROWS: codes, scales and products bit-equal. Times each
    kernel and plain version beside the bounds, and ``torch._int_mm``
    (the int32 product alone, no rescale) where it takes the shape (M >
    16, K and N multiples of 8). Returns {(product, M): numbers}."""
    times = {}
    for si, (name, K, N) in enumerate(INT8_SHAPES):
        for M in INT8_ROWS:
            x, wq, wqt, ws = int8_inputs(M, K, N, 100 * si + M, device)
            xq, xs = i8.quantize_rows(x)
            rq, rs = i8.quantize_rows_ref(x)
            torch.cuda.synchronize()
            if not (torch.equal(xq, rq) and torch.equal(xs, rs)):
                raise AssertionError(f"[int8] quantize_rows {M}x{K}: codes "
                                     "or scales differ from the plain "
                                     "version")
            out = i8.int8_matmul(xq, xs, wqt, ws)
            ref = i8.int8_matmul_ref(xq, xs, wqt, ws)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"[int8] int8_matmul {name} M {M}: max_abs_err "
                    f"{(out - ref).abs().max().item():.3e}, not bit-equal")
            t = {"ms": time_cuda(lambda: i8.int8_matmul(xq, xs, wqt, ws)),
                 "plain_ms": time_cuda(
                     lambda: i8.int8_matmul_ref(xq, xs, wqt, ws), reps=5,
                     warmup=1),
                 "q_ms": time_cuda(lambda: i8.quantize_rows(x)),
                 "q_plain_ms": time_cuda(lambda: i8.quantize_rows_ref(x),
                                         reps=5, warmup=1),
                 "int_mm_ms": None, **int8_bounds(M, K, N)}
            if M > 16 and K % 8 == 0 and N % 8 == 0:
                t["int_mm_ms"] = time_cuda(lambda: torch._int_mm(xq, wq))
            times[(name, M)] = t
            lib = ("refused" if t["int_mm_ms"] is None
                   else f"{t['int_mm_ms']:.4f} ms")
            log(f"[int8] {name} [{M}, {K}] x [{K}, {N}]: bit-equal; "
                f"int8_matmul {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, "
                f"{t['bound_by']}), plain {t['plain_ms']:.4f}, "
                f"torch._int_mm {lib}; quantize_rows {t['q_ms']:.4f} ms "
                f"(bound {t['q_bound_ms']:.4f}), plain "
                f"{t['q_plain_ms']:.4f}")
            del x, wq, wqt, ws, xq, xs, rq, rs, out, ref
    return times


def int8_rows(times: dict, launches: dict) -> list:
    """The kernels line's rows of the int8 matmul and the row quantizer:
    headline numbers for one layer at the decode bucket (the four
    products at M = INT8_HEADLINE_M, summed), every shape beside them.
    Neither replaces a Pallas kernel (the JAX package leaves the product
    to XLA's dot_general), and no one PyTorch call computes either
    function (``torch._int_mm`` gives the int32 product without the
    rescale and refuses M <= 16): ``library_ms`` is null and the
    ``int_mm_ms`` of each shape stands beside it."""
    head = [times[(name, INT8_HEADLINE_M)] for name, _, _ in INT8_SHAPES]
    shapes = {f"{name}_m{M}": t for (name, M), t in times.items()}
    replaces = ("none (paddle_tpu/inference/llm/model.py:113 _int8_dot: "
                "lax.dot_general, no Pallas kernel)")
    rows = []
    for kernel, pre, by in ((i8.INT8_MATMUL_KERNEL, "", "bound_by"),
                            (i8.QUANTIZE_ROWS_KERNEL, "q_", "q_bound_by")):
        rows.append({
            "name": kernel, "route": "cuda", "source": INT8_SOURCE,
            "replaces": replaces, "launches": launches.get(kernel, 0),
            "max_abs_err": 0.0,
            "ms": sum(t[pre + "ms"] for t in head),
            "plain_ms": sum(t[pre + "plain_ms"] for t in head),
            "bound_ms": sum(t[pre + "bound_ms"] for t in head),
            "bound_by": head[0][by], "library_ms": None,
            "shape": f"one GPT-3 XL layer's four products at M "
                     f"{INT8_HEADLINE_M}",
            "shapes": {k: {key: v for key, v in t.items()
                           if key.startswith(pre) or (
                               not pre and not key.startswith("q_"))}
                       for k, t in shapes.items()}})
    return rows


def teacher_forced(model, prompt, quant):
    """Logits of ``prompt`` through ``lm_ragged_step`` on a fresh cache
    aligned to ``quant`` (the kernels on the card), the weights prepared
    as an engine prepares them: one prefill step of the whole prompt
    (the tile kernel's rows)."""
    spec = model.spec
    params = prepare_model(model, quant).params
    n = len(prompt)
    cc = align_cache_config(CacheConfig(
        num_layers=spec.num_layers, num_heads=spec.num_heads,
        head_dim=spec.head_dim, num_pages=-(-n // PAGE) + 1, page_size=PAGE,
        max_slots=1, max_seq_len=spec.max_seq_len, swap_pages=0), quant)
    cache = PagedKVCache(cc, device=model.device)
    if not cache.allocate(0, n):
        raise AssertionError("the teacher-forced cache refused the prompt")
    i32 = dict(dtype=torch.int32, device=model.device)
    table = torch.as_tensor(np.array(cache.page_table), **i32)

    with torch.no_grad():
        return lm_ragged_step(
            params, spec, torch.tensor(prompt, **i32), torch.zeros(1, **i32),
            torch.tensor([n], **i32), torch.tensor([n], **i32),
            cache.k_pool, cache.v_pool, table, max_q_len=n,
            k_scale=cache.k_scale, v_scale=cache.v_scale, quant=quant)


def pick_token(logits, sp, index: int) -> int:
    """The engine's sampler on one row of logits: output token
    ``index`` of a request served with sampling ``sp`` (greedy when
    None; a sampled request's resolved seed, never None)."""
    dev = logits.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    greedy = sp is None or sp.temperature <= 0
    if not greedy and sp.seed is None:
        raise ValueError("a sampled pick needs the seed the request was "
                         "served with; seed=None was never used")
    tok = _sample_traced(
        logits.reshape(1, -1).float(),
        torch.tensor([0 if greedy else sp.seed], **i32),
        torch.tensor([index], **i32),
        torch.tensor([0.0 if greedy else sp.temperature], **f32),
        torch.tensor([0 if greedy else sp.top_k], **i32),
        torch.tensor([1.0 if greedy else sp.top_p], **f32))
    return int(tok[0])


def served_sampling(target, rids) -> list:
    """The sampling each of ``rids`` was served with, ``seed=None``
    resolved to the seed the engine or fabric drew for it, from the
    target's own request records (a fabric follows migrations and
    handoffs)."""
    find = getattr(target, "find_request", None)
    if find is None:
        find = target.scheduler.requests.get
    return [find(r).sampling for r in rids]


def compare_routes(label, requests, got, want, routes) -> list:
    """Each request's tokens ``got`` against ``want``, where the two runs
    took different arithmetic routes (other scale dtypes): equal, or
    parted at a near-tie, which ends the comparison of that request.
    ``requests`` holds each request's prompt and the sampling it was
    served with (the seed the run drew, never None). ``routes(context)``
    gives the last row's logits of ``got``'s route and of ``want``'s
    route, teacher-forced on the common context (prompt and common
    tokens). The parting at token j is a near-tie when

    - both runs' tokens j score within a margin of the best candidate
      of ``got``'s route (``decision_scores``; the margin is the larger
      of NEAR_TIE and twice the largest difference between the two
      routes' logits there, in score units), or
    - the sampler on each route picks exactly the token its run emitted.

    Raises otherwise; returns the near-ties as (token, gap, difference,
    decided apart)."""
    ties = []
    for (prompt, sp), a, b in zip(requests, got, want):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            if len(a) != len(b):
                raise AssertionError(f"{label}: {len(a)} tokens, the "
                                     f"reference {len(b)}")
            continue
        la, lb = routes(prompt + b[:j])
        la, lb = la[-1], lb[-1]
        scores = decision_scores(la, sp, j)
        top = scores.topk(2).values
        gap = (top[0] - top[1]).item()
        delta = (la - lb).abs().max().item()
        margin = max(NEAR_TIE, 2 * delta * score_scale(sp))
        near = all(scores[t].item() >= top[0].item() - margin
                   for t in (a[j], b[j]))
        picks = (pick_token(la, sp, j), pick_token(lb, sp, j))
        apart = picks == (a[j], b[j])
        del la, lb, scores
        if not (near or apart):
            raise AssertionError(
                f"{label}: token {j} of a {len(prompt)}-token prompt is "
                f"{a[j]}, the reference's {b[j]}, with a decision gap "
                f"{gap:.3e} and the routes' logits {delta:.3e} apart: "
                f"not both within {margin:.3e} of the best, and the "
                f"routes pick {picks}")
        ties.append((j, gap, delta, apart))
    return ties


class LogitsTap:
    """The logits row behind every token the engines sample, recorded on
    the card inside each step (and so inside its CUDA graph): while the
    tap is entered, the engine's sampler is wrapped so that its input
    rows and their (seed, token index) keys are appended to a device
    ring of ``rows`` rows before it draws. Keys are unique per request
    and token, since every request is served with a seed of its own.
    The tap must outlive the engines that ran under it (their graphs
    write its ring)."""

    def __init__(self, vocab: int, device, rows: int = TAP_ROWS):
        self.rows = rows
        self.logits = torch.empty((rows, vocab), dtype=torch.float32,
                                  device=device)
        self.keys = torch.empty((rows, 2), dtype=torch.int64, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self._index = None

    def __enter__(self):
        self._real = engine_mod._sample_traced

        def sample(logits, seeds, positions, *rest):
            at = (self.count + torch.arange(
                logits.shape[0], device=logits.device)) % self.rows
            self.logits.index_copy_(0, at, logits.float())
            self.keys.index_copy_(0, at, torch.stack(
                (seeds.long(), positions.long()), dim=1))
            self.count += logits.shape[0]
            return self._real(logits, seeds, positions, *rest)

        engine_mod._sample_traced = sample
        return self

    def __exit__(self, *exc):
        engine_mod._sample_traced = self._real

    def row(self, seed: int, index: int):
        """The logits that output token ``index`` of the request served
        with ``seed`` was drawn from: the newest row of that key (a
        token drawn again, after a relocation or a discarded partial
        chunk, comes later in the ring)."""
        if self._index is None:
            n = int(self.count)
            if n > self.rows:
                raise AssertionError(f"the logits tap overflowed: {n} rows "
                                     f"sampled, {self.rows} kept")
            self._index = {tuple(k): i
                           for i, k in enumerate(self.keys[:n].tolist())}
        i = self._index.get((seed, index))
        if i is None:
            raise AssertionError(f"no tapped logits for token {index} of "
                                 f"the request with seed {seed}")
        return self.logits[i]


def check_tapped(label, requests, outputs, tap) -> None:
    """Every delivered token is the sampler's draw from the logits its
    run computed for it (``tap``): the tap is aligned with the outputs,
    and nothing rewrote a token after it was drawn."""
    for (prompt, sp), out in zip(requests, outputs):
        if sp.seed is None:
            raise ValueError("the tapped rows are keyed by the seed each "
                             "request was served with; seed=None was "
                             "never used")
        for j, tok in enumerate(out):
            drawn = pick_token(tap.row(sp.seed, j), sp, j)
            if drawn != tok:
                raise AssertionError(
                    f"{label}: token {j} of a {len(prompt)}-token prompt "
                    f"is {tok}, but its run's logits draw {drawn}")


def compare_tapped(label, requests, got, want, tap_got, tap_want) -> list:
    """Each request's tokens ``got`` against ``want`` from two runs that
    computed the same contexts along other schedules (rows re-prefilled,
    moved between replicas, decoded where the other prefilled), with
    the logits each run drew every token from (``check_tapped`` holds
    both runs to them): equal, or parted where the two runs' logits on
    the common context agree within the quantized-serving bar (mean
    absolute difference at most QUANT_MAE_MAX) and so differ only by
    arithmetic route; that ends the comparison of the request. A parting
    whose logits disagree beyond the bar fails. ``requests`` holds each
    prompt with the sampling it was served with (``served_sampling``).
    Returns the partings as (token, decision gap of ``got``'s logits,
    largest and mean logit difference)."""
    check_tapped(label, requests, got, tap_got)
    check_tapped(label + " (reference)", requests, want, tap_want)
    ties = []
    for (prompt, sp), a, b in zip(requests, got, want):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            if len(a) != len(b):
                raise AssertionError(f"{label}: {len(a)} tokens, the "
                                     f"reference {len(b)}")
            continue
        la, lb = tap_got.row(sp.seed, j), tap_want.row(sp.seed, j)
        diff = (la - lb).abs()
        delta, mae = diff.max().item(), diff.mean().item()
        if mae > QUANT_MAE_MAX:
            raise AssertionError(
                f"{label}: token {j} of a {len(prompt)}-token prompt is "
                f"{a[j]}, the reference's {b[j]}, drawn from logits "
                f"{mae:.3e} apart on average (largest {delta:.3e}; bar "
                f"{QUANT_MAE_MAX}): not the same context")
        ties.append((j, decision_gap(la, sp, j), delta, mae))
    return ties


def _share(prof, keys) -> float:
    """Share of a finished ``torch.profiler`` run's device time spent in
    operations whose names hold one of ``keys``."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in events)
    part = sum(dev_us(e) for e in events if any(k in e.key for k in keys))
    return part / total if total else None


# device kernels of the float32 GEMMs (cuBLAS, CUTLASS, gemv), of the
# int8 matmul, and the elementwise multiplies (with weight_matmul off,
# the int8 weights' dequantization in front of each GEMM)
GEMM_KEYS = ("gemm", "gemv", "xmma", "cutlass", "sm90_", "Kernel2")
INT8_KEYS = ("int8_matmul_kernel", "quantize_rows_kernel")
DEQUANT_KEYS = ("MulFunctor",)


def phase_weight_matmul(model, batches) -> dict:
    """The int8 long-context path (GPT-3 XL, full depth, int8 KV and int8
    weights, split SPLIT, chunk CHUNK, async depth 1, graphs on, the
    ``requests_long`` batches) with ``weight_matmul`` off and then int8.
    Each engine serves a warm batch, a timed batch (ms/step; device time
    from the step profiler's events) and a batch under
    ``torch.profiler`` (device time in float32 GEMMs, in the int8 kernels
    and in elementwise multiplies). The int8 run's launches are counted
    over its timed batch: the int8 matmul and the quantizer four times a
    layer a step, the ragged kernel once. Tokens of the int8 route must
    be identical across two engines and across chunk budgets (CHUNK and
    CHUNK // 2), and its teacher-forced logits within QUANT_MAE_MAX (mean
    absolute error, the JAX bar) of the dequant-first route and of the
    float model. Returns the numbers and the int8 run's launches."""
    from torch.profiler import ProfilerActivity, profile

    card = card_identity()
    out, tokens, launches = {}, {}, {}
    steps_main = 0
    for wm in ("off", "int8"):
        quant = QuantConfig(kv="int8", weights="int8", weight_matmul=wm)
        torch.cuda.empty_cache()
        engine = make_engine(model, quant, SPLIT, CHUNK, async_depth=1,
                             swap_pages=0)
        warm, _ = serve(engine, batches[0])
        engine.reset_step_profile()
        pa.LAUNCHES.clear()
        steps0, commits0 = engine.steps_dispatched, engine.steps_committed
        got, wall = serve(engine, batches[1])
        steps = engine.steps_dispatched - steps0
        commits = engine.steps_committed - commits0
        if wm == "int8":
            launches = dict(pa.LAUNCHES)
            steps_main = steps
        busy = device_busy_s(engine, commits, f"[wm {wm}]")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tprof:
            got3, wall3 = serve(engine, batches[2])
        log_device_profile(tprof, f"weight_matmul {wm}", wall3,
                           engine.steps_dispatched - steps0 - steps, 10)
        row = {"ms_per_step": 1e3 * wall / steps, "steps": steps,
               "device_ms_per_step": 1e3 * busy / commits,
               "device_busy": busy / wall,
               "gemm_share": _share(tprof, GEMM_KEYS),
               "int8_share": _share(tprof, INT8_KEYS),
               "dequant_share": _share(tprof, DEQUANT_KEYS)}
        assert_no_faults(engine, f"[wm {wm}]")
        engine.cache.check_invariants()
        tokens[wm] = [warm, got, got3]
        out[wm] = row
        shares = ", ".join(
            f"{k} " + ("not measured" if row[k] is None
                       else f"{100 * row[k]:.1f}%")
            for k in ("gemm_share", "int8_share", "dequant_share"))
        log(f"[wm] weight_matmul {wm}: {row['ms_per_step']:.3f} ms/step "
            f"({steps} steps), device {row['device_ms_per_step']:.3f} "
            f"ms/step, busy {100 * row['device_busy']:.1f}% of wall; "
            f"{shares}; {card}")
        del engine
    L = model.spec.num_layers
    want = {i8.INT8_MATMUL_KERNEL: 4 * L * steps_main,
            i8.QUANTIZE_ROWS_KERNEL: 4 * L * steps_main,
            pa.kernel_name(torch.int8, True): L * steps_main}
    if launches != want:
        raise AssertionError(f"[wm] int8 route launches {launches}, "
                             f"expected {want}")
    # determinism: a second engine, and the chunk budget halved
    quant = QuantConfig(kv="int8", weights="int8", weight_matmul="int8")
    for chunk in (CHUNK, CHUNK // 2):
        torch.cuda.empty_cache()
        engine = make_engine(model, quant, SPLIT, chunk, async_depth=1,
                             swap_pages=0)
        again, _ = serve(engine, batches[0])
        if again != tokens["int8"][0]:
            raise AssertionError(f"[wm] int8 route tokens differ in another "
                                 f"engine at chunk {chunk}")
        del engine
    # teacher-forced quality against the dequant-first route and float
    torch.cuda.empty_cache()
    prompt = batches[0][0][0][:TEACHER_TOKENS]
    mxu = teacher_forced(model, prompt, QuantConfig(weights="int8",
                                                    weight_matmul="int8"))
    deq = teacher_forced(model, prompt, QuantConfig(weights="int8"))
    mae_deq = (mxu - deq).abs().mean().item()
    del deq
    flt = TorchLM(model.spec, init_lm_params(model.spec, seed=0,
                                             device=model.device),
                  device=model.device)
    ref = teacher_forced(flt, prompt, None)
    del flt
    mae_f = (mxu - ref).abs().mean().item()
    scale = ref.abs().mean().item()
    del mxu, ref
    torch.cuda.empty_cache()
    if not (0.0 < mae_deq <= QUANT_MAE_MAX and mae_f <= QUANT_MAE_MAX):
        raise AssertionError(f"[wm] teacher-forced logits MAE {mae_deq:.4f} "
                             f"vs dequant-first, {mae_f:.4f} vs float "
                             f"(bar {QUANT_MAE_MAX})")
    off, on = out["off"], out["int8"]
    log(f"[wm] int8 route: tokens identical in two engines and at chunk "
        f"{CHUNK} and {CHUNK // 2}; teacher-forced {TEACHER_TOKENS}-token "
        f"logits MAE {mae_deq:.5f} vs dequant-first, {mae_f:.5f} vs float "
        f"(mean |logit| {scale:.4f}; bar {QUANT_MAE_MAX}); ms/step off "
        f"{off['ms_per_step']:.3f}, int8 {on['ms_per_step']:.3f}; launches "
        f"{launches}; {card}")
    res = {"off": off, "int8": on, "mae_vs_dequant": mae_deq,
           "mae_vs_float": mae_f, "launches": launches}
    print(json.dumps({"weight_matmul": res, "card": card}))
    return res


# ---------------------------------------------------- narrow scale pools


def narrow_mix(kind: str, seed: int, device, mode: str, scale_dtype):
    """``ragged_mix`` at GPT-3 XL geometry with its scale pools stored in
    ``scale_dtype`` (the codes from the float32 scales, as
    ``quantize_kv`` writes them)."""
    args, scales, max_q, n_used = ragged_mix(kind, seed, device, GPT3_XL,
                                             mode)
    return (args, {k: v.to(scale_dtype) for k, v in scales.items()}, max_q,
            n_used)


def phase_narrow_kernels(device) -> dict:
    """The ragged pair with float16 and bfloat16 scale pools (int8 and
    fp8 codes) against their plain versions at the main path's decode
    and mix shapes, unsplit and split SPLIT: within ATTN_TOL, padding
    exact 0, a second split run bit-identical. Returns the worst error
    per kernel."""
    worst = {}
    for ci, (mode, sd) in enumerate(NARROW):
        for kind in ("decode", "mix"):
            args, scales, max_q, n_used = narrow_mix(kind, 40 + ci, device,
                                                     mode, sd)
            for split in (0, SPLIT):
                name = pa.kernel_name(DTYPES[mode], split > 0, sd)
                out = pa.ragged_attention(**args, tier="kernel",
                                          max_q_len=max_q, split_pages=split,
                                          **scales)
                torch.cuda.synchronize()
                ref = plain(args, scales, split)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                torch.testing.assert_close(out, ref, rtol=ATTN_TOL,
                                           atol=ATTN_TOL)
                if n_used < out.shape[0] and \
                        out[n_used:].abs().max().item() != 0:
                    raise AssertionError(f"{name}: bucket padding is not "
                                         "exact 0")
                if split:
                    again = pa.ragged_attention(
                        **args, tier="kernel", max_q_len=max_q,
                        split_pages=split, **scales)
                    if not torch.equal(again, out):
                        raise AssertionError(f"{name}: two runs differ")
                worst[name] = max(worst.get(name, 0.0), err)
                log(f"[kernel] {name} {kind}: max_abs_err vs plain "
                    f"{err:.3e} (tol {ATTN_TOL}), padding exact 0")
    return worst


def narrow_rows(device, launches: dict, errors: dict) -> list:
    """The kernels line's rows of the narrow-scale variants: each timed
    at the decode shape (the headline) and the mix shape beside its
    plain version, the library yardstick and the bounds (2-byte scales
    in the byte counts)."""
    rows = []
    for split in (0, SPLIT):
        for ci, (mode, sd) in enumerate(NARROW):
            name = pa.kernel_name(DTYPES[mode], split > 0, sd)
            shapes = {}
            for kind, seed in (("decode", 1), ("mix", 0)):
                args, scales, max_q, _ = narrow_mix(kind, seed, device, mode,
                                                    sd)
                shapes[kind] = time_shape(args, scales, max_q, split, True)
                del args, scales
                t = shapes[kind]
                log(f"[times] {name} {kind}: kernel {t['ms']:.4f} ms, "
                    f"plain {t['plain_ms']:.4f} ms, sdpa "
                    f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
                    f"ms ({t['bound_by']}), tensor-core bound "
                    f"{t['tc_bound_ms']:.4f} ms ({t['tc_bound_by']})")
            rows.append({"name": name, "route": "cuda",
                         "source": NARROW_SOURCES[(mode, sd)],
                         "replaces": REPLACES[split > 0],
                         "launches": launches.get(name, 0),
                         "max_abs_err": errors[name], **shapes["decode"],
                         "shapes": shapes})
    return rows


def phase_narrow_serving(model, requests, want,
                         min_prefix_pages: int = 512 // PAGE) -> dict:
    """The main path's quantized engine (int8 KV and weights, split
    SPLIT, chunk CHUNK) with bfloat16 scale pools: launches of the
    bfloat16-scale split kernel layers x steps, and tokens equal to the
    float32-scale run's ``want`` outside counted near-ties. The two runs
    store different scales (bfloat16 keeps 8 bits of each), so their
    logits differ by more than float32 summation order: a parting is a
    near-tie when the two routes, teacher-forced on the common context
    with their own scale pools, decide the token apart or sit within
    twice their logit difference of a tie (``compare_routes``). Any
    other parting fails."""
    f32 = QuantConfig(kv="int8", weights="int8")
    quant = dataclasses.replace(f32, scale_dtype="bfloat16")
    name = pa.kernel_name(torch.int8, True, torch.bfloat16)
    got = drive_path("GPT-3 XL int8 KV (bfloat16 scales) + int8 weights, "
                     f"split {SPLIT}", model, requests, name, quant, SPLIT,
                     CHUNK, min_prefix_pages=min_prefix_pages)
    launches, outs = got[0], got[3]
    del got
    ties = compare_routes(
        "[narrow] bfloat16 scales", requests, outs, want,
        lambda ctx: (teacher_forced(model, ctx, quant),
                     teacher_forced(model, ctx, f32)))
    same = len(outs) - len(ties)
    log(f"[narrow] bfloat16 scale pools on the main path: {same} of "
        f"{len(outs)} requests token-identical to float32 scales; "
        f"{len(ties)} part at a near-tie (token, decision gap, the two "
        f"routes' logit difference there, decided apart): "
        + (", ".join(f"({j}, {g:.3e}, {d:.3e}, {ap})" for j, g, d, ap
                     in ties) or "none")
        + f"; {name} launches {launches[name]}")
    return {"launches": launches, "ties": len(ties), "same": same,
            "tie_detail": ties}


# ------------------------------------------------------ the serving fabric


def make_shared_prefix_workload(n, rng, vocab, prefix_len, tail_hi):
    """``perf/bench_serving.py:451``'s shared-prefix burst: ``n``
    prompts of one ``prefix_len``-token prefix and a 4 to ``tail_hi``
    token tail each, 8 new tokens each."""
    prefix = rng.integers(0, vocab, size=prefix_len).tolist()
    prompts = [prefix + rng.integers(0, vocab, size=int(
        rng.integers(4, tail_hi))).tolist() for _ in range(n)]
    return prompts, [8] * n


def fabric_burst(vocab: int, seed: int = 5):
    """The fabric phase's traffic: two tenants, each with a burst of
    FABRIC_BURST prompts over its own FABRIC_PREFIX-token prefix
    (``make_shared_prefix_workload``), interleaved a, b, a, ...; every
    third request sampled with ``seed=None`` (the fabric draws its seed)
    and every fifth with a fixed seed. Returns [(prompt, new tokens,
    sampling, tenant)]; the first request of each tenant warms its
    prefix."""
    rng = np.random.default_rng(seed)
    per = {t: make_shared_prefix_workload(FABRIC_BURST, rng, vocab,
                                          FABRIC_PREFIX, FABRIC_TAIL)
           for t in ("a", "b")}
    out = []
    for i in range(FABRIC_BURST):
        for t in ("a", "b"):
            k = len(out)
            sp = (SamplingParams(temperature=0.8, top_k=50, top_p=0.9)
                  if k % 3 == 2 else
                  SamplingParams(temperature=0.8, top_k=50, seed=700 + k)
                  if k % 5 == 4 else None)
            out.append((per[t][0][i], per[t][1][i], sp, t))
    return out


def fabric_configs(model, slots=SLOTS):
    spec = model.spec
    pps = -(-spec.max_seq_len // PAGE)
    cache = CacheConfig(num_layers=spec.num_layers, num_heads=spec.num_heads,
                        head_dim=spec.head_dim, num_pages=slots * pps + 1,
                        page_size=PAGE, max_slots=slots,
                        max_seq_len=spec.max_seq_len)
    sched = SchedulerConfig(max_slots=slots, max_seq_len=spec.max_seq_len,
                            chunk_tokens=CHUNK, kv_split_pages=SPLIT,
                            async_depth=1)
    return cache, sched


FABRIC_QUANT = QuantConfig(kv="int8", weights="int8", weight_matmul="int8")


def run_fabric(model, burst, replicas=FABRIC_REPLICAS, roles="colocated",
               trace=True, kill_at=None, journal_dir=None, watch=False):
    """Serve ``burst`` on a fresh fabric (or, with ``replicas=0``, one
    engine of the same configuration): the first request of each tenant
    first, run dry (its prefix then sits on one replica), then the rest
    at once. ``kill_at`` kills replica 1 at that fabric step; ``watch``
    puts a hang watchdog on every replica for the whole run and fails
    if one fires. Returns (target, rids, outputs, the burst's timing,
    memory before and after the kill): its wall seconds, and the CUDA
    graph captures made inside it (new step signatures) with their wall
    seconds, from each engine's compile observatory."""
    cache, sched = fabric_configs(model)
    if replicas:
        target = ServingFabric(model, FabricConfig(
            replicas=replicas, roles=roles, trace=trace,
            journal_dir=journal_dir), cache_config=cache,
            scheduler_config=sched, quant=FABRIC_QUANT,
            device=model.device)
    else:
        target = GenerationEngine(model, cache_config=cache,
                                  scheduler_config=sched,
                                  quant=FABRIC_QUANT, device=model.device)
    dogs = ([obs.watch_engine(e, name=f"replica{i}", deadline_s=120.0,
                              register_default=False)
             for i, e in enumerate(target.replicas)]
            if watch and replicas else [])
    rids = [target.submit(p, n, sp, tenant=t) for p, n, sp, t in burst[:2]]
    target.run()
    mem = None
    caps0 = _captures(target)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids += [target.submit(p, n, sp, tenant=t) for p, n, sp, t in burst[2:]]
    steps = 0
    while target.has_work if replicas else (
            target.scheduler.has_work or target.pipeline_depth):
        if kill_at is not None and steps == kill_at:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            target.kill_replica(1)
            torch.cuda.synchronize()
            mem = (before, torch.cuda.memory_allocated())
        target.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    caps = {k: v for k, v in _captures(target).items() if k not in caps0}
    timing = {"wall_s": wall, "captures": len(caps),
              "capture_s": sum(caps.values())}
    for d in dogs:
        d.check()
        stalls = d.status()["stalls_total"]
        d.stop()
        if stalls:
            raise AssertionError("[fabric] a replica's hang watchdog fired")
    return target, rids, [target.output_of(r) for r in rids], timing, mem


def _captures(target) -> dict:
    """Every step graph the target's engines captured so far, by
    (engine, signature), with its capture's wall seconds."""
    engines = getattr(target, "replicas", [target])
    return {(id(e), k): v["compile_seconds"] for e in engines
            if e.ledger is not None for k, v in e.ledger.captures.items()}


def _burst_record(n_tok, timing, ttft) -> dict:
    """A timed burst's records: tokens/s over its wall time, and over
    its wall time less the graph captures made inside it."""
    return {"tokens_per_s": n_tok / timing["wall_s"],
            "tokens_per_s_less_captures":
                n_tok / (timing["wall_s"] - timing["capture_s"]),
            "captures": timing["captures"],
            "capture_s": timing["capture_s"], "ttft_ms": ttft}


def _ttft_ms(target, rids):
    vals = sorted(1e3 * target.request_summary(r)["ttft_seconds"]
                  for r in rids[2:])
    return (float(np.percentile(vals, 50)), float(np.percentile(vals, 99)))


def _check_fabric(fab, label) -> None:
    if not fab.pool_restored():
        raise AssertionError(f"{label}: a replica's pool is not back at "
                             "its boot size")
    fab.check_invariants()
    for i, eng in enumerate(fab.replicas):
        assert_no_faults(eng, f"{label} replica {i}")


def phase_fabric(model) -> dict:
    """The replicated serving fabric on the card: FABRIC_REPLICAS
    replicas of the int8 GPT-3 XL engine (int8 KV, int8 weights, the int8
    weight matmul, split SPLIT, chunk CHUNK, async depth 1, graphs on,
    SLOTS slots each) sharing one copy of the weights, on the two-tenant
    shared-prefix burst (``fabric_burst``). Checks:

    1. outputs equal to one engine's on the same submissions, outside
       partings between logits that differ only by arithmetic route
       (``compare_tapped``: a token prefilled in one run may be decoded
       in the other, and the tile kernel and the one-query walk sum in
       other orders); every run serves each request with one engine's
       sampling (the same seeds drawn for ``seed=None``), and every
       delivered token is the draw from the logits its run computed
       for it (a ``LogitsTap`` on each compared run);
    2. of the prefix pages the burst's followers could hit, at least
       FABRIC_AFFINITY_MIN are placed by affinity;
    3. replica 1 killed at fabric step FABRIC_KILL_STEP of the burst:
       no request dropped, outputs equal to the unkilled fabric's
       (greedy and sampled) outside such partings (the replayed
       requests re-prefill what they had decoded), and
       device memory after the kill and respawn no higher than before
       it by half a replica's KV pools (a corpse left on the card would
       add a whole replica's);
    4. prefill/decode disaggregation: outputs equal outside such
       partings, pages handed off;
    5. tracing off: outputs identical to the colocated run's;
    6. a slow step (FABRIC_FAULT_MS of sleep a replica step) fires the
       burn-rate alert on an inter-token objective of FABRIC_ITL_MS,
       and healing it clears the alert;
    every fabric's pools restored, no device fault, and the replicas'
    watchdogs silent. Prints tokens/s (also less the graph captures
    made inside the timed burst) and TTFT p50/p99 for one engine and
    for the fabric (records, not gates)."""
    import tempfile

    card = card_identity()
    burst = fabric_burst(model.spec.vocab)

    def tapped():
        return LogitsTap(model.spec.vocab, model.device)

    res = {"ties": {}}
    torch.cuda.empty_cache()
    # each tap outlives the engines that ran under it
    tap_one, tap_col, tap_kill, tap_dis = (tapped() for _ in range(4))
    with tap_one:
        eng, rids, want, timing, _ = run_fabric(model, burst, replicas=0)
    # each request with the sampling it was served with: every run must
    # draw the same seeds, and the tapped checks use them
    sps = served_sampling(eng, rids)
    reqs = [(p, sp) for (p, _, _, _), sp in zip(burst, sps)]

    def same_seeds(target, rids, label):
        if served_sampling(target, rids) != sps:
            raise AssertionError(f"{label}: requests served with other "
                                 "sampling than one engine's")

    n_tok = sum(len(o) for o in want[2:])
    res["one"] = _burst_record(n_tok, timing, _ttft_ms(eng, rids))
    assert_no_faults(eng, "[fabric] one engine")
    del eng
    with tempfile.TemporaryDirectory() as jdir:
        torch.cuda.empty_cache()
        with tap_col:
            fab, rids, got, timing, _ = run_fabric(
                model, burst, journal_dir=jdir, watch=True)
        same_seeds(fab, rids, "[fabric] colocated")
        res["ties"]["colocated"] = compare_tapped(
            "[fabric] colocated vs one engine", reqs, got, want, tap_col,
            tap_one)
        colocated = got
        rec = [dict(e.attrs) for e in fab._rec.by_category("fabric")
               if e.name == "routed" and e.rid in rids[2:]]
        prefix_pages = FABRIC_PREFIX // PAGE
        by_aff = sum(r["hit_pages"] for r in rec
                     if r["reason"] == "affinity")
        could = prefix_pages * len(rec)
        if by_aff < FABRIC_AFFINITY_MIN * could:
            raise AssertionError(f"[fabric] {by_aff} of {could} prefix "
                                 "pages placed by affinity")
        _check_fabric(fab, "[fabric]")
        res["two"] = {**_burst_record(n_tok, timing, _ttft_ms(fab, rids)),
                      "affinity_pages": by_aff, "prefix_pages": could,
                      "reasons": collections.Counter(r["reason"]
                                                     for r in rec)}
        pools = sum(t.numel() * t.element_size() for t in (
            fab.replicas[1].cache.k_pool, fab.replicas[1].cache.v_pool,
            fab.replicas[1].cache.k_scale, fab.replicas[1].cache.v_scale))
        del fab
    with tempfile.TemporaryDirectory() as jdir:
        torch.cuda.empty_cache()
        with tap_kill:
            fab, rids, got, _, mem = run_fabric(
                model, burst, journal_dir=jdir, kill_at=FABRIC_KILL_STEP)
        if any(len(o) != n for o, (_, n, _, _) in zip(got, burst)):
            raise AssertionError("[fabric] a request was dropped or cut "
                                 "short by the kill")
        same_seeds(fab, rids, "[fabric] killed")
        res["ties"]["kill"] = compare_tapped(
            "[fabric] killed vs unkilled", reqs, got, colocated, tap_kill,
            tap_col)
        if fab.migrations < 1:
            raise AssertionError("[fabric] the kill migrated no request")
        if mem[1] - mem[0] > pools // 2:
            raise AssertionError(
                f"[fabric] device memory {mem[0]} -> {mem[1]} bytes across "
                f"the kill and respawn: the killed replica's "
                f"{pools}-byte pools were not released")
        _check_fabric(fab, "[fabric] killed")
        res["kill"] = {"migrated": fab.migrations, "mem_before": mem[0],
                       "mem_after": mem[1], "replica_pools": pools}
        del fab
    with tempfile.TemporaryDirectory() as jdir:
        torch.cuda.empty_cache()
        with tap_dis:
            fab, rids, got, _, _ = run_fabric(
                model, burst, roles="disaggregated", journal_dir=jdir)
        if fab.handoff_pages <= 0:
            raise AssertionError("[fabric] disaggregated: no page handed off")
        same_seeds(fab, rids, "[fabric] disaggregated")
        res["ties"]["disaggregated"] = compare_tapped(
            "[fabric] disaggregated vs one engine", reqs, got, want, tap_dis,
            tap_one)
        _check_fabric(fab, "[fabric] disaggregated")
        res["disaggregated"] = {"handoff_pages": fab.handoff_pages}
        del fab
    del tap_one, tap_col, tap_kill, tap_dis
    with tempfile.TemporaryDirectory() as jdir:
        torch.cuda.empty_cache()
        prev = obs.set_default_recorder(obs.FlightRecorder())
        try:
            fab, _, got, _, _ = run_fabric(model, burst, trace=False,
                                           journal_dir=jdir)
            stamped = [ev for ev in fab._rec.snapshot()
                       if ev.attr("trace") is not None or ev.cat == "trace"]
        finally:
            obs.set_default_recorder(prev)
        if got != colocated:
            raise AssertionError("[fabric] outputs differ with tracing off")
        if stamped:
            raise AssertionError(f"[fabric] {len(stamped)} trace events "
                                 "with tracing off")
        del fab
    res["alerts"] = fabric_alerts(model, burst)
    one, two = res["one"], res["two"]
    ties = {k: len(v) for k, v in res["ties"].items()}
    log(f"[fabric] {FABRIC_REPLICAS} replicas x {SLOTS} slots, "
        f"{len(burst)} requests (2 tenants x {FABRIC_BURST}, "
        f"{FABRIC_PREFIX}-token prefixes): outputs equal to one engine's "
        f"colocated, after a kill (replica 1 at step {FABRIC_KILL_STEP}, "
        f"{res['kill']['migrated']} migrated; against the unkilled "
        f"fabric) and disaggregated "
        f"({res['disaggregated']['handoff_pages']} pages handed off), "
        f"outside {ties} partings where the two runs drew from logits "
        f"apart only by route (token, decision gap, largest and mean "
        f"logit difference: {res['ties']}), every token the draw from "
        f"its run's own logits, and identical with tracing off; "
        f"affinity placed "
        f"{two['affinity_pages']} of {two['prefix_pages']} prefix pages "
        f"({dict(two['reasons'])}); memory across the kill "
        f"{res['kill']['mem_before']} -> {res['kill']['mem_after']} bytes "
        f"(a replica's KV pools {res['kill']['replica_pools']}); "
        f"pools restored, watchdogs silent; {card}")
    log("[fabric] records: " + "; ".join(
        f"{name} {r['tokens_per_s']:.1f} tokens/s "
        f"({r['tokens_per_s_less_captures']:.1f} less the "
        f"{r['captures']} graph captures in the burst, "
        f"{r['capture_s']:.3f} s), TTFT p50 {r['ttft_ms'][0]:.1f} ms p99 "
        f"{r['ttft_ms'][1]:.1f}"
        for name, r in (("one engine", one),
                        (f"{FABRIC_REPLICAS} replicas", two)))
        + f"; {card}")
    print(json.dumps({"fabric": res, "card": card}, default=str))
    return res


def fabric_alerts(model, burst) -> dict:
    """A slow step fires the fabric's burn-rate alert and healing clears
    it: every replica step sleeps FABRIC_FAULT_MS (the injector's delay)
    against an inter-token objective of FABRIC_ITL_MS (small windows so
    that the run stays short); once it fires the fault is healed and
    fresh traffic flows until the alert clears. The burning replicas'
    brownout pressure is raised while it fires and lowered after."""
    alerts = obs.AlertConfig(itl_ms=FABRIC_ITL_MS, fast_window=8,
                             slow_window=32, eval_every=4, up_after=2,
                             down_after=2, min_samples=4)
    inj = FaultInjector(FaultConfig(delay_rate=1.0,
                                    delay_ms=FABRIC_FAULT_MS, seed=3))
    prev = set_default_injector(inj)
    try:
        import tempfile
        with tempfile.TemporaryDirectory() as jdir:
            cache, sched = fabric_configs(model)
            fab = ServingFabric(model, FabricConfig(
                replicas=FABRIC_REPLICAS, journal_dir=jdir),
                cache_config=cache, scheduler_config=sched,
                quant=FABRIC_QUANT, device=model.device)
            fab.alerts = obs.SLOAlerts(fab, alerts)
            for p, n, sp, t in burst[:4]:
                fab.submit(p, n, sp, tenant=t)
            fired = cleared = None
            for step in range(1, 200):
                fab.step()
                if fab.alerts.fires:
                    fired = step
                    pressure = [e.brownout.alert_pressure
                                for e in fab.replicas]
                    if not any(pressure):
                        raise AssertionError("[fabric] the alert fired "
                                             "without brownout pressure")
                    inj.config = FaultConfig(seed=3)          # heal
                    break
            if fired is None:
                raise AssertionError("[fabric] the slow step never fired "
                                     "the burn-rate alert")
            for i in range(400):
                if not fab.has_work:
                    for p, n, sp, t in burst[4 + 2 * (i % 6):
                                             6 + 2 * (i % 6)]:
                        fab.submit(p[:FABRIC_PREFIX // 4], 16, sp, tenant=t)
                fab.step()
                step += 1
                if fab.alerts.clears:
                    cleared = step
                    break
            if cleared is None or fab.alerts.active() or \
                    any(e.brownout.alert_pressure for e in fab.replicas):
                raise AssertionError("[fabric] the alert did not clear "
                                     "after healing")
            fab.run()
            _check_fabric(fab, "[fabric] alerts")
            log(f"[fabric] burn-rate alert fired at fabric step {fired} "
                f"under a {FABRIC_FAULT_MS} ms step sleep (objective "
                f"{FABRIC_ITL_MS} ms inter-token), cleared at step "
                f"{cleared} after healing; brownout pressure raised and "
                "lowered")
            del fab
    finally:
        set_default_injector(prev)
    return {"fired_at": fired, "cleared_at": cleared}


def phase_profile(model, requests) -> None:
    """``--profile`` only: one more warm run of the main path under
    ``torch.profiler``; prints device time per step by kernel and the
    device's busy share of the run's wall time (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine, _, wall = run_engine(model, requests,
                                     QuantConfig(kv="int8", weights="int8"),
                                     SPLIT, CHUNK)
    log_device_profile(prof, "main path", wall, engine.steps_dispatched, 14)


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn`` over ``reps`` runs, CUDA events around each,
    with the L2 cache flushed before every run (the serving step finds
    each layer's pages cold). A device-side sleep between the flush and
    the start event keeps the device busy while the host enqueues the
    run, so the events time the device's work and not the host's launch
    path (without it a row could include the host's launch time where
    it outlasted the flush)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sdpa_inputs(args, scales):
    """Dense per-row layout for the library yardstick: each row's
    context gathered and dequantized to ``[B, H, S, D]`` float32 and its
    tokens padded to ``[B, H, T, D]``, with a boolean mask of the same
    visibility."""
    q = args["q"]
    _, H, D = q.shape
    pt = args["page_table"].long()
    B, pps = pt.shape
    q_lens = args["q_lens"].tolist()
    kv_lens = args["kv_lens"].tolist()
    q_starts = args["q_starts"].tolist()
    S = pps * PAGE
    T = max(max(q_lens), 1)
    kv = []
    for pool, scale in ((args["k_pool"], scales.get("k_scale")),
                        (args["v_pool"], scales.get("v_scale"))):
        dense = pa._pages_f32(pool, scale, pt.reshape(-1))
        kv.append(dense.reshape(B, S, H, D).transpose(1, 2).contiguous())
    qd = torch.zeros(B, H, T, D, device=q.device)
    mask = torch.zeros(B, 1, T, S, dtype=torch.bool, device=q.device)
    pos = torch.arange(S, device=q.device)
    for b in range(B):
        ql, kvl, qs = q_lens[b], kv_lens[b], q_starts[b]
        if ql == 0:
            mask[b, 0, :, 0] = True        # keep padded rows finite
            continue
        qd[b, :, :ql] = q[qs:qs + ql].transpose(0, 1)
        qpos = kvl - ql + torch.arange(T, device=q.device)
        mask[b, 0] = (pos[None, :] < kvl) & (pos[None, :] <= qpos[:, None])
        mask[b, 0, ql:, 0] = True
    return qd, kv[0], kv[1], mask


def time_shape(args, scales, max_q, split, quant, old=None):
    """The kernel, its plain version and the library yardstick at one
    shape, beside both bounds; with ``old`` (a ``pa._entry`` that takes
    the ragged C entries from an earlier design's libraries) that
    design's time before and after the kernel's."""
    def kernel():
        return pa.ragged_attention(**args, tier="kernel", max_q_len=max_q,
                                   split_pages=split, **scales)

    def time_old():
        own, pa._entry = pa._entry, old
        try:
            return time_cuda(kernel)
        finally:
            pa._entry = own

    before = time_old() if old else None
    ms = time_cuda(kernel)
    out = {"ms": ms}
    if old:
        out["design_ms"] = [before, time_old()]
    out["plain_ms"] = time_cuda(lambda: plain(args, scales, split), reps=5,
                                warmup=1)
    qd, k, v, mask = sdpa_inputs(args, scales)
    lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        qd, k, v, attn_mask=mask))
    del qd, k, v, mask
    sb = scales["k_scale"].element_size() if scales else 4
    bms, by = bound(args, quant, sb)
    tc_ms, tc_by = tc_bound(args, quant, sb)
    out.update(bound_ms=bms, bound_by=by, library_ms=lib_ms,
               tc_bound_ms=tc_ms, tc_bound_by=tc_by)
    return out


def per_tier_work(args):
    """Bytes (K and V of every position below each slot's seq_len read
    once, q read, out written, float32) and float32 operations (4 * D
    per visible (query, key) pair and head; a padding row of the mixed
    shape sees its slot's whole context, and is computed)."""
    q, seq = args["q"], args["seq_lens"].tolist()
    H, D = q.shape[-2:]
    T = q.shape[1] if q.dim() == 4 else 1
    q_lens = args["q_lens"].tolist() if "q_lens" in args else [1] * len(seq)
    pairs = sum(min(s, max(0, s - ql + t + 1))
                for s, ql in zip(seq, q_lens) for t in range(T))
    return sum(seq) * H * D * 4 * 2 + q.numel() * 4 * 2, pairs * H * 4 * D


def per_tier_sdpa_inputs(args):
    """The library yardstick's inputs: each slot's table gathered dense
    to ``[B, H, S, D]``, the queries as ``[B, H, T, D]``, and a boolean
    mask of the same visibility (a row that sees nothing keeps key 0 so
    the library stays finite)."""
    q = args["q"] if args["q"].dim() == 4 else args["q"][:, None]
    B, T, H, D = q.shape
    pt = args["page_table"].long()
    S = pt.shape[1] * PAGE
    k, v = (pool[pt].reshape(B, S, H, D).transpose(1, 2).contiguous()
            for pool in (args["k_pool"], args["v_pool"]))
    seq = args["seq_lens"].long()
    q_lens = args["q_lens"].long() if "q_lens" in args else torch.ones_like(
        seq)
    pos = torch.arange(S, device=q.device)
    q_pos = (seq - q_lens)[:, None] + torch.arange(T, device=q.device)
    mask = ((pos[None, None, :] <= q_pos[:, :, None])
            & (pos[None, None, :] < seq[:, None, None]))[:, None]
    mask[..., 0] |= ~mask.any(dim=-1)
    return q.transpose(1, 2).contiguous(), k, v, mask


def per_tier_rows(device, launches: dict, errors: dict, old_decode=None):
    """The kernels line's rows for the decode and mixed kernels: kernel,
    plain and library times and the bound at each per-tier shape (the
    mixed kernel's headline at the chunk shape, verify beside it). With
    ``old_decode`` (source path, library of an earlier decode kernel) that
    design's time at the decode shape before and after the kernel's."""
    shapes = {name: {} for name in PER_TIER}
    old = (ragged_entry({"paged_attention_f32": old_decode[1]})
           if old_decode else None)

    def time_old(args):
        own, pa._entry = pa._entry, old
        try:
            return time_cuda(lambda: per_tier_call(args, "kernel"))
        finally:
            pa._entry = own

    for seed, (kind, name) in enumerate(PER_TIER_SHAPES):
        args = per_tier_mix(kind, 40 + seed, device)
        with_old = old is not None and name == pa.PAGED_KERNEL
        before = time_old(args) if with_old else None
        ms = time_cuda(lambda: per_tier_call(args, "kernel"))
        design = ""
        if with_old:
            design_ms = [before, time_old(args)]
            design = (f", {old_decode[0]} {design_ms[0]:.4f} / "
                      f"{design_ms[1]:.4f} ms")
        plain_ms = time_cuda(lambda: per_tier_call(args, "ref"), reps=5,
                             warmup=1)
        qd, k, v, mask = per_tier_sdpa_inputs(args)
        lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            qd, k, v, attn_mask=mask))
        del qd, k, v, mask
        nbytes, flops = per_tier_work(args)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
        t = {"ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": lib_ms, "bytes": nbytes, "flops": flops}
        if with_old:
            t["design_ms"] = design_ms
        note = ""
        if name == pa.MIXED_KERNEL:
            t["schedule"] = mixed_schedule(args)
            t["unsplit_ms"] = time_cuda(
                lambda: per_tier_call(args, "kernel", 0))
            note = (f" ({t['schedule']}; unsplit {t['unsplit_ms']:.4f} "
                    "ms)")
        shapes[name][kind] = t
        log(f"[times] {name} {kind} {list(args['q'].shape)}: kernel "
            f"{ms:.4f} ms{note}{design}, plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {nbytes} bytes, {flops} float32 "
            "operations)")
    rows = []
    for name, (source, replaces) in PER_TIER.items():
        head = shapes[name]["decode" if name == pa.PAGED_KERNEL else "chunk"]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches.get(name, 0),
                     "max_abs_err": errors[name],
                     **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
                     "shapes": shapes[name]})
    return rows


def phase_times(device, launches: dict, errors: dict, old_ragged=None):
    """Each kernel, its plain version and the library yardstick at the
    decode shape (the engine's steady state, reported first) and the mix
    shape of GPT-3 XL geometry; the float kernel also at its own
    GPT-2-small shapes. The yardstick times
    ``F.scaled_dot_product_attention`` alone on K/V already gathered and
    dequantized dense; the port never calls it. Each shape carries both
    bounds (``bound``: float32 operations at 67 TFLOP/s; ``tc_bound``:
    the arithmetic the kernels run) and, with ``old_ragged`` (source
    path, C entry -> library of an earlier design), that design's two
    times. Each row carries the launches by step class of the path its
    launches come from (LAUNCHES_BY_STEP) and launches x (time - bound)
    at the matching shape: decode-only steps at the decode shape, the
    rest at the mix."""
    old = ragged_entry(old_ragged[1]) if old_ragged else None
    rows = []
    for split in (0, SPLIT):
        for mode in MODES:
            name = pa.kernel_name(DTYPES[mode], split > 0)
            shapes = {}
            geoms = [(GPT3_XL, "")]
            if name == "ragged_attention":
                geoms.append((GPT2_SMALL, "_gpt2_small"))
            for spec, suffix in geoms:
                for kind, seed in (("decode", 1), ("mix", 0)):
                    args, scales, max_q, _ = ragged_mix(kind, seed, device,
                                                        spec, mode)
                    shapes[kind + suffix] = time_shape(
                        args, scales, max_q, split, mode != "f32", old)
                    del args, scales
                    t = shapes[kind + suffix]
                    design = ("" if old is None else
                              f", {old_ragged[0]} {t['design_ms'][0]:.4f} / "
                              f"{t['design_ms'][1]:.4f} ms")
                    log(f"[times] {name} {kind}{suffix}: kernel "
                        f"{t['ms']:.4f} ms{design}, plain "
                        f"{t['plain_ms']:.4f} ms, sdpa "
                        f"{t['library_ms']:.4f} ms, bound "
                        f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
                        f"tensor-core bound {t['tc_bound_ms']:.4f} ms "
                        f"({t['tc_bound_by']})")
            row = {"name": name, "route": "cuda", "source": SOURCES[mode],
                   "replaces": REPLACES[split > 0],
                   "launches": launches.get(name, 0),
                   "max_abs_err": errors[name], **shapes["decode"],
                   "shapes": shapes}
            # the path whose launches the row reports
            by_step = next(({"path": path, **rec} for path, rec in
                            reversed(LAUNCHES_BY_STEP.items())
                            if rec["kernel"] == name and rec["decode"]
                            + rec["mix"] == launches.get(name)), None)
            if by_step:
                suffix = "_gpt2_small" if name == "ragged_attention" else ""
                loss = {k: by_step[k] * (shapes[k + suffix]["ms"]
                                         - shapes[k + suffix]["bound_ms"])
                        for k in ("decode", "mix")}
                row["launches_by_step"] = by_step
                row["launch_ms_over_bound"] = loss
                log(f"[times] {name} on {by_step['path']}: "
                    f"{by_step['decode']} launches in decode-only steps x "
                    f"(time - bound) = {loss['decode']:.2f} ms, "
                    f"{by_step['mix']} in steps with a chunk or prefix row = "
                    f"{loss['mix']:.2f} ms (at the{suffix.replace('_', ' ')}"
                    " decode and mix shapes)")
            rows.append(row)
    return rows


def ragged_entry(libs: dict):
    """``pa._entry`` with each ragged C entry in ``libs`` (C entry ->
    library built from another source of it) taken from there, every
    other entry the port's own."""
    own = pa._entry

    def pick(lib_name, entry, n_ptr, n_int):
        if entry not in libs:
            return own(lib_name, entry, n_ptr, n_int)
        fn = getattr(libs[entry], entry)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn
    return pick


def inline_includes(text: str, seen=None, beside=None) -> str:
    """``text`` with each ``#include "..."`` replaced by the header, taken
    from the directory ``beside`` where it is there, else from ``csrc/``
    (recursively, each once, ``#pragma once`` dropped), so that it builds
    outside ``csrc/``."""
    seen = set() if seen is None else seen

    def sub(m):
        if m.group(1) in seen:
            return ""
        seen.add(m.group(1))
        path = _build.CSRC / m.group(1)
        if beside is not None and (Path(beside) / m.group(1)).exists():
            path = Path(beside) / m.group(1)
        return inline_includes(path.read_text(), seen, beside)

    text = re.sub(r"^\s*#pragma once\s*$", "", text, flags=re.M)
    return re.sub(r'^\s*#include\s+"([^"]+)"\s*$', sub, text, flags=re.M)


def old_ragged_sources(text: str) -> dict:
    """Library name -> CUDA source of each page type's library built
    from ``text``, an earlier ``ragged_attention.cuh``: the port's
    one-line instantiation with that header in place of its own."""
    return {f"{lib}_old": inline_includes(
        (_build.CSRC / f"{lib}.cu").read_text().replace(
            '#include "ragged_attention.cuh"', text))
        for lib, _, _ in pa._LIBS.values()}


# ------------------------------------------------------------ training


def flash_inputs(shape, dtype, seed, device):
    """q, k, v and an output gradient for ``shape`` (B, H, Sq, Sk, D)."""
    B, H, Sq, Sk, D = shape
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, H, S, D, generator=g, device=device).to(dtype)
            for S in (Sq, Sk, Sk, Sq)]


def flash_bwd_f64(q, k, v, do, lse, delta, sm_scale, causal):
    """The plain backward's arithmetic in float64 on the same inputs
    (``lse`` and ``delta`` as given): ``(dq, dk, dv)`` in float64, the
    yardstick both the float32 kernels and their plain versions are
    measured against."""
    q, k, v, do, lse, delta = (t.double() for t in (q, k, v, do, lse, delta))
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * sm_scale - lse)
    if causal:
        p = p.masked_fill(~fa._causal_mask(q.shape[2], k.shape[2], q.device),
                          0.0)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta) * sm_scale
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
            torch.matmul(p.transpose(-1, -2), do))


def flash_fwd_f64(q, k, v, sm_scale, causal):
    """The plain forward's arithmetic in float64 on the same inputs:
    ``(o, lse)`` in float64, ``lse`` ``[B, H, Sq, 1]``; a row that sees no
    key gets o = 0 and, as the float32 sides give it, lse = float32
    NEG_INF."""
    q, k, v = (t.double() for t in (q, k, v))
    s = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    if causal:
        mask = fa._causal_mask(q.shape[2], k.shape[2], q.device)
        s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    seen = m > -math.inf
    p = torch.exp(s - torch.where(seen, m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(seen, l, torch.ones_like(l))
    lse = torch.where(seen, m + torch.log(l_safe),
                      torch.full_like(m, float(np.float32(fa.NEG_INF))))
    return torch.matmul(p, v) / l_safe, lse


def check_f64(worst, args, got, plain, shape) -> None:
    """The float32 flash kernels' outputs (``got``: o and lse, and the
    gradients dq, dk, dv, each where given) and the plain versions'
    (``plain``, the same names) against ``flash_fwd_f64`` and
    ``flash_bwd_f64`` on the same inputs ``args`` (the backward's: q,
    k, v, dO, lse, delta, scale, causal): each kernel's error must be
    above 0 and at most FLASH_F64_RATIO times its plain version's.
    Records each kernel's worst pair in ``worst[(name, "float64")]``."""
    q, k, v, do, lse, delta, scale, causal = args
    want = {}
    if "o" in got:
        want.update(zip(("o", "lse"), flash_fwd_f64(q, k, v, scale, causal)))
    if "dq" in got:
        want.update(zip(("dq", "dk", "dv"), flash_bwd_f64(*args)))
    err = {n: ((got[n].double() - want[n]).abs().max().item(),
               (plain[n].double() - want[n]).abs().max().item())
           for n in want}
    del want
    for name, keys in FLASH_F64_OUTPUTS:
        if keys[0] not in err:
            continue
        kern = max(err[n][0] for n in keys)
        ref = max(err[n][1] for n in keys)
        if not 0 < kern <= FLASH_F64_RATIO * ref:
            raise AssertionError(
                f"{name} {shape}: float64 error {kern:.3e}, the plain "
                f"version's {ref:.3e}: want above 0 and at most "
                f"{FLASH_F64_RATIO:g}x")
        old = worst.get((name, "float64"), (0.0, 0.0))
        worst[(name, "float64")] = (max(old[0], kern), max(old[1], ref))
    log(f"[flash] float32 {'causal' if causal else 'full'} "
        f"{list(shape)} against float64: "
        + ", ".join(f"{n} kernel {e[0]:.3e} plain {e[1]:.3e}"
                    for n, e in err.items())
        + f" (kernel within {FLASH_F64_RATIO:g}x the plain version's)")


def phase_flash(device) -> dict:
    """Each flash kernel against its plain version, float32, bf16 and
    float16, causal and not, at the training shape and a GPT-3 XL head layout,
    plus Sq < Sk causal; every kernel run twice for identical bits; the
    float32 outputs and gradients of both also against float64
    (``check_f64``). Returns the worst error per kernel and dtype, and per
    kernel the worst float64 errors (kernel, plain) under ``(name,
    "float64")``."""
    worst: dict = {}
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    cases = [(shape, dtype, causal) for shape in (FLASH_TRAIN, FLASH_XL)
             for dtype in dtypes for causal in (True, False)]
    cases += [((4, 12, 512, 1024, 64), dtype, True) for dtype in dtypes]
    for seed, (shape, dtype, causal) in enumerate(cases):
        q, k, v, do = flash_inputs(shape, dtype, seed, device)
        scale = shape[-1] ** -0.5
        tol = FLASH_TOL[dtype]
        o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
        delta = fa.bwd_delta(o, do)
        dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale,
                                        causal)
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
        rdk, rdv = fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta, scale,
                                         causal)
        rdq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, scale, causal)
        errs = {}
        for name, got, want, t in (("o", o, ro, tol["o"]),
                                   ("lse", lse, rlse, tol["lse"]),
                                   ("dq", dq, rdq, tol["grad"]),
                                   ("dk", dk, rdk, tol["grad"]),
                                   ("dv", dv, rdv, tol["grad"])):
            errs[name] = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), rtol=t,
                                       atol=t, msg=f"{name} {shape} {dtype}")
        if dtype == torch.float32:
            check_f64(worst, (q, k, v, do, lse, delta, scale, causal),
                      {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
                      {"o": ro, "lse": rlse, "dq": rdq, "dk": rdk,
                       "dv": rdv}, shape)
        del ro, rlse, rdk, rdv, rdq
        again = fa.flash_fwd_cuda(q, k, v, scale, causal)
        same = (torch.equal(again[0], o) and torch.equal(again[1], lse)
                and all(torch.equal(a, b) for a, b in zip(
                    fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale,
                                           causal), (dk, dv)))
                and torch.equal(fa.flash_bwd_dq_cuda(
                    q, k, v, do, lse, delta, scale, causal), dq))
        if not same:
            raise AssertionError(f"flash kernels {shape} {dtype}: two runs "
                                 "differ")
        dt = str(dtype).split(".")[-1]
        for name, keys in (("flash_attention_fwd", ("o", "lse")),
                           ("flash_attention_bwd_dkdv", ("dk", "dv")),
                           ("flash_attention_bwd_dq", ("dq",))):
            key = (name, dt)
            worst[key] = max(worst.get(key, 0.0), *(errs[k] for k in keys))
        log(f"[flash] {dt} {'causal' if causal else 'full'} [B,H,Sq,Sk,D]="
            f"{list(shape)} vs plain: "
            + ", ".join(f"{n} {e:.3e} (tol {tol['grad' if n[0] == 'd' else n]})"
                        for n, e in errs.items())
            + "; a second run bit-identical")
        del q, k, v, do, o, lse, delta, dk, dv, dq, again
        torch.cuda.empty_cache()
    return worst


def train_model(device, layers, tier="auto", seed=0):
    cfg = GPTConfig(**{**TRAIN_CFG, "num_hidden_layers": layers},
                    attn_tier=tier)
    return GPTForCausalLM(cfg, device=device, seed=seed)


def loss_fn(net, x, y):
    return net.loss(x, y)


def phase_train_parity(device) -> None:
    """GPT-2-small widths at 2 layers, float32, three ``TrainStep``
    steps with the flash kernels against the same steps with the plain
    attention (the kernels' plain versions), from the same weights and
    tokens."""
    g = torch.Generator(device=device).manual_seed(21)
    ids = torch.randint(0, TRAIN_CFG["vocab_size"],
                        (PARITY_STEPS, PARITY_BATCH, TRAIN_SEQ),
                        generator=g, device=device)
    runs = {}
    for tier in ("kernel", "ref"):
        model = train_model(device, PARITY_LAYERS, tier)
        opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
        step = TrainStep(model, loss_fn, opt)
        fa.LAUNCHES.clear()
        losses = torch.stack([step(x, x) for x in ids])
        torch.cuda.synchronize()
        runs[tier] = (losses, dict(model.named_parameters()),
                      dict(fa.LAUNCHES))
    (lk, pk, nk), (lr, pr, nr) = runs["kernel"], runs["ref"]
    want = {n: PARITY_LAYERS * PARITY_STEPS for n in fa.KERNEL_NAMES}
    if nk != want or nr:
        raise AssertionError(f"parity launches: kernel route {nk}, plain "
                             f"route {nr}; expected {want} and none")
    if not torch.isfinite(lk).all():
        raise AssertionError("non-finite loss on the kernel route")
    torch.testing.assert_close(lk, lr, rtol=TRAIN_LOSS_RTOL, atol=0)
    max_diff, far, total = 0.0, 0, 0
    for name, p in pk.items():
        d = (p.detach() - pr[name].detach()).abs()
        max_diff = max(max_diff, d.max().item())
        far += int((d > TRAIN_PARAM_CLOSE).sum().item())
        total += d.numel()
    bound = 2 * TRAIN_LR * PARITY_STEPS
    log(f"[train] parity, GPT-2-small widths x {PARITY_LAYERS} layers, "
        f"float32, {PARITY_STEPS} TrainStep steps of {PARITY_BATCH} x "
        f"{TRAIN_SEQ}: losses kernel {[round(x, 6) for x in lk.tolist()]} vs "
        f"plain {[round(x, 6) for x in lr.tolist()]}, max rel err "
        f"{((lk - lr).abs() / lr.abs()).max().item():.3e} (tol "
        f"{TRAIN_LOSS_RTOL}); params max_abs_diff {max_diff:.3e} (bound "
        f"{bound:.1e}), {far} of {total} over {TRAIN_PARAM_CLOSE} (limit "
        f"{TRAIN_MAX_FAR_SHARE} of them)")
    if max_diff > bound or far > TRAIN_MAX_FAR_SHARE * total:
        raise AssertionError("kernel and plain training routes drifted apart")


def _stub(name):
    def refuse(*args, **kwargs):
        raise AssertionError(f"the training path reached the plain {name}")
    return refuse


PLAIN_ATTENTION = ((fa, "flash_fwd_ref"), (fa, "flash_bwd_ref"),
                   (fa, "flash_bwd_dkdv_ref"), (fa, "flash_bwd_dq_ref"),
                   (attn, "sdpa_reference"), (attn, "causal_sdpa_chunked"))


@contextlib.contextmanager
def plain_attention_refused():
    """Inside the block the plain attention functions raise: a training
    path that reaches one fails."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in PLAIN_ATTENTION]
    try:
        for mod, name, _ in saved:
            setattr(mod, name, _stub(name))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_train(device, profile: bool) -> dict:
    """The main path: bench.py's configuration and protocol. AdamW at lr
    1e-4 under AMP O2 bf16, ``TrainStep`` of 8 steps per call on 16 x
    1024 token ids (labels = ids, as bench.py), one warm call then
    TRAIN_CALLS timed calls, each call's losses read on the host after
    the next call is queued. The plain attention functions are replaced
    by ones that raise for the run, and every flash kernel must launch
    once per layer per step."""
    cfg_layers = TRAIN_CFG["num_hidden_layers"]
    model = train_model(device, cfg_layers)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    model, opt = decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, loss_fn, opt, steps_per_call=TRAIN_K)
    g = torch.Generator(device=device).manual_seed(7)
    ids = torch.randint(0, TRAIN_CFG["vocab_size"],
                        (TRAIN_K, TRAIN_BATCH, TRAIN_SEQ), generator=g,
                        device=device)
    losses = []
    with plain_attention_refused():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.LAUNCHES.clear()
        pa.LAUNCHES.clear()
        t_warm = time.perf_counter()
        losses.append(step(ids, ids).tolist())            # warm call
        warm = time.perf_counter() - t_warm
        t0 = time.perf_counter()
        prev = None
        for _ in range(TRAIN_CALLS):
            cur = step(ids, ids)
            if prev is not None:
                losses.append(prev.tolist())
            prev = cur
        losses.append(prev.tolist())
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        other = dict(pa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        t_off = time.perf_counter()
        with torch._C.DisableTorchFunctionSubclass():
            off_losses = step(ids, ids).tolist()
        wall_off = time.perf_counter() - t_off
        peak_off = torch.cuda.max_memory_allocated()
        if profile:
            phase_profile_train(step, ids)
    steps = TRAIN_K * (1 + TRAIN_CALLS)
    want = {n: cfg_layers * steps for n in fa.KERNEL_NAMES}
    if launches != want or other:
        raise AssertionError(f"training launches {launches} (and {other}), "
                             f"expected {want} = layers x steps")
    flat = [x for call in losses + [off_losses] for x in call]
    if len(flat) != steps + TRAIN_K or not all(math.isfinite(x)
                                               for x in flat):
        raise AssertionError(f"training losses not all finite: {flat}")
    timed = TRAIN_K * TRAIN_CALLS
    tokens = TRAIN_BATCH * TRAIN_SEQ * timed
    ms_step = 1e3 * wall / timed
    log(f"[train] main path: bench.py config (GPT-2-small, 12 layers, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, AdamW lr {TRAIN_LR}, AMP O2 "
        f"bf16, {TRAIN_K} steps per call): warm call {warm:.3f}s; "
        f"{TRAIN_CALLS} timed calls {wall:.3f}s = {tokens / wall:.1f} "
        f"tokens/s, {ms_step:.2f} ms/step; memory allocated before the "
        f"first call {base / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB "
        f"allocated, {peak_reserved / 2**30:.2f} GiB reserved; one more "
        f"call with the Tensor hook off {1e3 * wall_off / TRAIN_K:.2f} "
        f"ms/step (not pipelined), peak {peak_off / 2**30:.2f} GiB "
        f"allocated; loss first {flat[0]:.4f} last {flat[-1]:.4f}, all "
        f"{steps + TRAIN_K} finite; flash launches "
        f"{launches} = {cfg_layers} layers x {steps} steps, no plain attention, no "
        "other attention kernel")
    return {"tokens_per_s": tokens / wall, "ms_per_step": ms_step,
            "launches": launches, "peak_gib": peak / 2**30,
            "peak_above_gib": (peak - base) / 2**30}


def phase_train_f32(device) -> dict:
    """The training path in float32, where the float32 flash kernels run
    at full width: bench.py's widths and batch (GPT-2-small, 12 layers,
    16 x 1024 token ids, labels = ids) without AMP, AdamW at lr 1e-4,
    ``TrainStep`` of TRAIN_F32_K steps per call, one warm call then
    TRAIN_F32_CALLS timed calls (their losses read once all are queued),
    the plain attention functions refused. Every flash kernel must
    launch once per layer per step."""
    layers = TRAIN_CFG["num_hidden_layers"]
    model = train_model(device, layers)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    step = TrainStep(model, loss_fn, opt, steps_per_call=TRAIN_F32_K)
    g = torch.Generator(device=device).manual_seed(8)
    ids = torch.randint(0, TRAIN_CFG["vocab_size"],
                        (TRAIN_F32_K, TRAIN_BATCH, TRAIN_SEQ), generator=g,
                        device=device)
    with plain_attention_refused():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES.clear()
        pa.LAUNCHES.clear()
        t_warm = time.perf_counter()
        losses = [step(ids, ids).tolist()]
        warm = time.perf_counter() - t_warm
        t0 = time.perf_counter()
        calls = [step(ids, ids) for _ in range(TRAIN_F32_CALLS)]
        losses += [c.tolist() for c in calls]
        wall = time.perf_counter() - t0
        launches, other = dict(fa.LAUNCHES), dict(pa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_F32_K * (1 + TRAIN_F32_CALLS)
    want = {n: layers * steps for n in fa.KERNEL_NAMES}
    if launches != want or other:
        raise AssertionError(f"float32 training launches {launches} (and "
                             f"{other}), expected {want} = layers x steps")
    flat = [x for call in losses for x in call]
    if len(flat) != steps or not all(math.isfinite(x) for x in flat):
        raise AssertionError(f"float32 training losses not all finite: "
                             f"{flat}")
    timed = TRAIN_F32_K * TRAIN_F32_CALLS
    tokens = TRAIN_BATCH * TRAIN_SEQ * timed
    ms_step = 1e3 * wall / timed
    log(f"[train] float32 path: bench.py widths (GPT-2-small, {layers} "
        f"layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}, AdamW lr {TRAIN_LR}, "
        f"no AMP, {TRAIN_F32_K} steps per call): warm call {warm:.3f}s; "
        f"{TRAIN_F32_CALLS} timed calls {wall:.3f}s = "
        f"{tokens / wall:.1f} tokens/s, {ms_step:.2f} ms/step; peak "
        f"{peak / 2**30:.2f} GiB allocated; losses {flat}, all finite; "
        f"flash launches {launches} = {layers} layers x {steps} steps, no "
        "plain attention, no other attention kernel")
    return {"tokens_per_s": tokens / wall, "ms_per_step": ms_step,
            "launches": launches}


def phase_profile_train(step, ids) -> None:
    """``--profile`` only: one more training call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ids, ids).tolist()
    wall = time.perf_counter() - t0
    log_device_profile(prof, "training call", wall, TRAIN_K, 16,
                       ("flash attention kernels",
                        ("flash::", "fwd_kernel<", "bwd_dkdv_kernel<",
                         "bwd_dq_kernel<")))


def flash_work(shape, dtype, causal=True):
    """Per kernel: (bytes, operations). Bytes: each input read once and
    each output written once (q, k, v, dO and o in the input dtype,
    lse and delta float32). Operations: 2 * D per visible (query, key)
    pair and head for each product the kernel forms: QK^T and PV in the
    forward (4 D), QK^T, dO V^T, P^T dO and dS^T Q in dK/dV (8 D),
    QK^T, dO V^T and dS K in dQ (6 D)."""
    B, H, Sq, Sk, D = shape
    it = torch.tensor([], dtype=dtype).element_size()
    pairs = B * H * (sum(min(Sk, max(0, i + Sk - Sq + 1)) for i in range(Sq))
                     if causal else Sq * Sk)
    q_b, kv_b, row_b = B * H * Sq * D * it, B * H * Sk * D * it, B * H * Sq * 4
    return {"flash_attention_fwd": (2 * q_b + 2 * kv_b + row_b, 4 * D * pairs),
            "flash_attention_bwd_dkdv": (2 * q_b + 4 * kv_b + 2 * row_b,
                                         8 * D * pairs),
            "flash_attention_bwd_dq": (3 * q_b + 2 * kv_b + 2 * row_b,
                                       6 * D * pairs)}


def flash_bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM
    bandwidth and the operations over the tensor cores' rate, bf16's
    (the same as float16's) for bf16 and float16 inputs, three TF32
    products per float32 product for float32."""
    t_ops = (flops / BF16_FLOPS_PER_S
             if dtype in (torch.bfloat16, torch.float16)
             else 3 * flops / TF32_FLOPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def f32_fwd_from(lib):
    """``fa._entry`` with the float32 forward's C entry ``flash_fwd_f32``
    taken from the library ``lib`` (built from another source of it),
    every other entry the port's own."""
    fn = lib.flash_fwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    own = fa._entry
    return lambda kernel, dtype: (fn if (kernel, dtype) == (
        "fwd", torch.float32) else own(kernel, dtype))


def flash_times(device, dtype, old_fwd=None) -> dict:
    """Each flash kernel, its plain version and the library call at the
    training shape (causal), CUDA-event medians with L2 flushed. The
    library call is ``F.scaled_dot_product_attention(is_causal=True)``:
    its forward, forward+backward, and backward alone (the gradients of
    one kept output) on the same tensors, timed only: the port never
    calls it. The backward rows also carry ``bwd_delta``'s time, the
    plain pass the backward runs before its two kernels, so that delta +
    dK/dV + dQ compares with SDPA's backward alone. With ``old_fwd``
    (``(source path, library)`` of an earlier float32 forward) the
    float32 forward's row also carries that design's time, taken before
    and after the kernel's."""
    q, k, v, do = flash_inputs(FLASH_TRAIN, dtype, 99, device)
    scale = FLASH_TRAIN[-1] ** -0.5
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, True)
    delta = fa.bwd_delta(o, do)
    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_fwd_cuda(q, k, v, scale, True),
            lambda: fa.flash_fwd_ref(q, k, v, scale, True)),
        "flash_attention_bwd_dkdv": (
            lambda: fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale,
                                           True),
            lambda: fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta, scale,
                                          True)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale,
                                         True),
            lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, scale,
                                        True))}
    lib_fwd = time_cuda(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(
            do)

    lib_fwd_bwd = time_cuda(sdpa_fwd_bwd)
    kept = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = time_cuda(lambda: torch.autograd.grad(
        kept, (qg, kg, vg), do, retain_graph=True))
    delta_ms = time_cuda(lambda: fa.bwd_delta(o, do))
    work = flash_work(FLASH_TRAIN, dtype)
    out = {}
    old = None
    if old_fwd is not None and dtype == torch.float32:
        old = f32_fwd_from(old_fwd[1])

    def time_old():
        own, fa._entry = fa._entry, old
        try:
            return time_cuda(calls["flash_attention_fwd"][0])
        finally:
            fa._entry = own

    for name, (kernel, plain_fn) in calls.items():
        bms, by = flash_bound(*work[name], dtype)
        fwd = name.endswith("fwd")
        before = time_old() if fwd and old else None
        out[name] = {"ms": time_cuda(kernel),
                     "plain_ms": time_cuda(plain_fn, reps=5, warmup=1),
                     "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_fwd if fwd else None,
                     "library_fwd_bwd_ms": lib_fwd_bwd}
        if not fwd:
            out[name].update(library_bwd_ms=lib_bwd, delta_ms=delta_ms)
        if before is not None:
            out[name]["design"] = {"source": old_fwd[0],
                                   "ms": [before, time_old()]}
            log(f"[times] {name} float32: the design of {old_fwd[0]} "
                f"{out[name]['design']['ms'][0]:.4f} / "
                f"{out[name]['design']['ms'][1]:.4f} ms (before and after "
                f"the kernel's {out[name]['ms']:.4f} ms)")
        t = out[name]
        log(f"[times] {name} {str(dtype).split('.')[-1]} "
            f"{list(FLASH_TRAIN)} causal: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}); sdpa "
            f"fwd {lib_fwd:.4f} ms, fwd+bwd {lib_fwd_bwd:.4f} ms, bwd "
            f"alone {lib_bwd:.4f} ms; bwd_delta {delta_ms:.4f} ms")
    dkdv, dq = (out[n]["ms"] for n in ("flash_attention_bwd_dkdv",
                                       "flash_attention_bwd_dq"))
    log(f"[times] flash backward {str(dtype).split('.')[-1]}: bwd_delta + "
        f"dK/dV + dQ = {delta_ms:.4f} + {dkdv:.4f} + {dq:.4f} = "
        f"{delta_ms + dkdv + dq:.4f} ms against SDPA's backward alone "
        f"{lib_bwd:.4f} ms ({(delta_ms + dkdv + dq) / lib_bwd:.2f}x; the "
        f"two kernels {(dkdv + dq) / lib_bwd:.2f}x)")
    return out


def flash_rows_f16(device, launches: dict, errors: dict) -> list:
    """The kernels line's rows of the float16 flash kernels: their times
    at the training shape, their launches on the float16 O2 path and
    their worst error against their plain versions."""
    times = flash_times(device, torch.float16)
    return [{"name": f"{name}_f16", "route": "cuda",
             "source": FLASH_SOURCES_F16[name],
             "replaces": FLASH_REPLACES[name],
             "launches": launches.get(name, 0),
             "max_abs_err": errors[(name, "float16")], **times[name],
             "dtype": "float16", "shape": list(FLASH_TRAIN)}
            for name in fa.KERNEL_NAMES]


def flash_rows(device, launches: dict, errors: dict, launches_f32: dict,
               old_fwd=None):
    """The kernels line's rows for the flash kernels: numbers at the
    main path's dtype (bf16), float32's beside them (their launches from
    the float32 training path; each kernel's worst errors against
    float64, kernel and plain version; with ``old_fwd``, ``(source path,
    library)``, an earlier float32 forward timed beside it)."""
    times = {dt: flash_times(device, dt, old_fwd)
             for dt in (torch.bfloat16, torch.float32)}
    rows = []
    for name in fa.KERNEL_NAMES:
        f64 = errors.get((name, "float64"))
        rows.append({"name": name, "route": "cuda",
                     "source": FLASH_SOURCES[name],
                     "source_f32": FLASH_SOURCES_F32[name],
                     "replaces": FLASH_REPLACES[name],
                     "launches": launches.get(name, 0),
                     "launches_f32": launches_f32.get(name, 0),
                     "f64_err_f32": (None if f64 is None else
                                     {"kernel": f64[0], "plain": f64[1]}),
                     "max_abs_err": max(errors[(name, "bfloat16")],
                                        errors[(name, "float32")]),
                     **times[torch.bfloat16][name],
                     "dtype": "bfloat16", "shape": list(FLASH_TRAIN),
                     "max_abs_err_f32": errors[(name, "float32")],
                     "f32": times[torch.float32][name]})
    return rows


# ------------------------------------------------ the Paddle-API core


def triple_plain(x):
    """my_triple's plain version (and the JAX kernel's body)."""
    return x * 3.0


def triple_grid(x):
    """Blocks of TRIPLE_BLOCK threads, each thread two float4 (the
    kernel's kUnroll): one pass of the grid-stride loop, no cap (capped
    grids of several passes measured slower)."""
    return (max(1, -(-x.numel() // (8 * TRIPLE_BLOCK))),)


def triple_op():
    """The JAX package's user kernel as the port registers it."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, TRIPLE_SOURCE)) as f:
        source = f.read()
    return cuda_op("my_triple", source, "my_triple",
                   out_shape_fn=lambda x: ShapeDtypeStruct(x.shape, x.dtype),
                   grid_fn=triple_grid, block=TRIPLE_BLOCK,
                   reference=triple_plain)


def phase_custom_ops(device) -> dict:
    """The custom-op programs of ``tests/test_extensions.py:14-44`` on
    the card (``custom_op`` with torch's autodiff and with a custom
    backward; exact results), then the main path of the user kernel:
    ``my_triple`` through its op at the extension test's [4, 8] and at
    [8192, 8192], launches counted from 0, each output bit-equal to
    ``x * 3.0`` and to a rerun."""
    @custom_op("my_square_plus")
    def my_square_plus(x, bias=0.0):
        return x * x + bias

    my_relu = custom_op("my_relu_custom",
                        lambda x: (torch.clamp(x, min=0), (x,)),
                        backward=lambda res, g: (g * (res[0] > 0) * 10.0,))
    t = paddle.to_tensor(np.array([1.0, 2.0, 3.0], "float32"), place=device)
    u = paddle.to_tensor(np.array([-1.0, 2.0], "float32"), place=device)
    t.stop_gradient = u.stop_gradient = False
    out = my_square_plus(t, bias=1.0)
    out.sum().backward()
    my_relu(u).sum().backward()
    got = [out.numpy().tolist(), t.grad.numpy().tolist(),
           u.grad.numpy().tolist()]
    if got != [[2.0, 5.0, 10.0], [2.0, 4.0, 6.0], [0.0, 10.0]] or \
            t.grad.device.type != device.type:
        raise AssertionError(f"custom_op programs on {device}: {got}")
    log(f"[core] custom_op on {device}: autodiff x*x+1 -> {got[0]}, grad "
        f"{got[1]}; custom backward relu x10 grad {got[2]} (exact)")

    triple = triple_op()
    paddle.seed(5)
    xs = [paddle.randn(list(shape)) for shape in TRIPLE_SHAPES]
    OP_LAUNCHES.clear()
    ys = [triple(x) for x in xs]
    torch.cuda.synchronize()
    launches = dict(OP_LAUNCHES)
    if launches != {"my_triple": len(xs)}:
        raise AssertionError(f"my_triple launches {launches}, expected "
                             f"{len(xs)}")
    errs = []
    for x, y in zip(xs, ys):
        plain = triple_plain(x)
        if not isinstance(y, paddle.Tensor) or y.shape != x.shape:
            raise AssertionError(f"my_triple gave {type(y)} {y.shape}")
        if not torch.equal(y, plain):
            raise AssertionError(f"my_triple {list(x.shape)}: max abs err "
                                 f"{(y - plain).abs().max().item()}")
        if not torch.equal(triple(x), y):
            raise AssertionError("my_triple: a rerun is not bit-identical")
        errs.append((y - plain).abs().max().item())
    log(f"[core] my_triple (cuda_op, CUDA C++ user kernel) at "
        f"{[list(s) for s in TRIPLE_SHAPES]}: bit-equal to x * 3.0, reruns "
        f"bit-identical, {launches['my_triple']} launches on the main path")
    return {"op": triple, "x": xs[-1], "x_small": xs[0],
            "launches": launches["my_triple"], "max_abs_err": max(errs)}


def triple_row(core: dict) -> dict:
    """The kernels line's row for my_triple at [8192, 8192]: CUDA-event
    medians (L2 flushed) of the op, its plain version and ``torch.mul``,
    beside the byte bound (each input read once, each output written
    once: 8 bytes an element; 1 multiply an element is far under the
    float32 peak)."""
    op, x = core["op"], core["x"]
    nbytes = 2 * x.numel() * x.element_size()
    row = {"name": "my_triple", "route": "cuda", "source": TRIPLE_SOURCE,
           "replaces": TRIPLE_REPLACES, "launches": core["launches"],
           "max_abs_err": core["max_abs_err"],
           "ms": time_cuda(lambda: op(x)),
           "plain_ms": time_cuda(lambda: triple_plain(x)),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": time_cuda(lambda: torch.mul(x, 3.0)),
           "shape": list(x.shape), "dtype": "float32",
           "ms_4x8": time_cuda(lambda: op(core["x_small"]))}
    log(f"[times] my_triple {list(x.shape)} float32: kernel {row['ms']:.4f} "
        f"ms, plain {row['plain_ms']:.4f} ms, torch.mul "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"(bytes, {nbytes / 2**20:.0f} MiB); at [4, 8] {row['ms_4x8']:.4f} "
        "ms")
    return row


def resnet_loss(net, x, y):
    return PF.cross_entropy(net(x), y)


def _eager_steps(net, opt, xs, ys):
    """One eager step of ``opt`` on ``net`` per ``(x, y)``; returns, per
    step, the logits, the loss, every parameter's gradient and the state
    dict after the update, each on the CPU in float64."""
    def copy(t):
        return t.detach().to("cpu", torch.float64, copy=True)

    p0 = net.parameters()[0]
    out = []
    for x, y in zip(xs, ys):
        logits = net(paddle.to_tensor(x, dtype=p0.dtype, place=p0.device))
        loss = PF.cross_entropy(logits, paddle.to_tensor(y, place=p0.device))
        loss.backward()
        grads = {n: copy(p.grad) for n, p in net.named_parameters()}
        opt.step()
        opt.clear_grad()
        out.append((copy(logits), loss.item(), grads,
                    {k: copy(v) for k, v in net.state_dict().items()}))
    return out


def _rel_gap(a, b) -> float:
    """``max |a - b|`` over ``max |b|`` (``b`` the reference)."""
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-300)).item()


def _is_stat(name: str) -> bool:
    return name.endswith(("_mean", "_variance"))


def phase_resnet_parity(device, ref_device=torch.device("cpu")) -> None:
    """resnet50 (1000 classes) at batch 4 x 224^2, the same weights and
    inputs on ``device`` and on ``ref_device`` (the port's CPU path),
    with TF32 off for matmuls and cuDNN convolutions (PyTorch's default
    runs float32 convolutions in TF32, ~1e-3 relative, which would hide
    a fault):

    - float32, RESNET_PARITY_STEPS eager ``Momentum(RESNET_LR, 0.9)``
      steps, each from the CPU path's state (parameters, running
      statistics and velocities copied to the card first): the first
      logits within RESNET_LOGIT_TOL of max |logit|, the losses at
      RESNET_LOSS_RTOL, every BatchNorm running statistic after the step
      within RESNET_STAT_TOL of its buffer's largest value;
    - float64, RESNET_F64_STEPS free-running steps from one state: every
      loss, gradient, parameter update (after minus before) and running
      statistic within RESNET_F64_TOL of its tensor's largest value.
      This holds the backward pass and the optimizer's ``_foreach_*``
      update on the card, which float32's own ill-conditioning hides."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    paddle.seed(0)
    models = []
    for dev in (device, ref_device):
        paddle.set_device(dev)
        models.append(resnet50(num_classes=RESNET_CLASSES))
    paddle.set_device(device)
    card, cpu = models
    cpu.set_state_dict(card.state_dict())
    start = {k: v.detach().cpu().clone() for k, v in cpu.state_dict().items()}
    g = torch.Generator().manual_seed(3)
    shape = (RESNET_PARITY_STEPS, RESNET_PARITY_BATCH, 3, RESNET_SIZE,
             RESNET_SIZE)
    xs = torch.rand(shape, generator=g)
    ys = torch.randint(0, RESNET_CLASSES, shape[:2], generator=g)
    opts = [Momentum(RESNET_LR, RESNET_MOMENTUM, parameters=n.parameters())
            for n in (card, cpu)]
    logit_gap, loss_gaps, stat_gaps = None, [], []
    for x, y in zip(xs, ys):
        card.set_state_dict(cpu.state_dict())
        for pc, pr in zip(card.parameters(), cpu.parameters()):
            if id(pr) in opts[1]._accumulators:
                opts[0]._state_for(pc)["velocity"].copy_(
                    opts[1]._accumulators[id(pr)]["velocity"])
        (lg, lcard, _, sc), = _eager_steps(card, opts[0], [x], [y])
        (lc, lcpu, _, sr), = _eager_steps(cpu, opts[1], [x], [y])
        if logit_gap is None:
            logit_gap = _rel_gap(lg, lc)
        loss_gaps.append(abs(lcard - lcpu) / abs(lcpu))
        stat_gaps.append(max(_rel_gap(sc[k], sr[k]) for k in sr
                             if _is_stat(k)))
    del card, cpu, models, opts
    runs = []
    for dev in (device, ref_device):
        paddle.set_device(dev)
        net = resnet50(num_classes=RESNET_CLASSES)
        net.set_state_dict(start)
        net.to(dtype="float64")
        runs.append(_eager_steps(
            net, Momentum(RESNET_LR, RESNET_MOMENTUM,
                          parameters=net.parameters()),
            xs[:RESNET_F64_STEPS], ys[:RESNET_F64_STEPS]))
    paddle.set_device(device)
    f64 = {"loss": [], "grad": [], "update": [], "stat": []}
    before = {k: v.double() for k, v in start.items()}
    for (_, lcard, gc, sc), (_, lcpu, gr, sr) in zip(*runs):
        f64["loss"].append(abs(lcard - lcpu) / abs(lcpu))
        f64["grad"].append(max(_rel_gap(gc[n], gr[n]) for n in gr))
        f64["update"].append(max(_rel_gap(sc[k] - before[k], sr[k] - before[k])
                                 for k in sr if not _is_stat(k)))
        f64["stat"].append(max(_rel_gap(sc[k], sr[k]) for k in sr
                               if _is_stat(k)))
        before = sr
    log(f"[resnet] parity, resnet50 (TF32 off), batch {RESNET_PARITY_BATCH} "
        f"x {RESNET_SIZE}^2, {device} vs {ref_device}: float32, "
        f"{RESNET_PARITY_STEPS} Momentum({RESNET_LR}, {RESNET_MOMENTUM}) "
        f"steps from the CPU's state: first logits gap {logit_gap:.3e} of "
        f"max |logit| (tol {RESNET_LOGIT_TOL}), loss gaps "
        f"{[f'{v:.2e}' for v in loss_gaps]} (tol {RESNET_LOSS_RTOL}), BN "
        f"running-stat gaps {[f'{v:.2e}' for v in stat_gaps]} of each "
        f"buffer's max (tol {RESNET_STAT_TOL}); float64, "
        f"{RESNET_F64_STEPS} free-running steps, largest gap of each "
        f"tensor's max per step (tol {RESNET_F64_TOL}): "
        + ", ".join(f"{k} {[f'{v:.2e}' for v in vs]}"
                    for k, vs in f64.items()))
    if not (logit_gap <= RESNET_LOGIT_TOL
            and max(loss_gaps) <= RESNET_LOSS_RTOL
            and max(stat_gaps) <= RESNET_STAT_TOL
            and max(max(vs) for vs in f64.values()) <= RESNET_F64_TOL):
        raise AssertionError("resnet50 on the card drifted from the CPU path")


def timed_steps(step, x, y, n: int):
    """``n`` steps, each step's loss read on the host after the next is
    queued; returns the losses and the wall seconds."""
    losses, prev = [], None
    t0 = time.perf_counter()
    for _ in range(n):
        cur = step(x, y)
        if prev is not None:
            losses.append(prev.item())
        prev = cur
    losses.append(prev.item())
    return losses, time.perf_counter() - t0


def phase_resnet_train(device, profile: bool) -> dict:
    """The ResNet-50 main path: perf/resnet_bench.py's configuration and
    protocol with no cut (batch RESNET_BATCH x 3 x 224^2 random float32
    inputs cast to bf16, int64 labels, AMP O2 bf16, Momentum, TrainStep;
    RESNET_WARMUP steps, then RESNET_STEPS timed), then
    RESNET_PLAIN_STEPS more with the ``Tensor`` subclass's
    ``__torch_function__`` hook off, to price it."""
    paddle.seed(0)
    paddle.set_device(device)
    model = resnet50(num_classes=RESNET_CLASSES)
    opt = Momentum(RESNET_LR, RESNET_MOMENTUM, parameters=model.parameters())
    model, opt = decorate(model, opt, level="O2", dtype="bfloat16")
    if model.bn1._mean.dtype != torch.bfloat16:
        raise AssertionError("AMP O2 left the BatchNorm buffers in "
                             f"{model.bn1._mean.dtype}; JAX casts them")
    step = TrainStep(model, resnet_loss, opt)
    x = paddle.rand([RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE]).astype(
        "bfloat16")
    y = paddle.randint(0, RESNET_CLASSES, [RESNET_BATCH])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels_before = (dict(pa.LAUNCHES), dict(fa.LAUNCHES), dict(OP_LAUNCHES))
    warm_losses, warm = timed_steps(step, x, y, RESNET_WARMUP)
    losses, wall = timed_steps(step, x, y, RESNET_STEPS)
    peak = torch.cuda.max_memory_allocated()
    with torch._C.DisableTorchFunctionSubclass():
        _, wall_plain = timed_steps(step, x, y, RESNET_PLAIN_STEPS)
    if kernels_before != (dict(pa.LAUNCHES), dict(fa.LAUNCHES),
                          dict(OP_LAUNCHES)):
        raise AssertionError("the ResNet path launched a port kernel")
    every = warm_losses + losses
    if not all(math.isfinite(v) for v in every):
        raise AssertionError(f"resnet50 losses not all finite: {every}")
    ms = 1e3 * wall / RESNET_STEPS
    ms_plain = 1e3 * wall_plain / RESNET_PLAIN_STEPS
    log(f"[resnet] main path: perf/resnet_bench.py config (resnet50, "
        f"{RESNET_CLASSES} classes, batch {RESNET_BATCH} x 3 x "
        f"{RESNET_SIZE}^2, Momentum({RESNET_LR}, {RESNET_MOMENTUM}), AMP O2 "
        f"bf16, TrainStep): {RESNET_WARMUP} warm-up steps {warm:.3f}s; "
        f"{RESNET_STEPS} timed steps {wall:.3f}s = "
        f"{RESNET_BATCH * RESNET_STEPS / wall:.1f} samples/s, {ms:.2f} "
        f"ms/step; with the Tensor hook off {ms_plain:.2f} ms/step over "
        f"{RESNET_PLAIN_STEPS} steps; peak memory {peak / 2**30:.2f} GiB; "
        f"losses {[round(v, 4) for v in every]} all finite; BN running "
        f"stats {model.bn1._mean.dtype}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step(x, y)
            torch.cuda.synchronize()
        log_device_profile(prof, "resnet50 training", time.perf_counter() - t0,
                           2, 16)
    return {"samples_per_s": RESNET_BATCH * RESNET_STEPS / wall,
            "ms_per_step": ms, "ms_per_step_hook_off": ms_plain,
            "peak_bytes": peak}


# ------------------------------------- training as users configure it


def dropout_cases():
    """(label, shape, dtype, mask shape or None) of the dropout kernel's
    checks: the main path's two shapes, a broadcast mask, float16."""
    return (("hidden", DROPOUT_HIDDEN, torch.bfloat16, None),
            ("attention", DROPOUT_ATTN, torch.float32, None),
            ("axis", DROPOUT_AXIS[0], torch.bfloat16, DROPOUT_AXIS[1]),
            ("float16", DROPOUT_HIDDEN, torch.float16, None))


def _dropout_input(shape, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=device).to(dtype)


def _dropout_slices(n: int):
    """The flat ``(start, count)`` stretches the plain version is held to:
    the whole tensor, or its first and last DROPOUT_PLAIN_SLICE
    elements when it is larger."""
    if n <= 2 * DROPOUT_PLAIN_SLICE:
        return ((0, n),)
    return ((0, DROPOUT_PLAIN_SLICE),
            (n - DROPOUT_PLAIN_SLICE, DROPOUT_PLAIN_SLICE))


def _held_to_plain(label, got, x, key, mask, upscale=True):
    """``got`` (the kernel's output on x) equals the plain version's bits
    over each of :func:`_dropout_slices` (the whole tensor with a mask)."""
    if mask is not None:
        want = dk.dropout_ref(x, key, DROPOUT_P, mask, upscale)
        pairs = ((got, want),)
    else:
        flat, xf = got.reshape(-1), x.reshape(-1)
        pairs = ((flat[a:a + n], dk.dropout_ref(xf[a:a + n], key, DROPOUT_P,
                                                start=a))
                 for a, n in _dropout_slices(x.numel()))
    bits = torch.int16 if got.element_size() == 2 else torch.int32
    for g, w in pairs:
        if not torch.equal(g.view(bits), w.view(bits)):
            bad = int((g.view(bits) != w.view(bits)).sum().item())
            raise AssertionError(f"dropout kernel {label}: {bad} elements "
                                 "differ from the plain version's bits")


def phase_dropout_kernel(device) -> dict:
    """The dropout kernel bit-equal to its plain version, forward and
    backward (the same function of dy under the same key), at the main
    path's shapes, a broadcast mask and float16; two runs bit-identical;
    the kept share within DROPOUT_KEPT_TOL of 1 - p where there are
    enough draws. Returns the worst error (0 when bit-equal)."""
    for seed, (label, shape, dtype, mask) in enumerate(dropout_cases()):
        x = _dropout_input(shape, dtype, 40 + seed, device)
        key = threefry.prng_key(900 + seed)
        y = dk.dropout_cuda(x, key, DROPOUT_P, mask)
        torch.cuda.synchronize()
        _held_to_plain(f"{label} forward", y, x, key, mask)
        if not torch.equal(y, dk.dropout_cuda(x, key, DROPOUT_P, mask)):
            raise AssertionError(f"dropout kernel {label}: two runs differ")
        xg = x.clone().requires_grad_(True)
        dy = _dropout_input(shape, dtype, 60 + seed, device)
        dk.dropout(xg, key, DROPOUT_P, mask).backward(dy)
        torch.cuda.synchronize()
        _held_to_plain(f"{label} backward", xg.grad, dy, key, mask)
        draws = math.prod(mask) if mask is not None else x.numel()
        kept = None
        if draws >= DROPOUT_KEPT_MIN_DRAWS:
            kept = (dk.dropout_cuda(torch.ones_like(x), key, DROPOUT_P,
                                    mask, upscale=False) != 0).float() \
                .mean().item()
            if abs(kept - (1 - DROPOUT_P)) > DROPOUT_KEPT_TOL:
                raise AssertionError(f"dropout kernel {label}: kept share "
                                     f"{kept:.5f}, want {1 - DROPOUT_P}")
        whole = mask is not None or len(_dropout_slices(x.numel())) == 1
        over = ("the whole tensor" if whole else
                f"its first and last {DROPOUT_PLAIN_SLICE} elements")
        share = (f"kept share {kept:.5f} of {draws} draws (1 - p "
                 f"{1 - DROPOUT_P}, tol {DROPOUT_KEPT_TOL})"
                 if kept is not None else
                 f"{draws} draws (too few for the kept-share check)")
        log(f"[dropout] {label} {list(shape)} {str(dtype).split('.')[-1]}"
            f"{'' if mask is None else f' mask {list(mask)}'} p "
            f"{DROPOUT_P}: forward and backward bit-equal to the plain "
            f"version over {over}; a second run bit-identical; {share}")
        del x, y, xg, dy
        torch.cuda.empty_cache()
    return {"max_abs_err": 0.0}


def dropout_work(shape, dtype, mask=None):
    """(bytes, integer operations) of one dropout call: x read once and
    y written once; DROPOUT_INT_OPS a draw and an element."""
    n = math.prod(shape)
    it = torch.tensor([], dtype=dtype).element_size()
    return 2 * n * it, DROPOUT_INT_OPS * n


def dropout_bound(shape, dtype):
    nbytes, ops = dropout_work(shape, dtype)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dropout_times(device) -> dict:
    """The kernel, its plain version (reps 3: ~a hundred int64 passes)
    and ``F.dropout`` (Philox bits, another function: for scale only,
    never the library yardstick) at the main path's two shapes, beside
    the bound."""
    out = {}
    for label, shape, dtype, _ in dropout_cases()[:2]:
        x = _dropout_input(shape, dtype, 7, device)
        key = threefry.prng_key(5)
        bms, by = dropout_bound(shape, dtype)
        out[label] = {
            "ms": time_cuda(lambda: dk.dropout_cuda(x, key, DROPOUT_P)),
            "plain_ms": time_cuda(lambda: dk.dropout_ref(x, key, DROPOUT_P),
                                  reps=3, warmup=1),
            "bound_ms": bms, "bound_by": by,
            "torch_dropout_ms": time_cuda(lambda: F.dropout(x, DROPOUT_P)),
            "shape": list(shape), "dtype": str(dtype).split(".")[-1]}
        t = out[label]
        log(f"[times] dropout {label} {list(shape)} {t['dtype']}: kernel "
            f"{t['ms']:.4f} ms, bound {bms:.4f} ms ({by}; bytes "
            f"{dropout_work(shape, dtype)[0] / HBM_BYTES_PER_S * 1e3:.4f}, "
            f"int32 ops {dropout_work(shape, dtype)[1] / INT32_OPS_PER_S * 1e3:.4f}"
            f" at {INT32_OPS_PER_S / 1e12:.1f} T/s), plain "
            f"{t['plain_ms']:.4f} ms; F.dropout (Philox, for scale) "
            f"{t['torch_dropout_ms']:.4f} ms")
        del x
        torch.cuda.empty_cache()
    return out


def dropout_row(times: dict, launches: int, err: float) -> dict:
    """The kernels line's row of the dropout kernel: numbers at the
    attention-probability shape, the hidden shape's beside them; no
    PyTorch call computes this function (``F.dropout`` draws Philox
    bits), so ``library_ms`` is null."""
    att = times["attention"]
    return {"name": dk.KERNEL_NAME, "route": "cuda", "source": DROPOUT_SOURCE,
            "replaces": DROPOUT_REPLACES, "launches": launches,
            "max_abs_err": err, "ms": att["ms"], "plain_ms": att["plain_ms"],
            "bound_ms": att["bound_ms"], "bound_by": att["bound_by"],
            "library_ms": None, "torch_dropout_ms": att["torch_dropout_ms"],
            "shape": att["shape"], "dtype": att["dtype"],
            "hidden": times["hidden"]}


@contextlib.contextmanager
def plain_dropout_refused():
    """Inside the block the dropout kernel's plain version and the plain
    threefry draws raise: a path that reaches one fails."""
    saved = [(dk, "dropout_ref", dk.dropout_ref),
             (threefry, "bernoulli", threefry.bernoulli)]
    try:
        for mod, name, _ in saved:
            setattr(mod, name, _stub(name))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_ids(device, shape, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, TRAIN_CFG["vocab_size"], shape, generator=g,
                         device=device)


def dropout_train_step(device, seed=0):
    """bench.py's model with GPTConfig's default dropouts, AdamW under a
    linear warmup into a cosine decay, global-norm clipping, AMP O2
    bf16, TrainStep of TRAIN_K steps: (model, step, scheduler)."""
    cfg = GPTConfig(**{**TRAIN_CFG, "hidden_dropout_prob": TRAIN_DROPOUT,
                       "attention_probs_dropout_prob": TRAIN_DROPOUT})
    model = GPTForCausalLM(cfg, device=device, seed=seed)
    sched = LinearWarmup(CosineAnnealingDecay(TRAIN_LR, TRAIN_DECAY_STEPS),
                         TRAIN_WARMUP_STEPS, 0.0, TRAIN_LR)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(TRAIN_CLIP))
    model, opt = decorate(model, opt, level="O2", dtype="bfloat16")
    return model, TrainStep(model, loss_fn, opt, steps_per_call=TRAIN_K), \
        sched


def _call(step, sched, ids):
    out = step(ids, ids)
    for _ in range(TRAIN_K):
        sched.step()
    return out


def phase_train_dropout(device, base: dict, profile: bool = True) -> dict:
    """This slice's main path: bench.py's configuration with dropout 0.1
    / 0.1, the LR schedule, clipping and AMP O2 bf16, one warm call and
    TRAIN_DROPOUT_CALLS timed calls. Every dropout launch is counted:
    per step (1 + 2 x layers) hidden and layers attention dropouts
    forward and as many backward; the flash kernels stay idle (dropout
    keeps the attention on the plain route, as in the JAX package); the
    plain dropout and threefry draws are refused. The losses are finite
    and a second model from the same seeds repeats the first call's
    losses bit for bit; ``eval()`` gives the dropout-free logits. Prints
    ms/step and peak memory beside ``base`` (``phase_train``'s dropout-off
    numbers) and the dropout kernel's share of device time."""
    layers = TRAIN_CFG["num_hidden_layers"]
    ids = train_ids(device, (TRAIN_K, TRAIN_BATCH, TRAIN_SEQ), 7)
    model, step, sched = dropout_train_step(device)
    with plain_dropout_refused():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        trng.default_generator.manual_seed(0)
        dk.LAUNCHES.clear()
        fa.LAUNCHES.clear()
        t_warm = time.perf_counter()
        losses = [_call(step, sched, ids).tolist()]
        warm = time.perf_counter() - t_warm
        t0 = time.perf_counter()
        calls = [_call(step, sched, ids) for _ in range(TRAIN_DROPOUT_CALLS)]
        losses += [c.tolist() for c in calls]
        wall = time.perf_counter() - t0
        launches, flash = dict(dk.LAUNCHES), dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if profile:
            share = _dropout_share(step, sched, ids)
        else:
            share = None
    steps = TRAIN_K * (1 + TRAIN_DROPOUT_CALLS)
    per_step = (1 + 2 * layers) + layers
    want = {dk.KERNEL_NAME: 2 * per_step * steps}
    if launches != want or flash:
        raise AssertionError(f"dropout training launches {launches}, flash "
                             f"{flash}; expected {want} = 2 x ((1 + 2 x "
                             f"{layers}) + {layers}) x {steps} steps, and no "
                             "flash launch")
    flat = [x for call in losses for x in call]
    if not all(math.isfinite(x) for x in flat):
        raise AssertionError(f"dropout training losses not finite: {flat}")
    # eval: no key drawn, the logits of the same weights with every
    # dropout probability set to 0 (in training mode)
    x = ids[0][:2]
    state = trng.default_generator.get_state()
    model.eval()
    with torch.no_grad(), plain_dropout_refused():
        dk.LAUNCHES.clear()
        logits_eval = model(x)
        logits_free = _dropout_free_logits(model, x)
        eval_launches = dict(dk.LAUNCHES)
    if not torch.equal(logits_eval, logits_free) or eval_launches or \
            not torch.equal(state, trng.default_generator.get_state()):
        raise AssertionError("eval() did not give the dropout-free logits "
                             "(or drew a key, or launched the kernel)")
    del model, step, logits_eval, logits_free
    torch.cuda.empty_cache()
    # the same seeds again: the first call's losses bit for bit
    model2, step2, sched2 = dropout_train_step(device)
    trng.default_generator.manual_seed(0)
    again = _call(step2, sched2, ids).tolist()
    if again != losses[0]:
        raise AssertionError(f"dropout training from one seed is not "
                             f"repeatable: {losses[0]} then {again}")
    del model2, step2
    torch.cuda.empty_cache()
    timed = TRAIN_K * TRAIN_DROPOUT_CALLS
    ms_step = 1e3 * wall / timed
    log(f"[train] dropout main path: bench.py config with dropout "
        f"{TRAIN_DROPOUT} / {TRAIN_DROPOUT}, LinearWarmup({TRAIN_WARMUP_STEPS})"
        f" into CosineAnnealingDecay({TRAIN_DECAY_STEPS}), "
        f"ClipGradByGlobalNorm({TRAIN_CLIP}), AMP O2 bf16, {TRAIN_K} steps "
        f"per call: warm call {warm:.3f}s; {TRAIN_DROPOUT_CALLS} timed calls "
        f"{wall:.3f}s = {ms_step:.2f} ms/step (dropout off, phase_train: "
        f"{base['ms_per_step']:.2f}), peak {peak / 2**30:.2f} GiB allocated "
        f"(dropout off: {base['peak_gib']:.2f}), {(peak - before) / 2**30:.2f}"
        f" GiB above the {before / 2**30:.2f} allocated before the first "
        f"call (dropout off: {base['peak_above_gib']:.2f}); dropout kernel "
        f"share of "
        f"device time {'not measured' if share is None else f'{100 * share:.1f}%'}; "
        f"dropout launches {launches} = 2 x {per_step} x {steps} steps, "
        f"flash idle, plain dropout refused; losses all finite "
        f"(first {flat[0]:.4f}, last {flat[-1]:.4f}); a second model from "
        f"the same seeds repeats the first call's {TRAIN_K} losses bit for "
        f"bit; eval() logits equal the dropout-free forward's, no key drawn")
    return {"ms_per_step": ms_step, "peak_gib": peak / 2**30,
            "peak_above_gib": (peak - before) / 2**30,
            "launches": launches, "dropout_share": share}


def _dropout_free_logits(model, x):
    """The model's logits in training mode with every dropout
    probability (the config's and each ``Dropout`` layer's) at 0."""
    cfg = model.config
    saved = (cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob)
    layers = [(m, m.p) for m in model.modules() if isinstance(m, Dropout)]
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    for m, _ in layers:
        m.p = 0.0
    was = model.training
    model.train()
    try:
        return model(x)
    finally:
        model.train(was)
        cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob = saved
        for m, p in layers:
            m.p = p


def _dropout_share(step, sched, ids):
    """The dropout kernel's share of device time over one more training
    call under ``torch.profiler`` (None where it records no device
    time); prints the call's device time by operation."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _call(step, sched, ids).tolist()
    log_device_profile(prof, "dropout training call",
                       time.perf_counter() - t0, TRAIN_K, 10,
                       ("the dropout kernel", ("dropout_kernel",)))
    return _share(prof, ("dropout_kernel",))


def phase_train_fp16(device) -> dict:
    """bench.py's widths and depth under AMP O2 float16 (dropout 0),
    eager steps of ``scaler.scale(loss).backward(); scaler.step(opt)``
    from a loss scale at which the first steps overflow float16: a
    skipped step leaves every parameter bit-unchanged, the scale follows
    the found-inf sequence (halved at each overflow, kept otherwise),
    the last FP16_FINITE_TAIL steps are taken, every loss is finite; the
    float16 flash kernels launch once per layer per step with the plain
    attention refused."""
    layers = TRAIN_CFG["num_hidden_layers"]
    model = train_model(device, layers)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    model, opt = decorate(model, opt, level="O2", dtype="float16")
    scaler = GradScaler(init_loss_scaling=FP16_INIT_SCALE,
                        decr_every_n_nan_or_inf=1)
    ids = train_ids(device, (FP16_STEPS, TRAIN_BATCH, TRAIN_SEQ), 9)
    params = list(model.parameters())
    found_seq, scales, losses = [], [], []
    with plain_attention_refused():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES.clear()
        t0 = time.perf_counter()
        for x in ids:
            before = [p.detach().clone() for p in params]
            scale = scaler._scale
            loss = model.loss(x, x)
            scaler.scale(loss).backward()
            scaler.unscale_(opt)
            found = scaler._found_inf
            scaler.step(opt)
            opt.clear_grad()
            want = max(scale * 0.5, 1.0) if found else scale
            if scaler._scale != want:
                raise AssertionError(f"fp16: scale {scale} -> "
                                     f"{scaler._scale} after found_inf "
                                     f"{found}, want {want}")
            if found and not all(torch.equal(a, p.detach())
                                 for a, p in zip(before, params)):
                raise AssertionError("fp16: a skipped step changed the "
                                     "parameters")
            found_seq.append(found)
            scales.append(scaler._scale)
            losses.append(loss.float().item())
            del before
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    want = {n: layers * FP16_STEPS for n in fa.KERNEL_NAMES}
    if launches != want:
        raise AssertionError(f"fp16 flash launches {launches}, expected "
                             f"{want} = layers x steps")
    if not found_seq[0] or any(found_seq[-FP16_FINITE_TAIL:]):
        raise AssertionError(f"fp16: found_inf sequence {found_seq}: the "
                             "first step must overflow and the last "
                             f"{FP16_FINITE_TAIL} must not")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"fp16 losses not finite: {losses}")
    log(f"[train] float16 O2 path: bench.py widths ({layers} layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}), AdamW, GradScaler from "
        f"{FP16_INIT_SCALE:g} halving at each overflow, {FP16_STEPS} eager "
        f"steps {1e3 * wall / FP16_STEPS:.2f} ms/step (each reads found_inf "
        f"on the host), peak {peak / 2**30:.2f} GiB; found_inf "
        f"{[int(f) for f in found_seq]}, scales {[f'{v:g}' for v in scales]}"
        f"; {sum(found_seq)} skipped steps left every parameter "
        f"bit-unchanged; losses {[round(v, 4) for v in losses]}, all finite;"
        f" float16 flash launches {launches} = {layers} layers x "
        f"{FP16_STEPS} steps, no plain attention")
    return {"launches": launches, "ms_per_step": 1e3 * wall / FP16_STEPS,
            "skipped": sum(found_seq)}


def phase_remat(device) -> dict:
    """bench.py's configuration (bf16 O2, no dropout) under each remat
    policy: one warm and one timed call each from the same weights and
    tokens; the losses within TRAIN_LOSS_RTOL of no remat's (reported
    whether bit-equal), ms/step and peak memory per policy."""
    ids = train_ids(device, (TRAIN_K, TRAIN_BATCH, TRAIN_SEQ), 7)
    out = {}
    for policy in REMAT_POLICIES:
        cfg = GPTConfig(**{**TRAIN_CFG, "use_recompute": policy is True,
                           "recompute_policy": policy if isinstance(
                               policy, str) else None})
        model = GPTForCausalLM(cfg, device=device, seed=0)
        opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
        model, opt = decorate(model, opt, level="O2", dtype="bfloat16")
        step = TrainStep(model, loss_fn, opt, steps_per_call=TRAIN_K)
        with plain_attention_refused():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            fa.LAUNCHES.clear()
            losses = step(ids, ids).tolist()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += step(ids, ids).tolist()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = dict(fa.LAUNCHES)
        out[str(policy)] = {"ms_per_step": 1e3 * wall / TRAIN_K,
                            "peak_gib": (peak - before) / 2**30,
                            "losses": losses, "launches": launches}
        del model, opt, step
        torch.cuda.empty_cache()
    base = out["False"]["losses"]
    for name, r in out.items():
        if not all(math.isfinite(v) for v in r["losses"]):
            raise AssertionError(f"remat {name}: losses not finite")
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], base))
        r["max_rel_loss_diff"], r["bit_equal"] = rel, r["losses"] == base
        if rel > TRAIN_LOSS_RTOL:
            raise AssertionError(f"remat {name}: losses {rel:.3e} from no "
                                 f"remat's (tol {TRAIN_LOSS_RTOL})")
        log(f"[remat] {name:>16}: {r['ms_per_step']:.2f} ms/step, peak "
            f"{r['peak_gib']:.2f} GiB above the allocation before the "
            f"calls; losses {'bit-equal to' if r['bit_equal'] else f'within {rel:.2e} of'} "
            f"no remat's; flash launches {r['launches']}")
    return out


def adam_state_bytes(opt) -> int:
    return sum(t.numel() * t.element_size()
               for st in opt._accumulators.values() for t in st.values())


def adam_state_formula(params, lowmem: bool) -> int:
    """The optimizer-state bytes by formula, per parameter of n values:
    its float32 master (4n) and two float32 beta powers (8), plus 4n + 4n
    (moments) for the full tier; for the low-memory tier no first moment
    and, for a parameter of two or more axes, float32 row and column
    factors (4 x (prod(shape[:-1]) + shape[-1])), else a bf16 moment
    (2n)."""
    total = 0
    for p in params:
        n = p.numel()
        total += 4 * n + 8
        if not lowmem:
            total += 8 * n
        elif p.dim() >= 2:
            total += 4 * (n // p.shape[-1] + p.shape[-1])
        else:
            total += 2 * n
    return total


def phase_adam_lowmem(device) -> dict:
    """GPT-3 XL widths cut to four layers under AMP O2 bf16: AdamW's
    full tier against its low-memory tier (bf16 moments, factored second
    moment, no first moment, update RMS clip), one warm and one timed
    TrainStep call each: the optimizer-state bytes equal the formula,
    the losses are finite; ms/step and peak memory of each."""
    ids = train_ids(device, (ADAM_XL_K, ADAM_XL_BATCH, ADAM_XL_SEQ), 13)
    out = {}
    for tier, kw in (("full", {}), ("lowmem", ADAM_LOWMEM)):
        model = GPTForCausalLM(GPTConfig(**ADAM_XL_CFG), device=device,
                               seed=0)
        opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                    **kw)
        model, opt = decorate(model, opt, level="O2", dtype="bfloat16")
        step = TrainStep(model, loss_fn, opt, steps_per_call=ADAM_XL_K)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        losses = step(ids, ids).tolist()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += step(ids, ids).tolist()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        got = adam_state_bytes(opt)
        want = adam_state_formula(list(model.parameters()), tier == "lowmem")
        if got != want:
            raise AssertionError(f"adam {tier}: state {got} bytes, formula "
                                 f"{want}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"adam {tier}: losses not finite {losses}")
        out[tier] = {"state_bytes": got, "ms_per_step": 1e3 * wall / ADAM_XL_K,
                     "peak_gib": peak / 2**30, "losses": losses}
        log(f"[adam] GPT-3 XL widths x {ADAM_XL_CFG['num_hidden_layers']} "
            f"layers, {ADAM_XL_BATCH} x {ADAM_XL_SEQ}, O2 bf16, {tier} tier "
            f"{kw}: optimizer state {got} bytes (= the formula), "
            f"{out[tier]['ms_per_step']:.2f} ms/step, peak "
            f"{out[tier]['peak_gib']:.2f} GiB above the allocation before "
            f"the calls (the bf16 model's), losses "
            f"{[round(v, 4) for v in losses]}")
        del model, opt, step
        torch.cuda.empty_cache()
    return out


def phase_generate(device) -> dict:
    """GPT-2-small at full width and depth (float32, random weights from
    a seed): ``generate`` of GEN_NEW tokens after a GEN_PROMPT-token
    prompt for GEN_BATCH rows, greedy and then sampled (top-k, top-p,
    temperature). Each greedy token is the argmax of a full
    teacher-forced forward over the generated sequence, outside counted
    near-ties (the two best logits closer than NEAR_TIE); the sampled run
    repeats bit for bit from its seed. Reports ms/token."""
    cfg = GPTConfig(**{**TRAIN_CFG, "loss_chunks": 1})
    model = GPTForCausalLM(cfg, device=device, seed=0)
    g = torch.Generator(device=device).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                           generator=g, device=device)
    out, ms = {}, {}
    for label, kw in (("greedy", {}), ("sampled", GEN_SAMPLING)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = model.generate(prompt, max_new_tokens=GEN_NEW, **kw)
        torch.cuda.synchronize()
        ms[label] = 1e3 * (time.perf_counter() - t0) / GEN_NEW
        out[label] = toks
    if out["greedy"].shape != (GEN_BATCH, GEN_PROMPT + GEN_NEW):
        raise AssertionError(f"generate shape {tuple(out['greedy'].shape)}")
    model.eval()
    with torch.no_grad():
        logits = model(out["greedy"][:, :-1])[:, GEN_PROMPT - 1:].float()
    top2 = torch.topk(logits, 2, dim=-1)[0]
    gap = (top2[..., 0] - top2[..., 1])
    picked = out["greedy"][:, GEN_PROMPT:]
    best = logits.argmax(dim=-1)
    differ = picked != best
    ties = int((differ & (gap < NEAR_TIE)).sum().item())
    bad = int((differ & (gap >= NEAR_TIE)).sum().item())
    if bad:
        raise AssertionError(f"generate: {bad} greedy tokens are not the "
                             "teacher-forced argmax (no near-tie)")
    again = model.generate(prompt, max_new_tokens=GEN_NEW, **GEN_SAMPLING)
    if not torch.equal(again, out["sampled"]):
        raise AssertionError("generate: a sampled run did not repeat from "
                             "its seed")
    near = int((gap < NEAR_TIE).sum().item())
    log(f"[generate] GPT-2-small (12 layers, float32), batch {GEN_BATCH}, "
        f"prompt {GEN_PROMPT}, {GEN_NEW} new tokens: greedy "
        f"{ms['greedy']:.2f} ms/token, sampled {GEN_SAMPLING} "
        f"{ms['sampled']:.2f} ms/token; every greedy token the "
        f"teacher-forced argmax ({near} near-ties < {NEAR_TIE}, {ties} of "
        f"them decided the other way); the sampled run repeated bit for "
        "bit")
    del model
    torch.cuda.empty_cache()
    return {"ms_per_token": ms, "ties": ties}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()
    old_fwd, old_ragged, old_decode, old_text = None, None, None, {}
    argv = sys.argv[1:]
    for path in (argv[i + 1] for i, a in enumerate(argv[:-1])
                 if a == "--old-source"):
        with open(path) as f:
            text = f.read()
        if "#define RAGGED_ATTENTION_ENTRY" in text:
            old_ragged = path
            old_text.update(old_ragged_sources(text))
        elif 'extern "C" int paged_attention_f32' in text:
            old_decode = path
            old_text["paged_attention_old"] = inline_includes(
                text, beside=Path(path).parent)
        else:
            old_fwd = path
            old_text["flash_fwd_f32_old"] = text
    phase_build(triple_op(), old_text)
    log(f"[card] {card_identity()}")
    errors = phase_kernels(device)
    # the narrow-scale ragged pair and the int8 weight matmul
    narrow_errors = phase_narrow_kernels(device)
    int8_times = phase_int8_matmul(device)
    per_tier_errors = phase_per_tier_kernels(device)
    flash_errors = phase_flash(device)
    dropout_errors = phase_dropout_kernel(device)
    launches: dict = {}

    # the float path at GPT-2-small width, unsplit and split
    gpt2 = TorchLM(GPT2_SMALL, init_lm_params(GPT2_SMALL, seed=0,
                                              device=device), device=device)
    phase_step_float(device, gpt2.params)
    reqs = requests_gpt2(7)
    outs = {}
    for split in (0, SPLIT):
        got = drive_path(f"GPT-2-small float split {split}", gpt2, reqs,
                         pa.kernel_name(torch.float32, split > 0),
                         split=split, min_prefix_pages=256 // PAGE,
                         rerun=split == 0)
        launches.update(got[0])
        outs[split] = got[3]
    del got
    log_split_agreement("GPT-2-small float", reqs, outs)

    # the fourth slice's main path: speculative decoding on the engine,
    # then the per-tier graphs through the decode and mixed kernels
    spec_reqs = requests_spec()
    got, teacher, diverge = phase_spec_engine(gpt2, spec_reqs)
    launches.update(got)
    launches.update(phase_per_tier(gpt2, spec_reqs, teacher, diverge))
    # this slice's: priority admission, preemption through the host swap
    # tier, tenant quotas and deadlines, at async depth 1 with graphs on
    phase_preempt_swap(gpt2)
    # this slice's: the journal's kill and restore, the device-fault
    # boundary under seeded NaN rows and dispatch faults, and brownout
    phase_faults_journal(gpt2)
    del gpt2
    torch.cuda.empty_cache()

    # the main path: GPT-3 XL widths, full depth, int8 KV + int8 weights
    xl = TorchLM(GPT3_XL, init_lm_params(GPT3_XL, seed=0, device=device),
                 device=device).quantize_weights()
    torch.cuda.empty_cache()
    phase_step_quant(device, xl.params)
    reqs = requests_long(11, GPT3_XL.vocab)
    int8 = QuantConfig(kv="int8", weights="int8")
    outs, ms = {}, {}
    for split in (SPLIT, 0):
        # the engine the call also returns (with its model and KV pages)
        # must not outlive this path
        got = drive_path(
            f"GPT-3 XL int8 KV + int8 weights, "
            f"{f'split {split}' if split else 'unsplit'}", xl, reqs,
            pa.kernel_name(torch.int8, split > 0), int8, split, CHUNK,
            min_prefix_pages=512 // PAGE, rerun=split > 0)
        launches.update(got[0])
        ms[split], outs[split] = got[1], got[3]
    del got
    ms_split, ms_unsplit = ms[SPLIT], ms[0]
    log_split_agreement("GPT-3 XL int8", reqs, outs)
    log(f"[engine] GPT-3 XL int8 ms/step: split {SPLIT} {ms_split:.2f}, "
        f"unsplit {ms_unsplit:.2f} (warm split run vs the unsplit run "
        "that followed it)")
    # this slice's main path: the same traffic through the async
    # pipeline at depths 0, 1 and 2, CUDA graphs off and on
    batches = [requests_long(s, GPT3_XL.vocab) for s in (11, 13, 17)]
    phase_async_serving(xl, batches)
    # this slice's main path: the same engine at depth 1 with graphs,
    # observability on and off
    phase_observability(xl, batches)
    # quantized serving, the rest: bfloat16 scale pools on the main path,
    # the int8 weight matmul off and on, then the replicated fabric
    launches.update(phase_narrow_serving(xl, reqs, outs[SPLIT])["launches"])
    wm = phase_weight_matmul(xl, batches)["launches"]
    launches.update({k: wm[k] for k in (i8.INT8_MATMUL_KERNEL,
                                        i8.QUANTIZE_ROWS_KERNEL)})
    phase_fabric(xl)
    if "--profile" in sys.argv[1:]:
        phase_profile(xl, reqs)
    del xl
    torch.cuda.empty_cache()

    # fp8 pages on the engine path: GPT-3 XL widths, four layers
    xl4 = TorchLM(GPT3_XL_4L, init_lm_params(GPT3_XL_4L, seed=1,
                                             device=device), device=device)
    fp8 = QuantConfig(kv="fp8", weights="int8")
    outs = {}
    for split in (SPLIT, 0):
        # the engine the call also returns (with its model and KV pages)
        # must not outlive this path into the training phases
        got = drive_path(f"GPT-3 XL widths, 4 layers, fp8 KV, split "
                         f"{split}", xl4, reqs,
                         pa.kernel_name(torch.float8_e4m3fn, split > 0),
                         fp8, split, CHUNK, min_prefix_pages=512 // PAGE)
        launches.update(got[0])
        outs[split] = got[3]
    del got
    log_split_agreement("GPT-3 XL fp8", reqs, outs)
    del xl4
    torch.cuda.empty_cache()

    # training, the main path of this slice: parity at 2 layers in
    # float32, then bench.py's configuration
    phase_train_parity(device)
    torch.cuda.empty_cache()
    train = phase_train(device, "--profile" in sys.argv[1:])
    launches.update(train["launches"])
    torch.cuda.empty_cache()
    # the float32 kernels at full width: the training path without AMP
    launches_f32 = phase_train_f32(device)["launches"]
    torch.cuda.empty_cache()
    # training as users configure it, this slice's main path: dropout
    # through its kernel, an LR schedule and clipping; then float16 O2
    # with a GradScaler, the remat policies, Adam's low-memory tiers and
    # incremental decode
    dropout_main = phase_train_dropout(device, train)
    fp16 = phase_train_fp16(device)
    torch.cuda.empty_cache()
    phase_remat(device)
    phase_adam_lowmem(device)
    phase_generate(device)

    # the Paddle-API core, the main path of this slice: the custom ops
    # and the user kernel, then ResNet-50 through Layer, Momentum, AMP O2
    # and TrainStep
    paddle.set_device(device)
    core = phase_custom_ops(device)
    phase_resnet_parity(device)
    torch.cuda.empty_cache()
    phase_resnet_train(device, "--profile" in sys.argv[1:])
    torch.cuda.empty_cache()

    if old_ragged is not None:
        old_ragged = (old_ragged, {
            entry: _build.load_source(f"{lib}_old", old_text[f"{lib}_old"])
            for lib, entry, _ in pa._LIBS.values()})
    rows = phase_times(device, launches, errors, old_ragged)
    rows += narrow_rows(device, launches, narrow_errors)
    rows += int8_rows(int8_times, launches)
    if old_decode is not None:
        old_decode = (old_decode, _build.load_source(
            "paged_attention_old", old_text["paged_attention_old"]))
    rows += per_tier_rows(device, launches, per_tier_errors, old_decode)
    if old_fwd is not None:
        old_fwd = (old_fwd, _build.load_source(
            "flash_fwd_f32_old", old_text["flash_fwd_f32_old"]))
    rows += flash_rows(device, launches, flash_errors, launches_f32, old_fwd)
    rows += flash_rows_f16(device, fp16["launches"], flash_errors)
    rows.append(dropout_row(dropout_times(device),
                            dropout_main["launches"][dk.KERNEL_NAME],
                            dropout_errors["max_abs_err"]))
    rows.append(triple_row(core))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    # the card's name and power limit, exactly as nvidia-smi prints them
    log(card_identity())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
