#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

  python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi), the kernels'
   build from ``src/repro_torch/csrc`` (one nvcc per source, in parallel),
   with ptxas' register, spill and wgmma-serialisation (C7515) lines, and
   the flash forward's and the backward dQ and dK/dV kernels' registers,
   shared memory and spills by head dim (64, 80, 128; the backward's tiles
   held to the host models');
2. kernel matrices, each CUDA kernel against its plain PyTorch version on
   the card: the paged kernel (B1) over orders x GQA x chunk widths x page
   sizes x windows, with ragged q_lens, a free row and a shuffled block
   table, and launches of the wide width whose rows are verification
   chunks (q_len 2-8) beside q_len 1 and 0 rows, each case launched again recording its walk, which must equal
   the host model (``paged_decode_walks``) with the first launch's bits; the flash forward (B2) over orders x causal x windows x GQA x
   head dims (64, 80, 96, 128) x lengths, o and lse, a bitwise repeat, and the
   KV-tile walk each work item recorded held to the host model of the
   persistent schedule (``fwd_walks``); the contiguous decode (B3) over
   orders x GQA x windows x chunks x head dims (64, 80, 96, 128) with ragged
   lengths and a row of length 0; the fused backward (B4 delta, B5 dQ, B6
   dK/dV) over orders x causal x windows x GQA x head dims (64, 80, 96, 128) x
   lengths (Sq != Skv too), with exact zeros where nothing is seen, both recorded walks
   held to the host models of the persistent schedules (``fwd_walks``,
   ``dkv_walks``)
   and a bitwise repeat; the SSD scan (B7) over state
   dims x heads x batch x lengths x initial states, with two chained calls
   against one, a bitwise repeat, and deliberately wrong variants that must
   fail its limits;
3. main paths on full-width deepseek-7b (random weights from a seed):
   served by the continuous ServeEngine, every mixed step a replay of one
   of its two captured CUDA graphs (width 1 and the chunk width), with
   ``paged_decode`` launches == layers x mixed steps; then the same
   requests through new continuous engines with online order adaptation
   (A8): (a) its LLC model at the card's L2, (b) at a capacity small
   enough to switch (it must), (c) the fixed order, (d) (b)'s switches
   forced with the controller's decisions replaced, (e) (d) with a wrong
   page walk from the first switch on; (b) must equal (d) to the bit, every
   run keep two step graphs and launch B1 layers x mixed steps, a stream
   that (b) and (c) make differently must be tied there to bf16's
   resolution, (b)'s logits stay within ADAPT_SHIFT_LIMIT of (c)'s until
   then, and (e)'s exceed it; then by the static
   ServeEngine (the default scheduler), every decode step a replay of its
   one captured graph, with ``flash_fwd`` launches == layers x prefills,
   ``contig_decode`` launches == layers x decode steps and no
   ``paged_decode`` launch (a replay counts the launches its capture
   issued; steps are counted from the engine's spans and stats); each
   captured step then replayed once against the same step run eagerly on
   the same inputs and state, logits and every cache or page written equal
   to the bit; then with int8 KV caches (A5) through both engines (B1 and
   B3 reading the caches dequantized to bf16 inside the captured steps):
   every request ok, replays equal to eager steps int8 pages and scale
   planes included, the launch counts above, the caches under
   INT8_BYTES_LIMIT of bf16's bytes, the first step's logits within
   INT8_REL_LIMIT of the bf16 run's and, with the scales dropped, beyond
   it; then optimistic admission (A9) on a pool of OPT_POOL_PAGES pages,
   twice on one engine: preemptions and restores, the rerun equal to the
   bit, flips against the main path tied to bf16's resolution; then
   injected faults (a step failure retried once, equal to the main path
   to the bit; one failing twice, its rows failed; a pool exhaustion and a
   cancel); no run without an injected fault may show a step retry or a
   failed request; then the host KV tier (A10): the same requests on the
   optimistic 30-page pool over a host tier, bf16 and int8 pages, each
   twice: spills and resumes, each resumed slot's pages equal to the bit
   to what it held before its spill, fetches == hits + wasted, the bytes
   moved == pages x a page row's bytes, the rerun equal to the bit, flips
   tied; dropped fetches (a late resume) and stalled spills (preemption
   instead); then speculative decoding (A11), greedy, K 4, with the
   n-gram drafter and the target drafting for itself (its own pool and
   two graphs), each twice: drafts accepted + rolled back == drafted, the
   target's two graphs, B1 layers x (target + drafter) steps, the rerun
   equal to the bit, flips tied, and a ladder shifted by one position
   caught by the tie rule; then the main path sharded (A14): the same
   continuous engine with ``mesh=make_local_mesh(1, 1)`` (a 1x1
   DeviceMesh over NCCL, the params DTensors on their ``dist.sharding``
   specs, the kernels on each rank's local block) serving the 12
   requests: streams equal to the main path's to the bit, B1 30 a mixed
   step, every step a replay equal to the eager step; and the static
   engine on the same mesh: streams equal to the static path's, B2 30 a
   prefill, B3 30 a decode step, the decode step's replays equal to the
   eager step; then, with the
   serving weights released, the MoE family (A13): ``ops.ragged_dot`` (one ``grouped_mm``, the
   counterpart of XLA's ``ragged_dot``; a library call, not a kernel of
   this repository) against its plain masked products at olmoe-1b-7b's
   and mixtral-8x7b's expert shapes (a narrow step's, a wide step's and a
   prefill group's rows), empty groups included, within MOE_MATRIX_TOL and
   a control with every group boundary moved one row beyond it, each
   shape also with sizes summing to less than its rows (those rows zero
   in both), each shape's time beside its bound; then full-width olmoe-1b-7b (random
   weights from seed 0) serving the same requests continuously (B1 and
   the grouped products in both captured mixed-step graphs) and statically
   (B2 prefill, B3 decode): every request ok, B1/B2/B3 16 x steps,
   ``ragged_dot`` 3 x 16 x forward steps, replays equal to eager, a second
   continuous run equal to the first, and the first mixed step's and the
   first prefill's logits within MOE_LOGITS_TOL of the plain versions with
   a router moved past its top k beyond it; then the enc-dec and VLM
   families (A13) at full width, random weights from seed 0:
   seamless-m4t-medium (12 + 12 layers, d 1024, 16 heads of 64) and
   phi-3-vision-4.2b (32 layers, d 3072, 32 heads of 96), each serving the
   12 requests through the static engine with the reference's zero source
   or prefix embeddings (two groups of other buckets, one captured decode
   step): every request ok, ``flash_fwd`` == 36 (enc-dec: encoder, self,
   cross) or 32 x prefills, ``contig_decode`` == 24 (self and cross) or 32
   x decode steps, the replay equal to the eager step; since the stubs
   leave the encoder, the cross attention and ``vision_proj`` unused, a
   direct prefill (and the enc-dec's decode step) on seeded random
   embeddings held to the plain versions within FAMILY_LOGITS_TOL, with
   wrong controls (the cross K/V of another row, the self length as the
   cross length, ``vision_proj`` dropped) beyond it; then each trained 4
   adamw_factored steps of 4 x 1024 (the enc-dec with a random source of
   1024 frames, the VLM with a random prefix of 256 before 768 tokens):
   ``flash_fwd`` 2 x attentions x steps and each backward kernel
   attentions x steps (B2, B4-B6 at D 96 for the VLM), step 0 within the
   training limits of the plain versions, a falling loss, a peak under 80
   GB; then olmoe-1b-7b trained the same way (A12: the capacity path's
   (E, C, d) buffer, ``index_add`` dispatch and ``bmm`` products; B2 and
   B4-B6 at D 128): launches from the code, step 0 within the training
   limits of the plain versions with the router's softmax dropped beyond
   them, the aux loss above 0, a falling loss, its peak printed; then
   deepseek-7b trained for 4 adamw_factored steps (batch 4 x 1024, remat full), with
   ``flash_fwd`` launches == 2 x layers x steps (forward and remat
   recompute) and 120 of each backward kernel, a falling loss, and step 0
   held to the plain attention on the same weights; then sharded training
   (A14): deepseek-7b at full width and SHARDED_TRAIN_LAYERS layers, 2
   steps of 2 microbatches, unsharded and on the 1x1 NCCL mesh from the
   same weights and batches (losses, gradient norms and params equal to
   the bit, the same launches), and ``reduce_grads_compressed`` on one
   gradient leaf equal to its plain result to the bit; then, the NCCL
   group left, the dry-run (``launch.dryrun``) on fake process groups:
   deepseek-7b decode_32k on the 16x16 mesh, its train_4k extrapolated
   from depth 1 and 2 and held exactly to a full-depth trace (flops), its
   useful ratio above DRYRUN_USEFUL_MIN (a per-rank count), reduced
   olmoe-1b-7b on a (4, 2) mesh, every cell ok; the sharded-train step
   traced on a fake 1x1 mesh, its argument bytes equal to the card's state
   and batch exactly and its argument + temp bytes beside the card's
   ``max_memory_allocated``, the real step's MFU at most 1, the card's
   memory and shared memory an SM against ``analysis.constants``; then
   the four examples through their ``main`` (quickstart: B2 in both
   orders and its recorded walks; train_lm: 20 steps, B2 and B4-B6 8 x
   steps, a falling loss; serve_lm: full-size deepseek-7b continuously, 12
   requests, B1 30 x (mixed steps + warm-ups); sawtooth_analysis
   --quick). Then small bf16 models
   whose logits (serving) and losses (training) with the kernels must agree
   with the plain versions', and ``run_training`` crashed at a step and
   resumed from its checkpoint against an uninterrupted run. With
   ``--profile`` half of each serve path's requests and one training step
   run once more under torch.profiler, which gives the device's busy and
   idle share and its time by kind of kernel. Then full-width mamba2-130m
   (the SSM family) and zamba2-2.7b (the hybrid: Mamba-2 layers and a
   shared attention block of head dim 80 every 6 layers), random weights
   from seed 0, each serving the same 12 requests through the static
   ServeEngine, with ``ssd`` launches == layers x prefills (zamba2 also
   ``flash_fwd`` == 9 x prefills and ``contig_decode`` == 9 x decode
   steps), each decode step a replay of the engine's one graph, held to the
   eager step to the bit as above, and the first prefill's logits held to
   the plain versions'; then both trained at full width for 4
   adamw_factored steps of batch 4 x 1024 (remat full): ``ssd`` == 2 x
   layers x steps (forward and remat recompute; the SSD's backward is the
   plain chunked scan under autograd, as in the reference, its share of
   step 0's gradient pass read with CUDA events), zamba2 also ``flash_fwd``
   == 2 x 9 x steps and each backward kernel == 9 x steps at head dim 80,
   nothing else; step 0 held to the plain versions on the same weights and
   batch, mamba2 with B7's decays dropped beyond that limit, zamba2's
   shared attention weight gradients held to the plain backward on B2's
   residuals with the two wrong backwards beyond, and zamba2 under remat
   "dots" held to "full" (both peak memories printed); a falling loss and
   a peak under 80 GB; last, a step with an ``.item()`` inside, whose
   capture must raise;
4. kernel times at the main paths' shapes (B1: one narrow and one wide
   step; B2: the second prefill group, at head dim 128 and at zamba2's 80,
   and the training shape with lse, each in the sawtooth and the cyclic
   order, and an informational long shape, B 1 x 16384 positions, whose K
   and V exceed the L2 cache, phi-3-vision's prefill at head dim 96 and
   seamless's encoder (16 heads of 64, non-causal); B3: the static decode
   steps at head dim 128, 80 and 96, and seamless's cross decode; B4-B6:
   the training shape, at head dim 128, at zamba2's 80 and at
   phi-3-vision's 96 (B2 with lse beside), B5 and B6 also in the sawtooth
   and the cyclic order, and the three back to back against SDPA's
   backward, read alike and in turns, at the training shape and at the
   informational long shape; B7: the second prefill group of mamba2 and of
   zamba2): the kernel, its bound, the plain version and one library call
   where there is one (SDPA's backward for B4-B6 together; none for B7);
   B1's, B3's and B7's launch attributes (registers, spill, shared memory,
   cluster size, CTAs), B1's and B3's two-step sawtooth/cyclic readings;
   and, informational,
   B1 and B3 at one sequence of 8187 positions at every cluster size;
   then the walks B2 and B6 take, played through an LRU model of the
   card's L2 (and of half of it) in the sawtooth and the cyclic order,
   modeled miss, cold and non-compulsory bytes beside each one's time;
5. a JSON line of the library calls the main paths count (the grouped
   product), the JSON line of kernels, then the last line
   ``{"ok": true, "device": {...}}``.

It needs a GPU (``torch.cuda.is_available()``) and the repository's ``src``
beside it, and exits non-zero without either. It never runs on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_TOL = 2e-2        # abs, bf16 outputs vs the plain version in f32
LSE_TOL = 2e-3           # abs, the flash forward's float32 lse
SMALL_MODEL_TOL = 5e-2   # abs on logits of the small bf16 models
# The backward kernels against the plain backward in float32 on the same
# bf16 inputs, as max-abs error over max |plain|: P and dS are rounded to
# bf16 before their products (2^-9 relative each, as the TPU kernels do)
# and the gradients are written in bf16 (2^-9 again).
BWD_TOL = 2e-2
DELTA_TOL = 1e-4         # delta: float32 sums of the same products in another order
# Full-width training step 0, kernels against the plain attention (impl
# torch, float32 scores) on the same bf16 weights and batch. The loss and
# the global gradient norm (dominated by the embedding and head) read
# 5.2e-4 and 7.0e-5 (PERF.md, PR 13); the limits are about ten times that.
# Neither can see a wrong backward: the loss is the forward's.
TRAIN_LOSS_TOL = 5e-3
TRAIN_GNORM_RTOL = 1e-3
# What can: the gradients of the attention weights (wq, wk, wv, wo of the
# first and the last layer), each as ||diff|| over ||plain|| (Frobenius).
# The kernels read at most 3.21e-2 (wq and wk: at random init attention is
# near uniform, so dS = P (dP - delta) cancels, and the bf16 rounding of P
# and O, which the plain version does not do, shows there). Two
# deliberately wrong backwards built around the kernels in this run
# (_grad_control) read at most 1.0 (dK zeroed) and 4.44e-2 (dQ, dK and dV
# rounded to float8); the limit lies between, and each control must exceed
# it on some leaf (PERF.md, PR 13).
ATTN_GRAD_TOL = 3.8e-2
# Crash + resume against an uninterrupted run, in one process: the
# checkpoint is exact (bf16 saved as its bits) and the kernels and the
# optimizer deterministic, so the losses agree to the bit (every reading so
# far); the limit is two float32 ulps of a loss near 7.
LOOP_TOL = 1e-6
# The small bf16 model's 5 training steps, kernels against the plain
# versions: losses read 6.5e-4 apart (PERF.md, PR 13). This checks the
# steps' plumbing; the backward's accuracy is ATTN_GRAD_TOL's to check.
SMALL_TRAIN_TOL = 5e-3
# Full-width mamba2-130m and zamba2-2.7b training (phase_train_ssm) hold
# step 0 with the kernels to the plain versions (ssd_impl and attn_impl
# "torch") on the same weights and batch within the deepseek phase's
# TRAIN_LOSS_TOL and TRAIN_GNORM_RTOL, unchanged. Both sides run the scan in
# float32 and round y to bf16 (B7 with float32-accurate split-bf16
# products), so they differ by where bf16 activations round through 24 and
# 54 layers: their first-prefill logits read 2.7e-2 and 4.7e-2 apart (max
# |diff| over max |plain|, PERF.md §6), and a mean over 4,096 tokens'
# cross-entropy averages most of that out (1e-3 or less expected, PERF.md
# §6). B7 with its decays dropped must move the loss beyond
# TRAIN_LOSS_TOL. remat "dots" against "full" within the same limits.
# zamba2's shared attention weights' gradients against the plain attention
# (attn_impl "torch", B7 on both sides) read 4.2e-2 to 5.1e-2 on every leaf,
# wo included, whose gradient no attention backward at its own site forms:
# the plain forward keeps P in float32 where B2 rounds it to bf16, and that
# difference compounds through the 9 uses of the shared block and the 54
# Mamba layers; float8 dQ/dK/dV read 4.2e-2 to 5.6e-2 there, so that
# comparison cannot tell a wrong backward (PERF.md §6). The backward
# kernels are therefore held to the plain backward run on B2's own forward
# residuals (_plain_backward: the same forward bits on both sides, as the
# deepseek phase's comparison has the same everything but the attention);
# the fully plain reading is printed beside. There the kernels read at most
# 1.79e-2 and the controls 1.0 (dK zeroed) and 2.95e-2 (float8), under
# ATTN_GRAD_TOL: the float8 error averages over the 9 sites' 4,096
# positions each. So the hybrid's limit lies between the two, as
# ATTN_GRAD_TOL was set for deepseek (their geometric mean), and each
# control must exceed it on some leaf (PERF.md §6). The enc-dec's and the
# VLM's training (phase_train_family) is held to the same comparison and
# limit, for the same reason: against the plain attention seamless's
# kernels read up to 0.145 and float8 0.153, phi-3-vision's 4.87e-2 and
# 5.62e-2; on B2's residuals the kernels read 2.07e-2 and 1.91e-2, float8
# 5.5e-2 and 3.46e-2 (under ATTN_GRAD_TOL), dK zeroed 1.0 (PERF.md, PR 26).
RESIDUAL_ATTN_GRAD_TOL = 2.3e-2
TRAIN_MEM_LIMIT_GB = 80.0
# sharded-train runs deepseek-7b at full width but 16 of its 30 layers: two
# microbatches keep a float32 accumulator of every gradient (4 bytes a
# parameter) beside the step's own gradients, moments and params, which at 30
# layers (6.9 B params) comes within a few GB of the card's 80.
SHARDED_TRAIN_LAYERS = 16
# The dry-run's full-depth deepseek-7b train_4k trace on the 16 x 16 mesh
# (remat full, the plain attention materializing every score, the vocab
# products replicated over "model" by the "logits" rule) reads a useful
# ratio of 0.321 (a CPU trace, PR 28: flops are counted from shapes). A
# count of the global op in place of the rank's would read 1/256 of it.
DRYRUN_USEFUL_MIN = 0.1
# The reduced olmoe cell's batch in phase_dryrun: the reduced shape's batch
# of 2 does not divide the (4, 2) mesh's data axis, and on such a batch the
# card's torch 2.11 DTensor refuses the MoE step's views (ROADMAP §C, open);
# 8 gives each data rank 2 sequences, as the production cells do.
DRYRUN_SMALL_BATCH = 8
# The card shows less than its data-sheet 80 GB (``CHIP_HBM_BYTES``): the
# driver and ECC keep some; 5% is ample.
HBM_VISIBLE_MIN = 0.95
# train_lm's steps in phase_examples (the issue's 20; the loss must fall).
EXAMPLE_TRAIN_STEPS = 20

# B7 (the SSD scan) against its plain version (ssd_chunked in float32 on
# the same bf16 inputs), each as max-abs error over max |plain|. y is
# written in bf16, whose rounding alone reads up to 3.5e-3 over the 96-case
# matrix; the limit is about three times that. The final state is float32
# sums of the same products in another order: 1.3e-5 at most; the limit is
# about eight times that, below the 2.7e-4 of the state rounded to bf16
# between chunks. Of the deliberately wrong variants (_SSD_CONTROLS), the
# dropped decays read 5.6 (y) and 11.3 (state), the state not carried 0.98
# and 0.14 (PERF.md, §6).
SSD_Y_TOL = 1e-2
SSD_STATE_TOL = 1e-4
# Full-width mamba2-130m and zamba2-2.7b, the first prefill's logits with
# the kernels against the plain versions (ssd_impl and attn_impl "torch") on
# the same weights and tokens, as max-abs difference over max |plain|. The
# bf16 activations of 24 and 54 layers round where the two differ: 2.7e-2
# and 4.7e-2 on the H100 (PERF.md, §6); the limit is twice the larger. The
# script also prints each one's distance from a float32 forward of the same
# weights, the rounding that bf16 activations cost at this depth. The same
# prefill runs with each wrong B7 of _SSD_CONTROLS in the kernel's place:
# decays dropped read 1.40 and 1.30, so the limit lies between, and that
# variant must exceed it. The state not carried between chunks (3.8e-2 and
# 4.8e-2) and rounded to bf16 (3.3e-2, 4.0e-2) read like the kernels here;
# only the B7 matrix's limits tell them apart (PERF.md, §6).
SSM_LOGITS_TOL = 1e-1
_SSM_CONTROLS_CAUGHT = ("decay_dropped",)

# The MoE's grouped product (``ops.ragged_dot``: ``grouped_mm`` on the
# card, the counterpart of the reference's ``jax.lax.ragged_dot``, which XLA
# compiles outside any Pallas kernel) against its plain masked products on
# the same bf16 inputs, as max |diff| over max |plain|: both accumulate in
# float32 and round the output once to bf16 (2^-8 relative), so the limit
# is about two roundings. The same call with every group boundary moved one
# row must exceed it.
MOE_MATRIX_TOL = 1e-2
# Full-width olmoe-1b-7b, the first prefill's and the first mixed step's
# logits with the kernels (B2 or B1, grouped_mm) against the plain versions
# (attn_impl "torch", the masked grouped product) on the same weights and
# inputs, as max |diff| over max |plain|. The grouped products agree to the
# bit or one bf16 rounding; the attention kernels round where the plain
# versions do not, and through 16 layers a token whose k-th and (k+1)-th
# router logits lie that close picks another expert. They read 4.8e-2
# (the prefill's last positions) and 8.7e-2 (all 2,048 positions of the
# wide first step) on the H100 (PERF.md §6); the limit is about
# twice the larger. Each token routed to the k experts after its top k
# reads 0.52 and 0.59 there, and must exceed it.
MOE_LOGITS_TOL = 2e-1
MOE_ARCH = "olmoe-1b-7b"

# The enc-dec and VLM families (A13): seamless-m4t-medium and
# phi-3-vision-4_2b at full width. The serve engine feeds the reference's
# stubs, zero source and prefix embeddings, under which the encoder, every
# cross-attention and ``vision_proj`` leave the streams untouched; so each
# phase also runs ``lm.prefill`` (and, for the enc-dec, one
# ``lm.decode_step``) directly on seeded random embeddings, the kernels
# against the plain versions (attn_impl "torch") on the same weights and
# inputs: the logits as max |diff| over max |plain|, and for the VLM the
# KV caches too (its prefix positions, written from the projected
# prefix). The limit is the SSM paths': bf16 attention that rounds P where
# the plain version does not, through 24 and 32 layers. Deliberately wrong
# controls must exceed it: the enc-dec's decode step with the cross K/V of
# another batch row, and with B3 given the self cache's length as the
# cross length; the VLM's prefill with ``vision_proj`` dropped (the prefix
# embeddings used unprojected).
FAMILY_LOGITS_TOL = 1e-1
ENCDEC_ARCH = "seamless-m4t-medium"
VLM_ARCH = "phi-3-vision-4_2b"
# The random source of the enc-dec's direct check: 128 frames, a length
# other than the target prompt's, so the cross attention is Sq != Skv.
ENCDEC_SRC_LEN = 128
# The VLM's prefix in its direct check and in training: the reference's
# training rule, min(n_prefix_embeds, max(S // 4, 1)) = 256 at S 1024.
VLM_TRAIN_PREFIX = 256

# The adaptive continuous path (phase_adapt_path): full-width deepseek-7b
# through the continuous engine with online order adaptation, on the main
# path's 12 requests. Run (b) models an LLC of ADAPT_SMALL_CAPACITY bytes, a
# cut far under the card's 50 MiB L2, so that the controller switches on
# this traffic; run (a) models the card's own L2.
ADAPT_SMALL_CAPACITY = 131_072
# Run (d) replays (b) with the controller's decisions forced at the steps
# (b) recorded: the same staged inputs into the same kernels, so the token
# streams and every logit must be equal to the bit (B1 adds its pages in
# one fixed order per walk, and a replay equals the eager step).
# Against the fixed-order run (c), B1 adds up pages in another order after a
# switch, so a bf16 logit may round one step apart and a near-tied greedy
# token flip: at each stream's first differing token the two runs' top-2
# margins must pass repro_torch.testing.within_tie_rule (the smaller at most
# one bf16 ulp of the top logit, the larger below two), and until that token
# (b)'s logits stay within ADAPT_SHIFT_LIMIT of (c)'s. A deliberately wrong
# walk from the first switch on (run (e): every full page of a row read as
# its first page) must exceed that limit.
ADAPT_SHIFT_LIMIT = 0.5

# int8 KV caches (phase_int8_continuous, phase_int8_static): the first mixed
# step's logits (continuous, at its valid positions) and the first decode
# step's (static) within INT8_REL_LIMIT of the bf16 run's, as max |int8 -
# bf16| over max |bf16| (the limit of the reference's test_kv_cache.py); the
# same step with the scales dropped (each int8 read as its value) must
# exceed it. The caches, payload and scales, under INT8_BYTES_LIMIT of the
# bf16 caches' bytes (one byte a value and a float32 scale a 128-value
# vector: 0.516).
INT8_REL_LIMIT = 0.1
INT8_BYTES_LIMIT = 0.75
# TWO_STEP_TIE: the tie rule at two rounding steps a run (the smaller top-2
# margin at most 2 ulps, the larger below 3), for three cases where a run
# carries two (my chip runs, PR 24: flips read margins of 0 and 2 ulps where
# the tiered bf16 runs held to the main path read 0 and 1). On int8 pages a
# run whose rows move to other steps' widths writes K/V values a bf16 step
# apart, and a value near an int8 rounding boundary then moves its code a
# whole int8 step (the vector's absmax / 127). A run held to another run
# that is itself a step from the main path (the fetch-fault run to the
# un-faulted tiered run) carries both runs' steps. And a speculative run
# computes every verified token in the wide step, both its K/V and its
# logits, where the main path computes them in narrow ones. The logits stay
# within ADAPT_SHIFT_LIMIT until the flip, as every run's; the verification
# ladder shifted by one position must still fail the rule.
TWO_STEP_TIE = 2
# Optimistic admission under real pool pressure (phase_optimistic_path): an
# allocatable pool of OPT_POOL_PAGES pages of 64 positions (every slot's
# worst case is 128) on the main requests: decode growth runs out, and
# victims are preempted and restored by re-prefill (two preemptions in a
# run of the same schedule on the CPU). A restored row's K/V come from a
# wide step where they came from narrow ones, and the batch's rows move to
# other steps' widths, so a bf16 logit may round one step apart: the run is
# held exactly to its own rerun, and to the main path's streams by the tie
# rule at each first difference, its logits within ADAPT_SHIFT_LIMIT of the
# main path's until then.
OPT_POOL_PAGES = 30
OPT_MAX_PREEMPTIONS = 8
# Injected faults (phase_fault_path) on an engine of the main path's
# settings: a device-step failure at mixed step FAULT_STEP, once (retried on
# the same inputs: streams and logits equal to the main path's to the bit)
# and twice (that step's rows fail, the rest serve on); a pool exhaustion
# armed at FAULT_EXHAUST_STEP (a preemption) and a cancel of
# FAULT_CANCEL_RID at FAULT_CANCEL_STEP.
FAULT_STEP = 10
FAULT_EXHAUST_STEP = 20
FAULT_CANCEL_STEP, FAULT_CANCEL_RID = 30, 5
# The host KV tier (phase_tiered_path, phase_tier_fault_path): the optimistic
# pool of OPT_POOL_PAGES pages over a host tier of TIER_HOST_PAGES pages (every
# slot's worst case, so a spill never finds the host full), pages fetched back
# TIER_PREFETCH_DEPTH a step boundary. The schedule does not depend on the
# weights (EOS is never matched): on the CPU the same geometry spills 9 times
# and resumes every slot without a preemption. Spilled rows come back to the
# bit, but the batch's rows move to other steps and widths, so the runs are
# held exactly to their reruns and by the tie rule to the main path (bf16) or
# the int8 continuous run (int8 pages). TIER_FETCH_FAILS fetches are dropped in
# the fault run; a spill stall refuses every spill, and the engine preempts.
TIER_HOST_PAGES = 128
TIER_PREFETCH_DEPTH = 2
TIER_FETCH_FAILS = 3
TIER_COUNTERS = ("tier.spills", "tier.fetches", "tier.prefetch_hits", "tier.prefetch_wasted",
                 "tier.fetch_failures", "tier.spill_bytes", "tier.fetch_bytes")
# Speculative decoding (phase_spec_path): K = SPEC_DRAFT_LEN drafts a decode
# row, greedy, from the n-gram drafter and from the target drafting for
# itself. Verification rows run in the wide step, so a bf16 logit may round
# one step apart from the main path's narrow steps: each run is held exactly
# to its rerun and by the tie rule to the main path. Verifying against the
# target ladder shifted by one position must fail that rule.
SPEC_DRAFT_LEN = 4

# Data-sheet peaks by card name: (bytes/s, dense bf16 flop/s, float32 flop/s
# outside the tensor cores).
_PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H100", 3.35e12, 989e12, 67e12),   # SXM
)


def _port():
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {__file__}")
    sys.path.insert(0, str(src))


def _median_ms(fn, warmup: int = 5, reps: int = 30, batched: bool = True) -> float:
    """Device time of one ``fn()`` (``compare_kernels.median_ms``): batched,
    the median of ``reps`` batches of back-to-back calls timed with CUDA
    events, so the host's enqueue time is not read; otherwise the median of
    ``reps`` single calls, each between two events, which reads the host's
    time as well whenever the queue is empty."""
    from repro_torch.kernels.compare_kernels import median_ms

    return median_ms(fn, warmup=warmup, reps=reps, batched=batched)


def _host_us(fn) -> float:
    """Host time to issue one ``fn()``, in microseconds
    (``compare_kernels.host_us``)."""
    from repro_torch.kernels.compare_kernels import host_us

    return host_us(fn)


def _readings(fns: dict, rounds: int, batched: bool = True) -> dict:
    """``rounds`` readings of each of ``fns`` taken in turns, the order
    reversed every round (A B, B A, A B, ...): ``{name: [ms, ...]}``."""
    names = list(fns)
    runs: dict[str, list] = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            runs[name].append(_median_ms(fns[name], batched=batched))
    return runs


# ---- phase 1 ------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    match = next((m[1:] for m in _PEAKS if m[0] in name), None)
    if match is None:
        raise SystemExit(f"chip_smoke: no data-sheet peaks for {name!r}; add them to _PEAKS")
    bw, peak, peak_f32 = match
    print(f"[device] {name}; bound uses {bw / 1e12:.2f} TB/s, {peak / 1e12:.0f} TFLOP/s bf16 "
          f"dense and {peak_f32 / 1e12:.0f} TFLOP/s float32 (data sheet)")
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    built = cuda_lib.build_all(verbose=True)
    wall = time.perf_counter() - t0
    for kname, info in built.items():
        print(f"[build] {kname}: {info['seconds']:.1f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "entry function", "error",
                                               "warning", "c7515", "setmaxnreg")):
                print(f"[build]   {line.strip()}")
    print(f"[build] all kernels in {wall:.1f} s (parallel nvcc)")
    import ctypes

    from repro_torch.kernels.flash_attention import KERNEL_TILES

    attrs = {}
    for kname, dims in (("flash_fwd", (64, 80, 96, 128)), ("flash_bwd_dq", (64, 80, 96, 128)),
                        ("flash_bwd_dkv", (64, 80, 96, 128))):
        attr_fn = getattr(cuda_lib.load(kname), f"{kname}_attr")
        attr_fn.argtypes, attr_fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
        advisories = sum("C7515" in line for line in built[kname]["log"].splitlines())
        attrs[kname] = {}
        for d in dims:
            vals = (ctypes.c_int * 6)(*([-1] * 6))
            err = attr_fn(d, vals)
            if err:
                raise RuntimeError(f"{kname}_attr({d}) returned cudaError_t {err}")
            rec = {"registers_at_launch": vals[0], "dynamic_smem_bytes": vals[1],
                   "threads": vals[2], "local_bytes": vals[3], "c7515_advisories": advisories}
            if kname != "flash_fwd":  # the backward kernels also report their tiles
                rec["tile"] = [vals[4], vals[5]]
                if tuple(rec["tile"]) != KERNEL_TILES[kname]:
                    raise AssertionError(f"{kname} runs {rec['tile']} tiles; the host models "
                                         f"assume {KERNEL_TILES[kname]}")
            attrs[kname][d] = rec
            print(f"[build] {kname} D{d}: {json.dumps(rec)}")
    c7515 = {k: sum("C7515" in line for line in v["log"].splitlines()) for k, v in built.items()}
    return {"smi": smi, "name": name, "bw": bw, "peak": peak, "peak_f32": peak_f32,
            "flash_fwd_attr": attrs["flash_fwd"], "kernel_attr": attrs, "c7515": c7515,
            "build_seconds": {k: v["seconds"] for k, v in built.items()}}


# ---- phase 2 ------------------------------------------------------------------


def _case(gen, *, b_lens, q_lens, c, hq, hkv, d, page, max_len):
    dev = "cuda"
    b = len(b_lens)
    nb = -(-max_len // page)
    n_pages = b * nb + 1
    bf = torch.bfloat16
    k = torch.randn((n_pages, page, hkv, d), generator=gen, device=dev).to(bf)
    v = torch.randn((n_pages, page, hkv, d), generator=gen, device=dev).to(bf)
    q = torch.randn((b, c, hq, d), generator=gen, device=dev).to(bf)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * nb] + 1
    bt = perm.reshape(b, nb).to(torch.int32)
    lens = torch.tensor(b_lens, dtype=torch.int32, device=dev)
    qls = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    return q, k, v, bt, lens, qls


def _check_kernel(q, k, v, bt, lens, qls, window, group) -> float:
    from repro_torch.core.attention import paged_decode_attention
    from repro_torch.kernels.flash_decode import paged_flash_decode_fwd

    out = paged_flash_decode_fwd(q, k, v, lens, bt, q_lens=qls, window=window, order_group=group)
    ref = paged_decode_attention(
        q.float(), k.float(), v.float(), lens, bt, q_lens=qls, window=window, order_group=group
    )
    torch.cuda.synchronize()
    c = q.shape[1]
    valid = (torch.arange(c, device="cuda")[None, :] < qls[:, None].long())  # (B, C)
    valid &= lens[:, None] > 0
    o = out.float()
    if not torch.isfinite(o).all():
        raise AssertionError("kernel output has non-finite values")
    zero_rows = o[~valid]
    if zero_rows.numel() and zero_rows.abs().max().item() != 0.0:
        raise AssertionError("rows with nothing to attend to are not exact zeros")
    err = (o - ref).abs()[valid].max().item() if valid.any() else 0.0
    _check_paged_walk(q, k, v, bt, lens, qls, window, group, out)
    return err


def _check_paged_walk(q, k, v, bt, lens, qls, window, group, out) -> int:
    """B1 launched again recording its walk: the walk equals the host model
    (``paged_decode_walks`` at the kernel's own split count) and the output
    ``out``'s bits. Returns the pages recorded."""
    from repro_torch.kernels.flash_decode import (
        fold_schedule,
        launch_paged_decode,
        paged_decode_splits,
        paged_decode_walks,
    )

    b, c, hq, _ = q.shape
    page, hkv = k.shape[1], k.shape[2]
    nb = bt.shape[1]
    splits = paged_decode_splits(b, hkv, nb, _sms(), c * (hq // hkv))
    phys, logical = fold_schedule(lens, bt, order_group=group)
    want = paged_decode_walks(logical, lens, qls, c=c, g=hq // hkv, hkv=hkv, page=page,
                              window=window, splits=splits)
    visit = torch.full(tuple(want.shape), -7, dtype=torch.int32, device="cuda")
    again = launch_paged_decode(q, k, v, phys, logical, lens, qls, window=window,
                                visit_out=visit)
    torch.cuda.synchronize()
    if not torch.equal(visit.cpu(), want):
        raise AssertionError("paged_decode's recorded walk differs from paged_decode_walks")
    if not torch.equal(again, out):
        raise AssertionError("paged_decode: two launches differ in their bits")
    return int((want >= 0).sum())


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_kernel_matrix() -> float:
    from repro_torch.core.schedule import Order, resolve_order_group

    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst, n = 0.0, 0
    max_len, hkv, d = 1024, 4, 128
    for page in (64, 512):
        nb = max_len // page
        for g in (1, 4):
            for c in (1, 7, 256):
                b_lens = [1024, 613, 37, 200, 0]
                q_lens = [c, c // 2 + 1, min(c, 37), 0, 0]
                q, k, v, bt, lens, qls = _case(
                    gen, b_lens=b_lens, q_lens=q_lens, c=c, hq=hkv * g, hkv=hkv, d=d,
                    page=page, max_len=max_len,
                )
                for order in Order:
                    group = resolve_order_group(order, 3, nb)
                    for window in (None, 100):
                        err = _check_kernel(q, k, v, bt, lens, qls, window, group)
                        n += 1
                        ok = err <= KERNEL_TOL
                        print(f"[kernel] page={page} G={g} C={c} order={order.value} "
                              f"window={window}: max_abs_err={err:.3e}, walk and repeat "
                              f"{'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(
                                f"paged_decode disagrees with its plain version: "
                                f"{err:.3e} > {KERNEL_TOL}"
                            )
                        worst = max(worst, err)
    # Verification-shaped launches (speculative decoding): rows of q_len 2-8
    # beside q_len 1 and 0 rows inside a launch of the wide width, the tiles
    # B1 takes on its CUDA-core path (n_valid <= 8).
    c = 256
    b_lens = [1024, 613, 37, 200, 300, 5, 64, 0]
    q_lens = [2, 5, 8, 1, 0, 3, 7, 0]
    for page in (64, 512):
        nb = max_len // page
        for g in (1, 4):
            q, k, v, bt, lens, qls = _case(
                gen, b_lens=b_lens, q_lens=q_lens, c=c, hq=hkv * g, hkv=hkv, d=d, page=page,
                max_len=max_len,
            )
            for order in Order:
                group = resolve_order_group(order, 3, nb)
                for window in (None, 100):
                    err = _check_kernel(q, k, v, bt, lens, qls, window, group)
                    n += 1
                    ok = err <= KERNEL_TOL
                    print(f"[kernel] verification rows q_lens={q_lens} page={page} G={g} C={c} "
                          f"order={order.value} window={window}: max_abs_err={err:.3e}, walk "
                          f"and repeat {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"paged_decode disagrees with its plain version on verification "
                            f"rows: {err:.3e} > {KERNEL_TOL}"
                        )
                    worst = max(worst, err)
    print(f"[kernel] {n} cases, worst max_abs_err={worst:.3e} (tol {KERNEL_TOL}); every "
          f"recorded walk equals paged_decode_walks, every repeat the first launch's bits")
    return worst


def _bf16(gen, shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _seen(sq, skv, causal, window):
    """Visibility (Sq, Skv): query row r sees key column c."""
    r = torch.arange(sq, device="cuda")[:, None]
    c = torch.arange(skv, device="cuda")[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device="cuda")
    if causal:
        ok &= c <= r
    if window is not None:
        ok &= c > r - window
    return ok


def phase_flash_matrix() -> float:
    """B2 against its plain version (o on every row that sees a key, lse
    too; rows that see none are exact zeros), a second launch bitwise equal
    to the first, and the KV tiles each work item walked against the host
    model of the persistent schedule (``fwd_walks``: the k-th item of a CTA
    walks ``Traversal.kv_order(q_tile, local_iter=k)``) at the kernel's tile
    sizes, equal as integers."""
    from repro_torch.core.attention import flash_attention
    from repro_torch.core.schedule import Order
    from repro_torch.kernels.flash_attention import (
        FWD_BLOCK_M,
        FWD_BLOCK_N,
        flash_attention_fwd,
        fwd_walks,
        fwd_workers,
        kernel_traversal,
    )

    gen = torch.Generator(device="cuda").manual_seed(4321)
    workers = fwd_workers(torch.device("cuda"))
    b, hkv, sg = 2, 2, 2
    cases = [(s, s, causal, window) for s in (1, 77, 300, 700) for causal in (True, False)
             for window in (None, 100)]
    cases.append((300, 131, False, None))
    worst, n, n_visits = 0.0, 0, 0
    for d in (64, 80, 96, 128):
        for g in (1, 4):
            for sq, skv, causal, window in cases:
                q = _bf16(gen, (b, sq, hkv * g, d))
                k, v = _bf16(gen, (b, skv, hkv, d)), _bf16(gen, (b, skv, hkv, d))
                vis = _seen(sq, skv, causal, window).any(-1)
                errs = []
                for order in Order:
                    tr = kernel_traversal(sq, skv, g, kernel="flash_fwd", order=order,
                                          causal=causal, window=window, snake_group=sg)
                    visit = torch.full((b * hkv, tr.grid_rows, tr.n_kv), -2, dtype=torch.int32,
                                       device="cuda")
                    kw = dict(order=order, causal=causal, window=window, snake_group=sg,
                              return_lse=True)
                    o, lse = flash_attention_fwd(q, k, v, visit_out=visit, **kw)
                    o2, lse2 = flash_attention_fwd(q, k, v, **kw)
                    ro, rl = flash_attention(q.float(), k.float(), v.float(), order=order,
                                             causal=causal, window=window, q_block=FWD_BLOCK_M,
                                             kv_block=FWD_BLOCK_N, snake_group=sg,
                                             return_lse=True)
                    torch.cuda.synchronize()
                    case = (f"D={d} G={g} Sq={sq} Skv={skv} causal={causal} window={window} "
                            f"order={order.value}")
                    if not torch.isfinite(o.float()).all():
                        raise AssertionError(f"flash_fwd non-finite output: {case}")
                    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                        raise AssertionError(f"flash_fwd: two launches differ: {case}")
                    if (~vis).any() and o[:, ~vis].abs().max().item() != 0.0:
                        raise AssertionError(f"flash_fwd rows that see nothing are not zero: {case}")
                    err = (o.float() - ro)[:, vis].abs().max().item()
                    err_lse = (lse - rl)[:, vis].abs().max().item()
                    if err > KERNEL_TOL or err_lse > LSE_TOL:
                        raise AssertionError(f"flash_fwd disagrees with its plain version: {case}: "
                                             f"o {err:.3e} (tol {KERNEL_TOL}), lse {err_lse:.3e} "
                                             f"(tol {LSE_TOL})")
                    want = torch.tensor(fwd_walks(tr, b * hkv, workers), dtype=torch.int32,
                                        device="cuda")
                    if not torch.equal(visit, want):
                        raise AssertionError(f"flash_fwd walked another order than the host "
                                             f"model's: {case}")
                    n_visits += visit.numel()
                    errs.append(err)
                    worst = max(worst, err)
                    n += 1
                print(f"[flash] D={d} G={g} Sq={sq} Skv={skv} causal={causal} window={window}: "
                      f"max_abs_err by order {[f'{e:.2e}' for e in errs]} ok, walk == host "
                      "model, bitwise repeatable")
    print(f"[flash] {n} cases, worst max_abs_err={worst:.3e} (tol {KERNEL_TOL}); "
          f"{n_visits} recorded tile visits equal the host model's ({workers} CTAs)")
    return worst


def _rel_l2(got, want) -> float:
    """||got - want|| over ||want||, Frobenius norms in float32."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp(min=1e-30)).item()


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 when want is all zeros)."""
    scale = want.abs().max().item()
    return (got.float() - want).abs().max().item() / scale if scale else 0.0


def phase_bwd_matrix() -> dict:
    """B4-B6 against the plain backward on the same bf16 inputs, o and lse
    from B2: delta, and dq, dk, dv as max-abs error over max |plain|;
    gradients of rows and KV positions that nothing sees are exact zeros;
    the walks the dQ and dK/dV work items recorded equal the host models
    of the persistent schedules (``fwd_walks`` and ``dkv_walks``: the k-th
    item of a CTA walks ``kv_order(q_tile, local_iter=k)``, resp. streams
    ``stream_sweep(kv_tile, local_iter=k)``) at each kernel's tiles; a
    second run gives equal bits."""
    from repro_torch.core.attention import attention_delta, flash_attention_bwd as plain_bwd
    from repro_torch.core.schedule import Order
    from repro_torch.kernels.flash_attention import (
        BLOCK_M,
        BLOCK_N,
        dkv_walks,
        flash_attention_bwd,
        flash_attention_fwd,
        fwd_walks,
        fwd_workers,
        kernel_traversal,
        launch_flash_bwd_delta,
    )

    workers = fwd_workers(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(8642)
    b, hkv, sg = 2, 2, 2
    shapes = [(77, 77), (300, 300), (700, 700), (300, 131), (131, 300)]
    worst = {"delta": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    n = n_visits = 0
    for d in (64, 80, 96, 128):
        for g in (1, 4):
            for sq, skv in shapes:
                q = _bf16(gen, (b, sq, hkv * g, d))
                k, v = _bf16(gen, (b, skv, hkv, d)), _bf16(gen, (b, skv, hkv, d))
                do = _bf16(gen, (b, sq, hkv * g, d))
                for causal in (True, False):
                    for window in (None, 100):
                        ok = _seen(sq, skv, causal, window)
                        errs = []
                        for order in Order:
                            kw = dict(order=order, causal=causal, window=window, snake_group=sg)
                            case = (f"D={d} G={g} Sq={sq} Skv={skv} causal={causal} "
                                    f"window={window} order={order.value}")
                            o, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
                            tq = kernel_traversal(sq, skv, g, kernel="flash_bwd_dq", **kw)
                            tkv = kernel_traversal(sq, skv, g, kernel="flash_bwd_dkv", **kw)
                            vq = torch.full((b * hkv, tq.grid_rows, tq.n_kv), -2,
                                            dtype=torch.int32, device="cuda")
                            vkv = torch.full((b * hkv, tkv.n_kv, tkv.grid_rows), -2,
                                             dtype=torch.int32, device="cuda")
                            got = flash_attention_bwd(q, k, v, o, lse, do, visit_dq_out=vq,
                                                      visit_dkv_out=vkv, **kw)
                            again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
                            delta = torch.empty_like(lse)
                            launch_flash_bwd_delta(o, do, delta)
                            want = plain_bwd(q.float(), k.float(), v.float(), o.float(), lse,
                                             do.float(), q_block=BLOCK_M, kv_block=BLOCK_N, **kw)
                            torch.cuda.synchronize()
                            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                                raise AssertionError(f"flash_bwd: two runs differ: {case}")
                            for name, x in zip(("dq", "dk", "dv"), got):
                                if not torch.isfinite(x.float()).all():
                                    raise AssertionError(f"flash_bwd {name} non-finite: {case}")
                            dq, dk, dv = got
                            blind_rows, blind_cols = ~ok.any(1), ~ok.any(0)
                            if (blind_rows.any() and dq[:, blind_rows].abs().max().item() != 0.0
                                    or blind_cols.any() and max(
                                        dk[:, blind_cols].abs().max().item(),
                                        dv[:, blind_cols].abs().max().item()) != 0.0):
                                raise AssertionError(f"flash_bwd gradients of what nothing sees "
                                                     f"are not exact zeros: {case}")
                            e = {"delta": _rel_err(delta, attention_delta(o, do))}
                            e.update({name: _rel_err(x, y) for name, x, y in
                                      zip(("dq", "dk", "dv"), got, want)})
                            if e["delta"] > DELTA_TOL or max(e["dq"], e["dk"], e["dv"]) > BWD_TOL:
                                raise AssertionError(f"flash_bwd disagrees with its plain version: "
                                                     f"{case}: {e} (tol delta {DELTA_TOL}, "
                                                     f"grads {BWD_TOL})")
                            walk_q = torch.tensor(fwd_walks(tq, b * hkv, workers),
                                                  dtype=torch.int32, device="cuda")
                            walk_kv = torch.tensor(dkv_walks(tkv, b * hkv, workers),
                                                   dtype=torch.int32, device="cuda")
                            if not (torch.equal(vq, walk_q) and torch.equal(vkv, walk_kv)):
                                raise AssertionError(f"flash_bwd walked another order than the "
                                                     f"host models': {case}")
                            n_visits += vq.numel() + vkv.numel()
                            for key in worst:
                                worst[key] = max(worst[key], e[key])
                            errs.append(max(e["dq"], e["dk"], e["dv"]))
                            n += 1
                        print(f"[bwd] D={d} G={g} Sq={sq} Skv={skv} causal={causal} "
                              f"window={window}: rel err by order {[f'{x:.2e}' for x in errs]} "
                              "ok, walks == host models, bitwise repeatable")
    print(f"[bwd] {n} cases, worst rel err {json.dumps(worst)} (tol delta {DELTA_TOL}, grads "
          f"{BWD_TOL}); {n_visits} recorded tile visits equal the host models' ({workers} CTAs)")
    return worst


def phase_decode_matrix() -> float:
    """B3 against its plain version on rows of positive length; a row of
    length 0 gives exact zeros. S_max 300 is not a multiple of the chunk.
    Each case launches again recording its walk, which must equal the host
    model (``contig_decode_walks`` at the kernel's own split count), with
    the first launch's bits."""
    from repro_torch.core.attention import decode_attention
    from repro_torch.core.schedule import Order
    from repro_torch.kernels.flash_decode import (
        contig_decode_splits,
        contig_decode_walks,
        flash_decode_fwd,
        launch_contig_decode,
    )

    gen = torch.Generator(device="cuda").manual_seed(2468)
    b, hkv, s_max = 5, 2, 300
    lens = torch.tensor([300, 0, 129, 7, 255], dtype=torch.int32, device="cuda")
    ok = lens > 0
    worst, n = 0.0, 0
    for d in (64, 80, 96, 128):
        for g in (1, 4, 8):
            q = _bf16(gen, (b, 1, hkv * g, d))
            k, v = _bf16(gen, (b, s_max, hkv, d)), _bf16(gen, (b, s_max, hkv, d))
            for window in (None, 100):
                ref = decode_attention(q.float(), k.float(), v.float(), lens, window=window)
                errs = []
                for chunk in (128, 512):
                    for order in Order:
                        out = flash_decode_fwd(q, k, v, lens, order=order, window=window,
                                               chunk=chunk, snake_group=2)
                        torch.cuda.synchronize()
                        o = out.float()
                        case = f"D={d} G={g} window={window} chunk={chunk} order={order.value}"
                        if not torch.isfinite(o).all() or o[~ok].abs().max().item() != 0.0:
                            raise AssertionError(f"contig_decode: non-finite or non-zero empty "
                                                 f"row: {case}")
                        err = (o - ref)[ok].abs().max().item()
                        if err > KERNEL_TOL:
                            raise AssertionError(f"contig_decode disagrees with its plain "
                                                 f"version: {case}: {err:.3e}")
                        want = contig_decode_walks(
                            lens, s_max=s_max, hkv=hkv, g=g, chunk=chunk, order=order,
                            snake_group=2, window=window,
                            splits=contig_decode_splits(b, hkv, g, s_max, _sms()))
                        visit = torch.full(tuple(want.shape), -7, dtype=torch.int32,
                                           device="cuda")
                        again = launch_contig_decode(q, k, v, lens, order=order, window=window,
                                                     chunk=chunk, snake_group=2,
                                                     visit_out=visit)
                        torch.cuda.synchronize()
                        if not torch.equal(visit.cpu(), want) or not torch.equal(again, out):
                            raise AssertionError(f"contig_decode: recorded walk differs from "
                                                 f"contig_decode_walks or repeat's bits: {case}")
                        errs.append(err)
                        worst = max(worst, err)
                        n += 1
                print(f"[decode] D={d} G={g} window={window}: max_abs_err over chunks x orders "
                      f"{max(errs):.3e}, walks and repeats ok")
    print(f"[decode] {n} cases, worst max_abs_err={worst:.3e} (tol {KERNEL_TOL})")
    return worst


def _ssd_case(gen, bsz, s, h, n, state: bool):
    """B7's inputs at the model's scales: x, b, c bf16 of unit size; dt =
    softplus(noise - 3) (dt_bias lies in [-4, -2]); a = -linspace(1, 16, H),
    the init's decay rates, so cum reaches about -100 inside a chunk; and a
    random float32 initial state or None."""
    x = _bf16(gen, (bsz, s, h, 64))
    dt = torch.nn.functional.softplus(torch.randn((bsz, s, h), generator=gen, device="cuda") - 3)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    b, c = _bf16(gen, (bsz, s, n)), _bf16(gen, (bsz, s, n))
    init = torch.randn((bsz, h, 64, n), generator=gen, device="cuda") if state else None
    return x, dt, a, b, c, init


def _ssd_chunks(x, dt, a, b, c, init, carry):
    """B7 run one 128-position chunk at a time, the state between chunks
    passed through ``carry(prev_final, init)``: the deliberately wrong
    variants of the B7 check."""
    from repro_torch.kernels.ssd import ssd_fwd

    ys, st = [], init
    for s0 in range(0, x.shape[1], 128):
        sl = slice(s0, s0 + 128)
        y, fin = ssd_fwd(*(t[:, sl].contiguous() for t in (x, dt)), a,
                         *(t[:, sl].contiguous() for t in (b, c)), init_state=st)
        ys.append(y)
        st = carry(fin, init)
    return torch.cat(ys, 1), fin


# Deliberately wrong variants of B7, built around the kernel: the decays
# dropped (the kernel fed a = 0), the state not carried between chunks
# (each chunk restarts from the initial state), and the state rounded to
# bf16 between chunks (the precision that a bf16 tensor-core product of S
# would keep).
_SSD_CONTROLS = {
    "decay_dropped": lambda x, dt, a, b, c, init: _ssd_fwd_direct(
        x, dt, torch.zeros_like(a), b, c, init),
    "state_not_carried": lambda x, dt, a, b, c, init: _ssd_chunks(
        x, dt, a, b, c, init, lambda fin, init: init),
    "state_bf16": lambda x, dt, a, b, c, init: _ssd_chunks(
        x, dt, a, b, c, init, lambda fin, init: fin.to(torch.bfloat16).float()),
}


def _ssd_fwd_direct(x, dt, a, b, c, init):
    from repro_torch.kernels.ssd import ssd_fwd

    return ssd_fwd(x, dt, a, b, c, init_state=init)


@contextlib.contextmanager
def _ssd_control(name):
    """Route ops.ssd's B7 calls through the wrong variant ``name`` of
    _SSD_CONTROLS (which launches the real kernel around the fault)."""
    from repro_torch.kernels import ops

    real, fn = ops.ssd_fwd, _SSD_CONTROLS[name]
    ops.ssd_fwd = lambda x, dt, a, b, c, *, init_state=None, chunk=128: fn(
        x, dt, a, b, c, init_state)
    try:
        yield
    finally:
        ops.ssd_fwd = real


def phase_ssd_matrix() -> dict:
    """B7 against its plain version (ssd_chunked in float32 on the same bf16
    inputs) over N 64, 128 x H 24, 80 x B 1, 8 x S in {1, 77, 128, 300, 700,
    1024} x zero or random initial state: y and the final state as max-abs
    error over max |plain| against SSD_Y_TOL and SSD_STATE_TOL; finite; a
    second run bitwise equal; the sequence split in two calls chained
    through the state equal to one call. The deliberately wrong variants
    (_SSD_CONTROLS) run on the same cases and must exceed the limits."""
    from repro_torch.kernels.ssd import ssd_fwd
    from repro_torch.models.ssm import ssd_chunked

    gen = torch.Generator(device="cuda").manual_seed(1357)
    worst = {"y": 0.0, "state": 0.0, "chained_y": 0.0, "chained_state": 0.0}
    ctl = {name: {"y": 0.0, "state": 0.0} for name in _SSD_CONTROLS}
    n = 0
    for nd in (64, 128):
        for h in (24, 80):
            for bsz in (1, 8):
                errs = []
                for s in (1, 77, 128, 300, 700, 1024):
                    for state in (False, True):
                        case = f"N={nd} H={h} B={bsz} S={s} init={state}"
                        x, dt, a, b, c, init = _ssd_case(gen, bsz, s, h, nd, state)
                        y, fin = ssd_fwd(x, dt, a, b, c, init_state=init)
                        y2, fin2 = ssd_fwd(x, dt, a, b, c, init_state=init)
                        ry, rfin = ssd_chunked(x.float(), dt, a, b.float(), c.float(), chunk=128,
                                               init_state=init)
                        torch.cuda.synchronize()
                        if not (torch.isfinite(y.float()).all() and torch.isfinite(fin).all()):
                            raise AssertionError(f"ssd non-finite output: {case}")
                        if not (torch.equal(y, y2) and torch.equal(fin, fin2)):
                            raise AssertionError(f"ssd: two runs differ: {case}")
                        e = {"y": _rel_err(y, ry), "state": _rel_err(fin, rfin)}
                        if s > 1:
                            cut = s // 2
                            y1, s1 = ssd_fwd(*(t[:, :cut].contiguous() for t in (x, dt)), a,
                                             *(t[:, :cut].contiguous() for t in (b, c)),
                                             init_state=init)
                            yb, sb = ssd_fwd(*(t[:, cut:].contiguous() for t in (x, dt)), a,
                                             *(t[:, cut:].contiguous() for t in (b, c)),
                                             init_state=s1)
                            e["chained_y"] = _rel_err(torch.cat([y1, yb], 1), ry)
                            e["chained_state"] = _rel_err(sb, rfin)
                        if max(e["y"], e.get("chained_y", 0.0)) > SSD_Y_TOL or \
                                max(e["state"], e.get("chained_state", 0.0)) > SSD_STATE_TOL:
                            raise AssertionError(f"ssd disagrees with its plain version: {case}: "
                                                 f"{e} (tol y {SSD_Y_TOL}, state {SSD_STATE_TOL})")
                        for name, fn in _SSD_CONTROLS.items():
                            cy, cfin = fn(x, dt, a, b, c, init)
                            ctl[name]["y"] = max(ctl[name]["y"], _rel_err(cy, ry))
                            ctl[name]["state"] = max(ctl[name]["state"], _rel_err(cfin, rfin))
                        for key in e:
                            worst[key] = max(worst[key], e[key])
                        errs.append(max(e["y"], e["state"]))
                        n += 1
                print(f"[ssd] N={nd} H={h} B={bsz}: worst rel err over S x init "
                      f"{max(errs):.2e} ok, bitwise repeatable, chained == one call")
    print(f"[ssd] {n} cases, worst rel err {json.dumps(worst)} (tol y {SSD_Y_TOL}, state "
          f"{SSD_STATE_TOL}); wrong variants {json.dumps(ctl)}")
    for key, tol in (("y", SSD_Y_TOL), ("state", SSD_STATE_TOL)):
        if not any(ctl[name][key] > tol for name in ctl):
            raise AssertionError(f"no deliberately wrong variant of B7 exceeds the {key} limit "
                                 f"{tol}: {ctl}")
    for name, e in ctl.items():
        if e["y"] <= SSD_Y_TOL and e["state"] <= SSD_STATE_TOL:
            raise AssertionError(f"the B7 check cannot tell the wrong variant {name} from the "
                                 f"kernel: {e}")
    return {"worst": worst, "controls": ctl, "cases": n}


# ---- phase 3 ------------------------------------------------------------------


def _main_requests(vocab: int, seed: int = 0):
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    prefix = rng.integers(2, vocab, size=128).astype(np.int32)
    lens = np.linspace(100, 700, 12).astype(int)
    reqs = []
    for i, n in enumerate(lens):
        body = rng.integers(2, vocab, size=int(n)).astype(np.int32)
        if i % 3 != 2:  # 8 of 12 share the 128-token prefix
            body = np.concatenate([prefix, body[128:]]) if n > 128 else prefix[:n].copy()
        # eos_id -1 never matches: every request runs to its token limit.
        reqs.append(Request(tokens=body, max_new_tokens=32, rid=i, eos_id=-1))
    return reqs


def build_main_model():
    """Full-width deepseek-7b with random weights from seed 0, shared by
    both main paths."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("deepseek-7b")
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda")
    params = lm.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.2f} B params "
          f"({cfg.param_dtype}), init {time.perf_counter() - t0:.1f} s")
    return cfg, lm, params


def phase_main_path(cfg, lm, params, profile: bool = False, label: str = "continuous") -> dict:
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(lm, params, scheduler="continuous", batch_size=8, max_len=1024,
                      page_size=64, device="cuda")

    # Every logit the engine computes is checked for NaN/inf on the device:
    # the check is part of the step, so it is captured with it and runs at
    # every replay.
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    inner = eng.lm.decode_step

    def checked(p, tokens, caches):
        logits, caches = inner(p, tokens, caches)
        bad.add_((~torch.isfinite(logits)).sum())
        return logits, caches

    eng.lm = dataclasses.replace(eng.lm, decode_step=checked)

    # Warm-up (cuBLAS handles, allocator) and the capture of both widths'
    # graphs (a 300-token prompt takes wide steps, its last token a narrow
    # one); not part of the measured run.
    rng = np.random.default_rng(99)
    eng.generate([Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                          max_new_tokens=2, eos_id=-1) for n in (300, 20)])
    assert eng.compiled_step_count() == 2, eng.step_graphs()
    replays = {name: g.replays for name, g in eng.step_graphs().items()}

    reqs = _main_requests(cfg.vocab)
    eng.tracer.clear()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    library = dict(cuda_lib.library_counts)
    stats = eng.last_stats
    graphs = eng.step_graphs()
    replayed = {name: g.replays - replays[name] for name, g in graphs.items()}

    statuses = [r.status for r in results]
    assert all(s == "ok" for s in statuses), statuses
    assert all(r.steps == 32 and len(r.tokens) == 32 for r in results), [r.steps for r in results]
    assert int(bad.item()) == 0, f"{int(bad.item())} non-finite logits"
    # Every mixed step a replay of one of the two graphs captured before.
    assert eng.compiled_step_count() == 2 and list(graphs) == list(replays), graphs
    assert sum(replayed.values()) == stats.mixed_steps, (replayed, stats)
    assert replayed["mixed/1"] == stats.mixed_steps - stats.wide_steps, (replayed, stats)
    assert stats.pages_adopted > 0, stats
    want = cfg.n_layers * stats.mixed_steps
    assert launches["paged_decode"] == want, (launches, want)

    tokens = sum(r.steps for r in results)
    steps_by_width: dict[str, list] = {"narrow": [], "wide": []}
    for ev in eng.tracer.events():
        if ev.name == "serve.device_step":
            key = "narrow" if ev.args["width"] == 1 else "wide"
            steps_by_width[key].append(ev.dur_ns / 1e6)
    ttft = float(np.median([r.ttft_s for r in results]))
    tpot = float(np.nanmedian([r.tpot_s for r in results]))
    out = {
        "requests": len(results),
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_p50_s": ttft,
        "tpot_p50_s": tpot,
        "mixed_steps": stats.mixed_steps,
        "wide_steps": stats.wide_steps,
        "pages_adopted": stats.pages_adopted,
        "cow_forks": stats.cow_forks,
        "step_ms_narrow_mean": float(np.mean(steps_by_width["narrow"])) if steps_by_width["narrow"] else None,
        "step_ms_wide_mean": float(np.mean(steps_by_width["wide"])) if steps_by_width["wide"] else None,
        "launches": launches,
        "library": library,
        "launches_per_step": launches["paged_decode"] / max(stats.mixed_steps, 1),
        "graph_replays": replayed,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    prefix = "serve" if label == "continuous" else label
    print(f"[{prefix}] " + json.dumps(out))
    out["streams"] = {r.rid: r.tokens.tolist() for r in results}
    out["graphs"] = phase_graphs(eng, label)
    out["step_idle"] = {
        key: _step_idle(steps_by_width[key], out["graphs"][name]["replay_ms"])
        for key, name in zip(("narrow", "wide"), out["graphs"])  # mixed/1, mixed/<chunk>
    }
    print(f"[{prefix}] steps, wall against a replay's device time: "
          + json.dumps(out["step_idle"]))
    if profile:
        out["profile"] = phase_profile(eng, cfg, label, ("serve.device_step",))
    del eng
    torch.cuda.empty_cache()
    return out


class _WalkView:
    """What ``ServeEngine._run_mixed`` reads of the pool (block table and
    lengths), with the block table replaced."""

    def __init__(self, pool, block_tables):
        self.block_tables, self.lens = block_tables, pool.lens


def _warm_engine(cfg, lm, params, **engine_kw):
    """A continuous engine of the main path's settings and ``engine_kw``,
    with a device counter of the non-finite logits its steps compute
    (captured with them) and both step widths captured in a warm-up with
    the order controller held. Returns (engine, counter)."""
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(lm, params, scheduler="continuous", batch_size=8, max_len=1024,
                      page_size=64, device="cuda", **engine_kw)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    inner = eng.lm.decode_step

    def checked(p, tokens, caches):
        logits, caches = inner(p, tokens, caches)
        bad.add_((~torch.isfinite(logits)).sum())
        return logits, caches

    eng.lm = dataclasses.replace(eng.lm, decode_step=checked)
    ctl = eng.order_ctl
    adapting = ctl.enabled
    ctl.enabled = False
    rng = np.random.default_rng(99)
    eng.generate([Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                          max_new_tokens=2, eos_id=-1) for n in (300, 20)])
    assert eng.compiled_step_count() == 2, eng.step_graphs()
    assert ctl.switches == 0 and ctl.order.value == cfg.attn_order
    ctl.enabled = adapting
    return eng, bad


_RUN_COUNTERS = ("serve.step_retries", "serve.failed", "serve.preemptions",
                 "serve.restore_tokens", "serve.cancelled")


def _recorded_run(eng, bad, cfg, label: str, *, wrong_walk_from=None, expect_ok=True,
                  audit=False) -> dict:
    """The 12 main requests through ``eng`` (warmed by ``_warm_engine``),
    recording, for every token a request is given, the step that made it
    and that row's logits (kept on the card); the reversal group staged
    each step; the first step's staged inputs and its logits at the valid
    positions; the switches; the sampler's host time a sample; and the
    resilience counters of the run. ``wrong_walk_from`` makes every step
    from that one on read each row's full pages as its first page;
    ``audit`` checks the pool's invariants before every step. With
    ``expect_ok`` every request must end ``ok`` with 32 tokens. Each run
    checks its logits finite, its two step graphs, and B1 launched layers x
    mixed steps (plus a model drafter's steps). A verification row records
    each position under the token it makes if the drafts before it are
    accepted; a later step's logits replace the positions it rejected."""
    from repro_torch.kernels import cuda_lib

    ctl = eng.order_ctl
    sample_s = []
    sample = eng.llc.sample

    def timed_sample(pool, step_q=None):
        t0 = time.perf_counter()
        took = sample(pool, step_q=step_q)
        sample_s.append(time.perf_counter() - t0)
        return took

    eng.llc.sample = timed_sample

    logits_at: dict = {}   # (rid, token index) -> (step, logits row on the card)
    speculative: set = set()  # keys last recorded at a verification position
    staged: list = []
    first: dict = {}
    sched_of: dict = {}
    admit, run = eng._admit, eng._run_mixed

    def admit_rec(req, slot, sched, *rest, **kw):
        sched_of["sched"] = sched
        return admit(req, slot, sched, *rest, **kw)

    def run_rec(step, tokens, pool, qlens, order_group, *rest):
        ladder = rest[4]  # (temps, seeds, counts, lens, ladder, overlap)
        idx = len(staged)
        staged.append(int(order_group))
        if audit:
            pool.check_invariants()
        view = pool
        if wrong_walk_from is not None and idx >= wrong_walk_from:
            bt = pool.block_tables.copy()
            for b in np.flatnonzero(qlens > 0):
                full = int(pool.lens[b]) // pool.page  # pages written before this step
                bt[b, 1:full] = bt[b, 0]
            view = _WalkView(pool, bt)
        toks = run(step, tokens, view, qlens, order_group, *rest)
        if idx == 0:
            first.update(tokens=tokens.copy(), block_table=view.block_tables.copy(),
                         lens=pool.lens.copy(), q_lens=qlens.copy(),
                         order_group=int(order_group), width=tokens.shape[1],
                         logits=torch.cat([step.outputs[0][b, :int(qlens[b])]
                                           for b in np.flatnonzero(qlens > 0)]).clone())
        sched = sched_of["sched"]
        rows, pos, keys = [], [], []
        for b in np.flatnonzero(qlens > 0):
            st, q = sched.slots[b], int(qlens[b])
            if st.prefilling and st.prompt_pos + q < len(st.prompt):
                continue  # a prompt chunk that samples nothing
            # A verification row: position p makes token len(generated) + p
            # if the drafts before it are accepted.
            for p in (range(q) if ladder[b] else (q - 1,)):
                rows.append(int(b))
                pos.append(p)
                keys.append((st.request.rid, len(st.generated) + (p if ladder[b] else 0)))
        last = step.outputs[0][rows, pos].clone()
        for j, key in enumerate(keys):
            # Positions a verification row did not accept are made again by
            # a later step, whose logits replace theirs.
            assert key not in logits_at or key in speculative, (label, key)
            logits_at[key] = (idx, last[j])
            (speculative.add if ladder[rows[j]] else speculative.discard)(key)
        return toks

    eng._admit, eng._run_mixed = admit_rec, run_rec
    reqs = _main_requests(cfg.vocab)
    before = {name: eng.obs.value(name) for name in _RUN_COUNTERS}
    drafter = getattr(eng, "drafter", None)
    drafter_steps = getattr(drafter, "steps", 0)
    bad.zero_()
    eng.tracer.clear()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        results = eng.generate(reqs)
        torch.cuda.synchronize()
    finally:
        eng._admit, eng._run_mixed, eng.llc.sample = admit, run, sample
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    library = dict(cuda_lib.library_counts)
    stats = eng.last_stats
    drafter_steps = getattr(drafter, "steps", 0) - drafter_steps
    if expect_ok:
        assert all(r.status == "ok" and r.steps == 32 for r in results), \
            (label, [(r.status, r.steps) for r in results])
        assert len(logits_at) == 12 * 32, label
    assert int(bad.item()) == 0, f"{label}: {int(bad.item())} non-finite logits"
    assert eng.compiled_step_count() == 2, (label, eng.step_graphs())
    # A model drafter's steps run B1 too, one launch a layer each.
    assert launches["paged_decode"] == cfg.n_layers * (stats.mixed_steps + drafter_steps), \
        (label, launches, drafter_steps)
    assert len(staged) == stats.mixed_steps, label
    walls: dict[str, list] = {"narrow": [], "wide": []}
    switches, events = [], []
    spans: dict[str, list] = {"serve.draft": [], "serve.prefetch": []}
    first_resume = None
    for ev in eng.tracer.events():
        if ev.name == "serve.device_step":
            walls["narrow" if ev.args["width"] == 1 else "wide"].append(ev.dur_ns / 1e6)
        elif ev.name == "serve.order_switch":
            switches.append((ev.args["step"], ev.args["order"]))
        elif ev.name in spans:
            spans[ev.name].append(ev.dur_ns / 1e6)
        if ev.name == "serve.tier_resume" and first_resume is None:
            first_resume = sum(len(w) for w in walls.values())  # steps before it
        if ev.name in ("serve.preempt", "serve.step_retry", "serve.preempt_restore",
                       "serve.spill", "serve.tier_resume"):
            events.append({"name": ev.name, **(ev.args or {}),
                           **({"ms": ev.dur_ns / 1e6} if ev.dur_ns >= 0 else {})})
    return {
        "label": label,
        "events": events,
        "tokens": {r.rid: r.tokens.tolist() for r in results},
        "statuses": {r.rid: r.status for r in results},
        "n_preemptions": {r.rid: r.n_preemptions for r in results},
        "logits_at": logits_at,
        "first_step": first,
        "staged_groups": staged,
        "switches": switches,
        "final_order": ctl.order.value,
        "capacity_bytes": eng.llc.capacity_bytes,
        "history": [{k: h[k] for k in ("sample", "max_len", "footprint_bytes", "active_rows",
                                       "fwd_miss", "shared_frac", "current_order")}
                    for h in eng.llc.history],
        "samples": len(sample_s),
        "sample_host_ms_mean": 1e3 * float(np.mean(sample_s)) if sample_s else None,
        "sample_host_ms_max": 1e3 * max(sample_s) if sample_s else None,
        "mixed_steps": stats.mixed_steps,
        "wide_steps": stats.wide_steps,
        "stats": stats.as_dict(),
        "counters": {name: eng.obs.value(name) - before[name] for name in _RUN_COUNTERS},
        "wall_s": wall,
        "tokens_per_s": sum(r.steps for r in results) / wall,
        "step_ms_narrow_mean": float(np.mean(walls["narrow"])) if walls["narrow"] else None,
        "step_ms_wide_mean": float(np.mean(walls["wide"])) if walls["wide"] else None,
        "launches": launches,
        "library": library,
        "compiled_steps": eng.compiled_step_count(),
        "drafter_steps": drafter_steps,
        "draft_ms": spans["serve.draft"],
        "prefetch_ms": spans["serve.prefetch"],
        "first_resume_step": first_resume,
    }


def _adapt_run(cfg, lm, params, label: str, *, forced=None, wrong_walk_from=None,
               **engine_kw) -> dict:
    """One run of the 12 main requests through a new continuous engine with
    ``engine_kw`` (``_recorded_run``). ``forced`` (step -> order) replaces
    the controller's decisions by those switches."""
    eng, bad = _warm_engine(cfg, lm, params, **engine_kw)
    ctl = eng.order_ctl
    if forced is not None:
        ctl.enabled = True

        def replay(step_epoch, pool, sampler, step_q=None):
            if step_epoch not in forced:
                return False
            ctl.switch_to(forced[step_epoch])
            return True

        ctl.maybe_adapt = replay
    out = _recorded_run(eng, bad, cfg, label, wrong_walk_from=wrong_walk_from)
    del eng
    torch.cuda.empty_cache()
    return out


def _first_differences(x: dict, c: dict) -> list:
    """Per request whose stream differs between runs ``x`` and ``c``: the
    first differing token, each run's token, top logit and top-2 margin
    there, and the step of ``x`` that made it."""
    from repro_torch.testing import top2_margin

    out = []
    for rid, toks in sorted(x["tokens"].items()):
        other = c["tokens"][rid]
        k = next((i for i, (a, b) in enumerate(zip(toks, other)) if a != b), None)
        if k is None:
            continue
        step, row = x["logits_at"][(rid, k)]
        row_c = c["logits_at"][(rid, k)][1]
        top_x, m_x = top2_margin(row)
        top_c, m_c = top2_margin(row_c)
        out.append({"rid": rid, "token": k, "step": step, "tokens": [toks[k], other[k]],
                    "top": [top_x, top_c], "top2_margin": [m_x, m_c],
                    "shift": float((row.float() - row_c.float()).abs().max())})
    return out


def _logit_shift(x: dict, c: dict, from_step: int) -> dict:
    """Max |logits of x - logits of c| over every token up to and including
    each stream's first difference (the tokens both runs made from the same
    context), all of them and those x made from step ``from_step`` on."""
    shifts, after = [], []
    for rid, toks in x["tokens"].items():
        other = c["tokens"][rid]
        last = next((i for i, (a, b) in enumerate(zip(toks, other)) if a != b), len(toks) - 1)
        for k in range(last + 1):
            step, row = x["logits_at"][(rid, k)]
            d = float((row.float() - c["logits_at"][(rid, k)][1].float()).abs().max())
            shifts.append(d)
            if step >= from_step:
                after.append(d)
    return {"tokens": len(shifts), "max": max(shifts), "tokens_after": len(after),
            "max_after": max(after) if after else None,
            "median_after": float(np.median(after)) if after else None}


def phase_adapt_path(cfg, lm, params, main: dict) -> tuple[dict, dict]:
    """The continuous deepseek-7b engine at full width with online order
    adaptation (A8), on the main path's 12 requests: (a) adaptation on at
    the card's L2 (the realistic setting), (b) at ADAPT_SMALL_CAPACITY,
    which must switch at least once, (c) the config's fixed order, (d) (b)'s
    switches forced with the controller's decisions replaced, (e) (d) with a
    wrong walk from the first switch on. Checks: (b) equals (d) to the bit;
    two step graphs in every run; B1 launched layers x mixed steps; the tie
    rule and the logit shift between (b) and (c); the control beyond the
    shift limit. Returns the summary and run (c), whose logits the later
    phases hold their runs to."""
    from repro_torch.core.cache_model import device_hw_config
    from repro_torch.testing import bf16_ulp, within_tie_rule

    l2 = device_hw_config().cache_bytes
    a = _adapt_run(cfg, lm, params, "a", adapt_order=True, llc_capacity_bytes=l2)
    b = _adapt_run(cfg, lm, params, "b", adapt_order=True,
                   llc_capacity_bytes=ADAPT_SMALL_CAPACITY)
    c = _adapt_run(cfg, lm, params, "c")
    if not b["switches"]:
        raise AssertionError(f"phase_adapt_path: (b) at {ADAPT_SMALL_CAPACITY} modeled bytes "
                             "did not switch; the history: " + json.dumps(b["history"]))
    forced = dict(b["switches"])
    d = _adapt_run(cfg, lm, params, "d", forced=forced)
    first = b["switches"][0][0]  # switched after this many steps: step index `first` on
    e = _adapt_run(cfg, lm, params, "e", forced=forced, wrong_walk_from=first)

    # Exact: the forced replay equals the adaptive run, tokens and logits.
    assert d["switches"] == b["switches"], (d["switches"], b["switches"])
    assert d["staged_groups"] == b["staged_groups"], "staged reversal groups differ"
    assert d["tokens"] == b["tokens"], "the forced replay's streams differ from (b)'s"
    assert d["logits_at"].keys() == b["logits_at"].keys()
    unequal = [key for key, (_, row) in b["logits_at"].items()
               if not torch.equal(row, d["logits_at"][key][1])]
    assert not unequal, f"(d)'s logits differ from (b)'s at {len(unequal)} tokens"
    # The tie rule between (b) and (c), at each stream's first difference.
    diffs = _first_differences(b, c)
    for rec in diffs:
        top = max(abs(t) for t in rec["top"])
        rec["ulp"] = bf16_ulp(top)
        rec["tie"] = within_tie_rule(rec["top2_margin"], top)
        print(f"[adapt] stream {rec['rid']} differs from the fixed-order run at token "
              f"{rec['token']} (step {rec['step']}): " + json.dumps(rec))
    broken = [r for r in diffs if not r["tie"]]
    shift = _logit_shift(b, c, first)
    control = _logit_shift(e, c, first)
    summary = {
        "runs": {r["label"]: {k: r[k] for k in (
            "capacity_bytes", "switches", "final_order", "samples", "sample_host_ms_mean",
            "sample_host_ms_max", "mixed_steps", "wide_steps", "wall_s", "tokens_per_s",
            "step_ms_narrow_mean", "step_ms_wide_mean", "compiled_steps")}
            for r in (a, b, c, d, e)},
        "b_staged_groups": b["staged_groups"],
        "b_equals_d": True,
        "streams_equal_to_fixed_order": not diffs,
        "c_equals_main_path": c["tokens"] == main["streams"],
        "first_differences": diffs,
        "logit_shift": shift,
        "control_logit_shift": control,
        "shift_limit": ADAPT_SHIFT_LIMIT,
        "paged_decode_launches": {r["label"]: r["launches"]["paged_decode"]
                                  for r in (a, b, c, d, e)},
    }
    print("[adapt] " + json.dumps(summary))
    print("[adapt] (b) sampler history (footprint, modeled miss bytes per order, the order "
          "after the sample): " + json.dumps(b["history"]))
    print("[adapt] (a) sampler history: " + json.dumps(a["history"][-3:]))
    assert len(set(b["staged_groups"][:first])) == 1, b["staged_groups"]
    if broken:
        raise AssertionError("phase_adapt_path: a stream flipped from the fixed-order one "
                             "outside the tie rule: " + json.dumps(broken))
    if shift["max"] > ADAPT_SHIFT_LIMIT:
        raise AssertionError(f"phase_adapt_path: (b)'s logits moved {shift['max']} from "
                             f"(c)'s before the streams differ (limit {ADAPT_SHIFT_LIMIT})")
    if not (control["max_after"] or 0.0) > ADAPT_SHIFT_LIMIT:
        raise AssertionError("phase_adapt_path: the wrong walk's logits stayed within the "
                             f"shift limit: {control}")
    print(f"[adapt] checks: (b) == (d) to the bit over {len(b['logits_at'])} tokens; two "
          f"step graphs in every run; tie rule held at {len(diffs)} flipped streams; logit "
          f"shift {shift['max']:.4f} <= {ADAPT_SHIFT_LIMIT}; wrong-walk control "
          f"{control['max_after']:.4f} > {ADAPT_SHIFT_LIMIT}")
    launches = {}
    for r in (a, b, c, d, e):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    summary["launches"] = launches
    for r in (a, b, d, e):
        r.pop("logits_at")
    return summary, c


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _no_retry_or_failure(run: dict) -> None:
    """A run without injected faults must show no step retry and no failed
    request: on the card a swallowed kernel failure would show as one."""
    c = run["counters"]
    assert c["serve.step_retries"] == 0 and c["serve.failed"] == 0, (run["label"], c)


def phase_int8_continuous(cfg, params, fixed: dict, main: dict) -> dict:
    """The main requests through a continuous engine with int8 KV pages
    (A5): B1 reads the pool dequantized whole to bf16 inside each captured
    step, as the reference dequantizes before its kernel. Checks: every
    request ok, finite logits, both widths replays equal to their eager
    steps (logits, tokens, every int8 page and scale plane but page 0), B1
    layers x mixed steps, the pool's bytes under INT8_BYTES_LIMIT of bf16's,
    the first mixed step's logits within INT8_REL_LIMIT of the bf16 run's
    (run (c) of phase_adapt_path, the same staged inputs) and the same step
    with the scales dropped beyond it; no retry and no failure."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T

    cfg8 = cfg.with_(kv_cache_dtype="int8")
    eng, bad = _warm_engine(cfg, build_model(cfg8, device="cuda"), params)
    run = _recorded_run(eng, bad, cfg, "int8 continuous")
    _no_retry_or_failure(run)
    pool = eng.last_pool
    assert sorted(pool.pages) == ["k_pages", "k_pages_scale", "v_pages", "v_pages_scale"]
    bf16_bytes = 2 * sum(t.numel() for name, t in pool.pages.items() if "scale" not in name)
    ratio = pool.nbytes() / bf16_bytes
    f8, f16 = run["first_step"], fixed["first_step"]
    for key in ("tokens", "block_table", "lens", "q_lens", "order_group"):
        assert np.array_equal(f8[key], f16[key]), f"int8 and bf16 first steps differ in {key}"
    rel = _rel_max(f8["logits"], f16["logits"])
    # The first step again, eagerly, on its staged inputs (its rows' lengths
    # were 0, so it reads only what it writes): once as it is, once with the
    # scales dropped.
    step = eng.step_graphs()[f"mixed/{f8['width']}"]
    step.stage(tokens=f8["tokens"], block_table=f8["block_table"], lens=f8["lens"],
               q_lens=f8["q_lens"], order_group=f8["order_group"])
    rows = np.flatnonzero(f8["q_lens"] > 0)

    def valid(logits):
        return torch.cat([logits[b, :int(f8["q_lens"][b])] for b in rows])

    again = valid(step.run_eager()[0])
    dequantize = T._dequantize_kv
    T._dequantize_kv = lambda q, scale, dtype: q.to(dtype)
    try:
        control = valid(step.run_eager()[0])
    finally:
        T._dequantize_kv = dequantize
    rel_control = _rel_max(control, f16["logits"])
    graphs = phase_graphs(eng, "int8 continuous")
    assert all(g["compared"] == 6 for g in graphs.values()), graphs  # 2 outputs, 4 pool tensors
    # What int8 adds to a step, op by op (informational): one layer's K
    # dequantized whole (a step does it for K and V of every layer) and one
    # wide step's K chunk quantized, each against its bytes at 3.35 TB/s.
    k0, s0 = pool.pages["k_pages"][0], pool.pages["k_pages_scale"][0]
    chunk = torch.randn((8, f8["width"], cfg.n_kv_heads, cfg.hd), device="cuda",
                        dtype=torch.bfloat16)
    ops = {
        "dequantize_layer_ms": _median_ms(lambda: T._dequantize_kv(k0, s0, torch.bfloat16)),
        "dequantize_layer_bound_ms": (3 * k0.numel() + 4 * s0.numel()) / 3.35e12 * 1e3,
        "quantize_wide_chunk_ms": _median_ms(lambda: T._quantize_kv(chunk)),
        "quantize_wide_chunk_bound_ms": (3 * chunk.numel() + 4 * chunk.numel() // cfg.hd)
        / 3.35e12 * 1e3,
    }
    ops["dequantize_step_ms"] = 2 * cfg.n_layers * ops["dequantize_layer_ms"]
    out = {
        "tokens_per_s": run["tokens_per_s"],
        "step_ms_narrow_mean": run["step_ms_narrow_mean"],
        "step_ms_wide_mean": run["step_ms_wide_mean"],
        "replay_ms": {name: g["replay_ms"] for name, g in graphs.items()},
        "bf16": {"tokens_per_s": main["tokens_per_s"],
                 "step_ms_narrow_mean": main["step_ms_narrow_mean"],
                 "step_ms_wide_mean": main["step_ms_wide_mean"],
                 "replay_ms": {name: g["replay_ms"] for name, g in main["graphs"].items()}},
        "mixed_steps": run["mixed_steps"],
        "wide_steps": run["wide_steps"],
        "pool_bytes": pool.nbytes(),
        "bf16_pool_bytes": bf16_bytes,
        "pool_bytes_ratio": ratio,
        "first_step_rel": rel,
        "first_step_rel_scales_dropped": rel_control,
        "first_step_eager_equals_replay": bool(torch.equal(again, f8["logits"])),
        "ops": ops,
        "streams_equal_to_bf16": sum(run["tokens"][rid] == fixed["tokens"][rid]
                                     for rid in run["tokens"]),
        "launches": run["launches"],
    }
    print("[int8] continuous: " + json.dumps(out))
    if ratio >= INT8_BYTES_LIMIT:
        raise AssertionError(f"int8 pool at {ratio:.4f} of bf16's bytes (limit {INT8_BYTES_LIMIT})")
    if not rel < INT8_REL_LIMIT:
        raise AssertionError(f"int8 first mixed step {rel} from bf16's (limit {INT8_REL_LIMIT})")
    if rel_control <= INT8_REL_LIMIT:
        raise AssertionError(f"int8 with the scales dropped stayed within the limit: {rel_control}")
    print(f"[int8] continuous checks: pool {ratio:.4f} of bf16's bytes; first mixed step "
          f"{rel:.4f} from bf16's (limit {INT8_REL_LIMIT}), scales dropped {rel_control:.4f}; "
          f"B1 {run['launches']['paged_decode']} launches over {run['mixed_steps']} steps")
    out["run"] = run  # the run phase_tiered_path holds its int8 runs to
    del eng
    torch.cuda.empty_cache()
    return out


def phase_int8_static(cfg, params, static: dict) -> dict:
    """The main requests through the static engine with int8 caches: B2 in
    the prefill (on the fresh bf16 K/V, as in the reference), B3 in each
    decode step reading the cache dequantized whole. phase_static_path's
    checks, and: the decode caches' bytes under INT8_BYTES_LIMIT of bf16's,
    the first decode step's logits within INT8_REL_LIMIT of the bf16 run's
    and the same step with the scales dropped beyond it (prefill and step
    run eagerly)."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T

    lm8 = build_model(cfg.with_(kv_cache_dtype="int8"), device="cuda")
    out = phase_static_path(cfg, lm8, params, label="int8 static")
    ratio = out["cache_bytes"] / static["cache_bytes"]
    rel = _rel_max(out["first_decode_logits"], static["first_decode_logits"])
    reqs = _main_requests(cfg.vocab)[:8]
    bucket = max(len(r.tokens) for r in reqs)
    tokens = np.full((8, bucket), cfg.eos_id, np.int32)
    for i, r in enumerate(reqs):
        tokens[i, bucket - len(r.tokens):] = r.tokens
    with torch.no_grad():
        logits, caches = lm8.prefill(params, {"tokens": torch.as_tensor(tokens, device="cuda")},
                                     1024)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        eager, _ = lm8.decode_step(params, nxt, caches)
        dequantize = T._dequantize_kv
        T._dequantize_kv = lambda q, scale, dtype: q.to(dtype)
        try:
            control, _ = lm8.decode_step(params, nxt, caches)
        finally:
            T._dequantize_kv = dequantize
    rel_control = _rel_max(control[:, -1], static["first_decode_logits"])
    rec = {
        "tokens_per_s": out["tokens_per_s"],
        "decode_step_ms_mean": out["decode_step_ms_mean"],
        "prefill_ms_mean": out["prefill_ms_mean"],
        "replay_ms": out["graphs"]["decode"]["replay_ms"],
        "bf16": {"tokens_per_s": static["tokens_per_s"],
                 "decode_step_ms_mean": static["decode_step_ms_mean"],
                 "prefill_ms_mean": static["prefill_ms_mean"],
                 "replay_ms": static["graphs"]["decode"]["replay_ms"]},
        "cache_bytes": out["cache_bytes"],
        "bf16_cache_bytes": static["cache_bytes"],
        "cache_bytes_ratio": ratio,
        "first_decode_rel": rel,
        "first_decode_rel_scales_dropped": rel_control,
        "first_decode_eager_equals_replay": bool(torch.equal(eager[:, -1],
                                                             out["first_decode_logits"])),
        "launches": out["launches"],
    }
    print("[int8] static: " + json.dumps(rec))
    if ratio >= INT8_BYTES_LIMIT:
        raise AssertionError(f"int8 caches at {ratio:.4f} of bf16's bytes")
    if not rel < INT8_REL_LIMIT:
        raise AssertionError(f"int8 first decode step {rel} from bf16's (limit {INT8_REL_LIMIT})")
    if rel_control <= INT8_REL_LIMIT:
        raise AssertionError(f"int8 with the scales dropped stayed within the limit: {rel_control}")
    print(f"[int8] static checks: caches {ratio:.4f} of bf16's bytes; first decode step "
          f"{rel:.4f} from bf16's, scales dropped {rel_control:.4f}")
    del lm8, caches
    torch.cuda.empty_cache()
    return rec


def _same_runs(x: dict, y: dict) -> list:
    """What differs between two recorded runs meant to be equal to the bit:
    streams, statuses, preemptions, work counters, staged groups, and the
    logits of every token."""
    bad = [key for key in ("tokens", "statuses", "n_preemptions", "stats", "staged_groups")
           if x[key] != y[key]]
    if x["logits_at"].keys() != y["logits_at"].keys():
        return bad + ["logits_at keys"]
    unequal = [key for key, (_, row) in x["logits_at"].items()
               if not torch.equal(row, y["logits_at"][key][1])]
    return bad + ([f"logits at {len(unequal)} tokens"] if unequal else [])


def _tie_check(x: dict, fixed: dict, tag: str, steps: int = 1) -> dict:
    """``x`` against the main path's run (c) of phase_adapt_path (or another
    run ``fixed``): the tie rule at each stream's first difference, and the
    logit shift until then within ADAPT_SHIFT_LIMIT. ``steps``: the rule's
    rounding steps a run (TWO_STEP_TIE)."""
    from repro_torch.testing import bf16_ulp, within_tie_rule

    diffs = _first_differences(x, fixed)
    for rec in diffs:
        top = max(abs(t) for t in rec["top"])
        rec["ulp"] = bf16_ulp(top)
        rec["tie"] = within_tie_rule(rec["top2_margin"], top, steps=steps)
        print(f"[{tag}] stream {rec['rid']} differs from the main path at token "
              f"{rec['token']} (step {rec['step']}): " + json.dumps(rec))
    shift = _logit_shift(x, fixed, 0)
    broken = [r for r in diffs if not r["tie"]]
    if broken:
        raise AssertionError(f"{tag}: a stream flipped from the main path's outside the tie "
                             "rule: " + json.dumps(broken))
    if shift["max"] > ADAPT_SHIFT_LIMIT:
        raise AssertionError(f"{tag}: logits moved {shift['max']} from the main path's before "
                             f"the streams differ (limit {ADAPT_SHIFT_LIMIT})")
    return {"first_differences": diffs, "logit_shift": shift}


def _sum_launches(*runs) -> dict:
    out: dict = {}
    for r in runs:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def phase_optimistic_path(cfg, lm, params, fixed: dict) -> dict:
    """Optimistic admission (A9) under real pressure: the main requests on
    a pool of OPT_POOL_PAGES pages, twice on one engine. Checks: every
    request ok, at least one preemption and restored tokens, two step
    graphs, the pool's invariants before every step and after; the second
    run equal to the first to the bit; against the main path, the tie rule
    and the logit shift (``_tie_check``); B1 layers x mixed steps; no retry
    and no failure."""
    eng, bad = _warm_engine(cfg, lm, params, admission="optimistic",
                            pool_pages=OPT_POOL_PAGES, max_preemptions=OPT_MAX_PREEMPTIONS)
    x = _recorded_run(eng, bad, cfg, "optimistic", audit=True)
    y = _recorded_run(eng, bad, cfg, "optimistic rerun", audit=True)
    eng.last_pool.check_invariants()
    for run in (x, y):
        _no_retry_or_failure(run)
    st = x["stats"]
    assert st["preemptions"] >= 1 and st["restore_tokens"] > 0, st
    assert x["counters"]["serve.preemptions"] == st["preemptions"], x["counters"]
    assert sum(x["n_preemptions"].values()) == st["preemptions"], x["n_preemptions"]
    differ = _same_runs(x, y)
    if differ:
        raise AssertionError(f"phase_optimistic_path: the rerun differs in {differ}")
    ties = _tie_check(x, fixed, "optimistic")
    out = {
        "pool_pages": OPT_POOL_PAGES,
        "preemptions": st["preemptions"],
        "restore_tokens": st["restore_tokens"],
        "n_preemptions": x["n_preemptions"],
        "events": x["events"],
        "mixed_steps": x["mixed_steps"],
        "wide_steps": x["wide_steps"],
        "main_path_steps": [fixed["mixed_steps"], fixed["wide_steps"]],
        "tokens_per_s": [x["tokens_per_s"], y["tokens_per_s"]],
        "main_path_tokens_per_s": fixed["tokens_per_s"],
        "step_ms_narrow_mean": x["step_ms_narrow_mean"],
        "step_ms_wide_mean": x["step_ms_wide_mean"],
        "rerun_equal": True,
        "streams_equal_to_main_path": sum(x["tokens"][rid] == fixed["tokens"][rid]
                                          for rid in x["tokens"]),
        **ties,
        "launches": _sum_launches(x, y),
    }
    print("[optimistic] " + json.dumps(out))
    print(f"[optimistic] checks: {st['preemptions']} preemptions, {st['restore_tokens']} tokens "
          f"restored; the rerun equal to the bit over {len(x['logits_at'])} tokens; tie rule "
          f"held at {len(ties['first_differences'])} flipped streams; logit shift "
          f"{ties['logit_shift']['max']:.4f} <= {ADAPT_SHIFT_LIMIT}")
    del eng
    torch.cuda.empty_cache()
    return out


def phase_fault_path(cfg, lm, params, fixed: dict) -> dict:
    """Injected faults (A9) on an engine of the main path's settings: (i) a
    device-step failure at FAULT_STEP, retried once: one retry, streams and
    logits equal to the main path's to the bit; (ii) the same step failing
    twice: that step's rows fail, the rest end ok and the engine serves on;
    (iii) a pool exhaustion and a cancel: one request cancelled, the rest
    ok, a preemption counted. The pool's invariants hold before every step
    (and, as the engine checks, after each step a fault fired in)."""
    from repro_torch.serve import FaultPlan

    eng, bad = _warm_engine(cfg, lm, params)
    plans = {
        "i": FaultPlan().fail_device_step(FAULT_STEP),
        "ii": FaultPlan().fail_device_step(FAULT_STEP, times=2),
        "iii": FaultPlan().exhaust_pool(FAULT_EXHAUST_STEP).cancel(FAULT_CANCEL_STEP,
                                                                   rid=FAULT_CANCEL_RID),
    }
    runs = {}
    for name, plan in plans.items():
        eng.faults = plan
        runs[name] = _recorded_run(eng, bad, cfg, f"fault ({name})", expect_ok=name == "i",
                                   audit=True)
        assert plan.exhausted, (name, plan.fired)
        runs[name]["fired"] = plan.fired
    eng.faults = None
    one, two, three = runs["i"], runs["ii"], runs["iii"]
    assert one["counters"]["serve.step_retries"] == 1 and one["counters"]["serve.failed"] == 0
    differ = _same_runs(one, fixed)
    if differ:
        raise AssertionError(f"fault (i): the retried run differs from the main path in {differ}")
    statuses = two["statuses"]
    failed = [rid for rid, s in statuses.items() if s == "failed"]
    ok = [rid for rid, s in statuses.items() if s == "ok"]
    assert two["counters"]["serve.step_retries"] == 1, two["counters"]
    assert failed and ok and len(failed) + len(ok) == 12, statuses
    assert two["stats"]["failed"] == len(failed) == two["counters"]["serve.failed"], two["stats"]
    assert all(len(two["tokens"][rid]) == 32 for rid in ok), two["tokens"]
    statuses = three["statuses"]
    assert [rid for rid, s in statuses.items() if s == "cancelled"] == [FAULT_CANCEL_RID], statuses
    assert all(s == "ok" and len(three["tokens"][rid]) == 32
               for rid, s in statuses.items() if rid != FAULT_CANCEL_RID), statuses
    assert three["stats"]["preemptions"] >= 1 and three["stats"]["cancelled"] == 1, three["stats"]
    _no_retry_or_failure(three)
    out = {name: {k: r[k] for k in ("statuses", "counters", "fired", "events", "mixed_steps",
                                    "tokens_per_s")} for name, r in runs.items()}
    out["launches"] = _sum_launches(one, two, three)
    print("[faults] " + json.dumps(out))
    print(f"[faults] checks: (i) one retry, streams and logits equal to the main path's; (ii) "
          f"{len(failed)} rows failed at step {FAULT_STEP}, {len(ok)} ok; (iii) rid "
          f"{FAULT_CANCEL_RID} cancelled, {three['stats']['preemptions']} preemption(s)")
    del eng
    torch.cuda.empty_cache()
    return out


def _watch_tier(pool) -> dict:
    """Wraps a tiered pool's spill and resume: a slot's device pages (every
    leaf) are kept on the card before its spill and compared to the bit
    with the pages its resume writes back. A host copy read while the next
    step overwrites its source, or a splice before its fetch landed, shows
    as an unequal resume."""
    seen = {"spills": 0, "pages_spilled": 0, "resumes": 0, "unequal": 0}
    kept: dict = {}
    spill, resume = pool.spill_slot, pool.complete_resume

    def spill_rec(slot):
        idx = torch.as_tensor(pool._slot_pages[slot], dtype=torch.long, device="cuda")
        before = {name: t.index_select(1, idx) for name, t in pool.pages.items()}
        ok = spill(slot)
        if ok:
            kept[slot] = before
            seen["spills"] += 1
            seen["pages_spilled"] += len(idx)
        return ok

    def resume_rec(slot):
        ok = resume(slot)
        if ok:
            idx = torch.as_tensor(pool._slot_pages[slot], dtype=torch.long, device="cuda")
            before = kept.pop(slot)
            seen["resumes"] += 1
            if not all(torch.equal(t.index_select(1, idx), before[name])
                       for name, t in pool.pages.items()):
                seen["unequal"] += 1
        return ok

    pool.spill_slot, pool.complete_resume = spill_rec, resume_rec
    return seen


def _tiered_engine(cfg, lm, params, **engine_kw):
    """A warmed continuous engine over a tiered pool (``_warm_engine``), its
    spills and resumes watched (``_watch_tier``)."""
    eng, bad = _warm_engine(cfg, lm, params, admission="optimistic", pool_pages=OPT_POOL_PAGES,
                            max_preemptions=OPT_MAX_PREEMPTIONS, host_pages=TIER_HOST_PAGES,
                            prefetch_depth=TIER_PREFETCH_DEPTH, **engine_kw)
    return eng, bad, _watch_tier(eng.last_pool)


def _tiered_run(eng, bad, cfg, watch: dict, label: str, *, expect_spill: bool = True) -> dict:
    """One recorded run (``_recorded_run``, the pool audited before every
    step) with the tier's readings: counters, the watch, the overlap share,
    the transfers' rates from their CUDA events. Checks the accounting:
    hits + wasted == fetches, the bytes moved == pages x a page row's bytes,
    every resume back to the bit; with ``expect_spill`` at least one spill
    and one resume."""
    before = {k: eng.obs.value(k) for k in TIER_COUNTERS}
    seen0 = dict(watch)
    run = _recorded_run(eng, bad, cfg, label, audit=True)
    pool = eng.last_pool
    pool.check_invariants()
    tier = {k: eng.obs.value(k) - before[k] for k in TIER_COUNTERS}
    seen = {k: watch[k] - seen0[k] for k in watch}
    st = run["stats"]
    row_bytes = sum(t[:, 0].numel() * t.element_size() for t in pool.pages.values())
    assert st["prefetch_hits"] + st["prefetch_wasted"] == st["tier_fetches"], (label, st)
    assert tier["tier.fetches"] == st["tier_fetches"] and tier["tier.spills"] == st["spills"], \
        (label, tier, st)
    assert tier["tier.spill_bytes"] == seen["pages_spilled"] * row_bytes, (label, tier, seen)
    assert tier["tier.fetch_bytes"] == st["tier_fetches"] * row_bytes, (label, tier)
    assert seen["spills"] == st["spills"] and seen["unequal"] == 0, (label, seen)
    if expect_spill:
        assert st["spills"] >= 1 and seen["resumes"] >= 1, (label, st, seen)
    run["tier"] = {**tier, **seen, "row_bytes": row_bytes,
                   "overlap_frac": eng.obs.value("tier.overlap_frac"),
                   "fetch_failures": pool.fetch_failures,
                   "transfers": pool.transfer_stats()}
    return run


def _tier_record(run: dict, ref: dict) -> dict:
    return {"tokens_per_s": run["tokens_per_s"], "mixed_steps": run["mixed_steps"],
            "wide_steps": run["wide_steps"], "step_ms_narrow_mean": run["step_ms_narrow_mean"],
            "step_ms_wide_mean": run["step_ms_wide_mean"],
            "against": {k: ref[k] for k in ("label", "tokens_per_s", "mixed_steps", "wide_steps",
                                            "step_ms_narrow_mean", "step_ms_wide_mean")},
            "spills": run["stats"]["spills"], "preemptions": run["stats"]["preemptions"],
            "first_resume_step": run["first_resume_step"],
            "prefetch_ms_mean": float(np.mean(run["prefetch_ms"])) if run["prefetch_ms"] else None,
            "prefetch_ms_median": (float(np.median(run["prefetch_ms"])) if run["prefetch_ms"]
                                   else None),
            "prefetch_spans": len(run["prefetch_ms"]),
            **run["tier"]}


def phase_tiered_path(cfg, lm, params, fixed: dict, int8_run: dict) -> tuple[dict, dict]:
    """The host KV tier (A10) under real pressure: the main requests on an
    optimistic pool of OPT_POOL_PAGES pages over TIER_HOST_PAGES host pages,
    twice on one engine, then twice on int8 pages. Checks (each run): every
    request ok; at least one spill and one completed resume, each resumed
    slot's pages equal to the bit to what it held before its spill; hits +
    wasted == fetches; the spill and fetch bytes == pages x a page row's
    bytes (int8: payloads and scale planes); two step graphs; the pool's
    invariants before every step; B1 layers x mixed steps; no retry and no
    failure. The rerun equal to the first run to the bit; against the main
    path (bf16) or the int8 continuous run (at TWO_STEP_TIE), the tie rule
    and the logit shift. Records the transfers' GB/s (CUDA events), ``tier.overlap_frac``
    and the step walls beside the run held to. Returns the summary and the
    bf16 run, which phase_tier_fault_path holds its runs to."""
    from repro_torch.models import build_model

    out, first = {}, None
    for tag, model, against in (("bf16", lm, fixed),
                                ("int8", build_model(cfg.with_(kv_cache_dtype="int8"),
                                                     device="cuda"), int8_run)):
        eng, bad, watch = _tiered_engine(cfg, model, params)
        x = _tiered_run(eng, bad, cfg, watch, f"tiered {tag}")
        y = _tiered_run(eng, bad, cfg, watch, f"tiered {tag} rerun")
        for run in (x, y):
            _no_retry_or_failure(run)
        differ = _same_runs(x, y)
        if differ:
            raise AssertionError(f"phase_tiered_path ({tag}): the rerun differs in {differ}")
        ties = _tie_check(x, against, f"tiered {tag}",
                          steps=TWO_STEP_TIE if tag == "int8" else 1)
        out[tag] = {**_tier_record(x, against), "rerun_tokens_per_s": y["tokens_per_s"],
                    "rerun_transfers": y["tier"]["transfers"], "rerun_equal": True,
                    "events": x["events"], **ties,
                    "streams_equal": sum(x["tokens"][rid] == against["tokens"][rid]
                                         for rid in x["tokens"]),
                    "launches": _sum_launches(x, y)}
        print(f"[tier] {tag}: " + json.dumps(out[tag]))
        print(f"[tier] {tag} checks: {x['stats']['spills']} spills, {x['tier']['resumes']} "
              f"resumes equal to the bit, fetches {x['stats']['tier_fetches']} == hits + wasted, "
              f"bytes == pages x {x['tier']['row_bytes']}; the rerun equal to the bit over "
              f"{len(x['logits_at'])} tokens; tie rule held at "
              f"{len(ties['first_differences'])} flipped streams; logit shift "
              f"{ties['logit_shift']['max']:.4f} <= {ADAPT_SHIFT_LIMIT}")
        if tag == "bf16":
            first = x
        else:
            x.pop("logits_at")
        y.pop("logits_at")
        del eng, model
        torch.cuda.empty_cache()
    out["launches"] = _sum_launches(out["bf16"], out["int8"])
    return out, first


def phase_tier_fault_path(cfg, lm, params, fixed: dict, tiered: dict) -> dict:
    """The tier's faults on the engine of phase_tiered_path: (i)
    TIER_FETCH_FAILS dropped fetches: at least one counted, the first resume
    no earlier than without them, every request ok, and the streams held to
    the un-faulted tiered run by the tie rule at TWO_STEP_TIE; (ii) every
    spill stalled: no
    spill, at least one preemption instead, every request ok, held to the
    main path by the tie rule. No retry and no failure in either."""
    from repro_torch.serve import FaultPlan

    eng, bad, watch = _tiered_engine(cfg, lm, params)
    eng.faults = FaultPlan().fetch_fail(0, times=TIER_FETCH_FAILS)
    late = _tiered_run(eng, bad, cfg, watch, "tier fetch faults")
    eng.faults = FaultPlan().spill_stall(0, times=10_000)
    stall = _tiered_run(eng, bad, cfg, watch, "tier spill stall", expect_spill=False)
    eng.faults = None
    for run in (late, stall):
        _no_retry_or_failure(run)
    assert late["tier"]["fetch_failures"] >= 1, late["tier"]
    assert late["first_resume_step"] >= tiered["first_resume_step"], \
        (late["first_resume_step"], tiered["first_resume_step"])
    late_ties = _tie_check(late, tiered, "tier fetch faults", steps=TWO_STEP_TIE)
    st = stall["stats"]
    assert st["spills"] == 0 and st["preemptions"] >= 1, st
    stall_ties = _tie_check(stall, fixed, "tier spill stall")
    out = {"fetch_faults": {**_tier_record(late, tiered), **late_ties,
                            "first_resume_step_unfaulted": tiered["first_resume_step"]},
           "spill_stall": {**_tier_record(stall, fixed), **stall_ties,
                           "n_preemptions": stall["n_preemptions"]},
           "launches": _sum_launches(late, stall)}
    print("[tier faults] " + json.dumps(out))
    print(f"[tier faults] checks: {late['tier']['fetch_failures']} fetches dropped, first resume "
          f"after step {late['first_resume_step']} (un-faulted {tiered['first_resume_step']}), "
          f"tie rule held; spill stall: {st['preemptions']} preemptions, no spill, tie rule held")
    del eng
    torch.cuda.empty_cache()
    return out


class _TimedReplay:
    """A captured graph whose every replay is bracketed by CUDA events."""

    def __init__(self, graph, times: list):
        self.graph, self.times = graph, times

    def replay(self):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        self.times.append((start, end))


def phase_spec_path(cfg, lm, params, fixed: dict) -> dict:
    """Speculative decoding (A11), greedy, K = SPEC_DRAFT_LEN: the main
    requests through the n-gram drafter and through the target drafting for
    itself (its own pool and two step graphs, the target's weights), each
    twice on one engine. Checks (each): every request ok; the target keeps 2
    step graphs; drafts > 0 and accepted + rolled back == drafted; B1 layers
    x (target + drafter) steps; the pool's invariants before every step;
    the rerun equal to the bit; against the main path the tie rule at
    TWO_STEP_TIE and the logit shift; no retry and no failure. Then the
    n-gram engine verifying against the target ladder shifted by one
    position must fail that rule. Records acceptance, target and drafter steps, wide steps,
    tokens/s, step walls, the drafting wall and the drafter's device time a
    round beside the main path's figures."""
    from repro_torch.serve import ModelDrafter, NgramDrafter, Request

    out = {}
    for kind in ("ngram", "model"):
        drafter = (NgramDrafter() if kind == "ngram" else
                   ModelDrafter(lm, params, n_slots=8, max_len=1024, page_size=64))
        eng, bad = _warm_engine(cfg, lm, params, drafter=drafter, draft_len=SPEC_DRAFT_LEN)
        # A warm-up that drafts (the first one's limit of 2 leaves no room):
        # the model drafter captures its two widths here.
        rng = np.random.default_rng(98)
        eng.generate([Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                              max_new_tokens=8, eos_id=-1) for n in (300, 20)])
        times: list = []
        if kind == "model":
            assert drafter.compiled_step_count() == 2, drafter.step_graphs()
            for g in drafter._steps.values():
                g.graph = _TimedReplay(g.graph, times)
        x = _recorded_run(eng, bad, cfg, f"spec {kind}", audit=True)
        replays = len(times)
        device_ms = sum(s.elapsed_time(e) for s, e in times)
        y = _recorded_run(eng, bad, cfg, f"spec {kind} rerun", audit=True)
        eng.last_pool.check_invariants()
        for run in (x, y):
            _no_retry_or_failure(run)
            st = run["stats"]
            assert st["draft_tokens"] > 0, (run["label"], st)
            assert st["accepted_tokens"] + st["rollback_tokens"] == st["draft_tokens"], st
        differ = _same_runs(x, y)
        if differ:
            raise AssertionError(f"phase_spec_path ({kind}): the rerun differs in {differ}")
        ties = _tie_check(x, fixed, f"spec {kind}", steps=TWO_STEP_TIE)
        st = x["stats"]
        rounds = len(x["draft_ms"])
        out[kind] = {
            "draft_len": SPEC_DRAFT_LEN,
            "acceptance_rate": st["accepted_tokens"] / st["draft_tokens"],
            **{k: st[k] for k in ("draft_tokens", "accepted_tokens", "rollback_tokens")},
            "target_steps": x["mixed_steps"], "wide_steps": x["wide_steps"],
            "drafter_steps": x["drafter_steps"], "draft_rounds": rounds,
            "draft_wall_ms_per_round": sum(x["draft_ms"]) / max(rounds, 1),
            "drafter_device_ms_per_round": device_ms / max(rounds, 1) if replays else None,
            "drafter_replays": replays,
            "tokens_per_s": [x["tokens_per_s"], y["tokens_per_s"]],
            "step_ms_narrow_mean": x["step_ms_narrow_mean"],
            "step_ms_wide_mean": x["step_ms_wide_mean"],
            "main_path": {k: fixed[k] for k in ("tokens_per_s", "mixed_steps", "wide_steps",
                                                "step_ms_narrow_mean", "step_ms_wide_mean")},
            "rerun_equal": True,
            "streams_equal_to_main_path": sum(x["tokens"][rid] == fixed["tokens"][rid]
                                              for rid in x["tokens"]),
            **ties,
            "launches": _sum_launches(x, y),
        }
        if kind == "model":
            out[kind]["drafter_graphs"] = phase_graphs(drafter, "model drafter")
        print(f"[spec] {kind}: " + json.dumps(out[kind]))
        print(f"[spec] {kind} checks: {st['draft_tokens']} drafts, {st['accepted_tokens']} "
              f"accepted; 2 target step graphs; the rerun equal to the bit over "
              f"{len(x['logits_at'])} tokens; tie rule held at "
              f"{len(ties['first_differences'])} flipped streams; logit shift "
              f"{ties['logit_shift']['max']:.4f} <= {ADAPT_SHIFT_LIMIT}")
        if kind == "ngram":
            # The wrong variant: each verification row's targets read one
            # position late.
            inner = eng._run_mixed

            def shifted(step, tokens, pool, qlens, order_group, temps, seeds, counts, lens,
                        ladder, overlap=None):
                toks = inner(step, tokens, pool, qlens, order_group, temps, seeds, counts, lens,
                             ladder, overlap).copy()
                for b in np.flatnonzero(ladder):
                    q = int(qlens[b])
                    toks[b, : q - 1] = toks[b, 1:q]
                return toks

            eng._run_mixed = shifted
            try:
                wrong = _recorded_run(eng, bad, cfg, "spec wrong ladder", expect_ok=False)
            finally:
                eng._run_mixed = inner
            assert wrong["stats"]["draft_tokens"] > 0, wrong["stats"]
            try:
                _tie_check(wrong, fixed, "spec wrong ladder", steps=TWO_STEP_TIE)
            except AssertionError as err:
                out[kind]["wrong_ladder_caught"] = str(err)[:300]
            else:
                raise AssertionError("phase_spec_path: verifying against the shifted ladder "
                                     "passed the tie check")
            out[kind]["launches"] = _sum_launches(x, y, wrong)
            print(f"[spec] wrong ladder caught: {out[kind]['wrong_ladder_caught']}")
        for run in (x, y):
            run.pop("logits_at")
        del eng, drafter
        torch.cuda.empty_cache()
    out["launches"] = _sum_launches(out["ngram"], out["model"])
    return out


def phase_static_path(cfg, lm, params, profile: bool = False, label: str = "static") -> dict:
    """The same 12 requests through the static engine: two groups of 8 rows
    (the second padded), each one prefill and 31 decode steps. Keeps the
    first decode step's logits and the decode caches' bytes."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(lm, params, scheduler="static", batch_size=8, max_len=1024, device="cuda")
    bad = _check_logits(eng, lm)
    rng = np.random.default_rng(98)
    eng.generate([Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                          max_new_tokens=2, eos_id=-1) for n in (300, 20)])
    replays = eng.step_graphs()["decode"].replays
    first_decode = {}
    sample = eng._sample

    def sample_rec(logits, greedy, temps, seeds, count):
        if count == 1 and not first_decode:
            first_decode["logits"] = logits.clone()
        return sample(logits, greedy, temps, seeds, count)

    eng._sample = sample_rec

    reqs = _main_requests(cfg.vocab)
    eng.tracer.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    library = dict(cuda_lib.library_counts)
    spans, calls = _step_spans(eng)
    replayed = eng.step_graphs()["decode"].replays - replays

    statuses = [r.status for r in results]
    assert all(s == "ok" for s in statuses), statuses
    assert all(r.steps == 32 and len(r.tokens) == 32 for r in results), [r.steps for r in results]
    assert int(bad.item()) == 0, f"{int(bad.item())} non-finite logits"
    assert calls == {"prefill": 2, "decode": 62}, calls
    assert eng.compiled_step_count() == 1 and replayed == calls["decode"], (replayed, calls)
    assert launches["flash_fwd"] == cfg.n_layers * calls["prefill"], (launches, calls)
    assert launches["contig_decode"] == cfg.n_layers * calls["decode"], (launches, calls)
    assert launches["paged_decode"] == 0, launches
    tokens = sum(r.steps for r in results)
    out = {
        "requests": len(results),
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_p50_s": float(np.median([r.ttft_s for r in results])),
        "tpot_p50_s": float(np.nanmedian([r.tpot_s for r in results])),
        "prefill_calls": calls["prefill"],
        "decode_calls": calls["decode"],
        "prefill_ms_mean": float(np.mean(spans["serve.prefill"])),
        "decode_step_ms_mean": float(np.mean(spans["serve.decode_step"])),
        "decode_step_ms_range": [min(spans["serve.decode_step"]), max(spans["serve.decode_step"])],
        "graph_replays": replayed,
        "launches": launches,
        "library": library,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"[{label}] " + json.dumps(out))
    out["streams"] = {r.rid: r.tokens.tolist() for r in results}
    out["graphs"] = phase_graphs(eng, label)
    out["step_idle"] = _step_idle(spans["serve.decode_step"], out["graphs"]["decode"]["replay_ms"])
    print(f"[{label}] decode steps, wall against a replay's device time: "
          + json.dumps(out["step_idle"]))
    out["first_decode_logits"] = first_decode["logits"]
    # The first group's prompts as its prefill took them (padded to its bucket).
    out["first_prefill_tokens"] = torch.as_tensor(
        eng._pad_batch([r.tokens for r in reqs[:8]], eng._cap), device="cuda")
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for name, t in eng._decode_caches.items() if name != "len")
    if profile:
        out["profile"] = phase_profile(eng, cfg, "static", tuple(spans))
    del eng
    torch.cuda.empty_cache()
    return out


def phase_ssm_path(arch: str, profile: bool = False) -> dict:
    """Full-width ``arch`` (mamba2-130m: the SSM family; zamba2-2_7b: the
    hybrid) with random weights from seed 0, served by the static engine:
    the 12 requests of _main_requests over its vocab, batch 8, max_len 1024,
    32 new tokens. Launches: ``ssd`` == layers x prefills; the hybrid's 9
    shared-attention sites add ``flash_fwd`` == sites x prefills and
    ``contig_decode`` == sites x decode steps; nothing else. Then the first
    prefill's logits with the kernels against the plain versions on the
    same weights and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda")
    params = lm.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    hybrid = cfg.family == "hybrid"
    sites = cfg.n_layers // cfg.ssm.shared_attn_every if hybrid else 0
    label = "zamba2" if hybrid else "mamba2"
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} SSD heads of P {cfg.ssm.head_dim}, "
          f"N {cfg.ssm.state_dim}, vocab {cfg.vocab}"
          + (f", {sites} shared-attention sites of {cfg.n_heads} heads of {cfg.hd}" if hybrid
             else "")
          + f", {n_params / 1e9:.3f} B params ({cfg.param_dtype}), init "
          f"{time.perf_counter() - t0:.1f} s")

    eng = ServeEngine(lm, params, scheduler="static", batch_size=8, max_len=1024, device="cuda")
    bad = _check_logits(eng, lm)
    rng = np.random.default_rng(97)
    eng.generate([Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                          max_new_tokens=2, eos_id=-1) for n in (300, 20)])
    replays = eng.step_graphs()["decode"].replays

    reqs = _main_requests(cfg.vocab)
    eng.tracer.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    spans, calls = _step_spans(eng)
    replayed = eng.step_graphs()["decode"].replays - replays

    statuses = [r.status for r in results]
    assert all(s == "ok" for s in statuses), statuses
    assert all(r.steps == 32 and len(r.tokens) == 32 for r in results), [r.steps for r in results]
    assert int(bad.item()) == 0, f"{int(bad.item())} non-finite logits"
    assert calls == {"prefill": 2, "decode": 62}, calls
    assert eng.compiled_step_count() == 1 and replayed == calls["decode"], (replayed, calls)
    want = {name: 0 for name in launches}
    want["ssd"] = cfg.n_layers * calls["prefill"]
    if hybrid:
        want["flash_fwd"] = sites * calls["prefill"]
        want["contig_decode"] = sites * calls["decode"]
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, want {want}")

    # The first group's prefill again, with the kernels and with the plain
    # versions, on the same weights and the same padded tokens.
    first = torch.as_tensor(eng._pad_batch([r.tokens for r in reqs[:8]], eng._cap),
                            device="cuda")
    got, _ = lm.prefill(params, {"tokens": first}, 1024)
    plain_lm = build_model(cfg.with_(ssd_impl="torch", attn_impl="torch"), device="cuda")
    ref, _ = plain_lm.prefill(params, {"tokens": first}, 1024)
    exact_lm = build_model(cfg.with_(ssd_impl="torch", attn_impl="torch", dtype="float32"),
                           device="cuda")
    exact, _ = exact_lm.prefill(params, {"tokens": first}, 1024)
    torch.cuda.synchronize()
    logit_err = _rel_err(got, ref.float())
    argmax_agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    # The same prefill with each deliberately wrong B7 of the matrix in the
    # kernel's place: the logits check must tell the gross ones apart.
    controls = {}
    for name in _SSD_CONTROLS:
        with _ssd_control(name):
            bad_logits, _ = lm.prefill(params, {"tokens": first}, 1024)
        controls[name] = _rel_err(bad_logits, ref.float())
    del bad_logits
    f32_err = {"kernels": _rel_err(got, exact), "plain": _rel_err(ref, exact)}
    del exact_lm, exact

    tokens = sum(r.steps for r in results)
    out = {
        "arch": cfg.name,
        "requests": len(results),
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_p50_s": float(np.median([r.ttft_s for r in results])),
        "tpot_p50_s": float(np.nanmedian([r.tpot_s for r in results])),
        "prefill_calls": calls["prefill"],
        "decode_calls": calls["decode"],
        "buckets": [int(first.shape[1])],
        "prefill_ms_mean": float(np.mean(spans["serve.prefill"])),
        "decode_step_ms_mean": float(np.mean(spans["serve.decode_step"])),
        "decode_step_ms_range": [min(spans["serve.decode_step"]), max(spans["serve.decode_step"])],
        "graph_replays": replayed,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "params_b": n_params / 1e9,
        "first_prefill_logits_rel_err": logit_err,
        "first_prefill_argmax_agree": argmax_agree,
        "first_prefill_rel_err_vs_float32": f32_err,
        "first_prefill_wrong_b7_rel_err": controls,
    }
    print(f"[{label}] " + json.dumps(out))
    print(f"[{label}] first prefill, kernels vs plain versions: logits max |diff| / max |plain| "
          f"{logit_err:.3e} (tol {SSM_LOGITS_TOL}), argmax agrees on {argmax_agree:.3f} of rows; "
          f"against a float32 forward: kernels {f32_err['kernels']:.3e}, plain "
          f"{f32_err['plain']:.3e}; with a wrong B7: {json.dumps(controls)}")
    if logit_err > SSM_LOGITS_TOL:
        raise AssertionError(f"{arch}: prefill logits with the kernels differ from the plain "
                             f"versions': {logit_err}")
    for name in _SSM_CONTROLS_CAUGHT:
        if controls[name] <= SSM_LOGITS_TOL:
            raise AssertionError(f"{arch}: the logits check cannot tell the wrong B7 {name} "
                                 f"from the kernel: {controls}")
    out["graphs"] = phase_graphs(eng, label)
    out["step_idle"] = _step_idle(spans["serve.decode_step"], out["graphs"]["decode"]["replay_ms"])
    print(f"[{label}] decode steps, wall against a replay's device time: "
          + json.dumps(out["step_idle"]))
    if profile:
        out["profile"] = phase_profile(eng, cfg, label, tuple(spans))
    del eng, lm, plain_lm, params
    torch.cuda.empty_cache()
    return out


# ---- the MoE family (A13) -----------------------------------------------------


def _moe_groups(gen, e: int, m: int, skip: int) -> torch.Tensor:
    """Group sizes (E,) int32 of ``m`` rows, each row's group drawn
    uniformly from all but ``skip`` groups, which stay empty (the narrow
    step's 64 rows leave about 22 of 64 empty on their own)."""
    live = torch.randperm(e, generator=gen, device="cuda")[: e - skip]
    ids = live[torch.randint(0, e - skip, (m,), generator=gen, device="cuda")]
    sizes = torch.zeros(e, dtype=torch.int64, device="cuda")
    return sizes.scatter_add_(0, ids, torch.ones_like(ids)).to(torch.int32)


def _short_groups(sizes: torch.Tensor, drop: int) -> torch.Tensor:
    """``sizes`` with ``drop`` rows taken from the last groups that have
    them, so they sum to ``drop`` less than before."""
    out = sizes.cpu().clone()
    for g in range(len(out) - 1, -1, -1):
        take = min(drop, int(out[g]))
        out[g] -= take
        drop -= take
    return out.to(sizes.device)


def phase_moe_matrix(dev_info: dict) -> dict:
    """``ops.ragged_dot``'s ``cuda`` (one ``grouped_mm``) against its
    ``torch`` version on the same bf16 inputs at the MoE shapes: olmoe's E
    64, d 2048 -> ff 1024 and back, at a narrow step's 64 rows, a wide
    step's 16,384 and a static prefill group's 44,800 (8 x 700 at top 8);
    mixtral's E 8, d 4096 -> 14336 and back at 16 and 4,096 rows; every
    shape with empty groups, and again with sizes that leave the last M / 4
    rows in no group (``short``: those rows exact zeros in both, as
    ``jax.lax.ragged_dot`` gives them). Each within MOE_MATRIX_TOL of max |plain|, the
    same call with every group boundary moved one row beyond it; each
    shape's time beside its bound (the weights of the groups that have rows
    plus the rows in and out over the card's bytes rate, or the products
    over its bf16 peak), the wrapper's (with the offsets' cumsum) and the
    plain version's."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(25)
    shapes = []
    for arch, e, d, ff, rows, skip in (("olmoe-1b-7b", 64, 2048, 1024, (64, 16384, 44800), 3),
                                       ("mixtral-8x7b", 8, 4096, 14336, (16, 4096), 2)):
        for m in rows:
            shapes += [(arch, e, d, ff, m, skip), (arch, e, ff, d, m, skip)]
    out, worst, control_min = [], 0.0, math.inf
    for arch, e, k, n, m, skip in shapes:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((e, k, n), generator=gen, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
        sizes = _moe_groups(gen, e, m, skip)
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        got = ops.ragged_dot(x, w, sizes, impl="cuda")
        want = ops.ragged_dot(x, w, sizes, impl="torch")
        err = _rel_err(got, want.float())
        # every boundary one row earlier: the row before each lands in the next group
        shifted = torch.clamp(offs - 1, min=0)
        shifted[-1] = m
        wrong = torch.diff(shifted, prepend=shifted.new_zeros(1))
        control = _rel_err(ops.ragged_dot(x, w, wrong, impl="cuda"), want.float())
        # short: the last m // 4 rows in no group; both give zeros there
        short = _short_groups(sizes, max(1, m // 4))
        used = int(short.sum())
        got_short = ops.ragged_dot(x, w, short, impl="cuda")
        want_short = ops.ragged_dot(x, w, short, impl="torch")
        short_err = _rel_err(got_short, want_short.float())
        if got_short[used:].any() or want_short[used:].any():
            raise AssertionError(f"ragged_dot {arch} {m} rows: rows past the last group "
                                 "(sizes summing to less than M) are not zero")
        touched = int((sizes > 0).sum())
        nbytes = 2 * (touched * k * n + m * k + m * n)
        rec = _time_record({"kernel": lambda: torch.nn.functional.grouped_mm(x, w, offs=offs),
                            "wrapper": lambda: ops.ragged_dot(x, w, sizes, impl="cuda"),
                            "plain": lambda: ops.ragged_dot(x, w, sizes, impl="torch"),
                            "library": None}, nbytes, 2.0 * m * k * n, dev_info)
        row = {"arch": arch, "shape": [e, k, n, m], "empty_groups": e - touched,
               "max_abs_err": err, "short_max_abs_err": short_err, "short_rows": used,
               "shifted_offsets_err": control, "median_ms": rec["kernel_ms"],
               **{key: rec[key] for key in ("kernel_single_ms", "wrapper_ms", "wrapper_host_us",
                                            "plain_ms", "bound_ms", "bound_by", "bytes", "flops")}}
        row["bound_frac"] = rec["bound_ms"] / rec["kernel_ms"]
        out.append(row)
        print(f"[moe] ragged_dot {arch} E {e} {k} -> {n}, {m} rows ({e - touched} empty groups): "
              f"err {err:.3e}, short ({used} rows in groups, the rest zero) {short_err:.3e}, "
              f"shifted offsets {control:.3e}; {rec['kernel_ms']:.4f} ms "
              f"(bound {rec['bound_ms']:.4f}, {rec['bound_by']}; {row['bound_frac']:.2f} of it), "
              f"wrapper {rec['wrapper_ms']:.4f}, plain {rec['plain_ms']:.3f}")
        worst, control_min = max(worst, err, short_err), min(control_min, control)
        del x, w, got, want, got_short, want_short
    torch.cuda.empty_cache()
    print(f"[moe] grouped products: worst {worst:.3e} (limit {MOE_MATRIX_TOL}), every shifted "
          f"control at least {control_min:.3e}")
    if worst > MOE_MATRIX_TOL:
        raise AssertionError(f"ragged_dot cuda differs from its plain version: {worst}")
    if control_min <= MOE_MATRIX_TOL:
        raise AssertionError(f"a shifted-offsets control stayed within the limit: {control_min}")
    return {"worst": worst, "shifted_min": control_min, "shapes": out}


@contextlib.contextmanager
def _moe_swapped(plain: bool = False, routed_past_top_k: bool = False):
    """``plain``: every grouped product through the masked plain version;
    ``routed_past_top_k``: each token routed to the k experts after its top
    k (a deliberately wrong router)."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE

    saved = ops.ragged_dot, MOE._route
    if plain:
        ops.ragged_dot = functools.partial(saved[0], impl="torch")
    if routed_past_top_k:
        def route(p, cfg, xf):
            logits, _, _ = saved[1](p, cfg, xf)
            k = cfg.moe.top_k
            top, sel = torch.topk(logits, 2 * k, dim=-1)
            return logits, top[:, k:], sel[:, k:]
        MOE._route = route
    try:
        yield
    finally:
        ops.ragged_dot, MOE._route = saved


def phase_moe_path(matrix: dict, profile: bool = False) -> tuple[dict, dict]:
    """Full-width olmoe-1b-7b (16 layers, d 2048, 16 heads of 128, 64
    experts, top 8; random weights from seed 0) serving the 12 main
    requests, batch 8, max_len 1024: continuous (page 64: B1 and the
    grouped products in both captured mixed-step graphs), then static (B2
    prefill, B3 in the captured decode step). Each run: every request ok
    with 32 tokens, no non-finite logit; B1 16 x mixed steps, B2 16 x
    prefills, B3 16 x decode steps, ``ragged_dot`` 3 x 16 x forward steps;
    each captured step equal to its eager run to the bit. A second
    continuous run, recording its first mixed step, must give the same
    streams; that step and the first prefill with the kernels within
    MOE_LOGITS_TOL of the plain versions, each with the router's choices
    moved past the top k beyond it. Returns the two paths' records."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda")
    params = lm.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[olmoe] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.hd}, {m.num_experts} experts of d_ff {m.d_ff_expert}, top {m.top_k}, vocab "
          f"{cfg.vocab}, {n_params / 1e9:.2f} B params ({cfg.param_dtype}), init "
          f"{time.perf_counter() - t0:.1f} s")
    plain_lm = build_model(cfg.with_(attn_impl="torch"), device="cuda")
    per_pass = 3 * cfg.n_layers

    # ---- continuous ----
    cont = phase_main_path(cfg, lm, params, profile=profile, label="olmoe continuous")
    want = per_pass * cont["mixed_steps"]
    if cont["library"]["ragged_dot"] != want:
        raise AssertionError(f"olmoe continuous: ragged_dot {cont['library']}, want {want}")
    for g in cont["graphs"].values():
        assert g["launches_per_replay"]["ragged_dot"] == per_pass, g
    eng, bad = _warm_engine(cfg, lm, params)
    run = _recorded_run(eng, bad, cfg, "olmoe continuous, recorded")
    _no_retry_or_failure(run)
    if run["tokens"] != cont["streams"]:
        raise AssertionError("olmoe continuous: a second run's streams differ from the first's")
    f = run["first_step"]
    step = eng.step_graphs()[f"mixed/{f['width']}"]
    step.stage(tokens=f["tokens"], block_table=f["block_table"], lens=f["lens"],
               q_lens=f["q_lens"], order_group=f["order_group"])
    rows = np.flatnonzero(f["q_lens"] > 0)

    def valid(logits):
        return torch.cat([logits[b, :int(f["q_lens"][b])] for b in rows])

    # Its rows' lengths were 0: the first step reads only what it writes.
    again = valid(step.run_eager()[0])
    kernels_lm = eng.lm
    try:
        eng.lm = plain_lm
        with _moe_swapped(plain=True):
            plain = valid(step.run_eager()[0])
        eng.lm = kernels_lm
        with _moe_swapped(routed_past_top_k=True):
            rerouted = valid(step.run_eager()[0])
    finally:
        eng.lm = kernels_lm
    cont.update(
        first_step_width=f["width"],
        first_step_rel_err=_rel_err(f["logits"], plain.float()),
        first_step_argmax_agree=(f["logits"].argmax(-1) == plain.argmax(-1)).float().mean().item(),
        first_step_eager_equals_replay=bool(torch.equal(again, f["logits"])),
        first_step_rerouted_rel_err=_rel_err(rerouted, plain.float()),
    )
    del again, plain, rerouted, eng, run
    torch.cuda.empty_cache()
    graphs = cont["graphs"]
    narrow_name, wide_name = list(graphs)   # mixed/1, mixed/<chunk>

    # ---- static ----
    static = phase_static_path(cfg, lm, params, profile=profile, label="olmoe static")
    forward = static["prefill_calls"] + static["decode_calls"]
    if static["library"]["ragged_dot"] != per_pass * forward:
        raise AssertionError(f"olmoe static: ragged_dot {static['library']}, want "
                             f"{per_pass * forward}")
    first = static.pop("first_prefill_tokens")
    got, _ = lm.prefill(params, {"tokens": first}, 1024)
    with _moe_swapped(plain=True):
        ref, _ = plain_lm.prefill(params, {"tokens": first}, 1024)
    with _moe_swapped(routed_past_top_k=True):
        bad_logits, _ = lm.prefill(params, {"tokens": first}, 1024)
    static["first_prefill_rel_err"] = _rel_err(got, ref.float())
    static["first_prefill_argmax_agree"] = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    static["first_prefill_rerouted_rel_err"] = _rel_err(bad_logits, ref.float())
    static["bucket"] = int(first.shape[1])
    del got, ref, bad_logits, first

    # The grouped products' share of a replay's device time: 16 layers of
    # two d -> ff and one ff -> d products, timed alone in phase_moe_matrix
    # at the narrow (64 rows) and the wide (16,384 rows) step's rows.
    def product_ms(rows):
        t = {tuple(r["shape"][1:]): r["median_ms"] for r in matrix["shapes"]
             if r["arch"] == MOE_ARCH and r["shape"][3] == rows}
        d, ff = cfg.d_model, m.d_ff_expert
        return cfg.n_layers * (2 * t[(d, ff, rows)] + t[(ff, d, rows)])

    shares = {}
    for key, name, rows in (("narrow", narrow_name, 8 * m.top_k),
                            ("wide", wide_name, 8 * cont["first_step_width"] * m.top_k)):
        ms = product_ms(rows)
        shares[key] = {"grouped_ms": ms, "replay_ms": graphs[name]["replay_ms"],
                       "share": ms / graphs[name]["replay_ms"]}
    cont["grouped_share"] = shares
    peak = torch.cuda.max_memory_allocated() / 1e9
    cont["peak_mem_gb"] = peak
    summary = {
        "arch": cfg.name, "params_b": n_params / 1e9, "peak_mem_gb": peak,
        "continuous": {k: cont[k] for k in ("tokens_per_s", "mixed_steps", "wide_steps",
                                            "step_ms_narrow_mean", "step_ms_wide_mean",
                                            "step_idle", "grouped_share", "first_step_rel_err",
                                            "first_step_argmax_agree",
                                            "first_step_rerouted_rel_err",
                                            "first_step_eager_equals_replay", "launches",
                                            "library")},
        "static": {k: static[k] for k in ("tokens_per_s", "prefill_ms_mean",
                                          "decode_step_ms_mean", "first_prefill_rel_err",
                                          "first_prefill_argmax_agree",
                                          "first_prefill_rerouted_rel_err", "bucket", "launches",
                                          "library")},
        "static_replay_ms": static["graphs"]["decode"]["replay_ms"],
    }
    print("[olmoe] " + json.dumps(summary))
    for label, rel, control in (
            ("first mixed step", cont["first_step_rel_err"], cont["first_step_rerouted_rel_err"]),
            ("first prefill", static["first_prefill_rel_err"],
             static["first_prefill_rerouted_rel_err"])):
        print(f"[olmoe] {label}, kernels vs plain versions: logits max |diff| / max |plain| "
              f"{rel:.3e} (tol {MOE_LOGITS_TOL}); routed past the top k {control:.3e}")
        if rel > MOE_LOGITS_TOL:
            raise AssertionError(f"olmoe {label}: kernels differ from the plain versions: {rel}")
        if control <= MOE_LOGITS_TOL:
            raise AssertionError(f"olmoe {label}: the logits check cannot tell a wrong router "
                                 f"from the kernels: {control}")
    del lm, plain_lm, params
    torch.cuda.empty_cache()
    return cont, static


# ---- the enc-dec and VLM families (A13) ----------------------------------------


def _family_counts(cfg) -> tuple[int, int]:
    """(B2 launches a prefill or a training forward, B3 launches a decode
    step), from the code: the enc-dec runs its encoder's layers and, per
    decoder layer, a self and a cross attention (``encdec_prefill``; the
    decode step's cross attention reads the static encoder K/V through B3
    too); the VLM one attention a layer."""
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def phase_family_path(arch: str, profile: bool = False) -> dict:
    """Full-width ``arch`` (seamless-m4t-medium: 12 + 12 layers, d 1024, 16
    heads of 64; phi-3-vision-4_2b: 32 layers, d 3072, 32 heads of 96),
    random weights from seed 0, serving the 12 main requests through the
    static engine (the reference's choice under ``auto``), batch 8, max_len
    1024: two groups of other buckets through one captured decode step.
    Every request ok with 32 tokens, no non-finite logit; ``flash_fwd`` ==
    per-prefill attentions x prefills, ``contig_decode`` == per-step
    attentions x decode steps (``_family_counts``), nothing else; the
    decode graph replayed against its eager step to the bit. Then the
    direct checks on random embeddings (see FAMILY_LOGITS_TOL)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(arch)
    encdec = cfg.family == "encdec"
    label = "seamless" if encdec else "phi3v"
    gc.collect()   # the earlier phases' dead engines, so the peak is this phase's own
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda")
    params = lm.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    per_prefill, per_step = _family_counts(cfg)
    print(f"[{label}] {cfg.name} ({cfg.family}): "
          + (f"{cfg.n_encoder_layers} + {cfg.n_layers}" if encdec else f"{cfg.n_layers}")
          + f" layers, d {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {n_params / 1e9:.3f} B params ({cfg.param_dtype}), init "
          f"{time.perf_counter() - t0:.1f} s")

    eng = ServeEngine(lm, params, scheduler="static", batch_size=8, max_len=1024, device="cuda")
    bad = _check_logits(eng, lm)
    rng = np.random.default_rng(96)
    eng.generate([Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                          max_new_tokens=2, eos_id=-1) for n in (300, 20)])
    replays = eng.step_graphs()["decode"].replays
    reqs = _main_requests(cfg.vocab)
    eng.tracer.clear()
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    spans, calls = _step_spans(eng)
    replayed = eng.step_graphs()["decode"].replays - replays
    buckets = [len(eng._pad_batch([r.tokens for r in reqs[i:i + 8]], eng._cap)[0])
               for i in (0, 8)]

    statuses = [r.status for r in results]
    assert all(st == "ok" for st in statuses), statuses
    assert all(r.steps == 32 and len(r.tokens) == 32 for r in results), [r.steps for r in results]
    assert int(bad.item()) == 0, f"{int(bad.item())} non-finite logits"
    assert calls == {"prefill": 2, "decode": 62}, calls
    assert buckets[0] != buckets[1], buckets
    assert eng.compiled_step_count() == 1 and replayed == calls["decode"], (replayed, calls)
    want = {name: 0 for name in launches}
    want["flash_fwd"] = per_prefill * calls["prefill"]
    want["contig_decode"] = per_step * calls["decode"]
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, want {want}")
    tokens = sum(r.steps for r in results)
    out = {
        "arch": cfg.name, "family": cfg.family, "params_b": n_params / 1e9,
        "requests": len(results), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_p50_s": float(np.median([r.ttft_s for r in results])),
        "tpot_p50_s": float(np.nanmedian([r.tpot_s for r in results])),
        "prefill_calls": calls["prefill"], "decode_calls": calls["decode"], "buckets": buckets,
        "prefix": eng._prefix,
        "prefill_ms_mean": float(np.mean(spans["serve.prefill"])),
        "decode_step_ms_mean": float(np.mean(spans["serve.decode_step"])),
        "decode_step_ms_range": [min(spans["serve.decode_step"]),
                                 max(spans["serve.decode_step"])],
        "graph_replays": replayed, "launches": launches,
        "launches_per_prefill": launches["flash_fwd"] / calls["prefill"],
        "launches_per_decode_step": launches["contig_decode"] / calls["decode"],
    }
    print(f"[{label}] " + json.dumps(out))
    out["graphs"] = phase_graphs(eng, label)
    out["step_idle"] = _step_idle(spans["serve.decode_step"], out["graphs"]["decode"]["replay_ms"])
    print(f"[{label}] decode steps, wall against a replay's device time: "
          + json.dumps(out["step_idle"]))
    if profile:
        out["profile"] = phase_profile(eng, cfg, label, tuple(spans))
    first = torch.as_tensor(eng._pad_batch([r.tokens for r in reqs[:8]], eng._cap),
                            device="cuda")
    del eng
    torch.cuda.empty_cache()

    plain_lm = build_model(cfg.with_(attn_impl="torch"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2026)
    b = first.shape[0]
    if encdec:
        out["direct"] = _encdec_direct(lm, plain_lm, params, first, gen)
    else:
        out["direct"] = _vlm_direct(lm, plain_lm, params, first, gen)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{label}] direct, random embeddings, kernels vs plain versions: "
          + json.dumps(out["direct"]) + f" (limit {FAMILY_LOGITS_TOL}); peak "
          f"{out['peak_mem_gb']:.2f} GB; batch {b}")
    d = out["direct"]
    if d["rel_err"] > FAMILY_LOGITS_TOL:
        raise AssertionError(f"{arch}: the kernels differ from the plain versions on random "
                             f"embeddings: {d}")
    for name, err in d["controls"].items():
        if err <= FAMILY_LOGITS_TOL:
            raise AssertionError(f"{arch}: the check cannot tell the wrong control {name} from "
                                 f"the kernels: {d['controls']}")
    del lm, plain_lm, params
    torch.cuda.empty_cache()
    return out


def _encdec_direct(lm, plain_lm, params, tgt, gen) -> dict:
    """The enc-dec's prefill of the first group's target tokens against a
    random source of ENCDEC_SRC_LEN frames, then one decode step, with the
    kernels and with the plain versions; the decode step also with two
    wrong cross attentions (kernels, on the kernels' caches)."""
    cfg = lm.cfg
    b = tgt.shape[0]
    src = torch.randn((b, ENCDEC_SRC_LEN, cfg.d_model), generator=gen, device="cuda").to(
        cfg.activation_dtype())
    batch = {"src_embeds": src, "tgt_tokens": tgt}
    got, caches = lm.prefill(params, batch, 1024)
    ref, ref_caches = plain_lm.prefill(params, batch, 1024)
    nxt = got[:, -1].argmax(-1).to(torch.int32)[:, None]

    def decode(model, c):
        """One decode step on a copy of the caches ``c`` (the cross K/V in
        1024 rows, zero past the source, so a wrong length reads zeros,
        never past the buffer)."""
        cc = {part: {k: v.clone() for k, v in c[part].items()} for part in c}
        return model.decode_step(params, nxt, cc)[0]

    step = decode(lm, caches)
    ref_step = decode(plain_lm, ref_caches)
    torch.cuda.synchronize()
    rec = {"src_len": ENCDEC_SRC_LEN, "tgt_len": int(tgt.shape[1]),
           "prefill_rel_err": _rel_err(got, ref.float()),
           "decode_rel_err": _rel_err(step, ref_step.float()),
           "prefill_argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
           "decode_argmax_agree": (step.argmax(-1) == ref_step.argmax(-1)).float().mean().item(),
           "cross_kv_rel_err": max(_rel_err(caches["cross"][n], ref_caches["cross"][n].float())
                                   for n in ("k", "v"))}
    rec["rel_err"] = max(rec["prefill_rel_err"], rec["decode_rel_err"])
    swapped = dict(caches, cross=dict(caches["cross"],
                                      k=caches["cross"]["k"].roll(1, dims=1).contiguous(),
                                      v=caches["cross"]["v"].roll(1, dims=1).contiguous()))
    self_len = dict(caches, cross=dict(caches["cross"], kv_len=caches["self"]["len"].clone()))
    rec["controls"] = {"cross_kv_of_another_row": _rel_err(decode(lm, swapped), ref_step.float()),
                       "self_len_as_kv_len": _rel_err(decode(lm, self_len), ref_step.float())}
    return rec


def _vlm_direct(lm, plain_lm, params, tokens, gen) -> dict:
    """The VLM's prefill of VLM_TRAIN_PREFIX random prefix embeddings before
    the first group's tokens, with the kernels and with the plain
    versions: the logits and the KV caches (every layer's, the prefix
    positions among them); the kernels also with ``vision_proj`` dropped."""
    cfg = lm.cfg
    b = tokens.shape[0]
    pe = torch.randn((b, VLM_TRAIN_PREFIX, cfg.d_model), generator=gen, device="cuda").to(
        cfg.activation_dtype())
    batch = {"tokens": tokens, "prefix_embeds": pe}

    def run(model, p):
        logits, caches = model.prefill(p, batch, 1024)
        return logits, caches

    got, caches = run(lm, params)
    ref, ref_caches = run(plain_lm, params)
    n = VLM_TRAIN_PREFIX + tokens.shape[1]

    def err(logits, c):
        kv = max(_rel_err(c[name][:, :, :n], ref_caches[name][:, :, :n].float())
                 for name in ("k", "v"))
        return max(_rel_err(logits, ref.float()), kv), kv

    rel, kv = err(got, caches)
    rec = {"prefix": VLM_TRAIN_PREFIX, "tokens": int(tokens.shape[1]),
           "logits_rel_err": _rel_err(got, ref.float()), "kv_rel_err": kv, "rel_err": rel,
           "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float().mean().item()}
    del caches
    dropped = dict(params, vision_proj={"w": torch.eye(cfg.d_model, dtype=cfg.parameter_dtype(),
                                                       device="cuda")})
    bad_logits, bad_caches = run(lm, dropped)
    rec["controls"] = {"vision_proj_dropped": err(bad_logits, bad_caches)[0]}
    return rec


def phase_train_family(arch: str) -> dict:
    """Full-width ``arch`` (the enc-dec or the VLM), random weights from
    seed 0, remat full, 4 adamw_factored steps of batch 4 x 1024 through
    make_train_state + make_train_step: the tokens of DataConfig(seed=0)
    and seeded random embeddings (the enc-dec's source of 1024 frames
    beside 1024 target tokens; the VLM's prefix of VLM_TRAIN_PREFIX before
    768 tokens). Launches from the code: ``flash_fwd`` 2 x attentions x
    steps (forward and remat recompute), each backward kernel attentions x
    steps (``_family_counts``), nothing else. Step 0 against the plain
    versions on the same weights and batch (TRAIN_LOSS_TOL,
    TRAIN_GNORM_RTOL), and its attention weight gradients (the ends of
    each stack: the VLM's first and last layer; the enc-dec's first and
    last encoder layer, and the self and cross attention of its first and
    last decoder layer) within RESIDUAL_ATTN_GRAD_TOL of the plain
    backward's on B2's residuals, which the two wrong backwards
    (_CONTROLS) must exceed (against the plain attention, printed beside
    with no limit, the forward's rounding of P hides the backward, as at
    zamba2); the peak under 80 GB. The loss falls: each of the 4 batches' loss after the steps
    lies below its loss before them (the step losses, each on its own
    batch, need not fall in order: phi-3's rise at step 2, with the plain
    versions too)."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.data import DataConfig, SyntheticPacked
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import named_leaves
    from repro_torch.train.step import make_train_state, make_train_step

    steps, batch, seq = 4, 4, 1024
    cfg = get_config(arch).with_(attn_impl="auto", remat="full")
    encdec = cfg.family == "encdec"
    label = "train-" + ("seamless" if encdec else "phi3v")
    attns, _ = _family_counts(cfg)
    tcfg = _train_cfgs(steps, optimizer="adamw_factored")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda")
    state = make_train_state(lm, tcfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in named_leaves(state["params"]))
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"[{label}] {cfg.name}: {n_params / 1e9:.3f} B params ({cfg.param_dtype}), remat "
          f"{cfg.remat}, {tcfg.optimizer}: params + optimizer state {state_gb:.2f} GB, init "
          f"{time.perf_counter() - t0:.1f} s")
    data = SyntheticPacked(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = []
    for i in range(steps):
        tokens = torch.as_tensor(data.batch(i)["tokens"], device="cuda")
        if encdec:
            src = torch.randn((batch, seq, cfg.d_model), generator=gen, device="cuda")
            batches.append({"src_embeds": src.to(cfg.activation_dtype()), "tgt_tokens": tokens})
        else:
            pe = torch.randn((batch, VLM_TRAIN_PREFIX, cfg.d_model), generator=gen,
                             device="cuda")
            batches.append({"tokens": tokens[:, :seq - VLM_TRAIN_PREFIX],
                            "prefix_embeds": pe.to(cfg.activation_dtype())})
    params = state["params"]
    t0 = time.perf_counter()
    plain_lm = build_model(cfg.with_(attn_impl="torch"), device="cuda")
    plain_loss, plain_gnorm, plain_attn = _step0_grads(plain_lm, params, batches[0])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del plain_lm
    torch.cuda.empty_cache()
    with _plain_backward():
        _, _, resid_attn = _step0_grads(lm, params, batches[0])
    grad_errs, plain_errs = {}, {}
    for name in (None, *_CONTROLS):
        _, _, attn = _step0_grads(lm, params, batches[0], control=name)
        grad_errs[name or "kernels"] = {leaf: _rel_l2(g, resid_attn[leaf])
                                        for leaf, g in attn.items()}
        plain_errs[name or "kernels"] = {leaf: _rel_l2(g, plain_attn[leaf])
                                         for leaf, g in attn.items()}
        del attn
    del plain_attn, resid_attn
    torch.cuda.empty_cache()
    print(f"[{label}] step 0 attention weight gradients, ||diff|| / ||plain|| against the "
          "plain backward on B2's residuals: " + json.dumps(grad_errs) + "; against the plain "
          "attention, forward too (no limit): " + json.dumps(plain_errs))

    def batch_losses(model, p):
        with torch.no_grad():
            return [float(model.loss(p, b)[0]) for b in batches]

    before = batch_losses(lm, params)
    step_fn = make_train_step(lm, tcfg, ParallelConfig())
    records = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])  # waits for the card, as run_training's span does
        dt = time.perf_counter() - t0
        rec = {"step": i, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "step_s": dt, "tokens_per_s": batch * seq / dt}
        print(f"[{label}] " + json.dumps(rec))
        records.append(rec)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in records]
    after = batch_losses(lm, state["params"])
    want = {name: 0 for name in launches}
    want["flash_fwd"] = 2 * attns * steps
    for name in ("flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkv"):
        want[name] = attns * steps
    out = {"arch": cfg.name, "steps": steps, "batch": batch, "seq": seq,
           "params_b": n_params / 1e9, "state_gb": state_gb,
           "plain_step0": {"loss": plain_loss, "grad_norm": plain_gnorm, "seconds": plain_s},
           "losses": losses, "step_s": [r["step_s"] for r in records],
           "tokens_per_s": [r["tokens_per_s"] for r in records],
           "grad_norms": [r["grad_norm"] for r in records], "peak_mem_gb": peak,
           "batch_losses_before": before, "batch_losses_after": after,
           "attn_grad_rel_err": grad_errs,
           "attn_grad_rel_err_vs_plain_attention": plain_errs,
           "launches": launches, "launches_want": want, "attentions_per_forward": attns}
    print(f"[{label}] " + json.dumps(out))
    if launches != want:
        raise AssertionError(f"{arch} training launches {launches}, want {want}")
    if not all(np.isfinite(losses)) or abs(losses[0] - math.log(cfg.vocab)) > 1.5:
        raise AssertionError(f"{arch} step 0 loss {losses[0]} not finite or not within 1.5 of "
                             f"ln(vocab) = {math.log(cfg.vocab):.3f}")
    if not all(a < b for a, b in zip(after, before)):
        raise AssertionError(f"{arch} loss did not fall over {steps} steps: batch losses "
                             f"before {before}, after {after}")
    if peak >= TRAIN_MEM_LIMIT_GB:
        raise AssertionError(f"{arch} training peaked at {peak:.2f} GB")
    d_loss = abs(plain_loss - losses[0])
    d_gnorm = abs(plain_gnorm - records[0]["grad_norm"]) / plain_gnorm
    out.update(step0_loss_diff=d_loss, step0_gnorm_rel_diff=d_gnorm)
    print(f"[{label}] step 0, kernels vs plain versions: loss {losses[0]:.5f} vs "
          f"{plain_loss:.5f} (|diff| {d_loss:.2e}, tol {TRAIN_LOSS_TOL}); grad_norm "
          f"{records[0]['grad_norm']:.5f} vs {plain_gnorm:.5f} (rel diff {d_gnorm:.2e}, tol "
          f"{TRAIN_GNORM_RTOL}); step {np.mean(out['step_s'][1:]):.3f} s, "
          f"{np.mean(out['tokens_per_s'][1:]):.0f} tokens/s (steps 1-3), peak {peak:.2f} GB")
    if d_loss > TRAIN_LOSS_TOL or d_gnorm > TRAIN_GNORM_RTOL:
        raise AssertionError(f"{arch} training step 0 with the kernels disagrees with the "
                             "plain versions")
    worst = max(grad_errs["kernels"].values())
    print(f"[{label}] step 0 attention weight gradients ({len(grad_errs['kernels'])} leaves) "
          f"against the plain backward on B2's residuals: kernels worst {worst:.3e} (tol "
          f"{RESIDUAL_ATTN_GRAD_TOL}); controls worst " + ", ".join(
              f"{c} {max(grad_errs[c].values()):.3e}" for c in _CONTROLS)
          + "; against the plain attention (forward too, no limit): kernels worst "
          f"{max(plain_errs['kernels'].values()):.3e}, float8_dqkv "
          f"{max(plain_errs['float8_dqkv'].values()):.3e}")
    if worst > RESIDUAL_ATTN_GRAD_TOL:
        raise AssertionError(f"{arch} attention weight gradients with the kernels differ from "
                             f"the plain backward's: {grad_errs['kernels']}")
    for c in _CONTROLS:
        if max(grad_errs[c].values()) <= RESIDUAL_ATTN_GRAD_TOL:
            raise AssertionError(f"{arch}: the gradient check cannot tell control {c} from a "
                                 f"sound backward: {grad_errs[c]}")
    del state, step_fn, lm, params, batches
    torch.cuda.empty_cache()
    return out


def _check_logits(eng, lm):
    """A device counter of non-finite logits, added to by the engine's
    prefill and by its decode step (captured with the step, so counted at
    every replay)."""
    bad = torch.zeros((), dtype=torch.int64, device="cuda")

    def checked(fn):
        def run(*args):
            logits, caches = fn(*args)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, caches
        return run

    eng.lm = dataclasses.replace(lm, prefill=checked(lm.prefill),
                                 decode_step=checked(lm.decode_step))
    return bad


def _step_spans(eng) -> tuple[dict, dict]:
    """The static engine's step spans in ms, and how many of each."""
    spans: dict[str, list] = {"serve.prefill": [], "serve.decode_step": []}
    for ev in eng.tracer.events():
        if ev.name in spans:
            spans[ev.name].append(ev.dur_ns / 1e6)
    return spans, {"prefill": len(spans["serve.prefill"]),
                   "decode": len(spans["serve.decode_step"])}


def phase_graphs(eng, label: str) -> dict:
    """Each of ``eng``'s captured steps replayed once against the same step
    run eagerly on the same inputs (the last step the run staged at that
    width) and the same state (restored from a snapshot): the logits, the
    greedy tokens and every cache or pool page the step writes must be
    equal to the bit."""
    out = {}
    for name, g in eng.step_graphs().items():
        assert g.graph is not None, f"{label} {name} was not captured"
        diffs = g.replay_against_eager()
        torch.cuda.synchronize()
        unequal = {k: v["max_abs_diff"] for k, v in diffs.items() if not v["equal"]}
        if unequal:
            raise AssertionError(f"{label} {name}: replay differs from the eager step: {unequal}")
        # The step's device time: one replay between two CUDA events (the
        # host's part, one graph launch, is microseconds). The replays run
        # on from the state the run left; nothing reads it after.
        replay_ms = _median_ms(g, warmup=1, reps=5, batched=False)
        out[name] = {"launches_per_replay": g.launches, "compared": len(diffs),
                     "unequal": unequal, "replay_ms": replay_ms}
        print(f"[graph] {label} {name}: replay against eager on {len(diffs)} tensors "
              f"(outputs and state): equal to the bit; launches a replay "
              f"{json.dumps(g.launches)}; device time of a replay {replay_ms:.3f} ms")
    return out


def _step_idle(walls: list, replay_ms: float) -> dict:
    """A step's mean wall (its span) against its graph's device time: the
    share of the step the card idles while the host plans, stages and
    samples."""
    mean = float(np.mean(walls))
    return {"step_ms_mean": mean, "replay_ms": replay_ms, "idle_share": 1.0 - replay_ms / mean}


def phase_unsafe_capture() -> str:
    """A step that reads a value on the host (an ``.item()`` inside it)
    must make its capture raise, naming the step; the card works after."""
    from repro_torch.serve.step_graph import StepCaptureError, StepGraph

    x = torch.arange(4, dtype=torch.float32, device="cuda")
    step = StepGraph("host-read step", lambda n: (x * n.sum().item(),), {"n": (2,)},
                     device="cuda")
    try:
        step.capture()
    except StepCaptureError as err:
        msg = str(err)
    else:
        raise AssertionError("the capture of a step with an .item() inside did not raise")
    assert "host-read step" in msg and step.graph is None, msg
    assert float((x + 1).sum()) == 10.0
    print(f"[graph] a step with an .item() inside: capture raised: {msg[:300]}")
    return msg


def _kernel_kind(name: str) -> str:
    for kernel in ("paged_decode", "flash_fwd", "contig_decode", "flash_bwd_delta",
                   "flash_bwd_dq", "flash_bwd_dkv", "ssd_kernel"):
        if kernel in name:
            return kernel
    if any(k in name.lower() for k in ("gemm", "gemv", "xmma", "nvjet", "cutlass", "splitk")):
        return "matmul"
    return "other"


def _profile(run, label: str, steps: int) -> dict:
    """``run()`` under torch.profiler: device busy time (the union of kernel
    intervals) against the host's wall time, and device time by kind of
    kernel; ``steps`` is the number of steps ``run`` took."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us = _busy_us(spans)
    # From the first graph replay on (the static paths' eager prefill
    # before it): the device's idle share over the replayed steps.
    replays = [e.time_range.start for e in events if e.name.startswith("cudaGraphLaunch")]
    replayed = None
    if replays and spans:
        t0_us, t1_us = min(replays), max(b for _, b in spans)
        busy_in = _busy_us([(max(a, t0_us), b) for a, b in spans if b > t0_us])
        replayed = {"window_s": (t1_us - t0_us) / 1e6, "device_busy_s": busy_in / 1e6,
                    "device_idle_share": 1.0 - busy_in / max(t1_us - t0_us, 1e-9),
                    "graph_launches": len(replays)}
    by_kind: dict[str, list] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        for table, key in ((by_kind, _kernel_kind(e.name)), (by_name, e.name[:90])):
            acc = table.setdefault(key, [0.0, 0])
            acc[0] += dur / 1e6
            acc[1] += 1
    out = {
        "path": label,
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "from_first_replay": replayed,
        "steps": steps,
        "kernels": len(kernels),
        "kernels_per_step": len(kernels) / max(steps, 1),
        "by_kind_s": {k: v[0] for k, v in by_kind.items()},
        "by_kind_launches": {k: v[1] for k, v in by_kind.items()},
        "top": sorted(([k, v[0], v[1]] for k, v in by_name.items()), key=lambda r: -r[1])[:12],
    }
    print("[profile] " + json.dumps(out))
    return out


def _busy_us(spans) -> float:
    """Length of the union of sorted (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile(eng, cfg, label: str, step_spans: tuple) -> dict:
    """Half of the main path's requests (16 new tokens each, to keep the
    trace small) under torch.profiler; a step is one span named in
    ``step_spans``."""
    reqs = [dataclasses.replace(r, max_new_tokens=16) for r in _main_requests(cfg.vocab)[:6]]
    eng.tracer.clear()
    prof = _profile(lambda: eng.generate(reqs), label, 0)
    steps = sum(ev.name in step_spans for ev in eng.tracer.events())
    prof.update(steps=steps, kernels_per_step=prof["kernels"] / max(steps, 1))
    rep = prof["from_first_replay"]
    print(f"[profile] {label}: {steps} steps, {prof['kernels_per_step']:.0f} kernels a step; "
          f"device idle {prof['device_idle_share']:.3f} of the run, "
          + (f"{rep['device_idle_share']:.3f} from the first graph replay on" if rep
             else "no graph replay seen"))
    return prof


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_small_model() -> float:
    """A small bf16 model (head dim 64, GQA 4:2): logits of one prefill chunk
    and 8 decode steps with the kernel against the plain version, both fed
    the same tokens and caches built the same way."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import page_geometry

    base = get_config("deepseek-7b").reduced().with_(
        dtype="bfloat16", param_dtype="bfloat16", d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, vocab=1024, kv_layout="paged", page_size=16,
    )
    worst = 0.0
    runs = {}
    for impl in ("cuda", "torch"):
        cfg = base.with_(attn_impl=impl)
        lm = build_model(cfg, device="cuda")
        params = lm.init(7)
        page, nb = page_geometry(cfg, 96)
        shape = (cfg.n_layers, 2 * nb + 1, page, cfg.n_kv_heads, cfg.hd)
        # Shuffled block tables over pages 1.. (page 0 takes invalid rows).
        perm = torch.randperm(2 * nb, generator=torch.Generator().manual_seed(0)) + 1
        caches = {
            "k_pages": torch.zeros(shape, dtype=torch.bfloat16, device="cuda"),
            "v_pages": torch.zeros(shape, dtype=torch.bfloat16, device="cuda"),
            "block_table": perm.reshape(2, nb).to("cuda", torch.int32),
            "len": torch.zeros(2, dtype=torch.int32, device="cuda"),
        }
        rng = np.random.default_rng(3)
        toks = torch.as_tensor(rng.integers(2, cfg.vocab, size=(2, 40)), device="cuda")
        caches["q_len"] = torch.tensor([40, 23], dtype=torch.int32, device="cuda")
        logits, caches = lm.decode_step(params, toks, caches)
        seq = [logits.float()]
        nxt = torch.as_tensor(rng.integers(2, cfg.vocab, size=(8, 2, 1)), device="cuda")
        caches["q_len"] = torch.ones(2, dtype=torch.int32, device="cuda")
        for s in range(8):
            logits, caches = lm.decode_step(params, nxt[s], caches)
            seq.append(logits.float())
        runs[impl] = seq
    for a, b in zip(runs["cuda"], runs["torch"]):
        assert torch.isfinite(a).all()
        worst = max(worst, (a - b).abs().max().item())
    print(f"[small] bf16 model logits, kernel vs plain: max_abs_err={worst:.3e} "
          f"(tol {SMALL_MODEL_TOL})")
    assert worst <= SMALL_MODEL_TOL, worst
    return worst


def phase_small_static() -> float:
    """Small bf16 models (head dim 64, GQA 4:2) on the static path: prefill
    logits and 12 decode steps with the kernels against the plain versions,
    both fed the same tokens, with full attention and with a 48-position
    window (a ring buffer the prompt and decode steps overrun)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    base = get_config("deepseek-7b").reduced().with_(
        dtype="bfloat16", param_dtype="bfloat16", d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, vocab=1024,
    )
    worst = 0.0
    for window in (None, 48):
        runs = {}
        for impl in ("cuda", "torch"):
            cfg = base.with_(attn_impl=impl, window=window)
            lm = build_model(cfg, device="cuda")
            params = lm.init(7)
            rng = np.random.default_rng(3)
            toks = torch.as_tensor(rng.integers(2, cfg.vocab, size=(2, 40)), device="cuda")
            logits, caches = lm.prefill(params, {"tokens": toks}, 96)
            seq = [logits.float()]
            nxt = torch.as_tensor(rng.integers(2, cfg.vocab, size=(12, 2, 1)), device="cuda")
            for step in range(12):
                logits, caches = lm.decode_step(params, nxt[step], caches)
                seq.append(logits.float())
            runs[impl] = seq
        err = 0.0
        for a, b in zip(runs["cuda"], runs["torch"]):
            assert torch.isfinite(a).all()
            err = max(err, (a - b).abs().max().item())
        print(f"[small-static] bf16 model window={window}, kernels vs plain: prefill + 12 "
              f"decode steps max_abs_err={err:.3e} (tol {SMALL_MODEL_TOL})")
        assert err <= SMALL_MODEL_TOL, err
        worst = max(worst, err)
    return worst


# ---- phase 3b: training ---------------------------------------------------------


def _train_cfgs(steps: int, **kw):
    """The launcher's schedule for ``steps`` steps: lr 3e-4, warmup
    max(steps // 20, 1) (``TrainConfig``'s default 100-step warmup would
    barely move the weights in a few steps)."""
    from repro_torch.configs import TrainConfig

    return TrainConfig(lr=3e-4, total_steps=steps, warmup_steps=max(steps // 20, 1), **kw)


class _GradMap(torch.autograd.Function):
    """Identity forward; the backward passes the gradient through ``fn``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _to_float8(g):
    """g rounded to float8 e4m3 (3 mantissa bits) under a per-tensor scale."""
    scale = 448.0 / g.abs().amax().float().clamp(min=1e-30)
    return (g.float() * scale).to(torch.float8_e4m3fn).float().div(scale).to(g.dtype)


# The deliberately wrong attention backwards of the gradient check: maps
# applied to the gradients of (q, k, v) that the kernels return.
_CONTROLS = {"dk_zero": (None, torch.zeros_like, None),
             "float8_dqkv": (_to_float8, _to_float8, _to_float8)}


@contextlib.contextmanager
def _grad_control(name):
    """Within the block, ``ops.attention`` (the kernels, both directions)
    has its q, k, v gradients passed through control ``name``'s maps."""
    from repro_torch.kernels import ops

    real = ops.attention

    def attention(q, k, v, **kw):
        q, k, v = (x if f is None else _GradMap.apply(x, f)
                   for x, f in zip((q, k, v), _CONTROLS[name]))
        return real(q, k, v, **kw)

    ops.attention = attention
    try:
        yield
    finally:
        ops.attention = real


def _step0_grads(lm, params, batch, control=None, ssd_timer=None) -> tuple[float, float, dict]:
    """Loss, global gradient norm and attention weight gradients for one
    batch, without an update: those of the first and the last layer of
    each list of layers (``layers``; the enc-dec's ``encoder`` and
    ``decoder``, whose layers hold ``self_attn`` and ``cross_attn``), or of
    the shared block (zamba2's ``layers/shared/attn``; mamba2 has none).
    ``control`` names a
    deliberately wrong attention backward (``_CONTROLS``); ``ssd_timer`` (a
    list) receives a pair of CUDA events around each SSD backward."""
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import global_norm, named_leaves

    leaves = list(named_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    real_bwd = ops._SSD.backward
    if ssd_timer is not None:
        def timed(ctx, gy, gs):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real_bwd(ctx, gy, gs)
            ev[1].record()
            ssd_timer.append(ev)
            return out

        ops._SSD.backward = staticmethod(timed)
    try:
        with _grad_control(control) if control else contextlib.nullcontext():
            loss, _ = lm.loss(params, batch)
            grads = torch.autograd.grad(loss, [p for _, p in leaves])
    finally:
        ops._SSD.backward = staticmethod(real_bwd)
        for _, p in leaves:
            p.requires_grad_(False)
    if "layers" not in params or isinstance(params["layers"], list):
        ends = {k: (0, len(params[k]) - 1) for k in ("layers", "encoder", "decoder")
                if k in params}
        attn = {(f"layer{path[1]}.{path[3]}" if path[0] == "layers"
                 else f"{path[0]}{path[1]}.{path[2]}.{path[3]}"): g
                for (path, _), g in zip(leaves, grads)
                if path[0] in ends and path[1] in ends[path[0]]
                and path[2] in ("attn", "self_attn", "cross_attn")}
    else:
        attn = {f"shared.{path[3]}": g for (path, _), g in zip(leaves, grads)
                if path[:3] == ("layers", "shared", "attn")}
    return loss.item(), global_norm(list(grads)).item(), attn


def phase_train_main(profile: bool = False) -> dict:
    """Full-width deepseek-7b (30 layers, bf16, remat full, the CUDA kernels
    in both directions, sawtooth) takes 4 adamw_factored steps of batch 4 x
    1024 tokens from DataConfig(seed=0) through make_train_state +
    make_train_step. Before them, the same weights give step 0's loss and
    gradient norm through the plain attention (impl torch) for comparison."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.data import DataConfig, SyntheticPacked
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import named_leaves
    from repro_torch.train.step import make_train_state, make_train_step

    steps, batch, seq = 4, 4, 1024
    cfg = get_config("deepseek-7b").with_(attn_impl="auto")
    tcfg = _train_cfgs(steps, optimizer="adamw_factored")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda")
    state = make_train_state(lm, tcfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in named_leaves(state["params"]))
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
          f"{n_params / 1e9:.3f} B params ({cfg.param_dtype}), remat {cfg.remat}, "
          f"{tcfg.optimizer}: params + optimizer state {state_gb:.2f} GB, "
          f"init {time.perf_counter() - t0:.1f} s")
    data = SyntheticPacked(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
    batches = [data.batch(i) for i in range(steps)]

    plain_lm = build_model(cfg.with_(attn_impl="torch"), device="cuda")
    t0 = time.perf_counter()
    plain_loss, plain_gnorm, plain_attn = _step0_grads(plain_lm, state["params"], batches[0])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del plain_lm
    torch.cuda.empty_cache()
    grad_errs = {}
    for name in (None, *_CONTROLS):
        _, _, attn = _step0_grads(lm, state["params"], batches[0], control=name)
        grad_errs[name or "kernels"] = {leaf: _rel_l2(g, plain_attn[leaf])
                                        for leaf, g in attn.items()}
        del attn
    del plain_attn
    torch.cuda.empty_cache()
    print("[train] step 0 attention weight gradients, ||diff|| / ||plain|| against the plain "
          "attention: " + json.dumps(grad_errs))

    step_fn = make_train_step(lm, tcfg, ParallelConfig())
    records = []
    cuda_lib.reset_launch_counts()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])  # waits for the card, as run_training's span does
        dt = time.perf_counter() - t0
        rec = {"step": i, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "step_s": dt, "tokens_per_s": batch * seq / dt}
        print("[train] " + json.dumps(rec))
        records.append(rec)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in records]
    want = {"flash_fwd": 2 * cfg.n_layers * steps, "flash_bwd_delta": cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps, "flash_bwd_dkv": cfg.n_layers * steps,
            "paged_decode": 0, "contig_decode": 0, "ssd": 0}
    out = {
        "steps": steps, "batch": batch, "seq": seq, "losses": losses,
        "step_s": [r["step_s"] for r in records],
        "tokens_per_s": [r["tokens_per_s"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records],
        "peak_mem_gb": peak, "state_gb": state_gb, "launches": launches,
        "plain_step0": {"loss": plain_loss, "grad_norm": plain_gnorm, "seconds": plain_s},
        "attn_grad_rel_err": grad_errs,
    }
    print("[train] " + json.dumps(out))
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    if not all(np.isfinite(losses)) or abs(losses[0] - math.log(cfg.vocab)) > 1.5:
        raise AssertionError(f"step 0 loss {losses[0]} not finite or not within 1.5 of "
                             f"ln(vocab) = {math.log(cfg.vocab):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over {steps} steps: {losses}")
    d_loss = abs(plain_loss - losses[0])
    d_gnorm = abs(plain_gnorm - records[0]["grad_norm"]) / plain_gnorm
    print(f"[train] step 0, kernels vs plain attention: loss {losses[0]:.5f} vs {plain_loss:.5f} "
          f"(|diff| {d_loss:.2e}, tol {TRAIN_LOSS_TOL}); grad_norm {records[0]['grad_norm']:.5f} "
          f"vs {plain_gnorm:.5f} (rel diff {d_gnorm:.2e}, tol {TRAIN_GNORM_RTOL})")
    if d_loss > TRAIN_LOSS_TOL or d_gnorm > TRAIN_GNORM_RTOL:
        raise AssertionError("training step 0 with the kernels disagrees with the plain version")
    worst = max(grad_errs["kernels"].values())
    print(f"[train] step 0 attention weight gradients: kernels worst {worst:.3e} (tol "
          f"{ATTN_GRAD_TOL}); controls worst " + ", ".join(
              f"{c} {max(grad_errs[c].values()):.3e}" for c in _CONTROLS))
    if worst > ATTN_GRAD_TOL:
        raise AssertionError(f"attention weight gradients with the kernels differ from the "
                             f"plain attention's: {grad_errs['kernels']}")
    for c in _CONTROLS:
        if max(grad_errs[c].values()) <= ATTN_GRAD_TOL:
            raise AssertionError(f"the gradient check cannot tell control {c} from a sound "
                                 f"backward: {grad_errs[c]}")
    if profile:
        out["profile"] = _profile(lambda: step_fn(state, batches[0]), "train", 1)
    del state, step_fn, lm
    torch.cuda.empty_cache()
    return out


def _small_train_cfg(**kw):
    from repro_torch.configs import get_config

    return get_config("deepseek-7b").reduced().with_(
        dtype="bfloat16", param_dtype="bfloat16", d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, vocab=1024, remat="full", q_block=64, kv_block=64, **kw)


def phase_train_loop() -> dict:
    """run_training on a small bf16 config with the kernels: a crash
    injected at step 2, then a resume from the checkpoint, against an
    uninterrupted run; checkpoints under build/ (ignored by git), removed
    at the end."""
    import shutil

    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train.fault_tolerance import FailureInjector
    from repro_torch.train.loop import run_training

    cfg = _small_train_cfg()
    lm = build_model(cfg, device="cuda")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=4, seed=0)
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def run(name, **kw):
        tcfg = _train_cfgs(6, checkpoint_every=1, checkpoint_dir=str(root / name))
        return run_training(lm, tcfg, device="cuda", steps=6, data_cfg=dcfg, log_every=0, **kw)

    try:
        full = run("full")
        crashed = run("resume", injector=FailureInjector(crash_at=(2,)))
        resumed = run("resume")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"full": full.losses, "crashed": crashed.losses, "resumed": resumed.losses,
           "interrupted": [full.interrupted, crashed.interrupted, resumed.interrupted],
           "resumed_from": resumed.resumed_from}
    print("[loop] " + json.dumps(out))
    if out["interrupted"] != [False, True, False] or len(full.losses) != 6 \
            or len(crashed.losses) != 2 or resumed.resumed_from != 1 or resumed.final_step != 5:
        raise AssertionError(f"run_training crash/resume went wrong: {out}")
    err = max(abs(a - b) for a, b in zip(crashed.losses + resumed.losses, full.losses))
    print(f"[loop] crash at step 2 + resume vs uninterrupted: max |loss diff| {err:.2e} "
          f"(tol {LOOP_TOL})")
    if err > LOOP_TOL:
        raise AssertionError(f"resumed losses differ from the uninterrupted run: {err}")
    return out


def phase_small_train() -> float:
    """A small bf16 model (head dim 64, GQA 4:2, remat full): 5 steps of
    make_train_step with the kernels against the plain versions, from the
    same weights on the same batches."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.data import DataConfig, SyntheticPacked
    from repro_torch.models import build_model
    from repro_torch.train.step import make_train_state, make_train_step

    data = SyntheticPacked(DataConfig(vocab=1024, seq_len=200, global_batch=4, seed=1))
    runs = {}
    for impl in ("cuda", "torch"):
        cfg = _small_train_cfg(attn_impl=impl)
        lm = build_model(cfg, device="cuda")
        tcfg = _train_cfgs(5)
        state = make_train_state(lm, tcfg, 7, device="cuda")
        step = make_train_step(lm, tcfg, ParallelConfig())
        losses = []
        for i in range(5):
            state, m = step(state, data.batch(i))
            losses.append(float(m["loss"]))
        runs[impl] = losses
    err = max(abs(a - b) for a, b in zip(runs["cuda"], runs["torch"]))
    print(f"[small-train] bf16 model, 5 steps, kernels {runs['cuda']} vs plain {runs['torch']}: "
          f"max |loss diff| {err:.3e} (tol {SMALL_TRAIN_TOL})")
    assert all(np.isfinite(runs["cuda"])) and err <= SMALL_TRAIN_TOL, runs
    return err


class _KernelFwdPlainBwd(torch.autograd.Function):
    """B2's forward (o and its lse), then the plain blockwise backward
    (``core.attention.flash_attention_bwd``) from those residuals."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        from repro_torch.kernels.flash_attention import flash_attention_fwd

        o, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.attention import flash_attention_bwd as plain_bwd
        from repro_torch.kernels.flash_attention import BLOCK_M, BLOCK_N

        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = plain_bwd(q, k, v, o, lse, g, q_block=BLOCK_M, kv_block=BLOCK_N, **ctx.kw)
        return dq, dk, dv, None


class _SoftmaxDroppedTorch:
    """``torch`` as ``models.moe`` sees it, but with the softmax over a
    token's top-k router logits dropped: those raw logits become the
    combine weights (the softmax over all experts, the aux loss's, stays)."""

    def __init__(self, top_k: int):
        self._k = top_k

    def __getattr__(self, name):
        return getattr(torch, name)

    def softmax(self, x, dim=-1):
        return x if x.shape[-1] == self._k else torch.softmax(x, dim=dim)


@contextlib.contextmanager
def _router_softmax_dropped(top_k: int):
    """Within the block the MoE's capacity path combines its experts with
    the raw top-k router logits (a deliberately wrong router)."""
    from repro_torch.models import moe as MOE

    real = MOE.torch
    MOE.torch = _SoftmaxDroppedTorch(top_k)
    try:
        yield
    finally:
        MOE.torch = real


@contextlib.contextmanager
def _routing(record: list = None, replay: list = None):
    """Within the block ``models.moe._route`` appends each call's expert
    choices (T, k) to ``record``, or takes them from ``replay`` in call
    order (the top-k logits then gathered from this run's own router
    logits at those choices): two runs on the same routing."""
    from repro_torch.models import moe as MOE

    real = MOE._route
    calls = iter(replay or ())

    def route(p, cfg, xf):
        logits, top, sel = real(p, cfg, xf)
        if replay is not None:
            sel = next(calls)
            top = torch.gather(logits, -1, sel)
        if record is not None:
            record.append(sel.detach().clone())
        return logits, top, sel

    MOE._route = route
    try:
        yield
    finally:
        MOE._route = real


def _routing_flips(a: list, b: list) -> dict:
    """Choices (token, expert) of run ``a`` that run ``b`` did not make,
    over the routing calls both made in the same order."""
    n = flips = 0
    for x, y in zip(a, b):
        e = int(x.max().item()) + 1
        hx = torch.zeros((x.shape[0], max(e, int(y.max().item()) + 1)), device=x.device)
        hy = hx.clone()
        hx.scatter_(1, x, 1.0)
        hy.scatter_(1, y, 1.0)
        flips += int((hx - hy).clamp(min=0).sum().item())
        n += x.numel()
    return {"choices": n, "differ": flips, "share": flips / max(n, 1)}


def phase_train_moe() -> dict:
    """Full-width olmoe-1b-7b (16 layers, d 2048, 16 heads of 128, 64
    experts of d_ff 1024, top 8; 6.92 B params), random weights from seed
    0, remat full, 4 adamw_factored steps of batch 4 x 1024 from
    DataConfig(seed=0) through make_train_state + make_train_step, as
    phase_train_family does. ``LM.loss`` takes the capacity path (the (E,
    C, d) buffer, ``index_add`` dispatch, ``bmm`` products); attention runs
    on B2 forward and B4-B6 backward at D 128. Launches from the code:
    ``flash_fwd`` 2 x 16 x steps (forward and remat recompute), each
    backward kernel 16 x steps, nothing else (the capacity path calls no
    ``ragged_dot``). Step 0 against the plain versions on the same weights
    and batch (TRAIN_LOSS_TOL, TRAIN_GNORM_RTOL) on the kernels' routing
    (recorded and replayed), and the total loss within TRAIN_LOSS_TOL on
    the plain versions' own routing; the router's softmax
    dropped (``_router_softmax_dropped``) must fail one of those limits;
    the aux loss above 0 at every step; each batch's loss lower after the
    steps than before them; the peak under 80 GB."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.data import DataConfig, SyntheticPacked
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import named_leaves
    from repro_torch.train.step import make_train_state, make_train_step

    steps, batch, seq = 4, 4, 1024
    label = "train-olmoe"
    cfg = get_config(MOE_ARCH).with_(attn_impl="auto", remat="full")
    tcfg = _train_cfgs(steps, optimizer="adamw_factored")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda")
    state = make_train_state(lm, tcfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in named_leaves(state["params"]))
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.moe.num_experts} experts of d_ff {cfg.moe.d_ff_expert}, top {cfg.moe.top_k}, "
          f"{n_params / 1e9:.3f} B params ({cfg.param_dtype}), remat {cfg.remat}, "
          f"{tcfg.optimizer}: params + optimizer state {state_gb:.2f} GB, init "
          f"{time.perf_counter() - t0:.1f} s")
    data = SyntheticPacked(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
    batches = [{"tokens": torch.as_tensor(data.batch(i)["tokens"], device="cuda")}
               for i in range(steps)]
    params = state["params"]
    # Step 0's gradient pass with the kernels, its routing recorded; the
    # plain versions on that routing (both limits: a top-k choice is
    # discrete, and the two attentions' bf16 roundings flip the near-tied
    # ones, which moves the gradient norm past what the kernels' own error
    # does) and on their own (the loss limit; the gradient norm printed).
    kernel_sel, plain_sel = [], []
    with _routing(record=kernel_sel):
        kernel_loss, kernel_gnorm, _ = _step0_grads(lm, params, batches[0])
    t0 = time.perf_counter()
    plain_lm = build_model(cfg.with_(attn_impl="torch"), device="cuda")
    with _routing(replay=kernel_sel):
        plain_loss, plain_gnorm, _ = _step0_grads(plain_lm, params, batches[0])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    with _routing(record=plain_sel):
        own_loss, own_gnorm, _ = _step0_grads(plain_lm, params, batches[0])
    flips = _routing_flips(kernel_sel, plain_sel)
    del plain_lm, kernel_sel, plain_sel
    with _router_softmax_dropped(cfg.moe.top_k):
        bad_loss, bad_gnorm, _ = _step0_grads(lm, params, batches[0])
    torch.cuda.empty_cache()

    def batch_losses(p):
        with torch.no_grad():
            return [float(lm.loss(p, b)[0]) for b in batches]

    before = batch_losses(params)
    step_fn = make_train_step(lm, tcfg, ParallelConfig())
    records = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])  # waits for the card, as run_training's span does
        dt = time.perf_counter() - t0
        rec = {"step": i, "loss": loss, "total_loss": float(metrics["total_loss"]),
               "aux_loss": float(metrics["aux_loss"]),
               "grad_norm": float(metrics["grad_norm"]), "lr": float(metrics["lr"]),
               "step_s": dt, "tokens_per_s": batch * seq / dt}
        print(f"[{label}] " + json.dumps(rec))
        records.append(rec)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    library = dict(cuda_lib.library_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in records]
    after = batch_losses(state["params"])
    want = {name: 0 for name in launches}
    want["flash_fwd"] = 2 * cfg.n_layers * steps
    for name in ("flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkv"):
        want[name] = cfg.n_layers * steps
    # LM.loss returns the cross-entropy plus the aux loss, metrics["loss"]
    # the cross-entropy alone: step 0 is compared on the total.
    d_loss = abs(plain_loss - records[0]["total_loss"])
    d_gnorm = abs(plain_gnorm - records[0]["grad_norm"]) / plain_gnorm
    bad = {"loss_diff": abs(plain_loss - bad_loss),
           "gnorm_rel_diff": abs(plain_gnorm - bad_gnorm) / plain_gnorm}
    own = {"loss": own_loss, "grad_norm": own_gnorm, "routing_flips": flips,
           "loss_diff": abs(own_loss - records[0]["total_loss"]),
           "gnorm_rel_diff": abs(own_gnorm - records[0]["grad_norm"]) / own_gnorm}
    out = {"arch": cfg.name, "steps": steps, "batch": batch, "seq": seq,
           "params_b": n_params / 1e9, "state_gb": state_gb,
           "plain_step0": {"loss": plain_loss, "grad_norm": plain_gnorm, "seconds": plain_s},
           "step0_loss_diff": d_loss, "step0_gnorm_rel_diff": d_gnorm,
           "kernels_step0_pass": {"loss": kernel_loss, "grad_norm": kernel_gnorm},
           "plain_own_routing": own, "router_softmax_dropped": bad, "losses": losses,
           "aux_losses": [r["aux_loss"] for r in records],
           "step_s": [r["step_s"] for r in records],
           "tokens_per_s": [r["tokens_per_s"] for r in records],
           "grad_norms": [r["grad_norm"] for r in records], "peak_mem_gb": peak,
           "batch_losses_before": before, "batch_losses_after": after,
           "launches": launches, "launches_want": want, "library": library}
    print(f"[{label}] " + json.dumps(out))
    print(f"[{label}] step 0, kernels vs plain versions on the same routing: total loss "
          f"{records[0]['total_loss']:.5f} vs {plain_loss:.5f} (|diff| {d_loss:.2e}, tol "
          f"{TRAIN_LOSS_TOL}); grad_norm {records[0]['grad_norm']:.5f} vs {plain_gnorm:.5f} "
          f"(rel diff {d_gnorm:.2e}, tol {TRAIN_GNORM_RTOL}); on their own routing: total "
          f"loss |diff| {own['loss_diff']:.2e} (tol {TRAIN_LOSS_TOL}), grad_norm rel "
          f"{own['gnorm_rel_diff']:.2e} (no limit), "
          f"{flips['differ']} of {flips['choices']} choices differ; router softmax dropped: "
          f"|diff| {bad['loss_diff']:.2e}, rel "
          f"{bad['gnorm_rel_diff']:.2e}; steps 1-3 {np.mean(out['step_s'][1:]):.3f} s, "
          f"{np.mean(out['tokens_per_s'][1:]):.0f} tokens/s; aux {out['aux_losses']}; B2 "
          f"{launches.get('flash_fwd')}, B4-B6 {launches.get('flash_bwd_delta')}/"
          f"{launches.get('flash_bwd_dq')}/{launches.get('flash_bwd_dkv')}; peak {peak:.2f} GB")
    if launches != want or any(library.values()):
        raise AssertionError(f"olmoe training launches {launches} (library {library}), "
                             f"want {want}")
    if not all(np.isfinite(losses)) or abs(losses[0] - math.log(cfg.vocab)) > 1.5:
        raise AssertionError(f"olmoe step 0 loss {losses[0]} not finite or not within 1.5 of "
                             f"ln(vocab) = {math.log(cfg.vocab):.3f}")
    if not all(r["aux_loss"] > 0 for r in records):
        raise AssertionError(f"olmoe aux losses {out['aux_losses']} not all above 0")
    if not all(a < b for a, b in zip(after, before)):
        raise AssertionError(f"olmoe loss did not fall over {steps} steps: batch losses "
                             f"before {before}, after {after}")
    if peak >= TRAIN_MEM_LIMIT_GB:
        raise AssertionError(f"olmoe training peaked at {peak:.2f} GB")
    if d_loss > TRAIN_LOSS_TOL or d_gnorm > TRAIN_GNORM_RTOL:
        raise AssertionError("olmoe training step 0 with the kernels disagrees with the plain "
                             "versions")
    if own["loss_diff"] > TRAIN_LOSS_TOL:
        raise AssertionError(f"olmoe training step 0's total loss with the kernels disagrees "
                             f"with the plain versions on their own routing: {own}")
    if not (bad["loss_diff"] > TRAIN_LOSS_TOL or bad["gnorm_rel_diff"] > TRAIN_GNORM_RTOL):
        raise AssertionError(f"the step-0 check cannot tell a dropped router softmax from the "
                             f"sound router: {bad}")
    del state, step_fn, lm, params, batches
    torch.cuda.empty_cache()
    return out


def phase_sharded_train() -> dict:
    """deepseek-7b at full width and SHARDED_TRAIN_LAYERS of its 30 layers,
    2 adamw_factored steps of batch 4 x 1024 in 2 microbatches, twice from
    the same weights (seed 0) and batches: unsharded (``make_train_step``
    without a mesh), then on ``make_local_mesh(1, 1)`` over NCCL with
    ``ParallelConfig(fsdp_axes=("data",), data_axes=("data",),
    microbatches=2)`` (``shard_state``: every leaf a DTensor; the model runs
    on DTensors, the kernels on each rank's local block). Each step's loss
    and gradient norm, and the params after the steps, equal to the bit;
    the same launches (``flash_fwd`` 2 x layers x 2 microbatches a step,
    each backward kernel layers x 2). Then ``reduce_grads_compressed`` on
    one gradient leaf (layer 0's wq, step 0's) over the mesh's "data" dim:
    equal to the bit to its plain result, ``dequantize_int8(quantize_int8(g))``
    and the residual ``g`` less that."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.data import DataConfig, SyntheticPacked
    from repro_torch.dist import compression
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import make_train_state, make_train_step, shard_state

    steps, batch, seq, micro = 2, 4, 1024, 2
    label = "sharded-train"
    cfg = get_config("deepseek-7b").with_(attn_impl="auto", n_layers=SHARDED_TRAIN_LAYERS)
    tcfg = _train_cfgs(steps, optimizer="adamw_factored")
    pcfg = ParallelConfig(fsdp_axes=("data",), data_axes=("data",), microbatches=micro)
    data = SyntheticPacked(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
    batches = [data.batch(i) for i in range(steps)]
    mesh = make_local_mesh(1, 1)
    lm = build_model(cfg, device="cuda")
    runs = {}
    for name in ("unsharded", "sharded"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(lm, tcfg, 0, device="cuda")
        state_bytes = local_bytes(state)
        if name == "sharded":
            state = shard_state(state, pcfg, mesh)
        step_fn = make_train_step(lm, tcfg, pcfg, mesh if name == "sharded" else None)
        recs = []
        cuda_lib.reset_launch_counts()
        for b in batches:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            recs.append({"loss": loss, "grad_norm": float(metrics["grad_norm"]), "step_s": dt,
                         "tokens_per_s": batch * seq / dt})
            print(f"[{label}] {name} " + json.dumps(recs[-1]))
        torch.cuda.synchronize()
        p = state["params"]
        local = lambda t: t.to_local() if isinstance(t, DTensor) else t  # noqa: E731
        runs[name] = {"records": recs, "launches": dict(cuda_lib.launch_counts),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "state_bytes": state_bytes,
                      "placed": isinstance(p["layers"][0]["attn"]["wq"]["w"], DTensor),
                      "leaves": {k: local(t).clone() for k, t in (
                          ("layer0.wq", p["layers"][0]["attn"]["wq"]["w"]),
                          ("last.w_down", p["layers"][-1]["ffn"]["w_down"]["w"]),
                          ("embed", p["embed"]["table"]))}}
        del state, step_fn, p
    a, b = runs["unsharded"], runs["sharded"]
    unequal = [k for k in ("loss", "grad_norm")
               if [r[k] for r in a["records"]] != [r[k] for r in b["records"]]]
    unequal += [k for k in a["leaves"] if not torch.equal(a["leaves"][k], b["leaves"][k])]
    want = {"flash_fwd": 2 * cfg.n_layers * micro * steps,
            "flash_bwd_delta": cfg.n_layers * micro * steps,
            "flash_bwd_dq": cfg.n_layers * micro * steps,
            "flash_bwd_dkv": cfg.n_layers * micro * steps}

    # The compressed all-reduce on one gradient leaf over the mesh's "data".
    params = make_train_state(lm, tcfg, 0, device="cuda")["params"]
    g = _step0_grads(lm, params, {k: v[:1] for k, v in batches[0].items()})[2]["layer0.wq"]
    del params
    red, res = compression.reduce_grads_compressed(
        {"w": g}, compression.init_residuals({"w": g}), (mesh, "data"))
    q, sc = compression.quantize_int8(g.float())
    plain = compression.dequantize_int8(q, sc, g.shape, torch.float32)
    compressed = {"reduced_equal": bool(torch.equal(red["w"], plain.to(g.dtype))),
                  "residual_equal": bool(torch.equal(res["w"], g.float() - plain)),
                  "shape": list(g.shape), "dtype": str(g.dtype)}
    out = {"arch": cfg.name, "layers": cfg.n_layers, "steps": steps, "batch": batch, "seq": seq,
           "microbatches": micro, "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "backend": torch.distributed.get_backend(),
           "runs": {k: {kk: v[kk] for kk in ("records", "launches", "peak_mem_gb", "placed",
                                             "peak_mem_bytes", "state_bytes")}
                    for k, v in runs.items()},
           "batch_bytes": sum(int(x.nbytes) for x in batches[0].values()),
           "optimizer": tcfg.optimizer,
           "unequal": unequal, "launches": b["launches"], "launches_want": want,
           "compressed_allreduce": compressed}
    print(f"[{label}] " + json.dumps(out))
    print(f"[{label}] {cfg.name} at {cfg.n_layers} layers, 1x1 {out['backend']} mesh, "
          f"microbatches {micro}: losses {[r['loss'] for r in b['records']]} (unsharded "
          f"{[r['loss'] for r in a['records']]}), equal to the bit: {not unequal}; step "
          f"{b['records'][-1]['step_s']:.3f} s against {a['records'][-1]['step_s']:.3f} s "
          f"unsharded; peaks {b['peak_mem_gb']:.2f} and {a['peak_mem_gb']:.2f} GB; "
          f"compressed all-reduce equal to its plain result: {compressed}")
    if unequal:
        raise AssertionError(f"sharded training on the 1x1 mesh differs from the unsharded "
                             f"step in {unequal}")
    if not b["placed"] or a["placed"]:
        raise AssertionError("the sharded run's params are not DTensors")
    for name, run in runs.items():
        got = {k: run["launches"].get(k, 0) for k in want}
        if got != want or any(v for k, v in run["launches"].items() if k not in want):
            raise AssertionError(f"{name} launches {run['launches']}, want {want}")
    if not (compressed["reduced_equal"] and compressed["residual_equal"]):
        raise AssertionError(f"reduce_grads_compressed differs from its plain result: "
                             f"{compressed}")
    del lm, runs, g
    torch.cuda.empty_cache()
    return out


def phase_sharded_serve(cfg, lm, params, main: dict, static: dict) -> dict:
    """The main path on ``make_local_mesh(1, 1)`` over NCCL: the continuous
    engine with ``mesh`` (params placed as DTensors on their specs), warmed
    and captured as the main path's, then the 12 main requests. Streams
    equal to the main path's to the bit, every request ok, ``paged_decode``
    == layers x mixed steps (30 a step), every mixed step a replay, and
    each captured step replayed against the eager step to the bit
    (``phase_graphs``). Then the static engine with the same mesh on the
    same requests: streams equal to the static path's to the bit,
    ``flash_fwd`` == layers x prefills, ``contig_decode`` == layers x decode
    steps, every decode step a replay equal to the eager step."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serve import Request, ServeEngine

    label = "sharded-serve"
    mesh = make_local_mesh(1, 1)
    eng = ServeEngine(lm, params, scheduler="continuous", batch_size=8, max_len=1024,
                      page_size=64, device="cuda", mesh=mesh)
    placed = isinstance(eng.params["layers"][0]["attn"]["wq"]["w"], DTensor)
    rng = np.random.default_rng(99)
    t0 = time.perf_counter()
    eng.generate([Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                          max_new_tokens=2, eos_id=-1) for n in (300, 20)])
    warm_s = time.perf_counter() - t0
    assert eng.compiled_step_count() == 2, eng.step_graphs()
    replays = {name: g.replays for name, g in eng.step_graphs().items()}
    eng.tracer.clear()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.generate(_main_requests(cfg.vocab))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    stats = eng.last_stats
    replayed = {name: g.replays - replays[name] for name, g in eng.step_graphs().items()}
    streams = {r.rid: r.tokens.tolist() for r in results}
    differ = sorted(rid for rid, t in streams.items() if t != main["streams"][rid])
    tokens = sum(r.steps for r in results)
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "backend": torch.distributed.get_backend(), "params_placed": placed,
           "requests": len(results), "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "main_tokens_per_s": main["tokens_per_s"],
           "warmup_and_capture_s": warm_s, "mixed_steps": stats.mixed_steps,
           "wide_steps": stats.wide_steps, "launches": launches,
           "launches_per_step": launches.get("paged_decode", 0) / max(stats.mixed_steps, 1),
           "graph_replays": replayed, "streams_differ": differ}
    print(f"[{label}] " + json.dumps(out))
    if not placed:
        raise AssertionError("the sharded engine's params are not DTensors")
    if not all(r.status == "ok" and r.steps == 32 for r in results):
        raise AssertionError(f"sharded serving: {[(r.status, r.steps) for r in results]}")
    if differ:
        raise AssertionError(f"sharded serving streams differ from the main path's: {differ}")
    if launches.get("paged_decode") != cfg.n_layers * stats.mixed_steps:
        raise AssertionError(f"sharded serving launches {launches}, want paged_decode "
                             f"{cfg.n_layers} x {stats.mixed_steps}")
    if sum(replayed.values()) != stats.mixed_steps:
        raise AssertionError(f"sharded serving: not every mixed step replayed: {replayed}")
    out["graphs"] = phase_graphs(eng, label)
    print(f"[{label}] {cfg.name} continuous on the 1x1 {out['backend']} mesh: "
          f"{out['tokens_per_s']:.1f} tokens/s (main path {main['tokens_per_s']:.1f}), streams "
          f"equal to the bit, paged_decode {out['launches_per_step']:.0f} a mixed step")
    del eng
    torch.cuda.empty_cache()

    eng = ServeEngine(lm, params, scheduler="static", batch_size=8, max_len=1024, device="cuda",
                      mesh=mesh)
    rng = np.random.default_rng(98)
    eng.generate([Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                          max_new_tokens=2, eos_id=-1) for n in (300, 20)])
    replays = eng.step_graphs()["decode"].replays
    eng.tracer.clear()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.generate(_main_requests(cfg.vocab))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slaunches = dict(cuda_lib.launch_counts)
    _, calls = _step_spans(eng)
    replayed = eng.step_graphs()["decode"].replays - replays
    differ = sorted(r.rid for r in results if r.tokens.tolist() != static["streams"][r.rid])
    tokens = sum(r.steps for r in results)
    st = {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
          "static_tokens_per_s": static["tokens_per_s"], "calls": calls,
          "launches": slaunches, "graph_replays": replayed, "streams_differ": differ}
    print(f"[{label}] static " + json.dumps(st))
    if not all(r.status == "ok" and r.steps == 32 for r in results) or differ:
        raise AssertionError(f"sharded static serving: streams differ at {differ}, "
                             f"{[(r.status, r.steps) for r in results]}")
    want = {"flash_fwd": cfg.n_layers * calls["prefill"],
            "contig_decode": cfg.n_layers * calls["decode"]}
    if {k: slaunches.get(k) for k in want} != want or slaunches.get("paged_decode"):
        raise AssertionError(f"sharded static serving launches {slaunches}, want {want}")
    if replayed != calls["decode"]:
        raise AssertionError(f"sharded static serving: {replayed} replays for {calls}")
    st["graphs"] = phase_graphs(eng, label + " static")
    print(f"[{label}] {cfg.name} static on the 1x1 mesh: {st['tokens_per_s']:.1f} tokens/s "
          f"(static path {static['tokens_per_s']:.1f}), streams equal to the bit, flash_fwd "
          f"{cfg.n_layers} a prefill, contig_decode {cfg.n_layers} a decode step")
    out["static"] = st
    out["launches_continuous"] = launches
    out["launches"] = {k: launches.get(k, 0) + slaunches.get(k, 0)
                       for k in set(launches) | set(slaunches)}
    del eng
    torch.cuda.empty_cache()
    return out


def _dryrun_line(label: str, rec: dict) -> dict:
    """The figures of one dry-run record that the phase prints."""
    r = rec["roofline"]
    out = {"cell": f"{rec['arch']} {rec['shape']} {rec['mesh']}", "status": rec["status"],
           "trace_s": rec.get("lower_s"), "ops": rec.get("ops"),
           "flops_per_device": rec["cost"]["flops"],
           "bytes_accessed": rec["cost"].get("bytes_accessed", rec["cost"].get("bytes accessed")),
           "collectives": rec["collectives"], "memory": rec.get("memory"),
           "bottleneck": r["bottleneck"], "useful_ratio": r["useful_ratio"],
           "step_s_bound": r["step_s"]}
    print(f"[{label}] " + json.dumps(out))
    return out


def phase_dryrun() -> dict:
    """The dry-run (``launch.dryrun``) on this machine's torch, on fake
    process groups (no card, no collective moves a byte): deepseek-7b's
    decode_32k cell on the 16 x 16 mesh (256 fake ranks); its train_4k cell
    extrapolated from depth 1 and 2 (``extrapolate_cell``, microbatches 1)
    and held exactly to a full-depth trace of the same cell (flops; the
    trace unrolls every layer), whose useful ratio must lie in
    (DRYRUN_USEFUL_MIN, 1] (a count of the global op, not the rank's, reads
    1/256 of that); reduced olmoe-1b-7b's train_4k on a (4, 2) mesh at a
    batch of DRYRUN_SMALL_BATCH, which the data axis divides. Every
    cell must be ok; each prints its flops per device, collective bytes by
    kind, temp bytes and bottleneck."""
    from torch.testing._internal.distributed import fake_pg

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    label = "dryrun"
    t_start = time.perf_counter()
    print(f"[{label}] torch {torch.__version__}; fake process group: {fake_pg.__name__} "
          f"({Path(fake_pg.__file__).name}), backend 'fake' on a FakeStore")
    out = {"cells": {}}
    with D.fake_world(D.MESH_RANKS["single"]):
        mesh = make_production_mesh(device="cpu")
        rec, _ = D.lower_cell("deepseek-7b", "decode_32k", mesh, "single")
        out["cells"]["decode"] = _dryrun_line(label, rec)
        ex = D.extrapolate_cell("deepseek-7b", "train_4k", mesh, "single")
        out["cells"]["train_extrapolated"] = _dryrun_line(label, ex)
        full, _ = D.lower_cell("deepseek-7b", "train_4k", mesh, "single",
                               cfg_overrides={"scan_layers": False},
                               par_overrides={"microbatches": 1})
        out["cells"]["train_full_depth"] = _dryrun_line(label, full)
    with D.fake_world(8):
        rec, _ = D.lower_cell("olmoe-1b-7b", "train_4k", make_local_mesh(4, 2, device="cpu"),
                              "4x2", reduced=True,
                              shape_overrides={"global_batch": DRYRUN_SMALL_BATCH})
        out["cells"]["olmoe_reduced"] = _dryrun_line(label, rec)
    if torch.distributed.is_initialized():
        raise AssertionError("the dry-run left a process group joined")
    bad = [name for name, cell in out["cells"].items() if cell["status"] != "ok"]
    if bad:
        raise AssertionError(f"dry-run cells not ok: {bad}")
    got, want = full["cost"]["flops"], ex["cost"]["flops"]
    out["extrapolation"] = {"extrapolated_flops": want, "full_depth_flops": got,
                            "equal": got == want,
                            "bytes": [ex["cost"]["bytes accessed"], full["cost"]["bytes_accessed"]],
                            "collectives_total": [ex["collectives"].get("total"),
                                                  full["collectives"].get("total")]}
    out["seconds"] = time.perf_counter() - t_start
    print(f"[{label}] extrapolated against full depth: " + json.dumps(out["extrapolation"])
          + f"; the phase took {out['seconds']:.1f} s")
    if got != want:
        raise AssertionError(f"extrapolate_cell's flops {want} differ from the full-depth "
                             f"trace's {got}")
    useful = full["roofline"]["useful_ratio"]
    if not DRYRUN_USEFUL_MIN < useful <= 1.0:
        raise AssertionError(f"deepseek-7b train_4k's useful ratio {useful} lies outside "
                             f"({DRYRUN_USEFUL_MIN}, 1]: the trace does not count per rank")
    return out


def phase_dryrun_vs_card(sharded_train: dict) -> dict:
    """The dry-run held to the card: deepseek-7b's training step at the
    sharded-train phase's shape (SHARDED_TRAIN_LAYERS layers, 4 x 1024, 2
    microbatches, adamw_factored) traced on a fake 1 x 1 mesh. Its
    argument bytes must equal the real state's bytes on the card plus the
    batch's, exactly, and its collective bytes 0; its argument + temp
    bytes print beside ``max_memory_allocated`` of the real unsharded
    step. The real step's MFU (``model_flops`` over step time x
    ``PEAK_FLOPS_BF16``) must be at most 1. ``get_device_properties`` must
    agree with ``CHIP_HBM_BYTES`` (the visible memory within
    HBM_VISIBLE_MIN of it) and ``SMEM_PER_SM_BYTES``."""
    from repro_torch.analysis import constants as C
    from repro_torch.analysis import roofline as rf
    from repro_torch.configs import SHAPES, TrainConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_local_mesh

    label = "dryrun-vs-card"
    t_start = time.perf_counter()
    real = sharded_train["runs"]["unsharded"]
    shape = {"seq_len": sharded_train["seq"], "global_batch": sharded_train["batch"]}
    with D.fake_world(1):
        rec, _ = D.lower_cell(
            "deepseek-7b", "train_4k", make_local_mesh(1, 1, device="cpu"), "1x1",
            cfg_overrides={"n_layers": sharded_train["layers"]},
            par_overrides={"microbatches": sharded_train["microbatches"]},
            shape_overrides=shape, train_cfg=TrainConfig(optimizer=sharded_train["optimizer"]))
    mem = rec["memory"]
    real_args = real["state_bytes"] + sharded_train["batch_bytes"]
    step_s = real["records"][-1]["step_s"]
    cfg = D.cfg_for_dryrun("deepseek-7b", {"n_layers": sharded_train["layers"]})
    mf = rf.model_flops(cfg, dataclasses.replace(SHAPES["train_4k"], **shape))
    mfu = mf / (step_s * C.PEAK_FLOPS_BF16)
    props = torch.cuda.get_device_properties(0)
    out = {"status": rec["status"], "trace_s": rec["lower_s"], "ops": rec["ops"],
           "argument_bytes": mem["argument_bytes"], "real_state_bytes": real["state_bytes"],
           "real_batch_bytes": sharded_train["batch_bytes"],
           "argument_equal": mem["argument_bytes"] == real_args,
           "collectives": rec["collectives"], "temp_bytes": mem["temp_bytes"],
           "dryrun_peak_bytes": mem["argument_bytes"] + mem["temp_bytes"],
           "card_max_memory_allocated": real["peak_mem_bytes"],
           "dryrun_over_card": (mem["argument_bytes"] + mem["temp_bytes"])
           / real["peak_mem_bytes"],
           "traced_flops": rec["cost"]["flops"], "model_flops": mf, "step_s": step_s,
           "mfu": mfu, "card_total_memory": props.total_memory,
           "chip_hbm_bytes": C.CHIP_HBM_BYTES,
           "card_smem_per_sm": props.shared_memory_per_multiprocessor,
           "smem_per_sm": C.SMEM_PER_SM_BYTES}
    out["seconds"] = time.perf_counter() - t_start
    print(f"[{label}] " + json.dumps(out))
    print(f"[{label}] fake 1x1 argument bytes {mem['argument_bytes']:,} against the card's "
          f"state {real['state_bytes']:,} + batch {sharded_train['batch_bytes']:,}; dry-run "
          f"argument + temp {out['dryrun_peak_bytes'] / 1e9:.2f} GB against the card's "
          f"max_memory_allocated {real['peak_mem_bytes'] / 1e9:.2f} GB; the step's MFU "
          f"{mfu:.4f} ({mf:.4e} model flops in {step_s:.3f} s at {C.PEAK_FLOPS_BF16:.3e})")
    if rec["status"] != "ok" or not out["argument_equal"]:
        raise AssertionError(f"the fake 1x1 cell's argument bytes {mem['argument_bytes']} "
                             f"differ from the card's state and batch, {real_args}")
    if rec["collectives"].get("total", 0) != 0:
        raise AssertionError(f"a 1x1 mesh issued collective bytes: {rec['collectives']}")
    if not 0 < mfu <= 1:
        raise AssertionError(f"MFU {mfu} above 1: the flop count or the peak is wrong")
    if not HBM_VISIBLE_MIN * C.CHIP_HBM_BYTES <= props.total_memory <= C.CHIP_HBM_BYTES:
        raise AssertionError(f"the card reports {props.total_memory} bytes, CHIP_HBM_BYTES "
                             f"is {C.CHIP_HBM_BYTES}")
    if props.shared_memory_per_multiprocessor != C.SMEM_PER_SM_BYTES:
        raise AssertionError(f"the card reports {props.shared_memory_per_multiprocessor} "
                             f"bytes of shared memory an SM, SMEM_PER_SM_BYTES is "
                             f"{C.SMEM_PER_SM_BYTES}")
    return out


def phase_examples() -> dict:
    """The four examples (``repro_torch.examples``), each through its
    ``main(argv)`` in this process (the kernels' builds are reused):
    quickstart (B2: cyclic and sawtooth within KERNEL_TOL of each other and
    of the reference impl, its walks equal to the host model's; 4
    ``flash_fwd`` launches); train_lm (EXAMPLE_TRAIN_STEPS steps of the
    50.3 M-param config: the loss falls, ``flash_fwd`` and each backward kernel 8
    x steps, remat none; its peak printed); serve_lm (full-size deepseek-7b
    served continuously, 12 requests x 24 new tokens, train_lm's
    checkpoint refused as another config: every request ok, ``paged_decode``
    30 x (mixed steps + the two captured steps' warm-ups) and nothing
    else); sawtooth_analysis --quick."""
    import shutil

    from repro_torch.examples import quickstart, sawtooth_analysis, serve_lm, train_lm
    from repro_torch.kernels import cuda_lib

    label = "examples"
    t_start = time.perf_counter()
    ckdir = ROOT / "build" / "examples_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    out = {}
    try:
        qs = quickstart.main([])
        out["quickstart"] = {k: qs[k] for k in ("sawtooth_vs_cyclic", "kernel_vs_reference",
                                                 "gb10_reduction_pct", "walks", "launches")}
        print(f"[{label}] quickstart " + json.dumps(out["quickstart"]))
        want = {"flash_fwd": 4}  # two orders in part 1, each again recording its walk
        got = {k: v for k, v in qs["launches"].items() if v}
        if got != want:
            raise AssertionError(f"quickstart launches {got}, want {want}")
        if max(qs["sawtooth_vs_cyclic"], qs["kernel_vs_reference"]) > KERNEL_TOL:
            raise AssertionError(f"quickstart's outputs differ by more than {KERNEL_TOL}")

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        tr = train_lm.main(["--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt-dir", str(ckdir)])
        wall = time.perf_counter() - t0
        res, steps = tr["result"], tr["steps"]
        launches = {k: v for k, v in cuda_lib.launch_counts.items() if v}
        layers = tr["cfg"].n_layers
        want = {"flash_fwd": layers * steps, "flash_bwd_delta": layers * steps,
                "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps}
        out["train_lm"] = {"params": tr["params"], "steps": steps,
                           "losses": [res.losses[0], res.losses[-1]],
                           "interrupted": res.interrupted, "launches": launches,
                           "wall_s": wall,
                           "tokens_per_s": steps * tr["batch"] * tr["seq"] / wall,
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"[{label}] train_lm " + json.dumps(out["train_lm"]))
        if res.interrupted or not res.losses[-1] < res.losses[0]:
            raise AssertionError(f"train_lm did not learn: {out['train_lm']}")
        if launches != want:
            raise AssertionError(f"train_lm launches {launches}, want {want}")

        gc.collect()
        torch.cuda.empty_cache()
        cuda_lib.reset_launch_counts()
        sv = serve_lm.main(["--ckpt-dir", str(ckdir)])
        stats = sv["stats"]
        launches = {k: v for k, v in cuda_lib.launch_counts.items() if v}
        # each captured step's warm-up runs once for real (serve/step_graph.py)
        want = {"paged_decode": sv["cfg"].n_layers * (stats.mixed_steps + sv["graphs"])}
        statuses = sorted({r.status for r in sv["results"]})
        out["serve_lm"] = {"scheduler": sv["scheduler"], "requests": len(sv["results"]),
                           "statuses": statuses, "tokens": sv["tokens"],
                           "tokens_per_s": sv["tokens"] / sv["seconds"],
                           "mixed_steps": stats.mixed_steps, "graphs": sv["graphs"],
                           "launches": launches,
                           "restored_step": sv["restored_step"]}
        print(f"[{label}] serve_lm " + json.dumps(out["serve_lm"]))
        if sv["scheduler"] != "continuous" or statuses != ["ok"] or len(sv["results"]) != 12:
            raise AssertionError(f"serve_lm: {out['serve_lm']}")
        if launches != want:
            raise AssertionError(f"serve_lm launches {launches}, want {want}")
        del sv
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        sa = sawtooth_analysis.main(["--quick"])
        out["sawtooth_analysis"] = {"seconds": time.perf_counter() - t0, **sa}
        print(f"[{label}] sawtooth_analysis --quick " + json.dumps(out["sawtooth_analysis"]))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    out["launches"] = _sum_launches(*(out[k] for k in ("quickstart", "train_lm", "serve_lm")))
    out["seconds"] = time.perf_counter() - t_start
    print(f"[{label}] the four examples took {out['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def _plain_backward():
    """Within the block, ``ops.attention`` runs B2 forward and the plain
    backward (``_KernelFwdPlainBwd``): the reference side of the hybrid's
    attention gradient check."""
    from repro_torch.kernels import ops

    real = ops.attention

    def attention(q, k, v, *, order, causal, window, scale=None, snake_group=None, **_):
        kw = dict(order=order, causal=causal, window=window, scale=scale,
                  snake_group=snake_group)
        return _KernelFwdPlainBwd.apply(q, k, v, kw)

    ops.attention = attention
    try:
        yield
    finally:
        ops.attention = real


def phase_train_ssm(arch: str) -> dict:
    """Full-width ``arch`` (mamba2-130m: 24 Mamba-2 layers; zamba2-2_7b: 54
    Mamba-2 layers and a shared attention block of 32 heads of 80 at 9
    sites), random weights from seed 0, remat full, takes 4 adamw_factored
    steps of batch 4 x 1024 tokens from DataConfig(seed=0) through
    make_train_state + make_train_step, with B7 (forward and remat
    recompute) and, for zamba2, B2 and B4-B6. The SSD's backward re-runs the
    plain chunked scan under autograd, by the reference's design (its
    ops.ssd has no backward kernel): its device time is read with CUDA
    events around each SSD backward of step 0's gradient pass. Before the
    steps, on the same weights and batch 0: step 0 against the plain
    versions; mamba2 with B7's decays dropped (the loss must move beyond the
    limit); zamba2's shared attention gradients against the plain
    attention's and the two wrong backwards; zamba2 under remat "dots"
    against "full", each one's peak memory beside."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.data import DataConfig, SyntheticPacked
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import named_leaves
    from repro_torch.train.step import make_train_state, make_train_step

    steps, batch, seq = 4, 4, 1024
    cfg = get_config(arch).with_(attn_impl="auto", ssd_impl="auto", remat="full")
    hybrid = cfg.family == "hybrid"
    label = "train-" + ("zamba2" if hybrid else "mamba2")
    sites = cfg.n_layers // cfg.ssm.shared_attn_every if hybrid else 0
    tcfg = _train_cfgs(steps, optimizer="adamw_factored")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda")
    state = make_train_state(lm, tcfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in named_leaves(state["params"]))
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
          f"{n_params / 1e9:.3f} B params ({cfg.param_dtype}, activations {cfg.dtype}), remat "
          f"{cfg.remat}, {tcfg.optimizer}: params + optimizer state {state_gb:.2f} GB, init "
          f"{time.perf_counter() - t0:.1f} s")
    data = SyntheticPacked(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
    batches = [data.batch(i) for i in range(steps)]
    params = state["params"]

    t0 = time.perf_counter()
    plain_lm = build_model(cfg.with_(attn_impl="torch", ssd_impl="torch"), device="cuda")
    plain_loss, plain_gnorm, _ = _step0_grads(plain_lm, params, batches[0])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del plain_lm
    ssd_events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_loss, k_gnorm, k_attn = _step0_grads(lm, params, batches[0], ssd_timer=ssd_events)
    torch.cuda.synchronize()
    grad_pass_ms = (time.perf_counter() - t0) * 1e3
    ssd_bwd_ms = sum(a.elapsed_time(b) for a, b in ssd_events)
    out = {"arch": cfg.name, "steps": steps, "batch": batch, "seq": seq,
           "params_b": n_params / 1e9, "state_gb": state_gb,
           "plain_step0": {"loss": plain_loss, "grad_norm": plain_gnorm, "seconds": plain_s},
           "kernel_step0": {"loss": k_loss, "grad_norm": k_gnorm},
           "step0_grad_pass_ms": grad_pass_ms, "ssd_bwd_calls": len(ssd_events),
           "ssd_bwd_ms": ssd_bwd_ms, "ssd_bwd_share_of_grad_pass": ssd_bwd_ms / grad_pass_ms,
           "ssd_bwd_is": "plain ssd_chunked under autograd (no backward kernel in the "
                         "reference either)"}
    if hybrid:
        attn_lm = build_model(cfg.with_(attn_impl="torch"), device="cuda")
        _, _, plain_attn = _step0_grads(attn_lm, params, batches[0])
        del attn_lm
        out["attn_grad_rel_err_vs_plain_attention"] = {
            leaf: _rel_l2(g, plain_attn[leaf]) for leaf, g in k_attn.items()}
        with _plain_backward():
            _, _, plain_attn = _step0_grads(lm, params, batches[0])
        grad_errs = {"kernels": {leaf: _rel_l2(g, plain_attn[leaf])
                                 for leaf, g in k_attn.items()}}
        for name in _CONTROLS:
            _, _, attn = _step0_grads(lm, params, batches[0], control=name)
            grad_errs[name] = {leaf: _rel_l2(g, plain_attn[leaf]) for leaf, g in attn.items()}
            del attn
        del plain_attn
        out["attn_grad_rel_err"] = grad_errs
        remat = {}
        for policy in ("full", "dots"):
            policy_lm = build_model(cfg.with_(remat=policy), device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss, gnorm, attn = _step0_grads(policy_lm, params, batches[0])
            torch.cuda.synchronize()
            remat[policy] = {"loss": loss, "grad_norm": gnorm, "attn": attn,
                             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            del policy_lm
        out["remat_dots_vs_full"] = {
            "loss": [remat["dots"]["loss"], remat["full"]["loss"]],
            "grad_norm": [remat["dots"]["grad_norm"], remat["full"]["grad_norm"]],
            "attn_grad_rel_diff": {leaf: _rel_l2(g, remat["full"]["attn"][leaf])
                                   for leaf, g in remat["dots"]["attn"].items()},
            "peak_mem_gb": {p: remat[p]["peak_mem_gb"] for p in remat}}
        del remat
    else:
        with torch.no_grad(), _ssd_control("decay_dropped"):
            bad_loss = lm.loss(params, batches[0])[0].item()
        out["decay_dropped_step0_loss"] = bad_loss
    torch.cuda.empty_cache()

    step_fn = make_train_step(lm, tcfg, ParallelConfig())
    records = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])  # waits for the card, as run_training's span does
        dt = time.perf_counter() - t0
        rec = {"step": i, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "step_s": dt, "tokens_per_s": batch * seq / dt}
        print(f"[{label}] " + json.dumps(rec))
        records.append(rec)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in records]
    want = {name: 0 for name in launches}
    want["ssd"] = 2 * cfg.n_layers * steps
    if hybrid:
        want["flash_fwd"] = 2 * sites * steps
        for name in ("flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkv"):
            want[name] = sites * steps
    out.update({
        "losses": losses, "step_s": [r["step_s"] for r in records],
        "tokens_per_s": [r["tokens_per_s"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records], "peak_mem_gb": peak,
        "launches": launches, "launches_want": want,
    })
    print(f"[{label}] " + json.dumps(out))
    if launches != want:
        raise AssertionError(f"{arch} training launches {launches}, want {want}")
    if not all(np.isfinite(losses)) or abs(losses[0] - math.log(cfg.vocab)) > 1.5:
        raise AssertionError(f"{arch} step 0 loss {losses[0]} not finite or not within 1.5 of "
                             f"ln(vocab) = {math.log(cfg.vocab):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} loss did not fall over {steps} steps: {losses}")
    if peak >= TRAIN_MEM_LIMIT_GB:
        raise AssertionError(f"{arch} training peaked at {peak:.2f} GB")
    d_loss = abs(plain_loss - losses[0])
    d_gnorm = abs(plain_gnorm - records[0]["grad_norm"]) / plain_gnorm
    print(f"[{label}] step 0, kernels vs plain versions: loss {losses[0]:.5f} vs "
          f"{plain_loss:.5f} (|diff| {d_loss:.2e}, tol {TRAIN_LOSS_TOL}); grad_norm "
          f"{records[0]['grad_norm']:.5f} vs {plain_gnorm:.5f} (rel diff {d_gnorm:.2e}, tol "
          f"{TRAIN_GNORM_RTOL}); step {np.mean(out['step_s'][1:]):.3f} s, "
          f"{np.mean(out['tokens_per_s'][1:]):.0f} tokens/s (steps 1-3), peak {peak:.2f} GB; SSD "
          f"backward (plain, by design) {ssd_bwd_ms:.1f} ms of step 0's {grad_pass_ms:.1f} ms "
          f"gradient pass")
    if d_loss > TRAIN_LOSS_TOL or d_gnorm > TRAIN_GNORM_RTOL:
        raise AssertionError(f"{arch} training step 0 with the kernels disagrees with the "
                             "plain versions")
    if hybrid:
        worst = max(grad_errs["kernels"].values())
        print(f"[{label}] step 0 shared attention weight gradients against the plain backward "
              f"on B2's residuals: kernels worst {worst:.3e} (tol {RESIDUAL_ATTN_GRAD_TOL}); "
              f"controls worst " + ", ".join(f"{c} {max(grad_errs[c].values()):.3e}"
                                            for c in _CONTROLS)
              + "; against the plain attention (forward too, no limit): kernels worst "
              f"{max(out['attn_grad_rel_err_vs_plain_attention'].values()):.3e}")
        if worst > RESIDUAL_ATTN_GRAD_TOL:
            raise AssertionError(f"{arch} shared attention gradients with the kernels differ "
                                 f"from the plain backward's: {grad_errs['kernels']}")
        for c in _CONTROLS:
            if max(grad_errs[c].values()) <= RESIDUAL_ATTN_GRAD_TOL:
                raise AssertionError(f"the gradient check cannot tell control {c} from a sound "
                                     f"backward: {grad_errs[c]}")
        dots = out["remat_dots_vs_full"]
        dl = abs(dots["loss"][0] - dots["loss"][1])
        dg = abs(dots["grad_norm"][0] - dots["grad_norm"][1]) / dots["grad_norm"][1]
        da = max(dots["attn_grad_rel_diff"].values())
        print(f"[{label}] step 0 remat dots vs full: loss |diff| {dl:.2e} (tol "
              f"{TRAIN_LOSS_TOL}), grad_norm rel diff {dg:.2e} (tol {TRAIN_GNORM_RTOL}), shared "
              f"attention gradients {da:.2e} (tol {ATTN_GRAD_TOL}); peak "
              f"{dots['peak_mem_gb']['dots']:.2f} GB (dots) vs {dots['peak_mem_gb']['full']:.2f} "
              "GB (full)")
        if dl > TRAIN_LOSS_TOL or dg > TRAIN_GNORM_RTOL or da > ATTN_GRAD_TOL:
            raise AssertionError(f"{arch} step 0 under remat dots disagrees with full: {dots}")
    else:
        d_bad = abs(out["decay_dropped_step0_loss"] - plain_loss)
        print(f"[{label}] step 0 with B7's decays dropped: loss {out['decay_dropped_step0_loss']:.4f}"
              f" (|diff| {d_bad:.2e} from the plain scan's; must exceed {TRAIN_LOSS_TOL})")
        if not d_bad > TRAIN_LOSS_TOL:
            raise AssertionError(f"{arch}: the step-0 loss check cannot tell B7 with its decays "
                                 "dropped from the kernel")
    del state, step_fn, lm, params
    torch.cuda.empty_cache()
    return out


# ---- phase 4 ------------------------------------------------------------------


def _work(lens, qls, c, hq, hkv, d, window=None):
    """Bytes the function must move and flops it must do on these inputs:
    K and V below each row's length and the valid query rows read once, the
    whole (B, C, Hq, D) output (zero rows included) written once."""
    in_bytes = flops = 0
    for ln, ql in zip(lens, qls):
        if ql <= 0 or ln <= 0:
            continue
        base = ln - ql
        in_bytes += ln * hkv * d * 2 * 2  # K and V rows below len, bf16
        in_bytes += min(ql, c) * hq * d * 2  # valid query rows, bf16
        for t in range(min(ql, c)):
            pos = base + t
            lo = 0 if window is None else max(0, pos - window + 1)
            flops += (min(pos, ln - 1) - lo + 1) * hq * d * 4
    out_bytes = len(lens) * c * hq * d * 2
    return in_bytes + out_bytes, flops


def phase_kernel_times(dev_info: dict, main: dict) -> dict:
    from repro_torch.core.attention import paged_decode_attention
    from repro_torch.core.schedule import resolve_order_group
    from repro_torch.kernels.flash_decode import (
        decode_kernel_attr,
        fold_schedule,
        launch_paged_decode,
        paged_flash_decode_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, hq, hkv, d, page, max_len = 8, 32, 32, 128, 64, 1024
    nb = max_len // page
    rng = np.random.default_rng(5)
    lens0 = [int(x) for x in rng.integers(560, 641, size=b)]
    shapes = {
        "narrow": (1, [1] * b),
        "wide": (256, [256] + [1] * (b - 1)),
    }
    out = {}
    for key, (c, q_lens) in shapes.items():
        q, k, v, bt, lens, qls = _case(
            gen, b_lens=lens0, q_lens=q_lens, c=c, hq=hq, hkv=hkv, d=d, page=page,
            max_len=max_len,
        )
        group = resolve_order_group("sawtooth", None, nb)
        err = _check_kernel(q, k, v, bt, lens, qls, None, group)
        wrapper = lambda: paged_flash_decode_fwd(q, k, v, lens, bt, q_lens=qls, order_group=group)
        phys, logical = fold_schedule(lens, bt, order_group=group)
        kern = lambda: launch_paged_decode(q, k, v, phys, logical, lens, qls)
        plain = lambda: paged_decode_attention(q, k, v, lens, bt, q_lens=qls, order_group=group)
        # Library yardstick: SDPA over the pages gathered into a contiguous
        # cache, with the same boolean mask (the gather is not timed).
        s = nb * page
        kc = k[bt.long()].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
        vc = v[bt.long()].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
        qt = q.transpose(1, 2).contiguous()
        col = torch.arange(s, device="cuda")[None, None, :]
        tq = torch.arange(c, device="cuda")[None, :, None]
        qpos = (lens - qls)[:, None, None] + tq
        mask = (col <= qpos) & (col < lens[:, None, None]) & (tq < qls[:, None, None])
        mask = mask[:, None]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask)
        # The wrapper adds the schedule fold (a few small ops).
        nbytes, flops = _work(lens0, q_lens, c, hq, hkv, d)
        rec = _time_record({"kernel": kern, "wrapper": wrapper, "plain": plain,
                            "library": sdpa}, nbytes, flops, dev_info)
        rec.update(C=c, q_lens=q_lens, lens=lens0, max_abs_err=err,
                   launches_per_step=main["launches_per_step"],
                   kernel_attr=decode_kernel_attr("paged_decode", (b, c, hq, hkv, d, nb, page)))
        if key == "narrow":
            rec["alternating_ms"] = _alternating_orders(q, k, v, bt, lens, qls, nb)
        print(f"[time] {key}: " + json.dumps(rec))
        out[key] = rec
    return out


def _time_record(fns: dict, nbytes: int, flops: float, dev_info: dict) -> dict:
    """The kernel and the library call (``fns["library"]``, None where no
    PyTorch call computes the same function) are read alike and in turns:
    four batched readings each and two single-launch ones
    (``_median_ms``), each figure the median of its readings. The wrapper
    gets one reading of each kind and its host time a call; the plain
    version one batched reading. The bound takes ``flops`` at the dense
    bf16 peak."""
    pair = {"kernel": fns["kernel"]}
    if fns["library"] is not None:
        pair["library"] = fns["library"]
    batched = _readings(pair, rounds=4)
    single = _readings(pair, rounds=2, batched=False)
    t_bytes = nbytes / dev_info["bw"] * 1e3
    t_ops = flops / dev_info["peak"] * 1e3
    rec = {
        "kernel_ms": statistics.median(batched["kernel"]),
        "kernel_ms_runs": batched["kernel"],
        "kernel_single_ms": statistics.median(single["kernel"]),
        "kernel_single_ms_runs": single["kernel"],
        "kernel_host_us": _host_us(fns["kernel"]),
        "wrapper_ms": _median_ms(fns["wrapper"]),
        "wrapper_single_ms": _median_ms(fns["wrapper"], batched=False),
        "wrapper_host_us": _host_us(fns["wrapper"]),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
        "flops": flops,
        "plain_ms": _median_ms(fns["plain"]),
        "library_ms": None,
        "library_single_ms": None,
    }
    if "library" in pair:
        rec.update(library_ms=statistics.median(batched["library"]),
                   library_ms_runs=batched["library"],
                   library_single_ms=statistics.median(single["library"]),
                   library_single_ms_runs=single["library"])
    return rec


def _order_times(launch) -> dict:
    """B2 at one shape in the sawtooth and in the cyclic order, four batched
    readings each taken in turns (``_readings``); ``launch(order)``
    launches it once. Each order's figure is the median of its readings."""
    runs = _readings({order: (lambda order=order: launch(order))
                      for order in ("sawtooth", "cyclic")}, rounds=4)
    return {"sawtooth": statistics.median(runs["sawtooth"]),
            "cyclic": statistics.median(runs["cyclic"]), "runs": runs}


def phase_long_flash_times(dev_info: dict) -> dict:
    """B2 at an informational shape whose K and V (268 MB) exceed the 50 MB
    L2 many times over: B 1, Sq = Skv = 16384, 32 heads of 128, causal, in
    the sawtooth and the cyclic order, beside SDPA; no limit. The output is
    held to SDPA's (the plain version at this size takes seconds a call,
    so it is not timed). The paper's claim is that sawtooth order keeps
    more of the K/V a CTA walks in cache than cyclic order."""
    from repro_torch.kernels.flash_attention import launch_flash_fwd

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(12)
    b, h, s, d = 1, 32, 16384, 128
    q, k, v = (_bf16(gen, (b, s, h, d)) for _ in range(3))
    out = torch.empty_like(q)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    launch_flash_fwd(q, k, v, out, order="sawtooth", causal=True)
    lib = sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
    torch.cuda.synchronize()
    orders = _order_times(lambda order: launch_flash_fwd(q, k, v, out, order=order, causal=True))
    t_lib = statistics.median(_readings({"library": lambda: sdpa(qt, kt, vt, is_causal=True)},
                                        rounds=4)["library"])
    nbytes, flops = 4 * b * s * h * d * 2, 4.0 * b * h * d * s * (s + 1) / 2
    t_bytes, t_ops = nbytes / dev_info["bw"] * 1e3, flops / dev_info["peak"] * 1e3
    rec = {
        "shape": {"B": b, "Sq": s, "Skv": s, "Hq": h, "Hkv": h, "D": d, "causal": True},
        "kernel_ms": orders["sawtooth"],
        "orders_ms": orders,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": t_lib,
        "plain_ms": None,
        "library_max_abs_diff": (out.float() - lib.float()).abs().max().item(),
        "tflops_sawtooth": flops / orders["sawtooth"] / 1e9,
        "tflops_cyclic": flops / orders["cyclic"] / 1e9,
    }
    print("[time] flash_fwd long (informational): " + json.dumps(rec))
    del q, k, v, out, qt, kt, vt, lib
    torch.cuda.empty_cache()
    return rec


def phase_static_kernel_times(dev_info: dict, d: int = 128, *, h: int = 32, s: int = 700,
                              cross: bool = False) -> dict:
    """B2 at the static path's second prefill (B 8, Sq = Skv = ``s``, ``h``
    heads of ``d``, sawtooth; causal, or with ``cross`` not) and B3 at its
    decode steps (B 8, S_max 1024; lengths ``s`` to ``s`` + 31 by row, or
    with ``cross`` ``s`` on every row, the cross K/V of a group whose
    bucket is ``s``): deepseek-7b's shapes at d 128, zamba2's shared
    attention at d 80, phi-3-vision's at d 96 (``s`` 708: its bucket of 700
    after a prefix of 8), seamless-m4t-medium's at d 64 with ``h`` 16 and
    ``cross`` (its encoder, and its decoder's cross attention). Bytes: each
    input read once, each output written once (B3: K and V below each
    row's length only); flops: 4 per visible (query, key) pair and head
    dim."""
    from repro_torch.core.attention import decode_attention, flash_attention
    from repro_torch.kernels.flash_attention import (
        FWD_BLOCK_M,
        FWD_BLOCK_N,
        flash_attention_fwd,
        launch_flash_fwd,
    )
    from repro_torch.kernels.flash_decode import (
        decode_chunk,
        decode_kernel_attr,
        flash_decode_fwd,
        launch_contig_decode,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, causal = 8, not cross
    q, k, v = _bf16(gen, (b, s, h, d)), _bf16(gen, (b, s, h, d)), _bf16(gen, (b, s, h, d))
    out = torch.empty_like(q)
    kw = dict(order="sawtooth", causal=causal)
    got = flash_attention_fwd(q, k, v, **kw)
    tiles = dict(q_block=FWD_BLOCK_M, kv_block=FWD_BLOCK_N)
    ref = flash_attention(q.float(), k.float(), v.float(), **tiles, **kw)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = sdpa(qt, kt, vt, is_causal=causal).transpose(1, 2)
    torch.cuda.synchronize()
    pairs = s * (s + 1) / 2 if causal else s * s
    prefill = _time_record(
        {
            "kernel": lambda: launch_flash_fwd(q, k, v, out, **kw),
            "wrapper": lambda: flash_attention_fwd(q, k, v, **kw),
            "plain": lambda: flash_attention(q, k, v, **tiles, **kw),
            "library": lambda: sdpa(qt, kt, vt, is_causal=causal),
        },
        nbytes=4 * b * s * h * d * 2, flops=4.0 * b * h * d * pairs, dev_info=dev_info,
    )
    prefill.update(shape={"B": b, "Sq": s, "Skv": s, "Hq": h, "Hkv": h, "D": d,
                          "causal": causal},
                   max_abs_err=(got.float() - ref).abs().max().item(),
                   library_max_abs_diff=(got.float() - lib.float()).abs().max().item(),
                   orders_ms=_order_times(
                       lambda order: launch_flash_fwd(q, k, v, out, order=order, causal=causal)),
                   kernel_attr=dev_info["flash_fwd_attr"][d])
    tag = f"D{d} H{h} S{s}"
    print(f"[time] flash_fwd prefill {tag}" + (" non-causal" if cross else "") + ": "
          + json.dumps(prefill))

    s_max = 1024
    rng = np.random.default_rng(7)
    lens0 = [s] * b if cross else [int(x) for x in rng.integers(s, s + 32, size=b)]
    lens = torch.tensor(lens0, dtype=torch.int32, device="cuda")
    qd = _bf16(gen, (b, 1, h, d))
    kc, vc = _bf16(gen, (b, s_max, h, d)), _bf16(gen, (b, s_max, h, d))
    got = flash_decode_fwd(qd, kc, vc, lens, order="sawtooth")
    ref = decode_attention(qd.float(), kc.float(), vc.float(), lens)
    qdt, kct, vct = (x.transpose(1, 2).contiguous() for x in (qd, kc, vc))
    mask = (torch.arange(s_max, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    torch.cuda.synchronize()
    decode = _time_record(
        {
            "kernel": lambda: launch_contig_decode(qd, kc, vc, lens, order="sawtooth"),
            "wrapper": lambda: flash_decode_fwd(qd, kc, vc, lens, order="sawtooth"),
            "plain": lambda: decode_attention(qd, kc, vc, lens),
            "library": lambda: sdpa(qdt, kct, vct, attn_mask=mask),
        },
        nbytes=sum(lens0) * h * d * 2 * 2 + 2 * b * h * d * 2,
        flops=4.0 * sum(lens0) * h * d, dev_info=dev_info,
    )
    decode.update(shape={"B": b, "S_max": s_max, "lens": lens0, "Hq": h, "Hkv": h, "D": d},
                  max_abs_err=(got.float() - ref).abs().max().item(),
                  kernel_attr=decode_kernel_attr(
                      "contig_decode", (b, s_max, h, h, d, decode_chunk(512, s_max))),
                  alternating_ms=_alternating_contig(qd, kc, vc, lens))
    print(f"[time] contig_decode step {tag}" + (" cross" if cross else "") + ": "
          + json.dumps(decode))
    for rec in (prefill, decode):
        assert rec["max_abs_err"] <= KERNEL_TOL, rec["max_abs_err"]
    return {"flash_fwd": prefill, "contig_decode": decode}


def phase_train_kernel_times(dev_info: dict, d: int = 128) -> dict:
    """B2 with lse and B4, B5, B6 at the training shape (B 4, S 1024, 32
    heads of ``d``, causal, sawtooth): deepseek-7b's at d 128, zamba2's
    shared attention at d 80, phi-3-vision's at d 96 (its 32 heads, and
    1024 positions: the prefix of 256 and 768 tokens). Bytes: each input
    read once, each
    output written once; flops: 2 per visible (query, key) pair, head dim
    and product (B2 two products, B5 three, B6 four). No single PyTorch
    call computes one of B4-B6 alone; SDPA's backward (causal, timed alone
    on a saved graph) computes all three together and is given beside
    their sum. The plain version of B5 and B6 is the plain backward, which
    computes delta, dQ, dK and dV together."""
    from repro_torch.core.attention import attention_delta, flash_attention
    from repro_torch.core.attention import flash_attention_bwd as plain_bwd
    from repro_torch.kernels.flash_attention import (
        BLOCK_M,
        BLOCK_N,
        FWD_BLOCK_M,
        FWD_BLOCK_N,
        flash_attention_bwd,
        flash_attention_fwd,
        launch_flash_bwd_delta,
        launch_flash_bwd_dkv,
        launch_flash_bwd_dq,
        launch_flash_fwd,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, h, s = 4, 32, 1024
    q, k, v, do = (_bf16(gen, (b, s, h, d)) for _ in range(4))
    kw = dict(order="sawtooth", causal=True)
    tiles = dict(q_block=BLOCK_M, kv_block=BLOCK_N)
    fwd_tiles = dict(q_block=FWD_BLOCK_M, kv_block=FWD_BLOCK_N)
    o, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
    out, lse2 = torch.empty_like(q), torch.empty_like(lse)
    delta, dq = torch.empty_like(lse), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch_flash_bwd_delta(o, do, delta)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = plain_bwd(q.float(), k.float(), v.float(), o.float(), lse, do.float(), **tiles, **kw)
    ref_o, ref_lse = flash_attention(q.float(), k.float(), v.float(), return_lse=True,
                                     **fwd_tiles, **kw)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    lib_grads = torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)
    torch.cuda.synchronize()
    lse_err = (lse - ref_lse).abs().max().item()
    assert lse_err <= LSE_TOL, lse_err
    errs = {
        "flash_fwd": (o.float() - ref_o).abs().max().item(),
        "flash_bwd_delta": _rel_err(delta, attention_delta(o, do)),
        "flash_bwd_dq": _rel_err(got[0], want[0]),
        "flash_bwd_dkv": max(_rel_err(got[1], want[1]), _rel_err(got[2], want[2])),
    }
    lib_diff = max(_rel_err(x, y.transpose(1, 2).float())
                   for x, y in zip(got, lib_grads))
    bhsd = b * s * h * d
    pairs = b * h * s * (s + 1) / 2          # visible (query, key) pairs over all heads
    mm = 2.0 * pairs * d                     # flops of one score-shaped product
    rows = b * s * h * 4                     # one float32 per row (lse, delta)
    recs = {
        "flash_fwd": _time_record({
            "kernel": lambda: launch_flash_fwd(q, k, v, out, lse2, **kw),
            "wrapper": lambda: flash_attention_fwd(q, k, v, return_lse=True, **kw),
            "plain": lambda: flash_attention(q, k, v, return_lse=True, **fwd_tiles, **kw),
            "library": lambda: sdpa(qt, kt, vt, is_causal=True),
        }, nbytes=4 * bhsd * 2 + rows, flops=2 * mm, dev_info=dev_info),
        "flash_bwd_delta": _time_record({
            "kernel": lambda: launch_flash_bwd_delta(o, do, delta),
            "wrapper": lambda: launch_flash_bwd_delta(o, do, delta),
            "plain": lambda: attention_delta(o, do),
            "library": None,
        }, nbytes=2 * bhsd * 2 + rows, flops=2.0 * bhsd, dev_info=dev_info),
        "flash_bwd_dq": _time_record({
            "kernel": lambda: launch_flash_bwd_dq(q, k, v, do, lse, delta, dq, **kw),
            "wrapper": lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
            "plain": lambda: plain_bwd(q, k, v, o, lse, do, **tiles, **kw),
            "library": None,
        }, nbytes=5 * bhsd * 2 + 2 * rows, flops=3 * mm, dev_info=dev_info),
        "flash_bwd_dkv": _time_record({
            "kernel": lambda: launch_flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, **kw),
            "wrapper": lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
            "plain": lambda: plain_bwd(q, k, v, o, lse, do, **tiles, **kw),
            "library": None,
        }, nbytes=6 * bhsd * 2 + 2 * rows, flops=4 * mm, dev_info=dev_info),
    }
    trio = _bwd_against_sdpa(
        lambda: (launch_flash_bwd_delta(o, do, delta),
                 launch_flash_bwd_dq(q, k, v, do, lse, delta, dq, **kw),
                 launch_flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, **kw)),
        lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True))
    bwd_sum = sum(recs[n]["kernel_ms"] for n in ("flash_bwd_delta", "flash_bwd_dq",
                                                  "flash_bwd_dkv"))
    shape = {"B": b, "Sq": s, "Skv": s, "Hq": h, "Hkv": h, "D": d, "causal": True,
             "order": "sawtooth"}
    recs["flash_fwd"].update(
        orders_ms=_order_times(lambda order: launch_flash_fwd(q, k, v, out, lse2, order=order,
                                                              causal=True)),
        kernel_attr=dev_info["flash_fwd_attr"][d])
    recs["flash_bwd_dq"].update(
        orders_ms=_order_times(lambda order: launch_flash_bwd_dq(q, k, v, do, lse, delta, dq,
                                                                 order=order, causal=True)),
        kernel_attr=dev_info["kernel_attr"]["flash_bwd_dq"][d])
    recs["flash_bwd_dkv"].update(
        orders_ms=_order_times(lambda order: launch_flash_bwd_dkv(q, k, v, do, lse, delta, dk,
                                                                  dv, order=order, causal=True)),
        kernel_attr=dev_info["kernel_attr"]["flash_bwd_dkv"][d])
    for name, rec in recs.items():
        rec.update(shape=shape, max_abs_err=errs[name])
        if name != "flash_fwd":
            rec.update(sdpa_bwd_ms=trio["sdpa_bwd_ms"], bwd_kernels_sum_ms=bwd_sum,
                       bwd_trio=trio, sdpa_bwd_rel_diff=lib_diff,
                       plain_covers="flash_bwd_delta+flash_bwd_dq+flash_bwd_dkv"
                       if name != "flash_bwd_delta" else "flash_bwd_delta")
        print(f"[time] {name} train D{d}: " + json.dumps(rec))
    for name, rec in recs.items():
        tol = DELTA_TOL if name == "flash_bwd_delta" else BWD_TOL
        if name == "flash_fwd":
            tol = KERNEL_TOL
        assert rec["max_abs_err"] <= tol, (name, rec["max_abs_err"])
    return recs


def _bwd_against_sdpa(kernels, sdpa) -> dict:
    """B4, B5 and B6 launched back to back (``kernels()``) and SDPA's
    backward (``sdpa()``) read alike and in turns: four batched readings
    each and two single-launch ones (``_readings``), each figure the median
    of its readings."""
    fns = {"kernels": kernels, "sdpa": sdpa}
    batched = _readings(fns, rounds=4)
    single = _readings(fns, rounds=2, batched=False)
    return {"trio_ms": statistics.median(batched["kernels"]),
            "sdpa_bwd_ms": statistics.median(batched["sdpa"]),
            "trio_single_ms": statistics.median(single["kernels"]),
            "sdpa_bwd_single_ms": statistics.median(single["sdpa"]),
            "runs": batched, "single_runs": single}


def phase_long_bwd_times(dev_info: dict) -> dict:
    """B4-B6 at the informational long shape (B 1, Sq = Skv = 16384, 32
    heads of 128, causal) beside SDPA's backward; no limit. B5 and B6 in the
    sawtooth and the cyclic order (``_order_times``), the three kernels back
    to back against SDPA's backward (``_bwd_against_sdpa``). The gradients
    are held to SDPA's (max-abs difference over max |SDPA|, printed; the
    plain backward at this size takes seconds a call, so it is not run)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        launch_flash_bwd_delta,
        launch_flash_bwd_dkv,
        launch_flash_bwd_dq,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, h, s, d = 1, 32, 16384, 128
    q, k, v, do = (_bf16(gen, (b, s, h, d)) for _ in range(4))
    kw = dict(order="sawtooth", causal=True)
    o, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    lib = torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)
    torch.cuda.synchronize()
    if not all(torch.isfinite(x.float()).all() for x in got):
        raise AssertionError("flash_bwd long shape: non-finite gradients")
    diff = {name: _rel_err(x, y.transpose(1, 2).float())
            for name, x, y in zip(("dq", "dk", "dv"), got, lib)}
    delta, dq = torch.empty_like(lse), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch_flash_bwd_delta(o, do, delta)
    orders = {
        "flash_bwd_dq": _order_times(lambda order: launch_flash_bwd_dq(
            q, k, v, do, lse, delta, dq, order=order, causal=True)),
        "flash_bwd_dkv": _order_times(lambda order: launch_flash_bwd_dkv(
            q, k, v, do, lse, delta, dk, dv, order=order, causal=True)),
    }
    trio = _bwd_against_sdpa(
        lambda: (launch_flash_bwd_delta(o, do, delta),
                 launch_flash_bwd_dq(q, k, v, do, lse, delta, dq, **kw),
                 launch_flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, **kw)),
        lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True))
    mm = 2.0 * b * h * d * s * (s + 1) / 2  # flops of one score-shaped product
    rec = {"shape": {"B": b, "Sq": s, "Skv": s, "Hq": h, "Hkv": h, "D": d, "causal": True},
           "orders_ms": orders, "trio": trio, "sdpa_bwd_rel_diff": diff,
           "bound_ms": {"flash_bwd_dq": 3 * mm / dev_info["peak"] * 1e3,
                        "flash_bwd_dkv": 4 * mm / dev_info["peak"] * 1e3},
           "tflops_sawtooth": {"flash_bwd_dq": 3 * mm / orders["flash_bwd_dq"]["sawtooth"] / 1e9,
                               "flash_bwd_dkv": 4 * mm / orders["flash_bwd_dkv"]["sawtooth"]
                               / 1e9}}
    print("[time] flash_bwd long (informational): " + json.dumps(rec))
    del q, k, v, do, o, lse, got, qt, kt, vt, lib_out, dot, lib, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return rec


def phase_l2_model(static_times: dict, d80_times: dict, train_times: dict,
                   long_times: dict) -> dict:
    """The walks B2 and B6 take on this card played through the LRU model
    of an L2 (``kernels.traffic.fwd_walk_llc_model``/``dkv_walk_llc_model``,
    one CTA per SM in lock step), in the sawtooth and the cyclic order, at
    the card's L2 size (``torch.cuda.get_device_properties``) and at half
    of it: B2 at the static path's second prefill (D 128 and zamba2's D 80),
    the training shape and the 16k shape; B6 at the training shape. Beside
    each, the kernel's time in that order measured in this run (phase 4).
    Modeled bytes; no limit."""
    from repro_torch.core.cache_model import H100, device_hw_config
    from repro_torch.kernels.flash_attention import kernel_traversal
    from repro_torch.kernels.traffic import dkv_walk_llc_model, fwd_walk_llc_model

    hw = device_hw_config()
    print(f"[model] L2 config: the card reports {hw.name}, {hw.n_workers} SMs, L2 "
          f"{hw.cache_bytes} bytes; the data-sheet constant H100: {H100.n_workers} SMs, L2 "
          f"{H100.cache_bytes} bytes")
    caps = {"l2": float(hw.cache_bytes), "half_l2": hw.cache_bytes / 2}
    shapes = [
        ("flash_fwd", "prefill D128", (8, 700, 32, 128), static_times["flash_fwd"]["orders_ms"]),
        ("flash_fwd", "prefill D80", (8, 700, 32, 80), d80_times["flash_fwd"]["orders_ms"]),
        ("flash_fwd", "train", (4, 1024, 32, 128), train_times["flash_fwd"]["orders_ms"]),
        ("flash_fwd", "long 16k", (1, 16384, 32, 128), long_times["orders_ms"]),
        ("flash_bwd_dkv", "train", (4, 1024, 32, 128),
         train_times["flash_bwd_dkv"]["orders_ms"]),
    ]
    out = {"card": {"name": hw.name, "sms": hw.n_workers, "l2_bytes": hw.cache_bytes},
           "shapes": []}
    for kernel, label, (bsz, seq, heads, d), measured in shapes:
        model = fwd_walk_llc_model if kernel == "flash_fwd" else dkv_walk_llc_model
        rec = {"kernel": kernel, "shape": label,
               "dims": {"B": bsz, "S": seq, "H": heads, "D": d, "causal": True}}
        for order in ("sawtooth", "cyclic"):
            tr = kernel_traversal(seq, seq, 1, kernel=kernel, order=order, causal=True,
                                  window=None)
            t0 = time.perf_counter()
            results = model(tr, bsz * heads, hw.n_workers, capacities=list(caps.values()),
                            head_dim=d, seq_q=seq, seq_kv=seq)
            host_s = time.perf_counter() - t0
            rec[order] = {
                **{name: {"miss_bytes": r.misses, "cold_bytes": r.cold_misses,
                          "non_compulsory_bytes": r.non_compulsory_misses}
                   for name, r in zip(caps, results)},
                "read_bytes": results[0].accesses,
                "measured_ms": measured[order],
                "host_s": host_s,
            }
        out["shapes"].append(rec)
        print(f"[model] {kernel} {label} (B {bsz}, S {seq}, {heads} x {d}): modeled L2 bytes "
              f"of its walks, beside its measured ms: " + json.dumps(rec))
    return out


def _ssd_work(bsz: int, s: int, h: int, n: int, p: int = 64) -> tuple[int, float, float]:
    """(bytes, flops, float32 flops) of B7 on these shapes, started from
    zeros as ops.ssd starts it on the main path (no initial state read).
    Bytes: x, dt, a, b and c read once, y and the final state written once.
    Flops: C B^T once per (batch row, chunk), being the same for every head,
    on the positions j <= i; then per head W X (j <= i), C S^T and the state
    update, over each chunk's positions below S. The third value is the
    part of those whose operands are float32 (all but C B^T): B7 runs
    each as two bf16 products (hi and lo parts) on the tensor cores, which
    the bound does not count twice."""
    nbytes = 2 * bsz * s * h * p * 2 + bsz * s * h * 4 + h * 4 + 2 * bsz * s * n * 2
    nbytes += bsz * h * p * n * 4
    fl16 = fl32 = 0.0
    for s0 in range(0, s, 128):
        rows = min(128, s - s0)
        tri = rows * (rows + 1) / 2
        fl16 += bsz * 2 * tri * n
        fl32 += bsz * h * (2 * tri * p + 2 * rows * n * p + 2 * rows * p * n)
    return nbytes, fl16 + fl32, fl32


def phase_ssd_kernel_times(dev_info: dict) -> dict:
    """B7 at the second prefill group of each SSM path (B 8, S 700, the
    bucket of requests 8-11): mamba2-130m's 24 heads at N 128 and
    zamba2-2.7b's 80 heads at N 64, P 64, from a zero state as ops.ssd
    passes it (None). No single PyTorch call computes the scan: library_ms
    is None. bound_ms takes every product at the dense bf16 peak, the rate
    that tensor-core products at float32 accuracy (split bf16, 3xTF32)
    approach (B7's split-bf16 products do twice that work);
    ``bound_f32_fma_ms``, for comparison, is the bound of a design that runs
    the float32 products as FMAs at the data sheet's float32 rate outside
    the tensor cores. ``kernel_attr``: the launch's
    registers, spill bytes, shared memory, threads, cluster size and CTAs
    (``ssd_kernel_attr``), with the build's C7515 advisories."""
    from repro_torch.kernels.ssd import launch_ssd, ssd_fwd, ssd_kernel_attr
    from repro_torch.models.ssm import ssd_chunked

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for arch, h, nd in (("mamba2-130m", 24, 128), ("zamba2-2_7b", 80, 64)):
        bsz, s = 8, 700
        x, dt, a, b, c, _ = _ssd_case(gen, bsz, s, h, nd, False)
        y, fin = torch.empty_like(x), torch.empty((bsz, h, 64, nd), device="cuda")
        got_y, got_fin = ssd_fwd(x, dt, a, b, c)
        ry, rfin = ssd_chunked(x.float(), dt, a, b.float(), c.float(), chunk=128)
        torch.cuda.synchronize()
        nbytes, flops, fl32 = _ssd_work(bsz, s, h, nd)
        rec = _time_record({
            "kernel": lambda: launch_ssd(x, dt, a, b, c, None, y, fin),
            "wrapper": lambda: ssd_fwd(x, dt, a, b, c),
            "plain": lambda: ssd_chunked(x, dt, a, b, c, chunk=128),
            "library": None,
        }, nbytes=nbytes, flops=flops, dev_info=dev_info)
        t_fma = ((flops - fl32) / dev_info["peak"] + fl32 / dev_info["peak_f32"]) * 1e3
        rec.update(shape={"B": bsz, "S": s, "H": h, "P": 64, "N": nd, "chunk": 128},
                   bound_f32_fma_ms=max(nbytes / dev_info["bw"] * 1e3, t_fma), flops_f32=fl32,
                   max_abs_err=_rel_err(got_y, ry), state_rel_err=_rel_err(got_fin, rfin),
                   max_abs_err_is="max-abs error over max |plain|",
                   kernel_attr=ssd_kernel_attr(bsz, h, nd)
                   | {"c7515_advisories": dev_info["c7515"]["ssd"]})
        print(f"[time] ssd {arch}: " + json.dumps(rec))
        assert rec["max_abs_err"] <= SSD_Y_TOL and rec["state_rel_err"] <= SSD_STATE_TOL, rec
        out[arch] = rec
    return out


def _alternating_orders(q, k, v, bt, lens, qls, nb) -> dict:
    """Per-launch time of launch pairs whose rows' lengths differ by one, as
    two consecutive decode steps do, with the pages walked in cyclic and in
    sawtooth order: sawtooth starts each launch on the pages the previous
    one read last (the paper's L2 reuse). Two batched readings of each,
    taken in turns; each order's figure is the median of its readings."""
    from repro_torch.kernels.flash_decode import fold_schedule, launch_paged_decode

    lens2 = lens + 1
    fns = {}
    for name, group in (("cyclic", 1), ("sawtooth", nb)):
        pa, la = fold_schedule(lens, bt, order_group=group)
        pb, lb = fold_schedule(lens2, bt, order_group=group)
        fns[name] = lambda pa=pa, la=la, pb=pb, lb=lb: (
            launch_paged_decode(q, k, v, pa, la, lens, qls),
            launch_paged_decode(q, k, v, pb, lb, lens2, qls),
        )
    runs = {name: [t / 2 for t in ts] for name, ts in _readings(fns, rounds=2).items()}
    return {name: statistics.median(ts) for name, ts in runs.items()} | {"runs": runs}


def _alternating_contig(q, k, v, lens) -> dict:
    """B3's reading of two consecutive decode steps (lengths differing by
    one) in the cyclic and the sawtooth chunk order, as _alternating_orders
    reads B1; B3's parity key is the (row, kv head) index, so sawtooth
    reverses every other item's chunks in both steps."""
    from repro_torch.kernels.flash_decode import launch_contig_decode

    lens2 = lens + 1
    fns = {name: (lambda name=name: (launch_contig_decode(q, k, v, lens, order=name),
                                     launch_contig_decode(q, k, v, lens2, order=name)))
           for name in ("cyclic", "sawtooth")}
    runs = {name: [t / 2 for t in ts] for name, ts in _readings(fns, rounds=2).items()}
    return {name: statistics.median(ts) for name, ts in runs.items()} | {"runs": runs}


def phase_split_times() -> dict:
    """Informational: B1 and B3 at one decode step of a single sequence of
    8187 cached positions (32 heads of 128, page 64), where B x Hkv = 32
    items would leave most SMs idle without a split, at every cluster size
    S and at the kernels' own choice; batched device time, one reading
    each."""
    from repro_torch.kernels.flash_decode import (
        fold_schedule,
        launch_contig_decode,
        launch_paged_decode,
    )

    gen = torch.Generator(device="cuda").manual_seed(13)
    h, d, page, ln = 32, 128, 64, 8192
    nb = ln // page
    q = _bf16(gen, (1, 1, h, d))
    k, v = _bf16(gen, (nb + 1, page, h, d)), _bf16(gen, (nb + 1, page, h, d))
    bt = (torch.randperm(nb, generator=gen, device="cuda") + 1).reshape(1, nb).to(torch.int32)
    lens = torch.tensor([ln - 5], dtype=torch.int32, device="cuda")
    qls = torch.ones((1,), dtype=torch.int32, device="cuda")
    phys, logical = fold_schedule(lens, bt, order_group=nb)
    kc, vc = _bf16(gen, (1, ln, h, d)), _bf16(gen, (1, ln, h, d))
    out = {}
    for name, launch in (
        ("paged_decode", lambda s: launch_paged_decode(q, k, v, phys, logical, lens, qls,
                                                       splits=s)),
        ("contig_decode", lambda s: launch_contig_decode(q, kc, vc, lens, order="sawtooth",
                                                         splits=s)),
    ):
        out[name] = {str(s): _median_ms(lambda s=s: launch(s)) for s in (1, 2, 4, 8)}
        out[name]["auto"] = _median_ms(lambda: launch(None))
        print(f"[time] {name} one sequence of {ln - 5} positions by cluster size "
              f"(informational): " + json.dumps(out[name]))
    return out


def _entry(name: str, launches: int, max_abs_err: float, rec: dict, **extra) -> dict:
    from repro_torch.kernels import cuda_lib

    spec = cuda_lib.KERNELS[name]
    return {
        "name": spec.name,
        "route": "cuda",
        "source": f"src/repro_torch/csrc/{spec.source}",
        "replaces": spec.replaces,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": rec["kernel_ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
        "ms_single": rec["kernel_single_ms"],
        "library_single_ms": rec["library_single_ms"],
        "wrapper_ms": rec["wrapper_ms"],
        "wrapper_single_ms": rec["wrapper_single_ms"],
        "wrapper_host_us": rec["wrapper_host_us"],
        **extra,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile each main path (half of the serve requests of each "
                         "serve path, one training step) under torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test runs on the GPU only",
              file=sys.stderr)
        return 2
    _port()
    t_start = time.perf_counter()
    dev_info = phase_device()
    worst = phase_kernel_matrix()
    flash_worst = phase_flash_matrix()
    decode_worst = phase_decode_matrix()
    bwd_worst = phase_bwd_matrix()
    ssd_check = phase_ssd_matrix()
    cfg, lm, params = build_main_model()
    main_path = phase_main_path(cfg, lm, params, profile=args.profile)
    adapt, fixed = phase_adapt_path(cfg, lm, params, main_path)
    static = phase_static_path(cfg, lm, params, profile=args.profile)
    int8_cont = phase_int8_continuous(cfg, params, fixed, main_path)
    int8_run = int8_cont.pop("run")
    int8_static = phase_int8_static(cfg, params, static)
    optimistic = phase_optimistic_path(cfg, lm, params, fixed)
    faults = phase_fault_path(cfg, lm, params, fixed)
    tiered, tiered_run = phase_tiered_path(cfg, lm, params, fixed, int8_run)
    tier_faults = phase_tier_fault_path(cfg, lm, params, fixed, tiered_run)
    spec = phase_spec_path(cfg, lm, params, fixed)
    sharded_serve = phase_sharded_serve(cfg, lm, params, main_path, static)
    del lm, params, fixed, int8_run, tiered_run
    torch.cuda.empty_cache()
    moe_matrix = phase_moe_matrix(dev_info)
    moe_cont, moe_static = phase_moe_path(moe_matrix, profile=args.profile)
    torch.cuda.empty_cache()
    encdec = phase_family_path(ENCDEC_ARCH, profile=args.profile)
    vlm = phase_family_path(VLM_ARCH, profile=args.profile)
    train_encdec = phase_train_family(ENCDEC_ARCH)
    train_vlm = phase_train_family(VLM_ARCH)
    train_olmoe = phase_train_moe()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = phase_train_main(profile=args.profile)
    sharded_train = phase_sharded_train()
    if torch.distributed.is_initialized():  # the dry-run joins fake groups of its own
        torch.distributed.destroy_process_group()
    dryrun = phase_dryrun()
    dryrun_vs_card = phase_dryrun_vs_card(sharded_train)
    examples = phase_examples()
    small = phase_small_model()
    small_static = phase_small_static()
    loop = phase_train_loop()
    small_train = phase_small_train()
    mamba = phase_ssm_path("mamba2-130m", profile=args.profile)
    zamba = phase_ssm_path("zamba2-2_7b", profile=args.profile)
    train_mamba = phase_train_ssm("mamba2-130m")
    train_zamba = phase_train_ssm("zamba2-2_7b")
    phase_unsafe_capture()
    times = phase_kernel_times(dev_info, main_path)
    static_times = phase_static_kernel_times(dev_info)
    d80_times = phase_static_kernel_times(dev_info, d=80)
    train_times = phase_train_kernel_times(dev_info)
    train80_times = phase_train_kernel_times(dev_info, d=80)
    d96_times = phase_static_kernel_times(dev_info, d=96, s=708)
    encdec_times = phase_static_kernel_times(dev_info, d=64, h=16, cross=True)
    train96_times = phase_train_kernel_times(dev_info, d=96)
    long_times = phase_long_flash_times(dev_info)
    long_bwd = phase_long_bwd_times(dev_info)
    ssd_times = phase_ssd_kernel_times(dev_info)
    split_times = phase_split_times()
    l2_model = phase_l2_model(static_times, d80_times, train_times, long_times)

    paths = {"continuous": main_path, "adapt": adapt, "static": static,
             "int8_continuous": int8_cont, "int8_static": int8_static, "optimistic": optimistic,
             "faults": faults, "tiered": tiered, "tier_faults": tier_faults, "spec": spec,
             "olmoe_continuous": moe_cont, "olmoe_static": moe_static, "train": train,
             "mamba2": mamba, "zamba2": zamba,
             "train_mamba2": train_mamba, "train_zamba2": train_zamba,
             "encdec": encdec, "vlm": vlm, "train_encdec": train_encdec, "train_vlm": train_vlm,
             "train_olmoe": train_olmoe, "sharded_train": sharded_train,
             "sharded_serve": sharded_serve, "examples": examples}
    by_path = {name: {path: rec["launches"].get(name, 0) for path, rec in paths.items()}
               for name in main_path["launches"]}
    launches = {name: sum(paths.values()) for name, paths in by_path.items()}
    narrow, wide = times["narrow"], times["wide"]
    fwd, dec = static_times["flash_fwd"], static_times["contig_decode"]
    timing_keys = ("kernel_ms", "kernel_single_ms", "wrapper_ms", "wrapper_single_ms",
                   "wrapper_host_us", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "library_single_ms")
    def shape_rec(rec, *extra):
        return {k: rec[k] for k in ("shape", *timing_keys, *extra)}

    kernels = [
        _entry("paged_decode", launches["paged_decode"],
               max(worst, narrow["max_abs_err"], wide["max_abs_err"]), narrow,
               wide={k: wide[k] for k in (*timing_keys, "kernel_attr")},
               kernel_attr=narrow["kernel_attr"], alternating_ms=narrow["alternating_ms"],
               one_sequence_splits_ms=split_times["paged_decode"],
               small_model_max_abs_err=small),
        _entry("flash_fwd", launches["flash_fwd"],
               max(flash_worst, fwd["max_abs_err"], train_times["flash_fwd"]["max_abs_err"],
                   train80_times["flash_fwd"]["max_abs_err"],
                   train96_times["flash_fwd"]["max_abs_err"], d96_times["flash_fwd"]["max_abs_err"],
                   encdec_times["flash_fwd"]["max_abs_err"]), fwd,
               launches_per_prefill=static["launches"]["flash_fwd"] / static["prefill_calls"],
               launches_per_train_step=train["launches"]["flash_fwd"] / train["steps"],
               launches_per_zamba2_train_step=train_zamba["launches"]["flash_fwd"]
               / train_zamba["steps"],
               orders_ms=fwd["orders_ms"],
               modeled_l2={r["shape"]: {o: r[o] for o in ("sawtooth", "cyclic")}
                           for r in l2_model["shapes"] if r["kernel"] == "flash_fwd"},
               train_shape={k: train_times["flash_fwd"][k] for k in (*timing_keys, "orders_ms")},
               d80_zamba2_train_shape={k: train80_times["flash_fwd"][k]
                                       for k in (*timing_keys, "orders_ms")},
               d80_zamba2_shape={k: d80_times["flash_fwd"][k]
                                 for k in (*timing_keys, "orders_ms")},
               d96_phi3v_shape=shape_rec(d96_times["flash_fwd"], "orders_ms", "kernel_attr"),
               d96_phi3v_train_shape=shape_rec(train96_times["flash_fwd"], "orders_ms"),
               d64_seamless_encoder_shape=shape_rec(encdec_times["flash_fwd"], "orders_ms"),
               launches_per_seamless_prefill=encdec["launches_per_prefill"],
               launches_per_phi3v_prefill=vlm["launches_per_prefill"],
               launches_per_seamless_train_step=train_encdec["launches"]["flash_fwd"]
               / train_encdec["steps"],
               launches_per_phi3v_train_step=train_vlm["launches"]["flash_fwd"]
               / train_vlm["steps"],
               launches_per_olmoe_train_step=train_olmoe["launches"]["flash_fwd"]
               / train_olmoe["steps"],
               launches_per_sharded_train_step=sharded_train["launches"]["flash_fwd"]
               / sharded_train["steps"],
               long_shape_informational={k: long_times[k] for k in (
                   "shape", "kernel_ms", "orders_ms", "bound_ms", "bound_by", "library_ms",
                   "library_max_abs_diff")},
               kernel_attr=dev_info["flash_fwd_attr"],
               small_model_max_abs_err=small_static),
        _entry("contig_decode", launches["contig_decode"],
               max(decode_worst, dec["max_abs_err"], d80_times["contig_decode"]["max_abs_err"],
                   d96_times["contig_decode"]["max_abs_err"],
                   encdec_times["contig_decode"]["max_abs_err"]),
               dec,
               d96_phi3v_shape=shape_rec(d96_times["contig_decode"], "kernel_attr"),
               d64_seamless_cross_shape=shape_rec(encdec_times["contig_decode"], "kernel_attr"),
               launches_per_seamless_decode_step=encdec["launches_per_decode_step"],
               launches_per_phi3v_decode_step=vlm["launches_per_decode_step"],
               launches_per_decode_step=static["launches"]["contig_decode"]
               / static["decode_calls"],
               d80_zamba2_shape={k: d80_times["contig_decode"][k]
                                 for k in (*timing_keys, "kernel_attr", "alternating_ms")},
               kernel_attr=dec["kernel_attr"], alternating_ms=dec["alternating_ms"],
               one_sequence_splits_ms=split_times["contig_decode"],
               small_model_max_abs_err=small_static),
    ]
    for name, key in (("flash_bwd_delta", "delta"), ("flash_bwd_dq", "dq"),
                      ("flash_bwd_dkv", "dk")):
        rec, rec80, rec96 = train_times[name], train80_times[name], train96_times[name]
        err = max(bwd_worst[key], bwd_worst["dv"] if key == "dk" else 0.0, rec["max_abs_err"],
                  rec80["max_abs_err"], rec96["max_abs_err"])
        extra = {f"d{d}_{arch}_train_shape": {
            k: r[k] for k in (*timing_keys, "sdpa_bwd_ms", "bwd_kernels_sum_ms",
                              *(("orders_ms", "kernel_attr") if "orders_ms" in r else ()))}
            for d, arch, r in ((80, "zamba2", rec80), (96, "phi3v", rec96))}
        if name == "flash_bwd_dkv":
            extra["modeled_l2"] = {r["shape"]: {o: r[o] for o in ("sawtooth", "cyclic")}
                                   for r in l2_model["shapes"] if r["kernel"] == name}
        if name != "flash_bwd_delta":
            extra.update(orders_ms=rec["orders_ms"], kernel_attr=dev_info["kernel_attr"][name],
                         long_shape_informational={
                             "shape": long_bwd["shape"], "orders_ms": long_bwd["orders_ms"][name],
                             "bound_ms": long_bwd["bound_ms"][name], "bound_by": "operations",
                             "trio_ms": long_bwd["trio"]["trio_ms"],
                             "sdpa_bwd_ms": long_bwd["trio"]["sdpa_bwd_ms"],
                             "sdpa_bwd_rel_diff": long_bwd["sdpa_bwd_rel_diff"]})
        kernels.append(_entry(
            name, launches[name], err, rec,
            max_abs_err_is="max-abs error over max |plain|",
            launches_per_train_step=train["launches"][name] / train["steps"],
            launches_per_zamba2_train_step=train_zamba["launches"][name] / train_zamba["steps"],
            launches_per_seamless_train_step=train_encdec["launches"][name]
            / train_encdec["steps"],
            launches_per_phi3v_train_step=train_vlm["launches"][name] / train_vlm["steps"],
            launches_per_olmoe_train_step=train_olmoe["launches"][name] / train_olmoe["steps"],
            launches_per_sharded_train_step=sharded_train["launches"][name]
            / sharded_train["steps"],
            sdpa_bwd_ms=rec["sdpa_bwd_ms"], bwd_kernels_sum_ms=rec["bwd_kernels_sum_ms"],
            bwd_trio_ms=rec["bwd_trio"]["trio_ms"],
            plain_covers=rec["plain_covers"], small_train_max_abs_loss_diff=small_train,
            **extra))
    ssd_worst = ssd_check["worst"]
    kernels.append(_entry(
        "ssd", launches["ssd"],
        max(ssd_worst["y"], ssd_worst["chained_y"], *(r["max_abs_err"] for r in ssd_times.values())),
        ssd_times["mamba2-130m"],
        max_abs_err_is="max-abs error over max |plain| (y)",
        state_rel_err=max(ssd_worst["state"], ssd_worst["chained_state"],
                          *(r["state_rel_err"] for r in ssd_times.values())),
        bound_f32_fma_ms=ssd_times["mamba2-130m"]["bound_f32_fma_ms"],
        kernel_attr=ssd_times["mamba2-130m"]["kernel_attr"],
        zamba2_shape={k: ssd_times["zamba2-2_7b"][k]
                      for k in (*timing_keys, "bound_f32_fma_ms", "kernel_attr")},
        launches_per_prefill={"mamba2": mamba["launches"]["ssd"] / mamba["prefill_calls"],
                              "zamba2": zamba["launches"]["ssd"] / zamba["prefill_calls"]},
        launches_per_train_step={"mamba2": train_mamba["launches"]["ssd"] / train_mamba["steps"],
                                 "zamba2": train_zamba["launches"]["ssd"] / train_zamba["steps"]},
        backward="none: the SSD's backward re-runs the plain chunked scan under autograd, as "
                 "the reference's does (no backward kernel there either)",
        wrong_variants=ssd_check["controls"]))
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s; training "
          f"{train['tokens_per_s'][-1]:.0f} tokens/s at step {train['steps'] - 1}, peak "
          f"{train['peak_mem_gb']:.2f} GB; loop {loop['interrupted']}; mamba2 "
          f"{mamba['tokens_per_s']:.1f} and zamba2 {zamba['tokens_per_s']:.1f} tokens/s; "
          f"adaptive continuous {adapt['runs']['b']['tokens_per_s']:.1f} tokens/s, switches "
          f"{adapt['runs']['b']['switches']}, (a) at the card's L2 "
          f"{adapt['runs']['a']['switches']}; int8 continuous "
          f"{int8_cont['tokens_per_s']:.1f} and static {int8_static['tokens_per_s']:.1f} "
          f"tokens/s (bf16 {main_path['tokens_per_s']:.1f}, {static['tokens_per_s']:.1f}); "
          f"optimistic {optimistic['preemptions']} preemptions, "
          f"{optimistic['tokens_per_s'][0]:.1f} tokens/s; tiered {tiered['bf16']['spills']} "
          f"spills, {tiered['bf16']['tokens_per_s']:.1f} tokens/s (int8 "
          f"{tiered['int8']['tokens_per_s']:.1f}); speculative n-gram "
          f"{spec['ngram']['tokens_per_s'][0]:.1f} and self-drafting "
          f"{spec['model']['tokens_per_s'][0]:.1f} tokens/s, acceptance "
          f"{spec['ngram']['acceptance_rate']:.3f} and {spec['model']['acceptance_rate']:.3f}; "
          f"training mamba2 "
          f"{train_mamba['tokens_per_s'][-1]:.0f} and zamba2 {train_zamba['tokens_per_s'][-1]:.0f} "
          f"tokens/s, peak {train_mamba['peak_mem_gb']:.2f} and "
          f"{train_zamba['peak_mem_gb']:.2f} GB; "
          f"olmoe-1b-7b continuous {moe_cont['tokens_per_s']:.1f} and static "
          f"{moe_static['tokens_per_s']:.1f} tokens/s, peak {moe_cont['peak_mem_gb']:.2f} GB; "
          f"seamless-m4t-medium static {encdec['tokens_per_s']:.1f} tokens/s, peak "
          f"{encdec['peak_mem_gb']:.2f} GB, training {train_encdec['tokens_per_s'][-1]:.0f} "
          f"tokens/s, peak {train_encdec['peak_mem_gb']:.2f} GB; phi-3-vision-4.2b static "
          f"{vlm['tokens_per_s']:.1f} tokens/s, peak {vlm['peak_mem_gb']:.2f} GB, training "
          f"{train_vlm['tokens_per_s'][-1]:.0f} tokens/s, peak {train_vlm['peak_mem_gb']:.2f} GB; "
          f"olmoe-1b-7b training {train_olmoe['tokens_per_s'][-1]:.0f} tokens/s, peak "
          f"{train_olmoe['peak_mem_gb']:.2f} GB; sharded (1x1 "
          f"{sharded_serve['backend']}) serving {sharded_serve['tokens_per_s']:.1f} tokens/s, "
          f"training step {sharded_train['runs']['sharded']['records'][-1]['step_s']:.3f} s "
          f"against {sharded_train['runs']['unsharded']['records'][-1]['step_s']:.3f} s, both "
          f"equal to the unsharded runs to the bit")
    print(f"[done] dry-run: {len(dryrun['cells'])} cells ok in {dryrun['seconds']:.1f} s, "
          f"extrapolation equal to full depth; fake 1x1 argument bytes equal to the card's: "
          f"{dryrun_vs_card['argument_equal']}, MFU {dryrun_vs_card['mfu']:.4f}; examples in "
          f"{examples['seconds']:.1f} s: train_lm {examples['train_lm']['tokens_per_s']:.0f} "
          f"tokens/s, serve_lm {examples['serve_lm']['tokens_per_s']:.1f} tokens/s")
    # The grouped product is a library call (grouped_mm), the counterpart of
    # XLA's ragged_dot: not a kernel of this repository, so not in the list
    # of kernels below.
    print(json.dumps({"library_calls": [{
        "name": "ragged_dot", "route": "torch.nn.functional.grouped_mm",
        "replaces": "jax.lax.ragged_dot in src/repro/models/moe.py:_moe_dropless (XLA, no "
                    "Pallas kernel)",
        "launches_by_path": {"olmoe_continuous": moe_cont["library"]["ragged_dot"],
                             "olmoe_static": moe_static["library"]["ragged_dot"]},
        "max_abs_err": moe_matrix["worst"], "shifted_offsets_min_err": moe_matrix["shifted_min"],
        "shapes": moe_matrix["shapes"]}]}))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(dev_info["smi"])
    print("checked kernels: " + json.dumps([k["name"] for k in kernels]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
