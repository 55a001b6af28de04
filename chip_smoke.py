#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed N]

Phases, each failing the run with a non-zero exit:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
     source, all started together);
  3. hold K1 (diff_topk_payload), K2/K3 (scatter_accumulate) and K4
     (block_scatter_accumulate) to their plain PyTorch versions, in f64
     and f32, at the shapes FedNL's path gives them on w8a; K2 and K4
     bit for bit against the plain version on CPU copies, K2 also with
     init, a weight-0 silo, at d=1,100, at the K3 shape (d=2,048,
     142 silos, k=d) and at shapes of over 2,047 regions, where its
     sort takes two passes (``adversarial.TWO_PASS_SHAPES``); then K1, K5, K6, K4 and K2 bit for bit on
     adversarial inputs (``kernels.adversarial``: zero tiles, ties,
     -0.0, inf, ragged edges, k >= block^2, ``bisect_all``; repeated
     cells within and across silos, padding, out-of-range indices,
     blocks 8, 128 and 256; K2's one cell, diagonal, all padding,
     (1, 90,000) row, mirrors outside the matrix, -0.0 init, a silo
     scaled by 0, hot cells, a row window no pair lands in); K2 and K4
     also bit for bit on the FedNL variants' traffic: Rand-K's indices
     at w8a, a FedNL-PP round's payloads with 28 of 142 silos weighted 1
     and the rest 0 (equal bit for bit to the 28 alone), and K2 into
     (1, 300) and (1, 4,096) rows; and a fednl-cohort round's
     fractionally weighted payloads (K2, K4);
  4. drive FedNL Options 1 and 2 on the w8a stand-in (n=142, m=350,
     d=300, f64) for Top-K (k=d), symmetric Top-K (k=d), Rank-R (1) and
     Block-Top-K (8), 20 rounds each, through ``FedNL.run``; assert the
     error bound and that every kernel of the path was launched; then
     hold the card to the CPU port on a1a-sized data; then the server's
     mean of 142 Top-K payloads at the K3 shape through
     ``TopK.aggregate`` (plain and symmetric: 2 launches, bit for bit);
     then K2's timings (``k2_measure``: w8a and the K3 shape, plain and
     symmetric, the K3 shape with 0 and 100 % hot cells; launches per
     call as the profiler records them) while the profiler is fresh;
  4b. FedNL variants on w8a: FedNL-PP (Top-K k=d and Block-Top-K 8, tau
     28 and 71), FedNL-CR (Top-K), FedNL-LS (Block-Top-K), FedNL-BC
     (Top-K, downlink Top-K d/2, p=0.5), FedNL with Rand-K (k=d) and with
     PowerSGD (r=1), fednl-stoch (half of each silo's points a round) and
     fednl-ppbc (Top-K), newton, n0, ns, n0-ls, DIANA and Artemis (Rand-K
     on the gradient), seed 0, 20 rounds each, through the entry points
     (``make_method``, ``run``); each ||x^20 - x*|| under its bound from
     the reference (``VARIANT_RATIO``), K1, K2 and K4 launched on the
     path; the card against the CPU port on a1a-sized data to 1e-8
     (every draw from a CPU generator, so the same draws); each run's
     median ms per round;
  4c. the engine on w8a: one ``Sweep`` of six cells (FedNL Top-K k=d,
     Block-Top-K 8 and Rand-K k=d at Option 2 over seeds 0-2 / 0-1;
     FedNL-PP Top-K at tau 28; fednl-cohort Top-K and Block-Top-K with
     K = 28 on the fl-cross-device link, deadline 0.8, beta 0.5), 20
     rounds from x0 = 0: K1, K2 and K4 must launch; every cell equals
     the serial ``run`` of its seeds bit for bit; the cohort at beta 0
     and q 1 equals the PP cell bit for bit; the cohort cells equal the
     CPU port on a1a and on w8a to 1e-8; the accounting columns and
     ``uplink_bits`` over qwen2-0.5B with 4 silos equal the reference's
     (``ENGINE_ACCOUNTING``); each last gap stays under its bound from
     the reference (``ENGINE_GAP_RATIO``); one round's Top-K and
     Block-Top-K payloads of all 142 silos through the codec and back
     (raw bit for bit, fp16 and int8 within the reference's bounds);
     then the sweep CLI in process on the card. Prints each cell's
     us_per_round and median ms per round, the sweep's wall clock
     against the bare serial runs' and the codec's host ms;
  4d. multi-device aggregation on w8a: ``run_fednl_sharded`` over a
     one-rank NCCL group (``launch.mesh.make_host_mesh``; NCCL refuses
     two ranks on one card, so W > 1 with real collectives is held by the
     CPU tests on gloo groups) for Top-K k=d Options 1 and 2 and
     Block-Top-K 8 Option 2, 20 rounds, each equal to the unsharded
     ``FedNL.run`` bit for bit (K1, K2 and K4 must launch), ms per round
     of both in turns, one identity reduction's ms; then the sharded
     server sum window by window
     (``windowed_scatter_accumulate``) at W = 2 and 4 on w8a's Top-K
     payloads and the K3 shape's, plain and symmetric, each equal to the
     unsharded K2 sum bit for bit, timed beside it;
  5. drive the curvature-learning optimizer ``fednl_precond`` (k=2048 per
     128 x 128 tile) over all 14 tensors of qwen2-0.5B (494,032,768
     parameters, bf16, random from --seed) with 4 silos of Fisher
     observations: 3 ``update`` steps, one ``refresh``, one
     ``precondition``, then each silo's uplink payload of every tensor
     through the optimizer's codec (``compressor.compress``). At step 0
     H = 0, so K1(obs, 0) must equal K5(obs) bit for bit on every tile
     (a check outside the counted runs). K1 and K4 must have launched in
     the optimizer's calls and K5 in the codec's; H, l and the updates
     must be finite; the card must equal the CPU port on the small
     tensors; K1, K4 and the codec's K5 payloads are then held to their
     plain versions on every tensor's inputs; a refresh is profiled (K1's
     and K4's device ms beside their bounds), and K1 and K4 are timed
     over a whole refresh beside ``torch.topk`` and ``index_put_``;
  6. PowerSGD and dense block top-k: ``powersgd_rank_r`` (K8, r = 1, 2)
     and ``block_topk`` (K6) on a w8a Hessian (300 x 300 f64) and on
     ``layers.ffn.wg[0]`` (896 x 4864), against their plain versions; K8's
     small-N route (M @ Q, M^T @ P) and small-K route (P @ Q^T) must both
     have launched;
  7. FedNL lines 5-6 by ``hess_update`` (K7) on the w8a FedNL state
     (142 Hessians), held to what ``FedNL.step`` computes and to its
     plain version, and on the embed-sized H of phase 5;
  8. time a FedNL round per compressor, the optimizer's refresh and
     precondition, and K1-K8 beside their bounds, their plain versions
     and the nearest single PyTorch call (K2's from phase 4: w8a plain
     and symmetric, and the K3 shape as its own entry,
     ``scatter_accumulate_tiled``);
  9. qwen2-0.5B serving at full width and depth (bf16, random weights
     from --seed): K9 (flash_attention) against its plain version on all
     14 heads at T=4,000 in bf16 (the wgmma route, held to the f32 oracle
     beside SDPA: ``bf16_attention_check``) and f32 (the FFMA route, to
     2e-5) and on heads 0 and 13 of layer 0's inputs at T=32,768;
     ``make_prefill`` at B=1, T=32,768 (K9's wgmma route must launch once
     per layer, 24, and its FFMA route never, by the launch counters and
     by the profile), its host ms, peak memory and device time by kernel
     group; K9's times as for K1-K8; decode == forward
     at B=2, T=640 (the K9 branch) within a stated bf16 tolerance;
     ``generate`` for batch 4, prompt 64, 32 greedy tokens, held to the
     forward's argmax, and timed by the serving CLI in its own process;
  9b. (its profiled part runs before phase 9 and its decode loops after
     it, so that every profile comes before every decode loop: a
     profiler session records few launches, or none, after a million of
     them) starcoder2-3b serving at full width and depth (bf16,
     random weights from --seed; head dim 128, sliding window 4,096): K9
     with its window against the windowed plain version on all 24 heads
     at T=4,000 with a window of 300 (one that starts mid-tile) in bf16
     and f32, and on heads 0 and 23 of layer 0's inputs at T=32,768 with
     the real window in bf16 and f32; ``make_prefill`` at B=1, T=32,768
     (K9's wgmma route once per layer, 30, with the window; never the
     FFMA route), its ms, peak memory and device time by kernel group;
     K9's windowed times beside its bound, the plain version, SDPA with
     a window mask and the same call without the window; greedy
     ``generate`` (batch 2, prompt 16, 8 tokens) held to the forward's
     argmax; decode == forward at B=2, T=640 on the reduced config
     (window 16, the K9 branch) in f32 (FFMA, 2e-3) and bf16 (wgmma);
  9c. (split around phase 9 as 9b) minicpm3-4b serving at full width and depth
     (bf16, random weights; MLA, which takes no K9): layer 0's chunked
     MLA path against ``_mla_attend`` under the whole causal mask at
     T=4,096 (bf16 within 4 bf16 steps, f32 to 1e-4 of the largest
     output); ``make_prefill`` at B=1, T=4,096 through the chunked path
     (no K9 launch), its ms, peak memory and device time by group;
     decode == forward at B=2, T=64; greedy ``generate`` as in 9b;
  9d-9g. (their profiled parts run before phase 9b, their decode loops
     after phase 9's) the MoE, encoder-decoder and VLM families at full
     width (bf16, random weights from --seed), each with K9 against its
     plain version at the model's head counts (every head at T=4,000 in
     bf16 and f32, the first and last head of layer 0's prefill inputs in
     bf16), ``make_prefill`` at B=1 through one wgmma launch of K9 a
     decoder layer (counters and profile), its ms, peak memory and device
     time by kernel group, and K9's device ms on layer 0 beside its bound
     and SDPA: 9d granite-moe-1b-a400m (1.33 B parameters; T=32,768, n_rep
     2, hd 64) with layer 0's ``moe_forward`` in bf16 against f32 on the
     same tensors (equal routes) and the card's f32 against the CPU
     port's, and the device time by part (router, dispatch and combine,
     experts, attention) from layer 0 at the prefill's shape; 9e
     grok-1-314b cut to 8 of 64 layers (56.2 GB; T=4,096, n_rep 6, hd
     128) likewise; 9f whisper-tiny whole (4 + 4 layers; 1,500 frames,
     decoder T=32,768, n_rep 1) with the encoder and the cross-attention
     in bf16 against f32; 9g llava-next-34b with all 60 layers (68.8 GB,
     drawn layer by layer into the stacked weights; T=4,096 = 2,880
     patches and 1,216 tokens, n_rep 7). After phase 9: greedy
     ``generate`` of granite and whisper (batch 2) and llava (batch 1,
     text alone, its weights drawn again), each held to the serve step
     teacher-forced on its tokens; the card's granite decode in f32
     against the CPU port's at the published capacity; decode == forward
     for reduced granite with capacity_factor = E / top_k (nothing
     dropped; f32, T=640, FFMA) and for whisper with the encoder's memory
     in its cache (bf16, T=640, wgmma);
  9h. (profiled after 9g, decode after phase 9's) jamba-1.5-large-398b,
     one 8-layer period of 72 at full width (bf16, random weights from
     --seed; 7 Mamba layers and an attention layer, MoE on the odd
     positions; the four MoE layers read one drawn set of experts, 32.3
     GB stored where a whole period holds 90.2), the tree's shapes held
     to ``param_shapes`` of the 8-layer config: K9 at n_rep 8 (64/8
     heads, hd 128, no RoPE) against its plain version on every head at
     T=4,000 and on heads 0 and 63 of the attention layer's prefill
     inputs; layer 0's Mamba mixer in bf16 against f32; ``make_prefill``
     at B=1, T=4,096 through one wgmma launch of K9, its ms, peak memory,
     idle share and device time by kernel group, the CUDA-event spans of
     the Mamba scan, the MoE routing and K9 within one prefill, and a
     period's parts (Mamba mixer and scan, attention, MLP, MoE) by CUDA
     events; after phase 9, ``generate`` at batch 1 against the
     teacher-forced serve step;
  9i. (profiled after phase 9, the rest after every decode loop)
     xlstm-350m whole (241.6 M parameters, no feed-forward): the mLSTM
     (layer 0) and sLSTM (layer 7) mixers in bf16 against f32 at
     T=4,096; ``make_prefill`` at B=1, T=4,096, profiled, then at
     T=32,768 by the host clock and CUDA events (about 2 M launches, the
     sLSTM a step at a time); ``generate`` at batch 4 against the
     teacher-forced serve step; no K9 launch on any of its paths. For both, the
     reduced model in f32: the card against the CPU port over a T=640
     prefill and 20 decode steps (1e-4 of the largest logit), decode ==
     forward at T=640 (jamba with capacity_factor = E / top_k: nothing
     dropped; its attention layer through K9's FFMA route), greedy
     ``generate`` against the teacher-forced serve step;
  10. the loss's gradient above 512 tokens (the forward's
     ``_sdpa_chunked`` branch under autograd): reduced qwen2 in f32 at
     B=2, T=600, card against the CPU port on the same weights (1e-4 of
     each leaf's largest |grad|), no K9 launch; the full qwen2-0.5B in
     bf16 at B=1, T=4,096: ms, peak memory, finite nonzero gradients;
  11. (run right after 4d, before the first profiler session) the
     train step at full width: qwen2-0.5B (bf16, remat, random
     weights from --seed), ``make_optimizer("fednl", k_per_block=2048)``,
     ``make_train_step`` with 4 microbatches, 4 silos and a refresh
     every 2 steps on ``TokenPipeline`` batches of 4 x 4,096 tokens, 3
     steps: refresh flags [1, 0, 1], H bit for bit unchanged on step 1,
     finite loss and H, K1 and K4 launched on the refresh steps only, no
     K9; ms per step, of each refresh and precondition, peak memory; an
     AdamW step at the same shape; one Hutchinson step (T=512, 2 silos)
     and one silo's probe draw; a reduced model's 3 fednl steps on the
     card against the CPU port (1e-4 of each leaf's largest |value|);
  11b. (right after 11) the MoE train step at full width: granite-moe-
     1b-a400m as phase 11 (fednl k=2,048, 4 microbatches, 4 silos, 4 x
     4,096 tokens, a refresh every 2 steps, 3 steps): K1 once per tensor
     on the refresh steps (the 4-D expert leaves and the f32 router among
     them), K4 launched, no K9, the loss the cross-entropy plus 0.01 x the
     aux loss; the reduced model's gradient at B=2, T=600 in f32 on the
     card against the CPU port (1e-4 of each leaf's largest |grad|);
  11c. (right after 11b) the hybrid and ssm families trained:
     xlstm-350m as phase 11 (fednl k=2,048, 4 microbatches, 4 silos,
     a refresh every 2 steps, 3 steps), train_4k's batch cut to 4 and its
     T to 512 (the sLSTM's step loop is host-bound), its depth to one
     period of 8 layers (all 57 tensors): K1 once per tensor and
     K4 on the refresh steps, no K9, every mLSTM and sLSTM leaf with a
     nonzero curvature, ms per step, peak memory, K1 and K4 on the last
     refresh's mLSTM and sLSTM leaves against their plain versions;
     reduced jamba's 3 fednl steps on the card against the CPU port (1e-4
     of each leaf's largest |value|, K1 and K4 launched); one full-width
     jamba Mamba mixer (bf16, B=1, T=4,096) forward and backward through
     the scan's checkpointed chunks, its ms and peak memory, its input
     gradient within 8 bf16 steps of f32's largest entry;
  12. the roofline (``launch/roofline.py``'s H100 terms, the FLOPs and
     bytes of ``launch/dryrun.py``'s count on the meta device, made in a
     background process from the build on) of each measured train step
     (phases 11, 11b, 11c) beside its ms: a step under its compute or
     memory term fails;
  13. the autotuner (every earlier phase ran on an empty tuning cache)
     and the launch budgets: every kernel function of every source at
     every argument its paths and the tuner's candidates give it, priced
     by ``kernels/resources.launch_resources`` equal to the card's launch
     query (``cudaFuncGetAttributes`` and the launcher's dynamic shared
     bytes) and within 232,448 shared bytes and 65,536 registers a block,
     registers and shared bytes printed; K2 at w8a and at the K3 shape,
     K7 on the w8a Hessian stack, K8's small_n route on wg[0] @ Q and K9
     at qwen2's (32,768 x 14 / 2 x 64) and jamba's (4,096 x 64 / 8 x 128)
     bf16 prefill shapes tuned, each candidate's us, the winner, the
     default's and the winner's ms; each op then called with no config
     launches the winner (its resolver, its launch counter) and equals
     its plain version (K2/K3 and K7's H bit for bit, K8 to 1e-5, K9 by
     ``bf16_attention_check``); the cache saved and reloaded through
     ``REPRO_TORCH_TUNING_CACHE`` resolves the same;
  14. the examples: ``examples/torch_quickstart.py``,
     ``torch_fednl_federated_logreg.py``, ``torch_heterogeneity.py`` and
     ``torch_serve_batched.py`` with their defaults on the card, each in
     a process of its own (exit 0; the quickstart's last f(x) below its
     first, the Rank-1 gap after 20 rounds within 1e-12, the worst
     heterogeneity gap within 1e-6, two requests served; host seconds);
     then ``torch_train_lm.py --full --optimizer fednl --steps 6
     --refresh-every 2`` in this process (qwen2-0.5B at its published
     width, batch 8, seq 128): finite losses, the loss line, K1 and K4
     once per parameter tensor on each refresh step and never on the
     others (path ``examples_train_lm`` in the kernel line), ms a step
     with and without a refresh;
  15. the train driver on a mesh: ``launch.train.train`` with phase 14's
     arguments on the one-rank NCCL mesh of ``make_host_mesh`` (params and
     fednl state as DTensors laid out by the sharding rules, the hooks
     installed while it trains): losses and the sha256 of the final params
     equal phase 14's and the step's without a mesh bit for bit, K1 and
     K4 once per tensor on each refresh step (path ``mesh_train_qwen2``),
     ms a step, peak memory; then a refresh of the final H from 4 silos
     with the ranks played in turn (4 per-rank K1 calls, the payloads
     stacked in silo order, K4) equal to the one-call refresh bit for bit
     on all 14 tensors;
  16. the mesh's "model" axis: starcoder2-15b at its published width, 2
     of 40 layers, 4 model ranks played by threads on the card
     (``played_model_axis``): in bf16 and f32, each rank's prefill of a
     4,096-token prompt on its shards through the tensor-parallel layers
     (K9 on its 12 q heads over 1 KV head with the window: 8 launches a
     dtype, path ``model_axis_starcoder2_15b``), the ranks' logits
     against the unsplit model's (f32 within 1e-4 of the largest, bf16
     within 8 bf16 steps), the greedy token through the vocab-parallel
     argmax, the vocab-parallel loss (f32); K9 at n_rep 12 against its
     plain version with its time, bound, plain and SDPA time (the kernel
     line's ``n_rep12_window``); a refresh played on the model shards
     (each rank's K1 on its tiles, then K4) equal to the one-call refresh
     bit for bit on every tensor split on tile bounds; 16b-16d the same
     for the MoE family (granite, grok-1), MLA (minicpm3-4b) and the
     hybrid family (jamba);
  16e. xlstm-350m over 4 played ranks whole in f32 (a head a rank), one
     period in bf16, each layer teacher-forced, one period in f32 over 4
     and 16 ranks with decode == forward over the laid-out caches
     (the mLSTM's n and m equal on every rank), the refresh played on
     one period's shards (path ``model_axis_ssm``: K1, K4);
  16f. whisper-tiny over 2 and 4 played ranks and llava-next-34b's first
     2 layers over 4, bf16 and f32 (K9 on each rank's heads: path
     ``model_axis_encdec_vlm``), K9 alone at a rank's heads and the
     decoder's length (llava 14 over 2 at 4,096, whisper 3 over 3 at
     640), the refresh played on their shards;
  16g. Hutchinson curvature over the "model" axis, the double backward
     on each rank: 4 rank processes spawned on the card, joined by a gloo
     group whose collectives copy through the host (``host_model_axis``);
     qwen2-0.5B at its published width cut to 4 of 24 layers, f32, 2 x
     128 tokens, over all 4 (every head on every rank: 14 and 2 do not
     divide 4) and over 2 of them (7 heads a rank): each rank's probe its
     block of one process's z bit for bit, its Hz within 1e-4 of each
     leaf's largest |Hz| of one process on the card, the refresh from its
     observations z * Hz (K1 and K4 on its shards: path
     ``model_axis_hvp``, one of each a rank and tensor) equal to the
     one-call refresh of every rank's observations bit for bit; then the
     MoE, MLA, hybrid, ssm, encoder-decoder and VLM families' reduced
     configs over 2 processes, Hz against one process (the MoE up to a
     first router flip, which must be a near tie; xLSTM within 4 times
     its own spread under a rounding of its weights where that is wider);
  then print what the profiler failed to record (each such figure timed
  by CUDA events instead, or not measured), the kernel line (with each
  wrapper's registers and shared bytes, ``launch``, and its tuned cases,
  ``tuned``), the card line, and last the device line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROUNDS = 20
MU = 1e-3
# ||x^20 - x*|| of the JAX reference on its own w8a draws (x0 = 0,
# ||x0 - x*|| = 2.6326945144070444), f64 on the CPU, from
# scripts/reference_w8a_fednl.py. The port runs on other draws of the
# same shapes, so its bound is twice the reference's error scaled by the
# port's own ||x0 - x*||, and never below 1e-9 (Option 1 reaches the
# f64 round-off floor, where the reference reads 1e-15 to 1e-10).
REFERENCE_ERR0 = 2.6326945144070444
REFERENCE_ERR = {
    ("topk", 1): 6.732863620692267e-14, ("topk", 2): 0.11513699893708386,
    ("topk-sym", 1): 1.6870138221894845e-15,
    ("topk-sym", 2): 0.1073136652229507,
    ("rankr", 1): 1.4924566654577763e-12, ("rankr", 2): 0.032669316075475484,
    ("blocktopk", 1): 6.500296250558938e-11,
    ("blocktopk", 2): 0.12608646649884878,
}
LEVELS = {"topk": 300, "topk-sym": 300, "rankr": 1, "blocktopk": 8}
# the optimizer phase: qwen2-0.5B, 4 silos, Block-Top-K 2048 of 128^2
SILOS, K_PER_BLOCK, BLOCK, STEPS = 4, 2048, 128, 3
# the serving phase: qwen2-0.5B prefill at prefill_32k's sequence, one
# sequence on one card; decode == forward at a length that takes K9
PREFILL_T, CHECK_T, DECODE_B, DECODE_T = 32768, 4000, 2, 640
GEN_B, GEN_PROMPT, GEN_N = 4, 64, 32
# greedy generate at full width in phases 9b and 9c
SMALL_GEN_B, SMALL_GEN_PROMPT, SMALL_GEN_N = 2, 16, 8
# bf16 logits of decode and forward round at other places (decode's
# scores and softmax weights are bf16, K9 keeps them in f32; the GEMMs
# take other shapes): they must agree within 8 bf16 steps of the largest
# logit, and their argmax at 80 % of the positions
DECODE_TOL, ARGMAX_AGREE = 8 * 2.0 ** -7, 0.8
# MLA's chunked path and the whole mask in bf16: the same sums in other
# GEMM shapes, within 4 bf16 steps of the largest output
BF16_CHUNK_STEPS = 4


class SmokeFailure(Exception):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def time_cuda(fn, reps: int = 50, warmup: int = 3) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> tuple[float, object]:
    """Host clock around one call that ends in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def device_ms(fn, kernel: str, reps: int = 20, tries: int = 6) -> float:
    """Device time (ms) per call of ``fn`` in the CUDA kernels whose
    names contain ``kernel``, one launch a call, from the profiler
    (``time_cuda`` also counts the host's launch overhead wherever that
    exceeds the kernel's run). Late in a long run (after a million
    launches, tools/decode_profile.py) a session may record only some of
    the launches, or none: the time is averaged over the launches
    recorded, and the tries go on until one session (``profiled``)
    records them all. Where no try names such a kernel (a session can
    record no device event at all, even early in the run), the calls are
    timed by CUDA events instead (``time_cuda``: one launch a call, so
    the kernel's run plus any gap between launches), and the miss is
    printed and kept in ``PROFILER_MISSES``."""
    fn()
    per_launch, rows = None, []
    for _ in range(tries):
        _, rows = profiled(fn, reps)
        seen = [e for e in rows if kernel in e.key]
        count = sum(e.count for e in seen)
        if count:
            per_launch = sum(e.self_device_time_total for e in seen) / 1e3 / count
            if count >= reps:
                break
    if per_launch is not None:
        return per_launch
    ms = time_cuda(fn, reps=reps, warmup=1)
    profiler_miss(f"no session of {tries} recorded a kernel named like "
                  f"{kernel!r} (device rows of the last: "
                  f"{[e.key[:80] for e in rows]}); CUDA events instead: "
                  f"{ms} ms a call")
    return ms


# what the profiler failed to record, and what was measured instead
PROFILER_MISSES: list[str] = []


def profiler_miss(note: str) -> None:
    PROFILER_MISSES.append(note)
    print(f"# profiler miss: {note}", flush=True)


def profiled(fn, reps: int = 1, cuda_only: bool = False) -> tuple[float, list]:
    """``reps`` calls of ``fn`` under the profiler after a warm-up step of
    as many, which the profiler discards (it can miss the launches at its
    start): the wall ms of the active step and its device events (the
    step's own annotation, which spans the step, left out). With
    ``cuda_only`` the profiler records the device's activity alone: a
    step of 270 k launches (xlstm's prefill) then takes about a minute to
    parse instead of three."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    events, wall = [], 0.0
    activities = [ProfilerActivity.CUDA]
    if not cuda_only:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda prof: events.extend(
                     e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith("ProfilerStep"))
                 ) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            prof.step()
    return wall, events


def device_per_call(fn, names, reps: int = 10, tries: int = 6) -> dict:
    """Device ms and launches per call of ``fn`` in the CUDA kernels whose
    names contain each of ``names`` (a name matches every template
    instance), as the profiler records them over ``reps`` calls
    (``profiled``). Sessions run until two record the same launches of
    every kernel, each a whole number per call ("complete"); else the
    session that recorded the most launches is reported as it is. Per
    kernel: its recorded device ms over ``reps`` and its recorded
    launches over ``reps``. Fails when a kernel is never seen."""
    best, seen_before = None, []
    for _ in range(tries):
        _, events = profiled(fn, reps)
        ms = {name: 0.0 for name in names}
        seen = {name: 0 for name in names}
        for e in events:
            for name in names:
                if name in e.key:
                    ms[name] += e.self_device_time_total / 1e3
                    seen[name] += e.count
        if not all(seen.values()):
            continue
        row = {"device_ms": {name: ms[name] / reps for name in names},
               "launches": {name: seen[name] // reps if seen[name] % reps == 0
                            else seen[name] / reps for name in names},
               "complete": False}
        if best is None or sum(seen.values()) > sum(
                best["launches"].values()) * reps:
            best = row
        if seen in seen_before and all(c % reps == 0 for c in seen.values()):
            return {**row, "complete": True}
        seen_before.append(seen)
    if best is None:
        raise SmokeFailure(f"the profiler missed one of {list(names)} in "
                           f"every one of {tries} tries")
    return best


def counts(K) -> dict:
    """The launch counts of every wrapper, and of each route of K8 and K9
    as "<wrapper>:<route>"."""
    return {**K.LAUNCHES, **{f"{name}:{route}": n
                             for name, routes in K.ROUTES.items()
                             for route, n in routes.items()}}


def profile_rows(fn, cuda_only: bool = False) -> tuple[float, list]:
    """One call under the profiler (``profiled``): its wall ms and the
    device rows (kernel name, device ms, launches), largest first."""
    wall, events = profiled(fn, cuda_only=cuda_only)
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events]
    return wall, sorted((o for o in ops if o[1] > 0), key=lambda o: -o[1])


def profile_window(fn) -> dict:
    """One call under the profiler: wall ms, device busy ms, idle share
    and the top device rows."""
    wall, ops = profile_rows(fn)
    busy = sum(ms for _, ms, _ in ops)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top_device_ms": [[name[:60], ms] for name, ms, _ in ops[:6]]}


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over HBM rate vs operations
    over the peak rate of their type, the H100 SXM peaks of
    ``launch/roofline.py``."""
    from repro_torch.launch import roofline

    t_bytes = nbytes / roofline.HBM_BW
    t_ops = sum(n / roofline.PEAK_FLOPS_BY_DTYPE[t] for t, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_rel(got, want) -> float:
    """max |got - want| / max |want|."""
    import torch

    scale = float(torch.max(torch.abs(want)))
    return float(torch.max(torch.abs(got - want))) / max(scale, 1e-300)


# -- phase 3: K1, K2/K3, K4 against their plain versions at w8a shapes --------


def check_fednl_kernels(dev, err: dict) -> None:
    import torch
    from repro_torch.kernels.adversarial import TWO_PASS_SHAPES, two_pass_pairs
    from repro_torch.kernels.block_topk import diff_topk_payload, diff_topk_payload_ref
    from repro_torch.kernels.scatter_accum import (
        block_scatter_accumulate,
        block_scatter_accumulate_ref,
        scatter_accumulate,
        scatter_accumulate_ref,
    )
    from repro_torch.kernels.scatter_accum import plan as scatter_plan

    gen = torch.Generator(device=dev).manual_seed(0)

    def sym(n, d, dtype):
        m = torch.randn((n, d, d), generator=gen, device=dev, dtype=dtype)
        return 0.5 * (m + m.transpose(1, 2))

    for dtype in (torch.float64, torch.float32):
        a, b = sym(142, 300, dtype), sym(142, 300, dtype)
        a[:, :6, :6] = 9.0 * torch.sign(a[:, :6, :6])   # planted tie cluster
        b[:, :6, :6] = 0.0
        for k, block in ((8, 128), (128 * 128, 128), (40, 16)):
            got = diff_topk_payload(a, b, k=k, block=block)
            want = diff_topk_payload_ref(a, b, k=k, block=block)
            require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                    f"diff_topk_payload payload differs ({dtype}, k={k})")
            rel = float(torch.max(torch.abs(got[2] - want[2]) / want[2]))
            require(rel <= (1e-12 if dtype == torch.float64 else 1e-5),
                    f"diff_topk_payload ||D||^2 off by {rel:.2e} rel")
            if dtype == torch.float64:
                e = float(torch.max(torch.abs(got[2] - want[2])))
                err["diff_topk_payload"] = max(err["diff_topk_payload"], e)
        # one b shared by every silo (stride 0) equals the stacked copy
        got = diff_topk_payload(a, b[0], k=8)
        want = diff_topk_payload(a, b[0].expand_as(a).contiguous(), k=8)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(got[2], want[2]),
                f"diff_topk_payload with a shared b differs ({dtype})")

        def pairs(n, k, d, symmetric):
            idx = torch.randint(0, d * d, (n, k), generator=gen, device=dev)
            # every silo picks some of 64 hot cells (Top-K's pattern)
            hot = torch.randint(0, d * d, (64,), generator=gen, device=dev)
            idx[:, ::4] = hot[torch.randint(0, 64, (n, (k + 3) // 4),
                                            generator=gen, device=dev)]
            if symmetric:
                r, c = idx // d, idx % d
                idx = torch.maximum(r, c) * d + torch.minimum(r, c)
            idx[:, 5] = idx[:, 2]                          # duplicates
            idx[:, -7:] = -1                               # padding
            vals = torch.randn((n, k), generator=gen, device=dev, dtype=dtype)
            return vals, idx.to(torch.int32).contiguous()

        def same(what, vals, idx, d, symmetric=False, init=None):
            """K2 on the card against its plain version on CPU copies,
            bit for bit (both add each cell's pairs in stream order; on
            the card the plain version's index_add_ would use atomics).
            ``d``: the side of a square, or a shape. Records the f64
            max |got - want| (K3's at d >= 1,025)."""
            shape = (d, d) if isinstance(d, int) else d
            got = scatter_accumulate(vals, idx, shape, symmetric=symmetric,
                                     init=init).cpu()
            want = scatter_accumulate_ref(
                vals.cpu(), idx.cpu(), shape, symmetric=symmetric,
                init=None if init is None else init.cpu())
            e = float(torch.max(torch.abs(got - want))) if got.numel() else 0.0
            if dtype == torch.float64:
                key = ("scatter_accumulate_tiled" if min(shape) >= 1025
                       else "scatter_accumulate")
                err[key] = max(err[key], e)
            bits = torch.int64 if dtype == torch.float64 else torch.int32
            require(torch.equal(got.view(bits), want.view(bits)),
                    f"scatter_accumulate differs from its plain version "
                    f"({what}, {dtype}, max err {e:.2e})")
            return got

        for symmetric in (False, True):
            vals, idx = pairs(142, 300, 300, symmetric)
            same(f"w8a, symmetric {symmetric}", vals, idx, 300, symmetric)
            # a weight-0 silo changes nothing, bit for bit
            w = torch.ones(142, dtype=dtype, device=dev)
            w[17] = 0.0
            dropped = idx.clone()
            dropped[17] = -1
            x0 = same("w8a, a weight-0 silo", vals * w[:, None], idx, 300,
                      symmetric)
            x1 = same("w8a, a silo dropped", vals, dropped, 300, symmetric)
            require(torch.equal(x0, x1),
                    "scatter_accumulate: a weight-0 silo changed the sum")
            init = torch.randn((300, 300), generator=gen, device=dev,
                               dtype=dtype)
            same(f"w8a with init, symmetric {symmetric}", vals, idx, 300,
                 symmetric, init)
        # the FedNL variants' traffic: Rand-K's indices (each silo a
        # uniform permutation's prefix, in random order) at w8a; a
        # FedNL-PP round's payloads, 28 of 142 silos weighted 1 and the
        # rest 0, which must sum bit for bit as the 28 alone; vector
        # payloads (DIANA, Artemis) into a (1, 300) and a (1, 4,096) row
        host = torch.Generator().manual_seed(5)
        bits = torch.int64 if dtype == torch.float64 else torch.int32

        def randk(n, k, size):
            return torch.stack([torch.randperm(size, generator=host)[:k]
                                for _ in range(n)]).to(
                device=dev, dtype=torch.int32).contiguous()

        rvals = torch.randn((142, 300), generator=gen, device=dev, dtype=dtype)
        same("w8a Rand-K", rvals, randk(142, 300, 300 * 300), 300)
        active = torch.zeros(142, dtype=torch.bool)
        active[torch.randperm(142, generator=host)[:28]] = True
        active = active.to(dev)
        weight = active.to(dtype)
        vals, idx = pairs(142, 300, 300, False)
        x0 = same("w8a, a FedNL-PP round's weights",
                  (vals * weight[:, None]).contiguous(), idx, 300)
        x1 = same("w8a, a FedNL-PP round's active silos", vals,
                  torch.where(active[:, None], idx, -1).contiguous(), 300)
        require(torch.equal(x0.view(bits), x1.view(bits)),
                "scatter_accumulate: FedNL-PP's weight-0 silos changed the "
                "sum")
        for width, k in ((300, 30), (4096, 410)):
            vvals = torch.randn((142, k), generator=gen, device=dev,
                                dtype=dtype)
            same(f"a (1, {width}) row", vvals, randk(142, k, width),
                 (1, width))
        # d = 1,100 and the K3 shape: the TPU's output-tiled regime (d >=
        # 1,025 in f64), at Top-K k = d over 142 silos for d = 2,048
        for n, k, d in ((16, 4096, 1100), (142, 2048, 2048)):
            vals, idx = pairs(n, k, d, False)
            same(f"d={d}", vals, idx, d)
        # over 2,047 regions: the sort takes two passes and each sum warp
        # searches for its bucket
        for shape in TWO_PASS_SHAPES[dtype]:
            for symmetric in (False, True):
                args = two_pass_pairs(shape, symmetric, dtype, seed=27,
                                      device=dev)
                require(scatter_plan(*args["values"].shape, *shape, symmetric,
                                     args["values"].element_size()).passes == 2,
                        f"scatter_accumulate's plan sorts {shape} in one pass")
                same(f"{shape}, two sort passes, symmetric {symmetric}",
                     args["values"], args["indices"], shape, symmetric,
                     args["init"])
        del vals, idx, dropped, init, x0, x1, args, rvals, vvals

        bi = torch.randint(0, 128 * 128, (142, 9, 8), generator=gen, device=dev)
        bi[:, :, 3] = bi[:, :, 1]
        bi[:, :, -1] = -1
        bi = bi.to(torch.int32).contiguous()
        bv = torch.randn((142, 9, 8), generator=gen, device=dev, dtype=dtype)
        got = block_scatter_accumulate(bv, bi, (3, 3), 128)
        want = block_scatter_accumulate_ref(bv.cpu(), bi.cpu(), (3, 3), 128)
        e = float(torch.max(torch.abs(got.cpu() - want)))
        require(torch.equal(got.cpu(), want),
                f"block_scatter_accumulate off by {e:.2e} ({dtype})")
        if dtype == torch.float64:
            err["block_scatter_accumulate"] = max(
                err["block_scatter_accumulate"], e)
        # a FedNL-PP round's block payloads: weight 0 changes nothing
        bw = (bv * weight[:, None, None]).contiguous()
        got = block_scatter_accumulate(bw, bi, (3, 3), 128).cpu()
        want = block_scatter_accumulate_ref(bw.cpu(), bi.cpu(), (3, 3), 128)
        kept = block_scatter_accumulate(
            bv, torch.where(active[:, None, None], bi, -1).contiguous(),
            (3, 3), 128).cpu()
        require(torch.equal(got.view(bits), want.view(bits))
                and torch.equal(got.view(bits), kept.view(bits)),
                f"block_scatter_accumulate: FedNL-PP's weight-0 silos "
                f"changed the sum ({dtype})")
        # a fednl-cohort round's fractional weights (on time 1, stragglers
        # (1 + s)^(-1/2), the unsampled 0) on Top-K and Block-Top-K pairs
        w = cohort_round_weights(142, 300, dtype, dev, seed=11)
        require(bool(((w > 0) & (w < 1)).any()),
                "the cohort round has no fractionally weighted silo")
        vals, idx = pairs(142, 300, 300, False)
        same("w8a, a cohort round's weights",
             (vals * w[:, None]).contiguous(), idx, 300)
        bw = (bv * w[:, None, None]).contiguous()
        got = block_scatter_accumulate(bw, bi, (3, 3), 128).cpu()
        want = block_scatter_accumulate_ref(bw.cpu(), bi.cpu(), (3, 3), 128)
        require(torch.equal(got.view(bits), want.view(bits)),
                f"block_scatter_accumulate differs on a cohort round's "
                f"weights ({dtype})")
    check_adversarial(dev)
    torch.cuda.synchronize()


def cohort_round_weights(n: int, d: int, dtype, dev, seed: int):
    """(n,) weights of a ``fednl-cohort`` round (K = 28, the fl-cross-
    device deadline at 0.8, beta = 0.5) from the port's own
    ``round_weights``, with each silo last landed at a random round
    before round 9."""
    import torch
    from repro_torch.core import CohortFedNLPP, CohortSpec, TopK
    from repro_torch.core.cohort import CohortFedNLPPState
    from repro_torch.engine.method import RoundDraws

    co = CohortFedNLPP(None, None, TopK(d), CohortSpec(cohort=28))
    last = torch.randint(0, 9, (n,), generator=torch.Generator().manual_seed(
        seed), dtype=torch.int32)
    state = CohortFedNLPPState(
        w=torch.zeros(n, d, dtype=dtype, device=dev), h_local=None,
        l_local=None, g_local=None, h_global=None, l_global=None,
        g_global=None, x=torch.zeros(d, dtype=dtype, device=dev), step=9,
        draws=None, last_round=last.to(dev))
    return co.round_weights(state, RoundDraws(seed, dev).active(n, 28))


# K1, K5, K6 on (block, k, rows, cols): the path's block and k on a ragged
# grid; k = 8000, where v falls in a digit crowded by ties or zeros (the
# select's path over every entry); k >= block^2; block 8 on rows of 301
# (no 16-byte loads); block 12
ADVERSARIAL_TOPK = [(128, 2048, 300, 260), (128, 8000, 300, 260),
                    (128, 16384, 200, 132), (8, 5, 37, 301), (12, 50, 61, 48)]
# K4 on (block, silos, k, grid): the path's shapes, one silo, block 8, a
# block whose tile exceeds shared memory (row bands; k above one chunk of
# slots), k not a multiple of 4
ADVERSARIAL_SUM = [(128, 4, 2048, (3, 2)), (128, 1, 2048, (2, 3)),
                   (8, 4, 20, (5, 3)), (256, 4, 3000, (2, 1)),
                   (128, 4, 37, (1, 2))]


def check_adversarial(dev) -> None:
    """K1 (shared and stacked b), K5 (with and without ``bisect_all``),
    K6, K4 and K2 against their plain versions on the CPU, bit for bit,
    on the inputs of ``kernels.adversarial`` in f32 and f64: tiles of
    zeros, heavy ties, -0.0, inf and ragged edges, k >= block^2; pairs
    with cells repeated within and across silos, -1 padding,
    out-of-range indices, ragged grids, blocks 8, 128 and 256 (row
    bands); K2's cases (``SCATTER_CASES``: one cell, the diagonal, all
    padding, a (1, 90,000) row, mirrors outside the matrix, -0.0, a silo
    scaled by 0, hot cells, a row window no pair lands in). The norms
    ||D||^2 to 1e-5 (f32) or 1e-12 (f64) relative."""
    import torch
    from repro_torch.kernels.adversarial import (
        SCATTER_CASES,
        SUM_CASES,
        TOPK_CASES,
        block_sparse_pairs,
        scatter_pairs,
        topk_inputs,
    )
    from repro_torch.kernels.block_topk import (
        block_topk,
        block_topk_payload,
        diff_topk_payload,
    )
    from repro_torch.kernels.scatter_accum import (
        block_scatter_accumulate,
        block_scatter_accumulate_ref,
        scatter_accumulate,
        scatter_accumulate_ref,
    )

    checked = 0
    for dtype in (torch.float32, torch.float64):
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        for case in TOPK_CASES:
            for block, k, m, cols in ADVERSARIAL_TOPK:
                what = f"{case}, {dtype}, block {block}, k {k}"
                a, b = topk_inputs(case, 4, m, cols, dtype, seed=21)
                want = diff_topk_payload(a, b, k=k, block=block)
                for bb in (b.to(dev), b.expand_as(a).contiguous().to(dev)):
                    got = diff_topk_payload(a.to(dev), bb, k=k, block=block)
                    require(torch.equal(got[0].cpu(), want[0])
                            and torch.equal(got[1].cpu(), want[1]),
                            f"diff_topk_payload differs ({what})")
                    require(torch.equal(torch.isinf(got[2].cpu()),
                                        torch.isinf(want[2])),
                            f"diff_topk_payload ||D||^2 differs ({what})")
                    fin = torch.isfinite(want[2])
                    rel = torch.abs(got[2].cpu()[fin] - want[2][fin]) / want[2][fin]
                    require(bool((rel <= tol).all()),
                            f"diff_topk_payload ||D||^2 off ({what})")
                d = a - b
                for bisect_all in (False, True):
                    got = block_topk_payload(d.to(dev), k, block,
                                             bisect_all=bisect_all)
                    want = block_topk_payload(d, k, block, bisect_all=bisect_all)
                    require(torch.equal(got[0].cpu(), want[0])
                            and torch.equal(got[1].cpu(), want[1]),
                            f"block_topk_payload differs ({what}, bisect_all "
                            f"{bisect_all})")
                require(torch.equal(block_topk(d.to(dev), k, block).cpu(),
                                    block_topk(d, k, block)),
                        f"block_topk differs ({what})")
                checked += 1
        for case in SUM_CASES:
            for block, n, k, grid in ADVERSARIAL_SUM:
                vals, idx = block_sparse_pairs(case, n, grid[0] * grid[1], k,
                                               block, dtype, seed=22)
                got = block_scatter_accumulate(vals.to(dev), idx.to(dev), grid,
                                               block)
                require(torch.equal(got.cpu(), block_scatter_accumulate_ref(
                    vals, idx, grid, block)),
                    f"block_scatter_accumulate differs ({case}, {dtype}, "
                    f"block {block}, n {n}, k {k})")
                checked += 1
        for case in SCATTER_CASES:
            args = scatter_pairs(case, dtype, seed=23)
            silo = args.pop("zero_silo", None)
            on_card = {**args, "values": args["values"].to(dev),
                       "indices": args["indices"].to(dev),
                       "init": None if args["init"] is None
                       else args["init"].to(dev)}
            got = scatter_accumulate(**on_card).cpu()
            bits = torch.int64 if dtype == torch.float64 else torch.int32
            require(torch.equal(got.view(bits),
                                scatter_accumulate_ref(**args).view(bits)),
                    f"scatter_accumulate differs ({case}, {dtype})")
            if silo is not None:
                dropped = on_card["indices"].clone()
                dropped[silo] = -1
                alone = scatter_accumulate(**{**on_card, "indices": dropped})
                require(torch.equal(alone.cpu().view(bits), got.view(bits)),
                        f"scatter_accumulate: a silo scaled by 0 changed the "
                        f"sum ({dtype})")
            checked += 1
    print(f"# K1, K5, K6, K4 and K2 match their plain versions bit for bit "
          f"on {checked} adversarial inputs", flush=True)


# -- phase 4: FedNL Algorithm 1 on w8a ------------------------------------------


def fednl_w8a(dev, prob, x0, K) -> dict:
    import torch
    from repro_torch.core import FedNL, make_compressor
    from repro_torch.data import problem_from_data
    from repro_torch.data.synthetic import make_libsvm_like

    d, n = prob["d"], prob["n"]
    err0 = float(torch.linalg.vector_norm(x0 - prob["xstar"]))
    K.reset_launches()
    finals = {}
    t_main = time.perf_counter()
    for family, level in LEVELS.items():
        for option in (1, 2):
            alg = FedNL(prob["grad"], prob["hess"], make_compressor(family, level),
                        option=option, mu=MU)
            _, xs = alg.run(x0, n, ROUNDS)
            finals[family, option] = xs
    torch.cuda.synchronize()
    launches = counts(K)
    t_main = time.perf_counter() - t_main
    print(f"# FedNL path: 8 runs x {ROUNDS} rounds on w8a in {t_main:.1f} s; "
          f"launches {json.dumps(launches)}", flush=True)
    for (family, option), xs in finals.items():
        require(xs.shape == (ROUNDS + 1, d) and bool(torch.isfinite(xs).all()),
                f"{family} option {option}: non-finite or misshapen iterates")
        e = float(torch.linalg.vector_norm(xs[-1] - prob["xstar"]))
        limit = max(1e-9, 2 * REFERENCE_ERR[family, option] * err0
                    / REFERENCE_ERR0)
        print(f"# w8a {family} option {option}: ||x0-x*|| {err0:.6e} -> "
              f"||x{ROUNDS}-x*|| {e:.6e} (bound {limit:.6e})")
        require(e < limit, f"{family} option {option}: ||x-x*|| = {e:.3e} "
                f">= {limit}")
    for name in ("diff_topk_payload", "scatter_accumulate",
                 "block_scatter_accumulate"):
        require(launches[name] > 0,
                f"kernel {name} was not launched on the FedNL path")

    # the card against the CPU port (held to the JAX reference by the
    # tests) on a1a-sized data: iterates agree to 1e-8 absolute
    small = make_libsvm_like(torch.Generator().manual_seed(1), "a1a")
    p_cpu = problem_from_data(small)
    p_gpu = problem_from_data(small._replace(a=small.a.to(dev), b=small.b.to(dev)))
    for family, level in (("topk", 123), ("topk-sym", 123), ("rankr", 1),
                          ("blocktopk", 8)):
        for option in (1, 2):
            xs = []
            for p in (p_cpu, p_gpu):
                alg = FedNL(p["grad"], p["hess"], make_compressor(family, level),
                            option=option, mu=MU)
                z = torch.zeros(123, dtype=torch.float64, device=p["xstar"].device)
                xs.append(alg.run(z, 16, 12)[1].cpu())
            gap = float(torch.max(torch.abs(xs[0] - xs[1])))
            require(gap <= 1e-8, f"a1a {family} option {option}: card vs CPU "
                    f"gap {gap:.2e}")
    print("# a1a: card iterates match the CPU port to 1e-8", flush=True)
    return launches


# -- phase 4b: FedNL variants on w8a -------------------------------------------

# ||x^20 - x*|| / ||x^0 - x*|| of the JAX reference on its own w8a draws
# (x0 = 0, ||x0 - x*|| = 2.6326945144070444), f64 on the CPU, the worst
# of seeds 0-4 for a randomized run, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_w8a_fednl.py --variants
# The port runs seed 0 on its own draws of the same shapes: its
# ||x^20 - x*|| must stay under twice the ratio times its own
# ||x0 - x*||, and never below 1e-9, as phase 4's bound.
VARIANT_RATIO = {
    "pp-topk-tau28": 0.11719373085773886,
    "pp-topk-tau71": 0.08177540661220406,
    "pp-blocktopk-tau28": 0.11938175809798668,
    "pp-blocktopk-tau71": 0.08543234087049228,
    "cr-topk": 0.7806104998003254,
    "ls-blocktopk": 2.1715769030154446e-09,
    "bc-topk": 8.512120959378604e-06,
    "fednl-randk": 5.11636267963348e-09,
    "fednl-powersgd": 0.013335457820175693,
    "stoch-topk": 0.5355960348430475,
    "ppbc-topk": 0.16363813617286493,
    "newton": 8.641077179687332e-17,
    "n0": 6.898411927615837e-09,
    "ns": 8.3237630477544e-17,
    "n0-ls": 1.1817479095191405e-08,
    "diana-randk": 0.9655598291978416,
    "artemis-randk": 0.9838289861608442,
}
VARIANT_ROUNDS_A1A = 12


def variant_methods(prob) -> dict:
    """The phase's runs at the problem's n and d: Top-K at k = d,
    Block-Top-K 8 per 128^2 tile, tau = 0.2 n and 0.5 n (Fig. 9), the
    downlinks Top-K at d/2, Rand-K on the Hessian at k = d (alpha =
    1/(omega + 1)) and on the gradient at k = d/10."""
    import torch
    from repro_torch.core import (
        FedNL,
        PowerSGD,
        RandK,
        SubsampledHessian,
        TopK,
        make_compressor,
    )
    from repro_torch.core.baselines import Artemis, Diana
    from repro_torch.engine import Oracles, make_method

    d, n = prob["d"], prob["n"]
    data, consts = prob["data"], prob["consts"]
    oracles = Oracles(prob["val"], prob["grad"], prob["hess"])
    topk, block, down = TopK(d), make_compressor("blocktopk", 8), TopK(d // 2)
    randk, grad_k = RandK(d), RandK(d // 10)
    omega = grad_k.spec((d,)).omega
    tau = {"tau28": round(0.2 * n), "tau71": round(0.5 * n)}
    hstar = torch.mean(prob["hess"](prob["xstar"]), dim=0)
    runs = {f"pp-{name}-{t}": make_method("fednl-pp", oracles, comp,
                                          tau=tau[t])
            for name, comp in (("topk", topk), ("blocktopk", block))
            for t in tau}
    runs.update({
        "cr-topk": make_method("fednl-cr", oracles, topk,
                               l_star=consts["L_star"]),
        "ls-blocktopk": make_method("fednl-ls", oracles, block, mu=MU),
        "bc-topk": make_method("fednl-bc", oracles, topk,
                               model_compressor=down, p=0.5, option=1, mu=MU),
        "fednl-randk": FedNL(prob["grad"], prob["hess"], randk, option=1,
                             mu=MU,
                             alpha=1.0 / (randk.spec((d, d)).omega + 1.0)),
        "fednl-powersgd": FedNL(prob["grad"], prob["hess"], PowerSGD(1),
                                option=2),
        "stoch-topk": make_method(
            "fednl-stoch", oracles, topk,
            hess_fn_stoch=SubsampledHessian(data, data.a.shape[1] // 2)),
        "ppbc-topk": make_method("fednl-ppbc", oracles, topk,
                                 model_compressor=down, tau=tau["tau28"]),
        "newton": make_method("newton", oracles),
        "n0": make_method("n0", oracles),
        "ns": make_method("ns", oracles, h_fixed=hstar),
        "n0-ls": make_method("n0-ls", oracles),
        "diana-randk": Diana(prob["grad"], grad_k, consts["L"], n, omega),
        "artemis-randk": Artemis(prob["grad"], grad_k, consts["L"], n, omega,
                                 tau=tau["tau28"]),
    })
    return runs


def fednl_variants_w8a(dev, prob, x0, K, card: str) -> dict:
    """The FedNL variants, the Newton family and DIANA/Artemis on w8a
    (seed 0, ROUNDS rounds each) against their reference bounds, with
    K1, K2 and K4 launched on the path; the runs whose bound would pass
    an unmoved x also against the CPU port on w8a; then the card against
    the CPU port on a1a-sized data (same seeds, same draws: every draw
    comes from a CPU generator, so the checks are exact to 1e-8); then
    each run's median ms per round (6 rounds after a warm-up). Returns
    the path's launches."""
    import torch
    from repro_torch.core import solve_cubic_subproblem
    from repro_torch.data import problem_from_data
    from repro_torch.data.synthetic import make_libsvm_like

    t_phase = time.perf_counter()
    d, n = prob["d"], prob["n"]
    err0 = float(torch.linalg.vector_norm(x0 - prob["xstar"]))
    runs = variant_methods(prob)
    require(set(runs) == set(VARIANT_RATIO), "the phase's runs and their "
            "reference ratios differ")
    K.reset_launches()
    t_main = time.perf_counter()
    finals = {name: alg.run(x0, n, ROUNDS, seed=0)[1]
              for name, alg in runs.items()}
    torch.cuda.synchronize()
    launches = counts(K)
    t_main = time.perf_counter() - t_main
    print(f"# FedNL variants path: {len(runs)} runs x {ROUNDS} rounds on "
          f"w8a in {t_main:.1f} s; launches {json.dumps(launches)}",
          flush=True)
    for name, xs in finals.items():
        require(xs.shape == (ROUNDS + 1, d) and bool(torch.isfinite(xs).all()),
                f"{name}: non-finite or misshapen iterates")
        e = float(torch.linalg.vector_norm(xs[-1] - prob["xstar"]))
        limit = max(1e-9, 2 * VARIANT_RATIO[name] * err0)
        print(f"# w8a {name}: ||x0-x*|| {err0:.6e} -> ||x{ROUNDS}-x*|| "
              f"{e:.6e} (bound {limit:.6e})")
        require(e < limit, f"{name}: ||x-x*|| = {e:.3e} >= {limit}")
    for name in ("diff_topk_payload", "scatter_accumulate",
                 "block_scatter_accumulate"):
        require(launches[name] > 0,
                f"kernel {name} was not launched on the variants path")

    # a bound at or above ||x0 - x*|| passes a run that never moves x:
    # those runs are held to the CPU port on the same data and draws
    cpu = problem_from_data(prob["data"]._replace(a=prob["data"].a.cpu(),
                                                  b=prob["data"].b.cpu()))
    cpu_runs = variant_methods(cpu)
    for name in [r for r in runs if 2 * VARIANT_RATIO[r] >= 1]:
        xs = cpu_runs[name].run(torch.zeros(d, dtype=torch.float64), n,
                                ROUNDS, seed=0)[1]
        gap = float(torch.max(torch.abs(finals[name].cpu() - xs)))
        print(f"# w8a {name}: card vs CPU port gap {gap:.3e} over "
              f"{ROUNDS} rounds", flush=True)
        require(gap <= 1e-8, f"w8a {name}: card vs CPU gap {gap:.2e}")
    print("# FedNL variants path: diff_topk_payload "
          f"{launches['diff_topk_payload']}, scatter_accumulate "
          f"{launches['scatter_accumulate']}, block_scatter_accumulate "
          f"{launches['block_scatter_accumulate']} launches", flush=True)

    # the card against the CPU port on a1a-sized data
    small = make_libsvm_like(torch.Generator().manual_seed(1), "a1a")
    probs = (problem_from_data(small),
             problem_from_data(small._replace(a=small.a.to(dev),
                                              b=small.b.to(dev))))
    both = [variant_methods(p) for p in probs]
    for name in runs:
        xs = []
        for p, methods in zip(probs, both):
            z = torch.zeros(p["d"], dtype=torch.float64,
                            device=p["xstar"].device)
            xs.append(methods[name].run(z, p["n"], VARIANT_ROUNDS_A1A,
                                        seed=0)[1].cpu())
        gap = float(torch.max(torch.abs(xs[0] - xs[1])))
        require(gap <= 1e-8, f"a1a {name}: card vs CPU gap {gap:.2e}")
    print(f"# a1a: the card's iterates of all {len(runs)} runs match the "
          "CPU port to 1e-8", flush=True)

    # ms per round; FedNL-LS's line search reads each probe's value on the
    # host and FedNL-CR's cubic solve is 100 serial bisection steps, so
    # their times are shown beside the rounds'
    probe_ms = []
    val = prob["val"]

    def timed_val(x):
        ms, v = host_ms(lambda: val(x))
        probe_ms.append(ms)
        return v

    round_ms, extra = {}, {}
    for name, alg in variant_methods(dict(prob, val=timed_val)).items():
        state = alg.step(alg.init(x0, n, seed=1))     # a warm-up round
        probe_ms.clear()
        times = []
        for _ in range(6):
            ms, state = host_ms(lambda: alg.step(state))
            times.append(ms)
        round_ms[name] = statistics.median(times)
        if name == "ls-blocktopk":
            extra["ls_value_calls_per_round"] = len(probe_ms) / 6
            extra["ls_value_ms_per_round"] = sum(probe_ms) / 6
        if name == "cr-topk":
            g = torch.mean(prob["grad"](state.x), dim=0)
            extra["cr_cubic_solve_ms"] = statistics.median(
                host_ms(lambda: solve_cubic_subproblem(
                    g, state.h_global, alg.l_star))[0] for _ in range(6))
    print(json.dumps({"variants_round_ms_median": round_ms, **extra,
                      "phase_s": time.perf_counter() - t_phase,
                      "card": card}), flush=True)
    return launches


# -- phase 4c: the engine on w8a ------------------------------------------------

# The cells of one Sweep on w8a (x0 = 0, ROUNDS rounds): name -> (method,
# compressor family, level (None: k = d), params, seeds, cohort?). Rand-K
# takes alpha = 1/(omega + 1) (Assumption 3.5); tau and the cohort K are
# 0.2 n (28 of w8a's 142), a cohort on the fl-cross-device link with the
# deadline at 0.8 and beta = 0.5.
ENGINE_CELLS = {
    "a": ("fednl", "topk", None, dict(option=2), (0, 1, 2), False),
    "b": ("fednl", "blocktopk", 8, dict(option=2), (0, 1, 2), False),
    "c": ("fednl", "randk", None, dict(option=2), (0, 1), False),
    "d": ("fednl-pp", "topk", None, {}, (0,), False),
    "e": ("fednl-cohort", "topk", None, {}, (0,), True),
    "f": ("fednl-cohort", "blocktopk", 8, {}, (0,), True),
}
# The reference's accounting of each cell at n = 142, d = 300 (the
# summary's bits_per_round, bits_per_round_measured,
# bits_per_round_entropy, seconds_per_round), and fednl_precond's
# uplink_bits over the qwen2-0.5B tree with 4 silos, printed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_w8a_fednl.py --sweep
ENGINE_ACCOUNTING = {
    "a": (48064.0, 48064.0, 41360.0, 0.0316584228101312),
    "b": (26176.0, 26176.0, 24745.0, 0.030894402615774322),
    "c": (48064.0, 48064.0, 41360.0, 0.0316584228101312),
    "d": (48064.0, 48064.0, 41360.0, 0.0316584228101312),
    "e": (48064.0, 48064.0, 41360.0, 0.0748019643902884),
    "f": (26176.0, 26176.0, 24745.0, 0.07094680601829031),
}
UPLINK_BITS_QWEN2_4_SILOS = 23733731328
# (f(x^20) - f*) / (f(x^0) - f*) of the reference on its own w8a draws
# (x0 = 0), the worst of seeds 0-4 where a cell draws at random, from the
# same script: the port's last gap must stay under twice the ratio times
# its own first gap, and never below 1e-12 (the f64 floor of f - f*)
ENGINE_GAP_RATIO = {
    "a": 0.0013784136472973093,
    "b": 0.001655705129014783,
    "c": 0.0018589652797741704,
    "d": 0.010164736214737076,
    "e": 0.010184646799153476,
    "f": 0.010561249225571466,
}
# rounds of the CPU port held to the card's engine cells e and f on w8a
ENGINE_CPU_ROUNDS = 3
# the reference CLI's summary header with --target
SWEEP_HEADER = ("name,method,compressor,level,num_seeds,bits_per_round,"
                "bits_per_round_measured,bits_per_round_entropy,us_per_round,"
                "seconds_per_round,bits_to_target,rounds_to_target,"
                "bits_to_target_worst_seed")


def engine_specs(n: int, d: int) -> dict:
    """``ENGINE_CELLS`` as ``ExperimentSpec``s at n silos of width d."""
    from repro_torch.core import CohortSpec, make_compressor
    from repro_torch.engine import ExperimentSpec

    tau = round(0.2 * n)
    alpha = 1.0 / (make_compressor("randk", d).spec((d, d)).omega + 1.0)
    specs = {}
    for name, (method, family, level, params, seeds, co) in \
            ENGINE_CELLS.items():
        if family == "randk":
            params = dict(params, alpha=alpha)
        if method == "fednl-pp":
            params = dict(params, tau=tau)
        specs[name] = ExperimentSpec(
            method, family, d if level is None else level, params=params,
            seeds=seeds, num_rounds=ROUNDS,
            cohort=CohortSpec(cohort=tau) if co else None)
    return specs


def codec_round_trip(dev, prob, x0) -> dict:
    """One FedNL round's uplink on w8a, all 142 silos: Block-Top-K 8
    payloads from K1 and Top-K payloads (K2's input), each through
    ``encode_silos`` -> ``decode_silos`` -> ``decompress`` under every
    value format. raw must give the original's decompress bit for bit and
    the same server mean through K2/K4; fp16 the original's values cast
    to f16 and back, exactly; int8 each silo's values within max|v| / 250
    (the reference's stated bounds). Returns the host ms of encode and
    decode per payload kind and format."""
    import numpy as np
    import torch
    from repro_torch.core import FedNL, make_compressor
    from repro_torch.wire import decode_silos, encode_silos

    d, n = prob["d"], prob["n"]
    times = {}
    for family, level in (("blocktopk", 8), ("topk", d)):
        comp = make_compressor(family, level)
        alg = FedNL(prob["grad"], prob["hess"], comp, option=2)
        state = alg.step(alg.init(x0, n))
        pay, _ = alg._uplink_diff_payloads(prob["hess"](state.x),
                                           state.h_local)
        dense = comp.decompress(pay, (d, d))
        for fmt in ("raw", "fp16", "int8"):
            enc_ms, bufs = host_ms(lambda: list(encode_silos(
                pay, value_format=fmt)))
            dec_ms, back = host_ms(lambda: decode_silos(bufs, device=dev))
            times[f"{family}_{fmt}"] = dict(
                encode_ms=enc_ms, decode_ms=dec_ms, silos=len(bufs),
                bytes=sum(len(b) for b in bufs))
            got = comp.decompress(back, (d, d))
            what = f"codec round trip ({family}, {fmt})"
            if fmt == "raw":
                require(torch.equal(got, dense), f"{what}: decompress differs")
                require(torch.equal(comp.aggregate(back, (d, d)),
                                    comp.aggregate(pay, (d, d))),
                        f"{what}: the server mean differs")
            elif fmt == "fp16":
                # numpy's one rounding to f16, as the codec's
                cast = dataclasses.replace(pay, values=torch.from_numpy(
                    pay.values.cpu().numpy().astype(np.float16).astype(
                        np.float64)).to(dev))
                require(torch.equal(got, comp.decompress(cast, (d, d))),
                        f"{what}: values are not the f16 cast")
            else:
                lim = torch.amax(torch.abs(pay.values).reshape(n, -1), dim=1)
                err = torch.amax(torch.abs(got - dense).reshape(n, -1), dim=1)
                require(bool((err <= lim / 250).all()),
                        f"{what}: error {float((err / lim).max()):.3e} of "
                        f"max|v| above 1/250")
    return times


def engine_w8a(dev, prob, K, card: str) -> dict:
    """The experiment engine on w8a: one ``Sweep`` of ``ENGINE_CELLS``
    (the main path: K1, K2 and K4 must launch; counts around the sweep
    alone), held to the serial ``run`` of every cell and seed bit for
    bit, the cohort at beta = 0 and q = 1 to cell d bit for bit, cells e
    and f to the CPU port on a1a and on w8a (1e-8, the same draws), the
    accounting columns to the reference's, each last gap under its bound,
    and the codec round trip; then the CLI once, in process. Prints each
    cell's us_per_round and median ms per round, the sweep's wall clock
    against the bare serial runs' and the codec's host ms. Returns the
    sweep's launches."""
    import contextlib
    import io

    import numpy as np
    import torch
    from repro_torch.configs.qwen2_0_5b import param_shapes
    from repro_torch.core import CohortSpec, make_compressor
    from repro_torch.data import problem_from_data
    from repro_torch.data.synthetic import make_libsvm_like
    from repro_torch.engine import Oracles, Sweep, make_method
    from repro_torch.launch import sweep as sweep_cli
    from repro_torch.second_order.fednl_precond import fednl_precond

    t_phase = time.perf_counter()
    d, n = prob["d"], prob["n"]
    x0 = torch.zeros(d, dtype=torch.float64, device=dev)
    oracles = Oracles(prob["val"], prob["grad"], prob["hess"])
    specs = engine_specs(n, d)

    # the bare serial runs first: the sweep's cells must equal them
    serial, serial_s = {}, 0.0
    for name, spec in specs.items():
        for seed in spec.seeds:
            method = spec.build(oracles)
            torch.cuda.synchronize()
            t = time.perf_counter()
            serial[name, seed] = method.run(x0, n, ROUNDS, seed=seed)[1]
            torch.cuda.synchronize()
            serial_s += time.perf_counter() - t

    K.reset_launches()
    t = time.perf_counter()
    res = Sweep(list(specs.values())).run(prob, x0=x0)
    sweep_s = time.perf_counter() - t
    launches = counts(K)
    print(f"# engine path: one Sweep of {len(specs)} cells ("
          f"{sum(len(s.seeds) for s in specs.values())} runs x {ROUNDS} "
          f"rounds) on w8a in {sweep_s:.3f} s, the bare serial runs "
          f"{serial_s:.3f} s (overhead {sweep_s / serial_s - 1:+.2%}, the "
          f"sweep's gaps and accounting included); launches "
          f"{json.dumps(launches)}", flush=True)
    for kernel in ("diff_topk_payload", "scatter_accumulate",
                   "block_scatter_accumulate"):
        require(launches[kernel] > 0,
                f"kernel {kernel} was not launched on the engine path")

    summary = {row["name"]: row for row in res.summary()}
    for name, spec in specs.items():
        cell = res.cell(spec.label)
        for i, seed in enumerate(spec.seeds):
            require(torch.equal(torch.from_numpy(cell.xs[i]),
                                serial[name, seed].cpu()),
                    f"engine cell {name} seed {seed}: the sweep differs from "
                    f"the serial run")
        row = summary[spec.label]
        got = (row["bits_per_round"], row["bits_per_round_measured"],
               row["bits_per_round_entropy"], row["seconds_per_round"])
        require(got == ENGINE_ACCOUNTING[name],
                f"engine cell {name}: accounting {got} != the reference's "
                f"{ENGINE_ACCOUNTING[name]}")
        require(bool(np.isfinite(cell.gaps).all()),
                f"engine cell {name}: non-finite gaps")
        limit = max(1e-12, 2 * ENGINE_GAP_RATIO[name]
                    * float(cell.gaps[:, 0].max()))
        worst = float(cell.gaps[:, -1].max())
        print(f"# engine cell {name} ({spec.label}): gap {cell.gaps[0, 0]:.6e}"
              f" -> {worst:.6e} (bound {limit:.6e})")
        require(worst < limit, f"engine cell {name}: last gap {worst:.3e} >= "
                f"{limit:.3e}")

    # FedNL-PP recovered: beta = 0 and deadline quantile 1 are cell d
    pin = CohortSpec(cohort=specs["d"].params["tau"], staleness_beta=0.0,
                     deadline_quantile=1.0)
    _, xs = make_method("fednl-cohort", oracles, make_compressor("topk", d),
                        cohort=pin).run(x0, n, ROUNDS, seed=0)
    require(torch.equal(xs.cpu(), torch.from_numpy(
        res.cell(specs["d"].label).xs[0])),
            "the cohort at beta 0, q 1 differs from FedNL-PP (cell d)")

    # the card against the CPU port on cells e and f, from the same draws:
    # 12 rounds on a1a-sized data; on w8a the sweep's own iterates against
    # the CPU port's first ENGINE_CPU_ROUNDS rounds (a CPU round of w8a's
    # Block-Top-K takes seconds)
    small = make_libsvm_like(torch.Generator().manual_seed(1), "a1a")
    cpu_w8a = problem_from_data(prob["data"]._replace(a=prob["data"].a.cpu(),
                                                      b=prob["data"].b.cpu()))
    for name in ("e", "f"):
        for where, p_cpu, p_gpu, rounds in (
                ("a1a", problem_from_data(small), problem_from_data(
                    small._replace(a=small.a.to(dev), b=small.b.to(dev))), 12),
                ("w8a", cpu_w8a, None, ENGINE_CPU_ROUNDS)):
            xs = []
            for p in (p_cpu, p_gpu):
                if p is None:
                    xs.append(torch.from_numpy(res.cell(specs[name].label)
                                               .xs[0][:rounds + 1]))
                    continue
                spec = engine_specs(p["n"], p["d"])[name]
                method = spec.build(Oracles(p["val"], p["grad"], p["hess"]))
                z = torch.zeros(p["d"], dtype=torch.float64,
                                device=p["xstar"].device)
                xs.append(method.run(z, p["n"], rounds, seed=0)[1].cpu())
            gap = float(torch.max(torch.abs(xs[0] - xs[1])))
            require(gap <= 1e-8, f"{where} engine cell {name}: card vs CPU "
                    f"gap {gap:.2e}")
            print(f"# {where} engine cell {name}: card vs CPU port gap "
                  f"{gap:.3e} over {rounds} rounds", flush=True)

    bits = fednl_precond(k_per_block=K_PER_BLOCK, block=BLOCK).uplink_bits(
        param_shapes(), n_silos=SILOS)
    require(bits == UPLINK_BITS_QWEN2_4_SILOS,
            f"uplink_bits over qwen2-0.5B: {bits} != the reference's "
            f"{UPLINK_BITS_QWEN2_4_SILOS}")

    # median ms per round of each cell (seed 0, a warm-up round first)
    round_ms = {}
    for name, spec in specs.items():
        method = spec.build(oracles)
        state = method.step(method.init(x0, n, seed=0))
        times = []
        for _ in range(ROUNDS - 1):
            ms, state = host_ms(lambda: method.step(state))
            times.append(ms)
        round_ms[name] = statistics.median(times)
    codec_ms = codec_round_trip(dev, prob, x0)

    # the CLI once, in process, on the card
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sweep_cli.main(["--problem", "w8a", "--method", "fednl",
                             "--compressor", "topk", "--levels", "300",
                             "--seeds", "0,1", "--rounds", "5", "--option",
                             "2", "--target", "1e-9", "--device", "cuda"])
    lines = out.getvalue().strip().splitlines()
    require(rc == 0 and lines and lines[0] == SWEEP_HEADER and len(lines) == 2,
            f"the sweep CLI printed {lines[:2]}")
    print(json.dumps({
        "engine_us_per_round": {name: res.cell(spec.label).us_per_round
                                for name, spec in specs.items()},
        "engine_round_ms_median": round_ms,
        "engine_sweep_s": sweep_s, "engine_serial_s": serial_s,
        "engine_launches": {k: launches[k] for k in (
            "diff_topk_payload", "scatter_accumulate",
            "block_scatter_accumulate")},
        "codec_host_ms": codec_ms, "cli_row": lines[1],
        "phase_s": time.perf_counter() - t_phase, "card": card}), flush=True)
    return launches


# -- phase 4d: multi-device aggregation on w8a ------------------------------------

# The card is one, and NCCL refuses two ranks on one GPU: the group here
# is one rank (make_host_mesh's own NCCL group), where every all_reduce
# is the identity, so each sharded run must equal the unsharded FedNL
# run bit for bit. Ranks W > 1 with real collectives are held by the CPU
# tests on gloo groups of 4 (tests/test_torch_federated.py). The row
# windows of the sharded server sum run here window by window, at W = 2
# and 4, each a K2 call at (d / W, d).
SHARDED_RUNS = (("topk", None, 1), ("topk", None, 2), ("blocktopk", 8, 2))
WINDOW_WORLDS = (2, 4)


def sharded_w8a(dev, prob, x0, K, card: str) -> dict:
    """``run_fednl_sharded`` on a one-rank NCCL mesh for ``SHARDED_RUNS``
    (the main path: K1, K2 and K4 must launch; counts around those runs
    alone), each equal to the unsharded ``FedNL.run`` bit for bit; ms per
    round of both, in turns (parent order: unsharded, sharded, sharded,
    unsharded). Then ``windowed_scatter_accumulate`` at W = 2 and 4 on
    w8a's Top-K payloads (plain and symmetric) and on the K3 shape's,
    each equal to the unsharded K2 sum bit for bit (its launches counted
    as the paths ``sharded_windows`` and ``sharded_windows_d2048``), with
    CUDA-event ms of each beside the unsharded call. Returns the paths'
    launches; the group is destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    mesh = make_host_mesh()
    try:
        require(tuple(mesh.shape) == (1, 1) and dist.get_backend() == "nccl",
                f"the host mesh is {tuple(mesh.shape)} over "
                f"{dist.get_backend()}, not one NCCL rank")
        return _sharded_w8a(dev, prob, x0, K, card, mesh, t_phase)
    finally:
        dist.destroy_process_group()


def _sharded_w8a(dev, prob, x0, K, card, mesh, t_phase) -> dict:
    import torch
    from repro_torch.core import FedNL, make_compressor, run_fednl_sharded
    from repro_torch.kernels.scatter_accum import scatter_accumulate
    from repro_torch.kernels.scatter_accum.sharded import (
        windowed_scatter_accumulate,
    )

    d, n = prob["d"], prob["n"]

    def comp_of(family, level):
        return make_compressor(family, d if level is None else level)

    K.reset_launches()
    runs = {}
    for family, level, option in SHARDED_RUNS:
        _, xs = run_fednl_sharded(prob["data"], comp_of(family, level), mesh,
                                  x0, ROUNDS, option=option, mu=MU)
        runs[family, option] = xs
    torch.cuda.synchronize()
    launches = counts(K)
    for name in ("diff_topk_payload", "scatter_accumulate",
                 "block_scatter_accumulate"):
        require(launches[name] > 0,
                f"kernel {name} was not launched on the sharded FedNL path")
    round_ms = {}
    for family, level, option in SHARDED_RUNS:
        comp = comp_of(family, level)
        alg = FedNL(prob["grad"], prob["hess"], comp, option=option, mu=MU)
        want = alg.run(x0, n, ROUNDS)[1]
        require(torch.equal(runs[family, option], want),
                f"sharded {family} option {option} differs from the "
                f"unsharded run by "
                f"{float(torch.max(torch.abs(runs[family, option] - want))):.3e}")

        # a round: (a run of ROUNDS - a run of 0 rounds) / ROUNDS
        def per_round(sharded):
            def run(rounds):
                if sharded:
                    return run_fednl_sharded(prob["data"], comp, mesh, x0,
                                             rounds, option=option, mu=MU)
                return alg.run(x0, n, rounds)
            return (host_ms(lambda: run(ROUNDS))[0]
                    - host_ms(lambda: run(0))[0]) / ROUNDS

        turns = {"unsharded": [], "sharded": []}
        for key in ("unsharded", "sharded", "sharded", "unsharded"):
            turns[key].append(per_round(key == "sharded"))
        round_ms[f"{family}/option{option}"] = turns

    # the row windows against the unsharded K2 sum
    diff = prob["hess"](x0) - prob["hess"](prob["xstar"])
    k3 = k3_payloads(dev, seed=5)
    inputs = {"w8a": (comp_of("topk", None).compress(diff), (d, d), False),
              "w8a_sym": (comp_of("topk-sym", None).compress(diff), (d, d),
                          True),
              "k3": (k3, (K3_D, K3_D), False),
              "k3_sym": (k3, (K3_D, K3_D), True)}
    sums, window_launches = {}, {}
    for path, keys in (("sharded_windows", ("w8a", "w8a_sym")),
                       ("sharded_windows_d2048", ("k3", "k3_sym"))):
        K.reset_launches()
        for key in keys:
            pay, shape, sym = inputs[key]
            for w in WINDOW_WORLDS:
                sums[key, w] = windowed_scatter_accumulate(
                    pay.values.contiguous(), pay.indices.contiguous(), shape,
                    w, symmetric=sym)
        torch.cuda.synchronize()
        window_launches[path] = counts(K)
        got = window_launches[path]["scatter_accumulate"]
        require(got == len(keys) * sum(WINDOW_WORLDS),
                f"{path}: scatter_accumulate launched {got} times, not "
                f"{len(keys) * sum(WINDOW_WORLDS)}")
    window_ms = {}
    for key, (pay, shape, sym) in inputs.items():
        v, i = pay.values.contiguous(), pay.indices.contiguous()
        whole = scatter_accumulate(v, i, shape, symmetric=sym)
        row = {"unsharded_ms": time_cuda(
            lambda: scatter_accumulate(v, i, shape, symmetric=sym))}
        for w in WINDOW_WORLDS:
            require(torch.equal(sums[key, w], whole),
                    f"{key} at W={w}: the windows differ from the unsharded "
                    f"K2 sum")
            row[f"W{w}_ms"] = time_cuda(lambda: windowed_scatter_accumulate(
                v, i, shape, w, symmetric=sym))
        window_ms[key] = row
    # one identity all_reduce's wall ms, as _server_reduce issues it (a
    # clone, the collective, the division): the (d, d) mean and a scalar
    group = mesh.get_group("data")
    method = FedNL(None, None, comp_of("topk", None), group=group)
    reduce_ms = {}
    for key, t in (("dxd", diff[0]), ("scalar", diff[0, 0, 0])):
        reps = 200
        reduce_ms[key] = host_ms(lambda: [method._server_reduce(t)
                                          for _ in range(reps)])[0] / reps
    unsharded = {key: statistics.median(t["unsharded"])
                 for key, t in round_ms.items()}
    sharded = {key: statistics.median(t["sharded"])
               for key, t in round_ms.items()}
    print(f"# sharded FedNL on one NCCL rank: {len(SHARDED_RUNS)} runs x "
          f"{ROUNDS} rounds bit for bit equal to the unsharded runs; the "
          f"windows at W = {WINDOW_WORLDS} equal the unsharded K2 sum",
          flush=True)
    print(json.dumps({
        "sharded_round_ms_median": sharded,
        "unsharded_round_ms_median": unsharded,
        "sharded_round_ms_turns": round_ms, "window_ms": window_ms,
        "identity_reduce_ms": reduce_ms,
        "sharded_launches": {k: launches[k] for k in (
            "diff_topk_payload", "scatter_accumulate",
            "block_scatter_accumulate")},
        "window_launches": {path: got["scatter_accumulate"]
                            for path, got in window_launches.items()},
        "phase_s": time.perf_counter() - t_phase, "card": card}), flush=True)
    return {"fednl_sharded_w8a": launches, **window_launches}


# the K3 shape: d = 2,048 in f64, the first width where the TPU package
# tiles the output, at Top-K k = d over w8a's 142 silos
K3_N, K3_D = 142, 2048


def k3_payloads(dev, seed: int, hot: float = 0.5):
    """142 silos' Top-K payloads (k = d) on a 2,048 x 2,048 f64 matrix,
    lower-triangular, values from ``seed``: every 1/``hot``-th cell of a
    silo from 4,096 cells every silo picks (half of them by default;
    none, or all), the rest its own. The hot share is chosen, not
    measured: no configuration of the repo reaches d = 2,048, and it sets
    how long the runs on one cell are."""
    import torch
    from repro_torch.core import SparsePayload

    gen = torch.Generator(device=dev).manual_seed(seed)
    cells = K3_D * K3_D
    idx = torch.randint(0, cells, (K3_N, K3_D), generator=gen, device=dev)
    hot_cells = torch.randint(0, cells, (4096,), generator=gen, device=dev)
    if hot:
        step = round(1 / hot)
        idx[:, ::step] = hot_cells[torch.randint(
            0, 4096, (K3_N, -(-K3_D // step)), generator=gen, device=dev)]
    r, c = idx // K3_D, idx % K3_D
    idx = torch.maximum(r, c) * K3_D + torch.minimum(r, c)
    vals = torch.randn((K3_N, K3_D), generator=gen, device=dev,
                       dtype=torch.float64)
    return SparsePayload(values=vals, indices=idx.to(torch.int32).contiguous(),
                         universe=cells)


def topk_aggregate_k3(dev, K, err: dict) -> tuple[dict, object]:
    """The server's mean of 142 Top-K payloads at the K3 shape through
    ``TopK.aggregate`` (plain and symmetric); returns the launches and
    the payloads. The sum is held bit for bit to the plain version on
    the CPU, divided by n on the card as the mean is."""
    import torch
    from repro_torch.core import TopK
    from repro_torch.kernels.scatter_accum import scatter_accumulate_ref

    pay = k3_payloads(dev, seed=3)
    K.reset_launches()
    means = {sym: TopK(K3_D, symmetric=sym).aggregate(pay, (K3_D, K3_D))
             for sym in (False, True)}
    torch.cuda.synchronize()
    launches = counts(K)
    require(launches["scatter_accumulate"] == 2,
            f"TopK.aggregate at d={K3_D} launched scatter_accumulate "
            f"{launches['scatter_accumulate']} times, not 2")
    for sym, mean in means.items():
        # the mean's division as the card takes it (by the reciprocal)
        want = (scatter_accumulate_ref(pay.values.cpu(), pay.indices.cpu(),
                                       (K3_D, K3_D), symmetric=sym).to(dev)
                / K3_N).cpu()
        e = float(torch.max(torch.abs(mean.cpu() - want)))
        err["scatter_accumulate_tiled"] = max(err["scatter_accumulate_tiled"],
                                              e)
        require(mean.shape == (K3_D, K3_D) and torch.equal(mean.cpu(), want),
                f"TopK.aggregate at d={K3_D} (symmetric {sym}) differs from "
                f"the plain version (max err {e:.2e})")
    print(f"# TopK.aggregate at d={K3_D}: 142 silos, k = d, plain and "
          f"symmetric, bit for bit; launches {json.dumps(launches)}",
          flush=True)
    return launches, pay


# -- phase 5: the curvature-learning optimizer at qwen2-0.5B width ---------------


def _small(tree) -> dict:
    """The small tensors of a qwen2 tree: the norms, the biases and wk."""
    layer = tree["layers"][0]
    return {"norm_f": tree["norm_f"],
            "layers": [{"norm1": layer["norm1"], "norm2": layer["norm2"],
                        "mixer": {key: layer["mixer"][key]
                                  for key in ("bq", "bk", "bv", "wk")}}]}


def precond_qwen2(dev, seed: int, K, err: dict) -> dict:
    """Drive ``fednl_precond`` through 3 updates, a refresh and a
    precondition over every qwen2-0.5B tensor; returns what later phases
    time and report."""
    import torch
    from repro_torch.configs.qwen2_0_5b import param_shapes
    from repro_torch.kernels.block_topk import (
        block_topk_payload,
        block_topk_payload_ref,
        diff_topk_payload,
        diff_topk_payload_ref,
    )
    from repro_torch.kernels.scatter_accum import (
        block_scatter_accumulate,
        block_scatter_accumulate_ref,
    )
    from repro_torch.second_order import FedNLPrecondOptimizer, fednl_precond
    from repro_torch.second_order.fednl_precond import _shape2d
    from repro_torch.tree import tree_leaves, tree_map

    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = param_shapes()
    params = tree_map(lambda s: torch.randn(s.shape, generator=gen, device=dev,
                                            dtype=s.dtype).mul_(0.02), shapes)
    n_params = sum(p.numel() for p in tree_leaves(params))
    require(n_params == 494_032_768 and len(tree_leaves(params)) == 14,
            f"qwen2-0.5b tree has {n_params} parameters")
    opt = fednl_precond(lr=1e-3, k_per_block=K_PER_BLOCK, block=BLOCK)

    def draw():
        """Per-silo bf16 gradients -> (mean gradient, silo observations)."""
        silo_grads = tree_map(
            lambda p: torch.randn((SILOS,) + tuple(p.shape), generator=gen,
                                  device=dev, dtype=torch.bfloat16).mul_(1e-2),
            params)
        grads = tree_map(lambda g: g.float().mean(dim=0).to(torch.bfloat16),
                         silo_grads)
        return grads, opt.observe(silo_grads)

    torch.cuda.reset_peak_memory_stats()
    state = opt.init(params)
    first = draw()
    # H = 0 at step 0: the fused diff payload of obs - 0 is the payload of
    # obs. A check between two kernels, so it runs before the counts of
    # the path are reset.
    for o, h in zip(tree_leaves(first[1]), tree_leaves(state.h)):
        o2 = o.reshape((SILOS,) + _shape2d(h.shape))
        v1, i1, _ = diff_topk_payload(o2, h.reshape(o2.shape[1:]),
                                      K_PER_BLOCK, BLOCK)
        v5, i5 = block_topk_payload(o2, K_PER_BLOCK, BLOCK)
        require(torch.equal(v1, v5) and torch.equal(i1, i5),
                f"K1(obs, 0) != K5(obs) on a {tuple(h.shape)} tensor")
    del v1, i1, v5, i5
    record = []           # CPU copies of the small tensors, step by step
    update_ms = []
    K.reset_launches()
    t_path = time.perf_counter()
    for step in range(STEPS):
        grads, obs = first if step == 0 else draw()
        first = None
        ms, (upd, state) = host_ms(lambda: opt.update(grads, state, params, obs))
        update_ms.append(ms)
        record.append((_small(grads), _small(obs), _small(upd)))
    grads, obs = draw()
    before = state
    refresh_ms, state = host_ms(lambda: opt.refresh(before, obs))
    precond_ms, (upd, state) = host_ms(
        lambda: opt.precondition(grads, state, params))
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t_path
    launches = counts(K)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"# optimizer path: {STEPS} updates + refresh + precondition over "
          f"{n_params} qwen2-0.5b parameters, {SILOS} silos, in "
          f"{t_path:.1f} s; launches {json.dumps(launches)}", flush=True)
    for name in ("diff_topk_payload", "block_scatter_accumulate"):
        require(launches[name] > 0,
                f"kernel {name} was not launched on the optimizer path")
    # each silo's uplink payload of the refresh's observations, through
    # the optimizer's codec (BlockTopKThreshold.compress)
    codec = FedNLPrecondOptimizer(k_per_block=K_PER_BLOCK,
                                  block=BLOCK).compressor
    K.reset_launches()
    uplink = [codec.compress(o.reshape((SILOS,) + _shape2d(h.shape)))
              for o, h in zip(tree_leaves(obs), tree_leaves(before.h))]
    torch.cuda.synchronize()
    uplink_launches = counts(K)
    print(f"# optimizer uplink codec: launches {json.dumps(uplink_launches)}",
          flush=True)
    require(uplink_launches["block_topk_payload"] > 0,
            "kernel block_topk_payload was not launched by the uplink codec")
    for name, tree in (("H", state.h), ("l", state.l), ("mu", state.mu),
                       ("update", upd)):
        require(all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree)),
                f"non-finite {name} after the optimizer path")
    require(any(bool((h != 0).any()) for h in tree_leaves(state.h)),
            "H learned nothing")
    record.append((_small(grads), _small(obs), _small(upd)))

    # the card against the CPU port on the small tensors
    cpu = lambda t: t.cpu()                                   # noqa: E731
    p_c = tree_map(cpu, _small(params))
    s_c = opt.init(p_c)
    differ = [0, 0]                  # update entries that differ, of all
    for i, (g, o, u) in enumerate(record):
        g_c, o_c = tree_map(cpu, g), tree_map(cpu, o)
        if i < STEPS:
            u_c, s_c = opt.update(g_c, s_c, p_c, o_c)
        else:
            s_c = opt.refresh(s_c, o_c)
            u_c, s_c = opt.precondition(g_c, s_c, p_c)

        def close_updates(a, b):
            # bf16 updates: one bf16 rounding step apart, plus the f32
            # gap of the momentum they round (the ridge's sums run in
            # another order), norm-wise: an entry whose momentum cancels
            # to near 0 carries the absolute error of its terms
            a, b = a.cpu().float(), b.float()
            gap = torch.abs(a - b)
            scale = float(torch.max(torch.abs(b)))
            over = gap > 2.0 ** -7 * torch.abs(b) + 1e-5 * scale
            require(not bool(over.any()),
                    f"card and CPU updates differ at step {i}: "
                    f"{int(over.sum())} of {b.numel()} entries, worst gap "
                    f"{float(gap.max()):.3e} of max |u| {scale:.3e}")
            differ[0] += int((gap > 0).sum())
            differ[1] += b.numel()
        tree_map(close_updates, u, u_c)
    gap = {"h": 0.0, "l": 0.0, "mu": 0.0}
    for name in gap:
        for a, b in zip(tree_leaves(_small(getattr(state, name))),
                        tree_leaves(getattr(s_c, name))):
            a = a.cpu()
            if name == "h":
                require(torch.equal(a, b), "card and CPU H differ")
            gap[name] = max(gap[name], max_rel(a, b))
    require(gap["l"] <= 1e-5 and gap["mu"] <= 1e-5,
            f"card and CPU l/mu differ: {gap}")
    print(f"# optimizer: card == CPU port on the small tensors (H bitwise, "
          f"rel gaps {json.dumps(gap)}; {differ[0]} of {differ[1]} bf16 "
          f"update entries differ)", flush=True)

    # K1, K4 and the codec's K5 payloads against their plain versions on
    # every tensor's inputs of the refresh (per silo for the plain
    # versions, to bound memory)
    rel_sq = 0.0
    for o, h, pay in zip(tree_leaves(obs), tree_leaves(before.h), uplink):
        shape2 = _shape2d(h.shape)
        o2, h2 = o.reshape((SILOS,) + shape2), h.reshape(shape2)
        v, i, sq = diff_topk_payload(o2, h2, K_PER_BLOCK, BLOCK)
        v5, i5 = pay.values, pay.indices
        for s in range(SILOS):
            want = diff_topk_payload_ref(o2[s:s + 1], h2, K_PER_BLOCK, BLOCK)
            require(torch.equal(v[s:s + 1], want[0])
                    and torch.equal(i[s:s + 1], want[1]),
                    f"diff_topk_payload differs from its plain version on a "
                    f"{tuple(h.shape)} tensor")
            rel = float(torch.abs(sq[s] - want[2][0]) / want[2][0])
            require(rel <= 1e-5, f"diff_topk_payload ||D||^2 off by {rel:.2e}")
            rel_sq = max(rel_sq, rel)
            want5 = block_topk_payload_ref(o2[s:s + 1], K_PER_BLOCK, BLOCK,
                                           bisect_all=True)
            require(torch.equal(v5[s:s + 1], want5[0])
                    and torch.equal(i5[s:s + 1], want5[1]),
                    f"the uplink codec's payload differs from K5's plain "
                    f"version on a {tuple(h.shape)} tensor")
        # K4's plain version runs on the CPU: its index_add_ adds in
        # stream order there, as the kernel does, and with atomics in no
        # fixed order on the card (4 silos may hit one cell)
        grid = tuple(-(-x // BLOCK) for x in shape2)
        got = block_scatter_accumulate(v, i, grid, BLOCK)
        want = block_scatter_accumulate_ref(v.cpu(), i.cpu(), grid, BLOCK)
        require(torch.equal(got.cpu(), want), f"block_scatter_accumulate "
                f"differs from its plain version on a {tuple(h.shape)} tensor")
        del v, i, v5, i5, got, want
    del uplink
    err["block_topk_payload"] = 0.0
    print(f"# optimizer: K1, K4, K5 match their plain versions on all 14 "
          f"tensors (payloads and sums bitwise; ||D||^2 rel "
          f"{rel_sq:.2e})", flush=True)

    # where a refresh's device time goes (same inputs again), and K1's
    # and K4's device ms in it beside the least time of each: K1 reads
    # every silo's observation and H once and writes the payloads and
    # partials; K4 reads the payloads and writes the tiled dense sum
    wall, rows = profile_rows(lambda: opt.refresh(before, obs))
    busy = sum(ms for _, ms, _ in rows)
    prof = {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top_device_ms": [[name[:60], ms] for name, ms, _ in rows[:6]]}
    kernel_ms = {name: sum(ms for row, ms, _ in rows if symbol in row)
                 for name, symbol in REFRESH_KERNELS.items()}
    n_tiles = sum(-(-_shape2d(h.shape)[0] // BLOCK)
                  * -(-_shape2d(h.shape)[1] // BLOCK)
                  for h in tree_leaves(state.h))
    pairs = SILOS * n_tiles * K_PER_BLOCK
    entries = SILOS * n_tiles * BLOCK * BLOCK
    refresh_bound = {
        "diff_topk_payload": bound(
            (SILOS + 1) * n_params * 4 + pairs * 8 + SILOS * n_tiles * 4,
            {"f32": K1_OPS_PER_ENTRY * entries}),
        "block_scatter_accumulate": bound(
            pairs * 8 + n_tiles * BLOCK * BLOCK * 4, {"f32": pairs})}
    timings = {"update_ms": update_ms, "refresh_ms": refresh_ms,
               "precondition_ms": precond_ms, "peak_memory_gb": peak_gb,
               "tiles_per_silo": n_tiles,
               "refresh_kernel_device_ms": kernel_ms,
               "refresh_bound_ms": refresh_bound, "refresh_profile": prof}
    print(json.dumps({"fednl_precond_qwen2": timings}), flush=True)
    refresh_rows = refresh_kernel_rows(obs, before.h, refresh_bound)
    embed = {"obs": obs["embed"], "h": before.h["embed"],
             "h_new": state.h["embed"]}
    wg0 = params["layers"][0]["ffn"]["wg"][0].float()
    return dict(launches=launches, uplink_launches=uplink_launches,
                timings=timings, embed=embed, wg0=wg0, refresh=refresh_rows)


# the kernels of a refresh, by the symbol the profiler shows
REFRESH_KERNELS = {"diff_topk_payload": "diff_topk_payload_kernel",
                   "block_scatter_accumulate": "block_scatter_kernel"}
# f32 operations per tile entry in K1: a - b, the square-add of ||D||^2,
# the max, the pass-1 key and the two bracket compares
K1_OPS_PER_ENTRY = 6


def refresh_kernel_rows(obs, h, refresh_bound) -> dict:
    """K1 and K4 over a whole refresh (all 14 tensors, 4 silos, shared H):
    CUDA-event ms of the 14 wrapper calls and device ms of their kernels,
    beside the nearest PyTorch calls on the same inputs (``torch.topk``
    per tile on a precomputed |D|; ``index_put_(accumulate=True)`` into a
    tile-major buffer), for the kernel line's refresh rows."""
    import torch
    from repro_torch.kernels.block_topk import diff_topk_payload, to_tiles
    from repro_torch.kernels.scatter_accum import block_scatter_accumulate
    from repro_torch.second_order.fednl_precond import _shape2d
    from repro_torch.tree import tree_leaves

    inputs = []
    for o, hh in zip(tree_leaves(obs), tree_leaves(h)):
        shape2 = _shape2d(hh.shape)
        inputs.append((o.reshape((SILOS,) + shape2), hh.reshape(shape2),
                       tuple(-(-x // BLOCK) for x in shape2)))

    def k1():
        return [diff_topk_payload(o2, h2, K_PER_BLOCK, BLOCK)[:2]
                for o2, h2, _ in inputs]

    payloads = k1()

    def k4():
        return [block_scatter_accumulate(v, i, grid, BLOCK)
                for (v, i), (_, _, grid) in zip(payloads, inputs)]

    rows = {}
    for name, fn in (("diff_topk_payload", k1), ("block_scatter_accumulate", k4)):
        _, prof = profile_rows(fn)
        rows[name] = {
            "ms": time_cuda(fn, reps=3, warmup=1),
            "device_ms": sum(ms for row, ms, _ in prof
                             if REFRESH_KERNELS[name] in row),
            "bound_ms": refresh_bound[name][0],
            "bound_by": refresh_bound[name][1]}
    mags = [torch.abs(to_tiles(o2 - h2, BLOCK)) for o2, h2, _ in inputs]
    rows["diff_topk_payload"]["library_ms"] = time_cuda(
        lambda: [torch.topk(m, K_PER_BLOCK, dim=-1) for m in mags],
        reps=2, warmup=1)
    rows["diff_topk_payload"]["library_call"] = (
        "torch.topk(|D| per tile, 2048), |D| tiled beforehand")
    del mags
    flat = []
    for (v, i), (o2, _, _) in zip(payloads, inputs):
        nblk = i.shape[1]
        tile_of = torch.arange(nblk, device=i.device)[None, :, None] * BLOCK ** 2
        flat.append((torch.zeros(nblk * BLOCK ** 2, device=v.device),
                     (i.to(torch.int64) + tile_of).reshape(-1), v.reshape(-1)))
    rows["block_scatter_accumulate"]["library_ms"] = time_cuda(
        lambda: [buf.index_put_((ix,), vv, accumulate=True)
                 for buf, ix, vv in flat], reps=2, warmup=1)
    rows["block_scatter_accumulate"]["library_call"] = (
        "index_put_(accumulate=True) into (tiles, block^2), tile-major layout")
    del flat, payloads
    torch.cuda.empty_cache()
    print(json.dumps({"refresh_kernels": rows}), flush=True)
    return rows


# -- phase 6: PowerSGD (K8) and dense block top-k (K6) ---------------------------


def powersgd_and_dense_topk(dev, seed: int, mats: dict, K, err: dict) -> dict:
    import torch
    from repro_torch.kernels.block_topk import block_topk, block_topk_ref
    from repro_torch.kernels.tiled_matmul import powersgd_rank_r, subspace_iteration_ref

    K.reset_launches()
    outs = {}
    for name, (m, k) in mats.items():
        outs[name] = [block_topk(m, k, BLOCK)]
        for r in (1, 2):
            outs[name].append(powersgd_rank_r(m, r, seed=seed))
    torch.cuda.synchronize()
    launches = counts(K)
    print(f"# PowerSGD + dense top-k path: launches {json.dumps(launches)}",
          flush=True)
    for kname in ("block_topk", "tiled_matmul", "tiled_matmul:small_n",
                  "tiled_matmul:small_k"):
        require(launches[kname] > 0, f"kernel {kname} was not launched")
    for name, (m, k) in mats.items():
        dense = outs[name][0]
        require(torch.equal(dense, block_topk_ref(m[None], k, BLOCK)[0]),
                f"block_topk differs from its plain version on {name}")
        for r, got in zip((1, 2), outs[name][1:]):
            g = torch.Generator(device=dev).manual_seed(seed)
            q = torch.randn((m.shape[1], r), generator=g, dtype=torch.float32,
                            device=dev)
            want = subspace_iteration_ref(m, torch.linalg.qr(q)[0])
            require(bool(torch.isfinite(got).all()), f"powersgd on {name}: nan")
            rel = max_rel(got.float(), want.float())
            require(rel <= 1e-5, f"powersgd_rank_r r={r} on {name} off by "
                    f"{rel:.2e} of the largest entry")
            err["tiled_matmul"] = max(err["tiled_matmul"], rel)
    err["block_topk"] = 0.0
    print("# K6 bitwise and K8's power iteration to 1e-5 (largest entry) "
          "match their plain versions", flush=True)
    return launches


# -- phase 7: FedNL lines 5-6 by the fused Hessian update (K7) ------------------


def hess_update_w8a(dev, prob, x0, embed: dict, K, err: dict) -> dict:
    import torch
    from repro_torch.core import FedNL, make_compressor
    from repro_torch.kernels.hess_update import hess_update, hess_update_ref

    n = prob["n"]
    alg = FedNL(prob["grad"], prob["hess"], make_compressor("blocktopk", 8),
                option=2, mu=MU)
    state = alg.step(alg.init(x0, n))            # H_i differs from the Hessians
    hesses = prob["hess"](state.x)
    shape = tuple(hesses.shape[1:])
    payloads, l_i = alg._uplink_diff_payloads(hesses, state.h_local)
    s_i = alg._local_hessians(payloads, shape).contiguous()   # a cropped view
    K.reset_launches()
    out, l = hess_update(state.h_local, hesses, s_i, alg.alpha)
    torch.cuda.synchronize()
    launches = counts(K)
    require(launches["hess_update"] > 0, "hess_update was not launched")
    nxt = alg.step(state)
    require(torch.equal(out, nxt.h_local),
            "hess_update's H_i + alpha S_i differs from FedNL.step's")
    rel = float(torch.max(torch.abs(l.double() - l_i) / l_i))
    require(rel <= 1e-6, f"hess_update's l_i off FedNL.step's by {rel:.2e}")
    want = hess_update_ref(state.h_local, hesses, s_i, alg.alpha)
    require(torch.equal(out, want[0]), "hess_update differs from its plain "
            "version (w8a)")
    rel = max(rel, float(torch.max(torch.abs(l - want[1]) / want[1])))
    # the embed-sized H of the optimizer path: H, D = silo 0's
    # observation, S = the learned increment
    h, d = embed["h"], embed["obs"][0]
    s = embed["h_new"] - h
    got = hess_update(h, d, s, 1.0)
    want = hess_update_ref(h, d, s, 1.0)
    require(torch.equal(got[0], want[0]), "hess_update differs from its "
            "plain version (embed)")
    rel = max(rel, float(torch.abs(got[1] - want[1]) / want[1]))
    require(rel <= 1e-6, f"hess_update l off by {rel:.2e}")
    err["hess_update"] = rel
    print(f"# K7: FedNL lines 5-6 on w8a equal FedNL.step's H_i bitwise and "
          f"its l_i to {rel:.2e} rel; plain versions match", flush=True)
    return dict(launches=launches, w8a=(state.h_local, hesses, s_i, alg.alpha),
                embed=(h, d, s))


# -- phase 8: timings ------------------------------------------------------------


def fednl_round_times(prob, x0) -> tuple[dict, dict]:
    import torch
    from repro_torch.core import FedNL, make_compressor

    n = prob["n"]
    round_ms = {}
    for family, level in LEVELS.items():
        for option in (1, 2):
            alg = FedNL(prob["grad"], prob["hess"], make_compressor(family, level),
                        option=option, mu=MU)
            state = alg.init(x0, n)
            times = []
            for _ in range(8):
                ms, state = host_ms(lambda: alg.step(state))
                times.append(ms)
            round_ms[f"{family}/option{option}"] = statistics.median(times[2:])
    # where a round's device time goes: 3 rounds per compressor under the
    # profiler (the profiler slows the host, so wall times run higher)
    breakdown = {}
    for family, level in LEVELS.items():
        alg = FedNL(prob["grad"], prob["hess"], make_compressor(family, level),
                    option=2, mu=MU)
        state = [alg.step(alg.init(x0, n))]

        def three():
            for _ in range(3):
                state[0] = alg.step(state[0])

        prof = profile_window(three)
        for key in ("wall_ms", "device_busy_ms"):
            prof[key] /= 3
        prof["top_device_ms"] = [[name, ms / 3]
                                 for name, ms in prof["top_device_ms"]]
        breakdown[f"{family}/option2"] = prof
    return round_ms, breakdown


def k2_timings(dev, vals, idx, shape, symmetric) -> dict:
    """K2's wrapper ms, device ms and launches per call of its accum_*
    kernels as the profiler records them (a launch per sort pass of
    count, scan and place, and one sum, by the plan: checked when the
    profile is complete), plain ms, bound and library ms on one input.
    The bound: pairs in once, the dense sum out once; one add per pair
    (two when symmetric)."""
    import torch
    from repro_torch.kernels.scatter_accum import (
        plan,
        scatter_accumulate,
        scatter_accumulate_ref,
    )

    n, k = vals.shape
    p = plan(n, k, shape[0], shape[1], symmetric, vals.element_size())
    cells = shape[0] * shape[1]
    b_ms, b_by = bound(vals.numel() * (vals.element_size() + 4)
                       + cells * vals.element_size(),
                       {"f64": vals.numel() * (2 if symmetric else 1)})
    flat = torch.zeros(cells, dtype=vals.dtype, device=dev)
    i64 = idx.reshape(-1).to(torch.int64)
    v = vals.reshape(-1)
    if symmetric:                          # the library call's own mirror
        r, c = i64 // shape[1], i64 % shape[1]
        i64 = torch.cat([i64, torch.where(r != c, c * shape[1] + r, -1)])
        v = torch.cat([v, v])
    keep = i64 >= 0
    i64, v = i64[keep], v[keep]

    def call():
        return scatter_accumulate(vals, idx, shape, symmetric=symmetric)

    # a call's device time and launches, kernel by kernel
    names = ("accum_count_kernel", "accum_scan_kernel", "accum_place_kernel",
             "accum_sum_kernel")
    split = device_per_call(call, names)
    per_call = sum(split["launches"].values())
    require(not split["complete"] or per_call == 3 * p.passes + 1,
            f"scatter_accumulate launched {per_call} kernels a call, its "
            f"plan {3 * p.passes + 1} ({p.passes} sort passes)")
    return dict(
        ms=time_cuda(call),
        device_ms=sum(split["device_ms"].values()),
        device_ms_by_kernel=split["device_ms"],
        launches_per_call=per_call,
        launches_per_call_by_kernel=split["launches"],
        device_profile_complete=split["complete"],
        plain_ms=time_cuda(lambda: scatter_accumulate_ref(
            vals, idx, shape, symmetric=symmetric)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_cuda(lambda: flat.index_put_((i64,), v,
                                                     accumulate=True)))


def k2_measure(dev, prob, x0, k3_pay) -> dict:
    """K2's timings (``k2_timings``) early in the run, before the long
    phases fill the profiler: w8a's Top-K payloads (plain and symmetric),
    the K3 shape's payloads (plain and symmetric), and the K3 shape with
    none and with all of each silo's cells drawn from the hot cells."""
    from repro_torch.core import make_compressor

    d = prob["d"]
    diff = prob["hess"](x0) - prob["hess"](prob["xstar"])
    out = {}
    for key, family in (("w8a", "topk"), ("w8a_sym", "topk-sym")):
        pay = make_compressor(family, d).compress(diff)
        out[key] = k2_timings(dev, pay.values.contiguous(),
                              pay.indices.contiguous(), (d, d),
                              family == "topk-sym")
    for sym in (False, True):
        out["k3_sym" if sym else "k3"] = k2_timings(
            dev, k3_pay.values, k3_pay.indices, (K3_D, K3_D), sym)
    for hot in (0.0, 1.0):
        pay = k3_payloads(dev, seed=4, hot=hot)
        out[f"k3_hot{int(100 * hot)}"] = {
            key: val for key, val in k2_timings(
                dev, pay.values, pay.indices, (K3_D, K3_D), False).items()
            if key in ("ms", "device_ms", "launches_per_call",
                       "device_profile_complete")}
    print(f"# K2 timings: {json.dumps(out)}", flush=True)
    return out


def kernel_line(dev, prob, x0, paths: dict, inputs: dict, err: dict) -> list:
    """One entry per kernel of phases 3-7 (K1-K8): launches per path
    (``paths``, and per route for K8), times at the inputs its path gives
    it (``inputs``), bound, plain and library times (K2's and K3's from
    phase 4, ``inputs["k2"]``). K9's entry is made by phase 9."""
    import torch
    from repro_torch.kernels.block_topk import (
        block_topk,
        block_topk_payload,
        block_topk_payload_ref,
        block_topk_ref,
        diff_topk_payload,
        diff_topk_payload_ref,
        to_tiles,
    )
    from repro_torch.kernels.hess_update import hess_update, hess_update_ref
    from repro_torch.kernels.scatter_accum import (
        block_scatter_accumulate,
        block_scatter_accumulate_ref,
    )
    from repro_torch.kernels.tiled_matmul import tiled_matmul, tiled_matmul_ref

    def launches(name, only=None):
        by = {path: counts[name] for path, counts in paths.items()
              if counts.get(name) and (only is None or path in only)}
        return sum(by.values()), by

    d, n = prob["d"], prob["n"]
    # FedNL's inputs on w8a: Hessians at x0 against Hessians at x*
    h_new = prob["hess"](x0)
    h_old = prob["hess"](prob["xstar"])
    bvals, bidx, _ = diff_topk_payload(h_new, h_old, k=8)
    nblk = bvals.shape[1]
    grid = (-(-d // 128),) * 2
    kernels = []

    # K1: read a and b once; write k (value, index) pairs and one partial
    # per tile; a - b, the square-add and the f32 magnitude per entry, then
    # the key and the two bracket compares per padded tile entry
    total, by = launches("diff_topk_payload")
    b_ms, b_by = bound(2 * n * d * d * 8 + n * nblk * (8 * (8 + 4) + 8),
                       {"f64": 3 * n * d * d,
                        "f32": (K1_OPS_PER_ENTRY - 3) * n * nblk * 128 * 128})
    mags = torch.abs(h_new - h_old).reshape(n, 1, d * d)
    kernels.append(dict(
        name="diff_topk_payload", route="cuda",
        source="src/repro_torch/csrc/block_topk.cu",
        replaces="src/repro/kernels/block_topk/kernel.py:197",
        launches=total, launches_by_path=by,
        max_abs_err=err["diff_topk_payload"],
        ms=time_cuda(lambda: diff_topk_payload(h_new, h_old, k=8)),
        device_ms=device_ms(lambda: diff_topk_payload(h_new, h_old, k=8),
                            "diff_topk_payload_kernel<double, false"),
        plain_ms=time_cuda(lambda: diff_topk_payload_ref(h_new, h_old, k=8),
                           reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="w8a: (142, 300, 300) f64, k=8, block=128",
        nearest_call="torch.topk(|D|, 8) per matrix, D formed beforehand",
        nearest_call_ms=time_cuda(lambda: torch.topk(mags, 8, dim=-1)),
        refresh_shape="a fednl_precond refresh: 4 silos x all 14 qwen2-0.5b "
                      "tensors, one shared H, f32, k=2048, block=128",
        **{f"refresh_{key}": val for key, val in
           inputs["refresh"]["diff_topk_payload"].items()}))

    # K2 at w8a: Top-K's payloads, plain and symmetric (timed in phase 4)
    k2 = inputs["k2"]
    total, by = launches("scatter_accumulate",
                         [path for path in paths
                          if not path.endswith("d2048")])
    kernels.append(dict(
        name="scatter_accumulate", route="cuda",
        source="src/repro_torch/csrc/scatter_accum.cu",
        replaces="src/repro/kernels/scatter_accum/kernel.py:135",
        launches=total, launches_by_path=by,
        max_abs_err=err["scatter_accumulate"],
        max_abs_err_is="max |card - plain version on CPU copies| over "
                       "phase 3's f64 checks below d = 1,025 (held bit for "
                       "bit there)",
        **k2["w8a"],
        shape="w8a Top-K: 142 x 300 pairs into (300, 300) f64",
        library_call="index_put_(accumulate=True) into a flat (d*d) buffer "
                     "(symmetric: the mirrors appended)",
        **{f"symmetric_{key}": val for key, val in k2["w8a_sym"].items()},
        symmetric_shape="w8a symmetric Top-K: 142 x 300 lower-triangular "
                        "pairs and their mirrors into (300, 300) f64"))

    # K3: the same kernels at the TPU's output-tiled shape
    total, by = launches("scatter_accumulate",
                         [path for path in paths if path.endswith("d2048")])
    kernels.append(dict(
        name="scatter_accumulate_tiled", route="cuda",
        source="src/repro_torch/csrc/scatter_accum.cu",
        replaces="src/repro/kernels/scatter_accum/kernel.py:219",
        wrapper="scatter_accumulate",
        launches=total, launches_by_path=by,
        max_abs_err=err["scatter_accumulate_tiled"],
        max_abs_err_is="max |card - plain version on CPU copies| over "
                       "phase 3's f64 checks at d >= 1,025 and "
                       "TopK.aggregate's mean at the K3 shape (held bit "
                       "for bit)",
        **k2["k3"],
        shape=f"{K3_N} x {K3_D} Top-K pairs into ({K3_D}, {K3_D}) f64, "
              "half of each silo's cells from 4,096 hot cells (a chosen "
              "share)",
        library_call="index_put_(accumulate=True) into a flat (d*d) buffer",
        **{f"symmetric_{key}": val for key, val in k2["k3_sym"].items()},
        **{f"{hot}_{key}": val for hot in ("hot0", "hot100")
           for key, val in k2[f"k3_{hot}"].items()}))

    # K4
    total, by = launches("block_scatter_accumulate")
    b_ms, b_by = bound(bvals.numel() * 12 + nblk * 128 * 128 * 8,
                       {"f64": bvals.numel()})
    tiles = torch.zeros(nblk * 128 * 128, dtype=torch.float64, device=dev)
    tile_of = torch.arange(nblk, device=dev)[None, :, None] * (128 * 128)
    bflat = (bidx.to(torch.int64) + tile_of).reshape(-1)
    kernels.append(dict(
        name="block_scatter_accumulate", route="cuda",
        source="src/repro_torch/csrc/scatter_accum.cu",
        replaces="src/repro/kernels/scatter_accum/kernel.py:282",
        launches=total, launches_by_path=by,
        max_abs_err=err["block_scatter_accumulate"],
        ms=time_cuda(lambda: block_scatter_accumulate(bvals, bidx, grid, 128)),
        device_ms=device_ms(lambda: block_scatter_accumulate(bvals, bidx, grid,
                                                             128),
                            "block_scatter_kernel<double"),
        plain_ms=time_cuda(lambda: block_scatter_accumulate_ref(bvals, bidx,
                                                                grid, 128)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_cuda(lambda: tiles.index_put_((bflat,), bvals.reshape(-1),
                                                      accumulate=True)),
        shape="w8a Block-Top-K: (142, 9, 8) pairs f64",
        library_call="index_put_(accumulate=True) into (tiles, block^2), "
                     "tile-major layout",
        refresh_shape="a fednl_precond refresh: K1's payloads of 4 silos x "
                      "all 14 qwen2-0.5b tensors, f32, k=2048, block=128",
        **{f"refresh_{key}": val for key, val in
           inputs["refresh"]["block_scatter_accumulate"].items()}))
    del h_new, h_old, mags, tiles

    # K5 on the optimizer's largest input: embed, 4 silos of f32
    # observations, k = 2048 of 128^2
    x = inputs["embed"]["obs"]
    total, by = launches("block_topk_payload")
    ntile = x.shape[0] * (-(-x.shape[1] // BLOCK)) * (-(-x.shape[2] // BLOCK))
    b_ms, b_by = bound(x.numel() * 4 + ntile * K_PER_BLOCK * 8,
                       {"f32": (K1_OPS_PER_ENTRY - 3) * ntile * BLOCK * BLOCK})
    mag = torch.abs(to_tiles(x, BLOCK))
    kernels.append(dict(
        name="block_topk_payload", route="cuda",
        source="src/repro_torch/csrc/block_topk.cu",
        replaces="src/repro/kernels/block_topk/kernel.py:171",
        launches=total, launches_by_path=by,
        max_abs_err=err["block_topk_payload"],
        ms=time_cuda(lambda: block_topk_payload(x, K_PER_BLOCK, BLOCK), reps=10),
        device_ms=device_ms(lambda: block_topk_payload(x, K_PER_BLOCK, BLOCK),
                            "block_topk_payload_kernel<float", reps=5),
        plain_ms=time_cuda(lambda: block_topk_payload_ref(x, K_PER_BLOCK,
                                                          BLOCK),
                           reps=2, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_cuda(lambda: torch.topk(mag, K_PER_BLOCK, dim=-1),
                             reps=5, warmup=1),
        shape="qwen2 embed obs: (4, 151936, 896) f32, k=2048, block=128",
        library_call="torch.topk(|x| per tile, 2048) on a tiled copy"))
    del mag

    # K6 on layers.ffn.wg[0], k = 2048 of 128^2
    wg0 = inputs["wg0"]
    total, by = launches("block_topk")
    ntile = (-(-wg0.shape[0] // BLOCK)) * (-(-wg0.shape[1] // BLOCK))
    b_ms, b_by = bound(wg0.numel() * 8,
                       {"f32": (K1_OPS_PER_ENTRY - 3) * ntile * BLOCK * BLOCK})
    wt = to_tiles(wg0[None], BLOCK)[0]
    wmag = torch.abs(wt)

    def topk_scatter():
        _, i = torch.topk(wmag, K_PER_BLOCK, dim=-1)
        return torch.zeros_like(wt).scatter_(1, i, torch.gather(wt, 1, i))

    kernels.append(dict(
        name="block_topk", route="cuda",
        source="src/repro_torch/csrc/block_topk.cu",
        replaces="src/repro/kernels/block_topk/kernel.py:57",
        launches=total, launches_by_path=by, max_abs_err=err["block_topk"],
        ms=time_cuda(lambda: block_topk(wg0, K_PER_BLOCK, BLOCK)),
        device_ms=device_ms(lambda: block_topk(wg0, K_PER_BLOCK, BLOCK),
                            "block_topk_dense_kernel<float"),
        plain_ms=time_cuda(lambda: block_topk_ref(wg0[None], K_PER_BLOCK,
                                                  BLOCK), reps=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_cuda(topk_scatter, reps=10),
        shape="layers.ffn.wg[0]: (896, 4864) f32, k=2048, block=128",
        library_call="torch.topk(|x| per tile, 2048) + scatter into zeros, "
                     "on a tiled copy"))

    # K7 on the embed-sized H (f32): three reads, one write
    h, dd, s = inputs["hess_update"]["embed"]
    total, by = launches("hess_update")
    b_ms, b_by = bound(h.numel() * 16, {"f32": 5 * h.numel()})

    def axpy_norm():
        return torch.add(h, s, alpha=1.0), torch.linalg.vector_norm(
            (h - dd).float())

    kernels.append(dict(
        name="hess_update", route="cuda",
        source="src/repro_torch/csrc/hess_update.cu",
        replaces="src/repro/kernels/hess_update/kernel.py:32",
        launches=total, launches_by_path=by, max_abs_err=err["hess_update"],
        max_abs_err_is="relative error of l (out is bitwise)",
        ms=time_cuda(lambda: hess_update(h, dd, s, 1.0), reps=20),
        device_ms=device_ms(lambda: hess_update(h, dd, s, 1.0),
                            "hess_update_kernel<float>"),
        plain_ms=time_cuda(lambda: hess_update_ref(h, dd, s, 1.0), reps=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_cuda(axpy_norm, reps=20),
        shape="qwen2 embed H: (151936, 896) f32",
        library_call="torch.add(h, s, alpha) + "
                     "torch.linalg.vector_norm((h - d).float())",
        w8a_ms=time_cuda(lambda: hess_update(*inputs["hess_update"]["w8a"])),
        w8a_shape="(142, 300, 300) f64"))

    # K8: the power iteration's three products on wg[0] with r = 2, each
    # bound by reading A (a, b) or writing C (c) once: (a) M @ Q, small-N
    # route on a row-major A; (b) M^T @ P, small-N route on a column-major
    # view, K in chunks summed by a second kernel; (c) P @ Q^T, small-K
    total, by = launches("tiled_matmul")
    routes = {r: sum(c.get(f"tiled_matmul:{r}", 0) for c in paths.values())
              for r in ("small_n", "small_k", "tiled")}
    q = torch.linalg.qr(torch.randn((wg0.shape[1], 2), device=dev))[0]
    p = torch.linalg.qr(torch.randn((wg0.shape[0], 2), device=dev))[0]
    mm, kk = wg0.shape
    # each of the three reads or writes one (896, 4864) f32 matrix
    b_ms, b_by = bound((mm * kk + kk * 2 + mm * 2) * 4, {"f32": 2 * mm * kk * 2})
    products = {"b": (wg0.T, p, ("tiled_matmul_small_n_cols_kernel",
                                 "tiled_matmul_sum_partials_kernel")),
                "c": (p, q.T, ("tiled_matmul_small_k_kernel",))}
    more = {}
    for key, (a, b, names) in products.items():
        more.update({
            f"{key}_ms": time_cuda(lambda: tiled_matmul(a, b)),
            f"{key}_device_ms": sum(device_ms(lambda: tiled_matmul(a, b), n)
                                    for n in names),
            f"{key}_bound_ms": b_ms, f"{key}_bound_by": b_by,
            f"{key}_library_ms": time_cuda(lambda: torch.matmul(a, b))})
    # the tiled route, which no path's product takes, on a square product:
    # held to its plain version here, then timed
    from repro_torch.kernels import ROUTES

    sq_a, sq_b = wg0.T, wg0[:, :896]
    tiled_before = ROUTES["tiled_matmul"]["tiled"]
    got = tiled_matmul(sq_a, sq_b)
    require(ROUTES["tiled_matmul"]["tiled"] == tiled_before + 1,
            "the square product did not take K8's tiled route")
    want = tiled_matmul_ref(sq_a, sq_b)
    square_err = float(torch.max(torch.abs(got - want))
                       / torch.max(torch.abs(want)))
    require(square_err <= 1e-5, f"tiled_matmul's tiled route off its plain "
            f"version by {square_err:.2e} of the largest entry")
    del got, want
    big_ms = time_cuda(lambda: tiled_matmul(sq_a, sq_b), reps=10)
    big_bound, _ = bound((2 * kk * 896 + 896 * 896) * 4,
                         {"f32": 2 * kk * 896 * 896})
    kernels.append(dict(
        name="tiled_matmul", route="cuda",
        source="src/repro_torch/csrc/tiled_matmul.cu",
        replaces="src/repro/kernels/tiled_matmul/kernel.py:31",
        launches=total, launches_by_path=by, launches_by_route=routes,
        max_abs_err=err["tiled_matmul"],
        max_abs_err_is="max |error| / max |entry| of powersgd_rank_r",
        ms=time_cuda(lambda: tiled_matmul(wg0, q)),
        device_ms=device_ms(lambda: tiled_matmul(wg0, q),
                            "tiled_matmul_small_n_rows_kernel"),
        plain_ms=time_cuda(lambda: tiled_matmul_ref(wg0, q)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_cuda(lambda: torch.matmul(wg0, q)),
        shape="(a) wg[0] @ Q: (896, 4864) x (4864, 2) f32",
        library_call="torch.matmul f32, TF32 off",
        **more,
        b_shape="(b) wg[0]^T @ P: (4864, 896) view x (896, 2)",
        c_shape="(c) P @ Q^T: (896, 2) x (2, 4864) view",
        square_max_abs_err=square_err, square_ms=big_ms,
        square_bound_ms=big_bound,
        square_library_ms=time_cuda(lambda: torch.matmul(sq_a, sq_b), reps=10),
        square_shape="wg[0]^T @ wg[0][:, :896]: (4864, 896) x (896, 896), "
                     "tiled route"))

    return kernels


# -- phase 9: qwen2-0.5B serving, prefill through K9 -------------------------


def sdpa(q, k, v, window=None):
    """PyTorch's causal attention over (B, H, T, hd), fused backends only:
    the library yardstick of K9's time and of its bf16 error. With a
    sliding ``window``, a boolean (T, T) mask of i - window < j <= i (the
    flash backend takes no mask, so the efficient or cuDNN one runs)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        if window is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        t = q.shape[-2]
        i = torch.arange(t, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def check_flash(q, k, v, heads, err: dict, what: str, window=None) -> None:
    """K9 against its plain version on ``heads``, one head at a time
    (the plain version's (T, T) scores of one head fit the card at any
    T of the path). f32 (the FFMA route) to 2e-5. bf16 (the wgmma route,
    which rounds P to bf16 before P V) against the plain version in f32
    on the same bf16 inputs, not rounded: max error within 2 * 2^-8 of
    the head's max |oracle|, mean error within 1.5 x SDPA's on the same
    head, each row's max error within 4 * 2^-8 of its own max |oracle|
    (``bf16_attention_check``); the worst ratios go to ``err``. With a
    sliding ``window``, K9, its plain version and SDPA all take it."""
    import torch
    from repro_torch.kernels.flash_attention import (
        bf16_attention_check,
        flash_attention,
        flash_attention_ref,
    )

    out = flash_attention(q, k, v, window=window)
    n_rep = q.shape[2] // k.shape[2]
    for b in range(q.shape[0]):
        for h in heads:
            qh, kh, vh = q[b, :, h], k[b, :, h // n_rep], v[b, :, h // n_rep]
            got = out[b, :, h]
            if q.dtype == torch.float32:
                want = flash_attention_ref(qh[None], kh[None], vh[None],
                                           window)[0]
                e = float(torch.max(torch.abs(got - want)))
                require(e <= 2e-5, f"flash_attention off its plain version by "
                        f"{e:.2e} ({what}, head {h})")
                err["flash_attention"] = max(err["flash_attention"], e)
            else:
                want = flash_attention_ref(qh[None].float(), kh[None].float(),
                                           vh[None].float(), window)[0]
                r = bf16_attention_check(got, want, sdpa(
                    qh[None, None], kh[None, None], vh[None, None],
                    window)[0, 0])
                require(r["ok"], f"flash_attention (bf16) off the f32 oracle "
                        f"({what}, head {h}): {json.dumps(r)}")
                worst = err.setdefault("flash_attention_bf16", {
                    "max_abs_err": 0.0, "max_err_over_limit": 0.0,
                    "mean_err_over_sdpa": 0.0, "row_err_over_limit": 0.0})
                worst["max_abs_err"] = max(worst["max_abs_err"], r["max_err"])
                worst["row_err_over_limit"] = max(
                    worst["row_err_over_limit"], r["row_err"] / r["row_limit"])
                worst["max_err_over_limit"] = max(worst["max_err_over_limit"],
                                                  r["max_err"] / r["max_limit"])
                worst["mean_err_over_sdpa"] = max(
                    worst["mean_err_over_sdpa"],
                    r["mean_err"] / max(r["library_mean_err"], 1e-30))
            del want


def serve_cli_times(seed: int) -> dict:
    """Run the serving CLI (``python -m repro_torch.launch.serve``) on the
    full model, batch 4, prompt 64, 32 greedy tokens, in a process of its
    own; its host seconds for the prompt and the decode loop."""
    src = Path(__file__).resolve().parent / "src"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen2-0.5b", "--batch", str(GEN_B), "--prompt-len", str(GEN_PROMPT),
           "--gen", str(GEN_N), "--greedy", "--seed", str(seed)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(src)})
    found = re.search(r"in ([0-9.]+)s; generated .* in ([0-9.]+)s", out.stdout)
    require(out.returncode == 0 and found is not None,
            f"the serving CLI failed: {out.stdout[-500:]} {out.stderr[-1500:]}")
    prompt_s, decode_s = float(found.group(1)), float(found.group(2))
    return {"cli_prompt_s": prompt_s, "cli_decode_s": decode_s,
            "tokens_per_s": GEN_B * GEN_N / decode_s,
            "decode_ms_per_token": decode_s * 1e3 / GEN_N,
            "prompt_ms_per_token": prompt_s * 1e3 / GEN_PROMPT}


def flash_kernel_entry(q, k, v, err: dict) -> dict:
    """K9's kernel-line entry, launches aside, on layer 0's prefill inputs
    (bf16, the wgmma route): read q, k, v once and write out; 4 hd flops
    per (query, key <= query) pair and head, at the bf16 tensor-core rate.
    The FFMA route is timed on the same inputs in f32. Timed before the
    decode loops: the profiler records few launches, or none, after a
    million of them in one process (tools/decode_profile.py)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    b, t, h, hd = q.shape
    n_rep = h // k.shape[2]
    flops = 4 * b * h * hd * t * (t + 1) / 2
    b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                       {"bf16": flops})

    def plain_all_heads():
        for head in range(h):
            flash_attention_ref(q[0, :, head][None], k[0, :, head // n_rep][None],
                                v[0, :, head // n_rep][None])

    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(n_rep, dim=2).transpose(1, 2) for x in (k, v))

    def library():
        return sdpa(qt, kt, vt)

    dev_ms = device_ms(lambda: flash_attention(q, k, v),
                       "flash_attention_kernel_wgmma", reps=10)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    bf16 = err["flash_attention_bf16"]
    entry = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:53",
        max_abs_err=bf16["max_abs_err"],
        max_abs_err_is="bf16 (wgmma) against the f32 oracle on the same bf16 "
                       "inputs, all 14 heads at T=4000 and heads 0, 13 at "
                       "T=32768; see bf16_check",
        bf16_check={"max_err_over_limit": bf16["max_err_over_limit"],
                    "mean_err_over_sdpa": bf16["mean_err_over_sdpa"],
                    "row_err_over_limit": bf16["row_err_over_limit"],
                    "limits": "max err <= 2 * 2^-8 max |oracle|, mean err <= "
                              "1.5 x SDPA's, per head; each row's max err <= "
                              "4 * 2^-8 of its max |oracle|"},
        ms=time_cuda(lambda: flash_attention(q, k, v), reps=20),
        device_ms=dev_ms, tflops=flops / dev_ms / 1e9,
        plain_ms=time_cuda(plain_all_heads, reps=1, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_cuda(library, reps=20),
        shape=f"qwen2 layer 0 prefill: q ({b}, {t}, {h}, {hd}), k and v "
              f"({b}, {t}, {k.shape[2]}, {hd}) bf16, bq=bk=128",
        plain_is="the plain version on all 14 heads, one head at a time",
        tiles_ms={f"bq={bq},bk={bk}": time_cuda(
            lambda: flash_attention(q, k, v, bq, bk), reps=5, warmup=1)
            for bq in (64, 128) for bk in (64, 128)},
        library_call="scaled_dot_product_attention(is_causal=True), fused "
                     "backends only, KV heads expanded beforehand",
        ffma_source="src/repro_torch/csrc/flash_attention.cu",
        ffma_f32_max_abs_err=err["flash_attention"],
        ffma_f32_ms=time_cuda(lambda: flash_attention(q32, k32, v32), reps=2,
                              warmup=1),
        ffma_f32_device_ms=device_ms(lambda: flash_attention(q32, k32, v32),
                                     "flash_attention_kernel<", reps=2),
        ffma_f32_shape="the same inputs in f32")
    del q32, k32, v32
    torch.cuda.empty_cache()
    return entry


def window_pairs(t: int, window: int) -> int:
    """(query, key) pairs a causal pass with a sliding window computes:
    sum over i < t of min(i + 1, window)."""
    if t <= window:
        return t * (t + 1) // 2
    return window * t - window * (window - 1) // 2


def param_count(shapes) -> int:
    import math

    from repro_torch.tree import tree_leaves

    return sum(math.prod(s.shape) for s in tree_leaves(shapes))


def decode_vs_forward(model, params, toks, dev, K, frames=None) -> dict:
    """Teacher-forced forward logits against token-by-token decode logits
    at every position, and the launches of the forward. An
    encoder-decoder's forward takes ``frames`` and its decode cache the
    encoder's output on them."""
    import torch
    from repro_torch.launch.steps import make_prefill, make_serve_step

    b, t = toks.shape
    batch = {"tokens": toks} if frames is None else {"tokens": toks,
                                                     "frames": frames}
    K.reset_launches()
    fwd = make_prefill(model)(params, batch)
    launches = counts(K)
    serve = make_serve_step(model)
    cache = model.init_cache(b, t, dev)
    if frames is not None:
        with torch.no_grad():
            cache["enc"] = model._encode(params, frames)
    worst = torch.zeros((), device=dev)
    agree = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(t):
        lg, cache = serve(params, cache, toks[:, p:p + 1], p)
        worst = torch.maximum(worst, (lg[:, 0].float() - fwd[:, p].float())
                              .abs().max())
        agree += (lg[:, 0].argmax(-1) == fwd[:, p].argmax(-1)).sum()
    scale = float(fwd.float().abs().max())
    return {"shape": f"B={b}, T={t}, {model.cfg.dtype}",
            "max_abs_gap": float(worst), "max_abs_logit": scale,
            "gap_in_bf16_steps_of_max": float(worst) / (scale * 2.0 ** -7),
            "argmax_agreement": int(agree) / (b * t), "launches": launches}


def greedy_vs_forward(arch: str, params, seed: int, dev, K,
                      batch: int = SMALL_GEN_B, prompt: int = SMALL_GEN_PROMPT,
                      n: int = SMALL_GEN_N) -> dict:
    """``generate`` at full width (``batch`` sequences, a ``prompt``-token
    prompt, ``n`` greedy tokens) and its tokens against the teacher-forced
    forward's argmax."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import build_model

    K.reset_launches()
    seqs = generate(arch, smoke=False, batch=batch, prompt_len=prompt, gen=n,
                    seed=seed, greedy=True, device=dev, params=params)
    launches = counts(K)
    vocab = get_config(arch).vocab
    require(seqs.shape == (batch, prompt + n)
            and int(seqs.min()) >= 0 and int(seqs.max()) < vocab,
            f"{arch}: generate returned misshapen or out-of-range tokens")
    fwd = make_prefill(build_model(get_config(arch)))(
        params, {"tokens": seqs[:, :-1]})
    picked = fwd[:, prompt - 1:].argmax(-1)
    agree = float((picked == seqs[:, prompt:]).float().mean())
    require(agree >= ARGMAX_AGREE, f"{arch}: generate's greedy tokens match "
            f"the forward's argmax at {agree:.3f} of positions")
    return {"shape": f"batch {batch}, prompt {prompt}, {n} greedy",
            "greedy_vs_forward_argmax": agree, "launches": launches}


def prefill_report(model, params, batch, K, k9_layers: int,
                   cuda_only: bool = False) -> dict:
    """A bf16 prefill: host ms of a first call and two more, launches, peak
    memory, and the device time by kernel group from one profiled call
    (``cuda_only``: the device's activity alone, ``profiled``).
    K9 must launch ``k9_layers`` times by its wgmma route and never by
    its FFMA one, by the counters and by the profile (a session may drop
    records, ``device_ms``: up to six sessions). Where no session records
    a device event at all, the counters alone show K9's launches and the
    device time by group is reported as not measured."""
    import torch
    from repro_torch.launch.steps import make_prefill

    prefill = make_prefill(model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    K.reset_launches()
    first_ms, logits = host_ms(lambda: prefill(params, batch))
    launches = counts(K)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(launches["flash_attention:wgmma"] == k9_layers
            and launches["flash_attention"] == k9_layers
            and launches["flash_attention:ffma"] == 0,
            f"the {model.cfg.name} prefill launched K9 "
            f"{launches['flash_attention']} times "
            f"({launches['flash_attention:wgmma']} by its wgmma route), not "
            f"{k9_layers} times by the wgmma route")
    b, t = batch["tokens"].shape
    t += model.cfg.vision_tokens          # a VLM's patches come first
    require(logits.shape == (b, t, model.cfg.vocab)
            and logits.dtype == torch.bfloat16, "prefill logits misshapen")
    require(all(bool(torch.isfinite(c).all()) for c in logits.split(2048, 1)),
            "non-finite prefill logits")
    del logits
    ms = []
    for _ in range(2):
        one, out = host_ms(lambda: prefill(params, batch))
        del out
        ms.append(one)
    for _ in range(6):
        wall, rows = profile_rows(lambda: prefill(params, batch), cuda_only)
        seen = {route: sum(n for name, _, n in rows if symbol in name)
                for route, symbol in (("wgmma", "flash_attention_kernel_wgmma"),
                                      ("ffma", "flash_attention_kernel<"))}
        if rows and seen["wgmma"] == k9_layers:
            break
    report = {"shape": f"B={b}, T={t}, bf16, {model.cfg.n_layers} layers",
              "first_ms": first_ms, "ms": ms, "peak_memory_gb": peak_gb,
              "held_before_gb": held_gb, "launches": launches,
              "profile_wall_ms": wall}
    if not rows:
        # no session recorded a device event: the counters above alone
        # show K9's launches, and the device time by group is not measured
        profiler_miss(f"the {model.cfg.name} prefill: no session of 6 "
                      f"recorded a device event; K9's launches by the "
                      f"counters only, device time by group not measured")
        return {**report, "device_ms_by_group": "not measured"}
    require(seen == {"wgmma": k9_layers, "ffma": 0},
            f"the prefill's profile shows K9 launches {seen}, not "
            f"{k9_layers} of the wgmma kernel and none of the FFMA one")
    busy = sum(one for _, one, _ in rows)
    groups = {"flash_attention (K9)": 0.0, "GEMM": 0.0, "other": 0.0}
    for name, one, _ in rows:
        if "flash_attention_kernel" in name:
            groups["flash_attention (K9)"] += one
        elif any(w in name.lower() for w in ("gemm", "nvjet", "xmma", "cutlass")):
            groups["GEMM"] += one
        else:
            groups["other"] += one
    k9_ms = groups["flash_attention (K9)"]
    return {**report, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "device_ms_by_group": groups, "k9_profile_launches": seen,
            "k9_share_of_device": k9_ms / busy,
            "k9_device_ms_per_launch": k9_ms / max(k9_layers, 1),
            "top_device_ms": [[name[:70], one] for name, one, _ in rows[:10]]}


def serve_qwen2(dev, seed: int, K, err: dict) -> dict:
    """qwen2-0.5B at full width and depth (bf16, random weights from
    ``seed``): K9 against its plain version, ``make_prefill`` at
    T = 32,768 through 24 K9 launches, decode == forward at T = 640, and
    greedy ``generate``. Returns the counts per path and K9's entry of
    the kernel line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models.common import apply_norm, apply_rope
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(gen)
    n_params = sum(p.numel() for p in tree_leaves(params))
    require(n_params == 494_032_768, f"qwen2-0.5b has {n_params} parameters")
    h, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.hd

    # 1. K9 against its plain version: all 14 heads at a ragged T in bf16
    # and f32, then the first and last head of layer 0's prefill inputs
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((1, CHECK_T, n, hd), generator=g, device=dev)
                   .to(dtype) for n in (h, kvh, kvh))
        check_flash(q, k, v, range(h), err, f"T={CHECK_T} {dtype}")
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_T), generator=gen,
                           device=dev)
    lp = tree_map(lambda a: a[0], params["layers"][0])
    with torch.no_grad():
        x = apply_norm(params["embed"][tokens], lp["norm1"], cfg.norm)
        q, k, v = attn._qkv(lp["mixer"], x, cfg)
        pos = torch.arange(PREFILL_T, device=dev)[None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    check_flash(q, k, v, (0, h - 1), err, f"layer 0 at T={PREFILL_T}")
    flash_in = (q, k, v)
    del x, pos, q, k, v
    print(f"# K9 matches its plain version: {h} heads at T={CHECK_T} (f32 max "
          f"abs err {err['flash_attention']:.2e}; bf16 against the f32 oracle "
          f"{json.dumps(err['flash_attention_bf16'])}), heads 0 and {h - 1} of "
          f"layer 0 at T={PREFILL_T} (bf16)", flush=True)

    # 2. prefill: B=1, T=32,768, the whole model
    prefill_rep = prefill_report(model, params, {"tokens": tokens}, K,
                                 cfg.n_layers)
    prefill_launches = prefill_rep["launches"]
    xf = torch.randn((1, PREFILL_T, cfg.d_model), generator=g, device=dev
                     ).to(torch.bfloat16)
    with torch.no_grad():
        prefill_rep["logits_ms"] = time_cuda(lambda: model._logits(params, xf),
                                             reps=5)
    del xf
    print(json.dumps({"prefill_qwen2": prefill_rep}), flush=True)
    entry = flash_kernel_entry(*flash_in, err)
    del flash_in

    # 3. decode == forward at full width, on the K9 branch
    toks = torch.randint(0, cfg.vocab, (DECODE_B, DECODE_T), generator=gen,
                         device=dev)
    decode_rep = decode_vs_forward(model, params, toks, dev, K)
    decode_launches = decode_rep["launches"]
    require(decode_launches["flash_attention:wgmma"] == cfg.n_layers,
            f"the T={DECODE_T} forward did not take the K9 branch in every layer")
    print(json.dumps({"decode_vs_forward_qwen2": decode_rep}), flush=True)
    require(decode_rep["max_abs_gap"] <= DECODE_TOL * decode_rep["max_abs_logit"],
            f"decode and forward logits differ: {decode_rep}")
    require(decode_rep["argmax_agreement"] >= ARGMAX_AGREE,
            f"decode and forward argmax agree too rarely: {decode_rep}")

    # 4. generate: batch 4, prompt 64, 32 greedy tokens; then the decode
    # loop's speed as a user meets it: the serving CLI on the card, in a
    # fresh process (this one holds profiler state and the earlier phases'
    # tensors)
    gen_rep = greedy_vs_forward("qwen2-0.5b", params, seed, dev, K, GEN_B,
                                GEN_PROMPT, GEN_N)
    del params
    torch.cuda.empty_cache()
    gen_rep.update(serve_cli_times(seed))
    print(json.dumps({"generate_qwen2": gen_rep}), flush=True)
    paths = {"prefill_qwen2": prefill_launches,
             "decode_vs_forward_qwen2": decode_launches,
             "generate_qwen2": gen_rep["launches"]}
    by = {path: n["flash_attention"] for path, n in paths.items()
          if n["flash_attention"]}
    routes = {r: sum(n[f"flash_attention:{r}"] for n in paths.values())
              for r in ("wgmma", "ffma")}
    entry = {**{key: entry[key] for key in ("name", "route", "source",
                                            "replaces")},
             "launches": sum(by.values()), "launches_by_path": by,
             "launches_by_route": routes, **entry}
    return dict(paths=paths, kernel=entry)


# -- phase 9b: starcoder2-3b serving, the sliding window through K9 ---------------

# starcoder2-3b's prefill at prefill_32k's sequence, one sequence; K9's
# windowed checks at a ragged T with a window that starts mid-tile; decode
# == forward on the reduced config (window 16) past its window, on the K9
# branch
SC_T, SC_CHECK_T, SC_CHECK_WINDOW = 32768, 4000, 300
SC_DECODE_B, SC_DECODE_T = 2, 640


def window_kernel_fields(q, k, v, window: int, werr: dict) -> dict:
    """K9's windowed figures on starcoder2-3b's layer-0 prefill inputs
    (bf16, the wgmma route): ms, device ms, bound, plain and library ms;
    the same call without the window and the f32 FFMA route beside."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )

    b, t, h, hd = q.shape
    n_rep = h // k.shape[2]
    pairs = window_pairs(t, window)
    flops = 4 * b * h * hd * pairs
    b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                       {"bf16": flops})

    def plain_all_heads():
        for head in range(h):
            flash_attention_ref(q[0, :, head][None],
                                k[0, :, head // n_rep][None],
                                v[0, :, head // n_rep][None], window)

    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(n_rep, dim=2).transpose(1, 2) for x in (k, v))
    dev_ms = device_ms(lambda: flash_attention(q, k, v, window=window),
                       "flash_attention_kernel_wgmma", reps=10)
    causal_dev_ms = device_ms(lambda: flash_attention(q, k, v),
                              "flash_attention_kernel_wgmma", reps=5)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    out = dict(
        window_shape=f"starcoder2-3b layer 0 prefill: q ({b}, {t}, {h}, {hd}), "
                     f"k and v ({b}, {t}, {k.shape[2]}, {hd}) bf16, window "
                     f"{window}, bq=bk=128",
        window_max_abs_err=werr["flash_attention_bf16"]["max_abs_err"],
        window_bf16_check={key: val for key, val in
                           werr["flash_attention_bf16"].items()
                           if key != "max_abs_err"},
        window_f32_max_abs_err=werr["flash_attention"],
        window_max_abs_err_is=f"bf16 (wgmma) against the f32 oracle, all {h} "
                              f"heads at T={SC_CHECK_T} with window "
                              f"{SC_CHECK_WINDOW} and heads 0, {h - 1} at "
                              f"T={t} with window {window}; f32 (FFMA) "
                              f"against the plain version on the same heads",
        window_ms=time_cuda(lambda: flash_attention(q, k, v, window=window),
                            reps=10),
        window_device_ms=dev_ms, window_tflops=flops / dev_ms / 1e9,
        window_pairs=pairs,
        window_bound_ms=b_ms, window_bound_by=b_by,
        window_plain_ms=time_cuda(plain_all_heads, reps=1, warmup=1),
        window_library_ms=time_cuda(lambda: sdpa(qt, kt, vt, window), reps=5,
                                    warmup=1),
        window_library_call="scaled_dot_product_attention with a boolean "
                            "(T, T) window mask, efficient or cuDNN backend, "
                            "KV heads expanded beforehand",
        window_causal_device_ms=causal_dev_ms,
        window_causal_bound_ms=bound(0, {"bf16": 4 * b * h * hd * t * (t + 1)
                                         / 2})[0],
        window_ffma_f32_ms=time_cuda(
            lambda: flash_attention(q32, k32, v32, window=window), reps=2,
            warmup=1),
        window_ffma_f32_device_ms=device_ms(
            lambda: flash_attention(q32, k32, v32, window=window),
            "flash_attention_kernel<", reps=2))
    del q32, k32, v32, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def serve_starcoder2(dev, seed: int, K) -> dict:
    """starcoder2-3b at full width and depth (bf16, random weights from
    ``seed``; window 4,096, head dim 128): K9 with its window against the
    windowed plain version and ``make_prefill`` at T = 32,768 through 30
    windowed K9 launches, profiled. Returns the prefill's counts, K9's
    windowed figures for the kernel line, and the weights for
    ``decode_starcoder2``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.starcoder2_3b import param_shapes
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models.common import apply_norm, apply_rope
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("starcoder2-3b")
    w, h, kvh, hd = cfg.sliding_window, cfg.n_heads, cfg.kv_heads, cfg.hd
    require((w, h, kvh, hd, cfg.n_layers) == (4096, 24, 2, 128, 30),
            f"starcoder2-3b's config changed: {cfg}")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(gen)
    n_params = sum(p.numel() for p in tree_leaves(params))
    require(n_params == param_count(param_shapes()),
            f"starcoder2-3b has {n_params} parameters, not param_shapes()'s")

    # 1. K9 with a window against its plain version: all heads at a ragged
    # T with a window starting mid-tile (bf16 and f32), then the first and
    # last head of layer 0's inputs at T = 32,768 with the real window
    werr = {"flash_attention": 0.0}
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((1, SC_CHECK_T, n, hd), generator=g, device=dev)
                   .to(dtype) for n in (h, kvh, kvh))
        check_flash(q, k, v, range(h), werr, f"T={SC_CHECK_T} {dtype}",
                    window=SC_CHECK_WINDOW)
    tokens = torch.randint(0, cfg.vocab, (1, SC_T), generator=gen, device=dev)
    lp = tree_map(lambda a: a[0], params["layers"][0])
    with torch.no_grad():
        x = apply_norm(params["embed"][tokens], lp["norm1"], cfg.norm)
        q, k, v = attn._qkv(lp["mixer"], x, cfg)
        pos = torch.arange(SC_T, device=dev)[None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    del x, pos
    check_flash(q, k, v, (0, h - 1), werr, f"layer 0 at T={SC_T}", window=w)
    check_flash(*(x.float() for x in (q, k, v)), (0, h - 1), werr,
                f"layer 0 at T={SC_T}, f32", window=w)
    print(f"# K9 with a window matches its plain version: {h} heads at "
          f"T={SC_CHECK_T} window {SC_CHECK_WINDOW} (f32 max abs err "
          f"{werr['flash_attention']:.2e}; bf16 against the f32 oracle "
          f"{json.dumps(werr['flash_attention_bf16'])}), heads 0 and {h - 1} "
          f"of layer 0 at T={SC_T} window {w}", flush=True)

    # 2. prefill: B=1, T=32,768, the whole model; K9's windowed figures
    rep = prefill_report(model, params, {"tokens": tokens}, K, cfg.n_layers)
    launches = rep["launches"]
    print(json.dumps({"prefill_starcoder2": rep}), flush=True)
    fields = window_kernel_fields(q, k, v, w, werr)
    del q, k, v, tokens
    torch.cuda.empty_cache()
    print(f"# starcoder2-3b prefill phase in "
          f"{time.perf_counter() - t_phase:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return dict(paths={"prefill_starcoder2": launches}, window=fields,
                params=params)


def decode_starcoder2(dev, seed: int, K, params) -> dict:
    """Phase 9b's decode loops, run after every profiling phase: greedy
    ``generate`` at full width on ``params``, and decode == forward past
    the window on the K9 branch, on the reduced config (window 16) in f32
    (the FFMA route, to 2e-3) and bf16 (the wgmma route, within
    DECODE_TOL). Returns the counts per path."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    gen_rep = greedy_vs_forward("starcoder2-3b", params, seed, dev, K)
    print(json.dumps({"generate_starcoder2": gen_rep}), flush=True)
    del params
    torch.cuda.empty_cache()
    small = get_config("starcoder2-3b", smoke=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    dec = {}
    for dtype in ("float32", "bfloat16"):
        scfg = dataclasses.replace(small, dtype=dtype)
        smodel = build_model(scfg)
        sparams = smodel.init_params(
            torch.Generator(device=dev).manual_seed(seed))
        toks = torch.randint(0, scfg.vocab, (SC_DECODE_B, SC_DECODE_T),
                             generator=gen, device=dev)
        r = decode_vs_forward(smodel, sparams, toks, dev, K)
        route = "ffma" if dtype == "float32" else "wgmma"
        require(r["launches"][f"flash_attention:{route}"] == scfg.n_layers
                and r["launches"]["flash_attention"] == scfg.n_layers,
                f"the reduced starcoder2 forward ({dtype}, T={SC_DECODE_T}) "
                f"did not take K9's {route} route in every layer")
        if dtype == "float32":
            require(r["max_abs_gap"] <= 2e-3 * max(1.0, r["max_abs_logit"]),
                    f"starcoder2 decode and forward (f32) differ: {r}")
            require(r["argmax_agreement"] >= ARGMAX_AGREE,
                    f"starcoder2 decode and forward (f32) argmax: {r}")
        else:
            require(r["max_abs_gap"] <= DECODE_TOL * r["max_abs_logit"],
                    f"starcoder2 decode and forward (bf16) differ: {r}")
        dec[dtype] = r
    print(json.dumps({"decode_vs_forward_starcoder2": dec}), flush=True)
    print(f"# starcoder2-3b decode phase in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"decode_vs_forward_starcoder2_f32": dec["float32"]["launches"],
            "decode_vs_forward_starcoder2_bf16": dec["bfloat16"]["launches"],
            "generate_starcoder2": gen_rep["launches"]}


# -- phase 9c: minicpm3-4b serving, MLA --------------------------------------------

# minicpm3-4b's prefill at train_4k's sequence, one sequence (T = 32,768
# would hold 128 chunks x 62 layers of 1.3 GB f32 scores); decode ==
# forward at a short T (62 host-bound layers a step)
MC_T, MC_DECODE_B, MC_DECODE_T = 4096, 2, 64


def serve_minicpm3(dev, seed: int, K) -> dict:
    """minicpm3-4b at full width and depth (bf16, random weights from
    ``seed``; MLA, which takes no K9): layer 0's chunked path against
    ``_mla_attend`` under the whole causal mask (bf16 and f32), and
    ``make_prefill`` at B=1, T=4,096 through the chunked MLA path,
    profiled. Returns the prefill's counts and the weights for
    ``decode_minicpm3``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.minicpm3_4b import param_shapes
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models.common import apply_norm, causal_mask
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("minicpm3-4b")
    require(cfg.attn_type == "mla" and cfg.n_layers == 62,
            f"minicpm3-4b's config changed: {cfg}")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(gen)
    n_params = sum(p.numel() for p in tree_leaves(params))
    require(n_params == param_count(param_shapes()),
            f"minicpm3-4b has {n_params} parameters, not param_shapes()'s")
    tokens = torch.randint(0, cfg.vocab, (1, MC_T), generator=gen, device=dev)

    # 1. layer 0: the chunked path against the whole causal mask
    lp = tree_map(lambda a: a[0], params["layers"][0])
    chunk_gap = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        mixer = tree_map(lambda a: a.to(c.tdtype), lp["mixer"])
        with torch.no_grad():
            x = apply_norm(params["embed"][tokens], lp["norm1"], cfg.norm)
            parts = attn._mla_qk(mixer, x.to(c.tdtype),
                                 torch.arange(MC_T, device=dev)[None], c)
            got = attn._mla_attend_chunked(mixer, *parts, c)
            want = attn._mla_attend(mixer, *parts,
                                    causal_mask(MC_T, device=dev), c)
        gap = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        limit = (BF16_CHUNK_STEPS * 2.0 ** -7 if dtype == "bfloat16"
                 else 1e-4) * scale
        require(gap <= limit, f"minicpm3-4b layer 0 ({dtype}): the chunked "
                f"MLA path is {gap:.3e} off the whole mask's (limit "
                f"{limit:.3e})")
        chunk_gap[dtype] = {"max_abs_gap": gap, "max_abs_out": scale,
                            "limit": limit}
        del x, parts, got, want, mixer
    torch.cuda.empty_cache()

    # 2. prefill: B=1, T=4,096, no K9
    rep = prefill_report(model, params, {"tokens": tokens}, K, 0)
    rep["layer0_chunked_vs_whole_mask"] = chunk_gap
    print(json.dumps({"prefill_minicpm3": rep}), flush=True)

    require(rep["launches"]["flash_attention"] == 0,
            "the minicpm3-4b prefill launched K9")
    print(f"# minicpm3-4b prefill phase in "
          f"{time.perf_counter() - t_phase:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return dict(paths={"prefill_minicpm3": rep["launches"]}, params=params)


def decode_minicpm3(dev, seed: int, K, params) -> dict:
    """Phase 9c's decode loops, run after every profiling phase: decode ==
    forward at B=2, T=64 at full width, and greedy ``generate``; no K9
    launch. Returns the counts per path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = get_config("minicpm3-4b")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    toks = torch.randint(0, cfg.vocab, (MC_DECODE_B, MC_DECODE_T),
                         generator=gen, device=dev)
    dec = decode_vs_forward(build_model(cfg), params, toks, dev, K)
    require(dec["max_abs_gap"] <= DECODE_TOL * dec["max_abs_logit"],
            f"minicpm3-4b decode and forward logits differ: {dec}")
    require(dec["argmax_agreement"] >= ARGMAX_AGREE,
            f"minicpm3-4b decode and forward argmax: {dec}")
    print(json.dumps({"decode_vs_forward_minicpm3": dec}), flush=True)
    gen_rep = greedy_vs_forward("minicpm3-4b", params, seed, dev, K)
    print(json.dumps({"generate_minicpm3": gen_rep}), flush=True)
    paths = {"decode_vs_forward_minicpm3": dec["launches"],
             "generate_minicpm3": gen_rep["launches"]}
    require(not any(n["flash_attention"] for n in paths.values()),
            "an MLA path launched K9")
    del params
    torch.cuda.empty_cache()
    print(f"# minicpm3-4b decode phase in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


# -- phases 9d-9g: the MoE, encoder-decoder and VLM families through K9 ----------

# granite-moe-1b-a400m and whisper-tiny at prefill_32k's sequence (batch 32
# cut to 1); grok-1-314b (64 layers cut to 8: 56.2 GB of bf16 weights) and
# llava-next-34b (all 60 layers, 68.8 GB: 2,880 patches and 1,216 tokens)
# at train_4k's sequence, one sequence. Their decode loops run after
# phase 9's (``decode_new_families``): every profile before every decode
# loop.
MOE_T, GROK_T, GROK_LAYERS, WHISPER_T, LLAVA_T = 32768, 4096, 8, 32768, 4096
# decode == forward: whisper at full width, reduced granite with room for
# every token (capacity_factor = E / top_k); the card's decode against the
# CPU port's at granite's published capacity, in f32
NEW_DECODE_B, NEW_DECODE_T, MOE_CPU_DECODE_T = 2, 640, 16
# layer 0's MoE on the card: bf16 against f32 on the same tensors, and the
# card's f32 against the CPU port's on the first tokens
MOE_CHECK_T, MOE_CPU_CHECK_T = 4096, 1024


def attention_layer_inputs(model, params, batch):
    """The first attention layer's q, k, v of a prefill (layer 0, or
    jamba's position 7 of its period: the embedded inputs through the
    layers before it, then norm1, the projections and RoPE where the
    model has it), its input x and its layer tree."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm, apply_rope
    from repro_torch.models.transformer import _layer_forward
    from repro_torch.tree import tree_map

    cfg = model.cfg
    j = next(i for i, (mixer, _) in enumerate(model.kinds) if mixer == "attn")
    first = [tree_map(lambda a: a[0], stack) for stack in params["layers"]]
    with torch.no_grad():
        x = model._embed_inputs(params, batch)
        for lp, kind in zip(first[:j], model.kinds[:j]):
            x, _ = _layer_forward(lp, x, cfg, *kind)
        lp = first[j]
        q, k, v = attn._qkv(lp["mixer"], apply_norm(x, lp["norm1"], cfg.norm),
                            cfg)
        if cfg.rope:
            pos = torch.arange(x.shape[1], device=x.device)[None]
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
    return (q, k, v), x, lp


def k9_shape_fields(q, k, v, kerr: dict, heads_checked: str) -> dict:
    """K9 on one layer's prefill inputs (bf16, the wgmma route): device ms
    against its bound (operations at the bf16 rate) and SDPA's time, with
    the worst bf16 errors of the checks made on this model."""
    b, t, h, hd = q.shape
    n_rep = h // k.shape[2]
    from repro_torch.kernels.flash_attention import flash_attention

    flops = 4 * b * h * hd * t * (t + 1) / 2
    b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                       {"bf16": flops})
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(n_rep, dim=2).transpose(1, 2) for x in (k, v))
    dev_ms = device_ms(lambda: flash_attention(q, k, v),
                       "flash_attention_kernel_wgmma", reps=5)
    out = dict(shape=f"q ({b}, {t}, {h}, {hd}), k and v ({b}, {t}, "
                     f"{k.shape[2]}, {hd}) bf16, n_rep {n_rep}",
               ms=time_cuda(lambda: flash_attention(q, k, v), reps=5),
               device_ms=dev_ms, tflops=flops / dev_ms / 1e9,
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_cuda(lambda: sdpa(qt, kt, vt), reps=5),
               max_abs_err=kerr["flash_attention_bf16"]["max_abs_err"],
               bf16_check={key: val for key, val in
                           kerr["flash_attention_bf16"].items()
                           if key != "max_abs_err"},
               f32_max_abs_err=kerr["flash_attention"],
               checked=heads_checked)
    del qt, kt, vt
    return out


def check_k9_at(q, k, v, dev, seed: int, what: str,
                layer: str = "layer 0") -> tuple[dict, str]:
    """K9 against its plain version at a model's head counts: every head
    on random inputs at T = CHECK_T in bf16 and f32, then the first and
    last head of ``layer``'s prefill inputs (``q, k, v``) in bf16."""
    import torch

    h, kvh, hd = q.shape[2], k.shape[2], q.shape[3]
    kerr = {"flash_attention": 0.0}
    g = torch.Generator(device=dev).manual_seed(seed)
    for dtype in (torch.bfloat16, torch.float32):
        rq, rk, rv = (torch.randn((1, CHECK_T, n, hd), generator=g, device=dev)
                      .to(dtype) for n in (h, kvh, kvh))
        check_flash(rq, rk, rv, range(h), kerr, f"{what} T={CHECK_T} {dtype}")
        del rq, rk, rv
    check_flash(q, k, v, (0, h - 1), kerr, f"{what} {layer} at "
                f"T={q.shape[1]}")
    checked = (f"all {h} heads at T={CHECK_T} (bf16 and f32), heads 0 and "
               f"{h - 1} of {layer} at T={q.shape[1]} (bf16)")
    print(f"# K9 matches its plain version for {what}: {checked}; "
          f"{json.dumps(kerr)}", flush=True)
    return kerr, checked


def moe_groups(lp, x, cfg, k9_ms: float) -> dict:
    """Device ms of one MoE layer's parts at the prefill's shape, by CUDA
    events on layer 0 (the profiler cannot tell the dispatch and combine
    GEMMs from the experts'), each part the function ``moe_forward``
    calls: the router (``route_groups``: f32 logits, ``_route``),
    dispatch and combine (``dispatch_tokens`` and ``combine_tokens``),
    the experts (``run_experts``), and attention (the projections and
    K9's device ms); each also times the model's depth."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import mlp

    p = lp["ffn"]
    with torch.no_grad():
        groups, _ = mlp.group_tokens(x, cfg)

        def router():
            return mlp.route_groups(p, groups, cfg)

        dispatch, combine, _ = router()
        xin = mlp.dispatch_tokens(dispatch, groups)

        def experts():
            return mlp.run_experts(p, xin, cfg)

        xout = experts()

        def dispatch_and_combine():
            mlp.dispatch_tokens(dispatch, groups)
            return mlp.combine_tokens(combine, xout)

        def projections():
            q, _, _ = attn._qkv(lp["mixer"], x, cfg)
            return q.reshape(x.shape[0], x.shape[1], -1) @ lp["mixer"]["wo"]

        per_layer = {"router": time_cuda(router, reps=3, warmup=1),
                     "dispatch_and_combine": time_cuda(dispatch_and_combine,
                                                       reps=3, warmup=1),
                     "experts": time_cuda(experts, reps=3, warmup=1),
                     "attention_projections": time_cuda(projections, reps=3,
                                                        warmup=1),
                     "attention_k9_device": k9_ms}
    gsz = groups.shape[1]
    del dispatch, combine, xin, xout, groups
    torch.cuda.empty_cache()
    return {"per_layer_ms": per_layer,
            "model_ms": {key: val * cfg.n_layers
                         for key, val in per_layer.items()},
            "capacity": mlp.capacity(cfg, gsz), "group": gsz,
            "groups": -(-x.shape[0] * x.shape[1] // gsz)}


def moe_layer_check(lp, x, cfg) -> dict:
    """Layer 0's ``moe_forward`` on the card in bf16 against the same
    computation in f32 on the same tensors (the router reads f32 logits
    of the same values, so the routes are equal: the aux losses must be
    bit for bit), within DECODE_TOL of the largest output; then the card's
    f32 against the CPU port's on the first tokens, to 1e-5."""
    import dataclasses

    import torch
    from repro_torch.models import mlp
    from repro_torch.tree import tree_map

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda a: a.float(), lp["ffn"])
    with torch.no_grad():
        y, aux = mlp.moe_forward(lp["ffn"], x, cfg)
        y32, aux32 = mlp.moe_forward(p32, x.float(), cfg32)
        gap = float((y.float() - y32).abs().max())
        scale = float(y32.abs().max())
        require(torch.equal(aux, aux32), f"{cfg.name} layer 0: bf16 and f32 "
                f"routes differ (aux {float(aux)} against {float(aux32)})")
        require(gap <= DECODE_TOL * scale, f"{cfg.name} layer 0's MoE in "
                f"bf16 is {gap:.3e} off f32 (max {scale:.3e})")
        xs = x[:, :MOE_CPU_CHECK_T].float()
        card, _ = mlp.moe_forward(p32, xs, cfg32)
        cpu, _ = mlp.moe_forward(tree_map(lambda a: a.cpu(), p32), xs.cpu(),
                                 cfg32)
        cpu_gap = float((card.cpu() - cpu).abs().max())
        cpu_scale = float(cpu.abs().max())
        require(cpu_gap <= 1e-5 * cpu_scale, f"{cfg.name} layer 0's MoE: "
                f"card and CPU differ by {cpu_gap:.3e} (max {cpu_scale:.3e})")
    del p32, y, y32, card, cpu
    torch.cuda.empty_cache()
    return {"shape": f"(1, {x.shape[1]}, {cfg.d_model}) bf16 against f32",
            "max_abs_gap": gap, "max_abs_out": scale,
            "gap_in_bf16_steps_of_max": gap / (scale * 2.0 ** -7),
            "aux": float(aux),
            "card_vs_cpu_f32": {"tokens": MOE_CPU_CHECK_T,
                                "max_abs_gap": cpu_gap,
                                "max_abs_out": cpu_scale}}


def serve_family(dev, seed: int, K, arch: str, t: int, layers=None) -> dict:
    """One model at full width (bf16, random weights from ``seed``; depth
    cut to ``layers`` where given): K9 at its head counts against the
    plain version, ``make_prefill`` at B=1 and T = ``t`` through one K9
    launch a decoder layer, profiled; K9's figures on layer 0; for MoE
    layer 0's ``moe_forward`` against f32 and the time by part; for
    whisper the encoder's and the cross-attention's bf16 against f32.
    Returns the prefill's counts, K9's figures and the weights."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import add_modality_inputs
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models.common import apply_norm
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")
    model = build_model(cfg)
    held = torch.cuda.memory_allocated()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    n_params = sum(p.numel() for p in tree_leaves(params))
    require(n_params == param_count(mod.param_shapes(cfg)),
            f"{arch} has {n_params} parameters, not param_shapes()'s")
    # over what the earlier models' kept weights hold
    weights_gb = (torch.cuda.memory_allocated() - held) / 1e9
    init_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    t_text = t - cfg.vision_tokens
    batch = add_modality_inputs({"tokens": torch.randint(
        0, cfg.vocab, (1, t_text), generator=gen, device=dev)}, cfg, 0)
    (q, k, v), x, lp = attention_layer_inputs(model, params, batch)
    kerr, checked = check_k9_at(q, k, v, dev, seed + 6, arch)
    rep = {"config": f"{cfg.n_layers} of {full_layers} layers, d "
                     f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, "
                     f"hd {cfg.hd}", "parameters": n_params,
           "weights_gb": weights_gb, "init_peak_gb": init_peak_gb}
    if cfg.moe is not None:
        with torch.no_grad():
            h2 = apply_norm(x[:, :MOE_CHECK_T], lp["norm2"], cfg.norm)
        rep["layer0_moe_vs_f32"] = moe_layer_check(lp, h2, cfg)
        del h2
    if cfg.family == "encdec":
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = tree_map(lambda a: a.float(), params)
        with torch.no_grad():
            mem = model._encode(params, batch["frames"])
            mem32 = build_model(cfg32)._encode(p32, batch["frames"].float())
            hx = apply_norm(x[:, :MOE_CHECK_T], lp["norm_x"], cfg.norm)
            cross = attn.cross_forward(lp["cross"], hx, mem, cfg)
            cross32 = attn.cross_forward(
                tree_map(lambda a: a.float(), lp["cross"]), hx.float(),
                mem.float(), cfg32)
        gaps = {}
        for name, got, want in (("encoder", mem, mem32),
                                ("cross_attention", cross, cross32)):
            gap = float((got.float() - want).abs().max())
            scale = float(want.abs().max())
            require(gap <= DECODE_TOL * scale, f"whisper's {name} in bf16 is "
                    f"{gap:.3e} off f32 (max {scale:.3e})")
            gaps[name] = {"max_abs_gap": gap, "max_abs_out": scale}
        rep["bf16_vs_f32"] = gaps
        del p32, mem, mem32, hx, cross, cross32
    del x
    torch.cuda.empty_cache()
    pre = prefill_report(model, params, batch, K, cfg.n_layers)
    k9 = k9_shape_fields(q, k, v, kerr, checked)
    if cfg.moe is not None:
        with torch.no_grad():
            x = apply_norm(model._embed_inputs(params, batch), lp["norm2"],
                           cfg.norm)
        pre["moe_groups"] = moe_groups(lp, x, cfg, k9["device_ms"])
        del x
    del q, k, v, batch
    torch.cuda.empty_cache()
    rep["prefill"] = pre
    print(json.dumps({f"prefill_{arch}": rep}), flush=True)
    print(f"# {arch} prefill phase in {time.perf_counter() - t_phase:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    return dict(paths={f"prefill_{arch}": pre["launches"]}, k9=k9,
                params=params)


def serve_new_families(dev, seed: int, K) -> dict:
    """Phases 9d-9g's profiled parts: granite-moe-1b-a400m (T = 32,768),
    grok-1-314b cut to 8 layers (T = 4,096), whisper-tiny (T = 32,768
    over 1,500 frames) and llava-next-34b (T = 4,096: 2,880 patches and
    1,216 tokens). grok-1's and llava's weights are freed at once;
    granite's and whisper's are kept for ``decode_new_families``."""
    import torch

    out = {"paths": {}, "k9": {}, "params": {}}
    for arch, t, layers, keep in (
            ("granite-moe-1b-a400m", MOE_T, None, True),
            ("grok-1-314b", GROK_T, GROK_LAYERS, False),
            ("whisper-tiny", WHISPER_T, None, True),
            ("llava-next-34b", LLAVA_T, None, False)):
        r = serve_family(dev, seed, K, arch, t, layers)
        out["paths"].update(r["paths"])
        out["k9"][arch] = r["k9"]
        if keep:
            out["params"][arch] = r["params"]
        del r
        torch.cuda.empty_cache()
    return out


def greedy_vs_decode(arch: str, params, seed: int, dev, K, batch: int,
                     prompt: int, n: int, smoke: bool = False) -> dict:
    """``generate`` at full width (reduced with ``smoke``), and its tokens
    against the argmax of the serve step teacher-forced on them with the
    same cache (for whisper the same encoder memory, handed to both):
    the check for the models whose forward is not the decode's yardstick
    (MoE drops tokens by group; whisper's memory; llava's forward takes
    patches; xlstm's bf16 forward and decode round apart)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build_model

    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    cache = model.init_cache(batch, prompt + n, dev)
    memory = None
    if cfg.family == "encdec":
        g = torch.Generator(device=dev).manual_seed(seed + 8)
        memory = cache["enc"] = (torch.randn(cache["enc"].shape, generator=g,
                                             device=dev).to(cfg.tdtype) * 0.02)
    K.reset_launches()
    seqs = generate(arch, smoke=smoke, batch=batch, prompt_len=prompt, gen=n,
                    seed=seed, greedy=True, device=dev, params=params,
                    memory=memory)
    launches = counts(K)
    require(seqs.shape == (batch, prompt + n) and int(seqs.min()) >= 0
            and int(seqs.max()) < cfg.vocab,
            f"{arch}: generate returned misshapen or out-of-range tokens")
    serve = make_serve_step(model)
    picked = []
    for pos in range(prompt + n - 1):
        lg, cache = serve(params, cache, seqs[:, pos:pos + 1], pos)
        if pos >= prompt - 1:
            picked.append(lg[:, 0].argmax(-1))
    agree = float((torch.stack(picked, 1) == seqs[:, prompt:]).float().mean())
    require(agree >= ARGMAX_AGREE, f"{arch}: generate's greedy tokens match "
            f"the teacher-forced decode's argmax at {agree:.3f}")
    return {"shape": f"batch {batch}, prompt {prompt}, {n} greedy",
            "greedy_vs_decode_argmax": agree, "launches": launches}


def decode_new_families(dev, seed: int, K, kept: dict) -> dict:
    """Phases 9d, 9f and 9g's decode loops, after every profiling phase:
    greedy ``generate`` of granite (batch 2), whisper (batch 2) and
    llava-next-34b (batch 1, text alone; its weights drawn again);
    decode == forward for whisper at full width with the encoder's
    memory (bf16, T = 640, the K9 branch) and for reduced granite with
    capacity_factor = E / top_k (f32, T = 640: nothing dropped); the
    card's decode against the CPU port's at granite's published capacity
    in f32. Returns the counts per path."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.launch.train import add_modality_inputs
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    paths = {}
    gen = torch.Generator(device=dev).manual_seed(seed + 7)

    # granite: generate; the card's f32 decode against the CPU port's
    granite = "granite-moe-1b-a400m"
    params = kept.pop(granite)
    rep = greedy_vs_decode(granite, params, seed, dev, K, SMALL_GEN_B,
                           SMALL_GEN_PROMPT, SMALL_GEN_N)
    paths["generate_granite"] = rep.pop("launches")
    cfg32 = dataclasses.replace(get_config(granite), dtype="float32")
    model32 = build_model(cfg32)
    toks = torch.randint(0, cfg32.vocab, (NEW_DECODE_B, MOE_CPU_DECODE_T),
                         generator=gen, device=dev)
    logits = {}
    for where in (dev, "cpu"):
        p = tree_map(lambda a: a.to(where, torch.float32), params)
        cache = model32.init_cache(NEW_DECODE_B, MOE_CPU_DECODE_T, where)
        serve = make_serve_step(model32)
        out = []
        for pos in range(MOE_CPU_DECODE_T):
            lg, cache = serve(p, cache, toks[:, pos:pos + 1].to(where), pos)
            out.append(lg[:, 0].cpu())
        logits[str(where)] = torch.stack(out, 1)
        del p, cache
    del params
    torch.cuda.empty_cache()
    gap = float((logits[str(dev)] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    require(gap <= 1e-4 * scale, f"granite's f32 decode: card and CPU differ "
            f"by {gap:.3e} (max {scale:.3e})")
    rep["card_vs_cpu_f32_decode"] = {
        "shape": f"B={NEW_DECODE_B}, {MOE_CPU_DECODE_T} steps, published "
                 f"capacity", "max_abs_gap": gap, "max_abs_logit": scale}
    small = get_config(granite, smoke=True)
    small = dataclasses.replace(small, moe=dataclasses.replace(
        small.moe, capacity_factor=small.moe.num_experts / small.moe.top_k))
    smodel = build_model(small)
    sparams = smodel.init_params(torch.Generator(device=dev).manual_seed(seed))
    toks = torch.randint(0, small.vocab, (NEW_DECODE_B, NEW_DECODE_T),
                         generator=gen, device=dev)
    r = decode_vs_forward(smodel, sparams, toks, dev, K)
    require(r["launches"]["flash_attention:ffma"] == small.n_layers,
            "the reduced granite forward did not take K9's FFMA route")
    require(r["max_abs_gap"] <= 2e-3 * max(1.0, r["max_abs_logit"])
            and r["argmax_agreement"] >= ARGMAX_AGREE,
            f"reduced granite (nothing dropped): decode and forward differ: "
            f"{r}")
    paths["decode_vs_forward_granite_reduced"] = r.pop("launches")
    rep["decode_vs_forward_reduced_no_drop"] = r
    print(json.dumps({"decode_granite": rep}), flush=True)

    # whisper: decode == forward with the encoder's memory; generate
    whisper = "whisper-tiny"
    params = kept.pop(whisper)
    cfg = get_config(whisper)
    model = build_model(cfg)
    toks = torch.randint(0, cfg.vocab, (NEW_DECODE_B, NEW_DECODE_T),
                         generator=gen, device=dev)
    frames = add_modality_inputs({"tokens": toks}, cfg, 1)["frames"]
    r = decode_vs_forward(model, params, toks, dev, K, frames=frames)
    require(r["launches"]["flash_attention:wgmma"] == cfg.n_layers,
            "whisper's T=640 forward did not take K9 in every layer")
    require(r["max_abs_gap"] <= DECODE_TOL * r["max_abs_logit"]
            and r["argmax_agreement"] >= ARGMAX_AGREE,
            f"whisper decode and forward differ: {r}")
    paths["decode_vs_forward_whisper"] = r.pop("launches")
    rep = {"decode_vs_forward": r}
    rep.update(greedy_vs_decode(whisper, params, seed, dev, K, SMALL_GEN_B,
                                SMALL_GEN_PROMPT, SMALL_GEN_N))
    paths["generate_whisper"] = rep.pop("launches")
    del params
    print(json.dumps({"decode_whisper": rep}), flush=True)

    # llava-next-34b: its weights again (68.8 GB), text-only generate
    llava = "llava-next-34b"
    torch.cuda.empty_cache()
    params = build_model(get_config(llava)).init_params(
        torch.Generator(device=dev).manual_seed(seed))
    rep = greedy_vs_decode(llava, params, seed, dev, K, 1, SMALL_GEN_PROMPT,
                           SMALL_GEN_N)
    paths["generate_llava"] = rep.pop("launches")
    del params
    torch.cuda.empty_cache()
    print(json.dumps({"decode_llava": rep}), flush=True)
    print(f"# MoE, encoder-decoder and VLM decode phase in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


# -- phases 9h-9i: the hybrid and ssm families ---------------------------------------

# jamba-1.5-large-398b: one 8-layer period of 72 (7 Mamba, 1 attention; MoE
# on the odd positions) at full width, its four MoE layers reading one
# drawn set of expert weights (a period holds 90.2 GB in bf16; with one
# set, 32.3 GB); prefill at train_4k's sequence, batch 1; generate batch 1.
# xlstm-350m whole: a profiled prefill at 4,096 and one at prefill_32k's
# sequence timed by the host clock and CUDA events after every profile
# (its sLSTM runs a step at a time: about 2 M launches at 32,768);
# generate batch 4
JAMBA, JAMBA_LAYERS, JAMBA_T = "jamba-1.5-large-398b", 8, 4096
XLSTM, XLSTM_T, XLSTM_LONG_T, XLSTM_GEN_B = "xlstm-350m", 4096, 32768, 4
# the reduced models in f32: card == CPU port over the prefill and 20
# decode steps; decode == forward at NEW_DECODE_T
RECURRENT_CPU_T, RECURRENT_DECODE_STEPS = 640, 20


class cut_depth:
    """Within the block, ``get_config(arch)`` (and ``launch/serve.py``'s)
    gives ``arch`` with ``n_layers`` layers: the entry points then serve
    weights cut to that depth."""

    def __init__(self, arch: str, n_layers: int):
        self.arch, self.n_layers = arch, n_layers

    def __enter__(self):
        import repro_torch.configs as configs
        import repro_torch.launch.serve as serve

        self.saved = configs.get_config

        def get_config(name, smoke=False):
            cfg = self.saved(name, smoke=smoke)
            if name == self.arch and not smoke:
                cfg = dataclasses.replace(cfg, n_layers=self.n_layers)
            return cfg

        configs.get_config = serve.get_config = get_config
        return self

    def __exit__(self, *exc):
        import repro_torch.configs as configs
        import repro_torch.launch.serve as serve

        configs.get_config = serve.get_config = self.saved


def draw_jamba(cfg, dev, seed: int) -> dict:
    """One period of jamba (``cfg.n_layers`` = 8) drawn as
    ``Model.init_params`` draws it, layer by layer through ``_layer_init``,
    except that the MoE positions after the first take the first's
    ``ffn`` (the drawn sets are dropped): each layer does all its work,
    the expert weights are stored once. Each position's stack is a view
    with a leading segment axis of 1."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.common import embed_init, norm_params
    from repro_torch.models.transformer import _layer_init
    from repro_torch.tree import tree_map

    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.tdtype),
              "norm_f": norm_params(cfg.d_model, cfg.norm, cfg.tdtype, dev),
              "lm_head": embed_init(gen, cfg.vocab, cfg.d_model, cfg.tdtype),
              "layers": []}
    shared = None
    for mixer, ffn in model.kinds:
        lp = _layer_init(gen, cfg, mixer, ffn, False)
        if ffn == "moe":
            if shared is None:
                shared = lp["ffn"]
            else:
                lp["ffn"] = shared
        params["layers"].append(tree_map(lambda a: a[None], lp))
        del lp
    return params


def spans_by_part(fn, patches: dict) -> tuple[float, dict]:
    """One call of ``fn`` with CUDA events recorded around every call of
    each patched function (``{name: (module, attribute)}``): the events'
    ms over the whole call and the sums of each part's spans (device
    time from its first launch to its last, and any gap between)."""
    import torch

    marks = {name: [] for name in patches}
    saved = {}
    for name, (mod, attr) in patches.items():
        inner = getattr(mod, attr)
        saved[name] = inner

        def wrapped(*a, _inner=inner, _name=name, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = _inner(*a, **kw)
            e.record()
            marks[_name].append((s, e))
            return out

        setattr(mod, attr, wrapped)
    try:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        del out
        torch.cuda.synchronize()
    finally:
        for name, (mod, attr) in patches.items():
            setattr(mod, attr, saved[name])
    total = start.elapsed_time(end)
    parts = {name: sum(s.elapsed_time(e) for s, e in m)
             for name, m in marks.items()}
    parts["the rest"] = total - sum(parts.values())
    return total, {**parts, "calls": {n: len(m) for n, m in marks.items()}}


def bf16_vs_f32(fn, p, x, cfg, what: str) -> dict:
    """``fn(p, x, cfg)`` in bf16 against the same call on f32 copies of
    ``p`` and ``x``, within DECODE_TOL of the largest f32 output."""
    import torch
    from repro_torch.tree import tree_map

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        got = fn(p, x, cfg)
        want = fn(tree_map(lambda a: a.float(), p), x.float(), cfg32)
    gap = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    require(bool(torch.isfinite(got).all()) and gap <= DECODE_TOL * scale,
            f"{what} in bf16 is {gap:.3e} off f32 (max {scale:.3e})")
    return {"shape": f"{tuple(x.shape)} bf16 against f32", "max_abs_gap": gap,
            "max_abs_out": scale,
            "gap_in_bf16_steps_of_max": gap / (scale * 2.0 ** -7)}


def jamba_period_parts(params, x, cfg, model) -> dict:
    """Device ms of a period's parts at the prefill's shape by CUDA events
    on one layer each (``time_cuda``), and each times its count in the
    period: the Mamba mixer (position 0) and its scan alone (on the
    inputs that mixer hands it), the attention mixer (position 7, K9
    inside), the MLP (position 0) and the MoE (position 1)."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import mamba, mlp
    from repro_torch.models.common import apply_norm
    from repro_torch.tree import tree_map

    first = [tree_map(lambda a: a[0], stack) for stack in params["layers"]]
    m0, a7 = first[0], first[7]
    scan_args = []
    scan = mamba._ssm_scan

    def grab(*args):
        scan_args.extend(args)
        return scan(*args)

    with torch.no_grad():
        h0 = apply_norm(x, m0["norm1"], cfg.norm)
        h2 = apply_norm(x, m0["norm2"], cfg.norm)
        mamba._ssm_scan = grab
        try:
            mamba.mamba_forward(m0["mixer"], h0, cfg)
        finally:
            mamba._ssm_scan = scan
        kinds = [k for k, _ in model.kinds]
        ffns = [f for _, f in model.kinds]
        per_layer = {
            "mamba_mixer": time_cuda(lambda: mamba.mamba_forward(
                m0["mixer"], h0, cfg), reps=3, warmup=1),
            "mamba_scan": time_cuda(lambda: scan(*scan_args), reps=3,
                                    warmup=1),
            "attention_mixer": time_cuda(lambda: attn.gqa_forward(
                a7["mixer"], h0, cfg), reps=3, warmup=1),
            "mlp": time_cuda(lambda: mlp.mlp_forward(m0["ffn"], h2, cfg),
                             reps=3, warmup=1),
            "moe": time_cuda(lambda: mlp.moe_forward(first[1]["ffn"], h2,
                                                     cfg), reps=3, warmup=1)}
    count = {"mamba_mixer": kinds.count("mamba"),
             "mamba_scan": kinds.count("mamba"),
             "attention_mixer": kinds.count("attn"),
             "mlp": ffns.count("mlp"), "moe": ffns.count("moe")}
    del h0, h2, scan_args
    torch.cuda.empty_cache()
    return {"per_layer_ms": per_layer, "count_in_period": count,
            "period_ms": {k: v * count[k] for k, v in per_layer.items()}}


def serve_jamba(dev, seed: int, K) -> dict:
    """Phase 9h's profiled part: jamba-1.5-large-398b, one period at full
    width (bf16, random weights from ``seed``; the MoE layers share one
    set of experts): the tree's shapes against ``param_shapes`` of the
    8-layer config; K9 at n_rep 8 against its plain version (every head
    at T = CHECK_T, heads 0 and 63 of the attention layer's prefill
    inputs); layer 0's Mamba mixer in bf16 against f32; ``make_prefill``
    at B = 1, T = 4,096 through one K9 launch, profiled; the spans of
    the scan, the MoE routing and K9 in one prefill; a period's parts.
    Returns the counts, K9's figures and the weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.jamba_1_5_large_398b import param_shapes
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model, mamba, mlp
    from repro_torch.models.common import apply_norm
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(JAMBA)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    model = build_model(cfg)
    require(model.n_segments == 1 and [m for m, _ in model.kinds].count(
        "attn") == 1, f"jamba's period changed: {model.kinds}")
    held = torch.cuda.memory_allocated()
    params = draw_jamba(cfg, dev, seed)
    weights_gb = (torch.cuda.memory_allocated() - held) / 1e9
    init_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    n = []

    def same(p, spec):
        require(tuple(p.shape) == tuple(spec.shape) and p.dtype == spec.dtype,
                f"jamba's drawn tree: {tuple(p.shape)} {p.dtype} against "
                f"{spec}")
        n.append(p.numel())

    tree_map(same, params, param_shapes(cfg))
    require(sum(n) == param_count(param_shapes(cfg)),
            "jamba's drawn tree is not param_shapes()'s")
    stored = sum({p.untyped_storage().data_ptr(): p.untyped_storage().nbytes()
                  for p in tree_leaves(params)}.values())
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, JAMBA_T),
                                     generator=gen, device=dev)}
    (q, k, v), _, _ = attention_layer_inputs(model, params, batch)
    kerr, checked = check_k9_at(q, k, v, dev, seed + 6, JAMBA,
                                "layer 7 (the attention layer)")
    with torch.no_grad():
        x = model._embed_inputs(params, batch)
        lp0 = tree_map(lambda a: a[0], params["layers"][0])
        h0 = apply_norm(x, lp0["norm1"], cfg.norm)
    rep = {"config": f"{JAMBA_LAYERS} of {full.n_layers} layers (one period: "
                     f"{[list(k) for k in model.kinds]}), d {cfg.d_model}, "
                     f"Di {cfg.mamba.expand * cfg.d_model}, {cfg.n_heads}/"
                     f"{cfg.kv_heads} heads, hd {cfg.hd}, {cfg.moe.num_experts}"
                     f" experts top-{cfg.moe.top_k} of d_ff {cfg.d_ff}; the 4 "
                     f"MoE layers read one drawn set of experts",
           "parameters_in_the_tree": sum(n), "weights_stored_gb": stored / 1e9,
           "weights_gb": weights_gb, "init_peak_gb": init_peak_gb,
           "layer0_mamba_bf16_vs_f32": bf16_vs_f32(
               mamba.mamba_forward, lp0["mixer"], h0, cfg,
               "jamba layer 0's Mamba mixer")}
    del h0
    torch.cuda.empty_cache()
    pre = prefill_report(model, params, batch, K, 1)
    prefill = make_prefill(model)
    total, parts = spans_by_part(
        lambda: prefill(params, batch),
        {"mamba_scan": (mamba, "_ssm_scan"),
         "moe_routing": (mlp, "route_groups"),
         "k9": (attn, "flash_attention")})
    pre["spans_ms"] = {"prefill": total, **parts}
    pre["period_parts"] = jamba_period_parts(params, x, cfg, model)
    k9 = k9_shape_fields(q, k, v, kerr, checked)
    del q, k, v, x
    torch.cuda.empty_cache()
    rep["prefill"] = pre
    print(json.dumps({f"prefill_{JAMBA}": rep}), flush=True)
    print(f"# {JAMBA} prefill phase in {time.perf_counter() - t_phase:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    return dict(paths={f"prefill_{JAMBA}": pre["launches"]}, k9=k9,
                params=params)


def serve_xlstm(dev, seed: int, K) -> dict:
    """Phase 9i's profiled part, run after every other profile: xlstm-350m
    whole (bf16, random weights from ``seed``; 241.6 M parameters, no
    feed-forward): the mLSTM (layer 0) and sLSTM (layer 7) mixers in
    bf16 against f32 at T = 4,096, and ``make_prefill`` at B = 1,
    T = 4,096, profiled (the device's activity alone: about 270 k
    launches), with no K9 launch. Returns the counts and the weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.xlstm_350m import param_shapes
    from repro_torch.models import build_model, xlstm
    from repro_torch.models.common import apply_norm
    from repro_torch.models.transformer import _layer_forward
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(XLSTM)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    n_params = sum(p.numel() for p in tree_leaves(params))
    require(n_params == param_count(param_shapes(cfg)),
            f"{XLSTM} has {n_params} parameters, not param_shapes()'s")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, XLSTM_T),
                                     generator=gen, device=dev)}
    first = [tree_map(lambda a: a[0], stack) for stack in params["layers"]]
    with torch.no_grad():
        x = model._embed_inputs(params, batch)
        checks = {}
        for j, (mixer, _) in enumerate(model.kinds):
            if j in (0, 7):
                h = apply_norm(x, first[j]["norm1"], cfg.norm)
                fwd = {"mlstm": xlstm.mlstm_forward,
                       "slstm": xlstm.slstm_forward}[mixer]
                checks[f"layer{j}_{mixer}_bf16_vs_f32"] = bf16_vs_f32(
                    fwd, first[j]["mixer"], h, cfg,
                    f"{XLSTM} layer {j}'s {mixer}")
                del h
            x, _ = _layer_forward(first[j], x, cfg, *model.kinds[j])
    del x
    torch.cuda.empty_cache()
    pre = prefill_report(model, params, batch, K, 0, cuda_only=True)
    rep = {"config": f"{cfg.n_layers} layers ({[list(k) for k in model.kinds]}"
                     f" a period), d {cfg.d_model}, {cfg.n_heads} heads, "
                     f"chunk {cfg.xlstm.chunk}", "parameters": n_params,
           **checks, "prefill": pre}
    print(json.dumps({f"prefill_{XLSTM}": rep}), flush=True)
    print(f"# {XLSTM} prefill phase in {time.perf_counter() - t_phase:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    return dict(paths={f"prefill_{XLSTM}": pre["launches"]}, params=params)


def recurrent_reduced(arch: str, dev, seed: int, K) -> tuple[dict, dict]:
    """``arch``'s reduced model in f32 (random weights from ``seed``): the
    card against the CPU port over the prefill at T = 640 and 20 decode
    steps, each within 1e-4 of the largest logit; decode == forward on
    the card at T = 640 (jamba with capacity_factor = E / top_k, so no
    group drops a token); greedy ``generate`` against the teacher-forced
    serve step. Returns the report and the counts per path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    cpu_params = tree_map(lambda a: a.cpu(), params)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    toks = torch.randint(0, cfg.vocab, (NEW_DECODE_B, RECURRENT_CPU_T),
                         generator=gen, device=dev)
    prefill, serve = make_prefill(model), make_serve_step(model)
    card = prefill(params, {"tokens": toks}).cpu()
    cpu = prefill(cpu_params, {"tokens": toks.cpu()})
    gaps = {"prefill": float((card - cpu).abs().max()) / float(
        cpu.abs().max())}
    caches = {"card": model.init_cache(NEW_DECODE_B, RECURRENT_DECODE_STEPS,
                                       dev),
              "cpu": model.init_cache(NEW_DECODE_B, RECURRENT_DECODE_STEPS,
                                      "cpu")}
    worst = 0.0
    for pos in range(RECURRENT_DECODE_STEPS):
        lg, caches["card"] = serve(params, caches["card"],
                                   toks[:, pos:pos + 1], pos)
        want, caches["cpu"] = serve(cpu_params, caches["cpu"],
                                    toks[:, pos:pos + 1].cpu(), pos)
        worst = max(worst, float((lg.cpu() - want).abs().max())
                    / float(want.abs().max()))
    gaps["decode"] = worst
    require(max(gaps.values()) <= 1e-4, f"reduced {arch} in f32: card and CPU "
            f"differ by {gaps} of the largest logit")
    paths = {}
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        model = build_model(cfg)
    r = decode_vs_forward(model, params, toks[:, :NEW_DECODE_T], dev, K)
    attn_layers = sum(m == "attn" for m, _ in model.kinds) * model.n_segments
    require(r["launches"]["flash_attention:ffma"] == attn_layers
            == r["launches"]["flash_attention"],
            f"reduced {arch}'s T={NEW_DECODE_T} forward launched K9 "
            f"{r['launches']['flash_attention']} times, not {attn_layers}")
    require(r["max_abs_gap"] <= 2e-3 * max(1.0, r["max_abs_logit"])
            and r["argmax_agreement"] >= ARGMAX_AGREE,
            f"reduced {arch}: decode and forward differ: {r}")
    paths[f"decode_vs_forward_{arch.split('-')[0]}_reduced"] = r.pop(
        "launches")
    g = greedy_vs_decode(arch, params, seed, dev, K, NEW_DECODE_B,
                         SMALL_GEN_PROMPT, SMALL_GEN_N, smoke=True)
    require(g["greedy_vs_decode_argmax"] == 1.0, f"reduced {arch}: greedy "
            f"generate differs from the teacher-forced argmax: {g}")
    paths[f"generate_{arch.split('-')[0]}_reduced"] = g.pop("launches")
    del params, cpu_params, caches
    torch.cuda.empty_cache()
    return {"card_vs_cpu_f32": {
        "shape": f"B={NEW_DECODE_B}, prefill T={RECURRENT_CPU_T}, "
                 f"{RECURRENT_DECODE_STEPS} decode steps",
        "max_gap_over_max_logit": gaps},
        "decode_vs_forward": r, "generate_vs_teacher_forced": g}, paths


def decode_jamba(dev, seed: int, K, params) -> dict:
    """Phase 9h's decode loops, after every profile: greedy ``generate``
    of the period at batch 1 (prompt 16, 8 tokens) against the
    teacher-forced serve step, then the reduced model's checks
    (``recurrent_reduced``). Returns the counts per path."""
    import torch

    t_phase = time.perf_counter()
    with cut_depth(JAMBA, JAMBA_LAYERS):
        rep = greedy_vs_decode(JAMBA, params, seed, dev, K, 1,
                               SMALL_GEN_PROMPT, SMALL_GEN_N)
    paths = {"generate_jamba": rep.pop("launches")}
    require(paths["generate_jamba"]["flash_attention"] == 0,
            "jamba's decode launched K9")
    del params
    torch.cuda.empty_cache()
    rep["reduced"], more = recurrent_reduced(JAMBA, dev, seed, K)
    paths.update(more)
    print(json.dumps({"decode_jamba": rep}), flush=True)
    print(f"# {JAMBA} decode phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def long_xlstm(dev, seed: int, K, params) -> dict:
    """Phase 9i after every profile: xlstm-350m's prefill at B = 1,
    T = 32,768 (host clock and CUDA events over one call, peak memory,
    no K9), greedy ``generate`` at batch 4 against the teacher-forced
    serve step (in bf16 the full model's forward and decode pick other
    tokens at many positions: its bf16 logits depart from f32 by most of
    the largest logit, the reference's own as much), then the reduced
    model's checks (``recurrent_reduced``). Every path launches no K9.
    Returns the counts per path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = get_config(XLSTM)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    tokens = torch.randint(0, cfg.vocab, (1, XLSTM_LONG_T), generator=gen,
                           device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    wall, logits = host_ms(lambda: make_prefill(model)(params,
                                                       {"tokens": tokens}))
    end.record()
    torch.cuda.synchronize()
    launches = counts(K)
    require(logits.shape == (1, XLSTM_LONG_T, cfg.vocab)
            and all(bool(torch.isfinite(c).all()) for c in logits.split(2048, 1)),
            f"{XLSTM}'s T={XLSTM_LONG_T} logits misshapen or not finite")
    del logits
    rep = {"long_prefill": {"shape": f"B=1, T={XLSTM_LONG_T}, bf16",
                            "host_ms": wall, "events_ms": start.elapsed_time(end),
                            "peak_memory_gb": torch.cuda.max_memory_allocated()
                            / 1e9}}
    paths = {f"prefill_{XLSTM}_long": launches}
    g = greedy_vs_decode(XLSTM, params, seed, dev, K, XLSTM_GEN_B,
                         SMALL_GEN_PROMPT, SMALL_GEN_N)
    paths["generate_xlstm"] = g.pop("launches")
    rep["generate"] = g
    del params
    torch.cuda.empty_cache()
    rep["reduced"], more = recurrent_reduced(XLSTM, dev, seed, K)
    paths.update(more)
    require(all(n["flash_attention"] == 0 for n in paths.values()),
            f"an {XLSTM} path launched K9: {paths}")
    print(json.dumps({f"decode_{XLSTM}": rep}), flush=True)
    print(f"# {XLSTM} long prefill and decode phase in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


# -- phase 10: the loss's gradient above 512 tokens ------------------------------

# the reduced model's check and the full model's backward at train_4k's
# sequence (the batch cut to 1)
GRAD_B, GRAD_T, TRAIN_T = 2, 600, 4096


def grad_qwen2(dev, seed: int, K) -> dict:
    """``loss_fn(...).backward()`` above 512 tokens, where the forward
    takes ``_sdpa_chunked`` while autograd records: reduced qwen2 in f32
    at B=2, T=600 on the card against the CPU port on the same weights
    (each leaf within 1e-4 of its largest |grad|), with no K9 launch; then
    the full qwen2-0.5B (24 layers, bf16) at B=1, T=4,096: host ms, peak
    memory, and a finite, nonzero gradient on every leaf."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map

    def leaves_of(params, device):
        return tree_map(lambda a: a.detach().to(device).requires_grad_(True),
                        params)

    # without remat, as this phase has measured the backward since PR 16
    # (phase 11 trains with it)
    model = build_model(get_config("qwen2-0.5b", smoke=True), use_remat=False)
    cpu_params = model.init_params(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 2)
    tokens = torch.randint(0, model.cfg.vocab, (GRAD_B, GRAD_T), generator=gen)
    batch = {"tokens": tokens, "targets": tokens.roll(-1, dims=1)}
    grads = {}
    for where in ("cpu", dev):
        leaves = leaves_of(cpu_params, where)
        K.reset_launches()
        model.loss_fn(leaves, {key: t.to(where) for key, t in batch.items()}
                      ).backward()
        require(K.LAUNCHES["flash_attention"] == 0,
                f"the forward under autograd launched K9 on {where}")
        grads[str(where)] = [leaf.grad.cpu() for leaf in tree_leaves(leaves)]
    worst = 0.0
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        scale = float(torch.max(torch.abs(want)))
        gap = float(torch.max(torch.abs(got - want)))
        require(scale > 0 and gap <= 1e-4 * scale,
                f"card and CPU gradients differ by {gap:.3e} of max "
                f"|grad| {scale:.3e} on a {tuple(want.shape)} leaf")
        worst = max(worst, gap / scale)

    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg, use_remat=False)
    params = leaves_of(model.init_params(
        torch.Generator(device=dev).manual_seed(seed)), dev)
    tokens = torch.randint(0, cfg.vocab, (1, TRAIN_T + 1),
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed + 3), device=dev)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()

    def step():
        for leaf in tree_leaves(params):
            leaf.grad = None
        loss = model.loss_fn(params, batch)
        loss.backward()
        return loss

    first_ms, loss = host_ms(step)
    ms = [host_ms(step)[0] for _ in range(2)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(K.LAUNCHES["flash_attention"] == 0,
            "the full model's forward under autograd launched K9")
    require(bool(torch.isfinite(loss)), "non-finite loss at T=4096")
    for leaf in tree_leaves(params):
        require(leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
                and bool((leaf.grad != 0).any()),
                f"a {tuple(leaf.shape)} leaf has no finite, nonzero gradient")
    rep = {"reduced_f32": {"shape": f"B={GRAD_B}, T={GRAD_T}, smoke config",
                           "max_gap_over_leaf_max_grad": worst},
           "full_bf16": {"shape": f"B=1, T={TRAIN_T}, {cfg.n_layers} layers, "
                                  "bf16", "loss": float(loss.detach()),
                         "first_ms": first_ms, "ms": ms,
                         "peak_memory_gb": peak_gb}}
    print(json.dumps({"grad_qwen2": rep}), flush=True)
    del params, loss
    torch.cuda.empty_cache()
    return rep


# -- phase 11: the train step at full width -----------------------------------------

# qwen2-0.5B's published configuration with random weights, remat on,
# make_optimizer("fednl", k_per_block=2048: the train driver's
# --curvature-k default), a batch of 4 sequences at train_4k's T = 4,096
# (its batch of 256 cut to 4): 4 microbatches, 4 silos of one sequence,
# a refresh every 2 steps, 3 steps. The Hutchinson step (a double
# backward per silo) runs once at T = 512, B = n_silos = 2: its graph at
# T = 4,096 is a later measurement. The reduced model (2 layers, d 64,
# f32, k = block^2 = 64 so no selection tie can part card and CPU) runs
# 3 fednl steps on the card and on the CPU port.
TRAIN_T, TRAIN_B, TRAIN_MB, TRAIN_SILOS = 4096, 4, 4, 4
TRAIN_REFRESH, TRAIN_STEPS, TRAIN_LR, CURVATURE_K = 2, 3, 3e-4, 2048
HVP_T, HVP_SILOS = 512, 2
SMALL_TRAIN = dict(n_layers=2, d_model=64, d_ff=128, vocab=128)
# each measured train step's ms and refresh flag by arch (phases 11-11c),
# held to its roofline in phase 12
MEASURED_STEPS: dict = {}


def _timed(opt, log: dict):
    """``opt`` with its refresh and precondition timed into ``log``."""
    def wrap(name, fn):
        def call(*args):
            ms, out = host_ms(lambda: fn(*args))
            log.setdefault(name, []).append(ms)
            return out
        return call

    return dataclasses.replace(opt, refresh=wrap("refresh", opt.refresh),
                               precondition=wrap("precondition",
                                                 opt.precondition))


def fednl_steps(label: str, model, params, pipe, opt, K, kept: dict):
    """``TRAIN_STEPS`` steps of ``make_train_step`` with ``opt`` (fednl;
    ``TRAIN_MB`` microbatches, ``TRAIN_SILOS`` silos, a refresh every
    ``TRAIN_REFRESH``) on ``pipe``'s batches: refresh flags [1, 0, 1], H
    bit for bit unchanged on step 1, finite loss and H, K1 once per
    tensor and K4 launched on the refresh steps alone, K9 never; the ms
    of each step, its launches, the peak memory. ``kept["want"]`` is set
    on the last step. Returns (params, state, the steps, the launches of
    all of them, the peak in GB)."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.tree import tree_leaves

    n_leaves = len(tree_leaves(params))
    step = make_train_step(model, opt, microbatches=TRAIN_MB,
                           refresh_every=TRAIN_REFRESH, n_silos=TRAIN_SILOS)
    state = opt.init(params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    total = {name: 0 for name in counts(K)}
    per_step = []
    for i in range(TRAIN_STEPS):
        batch = pipe.batch(i, device=params["embed"].device)
        h_before = [h.clone() for h in tree_leaves(state.h)] if i == 1 else None
        kept["want"] = i == TRAIN_STEPS - 1
        K.reset_launches()
        ms, (params, state, m) = host_ms(lambda: step(params, state, batch))
        got = counts(K)
        for name, c in got.items():
            total[name] += c
        refreshed = m["curv_refreshed"] == 1.0
        require(bool(torch.isfinite(m["loss"])), f"{label} step {i}: loss "
                f"{float(m['loss'])}")
        require(all(bool(torch.isfinite(h).all()) for h in tree_leaves(state.h)),
                f"{label} step {i}: non-finite H")
        require(refreshed == (i % TRAIN_REFRESH == 0),
                f"{label} step {i}: curv_refreshed {m['curv_refreshed']}")
        require(got["diff_topk_payload"] == (n_leaves if refreshed else 0)
                and (got["block_scatter_accumulate"] > 0) == refreshed,
                f"{label} step {i} (refresh {refreshed}) launched K1 "
                f"{got['diff_topk_payload']} times for {n_leaves} tensors, "
                f"K4 {got['block_scatter_accumulate']}")
        require(got["flash_attention"] == 0,
                f"{label} step {i}: the train step launched K9")
        if h_before is not None:
            require(all(torch.equal(a, b) for a, b in
                        zip(h_before, tree_leaves(state.h))),
                    f"{label}: H changed on a step without a refresh")
            del h_before
        per_step.append({"ms": ms, "loss": float(m["loss"]),
                         "refreshed": refreshed,
                         "grad_norm": float(m["grad_norm"]),
                         "k1": got["diff_topk_payload"],
                         "k4": got["block_scatter_accumulate"]})
    MEASURED_STEPS[model.cfg.name] = per_step
    return (params, state, per_step, total,
            torch.cuda.max_memory_allocated() / 1e9)


def train_qwen2(dev, seed: int, K, card: str) -> dict:
    """``make_train_step`` at full width: 3 fednl steps (refresh flags
    [1, 0, 1], H bit for bit unchanged on step 1, finite loss and H; K1
    and K4 launched on the refresh steps alone, K9 never), the ms of
    each step, of the refreshes and preconditions inside them, peak
    memory; an adamw step at the same shape; one Hutchinson step; the
    reduced model on the card against the CPU port. Returns the
    launches of the 3 fednl steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import (
        RademacherProbes,
        make_optimizer,
        make_train_step,
    )
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=TRAIN_T,
                         global_batch=TRAIN_B, seed=seed)
    log: dict = {}
    opt = _timed(make_optimizer("fednl", TRAIN_LR, k_per_block=CURVATURE_K),
                 log)
    params, state, per_step, total, peak_gb = fednl_steps(
        "qwen2", model, params, pipe, opt, K, {})
    del state, opt
    torch.cuda.empty_cache()

    # the first-order baseline at the same shape
    opt = make_optimizer("adamw", TRAIN_LR)
    step = make_train_step(model, opt, microbatches=TRAIN_MB)
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    batch = pipe.batch(0, device=dev)
    adamw_ms = []
    for _ in range(2):
        ms, (params, state, m) = host_ms(lambda: step(params, state, batch))
        adamw_ms.append(ms)
    require(bool(torch.isfinite(m["loss"])), "adamw: non-finite loss")
    adamw_peak = torch.cuda.max_memory_allocated() / 1e9
    del state, m, opt, step
    torch.cuda.empty_cache()

    # one Hutchinson step: z * Hz by double backward
    opt = make_optimizer("fednl", TRAIN_LR, k_per_block=CURVATURE_K,
                         curvature="hutchinson")
    step = make_train_step(model, opt, refresh_every=1, n_silos=HVP_SILOS,
                           hvp=True, probe_seed=seed)
    state = opt.init(params)
    batch = TokenPipeline(vocab_size=cfg.vocab, seq_len=HVP_T,
                          global_batch=HVP_SILOS, seed=seed).batch(0,
                                                                   device=dev)
    # one silo's probes alone: 494 M Rademacher draws on the CPU
    probe_ms = host_ms(lambda: RademacherProbes(seed)(0, 0, params))[0]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    hvp_ms, (_, state, m) = host_ms(lambda: step(params, state, batch))
    hvp_launches = counts(K)
    require(m["curv_refreshed"] == 1.0 and bool(torch.isfinite(m["loss"]))
            and all(bool(torch.isfinite(h).all())
                    for h in tree_leaves(state.h))
            and hvp_launches["diff_topk_payload"] > 0
            and hvp_launches["flash_attention"] == 0,
            f"the Hutchinson step: loss {float(m['loss'])}, launches "
            f"{hvp_launches}")
    hvp_peak = torch.cuda.max_memory_allocated() / 1e9
    del params, state, m, opt, step, model
    torch.cuda.empty_cache()

    # the reduced model: the card against the CPU port, 3 fednl steps
    worst = reduced_steps_card_vs_cpu(
        get_config("qwen2-0.5b").reduced(**SMALL_TRAIN), dev, seed)

    refresh_ms, precond_ms = log.get("refresh", []), log.get("precondition", [])
    rep = {"shape": f"B={TRAIN_B}, T={TRAIN_T}, {cfg.n_layers} layers, {cfg.dtype}, "
                    f"{TRAIN_MB} microbatches, {TRAIN_SILOS} silos, "
                    f"refresh every {TRAIN_REFRESH}, k={CURVATURE_K}",
           "steps": per_step, "refresh_ms": refresh_ms,
           "precondition_ms": precond_ms, "peak_memory_gb": peak_gb,
           "adamw_ms": adamw_ms, "adamw_peak_memory_gb": adamw_peak,
           "hutchinson": {"shape": f"B={HVP_SILOS}, T={HVP_T}, "
                                   f"{HVP_SILOS} silos",
                          "ms": hvp_ms, "peak_memory_gb": hvp_peak,
                          "one_silo_probe_draw_ms": probe_ms,
                          "k1": hvp_launches["diff_topk_payload"],
                          "k4": hvp_launches["block_scatter_accumulate"]},
           "reduced_card_vs_cpu_max_gap_over_leaf_max": worst,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    print(json.dumps({"train_qwen2": rep}), flush=True)
    return total


def reduced_steps_card_vs_cpu(small, dev, seed: int) -> float:
    """3 fednl steps of a reduced model (f32, B=4, T=128, 2 microbatches,
    2 silos, a refresh every 2 steps) on the card and on the CPU port
    from the same weights: every parameter and H leaf within 1e-4 of the
    CPU's largest |value| on it. Returns the worst gap over that max."""
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map

    model = build_model(small, use_remat=True)
    cpu_params = model.init_params(torch.Generator().manual_seed(seed))
    out = {}
    for where in ("cpu", dev):
        opt = make_optimizer("fednl", 1e-2, k_per_block=64, block=8)
        step = make_train_step(model, opt, microbatches=2, refresh_every=2,
                               n_silos=2)
        p = tree_map(lambda a: a.to(where), cpu_params)
        state = opt.init(p)
        spipe = TokenPipeline(vocab_size=small.vocab, seq_len=128,
                              global_batch=4, seed=seed)
        for i in range(TRAIN_STEPS):
            p, state, _ = step(p, state, spipe.batch(i, device=where))
        out[str(where)] = [t.cpu() for t in tree_leaves(p) + tree_leaves(state.h)]
    worst = 0.0
    for got, want in zip(out[str(dev)], out["cpu"]):
        scale = float(torch.max(torch.abs(want)))
        gap = float(torch.max(torch.abs(got - want)))
        require(gap <= 1e-4 * max(scale, 1e-30),
                f"reduced {small.name} train step: card and CPU differ by "
                f"{gap:.3e} of max {scale:.3e} on a {tuple(want.shape)} leaf")
        worst = max(worst, gap / max(scale, 1e-30))
    return worst


# -- phase 11b: the MoE train step at full width -------------------------------------

# granite-moe-1b-a400m's published configuration with random weights, as
# phase 11: fednl k = 2,048, 4 microbatches, 4 silos, train_4k's T = 4,096
# with its batch of 256 cut to 4, a refresh every 2 steps, 3 steps; the
# reduced model's gradient above 512 tokens on the card against the CPU
# port (f32, B = 2, T = 600), as phase 10
MOE_GRAD_B, MOE_GRAD_T = 2, 600


# rows of a tensor that K1's plain version takes at a time (a band of
# whole tile rows: its payloads are the kernel's tiles in that band)
REF_BAND_ROWS = 1024 * BLOCK


def refresh_checks(inputs: dict, label: str) -> dict:
    """K1 and K4 on one refresh's inputs ({name: (silo-stacked
    observations, H)}) of ``label``'s train step, each tensor as the
    refresh gives it to them:
    K1's payloads bit for bit against ``diff_topk_payload_ref`` per silo
    and band of tile rows, its ||D||^2 to 1e-5; K4's sum of those
    payloads bit for bit against ``block_scatter_accumulate_ref`` on CPU
    copies (in stream order there, as the kernel adds; atomics on the
    card). These launches are not the path's."""
    import torch
    from repro_torch.kernels.block_topk import (
        diff_topk_payload,
        diff_topk_payload_ref,
    )
    from repro_torch.kernels.scatter_accum import (
        block_scatter_accumulate,
        block_scatter_accumulate_ref,
    )
    from repro_torch.second_order.fednl_precond import _shape2d

    out = {}
    for name, (obs, h) in inputs.items():
        shape2 = _shape2d(h.shape)
        n = obs.shape[0]
        o2, h2 = obs.reshape((n,) + shape2), h.reshape(shape2)
        v, i, sq = diff_topk_payload(o2, h2, CURVATURE_K, BLOCK)
        grid = tuple(-(-x // BLOCK) for x in shape2)
        rel_sq = 0.0
        for s in range(n):
            sq_want = 0.0
            for r0 in range(0, shape2[0], REF_BAND_ROWS):
                r1 = min(r0 + REF_BAND_ROWS, shape2[0])
                t0, t1 = r0 // BLOCK * grid[1], -(-r1 // BLOCK) * grid[1]
                want = diff_topk_payload_ref(o2[s:s + 1, r0:r1], h2[r0:r1],
                                             CURVATURE_K, BLOCK)
                require(torch.equal(v[s:s + 1, t0:t1], want[0])
                        and torch.equal(i[s:s + 1, t0:t1], want[1]),
                        f"{label}'s refresh: diff_topk_payload differs from "
                        f"its plain version on {name} {tuple(h.shape)}, "
                        f"silo {s}, rows {r0}:{r1}")
                sq_want += float(want[2][0])
                del want
            rel = abs(float(sq[s]) - sq_want) / sq_want
            require(rel <= 1e-5, f"{label}'s refresh: diff_topk_payload's "
                    f"||D||^2 on {name} is off by {rel:.2e}")
            rel_sq = max(rel_sq, rel)
        got = block_scatter_accumulate(v, i, grid, BLOCK)
        want = block_scatter_accumulate_ref(v.cpu(), i.cpu(), grid, BLOCK)
        require(torch.equal(got.cpu(), want), f"{label}'s refresh: "
                f"block_scatter_accumulate differs from its plain version "
                f"on {name} {tuple(h.shape)}")
        out[name] = {"shape": list(h.shape), "silos": n,
                     "tiles_per_silo": grid[0] * grid[1],
                     "payloads_and_sum": "bitwise", "sq_norm_rel": rel_sq}
        del v, i, sq, got, want
    torch.cuda.empty_cache()
    print(f"# {label}'s refresh: K1 and K4 match their plain versions on "
          f"{', '.join(inputs)}: {json.dumps(out)}", flush=True)
    return out


def train_granite(dev, seed: int, K, card: str) -> dict:
    """``make_train_step`` on granite-moe-1b-a400m at full width: refresh
    flags [1, 0, 1], H bit for bit unchanged on step 1, finite loss and
    H; K1 and K4 launched on the refresh steps alone, K1 once per tensor
    (the 4-D expert leaves and the f32 router among them), K9 never; the
    loss is the cross-entropy plus 0.01 times the layers' aux loss; ms per
    step, peak memory; K1 and K4 on the last refresh's inputs of the
    expert wi leaf and the router against their plain versions; the
    reduced model's 3 fednl steps and its gradient at T = 600 on the card
    against the CPU port. Returns the launches of the 3 steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models import build_model
    from repro_torch.models.common import cross_entropy
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_config("granite-moe-1b-a400m")
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    n_leaves = len(tree_leaves(params))
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=TRAIN_T,
                         global_batch=TRAIN_B, seed=seed)
    log: dict = {}
    opt = _timed(make_optimizer("fednl", TRAIN_LR, k_per_block=CURVATURE_K),
                 log)
    kept: dict = {}
    refresh = opt.refresh

    def keep_inputs(state, obs):
        """The refresh, keeping the last one's observations and H of
        layers[0].ffn's expert wi and router for the kernels' checks."""
        if kept.get("want"):
            o, h = obs["layers"][0]["ffn"], state.h["layers"][0]["ffn"]
            kept["inputs"] = {name: (o[name], h[name])
                              for name in ("wi", "router")}
        return refresh(state, obs)

    opt = dataclasses.replace(opt, refresh=keep_inputs)
    params, state, per_step, total, peak_gb = fednl_steps(
        "granite", model, params, pipe, opt, K, kept)
    experts_h = state.h["layers"][0]["ffn"]["wi"]
    require(experts_h.dim() == 4 and bool((experts_h != 0).any()),
            "granite: the expert leaves' curvature was not learned")
    del state, opt, experts_h
    torch.cuda.empty_cache()

    # the loss holds the aux term: cross-entropy + router_aux_weight * aux
    one = {key: val[:1] for key, val in pipe.batch(0, device=dev).items()}
    with torch.no_grad():
        logits, aux = model.forward(params, one)
        ce = cross_entropy(logits, one["targets"])
        loss = model.loss_fn(params, one)
    want = ce + cfg.moe.router_aux_weight * aux
    require(float(aux) > 0 and abs(float(loss) - float(want))
            <= 1e-6 * abs(float(want)),
            f"granite's loss {float(loss)} is not the cross-entropy "
            f"{float(ce)} + {cfg.moe.router_aux_weight} x aux {float(aux)}")
    del params, model, logits
    torch.cuda.empty_cache()
    require("inputs" in kept, "granite: the last step did not refresh")
    kernels = refresh_checks(kept.pop("inputs"), "granite")

    # the reduced model: the card against the CPU port, 3 fednl steps
    steps_gap = reduced_steps_card_vs_cpu(
        get_config("granite-moe-1b-a400m").reduced(**SMALL_TRAIN), dev, seed)

    # the reduced model's gradient above 512 tokens: card against CPU
    small = get_config("granite-moe-1b-a400m", smoke=True)
    smodel = build_model(small, use_remat=True)
    cpu_params = smodel.init_params(torch.Generator().manual_seed(seed))
    tokens = torch.randint(0, small.vocab, (MOE_GRAD_B, MOE_GRAD_T),
                           generator=torch.Generator().manual_seed(seed + 2))
    sbatch = {"tokens": tokens, "targets": tokens.roll(-1, dims=1)}
    grads = {}
    for where in ("cpu", dev):
        leaves = tree_map(lambda a: a.detach().to(where).requires_grad_(True),
                          cpu_params)
        K.reset_launches()
        smodel.loss_fn(leaves, {key: x.to(where) for key, x in sbatch.items()}
                       ).backward()
        require(K.LAUNCHES["flash_attention"] == 0,
                f"reduced granite under autograd launched K9 on {where}")
        grads[str(where)] = [leaf.grad.cpu() for leaf in tree_leaves(leaves)]
    worst = 0.0
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        scale = float(torch.max(torch.abs(want)))
        gap = float(torch.max(torch.abs(got - want)))
        require(scale > 0 and gap <= 1e-4 * scale,
                f"reduced granite: card and CPU gradients differ by "
                f"{gap:.3e} of max |grad| {scale:.3e} on a "
                f"{tuple(want.shape)} leaf")
        worst = max(worst, gap / scale)
    rep = {"shape": f"B={TRAIN_B}, T={TRAIN_T}, {cfg.n_layers} layers, "
                    f"{cfg.dtype}, {TRAIN_MB} microbatches, {TRAIN_SILOS} "
                    f"silos, refresh every {TRAIN_REFRESH}, k={CURVATURE_K}",
           "tensors": n_leaves, "steps": per_step,
           "refresh_ms": log.get("refresh", []),
           "precondition_ms": log.get("precondition", []),
           "peak_memory_gb": peak_gb,
           "loss_terms": {"cross_entropy": float(ce), "aux": float(aux),
                          "loss": float(loss)},
           "refresh_kernels_vs_plain": kernels,
           "reduced_steps_card_vs_cpu_max_gap_over_leaf_max": steps_gap,
           "reduced_grad": {"shape": f"B={MOE_GRAD_B}, T={MOE_GRAD_T}, f32",
                            "max_gap_over_leaf_max_grad": worst},
           "phase_s": time.perf_counter() - t_phase, "card": card}
    print(json.dumps({"train_granite": rep}), flush=True)
    return total


# -- phase 11c: xlstm-350m trained whole, jamba's Mamba under autograd ---------------

# xlstm-350m as phase 11 (fednl k = 2,048, 4 microbatches, 4 silos, a
# refresh every 2 steps, 3 steps), train_4k's batch of 256 cut to 4 and its
# T of 4,096 to 512: the sLSTM's step loop is host-bound (about 22
# launches a token, PERF.md section 5); its depth cut 24 -> 8 layers, one
# period of 7 mLSTM and 1 sLSTM blocks (every one of its 57 tensors, each
# a stack of one layer), to keep the script inside its time
XLSTM_TRAIN_T, XLSTM_TRAIN_LAYERS = 512, 8
# one full-width jamba Mamba mixer, forward and backward at B = 1
MAMBA_BWD_T = 4096
# its bf16 input gradient against f32: within 8 bf16 steps of the largest
MAMBA_GRAD_STEPS = 8


def train_xlstm(dev, seed: int, K, card: str) -> dict:
    """``make_train_step`` on xlstm-350m at its published width, one
    period deep (``XLSTM_TRAIN_LAYERS``): refresh flags [1, 0, 1],
    H bit for bit unchanged on step 1, finite loss and H, K1 once per
    tensor and K4 launched on the refresh steps alone, K9 never; ms per
    step, of each refresh and precondition, peak memory; K1 and K4 on the
    last refresh's inputs of an mLSTM and the sLSTM leaf against their
    plain versions. Returns the launches of the 3 steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(XLSTM), n_layers=XLSTM_TRAIN_LAYERS)
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    n_leaves = len(tree_leaves(params))
    slstm = [m for m, _ in model.kinds].index("slstm")
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=XLSTM_TRAIN_T,
                         global_batch=TRAIN_B, seed=seed)
    log: dict = {}
    opt = _timed(make_optimizer("fednl", TRAIN_LR, k_per_block=CURVATURE_K),
                 log)
    kept: dict = {}
    refresh = opt.refresh

    def keep_inputs(state, obs):
        """The refresh, keeping the last one's observations and H of
        layer 0's mLSTM query and the sLSTM's recurrent weight."""
        if kept.get("want"):
            kept["inputs"] = {
                "layers[0].mixer.wq (mLSTM)": (
                    obs["layers"][0]["mixer"]["wq"],
                    state.h["layers"][0]["mixer"]["wq"]),
                f"layers[{slstm}].mixer.wr (sLSTM)": (
                    obs["layers"][slstm]["mixer"]["wr"],
                    state.h["layers"][slstm]["mixer"]["wr"])}
        return refresh(state, obs)

    opt = dataclasses.replace(opt, refresh=keep_inputs)
    params, state, per_step, total, peak_gb = fednl_steps(
        "xlstm", model, params, pipe, opt, K, kept)
    for pos, (mixer, _) in enumerate(model.kinds):
        h = state.h["layers"][pos]["mixer"]
        require(all(bool((x != 0).any()) for x in tree_leaves(h)),
                f"xlstm: a {mixer} leaf at position {pos} learned no "
                f"curvature")
    del state, opt, params, model
    torch.cuda.empty_cache()
    require("inputs" in kept, "xlstm: the last step did not refresh")
    kernels = refresh_checks(kept.pop("inputs"), "xlstm")
    rep = {"shape": f"B={TRAIN_B}, T={XLSTM_TRAIN_T}, {cfg.n_layers} layers, "
                    f"{cfg.dtype}, {TRAIN_MB} microbatches, {TRAIN_SILOS} "
                    f"silos, refresh every {TRAIN_REFRESH}, k={CURVATURE_K}",
           "tensors": n_leaves, "steps": per_step,
           "refresh_ms": log.get("refresh", []),
           "precondition_ms": log.get("precondition", []),
           "peak_memory_gb": peak_gb, "refresh_kernels_vs_plain": kernels,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    print(json.dumps({"train_xlstm": rep}), flush=True)
    return total


def mamba_backward(dev, seed: int, card: str) -> dict:
    """One full-width jamba Mamba mixer (d 8,192, Di 16,384, S 16; bf16,
    B = 1, T = ``MAMBA_BWD_T``): forward and backward through the scan's
    checkpointed chunks, twice, by the host clock; the peak memory of a
    pass; the input gradient against the same pass on f32 copies, within
    ``MAMBA_GRAD_STEPS`` bf16 steps of its largest entry."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import mamba
    from repro_torch.tree import tree_map

    cfg = get_config(JAMBA)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = mamba.mamba_init(gen, cfg)
    x = torch.randn((1, MAMBA_BWD_T, cfg.d_model), generator=gen,
                    device=dev).to(cfg.tdtype)
    g = torch.randn((1, MAMBA_BWD_T, cfg.d_model), generator=gen,
                    device=dev).to(cfg.tdtype)

    def grads(params, xin, dy, c):
        leaves = tree_map(lambda a: a.detach().requires_grad_(True), params)
        xg = xin.detach().requires_grad_(True)
        fwd_ms, y = host_ms(lambda: mamba.mamba_forward(leaves, xg, c))
        bwd_ms, _ = host_ms(lambda: y.backward(dy))
        return fwd_ms, bwd_ms, xg.grad

    runs = []
    for _ in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fwd_ms, bwd_ms, gx = grads(p, x, g, cfg)
        runs.append({"forward_ms": fwd_ms, "backward_ms": bwd_ms,
                     "peak_gb_over_held": (torch.cuda.max_memory_allocated()
                                           - held) / 1e9})
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    _, _, gx32 = grads(tree_map(lambda a: a.float(), p), x.float(), g.float(),
                       cfg32)
    gap = float((gx.float() - gx32).abs().max())
    scale = float(gx32.abs().max())
    require(bool(torch.isfinite(gx).all()) and scale > 0
            and gap <= MAMBA_GRAD_STEPS * 2.0 ** -7 * scale,
            f"the full-width Mamba mixer's bf16 input gradient is {gap:.3e} "
            f"off f32 (max {scale:.3e})")
    rep = {"shape": f"B=1, T={MAMBA_BWD_T}, d {cfg.d_model}, Di "
                    f"{cfg.mamba.expand * cfg.d_model}, S "
                    f"{cfg.mamba.d_state}, bf16",
           "runs": runs,
           "input_grad_vs_f32_bf16_steps_of_max": gap / (scale * 2.0 ** -7),
           "card": card}
    del p, x, g, gx, gx32
    torch.cuda.empty_cache()
    return rep


def train_jamba(dev, seed: int, K, card: str) -> dict:
    """Reduced jamba's 3 fednl steps on the card against the CPU port (1e-4
    of each leaf's largest |value|), its K1 and K4 launched on the card;
    one full-width Mamba mixer's forward and backward
    (``mamba_backward``). Returns the launches of the card's 3 steps."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    K.reset_launches()
    gap = reduced_steps_card_vs_cpu(get_config(JAMBA, smoke=True), dev, seed)
    launches = counts(K)
    require(launches["diff_topk_payload"] > 0
            and launches["block_scatter_accumulate"] > 0
            and launches["flash_attention"] == 0,
            f"reduced jamba's train steps launched {launches}")
    rep = {"reduced_steps_card_vs_cpu_max_gap_over_leaf_max": gap,
           "reduced_launches": {"k1": launches["diff_topk_payload"],
                                "k4": launches["block_scatter_accumulate"]},
           "mamba_mixer_backward": mamba_backward(dev, seed, card),
           "phase_s": time.perf_counter() - t_phase, "card": card}
    print(json.dumps({"train_jamba": rep}), flush=True)
    return launches


# -- phase 12: the roofline of the measured train steps ------------------------------

# (arch, batch, T, layers: None for the published depth) of each
# measured train step (phases 11, 11b, 11c)
ROOFLINE_STEPS = [("qwen2-0.5b", TRAIN_B, TRAIN_T, None),
                  ("granite-moe-1b-a400m", TRAIN_B, TRAIN_T, None),
                  (XLSTM, TRAIN_B, XLSTM_TRAIN_T, XLSTM_TRAIN_LAYERS)]


def count_train_steps() -> int:
    """The ``--count-train-steps`` mode: ``dryrun.train_step_roofline`` of
    each measured step, with and without a refresh, on the meta device (no
    card); one JSON line."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import train_step_roofline

    torch.set_num_threads(1)
    out = {}
    for arch, b, t, layers in ROOFLINE_STEPS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        for refresh in (True, False):
            t0 = time.perf_counter()
            rl, c = train_step_roofline(cfg, b, t, "fednl", refresh,
                                        k_per_block=CURVATURE_K)
            out[f"{arch}:{'refresh' if refresh else 'plain'}"] = {
                "flops": rl.flops, "bytes": rl.bytes_hbm,
                "t_compute_s": rl.t_compute, "t_memory_s": rl.t_memory,
                "model_flops": rl.model_flops, "aten_ops": c["ops"],
                "count_s": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return 0


def start_train_counts():
    """This script in ``--count-train-steps`` mode, in the background on
    the host (one thread, no card): phase 12 reads its line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--count-train-steps"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def roofline_of_steps(counter, card: str) -> dict:
    """Each measured train step beside the roofline of its shape (the
    background count): its compute and memory terms, and the step's ms
    over the larger. A step faster than either term fails: the count
    would be wrong."""
    try:
        out, err = counter.communicate(timeout=1800)
    except subprocess.TimeoutExpired:
        counter.kill()
        counter.communicate()
        raise SmokeFailure("the train steps' count did not finish")
    require(counter.returncode == 0 and out.strip(),
            f"the train steps' count failed: {err[-2000:]}")
    rows = json.loads(out.strip().splitlines()[-1])
    report = {}
    for arch, b, t, layers in ROOFLINE_STEPS:
        require(arch in MEASURED_STEPS, f"no measured train step of {arch}")
        for i, st in enumerate(MEASURED_STEPS[arch]):
            rl = rows[f"{arch}:{'refresh' if st['refreshed'] else 'plain'}"]
            floor_ms = 1e3 * max(rl["t_compute_s"], rl["t_memory_s"])
            require(st["ms"] >= 1e3 * rl["t_compute_s"]
                    and st["ms"] >= 1e3 * rl["t_memory_s"],
                    f"{arch} step {i} took {st['ms']:.1f} ms, under its "
                    f"roofline's compute {1e3 * rl['t_compute_s']:.1f} ms or "
                    f"memory {1e3 * rl['t_memory_s']:.1f} ms term")
            report[f"{arch} step {i}"] = {
                "shape": f"B={b}, T={t}" + (f", {layers} layers" if layers
                                            else ""),
                "refreshed": st["refreshed"],
                "ms": st["ms"], "compute_ms": 1e3 * rl["t_compute_s"],
                "memory_ms": 1e3 * rl["t_memory_s"],
                "ms_over_roofline": st["ms"] / floor_ms,
                "flops": rl["flops"], "bytes": rl["bytes"],
                "model_flops": rl["model_flops"]}
    report["count_s"] = {key: row["count_s"] for key, row in rows.items()}
    print(json.dumps({"roofline_train_steps": report, "card": card}),
          flush=True)
    return report


# -- phase 13: the autotuner and the kernels' launch budgets -----------------

# the launch query's args that the paths and the tuner's candidates give
# each kernel: payload widths k of K1/K5 (K6 takes 0), every digit width of
# K2's count/place, every sum width 2^log_sub of K2's sum, every K4 block;
# K7, K8 and K9 launch with no argument
QUERY_ARGS = {
    "block_topk": (0, 1, 8, 32, 64, 300, 2048, 4096, 16384),
    "accum_count_kernel": tuple(range(1, 12)),
    "accum_place_kernel": tuple(range(1, 12)),
    "accum_sum_kernel": tuple(range(0, 12)),
    "block_scatter_kernel": (8, 16, 32, 64, 128, 256),
}
QWEN_K9 = (32768, 14, 2, 64)       # qwen2-0.5B layer 0's prefill: T, H, KV, hd
JAMBA_K9 = (4096, 64, 8, 128)      # jamba's attention layer at n_rep 8


def query_args(source: str, kernel: str) -> tuple:
    if source == "block_topk":
        return (0,) if kernel.startswith("block_topk_dense") \
            else QUERY_ARGS["block_topk"]
    return QUERY_ARGS.get(kernel.split("<")[0], (0,))


def launch_matches(lc, seen: dict) -> dict:
    """``launch_resources``' pricing of one launch against the card's
    launch query: threads, dynamic shared bytes, registers and static
    shared bytes equal, the block within 227 KB and 65,536 registers."""
    from repro_torch.kernels.resources import query

    key = (lc.source, lc.kernel, lc.arg)
    got = seen.get(key)
    if got is None:
        got = seen[key] = query(lc)
    want = {"registers": lc.registers, "static_smem": lc.static_smem,
            "threads": lc.threads, "dynamic_smem": lc.dynamic_smem}
    for name, value in want.items():
        require(got[name] == value, f"{lc.kernel} (arg {lc.arg}): "
                f"launch_resources gives {name} {value}, the card "
                f"{got[name]}")
    require(lc.threads <= got["max_threads"], f"{lc.kernel}: {lc.threads} "
            f"threads over the kernel's {got['max_threads']}")
    require(lc.fits(), f"over a block's budget: {lc.describe()}")
    return got


def kernel_budgets(seen: dict) -> dict:
    """Every kernel function of every source at every argument its paths
    and the tuner's candidates give it (``QUERY_ARGS``): the pricing in
    Python equal to the card's query, each launch within budget. Returns
    each function's registers and shared bytes (static; dynamic at its
    largest argument)."""
    from repro_torch.kernels.resources import KERNELS

    out = {}
    for source, names in KERNELS.items():
        for kernel in names:
            for arg in query_args(source, kernel):
                got = launch_matches(_launch_of(source, kernel, arg), seen)
            out[kernel] = {"registers": got["registers"],
                           "static_smem": got["static_smem"],
                           "dynamic_smem": got["dynamic_smem"],
                           "threads": got["threads"],
                           "block_registers": got["registers"]
                           * got["threads"]}
    return out


def _launch_of(source: str, kernel: str, arg: int):
    """The ``Launch`` that ``launch_resources`` prices for ``kernel`` (a
    name of ``resources.KERNELS``) at query argument ``arg``."""
    import torch
    from repro_torch.kernels import resources as R
    from repro_torch.kernels.scatter_accum.ops import ScatterPlan

    base, _, rest = kernel.partition("<")
    targs = rest.rstrip(">").split(", ") if rest else []
    t = torch.float64 if "double" in targs else torch.float32
    vec = targs[-1:] == ["true"]
    if base == "diff_topk_payload_kernel":
        found = R.launch_resources("diff_topk_payload", dtype=t, k=arg,
                                   vec=vec, shared_b=targs[1] == "true")
    elif base == "block_topk_payload_kernel":
        found = R.launch_resources("block_topk_payload", dtype=t, k=arg,
                                   vec=vec)
    elif base == "block_topk_dense_kernel":
        found = R.launch_resources("block_topk", dtype=t, vec=vec)
    elif base == "block_scatter_kernel":
        found = R.launch_resources("block_scatter_accumulate", dtype=t,
                                   block=arg, vec=vec)
    elif base.startswith("accum_"):
        # a two-pass plan with digits of `arg` bits and sum warps of 2^arg
        # cells: its launches include every accum_* kernel of type t
        plan = ScatterPlan(entries=1, cells=1, log_r=arg, log_sub=arg,
                           regions=1, digit_bits=max(arg, 1), passes=2,
                           seg=32, chunks=1, layout=(), scratch_bytes=0)
        found = R.launch_resources("scatter_accumulate", dtype=t, plan=plan)
    elif base.startswith("flash_attention_kernel"):
        hd, bq, bk = (int(x) for x in targs[-3:])
        found = R.launch_resources(
            "flash_attention", dtype=torch.bfloat16 if "wgmma" in base
            else torch.float32, hd=hd, bq=bq, bk=bk)
    elif base == "hess_update_kernel":
        found = R.launch_resources("hess_update", dtype=t)
    else:
        route, layout, chunks = {
            "tiled_matmul_kernel": ("tiled", "rows", 1),
            "tiled_matmul_small_k_kernel": ("small_k", "rows", 1),
            "tiled_matmul_small_n_rows_kernel": ("small_n", "rows", 1),
            "tiled_matmul_small_n_cols_kernel": ("small_n", "cols", 1),
            "tiled_matmul_sum_partials_kernel": ("small_n", "rows", 2)}[base]
        found = R.launch_resources("tiled_matmul", route=route, layout=layout,
                                   chunks=chunks)
    matches = [lc for lc in found if lc.kernel == kernel]
    require(len(matches) > 0 and matches[0].source == source,
            f"launch_resources prices no launch of {kernel}")
    return matches[0]


def _tune(name: str, autotune, default, pool: list, run, launches,
          card: str, seen: dict) -> dict:
    """Run the tuner (``autotune(timings)``: an ``autotune_*`` of
    ``kernels.tuning`` that measures 20 calls a candidate and records the
    winner), price every candidate of ``pool`` equal to the card's query
    and within budget, and time the untuned ``default`` and the winner
    (CUDA events, 50 calls each, in turns default, winner, winner,
    default). Returns the entry: each measured candidate's us, the
    winner, both ms."""
    for cfg in pool:
        for lc in launches(cfg):
            launch_matches(lc, seen)
    us: dict = {}
    winner = autotune(us)
    d1 = time_cuda(lambda: run(default))
    w1 = time_cuda(lambda: run(winner))
    w2 = time_cuda(lambda: run(winner))
    d2 = time_cuda(lambda: run(default))
    out = {"candidates_us": {json.dumps(c.to_dict()): us[c] for c in us},
           "pool": len(pool), "default": default.to_dict(),
           "winner": winner.to_dict(), "default_ms": [d1, d2],
           "winner_ms": [w1, w2], "card": card}
    print(f"# tuned {name}: {json.dumps(out)}", flush=True)
    return out


def tuning_phase(dev, prob, x0, wg0, card: str, K) -> dict:
    """Phase 13: every kernel function's launch priced in Python equal to
    the card's query and within budget (``kernel_budgets``); K2 at w8a and
    at the K3 shape, K7 on the w8a Hessian stack, K8's small_n on
    wg[0] @ Q and K9 at qwen2's and jamba's prefill shapes tuned into a
    fresh cache; then each op called with no config launches the cached
    config (its resolver and its launch counter) and equals its plain
    version (K2 and K3 bit for bit on CPU copies, K7's H bit for bit and
    its l to 1e-6, K8 to 1e-5 of the largest entry, K9 by
    ``bf16_attention_check`` on the first and last head); the cache saved,
    reloaded through ``REPRO_TORCH_TUNING_CACHE`` and resolving the same.
    Leaves the process on an empty cache."""
    import tempfile

    import torch
    from repro_torch.core import FedNL, make_compressor
    from repro_torch.kernels import resources as R
    from repro_torch.kernels import tuning as T
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import resolve_tiles
    from repro_torch.kernels.hess_update import (
        DEFAULT_BLOCK,
        hess_update,
        hess_update_ref,
        resolve_block,
    )
    from repro_torch.kernels.scatter_accum import (
        scatter_accumulate,
        scatter_accumulate_ref,
    )
    from repro_torch.kernels.scatter_accum.ops import resolve_plan
    from repro_torch.kernels.tiled_matmul import tiled_matmul, tiled_matmul_ref
    from repro_torch.kernels.tiled_matmul.ops import resolve_plan as mm_plan

    t0 = time.perf_counter()
    seen: dict = {}
    budgets = kernel_budgets(seen)
    print(f"# kernel registers and shared bytes ({card}): "
          f"{json.dumps(budgets)}", flush=True)
    cache = T.TuningCache()
    T.set_cache(cache)
    tuned = {}
    gen = torch.Generator(device=dev).manual_seed(13)

    # -- K2 at w8a (Top-K, k = d) and at the K3 shape
    d = prob["d"]
    pay = make_compressor("topk", d).compress(
        prob["hess"](x0) - prob["hess"](prob["xstar"]))
    idx3 = torch.randint(0, K3_D * K3_D, (K3_N, K3_D), generator=gen,
                         device=dev)
    r, c = idx3 // K3_D, idx3 % K3_D
    idx3 = (torch.maximum(r, c) * K3_D + torch.minimum(r, c)).to(torch.int32)
    k2_cases = {
        "scatter_accumulate_w8a": (pay.values.contiguous(),
                                   pay.indices.contiguous(), (d, d)),
        "scatter_accumulate_k3": (
            torch.randn((K3_N, K3_D), generator=gen, device=dev,
                        dtype=torch.float64), idx3.contiguous(),
            (K3_D, K3_D))}

    def plan_of(vals, shape, cfg=None):
        n, k = vals.shape
        f = {} if cfg is None else dict(log_r=cfg.log_r,
                                        digit_bits=cfg.digit_bits,
                                        seg=cfg.seg)
        return resolve_plan(n, k, shape[0], shape[1], False, vals.dtype, dev,
                            **f)

    for name, (vals, idx, shape) in k2_cases.items():
        n, k = vals.shape

        def run(cfg, vals=vals, idx=idx, shape=shape):
            return scatter_accumulate(vals, idx, shape, log_r=cfg.log_r,
                                      digit_bits=cfg.digit_bits, seg=cfg.seg)

        pool = T.scatter_candidates(shape, k, n, vals.dtype)
        tuned[name] = _tune(
            name, lambda us, vals=vals, idx=idx, shape=shape:
            T.autotune_scatter_accumulate(vals, idx, shape, reps=20,
                                          timings=us),
            pool[0], pool, run,
            lambda cf, vals=vals, shape=shape: R.launch_resources(
                "scatter_accumulate", dtype=vals.dtype,
                plan=plan_of(vals, shape, cf)), card, seen)
        w = tuned[name]["winner"]
        p = plan_of(vals, shape)
        require((p.log_r, p.digit_bits, p.seg) == (w["log_r"], w["digit_bits"],
                                                   w["seg"]),
                f"{name}: with no plan given the resolver gives {p}, not the "
                f"winner {w}")
        before = K.LAUNCHES["scatter_accumulate"]
        got = scatter_accumulate(vals, idx, shape)
        torch.cuda.synchronize()
        require(K.LAUNCHES["scatter_accumulate"] == before + 1,
                f"{name}: scatter_accumulate did not launch")
        require(torch.equal(got.cpu(), scatter_accumulate_ref(
            vals.cpu(), idx.cpu(), shape)),
            f"{name}: the tuned K2 differs from its plain version")

    # -- K7 on the w8a Hessian stack (FedNL lines 5-6's operands)
    alg = FedNL(prob["grad"], prob["hess"], make_compressor("blocktopk", 8),
                option=2, mu=MU)
    state = alg.step(alg.init(x0, prob["n"]))
    hesses = prob["hess"](state.x)
    payloads, _ = alg._uplink_diff_payloads(hesses, state.h_local)
    s_i = alg._local_hessians(payloads, tuple(hesses.shape[1:])).contiguous()
    h = state.h_local

    def run7(cfg):
        return hess_update(h, hesses, s_i, alg.alpha, block=cfg.block)

    tuned["hess_update_w8a"] = _tune(
        "hess_update_w8a", lambda us: T.autotune_hess_update(
            h, hesses, s_i, alg.alpha, reps=20, timings=us),
        T.KernelConfig(block=DEFAULT_BLOCK),
        T.hess_candidates(h.shape, h.dtype), run7,
        lambda cf: R.launch_resources("hess_update", dtype=h.dtype), card,
        seen)
    block = tuned["hess_update_w8a"]["winner"]["block"]
    require(resolve_block(h.shape, h.dtype, dev) == block,
            "hess_update: the resolver does not give the winner's block")
    before = K.LAUNCHES["hess_update"]
    out, l = hess_update(h, hesses, s_i, alg.alpha)
    want = hess_update_ref(h, hesses, s_i, alg.alpha, block)
    torch.cuda.synchronize()
    require(K.LAUNCHES["hess_update"] == before + 1,
            "hess_update did not launch")
    require(torch.equal(out, want[0]), "the tuned K7's H differs from its "
            "plain version")
    rel7 = float(torch.max(torch.abs(l - want[1]) / want[1]))
    require(rel7 <= 1e-6, f"the tuned K7's l off its plain version by "
            f"{rel7:.2e}")
    h_shape = tuple(h.shape)
    del state, hesses, payloads, s_i, h, out, want

    # -- K8's small_n route on wg[0] @ Q (the power iteration's M Q, r = 2)
    m32 = wg0.float().contiguous()
    q = torch.linalg.qr(torch.randn((m32.shape[1], 2), generator=gen,
                                    device=dev))[0]

    def run8(cfg):
        return tiled_matmul(m32, q, chunks=cfg.chunks)

    pool = T.matmul_candidates(m32, q)
    tuned["tiled_matmul_wg0"] = _tune(
        "tiled_matmul_wg0", lambda us: T.autotune_tiled_matmul(
            m32, q, reps=20, timings=us), pool[0], pool, run8,
        lambda cf: R.launch_resources("tiled_matmul", route="small_n",
                                      layout="rows", chunks=cf.chunks),
        card, seen)

    def mm_chunks():
        p = mm_plan(m32.shape[0], 2, m32.shape[1], m32.stride(),
                    m32.data_ptr() % 16 == 0, dev)
        return p.chunks if p.route == "small_n" else None

    require(mm_chunks() == tuned["tiled_matmul_wg0"]["winner"]["chunks"],
            "tiled_matmul: the resolver does not give the winner's chunks")
    before = K.ROUTES["tiled_matmul"]["small_n"]
    got = tiled_matmul(m32, q)
    torch.cuda.synchronize()
    require(K.ROUTES["tiled_matmul"]["small_n"] == before + 1,
            "tiled_matmul did not take the small_n route")
    rel8 = max_rel(got, tiled_matmul_ref(m32, q))
    require(rel8 <= 1e-5, f"the tuned K8 off its plain version by {rel8:.2e}")

    # -- K9 at qwen2's and jamba's prefill shapes (bf16: the wgmma route)
    k9_err = {"flash_attention": 0.0}
    k9_cases = {"flash_attention_qwen2": QWEN_K9,
                "flash_attention_jamba": JAMBA_K9}
    for name, (t, nh, kvh, hd) in k9_cases.items():
        qq, kk, vv = (torch.randn((1, t, nn, hd), generator=gen, device=dev)
                      .to(torch.bfloat16) for nn in (nh, kvh, kvh))

        def run9(cfg, qq=qq, kk=kk, vv=vv):
            return flash_attention(qq, kk, vv, bq=cfg.bq, bk=cfg.bk)

        pool = T.flash_candidates(hd, torch.bfloat16)
        tuned[name] = _tune(
            name, lambda us, qq=qq, kk=kk, vv=vv: T.autotune_flash_attention(
                qq, kk, vv, reps=20, timings=us), pool[0], pool, run9,
            lambda cf, hd=hd: R.launch_resources(
                "flash_attention", dtype=torch.bfloat16, hd=hd, bq=cf.bq,
                bk=cf.bk), card, seen)
        w = tuned[name]["winner"]
        require(resolve_tiles(t, hd, nh // kvh, None, torch.bfloat16, dev)
                == (w["bq"], w["bk"]),
                f"{name}: the resolver does not give the winner's tiles")
        before = K.ROUTES["flash_attention"]["wgmma"]
        check_flash(qq, kk, vv, (0, nh - 1), k9_err, f"{name} tuned")
        torch.cuda.synchronize()
        require(K.ROUTES["flash_attention"]["wgmma"] == before + 1,
                f"{name}: K9 did not launch on the wgmma route")
        del qq, kk, vv

    # -- the cache, saved and reloaded through the env var
    saved = cache.entries()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "tuning.json")
        cache.save(path)
        os.environ[T.CACHE_ENV] = path
        T.set_cache(None)
        try:
            require(T.get_cache().entries() == saved,
                    "the reloaded cache differs from the saved one")
            for name, (vals, _, shape) in k2_cases.items():
                p = plan_of(vals, shape)
                w = tuned[name]["winner"]
                require((p.log_r, p.digit_bits, p.seg) == (
                    w["log_r"], w["digit_bits"], w["seg"]),
                    f"{name}: the reloaded cache resolves to {p}")
            require(resolve_block(h_shape, torch.float64, dev) == block,
                    "hess_update: the reloaded cache resolves otherwise")
            require(mm_chunks() == tuned["tiled_matmul_wg0"]["winner"][
                "chunks"], "tiled_matmul: the reloaded cache resolves "
                "otherwise")
            for name, (t, nh, kvh, hd) in k9_cases.items():
                w = tuned[name]["winner"]
                require(resolve_tiles(t, hd, nh // kvh, None, torch.bfloat16,
                                      dev) == (w["bq"], w["bk"]),
                        f"{name}: the reloaded cache resolves otherwise")
        finally:
            del os.environ[T.CACHE_ENV]
            T.set_cache(T.TuningCache())
    print(f"# phase 13 (tuning, launch budgets) in "
          f"{time.perf_counter() - t0:.1f} s: every launch priced equal to "
          f"the card's query ({len(seen)} queries); tuned dispatch held: "
          f"K2/K3 bitwise, K7 H bitwise and l to {rel7:.2e}, K8 to "
          f"{rel8:.2e}, K9 {json.dumps(k9_err)}; the cache reloads through "
          f"{T.CACHE_ENV}", flush=True)
    return {"tuned": tuned, "budgets": budgets}


# the kernel line's entry of each tuned case, and the kernel functions of
# each entry's wrapper
TUNED_ENTRY = {"scatter_accumulate_w8a": "scatter_accumulate",
               "scatter_accumulate_k3": "scatter_accumulate_tiled",
               "hess_update_w8a": "hess_update",
               "tiled_matmul_wg0": "tiled_matmul",
               "flash_attention_qwen2": "flash_attention",
               "flash_attention_jamba": "flash_attention"}
ENTRY_KERNELS = {"diff_topk_payload": ("diff_topk_payload_kernel",),
                 "scatter_accumulate": ("accum_",),
                 "scatter_accumulate_tiled": ("accum_",),
                 "block_scatter_accumulate": ("block_scatter_kernel",),
                 "block_topk_payload": ("block_topk_payload_kernel",),
                 "block_topk": ("block_topk_dense_kernel",),
                 "hess_update": ("hess_update_kernel",),
                 "tiled_matmul": ("tiled_matmul_",),
                 "flash_attention": ("flash_attention_kernel",)}


def attach_phase13(kernels: list, ph13: dict) -> None:
    """Each kernel line entry gets its wrapper's kernel functions'
    registers and shared bytes (``launch``) and, where tuned, the
    default's and the winner's ms (``tuned``)."""
    for entry in kernels:
        prefixes = ENTRY_KERNELS[entry["name"]]
        entry["launch"] = {k: v for k, v in ph13["budgets"].items()
                           if k.startswith(prefixes)}
        entry["tuned"] = {case: ph13["tuned"][case]
                          for case, name in TUNED_ENTRY.items()
                          if name == entry["name"]}


def kernel_name(mangled: str) -> str:
    """A kernel's C++ name with its template arguments, without its
    namespace and parameters (``c++filt``; the mangled name without it)."""
    try:
        out = subprocess.run(["c++filt", mangled], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except OSError:
        return mangled
    name = out.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip() or mangled


def ptxas_lines(log: str) -> list:
    """One line per kernel that nvcc's ``-Xptxas -v`` log reports (its
    name; registers, shared memory, stack and spills), and every warning
    line."""
    out, entry, frame = [], "?", ""
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            entry = kernel_name(found.group(1))
        elif "warning" in line:
            out.append(line.strip())
        elif "spill" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{entry}: {line.split('Used', 1)[1].strip()}; {frame}")
    return out


# -- phase 14: the examples ---------------------------------------------------------

# the four examples run with their defaults, each in a process of its own,
# and the bounds the reference's own printout meets (its Rank-1 gap is 0
# from round 10; its worst heterogeneity gap 3.52e-09)
EXAMPLE_TIMEOUT_S = 300
RANK1_GAP_BOUND, HETEROGENEITY_GAP_BOUND = 1e-12, 1e-6
# the train example in process: qwen2-0.5B at its published width with
# its default batch 8 and seq 128, fednl, a refresh every 2 of 6 steps
EXAMPLE_TRAIN_ARGS = ("--full", "--optimizer", "fednl", "--steps", "6",
                      "--refresh-every", "2")
NUMBER = r"(-?[0-9.]+(?:e[+-][0-9]+)?)"


def run_example(name: str) -> tuple[str, float]:
    """``examples/torch_<name>.py`` with its defaults (the card) in a
    process of its own; its standard output and host seconds."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(root / "examples" /
                                              f"torch_{name}.py")],
                         capture_output=True, text=True,
                         timeout=EXAMPLE_TIMEOUT_S,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    seconds = time.perf_counter() - t0
    require(out.returncode == 0,
            f"examples/torch_{name}.py exited {out.returncode}: "
            f"{out.stdout[-800:]} {out.stderr[-2000:]}")
    return out.stdout, seconds


def example_processes(card: str) -> dict:
    """Phase 14's four examples in their own processes: the quickstart's
    last f(x) below its first, the Rank-1 gap after 20 rounds within
    ``RANK1_GAP_BOUND``, the worst heterogeneity gap within
    ``HETEROGENEITY_GAP_BOUND``, two requests served. Returns what each
    printed that the checks read, and its host seconds."""
    rep = {}
    out, secs = run_example("quickstart")
    values = [float(v) for v in re.findall(rf"round +\d+  f\(x\) = {NUMBER}",
                                           out)]
    require(len(values) == 6 and values[-1] < values[0]
            and "uplink per device per round: 1456 bytes" in out,
            f"the quickstart printed f(x) {values}: {out[-600:]}")
    rep["quickstart"] = {"s": secs, "f_first": values[0],
                         "f_last": values[-1]}

    out, secs = run_example("fednl_federated_logreg")
    rank1 = re.search(rf"round +20 +{NUMBER} +{NUMBER}", out)
    sharded = re.search(rf"over (\d+) rank\(s\): gap after 10 rounds = "
                        rf"{NUMBER}", out)
    gd = re.search(rf"GD +after {NUMBER} bits/node: gap {NUMBER}", out)
    diana = re.search(rf"DIANA after {NUMBER} bits/node: gap {NUMBER}", out)
    require(None not in (rank1, sharded, gd, diana)
            and abs(float(rank1[2])) <= RANK1_GAP_BOUND,
            f"the federated logreg example: {out[-1200:]}")
    rep["fednl_federated_logreg"] = {
        "s": secs, "rank1_bits_20": float(rank1[1]),
        "rank1_gap_20": float(rank1[2]), "sharded_world": int(sharded[1]),
        "sharded_gap_10": float(sharded[2]), "gd_gap": float(gd[2]),
        "diana_gap": float(diana[2])}

    out, secs = run_example("heterogeneity")
    rows = re.findall(rf"(\S+) +FedNL gap@15 rounds \(worst of 3 seeds\): +"
                      rf"{NUMBER} +GD gap@1500 rounds: +{NUMBER}", out)
    require(len(rows) == 3 and max(float(r[1]) for r in rows)
            <= HETEROGENEITY_GAP_BOUND,
            f"the heterogeneity example: {out[-800:]}")
    rep["heterogeneity"] = {"s": secs, **{
        tag: {"fednl_gap": float(f), "gd_gap": float(g)}
        for tag, f, g in rows}}

    out, secs = run_example("serve_batched")
    requests = re.findall(r"^request (\d+): \[[0-9, ]+\]$", out, re.M)
    require(requests == ["0", "1"],
            f"the serving example printed requests {requests}: {out[-600:]}")
    rep["serve_batched"] = {"s": secs, "requests": len(requests)}
    print(json.dumps({"examples": rep, "card": card}), flush=True)
    return rep


def example_train_lm(K, card: str) -> dict:
    """``examples/torch_train_lm.py --full --optimizer fednl`` in this
    process (``runpy``, ``sys.argv`` patched) between a reset and a read
    of the launch counters: finite losses, the loss line, K1 and K4
    launched once per parameter tensor on each refresh step (a refresh
    compresses every tensor in one K1 call over the silos and sums it in
    one K4 call, ``FedNLPrecondOptimizer.learn``) and never on the other
    steps, the refreshes the steps report equal to those of the
    ``curv_bits`` that ``train`` prints. Each step is timed on the host clock
    to a synchronize. Returns the launches, and the steps' losses and the
    digest of the final params (``params_digest``) for phase 15."""
    import contextlib
    import io
    import runpy

    import torch
    import repro_torch.launch.train as train_mod
    from repro_torch.tree import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps, make, final = [], train_mod.make_train_step, {}

    def timed_make(*args, **kw):
        step = make(*args, **kw)

        def timed(params, opt_state, batch):
            before = counts(K)
            ms, out = host_ms(lambda: step(params, opt_state, batch))
            final["params"] = out[0]
            after = counts(K)
            steps.append({
                "ms": ms, "loss": float(out[2]["loss"]),
                "refreshed": bool(out[2]["curv_refreshed"] == 1.0),
                "tensors": len(tree_leaves(params)),
                "k1": after["diff_topk_payload"] - before["diff_topk_payload"],
                "k4": (after["block_scatter_accumulate"]
                       - before["block_scatter_accumulate"])})
            return out

        return timed

    script = Path(__file__).resolve().parent / "examples" / "torch_train_lm.py"
    printed, argv = io.StringIO(), sys.argv
    t0 = time.perf_counter()
    K.reset_launches()
    try:
        train_mod.make_train_step = timed_make
        sys.argv = [str(script), *EXAMPLE_TRAIN_ARGS]
        with contextlib.redirect_stdout(printed):
            runpy.run_path(str(script), run_name="__main__")
    finally:
        train_mod.make_train_step, sys.argv = make, argv
        print(printed.getvalue(), end="", flush=True)
    launches = counts(K)
    seconds = time.perf_counter() - t0
    out = printed.getvalue()

    loss = re.search(rf"loss: {NUMBER} -> {NUMBER} over 6 steps \(fednl\)", out)
    per = re.search(r"curvature uplink: (\d+) bits/refresh", out)
    logged = re.findall(r"curv_bits (\d+)", out)
    refreshes = sum(s["refreshed"] for s in steps)
    require(len(steps) == 6 and loss is not None and per is not None
            and logged and all(math.isfinite(s["loss"]) for s in steps),
            f"the train example: {len(steps)} steps, {out[-800:]}")
    require([s["refreshed"] for s in steps] == [i % 2 == 0 for i in range(6)]
            and int(logged[-1]) == refreshes * int(per[1]),
            f"the train example's refreshes: {[s['refreshed'] for s in steps]}"
            f", curv_bits {logged} at {per[1]} bits a refresh")
    tensors = steps[0]["tensors"]
    for i, s in enumerate(steps):
        want = tensors if s["refreshed"] else 0
        require(s["k1"] == want and s["k4"] == want,
                f"the train example's step {i} (refresh {s['refreshed']}) "
                f"launched K1 {s['k1']} and K4 {s['k4']} times for {tensors} "
                f"tensors")
    require(launches["diff_topk_payload"] == refreshes * tensors
            and launches["block_scatter_accumulate"] == refreshes * tensors
            and launches["flash_attention"] == 0,
            f"the train example launched {launches}")
    refresh_ms = [s["ms"] for s in steps if s["refreshed"]]
    plain_ms = [s["ms"] for s in steps if not s["refreshed"]]
    rep = {"args": " ".join(EXAMPLE_TRAIN_ARGS), "s": seconds,
           "tensors": tensors, "refreshes": refreshes,
           "k1": launches["diff_topk_payload"],
           "k4": launches["block_scatter_accumulate"],
           "loss_first": float(loss[1]), "loss_last": float(loss[2]),
           "step_ms": [s["ms"] for s in steps],
           "refresh_step_ms_median": statistics.median(refresh_ms[1:]),
           "plain_step_ms_median": statistics.median(plain_ms),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": card}
    print(json.dumps({"examples_train_lm": rep}), flush=True)
    return launches, {"losses": [s["loss"] for s in steps],
                      "digest": params_digest(final.pop("params"))}


# -- phase 15: the train driver on a mesh ---------------------------------------------

# phase 14's example's run: qwen2-0.5B at its published width, 8 x 128
# tokens, fednl with a refresh every 2 of 6 steps, the example's lr
MESH_TRAIN_ARGS = dict(smoke=False, steps=6, batch=8, seq=128, lr=1e-3,
                       optimizer="fednl", refresh_every=2, curvature_k=2048)
# the ranks played in turn on the card for one refresh
PLAYED_RANKS = 4


def params_digest(params) -> str:
    """sha256 of every leaf's bytes in leaf order (a DTensor's local
    tensor, all of it on one rank)."""
    import hashlib

    import torch
    from repro_torch.tree import tree_leaves

    digest = hashlib.sha256()
    for x in tree_leaves(params):
        x = x.to_local() if hasattr(x, "to_local") else x
        digest.update(x.detach().contiguous().reshape(-1).view(torch.uint8)
                      .cpu().numpy().tobytes())
    return digest.hexdigest()


def plain_train_qwen2(dev) -> dict:
    """Phase 14's run through the step without a mesh on plain tensors,
    one silo, no hooks: its losses and the digest of its params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import build_model

    a = MESH_TRAIN_ARGS
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    opt = make_optimizer("fednl", a["lr"], k_per_block=a["curvature_k"],
                         curvature="fisher")
    state = opt.init(params)
    step = make_train_step(model, opt, refresh_every=a["refresh_every"])
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=a["seq"],
                         global_batch=a["batch"], seed=0)
    losses = []
    for i in range(a["steps"]):
        params, state, m = step(params, state, pipe.batch(i, device=dev))
        losses.append(float(m["loss"]))
    out = {"losses": losses, "digest": params_digest(params)}
    del params, state
    torch.cuda.empty_cache()
    return out


def played_refresh(model, params, h, batch) -> dict:
    """One refresh of ``h`` from ``PLAYED_RANKS`` silos of ``batch``'s rows
    at ``params``, per tensor twice: in one call (K1 over the stacked
    silos, K4), and with the ranks played in turn (rank 0's
    ``FedNLPrecondOptimizer.learn`` on its own silo, whose ``gather``
    makes the other ranks' K1 calls, each on its own silo, and stacks the
    payloads in silo order before K4). s and l bit for bit; the played
    calls' launches."""
    import torch
    from repro_torch.kernels.block_topk import diff_topk_payload
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.second_order.fednl_precond import (
        FedNLPrecondOptimizer,
        _shape2d,
    )
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    import repro_torch.kernels as K

    opt = FedNLPrecondOptimizer(lr=MESH_TRAIN_ARGS["lr"],
                                k_per_block=MESH_TRAIN_ARGS["curvature_k"])
    rows = batch["tokens"].shape[0] // PLAYED_RANKS
    obs = []
    for r in range(PLAYED_RANKS):
        mine = tree_map(lambda x: x[r * rows:(r + 1) * rows], batch)
        _, _, g = value_and_grad(model, params, mine)
        obs.append(tree_leaves(opt.observe(tree_unflatten(params, list(g)))))
        del g
    played = {"diff_topk_payload": 0, "block_scatter_accumulate": 0}
    for t, ht in enumerate(tree_leaves(h)):
        silos = [o[t].contiguous() for o in obs]
        s1, l1 = opt.learn(ht, torch.stack(silos))
        shape2 = _shape2d(ht.shape)

        def gather(vals, idx, tile_sq):
            parts = [(vals, idx, tile_sq)] + [
                diff_topk_payload(o.reshape((1,) + shape2),
                                  ht.reshape(shape2), opt._k(), opt.block,
                                  tile_sums=True) for o in silos[1:]]
            return tuple(torch.cat(x) for x in zip(*parts))

        before = counts(K)
        s4, l4 = opt.learn(ht, silos[0][None], gather=gather)
        torch.cuda.synchronize()
        after = counts(K)
        for name in played:
            played[name] += after[name] - before[name]
        require(torch.equal(s1, s4) and torch.equal(l1, l4),
                f"the played ranks' refresh of a {tuple(ht.shape)} tensor "
                f"differs from the one-call refresh (l {float(l1)} vs "
                f"{float(l4)})")
        del s1, s4, silos
    tensors = len(tree_leaves(h))
    require(played == {"diff_topk_payload": PLAYED_RANKS * tensors,
                       "block_scatter_accumulate": tensors},
            f"the played refresh launched {played} for {tensors} tensors")
    return {"tensors": tensors, **played}


def mesh_train_qwen2(K, card: str, example: dict, dev) -> dict:
    """Phase 15: ``launch.train.train`` itself with phase 14's example's
    arguments on the one-rank NCCL mesh that ``make_host_mesh`` makes:
    every param and state leaf a DTensor laid out by the rules (each
    replicated on one rank), the hooks installed while it trains and
    taken away after, the step on the mesh. Its losses and the digest of
    its final params equal phase 14's run bit for bit, and the step
    without a mesh on plain tensors gives them too; K1 and K4 once per
    tensor on each refresh step and never on the others (path
    ``mesh_train_qwen2``); ms a step and the peak memory. Then
    ``played_refresh`` of the final H at the final params on the batch of
    step 6, 4 ranks played in turn. Returns the driver run's launches."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    import repro_torch.launch.train as train_mod
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import scoped_group
    from repro_torch.models import build_model, common
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    plain = plain_train_qwen2(dev)
    plain_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps, make, final = [], train_mod.make_train_step, {}

    def timed_make(*args, **kw):
        step = make(*args, **kw)

        def timed(params, opt_state, batch):
            if not steps:
                leaves = tree_leaves(params) + tree_leaves(opt_state.h)
                require(kw.get("mesh") is not None
                        and dist.get_backend() == "nccl"
                        and all(isinstance(x, DTensor) for x in leaves)
                        and common._LAYER_PARAM_CONSTRAINT is not None
                        and common._ACT_CONSTRAINT is not None,
                        "the driver did not train on an NCCL mesh with "
                        "DTensors and the hooks installed")
            before = counts(K)
            ms, out = host_ms(lambda: step(params, opt_state, batch))
            after = counts(K)
            final["params"], final["state"] = out[0], out[1]
            steps.append({
                "ms": ms, "loss": float(out[2]["loss"]),
                "refreshed": bool(out[2]["curv_refreshed"] == 1.0),
                "k1": after["diff_topk_payload"] - before["diff_topk_payload"],
                "k4": (after["block_scatter_accumulate"]
                       - before["block_scatter_accumulate"])})
            return out

        return timed

    t0 = time.perf_counter()
    K.reset_launches()
    try:
        train_mod.make_train_step = timed_make
        with scoped_group():
            train_mod.train("qwen2-0.5b", device=dev, **MESH_TRAIN_ARGS)
            params = tree_map(lambda x: x.to_local(), final.pop("params"))
            h = tree_map(lambda x: x.to_local(), final.pop("state").h)
    finally:
        train_mod.make_train_step = make
    launches = counts(K)
    seconds = time.perf_counter() - t0
    require(common._LAYER_PARAM_CONSTRAINT is None
            and common._ACT_CONSTRAINT is None and not dist.is_initialized(),
            "the driver left its hooks or its process group behind")
    losses = [s["loss"] for s in steps]
    digest = params_digest(params)
    require(losses == example["losses"] and digest == example["digest"],
            f"the driver on a one-rank mesh differs from phase 14's run: "
            f"losses {losses} vs {example['losses']}, digest {digest} vs "
            f"{example['digest']}")
    require(losses == plain["losses"] and digest == plain["digest"],
            f"the driver on a one-rank mesh differs from the step without "
            f"a mesh: losses {losses} vs {plain['losses']}")
    tensors = len(tree_leaves(params))
    refreshes = sum(s["refreshed"] for s in steps)
    require([s["refreshed"] for s in steps] == [i % 2 == 0 for i in range(6)]
            and all(s["k1"] == s["k4"] == (tensors if s["refreshed"] else 0)
                    for s in steps)
            and launches["diff_topk_payload"] == refreshes * tensors
            and launches["block_scatter_accumulate"] == refreshes * tensors,
            f"the driver's K1/K4 launches by step "
            f"{[(s['k1'], s['k4']) for s in steps]}, in all {launches}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    t1 = time.perf_counter()
    cfg = get_config("qwen2-0.5b")
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=MESH_TRAIN_ARGS["seq"],
                         global_batch=MESH_TRAIN_ARGS["batch"], seed=0)
    played = played_refresh(build_model(cfg, use_remat=True), params, h,
                            pipe.batch(MESH_TRAIN_ARGS["steps"], device=dev))
    played_s = time.perf_counter() - t1
    del params, h
    torch.cuda.empty_cache()
    refresh_ms = [s["ms"] for s in steps if s["refreshed"]]
    plain_ms = [s["ms"] for s in steps if not s["refreshed"]]
    rep = {"s": seconds, "plain_step_s": plain_s, "tensors": tensors,
           "refreshes": refreshes, "k1": launches["diff_topk_payload"],
           "k4": launches["block_scatter_accumulate"], "losses": losses,
           "digest": digest, "equal_to_phase_14": True,
           "equal_to_step_without_mesh": True,
           "step_ms": [s["ms"] for s in steps],
           "refresh_step_ms_median": statistics.median(refresh_ms[1:]),
           "plain_step_ms_median": statistics.median(plain_ms),
           "peak_memory_gb": peak, "played_refresh": played,
           "played_refresh_bitwise": True, "played_s": played_s,
           "card": card}
    print(json.dumps({"mesh_train_qwen2": rep}), flush=True)
    return launches


# phase 16: starcoder2-15b at its published width, depth cut to 2 of 40
# layers, its "model" axis of 4 ranks played in turn on the card
MODEL_AXIS_ARCH, MODEL_AXIS_LAYERS, MODEL_AXIS_RANKS = "starcoder2-15b", 2, 4
MODEL_AXIS_T, MODEL_AXIS_K = 4096, 2048
# the played logits against the unsplit model's: f32 within 1e-4 of the
# largest; bf16 within DECODE_TOL (8 bf16 steps) of the largest, since
# each layer's row-parallel partials are rounded to bf16, summed over the
# ranks in f32 and rounded again, where one GEMM rounds once
MODEL_AXIS_F32_REL = 1e-4


def played_model_axis(world: int):
    """A ``ModelAxis`` of ``world`` ranks played by threads of this
    process on one card: each thread sets its ``rank`` (thread-local) and
    the collectives meet at a barrier, each rank's tensor copied into a
    slot and the reduction made in rank order by every thread alike.
    The ranks run in turns (``turn``, held by a rank from its start to
    its next collective, given up while it waits there): every torch
    call gives up the GIL, so ranks running at once would hand it to
    each other at every launch, and a rank's sLSTM loop of 22 launches a
    step ran several times slower than alone. The card serializes the
    ranks' launches on its one stream either way. Forward only: the
    played ranks make no backward (autograd runs a device's backward on
    one thread, where two ranks would wait on each other); phase 16g runs
    its backward on model ranks as processes (``model_axis_hvp``)."""
    import threading

    import torch
    from repro_torch.launch.sharding import ModelAxis

    class Played(ModelAxis):
        def __init__(self):
            self._local = threading.local()
            super().__init__(None)
            self.world = world
            self.barrier = threading.Barrier(world, timeout=600)
            self.turn = threading.Lock()
            self._slots = [None] * world

        @property
        def rank(self):
            return self._local.rank

        @rank.setter
        def rank(self, r):
            self._local.rank = r

        def _meet(self):
            """The barrier, this rank's turn given up while it waits."""
            self.turn.release()
            try:
                self.barrier.wait()
            finally:
                self.turn.acquire()

        def _exchange(self, x):
            self._slots[self.rank] = x.clone()
            self._meet()
            parts = list(self._slots)
            self._meet()
            return parts

        def _all_gather(self, x):
            return torch.cat(self._exchange(x))

        def _all_reduce(self, x, op="sum"):
            parts = self._exchange(x)
            acc = parts[0].clone()
            for p in parts[1:]:
                acc = torch.maximum(acc, p) if op == "max" else acc.add_(p)
            return x.copy_(acc)

        def _reduce_scatter(self, x):
            raise NotImplementedError("the played ranks run no backward")

    return Played()


def play_ranks(axis, fn) -> list:
    """``fn(rank)`` on a thread per rank of the played ``axis``, in
    turns between its collectives, with the axis installed as the models'
    model axis; the results in rank order. A rank that raises breaks the
    barrier, so the others stop too."""
    import threading

    from repro_torch.models.common import set_activation_sharder

    out, errors = [None] * axis.world, []

    def run(r):
        with axis.turn:
            try:
                axis.rank = r
                out[r] = fn(r)
            except BaseException as exc:   # re-raised below, after the join
                errors.append(exc)
                axis.barrier.abort()

    set_activation_sharder(None, None, axis)
    try:
        threads = [threading.Thread(target=run, args=(r,))
                   for r in range(axis.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        set_activation_sharder(None, None, None)
    if errors:
        raise errors[0]
    return out


# a played prefill's warm-up: each rank's prefill of its first this many
# tokens (the kernels and the allocator's blocks are warm by then)
PLAYED_WARMUP_T = 64


def played_prefill(prefill, shards, axis, batch, K, last=False,
                   watch=None) -> tuple:
    """Each played rank's prefill of ``batch`` on its shards, after a
    warm-up on its first ``PLAYED_WARMUP_T`` tokens, with the counts set
    to 0 just before and read just after: (host ms, each rank's f32
    logits, of the last position where ``last`` (a bool, or of the
    rank) says so, else of all, the counts, what ``watch`` (a context
    manager entered around the measured prefill alone) gave)."""
    import torch

    short = {**batch, "tokens": batch["tokens"][:, :PLAYED_WARMUP_T]}
    play_ranks(axis, lambda r: prefill(shards[r], short))   # warm-up

    def run(r):
        out = prefill(shards[r], batch)[0]
        keep = last(r) if callable(last) else last
        return (out[-1:] if keep else out).float()

    torch.cuda.synchronize()
    K.reset_launches()
    with (watch if watch is not None else contextlib.nullcontext()) as seen:
        ms, logits = host_ms(lambda: play_ranks(axis, run))
    return ms, logits, counts(K), seen


def joined_logits(logits: list, vocab: int, world: int, what: str):
    """The whole logits from each played rank's: their vocab blocks side
    by side where the axis splits the vocab, else (the rules replicate
    the table) rank 0's, whose trailing rows every rank's must equal."""
    import torch

    if vocab % world == 0:
        return torch.cat(logits, dim=-1)
    require(all(torch.equal(logits[0][-len(x):], x) for x in logits[1:]),
            f"{what}: the ranks' whole logits differ (the vocab is "
            f"replicated over 'model')")
    return logits[0]


def model_axis_k9(dev, seed: int, h: int = 12, kvh: int = 1, hd: int = 128,
                  w=4096, t: int = MODEL_AXIS_T) -> dict:
    """K9 on one played rank's heads at T = ``t`` (4,096 by default):
    ``h`` q heads over ``kvh`` KV heads of ``hd``, window ``w`` (None:
    causal); by default starcoder2-15b's (12 over 1, hd 128, window
    4,096). Every head
    against its plain version in bf16 and f32 (``check_flash``), then
    the bf16 call's ms, device ms, bound, plain and SDPA ms."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    err = {"flash_attention": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((1, t, n, hd), generator=g, device=dev)
                   .to(dtype) for n in (h, kvh, kvh))
        check_flash(q, k, v, range(h), err, f"n_rep {h // kvh} {dtype}",
                    window=w)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    pairs = window_pairs(t, w or t)
    flops = 4 * h * hd * pairs
    b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                       {"bf16": flops})
    dev_ms = device_ms(lambda: flash_attention(q, k, v, window=w),
                       "flash_attention_kernel_wgmma", reps=10)

    def plain_all_heads():
        for head in range(h):
            kv = head // (h // kvh)
            flash_attention_ref(q[0, :, head][None], k[0, :, kv][None],
                                v[0, :, kv][None], w)

    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
              for x in (k, v))
    out = dict(shape=f"q (1, {t}, {h}, {hd}), k and v (1, {t}, {kvh}, {hd}) "
                     f"bf16, n_rep {h // kvh}, window {w}",
               ms=time_cuda(lambda: flash_attention(q, k, v, window=w),
                            reps=10),
               device_ms=dev_ms, tflops=flops / dev_ms / 1e9, pairs=pairs,
               bound_ms=b_ms, bound_by=b_by,
               plain_ms=time_cuda(plain_all_heads, reps=1, warmup=1),
               library_ms=time_cuda(lambda: sdpa(qt, kt, vt, w), reps=5,
                                    warmup=1),
               library_call=("scaled_dot_product_attention(is_causal)"
                             if w is None else
                             "scaled_dot_product_attention with a boolean "
                             "window mask") + ", KV heads expanded beforehand",
               max_abs_err=err["flash_attention_bf16"]["max_abs_err"],
               bf16_check={key: val for key, val in
                           err["flash_attention_bf16"].items()
                           if key != "max_abs_err"},
               f32_max_abs_err=err["flash_attention"])
    del q, k, v, qt, kt, vt
    return out


def model_axis_refresh(cfg, dev, seed: int, K, ranks: int = None,
                       only=None) -> dict:
    """A refresh of the model's H from one silo's gradient (random, f32),
    per tensor split over "model" (``only``: those whose path ends with
    one of its strings): in one call (``learn`` of the gradient's observation g^2: K1, K4
    on the whole tensor), then through the port's own route on ``ranks``
    played ranks (``FedNLPrecondOptimizer._learn_grads``, the route of
    ``refresh_grads`` that the train step's observation takes: a stacked
    tensor a layer slice at a time where its layers lie on 128-row tile
    bounds; K1 and K4 on the rank's model shard where the split is on
    tile bounds, else on the tensor gathered over "model"; the ridge's
    per-tile terms gathered in the whole tensor's tile order), with the
    counts set to 0 just before and read just after. Each rank's H and l
    bit for bit against the one call's; the played launches, one K1 and
    one K4 a rank and tensor (a rank and layer slice where the layer
    route applies: not here, where no leaf is split over "data")."""
    import torch
    from repro_torch.configs import model_param_shapes
    from repro_torch.launch.sharding import (DataAxis, LeafLayout,
                                             model_parts, tree_param_specs)
    from repro_torch.second_order.fednl_precond import (
        FedNLPrecondOptimizer,
        _tile_grid,
    )
    from repro_torch.tree import tree_leaves, tree_map

    m = ranks or MODEL_AXIS_RANKS
    ext = {"data": 1, "model": m}
    opt = FedNLPrecondOptimizer(k_per_block=MODEL_AXIS_K)
    axis = played_model_axis(m)
    data = DataAxis(None, model=axis)
    g = torch.Generator(device=dev).manual_seed(seed)
    tree = tree_map(lambda s: torch.empty(s.shape, device="meta"),
                    model_param_shapes(cfg))
    names = []

    def walk(t, prefix):
        if isinstance(t, dict):
            for key, val in t.items():
                walk(val, f"{prefix}/{key}")
        elif isinstance(t, list):
            for i, val in enumerate(t):
                walk(val, f"{prefix}/{i}")
        else:
            names.append(prefix)

    walk(tree, "params")
    specs = tree_leaves(tree_param_specs(tree, ext))
    played = {"diff_topk_payload": 0, "block_scatter_accumulate": 0}
    want = dict(played)
    aligned = routes = layered = 0
    for name, shape, spec in zip(names, (x.shape for x in tree_leaves(tree)),
                                 specs):
        split = [d for d, e in enumerate(spec)
                 if "model" in (e if isinstance(e, tuple) else (e,))]
        if not split or (only and not name.endswith(only)):
            continue
        dim = split[0]
        routes += 1
        h = torch.rand(shape, generator=g, device=dev)
        grad = torch.randn(shape, generator=g, device=dev)
        obs = opt.observe(grad)[None]
        s1, l1 = opt.learn(h, obs)
        del obs
        h1 = torch.add(h, s1, alpha=opt.alpha)
        del s1
        # each rank's shards of H and of the gradient, as a rank holds
        # them (contiguous), and its layout: split on "model" only
        mine = play_ranks(axis, lambda r: tuple(
            x.contiguous() for x in model_parts([h, grad], [spec, spec],
                                                axis)))
        del h, grad
        lay = LeafLayout(None, data, dim)
        aligned += _tile_grid(mine[0][0].shape, dim, opt.block) is not None
        route = opt._by_layer(mine[0][0], lay)
        layered += route is not None
        n = shape[0] if route is not None else 1
        for key in want:
            want[key] += m * n
        torch.cuda.synchronize()
        K.reset_launches()
        out = play_ranks(axis, lambda r: opt._learn_grads(
            mine[r][0], [mine[r][1]], lay))
        torch.cuda.synchronize()
        got = counts(K)
        for key in played:
            played[key] += got[key]
        size = shape[dim] // m
        require(all(torch.equal(l1, l) and torch.equal(
            h1.narrow(dim, r * size, size), hr)
            for r, (hr, l) in enumerate(out)),
            f"the played model shards' refresh of {name} {tuple(shape)} "
            f"split on dim {dim} differs from the one-call refresh (l "
            f"{float(l1)} vs {[float(l) for _, l in out]})")
        del h1, mine, out
        torch.cuda.empty_cache()
    require(routes > 0 and aligned > 0 and played == want,
            f"the played model-shard refresh launched {played} for "
            f"{routes} tensors, not {want}")
    return {"ranks": m, "tensors_split": routes,
            "tensors_on_tile_bounds": aligned, "tensors_by_layer": layered,
            "route": "FedNLPrecondOptimizer._learn_grads", **played}


def model_axis_starcoder2_15b(K, card: str, dev, seed: int) -> tuple:
    """Phase 16: starcoder2-15b at its published width, 2 of 40 layers,
    the mesh's "model" axis of 4 ranks played by threads on the card
    (``played_model_axis``). In bf16 and in f32: the unsplit model's
    prefill of one 4,096-token prompt, then each played rank's prefill
    through the tensor-parallel layers on its shards (its 12 q heads
    over 1 KV head through K9 with the window, its d_ff / 4 columns, its
    12,288 vocab rows) with the counts set to 0 just before and read just
    after (path ``model_axis_starcoder2_15b``: K9 on 4 ranks x 2 layers
    a dtype), the ranks' logits against the unsplit model's (f32 within
    ``MODEL_AXIS_F32_REL`` of the largest, bf16 within ``DECODE_TOL``),
    the greedy token through ``argmax_over`` and (f32) the vocab-parallel
    loss through each rank's shard. Then K9 at n_rep 12 alone
    (``model_axis_k9``) and a refresh played on the model shards
    (``model_axis_refresh``). Returns (the path's launches, K9's
    fields)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import argmax_over
    from repro_torch.launch.sharding import model_parts, tree_param_specs
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import build_model
    from repro_torch.models.common import (cross_entropy,
                                           vocab_parallel_cross_entropy)
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    ext = {"data": 1, "model": MODEL_AXIS_RANKS}
    launches = {"flash_attention": 0, "flash_attention:wgmma": 0,
                "flash_attention:ffma": 0}
    rep = {"arch": MODEL_AXIS_ARCH, "layers": MODEL_AXIS_LAYERS,
           "ranks_played": MODEL_AXIS_RANKS, "t": MODEL_AXIS_T, "card": card}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config(MODEL_AXIS_ARCH),
                                  n_layers=MODEL_AXIS_LAYERS, dtype=dtype)
        model = build_model(cfg)
        g = torch.Generator(device=dev).manual_seed(seed)
        params = model.init_params(g)
        tokens = torch.randint(0, cfg.vocab, (1, MODEL_AXIS_T), generator=g,
                               device=dev)
        prefill = make_prefill(model)
        whole_ms, whole = host_ms(lambda: prefill(params, {"tokens": tokens}))
        axis = played_model_axis(MODEL_AXIS_RANKS)
        # each rank's shards by the rules (contiguous, as a rank holds them)
        specs = tree_param_specs(params, ext)
        shards = play_ranks(axis, lambda r: tree_map(
            lambda x: x.contiguous(), model_parts(params, specs, axis)))
        del params

        def rank_prefill(r):
            return prefill(shards[r], {"tokens": tokens})

        play_ranks(axis, rank_prefill)                  # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        played_ms, logits = host_ms(lambda: play_ranks(axis, rank_prefill))
        got = counts(K)
        n = MODEL_AXIS_RANKS * MODEL_AXIS_LAYERS
        route = "wgmma" if dtype == "bfloat16" else "ffma"
        require(got["flash_attention"] == n
                and got[f"flash_attention:{route}"] == n,
                f"{dtype}: the played ranks' prefill launched K9 "
                f"{got['flash_attention']} times ({route} "
                f"{got[f'flash_attention:{route}']}), not {n}")
        for key in launches:
            launches[key] += got[key]
        joined = torch.cat(logits, dim=-1).float()
        top = float(whole.float().abs().max())
        gap = float((joined - whole.float()).abs().max())
        tol = (MODEL_AXIS_F32_REL if dtype == "float32" else DECODE_TOL) * top
        require(bool(torch.isfinite(joined).all()) and gap <= tol,
                f"{dtype}: the played ranks' logits are {gap} from the unsplit "
                f"model's (bound {tol})")
        want = int(torch.argmax(whole[0, -1]))
        toks = play_ranks(axis, lambda r: int(argmax_over(
            logits[r][0, -1:], axis)[0]))
        agree = float((torch.argmax(joined[0], -1)
                       == torch.argmax(whole[0].float(), -1)).float().mean())
        entry = {"whole_prefill_ms": whole_ms, "played_prefill_ms": played_ms,
                 "k9_launches": got["flash_attention"], "route": route,
                 "logit_gap": gap, "logit_max": top, "bound": tol,
                 "greedy_token": toks[0], "argmax_agree_all_positions": agree}
        require(toks == [want] * MODEL_AXIS_RANKS,
                f"{dtype}: the vocab-parallel greedy token {toks} is not the "
                f"unsplit model's {want}")
        if dtype == "float32":
            targets = torch.roll(tokens, -1, dims=1)
            losses = play_ranks(axis, lambda r: float(
                vocab_parallel_cross_entropy(logits[r], targets, axis)))
            ref = float(cross_entropy(joined, targets))
            require(all(abs(x - ref) <= 1e-6 * abs(ref) for x in losses),
                    f"the vocab-parallel loss {losses} is not {ref}")
            entry["vocab_parallel_loss"] = losses[0]
        rep[dtype] = entry
        del shards, whole, logits, joined, model
        torch.cuda.empty_cache()
    k9 = model_axis_k9(dev, seed)
    rep["k9_n_rep12"] = k9
    torch.cuda.empty_cache()
    K.reset_launches()
    cfg = dataclasses.replace(get_config(MODEL_AXIS_ARCH),
                              n_layers=MODEL_AXIS_LAYERS, dtype="float32")
    refresh = model_axis_refresh(cfg, dev, seed, K)
    rep["played_refresh"] = refresh
    launches["diff_topk_payload"] = refresh["diff_topk_payload"]
    launches["block_scatter_accumulate"] = refresh["block_scatter_accumulate"]
    rep["s"] = time.perf_counter() - t0
    print(json.dumps({"model_axis_starcoder2_15b": rep}), flush=True)
    torch.cuda.empty_cache()
    return launches, k9


def top_k_margin(x, k: int):
    """The smallest gap between neighbours among the k + 1 largest of
    the last axis: the top-k pick changes at a gap at the k-th place, and
    the order of a token's picks (its slot priority for the experts'
    capacity) at a gap above it."""
    import torch

    s = torch.sort(x, dim=-1, descending=True).values[..., :k + 1]
    return torch.amin(s[..., :-1] - s[..., 1:], dim=-1)


@contextlib.contextmanager
def routes_by_rank(axis):
    """While the block runs, every MoE routing's gate ids (groups, G, k)
    and top-k margins (``top_k_margin`` of the router probabilities) by
    played rank of ``axis`` (None: a call outside the played threads),
    one forward's routings in layer order."""
    import threading

    import torch

    import repro_torch.models.mlp as mlp

    out, top = {}, mlp.top_k_lower_index

    def recording(x, k):
        vals, ids = top(x, k)
        rank = (None if threading.current_thread() is threading.main_thread()
                else axis.rank)
        out.setdefault(rank, []).append((ids, top_k_margin(x, k)))
        return vals, ids

    mlp.top_k_lower_index = recording
    try:
        yield out
    finally:
        mlp.top_k_lower_index = top


def route_flips(whole: list, played: list) -> dict:
    """Tokens whose top-k experts, or their order, differ between the
    unsplit model's routings and a played rank's (the same layers in
    order): how many,
    the first layer where any does, and the largest of the unsplit
    model's top-k margins at that layer's rerouted tokens (a flip starts
    at a near tie when that margin is small; later layers' inputs differ
    by the flips before them)."""
    flips, first, margin, by_layer = 0, None, 0.0, []
    for layer, ((w_ids, w_margin), (p_ids, _)) in enumerate(zip(whole,
                                                                played)):
        differ = (w_ids != p_ids).any(-1)
        flips += int(differ.sum())
        by_layer.append(int(differ.sum()))
        if first is None and bool(differ.any()):
            first, margin = layer, float(w_margin[differ].max())
    return {"tokens_rerouted": flips, "first_layer": first,
            "max_margin_first_layer": margin, "routings": len(whole),
            "by_layer": by_layer}


# in f32 a rerouted token must sit at a near tie of the unsplit model's
# router (two of its k + 1 largest probabilities this close,
# ``top_k_margin``): the ranks' row-parallel and partial-combine sums
# round apart by about 1e-7 of a layer's output. A flip changes the
# token's slots, so through the experts' capacity other tokens' too, and
# attention carries it on. In bf16 the router's input rounds apart by a
# bf16 step, and ties up to a few 1e-2 apart flip (reported, not held)
MOE_NEAR_TIE = 1e-5


@contextlib.contextmanager
def layers_recorded():
    """While the block runs on this (the main) thread, each decoder
    layer's input and output (``transformer._layer_forward``), in order."""
    import threading

    import repro_torch.models.transformer as tf

    out, fwd = [], tf._layer_forward

    def recording(p, x, *args, **kw):
        y = fwd(p, x, *args, **kw)
        if threading.current_thread() is threading.main_thread():
            out.append((x, y[0]))
        return y

    tf._layer_forward = recording
    try:
        yield out
    finally:
        tf._layer_forward = fwd


def teacher_forced_layers(model, shards, axis, recorded, routes, dtype):
    """Each decoder layer run on the played ranks' shards from the input
    the unsplit model gave it (``recorded``: (input, output) by layer),
    so a difference does not carry from layer to layer: every rank's
    output equal, and against the unsplit layer's at the positions no
    rank rerouted: f32 within ``MODEL_AXIS_F32_REL`` of the largest, the
    rerouted tokens at near ties (``MOE_NEAR_TIE``); bf16 on average
    within one bf16 step of the largest (a token whose gate weights round
    apart moves by more; the largest gap is reported). ``routes``: the
    unsplit model's routings in layer order, one an MoE layer (layer i
    is position i % period of segment i // period; a layer without an
    MoE routes nothing)."""
    import torch

    import repro_torch.models.transformer as tf

    cfg, worst, worst_mean, rerouted, margin = model.cfg, 0.0, 0.0, 0, 0.0
    rel = MODEL_AXIS_F32_REL if dtype == "float32" else DECODE_TOL
    routings = iter(routes)
    for i, (x, want) in enumerate(recorded):
        seg, pos = divmod(i, model.period)
        kind = model.kinds[pos]
        with routes_by_rank(axis) as played:
            outs = play_ranks(axis, lambda r: tf._layer_forward(
                tf._layer(shards[r]["layers"][pos], seg), x, cfg,
                *kind)[0])
        require(all(torch.equal(outs[0], o) for o in outs[1:]),
                f"{cfg.name} layer {i}: the played ranks' outputs differ")
        differ = torch.zeros(x.shape[1], dtype=torch.bool, device=x.device)
        w_margin = torch.zeros(x.shape[1], device=x.device)
        if kind[1] == "moe":
            (w_ids, w_margin) = next(routings)
            (p_ids, _), = played[0]
            # one prompt: the groups' tokens in order, the last group's
            # pads after them
            differ = (w_ids != p_ids).any(-1).reshape(-1)[:x.shape[1]]
            w_margin = w_margin.reshape(-1)[:x.shape[1]]
        keep = ~differ
        top = float(want.float().abs().max())
        err = (outs[0].float() - want.float())[0, keep].abs()
        gap, mean = float(err.max()), float(err.mean())
        worst = max(worst, gap / top)
        worst_mean = max(worst_mean, mean / top)
        rerouted += int(differ.sum())
        if bool(differ.any()):
            margin = max(margin, float(w_margin[differ].max()))
        if dtype == "float32":
            require(gap <= rel * top,
                    f"{cfg.name} layer {i}, f32, teacher-forced: the played "
                    f"ranks' output is {gap} from the unsplit layer's at the "
                    f"tokens routed alike (bound {rel * top})")
        else:
            require(mean <= 2.0 ** -8 * top,
                    f"{cfg.name} layer {i}, bf16, teacher-forced: the played "
                    f"ranks' output is {mean} from the unsplit layer's on "
                    f"average at the tokens routed alike (bound one bf16 "
                    f"step of the largest, {2.0 ** -8 * top})")
    require(dtype != "float32" or margin <= MOE_NEAR_TIE,
            f"{cfg.name}, f32, teacher-forced: a token rerouted at a margin "
            f"of {margin} (near-tie bound {MOE_NEAR_TIE})")
    return {"layers": len(recorded), "max_gap_over_max": worst,
            "mean_gap_over_max": worst_mean, "tokens_rerouted": rerouted,
            "max_margin_there": margin}


# phase 16b: the MoE family's "model" axis, ranks played on the card:
# (arch, layers (None: all), played ranks); the refresh's leaves (None:
# every split one) and depth
MOE_AXIS_CASES = (("granite-moe-1b-a400m", None, 4), ("grok-1-314b", 2, 4),
                  ("grok-1-314b", 2, 16))
MOE_AXIS_REFRESH = {"granite-moe-1b-a400m": (None, 2),
                    "grok-1-314b": (("ffn/wi", "ffn/wo"), 1)}


def rank_shards(params, specs, world: int) -> list:
    """Each of ``world`` ranks' shards of the whole ``params`` by its
    ``specs`` over "model" (contiguous, as a rank holds them), made leaf
    by leaf with each whole leaf dropped once its shards are made, so
    the peak is the tree and one leaf, not two trees. ``params`` is
    emptied."""
    from repro_torch.launch.sharding import _split_dims
    from repro_torch.tree import tree_leaves, tree_unflatten

    leaves, spec_leaves = tree_leaves(params), tree_leaves(specs)
    skeleton = tree_unflatten(params, [None] * len(leaves))
    params.clear()
    parts = [[] for _ in range(world)]
    for i, spec in enumerate(spec_leaves):
        x, leaves[i] = leaves[i], None
        dim = _split_dims(spec).get("model")
        for r in range(world):
            if dim is None:
                parts[r].append(x)
            else:
                size = x.shape[dim] // world
                parts[r].append(x.narrow(dim, r * size, size).contiguous())
        del x
    return [tree_unflatten(skeleton, p) for p in parts]


def model_axis_moe(K, card: str, dev, seed: int) -> tuple:
    """Phase 16b: the MoE family at its published width over a "model"
    axis of ranks played by threads on the card (``played_model_axis``):
    granite-moe-1b-a400m at full depth over 4 ranks (expert parallel, 8 of
    32 experts a rank; 4 q heads over 2 KV heads; its 49,155-row vocab
    replicated, so every rank computes the whole logits), grok-1-314b cut
    to 2 of 64 layers over 4 ranks (expert parallel, 2 of 8 experts; 12 q
    heads over 2 KV heads) and over 16, the reference's extent (tensor
    parallel inside each expert, 2,048 of 32,768 d_ff columns; 3 q heads
    over 1 KV head). For each, in bf16 and in f32: the unsplit model's
    prefill of one 4,096-token prompt (each layer's input and output
    recorded), then each played rank's prefill on its shards
    (``rank_shards``) with the counts set to 0 just before and read just
    after (path ``model_axis_moe``: K9 on every rank's heads, a launch a
    rank and layer), and every token's routing against the unsplit
    model's (``route_flips``). In bf16, and in f32 where no token is
    rerouted, the last position's logits against the unsplit model's
    (f32 within ``MODEL_AXIS_F32_REL`` of the largest, bf16 within
    ``DECODE_TOL``; where the vocab is replicated, every rank's logits
    equal) and the greedy token over the ranks (``argmax_over`` where the
    vocab splits) equal. A flip at a router near tie changes that token's
    layer output, and attention carries it on, so where f32 tokens are
    rerouted the first layer's flips must be near ties (``MOE_NEAR_TIE``)
    and the gap and the token are reported; and every layer is held on
    the unsplit model's own input (``teacher_forced_layers``), so no flip
    carries.
    Then K9 at each rank's head count alone (``model_axis_k9``, causal)
    and the refresh played on the model shards (``model_axis_refresh``:
    granite every split tensor at 2 layers, grok-1 its experts' ``wi``
    and ``wo`` at one layer, at each extent). Returns (the path's
    launches, K9's fields by shape)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import argmax_over
    from repro_torch.launch.sharding import tree_param_specs
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    launches = {"flash_attention": 0, "flash_attention:wgmma": 0,
                "flash_attention:ffma": 0, "diff_topk_payload": 0,
                "block_scatter_accumulate": 0}
    rep = {"t": MODEL_AXIS_T, "card": card, "cases": []}
    k9 = {}
    for arch, layers, world in MOE_AXIS_CASES:
        entry = {"arch": arch, "ranks_played": world}
        ext = {"data": 1, "model": world}
        cfg = get_config(arch)
        heads = (cfg.n_heads // world, max(1, cfg.kv_heads // world), cfg.hd)
        key = f"{arch} over {world}: {heads[0]} q over {heads[1]} kv"
        if key not in k9:
            k9[key] = model_axis_k9(dev, seed, *heads, w=None)
            torch.cuda.empty_cache()
        for dtype in ("bfloat16", "float32"):
            cfg = get_config(arch)
            cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                                      dtype=dtype)
            entry["layers"] = cfg.n_layers
            model = build_model(cfg)
            g = torch.Generator(device=dev).manual_seed(seed)
            params = model.init_params(g)
            tokens = torch.randint(0, cfg.vocab, (1, MODEL_AXIS_T),
                                   generator=g, device=dev)
            prefill = make_prefill(model)
            axis = played_model_axis(world)
            with routes_by_rank(axis) as routes, layers_recorded() as rec:
                whole_ms, whole = host_ms(
                    lambda: prefill(params, {"tokens": tokens}))
            whole = whole[0, -1:].float()     # the last position's logits
            shards = rank_shards(params, tree_param_specs(params, ext), world)
            del params
            torch.cuda.empty_cache()

            played_ms, logits, got, played_routes = played_prefill(
                prefill, shards, axis, {"tokens": tokens}, K, last=True,
                watch=routes_by_rank(axis))
            flips = route_flips(routes[None], played_routes[0])
            n = world * cfg.n_layers
            route = "wgmma" if dtype == "bfloat16" else "ffma"
            require(got["flash_attention"] == n
                    and got[f"flash_attention:{route}"] == n,
                    f"{arch} over {world} played ranks, {dtype}: K9 launched "
                    f"{got['flash_attention']} times ({route} "
                    f"{got[f'flash_attention:{route}']}), not {n}")
            for key in ("flash_attention", f"flash_attention:{route}"):
                launches[key] += got[key]
            split_vocab = cfg.vocab % world == 0
            joined = joined_logits(logits, cfg.vocab, world,
                                   f"{arch}, {dtype}")
            top = float(whole.abs().max())
            gap = float((joined - whole).abs().max())
            tol = (MODEL_AXIS_F32_REL if dtype == "float32"
                   else DECODE_TOL) * top
            want = int(torch.argmax(whole[0]))
            toks = play_ranks(axis, lambda r: int(argmax_over(
                logits[r], axis if split_vocab else None)[0]))
            require(bool(torch.isfinite(joined).all())
                    and all(t == toks[0] for t in toks),
                    f"{arch}, {dtype}: non-finite logits or ranks that "
                    f"disagree on the greedy token {toks}")
            forced = teacher_forced_layers(model, shards, axis, rec,
                                           routes[None], dtype)
            if dtype == "bfloat16" or flips["tokens_rerouted"] == 0:
                require(gap <= tol and toks[0] == want,
                        f"{arch} over {world} played ranks, {dtype}: the "
                        f"last position's logits are {gap} from the "
                        f"unsplit model's (bound {tol}), greedy {toks[0]} "
                        f"vs {want}; routing {flips}; teacher-forced "
                        f"{forced}")
            else:
                require(flips["max_margin_first_layer"] <= MOE_NEAR_TIE,
                        f"{arch} over {world} played ranks, f32: tokens "
                        f"rerouted away from a near tie: {flips}; "
                        f"teacher-forced {forced}")
            entry[dtype] = {"whole_prefill_ms": whole_ms,
                            "played_prefill_ms": played_ms,
                            "k9_launches": got["flash_attention"],
                            "route": route, "logit_gap": gap,
                            "logit_max": top, "bound": tol,
                            "within_bound": gap <= tol,
                            "vocab_split": split_vocab,
                            "greedy_token": toks[0],
                            "greedy_equal": toks[0] == want,
                            "routing": flips, "teacher_forced": forced}
            del shards, whole, logits, joined, model, routes, played_routes
            del rec
            torch.cuda.empty_cache()
        only, depth = MOE_AXIS_REFRESH[arch]
        cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                                  dtype="float32")
        K.reset_launches()
        refresh = model_axis_refresh(cfg, dev, seed, K, ranks=world,
                                     only=only)
        for key in ("diff_topk_payload", "block_scatter_accumulate"):
            launches[key] += refresh[key]
        entry["played_refresh"] = refresh
        rep["cases"].append(entry)
        torch.cuda.empty_cache()
    rep["s"] = time.perf_counter() - t0
    print(json.dumps({"model_axis_moe": rep}), flush=True)
    return launches, k9


# phase 16c: MLA's "model" axis (minicpm3-4b), ranks played on the card:
# (layers (None: all 62), played ranks, decode == forward over the latent
# cache split on its sequence at MLA_AXIS_DECODE_T tokens, in f32: on the
# cut depth, since a played decode step costs a few barriers a layer); the
# refresh played on every split tensor of MLA_AXIS_REFRESH_LAYERS layers
MLA_AXIS_ARCH = "minicpm3-4b"
MLA_AXIS_CASES = ((None, 4, False), (4, 4, True), (4, 16, True))
MLA_AXIS_DECODE_T, MLA_AXIS_REFRESH_LAYERS = 32, 2


def greedy_held(whole_last, toks: list, gap: float) -> bool:
    """Whether the played ranks' greedy tokens ``toks`` are one token, and
    the unsplit model's argmax of its last logits ``whole_last`` (V,) or
    a token whose logit is within 2 ``gap`` of its max: the logits are
    held within ``gap``, so two within 2 ``gap`` may change places."""
    if any(t != toks[0] for t in toks):
        return False
    return float(whole_last.max() - whole_last[toks[0]]) <= 2 * gap


def played_decode(model, shards, axis, tokens, ext, caches=None) -> list:
    """Greedy-free decode of ``tokens`` (1, T) on every played rank of
    ``axis`` from its shards, over its part of the cache as
    ``cache_specs`` lays it out (the latent cache's sequence split where
    T divides by the ranks, marked ``latent_seq`` as ``generate`` marks
    it): each rank's logits at every position, (T, V or V / M). Each
    rank's cache after the last token goes into ``caches`` by rank where
    given."""
    import torch
    from repro_torch.launch.sharding import cache_specs, model_parts
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.tree import tree_map

    t = tokens.shape[1]
    serve = make_serve_step(model)
    cache = model.init_cache(1, t, tokens.device)
    specs = cache_specs(cache, ext)

    def run(r):
        mine = tree_map(torch.clone, model_parts(cache, specs, axis))
        mine["latent_seq"] = t % axis.world == 0
        out = []
        for pos in range(t):
            logits, mine = serve(shards[r], mine, tokens[:, pos:pos + 1],
                                 pos)
            out.append(logits[0].float())
        if caches is not None:
            caches[r] = mine
        return torch.cat(out)

    return play_ranks(axis, run)


def model_axis_mla(K, card: str, dev, seed: int) -> dict:
    """Phase 16c: minicpm3-4b (MLA) at its published width over a "model"
    axis of ranks played by threads on the card (``played_model_axis``):
    all 62 layers over 4 ranks (10 of 40 heads a rank, ``wuk`` and
    ``wuv`` gathered from their 64 latent rows a rank, the vocab of
    73,448 split), then 4 layers over 4 and over 16 (the 40 heads do not
    split there: every rank computes every head from ``wuq`` gathered
    whole and takes its 160 columns into its rows of ``wo``; the vocab
    is replicated). For each, in bf16 and in f32: the unsplit model's
    prefill of one 4,096-token prompt, then each played rank's on its
    shards (``rank_shards``) with the counts set to 0 just before and
    read just after (MLA's q.k is 96 wide and v 64, so no K9: none may
    launch), the logits against the unsplit model's (f32 within
    ``MODEL_AXIS_F32_REL`` of the largest, bf16 within ``DECODE_TOL``;
    where the vocab is replicated every rank's equal) and the greedy
    token over the ranks (``greedy_held``). In f32 at 4 layers, decode
    == forward over the latent cache split on its sequence
    (``played_decode``, ``MLA_AXIS_DECODE_T`` tokens: each rank writes a
    token only where its slice holds it, gathers q (over 4 ranks) and
    combines the ranks' split softmax). Then the refresh played on every
    split tensor at ``MLA_AXIS_REFRESH_LAYERS`` layers over 4 ranks
    (``model_axis_refresh``). Returns the path's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import argmax_over
    from repro_torch.launch.sharding import tree_param_specs
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    launches = {"diff_topk_payload": 0, "block_scatter_accumulate": 0}
    rep = {"arch": MLA_AXIS_ARCH, "t": MODEL_AXIS_T, "card": card,
           "cases": []}
    for layers, world, decode in MLA_AXIS_CASES:
        ext = {"data": 1, "model": world}
        entry = {"ranks_played": world}
        for dtype in ("bfloat16", "float32"):
            cfg = get_config(MLA_AXIS_ARCH)
            cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                                      dtype=dtype)
            entry["layers"] = cfg.n_layers
            model = build_model(cfg)
            g = torch.Generator(device=dev).manual_seed(seed)
            params = model.init_params(g)
            tokens = torch.randint(0, cfg.vocab, (1, MODEL_AXIS_T),
                                   generator=g, device=dev)
            prefill = make_prefill(model)
            whole_ms, whole = host_ms(
                lambda: prefill(params, {"tokens": tokens}))
            whole = whole[0].float()
            dec_tokens = tokens[:, :MLA_AXIS_DECODE_T]
            dec_want = (prefill(params, {"tokens": dec_tokens})[0].float()
                        if decode and dtype == "float32" else None)
            shards = rank_shards(params, tree_param_specs(params, ext), world)
            del params
            torch.cuda.empty_cache()
            axis = played_model_axis(world)
            split_vocab = cfg.vocab % world == 0
            # where the vocab is replicated, rank 0's logits of every
            # position, the others' of the last
            played_ms, logits, got, _ = played_prefill(
                prefill, shards, axis, {"tokens": tokens}, K,
                last=lambda r: not split_vocab and r > 0)
            require(got["flash_attention"] == 0,
                    f"{MLA_AXIS_ARCH} over {world} played ranks, {dtype}: "
                    f"the MLA prefill launched K9 {got['flash_attention']} "
                    f"times")
            joined = joined_logits(logits, cfg.vocab, world,
                                   f"{MLA_AXIS_ARCH}, {dtype}")
            top = float(whole.abs().max())
            gap = float((joined - whole).abs().max())
            tol = (MODEL_AXIS_F32_REL if dtype == "float32"
                   else DECODE_TOL) * top
            want = int(torch.argmax(whole[-1]))
            toks = play_ranks(axis, lambda r: int(argmax_over(
                logits[r][-1:], axis if split_vocab else None)[0]))
            agree = float((torch.argmax(joined, -1)
                           == torch.argmax(whole, -1)).float().mean())
            require(bool(torch.isfinite(joined).all()) and gap <= tol
                    and greedy_held(whole[-1], toks, gap),
                    f"{MLA_AXIS_ARCH} over {world} played ranks, {dtype}: "
                    f"the logits are {gap} from the unsplit model's (bound "
                    f"{tol}), greedy {toks} vs {want}")
            entry[dtype] = {"whole_prefill_ms": whole_ms,
                            "played_prefill_ms": played_ms,
                            "k9_launches": got["flash_attention"],
                            "logit_gap": gap, "logit_max": top,
                            "bound": tol, "vocab_split": split_vocab,
                            "greedy_token": toks[0],
                            "greedy_equal": toks[0] == want,
                            "argmax_agree_all_positions": agree}
            del logits, joined, whole
            if dec_want is not None:
                dec_ms, dec = host_ms(lambda: played_decode(
                    model, shards, axis, dec_tokens, ext))
                dec_joined = joined_logits(dec, cfg.vocab, world,
                                           f"{MLA_AXIS_ARCH} decode")
                dtop = float(dec_want.abs().max())
                dgap = float((dec_joined - dec_want).abs().max())
                require(dgap <= MODEL_AXIS_F32_REL * dtop,
                        f"{MLA_AXIS_ARCH} over {world} played ranks: decode "
                        f"over the split latent cache is {dgap} from the "
                        f"forward (bound {MODEL_AXIS_F32_REL * dtop})")
                entry["decode_vs_forward_f32"] = {
                    "t": MLA_AXIS_DECODE_T, "ms": dec_ms, "gap": dgap,
                    "logit_max": dtop,
                    "latent_seq": MLA_AXIS_DECODE_T % world == 0}
                del dec, dec_joined, dec_want
            del shards, model
            torch.cuda.empty_cache()
        rep["cases"].append(entry)
    cfg = dataclasses.replace(get_config(MLA_AXIS_ARCH),
                              n_layers=MLA_AXIS_REFRESH_LAYERS,
                              dtype="float32")
    K.reset_launches()
    refresh = model_axis_refresh(cfg, dev, seed, K, ranks=4)
    for key in launches:
        launches[key] += refresh[key]
    rep["played_refresh"] = refresh
    rep["s"] = time.perf_counter() - t0
    print(json.dumps({"model_axis_mla": rep}), flush=True)
    torch.cuda.empty_cache()
    return launches


# phase 16d: the hybrid family's "model" axis (jamba-1.5-large-398b) over 4
# ranks played on the card: its first 2 layers (Mamba + MLP, Mamba + MoE)
# in bf16, the first alone in f32; its attention layer's mixer (64 q heads
# over 8 KV heads, 16 over 2 a rank); the refresh of the Mamba leaves
HYBRID_AXIS_ARCH, HYBRID_AXIS_RANKS = "jamba-1.5-large-398b", 4
HYBRID_AXIS_LAYERS = {"bfloat16": 2, "float32": 1}
HYBRID_AXIS_REFRESH = ("mixer/win", "mixer/conv", "mixer/wbc",
                       "mixer/a_log", "mixer/wout")


def hybrid_attention_axis(cfg, dev, seed: int, K, world: int) -> dict:
    """Jamba's attention mixer (its period's last layer; no positions) at
    full width on one (1, T) input over ``world`` played ranks: the
    unsplit ``gqa_forward`` (K9 on all 64 heads), then each rank's on its
    shards (K9 on its 16 q heads over 2 KV heads, a launch a rank) with
    the counts set to 0 just before and read just after; every rank's
    output equal, and against the unsplit one's (f32 within
    ``MODEL_AXIS_F32_REL`` of the largest, bf16 within ``DECODE_TOL``).
    Returns the played launches and the figures."""
    import torch
    from repro_torch.launch.sharding import tree_param_specs
    from repro_torch.models import attention as attn

    g = torch.Generator(device=dev).manual_seed(seed + 7)
    tree = {"mixer": attn.gqa_init(g, cfg)}
    x = torch.randn((1, MODEL_AXIS_T, cfg.d_model), generator=g,
                    device=dev).to(cfg.tdtype)
    with torch.no_grad():
        want = attn.gqa_forward(tree["mixer"], x, cfg)[0].float()
        shards = rank_shards(tree, tree_param_specs(
            tree, {"data": 1, "model": world}), world)
        axis = played_model_axis(world)

        def run(r):
            return attn.gqa_forward(shards[r]["mixer"], x, cfg)[0]

        torch.cuda.synchronize()
        K.reset_launches()
        ms, outs = host_ms(lambda: play_ranks(axis, run))
        got = counts(K)
    route = "wgmma" if cfg.dtype == "bfloat16" else "ffma"
    require(got["flash_attention"] == world
            and got[f"flash_attention:{route}"] == world,
            f"{cfg.name} attention over {world} played ranks, {cfg.dtype}: K9 "
            f"launched {got['flash_attention']} times, not {world}")
    require(all(torch.equal(outs[0], o) for o in outs[1:]),
            f"{cfg.name} attention, {cfg.dtype}: the played ranks differ")
    top = float(want.abs().max())
    gap = float((outs[0].float() - want).abs().max())
    tol = (MODEL_AXIS_F32_REL if cfg.dtype == "float32" else DECODE_TOL) * top
    require(gap <= tol, f"{cfg.name} attention over {world} played ranks, "
                        f"{cfg.dtype}: {gap} from the unsplit mixer's (bound "
                        f"{tol})")
    return {"launches": {"flash_attention": got["flash_attention"],
                         f"flash_attention:{route}": got[
                             f"flash_attention:{route}"]},
            "played_ms": ms, "gap": gap, "out_max": top, "bound": tol}


def model_axis_hybrid(K, card: str, dev, seed: int) -> tuple:
    """Phase 16d: jamba-1.5-large-398b at its published width over a
    "model" axis of 4 ranks played by threads on the card: its first two
    layers (a stack cut below one period: Mamba + MLP, Mamba + MoE with
    16 experts, 4 a rank; about 24 GB in bf16) and, in f32, the first
    alone. Each rank's Mamba mixer runs the conv and the scan on its
    4,096 of 16,384 channels: ``win``'s shard gathered on its last dim
    and narrowed to the rank's channels of u and z, ``wbc`` and
    ``a_log`` gathered from their column shards, the B, C and Delta
    projections summed over the ranks, ``wout`` row-parallel. For each
    dtype: the unsplit model's prefill of one 4,096-token prompt (each
    layer's input and output recorded), each played rank's on its shards
    (``rank_shards``) with the counts set to 0 just before and read just
    after, the routing against the unsplit model's (``route_flips``),
    the logits (bf16: the last position's within ``DECODE_TOL`` of the
    largest; f32: every position's within ``MODEL_AXIS_F32_REL``; the
    greedy token by ``greedy_held``) and every layer teacher-forced on the unsplit
    model's own input (``teacher_forced_layers``). Then the attention
    layer's mixer over the played ranks through K9
    (``hybrid_attention_axis``), K9 at a rank's head count alone
    (``model_axis_k9``: 16 q heads over 2 KV heads, causal) and the
    refresh of the Mamba leaves played on their shards
    (``model_axis_refresh``). Returns (the path's launches, K9's
    fields)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import argmax_over
    from repro_torch.launch.sharding import tree_param_specs
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    world = HYBRID_AXIS_RANKS
    ext = {"data": 1, "model": world}
    launches = {"flash_attention": 0, "flash_attention:wgmma": 0,
                "flash_attention:ffma": 0, "diff_topk_payload": 0,
                "block_scatter_accumulate": 0}
    rep = {"arch": HYBRID_AXIS_ARCH, "t": MODEL_AXIS_T, "card": card,
           "ranks_played": world}
    full = get_config(HYBRID_AXIS_ARCH)
    heads = (full.n_heads // world, full.kv_heads // world, full.hd)
    k9 = model_axis_k9(dev, seed, *heads, w=None)
    torch.cuda.empty_cache()
    for dtype, layers in HYBRID_AXIS_LAYERS.items():
        cfg = dataclasses.replace(full, n_layers=layers, dtype=dtype)
        model = build_model(cfg)
        g = torch.Generator(device=dev).manual_seed(seed)
        params = model.init_params(g)
        tokens = torch.randint(0, cfg.vocab, (1, MODEL_AXIS_T), generator=g,
                               device=dev)
        prefill = make_prefill(model)
        axis = played_model_axis(world)
        with routes_by_rank(axis) as routes, layers_recorded() as rec:
            whole_ms, whole = host_ms(
                lambda: prefill(params, {"tokens": tokens}))
        whole = whole[0].float() if dtype == "float32" else \
            whole[0, -1:].float()
        shards = rank_shards(params, tree_param_specs(params, ext), world)
        del params
        torch.cuda.empty_cache()
        last = dtype != "float32"
        played_ms, logits, got, played_routes = played_prefill(
            prefill, shards, axis, {"tokens": tokens}, K, last=last,
            watch=routes_by_rank(axis))
        require(got["flash_attention"] == 0,
                f"{HYBRID_AXIS_ARCH}: a stack without attention launched K9")
        flips = route_flips(routes.get(None, []), played_routes.get(0, []))
        joined = joined_logits(logits, cfg.vocab, world, HYBRID_AXIS_ARCH)
        top = float(whole.abs().max())
        gap = float((joined - whole).abs().max())
        tol = (MODEL_AXIS_F32_REL if dtype == "float32"
               else DECODE_TOL) * top
        want = int(torch.argmax(whole[-1]))
        toks = play_ranks(axis, lambda r: int(argmax_over(
            logits[r][-1:], axis)[0]))
        forced = teacher_forced_layers(model, shards, axis, rec,
                                       routes.get(None, []), dtype)
        require(bool(torch.isfinite(joined).all()) and gap <= tol
                and greedy_held(whole[-1], toks, gap),
                f"{HYBRID_AXIS_ARCH} over {world} played ranks, {dtype}: the "
                f"logits are {gap} from the unsplit model's (bound {tol}), "
                f"greedy {toks} vs {want}; routing {flips}; teacher-forced "
                f"{forced}")
        rep[dtype] = {"layers": layers,
                      "kinds": [list(k) for k in model.kinds],
                      "whole_prefill_ms": whole_ms,
                      "played_prefill_ms": played_ms, "logit_gap": gap,
                      "logit_max": top, "bound": tol,
                      "positions": "last" if last else "all",
                      "greedy_token": toks[0],
                      "greedy_equal": toks[0] == want, "routing": flips,
                      "teacher_forced": forced}
        del shards, whole, logits, joined, model, routes, played_routes, rec
        torch.cuda.empty_cache()
        attn = hybrid_attention_axis(cfg, dev, seed, K, world)
        for key, n in attn.pop("launches").items():
            launches[key] += n
        rep[dtype]["attention_mixer"] = attn
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(full, n_layers=1, dtype="float32")
    K.reset_launches()
    refresh = model_axis_refresh(cfg, dev, seed, K, ranks=world,
                                 only=HYBRID_AXIS_REFRESH)
    for key in ("diff_topk_payload", "block_scatter_accumulate"):
        launches[key] += refresh[key]
    rep["played_refresh"] = refresh
    rep["k9_rank_heads"] = k9
    rep["s"] = time.perf_counter() - t0
    print(json.dumps({"model_axis_hybrid": rep}), flush=True)
    torch.cuda.empty_cache()
    return launches, k9


# phase 16e: xLSTM's "model" axis (xlstm-350m), ranks played on the card:
# (layers (None: all 24), played ranks, dtype, T, decode steps (0: none,
# each layer teacher-forced instead)): the whole model in f32 over 4
# ranks (a head a rank); one period (8 layers) in bf16 over 4; one period
# in f32 over 4 and over 16 (4 heads: every rank computes every head)
# with decode == forward over the laid-out caches. T of the one-period
# f32 cases is 512, two mLSTM chunks: a played decode step costs a few
# barriers a layer, and a played sLSTM step runs on every rank
SSM_AXIS_ARCH = "xlstm-350m"
SSM_AXIS_CASES = ((None, 4, "float32", 4096, 0),
                  (8, 4, "bfloat16", 4096, 0),
                  (8, 4, "float32", 512, 16),
                  (8, 16, "float32", 512, 4))
# xLSTM's f32 logits answer a rounding-sized change of its weights by far
# more than 1e-4 of the largest at depth (the mLSTM's normalizer): the
# played ranks' f32 logits are held within the larger of
# MODEL_AXIS_F32_REL and ``tree.SPREAD_FACTOR`` times the unsplit model's
# own spread under such a change, the largest over SPREAD_DRAWS draws
# (``rounding_floor``), and each layer teacher-forced within
# MODEL_AXIS_F32_REL
SPREAD_DRAWS = 3


def rounding_floor(prefill, params, batch, whole, seed: int) -> float:
    """The unsplit model's own spread at its rounding: the largest gap of
    its logits from ``whole``, its logits, when its weights are
    ``tree.nudged``, over ``SPREAD_DRAWS`` draws, relative to the
    largest of ``whole``."""
    import torch
    from repro_torch.tree import nudged

    g = torch.Generator(device=whole.device).manual_seed(seed + 11)
    gap = 0.0
    for _ in range(SPREAD_DRAWS):
        moved = nudged(params, g)
        out = prefill(moved, batch)[0].float()
        del moved
        gap = max(gap, float((out - whole).abs().max()))
    return gap / float(whole.abs().max())


def model_axis_ssm(K, card: str, dev, seed: int) -> dict:
    """Phase 16e: xlstm-350m (7 mLSTM blocks and one sLSTM a period, 4
    heads of 256, no MLP) at its published width over a "model" axis of
    ranks played by threads on the card (``played_model_axis``). Each
    rank's mLSTM computes its heads from its column shards of ``wq``,
    ``wk``, ``wv``, ``wo_gate`` and ``wif`` (over 16 ranks, where 4 heads
    do not split, every head from those weights gathered whole, and the
    rank's 64 columns of y * o into its rows of ``wout``); each rank's
    sLSTM runs the whole recurrence from ``wx``, ``wr`` and ``b`` taken
    whole, no collective inside its loop, and keeps its rows of y for
    its rows of ``wout``. For each of ``SSM_AXIS_CASES``: the unsplit
    model's prefill of one prompt, then each played rank's on its shards
    (``rank_shards``, ``played_prefill``; xLSTM takes no K9: none may
    launch), f32 logits within the larger of ``MODEL_AXIS_F32_REL`` and
    ``tree.SPREAD_FACTOR`` times the model's own spread at f32 rounding
    (``rounding_floor``) of the largest, and the greedy token
    (``greedy_held``); where there is no decode, each layer
    teacher-forced on the unsplit model's own input
    (``teacher_forced_layers``: f32 within ``MODEL_AXIS_F32_REL``, bf16
    every layer's largest gap within ``DECODE_TOL`` of its largest
    output; the whole bf16 model's gap is reported, not held, since its
    normalizer grows the rounding from segment to segment); in f32 at one
    period, the case's decode steps on every rank over its part of the
    caches (``cache_specs``: the mLSTM's C its heads where they
    split, n and m whole; the sLSTM's state whole), against the unsplit
    model's forward within the same kind of bound, and every cache leaf a
    rank holds whole equal on every rank after them. Then the refresh played
    on every split tensor of one period over 4 ranks
    (``model_axis_refresh``). Returns the path's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import argmax_over
    from repro_torch.launch.sharding import tree_param_specs
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import build_model
    from repro_torch.tree import SPREAD_FACTOR

    t0 = time.perf_counter()
    launches = {"diff_topk_payload": 0, "block_scatter_accumulate": 0}
    rep = {"arch": SSM_AXIS_ARCH, "card": card, "cases": []}
    for layers, world, dtype, t, decode in SSM_AXIS_CASES:
        ext = {"data": 1, "model": world}
        cfg = get_config(SSM_AXIS_ARCH)
        cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                                  dtype=dtype)
        what = (f"{SSM_AXIS_ARCH} ({cfg.n_layers} layers) over {world} "
                f"played ranks, {dtype}")
        model = build_model(cfg)
        g = torch.Generator(device=dev).manual_seed(seed)
        params = model.init_params(g)
        tokens = torch.randint(0, cfg.vocab, (1, t), generator=g, device=dev)
        prefill = make_prefill(model)
        f32 = dtype == "float32"
        forced = not decode
        with (layers_recorded() if forced
              else contextlib.nullcontext([])) as rec:
            whole_ms, whole = host_ms(
                lambda: prefill(params, {"tokens": tokens}))
        whole = whole[0].float()
        floor = (rounding_floor(prefill, params, {"tokens": tokens}, whole,
                                seed) if f32 else None)
        dec_tokens = tokens[:, :decode]
        dec_want = dec_floor = None
        if decode:
            dec_want = prefill(params, {"tokens": dec_tokens})[0].float()
            dec_floor = rounding_floor(prefill, params,
                                       {"tokens": dec_tokens}, dec_want, seed)
        shards = rank_shards(params, tree_param_specs(params, ext), world)
        del params
        torch.cuda.empty_cache()
        axis = played_model_axis(world)
        played_ms, logits, got, _ = played_prefill(
            prefill, shards, axis, {"tokens": tokens}, K)
        require(got["flash_attention"] == 0,
                f"{what}: the xLSTM prefill launched K9")
        joined = joined_logits(logits, cfg.vocab, world, what)
        top = float(whole.abs().max())
        gap = float((joined - whole).abs().max())
        toks = play_ranks(axis, lambda r: int(argmax_over(
            logits[r][-1:], axis if cfg.vocab % world == 0 else None)[0]))
        entry = {"layers": cfg.n_layers, "ranks_played": world,
                 "dtype": dtype, "t": t,
                 "heads_split": cfg.n_heads % world == 0,
                 "whole_prefill_ms": whole_ms,
                 "played_prefill_ms": played_ms, "logit_gap": gap,
                 "logit_max": top, "greedy_token": toks[0],
                 "greedy_equal": toks[0] == int(torch.argmax(whole[-1]))}
        require(bool(torch.isfinite(joined).all()), f"{what}: not finite")
        del logits, joined
        if forced:
            entry["teacher_forced"] = teacher_forced_layers(
                model, shards, axis, rec, [], dtype)
            worst = entry["teacher_forced"]["max_gap_over_max"]
            rel = MODEL_AXIS_F32_REL if f32 else DECODE_TOL
            require(worst <= rel,
                    f"{what}, teacher-forced: a layer's output is {worst} of "
                    f"its largest from the unsplit layer's (bound {rel})")
        if f32:
            tol = max(MODEL_AXIS_F32_REL, SPREAD_FACTOR * floor) * top
            require(gap <= tol and greedy_held(whole[-1], toks, gap),
                    f"{what}: the logits are {gap} from the unsplit model's "
                    f"(bound {tol}; its own spread at f32 rounding {floor} "
                    f"of the largest), greedy {toks}")
            entry.update(bound=tol, rounding_floor=floor)
        else:
            # the whole bf16 model is reported, not held (module comment)
            entry["whole_model_gap_held"] = False
        del rec, whole
        if decode:
            caches = {}
            dec_ms, dec = host_ms(lambda: played_decode(
                model, shards, axis, dec_tokens, ext, caches))
            dec_joined = joined_logits(dec, cfg.vocab, world, what)
            dtop = float(dec_want.abs().max())
            dgap = float((dec_joined - dec_want).abs().max())
            dtol = max(MODEL_AXIS_F32_REL, SPREAD_FACTOR * dec_floor) * dtop
            require(dgap <= dtol,
                    f"{what}: decode over the laid-out caches is {dgap} from "
                    f"the forward (bound {dtol})")
            unsplit = model.init_cache(1, decode, dev)["blocks"]
            whole_leaves = equal_leaves = 0
            for j, blocks in enumerate(unsplit):
                for name, x in caches[0]["blocks"][j].items():
                    if x.shape != blocks[name].shape:
                        continue
                    whole_leaves += 1
                    equal_leaves += all(torch.equal(
                        x, caches[r]["blocks"][j][name])
                        for r in range(1, world))
            del unsplit
            require(whole_leaves > 0 and equal_leaves == whole_leaves,
                    f"{what}: {whole_leaves - equal_leaves} of the "
                    f"{whole_leaves} cache leaves held whole differ between "
                    f"the ranks after the decode")
            entry["decode_vs_forward_f32"] = {
                "t": decode, "ms": dec_ms, "gap": dgap,
                "logit_max": dtop, "bound": dtol,
                "rounding_floor": dec_floor,
                "whole_cache_leaves_equal": equal_leaves}
            del dec, dec_joined, dec_want, caches
        del shards, model
        torch.cuda.empty_cache()
        rep["cases"].append(entry)
    cfg = dataclasses.replace(get_config(SSM_AXIS_ARCH), n_layers=8,
                              dtype="float32")
    K.reset_launches()
    refresh = model_axis_refresh(cfg, dev, seed, K, ranks=4)
    for key in launches:
        launches[key] += refresh[key]
    rep["played_refresh"] = refresh
    rep["s"] = time.perf_counter() - t0
    print(json.dumps({"model_axis_ssm": rep}), flush=True)
    torch.cuda.empty_cache()
    return launches


# phase 16f: the encoder-decoder's and the VLM's "model" axis, ranks
# played on the card: (arch, layers (None: all), text tokens, played
# ranks); whisper's decoder takes 640 tokens (above 2 x SDPA_CHUNK, so
# K9) over its 1,500 frames, llava 2,880 patches and 1,216 tokens; K9
# alone at a rank's heads and the decoder's length: llava's 14 q over 2
# KV heads of 128 at 4,096, whisper's 3 over 3 of 64 at M = 2 and 640;
# the refresh of whisper whole and of one llava
# layer's q and MLP input projections
ENCDEC_AXIS_CASES = (("whisper-tiny", None, 640, (2, 4)),
                     ("llava-next-34b", 2, 1216, (4,)))
ENCDEC_AXIS_REFRESH = {"whisper-tiny": (None, None),
                       "llava-next-34b": (1, ("mixer/wq", "ffn/wi"))}


def model_axis_encdec_vlm(K, card: str, dev, seed: int) -> tuple:
    """Phase 16f: whisper-tiny (6 heads of 64: 3 a rank over 2 ranks;
    over 4 every rank computes every head, ``q_whole``) whole, and
    llava-next-34b at its published width cut to 2 of 60 layers (56 q
    heads over 8 KV heads: 14 over 2 a rank), over a "model" axis of
    ranks played by threads on the card. Whisper's encoder
    self-attention and its decoder's cross-attention run on the rank's
    heads (``_full_attention``: the memory through ``copy_in``), its
    decoder's causal self-attention through K9 on them; its vocab of
    51,865 is replicated, so every rank computes the whole logits.
    llava's batch holds its patches before its tokens. For each, in bf16
    and f32: the unsplit model's prefill, then each played rank's on its
    shards with the counts set to 0 just before and read just after (K9
    once a rank and decoder layer, on the dtype's route), the logits
    against the unsplit model's (f32 within ``MODEL_AXIS_F32_REL`` of
    the largest, bf16 within ``DECODE_TOL``) and the greedy token. Then
    K9 alone at a rank's head count and the decoder's length
    (``model_axis_k9``) and the refresh played on the split tensors
    (``model_axis_refresh``). Returns (the path's launches, K9's
    fields)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import argmax_over
    from repro_torch.launch.sharding import tree_param_specs
    from repro_torch.launch.steps import make_prefill
    from repro_torch.launch.train import add_modality_inputs
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    launches = {"flash_attention": 0, "flash_attention:wgmma": 0,
                "flash_attention:ffma": 0, "diff_topk_payload": 0,
                "block_scatter_accumulate": 0}
    rep = {"card": card, "cases": []}
    k9 = {}
    for arch, layers, text, worlds in ENCDEC_AXIS_CASES:
        full = get_config(arch)
        # K9 alone at the decoder's own length (patches and tokens)
        t = text + (full.vision_tokens if full.family == "vlm" else 0)
        for world in worlds:
            if full.n_heads % world == 0:
                heads = (full.n_heads // world, full.kv_heads // world,
                         full.hd)
                k9[f"{arch}@{world}"] = model_axis_k9(dev, seed, *heads,
                                                      w=None, t=t)
        torch.cuda.empty_cache()
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(full, n_layers=layers or full.n_layers,
                                      dtype=dtype)
            model = build_model(cfg)
            g = torch.Generator(device=dev).manual_seed(seed)
            params = model.init_params(g)
            tokens = torch.randint(0, cfg.vocab, (1, text), generator=g,
                                   device=dev)
            batch = add_modality_inputs({"tokens": tokens}, cfg, 0)
            prefill = make_prefill(model)
            whole_ms, whole = host_ms(lambda: prefill(params, batch))
            whole = whole[0].float()
            top = float(whole.abs().max())
            tol = (MODEL_AXIS_F32_REL if dtype == "float32"
                   else DECODE_TOL) * top
            route = "wgmma" if dtype == "bfloat16" else "ffma"
            for world in worlds:
                what = (f"{arch} ({cfg.n_layers} layers) over {world} played "
                        f"ranks, {dtype}")
                ext = {"data": 1, "model": world}
                last = world == worlds[-1]
                # the last world takes the tree itself (emptied)
                shards = rank_shards(params if last else dict(params),
                                     tree_param_specs(params, ext), world)
                if last:
                    del params
                torch.cuda.empty_cache()
                axis = played_model_axis(world)
                played_ms, logits, got, _ = played_prefill(
                    prefill, shards, axis, batch, K)
                want_k9 = world * cfg.n_layers
                require(got["flash_attention"] == want_k9
                        and got[f"flash_attention:{route}"] == want_k9,
                        f"{what}: K9 launched {got['flash_attention']} "
                        f"times, not {want_k9} (a rank and decoder layer)")
                for key in ("flash_attention", f"flash_attention:{route}"):
                    launches[key] += got[key]
                joined = joined_logits(logits, cfg.vocab, world, what)
                gap = float((joined - whole).abs().max())
                toks = play_ranks(axis, lambda r: int(argmax_over(
                    logits[r][-1:],
                    axis if cfg.vocab % world == 0 else None)[0]))
                require(bool(torch.isfinite(joined).all()) and gap <= tol
                        and greedy_held(whole[-1], toks, gap),
                        f"{what}: the logits are {gap} from the unsplit "
                        f"model's (bound {tol}), greedy {toks}")
                rep["cases"].append({
                    "arch": arch, "layers": cfg.n_layers, "dtype": dtype,
                    "ranks_played": world, "t": whole.shape[0],
                    "heads_split": cfg.n_heads % world == 0,
                    "vocab_split": cfg.vocab % world == 0,
                    "whole_prefill_ms": whole_ms,
                    "played_prefill_ms": played_ms, "k9_launches": want_k9,
                    "logit_gap": gap, "logit_max": top, "bound": tol,
                    "greedy_token": toks[0],
                    "greedy_equal": toks[0] == int(torch.argmax(whole[-1]))})
                del shards, logits, joined
                torch.cuda.empty_cache()
            del whole, model
            torch.cuda.empty_cache()
        depth, only = ENCDEC_AXIS_REFRESH[arch]
        cfg = dataclasses.replace(full, n_layers=depth or full.n_layers,
                                  dtype="float32")
        K.reset_launches()
        refresh = model_axis_refresh(cfg, dev, seed, K, ranks=worlds[-1],
                                     only=only)
        for key in ("diff_topk_payload", "block_scatter_accumulate"):
            launches[key] += refresh[key]
        rep[f"played_refresh_{arch}"] = refresh
        torch.cuda.empty_cache()
    rep["k9_rank_heads"] = k9
    rep["s"] = time.perf_counter() - t0
    print(json.dumps({"model_axis_encdec_vlm": rep}), flush=True)
    return launches, k9


# phase 16g: Hutchinson curvature over the "model" axis. The double
# backward runs on each rank, so the ranks are processes (a thread-played
# rank cannot run a backward: autograd runs a device's backward on one
# thread, where two ranks would wait on each other), all on the one card
# (NCCL takes no two ranks on one card), joined by a gloo group whose
# collectives go through the host (``host_model_axis``). qwen2-0.5B at
# its published width cut to 4 of 24 layers, f32, 2 x 128 tokens, over 4
# rank processes (14 heads over 2 KV heads do not split: every rank
# computes every head) and over 2 (7 heads a rank); then each other
# family's reduced config over 2
HVP_AXIS_ARCH, HVP_AXIS_LAYERS = "qwen2-0.5b", 4
HVP_AXIS_B, HVP_AXIS_T, HVP_FAMILY_T, HVP_WARMUP_T = 2, 128, 64, 16
HVP_AXIS_RANKS = 4
# the families run by ranks 0-1 and by ranks 2-3, two at a time
HVP_AXIS_FAMILIES = (("granite-moe-1b-a400m", "minicpm3-4b",
                      "jamba-1.5-large-398b"),
                     ("xlstm-350m", "whisper-tiny", "llava-next-34b"))
# each leaf's Hz over the ranks within this of its largest |Hz| of one
# process (f32: the row-parallel partial products are summed over the
# ranks where one process takes one product; 5e-6 on the CPU tests)
HVP_AXIS_REL = 1e-4
# the gloo group's timeout and the rank processes' deadline
HVP_AXIS_SECONDS = 300


def host_model_axis(group, ranks: list):
    """A ``ModelAxis`` over the rank processes ``ranks`` (global ranks in
    axis order) of the gloo ``group`` (None: the default group) for
    tensors on the card: each of the three primitives copies its tensor
    to the host, runs the gloo collective there and copies the result
    back to the card; every other operation stays on the card. A tensor
    that is not contiguous is refused, as NCCL refuses it (gloo would
    take it)."""
    import torch.distributed as dist
    from repro_torch.launch.sharding import ModelAxis

    def host(x):
        if not x.is_contiguous():
            raise ValueError(f"a collective's tensor {tuple(x.shape)} is "
                             f"not contiguous (NCCL refuses it)")
        return x.cpu()

    class HostGloo(ModelAxis):
        def __init__(self):
            super().__init__(None)
            self.world, self.group = len(ranks), group
            self.rank = ranks.index(dist.get_rank())

        def _all_gather(self, x):
            return ModelAxis._all_gather(self, host(x)).to(x.device)

        def _all_reduce(self, x, op="sum"):
            return x.copy_(ModelAxis._all_reduce(self, host(x), op))

        def _reduce_scatter(self, x):
            return ModelAxis._reduce_scatter(self, host(x)).to(x.device)

    return HostGloo()


@contextlib.contextmanager
def routings_recorded():
    """While the block runs, every MoE routing's gate ids and top-k
    margins (``top_k_margin`` of the router probabilities), in order."""
    import repro_torch.models.mlp as mlp

    out, top = [], mlp.top_k_lower_index

    def recording(x, k):
        vals, ids = top(x, k)
        out.append((ids.detach(), top_k_margin(x.detach(), k)))
        return vals, ids

    mlp.top_k_lower_index = recording
    try:
        yield out
    finally:
        mlp.top_k_lower_index = top


def hvp_axis_case(cfg, axis, dev, seed: int, K, t: int,
                  refresh: bool) -> dict:
    """One rank's part of Hutchinson curvature over ``axis``: the
    config's whole tree drawn from ``seed`` (alike on every rank) and a
    (B, ``t``) batch with the family's frames or patches; this rank's
    shards by the rules, their probe (``RademacherProbes`` with the
    layouts: the rank's block of one process's z) and the double backward
    (``grad_and_hvp``) with the axis installed, then (``refresh``) the
    observations z * Hz and ``optimizer.refresh(..., layout=)`` from H = 0
    on the shards, K1 and K4 counted from 0 just before the probe and read
    just after the refresh (a warm-up double backward on the batch's first
    tokens before). Then on this rank alone, one process: z and
    Hz of the whole tree, the rank's blocks held to them (z bit for bit,
    Hz within ``HVP_AXIS_REL`` of each leaf's largest |Hz|; an MoE up to
    its first router flip, which must be a near tie; xLSTM within
    ``tree.SPREAD_FACTOR`` times the leaf's own spread when the weights
    move by a rounding, if that is larger), and the one-call refresh of
    every rank's observations gathered whole, held bit for bit."""
    import torch
    from repro_torch.launch.sharding import (DataAxis, LeafLayout,
                                             _split_dims, check_model_axis,
                                             model_parts, tree_param_specs)
    from repro_torch.launch.steps import (RademacherProbes, grad_and_hvp,
                                          make_optimizer)
    from repro_torch.launch.train import add_modality_inputs
    from repro_torch.models import build_model
    from repro_torch.models.common import set_activation_sharder
    from repro_torch.second_order.fednl_precond import (FedNLPrecondState,
                                                        _tile_grid)
    from repro_torch.tree import (SPREAD_FACTOR, nudged, tree_leaves,
                                  tree_map, tree_unflatten)

    ext = {"data": 1, "model": axis.world}
    check_model_axis(cfg, ext)
    model = build_model(cfg, use_remat=True)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(g)
    tokens = torch.randint(0, cfg.vocab, (HVP_AXIS_B, t), generator=g,
                           device=dev)
    batch = add_modality_inputs({"tokens": tokens,
                                 "targets": torch.roll(tokens, -1, 1)},
                                cfg, 0)
    specs = tree_param_specs(params, ext)
    mdims = [_split_dims(s).get("model") for s in tree_leaves(specs)]
    data = DataAxis(None, model=axis)
    lays = tree_unflatten(params, [LeafLayout(None, data, d) for d in mdims])
    shards = tree_map(lambda x: x.contiguous(),
                      model_parts(params, specs, axis))
    probes = RademacherProbes(seed)
    opt = make_optimizer("fednl", 1e-3, k_per_block=MODEL_AXIS_K,
                         curvature="hutchinson")
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "ranks": axis.world,
           "rank": axis.rank, "t": int(batch["tokens"].shape[1]),
           "heads_split": cfg.n_heads % axis.world == 0,
           "tensors": len(mdims),
           "tensors_split": sum(d is not None for d in mdims)}

    # warm-up: a double backward over the axis on the batch's first
    # HVP_WARMUP_T tokens (the first call in a process pays the card's
    # and the group's set-up)
    short = {k: v[:, :HVP_WARMUP_T] if k in ("tokens", "targets") else v
             for k, v in batch.items()}
    set_activation_sharder(None, None, axis)
    try:
        grad_and_hvp(model, shards, short, tree_map(torch.ones_like, shards))
    finally:
        set_activation_sharder(None, None, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    z = probes(0, 0, shards, lays)
    torch.cuda.synchronize()
    rec["probe_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with routings_recorded() as routes:
        set_activation_sharder(None, None, axis)
        try:
            grads, hz = grad_and_hvp(model, shards, batch, z)
        finally:
            set_activation_sharder(None, None, None)
    torch.cuda.synchronize()
    rec["hz_ms"] = (time.perf_counter() - t0) * 1e3
    if refresh:
        t0 = time.perf_counter()
        obs = opt.observe(grads, shards, hvp=(z, hz))
        state = FedNLPrecondState(0, tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=dev), shards), None, None)
        new = opt.refresh(state, tree_map(lambda o: o[None].contiguous(),
                                          obs), layout=lays)
        torch.cuda.synchronize()
        rec["refresh_ms"] = (time.perf_counter() - t0) * 1e3
    got = counts(K)
    rec["launches"] = {k: got[k] for k in ("diff_topk_payload",
                                           "block_scatter_accumulate",
                                           "flash_attention")}
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del grads

    # one process, on this rank alone
    zw = probes(0, 0, params)
    grad_and_hvp(model, params, short, zw)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with routings_recorded() as whole_routes:
        _, hzw = grad_and_hvp(model, params, batch, zw)
    torch.cuda.synchronize()
    rec["one_hz_ms"] = (time.perf_counter() - t0) * 1e3

    def block(x, mdim):
        return x if mdim is None else axis.part(x, mdim)

    rec["z_bitwise"] = all(
        torch.equal(a, block(b, d))
        for a, b, d in zip(tree_leaves(z), tree_leaves(zw), mdims))
    gaps = [float((a - block(b, d)).abs().max()) / float(b.abs().max())
            for a, b, d in zip(tree_leaves(hz), tree_leaves(hzw), mdims)]
    rec["hz_rel_max"] = max(gaps)
    bounds = [HVP_AXIS_REL] * len(gaps)
    if cfg.family == "ssm":
        moved = nudged(params, torch.Generator(device=dev).manual_seed(
            seed + 11))
        _, hzn = grad_and_hvp(model, moved, batch, zw)
        spread = [float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(tree_leaves(hzn), tree_leaves(hzw))]
        rec["spread_rel_max"] = max(spread)
        bounds = [max(b, SPREAD_FACTOR * s) for b, s in zip(bounds, spread)]
        del moved, hzn
    held = all(gap <= b for gap, b in zip(gaps, bounds))
    rec["why"] = "" if held else (
        f"Hz {max(gaps)} of its leaf's largest from one process's "
        f"(leaf {gaps.index(max(gaps))})")
    if cfg.moe is not None:
        flips = route_flips(whole_routes, routes)
        rec["route_flips"] = flips
        if flips["first_layer"] is not None:
            # past a flip the routes differ: held to its being a near tie
            held = flips["max_margin_first_layer"] <= MOE_NEAR_TIE
            rec["why"] = "" if held else f"a router flip off a near tie: " \
                f"{flips}"
    rec["ok"] = rec["z_bitwise"] and held
    if not rec["z_bitwise"]:
        rec["why"] += "; z is not the rank's block of one process's"

    if refresh:
        whole_obs = [axis.whole(o, d) if d is not None else o
                     for o, d in zip(tree_leaves(obs), mdims)]
        one = opt.refresh(FedNLPrecondState(0, tree_map(
            lambda x: torch.zeros(x.shape, dtype=torch.float32, device=dev),
            params), None, None),
            tree_unflatten(params, [o[None].contiguous() for o in whole_obs]))
        rec["refresh_bitwise"] = all(
            torch.equal(a, block(b, d)) for a, b, d in
            zip(tree_leaves(new.h), tree_leaves(one.h), mdims)) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(new.l),
                                               tree_leaves(one.l)))
        tile = opt.refresh.__self__.block
        rec["tensors_on_tile_bounds"] = sum(
            d is not None and _tile_grid(x.shape, d, tile) is not None
            for x, d in zip(tree_leaves(shards), mdims))
        rec["ok"] = rec["ok"] and rec["refresh_bitwise"]
        if not rec["refresh_bitwise"]:
            rec["why"] += "; the refresh differs from the one-call refresh"
        del obs, new, one, whole_obs
    del params, shards, z, hz, zw, hzw
    torch.cuda.empty_cache()
    return rec


def hvp_axis_rank(rank: int, world: int, store_path: str, out_path: str,
                  seed: int, device: str) -> None:
    """A rank process of phase 16g (``torch.multiprocessing`` spawns
    ``world`` of them on ``device``, the card): a gloo group over a
    ``FileStore``; qwen2-0.5B's cut depth over every rank, then over ranks
    0-1 while ranks 2-3 take their families, then ranks 0-1 theirs
    (``hvp_axis_case``). Every rank's records gathered, rank 0 writes
    them to ``out_path`` as JSON."""
    import datetime

    import torch
    import torch.distributed as dist

    import repro_torch.kernels as K
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        K.build_all()            # loads the libraries the parent built
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=HVP_AXIS_SECONDS))
    try:
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        full = dataclasses.replace(get_config(HVP_AXIS_ARCH),
                                   n_layers=HVP_AXIS_LAYERS, dtype="float32")
        cases = [hvp_axis_case(full, host_model_axis(None, list(range(world))),
                               dev, seed, K, HVP_AXIS_T, refresh=True)]
        pair = rank // 2
        axis = host_model_axis(pairs[pair], [2 * pair, 2 * pair + 1])
        if pair == 0:
            cases.append(hvp_axis_case(full, axis, dev, seed, K, HVP_AXIS_T,
                                       refresh=True))
        for arch in HVP_AXIS_FAMILIES[pair]:
            cases.append(hvp_axis_case(get_config(arch, smoke=True), axis,
                                       dev, seed, K, HVP_FAMILY_T,
                                       refresh=False))
        everyone = [None] * world
        dist.all_gather_object(everyone, cases)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(everyone, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def merged_hvp_cases(by_rank: list) -> list:
    """The rank processes' records of each (arch, layers, ranks) case
    merged: launches summed over its ranks, the largest gap, every
    rank's host ms and peak memory, ok where every rank's is."""
    merged = {}
    for cases in by_rank:
        for c in cases:
            key = (c["arch"], c["layers"], c["ranks"])
            m = merged.setdefault(key, {
                **{k: c[k] for k in ("arch", "layers", "ranks", "t",
                                     "heads_split", "tensors",
                                     "tensors_split")},
                "launches": {k: 0 for k in c["launches"]},
                "hz_rel_max": 0.0, "ok": True, "why": [],
                "probe_ms": [], "hz_ms": [], "one_hz_ms": [],
                "peak_gb": []})
            for k, n in c["launches"].items():
                m["launches"][k] += n
            m["hz_rel_max"] = max(m["hz_rel_max"], c["hz_rel_max"])
            for k in ("probe_ms", "hz_ms", "one_hz_ms", "peak_gb"):
                m[k].append(c[k])
            for k in ("refresh_ms",):
                if k in c:
                    m.setdefault(k, []).append(c[k])
            for k in ("refresh_bitwise", "z_bitwise"):
                if k in c:
                    m[k] = m.get(k, True) and c[k]
            for k in ("tensors_on_tile_bounds", "spread_rel_max",
                      "route_flips"):
                if k in c:
                    m[k] = c[k]
            m["ok"] = m["ok"] and c["ok"]
            if c["why"]:
                m["why"].append(f"rank {c['rank']}: {c['why']}")
    return list(merged.values())


def model_axis_hvp(K, card: str, dev, seed: int) -> dict:
    """Phase 16g: ``HVP_AXIS_RANKS`` rank processes spawned on the card
    (``hvp_axis_rank``), joined within ``HVP_AXIS_SECONDS``; every case's
    records merged (``merged_hvp_cases``) and held: each rank's z its
    block of one process's, Hz within its bound, the refresh bit for bit,
    and on qwen2-0.5B's cut depth one K1 and one K4 a rank and tensor.
    Returns the path's launches (qwen2's cases)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "out.json")
        ctx = mp.start_processes(
            hvp_axis_rank, args=(HVP_AXIS_RANKS, os.path.join(tmp, "store"),
                                 out_path, seed, str(dev)),
            nprocs=HVP_AXIS_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + HVP_AXIS_SECONDS
        try:
            while not ctx.join(timeout=1):
                require(time.monotonic() < deadline,
                        f"16g: the {HVP_AXIS_RANKS} rank processes did not "
                        f"finish in {HVP_AXIS_SECONDS} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
            raise SmokeFailure(f"16g: a rank process failed: {exc}") from exc
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        with open(out_path) as f:
            cases = merged_hvp_cases(json.load(f))
    launches = {"diff_topk_payload": 0, "block_scatter_accumulate": 0}
    for c in cases:
        what = (f"16g: {c['arch']} ({c['layers']} layers) over "
                f"{c['ranks']} ranks")
        require(c["ok"], f"{what}: {c['why']}")
        if c["arch"] == HVP_AXIS_ARCH:
            want = c["ranks"] * c["tensors"]
            got = c["launches"]
            require(got["diff_topk_payload"] == want
                    and got["block_scatter_accumulate"] == want,
                    f"{what}: the refresh launched K1 "
                    f"{got['diff_topk_payload']} and K4 "
                    f"{got['block_scatter_accumulate']} times, not {want} "
                    f"(one a rank and tensor)")
            for k in launches:
                launches[k] += got[k]
    require(sum(c["arch"] == HVP_AXIS_ARCH for c in cases) == 2
            and len(cases) == 2 + sum(map(len, HVP_AXIS_FAMILIES)),
            f"16g: {len(cases)} cases came back")
    rep = {"card": card, "rank_processes": HVP_AXIS_RANKS, "cases": cases,
           "s": time.perf_counter() - t0}
    print(json.dumps({"model_axis_hvp": rep}), flush=True)
    return launches


def add_path_launches(kernels: list, path: str, launches: dict) -> None:
    """``path``'s launches added to each kernel line entry it launched."""
    for entry in kernels:
        n = launches.get(entry["name"], 0)
        if n:
            entry["launches_by_path"][path] = n
            entry["launches"] += n


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the optimizer phase's weights and "
                             "gradients")
    parser.add_argument("--count-train-steps", action="store_true",
                        help="only count the measured train steps' FLOPs and "
                             "bytes on the meta device (phase 12 runs this "
                             "in the background)")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if args.count_train_steps:
        return count_train_steps()
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        return fail(f"the port's sources are not at {src}")
    sys.path.insert(0, str(src))
    import repro_torch.kernels as K
    from repro_torch.data import make_problem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        return fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    counter = None
    try:
        # -- 2. build -------------------------------------------------------
        t0 = time.perf_counter()
        logs = K.build_all()
        for name, log in logs.items():
            for line in ptxas_lines(log):
                print(f"# ptxas {name}: {line}")
        print(f"# build: {time.perf_counter() - t0:.1f} s", flush=True)
        # phase 12's count of the train steps, on the host meanwhile
        counter = start_train_counts()

        # -- 3-7. kernels and paths -----------------------------------------
        err = {name: 0.0 for name in K.LAUNCHES}
        err["scatter_accumulate_tiled"] = 0.0           # K2 at d >= 1,025
        t0 = time.perf_counter()
        check_fednl_kernels(dev, err)
        print(f"# K1, K2/K3, K4 match their plain versions (f64 and f32) "
              f"in {time.perf_counter() - t0:.1f} s; max abs err in f64 "
              f"{json.dumps(err)}", flush=True)
        prob = make_problem("w8a", seed=0, device=dev)
        x0 = torch.zeros(prob["d"], dtype=torch.float64, device=dev)
        paths = {"fednl_w8a": fednl_w8a(dev, prob, x0, K)}
        paths["fednl_variants_w8a"] = fednl_variants_w8a(dev, prob, x0, K,
                                                         card)
        paths["engine_w8a"] = engine_w8a(dev, prob, K, card)
        paths.update(sharded_w8a(dev, prob, x0, K, card))

        # -- 11. the train step at full width, before the phases that
        # profile: a profiler session slows later launches (PERF.md §2)
        t0 = time.perf_counter()
        paths["train_qwen2"] = train_qwen2(dev, args.seed, K, card)
        print(f"# train phase in {time.perf_counter() - t0:.1f} s; launches "
              f"K1 {paths['train_qwen2']['diff_topk_payload']}, K4 "
              f"{paths['train_qwen2']['block_scatter_accumulate']}",
              flush=True)
        t0 = time.perf_counter()
        paths["train_granite"] = train_granite(dev, args.seed, K, card)
        print(f"# MoE train phase in {time.perf_counter() - t0:.1f} s; "
              f"launches K1 {paths['train_granite']['diff_topk_payload']}, "
              f"K4 {paths['train_granite']['block_scatter_accumulate']}",
              flush=True)
        t0 = time.perf_counter()
        paths["train_xlstm"] = train_xlstm(dev, args.seed, K, card)
        paths["train_jamba_reduced"] = train_jamba(dev, args.seed, K, card)
        print(f"# hybrid and ssm train phase in "
              f"{time.perf_counter() - t0:.1f} s; launches K1 "
              f"{paths['train_xlstm']['diff_topk_payload']} (xlstm) + "
              f"{paths['train_jamba_reduced']['diff_topk_payload']} (reduced "
              f"jamba), K4 {paths['train_xlstm']['block_scatter_accumulate']}"
              f" + {paths['train_jamba_reduced']['block_scatter_accumulate']}",
              flush=True)
        paths["topk_aggregate_d2048"], k3_pay = topk_aggregate_k3(dev, K, err)
        k2 = k2_measure(dev, prob, x0, k3_pay)
        pre = precond_qwen2(dev, args.seed, K, err)
        paths["fednl_precond_qwen2"] = pre["launches"]
        paths["fednl_precond_qwen2_uplink"] = pre["uplink_launches"]
        w8a_h = prob["hess"](x0)[0].contiguous()
        paths["powersgd_and_dense_topk"] = powersgd_and_dense_topk(
            dev, args.seed, {"w8a hessian": (w8a_h, 8),
                             "layers.ffn.wg[0]": (pre["wg0"], K_PER_BLOCK)},
            K, err)
        hu = hess_update_w8a(dev, prob, x0, pre["embed"], K, err)
        paths["hess_update_w8a"] = hu["launches"]

        # -- 8. timings -----------------------------------------------------
        round_ms, breakdown = fednl_round_times(prob, x0)
        print(json.dumps({"round_ms_median": round_ms, "card": card}), flush=True)
        print(json.dumps({"round_profile": breakdown}), flush=True)
        inputs = dict(embed=pre["embed"], wg0=pre["wg0"], hess_update=hu,
                      refresh=pre["refresh"], k2=k2)
        kernels = kernel_line(dev, prob, x0, paths, inputs, err)
        wg0 = pre["wg0"]
        del pre, hu, inputs, k3_pay

        # -- 9d-9g, 9b, 9c, 9. the MoE, encoder-decoder and VLM families,
        # starcoder2-3b, minicpm3-4b and qwen2-0.5B serving: every profile
        # before every decode loop (a profiler session records few
        # launches, or none, after a million of them)
        t0 = time.perf_counter()
        nf = serve_new_families(dev, args.seed, K)
        print(f"# MoE, encoder-decoder and VLM prefill phases in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        jm = serve_jamba(dev, args.seed, K)
        sc = serve_starcoder2(dev, args.seed, K)
        mc = serve_minicpm3(dev, args.seed, K)
        t0 = time.perf_counter()
        sv = serve_qwen2(dev, args.seed, K, err)
        paths.update(sv["paths"])
        print(f"# qwen2-0.5B serving phase in {time.perf_counter() - t0:.1f} s; "
              f"launches {json.dumps(sv['paths'])}", flush=True)
        xl = serve_xlstm(dev, args.seed, K)
        sc["paths"].update(decode_starcoder2(dev, args.seed, K,
                                             sc.pop("params")))
        mc["paths"].update(decode_minicpm3(dev, args.seed, K,
                                           mc.pop("params")))
        jm["paths"].update(decode_jamba(dev, args.seed, K, jm.pop("params")))
        nf["paths"].update(decode_new_families(dev, args.seed, K,
                                               nf.pop("params")))
        xl["paths"].update(long_xlstm(dev, args.seed, K, xl.pop("params")))
        # K9's entry: qwen2's paths and figures, then starcoder2's
        # windowed ones, then the six new models' head counts
        k9 = sv["kernel"]
        for path, n in {**sc["paths"], **mc["paths"], **nf["paths"],
                        **jm["paths"], **xl["paths"]}.items():
            paths[path] = n
            if n["flash_attention"]:
                k9["launches_by_path"][path] = n["flash_attention"]
                for r in k9["launches_by_route"]:
                    k9["launches_by_route"][r] += n[f"flash_attention:{r}"]
        k9["launches"] = sum(k9["launches_by_path"].values())
        k9["window_launches"] = sc["paths"]["prefill_starcoder2"][
            "flash_attention"]
        k9.update(sc["window"])
        k9["new_shapes"] = {**nf["k9"], JAMBA: jm["k9"]}
        kernels.append(k9)

        # -- 10. the loss's gradient above 512 tokens -------------------------
        t0 = time.perf_counter()
        grad_qwen2(dev, args.seed, K)
        print(f"# gradient phase in {time.perf_counter() - t0:.1f} s",
              flush=True)

        # -- 12. the measured train steps against their roofline -----------
        roofline_of_steps(counter, card)

        # -- 13. the autotuner and every launch's budget (every earlier
        # phase ran on an empty cache) --------------------------------------
        ph13 = tuning_phase(dev, prob, x0, wg0, card, K)
        attach_phase13(kernels, ph13)

        # -- 14. the examples: four in their own processes, the train
        # example at qwen2-0.5B width in this one, through K1 and K4 ------
        del prob, x0, wg0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        example_processes(card)
        launches, example = example_train_lm(K, card)
        add_path_launches(kernels, "examples_train_lm", launches)
        print(f"# examples phase in {time.perf_counter() - t0:.1f} s",
              flush=True)

        # -- 15. the train driver on a one-rank NCCL mesh, equal to phase
        # 14's run; four ranks' refresh played in turn on the card ---------
        t0 = time.perf_counter()
        add_path_launches(kernels, "mesh_train_qwen2",
                          mesh_train_qwen2(K, card, example, dev))
        print(f"# mesh train phase in {time.perf_counter() - t0:.1f} s",
              flush=True)

        # -- 16. starcoder2-15b's "model" axis: 4 ranks played on the card
        t0 = time.perf_counter()
        launches, k9_rep12 = model_axis_starcoder2_15b(K, card, dev,
                                                       args.seed)
        add_path_launches(kernels, "model_axis_starcoder2_15b", launches)
        for entry in kernels:
            if entry["name"] == "flash_attention":
                for r in entry["launches_by_route"]:
                    entry["launches_by_route"][r] += launches[
                        f"flash_attention:{r}"]
                entry["n_rep12_window"] = k9_rep12
        print(f"# model axis phase in {time.perf_counter() - t0:.1f} s",
              flush=True)

        # -- 16b. the MoE family's "model" axis: granite and grok-1 over 4
        # played ranks (expert parallel), grok-1 over 16 (tensor parallel
        # inside the experts)
        t0 = time.perf_counter()
        launches, k9_moe = model_axis_moe(K, card, dev, args.seed)
        add_path_launches(kernels, "model_axis_moe", launches)
        for entry in kernels:
            if entry["name"] == "flash_attention":
                for r in entry["launches_by_route"]:
                    entry["launches_by_route"][r] += launches[
                        f"flash_attention:{r}"]
                entry["moe_axis_shapes"] = k9_moe
        print(f"# MoE model axis phase in {time.perf_counter() - t0:.1f} s",
              flush=True)

        # -- 16c. MLA's "model" axis: minicpm3-4b over 4 played ranks at
        # full depth, 4 layers over 16 (the heads whole on each)
        t0 = time.perf_counter()
        add_path_launches(kernels, "model_axis_mla",
                          model_axis_mla(K, card, dev, args.seed))
        print(f"# MLA model axis phase in {time.perf_counter() - t0:.1f} s",
              flush=True)

        # -- 16d. the hybrid family's "model" axis: jamba's Mamba mixers,
        # MLP, MoE and attention over 4 played ranks
        t0 = time.perf_counter()
        launches, k9_hybrid = model_axis_hybrid(K, card, dev, args.seed)
        add_path_launches(kernels, "model_axis_hybrid", launches)
        for entry in kernels:
            if entry["name"] == "flash_attention":
                for r in entry["launches_by_route"]:
                    entry["launches_by_route"][r] += launches[
                        f"flash_attention:{r}"]
                entry["hybrid_axis_rank_heads"] = k9_hybrid
        print(f"# hybrid model axis phase in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # -- 16e. xLSTM's "model" axis: xlstm-350m whole over 4 played
        # ranks (a head a rank), a period over 4 in bf16 and over 16
        t0 = time.perf_counter()
        add_path_launches(kernels, "model_axis_ssm",
                          model_axis_ssm(K, card, dev, args.seed))
        print(f"# xLSTM model axis phase in {time.perf_counter() - t0:.1f} s",
              flush=True)

        # -- 16f. the encoder-decoder's and the VLM's "model" axis:
        # whisper-tiny over 2 and 4 played ranks, llava-next-34b's first
        # 2 layers over 4
        t0 = time.perf_counter()
        launches, k9_encdec = model_axis_encdec_vlm(K, card, dev, args.seed)
        add_path_launches(kernels, "model_axis_encdec_vlm", launches)
        for entry in kernels:
            if entry["name"] == "flash_attention":
                for r in entry["launches_by_route"]:
                    entry["launches_by_route"][r] += launches[
                        f"flash_attention:{r}"]
                entry["encdec_vlm_axis_rank_heads"] = k9_encdec
        print(f"# encoder-decoder and VLM model axis phase in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # -- 16g. Hutchinson curvature over the "model" axis: 4 rank
        # processes on the card joined by gloo, qwen2-0.5B's width over 4
        # and 2 of them, each other family's reduced config over 2
        t0 = time.perf_counter()
        add_path_launches(kernels, "model_axis_hvp",
                          model_axis_hvp(K, card, dev, args.seed))
        print(f"# Hutchinson model axis phase in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    except SmokeFailure as exc:
        return fail(str(exc))
    finally:
        if counter is not None and counter.poll() is None:
            counter.kill()
            counter.communicate()

    # -- 12. result lines ----------------------------------------------------
    print(json.dumps({"profiler_misses": PROFILER_MISSES}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
