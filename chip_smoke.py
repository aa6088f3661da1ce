#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. Print the card's name and power limit (``nvidia-smi``); fail when
   ``torch.cuda.is_available()`` is false.
2. Build the CUDA kernels from ``howtotrainyourmamlpytorch_tpu_torch/
   kernels/csrc`` (and print ptxas' resource usage).
3. Hold each kernel against its plain PyTorch twin on the card at the
   main paths' shapes — the serving kernels K1-K4 at T = 8 tenants, N = 25
   and 75 images; the training kernels K1 stats-free and K5 at T = 2 and 8
   tasks, N = 25 — at layer-1 and layer-2 geometry of the mini-ImageNet
   model, K1 (both modes) and K4 also at its stages 2-3 (21 and 10
   pixels; the f32 stride-1 K1 and K4 held twice, bit for bit, here, at
   the Omniglot layers and at pad 0, and their rows printed with their
   library ratio and bound share as ``[K1]`` lines, with each K1 row's
   device time from the profiler, and ``[K4]`` lines); K3 and K5 in f32
   (the cooperative kernels of ``csrc/bn_act_pool_bwd.cu``) also at the
   stages 2-3 and K3 at T = 2 at every stage (N = 25), every f32 pooled
   K3 and K5 call held twice, bit for bit, and their rows printed as
   ``[K3]`` and ``[K5]`` lines with their device time and bound share;
   K2 (``csrc/bn_act_fwd.cu``, pooled and pool-free, f32 and bf16) at
   every shape this phase and the later kernel phases hold it — the
   pooled rows, ``bn_act_fwd``, ``batch_norm_fwd`` and their ``_bf16``
   forms — each call held twice, bit for bit, its rows printed as
   ``[K2]`` lines with their device time, bound share and library ratio;
   ``bn_input_stats`` (``csrc/bn_input_stats.cu``) and the GAP's forward
   and backward (``csrc/global_avg_pool.cu``), f32 and bf16, at every
   shape this phase and the later kernel phases hold them — the
   norm-first stages and the strided image, the strided Omniglot 2 x 2 x
   64 map and the unpadded strided 4 x 4 x 48 map at N = 75 — each call
   held twice, bit for bit, their rows printed at the end as ``[B5]``
   lines with their device time, bound share and library ratio; the
   pool-free K3 (``csrc/bn_act_bwd.cu``: ``bn_act_bwd``, and at slope 1
   ``batch_norm_bwd``) and ``act_bwd`` (``csrc/act.cu``), f32 and bf16, at
   every shape the models give them (the strided and unpadded strided
   conv outputs, every norm-first block input; T = 2 and 8), each call
   held twice, bit for bit (``act_bwd`` also bit for bit its twin), the
   timed rows printed at the end as ``[K3f]`` lines with their device
   time, bound share and library ratio; ``act_fwd`` (``csrc/act.cu``) and
   ``layer_norm_fwd`` (``csrc/layer_norm.cu``), f32 and bf16, at every
   shape the models give them (the strided norm-first conv outputs; every
   tensor the layer-norm models normalize, T = 2 and 8), each call bit for
   bit its twin and held twice, bit for bit, the timed rows printed at the
   end as ``[FWD]`` lines with their device time, bound share and library
   ratio; ``act_pool_fwd`` and ``act_pool_bwd`` (``csrc/act.cu``), f32
   and bf16, at the norm-first stages (84/42/21/10) and the unpadded conv
   outputs (82/39/17/6), each call its twin's bits (zeros' signs
   included) and held twice, the timed rows printed at the end as
   ``[B2]`` lines with their device time and bound share; the pool-free
   K5 (``csrc/bn_act_bwd.cu``: ``bn_act_bwd_bwd``, and at slope 1
   ``batch_norm_bwd_bwd``) and ``act_pool_gather`` (``csrc/act.cu``, its
   twin's bits), f32 and bf16, at the strided layers and the norm-first
   stages, each call held twice, bit for bit, the timed rows printed at
   the end as ``[K5f]`` and ``[B2]`` lines;
   K1-K5 again at the four layers of the Omniglot 20-way 1-shot
   model (28/14/7/3, cin 1 and 64, cout 64, T = 8, N = 20); and the ingest
   kernel ``episode_expand`` at the Omniglot device-tier train batch, a
   mini-ImageNet serve bucket of 8 (also with ``reverse_channels``) and the
   uint8 decode of a mini-ImageNet train batch of 2, where it must EQUAL
   its twin (a pure lookup), plus rows outside the store. Each is timed
   beside its twin and, where one PyTorch call computes the same function,
   that library call (CUDA events, after a warmup). Then the block's first
   and second derivatives on the kernels against autograd of the plain
   block.
4. Serving main paths: the port's ``serve-bench`` at the full mini-ImageNet
   5-way 5-shot configuration, 16 requests each, through ``ServingEngine``
   with the f32, uint8 and index ingests (the index store: 12,000 rows).
   Every kernel's launch counter is zeroed just before each run and read
   just after, and must have moved by the per-dispatch counts of the model
   (5 inner steps x 4 blocks, plus 2 / 1 ``episode_expand`` for uint8 /
   index) for every dispatch. Then the serve step against the plain serve
   step (small input; one full-width bucket-8 dispatch), one bucket-8
   index dispatch
   against the f32 dispatch on the host-decoded pixels of the same rows
   (bit-identical preds and loss), and profiles of a bucket-8 and a
   bucket-1 f32 dispatch and a bucket-8 index dispatch.
5. Training main paths: the port's ``train-bench`` at the mini-ImageNet
   configuration, second order from epoch 0 (MSL on), at batch 2 (the
   config's) and 8 on one fixed batch, and at the Omniglot 20-way 1-shot
   configuration (batch 8) through the device data tier and the host tier,
   2 warmup and 5 timed steps each; every step's launches must equal
   ``expected_step_launches`` (one ``episode_expand`` per device-tier
   step). Then a learning check (10 steps on one fixed batch) of each
   model, profiles of a mini-ImageNet batch-2 step and an Omniglot
   device-tier step, and the meta-gradients of the kernels against the
   plain ops on the card: on a small input at the CPU parity tolerance,
   and at full width, batch 2, for one data seed of each model by default
   (``--grad-seeds``, ``--omniglot-grad-seeds``), leaf by leaf against the
   same step in f64, beside the plain ops' own f32 errors: first with the
   f64 step replaying each f32 run's pool argmaxes and leaky-ReLU signs
   (the smooth rounding error alone), then against f64's own path (twopass
   and fused statistics, each the median over five orders of the images).
6. The norm-first model (``block_order='norm_conv_relu'``, the same
   mini-ImageNet config with only that field overridden): its kernels at
   the four stages (``bn_input_stats`` on the image at C = 3, K2/K3/K5 at
   slope 1 as ``batch_norm_*``, the leaky-ReLU + pool kernels, K1
   stats-free with bias at cin 3 and dgrad back to it; the pool-free
   ``act_*`` and the stride-2 dgrad at cin 1 at the strided Omniglot
   layers) against their twins, the norm-first block's first and second
   derivatives (pooled, and strided with GAP; the plain block replays
   the kernels' pool argmaxes and signs, and in the serve-step and
   meta-gradient checks the recording kernel block is held bit for bit
   to the model's own block); ``serve-bench --block_order
   norm_conv_relu`` with the f32 and index ingests (16
   requests, launches per dispatch as ``expected_launches`` says), the
   serve step against the plain one (small and full width, without the
   CPU spread), the index
   dispatch bit-identical to f32, a profiled bucket-8 dispatch;
   ``train-bench`` second order at batch 2 (launches per step as
   ``expected_train_launches`` says), the 10-step learning check, a
   profiled step, the small meta-gradient check and the replayed-path
   gate on ``--norm-first-grad-seeds``; then 4 f32 requests of the
   strided norm-first Omniglot model and its small serve-step check.
7. The layer-norm model (``norm_layer='layer_norm'``, the mini-ImageNet
   config with only that field overridden): the layer norm's kernels
   (``layer_norm_stats/fwd/bwd/bwd_bwd``; the statistics and the backward
   one launch of ``csrc/layer_norm.cu`` each, a second launch bit for bit
   the first, here and in bf16) at every tensor the layer-norm
   models normalize (both orders' mini-ImageNet stages, the strided
   Omniglot layers) against their twins, both layer-norm blocks' first and
   second derivatives (pooled, and strided with GAP; the plain block
   replays the kernels' decisions); ``serve-bench --norm_layer
   layer_norm`` with the f32 and index ingests (16 requests), the serve
   step against the plain one (small and full width, without the CPU
   spread), the index dispatch bit-identical to f32; ``train-bench``
   second order at batch 2, the learning check, the
   small meta-gradient check and the replayed-path gate on
   ``--layer-norm-grad-seeds``; then 4 f32 requests each of the
   norm-first layer-norm model and of the strided layer-norm Omniglot
   model, each with its small serve-step check.
8. The unpadded models (``conv_padding=False``, the mini-ImageNet config
   with only that field overridden: every 3x3 conv a valid window): the
   conv kernels at pad 0 (K1 with statistics and stats-free, dgrad,
   wgrad; ``conv3x3_p0_*`` and, strided, ``conv3x3_s2_p0_*``) at the four
   stages of the pooled and the strided unpadded model (dgrad back to cin
   3 at the pooled stage 0) against their twins, K2/K3 on the odd conv
   outputs, and the unpadded block's first and second derivatives
   (pooled, strided, strided with GAP); ``serve-bench --conv_padding
   false`` with the f32 and index ingests (16 requests), the serve step
   against the plain one (small and full width, without the CPU spread),
   the index dispatch bit-identical to f32; ``train-bench``
   second order at batch 2, the learning check, the
   small meta-gradient check and the replayed-path gate on
   ``--unpadded-grad-seeds``; 4 f32 requests each of the strided, the
   norm-first and the layer-norm unpadded models, each with its small
   serve-step check, and 2 second-order train steps of the strided one
   (its backward is the only path to the stride-2 pad-0 stats-free
   conv). Then the MAML (not ++) mini-ImageNet config as
   shipped (shared batch-norm parameters, no running statistics, no MSL,
   a fixed inner learning rate): 4 f32 requests, the small serve-step
   check and 2 second-order train steps.
9. bf16 (``compute_dtype='bfloat16'``, the configs with only that field
   overridden): the bf16 kernels (K1 with statistics, K2/K3 pooled, K4
   dgrad and wgrad; ``*_bf16``) at the four mini-ImageNet stages (N = 75
   forward, 25 backward, T = 8) against their bf16 twins — K2 equal bit
   for bit (pooled values and argmax), K1 (y, mean, var, rstd), K3 (dy,
   dgamma, dbeta), dgrad and wgrad within one bf16 ulp elementwise (y:
   one of the conv's sum and one of the bias add) or 1e-4 of the output's
   scale — and the kernels second order adds, held the same way: K1
   stats-free (with and without bias) at the four stages and the four
   Omniglot layers, K5 at the same stages and layers on random
   cotangents, wgrad at the four Omniglot layers, and the unpadded model's
   pad-0 convs (``conv3x3_p0_*_bf16``) at its four stages; each timed
   beside the twin and the library calls (grouped ``F.conv2d``,
   ``conv2d_input``, ``conv2d_weight`` and ``F.batch_norm`` given
   statistics, in bf16; the convs' bounds at the bf16 tensor-core rate; K1,
   dgrad and wgrad at stride 1, which run on the tensor cores, also held to
   a second launch bit for bit and printed at the end as ``[K1]`` /
   ``[K4]`` lines with their device time).
   ``serve-bench --compute_dtype bfloat16`` with
   the f32 and index ingests (16 requests, the bf16 launches per
   dispatch), a bucket-8 dispatch on the kernels against the plain block
   in bf16 (its pool's gradient to the first maximum, as the kernels')
   within 2x that block's bf16-vs-f32 spread (preds and loss), the pool
   ties of stage 1 and the accuracy gap to f32, the index dispatch
   bit-identical to f32, a profiled bucket-8 dispatch. Second-order
   ``train-bench --compute_dtype bfloat16`` at batch 2 and 8 of the
   mini-ImageNet config, each beside the f32 run of its batch, at batch 2
   of the unpadded model and at batch 8 of the Omniglot model through the
   device tier (every step's launches the f32 formula on the ``*_bf16``
   names); the 10-step learning check in bf16 and its accuracy gap to
   f32's; a profiled bf16 step (with its copy kernels: the casts); the
   replayed-path meta-gradient gate in bf16 (``--bf16-grad-seeds``) on
   the padded and the unpadded model. The unpadded bf16 model served
   (f32 and index ingests), its serve step against the plain block and
   its index dispatch bit-identical to f32.
10. bf16 strided and norm-first: the stride-2 convs in bf16
   (``conv3x3_s2_*_bf16`` at the strided Omniglot layers, dgrad at cin 1
   too; ``conv3x3_s2_p0_*_bf16`` at the unpadded strided stages, dgrad at
   cin 3 too; K1 and dgrad held twice, bit for bit), the
   pool-free K2/K3/K5 (``bn_act_*_bf16``), the GAP, ``bn_input_stats``,
   ``batch_norm_*`` and the act-pool kernels in bf16 at their paths'
   shapes against their bf16 twins — the pool-free K2, ``batch_norm_fwd``,
   the GAP and the act-pool kernels bit for bit, the rest within one bf16
   ulp or 1e-4 of scale — each timed beside the twin, the f32 kernel at
   the same shape and the bf16 library call; the strided and norm-first
   blocks' first and second derivatives in bf16 against the plain block
   in bf16 and in f64, both replaying the kernels' decisions (the kernels
   within 2x the plain bf16 block's distance to f64). The strided Omniglot
   bf16 model (``--max_pooling false --compute_dtype bfloat16``) and the
   norm-first mini-ImageNet bf16 model each served with the f32 and index
   ingests (16 requests, the bf16 launches per dispatch), their serve step
   against the plain block in bf16, the index dispatch bit-identical to
   f32, ``train-bench`` second order beside the f32 run of its batch
   (strided: batch 8 through the device tier; norm-first: batch 2), the
   learning check and its accuracy gap to f32, a profiled norm-first bf16
   step, the replayed meta-gradient gate (``--strided-bf16-grad-seeds``,
   ``--norm-first-bf16-grad-seeds``; in it the recording block held bit
   for bit to the model's own); 4 requests and 2 train steps each of the
   unpadded strided and the strided norm-first bf16 models.
11. bf16 layer norm: the layer norm's four kernels in bf16
   (``layer_norm_stats/fwd/bwd/bwd_bwd_bf16``) at the conv-first stages
   (84/42/21/10 x 48), the norm-first stage-0 image (84 x 84 x 3) and
   the strided Omniglot 2 x 2 x 64 map against their bf16 twins — the
   forward bit for bit (and twice), the rest within one bf16 ulp or 1e-4
   of scale —
   each timed beside the twin, the f32 kernel at the same shape and the
   bf16 library call; both layer-norm blocks' first and second
   derivatives in bf16 (pooled at stage 1, strided, strided with GAP)
   against the plain block in bf16 and f64, replaying the kernels'
   decisions. The flagship layer-norm bf16 model (``--norm_layer
   layer_norm --compute_dtype bfloat16``) served with the f32 and index
   ingests (16 requests, the bf16 launches per dispatch), its serve step
   against the plain block in bf16, the index dispatch bit-identical to
   f32, ``train-bench`` second order at batch 2 beside f32, the learning
   check and its accuracy gap, a profiled step and the replayed
   meta-gradient gate (``--layer-norm-bf16-grad-seeds``); then 4 requests
   and 2 train steps each of the norm-first, the unpadded and the strided
   Omniglot layer-norm bf16 models. On every bf16 path no f32 kernel may
   move (``episode_expand`` outputs f32 and is the one exception). Every
   kernel must have been launched by some main path.
12. The training entry point: ``cli.main(["train", ...])`` in this
   process at the full width of the mini-ImageNet MAML++ JSON (84x84x3,
   48 filters, 4 stages, 5-way 5-shot, 15 targets, batch 2, second order
   from epoch 0, MSL, LSLR, per-step BN, f32), on a procedural pre-split
   dataset this phase writes with the port's PNG writer under a temp dir
   (``train/val/test``, 64/16/20 classes, 20 images a class, the
   ``datasets/make_mini_imagenet_proxy.py`` pictures; a dataset name of
   its own, so no known-name file count applies), overriding only the
   dataset, experiment and cache paths, ``total_epochs``,
   ``total_iter_per_epoch`` (3) and ``num_evaluation_tasks`` (4). Runs:
   (a) 2 epochs; (b) the same command with ``--total_epochs 3``, which
   must resume from ``latest`` and add exactly one epoch; (c) a fresh
   3-epoch run; (d) one epoch through the device tier
   (``--data_placement device --use_mmap_cache true``: ``episode_expand``
   in every step). Each run's launches, counted from 0 around it, must
   equal its train steps times a step's and its eval dispatches times a
   dispatch's. It fails unless (b) leaves 3 CSV rows, the first two (a)'s
   bytes; every run writes a ``test_summary.csv`` with a finite accuracy
   in [0, 1]; the checkpoints on disk are ``latest`` and the
   ``max_models_to_save`` best epochs; (b)'s third row equals (c)'s bit
   for bit and (d)'s first row (a)'s, on every column but the timings.
   Prints the phase's seconds and each run's train-step p50.
13. Print the rows of K1 and dgrad at stride 2 (``csrc/conv3x3_s2.cu``,
   f32 and bf16, pad 1 and 0: every shape phases 3, 8 and 10 hold them at,
   each held twice bit for bit there) as ``[K1]`` / ``[K4]`` lines with
   their library ratio and bound share; the run's total seconds as a
   ``[total]`` line; one ``{"kernels": [...]}`` line (launches summed over
   all the main paths), then the result line ``{"ok": true, "device":
   {...}}`` last.

Needs one card. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

FLAGSHIP = ("experiment_config/"
            "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")
OMNIGLOT = "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json"
T_TENANTS = 8
COUT = 48
# (label, H = W, cin) of the layers whose shapes the kernels are held at
LAYERS = (("layer1", 84, 3), ("layer2", 42, 48))
# the mini-ImageNet model's stages 2-3, where K1 and K4 also run
# (check_conv_stages)
CONV_STAGES = (("layer3", 21, 48), ("layer4", 10, 48))
IMAGES = (25, 75)  # 5-shot support, 15-target query (5-way)
# the Omniglot 20-way 1-shot model: 64 filters, pooling 28 -> 14 -> 7 -> 3
# -> 1; 20 support and 20 target images per task
OMNIGLOT_LAYERS = (("layer1", 28, 1), ("layer2", 14, 64), ("layer3", 7, 64),
                   ("layer4", 3, 64))
OMNIGLOT_COUT = 64
OMNIGLOT_IMAGES = 20
# the strided Omniglot 20-way 1-shot model (the same config with
# max_pooling=False, the override the JAX command line takes): stride-2
# convs 28 -> 14 -> 7 -> 4 -> 2, no pool, a global average pool into the
# (64, 20) head
STRIDED_LAYERS = (("layer1", 28, 1), ("layer2", 14, 64), ("layer3", 7, 64),
                  ("layer4", 4, 64))
STRIDED_ARGS = ("--max_pooling", "false")
# the norm-first model (the same configs with block_order='norm_conv_relu',
# the override the JAX command line takes): batch norm of each block's
# input (3 channels at stage 0, then 48), conv + bias, leaky-ReLU, pool;
# (label, H = W, channels) of each stage's input
NORM_FIRST_ARGS = ("--block_order", "norm_conv_relu")
NORM_FIRST_STAGES = (("stage0", 84, 3), ("stage1", 42, 48),
                     ("stage2", 21, 48), ("stage3", 10, 48))
# the layer-norm models (the same configs with norm_layer='layer_norm'):
# a layer norm over each image's (H, W, C) in place of the batch norm;
# (label, H = W, C) of each normalized tensor: conv first, the conv
# output (48 channels from stage 0), norm first, the block input (the
# image at stage 0); stages 1-3 are the same shapes in both orders
LAYER_NORM_ARGS = ("--norm_layer", "layer_norm")
LAYER_NORM_STAGES = (("conv-first stage0", 84, 48), ("norm-first stage0", 84, 3),
                     ("stage1", 42, 48), ("stage2", 21, 48),
                     ("stage3", 10, 48))
# the strided layer-norm Omniglot model: the conv outputs 14 -> 2 (64
# channels) conv first, and the 28x28x1 image the norm-first model's first
# block normalizes
LAYER_NORM_STRIDED = (("strided layer1", 14, 64), ("strided layer2", 7, 64),
                      ("strided layer3", 4, 64), ("strided layer4", 2, 64),
                      ("strided norm-first layer1", 28, 1))
# the unpadded models (the mini-ImageNet config with conv_padding=False,
# the override the JAX command line takes): every 3x3 conv a valid window;
# (label, H = W, cin) of each stage's input, pooled (84 -> 82/41 -> 39/19
# -> 17/8 -> 6/3, a (432, 5) head) and strided (84 -> 41 -> 20 -> 9 -> 4,
# the global average pool into a (48, 5) head)
UNPADDED_ARGS = ("--conv_padding", "false")
UNPADDED_STAGES = (("stage0", 84, 3), ("stage1", 41, 48),
                   ("stage2", 19, 48), ("stage3", 8, 48))
UNPADDED_STRIDED_STAGES = (("stage0", 84, 3), ("stage1", 41, 48),
                           ("stage2", 20, 48), ("stage3", 9, 48))
# the unpadded norm-first models' block inputs past the image (stage 0's
# 84 x 84 x 3 is NORM_FIRST_STAGES'): pooled 41/19/8 x 48, strided 20/9 x
# 48 (41 x 41 x 48 both), where bn_input_stats runs at N = 75
UNPADDED_NORM_FIRST = (
    tuple((f"unpadded {s}", hw, c) for s, hw, c in UNPADDED_STAGES[1:])
    + tuple((f"unpadded strided {s}", hw, c)
            for s, hw, c in UNPADDED_STRIDED_STAGES[2:]))
# the MAML (not ++) mini-ImageNet config, unmodified: shared batch-norm
# gamma and beta, no running statistics, no MSL, a fixed inner LR
MAML_JSON = ("experiment_config/"
             "mini-imagenet_maml-mini-imagenet_5_5_2_0.01_48_0.json")
# bf16: the mini-ImageNet config with only compute_dtype overridden, its
# stages (84 -> 42 -> 21 -> 10, the pooled model at pad 1); the unpadded
# bf16 model's are UNPADDED_STAGES, the Omniglot bf16 model's
# OMNIGLOT_LAYERS
BF16_ARGS = ("--compute_dtype", "bfloat16")
BF16_STAGES = (("stage0", 84, 3), ("stage1", 42, 48), ("stage2", 21, 48),
               ("stage3", 10, 48))
# the index ingest's store: the mini-ImageNet test split, 20 x 600 rows
STORE_ROWS = 12000
# episode_expand launches per serve dispatch / train step of each ingest
EXPAND_PER_DISPATCH = {"f32": 0, "uint8": 2, "index": 1}
EXPAND_PER_STEP = {None: 0, "host": 0, "uint8_stream": 2, "device": 1}

# Tolerances, as max |kernel - twin| <= ATOL + RTOL * max |twin|. The
# kernels sum in another order than the twin (f32 FFMA throughout, no
# TF32); a 432-deep f32 dot product and the batch statistics over up to
# 529,200 pixels stay far inside 1e-4 of their scale.
RTOL = 1e-4
ATOL = 1e-5
# serve step vs the plain serve step after 5 inner steps at full width:
# preds atol, loss rtol; accuracy equal where the argmax margin exceeds
# PREDS_ATOL. Wider than the per-kernel tolerances because the adapted
# model is ill-conditioned at this width: the batch-norm backward
# (dz - mean(dz) - xhat * mean(dz * xhat)) cancels, so summation order
# alone moves the inner gradients, and two f32 runs of the SAME plain code
# on the CPU and on the card already differ by ~5e-3 in preds (4.767e-03 at
# mini-ImageNet width on an NVIDIA H100 80GB HBM3; that CPU dispatch takes
# 37 s, so check_against_plain measures the spread at the strided Omniglot
# model's width only).
PREDS_ATOL = 1e-2
LOSS_RTOL = 2e-3
# second-order meta-gradients at full width (check_grads_full_width): per
# leaf and data seed, each f32 run's max |err| against the same step in
# f64, as the median over GRAD_ORDERS orders of the images; the kernels'
# median within GRADS_FACTOR times the larger of the plain ops' medians
# (twopass and fused statistics), plus GRADS_FLOOR times the tree's largest
# entry (for the conv biases, whose true meta-gradient is 0). How
# GRADS_FACTOR was derived is in check_grads_full_width's docstring.
GRAD_ORDERS = 5
GRADS_FACTOR = 4.0
GRADS_FLOOR = 1e-5
# one data seed per model by default: every model's factor is calibrated
# on its seeds 0-9 (the docstrings of check_grads_full_width and
# check_grads_replayed), and three seeds a model no longer fit the run's
# time limit once the bf16 strided and norm-first models joined it
GRAD_SEEDS = (10,)
# the same step's meta-gradients with every max-pool argmax and leaky-ReLU
# sign of the f64 reference replayed from the f32 run it is held to
# (check_grads_replayed): per leaf and data seed, the kernels' median max
# |err| over GRAD_ORDERS image orders within REPLAY_FACTOR times the
# larger of the plain ops' (twopass and fused statistics), plus
# GRADS_FLOOR times the tree's largest entry. How REPLAY_FACTOR was
# derived is in check_grads_replayed's docstring.
REPLAY_FACTOR = 5.0
# the same gate for the bf16 models' meta-gradients (check_grads_replayed on
# a bf16 config: the kernels and the plain ops in bf16, each run's f64
# reference replaying its own decisions); derived by the same rule from the
# bf16 null ratios, see check_grads_replayed's docstring. The norm-first
# bf16 model's own null over its seeds 0-9 gave it a factor of its own,
# the layer-norm bf16 model's kept 10; the factor is keyed on (block
# order, norm layer)
BF16_REPLAY_FACTOR = 10.0
BF16_REPLAY_FACTORS = {
    ("conv_norm_relu", "batch_norm"): BF16_REPLAY_FACTOR,
    ("norm_conv_relu", "batch_norm"): 11.0,
    ("conv_norm_relu", "layer_norm"): BF16_REPLAY_FACTOR,
}

REPLACES = {
    "conv3x3_fwd_stats": "howtotrainyourmamlpytorch_tpu/ops/functional.py:249",
    "bn_act_pool_fwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:325",
    "bn_act_pool_bwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:368",
    "conv3x3_dgrad": "howtotrainyourmamlpytorch_tpu/ops/functional.py:199",
    "conv3x3_wgrad": "howtotrainyourmamlpytorch_tpu/ops/functional.py:199",
    "conv3x3_fwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:199",
    "bn_act_pool_bwd_bwd":
        "howtotrainyourmamlpytorch_tpu/ops/functional.py:368",
    "episode_expand":
        "howtotrainyourmamlpytorch_tpu/ops/device_pipeline.py:209",
    "conv3x3_s2_fwd_stats":
        "howtotrainyourmamlpytorch_tpu/ops/functional.py:249",
    "bn_act_fwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:368",
    "bn_act_bwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:368",
    "conv3x3_s2_dgrad": "howtotrainyourmamlpytorch_tpu/ops/functional.py:199",
    "conv3x3_s2_wgrad": "howtotrainyourmamlpytorch_tpu/ops/functional.py:199",
    "conv3x3_s2_fwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:199",
    "bn_act_bwd_bwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:368",
    "global_avg_pool2d_fwd":
        "howtotrainyourmamlpytorch_tpu/ops/functional.py:357",
    "global_avg_pool2d_bwd":
        "howtotrainyourmamlpytorch_tpu/ops/functional.py:357",
    "bn_input_stats": "howtotrainyourmamlpytorch_tpu/ops/functional.py:368",
    "batch_norm_fwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:368",
    "batch_norm_bwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:368",
    "batch_norm_bwd_bwd":
        "howtotrainyourmamlpytorch_tpu/ops/functional.py:368",
    "act_pool_fwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:325",
    "act_pool_bwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:325",
    "act_pool_gather": "howtotrainyourmamlpytorch_tpu/ops/functional.py:325",
    "act_fwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:363",
    "act_bwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:363",
    "layer_norm_stats": "howtotrainyourmamlpytorch_tpu/ops/functional.py:447",
    "layer_norm_fwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:447",
    "layer_norm_bwd": "howtotrainyourmamlpytorch_tpu/ops/functional.py:447",
    "layer_norm_bwd_bwd":
        "howtotrainyourmamlpytorch_tpu/ops/functional.py:447",
}
# the pad-0 conv kernels replace the same ops at padding=0 (``_im2col`` :85
# with a valid window)
REPLACES.update({
    f"conv3x3{tag}_{k}": REPLACES[f"conv3x3_{k}"]
    for tag in ("_p0", "_s2_p0")
    for k in ("fwd_stats", "dgrad", "wgrad", "fwd")})
# the bf16 kernels replace the same ops at compute_dtype='bfloat16': every
# kernel but episode_expand (which outputs f32)
BF16_KERNELS = tuple(k for k in REPLACES if k != "episode_expand")
REPLACES.update({f"{k}_bf16": REPLACES[k] for k in BF16_KERNELS})
# K1 (both modes) and dgrad at stride 2 in both dtypes: the band kernels of
# conv3x3_s2.cu; wgrad at stride 2 in both dtypes conv3x3_wgrad_s2.cu (the
# band kernel in f32, the tensor-core kernels in bf16)
S2_SOURCE = ("cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                     "conv3x3_s2.cu")
S2_WGRAD_SOURCE = ("cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/"
                           "csrc/conv3x3_wgrad_s2.cu")
SOURCES = {
    "conv3x3_fwd_stats": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "conv3x3_fwd_s1.cu"),
    "bn_act_pool_fwd": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "bn_act_fwd.cu"),
    "bn_act_pool_bwd": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "bn_act_pool_bwd.cu"),
    "conv3x3_dgrad": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "conv3x3_bwd_s1.cu"),
    "conv3x3_wgrad": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "conv3x3_bwd_s1.cu"),
    "conv3x3_fwd": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "conv3x3_fwd_s1.cu"),
    "bn_act_pool_bwd_bwd": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "bn_act_pool_bwd.cu"),
    "episode_expand": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "episode_expand.cu"),
}
# K3 and K5 pool-free (bn_act_bwd, batch_norm_bwd; bn_act_bwd_bwd,
# batch_norm_bwd_bwd) and act_bwd one CUDA launch a call
K3_FREE_SOURCE = ("cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                          "bn_act_bwd.cu")
ACT_SOURCE = ("cuda",
              "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/act.cu")
SOURCES.update({
    "conv3x3_s2_fwd_stats": S2_SOURCE,
    "conv3x3_s2_fwd": S2_SOURCE,
    "conv3x3_s2_dgrad": S2_SOURCE,
    "conv3x3_s2_wgrad": S2_WGRAD_SOURCE,
    "bn_act_fwd": SOURCES["bn_act_pool_fwd"],
    "bn_act_bwd": K3_FREE_SOURCE,
    "bn_act_bwd_bwd": K3_FREE_SOURCE,
    "global_avg_pool2d_fwd": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "global_avg_pool.cu"),
    "global_avg_pool2d_bwd": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "global_avg_pool.cu"),
    "bn_input_stats": (
        "cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                "bn_input_stats.cu"),
    "batch_norm_fwd": SOURCES["bn_act_pool_fwd"],
    "batch_norm_bwd": K3_FREE_SOURCE,
    "batch_norm_bwd_bwd": K3_FREE_SOURCE,
    "act_fwd": ACT_SOURCE,
    "act_bwd": ACT_SOURCE,
})
# the leaky-ReLU + pool forward, backward and gather one CUDA launch a
# call (csrc/act.cu)
SOURCES.update({"act_pool_fwd": ACT_SOURCE, "act_pool_bwd": ACT_SOURCE,
                "act_pool_gather": ACT_SOURCE})
# the layer norm: the statistics, the forward, the backward and the double
# backward one CUDA launch a call (csrc/layer_norm.cu)
SOURCES.update({
    k: ("cuda",
        "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/layer_norm.cu")
    for k in ("layer_norm_stats", "layer_norm_fwd", "layer_norm_bwd",
              "layer_norm_bwd_bwd")})
# the f32 convs at stride 1 (pad 1 and 0) run the band kernels; at stride 2
# K1 and dgrad conv3x3_s2.cu, wgrad conv3x3_wgrad_s2.cu; the bf16 convs the
# tensor-core kernels (below; at stride 2 those same two sources)
SOURCES.update({f"conv3x3_p0_{k}": SOURCES[f"conv3x3_{k}"]
                for k in ("fwd_stats", "dgrad", "wgrad", "fwd")})
SOURCES.update({f"conv3x3_s2_p0_{k}": SOURCES[f"conv3x3_s2_{k}"]
                for k in ("fwd_stats", "dgrad", "wgrad", "fwd")})
# in bf16 as in f32: K3 and K5 pooled csrc/bn_act_pool_bwd.cu, K2
# csrc/bn_act_fwd.cu, the pool-free K3 and K5 csrc/bn_act_bwd.cu, the
# act-pool kernels, act_fwd and act_bwd csrc/act.cu and the layer norm's
# four csrc/layer_norm.cu
SOURCES.update({f"{k}_bf16": SOURCES[k] for k in BF16_KERNELS})
# K1 (both modes) and dgrad in bf16 at stride 1, pad 1 and 0: one
# mma.sync implicit GEMM
MMA_SOURCE = ("cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/csrc/"
                      "conv3x3_s1_bf16.cu")
SOURCES.update({f"conv3x3{tag}_{k}_bf16": MMA_SOURCE
                for tag in ("", "_p0")
                for k in ("fwd_stats", "fwd", "dgrad")})
# K4 wgrad in bf16 at stride 1, pad 1 and 0: an mma.sync reduction over
# staged x and dy bands
WGRAD_MMA_SOURCE = ("cuda", "howtotrainyourmamlpytorch_tpu_torch/kernels/"
                            "csrc/conv3x3_wgrad_s1_bf16.cu")
SOURCES.update({f"conv3x3{tag}_wgrad_bf16": WGRAD_MMA_SOURCE
                for tag in ("", "_p0")})
# the shape each kernel's line reports (a key of its records)
REPORT_AT = {
    "conv3x3_fwd_stats": "T=8 layer1 N=75",
    "bn_act_pool_fwd": "T=8 layer1 N=75",
    "bn_act_pool_bwd": "T=8 layer1 N=25",
    "conv3x3_dgrad": "T=8 layer2 N=25",
    "conv3x3_wgrad": "T=8 layer1 N=25",
    "conv3x3_fwd": "T=8 layer2 N=25",
    "bn_act_pool_bwd_bwd": "T=8 layer1 N=25",
    "episode_expand": "(a) mini-ImageNet serve bucket 8",
    "conv3x3_s2_fwd_stats": "strided T=8 layer2 N=20",
    "bn_act_fwd": "strided T=8 layer1 N=20",
    "bn_act_bwd": "strided T=8 layer1 N=20",
    "conv3x3_s2_dgrad": "strided T=8 layer2 N=20",
    "conv3x3_s2_wgrad": "strided T=8 layer2 N=20",
    "conv3x3_s2_fwd": "strided T=8 layer2 N=20",
    "bn_act_bwd_bwd": "strided T=8 layer1 N=20",
    "global_avg_pool2d_fwd": "strided T=8 layer4 N=20",
    "global_avg_pool2d_bwd": "strided T=8 layer4 N=20",
    "bn_input_stats": "norm-first T=8 stage0 N=75",
    "batch_norm_fwd": "norm-first T=8 stage0 N=75",
    "batch_norm_bwd": "norm-first T=8 stage0 N=25",
    "batch_norm_bwd_bwd": "norm-first T=8 stage0 N=25",
    "act_pool_fwd": "norm-first T=8 stage0 N=75",
    "act_pool_bwd": "norm-first T=8 stage0 N=25",
    "act_pool_gather": "norm-first T=8 stage0 N=25",
    "act_fwd": "strided norm-first T=8 layer1 N=20",
    "act_bwd": "strided norm-first T=8 layer1 N=20",
    "layer_norm_stats": "layer-norm T=8 conv-first stage0 N=75",
    "layer_norm_fwd": "layer-norm T=8 conv-first stage0 N=75",
    "layer_norm_bwd": "layer-norm T=8 conv-first stage0 N=25",
    "layer_norm_bwd_bwd": "layer-norm T=8 conv-first stage0 N=25",
    "conv3x3_p0_fwd_stats": "unpadded T=8 stage0 N=75",
    "conv3x3_p0_fwd": "unpadded T=8 stage1 N=25",
    "conv3x3_p0_dgrad": "unpadded T=8 stage1 N=25",
    "conv3x3_p0_wgrad": "unpadded T=8 stage0 N=25",
    "conv3x3_s2_p0_fwd_stats": "unpadded strided T=8 stage1 N=75",
    "conv3x3_s2_p0_fwd": "unpadded strided T=8 stage1 N=25",
    "conv3x3_s2_p0_dgrad": "unpadded strided T=8 stage1 N=25",
    "conv3x3_s2_p0_wgrad": "unpadded strided T=8 stage1 N=25",
    "conv3x3_fwd_stats_bf16": "bf16 T=8 stage0 N=75",
    "bn_act_pool_fwd_bf16": "bf16 T=8 stage0 N=75",
    "bn_act_pool_bwd_bf16": "bf16 T=8 stage0 N=25",
    "conv3x3_dgrad_bf16": "bf16 T=8 stage1 N=25",
    "conv3x3_wgrad_bf16": "bf16 T=8 stage0 N=25",
    "conv3x3_fwd_bf16": "bf16 T=8 stage1 N=25 bias",
    "bn_act_pool_bwd_bwd_bf16": "bf16 T=8 stage0 N=25",
    "conv3x3_p0_fwd_stats_bf16": "bf16 unpadded T=8 stage0 N=75",
    "conv3x3_p0_fwd_bf16": "bf16 unpadded T=8 stage1 N=25",
    "conv3x3_p0_dgrad_bf16": "bf16 unpadded T=8 stage1 N=25",
    "conv3x3_p0_wgrad_bf16": "bf16 unpadded T=8 stage0 N=25",
    "conv3x3_s2_fwd_stats_bf16": "bf16 strided T=8 layer2 N=20",
    "conv3x3_s2_fwd_bf16": "bf16 strided T=8 layer2 N=20 bias",
    "conv3x3_s2_dgrad_bf16": "bf16 strided T=8 layer2 N=20",
    "conv3x3_s2_wgrad_bf16": "bf16 strided T=8 layer2 N=20",
    "bn_act_fwd_bf16": "bf16 strided T=8 layer1 N=20",
    "bn_act_bwd_bf16": "bf16 strided T=8 layer1 N=20",
    "bn_act_bwd_bwd_bf16": "bf16 strided T=8 layer1 N=20",
    "global_avg_pool2d_fwd_bf16": "bf16 strided T=8 layer4 N=20",
    "global_avg_pool2d_bwd_bf16": "bf16 strided T=8 layer4 N=20",
    "conv3x3_s2_p0_fwd_stats_bf16": "bf16 unpadded strided T=8 stage1 N=75",
    "conv3x3_s2_p0_fwd_bf16": "bf16 unpadded strided T=8 stage1 N=25",
    "conv3x3_s2_p0_dgrad_bf16": "bf16 unpadded strided T=8 stage1 N=25",
    "conv3x3_s2_p0_wgrad_bf16": "bf16 unpadded strided T=8 stage1 N=25",
    "bn_input_stats_bf16": "bf16 norm-first T=8 stage0 N=75",
    "batch_norm_fwd_bf16": "bf16 norm-first T=8 stage0 N=75",
    "batch_norm_bwd_bf16": "bf16 norm-first T=8 stage0 N=25",
    "batch_norm_bwd_bwd_bf16": "bf16 norm-first T=8 stage0 N=25",
    "act_pool_fwd_bf16": "bf16 norm-first T=8 stage0 N=75",
    "act_pool_bwd_bf16": "bf16 norm-first T=8 stage0 N=25",
    "act_pool_gather_bf16": "bf16 norm-first T=8 stage0 N=25",
    "act_fwd_bf16": "bf16 strided norm-first T=8 layer1 N=20",
    "act_bwd_bf16": "bf16 strided norm-first T=8 layer1 N=20",
    "layer_norm_stats_bf16": "bf16 layer-norm T=8 conv-first stage0 N=75",
    "layer_norm_fwd_bf16": "bf16 layer-norm T=8 conv-first stage0 N=75",
    "layer_norm_bwd_bf16": "bf16 layer-norm T=8 conv-first stage0 N=25",
    "layer_norm_bwd_bwd_bf16": "bf16 layer-norm T=8 conv-first stage0 N=25",
}
TRAIN_TASKS = (2, 8)  # the config's batch, and bench.py's per-chip default
DEVICE = "cuda:0"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(name: str, got, want, scaled_atol: bool = False) -> float:
    """max |got - want|, within ATOL + RTOL * max |want|; with
    ``scaled_atol`` the ATOL shrinks with an output below unit scale
    (ATOL * min(1, max |want|)), so it never covers a small output."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    atol = ATOL * min(1.0, scale) if scaled_atol else ATOL
    if err > atol + RTOL * scale:
        raise AssertionError(
            f"{name}: max |kernel - plain| = {err:.3e} exceeds "
            f"{atol:.3g} + {RTOL:g} * {scale:.3e}"
        )
    return err


def _nchw_tenants(a):
    """(T, N, H, W, C) -> (N, T*C, H, W): tenants as conv groups."""
    t, n, h, w, c = a.shape
    return a.permute(1, 0, 4, 2, 3).reshape(n, t * c, h, w).contiguous()


class Records:
    """{kernel: {shape label: record}} of the kernel phase: max error,
    kernel / plain / library ms (CUDA events) and the bound. ``peaks`` is
    the card's (f32 FLOP/s, bytes/s), ``tensor_core_flops`` its dense bf16
    tensor-core rate: the peak for the products of a bf16 conv
    (``add(..., tensor_cores=True)``), whatever units its kernel uses."""

    def __init__(self, kernels, peaks, tensor_core_flops):
        self.by_kernel = {k: {} for k in kernels}
        self.peak_flops, self.peak_bw = peaks
        self.tensor_core_flops = tensor_core_flops

    def add(self, kernel, label, err, kernel_fn, plain_fn, library_fn, flops,
            nbytes, tensor_cores=False, f32_fn=None, device=None):
        """One record; ``f32_fn`` (a bf16 kernel's f32 version at the same
        shape) is timed beside it as ``f32_ms``; with ``device`` (the
        kernels' names, as ``device_ms`` takes them) the device time of
        ``kernel_fn``'s launches, from the profiler, as ``device_ms``."""
        peak = self.tensor_core_flops if tensor_cores else self.peak_flops
        t_ops = flops / peak * 1e3
        t_bytes = nbytes / self.peak_bw * 1e3
        by = "operations" if t_ops > t_bytes else "bytes"
        r = {
            "max_abs_err": err,
            "ms": time_ms(kernel_fn),
            "plain_ms": time_ms(plain_fn),
            "library_ms": (time_ms(library_fn) if library_fn is not None
                           else None),
            "f32_ms": time_ms(f32_fn) if f32_fn is not None else None,
            "device_ms": (device_ms(kernel_fn, device) if device is not None
                          else None),
            "bound_ms": max(t_ops, t_bytes), "bound_by": by,
            "flops": flops, "bytes": nbytes,
        }
        self.by_kernel[kernel][label] = r
        f32 = "" if f32_fn is None else f"  f32 {r['f32_ms']:.4f} ms"
        print(f"  {kernel} @ {label}: err {err:.3e}  kernel "
              f"{r['ms']:.4f} ms{f32}  plain {r['plain_ms']:.4f} ms  library "
              f"{r['library_ms']} ms  bound {r['bound_ms']:.4f} ms ({by})",
              flush=True)


# the f32 stride-1 K1 kernels on the device (csrc/conv3x3_fwd_s1.cu: the
# conv, and with statistics the merge of their partials)
K1_DEVICE = ("conv3x3_fwd_band_kernel", "bn_stats_merge_kernel")
# K3 in f32 and K5 in either dtype, pooled, on the device
# (csrc/bn_act_pool_bwd.cu: one cooperative kernel a call)
K3_DEVICE = "bn_act_pool_bwd_kernel"
K5_DEVICE = "bn_act_pool_bwd_bwd_kernel"
# K2 on the device (csrc/bn_act_fwd.cu): pooled, and pool-free (also
# ``batch_norm_fwd``), in either dtype
K2_DEVICE = "bn_act_pool_fwd_kernel"
K2_FREE_DEVICE = "bn_act_fwd_kernel"
# bn_input_stats and the GAP on the device (csrc/bn_input_stats.cu: one
# kernel a call, a block a tenant or cooperative; csrc/global_avg_pool.cu:
# one kernel each way), in either dtype
STATS_DEVICE = "bn_input_stats_kernel"
GAP_FWD_DEVICE = "global_avg_pool_fwd_kernel"
GAP_BWD_DEVICE = "global_avg_pool_bwd_kernel"
# the pool-free K3 (also ``batch_norm_bwd``) and act_bwd on the device
# (csrc/bn_act_bwd.cu: one kernel a call, a block a tenant or cooperative;
# csrc/act.cu), in either dtype
K3_FREE_DEVICE = "bn_act_bwd_kernel"
ACT_BWD_DEVICE = "act_bwd_kernel"
# the pool-free K5 (also ``batch_norm_bwd_bwd``) and act_pool_gather on the
# device (csrc/bn_act_bwd.cu, csrc/act.cu: one kernel a call), in either
# dtype
K5_FREE_DEVICE = "bn_act_bwd_bwd_kernel"
ACT_POOL_GATHER_DEVICE = "act_pool_gather_kernel"
# act_fwd (csrc/act.cu) and layer_norm_fwd (csrc/layer_norm.cu) on the
# device, in either dtype
ACT_FWD_DEVICE = "act_fwd_kernel"
# act_pool_fwd and act_pool_bwd on the device (csrc/act.cu), in either
# dtype
ACT_POOL_FWD_DEVICE = "act_pool_fwd_kernel"
ACT_POOL_BWD_DEVICE = "act_pool_bwd_kernel"
# the unpadded models' conv outputs, which act_pool_fwd / act_pool_bwd
# take in their norm-first and layer-norm variants (84 -> 82, 41 -> 39,
# 19 -> 17, 8 -> 6; 48 channels)
UNPADDED_ACT_POOL = (("stage0", 82), ("stage1", 39), ("stage2", 17),
                     ("stage3", 6))
LN_FWD_DEVICE = "layer_norm_fwd_kernel"
# the layer norm's double backward on the device (csrc/layer_norm.cu: one
# cooperative kernel a call), in either dtype
LN_BWD_BWD_DEVICE = "layer_norm_bwd_bwd_kernel"
# K1 and dgrad in bf16 at stride 1 on the device (csrc/conv3x3_s1_bf16.cu:
# the conv, and with statistics the merge)
MMA_DEVICE = "conv3x3_s1_mma_kernel"
MMA_STATS_DEVICE = (MMA_DEVICE, "bn_stats_merge_kernel")
# wgrad in bf16 at stride 1 on the device (csrc/conv3x3_wgrad_s1_bf16.cu:
# the products, taps or packed; csrc/wgrad_reduce.cuh: the reduce of the
# split partials)
WGRAD_MMA_DEVICE = ("conv3x3_wgrad_mma", "conv3x3_wgrad_reduce")
# K4 wgrad at stride 2 on the device (csrc/conv3x3_wgrad_s2.cu, both
# dtypes: the band or tensor-core kernel, then the reduce)
S2_WGRAD_DEVICE = ("conv3x3_s2_wgrad", "conv3x3_wgrad_reduce")
# K3 pooled in bf16 on the device (csrc/bn_act_pool_bwd.cu)
K3_BF16_DEVICE = "bn_act_pool_bwd_bf16_kernel"


def _randn(gen):
    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale
    return randn


def check_kernels(cb, F, records, layers=LAYERS, images=IMAGES, C=COUT,
                  prefix=""):
    """Phase 3, the serving kernels K1-K4 at T = 8 (by default at the
    mini-ImageNet model's layers 1-2, N = 25 and 75 images)."""
    rec = records.add
    randn = _randn(torch.Generator(device="cuda").manual_seed(0))
    T = T_TENANTS
    for layer, hw, cin in layers:
        for n in images:
            label = f"{prefix}T={T} {layer} N={n}"
            H = W = hw
            M = n * H * W
            x = randn(T, n, H, W, cin)
            w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin)))
            b = randn(T, C, scale=0.1)
            gamma = 1.0 + randn(T, C, scale=0.1)
            beta = randn(T, C, scale=0.1)
            # K1
            y, mean, var, rstd = cb.conv3x3_fwd_stats(x, w, b)
            y_p, mean_p, var_p, rstd_p = F.conv3x3_fwd_stats(x, w, b)
            err = max(max_err("conv3x3_fwd_stats y", y, y_p),
                      max_err("conv3x3_fwd_stats mean", mean, mean_p),
                      max_err("conv3x3_fwd_stats var", var, var_p),
                      max_err("conv3x3_fwd_stats rstd", rstd, rstd_p))
            _same_bits("conv3x3_fwd_stats",
                       lambda: cb.conv3x3_fwd_stats(x, w, b),
                       (y, mean, var, rstd))
            xl = _nchw_tenants(x)
            wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3)
            wl = wl.contiguous()
            bl = b.reshape(-1).contiguous()
            rec("conv3x3_fwd_stats", label, err,
                lambda: cb.conv3x3_fwd_stats(x, w, b),
                lambda: F.conv3x3_fwd_stats(x, w, b),
                lambda: torch.nn.functional.conv2d(xl, wl, bl, padding=1,
                                                   groups=T),
                2 * T * M * 9 * cin * C + T * M * C,
                4 * (x.numel() + w.numel() + b.numel() + y.numel()
                     + 3 * T * C), device=K1_DEVICE)
            # K2 on K1's outputs
            pooled, pooled_p, arg = _check_k2(cb, F, records, label, y, mean,
                                              rstd, gamma, beta)
            # K3
            dp = randn(*pooled.shape, scale=1.0 / math.sqrt(pooled.numel()))
            dy, dg, dbeta = cb.bn_act_pool_bwd(dp, arg, y, mean, rstd, gamma,
                                               beta)
            dy_p, dg_p, dbeta_p = F.bn_act_pool_bwd(dp, arg, y, mean, rstd,
                                                    gamma, beta)
            err = max(max_err("bn_act_pool_bwd dy", dy, dy_p),
                      max_err("bn_act_pool_bwd dgamma", dg, dg_p),
                      max_err("bn_act_pool_bwd dbeta", dbeta, dbeta_p))
            _same_bits("bn_act_pool_bwd",
                       lambda: cb.bn_act_pool_bwd(dp, arg, y, mean, rstd,
                                                  gamma, beta),
                       (dy, dg, dbeta))
            rec("bn_act_pool_bwd", label, err,
                lambda: cb.bn_act_pool_bwd(dp, arg, y, mean, rstd, gamma,
                                           beta),
                lambda: F.bn_act_pool_bwd(dp, arg, y, mean, rstd, gamma,
                                          beta),
                None, *_k3_cost(y, dp, arg), device=K3_DEVICE)
            # K4: dgrad at layers 2-4 only (layer 1's input is the images)
            _check_k4(cb, F, records, label, x, w, dy, dgrad=cin == C)
            del x, y, y_p, pooled, pooled_p, dy, dy_p, xl
            torch.cuda.empty_cache()


def _check_k2(cb, F, records, label, y, mean, rstd, gamma, beta):
    """K2 against its twin (the argmax equal but for a near-tie in a
    million), a second launch bit for bit the first, timed beside the twin
    with its device time; returns the kernel's and the twin's pooled
    values and the kernel's argmax."""
    T, C = y.shape[0], y.shape[-1]
    pooled, arg = cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    pooled_p, arg_p = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    err = max_err("bn_act_pool_fwd pooled", pooled, pooled_p)
    mismatch = (arg != arg_p).float().mean().item()
    if mismatch > 1e-6:
        raise AssertionError(
            f"bn_act_pool_fwd argmax differs at {mismatch:.2e} of the "
            "pooled elements"
        )
    _same_bits("bn_act_pool_fwd",
               lambda: cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta),
               (pooled, arg))
    records.add("bn_act_pool_fwd", label, err,
                lambda: cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta),
                lambda: F.bn_act_pool_fwd(y, mean, rstd, gamma, beta),
                None,
                6 * y.numel() + 3 * pooled.numel(),
                4 * (y.numel() + 4 * T * C) + 5 * pooled.numel(),
                device=K2_DEVICE)
    return pooled, pooled_p, arg


def _same_bits(name, fn, want):
    """A second launch on the same inputs gives the same bits (no atomics,
    every sum in a fixed order)."""
    got = fn()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ")


def _equal_bits(name, got, want):
    """A kernel whose outputs are its twin's bits, a zero's sign included
    (compared as integers); returns 0.0."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, p in zip(got, want):
        if g.dtype != p.dtype or g.shape != p.shape:
            raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)} "
                                 f"against the twin's {p.dtype} "
                                 f"{tuple(p.shape)}")
        if g.is_floating_point():
            as_int = torch.int16 if g.element_size() == 2 else torch.int32
            g, p = g.view(as_int), p.view(as_int)
        if not torch.equal(g, p):
            raise AssertionError(f"{name}: not bit for bit its twin")
    return 0.0


def _check_act_pool_unpadded(cb, F, randn, dtype, T=T_TENANTS, C=COUT):
    """``act_pool_fwd`` (N = 75) and ``act_pool_bwd`` (N = 25) at the
    unpadded models' conv outputs (82/39/17/6, two of them odd) in
    ``dtype``: each the twin's bits, a second launch the first's."""
    tag = "_bf16" if dtype == torch.bfloat16 else ""
    for stage, hw in UNPADDED_ACT_POOL:
        y = randn(T, max(IMAGES), hw, hw, C).to(dtype)
        got = cb.act_pool_fwd(y)
        _equal_bits("act_pool_fwd" + tag, got, F.act_pool_fwd(y))
        _same_bits("act_pool_fwd" + tag, lambda: cb.act_pool_fwd(y), got)
        y = y[:, :min(IMAGES)].contiguous()
        _, arg = F.act_pool_fwd(y)
        dp = randn(*arg.shape).to(dtype)
        dy = cb.act_pool_bwd(dp, arg, y)
        _equal_bits("act_pool_bwd" + tag, dy, F.act_pool_bwd(dp, arg, y))
        _same_bits("act_pool_bwd" + tag, lambda: cb.act_pool_bwd(dp, arg, y),
                   dy)
        del y, got, arg, dp, dy
        torch.cuda.empty_cache()
    print(f"  act_pool_fwd{tag} / act_pool_bwd{tag} at the unpadded conv "
          f"outputs {'/'.join(str(hw) for _, hw in UNPADDED_ACT_POOL)}: the "
          "twins' bits, a second launch the first's", flush=True)


def _check_k4(cb, F, records, label, x, w, dy, dgrad=True):
    """K4 dgrad (with ``dgrad``) and wgrad at pad 1, stride 1 on (x, w, dy)
    against their twins, a second launch bit for bit the first, each timed
    beside its twin and the library call (``conv2d_input`` /
    ``conv2d_weight``, grouped by tenant)."""
    rec = records.add
    T, N, H, W, cin = x.shape
    C = w.shape[-1]
    M = N * H * W
    xl = _nchw_tenants(x)
    wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3).contiguous()
    dyl = _nchw_tenants(dy)
    if dgrad:
        dx = cb.conv3x3_dgrad(dy, w)
        err = max_err("conv3x3_dgrad", dx, F.conv3x3_dgrad(dy, w))
        _same_bits("conv3x3_dgrad", lambda: cb.conv3x3_dgrad(dy, w), dx)
        rec("conv3x3_dgrad", label, err,
            lambda: cb.conv3x3_dgrad(dy, w),
            lambda: F.conv3x3_dgrad(dy, w),
            lambda: torch.nn.grad.conv2d_input(
                xl.shape, wl, dyl, padding=1, groups=T),
            2 * T * M * 9 * cin * C,
            4 * (dy.numel() + w.numel() + dx.numel()))
    dw, db = cb.conv3x3_wgrad(x, dy)
    dw_p, db_p = F.conv3x3_wgrad(x, dy)
    err = max(max_err("conv3x3_wgrad dw", dw, dw_p),
              max_err("conv3x3_wgrad db", db, db_p))
    _same_bits("conv3x3_wgrad", lambda: cb.conv3x3_wgrad(x, dy), (dw, db))
    rec("conv3x3_wgrad", label, err,
        lambda: cb.conv3x3_wgrad(x, dy),
        lambda: F.conv3x3_wgrad(x, dy),
        lambda: torch.nn.grad.conv2d_weight(
            xl, wl.shape, dyl, padding=1, groups=T),
        2 * T * M * 9 * cin * C + T * M * C,
        4 * (x.numel() + dy.numel() + dw.numel() + db.numel()))


def print_k4_rows(records):
    """K4's f32 rows at every timed shape of the kernel phase: ms, the
    library call's, the bound and the bound's share of the kernel's time."""
    for kernel in ("conv3x3_wgrad", "conv3x3_dgrad", "conv3x3_p0_wgrad",
                   "conv3x3_p0_dgrad"):
        for label, r in records.by_kernel[kernel].items():
            lib = r["library_ms"]
            vs = ("no library call" if lib is None else
                  "library %.4f ms (%.2fx)" % (lib, r["ms"] / lib))
            print(f"[K4] {kernel} @ {label}: {r['ms']:.4f} ms, {vs}, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of the kernel's "
                  "time", flush=True)


def print_k1_rows(records, tag="K1",
                  kernels=("conv3x3_fwd_stats", "conv3x3_fwd",
                           "conv3x3_p0_fwd_stats", "conv3x3_p0_fwd")):
    """The rows of ``kernels`` (by default K1's f32 stride-1 ones, with
    statistics and stats-free, pad 1 and 0) at every timed shape: ms by
    events, the device time of their launches, the library call's ms, the
    bound and its share of the kernel's time, by events and, where
    measured, by device time."""
    for kernel in kernels:
        for label, r in records.by_kernel[kernel].items():
            lib = r["library_ms"]
            vs = ("no library call" if lib is None else
                  "library %.4f ms (%.2fx)" % (lib, r["ms"] / lib))
            dev = r["device_ms"]
            share = (f"{100 * r['bound_ms'] / r['ms']:.1f}% of the kernel's "
                     "time")
            if dev is not None:
                share += (f", {100 * r['bound_ms'] / dev:.1f}% of its device "
                          "time")
            dev = "not measured" if dev is None else "%.4f ms" % dev
            print(f"[{tag}] {kernel} @ {label}: {r['ms']:.4f} ms (device "
                  f"{dev}), {vs}, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), {share}", flush=True)


def check_conv_stages(cb, F, records, stages=CONV_STAGES, images=IMAGES,
                      C=COUT):
    """Phase 3, K1 and K4 at the mini-ImageNet model's stages 2-3 (21 and
    10 pixels, 48 channels; N = 25 and 75, T = 8), the rest of their f32
    main-path shapes: K1 with statistics (N = 25 and 75) and stats-free
    with bias (N = 25) on random x, dgrad and wgrad on a random dy, each
    against its twin, twice (bit for bit), timed beside the twin and the
    library call (grouped ``conv2d``, ``conv2d_input``,
    ``conv2d_weight``)."""
    randn = _randn(torch.Generator(device="cuda").manual_seed(12))
    T = T_TENANTS
    conv2d = torch.nn.functional.conv2d
    for layer, hw, cin in stages:
        for n in images:
            label = f"T={T} {layer} N={n}"
            M = n * hw * hw
            x = randn(T, n, hw, hw, cin)
            w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin)))
            b = randn(T, C, scale=0.1)
            xl = _nchw_tenants(x)
            wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3)
            wl, bl = wl.contiguous(), b.reshape(-1).contiguous()
            flops = 2 * T * M * 9 * cin * C + T * M * C
            nbytes = 4 * (x.numel() + w.numel() + b.numel() + T * M * C)
            got = cb.conv3x3_fwd_stats(x, w, b)
            err = _bn_errs("conv3x3_fwd_stats", got,
                           F.conv3x3_fwd_stats(x, w, b),
                           ("y", "mean", "var", "rstd"), label)
            _same_bits("conv3x3_fwd_stats",
                       lambda: cb.conv3x3_fwd_stats(x, w, b), got)
            records.add("conv3x3_fwd_stats", label, err,
                        lambda: cb.conv3x3_fwd_stats(x, w, b),
                        lambda: F.conv3x3_fwd_stats(x, w, b),
                        lambda: conv2d(xl, wl, bl, padding=1, groups=T),
                        flops, nbytes + 4 * 3 * T * C, device=K1_DEVICE)
            if n == min(images):
                got = cb.conv3x3_fwd(x, w, b)
                err = max(max_err("conv3x3_fwd", got, F.conv3x3(x, w, b)),
                          max_err("conv3x3_fwd (no bias)",
                                  cb.conv3x3_fwd(x, w), F.conv3x3(x, w)))
                _same_bits("conv3x3_fwd", lambda: cb.conv3x3_fwd(x, w, b),
                           got)
                records.add("conv3x3_fwd", label, err,
                            lambda: cb.conv3x3_fwd(x, w, b),
                            lambda: F.conv3x3(x, w, b),
                            lambda: conv2d(xl, wl, bl, padding=1, groups=T),
                            flops, nbytes, device=K1_DEVICE)
            del got, xl
            dy = randn(T, n, hw, hw, C, scale=1.0 / math.sqrt(n * hw * hw))
            _check_k4(cb, F, records, label, x, w, dy)
            del x, dy
            torch.cuda.empty_cache()


def check_train_kernels(cb, F, records, tasks=TRAIN_TASKS, layers=LAYERS,
                        n=25, C=COUT, prefix=""):
    """Phase 3, the kernels only second order launches: K1 stats-free
    (bias as Wgrad's backward passes it) and K5, at the training shapes
    (by default T = 2 and 8 tasks, 5-shot support (N = 25), layers 1 and 2
    of the mini-ImageNet model)."""
    rec = records.add
    randn = _randn(torch.Generator(device="cuda").manual_seed(4))
    for T in tasks:
        for layer, hw, cin in layers:
            label = f"{prefix}T={T} {layer} N={n}"
            H = W = hw
            M = n * H * W
            x = randn(T, n, H, W, cin)
            w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin)))
            b = randn(T, C, scale=0.1)
            y = cb.conv3x3_fwd(x, w, b)
            err = max(max_err("conv3x3_fwd", y, F.conv3x3(x, w, b)),
                      max_err("conv3x3_fwd (no bias)", cb.conv3x3_fwd(x, w),
                              F.conv3x3(x, w)))
            _same_bits("conv3x3_fwd", lambda: cb.conv3x3_fwd(x, w, b), y)
            xl = _nchw_tenants(x)
            wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3)
            wl = wl.contiguous()
            bl = b.reshape(-1).contiguous()
            rec("conv3x3_fwd", label, err,
                lambda: cb.conv3x3_fwd(x, w, b),
                lambda: F.conv3x3(x, w, b),
                lambda: torch.nn.functional.conv2d(xl, wl, bl, padding=1,
                                                   groups=T),
                2 * T * M * 9 * cin * C + T * M * C,
                4 * (x.numel() + w.numel() + b.numel() + y.numel()),
                device=K1_DEVICE)
            # K5 on the statistics, pooling and argmax of that conv output.
            # Every cotangent at unit scale, so that each term of g_dz, G
            # and L_r is of the same order; each output gated on its own
            # scale, its ATOL shrunk with it. Then again with g_gamma =
            # g_beta = 0, which leaves g_dpooled the projection term
            # gamma r P(a) alone.
            gamma = 1.0 + randn(T, C, scale=0.1)
            beta = randn(T, C, scale=0.1)
            y, mean, _, rstd = F.conv3x3_fwd_stats(x, w, b)
            pooled, arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
            a, dp = randn(*y.shape), randn(*pooled.shape)
            args = (a, randn(T, C), randn(T, C), dp, arg, y, mean, rstd,
                    gamma, beta)
            zero = torch.zeros(T, C, device="cuda")
            errs = []
            for case, case_args in (("", args), (" (g_gamma = g_beta = 0)",
                                                 (a, zero, zero) + args[3:])):
                got = cb.bn_act_pool_bwd_bwd(*case_args)
                want = F.bn_act_pool_bwd_bwd(*case_args)
                _same_bits("bn_act_pool_bwd_bwd",
                           lambda: cb.bn_act_pool_bwd_bwd(*case_args), got)
                outs = ("g_dpooled", "g_y", "g_gamma")
                case_errs = [
                    max_err(f"bn_act_pool_bwd_bwd {what}{case}", g, p,
                            scaled_atol=True)
                    for what, g, p in zip(outs, got, want)]
                errs += case_errs
                print(f"  bn_act_pool_bwd_bwd @ {label}{case}: "
                      + ", ".join(
                          f"{what} err {e:.3e} of max |twin| "
                          f"{p.abs().max().item():.3e}"
                          for what, e, p in zip(outs, case_errs, want)),
                      flush=True)
            err = max(errs)
            rec("bn_act_pool_bwd_bwd", label, err,
                lambda: cb.bn_act_pool_bwd_bwd(*args),
                lambda: F.bn_act_pool_bwd_bwd(*args),
                None, *_k5_cost(y, pooled, arg), device=K5_DEVICE)
            del x, y, pooled, arg, args, case_args, got, want, xl, a, dp
            torch.cuda.empty_cache()


def _k3_cost(y, dp, arg):
    """K3's (FLOPs, bytes): it reads dpooled, argmax, y and four (T, C)
    vectors once and writes dy, dgamma and dbeta; ~10 FLOPs an element of
    y, 6 a pooled one."""
    T, C = y.shape[0], y.shape[-1]
    return (10 * y.numel() + 6 * dp.numel(),
            4 * (dp.numel() + 2 * y.numel() + 6 * T * C) + arg.numel())


def _k5_cost(y, pooled, arg):
    """K5's (FLOPs, bytes): it reads a, y, dpooled, argmax and six (T, C)
    vectors once and writes g_y, g_dpooled, g_gamma; ~42 FLOPs per element
    of y over its two passes (normalise, mask, five products and sums; then
    the g_dz, G and g_y formulas)."""
    T, C = y.shape[0], y.shape[-1]
    return (42 * y.numel(),
            4 * (3 * y.numel() + 2 * pooled.numel() + 7 * T * C)
            + arg.numel())


def check_bn_bwd_stages(cb, F, records, tasks=TRAIN_TASKS, n=25, C=COUT):
    """Phase 3, the rest of K3's and K5's f32 main-path shapes: both at the
    mini-ImageNet model's stages 2-3 (21 and 10 pixels) and K3 also at
    stages 0-1 at T = 2 (``check_kernels`` takes T = 8 there), the support
    set (N = 25), on the statistics and argmax of a random y: each against
    its twin, twice (bit for bit), timed beside the twin with its device
    time. K2 at the stages 2-3 too (T = 8, N = 75, the target forward's
    shape, as ``check_kernels`` takes it at stages 0-1)."""
    randn = _randn(torch.Generator(device="cuda").manual_seed(16))
    for layer, hw, _ in CONV_STAGES:
        y = 2.0 * randn(T_TENANTS, max(IMAGES), hw, hw, C) + 0.3
        mean, _, rstd = F.bn_stats(y)
        _check_k2(cb, F, records, f"T={T_TENANTS} {layer} N={max(IMAGES)}",
                  y, mean, rstd, 1.0 + randn(T_TENANTS, C, scale=0.1),
                  randn(T_TENANTS, C, scale=0.1))
        del y
    for T in tasks:
        for layer, hw, _ in LAYERS + CONV_STAGES:
            label = f"T={T} {layer} N={n}"
            y = 2.0 * randn(T, n, hw, hw, C) + 0.3
            mean, _, rstd = F.bn_stats(y)
            gamma, beta = 1.0 + randn(T, C, scale=0.1), randn(T, C, scale=0.1)
            pooled, arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
            dp = randn(*pooled.shape, scale=1.0 / math.sqrt(pooled.numel()))
            k3 = (dp, arg, y, mean, rstd, gamma, beta)
            if label not in records.by_kernel["bn_act_pool_bwd"]:
                got = cb.bn_act_pool_bwd(*k3)
                err = _bn_errs("bn_act_pool_bwd", got, F.bn_act_pool_bwd(*k3),
                               ("dy", "dgamma", "dbeta"), label)
                _same_bits("bn_act_pool_bwd",
                           lambda: cb.bn_act_pool_bwd(*k3), got)
                records.add("bn_act_pool_bwd", label, err,
                            lambda: cb.bn_act_pool_bwd(*k3),
                            lambda: F.bn_act_pool_bwd(*k3), None,
                            *_k3_cost(y, dp, arg), device=K3_DEVICE)
            if label not in records.by_kernel["bn_act_pool_bwd_bwd"]:
                k5 = (randn(*y.shape), randn(T, C), randn(T, C)) + k3
                got = cb.bn_act_pool_bwd_bwd(*k5)
                err = _bn_errs("bn_act_pool_bwd_bwd", got,
                               F.bn_act_pool_bwd_bwd(*k5),
                               ("g_dpooled", "g_y", "g_gamma"), label,
                               scaled_atol=True)
                _same_bits("bn_act_pool_bwd_bwd",
                           lambda: cb.bn_act_pool_bwd_bwd(*k5), got)
                records.add("bn_act_pool_bwd_bwd", label, err,
                            lambda: cb.bn_act_pool_bwd_bwd(*k5),
                            lambda: F.bn_act_pool_bwd_bwd(*k5), None,
                            *_k5_cost(y, pooled, arg), device=K5_DEVICE)
            del y, pooled, arg, dp, k3
            torch.cuda.empty_cache()


def print_device_rows(records, tag, kernels):
    """The rows of ``kernels`` and their ``_bf16`` forms at every timed
    shape of the kernel phases, as ``[tag]`` lines: ms by events, the
    device time of their launches, the library call's ms and ratio where
    one exists, the bound and its share of the kernel's time, by events
    and by device time."""
    for kernel in kernels:
        for name in (kernel, f"{kernel}_bf16"):
            for label, r in records.by_kernel[name].items():
                lib, dev = r["library_ms"], r["device_ms"]
                vs = ("no library call" if lib is None else
                      "library %.4f ms (%.2fx)" % (lib, r["ms"] / lib))
                by_dev = ("" if dev is None else
                          ", %.1f%% by device time"
                          % (100 * r["bound_ms"] / dev))
                dev = "not measured" if dev is None else "%.4f ms" % dev
                print(f"[{tag}] {name} @ {label}: {r['ms']:.4f} ms (device "
                      f"{dev}), {vs}, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}), "
                      f"{100 * r['bound_ms'] / r['ms']:.1f}% of the "
                      f"kernel's time{by_dev}", flush=True)


def print_k35_rows(records):
    """K3's and K5's f32 pooled rows at every timed shape of the kernel
    phase: ms by events, the device time of their launches, the bound and
    the bound's share of the kernel's time."""
    for kernel in ("bn_act_pool_bwd", "bn_act_pool_bwd_bwd"):
        tag = "K3" if kernel == "bn_act_pool_bwd" else "K5"
        for label, r in records.by_kernel[kernel].items():
            dev = r["device_ms"]
            dev = "not measured" if dev is None else "%.4f ms" % dev
            print(f"[{tag}] {kernel} @ {label}: {r['ms']:.4f} ms (device "
                  f"{dev}), plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of the kernel's "
                  "time", flush=True)


def _bn_errs(what, got, want, outs, label, scaled_atol=False):
    """Each output against its twin's; returns the largest error."""
    errs = [max_err(f"{what} {o}", g, p, scaled_atol)
            for o, g, p in zip(outs, got, want)]
    if scaled_atol:
        print(f"  {what} @ {label}: " + ", ".join(
            f"{o} err {e:.3e} of max |twin| {p.abs().max().item():.3e}"
            for o, e, p in zip(outs, errs, want)), flush=True)
    return max(errs)


def check_strided_kernels(cb, F, records, T=T_TENANTS, n=OMNIGLOT_IMAGES,
                          C=OMNIGLOT_COUT):
    """Phase 3, the strided model's kernels at its four layers (T = 8
    tasks, N = 20 images, cout 64): K1 at stride 2 with statistics and
    stats-free, the pool-free K2, K3 and K5 on its output, K4 dgrad
    (layers 2-4) and wgrad at stride 2, and the global average pool's
    forward and backward on layer 4's activation (T, N, 2, 2, 64). Each
    against its twin, timed beside it and beside one PyTorch call where
    one computes the same function (grouped ``conv2d`` / ``conv2d_input``
    / ``conv2d_weight`` at stride 2; ``mean`` over H, W)."""
    rec = records.add
    randn = _randn(torch.Generator(device="cuda").manual_seed(11))
    nn = torch.nn
    for layer, hw, cin in STRIDED_LAYERS:
        label = f"strided T={T} {layer} N={n}"
        H = W = hw
        Ho = Wo = (hw - 1) // 2 + 1
        M = n * Ho * Wo
        x = randn(T, n, H, W, cin)
        w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin)))
        b = randn(T, C, scale=0.1)
        gamma = 1.0 + randn(T, C, scale=0.1)
        beta = randn(T, C, scale=0.1)
        xl = _nchw_tenants(x)
        wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3).contiguous()
        bl = b.reshape(-1).contiguous()
        conv_flops = 2 * T * M * 9 * cin * C
        # K1 at stride 2, with statistics and stats-free
        got = cb.conv3x3_fwd_stats(x, w, b, stride=2)
        want = F.conv3x3_fwd_stats(x, w, b, stride=2)
        y, mean, _, rstd = want
        err = _bn_errs("conv3x3_s2_fwd_stats", got, want,
                       ("y", "mean", "var", "rstd"), label)
        _same_bits("conv3x3_s2_fwd_stats",
                   lambda: cb.conv3x3_fwd_stats(x, w, b, stride=2), got)
        rec("conv3x3_s2_fwd_stats", label, err,
            lambda: cb.conv3x3_fwd_stats(x, w, b, stride=2),
            lambda: F.conv3x3_fwd_stats(x, w, b, stride=2),
            lambda: nn.functional.conv2d(xl, wl, bl, stride=2, padding=1,
                                         groups=T),
            conv_flops + T * M * C,
            4 * (x.numel() + w.numel() + b.numel() + y.numel() + 3 * T * C))
        got = cb.conv3x3_fwd(x, w, None, 2)
        err = max(max_err("conv3x3_s2_fwd", cb.conv3x3_fwd(x, w, b, 2),
                          F.conv3x3(x, w, b, stride=2)),
                  max_err("conv3x3_s2_fwd (no bias)", got,
                          F.conv3x3(x, w, stride=2)))
        _same_bits("conv3x3_s2_fwd", lambda: cb.conv3x3_fwd(x, w, None, 2),
                   got)
        rec("conv3x3_s2_fwd", label, err,
            lambda: cb.conv3x3_fwd(x, w, b, 2),
            lambda: F.conv3x3(x, w, b, stride=2),
            lambda: nn.functional.conv2d(xl, wl, bl, stride=2, padding=1,
                                         groups=T),
            conv_flops, 4 * (x.numel() + w.numel() + b.numel() + y.numel()))
        # the pool-free K2, K3, K5 on K1's output
        bn = (y, mean, rstd, gamma, beta)
        act = cb.bn_act_fwd(*bn)
        err = max_err("bn_act_fwd", act, F.bn_act_fwd(*bn))
        _same_bits("bn_act_fwd", lambda: cb.bn_act_fwd(*bn), act)
        rec("bn_act_fwd", label, err, lambda: cb.bn_act_fwd(*bn),
            lambda: F.bn_act_fwd(*bn), None, 6 * y.numel(),
            4 * (2 * y.numel() + 4 * T * C), device=K2_FREE_DEVICE)
        da = randn(*y.shape, scale=1.0 / math.sqrt(y.numel()))
        got = cb.bn_act_bwd(da, *bn)
        err = _bn_errs("bn_act_bwd", got, F.bn_act_bwd(da, *bn),
                       ("dy", "dgamma", "dbeta"), label)
        _same_bits("bn_act_bwd", lambda: cb.bn_act_bwd(da, *bn), got)
        rec("bn_act_bwd", label, err, lambda: cb.bn_act_bwd(da, *bn),
            lambda: F.bn_act_bwd(da, *bn), None, 16 * y.numel(),
            4 * (3 * y.numel() + 6 * T * C), device=K3_FREE_DEVICE)
        dy = F.bn_act_bwd(da, *bn)[0]
        # K5 with every cotangent at unit scale, then with g_gamma =
        # g_beta = 0 (g_da is then the projection term alone); each output
        # gated on its own scale, its ATOL shrunk with it
        a, db_ = randn(*y.shape), randn(*y.shape)
        args = (a, randn(T, C), randn(T, C), db_, *bn)
        zero = torch.zeros(T, C, device="cuda")
        err = max(
            _bn_errs(f"bn_act_bwd_bwd{case}", cb.bn_act_bwd_bwd(*case_args),
                     F.bn_act_bwd_bwd(*case_args), ("g_da", "g_y",
                                                    "g_gamma"),
                     label, scaled_atol=True)
            for case, case_args in (("", args), (" (g_gamma = g_beta = 0)",
                                                 (a, zero, zero) + args[3:])))
        _same_bits("bn_act_bwd_bwd", lambda: cb.bn_act_bwd_bwd(*args),
                   cb.bn_act_bwd_bwd(*args))
        rec("bn_act_bwd_bwd", label, err, lambda: cb.bn_act_bwd_bwd(*args),
            lambda: F.bn_act_bwd_bwd(*args), None, 42 * y.numel(),
            4 * (5 * y.numel() + 7 * T * C), device=K5_FREE_DEVICE)
        dyl = _nchw_tenants(dy)
        # K4 at stride 2: dgrad at layers 2-4 (layer 1's input is the
        # images); bound: the useful FLOPs, the forward's
        if cin == C:
            got = cb.conv3x3_dgrad(dy, w, 2, (H, W))
            err = max_err("conv3x3_s2_dgrad", got,
                          F.conv3x3_dgrad(dy, w, 2, (H, W)))
            _same_bits("conv3x3_s2_dgrad",
                       lambda: cb.conv3x3_dgrad(dy, w, 2, (H, W)), got)
            rec("conv3x3_s2_dgrad", label, err,
                lambda: cb.conv3x3_dgrad(dy, w, 2, (H, W)),
                lambda: F.conv3x3_dgrad(dy, w, 2, (H, W)),
                lambda: nn.grad.conv2d_input(xl.shape, wl, dyl, stride=2,
                                             padding=1, groups=T),
                conv_flops, 4 * (dy.numel() + w.numel() + x.numel()))
        got = cb.conv3x3_wgrad(x, dy, 2)
        err = _bn_errs("conv3x3_s2_wgrad", got, F.conv3x3_wgrad(x, dy, 2),
                       ("dw", "db"), label)
        _same_bits("conv3x3_s2_wgrad", lambda: cb.conv3x3_wgrad(x, dy, 2),
                   got)
        rec("conv3x3_s2_wgrad", label, err,
            lambda: cb.conv3x3_wgrad(x, dy, 2),
            lambda: F.conv3x3_wgrad(x, dy, 2),
            lambda: nn.grad.conv2d_weight(xl, wl.shape, dyl, stride=2,
                                          padding=1, groups=T),
            conv_flops + T * M * C,
            4 * (x.numel() + dy.numel() + w.numel() + T * C),
            device=S2_WGRAD_DEVICE)
        if layer == STRIDED_LAYERS[-1][0]:
            _check_gap(cb, F, records, randn, label, F.bn_act_fwd(*bn))
        del x, y, dy, a, db_, args, xl, dyl
        torch.cuda.empty_cache()


def _check_gap(cb, F, records, randn, label, act):
    """The GAP's forward and backward in f32 on ``act`` (T, N, h, w, C)
    against their twins, each held twice bit for bit, timed beside the
    twin and the library call (``mean``, ``_gap_bwd_library``), with the
    device time of their launches: launch-bound, the event times include
    the wrapper's host time."""
    T, n, h, w, C = act.shape
    got = cb.global_avg_pool2d_fwd(act)
    err = max_err("global_avg_pool2d_fwd", got, F.global_avg_pool2d(act))
    _same_bits("global_avg_pool2d_fwd",
               lambda: cb.global_avg_pool2d_fwd(act), got)
    records.add("global_avg_pool2d_fwd", label, err,
                lambda: cb.global_avg_pool2d_fwd(act),
                lambda: F.global_avg_pool2d(act),
                lambda: act.mean(dim=(-3, -2)), act.numel(),
                4 * (act.numel() + T * n * C), device=GAP_FWD_DEVICE)
    g = randn(T, n, C)
    got = cb.global_avg_pool2d_bwd(g, h, w)
    err = max_err("global_avg_pool2d_bwd", got,
                  F.global_avg_pool2d_bwd(g, h, w))
    _same_bits("global_avg_pool2d_bwd",
               lambda: cb.global_avg_pool2d_bwd(g, h, w), got)
    records.add("global_avg_pool2d_bwd", label, err,
                lambda: cb.global_avg_pool2d_bwd(g, h, w),
                lambda: F.global_avg_pool2d_bwd(g, h, w),
                _gap_bwd_library(g, act), act.numel(),
                4 * (act.numel() + g.numel()), device=GAP_BWD_DEVICE)


def _check_stats(cb, F, records, label, x, bf16=False):
    """``bn_input_stats`` on x against its twin (f32 within the gate, bf16
    within one bf16 ulp), held twice bit for bit, timed beside the twin,
    ``torch.var_mean`` and (bf16) the f32 kernel, with the device time of
    its launches."""
    got = cb.bn_input_stats(x)
    want = F.bn_input_stats(x)
    if bf16:
        err = max(within_ulp(f"bn_input_stats_bf16 {what}", a, c)
                  for what, a, c in zip(("mean", "var", "rstd"), got, want))
        x32 = x.float()
    else:
        err = _bn_errs("bn_input_stats", got, want, ("mean", "var", "rstd"),
                       label)
    name = "bn_input_stats_bf16" if bf16 else "bn_input_stats"
    _same_bits(name, lambda: cb.bn_input_stats(x), got)
    T, C = x.shape[0], x.shape[-1]
    records.add(name, label, err, lambda: cb.bn_input_stats(x),
                lambda: F.bn_input_stats(x),
                lambda: torch.var_mean(x, dim=(1, 2, 3), correction=0),
                4 * x.numel(), x.element_size() * (x.numel() + 3 * T * C),
                f32_fn=(lambda: cb.bn_input_stats(x32)) if bf16 else None,
                device=STATS_DEVICE)


def check_norm_first_kernels(cb, F, records, T=T_TENANTS):
    """Phase 3, the norm-first block's kernels at the mini-ImageNet model's
    four stages (T = 8 tasks; the forward kernels at N = 75 images, the
    backward ones at N = 25): ``bn_input_stats`` and ``batch_norm_fwd`` on
    the block input (pixels in [0, 1] at stage 0, 3 channels), K1
    stats-free with bias on the normalized input (the new shape: cin 3 at
    84x84), ``act_pool_fwd`` on the conv output (48 channels);
    ``batch_norm_bwd`` / ``batch_norm_bwd_bwd`` (K3/K5 at slope 1),
    ``act_pool_bwd`` / ``act_pool_gather`` and dgrad back to the input
    (cin 3 at stage 0). Each against its twin, timed beside it and beside
    one PyTorch call where one computes the same function:
    ``torch.var_mean`` for the statistics, ``F.batch_norm`` with the given
    statistics for the normalize, ``aten.native_batch_norm_backward``
    (train) for its backward, grouped ``conv2d`` / ``conv2d_input``; none
    for the act-pool kernels and the double backward. Then
    ``F.batch_norm(training=True)`` beside the two forward kernels
    together. Last, ``bn_input_stats`` at the unpadded norm-first models'
    block inputs (``UNPADDED_NORM_FIRST``, N = 75) and the act-pool
    kernels at the unpadded conv outputs. ``act_pool_fwd`` and
    ``act_pool_bwd`` must be their twins' bits and a second launch the
    first's."""
    rec = records.add
    randn = _randn(torch.Generator(device="cuda").manual_seed(21))
    nnf = torch.nn.functional
    C = COUT
    for stage, hw, cin in NORM_FIRST_STAGES:
        for n in IMAGES:
            label = f"norm-first T={T} {stage} N={n}"
            H = W = hw
            M = n * H * W
            x = (torch.rand(T, n, H, W, cin, device="cuda") if cin == 3
                 else randn(T, n, H, W, cin))
            gamma = 1.0 + randn(T, cin, scale=0.1)
            beta = randn(T, cin, scale=0.1)
            mean, var, rstd = F.bn_input_stats(x)
            bn = (x, mean, rstd, gamma, beta)
            w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin)))
            b = randn(T, C, scale=0.1)
            y = F.conv3x3(F.batch_norm_fwd(*bn), w, b)
            xl = _nchw_tenants(x)
            if n == max(IMAGES):
                # the forward: support and target, the target's N here
                _check_stats(cb, F, records, label, x)
                z = cb.batch_norm_fwd(*bn)
                err = max_err("batch_norm_fwd", z, F.batch_norm_fwd(*bn))
                _same_bits("batch_norm_fwd", lambda: cb.batch_norm_fwd(*bn),
                           z)
                args = (mean.reshape(-1), var.reshape(-1),
                        gamma.reshape(-1), beta.reshape(-1))
                rec("batch_norm_fwd", label, err,
                    lambda: cb.batch_norm_fwd(*bn),
                    lambda: F.batch_norm_fwd(*bn),
                    lambda: nnf.batch_norm(xl, *args, training=False,
                                           eps=F.BN_EPS),
                    4 * x.numel(), 4 * (2 * x.numel() + 4 * T * cin),
                    device=K2_FREE_DEVICE)
                both = time_ms(lambda: cb.batch_norm_fwd(
                    x, *cb.bn_input_stats(x)[::2], gamma, beta))
                lib = time_ms(lambda: nnf.batch_norm(
                    xl, None, None, args[2], args[3], training=True,
                    eps=F.BN_EPS))
                print(f"  B5b forward @ {label}: bn_input_stats + "
                      f"batch_norm_fwd {both:.4f} ms, F.batch_norm("
                      f"training=True) {lib:.4f} ms", flush=True)
                if cin == 3:
                    z = F.batch_norm_fwd(*bn)
                    wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3)
                    wl, zl = wl.contiguous(), _nchw_tenants(z)
                    got = cb.conv3x3_fwd(z, w, b)
                    err = max_err("conv3x3_fwd", got, y)
                    _same_bits("conv3x3_fwd", lambda: cb.conv3x3_fwd(z, w, b),
                               got)
                    rec("conv3x3_fwd", label, err,
                        lambda: cb.conv3x3_fwd(z, w, b),
                        lambda: F.conv3x3(z, w, b),
                        lambda: nnf.conv2d(zl, wl, b.reshape(-1), padding=1,
                                           groups=T),
                        2 * T * M * 9 * cin * C + T * M * C,
                        4 * (z.numel() + w.numel() + b.numel() + y.numel()),
                        device=K1_DEVICE)
                    del got
                    del z, zl
                pooled, arg = cb.act_pool_fwd(y)
                err = _equal_bits("act_pool_fwd", (pooled, arg),
                                  F.act_pool_fwd(y))
                _same_bits("act_pool_fwd", lambda: cb.act_pool_fwd(y),
                           (pooled, arg))
                rec("act_pool_fwd", label, err, lambda: cb.act_pool_fwd(y),
                    lambda: F.act_pool_fwd(y), None,
                    3 * y.numel(),
                    4 * (y.numel() + pooled.numel()) + arg.numel(),
                    device=ACT_POOL_FWD_DEVICE)
                del pooled, arg
            else:
                # the backward, on the support (N = 25)
                dz = randn(*x.shape, scale=1.0 / math.sqrt(x.numel()))
                got = cb.batch_norm_bwd(dz, *bn)
                err = _bn_errs("batch_norm_bwd", got,
                               F.batch_norm_bwd(dz, *bn),
                               ("dx", "dgamma", "dbeta"), label)
                _same_bits("batch_norm_bwd",
                           lambda: cb.batch_norm_bwd(dz, *bn), got)
                del got
                dzl = _nchw_tenants(dz)
                saved = (gamma.reshape(-1), None, None, mean.reshape(-1),
                         rstd.reshape(-1), True, F.BN_EPS, [True] * 3)
                rec("batch_norm_bwd", label, err,
                    lambda: cb.batch_norm_bwd(dz, *bn),
                    lambda: F.batch_norm_bwd(dz, *bn),
                    lambda: torch.ops.aten.native_batch_norm_backward(
                        dzl, xl, *saved),
                    16 * x.numel(), 4 * (3 * x.numel() + 6 * T * cin),
                    device=K3_FREE_DEVICE)
                a = randn(*x.shape)
                args = (a, randn(T, cin), randn(T, cin), randn(*x.shape),
                        *bn)
                zero = torch.zeros(T, cin, device="cuda")
                err = max(
                    _bn_errs(f"batch_norm_bwd_bwd{case}",
                             cb.batch_norm_bwd_bwd(*case_args),
                             F.batch_norm_bwd_bwd(*case_args),
                             ("g_dz", "g_x", "g_gamma"), label,
                             scaled_atol=True)
                    for case, case_args in (
                        ("", args),
                        (" (g_gamma = g_beta = 0)", (a, zero, zero)
                         + args[3:])))
                _same_bits("batch_norm_bwd_bwd",
                           lambda: cb.batch_norm_bwd_bwd(*args),
                           cb.batch_norm_bwd_bwd(*args))
                rec("batch_norm_bwd_bwd", label, err,
                    lambda: cb.batch_norm_bwd_bwd(*args),
                    lambda: F.batch_norm_bwd_bwd(*args), None,
                    42 * x.numel(), 4 * (5 * x.numel() + 7 * T * cin),
                    device=K5_FREE_DEVICE)
                _, arg = F.act_pool_fwd(y)
                P = arg.numel()
                dp = randn(*arg.shape, scale=1.0 / math.sqrt(P))
                dy = cb.act_pool_bwd(dp, arg, y)
                err = _equal_bits("act_pool_bwd", dy,
                                  F.act_pool_bwd(dp, arg, y))
                _same_bits("act_pool_bwd",
                           lambda: cb.act_pool_bwd(dp, arg, y), dy)
                # reads dpooled, the argmax and y at it; writes dy densely
                rec("act_pool_bwd", label, err,
                    lambda: cb.act_pool_bwd(dp, arg, y),
                    lambda: F.act_pool_bwd(dp, arg, y), None,
                    2 * P, 4 * (2 * P + y.numel()) + P,
                    device=ACT_POOL_BWD_DEVICE)
                g_dy = randn(*y.shape)
                got = cb.act_pool_gather(g_dy, arg, y)
                err = _equal_bits("act_pool_gather", got,
                                  F.act_pool_gather(g_dy, arg, y))
                _same_bits("act_pool_gather",
                           lambda: cb.act_pool_gather(g_dy, arg, y), got)
                del got
                # reads the argmax and g_dy and y at it; writes the pooled
                # quarter
                rec("act_pool_gather", label, err,
                    lambda: cb.act_pool_gather(g_dy, arg, y),
                    lambda: F.act_pool_gather(g_dy, arg, y), None,
                    2 * P, 4 * 3 * P + P, device=ACT_POOL_GATHER_DEVICE)
                if cin == 3:
                    # dgrad back to the normalized image: 3 of dgrad's 16
                    # channel lanes live
                    wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3)
                    wl, dyl = wl.contiguous(), _nchw_tenants(dy)
                    err = max_err("conv3x3_dgrad", cb.conv3x3_dgrad(dy, w),
                                  F.conv3x3_dgrad(dy, w))
                    rec("conv3x3_dgrad", label, err,
                        lambda: cb.conv3x3_dgrad(dy, w),
                        lambda: F.conv3x3_dgrad(dy, w),
                        lambda: torch.nn.grad.conv2d_input(
                            xl.shape, wl, dyl, padding=1, groups=T),
                        2 * T * M * 9 * cin * C,
                        4 * (dy.numel() + w.numel() + x.numel()))
                    del dyl
                del dz, dzl, a, args, dp, dy, g_dy, arg
            del x, xl, y, bn
            torch.cuda.empty_cache()
    # the statistics at the unpadded norm-first models' block inputs
    n = max(IMAGES)
    for stage, hw, cin in UNPADDED_NORM_FIRST:
        _check_stats(cb, F, records, f"norm-first T={T} {stage} N={n}",
                     randn(T, n, hw, hw, cin))
        torch.cuda.empty_cache()
    _check_act_pool_unpadded(cb, F, randn, torch.float32, T)


def check_strided_norm_first_kernels(cb, F, records, T=T_TENANTS,
                                     n=OMNIGLOT_IMAGES, C=OMNIGLOT_COUT):
    """Phase 3, what the strided norm-first model (Omniglot, stride 2, no
    pool) adds: ``act_fwd`` / ``act_bwd`` (the pool-free leaky-ReLU and its
    backward, flat elementwise passes, beside ``leaky_relu`` and
    ``aten.leaky_relu_backward``) on the conv output of each of its
    four layers (14x14, 7x7, 4x4, 2x2, 64 channels), the statistics of
    each layer's input (the image, C = 1, at layer 1; 14x14, 7x7, 4x4 x 64
    after), and at layer 1 the stride-2 dgrad back to the image (cin 1)."""
    rec = records.add
    randn = _randn(torch.Generator(device="cuda").manual_seed(23))
    for layer, hw, cin in STRIDED_LAYERS:
        label = f"strided norm-first T={T} {layer} N={n}"
        Ho = Wo = (hw - 1) // 2 + 1
        y = randn(T, n, Ho, Wo, C)
        da = randn(*y.shape)
        got = cb.act_fwd(y)
        err = _equal("act_fwd", got, F.act_fwd(y))
        _same_bits("act_fwd", lambda: cb.act_fwd(y), got)
        rec("act_fwd", label, err, lambda: cb.act_fwd(y),
            lambda: F.act_fwd(y),
            lambda: torch.nn.functional.leaky_relu(y, F.LEAKY_SLOPE),
            2 * y.numel(), 8 * y.numel(), device=ACT_FWD_DEVICE)
        got = cb.act_bwd(da, y)
        err = _equal("act_bwd", got, F.act_bwd(da, y))
        _same_bits("act_bwd", lambda: cb.act_bwd(da, y), got)
        rec("act_bwd", label, err, lambda: cb.act_bwd(da, y),
            lambda: F.act_bwd(da, y),
            lambda: torch.ops.aten.leaky_relu_backward(da, y, F.LEAKY_SLOPE,
                                                       False),
            2 * y.numel(), 12 * y.numel(), device=ACT_BWD_DEVICE)
        x = (torch.rand(T, n, hw, hw, cin, device="cuda") if cin == 1
             else randn(T, n, hw, hw, cin))
        _check_stats(cb, F, records, label, x)
        if cin == 1:
            w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin)))
            wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3)
            wl, dyl = wl.contiguous(), _nchw_tenants(da)
            got = cb.conv3x3_dgrad(da, w, 2, (hw, hw))
            err = max_err("conv3x3_s2_dgrad", got,
                          F.conv3x3_dgrad(da, w, 2, (hw, hw)))
            _same_bits("conv3x3_s2_dgrad",
                       lambda: cb.conv3x3_dgrad(da, w, 2, (hw, hw)), got)
            rec("conv3x3_s2_dgrad", label, err,
                lambda: cb.conv3x3_dgrad(da, w, 2, (hw, hw)),
                lambda: F.conv3x3_dgrad(da, w, 2, (hw, hw)),
                lambda: torch.nn.grad.conv2d_input(
                    (n, T * cin, hw, hw), wl, dyl, stride=2, padding=1,
                    groups=T),
                2 * T * n * Ho * Wo * 9 * cin * C,
                4 * (da.numel() + w.numel() + x.numel()))
        torch.cuda.empty_cache()


# (N, H = W, C) of every tensor the pool-free K3 takes on a main path: the
# strided Omniglot conv outputs and the unpadded strided mini-ImageNet
# ones (``bn_act_bwd``), every norm-first block input (``batch_norm_bwd``:
# the image at N = 25 and 75, pooled 42/21/10, unpadded 41/19/8, the
# strided model's 28 x 28 x 1 image and 14/7/4 x 64, unpadded strided
# 20/9); ``act_bwd`` at the strided norm-first conv outputs
K3_FREE_CONV_OUTPUTS = ((20, 14, 64), (20, 7, 64), (20, 4, 64), (20, 2, 64),
                        (25, 41, 48), (25, 20, 48), (25, 9, 48), (25, 4, 48))
K3_FREE_BLOCK_INPUTS = ((25, 84, 3), (75, 84, 3), (25, 42, 48),
                        (25, 21, 48), (25, 10, 48), (25, 41, 48),
                        (25, 19, 48), (25, 8, 48), (20, 28, 1),
                        (20, 14, 64), (20, 7, 64), (20, 4, 64),
                        (25, 20, 48), (25, 9, 48))
ACT_BWD_OUTPUTS = ((20, 14, 64), (20, 7, 64), (20, 4, 64), (20, 2, 64))
# (N, H = W, C) of every tensor the layer-norm models normalize: the
# mini-ImageNet conv-first outputs and norm-first image (support 25,
# targets 75), the unpadded conv outputs, the strided Omniglot conv
# outputs and its norm-first 28 x 28 x 1 image (20)
LN_FWD_SHAPES = tuple((n, hw, c) for n in (25, 75) for _, hw, c in
                      LAYER_NORM_STAGES) \
    + tuple((n, hw, 48) for n in (25, 75) for hw in (82, 39, 17, 6)) \
    + tuple((OMNIGLOT_IMAGES, hw, c) for _, hw, c in LAYER_NORM_STRIDED)


def check_k3_free_shapes(cb, F, tasks=TRAIN_TASKS):
    """Phase 3, the pool-free K3 (csrc/bn_act_bwd.cu), ``act_fwd`` and
    ``act_bwd`` (csrc/act.cu) and ``layer_norm_fwd`` (csrc/layer_norm.cu)
    at every model shape they take (``K3_FREE_*``, ``ACT_BWD_OUTPUTS``,
    ``LN_FWD_SHAPES``) at T = 2 and 8, in f32 and bf16: ``bn_act_bwd``
    and ``batch_norm_bwd`` against their twins (f32 within 1e-5 + 1e-4 *
    scale, bf16 within one bf16 ulp or 1e-4 of scale), ``act_fwd``,
    ``act_bwd`` and ``layer_norm_fwd`` bit for bit, each held twice, bit
    for bit; not timed (the kernel phases time their rows)."""
    randn = _randn(torch.Generator(device="cuda").manual_seed(37))
    cases = ([("bn_act_bwd", s) for s in K3_FREE_CONV_OUTPUTS]
             + [("batch_norm_bwd", s) for s in K3_FREE_BLOCK_INPUTS]
             + [(k, s) for k in ("act_fwd", "act_bwd")
                for s in ACT_BWD_OUTPUTS]
             + [("layer_norm_fwd", s) for s in LN_FWD_SHAPES])
    held = 0
    for T in tasks:
        for dtype in (torch.float32, torch.bfloat16):
            tag = "_bf16" if dtype == torch.bfloat16 else ""
            for name, (n, hw, c) in cases:
                label = f"{name}{tag} T={T} {hw}x{hw}x{c} N={n}"
                x = (torch.rand(T, n, hw, hw, c, device="cuda") if c <= 3
                     else 0.5 + 2.0 * randn(T, n, hw, hw, c)).to(dtype)
                da = randn(*x.shape).to(dtype)
                if name == "act_fwd":
                    got = cb.act_fwd(x)
                    _equal(label, got, F.act_fwd(x))
                    _same_bits(label, lambda: cb.act_fwd(x), got)
                elif name == "act_bwd":
                    got = cb.act_bwd(da, x)
                    _equal(label, got, F.act_bwd(da, x))
                    _same_bits(label, lambda: cb.act_bwd(da, x), got)
                elif name == "layer_norm_fwd":
                    mean, _, rstd = F.layer_norm_stats(x)
                    gamma = (1.0 + randn(T, hw, hw, c, scale=0.1)).to(dtype)
                    ln = (x, mean, rstd, gamma, da[:, 0].contiguous())
                    got = cb.layer_norm_fwd(*ln)
                    _equal(label, got, F.layer_norm_fwd(*ln))
                    _same_bits(label, lambda: cb.layer_norm_fwd(*ln), got)
                    del ln
                else:
                    mean, _, rstd = F.bn_input_stats(x)
                    gamma = (1.0 + randn(T, c, scale=0.1)).to(dtype)
                    beta = randn(T, c, scale=0.1).to(dtype)
                    bn = (x, mean, rstd, gamma, beta)
                    fn = getattr(cb, name)
                    got = fn(da, *bn)
                    want = getattr(F, name)(da, *bn)
                    for what, a, p in zip(("dy", "dgamma", "dbeta"), got,
                                          want):
                        if tag:
                            within_ulp(f"{label} {what}", a, p)
                        else:
                            max_err(f"{label} {what}", a, p)
                    _same_bits(label, lambda: fn(da, *bn), got)
                held += 1
                del x, da, got
            torch.cuda.empty_cache()
    print(f"  the pool-free K3, act_fwd, act_bwd and layer_norm_fwd: {held} "
          "shapes x dtypes held to their twins and twice bit for bit",
          flush=True)


def check_layer_norm_kernels(cb, F, records, T=T_TENANTS):
    """Phase 3, the layer norm's kernels (B5c) on every tensor the
    layer-norm models normalize: at the mini-ImageNet stages of both orders
    (``LAYER_NORM_STAGES``; the statistics and the forward at N = 75, the
    backward and double backward at N = 25) and at the strided Omniglot
    layers (``LAYER_NORM_STRIDED``, N = 20, all four). T = 8; gamma and
    beta shared ``(H, W, C)`` (the frozen gamma and the meta-trained beta
    of serving), given to the kernels as the blocks give them, expanded to
    ``(T, H, W, C)``. Each against its twin, timed beside it and beside one
    PyTorch call where one computes the same function:
    ``torch.var_mean`` for the statistics, ``F.layer_norm`` for the
    forward (statistics and normalize in one call), and
    ``aten.native_layer_norm_backward`` for the backward; none for the
    double backward."""
    rec = records.add
    randn = _randn(torch.Generator(device="cuda").manual_seed(31))
    nnf = torch.nn.functional
    cases = [(f"layer-norm T={T} {label} N={n}", hw, c, n)
             for label, hw, c in LAYER_NORM_STAGES for n in IMAGES]
    cases += [(f"layer-norm T={T} {label} N={OMNIGLOT_IMAGES}", hw, c,
               OMNIGLOT_IMAGES) for label, hw, c in LAYER_NORM_STRIDED]
    for label, hw, c, n in cases:
        shape = (hw, hw, c)
        x = (torch.rand(T, n, *shape, device="cuda") if c <= 3
             else randn(T, n, *shape))
        gamma_s = 1.0 + randn(*shape, scale=0.1)
        beta_s = randn(*shape, scale=0.1)
        gamma = gamma_s.expand(T, *shape).contiguous()
        beta = beta_s.expand(T, *shape).contiguous()
        mean, var, rstd = F.layer_norm_stats(x)
        numel, tm, rows = x.numel(), gamma.numel(), T * n
        forward = n != min(IMAGES)
        if forward:
            stats = cb.layer_norm_stats(x)
            err = _bn_errs("layer_norm_stats", stats, (mean, var, rstd),
                           ("mean", "var", "rstd"), label)
            _same_bits("layer_norm_stats", lambda: cb.layer_norm_stats(x),
                       stats)
            del stats
            rec("layer_norm_stats", label, err,
                lambda: cb.layer_norm_stats(x),
                lambda: F.layer_norm_stats(x),
                lambda: torch.var_mean(x, dim=(2, 3, 4), correction=0),
                4 * numel, 4 * (numel + 3 * rows))
            ln = (x, mean, rstd, gamma, beta)
            z = cb.layer_norm_fwd(*ln)
            err = _equal("layer_norm_fwd", z, F.layer_norm_fwd(*ln))
            _same_bits("layer_norm_fwd", lambda: cb.layer_norm_fwd(*ln), z)
            del z
            rec("layer_norm_fwd", label, err,
                lambda: cb.layer_norm_fwd(*ln),
                lambda: F.layer_norm_fwd(*ln),
                lambda: nnf.layer_norm(x, shape, gamma_s, beta_s, F.LN_EPS),
                4 * numel, 4 * (2 * numel + 2 * tm + 2 * rows),
                device=LN_FWD_DEVICE)
            del ln
        if not forward or n == OMNIGLOT_IMAGES:
            dz = randn(*x.shape, scale=1.0 / math.sqrt(numel))
            ln = (x, mean, rstd, gamma)
            grads = cb.layer_norm_bwd(dz, *ln)
            err = _bn_errs("layer_norm_bwd", grads,
                           F.layer_norm_bwd(dz, *ln),
                           ("dx", "dgamma", "dbeta"), label)
            _same_bits("layer_norm_bwd", lambda: cb.layer_norm_bwd(dz, *ln),
                       grads)
            del grads
            saved = (mean.reshape(T, n, 1, 1, 1), rstd.reshape(T, n, 1, 1, 1),
                     gamma_s, beta_s, [True] * 3)
            rec("layer_norm_bwd", label, err,
                lambda: cb.layer_norm_bwd(dz, *ln),
                lambda: F.layer_norm_bwd(dz, *ln),
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dz, x, list(shape), *saved),
                12 * numel, 4 * (3 * numel + 3 * tm + 2 * rows))
            a = randn(*x.shape)
            args = (a, randn(T, *shape), randn(T, *shape), randn(*x.shape),
                    *ln)
            zero = torch.zeros(T, *shape, device="cuda")
            errs = []
            for case, case_args in (
                    ("", args),
                    (" (g_gamma = g_beta = 0)", (a, zero, zero) + args[3:])):
                got = cb.layer_norm_bwd_bwd(*case_args)
                errs.append(_bn_errs(f"layer_norm_bwd_bwd{case}", got,
                                     F.layer_norm_bwd_bwd(*case_args),
                                     ("g_dz", "g_x", "g_gamma"), label,
                                     scaled_atol=True))
                _same_bits("layer_norm_bwd_bwd",
                           lambda: cb.layer_norm_bwd_bwd(*case_args), got)
                del got
            rec("layer_norm_bwd_bwd", label, max(errs),
                lambda: cb.layer_norm_bwd_bwd(*args),
                lambda: F.layer_norm_bwd_bwd(*args), None,
                40 * numel, 4 * (5 * numel + 4 * tm + 2 * rows),
                device=LN_BWD_BWD_DEVICE)
            del dz, ln, a, args, zero
        del x, mean, var, rstd
        torch.cuda.empty_cache()


def check_unpadded_kernels(cb, F, records, T=T_TENANTS, C=COUT):
    """Phase 3, the conv kernels at pad 0 (the unpadded models,
    ``conv_padding=False``) at the mini-ImageNet unpadded models' four
    stages, pooled (stride 1: 84 -> 82, 41 -> 39, 19 -> 17, 8 -> 6) and
    strided (84 -> 41, 41 -> 20, 20 -> 9, 9 -> 4; the last row of an even
    input is read by no output), T = 8: K1 with statistics at N = 75 (the
    targets); K1 stats-free (with and without bias), dgrad and wgrad at N
    = 25 (the support); dgrad at stage 0 too, back to cin 3 (the
    norm-first models'); each conv held twice, bit for bit. Each against
    its twin, timed beside it and beside
    grouped ``conv2d`` / ``conv2d_input`` / ``conv2d_weight`` at
    ``padding=0``. On the pooled stages' odd conv outputs (39 -> 19, 17 ->
    8), K2 and K3 are held to their twins as well (the pool drops the last
    row and column)."""
    rec = records.add
    randn = _randn(torch.Generator(device="cuda").manual_seed(41))
    nn = torch.nn
    for strided, stages in ((False, UNPADDED_STAGES),
                            (True, UNPADDED_STRIDED_STAGES)):
        s = 2 if strided else 1
        kw = dict(stride=s, padding=0)
        for stage, hw, cin in stages:
            for n in IMAGES:
                label = (f"unpadded{' strided' if strided else ''} T={T} "
                         f"{stage} N={n}")
                Ho, Wo = F.conv_out_hw(hw, hw, s, 0)
                M = n * Ho * Wo
                x = randn(T, n, hw, hw, cin)
                w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin)))
                b = randn(T, C, scale=0.1)
                xl = _nchw_tenants(x)
                wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3)
                wl, bl = wl.contiguous(), b.reshape(-1).contiguous()
                conv_flops = 2 * T * M * 9 * cin * C
                y_bytes = 4 * T * M * C
                if n == max(IMAGES):
                    name = cb._conv_name("conv3x3_fwd_stats", s, 0)
                    want = F.conv3x3_fwd_stats(x, w, b, **kw)
                    got = cb.conv3x3_fwd_stats(x, w, b, **kw)
                    err = _bn_errs(name, got, want,
                                   ("y", "mean", "var", "rstd"), label)
                    _same_bits(name, lambda: cb.conv3x3_fwd_stats(
                        x, w, b, **kw), got)
                    rec(name, label, err,
                        lambda: cb.conv3x3_fwd_stats(x, w, b, **kw),
                        lambda: F.conv3x3_fwd_stats(x, w, b, **kw),
                        lambda: nn.functional.conv2d(xl, wl, bl, stride=s,
                                                     padding=0, groups=T),
                        conv_flops + T * M * C,
                        4 * (x.numel() + w.numel() + b.numel() + 3 * T * C)
                        + y_bytes, device=None if strided else K1_DEVICE)
                    if strided and stage == stages[-1][0]:
                        # the unpadded strided model's GAP: 4 x 4 x 48
                        y, mean, _, rstd = want
                        ones = torch.ones(T, C, device="cuda")
                        _check_gap(cb, F, records, randn, label,
                                   F.bn_act_fwd(y, mean, rstd, ones,
                                                0 * ones))
                        del y
                    del want, got
                else:
                    name = cb._conv_name("conv3x3_fwd", s, 0)
                    got = cb.conv3x3_fwd(x, w, b, s, 0)
                    err = max(max_err(name, got, F.conv3x3(x, w, b, **kw)),
                              max_err(f"{name} (no bias)",
                                      cb.conv3x3_fwd(x, w, None, s, 0),
                                      F.conv3x3(x, w, **kw)))
                    _same_bits(name, lambda: cb.conv3x3_fwd(
                        x, w, b, s, 0), got)
                    del got
                    rec(name, label, err,
                        lambda: cb.conv3x3_fwd(x, w, b, s, 0),
                        lambda: F.conv3x3(x, w, b, **kw),
                        lambda: nn.functional.conv2d(xl, wl, bl, stride=s,
                                                     padding=0, groups=T),
                        conv_flops,
                        4 * (x.numel() + w.numel() + b.numel()) + y_bytes,
                        device=None if strided else K1_DEVICE)
                    if not strided and Ho % 2:
                        _check_odd_map_bn_kernels(cb, F, randn, x, w, b,
                                                  label)
                    dy = randn(T, n, Ho, Wo, C, scale=1.0 / math.sqrt(M * T))
                    dyl = _nchw_tenants(dy)
                    name = cb._conv_name("conv3x3_dgrad", s, 0)
                    dx = cb.conv3x3_dgrad(dy, w, s, (hw, hw), 0)
                    err = max_err(name, dx, F.conv3x3_dgrad(
                        dy, w, s, (hw, hw), 0))
                    if strided and hw % 2 == 0 and (
                            dx[:, :, -1].any() or dx[:, :, :, -1].any()):
                        raise AssertionError(f"{name}: the unread last "
                                             "row has a gradient")
                    _same_bits(name, lambda: cb.conv3x3_dgrad(
                        dy, w, s, (hw, hw), 0), dx)
                    rec(name, label, err,
                        lambda: cb.conv3x3_dgrad(dy, w, s, (hw, hw), 0),
                        lambda: F.conv3x3_dgrad(dy, w, s, (hw, hw), 0),
                        lambda: nn.grad.conv2d_input(
                            xl.shape, wl, dyl, stride=s, padding=0,
                            groups=T),
                        conv_flops,
                        4 * (dy.numel() + w.numel() + x.numel()))
                    del dx
                    name = cb._conv_name("conv3x3_wgrad", s, 0)
                    got = cb.conv3x3_wgrad(x, dy, s, 0)
                    err = _bn_errs(name, got, F.conv3x3_wgrad(x, dy, **kw),
                                   ("dw", "db"), label)
                    _same_bits(name, lambda: cb.conv3x3_wgrad(x, dy, s, 0),
                               got)
                    del got
                    rec(name, label, err,
                        lambda: cb.conv3x3_wgrad(x, dy, s, 0),
                        lambda: F.conv3x3_wgrad(x, dy, **kw),
                        lambda: nn.grad.conv2d_weight(
                            xl, wl.shape, dyl, stride=s, padding=0,
                            groups=T),
                        conv_flops + T * M * C,
                        4 * (x.numel() + dy.numel() + w.numel() + T * C),
                        device=S2_WGRAD_DEVICE if strided else None)
                    del dy, dyl
                del x, xl
                torch.cuda.empty_cache()


def _check_odd_map_bn_kernels(cb, F, randn, x, w, b, label):
    """K2, K3 and K5 on an odd pad-0 conv output (39 -> 19, 17 -> 8: the
    pool drops the last row and column, which K3 and K5 still give a
    gradient through the batch statistics), each against its twin."""
    T, C = w.shape[0], w.shape[-1]
    y, mean, _, rstd = F.conv3x3_fwd_stats(x, w, b, padding=0)
    bn = (y, mean, rstd, 1.0 + randn(T, C, scale=0.1), randn(T, C, scale=0.1))
    pooled, arg = cb.bn_act_pool_fwd(*bn)
    pooled_p, arg_p = F.bn_act_pool_fwd(*bn)
    errs = [max_err("bn_act_pool_fwd (odd map)", pooled, pooled_p)]
    if not torch.equal(arg, arg_p):
        raise AssertionError("bn_act_pool_fwd argmax differs on an odd map")
    _same_bits("bn_act_pool_fwd (odd map)",
               lambda: cb.bn_act_pool_fwd(*bn), (pooled, arg))
    dp = randn(*pooled.shape)
    got = cb.bn_act_pool_bwd(dp, arg, *bn)
    errs.append(_bn_errs("bn_act_pool_bwd (odd map)", got,
                         F.bn_act_pool_bwd(dp, arg, *bn),
                         ("dy", "dgamma", "dbeta"), label))
    _same_bits("bn_act_pool_bwd (odd map)",
               lambda: cb.bn_act_pool_bwd(dp, arg, *bn), got)
    args = (randn(*y.shape), randn(T, C), randn(T, C), dp, arg, *bn)
    got = cb.bn_act_pool_bwd_bwd(*args)
    errs.append(_bn_errs("bn_act_pool_bwd_bwd (odd map)", got,
                         F.bn_act_pool_bwd_bwd(*args),
                         ("g_dpooled", "g_y", "g_gamma"), label,
                         scaled_atol=True))
    _same_bits("bn_act_pool_bwd_bwd (odd map)",
               lambda: cb.bn_act_pool_bwd_bwd(*args), got)
    print(f"  K2, K3, K5 on the {y.shape[2]}x{y.shape[3]} conv output @ "
          f"{label}: max err {max(errs):.3e}", flush=True)


def _block_decisions_apart(cb, F, x_shape, kw, seed):
    """On ``_block_inputs(seed, x_shape)``: how many max-pool argmaxes and
    leaky-ReLU signs the conv-first batch-norm block on the kernels and
    the plain block take differently, each on its own values, and how
    many pool windows of the plain block hold an exact tie at their
    maximum (the normalize can round two conv outputs to one value; the
    plain max pool then splits the gradient among them, where the kernels
    give it all to the first: the documented divergence of ROADMAP Queue
    C). Where either count is not 0, a derivative check of the two blocks
    on their own decisions compares two piecewise-linear functions on
    different pieces."""
    _, inputs = _block_inputs(seed, x_shape, x_shape[-1])
    logs, ties = ([], []), []
    with torch.no_grad():
        _recording_kernel_block(cb, logs[0])(*inputs, **kw)
        _plain_block(F, logs[1], ties=ties)(*inputs, **kw)
    return sum((0 if a is None else int((a != a_p).sum()))
               + int((p != p_p).sum())
               for (a, p), (a_p, p_p) in zip(*logs)), sum(ties)


def _unpadded_block_cases():
    """The unpadded blocks' derivative checks: stage 1 (41 -> 39, pooled)
    and strided stage 1 (41 -> 20, pool-free) and stage 3 (9 -> 4) with
    the global average pool, 8 tasks, 5-shot support."""
    x1 = (T_TENANTS, 25, 41, 41, COUT)
    x3 = (T_TENANTS, 25, 9, 9, COUT)
    kw = dict(stride=2, pool=False, padding=0)
    return (("unpadded stage 1", x1, dict(padding=0)),
            ("unpadded strided stage 1", x1, kw),
            ("unpadded strided stage 3 + GAP", x3, {**kw, "gap": True}))


def _expand_inputs(cfg, rows_shape, store_rows, gen, rotate=False):
    """A store of ``store_rows`` random bytes, ``rows_shape`` int32 rows in
    it, and (when rotating) rot90 draws with all four k present, on the
    card."""
    h, w, c = cfg.im_shape
    store = torch.randint(0, 256, (store_rows, h, w, c), dtype=torch.uint8,
                          device="cuda", generator=gen)
    rows = torch.randint(0, store_rows, rows_shape, dtype=torch.int32,
                         device="cuda", generator=gen)
    rot = None
    if rotate:
        g = math.prod(rows_shape[:-1])
        order = torch.randperm(g, device="cuda", generator=gen)
        rot = (order % 4).to(torch.int32).reshape(rows_shape[:-1])
    return store, rows, rot


def _print_device_ms(label, fn):
    ms = device_ms(fn, "episode_expand")
    print(f"  episode_expand @ {label}: device time "
          f"{'not measured' if ms is None else f'{ms:.4f} ms'} per launch "
          "(profiler; the event time above includes the wrapper's host "
          "time)", flush=True)


def _expand_exact(what, got, want):
    """The kernel is a pure lookup: it must equal its twin bit for bit."""
    for g, p in zip(got, want):
        if g.shape != p.shape or not torch.isfinite(g).all():
            raise AssertionError(f"episode_expand {what}: shape "
                                 f"{tuple(g.shape)} vs {tuple(p.shape)} or "
                                 "non-finite output")
    err = max((g - p).abs().max().item() if g.numel() else 0.0
              for g, p in zip(got, want))
    if err != 0.0 or not all(torch.equal(g, p) for g, p in zip(got, want)):
        raise AssertionError(f"episode_expand {what}: max |kernel - twin| "
                             f"= {err:.3e}, expected exact equality")
    return err


def device_ms(fn, kernel, reps=10):
    """Device time of ``kernel`` (a substring of its name, or a tuple of
    them: kernels ``fn`` launches once a call each) per call of ``fn``,
    from ``torch.profiler`` over ``reps`` calls after a profiled warmup of
    as many, each kernel's time over the launches the profile recorded
    (late in the run a profile records only some of them): the kernels'
    own time, without the host time a launch costs."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    active = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: active.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    names = (kernel,) if isinstance(kernel, str) else kernel
    per_call = sum(e.device_time_total / e.count
                   for e in (active[0] if active else [])
                   if e.count and any(k in e.key for k in names))
    return per_call / 1e3 if per_call else None


def check_episode_expand(ee, dp, records, mini, omniglot):
    """Phase 3, the ingest kernel (B6) against its twin, exact equality, at
    the main paths' shapes: (b) the Omniglot device-tier train batch (8
    tasks x 20 classes x 2 images, all four k), (a) a mini-ImageNet serve
    bucket of 8 from the 12,000-row store (with and without
    ``reverse_channels``), (c) the uint8 decode of a mini-ImageNet train
    batch of 2 (200 images). Then rows outside the store (negative, past
    its end) against the twin's rule (wrap once, clamp). Bound: bytes,
    each uint8 pixel read once and each f32 written once, plus the rows,
    the k and the table."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = (
        ("(b) Omniglot train T=8 n=20 S=2 rot", omniglot, (8, 20, 2), 23000,
         True, False),
        ("(a) mini-ImageNet serve bucket 8", mini, (8, 5, 20), STORE_ROWS,
         False, False),
        ("(a) mini-ImageNet serve bucket 8 reverse_channels", mini,
         (8, 5, 20), STORE_ROWS, False, True),
    )
    for label, cfg, shape, n, rotate, reverse in cases:
        store, rows, rot = _expand_inputs(cfg, shape, n, gen, rotate)
        lut = torch.from_numpy(dp.decode_lut(cfg)).cuda()
        spc = cfg.num_samples_per_class
        got = ee.gather_decode(store, rows, rot, lut, spc, reverse)
        want = dp.expand_plain(store, rows, rot, lut, spc, reverse)
        err = _expand_exact(label, got, want)
        pixels = rows.numel() * math.prod(cfg.im_shape)
        records.add(
            "episode_expand", label, err,
            lambda: ee.gather_decode(store, rows, rot, lut, spc, reverse),
            lambda: dp.expand_plain(store, rows, rot, lut, spc, reverse),
            None, 0,
            5 * pixels + 4 * rows.numel() + lut.numel() * 4
            + (4 * rot.numel() if rot is not None else 0))
        _print_device_ms(label, lambda: ee.gather_decode(
            store, rows, rot, lut, spc, reverse))
        del store
    label = "(c) mini-ImageNet train batch 2 decode"
    pixels = torch.randint(0, 256, (2, 5, 20) + mini.im_shape,
                           dtype=torch.uint8, device="cuda", generator=gen)
    lut = torch.from_numpy(dp.decode_lut(mini)).cuda()
    err = _expand_exact(label, (ee.decode(pixels, lut),),
                        (dp.decode_plain(pixels, lut),))
    records.add("episode_expand", label, err,
                lambda: ee.decode(pixels, lut),
                lambda: dp.decode_plain(pixels, lut), None, 0,
                5 * pixels.numel() + lut.numel() * 4)
    _print_device_ms(label, lambda: ee.decode(pixels, lut))
    store, _, _ = _expand_inputs(omniglot, (1, 1), 50, gen)
    rows = torch.tensor([[[-1, -50, -51, -400, 0], [49, 50, 51, 4000, 7]]],
                        dtype=torch.int32, device="cuda")
    rot = torch.tensor([[0, 3]], dtype=torch.int32, device="cuda")
    lut = torch.from_numpy(dp.decode_lut(omniglot)).cuda()
    _expand_exact("rows outside the store",
                  ee.gather_decode(store, rows, rot, lut, 2),
                  dp.expand_plain(store, rows, rot, lut, 2))
    print("  episode_expand, rows outside the store: equal to the twin's "
          "rule (wrap once, then clamp)", flush=True)
    torch.cuda.empty_cache()


def _block_errs(what, got, want, names):
    """max |kernel - plain| of each of the block's derivatives, each on
    its own scale, except the conv bias ("b"): its derivatives through
    batch norm are 0, so its computed value is pure round-off, held to the
    tolerance of the largest entry of them all."""
    scale = max(v.abs().max().item() for v in want)
    errs = []
    for n, g, p in zip(names, got, want):
        if n != "b":
            errs.append(max_err(f"{what} {n}", g, p))
            continue
        err = (g - p).abs().max().item()
        if err > ATOL + RTOL * scale:
            raise AssertionError(
                f"{what} b: max |kernel - plain| = {err:.3e} exceeds "
                f"{ATOL:g} + {RTOL:g} * {scale:.3e} (the largest entry)")
        errs.append(err)
    print(f"  {what} vs plain autograd: max err "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
          + f" (largest entry {scale:.3e})", flush=True)


def _block_inputs(seed, x_shape=(T_TENANTS, 25, 42, 42, COUT), cout=COUT,
                  norm_shape=None):
    """Block inputs, by default at layer 2 of the main path's support
    shape (8 tasks, 5-shot support): x, w, b, gamma, beta, and the
    generator. The checks take cout = cin, so gamma and beta fit either
    block order (the conv output's channels, or the input's); a layer
    norm's are a shared ``norm_shape`` gamma and a per-tenant beta (an
    adapted one's shape)."""
    randn = _randn(torch.Generator(device="cuda").manual_seed(seed))
    T, cin = x_shape[0], x_shape[-1]
    return randn, [
        randn(*x_shape),
        randn(T, 3, 3, cin, cout, scale=math.sqrt(2.0 / (9 * cin))),
        randn(T, cout, scale=0.1),
        1.0 + randn(*(norm_shape or (cout,)), scale=0.1),
        (randn(T, *norm_shape, scale=0.1) if norm_shape
         else randn(cout, scale=0.1)),
    ]


def _norm_shape(block, x_shape, kw):
    """The (H, W, C) a layer-norm block normalizes (its block input, or
    the conv output at the stride and pad in ``kw``; cout = cin here),
    None for a batch-norm block."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    if block.norm_layer != "layer_norm":
        return None
    _, _, h, w, c = x_shape
    if block.block_order == "norm_conv_relu":
        return (h, w, c)
    return (*F.conv_out_hw(h, w, kw.get("stride", 1), kw.get("padding", 1)),
            c)


def _strided_block_cases():
    """The strided model's block checks: layer 2 (14 -> 7, pool-free) and
    layer 4 (4 -> 2) with the global average pool, 8 tasks, 20 images."""
    x2 = (T_TENANTS, OMNIGLOT_IMAGES, 14, 14, OMNIGLOT_COUT)
    x4 = (T_TENANTS, OMNIGLOT_IMAGES, 4, 4, OMNIGLOT_COUT)
    kw = dict(stride=2, pool=False)
    return (("strided layer 2", x2, kw),
            ("strided layer 4 + GAP", x4, {**kw, "gap": True}))


def _replayed_blocks(cb, F, norm_first=True, layer_norm=False):
    """The block on the kernels (by default the norm-first batch-norm
    block), recording its pool argmaxes and leaky-ReLU signs, then the
    plain block replaying them. The normalize before the conv rounds
    differently in the two (Chan-merged statistics against two passes,
    another order of operations), so the conv outputs differ by ~1e-6 of
    their scale and at full width a few near-tie decisions of the millions
    of windows and signs flip, each moving a gradient by O(1); replayed,
    what is left is the kernels' rounding. A layer norm after the conv
    flips decisions too: its gamma and beta vary over (h, w), so it is not
    monotone within a pool window, and its rounding moves the values the
    pool compares."""
    log = []
    return (_recording_kernel_block(cb, log, norm_first, layer_norm),
            _plain_block(F, log, replay=True, norm_first=norm_first,
                         layer_norm=layer_norm))


def _replayed_pair(cfg, cb, F):
    """``_replayed_blocks`` of ``cfg``'s block order and norm layer."""
    return _replayed_blocks(cb, F, cfg.block_order == "norm_conv_relu",
                            cfg.norm_layer == "layer_norm")


def check_block_autograd(blocks, x_shape=(T_TENANTS, 25, 42, 42, COUT),
                         kw=None, what="block"):
    """The first derivative of ``blocks[0]`` on the kernels (K3, K4; with
    ``kw`` the strided block's modes; the norm-first block's kernels for
    its pair) against autograd of the plain block ``blocks[1]``, by default
    at layer-2 shapes, against a unit-scale random cotangent."""
    kw = kw or {}
    randn, inputs = _block_inputs(1, x_shape, x_shape[-1],
                                  _norm_shape(blocks[0], x_shape, kw))
    ct, grads = None, []
    for fn in blocks:
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        out, _, _ = fn(*leaves, **kw)
        if ct is None:
            ct = randn(*out.shape)
        grads.append(torch.autograd.grad((out * ct).sum(), leaves))
    _block_errs(f"{what} first derivative", *grads,
                ("x", "w", "b", "gamma", "beta"))


def check_block_double_backward(blocks,
                                x_shape=(T_TENANTS, 25, 42, 42, COUT),
                                kw=None, what="block"):
    """The block's second derivative on the card: a scalar function of the
    block's first gradients (each against a unit-scale random cotangent),
    differentiated again, on the kernels (``blocks[0]``: K3's backward K5,
    the conv closure on K1 stats-free and K4; with ``kw`` the strided
    block's modes; the norm-first block's K5 at slope 1 and the act-pool
    gather; the layer-norm blocks' ``layer_norm_bwd_bwd``) against
    autograd of the plain block ``blocks[1]``, by default at layer-2
    shapes (8 tasks, 5-shot support). In x, w, b and gamma; for the
    norm-first blocks x, w, gamma and beta (its conv bias enters only
    through piecewise-constant masks: its second derivative is 0; so does
    beta's after the norm, conv first)."""
    kw = kw or {}
    norm_first = blocks[0].block_order == "norm_conv_relu"
    randn, inputs = _block_inputs(5, x_shape, x_shape[-1],
                                  _norm_shape(blocks[0], x_shape, kw))
    names = ("x", "w", "gamma", "beta") if norm_first else (
        "x", "w", "b", "gamma")
    wrt = [("x", "w", "b", "gamma", "beta").index(n) for n in names]
    ct, results = None, []
    for fn in blocks:
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        out, _, _ = fn(*leaves, **kw)
        if ct is None:
            ct = randn(*out.shape)
            cts = [randn(*leaves[i].shape) for i in wrt]
        first = torch.autograd.grad((out * ct).sum(),
                                    [leaves[i] for i in wrt],
                                    create_graph=True)
        scalar = sum((g * c).sum() for g, c in zip(first, cts))
        results.append(torch.autograd.grad(scalar,
                                           [leaves[i] for i in wrt]))
    _block_errs(f"{what} second derivative", *results, names)


# conv role -> the conv kernel at stride 1 and pad 1 (``_by_kernel``
# names it at the model's stride and pad with ``conv_block._conv_name``)
CONV_ROLES = {"fwd_stats": "conv3x3_fwd_stats", "dgrad": "conv3x3_dgrad",
              "wgrad": "conv3x3_wgrad", "fwd": "conv3x3_fwd"}
# every other role -> (the max-pooling model's kernel, the strided model's)
ROLE_KERNELS = {
    "act_fwd": ("bn_act_pool_fwd", "bn_act_fwd"),
    "act_bwd": ("bn_act_pool_bwd", "bn_act_bwd"),
    "act_bwd_bwd": ("bn_act_pool_bwd_bwd", "bn_act_bwd_bwd"),
    # the norm-first block: the standalone batch norm (K2/K3/K5 at slope
    # 1) and the standalone leaky-ReLU + pool (B2), pool-free when strided
    "in_stats": ("bn_input_stats", "bn_input_stats"),
    "bn_fwd": ("batch_norm_fwd", "batch_norm_fwd"),
    "bn_bwd": ("batch_norm_bwd", "batch_norm_bwd"),
    "bn_bwd_bwd": ("batch_norm_bwd_bwd", "batch_norm_bwd_bwd"),
    "pool_fwd": ("act_pool_fwd", "act_fwd"),
    "pool_bwd": ("act_pool_bwd", "act_bwd"),
    "pool_gather": ("act_pool_gather", "act_bwd"),
    # the layer norm (B5c), pooled or not
    "ln_stats": ("layer_norm_stats", "layer_norm_stats"),
    "ln_fwd": ("layer_norm_fwd", "layer_norm_fwd"),
    "ln_bwd": ("layer_norm_bwd", "layer_norm_bwd"),
    "ln_bwd_bwd": ("layer_norm_bwd_bwd", "layer_norm_bwd_bwd"),
}
GAP_KERNELS = ("global_avg_pool2d_fwd", "global_avg_pool2d_bwd")
# a layer norm in place of the batch norm (norm_layer='layer_norm'): each
# batch-norm role of a block order becomes the roles that take its place.
# Conv first, K1 with statistics is K1 stats-free + the layer norm's
# statistics, K2 the layer norm + act_pool_fwd, K3 act_pool_bwd + the
# layer norm's backward, K5 the gather + its double backward: the same
# graph with each fused node split in two. Norm first, the standalone
# batch norm's kernels become the layer norm's one for one.
LAYER_NORM_ROLES = {
    "conv_norm_relu": {"fwd_stats": ("fwd", "ln_stats"),
                       "act_fwd": ("ln_fwd", "pool_fwd"),
                       "act_bwd": ("pool_bwd", "ln_bwd"),
                       "act_bwd_bwd": ("pool_gather", "ln_bwd_bwd")},
    "norm_conv_relu": {"in_stats": ("ln_stats",), "bn_fwd": ("ln_fwd",),
                       "bn_bwd": ("ln_bwd",), "bn_bwd_bwd": ("ln_bwd_bwd",)},
}


def _by_kernel(cfg, per_role, gap_fwd, gap_bwd):
    """Launches per kernel name of the block kernels, from launches per
    role of the batch-norm model of ``cfg``'s block order (mapped through
    ``LAYER_NORM_ROLES`` for a layer norm): the max-pooling model's
    kernels, or the strided model's (``conv3x3_s2_*``, the pool-free
    ``bn_act_*`` / ``act_*``) with its global average pool, the conv
    kernels at the model's pad (``conv3x3_p0_*`` / ``conv3x3_s2_p0_*``
    unpadded), each on its ``_bf16`` counter in bf16; every other kernel
    0. Pool-free, the pool's gather is ``act_bwd`` again (its own
    adjoint), so roles add up."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb

    strided = not cfg.max_pooling
    stride, pad = (2 if strided else 1), (1 if cfg.conv_padding else 0)
    tag = "_bf16" if cfg.compute_dtype == "bfloat16" else ""
    out = {name: 0 for name in cb.KERNELS}
    swap = (LAYER_NORM_ROLES[cfg.block_order]
            if cfg.norm_layer == "layer_norm" else {})
    for role, n in per_role.items():
        for r in swap.get(role, (role,)):
            name = (cb._conv_name(CONV_ROLES[r], stride, pad)
                    if r in CONV_ROLES else ROLE_KERNELS[r][strided])
            if n:
                out[name + tag] += n
    out[GAP_KERNELS[0] + tag] = gap_fwd if strided else 0
    out[GAP_KERNELS[1] + tag] = gap_bwd if strided else 0
    return out


def expected_launches(cfg):
    """Block-kernel launches of one serve dispatch (first order, the eval
    steps S, B blocks), either model, either block order. The strided
    model adds the global average pool: forward once per support and
    target forward, backward once per support backward.

    The norm-first block (``block_order='norm_conv_relu'``) runs per
    forward ``bn_input_stats``, ``batch_norm_fwd``, K1 stats-free with bias
    and ``act_pool_fwd``; the support backward runs ``act_pool_bwd`` and
    wgrad at every block, and dgrad and ``batch_norm_bwd`` at every block
    but the first (serving adapts no norm parameter, so nothing needs the
    gradient of the normalized images)."""
    s, b = cfg.number_of_evaluation_steps_per_iter, cfg.num_stages
    if cfg.block_order == "norm_conv_relu":
        return _by_kernel(cfg, {
            "in_stats": 2 * s * b, "bn_fwd": 2 * s * b, "fwd": 2 * s * b,
            "pool_fwd": 2 * s * b, "pool_bwd": s * b, "wgrad": s * b,
            "dgrad": s * (b - 1), "bn_bwd": s * (b - 1),
        }, gap_fwd=2 * s, gap_bwd=s)
    return _by_kernel(cfg, {
        "fwd_stats": 2 * s * b,  # support + target forward
        "act_fwd": 2 * s * b,
        "act_bwd": s * b,        # support backward only
        "dgrad": s * (b - 1),    # not for the images
        "wgrad": s * b,
        "fwd": 0,                # second order only
        "act_bwd_bwd": 0,
    }, gap_fwd=2 * s, gap_bwd=s)


def expected_serve_launches(cfg, ingest):
    """Kernel launches of one serve dispatch with ``ingest``."""
    return {**expected_launches(cfg),
            "episode_expand": EXPAND_PER_DISPATCH[ingest]}


def expected_step_launches(cfg, placement):
    """Kernel launches of one second-order train step whose batch comes
    through the data tier ``placement`` (None: the fixed batch)."""
    return {**expected_train_launches(cfg, True),
            "episode_expand": EXPAND_PER_STEP[placement]}


def expected_train_launches(cfg, second_order):
    """Kernel launches of ONE train step (``make_train_step``), from the
    structure of ``kernels/conv_block.py``'s Functions; S inner steps, B
    blocks, times ``meta_accum_steps`` (each microbatch runs the graph
    once). Per inner step and block:

    * forward (support, target): K1 and K2 twice each;
    * inner backward of the support loss: K3 once, K4 wgrad once, dgrad
      once except at block 1 (its input is the images);
    * first order adds the outer backward of the target forward only:
      K3, wgrad, and dgrad except at block 1 — 2 K3, 2 wgrad, 2 dgrad;
    * second order differentiates the inner backward too: the outer pass
      runs the target forward's and the support forward's backwards (K3,
      wgrad, dgrad except at block 1, each twice in all), K5 once (the
      backward of the support's K3), and the conv closure — Wgrad's
      backward (K1 stats-free with bias for dy; dgrad for x except at block
      1) and Dgrad's backward (K1 stats-free for dy; wgrad for w; no Dgrad
      node at block 1). Totals per step and block, second order: K3 3,
      wgrad 4 (3 at block 1), dgrad 4 (0 at block 1), K1 stats-free 2 (1 at
      block 1), K5 1.

    The strided model (``max_pooling=False``) runs the same graph on the
    stride-2 conv kernels and the pool-free K2/K3/K5, so the same counts
    fall on those names; its global average pool (after the last block
    only) adds, per inner step: the forward once per support and target
    forward (2), the backward (``GapBwd``) once in the inner support
    backward; first order, the backward once more in the outer pass (the
    target's) — forward 2, backward 2; second order, the outer pass runs
    the backward of both forwards' ``Gap`` nodes (backward 2 more) and the
    backward of the inner ``GapBwd`` node, which is ``Gap`` (forward 1
    more) — forward 3, backward 3.

    The norm-first block (``block_order='norm_conv_relu'``; the norm
    parameters are meta-trained, so the normalized images need a gradient
    in the outer pass). Per inner step and block:

    * forward (support, target): ``bn_input_stats``, ``batch_norm_fwd``,
      K1 stats-free with bias and ``act_pool_fwd``, twice each;
    * inner backward: ``act_pool_bwd``, wgrad and dgrad once (dgrad at
      block 1 too: its input, the normalized images, requires a gradient,
      and ``Conv3x3`` cannot know that this pass discards it), and
      ``batch_norm_bwd`` except at block 1 (not on the path to the adapted
      weights);
    * first order adds the outer backward of the target forward:
      ``act_pool_bwd``, wgrad, dgrad and ``batch_norm_bwd`` once each —
      totals 2, 2, 2 and 2 (1 at block 1);
    * second order adds the outer backward of both forwards (2 each of
      ``act_pool_bwd``, wgrad, dgrad, ``batch_norm_bwd``) and of the inner
      backward's nodes: ``ActPoolBwd`` -> ``act_pool_gather`` once;
      ``Wgrad`` -> K1 stats-free with bias and dgrad once; ``Dgrad`` -> K1
      stats-free and wgrad, except at block 1 (its inner dx reached no
      loss); ``BatchNormBwd`` -> ``batch_norm_bwd_bwd`` except at block 1.
      Totals: ``act_pool_bwd`` 3, gather 1, dgrad 4, wgrad 4 (3 at block
      1), K1 stats-free 4 (3 at block 1), ``batch_norm_bwd`` 3 (2 at block
      1), ``batch_norm_bwd_bwd`` 1 (0 at block 1).

    Pool-free (the strided norm-first model) the same counts fall on
    ``act_fwd`` / ``act_bwd`` (the gather's count on ``act_bwd`` too) and
    the stride-2 conv kernels, and the global average pool adds what it
    adds to the strided model.

    ``tests/test_torch_train.py`` and ``tests/test_torch_norm_first.py``
    count the same calls on the CPU through the twins and hold them to
    this formula."""
    s, b = cfg.number_of_training_steps_per_iter, cfg.num_stages
    if cfg.block_order == "norm_conv_relu":
        per_role = {"in_stats": 2 * s * b, "bn_fwd": 2 * s * b,
                    "pool_fwd": 2 * s * b}
        if second_order:
            per_role.update({
                "fwd": s * (4 * b - 1), "pool_bwd": 3 * s * b,
                "pool_gather": s * b, "dgrad": 4 * s * b,
                "wgrad": s * (4 * b - 1), "bn_bwd": s * (3 * b - 1),
                "bn_bwd_bwd": s * (b - 1)})
            gap = 3 * s
        else:
            per_role.update({
                "fwd": 2 * s * b, "pool_bwd": 2 * s * b, "dgrad": 2 * s * b,
                "wgrad": 2 * s * b, "bn_bwd": s * (2 * b - 1)})
            gap = 2 * s
        per_step = _by_kernel(cfg, per_role, gap_fwd=gap, gap_bwd=gap)
    elif second_order:
        per_step = _by_kernel(cfg, {
            "fwd_stats": 2 * s * b,
            "act_fwd": 2 * s * b,
            "act_bwd": 3 * s * b,
            "dgrad": 4 * s * (b - 1),
            "wgrad": s * (4 * b - 1),
            "fwd": s * (2 * b - 1),
            "act_bwd_bwd": s * b,
        }, gap_fwd=3 * s, gap_bwd=3 * s)
    else:
        per_step = _by_kernel(cfg, {
            "fwd_stats": 2 * s * b,
            "act_fwd": 2 * s * b,
            "act_bwd": 2 * s * b,
            "dgrad": 2 * s * (b - 1),
            "wgrad": 2 * s * b,
            "fwd": 0,
            "act_bwd_bwd": 0,
        }, gap_fwd=2 * s, gap_bwd=2 * s)
    return {k: v * cfg.meta_accum_steps for k, v in per_step.items()}


def _block_pair(cfg, cb, F):
    """The kernel side and the plain side of a kernels-vs-plain check of
    ``cfg``'s model: for the conv-first batch-norm block the default block
    (None: the kernels) and the plain block, which take the same pool and
    sign decisions (the conv kernels equal the plain conv bit for bit, and
    the normalize after it is monotone in it); for the norm-first block
    and the layer-norm blocks ``_replayed_pair`` (kernels recording, plain
    replaying). The recorder re-composes the Functions of the model's
    block (``norm_function_block``, ``conv_ln_function_block``,
    ``ln_conv_function_block``), so each check that takes it also runs the
    model's own block (None) and holds the two equal bit for bit
    (``_same_as_own``): the same kernels in the same order,
    deterministic, no atomics."""
    if cfg.block_order == "norm_conv_relu" or cfg.norm_layer == "layer_norm":
        return _replayed_pair(cfg, cb, F)
    return None, _plain(cfg)


def _same_as_own(what, recorder, own):
    """The recording block's results (served ``DispatchResult`` or a (loss,
    meta-gradients) pair) against the model's own block's: exactly
    equal."""
    import numpy as np

    if isinstance(recorder, tuple):
        same = recorder[0] == own[0] and all(
            torch.equal(v, own[1][k]) for k, v in recorder[1].items())
    else:
        same = all(np.array_equal(a.preds, b.preds) and a.loss == b.loss
                   for a, b in zip(recorder.results, own.results))
    if not same:
        raise AssertionError(f"{what}: the recording block differs from the "
                             "model's own block")
    print(f"  {what}: the recording block equals the model's own block bit "
          "for bit", flush=True)


def check_small_against_plain(cfg, F, cb):
    """Phase 5a: the serve step on a SMALL input — 2 stages, 8 filters,
    20x20 images, 2 inner steps — kernels vs plain ops on the card, at
    the CPU parity tests' tolerances (preds atol 1e-4, loss rtol 1e-4)
    (``_block_pair``)."""
    import numpy as np

    from howtotrainyourmamlpytorch_tpu_torch.serving import bench
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    small = cfg.replace(image_height=20, image_width=20, cnn_num_filters=8,
                        num_stages=2, number_of_training_steps_per_iter=2,
                        number_of_evaluation_steps_per_iter=2)
    group = bench._synth_groups(small, [5], 6, 3, 1)[-1]  # 3 tenants
    state = init_state(small, device="cuda:0")
    blocks = _block_pair(small, cb, F)
    if blocks[0] is not None:
        blocks += (None,)
    out = [
        ServingEngine(small, state, [5], device="cuda:0",
                      block=block).serve_group(group)
        for block in blocks
    ]

    def spread(a, b):
        return (max(float(np.abs(ra.preds - rb.preds).max())
                    for ra, rb in zip(a.results, b.results)),
                max(abs(ra.loss - rb.loss) / abs(rb.loss)
                    for ra, rb in zip(a.results, b.results)))

    preds, loss = spread(out[0], out[1])
    print(f"  small serve step ({len(group)} tenants, bucket "
          f"{out[0].bucket}), kernels vs plain on the card: preds max err "
          f"{preds:.3e}, loss max rel err {loss:.3e}", flush=True)
    if len(out) > 2:
        _same_as_own("small serve step", out[0], out[2])
    if preds > 1e-4 or loss > 1e-4:
        raise AssertionError("small serve step: kernels disagree with plain")


def check_against_plain(cfg, F, cb, cpu_spread=True):
    """Phase 5b: one bucket-8 dispatch at full width, kernels vs plain ops
    on the card (``_block_pair``), beside (with ``cpu_spread``) the
    CPU-vs-card spread of the plain ops. That spread is printed, not
    gated, and its CPU dispatch takes 25-37 s at mini-ImageNet width, so
    every mini-ImageNet model leaves it out (the flagship's spread is
    ~5e-3 in preds, the comment at PREDS_ATOL); the strided Omniglot model
    keeps it."""
    import numpy as np

    from howtotrainyourmamlpytorch_tpu_torch.serving import bench
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    # twopass statistics everywhere, so the CPU run computes what the card's
    # plain run computes ('auto' would pick 'fused' on the CPU)
    cfg = cfg.replace(bn_stats_impl="twopass")
    shots_buckets = bench.bench_shots_buckets(cfg)
    groups = bench._synth_groups(cfg, shots_buckets, 32, 8, 0)
    group = max(groups, key=len)  # 7 tenants -> bucket 8, 1 pad tenant
    state = init_state(cfg, device="cuda:0")
    blocks = _block_pair(cfg, cb, F)
    engines = (
        ("kernels", ServingEngine(cfg, state, shots_buckets,
                                  device="cuda:0", block=blocks[0]), 3),
        ("plain", ServingEngine(cfg, state, shots_buckets, device="cuda:0",
                                block=blocks[1]), 3),
    ) + ((("plain on the CPU", ServingEngine(cfg, state, shots_buckets,
                                             device="cpu"), 1),)
         if cpu_spread else ()) + ((("the model's own block", ServingEngine(
        cfg, state, shots_buckets, device="cuda:0"), 1),)
        if blocks[0] is not None else ())
    results = {}
    for name, engine, reps in engines:
        drs = [engine.serve_group(group) for _ in range(reps)]
        results[name] = drs[-1]
        print(f"  bucket-{drs[-1].bucket} dispatch ({len(group)} tenants, "
              f"{drs[-1].shots} shots) with {name}: adapt_ms "
              f"{[round(d.adapt_ms, 3) for d in drs]}", flush=True)

    def spread(a, b):
        preds = loss = 0.0
        for ra, rb in zip(results[a].results, results[b].results):
            preds = max(preds, float(np.abs(ra.preds - rb.preds).max()))
            loss = max(loss, abs(ra.loss - rb.loss) / abs(rb.loss))
        return preds, loss

    way_t = cfg.num_classes_per_set * cfg.num_target_samples
    for rk, rp in zip(results["kernels"].results, results["plain"].results):
        if rk.preds.shape != (way_t, cfg.num_classes_per_set):
            raise AssertionError(f"preds shape {rk.preds.shape}")
        if not np.isfinite(rk.preds).all() or not np.allclose(
                rk.preds.sum(-1), 1.0, atol=1e-5):
            raise AssertionError("preds are not finite probabilities")
        top2 = np.sort(rp.preds, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > PREDS_ATOL
        agree = rk.preds.argmax(-1) == rp.preds.argmax(-1)
        if not agree[clear].all():
            raise AssertionError(
                f"accuracy differs where the margin > {PREDS_ATOL}")
    worst_p, worst_l = spread("kernels", "plain")
    print(f"  serve step, kernels vs plain on the card: preds max err "
          f"{worst_p:.3e}, loss max rel err {worst_l:.3e}", flush=True)
    if cpu_spread:
        base_p, base_l = spread("plain on the CPU", "plain")
        print(f"  serve step, plain on the CPU vs plain on the card (the "
              f"f32 summation-order spread): preds {base_p:.3e}, loss "
              f"{base_l:.3e}", flush=True)
    if "the model's own block" in results:
        _same_as_own("bucket-8 serve step", results["kernels"],
                     results["the model's own block"])
    if worst_p > PREDS_ATOL or worst_l > LOSS_RTOL:
        raise AssertionError(
            f"serve step vs plain: preds max err {worst_p:.3e} (atol "
            f"{PREDS_ATOL}), loss max rel err {worst_l:.3e} (rtol "
            f"{LOSS_RTOL})"
        )


def profile_dispatch(cfg, ingest="f32", small=True, store_rows=STORE_ROWS):
    """Phase 5c: where a dispatch spends its time — ``torch.profiler``
    over one warm bucket-8 (and with ``small`` one warm bucket-1) dispatch
    of ``ingest`` (the index ingest from a store of ``store_rows``): device
    time by kernel and the device's busy share of the dispatch's wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    from howtotrainyourmamlpytorch_tpu_torch.serving import bench
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    shots_buckets = bench.bench_shots_buckets(cfg)
    rows = store_rows if ingest == "index" else 0
    groups = bench._synth_groups(cfg, shots_buckets, 36, 8, 0, ingest, rows)
    engine = ServingEngine(
        cfg, init_state(cfg, device="cuda:0"), shots_buckets,
        device="cuda:0", ingest=ingest,
        store=bench._synth_store(cfg, rows) if rows else None)
    # 8 tenants x 6 shots; 1 x 5
    for group in (groups[-1], groups[0]) if small else (groups[-1],):
        engine.serve_group(group)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dr = engine.serve_group(group)
        model = (" of the bf16 model" if cfg.compute_dtype == "bfloat16"
                 else "")
        _profile_report(prof, dr.adapt_ms,
                        f"profiled {ingest} bucket-{dr.bucket} dispatch"
                        f"{model} ({dr.tenants} tenants, {dr.shots} shots, "
                        f"{dr.ingest_bytes} B uploaded)")


def _profile_report(prof, wall_ms, what):
    """Device time by kernel and the device's busy share of ``wall_ms``."""
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    if not events:
        print(f"  {what}: device time by kernel: not measured (the "
              "profiler saw no device activity)", flush=True)
        return
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"  {what}: device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / wall_ms:.1f}% of {wall_ms:.3f} ms, "
          f"{sum(e.count for e in events)} device activities", flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    casts = [e for e in events if "copy_kernel" in e.key]
    print(f"  {what}: copy kernels (dtype casts and copies) "
          f"{sum(e.device_time_total for e in casts) / 1e3:.3f} ms over "
          f"{sum(e.count for e in casts)} launches", flush=True)


def run_train_bench(ks, cfg, batch_size, config=FLAGSHIP, name="mini-ImageNet "
                    "5-way 5-shot", placement=None, extra=(), warmup=2,
                    steps=5):
    """Phase 5, a training main path: ``train-bench`` at ``config`` (with
    the ``extra`` arguments: a config override), second order from epoch
    0, its batches through the data tier ``placement`` (None: one fixed
    batch), ``warmup`` then ``steps`` timed steps; every timed step's
    launches equal ``expected_step_launches`` of ``cfg`` and the run's
    totals equal it times the steps (every counter: on a bf16 model no f32
    kernel may move). Returns (JSON line, launch counts over the
    run)."""
    from howtotrainyourmamlpytorch_tpu_torch import bench as train_bench

    tier = [] if placement is None else ["--data-placement", placement]
    print(f"[train] train-bench --config {name} --batch-size {batch_size} "
          f"--epoch 0 --warmup {warmup} --steps {steps} "
          f"{' '.join(tier + list(extra))}", flush=True)
    ks.reset_launches()
    line = train_bench.run([
        "--config", config, "--batch-size", str(batch_size), "--epoch",
        "0", "--warmup", str(warmup), "--steps", str(steps), "--seed", "0",
        "--device", DEVICE] + tier + list(extra))
    counts = ks.launches()
    print(json.dumps(line), flush=True)
    expected = expected_step_launches(cfg.replace(batch_size=batch_size),
                                      placement)
    if (not line["second_order"] or line["batch_size"] != batch_size
            or line["max_pooling"] != cfg.max_pooling
            or line["block_order"] != cfg.block_order
            or line["norm_layer"] != cfg.norm_layer
            or line["conv_padding"] != cfg.conv_padding
            or line["dtype"] != cfg.compute_dtype):
        raise AssertionError(f"train-bench ran {line}")
    for i, got in enumerate(line["kernel_launches_per_step"]):
        if got != expected:
            raise AssertionError(
                f"train step {i}: launches {got}, expected {expected}")
    for k, per_step in expected.items():
        if counts[k] != per_step * (warmup + steps):
            raise AssertionError(
                f"{k}: {counts[k]} launches over the training path, "
                f"expected {per_step} x {warmup + steps} steps")
    tps = line["tasks_per_sec"]
    if not (tps and math.isfinite(tps)
            and all(math.isfinite(v) for v in line["loss"])):
        raise AssertionError(f"train-bench line is incomplete: {line}")
    print(f"[train] {name} batch {batch_size} {placement or 'fixed batch'}: "
          f"tasks_per_sec {tps}  step_ms p50 {line['step_ms_p50']}  p95 "
          f"{line['step_ms_p95']}  peak_mem_gb {line['peak_mem_gb']}  "
          f"ffma_peak_share {line['ffma_peak_share']}  h2d_bytes_per_step "
          f"{line['h2d_bytes_per_step']}  host_assembly_ms_per_step "
          f"{line['host_assembly_ms_per_step']}  launches per step "
          f"{ {k: v for k, v in expected.items() if v} }", flush=True)
    return line, counts


def _batch(cfg, seed):
    """The bench's batch from ``seed`` on the card."""
    from howtotrainyourmamlpytorch_tpu_torch import bench as train_bench

    return train_bench.synth_batch(cfg, seed, torch.device(DEVICE))


def _image_order(batch, order):
    """``batch`` with each task's support and target images (with their
    labels) permuted, the same permutation for every task; order 0 keeps
    them. The meta-loss and its gradients are sums over the images, so a
    permutation changes only the order in which the f32 sums are taken."""
    if order == 0:
        return batch
    gen = torch.Generator().manual_seed(order)
    out = []
    for x, y in (batch[:2], batch[2:]):
        b, per_task = y.shape[0], y[0].numel()
        perm = torch.randperm(per_task, generator=gen).to(x.device)
        out += [x.reshape(b, per_task, *x.shape[3:])[:, perm].reshape(x.shape),
                y.reshape(b, per_task)[:, perm].reshape(y.shape)]
    return tuple(out)


def _plain(cfg):
    """The plain block of ``cfg``'s block order (``vgg.blocks_for``)."""
    from howtotrainyourmamlpytorch_tpu_torch.models import vgg

    return vgg.blocks_for(cfg)[1]


def _grads(cfg, block, batch, dtype=None):
    """(loss, meta-gradients) of one second-order step from the config's
    seeded state on ``batch``, on the card, in ``dtype`` (f32 unless named:
    f64 on the plain ops is the reference)."""
    from howtotrainyourmamlpytorch_tpu_torch.core import maml
    from howtotrainyourmamlpytorch_tpu_torch.state import (
        init_state,
        to_device,
    )

    device = torch.device(DEVICE)
    state = init_state(cfg, device=device)
    x_s, y_s, x_t, y_t = batch
    if dtype is not None:
        state = to_device(state, device, dtype)
        x_s, x_t = x_s.to(dtype), x_t.to(dtype)
    _, weights, _ = maml.epoch_schedule(cfg, 0)
    loss, grads = maml.make_grads_fn(cfg, True, block=block)(
        state, x_s, y_s, x_t, y_t, weights)
    return float(loss), {f"{g}/{k}": v for g, part in grads.items()
                         for k, v in part.items()}


def check_grads_small(cfg, F, cb):
    """Phase 5: second-order meta-gradients on a SMALL input — 2 stages, 8
    filters, 20x20 images, 2 inner steps, batch 2 — kernels vs plain ops
    on the card (``_block_pair``), at the CPU parity tests' tolerance
    (each leaf within 1e-6 + 1e-4 * its largest entry; loss rtol
    1e-4)."""
    small = cfg.replace(image_height=20, image_width=20, cnn_num_filters=8,
                        num_stages=2, number_of_training_steps_per_iter=2,
                        number_of_evaluation_steps_per_iter=2,
                        bn_stats_impl="twopass", batch_size=2)
    batch = _batch(small, 0)
    kernel_block, plain_block = _block_pair(small, cb, F)
    loss_k, grads_k = _grads(small, kernel_block, batch)
    loss_p, grads_p = _grads(small, plain_block, batch)
    if kernel_block is not None:
        _same_as_own("small second-order step", (loss_k, grads_k),
                     _grads(small, None, batch))
    worst = 0.0
    for key, want in grads_p.items():
        err = (grads_k[key] - want).abs().max().item()
        bound = 1e-6 + 1e-4 * want.abs().max().item()
        worst = max(worst, err / bound)
        if err > bound:
            raise AssertionError(f"small meta-gradient {key}: max err "
                                 f"{err:.3e} > {bound:.3e}")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  small second-order step, kernels vs plain on the card: loss "
          f"rel err {rel:.3e}, worst leaf at {worst:.3f} of its bound",
          flush=True)
    if rel > 1e-4:
        raise AssertionError("small train step: loss disagrees with plain")


def _quantiles(values):
    v = sorted(values)
    return ", ".join(f"{q} {v[min(len(v) - 1, int(p * len(v)))]:.3f}"
                     for q, p in (("median", 0.5), ("p90", 0.9),
                                  ("p99", 0.99), ("max", 1.0)))


def check_grads_full_width(cfg, F, seeds):
    """Phase 5: second-order meta-gradients at full width, batch 2, for
    each data seed, held against the same step in f64 on the plain ops on
    the card (the reference). Three f32 runs: the kernels, and the plain
    ops with twopass and with fused statistics, each in GRAD_ORDERS orders
    of the images (``_image_order``). Per leaf and seed, each run's error
    is the median over the orders of max |run - f64|; the kernels' must
    stay within GRADS_FACTOR times the larger plain median, plus
    GRADS_FLOOR times the tree's largest entry; the loss likewise (relative
    error, floor 1e-7). Every leaf is printed before the gate.

    Why medians over orders: at this width an f32 step is far from its f64
    value (1e-3 to 1 of a leaf's own scale), and the error comes in bursts
    (a max-pool argmax or a leaky-ReLU sign that flips in an early inner
    step reroutes a gradient), so one order's error varies over 10x between
    orders of the same code. The median of several orders is steady where
    a single reading is not, while a fault in the kernels moves every
    order alike.

    GRADS_FACTOR comes from the null ratios, which this phase prints: the
    same statistic taken for each plain run instead of the kernels (its
    median over the larger of the other two runs' medians; nonzero leaves
    and the loss). If the kernels are one more f32 summation order, their
    ratio is drawn from that distribution. Over the data seeds 0-9
    (``--grad-seeds 0,1,2,3,4,5,6,7,8,9``; 420 null ratios on an NVIDIA
    H100 80GB HBM3 at 700 W) it had median 0.951, p90 1.463, p99 2.565
    and max 2.792; GRADS_FACTOR = 4 leaves room for that tail over the 63
    ratios of a three-seed run (21 of the one-seed default). The default
    seeds are other seeds.

    On the Omniglot 20-way 1-shot model the same calibration (seeds 0-9)
    gave null max 3.335, but the kernels' ratio reached 8.804 on seed 1 and
    exceeded 4 on seed 8: there the bursts are decisions (a pool argmax or
    a sign) that the kernels, another conv summation order, take otherwise
    than f64 in a later inner step, while the two plain runs, which share
    their conv code, do not. ``check_grads_replayed`` takes the decisions
    out of the comparison and passes those seeds; this check keeps its
    statistic, factor and default seeds for both models."""
    import statistics

    cfg = cfg.replace(batch_size=2)
    twopass = cfg.replace(bn_stats_impl="twopass")
    plain_block = _plain(cfg)
    runs = (("kernels", cfg, None), ("twopass", twopass, plain_block),
            ("fused", cfg.replace(bn_stats_impl="fused"), plain_block))
    start = time.perf_counter()
    rows, failures, ratios, null = {}, [], [], []
    for seed in seeds:
        batch = _batch(cfg, seed)
        ref_loss, ref = _grads(twopass, plain_block, batch, torch.float64)
        scale = max(v.abs().max().item() for v in ref.values())
        loss_errs = {name: [] for name, _, _ in runs}
        errs = {name: {key: [] for key in ref} for name, _, _ in runs}
        for order in range(GRAD_ORDERS):
            permuted = _image_order(batch, order)
            for name, c, block in runs:
                loss, g = _grads(c, block, permuted)
                loss_errs[name].append(abs(loss - ref_loss) / abs(ref_loss))
                for key, want in ref.items():
                    errs[name][key].append(
                        (g[key].double() - want).abs().max().item())
                del g
        stats = [("loss", 1.0, {n: statistics.median(v)
                                for n, v in loss_errs.items()}, 1e-7)]
        stats += [(key, want.abs().max().item(),
                   {n: statistics.median(errs[n][key]) for n in errs},
                   GRADS_FLOOR * scale) for key, want in ref.items()]
        print(f"  seed {seed}: loss f64 {ref_loss:.8f}; median rel err vs "
              "f64 " + ", ".join(f"{n} {v:.3e}" for n, v in
                                 stats[0][2].items())
              + " (orders: kernels "
              + " ".join(f"{v:.1e}" for v in loss_errs["kernels"])
              + "); largest meta-gradient entry "
              f"{scale:.3e}", flush=True)
        for key, m, med, floor in stats:
            plain = max(med["twopass"], med["fused"])
            zero = key != "loss" and m < 1e-6 * scale
            ratio = med["kernels"] / plain if plain else 0.0
            rows.setdefault(key, []).append((m, med, ratio, zero, scale))
            if not zero:
                ratios.append((ratio, seed, key))
                for n, others in (("twopass", ("kernels", "fused")),
                                  ("fused", ("kernels", "twopass"))):
                    null.append((med[n] / max(med[o] for o in others),
                                 seed, key))
            if med["kernels"] > GRADS_FACTOR * plain + floor:
                failures.append(f"seed {seed} {key}")
    print(f"  per leaf, seeds {list(seeds)}, median over {GRAD_ORDERS} "
          "image orders: max |f64| ; median max |err| / max |f64| of "
          "kernels, twopass, fused, or * / the tree's largest entry where "
          "the leaf is 0 (below 1e-6 of it) ; kernels / larger plain",
          flush=True)
    for key, per_seed in rows.items():
        cells = []
        for m, med, ratio, zero, scale in per_seed:
            rel = ("*" if zero else "") + " ".join(
                f"{med[n] / (scale if zero else m):.2e}" for n in med)
            cells.append(f"{m:.2e}; {rel}; {ratio:.2f}")
        print(f"    {key:34s} " + " | ".join(cells), flush=True)
    print(f"  kernels / larger plain median over {len(ratios)} nonzero "
          f"leaf-seeds: {_quantiles([r for r, _, _ in ratios])}; worst "
          + ", ".join(f"{r:.2f} (seed {s} {k})"
                      for r, s, k in sorted(ratios)[-3:]), flush=True)
    print(f"  null ratios, each plain median / the larger of the other "
          f"two runs', over "
          f"{len(null)}: {_quantiles([r for r, _, _ in null])}; worst "
          + ", ".join(f"{r:.2f} (seed {s} {k})"
                      for r, s, k in sorted(null)[-3:])
          + f" (gate {GRADS_FACTOR:g}x + {GRADS_FLOOR:g} of the largest "
          f"entry; {time.perf_counter() - start:.1f} s)", flush=True)
    if failures:
        raise AssertionError("full-width meta-gradients: kernels further "
                             "from f64 than the plain orders allow at "
                             + ", ".join(failures))


def _recording_kernel_block(cb, log, norm_first=False, layer_norm=False):
    """The kernels' block (``conv_block.function_block``, with
    ``norm_first`` ``norm_function_block``, with ``layer_norm``
    ``conv_ln_function_block`` or ``ln_conv_function_block``) that also
    appends each call's discrete decisions to ``log``: with the max pool,
    the window argmax of every pooled element (K2's or ``act_pool_fwd``'s
    output) and whether the pooled value (the leaky-ReLU output at that
    argmax) is >= 0; pool-free (the strided model), no argmax (None) and
    the sign of every activation."""
    def block(x, w, b, gamma, beta, stats_impl="twopass", stride=1,
              pool=True, gap=False, padding=1):
        x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
        mean = var = None
        conv = (stride, padding)
        if layer_norm and norm_first:
            z = cb.LayerNorm.apply(x, *cb._ln_params(gamma, beta, x))
            out = cb.ActPool.apply(cb.Conv3x3.apply(z, w, b, False, *conv),
                                   pool)
        elif layer_norm:
            y = cb.Conv3x3.apply(x, w, b, False, *conv)
            out = cb.ActPool.apply(
                cb.LayerNorm.apply(y, *cb._ln_params(gamma, beta, y)), pool)
        else:
            T, c = x.shape[0], (x if norm_first else w).shape[-1]
            gamma = gamma.to(x.dtype).expand(T, c).contiguous()
            beta = beta.to(x.dtype).expand(T, c).contiguous()
            if norm_first:
                z, mean, var, _ = cb.BatchNorm.apply(x, gamma, beta)
                out = cb.ActPool.apply(cb.Conv3x3.apply(
                    z, w, b, False, *conv), pool)
            else:
                y, mean, var, rstd = cb.Conv3x3.apply(x, w, b, True, *conv)
                out = cb.BnActPool.apply(y, gamma, beta, mean, rstd, pool)
        out, arg = out if pool else (out, None)
        log.append((arg, out.detach() >= 0))
        if gap:
            out = cb.Gap.apply(out)
        return out, mean, var
    block.block_order = "norm_conv_relu" if norm_first else "conv_norm_relu"
    block.norm_layer = "layer_norm" if layer_norm else "batch_norm"
    return block


def _plain_block(F, log, replay=False, norm_first=False, layer_norm=False,
                 ties=None, slope=None):
    """The block in plain ops, differentiable by autograd (with
    ``norm_first`` the norm-first block, with ``layer_norm`` the
    layer-norm block of that order). Recording (``replay=False``): the
    pool takes each window's first maximum and appends the decisions to
    ``log`` as ``_recording_kernel_block`` does. Replaying: the pool takes
    the argmax, and the leaky-ReLU the sign, that the next entry of
    ``log`` recorded, whatever this run's own values say, so the run
    follows the recorded run's piecewise-linear path. Pool-free (the
    strided model) the signs alone. Recording with a ``ties`` list, each
    call also appends how many pool windows hold an exact tie at their
    maximum.

    The layer norm is ``F.layer_norm`` (two passes, as the JAX package's,
    which has no other statistics mode); with ``stats_impl='fused'`` its
    statistics come from ``torch.var_mean`` instead (one pass): another
    f32 summation order of the same function, the second plain run of the
    meta-gradient checks' null ratios. In bf16 that run stays a plain bf16
    path with its own rounding: ``torch.var_mean`` of a bf16 tensor sums
    in f32 and returns bf16 statistics, and ``var + eps``, the rsqrt and
    every op after it round to bf16 (eps added in f32 inside the op, not
    rounded to bf16 first as the twopass run's). ``slope`` replaces the
    leaky-ReLU's
    (an f64 reference of a bf16 run takes bf16's, 0.010009765625)."""
    entries = iter(log)

    def leaky(t):
        return (slope if slope is not None
                else F.scalar_like(F.LEAKY_SLOPE, t)) * t

    def affine(t, mean, var, gamma, beta):
        inv = F.rsqrt_eps(var, F.BN_EPS)
        t = (t - F._per_channel(mean, t)) * F._per_channel(inv, t)
        return t * F._per_channel(gamma.to(t.dtype), t) + F._per_channel(
            beta.to(t.dtype), t)

    def norm(t, gamma, beta, stats_impl):
        if stats_impl != "fused":
            return F.layer_norm(t, gamma, beta)
        var, mean = torch.var_mean(t, dim=(-3, -2, -1), correction=0,
                                   keepdim=True)
        t = (t - mean) * torch.rsqrt(var + F.LN_EPS)
        return (t * F._ln_param(gamma.to(t.dtype), t)
                + F._ln_param(beta.to(t.dtype), t))

    def block(x, w, b, gamma, beta, stats_impl="twopass", stride=1,
              pool=True, gap=False, padding=1):
        stats = (None, None)
        if layer_norm and norm_first:
            z = F.conv2d(norm(x, gamma, beta, stats_impl), w, b, stride,
                         padding)
        elif layer_norm:
            z = norm(F.conv2d(x, w, b, stride, padding), gamma, beta,
                     stats_impl)
        elif norm_first:
            mean, var = F.batch_stats(x, stats_impl)
            z = F.conv2d(affine(x, mean, var, gamma, beta), w, b, stride,
                         padding)
            stats = (mean.detach(), var.detach())
        else:
            y = F.conv2d(x, w, b, stride, padding)
            mean, var = F.batch_stats(y, stats_impl)
            z = affine(y, mean, var, gamma, beta)
            stats = (mean.detach(), var.detach())
        if not pool:
            if replay:
                _, positive = next(entries)
            else:
                positive = z >= 0
                log.append((None, positive))
            out = torch.where(positive, z, leaky(z))
            if gap:
                out = F.global_avg_pool2d(out)
            return (out, *stats)
        win = F._windows(z)
        if replay:
            arg, positive = next(entries)
        else:
            act = F._windows(F.leaky_relu(z))
            arg = torch.argmax(act, dim=-1)
            if ties is not None:
                top = act.topk(2, dim=-1).values
                ties.append(int((top[..., 0] == top[..., 1]).sum()))
        z_at = torch.gather(win, -1, arg.long().unsqueeze(-1)).squeeze(-1)
        if not replay:
            positive = z_at >= 0
            log.append((arg.to(torch.uint8), positive))
        pooled = torch.where(positive, z_at, leaky(z_at))
        return (pooled, *stats)
    block.block_order = "norm_conv_relu" if norm_first else "conv_norm_relu"
    block.norm_layer = "layer_norm" if layer_norm else "batch_norm"
    return block


def _decision_flips(cfg, cb, F, batch):
    """The first support forward (inner step 0) of the kernels, the plain
    ops in the config's dtype (f32 or bf16) and the plain ops in f64 on
    ``batch``: per implementation, how many of its pool argmax and sign
    decisions differ from f64's."""
    from howtotrainyourmamlpytorch_tpu_torch.core import partition
    from howtotrainyourmamlpytorch_tpu_torch.models import vgg
    from howtotrainyourmamlpytorch_tpu_torch.state import (
        init_state,
        to_device,
    )

    device = torch.device(DEVICE)
    x = batch[0].reshape(batch[0].shape[0], -1, *batch[0].shape[-3:])
    logs = {}
    for name, dtype in (("kernels", None), ("plain", None),
                        ("f64", torch.float64)):
        state = init_state(cfg, device=device)
        if dtype is not None:
            state = to_device(state, device, dtype)
        net = {k: v.unsqueeze(0).expand(x.shape[0], *v.shape).contiguous()
               if partition.is_inner_adapted(cfg, k) else v
               for k, v in state.net.items()}
        log = []
        orders = dict(norm_first=cfg.block_order == "norm_conv_relu",
                      layer_norm=cfg.norm_layer == "layer_norm")
        block = (_recording_kernel_block(cb, log, **orders)
                 if name == "kernels" else _plain_block(F, log, **orders))
        with torch.no_grad():
            if dtype is None:
                vgg.apply(cfg, net, state.bn, x, 0, block=block)
            else:
                vgg.apply(cfg.replace(compute_dtype="float32"), net,
                          state.bn, x.to(dtype), 0, block=block)
        logs[name] = log
    return {name: sum((0 if a is None else int((a != a64).sum()))
                      + int((p != p64).sum())
                      for (a, p), (a64, p64) in zip(logs[name], logs["f64"]))
            for name in ("kernels", "plain")}


def check_grads_replayed(cfg, cb, F, seeds):
    """Phase 5: full-width meta-gradients, batch 2, each f32 run held to an
    f64 reference that takes the same discrete path. Max pooling and the
    leaky ReLU make the step piecewise linear: a pool argmax or a sign that
    an f32 run decides otherwise than f64 (a near-tie within f32 rounding)
    reroutes a gradient, and those flips, not rounding, make the f32 error
    bursty (``check_grads_full_width``). Here each f32 run records every
    argmax and sign it takes, and its reference is the plain step in f64
    replaying exactly those decisions: what is left is the run's smooth
    f32 rounding. The runs are ``check_grads_full_width``'s — the kernels,
    and the plain ops with twopass and with fused statistics — each in
    GRAD_ORDERS orders of the images. Per leaf and seed, each run's error
    is the median over the orders of max |run - its reference|; the
    kernels' must stay within REPLAY_FACTOR times the larger plain median,
    plus GRADS_FLOOR times the tree's largest entry. The kernels' run of
    the first order is also held bit for bit to the step on the model's
    own block (``_same_as_own``). Also printed, per seed: how many
    decisions of the first support forward the kernels and the plain f32
    ops take otherwise than f64.

    REPLAY_FACTOR comes from the null ratios this phase prints (each plain
    median over the larger of the other two runs'), over the data seeds
    0-9 of both models (``--grad-seeds 0,...,9 --omniglot-grad-seeds
    0,...,9``; 800 null ratios on an NVIDIA H100 80GB HBM3 at 700 W): max
    3.624 (mini-ImageNet; Omniglot 2.626). The rule, fixed before that
    reading: 4 if the null max stayed under 3.2, else the smallest integer
    at or above 1.25 times it, hence 5. In that run the kernels' ratio had
    median 0.225 and max 1.003 on mini-ImageNet, median 0.682 and max
    3.434 on Omniglot. The norm-first model's own null over its seeds 0-9
    (``--norm-first-grad-seeds 0,...,9``; 560 ratios, same card) has max
    2.640, under 4 (1.25 x 2.640 <= 5), so the same factor holds for it;
    the kernels' ratio there had median 0.854 and max 2.369. The
    layer-norm model's own null over its seeds 0-9
    (``--layer-norm-grad-seeds 0,...,9``; 560 ratios, same card; its
    second plain run takes the layer norm's statistics from
    ``torch.var_mean``, see ``_plain_block``) has max 2.119: 1.25 x 2.119
    <= 5, so the factor holds for it too; the kernels' ratio there had
    median 0.328 and max 1.678. The unpadded model's own null over its
    seeds 0-9 (``--unpadded-grad-seeds 0,...,9``; 400 ratios, same card)
    has max 3.386: 1.25 x 3.386 = 4.23 <= 5, so the factor holds for it
    as well; the kernels' ratio there had median 0.218 and max 2.286. The
    default seeds are other seeds.

    On a bf16 config the three runs compute in bf16 and each reference
    stays f64 (f32 compute of f64 inputs), held to BF16_REPLAY_FACTOR.
    Its reading (``--bf16-grad-seeds 0,...,9`` on the mini-ImageNet bf16
    model, padded and unpadded; 800 null ratios on an NVIDIA H100 80GB
    HBM3 at 700 W): null max 7.989 padded (seed 5
    lslr/conv0.conv.weight; p99 6.929, median 0.954) and 4.408 unpadded.
    By the rule above, fixed before that reading, the smallest integer at
    or above 1.25 x 7.989 = 9.99: 10. The plain bf16 runs are that far
    apart because each rounds after every op of the second derivative
    (a plain run's worst leaf reached 3.6x its reference's largest entry,
    seed 8); the kernels' ratio had median 0.293 and max 1.763 padded,
    median 0.512 and max 1.848 unpadded. The strided and the norm-first
    bf16 models, each on its own seeds 0-9 (``--strided-bf16-grad-seeds
    0,...,9 --norm-first-bf16-grad-seeds 0,...,9``; 400 and 560 null
    ratios, same card): the strided Omniglot model's null max 4.600
    (under 8: factor 10 stands; the kernels' ratio median 0.707, p90
    3.520, max 7.466), the norm-first mini-ImageNet model's 8.523 (seed 3
    lslr/conv1.conv.bias), so by the same rule its own factor, the
    smallest integer at or above 1.25 x 8.523 = 10.65: 11
    (``BF16_REPLAY_FACTORS``; the kernels' ratio median 0.532,
    max 3.588). The layer-norm mini-ImageNet bf16 model on its own seeds
    0-9 (``--layer-norm-bf16-grad-seeds 0,...,9``; 560 null ratios, same
    card; its fused run takes ``torch.var_mean``'s bf16 statistics, see
    ``_plain_block``): null max 2.608 (seed 2 lslr/conv0.conv.weight; p90
    1.305, median 0.894), under 8, so by the rule, fixed before that
    reading, factor 10 stands for it; the kernels' ratio median 0.760, p90
    1.464, max 3.019 (seed 9 lslr/conv1.conv.bias)."""
    import statistics

    cfg = cfg.replace(batch_size=2)
    orders = dict(norm_first=cfg.block_order == "norm_conv_relu",
                  layer_norm=cfg.norm_layer == "layer_norm")
    twopass = cfg.replace(bn_stats_impl="twopass")
    # the f64 reference computes in f64 whatever the runs' dtype
    reference = twopass.replace(compute_dtype="float32")
    factor = REPLAY_FACTOR
    if cfg.compute_dtype == "bfloat16":
        factor = BF16_REPLAY_FACTORS[(cfg.block_order, cfg.norm_layer)]
    runs = (("kernels", twopass, True), ("twopass", twopass, False),
            ("fused", cfg.replace(bn_stats_impl="fused"), False))
    start = time.perf_counter()
    ratios, null, failures, worst = [], [], [], {}
    for seed in seeds:
        batch = _batch(cfg, seed)
        flips = _decision_flips(twopass, cb, F, batch)
        errs, scales = {n: {} for n, _, _ in runs}, {}
        for order in range(GRAD_ORDERS):
            permuted = _image_order(batch, order)
            for name, c, kernels in runs:
                log = []
                block = (_recording_kernel_block(cb, log, **orders)
                         if kernels else _plain_block(F, log, **orders))
                loss, got = _grads(c, block, permuted)
                if kernels and order == 0:
                    _same_as_own(f"seed {seed} step", (loss, got),
                                 _grads(c, None, permuted))
                _, ref = _grads(reference, _plain_block(
                    F, log, replay=True, **orders), permuted,
                    torch.float64)
                for k, v in ref.items():
                    errs[name].setdefault(k, []).append(
                        (got[k].double() - v).abs().max().item())
                    scales[k] = max(scales.get(k, 0.0),
                                    v.abs().max().item())
                del got, ref
        scale = max(scales.values())
        med = {n: {k: statistics.median(v) for k, v in e.items()}
               for n, e in errs.items()}
        rel = {n: max(m[k] / scales[k] for k in m if scales[k] > 1e-6 * scale)
               for n, m in med.items()}
        print(f"  seed {seed}: first support forward, decisions unlike f64 "
              f"kernels {flips['kernels']} plain {flips['plain']}; worst "
              "leaf median max |err| / max |ref| " + ", ".join(
                  f"{n} {v:.2e}" for n, v in rel.items()), flush=True)
        for key in scales:
            k_err = med["kernels"][key]
            plain = max(med["twopass"][key], med["fused"][key])
            if scales[key] > 1e-6 * scale:
                ratio = k_err / plain if plain else 0.0
                ratios.append((ratio, seed, key))
                worst[key] = max(worst.get(key, 0.0), ratio)
                for n, others in (("twopass", ("kernels", "fused")),
                                  ("fused", ("kernels", "twopass"))):
                    den = max(med[o][key] for o in others)
                    null.append((med[n][key] / den if den else 0.0, seed,
                                 key))
            if k_err > factor * plain + GRADS_FLOOR * scale:
                failures.append(f"seed {seed} {key}")
    print("  per leaf, the worst kernels / larger plain median over the "
          "seeds: " + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()),
          flush=True)
    print(f"  kernels / larger plain median over {len(ratios)} nonzero "
          f"leaf-seeds: {_quantiles([r for r, _, _ in ratios])}; worst "
          + ", ".join(f"{r:.2f} (seed {s} {k})"
                      for r, s, k in sorted(ratios)[-3:]), flush=True)
    print(f"  null ratios, each plain median / the larger of the other two "
          f"runs', over {len(null)}: {_quantiles([r for r, _, _ in null])}; "
          "worst " + ", ".join(f"{r:.2f} (seed {s} {k})"
                               for r, s, k in sorted(null)[-3:])
          + f" (gate {factor:g}x + {GRADS_FLOOR:g} of the largest "
          f"entry; {time.perf_counter() - start:.1f} s)", flush=True)
    if failures:
        raise AssertionError("replayed-path meta-gradients: kernels further "
                             "from f64 than the plain ops allow at "
                             + ", ".join(failures))


def check_learning(config=FLAGSHIP, batch_size=2, extra=()):
    """Phase 5: 10 second-order steps on one fixed full-width batch at the
    config's meta LR (``extra``: a config override); the loss of the last
    step is below the first's. Returns train-bench's line."""
    from howtotrainyourmamlpytorch_tpu_torch import bench as train_bench

    line = train_bench.run([
        "--config", config, "--batch-size", str(batch_size), "--epoch", "0",
        "--warmup", "0", "--steps", "10", "--seed", "1", "--device",
        DEVICE] + list(extra))
    losses = line["loss"]
    print(f"  {config.split('/')[-1]} {' '.join(extra)}: 10 steps on one "
          f"batch of "
          f"{batch_size} at lr {line['lr']}: loss "
          f"{[round(v, 5) for v in losses]}, accuracy "
          f"{[round(v, 4) for v in line['accuracy']]}", flush=True)
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall over 10 steps")
    return line


def profile_train_step(cfg, batch_size=2, placement=None):
    """Phase 5: where a full-width second-order step spends its time:
    ``torch.profiler`` over one warm step, its batch the fixed one or one
    drawn through the data tier ``placement`` (host assembly and upload
    included)."""
    from torch.profiler import ProfilerActivity, profile

    from howtotrainyourmamlpytorch_tpu_torch import bench as train_bench
    from howtotrainyourmamlpytorch_tpu_torch.core import maml
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    cfg = cfg.replace(batch_size=batch_size)
    device = torch.device(DEVICE)
    if placement is not None:
        cfg = cfg.replace(use_mmap_cache=True, data_placement=placement)
    state = init_state(cfg, device=device, with_opt=True)
    lr, weights, _ = maml.epoch_schedule(cfg, 0)
    if placement is None:
        batch = train_bench.synth_batch(cfg, 0, device)
        step = maml.make_train_step(cfg, True)

        def run(state, i):
            return step(state, *batch, weights, lr)
    else:
        tier = train_bench._Tier(cfg, placement, True, 0, device)

        def run(state, i):
            return tier.run(state, tier.assemble(i), weights, lr)
    state, _ = run(state, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        state, _ = run(state, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    _profile_report(prof, wall_ms, f"profiled batch-{batch_size} train step"
                    f" ({placement or 'fixed batch'})")


def run_serve_bench(ks, cfg, ingest, config=FLAGSHIP,
                    name="mini-ImageNet 5-way 5-shot",
                    extra=("--store-rows", str(STORE_ROWS)), requests=16):
    """Phase 4, a serving main path: ``serve-bench`` at ``config`` (with
    the ``extra`` arguments) with ``ingest``, ``requests`` requests; every
    dispatch's launches equal ``expected_serve_launches`` of ``cfg`` and
    the run's totals (warmup included) equal it times the dispatches. The
    expected counts name every counter, so on a bf16 model, whose f32
    counters all expect 0, no f32 kernel may move. Returns (JSON line,
    launch counts)."""
    from howtotrainyourmamlpytorch_tpu_torch.serving import bench

    print(f"[serve] serve-bench --config {name} --requests {requests} "
          f"--seed 0 --ingest {ingest} {' '.join(extra)}", flush=True)
    ks.reset_launches()
    line = bench.run(["--config", config, "--requests", str(requests),
                      "--seed", "0", "--device", DEVICE, "--ingest", ingest]
                     + list(extra))
    counts = ks.launches()
    print(json.dumps(line), flush=True)
    expected = expected_serve_launches(cfg, ingest)
    for i, got in enumerate(line["kernel_launches_per_dispatch"]):
        if got != expected:
            raise AssertionError(
                f"{ingest} dispatch {i}: launches {got}, expected {expected}"
            )
    dispatches = line["dispatches"] + line["warmup_dispatches"]
    for k, per_dispatch in expected.items():
        if counts[k] != per_dispatch * dispatches:
            raise AssertionError(
                f"{k}: {counts[k]} launches over the {ingest} path, "
                f"expected {per_dispatch} x {dispatches} dispatches"
            )
    tps = line["tenants_per_sec"]
    if not (line["tenants"] == requests and tps and math.isfinite(tps)
            and line["ingest"] == ingest
            and line["max_pooling"] == cfg.max_pooling
            and line["block_order"] == cfg.block_order
            and line["norm_layer"] == cfg.norm_layer
            and line["conv_padding"] == cfg.conv_padding
            and line["dtype"] == cfg.compute_dtype):
        raise AssertionError(f"serve-bench line is incomplete: {line}")
    print(f"[serve] {name} {ingest}: tenants_per_sec {tps}  adapt_ms p50 "
          f"{line['adaptation_latency_ms_p50']}  p95 "
          f"{line['adaptation_latency_ms_p95']}  h2d_bytes_per_dispatch "
          f"{line['h2d_bytes_per_dispatch']}  launches {counts}", flush=True)
    return line, counts


def check_index_bit_identical(cfg, store_rows=STORE_ROWS):
    """Phase 4: one bucket-8 index-ingest dispatch (8 tenants, the config's
    shots, rows of a ``store_rows`` store) against the f32 dispatch fed the
    host-decoded pixels of the same rows (the port's host pipeline,
    ``decode_cached`` + ``augment_stack``), both on the kernels: preds and
    loss must be bit-identical, in every repetition. Every kernel is
    deterministic (no atomics), and the expansion is exact, so the two
    programs see the same inputs. The two ingests are then timed in turns
    (f32, index, index, f32, three times) on the same card."""
    import statistics

    import numpy as np

    from howtotrainyourmamlpytorch_tpu_torch.data.episodes import (
        augment_stack,
        decode_cached,
    )
    from howtotrainyourmamlpytorch_tpu_torch.serving import bench
    from howtotrainyourmamlpytorch_tpu_torch.serving.batcher import (
        AdaptRequest,
    )
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    store = bench._synth_store(cfg, store_rows, 3)
    shots, n = cfg.num_samples_per_class, cfg.num_classes_per_set
    group = bench._synth_groups(cfg, [shots], 36, 8, 5, "index",
                                store_rows)[-1]

    def host_pixels(rows):
        x = decode_cached(cfg, store[rows.reshape(-1)])
        x = augment_stack(cfg, x, 0, False)
        return np.ascontiguousarray(x, np.float32).reshape(
            rows.shape + cfg.im_shape)

    pixel_group = [AdaptRequest(
        support_x=host_pixels(r.support_idx),
        support_y=np.tile(np.arange(n, dtype=np.int32)[:, None], (1, shots)),
        query_x=host_pixels(r.query_idx),
        query_y=np.tile(np.arange(n, dtype=np.int32)[:, None],
                        (1, cfg.num_target_samples)),
        tenant_id=r.tenant_id) for r in group]
    state = init_state(cfg, device=DEVICE)
    engines = {
        "index": (ServingEngine(cfg, state, [shots], device=DEVICE,
                                ingest="index", store=store), group),
        "f32": (ServingEngine(cfg, state, [shots], device=DEVICE,
                              ingest="f32"), pixel_group)}
    # first dispatches warm up; then both in turns, f32, index, index, f32
    results = {name: [eng.serve_group(reqs)]
               for name, (eng, reqs) in engines.items()}
    for name in ("f32", "index", "index", "f32") * 3:
        eng, reqs = engines[name]
        results[name].append(eng.serve_group(reqs))
    index, f32 = results["index"][0], results["f32"][0]
    same = all(np.array_equal(a.preds, b.preds) and a.loss == b.loss
               for drs in zip(*results.values())
               for a, b in zip(drs[0].results, drs[1].results))
    for name, drs in results.items():
        times = sorted(d.adapt_ms for d in drs[1:])
        print(f"  bucket-8 {name:5s} dispatches in turns: adapt_ms median "
              f"{statistics.median(times):.3f} (min {times[0]:.3f}, max "
              f"{times[-1]:.3f}, {len(times)} dispatches)", flush=True)
    print(f"  bucket-{index.bucket} dispatch ({index.tenants} tenants): "
          f"index ingest ({index.ingest_bytes} B uploaded) vs f32 ingest "
          f"({f32.ingest_bytes} B) on the same pixels: preds and loss "
          f"bit-identical {same}; losses "
          f"{[r.loss for r in index.results[:3]]} ...", flush=True)
    if index.bucket != 8 or not same:
        raise AssertionError("index-ingest dispatch differs from the f32 "
                             "dispatch on the same pixels")

# -- bf16 serving -------------------------------------------------------------


def bf16_ulp(v):
    """The spacing of bf16 at each |v| (8 significant bits)."""
    _, e = torch.frexp(v.double().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float64), e - 8)


def within_ulp(name, got, want, ulps=None):
    """Phase 9's gate of the bf16 kernels that round f32 sums to bf16 (K1,
    K3, K4): |got - want| within ``ulps``
    (default one bf16 ulp of want) elementwise, or 1e-4 of max |want|
    where that is larger; returns max |got - want|."""
    if got.dtype != torch.bfloat16 or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}, "
                             f"expected bf16 {tuple(want.shape)}")
    diff = (got.double() - want.double()).abs()
    tol = bf16_ulp(want) if ulps is None else ulps
    tol = torch.clamp_min(tol, 1e-4 * want.double().abs().max().item())
    bad = int((diff > tol).sum())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {bad} elements beyond one bf16 ulp "
                             f"(max |kernel - twin| {diff.max().item():.3e})")
    return diff.max().item()


def check_bf16_kernels(cb, F, records, T=T_TENANTS, C=COUT):
    """Phase 9, the bf16 kernels at the bf16 model's four stages: K1 and
    K2 at N = 75 (the target forward), K3, dgrad (stages 1-3) and wgrad at
    N = 25 (the support backward), against their bf16 twins; timed beside
    the twin and the library call in bf16 (K4 on a random dy). Bound:
    2-byte elements, and the convs' products at the bf16 tensor-core rate
    (the least time the card needs for a bf16 product: K1, dgrad and wgrad
    multiply on the tensor cores). K1, dgrad and wgrad are held to a
    second launch bit for bit, timed with their device time."""
    randn = _randn(torch.Generator(device="cuda").manual_seed(9))
    bf = torch.bfloat16
    nn = torch.nn.functional
    for stage, hw, cin in BF16_STAGES:
        for n in (75, 25):
            label = f"bf16 T={T} {stage} N={n}"
            M = n * hw * hw
            x = randn(T, n, hw, hw, cin).to(bf)
            w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin)))
            w = w.to(bf)
            b = randn(T, C, scale=0.1).to(bf)
            gamma = (1.0 + randn(T, C, scale=0.1)).to(bf)
            beta = randn(T, C, scale=0.1).to(bf)
            got = cb.conv3x3_fwd_stats(x, w, b)
            _same_bits("conv3x3_fwd_stats_bf16",
                       lambda: cb.conv3x3_fwd_stats(x, w, b), got)
            y, mean, var, rstd = got
            del got
            want = F.conv3x3_fwd_stats(x, w, b)
            y_ulps = bf16_ulp(want[0]) + bf16_ulp(F.conv3x3(x, w))
            err = max([within_ulp("conv3x3_fwd_stats_bf16 y", y, want[0],
                                  y_ulps)]
                      + [within_ulp(f"conv3x3_fwd_stats_bf16 {what}", a, c)
                         for what, a, c in zip(("mean", "var", "rstd"),
                                               (mean, var, rstd), want[1:])])
            del y_ulps
            y, mean, _, rstd = want
            pooled, arg = cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
            pooled_p, arg_p = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
            if not (torch.equal(pooled, pooled_p)
                    and torch.equal(arg, arg_p)):
                raise AssertionError(f"bn_act_pool_fwd_bf16 @ {label}: not "
                                     "bit for bit its twin")
            _same_bits("bn_act_pool_fwd_bf16", lambda: cb.bn_act_pool_fwd(
                y, mean, rstd, gamma, beta), (pooled, arg))
            xl = _nchw_tenants(x)
            wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3)
            wl = wl.contiguous()
            if n == 75:
                yl = _nchw_tenants(y)
                flat = [v.reshape(-1).float() for v in (mean, var, gamma,
                                                        beta)]
                records.add(
                    "conv3x3_fwd_stats_bf16", label, err,
                    lambda: cb.conv3x3_fwd_stats(x, w, b),
                    lambda: F.conv3x3_fwd_stats(x, w, b),
                    lambda: nn.conv2d(xl, wl, b.reshape(-1), padding=1,
                                      groups=T),
                    2 * T * M * 9 * cin * C + T * M * C,
                    2 * (x.numel() + w.numel() + b.numel() + y.numel()
                         + 3 * T * C),
                    tensor_cores=True, device=MMA_STATS_DEVICE)
                records.add(
                    "bn_act_pool_fwd_bf16", label, 0.0,
                    lambda: cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta),
                    lambda: F.bn_act_pool_fwd(y, mean, rstd, gamma, beta),
                    lambda: nn.batch_norm(yl, flat[0], flat[1], flat[2],
                                          flat[3], False, 0.0, F.BN_EPS),
                    6 * y.numel() + 3 * pooled.numel(),
                    2 * (y.numel() + 4 * T * C) + 3 * pooled.numel(),
                    device=K2_DEVICE)
                print(f"  bf16 {stage} N=75: K2 equal to its twin bit for "
                      f"bit; {_window_ties(F, y, mean, rstd, gamma, beta)} "
                      "pool windows hold an exact tie at their maximum",
                      flush=True)
                del yl
                continue
            dp = randn(*pooled.shape, scale=1.0 / math.sqrt(pooled.numel()))
            _check_bf16_k3(cb, F, records, label, dp.to(bf), arg, y, mean,
                           rstd, gamma, beta)
            # K4 takes a random dy: K3's sums to zero over each channel
            # (batch norm's backward), so its db would be rounding noise,
            # which no gate relative to the output can judge
            dy = randn(*y.shape).to(bf)
            dyl = _nchw_tenants(dy)
            if cin == C:
                dx = cb.conv3x3_dgrad(dy, w)
                err = within_ulp("conv3x3_dgrad_bf16", dx,
                                 F.conv3x3_dgrad(dy, w))
                _same_bits("conv3x3_dgrad_bf16",
                           lambda: cb.conv3x3_dgrad(dy, w), dx)
                del dx
                records.add(
                    "conv3x3_dgrad_bf16", label, err,
                    lambda: cb.conv3x3_dgrad(dy, w),
                    lambda: F.conv3x3_dgrad(dy, w),
                    lambda: torch.nn.grad.conv2d_input(
                        xl.shape, wl, dyl, padding=1, groups=T),
                    2 * T * M * 9 * cin * C,
                    2 * (dy.numel() + w.numel() + x.numel()),
                    tensor_cores=True, device=MMA_DEVICE)
            dw, db = cb.conv3x3_wgrad(x, dy)
            dw_p, db_p = F.conv3x3_wgrad(x, dy)
            err = max(within_ulp("conv3x3_wgrad_bf16 dw", dw, dw_p),
                      within_ulp("conv3x3_wgrad_bf16 db", db, db_p))
            _same_bits("conv3x3_wgrad_bf16", lambda: cb.conv3x3_wgrad(x, dy),
                       (dw, db))
            records.add(
                "conv3x3_wgrad_bf16", label, err,
                lambda: cb.conv3x3_wgrad(x, dy),
                lambda: F.conv3x3_wgrad(x, dy),
                lambda: torch.nn.grad.conv2d_weight(
                    xl, wl.shape, dyl, padding=1, groups=T),
                2 * T * M * 9 * cin * C + T * M * C,
                2 * (x.numel() + dy.numel() + dw.numel() + db.numel()),
                tensor_cores=True, device=WGRAD_MMA_DEVICE)
            del x, y, pooled, pooled_p, dy, dyl, xl, want
            torch.cuda.empty_cache()


def _check_bf16_k3(cb, F, records, label, dp, arg, y, mean, rstd, gamma,
                   beta):
    """K3 pooled in bf16 (csrc/bn_act_pool_bwd.cu) on these inputs: dy,
    dgamma and dbeta within one bf16 ulp of the twin (sums f32 in both,
    each output rounded once), a second launch bit for bit the first,
    timed beside the twin and the f32 kernel with its device time."""
    args = (dp, arg, y, mean, rstd, gamma, beta)
    got = cb.bn_act_pool_bwd(*args)
    err = max(within_ulp(f"bn_act_pool_bwd_bf16 {what} @ {label}", a, c)
              for what, a, c in zip(("dy", "dgamma", "dbeta"), got,
                                    F.bn_act_pool_bwd(*args)))
    _same_bits("bn_act_pool_bwd_bf16", lambda: cb.bn_act_pool_bwd(*args),
               got)
    args32 = tuple(t if t.dtype == torch.uint8 else t.float() for t in args)
    T, C = y.shape[0], y.shape[-1]
    records.add(
        "bn_act_pool_bwd_bf16", label, err,
        lambda: cb.bn_act_pool_bwd(*args),
        lambda: F.bn_act_pool_bwd(*args), None,
        10 * y.numel() + 6 * dp.numel(),
        2 * (dp.numel() + 2 * y.numel() + 6 * T * C) + arg.numel(),
        f32_fn=lambda: cb.bn_act_pool_bwd(*args32), device=K3_BF16_DEVICE)


def check_bf16_k3_shapes(cb, F, records):
    """Phase 9, K3 pooled in bf16 beyond the bf16 model's T = 8 stages
    (``check_bf16_kernels``): at T = 2 (the training batch) at the four
    mini-ImageNet stages, at the unpadded model's odd conv outputs
    (82/39/17/6, T = 8; the pool drops the last row and column of 39 and
    17) and at Omniglot's four layers (28/14/7/3, 64 channels, N = 20; the
    pool drops a row and a column at 7 and 3). Inputs: a random bf16 conv
    output, its bf16 statistics, K2's argmax of it, a random pooled
    gradient."""
    randn = _randn(torch.Generator(device="cuda").manual_seed(43))
    bf = torch.bfloat16
    cases = ([("bf16", 2, 25, hw, COUT, stage)
              for stage, hw, _ in BF16_STAGES]
             + [("bf16 unpadded", T_TENANTS, 25, hw, COUT, stage)
                for stage, hw in (("stage0", 82), ("stage1", 39),
                                  ("stage2", 17), ("stage3", 6))]
             + [("bf16 omniglot", T_TENANTS, OMNIGLOT_IMAGES, hw,
                 OMNIGLOT_COUT, layer)
                for layer, hw in (("layer1", 28), ("layer2", 14),
                                  ("layer3", 7), ("layer4", 3))])
    for model, T, n, hw, C, where in cases:
        label = f"{model} T={T} {where} N={n}"
        y = (randn(T, n, hw, hw, C) + 0.3).to(bf)
        mean, _, rstd = F.bn_stats(y)
        gamma = (1.0 + randn(T, C, scale=0.1)).to(bf)
        beta = randn(T, C, scale=0.1).to(bf)
        pooled, arg = cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
        dp = randn(*pooled.shape, scale=1.0 / math.sqrt(pooled.numel()))
        _check_bf16_k3(cb, F, records, label, dp.to(bf), arg, y, mean, rstd,
                       gamma, beta)
        del y, pooled, arg, dp
        torch.cuda.empty_cache()


def _bf16_conv_lib(x, w, b, T, cin, C, padding, stride=1):
    """The grouped ``F.conv2d`` of the tenants' convs in x's dtype (the
    library call beside K1), on its NCHW copies."""
    xl = _nchw_tenants(x)
    wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3).contiguous()
    bl = None if b is None else b.reshape(-1).contiguous()
    return xl, wl, lambda: torch.nn.functional.conv2d(
        xl, wl, bl, stride=stride, padding=padding, groups=T)


def check_bf16_train_kernels(cb, F, records, T=T_TENANTS, C=COUT):
    """Phase 9, the bf16 kernels second-order training adds: K1's
    stats-free mode (``conv3x3_fwd_bf16``; Dgrad's backward without a
    bias, Wgrad's with one) at the four bf16 stages, N = 25, and at the
    four Omniglot layers (cin 1 at layer 1, 64 filters, N = 20); K5
    (``bn_act_pool_bwd_bwd_bf16``) at the same stages and layers, on
    random bf16 cotangents (K3's own dy sums to zero per channel, so the
    path's would leave the g_gamma term rounding noise); wgrad at the
    Omniglot layers on a random dy (the mini stages' are phase 9's); and the
    unpadded bf16 model's convs at pad 0 (``conv3x3_p0_*_bf16``: K1 with
    statistics at N = 75, stats-free, dgrad at stages 1-3 and wgrad at N =
    25) at ``UNPADDED_STAGES``. Each within one bf16 ulp of its bf16 twin
    elementwise (y of a conv with a bias: one ulp of the sum and one of
    the bias add), or 1e-4 of the output's scale (``within_ulp``); timed
    beside the twin and the library call (grouped ``F.conv2d``,
    ``conv2d_input``, ``conv2d_weight`` in bf16; K5 has none). Bound:
    2-byte elements, the convs' products at the bf16 tensor-core rate."""
    randn = _randn(torch.Generator(device="cuda").manual_seed(19))
    bf = torch.bfloat16
    grad = torch.nn.grad
    models = (("", BF16_STAGES, 25, C),
              ("omniglot ", OMNIGLOT_LAYERS, OMNIGLOT_IMAGES, OMNIGLOT_COUT))
    for prefix, stages, n, cout in models:
        for stage, hw, cin in stages:
            label = f"bf16 {prefix}T={T} {stage} N={n}"
            M = n * hw * hw
            x = randn(T, n, hw, hw, cin).to(bf)
            w = randn(T, 3, 3, cin, cout,
                      scale=math.sqrt(2.0 / (9 * cin))).to(bf)
            b = randn(T, cout, scale=0.1).to(bf)
            plain = F.conv3x3(x, w)
            for bias in (None, b):
                want = F.conv3x3(x, w, bias)
                ulps = (bf16_ulp(want) if bias is None
                        else bf16_ulp(want) + bf16_ulp(plain))
                got = cb.conv3x3_fwd(x, w, bias)
                err = within_ulp("conv3x3_fwd_bf16", got, want, ulps)
                _same_bits("conv3x3_fwd_bf16",
                           lambda: cb.conv3x3_fwd(x, w, bias), got)
                del got
                _, _, lib = _bf16_conv_lib(x, w, bias, T, cin, cout, 1)
                records.add(
                    "conv3x3_fwd_bf16",
                    label + ("" if bias is None else " bias"), err,
                    lambda: cb.conv3x3_fwd(x, w, bias),
                    lambda: F.conv3x3(x, w, bias), lib,
                    2 * T * M * 9 * cin * cout
                    + (0 if bias is None else T * M * cout),
                    2 * (x.numel() + w.numel() + want.numel()
                         + (0 if bias is None else b.numel())),
                    tensor_cores=True, device=MMA_DEVICE)
                del want, ulps
            # K5 at the K2 decisions of this conv's output
            gamma = (1.0 + randn(T, cout, scale=0.1)).to(bf)
            beta = randn(T, cout, scale=0.1).to(bf)
            y, mean, _, rstd = F.conv3x3_fwd_stats(x, w, b)
            pooled, arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
            args = (randn(*y.shape).to(bf), randn(T, cout).to(bf),
                    randn(T, cout).to(bf), randn(*pooled.shape).to(bf), arg,
                    y, mean, rstd, gamma, beta)
            got = cb.bn_act_pool_bwd_bwd(*args)
            err = max(within_ulp(f"bn_act_pool_bwd_bwd_bf16 {what}", g, p)
                      for what, g, p in zip(
                          ("g_dpooled", "g_y", "g_gamma"), got,
                          F.bn_act_pool_bwd_bwd(*args)))
            _same_bits("bn_act_pool_bwd_bwd_bf16",
                       lambda: cb.bn_act_pool_bwd_bwd(*args), got)
            del got
            args32 = tuple(t if t.dtype == torch.uint8 else t.float()
                           for t in args)
            # as f32's K5: ~42 FLOPs per element of y, each input read and
            # each output written once, in 2-byte elements
            records.add(
                "bn_act_pool_bwd_bwd_bf16", label, err,
                lambda: cb.bn_act_pool_bwd_bwd(*args),
                lambda: F.bn_act_pool_bwd_bwd(*args), None,
                42 * y.numel(),
                2 * (3 * y.numel() + 2 * pooled.numel() + 7 * T * cout)
                + arg.numel(),
                f32_fn=lambda: cb.bn_act_pool_bwd_bwd(*args32),
                device=K5_DEVICE)
            if prefix:
                dy = randn(*y.shape).to(bf)
                dw, db = cb.conv3x3_wgrad(x, dy)
                dw_p, db_p = F.conv3x3_wgrad(x, dy)
                err = max(within_ulp("conv3x3_wgrad_bf16 dw", dw, dw_p),
                          within_ulp("conv3x3_wgrad_bf16 db", db, db_p))
                _same_bits("conv3x3_wgrad_bf16",
                           lambda: cb.conv3x3_wgrad(x, dy), (dw, db))
                xl, wl, _ = _bf16_conv_lib(x, w, None, T, cin, cout, 1)
                dyl = _nchw_tenants(dy)
                records.add(
                    "conv3x3_wgrad_bf16", label, err,
                    lambda: cb.conv3x3_wgrad(x, dy),
                    lambda: F.conv3x3_wgrad(x, dy),
                    lambda: grad.conv2d_weight(xl, wl.shape, dyl, padding=1,
                                               groups=T),
                    2 * T * M * 9 * cin * cout + T * M * cout,
                    2 * (x.numel() + dy.numel() + dw.numel() + db.numel()),
                    tensor_cores=True, device=WGRAD_MMA_DEVICE)
                del dy, dyl, xl, wl, dw, db, dw_p, db_p
            del x, y, pooled, arg, args, plain
            torch.cuda.empty_cache()
    # the unpadded bf16 model's convs at pad 0
    for stage, hw, cin in UNPADDED_STAGES:
        x75 = randn(T, 75, hw, hw, cin).to(bf)
        w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin))).to(bf)
        b = randn(T, C, scale=0.1).to(bf)
        label = f"bf16 unpadded T={T} {stage} N=75"
        ho = hw - 2
        want = F.conv3x3_fwd_stats(x75, w, b, padding=0)
        got = cb.conv3x3_fwd_stats(x75, w, b, padding=0)
        _same_bits("conv3x3_p0_fwd_stats_bf16",
                   lambda: cb.conv3x3_fwd_stats(x75, w, b, padding=0), got)
        y_ulps = bf16_ulp(want[0]) + bf16_ulp(F.conv3x3(x75, w, padding=0))
        err = max([within_ulp("conv3x3_p0_fwd_stats_bf16 y", got[0], want[0],
                              y_ulps)]
                  + [within_ulp(f"conv3x3_p0_fwd_stats_bf16 {what}", a, c)
                     for what, a, c in zip(("mean", "var", "rstd"), got[1:],
                                           want[1:])])
        del got, want, y_ulps
        _, _, lib = _bf16_conv_lib(x75, w, b, T, cin, C, 0)
        M = 75 * ho * ho
        records.add(
            "conv3x3_p0_fwd_stats_bf16", label, err,
            lambda: cb.conv3x3_fwd_stats(x75, w, b, padding=0),
            lambda: F.conv3x3_fwd_stats(x75, w, b, padding=0), lib,
            2 * T * M * 9 * cin * C + T * M * C,
            2 * (x75.numel() + w.numel() + b.numel() + T * M * C + 3 * T * C),
            tensor_cores=True, device=MMA_STATS_DEVICE)
        del x75, lib
        torch.cuda.empty_cache()
        x = randn(T, 25, hw, hw, cin).to(bf)
        label = f"bf16 unpadded T={T} {stage} N=25"
        M = 25 * ho * ho
        want = F.conv3x3(x, w, padding=0)
        got = cb.conv3x3_fwd(x, w, padding=0)
        err = within_ulp("conv3x3_p0_fwd_bf16", got, want)
        _same_bits("conv3x3_p0_fwd_bf16",
                   lambda: cb.conv3x3_fwd(x, w, padding=0), got)
        del got
        xl, wl, lib = _bf16_conv_lib(x, w, None, T, cin, C, 0)
        records.add(
            "conv3x3_p0_fwd_bf16", label, err,
            lambda: cb.conv3x3_fwd(x, w, padding=0),
            lambda: F.conv3x3(x, w, padding=0), lib,
            2 * T * M * 9 * cin * C,
            2 * (x.numel() + w.numel() + want.numel()), tensor_cores=True,
            device=MMA_DEVICE)
        # K4 on a random dy
        dy = randn(*want.shape).to(bf)
        dyl = _nchw_tenants(dy)
        hw2 = (hw, hw)
        if cin == C:
            dx = cb.conv3x3_dgrad(dy, w, 1, hw2, 0)
            err = within_ulp("conv3x3_p0_dgrad_bf16", dx,
                             F.conv3x3_dgrad(dy, w, 1, hw2, 0))
            _same_bits("conv3x3_p0_dgrad_bf16",
                       lambda: cb.conv3x3_dgrad(dy, w, 1, hw2, 0), dx)
            del dx
            records.add(
                "conv3x3_p0_dgrad_bf16", label, err,
                lambda: cb.conv3x3_dgrad(dy, w, 1, hw2, 0),
                lambda: F.conv3x3_dgrad(dy, w, 1, hw2, 0),
                lambda: grad.conv2d_input(xl.shape, wl, dyl, padding=0,
                                          groups=T),
                2 * T * M * 9 * cin * C,
                2 * (dy.numel() + w.numel() + x.numel()), tensor_cores=True,
                device=MMA_DEVICE)
        dw, db = cb.conv3x3_wgrad(x, dy, padding=0)
        dw_p, db_p = F.conv3x3_wgrad(x, dy, padding=0)
        err = max(within_ulp("conv3x3_p0_wgrad_bf16 dw", dw, dw_p),
                  within_ulp("conv3x3_p0_wgrad_bf16 db", db, db_p))
        _same_bits("conv3x3_p0_wgrad_bf16",
                   lambda: cb.conv3x3_wgrad(x, dy, padding=0), (dw, db))
        records.add(
            "conv3x3_p0_wgrad_bf16", label, err,
            lambda: cb.conv3x3_wgrad(x, dy, padding=0),
            lambda: F.conv3x3_wgrad(x, dy, padding=0),
            lambda: grad.conv2d_weight(xl, wl.shape, dyl, padding=0,
                                       groups=T),
            2 * T * M * 9 * cin * C + T * M * C,
            2 * (x.numel() + dy.numel() + dw.numel() + db.numel()),
            tensor_cores=True, device=WGRAD_MMA_DEVICE)
        del x, want, dy, dyl, xl, dw, db, dw_p, db_p
        torch.cuda.empty_cache()


def _f32(*tensors):
    """f32 copies of bf16 tensors: the f32 kernel's inputs at the same
    shape, timed beside the bf16 kernel."""
    return tuple(t.float() for t in tensors)


def _equal(name, got, want):
    """A kernel that must equal its twin bit for bit; returns 0.0."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    if not all(g.dtype == p.dtype and torch.equal(g, p)
               for g, p in zip(got, want)):
        raise AssertionError(f"{name}: not bit for bit its twin")
    return 0.0


def _bf16_conv_s2(cb, F, records, randn, label, x, w, b, padding):
    """The stride-2 conv kernels in bf16 on ``x`` (K1 with statistics when
    ``b`` is given, else the stats-free mode with and without a bias and
    K4 on a random dy, dgrad back to cin 1 and 3 too: the norm-first
    models'): each within one bf16 ulp of its twin (y: one of the sum and
    one of the bias add), K1 and dgrad held twice bit for bit, dx's rows
    and columns that no output reads zero, each timed beside the twin, the
    f32 kernel and the bf16 library call."""
    rec, bf, nn = records.add, torch.bfloat16, torch.nn
    T, n, hw, _, cin = x.shape
    C = w.shape[-1]
    tag = "_s2" if padding else "_s2_p0"
    ho = (hw + 2 * padding - 3) // 2 + 1
    M = n * ho * ho
    flops = 2 * T * M * 9 * cin * C
    x32, w32 = _f32(x, w)
    plain = F.conv3x3(x, w, stride=2, padding=padding)
    xl, wl, lib = _bf16_conv_lib(x, w, b, T, cin, C, padding, 2)
    if b is not None:
        b32 = b.float()
        got = cb.conv3x3_fwd_stats(x, w, b, stride=2, padding=padding)
        want = F.conv3x3_fwd_stats(x, w, b, stride=2, padding=padding)
        name = f"conv3x3{tag}_fwd_stats_bf16"
        err = max([within_ulp(f"{name} y", got[0], want[0],
                              bf16_ulp(want[0]) + bf16_ulp(plain))]
                  + [within_ulp(f"{name} {what}", a, c) for what, a, c in
                     zip(("mean", "var", "rstd"), got[1:], want[1:])])
        _same_bits(name, lambda: cb.conv3x3_fwd_stats(
            x, w, b, stride=2, padding=padding), got)
        rec(name, label, err,
            lambda: cb.conv3x3_fwd_stats(x, w, b, stride=2, padding=padding),
            lambda: F.conv3x3_fwd_stats(x, w, b, stride=2, padding=padding),
            lib, flops + T * M * C,
            2 * (x.numel() + w.numel() + b.numel() + T * M * C + 3 * T * C),
            tensor_cores=True, f32_fn=lambda: cb.conv3x3_fwd_stats(
                x32, w32, b32, stride=2, padding=padding))
        return want
    name = f"conv3x3{tag}_fwd_bf16"
    bias = randn(T, C, scale=0.1).to(bf)
    for bb in (None, bias):
        want = F.conv3x3(x, w, bb, stride=2, padding=padding)
        ulps = bf16_ulp(want) + (0 if bb is None else bf16_ulp(plain))
        got = cb.conv3x3_fwd(x, w, bb, 2, padding)
        err = within_ulp(name, got, want, ulps)
        _same_bits(name, lambda: cb.conv3x3_fwd(x, w, bb, 2, padding), got)
        bb32 = None if bb is None else bb.float()
        rec(name, label + ("" if bb is None else " bias"), err,
            lambda: cb.conv3x3_fwd(x, w, bb, 2, padding),
            lambda: F.conv3x3(x, w, bb, stride=2, padding=padding),
            _bf16_conv_lib(x, w, bb, T, cin, C, padding, 2)[2],
            flops + (0 if bb is None else T * M * C),
            2 * (x.numel() + w.numel() + T * M * C
                 + (0 if bb is None else bb.numel())),
            tensor_cores=True,
            f32_fn=lambda: cb.conv3x3_fwd(x32, w32, bb32, 2, padding))
    # K4 on a random dy (K3's sums to zero per channel)
    dy = randn(T, n, ho, ho, C).to(bf)
    dy32, dyl = dy.float(), _nchw_tenants(dy)
    hw2 = (hw, hw)
    name = f"conv3x3{tag}_dgrad_bf16"
    dx = cb.conv3x3_dgrad(dy, w, 2, hw2, padding)
    err = within_ulp(name, dx, F.conv3x3_dgrad(dy, w, 2, hw2, padding))
    _same_bits(name, lambda: cb.conv3x3_dgrad(dy, w, 2, hw2, padding), dx)
    if padding == 0 and hw % 2 == 0 and (dx[:, :, -1].any()
                                         or dx[:, :, :, -1].any()):
        raise AssertionError(f"{name}: the unread last row has a gradient")
    rec(name, label, err,
        lambda: cb.conv3x3_dgrad(dy, w, 2, hw2, padding),
        lambda: F.conv3x3_dgrad(dy, w, 2, hw2, padding),
        lambda: nn.grad.conv2d_input(xl.shape, wl, dyl, stride=2,
                                     padding=padding, groups=T),
        flops, 2 * (dy.numel() + w.numel() + x.numel()),
        tensor_cores=True,
        f32_fn=lambda: cb.conv3x3_dgrad(dy32, w32, 2, hw2, padding))
    del dx
    name = f"conv3x3{tag}_wgrad_bf16"
    got = cb.conv3x3_wgrad(x, dy, 2, padding)
    want = F.conv3x3_wgrad(x, dy, 2, padding)
    err = max(within_ulp(f"{name} dw", got[0], want[0]),
              within_ulp(f"{name} db", got[1], want[1]))
    _same_bits(name, lambda: cb.conv3x3_wgrad(x, dy, 2, padding), got)
    rec(name, label, err, lambda: cb.conv3x3_wgrad(x, dy, 2, padding),
        lambda: F.conv3x3_wgrad(x, dy, 2, padding),
        lambda: nn.grad.conv2d_weight(xl, wl.shape, dyl, stride=2,
                                      padding=padding, groups=T),
        flops + T * M * C,
        2 * (x.numel() + dy.numel() + w.numel() + T * C), tensor_cores=True,
        f32_fn=lambda: cb.conv3x3_wgrad(x32, dy32, 2, padding),
        device=S2_WGRAD_DEVICE)
    return None


def _gap_bwd_library(g, act):
    """One PyTorch call that computes the GAP's backward of the (T, N, C)
    cotangent ``g`` for ``act`` (T, N, h, w, C):
    ``aten._adaptive_avg_pool2d_backward`` on the tenants' images as a
    channels-last (T * N, C, h, w) batch (views, no copy)."""
    T, n, h, w, C = act.shape
    view = act.reshape(T * n, h, w, C).permute(0, 3, 1, 2)
    grad = g.reshape(T * n, C, 1, 1)
    return lambda: torch.ops.aten._adaptive_avg_pool2d_backward(grad, view)


def _bf16_gap(cb, F, records, randn, label, act, record=True):
    """The GAP's forward and backward in bf16 on ``act`` (T, N, h, w, C):
    each equal to its twin bit for bit, timed beside the twin, the f32
    kernel and, for the forward, ``mean``."""
    T, n, h, w, C = act.shape
    g = randn(T, n, C).to(torch.bfloat16)
    act32, g32 = _f32(act, g)
    for name, fn, twin in (
            ("global_avg_pool2d_fwd_bf16",
             lambda: cb.global_avg_pool2d_fwd(act),
             F.global_avg_pool2d(act)),
            ("global_avg_pool2d_bwd_bf16",
             lambda: cb.global_avg_pool2d_bwd(g, h, w),
             F.global_avg_pool2d_bwd(g, h, w))):
        got = fn()
        _equal(name, got, twin)
        _same_bits(name, fn, got)
    print(f"  GAP bf16 forward and backward @ {label} ({h}x{w}): equal to "
          "their twins bit for bit, twice", flush=True)
    if not record:
        return
    records.add("global_avg_pool2d_fwd_bf16", label, 0.0,
                lambda: cb.global_avg_pool2d_fwd(act),
                lambda: F.global_avg_pool2d(act),
                lambda: act.mean(dim=(-3, -2)), act.numel(),
                2 * (act.numel() + T * n * C),
                f32_fn=lambda: cb.global_avg_pool2d_fwd(act32),
                device=GAP_FWD_DEVICE)
    records.add("global_avg_pool2d_bwd_bf16", label, 0.0,
                lambda: cb.global_avg_pool2d_bwd(g, h, w),
                lambda: F.global_avg_pool2d_bwd(g, h, w),
                _gap_bwd_library(g, act), act.numel(),
                2 * (act.numel() + g.numel()),
                f32_fn=lambda: cb.global_avg_pool2d_bwd(g32, h, w),
                device=GAP_BWD_DEVICE)


def check_bf16_strided_kernels(cb, F, records, T=T_TENANTS,
                               n=OMNIGLOT_IMAGES, C=OMNIGLOT_COUT):
    """Phase 10, the strided models' kernels in bf16: at the strided
    Omniglot model's four layers (T = 8, N = 20, cout 64) K1 at stride 2
    with statistics and stats-free (with and without the bias), the
    pool-free K2 (bit for bit), K3 on a random da, K5 on random cotangents
    (7 -> 4 at layer 3: the odd map with pad 1 at stride 2), dgrad (layers
    2-4) and wgrad at stride 2 on a random dy, and the GAP's forward and
    backward (bit for bit) at layer 4; then the unpadded strided model's
    pad-0 stride-2 convs at its four mini-ImageNet stages (K1 with
    statistics at N = 75; stats-free, dgrad at stages 1-3 and wgrad at N =
    25) and the GAP on its 4x4 output. Each against its bf16 twin
    (``within_ulp``, or equal), timed beside the twin, the f32 kernel at
    the same shape and the library call in bf16 (grouped ``conv2d`` /
    ``conv2d_input`` / ``conv2d_weight`` at stride 2, ``F.batch_norm``
    given statistics, ``mean``). Bound: 2-byte elements, the convs'
    products at the bf16 tensor-core rate."""
    rec = records.add
    randn = _randn(torch.Generator(device="cuda").manual_seed(29))
    bf = torch.bfloat16
    for layer, hw, cin in STRIDED_LAYERS:
        label = f"bf16 strided T={T} {layer} N={n}"
        x = randn(T, n, hw, hw, cin).to(bf)
        w = randn(T, 3, 3, cin, C, scale=math.sqrt(2.0 / (9 * cin))).to(bf)
        b = randn(T, C, scale=0.1).to(bf)
        gamma = (1.0 + randn(T, C, scale=0.1)).to(bf)
        beta = randn(T, C, scale=0.1).to(bf)
        y, mean, var, rstd = _bf16_conv_s2(cb, F, records, randn, label, x,
                                           w, b, 1)
        _bf16_conv_s2(cb, F, records, randn, label, x, w, None, 1)
        # the pool-free K2, K3 and K5 on K1's output
        bn = (y, mean, rstd, gamma, beta)
        bn32 = _f32(*bn)
        act = cb.bn_act_fwd(*bn)
        _same_bits("bn_act_fwd_bf16", lambda: cb.bn_act_fwd(*bn), act)
        yl = _nchw_tenants(y)
        flat = [v.reshape(-1).float() for v in (mean, var, gamma, beta)]
        rec("bn_act_fwd_bf16", label,
            _equal("bn_act_fwd_bf16", act, F.bn_act_fwd(*bn)),
            lambda: cb.bn_act_fwd(*bn), lambda: F.bn_act_fwd(*bn),
            lambda: torch.nn.functional.batch_norm(
                yl, flat[0], flat[1], flat[2], flat[3], False, 0.0,
                F.BN_EPS),
            6 * y.numel(), 2 * (2 * y.numel() + 4 * T * C),
            f32_fn=lambda: cb.bn_act_fwd(*bn32), device=K2_FREE_DEVICE)
        da = randn(*y.shape).to(bf)
        da32 = da.float()
        got = cb.bn_act_bwd(da, *bn)
        err = max(within_ulp(f"bn_act_bwd_bf16 {what}", a, c)
                  for what, a, c in zip(("dy", "dgamma", "dbeta"), got,
                                        F.bn_act_bwd(da, *bn)))
        _same_bits("bn_act_bwd_bf16", lambda: cb.bn_act_bwd(da, *bn), got)
        del got
        rec("bn_act_bwd_bf16", label, err, lambda: cb.bn_act_bwd(da, *bn),
            lambda: F.bn_act_bwd(da, *bn), None, 16 * y.numel(),
            2 * (3 * y.numel() + 6 * T * C),
            f32_fn=lambda: cb.bn_act_bwd(da32, *bn32),
            device=K3_FREE_DEVICE)
        args = (randn(*y.shape).to(bf), randn(T, C).to(bf),
                randn(T, C).to(bf), da, *bn)
        args32 = _f32(*args)
        got = cb.bn_act_bwd_bwd(*args)
        err = max(within_ulp(f"bn_act_bwd_bwd_bf16 {what}", a, c)
                  for what, a, c in zip(("g_da", "g_y", "g_gamma"), got,
                                        F.bn_act_bwd_bwd(*args)))
        _same_bits("bn_act_bwd_bwd_bf16", lambda: cb.bn_act_bwd_bwd(*args),
                   got)
        del got
        rec("bn_act_bwd_bwd_bf16", label, err,
            lambda: cb.bn_act_bwd_bwd(*args),
            lambda: F.bn_act_bwd_bwd(*args), None, 42 * y.numel(),
            2 * (5 * y.numel() + 7 * T * C),
            f32_fn=lambda: cb.bn_act_bwd_bwd(*args32),
            device=K5_FREE_DEVICE)
        if layer == STRIDED_LAYERS[-1][0]:
            _bf16_gap(cb, F, records, randn, label, act)
        del x, y, act, yl, da, args, args32
        torch.cuda.empty_cache()
    # the unpadded strided model's pad-0 stride-2 convs
    for stage, hw, cin in UNPADDED_STRIDED_STAGES:
        w = randn(T, 3, 3, cin, COUT, scale=math.sqrt(2.0 / (9 * cin))).to(bf)
        b = randn(T, COUT, scale=0.1).to(bf)
        x = randn(T, 75, hw, hw, cin).to(bf)
        y, mean, _, rstd = _bf16_conv_s2(
            cb, F, records, randn, f"bf16 unpadded strided T={T} {stage} N=75",
            x, w, b, 0)
        if stage == UNPADDED_STRIDED_STAGES[-1][0]:
            ones = torch.ones(T, COUT, device="cuda", dtype=bf)
            _bf16_gap(cb, F, records, randn,
                      f"bf16 unpadded strided T={T} {stage} N=75",
                      F.bn_act_fwd(y, mean, rstd, ones, 0 * ones))
        del x, y
        x = randn(T, 25, hw, hw, cin).to(bf)
        _bf16_conv_s2(cb, F, records, randn,
                      f"bf16 unpadded strided T={T} {stage} N=25", x, w,
                      None, 0)
        del x
        torch.cuda.empty_cache()


def check_bf16_norm_first_kernels(cb, F, records, T=T_TENANTS):
    """Phase 10, the norm-first block's kernels in bf16 at the
    mini-ImageNet model's four stages (T = 8; the forward kernels at N =
    75, the backward ones at N = 25): ``bn_input_stats`` (pixels in [0, 1]
    at stage 0, 3 channels), ``batch_norm_fwd`` (bit for bit),
    ``act_pool_fwd`` (bit for bit, and the exact ties its windows hold),
    ``batch_norm_bwd`` on a random dz, ``batch_norm_bwd_bwd`` on random
    cotangents, ``act_pool_bwd`` / ``act_pool_gather`` (bit for bit) and
    dgrad back to cin 3 on a random dy; then what the strided norm-first
    Omniglot model adds: ``act_fwd`` / ``act_bwd`` (bit for bit) on the
    conv outputs of its four layers, the statistics of each layer's input
    (the image, C = 1, then 64 channels), and at layer 1 the stride-2
    dgrad back to the image (cin 1); and the statistics at the unpadded
    norm-first models' block inputs (``UNPADDED_NORM_FIRST``) and the
    act-pool kernels at the unpadded conv outputs (its twin's bits, held
    twice). Each against its bf16 twin, timed beside the twin, the f32
    kernel at the same shape and the library call in bf16 where one
    computes the same function (``torch.var_mean``, ``F.batch_norm`` given
    statistics, ``F.leaky_relu``, ``aten.leaky_relu_backward``,
    ``conv2d_input``)."""
    rec = records.add
    randn = _randn(torch.Generator(device="cuda").manual_seed(31))
    bf = torch.bfloat16
    nnf = torch.nn.functional
    C = COUT
    for stage, hw, cin in NORM_FIRST_STAGES:
        for n in IMAGES:
            label = f"bf16 norm-first T={T} {stage} N={n}"
            x = (torch.rand(T, n, hw, hw, cin, device="cuda") if cin == 3
                 else randn(T, n, hw, hw, cin)).to(bf)
            gamma = (1.0 + randn(T, cin, scale=0.1)).to(bf)
            beta = randn(T, cin, scale=0.1).to(bf)
            mean, var, rstd = F.bn_input_stats(x)
            bn = (x, mean, rstd, gamma, beta)
            bn32 = _f32(*bn)
            w = randn(T, 3, 3, cin, C,
                      scale=math.sqrt(2.0 / (9 * cin))).to(bf)
            y = F.conv3x3(F.batch_norm_fwd(*bn), w,
                          randn(T, C, scale=0.1).to(bf))
            y32 = y.float()
            xl = _nchw_tenants(x)
            if n == max(IMAGES):
                _check_stats(cb, F, records, label, x, bf16=True)
                flat = [v.reshape(-1).float() for v in (mean, var, gamma,
                                                        beta)]
                z = cb.batch_norm_fwd(*bn)
                _same_bits("batch_norm_fwd_bf16",
                           lambda: cb.batch_norm_fwd(*bn), z)
                rec("batch_norm_fwd_bf16", label,
                    _equal("batch_norm_fwd_bf16", z, F.batch_norm_fwd(*bn)),
                    lambda: cb.batch_norm_fwd(*bn),
                    lambda: F.batch_norm_fwd(*bn),
                    lambda: nnf.batch_norm(xl, *flat, training=False,
                                           eps=F.BN_EPS),
                    4 * x.numel(), 2 * (2 * x.numel() + 4 * T * cin),
                    f32_fn=lambda: cb.batch_norm_fwd(*bn32),
                    device=K2_FREE_DEVICE)
                got = cb.act_pool_fwd(y)
                _same_bits("act_pool_fwd_bf16", lambda: cb.act_pool_fwd(y),
                           got)
                P = got[1].numel()
                rec("act_pool_fwd_bf16", label,
                    _equal_bits("act_pool_fwd_bf16", got, F.act_pool_fwd(y)),
                    lambda: cb.act_pool_fwd(y), lambda: F.act_pool_fwd(y),
                    None, 3 * y.numel(), 2 * (y.numel() + P) + P,
                    f32_fn=lambda: cb.act_pool_fwd(y32),
                    device=ACT_POOL_FWD_DEVICE)
                del got
                win = F._windows(F.act_fwd(y))
                ties = int(((win == win.amax(-1, keepdim=True)).sum(-1)
                            > 1).sum())
                print(f"  bf16 norm-first {stage} N={n}: act_pool_fwd equal "
                      f"to its twin bit for bit; {ties} pool windows hold an "
                      "exact tie at their maximum", flush=True)
                del win
            else:
                dz = randn(*x.shape).to(bf)
                dz32 = dz.float()
                got = cb.batch_norm_bwd(dz, *bn)
                err = max(within_ulp(f"batch_norm_bwd_bf16 {what}", a, c)
                          for what, a, c in zip(
                              ("dx", "dgamma", "dbeta"), got,
                              F.batch_norm_bwd(dz, *bn)))
                _same_bits("batch_norm_bwd_bf16",
                           lambda: cb.batch_norm_bwd(dz, *bn), got)
                del got
                dzl = _nchw_tenants(dz)
                saved = (gamma.reshape(-1).float(), None, None,
                         mean.reshape(-1).float(), rstd.reshape(-1).float(),
                         True, F.BN_EPS, [True] * 3)
                rec("batch_norm_bwd_bf16", label, err,
                    lambda: cb.batch_norm_bwd(dz, *bn),
                    lambda: F.batch_norm_bwd(dz, *bn),
                    lambda: torch.ops.aten.native_batch_norm_backward(
                        dzl, xl, *saved),
                    16 * x.numel(), 2 * (3 * x.numel() + 6 * T * cin),
                    f32_fn=lambda: cb.batch_norm_bwd(dz32, *bn32),
                    device=K3_FREE_DEVICE)
                del dzl
                args = (randn(*x.shape).to(bf), randn(T, cin).to(bf),
                        randn(T, cin).to(bf), dz, *bn)
                args32 = _f32(*args)
                got = cb.batch_norm_bwd_bwd(*args)
                err = max(within_ulp(f"batch_norm_bwd_bwd_bf16 {what}", a, c)
                          for what, a, c in zip(
                              ("g_dz", "g_x", "g_gamma"), got,
                              F.batch_norm_bwd_bwd(*args)))
                _same_bits("batch_norm_bwd_bwd_bf16",
                           lambda: cb.batch_norm_bwd_bwd(*args), got)
                del got
                rec("batch_norm_bwd_bwd_bf16", label, err,
                    lambda: cb.batch_norm_bwd_bwd(*args),
                    lambda: F.batch_norm_bwd_bwd(*args), None,
                    42 * x.numel(), 2 * (5 * x.numel() + 7 * T * cin),
                    f32_fn=lambda: cb.batch_norm_bwd_bwd(*args32),
                    device=K5_FREE_DEVICE)
                _, arg = F.act_pool_fwd(y)
                P = arg.numel()
                dp = randn(*arg.shape).to(bf)
                dp32 = dp.float()
                dy = cb.act_pool_bwd(dp, arg, y)
                _same_bits("act_pool_bwd_bf16",
                           lambda: cb.act_pool_bwd(dp, arg, y), dy)
                rec("act_pool_bwd_bf16", label,
                    _equal_bits("act_pool_bwd_bf16", dy,
                                F.act_pool_bwd(dp, arg, y)),
                    lambda: cb.act_pool_bwd(dp, arg, y),
                    lambda: F.act_pool_bwd(dp, arg, y), None, 2 * P,
                    2 * (2 * P + y.numel()) + P,
                    f32_fn=lambda: cb.act_pool_bwd(dp32, arg, y32),
                    device=ACT_POOL_BWD_DEVICE)
                del dy
                g_dy = randn(*y.shape).to(bf)
                g_dy32 = g_dy.float()
                got = cb.act_pool_gather(g_dy, arg, y)
                _same_bits("act_pool_gather_bf16",
                           lambda: cb.act_pool_gather(g_dy, arg, y), got)
                rec("act_pool_gather_bf16", label,
                    _equal_bits("act_pool_gather_bf16", got,
                                F.act_pool_gather(g_dy, arg, y)),
                    lambda: cb.act_pool_gather(g_dy, arg, y),
                    lambda: F.act_pool_gather(g_dy, arg, y), None, 2 * P,
                    2 * 3 * P + P,
                    f32_fn=lambda: cb.act_pool_gather(g_dy32, arg, y32),
                    device=ACT_POOL_GATHER_DEVICE)
                del got
                if cin == 3:
                    # dgrad back to the normalized image, on a random dy
                    dy = randn(*y.shape).to(bf)
                    dy32, w32 = dy.float(), w.float()
                    wl = w.permute(0, 4, 3, 1, 2).reshape(T * C, cin, 3, 3)
                    wl, dyl = wl.contiguous(), _nchw_tenants(dy)
                    dx = cb.conv3x3_dgrad(dy, w)
                    err = within_ulp("conv3x3_dgrad_bf16", dx,
                                     F.conv3x3_dgrad(dy, w))
                    _same_bits("conv3x3_dgrad_bf16",
                               lambda: cb.conv3x3_dgrad(dy, w), dx)
                    del dx
                    rec("conv3x3_dgrad_bf16", label, err,
                        lambda: cb.conv3x3_dgrad(dy, w),
                        lambda: F.conv3x3_dgrad(dy, w),
                        lambda: torch.nn.grad.conv2d_input(
                            xl.shape, wl, dyl, padding=1, groups=T),
                        2 * T * n * hw * hw * 9 * cin * C,
                        2 * (dy.numel() + w.numel() + x.numel()),
                        tensor_cores=True,
                        f32_fn=lambda: cb.conv3x3_dgrad(dy32, w32),
                        device=MMA_DEVICE)
                    del dy, dyl
                del dz, args, args32, dp, g_dy, arg
            del x, xl, y, y32, bn, bn32
            torch.cuda.empty_cache()
    # the strided norm-first Omniglot model: the pool-free act kernels, the
    # statistics of the image and the stride-2 dgrad back to it
    n, Co = OMNIGLOT_IMAGES, OMNIGLOT_COUT
    for layer, hw, cin in STRIDED_LAYERS:
        label = f"bf16 strided norm-first T={T} {layer} N={n}"
        ho = (hw - 1) // 2 + 1
        y = randn(T, n, ho, ho, Co).to(bf)
        da = randn(*y.shape).to(bf)
        y32, da32 = _f32(y, da)
        got = cb.act_fwd(y)
        _same_bits("act_fwd_bf16", lambda: cb.act_fwd(y), got)
        rec("act_fwd_bf16", label, _equal("act_fwd_bf16", got, F.act_fwd(y)),
            lambda: cb.act_fwd(y), lambda: F.act_fwd(y),
            lambda: nnf.leaky_relu(y, F.LEAKY_SLOPE), 2 * y.numel(),
            4 * y.numel(), f32_fn=lambda: cb.act_fwd(y32),
            device=ACT_FWD_DEVICE)
        got = cb.act_bwd(da, y)
        _same_bits("act_bwd_bf16", lambda: cb.act_bwd(da, y), got)
        rec("act_bwd_bf16", label, _equal("act_bwd_bf16", got,
                                          F.act_bwd(da, y)),
            lambda: cb.act_bwd(da, y), lambda: F.act_bwd(da, y),
            lambda: torch.ops.aten.leaky_relu_backward(da, y, F.LEAKY_SLOPE,
                                                       False),
            2 * y.numel(), 6 * y.numel(),
            f32_fn=lambda: cb.act_bwd(da32, y32), device=ACT_BWD_DEVICE)
        x = (torch.rand(T, n, hw, hw, cin, device="cuda") if cin == 1
             else randn(T, n, hw, hw, cin)).to(bf)
        _check_stats(cb, F, records, label, x, bf16=True)
        if cin == 1:
            w = randn(T, 3, 3, cin, Co,
                      scale=math.sqrt(2.0 / (9 * cin))).to(bf)
            w32 = w.float()
            wl = w.permute(0, 4, 3, 1, 2).reshape(T * Co, cin, 3, 3)
            wl, dyl = wl.contiguous(), _nchw_tenants(da)
            hw2 = (hw, hw)
            err = within_ulp("conv3x3_s2_dgrad_bf16",
                             cb.conv3x3_dgrad(da, w, 2, hw2),
                             F.conv3x3_dgrad(da, w, 2, hw2))
            rec("conv3x3_s2_dgrad_bf16", label, err,
                lambda: cb.conv3x3_dgrad(da, w, 2, hw2),
                lambda: F.conv3x3_dgrad(da, w, 2, hw2),
                lambda: torch.nn.grad.conv2d_input(
                    (n, T * cin, hw, hw), wl, dyl, stride=2, padding=1,
                    groups=T),
                2 * T * n * ho * ho * 9 * cin * Co,
                2 * (da.numel() + w.numel() + x.numel()), tensor_cores=True,
                f32_fn=lambda: cb.conv3x3_dgrad(da32, w32, 2, hw2))
        torch.cuda.empty_cache()
    n = max(IMAGES)
    for stage, hw, cin in UNPADDED_NORM_FIRST:
        _check_stats(cb, F, records, f"bf16 norm-first T={T} {stage} N={n}",
                     randn(T, n, hw, hw, cin).to(bf), bf16=True)
        torch.cuda.empty_cache()
    _check_act_pool_unpadded(cb, F, randn, bf, T)


def check_bf16_layer_norm_kernels(cb, F, records, T=T_TENANTS):
    """Phase 11, the layer norm's four kernels in bf16 at every tensor the
    layer-norm bf16 models normalize: the mini-ImageNet stages of both
    orders (``LAYER_NORM_STAGES``: the conv-first conv outputs 84/42/21/10
    x 48, the norm-first stage-0 image 84 x 84 x 3; statistics and forward
    at N = 75, backward and double backward at N = 25) and the strided
    Omniglot model's last map (2 x 2 x 64, N = 20, all four). T = 8;
    gamma and beta shared ``(H, W, C)``, expanded to ``(T, H, W, C)`` as
    the blocks give them. ``layer_norm_fwd`` must equal its twin bit for
    bit (fed the twin's statistics), the statistics, backward and double
    backward within one bf16 ulp or 1e-4 of scale. Each timed beside its
    twin, the f32 kernel at the same shape and, in bf16, the library call
    where one computes the same function: ``torch.var_mean``,
    ``F.layer_norm`` (statistics included) and
    ``aten.native_layer_norm_backward``; none for the double backward.
    Bound: 2-byte elements."""
    rec = records.add
    randn = _randn(torch.Generator(device="cuda").manual_seed(41))
    bf = torch.bfloat16
    nnf = torch.nn.functional
    cases = [(f"bf16 layer-norm T={T} {label} N={n}", hw, c, n)
             for label, hw, c in LAYER_NORM_STAGES for n in IMAGES]
    cases += [(f"bf16 layer-norm T={T} strided layer4 N={OMNIGLOT_IMAGES}",
               2, OMNIGLOT_COUT, OMNIGLOT_IMAGES)]
    for label, hw, c, n in cases:
        shape = (hw, hw, c)
        x = (torch.rand(T, n, *shape, device="cuda") if c <= 3
             else randn(T, n, *shape)).to(bf)
        gamma_s = (1.0 + randn(*shape, scale=0.1)).to(bf)
        beta_s = randn(*shape, scale=0.1).to(bf)
        gamma = gamma_s.expand(T, *shape).contiguous()
        beta = beta_s.expand(T, *shape).contiguous()
        x32, gamma32, beta32 = _f32(x, gamma, beta)
        mean, var, rstd = F.layer_norm_stats(x)
        mean32, rstd32 = _f32(mean, rstd)
        numel, tm, rows = x.numel(), gamma.numel(), T * n
        forward = n != min(IMAGES)
        if forward:
            stats = cb.layer_norm_stats(x)
            err = max(within_ulp(f"layer_norm_stats_bf16 {what}", a, b)
                      for what, a, b in zip(("mean", "var", "rstd"), stats,
                                            (mean, var, rstd)))
            _same_bits("layer_norm_stats_bf16",
                       lambda: cb.layer_norm_stats(x), stats)
            del stats
            rec("layer_norm_stats_bf16", label, err,
                lambda: cb.layer_norm_stats(x),
                lambda: F.layer_norm_stats(x),
                lambda: torch.var_mean(x, dim=(2, 3, 4), correction=0),
                4 * numel, 2 * (numel + 3 * rows),
                f32_fn=lambda: cb.layer_norm_stats(x32))
            ln = (x, mean, rstd, gamma, beta)
            z = cb.layer_norm_fwd(*ln)
            err = _equal("layer_norm_fwd_bf16", z, F.layer_norm_fwd(*ln))
            _same_bits("layer_norm_fwd_bf16",
                       lambda: cb.layer_norm_fwd(*ln), z)
            del z
            rec("layer_norm_fwd_bf16", label, err,
                lambda: cb.layer_norm_fwd(*ln),
                lambda: F.layer_norm_fwd(*ln),
                lambda: nnf.layer_norm(x, shape, gamma_s, beta_s, F.LN_EPS),
                4 * numel, 2 * (2 * numel + 2 * tm + 2 * rows),
                f32_fn=lambda: cb.layer_norm_fwd(x32, mean32, rstd32,
                                                 gamma32, beta32),
                device=LN_FWD_DEVICE)
            del ln
        if not forward or n == OMNIGLOT_IMAGES:
            dz = randn(*x.shape, scale=1.0 / math.sqrt(numel)).to(bf)
            dz32 = dz.float()
            ln = (x, mean, rstd, gamma)
            ln32 = (x32, mean32, rstd32, gamma32)
            grads = cb.layer_norm_bwd(dz, *ln)
            err = max(within_ulp(f"layer_norm_bwd_bf16 {what}", a, b)
                      for what, a, b in zip(("dx", "dgamma", "dbeta"),
                                            grads,
                                            F.layer_norm_bwd(dz, *ln)))
            _same_bits("layer_norm_bwd_bf16",
                       lambda: cb.layer_norm_bwd(dz, *ln), grads)
            del grads
            saved = (mean32.reshape(T, n, 1, 1, 1),
                     rstd32.reshape(T, n, 1, 1, 1), gamma_s, beta_s,
                     [True] * 3)
            rec("layer_norm_bwd_bf16", label, err,
                lambda: cb.layer_norm_bwd(dz, *ln),
                lambda: F.layer_norm_bwd(dz, *ln),
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dz, x, list(shape), *saved),
                12 * numel, 2 * (3 * numel + 3 * tm + 2 * rows),
                f32_fn=lambda: cb.layer_norm_bwd(dz32, *ln32))
            args = (randn(*x.shape).to(bf), randn(T, *shape).to(bf),
                    randn(T, *shape).to(bf), randn(*x.shape).to(bf), *ln)
            args32 = _f32(*args[:4]) + ln32
            got = cb.layer_norm_bwd_bwd(*args)
            err = max(within_ulp(f"layer_norm_bwd_bwd_bf16 {what}", a, b)
                      for what, a, b in zip(("g_dz", "g_x", "g_gamma"), got,
                                            F.layer_norm_bwd_bwd(*args)))
            _same_bits("layer_norm_bwd_bwd_bf16",
                       lambda: cb.layer_norm_bwd_bwd(*args), got)
            del got
            rec("layer_norm_bwd_bwd_bf16", label, err,
                lambda: cb.layer_norm_bwd_bwd(*args),
                lambda: F.layer_norm_bwd_bwd(*args), None,
                40 * numel, 2 * (5 * numel + 4 * tm + 2 * rows),
                f32_fn=lambda: cb.layer_norm_bwd_bwd(*args32),
                device=LN_BWD_BWD_DEVICE)
            del dz, dz32, ln, ln32, args, args32
        del x, x32, mean, var, rstd, gamma, beta, gamma32, beta32
        torch.cuda.empty_cache()


def check_bf16_block_derivatives(cb, F, x_shape, kw, what, norm_first,
                                 layer_norm=False):
    """Phase 10: the bf16 block's first and second derivatives on the
    kernels (the conv-first batch-norm block, or with ``norm_first`` the
    norm-first one, with ``layer_norm`` the layer-norm block of that order
    (phase 11; gamma shared over the normalized (H, W, C), beta per
    tenant), recording its pool argmaxes and leaky-ReLU signs)
    against autograd of the plain block in bf16 and in f64, both replaying
    the kernels' decisions, on the same bf16 inputs (gamma and beta bf16
    values too; each first derivative against a unit-scale random
    cotangent, the second that of a scalar of the first gradients). Per
    derivative, the kernels' max |err| against f64 within 2x the plain
    bf16 block's, that taken as at least one bf16 ulp of the derivative's
    largest f64 entry; a derivative whose f64 value is 0 (below 1e-6 of the
    largest of them all: the conv bias of the conv-first block, which batch
    norm cancels) within 2x the plain bf16 block's largest error. The f64
    block takes bf16's leaky slope."""
    bf, f64 = torch.bfloat16, torch.float64
    record = _recording_kernel_block(cb, [], norm_first, layer_norm)
    randn, inputs = _block_inputs(7, x_shape, x_shape[-1],
                                  _norm_shape(record, x_shape, kw))
    inputs = [t.to(bf) for t in inputs]
    names = ("x", "w", "b", "gamma", "beta")
    second_names = (("x", "w", "gamma", "beta") if norm_first
                    else ("x", "w", "b", "gamma"))
    wrt = [names.index(k) for k in second_names]
    results = {"first": {}, "second": {}}
    cts = None
    for order in ("first", "second"):
        log = []
        for run in ("kernels", "plain bf16", "plain f64"):
            dtype = f64 if run == "plain f64" else None
            if run == "kernels":
                fn = _recording_kernel_block(cb, log, norm_first,
                                             layer_norm)
            else:
                # the f64 reference takes bf16's slope, so that only
                # rounding sets the two bf16 runs apart from it
                fn = _plain_block(F, log, replay=True, norm_first=norm_first,
                                  layer_norm=layer_norm,
                                  slope=F.scalar_like(F.LEAKY_SLOPE,
                                                      inputs[0]))
            leaves = [(t if dtype is None else t.to(dtype)).clone()
                      .requires_grad_(True) for t in inputs]
            out, _, _ = fn(*leaves, **kw)
            if cts is None:
                cts = (randn(*out.shape),
                       [randn(*inputs[i].shape) for i in wrt])
            ct = cts[0].to(out.dtype if dtype is not None else torch.float32)
            loss = ((out if dtype is not None else out.float()) * ct).sum()
            if order == "first":
                got = torch.autograd.grad(loss, leaves)
            else:
                first = torch.autograd.grad(loss, [leaves[i] for i in wrt],
                                            create_graph=True)
                scalar = sum((g.to(ct.dtype) * c.to(ct.dtype)).sum()
                             for g, c in zip(first, cts[1]))
                got = torch.autograd.grad(scalar, [leaves[i] for i in wrt])
            results[order][run] = [g.detach().double() for g in got]
    for order, runs in results.items():
        keys = names if order == "first" else second_names
        ref = runs["plain f64"]
        scale = max(r.abs().max().item() for r in ref)
        err = {run: [(g - r).abs().max().item() for g, r in zip(runs[run],
                                                                ref)]
               for run in ("kernels", "plain bf16")}
        worst_plain = max(err["plain bf16"])
        cells, bad = [], []
        for i, key in enumerate(keys):
            m = ref[i].abs().max().item()
            if m < 1e-6 * scale:
                limit = 2 * worst_plain
            else:
                ulp = bf16_ulp(torch.tensor(m)).item()
                limit = 2 * max(err["plain bf16"][i], ulp)
            cells.append(f"{key} {err['kernels'][i]:.3e} (plain "
                         f"{err['plain bf16'][i]:.3e})")
            if err["kernels"][i] > limit:
                bad.append(f"{key} {err['kernels'][i]:.3e} > {limit:.3e}")
        print(f"  {what} bf16 {order} derivative, max |err| against f64 "
              f"(replayed decisions): " + ", ".join(cells)
              + f" (largest entry {scale:.3e})", flush=True)
        if bad:
            raise AssertionError(f"{what} bf16 {order} derivative: kernels "
                                 "further from f64 than 2x the plain bf16 "
                                 "block: " + ", ".join(bad))


def _window_ties(F, y, mean, rstd, gamma, beta):
    """Pool windows whose maximum activation occurs twice or more (K2's
    activation of y)."""
    win = F._windows(F.bn_act_fwd(y, mean, rstd, gamma, beta))
    return int(((win == win.amax(-1, keepdim=True)).sum(-1) > 1).sum())


class _Unkept(list):
    """A decision log for ``_plain_block`` that keeps nothing."""

    def append(self, _):
        pass


def check_bf16_serve(cfg, F, cb):
    """Phase 9: one bucket-8 dispatch at full width of the bf16 model
    (``cfg``'s: padded or unpadded, pooled or strided, conv first or norm
    first, batch norm or layer norm) on
    the kernels against the plain block in bf16 on the card, within 2x the
    plain block's own bf16-vs-f32 spread (preds max |diff|, loss max
    relative diff over the tenants); the accuracy gap between the bf16 and
    the f32 kernels; and, for the pooled conv-first model, the pool-window
    ties of stage 1 on the dispatch's
    support images in bf16 and f32 (the same weights). The plain block is
    ``_plain_block`` of the model's block order and norm layer, whose pool gives each
    window's gradient to its first maximum as the kernels do (the model's
    plain block, ``amax``, splits it among tied maxima, and bf16 ties
    thousands of windows)."""
    import numpy as np

    from howtotrainyourmamlpytorch_tpu_torch.serving import bench
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.state import init_state

    cfg32 = cfg.replace(bn_stats_impl="twopass", compute_dtype="float32")
    cfg16 = cfg32.replace(compute_dtype="bfloat16")
    shots_buckets = bench.bench_shots_buckets(cfg32)
    group = max(bench._synth_groups(cfg32, shots_buckets, 32, 8, 0), key=len)
    state = init_state(cfg32, device=DEVICE)
    results = {}
    plain = _plain_block(F, _Unkept(),
                         norm_first=cfg.block_order == "norm_conv_relu",
                         layer_norm=cfg.norm_layer == "layer_norm")
    for name, c, block in (
            ("bf16 kernels", cfg16, None),
            ("bf16 plain", cfg16, plain),
            ("f32 plain", cfg32, plain),
            ("f32 kernels", cfg32, None)):
        engine = ServingEngine(c, state, shots_buckets, device=DEVICE,
                               block=block)
        drs = [engine.serve_group(group) for _ in range(2)]
        results[name] = drs[-1]
        print(f"  bucket-{drs[-1].bucket} dispatch ({len(group)} tenants) "
              f"with the {name}: adapt_ms "
              f"{[round(d.adapt_ms, 3) for d in drs]}", flush=True)

    def spread(a, b):
        preds = loss = 0.0
        for ra, rb in zip(results[a].results, results[b].results):
            if not np.isfinite(ra.preds).all():
                raise AssertionError(f"{a}: non-finite preds")
            preds = max(preds, float(np.abs(ra.preds - rb.preds).max()))
            loss = max(loss, abs(ra.loss - rb.loss) / abs(rb.loss))
        return preds, loss

    kp, kl = spread("bf16 kernels", "bf16 plain")
    pp, pl = spread("bf16 plain", "f32 plain")
    print(f"  bf16 serve step, kernels vs plain on the card: preds max err "
          f"{kp:.3e}, loss max rel err {kl:.3e}; plain bf16 vs plain f32: "
          f"preds {pp:.3e}, loss {pl:.3e}", flush=True)
    if kp > 2 * pp or kl > 2 * pl:
        raise AssertionError("bf16 serve step: the kernels are further from "
                             "the plain ops than 2x the plain bf16-vs-f32 "
                             "spread")

    def accuracy(name):
        return float(np.mean([r.accuracy for r in results[name].results]))

    print(f"  accuracy of the bucket-8 dispatch: bf16 kernels "
          f"{accuracy('bf16 kernels'):.4f}, f32 kernels "
          f"{accuracy('f32 kernels'):.4f} (gap "
          f"{accuracy('bf16 kernels') - accuracy('f32 kernels'):+.4f})",
          flush=True)
    if (not cfg.max_pooling or cfg.block_order != "conv_norm_relu"
            or cfg.norm_layer != "batch_norm"):
        return
    # stage 1's pool windows on the support images, at stage 0's output
    h, w, c = cfg32.im_shape
    x = torch.from_numpy(np.stack([r.support_x for r in group])).to(DEVICE)
    x = x.reshape(len(group), -1, h, w, c)
    net, step = state.net, 0
    for dtype in (torch.bfloat16, torch.float32):
        def stage(i, inp):
            T = inp.shape[0]
            wt = net[f"conv{i}.conv.weight"].to(dtype).expand(
                T, *net[f"conv{i}.conv.weight"].shape).contiguous()
            bt = net[f"conv{i}.conv.bias"].to(dtype).expand(T, -1)
            g = net[f"conv{i}.norm.gamma"][step].to(dtype).expand(T, -1)
            be = net[f"conv{i}.norm.beta"][step].to(dtype).expand(T, -1)
            y, mean, _, rstd = cb.conv3x3_fwd_stats(
                inp, wt, bt.contiguous(), padding=1 if cfg.conv_padding else 0)
            return y, mean, rstd, g.contiguous(), be.contiguous()

        y, mean, rstd, g, be = stage(0, x.to(dtype).contiguous())
        x1, _ = cb.bn_act_pool_fwd(y, mean, rstd, g, be)
        ties = _window_ties(F, *stage(1, x1))
        print(f"  stage 1 of the dispatch's support images in "
              f"{str(dtype)[6:]}: {ties} pool windows hold an exact tie at "
              "their maximum", flush=True)


def _print_accuracy_gap(learning16, learning32):
    """The accuracy after the 10-step learning check, bf16 against f32."""
    a16, a32 = learning16["accuracy"][-1], learning32["accuracy"][-1]
    print(f"  accuracy after the 10 steps: bf16 {a16:.4f}, f32 {a32:.4f} "
          f"(gap {a16 - a32:+.4f})", flush=True)


# the training entry point's phase (phase 12): a pre-split dataset of
# mini-ImageNet's shape and split at 20 images a class, under a name of its
# own (no known-name file count; "imagenet" in it keeps the flagship's
# normalization and gradient clamp)
RUNNER_DATASET = "smoke_imagenet_proxy"
RUNNER_SPLITS = (("train", 64), ("val", 16), ("test", 20))
RUNNER_IMAGES = 20
RUNNER_ITERS = 3  # total_iter_per_epoch
RUNNER_EVAL_TASKS = 4  # num_evaluation_tasks: 2 batches of 2


def write_runner_dataset(root):
    """The pre-split dataset of phase 12: each class's pictures are
    ``datasets/make_mini_imagenet_proxy.py``'s (its ``_class_spec`` and
    ``_render``, with its seeds), written as PNGs by the port's writer."""
    import importlib.util
    import os

    import numpy as np

    from howtotrainyourmamlpytorch_tpu_torch.data import png

    spec = importlib.util.spec_from_file_location(
        "make_mini_imagenet_proxy",
        os.path.join("datasets", "make_mini_imagenet_proxy.py"))
    proxy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proxy)
    cls = 0
    for split, n_classes in RUNNER_SPLITS:
        for _ in range(n_classes):
            look = proxy._class_spec(np.random.RandomState(1000 + cls))
            d = os.path.join(root, split, f"n{90000000 + cls:08d}")
            os.makedirs(d)
            rng = np.random.RandomState(500_000 + cls)
            for j in range(RUNNER_IMAGES):
                png.write(os.path.join(d, f"im{j:04d}.png"),
                          proxy._render(look, rng))
            cls += 1


def _csv_rows(exp, name="summary_statistics.csv"):
    import csv
    import os

    with open(os.path.join(exp, "logs", name)) as f:
        return list(csv.reader(f))


def _untimed(header, row):
    """A CSV row's columns but its timings (step times, the loader's
    stream figures, the epoch's wall time), as their strings."""
    return {k: v for k, v in zip(header, row)
            if not ("time" in k or "per_sec" in k or k.startswith("stream_"))}


def run_runner(ks, cfg, name, exp, data, cache, epochs, extra=(),
               new_epochs=None, resumed_epochs=0):
    """One ``train`` run of phase 12; its launches, counted from 0 around
    it, must be its train steps times a step's plus its eval dispatches
    times a dispatch's (the device tier: ``episode_expand`` once in
    each). Returns (the run's launches, its CSV rows, its test accuracy,
    its seconds, its new epochs' train-step p50s)."""
    from howtotrainyourmamlpytorch_tpu_torch import cli

    args = ["train", "--name_of_args_json_file", FLAGSHIP,
            "--dataset_name", RUNNER_DATASET, "--dataset_path", data,
            "--experiment_name", exp, "--cache_dir", cache,
            "--total_epochs", str(epochs),
            "--total_iter_per_epoch", str(RUNNER_ITERS),
            "--num_evaluation_tasks", str(RUNNER_EVAL_TASKS)] + list(extra)
    print(f"[runner] ({name}) cli train {' '.join(args[1:])}", flush=True)
    ks.reset_launches()
    t0 = time.perf_counter()
    assert cli.main(args) == 0
    seconds = time.perf_counter() - t0
    counts = ks.launches()
    device_tier = "device" in extra
    new_epochs = epochs if new_epochs is None else new_epochs
    steps = new_epochs * RUNNER_ITERS
    # validation: 2 batches an epoch; the test: 2 batches a kept epoch
    tested = min(epochs, 5, cfg.max_models_to_save)
    evals = 2 * new_epochs + 2 * tested
    per_step = expected_step_launches(cfg, "device" if device_tier
                                      else "host")
    per_eval = expected_serve_launches(cfg, "index" if device_tier
                                       else "f32")
    for k in counts:
        want = steps * per_step[k] + evals * per_eval[k]
        if counts[k] != want:
            raise AssertionError(
                f"runner ({name}): {k} launched {counts[k]} times, expected "
                f"{steps} steps x {per_step[k]} + {evals} eval dispatches x "
                f"{per_eval[k]}")
    rows = _csv_rows(exp)
    test = dict(zip(*_csv_rows(exp, "test_summary.csv")))
    acc = float(test["test_accuracy_mean"])
    if not (math.isfinite(acc) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"runner ({name}): test accuracy {acc}")
    header = rows[0]
    p50 = [float(r[header.index("train_step_time_p50_ms")])
           for r in rows[1 + resumed_epochs:]]
    print(f"[runner] ({name}) {seconds:.1f} s, {steps} train steps, {evals} "
          f"eval dispatches; train step p50 per epoch {p50} ms; test "
          f"accuracy {acc}", flush=True)
    return counts, rows, acc, seconds, p50


def check_runner(ks, card):
    """Phase 12 (see the module docstring). Returns the launches of its
    runs, summed."""
    import os
    import statistics
    import tempfile

    import numpy as np

    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint

    t_phase = time.perf_counter()
    cfg = MAMLConfig.from_json_file(FLAGSHIP)
    total = {}
    with tempfile.TemporaryDirectory(prefix="runner_") as tmp:
        data = os.path.join(tmp, RUNNER_DATASET)
        cache = os.path.join(tmp, "cache")
        t0 = time.perf_counter()
        write_runner_dataset(data)
        print(f"[runner] wrote {sum(n for _, n in RUNNER_SPLITS)} classes x "
              f"{RUNNER_IMAGES} PNGs (84x84x3) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        exp_a, exp_c, exp_d = (os.path.join(tmp, e) for e in
                               ("exp_a", "exp_c", "exp_d"))
        runs = {}
        runs["a"] = run_runner(ks, cfg, "a", exp_a, data, cache, 2)
        rows_a = runs["a"][1]
        runs["b"] = run_runner(ks, cfg, "b", exp_a, data, cache, 3,
                               new_epochs=1, resumed_epochs=2)
        rows_b = runs["b"][1]
        if len(rows_b) != 4 or rows_b[:3] != rows_a:
            raise AssertionError(
                f"runner (b): {len(rows_b) - 1} CSV rows, expected (a)'s 2 "
                "and one new epoch")
        runs["c"] = run_runner(ks, cfg, "c", exp_c, data, cache, 3)
        rows_c = runs["c"][1]
        header = rows_c[0]
        if header != rows_b[0] or (_untimed(header, rows_b[3])
                                   != _untimed(header, rows_c[3])):
            raise AssertionError(
                "runner: the resumed run's third epoch differs from the "
                f"uninterrupted run's: {_untimed(header, rows_b[3])} vs "
                f"{_untimed(header, rows_c[3])}")
        runs["d"] = run_runner(ks, cfg, "d", exp_d, data, cache, 1,
                               ("--data_placement", "device",
                                "--use_mmap_cache", "true"))
        rows_d = runs["d"][1]
        if _untimed(header, rows_d[1]) != _untimed(header, rows_a[1]):
            raise AssertionError(
                "runner: the device tier's first epoch differs from the "
                f"host tier's: {_untimed(header, rows_d[1])} vs "
                f"{_untimed(header, rows_a[1])}")
        for exp, rows in ((exp_a, rows_b), (exp_c, rows_c), (exp_d, rows_d)):
            col = rows[0].index("val_accuracy_mean")
            val_acc = [float(r[col]) for r in rows[1:]]
            keep = [str(int(i) + 1) for i in np.argsort(
                val_acc, kind="stable")[::-1][:cfg.max_models_to_save]]
            on_disk = checkpoint.list_checkpoints(
                os.path.join(exp, "saved_models"), "train_model")
            if sorted(on_disk) != sorted(keep + ["latest"]):
                raise AssertionError(
                    f"runner: checkpoints {on_disk} in {exp}, expected "
                    f"latest and the best {cfg.max_models_to_save}: {keep}")
        for counts, *_ in runs.values():
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    seconds = time.perf_counter() - t_phase
    for key, (_, _, _, run_s, p50) in runs.items():
        print(f"[runner] run ({key}): {run_s:.1f} s, train step p50 "
              f"{statistics.median(p50):.2f} ms (median of its epochs' "
              f"p50) | {card}", flush=True)
    print(f"[runner] {seconds:.1f} s | {card}", flush=True)
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--grad-seeds", default=",".join(map(str, GRAD_SEEDS)),
        help="data seeds of the full-width meta-gradient check against f64, "
             "mini-ImageNet (comma-separated)")
    parser.add_argument(
        "--omniglot-grad-seeds", default=",".join(map(str, GRAD_SEEDS)),
        help="the same for the Omniglot 20-way 1-shot model")
    parser.add_argument(
        "--strided-grad-seeds", default=",".join(map(str, GRAD_SEEDS)),
        help="data seeds of the replayed-path meta-gradient check of the "
             "strided Omniglot model")
    parser.add_argument(
        "--norm-first-grad-seeds", default=",".join(map(str, GRAD_SEEDS)),
        help="data seeds of the replayed-path meta-gradient check of the "
             "norm-first mini-ImageNet model")
    parser.add_argument(
        "--layer-norm-grad-seeds", default=",".join(map(str, GRAD_SEEDS)),
        help="data seeds of the replayed-path meta-gradient check of the "
             "layer-norm mini-ImageNet model")
    parser.add_argument(
        "--unpadded-grad-seeds", default=",".join(map(str, GRAD_SEEDS)),
        help="data seeds of the replayed-path meta-gradient check of the "
             "unpadded mini-ImageNet model")
    parser.add_argument(
        "--bf16-grad-seeds", default=",".join(map(str, GRAD_SEEDS)),
        help="data seeds of the replayed-path meta-gradient check of the "
             "bf16 mini-ImageNet models, padded and unpadded")
    parser.add_argument(
        "--strided-bf16-grad-seeds", default=",".join(map(str, GRAD_SEEDS)),
        help="data seeds of the replayed-path meta-gradient check of the "
             "bf16 strided Omniglot model")
    parser.add_argument(
        "--norm-first-bf16-grad-seeds",
        default=",".join(map(str, GRAD_SEEDS)),
        help="data seeds of the replayed-path meta-gradient check of the "
             "bf16 norm-first mini-ImageNet model")
    parser.add_argument(
        "--layer-norm-bf16-grad-seeds",
        default=",".join(map(str, GRAD_SEEDS)),
        help="data seeds of the replayed-path meta-gradient check of the "
             "bf16 layer-norm mini-ImageNet model")
    args = parser.parse_args()
    seeds = tuple(int(v) for v in args.grad_seeds.split(","))
    omniglot_seeds = tuple(int(v) for v in
                           args.omniglot_grad_seeds.split(","))
    strided_seeds = tuple(int(v) for v in
                          args.strided_grad_seeds.split(","))
    norm_first_seeds = tuple(int(v) for v in
                             args.norm_first_grad_seeds.split(","))
    layer_norm_seeds = tuple(int(v) for v in
                             args.layer_norm_grad_seeds.split(","))
    unpadded_seeds = tuple(int(v) for v in
                           args.unpadded_grad_seeds.split(","))
    bf16_seeds = tuple(int(v) for v in args.bf16_grad_seeds.split(","))
    strided16_seeds = tuple(int(v) for v in
                            args.strided_bf16_grad_seeds.split(","))
    nf16_seeds = tuple(int(v) for v in
                       args.norm_first_bf16_grad_seeds.split(","))
    ln16_seeds = tuple(int(v) for v in
                       args.layer_norm_bf16_grad_seeds.split(","))
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}", flush=True)

    from howtotrainyourmamlpytorch_tpu_torch import kernels as ks
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.device import (
        peak_rates,
        resolve_device,
    )
    from howtotrainyourmamlpytorch_tpu_torch.kernels import build
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
    from howtotrainyourmamlpytorch_tpu_torch.kernels import (
        episode_expand as ee,
    )
    from howtotrainyourmamlpytorch_tpu_torch.models import vgg
    from howtotrainyourmamlpytorch_tpu_torch.ops import device_pipeline as dp
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F
    from howtotrainyourmamlpytorch_tpu_torch.serving import (
        bench as serve_bench,
    )

    resolve_device("cuda:0")  # TF32 off for the plain versions too
    print(f"[build] {build.timed_build():.2f} s into {build.build_dir()}",
          flush=True)
    for stem, log in build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {stem}] {line.strip()}", flush=True)

    cfg = MAMLConfig.from_json_file(FLAGSHIP)
    omniglot = MAMLConfig.from_json_file(OMNIGLOT)
    strided = omniglot.replace(max_pooling=False)
    norm_first = cfg.replace(block_order="norm_conv_relu")
    strided_norm_first = strided.replace(block_order="norm_conv_relu")
    layer_norm = cfg.replace(norm_layer="layer_norm")
    ln_norm_first = norm_first.replace(norm_layer="layer_norm")
    strided_ln = strided.replace(norm_layer="layer_norm")
    unpadded = cfg.replace(conv_padding=False)
    maml_cfg = MAMLConfig.from_json_file(MAML_JSON)
    all_kernels = cb.KERNELS + ee.KERNELS
    print("[kernels] each kernel vs its plain twin on the card", flush=True)
    t0 = time.perf_counter()
    records = Records(all_kernels, peak_rates(kind),
                      peak_rates(kind, bf16_tensor_cores=True)[0])
    check_kernels(cb, F, records)
    print("[kernels] K1 and K4 at the mini-ImageNet stages 2-3", flush=True)
    check_conv_stages(cb, F, records)
    check_train_kernels(cb, F, records)
    print("[kernels] K3 and K5 at the mini-ImageNet stages 2-3 (and K3 at "
          "T = 2)", flush=True)
    check_bn_bwd_stages(cb, F, records)
    print("[kernels] K1-K5 at the Omniglot 20-way 1-shot layers", flush=True)
    check_kernels(cb, F, records, OMNIGLOT_LAYERS, (OMNIGLOT_IMAGES,),
                  OMNIGLOT_COUT, "omniglot ")
    check_train_kernels(cb, F, records, (T_TENANTS,), OMNIGLOT_LAYERS,
                        OMNIGLOT_IMAGES, OMNIGLOT_COUT, "omniglot ")
    print("[kernels] episode_expand vs its twin (exact)", flush=True)
    check_episode_expand(ee, dp, records, cfg, omniglot)
    check_block_autograd(vgg.blocks_for(cfg))
    check_block_double_backward(vgg.blocks_for(cfg))
    print("[kernels] the strided model's kernels (stride-2 K1/K4, "
          "pool-free K2/K3/K5, GAP) at its four layers", flush=True)
    check_strided_kernels(cb, F, records)
    for what, x_shape, kw in _strided_block_cases():
        check_block_autograd(vgg.blocks_for(strided), x_shape, kw, what)
        check_block_double_backward(vgg.blocks_for(strided), x_shape, kw,
                                    what)
    print("[kernels] the norm-first block's kernels (bn_input_stats, K2/K3/"
          "K5 at slope 1, act-pool, K1 stats-free and dgrad at cin 3) at "
          "its four stages; the pool-free act kernels at the strided "
          "layers", flush=True)
    check_norm_first_kernels(cb, F, records)
    check_strided_norm_first_kernels(cb, F, records)
    print("[kernels] the pool-free K3 (bn_act_bwd, batch_norm_bwd) and "
          "act_bwd at every model shape, T = 2 and 8, f32 and bf16",
          flush=True)
    check_k3_free_shapes(cb, F)
    check_block_autograd(_replayed_blocks(cb, F),
                         what="norm-first stage 1")
    check_block_double_backward(_replayed_blocks(cb, F),
                                what="norm-first stage 1")
    for what, x_shape, kw in _strided_block_cases():
        check_block_autograd(_replayed_blocks(cb, F), x_shape, kw,
                             f"norm-first {what}")
        check_block_double_backward(_replayed_blocks(cb, F), x_shape, kw,
                                    f"norm-first {what}")
    print("[kernels] the layer norm's kernels (stats, forward, backward, "
          "double backward) at the mini-ImageNet stages of both orders and "
          "the strided layers; the layer-norm blocks' derivatives",
          flush=True)
    check_layer_norm_kernels(cb, F, records)
    for nf in (False, True):
        order = "norm-first " if nf else "conv-first "
        check_block_autograd(_replayed_blocks(cb, F, nf, True),
                             what=f"layer-norm {order}stage 1")
        check_block_double_backward(_replayed_blocks(cb, F, nf, True),
                                    what=f"layer-norm {order}stage 1")
        for what, x_shape, kw in _strided_block_cases():
            check_block_autograd(_replayed_blocks(cb, F, nf, True), x_shape,
                                 kw, f"layer-norm {order}{what}")
            check_block_double_backward(_replayed_blocks(cb, F, nf, True),
                                        x_shape, kw,
                                        f"layer-norm {order}{what}")
    print("[kernels] the conv kernels at pad 0 (K1 both modes, dgrad, "
          "wgrad) at the unpadded models' stages, pooled and strided; the "
          "unpadded blocks' derivatives", flush=True)
    check_unpadded_kernels(cb, F, records)
    for what, x_shape, kw in _unpadded_block_cases():
        for check, seed in ((check_block_autograd, 1),
                            (check_block_double_backward, 5)):
            apart, ties = _block_decisions_apart(cb, F, x_shape, kw, seed)
            print(f"  {what} (inputs of seed {seed}): the kernels' block and "
                  f"the plain block take {apart} pool/sign decisions apart "
                  f"on their own values, and {ties} pool windows hold an "
                  "exact tie at their maximum; held on the kernels' "
                  "decisions", flush=True)
            check(_replayed_blocks(cb, F, False), x_shape, kw, what)
    print(f"[kernels] {time.perf_counter() - t0:.1f} s", flush=True)
    print_k1_rows(records)
    print_k4_rows(records)
    print_k35_rows(records)

    main_counts = {k: 0 for k in all_kernels}
    t0 = time.perf_counter()
    serve_lines = {}
    for ingest in EXPAND_PER_DISPATCH:
        serve_lines[ingest], counts = run_serve_bench(ks, cfg, ingest)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    for ingest, line in serve_lines.items():
        print(f"[serve] {ingest:5s}: h2d_bytes_per_dispatch "
              f"{line['h2d_bytes_per_dispatch']}  adapt_ms p50 "
              f"{line['adaptation_latency_ms_p50']}  p95 "
              f"{line['adaptation_latency_ms_p95']}  tenants_per_sec "
              f"{line['tenants_per_sec']}", flush=True)

    print("[serve] the serve step vs the plain serve step", flush=True)
    check_small_against_plain(cfg, F, cb)
    check_against_plain(cfg, F, cb, cpu_spread=False)
    print("[serve] index ingest vs f32 ingest on the same pixels", flush=True)
    check_index_bit_identical(cfg)
    print("[profile] one bucket-8 and one bucket-1 f32 dispatch, one "
          "bucket-8 index dispatch", flush=True)
    profile_dispatch(cfg)
    profile_dispatch(cfg, "index", small=False)
    torch.cuda.empty_cache()
    print(f"[serve] {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for batch_size in TRAIN_TASKS:
        _, counts = run_train_bench(ks, cfg, batch_size)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    omniglot_name = "Omniglot 20-way 1-shot"
    for placement in ("device", "host"):
        _, counts = run_train_bench(ks, omniglot, omniglot.batch_size,
                                    OMNIGLOT, omniglot_name, placement)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[train] learning checks and profiles", flush=True)
    learning32 = check_learning()
    check_learning(OMNIGLOT, omniglot.batch_size)
    profile_train_step(cfg)
    profile_train_step(omniglot, omniglot.batch_size, "device")
    torch.cuda.empty_cache()
    print("[train] meta-gradients, kernels vs plain on the card", flush=True)
    check_grads_small(cfg, F, cb)
    check_grads_replayed(cfg, cb, F, seeds)
    check_grads_full_width(cfg, F, seeds)
    print(f"[train] {omniglot_name} full-width meta-gradients", flush=True)
    check_grads_replayed(omniglot, cb, F, omniglot_seeds)
    check_grads_full_width(omniglot, F, omniglot_seeds)
    print(f"[train] {time.perf_counter() - t0:.1f} s", flush=True)

    # the strided model (max_pooling=False): serving and training
    t0 = time.perf_counter()
    strided_name = f"{omniglot_name} strided"
    store_rows = serve_bench.serving_store_rows(strided)
    for ingest in ("f32", "index"):
        _, counts = run_serve_bench(ks, strided, ingest, OMNIGLOT,
                                    strided_name, STRIDED_ARGS)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[serve] strided: the serve step vs the plain serve step; index "
          "vs f32 on the same pixels", flush=True)
    check_small_against_plain(strided, F, cb)
    check_against_plain(strided, F, cb)
    check_index_bit_identical(strided, store_rows)
    _, counts = run_train_bench(ks, strided, strided.batch_size, OMNIGLOT,
                                strided_name, "device", STRIDED_ARGS)
    for k, v in counts.items():
        main_counts[k] += v
    torch.cuda.empty_cache()
    print("[train] strided: learning check, profile, meta-gradients",
          flush=True)
    learning_strided32 = check_learning(OMNIGLOT, strided.batch_size,
                                        STRIDED_ARGS)
    profile_train_step(strided, strided.batch_size, "device")
    check_grads_small(strided, F, cb)
    check_grads_replayed(strided, cb, F, strided_seeds)
    print(f"[strided] {time.perf_counter() - t0:.1f} s", flush=True)

    # the norm-first model (block_order='norm_conv_relu'): serving and
    # training at mini-ImageNet width; the strided norm-first model served
    t0 = time.perf_counter()
    nf_name = "mini-ImageNet 5-way 5-shot norm-first"
    for ingest in ("f32", "index"):
        _, counts = run_serve_bench(
            ks, norm_first, ingest, FLAGSHIP, nf_name,
            ("--store-rows", str(STORE_ROWS)) + NORM_FIRST_ARGS)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[serve] norm-first: the serve step vs the plain serve step; "
          "index vs f32 on the same pixels", flush=True)
    check_small_against_plain(norm_first, F, cb)
    check_against_plain(norm_first, F, cb, cpu_spread=False)
    check_index_bit_identical(norm_first)
    profile_dispatch(norm_first, small=False)
    torch.cuda.empty_cache()
    _, counts = run_train_bench(ks, norm_first, norm_first.batch_size,
                                FLAGSHIP, nf_name, None, NORM_FIRST_ARGS)
    for k, v in counts.items():
        main_counts[k] += v
    torch.cuda.empty_cache()
    print("[train] norm-first: learning check, profile, meta-gradients",
          flush=True)
    learning_nf32 = check_learning(FLAGSHIP, norm_first.batch_size,
                                   NORM_FIRST_ARGS)
    profile_train_step(norm_first)
    check_grads_small(norm_first, F, cb)
    check_grads_replayed(norm_first, cb, F, norm_first_seeds)
    snf_name = f"{omniglot_name} strided norm-first"
    _, counts = run_serve_bench(ks, strided_norm_first, "f32", OMNIGLOT,
                                snf_name, STRIDED_ARGS + NORM_FIRST_ARGS,
                                requests=4)
    for k, v in counts.items():
        main_counts[k] += v
    check_small_against_plain(strided_norm_first, F, cb)
    print(f"[norm-first] {time.perf_counter() - t0:.1f} s", flush=True)

    # the layer-norm model (norm_layer='layer_norm'): serving and training
    # at mini-ImageNet width; the norm-first and the strided layer-norm
    # models served
    t0 = time.perf_counter()
    ln_name = "mini-ImageNet 5-way 5-shot layer-norm"
    for ingest in ("f32", "index"):
        _, counts = run_serve_bench(
            ks, layer_norm, ingest, FLAGSHIP, ln_name,
            ("--store-rows", str(STORE_ROWS)) + LAYER_NORM_ARGS)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[serve] layer-norm: the serve step vs the plain serve step; "
          "index vs f32 on the same pixels", flush=True)
    check_small_against_plain(layer_norm, F, cb)
    check_against_plain(layer_norm, F, cb, cpu_spread=False)
    check_index_bit_identical(layer_norm)
    torch.cuda.empty_cache()
    _, counts = run_train_bench(ks, layer_norm, layer_norm.batch_size,
                                FLAGSHIP, ln_name, None, LAYER_NORM_ARGS)
    for k, v in counts.items():
        main_counts[k] += v
    torch.cuda.empty_cache()
    print("[train] layer-norm: learning check, meta-gradients",
          flush=True)
    learning_ln32 = check_learning(FLAGSHIP, layer_norm.batch_size,
                                   LAYER_NORM_ARGS)
    check_grads_small(layer_norm, F, cb)
    check_grads_replayed(layer_norm, cb, F, layer_norm_seeds)
    for c, config, name, extra in (
            (ln_norm_first, FLAGSHIP, f"{ln_name} norm-first",
             ("--store-rows", str(STORE_ROWS)) + NORM_FIRST_ARGS),
            (strided_ln, OMNIGLOT, f"{omniglot_name} strided layer-norm",
             STRIDED_ARGS)):
        _, counts = run_serve_bench(ks, c, "f32", config, name,
                                    extra + LAYER_NORM_ARGS, requests=4)
        for k, v in counts.items():
            main_counts[k] += v
        check_small_against_plain(c, F, cb)
        torch.cuda.empty_cache()
    print(f"[layer-norm] {time.perf_counter() - t0:.1f} s", flush=True)

    # the unpadded model (conv_padding=False): serving and training at
    # mini-ImageNet width; the strided, norm-first and layer-norm unpadded
    # models served; then the MAML (not ++) config, served and trained
    t0 = time.perf_counter()
    up_name = "mini-ImageNet 5-way 5-shot unpadded"
    store = ("--store-rows", str(STORE_ROWS))
    for ingest in ("f32", "index"):
        _, counts = run_serve_bench(ks, unpadded, ingest, FLAGSHIP, up_name,
                                    store + UNPADDED_ARGS)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[serve] unpadded: the serve step vs the plain serve step; index "
          "vs f32 on the same pixels", flush=True)
    check_small_against_plain(unpadded, F, cb)
    check_against_plain(unpadded, F, cb, cpu_spread=False)
    check_index_bit_identical(unpadded)
    torch.cuda.empty_cache()
    _, counts = run_train_bench(ks, unpadded, unpadded.batch_size, FLAGSHIP,
                                up_name, None, UNPADDED_ARGS)
    for k, v in counts.items():
        main_counts[k] += v
    torch.cuda.empty_cache()
    print("[train] unpadded: learning check, meta-gradients",
          flush=True)
    check_learning(FLAGSHIP, unpadded.batch_size, UNPADDED_ARGS)
    check_grads_small(unpadded, F, cb)
    check_grads_replayed(unpadded, cb, F, unpadded_seeds)
    up_strided = unpadded.replace(max_pooling=False)
    for c, name, extra in (
            (up_strided, f"{up_name} strided", STRIDED_ARGS),
            (unpadded.replace(block_order="norm_conv_relu"),
             f"{up_name} norm-first", NORM_FIRST_ARGS),
            (unpadded.replace(norm_layer="layer_norm"),
             f"{up_name} layer-norm", LAYER_NORM_ARGS)):
        _, counts = run_serve_bench(ks, c, "f32", FLAGSHIP, name,
                                    store + UNPADDED_ARGS + extra,
                                    requests=4)
        for k, v in counts.items():
            main_counts[k] += v
        check_small_against_plain(c, F, cb)
        torch.cuda.empty_cache()
    # the stride-2 pad-0 conv's stats-free mode runs in the strided
    # unpadded model's second-order backward only: 2 train steps
    _, counts = run_train_bench(ks, up_strided, up_strided.batch_size,
                                FLAGSHIP, f"{up_name} strided", None,
                                UNPADDED_ARGS + STRIDED_ARGS, warmup=1,
                                steps=2)
    for k, v in counts.items():
        main_counts[k] += v
    torch.cuda.empty_cache()
    maml_name = "mini-ImageNet MAML 5-way 5-shot"
    _, counts = run_serve_bench(ks, maml_cfg, "f32", MAML_JSON, maml_name,
                                store, requests=4)
    for k, v in counts.items():
        main_counts[k] += v
    check_small_against_plain(maml_cfg, F, cb)
    _, counts = run_train_bench(ks, maml_cfg, maml_cfg.batch_size, MAML_JSON,
                                maml_name, warmup=1, steps=2)
    for k, v in counts.items():
        main_counts[k] += v
    torch.cuda.empty_cache()
    print(f"[unpadded] {time.perf_counter() - t0:.1f} s", flush=True)

    # bf16 (compute_dtype='bfloat16'): its kernels; the padded model served
    # (f32 and index ingests) and the serve step against the plain ops; the
    # padded, unpadded and Omniglot models trained second order, the
    # learning check, a profile and the replayed meta-gradient gate; the
    # unpadded model served; the strided model, which must raise
    t0 = time.perf_counter()
    print("[kernels] the bf16 kernels (K1 with statistics and stats-free, "
          "K2/K3/K5 pooled, K4; the pad-0 convs) at the mini-ImageNet "
          "stages, the Omniglot layers and the unpadded stages", flush=True)
    check_bf16_kernels(cb, F, records)
    check_bf16_k3_shapes(cb, F, records)
    check_bf16_train_kernels(cb, F, records)
    bf16 = cfg.replace(compute_dtype="bfloat16")
    bf16_name = "mini-ImageNet 5-way 5-shot bf16"
    for ingest in ("f32", "index"):
        _, counts = run_serve_bench(ks, bf16, ingest, FLAGSHIP, bf16_name,
                                    store + BF16_ARGS)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[serve] bf16: the serve step vs the plain serve step; index vs "
          "f32 on the same pixels", flush=True)
    check_bf16_serve(cfg, F, cb)
    check_index_bit_identical(bf16)
    profile_dispatch(bf16, small=False)
    torch.cuda.empty_cache()
    # second-order training in bf16, each beside the f32 run of its batch
    for batch_size in TRAIN_TASKS:
        for c, name, extra in ((bf16, bf16_name, BF16_ARGS),
                               (cfg, "mini-ImageNet 5-way 5-shot", ())):
            _, counts = run_train_bench(ks, c, batch_size, FLAGSHIP, name,
                                        None, extra)
            for k, v in counts.items():
                main_counts[k] += v
            torch.cuda.empty_cache()
    up16 = unpadded.replace(compute_dtype="bfloat16")
    up16_name = f"{up_name} bf16"
    omniglot16 = omniglot.replace(compute_dtype="bfloat16")
    for c, config, name, placement, extra in (
            (up16, FLAGSHIP, up16_name, None, UNPADDED_ARGS + BF16_ARGS),
            (omniglot16, OMNIGLOT, f"{omniglot_name} bf16", "device",
             BF16_ARGS)):
        _, counts = run_train_bench(ks, c, c.batch_size, config, name,
                                    placement, extra)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[train] bf16: learning check, profile, meta-gradients",
          flush=True)
    _print_accuracy_gap(check_learning(FLAGSHIP, bf16.batch_size, BF16_ARGS),
                        learning32)
    profile_train_step(bf16)
    torch.cuda.empty_cache()
    check_grads_replayed(bf16, cb, F, bf16_seeds)
    check_grads_replayed(up16, cb, F, bf16_seeds)
    torch.cuda.empty_cache()
    # the unpadded bf16 model served
    for ingest in ("f32", "index"):
        _, counts = run_serve_bench(ks, up16, ingest, FLAGSHIP, up16_name,
                                    store + UNPADDED_ARGS + BF16_ARGS)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[serve] unpadded bf16: the serve step vs the plain serve step; "
          "index vs f32 on the same pixels", flush=True)
    check_bf16_serve(unpadded, F, cb)
    check_index_bit_identical(up16)
    print(f"[bf16] {time.perf_counter() - t0:.1f} s", flush=True)

    # bf16 strided and norm-first (phase 10): their kernels and blocks; the
    # strided Omniglot model and the norm-first mini-ImageNet model served
    # (f32 and index ingests) and trained second order beside f32, the
    # learning check, the replayed meta-gradient gate; 4 requests and 2
    # train steps each of the unpadded strided and the strided norm-first
    # models; the layer-norm model, which must raise
    t0 = time.perf_counter()
    print("[kernels] the strided and norm-first models' bf16 kernels (the "
          "stride-2 convs at pad 1 and 0, pool-free K2/K3/K5, GAP, "
          "bn_input_stats, batch_norm_*, act-pool) and their blocks' "
          "derivatives", flush=True)
    check_bf16_strided_kernels(cb, F, records)
    check_bf16_norm_first_kernels(cb, F, records)
    for what, x_shape, kw in _strided_block_cases():
        check_bf16_block_derivatives(cb, F, x_shape, kw, what, False)
        check_bf16_block_derivatives(cb, F, x_shape, kw,
                                     f"norm-first {what}", True)
    check_bf16_block_derivatives(cb, F, (T_TENANTS, 25, 42, 42, COUT), {},
                                 "norm-first stage 1", True)
    print(f"[bf16 kernels] {time.perf_counter() - t0:.1f} s", flush=True)
    strided16 = strided.replace(compute_dtype="bfloat16")
    strided16_name = f"{strided_name} bf16"
    for ingest in ("f32", "index"):
        _, counts = run_serve_bench(ks, strided16, ingest, OMNIGLOT,
                                    strided16_name, STRIDED_ARGS + BF16_ARGS)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[serve] strided bf16: the serve step vs the plain serve step; "
          "index vs f32 on the same pixels", flush=True)
    check_bf16_serve(strided, F, cb)
    check_index_bit_identical(strided16, store_rows)
    for c, name, extra in (
            (strided16, strided16_name, STRIDED_ARGS + BF16_ARGS),
            (strided, strided_name, STRIDED_ARGS)):
        _, counts = run_train_bench(ks, c, c.batch_size, OMNIGLOT, name,
                                    "device", extra)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[train] strided bf16: learning check, meta-gradients", flush=True)
    learning = check_learning(OMNIGLOT, strided.batch_size,
                              STRIDED_ARGS + BF16_ARGS)
    _print_accuracy_gap(learning, learning_strided32)
    check_grads_replayed(strided16, cb, F, strided16_seeds)
    torch.cuda.empty_cache()
    print(f"[bf16 strided] {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    nf16 = norm_first.replace(compute_dtype="bfloat16")
    nf16_name = f"{nf_name} bf16"
    for ingest in ("f32", "index"):
        _, counts = run_serve_bench(ks, nf16, ingest, FLAGSHIP, nf16_name,
                                    store + NORM_FIRST_ARGS + BF16_ARGS)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[serve] norm-first bf16: the serve step vs the plain serve step; "
          "index vs f32 on the same pixels", flush=True)
    check_bf16_serve(norm_first, F, cb)
    check_index_bit_identical(nf16)
    for c, name, extra in (
            (nf16, nf16_name, NORM_FIRST_ARGS + BF16_ARGS),
            (norm_first, nf_name, NORM_FIRST_ARGS)):
        _, counts = run_train_bench(ks, c, c.batch_size, FLAGSHIP, name,
                                    None, extra)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[train] norm-first bf16: learning check, profile, meta-gradients",
          flush=True)
    learning = check_learning(FLAGSHIP, norm_first.batch_size,
                              NORM_FIRST_ARGS + BF16_ARGS)
    _print_accuracy_gap(learning, learning_nf32)
    profile_train_step(nf16)
    torch.cuda.empty_cache()
    check_grads_replayed(nf16, cb, F, nf16_seeds)
    torch.cuda.empty_cache()
    print(f"[bf16 norm-first] {time.perf_counter() - t0:.1f} s", flush=True)
    # the smaller bf16 runs: the unpadded strided model (its backward is
    # the only path to the stride-2 pad-0 stats-free conv) and the strided
    # norm-first model (the pool-free act kernels), 4 requests and 2
    # second-order train steps each
    t0 = time.perf_counter()
    for c, config, name, extra, placement in (
            (up_strided.replace(compute_dtype="bfloat16"), FLAGSHIP,
             f"{up_name} strided bf16",
             store + UNPADDED_ARGS + STRIDED_ARGS + BF16_ARGS, None),
            (strided_norm_first.replace(compute_dtype="bfloat16"), OMNIGLOT,
             f"{snf_name} bf16", STRIDED_ARGS + NORM_FIRST_ARGS + BF16_ARGS,
             "device")):
        _, counts = run_serve_bench(ks, c, "f32", config, name, extra,
                                    requests=4)
        for k, v in counts.items():
            main_counts[k] += v
        train_extra = tuple(a for a in extra if a not in store)
        _, counts = run_train_bench(ks, c, c.batch_size, config, name,
                                    placement, train_extra, warmup=1,
                                    steps=2)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print(f"[bf16 small] {time.perf_counter() - t0:.1f} s", flush=True)

    # bf16 layer norm (phase 11): the layer norm's four bf16 kernels and the
    # layer-norm blocks' derivatives; the flagship layer-norm model served
    # (f32 and index ingests) and trained second order beside f32, the
    # learning check, a profile and the replayed gate; 4 requests and 2
    # train steps each of its norm-first, unpadded and strided Omniglot
    # variants
    t0 = time.perf_counter()
    print("[kernels] the layer norm's bf16 kernels (stats, forward, "
          "backward, double backward) at the mini-ImageNet stages of both "
          "orders and the strided Omniglot 2x2x64 map; the layer-norm "
          "blocks' derivatives in bf16", flush=True)
    check_bf16_layer_norm_kernels(cb, F, records)
    for nf in (False, True):
        order = "layer-norm norm-first" if nf else "layer-norm conv-first"
        check_bf16_block_derivatives(cb, F, (T_TENANTS, 25, 42, 42, COUT),
                                     {}, f"{order} stage 1", nf, True)
        for what, x_shape, kw in _strided_block_cases():
            check_bf16_block_derivatives(cb, F, x_shape, kw,
                                         f"{order} {what}", nf, True)
    print(f"[bf16 layer-norm kernels] {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    ln16 = layer_norm.replace(compute_dtype="bfloat16")
    ln16_name = f"{ln_name} bf16"
    for ingest in ("f32", "index"):
        _, counts = run_serve_bench(ks, ln16, ingest, FLAGSHIP, ln16_name,
                                    store + LAYER_NORM_ARGS + BF16_ARGS)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[serve] layer-norm bf16: the serve step vs the plain serve step; "
          "index vs f32 on the same pixels", flush=True)
    check_bf16_serve(layer_norm, F, cb)
    check_index_bit_identical(ln16)
    for c, name, extra in (
            (ln16, ln16_name, LAYER_NORM_ARGS + BF16_ARGS),
            (layer_norm, ln_name, LAYER_NORM_ARGS)):
        _, counts = run_train_bench(ks, c, c.batch_size, FLAGSHIP, name,
                                    None, extra)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print("[train] layer-norm bf16: learning check, profile, meta-gradients",
          flush=True)
    learning = check_learning(FLAGSHIP, layer_norm.batch_size,
                              LAYER_NORM_ARGS + BF16_ARGS)
    _print_accuracy_gap(learning, learning_ln32)
    profile_train_step(ln16)
    torch.cuda.empty_cache()
    check_grads_replayed(ln16, cb, F, ln16_seeds)
    torch.cuda.empty_cache()
    print(f"[bf16 layer-norm] {time.perf_counter() - t0:.1f} s", flush=True)
    # the variants: norm first (a layer norm over the 84x84x3 image at stage
    # 0), unpadded, and the strided Omniglot model (the 2x2x64 map, the
    # pool-free act kernels and the GAP), 4 requests and 2 second-order
    # train steps each
    t0 = time.perf_counter()
    for c, config, name, extra, placement in (
            (ln_norm_first.replace(compute_dtype="bfloat16"), FLAGSHIP,
             f"{ln_name} norm-first bf16", store + NORM_FIRST_ARGS, None),
            (unpadded.replace(norm_layer="layer_norm",
                              compute_dtype="bfloat16"), FLAGSHIP,
             f"{up_name} layer-norm bf16", store + UNPADDED_ARGS, None),
            (strided_ln.replace(compute_dtype="bfloat16"), OMNIGLOT,
             f"{omniglot_name} strided layer-norm bf16", STRIDED_ARGS,
             "device")):
        extra = extra + LAYER_NORM_ARGS + BF16_ARGS
        _, counts = run_serve_bench(ks, c, "f32", config, name, extra,
                                    requests=4)
        for k, v in counts.items():
            main_counts[k] += v
        train_extra = tuple(a for a in extra if a not in store)
        _, counts = run_train_bench(ks, c, c.batch_size, config, name,
                                    placement, train_extra, warmup=1,
                                    steps=2)
        for k, v in counts.items():
            main_counts[k] += v
        torch.cuda.empty_cache()
    print(f"[bf16 layer-norm variants] {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the training entry point (phase 12): cli train, resumed, at full
    # width, host and device tiers
    for k, v in check_runner(ks, card).items():
        main_counts[k] += v
    torch.cuda.empty_cache()

    idle = [k for k in all_kernels if not main_counts[k]]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    print_device_rows(records, "K2", ("bn_act_pool_fwd", "bn_act_fwd",
                                      "batch_norm_fwd"))
    print_device_rows(records, "B5", ("bn_input_stats",
                                      "global_avg_pool2d_fwd",
                                      "global_avg_pool2d_bwd"))
    print_device_rows(records, "K3f", ("bn_act_bwd", "batch_norm_bwd",
                                       "act_bwd"))
    print_device_rows(records, "K5f", ("bn_act_bwd_bwd",
                                       "batch_norm_bwd_bwd"))
    print_device_rows(records, "FWD", ("act_fwd", "layer_norm_fwd"))
    print_device_rows(records, "B2", ("act_pool_fwd", "act_pool_bwd",
                                      "act_pool_gather"))
    # the bf16 stride-1 convs on the tensor cores (bound at their rate)
    print_k1_rows(records, "K1", ("conv3x3_fwd_stats_bf16",
                                  "conv3x3_fwd_bf16",
                                  "conv3x3_p0_fwd_stats_bf16",
                                  "conv3x3_p0_fwd_bf16"))
    print_k1_rows(records, "K4", ("conv3x3_dgrad_bf16",
                                  "conv3x3_p0_dgrad_bf16",
                                  "conv3x3_wgrad_bf16",
                                  "conv3x3_p0_wgrad_bf16"))
    # K1 and dgrad at stride 2 (csrc/conv3x3_s2.cu), f32 and bf16
    s2 = tuple(f"conv3x3_s2{p}_{k}{d}" for d in ("", "_bf16")
               for p in ("", "_p0") for k in ("fwd_stats", "fwd"))
    print_k1_rows(records, "K1", s2)
    print_k1_rows(records, "K4", tuple(
        f"conv3x3_s2{p}_dgrad{d}" for d in ("", "_bf16") for p in ("", "_p0")))
    # K4 wgrad at stride 2 (csrc/conv3x3_wgrad_s2.cu), f32 and bf16, and K3
    # pooled in bf16 (csrc/bn_act_pool_bwd.cu)
    print_k1_rows(records, "K4", tuple(
        f"conv3x3_s2{p}_wgrad{d}" for d in ("", "_bf16") for p in ("", "_p0")))
    print_k1_rows(records, "K3", ("bn_act_pool_bwd_bf16",))
    # K5 pooled in bf16 (csrc/bn_act_pool_bwd.cu) and the layer norm's
    # double backward in both dtypes (csrc/layer_norm.cu)
    print_k1_rows(records, "K5", ("bn_act_pool_bwd_bwd_bf16",))
    print_k1_rows(records, "B5c", ("layer_norm_bwd_bwd",
                                   "layer_norm_bwd_bwd_bf16"))

    kernels = []
    for k in all_kernels:
        r = records.by_kernel[k][REPORT_AT[k]]
        route, source = SOURCES[k]
        kernels.append({
            "name": k, "route": route, "source": source,
            "replaces": REPLACES[k], "launches": main_counts[k],
            "max_abs_err": max(v["max_abs_err"]
                               for v in records.by_kernel[k].values()),
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "f32_ms": r["f32_ms"],
            "shape": REPORT_AT[k],
        })
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
