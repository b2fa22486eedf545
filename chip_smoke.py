#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lmnet_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases, each printing a line, any failure raising (exit code != 0):
  1. the device (nvidia-smi name and power limit, torch and CUDA versions);
  2. build the ten kernel sources (csrc/nat_fwd.cu, nat_bwd.cu, rc_dw_gelu.cu,
     rc_stats.cu, rc_fused.cu, nat_kernel.cu, upsample_flat.cu,
     natt_flat.cu, bn_train.cu, layer_norm.cu) with nvcc for sm_90a, one process
     per source, all started together; print ptxas's registers and spills of
     every source's kernels and the number of HMMA/HGMMA
     (tensor-core) instructions in rc_fused's and natt_flat's libraries
     (cuobjdump, where it is found);
  3. the forward kernel against its plain PyTorch version, in float32
     (TF32 off) and bfloat16, at the four NAT stage shapes of the 256^2
     model (B=2) and of the 288^2 training epoch (B=16), at H=W=28 with
     head_dim 3, at H=W=3 and on a narrow W=4 map;
  4. the serving path: the full-width LMNet from a seeded generator (BN
     running statistics and LayerNorm affines randomised from it too),
     serving_evaluate over
     make_loader(SyntheticDataset(32, 256, 'val', seed=0), 16) with every
     kernel launch counted, and two checks of the output: the deploy graph
     against the model's own eval forward (float32, small input), and the
     'flat' NAT backend against 'plain' on one served bf16 batch;
  5. serving times from CUDA events after a warm-up: the forward kernel at
     each 256^2 stage shape (B=16, bf16; its output held against the plain
     one as in phase 3), eagerly and as a CUDA graph of the same call
     (device time alone), beside its bytes, GB/s, bound and the launch
     plan's variant, which must be the vectorised one; the plain version;
     and the serving rate at 256^2, B=16;
  6. the backward kernel against the plain backward (autograd of the plain
     NAT) for dq, dk, dv and d_rpb, in float32 and bfloat16, at the shapes
     of phase 3, and two calls bitwise equal (288^2 stage, B=16);
  7. the training path: create_train_state(LMNet(dtype=bf16, rc_remat=True))
     -> train_one_epoch(augment_on_device=False) over
     make_loader(SyntheticDataset(32, 256, 'train'), 16) (the 'train' split
     loads 288^2 images, as the JAX loop sees them without augmentation) ->
     evaluate over a 256^2 val set, every kernel launch counted; then 8
     steps on one fixed batch must lower the loss;
  8. 'flat' against 'plain' NAT on one train_step: float32 at 64^2, B=2
     (the loss and every gradient), bf16 at full width, 256^2, B=16 (the
     loss and the gradients of every NAT layer, each backend against a
     float32 step from the same weights);
  9. training times from CUDA events after a warm-up: the backward kernel
     at each 256^2 stage (B=16, bf16; its output held against the plain one
     as in phase 6), eagerly and as a CUDA graph, with bytes, GB/s, bound
     and variant as in phase 5 (vectorised at all four stages), the plain
     backward, and
     train_step at 256^2, B=16, bf16, rc_remat=True with flat and with
     plain NAT in turns (img/s, peak device memory, NAT launches per step);
     a torch.profiler pass over flat train steps (kernel launches, device
     busy time and the top ops by device time per step); one more step
     under CUDA's sync debug mode must make no host sync;
 10. the ReparamConv kernels against their plain versions, float32 (TF32
     off for convs and matmuls) and bfloat16: B5 (rc_dw_gelu) and B6
     (rc_stats) at every ReparamConv shape of the 256^2 model (B=2) and of
     the 288^2 training epoch (B=16), B4 (rc_fused) at the five
     (H, Cin, E, Cout) of the 256^2 model (B=2), all three on a 5x5 map, a
     28^2 map with E=20 and a W=7 strip (bf16 B4, whose 1x1 products run on
     the tensor cores, two ways: against the plain version that rounds at
     its points and against the float32 plain version); B5's sums and B4's
     phase-1 sums bitwise equal over two calls, B6's statistics at every
     shape;
 11. serving at full width, 256^2, B=16, bf16, with rc_backend 'flat',
     'pallas' and 'auto' (serving_evaluate, launches counted; the pair
     'auto' picked and its timing table), each backend's logits against
     'xla' on one batch, deploy_forward times per backend in turns, and B4
     and B5 against their plain versions at the inputs of the 16 blocks of
     a served batch, timed beside their plain versions and the stock bf16
     compositions that serve by default ('xla'), in total and for each of
     the five block shapes;
 12. training with LMNet(dtype=bf16, rc_remat=True,
     rc_train_backend='fused'): one 'train' epoch at 288^2, B=16 with the
     B5 and B6 launches counted, evaluate; 'fused' against 'xla' on one
     train_step (float32 at 64^2, B=2: the loss, every gradient, all
     running statistics; bf16 at 256^2, B=16: the loss and the gradients
     of every ReparamConv block, each against a float32 'xla' step);
     train_step times for both in three turns each with peak memory, a
     torch.profiler pass over two steps of each (device kernels and busy
     time per step), and B6 against its plain version at the inputs of the
     16 blocks of a training forward (bitwise repeated), timed for each of
     its four block shapes eagerly and as a CUDA graph, beside its plain
     version and the stock bf16 composition that 'xla' training runs for
     the same statistics (stats_stock);
 13. B3 (nat_kernel, nat_backend='pallas') against the plain NAT and against
     B1 on the same inputs, float32 and bfloat16, at phase 3's shapes and
     the timed 256^2 B=16 stage inputs, each with its launch plan's variant
     ('vec' with a rank-2 or rank-3 tensor map, or 'generic'), tile and
     persistent blocks, and against the plain NAT alone at shapes of other
     head counts (B3_VARIANT_SHAPES: float32 rank-2 maps); B3 and B1 times
     per stage, eager and as a CUDA
     graph, and the plain version's;
     serving_evaluate with nat_backend='pallas' (launches counted, logits
     against 'flat'); train_step with LMNet(nat_backend='pallas'): float32
     at 64^2, B=2 (the loss and every gradient against 'flat') and bf16 at
     full width (the NAT layers' gradients against a float32 step, as phase
     8, B3 launches counted), and its time beside 'flat';
 14. B7 (upsample_flat) with the upsample backend set to 'flat': against its
     plain version at the 7 upsample shapes of the 256^2 model (B=16 and
     B=2) and a few odd shapes, float32 and bfloat16, each with its launch
     plan's variant ('tma', or 'generic' where a pixel's bytes are not a
     multiple of 16) and tile; its backward against autograd of the plain
     version; serving_evaluate and a 'train' epoch with its launches
     counted; each of the 7 calls of a served batch timed eagerly, as a
     CUDA graph and in a graph of 10 calls (its device time), with the
     host's microseconds a call (eager less device), beside the plain
     version and F.interpolate (the library call), and their sums;
 15. the serving options natt_int8, ln_fold and skip_compose at full width,
     256^2 B=16 bf16: logits against the default's, and deploy_forward
     times in turns;
 16. B8 (natt_flat) on the embeddings of the four NATT stages of a served
     batch: launches counted, against its plain versions (check_b8: float32;
     bf16, whose products run on the tensor cores, two ways) at the four
     stages and at B8_SHAPES, each stage timed eagerly and as a CUDA graph
     beside the unfused interior deploy_forward runs (eager and graph).
 17. the training CLI (python -m lmnet_tpu_torch.cli.train, called as
     cli.main) at full width with --apm, 256^2, --synthetic (8 'train'
     images at 288^2, 4 'val'), --batch_size 8, in a temporary directory
     under build/: 2 epochs, --resume to 3, --test --hd95, --test --serve
     (loss within max(5 %, 0.05) and Dice within 0.02 of the eval path's),
     --visualization (every PNG read back with data/png.py), --export PATH
     (the best checkpoint's deploy artifact, kept for phase 19); the CSV
     shapes, finite values, checkpoint files and the resume line, and the
     B1 and B2 launches each command implies; then train_one_epoch with the
     on-device
     augmentation over SyntheticDataset(64, 256, 'train') at B=16, with
     apply_params on the card held against the CPU for each batch's drawn
     parameters (images within 1e-3 normalised on all but 0.1 % of the
     values, masks >= 99.9 % equal), B1 and B2 launches counted, the
     augmentation's ms per batch of 16 (288^2 -> 256^2, CUDA events) and
     the epoch's img/s with the augmentation on and off (host clock, in
     turns);
 18. the model options (LMNet's gelu_exact, rc_remat, natt_remat): each of
     rc_remat False and 'branches' ('xla'), 'branches' with
     rc_train_backend='fused', and natt_remat (flat NAT) on one train_step
     against the default (rc_remat=True, 'xla', natt_remat off), dropout on
     from one generator seed: float32 at 64^2, B=2 (loss rel 1e-5, every
     gradient as phase 8), bf16 at 256^2, B=16 (the loss and each block's
     gradients no further from a float32 default step than twice the bf16
     default's distance plus phase 8's slack); under natt_remat the loss
     bitwise equal to the default's and the generator's state after the
     step equal. One counted step each of natt_remat (B1 8, B2 4) and
     'branches' + 'fused' (B5 and B6 32 each); ms a step (CUDA events, in
     turns there and back) and peak device memory of the five; one
     gelu_exact step, and LMNet(gelu_exact=True, rc_train_backend='fused')
     must raise;
 19. the export and the daemon: save_deploy of the seeded full-width model
     on the card and on the CPU, each loaded onto the card, and phase 17's
     --export file: logits at B=1, 3 and 16 (256^2, bf16) within 0.05 x
     max(scale, 1) of deploy_forward(nat 'plain', rc 'xla'), argmax flips
     < 2.5 %; the card's artifact loaded on the CPU (B=1, against the
     card); the artifact's ms beside eager deploy_forward at its default
     backends, in turns; the daemon's HTTP server on 127.0.0.1 port 0
     (max_batch 64, max_wait_ms 5) driven through the loaded artifact and
     through a default-backend deploy_forward closure (B1 launches
     counted): 8 client threads x 16 requests of 1-4 images from a seeded
     generator, every mask against the argmax of the same fn on the
     request alone (flips < 2.5 %), /healthz's counts against what was
     sent, img/s, per-request p50/p99 latency, batches and padded images;
     ``python -m lmnet_tpu_torch.serve.daemon --artifact ... --port 0`` is
     started as a subprocess on the CPU's file while the checks run: its
     "serving on" line, one POST, terminated before anything is timed.
 20. the data-parallel path (lmnet_tpu_torch/parallel/): (a) the twelve
     losses, the confusion matrix, binary_iou/binary_dice and
     derived_metrics on the card against the same calls on the CPU
     (float32; losses rel 1e-5, counts exact); (b) ``python -m
     torch.distributed.run --standalone --nproc_per_node 1 chip_smoke.py
     --cli-rank ...``: the CLI with --distributed True on one NCCL rank,
     1 epoch at 256^2, --apm, B=8: exit 0, rank 0's CSV and checkpoints,
     B1 8 and B2 4 launches, the CSV row against the same command without
     --distributed and its float32 form (the losses by the bf16 rule of
     "a kernel on the train step", the metrics within 0.02); (c)
     ``--nproc_per_node 2 chip_smoke.py --ddp-rank DIR``: two ranks on the
     one card over gloo (NCCL refuses two ranks on a device), each running
     its 8 rows of a bf16 256^2 B=16 train_step ('flat' NAT, 'fused'
     ReparamConv, rc_remat, dropout on) with B1, B2, B5 and B6 launched on
     each rank (4, 4, 32, 32), held against the one-process step on the
     same 16 images and seeded weights by the bf16 rule (the loss, each
     block's gradients, each BatchNorm's running statistics, the confusion
     matrix, all against a float32 step); a float32 64^2 B=4 step (loss
     rel 1e-5, each gradient as phase 8, running statistics rtol 1e-4);
     the ranks' parameters bitwise equal after each step; evaluate
     (float32: loss rel 1e-5, accuracy moved on < 1e-4 of the pixels) and
     serving_evaluate (bf16, B1 on each rank: the serving rule) over 9
     images in batches of 4, 4, 1; ms a step of one process and of the two
     ranks (gloo's all-reduces go through the host) and the all-reduces a
     step. B1's, B2's, B5's and B6's ``launches_by_path`` gain 'ddp' (the
     two ranks' own counters summed) and B1's and B2's 'ddp_cli'.
 21. the mesh's 'spatial' axis (lmnet_tpu_torch/parallel/spatial.py): B1
     and B2 against their plain versions at the four NAT slabs a rank gives
     them at 512^2 (B=4; H = 257, 129, 65, 33, W.C = 6144), bf16 and
     float32, each plan 'vec', the bf16 calls timed beside their byte
     bounds; ``--nproc_per_node 2 chip_smoke.py --spatial-rank DIR``: two
     gloo ranks on the card on a (1 x 2) mesh, each running its 256 rows
     of a bf16 512^2 B=4 train_step of the default model ('flat' NAT,
     'xla' ReparamConv, rc_remat, dropout on; B1 4 and B2 4 a rank), held
     against the one-process step by the bf16 rule; a float32 64^2 B=2
     step by phase 20's fp32 rule; the ranks' parameters bitwise equal;
     evaluate (float32, HD95 on the gathered maps) and serving_evaluate
     (bf16, B1 on each slab) over 5 images in batches of 2, 2, 1 by the
     eval and serving rules; ms a step of one process and of the two
     ranks, and a step's halo exchanges and all-reduces; then
     ``parallel.dryrun.dryrun_multichip(4, device='cuda')``: four gloo
     ranks on the card, (2 x 2). The row-window kernels: B4, B5,
     B6 and B7 on each rank's slab at every shape the 512^2 path gives
     them (the ReparamConv blocks' five, h = 256 .. 32 rows, W = 512 ..
     64; the upsamples' four), bf16 and float32, against their plain
     versions on the slab and against the same kernel on the whole map
     (rows, and the ranks' sums added), rank 0's bf16 slab calls timed
     beside their byte bounds; on the ranks, the bf16 512^2 B=4 step with
     rc_train_backend='fused' and the flat upsample (B1, B2, B5, B6, B7
     on every rank) against one process by the bf16 rule, the fp32 64^2
     step by the fp32 rule, and serving_evaluate with rc_backend 'flat'
     and 'pallas' (B5 or B4, B1, B7) by the serving rule, each path's
     launches a rank checked. B1's, B2's, B4's, B5's, B6's and B7's
     ``launches_by_path`` gain 'spatial' (the two ranks' counters summed)
     and their entries ``ms_by_slab``.
 22. the convergence-parity protocol (lmnet_tpu_torch/parity/convergence.py,
     ROADMAP A9): each arm ('fp32': erf GELU, B1 and B2; 'fused': tanh
     GELU, rc_train_backend='fused' and the flat upsample, B1, B2, B5, B6,
     B7; 'bf16': the CLI's --apm model, B1 and B2) trains the full-width
     model for 48 epochs of the reference recipe at 64^2 (48 train / 16 val
     images, B=8, 288 steps, dropout off, torch's deterministic algorithms
     on), the eval-mode forward scoring the val split after each epoch, from
     4 draws of the numpy init (draw 0 the init itself, draws 1-3 perturbed
     at 1e-6), each draw a ``chip_smoke.py --convergence-draw`` child, all
     12 at once (each host-bound), held against JAX's records of the same
     draws (lmnet_tpu_torch/parity/ref/jax_<arm>_seed0[_p<k>].json, made on
     a CPU by tests/_torch_convergence_jax.py): each draw's init digest
     equal, draw 0's epoch-1 last-step loss within rtol 5e-3 (bf16: 2e-2),
     the gap of the two sides' mean best-val Dice under 0.5 points (bf16:
     1.0);
     draw 0's best-val-IoU checkpoint is reparameterised and served over
     the val split through B1, B3, B5 and B4, each with B7: val Dice within
     0.1 point of the eval forward's, pixel agreement >= 99.9 % (bf16:
     99.5 %). One line an arm (draw 0's best epochs, Dice and IoU on both
     sides, every draw's Dice, the gaps, wall seconds, launches), draw 0's
     losses every 6 epochs, one line a served backend. Every kernel's
     ``launches_by_path`` gains 'convergence' (B1-B7).
 23. JAX's multi-host mode (a node stands for a JAX process, with its own
     data): two torchrun agents, ``--nnodes 2 --node_rank 0|1``, on the one
     card, their ranks over gloo (``chip_smoke.py --mh-rank DIR LAYOUT``).
     On 2 nodes x 1 rank: each node loads its own 8 of phase 20's 16
     images and runs its step of the bf16 256^2 global batch of 16 ('flat'
     NAT, 'fused' ReparamConv, rc_remat, dropout on; B1, B2, B5, B6 4, 4,
     32, 32 a rank), held against phase 20's one-process step on the 16 by
     the bf16 rule, the nodes' parameters bitwise equal; evaluate
     (float32, cross-host) of each node's shard of phase 20's eval set (5
     and 4 images) against one process over both shards (loss rel 1e-5,
     accuracy moved on < 1e-4 of the pixels) and serving_evaluate (bf16,
     B1) of the nodes' batches as global batches against one process on
     the concatenated batches (the serving rule); ms a step a rank. On 2
     nodes x 2 ranks: the float32 64^2 step on each node's 2 of phase 20's
     4 images (1 row a rank) by phase 20's fp32 rule against its one
     process; then the CLI (--apm --distributed True, --batch_size 4 a
     node, 1 epoch at full width, 256^2) on the nodes' train and val
     shards: rank 0's files, one finite 16-column row, B1 8 and B2 4 a
     rank. B1's, B2's, B5's and B6's ``launches_by_path`` gain 'multihost'
     (every rank of both runs summed).
 24. bench_torch.py, JAX's bench.py protocol on the port at B=128: (a) B1
     at the four NAT stages of 256^2, 384^2 and 512^2 inputs (the 512^2
     stage's q, k and v 805 MB each, every byte offset past 2^31) and (b)
     B2 at the 256^2 stages, bf16, the whole batch in one launch, held on
     images 0, 1, 126, 127 against the plain version of those images alone
     at phases 3's and 6's tolerances, B2's d_rpb against the plain one
     summed over chunks of 16 images, the C plans equal to nat_plan; (c)
     B=128 distinct random bf16 images at each size through deploy_forward,
     the logits of those four images against deploy_forward of them alone
     by the serving rule; (d) one bf16 256^2 B=128 train_step (dropout off;
     B1 4, B2 4) against the plain NAT's from the same weights, each
     measured against a float32 plain step, with the three steps' peak
     memory; then the protocol timed through bench_torch.run (serving at
     256^2, training at 256^2, serving at 384^2 and 512^2, B=128, chains
     of 10): each configuration's ms a step, peak GiB and launches,
     bench.py's seven numbers, the launches exactly the chains' (B1 4 a
     forward or step, B2 4 a step; B4-B7 none). B1's and B2's ``launches_by_path`` gain 'bench'
     (the timed protocol) and 'bench_checks' ((c) and (d)).
 25. the train-mode BatchNorm kernels (csrc/bn_train.cu, ops/bn_train.py)
     at the eight BatchNorm shapes of the 256^2 training step (the blocks'
     expand widths 24/48/96/192 at 256^2 .. 32^2, the skips' 12/24/48/96):
     y, mean, var, dx, dgamma and dbeta in bf16 against the plain version
     (the tolerances of tests/test_torch_bn_train.py), at B=2 and again at
     B=128, the train cell's size, where each thread of the statistics
     kernels walks its periods four at a time, and at SegFormer-B5's head
     (B=8, 256^2, 768 channels: 96 vectors a period), its launches
     counted; at B=128
     each shape's forward and forward + backward timed as CUDA graphs
     (device time) for the kernels, the plain version and F.batch_norm (the
     one-call yardstick,
     which the port never calls), summed over a step of the train cell (a
     block's BatchNorm forward twice under rc_remat, a skip's once, each
     backward once) beside the step's byte bound (x read and y written once
     a forward, dy and x read and dx written once a backward). Then the
     launches of a bf16 256^2 train_step at B=2: 84 + 80 forwards and 84
     backwards. The kernels line's ``launches_by_path`` for bn_train holds
     that step's launches and those of every training phase before it (by
     phase name; the children of phases 20-23 as ``ddp_ranks``, ``ddp_cli``,
     ``spatial_ranks``, ``convergence_draws``, ``multihost_ranks``), each
     training path's above 0.
 26. the LayerNorm kernels (csrc/layer_norm.cu, ops/layer_norm.py) at the
     LayerNorm shapes of the two train cells: SegFormer-B5's at 1024^2, B=8
     (its four stage widths 64/128/320/512 on the stages' maps, and the
     reductions' 64/128/320 on their 32^2 maps: 161 a forward) and LM-Net's
     at 256^2, B=128 (the NATT blocks' 12/24/48/96, the GFT's 372: 10 a
     forward), bf16: y, dx, dweight and dbias against the plain version on
     the inputs' float32 copies (the tolerances of
     tests/test_torch_layer_norm.py), their launches
     counted; each shape's forward and forward + backward timed as CUDA
     graphs for the kernels, the plain version and F.layer_norm (the
     one-call yardstick, which the port never calls), each beside its byte
     bound (x read and y written once a forward, dy and x read and dx
     written once a backward) and as a share of it, and summed over a step
     of each cell (every LayerNorm forward and backward once). Then the
     main path's launches, counted exactly (``ln_main_path``): a bf16 256^2
     LM-Net train_step (B=2) launches 10 forwards and 10 backwards;
     SegFormer-B5 at B=1, 256^2, bf16, 161 and 161 in an eager forward and
     backward (train=False), 3 x 161 and 2 x 161 in its first graphed train
     step (a pass without gradients, the warm-up, the capture) and none in
     the second (the graphs replay). The kernels line's ``launches_by_path``
     for layer_norm holds those counts, the phase's own checks and timing
     captures ('phase_26'), and the launches of every training phase of
     this process by phase name (the children of phases 20-23 are not
     counted), each of phases 8, 18, 24 and 25 above 0.

Each kernel's bound is the least time the card could take for its work at
the inputs it was timed on: the largest of its bytes (each input read once,
each output written once) at 3.35 TB/s, its float32 operations at 67
TFLOP/s, and its operations that the tensor cores can take (B4's three 1x1
products, B8's six C-mixing products) at 989 TFLOP/s (bf16, dense). B1's,
B2's, B3's, B6's and B8's entries also carry ``ms_by_stage``: phase 5's,
9's, 13's, 12's and 16's per-stage (B6: per block shape) eager and
CUDA-graph times; B7's carries ``ms_by_call``, phase 14's per-call times,
and ``host_us``;
B4's, B5's and B6's carry ``xla_ms``, the stock bf16 composition's time.

B1's and B2's ``launches_by_path`` include phase 17's CLI cycle ('cli') and
augmented epoch ('train_augment'), and phase 18's counted steps
('natt_remat', 'rc_remat_branches'); B1's also phase 19's closure drive
('daemon'); B5's and B6's 'rc_remat_branches' (B6's entry carries
``launches_by_path`` since phase 18).

The script's wall seconds come on a line before the kernels line, which
lists every kernel of the paths as JSON; the line before the last is the
card's name and power limit as nvidia-smi prints them; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

BATCH = 16
IMG = 256
# (H, W, C) of the four NAT stages at 256^2 inputs, 12 heads: natt4 .. natt1
STAGES_256 = [(256, 256, 12), (128, 128, 24), (64, 64, 48), (32, 32, 96)]
# the same at the 'train' split's 288^2 load size, which the training epoch sees
STAGES_288 = [(288, 288, 12), (144, 144, 24), (72, 72, 48), (36, 36, 96)]
HEADS = 12
# (B, H, W, C) at which phases 3 and 6 hold each kernel against its plain
# version: the 256^2 stages at B=2, the training epoch's 288^2 stages at
# B=16, and the shapes TPU kernels leave to XLA (head_dim 3, H=W=3, W=4);
# the 256^2 stages at B=16 are checked on the inputs phases 5 and 9 time
CHECK_SHAPES = ([(2, h, w, c) for h, w, c in STAGES_256]
                + [(BATCH, h, w, c) for h, w, c in STAGES_288]
                + [(2, 28, 28, 36), (2, 3, 3, 24), (2, 16, 4, 48)])
# (B, H, W, heads, head_dim) at which phase 13 also holds B3 against the
# plain NAT, shapes of other head counts than the model's: float32 C = 6
# and 3 x 2 (a rank-2 map, 8 bytes a thread; generic in bf16, where no
# thread group divides C = 6), bf16 C = 20 (rank 2, 4 mod 8)
B3_VARIANT_SHAPES = [(1, 8, 8, 6, 1), (2, 9, 10, 6, 1), (1, 7, 12, 3, 2), (2, 11, 16, 5, 4)]
# (B, H, W, Cin, E, Cout) at which phase 10 holds B4 against its plain
# version: the five distinct ReparamConv shapes of the 256^2 model at B=2,
# then a 5x5 map, a 28^2 map with E=20 and a W=7 strip
RC_SHAPES = ([(2, 256, 256, 3, 24, 12), (2, 256, 256, 12, 24, 12), (2, 128, 128, 24, 48, 24),
              (2, 64, 64, 48, 96, 48), (2, 32, 32, 96, 192, 96)]
             + [(2, 5, 5, 24, 48, 24), (2, 28, 28, 12, 20, 12), (2, 32, 7, 24, 48, 24)])
# (B, H, W, E) at which phase 10 holds B5 and B6 against theirs: the
# depthwise shapes of the 256^2 model (B=2), of the 288^2 training epoch
# (B=16), and the small maps above
DW_SHAPES = ([(2, h, w, 2 * c) for h, w, c in STAGES_256]
             + [(BATCH, h, w, 2 * c) for h, w, c in STAGES_288]
             + [(2, 5, 5, 48), (2, 28, 28, 20), (2, 32, 7, 48)])
RC_KERNELS = ("rc_dw_gelu", "rc_stats", "rc_fused")
KERNELS = ("nat_fwd", "nat_bwd", *RC_KERNELS, "nat_kernel", "upsample_flat", "natt_flat",
           "bn_train", "layer_norm")
# H100 SXM: HBM3 bytes per second; float32 operations per second outside
# the tensor cores; bf16 operations per second on the tensor cores, dense
# (NVIDIA's data sheet)
HBM_RATE = 3.35e12
F32_RATE = 67e12
TC_RATE = 989e12


class Work:
    """Bytes moved, float32 operations and tensor-core operations of a
    kernel's calls, summed."""

    def __init__(self):
        self.nbytes = self.flops = self.tc_flops = 0.0

    def add(self, nbytes, flops, tc_flops=0.0):
        self.nbytes += nbytes
        self.flops += flops
        self.tc_flops += tc_flops

    def terms(self) -> dict:
        """Least milliseconds for each: the bytes at HBM_RATE, the float32
        operations at F32_RATE, the tensor-core operations at TC_RATE."""
        return {"bytes": self.nbytes / HBM_RATE * 1e3, "f32": self.flops / F32_RATE * 1e3,
                "tensor_core": self.tc_flops / TC_RATE * 1e3}

    def bound(self) -> tuple[float, str]:
        """(least milliseconds, what bounds them): the largest of the three
        terms, 'bytes' or 'operations' (float32 or tensor-core)."""
        t = self.terms()
        ms = max(t.values())
        return ms, "bytes" if t["bytes"] >= ms else "operations"


def nat_fwd_work(q, C) -> tuple[float, float]:
    """NAT forward on q (C channels a pixel, HEADS heads): q, k, v in and
    out once; per element 9 logit and 9 weighted-sum multiply-adds, per
    (pixel, head) ~36 softmax operations."""
    return 4 * q.numel() * q.element_size(), 36 * q.numel() + 36 * (q.numel() // C) * HEADS


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, calls: int = 1) -> float:
    """Milliseconds per call of ``fn`` captured ``calls`` times in one CUDA
    graph, per replay over ``calls``: the device time of its launches, with
    no host work between them. A call of a few microseconds needs several
    calls a graph, or the replay's own host cost is what is measured."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    return cuda_ms(g.replay, iters=iters) / calls


def stage_line(label, name, B, H, W, C, nbytes, ms, g_ms, plan, card_line) -> dict:
    """Print one stage's eager and CUDA-graph times beside its bytes, rate,
    bound and the plan's variant; return them as the kernels line keeps
    them. The stage must take the vectorised variant."""
    bound = nbytes / HBM_RATE * 1e3
    print(f"{label}: {name} stage H={H} W={W} C={C} hd={C // HEADS} B={B} bf16 "
          f"[{plan['variant']}, tile {plan['tile'][0]}x{plan['tile'][1]}, "
          f"{plan['heads_per_block']} heads a block, {plan['threads']} threads, "
          f"{plan['smem']} B shared]: eager {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
          f"CUDA graph {g_ms:.4f} ms ({nbytes / g_ms / 1e6:.1f} GB/s) of {nbytes / 1e6:.1f} MB, "
          f"bound {bound:.4f} ms [{card_line}]")
    check(plan["variant"] == "vec", f"{name} at H={H} C={C} took the {plan['variant']} variant")
    return {"H": H, "W": W, "C": C, "hd": C // HEADS, "variant": plan["variant"],
            "mb": nbytes / 1e6, "bound_ms": bound, "ms": ms, "graph_ms": g_ms,
            "gb_s": nbytes / ms / 1e6}


def nat_inputs(B, H, W, C, dtype, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(B, H, W * C, generator=g).to(dev, dtype) for _ in range(3))
    rpb = (torch.randn(HEADS, 5, 5, generator=g) * 0.3).to(dev)
    return q, k, v, rpb


def check_fwd(label, got, q, k, v, rpb, B, H, W, C, name="nat_fwd") -> float:
    """Hold a NAT forward kernel's output ``got`` (flat) against the plain
    NAT on q, k, v upcast to float32; print one line; raise if they
    disagree."""
    from lmnet_tpu_torch.ops.nat import neighborhood_attention

    ref = neighborhood_attention(
        *(t.float().reshape(B, H, W, C) for t in (q, k, v)), rpb, 3
    ).reshape(B, H, W * C)
    err = (got.float() - ref).abs()
    if q.dtype == torch.float32:
        tol = "abs 1e-5"
        ok = bool((err <= 1e-5).all())
    else:  # one bf16 rounding of the stored result (2^-9 relative), with margin
        tol = "2^-8*|ref| + 1e-4"
        ok = bool((err <= 2**-8 * ref.abs() + 1e-4).all())
    e = err.max().item()
    print(f"{label}: {name} vs plain B={B} H={H} W={W} C={C} hd={C // HEADS} "
          f"{str(q.dtype).split('.')[-1]}: max_abs_err={e:.3e} (tol {tol}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagrees with plain at {(B, H, W, C, q.dtype)}: {e}")
    return e


def phase_kernel_vs_plain(dev) -> float:
    from lmnet_tpu_torch.ops.nat_flat import nat_flat

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for i, (B, H, W, C) in enumerate(CHECK_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, rpb = nat_inputs(B, H, W, C, dtype, i, dev)
            got = nat_flat(q, k, v, rpb, HEADS, C, W)
            worst = max(worst, check_fwd("phase 3", got, q, k, v, rpb, B, H, W, C))
    return worst


def seeded_model(dev):
    from lmnet_tpu_torch.models import LMNet
    from lmnet_tpu_torch.models.blocks import BatchNorm, LayerNorm

    g = torch.Generator().manual_seed(0)
    model = LMNet(generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
            elif isinstance(m, LayerNorm):  # so that ln_fold folds a real affine
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return model.to(dev).eval()


def phase_serving(model, dev):
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.ops.nat_flat import nat_flat
    from lmnet_tpu_torch.serve import deploy_forward, serving_evaluate

    n_images = 32
    n_batches = (n_images + BATCH - 1) // BATCH
    state = model.state_dict()
    deploy = structural_reparam(state)
    torch.cuda.synchronize()

    nat_flat.launches = 0
    t0 = time.perf_counter()
    loss, metrics = serving_evaluate(
        state, make_loader(SyntheticDataset(n_images, IMG, "val", seed=0), BATCH),
        num_classes=2, img_size=IMG, num_heads=HEADS,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nat_flat.launches
    print(f"phase 4: serving_evaluate {n_images} images at {IMG}^2 B={BATCH}: "
          f"loss={loss:.6f} metrics={json.dumps(metrics)} wall={wall:.3f}s "
          f"nat_fwd launches={launches}")
    check(np.isfinite(loss) and all(np.isfinite(v) for v in metrics.values()),
          "non-finite loss or metrics")
    check(launches == 4 * n_batches,
          f"nat_fwd launched {launches} times, want 4 x {n_batches} batches")

    # the deploy graph against the model's own eval forward (float32, TF32
    # off): reparam and the CUDA NAT kernel change only summation order
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        ref = model(x)
        out = deploy_forward(deploy, x, num_heads=HEADS, nat_backend="flat")
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    ok = out.shape == (2, 64, 64, 2) and bool(torch.isfinite(out).all()) and err <= 1e-4 * max(scale, 1.0)
    print(f"phase 4: deploy_forward(flat) vs LMNet eval forward, fp32 64^2 B=2: "
          f"max_abs_err={err:.3e} on logits of max {scale:.3e} (tol 1e-4 x max(scale, 1)) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "deploy forward disagrees with the eval forward")

    # 'flat' against 'plain' on one served batch, bf16 on both sides
    from lmnet_tpu_torch.data.augment import eval_pipeline

    images, masks = next(iter(make_loader(SyntheticDataset(BATCH, IMG, "val", seed=0), BATCH)))
    xb, _ = eval_pipeline(torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev), IMG)
    xb = xb.to(torch.bfloat16)
    with torch.inference_mode():
        lf = deploy_forward(deploy, xb, num_heads=HEADS, nat_backend="flat")
        lp = deploy_forward(deploy, xb, num_heads=HEADS, nat_backend="plain")
    torch.cuda.synchronize()
    scale = lp.abs().max().item()
    err = (lf - lp).abs().max().item()
    flips = (lf.argmax(-1) != lp.argmax(-1)).float().mean().item()
    ok = (lf.shape == (BATCH, IMG, IMG, 2) and bool(torch.isfinite(lf).all())
          and err <= 0.05 * max(scale, 1.0) and flips < 0.025)
    print(f"phase 4: deploy_forward bf16 {IMG}^2 B={BATCH} flat vs plain: max_abs_diff={err:.3e} "
          f"on logits of max {scale:.3e}, argmax flips={flips:.4%} "
          f"(tol 0.05 x max(scale, 1), flips < 2.5%) {'ok' if ok else 'FAIL'}")
    check(ok, "flat and plain NAT backends disagree on the served batch")
    return deploy, launches, xb


def phase_times(deploy, xb, card_line):
    from lmnet_tpu_torch.ops.nat import neighborhood_attention
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_plan
    from lmnet_tpu_torch.serve import deploy_forward

    dev = xb.device
    k_total = p_total = worst = 0.0
    work = Work()
    stages = []
    for i, (H, W, C) in enumerate(STAGES_256):
        q, k, v, rpb = nat_inputs(BATCH, H, W, C, torch.bfloat16, 100 + i, dev)
        work.add(*nat_fwd_work(q, C))
        q4, k4, v4 = (t.reshape(BATCH, H, W, C) for t in (q, k, v))
        fwd = lambda: nat_flat(q, k, v, rpb, HEADS, C, W)  # noqa: E731
        with torch.inference_mode():
            got = fwd()
            worst = max(worst, check_fwd("phase 5", got, q, k, v, rpb, BATCH, H, W, C))
            k_ms, g_ms = cuda_ms(fwd), graph_ms(fwd)
            p_ms = cuda_ms(lambda: neighborhood_attention(q4, k4, v4, rpb, 3))
        k_total += k_ms
        p_total += p_ms
        stages.append(stage_line("phase 5", "nat_fwd", BATCH, H, W, C,
                                 4 * q.numel() * q.element_size(), k_ms, g_ms,
                                 nat_plan(BATCH, H, W, HEADS, C // HEADS, q.dtype, "fwd"),
                                 card_line))
        print(f"phase 5:   plain nat stage H={H}: {p_ms:.4f} ms [{card_line}]")
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        f_ms = cuda_ms(lambda: deploy_forward(deploy, xb, num_heads=HEADS), iters=10)
        peak = torch.cuda.max_memory_allocated() / 2**30
        pl_ms = cuda_ms(lambda: deploy_forward(deploy, xb, num_heads=HEADS, nat_backend="plain"),
                        iters=10)
    print(f"phase 5: deploy_forward bf16 {IMG}^2 B={BATCH}: nat flat {f_ms:.3f} ms/batch = "
          f"{BATCH * 1000 / f_ms:.1f} img/s (peak {peak:.2f} GiB); nat plain {pl_ms:.3f} ms/batch = "
          f"{BATCH * 1000 / pl_ms:.1f} img/s [{card_line}]")
    print(f"phase 5: nat_fwd over the four stages: eager {k_total:.4f} ms, CUDA graph "
          f"{sum(st['graph_ms'] for st in stages):.4f} ms, bound {work.bound()[0]:.4f} ms "
          f"[{card_line}]")
    return k_total, p_total, worst, work, stages


def check_bwd(label, got, q, k, v, rpb, g, B, H, W, C, scale, drpb=None) -> float:
    """Hold the backward kernel's (dq, dk, dv, d_rpb) ``got`` against the
    plain backward on q, k, v, g upcast to float32; print one line; raise if
    they disagree. d_rpb is a sum over B*H*W pixels: a norm-relative bound,
    against ``drpb`` where given (the whole batch's, where q holds a few of
    its images)."""
    from lmnet_tpu_torch.ops.nat_flat import nat_flat_bwd_plain

    ref = nat_flat_bwd_plain(q.float(), k.float(), v.float(), rpb, g.float(),
                             HEADS, C, W, scale)
    errs, ok = [], True
    for a, b in zip(got[:3], ref[:3]):
        err = (a.float() - b).abs()
        big = b.abs().max()
        if q.dtype == torch.float32:
            bound = 1e-5 * (1 + big)
        else:  # one bf16 rounding of the stored gradient, with margin
            bound = 2**-8 * b.abs() + 1e-4 * (1 + big)
        ok = ok and bool((err <= bound).all()) and a.dtype == q.dtype
        errs.append(err.max().item())
    drpb = ref[3] if drpb is None else drpb
    rel = ((got[3] - drpb).norm() / drpb.norm()).item()
    ok = ok and rel <= 1e-4 and got[3].dtype == torch.float32
    tol = ("1e-5*(1+max|ref|)" if q.dtype == torch.float32
           else "2^-8*|ref| + 1e-4*(1+max|ref|)")
    print(f"{label}: nat_bwd vs plain B={B} H={H} W={W} C={C} hd={C // HEADS} "
          f"{str(q.dtype).split('.')[-1]}: max_abs_err dq={errs[0]:.3e} dk={errs[1]:.3e} "
          f"dv={errs[2]:.3e} (tol {tol}); d_rpb norm-rel err={rel:.3e} (tol 1e-4) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"nat_bwd disagrees with plain at {(B, H, W, C, q.dtype)}")
    return max(errs)


def phase_bwd_vs_plain(dev) -> float:
    from lmnet_tpu_torch.ops.nat_flat import nat_flat_bwd

    worst = 0.0
    for i, (B, H, W, C) in enumerate(CHECK_SHAPES):
        scale = float(C // HEADS) ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, rpb = nat_inputs(B, H, W, C, dtype, 200 + i, dev)
            g = torch.randn(B, H, W * C, generator=torch.Generator().manual_seed(300 + i))
            g = g.to(dev, dtype)
            got = nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, scale)
            worst = max(worst, check_bwd("phase 6", got, q, k, v, rpb, g, B, H, W, C, scale))
    for dtype in (torch.float32, torch.bfloat16):
        B, (H, W, C) = BATCH, STAGES_288[0]
        q, k, v, rpb = nat_inputs(B, H, W, C, dtype, 400, dev)
        g = torch.randn(B, H, W * C, generator=torch.Generator().manual_seed(401)).to(dev, dtype)
        a = nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, 0.5)
        b = nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, 0.5)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"phase 6: nat_bwd twice on the same inputs B={B} H={H} W={W} C={C} "
              f"{str(dtype).split('.')[-1]}: dq, dk, dv, d_rpb bitwise equal: {same}")
        check(same, "nat_bwd is not bitwise repeatable")
    return worst


def _train_model(dev, dtype=torch.bfloat16, nat_backend="flat", rc_train_backend="auto", seed=0):
    from lmnet_tpu_torch.models import LMNet

    model = LMNet(generator=torch.Generator().manual_seed(seed), dtype=dtype,
                  nat_backend=nat_backend, rc_remat=True, rc_train_backend=rc_train_backend)
    return model.to(dev)


def _batch(n, img, split, seed, dev):
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.data.augment import eval_pipeline

    images, masks = next(iter(make_loader(SyntheticDataset(n, img, split, seed=seed), n)))
    return eval_pipeline(torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev), img)


def phase_training(dev):
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd
    from lmnet_tpu_torch.train import create_train_state, evaluate, train_one_epoch, train_step

    n_images = 32
    steps = (n_images + BATCH - 1) // BATCH
    load = IMG * 9 // 8  # the 'train' split's load size
    state = create_train_state(_train_model(dev), (BATCH, load, load, 3), seed=0,
                               epochs=10, steps_per_epoch=steps)
    torch.cuda.synchronize()

    nat_flat.launches = nat_flat_bwd.launches = 0
    t0 = time.perf_counter()
    state, total, metrics = train_one_epoch(
        state, make_loader(SyntheticDataset(n_images, IMG, "train", seed=0), BATCH),
        img_size=IMG, augment_on_device=False,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = {"nat_fwd": nat_flat.launches, "nat_bwd": nat_flat_bwd.launches}
    print(f"phase 7: train_one_epoch {n_images} images ({load}^2, B={BATCH}, bf16, rc_remat) "
          f"{steps} steps: loss={total:.6f} metrics={json.dumps(metrics)} wall={wall:.3f}s "
          f"nat_fwd launches={train_launches['nat_fwd']} nat_bwd launches={train_launches['nat_bwd']}")
    check(np.isfinite(total) and all(np.isfinite(v) for v in metrics.values()),
          "non-finite training loss or metrics")
    check(train_launches == {"nat_fwd": 4 * steps, "nat_bwd": 4 * steps},
          f"NAT kernels launched {train_launches}, want 4 x {steps} steps each")

    nat_flat.launches = nat_flat_bwd.launches = 0
    val = make_loader(SyntheticDataset(n_images, IMG, "val", seed=1), BATCH)
    loss, vmetrics = evaluate(state, val, img_size=IMG)
    torch.cuda.synchronize()
    eval_launches = {"nat_fwd": nat_flat.launches, "nat_bwd": nat_flat_bwd.launches}
    print(f"phase 7: evaluate {n_images} images at {IMG}^2: ce_loss={loss:.6f} "
          f"metrics={json.dumps(vmetrics)} nat_fwd launches={eval_launches['nat_fwd']} "
          f"nat_bwd launches={eval_launches['nat_bwd']}")
    check(np.isfinite(loss) and all(np.isfinite(v) for v in vmetrics.values()),
          "non-finite eval loss or metrics")
    check(eval_launches == {"nat_fwd": 4 * steps, "nat_bwd": 0},
          f"evaluate launched {eval_launches}, want nat_fwd 4 x {steps} batches")

    # eight steps on one fixed batch lower the loss (tests/test_train.py in JAX)
    state = create_train_state(_train_model(dev, seed=1), (BATCH, IMG, IMG, 3), seed=1,
                               epochs=10, steps_per_epoch=4)
    x, y = _batch(BATCH, IMG, "val", 2, dev)
    cm = ConfusionAccumulator.init(2, dev)
    losses = []
    for _ in range(8):
        state, l, cm = train_step(state, x, y, cm)
        losses.append(l)
    losses = [float(v) for v in losses]
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    print(f"phase 7: 8 train steps on one batch ({IMG}^2, B={BATCH}, bf16): losses "
          f"{' '.join(f'{v:.5f}' for v in losses)} {'ok' if ok else 'FAIL'}")
    check(ok, "the loss did not fall over 8 steps on one batch")
    return {k: train_launches[k] + eval_launches[k] for k in train_launches}


def _gen_step(model, x, y, seed):
    """One train_step of ``model`` (dropout on, drawn from a generator
    seeded ``seed``): the loss, every gradient, and the generator's state
    after the step."""
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.train import create_train_state, train_step

    state = create_train_state(model, tuple(x.shape), seed=seed)
    state, loss, _ = train_step(state, x, y, ConfusionAccumulator.init(2, x.device))
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(loss), grads, state.generator.get_state()


def _one_step(model, x, y, seed):
    return _gen_step(model, x, y, seed)[:2]


def _same_start(dev, seed, *specs):
    """One model per (compute dtype, NAT backend[, ReparamConv train
    backend]), each with the first one's weights."""
    models = [_train_model(dev, *spec, seed=seed) for spec in specs]
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    return models


def phase_flat_vs_plain_step(dev):
    from lmnet_tpu_torch.models.blocks import NeighborhoodAttention2D

    # float32 at 64^2, B=2, TF32 off: the loss and every gradient. Both
    # models start from the same weights and draw the same dropout masks
    # (generators seeded alike); the backends differ in float32 summation
    # order only. Per tensor ||flat - plain|| <= 1e-3 ||plain|| + 1e-5 G,
    # G the largest gradient norm: the floor covers the gradients that are
    # zero in exact arithmetic (the bias of a conv feeding a train-mode BN),
    # float32 noise of ~1e-8 that differs between any two runs (plain
    # against plain differs there as much, and by 5e-7 over all gradients).
    x, y = _batch(2, 64, "val", 3, dev)
    flat, plain = _same_start(dev, 2, (torch.float32, "flat"), (torch.float32, "plain"))
    lf, gf = _one_step(flat, x, y, seed=5)
    lp, gp = _one_step(plain, x, y, seed=5)
    big = max(g.norm().item() for g in gp.values())
    worst = max((gf[k] - gp[k]).norm().item() / (1e-3 * gp[k].norm().item() + 1e-5 * big)
                for k in gp)
    total = (torch.cat([(gf[k] - gp[k]).flatten() for k in gp]).norm()
             / torch.cat([g.flatten() for g in gp.values()]).norm()).item()
    ok = abs(lf - lp) <= 1e-5 * abs(lp) and worst <= 1.0
    print(f"phase 8: train_step fp32 64^2 B=2 flat vs plain: loss {lf:.7f} vs {lp:.7f} "
          f"(tol rel 1e-5); {len(gp)} gradients: worst ||flat-plain|| / (1e-3 ||plain|| + "
          f"1e-5 max||g||) = {worst:.3e} (tol 1), all gradients ||flat-plain||/||plain|| = "
          f"{total:.3e} {'ok' if ok else 'FAIL'}")
    check(ok, "flat and plain NAT disagree on the fp32 train step")

    # bf16 at full width, 256^2, B=16: the loss and the gradients of every
    # NAT layer (qkv, proj, rpb), which the backward kernel produces. bf16
    # moves both backends off the exact step, so each is measured against a
    # float32 plain step from the same weights and dropout masks, and the
    # kernel's step may be off by at most twice as much as the plain one's,
    # plus 1e-4 of the loss or 1e-3 of the gradient's norm.
    x, y = _batch(BATCH, IMG, "val", 4, dev)
    flat, plain, ref = _same_start(dev, 3, (torch.bfloat16, "flat"), (torch.bfloat16, "plain"),
                                   (torch.float32, "plain"))
    nat = [f"{mn}.{pn}" for mn, m in flat.named_modules()
           if isinstance(m, NeighborhoodAttention2D) for pn, _ in m.named_parameters()]
    lf, gf = _one_step(flat, x, y, seed=6)
    lp, gp = _one_step(plain, x, y, seed=6)
    lr, gr = _one_step(ref, x, y, seed=6)
    ok = np.isfinite(lf) and abs(lf - lr) <= 2 * abs(lp - lr) + 1e-4 * abs(lr)
    print(f"phase 8: train_step bf16 {IMG}^2 B={BATCH} flat vs plain: loss {lf:.6f} vs "
          f"{lp:.6f}, fp32 {lr:.6f} (tol |flat-fp32| <= 2 |plain-fp32| + 1e-4 |fp32|) "
          f"{'ok' if ok else 'FAIL'}")
    ratios = {}
    for n in nat:
        ef, ep = (gf[n] - gr[n]).norm().item(), (gp[n] - gr[n]).norm().item()
        ratios[n] = ef / (2 * ep + 1e-3 * gr[n].norm().item())
        fp = ((gf[n] - gp[n]).norm() / gp[n].norm()).item()
        print(f"phase 8:   {n}: ||flat-fp32|| {ef:.3e} ||plain-fp32|| {ep:.3e} "
              f"||fp32|| {gr[n].norm().item():.3e} ||flat-plain||/||plain|| {fp:.3e}")
    worst = max(ratios.values())
    ok = ok and bool(np.isfinite(worst)) and worst <= 1.0
    print(f"phase 8: train_step bf16 {IMG}^2 B={BATCH}: {len(nat)} NAT-layer gradients, worst "
          f"||flat-fp32|| / (2 ||plain-fp32|| + 1e-3 ||fp32||) = {worst:.3e} (tol 1), at "
          f"{max(ratios, key=ratios.get)} {'ok' if ok else 'FAIL'}")
    check(ok, "flat and plain NAT disagree on the bf16 train step")


def _time_steps(state, x, y, n):
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.train import train_step

    cm = ConfusionAccumulator.init(2, x.device)

    def step():
        nonlocal state, cm
        state, _, cm = train_step(state, x, y, cm)

    return cuda_ms(step, iters=n, warmup=3)


def _profile_steps(state, x, y, steps):
    """``steps`` train steps under torch.profiler; returns (state, the device
    kernel events, device busy ms, wall ms, the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.train import train_step

    cm = ConfusionAccumulator.init(2, x.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _, cm = train_step(state, x, y, cm)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1000
    return state, kernels, busy_ms, wall_ms, prof


def rc_step_ms(kernels, steps) -> dict:
    """Device ms a step of the 'fused' ReparamConv kernels among profiled
    ``kernels``: B6 (rc_stats), B5 (dw_gelu), and the reductions of their
    tiles' partials (reduce_partials*, which on a training step only these
    two launch), and their sum."""
    out = {"B6": 0.0, "B5": 0.0, "reductions": 0.0}
    for e in kernels:
        key = ("B6" if "rc_stats" in e.name else "B5" if "dw_gelu" in e.name
               else "reductions" if "reduce_partials" in e.name else None)
        if key:
            out[key] += e.time_range.elapsed_us() / 1000 / steps
    out["sum"] = out["B6"] + out["B5"] + out["reductions"]
    return out


def phase_train_times(dev, card_line):
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd, nat_flat_bwd_plain, nat_plan
    from lmnet_tpu_torch.train import create_train_state, train_step

    k_total = p_total = worst = 0.0
    work = Work()
    stages = []
    for i, (H, W, C) in enumerate(STAGES_256):
        q, k, v, rpb = nat_inputs(BATCH, H, W, C, torch.bfloat16, 500 + i, dev)
        # q, k, v, g in, dq, dk, dv out; per element the 9 logits, 9 dP, and
        # 9 each of dq, dk and dv multiply-adds, per (pixel, head) ~50 more
        work.add(7 * q.numel() * q.element_size(), 90 * q.numel() + 50 * (q.numel() // C) * HEADS)
        g = torch.randn(BATCH, H, W * C, generator=torch.Generator().manual_seed(600 + i))
        g = g.to(dev, torch.bfloat16)
        scale = float(C // HEADS) ** -0.5
        got = nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, scale)
        worst = max(worst, check_bwd("phase 9", got, q, k, v, rpb, g, BATCH, H, W, C, scale))
        bwd = lambda: nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, scale)  # noqa: E731
        k_ms, g_ms = cuda_ms(bwd), graph_ms(bwd)
        p_ms = cuda_ms(lambda: nat_flat_bwd_plain(q, k, v, rpb, g, HEADS, C, W, scale))
        k_total += k_ms
        p_total += p_ms
        # q, k, v, g in + dq, dk, dv out
        stages.append(stage_line("phase 9", "nat_bwd", BATCH, H, W, C,
                                 7 * q.numel() * q.element_size(), k_ms, g_ms,
                                 nat_plan(BATCH, H, W, HEADS, C // HEADS, q.dtype, "bwd"),
                                 card_line))
        print(f"phase 9:   plain nat backward stage H={H}: {p_ms:.4f} ms [{card_line}]")
    print(f"phase 9: nat_bwd over the four stages: eager {k_total:.4f} ms, CUDA graph "
          f"{sum(st['graph_ms'] for st in stages):.4f} ms, bound {work.bound()[0]:.4f} ms "
          f"[{card_line}]")

    x, y = _batch(BATCH, IMG, "val", 7, dev)
    states = {nb: create_train_state(_train_model(dev, nat_backend=nb, seed=4),
                                     (BATCH, IMG, IMG, 3), seed=0)
              for nb in ("flat", "plain")}
    n = 10
    for nb in ("plain", "flat"):
        nat_flat.launches = nat_flat_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        ms = _time_steps(states[nb], x, y, n)
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_step = (nat_flat.launches / (n + 3), nat_flat_bwd.launches / (n + 3))
        print(f"phase 9: train_step bf16 {IMG}^2 B={BATCH} rc_remat nat {nb}: {ms:.3f} ms/step = "
              f"{BATCH * 1000 / ms:.1f} img/s, peak {peak:.2f} GiB, NAT launches per step "
              f"fwd {per_step[0]:g} bwd {per_step[1]:g} [{card_line}]")

    steps = 3
    state, kernels, busy_ms, wall_ms, prof = _profile_steps(states["flat"], x, y, steps)
    nat_ms = sum(e.time_range.elapsed_us() for e in kernels if "nat_" in e.name) / 1000
    print(f"phase 9: profiled {steps} flat train steps: {len(kernels) / steps:.0f} device "
          f"kernels per step, device busy {busy_ms / steps:.3f} ms per step of "
          f"{wall_ms / steps:.3f} ms profiled wall (idle share {1 - busy_ms / wall_ms:.3f} "
          f"under the profiler), NAT kernels {nat_ms / steps:.3f} ms per step [{card_line}]")
    ops = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    for e in ops[:12]:
        print(f"phase 9:   device time by op: {e.self_device_time_total / 1000 / steps:8.3f} ms "
              f"per step, {e.count / steps:5.0f} calls per step  {e.key[:70]}")
    # the per-step path makes no host sync: one more step with CUDA's sync
    # debug mode on records a warning for every synchronising call
    cm = ConfusionAccumulator.init(2, dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _, cm = train_step(state, x, y, cm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
    print(f"phase 9: one train_step under torch.cuda.set_sync_debug_mode('warn'): "
          f"{len(syncs)} host syncs {'ok' if not syncs else syncs[:3]}")
    check(not syncs, "train_step synchronises the host with the device")
    return k_total, p_total, worst, work, stages


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


def check_dw(label, e, k, b, t, sums, C, top=0, rows=None) -> float:
    """Hold B5's (t, sums) against the plain version on e upcast to float32
    (at the row window ``top``, ``rows`` of a slab e):
    t f32 within 1e-5 (1 + |ref|), bf16 within one rounding of the stored
    value (2^-8 |ref| + 1e-5); each channel sum (both from the float32 t)
    within 1e-5 of the sum of |t| + 1e-6. Print one line; raise on a
    mismatch. Returns the max abs error of t."""
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat_plain

    B, _, WC = e.shape
    ref, ref_sums = dw_gelu_flat_plain(e.float(), k, b, C, top, rows)
    H = ref.shape[1]
    err = (t.float() - ref).abs()
    bound = 1e-5 * (1 + ref.abs()) if e.dtype == torch.float32 else 2**-8 * ref.abs() + 1e-5
    serr = (sums - ref_sums).abs()
    sbound = 1e-5 * ref.abs().reshape(B, -1, C).sum(1) + 1e-6
    ok = bool((err <= bound).all()) and bool((serr <= sbound).all()) and t.dtype == e.dtype
    print(f"{label}: rc_dw_gelu vs plain B={B} H={H} W={WC // C} C={C} {_dt(e.dtype)}: "
          f"max_abs_err t={err.max().item():.3e} sums={serr.max().item():.3e} "
          f"(tol t {'1e-5*(1+|ref|)' if e.dtype == torch.float32 else '2^-8*|ref| + 1e-5'}, "
          f"sums 1e-5*sum|t| + 1e-6) {'ok' if ok else 'FAIL'}")
    check(ok, f"rc_dw_gelu disagrees with plain at {(B, H, WC // C, C, e.dtype)}")
    return err.max().item()


def check_stats(label, e, ks, got, C, top=0, rows=None) -> float:
    """Hold B6's (4, 2, C) statistics against the plain version on e upcast
    to float32 (at the row window ``top``, ``rows`` of a slab e): each
    within 1e-5 of the matching sum of |y| (or of y^2) + 1e-6. Print one
    line; raise on a mismatch. Returns the max abs error."""
    from lmnet_tpu_torch.ops import rc_train

    B, _, WC = e.shape
    ys = rc_train._branch_outputs(e.float(), [k.float() for k in ks], C, torch.float32, top,
                                  rows)
    H = ys[0].shape[2]
    ref = torch.stack([torch.stack([y.sum(dim=(0, 2, 3)), y.square().sum(dim=(0, 2, 3))])
                       for y in ys])
    scale = torch.stack([torch.stack([y.abs().sum(dim=(0, 2, 3)), y.square().sum(dim=(0, 2, 3))])
                         for y in ys])
    del ys
    err = (got - ref).abs()
    rel = (err / scale.clamp_min(1e-30)).max().item()
    ok = bool((err <= 1e-5 * scale + 1e-6).all()) and got.shape == (4, 2, C)
    print(f"{label}: rc_stats vs plain B={B} H={H} W={WC // C} C={C} {_dt(e.dtype)}: "
          f"max_abs_err={err.max().item():.3e}, max err / sum|y| (or sum y^2) = {rel:.3e} "
          f"(tol 1e-5 + 1e-6 abs) {'ok' if ok else 'FAIL'}")
    check(ok, f"rc_stats disagrees with plain at {(B, H, WC // C, C, e.dtype)}")
    return err.max().item()


def check_rc(label, x, w, got, top=0, rows=None) -> float:
    """Hold B4's output against the plain block. float32: within 1e-4 (1 +
    max|ref|) of the float32 plain version (sums of up to 192 + 96 products
    and the SE scale in another order). bf16 (tensor-core products), two
    ways on the same bf16 x: within 2^-7 max|ref| of the plain version that
    rounds at the kernel's points (We, Wp, Wsc and t*s to bf16; one
    rounding of the stored y, float32 sums in another order), and within 2x
    that version's distance from the float32 plain version, + 2^-8
    max|ref|, of the float32 plain version. Print one line with the
    distances; raise on a mismatch. Returns the max abs error against the
    plain version of the kernel's own numerics. At a row window (``top``,
    ``rows`` of a slab x) the block's SE is the slab's rows' own mean."""
    from lmnet_tpu_torch.ops.rc_kernel import fused_reparam_conv_plain

    ref = fused_reparam_conv_plain(x.float(), w, top, rows)
    m = ref.abs().max().item()
    B, _, W, Cin = x.shape
    H = ref.shape[1]
    shape = (f"B={B} H={H} W={W} Cin={Cin} E={w['we'].shape[0]} Cout={w['wp'].shape[0]} "
             f"{_dt(x.dtype)}")
    if x.dtype == torch.float32:
        err = (got - ref).abs().max().item()
        ok = err <= 1e-4 * (1 + m)
        msg = f"max_abs_err={err:.3e} on outputs of max {m:.3e} (tol 1e-4*(1+max|ref|))"
    else:
        rounded = fused_reparam_conv_plain(x, w, top, rows).float()
        err = (got.float() - rounded).abs().max().item()
        d_f32 = (got.float() - ref).abs().max().item()
        dist = (rounded - ref).abs().max().item()
        ok = err <= 2**-7 * m and d_f32 <= 2 * dist + 2**-8 * m
        msg = (f"vs bf16-rounding plain {err:.3e} (tol 2^-7*max|ref| = {2**-7 * m:.3e}), "
               f"vs float32 plain {d_f32:.3e} (tol 2 x {dist:.3e} + 2^-8*max|ref| = "
               f"{2 * dist + 2**-8 * m:.3e}), outputs of max {m:.3e}")
    ok = ok and got.shape == ref.shape and got.dtype == x.dtype
    print(f"{label}: rc_fused vs plain {shape}: {msg} {'ok' if ok else 'FAIL'}")
    check(ok, f"rc_fused disagrees with plain at {(B, H, W, Cin, x.dtype)}")
    return err


def check_b8(label, emb, fw, heads, C, W, got) -> float:
    """Hold B8's output against its plain versions on the same emb.
    float32: within 1e-4 (1 + max|ref|) of the float32 plain version (sums
    of up to 2C products and two LayerNorms in another order). bf16
    (products on the tensor cores), two ways: within 2^-7 max|ref| of the
    plain version that rounds at the kernel's points (the weights and the
    four A operands to bf16; one rounding of the stored value, float32 sums
    in another order), and within 2x that version's distance from the
    float32 plain version, + 2^-8 max|ref|, of the float32 plain version.
    Print one line with the distances; raise on a mismatch. Returns the max
    abs error against the plain version of the kernel's own numerics."""
    from lmnet_tpu_torch.ops.natt_flat import natt_flat_interior_plain

    B, H, WC = emb.shape
    ref = natt_flat_interior_plain(emb.float(), fw, heads, C, W)
    m = ref.abs().max().item()
    if emb.dtype == torch.float32:
        err = (got - ref).abs().max().item()
        ok = err <= 1e-4 * (1 + m)
        msg = f"max_abs_err={err:.3e} on outputs of max {m:.3e} (tol 1e-4 (1 + max|ref|))"
    else:
        rounded = natt_flat_interior_plain(emb, fw, heads, C, W).float()
        err = (got.float() - rounded).abs().max().item()
        d_f32 = (got.float() - ref).abs().max().item()
        dist = (rounded - ref).abs().max().item()
        ok = err <= 2**-7 * m and d_f32 <= 2 * dist + 2**-8 * m
        msg = (f"vs bf16-rounding plain {err:.3e} (tol 2^-7*max|ref| = {2**-7 * m:.3e}), "
               f"vs float32 plain {d_f32:.3e} (tol 2 x {dist:.3e} + 2^-8*max|ref| = "
               f"{2 * dist + 2**-8 * m:.3e}), outputs of max {m:.3e}")
    ok = ok and got.shape == emb.shape and got.dtype == emb.dtype
    print(f"{label}: natt_flat vs plain B={B} H={H} W={W} C={C} heads={heads} "
          f"{_dt(emb.dtype)}: {msg} {'ok' if ok else 'FAIL'}")
    check(ok, f"natt_flat disagrees with plain at {(B, H, W, C, heads, emb.dtype)}")
    return err


def rc_weights(seed, Cin, E, Cout, dev):
    """Random ``fold_rc_weights``-shaped float32 weights, fan-in scaled."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    from lmnet_tpu_torch.ops.rc_kernel import pack_rc_weights

    w = dict(we=n(E, Cin, s=Cin**-0.5), be=n(E, s=0.1), kdw=n(25, E, s=0.2), bdw=n(E, s=0.1),
             fc1_w=n(E // 4, E, s=E**-0.5), fc1_b=n(E // 4, s=0.1),
             fc2_w=n(E, E // 4, s=(E // 4) ** -0.5), fc2_b=n(E, s=0.1),
             wp=n(Cout, E, s=E**-0.5), bp=n(Cout, s=0.1), wsc=n(Cout, Cin, s=Cin**-0.5),
             bsc=n(Cout, s=0.1))
    w["packed"] = pack_rc_weights(w)
    return w


def branch_inputs(B, H, W, C, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    e = torch.randn(B, H, W * C, generator=g).to(dev, dtype)
    ks = [(torch.randn(C, 1, kh, kw, generator=g) * 0.3).to(dev)
          for kh, kw in ((5, 5), (3, 3), (3, 1), (1, 3))]
    return e, ks


def stats_stock(e, ks, C):
    """The stock bf16 composition that 'xla' training runs for B6's
    statistics (models/blocks.py: ConvBN's conv, then BatchNorm's float32
    mean and mean square): the four branch convs of e (B, H, W*C) in e's
    dtype and, per branch, the float32 mean and mean of squares, (4, 2, C).
    B6's yardstick: four convs and eight reductions, no single library call."""
    from lmnet_tpu_torch.models.blocks import conv_nhwc

    B, H, WC = e.shape
    e4 = e.reshape(B, H, WC // C, C)
    out = []
    for k in ks:
        y = conv_nhwc(e4, k, None, 1, C).float()
        out.append(torch.stack([y.mean(dim=(0, 1, 2)), y.square().mean(dim=(0, 1, 2))]))
    return torch.stack(out)


# (H, E, blocks) of the ReparamConv blocks of a 256^2 training forward: the
# inputs B6 takes there (B = BATCH)
B6_BLOCKS = [(256, 24, 4), (128, 48, 4), (64, 96, 4), (32, 192, 4)]


def natt_state(seed, C, heads, dev, name="natt"):
    """A random NATT block ``name`` as raw state-dict entries (the keys
    ``fold_natt_weights`` and ``serve.engine.natt_interior`` read), float32,
    fan-in scaled, LayerNorm affines near (1, 0)."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, s=1.0, base=0.0):
        return (base + torch.randn(*shape, generator=g) * s).to(dev)

    w = {"norm1.weight": n(C, s=0.1, base=1.0), "norm1.bias": n(C, s=0.1),
         "att1.qkv.weight": n(3 * C, C, s=C**-0.5), "att1.qkv.bias": n(3 * C, s=0.1),
         "att1.rpb": n(heads, 5, 5, s=0.3),
         "att1.proj.weight": n(C, C, s=C**-0.5), "att1.proj.bias": n(C, s=0.1),
         "norm2.weight": n(C, s=0.1, base=1.0), "norm2.bias": n(C, s=0.1),
         "mlp.fc1.weight": n(2 * C, C, s=C**-0.5), "mlp.fc1.bias": n(2 * C, s=0.1),
         "mlp.fc2.weight": n(C, 2 * C, s=(2 * C) ** -0.5), "mlp.fc2.bias": n(C, s=0.1)}
    return {f"{name}.{k}": v for k, v in w.items()}


def phase_rc_kernels(dev) -> dict:
    """Phase 10; returns the worst error of each kernel."""
    from lmnet_tpu_torch.ops import rc_kernel
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat
    from lmnet_tpu_torch.ops.rc_kernel import fused_reparam_conv
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {k: 0.0 for k in RC_KERNELS}
    for i, (B, H, W, C) in enumerate(DW_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            e, ks = branch_inputs(B, H, W, C, dtype, 700 + i, dev)
            k = (ks[0] * 0.7).contiguous()
            b = torch.randn(C, generator=torch.Generator().manual_seed(i)).to(dev) * 0.1
            t, sums = dw_gelu_flat(e, k, b, C)
            worst["rc_dw_gelu"] = max(worst["rc_dw_gelu"], check_dw("phase 10", e, k, b, t, sums, C))
            stats = rc_branch_stats(e, *ks, C)
            worst["rc_stats"] = max(worst["rc_stats"], check_stats("phase 10", e, ks, stats, C))
            check(torch.equal(stats, rc_branch_stats(e, *ks, C)),
                  f"rc_stats is not bitwise repeatable at {(B, H, W, C, dtype)}")
            if B == BATCH and H == STAGES_288[0][0]:
                same = torch.equal(sums, dw_gelu_flat(e, k, b, C)[1])
                print(f"phase 10: rc_dw_gelu sums twice on the same inputs B={B} H={H} W={W} "
                      f"C={C} {_dt(dtype)}: bitwise equal: {same}; rc_stats bitwise equal over "
                      f"two calls at every shape above")
                check(same, "rc_dw_gelu is not bitwise repeatable")
            del e, ks, t
    for i, (B, H, W, Cin, E, Cout) in enumerate(RC_SHAPES):
        w = rc_weights(800 + i, Cin, E, Cout, dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(B, H, W, Cin, generator=torch.Generator().manual_seed(i)).to(dev, dtype)
            got = fused_reparam_conv(x, w)
            worst["rc_fused"] = max(worst["rc_fused"], check_rc("phase 10", x, w, got))
            if i == 1:  # phase 1's channel sums, twice on the same inputs
                same = torch.equal(rc_kernel.rc_phase1(x, w), rc_kernel.rc_phase1(x, w))
                print(f"phase 10: rc_fused phase-1 sums twice on the same inputs B={B} H={H} "
                      f"W={W} Cin={Cin} E={E} {_dt(dtype)}: bitwise equal: {same}")
                check(same, "rc_fused's phase-1 sums are not bitwise repeatable")
    return worst


def _capture(module, name, calls):
    """Patch ``module.name`` with a recorder of its arguments that calls the
    original; returns the original."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    setattr(module, name, spy)
    return real


def phase_rc_serving(model, dev, card_line):
    """Phase 11; returns (serving launches of B5 and B4, B5 and B4 worst
    errors and summed kernel and plain ms at the timed inputs)."""
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.data.augment import eval_pipeline
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.ops.nat_flat import nat_flat
    from lmnet_tpu_torch.ops.rc_flat import (
        dw_gelu_flat,
        dw_gelu_flat_plain,
        fold_rc_flat_weights,
    )
    from lmnet_tpu_torch.ops.rc_kernel import (
        fold_rc_weights,
        fused_reparam_conv,
        fused_reparam_conv_plain,
    )
    from lmnet_tpu_torch.serve import deploy_forward, engine, serving_evaluate

    n_images = 32
    n_batches = (n_images + BATCH - 1) // BATCH
    state = model.state_dict()
    deploy = structural_reparam(state)
    launches = {}
    for rc in ("flat", "pallas", "auto"):
        torch.cuda.synchronize()
        nat_flat.launches = dw_gelu_flat.launches = fused_reparam_conv.launches = 0
        t0 = time.perf_counter()
        loss, metrics = serving_evaluate(
            state, make_loader(SyntheticDataset(n_images, IMG, "val", seed=0), BATCH),
            num_classes=2, img_size=IMG, num_heads=HEADS, rc_backend=rc,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[rc] = {"rc_dw_gelu": dw_gelu_flat.launches,
                        "rc_fused": fused_reparam_conv.launches, "nat_fwd": nat_flat.launches}
        print(f"phase 11: serving_evaluate rc_backend={rc} {n_images} images at {IMG}^2 B={BATCH} "
              f"bf16: loss={loss:.6f} metrics={json.dumps(metrics)} wall={wall:.3f}s launches "
              f"{json.dumps(launches[rc])}")
        check(np.isfinite(loss) and all(np.isfinite(v) for v in metrics.values()),
              f"non-finite loss or metrics with rc_backend={rc}")
    check(launches["flat"] == {"rc_dw_gelu": 16 * n_batches, "rc_fused": 0,
                               "nat_fwd": 4 * n_batches},
          f"rc_backend='flat' launched {launches['flat']}, want rc_dw_gelu 16 x {n_batches}")
    check(launches["pallas"] == {"rc_dw_gelu": 0, "rc_fused": 16 * n_batches,
                                 "nat_fwd": 4 * n_batches},
          f"rc_backend='pallas' launched {launches['pallas']}, want rc_fused 16 x {n_batches}")
    (choice, table), = (v for k, v in engine.AUTOTUNE_CACHE.items() if k[0][1] == IMG)
    print(f"phase 11: rc_backend='auto' picked (rc, nat) = {choice} from "
          + ", ".join(f"{k}: {v * 1000:.3f} ms" for k, v in table.items())
          + f" (CUDA events, warm-up + 8 calls each) [{card_line}]")
    # the sweep runs 'flat' 9 times (warm-up + 8), then the chosen pair serves
    want_b5 = 16 * (9 + (n_batches if choice[0] == "flat" else 0))
    check(launches["auto"]["rc_dw_gelu"] == want_b5,
          f"rc_backend='auto' launched rc_dw_gelu {launches['auto']['rc_dw_gelu']}, want {want_b5}")

    images, masks = next(iter(make_loader(SyntheticDataset(BATCH, IMG, "val", seed=0), BATCH)))
    xb, _ = eval_pipeline(torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev), IMG)
    xb = xb.to(torch.bfloat16)
    with torch.inference_mode():
        ref = deploy_forward(deploy, xb, num_heads=HEADS, rc_backend="xla")
        for rc in ("flat", "pallas"):
            out = deploy_forward(deploy, xb, num_heads=HEADS, rc_backend=rc)
            scale = ref.abs().max().item()
            err = (out - ref).abs().max().item()
            flips = (out.argmax(-1) != ref.argmax(-1)).float().mean().item()
            ok = (out.shape == ref.shape and bool(torch.isfinite(out).all())
                  and err <= 0.05 * max(scale, 1.0) and flips < 0.025)
            print(f"phase 11: deploy_forward bf16 {IMG}^2 B={BATCH} rc {rc} vs xla: "
                  f"max_abs_diff={err:.3e} on logits of max {scale:.3e}, argmax flips={flips:.4%} "
                  f"(tol 0.05 x max(scale, 1), flips < 2.5%) {'ok' if ok else 'FAIL'}")
            check(ok, f"rc_backend={rc} disagrees with xla on the served batch")
        times = {"xla": [], "flat": [], "pallas": []}
        for rc in ("xla", "flat", "pallas", "pallas", "flat", "xla"):
            times[rc].append(cuda_ms(lambda: deploy_forward(deploy, xb, num_heads=HEADS,
                                                            rc_backend=rc), iters=10))
    print("phase 11: deploy_forward bf16 256^2 B=16 by rc_backend, turns xla, flat, pallas, "
          "pallas, flat, xla: " + "; ".join(
              f"{rc} {' / '.join(f'{t:.3f}' for t in ts)} ms = "
              f"{BATCH * 1000 / float(np.mean(ts)):.1f} img/s" for rc, ts in times.items())
          + f" [{card_line}]")

    # B4 and B5 against their plain versions at the inputs of the 16 blocks,
    # timed beside the plain versions and the stock bf16 compositions that
    # serve by default ('xla': engine._rc for B4; conv2d(groups=E) + tanh
    # GELU + the channel sum for B5), in total and per block shape
    calls = []
    real = _capture(engine, "_rc", calls)
    try:
        with torch.inference_mode():
            deploy_forward(deploy, xb, num_heads=HEADS, rc_backend="xla")
    finally:
        engine._rc = real
    check(len(calls) == 16, f"captured {len(calls)} ReparamConv inputs, want 16")
    from lmnet_tpu_torch.models.blocks import conv_nhwc

    def dw_xla(e4, fw):
        t = torch.nn.functional.gelu(conv_nhwc(e4, fw["kd"], fw["bdw"], groups=e4.shape[-1]),
                                     approximate="tanh")
        return t, t.sum(dim=(1, 2))

    # err, ms, plain ms, xla ms
    res = {"rc_dw_gelu": [0.0, 0.0, 0.0, 0.0], "rc_fused": [0.0, 0.0, 0.0, 0.0]}
    work = {"rc_dw_gelu": Work(), "rc_fused": Work()}
    by_shape = {}
    with torch.inference_mode():
        for sd, name, h, _ in calls:
            w = fold_rc_weights(sd, name)
            B, H, W, Cin = h.shape
            E, Cout = w["we"].shape[0], w["wp"].shape[0]
            # x in, y out, the weights once (bf16 matrices, float32 vectors);
            # per pixel the expand, pointwise and shortcut multiply-adds on
            # the tensor cores, the depthwise multiply-adds and ~20
            # activation operations per channel of e in float32
            work["rc_fused"].add(B * H * W * (Cin + Cout) * h.element_size()
                                 + 2 * (E * Cin + E * Cout + Cin * Cout) + 4 * (27 * E + 2 * Cout),
                                 B * H * W * (2 * 25 * E + 20 * E),
                                 B * H * W * 2 * (Cin * E + E * Cout + Cin * Cout))
            # e in, t out, per element 25 multiply-adds and ~20 for bias and GELU
            work["rc_dw_gelu"].add(2 * B * H * W * E * h.element_size(), 70 * B * H * W * E)
            got = fused_reparam_conv(h, w)
            res["rc_fused"][0] = max(res["rc_fused"][0], check_rc("phase 11", h, w, got))
            t4 = {"rc_fused": cuda_ms(lambda: fused_reparam_conv(h, w)),
                  "rc_fused plain": cuda_ms(lambda: fused_reparam_conv_plain(h, w)),
                  "rc_fused xla": cuda_ms(lambda: real(sd, name, h, "xla"))}
            fw = fold_rc_flat_weights(sd, name)
            e = torch.nn.functional.hardswish(torch.nn.functional.linear(
                h, fw["we"].to(h.dtype), fw["be"].to(h.dtype))).reshape(B, H, W * E)
            t, sums = dw_gelu_flat(e, fw["kd"], fw["bdw"], E)
            res["rc_dw_gelu"][0] = max(res["rc_dw_gelu"][0],
                                       check_dw("phase 11", e, fw["kd"], fw["bdw"], t, sums, E))
            e4 = e.reshape(B, H, W, E)
            t5 = {"rc_dw_gelu": cuda_ms(lambda: dw_gelu_flat(e, fw["kd"], fw["bdw"], E)),
                  "rc_dw_gelu plain": cuda_ms(lambda: dw_gelu_flat_plain(e, fw["kd"], fw["bdw"],
                                                                         E)),
                  "rc_dw_gelu xla": cuda_ms(lambda: dw_xla(e4, fw))}
            for k, t_ in {**t4, **t5}.items():
                kernel, _, kind = k.partition(" ")
                res[kernel][{"": 1, "plain": 2, "xla": 3}[kind]] += t_
            row = by_shape.setdefault((H, Cin, E, Cout), {"blocks": 0, **{k: 0.0 for k in t4},
                                                          **{k: 0.0 for k in t5}})
            row["blocks"] += 1
            for k, t_ in {**t4, **t5}.items():
                row[k] += t_
    for (H, Cin, E, Cout), row in by_shape.items():
        print(f"phase 11: block shape {H}^2 Cin={Cin} E={E} Cout={Cout} B={BATCH} bf16, "
              f"{row['blocks']} blocks: rc_fused {row['rc_fused']:.4f} ms (plain "
              f"{row['rc_fused plain']:.4f}, xla {row['rc_fused xla']:.4f}); rc_dw_gelu "
              f"{row['rc_dw_gelu']:.4f} ms (plain {row['rc_dw_gelu plain']:.4f}, xla "
              f"{row['rc_dw_gelu xla']:.4f}) [{card_line}]")
    for k, (_, ms, pms, xms) in res.items():
        print(f"phase 11: {k} over the 16 ReparamConv blocks of a served batch (256^2, B=16, "
              f"bf16): kernel {ms:.4f} ms, plain {pms:.4f} ms, stock bf16 composition (xla) "
              f"{xms:.4f} ms (bound {work[k].bound()[0]:.4f} ms, {work[k].bound()[1]}; "
              f"terms {json.dumps({t: round(v, 4) for t, v in work[k].terms().items()})}) "
              f"[{card_line}]")
    serve_launches = {"rc_dw_gelu": launches["flat"]["rc_dw_gelu"],
                      "rc_fused": launches["pallas"]["rc_fused"]}
    return serve_launches, res, work


def phase_rc_training(dev, card_line):
    """Phase 12; returns (training launches of B5 and B6, B6's worst error
    and summed kernel, plain and stock-composition ms at the timed inputs,
    its work, and its times by block shape)."""
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.models import blocks
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats
    from lmnet_tpu_torch.train import create_train_state, evaluate, train_one_epoch

    n_images = 32
    steps = (n_images + BATCH - 1) // BATCH
    load = IMG * 9 // 8
    state = create_train_state(_train_model(dev, rc_train_backend="fused"),
                               (BATCH, load, load, 3), seed=0, epochs=10, steps_per_epoch=steps)
    torch.cuda.synchronize()
    dw_gelu_flat.launches = rc_branch_stats.launches = 0
    t0 = time.perf_counter()
    state, total, metrics = train_one_epoch(
        state, make_loader(SyntheticDataset(n_images, IMG, "train", seed=0), BATCH),
        img_size=IMG, augment_on_device=False,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = {"rc_dw_gelu": dw_gelu_flat.launches, "rc_stats": rc_branch_stats.launches}
    print(f"phase 12: train_one_epoch rc_train_backend=fused {n_images} images ({load}^2, "
          f"B={BATCH}, bf16, rc_remat) {steps} steps: loss={total:.6f} "
          f"metrics={json.dumps(metrics)} wall={wall:.3f}s launches {json.dumps(train_launches)}")
    check(np.isfinite(total) and all(np.isfinite(v) for v in metrics.values()),
          "non-finite fused training loss or metrics")
    # 16 blocks, each run forward and again in the checkpoint's recompute
    want = {"rc_dw_gelu": 2 * 16 * steps, "rc_stats": 2 * 16 * steps}
    check(train_launches == want, f"fused training launched {train_launches}, want {want}")
    dw_gelu_flat.launches = rc_branch_stats.launches = 0
    loss, vmetrics = evaluate(state, make_loader(SyntheticDataset(n_images, IMG, "val", seed=1),
                                                 BATCH), img_size=IMG)
    torch.cuda.synchronize()
    eval_launches = {"rc_dw_gelu": dw_gelu_flat.launches, "rc_stats": rc_branch_stats.launches}
    print(f"phase 12: evaluate {n_images} images at {IMG}^2: ce_loss={loss:.6f} "
          f"metrics={json.dumps(vmetrics)} launches {json.dumps(eval_launches)}")
    check(np.isfinite(loss) and eval_launches == {"rc_dw_gelu": 0, "rc_stats": 0},
          f"evaluate gave {loss} and launched {eval_launches}, want no ReparamConv kernel")
    del state

    # float32 at 64^2, B=2, TF32 off: the loss, every gradient and every
    # running statistic. 'fused' folds the batch statistics into one conv
    # and 'xla' sums four; in float32 they differ in rounding only. Bounds
    # as phase 8: loss rel 1e-5, each gradient ||fused - xla|| <= 1e-3
    # ||xla|| + 1e-5 G; each running statistic 1e-4 |xla| + 1e-5 max|xla|.
    x, y = _batch(2, 64, "val", 3, dev)
    fused, xla = _same_start(dev, 2, (torch.float32, "flat", "fused"),
                             (torch.float32, "flat", "xla"))
    lf, gf = _one_step(fused, x, y, seed=5)
    lx, gx = _one_step(xla, x, y, seed=5)
    big = max(g.norm().item() for g in gx.values())
    worst = max((gf[k] - gx[k]).norm().item() / (1e-3 * gx[k].norm().item() + 1e-5 * big)
                for k in gx)
    sf, sx = fused.state_dict(), xla.state_dict()
    stat_keys = [k for k in sx if "running" in k]
    stat_worst = max(((sf[k] - sx[k]).abs() / (1e-4 * sx[k].abs() + 1e-5 * sx[k].abs().max()))
                     .max().item() for k in stat_keys)
    ok = abs(lf - lx) <= 1e-5 * abs(lx) and worst <= 1.0 and stat_worst <= 1.0
    print(f"phase 12: train_step fp32 64^2 B=2 rc fused vs xla: loss {lf:.7f} vs {lx:.7f} "
          f"(tol rel 1e-5); {len(gx)} gradients: worst ||fused-xla|| / (1e-3 ||xla|| + 1e-5 "
          f"max||g||) = {worst:.3e} (tol 1); {len(stat_keys)} running statistics: worst "
          f"|fused-xla| / (1e-4 |xla| + 1e-5 max|xla|) = {stat_worst:.3e} (tol 1) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "fused and xla ReparamConv disagree on the fp32 train step")
    del fused, xla

    # bf16 at full width, 256^2, B=16: the loss and the gradients of every
    # ReparamConv block (its 24 parameters as one vector), each backend
    # measured against a float32 'xla' step from the same weights; 'fused'
    # may be off by at most twice as much as 'xla', plus 1e-4 of the loss or
    # 1e-3 of the block gradient's norm. Per block, not per parameter: a few
    # single gradients are mostly bf16 noise (the first block's expand
    # weight is 14 % off float32 in 'xla' itself), and there the ratio of
    # two noise draws spreads past 2 while the block's does not.
    x, y = _batch(BATCH, IMG, "val", 4, dev)
    fused, xla, ref = _same_start(dev, 3, (torch.bfloat16, "flat", "fused"),
                                  (torch.bfloat16, "flat", "xla"), (torch.float32, "flat", "xla"))
    rc_blocks = {mn: [f"{mn}.{pn}" for pn, _ in m.named_parameters()]
                 for mn, m in fused.named_modules() if isinstance(m, blocks.ReparamConv)}
    lf, gf = _one_step(fused, x, y, seed=6)
    lx, gx = _one_step(xla, x, y, seed=6)
    lr, gr = _one_step(ref, x, y, seed=6)
    del fused, xla, ref
    ok = np.isfinite(lf) and abs(lf - lr) <= 2 * abs(lx - lr) + 1e-4 * abs(lr)
    print(f"phase 12: train_step bf16 {IMG}^2 B={BATCH} rc fused vs xla: loss {lf:.6f} vs "
          f"{lx:.6f}, fp32 {lr:.6f} (tol |fused-fp32| <= 2 |xla-fp32| + 1e-4 |fp32|) "
          f"{'ok' if ok else 'FAIL'}")

    def dist(g, names):
        return sum((g[n] - gr[n]).square().sum().item() for n in names) ** 0.5

    def norm(names):
        return sum(gr[n].square().sum().item() for n in names) ** 0.5

    ratios, rel = {}, {}
    for mn, names in rc_blocks.items():
        df, dx = dist(gf, names), dist(gx, names)
        ratios[mn] = df / (2 * dx + 1e-3 * norm(names))
        rel[mn] = (df / norm(names), dx / norm(names))
    names = [n for ns in rc_blocks.values() for n in ns]
    per_param = [(gf[n] - gr[n]).norm().item() / max((gx[n] - gr[n]).norm().item(), 1e-30)
                 for n in names]
    worst = max(ratios.values())
    ok = ok and bool(np.isfinite(worst)) and worst <= 1.0
    print(f"phase 12: train_step bf16 {IMG}^2 B={BATCH}: {len(rc_blocks)} ReparamConv blocks "
          f"({len(names)} gradients), ||g-fp32|| / ||fp32|| per block fused "
          f"{min(r[0] for r in rel.values()):.4f}-{max(r[0] for r in rel.values()):.4f}, xla "
          f"{min(r[1] for r in rel.values()):.4f}-{max(r[1] for r in rel.values()):.4f}; all "
          f"ReparamConv gradients fused {dist(gf, names) / norm(names):.4f} xla "
          f"{dist(gx, names) / norm(names):.4f}; worst ||fused-fp32|| / "
          f"(2 ||xla-fp32|| + 1e-3 ||fp32||) = {worst:.3e} (tol 1), at {max(ratios, key=ratios.get)}; "
          f"per parameter ||fused-fp32|| / ||xla-fp32|| median {float(np.median(per_param)):.3f}, "
          f"max {max(per_param):.3f} (not bounded) {'ok' if ok else 'FAIL'}")
    check(ok, "fused and xla ReparamConv disagree on the bf16 train step")

    # train_step times in turns, then B6 at the inputs of a training forward
    x, y = _batch(BATCH, IMG, "val", 7, dev)
    states = {rb: create_train_state(_train_model(dev, rc_train_backend=rb, seed=4),
                                     (BATCH, IMG, IMG, 3), seed=0) for rb in ("xla", "fused")}
    n = 10
    # one turn each: steps of one call vary by up to 20 % between turns, so
    # the two are not ranked here
    for rb in ("xla", "fused"):
        dw_gelu_flat.launches = rc_branch_stats.launches = 0
        torch.cuda.reset_peak_memory_stats()
        ms = _time_steps(states[rb], x, y, n)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"phase 12: train_step bf16 {IMG}^2 B={BATCH} rc_remat rc_train_backend {rb}: "
              f"{ms:.3f} ms/step = {BATCH * 1000 / ms:.1f} img/s, peak {peak:.2f} GiB, B5/B6 "
              f"launches per step {dw_gelu_flat.launches / (n + 3):g}/"
              f"{rc_branch_stats.launches / (n + 3):g} [{card_line}]")
    for rb in ("xla", "fused"):
        steps = 2
        states[rb], kernels, busy_ms, wall_ms, _ = _profile_steps(states[rb], x, y, steps)
        rc = rc_step_ms(kernels, steps)
        print(f"phase 12: profiled {steps} train steps, rc_train_backend {rb}: "
              f"{len(kernels) / steps:.0f} device kernels per step, device busy "
              f"{busy_ms / steps:.3f} ms per step of {wall_ms / steps:.3f} ms profiled wall, "
              f"B5 + B6 kernels and their reductions {rc['sum']:.3f} ms per step (B6 "
              f"{rc['B6']:.3f}, B5 {rc['B5']:.3f}, reductions {rc['reductions']:.3f}) "
              f"[{card_line}]")

    calls = []
    real = _capture(blocks, "rc_branch_act", calls)
    try:
        with torch.no_grad():
            states["fused"].model(x.to(torch.bfloat16), train=True, deterministic=True)
    finally:
        blocks.rc_branch_act = real
    del states
    check(len(calls) == 16, f"captured {len(calls)} fused ReparamConv inputs, want 16")
    err, total, work, by_shape = time_b6(calls, card_line)
    return train_launches, (err, total["ms"], total["plain_ms"], total["xla_ms"]), work, by_shape


def time_b6(calls, card_line):
    """B6 at the captured inputs of a training forward's 16 blocks: held
    against its plain version and bitwise repeated at each, then timed
    eagerly and as a CUDA graph beside its plain version and the stock
    bf16 composition (stats_stock), summed by block shape. Returns (worst
    error, the sums over the 16 blocks, its work, the rows by shape)."""
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats, rc_branch_stats_plain

    err = 0.0
    work = Work()
    shapes = {}  # (H, C) -> summed times of its blocks
    with torch.no_grad():
        for e, k5, k3, kv, kh, *_, C, _eps in calls:
            ks = [k5, k3, kv, kh]
            # e in; per element the four branches' 40 multiply-adds and a sum
            # and a square sum for each
            work.add(e.numel() * e.element_size(), 96 * e.numel())
            got = rc_branch_stats(e, *ks, C)
            err = max(err, check_stats("phase 12", e, ks, got, C))
            check(torch.equal(got, rc_branch_stats(e, *ks, C)),
                  f"rc_stats is not bitwise repeatable at {tuple(e.shape)}")
            fn = lambda: rc_branch_stats(e, *ks, C)  # noqa: E731
            stock = lambda: stats_stock(e, ks, C)  # noqa: E731
            t = {"ms": cuda_ms(fn), "graph_ms": graph_ms(fn),
                 "plain_ms": cuda_ms(lambda: rc_branch_stats_plain(e, *ks, C), iters=5),
                 "xla_ms": cuda_ms(stock), "xla_graph_ms": graph_ms(stock),
                 "bound_ms": 96 * e.numel() / F32_RATE * 1e3, "blocks": 1}
            row = shapes.setdefault((e.shape[1], C), dict.fromkeys(t, 0.0))
            for k, v in t.items():
                row[k] += v
    total = {k: sum(r[k] for r in shapes.values()) for k in ("ms", "graph_ms", "plain_ms",
                                                              "xla_ms", "xla_graph_ms")}
    by_shape = []
    for (H, C), r in shapes.items():
        flops = 96 * BATCH * H * H * C * r["blocks"]
        print(f"phase 12: rc_stats at the {int(r['blocks'])} training-forward blocks of shape "
              f"{H}^2 E={C} B={BATCH} bf16: eager {r['ms']:.4f} ms "
              f"({flops / r['ms'] / 1e9:.2f} TFLOP/s), CUDA graph "
              f"{r['graph_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (operations), plain "
              f"{r['plain_ms']:.4f} ms, stock bf16 composition {r['xla_ms']:.4f} ms "
              f"(graph {r['xla_graph_ms']:.4f}) [{card_line}]")
        by_shape.append({"H": H, "W": H, "C": C, **r, "tflop_s": flops / r["ms"] / 1e9})
    print(f"phase 12: rc_stats over the 16 ReparamConv blocks of a training forward (256^2, "
          f"B=16, bf16): kernel {total['ms']:.4f} ms eager, {total['graph_ms']:.4f} ms as CUDA "
          f"graphs, plain {total['plain_ms']:.4f} ms, the stock bf16 composition 'xla' runs for "
          f"the same statistics {total['xla_ms']:.4f} ms (graph {total['xla_graph_ms']:.4f}); "
          f"bound {work.bound()[0]:.4f} ms [{card_line}]")
    return err, total, work, by_shape


def check_b3(label, got, q, k, v, rpb, B, H, W, C) -> float:
    """Hold B3's NHWC output against the plain NAT (check_fwd's bounds) and
    against B1 on the same inputs: f32 abs 1e-5; bf16 two roundings of the
    stored results, 2^-7 |B1| + 1e-4. Returns the error against plain."""
    from lmnet_tpu_torch.ops.nat_flat import nat_flat

    flat = (B, H, W * C)
    err = check_fwd(label, got.reshape(flat), q, k, v, rpb, B, H, W, C, "nat_kernel")
    b1 = nat_flat(q.reshape(flat), k.reshape(flat), v.reshape(flat), rpb, HEADS, C, W).float()
    d = (got.reshape(flat).float() - b1).abs()
    ok = bool((d <= (1e-5 if q.dtype == torch.float32 else 2**-7 * b1.abs() + 1e-4)).all())
    print(f"{label}: nat_kernel vs nat_fwd B={B} H={H} W={W} C={C} {_dt(q.dtype)} "
          f"[{b3_variant(B, H, W, C, q.dtype)}]: max_abs_diff={d.max().item():.3e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"nat_kernel disagrees with nat_fwd at {(B, H, W, C, q.dtype)}")
    return err


def check_b3_variants(dev) -> float:
    """Hold B3 against the plain NAT at B3_VARIANT_SHAPES, float32 and bf16
    (check_fwd's bounds), each with its plan's variant; return the worst
    float32 error."""
    from lmnet_tpu_torch.ops.nat import neighborhood_attention
    from lmnet_tpu_torch.ops.nat_kernel import b3_plan, neighborhood_attention_pallas

    worst = 0.0
    for i, (B, H, W, heads, hd) in enumerate(B3_VARIANT_SHAPES):
        g = torch.Generator(device="cpu").manual_seed(1350 + i)
        q, k, v = (torch.randn(B, H, W, heads * hd, generator=g) for _ in range(3))
        rpb = (torch.randn(heads, 5, 5, generator=g) * 0.3).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dev, dtype) for t in (q, k, v))
            got = neighborhood_attention_pallas(qd, kd, vd, rpb).float()
            ref = neighborhood_attention(qd.float(), kd.float(), vd.float(), rpb, 3)
            err = (got - ref).abs()
            f32 = dtype == torch.float32
            ok = bool((err <= (1e-5 if f32 else 2**-8 * ref.abs() + 1e-4)).all())
            p = b3_plan(B, H, W, heads, hd, dtype)
            rank = f" rank {p['rank']}" if p["variant"] == "vec" else ""
            print(f"phase 13: nat_kernel vs plain B={B} H={H} W={W} heads={heads} hd={hd} "
                  f"{_dt(dtype)} [{p['variant']}{rank}]: max_abs_err={err.max().item():.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"nat_kernel disagrees with plain at {(B, H, W, heads, hd, dtype)}")
            worst = max(worst, err.max().item()) if f32 else worst
    return worst


def b3_variant(B, H, W, C, dtype) -> str:
    """B3's launch plan for this call in a few words: variant, map rank,
    tile, heads a tile, persistent blocks over tiles ('n/a' for a package
    without the plan, an earlier commit's)."""
    from lmnet_tpu_torch.ops import nat_kernel

    if not hasattr(nat_kernel, "b3_plan"):
        return "n/a"
    p = nat_kernel.b3_plan(B, H, W, HEADS, C // HEADS, dtype)
    rank = f" rank {p['rank']}" if p["variant"] == "vec" else ""
    return (f"{p['variant']}{rank}, tile {p['tile'][0]}x{p['tile'][1]}, "
            f"{p['heads_per_block']} heads, {p['blocks']} blocks / {p['tiles']} tiles")


def up_variant(x, rows=None) -> str:
    """B7's launch plan for x (a slab of which it writes the outputs of
    ``rows`` rows) in a few words: variant, tile, blocks ('n/a' for a
    package without the plan)."""
    from lmnet_tpu_torch.ops import upsample_flat

    if not hasattr(upsample_flat, "upsample_plan"):
        return "n/a"
    B, Hs, W, C = x.shape
    p = (upsample_flat.upsample_plan(B, Hs, W, C, x.dtype) if rows is None
         else upsample_flat.upsample_plan(B, rows, W, C, x.dtype, Hs))
    gx, gy, gz = p["grid"]
    copies = f", {p['copies']} TMA copies a tile" if p["variant"] == "tma" else ""
    return f"{p['variant']}, tile {p['tile'][0]}x{p['tile'][1]}, {gx * gy * gz} blocks{copies}"


def _served_batch(dev):
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.data.augment import eval_pipeline

    images, masks = next(iter(make_loader(SyntheticDataset(BATCH, IMG, "val", seed=0), BATCH)))
    xb, _ = eval_pipeline(torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev), IMG)
    return xb.to(torch.bfloat16)


def _logits_close(label, out, ref, bound=None, flips_max=0.025, rel_max=None):
    """Served bf16 logits against a reference's: max |diff| <= ``bound``,
    argmax flips under ``flips_max``, mean |diff| / mean |ref| under
    ``rel_max`` (a None bound is printed, not held); print one line, raise
    if not."""
    err = (out - ref).abs().max().item()
    flips = (out.argmax(-1) != ref.argmax(-1)).float().mean().item()
    rel = ((out - ref).abs().mean() / ref.abs().mean()).item()
    ok = (out.shape == ref.shape and bool(torch.isfinite(out).all())
          and (bound is None or err <= bound) and (flips_max is None or flips < flips_max)
          and (rel_max is None or rel < rel_max))
    print(f"{label}: max_abs_diff={err:.3e} (tol {bound}) mean rel diff={rel:.3e} "
          f"(tol {rel_max}) argmax flips={flips:.4%} (tol {flips_max}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: logits disagree")


def phase_b3(model, dev, card_line):
    """Phase 13; returns the B3 entry's numbers and its launches by path."""
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.models.blocks import NeighborhoodAttention2D
    from lmnet_tpu_torch.ops.nat_flat import nat_flat
    from lmnet_tpu_torch.ops.nat_kernel import (
        neighborhood_attention_pallas,
        neighborhood_attention_pallas_plain,
    )
    from lmnet_tpu_torch.serve import deploy_forward, serving_evaluate
    from lmnet_tpu_torch.train import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for i, (B, H, W, C) in enumerate(CHECK_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, rpb = nat_inputs(B, H, W, C, dtype, 1300 + i, dev)
            got = neighborhood_attention_pallas(*(t.reshape(B, H, W, C) for t in (q, k, v)), rpb)
            worst = max(worst, check_b3("phase 13", got, q, k, v, rpb, B, H, W, C))
    worst = max(worst, check_b3_variants(dev))
    ms = {"nat_kernel": 0.0, "graph": 0.0, "nat_fwd": 0.0, "nat_fwd_graph": 0.0, "plain": 0.0}
    work, stages = Work(), []
    with torch.inference_mode():
        for i, (H, W, C) in enumerate(STAGES_256):
            q, k, v, rpb = nat_inputs(BATCH, H, W, C, torch.bfloat16, 1400 + i, dev)
            q4, k4, v4 = (t.reshape(BATCH, H, W, C) for t in (q, k, v))
            got = neighborhood_attention_pallas(q4, k4, v4, rpb)
            worst = max(worst, check_b3("phase 13", got, q, k, v, rpb, BATCH, H, W, C))
            work.add(*nat_fwd_work(q, C))
            b3 = lambda: neighborhood_attention_pallas(q4, k4, v4, rpb)  # noqa: E731
            b1 = lambda: nat_flat(q, k, v, rpb, HEADS, C, W)  # noqa: E731
            t = {"nat_kernel": cuda_ms(b3), "graph": graph_ms(b3), "nat_fwd": cuda_ms(b1),
                 "nat_fwd_graph": graph_ms(b1),
                 "plain": cuda_ms(lambda: neighborhood_attention_pallas_plain(q4, k4, v4, rpb),
                                  iters=5)}
            for key in ms:
                ms[key] += t[key]
            variant = b3_variant(BATCH, H, W, C, torch.bfloat16)
            stages.append({"H": H, "W": W, "C": C, "variant": variant, "ms": t["nat_kernel"],
                           "graph_ms": t["graph"], "nat_fwd_ms": t["nat_fwd"],
                           "nat_fwd_graph_ms": t["nat_fwd_graph"],
                           "bound_ms": nat_fwd_work(q, C)[0] / HBM_RATE * 1e3})
            print(f"phase 13: nat stage H={H} W={W} C={C} B={BATCH} bf16 [{variant}]: nat_kernel "
                  f"{t['nat_kernel']:.4f} ms eager, {t['graph']:.4f} as a CUDA graph; nat_fwd "
                  f"{t['nat_fwd']:.4f} / {t['nat_fwd_graph']:.4f} ms; plain {t['plain']:.4f} ms "
                  f"[{card_line}]")
    print(f"phase 13: the four stages: nat_kernel {ms['nat_kernel']:.4f} ms eager, "
          f"{ms['graph']:.4f} as CUDA graphs; nat_fwd {ms['nat_fwd']:.4f} / "
          f"{ms['nat_fwd_graph']:.4f} ms; plain {ms['plain']:.4f} ms (bound "
          f"{work.bound()[0]:.4f} ms, {work.bound()[1]}) [{card_line}]")

    # serving with nat_backend='pallas'
    n_images = 32
    n_batches = (n_images + BATCH - 1) // BATCH
    state = model.state_dict()
    torch.cuda.synchronize()
    neighborhood_attention_pallas.launches = nat_flat.launches = 0
    loss, metrics = serving_evaluate(
        state, make_loader(SyntheticDataset(n_images, IMG, "val", seed=0), BATCH),
        num_classes=2, img_size=IMG, num_heads=HEADS, nat_backend="pallas")
    torch.cuda.synchronize()
    serve = neighborhood_attention_pallas.launches
    print(f"phase 13: serving_evaluate nat_backend=pallas {n_images} images at {IMG}^2 "
          f"B={BATCH}: loss={loss:.6f} metrics={json.dumps(metrics)} nat_kernel launches={serve} "
          f"nat_fwd launches={nat_flat.launches}")
    check(np.isfinite(loss) and all(np.isfinite(v) for v in metrics.values()),
          "non-finite loss or metrics with nat_backend='pallas'")
    check(serve == 4 * n_batches and nat_flat.launches == 0,
          f"nat_kernel launched {serve} times, want 4 x {n_batches} batches and no nat_fwd")
    deploy = structural_reparam(state)
    xb = _served_batch(dev)
    with torch.inference_mode():
        lp = deploy_forward(deploy, xb, num_heads=HEADS, nat_backend="pallas")
        lf = deploy_forward(deploy, xb, num_heads=HEADS, nat_backend="flat")
    _logits_close(f"phase 13: deploy_forward bf16 {IMG}^2 B={BATCH} nat pallas vs flat", lp, lf,
                  bound=0.05 * max(lf.abs().max().item(), 1.0))
    del deploy, xb

    # train_step: float32 64^2 B=2, the loss and every gradient against
    # 'flat' (phase 8's bounds)
    x, y = _batch(2, 64, "val", 3, dev)
    pallas, flat = _same_start(dev, 2, (torch.float32, "pallas"), (torch.float32, "flat"))
    lp, gp = _one_step(pallas, x, y, seed=5)
    lf, gf = _one_step(flat, x, y, seed=5)
    big = max(g.norm().item() for g in gf.values())
    w = max((gp[k] - gf[k]).norm().item() / (1e-3 * gf[k].norm().item() + 1e-5 * big) for k in gf)
    ok = abs(lp - lf) <= 1e-5 * abs(lf) and w <= 1.0
    print(f"phase 13: train_step fp32 64^2 B=2 pallas vs flat: loss {lp:.7f} vs {lf:.7f} (tol rel "
          f"1e-5); {len(gf)} gradients: worst ||pallas-flat|| / (1e-3 ||flat|| + 1e-5 max||g||) = "
          f"{w:.3e} (tol 1) {'ok' if ok else 'FAIL'}")
    check(ok, "pallas and flat NAT disagree on the fp32 train step")
    del pallas, flat

    # bf16 at full width: the NAT layers' gradients, each backend against a
    # float32 plain step from the same weights (phase 8's bound); the B3
    # launches of this step are the training path's
    x, y = _batch(BATCH, IMG, "val", 4, dev)
    pallas, plain, ref = _same_start(dev, 3, (torch.bfloat16, "pallas"),
                                     (torch.bfloat16, "plain"), (torch.float32, "plain"))
    nat_names = [f"{mn}.{pn}" for mn, m in pallas.named_modules()
                 if isinstance(m, NeighborhoodAttention2D) for pn, _ in m.named_parameters()]
    neighborhood_attention_pallas.launches = 0
    lp, gp = _one_step(pallas, x, y, seed=6)
    train = neighborhood_attention_pallas.launches
    lq, gq = _one_step(plain, x, y, seed=6)
    lr, gr = _one_step(ref, x, y, seed=6)
    del pallas, plain, ref
    ok = (np.isfinite(lp) and abs(lp - lr) <= 2 * abs(lq - lr) + 1e-4 * abs(lr)
          and train == 4)
    ratios = {n: (gp[n] - gr[n]).norm().item()
              / (2 * (gq[n] - gr[n]).norm().item() + 1e-3 * gr[n].norm().item()) for n in nat_names}
    worst_g = max(ratios.values())
    ok = ok and bool(np.isfinite(worst_g)) and worst_g <= 1.0
    print(f"phase 13: train_step bf16 {IMG}^2 B={BATCH} nat pallas: loss {lp:.6f}, plain {lq:.6f}, "
          f"fp32 {lr:.6f}; nat_kernel launches {train} (want 4); {len(nat_names)} NAT-layer "
          f"gradients, worst ||pallas-fp32|| / (2 ||plain-fp32|| + 1e-3 ||fp32||) = {worst_g:.3e} "
          f"(tol 1), at {max(ratios, key=ratios.get)} {'ok' if ok else 'FAIL'}")
    check(ok, "pallas NAT disagrees on the bf16 train step")

    x, y = _batch(BATCH, IMG, "val", 7, dev)
    states = {nb: create_train_state(_train_model(dev, nat_backend=nb, seed=4),
                                     (BATCH, IMG, IMG, 3), seed=0) for nb in ("flat", "pallas")}
    times = {"flat": [], "pallas": []}
    for nb in ("pallas", "flat", "flat", "pallas"):
        times[nb].append(_time_steps(states[nb], x, y, 5))
    del states
    print(f"phase 13: train_step bf16 {IMG}^2 B={BATCH} rc_remat, turns pallas, flat, flat, pallas: "
          + "; ".join(f"nat {nb} {' / '.join(f'{t:.3f}' for t in ts)} ms" for nb, ts in times.items())
          + f" [{card_line}]")
    return ({"max_abs_err": worst, "ms": ms["nat_kernel"], "plain_ms": ms["plain"],
             "graph_ms": ms["graph"], "nat_fwd_ms": ms["nat_fwd"],
             "nat_fwd_graph_ms": ms["nat_fwd_graph"], "ms_by_stage": stages}, work,
            {"serving": serve, "training": train})


# (B, H, W, C) of the 2x upsamples of one 256^2 forward (up1..up4 and the
# skips' convs inputs), at B=16; phase 14 also checks them at B=2
UPSAMPLE_SHAPES = [(BATCH, 16, 16, 192), (BATCH, 32, 32, 96), (BATCH, 64, 64, 48),
                   (BATCH, 128, 128, 24)]
# the same at the 'train' split's 288^2 load size, which the training epoch sees
UPSAMPLE_SHAPES_288 = [(BATCH, 18, 18, 192), (BATCH, 36, 36, 96), (BATCH, 72, 72, 48),
                       (BATCH, 144, 144, 24)]


def check_up(label, got, x, window=()) -> float:
    """Hold B7's output against the plain version on x upcast to float32 (at
    the row window (top, rows, Hg, row0) of a slab x):
    f32 within 1e-6 (1 + |ref|), bf16 within one rounding of the stored
    value, 2^-8 |ref| + 1e-6. Print one line; raise on a mismatch."""
    from lmnet_tpu_torch.ops.upsample_flat import upsample2x_flat_plain

    ref = upsample2x_flat_plain(x.float(), *window)
    err = (got.float() - ref).abs()
    bound = 1e-6 * (1 + ref.abs()) if x.dtype == torch.float32 else 2**-8 * ref.abs() + 1e-6
    ok = bool((err <= bound).all()) and got.dtype == x.dtype and got.shape == ref.shape
    print(f"{label}: upsample_flat vs plain {tuple(x.shape)} {_dt(x.dtype)} "
          f"[{up_variant(x, window[1] if window else None)}]: "
          f"max_abs_err={err.max().item():.3e} {'ok' if ok else 'FAIL'}")
    check(ok, f"upsample_flat disagrees with plain at {tuple(x.shape)} {x.dtype}")
    return err.max().item()


def phase_b7(model, dev, card_line):
    """Phase 14; returns the B7 entry's numbers and its launches by path."""
    import torch.nn.functional as F

    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.ops import resize
    from lmnet_tpu_torch.ops.upsample_flat import upsample2x_flat, upsample2x_flat_plain
    from lmnet_tpu_torch.serve import deploy_forward, serving_evaluate
    from lmnet_tpu_torch.train import create_train_state, train_one_epoch

    worst = 0.0
    odd = [(2, 5, 7, 3), (2, 1, 1, 8), (3, 9, 13, 12), (1, 7, 3, 20)]
    shapes = (UPSAMPLE_SHAPES + [(2, h, w, c) for _, h, w, c in UPSAMPLE_SHAPES]
              + UPSAMPLE_SHAPES_288 + odd)
    for i, shape in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(*shape, generator=torch.Generator().manual_seed(1500 + i))
            x = x.to(dev, dtype)
            worst = max(worst, check_up("phase 14", upsample2x_flat(x), x))
    x = torch.randn(2, 128, 128, 24, generator=torch.Generator().manual_seed(1600)).to(dev)
    g = torch.randn(2, 256, 256, 24, generator=torch.Generator().manual_seed(1601)).to(dev)
    xa, xb_ = x.clone().requires_grad_(), x.clone().requires_grad_()
    (ga,) = torch.autograd.grad(upsample2x_flat(xa), xa, g)
    (gb,) = torch.autograd.grad(upsample2x_flat_plain(xb_), xb_, g)
    err = (ga - gb).abs().max().item()
    ok = err <= 1e-5 * (1 + gb.abs().max().item())
    print(f"phase 14: upsample_flat backward vs autograd of plain (2, 128, 128, 24) f32: "
          f"max_abs_err={err:.3e} (tol 1e-5 (1 + max|ref|)) {'ok' if ok else 'FAIL'}")
    check(ok, "upsample_flat's backward disagrees with the plain adjoint")

    resize.UPSAMPLE_BACKEND = "flat"
    try:
        n_images = 32
        n_batches = (n_images + BATCH - 1) // BATCH
        state = model.state_dict()
        torch.cuda.synchronize()
        upsample2x_flat.launches = 0
        loss, metrics = serving_evaluate(
            state, make_loader(SyntheticDataset(n_images, IMG, "val", seed=0), BATCH),
            num_classes=2, img_size=IMG, num_heads=HEADS)
        torch.cuda.synchronize()
        serve = upsample2x_flat.launches
        print(f"phase 14: serving_evaluate upsample backend flat {n_images} images at {IMG}^2 "
              f"B={BATCH}: loss={loss:.6f} metrics={json.dumps(metrics)} upsample_flat "
              f"launches={serve}")
        check(np.isfinite(loss) and serve == 7 * n_batches,
              f"upsample_flat launched {serve} times, want 7 x {n_batches} batches")
        steps = 2
        tstate = create_train_state(_train_model(dev, seed=5), (BATCH, IMG * 9 // 8, IMG * 9 // 8, 3),
                                    seed=0, epochs=10, steps_per_epoch=steps)
        tcalls = []
        real = _capture(resize, "upsample2x_flat", tcalls)
        upsample2x_flat.launches = 0
        try:
            tstate, total, tmetrics = train_one_epoch(
                tstate, make_loader(SyntheticDataset(steps * BATCH, IMG, "train", seed=0), BATCH),
                img_size=IMG, augment_on_device=False)
            torch.cuda.synchronize()
        finally:
            resize.upsample2x_flat = real
        train = upsample2x_flat.launches
        del tstate
        print(f"phase 14: train_one_epoch upsample backend flat {steps} steps ({IMG * 9 // 8}^2, "
              f"B={BATCH}, bf16, rc_remat): loss={total:.6f} upsample_flat launches={train}")
        check(np.isfinite(total) and train == 7 * steps,
              f"upsample_flat launched {train} times in training, want 7 x {steps} steps")
        # the counted steps' own upsample inputs, held against the plain version
        for (x,) in tcalls[:7]:
            x = x.detach()
            worst = max(worst, check_up("phase 14 trained", upsample2x_flat(x), x))

        deploy = structural_reparam(state)
        xb = _served_batch(dev)
        calls = []
        real = _capture(resize, "upsample2x_flat", calls)
        try:
            with torch.inference_mode():
                lu = deploy_forward(deploy, xb, num_heads=HEADS)
        finally:
            resize.upsample2x_flat = real
    finally:
        resize.UPSAMPLE_BACKEND = "einsum"
    with torch.inference_mode():
        le = deploy_forward(deploy, xb, num_heads=HEADS)
    _logits_close(f"phase 14: deploy_forward bf16 {IMG}^2 B={BATCH} upsample flat vs einsum",
                  lu, le, bound=0.05 * max(le.abs().max().item(), 1.0))
    check(len(calls) == 7, f"captured {len(calls)} upsample inputs, want 7")
    total = {"ms": 0.0, "graph_ms": 0.0, "graph10_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    work, by_call = Work(), []
    with torch.inference_mode():
        for (x,) in calls:
            worst = max(worst, check_up("phase 14 served", upsample2x_flat(x), x))
            # x in, the 4x larger output out; ~6 operations an output element
            work.add(5 * x.numel() * x.element_size(), 24 * x.numel())
            fn = lambda: upsample2x_flat(x)  # noqa: E731
            t = {"ms": cuda_ms(fn), "graph_ms": graph_ms(fn), "graph10_ms": graph_ms(fn, calls=10),
                 "plain_ms": cuda_ms(lambda: upsample2x_flat_plain(x)),
                 "library_ms": cuda_ms(lambda: F.interpolate(
                     x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear", align_corners=True))}
            for key in total:
                total[key] += t[key]
            # the host's share of an eager call: eager less the device time
            # (a graph of 10 calls, whose replay's host cost is spread)
            host_us = (t["ms"] - t["graph10_ms"]) * 1e3
            by_call.append({"shape": list(x.shape), "variant": up_variant(x), "host_us": host_us,
                            "bound_ms": 5 * x.numel() * x.element_size() / HBM_RATE * 1e3, **t})
            print(f"phase 14:   upsample {tuple(x.shape)} bf16 [{up_variant(x)}]: eager "
                  f"{t['ms']:.4f} ms, CUDA graph {t['graph_ms']:.4f} ms (10 calls a graph: "
                  f"{t['graph10_ms']:.4f} ms a call), host {host_us:.1f} us a call; plain "
                  f"{t['plain_ms']:.4f} ms, F.interpolate {t['library_ms']:.4f} ms [{card_line}]")
    host = sum(c["host_us"] for c in by_call)
    print(f"phase 14: the 7 upsamples of a served batch ({', '.join(str(tuple(c[0].shape)) for c in calls)}"
          f", bf16): upsample_flat {total['ms']:.4f} ms eager, {total['graph_ms']:.4f} as CUDA "
          f"graphs ({total['graph10_ms']:.4f} in graphs of 10 calls), host {host:.1f} us in all; "
          f"plain {total['plain_ms']:.4f} ms, F.interpolate {total['library_ms']:.4f} ms (bound "
          f"{work.bound()[0]:.4f} ms, {work.bound()[1]}) [{card_line}]")
    return ({"max_abs_err": worst, **total, "host_us": host, "ms_by_call": by_call}, work,
            {"serving": serve, "training": train})


def phase_options(model, dev, card_line):
    """Phase 15: natt_int8, ln_fold and skip_compose served at full width."""
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.serve import deploy_forward

    deploy = structural_reparam(model.state_dict())
    xb = _served_batch(dev)
    opts = {"default": {}, "natt_int8": {"natt_int8": True}, "ln_fold": {"ln_fold": True},
            "skip_compose": {"skip_compose": True}}
    with torch.inference_mode():
        ref = deploy_forward(deploy, xb, num_heads=HEADS)
        scale = ref.abs().max().item()
        # the CPU tests' bounds: ln_fold as the other bf16 backends, the
        # composed skips' logits within 0.3 max|ref|, the int8 interiors'
        # mean relative error under 0.05; every option's argmax flips < 2.5 %
        bounds = {"ln_fold": dict(bound=0.05 * max(scale, 1.0)),
                  "skip_compose": dict(bound=0.3 * scale),
                  "natt_int8": dict(rel_max=0.05)}
        for name, kw in bounds.items():
            out = deploy_forward(deploy, xb, num_heads=HEADS, **opts[name])
            _logits_close(f"phase 15: deploy_forward bf16 {IMG}^2 B={BATCH} {name} vs default",
                          out, ref, **kw)
        times = {k: [] for k in opts}
        for name in (*opts, *reversed(opts)):
            times[name].append(cuda_ms(lambda: deploy_forward(deploy, xb, num_heads=HEADS,
                                                              **opts[name]), iters=10))
    print(f"phase 15: deploy_forward bf16 {IMG}^2 B={BATCH} by option, turns there and back: "
          + "; ".join(
        f"{k} {' / '.join(f'{t:.3f}' for t in ts)} ms" for k, ts in times.items())
        + f" [{card_line}]")


# (B, H, W, heads, head_dim) at which phase 16 also holds B8 against its
# plain versions (tests/test_torch_natt.py holds it at the same shapes on the
# card): LM-Net's four NATT widths (12 heads), a 3x3 map, head_dim 3, maps
# that end mid-tile
B8_SHAPES = [(2, 32, 32, 12, 1), (2, 16, 24, 12, 2), (1, 16, 16, 12, 4), (2, 8, 8, 12, 8),
             (1, 3, 3, 2, 2), (1, 11, 7, 4, 3), (1, 19, 21, 2, 16)]


def natt_work(B, H, W, C, heads, packed_words):
    """B8's work on (B, H, W*C) bf16 emb: emb in and out once and the
    float32 weights once; per pixel the NAT's and ~56 C float32 operations
    (two LayerNorms, the GELU, the residuals), and 8 C^2 multiply-adds (q,
    k, v, proj, fc1, fc2) of tensor-core work."""
    work = Work()
    px = B * H * W
    work.add(2 * 2 * px * C + 4 * packed_words, px * (36 * C + 36 * heads + 56 * C),
             px * 16 * C * C)
    return work


def phase_b8(model, dev, card_line):
    """Phase 16; returns the B8 entry's numbers, its work, its launches and
    its times by stage."""
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.ops.natt_flat import (
        fold_natt_weights,
        natt_flat_interior,
        natt_flat_interior_plain,
        natt_plan,
    )
    from lmnet_tpu_torch.serve import deploy_forward, engine

    deploy = structural_reparam(model.state_dict())
    xb = _served_batch(dev)
    calls = []
    real = _capture(engine, "_natt", calls)
    try:
        with torch.inference_mode():
            deploy_forward(deploy, xb, num_heads=HEADS)
    finally:
        engine._natt = real
    check(len(calls) == 4, f"captured {len(calls)} NATT inputs, want 4")
    with torch.inference_mode():
        stages = []
        for sd, name, x, *_ in calls:
            emb = engine._conv(sd, f"{name}.patchembedding.patch_embeddings", x)
            B, H, W, C = emb.shape
            stages.append((name, emb, fold_natt_weights(sd, name, HEADS), (B, H, W, C)))
        natt_flat_interior.launches = 0
        outs = [natt_flat_interior(emb.reshape(B, H, W * C), fw, HEADS, C, W)
                for _, emb, fw, (B, H, W, C) in stages]
        torch.cuda.synchronize()
        launches = natt_flat_interior.launches
        print(f"phase 16: natt_flat over the four NATT stages of a served batch: launches "
              f"{launches} (want 4)")
        check(launches == 4, f"natt_flat launched {launches} times, want 4")
        worst = 0.0
        ms = {"natt_flat": 0.0, "graph": 0.0, "plain": 0.0, "unfused": 0.0, "unfused_graph": 0.0}
        work = Work()
        by_stage = []
        for (name, emb, fw, (B, H, W, C)), got in zip(stages, outs):
            e = emb.reshape(B, H, W * C)
            worst = max(worst, check_b8("phase 16", e, fw, HEADS, C, W, got))
            e32 = e.float()
            worst = max(worst, check_b8("phase 16", e32, fw, HEADS, C, W,
                                        natt_flat_interior(e32, fw, HEADS, C, W)))
            unf = engine.natt_interior(deploy, name, emb, HEADS, "flat").reshape(B, H, W * C)
            d = (got.float() - unf.float()).abs().max().item()
            w = natt_work(B, H, W, C, HEADS, fw["packed"].numel())
            work.add(w.nbytes, w.flops, w.tc_flops)
            fn = lambda: natt_flat_interior(e, fw, HEADS, C, W)  # noqa: E731
            un = lambda: engine.natt_interior(deploy, name, emb, HEADS, "flat")  # noqa: E731
            t = {"natt_flat": cuda_ms(fn), "graph": graph_ms(fn),
                 "plain": cuda_ms(lambda: natt_flat_interior_plain(e, fw, HEADS, C, W), iters=5),
                 "unfused": cuda_ms(un), "unfused_graph": graph_ms(un)}
            for k in ms:
                ms[k] += t[k]
            plan = natt_plan(B, H, W, HEADS, C // HEADS, torch.bfloat16)
            bound, by = w.bound()
            print(f"phase 16: {name} H={H} W={W} C={C} B={B} bf16 [tile {plan['tile'][0]}x"
                  f"{plan['tile'][1]}, group {plan['group']}, {plan['smem']} B shared]: "
                  f"natt_flat {t['natt_flat']:.4f} ms eager, {t['graph']:.4f} ms as a CUDA graph "
                  f"({w.tc_flops / t['natt_flat'] / 1e9:.2f} TFLOP/s of product work), bound "
                  f"{bound:.4f} ms ({by}), plain {t['plain']:.4f} ms, the unfused bf16 interior "
                  f"{t['unfused']:.4f} ms (graph {t['unfused_graph']:.4f}) (max |natt_flat - "
                  f"unfused| {d:.3e}) [{card_line}]")
            by_stage.append({"H": H, "W": W, "C": C, "hd": C // HEADS, "tile": plan["tile"],
                             "group": plan["group"], "ms": t["natt_flat"], "graph_ms": t["graph"],
                             "plain_ms": t["plain"], "unfused_ms": t["unfused"],
                             "unfused_graph_ms": t["unfused_graph"], "bound_ms": bound,
                             "bound_by": by})
        for i, (B, H, W, heads, hd) in enumerate(B8_SHAPES):
            C = heads * hd
            fw = fold_natt_weights(natt_state(900 + i, C, heads, dev), "natt", heads)
            g = torch.Generator().manual_seed(H * W)
            for dtype in (torch.bfloat16, torch.float32):
                e = torch.randn(B, H, W * C, generator=g).to(dev, dtype)
                worst = max(worst, check_b8("phase 16", e, fw, heads, C, W,
                                            natt_flat_interior(e, fw, heads, C, W)))
    print(f"phase 16: the four stages: natt_flat {ms['natt_flat']:.4f} ms eager, "
          f"{ms['graph']:.4f} ms as CUDA graphs, plain {ms['plain']:.4f} ms, unfused "
          f"{ms['unfused']:.4f} ms (graphs {ms['unfused_graph']:.4f}) (bound "
          f"{work.bound()[0]:.4f} ms, {work.bound()[1]}) [{card_line}]")
    return ({"max_abs_err": worst, "ms": ms["natt_flat"], "plain_ms": ms["plain"],
             "unfused_ms": ms["unfused"]}, work, launches, by_stage)


CLI_BATCH = 8  # the synthetic train set is 8 images: B=16 with drop_last gives no step


def run_cli(argv, phase: int = 17) -> str:
    """``python -m lmnet_tpu_torch.cli.train`` in this process; prints and
    returns what it printed."""
    import contextlib
    import io

    from lmnet_tpu_torch.cli import train as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"phase {phase}: cli| {line}")
    return out


def _csv_rows(path) -> list:
    import csv

    with open(path, encoding="utf-8") as f:
        return [r for r in csv.reader(f) if r]


def phase_cli(dev, card_line, export_path) -> dict:
    """Phase 17; returns the NAT launches of the CLI cycle and of the
    augmented epoch, the augmentation's numbers, and under 'export' what
    phase 19 holds the artifact ``--export`` wrote to ``export_path``
    against: a batch of 3 and the logits of ``deploy_forward(nat 'plain',
    rc 'xla')`` of the best checkpoint on it."""
    import os
    import tempfile
    from pathlib import Path

    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.data.augment import apply_params, draw_params
    from lmnet_tpu_torch.data.png import read_png
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd
    from lmnet_tpu_torch.serve import deploy_forward
    from lmnet_tpu_torch.train import checkpoint as ckpt
    from lmnet_tpu_torch.train import create_train_state, train_one_epoch
    from lmnet_tpu_torch.train.loop import augment_generator

    def counts():
        return {"nat_fwd": nat_flat.launches, "nat_bwd": nat_flat_bwd.launches}

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_", dir=build) as tmp:
        out, ck = Path(tmp) / "out", Path(tmp) / "ckpt"
        base = ["--synthetic", "--k_fold", "False", "--apm", "--img_size", str(IMG),
                "--batch_size", str(CLI_BATCH), "--seed", "0", "--ckpt_dir", str(ck),
                "--out_dir", str(out), "--device", "cuda"]
        # per command: (extra flags, epochs, want nat_fwd, want nat_bwd). A
        # train epoch is 8 // 8 = 1 step (4 forward, 4 backward NAT calls)
        # plus a 4-image eval batch (4 forward); each test or visualization
        # is one 4-image batch; the export traces the plain NAT
        cycle = [("train", [], 2, 2 * 8, 2 * 4), ("resume", ["--resume"], 3, 8, 4),
                 ("test --hd95", ["--test", "--hd95"], 3, 4, 0),
                 ("test --serve", ["--test", "--serve"], 3, 4, 0),
                 ("visualization", ["--visualization"], 3, 4, 0),
                 ("export", ["--export", str(export_path)], 3, 0, 0)]
        cli_launches = {"nat_fwd": 0, "nat_bwd": 0}
        said = {}
        t_cli = time.perf_counter()
        for name, flags, epochs, want_f, want_b in cycle:
            nat_flat.launches = nat_flat_bwd.launches = 0
            t0 = time.perf_counter()
            said[name] = run_cli(base + ["--epochs", str(epochs)] + flags)
            torch.cuda.synchronize()
            got = counts()
            print(f"phase 17: cli {name}: {time.perf_counter() - t0:.2f}s, nat_fwd launches "
                  f"{got['nat_fwd']} (want {want_f}), nat_bwd launches {got['nat_bwd']} "
                  f"(want {want_b})")
            check(got == {"nat_fwd": want_f, "nat_bwd": want_b},
                  f"cli {name} launched {got}, want {want_f} and {want_b}")
            for k in cli_launches:
                cli_launches[k] += got[k]
        rows = _csv_rows(out / "LM_NetKvasir_0.csv")
        check(len(rows) == 3 and all(len(r) == 16 for r in rows),
              f"per-epoch CSV has {[len(r) for r in rows]} columns, want 3 rows of 16")
        check(all(np.isfinite(float(v)) for r in rows for v in r), "non-finite CSV value")
        best = _csv_rows(out / "LM_NetKvasirbestresult_0.csv")
        check(len(best) == 1 and len(best[0]) == 16, "bestresult is not one 16-column row")
        check((ck / "LM_NetKvasir_0_checkpoint").is_file() and (ck / "LM_NetKvasirbest_0").is_file(),
              "missing rolling or best checkpoint")
        check("resumed fold 0 at epoch 2 (best_iou " in said["resume"], "no resume line")
        trows = _csv_rows(out / "LM_NetKvasirtest_rvd_class.csv")
        check([len(r) for r in trows] == [9, 8], f"test rows {[len(r) for r in trows]}, want 9, 8")
        ev_loss, sv_loss = float(trows[0][0]), float(trows[1][0])
        ev_dice, sv_dice = float(trows[0][5]), float(trows[1][5])
        ok = (abs(ev_loss - sv_loss) <= max(0.05 * abs(ev_loss), 0.05)
              and abs(ev_dice - sv_dice) <= 0.02)
        print(f"phase 17: --test loss {ev_loss} dice {ev_dice} hd95 {trows[0][8]}; --test --serve "
              f"loss {sv_loss} dice {sv_dice} (tol loss max(5 %, 0.05), dice 0.02) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "the served test row disagrees with the eval path's")
        viz = sorted(os.listdir(out / "viz"))
        shapes = {read_png(str(out / "viz" / f)).shape for f in viz}
        check(len(viz) == 4 and shapes == {(IMG, IMG, 3)}, f"visualizations {viz} {shapes}")
        check(f"wrote serving artifact {export_path}" in said["export"]
              and export_path.is_file(), "--export wrote no artifact")
        best_state, _, _ = ckpt.restore_checkpoint(
            str(ck), "LM_NetKvasirbest_0",
            create_train_state(_train_model(dev), (CLI_BATCH, IMG, IMG, 3), device=dev))
        export_x = _served_batch(dev)[:3]
        with torch.inference_mode():
            export_ref = deploy_forward(structural_reparam(best_state.model.state_dict()),
                                        export_x, num_heads=HEADS, nat_backend="plain")
        del best_state
        print(f"phase 17: the CLI cycle took {time.perf_counter() - t_cli:.1f}s: CSV 3x16, "
              f"bestresult, both checkpoints, the resume line, test rows 9 and 8 columns, "
              f"{len(viz)} PNGs of {IMG}^2 read back, the --export artifact "
              f"({export_path.stat().st_size / 1e6:.1f} MB); nat_fwd launches "
              f"{cli_launches['nat_fwd']}, "
              f"nat_bwd launches {cli_launches['nat_bwd']} [{card_line}]")

    # the augmented epoch: 64 'train' images (288^2) at B=16, 4 steps
    n_images, seed, epoch = 64, 0, 0
    load = IMG * 9 // 8
    ds = SyntheticDataset(n_images, IMG, "train", seed=0)
    batches = list(make_loader(ds, BATCH))
    worst, worst_frac, worst_mask = 0.0, 0.0, 1.0
    aug_ms = []
    for bi, (images, masks) in enumerate(batches):
        params = draw_params(augment_generator(seed, epoch, bi), BATCH, (load, load), IMG)
        gi, gm = torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev)
        gx, gy = apply_params(gi, gm, params, IMG)
        cx, cy = apply_params(torch.from_numpy(images), torch.from_numpy(masks), params, IMG)
        d = (gx.cpu() - cx).abs()
        frac = (d > 1e-3).double().mean().item()
        same = (gy.cpu() == cy).double().mean().item()
        ok = frac <= 1e-3 and same >= 0.999 and bool(torch.isfinite(gx).all())
        branches = torch.bincount(params["branch"], minlength=10).tolist()
        ms = cuda_ms(lambda: apply_params(gi, gm, params, IMG), iters=10, warmup=2)
        aug_ms.append(ms)
        print(f"phase 17: apply_params batch {bi} (B={BATCH}, {load}^2 -> {IMG}^2, branch counts "
              f"{branches}, jitter {int(params['jitter'].sum())}): card vs CPU max |d| "
              f"{d.max().item():.3e}, share > 1e-3 {frac:.2e} (tol 1e-3), masks equal "
              f"{same:.6f} (tol 0.999) {'ok' if ok else 'FAIL'}; {ms:.3f} ms on the card")
        check(ok, f"apply_params on the card disagrees with the CPU at batch {bi}")
        worst, worst_frac, worst_mask = max(worst, d.max().item()), max(worst_frac, frac), min(worst_mask, same)
    t0 = time.perf_counter()
    for _ in range(10):
        draw_params(augment_generator(seed, epoch, 0), BATCH, (load, load), IMG)
    draw_ms = (time.perf_counter() - t0) * 100
    state = create_train_state(_train_model(dev), (BATCH, IMG, IMG, 3), seed=0, epochs=10,
                               steps_per_epoch=n_images // BATCH, device=dev)
    nat_flat.launches = nat_flat_bwd.launches = 0
    state, total, metrics = train_one_epoch(state, make_loader(ds, BATCH), img_size=IMG,
                                            augment_on_device=True, seed=seed, epoch=epoch)
    torch.cuda.synchronize()
    aug_launches = counts()
    steps = n_images // BATCH
    print(f"phase 17: train_one_epoch(augment_on_device=True) {n_images} images ({load}^2 -> "
          f"{IMG}^2, B={BATCH}, bf16, rc_remat) {steps} steps: loss={total:.6f} "
          f"metrics={json.dumps(metrics)} nat_fwd launches {aug_launches['nat_fwd']} nat_bwd "
          f"launches {aug_launches['nat_bwd']}")
    check(np.isfinite(total) and all(np.isfinite(v) for v in metrics.values()),
          "non-finite augmented training loss or metrics")
    check(aug_launches == {"nat_fwd": 4 * steps, "nat_bwd": 4 * steps},
          f"the augmented epoch launched {aug_launches}, want 4 x {steps} each")
    rates = {"on": [], "off": []}
    for aug in (False, True):
        _, _, m = train_one_epoch(state, make_loader(ds, BATCH), img_size=IMG,
                                  augment_on_device=aug, seed=seed, epoch=1)
        rates["on" if aug else "off"].append(m["images_per_sec"])
    mean_ms = sum(aug_ms) / len(aug_ms)
    print(f"phase 17: augmentation {mean_ms:.3f} ms per batch of {BATCH} on the card "
          f"(apply_params, {', '.join(f'{v:.3f}' for v in aug_ms)} over the 4 batches; "
          f"draw_params {draw_ms:.3f} ms on the host); train epoch {n_images} images: "
          f"{', '.join(f'{v:.1f}' for v in rates['on'])} img/s with the augmentation "
          f"({IMG}^2), {', '.join(f'{v:.1f}' for v in rates['off'])} img/s without ({load}^2, "
          f"normalise only), host clock, in turns off/on [{card_line}]")
    result = {"cli": cli_launches, "train_augment": aug_launches,
              "augment": {"ms_per_batch": mean_ms, "ms_by_batch": aug_ms, "draw_ms": draw_ms,
                          "card_vs_cpu_max_abs": worst, "card_vs_cpu_share_over_1e-3": worst_frac,
                          "masks_equal": worst_mask, "img_s_on": rates["on"],
                          "img_s_off": rates["off"], "card": card_line}}
    print(f"phase 17: {json.dumps(result)}")
    result["export"] = {"x": export_x, "ref": export_ref}
    return result


# phase 18's train-mode options at full width: each against the default
# (rc_remat=True, rc_train_backend 'xla', natt_remat off, 'flat' NAT)
OPTIONS = {"default": {}, "rc_remat False": {"rc_remat": False},
           "rc_remat branches": {"rc_remat": "branches"},
           "branches fused": {"rc_remat": "branches", "rc_train_backend": "fused"},
           "natt_remat": {"natt_remat": True}}


def _option_models(dev, dtype, seed, names=tuple(OPTIONS)) -> dict:
    """One LMNet per option in ``names``, each with the first one's weights."""
    from lmnet_tpu_torch.models import LMNet

    models = {n: LMNet(generator=torch.Generator().manual_seed(seed), dtype=dtype,
                       **OPTIONS[n]).to(dev) for n in names}
    first = next(iter(models.values()))
    for m in models.values():
        m.load_state_dict(first.state_dict())
    return models


def _grad_blocks(names) -> dict:
    """Parameter names grouped by block: each ReparamConv ('conv1.0', ...)
    and each other top-level module ('natt1', 'gft', 'down1', ...)."""
    blocks = {}
    for n in names:
        p = n.split(".")
        blocks.setdefault(".".join(p[:2]) if p[0].startswith(("conv", "dconv")) else p[0],
                          []).append(n)
    return blocks


def phase_model_options(dev, card_line) -> dict:
    """Phase 18; returns the launches of one counted step on each of the
    natt_remat and rc_remat='branches' + 'fused' paths."""
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.models import LMNet
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats
    from lmnet_tpu_torch.train import create_train_state, train_step

    def zero():
        nat_flat.launches = nat_flat_bwd.launches = 0
        dw_gelu_flat.launches = rc_branch_stats.launches = 0

    def counts():
        return {"nat_fwd": nat_flat.launches, "nat_bwd": nat_flat_bwd.launches,
                "rc_dw_gelu": dw_gelu_flat.launches, "rc_stats": rc_branch_stats.launches}

    # float32 at 64^2, B=2, TF32 off: each option's loss and every gradient
    # against the default's, phase 8's bounds; dropout on, from one seed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y = _batch(2, 64, "val", 3, dev)
    models = _option_models(dev, torch.float32, 2)
    ld, gd, gen_d = _gen_step(models.pop("default"), x, y, seed=5)
    big = max(g.norm().item() for g in gd.values())
    for name, m in models.items():
        lo, go, gen_o = _gen_step(m, x, y, seed=5)
        worst = max((go[k] - gd[k]).norm().item() / (1e-3 * gd[k].norm().item() + 1e-5 * big)
                    for k in gd)
        ok = abs(lo - ld) <= 1e-5 * abs(ld) and worst <= 1.0
        extra = ""
        if name == "natt_remat":  # the same masks: the same loss and generator state
            same_gen = torch.equal(gen_o, gen_d)
            ok = ok and lo == ld and same_gen
            extra = f", loss bitwise equal {lo == ld}, generator state equal {same_gen}"
        print(f"phase 18: train_step fp32 64^2 B=2 dropout on, {name} vs default: loss "
              f"{lo:.7f} vs {ld:.7f} (tol rel 1e-5); {len(gd)} gradients: worst ||opt-default|| / "
              f"(1e-3 ||default|| + 1e-5 max||g||) = {worst:.3e} (tol 1){extra} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name} disagrees with the default on the fp32 train step")
    del models

    # bf16 at full width, 256^2, B=16: each option's loss, and its gradients
    # block by block, no further from a float32 default step than twice the
    # bf16 default's distance plus 1e-4 of the loss or 1e-3 of the block's
    # gradient norm (phases 8 and 12)
    x, y = _batch(BATCH, IMG, "val", 4, dev)
    ref = _option_models(dev, torch.float32, 3, ("default",))["default"]
    models = _option_models(dev, torch.bfloat16, 3)
    ref.load_state_dict(models["default"].state_dict())
    lr, gr, _ = _gen_step(ref, x, y, seed=6)
    del ref
    ld, gd, gen_d = _gen_step(models.pop("default"), x, y, seed=6)
    blocks = _grad_blocks(gr)

    def dist(g, names):
        return sum((g[n] - gr[n]).square().sum().item() for n in names) ** 0.5

    def norm(names):
        return sum(gr[n].square().sum().item() for n in names) ** 0.5

    for name in list(models):
        lo, go, gen_o = _gen_step(models.pop(name), x, y, seed=6)
        ratios = {b: dist(go, ns) / (2 * dist(gd, ns) + 1e-3 * norm(ns))
                  for b, ns in blocks.items()}
        worst = max(ratios.values())
        ok = (np.isfinite(lo) and abs(lo - lr) <= 2 * abs(ld - lr) + 1e-4 * abs(lr)
              and bool(np.isfinite(worst)) and worst <= 1.0)
        extra = ""
        if name == "natt_remat":
            same_gen = torch.equal(gen_o, gen_d)
            ok = ok and lo == ld and same_gen
            extra = (f", loss bitwise equal to the default's {lo == ld}, generator state "
                     f"equal {same_gen}")
        print(f"phase 18: train_step bf16 {IMG}^2 B={BATCH} dropout on, {name}: loss {lo:.6f}, "
              f"default {ld:.6f}, fp32 {lr:.6f} (tol |opt-fp32| <= 2 |default-fp32| + 1e-4 "
              f"|fp32|); {len(blocks)} blocks: worst ||opt-fp32|| / (2 ||default-fp32|| + 1e-3 "
              f"||fp32||) = {worst:.3e} (tol 1) at {max(ratios, key=ratios.get)}{extra} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name} is further from the float32 step than the default on the bf16 step")
        del go
    del models, gd, gr

    # one counted step on each new path
    x, y = _batch(BATCH, IMG, "val", 7, dev)
    states = {n: create_train_state(_option_models(dev, torch.bfloat16, 4, (n,))[n],
                                    (BATCH, IMG, IMG, 3), seed=0) for n in OPTIONS}
    want = {"natt_remat": {"nat_fwd": 8, "nat_bwd": 4, "rc_dw_gelu": 0, "rc_stats": 0},
            "branches fused": {"nat_fwd": 4, "nat_bwd": 4, "rc_dw_gelu": 32, "rc_stats": 32}}
    launches = {}
    for name, w in want.items():
        zero()
        train_step(states[name], x, y, ConfusionAccumulator.init(2, dev))
        torch.cuda.synchronize()
        launches[name] = counts()
        print(f"phase 18: one train_step bf16 {IMG}^2 B={BATCH} {name}: launches "
              f"{json.dumps(launches[name])} (want {json.dumps(w)})")
        check(launches[name] == w, f"{name} launched {launches[name]}, want {w}")

    # ms a step and peak memory, one turn an option
    times = {n: [] for n in OPTIONS}
    peaks = {}
    for name in OPTIONS:
        state = states[name]
        cm = ConfusionAccumulator.init(2, dev)
        train_step(state, x, y, cm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            train_step(state, x, y, cm)
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / 3)
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    for name in OPTIONS:
        print(f"phase 18: train_step bf16 {IMG}^2 B={BATCH} {name}: "
              f"{' / '.join(f'{t:.3f}' for t in times[name])} ms/step, "
              f"peak {peaks[name]:.2f} GiB [{card_line}]")
    del states

    # gelu_exact: the erf GELU trains with the plain branch graph; 'fused'
    # (B5 and B6 compute the tanh GELU) refuses it
    model = LMNet(generator=torch.Generator().manual_seed(5), dtype=torch.bfloat16,
                  gelu_exact=True).to(dev)
    lg, _, _ = _gen_step(model, x, y, seed=0)
    try:
        LMNet(gelu_exact=True, rc_train_backend="fused")
        refused = ""
    except ValueError as e:
        refused = str(e)
    ok = np.isfinite(lg) and "B5 and B6" in refused
    print(f"phase 18: train_step bf16 {IMG}^2 B={BATCH} gelu_exact: loss {lg:.6f}; "
          f"LMNet(gelu_exact=True, rc_train_backend='fused') raises: {refused!r} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "gelu_exact did not train, or 'fused' took it")
    return {"times": times, "peaks": peaks, "launches": launches}


def _post_npy(host, port, x, timeout=300):
    """POST ``x`` as .npy to /predict; (status, body)."""
    import http.client
    import io

    buf = io.BytesIO()
    np.save(buf, x)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/predict", body=buf.getvalue())
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get_json(host, port, path):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


CLIENTS, REQUESTS = 8, 16  # phase 19's client threads and requests each


def drive_daemon(fn, pool, dev, label, card_line) -> dict:
    """Serve ``fn`` over HTTP (127.0.0.1, port 0, max_batch 64, max_wait 5
    ms) and send it CLIENTS threads of REQUESTS requests of 1-4 images each
    from ``pool`` (sizes and images from a seeded generator); every mask is
    held against the argmax of ``fn`` on that request's images alone
    (flips < 2.5 %), and /healthz's counts against what was sent. Returns
    the rate, latencies, counts and the B1 launches while it served."""
    import io
    import threading

    from lmnet_tpu_torch.ops.nat_flat import nat_flat
    from lmnet_tpu_torch.serve.daemon import DynamicBatcher, make_server

    rng = np.random.default_rng(19)
    plan = [[rng.choice(len(pool), size=int(rng.integers(1, 5)), replace=False)
             for _ in range(REQUESTS)] for _ in range(CLIENTS)]
    batcher = DynamicBatcher(fn, img_size=IMG, max_batch=64, max_wait_ms=5.0, device=dev)
    srv = make_server(batcher, "127.0.0.1", 0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    host, port = srv.server_address
    results = [[None] * REQUESTS for _ in range(CLIENTS)]
    errors = []

    def client(c):
        try:
            for r, idx in enumerate(plan[c]):
                t0 = time.perf_counter()
                status, body = _post_npy(host, port, pool[idx])
                ms = (time.perf_counter() - t0) * 1000
                check(status == 200, f"{label}: status {status}: {body[:200]!r}")
                results[c][r] = (np.load(io.BytesIO(body), allow_pickle=False), ms)
        except Exception as e:  # reported and raised below, on the main thread
            errors.append(e)

    try:
        nat_flat.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        b1 = nat_flat.launches
        check(not errors and not any(t.is_alive() for t in threads),
              f"{label}: client errors {errors[:3]}")
        health = _get_json(host, port, "/healthz")
    finally:
        srv.shutdown()
        srv.server_close()
        server.join(timeout=30)
        batcher.stop()
    n_req = CLIENTS * REQUESTS
    n_img = sum(len(idx) for p in plan for idx in p)
    check(health["ok"] and health["requests"] == n_req and health["images"] == n_img,
          f"{label}: /healthz {health}, sent {n_req} requests of {n_img} images")
    worst = 0.0
    with torch.inference_mode():
        for c in range(CLIENTS):
            for r, idx in enumerate(plan[c]):
                mask = results[c][r][0]
                ref = fn(torch.from_numpy(pool[idx]).to(dev, torch.bfloat16)).argmax(-1)
                check(mask.shape == (len(idx), IMG, IMG) and mask.dtype == np.int32,
                      f"{label}: mask {mask.shape} {mask.dtype}")
                worst = max(worst, float((torch.from_numpy(mask).to(dev) != ref).float()
                                         .mean().item()))
    lat = np.array([results[c][r][1] for c in range(CLIENTS) for r in range(REQUESTS)])
    out = {"img_s": n_img / wall, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "requests": n_req, "images": n_img,
           "batches": health["batches"], "padded": health["padded"], "worst_flips": worst,
           "b1_launches": b1}
    ok = worst < 0.025
    print(f"phase 19: daemon {label}: {CLIENTS} clients x {REQUESTS} requests ({n_img} images "
          f"of {IMG}^2, 1-4 a request) in {wall:.2f}s = {out['img_s']:.1f} img/s, latency p50 "
          f"{out['p50_ms']:.1f} ms p99 {out['p99_ms']:.1f} ms, {health['batches']} batches, "
          f"{health['padded']} padded images, nat_fwd launches {b1}; /healthz counts match; "
          f"worst argmax flips against fn on the request alone {worst:.4%} (tol 2.5 %) "
          f"{'ok' if ok else 'FAIL'} [{card_line}]")
    check(ok, f"{label}: served masks disagree with fn on the request alone")
    return out


def start_daemon(artifact, root):
    """Start ``python -m lmnet_tpu_torch.serve.daemon --artifact ARTIFACT
    --port 0`` from ``root``, as a user does; returns the process and a
    queue of its output lines (read by a thread)."""
    import queue
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "lmnet_tpu_torch.serve.daemon", "--artifact", str(artifact),
         "--img_size", str(IMG), "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=root)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    return proc, lines


def stop_process(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)


def phase_export_daemon(dev, card_line, cli_export, cli_export_path) -> dict:
    """Phase 19; returns the daemon's numbers for both drives (B1 launches
    included) and the artifact's and eager ms."""
    import io
    import tempfile
    from pathlib import Path

    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.serve import deploy_forward
    from lmnet_tpu_torch.serve.export import load_deploy_file, save_deploy

    root = Path(__file__).resolve().parent
    model = seeded_model(dev)
    deploy = structural_reparam(model.state_dict())
    del model
    xb = _served_batch(dev)
    pool = _batch(64, IMG, "val", 5, "cpu")[0].numpy()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_", dir=root / "build") as tmp:
        paths, fns = {}, {}

        def save(where, on):
            t0 = time.perf_counter()
            paths[where] = save_deploy(str(Path(tmp) / f"{where}.pt2"),
                                       {k: v.to(on) for k, v in deploy.items()},
                                       img_size=IMG, num_heads=HEADS)
            print(f"phase 19: save_deploy on the {where} (bf16, symbolic batch, {IMG}^2): "
                  f"{time.perf_counter() - t0:.1f}s, "
                  f"{Path(paths[where]).stat().st_size / 1e6:.1f} MB")

        save("cpu", torch.device("cpu"))
        # the daemon's own entry point on the CPU's file: its start
        # (interpreter, CUDA, load, warm-up) overlaps the card's export and
        # the checks below, and it has answered and stopped before anything
        # is timed
        t_spawn = time.perf_counter()
        proc, lines = start_daemon(paths["cpu"], root)
        try:
            save("card", dev)
            for where in paths:
                t0 = time.perf_counter()
                fns[where] = load_deploy_file(paths[where], device=dev)
                print(f"phase 19: load_deploy_file of the {where}'s file onto the card: "
                      f"{time.perf_counter() - t0:.1f}s")
            with torch.inference_mode():
                for b in (1, 3, BATCH):
                    ref = deploy_forward(deploy, xb[:b], num_heads=HEADS, nat_backend="plain")
                    bound = 0.05 * max(ref.abs().max().item(), 1.0)
                    for where, fn in fns.items():
                        _logits_close(f"phase 19: artifact written on the {where}, on the card, "
                                      f"B={b}, vs deploy_forward(plain, xla)", fn(xb[:b]), ref,
                                      bound=bound)
                cli_fn = load_deploy_file(str(cli_export_path), device=dev)
                ref = cli_export["ref"]
                _logits_close("phase 19: the CLI's --export artifact on the card, B=3, vs "
                              "deploy_forward(plain, xla) of its best checkpoint",
                              cli_fn(cli_export["x"]), ref,
                              bound=0.05 * max(ref.abs().max().item(), 1.0))
                del cli_fn
                t0 = time.perf_counter()
                cpu_fn = load_deploy_file(paths["card"], device="cpu")
                out = cpu_fn(xb[:1].cpu())
                ref = fns["card"](xb[:1]).cpu()
                _logits_close(f"phase 19: artifact written on the card, loaded on the CPU "
                              f"({time.perf_counter() - t0:.1f}s with one B=1 call), vs the card",
                              out.float(), ref.float(),
                              bound=0.05 * max(ref.abs().max().item(), 1.0))
                del cpu_fn
            said = []
            while not said or not said[-1].startswith("serving on http://"):
                said.append(lines.get(timeout=300))
            up = time.perf_counter() - t_spawn
            host, port = said[-1].split("http://")[1].split()[0].split(":")
            status, body = _post_npy(host, int(port), pool[:2])
            mask = np.load(io.BytesIO(body), allow_pickle=False) if status == 200 else None
        finally:
            stop_process(proc)
        with torch.inference_mode():
            ref = fns["cpu"](torch.from_numpy(pool[:2]).to(dev, torch.bfloat16)).argmax(-1)
        flips = (float((torch.from_numpy(mask).to(dev) != ref).float().mean().item())
                 if mask is not None else 1.0)
        ok = status == 200 and mask.shape == (2, IMG, IMG) and flips < 0.025
        print(f"phase 19: python -m lmnet_tpu_torch.serve.daemon --artifact <cpu.pt2> --port 0: "
              f"{said[-1].strip()!r} {up:.1f}s after its start; one POST of 2 images: status "
              f"{status}, argmax flips against the artifact in this process {flips:.4%} (tol "
              f"2.5 %); terminated, exit code {proc.returncode} {'ok' if ok else 'FAIL'}")
        check(ok, "the daemon subprocess did not serve the request")

        with torch.inference_mode():
            times = {"artifact": [], "eager": []}
            eager = lambda: deploy_forward(deploy, xb, num_heads=HEADS)  # noqa: E731
            for name in ("artifact", "eager"):
                times[name].append(cuda_ms(eager if name == "eager" else
                                           (lambda: fns["card"](xb)), iters=5, warmup=2))
        print(f"phase 19: B={BATCH} bf16 {IMG}^2: the artifact (plain NAT, 'xla' ReparamConv) "
              f"{' / '.join(f'{t:.3f}' for t in times['artifact'])} ms, eager deploy_forward at "
              f"its default backends (B1 NAT) {' / '.join(f'{t:.3f}' for t in times['eager'])} ms "
              f"(turns artifact, eager) [{card_line}]")

        served = {"artifact": drive_daemon(fns["card"], pool, dev, "artifact", card_line)}
        closure = lambda x: deploy_forward(deploy, x, num_heads=HEADS)  # noqa: E731
        served["closure"] = drive_daemon(closure, pool, dev, "deploy_forward closure", card_line)
        # the artifact runs the plain NAT; the closure B1, four times a batch
        got = {k: v["b1_launches"] for k, v in served.items()}
        want = {"artifact": 0, "closure": 4 * served["closure"]["batches"]}
        print(f"phase 19: nat_fwd launches while serving {json.dumps(got)} (want "
              f"{json.dumps(want)})")
        check(got == want, f"the daemon launched B1 {got} times, want {want}")
    served["ms"] = times
    return served


# phase 20: the data-parallel path (lmnet_tpu_torch/parallel/)
DDP_KERNELS = ("nat_fwd", "nat_bwd", "rc_dw_gelu", "rc_stats")
BN_COUNTERS = ("bn_train", "bn_train_bwd")  # batch_norm_train, batch_norm_train_backward
DDP_SEED = 8  # the seeded weights of phase 20's steps
DDP_EVAL_IMAGES = 9  # batches of 4, 4, 1: the tail leaves rank 1 none


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _steps_ms(fn, n: int, dev) -> float:
    """ms a call of ``fn`` over ``n`` calls after one: CUDA events on the
    card (the host clock where phase 20 is rehearsed on the CPU)."""
    fn()
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _kernel_counters():
    """The launch counters of B1, B2, B5, B6 (phase 20's kernels), B4, B7
    and the train-mode BatchNorm's forward and backward (``BN_COUNTERS``)."""
    from lmnet_tpu_torch.ops.bn_train import batch_norm_train, batch_norm_train_backward
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat
    from lmnet_tpu_torch.ops.rc_kernel import fused_reparam_conv
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats
    from lmnet_tpu_torch.ops.upsample_flat import upsample2x_flat

    return dict(zip(DDP_KERNELS + ("rc_fused", "upsample_flat") + BN_COUNTERS,
                    (nat_flat, nat_flat_bwd, dw_gelu_flat, rc_branch_stats, fused_reparam_conv,
                     upsample2x_flat, batch_norm_train, batch_norm_train_backward)))


def _bn_launches(counts: dict) -> int:
    """The BatchNorm kernels' forwards and backwards in ``_read_counters``'s
    ``counts``."""
    return sum(counts[k] for k in BN_COUNTERS)


# the BatchNorm kernels' launches that _zero_counters dropped in this process
_BN_DROPPED = [0]


def _zero_counters() -> None:
    for k, fn in _kernel_counters().items():
        if k in BN_COUNTERS:
            _BN_DROPPED[0] += fn.launches
        fn.launches = 0


def _bn_total() -> int:
    """The BatchNorm kernels' launches in this process since it started."""
    return _BN_DROPPED[0] + _bn_launches(_read_counters())


def _ln_total() -> int:
    """The LayerNorm kernels' forwards and backwards in this process since
    it started."""
    from lmnet_tpu_torch.ops.layer_norm import layer_norm, layer_norm_backward

    return layer_norm.launches + layer_norm_backward.launches


def _read_counters() -> dict:
    return {k: fn.launches for k, fn in _kernel_counters().items()}


def _ddp_model(dev, dtype):
    """Phase 20's model: full width, seeded, rc_remat=True, 'flat' NAT (B1,
    B2) and rc_train_backend='fused' (B5, B6)."""
    return _train_model(dev, dtype, "flat", "fused", seed=DDP_SEED)


def _ddp_step(model, x, y, mesh=None, spatial=False):
    """One train_step (dropout on, the generator seeded alike everywhere):
    (loss, {name: grad}, state dict after the step, the step's confusion
    matrix, summed over the ranks under a mesh), on the CPU. Under a mesh
    ``x`` is this rank's node's batch (on one node the global batch).
    ``spatial``: each rank's block of H too (the mesh's 'spatial' axis)."""
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.parallel.dist_utils import host_count
    from lmnet_tpu_torch.parallel.mesh import h_rows, node_rows, replicate, sum_group
    from lmnet_tpu_torch.train import create_train_state, train_step

    state = create_train_state(model, tuple(x.shape), seed=9, device=x.device)
    cm = ConfusionAccumulator.init(2, x.device)
    if mesh is None:
        state, loss, cm = train_step(state, x, y, cm)
    else:
        replicate(mesh, state)
        rows = node_rows(mesh, len(x))
        hs = h_rows(mesh, x.shape[1]) if spatial else slice(None)
        state, loss, cm = train_step(state, x[rows][:, hs], y[rows][:, hs], cm, mesh=mesh,
                                     global_rows=len(x) * host_count(), spatial=spatial)
        torch.distributed.all_reduce(cm, group=sum_group(mesh, spatial))
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return (float(loss), grads, {k: v.detach().cpu() for k, v in model.state_dict().items()},
            cm.cpu())


def _ddp_eval_set():
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader

    return make_loader(SyntheticDataset(DDP_EVAL_IMAGES, IMG, "val", seed=12), 4)


def _ddp_evals(dev, mesh=None):
    """evaluate at float32 and serving_evaluate (bf16, B1) of the seeded
    float32 model over the eval set: (loss, metrics) for each."""
    from lmnet_tpu_torch.serve import serving_evaluate
    from lmnet_tpu_torch.train import create_train_state, evaluate

    state = create_train_state(_ddp_model(dev, torch.float32), (4, IMG, IMG, 3), seed=0,
                               device=dev)
    ev = evaluate(state, _ddp_eval_set(), img_size=IMG, mesh=mesh)
    sv = serving_evaluate(state.model.state_dict(), _ddp_eval_set(), 2, IMG, device=dev,
                          mesh=mesh)
    return ev, sv


def ddp_rank_main(out_dir, device_type: str = "cuda") -> int:
    """One rank of phase 20(c), under torchrun: two ranks share the one card
    over gloo (NCCL refuses two ranks on one device). Runs the 2-rank steps,
    evaluate and serving_evaluate, times the bf16 step, and saves what it
    got, its own kernel launches and its all-reduces to
    ``out_dir/rank{r}.pt``."""
    import os
    from pathlib import Path

    from lmnet_tpu_torch.parallel import batch as pbatch
    from lmnet_tpu_torch.parallel import dist_utils
    from lmnet_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.train import create_train_state, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist_utils.init_distributed_mode(device_type, backend="gloo")
    rank = dist_utils.get_rank()
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    mesh = make_mesh(device_type=device_type)
    got = {"rank": rank, "world": dist_utils.get_world_size(),
           "backend": torch.distributed.get_backend(), "device": str(dev)}
    _zero_counters()
    x, y = _batch(BATCH, IMG, "val", 4, dev)
    before = dict(pbatch.COUNTS)
    got["bf16"] = _ddp_step(_ddp_model(dev, torch.bfloat16), x, y, mesh)
    _sync(dev)
    got["collectives"] = {k: pbatch.COUNTS[k] - before[k] for k in before}
    got["step_launches"] = _read_counters()
    x32, y32 = _batch(4, 64, "val", 3, dev)
    got["fp32"] = _ddp_step(_ddp_model(dev, torch.float32), x32, y32, mesh)
    got["evals"] = _ddp_evals(dev, mesh)
    _sync(dev)
    got["launches"] = _read_counters()

    # ms a step: 3 steps after a warm-up, CUDA events, once the runs beside
    # this one have ended
    state = create_train_state(_ddp_model(dev, torch.bfloat16), (BATCH, IMG, IMG, 3), seed=0,
                               device=dev)
    _wait_quiet(out_dir)
    rows = shard_rows(mesh, BATCH)
    cm = ConfusionAccumulator.init(2, dev)
    times = [_steps_ms(lambda: train_step(state, x[rows], y[rows], cm, mesh=mesh,
                                          global_rows=BATCH), 3, dev)]
    got["ms"] = times
    print(f"phase 20: rank {rank}| {got['backend']} on {dev}, kernels launched "
          f"{json.dumps(got['launches'])}, all-reduces in the bf16 step "
          f"{json.dumps(got['collectives'])}, ms a step {times}", flush=True)
    torch.save(got, Path(out_dir) / f"rank{rank}.pt")
    dist_utils.cleanup()
    return 0


def cli_rank_main(argv) -> int:
    """Phase 20(b)'s child, under torchrun: the CLI's main with ``argv``,
    then this rank's B1 and B2 launches as one line."""
    from lmnet_tpu_torch.cli import train as cli
    from lmnet_tpu_torch.parallel import dist_utils

    _zero_counters()
    cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    print("LAUNCHES " + json.dumps({"rank": dist_utils.get_rank(), **_read_counters()}),
          flush=True)
    return 0


def _torchrun_start(nproc: int, args, rendezvous=("--standalone",)) -> subprocess.Popen:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc chip_smoke.py args`` (or another ``rendezvous``), started."""
    cmd = [sys.executable, "-m", "torch.distributed.run", *rendezvous,
           "--nproc_per_node", str(nproc), __file__, *args]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _torchrun_end(proc, args, timeout: int = 600, phase: int = 20) -> str:
    """The output of ``_torchrun_start``'s run, each line printed; raises if
    it fails."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        stop_process(proc)
    for line in out.splitlines():
        print(f"phase {phase}: torchrun| {line}")
    check(proc.returncode == 0, f"torchrun {' '.join(args[:1])} exited {proc.returncode}: "
                                f"{err[-3000:]}")
    return out


def _wait_quiet(out_dir, timeout: float = 300.0) -> None:
    """Wait for the parent's ``quiet`` file in ``out_dir``: every other run
    it started beside this one has ended, so the card and host are this
    run's to time."""
    from pathlib import Path

    deadline = time.time() + timeout
    while not (Path(out_dir) / "quiet").exists() and time.time() < deadline:
        time.sleep(0.2)


def _bf16_rule(label, got, one, ref, phase: int = 20) -> float:
    """The bf16 rule of "a kernel on the train step" (PERF.md section 2):
    the 2-rank step ``got`` and the one-process step ``one``, each (loss,
    gradients, running statistics, confusion matrix), held to the float32
    one-process step ``ref``. The loss no further from ref's than 2 x one's
    distance + 1e-4 |ref|; each block of gradients (``_grad_blocks``) and
    each BatchNorm's running statistics no further than 2 x one's distance
    + 1e-3 ||ref||; the confusion matrix's distance (half its L1) no more
    than 2 x one's + 1e-4 of the pixels. Returns the worst ratio (tol 1)."""
    (lg, gg, sg, cg), (lo, go, so, co), (lr, gr, sr, cr) = got, one, ref

    def dist(a, b, names):
        return sum((a[n].float() - b[n].float()).square().sum().item() for n in names) ** 0.5

    ratios = {"loss": abs(lg - lr) / (2 * abs(lo - lr) + 1e-4 * abs(lr))}
    for kind, g, o, r, blocks in (("gradients", gg, go, gr, _grad_blocks(gr)),
                                  ("running statistics", sg, so, sr, _stat_blocks(sr))):
        for b, names in blocks.items():
            norm = sum(r[n].float().square().sum().item() for n in names) ** 0.5
            ratios[f"{kind} {b}"] = dist(g, r, names) / (2 * dist(o, r, names) + 1e-3 * norm)
    ratios["confusion matrix"] = float((cg - cr).abs().sum()) / (
        2 * float((co - cr).abs().sum()) + 2e-4 * float(cr.sum()))
    worst = max(ratios, key=ratios.get)
    ok = all(np.isfinite(v) and v <= 1.0 for v in ratios.values())
    print(f"phase {phase}: {label}: loss 2 ranks {lg:.6f}, one process {lo:.6f}, fp32 {lr:.6f}; "
          f"{len(ratios)} checks (the loss, {len(_grad_blocks(gr))} gradient blocks, "
          f"{len(_stat_blocks(sr))} BatchNorms' running statistics, the confusion matrix): "
          f"worst |2 ranks - fp32| / (2 |one - fp32| + slack) = {ratios[worst]:.3e} at {worst} "
          f"(tol 1) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the 2-rank step is further from float32 than one process")
    return ratios[worst]


def _stat_blocks(sd) -> dict:
    """The running statistics grouped by BatchNorm."""
    blocks = {}
    for n in sd:
        if n.endswith(("running_mean", "running_var")):
            blocks.setdefault(n.rsplit(".", 1)[0], []).append(n)
    return blocks


def phase_ddp(dev, card_line) -> dict:
    """Phase 20; returns the kernel launches of the 2-rank run (each rank's
    and their sum) and of the NCCL CLI run."""
    import csv
    import tempfile
    from pathlib import Path

    from lmnet_tpu_torch import losses as L
    from lmnet_tpu_torch import metrics as M
    from lmnet_tpu_torch.metrics import functional as MF

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # (a) the losses and metrics on the card against the same call on the
    # CPU: float32, losses rtol 1e-5, counts exact
    g = torch.Generator().manual_seed(20)
    logits = torch.randn(4, 32, 32, 2, generator=g) * 3
    labels = torch.randint(0, 2, (4, 32, 32), generator=g)
    ign = labels.clone()
    ign[torch.rand(ign.shape, generator=g) < 0.1] = 255
    multi = (torch.rand(4, 32, 32, 2, generator=g) < 0.4).float()
    alpha = torch.rand(4, 32, 32, 1, generator=g)
    probs = torch.softmax(logits, -1)
    onehot = torch.nn.functional.one_hot(labels, 2).float()
    valid = (torch.rand(4, 32, 32, generator=g) < 0.9).int()
    flat_logits, flat_labels = logits.reshape(-1, 2)[:512], labels.reshape(-1)[:512]
    cases = {
        "cross_entropy_loss": (L.cross_entropy_loss, (logits, labels, (1.0, 4.0), 0.001)),
        "dice_loss": (L.dice_loss, (logits, labels, (1.0, 4.0))),
        "segmentation_loss": (L.segmentation_loss, (logits, labels)),
        "bce_dice_loss": (L.bce_dice_loss, (logits, labels)),
        "focal_loss": (L.focal_loss, (logits, multi, alpha)),
        "sigmoid_focal_loss": (L.sigmoid_focal_loss, (logits[..., 1], multi[..., 1])),
        "focal_loss_per_class": (L.focal_loss_per_class, (logits, labels)),
        "class_balanced_loss": (L.class_balanced_loss, (flat_logits, flat_labels, (90, 10))),
        "mmseg_binary_dice_loss": (L.mmseg_binary_dice_loss,
                                   (probs[..., 1], onehot[..., 1], valid)),
        "mmseg_dice_loss": (L.mmseg_dice_loss, (probs, onehot, valid)),
        "official_dice_loss": (L.official_dice_loss, (logits, ign)),
    }
    worst = 0.0
    for name, (fn, args) in cases.items():
        want = fn(*args)
        have = fn(*[a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]).cpu()
        err = float(((have - want).abs() / want.abs().clamp(min=1e-30)).max())
        worst = max(worst, err)
        check(err <= 1e-5, f"{name} on the card differs from the CPU by rel {err:.3e}")
    w_dev = L.effective_number_weights((90, 10), device=dev).cpu()
    check(torch.equal(w_dev, L.effective_number_weights((90, 10))), "effective_number_weights")
    pred = logits.argmax(-1)
    counts_ok = (torch.equal(M.confusion_matrix(pred.to(dev), labels.to(dev), 2).cpu(),
                             M.confusion_matrix(pred, labels, 2))
                 and torch.equal(M.binary_iou(probs[..., 1].to(dev), labels.to(dev)).cpu(),
                                 M.binary_iou(probs[..., 1], labels))
                 and torch.equal(M.binary_dice(probs[..., 1].to(dev), labels.to(dev)).cpu(),
                                 M.binary_dice(probs[..., 1], labels)))
    stats = MF.get_stats(pred.numpy(), labels.numpy(), "multiclass", num_classes=2)
    dm_dev = M.derived_metrics(M.confusion_matrix(pred.to(dev), labels.to(dev), 2))
    dm_cpu = M.derived_metrics(M.confusion_matrix(pred, labels, 2))
    counts_ok = counts_ok and all(float(dm_dev[k]) == float(dm_cpu[k]) for k in dm_cpu)
    print(f"phase 20: (a) {len(cases) + 1} losses on the card against the CPU: worst rel "
          f"{worst:.3e} (tol 1e-5); confusion matrix, binary_iou, binary_dice, derived_metrics "
          f"equal {counts_ok}; functional iou {MF.iou_score(*stats, reduction='micro'):.6f} "
          f"{'ok' if counts_ok else 'FAIL'}")
    check(counts_ok, "a count or metric on the card differs from the CPU")

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_", dir=build) as tmp:
        tmp = Path(tmp)

        # (b) the CLI with --distributed True under torchrun, one rank on
        # NCCL, against the same command without --distributed (in this
        # process) and the float32 command (no --apm) by the bf16 rule
        def argv(name, apm=True):
            return (["--synthetic", "--k_fold", "False", "--img_size", str(IMG),
                     "--batch_size", str(CLI_BATCH), "--epochs", "1", "--seed", "0",
                     "--ckpt_dir", str(tmp / name / "ckpt"), "--out_dir", str(tmp / name / "out"),
                     "--device", dev.type] + (["--apm"] if apm else []))

        # (c)'s one process is timed first; then (b) and (c)'s two ranks
        # start together (each is mostly its processes' start), and the
        # ranks time their steps once (b) and this process are done
        from lmnet_tpu_torch.metrics import ConfusionAccumulator
        from lmnet_tpu_torch.train import create_train_state, train_step

        x, y = _batch(BATCH, IMG, "val", 4, dev)
        state = create_train_state(_ddp_model(dev, torch.bfloat16), (BATCH, IMG, IMG, 3), seed=0,
                                   device=dev)
        cm = ConfusionAccumulator.init(2, dev)
        one_ms = [_steps_ms(lambda: train_step(state, x, y, cm), 3, dev)]
        del state
        t0 = time.perf_counter()
        nccl_args = ["--cli-rank", *argv("nccl"), "--distributed", "True"]
        nccl, gloo = _torchrun_start(1, nccl_args), _torchrun_start(2, ["--ddp-rank", str(tmp),
                                                                        dev.type])
        try:
            for name, apm in (("one", True), ("fp32", False)):
                run_cli(argv(name, apm), phase=20)
            said = _torchrun_end(nccl, nccl_args)
            t_nccl = time.perf_counter() - t0
            (tmp / "quiet").touch()
            _torchrun_end(gloo, ["--ddp-rank"])
            t_gloo = time.perf_counter() - t0
        finally:
            for p in (nccl, gloo):
                stop_process(p)
        cli_launch = json.loads(next(line for line in said.splitlines()
                                     if line.startswith("LAUNCHES "))[len("LAUNCHES "):])
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
        rows = {n: [[float(v) for v in r]
                    for r in _csv_rows(tmp / n / "out" / "LM_NetKvasir_0.csv")]
                for n in ("nccl", "one", "fp32")}
        files = sorted(p.name for p in (tmp / "nccl" / "out").iterdir())
        ckpts = sorted(p.name for p in (tmp / "nccl" / "ckpt").iterdir())
        ok = (files == ["LM_NetKvasir_0.csv", "LM_NetKvasirbestresult_0.csv"]
              and ckpts == ["LM_NetKvasir_0_checkpoint", "LM_NetKvasirbest_0"]
              and all(len(r) == 1 and len(r[0]) == 16 for r in rows.values())
              and cli_launch["nat_fwd"] == 8 and cli_launch["nat_bwd"] == 4)
        d, o, f = (np.array(rows[n][0]) for n in ("nccl", "one", "fp32"))
        # the losses (columns 0 and 8) by the bf16 rule, + 1e-4 for the CSV's
        # 4 decimals; the metrics within 0.02 of the run without --distributed
        loss_ok = all(abs(d[i] - f[i]) <= 2 * abs(o[i] - f[i]) + 1e-4 * abs(f[i]) + 1e-4
                      for i in (0, 8))
        metric_ok = bool(np.all(np.abs(np.delete(d - o, [0, 8])) <= 0.02))
        ok = ok and loss_ok and metric_ok
        print(f"phase 20: (b) torchrun --nproc_per_node 1 cli --distributed True (NCCL) "
              f"ended {t_nccl:.1f}s after its start: files {files}, checkpoints {ckpts}, "
              f"B1 {cli_launch['nat_fwd']} "
              f"B2 {cli_launch['nat_bwd']} launches (want 8, 4); CSV row {d.tolist()} against "
              f"one process {o.tolist()} and fp32 {f.tolist()}: losses by the bf16 rule "
              f"{loss_ok}, metrics within 0.02 {metric_ok} {'ok' if ok else 'FAIL'}")
        check(ok, "the NCCL --distributed CLI run disagrees with one process")

    # (c) two ranks on the one card over gloo: the 2-rank steps, evaluate and
    # serving_evaluate against one process on the same inputs

    check([r["backend"] for r in ranks] == ["gloo", "gloo"]
          and [r["world"] for r in ranks] == [2, 2], "the ranks are not a gloo group of two")
    for r in ranks:
        check(all(r["launches"][k] > 0 for k in DDP_KERNELS),
              f"rank {r['rank']} launched {r['launches']}: every kernel of the path must run")
        check({k: r["step_launches"][k] for k in DDP_KERNELS}
              == {"nat_fwd": 4, "nat_bwd": 4, "rc_dw_gelu": 32, "rc_stats": 32},
              f"rank {r['rank']}'s bf16 step launched {r['step_launches']}")
    # bf16 256^2, B=16 (8 a rank): against one process by the bf16 rule
    one_bf16 = _ddp_step(_ddp_model(dev, torch.bfloat16), x, y)
    ref = _ddp_model(dev, torch.float32)
    ref.load_state_dict(_ddp_model(dev, torch.bfloat16).state_dict())
    fp32 = _ddp_step(ref, x, y)
    del ref

    got = ranks[0]["bf16"]

    def stats_only(step):
        return step[0], step[1], {k: v for k, v in step[2].items() if "running" in k}, step[3]

    refs = {"bf16": stats_only(one_bf16), "fp32": stats_only(fp32), "two_ranks": got,
            "one_ms": one_ms}
    b16 = _bf16_rule(f"(c) bf16 {IMG}^2 B={BATCH} step, 2 ranks x {BATCH // 2} against one "
                     "process", stats_only(got), refs["bf16"], refs["fp32"])
    del one_bf16, fp32
    same = all(torch.equal(ranks[0][k][2][n], ranks[1][k][2][n])
               for k in ("bf16", "fp32") for n in ranks[0][k][2])
    print(f"phase 20: (c) both ranks' parameters and running statistics bitwise equal after "
          f"the bf16 and fp32 steps: {same} {'ok' if same else 'FAIL'}")
    check(same, "the ranks' parameters differ after the step")

    # fp32 64^2, B=4 (2 a rank): loss rel 1e-5, each gradient ||d|| <= 1e-3
    # ||ref|| + 1e-5 max||g||, running statistics rtol 1e-4 / atol 1e-5 max
    x32, y32 = _batch(4, 64, "val", 3, dev)
    lo, go, so, co = refs["fp32_64"] = _ddp_step(_ddp_model(dev, torch.float32), x32, y32)
    lg, gg, sg, cg = ranks[0]["fp32"]
    big = max(v.norm().item() for v in go.values())
    worst_g = max((gg[k] - go[k]).norm().item() / (1e-3 * go[k].norm().item() + 1e-5 * big)
                  for k in go)
    worst_s = max(float(((sg[k] - so[k]).abs()
                         / (1e-4 * so[k].abs() + 1e-5 * so[k].abs().max().item())).max())
                  for k in so if "running" in k)
    ok = (abs(lg - lo) <= 1e-5 * abs(lo) and worst_g <= 1.0 and worst_s <= 1.0
          and torch.equal(cg, co))
    print(f"phase 20: (c) fp32 64^2 B=4 step, 2 ranks x 2 against one process: loss {lg:.7f} "
          f"vs {lo:.7f} (tol rel 1e-5); {len(go)} gradients worst ||2r-1p|| / (1e-3 ||1p|| + "
          f"1e-5 max||g||) = {worst_g:.3e}; running statistics worst {worst_s:.3e} (tol 1); "
          f"confusion matrix equal {torch.equal(cg, co)} {'ok' if ok else 'FAIL'}")
    check(ok, "the fp32 2-rank step disagrees with one process")

    # evaluate (fp32) and serving_evaluate (bf16, B1 on each rank)
    (el, em), (sl, sm) = _ddp_evals(dev)
    (gel, gem), (gsl, gsm) = ranks[0]["evals"]
    pixels = DDP_EVAL_IMAGES * IMG * IMG
    ev_flips = abs(gem["accuracy"] - em["accuracy"]) * pixels
    sv_flips = abs(gsm["accuracy"] - sm["accuracy"]) * pixels
    ok = (ranks[0]["evals"] == ranks[1]["evals"] and abs(gel - el) <= 1e-5 * abs(el)
          and ev_flips <= 1e-4 * pixels and abs(gsl - sl) <= 0.02 * abs(sl)
          and sv_flips <= 0.025 * pixels
          and all(abs(gsm[k] - sm[k]) <= 0.02 for k in sm))
    print(f"phase 20: (c) evaluate fp32 over {DDP_EVAL_IMAGES} images (batches 4, 4, 1): 2 ranks "
          f"loss {gel:.6f} vs {el:.6f} (tol rel 1e-5), metrics equal {gem == em}, accuracy "
          f"moved by {ev_flips:.0f} pixels (tol 1e-4 of {pixels}); serving_evaluate bf16: loss "
          f"{gsl:.6f} vs {sl:.6f} (tol 2 %), metrics equal {gsm == sm}, {sv_flips:.0f} pixels "
          f"(tol 2.5 %) {'ok' if ok else 'FAIL'}")
    check(ok, "the 2-rank evaluate or serving_evaluate disagrees with one process")

    coll = ranks[0]["collectives"]
    two_ms = [r["ms"] for r in ranks]
    print(f"phase 20: (c) train_step bf16 {IMG}^2 B={BATCH} 'flat' + 'fused', rc_remat: one "
          f"process {' / '.join(f'{t:.1f}' for t in one_ms)} ms (before the 2-rank run), "
          f"2 ranks x {BATCH // 2} on one card over gloo {two_ms} ms a step (one turn each rank; "
          f"gloo "
          f"copies every all-reduce through the host: not NCCL's time) [{card_line}]; "
          f"all-reduces a step: {coll['forward']} in forwards, {coll['backward']} in backwards, "
          f"{coll['grads']} of the gradients; torchrun 2 ranks {t_gloo:.1f}s")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in DDP_KERNELS}
    print(f"phase 20: data-parallel path: kernel launches {json.dumps(launches)} "
          f"(rank 0 {json.dumps(ranks[0]['launches'])}, "
          f"rank 1 {json.dumps(ranks[1]['launches'])}), "
          f"the NCCL CLI run {json.dumps({k: cli_launch[k] for k in DDP_KERNELS})}; "
          f"phase 20 {time.perf_counter() - t_phase:.1f}s")
    return {"ddp": launches, "ddp_cli": {k: cli_launch[k] for k in DDP_KERNELS},
            "bn": {"ddp": sum(_bn_launches(r["launches"]) for r in ranks),
                   "ddp_cli": _bn_launches(cli_launch)},
            "one_ms": one_ms, "two_ms": two_ms, "collectives": coll, "bf16_worst": b16,
            "refs": refs}


# phase 21: the mesh's 'spatial' axis (lmnet_tpu_torch/parallel/spatial.py)
SPATIAL_IMG = 512  # JAX's CLI turns the axis on at --img_size >= 512
SPATIAL_BATCH = 4
SPATIAL_SEED = 21  # the seeded weights of phase 21's steps
SPATIAL_EVAL_IMAGES = 5  # batches of 2, 2, 1
# (H, W, C) of the NAT slabs each rank of the (1 x 2) mesh gives B1 and B2 at
# 512^2: its 256 / 128 / 64 / 32 rows and one row of its neighbour; W.C = 6144
SPATIAL_SLABS = [(257, 512, 12), (129, 256, 24), (65, 128, 48), (33, 64, 96)]
# (h, W, Cin, E, Cout) of the 16 ReparamConv blocks' five shapes on a rank of
# that mesh at 512^2 (its 256 / 128 / 64 / 32 rows): B4 takes them on slabs of
# h + 2 rows (no row past the global edge), B5 and B6 on slabs of h + 4
SPATIAL_RC = [(256, 512, 3, 24, 12), (256, 512, 12, 24, 12), (128, 256, 24, 48, 24),
              (64, 128, 48, 96, 48), (32, 64, 96, 192, 96)]
# (h, W, C) of the 7 upsamples' four input shapes on a rank at 512^2: B7 takes
# them on slabs of h + 1 rows
SPATIAL_UP = [(16, 32, 192), (32, 64, 96), (64, 128, 48), (128, 256, 24)]


def _spatial_model(dev, dtype):
    """Phase 21's model: the full-width default, seeded: rc_remat=True,
    'flat' NAT (B1, B2), 'xla' ReparamConv, dropout on."""
    return _train_model(dev, dtype, "flat", "auto", seed=SPATIAL_SEED)


def _spatial_evals(dev, mesh=None):
    """evaluate (float32, HD95) and serving_evaluate (bf16, B1) of the seeded
    float32 model over SPATIAL_EVAL_IMAGES 512^2 images in batches of 2, 2,
    1: (loss, metrics) for each, H over the mesh's 'spatial' axis."""
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.serve import serving_evaluate
    from lmnet_tpu_torch.train import create_train_state, evaluate

    def loader():
        return make_loader(SyntheticDataset(SPATIAL_EVAL_IMAGES, SPATIAL_IMG, "val", seed=12), 2)

    state = create_train_state(_spatial_model(dev, torch.float32),
                               (2, SPATIAL_IMG, SPATIAL_IMG, 3), seed=0, device=dev)
    ev = evaluate(state, loader(), img_size=SPATIAL_IMG, compute_hd95=True, mesh=mesh,
                  spatial=True)
    sv = serving_evaluate(state.model.state_dict(), loader(), 2, SPATIAL_IMG, device=dev,
                          mesh=mesh, spatial=True)
    return ev, sv


def _spatial_fused_model(dev, dtype):
    """Phase 21's model with rc_train_backend='fused' (B6, B5): the same
    seeded weights as ``_spatial_model``."""
    return _train_model(dev, dtype, "flat", "fused", seed=SPATIAL_SEED)


def _spatial_serves(dev, mesh=None):
    """serving_evaluate (bf16) of the seeded float32 model over the eval set
    with rc_backend 'flat' (B5) and 'pallas' (B4), the upsample backend
    'flat' (B7), H over the mesh's 'spatial' axis: {rc: ((loss, metrics),
    the launches it made)}."""
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.ops import resize
    from lmnet_tpu_torch.serve import serving_evaluate
    from lmnet_tpu_torch.train import create_train_state

    state = create_train_state(_spatial_model(dev, torch.float32),
                               (2, SPATIAL_IMG, SPATIAL_IMG, 3), seed=0, device=dev)
    out = {}
    resize.UPSAMPLE_BACKEND = "flat"
    try:
        for rc in ("flat", "pallas"):
            _zero_counters()
            sv = serving_evaluate(state.model.state_dict(),
                                  make_loader(SyntheticDataset(SPATIAL_EVAL_IMAGES, SPATIAL_IMG,
                                                               "val", seed=12), 2),
                                  2, SPATIAL_IMG, device=dev, mesh=mesh, spatial=True,
                                  rc_backend=rc)
            _sync(dev)
            out[rc] = (sv, _read_counters())
    finally:
        resize.UPSAMPLE_BACKEND = "einsum"
    return out


def spatial_rank_main(out_dir, device_type: str = "cuda") -> int:
    """One rank of phase 21, under torchrun: two ranks share the one card over
    gloo on a (1 x 2) mesh, each holding 256 rows of every 512^2 image. Runs
    the sharded steps, evaluate and serving_evaluate, times the bf16 step,
    and saves what it got, its B1 and B2 launches and its collectives to
    ``out_dir/rank{r}.pt``."""
    from pathlib import Path

    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.parallel import batch as pbatch
    from lmnet_tpu_torch.parallel import dist_utils
    from lmnet_tpu_torch.parallel.mesh import h_rows, make_mesh
    from lmnet_tpu_torch.train import create_train_state, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist_utils.init_distributed_mode(device_type, backend="gloo")
    rank = dist_utils.get_rank()
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    mesh = make_mesh(n_spatial=2, device_type=device_type)
    got = {"rank": rank, "mesh": tuple(mesh.shape), "backend": torch.distributed.get_backend()}
    _zero_counters()
    x, y = _batch(SPATIAL_BATCH, SPATIAL_IMG, "val", 4, dev)
    before = dict(pbatch.COUNTS)
    got["bf16"] = _ddp_step(_spatial_model(dev, torch.bfloat16), x, y, mesh, spatial=True)
    _sync(dev)
    got["collectives"] = {k: pbatch.COUNTS[k] - before[k] for k in before}
    got["step_launches"] = _read_counters()
    x32, y32 = _batch(2, 64, "val", 3, dev)
    got["fp32"] = _ddp_step(_spatial_model(dev, torch.float32), x32, y32, mesh, spatial=True)
    got["evals"] = _spatial_evals(dev, mesh)
    _sync(dev)
    got["launches"] = _read_counters()

    # the row-window kernels' path: the 'fused' + 'flat' upsample steps (B6,
    # B5, B7 on the rank's slabs), then serving through B5 and through B4
    from lmnet_tpu_torch.ops import resize

    resize.UPSAMPLE_BACKEND = "flat"
    _zero_counters()
    before = dict(pbatch.COUNTS)
    got["fused_bf16"] = _ddp_step(_spatial_fused_model(dev, torch.bfloat16), x, y, mesh,
                                  spatial=True)
    _sync(dev)
    got["fused_collectives"] = {k: pbatch.COUNTS[k] - before[k] for k in before}
    got["fused_step_launches"] = _read_counters()
    got["fused_fp32"] = _ddp_step(_spatial_fused_model(dev, torch.float32), x32, y32, mesh,
                                  spatial=True)
    _sync(dev)
    resize.UPSAMPLE_BACKEND = "einsum"
    got["fused_launches"] = _read_counters()
    got["serves"] = _spatial_serves(dev, mesh)

    # ms a step: 3 steps after a warm-up, CUDA events, once the dry run
    # beside this one has ended
    state = create_train_state(_spatial_model(dev, torch.bfloat16),
                               (SPATIAL_BATCH, SPATIAL_IMG, SPATIAL_IMG, 3), seed=0, device=dev)
    _wait_quiet(out_dir)
    hs = h_rows(mesh, SPATIAL_IMG)
    xs, ys = x[:, hs].contiguous(), y[:, hs].contiguous()
    cm = ConfusionAccumulator.init(2, dev)
    got["ms"] = [_steps_ms(lambda: train_step(state, xs, ys, cm, mesh=mesh, spatial=True), 3,
                           dev)]
    print(f"phase 21: rank {rank}| {got['backend']} mesh {got['mesh']}, B1/B2 launched "
          f"{got['launches']['nat_fwd']}/{got['launches']['nat_bwd']} (bf16 step "
          f"{got['step_launches']['nat_fwd']}/{got['step_launches']['nat_bwd']}), collectives "
          f"in the bf16 step {json.dumps(got['collectives'])}, ms a step {got['ms']}; 'fused' + "
          f"flat upsample steps launched {json.dumps(got['fused_launches'])} (bf16 step "
          f"{json.dumps(got['fused_step_launches'])}, collectives "
          f"{json.dumps(got['fused_collectives'])}); serving launched "
          f"{json.dumps({rc: v[1] for rc, v in got['serves'].items()})}", flush=True)
    torch.save(got, Path(out_dir) / f"rank{rank}.pt")
    dist_utils.cleanup()
    return 0


def _spatial_slab_kernels(dev, card_line) -> dict:
    """B1 and B2 against their plain versions at the four slab shapes of a
    rank, bf16 and float32, each with its plan's variant (which must be
    'vec'); the bf16 calls timed eagerly beside their byte bounds."""
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd, nat_plan

    out = {"nat_fwd": [], "nat_bwd": []}
    for i, (H, W, C) in enumerate(SPATIAL_SLABS):
        B, hd, scale = SPATIAL_BATCH, C // HEADS, float(C // HEADS) ** -0.5
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, rpb = nat_inputs(B, H, W, C, dtype, 500 + i, dev)
            g = torch.randn(B, H, W * C, generator=torch.Generator().manual_seed(600 + i))
            g = g.to(dev, dtype)
            plans = {kind: nat_plan(B, H, W, HEADS, hd, dtype, kind)["variant"]
                     for kind in ("fwd", "bwd")}
            e_f = check_fwd(f"phase 21: [{plans['fwd']}]", nat_flat(q, k, v, rpb, HEADS, C, W),
                            q, k, v, rpb, B, H, W, C)
            e_b = check_bwd(f"phase 21: [{plans['bwd']}]",
                            nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, scale),
                            q, k, v, rpb, g, B, H, W, C, scale)
            check(set(plans.values()) == {"vec"},
                  f"B1/B2 at the slab H={H} W={W} C={C} took {plans}")
            if dtype != torch.bfloat16:
                continue
            es = q.element_size()
            for name, fn, nbytes, err in (
                    ("nat_fwd", lambda: nat_flat(q, k, v, rpb, HEADS, C, W),
                     4 * q.numel() * es, e_f),
                    ("nat_bwd", lambda: nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, scale),
                     7 * q.numel() * es, e_b)):
                ms = cuda_ms(fn, iters=10)
                out[name].append({"H": H, "W": W, "C": C, "B": B, "variant": plans[name[-3:]],
                                  "ms": ms, "bound_ms": nbytes / HBM_RATE * 1e3,
                                  "max_abs_err": err})
                print(f"phase 21: {name} slab B={B} H={H} W={W} C={C} bf16: {ms:.4f} ms eager, "
                      f"bound {nbytes / HBM_RATE * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB) "
                      f"[{card_line}]")
    return out


def _fp32_rule(label, got, one, phase: int = 21, who: str = "2 ranks x 32 rows") -> None:
    """A float32 2-rank step ``got`` against the one-process step ``one``
    (loss, gradients, state, confusion matrix): loss rel 1e-5, each gradient
    ||d|| <= 1e-3 ||ref|| + 1e-5 max||g||, running statistics rtol 1e-4 /
    atol 1e-5 max, the confusion matrix equal."""
    lo, go, so, co = one
    lg, gg, sg, cg = got
    big = max(v.norm().item() for v in go.values())
    worst_g = max((gg[k] - go[k]).norm().item() / (1e-3 * go[k].norm().item() + 1e-5 * big)
                  for k in go)
    worst_s = max(float(((sg[k] - so[k]).abs()
                         / (1e-4 * so[k].abs() + 1e-5 * so[k].abs().max().item())).max())
                  for k in so if "running" in k)
    ok = (abs(lg - lo) <= 1e-5 * abs(lo) and worst_g <= 1.0 and worst_s <= 1.0
          and torch.equal(cg, co))
    print(f"phase {phase}: {label}, {who} against one process: loss {lg:.7f} vs "
          f"{lo:.7f} (tol rel 1e-5); {len(go)} gradients worst ||2r-1p|| / (1e-3 ||1p|| + "
          f"1e-5 max||g||) = {worst_g:.3e}; running statistics worst {worst_s:.3e} (tol 1); "
          f"confusion matrix equal {torch.equal(cg, co)} {'ok' if ok else 'FAIL'}")
    check(ok, f"the {label} on {who} disagrees with one process")


def _serving_rule(label, got, one) -> None:
    """The 2-rank serving_evaluate (loss, metrics) against one process's, by
    the serving rule: loss within 2 %, argmax moved on at most 2.5 % of the
    pixels, every metric within 0.02."""
    (gsl, gsm), (sl, sm) = got, one
    pixels = SPATIAL_EVAL_IMAGES * SPATIAL_IMG * SPATIAL_IMG
    flips = abs(gsm["accuracy"] - sm["accuracy"]) * pixels
    ok = (abs(gsl - sl) <= 0.02 * abs(sl) and flips <= 0.025 * pixels
          and all(abs(gsm[k] - sm[k]) <= 0.02 for k in sm))
    print(f"phase 21: {label}: 2 ranks loss {gsl:.6f} vs one process {sl:.6f} (tol 2 %), "
          f"{flips:.0f} pixels moved (tol 2.5 % of {pixels}) {'ok' if ok else 'FAIL'}")
    check(ok, f"the sharded {label} disagrees with one process")


def _rank_slab(x, rank, size, halo, edges):
    """Rank ``rank`` of ``size``'s slab of the whole map x (rows on axis 1)
    as its exchange makes it: ``halo`` rows of each neighbour, zero rows
    past the global edges with ``edges``, else none. Returns (slab, top,
    rows, row0)."""
    h = x.shape[1] // size
    lo, hi = rank * h - halo, (rank + 1) * h + halo
    part = x[:, max(lo, 0):min(hi, x.shape[1])]
    if edges:
        part = torch.cat([x.new_zeros((x.shape[0], max(-lo, 0), *x.shape[2:])), part,
                          x.new_zeros((x.shape[0], max(hi - x.shape[1], 0), *x.shape[2:]))],
                         dim=1)
        return part, halo, h, rank * h
    return part.contiguous(), rank * h - max(lo, 0), h, rank * h


def _rows_vs_whole(label, got, want) -> float:
    """A rank's output rows of a row-window kernel against the same kernel's
    rows on the whole map: float32 within 1e-6 max|ref|, bf16 within one
    rounding of the stored value (2^-8 |ref| + 1e-6 max|ref|). Prints one
    line; raises on a mismatch. Returns the max abs error."""
    big = want.float().abs().max().item()
    err = (got.float() - want.float()).abs()
    bound = (1e-6 * big if want.dtype == torch.float32
             else 2**-8 * want.float().abs() + 1e-6 * big)
    ok = got.shape == want.shape and bool((err <= bound).all())
    print(f"{label}: rows against the whole map's kernel: max_abs_err={err.max().item():.3e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the slab's rows disagree with the whole map's")
    return err.max().item()


def _sums_vs_whole(label, got, want, scale) -> float:
    """The ranks' sums added against the whole map's kernel: within 1e-5
    scale + 1e-6 (scale: the sum of |t|, or the largest statistic)."""
    err = (got - want).abs()
    ok = bool((err <= 1e-5 * scale + 1e-6).all())
    print(f"{label}: the 2 ranks' sums added against the whole map's kernel: "
          f"max_abs_err={err.max().item():.3e} (tol 1e-5 scale + 1e-6) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the ranks' sums do not add up to the whole map's")
    return err.max().item()


def _spatial_window_kernels(dev, card_line) -> dict:
    """B4, B5, B6 and B7 on each rank's slab of the (1 x 2) mesh at 512^2
    (B=4): the ReparamConv blocks' five shapes (SPATIAL_RC) and the
    upsamples' four (SPATIAL_UP), bf16 and float32. Each slab call against
    the plain version on the same slab (``check_dw``, ``check_stats``,
    ``check_rc`` (its SE the slab's own), ``check_up``); each rank's output
    rows against the same kernel on the whole map (B4's phase 2 with the
    whole map's SE scale) and the two ranks' sums added against the whole
    map's; rank 0's bf16 slab calls timed (CUDA events) beside their byte
    bounds. Returns {kernel: [slab entries]}."""
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat, se_scale
    from lmnet_tpu_torch.ops.rc_kernel import rc_phase1, rc_phase2
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats
    from lmnet_tpu_torch.ops.upsample_flat import _launch

    B = SPATIAL_BATCH
    out = {"rc_fused": [], "rc_dw_gelu": [], "rc_stats": [], "upsample_flat": []}
    for i, (h, W, Cin, E, Cout) in enumerate(SPATIAL_RC):
        H = 2 * h
        w = rc_weights(2100 + i, Cin, E, Cout, dev)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator().manual_seed(2110 + i)
            e = torch.randn(B, H, W * E, generator=g).to(dev, dtype)
            k = (torch.randn(E, 1, 5, 5, generator=g) * 0.2).to(dev)
            b = (torch.randn(E, generator=g) * 0.1).to(dev)
            ks = [(torch.randn(E, 1, kh, kw, generator=g) * 0.3).to(dev)
                  for kh, kw in ((5, 5), (3, 3), (3, 1), (1, 3))]
            x = torch.randn(B, H, W, Cin, generator=g).to(dev, dtype)
            t, sums = dw_gelu_flat(e, k, b, E)
            stats = rc_branch_stats(e, *ks, E)
            s1 = rc_phase1(x, w)
            sc = se_scale(s1, w, H * W)
            y = rc_phase2(x, w, sc)
            errs = {"rc_dw_gelu": 0.0, "rc_stats": 0.0, "rc_fused": 0.0}
            got_sums = got_stats = got_s1 = 0
            for r in range(2):
                lab = f"phase 21: rank {r} slab"
                es, top, rows, _ = _rank_slab(e, r, 2, 2, edges=True)
                t_r, s_r = dw_gelu_flat(es, k, b, E, top, rows)
                errs["rc_dw_gelu"] = max(errs["rc_dw_gelu"],
                                         check_dw(lab, es, k, b, t_r, s_r, E, top, rows),
                                         _rows_vs_whole(f"{lab} rc_dw_gelu", t_r,
                                                        t[:, r * h:(r + 1) * h]))
                st_r = rc_branch_stats(es, *ks, E, top, rows)
                errs["rc_stats"] = max(errs["rc_stats"],
                                       check_stats(lab, es, ks, st_r, E, top, rows))
                got_sums, got_stats = got_sums + s_r, got_stats + st_r
                xs, xtop, _, _ = _rank_slab(x, r, 2, 2, edges=False)
                p1 = rc_phase1(xs, w, xtop, rows)
                got_s1 = got_s1 + p1
                own = rc_phase2(xs, w, se_scale(p1, w, rows * W).contiguous(), xtop, rows)
                errs["rc_fused"] = max(errs["rc_fused"], check_rc(lab, xs, w, own, xtop, rows),
                                       _rows_vs_whole(f"{lab} rc_fused",
                                                      rc_phase2(xs, w, sc, xtop, rows),
                                                      y[:, r * h:(r + 1) * h]))
                if r == 0 and dtype == torch.bfloat16:
                    es0, xs0, top0, xtop0 = es, xs, top, xtop
            shape = f"B={B} h={h} W={W} E={E}"
            _sums_vs_whole(f"phase 21: rc_dw_gelu {shape} {_dt(dtype)}", got_sums, sums,
                           t.float().abs().reshape(B, H * W, E).sum(1))
            _sums_vs_whole(f"phase 21: rc_stats {shape} {_dt(dtype)}", got_stats, stats,
                           stats.abs().amax(-1, keepdim=True))
            _sums_vs_whole(f"phase 21: rc_fused phase 1 {shape} {_dt(dtype)}", got_s1, s1,
                           s1.abs().amax(-1, keepdim=True))
            if dtype != torch.bfloat16:
                continue
            es_b = 2
            for name, fn, nbytes in (
                    ("rc_dw_gelu", lambda: dw_gelu_flat(es0, k, b, E, top0, h),
                     es_b * B * W * E * (es0.shape[1] + h)),
                    ("rc_stats", lambda: rc_branch_stats(es0, *ks, E, top0, h),
                     es_b * B * W * E * es0.shape[1]),
                    ("rc_fused", lambda: rc_phase2(xs0, w, se_scale(
                        rc_phase1(xs0, w, xtop0, h), w, h * W).contiguous(), xtop0, h),
                     es_b * B * W * (Cin * xs0.shape[1] + Cout * h))):
                ms = cuda_ms(fn, iters=10)
                slab_rows = es0.shape[1] if name != "rc_fused" else xs0.shape[1]
                out[name].append({"h": h, "slab_rows": slab_rows, "W": W, "Cin": Cin, "E": E,
                                  "Cout": Cout, "B": B, "ms": ms,
                                  "bound_ms": nbytes / HBM_RATE * 1e3,
                                  "max_abs_err": errs[name]})
                print(f"phase 21: {name} rank 0 slab B={B} rows {slab_rows} -> {h} W={W} "
                      f"Cin={Cin} E={E} bf16: {ms:.4f} ms eager, byte bound "
                      f"{nbytes / HBM_RATE * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB) [{card_line}]")
    for i, (h, W, C) in enumerate(SPATIAL_UP):
        H = 2 * h
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(2150 + i))
            x = x.to(dev, dtype)
            whole = _launch(x)
            err = 0.0
            for r in range(2):
                xs, top, rows, row0 = _rank_slab(x, r, 2, 1, edges=False)
                window = (top, rows, H, row0)
                u = _launch(xs, window)
                err = max(err, check_up(f"phase 21: rank {r} slab", u, xs, window),
                          _rows_vs_whole(f"phase 21: rank {r} slab upsample_flat", u,
                                         whole[:, 2 * row0:2 * (row0 + rows)]))
                if r == 0:
                    xs0, window0 = xs, window
            if dtype != torch.bfloat16:
                continue
            ms = cuda_ms(lambda: _launch(xs0, window0), iters=10)
            nbytes = 2 * B * W * C * (xs0.shape[1] + 4 * h)
            out["upsample_flat"].append({"h": h, "slab_rows": xs0.shape[1], "W": W, "C": C,
                                         "B": B, "variant": up_variant(xs0, h), "ms": ms,
                                         "bound_ms": nbytes / HBM_RATE * 1e3,
                                         "max_abs_err": err})
            print(f"phase 21: upsample_flat rank 0 slab B={B} rows {xs0.shape[1]} -> {2 * h} "
                  f"W={W} C={C} bf16: {ms:.4f} ms eager, byte bound "
                  f"{nbytes / HBM_RATE * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB) [{card_line}]")
    return out


def phase_spatial(dev, card_line) -> dict:
    """Phase 21; returns the two ranks' B1 and B2 launches (summed), B1's and
    B2's slab checks and times, and the phase's numbers."""
    import tempfile
    from pathlib import Path

    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.parallel.dryrun import dryrun_multichip
    from lmnet_tpu_torch.train import create_train_state, train_step

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slabs = _spatial_slab_kernels(dev, card_line)
    windows = _spatial_window_kernels(dev, card_line)

    x, y = _batch(SPATIAL_BATCH, SPATIAL_IMG, "val", 4, dev)
    state = create_train_state(_spatial_model(dev, torch.bfloat16),
                               (SPATIAL_BATCH, SPATIAL_IMG, SPATIAL_IMG, 3), seed=0, device=dev)
    cm = ConfusionAccumulator.init(2, dev)

    one_ms = [_steps_ms(lambda: train_step(state, x, y, cm), 3, dev)]
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    del state
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_", dir=build) as tmp:
        # the dry run beside the two ranks (each is mostly its processes'
        # start); the ranks time their steps once it has ended
        t0 = time.perf_counter()
        args = ["--spatial-rank", tmp, dev.type]
        proc = _torchrun_start(2, args)
        try:
            dry = dryrun_multichip(4, device=dev.type)
            (Path(tmp) / "quiet").touch()
            _torchrun_end(proc, args, phase=21)
        finally:
            stop_process(proc)
        t_ranks = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(2)]

    check([r["backend"] for r in ranks] == ["gloo", "gloo"]
          and [r["mesh"] for r in ranks] == [(1, 2), (1, 2)],
          "the ranks are not a gloo (1 x 2) mesh")
    for r in ranks:
        check(r["step_launches"]["nat_fwd"] == 4 and r["step_launches"]["nat_bwd"] == 4,
              f"rank {r['rank']}'s bf16 step launched {r['step_launches']}")
        check(r["collectives"] == ranks[0]["collectives"] and r["collectives"]["halo"] > 0,
              f"the ranks' collectives differ: {[q['collectives'] for q in ranks]}")

    # bf16 512^2, B=4 (256 rows a rank): against one process by the bf16 rule
    one_bf16 = _ddp_step(_spatial_model(dev, torch.bfloat16), x, y)
    ref = _spatial_model(dev, torch.float32)
    ref.load_state_dict(_spatial_model(dev, torch.bfloat16).state_dict())
    fp32 = _ddp_step(ref, x, y)
    del ref

    def stats_only(step):
        return step[0], step[1], {k: v for k, v in step[2].items() if "running" in k}, step[3]

    b16 = _bf16_rule(f"bf16 {SPATIAL_IMG}^2 B={SPATIAL_BATCH} step, 2 ranks x "
                     f"{SPATIAL_IMG // 2} rows against one process", stats_only(ranks[0]["bf16"]),
                     stats_only(one_bf16), stats_only(fp32), phase=21)
    del one_bf16, fp32
    same = all(torch.equal(ranks[0][k][2][n], ranks[1][k][2][n])
               for k in ("bf16", "fp32") for n in ranks[0][k][2])
    print(f"phase 21: both ranks' parameters and running statistics bitwise equal after the bf16 "
          f"and fp32 steps: {same} {'ok' if same else 'FAIL'}")
    check(same, "the ranks' parameters differ after the sharded step")

    x32, y32 = _batch(2, 64, "val", 3, dev)
    _fp32_rule("fp32 64^2 B=2 step", ranks[0]["fp32"],
               _ddp_step(_spatial_model(dev, torch.float32), x32, y32))

    # evaluate (fp32, HD95) and serving_evaluate (bf16, B1 on each slab)
    (el, em), (sl, sm) = _spatial_evals(dev)
    (gel, gem), (gsl, gsm) = ranks[0]["evals"]
    pixels = SPATIAL_EVAL_IMAGES * SPATIAL_IMG * SPATIAL_IMG
    ev_flips = abs(gem["accuracy"] - em["accuracy"]) * pixels
    hd_ok = (np.isnan(gem["hd95"]) and np.isnan(em["hd95"])) or abs(gem["hd95"] - em["hd95"]) <= 1
    ok = abs(gel - el) <= 1e-5 * abs(el) and ev_flips <= 1e-4 * pixels and hd_ok
    print(f"phase 21: evaluate fp32 over {SPATIAL_EVAL_IMAGES} images (batches 2, 2, 1): 2 ranks "
          f"loss {gel:.6f} vs {el:.6f} (tol rel 1e-5), accuracy moved by {ev_flips:.0f} pixels "
          f"(tol 1e-4 of {pixels}), HD95 {gem['hd95']:.4f} vs {em['hd95']:.4f} (tol 1 pixel) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the sharded evaluate disagrees with one process")
    _serving_rule("serving_evaluate bf16 ('xla' ReparamConv, einsum upsample)", (gsl, gsm),
                  (sl, sm))

    # the row-window kernels' path: 'fused' + the flat upsample (B6, B5, B7 on
    # each rank's slabs), then serving through B5 and B4 (and B7)
    from lmnet_tpu_torch.ops import resize

    for r in ranks:
        # the BatchNorm kernels: the 16 expand and 4 skip BatchNorms, the 16
        # expand ones again in the recompute, 20 backwards ('fused' keeps the
        # branch statistics in B6)
        want = {"nat_fwd": 4, "nat_bwd": 4, "rc_dw_gelu": 32, "rc_stats": 32, "rc_fused": 0,
                "upsample_flat": 7, "bn_train": 36, "bn_train_bwd": 20}
        check(r["fused_step_launches"] == want,
              f"rank {r['rank']}'s 'fused' + flat bf16 step launched {r['fused_step_launches']}"
              f", want {want}")
        for rc, kernel, other in (("flat", "rc_dw_gelu", "rc_fused"),
                                  ("pallas", "rc_fused", "rc_dw_gelu")):
            got = r["serves"][rc][1]
            check(got[kernel] == 16 * 3 and got[other] == 0 and got["upsample_flat"] == 7 * 3
                  and got["nat_fwd"] == 4 * 3,
                  f"rank {r['rank']}'s serving with rc_backend={rc!r} launched {got}")
        check(r["fused_collectives"] == ranks[0]["fused_collectives"],
              f"the ranks' collectives differ: {[q['fused_collectives'] for q in ranks]}")
    resize.UPSAMPLE_BACKEND = "flat"
    try:
        one_fused = _ddp_step(_spatial_fused_model(dev, torch.bfloat16), x, y)
        ref = _spatial_fused_model(dev, torch.float32)
        ref.load_state_dict(_spatial_fused_model(dev, torch.bfloat16).state_dict())
        fp32_fused = _ddp_step(ref, x, y)
        del ref
        b16_fused = _bf16_rule(
            f"'fused' + flat upsample bf16 {SPATIAL_IMG}^2 B={SPATIAL_BATCH} step, 2 ranks x "
            f"{SPATIAL_IMG // 2} rows against one process", stats_only(ranks[0]["fused_bf16"]),
            stats_only(one_fused), stats_only(fp32_fused), phase=21)
        del one_fused, fp32_fused
        _fp32_rule("'fused' + flat upsample fp32 64^2 B=2 step", ranks[0]["fused_fp32"],
                   _ddp_step(_spatial_fused_model(dev, torch.float32), x32, y32))
    finally:
        resize.UPSAMPLE_BACKEND = "einsum"
    same = all(torch.equal(ranks[0][k][2][n], ranks[1][k][2][n])
               for k in ("fused_bf16", "fused_fp32") for n in ranks[0][k][2])
    print(f"phase 21: both ranks' parameters and running statistics bitwise equal after the "
          f"'fused' + flat steps: {same} {'ok' if same else 'FAIL'}")
    check(same, "the ranks' parameters differ after the sharded 'fused' step")
    serves = _spatial_serves(dev)
    for rc, (one, _) in serves.items():
        _serving_rule(f"serving_evaluate bf16 rc_backend={rc!r}, flat upsample",
                      ranks[0]["serves"][rc][0], one)
    fused_coll = ranks[0]["fused_collectives"]
    window_launches = {
        "rc_fused": sum(r["serves"]["pallas"][1]["rc_fused"] for r in ranks),
        "rc_dw_gelu": sum(r["fused_launches"]["rc_dw_gelu"] + r["serves"]["flat"][1]["rc_dw_gelu"]
                          for r in ranks),
        "rc_stats": sum(r["fused_launches"]["rc_stats"] for r in ranks),
        "upsample_flat": sum(r["fused_launches"]["upsample_flat"]
                             + sum(r["serves"][rc][1]["upsample_flat"] for rc in r["serves"])
                             for r in ranks),
    }
    check(all(v > 0 for v in window_launches.values()),
          f"a row-window kernel never launched on the spatial path: {window_launches}")

    coll = ranks[0]["collectives"]
    two_ms = [r["ms"] for r in ranks]
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ("nat_fwd", "nat_bwd")}
    print(f"phase 21: train_step bf16 {SPATIAL_IMG}^2 B={SPATIAL_BATCH} 'flat' + 'xla', rc_remat: "
          f"one process {' / '.join(f'{t:.1f}' for t in one_ms)} ms (before the "
          f"2-rank run), 2 ranks x {SPATIAL_IMG // 2} rows on one card over gloo {two_ms} ms a "
          f"step (one turn each rank; every exchange and all-reduce goes through the host) "
          f"[{card_line}]; a step's collectives: {coll['halo']} halo exchanges, "
          f"{coll['forward']} all-reduces in forwards, {coll['backward']} in backwards, "
          f"{coll['grads']} of the gradients; torchrun 2 ranks {t_ranks:.1f}s, the dry run "
          f"{dry['mesh'][0]}x{dry['mesh'][1]} beside them {dry['seconds']:.1f}s")
    print(f"phase 21: the 'fused' + flat upsample bf16 step's collectives: "
          f"{fused_coll['halo']} halo exchanges, {fused_coll['forward']} all-reduces in "
          f"forwards, {fused_coll['backward']} in backwards, {fused_coll['grads']} of the "
          f"gradients")
    print(f"phase 21: spatial path: B1/B2 launches {json.dumps(launches)} (rank 0 "
          f"{json.dumps(ranks[0]['launches'])}, rank 1 {json.dumps(ranks[1]['launches'])}); "
          f"B4-B7 (the two ranks' 'fused' + flat steps and serving through B5 and B4) "
          f"{json.dumps(window_launches)}; phase 21 {time.perf_counter() - t_phase:.1f}s")
    return {"spatial": {**launches, **window_launches}, "slabs": {**slabs, **windows},
            "bn": sum(_bn_launches(r["launches"]) + _bn_launches(r["fused_launches"])
                      for r in ranks),
            "one_ms": one_ms, "two_ms": two_ms, "collectives": coll,
            "fused_collectives": fused_coll, "bf16_worst": b16, "bf16_fused_worst": b16_fused}


CONVERGENCE_ARMS = ("fp32", "fused", "bf16")
# the kernels phase 22 counts: B1, B2, B5, B6, B4, B7 and B3
CONVERGENCE_KERNELS = (*DDP_KERNELS, "rc_fused", "upsample_flat", "nat_kernel")


def _convergence_counters() -> dict:
    from lmnet_tpu_torch.ops.nat_kernel import neighborhood_attention_pallas

    return {**_kernel_counters(), "nat_kernel": neighborhood_attention_pallas}


def convergence_draw_main(arm: str, k: str, out_dir: str, device: str = "cuda") -> int:
    """A child of phase 22: draw ``k`` of ``arm``'s protocol on ``device``
    (draw 0 also serves its best checkpoint), its record, wall seconds and
    kernel launches written to ``out_dir/<arm>_<k>.json``."""
    from pathlib import Path

    from lmnet_tpu_torch.parity import convergence as cv

    torch.set_num_threads(1)
    k = int(k)
    counters = _convergence_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rec = cv.run_arm(arm, device=device, ref=cv.load_ref(arm, 0, k), perturb=k, serve=k == 0,
                     log=lambda m: None)
    rec["wall"] = time.perf_counter() - t0
    rec["launches"] = {name: fn.launches for name, fn in counters.items()}
    (Path(out_dir) / f"{arm}_{k}.json").write_text(json.dumps(rec))
    return 0


def _convergence_draws(jobs, dev) -> dict:
    """{(arm, k): the record of that draw}, each draw in a child process
    (``--convergence-draw``) on ``dev``, all started together."""
    import os
    import tempfile
    from pathlib import Path

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_convergence_", dir=build) as tmp:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = {job: subprocess.Popen(
            [sys.executable, __file__, "--convergence-draw", job[0], str(job[1]), tmp,
             dev.type], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for job in jobs}
        try:
            outs = {job: p.communicate(timeout=900)[0] for job, p in procs.items()}
        finally:
            for p in procs.values():
                stop_process(p)
        for job, p in procs.items():
            check(p.returncode == 0, f"phase 22: draw {job[1]} of {job[0]} exited "
                  f"{p.returncode}: {outs[job][-3000:]}")
        return {job: json.loads((Path(tmp) / f"{job[0]}_{job[1]}.json").read_text())
                for job in jobs}


def pool_times(dev, card_line) -> None:
    """The pyramid pool's four adaptive pools at phase 8's shapes (the
    full-width model at 256^2, B=16, the tensors as its forward gives them),
    forward and backward in both dtypes: ``ops/resize.py``'s 'mean' pool, the
    convergence harness's (a reshape-mean), against its default 'torch'
    (``F.adaptive_avg_pool2d``, whose CUDA backward adds with atomics and
    raises under deterministic algorithms). CUDA events; the outputs agree
    within float32 order or one bf16 rounding."""
    import torch.nn.functional as F

    from lmnet_tpu_torch.models import lm_net
    from lmnet_tpu_torch.ops import resize

    calls = []
    real = _capture(lm_net, "pyramid_pool", calls)
    try:
        with torch.no_grad():
            seeded_model(dev)(_served_batch(dev).float())
    finally:
        lm_net.pyramid_pool = real
    xs, last = calls[0]
    hw = tuple(last.shape[1:3])
    def mean(x):
        resize.POOL_BACKEND = "mean"
        try:
            return resize.adaptive_avg_pool(x, hw)
        finally:
            resize.POOL_BACKEND = "torch"

    pools = {"reshape-mean": mean,
             "F.adaptive_avg_pool2d": lambda x: F.adaptive_avg_pool2d(
                 x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)}
    for dtype in (torch.bfloat16, torch.float32):
        ins = [x.detach().to(dtype).requires_grad_() for x in xs]
        with torch.no_grad():
            outs = {name: [pool(x) for x in ins] for name, pool in pools.items()}
        err = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                  for a, b in zip(*outs.values()))
        # float32 means of up to 256 terms in another order; bf16 one rounding
        tol = 2**-7 if dtype == torch.bfloat16 else 1e-5
        grads = [torch.ones_like(o) for o in outs["reshape-mean"]]

        def step(pool):
            return lambda: torch.autograd.backward([pool(x) for x in ins], grads)

        ms = {name: cuda_ms(step(pool)) for name, pool in pools.items()}
        print(f"phase 22: pyramid pool {_dt(dtype)} {[tuple(x.shape) for x in xs]} -> {hw}, "
              f"forward + backward: " + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items())
              + f"; outputs rel {err:.2e} (tol {tol:g}) [{card_line}]")
        check(err <= tol, f"phase 22: the 'mean' pool disagrees with torch's ({err:.2e})")


def phase_convergence(dev, card_line) -> dict:
    """Phase 22: the convergence-parity protocol
    (lmnet_tpu_torch/parity/convergence.py): every draw of every arm in a
    child process of its own (``--convergence-draw``), all at once on the
    card (each is host-bound), held against JAX's committed records; draw
    0's best checkpoint served through B1, B3, B5 and B4 with B7; every
    rule a check. Returns the launches of the seven kernels summed over the
    children and each arm's records."""
    from lmnet_tpu_torch.parity import convergence as cv

    t_phase = time.perf_counter()
    pool_times(dev, card_line)
    jobs = [(arm, k) for arm in CONVERGENCE_ARMS for k in range(cv.DRAWS)]
    recs = _convergence_draws(jobs, dev)
    launches = {name: sum(r["launches"][name] for r in recs.values())
                for name in CONVERGENCE_KERNELS}
    records = {}
    for arm in CONVERGENCE_ARMS:
        ports = [recs[(arm, k)] for k in range(cv.DRAWS)]
        refs = [cv.load_ref(arm, 0, k) for k in range(cv.DRAWS)]
        records[arm] = ports
        rec, ref = ports[0], refs[0]
        per_arm = {name: sum(r["launches"][name] for r in ports) for name in CONVERGENCE_KERNELS}
        name, ok, detail = cv.compare_draws(ports, refs)
        trains = ", ".join(f"{r['seconds']:.1f}" for r in ports)
        print(f"phase 22: {arm}: draw 0 port best epoch {rec['best_epoch']} dice "
              f"{100 * rec['best_val_dice']:.3f} iou {100 * rec['best_val_iou']:.3f} | jax best "
              f"epoch {ref['best_epoch']} dice {100 * ref['best_val_dice']:.3f} iou "
              f"{100 * ref['best_val_iou']:.3f} | {name}: {detail} | wall "
              f"{max(r['wall'] for r in ports):.1f}s a draw at most (train {trains}s) "
              f"| launches {json.dumps(per_arm)} [{card_line}]")
        n_ep = len(rec["history"])
        print(f"phase 22: {arm}: draw 0 last-step loss port/jax at epochs "
              + ", ".join(f"{e + 1}: {rec['history'][e][0]:.4f}/{ref['history'][e][0]:.4f}"
                          for e in [*range(0, n_ep - 1, 6), n_ep - 1]))
        for combo, c in rec["served"]["combos"].items():
            print(f"phase 22: {arm}: serving draw 0's best checkpoint {combo}: dice "
                  f"{100 * c['dice']:.3f} iou {100 * c['iou']:.3f}, agreement "
                  f"{100 * c['agree']:.4f} % with the eval forward (dice "
                  f"{100 * rec['served']['eval'][0]:.3f})")
        for k, r in enumerate(ports):
            for cname, cok, cdetail in r["checks"]:
                check(cok, f"phase 22: {arm} draw {k} {cname}: {cdetail}")
        check(ok, f"phase 22: {arm} {name}: {detail}")
        need = {"nat_fwd", "nat_bwd", "nat_kernel", "rc_fused", "rc_dw_gelu", "upsample_flat"}
        if arm == "fused":
            need.add("rc_stats")
        check(all(per_arm[k] > 0 for k in need),
              f"phase 22: {arm}: a kernel of the arm never launched: {per_arm}")
    print(f"phase 22: convergence launches {json.dumps(launches)}; {len(jobs)} draws in "
          f"parallel processes; phase 22 {time.perf_counter() - t_phase:.1f}s [{card_line}]")
    return {"launches": launches, "records": records,
            "bn": sum(_bn_launches(r["launches"]) for r in recs.values())}


# phase 23: JAX's multi-host mode, a node standing for a JAX process; two
# simulated nodes on the one card, each started by a torchrun agent of its
# own (--nnodes 2), their ranks over gloo
MH_LAYOUTS = {"2x1": 1, "2x2": 2}  # ranks a node
MH_CLI_BATCH = 4  # a node's --batch_size: the synthetic train shard of 4 gives 1 step


def _node_batch(n, img, seed, dev, node):
    """Node ``node``'s half of ``_batch(n, img, 'val', seed, dev)``: the
    node's own n / 2 images, its batch of a global batch of n."""
    import itertools

    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.data.augment import eval_pipeline

    loader = make_loader(SyntheticDataset(n, img, "val", seed=seed), n // 2, num_threads=1)
    images, masks = next(itertools.islice(loader, node, None))
    return eval_pipeline(torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev), img)


def _mh_eval_loader(node):
    """Node ``node``'s shard of phase 20's eval set (5 and 4 images), in
    batches of 4."""
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader

    return make_loader(SyntheticDataset(DDP_EVAL_IMAGES, IMG, "val", seed=12).shard(node, 2), 4)


def _mh_evals(dev, mesh=None):
    """evaluate at float32 (cross-host) and serving_evaluate (bf16, B1) of
    phase 20's seeded float32 model: on a mesh of two nodes each node over
    its own shard; in one process evaluate over both shards in node order
    and serving_evaluate over the nodes' batches i concatenated (8 rows,
    then node 0's tail of 1)."""
    import itertools

    from lmnet_tpu_torch.parallel.dist_utils import host_index
    from lmnet_tpu_torch.serve import serving_evaluate
    from lmnet_tpu_torch.train import create_train_state, evaluate

    state = create_train_state(_ddp_model(dev, torch.float32), (4, IMG, IMG, 3), seed=0,
                               device=dev)
    sd = state.model.state_dict()
    if mesh is not None:
        node = host_index()
        return (evaluate(state, _mh_eval_loader(node), img_size=IMG, mesh=mesh, cross_host=True),
                serving_evaluate(sd, _mh_eval_loader(node), 2, IMG, device=dev, mesh=mesh))
    nodes = [list(_mh_eval_loader(k)) for k in range(2)]
    batches = [tuple(np.concatenate([b[i] for b in bs if b is not None]) for i in range(2))
               for bs in itertools.zip_longest(*nodes)]
    return (evaluate(state, itertools.chain(*nodes), img_size=IMG),
            serving_evaluate(sd, batches, 2, IMG, device=dev))


def mh_rank_main(out_dir, layout: str, device_type: str, t0: str) -> int:
    """One rank of phase 23, started by one of two torchrun agents (a node
    each) at ``t0`` (seconds since the epoch): on 2 nodes x 1 rank the bf16
    256^2 step on its node's 8 rows of phase 20's 16, the cross-host
    evaluate and serving_evaluate of its node's eval shard, then, once the
    runs beside it have ended (``_wait_quiet``), 3 timed steps; on 2 nodes
    x 2 ranks the float32 64^2 step on its node's 2 rows of phase 20's 4,
    then the CLI on its node's train and val shards. Saves what it got,
    its kernel launches and its seconds a part to ``out_dir/rank{r}.pt``."""
    from pathlib import Path

    from lmnet_tpu_torch.cli import train as cli
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.parallel import dist_utils
    from lmnet_tpu_torch.parallel.mesh import make_mesh, node_rows
    from lmnet_tpu_torch.train import create_train_state, train_step

    seconds, last = {"start": time.time() - float(t0)}, [time.perf_counter()]

    def lap(name):
        _sync(dev)
        seconds[name] = time.perf_counter() - last[0]
        last[0] = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist_utils.init_distributed_mode(device_type, backend="gloo")
    rank, node = dist_utils.get_rank(), dist_utils.host_index()
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    mesh = make_mesh(device_type=device_type)
    got = {"rank": rank, "backend": torch.distributed.get_backend(),
           "hosts": (node, dist_utils.host_count(), dist_utils.local_world_size())}
    lap("init")
    _zero_counters()
    if layout == "2x1":
        x, y = _node_batch(BATCH, IMG, 4, dev, node)
        got["bf16"] = _ddp_step(_ddp_model(dev, torch.bfloat16), x, y, mesh)
        _sync(dev)
        got["step_launches"] = _read_counters()
        lap("step")
        got["evals"] = _mh_evals(dev, mesh)
        lap("evals")
        state = create_train_state(_ddp_model(dev, torch.bfloat16), tuple(x.shape), seed=0,
                                   device=dev)
        rows, cm = node_rows(mesh, len(x)), ConfusionAccumulator.init(2, dev)
        _wait_quiet(out_dir)
        lap("wait")
        got["ms"] = _steps_ms(lambda: train_step(state, x[rows], y[rows], cm, mesh=mesh,
                                                 global_rows=BATCH), 3, dev)
        lap("timed")
    else:
        x32, y32 = _node_batch(4, 64, 3, dev, node)
        got["fp32"] = _ddp_step(_ddp_model(dev, torch.float32), x32, y32, mesh)
        lap("step")
        before = _read_counters()
        root = Path(out_dir) / "cli"
        cli.main(["--synthetic", "--k_fold", "False", "--img_size", str(IMG), "--batch_size",
                  str(MH_CLI_BATCH), "--epochs", "1", "--seed", "0", "--apm", "--distributed",
                  "True", "--ckpt_dir", str(root / "ckpt"), "--out_dir", str(root / "out"),
                  "--device", device_type])
        _sync(dev)
        got["cli_launches"] = {k: v - before[k] for k, v in _read_counters().items()}
        lap("cli")
    got["launches"] = _read_counters()
    got["seconds"] = seconds
    print(f"phase 23: rank {rank} (node {node})| launches {json.dumps(got['launches'])}; "
          f"seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}", flush=True)
    torch.save(got, Path(out_dir) / f"rank{rank}.pt")
    dist_utils.cleanup()
    return 0


def _start_two_nodes(local: int, args) -> list:
    """Two torchrun agents, node ranks 0 and 1 of ``--nnodes 2`` with
    ``local`` ranks each (static rendezvous on 127.0.0.1), running
    ``chip_smoke.py args``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return [_torchrun_start(local, args, ("--nnodes", "2", "--node_rank", str(k), "--master_addr",
                                          "127.0.0.1", "--master_port", str(port)))
            for k in range(2)]


def phase_multihost(dev, card_line, refs) -> dict:
    """Phase 23: JAX's multi-host mode, each node a JAX process with its own
    data. ``refs``: phase 20's one-process steps on the 16 and 4 images the
    nodes' batches concatenate to. Returns the kernel launches summed over
    the ranks of both runs."""
    import tempfile
    from pathlib import Path

    t_phase = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_", dir=build) as tmp:
        tmp = Path(tmp)
        # both runs at once (each is mostly its processes' start); the 2 x 1
        # ranks time their steps once the 2 x 2 run has ended
        procs, args = {}, {}
        for layout, local in MH_LAYOUTS.items():
            (tmp / layout).mkdir()
            args[layout] = ["--mh-rank", str(tmp / layout), layout, dev.type, repr(time.time())]
            procs[layout] = _start_two_nodes(local, args[layout])
        runs, seconds = {}, {}
        try:
            for layout in ("2x2", "2x1"):
                for p in procs[layout]:
                    _torchrun_end(p, args[layout], timeout=300, phase=23)
                if layout == "2x2":
                    (tmp / "2x1" / "quiet").touch()
                seconds[layout] = time.perf_counter() - t_phase
                runs[layout] = [torch.load(tmp / layout / f"rank{r}.pt", weights_only=False)
                                for r in range(2 * MH_LAYOUTS[layout])]
        finally:
            for p in procs["2x1"] + procs["2x2"]:
                stop_process(p)
        cli_root = tmp / "2x2" / "cli"
        files = sorted(p.name for p in (cli_root / "out").iterdir())
        ckpts = sorted(p.name for p in (cli_root / "ckpt").iterdir())
        rows = _csv_rows(cli_root / "out" / "LM_NetKvasir_0.csv")

    for layout, local in MH_LAYOUTS.items():
        for r in runs[layout]:
            check(r["backend"] == "gloo" and r["hosts"] == (r["rank"] // local, 2, local),
                  f"phase 23: rank {r['rank']} of {layout} is on node {r['hosts']}")

    # (a) 2 nodes x 1 rank: the bf16 step on each node's own 8 rows
    two = runs["2x1"]
    for r in two:
        check({k: r["step_launches"][k] for k in DDP_KERNELS}
              == {"nat_fwd": 4, "nat_bwd": 4, "rc_dw_gelu": 32, "rc_stats": 32},
              f"phase 23: rank {r['rank']}'s bf16 step launched {r['step_launches']}")
    got = two[0]["bf16"]
    stats = (got[0], got[1], {k: v for k, v in got[2].items() if "running" in k}, got[3])
    b16 = _bf16_rule(f"(a) bf16 {IMG}^2 step on 2 nodes x {BATCH // 2} rows (a global batch of "
                     f"{BATCH}) against one process on the concatenation", stats, refs["bf16"],
                     refs["fp32"], phase=23)
    same = all(torch.equal(got[2][n], two[1]["bf16"][2][n]) for n in got[2])
    phase20 = refs["two_ranks"]
    like20 = (got[0] == phase20[0] and all(torch.equal(got[1][n], phase20[1][n]) for n in got[1]))
    print(f"phase 23: (a) both nodes' parameters and running statistics bitwise equal after the "
          f"step: {same}; loss and gradients bitwise phase 20's 2 ranks on one node: {like20} "
          f"{'ok' if same else 'FAIL'}")
    check(same, "phase 23: the nodes' parameters differ after the step")

    # (b) cross-host evaluate and serving_evaluate of each node's shard
    (el, em), (sl, sm) = _mh_evals(dev)
    (gel, gem), (gsl, gsm) = two[0]["evals"]
    pixels = DDP_EVAL_IMAGES * IMG * IMG
    ev_flips = abs(gem["accuracy"] - em["accuracy"]) * pixels
    sv_flips = abs(gsm["accuracy"] - sm["accuracy"]) * pixels
    ok = (two[0]["evals"] == two[1]["evals"] and abs(gel - el) <= 1e-5 * abs(el)
          and ev_flips <= 1e-4 * pixels and abs(gsl - sl) <= 0.02 * abs(sl)
          and sv_flips <= 0.025 * pixels and all(abs(gsm[k] - sm[k]) <= 0.02 for k in sm))
    print(f"phase 23: (b) cross-host evaluate fp32 of the nodes' shards (5 and 4 images, "
          f"batches of 4): loss {gel:.6f} vs one process over both {el:.6f} (tol rel 1e-5), "
          f"accuracy moved by {ev_flips:.0f} pixels (tol 1e-4 of {pixels}); serving_evaluate "
          f"bf16 of the nodes' batches as global batches: loss {gsl:.6f} vs {sl:.6f} (tol 2 %), "
          f"{sv_flips:.0f} pixels (tol 2.5 %) {'ok' if ok else 'FAIL'}")
    check(ok, "phase 23: the two nodes' evaluate or serving_evaluate disagrees with one process")

    # (c) 2 nodes x 2 ranks: the float32 64^2 step, 1 row a rank
    four = runs["2x2"]
    _fp32_rule("(c) fp32 64^2 step", four[0]["fp32"], refs["fp32_64"], phase=23,
               who="2 nodes x 2 ranks x 1 row")
    same = all(torch.equal(four[0]["fp32"][2][n], r["fp32"][2][n])
               for r in four[1:] for n in four[0]["fp32"][2])
    check(same, "phase 23: the four ranks' parameters differ after the fp32 step")

    # (d) the CLI on 2 nodes x 2 ranks: a global batch of 8, each node its shard
    ok = (files == ["LM_NetKvasir_0.csv", "LM_NetKvasirbestresult_0.csv"]
          and ckpts == ["LM_NetKvasir_0_checkpoint", "LM_NetKvasirbest_0"]
          and len(rows) == 1 and len(rows[0]) == 16
          and all(np.isfinite(float(v)) for v in rows[0])
          and all(r["cli_launches"]["nat_fwd"] == 8 and r["cli_launches"]["nat_bwd"] == 4
                  for r in four))
    print(f"phase 23: (d) cli --apm --distributed True on 2 nodes x 2 ranks (--batch_size "
          f"{MH_CLI_BATCH} a node, 2 rows a rank; train shards of 4, val shards of 2): files "
          f"{files}, checkpoints {ckpts}, rank 0's row {rows}; B1/B2 launches a rank "
          f"{[(r['cli_launches']['nat_fwd'], r['cli_launches']['nat_bwd']) for r in four]} "
          f"(want 8, 4) {'ok' if ok else 'FAIL'}")
    check(ok, "phase 23: the two-node CLI run broke its file contract or its launches")

    launches = {k: sum(r["launches"][k] for r in two + four) for k in DDP_KERNELS}
    check(all(r["launches"][k] > 0 for r in two for k in DDP_KERNELS)
          and all(r["launches"][k] > 0 for r in four for k in ("nat_fwd", "nat_bwd")),
          "phase 23: a rank did not launch every kernel of its path")
    ms = [r["ms"] for r in two]
    parts = [{k: round(v, 1) for k, v in r["seconds"].items()} for r in two + four]
    print(f"phase 23: train_step bf16 {IMG}^2, global batch {BATCH} on 2 nodes x 1 rank "
          f"sharing one card over gloo: {ms} ms a step a rank (gloo copies every all-reduce "
          f"through the host: not NCCL's time; phase 20's one process "
          f"{refs['one_ms']} ms) [{card_line}]; the two-node runs, started together, ended "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})} s into the phase; "
          f"each rank's seconds a part {json.dumps(parts)}; "
          f"kernel launches "
          f"{json.dumps(launches)}; phase 23 {time.perf_counter() - t_phase:.1f}s")
    return {"launches": launches, "ms": ms, "bf16_worst": b16,
            "bn": sum(_bn_launches(r["launches"]) for r in two + four)}


# phase 24: bench_torch.py, JAX's bench.py protocol on the port (B=128)
BENCH_SIZES = (256, 384, 512)
BENCH_SEED = 24


def _bench_stages(size):
    """(H, W, C) of the four NAT stages at ``size``^2 inputs, 12 heads:
    natt4 .. natt1."""
    return [(size >> i, size >> i, 12 << i) for i in range(4)]


def _bench_rows(b):
    """The images phase 24 holds against a reference: the first two and the
    last two of the batch, where an offset fault past 2^31 bytes would
    show."""
    return [0, 1, b - 2, b - 1]


def _bench_nat_kernels(dev, batch) -> tuple[float, float]:
    """Phase 24 (a), (b): B1 at the four NAT stages of every served size and
    B2 at the 256^2 stages, bf16, the whole batch in one launch, held on
    images _bench_rows against the plain version of those images alone
    (the plain NAT materialises 9 slots of k and v and the logits: ~14.5 GB
    each in float32 for the whole 512^2 stage). The C plan (``kernel_plan``)
    must equal ``nat_plan`` at each shape. Returns the worst B1 and B2
    errors."""
    from lmnet_tpu_torch.ops.nat_flat import nat_flat

    rows = _bench_rows(batch)
    idx = torch.tensor(rows, device=dev)
    worst_f = worst_b = 0.0
    for size in BENCH_SIZES:
        for i, (H, W, C) in enumerate(_bench_stages(size)):
            g = torch.Generator(device=dev).manual_seed(BENCH_SEED * 1000 + size + i)
            q, k, v = (torch.randn(batch, H, W * C, generator=g, device=dev,
                                   dtype=torch.bfloat16) for _ in range(3))
            rpb = torch.randn(HEADS, 5, 5, generator=g, device=dev) * 0.3
            plan = _bench_plan(dev, batch, H, W, C, "fwd")
            with torch.inference_mode():
                got = nat_flat(q, k, v, rpb, HEADS, C, W)
                print(f"phase 24: nat_fwd B={batch} H={H} W={W} C={C} bf16 "
                      f"({q.numel() * 2 / 1e6:.1f} MB a tensor; {plan['variant']}, tile "
                      f"{plan['tile'][0]}x{plan['tile'][1]}, grid {plan['grid']}), "
                      f"images {rows}:")
                worst_f = max(worst_f, check_fwd("phase 24", got[idx], q[idx], k[idx], v[idx],
                                                 rpb, len(rows), H, W, C))
            del got
            if size == IMG:
                worst_b = max(worst_b, _bench_b2(q, k, v, rpb, idx, g))
            del q, k, v
    return worst_f, worst_b


def _bench_plan(dev, batch, H, W, C, kind) -> dict:
    """``nat_plan`` at a phase 24 shape; on the card the C source's plan
    (its launch guard included) must be the same."""
    from lmnet_tpu_torch.ops.nat_flat import kernel_plan, nat_plan

    plan = nat_plan(batch, H, W, HEADS, C // HEADS, torch.bfloat16, kind)
    check(plan is not None and (dev.type != "cuda" or kernel_plan(
        batch, H, W, HEADS, C // HEADS, torch.bfloat16, kind) == plan),
        f"phase 24: nat_{kind}'s plans refuse or differ at {(batch, H, W, C)}")
    return plan


def _bench_b2(q, k, v, rpb, idx, g) -> float:
    """Phase 24 (b) at one stage: B2 on the whole batch, dq, dk and dv on
    images ``idx`` against the plain backward of those images alone, d_rpb
    (a sum over the batch) against the plain backward's summed over chunks
    of 16 images. Returns the worst dq/dk/dv error."""
    from lmnet_tpu_torch.ops.nat_flat import nat_flat_bwd, nat_flat_bwd_plain

    (batch, H, WC), W = q.shape, q.shape[1]
    C = WC // W
    scale = float(C // HEADS) ** -0.5
    plan = _bench_plan(q.device, batch, H, W, C, "bwd")
    gy = torch.randn(batch, H, WC, generator=g, device=q.device, dtype=torch.bfloat16)
    got = nat_flat_bwd(q, k, v, rpb, gy, HEADS, C, W, scale)
    drpb = sum(nat_flat_bwd_plain(*(t[s:s + 16].float() for t in (q, k, v)), rpb,
                                  gy[s:s + 16].float(), HEADS, C, W, scale)[3]
               for s in range(0, batch, 16))
    print(f"phase 24: nat_bwd B={batch} H={H} W={W} C={C} bf16 (d_rpb partials "
          f"{plan['workspace'] * 4 / 1e6:.1f} MB; {plan['variant']}, grid {plan['grid']}), "
          f"dq, dk, dv on images {idx.tolist()}, d_rpb over the batch in chunks of 16:")
    return check_bwd("phase 24", (got[0][idx], got[1][idx], got[2][idx], got[3]), q[idx],
                     k[idx], v[idx], rpb, gy[idx], len(idx), H, W, C, scale, drpb=drpb)


def _bench_served(deploy, dev, batch) -> int:
    """Phase 24 (c): a batch of distinct random bf16 images at every served
    size through ``deploy_forward`` (B1), its logits on images _bench_rows
    against ``deploy_forward`` of those images alone, by the serving rule.
    Returns the B1 launches of the full batches."""
    from lmnet_tpu_torch.ops.nat_flat import nat_flat
    from lmnet_tpu_torch.serve import deploy_forward

    rows = _bench_rows(batch)
    idx = torch.tensor(rows, device=dev)
    launches = 0
    for size in BENCH_SIZES:
        g = torch.Generator(device=dev).manual_seed(BENCH_SEED + size)
        x = torch.randn(batch, size, size, 3, generator=g, device=dev, dtype=torch.bfloat16)
        with torch.inference_mode():
            before = nat_flat.launches
            out = deploy_forward(deploy, x, num_heads=HEADS, nat_backend="flat")
            launches += nat_flat.launches - before
            finite = bool(torch.isfinite(out).all())
            out = out[idx]
            ref = deploy_forward(deploy, x[idx], num_heads=HEADS, nat_backend="flat")
        scale = ref.abs().max().item()
        check(finite, f"phase 24: non-finite logits in the {size}^2 B={batch} batch")
        _logits_close(f"phase 24: deploy_forward bf16 {size}^2 B={batch} (distinct random "
                      f"images), images {rows} against those images alone (logits of max "
                      f"{scale:.3e})", out, ref, bound=0.05 * max(scale, 1.0))
        del x, out
    return launches


def _bench_step(model, x, y, dev) -> tuple[float, dict, float, float]:
    """One train_step of ``model`` with dropout off: the loss, the NAT
    layers' gradients, the step's peak device GiB and its seconds."""
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.models.blocks import NeighborhoodAttention2D
    from lmnet_tpu_torch.parity.convergence import NoDropout
    from lmnet_tpu_torch.train import create_train_state, train_step

    state = create_train_state(NoDropout(model), tuple(x.shape), seed=0, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    _, loss, _ = train_step(state, x, y, ConfusionAccumulator.init(2, dev))
    loss = float(loss)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    grads = {f"{mn}.{pn}": p.grad.detach().float().clone() for mn, m in model.named_modules()
             if isinstance(m, NeighborhoodAttention2D) for pn, p in m.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss, grads, peak, seconds


def _bench_train_step(dev, batch, card_line) -> dict:
    """Phase 24 (d): one bf16 train_step at 256^2 of ``batch`` random images
    and labels through B1 and B2 (dropout off), against the bf16 step with
    the plain NAT from the same weights, each measured against a float32
    plain step (54 GiB at B=128) by phase 8's rule. Returns the flat step's
    B1 and B2 launches."""
    from lmnet_tpu_torch.models import LMNet
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase 3 leaves them
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(BENCH_SEED)
    x = torch.randn(batch, IMG, IMG, 3, generator=g, device=dev)
    y = torch.randint(0, 2, (batch, IMG, IMG), generator=g, device=dev, dtype=torch.int32)

    def model(dtype, nat_backend):
        m = LMNet(generator=torch.Generator().manual_seed(BENCH_SEED), dtype=dtype,
                  nat_backend=nat_backend)
        return m.to(dev)

    before = (nat_flat.launches, nat_flat_bwd.launches)
    lf, gf, pf, sf = _bench_step(model(torch.bfloat16, "flat"), x, y, dev)
    launches = {"nat_fwd": nat_flat.launches - before[0],
                "nat_bwd": nat_flat_bwd.launches - before[1]}
    lp, gp, pp, sp = _bench_step(model(torch.bfloat16, "plain"), x, y, dev)
    lr, gr, pr, sr = _bench_step(model(torch.float32, "plain"), x, y, dev)
    ok = np.isfinite(lf) and abs(lf - lr) <= 2 * abs(lp - lr) + 1e-4 * abs(lr)
    print(f"phase 24: train_step {IMG}^2 B={batch} dropout off: bf16 flat loss {lf:.6f} "
          f"(peak {pf:.2f} GiB, {sf:.2f} s, B1/B2 launches {launches['nat_fwd']}/"
          f"{launches['nat_bwd']}), bf16 plain {lp:.6f} (peak {pp:.2f} GiB, {sp:.2f} s), "
          f"float32 plain {lr:.6f} (peak {pr:.2f} GiB, {sr:.2f} s) (tol |flat-fp32| <= "
          f"2 |plain-fp32| + 1e-4 |fp32|) {'ok' if ok else 'FAIL'} [{card_line}]")
    check(launches == {"nat_fwd": 4, "nat_bwd": 4},
          f"phase 24: the flat train step launched {launches}, want B1 4 and B2 4")
    ratios = {}
    for n in gr:
        ef, ep = (gf[n] - gr[n]).norm().item(), (gp[n] - gr[n]).norm().item()
        ratios[n] = ef / (2 * ep + 1e-3 * gr[n].norm().item())
        print(f"phase 24:   {n}: ||flat-fp32|| {ef:.3e} ||plain-fp32|| {ep:.3e} "
              f"||fp32|| {gr[n].norm().item():.3e} ||flat-plain||/||plain|| "
              f"{((gf[n] - gp[n]).norm() / gp[n].norm()).item():.3e}")
    worst = max(ratios.values())
    ok = ok and bool(np.isfinite(worst)) and worst <= 1.0
    print(f"phase 24: train_step bf16 {IMG}^2 B={batch}: {len(gr)} NAT-layer gradients, "
          f"worst ||flat-fp32|| / (2 ||plain-fp32|| + 1e-3 ||fp32||) = {worst:.3e} (tol 1), "
          f"at {max(ratios, key=ratios.get)} {'ok' if ok else 'FAIL'}")
    check(ok, "phase 24: flat and plain NAT disagree on the B=128 bf16 train step")
    return launches


def phase_bench(dev, card_line) -> dict:
    """Phase 24: bench_torch.py's path at its sizes, checked (a)-(d), then
    its protocol timed through bench_torch's own functions with the kernel
    counters zeroed just before and read just after."""
    import bench_torch

    t_phase = time.perf_counter()
    batch = bench_torch.BATCH
    worst_f, worst_b = _bench_nat_kernels(dev, batch)
    deploy = bench_torch.serving_model(dev)
    served = _bench_served(deploy, dev, batch)
    del deploy
    step = _bench_train_step(dev, bench_torch.TRAIN_BATCH, card_line)
    checks = {"nat_fwd": served + step["nat_fwd"], "nat_bwd": step["nat_bwd"]}

    _sync(dev)
    _zero_counters()
    results = bench_torch.run(dev)
    _sync(dev)
    launches = _read_counters()
    for name, r in results.items():
        b = bench_torch.TRAIN_BATCH if name.startswith("train") else batch
        print(f"phase 24: {bench_torch.config_line(name, r, b, card_line)}")
    print(f"phase 24: bench_torch's numbers: "
          f"{json.dumps(bench_torch.summary(results, card_line))}")
    # 4 B1 launches a forward or step and 4 B2 a step; the BatchNorm
    # kernels 84 + 80 forwards (rc_remat's recompute) and 84 backwards a
    # step; a warm-up chain and the reps, ITERS calls each
    chains = 1 + bench_torch.REPS, 1 + bench_torch.LARGE_REPS
    it = bench_torch.ITERS
    want = {"nat_fwd": 4 * it * (2 * chains[0] + len(bench_torch.LARGE_SIZES) * chains[1]),
            "nat_bwd": 4 * it * chains[0], "bn_train": (84 + 80) * it * chains[0],
            "bn_train_bwd": 84 * it * chains[0]}
    ok = ({k: launches[k] for k in want} == want
          and all(launches[k] == 0 for k in launches if k not in want)
          and all(r["img_s"] > 0 and np.isfinite(r["acc"]) for r in results.values()))
    print(f"phase 24: the protocol's kernel launches {json.dumps(launches)} (want "
          f"{json.dumps(want)}, the rest 0), every rate > 0 and every accumulator finite "
          f"{'ok' if ok else 'FAIL'}; phase 24 {time.perf_counter() - t_phase:.1f}s "
          f"[{card_line}]")
    check(ok, "phase 24: the protocol's launches or numbers are off")
    return {"launches": {k: launches[k] for k in want}, "checks": checks,
            "worst_fwd": worst_f, "worst_bwd": worst_b}


def _kernel_name(mangled: str) -> str:
    """The kernel's own name in an Itanium-mangled entry (a length-prefixed
    identifier ending in ``_kernel`` or starting ``reduce_``), with its
    template arguments (``I...EE``) where it has them; else the entry's
    first 48 characters."""
    i = 0
    while i < len(mangled):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j == i:
            i += 1
            continue
        name = mangled[j:j + int(mangled[i:j])]
        if name.endswith("_kernel") or name.startswith("reduce_"):
            rest = mangled[j + len(name):]
            return name + (rest[:rest.index("EE") + 2] if rest.startswith("I") and "EE" in rest
                           else "")
        i = j + len(name)
    return mangled[:48]


# phase 25: (H, C, forwards a step, BatchNorms) of the 256^2 training step's
# BatchNorms: the 16 blocks' five at their expand width (4 blocks a shape),
# run forward twice under rc_remat; the 4 skips' once
BN_SHAPES = ((256, 24, 2, 20), (128, 48, 2, 20), (64, 96, 2, 20), (32, 192, 2, 20),
             (256, 12, 1, 1), (128, 24, 1, 1), (64, 48, 1, 1), (32, 96, 1, 1))
BN_BATCH = 128


def _bn_case(B, H, C, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    off = torch.linspace(-2.0, 3.0, C, device=dev)
    x = (torch.randn(B, H, H, C, generator=g, device=dev) * 2 + off).to(dtype)
    dy = torch.randn(B, H, H, C, generator=g, device=dev).to(dtype)
    w = torch.rand(C, generator=g, device=dev) + 0.5
    b = torch.rand(C, generator=g, device=dev) - 0.5
    return x, dy, w, b


def _fwd_bwd(fn, x, dy, w, b):
    """(y, dx, dw, db) of ``fn(x, w, b) -> y`` and its autograd backward."""
    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, w, b))
    y = fn(xr, wr, br)
    y.backward(dy)
    return y, xr.grad, wr.grad, br.grad


def _fwd_bwd_graph_ms(fn, x, dy, w, b) -> tuple[float, float]:
    """(forward, forward + backward) device milliseconds of ``fn(x, w, b)
    -> y`` and its autograd backward, each captured 4 times in a CUDA graph
    (the host's launch and autograd time out of it)."""
    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, w, b))

    def fwd_bwd():
        xr.grad = wr.grad = br.grad = None
        fn(xr, wr, br).backward(dy)

    with torch.no_grad():
        f_ms = graph_ms(lambda: fn(x, w, b), iters=10, calls=4)
    return f_ms, graph_ms(fwd_bwd, iters=10, calls=4)


BN_EPS = 1e-5
# SegFormer-B5's head at 1024^2, B=8: the fused 768 channels over c1's 256^2
# grid (96 16-byte vectors a period, against at most 24 at LM-Net's widths)
BN_HEAD = (8, 256, 768)


def _bn_kernel(x, w, b):
    from lmnet_tpu_torch.ops.bn_train import batch_norm_train

    return batch_norm_train(x, w, b, BN_EPS)[0]


def _bn_plain(x, w, b):
    from lmnet_tpu_torch.ops.bn_train import batch_norm_train_plain

    return batch_norm_train_plain(x, w, b, BN_EPS)[0]


def bn_against_plain(x, dy, w, b, where) -> float:
    """The BatchNorm kernels' statistics, y, dx, dgamma and dbeta against the
    plain version's on the same bf16 tensors (phase 25's tolerances); the
    worst |y|, |dx| error."""
    from lmnet_tpu_torch.ops.bn_train import batch_norm_train, batch_norm_train_plain

    got = _fwd_bwd(_bn_kernel, x, dy, w, b)
    want = _fwd_bwd(_bn_plain, x, dy, w, b)
    with torch.no_grad():
        _, mean, var = batch_norm_train(x, w, b, BN_EPS)
        _, wmean, wvar = batch_norm_train_plain(x, w, b, BN_EPS)
    ms = x.float().square().mean((0, 1, 2))
    check(bool(((mean - wmean).abs() <= 1e-5 * ms.sqrt()).all())
          and bool(((var - wvar).abs() <= 1e-5 * ms).all()),
          f"phase 25: bn_train statistics {where}")
    worst = 0.0
    for name, gt, wt in zip(("y", "dx"), got[:2], want[:2]):
        err = (gt.float() - wt.float()).abs()
        worst = max(worst, err.max().item())
        check(bool((err <= 2**-7 * wt.float().abs() + 1e-3).all()),
              f"phase 25: bn_train {name} {where}: {err.max().item()}")
    for name, gt, wt in zip(("dgamma", "dbeta"), got[2:], want[2:]):
        err = (gt - wt).abs().max().item()
        # the same bf16 dy and x on both sides: float32 sums of B H^2
        # products in another order, within 1e-4 of the largest entry
        check(err <= 1e-4 * wt.abs().max().item(),
              f"phase 25: bn_train {name} {where}: {err}")
    return worst


def bn_head_check(dev) -> tuple[float, tuple[int, int]]:
    """Phase 25 at SegFormer-B5's head (``BN_HEAD``, bf16): the kernels
    against the plain version, forward and backward. Returns the worst
    |y|, |dx| error and the (forward, backward) launches, which must be
    the check's own (2, 1): the kernels ran, nothing gave way to another
    composition."""
    from lmnet_tpu_torch.ops.bn_train import batch_norm_train, batch_norm_train_backward

    B, H, C = BN_HEAD
    before = (batch_norm_train.launches, batch_norm_train_backward.launches)
    worst = bn_against_plain(*_bn_case(B, H, C, torch.bfloat16, dev, seed=2),
                             f"at SegFormer-B5's head B={B} H={H} C={C}")
    torch.cuda.synchronize()
    launches = (batch_norm_train.launches - before[0],
                batch_norm_train_backward.launches - before[1])
    check(launches == (2, 1), f"phase 25: bn_train launches at SegFormer-B5's head {launches}")
    torch.cuda.empty_cache()
    return worst, launches


def phase_bn_train(dev, card_line) -> dict:
    """Phase 25: the train-mode BatchNorm kernels against the plain version
    and timed at the train cell's shapes (see the module docstring)."""
    import torch.nn.functional as F

    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.models import LMNet
    from lmnet_tpu_torch.ops.bn_train import batch_norm_train, batch_norm_train_backward
    from lmnet_tpu_torch.train import create_train_state, train_step

    def library(x, w, b):  # F.batch_norm on the NCHW view (channels_last), training
        return F.batch_norm(x.permute(0, 3, 1, 2), None, None, w, b, True, 0.1,
                            BN_EPS).permute(0, 2, 3, 1)

    worst = max(bn_against_plain(*_bn_case(2, H, C, torch.bfloat16, dev), f"at B=2 H={H} C={C}")
                for H, C, _, _ in BN_SHAPES)
    print(f"phase 25: bn_train against the plain version at the 8 BatchNorm shapes of the 256^2 "
          f"step (B=2, bf16): statistics, y, dx, dgamma, dbeta within tolerance; worst |y|, "
          f"|dx| error {worst:.3g}")
    worst_h, head_launches = bn_head_check(dev)
    worst = max(worst, worst_h)
    print(f"phase 25: bn_train against the plain version at SegFormer-B5's head (B={BN_HEAD[0]}, "
          f"{BN_HEAD[1]}^2, C={BN_HEAD[2]}, bf16): statistics, y, dx, dgamma, dbeta within "
          f"tolerance; worst |y|, |dx| error {worst_h:.3g}; {head_launches[0]} forwards, "
          f"{head_launches[1]} backward launched")

    work = Work()
    step = {"kernel": 0.0, "plain": 0.0, "library": 0.0}
    shapes = []
    worst_b = 0.0
    for H, C, nfwd, count in BN_SHAPES:
        x, dy, w, b = _bn_case(BN_BATCH, H, C, torch.bfloat16, dev, seed=1)
        # the train cell's size, where every thread of the statistics
        # kernels walks its periods four at a time
        worst_b = max(worst_b, bn_against_plain(x, dy, w, b, f"at B={BN_BATCH} H={H} C={C}"))
        torch.cuda.empty_cache()
        nbytes = x.numel() * x.element_size()
        work.add(count * (nfwd * 2 * nbytes + 3 * nbytes), count * (nfwd * 4 + 8) * x.numel())
        row = {"H": H, "C": C, "forwards": nfwd, "bns": count}
        for name, fn in (("kernel", _bn_kernel), ("plain", _bn_plain), ("library", library)):
            f_ms, fb_ms = _fwd_bwd_graph_ms(fn, x, dy, w, b)
            row[name] = {"fwd_ms": round(f_ms, 4), "fwd_bwd_ms": round(fb_ms, 4)}
            step[name] += count * ((nfwd - 1) * f_ms + fb_ms)
        row["kernel"]["fwd_GBs"] = round(3 * nbytes / row["kernel"]["fwd_ms"] / 1e6, 1)
        row["kernel"]["bwd_GBs"] = round(
            5 * nbytes / (row["kernel"]["fwd_bwd_ms"] - row["kernel"]["fwd_ms"]) / 1e6, 1)
        shapes.append(row)
        print(f"phase 25: bn_train {json.dumps(row)}")
        del x, dy
    print(f"phase 25: bn_train against the plain version at the same 8 shapes at B={BN_BATCH} "
          f"(bf16): statistics, y, dx, dgamma, dbeta within tolerance; worst |y|, |dx| error "
          f"{worst_b:.3g}")
    worst = max(worst, worst_b)
    bound_ms, _ = work.bound()
    print(f"phase 25: a 256^2 B={BN_BATCH} training step's 84 + 80 BatchNorm forwards and 84 "
          f"backwards [{card_line}]: kernels {step['kernel']:.2f} ms, bound {bound_ms:.2f} ms "
          f"(bytes), plain {step['plain']:.2f} ms, F.batch_norm {step['library']:.2f} ms")

    model = LMNet(generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                  rc_remat=True)
    state = create_train_state(model, (2, 256, 256, 3), seed=0, device=dev)
    x = torch.randn(2, 256, 256, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    before = (batch_norm_train.launches, batch_norm_train_backward.launches)
    train_step(state, x, (x.mean(-1) > 0).long(), ConfusionAccumulator.init(2, dev))
    torch.cuda.synchronize()
    launches = (batch_norm_train.launches - before[0],
                batch_norm_train_backward.launches - before[1])
    check(launches == (84 + 80, 84), f"phase 25: bn_train launches of a train_step {launches}")
    print(f"phase 25: a bf16 256^2 train_step (B=2, rc_remat): bn_train {launches[0]} forwards, "
          f"{launches[1]} backwards")
    del model, state
    return {"max_abs_err": worst, "ms": step["kernel"], "plain_ms": step["plain"],
            "library_ms": step["library"], "work": work, "shapes": shapes,
            "launches": {"train_step": sum(launches), "segformer_head": sum(head_launches)}}


# phase 26: (rows an image, C, LayerNorms a forward) of the train cells'
# LayerNorms, and their batch: SegFormer-B5 at 1024^2 (its stages' maps
# 256^2 .. 32^2: two a block, the patch embedding's, the stage end's; the
# reductions' 32^2 maps at sr 8, 4, 2) and LM-Net at 256^2 (two a NATT
# block at 256^2 .. 32^2, two in the GFT at 16^2)
LN_CELLS = {
    "segformer-b5-1024": (8, 1e-6, ((65536, 64, 8), (16384, 128, 14), (4096, 320, 82),
                                    (1024, 512, 8), (1024, 64, 3), (1024, 128, 6),
                                    (1024, 320, 40))),
    "lmnet-256": (128, 1e-5, ((65536, 12, 2), (16384, 24, 2), (4096, 48, 2), (1024, 96, 2),
                              (256, 372, 2))),
}


def _ln_case(rows, C, dtype, dev, seed=0):
    """Rows with their own offset, as a residual stream's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    off = torch.linspace(-3.0, 3.0, rows, device=dev)[:, None]
    x = (torch.randn(rows, C, generator=g, device=dev) * 2 + off).to(dtype)
    dy = torch.randn(rows, C, generator=g, device=dev).to(dtype)
    w = torch.rand(C, generator=g, device=dev) + 0.5
    b = torch.rand(C, generator=g, device=dev) - 0.5
    return x, dy, w, b


def ln_against_plain(x, dy, w, b, eps, where) -> float:
    """The LayerNorm kernels' y, dx, dweight and dbias on bf16 tensors
    against the plain version's on their float32 copies (the bf16
    composition rounds two partial gradients of x before it adds them;
    tests/test_torch_layer_norm.py's tolerances: y and dx within a bf16
    rounding, 2**-8 of the entry, plus 1e-4 of the largest; dweight and
    dbias within 1e-4 of the largest); the worst |y|, |dx| error."""
    from lmnet_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain

    got = _fwd_bwd(lambda *a: layer_norm(*a, eps), x, dy, w, b)
    want = _fwd_bwd(lambda *a: layer_norm_plain(*a, eps), x.float(), dy.float(), w, b)
    worst = 0.0
    for name, gt, wt in zip(("y", "dx", "dweight", "dbias"), got, want):
        err = (gt.float() - wt).abs()
        top = wt.abs().max().item()
        if name in ("y", "dx"):
            worst = max(worst, err.max().item())
            ok = bool((err <= 2**-8 * wt.abs() + 1e-4 * top).all())
        else:
            ok = err.max().item() <= 1e-4 * top
        check(ok, f"phase 26: layer_norm {name} {where}: {err.max().item()} (largest {top})")
    return worst


def ln_main_path(dev) -> dict:
    """The LayerNorm kernels' (forwards, backwards) on the main path
    (phase 26; see the module docstring), each checked exactly."""
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.models import LMNet, SegFormer
    from lmnet_tpu_torch.ops.layer_norm import layer_norm, layer_norm_backward
    from lmnet_tpu_torch.train import create_train_state, train_step

    def counted(fn):
        before = (layer_norm.launches, layer_norm_backward.launches)
        fn()
        torch.cuda.synchronize()
        return (layer_norm.launches - before[0], layer_norm_backward.launches - before[1])

    got = {}
    model = LMNet(generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                  rc_remat=True)
    state = create_train_state(model, (2, 256, 256, 3), seed=0, device=dev)
    x = torch.randn(2, 256, 256, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    got["lmnet_train_step"] = counted(lambda: train_step(
        state, x, (x.mean(-1) > 0).long(), ConfusionAccumulator.init(2, dev)))
    del model, state
    seg = SegFormer(generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16).to(dev)
    x = torch.randn(1, 256, 256, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)

    def step(train):
        seg(x, train=train, generator=gen).sum().backward()

    got["segformer_eager"] = counted(lambda: step(False))
    got["segformer_graphed_first"] = counted(lambda: step(True))
    got["segformer_graphed_replay"] = counted(lambda: step(True))
    del seg
    torch.cuda.empty_cache()
    n = 161  # SegFormer-B5's: 104 in the blocks, 49 after the reductions, 4 + 4
    want = {"lmnet_train_step": (10, 10), "segformer_eager": (n, n),
            "segformer_graphed_first": (3 * n, 2 * n), "segformer_graphed_replay": (0, 0)}
    check(got == want, f"phase 26: layer_norm launches on the main path {got}, want {want}")
    print(f"phase 26: layer_norm (forwards, backwards) on the main path: {json.dumps(got)}")
    return {k: sum(v) for k, v in got.items()}


def phase_layer_norm(dev, card_line) -> dict:
    """Phase 26: the LayerNorm kernels against the plain version and timed
    at the train cells' shapes (see the module docstring)."""
    import torch.nn.functional as F

    from lmnet_tpu_torch.ops.layer_norm import layer_norm, layer_norm_backward, layer_norm_plain

    main_path = ln_main_path(dev)
    worst, work, shapes, steps = 0.0, Work(), [], {}
    before = (layer_norm.launches, layer_norm_backward.launches)
    checks = 0
    for cell, (B, eps, cases) in LN_CELLS.items():
        step = {"kernel": 0.0, "plain": 0.0, "library": 0.0, "bound": 0.0}

        def library(x, w, b, eps=eps):  # F.layer_norm, its affine in x's dtype
            return F.layer_norm(x, x.shape[-1:], w.to(x.dtype), b.to(x.dtype), eps)

        fns = (("kernel", lambda x, w, b, eps=eps: layer_norm(x, w, b, eps)),
               ("plain", lambda x, w, b, eps=eps: layer_norm_plain(x, w, b, eps)),
               ("library", library))
        for rows, C, count in cases:
            x, dy, w, b = _ln_case(B * rows, C, torch.bfloat16, dev, seed=rows + C)
            worst = max(worst, ln_against_plain(x, dy, w, b, eps,
                                                f"at {cell} B={B} rows={rows} C={C}"))
            checks += 1
            nbytes = x.numel() * x.element_size()
            work.add(count * 5 * nbytes, count * 20 * x.numel())
            bound_fwd, bound_bwd = 2 * nbytes / HBM_RATE * 1e3, 3 * nbytes / HBM_RATE * 1e3
            row = {"cell": cell, "rows": B * rows, "C": C, "count": count,
                   "bound_fwd_ms": round(bound_fwd, 5), "bound_bwd_ms": round(bound_bwd, 5)}
            for name, fn in fns:
                f_ms, fb_ms = _fwd_bwd_graph_ms(fn, x, dy, w, b)
                row[name] = {"fwd_ms": round(f_ms, 5), "fwd_bwd_ms": round(fb_ms, 5),
                             "fwd_share": round(100 * bound_fwd / f_ms, 1),
                             "bwd_share": round(100 * bound_bwd / (fb_ms - f_ms), 1)}
                step[name] += count * fb_ms
            step["bound"] += count * (bound_fwd + bound_bwd)
            shapes.append(row)
            print(f"phase 26: layer_norm {json.dumps(row)}")
            del x, dy
            torch.cuda.empty_cache()
        steps[cell] = {k: round(v, 4) for k, v in step.items()}
        print(f"phase 26: {cell}'s LayerNorms a B={B} step, each forward and backward once "
              f"[{card_line}]: kernels {step['kernel']:.3f} ms, bound {step['bound']:.3f} ms "
              f"(bytes; {100 * step['bound'] / step['kernel']:.1f} % of it), plain "
              f"{step['plain']:.3f} ms, F.layer_norm {step['library']:.3f} ms")
    torch.cuda.synchronize()
    # the checks' own launches; the timing's captures count once more each
    launches = (layer_norm.launches - before[0], layer_norm_backward.launches - before[1])
    check(launches[0] >= checks and launches[1] >= checks,
          f"phase 26: layer_norm launches {launches} for {checks} checked shapes")
    print(f"phase 26: layer_norm against the plain version at {checks} shapes (bf16): y, dx, "
          f"dweight, dbias within tolerance; worst |y|, |dx| error {worst:.3g}; launches "
          f"{launches[0]} forwards, {launches[1]} backwards")
    return {"max_abs_err": worst, "ms": sum(s["kernel"] for s in steps.values()),
            "plain_ms": sum(s["plain"] for s in steps.values()),
            "library_ms": sum(s["library"] for s in steps.values()), "work": work,
            "shapes": shapes, "steps": steps,
            "launches": {**main_path, "phase_26": sum(launches)}}


def ptxas_report(log: str) -> list[str]:
    """'kernel: N registers, S bytes spill stores, L bytes spill loads' for
    each kernel in nvcc's -Xptxas=-v messages."""
    import re

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"{m.group(1)} bytes spill stores, {m.group(2)} bytes spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill or 'spills not reported'}")
            name, spill = None, ""
    return out


def tensor_core_count(lib_path) -> str:
    """The number of HMMA and HGMMA instructions in a built library's SASS,
    by cuobjdump (the CUDA toolkit's, or Triton's copy), or 'cuobjdump not
    found'."""
    import importlib.util
    import shutil
    from pathlib import Path

    from lmnet_tpu_torch.ops import _build

    candidates = [shutil.which("cuobjdump"), str(Path(_build.nvcc()).parent / "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        candidates.append(str(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump"))
    tool = next((c for c in candidates if c and Path(c).is_file()), None)
    if tool is None:
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout
    words = sass.split()
    hmma = sum(w.startswith("HMMA") for w in words)
    hgmma = sum(w.startswith("HGMMA") for w in words)
    return f"{hmma} HMMA and {hgmma} HGMMA instructions (cuobjdump -sass, {tool})"


def entry(name, source, replaces, launches, numbers, work, **extra):
    """One kernel of the kernels line."""
    bound_ms, bound_by = work.bound()
    return {"name": name, "route": "cuda", "source": f"lmnet_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["ms"], "plain_ms": numbers["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": numbers.get("library_ms"),
            "bound_terms_ms": work.terms(), **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    from lmnet_tpu_torch.ops import _build

    card_line = card()
    dev = torch.device("cuda")
    print(f"phase 1: device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"[{card_line}] torch {torch.__version__} cuda {torch.version.cuda}")

    t_start = t0 = time.perf_counter()
    logs = _build.build(*KERNELS)
    for name in KERNELS:
        _build.load(name)
    print(f"phase 2: {', '.join(KERNELS)} built in parallel from {_build.CSRC} -> "
          f"{', '.join(_build.library_path(n).name for n in KERNELS)} "
          f"in {time.perf_counter() - t0:.2f}s")
    for name in ("nat_fwd", "nat_bwd", "rc_fused", "rc_dw_gelu", "rc_stats", "natt_flat",
                 "nat_kernel", "upsample_flat", "bn_train", "layer_norm"):
        for line in ptxas_report(logs.get(name, "")) or ["(built earlier; no report)"]:
            print(f"phase 2: ptxas {name}.cu {line}")
    for name in ("rc_fused", "natt_flat"):
        print(f"phase 2: {name}'s library: {tensor_core_count(_build.library_path(name))}")

    seconds = {"2": round(time.perf_counter() - t0, 1)}

    bn_paths = {}  # the BatchNorm kernels' launches in this process, by phase
    ln_paths = {}  # the LayerNorm kernels' likewise

    def timed(n, fn, *args):
        """``fn(*args)``, its wall seconds kept as phase ``n``'s, and the
        BatchNorm and LayerNorm kernels' launches in this process under its
        name."""
        t = time.perf_counter()
        bn0, ln0 = _bn_total(), _ln_total()
        out = fn(*args)
        seconds[str(n)] = round(time.perf_counter() - t, 1)
        bn_n, ln_n = _bn_total() - bn0, _ln_total() - ln0
        name = fn.__name__.removeprefix("phase_")
        if bn_n and n != 25:  # phase 25 reports its own
            bn_paths[name] = bn_n
        if ln_n and n != 26:  # phase 26 likewise
            ln_paths[name] = ln_n
        return out

    worst = timed(3, phase_kernel_vs_plain, dev)
    model = seeded_model(dev)
    deploy, serve_launches, xb = timed(4, phase_serving, model, dev)
    k_ms, p_ms, worst_timed, b1_work, b1_stages = timed(5, phase_times, deploy, xb, card_line)
    del deploy, xb
    worst_bwd = timed(6, phase_bwd_vs_plain, dev)
    launches = timed(7, phase_training, dev)
    timed(8, phase_flat_vs_plain_step, dev)
    kb_ms, pb_ms, worst_bwd_timed, b2_work, b2_stages = timed(9, phase_train_times, dev,
                                                              card_line)
    worst_rc = timed(10, phase_rc_kernels, dev)
    rc_serve_launches, rc_timed, rc_work = timed(11, phase_rc_serving, model, dev, card_line)
    rc_train_launches, stats_timed, b6_work, b6_shapes = timed(12, phase_rc_training, dev,
                                                               card_line)
    b3, b3_work, b3_launches = timed(13, phase_b3, model, dev, card_line)
    b7, b7_work, b7_launches = timed(14, phase_b7, model, dev, card_line)
    timed(15, phase_options, model, dev, card_line)
    b8, b8_work, b8_launches, b8_stages = timed(16, phase_b8, model, dev, card_line)
    del model
    import tempfile
    from pathlib import Path

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_export_", dir=build) as tmp:
        cli_export_path = Path(tmp) / "cli.pt2"
        cli = timed(17, phase_cli, dev, card_line, cli_export_path)
        options = timed(18, phase_model_options, dev, card_line)
        served = timed(19, phase_export_daemon, dev, card_line, cli.pop("export"),
                       cli_export_path)
    ddp = timed(20, phase_ddp, dev, card_line)
    spatial = timed(21, phase_spatial, dev, card_line)
    convergence = timed(22, phase_convergence, dev, card_line)
    multihost = timed(23, phase_multihost, dev, card_line, ddp.pop("refs"))
    bench = timed(24, phase_bench, dev, card_line)
    bn = timed(25, phase_bn_train, dev, card_line)
    ln = timed(26, phase_layer_norm, dev, card_line)
    # the BatchNorm kernels on every training path: this process's phases,
    # and the children of phases 20-23 (their ranks, CLI runs and draws)
    bn["launches"].update(bn_paths, ddp_ranks=ddp["bn"]["ddp"], ddp_cli=ddp["bn"]["ddp_cli"],
                          spatial_ranks=spatial["bn"], convergence_draws=convergence["bn"],
                          multihost_ranks=multihost["bn"])
    need = ("flat_vs_plain_step", "model_options", "ddp_ranks", "ddp_cli", "spatial_ranks",
            "convergence_draws", "multihost_ranks", "bench")
    print(f"chip_smoke: bn_train launches by path {json.dumps(bn['launches'])}")
    check(all(bn["launches"].get(k, 0) > 0 for k in need)
          and all(v >= 0 for v in bn["launches"].values()),
          f"a training path never launched the BatchNorm kernels: {bn['launches']}")
    ln["launches"].update(ln_paths)
    print(f"chip_smoke: layer_norm launches by path {json.dumps(ln['launches'])}")
    check(all(ln["launches"].get(k, 0) > 0
              for k in ("flat_vs_plain_step", "model_options", "bench", "bn_train")),
          f"a training path never launched the LayerNorm kernels: {ln['launches']}")
    convergence, multihost = convergence["launches"], multihost["launches"]
    new_paths = {
        "nat_fwd": {"natt_remat": options["launches"]["natt_remat"]["nat_fwd"],
                    "rc_remat_branches": options["launches"]["branches fused"]["nat_fwd"],
                    "daemon": served["closure"]["b1_launches"]},
        "nat_bwd": {"natt_remat": options["launches"]["natt_remat"]["nat_bwd"],
                    "rc_remat_branches": options["launches"]["branches fused"]["nat_bwd"]},
        "rc_dw_gelu": {"rc_remat_branches": options["launches"]["branches fused"]["rc_dw_gelu"]},
        "rc_stats": {"rc_remat_branches": options["launches"]["branches fused"]["rc_stats"]},
    }
    for k in DDP_KERNELS:  # phase 20: the two ranks' sum, and the NCCL CLI run
        new_paths[k]["ddp"] = ddp["ddp"][k]
        if ddp["ddp_cli"][k]:
            new_paths[k]["ddp_cli"] = ddp["ddp_cli"][k]
    new_paths["rc_fused"] = {}
    new_paths["upsample_flat"] = {}
    for k in ("nat_fwd", "nat_bwd", *RC_KERNELS, "upsample_flat"):  # phase 21: the ranks' sum
        new_paths[k]["spatial"] = spatial["spatial"][k]
    for k in ("nat_fwd", "nat_bwd", *RC_KERNELS, "upsample_flat"):  # phase 22
        new_paths[k]["convergence"] = convergence[k]
    b3_launches["convergence"] = convergence["nat_kernel"]
    for k in DDP_KERNELS:  # phase 23: every rank of both two-node runs
        new_paths[k]["multihost"] = multihost[k]
    for k in ("nat_fwd", "nat_bwd"):  # phase 24: the timed protocol, and checks (c), (d)
        new_paths[k]["bench"] = bench["launches"][k]
        new_paths[k]["bench_checks"] = bench["checks"][k]
    cli_f = (cli["cli"]["nat_fwd"] + cli["train_augment"]["nat_fwd"]
             + sum(new_paths["nat_fwd"].values()))
    cli_b = (cli["cli"]["nat_bwd"] + cli["train_augment"]["nat_bwd"]
             + sum(new_paths["nat_bwd"].values()))

    def rc_numbers(k, extra):
        return {"max_abs_err": max(worst_rc[k], extra[0],
                                   *(s["max_abs_err"] for s in spatial["slabs"][k])),
                "ms": extra[1], "plain_ms": extra[2]}

    print(f"chip_smoke: wall seconds a phase {json.dumps(seconds)}")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s wall")
    print(json.dumps({"kernels": [
        entry("nat_fwd", "nat_fwd.cu", "lmnet_tpu/ops/pallas/nat_flat.py:249",
              launches["nat_fwd"] + serve_launches + cli_f,
              {"max_abs_err": max(worst, worst_timed, bench["worst_fwd"],
                                  *(s["max_abs_err"] for s in spatial["slabs"]["nat_fwd"])),
               "ms": k_ms, "plain_ms": p_ms}, b1_work, ms_by_slab=spatial["slabs"]["nat_fwd"],
              launches_by_path={"training": launches["nat_fwd"], "serving": serve_launches,
                                "cli": cli["cli"]["nat_fwd"],
                                "train_augment": cli["train_augment"]["nat_fwd"],
                                **new_paths["nat_fwd"]},
              ms_by_stage=b1_stages),
        entry("nat_bwd", "nat_bwd.cu", "lmnet_tpu/ops/pallas/nat_flat.py:563",
              launches["nat_bwd"] + cli_b,
              {"max_abs_err": max(worst_bwd, worst_bwd_timed, bench["worst_bwd"],
                                  *(s["max_abs_err"] for s in spatial["slabs"]["nat_bwd"])),
               "ms": kb_ms, "plain_ms": pb_ms},
              b2_work, ms_by_stage=b2_stages, ms_by_slab=spatial["slabs"]["nat_bwd"],
              launches_by_path={"training": launches["nat_bwd"], "cli": cli["cli"]["nat_bwd"],
                                "train_augment": cli["train_augment"]["nat_bwd"],
                                **new_paths["nat_bwd"]}),
        entry("nat_kernel", "nat_kernel.cu", "lmnet_tpu/ops/pallas/nat_kernel.py:231",
              sum(b3_launches.values()), b3, b3_work, launches_by_path=b3_launches,
              graph_ms=b3["graph_ms"], nat_fwd_ms=b3["nat_fwd_ms"],
              nat_fwd_graph_ms=b3["nat_fwd_graph_ms"], ms_by_stage=b3["ms_by_stage"]),
        entry("rc_fused", "rc_fused.cu", "lmnet_tpu/ops/pallas/rc_kernel.py:145",
              rc_serve_launches["rc_fused"] + sum(new_paths["rc_fused"].values()),
              rc_numbers("rc_fused", rc_timed["rc_fused"]),
              rc_work["rc_fused"], xla_ms=rc_timed["rc_fused"][3],
              launches_by_path={"serving": rc_serve_launches["rc_fused"],
                                **new_paths["rc_fused"]},
              ms_by_slab=spatial["slabs"]["rc_fused"]),
        entry("rc_dw_gelu", "rc_dw_gelu.cu", "lmnet_tpu/ops/pallas/rc_flat.py:119",
              rc_serve_launches["rc_dw_gelu"] + rc_train_launches["rc_dw_gelu"]
              + sum(new_paths["rc_dw_gelu"].values()),
              rc_numbers("rc_dw_gelu", rc_timed["rc_dw_gelu"]), rc_work["rc_dw_gelu"],
              launches_by_path={"serving": rc_serve_launches["rc_dw_gelu"],
                                "training": rc_train_launches["rc_dw_gelu"],
                                **new_paths["rc_dw_gelu"]},
              xla_ms=rc_timed["rc_dw_gelu"][3], ms_by_slab=spatial["slabs"]["rc_dw_gelu"]),
        entry("rc_stats", "rc_stats.cu", "lmnet_tpu/ops/pallas/rc_train.py:140",
              rc_train_launches["rc_stats"] + sum(new_paths["rc_stats"].values()),
              rc_numbers("rc_stats", stats_timed), b6_work,
              launches_by_path={"training": rc_train_launches["rc_stats"],
                                **new_paths["rc_stats"]},
              xla_ms=stats_timed[3], ms_by_stage=b6_shapes,
              ms_by_slab=spatial["slabs"]["rc_stats"]),
        entry("upsample_flat", "upsample_flat.cu", "lmnet_tpu/ops/pallas/upsample_flat.py:148",
              sum(b7_launches.values()) + sum(new_paths["upsample_flat"].values()),
              {**b7, "max_abs_err": max(b7["max_abs_err"], *(
                  s["max_abs_err"] for s in spatial["slabs"]["upsample_flat"]))},
              b7_work, launches_by_path={**b7_launches, **new_paths["upsample_flat"]},
              graph_ms=b7["graph_ms"], graph10_ms=b7["graph10_ms"], host_us=b7["host_us"],
              ms_by_call=b7["ms_by_call"], ms_by_slab=spatial["slabs"]["upsample_flat"]),
        entry("natt_flat", "natt_flat.cu", "lmnet_tpu/ops/pallas/natt_flat.py:265",
              b8_launches, b8, b8_work, unfused_ms=b8["unfused_ms"], ms_by_stage=b8_stages),
        entry("bn_train", "bn_train.cu", None, sum(bn["launches"].values()), bn, bn["work"],
              launches_by_path=bn["launches"], ms_by_shape=bn["shapes"]),
        entry("layer_norm", "layer_norm.cu", None, sum(ln["launches"].values()), ln, ln["work"],
              launches_by_path=ln["launches"], ms_by_shape=ln["shapes"], ms_by_step=ln["steps"]),
    ]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    # phase 20's and 21's children, started by torchrun: a rank of the 2-rank
    # run, the CLI under --distributed, or a rank of the sharded run; phase
    # 22's, one draw of a convergence arm; phase 23's, a rank of a node
    if sys.argv[1:2] == ["--ddp-rank"]:
        sys.exit(ddp_rank_main(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--cli-rank"]:
        sys.exit(cli_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--spatial-rank"]:
        sys.exit(spatial_rank_main(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--mh-rank"]:
        sys.exit(mh_rank_main(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--convergence-draw"]:
        sys.exit(convergence_draw_main(*sys.argv[2:6]))
    sys.exit(main())
