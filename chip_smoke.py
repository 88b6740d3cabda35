#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --phase model_mesh`` (or ``zoo_mesh``) builds the
kernels, runs the flash checks and then phase 3n (or 3o) alone with its
phase 5 rows.

Phases (any failure exits non-zero; nothing is caught and passed over).
After phase 3b two side processes on the same card (``--side a`` and
``--side b``, started by the whole run) take phases 3e, 3g, 3h and 4,
which drive small tasks and leave the card idle most of the time, while
this process runs phases 3c, 3m, 3f, 3g's full-width top-k run, 3n and 3i;
the side processes' logs follow, and a side process that fails fails the
run. The phases that time or profile the device (3j, 3k, 3l, 3o, 5, 6)
come after both have ended. A card whose compute mode takes one process
runs the side phases in this process instead.

1. probe — the card's name and power limit, CUDA and nvcc versions; build
   the hand-written kernels from ``src/repro_torch/csrc`` and time the build
   (a build in which ptxas serialized any ``wgmma`` fails the run); the
   registers, shared memory and local memory (spills) of each flash
   kernel and of the L1 rows, fused assign, ingest chain, chi2, merge and uplink encode kernels from
   ``cuobjdump --dump-resource-usage`` (the chain in both instantiations,
   with and without the guard's norm statistic), the ingest chain's launch
   plan (grid, dynamic shared memory, rows on chip) at the paths' shapes, and a check of
   each flash kernel's SASS for tensor-core instructions: ``HMMA`` in the
   fp32 ones, ``HGMMA`` (wgmma) and no TF32 ``HMMA`` in the bf16 ones, whose
   dynamic shared memory it prints too (a missing one, a spill at head width
   64 (fp32) or up to 128 (bf16), or an L1, assign, chain, chi2, merge,
   encode or RNN kernel that spills fail the run; ``flash_fwd_kernel<256>``'s,
   which phase 3j's prefill runs, on a line of its own; the broadcast RNN
   kernel's dynamic shared memory and scratch at windows of 10 and 128);
2. kernels — every kernel wrapper against its plain PyTorch version on the
   card, at the main path's widths and at edge shapes; the L1 sums' fixed
   order at N % 4 = 0, 1, 2, 3, N = 1 and N = 783,360 (bitwise across
   repeats, entry points, places and alignments, ties to the first index, a
   NaN row winning the argmin); the chi2 kernel's fixed order, g and segment
   sums bitwise the numpy model's (``tests/test_torch_chi2_order.py``) at
   M = 1, 20, 300, 2049, J = 2, 10, 16, 200 and S = 0, 1, 4, 300, and across
   repeats; the merge kernel bitwise its plain version at N = 1, 2304, 4099,
   4550, 25,418, 783,360 and 4,000,000 (past one grid step), on NaN, inf,
   all-negative and signed-zero inputs, in place on a plane row of odd index
   (8-byte aligned), across repeats, one kernel per call in a profiler trace;
   the coalesced ingest chain (``csrc/ingest_chain.cu``) at (S, C, N) = (1, 1,
   1), (8, 3, 4099), (13, 4, 4550), (32, 4, 25,418), (4, 2, 783,360),
   (40, 16, 25,418), (25, 4, 25,418), (16, 2, 2304), (12, 5, 8193) and
   (3, 1024, 4099), with vetoes, forced ids and a NaN upload: cids, blended
   rows and the carried matrix bitwise the plain version's, distances and
   statistics bitwise the numpy model of the L1 order
   (``tests/test_torch_l1_order.py::kernel_chain``), bitwise across repeats,
   the centers only read, one kernel per call in a profiler trace at every
   shape and no device-to-device copy; and with ``with_stats=True`` (the
   ingest guard's post-blend center norm) at every shape: the four
   statistics bitwise the model's, every other output bitwise the chain's
   without the norm, a NaN upload's norm NaN, one ``ingest_chain_kernel<4>``
   a call; the uplink encodes
   (``csrc/uplink.cu``) bitwise their plain versions at (B, n) = 1, 3, 32 x
   4,550, 25,418, 2,304 and 783,360 (k = round(0.1 n), chunk 512) and at
   n = 1, n % chunk = 1 and k = n, on random, tie, signed-zero, NaN and
   inf rows: reconstruction, anchor and residual rows and the rows they
   must not touch, across 3 repeats, one kernel per call in a profiler
   trace; the broadcast RNN kernel (``csrc/rnn.cu``) against its plain
   version: one SGD step at windows of 10 and 128 records within rtol 1e-6,
   atol 1e-7, 64 decisions a window identical wherever the plain logit
   margin exceeds 1e-5 (those under it counted), chains of 32 steps with
   mixed gates and ragged windows (k = 10, 16, 33, 128) within rtol 1e-5,
   atol 1e-6 under the same margin rule, each one launch and bit for bit
   its steps as per-event launches and its own repeat, the 1,200-state
   pretraining one launch within 4 times its fp32-against-fp64 gap
   (``tests/torch_rnn_model.py``) of the plain pretraining on the card, a
   window past 1,024 records refused, a parent's weights untouched by its
   expanded child's learn; the flash-attention forward and
   backward at the LM paths' shapes and at the model zoo's head widths (up
   to 256), the backward also bitwise across repeats; the forward alone at
   phase 3j's gemma2-2b prefill shapes, (4, 512) and (2, 4,200), each with
   the local layers' window of 4,096 and the global layers' none, and at
   phase 3k's MLA prefill shape (2, 16, 512, 192, value width 128, scale
   192 ** -0.5); forward and backward at hubert-xlarge's non-causal heads
   (2, 16, 200, 80) and at phase 3l's training shape (2, 32, 4,096, 64,
   8 KV heads);
3. main path — ``repro_torch.fl.experiment.run_experiment("image_recognition",
   "echopfl", num_clients=20, max_time=1500, seed=0)`` on the card and, only
   if that run makes no merge, the same run with ``hm=1.0``; launch counts
   are zeroed just before and read just after, and every kernel of the
   per-event path must launch (``l1_distance`` exactly twice an upload and
   once more a broadcast decision: the predictor's L1 statistics, ``l1_vec``
   on the card; ``rnn_chain`` once a pretraining, a learn and an RNN
   decision, each ``pretrain_rnn`` exactly one launch); host time is summed
   per layer;
3d. coalesced path — the same model coalesced: 128 clients, a 45 s window,
   ``refine_every=32``, 800 uploads, seed 0, the broadcast RNN of phase 3
   handed over; uploads per wall second, the arrival batches, the segments
   and the launch counts; ``ingest_chain`` must launch on segments longer
   than 1 and every kernel of the per-event path too; each predictor chain
   (a touched cluster a sub-window) is one ``rnn_chain`` launch, and so is
   each learn and RNN decision outside a chain;
3b. LM path — ``repro_torch.fl.lm_task.run_lm_experiment("echopfl",
   num_clients=8, max_time=900, eval_interval=120, seed=0)`` on ``tiny_lm``:
   its own launch counts (the flash kernels and the server's assign chain
   must launch), host time per layer, and the training NLL of every
   client's last upload below that of its first;
3c. full width — the same run over a ``llama3.2-1b`` base drawn on the card
   (4 clients, seq_len 256, one local epoch, 720 s): flash kernels at
   ``(4, 32, 256, 64)``, wall time per upload, peak device memory;
3m. the sharded plane — (a) phase 3's merging run (``hm=1.0``, phase 3's
   RNN) with the server's plane on an 8-row-shard mesh of the one card
   (``make_plane_mesh(8, devices=[cuda:0] * 8)``), ``mesh_min_rows=0``, and
   the client fleet on a 4-shard mesh, then with the plane mesh alone,
   each against the same run without meshes: events, assignments, client
   versions, ``stats()`` (the feedback means, from segment sums added over
   shards, within 1 ulp), final accuracy and curve identical and every
   center bit for bit; launches by kernel name and the sharded calls, each
   sharded call 8 launches (``l1_distance`` 8 a sharded assign beside the
   predictor's 2 an upload and 1 a decision, the fused assign none), the
   merge in place; (b) phase 3c's run on a 4 x 2 (rows x model dim) mesh,
   the 783,360-float row in two 391,680-float chunks, against the same run
   without a mesh: identical decisions, centers bit for bit, the assign's
   distances bit for bit the two chunks' L1 in the kernel's order added in
   chunk order, and their largest gap in ulps from the single device's;
   each arm's wall time; then each sharded entry point on both meshes,
   first held to its single-device call on the same inputs (bit for bit,
   dim-sharded distances bit for bit the chunk model, segment sums within
   2 ulps), then timed a call beside it, at the main path's most frequent
   shapes and the full width's assign;
3e. the paper's comparison — the reference's Tab. 1 bench at one task and
   seed: all seven strategies on ``image_recognition`` (20 clients, 1800 s,
   at most 40 rounds, seed 0; EchoPFL with phase 3's broadcast RNN handed
   over; FedAsyn and FedSEA also at a 45 s window): final accuracy, the
   slowest and fastest device class's, time to target, ``summary()``,
   ``bytes_until`` the time to target, wall time, uploads or rounds per wall
   second, host time per layer; every run finite with non-zero bytes, and
   the MLP baselines launch none of the port's kernels;
3f. full width on the synchronous loop — ``run_lm_experiment("fedavg")``
   over the ``llama3.2-1b`` base (4 clients, seq_len 256, 4 train / 2 test
   sequences, one local epoch, 3 rounds): one cohort of 4 clients a round,
   so flash at ``(16, 32, 256, 64)``; dq and dkv launch in pairs, every
   client's training NLL falls from its first upload to its last, peak
   device memory;
3g. the paper's comm sweep — the reference's
   ``benchmarks/bench_comm_cost.py::run_compress`` at one task and seed:
   ``har``, 20 clients, 3,600 s, 45 s windows, EchoPFL (phase 3's RNN)
   and FedAsyn, each with no codec, ``topk`` and ``int8``: up/down/total MB,
   ``uplink_ratio``, payload bytes, codec and kernel launches, the cohorts,
   final and tail accuracy, uploads per wall second; a compressed arm bills
   ``up_events x payload_bytes`` and launches its kernel ``codec.launches``
   times, and the uplink's ledger (FedAsyn's downlink too) equals
   ``BENCH_comm_compress.json``'s; then phase 3's per-event
   ``image_recognition`` run (300 s) with each codec: the encode at
   (1, 25,418) once an upload; then phase 3c's full-width run with
   ``uplink="topk"``: the encode at (1, 783,360) once an upload;
3h. chaos — the reference's fault and defense sweeps at rate 0.1, seeds
   0-2, through the port's ``build_clients``, ``build_strategy`` and
   ``Simulator`` (phase 3's RNN handed over): ``benchmarks/bench_faults.py``'s
   retry and drop arms (``har``, 32 clients with 48 samples, 2,400 s, 30 s
   windows) and ``bench_defense.py``'s guard-off and guard-on arms (16
   clients, 1,800 s, per event and at 30 s); every field printed beside
   ``BENCH_faults.json``'s and ``BENCH_defense.json``'s, the fields the live
   reference reproduces (FAULT_EXACT, DEFENSE_EXACT) equal to them; every
   guard-on run ends with finite centers and no NaN accuracy, and its
   coalesced runs launch ``ingest_chain`` with the norm statistic; host time
   per layer, the guard's host copies included;
3j. serving — gemma2-2b at full width (2.61 B parameters, fp32, random
   weights from a card generator seeded 0) through the serving entry point
   (``repro_torch.launch.serve.serve``): (a) batch 4, prompt 512, 32
   tokens and (b) batch 2, prompt 4,200, 16 tokens, whose decode runs past
   the 4,096-token window; the prefill makes one flash forward launch a
   layer (26, head width 256) and the decode none; every decode step's
   logits against a teacher-forced full forward within SERVE_ATOL, the
   tokens its argmax wherever its top-2 margin exceeds that; prefill
   seconds, decode tokens/s and peak memory; a profiled window of 8 decode
   steps (kernels a step, idle share); then the pytree backend:
   ``image_recognition`` per event (20 clients, 300 s, hm 1.0) with
   ``plane_backend="pytree"`` against the plane backend: identical
   ledgers, decisions, stats and centers, and the pytree run's
   ``l1_distance`` and ``merge_attention`` launches;
3k. the model zoo's full-width MoE and MLA arch — deepseek-v2-lite-16b
   (15.7 B parameters, 2.66 B active a token, 58.5 GiB of fp32 weights
   from a card generator seeded 0, depth uncut) through the same serving
   entry point at ZOO_SERVE (batch 2, prompt 512, 16 tokens), after phase
   3j has freed gemma2-2b's weights: (a) MoE dropless, 27 flash forward
   launches a prefill (head width 192 in the 256 bucket, value width 128)
   and none in the decode (MLA's absorbed decode and the MoE dispatch are
   plain PyTorch), every decode step's logits against a teacher-forced
   full forward within SERVE_ATOL under the margin rule; (b) the default
   capacity dispatch (1.25), the same launches, finite logits; prefill
   seconds, decode tokens/s, peak memory, the largest leaf, the tree's
   element count beside ``param_count`` and ``active_param_count``;
3l. training — llama3.2-1b at full width (1.24 B parameters, fp32, AdamW,
   weights from a card generator seeded 0, depth uncut) through the
   training driver's ``repro_torch.launch.train.train`` at train_4k's
   4,096 tokens: one step at batch 1 with remat on and off (the loss and
   every param bit for bit; both peaks), then 8 steps at batch 2 with remat
   (launch counts zeroed just before and read just after: 32 flash forward
   launches a step, each of 16 layers also recomputed, and 16 of each
   backward kernel, all at (2, 32, 4,096, 64); every loss finite, the last
   below the first; s a step, tokens/s, peak memory); the driver's
   checkpoints at reduced llama3.2-1b (stopped at 3 steps, the checkpoint
   the stopped state bit for bit, resumed to 6 twice, identical; bytes,
   save and restore times); the EchoPFL transformer-client example
   (``repro_torch.launch.train_async_pfl``) killed at round 150 and resumed
   to 300 (its own assertion on the killed half and over the whole run, the
   restored server state the saved one bit for bit, launches by name,
   rounds per second);
3n. model meshes — the dense decoders on meshes that repeat the card,
   one process driving every shard (``repro_torch.launch.sharded``):
   llama3.2-1b at full width served (16 x 512, 4 tokens) on the pod mesh
   (16 x 16 = 256 shards) against no mesh (prefill logits within
   SERVE_ATOL, tokens under the margin rule, 16 x 16 x 16 flash forward
   launches at the shard shape (1, 2, 512, 64) over 1 KV head, the mesh
   arm's peak at most 1.25 x the unmeshed arm's: each block lives once on
   the card) and trained (2 steps at 16 x 256, remat) against no mesh
   (losses within 1e-5 relative, first-step gradients within 1e-4 of each
   leaf's max |g|, the launches the mesh and remat predict); reduced
   llama3.2-1b and tiny_lm on the multipod mesh (2 x 16
   x 16) stopped after 2 steps and resumed (bit for bit), and on the smoke
   mesh (bit for bit the unmeshed serve and train); prefill s, decode
   tokens/s, s a step, tokens/s and the peaks;
3o. the zoo on model meshes — the MoE, MLA and recurrent archs on meshes
   that repeat the card (``zoo_mesh_phase``): deepseek-v2-lite-16b at full
   width (depth uncut) served 16 x 256 and two decode steps on the pod mesh
   against no mesh, dropless and at capacity 1.25, routed as the unmeshed
   run (prefill logits within SERVE_ATOL, tokens under the margin rule,
   27 x 16 x 16 flash forward launches at MLA's shard (1, 1, 256, 192),
   value width 128; the idle share of a mesh prefill); one period of
   xlstm-1.3b at full width served 2 x 64 with 4 tokens (logits within
   XLSTM_MESH_ATOL; two planted faults, the sLSTM's ``h`` joined out of
   rank order and the mLSTM's row-parallel ``wq`` against the wrong input
   blocks, must each move the prefill's logits past it); 16 of granite-moe-3b-a800m's 32 layers at full width
   trained 2 steps at 16 x 128 (losses 1e-5 relative, first-step gradients
   1e-4, the flash launches a batch shard and layer); reduced deepseek,
   granite, jamba and xlstm (one period) on the multipod mesh (resume bit
   for bit) and
   the smoke mesh (bit for bit the unmeshed runs);
3i. restart (after phase 3n; its card-against-CPU agreement in side
   process a) — the fault plan's server kill and restore
   (``ServerRestartPlan``): ``tests/test_faults.py``'s run (``har``, 8
   clients with 48 samples, ``uplink="topk"``, faults at seed 5, 900 s,
   killed at 30 uploads) per event and at a 30 s window, and phase 3c's
   full-width ``llama3.2-1b`` run killed at half its uploads; each twice
   uninterrupted and once killed, with the launch counts zeroed before each
   run: the two uninterrupted runs must agree (fields that do not are
   printed and left out) and the killed run must equal them in the
   ledgers, curve, accuracies, events, assignments, the final state bit
   for bit and the kernel and codec launches; the checkpoint's bytes and
   leaves and the times of ``state_dict``, the save, the restore and
   ``load_state``; then an ``image_recognition`` server's checkpoint
   (25,418 floats a row, top-k codec) from the card into a CPU server and
   a CPU server's into a card server, each restore equal to its writer's
   state bit for bit; checkpoints go to a temporary directory the phase
   deletes;
4. agreement — a small ``har`` run and the ``tiny_lm`` LM run on the card
   against the same runs on the CPU, where every wrapper takes its plain
   version; the ``har`` run also coalesced at a 45 s window, card against
   CPU, and at a 1e-9 s window against the per-event run on the card
   (identical events, assignments and centers); ``har`` FedAvg (5 rounds)
   and FedAsyn (900 s, per event and at a 45 s window), card against CPU:
   identical ledgers and stats, accuracy curves within 0.02; compressed
   ``har``: EchoPFL with ``topk`` and ``int8`` per event and at 45 s, FedAvg
   with ``int8`` (5 rounds), card against CPU: identical ledgers,
   ``extra["uplink"]``, events and assignments, curves within 0.02; chaos
   ``har`` (faults at 0.3 plus poison at 0.2, guard on) per event and at
   45 s, card against CPU: identical fault, guard and byte ledgers, events
   and assignments, curves within 0.02; a guard on a clean run on the card
   is the guard-off run bit for bit; phase 3i's coalesced ``har`` restart,
   card against CPU: identical ledgers, events and assignments, curves
   within 0.02; the per-cluster serving example
   (``repro_torch.launch.serve_cluster_models``), card against CPU:
   identical clusters, assignments and events, served logits within
   EXAMPLE_ATOL and tokens equal under the margin rule; ``har`` with the
   pytree backend, card against CPU: identical ledgers, events and
   assignments, curves within 0.02; the model zoo's five reduced archs
   (granite-moe, deepseek-v2-lite, hubert, jamba, xlstm), card against
   CPU: the forward (one flash forward an attention layer), the prefill
   and 8 decode steps fed the same tokens (MoE dropless), one train step
   (the flash backward once an attention layer, the forward once more an
   attention layer that remat recomputes), at ``tests/torch_zoo.py``'s
   tolerances (ZOO_ATOL; xlstm 3 x its one-ulp spread); training: the
   driver at reduced llama3.2-1b and deepseek-v2-lite-16b for 3 steps,
   card against CPU (losses within rtol 1e-5, params by the zoo's rule),
   remat on against off on the card bit for bit, and the transformer-client
   example for 40 rounds, card against CPU (identical arrivals and
   decisions every round, round losses within EXAMPLE_LOSS_RTOL);
5. timing — each kernel, its plain version and (where one exists) a single
   PyTorch call computing the same function, at the shape the main path
   called it with most (the flash kernels and ``pairwise_l1`` at the
   ``tiny_lm`` and the ``llama3.2-1b`` shapes, the flash kernels also at
   phase 3f's cohort shape, the flash forward also at phase 3j's two
   gemma2-2b prefill shapes with its softcap, where no library call
   applies, and at phase 3k's MLA prefill shape beside fp32 SDPA, the
   flash forward and backward at phase 3l's training shape beside fp32
   SDPA's, at phase 3n's per-shard shapes (the forward at the pod
   prefill's, both at the pod training step's) and at phase 3o's (the
   forward at deepseek's MLA shard, both at granite's batch shard),
   ``l1_distance`` and
   ``assign_and_lerp`` also at the full-width run's; the segmented chi2 also
   at the 128-client fleet's refine, (128, 10) with S = 16, and at (1, 1) with
   S = 1, the launch floor; the merge also at ``har``'s, ``tiny_lm``'s and the
   full width's row and at N = 1; the ingest chain at phase 3d's most
   frequent segment shape and at (32, 4, 25,418), beside the per-event
   device work for the same uploads, and at (25, 4, 25,418) with and without
   the guard's norm statistic; the uplink encodes at phase 3g's most
   frequent cohort, at (1, 25,418) and at (1, 783,360), the top-k beside
   ``torch.topk`` on |c|; the broadcast RNN at (S, T) = (1, 10) learn and
   decide, at phase 3d's most frequent chain (its recorded operands) and
   at the (1,200, 10) pretraining, beside ``torch.nn.RNN(1, 128, 2)``
   (cuDNN) forward and backward through a linear output layer, a yardstick
   the port never calls), beside the least time the
   card could take (fp32 on the CUDA cores; for the flash kernels also
   ``bound_tc_ms``, split TF32 on the tensor cores): device time per call from a ``torch.profiler`` trace
   (``ms``, ``plain_ms``, ``library_ms``; the profiler can lose a short
   session's kernels, so a time counts only from two sessions that record
   the same, largest event count) and the per-call time of
   back-to-back calls between CUDA events, host overhead included
   (``call_ms`` and its two siblings; the merge also in place, as the server
   calls it);
6. profile — short runs of the main path (300 s), of the coalesced path
   (300 uploads; the RNN kernels in the trace against their launches), of both LM paths (900 s, 720 s), of phase 3f's
   full-width FedAvg run, of phase 3g's EchoPFL top-k arm (its first
   1,200 s) and of phase 3h's coalesced guard-on defense arm (seed 0,
   1,800 s) under ``torch.profiler``: device busy time, the device's idle
   share and the kernels that take the time.

The last lines are one JSON object with the kernel table, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import atexit
import hashlib
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch.mesh import H100_BF16_FLOPS_PER_S as BF16_FLOPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import H100_FP32_FLOPS_PER_S as FP32_FLOPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import H100_TF32_FLOPS_PER_S as TF32_FLOPS_PER_S  # noqa: E402

DEVICE = "cuda"

KERNELS = {  # row name -> (CUDA source, the TPU kernel's pallas_call it replaces)
    "l1_distance": ("src/repro_torch/csrc/l1.cu", "src/repro/kernels/l1_distance.py:51"),
    "l1_distance_pairwise": ("src/repro_torch/csrc/l1.cu", "src/repro/kernels/l1_pairwise.py:57"),
    "assign_and_lerp": ("src/repro_torch/csrc/assign_lerp.cu", "src/repro/kernels/assign_lerp.py:63"),
    # not a pallas_call: ops.ingest_chain (jit body _ingest_chain_jit, ops.py:446), a lax.scan around l1_distance.py:51
    "ingest_chain": ("src/repro_torch/csrc/ingest_chain.cu", "src/repro/kernels/ops.py:501"),
    "chi2_feedback": ("src/repro_torch/csrc/chi2.cu", "src/repro/kernels/chi2_feedback.py:50"),
    "chi2_feedback_segmented": ("src/repro_torch/csrc/chi2.cu", "src/repro/kernels/chi2_feedback.py:111"),
    "merge_attention": ("src/repro_torch/csrc/merge.cu", "src/repro/kernels/merge_attention.py:68"),
    # not pallas_calls: the jitted cohort encodes of the compressed uplink
    "uplink_int8_encode": ("src/repro_torch/csrc/uplink.cu", "src/repro/fl/uplink.py:141"),
    "uplink_topk_encode": ("src/repro_torch/csrc/uplink.cu", "src/repro/fl/uplink.py:131"),
    # not a pallas_call: ops.predictor_chain's jit body _predictor_chain_jit (a lax.scan of broadcast.py:129
    # rnn_chain_step), with broadcast.py:71 _rnn_sgd, :81 _rnn_want and pretrain_rnn's _rnn_sgd loop (:258)
    "rnn_chain": ("src/repro_torch/csrc/rnn.cu", "src/repro/kernels/ops.py:541"),
    "pairwise_l1": ("src/repro_torch/csrc/l1.cu", "src/repro/kernels/l1_distance.py:65"),
    "flash_attention_fwd": ("src/repro_torch/csrc/flash_fwd.cu", "src/repro/kernels/flash_attention.py:127"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_bwd.cu", "src/repro/kernels/flash_attention_bwd.py:176"),
}
L1_WIDTHS = (25418, 4550, 4099, 783360, 1, 4097)  # N % 4 = 2, 2, 3, 0, 1, 1
# where a row's function also runs: the L1 sums are the first phase of the fused assign and of the chain
ALSO_IN = {"l1_distance": "src/repro_torch/csrc/assign_lerp.cu, src/repro_torch/csrc/ingest_chain.cu"}
# the compressed uplink's encodes (phase 3g), launched only by a run with uplink= set
UPLINK_KERNELS = ("uplink_int8_encode", "uplink_topk_encode")
# the per-event MLP path's kernels; the coalesced path (phase 3d) runs them and the chain
MLP_PATH = KERNELS.keys() - {"pairwise_l1", "flash_attention_fwd", "flash_attention_bwd", "ingest_chain",
                             *UPLINK_KERNELS}
COALESCED_PATH = MLP_PATH | {"ingest_chain"}
# ingest chain checks: (S, C, N), with phase 3d's most frequent segment (25, 4, 25418), tiny_lm's one-chunk
# row (16, 2, 2304), a partial tile across three chunks, the last ragged (12, 5, 8193), and the center limit
# (3, 1024, 4099), whose rows stay in the output matrix; then the phase 3d settings
CHAIN_SHAPES = ((1, 1, 1), (8, 3, 4099), (13, 4, 4550), (32, 4, 25418), (4, 2, 783360), (40, 16, 25418),
                (25, 4, 25418), (16, 2, 2304), (12, 5, 8193), (3, 1024, 4099))
COALESCED = dict(num_clients=128, coalesce_window=45.0, refine_every=32, max_uploads=800, max_time=1e9, seed=0)
# launch counters the LM paths must move: the flash kernels and the server's fused assign
LM_PATH = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv", "assign_and_lerp")
# the kernels' entry functions in src/repro_torch/csrc, as the profiler names them
PORT_KERNEL_NAMES = ("l1_rows_kernel", "assign_lerp_kernel", "ingest_chain_kernel", "chi2_kernel", "merge_kernel",
                     "uplink_int8_kernel", "uplink_topk_kernel", "uplink_topk_split_kernel", "rnn_chain_kernel",
                     "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
# the broadcast RNN's checks: one step at these windows (top_k's 10; 128, the largest a path runs: 128 clients),
# and chains of 32 steps at (k, seed), ragged and past the 12 records whose histories stay in shared memory
RNN_STEP_T = (10, 128)
RNN_CHAINS = ((10, 0), (16, 1), (33, 2), (128, 3))
RNN_LR, RNN_PRETRAIN_LR = 1e-2, 5e-3
# chi2 order checks: rows, widths (J > 32 takes the warp path) and segment counts (300 > threads)
CHI2_ROWS, CHI2_WIDTHS, CHI2_SEGMENTS = (1, 20, 300, 2049), (2, 10, 16, 200), (0, 1, 4, 300)
# extra segmented chi2 timing shapes: the 128-client fleet's refine, and the launch floor
CHI2_EXTRA = {"client_fleet": (128, 10, 16), "launch_floor": (1, 1, 1)}
# merge checks: the paths' rows (tiny_lm, har, image_recognition, the full-width LM delta), N = 1,
# N % 4 = 3, and 4,000,000, past what one step of the grid covers on an H100 (264 blocks x 6144)
MERGE_WIDTHS = (1, 2304, 4099, 4550, 25418, 783360, 4_000_000)
# extra merge timing shapes, under their labels: the other paths' rows and the launch floor
MERGE_EXTRA = {"har": (4550,), "tiny_lm": (2304,), "llama3.2-1b": (783360,), "launch_floor": (1,)}
# flash kernel checks: name, B, H, KV, Sq, Sk, hd, dv, options
FLASH_CASES = (
    ("tiny_lm", 8, 4, 2, 32, 32, 16, 16, {}),
    ("llama3.2-1b", 4, 32, 8, 256, 256, 64, 64, {}),
    ("llama3.2-1b cohort", 16, 32, 8, 256, 256, 64, 64, {}),
    ("llama3.2-1b S=2048", 1, 32, 8, 2048, 2048, 64, 64, {}),
    ("llama3.2-1b train 2x4096", 2, 32, 8, 4096, 4096, 64, 64, {}),  # phase 3l's training shape
    ("gemma2-2b heads", 1, 8, 4, 512, 512, 256, 256, dict(window=128, softcap=50.0, scale=256 ** -0.5)),
    ("MLA", 1, 16, 16, 256, 256, 192, 128, {}),
    ("non-causal", 1, 2, 2, 64, 64, 32, 32, dict(causal=False)),
    ("ragged", 1, 8, 2, 100, 100, 64, 64, {}),
    ("extreme GQA 4:1", 2, 4, 1, 48, 48, 16, 16, {}),
    ("continuation", 1, 4, 2, 16, 80, 32, 32, dict(q_pos0=64)),
    ("hd 128", 1, 8, 2, 300, 300, 128, 128, {}),
    ("one row past a tile", 1, 4, 2, 65, 65, 64, 64, {}),
    ("hd 12: 4-byte copies", 2, 4, 2, 70, 70, 12, 12, {}),
    # hubert-xlarge's non-causal encoder attention, head width 80 in the 128 bucket
    ("hubert-xlarge heads, non-causal", 2, 16, 16, 200, 200, 80, 80, dict(causal=False)),
    # phase 3o's granite-moe-3b-a800m batch shard on the pod mesh (heads replicated: 24 over 8 KV heads)
    ("granite-moe-3b-a800m pod batch shard", 1, 24, 8, 128, 128, 64, 64, {}),
)
# forward-only checks at phase 3j's prefill shapes (gemma2-2b: 8 heads over 4, head width 256, softcap 50,
# scale 1/16), on the local layers' window of 4,096 and on the global layers' none; at 4,200 the window bites
GEMMA_PREFILL = dict(causal=True, softcap=50.0, scale=256 ** -0.5)
# phase 3k's MLA prefill (deepseek-v2-lite-16b: 16 heads, query/key width 128 + 64, value width 128, scale
# 192 ** -0.5, causal): (B, H, KV, Sq, Sk, hd, dv)
MLA_PREFILL = (2, 16, 16, 512, 512, 192, 128)
MLA_OPTS = dict(causal=True, scale=192 ** -0.5)
MLA_SHARD = (1, 1, 1, 256, 256, 192, 128)  # phase 3o's pod shard: a row and a head
FLASH_FWD_CASES = tuple(
    (f"gemma2-2b prefill {B}x{S}{' local' if w else ' global'}", B, 8, 4, S, S, 256, 256,
     dict(GEMMA_PREFILL, window=w) if w else GEMMA_PREFILL)
    for B, S in ((4, 512), (2, 4200)) for w in (4096, None)) + (
    ("deepseek-v2-lite-16b MLA prefill 2x512", *MLA_PREFILL, MLA_OPTS),
    ("deepseek-v2-lite-16b MLA pod shard (phase 3o)", *MLA_SHARD, MLA_OPTS))


# phase 3e: the reference's Tab. 1 bench (benchmarks/bench_accuracy_time.py) at one task and seed
STRATEGIES = ("fedavg", "oort", "fedasyn", "fedsea", "clusterfl", "echopfl", "standalone")
PAPER_RUN = dict(num_clients=20, max_time=1800, rounds=40, seed=0)
SPEED_ORDER = ("D5", "D1", "D2", "D3", "D4")  # slowest -> fastest device class
# phase 3f: FedAvg over the llama3.2-1b base, one cohort of 4 clients (an attention batch of 16) a round
FULL_SYNC = dict(num_clients=4, seq_len=256, n_train=4, n_test=2, local_epochs=1, rounds=3, eval_interval=240, seed=0)
COHORT_FLASH = (16, 32, 256, 64, 8, 256, 64)  # (B, H, Sq, hd, KV, Sk, dv) of phase 3f's training launches
# uplink encode checks, (B, n, chunk, k): the paths' rows (har, image_recognition, tiny_lm, the full-width
# delta) with k = round(0.1 n) at B = 1, 3, 32; then n = 1, n % chunk = 1 and k = n
UPLINK_SHAPES = tuple((b, n, 512, round(0.1 * n)) for n in (4550, 25418, 2304, 783360) for b in (1, 3, 32)) + (
    (2, 1, 1, 1), (3, 513, 512, 51), (2, 4097, 4096, 4097),
    # about the top-k split's edges: one row too short to split, split rows, more rows than the card holds split
    (1, 8191, 512, 819), (3, 8192, 512, 819), (600, 8192, 512, 819))
UPLINK_KINDS = ("random", "ties", "zeros", "nan", "inf")
# phase 3g: the reference's comm sweep (benchmarks/bench_comm_cost.py::run_compress) at one task and seed
COMM_SWEEP = dict(num_clients=20, max_time=3600.0, coalesce_window=45.0, eval_interval=120.0, seed=0)
# phase 3h: the reference's fault and defense sweeps (benchmarks/bench_faults.py, bench_defense.py) at rate 0.1
CHAOS_RATE, CHAOS_SEEDS = 0.1, (0, 1, 2)
FAULT_SWEEP = dict(clients=32, horizon=2400.0, windows={"coalesced": 30.0})
DEFENSE_SWEEP = dict(clients=16, horizon=1800.0, windows={"coalesced": 30.0, "per_event": 0.0})
# the stored fields held equal: those the live reference (jax 0.9.0, CPU) reproduces at rate 0.1, seeds 0-2, and
# the port reproduces with its own weights (scripts/chaos_reference.py --port; PERF.md section 7). The faults
# arms' uploads and up_MB are printed only: the broadcasts (which follow the weights) start windows, and a
# window's boundaries decide the order of compute-time draws, so one seed's count moves by 2 with other weights.
# Byte fields are compared as the total bytes over the seeds.
FAULT_EXACT = ("retry_MB", "dropped", "crashes", "upload_failures", "dups_absorbed")
DEFENSE_EXACT = {"guard_off": ("uploads", "poisoned"), "guard_on": ()}
# phase 3j: gemma2-2b at full width through the serving entry point; (b) decodes past the 4,096-token window
SERVE_CASES = {"a": dict(batch=4, prompt=512, gen=32), "b": dict(batch=2, prompt=4200, gen=16)}
# decode logits against the teacher-forced full forward (fp32 over 26 layers, logits up to the softcap of 30;
# 2.3e-5 and 7.4e-5 measured at the two cases, PERF.md), and the token margin rule's
SERVE_ATOL = 2e-4
# phase 3j's pytree-against-plane run; hm = 1.0 so that 300 s hold a merge (as phase 3's second run)
PYTREE_RUN = dict(num_clients=20, max_time=300, seed=0, hm=1.0)
EXAMPLE_ATOL = 1e-4  # the serving example's served logits, card against CPU (120 AdamW steps apart)
# phase 3k: deepseek-v2-lite-16b at full width through the serving entry point, (a) dropless, (b) capacity dispatch
ZOO_SERVE = dict(batch=2, prompt=512, gen=16)
# phase 3l: llama3.2-1b trained at full width through the training driver, at train_4k's 4,096 tokens
TRAIN_FULL = dict(batch=2, seq=4096, steps=8)
TRAIN_FLASH = (2, 32, 4096, 64, 8, 4096, 64)  # (B, H, Sq, hd, KV, Sk, dv) of its flash launches
# the driver's checkpoints at reduced llama3.2-1b (the driver's default batch and length): stopped at 3, resumed to 6
TRAIN_CKPT = dict(batch=8, seq=64, kill=3, steps=6)
# the EchoPFL transformer-client example: killed at round 150 (a checkpoint every 50), resumed to 300
EXAMPLE_RUN = dict(kill=150, steps=300)
# phase 3n: llama3.2-1b on the pod mesh over the card, (a) served, (b) trained; (c) reduced archs, multipod and smoke
MESH_SERVE = dict(batch=16, prompt=512, gen=4)
MESH_TRAIN = dict(batch=16, seq=256, steps=2)
MESH_REDUCED = ("llama3.2-1b", "tiny_lm")
MESH_RESUME = dict(batch=32, seq=32)  # 32 rows: one a data shard of the multipod mesh
MESH_SMOKE_SERVE = dict(batch=2, prompt=16, gen=4)
# phase 3o: (a) deepseek-v2-lite-16b served on the pod mesh, a row a data shard; (b) xlstm-1.3b served at batch 2
# (one batch shard, on every rank); (c) granite-moe-3b-a800m trained on the pod mesh, depth cut to 16 of its 32
# layers (the functional AdamW step holds the old and new params and moments, the gradients and the updates at
# once: 8 x 13.2 GB uncut); (d) the reduced archs' multipod resume, one period each (the MoE archs a row a data
# shard, the recurrent ones at batch 2: one shard, every layer over the 16 ranks)
# two decode steps (the second reads the cache rows the first wrote): on the mesh some 300,000 launches a step
ZOO_MESH_SERVE = dict(batch=16, prompt=256, gen=2)
XLSTM_MESH_SERVE = dict(batch=2, prompt=64, gen=4)
# xlstm-1.3b's random-weight stack amplifies rounding some 20 times a period (one ulp on the embeddings moves the
# unmeshed logits 5.9e-4 at one period, 1.2e-2 at two, on the CPU: scripts/xlstm_mesh_gap.py), so its card arm runs
# one period (8 blocks: 7 mLSTM, 1 sLSTM) at full width. The bound is 10 x the one-period mesh-against-no-mesh gap on
# the CPU (5.31e-4); 3 x that did not hold on the card, whose sums round otherwise (2.88e-3; PERF.md)
XLSTM_MESH_PERIODS = 1
XLSTM_MESH_ATOL = 5.3e-3
ZOO_MESH_TRAIN = dict(batch=16, seq=128, steps=2, periods=16)
ZOO_MESH_REDUCED = ("deepseek-v2-lite-16b", "granite-moe-3b-a800m", "jamba-1.5-large-398b", "xlstm-1.3b")
ZOO_MESH_RESUME = dict(batch=32, seq=8, periods=1)
# phase 4's training agreement: the driver at these reduced archs for 3 steps, card against CPU, and the example
TRAIN_AGREEMENT = ("llama3.2-1b", "deepseek-v2-lite-16b")
EXAMPLE_AGREEMENT_ROUNDS = 40
EXAMPLE_LOSS_RTOL = 1e-4  # the example's round losses (tests/test_torch_train_async_pfl.py's tolerance)
# phase 4's model-zoo agreement: the reduced archs, card against CPU, at tests/torch_zoo.py's tolerances
ZOO = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b", "hubert-xlarge", "jamba-1.5-large-398b", "xlstm-1.3b")
ZOO_ATOL = 1e-4  # logits, caches and the aux loss, rtol and atol
# archs whose logits move more than ZOO_ATOL under one ulp of noise on the embeddings: held to 3 x that spread
ZOO_SENSITIVE = ("xlstm-1.3b",)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120).stdout.strip()


def gen(seed: int):
    return torch.Generator(device=DEVICE).manual_seed(seed)


def randn(g, *shape):
    return torch.randn(shape, generator=g, device=DEVICE, dtype=torch.float32)


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------------ phase 1
def probe():
    from repro_torch.kernels import _build

    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print("nvcc: " + sh(_build.nvcc(), "--version").splitlines()[-1])
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    print(f"kernel build: {time.perf_counter() - t0:.2f} s"
          + ("" if built is not None else " (loaded an existing build)"))
    if built is not None:  # the bf16 flash kernels' shared loop keeps every wgmma asynchronous
        serialized = [f"{name}: {line.strip()}" for name, out in _build.build_output.items()
                      for line in out.splitlines() if "wgmma" in line and "serialized" in line]
        print("ptxas wgmma advisories: " + ("; ".join(serialized) if serialized else "none"))
        check(not serialized, "ptxas serialized wgmma instructions")
    kernel_resources()
    return smi


def _kernel_label(mangled: str) -> str:
    """``flash_dkv_kernel<64,3>`` from a mangled name."""
    names = re.findall(r"(?:flash_[a-z]+(?:_bf16)?|l1_rows|assign_lerp|ingest_chain|chi2|merge|uplink_int8"
                       r"|uplink_topk_split|uplink_topk|rnn_chain)_kernel", mangled)
    args = re.findall(r"Li(\d+)E", mangled)
    return (names[-1] if names else mangled) + (f"<{','.join(args)}>" if args else "")


FLASH_BF16_RESOURCES: dict[str, dict[int, dict]] = {}  # phase 1's: "flash_fwd" etc. -> bucket -> resources


def kernel_resources() -> None:
    """Registers, shared memory, stack and local memory of every flash
    kernel and of the L1, fused assign, ingest chain, chi2 and merge kernels
    from ``cuobjdump --dump-resource-usage``, and each flash kernel's
    tensor-core instructions from ``cuobjdump -sass``: ``HMMA`` (mma.sync)
    in the fp32 ones, ``HGMMA`` (wgmma) and no TF32 ``HMMA`` in the bf16 ones.
    An fp32 flash kernel without HMMA, a bf16 one without HGMMA or with a
    TF32 HMMA, a flash kernel with a stack frame or local memory (spills) at
    head width 64 (fp32) or up to 128 (bf16), or an L1, assign, chain, chi2
    or merge kernel with either, fails."""
    from repro_torch.kernels import _build

    tool = _build.cuda_tool("cuobjdump")
    if tool is None:
        print("cuobjdump: not in the CUDA toolkit; kernels' resources and HMMA NOT checked")
        return
    lib = str(_build.library_path())
    usage, name = {}, None
    for line in sh(tool, "--dump-resource-usage", lib).splitlines():
        m = re.search(r"Function (\S+?):?$", line.strip())
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            usage[name] = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", line)}
            name = None
    hmma: Counter = Counter()
    hgmma: Counter = Counter()
    tf32: Counter = Counter()
    name = None
    for line in sh(tool, "-sass", lib).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
        elif name and "HGMMA" in line:
            hgmma[name] += 1
        elif name and "HMMA" in line:
            hmma[name] += 1
            tf32[name] += "TF32" in line
    flash = sorted(n for n in usage if "flash_" in n)
    check(len(flash) > 0, "cuobjdump found no flash kernel in the library")
    for n in flash:
        u = usage[n]
        label = _kernel_label(n)
        width = int(re.findall(r"Li(\d+)E", n)[0])
        spill = u.get("LOCAL", 0) or u.get("STACK", 0)
        if "_bf16_kernel" in label:
            kind = label.split("_bf16_kernel")[0]
            dynamic = getattr(_build.library(), f"repro_{kind}_bf16_smem")(width, width)
            FLASH_BF16_RESOURCES.setdefault(kind, {})[width] = {
                "registers": u.get("REG"), "local": u.get("LOCAL"), "stack": u.get("STACK"), "dynamic_shared": dynamic}
            print(f"  {label:<28} registers {u.get('REG')}, shared {u.get('SHARED')} B static + {dynamic} B dynamic, "
                  f"local {u.get('LOCAL')} B, stack {u.get('STACK')} B, HGMMA {hgmma[n]}, HMMA {hmma[n]} "
                  f"(TF32 {tf32[n]})")
            check(hgmma[n] > 0 and tf32[n] == 0, f"{label}: bf16 products must be wgmma (HGMMA {hgmma[n]}, "
                                                 f"TF32 HMMA {tf32[n]})")
            check(width > 128 or not spill, f"{label} spills ({u.get('STACK')} B stack, {u.get('LOCAL')} B local)")
        else:
            print(f"  {label:<28} registers {u.get('REG')}, shared {u.get('SHARED')} B static, local "
                  f"{u.get('LOCAL')} B, stack {u.get('STACK')} B, HMMA {hmma[n]}")
            check(hmma[n] > 0, f"{label} has no tensor-core HMMA instruction")
            check(width != 64 or not spill, f"{label} spills ({u.get('STACK')} B stack, {u.get('LOCAL')} B local)")
    print(f"flash kernels: {len(flash)} instantiations; the fp32 ones with HMMA, none at head width 64 spilling; the "
          "bf16 ones with HGMMA and no TF32 HMMA, none up to head width 128 spilling")
    fwd256 = [n for n in flash if "flash_fwd_kernel" in n and "Li256E" in n and "bfloat16" not in n]
    check(len(fwd256) == 1, "cuobjdump found no flash_fwd_kernel<256> (gemma2-2b's head width) in the library")
    bf16 = [n for n in usage if "bfloat16" in n]
    check(all(any(f"flash_{k}_bf16_kernel" in n for n in bf16) for k in ("fwd", "dq", "dkv"))
          and any("l1_rows_kernel" in n for n in bf16) and any("merge_kernel" in n for n in bf16),
          "cuobjdump found no bf16 flash kernel or no bf16 instantiation of the L1 or merge kernels")
    print(f"bf16 instantiations: {len(bf16)} kernels (flash {sum('flash_' in n for n in bf16)})")
    u = usage[fwd256[0]]
    spill = u.get("LOCAL", 0) or u.get("STACK", 0)
    print(f"flash_fwd_kernel<256> (gemma2-2b's head width, phase 3j's prefill): registers {u.get('REG')}, shared "
          f"{u.get('SHARED')} B static, local {u.get('LOCAL')} B, stack {u.get('STACK')} B: "
          + (f"it spills ({u.get('STACK')} B stack, {u.get('LOCAL')} B local)" if spill else "no spills"))
    kinds = ("l1_rows_kernel", "assign_lerp_kernel", "ingest_chain_kernel", "chi2_kernel", "merge_kernel",
             "uplink_int8_kernel", "uplink_topk_kernel", "uplink_topk_split_kernel", "rnn_chain_kernel")
    rows = sorted(n for n in usage if any(k in n for k in kinds))
    check(all(any(k in n for n in rows) for k in kinds),
          "cuobjdump found no L1 rows, fused assign, ingest chain, chi2, merge, uplink or RNN kernel in the library")
    for n in rows:
        u = usage[n]
        print(f"  {_kernel_label(n):<24} registers {u.get('REG')}, shared {u.get('SHARED')} B static, "
              f"local {u.get('LOCAL')} B, stack {u.get('STACK')} B")
        check(u.get("LOCAL", 0) == 0 and u.get("STACK", 0) == 0,
              f"{_kernel_label(n)} spills ({u.get('STACK')} B stack, {u.get('LOCAL')} B local)")
    print("L1, fused assign, ingest chain, chi2, merge, uplink encode and RNN kernels: no spills")
    from repro_torch.kernels.rnn import plan as rnn_plan

    for t in (10, 128):
        rp = rnn_plan(t)
        print(f"  rnn_chain_kernel launch at a window of {t}: one block of 512 threads, dynamic shared {rp['smem']} B, "
              + (f"histories in {rp['scratch']} floats of global scratch" if rp["scratch"] else "histories on chip"))
    from repro_torch.kernels.ingest_chain import chain_plan

    for c, n in dict.fromkeys((c, n) for _, c, n in CHAIN_SHAPES):
        plan = chain_plan(c, n)
        print(f"  ingest_chain_kernel launch at (C, N) = {(c, n)}: {plan['blocks']} blocks, dynamic shared "
              f"{plan['smem']} B a block, rows {'on chip' if plan['on_chip'] else 'in the output matrix'}"
              + ("" if chain_plan(c, n, with_stats=True) == plan else
                 f"; with the norm {chain_plan(c, n, with_stats=True)}"))
    from repro_torch.kernels.uplink import topk_plan

    for b, n, _, _ in UPLINK_SHAPES:
        plan = topk_plan(b, n)
        print(f"  uplink top-k launch at (B, n) = {(b, n)}: " + (
            f"uplink_topk_split_kernel, {plan['parts']} blocks a row, {plan['ws']} ints of scratch" if plan["parts"]
            else "uplink_topk_kernel, one block a row"))
    check(topk_plan(1, 783360)["parts"] > 1 and topk_plan(1, 8191)["parts"] == 0,
          "the full-width row must split over blocks and a row under 8,192 floats not")


# ------------------------------------------------------------------ phase 2
def kernel_phase():
    from repro_torch.kernels import assign_lerp, chi2, l1, ops

    n_checked = 0
    widths = (25418, 4550, 4099)  # image_recognition, har, and N % 4 != 0
    for n in widths:
        g = gen(n)
        for c in (1, 2, 5, 8):
            cs = randn(g, c, n)
            for m in (1, 8, 64):
                xs = randn(g, m, n)
                got, want = ops.l1_distance_pairwise(xs, cs), l1.l1_distance_pairwise_plain(xs, cs)
                torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
                n_checked += 1
            u = randn(g, n)
            torch.testing.assert_close(ops.l1_distance(u, cs), l1.l1_distance_plain(u, cs), rtol=1e-5, atol=0)
            for beta in (0.25, 0.3):
                d, i, b = ops.assign_and_lerp(u, cs, beta)
                dp, ip, bp = assign_lerp.assign_and_lerp_plain(u, cs, beta)
                torch.testing.assert_close(d, dp, rtol=1e-5, atol=0)
                check(int(i) == int(ip) == int(torch.argmin(d.cpu())), f"argmin n={n} c={c}")
                check(torch.equal(b, bp), f"blend not bitwise n={n} c={c} beta={beta}")
                n_checked += 1
        # tie: rows 1 and 3 equal and nearest (same alignment class) -> index 1
        cs = randn(g, 5, n) + 5.0
        u = randn(g, n)
        cs[1] = u + 0.5
        cs[3] = u + 0.5
        d, i, b = ops.assign_and_lerp(u, cs, 0.25)
        check(int(i) == 1 and float(d[1]) == float(d[3]), f"tie n={n}: idx {int(i)}")
        check(torch.equal(b, assign_lerp.blend_plain(cs[1], u, 0.25)), "tie blend")
    g = gen(7)
    for m in (1, 8, 64, 300):
        for j in (6, 10):
            fp = torch.rand((m, j), generator=g, device=DEVICE) * 100
            ft = torch.rand((m, j), generator=g, device=DEVICE) * 100 + 1.0
            ss = torch.softmax(randn(g, m, j), dim=-1)
            torch.testing.assert_close(ops.chi2_feedback(fp, ft, ss), chi2.chi2_feedback_plain(fp, ft, ss),
                                       rtol=1e-5, atol=1e-6)
            for s in (1, 4, 8):
                seg = torch.randint(-1, s, (m,), generator=g, device=DEVICE, dtype=torch.int32)
                runs = [ops.chi2_feedback_segmented(fp, ft, ss, seg, s) for _ in range(3)]
                gp, sp = chi2.chi2_feedback_segmented_plain(fp, ft, ss, seg, s)
                torch.testing.assert_close(runs[0][0], gp, rtol=1e-5, atol=1e-6)
                torch.testing.assert_close(runs[0][1], sp, rtol=1e-5, atol=1e-5)
                check(all(torch.equal(r[1], runs[0][1]) and torch.equal(r[0], runs[0][0]) for r in runs),
                      "segment sums differ across repeats")
                n_checked += 1
    for m, n in ((8, 2304), (4, 783360), (5, 4099)):
        x = randn(g, m, n)
        torch.testing.assert_close(ops.pairwise_l1(x), l1.pairwise_l1_plain(x), rtol=1e-5, atol=0)
        n_checked += 1
    sync()
    print(f"kernel phase: {n_checked} checks passed (L1/chi2 rtol 1e-5, blend bitwise, "
          "idx equal, segment sums bitwise across repeats)")
    l1_order_checks()
    ingest_chain_checks()
    chi2_order_checks()
    merge_checks()
    uplink_checks()
    rnn = rnn_checks()
    flash_checks()
    return rnn


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _rnn_weights(seed: int) -> dict:
    from repro_torch.core.broadcast import init_rnn

    return init_rnn(torch.Generator().manual_seed(seed), device=DEVICE)


def _rnn_same_bits(a: dict, b: dict) -> bool:
    return all(_same_bits(a[k], b[k]) for k in a)


def rnn_checks() -> dict:
    """The broadcast RNN kernel (``csrc/rnn.cu``) against its plain version
    on the card (phase 2): one SGD step at RNN_STEP_T within rtol 1e-6, atol
    1e-7, 64 decisions a window identical wherever the plain logit margin
    exceeds 1e-5; chains of 32 steps at RNN_CHAINS within rtol 1e-5, atol
    1e-6 under the margin rule (``tests/torch_rnn_model.py``), each one
    launch, bit for bit the same steps launched one by one and its own
    repeat; the pretraining one launch within PRETRAIN_BOUND_FACTOR x
    PRETRAIN_FP32_GAP of the plain pretraining on the card, and its repeat
    bit for bit; a window past 1,024 records refused; a parent's weights
    untouched by its expanded child's learn. Returns the plain
    pretraining's wall seconds on the card and the margins' counts."""
    import numpy as np

    from repro_torch.core.broadcast import BroadcastPredictor, predictor_for_expansion, pretrain_rnn, pretrain_windows
    from repro_torch.kernels import rnn

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_rnn_model import (DECISION_MARGIN, PRETRAIN_BOUND_FACTOR, PRETRAIN_FP32_GAP, chain_inputs,
                                 check_wants, plain_serial)

    rng = np.random.default_rng(0)
    step_err, probes, under = 0.0, 0, 0
    for T in RNN_STEP_T:
        p = _rnn_weights(T)
        for label in (0, 1):
            seq = rng.uniform(0, 1, (T, 1)).astype(np.float32)
            got, _ = rnn.rnn_sgd(p, seq, label, RNN_LR)
            want, _ = rnn.rnn_sgd_plain(p, torch.from_numpy(seq).to(DEVICE), label, RNN_LR)
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7, msg=f"rnn step T={T} {k}")
            step_err = max(step_err, max(float((got[k] - want[k]).abs().max()) for k in want))
        for x in rng.uniform(0, 1, (64, T, 1)).astype(np.float32):
            lg = rnn.rnn_logits(p, torch.from_numpy(x).to(DEVICE))
            m = float(lg[1] - lg[0])
            close = abs(m) <= DECISION_MARGIN
            check(bool(rnn.rnn_want(p, x)) == (m > 0) or close, f"rnn decision T={T}: margin {m:.3g}")
            probes, under = probes + 1, under + close
    chain_err, split_at = 0.0, []
    for k, seed in RNN_CHAINS:
        p = _rnn_weights(seed)
        pre, post, lab, fb, learn, decide, fallback = args = chain_inputs(k, 32, seed)
        n0 = rnn.rnn_chain.launches
        got, wants = rnn.rnn_chain(p, *args, RNN_LR)
        check(rnn.rnn_chain.launches == n0 + 1, f"rnn chain k={k}: {rnn.rnn_chain.launches - n0} launches")
        want, want_wants, margins = plain_serial(p, *args, RNN_LR)
        u, split = check_wants(wants.tolist(), want_wants, margins)
        under, probes = under + u, probes + int(np.sum(decide & ~fallback))
        split_at.append(split)
        if split is None:
            for name in want:
                torch.testing.assert_close(got[name], want[name], rtol=1e-5, atol=1e-6, msg=f"rnn chain k={k} {name}")
            chain_err = max(chain_err, max(float((got[n] - want[n]).abs().max()) for n in want))
        q, fire, serial = p, 0, []
        for j in range(len(learn)):
            if learn[j]:
                q, _ = rnn.rnn_sgd(q, pre[j], int(lab[j, fire]), RNN_LR)
            w = bool(fb[j, fire]) if fallback[j] else bool(rnn.rnn_want(q, post[j])) if decide[j] else False
            fire = j + 1 if w else fire
            serial.append(w)
        check(wants.tolist() == serial and _rnn_same_bits(got, q), f"rnn chain k={k}: not the per-event launches' bits")
        again, wants2 = rnn.rnn_chain(p, *args, RNN_LR)
        check(torch.equal(wants, wants2) and _rnn_same_bits(got, again), f"rnn chain k={k}: a repeat differs")
    n0 = rnn.rnn_chain.launches
    pre_k = pretrain_rnn(0, device=DEVICE)
    check(rnn.rnn_chain.launches == n0 + 1, f"pretrain_rnn: {rnn.rnn_chain.launches - n0} launches, not 1")
    windows, labels = pretrain_windows(0)
    learn = np.ones(len(labels), bool)
    sync()
    t0 = time.perf_counter()
    pre_p, _ = rnn.rnn_chain_plain(_rnn_weights(0), windows, None, labels, None, learn, ~learn, ~learn, RNN_PRETRAIN_LR)
    sync()
    plain_s = time.perf_counter() - t0
    gap = max(float((pre_k[k] - pre_p[k]).abs().max() / pre_p[k].abs().max()) for k in pre_p)
    check(gap <= PRETRAIN_BOUND_FACTOR * PRETRAIN_FP32_GAP,
          f"pretraining: kernel {gap:.3g} from the plain version, past {PRETRAIN_BOUND_FACTOR} x {PRETRAIN_FP32_GAP}")
    check(_rnn_same_bits(pre_k, pretrain_rnn(0, device=DEVICE)), "pretraining: a repeat differs")
    try:
        rnn.rnn_sgd(_rnn_weights(1), np.zeros((rnn.MAX_T + 1, 1), np.float32), 1, RNN_LR)
        check(False, "rnn_sgd took a window past the kernel's limit")
    except ValueError:
        pass
    parent = BroadcastPredictor(params=_rnn_weights(6), k=10, records=[0.5, 1.25, 0.75])
    before = {k: v.clone() for k, v in parent.params.items()}
    child = predictor_for_expansion(parent, 2.0)
    child.observe(1.5)
    child.learn(1)
    check(_rnn_same_bits(parent.params, before) and not _rnn_same_bits(child.params, before),
          "rnn: an expanded child's learn touched its parent's weights")
    sync()
    print(f"rnn kernel: one step at windows {RNN_STEP_T} within rtol 1e-6, atol 1e-7 (max abs {step_err:.3g}); chains "
          f"{RNN_CHAINS} within rtol 1e-5, atol 1e-6 (max abs {chain_err:.3g}), each one launch, bit for bit its "
          f"per-event launches and its repeat (first decision difference at {split_at}); {under} of {probes} "
          f"decisions within the {DECISION_MARGIN} margin; pretraining one launch, {gap:.3g} from the plain version "
          f"(bound {PRETRAIN_BOUND_FACTOR * PRETRAIN_FP32_GAP:.3g}), plain on the card {plain_s:.3f} s; the window "
          f"limit and the parent's weights held")
    return {"pretrain_plain_s": plain_s, "pretrain_gap": gap, "under_margin": under, "decisions": probes}


def _same_bits(*ts: torch.Tensor) -> bool:
    return all(torch.equal(_bits(t), _bits(ts[0])) for t in ts[1:])


def _first_argmin(d: torch.Tensor) -> int:
    """numpy's first-index argmin (a NaN is the minimum, the first NaN wins)."""
    import numpy as np

    return int(np.argmin(d.cpu().numpy()))


def l1_order_checks() -> None:
    """The L1 sums' fixed order on the card (``csrc/l1_rows.cuh``), at widths
    with N % 4 = 0, 1, 2, 3, a single element and the LM delta's 783,360:
    distances within rtol 1e-5 (atol 0) of the plain version for C in
    {1, 2, 5, 8, 33}; the index the first-index argmin of the returned
    distances; the blend bitwise; repeats bitwise; the fused assign's
    distances bitwise those of ``l1_distance``, and of ``l1_distance_pairwise``
    and ``pairwise_l1`` for the same pair of rows at another place in their
    matrix; equal rows in different alignment classes bitwise equal, the tie
    to the first index; a NaN row wins the argmin."""
    from repro_torch.kernels import assign_lerp, l1, ops

    n_checked = 0
    for n in L1_WIDTHS:
        g = gen(n % 9973)
        m = 1 if n > 100_000 else 3  # the plain pairwise version materializes (M, C, N)
        for c in (1, 2, 5, 8, 33):
            cs, u = randn(g, c, n), randn(g, n)
            runs = [ops.assign_and_lerp(u, cs, 0.3) for _ in range(3)]
            d, i, b = runs[0]
            dp, _, bp = assign_lerp.assign_and_lerp_plain(u, cs, 0.3)
            torch.testing.assert_close(d, dp, rtol=1e-5, atol=0, msg=lambda s: f"assign n={n} c={c}: {s}")
            check(int(i) == _first_argmin(d), f"assign idx n={n} c={c}: {int(i)} != {_first_argmin(d)}")
            check(torch.equal(b, assign_lerp.blend_plain(cs[int(i)], u, 0.3)), f"blend not bitwise n={n} c={c}")
            if int(i) == int(torch.argmin(dp)):
                check(torch.equal(b, bp), f"blend differs from the plain assign n={n} c={c}")
            check(all(_same_bits(r[0], d) and torch.equal(r[1], i) and _same_bits(r[2], b) for r in runs[1:]),
                  f"assign not bitwise across repeats n={n} c={c}")
            xs = randn(g, m, n)
            xs[m - 1] = u  # u at the last row: another alignment class where N % 4 != 0
            dl, dpw = ops.l1_distance(u, cs), ops.l1_distance_pairwise(xs, cs)
            torch.testing.assert_close(dpw, l1.l1_distance_pairwise_plain(xs, cs), rtol=1e-5, atol=0,
                                       msg=lambda s: f"pairwise n={n} c={c}: {s}")
            check(_same_bits(dl, d, dpw[m - 1], ops.l1_distance(u, cs)),
                  f"l1_distance, l1_distance_pairwise and the assign differ in bits n={n} c={c}")
            n_checked += 1
        # rows 1 and 2 equal and nearest: different alignment classes where N % 4 != 0
        cs, u = randn(g, 5, n) + 5.0, randn(g, n)
        cs[1] = u + 0.5
        cs[2] = cs[1]
        d, i, b = ops.assign_and_lerp(u, cs, 0.25)
        check(int(i) == 1 and _same_bits(d[1], d[2]), f"alignment tie n={n}: idx {int(i)}, d {d[1]} vs {d[2]}")
        check(torch.equal(b, assign_lerp.blend_plain(cs[1], u, 0.25)), f"alignment tie blend n={n}")
        dl, dpw = ops.l1_distance(u, cs), ops.l1_distance_pairwise(torch.stack([cs[0], u]), cs)
        check(_same_bits(dl[1], dl[2], dpw[1, 1], dpw[1, 2]), f"alignment tie l1 entry points n={n}")
        # one pair (u, cs[1]) through the four entry points, at different places in the matrices
        pw, pw_rev = ops.pairwise_l1(torch.stack([u, cs[1]])), ops.pairwise_l1(torch.stack([cs[3], cs[1], u]))
        check(_same_bits(d[1], dl[1], dpw[1, 1], pw[0, 1], pw[1, 0], pw_rev[2, 1], pw_rev[1, 2]),
              f"one pair, four entry points, different bits n={n}")
        torch.testing.assert_close(pw_rev, l1.pairwise_l1_plain(torch.stack([cs[3], cs[1], u])), rtol=1e-5, atol=0)
        # u at an odd place in memory gives the same bits
        u_off = torch.stack([cs[0], u])[1]
        check(_same_bits(ops.assign_and_lerp(u_off, cs, 0.25)[0], d), f"u's alignment changed the bits n={n}")
        # a NaN row wins the argmin; a NaN in u makes every distance NaN and idx 0
        cs[3, n // 2] = float("nan")
        d, i, b = ops.assign_and_lerp(u, cs, 0.25)
        dp, ip, bp = assign_lerp.assign_and_lerp_plain(u, cs, 0.25)
        check(int(i) == 3 == int(ip) and bool(torch.isnan(d[3])), f"NaN row did not win n={n}: idx {int(i)}")
        torch.testing.assert_close(d, dp, rtol=1e-5, atol=0, equal_nan=True)
        torch.testing.assert_close(b, bp, rtol=0, atol=0, equal_nan=True, msg=lambda s: f"NaN-row blend n={n}: {s}")
        u[n // 2] = float("nan")
        d, i, b = ops.assign_and_lerp(u, cs, 0.25)
        check(int(i) == 0 and bool(torch.isnan(d).all()), f"NaN upload n={n}: idx {int(i)}")
        torch.testing.assert_close(b, assign_lerp.blend_plain(cs[0], u, 0.25), rtol=0, atol=0, equal_nan=True)
        n_checked += 5
    sync()
    print(f"L1 order checks: {n_checked} passed at N = {list(L1_WIDTHS)} (rtol 1e-5 atol 0, blend bitwise, "
          "idx the first-index argmin, bitwise across repeats, entry points, places and alignments; NaN wins)")


def chain_inputs(s: int, c: int, n: int, seed: int, nan_step: int | None = None):
    """Numpy inputs of one ingest chain: centers, their anchors, S uploads,
    prev and forced ids. A third of the uploads lie near a random center
    (switches and repeated winners), a third midway between the client's
    previous center and another (vetoes), a third are noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, n)).astype(np.float32)
    bcast = (centers + 0.3 * rng.standard_normal((c, n))).astype(np.float32)
    U = rng.standard_normal((s, n)).astype(np.float32)
    prev = [int(p) if rng.uniform() < 0.7 else -1 for p in rng.integers(0, c, s)]
    forced = [int(p) if rng.uniform() < 0.2 else -1 for p in rng.integers(0, c, s)]
    prev[0] = forced[0] = -1
    kind, pick = rng.integers(0, 3, s), rng.integers(0, c, s)
    for j in range(s):
        if kind[j] == 0:
            U[j] = centers[pick[j]] + 0.2 * U[j]
        elif kind[j] == 1 and prev[j] >= 0:
            U[j] = 0.5 * (centers[prev[j]] + centers[pick[j]]) + 0.05 * U[j]
    if nan_step is not None:
        U[nan_step, n // 3] = np.nan
    return U, centers, bcast, prev, forced


def ingest_chain_checks() -> None:
    """The ingest chain kernel (``csrc/ingest_chain.cu``) at CHAIN_SHAPES, with
    and without the guard's norm statistic (``with_stats``), on
    random inputs and (S >= 4) with a NaN upload mid-segment: cids equal to
    the plain version's (run on the CPU) and the numpy model's
    (``tests/test_torch_l1_order.py::kernel_chain``); the blended rows and the
    carried matrix bitwise the plain version's; the distances and the three
    statistics bitwise the model's (NaN at the same places); everything
    bitwise over 3 repeats; the centers unchanged; ``l1_vec`` on the card
    bitwise the chain's statistic of the same rows; at every shape one
    ``ingest_chain_kernel`` per call in a profiler trace, beside the index
    table's host-to-device copy and nothing else (no device-to-device copy).
    With the norm: the four statistics bitwise ``kernel_chain(...,
    with_stats=True)``'s, every other output bitwise the chain's without it,
    a NaN upload's norm NaN, and ``ingest_chain_kernel<4>`` once a call."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_l1_order import kernel_chain

    from repro_torch.core.plane import l1_vec
    from repro_torch.kernels import ops
    from repro_torch.kernels.ingest_chain import ingest_chain_plain

    n_checked, steps, vetoes, pinned, norms = 0, 0, 0, 0, 0
    for s, c, n in CHAIN_SHAPES:
        for nan_step in (None, s // 2) if s >= 4 else (None,):
            U, centers, bcast, prev, forced = chain_inputs(s, c, n, s * 1000 + c * 10 + n % 97, nan_step)
            args = [torch.from_numpy(a).to(DEVICE) for a in (U, centers, bcast)]
            runs = [ops.ingest_chain(*args, prev, forced, beta=0.25) for _ in range(3)]
            got = runs[0]
            plain = ingest_chain_plain(*(torch.from_numpy(a) for a in (U, centers, bcast)), prev, forced, 0.25)
            m_cids, m_blended, m_dists, n_stats, m_carried = kernel_chain(U, centers, bcast, prev, forced, 0.25,
                                                                          with_stats=True)
            m_stats = np.ascontiguousarray(n_stats[:, :3])
            label = f"ingest chain (S, C, N) = {(s, c, n)}" + ("" if nan_step is None else f", NaN at step {nan_step}")
            cids = got.cids.cpu()
            check(torch.equal(cids, plain.cids) and np.array_equal(cids.numpy(), m_cids), f"{label}: cids differ")
            check(_same_nan_bits(got.blended.cpu(), plain.blended), f"{label}: blended rows not the plain version's")
            check(_same_nan_bits(got.carried.cpu(), plain.carried), f"{label}: carried matrix not the plain version's")
            check(_same_nan_bits(got.dists.cpu(), torch.from_numpy(m_dists)), f"{label}: distances not the model's")
            check(_same_nan_bits(got.stats.cpu(), torch.from_numpy(m_stats)), f"{label}: statistics not the model's")
            check(all(torch.equal(r.cids, got.cids) and _same_bits(r.buf, got.buf) and _same_bits(r.carried, got.carried)
                      for r in runs[1:]), f"{label}: not bitwise across repeats")
            check(torch.equal(args[1].cpu(), torch.from_numpy(centers)), f"{label}: the centers were written")
            if nan_step is None:
                j0 = int(cids[0])
                check(_same_bits(l1_vec(got.blended[0], args[1][j0]), got.stats[0, 0]),
                      f"{label}: l1_vec on the card differs from the chain's change")
            # with the guard's post-blend center norm: the fourth statistic bitwise the model's, every
            # other output bitwise the chain's without it
            on = ops.ingest_chain(*args, prev, forced, beta=0.25, with_stats=True)
            check(tuple(on.stats.shape) == (s, 4) and _same_nan_bits(on.stats.cpu(), torch.from_numpy(n_stats)),
                  f"{label}: with_stats statistics (the norm included) not the model's")
            check(all(_same_bits(a, b) for a, b in ((on.cids, got.cids), (on.blended, got.blended),
                                                     (on.dists, got.dists), (on.carried, got.carried),
                                                     (on.stats[:, :3].contiguous(), got.stats))),
                  f"{label}: with_stats changed another output")
            if nan_step is not None:
                check(bool(torch.isnan(on.cnorm[nan_step])), f"{label}: a NaN upload's norm is not NaN")
            norms += s
            amin = np.argmin(m_dists, axis=1)
            steps += s
            vetoes += int(sum(1 for j in range(s) if forced[j] < 0 and cids[j] != amin[j]))
            pinned += int(sum(1 for f in forced if f >= 0))
            n_checked += 1
    per_call = {}
    for s, c, n in CHAIN_SHAPES:  # the one host-to-device copy is the index table
        U, centers, bcast, prev, forced = chain_inputs(s, c, n, 7)
        args = [torch.from_numpy(a).to(DEVICE) for a in (U, centers, bcast)]
        for with_stats in (False, True):
            seen = kernels_per_call(lambda: ops.ingest_chain(*args, prev, forced, beta=0.25, with_stats=with_stats))
            instance = f"ingest_chain_kernel<{4 if with_stats else 3}>"
            check(sum(v for k, v in seen.items() if instance in k) == 10
                  and not any(instance not in k and "HtoD" not in k for k in seen),
                  f"ingest chain {(s, c, n)} with_stats={with_stats}: 10 calls traced as {dict(seen)}, not 10 "
                  f"{instance} and index copies")
            per_call[(s, c, n, with_stats)] = dict(seen)
    sync()
    print(f"ingest chain checks: {n_checked} passed at (S, C, N) = {list(CHAIN_SHAPES)}, {steps} steps with "
          f"{vetoes} vetoes and {pinned} forced ids (cids equal; blended rows and carried matrix bitwise the plain "
          f"version's; distances and statistics bitwise the L1 order model's; bitwise across 3 repeats; centers "
          f"unchanged); with_stats: {norms} post-blend norms bitwise the model's, every other output bitwise "
          f"the chain's without the norm, NaN uploads give NaN norms; device events of 10 calls (no other kernel, "
          f"no device-to-device copy): {per_call}")


def chi2_order_checks() -> None:
    """The chi2 kernel's fixed order on the card (``csrc/chi2.cu``): for every
    (M, J, S) of the CHI2_* shapes, g and the segment sums bitwise those of
    the numpy model (``tests/test_torch_chi2_order.py``), bitwise across
    repeats, and within rtol 1e-5 / atol 1e-6 (g) and atol 1e-5 (sums) of
    the plain version; ``segmented_numpy`` reads both in one copy."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_chi2_order import feedback, kernel_chi2

    from repro_torch.kernels import chi2, ops

    n_checked = 0
    for m in CHI2_ROWS:
        for j in CHI2_WIDTHS:
            rng = np.random.default_rng(m * 1000 + j)
            fp, ft, ss = feedback(rng, m, j)
            t = [torch.from_numpy(a).to(DEVICE) for a in (fp, ft, ss)]
            want_g, _ = kernel_chi2(fp, ft, ss)
            g = ops.chi2_feedback(*t)
            check(np.array_equal(g.cpu().numpy().view(np.int32), want_g.view(np.int32)),
                  f"chi2_feedback bits differ from the model at M={m} J={j}")
            torch.testing.assert_close(g, chi2.chi2_feedback_plain(*t), rtol=1e-5, atol=1e-6)
            for s in CHI2_SEGMENTS:
                seg = rng.integers(-1, s, m).astype(np.int32)
                seg_t = torch.from_numpy(seg).to(DEVICE)
                runs = [ops.chi2_feedback_segmented(*t, seg_t, s) for _ in range(3)]
                wg, ws = kernel_chi2(fp, ft, ss, seg, s)
                for rg, rs in runs:
                    check(np.array_equal(rg.cpu().numpy().view(np.int32), wg.view(np.int32))
                          and np.array_equal(rs.cpu().numpy().view(np.int32), ws.view(np.int32)),
                          f"chi2_feedback_segmented bits differ from the model at M={m} J={j} S={s}")
                gp, sp = chi2.chi2_feedback_segmented_plain(*t, seg_t, s)
                torch.testing.assert_close(runs[0][0], gp, rtol=1e-5, atol=1e-6)
                torch.testing.assert_close(runs[0][1], sp, rtol=1e-5, atol=1e-5)
                hg, hs = chi2.segmented_numpy(*runs[0])
                check(hg.tobytes() == wg.tobytes() and hs.tobytes() == ws.tobytes(), "segmented_numpy")
                n_checked += 1
    sync()
    print(f"chi2 order checks: {n_checked} passed at M = {list(CHI2_ROWS)}, J = {list(CHI2_WIDTHS)}, "
          f"S = {list(CHI2_SEGMENTS)} (g and segment sums bitwise the numpy model's and across 3 repeats; "
          "plain rtol 1e-5 atol 1e-6 / 1e-5)")


def _same_nan_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN at the same places and every other element bitwise equal."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and torch.equal(_bits(got[~nan]), _bits(want[~nan]))


def kernels_per_call(fn, calls: int = 10, sessions: int = 5) -> Counter:
    """The device kernels of ``calls`` calls of ``fn``, by name, from the
    padded profiler session that records the most of them (the profiler can
    lose a short session's kernels, never add any)."""
    best: Counter = Counter()
    fn()
    for _ in range(sessions):
        prof, _ = _device_trace(lambda: [fn() for _ in range(calls)])
        seen = Counter(e.name for e in _device_events(prof))
        if sum(seen.values()) > sum(best.values()):
            best = seen
    return best


def merge_checks() -> None:
    """The merge kernel (``csrc/merge.cu``) bitwise its plain version at
    MERGE_WIDTHS on every case of ``tests/test_torch_merge.py::merge_cases``
    (random, NaN in each input, +-inf, all-negative p, signed zeros; NaN
    positions equal, the rest bitwise, and a NaN in p NaN everywhere), the
    same bits over 3 repeats, in place on row 1 of a 3-row plane (only 8-byte
    aligned where N % 4 = 2), and one ``merge_kernel`` per call in a profiler
    trace at the paths' widths and N = 1."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_merge import merge_cases

    from repro_torch.kernels import merge, ops

    n_checked = 0
    for n in MERGE_WIDTHS:
        for label, rows in merge_cases(np.random.default_rng(n % 9973), n).items():
            vm, va, vt = (torch.from_numpy(r).to(DEVICE) for r in rows)
            want = merge.merge_attention_plain(vm, va, vt)[0]
            runs = [ops.merge_attention(vm, va, vt) for _ in range(3)]
            check(all(_same_nan_bits(r, want) for r in runs), f"merge n={n} {label}: not the plain version's bits")
            if label.startswith("nan"):
                check(bool(torch.isnan(runs[0]).all()), f"merge n={n} {label}: a NaN in p must make every output NaN")
            n_checked += 1
        g = gen(n % 9973)
        plane, vt = randn(g, 3, n), randn(g, n)
        want = merge.merge_attention_plain(plane[1], plane[2], vt)[0]
        row = plane[1]
        check(ops.merge_attention(row, plane[2], vt, out=row) is row and _same_nan_bits(plane[1], want),
              f"merge n={n}: in place on a plane row (address % 16 = {row.data_ptr() % 16}) not bitwise")
        n_checked += 1
    per_call = {}
    for n in (1, 2304, 4550, 25418, 783360):
        g = gen(n)
        vm, va, vt = randn(g, n), randn(g, n), randn(g, n)
        seen = kernels_per_call(lambda: ops.merge_attention(vm, va, vt, out=vm))
        check(sum(seen.values()) == 10 and all("merge_kernel" in k for k in seen),
              f"merge n={n}: 10 calls traced as {dict(seen)}, not 10 merge kernels")
        per_call[n] = re.search(r"merge_kernel(<[^>]*>)?", next(iter(seen))).group(0)
    sync()
    print(f"merge checks: {n_checked} passed at N = {list(MERGE_WIDTHS)} (bitwise the plain version on "
          f"{len(merge_cases(np.random.default_rng(0), 8))} cases, across 3 repeats and in place on a plane row); "
          f"one kernel per call: {per_call}")


def uplink_case(kind: str, shape: tuple):
    """Card tensors for one encode check: the plane (anchors and residuals
    at permuted rows, two rows no encode may touch), the anchor and residual
    row ids and the trained rows, from ``tests/test_torch_uplink.py``'s
    seeded ``encode_inputs`` and ``encode_plane``."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_uplink import encode_inputs, encode_plane

    b, n, _, k = shape
    A, R, mat = encode_inputs(kind, b, n, b * n + k)
    plane, a_rows, r_rows = encode_plane(A, R, b)
    return [t.to(DEVICE) for t in (plane, a_rows, r_rows, torch.from_numpy(mat))]


def uplink_checks() -> None:
    """The two encode kernels (``csrc/uplink.cu``) bitwise their plain
    versions on the card at UPLINK_SHAPES on every UPLINK_KINDS case
    (random, ties across the k-th place, signed zeros, NaN, inf; NaN at the
    same places): the reconstruction and the whole plane after the call (the
    anchor and residual rows written, the rows not to touch), the trained
    rows only read, the same bits over 3 repeats from the same plane; and one
    kernel per call in a profiler trace at the paths' rows."""
    from repro_torch.kernels import ops, uplink
    from repro_torch.kernels.uplink import topk_plan

    n_checked = 0
    for shape in UPLINK_SHAPES:
        _, _, chunk, k = shape
        for kind in UPLINK_KINDS:
            plane, a_rows, r_rows, mat = uplink_case(kind, shape)
            mat0 = mat.clone()
            for name, kernel, plain in (
                    ("int8", lambda p: ops.uplink_int8_encode(p, a_rows, mat, chunk),
                     lambda p: uplink.uplink_int8_encode_plain(p, a_rows, mat, chunk)),
                    ("topk", lambda p: ops.uplink_topk_encode(p, a_rows, r_rows, mat, k),
                     lambda p: uplink.uplink_topk_encode_plain(p, a_rows, r_rows, mat, k))):
                want_plane = plane.clone()
                want = plain(want_plane)
                for _ in range(3):
                    got_plane = plane.clone()
                    got = kernel(got_plane)
                    check(_same_nan_bits(got, want), f"uplink {name} {shape} {kind}: reconstruction not bitwise")
                    check(_same_nan_bits(got_plane, want_plane), f"uplink {name} {shape} {kind}: plane rows differ")
                check(_same_nan_bits(mat, mat0), f"uplink {name} {shape} {kind}: the trained rows were written")
                n_checked += 1
            del plane, mat, mat0
    per_call = {}
    for shape in ((1, 4550, 512, 455), (3, 25418, 512, 2542), (1, 783360, 512, 78336)):
        _, _, chunk, k = shape
        plane, a_rows, r_rows, mat = uplink_case("random", shape)
        topk = "uplink_topk_split_kernel" if topk_plan(*shape[:2])["parts"] else "uplink_topk_kernel"
        for kernel, fn in (("uplink_int8_kernel", lambda: ops.uplink_int8_encode(plane, a_rows, mat, chunk)),
                           (topk, lambda: ops.uplink_topk_encode(plane, a_rows, r_rows, mat, k))):
            seen = kernels_per_call(fn)
            check(sum(seen.values()) == 10 and all(kernel in x for x in seen),
                  f"uplink {shape}: 10 calls traced as {dict(seen)}, not 10 {kernel}")
            per_call[kernel, shape[:2]] = sum(seen.values()) // 10
    torch.cuda.empty_cache()
    sync()
    traced = ", ".join(f"{kernel} at {bn}: {v}" for (kernel, bn), v in per_call.items())
    print(f"uplink encode checks: {n_checked} passed at (B, n, chunk, k) = {list(UPLINK_SHAPES)} on "
          f"{list(UPLINK_KINDS)} rows (bitwise the plain version with NaN at the same places: reconstruction, anchor "
          f"and residual rows, untouched rows; 3 repeats; the trained rows only read); kernels per call: {traced}")


def flash_inputs(g, B, H, KV, Sq, Sk, hd, dv):
    return randn(g, B, H, Sq, hd), randn(g, B, KV, Sk, hd), randn(g, B, KV, Sk, dv), randn(g, B, H, Sq, dv)


def flash_checks():
    """Forward (o, lse) within rtol/atol 1e-5 and backward (dq, dk, dv)
    within 3e-4 of the plain versions on the same inputs; the backward
    bitwise equal across 3 repeats."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import flash_attention_bwd as FB

    g = gen(5)
    for name, B, H, KV, Sq, Sk, hd, dv, kw in FLASH_CASES:
        q, k, v, do = flash_inputs(g, B, H, KV, Sq, Sk, hd, dv)
        o, lse = F.flash_attention_with_lse(q, k, v, **kw)
        o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v, **kw)
        torch.testing.assert_close(o, o_p, rtol=1e-5, atol=1e-5, msg=lambda m: f"fwd o {name}: {m}")
        torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5, msg=lambda m: f"fwd lse {name}: {m}")
        runs = [FB.flash_attention_bwd(q, k, v, o, lse, do, **kw) for _ in range(3)]
        want = FB.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        errs = []
        for got, w, part in zip(runs[0], want, ("dq", "dk", "dv")):
            torch.testing.assert_close(got, w, rtol=3e-4, atol=3e-4, msg=lambda m: f"bwd {part} {name}: {m}")
            errs.append((got - w).abs().max().item())
        check(all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0])),
              f"flash backward not bitwise across repeats: {name}")
        sync()
        print(f"  flash {name} (B {B}, H {H}, KV {KV}, Sq {Sq}, Sk {Sk}, hd {hd}, dv {dv}, {kw or 'causal'}): "
              f"max |err| o {(o - o_p).abs().max().item():.3g}, lse {(lse - lse_p).abs().max().item():.3g}, "
              f"dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g}; backward bitwise across 3 repeats")
    for name, B, H, KV, Sq, Sk, hd, dv, kw in FLASH_FWD_CASES:  # the serving path runs no backward
        q, k, v, _ = flash_inputs(g, B, H, KV, Sq, Sk, hd, dv)
        o, lse = F.flash_attention_with_lse(q, k, v, **kw)
        o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v, **kw)
        torch.testing.assert_close(o, o_p, rtol=1e-5, atol=1e-5, msg=lambda m: f"fwd o {name}: {m}")
        torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5, msg=lambda m: f"fwd lse {name}: {m}")
        sync()
        print(f"  flash {name} (B {B}, H {H}, KV {KV}, Sq {Sq}, Sk {Sk}, hd {hd}, dv {dv}, {kw}): forward only, "
              f"max |err| o {(o - o_p).abs().max().item():.3g}, lse {(lse - lse_p).abs().max().item():.3g}")
        del q, k, v, o, lse, o_p, lse_p
        torch.cuda.empty_cache()
    print(f"flash checks: {len(FLASH_CASES)} cases passed (forward rtol/atol 1e-5, backward rtol/atol 3e-4), "
          f"{len(FLASH_FWD_CASES)} forward-only serving cases passed (rtol/atol 1e-5)")


# ------------------------------------------------------------------ phase 3
def _record_shapes(ops):
    """Wrap the ops entry points the protocol calls so the main path's
    argument shapes are logged (the wrapped functions still count)."""
    shapes: dict[str, Counter] = {name: Counter() for name in MLP_PATH}
    originals = {}

    def wrap(name, fn, key):
        def rec(*args, **kw):
            shapes[name][key(*args, **kw)] += 1
            return fn(*args, **kw)
        originals[name] = fn
        setattr(ops, name, rec)

    wrap("l1_distance_pairwise", ops.l1_distance_pairwise, lambda x, c, **_: (x.shape[0], c.shape[0], x.shape[1]))
    wrap("assign_and_lerp", ops.assign_and_lerp, lambda u, c, b, **_: (c.shape[0], c.shape[1]))
    wrap("chi2_feedback", ops.chi2_feedback, lambda fp, ft, ss, **_: tuple(fp.shape))
    wrap("chi2_feedback_segmented", ops.chi2_feedback_segmented,
         lambda fp, ft, ss, seg, num_segments, **_: (fp.shape[0], fp.shape[1], num_segments))
    wrap("merge_attention", ops.merge_attention, lambda vm, va, vt, out=None: (vm.shape[0],))

    def restore():
        for name, fn in originals.items():
            setattr(ops, name, fn)
        # l1_vec: one upload-sized row against one
        shapes["l1_distance"] = Counter({(1, 1, n): k for (_, n), k in shapes["assign_and_lerp"].items()})

    return shapes, restore


def _host_timers():
    """Wrap the main path's layers with host-clock timers (seconds summed
    per layer; nested layers are reported inside their parent). An
    upload's first host sync is ``assign``'s read of the distances, so
    device work still queued from the layers before it is charged there."""
    from repro_torch.core import server as server_mod
    from repro_torch.core.broadcast import BroadcastPredictor
    from repro_torch.core.clustering import DynamicClustering
    from repro_torch.fl.fleet import ClientFleet
    from repro_torch.fl.simulator import Simulator

    spent: Counter = Counter()
    originals = []

    def wrap(owner, attr, bucket):
        fn = getattr(owner, attr)

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[bucket] += time.perf_counter() - t
        originals.append((owner, attr, fn))
        setattr(owner, attr, timed)

    wrap(server_mod, "pretrain_rnn", "setup: pretrain_rnn")
    wrap(ClientFleet, "train_client", "client: train_client")
    wrap(Simulator, "_evaluate", "client: evaluate_fleet")
    wrap(Simulator, "_set_model", "client: install downlink")
    wrap(ClientFleet, "train_rows", "client: train_rows (a window)")
    wrap(ClientFleet, "set_models", "client: set_models (a window)")
    wrap(server_mod.EchoPFLServer, "handle_uploads", "server: handle_uploads (a window)")
    wrap(server_mod.EchoPFLServer, "_plan_predictor_window", "server:   predictor plan and chains")
    wrap(server_mod.EchoPFLServer, "handle_upload", "server: handle_upload")
    wrap(DynamicClustering, "assign", "server:   assign (reads the distances)")
    wrap(BroadcastPredictor, "learn", "server:   predictor learn")
    wrap(BroadcastPredictor, "decide", "server:   predictor decide")
    wrap(server_mod.EchoPFLServer, "_refine", "server:   _refine")
    wrap(ClientFleet, "train_cohort", "client: train_cohort (a round)")
    from repro_torch.fl.uplink import UplinkCodec

    wrap(UplinkCodec, "encode_vecs", "client: uplink encode (a cohort)")
    from repro_torch.fl.guard import IngestGuard

    wrap(IngestGuard, "upload_stats", "guard: upload_stats (host copies)")
    wrap(server_mod.EchoPFLServer, "_center_norm", "guard: per-event center norm (host copy)")
    wrap(server_mod.EchoPFLServer, "_rollback_center", "guard: rollback")
    from repro_torch import baselines

    for cls, attrs in ((baselines.FedAvg, ("finish_round",)), (baselines.Oort, ("select", "finish_round")),
                       (baselines.ClusterFL, ("finish_round",)), (baselines.Standalone, ("finish_round",)),
                       (baselines.FedAsyn, ("handle_upload", "handle_uploads")),
                       (baselines.FedSEA, ("handle_upload", "on_tick"))):
        for attr in attrs:
            wrap(cls, attr, f"server: {cls.__name__}.{attr}")

    def restore():
        for owner, attr, fn in reversed(originals):
            setattr(owner, attr, fn)

    return spent, restore


def main_path():
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.kernels import ops

    shapes, restore = _record_shapes(ops)
    spent, restore_timers = _host_timers()
    rnn_rec, restore_rnn = _record_rnn()
    sync()
    ops.reset_launch_counts()
    runs = []
    t0 = time.perf_counter()
    for kw in ({}, {"hm": 1.0}):
        t1 = time.perf_counter()
        _, _, strat, rep = run_experiment("image_recognition", "echopfl", num_clients=20,
                                          max_time=1500, seed=0, device=DEVICE, **kw)
        sync()
        runs.append((kw, strat, rep, time.perf_counter() - t1))
        if strat.clustering.merges > 0:
            break  # a merge happened: merge_attention ran, no second run needed
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    restore_rnn()
    restore_timers()
    restore()
    for bucket in sorted(spent):
        print(f"  host time {bucket:<40} {spent[bucket]:8.3f} s ({100 * spent[bucket] / wall:5.1f}%)")
    for kw, strat, rep, secs in runs:
        kinds = Counter(e["kind"] for e in strat.events)
        st = strat.stats()
        print(f"main path {kw or 'default'}: uploads {rep.extra['uploads']}, up {rep.up_events} events / "
              f"{rep.up_bytes} B, down {rep.down_events} events / {rep.down_bytes} B, events {dict(kinds)}, "
              f"clusters {st['clusters']}, merges {st['merges']}, final_acc {rep.final_acc:.4f}, "
              f"wall {secs:.2f} s")
        check(rep.extra["uploads"] > 100, "main path made too few uploads")
        check(0.0 <= rep.final_acc <= 1.0 and all(0.0 <= a <= 1.0 for _, a in rep.curve), "accuracy range")
        for c in strat.clustering.clusters.values():
            v = c.center_vec
            check(v.shape == (25418,) and v.device.type == DEVICE and bool(torch.isfinite(v).all()),
                  "centers must be finite (25418,) rows on the card")
    check(runs[-1][1].clustering.merges > 0, "no run merged: merge_attention never ran")
    check(runs[0][2].final_acc > 0.5, f"default run did not learn: final_acc {runs[0][2].final_acc}")
    uploads = sum(rep.extra["uploads"] for _, _, rep, _ in runs)
    print(f"main path wall time {wall:.2f} s, {uploads} uploads, {uploads / wall:.2f} uploads/s; "
          f"launches {json.dumps(counts)}")
    for name in MLP_PATH:
        check(counts[name] > 0, f"kernel {name} never launched on the main path")
    check_l1_vec_launches(counts, [(strat, rep) for _, strat, rep, _ in runs], "main path")
    check(counts["ingest_chain"] == 0, "the per-event path launched the ingest chain")
    check(len(rnn_rec["pretrain_launches"]) == len(runs) and not rnn_rec["chain_launches"] and rnn_rec["sgd"] > 0
          and rnn_rec["want"] > 0, f"main path: {len(rnn_rec['pretrain_launches'])} pretrainings for {len(runs)} "
                                   f"runs, {len(rnn_rec['chain_launches'])} chains, {rnn_rec['sgd']} learns, "
                                   f"{rnn_rec['want']} RNN decisions")
    check_rnn_launches(counts, rnn_rec, "main path")
    print(f"main path rnn_chain launches: {len(rnn_rec['pretrain_launches'])} pretrainings (one launch each), "
          f"{rnn_rec['sgd']} learns, {rnn_rec['want']} RNN decisions")
    shapes["rnn"] = rnn_rec
    rnn = {k: v.cpu().numpy() for k, v in runs[0][1]._rnn_init.items()}  # pretrained broadcast RNN
    return counts, shapes, wall, rnn


def _record_rnn():
    """Count the broadcast RNN's entry points as the server calls them:
    each learn (``_rnn_sgd``) and RNN decision (``_rnn_want``), each
    pretraining and each coalesced chain with the ``rnn_chain`` launches it
    made; chains by (S, k), with the first chain's operands of each shape."""
    from repro_torch.core import broadcast as bc
    from repro_torch.core import server as server_mod
    from repro_torch.kernels import rnn

    rec = {"sgd": 0, "want": 0, "pretrain_launches": [], "chain_launches": [], "chains": Counter(), "chain_args": {}}
    sgd, want, chain, pretrain = bc._rnn_sgd, bc._rnn_want, server_mod.predictor_chain, server_mod.pretrain_rnn

    def rec_sgd(*a, **kw):
        rec["sgd"] += 1
        return sgd(*a, **kw)

    def rec_want(*a, **kw):
        rec["want"] += 1
        return want(*a, **kw)

    def rec_chain(params, pre, post, lab, fb, lg, dg, fg, *a, **kw):
        n0 = rnn.rnn_chain.launches
        out = chain(params, pre, post, lab, fb, lg, dg, fg, *a, **kw)
        shape = (len(lg), pre.shape[1])
        rec["chains"][shape] += 1
        rec["chain_launches"].append(rnn.rnn_chain.launches - n0)
        rec["chain_args"].setdefault(shape, (params, pre, post, lab, fb, lg, dg, fg))
        return out

    def rec_pretrain(*a, **kw):
        n0 = rnn.rnn_chain.launches
        out = pretrain(*a, **kw)
        rec["pretrain_launches"].append(rnn.rnn_chain.launches - n0)
        return out

    bc._rnn_sgd, bc._rnn_want, server_mod.predictor_chain, server_mod.pretrain_rnn = (rec_sgd, rec_want, rec_chain,
                                                                                      rec_pretrain)

    def restore():
        bc._rnn_sgd, bc._rnn_want, server_mod.predictor_chain, server_mod.pretrain_rnn = sgd, want, chain, pretrain

    return rec, restore


def check_rnn_launches(counts, rec: dict, label: str) -> None:
    """``rnn_chain`` launched once a pretraining, a chain, a learn and an RNN
    decision, and nowhere else."""
    want = sum(rec["pretrain_launches"]) + sum(rec["chain_launches"]) + rec["sgd"] + rec["want"]
    check(all(n == 1 for n in rec["pretrain_launches"] + rec["chain_launches"]),
          f"{label}: a pretraining or chain made {rec['pretrain_launches'] + rec['chain_launches']} launches, not 1")
    check(counts["rnn_chain"] == want > 0, f"{label}: rnn_chain launched {counts['rnn_chain']} times, not once a "
                                           f"pretraining, chain, learn and decision ({want})")


def check_l1_vec_launches(counts, runs, label: str) -> None:
    """On the card the predictor's L1 statistics (``l1_vec``) are
    ``l1_distance`` launches: two an upload (change, gap before) and one more
    a broadcast decision (gap after, when the cluster has other members),
    on the per-event path; the Eq. 1 assign stays in ``assign_and_lerp``."""
    want = sum(2 * rep.extra["uploads"] + strat._decisions for strat, rep in runs)
    check(counts["l1_distance"] == want,
          f"{label}: l1_distance launched {counts['l1_distance']} times, not 2 an upload and 1 a decision ({want})")
    check(0 < counts["assign_and_lerp"] <= sum(rep.extra["uploads"] for _, rep in runs),
          f"{label}: {counts['assign_and_lerp']} fused assigns")


# ----------------------------------------------------------------- phase 3b
def _record_flash_shapes(ops):
    """Log the (B, H, Sq, hd) the LM path gives the flash forward wrapper
    (the Function in ``ops`` looks the name up at call time)."""
    shapes: Counter = Counter()
    fn = ops.flash_attention_with_lse

    def rec(q, k, v, **kw):
        shapes[tuple(q.shape) + (k.shape[1], k.shape[2], v.shape[3])] += 1
        return fn(q, k, v, **kw)

    ops.flash_attention_with_lse = rec

    def restore():
        ops.flash_attention_with_lse = fn

    return shapes, restore


def _record_uploads():
    """Keep the delta of each client's first and last local round."""
    from repro_torch.fl.fleet import ClientFleet

    first, last, rounds = {}, {}, Counter()
    fn = ClientFleet.train_client

    def rec(self, cid):
        params, loss = fn(self, cid)
        first.setdefault(cid, params)
        last[cid] = params
        rounds[cid] += 1
        return params, loss

    ClientFleet.train_client = rec

    def restore():
        ClientFleet.train_client = fn

    return first, last, rounds, restore


def upload_nll(task, clients, by_cid) -> torch.Tensor:
    """(K,) mean training NLL of each client's delta in ``by_cid``."""
    from repro_torch.common.pytrees import tree_map

    fd = task.build_fleet_data([c.data for c in clients], task.device, task.buckets)
    cids = [c.client_id for c in clients]
    stacked = tree_map(lambda *xs: torch.stack(xs), *[by_cid[c] for c in cids])
    with torch.no_grad():
        return task._nll(stacked, fd.train["tokens"], fd.train["labels"], fd.train["mask"])


def lm_run(label: str, expect_shape=None, nll_must_fall: bool = True, **kw):
    """One EchoPFL LM run on the card with its own launch counts, host
    timers and upload recorder; checks the LM path's kernels launched,
    centers are finite rows of the delta's width on the card, and (unless
    ``nll_must_fall`` is off) every client's last upload has a lower
    training NLL than its first."""
    from repro_torch.common.pytrees import tree_leaves
    from repro_torch.fl.lm_task import run_lm_experiment
    from repro_torch.kernels import ops

    shapes, restore_shapes = _record_flash_shapes(ops)
    server_shapes, restore_server_shapes = _record_shapes(ops)
    first, last, rounds, restore_uploads = _record_uploads()
    spent, restore_timers = _host_timers()
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    task, clients, strat, rep = run_lm_experiment("echopfl", seed=0, device=DEVICE, **kw)
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    restore_timers()
    restore_uploads()
    restore_server_shapes()
    restore_shapes()
    for bucket in sorted(spent):
        print(f"  host time {bucket:<40} {spent[bucket]:8.3f} s ({100 * spent[bucket] / wall:5.1f}%)")
    uploads = rep.extra["uploads"]
    kinds = Counter(e["kind"] for e in strat.events)
    nll0, nll1 = upload_nll(task, clients, first), upload_nll(task, clients, last)
    print(f"{label}: uploads {uploads}, up {rep.up_events} events / {rep.up_bytes} B, down {rep.down_events} "
          f"events / {rep.down_bytes} B, server events {dict(kinds)}, clusters {strat.stats()['clusters']}, "
          f"wall {wall:.2f} s ({wall / max(uploads, 1):.3f} s per upload), peak device memory "
          f"{peak / 2**30:.2f} GiB; rounds per client {dict(sorted(rounds.items()))}; training NLL first "
          f"upload {nll0.tolist()} -> last {nll1.tolist()}; "
          f"accuracy curve {[(t, round(a, 4)) for t, a in rep.curve]}")
    print(f"{label}: flash shapes (B, H, Sq, hd, KV, Sk, dv) {dict(shapes)}; launches {json.dumps(counts)}")
    for name in LM_PATH:
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    check_l1_vec_launches(counts, [(strat, rep)], label)
    check(counts["flash_attention_dq"] == counts["flash_attention_dkv"], f"{label}: dq and dkv launches differ")
    width = sum(t.numel() for t in tree_leaves(task.init_params(torch.Generator().manual_seed(0))))
    for c in strat.clustering.clusters.values():
        v = c.center_vec
        check(v.shape == (width,) and v.device.type == DEVICE and bool(torch.isfinite(v).all()),
              f"{label}: centers must be finite ({width},) rows on the card")
    check(all(rounds[c.client_id] >= 2 for c in clients), f"{label}: a client trained fewer than 2 rounds")
    if nll_must_fall:
        check(bool((nll1 < nll0).all()), f"{label}: training NLL did not fall for every client")
    if expect_shape is not None:
        check(any(s[:4] == expect_shape for s in shapes), f"{label}: no flash launch at {expect_shape}")
    return dict(counts=counts, shapes=shapes, server_shapes=server_shapes, wall=wall, uploads=uploads, peak=peak,
                strat=strat, rep=rep)


def lm_path():
    out = lm_run("LM path (tiny_lm, 8 clients, 900 s)", num_clients=8, max_time=900, eval_interval=120)
    out["rnn"] = {k: v.cpu().numpy() for k, v in out["strat"]._rnn_init.items()}
    return out


# ----------------------------------------------------------------- phase 3c
def full_width_task():
    """The LM task over a ``llama3.2-1b`` base (1.24 B parameters) drawn on
    the card from a seeded generator."""
    from repro_torch.configs import get_config
    from repro_torch.fl.lm_task import FrozenBase, LMTask
    from repro_torch.models.model import init_params

    cfg = get_config("llama3.2-1b")
    return LMTask(base=FrozenBase(init_params(cfg, gen(0))), cfg=cfg)


def full_width(rnn_params: dict):
    """The LM run over a ``llama3.2-1b`` base (1.24 B parameters, drawn on
    the card from a seeded generator): 4 clients, seq_len 256, 4 training
    and 2 test sequences each, one local epoch, 720 s of virtual time (so
    that the slowest device class trains at least twice)."""
    t0 = time.perf_counter()
    task = full_width_task()
    sync()
    print(f"full width: llama3.2-1b base drawn on the card in {time.perf_counter() - t0:.2f} s")
    out = lm_run("full width (llama3.2-1b, 4 clients, seq 256, 720 s)", expect_shape=(4, 32, 256, 64),
                 num_clients=4, max_time=720, eval_interval=240, seq_len=256, n_train=4, n_test=2,
                 local_epochs=1, task=task, rnn_params=rnn_params)
    check(out["uploads"] >= 8, f"full width: {out['uploads']} uploads, fewer than 8")
    out["events"] = list(out.pop("strat").events)  # phase 3m's 4 x 2 arms repeat this run
    out.pop("rep")
    out["task"] = task  # the base phase 3m reuses and then frees
    return out


# ----------------------------------------------------------------- phase 3m
MESH_TASK, MESH_MAIN = "image_recognition", dict(num_clients=20, max_time=1500, seed=0, hm=1.0)  # phase 3's merging run
MESH_FULL = dict(num_clients=4, max_time=720, eval_interval=240, seq_len=256, n_train=4, n_test=2, local_epochs=1)
SHARDED_NAMES = ("l1_distance_pairwise", "chi2_feedback", "chi2_feedback_segmented")


def _decisions(strat, rep) -> dict:
    """What a meshed run must share with its run without a mesh."""
    st = strat.stats()
    return dict(events=list(strat.events), assignment=dict(strat.clustering.assignment),
                client_versions=dict(strat.client_versions), fb=st.pop("cluster_feedback_mean"), stats=st,
                centers={cid: c.center_vec.clone() for cid, c in strat.clustering.clusters.items()},
                ledger=(rep.up_events, rep.down_events, rep.up_bytes, rep.down_bytes), curve=list(rep.curve),
                final_acc=rep.final_acc, uploads=rep.extra["uploads"], decisions=strat._decisions)


def _differences(a: dict, b: dict) -> list[str]:
    """The fields where two runs' :func:`_decisions` differ (empty: the same
    run, centers bit for bit, feedback means within 1 ulp)."""
    out = [k for k in ("events", "assignment", "client_versions", "stats", "ledger", "curve", "final_acc")
           if a[k] != b[k]]
    if a["fb"].keys() != b["fb"].keys() or any(abs(a["fb"][c] - b["fb"][c]) > abs(b["fb"][c]) * 2.0 ** -23
                                                for c in a["fb"]):
        out.append(f"feedback means {a['fb']} / {b['fb']}")
    if a["centers"].keys() != b["centers"].keys() or not all(
            _same_bits(a["centers"][c], b["centers"][c]) for c in a["centers"]):
        out.append("centers")
    return out


def _ulp_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in ulps between two fp32 tensors of one sign pattern."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    return int((ia - ib).abs().max()) if a.numel() else 0


def _chunk_l1(u, cs, m: int):
    """The distances of a plane whose dim is in ``m`` chunks: each chunk's L1
    in the kernel's order (``tests/test_torch_l1_order.py::kernel_l1``),
    the chunks' sums added in chunk order (``plane_sharded``'s join)."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_l1_order import kernel_l1

    out = []
    for c in cs:
        parts = [kernel_l1(a, b) for a, b in zip(np.split(u, m), np.split(c, m))]
        acc = np.float32(parts[0])
        for p in parts[1:]:
            acc = np.float32(acc + p)
        out.append(acc)
    return np.asarray(out, np.float32)


def _mesh_arm(run, label: str, keep_inputs: bool = False, **kw) -> dict:
    """One arm of phase 3m: launch counts zeroed just before and read just
    after, the assign's distances recorded (and with ``keep_inputs`` its
    upload and centers, gathered on the card)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.plane_sharded import MeshRows

    dists: list = []
    inputs: list = []
    assign = ops.assign_and_lerp

    def rec(u, c, b, **akw):
        out = assign(u, c, b, **akw)
        dists.append(out[0].detach().cpu())
        if keep_inputs:
            inputs.append((u.detach().clone(), c.gather(u.device) if isinstance(c, MeshRows) else c.clone()))
        return out
    ops.assign_and_lerp = rec
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        strat, rep = run(**kw)
        sync()
    finally:
        ops.assign_and_lerp = assign
    wall = time.perf_counter() - t0
    out = dict(label=label, wall=wall, counts=ops.launch_counts(), calls=ops.sharded_calls(), dists=dists,
               inputs=inputs, **_decisions(strat, rep))
    print(f"phase 3m {label}: {out['uploads']} uploads, {len(out['events'])} events, clusters "
          f"{out['stats']['clusters']}, merges {out['stats']['merges']}, final_acc {out['final_acc']:.4f}, wall "
          f"{wall:.2f} s; launches {json.dumps(out['counts'])}; sharded calls {json.dumps(out['calls'])}")
    return out


def _check_sharded_launches(arm: dict, shards: int, label: str, required=SHARDED_NAMES) -> None:
    """Every sharded call made one launch a shard (and each of ``required``
    ran sharded); the fused assign gave way to ``l1_distance`` a shard; the
    merge ran where the run merged."""
    counts, calls = arm["counts"], arm["calls"]
    for name in SHARDED_NAMES:
        check((calls[name] > 0 or name not in required) and counts[name] >= shards * calls[name],
              f"{label}: {name} launched {counts[name]} times in {calls[name]} sharded calls")
    want = shards * calls["assign_and_lerp"] + 2 * arm["uploads"] + arm["decisions"]
    check(calls["assign_and_lerp"] > 0 and counts["l1_distance"] == want,
          f"{label}: l1_distance launched {counts['l1_distance']} times, not {shards} a sharded assign and the "
          f"predictor's ({want})")
    check(counts["assign_and_lerp"] == 0, f"{label}: the fused assign launched {counts['assign_and_lerp']} times")
    check(arm["stats"]["merges"] == 0 or counts["merge_attention"] >= arm["stats"]["merges"],
          f"{label}: {arm['stats']['merges']} merges, {counts['merge_attention']} merge launches")


def _pairwise_chunk_l1(xs: torch.Tensor, cs: torch.Tensor, m: int):
    """:func:`_chunk_l1` for every query row: the (M, C) distances."""
    import numpy as np

    c = cs.cpu().numpy()
    return np.stack([_chunk_l1(x, c, m) for x in xs.cpu().numpy()])


def _sharded_call_ms(meshes: dict) -> dict:
    """Per call (CUDA events, host overhead included) of each sharded entry
    point beside its single-device call, at the main path's most frequent
    shapes (PERF.md's table) and the full width's assign. Each meshed call's
    output is first held to the single-device call's on the same inputs:
    bit for bit (row-sharded distances, the argmin, the blended row, scores
    and g), dim-sharded distances bit for bit :func:`_chunk_l1`'s, segment
    sums within 2 ulps."""
    from repro_torch.kernels import ops

    g = gen(12)
    u, cs, xs = randn(g, 25418), randn(g, 4, 25418), randn(g, 3, 25418)
    uf, cf = randn(g, 783360), randn(g, 2, 783360)
    fp, ft, ss = randn(g, 20, 10).abs() * 100, randn(g, 20, 10).abs() * 100 + 1, torch.softmax(randn(g, 20, 10), -1)
    seg = torch.arange(20, device=DEVICE, dtype=torch.int32) % 4
    # name: (call, the kind of each output, the dim-chunk model of its distances)
    cases = {
        "assign_and_lerp (4, 25418)": (lambda **kw: ops.assign_and_lerp(u, cs, 0.25, **kw), ("l1", "bits", "bits"),
                                       lambda m: _pairwise_chunk_l1(u[None], cs, m)[0]),
        "assign_and_lerp (2, 783360)": (lambda **kw: ops.assign_and_lerp(uf, cf, 0.25, **kw), ("l1", "bits", "bits"),
                                        lambda m: _pairwise_chunk_l1(uf[None], cf, m)[0]),
        "l1_distance_pairwise (3, 3, 25418)": (lambda **kw: ops.l1_distance_pairwise(xs, xs, **kw), ("l1",),
                                               lambda m: _pairwise_chunk_l1(xs, xs, m)),
        "chi2_feedback (4, 10)": (lambda **kw: ops.chi2_feedback(fp[:4], ft[:4], ss[:4], **kw), ("bits",), None),
        "chi2_feedback_segmented (20, 10), S = 4": (
            lambda **kw: ops.chi2_feedback_segmented(fp, ft, ss, seg, 4, **kw), ("bits", "seg"), None),
    }
    out = {}
    for name, (fn, kinds, model) in cases.items():
        want = fn()
        want = want if isinstance(want, tuple) else (want,)
        for label, mesh in meshes.items():
            got = fn(mesh=mesh)
            got = got if isinstance(got, tuple) else (got,)
            for k, (a, b, kind) in enumerate(zip(got, want, kinds)):
                m = mesh.shape.get("model", 1)  # every width here is even: a model axis splits it
                if kind == "l1" and m > 1:
                    ok = a.cpu().numpy().tobytes() == model(m).tobytes()
                else:
                    ok = _ulp_gap(a, b) <= 2 if kind == "seg" else _same_bits(a, b)
                check(a.shape == b.shape and ok, f"phase 3m per call {name} on {label}: output {k} disagrees "
                                                 f"with the single device's ({kind})")
        row = {"single": call_ms(fn, iters=100)}
        for label, mesh in meshes.items():
            row[label] = call_ms(lambda: fn(mesh=mesh), iters=100)
        out[name] = row
        print(f"phase 3m per call {name}: single device {row['single']:.4f} ms, "
              + ", ".join(f"{label} {row[label]:.4f} ms" for label in meshes))
    return out


def sharded_phase(rnn_params: dict, lm_rnn_params: dict, full: dict, smi: str) -> dict:
    """Phase 3m: the EchoPFL server on sharded planes of the one card."""
    from repro_torch.common.device import resolve_device
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.fl.lm_task import run_lm_experiment
    from repro_torch.launch.mesh import make_plane_mesh

    t_phase = time.perf_counter()
    card = resolve_device(DEVICE)

    def mlp(**kw):
        _, _, strat, rep = run_experiment(MESH_TASK, "echopfl", device=DEVICE, rnn_params=rnn_params,
                                          **MESH_MAIN, **kw)
        return strat, rep

    rows_8 = make_plane_mesh(8, devices=[card] * 8)
    single = _mesh_arm(mlp, "(a) no mesh")
    both = _mesh_arm(mlp, "(a) plane 1 x 8, fleet 4", plane_mesh=rows_8,
                     fleet_mesh=make_plane_mesh(4, devices=[card] * 4), mesh_min_rows=0)
    plane = _mesh_arm(mlp, "(a) plane 1 x 8", plane_mesh=rows_8, mesh_min_rows=0)
    check(single["stats"]["merges"] > 0, "phase 3m (a): the run without a mesh made no merge")
    diff_plane = _differences(plane, single)
    check(not diff_plane, f"phase 3m (a): the plane mesh alone changed {diff_plane}")
    diff_both = _differences(both, single)
    check(not diff_both, f"phase 3m (a): the plane and fleet meshes changed {diff_both}")
    print(f"phase 3m (a) plane 1 x 8, and plane 1 x 8 with fleet 4, against no mesh: identical "
          f"({len(single['events'])} events, {single['uploads']} uploads, centers bit for bit)")
    for arm in (both, plane):
        _check_sharded_launches(arm, 8, f"phase 3m {arm['label']}")

    task = full.pop("task")

    def lm(**kw):
        _, _, strat, rep = run_lm_experiment("echopfl", seed=0, device=DEVICE, task=task, rnn_params=lm_rnn_params,
                                             **MESH_FULL, **kw)
        return strat, rep

    lm_single = _mesh_arm(lm, "(b) llama3.2-1b no mesh")
    check(lm_single["events"] == full["events"], "phase 3m (b): the run without a mesh is not phase 3c's")
    lm_mesh = _mesh_arm(lm, "(b) llama3.2-1b plane 4 x 2", keep_inputs=True,
                        plane_mesh=make_plane_mesh(4, dim_shards=2, devices=[card] * 8), mesh_min_rows=0)
    del task
    torch.cuda.empty_cache()
    diff_lm = _differences(lm_mesh, lm_single)
    check(not diff_lm, f"phase 3m (b): the 4 x 2 plane changed {diff_lm}")
    _check_sharded_launches(lm_mesh, 8, "phase 3m (b)", required=())
    check(len(lm_mesh["dists"]) == len(lm_single["dists"]) > 0, "phase 3m (b): assign counts differ")
    for k, (d, (u, c)) in enumerate(zip(lm_mesh["dists"], lm_mesh.pop("inputs"))):
        check(d.numpy().tobytes() == _chunk_l1(u.cpu().numpy(), c.cpu().numpy(), 2).tobytes(),
              f"phase 3m (b): assign {k}'s distances are not the two chunks' kernel sums added in order")
    ulps = max(_ulp_gap(a, b) for a, b in zip(lm_mesh["dists"], lm_single["dists"]))
    ulps_a = max(_ulp_gap(a, b) for a, b in zip(plane["dists"], single["dists"]))
    check(ulps_a == 0, f"phase 3m (a): row-sharded distances {ulps_a} ulps from the single device's")
    per_call = _sharded_call_ms({"1x8": rows_8, "4x2": make_plane_mesh(4, dim_shards=2, devices=[card] * 8)})
    wall = time.perf_counter() - t_phase
    print(f"phase 3m (b) llama3.2-1b, 783,360 floats a row in 2 x 391,680 on a 4 x 2 plane: identical decisions "
          f"({len(lm_single['events'])} events, {lm_single['uploads']} uploads), centers bit for bit, assign "
          f"distances bit for bit the chunks' kernel sums and at most {ulps} ulps from the single device's ({len(lm_single['dists'])} assigns)")
    print(f"phase 3m wall: (a) no mesh {single['wall']:.2f} s, plane 1 x 8 and fleet 4 {both['wall']:.2f} s, plane "
          f"1 x 8 {plane['wall']:.2f} s; (b) no mesh {lm_single['wall']:.2f} s, plane 4 x 2 {lm_mesh['wall']:.2f} s; "
          f"phase {wall:.1f} s; card {smi}")
    rows = {name: {"1x8": plane["counts"][name], "1x8_fleet4": both["counts"][name], "4x2": lm_mesh["counts"][name],
                   "sharded_calls_1x8": plane["calls"].get(name, 0), "sharded_calls_4x2": lm_mesh["calls"].get(name, 0)}
            for name in ("l1_distance", "l1_distance_pairwise", "assign_and_lerp", "chi2_feedback",
                         "chi2_feedback_segmented", "merge_attention")}
    return dict(rows=rows, wall=wall, dist_ulps_4x2=ulps, per_call_ms=per_call,
                walls={a["label"]: a["wall"] for a in (single, both, plane, lm_single, lm_mesh)},
                uploads={"a": single["uploads"], "b": lm_single["uploads"]})


# ----------------------------------------------------------------- phase 3d
def coalesced_path(rnn_params: dict):
    """The main path's model coalesced (COALESCED: 128 clients, 45 s
    windows, refine_every 32, 800 uploads), the broadcast RNN of phase 3
    handed over so that its pretraining stays outside. Launch counts are
    zeroed just before and read just after; the segments' (S, C, N) are
    recorded as they go into ``ingest_chain``."""
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.fl.simulator import Simulator
    from repro_torch.kernels import ops

    segs: Counter = Counter()
    sims: list = []
    fn, run = ops.ingest_chain, Simulator.run_async

    def rec(U, centers, *a, **kw):
        segs[(U.shape[0], centers.shape[0], U.shape[1])] += 1
        return fn(U, centers, *a, **kw)

    def rec_run(self, **kw):
        sims.append(self)
        return run(self, **kw)

    spent, restore_timers = _host_timers()
    rnn_rec, restore_rnn = _record_rnn()
    ops.ingest_chain, Simulator.run_async = rec, rec_run
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        _, _, strat, rep = run_experiment("image_recognition", "echopfl", device=DEVICE, rnn_params=rnn_params,
                                          **COALESCED)
        sync()
    finally:
        ops.ingest_chain, Simulator.run_async = fn, run
        restore_rnn()
        restore_timers()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for bucket in sorted(spent):
        print(f"  host time {bucket:<40} {spent[bucket]:8.3f} s ({100 * spent[bucket] / wall:5.1f}%)")
    uploads = rep.extra["uploads"]
    arrivals = sims[0].coalesced_groups["upload_done"]
    sizes = [s for (s, _, _), k in segs.items() for _ in range(k)]
    kinds = Counter(e["kind"] for e in strat.events)
    print(f"coalesced path (image_recognition, {COALESCED}): uploads {uploads}, wall {wall:.2f} s, "
          f"{uploads / wall:.2f} uploads/s; arrival batches {len(arrivals)}, mean {statistics.mean(arrivals):.2f}, "
          f"max {max(arrivals)}; segments {len(sizes)}, mean {statistics.mean(sizes):.2f}, max {max(sizes)}, "
          f"uploads in segments {sum(sizes)}; (S, C, N) most frequent {segs.most_common(3)}; up {rep.up_events} "
          f"events / {rep.up_bytes} B, down {rep.down_events} events / {rep.down_bytes} B, events {dict(kinds)}, "
          f"clusters {strat.stats()['clusters']}, merges {strat.clustering.merges}, final_acc {rep.final_acc:.4f}; "
          f"launches {json.dumps(counts)}")
    check(uploads == COALESCED["max_uploads"], f"coalesced path: {uploads} uploads")
    check(counts["ingest_chain"] == len(sizes) > 0 and max(sizes) > 1,
          f"coalesced path: ingest_chain launched {counts['ingest_chain']} times, segments {sorted(set(sizes))}")
    for name in COALESCED_PATH:
        check(counts[name] > 0, f"coalesced path: kernel {name} never launched")
    check(rnn_rec["chain_launches"] and not rnn_rec["pretrain_launches"],
          f"coalesced path: {len(rnn_rec['chain_launches'])} predictor chains, "
          f"{len(rnn_rec['pretrain_launches'])} pretrainings")
    check_rnn_launches(counts, rnn_rec, "coalesced path")
    print(f"coalesced path rnn_chain launches: {len(rnn_rec['chain_launches'])} chains (one launch each; (S, k) most "
          f"frequent {rnn_rec['chains'].most_common(3)}), {rnn_rec['sgd']} learns and {rnn_rec['want']} RNN decisions "
          f"outside a chain")
    for c in strat.clustering.clusters.values():
        v = c.center_vec
        check(v.shape == (25418,) and v.device.type == DEVICE and bool(torch.isfinite(v).all()),
              "coalesced path: centers must be finite (25418,) rows on the card")
    check(rep.final_acc > 0.5, f"coalesced path did not learn: final_acc {rep.final_acc}")
    return dict(counts=counts, segs=segs, wall=wall, uploads=uploads, arrivals=arrivals, rnn=rnn_rec)


# ----------------------------------------------------------------- phase 3e
def per_class_accuracy(rep) -> dict[str, float]:
    """Mean accuracy per device class."""
    by_class: dict[str, list[float]] = {}
    for cid, acc in rep.per_client_acc.items():
        by_class.setdefault(rep.per_client_class[cid], []).append(acc)
    return {k: statistics.mean(v) for k, v in sorted(by_class.items())}


def paper_comparison(rnn_params: dict) -> list[dict]:
    """The reference's Tab. 1 bench at one task and seed on the card: the
    seven strategies on ``image_recognition`` (PAPER_RUN), FedAsyn and
    FedSEA also at a 45 s window, EchoPFL with phase 3's broadcast RNN
    handed over. Each run's launch counts are zeroed just before it and
    read just after: the MLP baselines must launch none of the port's
    kernels, EchoPFL its per-event path's."""
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.kernels import ops

    out = []
    for name in STRATEGIES:
        for window in ((0.0, 45.0) if name in ("fedasyn", "fedsea") else (0.0,)):
            kw = dict(rnn_params=rnn_params) if name == "echopfl" else {}
            spent, restore_timers = _host_timers()
            sync()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                _, _, strat, rep = run_experiment("image_recognition", name, device=DEVICE, coalesce_window=window,
                                                  **PAPER_RUN, **kw)
                sync()
            finally:
                restore_timers()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            label = name + (f" at {window:g} s" if window else "")
            pc = per_class_accuracy(rep)
            present = [c for c in SPEED_ORDER if c in pc]
            horizon = rep.time_to_target if rep.time_to_target is not None else rep.duration
            up_b, down_b = rep.bytes_until(horizon)
            steps = rep.extra["rounds"] if strat.is_synchronous else rep.extra["uploads"]
            unit = "rounds" if strat.is_synchronous else "uploads"
            row = dict(strategy=label, final_acc=rep.final_acc, acc_slowest=pc[present[0]],
                       acc_fastest=pc[present[-1]], time_to_target=rep.time_to_target, duration=rep.duration,
                       bytes_until_target=[up_b, down_b], wall_s=wall, **{unit: steps},
                       per_wall_s=steps / wall, stats=strat.stats(), summary=rep.summary())
            print(f"paper comparison {label}: final_acc {rep.final_acc:.4f}, slowest class {present[0]} "
                  f"{row['acc_slowest']:.4f}, fastest class {present[-1]} {row['acc_fastest']:.4f}, time to target "
                  f"{rep.time_to_target}, duration {rep.duration:.1f} s, bytes until target (up, down) {up_b}, "
                  f"{down_b}; {steps} {unit} in {wall:.2f} s wall, {steps / wall:.2f} {unit}/s; stats "
                  f"{json.dumps(strat.stats())}; summary {json.dumps(rep.summary())}")
            for bucket in sorted(spent):
                print(f"  host time {bucket:<40} {spent[bucket]:8.3f} s ({100 * spent[bucket] / wall:5.1f}%)")
            check(all(0.0 <= a <= 1.0 for _, a in rep.curve) and 0.0 <= rep.final_acc <= 1.0,
                  f"paper comparison {label}: accuracy not finite in [0, 1]")
            check(rep.up_bytes > 0 and rep.down_bytes > 0 and up_b > 0, f"paper comparison {label}: no bytes")
            check(steps > 0, f"paper comparison {label}: no {unit}")
            if name == "echopfl":
                check(counts["assign_and_lerp"] > 0, f"paper comparison {label}: the fused assign never launched")
            else:
                check(not any(counts.values()), f"paper comparison {label}: an MLP baseline launched {counts}")
            out.append(row)
    return out


# ----------------------------------------------------------------- phase 3f
def _record_cohorts():
    """Keep each client's first and last trained delta of a synchronous
    run, and count its cohort trainings."""
    from repro_torch.fl.fleet import ClientFleet

    first, last, rounds = {}, {}, Counter()
    fn = ClientFleet.train_cohort

    def rec(self, cids, params_list):
        trained, losses, vecs = fn(self, cids, params_list)
        for cid, params in zip(cids, trained):
            first.setdefault(int(cid), params)
            last[int(cid)] = params
            rounds[int(cid)] += 1
        return trained, losses, vecs

    ClientFleet.train_cohort = rec

    def restore():
        ClientFleet.train_cohort = fn

    return first, last, rounds, restore


def full_width_sync():
    """FedAvg over a ``llama3.2-1b`` base drawn on the card (FULL_SYNC): a
    round trains its cohort of 4 clients × 4 sequences as one attention
    batch of 16. Launch counts are zeroed just before the run and read just
    after."""
    from repro_torch.fl.lm_task import run_lm_experiment
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    task = full_width_task()
    sync()
    print(f"full width FedAvg: llama3.2-1b base drawn on the card in {time.perf_counter() - t0:.2f} s")
    shapes, restore_shapes = _record_flash_shapes(ops)
    first, last, rounds, restore_cohorts = _record_cohorts()
    spent, restore_timers = _host_timers()
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        _, clients, strat, rep = run_lm_experiment("fedavg", device=DEVICE, task=task, **FULL_SYNC)
        sync()
    finally:
        restore_timers()
        restore_cohorts()
        restore_shapes()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for bucket in sorted(spent):
        print(f"  host time {bucket:<40} {spent[bucket]:8.3f} s ({100 * spent[bucket] / wall:5.1f}%)")
    nll0, nll1 = upload_nll(task, clients, first), upload_nll(task, clients, last)
    n_rounds = rep.extra["rounds"]
    print(f"full width FedAvg (llama3.2-1b, {FULL_SYNC}): {n_rounds} rounds, {rep.up_events} uploads / "
          f"{rep.up_bytes} B up, {rep.down_events} events / {rep.down_bytes} B down, wall {wall:.2f} s "
          f"({wall / n_rounds:.3f} s a round, {rep.up_events / wall:.2f} uploads/s), peak device memory "
          f"{peak / 2**30:.2f} GiB; cohorts per client {dict(sorted(rounds.items()))}; training NLL first upload "
          f"{nll0.tolist()} -> last {nll1.tolist()}; accuracy curve {[(t, round(a, 4)) for t, a in rep.curve]}")
    print(f"full width FedAvg: flash shapes (B, H, Sq, hd, KV, Sk, dv) {dict(shapes)}; launches {json.dumps(counts)}")
    for name in LM_PATH[:3]:
        check(counts[name] > 0, f"full width FedAvg: kernel {name} never launched")
    check(counts["flash_attention_dq"] == counts["flash_attention_dkv"], "full width FedAvg: dq and dkv launches differ")
    check(shapes[COHORT_FLASH] > 0, f"full width FedAvg: no flash launch at {COHORT_FLASH}")
    check(n_rounds == FULL_SYNC["rounds"] and all(rounds[c.client_id] == n_rounds for c in clients),
          f"full width FedAvg: {n_rounds} rounds, cohorts {dict(rounds)}")
    check(bool((nll1 < nll0).all()), "full width FedAvg: training NLL did not fall for every client")
    width = strat.spec.dim  # 783,360 floats: the LoRA/head delta over llama3.2-1b
    check(rep.up_bytes == rep.up_events * width * 4, "full width FedAvg: uploads not billed at the delta's size")
    v = strat._vec
    check(v.shape == (width,) and v.device.type == DEVICE and bool(torch.isfinite(v).all()),
          f"full width FedAvg: the global delta must be a finite ({width},) row on the card")
    del task, strat, clients
    torch.cuda.empty_cache()
    return dict(counts=counts, shapes=shapes, wall=wall, peak=peak, rounds=n_rounds)


# ----------------------------------------------------------------- phase 3g
def _record_encodes():
    """Count the (B, n) cohorts the codec hands each encode wrapper (the
    codec looks the names up in ``repro_torch.fl.uplink`` at call time)."""
    from repro_torch.fl import uplink as codec_mod

    shapes = {name: Counter() for name in UPLINK_KERNELS}
    originals = {name: getattr(codec_mod, name) for name in UPLINK_KERNELS}

    def wrap(name):
        fn = originals[name]

        def rec(plane, rows, *args):
            shapes[name][tuple(args[-2].shape)] += 1  # mat, then k or chunk
            return fn(plane, rows, *args)
        return rec

    for name in UPLINK_KERNELS:
        setattr(codec_mod, name, wrap(name))

    def restore():
        for name, fn in originals.items():
            setattr(codec_mod, name, fn)

    return shapes, restore


def comm_sweep(rnn_params: dict) -> list[dict]:
    """The reference's comm sweep (``benchmarks/bench_comm_cost.py::
    run_compress``) on the card at one task and seed: ``har``, 20 clients,
    3,600 s, 45 s windows, EchoPFL (phase 3's broadcast RNN handed over)
    and FedAsyn, each with no codec, ``topk`` and ``int8``. Launch counts are
    zeroed just before each run and read just after: a compressed arm bills
    ``up_events x payload_bytes`` exactly and launches its encode kernel
    ``codec.launches`` times; an uncompressed arm launches neither. The
    uplink's events, bytes, payload size and codec launches (and FedAsyn's
    downlink bytes) must equal the reference's ``BENCH_comm_compress.json``,
    whose rows are printed beside."""
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.kernels import ops

    bench_rows = json.loads((ROOT / "BENCH_comm_compress.json").read_text())["rows"]
    bench = {(r["strategy"], r["uplink"]): r for r in bench_rows}
    rows = []
    for name in ("echopfl", "fedasyn"):
        for uplink in (None, "topk", "int8"):
            kw = dict(rnn_params=rnn_params) if name == "echopfl" else {}
            shapes, restore = _record_encodes()
            spent, restore_timers = _host_timers()
            sync()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                _, _, strat, rep = run_experiment("har", name, device=DEVICE, uplink=uplink, **COMM_SWEEP, **kw)
                sync()
            finally:
                restore_timers()
                restore()
            wall = time.perf_counter() - t0
            for bucket in sorted(spent):
                print(f"  host time {bucket:<40} {spent[bucket]:8.3f} s ({100 * spent[bucket] / wall:5.1f}%)")
            counts = ops.launch_counts()
            up = rep.extra.get("uplink") or {}
            mode = uplink or "none"
            accs = [a for _, a in rep.curve]
            row = dict(strategy=name, uplink=mode, up_MB=rep.up_bytes / 1e6, down_MB=rep.down_bytes / 1e6,
                       total_MB=(rep.up_bytes + rep.down_bytes) / 1e6, up_events=rep.up_events,
                       down_events=rep.down_events, uplink_ratio=rep.summary().get("uplink_ratio"),
                       payload_bytes=up.get("payload_bytes"), codec_launches=up.get("launches"),
                       kernel_launches={k: counts[k] for k in UPLINK_KERNELS}, final_acc=rep.final_acc,
                       tail_acc=statistics.mean(accs[-5:]), uploads_per_wall_s=rep.up_events / wall, wall_s=wall,
                       cohorts={k: {str(sh): c for sh, c in v.most_common()} for k, v in shapes.items() if v},
                       top_cohort={k: list(v.most_common(1)[0][0]) for k, v in shapes.items() if v})
            ref = bench[(name, mode)]
            print(f"comm sweep {name} {mode}: up {row['up_MB']:.6f} MB ({rep.up_events} events), down "
                  f"{row['down_MB']:.6f} MB ({rep.down_events} events), total {row['total_MB']:.6f} MB, uplink_ratio "
                  f"{row['uplink_ratio']}, payload_bytes {row['payload_bytes']}, codec launches "
                  f"{row['codec_launches']}, "
                  f"kernel launches {row['kernel_launches']}, cohorts (B, n) {row['cohorts']}; final_acc "
                  f"{rep.final_acc:.4f}, tail_acc {row['tail_acc']:.4f}; {row['uploads_per_wall_s']:.2f} uploads per "
                  f"wall s ({wall:.2f} s); BENCH_comm_compress.json (the reference, another machine): up "
                  f"{ref.get('up_MB')} MB ({ref.get('up_events')} events), down {ref.get('down_MB')} MB, final_acc "
                  f"{ref.get('final_acc')}")
            check(all(0.0 <= a <= 1.0 for a in accs), f"comm sweep {name} {mode}: accuracy not finite in [0, 1]")
            check(rep.up_events > 0 and rep.down_bytes > 0, f"comm sweep {name} {mode}: no traffic")
            if uplink is None:
                check(not up and not any(row["kernel_launches"].values()) and rep.up_raw_bytes == rep.up_bytes,
                      f"comm sweep {name}: an uncompressed run encoded")
            else:
                check(rep.up_bytes == rep.up_events * up["payload_bytes"],
                      f"comm sweep {name} {mode}: up_bytes {rep.up_bytes} != {rep.up_events} x {up['payload_bytes']}")
                check(counts[f"uplink_{mode}_encode"] == up["launches"] > 0
                      and counts[f"uplink_{'int8' if mode == 'topk' else 'topk'}_encode"] == 0,
                      f"comm sweep {name} {mode}: kernel launches {row['kernel_launches']}, codec {up['launches']}")
                check(up["launches"] < rep.up_events, f"comm sweep {name} {mode}: no window encoded a cohort")
            # the uplink's ledger depends on the draws and the wire sizes alone, not on the weights; so does
            # FedAsyn's downlink (one unicast an upload), while EchoPFL's follows its broadcast decisions
            mine = [row["up_events"], round(row["up_MB"], 6), row["payload_bytes"], row["codec_launches"]]
            theirs = [ref["up_events"], round(ref["up_MB"], 6), ref["payload_bytes"], ref["codec_launches"]]
            if name == "fedasyn":
                mine, theirs = mine + [round(row["down_MB"], 6)], theirs + [round(ref["down_MB"], 6)]
            check(mine == theirs, f"comm sweep {name} {mode}: {mine} differs from BENCH_comm_compress.json's {theirs}")
            rows.append(row)
    return rows


def per_event_encodes(rnn_params: dict) -> dict:
    """Phase 3's per-event ``image_recognition`` EchoPFL run (20 clients,
    300 s, phase 3's RNN handed over) under each codec: every upload is one
    encode at (1, 25,418). Launch counts are zeroed just before each run and
    read just after; returns each kernel's launches at that shape."""
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.kernels import ops

    out = {}
    for name in UPLINK_KERNELS:
        mode = name.split("_")[1]
        shapes, restore = _record_encodes()
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rep = run_experiment("image_recognition", "echopfl", num_clients=20, max_time=300, seed=0, device=DEVICE,
                                 rnn_params=rnn_params, uplink=mode)[3]
            sync()
        finally:
            restore()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        up = rep.extra["uplink"]
        print(f"per-event image_recognition {mode}: {rep.up_events} uploads, up {rep.up_bytes} B, payload_bytes "
              f"{up['payload_bytes']}, codec launches {up['launches']}, kernel launches "
              f"{ {k: counts[k] for k in UPLINK_KERNELS} }, cohorts (B, n) {dict(shapes[name])}, final_acc "
              f"{rep.final_acc:.4f}, wall {wall:.2f} s")
        check(dict(shapes[name]) == {(1, 25418): counts[name]} and counts[name] == up["launches"] == rep.up_events > 0
              and sum(counts[k] for k in UPLINK_KERNELS) == counts[name],
              f"per-event image_recognition {mode}: encodes {dict(shapes[name])}, launches {counts[name]}, codec "
              f"{up['launches']}, uploads {rep.up_events}")
        check(rep.up_bytes == rep.up_events * up["payload_bytes"],
              f"per-event image_recognition {mode}: up_bytes {rep.up_bytes} != {rep.up_events} x {up['payload_bytes']}")
        check(all(0.0 <= a <= 1.0 for _, a in rep.curve), f"per-event image_recognition {mode}: accuracy range")
        out[name] = counts[name]
    return out


def full_width_topk(rnn_params: dict) -> dict:
    """Phase 3c's full-width LM run (``llama3.2-1b`` base, 4 clients, seq
    256, 720 s) with ``uplink="topk"``: the topk encode must launch at (B,
    783,360), once an upload (the per-event loop), and every check of
    ``lm_run`` holds but the falling NLL. The server blends only the sent
    tenth of each delta, and each unicast back resets the client's anchor
    and drops its residual, so a client's delta need not improve on its own
    data within 720 s; its NLLs are printed."""
    task = full_width_task()
    sync()
    shapes, restore = _record_encodes()
    try:
        out = lm_run("full width top-k (llama3.2-1b, 4 clients, seq 256, 720 s, uplink topk)",
                     expect_shape=(4, 32, 256, 64), num_clients=4, max_time=720, eval_interval=240, seq_len=256,
                     n_train=4, n_test=2, local_epochs=1, task=task, rnn_params=rnn_params, uplink="topk",
                     nll_must_fall=False)
    finally:
        restore()
    out.pop("strat")  # holds the clients, and through them the base
    rep = out.pop("rep")
    up = rep.extra["uplink"]
    topk = shapes["uplink_topk_encode"]
    print(f"full width top-k: payload_bytes {up['payload_bytes']}, codec launches {up['launches']}, encode cohorts "
          f"(B, n) {dict(topk)}, up {rep.up_bytes} B for {rep.up_events} uploads (dense {rep.up_raw_bytes} B), "
          f"{out['wall'] / out['uploads']:.3f} s wall per upload, peak {out['peak'] / 2**30:.2f} GiB")
    check(out["counts"]["uplink_topk_encode"] == up["launches"] == rep.up_events > 0
          and all(n == 783360 for _, n in topk), f"full width top-k: encodes {dict(topk)}, launches {out['counts']}")
    check(rep.up_bytes == rep.up_events * 78336 * 8, "full width top-k: uploads not billed at k = 78,336 pairs")
    del task
    torch.cuda.empty_cache()
    return dict(out, encodes=topk)


# ----------------------------------------------------------------- phase 3h
def _fault_plan(rate: float, policy: str = "retry", poison: float = 0.0, seed: int = 0):
    """``bench_faults.py``'s plan (loss r, crash r/2, duplicates and reorders
    r/4) at ``rate``, or with ``poison`` ``bench_defense.py``'s (NaN p/2,
    blow-up and sign flip p/4 each, the other rates at their defaults); the
    fault seed is ``seed + 1``, as in both."""
    from repro_torch.fl.faults import FaultConfig, FaultPlan

    if poison:
        cfg = dict(poison_nan_rate=poison / 2, poison_scale_rate=poison / 4, poison_sign_rate=poison / 4)
        if rate:
            cfg.update(loss_rate=rate, crash_rate=rate / 2, dup_rate=rate / 4, reorder_rate=rate / 4)
        return FaultPlan(config=FaultConfig(seed=seed + 1, policy=policy, **cfg))
    return FaultPlan(config=FaultConfig(seed=seed + 1, loss_rate=rate, crash_rate=rate / 2, dup_rate=rate / 4,
                                        reorder_rate=rate / 4, policy=policy))


def _nonfinite_centers(strat) -> int:
    return sum(not bool(torch.isfinite(c.center_vec).all()) for c in strat.clustering.clusters.values())


def chaos_run(n: int, seed: int, window: float, horizon: float, faults, guard, rnn_params: dict) -> dict:
    """One arm of the reference's fault or defense bench on the card
    (``_run`` of ``benchmarks/bench_faults.py`` / ``bench_defense.py``):
    ``har``, ``n`` clients with 48 samples each, EchoPFL with phase 3's
    broadcast RNN handed over, through ``build_clients``, ``build_strategy``
    and ``Simulator``. Launch counts are zeroed just before and read just
    after; ``ingest_chain`` calls are counted by ``with_stats``."""
    from repro_torch.fl.experiment import build_clients, build_strategy
    from repro_torch.fl.network import NetworkModel
    from repro_torch.fl.simulator import Simulator
    from repro_torch.kernels import ops

    _, clients, init = build_clients("har", n, seed=seed, samples_per_client=48, device=DEVICE)
    strat = build_strategy("echopfl", init, clients, seed=seed, rnn_params=rnn_params, device=DEVICE)
    sim = Simulator(clients, strat, network=NetworkModel(), seed=seed, coalesce_window=window, faults=faults,
                    guard=guard)
    chains: Counter = Counter()
    fn = ops.ingest_chain

    def rec(*a, with_stats=False, **kw):
        chains[with_stats] += 1
        return fn(*a, with_stats=with_stats, **kw)

    spent, restore_timers = _host_timers()
    ops.ingest_chain = rec
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rep = sim.run_async(max_time=horizon)
        sync()
    finally:
        ops.ingest_chain = fn
        restore_timers()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    k = max(1, len(rep.curve) // 5)
    f, g = rep.extra.get("faults", {}), rep.extra.get("guard", {})
    return dict(
        final_acc=rep.final_acc, tail_acc=sum(a for _, a in rep.curve[-k:]) / k,
        any_nan_acc=any(not (a == a) for _, a in rep.curve), uploads=rep.extra["uploads"],
        retry_MB=rep.up_retry_bytes / 1e6, up_MB=rep.up_bytes / 1e6, dropped=f.get("dropped_clients", 0),
        crashes=f.get("crashes", 0), upload_failures=f.get("upload_failures", 0),
        dups_absorbed=f.get("dups_absorbed", 0), stale_absorbed=f.get("stale_downlinks_absorbed", 0),
        poisoned=f.get("poison_nan", 0) + f.get("poison_scale", 0) + f.get("poison_sign", 0),
        nonfinite_centers=_nonfinite_centers(sim.strategy),
        quarantine={key: g.get(key, 0) for key in ("accepted", "rejected_nonfinite", "rejected_norm", "rejected_dist",
                                                    "rejected_quarantined", "rollbacks", "quarantined_clients",
                                                    "evicted_clients")} if g else None,
        wall_s=wall, host=dict(spent), chain_launches=counts["ingest_chain"],
        chains_with_stats=chains[True], chains_without=chains[False])


def _mean_arm(runs: list[dict]) -> dict:
    """Seed means as the benches take them (a NaN accuracy stays NaN), with
    the per-seed runs beside."""
    out = {}
    for key in ("final_acc", "tail_acc", "uploads", "retry_MB", "up_MB", "dropped", "crashes", "upload_failures",
                "dups_absorbed", "stale_absorbed", "poisoned", "nonfinite_centers", "wall_s"):
        out[key] = sum(r[key] for r in runs) / len(runs)
    out["any_nan_acc"] = any(r["any_nan_acc"] for r in runs)
    out["final_acc_by_seed"] = [r["final_acc"] for r in runs]
    if runs[0]["quarantine"] is not None:
        out["quarantine"] = {k: sum(r["quarantine"][k] for r in runs) / len(runs) for k in runs[0]["quarantine"]}
    return out


def _beside(label: str, mine: dict, stored: dict, exact: tuple) -> None:
    """Print every field of the stored bench row beside the card's, and
    require equality where the live reference reproduces the stored value."""
    parts = []
    for key, want in stored.items():
        got = mine.get(key)
        parts.append(f"{key} {got} (stored {want})")
    print(f"{label}: " + "; ".join(parts) + f"; wall {mine['wall_s']:.2f} s a run")
    for key in exact:
        same = (round(mine[key] * 1e6 * len(CHAOS_SEEDS)) == round(stored[key] * 1e6 * len(CHAOS_SEEDS))
                if key.endswith("_MB") else mine[key] == stored[key])
        check(same, f"{label}: {key} {mine[key]} differs from the stored bench's {stored[key]}")


def chaos_sweeps(rnn_params: dict, parts: tuple = ("faults", "defense")) -> dict:
    """Phase 3h: the reference's fault and defense sweeps at rate 0.1, seeds
    0-2, on the card: ``bench_faults.py``'s retry and drop arms (``har``, 32
    clients, 2,400 s, 30 s windows) and ``bench_defense.py``'s guard-on and
    guard-off arms (16 clients, 1,800 s, per event and at 30 s). Every field
    is printed beside ``BENCH_faults.json``'s and ``BENCH_defense.json``'s;
    FAULT_EXACT and DEFENSE_EXACT must equal them. Every guard-on run ends
    with finite centers and no NaN in its curve, and its coalesced runs
    launch the chain with the norm statistic (and never without). ``parts``
    picks the sweeps (``merge_chaos`` joins two parts' results)."""
    stored_f = json.loads((ROOT / "BENCH_faults.json").read_text())["by_rate"][str(CHAOS_RATE)]
    stored_d = json.loads((ROOT / "BENCH_defense.json").read_text())["by_rate"][str(CHAOS_RATE)]
    out: dict = {"faults": {}, "defense": {}}
    host: Counter = Counter()
    walls, with_norm = 0.0, 0
    for policy in ("retry", "drop") if "faults" in parts else ():
        runs = [chaos_run(FAULT_SWEEP["clients"], s, FAULT_SWEEP["windows"]["coalesced"], FAULT_SWEEP["horizon"],
                          _fault_plan(CHAOS_RATE, policy, seed=s), None, rnn_params) for s in CHAOS_SEEDS]
        arm = _mean_arm(runs)
        _beside(f"chaos faults {policy}", arm, stored_f[policy], FAULT_EXACT)
        check(all(r["chains_without"] == r["chain_launches"] > 0 for r in runs),
              f"chaos faults {policy}: the guard-off runs must launch the chain without the norm")
        out["faults"][policy] = arm
        for r in runs:
            host.update(r["host"])
            walls += r["wall_s"]
    for wname, window in DEFENSE_SWEEP["windows"].items() if "defense" in parts else ():
        for arm_name, guard in (("guard_off", "off"), ("guard_on", "on")):
            runs = [chaos_run(DEFENSE_SWEEP["clients"], s, window, DEFENSE_SWEEP["horizon"],
                              _fault_plan(0.0, poison=CHAOS_RATE, seed=s), guard, rnn_params) for s in CHAOS_SEEDS]
            arm = _mean_arm(runs)
            label = f"chaos defense {wname} {arm_name}"
            _beside(label, arm, stored_d[wname][arm_name], DEFENSE_EXACT[arm_name])
            if guard == "on":
                check(all(r["nonfinite_centers"] == 0 and not r["any_nan_acc"] for r in runs),
                      f"{label}: a guard-on run ended with a non-finite center or a NaN accuracy")
                if window:
                    check(all(r["chains_with_stats"] == r["chain_launches"] > 0 and r["chains_without"] == 0
                              for r in runs), f"{label}: the chain must launch with the norm statistic, and only so")
                    print(f"{label}: ingest_chain with the norm {[r['chains_with_stats'] for r in runs]} launches")
            out["defense"][f"{wname} {arm_name}"] = arm
            for r in runs:
                host.update(r["host"])
                walls += r["wall_s"]
                with_norm += r["chains_with_stats"]
    for bucket in sorted(host):
        print(f"  chaos host time {bucket:<40} {host[bucket]:8.3f} s ({100 * host[bucket] / walls:5.1f}%)")
    out["wall_s"] = walls
    out["host"] = dict(host)
    out["chains_with_stats"] = with_norm
    print(f"chaos sweeps ({', '.join(parts)}): {walls:.2f} s of runs")
    return out


def merge_chaos(*outs: dict) -> dict:
    """One ``chaos_sweeps`` result from those of its parts."""
    host: Counter = Counter()
    for o in outs:
        host.update(o["host"])
    return {"faults": {k: v for o in outs for k, v in o["faults"].items()},
            "defense": {k: v for o in outs for k, v in o["defense"].items()},
            "wall_s": sum(o["wall_s"] for o in outs), "host": dict(host),
            "chains_with_stats": sum(o["chains_with_stats"] for o in outs)}


# ----------------------------------------------------------------- phase 3j
def margin_rule(tokens: torch.Tensor, ref_logits: torch.Tensor, vocab: int, tol: float, label: str) -> int:
    """Greedy ``tokens (B, n)`` against the argmax of ``ref_logits (n, B,
    V)`` wherever the reference's top-2 margin exceeds ``tol``; returns the
    number of positions exempt (margin at most ``tol``)."""
    top2 = torch.topk(ref_logits[..., :vocab], 2, dim=-1)
    margin = (top2.values[..., 0] - top2.values[..., 1]).T
    firm = margin > tol
    same = tokens.to(top2.indices.device) == top2.indices[..., 0].T
    bad = int((firm & ~same).sum())
    check(bad == 0, f"{label}: {bad} tokens differ from the reference's argmax where its top-2 margin exceeds {tol}")
    return int((~firm).sum())


def serving_phase(rnn_params: dict) -> dict:
    """gemma2-2b at full width (2.61 B parameters in fp32, random weights
    from a generator seeded 0 on the card) through the serving entry point's
    ``repro_torch.launch.serve.serve`` (what ``python -m
    repro_torch.launch.serve --arch gemma2-2b`` runs) at SERVE_CASES: the
    prefill through the flash forward kernel at head width 256 (window
    4,096 on the local layers, softcap 50), one launch a layer and no
    kernel of ours in the decode; each decode step's logits against a
    teacher-forced full forward over the prompt and the tokens, within
    SERVE_ATOL, and the greedy tokens its argmax wherever its top-2 margin
    exceeds SERVE_ATOL. Prints the prefill time, the decode tokens/s and the
    peak memory. Then the pytree backend (``pytree_phase``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import forward

    cfg = get_config("gemma2-2b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out, params = {}, None
    shapes, restore = _record_flash_shapes(ops)
    try:
        for label, kw in SERVE_CASES.items():
            torch.cuda.reset_peak_memory_stats()
            res = serve.serve(cfg, device=DEVICE, params=params, keep_logits=True, verbose=False, **kw)
            params = res["params"]
            peak = torch.cuda.max_memory_allocated()
            pre, dec = res["launches"]["prefill"], res["launches"]["decode"]
            check(pre["flash_attention_fwd"] == cfg.num_layers and sum(pre.values()) == cfg.num_layers,
                  f"serving {label}: prefill launches {pre}, not {cfg.num_layers} flash forwards")
            check(sum(dec.values()) == 0, f"serving {label}: the decode launched {dec}")
            toks = torch.from_numpy(res["tokens"]).to(DEVICE)
            with torch.no_grad():
                full = forward(cfg, params, {"tokens": torch.cat([res["prompts"], toks], dim=1)},
                               last=kw["gen"] + 1)[0].transpose(0, 1)  # (gen + 1, B, V)
            got = torch.stack(res["logits"])
            check(got.shape == full.shape == (kw["gen"] + 1, kw["batch"], cfg.padded_vocab)
                  and bool(torch.isfinite(got).all()), f"serving {label}: logits {tuple(got.shape)} not finite")
            err = (got - full).abs().max().item()
            check(err <= SERVE_ATOL, f"serving {label}: decode logits differ from the full forward by {err}")
            exempt = margin_rule(toks, full[:-1], cfg.vocab_size, SERVE_ATOL, f"serving {label}")
            tps = kw["batch"] * kw["gen"] / res["decode_s"]
            out[label] = {**kw, "prefill_s": res["prefill_s"], "decode_s": res["decode_s"], "decode_tok_s": tps,
                          "peak_GiB": peak / 2**30, "max_abs_err": err, "exempt": exempt,
                          "flash_prefill": pre["flash_attention_fwd"]}
            print(f"serving {label} (gemma2-2b full width, batch {kw['batch']}, prompt {kw['prompt']}, gen "
                  f"{kw['gen']}): prefill {res['prefill_s']:.4f} s, decode {res['decode_s']:.4f} s ({tps:.2f} "
                  f"tokens/s), peak {peak / 2**30:.2f} GiB; flash forward launches {pre['flash_attention_fwd']} in "
                  f"the prefill, {dec['flash_attention_fwd']} in the decode; decode against the teacher-forced "
                  f"full forward max |diff| {err:.3g} (tolerance {SERVE_ATOL}), tokens its argmax where the "
                  f"margin exceeds that, {exempt} of {toks.numel()} positions exempt; "
                  f"sample {res['tokens'][0, :8].tolist()}")
            del res, full, got, toks
            if label == "a":
                out["decode_profile"] = decode_profile(cfg, params)
    finally:
        restore()
    del params
    torch.cuda.empty_cache()
    out["flash_shapes"] = shapes
    out["pytree"] = pytree_phase(rnn_params)
    out["wall"] = time.perf_counter() - t0
    print(f"phase 3j: {out['wall']:.1f} s")
    return out


def decode_profile(cfg, params, steps: int = 8, kw: dict = SERVE_CASES["a"]) -> dict:
    """Device kernels a decode step and the device's idle share: a fresh
    prefill at ``kw``'s shape (other prompts), then ``steps`` decode steps
    under ``torch.profiler``."""
    from repro_torch.launch import serve

    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (kw["batch"], kw["prompt"]), generator=g).to(DEVICE)
    logits, cache = serve.prefill(cfg, params, prompts, steps)

    def run():
        t0 = time.perf_counter()
        serve.decode(cfg, params, cache, logits, steps)
        sync()
        return time.perf_counter() - t0

    prof, wall = _device_trace(run)
    events = _device_events(prof)
    busy = sum(e.us for e in events) / 1e6
    per = _device_us(events)
    out = {"kernels_a_step": len(events) / steps, "busy_ms_a_step": 1e3 * busy / steps,
           "wall_ms_a_step": 1e3 * wall / steps, "idle_share": 1 - busy / wall}
    print(f"decode profile ({cfg.name}, batch {kw['batch']}, {steps} steps after a {kw['prompt']}-token prefill): "
          f"{out['kernels_a_step']:.1f} device kernels a step, busy {out['busy_ms_a_step']:.3f} ms of "
          f"{out['wall_ms_a_step']:.3f} ms a step under the profiler, idle share {out['idle_share']:.4f}; top: "
          + "; ".join(f"{name[:60]} {us / 1e3 / steps:.3f} ms" for name, us in per.most_common(4)))
    return out


def pytree_phase(rnn_params: dict) -> dict:
    """The pytree backend on the card: ``image_recognition`` per event
    (PYTREE_RUN, phase 3's broadcast RNN), pytree against plane. Identical
    ledgers, curves, events, assignments, staleness, centers and anchors
    (bit for bit) and ``stats()`` (its backend fields aside; the feedback
    means within rtol 1e-5). The pytree run assigns through
    ``l1_distance`` (no fused assign, no chain) and merges through
    ``merge_attention``, each launched; its launch counts are printed."""
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.kernels import ops

    runs = {}
    for backend in ("pytree", "plane"):
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, strat, rep = run_experiment("image_recognition", "echopfl", device=DEVICE, rnn_params=rnn_params,
                                          plane_backend=backend, **PYTREE_RUN)
        sync()
        runs[backend] = (strat, rep, ops.launch_counts(), time.perf_counter() - t0)
    (ts, tr, tc, tw), (ps, pr, pc, pw) = runs["pytree"], runs["plane"]
    for name in ("up_events", "down_events", "up_bytes", "down_bytes", "duration", "up_series", "down_series",
                 "curve"):
        check(getattr(tr, name) == getattr(pr, name), f"pytree on the card: {name} differs from the plane run's")
    check(ts.events == ps.events and ts.clustering.assignment == ps.clustering.assignment
          and ts.staleness.snapshot() == ps.staleness.snapshot(), "pytree on the card: decisions differ")
    check(sorted(ts.clustering.clusters) == sorted(ps.clustering.clusters) and all(
        _same_bits(c.center_vec, ts.clustering.clusters[cid].center_vec)
        and _same_bits(c.broadcast_vec, ts.clustering.clusters[cid].broadcast_vec)
        for cid, c in ps.clustering.clusters.items()), "pytree on the card: centers differ from the plane run's")
    st, sp = ts.stats(), ps.stats()
    check(st.pop("backend") == "pytree" and st.pop("plane_rows") == 0 and sp.pop("backend") == "plane"
          and sp.pop("plane_rows") > 0, "pytree on the card: backend fields")
    fb_t, fb_p = st.pop("cluster_feedback_mean"), sp.pop("cluster_feedback_mean")
    check(st == sp and fb_t.keys() == fb_p.keys()
          and all(abs(fb_t[c] - fb_p[c]) <= 1e-5 * abs(fb_p[c]) for c in fb_p), "pytree on the card: stats differ")
    check(tc["assign_and_lerp"] == tc["ingest_chain"] == 0 and tc["l1_distance"] > 0 and tc["merge_attention"] > 0,
          f"pytree on the card: launches {tc} (an assign is one l1_distance, a merge one merge_attention)")
    print(f"pytree backend on the card (image_recognition, {PYTREE_RUN['num_clients']} clients, "
          f"{PYTREE_RUN['max_time']} s, hm {PYTREE_RUN['hm']}, per event): {tr.extra['uploads']} uploads, {len(ts.events)} events, "
          f"clusters {st['clusters']}, merges {st['merges']}, identical to the plane run (centers bit for bit); "
          f"launches pytree l1_distance {tc['l1_distance']}, merge_attention {tc['merge_attention']}, "
          f"l1_distance_pairwise {tc['l1_distance_pairwise']}, chi2 {tc['chi2_feedback']} + "
          f"{tc['chi2_feedback_segmented']}; plane l1_distance {pc['l1_distance']}, assign_and_lerp "
          f"{pc['assign_and_lerp']}, merge_attention {pc['merge_attention']}; wall pytree {tw:.2f} s, plane {pw:.2f} s")
    return {"uploads": tr.extra["uploads"], "pytree": tc, "plane": pc, "wall": {"pytree": tw, "plane": pw}}


# ----------------------------------------------------------------- phase 3k
def _largest_leaf(tree, path: str = "") -> tuple[str, torch.Tensor | None]:
    if isinstance(tree, dict):
        items = ((f"{path}.{k}" if path else k, v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"{path}[{i}]", v) for i, v in enumerate(tree))
    else:
        return path, tree
    best = ("", None)
    for p, v in items:
        cand = _largest_leaf(v, p)
        if cand[1] is not None and (best[1] is None or cand[1].numel() > best[1].numel()):
            best = cand
    return best


class Routing:
    """The MoE layers' top-k choices (``models.layers.top_k``) in call
    order: ``record`` keeps each call's experts and the margin of the k-th
    probability over the next, ``replay`` hands recorded experts back (with
    the current probabilities at them), so that a second computation can be
    held to a first under the same routing. Two computations that round a
    router's logits differently (cuBLAS picks its kernels by shape) route a
    token whose k-th and next probabilities are that close to different
    experts, a jump in its output."""

    def __init__(self):
        from repro_torch.models import layers

        self.layers, self.top_k, self.calls = layers, layers.top_k, []

    def record(self) -> None:
        self.calls = []

        def rec(probs, k):
            values, indices = self.top_k(probs, k + 1)
            self.calls.append((indices[..., :k], values[..., k - 1] - values[..., k]))
            return values[..., :k], indices[..., :k]

        self.layers.top_k = rec

    def replay(self, chosen: list) -> None:
        it = iter(chosen)

        def rep(probs, k):
            indices = next(it)
            return probs.gather(-1, indices), indices

        self.layers.top_k = rep

    def pin(self, chosen: list) -> None:
        """``replay``, keeping beside each call the tokens the free top-k
        would route otherwise (another set of experts) and their k-th over
        next margins (``moved``)."""
        it = iter(chosen)
        self.calls = []

        def rep(probs, k):
            indices = next(it)
            values, free = self.top_k(probs, k + 1)
            moved = (free[..., :k].sort(-1).values != indices.sort(-1).values).any(-1)
            self.calls.append((int(moved.sum()), (values[..., k - 1] - values[..., k])[moved]))
            return probs.gather(-1, indices), indices

        self.layers.top_k = rep

    def moved(self) -> tuple[int, float]:
        """After ``pin``: the token-layers the free routing would move, and
        the largest of their margins."""
        margins = [m for _, m in self.calls if m.numel()]
        return sum(n for n, _ in self.calls), max((float(m.max()) for m in margins), default=0.0)

    def restore(self) -> None:
        self.layers.top_k = self.top_k


def _pinned_routing(calls: list, n_moe: int, batch: int, prompt: int, gen: int) -> list:
    """The experts a teacher-forced forward over prompt and tokens would
    take if it routed as the prefill and the decode steps did: per MoE
    layer, the prefill's ``(batch, prompt)`` choices and each step's
    ``(batch, 1)``, token-major as the forward groups them."""
    pre, dec = calls[:n_moe], calls[n_moe:]
    k = pre[0][0].shape[-1]
    return [torch.cat([pre[l][0].reshape(batch, prompt, k)]
                      + [dec[s * n_moe + l][0].reshape(batch, 1, k) for s in range(gen)], dim=1).reshape(1, -1, k)
            for l in range(n_moe)]


def zoo_serving_phase() -> dict:
    """deepseek-v2-lite-16b at full width (15.7 B parameters, 2.66 B active
    a token, in fp32; random weights from a generator seeded 0 on the card;
    depth uncut: a dense prefix layer and 26 MoE layers, MLA in all 27)
    through the serving entry point's ``repro_torch.launch.serve.serve``
    (what ``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b``
    runs) at ZOO_SERVE: (a) with ``moe_dropless``, the prefill through the
    flash forward kernel at head width 192 and value width 128, one launch a
    layer, and no kernel of ours in the decode (MLA's absorbed decode and the
    MoE are plain PyTorch); each decode step's logits against a
    teacher-forced full forward routed as the prefill and the decode were
    (``Routing``) within SERVE_ATOL, and the greedy tokens its argmax
    wherever its top-2 margin exceeds SERVE_ATOL; the same forward routing
    freely is printed beside it, with the tokens it routes otherwise and
    their margins (random weights leave top-k margins down to 1e-7, under
    what rounding moves); (b) the serving
    entry point's default capacity dispatch (capacity factor 1.25: one slot an
    expert at a decode step of 2 tokens), the same launches and finite
    logits. Prints the prefill time, the decode tokens/s, the peak memory,
    the largest leaf and the analytic parameter counts, and profiles 8
    decode steps of each (kernels a step, idle share)."""
    import dataclasses

    from repro_torch.common.pytrees import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import forward

    base = get_config("deepseek-v2-lite-16b")
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out, params = {}, None
    shapes, restore = _record_flash_shapes(ops)
    try:
        for label, cfg in (("a", dataclasses.replace(base, moe_dropless=True)), ("b", base)):
            kw = ZOO_SERVE
            torch.cuda.reset_peak_memory_stats()
            routing = Routing()
            if cfg.moe_dropless:
                routing.record()
            t1 = time.perf_counter()
            try:
                res = serve.serve(cfg, device=DEVICE, params=params, keep_logits=True, verbose=False, **kw)
            finally:
                routing.restore()
            wall = time.perf_counter() - t1
            peak = torch.cuda.max_memory_allocated()
            if params is None:
                params = res["params"]
                leaf_path, leaf = _largest_leaf(params)
                n_tree = sum(t.numel() for t in tree_leaves(params))
                out["weights"] = {"draw_s": wall - res["prefill_s"] - res["decode_s"], "tree_params": n_tree,
                                  "param_count": base.param_count(), "active_param_count": base.active_param_count(),
                                  "GiB": 4 * n_tree / 2**30, "largest_leaf": leaf_path,
                                  "largest_leaf_shape": list(leaf.shape), "largest_leaf_GiB": 4 * leaf.numel() / 2**30,
                                  "resident_before_GiB": resident / 2**30}
                w = out["weights"]
                print(f"deepseek-v2-lite-16b weights: {n_tree:,} elements in the tree ({w['GiB']:.2f} GiB fp32), "
                      f"param_count {w['param_count']:,}, active_param_count {w['active_param_count']:,}; largest "
                      f"leaf {leaf_path} {tuple(leaf.shape)} ({w['largest_leaf_GiB']:.2f} GiB); drawn in "
                      f"{w['draw_s']:.2f} s; {resident / 2**30:.2f} GiB resident before the phase")
                del leaf
            pre, dec = res["launches"]["prefill"], res["launches"]["decode"]
            check(pre["flash_attention_fwd"] == cfg.num_layers == 27 and sum(pre.values()) == cfg.num_layers,
                  f"zoo serving {label}: prefill launches {pre}, not {cfg.num_layers} flash forwards")
            check(sum(dec.values()) == 0, f"zoo serving {label}: the decode launched {dec}")
            got = torch.stack(res["logits"])  # (gen + 1, B, V)
            check(got.shape == (kw["gen"] + 1, kw["batch"], cfg.padded_vocab) and bool(torch.isfinite(got).all()),
                  f"zoo serving {label}: logits {tuple(got.shape)} not finite")
            row = {**kw, "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
                   "decode_tok_s": kw["batch"] * kw["gen"] / res["decode_s"], "peak_GiB": peak / 2**30,
                   "flash_prefill": pre["flash_attention_fwd"], "moe_dropless": cfg.moe_dropless}
            note = "logits finite"
            if cfg.moe_dropless:
                toks = torch.from_numpy(res["tokens"]).to(DEVICE)
                n_moe = sum(spec.ffn == "moe" for spec in cfg.all_layers)
                check(len(routing.calls) == n_moe * (kw["gen"] + 1),
                      f"zoo serving {label}: {len(routing.calls)} MoE calls, not {n_moe} a prefill and a step")
                chosen = _pinned_routing(routing.calls, n_moe, kw["batch"], kw["prompt"], kw["gen"])
                batch = {"tokens": torch.cat([res["prompts"], toks], dim=1)}
                try:
                    with torch.no_grad():
                        routing.replay(chosen)
                        full = forward(cfg, params, batch, last=kw["gen"] + 1)[0].transpose(0, 1)
                        routing.record()
                        free = forward(cfg, params, batch, last=kw["gen"] + 1)[0].transpose(0, 1)
                finally:
                    routing.restore()
                err = (got - full).abs().max().item()
                check(err <= SERVE_ATOL, f"zoo serving {label}: decode logits differ from the full forward routed as "
                                         f"they were by {err}")
                exempt = margin_rule(toks, full[:-1], cfg.vocab_size, SERVE_ATOL, f"zoo serving {label}")
                moved = [(c != f[0].reshape(c.shape)).any(-1).reshape(-1) for c, f in zip(chosen, routing.calls)]
                margins = [f[1].reshape(-1)[m] for m, f in zip(moved, routing.calls)]
                rerouted = sum(int(m.sum()) for m in moved)
                top_margin = max((float(m.max()) for m in margins if m.numel()), default=0.0)
                free_err = (got - free).abs().max().item()
                row.update(max_abs_err=err, exempt=exempt, free_max_abs_err=free_err, rerouted=rerouted,
                           rerouted_margin_max=top_margin)
                note = (f"decode against the teacher-forced full forward routed as they were max |diff| {err:.3g} "
                        f"(tolerance {SERVE_ATOL}), tokens its argmax where the margin exceeds that, {exempt} of "
                        f"{toks.numel()} positions exempt; the forward routing freely {free_err:.3g} away, "
                        f"{rerouted} of {n_moe * batch['tokens'].numel()} token-layers routed otherwise, at top-k "
                        f"margins up to {top_margin:.3g}")
                del toks, full, free, chosen
            out[label] = row
            print(f"zoo serving {label} (deepseek-v2-lite-16b full width, {'dropless' if cfg.moe_dropless else 'capacity 1.25'}, "
                  f"batch {kw['batch']}, prompt {kw['prompt']}, gen {kw['gen']}): prefill {res['prefill_s']:.4f} s, "
                  f"decode {res['decode_s']:.4f} s ({row['decode_tok_s']:.2f} tokens/s), peak {peak / 2**30:.2f} GiB; "
                  f"flash forward launches {pre['flash_attention_fwd']} in the prefill, {dec['flash_attention_fwd']} in "
                  f"the decode; {note}; sample {res['tokens'][0, :8].tolist()}")
            del res, got
            out[f"decode_profile {label}"] = decode_profile(cfg, params, kw=ZOO_SERVE)
    finally:
        restore()
    del params
    torch.cuda.empty_cache()
    out["flash_shapes"] = shapes
    out["wall"] = time.perf_counter() - t0
    print(f"phase 3k: {out['wall']:.1f} s")
    return out


# ----------------------------------------------------------------- phase 3l
def recomputed_attention(cfg) -> int:
    """Attention layers a train step runs twice under remat: those of the
    periods (the prefix is not wrapped)."""
    if not cfg.train.remat:
        return 0
    return cfg.num_periods * sum(spec.mixer in ("attn", "attn_local") for spec in cfg.pattern)


def _tree_bits_equal(a, b) -> bool:
    """Two trees (tensors or numpy leaves) equal leaf for leaf, bit for bit."""
    from repro_torch.common.pytrees import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu())
                                      for x, y in zip(la, lb))


def training_phase(rnn_params: dict) -> dict:
    """Training through the port's entry points. (a) llama3.2-1b at full
    width (1.24 B parameters, fp32, AdamW, weights drawn on the card from a
    generator seeded 0, depth uncut) through ``repro_torch.launch.train.train``
    at train_4k's 4,096 tokens: one step at batch 1 with remat on and with
    it off, the loss and every param identical; then TRAIN_FULL's 8 steps
    at batch 2 with remat on, launch counts zeroed just before and read just
    after: 32 flash forward launches a step (16 layers, each recomputed)
    and 16 of each backward kernel, all at TRAIN_FLASH, every loss finite and
    the last below the first; s a step, tokens/s, peak memory. (b) The
    driver's checkpoints at reduced llama3.2-1b: stopped at 3 steps (saved
    at 3), the checkpoint equal to the stopped state bit for bit, then
    resumed to 6 twice from copies of it, the two resumed runs identical;
    the checkpoint's bytes, save and restore times. (c) The EchoPFL
    transformer-client example (``repro_torch.launch.train_async_pfl``,
    phase 3's broadcast RNN handed over) killed at round 150 and resumed to
    300: its own assertion on the killed half and over the whole run (the
    resumed half alone fails it, as the reference's ``--resume`` does), the
    restored server's state equal to the saved one bit for bit, launches by
    name and rounds per second."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.server import EchoPFLServer
    from repro_torch.kernels import ops
    from repro_torch.launch import train as driver
    from repro_torch.launch import train_async_pfl as example
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.common.pytrees import tree_leaves

    t0 = time.perf_counter()
    out = {}
    cfg = get_config("llama3.2-1b")
    seq = SHAPES["train_4k"].seq_len
    check(seq == TRAIN_FULL["seq"] == TRAIN_FLASH[2], f"phase 3l: train_4k's length {seq}")
    torch.cuda.empty_cache()
    # (a) remat on against off, one step at 1 x 4,096
    res = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=remat))
        resident = torch.cuda.memory_allocated()
        r = driver.train(c, steps=1, batch=1, seq=seq, device=DEVICE, verbose=False)
        res[remat] = {"loss": r["losses"][0], "params": r["state"].params, "step_s": r["step_s"][0],
                      "peak_GiB": r["peak_bytes"] / 2**30, "resident_GiB": resident / 2**30}
        del r
        torch.cuda.empty_cache()
    on, off = res[True], res[False]
    check(math.isfinite(on["loss"]) and on["loss"] == off["loss"],
          f"phase 3l: remat on / off losses {on['loss']} / {off['loss']}")
    check(_tree_bits_equal(on["params"], off["params"]), "phase 3l: remat changed a param bit")
    out["remat"] = {k: {f: v[f] for f in ("loss", "step_s", "peak_GiB", "resident_GiB")} for k, v in
                    (("on", on), ("off", off))}
    print(f"phase 3l remat (llama3.2-1b full width, one step at 1 x {seq}): loss {on['loss']:.6f} on and off, every "
          f"param bit identical; peak {on['peak_GiB']:.2f} GiB with remat, {off['peak_GiB']:.2f} GiB without "
          f"({off['resident_GiB']:.2f} GiB of the first run's params resident); step {on['step_s']:.3f} / "
          f"{off['step_s']:.3f} s (the first step of each run)")
    del res, on, off
    torch.cuda.empty_cache()
    # 8 steps at 2 x 4,096 with remat on
    shapes, restore = _record_flash_shapes(ops)
    sync()
    ops.reset_launch_counts()
    try:
        r = driver.train(cfg, steps=TRAIN_FULL["steps"], batch=TRAIN_FULL["batch"], seq=seq, device=DEVICE,
                         log_every=1)
        sync()
    finally:
        restore()
    counts = ops.launch_counts()
    steps, n_layers = TRAIN_FULL["steps"], cfg.num_layers
    losses = r["losses"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"phase 3l: losses {losses}")
    check(counts["flash_attention_fwd"] == steps * (n_layers + recomputed_attention(cfg)) == steps * 32
          and counts["flash_attention_dq"] == counts["flash_attention_dkv"] == steps * n_layers,
          f"phase 3l: launches {counts}, not 32 forward and 16 of each backward kernel a step")
    check(shapes == Counter({TRAIN_FLASH: counts["flash_attention_fwd"]}), f"phase 3l: flash shapes {dict(shapes)}")
    check(sum(counts.values()) == counts["flash_attention_fwd"] + 2 * counts["flash_attention_dq"],
          f"phase 3l: other kernels launched: {counts}")
    tokens = TRAIN_FULL["batch"] * seq
    steady = r["step_s"][1:]
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(r["state"]))  # the state it placed
    out["full"] = {**TRAIN_FULL, "losses": losses, "step_s": r["step_s"], "steady_step_s": statistics.mean(steady),
                   "state_bytes": state_bytes,
                   "tokens_per_s": tokens / statistics.mean(steady), "driver_tokens_per_s": r["tokens_per_s"],
                   "peak_GiB": r["peak_bytes"] / 2**30, "launches": counts}
    f = out["full"]
    print(f"phase 3l full width (llama3.2-1b, {steps} steps at {TRAIN_FULL['batch']} x {seq}, remat, AdamW): losses "
          f"{[round(x, 4) for x in losses]}; {f['steady_step_s']:.3f} s a step after the first "
          f"({r['step_s'][0]:.3f} s), {f['tokens_per_s']:,.0f} tokens/s ({f['driver_tokens_per_s']:,.0f} over the "
          f"run); peak {f['peak_GiB']:.2f} GiB; launches {json.dumps(counts)} at {TRAIN_FLASH}")
    del r
    torch.cuda.empty_cache()

    small = reduced_config(cfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # (b) the driver's checkpoints: stopped at 3, resumed to 6 twice
        kw = dict(batch=TRAIN_CKPT["batch"], seq=TRAIN_CKPT["seq"], device=DEVICE, ckpt_every=TRAIN_CKPT["kill"],
                  verbose=False)
        root = os.path.join(tmp, "driver")
        first = driver.train(small, steps=TRAIN_CKPT["kill"], ckpt_dir=root, **kw)
        step_dir = os.path.join(root, f"step_{TRAIN_CKPT['kill']:010d}")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, n)) for n in os.listdir(step_dir))
        t1 = time.perf_counter()
        saved, extra = restore_pytree(step_dir, like=first["state"])
        restore_s = time.perf_counter() - t1
        check(_tree_bits_equal(saved, first["state"]) and extra == {"loss": first["losses"][-1]},
              "phase 3l: the driver's checkpoint differs from the stopped state")
        sync()
        t1 = time.perf_counter()
        save_pytree(os.path.join(tmp, "timed", "step"), first["state"], extra)
        save_s = time.perf_counter() - t1
        resumed = []
        for i in range(2):
            d = os.path.join(tmp, f"resume{i}")
            shutil.copytree(step_dir, os.path.join(d, os.path.basename(step_dir)))
            resumed.append(driver.train(small, steps=TRAIN_CKPT["steps"], ckpt_dir=d, **kw))
        a, b = resumed
        check(a["start"] == b["start"] == TRAIN_CKPT["kill"] and len(a["losses"]) == TRAIN_CKPT["steps"] - a["start"],
              f"phase 3l: resumed at {a['start']}, {b['start']}")
        check(a["losses"] == b["losses"] and _tree_bits_equal(a["state"], b["state"]),
              f"phase 3l: two resumed runs differ: {a['losses']} / {b['losses']}")
        out["checkpoint"] = {**TRAIN_CKPT, "bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
                             "losses": first["losses"], "resumed_losses": a["losses"]}
        print(f"phase 3l checkpoints (reduced llama3.2-1b, {TRAIN_CKPT['batch']} x {TRAIN_CKPT['seq']}): stopped at "
              f"{TRAIN_CKPT['kill']} (losses {[round(x, 4) for x in first['losses']]}), the checkpoint the stopped "
              f"state bit for bit, {nbytes:,} B; save {1e3 * save_s:.1f} ms, restore {1e3 * restore_s:.1f} ms; "
              f"resumed to {TRAIN_CKPT['steps']} twice, identical (losses {[round(x, 4) for x in a['losses']]})")
        del first, saved, resumed, a, b

        # (c) the example, killed and resumed
        d = os.path.join(tmp, "example")
        runs = {}
        for label, kw in (("killed", dict(steps=EXAMPLE_RUN["kill"])),
                          ("resumed", dict(steps=EXAMPLE_RUN["steps"], resume=True))):
            sync()
            ops.reset_launch_counts()
            run = example.run(DEVICE, ckpt_dir=d, rnn_params=rnn_params, verbose=False, **kw)
            sync()
            runs[label] = (run, ops.launch_counts())
            if label == "killed":
                example.check_losses_fall(run)
                tree, meta = run["server"].state_dict()
                fresh = EchoPFLServer(run["server"].init_params, num_initial_clusters=2, seed=0,
                                      rnn_params=rnn_params, device=DEVICE)
                check(example.restore_server(fresh, d) == EXAMPLE_RUN["kill"], "phase 3l: no example checkpoint")
                got, got_meta = fresh.state_dict()
                check(got_meta == meta and _tree_bits_equal(got, tree),
                      "phase 3l: the restored server state differs from the saved one")
                del tree, got, fresh
        out["example"] = {}
        for label, (run, counts) in runs.items():
            n = len(run["order"])
            for name in LM_PATH + ("l1_distance",):
                check(counts[name] > 0, f"phase 3l example {label}: kernel {name} never launched")
            check(counts["flash_attention_dq"] == counts["flash_attention_dkv"],
                  f"phase 3l example {label}: dq and dkv launches differ")
            out["example"][label] = {"start": run["start"], "rounds": n, "wall_s": run["wall_s"],
                                     "rounds_per_s": n / run["wall_s"], "assignment": run["assignment"],
                                     "clusters": run["stats"]["clusters"], "broadcasts": run["stats"]["broadcasts"],
                                     "merges": run["stats"]["merges"], "launches": counts}
            e = out["example"][label]
            print(f"phase 3l example {label} (rounds {run['start']}..{run['start'] + n}): {e['rounds_per_s']:.2f} "
                  f"rounds/s ({e['wall_s']:.2f} s), clusters {e['clusters']}, broadcasts {e['broadcasts']}, merges "
                  f"{e['merges']}, assignment {e['assignment']}, each client's first and last round loss "
                  f"{ {i: (round(v[0], 4), round(v[-1], 4)) for i, v in run['losses'].items() if v} }; "
                  f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
        check(out["example"]["resumed"]["start"] == EXAMPLE_RUN["kill"], "phase 3l: the example did not resume")
        # the resumed half alone replays each client's stream from its start, which the restored server has
        # trained on, so its first losses are low and it fails the example's assertion, as the reference's
        # --resume does (ROADMAP queue 3); over the whole run, first losses of the killed half against the last
        # of the resumed half, it must hold
        killed, resumed = runs["killed"][0], runs["resumed"][0]
        example.check_losses_fall({"losses": {i: [killed["losses"][i][0], resumed["losses"][i][-1]]
                                              for i in killed["losses"]}})
        print("phase 3l example: every client's loss fell in the killed half and from its first round to its last "
              "over the whole run (the resumed half alone starts on batches the restored server has trained on)")
        del runs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["flash_shapes"] = shapes
    out["wall"] = time.perf_counter() - t0
    print(f"phase 3l: {out['wall']:.1f} s")
    return out


# ----------------------------------------------------------------- phase 3n
def _pod_on_card(multi_pod: bool = False):
    """The pod (16 x 16) or multipod (2 x 16 x 16) mesh over the one card."""
    from repro_torch.common.device import resolve_device
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=multi_pod, devices=[resolve_device(DEVICE)] * (512 if multi_pod else 256))


def _record_first_grads(host: bool = False):
    """Keep the first train step's gradients (whole leaves in tree order, as
    the step hands them to the clipping): through ``_sharded_update`` under
    a model mesh, through ``clip_by_global_norm`` without one; with
    ``host`` as copies in host memory, off the card's budget."""
    from repro_torch.common.pytrees import tree_leaves
    from repro_torch.launch import sharded
    from repro_torch.models import steps

    kept: list = []
    update, clip = steps._sharded_update, steps.clip_by_global_norm
    where = torch.device("cpu") if host else None

    def rec_update(cfg, opt, state, grads):
        if not kept:
            kept.extend(tree_leaves(sharded.gather_tree(grads, where)))
        return update(cfg, opt, state, grads)

    def rec_clip(grads, max_norm):
        if not kept:
            kept.extend(t.to(where) if host else t for t in tree_leaves(grads))
        return clip(grads, max_norm)

    steps._sharded_update, steps.clip_by_global_norm = rec_update, rec_clip

    def restore():
        steps._sharded_update, steps.clip_by_global_norm = update, clip

    return kept, restore


def model_mesh_phase() -> dict:
    """The dense decoders on model meshes that repeat the card (phase 3n).
    (a) llama3.2-1b at full width (1.236 B parameters, fp32, weights from a
    generator seeded 0 on the card, depth uncut) served through
    ``repro_torch.launch.serve.serve`` at MESH_SERVE on the pod mesh (16 x 16
    over the card, 256 shards) and without a mesh: prefill logits within
    SERVE_ATOL, tokens under the margin rule, MESH_SERVE's flash forward
    launches a prefill 16 layers x 16 x 16, the mesh arm's peak (from the
    prefill on, the placed weights included) at most 1.25 x the unmeshed
    arm's. (b) The same weights trained through ``repro_torch.launch.train.
    train`` at MESH_TRAIN on the pod mesh and without one: each step's loss
    within 1e-5 relative, the first step's gradients within 1e-4 of each
    leaf's max |g|, the flash launches a step the mesh and remat predict.
    (c) Reduced llama3.2-1b and tiny_lm on the multipod mesh (2 x 16 x 16,
    512 shards): driver steps stopped after 2 and resumed to 3, the resumed
    step bit for bit the uninterrupted run's, which steps the state at 2 on
    the stream's first batch (a resumed run draws from the stream's start,
    as the reference's); and on the smoke mesh, serving and training bit
    for bit the unmeshed runs. The gradients are the ones the train step
    hands to the clipping (``_record_first_grads``)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.lm import token_stream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, sharded
    from repro_torch.launch import train as driver
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import dist
    from repro_torch.models.steps import make_train_step

    t0 = time.perf_counter()
    out = {}
    cfg = get_config("llama3.2-1b")
    layers, tp, dp = cfg.num_layers, 16, 16
    pod = _pod_on_card()
    torch.cuda.empty_cache()
    # (a) serving
    arms = {}
    for label, mesh in (("pod", pod), ("none", None)):
        shapes, restore = _record_flash_shapes(ops)
        try:
            r = serve.serve(cfg, device=DEVICE, keep_logits=True, verbose=False, mesh=mesh, **MESH_SERVE)
        finally:
            restore()
        arms[label] = {"tokens": torch.as_tensor(r["tokens"]), "logits": torch.stack(r["logits"]),
                       "prefill_s": r["prefill_s"], "decode_s": r["decode_s"], "peak": r["peak_bytes"],
                       "launches": r["launches"], "shapes": shapes}
        del r
        torch.cuda.empty_cache()
    got, want = arms["pod"], arms["none"]
    err = (got["logits"][0] - want["logits"][0]).abs().max().item()
    check(err <= SERVE_ATOL, f"phase 3n (a): prefill logits {err:.3g} from the unmeshed run's")
    exempt = margin_rule(got["tokens"], want["logits"][:-1], cfg.vocab_size, SERVE_ATOL, "phase 3n (a)")
    pre = got["launches"]["prefill"]
    want_fwd = layers * dp * tp
    check(pre["flash_attention_fwd"] == want_fwd, f"phase 3n (a): {pre['flash_attention_fwd']} flash forward "
          f"launches a prefill, not {layers} layers x {dp} x {tp}")
    shard = (MESH_SERVE["batch"] // dp, cfg.num_heads // tp, MESH_SERVE["prompt"], cfg.resolved_head_dim, 1,
             MESH_SERVE["prompt"], cfg.resolved_head_dim)
    check(got["shapes"] == Counter({shard: want_fwd}), f"phase 3n (a): shard shapes {dict(got['shapes'])}")
    ratio = got["peak"] / want["peak"]
    check(ratio <= 1.25, f"phase 3n (a): the mesh arm's peak is {ratio:.3f} x the unmeshed arm's")
    tokens = MESH_SERVE["batch"] * MESH_SERVE["gen"]
    out["serve"] = {**MESH_SERVE, "max_abs_err": err, "exempt": exempt, "flash_prefill": pre["flash_attention_fwd"],
                    "shard_shape": list(shard), "peak_ratio": ratio,
                    **{f"{k}_{f}": v[f] for k, v in arms.items() for f in ("prefill_s", "decode_s")},
                    **{f"{k}_decode_tok_s": tokens / v["decode_s"] for k, v in arms.items()},
                    **{f"{k}_peak_GiB": v["peak"] / 2**30 for k, v in arms.items()}}
    s = out["serve"]
    print(f"phase 3n (a) llama3.2-1b served at {MESH_SERVE} on the pod mesh (16 x 16 over the card): prefill logits "
          f"{err:.3g} from the unmeshed run's, tokens equal where the margin exceeds {SERVE_ATOL} ({exempt} "
          f"exempt); {pre['flash_attention_fwd']} flash forward launches at {shard}; prefill {s['pod_prefill_s']:.3f} "
          f"s (unmeshed {s['none_prefill_s']:.3f} s), decode {s['pod_decode_tok_s']:.2f} tokens/s (unmeshed "
          f"{s['none_decode_tok_s']:.2f}); peak {s['pod_peak_GiB']:.2f} GiB ({ratio:.3f} x the unmeshed "
          f"{s['none_peak_GiB']:.2f} GiB)")
    del arms, got, want
    torch.cuda.empty_cache()
    # (b) training
    runs = {}
    for label, mesh in (("pod", pod), ("none", None)):
        shapes, restore = _record_flash_shapes(ops)
        grads, restore_grads = _record_first_grads()
        sync()
        ops.reset_launch_counts()
        try:
            r = driver.train(cfg, device=DEVICE, verbose=False, mesh=mesh, **MESH_TRAIN)
            sync()
        finally:
            restore()
            restore_grads()
        runs[label] = {"losses": r["losses"], "step_s": r["step_s"], "tokens_per_s": r["tokens_per_s"],
                       "peak_GiB": r["peak_bytes"] / 2**30, "launches": ops.launch_counts(), "shapes": shapes,
                       "grads": grads}
        del r
        torch.cuda.empty_cache()
    got, want = runs["pod"], runs["none"]
    g_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(got.pop("grads"), want.pop("grads")))
    check(g_err <= 1e-4, f"phase 3n (b): first-step gradients {g_err:.3g} of a leaf's max |g| apart")
    for a, b in zip(got["losses"], want["losses"]):
        check(math.isfinite(a) and abs(a - b) <= 1e-5 * abs(b), f"phase 3n (b): losses {got['losses']} against "
              f"{want['losses']}")
    steps = MESH_TRAIN["steps"]
    fwd = steps * dp * tp * (layers + recomputed_attention(cfg))
    c = got["launches"]
    check(c["flash_attention_fwd"] == fwd and c["flash_attention_dq"] == c["flash_attention_dkv"]
          == steps * dp * tp * layers, f"phase 3n (b): launches {c}, not {fwd} forward and "
          f"{steps * dp * tp * layers} of each backward kernel")
    train_shard = (MESH_TRAIN["batch"] // dp, cfg.num_heads // tp, MESH_TRAIN["seq"], cfg.resolved_head_dim, 1,
                   MESH_TRAIN["seq"], cfg.resolved_head_dim)
    check(got["shapes"] == Counter({train_shard: fwd}), f"phase 3n (b): shard shapes {dict(got['shapes'])}")
    tokens = MESH_TRAIN["batch"] * MESH_TRAIN["seq"]
    out["train"] = {**MESH_TRAIN, "grad_rel_err": g_err, "shard_shape": list(train_shard),
                    "launches": {k: v for k, v in c.items() if v},
                    **{f"{k}_{f}": v[f] for k, v in runs.items() for f in ("losses", "step_s", "peak_GiB")},
                    **{f"{k}_tokens_per_s": tokens / statistics.mean(v["step_s"]) for k, v in runs.items()}}
    t = out["train"]
    print(f"phase 3n (b) llama3.2-1b trained at {MESH_TRAIN} on the pod mesh: losses {t['pod_losses']} (unmeshed "
          f"{t['none_losses']}), first-step gradients within {g_err:.3g} of each leaf's max |g|; launches "
          f"{json.dumps(t['launches'])} at {train_shard}; {statistics.mean(t['pod_step_s']):.3f} s a step, "
          f"{t['pod_tokens_per_s']:,.0f} tokens/s (unmeshed {statistics.mean(t['none_step_s']):.3f} s, "
          f"{t['none_tokens_per_s']:,.0f} tokens/s); peak {t['pod_peak_GiB']:.2f} GiB (unmeshed "
          f"{t['none_peak_GiB']:.2f} GiB)")
    del runs
    torch.cuda.empty_cache()
    # (c) reduced archs: multipod resume, smoke against no mesh
    multi, smoke = _pod_on_card(multi_pod=True), make_smoke_mesh([pod.first_device])
    out["reduced"] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        for arch in MESH_REDUCED:
            rc = get_config(arch) if arch == "tiny_lm" else reduced_config(get_config(arch))
            kw = dict(batch=MESH_RESUME["batch"], seq=MESH_RESUME["seq"], device=DEVICE, verbose=False)
            ck = os.path.join(tmp, arch)
            first = driver.train(rc, steps=2, mesh=multi, ckpt_dir=ck, ckpt_every=1, **kw)
            resumed = driver.train(rc, steps=3, mesh=multi, ckpt_dir=ck, ckpt_every=1, **kw)
            check(resumed["start"] == 2, f"phase 3n (c) {arch}: resumed from step {resumed['start']}")
            # the uninterrupted run's third step: the state at 2 stepped on the stream's first batch
            with dist.use_mesh(multi):
                state, metrics = make_train_step(rc)(sharded.shard_state(rc, first["state"], multi),
                                                     next(token_stream(rc.vocab_size, seed=0, **{
                                                         k: MESH_RESUME[k] for k in ("batch", "seq")})))
            check(resumed["losses"] == [float(metrics["loss"])]
                  and _tree_bits_equal(resumed["state"], sharded.gather_state(state)),
                  f"phase 3n (c) {arch}: the resumed step is not the stopped state's step bit for bit")
            a = serve.serve(rc, device=DEVICE, keep_logits=True, verbose=False, **MESH_SMOKE_SERVE)
            b = serve.serve(rc, device=DEVICE, keep_logits=True, verbose=False, mesh=smoke, **MESH_SMOKE_SERVE)
            ta = driver.train(rc, steps=2, **kw)
            tb = driver.train(rc, steps=2, mesh=smoke, **kw)
            check((a["tokens"] == b["tokens"]).all() and _tree_bits_equal(a["logits"], b["logits"])
                  and ta["losses"] == tb["losses"] and _tree_bits_equal(ta["state"], tb["state"]),
                  f"phase 3n (c) {arch}: the smoke mesh is not the unmeshed run bit for bit")
            losses = first["losses"] + resumed["losses"]
            step_s = statistics.mean(first["step_s"] + resumed["step_s"])
            out["reduced"][arch] = {"losses": losses, "multipod_step_s": step_s}
            print(f"phase 3n (c) {arch}: multipod (2 x 16 x 16 over the card) losses {[round(x, 5) for x in losses]}, "
                  f"stopped at 2 and resumed: the resumed step bit for bit the uninterrupted run's; {step_s:.3f} s a "
                  f"step; smoke mesh serving and training bit for bit the unmeshed runs")
    out["wall"] = time.perf_counter() - t0
    print(f"phase 3n: {out['wall']:.1f} s")
    return out


# ----------------------------------------------------------------- phase 3o
def _prefill_idle_share(cfg, params, mesh, kw: dict) -> dict:
    """One more prefill at ``kw``'s shape under the profiler: device kernels,
    busy and wall time, and the device's idle share."""
    from repro_torch.launch import serve
    from repro_torch.models import dist

    prompts = torch.randint(0, cfg.vocab_size, (kw["batch"], kw["prompt"]),
                            generator=torch.Generator().manual_seed(1)).to(DEVICE)

    def run():
        t0 = time.perf_counter()
        with dist.use_mesh(mesh):
            serve.prefill(cfg, params, prompts, kw["gen"])
        sync()
        return time.perf_counter() - t0

    prof, wall = _device_trace(run)
    events = _device_events(prof)
    busy = sum(e.us for e in events) / 1e6
    return {"kernels": len(events), "busy_s": busy, "wall_s": wall, "idle_share": 1 - busy / wall}


def _reversed_ranks(name: str, leaves: tuple):
    """A planted fault for a control: ``models.layers.<name>`` takes the
    rank parts of its params' ``leaves`` in reversed rank order. Returns
    the undo."""
    from repro_torch.models import layers

    real = getattr(layers, name)

    def faulty(params, *a, **kw):
        return real(dict(params, **{k: params[k].rebuild(params[k][::-1]) for k in leaves}), *a, **kw)

    setattr(layers, name, faulty)
    return lambda: setattr(layers, name, real)


def zoo_mesh_phase() -> dict:
    """The MoE, MLA and recurrent archs on meshes that repeat the card.
    (a) deepseek-v2-lite-16b at full width (15.71 B parameters, fp32, depth
    uncut, weights from a generator seeded 0 on the card) served through
    ``repro_torch.launch.serve.serve`` at ZOO_MESH_SERVE (a row a data
    shard) without a mesh and on the pod mesh (256 shards), dropless and
    at the default capacity 1.25, the arms in turn; the mesh arm's blocks
    are views of the unmeshed arm's leaves (``shard_tree`` on a mesh that
    repeats their device), so the card holds the weights once. Each mesh arm
    routes as its unmeshed arm did (``Routing``, replayed call by call):
    prefill logits within SERVE_ATOL, tokens under the margin rule, and the
    tokens its free routing would move printed with their margins; 27
    layers x 16 batch shards x 16 ranks flash forward launches a prefill at
    MLA's shard (1, 1, 256, 192), value width 128, and the decode step's
    logits within SERVE_ATOL where its tokens agree; prefill s, decode
    tokens/s, peaks and the device's idle share of a mesh prefill. (b)
    xlstm-1.3b at full width and one period (XLSTM_MESH_PERIODS) served at
    XLSTM_MESH_SERVE (batch 2: one batch shard, on every rank) on the pod
    mesh against no mesh: every logit within XLSTM_MESH_ATOL, tokens under
    the margin rule at that tolerance, no kernel of ours launched; then two
    controls that the bound can fail, each a mesh prefill with a planted
    fault (``_reversed_ranks``) whose logits must land beyond
    XLSTM_MESH_ATOL: the sLSTM's ``wgx``, ``wgh`` and ``gbias`` parts in
    reversed rank order (each step's ``h`` joined out of rank order) and
    the mLSTM's ``wq`` parts reversed (its row-parallel partial products
    against the wrong input blocks). (c)
    granite-moe-3b-a800m at full width and ZOO_MESH_TRAIN's depth trained
    through ``repro_torch.launch.train.train`` without a mesh and on the
    pod mesh, the mesh arm routed as the unmeshed arm (each step's forward
    and remat recomputation): losses within 1e-5 relative, first-step
    gradients within 1e-4 of each leaf's max |g|, the flash launches the
    mesh and remat predict at the batch shard's (1, 24, 128, 64) over 8 KV
    heads. (d) Reduced deepseek, granite, jamba and xlstm (one period each)
    on the multipod mesh: driver steps stopped after 2 and resumed to 3, the resumed step
    bit for bit the stopped state's step on the stream's first batch; and
    on the smoke mesh, serving and training bit for bit the unmeshed runs."""
    import dataclasses

    from repro_torch.common.pytrees import tree_leaves
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.lm import token_stream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, sharded
    from repro_torch.launch import train as driver
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.shardings import param_shardings_flat
    from repro_torch.models import dist
    from repro_torch.models.model import forward
    from repro_torch.models.steps import make_train_step

    t0 = time.perf_counter()
    out = {}
    pod = _pod_on_card()
    tp = dp = 16
    torch.cuda.empty_cache()
    # (a) deepseek-v2-lite-16b served
    base = get_config("deepseek-v2-lite-16b")
    kw = ZOO_MESH_SERVE
    params, arms = None, {}
    t1 = time.perf_counter()
    for label in ("dropless", "capacity"):
        cfg = dataclasses.replace(base, moe_dropless=label == "dropless")
        routing = Routing()
        routing.record()
        try:
            r = serve.serve(cfg, device=DEVICE, params=params, keep_logits=True, verbose=False, **kw)
        finally:
            routing.restore()
        params = r["params"]
        arms[("none", label)] = {"tokens": torch.as_tensor(r["tokens"]), "logits": torch.stack(r["logits"]),
                                 "prefill_s": r["prefill_s"], "decode_s": r["decode_s"], "peak": r["peak_bytes"],
                                 "launches": r["launches"], "calls": [c[0] for c in routing.calls]}
        del r
    out["deepseek_weights_s"] = time.perf_counter() - t1 - sum(a["prefill_s"] + a["decode_s"] for a in arms.values())
    placed = sharded.shard_tree(params, param_shardings_flat(base, pod, params), pod)
    del params
    for label in ("dropless", "capacity"):
        cfg = dataclasses.replace(base, moe_dropless=label == "dropless")
        routing = Routing()
        routing.pin(arms[("none", label)]["calls"])
        shapes, restore = _record_flash_shapes(ops)
        try:
            r = serve.serve(cfg, device=DEVICE, params=placed, keep_logits=True, verbose=False, mesh=pod, **kw)
        finally:
            restore()
            routing.restore()
        arms[("pod", label)] = {"tokens": torch.as_tensor(r["tokens"]), "logits": torch.stack(r["logits"]),
                                "prefill_s": r["prefill_s"], "decode_s": r["decode_s"], "peak": r["peak_bytes"],
                                "launches": r["launches"], "shapes": shapes, "free": routing.moved()}
        del r
    profile = _prefill_idle_share(base, placed, pod, kw)
    del placed
    torch.cuda.empty_cache()
    want_fwd = base.num_layers * dp * tp
    shard = (kw["batch"] // dp, base.num_heads // tp, kw["prompt"], base.mla.qk_nope_head_dim
             + base.mla.qk_rope_head_dim, 1, kw["prompt"], base.mla.v_head_dim)
    out["deepseek"] = {}
    for label in ("dropless", "capacity"):
        got, want = arms[("pod", label)], arms[("none", label)]
        exempt = margin_rule(got["tokens"], want["logits"][:-1], base.vocab_size, SERVE_ATOL, f"phase 3o (a) {label}")
        # the decode step's logits too where the tokens it was fed agree
        same = (got["tokens"] == want["tokens"]).all(dim=1).to(got["logits"].device)
        err = max((got["logits"][0] - want["logits"][0]).abs().max().item(),
                  (got["logits"][1:, same] - want["logits"][1:, same]).abs().max().item() if bool(same.any()) else 0.0)
        check(err <= SERVE_ATOL, f"phase 3o (a) {label}: logits {err:.3g} from the unmeshed run's")
        pre = got["launches"]["prefill"]
        check(pre["flash_attention_fwd"] == want_fwd and sum(pre.values()) == want_fwd,
              f"phase 3o (a) {label}: prefill launches {pre}, not {base.num_layers} layers x {dp} x {tp} flash "
              f"forwards")
        check(got["shapes"] == Counter({shard: want_fwd}), f"phase 3o (a) {label}: shard shapes {dict(got['shapes'])}")
        check(sum(got["launches"]["decode"].values()) == 0, f"phase 3o (a) {label}: decode launched "
                                                            f"{got['launches']['decode']}")
        tokens = kw["batch"] * kw["gen"]
        row = {"max_abs_err": err, "exempt": exempt, "flash_prefill": pre["flash_attention_fwd"],
               "free_rerouted": got["free"][0], "free_margin_max": got["free"][1],
               **{f"{k}_prefill_s": arms[(k, label)]["prefill_s"] for k in ("pod", "none")},
               **{f"{k}_decode_tok_s": tokens / arms[(k, label)]["decode_s"] for k in ("pod", "none")},
               **{f"{k}_peak_GiB": arms[(k, label)]["peak"] / 2**30 for k in ("pod", "none")}}
        out["deepseek"][label] = row
        print(f"phase 3o (a) deepseek-v2-lite-16b {label} served at {kw} on the pod mesh (16 x 16 over the card), "
              f"routed as the unmeshed run: prefill and decode logits {err:.3g} from its, tokens equal where the margin exceeds "
              f"{SERVE_ATOL} ({exempt} exempt); free routing would move {got['free'][0]} token-layers (top-k "
              f"margins up to {got['free'][1]:.3g}); {pre['flash_attention_fwd']} flash forward launches at {shard}; "
              f"prefill {row['pod_prefill_s']:.3f} s (unmeshed {row['none_prefill_s']:.3f} s), decode "
              f"{row['pod_decode_tok_s']:.2f} tokens/s (unmeshed {row['none_decode_tok_s']:.2f}); peak "
              f"{row['pod_peak_GiB']:.2f} GiB (unmeshed {row['none_peak_GiB']:.2f} GiB)")
    out["deepseek"]["shard_shape"] = list(shard)
    out["deepseek"]["prefill_profile"] = profile
    print(f"phase 3o (a) mesh prefill under the profiler: {profile['kernels']} device kernels, busy "
          f"{profile['busy_s']:.3f} s of {profile['wall_s']:.3f} s, idle share {profile['idle_share']:.4f}; weights "
          f"drawn in {out['deepseek_weights_s']:.2f} s")
    del arms
    torch.cuda.empty_cache()
    # (b) xlstm-1.3b served
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), num_periods=XLSTM_MESH_PERIODS)
    kw = XLSTM_MESH_SERVE
    res = {}
    params = None
    for label, mesh in (("none", None), ("pod", pod)):
        r = serve.serve(cfg, device=DEVICE, params=params, keep_logits=True, verbose=False, mesh=mesh, **kw)
        if params is None:
            params, r_prompts = r["params"], r["prompts"]
        res[label] = {"tokens": torch.as_tensor(r["tokens"]), "logits": torch.stack(r["logits"]),
                      "prefill_s": r["prefill_s"], "decode_s": r["decode_s"], "peak": r["peak_bytes"],
                      "launches": r["launches"]}
        del r
    with torch.no_grad():  # the model's own conditioning: one ulp on the embeddings, teacher-forced
        batch = {"tokens": torch.cat([r_prompts, res["none"]["tokens"].to(DEVICE)], dim=1)}
        base_logits = forward(cfg, params, batch, last=kw["gen"] + 1)[0]
        nudged = dict(params, embed=torch.nextafter(params["embed"], torch.full_like(params["embed"], math.inf)))
        spread = (forward(cfg, nudged, batch, last=kw["gen"] + 1)[0] - base_logits).abs().max().item()
        del nudged, base_logits
    got, want = res["pod"], res["none"]
    err = (got["logits"] - want["logits"]).abs().max().item()
    check(err <= XLSTM_MESH_ATOL, f"phase 3o (b): xlstm-1.3b logits {err:.3g} from the unmeshed run's, over "
                                  f"{XLSTM_MESH_ATOL}")
    faults = {}
    for name, fn, leaves in (("slstm_h_out_of_rank_order", "_apply_slstm_ranks", ("wgx", "wgh", "gbias")),
                             ("mlstm_wq_rows_reversed", "apply_mlstm", ("wq",))):
        restore = _reversed_ranks(fn, leaves)
        try:
            r = serve.serve(cfg, device=DEVICE, params=params, keep_logits=True, verbose=False, mesh=pod,
                            **dict(kw, gen=1))
        finally:
            restore()
        faults[name] = (r["logits"][0] - want["logits"][0]).abs().max().item()
        del r
        check(faults[name] > XLSTM_MESH_ATOL, f"phase 3o (b): the planted fault {name} moved the prefill's logits "
                                              f"only {faults[name]:.3g}, within {XLSTM_MESH_ATOL}")
    del params
    torch.cuda.empty_cache()
    exempt = margin_rule(got["tokens"], want["logits"][:-1], cfg.vocab_size, XLSTM_MESH_ATOL, "phase 3o (b)")
    launched = {k: v for part in got["launches"].values() for k, v in part.items() if v}
    check(not launched, f"phase 3o (b): xlstm-1.3b launched {launched}")
    out["xlstm"] = {**kw, "max_abs_err": err, "bound": XLSTM_MESH_ATOL, "one_ulp_spread": spread, "exempt": exempt,
                    "planted_faults": faults,
                    **{f"{k}_prefill_s": v["prefill_s"] for k, v in res.items()},
                    **{f"{k}_decode_tok_s": kw["batch"] * kw["gen"] / v["decode_s"] for k, v in res.items()},
                    **{f"{k}_peak_GiB": v["peak"] / 2**30 for k, v in res.items()}}
    x = out["xlstm"]
    print(f"phase 3o (b) xlstm-1.3b ({cfg.num_layers} of 48 blocks, {cfg.param_count():,} parameters) served at "
          f"{kw} on the pod mesh: logits (prefill and {kw['gen']} steps) {err:.3g} "
          f"from the unmeshed run's (bound {XLSTM_MESH_ATOL}; one ulp on the embeddings moves the unmeshed "
          f"teacher-forced logits {spread:.3g}), tokens equal where the margin exceeds it ({exempt} exempt); planted "
          f"faults move the prefill's logits past the bound: "
          f"{', '.join(f'{k} {v:.3g}' for k, v in faults.items())}; no "
          f"kernel of ours; prefill {x['pod_prefill_s']:.3f} s (unmeshed {x['none_prefill_s']:.3f} s), "
          f"decode {x['pod_decode_tok_s']:.2f} tokens/s (unmeshed {x['none_decode_tok_s']:.2f}); peak "
          f"{x['pod_peak_GiB']:.2f} GiB (unmeshed {x['none_peak_GiB']:.2f} GiB)")
    del res
    # (c) granite-moe-3b-a800m trained
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), num_periods=ZOO_MESH_TRAIN["periods"])
    kw = {k: ZOO_MESH_TRAIN[k] for k in ("batch", "seq", "steps")}
    runs, chosen = {}, None
    for label, mesh in (("none", None), ("pod", pod)):
        routing = Routing()
        if chosen is None:
            routing.record()
        else:
            routing.pin(chosen)
        shapes, restore = _record_flash_shapes(ops)
        grads, restore_grads = _record_first_grads(host=True)
        sync()
        ops.reset_launch_counts()
        try:
            r = driver.train(cfg, device=DEVICE, verbose=False, mesh=mesh, **kw)
            sync()
        finally:
            restore()
            restore_grads()
            routing.restore()
        if chosen is None:
            chosen = [c[0] for c in routing.calls]
        runs[label] = {"losses": r["losses"], "step_s": r["step_s"], "peak_GiB": r["peak_bytes"] / 2**30,
                       "launches": ops.launch_counts(), "shapes": shapes, "grads": grads,
                       "free": routing.moved() if label == "pod" else None}
        del r
        torch.cuda.empty_cache()
    got, want = runs["pod"], runs["none"]
    g_err = max(((a.to(DEVICE) - b.to(DEVICE)).abs().max() / b.to(DEVICE).abs().max().clamp_min(1e-30)).item()
                for a, b in zip(got.pop("grads"), want.pop("grads")))  # leaf by leaf on the card
    check(g_err <= 1e-4, f"phase 3o (c): first-step gradients {g_err:.3g} of a leaf's max |g| apart")
    for a, b in zip(got["losses"], want["losses"]):
        check(math.isfinite(a) and abs(a - b) <= 1e-5 * abs(b), f"phase 3o (c): losses {got['losses']} against "
              f"{want['losses']}")
    steps, layers = kw["steps"], cfg.num_layers
    fwd = steps * dp * (layers + recomputed_attention(cfg))
    c = got["launches"]
    check(c["flash_attention_fwd"] == fwd and c["flash_attention_dq"] == c["flash_attention_dkv"]
          == steps * dp * layers, f"phase 3o (c): launches {c}, not {fwd} forward and {steps * dp * layers} of each "
          f"backward kernel (heads replicated: one launch a batch shard and layer)")
    train_shard = (kw["batch"] // dp, cfg.num_heads, kw["seq"], cfg.resolved_head_dim, cfg.num_kv_heads, kw["seq"],
                   cfg.resolved_head_dim)
    check(got["shapes"] == Counter({train_shard: fwd}), f"phase 3o (c): shard shapes {dict(got['shapes'])}")
    tokens = kw["batch"] * kw["seq"]
    out["granite"] = {**kw, "periods": cfg.num_periods, "params": cfg.param_count(),
                      "grad_rel_err": g_err, "shard_shape": list(train_shard),
                      "launches": {k: v for k, v in c.items() if v}, "free_rerouted": got["free"][0],
                      "free_margin_max": got["free"][1],
                      **{f"{k}_{f}": v[f] for k, v in runs.items() for f in ("losses", "step_s", "peak_GiB")},
                      **{f"{k}_tokens_per_s": tokens / statistics.mean(v["step_s"]) for k, v in runs.items()}}
    t = out["granite"]
    print(f"phase 3o (c) granite-moe-3b-a800m ({cfg.num_layers} of 32 layers, {t['params']:,} parameters) trained "
          f"at {kw} on the pod mesh, routed as the unmeshed run: losses {t['pod_losses']} (unmeshed "
          f"{t['none_losses']}), first-step gradients within {g_err:.3g} of each leaf's max |g|; free routing would "
          f"move {t['free_rerouted']} token-layers (margins up to {t['free_margin_max']:.3g}); launches "
          f"{json.dumps(t['launches'])} at {train_shard}; {statistics.mean(t['pod_step_s']):.3f} s a step, "
          f"{t['pod_tokens_per_s']:,.0f} tokens/s (unmeshed {statistics.mean(t['none_step_s']):.3f} s, "
          f"{t['none_tokens_per_s']:,.0f} tokens/s); peak {t['pod_peak_GiB']:.2f} GiB (unmeshed "
          f"{t['none_peak_GiB']:.2f} GiB)")
    del runs
    torch.cuda.empty_cache()
    # (d) reduced archs: multipod resume, smoke against no mesh
    multi, smoke = _pod_on_card(multi_pod=True), make_smoke_mesh([pod.first_device])
    out["reduced"] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_mesh_") as tmp:
        for arch in ZOO_MESH_REDUCED:
            rc = dataclasses.replace(reduced_config(get_config(arch)), num_periods=ZOO_MESH_RESUME["periods"])
            rows = ZOO_MESH_RESUME["batch"] if rc.moe is not None and rc.mamba is None else 2
            kw = dict(batch=rows, seq=ZOO_MESH_RESUME["seq"], device=DEVICE, verbose=False)
            ck = os.path.join(tmp, arch)
            first = driver.train(rc, steps=2, mesh=multi, ckpt_dir=ck, ckpt_every=1, **kw)
            resumed = driver.train(rc, steps=3, mesh=multi, ckpt_dir=ck, ckpt_every=1, **kw)
            check(resumed["start"] == 2, f"phase 3o (d) {arch}: resumed from step {resumed['start']}")
            with dist.use_mesh(multi):
                state, metrics = make_train_step(rc)(sharded.shard_state(rc, first["state"], multi),
                                                     next(token_stream(rc.vocab_size, seed=0, batch=rows,
                                                                       seq=ZOO_MESH_RESUME["seq"])))
            check(resumed["losses"] == [float(metrics["loss"])]
                  and _tree_bits_equal(resumed["state"], sharded.gather_state(state)),
                  f"phase 3o (d) {arch}: the resumed step is not the stopped state's step bit for bit")
            a = serve.serve(rc, device=DEVICE, keep_logits=True, verbose=False, **MESH_SMOKE_SERVE)
            b = serve.serve(rc, device=DEVICE, keep_logits=True, verbose=False, mesh=smoke, **MESH_SMOKE_SERVE)
            ta = driver.train(rc, steps=2, **kw)
            tb = driver.train(rc, steps=2, mesh=smoke, **kw)
            check((a["tokens"] == b["tokens"]).all() and _tree_bits_equal(a["logits"], b["logits"])
                  and ta["losses"] == tb["losses"] and _tree_bits_equal(ta["state"], tb["state"]),
                  f"phase 3o (d) {arch}: the smoke mesh is not the unmeshed run bit for bit")
            losses = first["losses"] + resumed["losses"]
            step_s = statistics.mean(first["step_s"] + resumed["step_s"])
            out["reduced"][arch] = {"batch": rows, "losses": losses, "multipod_step_s": step_s}
            print(f"phase 3o (d) {arch} (batch {rows}): multipod (2 x 16 x 16 over the card) losses "
                  f"{[round(x, 5) for x in losses]}, stopped at 2 and resumed: the resumed step bit for bit the "
                  f"uninterrupted run's; {step_s:.3f} s a step; smoke mesh serving and training bit for bit the "
                  f"unmeshed runs")
            del first, resumed, state, a, b, ta, tb
    out["wall"] = time.perf_counter() - t0
    print(f"phase 3o: {out['wall']:.1f} s")
    return out


# ----------------------------------------------------------------- phase 3i
def _synced(spent: Counter, step: str, fn, *a, **kw):
    """``fn(*a, **kw)`` on the host clock, the card synced before and after,
    its seconds added to ``spent[step]``."""
    sync()
    t = time.perf_counter()
    out = fn(*a, **kw)
    sync()
    spent[step] += time.perf_counter() - t
    return out


def _restart_timers():
    """Time the restart's four steps on the host clock, the card synced
    before and after each (seconds summed per step, over every restart in
    the window), and record each saved checkpoint's bytes on disk and
    leaf count."""
    from repro_torch import checkpoint as ck_pkg
    from repro_torch.checkpoint import checkpointer as ck_mod
    from repro_torch.core.server import EchoPFLServer

    spent: Counter = Counter()
    saved: list[dict] = []
    originals = []

    def wrap(owner, attr, step, after=None):
        fn = getattr(owner, attr)

        def timed(*a, **kw):
            out = _synced(spent, step, fn, *a, **kw)
            if after is not None:
                after(*a)
            return out
        originals.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def size(directory, tree, extra=None):
        files = [os.path.join(directory, n) for n in os.listdir(directory)]
        saved.append({"bytes": sum(os.path.getsize(f) for f in files),
                      "leaves": len(ck_mod._paths_and_leaves(tree)[0])})

    wrap(EchoPFLServer, "state_dict", "state_dict")
    wrap(ck_mod, "save_pytree", "save", after=size)
    wrap(ck_pkg, "restore_pytree", "restore")
    wrap(EchoPFLServer, "load_state", "load_state")

    def restore():
        for owner, attr, fn in reversed(originals):
            setattr(owner, attr, fn)

    return spent, saved, restore


def _state_bits(strat) -> str:
    """A digest of every leaf of the strategy's state tree and of its meta."""
    from repro_torch.checkpoint.checkpointer import _paths_and_leaves

    tree, meta = strat.state_dict()
    h = hashlib.sha256(json.dumps(meta).encode())
    for path, leaf in zip(*_paths_and_leaves(tree)):
        h.update(path.encode())
        h.update(leaf.tobytes())
    return h.hexdigest()


def _run_fields(rep, sim, counts) -> dict:
    """What a killed run must share with the uninterrupted one: the ledgers,
    the curve and accuracies, the server's decisions and state, the kernel
    launches (the codec's included)."""
    strat = sim.strategy
    out = {f: getattr(rep, f) for f in ("curve", "per_client_acc", "up_bytes", "down_bytes", "up_events",
                                         "down_events", "up_raw_bytes", "up_retry_bytes", "duration", "up_series",
                                         "down_series")}
    out["faults"] = {k: v for k, v in rep.extra["faults"].items() if k != "server_restarts"}
    for key in ("staleness", "uploads", "broadcasts", "decisions", "rnn_broadcasts", "clusters", "merges",
                "expansions", "uplink"):
        out[key] = rep.extra.get(key)
    out["events"] = strat.events
    out["assignment"] = strat.clustering.assignment
    out["launches"] = counts
    out["state"] = _state_bits(strat)
    return out


def _restart_trio(label: str, build, at_uploads: int | None = None) -> dict:
    """Two uninterrupted runs and one killed at ``at_uploads`` (default: half
    the first run's uploads), each with the launch counts zeroed just before
    and read just after. Fields the two uninterrupted runs do not share are
    printed and left out; the killed run must equal the uninterrupted one in
    every other field. ``build(restart_dir, at_uploads)`` returns a ready
    simulator and its horizon."""
    from repro_torch.kernels import ops

    runs = []
    workdir = tempfile.mkdtemp(prefix="repro_torch_restart_")
    try:
        for killed in (False, False, True):
            if killed and at_uploads is None:
                at_uploads = runs[0][0]["uploads"] // 2
            sim, horizon = build(os.path.join(workdir, "ck") if killed else None, at_uploads)
            if killed:
                spent, saved, restore = _restart_timers()
            sync()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                rep = sim.run_async(max_time=horizon)
                sync()
            finally:
                if killed:
                    restore()
            wall = time.perf_counter() - t0
            runs.append((_run_fields(rep, sim, ops.launch_counts()), rep, sim, wall))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    (a, _, sa, wa), (a2, _, _, wa2), (b, rb, sb, wb) = runs
    unsteady = sorted(k for k in a if a[k] != a2[k])
    differ = sorted(k for k in a if k not in unsteady and a[k] != b[k])
    check(rb.extra["faults"]["server_restarts"] == 1, f"{label}: the server was not restarted")
    check(sb.strategy is not sa.strategy and b["uploads"] > at_uploads,
          f"{label}: the restored server did not finish the run")
    if sb._codec is not None:
        check(sb.strategy.uplink_codec is sb._codec, f"{label}: the codec was not re-attached")
    check(getattr(sb.strategy.feedback_batch_fn, "_fleet", None) is sb._fleet,
          f"{label}: the fleet's feedback probe was not reinstalled")
    print(f"{label}: two uninterrupted card runs " + ("identical in every field" if not unsteady else
          f"DIFFER in {unsteady}; the restart is held to the other fields only"))
    check(not differ, f"{label}: the killed run differs from the uninterrupted one in {differ}")
    check(len(saved) == 1, f"{label}: {len(saved)} checkpoints saved, not 1")
    held = [k for k in a if k not in unsteady]
    print(f"{label}: killed at {at_uploads} of {b['uploads']} uploads, equal to the uninterrupted run in "
          f"{len(held)} fields ({', '.join(held)}); launches {json.dumps(b['launches'])}; checkpoint "
          f"{saved[0]['bytes']} B on disk, {saved[0]['leaves']} leaves; state_dict {spent['state_dict'] * 1e3:.3f} ms, "
          f"save {spent['save'] * 1e3:.3f} ms, restore {spent['restore'] * 1e3:.3f} ms (raw, then into the template), "
          f"load_state {spent['load_state'] * 1e3:.3f} ms; wall {wa:.2f} / {wa2:.2f} / {wb:.2f} s (uninterrupted, "
          f"again, killed); card {sh('nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader')}")
    return dict(fields=b, unsteady=unsteady, saved=saved[0], spent=dict(spent), at=at_uploads)


RESTART_CHAOS = dict(seed=5, crash_rate=0.05, loss_rate=0.2, dup_rate=0.1, reorder_rate=0.1)
NO_FAULTS = dict(crash_rate=0.0, loss_rate=0.0, dup_rate=0.0, reorder_rate=0.0)


def _har_restart_sim(device: str, window: float, rnn_params: dict, init_params=None):
    """``tests/test_faults.py``'s kill-restore run: ``har``, 8 clients with
    48 samples, seed 0, ``uplink="topk"``, faults (seed 5), 900 s; the
    simulator builder ``_restart_trio`` takes."""
    from repro_torch.fl.experiment import build_clients, build_strategy
    from repro_torch.fl.faults import FaultConfig, FaultPlan, ServerRestartPlan
    from repro_torch.fl.simulator import Simulator

    def build(restart_dir, at_uploads):
        _, clients, init = build_clients("har", 8, seed=0, samples_per_client=48, device=device,
                                         init_params=init_params)

        def factory():
            return build_strategy("echopfl", init, clients, seed=0, rnn_params=rnn_params, device=device)

        plan = None if restart_dir is None else ServerRestartPlan(at_uploads, restart_dir, factory)
        return Simulator(clients, factory(), seed=0, coalesce_window=window, uplink="topk",
                         faults=FaultPlan(config=FaultConfig(**RESTART_CHAOS), restart=plan)), 900.0

    return build


def _interchange(rnn_params: dict) -> dict:
    """A card server's checkpoint into a CPU server of the port and a CPU
    server's into a card server (``image_recognition``, 25,418 floats a row,
    20 clients, 600 s with ``uplink="topk"``, so the codec's rows ride
    along): in each direction ``state_dict`` after the restore equals the
    writer's leaf for leaf, bit for bit, the meta equal. The CPU server
    ingests five uploads of its own before it writes."""
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.checkpoint.checkpointer import _paths_and_leaves
    from repro_torch.fl.experiment import build_clients, build_strategy, run_experiment
    from repro_torch.fl.uplink import UplinkCodec

    import numpy as np

    _, _, card, rep = run_experiment("image_recognition", "echopfl", num_clients=20, max_time=600, seed=0,
                                     device=DEVICE, rnn_params=rnn_params, uplink="topk")
    init_np = [{k: v.cpu().numpy() for k, v in layer.items()} for layer in card.init_params]

    def server(device):
        _, clients, init = build_clients("image_recognition", 20, seed=0, device=device, init_params=init_np)
        srv = build_strategy("echopfl", init, clients, seed=0, rnn_params=rnn_params, device=device)
        srv.attach_uplink_codec(UplinkCodec(init, [c.client_id for c in clients], card.uplink_codec.config,
                                            device=device))
        return srv

    def same(w, r) -> bool:
        (tw, mw), (tr, mr) = w.state_dict(), r.state_dict()
        (pw, lw), (pr, lr) = _paths_and_leaves(tw), _paths_and_leaves(tr)
        return mw == mr and pw == pr and all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                                             for a, b in zip(lw, lr))

    spent: Counter = Counter()

    def timed(step, fn, *a, **kw):
        return _synced(spent, step, fn, *a, **kw)

    workdir = tempfile.mkdtemp(prefix="repro_torch_interchange_")
    try:
        cpu = server("cpu")
        d = os.path.join(workdir, "card")
        tree, meta = timed("card state_dict", card.state_dict)
        timed("save", save_pytree, d, tree, extra=meta)
        nbytes = sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))
        leaves = len(_paths_and_leaves(tree)[0])
        raw = timed("restore", restore_pytree, d)[1]
        got = timed("restore", restore_pytree, d, like=cpu.state_template(raw))
        timed("CPU load_state", cpu.load_state, *got)
        check(same(card, cpu), "interchange: the CPU server's state differs from the card checkpoint's")
        rng = np.random.default_rng(0)
        for i in range(5):
            up = [{k: v + torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32) * 0.05)
                   for k, v in layer.items()} for layer in cpu.init_params]
            cpu.handle_upload(i, up, 0, 48, 601.0 + i)
        d2 = os.path.join(workdir, "cpu")
        tree, meta = cpu.state_dict()
        save_pytree(d2, tree, extra=meta)
        card2 = server(DEVICE)
        raw = restore_pytree(d2)[1]
        got = restore_pytree(d2, like=card2.state_template(raw))
        timed("card load_state", card2.load_state, *got)
        check(same(cpu, card2), "interchange: the card server's state differs from the CPU checkpoint's")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"interchange (image_recognition, 25,418 floats a row, {rep.extra['uploads']} uploads on the card, top-k "
          f"codec): card -> CPU and CPU -> card restores equal the writer's state bit for bit, meta equal; "
          f"checkpoint {nbytes} B on disk, {leaves} leaves; card state_dict {spent['card state_dict'] * 1e3:.3f} ms, "
          f"save {spent['save'] * 1e3:.3f} ms, restore {spent['restore'] * 1e3:.3f} ms (raw, then into the "
          f"template), CPU load_state {spent['CPU load_state'] * 1e3:.3f} ms, card load_state (the CPU "
          f"checkpoint) {spent['card load_state'] * 1e3:.3f} ms; card "
          f"{sh('nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader')}")
    return dict(bytes=nbytes, leaves=leaves, spent=dict(spent))


def restart_phase(rnn_params: dict, lm_rnn_params: dict) -> dict:
    """Phase 3i: the fault plan's server kill and restore on the card.
    ``har``, the reference's own bar, per event and at a 30 s window; the
    full-width ``llama3.2-1b`` run of phase 3c killed near the middle of its
    uploads; and checkpoints between card and CPU servers."""
    from repro_torch.fl.experiment import build_strategy
    from repro_torch.fl.faults import FaultConfig, FaultPlan, ServerRestartPlan
    from repro_torch.fl.lm_task import build_lm_clients
    from repro_torch.fl.network import NetworkModel
    from repro_torch.fl.simulator import Simulator

    out = {}
    for window in (0.0, 30.0):
        label = f"restart har (8 clients, 900 s, top-k, faults, window {window} s)"
        res = _restart_trio(label, _har_restart_sim(DEVICE, window, rnn_params), at_uploads=30)
        counts = res["fields"]["launches"]
        for name in ("l1_distance", "assign_and_lerp", "uplink_topk_encode") + (("ingest_chain",) if window else ()):
            check(counts[name] > 0, f"{label}: kernel {name} never launched")
        check(counts["uplink_topk_encode"] == res["fields"]["uplink"]["launches"],
              f"{label}: encode launches {counts['uplink_topk_encode']} != the codec's")
        out[f"har w{int(window)}"] = res
    task = full_width_task()

    def build(restart_dir, at_uploads):
        clients, _, init = build_lm_clients(4, seed=0, local_epochs=1, n_train=4, n_test=2, seq_len=256, task=task,
                                            device=DEVICE)

        def factory():
            return build_strategy("echopfl", init, clients, seed=0, rnn_params=lm_rnn_params, device=DEVICE)

        plan = None if restart_dir is None else ServerRestartPlan(at_uploads, restart_dir, factory)
        return Simulator(clients, factory(), network=NetworkModel(), eval_interval=240, seed=0,
                         faults=FaultPlan(config=FaultConfig(**NO_FAULTS), restart=plan)), 720.0

    label = "restart full width (llama3.2-1b, 4 clients, seq 256, 720 s, no fault)"
    res = _restart_trio(label, build)
    for name in LM_PATH:
        check(res["fields"]["launches"][name] > 0, f"{label}: kernel {name} never launched")
    out["llama3.2-1b"] = res
    del task
    torch.cuda.empty_cache()
    out["interchange"] = _interchange(rnn_params)
    return out


# ------------------------------------------------------------------ phase 4
def agreement_inputs() -> tuple[list, dict]:
    """Phase 4's ``har`` weights, as numpy: the MLP from a CPU generator
    seeded 0 and the broadcast RNN pretrained on the CPU."""
    from repro_torch.configs.paper_tasks import PAPER_TASKS
    from repro_torch.core.broadcast import pretrain_rnn
    from repro_torch.models.mlp import init_mlp

    init = init_mlp(PAPER_TASKS["har"], torch.Generator().manual_seed(0))
    rnn = pretrain_rnn(0, device="cpu")
    return [{k: v.numpy() for k, v in layer.items()} for layer in init], {k: v.numpy() for k, v in rnn.items()}


def agreement(init_np: list, rnn_np: dict) -> None:
    """``har`` (8 clients, 900 s) on the card against the CPU, per event and
    coalesced at a 45 s window: identical ledgers, server events and
    assignments, accuracy curves within 0.02; and at a 1e-9 s window on the
    card against the per-event run on the card: identical events,
    assignments and centers (bit for bit)."""
    from repro_torch.fl.experiment import run_experiment

    out = {}
    for dev, window in (("cpu", 0.0), (DEVICE, 0.0), ("cpu", 45.0), (DEVICE, 45.0), (DEVICE, 1e-9)):
        t0 = time.perf_counter()
        _, _, strat, rep = run_experiment("har", "echopfl", num_clients=8, max_time=900, seed=0, device=dev,
                                          init_params=init_np, rnn_params=rnn_np, coalesce_window=window)
        out[dev, window] = (strat, rep, time.perf_counter() - t0)
    for window in (0.0, 45.0):
        (sc, rc, tc), (sg, rg, tg) = out["cpu", window], out[DEVICE, window]
        label = f"agreement (window {window} s)"
        for name in ("up_events", "down_events", "up_bytes", "down_bytes"):
            check(getattr(rc, name) == getattr(rg, name), f"{label}: {name} {getattr(rc, name)} != {getattr(rg, name)}")
        check(sc.events == sg.events, f"{label}: server event sequences differ")
        check(sc.clustering.assignment == sg.clustering.assignment, f"{label}: assignments differ")
        gap = max(abs(a - b) for (_, a), (_, b) in zip(rc.curve, rg.curve))
        check(gap <= 0.02, f"{label}: accuracy curves differ by {gap}")
        print(f"{label} (har, 8 clients, 900 s, card vs CPU plain versions): ledger and {len(sg.events)} events "
              f"identical, {rg.extra['uploads']} uploads, accuracy gap {gap:.4f}; wall CPU {tc:.2f} s, card {tg:.2f} s")
    (se, re_, _), (sz, rz, _) = out[DEVICE, 0.0], out[DEVICE, 1e-9]
    check(se.events == sz.events and se.clustering.assignment == sz.clustering.assignment,
          "agreement: the 1e-9 s window and the per-event run differ on the card")
    check(re_.curve == rz.curve and (re_.up_bytes, re_.down_bytes) == (rz.up_bytes, rz.down_bytes),
          "agreement: the 1e-9 s window's report differs from the per-event run's on the card")
    check(sorted(se.clustering.clusters) == sorted(sz.clustering.clusters)
          and all(_same_bits(c.center_vec, sz.clustering.clusters[cid].center_vec)
                  for cid, c in se.clustering.clusters.items()),
          "agreement: the 1e-9 s window's centers differ from the per-event run's on the card")
    print("agreement (har, card): the 1e-9 s window equals the per-event run (events, assignments, curve, bytes, "
          "centers bit for bit)")


def compressed_agreement(init_np: list, rnn_np: dict) -> None:
    """Compressed ``har`` runs (8 clients) on the card against the CPU, where
    the encodes take their plain versions: EchoPFL with ``topk`` and with
    ``int8``, per event and at a 45 s window (900 s), and FedAvg with
    ``int8`` (5 rounds). Identical ledgers (dense-equivalent bytes too),
    ``extra["uplink"]``, stats, server events and assignments; accuracy
    curves within 0.02; on the card the encode kernel launched
    ``codec.launches`` times."""
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.kernels import ops

    cases = [("echopfl", dict(max_time=900, uplink=m, coalesce_window=w))
             for m in ("topk", "int8") for w in (0.0, 45.0)]
    for name, kw in cases + [("fedavg", dict(rounds=5, uplink="int8"))]:
        out = {}
        for dev in ("cpu", DEVICE):
            extra = dict(rnn_params=rnn_np) if name == "echopfl" else {}
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            _, _, strat, rep = run_experiment("har", name, num_clients=8, seed=0, device=dev, init_params=init_np,
                                              **kw, **extra)
            out[dev] = (strat, rep, time.perf_counter() - t0, ops.launch_counts())
        (sc, rc, tc, _), (sg, rg, tg, counts) = out["cpu"], out[DEVICE]
        label = f"compressed agreement {name} {kw}"
        for field in ("up_events", "down_events", "up_bytes", "down_bytes", "up_raw_bytes", "duration", "up_series",
                      "down_series"):
            check(getattr(rc, field) == getattr(rg, field), f"{label}: {field} differs card vs CPU")
        check(rc.extra["uplink"] == rg.extra["uplink"], f"{label}: {rc.extra['uplink']} != {rg.extra['uplink']}")
        check(counts[f"uplink_{kw['uplink']}_encode"] == rg.extra["uplink"]["launches"] > 0,
              f"{label}: encode kernel launches {counts}, codec {rg.extra['uplink']}")
        if name == "echopfl":
            check(sc.events == sg.events and sc.clustering.assignment == sg.clustering.assignment,
                  f"{label}: server events or assignments differ")
            same_stats = {k: v for k, v in sc.stats().items() if k != "cluster_feedback_mean"} == {
                k: v for k, v in sg.stats().items() if k != "cluster_feedback_mean"}
        else:
            same_stats = sc.stats() == sg.stats()
        check(same_stats, f"{label}: stats differ card vs CPU")
        check([t for t, _ in rc.curve] == [t for t, _ in rg.curve], f"{label}: evaluation times differ")
        gap = max(abs(a - b) for (_, a), (_, b) in zip(rc.curve, rg.curve))
        check(gap <= 0.02, f"{label}: accuracy curves differ by {gap}")
        print(f"{label} (har, 8 clients, card vs CPU plain versions): ledger, {rg.extra['uplink']}, stats"
              + (f" and {len(sg.events)} events" if name == "echopfl" else "") + f" identical, "
              f"{rg.up_events} uploads, accuracy gap {gap:.4f}, final {rg.final_acc:.4f}; wall CPU {tc:.2f} s, "
              f"card {tg:.2f} s")


def chaos_agreement(init_np: list, rnn_np: dict) -> None:
    """``har`` (8 clients, 900 s) per event and at a 45 s window, on the card
    against the CPU's plain versions, with ``bench_faults.py``'s faults at
    rate 0.3 plus ``bench_defense.py``'s poison at 0.2 and the guard on:
    identical fault, guard and byte ledgers, server events and assignments,
    accuracy curves within 0.02 (NaN at the same places). Then a guard on a
    clean run on the card is the guard-off run on the card bit for bit
    (curves, ledgers, events, assignments, centers)."""
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.kernels import ops

    fields = ("up_events", "down_events", "up_bytes", "down_bytes", "up_retry_bytes", "duration", "up_series",
              "down_series")
    for window in (0.0, 45.0):
        out = {}
        for dev in ("cpu", DEVICE):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            _, _, strat, rep = run_experiment("har", "echopfl", num_clients=8, max_time=900, seed=0, device=dev,
                                              init_params=init_np, rnn_params=rnn_np, coalesce_window=window,
                                              faults=_fault_plan(0.3, poison=0.2), guard="on")
            out[dev] = (strat, rep, time.perf_counter() - t0, ops.launch_counts())
        (sc, rc, tc, _), (sg, rg, tg, counts) = out["cpu"], out[DEVICE]
        label = f"chaos agreement (window {window} s)"
        for field in fields:
            check(getattr(rc, field) == getattr(rg, field), f"{label}: {field} differs card vs CPU")
        for key in ("faults", "guard", "uploads", "staleness", "broadcasts", "decisions"):
            check(rc.extra.get(key) == rg.extra.get(key), f"{label}: {key} {rc.extra.get(key)} != {rg.extra.get(key)}")
        check(sc.events == sg.events and sc.clustering.assignment == sg.clustering.assignment,
              f"{label}: server events or assignments differ")
        ac, ag = [a for _, a in rc.curve], [a for _, a in rg.curve]
        check([a != a for a in ac] == [a != a for a in ag], f"{label}: NaN accuracies at different places")
        gap = max((abs(a - b) for a, b in zip(ac, ag) if a == a), default=0.0)
        check(gap <= 0.02, f"{label}: accuracy curves differ by {gap}")
        if window:
            check(counts["ingest_chain"] > 0, f"{label}: the chain never launched on the card")
        print(f"{label} (har, 8 clients, 900 s, faults 0.3 + poison 0.2, guard on; card vs CPU plain versions): "
              f"fault ledger {json.dumps(rg.extra['faults'])}, guard ledger {json.dumps(rg.extra['guard'])}, bytes "
              f"and {len(sg.events)} events identical, accuracy gap {gap:.4f}, final {rg.final_acc:.4f}; chain "
              f"launches {counts['ingest_chain']}; wall CPU {tc:.2f} s, card {tg:.2f} s")
    for window in (0.0, 45.0):
        runs = {}
        for guard in (None, "on"):
            _, _, strat, rep = run_experiment("har", "echopfl", num_clients=8, max_time=900, seed=0, device=DEVICE,
                                              init_params=init_np, rnn_params=rnn_np, coalesce_window=window,
                                              guard=guard)
            runs[guard] = (strat, rep)
        (so, ro), (sn, rn) = runs[None], runs["on"]
        label = f"guard on a clean run (card, window {window} s)"
        check(ro.curve == rn.curve and ro.per_client_acc == rn.per_client_acc
              and all(getattr(ro, f) == getattr(rn, f) for f in fields), f"{label}: the report differs from guard-off")
        check(so.events == sn.events and so.clustering.assignment == sn.clustering.assignment
              and sorted(so.clustering.clusters) == sorted(sn.clustering.clusters)
              and all(_same_bits(c.center_vec, sn.clustering.clusters[cid].center_vec)
                      for cid, c in so.clustering.clusters.items()), f"{label}: events, assignments or centers differ")
        g = rn.extra["guard"]
        check(g["accepted"] == rn.extra["uploads"] and g["rollbacks"] == 0, f"{label}: the guard rejected {g}")
        print(f"{label}: bit for bit the guard-off run ({rn.extra['uploads']} uploads, all accepted)")


def restart_agreement(init_np: list, rnn_np: dict) -> None:
    """Phase 3i's coalesced ``har`` kill-restore run (30 s windows, top-k,
    faults, the server killed at 30 uploads) on the card against the CPU:
    identical ledgers (the fault ledger with its restart), server events and
    assignments, accuracy curves within 0.02."""
    out = {}
    for dev in ("cpu", DEVICE):
        workdir = tempfile.mkdtemp(prefix="repro_torch_restart_")
        try:
            sim, horizon = _har_restart_sim(dev, 30.0, rnn_np, init_np)(workdir, 30)
            t0 = time.perf_counter()
            rep = sim.run_async(max_time=horizon)
            out[dev] = (sim, rep, time.perf_counter() - t0)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    (sc, rc, tc), (sg, rg, tg) = out["cpu"], out[DEVICE]
    label = "restart agreement (window 30.0 s)"
    for field in ("up_events", "down_events", "up_bytes", "down_bytes", "up_raw_bytes", "up_retry_bytes", "duration",
                  "up_series", "down_series"):
        check(getattr(rc, field) == getattr(rg, field), f"{label}: {field} differs card vs CPU")
    for key in ("faults", "uploads", "staleness", "broadcasts", "decisions", "uplink"):
        check(rc.extra.get(key) == rg.extra.get(key), f"{label}: {key} {rc.extra.get(key)} != {rg.extra.get(key)}")
    check(rg.extra["faults"]["server_restarts"] == 1, f"{label}: no restart on the card")
    check(sc.strategy.events == sg.strategy.events
          and sc.strategy.clustering.assignment == sg.strategy.clustering.assignment,
          f"{label}: server events or assignments differ")
    check([t for t, _ in rc.curve] == [t for t, _ in rg.curve], f"{label}: evaluation times differ")
    gap = max(abs(a - b) for (_, a), (_, b) in zip(rc.curve, rg.curve))
    check(gap <= 0.02, f"{label}: accuracy curves differ by {gap}")
    print(f"{label} (har, 8 clients, 900 s, top-k, faults, killed at 30 uploads; card vs CPU plain versions): "
          f"ledgers and {len(sg.strategy.events)} events identical, {rg.extra['uploads']} uploads, accuracy gap "
          f"{gap:.4f}, final {rg.final_acc:.4f}; wall CPU {tc:.2f} s, card {tg:.2f} s")


def baseline_agreement():
    """``har`` (8 clients) FedAvg at 5 rounds and FedAsyn at 900 s, per
    event and at a 45 s window, on the card against the CPU: identical
    ledgers and stats, accuracy curves within 0.02."""
    from repro_torch.configs.paper_tasks import PAPER_TASKS
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.models.mlp import init_mlp

    init = init_mlp(PAPER_TASKS["har"], torch.Generator().manual_seed(0))
    init_np = [{k: v.numpy() for k, v in layer.items()} for layer in init]
    for name, kw in (("fedavg", dict(rounds=5)), ("fedasyn", dict(max_time=900)),
                     ("fedasyn", dict(max_time=900, coalesce_window=45.0))):
        out = {}
        for dev in ("cpu", DEVICE):
            t0 = time.perf_counter()
            _, _, strat, rep = run_experiment("har", name, num_clients=8, seed=0, device=dev, init_params=init_np, **kw)
            out[dev] = (strat, rep, time.perf_counter() - t0)
        (sc, rc, tc), (sg, rg, tg) = out["cpu"], out[DEVICE]
        label = f"agreement {name} {kw}"
        for field in ("up_events", "down_events", "up_bytes", "down_bytes", "duration", "up_series", "down_series"):
            check(getattr(rc, field) == getattr(rg, field), f"{label}: {field} differs card vs CPU")
        check(sc.stats() == sg.stats(), f"{label}: stats {sc.stats()} != {sg.stats()}")
        check([t for t, _ in rc.curve] == [t for t, _ in rg.curve], f"{label}: evaluation times differ")
        gap = max(abs(a - b) for (_, a), (_, b) in zip(rc.curve, rg.curve))
        check(gap <= 0.02, f"{label}: accuracy curves differ by {gap}")
        print(f"{label} (har, 8 clients, card vs CPU): ledger and stats identical ({json.dumps(sg.stats())}), "
              f"accuracy gap {gap:.4f}, final {rg.final_acc:.4f}; wall CPU {tc:.2f} s, card {tg:.2f} s")


def loop_agreement(init_np: list, rnn_np: dict) -> None:
    """The loop client backend (``client_backend="loop"``: one
    ``SimClient.local_train`` / ``evaluate`` a client, the strategy's own
    ``feedback_fn`` probes) on ``har`` (8 clients): EchoPFL per event at
    900 s and FedAvg at 5 rounds, the card's loop against the CPU's loop
    (identical ledgers and decisions, accuracy curves within 0.02) and
    against the card's fleet (identical ledgers and decisions)."""
    from repro_torch.fl.experiment import run_experiment

    for name, kw in (("echopfl", dict(max_time=900, rnn_params=rnn_np)), ("fedavg", dict(rounds=5))):
        out = {}
        for dev, backend in (("cpu", "loop"), (DEVICE, "loop"), (DEVICE, "fleet")):
            t0 = time.perf_counter()
            _, _, strat, rep = run_experiment("har", name, num_clients=8, seed=0, device=dev, init_params=init_np,
                                              client_backend=backend, **kw)
            out[dev, backend] = (strat, rep, time.perf_counter() - t0)
        decisions = (lambda s: (s.events, s.clustering.assignment)) if name == "echopfl" else (lambda s: s.stats())
        (sc, rc, tc), (sl, rl, tl), (sf, rf, tf) = out["cpu", "loop"], out[DEVICE, "loop"], out[DEVICE, "fleet"]
        for label, (sa, ra), (sb, rb) in (("card loop vs CPU loop", (sl, rl), (sc, rc)),
                                          ("card loop vs card fleet", (sl, rl), (sf, rf))):
            for field in ("up_events", "down_events", "up_bytes", "down_bytes", "duration", "up_series", "down_series"):
                check(getattr(ra, field) == getattr(rb, field), f"loop agreement {name}, {label}: {field} differs")
            check(decisions(sa) == decisions(sb), f"loop agreement {name}, {label}: decisions differ")
            check([t for t, _ in ra.curve] == [t for t, _ in rb.curve], f"loop agreement {name}, {label}: eval times")
        gap = max(abs(a - b) for (_, a), (_, b) in zip(rl.curve, rc.curve))
        check(gap <= 0.02, f"loop agreement {name}: card loop vs CPU loop accuracy curves differ by {gap}")
        fleet_gap = max(abs(a - b) for (_, a), (_, b) in zip(rl.curve, rf.curve))
        print(f"loop agreement {name} (har, 8 clients): card loop = CPU loop and = card fleet in ledger and "
              f"decisions; accuracy gap {gap:.4f} to the CPU, {fleet_gap:.4f} to the fleet; final {rl.final_acc:.4f}; "
              f"wall CPU loop {tc:.2f} s, card loop {tl:.2f} s, card fleet {tf:.2f} s")


def lm_agreement(rnn_params: dict):
    """The tiny_lm LM run on the card and on the CPU, base, initial delta
    and broadcast RNN handed over: identical ledgers, server events and
    assignments; accuracy curves within 0.02."""
    from repro_torch.fl.lm_task import default_lm_task, run_lm_experiment
    from repro_torch.interop import tree_to_numpy

    task = default_lm_task("cpu")
    base = tree_to_numpy(task.base.params)
    delta = tree_to_numpy(task.init_params(torch.Generator().manual_seed(0)))
    out = {}
    for dev in ("cpu", DEVICE):
        t0 = time.perf_counter()
        _, _, strat, rep = run_lm_experiment("echopfl", num_clients=8, max_time=900, eval_interval=120, seed=0,
                                             device=dev, base_params=base, init_params=delta,
                                             rnn_params=rnn_params)
        out[dev] = (strat, rep, time.perf_counter() - t0)
    (sc, rc, tc), (sg, rg, tg) = out["cpu"], out[DEVICE]
    for name in ("up_events", "down_events", "up_bytes", "down_bytes"):
        check(getattr(rc, name) == getattr(rg, name),
              f"LM agreement: {name} {getattr(rc, name)} != {getattr(rg, name)}")
    check(sc.events == sg.events, "LM agreement: server event sequences differ")
    check(sc.clustering.assignment == sg.clustering.assignment, "LM agreement: assignments differ")
    gap = max(abs(a - b) for (_, a), (_, b) in zip(rc.curve, rg.curve))
    check(gap <= 0.02, f"LM agreement: accuracy curves differ by {gap}")
    centers = max((sc.clustering.clusters[cid].center_vec - c.center_vec.cpu()).abs().max().item()
                  for cid, c in sg.clustering.clusters.items())
    print(f"LM agreement (tiny_lm, 8 clients, 900 s, card vs CPU plain versions): ledger and "
          f"{len(sg.events)} events identical, accuracy gap {gap:.4f}, centers max |diff| {centers:.3g}; "
          f"wall CPU {tc:.2f} s, card {tg:.2f} s")


def serving_agreement(rnn_np: dict) -> None:
    """The per-cluster serving example (``repro_torch.launch.serve_cluster_models``)
    on the card against the CPU, the initial weights (a CPU generator seeded
    0) and the broadcast RNN handed over: identical clusters, assignments
    and events; served logits within EXAMPLE_ATOL and tokens the CPU's
    wherever the CPU's top-2 margin exceeds EXAMPLE_ATOL, each row up to
    and including its first position where the margin is thin and the
    tokens differ; at least one position compared."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.interop import tree_to_numpy
    from repro_torch.launch.serve_cluster_models import main as example
    from repro_torch.models.model import init_params

    cfg = reduced_config(get_config("gemma2-2b"), d_model=64, periods=2)
    init = tree_to_numpy(init_params(cfg, torch.Generator().manual_seed(0)))
    t0 = time.perf_counter()
    cpu = example("cpu", init_params=init, rnn_params=rnn_np, verbose=False)
    t1 = time.perf_counter()
    card = example(DEVICE, init_params=init, rnn_params=rnn_np)
    t2 = time.perf_counter()
    sc, sg = cpu["server"], card["server"]
    check(sc.clustering.assignment == sg.clustering.assignment and sc.events == sg.events
          and sc.stats() == sg.stats(), "serving example: card and CPU differ in clusters or decisions")
    centers = max((sc.clustering.clusters[cid].center_vec - c.center_vec.cpu()).abs().max().item()
                  for cid, c in sg.clustering.clusters.items())
    err, exempt, n, compared = 0.0, 0, 0, 0
    for cid, want in cpu["served"].items():
        got = card["served"][cid]
        ref, out = torch.from_numpy(want["logits"]), torch.from_numpy(got["logits"])  # (gen, B, V)
        top2 = torch.topk(ref[..., :cfg.vocab_size], 2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).T.numpy()
        B, T = got["tokens"].shape
        n += B * T
        for b in range(B):
            # a row's logits and tokens are compared up to and including its first position where the CPU's
            # margin is thin and the tokens differ: the logits there came from the same prefix, later ones not
            stop = T
            for t in range(T):
                if margin[b, t] > EXAMPLE_ATOL:
                    check(got["tokens"][b, t] == want["tokens"][b, t], f"serving example: cluster {cid} row {b} "
                          f"position {t} differs with margin {margin[b, t]}")
                elif got["tokens"][b, t] != want["tokens"][b, t]:
                    exempt += T - t
                    stop = t + 1
                    break
                else:
                    exempt += 1
            err = max(err, (out[:stop, b] - ref[:stop, b]).abs().max().item())
            compared += stop
    check(compared > 0, "serving example: no served position was compared")
    check(err <= EXAMPLE_ATOL, f"serving example: served logits differ by {err}")
    print(f"serving example agreement (reduced gemma2-2b, 4 clients, 40 uploads, card vs CPU): clusters "
          f"{sg.stats()['clusters']}, assignments and {len(sg.events)} events identical, centers max |diff| "
          f"{centers:.3g}, served logits max |diff| {err:.3g} at {compared} of {n} positions (tolerance "
          f"{EXAMPLE_ATOL}), {exempt} of {n} token positions exempt; wall CPU {t1 - t0:.2f} s, card {t2 - t1:.2f} s")


def pytree_agreement(init_np: list, rnn_np: dict) -> None:
    """``har`` (8 clients, 900 s, per event) with the pytree backend, card
    against CPU: identical ledgers, events and assignments, accuracy curves
    within 0.02."""
    from repro_torch.fl.experiment import run_experiment

    out = {}
    for dev in ("cpu", DEVICE):
        t0 = time.perf_counter()
        _, _, strat, rep = run_experiment("har", "echopfl", num_clients=8, max_time=900, seed=0, device=dev,
                                          init_params=init_np, rnn_params=rnn_np, plane_backend="pytree")
        out[dev] = (strat, rep, time.perf_counter() - t0)
    (sc, rc, tc), (sg, rg, tg) = out["cpu"], out[DEVICE]
    for name in ("up_events", "down_events", "up_bytes", "down_bytes", "duration"):
        check(getattr(rc, name) == getattr(rg, name), f"pytree agreement: {name} differs")
    check(sc.events == sg.events and sc.clustering.assignment == sg.clustering.assignment,
          "pytree agreement: decisions differ")
    check(sg.stats()["backend"] == "pytree" and sg.stats()["plane_rows"] == 0, "pytree agreement: backend")
    gap = max(abs(a - b) for (_, a), (_, b) in zip(rc.curve, rg.curve))
    check(gap <= 0.02, f"pytree agreement: accuracy curves differ by {gap}")
    print(f"pytree agreement (har, 8 clients, 900 s, per event, card vs CPU): ledger and {len(sg.events)} events "
          f"identical, accuracy gap {gap:.4f}; wall CPU {tc:.2f} s, card {tg:.2f} s")


def _zoo_batch(cfg, shape, seed: int) -> dict:
    """Tokens, or frame embeddings for an encoder, from a numpy generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if cfg.is_encoder:
        return {"embeds": torch.from_numpy(rng.standard_normal((*shape, cfg.d_model)).astype(np.float32))}
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))}


def _zoo_perturbed(params: dict) -> dict:
    """The weights with the embedding scaled by 1 +- 6e-8 (a random sign an
    element): one ulp of noise, as tests/torch_zoo.py perturbs them."""
    import numpy as np

    sign = np.random.default_rng(5).choice([-1.0, 1.0], tuple(params["embed"].shape)).astype(np.float32)
    return dict(params, embed=params["embed"] * (1 + 6e-8 * torch.from_numpy(sign)).to(params["embed"].device))


def _params_off(a_leaves, b_leaves, lr: float) -> tuple[int, int, int, float]:
    """Elements beyond atol 1e-6 and beyond atol 0.1 lr (rtol 1e-4 in both),
    the element count and the largest difference."""
    off = big = total = 0
    worst = 0.0
    for a, b in zip(a_leaves, b_leaves):
        d, r = (a.cpu() - b).abs(), 1e-4 * b.abs()
        off += int((d > 1e-6 + r).sum())
        big += int((d > 0.1 * lr + r).sum())
        total += a.numel()
        worst = max(worst, d.max().item())
    return off, big, total, worst


def zoo_agreement() -> None:
    """The model zoo's five reduced archs (``reduced_config``: d_model 64,
    2 periods) on the card against the CPU, weights from a CPU generator
    seeded 0: the forward's logits and MoE aux loss; the prefill and 8
    decode steps fed the same tokens (MoE dropless; not the encoder); one
    train step's loss, ce, aux and params. Tolerances as
    ``tests/torch_zoo.py``'s: logits and caches within rtol/atol ZOO_ATOL,
    except an arch of ZOO_SENSITIVE, held to 3 times how far its CPU logits
    move under one ulp of noise on the embeddings (the forward's, and the
    prefill and decode steps' for those); params at most 0.1% of
    the elements beyond atol 1e-6 and 0.001% beyond 0.1 lr (an Adam or
    Adafactor first step's sign flips where a gradient is rounding noise),
    none beyond 2.5 lr, or for ZOO_SENSITIVE 3 times the CPU's own counts
    from the perturbed weights. The card's flash forward must launch once an
    attention layer in the forward, and in the train step once more for each
    attention layer remat recomputes (those of the periods), the backward
    kernels once each."""
    import dataclasses

    import numpy as np

    from repro_torch.common.pytrees import tree_leaves, tree_map
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prefill
    from repro_torch.models.model import forward, init_params
    from repro_torch.models.steps import TrainState, make_optimizer, make_serve_step, make_train_step

    S, GEN = 12, 8
    for name in ZOO:
        t0 = time.perf_counter()
        cfg = reduced_config(get_config(name))
        n_attn = sum(spec.mixer in ("attn", "attn_local") for spec in cfg.all_layers)
        cpu = init_params(cfg, torch.Generator().manual_seed(0))
        card = tree_map(lambda t: t.to(DEVICE), cpu)
        b = _zoo_batch(cfg, (2, S), 1)
        on = lambda batch: {k: v.to(DEVICE) for k, v in batch.items()}  # noqa: E731
        with torch.no_grad():
            want, want_aux, _ = forward(cfg, cpu, b)
            tol, spread = ZOO_ATOL, None
            if name in ZOO_SENSITIVE:
                spread = (forward(cfg, _zoo_perturbed(cpu), b)[0] - want).abs().max().item()
                tol = max(ZOO_ATOL, 3 * spread)
            ops.reset_launch_counts()
            got, aux, _ = forward(cfg, card, on(b))
            sync()
            launches = ops.launch_counts()
        check(launches["flash_attention_fwd"] == n_attn and sum(launches.values()) == n_attn,
              f"zoo agreement {name}: forward launches {launches}, not {n_attn} flash forwards")
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol, msg=lambda m: f"zoo {name} forward: {m}")
        torch.testing.assert_close(aux.cpu(), want_aux, rtol=ZOO_ATOL, atol=ZOO_ATOL,
                                   msg=lambda m: f"zoo {name} aux: {m}")
        errs = {"forward": (got.cpu() - want).abs().max().item()}
        if not cfg.is_encoder:
            dcfg = dataclasses.replace(cfg, moe_dropless=True)
            feed = _zoo_batch(cfg, (2, GEN), 5)["tokens"]
            steps = {}
            starts = [("cpu", cpu), (DEVICE, card)] + ([("moved", _zoo_perturbed(cpu))] if spread else [])
            for label, params in starts:
                dev = DEVICE if label == DEVICE else "cpu"
                logits, cache = prefill(dcfg, params, b["tokens"].to(dev), GEN)
                serve = make_serve_step(dcfg)
                out = [logits[:, -1]]
                for i in range(GEN):
                    logits, cache = serve(params, cache, {"tokens": feed[:, i:i + 1].to(dev)})
                    out.append(logits[:, -1])
                steps[label] = torch.stack(out).cpu()
            dtol = ZOO_ATOL
            if spread:  # the decode's own one-ulp spread on the CPU
                spread = max(spread, (steps["moved"] - steps["cpu"]).abs().max().item())
                dtol = max(ZOO_ATOL, 3 * spread)
            torch.testing.assert_close(steps[DEVICE], steps["cpu"], rtol=dtol, atol=dtol,
                                       msg=lambda m: f"zoo {name} prefill and decode: {m}")
            errs["decode"] = (steps[DEVICE] - steps["cpu"]).abs().max().item()
            errs["decode_tol"] = dtol
        labels = np.random.default_rng(10).integers(0, cfg.vocab_size, (4, S))
        tb = dict(_zoo_batch(cfg, (4, S), 20), labels=torch.from_numpy(labels))
        opt = make_optimizer(cfg)
        step = make_train_step(cfg)
        runs = {}
        starts = [("cpu", cpu), (DEVICE, card)] + ([("moved", _zoo_perturbed(cpu))] if name in ZOO_SENSITIVE else [])
        for label, params in starts:
            if label == DEVICE:
                ops.reset_launch_counts()
            state, m = step(TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32)), tb)
            if label == DEVICE:
                sync()
                launches = ops.launch_counts()
            runs[label] = (tree_leaves(state.params), {k: float(v) for k, v in m.items()})
        check(launches["flash_attention_fwd"] == n_attn + recomputed_attention(cfg)
              and launches["flash_attention_dq"] == launches["flash_attention_dkv"] == n_attn,
              f"zoo agreement {name}: train step launches {launches}")
        (cl, cm), (gl, gm) = runs["cpu"], runs[DEVICE]
        lr = cfg.train.learning_rate
        for k in ("loss", "ce", "moe_aux"):
            limit = max(1e-5 * abs(cm[k]), 1e-6 if k == "moe_aux" else 0.0)
            if "moved" in runs:
                limit = max(limit, 3 * abs(runs["moved"][1][k] - cm[k]))
            check(abs(gm[k] - cm[k]) <= limit, f"zoo agreement {name}: train {k} {gm[k]} against {cm[k]}")
        off, big, total, worst = _params_off(gl, cl, lr)
        off_limit, big_limit = 1e-3 * total, 1e-5 * total
        if "moved" in runs:
            m_off, m_big, _, _ = _params_off(runs["moved"][0], cl, lr)
            off_limit, big_limit = max(off_limit, 3 * m_off), max(big_limit, 3 * m_big)
        check(off <= off_limit and big <= big_limit and worst <= 2.5 * lr,
              f"zoo agreement {name}: params after a train step off {off} (limit {off_limit}), beyond 0.1 lr {big} "
              f"(limit {big_limit}), worst {worst}")
        print(f"zoo agreement ({name} reduced, card vs CPU): forward max |diff| {errs['forward']:.3g} (tolerance "
              f"{tol:.3g})" + (f", prefill and 8 decode steps {errs['decode']:.3g} (tolerance {errs['decode_tol']:.3g})"
                               if "decode" in errs else ", no decode (encoder)")
              + (f", tolerances 3 x the CPU's one-ulp spread, at most {spread:.3g}" if spread else "")
              + f"; aux {float(aux):.6f}; train loss {gm['loss']:.6f} against {cm['loss']:.6f}, params off "
              f"{off} / beyond 0.1 lr {big} of {total}, worst {worst:.3g}; flash forward launches {n_attn} a forward; "
              f"wall {time.perf_counter() - t0:.2f} s")


def training_agreement(rnn_np: dict) -> None:
    """Training, card against CPU: (1) the driver
    (``repro_torch.launch.train.train``) at TRAIN_AGREEMENT's reduced archs
    for 3 steps (batch 2, 16 tokens), weights from a CPU generator seeded
    0: each loss within rtol 1e-5, the params by phase 4's zoo rule (at most
    0.1% of the elements beyond atol 1e-6, 0.001% beyond 0.1 lr, none beyond
    2.5 lr a step), and on the card per step one flash forward launch an
    attention layer plus one a recomputed one, one of each backward kernel
    an attention layer; (2) remat on against off on the card, 2 train steps
    of each, every loss, metric, param and optimizer leaf bit for bit;
    (3) the EchoPFL transformer-client example for EXAMPLE_AGREEMENT_ROUNDS
    rounds, initial weights from a CPU generator and phase 4's broadcast RNN
    handed to both: the same arrivals, and after every round the same
    assignment, clusters, broadcasts and merges; each client's round losses
    within EXAMPLE_LOSS_RTOL."""
    import dataclasses

    from repro_torch.common.pytrees import tree_leaves, tree_map
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.lm import token_stream
    from repro_torch.interop import tree_to_numpy
    from repro_torch.kernels import ops
    from repro_torch.launch import train as driver
    from repro_torch.launch import train_async_pfl as example
    from repro_torch.models.model import init_params
    from repro_torch.models.steps import TrainState, make_optimizer, make_train_step

    steps = 3
    for name in TRAIN_AGREEMENT:
        t0 = time.perf_counter()
        cfg = reduced_config(get_config(name))
        n_attn = sum(spec.mixer in ("attn", "attn_local") for spec in cfg.all_layers)
        cpu = init_params(cfg, torch.Generator().manual_seed(0))
        kw = dict(steps=steps, batch=2, seq=16, verbose=False)
        want = driver.train(cfg, device="cpu", params=cpu, **kw)
        ops.reset_launch_counts()
        got = driver.train(cfg, device=DEVICE, params=tree_map(lambda t: t.to(DEVICE), cpu), **kw)
        sync()
        launches = ops.launch_counts()
        check(launches["flash_attention_fwd"] == steps * (n_attn + recomputed_attention(cfg))
              and launches["flash_attention_dq"] == launches["flash_attention_dkv"] == steps * n_attn,
              f"training agreement {name}: launches {launches}")
        for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
            check(abs(a - b) <= 1e-5 * abs(b), f"training agreement {name}: step {i} loss {a} against {b}")
        lr = cfg.train.learning_rate
        off, big, total, worst = _params_off(tree_leaves(got["state"].params), tree_leaves(want["state"].params), lr)
        check(off <= 1e-3 * total and big <= 1e-5 * total and worst <= 2.5 * lr * steps,
              f"training agreement {name}: params off {off}, beyond 0.1 lr {big} of {total}, worst {worst}")
        # remat on against off on the card
        bits = {}
        for remat in (True, False):
            c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=remat))
            opt = make_optimizer(c)
            params = tree_map(lambda t: t.to(DEVICE), cpu)
            state = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32, device=DEVICE))
            step, stream, metrics = make_train_step(c, opt), token_stream(c.vocab_size, seed=0, batch=2, seq=16), []
            for _ in range(2):
                state, m = step(state, next(stream))
                metrics.append(m)
            bits[remat] = (state, metrics)
        (sa, ma), (sb, mb) = bits[True], bits[False]
        check(_tree_bits_equal(sa, sb) and all(torch.equal(x[k], y[k]) for x, y in zip(ma, mb) for k in x),
              f"training agreement {name}: remat changed a bit on the card")
        print(f"training agreement ({name} reduced, {steps} driver steps, card vs CPU): losses "
              f"{[round(x, 6) for x in got['losses']]} against {[round(x, 6) for x in want['losses']]}, params off "
              f"{off} / beyond 0.1 lr {big} of {total}, worst {worst:.3g}; launches {json.dumps(launches)}; remat on "
              f"and off on the card bit for bit over 2 steps; wall {time.perf_counter() - t0:.2f} s")
    # the example, card against CPU
    t0 = time.perf_counter()
    init_np = tree_to_numpy(init_params(example.example_config(), torch.Generator().manual_seed(0)))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_example_")
    try:
        runs = {dev: example.run(dev, steps=EXAMPLE_AGREEMENT_ROUNDS, ckpt_dir=os.path.join(tmp, dev),
                                 init_params=init_np, rnn_params=rnn_np, verbose=False) for dev in ("cpu", DEVICE)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    c, g = runs["cpu"], runs[DEVICE]
    check(c["order"] == g["order"], "example agreement: arrival orders differ")
    diverged = next((h["round"] for h, k in zip(g["history"], c["history"]) if h != k), None)
    check(diverged is None, f"example agreement: decisions differ from round {diverged}")
    check(c["server"].events == g["server"].events, "example agreement: server events differ")
    gap = 0.0
    for cid, want in c["losses"].items():
        for a, b in zip(g["losses"][cid], want):
            gap = max(gap, abs(a - b) / abs(b))
    check(gap <= EXAMPLE_LOSS_RTOL, f"example agreement: round losses {gap} apart (relative)")
    print(f"example agreement (train_async_pfl, {EXAMPLE_AGREEMENT_ROUNDS} rounds, card vs CPU): arrivals, "
          f"assignments, clusters, broadcasts ({g['stats']['broadcasts']}) and merges ({g['stats']['merges']}) "
          f"identical every round, {len(g['server'].events)} server events identical; round losses within "
          f"{gap:.3g} (relative); wall CPU {c['wall_s']:.2f} s, card {g['wall_s']:.2f} s, "
          f"phase {time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------------ phase 5
def call_ms(fn, iters: int = 200, reps: int = 5) -> float:
    """Per-call time of back-to-back calls between two CUDA events: what a
    caller pays per call, the host's launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / iters)
    return statistics.median(per)


class DeviceEvent(NamedTuple):
    name: str
    us: float  # duration


def _device_events(prof) -> list[DeviceEvent]:
    """The device events of a trace, less the head sentinels of
    ``_device_trace``, read from the profiler's raw results: ``prof.events()``
    would first parse every event of the trace, host calls included, into
    ``FunctionEvent`` trees (some 80 us an event on the host, against some
    5 us here), for the same names and the same durations."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            if "spin_kernel" not in name:
                out.append(DeviceEvent(name, (e.end_ns() - e.start_ns()) / 1e3))
    return out


def _device_us(events: list[DeviceEvent]) -> Counter:
    """Device time (us) by kernel name."""
    per: Counter = Counter()
    for e in events:
        per[e.name] += e.us
    return per


PROFILER_PAD_S = 0.005  # host sleep at each end of a profiled window
# On the H100 a session can drop its first few kernel launches (2 to 6 seen, more after a long
# run, never a later one; once, with 32 spin kernels, every session of a timing lacked 2 of its
# 300 measured launches): each session starts with this many spin kernels, which
# _device_events leaves out, so the launches that are measured come after them.
PROFILER_HEAD_KERNELS = 256
trace_sessions = Counter()  # device_ms's profiler sessions: "kept" and "refused"


def _device_trace(run):
    """``torch.profiler`` trace (CUDA activity only) of ``run()``, padded by
    an idle host sleep at each end and headed by PROFILER_HEAD_KERNELS spin
    kernels; returns ``(prof, run's result)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        for _ in range(PROFILER_HEAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        out = run()
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)
    return prof, out


def device_ms(fn, iters: int = 100, sessions: int = 6) -> float:
    """Device time per call: the summed durations of the kernels one call
    launches, from a ``torch.profiler`` trace (host overhead excluded).

    On the H100 the profiler now and then records only part of a short
    session's kernels, or none; the launches it drops most often, a
    session's first few, fall on ``_device_trace``'s head sentinels. It
    never records more than ran, so a session's event count is held to the
    largest seen: a time is kept once two sessions record that same count, a
    whole number of events per call; after ``sessions`` sessions without
    that, the run fails."""
    fn()
    by_count: dict[int, list[float]] = {}
    for _ in range(sessions):
        prof, _ = _device_trace(lambda: [fn() for _ in range(iters)])
        events = _device_events(prof)
        by_count.setdefault(len(events), []).append(sum(e.us for e in events))
        top = max(by_count)
        if top > 0 and top % iters == 0 and len(by_count[top]) == 2:
            kept = sum(len(v) for v in by_count.values())
            trace_sessions.update(kept=2, refused=kept - 2)
            return sum(by_count[top]) / 2 / iters / 1e3
    raise AssertionError(f"the profiler recorded no two full sessions in {sessions}: "
                         f"event counts {sorted(by_count)} for {iters} calls")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _server_case(name: str, shape: tuple, g):
    """``(fn, plain, library call or None, bytes, flops, max_abs_err)`` for one
    server kernel at one shape, on fresh random inputs."""
    from repro_torch.kernels import assign_lerp, chi2, l1, merge, ops

    lib = None
    if name in ("l1_distance", "l1_distance_pairwise"):
        m, c, n = shape
        xs, cs = randn(g, m, n), randn(g, c, n)
        if name == "l1_distance":
            u = xs[0].contiguous()
            fn, plain = (lambda: ops.l1_distance(u, cs)), (lambda: l1.l1_distance_plain(u, cs))
            lib = lambda: torch.cdist(u[None], cs, p=1)  # noqa: E731
        else:
            fn, plain = (lambda: ops.l1_distance_pairwise(xs, cs)), (lambda: l1.l1_distance_pairwise_plain(xs, cs))
            lib = lambda: torch.cdist(xs, cs, p=1)  # noqa: E731
        nbytes, flops = 4 * (m * n + c * n + m * c), 3 * m * c * n
        err = (fn() - plain()).abs().max().item()
    elif name == "assign_and_lerp":
        c, n = shape
        u, cs = randn(g, n), randn(g, c, n)
        fn, plain = (lambda: ops.assign_and_lerp(u, cs, 0.25)), (lambda: assign_lerp.assign_and_lerp_plain(u, cs, 0.25))
        nbytes, flops = 4 * (n + c * n + c + 1 + n), 3 * c * n + c + 3 * n
        a, b = fn(), plain()
        err = max((a[0] - b[0]).abs().max().item(), (a[2] - b[2]).abs().max().item())
    elif name in ("chi2_feedback", "chi2_feedback_segmented"):
        m, j = shape[:2]
        fp = torch.rand((m, j), generator=g, device=DEVICE) * 30
        ft = torch.rand((m, j), generator=g, device=DEVICE) * 30 + 1.0
        ss = torch.softmax(randn(g, m, j), dim=-1)
        nbytes, flops = 4 * (3 * m * j + m), 9 * m * j
        if name == "chi2_feedback":
            fn, plain = (lambda: ops.chi2_feedback(fp, ft, ss)), (lambda: chi2.chi2_feedback_plain(fp, ft, ss))
            err = (fn() - plain()).abs().max().item()
        else:
            s = shape[2]
            seg = torch.arange(m, device=DEVICE, dtype=torch.int32) % s
            fn = lambda: ops.chi2_feedback_segmented(fp, ft, ss, seg, s)  # noqa: E731
            plain = lambda: chi2.chi2_feedback_segmented_plain(fp, ft, ss, seg, s)  # noqa: E731
            nbytes += 4 * (m + s)
            flops += m
            a, b = fn(), plain()
            err = max((a[0] - b[0]).abs().max().item(), (a[1] - b[1]).abs().max().item())
    else:  # merge_attention
        (n,) = shape
        vm, va, vt = randn(g, n), randn(g, n), randn(g, n)
        fn, plain = (lambda: ops.merge_attention(vm, va, vt)), (lambda: merge.merge_attention_plain(vm, va, vt))
        nbytes, flops = 4 * 4 * n, 10 * n
        err = (fn() - plain()[0]).abs().max().item()
    return fn, plain, lib, nbytes, flops, err


def _inplace_merge_call_ms(n: int, g) -> float:
    """Per-call time of the merge as the server calls it: in place, ``out``
    the main row, so the wrapper allocates nothing."""
    from repro_torch.kernels import ops

    vm, va, vt = randn(g, n), randn(g, n), randn(g, n)
    return call_ms(lambda: ops.merge_attention(vm, va, vt, out=vm))


def _server_timing(name: str, shape: tuple, launches: int, g, label: str) -> dict:
    fn, plain, lib, nbytes, flops, err = _server_case(name, shape, g)
    bound_ms, bound_by = bound(nbytes, flops)
    row = {
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(fn), "plain_ms": device_ms(plain), "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None if lib is None else device_ms(lib),
        "call_ms": call_ms(fn), "plain_call_ms": call_ms(plain),
        "library_call_ms": None if lib is None else call_ms(lib),
        "shape": list(shape),
    }
    if name == "merge_attention":
        row["inplace_call_ms"] = _inplace_merge_call_ms(shape[0], g)
    print(f"timing {name} at {label}{tuple(shape)}: device time kernel {row['ms']:.5f} ms, plain "
          f"{row['plain_ms']:.5f} ms, library " + ("n/a" if lib is None else f"{row['library_ms']:.5f} ms")
          + f"; bound {bound_ms:.6f} ms ({bound_by}); per call kernel {row['call_ms']:.4f} ms, plain "
          f"{row['plain_call_ms']:.4f} ms, library "
          + ("n/a" if lib is None else f"{row['library_call_ms']:.4f} ms")
          + (f", in place {row['inplace_call_ms']:.4f} ms" if "inplace_call_ms" in row else "")
          + f"; launches {launches}; max_abs_err {err:.3g}")
    return row


def _chain_timing(shape: tuple, launches: int, label: str, with_stats: bool = False) -> dict:
    """The ingest chain at one (S, C, N) on fresh inputs: the kernel, the
    plain version on the card, and the per-event device work for the same S
    uploads (S fused assigns and 3 S ``l1_distance``, as ``handle_upload``
    launches them). ``bound_ms``: each input read and each output written
    once; ``bound_step_ms``: a step's own traffic, S (C + 6) N floats.
    ``with_stats``: the chain with the guard's norm statistic (one more
    output a step, 2 N more flops)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ingest_chain import ingest_chain_plain
    from repro_torch.kernels.l1 import l1_distance

    S, C, N = shape
    U, centers, bcast, prev, forced = chain_inputs(S, C, N, S * 31 + C)
    Ud, Cd, Bd = (torch.from_numpy(a).to(DEVICE) for a in (U, centers, bcast))
    fn = lambda: ops.ingest_chain(Ud, Cd, Bd, prev, forced, beta=0.25, with_stats=with_stats)  # noqa: E731
    plain = lambda: ingest_chain_plain(Ud, Cd, Bd, prev, forced, 0.25, with_stats=with_stats)  # noqa: E731

    def per_event():
        for j in range(S):
            ops.assign_and_lerp(Ud[j], Cd, 0.25)
            for _ in range(3):
                l1_distance(Ud[j], Cd[:1])

    a, b = fn(), plain()
    err = max((a.stats - b.stats).abs().max().item(), (a.blended - b.blended).abs().max().item())
    K = 4 if with_stats else 3
    nbytes = 4 * (2 * S * N + 3 * C * N + S * C + (K + 1) * S + 2 * S)
    bound_ms, bound_by = bound(nbytes, S * (3 * C + 12 + 2 * (K - 3)) * N)
    row = {
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(fn), "plain_ms": device_ms(plain, iters=10), "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "bound_step_ms": S * (C + 6) * N * 4 / HBM_BYTES_PER_S * 1e3,
        "per_event_ms": device_ms(per_event, iters=10),
        "call_ms": call_ms(fn, 50, 3), "plain_call_ms": call_ms(plain, 5, 3), "per_event_call_ms": call_ms(per_event, 10, 3),
        "shape": list(shape),
    }
    print(f"timing ingest_chain at {label}{shape}: device time kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, "
          f"per-event work {row['per_event_ms']:.5f} ms; bound {bound_ms:.6f} ms ({bound_by}), a step's own traffic "
          f"{row['bound_step_ms']:.6f} ms; per call kernel {row['call_ms']:.4f} ms, plain {row['plain_call_ms']:.4f} ms, "
          f"per-event {row['per_event_call_ms']:.4f} ms; launches {launches}; max_abs_err {err:.3g}")
    return row


def chain_row(coal, chaos) -> dict:
    """The ingest chain's row: at phase 3d's most frequent segment shape,
    with (32, 4, 25418) beside it under ``"s32_c4"`` and the chain with the
    guard's norm at (25, 4, 25418) under ``"with_stats"`` (launches: phase
    3h's coalesced guard-on runs'), beside its time without the norm at the
    same shape under ``"without_stats"``."""
    source, replaces = KERNELS["ingest_chain"]
    shape = coal["segs"].most_common(1)[0][0]
    row = {"name": "ingest_chain", "route": "cuda", "source": source, "replaces": replaces,
           "note": "not a pallas_call: ops.ingest_chain (jit body _ingest_chain_jit, src/repro/kernels/ops.py:446), "
                   "a lax.scan around src/repro/kernels/l1_distance.py:51",
           **_chain_timing(shape, coal["counts"]["ingest_chain"], "phase 3d's most frequent shape ")}
    row["s32_c4"] = _chain_timing((32, 4, 25418), coal["segs"][(32, 4, 25418)], "")
    with_norm = chaos["chains_with_stats"]
    row["without_stats"] = _chain_timing((25, 4, 25418), coal["segs"][(25, 4, 25418)], "without the norm ")
    row["with_stats"] = _chain_timing((25, 4, 25418), with_norm, "with the norm ", with_stats=True)
    return row


def _uplink_timing(name: str, shape: tuple, launches: int, label: str) -> dict:
    """One encode kernel at (B, n) on fresh seeded inputs (k = round(0.1 n),
    chunk 512, the codec's defaults): device and per-call time of the
    kernel and the plain version; the bound counts 16 B an element for int8
    (mat and the anchor read, rec and the anchor written) and for top-k
    20 B an element (mat, the anchor and the residual read, rec and the
    residual written) plus 4 B for each anchor element whose bits the
    encode changes (the sent ones, and unsent -0 anchors made +0), counted
    on this call's data; ``library_ms`` for top-k is ``torch.topk`` on |c|
    at the same shape, a yardstick the port never calls (it breaks ties
    otherwise), for int8 none."""
    from repro_torch.kernels import ops, uplink

    b, n = shape
    k, chunk = round(0.1 * n), min(512, n)
    plane, a_rows, r_rows, mat = uplink_case("random", (b, n, chunk, k))
    if name == "uplink_int8_encode":
        fn = lambda: ops.uplink_int8_encode(plane, a_rows, mat, chunk)  # noqa: E731
        plain = lambda: uplink.uplink_int8_encode_plain(plane, a_rows, mat, chunk)  # noqa: E731
        lib, nbytes, flops = None, 16 * b * n, 8 * b * n
    else:
        fn = lambda: ops.uplink_topk_encode(plane, a_rows, r_rows, mat, k)  # noqa: E731
        plain = lambda: uplink.uplink_topk_encode_plain(plane, a_rows, r_rows, mat, k)  # noqa: E731
        mag = (mat - plane[a_rows] + plane[r_rows]).abs()
        lib, flops = (lambda: torch.topk(mag, k, dim=1)), 12 * b * n
    p0 = plane.clone()
    got = fn()
    p1, plane[:] = plane.clone(), p0
    if name == "uplink_topk_encode":
        changed = int((_bits(p1[a_rows]) != _bits(p0[a_rows])).sum())
        nbytes = 20 * b * n + 4 * changed
    want = plain()
    err = 0.0 if _same_nan_bits(got, want) and _same_nan_bits(p1, plane) else float((got - want).abs().max())
    bound_ms, bound_by = bound(nbytes, flops)
    iters = 20 if b * n > 4_000_000 else 100
    row = {
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(fn, iters), "plain_ms": device_ms(plain, iters), "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None if lib is None else device_ms(lib, iters),
        "call_ms": call_ms(fn, iters, 3), "plain_call_ms": call_ms(plain, iters, 3),
        "library_call_ms": None if lib is None else call_ms(lib, iters, 3), "shape": [b, n],
    }
    print(f"timing {name} at {label}{(b, n)}: device time kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, "
          f"library " + ("n/a" if lib is None else f"{row['library_ms']:.5f} ms (torch.topk)")
          + f"; bound {bound_ms:.6f} ms ({bound_by}); per call kernel {row['call_ms']:.4f} ms, plain "
          f"{row['plain_call_ms']:.4f} ms, library " + ("n/a" if lib is None else f"{row['library_call_ms']:.4f} ms")
          + f"; launches {launches}; max_abs_err {err:.3g}")
    del plane, mat
    return row


def uplink_rows(sweep: list[dict], per_event: dict, full_topk: dict) -> list[dict]:
    """The encode kernels' rows: at the most frequent cohort shape of phase
    3g's EchoPFL arm of their mode (``launches``: the kernel's launches over
    phase 3g's comm sweep), with B = 1 at image_recognition's row (25,418;
    launches: phase 3g's per-event image_recognition run of that mode) and
    the full-width delta (1, 783,360; launches: the full-width top-k run's)
    beside them."""
    rows = []
    for name in UPLINK_KERNELS:
        mode = name.split("_")[1]
        arm = next(r for r in sweep if r["strategy"] == "echopfl" and r["uplink"] == mode)
        shape = tuple(arm["top_cohort"][name])
        launches = sum(r["kernel_launches"][name] for r in sweep)
        source, replaces = KERNELS[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "note": f"not a pallas_call: the jitted cohort encode {replaces}",
               **_uplink_timing(name, shape, launches, "phase 3g's most frequent cohort ")}
        row["image_recognition B=1"] = _uplink_timing(name, (1, 25418), per_event[name], "image_recognition ")
        row["llama3.2-1b"] = _uplink_timing(name, (1, 783360), full_topk["counts"][name], "llama3.2-1b ")
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def timing(counts, shapes, full, tiny):
    """Rows for the server kernels at the main path's most frequent shapes;
    ``l1_distance`` and ``assign_and_lerp`` also at the full-width LM run's
    shapes, under ``"llama3.2-1b"``, with that run's launches; the
    segmented chi2 also at CHI2_EXTRA's shapes and the merge at MERGE_EXTRA's,
    under their names (launches: the ``tiny_lm`` and full-width runs' own,
    else none: the main path does not call them). A row whose sums also run
    inside other kernels names their sources in ``also_in``."""
    g = gen(11)
    rows = []
    full_assign = full["server_shapes"]["assign_and_lerp"].most_common(1)[0][0]
    full_shapes = {"assign_and_lerp": full_assign, "l1_distance": (1, 1, full_assign[1])}
    for name, (source, replaces) in KERNELS.items():
        if name not in MLP_PATH or name == "rnn_chain":
            continue
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               **_server_timing(name, shapes[name].most_common(1)[0][0], counts[name], g, "")}
        if name in ALSO_IN:
            row["also_in"] = ALSO_IN[name]
        if name in full_shapes:
            row["llama3.2-1b"] = _server_timing(name, full_shapes[name], full["counts"][name], g, "llama3.2-1b ")
        if name == "chi2_feedback_segmented":
            for label, shape in CHI2_EXTRA.items():
                row[label] = _server_timing(name, shape, 0, g, f"{label} ")
        if name == "merge_attention":
            runs = {"tiny_lm": tiny["counts"], "llama3.2-1b": full["counts"]}
            for label, shape in MERGE_EXTRA.items():
                row[label] = _server_timing(name, shape, runs.get(label, {}).get(name, 0), g, f"{label} ")
        rows.append(row)
    return rows


def _rnn_cost(T: int, gates) -> tuple[float, float]:
    """(bytes, flops) of one ``rnn_chain`` launch over these gates at window
    T, as the kernel does the work: the weights read once and, where a step
    learns, written once; the packed operands (the windows, the label and
    fallback tables, the gates) read once; the losses and wants written. A
    decision's forward is 3 T products of 128 x 128 and the output layer; a
    learn adds the backward's 3 T - 2 (no gradient flows into the zero
    initial states), the gradient sums' 3 T - 2 outer products and the
    update of every leaf."""
    from repro_torch.kernels.rnn import DECIDE, FALLBACK, HIDDEN, LEAF_FLOATS, LEARN

    S = len(gates)
    learns = sum(1 for g in gates if g & LEARN)
    decides = sum(1 for g in gates if g & DECIDE and not g & FALLBACK)
    cols = S + 1 if any(g & (DECIDE | FALLBACK) for g in gates) else 1
    mm = HIDDEN * HIDDEN
    flops = decides * 2 * (3 * T * mm + 2 * HIDDEN) + learns * (2 * ((9 * T - 4) * mm + 4 * HIDDEN) + 2 * LEAF_FLOATS)
    nbytes = 4 * LEAF_FLOATS * (1 + (learns > 0)) + 4 * (S * T * (1 + (decides > 0)) + 2 * S * cols + S) + 5 * S
    return nbytes, flops


def _rnn_yardstick(T: int, gates):
    """``torch.nn.RNN(1, 128, 2, nonlinearity="tanh")`` (cuDNN) through a
    linear output layer over the same steps: forward, cross-entropy and
    backward a learn step, the forward and argmax a decision step (no
    update). A yardstick the port never calls."""
    from repro_torch.kernels.rnn import DECIDE, FALLBACK, HIDDEN, LEARN

    net = torch.nn.RNN(1, HIDDEN, 2, nonlinearity="tanh").to(DEVICE)
    out = torch.nn.Linear(HIDDEN, 2).to(DEVICE)
    x = torch.rand((T, 1, 1), generator=gen(T), device=DEVICE)
    label = torch.ones(1, dtype=torch.long, device=DEVICE)

    def run():
        for g in gates:
            if g & LEARN:
                hs, _ = net(x)
                torch.nn.functional.cross_entropy(out(hs[-1]), label).backward()
            if g & DECIDE and not g & FALLBACK:
                with torch.no_grad():
                    hs, _ = net(x)
                    torch.argmax(out(hs[-1, 0])) == 1  # noqa: B015
    return run


def _rnn_timing(label: str, T: int, gates, fn, plain, launches: int, err: float, iters: int = 100,
                plain_iters: int | None = 10) -> dict:
    """One ``rnn_chain`` case: device and per-call times of the kernel, the
    plain version (``plain_iters`` None: not timed) and the cuDNN
    yardstick (per call only where it takes under a second)."""
    bound_ms, bound_by = bound(*_rnn_cost(T, gates))
    lib = _rnn_yardstick(T, gates)
    lib_iters = max(1, iters // len(gates))
    row = {
        "launches": launches, "max_abs_err": err, "ms": device_ms(fn, iters),
        "plain_ms": None if plain_iters is None else device_ms(plain, plain_iters), "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": device_ms(lib, lib_iters),
        "call_ms": call_ms(fn, iters, 3), "plain_call_ms": None if plain_iters is None else call_ms(plain, plain_iters, 3),
        "library_call_ms": call_ms(lib, lib_iters, 3) if len(gates) < 100 else None, "shape": [len(gates), T],
    }
    print(f"timing rnn_chain at {label} (S, T) = {(len(gates), T)}: device time kernel {row['ms']:.5f} ms, plain "
          + ("not measured" if row["plain_ms"] is None else f"{row['plain_ms']:.5f} ms")
          + f", cuDNN RNN {row['library_ms']:.5f} ms; bound {bound_ms:.6f} ms ({bound_by}); per call kernel "
          f"{row['call_ms']:.4f} ms, plain " + ("not measured" if row["plain_call_ms"] is None else
                                                f"{row['plain_call_ms']:.4f} ms")
          + ", cuDNN " + ("not measured" if row["library_call_ms"] is None else f"{row['library_call_ms']:.4f} ms")
          + f"; launches {launches}; max_abs_err {err:.3g}")
    return row


def rnn_row(counts, shapes, coal, rnn_check) -> dict:
    """The broadcast RNN's row: a per-event learn at (S, T) = (1, 10)
    (``launches``: the main path's ``rnn_chain`` launches, all four entry
    points), beside it a decision at (1, 10) (the main path's RNN
    decisions), phase 3d's most frequent chain on its recorded operands (its
    chains of that shape) and the (1,200, 10) pretraining (the main path's
    pretrainings; the plain version's wall time on the card from phase 2)."""
    import numpy as np

    from repro_torch.core.broadcast import pretrain_windows
    from repro_torch.kernels import rnn

    source, replaces = KERNELS["rnn_chain"]
    main_rec, coal_rec = shapes["rnn"], coal["rnn"]
    p = _rnn_weights(0)
    seq = np.random.default_rng(10).uniform(0, 1, (10, 1)).astype(np.float32)
    seq_d = torch.from_numpy(seq).to(DEVICE)
    got, want = rnn.rnn_sgd(p, seq, 1, RNN_LR)[0], rnn.rnn_sgd_plain(p, seq_d, 1, RNN_LR)[0]
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    row = {"name": "rnn_chain", "route": "cuda", "source": source, "replaces": replaces,
           "note": "not a pallas_call: ops.predictor_chain's jit body _predictor_chain_jit (src/repro/kernels/"
                   "ops.py:541), broadcast.py:71 _rnn_sgd, :81 _rnn_want and pretrain_rnn's _rnn_sgd loop (:258)",
           **_rnn_timing("a per-event learn", 10, [rnn.LEARN], lambda: rnn.rnn_sgd(p, seq, 1, RNN_LR),
                         lambda: rnn.rnn_sgd_plain(p, seq_d, 1, RNN_LR), counts["rnn_chain"], err)}
    row["decide"] = _rnn_timing("a per-event decision", 10, [rnn.DECIDE], lambda: rnn.rnn_want(p, seq),
                                lambda: rnn.rnn_want_plain(p, seq_d), main_rec["want"],
                                0.0 if bool(rnn.rnn_want(p, seq)) == bool(rnn.rnn_want_plain(p, seq_d)) else 1.0)
    shape, n = coal_rec["chains"].most_common(1)[0]
    params, pre, post, lab, fb, lg, dg, fg = coal_rec["chain_args"][shape]
    lg, dg, fg = (np.asarray(g, bool) for g in (lg, dg, fg))
    gates = (lg * rnn.LEARN | (dg & ~fg) * rnn.DECIDE | fg * rnn.FALLBACK).tolist()
    got, want = (f(params, pre, post, lab, fb, lg, dg, fg, RNN_LR)[0] for f in (rnn.rnn_chain, rnn.rnn_chain_plain))
    row["chain"] = _rnn_timing("phase 3d's most frequent chain", shape[1], gates,
                               lambda: rnn.rnn_chain(params, pre, post, lab, fb, lg, dg, fg, RNN_LR),
                               lambda: rnn.rnn_chain_plain(params, pre, post, lab, fb, lg, dg, fg, RNN_LR), n,
                               max(float((got[k] - want[k]).abs().max()) for k in want), iters=50)
    row["chain"]["gates"] = {"learn": int(lg.sum()), "decide": int((dg & ~fg).sum()), "fallback": int(fg.sum())}
    windows, labels = pretrain_windows(0)
    learn = np.ones(len(labels), bool)
    row["pretraining"] = _rnn_timing(
        "the pretraining", 10, [rnn.LEARN] * len(labels),
        lambda: rnn.rnn_chain(p, windows, None, labels, None, learn, ~learn, ~learn, RNN_PRETRAIN_LR), None,
        sum(main_rec["pretrain_launches"]), rnn_check["pretrain_gap"], iters=2, plain_iters=None)
    row["pretraining"]["plain_wall_ms"] = 1e3 * rnn_check["pretrain_plain_s"]
    row["pretraining"]["max_abs_err_is"] = "the largest relative leaf gap to the plain pretraining (phase 2)"
    return row


def _allowed_pairs(Sq: int, Sk: int) -> int:
    """(q, k) pairs a causal mask allows (q_pos0 = 0, no window)."""
    from repro_torch.kernels.flash_attention import attention_mask

    return int(attention_mask(Sq, Sk, causal=True, window=None, q_pos0=0, device="cpu").sum())


def _measure(fn, plain, lib, iters: int) -> dict:
    return {
        "ms": device_ms(fn, iters), "plain_ms": device_ms(plain, iters),
        "library_ms": None if lib is None else device_ms(lib, iters),
        "call_ms": call_ms(fn, iters, 3), "plain_call_ms": call_ms(plain, iters, 3),
        "library_call_ms": None if lib is None else call_ms(lib, iters, 3),
    }


def lm_kernel_timings(shape, g) -> dict[str, dict]:
    """The flash forward and backward and ``pairwise_l1`` at one LM shape
    ``(B, H, Sq, hd, KV, Sk, dv)`` (causal, as the LM path calls them).
    ``library_ms``: fp32 ``scaled_dot_product_attention`` (GQA) and its
    autograd backward, a yardstick the port never calls; ``pairwise_l1``'s
    is ``torch.cdist(x, x, p=1)`` over B delta rows of the width the shape's
    model gives."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import ops

    B, H, Sq, hd, KV, Sk, dv = shape
    q, k, v, do = flash_inputs(g, B, H, KV, Sq, Sk, hd, dv)
    pairs = B * H * _allowed_pairs(Sq, Sk)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o, lse = ops.flash_attention_with_lse(q, k, v)
    o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v)
    iters = 50 if pairs * hd < 1e9 else 20
    out = {}
    fwd = _measure(lambda: ops.flash_attention_with_lse(q, k, v), lambda: F.flash_attention_with_lse_plain(q, k, v),
                   lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), iters)
    fwd.update(bound_pair(4 * (q.numel() + k.numel() + v.numel() + o.numel() + lse.numel()), 2 * (hd + dv) * pairs,
                          split_tf32=True),
               max_abs_err=max((o - o_p).abs().max().item(), (lse - lse_p).abs().max().item()))
    out["flash_attention_fwd"] = fwd
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o_lib = sdpa(qr, kr, vr, is_causal=True, enable_gqa=True)
    bwd = _measure(lambda: FB.flash_attention_bwd(q, k, v, o, lse, do),
                   lambda: FB.flash_attention_bwd_plain(q, k, v, o, lse, do),
                   lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do, retain_graph=True), iters)
    got, want = FB.flash_attention_bwd(q, k, v, o, lse, do), FB.flash_attention_bwd_plain(q, k, v, o, lse, do)
    nbytes = 4 * (2 * (q.numel() + k.numel() + v.numel()) + o.numel() + lse.numel() + do.numel())
    bwd.update(bound_pair(nbytes, 2 * (3 * hd + 2 * dv) * pairs, split_tf32=True),
               max_abs_err=max((a - b).abs().max().item() for a, b in zip(got, want)))
    out["flash_attention_bwd"] = bwd
    return out


def pairwise_timings(m: int, n: int, g) -> dict:
    from repro_torch.kernels import l1, ops

    x = randn(g, m, n)
    row = _measure(lambda: ops.pairwise_l1(x), lambda: l1.pairwise_l1_plain(x),
                   lambda: torch.cdist(x, x, p=1), 50)
    row.update(bound_pair(4 * (m * n + m * m), 3 * m * m * n),
               max_abs_err=(ops.pairwise_l1(x) - l1.pairwise_l1_plain(x)).abs().max().item())
    return row


def bound_pair(nbytes: float, flops: float, split_tf32: bool = False) -> dict:
    """``bound_ms`` at fp32 on the CUDA cores; with ``split_tf32`` also
    ``bound_tc_ms``: three TF32 tensor-core products per fp32 product."""
    ms, by = bound(nbytes, flops)
    out = {"bound_ms": ms, "bound_by": by}
    if split_tf32:
        out["bound_tc_ms"] = max(nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS_PER_S) * 1e3
    return out


def lm_timing(tiny, full, cohort) -> list[dict]:
    """Rows for the flash kernels and ``pairwise_l1``: the numbers at the
    full-width ``llama3.2-1b`` shape, with the ``tiny_lm`` shape's beside
    them under ``"tiny_lm"`` and, for the flash kernels, phase 3f's cohort
    shape under ``"llama3.2-1b cohort"`` (``launches`` there: the FedAvg
    run's, ``launches_at_shape``: its forward launches at that shape);
    ``launches`` are the full-width run's."""
    g = gen(13)
    tiny_shape = tiny["shapes"].most_common(1)[0][0]
    full_shape = full["shapes"].most_common(1)[0][0]
    per_shape = {}
    for label, shape, width in (("tiny_lm", tiny_shape, 2304), ("llama3.2-1b", full_shape, 783360)):
        per_shape[label] = lm_kernel_timings(shape, g)
        m = 8 if label == "tiny_lm" else 4  # delta rows: one per client of the run
        per_shape[label]["pairwise_l1"] = pairwise_timings(m, width, g)
        per_shape[label]["shapes"] = {"flash": list(shape), "pairwise_l1": [m, width]}
    per_shape["cohort"] = lm_kernel_timings(COHORT_FLASH, g)
    rows = []
    # launch counter of each row (dq and dkv launch in pairs, checked in lm_run)
    counter = {"pairwise_l1": "pairwise_l1", "flash_attention_fwd": "flash_attention_fwd",
               "flash_attention_bwd": "flash_attention_dq"}
    for name in ("pairwise_l1", "flash_attention_fwd", "flash_attention_bwd"):
        source, replaces = KERNELS[name]
        key = "pairwise_l1" if name == "pairwise_l1" else "flash"
        small = dict(per_shape["tiny_lm"][name], shape=per_shape["tiny_lm"]["shapes"][key],
                     launches=tiny["counts"][counter[name]])
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": full["counts"][counter[name]], **per_shape["llama3.2-1b"][name],
               "shape": per_shape["llama3.2-1b"]["shapes"][key], "tiny_lm": small}
        rows.append(row)
        shown = [("llama3.2-1b", row), ("tiny_lm", small)]
        if key == "flash":
            row["llama3.2-1b cohort"] = dict(per_shape["cohort"][name], shape=list(COHORT_FLASH),
                                             launches=cohort["counts"][counter[name]],
                                             launches_at_shape=cohort["shapes"][COHORT_FLASH])
            shown.append(("llama3.2-1b cohort", row["llama3.2-1b cohort"]))
        for label, r in shown:
            tc = f", split-TF32 tensor-core bound {r['bound_tc_ms']:.6f} ms" if "bound_tc_ms" in r else ""
            print(f"timing {name} at {label} {tuple(r['shape'])}: device time kernel {r['ms']:.5f} ms, plain "
                  f"{r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms; bound {r['bound_ms']:.6f} ms "
                  f"({r['bound_by']}){tc}; per call kernel {r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms, "
                  f"library {r['library_call_ms']:.4f} ms; launches {r['launches']}; "
                  f"max_abs_err {r['max_abs_err']:.3g}")
    return rows


def gemma_flash_timing(serving: dict) -> dict:
    """The flash forward at phase 3j's two prefill shapes (gemma2-2b: 8
    heads over 4, head width 256, causal, softcap 50, scale 1/16; the
    global layers' case, no window): device time, the plain version's, the
    bound ``2 (hd + dv)`` flops a causal pair (fp32 on the CUDA cores, and
    split TF32 on the tensor cores) and the launches at that shape in phase
    3j. No library call: ``scaled_dot_product_attention`` has no logit
    softcap."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import ops

    g = gen(17)
    opts = GEMMA_PREFILL
    out = {}
    for label, kw in SERVE_CASES.items():
        B, Sq = kw["batch"], kw["prompt"]
        shape = (B, 8, Sq, 256, 4, Sq, 256)
        q, k, v, _ = flash_inputs(g, B, 8, 4, Sq, Sq, 256, 256)
        o, lse = ops.flash_attention_with_lse(q, k, v, **opts)
        o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v, **opts)
        torch.testing.assert_close(o, o_p, rtol=1e-5, atol=1e-5, msg=lambda m: f"gemma2-2b prefill {label} o: {m}")
        torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"gemma2-2b prefill {label} lse: {m}")
        iters = 20
        row = {"ms": device_ms(lambda: ops.flash_attention_with_lse(q, k, v, **opts), iters),
               "plain_ms": device_ms(lambda: F.flash_attention_with_lse_plain(q, k, v, **opts), 5),
               "library_ms": None, "call_ms": call_ms(lambda: ops.flash_attention_with_lse(q, k, v, **opts), iters, 3)}
        pairs = B * 8 * _allowed_pairs(Sq, Sq)
        row.update(bound_pair(4 * (q.numel() + k.numel() + v.numel() + o.numel() + lse.numel()),
                              2 * (256 + 256) * pairs, split_tf32=True),
                   max_abs_err=max((o - o_p).abs().max().item(), (lse - lse_p).abs().max().item()),
                   shape=list(shape), launches=serving["flash_shapes"][shape], opts="causal, softcap 50, scale 1/16")
        out[f"gemma2-2b prefill {label}"] = row
        print(f"timing flash_attention_fwd at gemma2-2b prefill {label} {shape}: device time kernel {row['ms']:.5f} ms, "
              f"plain {row['plain_ms']:.5f} ms, library none (SDPA has no softcap); bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}), split-TF32 tensor-core bound {row['bound_tc_ms']:.6f} ms; per call kernel "
              f"{row['call_ms']:.4f} ms; launches at this shape in phase 3j {row['launches']}; "
              f"max_abs_err {row['max_abs_err']:.3g}")
        del q, k, v, o, lse, o_p, lse_p
        torch.cuda.empty_cache()
    return out


def mla_flash_timing(zoo: dict) -> dict:
    """The flash forward at phase 3k's MLA prefill shape (deepseek-v2-lite-16b:
    16 heads, head width 192 in the 256 bucket, value width 128, causal,
    scale 192 ** -0.5), with the launches at that shape in phase 3k
    (``mla_fwd_timing``)."""
    B, H, KV, Sq, Sk, hd, dv = MLA_PREFILL
    key = (B, H, Sq, hd, KV, Sk, dv)
    return {"deepseek-v2-lite-16b MLA prefill": mla_fwd_timing(MLA_PREFILL, zoo["flash_shapes"][key],
                                                               "deepseek-v2-lite-16b MLA prefill", "phase 3k", gen(19))}


def mla_fwd_timing(shape: tuple, launches: int, label: str, phase: str, g) -> dict:
    """The flash forward at an MLA shape ``(B, H, KV, Sq, Sk, hd, dv)``
    (causal, scale 192 ** -0.5): device time, the plain version's, the bound
    ``2 (hd + dv)`` flops a causal pair (fp32 on the CUDA cores, and split
    TF32 on the tensor cores) and ``launches``. The library call is fp32
    ``scaled_dot_product_attention`` with the same scale, where it takes a
    value width other than the head width (else none, with the reason)."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import ops

    B, H, KV, Sq, Sk, hd, dv = shape
    q, k, v, _ = flash_inputs(g, B, H, KV, Sq, Sk, hd, dv)
    o, lse = ops.flash_attention_with_lse(q, k, v, **MLA_OPTS)
    o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v, **MLA_OPTS)
    torch.testing.assert_close(o, o_p, rtol=1e-5, atol=1e-5, msg=lambda m: f"{label} o: {m}")
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5, msg=lambda m: f"{label} lse: {m}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib, lib_note = (lambda: sdpa(q, k, v, is_causal=True, scale=MLA_OPTS["scale"])), "fp32 SDPA, dv != hd"
    try:
        torch.testing.assert_close(lib(), o_p, rtol=1e-4, atol=1e-4)
    except (RuntimeError, AssertionError) as e:  # the library call is a yardstick only: record why it has none
        lib, lib_note = None, f"none: SDPA {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    iters = 20
    row = {"ms": device_ms(lambda: ops.flash_attention_with_lse(q, k, v, **MLA_OPTS), iters),
           "plain_ms": device_ms(lambda: F.flash_attention_with_lse_plain(q, k, v, **MLA_OPTS), 5),
           "library_ms": None if lib is None else device_ms(lib, iters), "library": lib_note,
           "call_ms": call_ms(lambda: ops.flash_attention_with_lse(q, k, v, **MLA_OPTS), iters, 3)}
    pairs = B * H * _allowed_pairs(Sq, Sk)
    key = (B, H, Sq, hd, KV, Sk, dv)
    row.update(bound_pair(4 * (q.numel() + k.numel() + v.numel() + o.numel() + lse.numel()), 2 * (hd + dv) * pairs,
                          split_tf32=True),
               max_abs_err=max((o - o_p).abs().max().item(), (lse - lse_p).abs().max().item()),
               shape=list(key), launches=launches, opts="causal, scale 192 ** -0.5, hd 192, dv 128")
    lib_ms = "none" if row["library_ms"] is None else f"{row['library_ms']:.5f} ms"
    print(f"timing flash_attention_fwd at {label} {key}: device time kernel {row['ms']:.5f} ms, "
          f"plain {row['plain_ms']:.5f} ms, library {lib_ms} ({lib_note}); bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']}), split-TF32 tensor-core bound {row['bound_tc_ms']:.6f} ms; per call kernel "
          f"{row['call_ms']:.4f} ms; launches at this shape in {phase} {row['launches']}; "
          f"max_abs_err {row['max_abs_err']:.3g}")
    del q, k, v, o, lse, o_p, lse_p
    torch.cuda.empty_cache()
    return row


def zoo_mesh_flash_timing(zoo_mesh: dict) -> dict:
    """The flash kernels at phase 3o's per-shard shapes: the forward at
    deepseek-v2-lite-16b's MLA pod shard (one row, one head; ``mla_fwd_timing``),
    forward and backward at granite-moe-3b-a800m's batch shard (24 heads over
    8 KV, ``lm_kernel_timings``); launches: phase 3o's (a prefill's of the
    capacity arm; the training's, the backward's dq's)."""
    out = {"flash_attention_fwd": {}, "flash_attention_bwd": {}}
    g = gen(31)
    ds = zoo_mesh["deepseek"]
    out["flash_attention_fwd"]["deepseek-v2-lite-16b pod prefill shard"] = mla_fwd_timing(
        MLA_SHARD, ds["capacity"]["flash_prefill"], "deepseek-v2-lite-16b pod prefill shard", "a phase 3o prefill", g)
    gr = zoo_mesh["granite"]
    shape = tuple(gr["shard_shape"])
    rows = lm_kernel_timings(shape, g)
    for name, counter in (("flash_attention_fwd", "flash_attention_fwd"), ("flash_attention_bwd", "flash_attention_dq")):
        r = dict(rows[name], shape=list(shape), launches=gr["launches"][counter])
        out[name]["granite-moe-3b-a800m pod train shard"] = r
        print(f"timing {name} at granite-moe-3b-a800m pod train shard {shape}: device time kernel {r['ms']:.5f} ms, "
              f"plain {r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms; bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}); per call kernel {r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms, "
              f"library {r['library_call_ms']:.4f} ms; launches in phase 3o {r['launches']}; "
              f"max_abs_err {r['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return out


def train_flash_timing(training: dict) -> dict:
    """The flash forward and backward at phase 3l's shape (TRAIN_FLASH:
    llama3.2-1b at 2 x 4,096, causal), as ``lm_kernel_timings`` times the LM
    shapes: device time, the plain version's, fp32 SDPA's forward and
    autograd backward, the bounds ``2 (hd + dv)`` and ``2 (3 hd + 2 dv)``
    flops a causal pair (fp32 on the CUDA cores, and split TF32 on the
    tensor cores); launches: phase 3l's 8 steps (the backward's: dq's)."""
    rows = lm_kernel_timings(TRAIN_FLASH, gen(23))
    counts = training["full"]["launches"]
    out = {}
    for name, counter in (("flash_attention_fwd", "flash_attention_fwd"), ("flash_attention_bwd", "flash_attention_dq")):
        r = dict(rows[name], shape=list(TRAIN_FLASH), launches=counts[counter])
        out[name] = {"llama3.2-1b train": r}
        print(f"timing {name} at llama3.2-1b train {TRAIN_FLASH}: device time kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms; bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), split-TF32 tensor-core bound {r['bound_tc_ms']:.6f} ms; per call kernel "
              f"{r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms, library {r['library_call_ms']:.4f} ms; "
              f"launches in phase 3l {r['launches']}; max_abs_err {r['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return out


def mesh_flash_timing(meshes: dict) -> dict:
    """The flash forward and backward at phase 3n's per-shard shapes (one
    batch shard's row, 2 query heads over 1 KV head), as
    ``lm_kernel_timings`` times the LM shapes: the forward at the serving
    prefill's shard and both at the training step's; launches: phase 3n's
    (the backward's: dq's)."""
    out = {"flash_attention_fwd": {}, "flash_attention_bwd": {}}
    g = gen(29)
    for label, part, names in (("llama3.2-1b pod prefill shard", "serve", ("flash_attention_fwd",)),
                               ("llama3.2-1b pod train shard", "train", ("flash_attention_fwd", "flash_attention_bwd"))):
        shape = tuple(meshes[part]["shard_shape"])
        rows = lm_kernel_timings(shape, g)
        for name in names:
            if part == "serve":
                launches = meshes["serve"]["flash_prefill"]
            else:
                launches = meshes["train"]["launches"]["flash_attention_fwd" if name.endswith("fwd") else
                                                        "flash_attention_dq"]
            r = dict(rows[name], shape=list(shape), launches=launches)
            out[name][label] = r
            print(f"timing {name} at {label} {shape}: device time kernel {r['ms']:.5f} ms, plain "
                  f"{r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms; bound {r['bound_ms']:.6f} ms "
                  f"({r['bound_by']}); per call kernel {r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms, "
                  f"library {r['library_call_ms']:.4f} ms; launches in phase 3n {launches}; "
                  f"max_abs_err {r['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 6
# ------------------------------------------------------- phase 5: bf16 rows
# the bf16 instantiations (the reference's kernel bodies cast bf16 inputs to fp32): their tolerance against
# the plain version on the same bf16 inputs, as stated in tests/test_torch_bf16_kernels.py; the L1 and flash
# ones are the reference's own bf16 tolerances (tests/test_kernels.py:14, :69)
BF16_TOL = {
    "l1_distance": "rtol 3e-3", "l1_distance_pairwise": "rtol 3e-3", "pairwise_l1": "rtol 3e-3",
    "assign_and_lerp": "distances rtol 3e-3, index equal, blended row bit for bit",
    "chi2_feedback": "rtol 1e-5, atol 1e-6", "chi2_feedback_segmented": "rtol 1e-5, atol 1e-6 (sums atol 1e-5)",
    "merge_attention": "bit for bit",
    "flash_attention_fwd": "o within one bf16 ulp or 1e-5, lse atol = rtol = 1e-5; both within 2e-2",
    "flash_attention_bwd": "dq, dk, dv within one bf16 ulp or 1e-5; within 2e-2",
}
BF16_SERVER = ("l1_distance", "l1_distance_pairwise", "assign_and_lerp", "chi2_feedback", "chi2_feedback_segmented",
               "merge_attention")
BF16_STEP = dict(periods=2, batch=2, seq=512)  # phase 5's bf16 train step: llama3.2-1b at full width, 2 periods
BF16_FLASH = (2, 32, 512, 64, 8, 512, 64)  # (B, H, Sq, hd, KV, Sk, dv): its flash launches
BF16_FLASH_4K = (2, 32, 4096, 64, 8, 4096, 64)  # the reference's train_4k attention at bf16: timed only
BF16_PAIRWISE = (4, 783360)  # pairwise_l1 at the full-width LM delta rows


def _bf16_server_inputs(name: str, shape: tuple, g) -> tuple:
    """Random bf16 inputs of one server kernel at one shape (``_server_case``'s shapes)."""
    bf = torch.bfloat16
    if name in ("l1_distance", "l1_distance_pairwise"):
        m, c, n = shape
        xs, cs = randn(g, m, n).to(bf), randn(g, c, n).to(bf)
        return (xs[0].contiguous(), cs) if name == "l1_distance" else (xs, cs)
    if name == "assign_and_lerp":
        c, n = shape
        return randn(g, n).to(bf), randn(g, c, n).to(bf)
    if name in ("chi2_feedback", "chi2_feedback_segmented"):
        m, j = shape[:2]
        fp = (torch.rand((m, j), generator=g, device=DEVICE) * 30).to(bf)
        ft = (torch.rand((m, j), generator=g, device=DEVICE) * 30 + 1.0).to(bf)
        ss = torch.softmax(randn(g, m, j), dim=-1).to(bf)
        if name == "chi2_feedback":
            return fp, ft, ss
        return fp, ft, ss, torch.arange(m, device=DEVICE, dtype=torch.int32) % shape[2], shape[2]
    (n,) = shape
    return randn(g, n).to(bf), randn(g, n).to(bf), randn(g, n).to(bf)


def _server_flops(name: str, shape: tuple) -> float:
    """The operations of one server kernel call at ``shape``, as the fp32 rows
    count them (``_server_case``)."""
    if name in ("l1_distance", "l1_distance_pairwise"):
        m, c, n = shape
        return 3 * m * c * n
    if name == "pairwise_l1":
        m, n = shape
        return 3 * m * m * n
    if name == "assign_and_lerp":
        c, n = shape
        return 3 * c * n + c + 3 * n
    if name.startswith("chi2"):
        return 9 * shape[0] * shape[1] + (shape[0] if name.endswith("segmented") else 0)
    return 10 * shape[0]


def _bf16_call(name: str):
    from repro_torch.kernels import assign_lerp, chi2, l1, merge, ops

    kernel = {"l1_distance": ops.l1_distance, "l1_distance_pairwise": ops.l1_distance_pairwise,
              "assign_and_lerp": lambda u, c: ops.assign_and_lerp(u, c, 0.25), "chi2_feedback": ops.chi2_feedback,
              "chi2_feedback_segmented": ops.chi2_feedback_segmented, "merge_attention": ops.merge_attention,
              "pairwise_l1": ops.pairwise_l1}[name]
    plain = {"l1_distance": l1.l1_distance_plain, "l1_distance_pairwise": l1.l1_distance_pairwise_plain,
             "assign_and_lerp": lambda u, c: assign_lerp.assign_and_lerp_plain(u, c, 0.25),
             "chi2_feedback": chi2.chi2_feedback_plain, "chi2_feedback_segmented": chi2.chi2_feedback_segmented_plain,
             "merge_attention": lambda *a: merge.merge_attention_plain(*a)[0],
             "pairwise_l1": l1.pairwise_l1_plain}[name]
    return kernel, plain


def _bf16_check(name: str, args: tuple) -> float:
    """The bf16 instantiation against its plain version at BF16_TOL, and (but
    the merge and flash, whose output is bf16) bit for bit against the fp32
    kernel on the inputs cast to fp32: it is that kernel on converted loads.
    Returns the largest absolute difference to the plain version."""
    kernel, plain = _bf16_call(name)
    got, want = kernel(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if name == "assign_and_lerp":
        torch.testing.assert_close(got[0], want[0], rtol=3e-3, atol=0, msg=lambda m: f"bf16 {name}: {m}")
        check(int(got[1]) == int(want[1]) and torch.equal(got[2], want[2]), f"bf16 {name}: index or blend differs")
    elif name == "merge_attention":
        check(got[0].dtype == torch.bfloat16 and torch.equal(got[0].view(torch.int16), want[0].view(torch.int16)),
              f"bf16 {name}: not the plain version bit for bit")
    else:
        rtol, atol = (1e-5, 1e-6) if name.startswith("chi2") else (3e-3, 0.0)
        for i, (a, b) in enumerate(zip(got, want)):
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol if i == 0 else 1e-5,
                                       msg=lambda m: f"bf16 {name}: {m}")
    if name != "merge_attention":
        f32 = kernel(*(a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a for a in args))
        f32 = f32 if isinstance(f32, tuple) else (f32,)
        check(all(torch.equal(a, b) for a, b in zip(got, f32)),
              f"bf16 {name}: not the fp32 kernel's bits on the inputs cast to fp32")
    return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want) if a.is_floating_point())


def bf16_drive(shapes) -> dict:
    """Phase 5's bf16 path, every bf16 launch counter zeroed just before and
    read just after: (a) llama3.2-1b at full width, depth cut to 2 periods,
    its params drawn at bf16 (``init_params(dtype=)``), one train step
    through ``launch.train.train`` at 2 x 512 (the flash forward, dq and dkv
    at bf16); (b) the server's kernel calls of one upload and one refine at
    the main path's shapes, and ``pairwise_l1`` at the full-width delta
    rows, on bf16 rows (no path of the system holds bf16 plane rows: the
    reference's planes are fp32 too). Each bf16 instantiation must launch,
    and the step's loss be finite."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as driver
    from repro_torch.models.model import init_params

    cfg = get_config("llama3.2-1b")
    cfg = dataclasses.replace(cfg, num_periods=BF16_STEP["periods"])
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE, dtype=torch.bfloat16)
    g = gen(29)
    calls = [(name, _bf16_server_inputs(name, shapes[name].most_common(1)[0][0], g)) for name in BF16_SERVER]
    calls.append(("pairwise_l1", (randn(g, *BF16_PAIRWISE).to(torch.bfloat16),)))
    sync()
    ops.reset_launch_counts()
    r = driver.train(cfg, steps=1, batch=BF16_STEP["batch"], seq=BF16_STEP["seq"], device=DEVICE, params=params,
                     verbose=False)
    for name, args in calls:
        _bf16_call(name)[0](*args)
    sync()
    counts = ops.launch_counts_bf16()
    check(all(counts[k] > 0 for k in counts), f"phase 5 bf16 path: a bf16 instantiation never launched: {counts}")
    check(math.isfinite(r["losses"][0]), f"phase 5 bf16 step: loss {r['losses'][0]}")
    check(sum(ops.launch_counts().values()) == 0, f"phase 5 bf16 path launched fp32 kernels: {ops.launch_counts()}")
    print(f"phase 5 bf16 path: llama3.2-1b full width, {BF16_STEP['periods']} periods, bf16 params, one train step "
          f"at {BF16_STEP['batch']} x {BF16_STEP['seq']}: loss {r['losses'][0]:.4f}, {r['step_s'][0]:.3f} s; server "
          f"calls on bf16 rows; bf16 launches {json.dumps(counts)}")
    del r, params
    torch.cuda.empty_cache()
    return counts


def bf16_rows(shapes, counts) -> list[dict]:
    """A row a bf16 instantiation, beside the fp32 rows: checked against
    its plain version (BF16_TOL) and the fp32 kernel, then timed at the
    shapes the fp32 rows use (the server kernels at the main path's,
    ``pairwise_l1`` at the full-width delta's). ``bound_ms``: 2 bytes an
    input element, outputs at their dtype; operations at the fp32 CUDA-core
    rate for the server kernels and at the bf16 tensor-core peak for flash.
    ``library_ms``: ``torch.cdist`` on the bf16 rows for L1 (None if it
    refuses bf16), bf16 SDPA and its autograd backward for flash; ``fp32_ms``: the fp32 kernel on the inputs
    cast to fp32, in the same call; ``launches``: :func:`bf16_drive`'s; then
    the flash rows (:func:`bf16_flash_rows`)."""
    g = gen(31)
    rows = []
    for name in BF16_SERVER + ("pairwise_l1",):
        shape = BF16_PAIRWISE if name == "pairwise_l1" else shapes[name].most_common(1)[0][0]
        args = (randn(g, *shape).to(torch.bfloat16),) if name == "pairwise_l1" else _bf16_server_inputs(name, shape, g)
        err = _bf16_check(name, args)
        kernel, plain = _bf16_call(name)
        lib = None
        if name in ("l1_distance", "l1_distance_pairwise", "pairwise_l1"):
            x = args[0][None] if name == "l1_distance" else args[0]
            y = args[0] if name == "pairwise_l1" else args[1]
            try:
                torch.cdist(x, y, p=1)
                lib = lambda x=x, y=y: torch.cdist(x, y, p=1)  # noqa: E731
            except RuntimeError as e:
                print(f"  torch.cdist refuses bf16 rows: {str(e).splitlines()[0]}")
        outs = kernel(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs) if isinstance(t, torch.Tensor))
        t_b, t_o = nbytes / HBM_BYTES_PER_S, _server_flops(name, shape) / FP32_FLOPS_PER_S
        src, replaces = KERNELS[name]
        cast = tuple(a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a for a in args)
        row = {"name": f"{name}[bf16]", "route": "cuda", "source": src, "replaces": replaces, "dtype": "bfloat16",
               "launches": counts[name], "launches_from": "phase 5's bf16 path", "max_abs_err": err,
               "tolerance": BF16_TOL[name], "ms": device_ms(lambda: kernel(*args)),
               "plain_ms": device_ms(lambda: plain(*args)), "bound_ms": max(t_b, t_o) * 1e3,
               "bound_by": "bytes" if t_b >= t_o else "operations",
               "library_ms": None if lib is None else device_ms(lib), "shape": list(shape),
               "fp32_ms": device_ms(lambda: kernel(*cast))}
        rows.append(row)
    rows += bf16_flash_rows(counts, g)
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms"
        print(f"timing {r['name']} at {tuple(r['shape'])}: device time kernel {r['ms']:.5f} ms (the fp32 kernel on "
              f"the rows cast: {r['fp32_ms']:.5f} ms), plain {r['plain_ms']:.5f} ms, library {lib}; bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}); launches "
              f"{r['launches']} (phase 5's bf16 path); max_abs_err {r['max_abs_err']:.3g} ({r['tolerance']})")
    return rows


def bf16_flash_rows(counts, g) -> list[dict]:
    """The bf16 flash forward and backward rows: checked against their plain
    versions at ``tests/torch_bf16_bounds.py``'s bounds (o and the gradients
    within one bf16 ulp or 1e-5, lse within 1e-5) and at the reference's
    2e-2, then timed at phase 5's step's shape and, timed only (no path
    launches it), at the reference's train_4k attention shape, each beside
    its plain version, bf16 SDPA (and its autograd backward) and the fp32
    kernel on the inputs cast to fp32, in the same call; the backward also
    as its parts, the ``D`` pre-pass, dq and dkv. ``resources``: registers,
    local and stack bytes (phase 1's ``cuobjdump``) and dynamic shared
    memory of the bucket's kernels (:data:`FLASH_BF16_RESOURCES`)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_bf16_bounds import LSE_TOL, REFERENCE_TOL, max_ulps, within_one_ulp

    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import ops

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for shape, iters in ((BF16_FLASH, 50), (BF16_FLASH_4K, 10)):
        B, H, Sq, hd, KV, Sk, dv = shape
        q, k, v, do = (t.to(torch.bfloat16) for t in flash_inputs(g, B, H, KV, Sq, Sk, hd, dv))
        check(F.bf16_copy_path(q, k, v, do) == "cp.async 16 B", f"bf16 flash at {shape}: 16-byte copies expected")
        pairs = B * H * _allowed_pairs(Sq, Sk)
        o, lse = ops.flash_attention_with_lse(q, k, v)
        o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v)
        check(o.dtype == torch.bfloat16 and lse.dtype == torch.float32, "bf16 flash forward: output dtypes")
        check(within_one_ulp(o, o_p), f"bf16 flash o at {shape}: not within one bf16 ulp or 1e-5 of the plain "
                                       f"version ({max_ulps(o, o_p):.3g} ulps)")
        torch.testing.assert_close(lse, lse_p, rtol=LSE_TOL, atol=LSE_TOL, msg=lambda m: f"bf16 flash lse: {m}")
        torch.testing.assert_close(o.float(), o_p.float(), rtol=REFERENCE_TOL, atol=REFERENCE_TOL,
                                   msg=lambda m: f"bf16 flash o: {m}")
        errs = {"o": (o.float() - o_p.float()).abs().max().item(), "lse": (lse - lse_p).abs().max().item()}
        ulps = {"o": max_ulps(o, o_p)}
        del o_p, lse_p
        got, want = FB.flash_attention_bwd(q, k, v, o, lse, do), FB.flash_attention_bwd_plain(q, k, v, o, lse, do)
        for a, b, part in zip(got, want, ("dq", "dk", "dv")):
            check(a.dtype == torch.bfloat16, f"bf16 flash {part}: dtype {a.dtype}")
            check(within_one_ulp(a, b), f"bf16 flash {part} at {shape}: not within one bf16 ulp or 1e-5 of the "
                                        f"plain version ({max_ulps(a, b):.3g} ulps)")
            torch.testing.assert_close(a.float(), b.float(), rtol=REFERENCE_TOL, atol=REFERENCE_TOL,
                                       msg=lambda m: f"bf16 flash {part}: {m}")
            errs[part], ulps[part] = (a.float() - b.float()).abs().max().item(), max_ulps(a, b)
        del got, want
        torch.cuda.empty_cache()
        dsum = FB._dsum(do, o)
        qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        o_lib = sdpa(qr, kr, vr, is_causal=True, enable_gqa=True)
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        o32, lse32 = ops.flash_attention_with_lse(q32, k32, v32)
        fwd_bytes = 2 * (q.numel() + k.numel() + v.numel() + o.numel()) + 4 * lse.numel()
        bwd_bytes = 2 * (2 * (q.numel() + k.numel() + v.numel()) + o.numel() + do.numel()) + 4 * lse.numel()
        timed = {
            "flash_attention_fwd": dict(
                fn=lambda: ops.flash_attention_with_lse(q, k, v), plain=lambda: F.flash_attention_with_lse_plain(q, k, v),
                lib=lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                fp32=lambda: ops.flash_attention_with_lse(q32, k32, v32), nbytes=fwd_bytes,
                flops=2 * (hd + dv) * pairs, err=max(errs["o"], errs["lse"]), ulps=ulps["o"], parts={}),
            "flash_attention_bwd": dict(
                fn=lambda: FB.flash_attention_bwd(q, k, v, o, lse, do),
                plain=lambda: FB.flash_attention_bwd_plain(q, k, v, o, lse, do),
                lib=lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do, retain_graph=True),
                fp32=lambda: FB.flash_attention_bwd(q32, k32, v32, o32, lse32, do32), nbytes=bwd_bytes,
                flops=2 * (3 * hd + 2 * dv) * pairs, err=max(errs["dq"], errs["dk"], errs["dv"]),
                ulps=max(ulps["dq"], ulps["dk"], ulps["dv"]),
                parts={"dsum_ms": lambda: FB._dsum(do, o), "dq_ms": lambda: FB.flash_attention_dq(q, k, v, do, lse, dsum),
                       "dkv_ms": lambda: FB.flash_attention_dkv(q, k, v, do, lse, dsum)}),
        }
        for name, t in timed.items():
            t_b, t_o = t["nbytes"] / HBM_BYTES_PER_S, t["flops"] / BF16_FLOPS_PER_S
            out = {"shape": list(shape), "max_abs_err": t["err"], "max_ulps_past_1e-5": t["ulps"],
                   "ms": device_ms(t["fn"], iters), "plain_ms": device_ms(t["plain"], iters),
                   "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
                   "library_ms": device_ms(t["lib"], iters), "fp32_ms": device_ms(t["fp32"], iters),
                   **{k: device_ms(fn, iters) for k, fn in t["parts"].items()}}
            if shape == BF16_FLASH:
                src, replaces = KERNELS[name]
                kinds = ("fwd",) if name.endswith("fwd") else ("dq", "dkv")
                rows[name] = {"name": f"{name}[bf16]", "route": "cuda", "source": src.replace(".cu", "_bf16.cu"),
                              "replaces": replaces, "dtype": "bfloat16",
                              "launches": counts["flash_attention_fwd" if name.endswith("fwd") else "flash_attention_dq"],
                              "launches_from": "phase 5's bf16 path", "tolerance": BF16_TOL[name],
                              "resources": {kind: FLASH_BF16_RESOURCES.get(f"flash_{kind}", {}).get(hd)
                                            for kind in kinds}, **out}
            else:
                rows[name]["at_4096"] = {**out, "launches": 0, "launches_from": "timed only: no path launches it"}
            print(f"timing {name}[bf16] at {shape}: device time kernel {out['ms']:.5f} ms "
                  + "".join(f"({k[:-3]} {out[k]:.5f} ms) " for k in t["parts"])
                  + f"(the fp32 kernel on the inputs cast {out['fp32_ms']:.5f} ms), plain {out['plain_ms']:.5f} ms, "
                  f"bf16 SDPA {out['library_ms']:.5f} ms; bound {out['bound_ms']:.6f} ms ({out['bound_by']}); max_abs_err "
                  f"{out['max_abs_err']:.3g}, {out['max_ulps_past_1e-5']:.3g} bf16 ulps past 1e-5")
        del q, k, v, do, o, lse, dsum, qr, kr, vr, o_lib, q32, k32, v32, do32, o32, lse32, timed
        torch.cuda.empty_cache()
    return list(rows.values())


def bf16_phase(shapes) -> list[dict]:
    """Phase 5's bf16 part: the path, then the rows."""
    counts = bf16_drive(shapes)
    return bf16_rows(shapes, counts)


def profile_window(label: str, run) -> None:
    """One run under ``torch.profiler`` (CUDA activity only). Device busy
    time is the sum of kernel durations (one stream, so they do not
    overlap); the idle share is the rest of the window's host wall time.
    ``run()`` returns the number of uploads it made. The trace's kernels of
    the assign and the flash forward, one per launch, are counted against
    their wrappers' launch counts: a trace that lost kernels shows there."""
    from repro_torch.kernels import ops

    def timed():
        t0 = time.perf_counter()
        uploads = run()
        sync()
        return uploads, time.perf_counter() - t0

    ops.reset_launch_counts()
    prof, (uploads, wall) = _device_trace(timed)
    launched = ops.launch_counts()
    events = _device_events(prof)
    per = _device_us(events)
    busy = sum(per.values()) / 1e6
    check(busy > 0, f"profile {label}: the profiler saw no device time")
    ours = sum(v for k, v in per.items() if any(n in k for n in PORT_KERNEL_NAMES)) / 1e6
    flash = sum(v for k, v in per.items() if "flash_" in k) / 1e6
    n_kernels = len(events)
    print(f"profile ({label}, {uploads} uploads): wall {wall:.3f} s under the profiler, device busy {busy:.4f} s, "
          f"idle share {1 - busy / wall:.4f}, {n_kernels} kernels; the port's CUDA kernels {ours:.5f} s "
          f"({100 * ours / busy:.2f}% of busy), of which flash attention {flash:.5f} s ({100 * flash / busy:.2f}%)")
    seen = Counter(e.name for e in events)
    print("  kernels in the trace / launched: " + ", ".join(
        f"{kernel} {sum(v for k, v in seen.items() if kernel in k)}/{launched[wrapper]}"
        for kernel, wrapper in (("assign_lerp_kernel", "assign_and_lerp"), ("ingest_chain_kernel", "ingest_chain"),
                                ("rnn_chain_kernel", "rnn_chain"), ("uplink_topk", "uplink_topk_encode"),
                                ("flash_fwd_kernel", "flash_attention_fwd"))))
    for name, us in per.most_common(12):
        print(f"  device time {us / 1e3:10.3f} ms ({100 * us / 1e6 / busy:5.1f}%)  {name[:110]}")


def profiles(rnn_params: dict, lm_rnn_params: dict) -> None:
    """Steady-state windows, the broadcast RNN handed over so that its
    pretraining stays outside: the MLP main path (a 300 s image_recognition
    run), the coalesced path (its first 300 uploads), the tiny_lm LM run,
    the full-width llama3.2-1b LM run and phase 3f's full-width FedAvg run
    (the base drawn once, before the windows), phase 3g's EchoPFL top-k
    arm for its first 1,200 s, and phase 3h's coalesced guard-on defense
    arm at seed 0."""
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.fl.lm_task import run_lm_experiment

    def mlp():
        rep = run_experiment("image_recognition", "echopfl", num_clients=20, max_time=300, seed=0, device=DEVICE,
                             rnn_params=rnn_params)[3]
        return rep.extra["uploads"]

    def coalesced():
        rep = run_experiment("image_recognition", "echopfl", device=DEVICE, rnn_params=rnn_params,
                             **dict(COALESCED, max_uploads=300))[3]
        return rep.extra["uploads"]

    def tiny():
        rep = run_lm_experiment("echopfl", num_clients=8, max_time=900, eval_interval=120, seed=0, device=DEVICE,
                                rnn_params=lm_rnn_params)[3]
        return rep.extra["uploads"]

    def full():
        rep = run_lm_experiment("echopfl", num_clients=4, max_time=720, eval_interval=240, seq_len=256, n_train=4,
                                n_test=2, local_epochs=1, seed=0, device=DEVICE, task=task,
                                rnn_params=lm_rnn_params)[3]
        return rep.extra["uploads"]

    def full_sync():
        return run_lm_experiment("fedavg", device=DEVICE, task=task, **FULL_SYNC)[3].up_events

    def comm_topk():
        return run_experiment("har", "echopfl", device=DEVICE, rnn_params=rnn_params, uplink="topk",
                              **dict(COMM_SWEEP, max_time=1200.0))[3].up_events

    def defense():
        return chaos_run(DEFENSE_SWEEP["clients"], 0, DEFENSE_SWEEP["windows"]["coalesced"], DEFENSE_SWEEP["horizon"],
                         _fault_plan(0.0, poison=CHAOS_RATE), "on", rnn_params)["uploads"]

    profile_window("image_recognition, 20 clients, 300 s", mlp)
    profile_window("image_recognition coalesced, 128 clients, 45 s windows, 300 uploads", coalesced)
    profile_window("har comm sweep EchoPFL top-k, 20 clients, 45 s windows, 1200 s", comm_topk)
    profile_window("har defense, guard on, poison 0.1, 16 clients, 30 s windows, 1800 s, seed 0", defense)
    profile_window("tiny_lm LM run, 8 clients, 900 s", tiny)
    task = full_width_task()  # the base is drawn outside the windows
    profile_window("llama3.2-1b LM run, 4 clients, 720 s", full)
    profile_window("llama3.2-1b FedAvg, 4 clients, 3 rounds (cohorts of 16 sequences)", full_sync)
    del task
    torch.cuda.empty_cache()


# --------------------------------------------------------- side processes
def side_part(part: str, rnn_params: dict, lm_rnn_params: dict) -> dict:
    """One side process's phases, in order: phases 3e, 3g, 3h and 4 drive
    small tasks (``har``, ``image_recognition``, ``tiny_lm``, the reduced
    archs) that leave the card idle most of the time. Returns what the main
    run's later phases read."""
    t0 = time.perf_counter()

    def mark(label: str) -> None:
        print(f"[side {part}: {time.perf_counter() - t0:.1f} s] {label} done", flush=True)

    out = {}
    if part == "a":
        out["paper"] = paper_comparison(rnn_params)
        mark("paper_comparison")
        out["chaos"] = chaos_sweeps(rnn_params, ("faults",))
        mark("chaos_sweeps (faults)")
        init_np, rnn_np = agreement_inputs()
        agreement(init_np, rnn_np)
        mark("agreement")
        compressed_agreement(init_np, rnn_np)
        mark("compressed_agreement")
        baseline_agreement()
        mark("baseline_agreement")
        pytree_agreement(init_np, rnn_np)
        mark("pytree_agreement")
        restart_agreement(init_np, rnn_np)
        mark("restart_agreement")
    else:
        out["sweep"] = comm_sweep(rnn_params)
        mark("comm_sweep")
        out["per_event"] = per_event_encodes(rnn_params)
        mark("per_event_encodes")
        out["chaos"] = chaos_sweeps(rnn_params, ("defense",))
        mark("chaos_sweeps (defense)")
        init_np, rnn_np = agreement_inputs()
        chaos_agreement(init_np, rnn_np)
        mark("chaos_agreement")
        loop_agreement(init_np, rnn_np)
        mark("loop_agreement")
        lm_agreement(lm_rnn_params)
        mark("lm_agreement")
        serving_agreement(rnn_np)
        mark("serving_agreement")
        zoo_agreement()
        mark("zoo_agreement")
        training_agreement(rnn_np)
        mark("training_agreement")
    torch.cuda.empty_cache()
    return out


class SideRuns:
    """``side_part("a")`` and ``side_part("b")``, each in a process of its
    own on the same card, beside the main run's host-bound phases; joined
    before the phases that time or profile the device. Where the card does
    not take a second process (a compute mode other than Default), the
    parts run in this process at the join. The inputs, logs and results
    live in a directory under ``build/`` that ``close`` removes."""

    PARTS = ("a", "b")

    def __init__(self, rnn_params: dict, lm_rnn_params: dict):
        self.inputs = (rnn_params, lm_rnn_params)
        self.procs: dict = {}
        mode = sh("nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader").strip()
        self.inline = mode != "Default"
        (ROOT / "build").mkdir(exist_ok=True)
        self.dir = Path(tempfile.mkdtemp(prefix="chip_smoke_side_", dir=ROOT / "build"))
        if self.inline:
            print(f"side processes: compute mode {mode}; phases 3e, 3g, 3h and 4 run in this process at the join")
            return
        with open(self.dir / "inputs.pkl", "wb") as f:
            pickle.dump(self.inputs, f)
        for part in self.PARTS:
            with open(self.dir / f"{part}.log", "wb") as log:
                self.procs[part] = subprocess.Popen(
                    [sys.executable, "-u", str(ROOT / "chip_smoke.py"), "--side", part, str(self.dir)],
                    stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
        print(f"side processes: {', '.join(f'{k} (pid {p.pid})' for k, p in self.procs.items())} started")

    def join(self) -> dict:
        """Each part's result (through JSON, as from a side process); its
        log printed; a part that failed fails the run."""
        out, failed = {}, []
        for part in self.PARTS:
            if self.inline:
                out[part] = json.loads(json.dumps(side_part(part, *self.inputs)))
                continue
            rc = self.procs[part].wait()
            print(f"---- side process {part}: exit {rc} ----")
            print((self.dir / f"{part}.log").read_text(errors="replace"), end="", flush=True)
            if rc:
                failed.append(part)
            else:
                out[part] = json.loads((self.dir / f"{part}.json").read_text())
        self.close()
        check(not failed, f"side process {', '.join(failed)} failed")
        return out

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


# ------------------------------------------------------------------ phase 3p
# the dry-run's full-size cells on the pod mesh, each in a process of its own (tracing on meta is host
# work): llama3.2-1b's training shape and deepseek-v2-lite-16b's prefill; the first also predicts phase 3l's
# step (llama3.2-1b unmeshed, fp32, 2 x 4,096, remat)
DRYRUN_CELLS = {"llama": ("llama3.2-1b", "train_4k"), "deepseek": ("deepseek-v2-lite-16b", "prefill_32k")}


def dryrun_main(which: str, out_path: str) -> int:
    """A phase 3p process: the dry-run's record of one full-size cell
    (``launch.dryrun.run_cell``, bf16 on the pod mesh, ``meta`` tensors: no
    card), and for ``llama`` also phase 3l's step at fp32 unmeshed; written
    as JSON to ``out_path``. One intra-op thread."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    arch, shape = DRYRUN_CELLS[which]
    out = {"cell": dryrun.run_cell(arch, shape, False, None)}
    if which == "llama":
        step = ShapeSpec("phase 3l", TRAIN_FULL["seq"], TRAIN_FULL["batch"], "train")
        out["phase_3l"] = dryrun.run_cell("llama3.2-1b", step.name, False, None, cfg=get_config("llama3.2-1b"),
                                          shape=step, mesh=dryrun.meta_mesh((1, 1)), mesh_name="1x1",
                                          dtype=torch.float32)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


class DryRuns:
    """Phase 3p's processes (``chip_smoke.py --dryrun CELL OUT``), started
    at the run's start; ``join`` waits for them after phase 3l. They touch
    no card. ``close`` stops any that still runs."""

    def __init__(self):
        (ROOT / "build").mkdir(exist_ok=True)
        self.dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_", dir=ROOT / "build"))
        self.t0 = time.perf_counter()
        self.procs = {}
        for which in DRYRUN_CELLS:
            with open(self.dir / f"{which}.log", "wb") as log:
                self.procs[which] = subprocess.Popen(
                    [sys.executable, "-u", str(ROOT / "chip_smoke.py"), "--dryrun", which,
                     str(self.dir / f"{which}.json")], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)

    def join(self) -> dict:
        out, failed = {}, []
        for which, p in self.procs.items():
            rc = p.wait()
            if rc:
                failed.append(which)
                log = (self.dir / f"{which}.log").read_text(errors="replace")
                print(f"---- phase 3p {which}: exit {rc} ----\n{log}")
            else:
                out[which] = json.loads((self.dir / f"{which}.json").read_text())
        print(f"phase 3p processes joined {time.perf_counter() - self.t0:.1f} s after their start")
        self.close()
        check(not failed, f"phase 3p: dry-run process {', '.join(failed)} failed")
        return out

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def dryrun_phase(records: dict, training: dict) -> dict:
    """Phase 3p's checks and figures: both full-size cells traced (status
    OK) and printed; the predicted phase 3l step's state bytes equal to the
    bytes of the state phase 3l placed; its FLOPs a step beside phase 3l's
    measured seconds a step: the achieved FLOP/s and its share of the fp32
    (outside the tensor cores) and TF32 peaks."""
    out = {}
    for which, rec in records.items():
        cell = rec["cell"]
        check(cell["status"] == "OK", f"phase 3p: {cell['arch']} x {cell['shape']}: {cell.get('error')}")
        out[which] = {k: v for k, v in cell.items() if k != "traceback"}
        t = cell["roofline"]
        print(f"phase 3p dry-run {cell['arch']} x {cell['shape']} x {cell['mesh']} (bf16, meta, traced in "
              f"{cell['trace_s']} s): {cell['flops_per_device']:.6g} FLOPs ({cell['dot_flops_per_device']:.6g} in "
              f"products), {cell['bytes_per_device']:.6g} bytes, collectives {json.dumps(cell['collectives'])} a "
              f"device; state {cell['state_bytes_per_device']:.6g} B a device; model_flops {cell['model_flops']:.6g}, "
              f"ratio {cell['model_flops_ratio']:.4f}; H100 roofline compute {t['compute_s']:.6f} s, memory "
              f"{t['memory_s']:.6f} s, collective {t['collective_s']:.6f} s: {cell['bottleneck']}")
        print("phase 3p record: " + json.dumps(out[which]))
    pred, full = records["llama"]["phase_3l"], training["full"]
    check(pred["status"] == "OK", f"phase 3p: phase 3l's step: {pred.get('error')}")
    check(pred["state_bytes_per_device"] == full["state_bytes"],
          f"phase 3p: predicted state {pred['state_bytes_per_device']} B, phase 3l placed {full['state_bytes']} B")
    rate = pred["flops_per_device"] / full["steady_step_s"]
    out["phase_3l"] = {"flops": pred["flops_per_device"], "dot_flops": pred["dot_flops_per_device"],
                       "bytes": pred["bytes_per_device"], "state_bytes": pred["state_bytes_per_device"],
                       "step_s": full["steady_step_s"], "flops_per_s": rate,
                       "fp32_share": rate / FP32_FLOPS_PER_S, "tf32_share": rate / TF32_FLOPS_PER_S,
                       "roofline": pred["roofline"]}
    p = out["phase_3l"]
    print(f"phase 3p predicts phase 3l's step (llama3.2-1b, fp32, unmeshed, {TRAIN_FULL['batch']} x "
          f"{TRAIN_FULL['seq']}, remat): state {p['state_bytes']:.0f} B = the {full['state_bytes']} B phase 3l "
          f"placed; {p['flops']:.6g} FLOPs a step ({p['dot_flops']:.6g} in products) over phase 3l's "
          f"{p['step_s']:.3f} s a step: {rate / 1e12:.3f} TFLOP/s achieved, {100 * p['fp32_share']:.2f}% of the "
          f"fp32 peak and {100 * p['tf32_share']:.2f}% of the TF32 peak; predicted roofline compute "
          f"{p['roofline']['compute_s']:.4f} s, memory {p['roofline']['memory_s']:.4f} s (unfused bytes)")
    return out


def side_main(part: str, where: str) -> int:
    """A side process: ``side_part`` with the main run's inputs, its result
    written as JSON beside them. One intra-op thread: two side processes
    with a thread a core each beside the main run oversubscribe the host's
    cores many times over (phase 4's CPU runs took 4-14 x as long on the
    H100's host)."""
    torch.set_num_threads(1)
    with open(Path(where) / "inputs.pkl", "rb") as f:
        rnn_params, lm_rnn_params = pickle.load(f)
    out = side_part(part, rnn_params, lm_rnn_params)
    (Path(where) / f"{part}.json").write_text(json.dumps(out))
    return 0


# ``--phase NAME``: a model-mesh phase alone, with its flash rows (the phases that take no other phase's output)
def bf16_alone() -> dict:
    """Phase 5's bf16 part alone (``--phase bf16``): the main path for its
    shapes, then the bf16 path and rows."""
    _, shapes, _, _ = main_path()
    return {"rows": bf16_phase(shapes)}


PHASES = {"model_mesh": ("model_mesh_phase", "mesh_flash_timing"),
          "zoo_mesh": ("zoo_mesh_phase", "zoo_mesh_flash_timing"),
          "bf16": ("bf16_alone", "bf16_rows_of")}


def bf16_rows_of(out: dict) -> list:
    return out["rows"]


def one_phase(name: str) -> int:
    """The card, the kernels' build and the flash checks, then the phase
    ``PHASES[name]`` and its phase 5 rows; prints the seconds after each
    part and the phase's numbers as JSON, not the contract's lines. Exits
    non-zero on any failed check, as the whole smoke does."""
    t0 = time.perf_counter()
    probe()
    flash_checks()
    print(f"[{time.perf_counter() - t0:.1f} s] build and flash checks")
    phase, rows = (globals()[f] for f in PHASES[name])
    out = phase()
    print(f"[{time.perf_counter() - t0:.1f} s] {phase.__name__}")
    print(f"{name}: " + json.dumps(out))
    print("rows: " + json.dumps(rows(out)))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description="The port's main paths and kernels on one CUDA card.")
    parser.add_argument("--phase", choices=sorted(PHASES), help="run this phase alone (the model-mesh phases, "
                                                                 "phase 5's bf16 part)")
    parser.add_argument("--side", nargs=2, metavar=("PART", "DIR"),
                        help="run side process PART (a or b) with the inputs in DIR (the whole run starts these)")
    parser.add_argument("--dryrun", nargs=2, metavar=("CELL", "OUT"),
                        help="phase 3p: trace dry-run CELL (llama or deepseek) and write it to OUT (the whole run "
                             "starts these)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.common.device import resolve_device

    resolve_device("cuda")  # TF32 off, fp32 throughout
    if args.phase:
        return one_phase(args.phase)
    if args.side:
        return side_main(*args.side)
    if args.dryrun:
        return dryrun_main(*args.dryrun)
    t0 = time.perf_counter()

    def mark(label: str) -> None:
        print(f"[{time.perf_counter() - t0:.1f} s] {label} done", flush=True)

    smi = probe()
    mark("probe")
    dryruns = DryRuns()  # phase 3p, host work beside everything until after phase 3l
    atexit.register(dryruns.close)  # stopped whatever fails before the join
    rnn_check = kernel_phase()
    mark("kernel_phase")
    counts, shapes, _, rnn_params = main_path()
    mark("main_path")
    coal = coalesced_path(rnn_params)
    mark("coalesced_path")
    tiny = lm_path()
    mark("lm_path")
    sides = SideRuns(rnn_params, tiny["rnn"])
    try:
        # beside the side processes: the phases that neither time nor profile the device
        full = full_width(tiny["rnn"])
        mark("full_width")
        mesh = sharded_phase(rnn_params, tiny["rnn"], full, smi)
        mark("sharded_phase")
        cohort = full_width_sync()
        mark("full_width_sync")
        full_topk = full_width_topk(tiny["rnn"])
        mark("full_width_topk")
        meshes = model_mesh_phase()
        mark("model_mesh_phase")
        restart = restart_phase(rnn_params, tiny["rnn"])
        mark("restart_phase")
        side = sides.join()
    finally:
        sides.close()
    mark("side processes (phases 3e, 3g, 3h and 4)")
    paper, sweep, per_event = side["a"]["paper"], side["b"]["sweep"], side["b"]["per_event"]
    chaos = merge_chaos(side["a"]["chaos"], side["b"]["chaos"])
    serving = serving_phase(rnn_params)
    mark("serving_phase")
    zoo = zoo_serving_phase()
    mark("zoo_serving_phase")
    training = training_phase(rnn_params)
    mark("training_phase")
    try:
        dry = dryrun_phase(dryruns.join(), training)
    finally:
        dryruns.close()
    mark("dryrun_phase (phase 3p)")
    zoo_meshes = zoo_mesh_phase()
    mark("zoo_mesh_phase")
    rows = (timing(counts, shapes, full, tiny) + [chain_row(coal, chaos), rnn_row(counts, shapes, coal, rnn_check)]
            + uplink_rows(sweep, per_event, full_topk) + lm_timing(tiny, full, cohort))
    flash_row = next(r for r in rows if r["name"] == "flash_attention_fwd")
    flash_row.update(gemma_flash_timing(serving))
    flash_row.update(mla_flash_timing(zoo))
    for timed in (train_flash_timing(training), mesh_flash_timing(meshes), zoo_mesh_flash_timing(zoo_meshes)):
        for name, extra in timed.items():
            next(r for r in rows if r["name"] == name).update(extra)
    rows += bf16_phase(shapes)
    for row in rows:  # phase 3m's per-shard launches beside each row's own
        if row["name"] in mesh["rows"]:
            row["phase_3m"] = mesh["rows"][row["name"]]
    print(f"timing: {trace_sessions['kept']} profiler sessions kept, {trace_sessions['refused']} refused "
          f"(a partial or empty trace)")
    mark("timing")
    profiles(rnn_params, tiny["rnn"])
    mark("profiles")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print("paper comparison: " + json.dumps(paper))
    print("comm sweep: " + json.dumps(sweep))
    print("chaos sweeps: " + json.dumps(chaos))
    print("serving: " + json.dumps({k: v for k, v in serving.items()
                                    if k in SERVE_CASES or k in ("decode_profile", "pytree", "wall")}))
    print("zoo serving: " + json.dumps({k: v for k, v in zoo.items() if k != "flash_shapes"}))
    print("training: " + json.dumps({k: v for k, v in training.items() if k != "flash_shapes"}))
    print("sharded plane: " + json.dumps({k: v for k, v in mesh.items() if k != "rows"}))
    print("model meshes: " + json.dumps(meshes))
    print("zoo meshes: " + json.dumps(zoo_meshes))
    print("dry-run: " + json.dumps(dry))
    print("restart: " + json.dumps({k: {f: v[f] for f in ("saved", "spent", "at", "unsteady", "bytes", "leaves")
                                       if f in v} for k, v in restart.items()}))
    print(json.dumps({"kernels": rows}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
