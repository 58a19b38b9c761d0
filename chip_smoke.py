#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(``python3 chip_smoke.py --mesh-dryrun`` runs phase 19's dry runs alone
and prints them as one JSON line; ``python3 chip_smoke.py
--time-aggregation`` times only
``segment_aggregate``, ``cloud_aggregate``, ``weighted_mean`` and
``segment_sum`` and runs phase 6, through the wrappers alone; ``python3
chip_smoke.py --time-rounds`` times phase 3's warm sync round and phase
5's async updates alone.  Copied into an older tree, either times that
tree's code, so two trees compare on one card in one call.  ``python3
chip_smoke.py --probe-profiler`` counts, over 200 ``torch.profiler``
sessions in a fresh process, those that record no kernel of phase 2's 9
``segment_aggregate`` calls.)

Every phase prints its seconds (``phase N: x s``).

Phases, in order; any failure ends the run with a non-zero exit:

1. Device: the card's name and power limit, the CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` (build seconds; ptxas's registers and
   spills of every kernel; no spill in ``flash_attention``,
   ``flash_attention_bf16``, ``decode_attention``,
   ``decode_attention_bf16``, ``segment_sum``,
   ``segment_aggregate``, ``cloud_aggregate`` and ``weighted_mean``), TF32
   off.
2. Kernels against their plain PyTorch versions on the card, at the
   paths' shapes and at the edge cases; each kernel timed (CUDA events,
   median of 100 launches, L2 flushed before each) beside its plain
   version, one PyTorch library call (where one computes the same
   function) and its bound.  The four aggregation kernels also bit for
   bit between two launches (``segment_sum``: the chunk sum formed first,
   then added), on row views from an odd row, one kernel a call at every
   case's shape (each wrapper's ``launch_counts`` up by exactly one a
   call, and ``torch.profiler`` recording only its kernel, at most once a
   call, after a throwaway first session; a session that records no
   kernel is rerun, at most 3 times, each printed, and never passes);
   ``segment_aggregate`` and
   ``cloud_aggregate`` at phases 3 and 5's cohort (with each wrapper's
   host time a call and one call's device time, and with half and twice
   the warps rule's choice), ``segment_aggregate`` also at phase 9's
   slab, ``cloud_aggregate`` with all-zero weights (NaN, as the
   reference), ``segment_sum`` at the streaming chunk, the LeNet cohort
   and phase 13's merge chunk (20 rows, M=1; and with half and twice its
   rule's row slices at the streaming chunk).
   ``flash_attention`` at the prefill shapes of
   phases 7 and 8 and of the serving CLI (beside masked SDPA, SDPA with
   ``is_causal=True`` and with ``enable_gqa=True`` where there is no window;
   with every warps-per-block count, its rule's among them; its build must
   show no register spill),
   ``decode_attention`` at the decode shapes of phases 7 and 8 and of
   the serving CLI (beside masked SDPA on expanded heads and with
   ``enable_gqa=True``; with half and twice its rule's split count), and
   its bf16 kernel (``decode_attention_bf16``) on every case and at the
   bf16 paths' shapes (phases 17 (c) and 19 (b)) by the bf16 rule,
   ``weighted_mean`` at phase 9's
   slab and at a fleet-scale shard in fp32 and bf16, its tile counters
   back at 0 after every call (and the slab and the fleet shards with half
   and twice its plan's row slices and other splits).
3. The main path at full width: ``plan()`` on the paper's 5-edge,
   100-UE topology, then synchronous Algorithm 1 on full LeNet
   (``HFLSimulator(device="cuda")``) for 2 cloud rounds; each kernel's
   launch count over exactly that run must equal what the schedule needs.
   Then one warm round timed and one profiled (where the device time goes).
4. The card against the CPU: one cloud round from the same init on both,
   on edge 0's first 10 UEs at phase 3's (a*, b*), within SENSITIVITY_FACTOR
   times the CPU's spread there; then the full cohort's round on the card
   and its spread on the card (cuDNN's deterministic algorithms), phase
   5's references.
5. Async Algorithm 1 at full width (``mode="async"``, ``max_staleness=2``)
   for 2 rounds' delivery quota; launch counts against the departure waves
   of its event trace.  Then the ``max_staleness=0`` barrier against the
   card's sync round of phase 4, within phase 4's rule.
6. Streaming edge aggregation at the largest fleet of
   ``benchmarks/bench_scale.py``: 1,048,576 client rows x 1,024 columns
   folded in 8,192-row chunks made on the card (the 4 GiB buffer never
   exists), one ``segment_sum`` launch per chunk, against a float64
   accumulation of the same chunks; then 10 chunks profiled:
   ``segment_sum``'s device time on the path.
7. Serving at full width: RecurrentGemma-9B (38 layers, 8,532,381,696
   fp32 parameters from seed 0) through ``repro_torch.launch.serve``,
   B=2, a 4,096-token prompt (twice the 2,048 window) and 32 greedy
   tokens; then the same model step by step: 12 ``flash_attention`` and
   26 ``rglru_scan`` launches in prefill, 12 ``decode_attention`` launches
   per decode step; a profiled prefill and decode step (device time and
   kernel count by kernel); the kernel route
   against the plain route (``impl="naive"``) on prefill and 8
   teacher-forced decode steps' logits, within a multiple of the plain
   route's spread under a 1e-7 perturbation of the embedding; one pattern cycle
   (3 layers) at B=1, S=2,560 on the card against the CPU, prefill and 4
   teacher-forced decode steps.
8. Serving the homogeneous dense stack (the ``"scanned"`` layout) at full
   width: ChatGLM3-6B (28 layers, 6,243,454,976 fp32 parameters from seed
   0), B=2, a 4,096-token prompt and 32 greedy tokens, as phase 7: 28
   ``flash_attention`` launches in prefill and 28 ``decode_attention``
   launches per decode step; 3 layers at B=1, S=320 on the card against
   the CPU.  Then the serving CLI with no arguments: its default,
   StableLM-1.6B (1,644,267,520 parameters), B=4, a 64-token prompt, 32
   tokens.
9. Data-sharded synchronous Algorithm 1: two ``torch.distributed`` ranks
   (gloo, both on the one card; ``run_ranks``) on a 2 x 1 mesh, each
   holding the UE rows of whole edges, run phase 3's problem and model for
   ROUNDS rounds: ``b*`` ``segment_aggregate`` and one ``weighted_mean``
   launch per rank per round, no ``cloud_aggregate``; held to phase 3's
   run repeated unsharded, within SENSITIVITY_FACTOR times the spread of
   that run under a 1e-7 init move (the largest of three moves), and its
   accuracy within one test sample, all with cuDNN's deterministic
   algorithms (with its default ones a LeNet run on the card differs from
   itself as much as the sharded run differs from it).  Then one sharded cloud event at fleet scale,
   2 ranks x 16,384 UE rows x 44,426 fp32 columns made on the card,
   against a float64 sum and all-reduce.
10. The stochastic clock at full width, with cuDNN's deterministic
   algorithms: phase 3's run under ``DeterministicDelays()`` gives phase
   3's clock exactly and the params of a ``delay_model=None`` run bit for
   bit; under the ``urban_stragglers`` scenario's model with
   ``delay_seed=0`` a sync run of ROUNDS rounds (``b*`` ``segment_aggregate``
   and one ``cloud_aggregate`` launch a round) has the clock of the rows
   drawn on the card, within 1e-6 of the same draws made on the CPU, and
   an async run at ``max_staleness=2``, CUT_ROUNDS rounds' quota (``b*``
   launches a departure wave) the timeline of ``events.simulate_async``
   on the card-drawn matrix;
   then its makespan against the sync barrier on the same draws and
   ``makespan_distribution``'s p50/p95 over 64 trials drawn on the card.
11. Faults and sampling at full width, with cuDNN's deterministic
   algorithms: ``FaultModel()`` and a rate-1 sampler give the plain run's
   clock and params bit for bit; ``faulty_cycle_stats`` of churn, uplink
   loss and edge outages over ``ue_churn``'s delays drawn on the card
   equals the CPU's draw (masks and windows exactly, cycle times within
   1e-6); 4 sync rounds under wait-for-all and under deadline+failover
   (clock = the card-drawn stats' round times, deadline <= wait-for-all,
   ``b*`` ``segment_aggregate`` and one ``cloud_aggregate`` a round with
   any survivor); the dead cohort on the card (K1 leaves a killed edge's
   rows exactly 0; K1 and K2 under fault weights against their plain
   versions); sampled sync at rate 0.1 (clock = the cohort-masked
   deterministic cycles, cohort sizes = ``expected_cohort``); async at
   ``max_staleness=2``, CUT_ROUNDS rounds' quota, under deadline+failover
   (timeline =
   ``faulty_async_completion`` on the card, ``b*`` launches a wave); then
   ``fault_makespan_distribution`` over 8 trials, both policies.
12. Joint planning at full width, with cuDNN's deterministic algorithms:
   ``plan_joint`` on phase 3's problem gives ``plan()``'s (a, b) under
   deterministic delays; under ``urban_stragglers`` (16 trials,
   ``Key(0)``) ``solve_joint`` with the key on the card chooses the tuple
   (a, b, max_staleness, bandwidth) it chooses with the key on the CPU,
   every history objective within 1e-6; ``refined(objective="joint")``
   on the 12-UE, 3-edge problem; then ``HFLSimulator(plan_joint's
   schedule, mode="async", max_staleness=None)`` on full-width LeNet for
   three one-round segments (``b*`` ``segment_aggregate`` launches a
   departure wave), checkpointed after the first through ``save_pytree``
   (``{"flat", "params"}``) and finished on a fresh simulator restored by
   ``load_pytree(target=)`` and the ``params`` setter: the clock, trace,
   losses and params equal the uninterrupted run's (max|err| 0.0).
13. The always-on service on the card, with cuDNN's deterministic
   algorithms: ``HFLService`` over a full-width LeNet async simulator on
   phase 3's problem (max_staleness 4, the segments of the JAX package's
   ``tools/crash_smoke.py``), 40 events checkpointed every 5 (the burst
   drives shedding); a service resumed from the event-35 checkpoint ends
   with the same trace, its model within 1e-6; a ``merge_stream_chunk=32``
   run (``segment_sum`` once a chunk, the accumulator on the card) whose
   rows are the direct reads' within 1e-5 and whose trace is the first
   run's (4 events), each of its chunks then held to ``segment_sum``'s plain version
   as phase 2 holds it, on the chunk's own rows and on distinct random
   rows of its shape under its weights; an ``edge_outage`` run of 4
   events with ``fail``, ``repair`` and ``failover`` records, and a wave with a dead cohort whose rows are
   exactly 0; and, in processes of their own beside those runs,
   ``python -m repro_torch.launch.service --device cuda`` (24 UEs, 4
   edges, 40 events) killed with SIGKILL after two checkpoints and
   rerun with ``--resume``: its final checkpoint has an in-process run's
   trace and model (within 1e-6).  Each run's
   ``segment_aggregate`` launches are ``b*`` a departure wave.
14. The rest of multi-device, with cuDNN's deterministic algorithms: one
   ``run_ranks`` spawn of 4 gloo ranks on the one card.  On a 4 x 1 data
   mesh (phase 3's 5 edges pack 2 + 1 + 1 + 1: 40-row slabs) (a) phase
   5's async run cut to one round's quota (timeline and clock = the
   single-device run's of that quota, ``b*``
   ``segment_aggregate`` launches a wave a rank), (d) each rank's slab
   after it folded through ``StreamingEdgeAccumulator`` in 32-row chunks
   (``segment_sum`` once a chunk, within 1e-5 of K1 on the slab and on
   distinct random rows), (b) phase 11's deadline+failover and sampled
   sync runs (clock and masks = phase 11's, ``weighted_mean`` once a
   rank a round with a survivor, no pad row sampled), (c) phase 13's
   streamed service for 4 events (trace = phase 13's record for record,
   ``segment_sum`` once a merge row's chunk; rank 0 checkpoints at event
   2, fresh mesh services resume it to the uninterrupted run's trace and
   model within 1e-6); then on a 2 x 2 ('edge', 'ue') mesh (e) one
   ``make_hfl_cloud_round`` of full-width LeNet at (a*, b*), one of phase
   3's UEs a rank, with no launch.  Each model is held to its
   single-device run on the card by phase 9's rule (the stacked loop of
   ``clients.gd_local_steps`` and ``stacked_weighted_average`` for (e));
   the references not run by phases 5, 11 and 13 and the spread runs run
   in this process while the ranks run (a spread from one init move
   each).  After (e) the ranks also run
   phase 15's part (d).  Each rank's start-up is printed, split into the
   interpreter's start, the import of this script, the CUDA context, the
   gloo rendezvous and the mesh's groups.
15. The transformer's training half, with no kernel launch: (a)
   ``repro_torch.launch.train``'s CLI at its defaults on the card,
   full-width StableLM-1.6B (1,644,267,520 fp32 parameters), AdamW, B=8,
   S=128, 10 steps through ``impl="xla_flash"`` (finite, falling
   losses; ms a step, tokens/s, 6*N*tokens/step time against 67 TFLOP/s
   fp32, peak memory; one warm step profiled; the params and AdamW state
   kept for phase 18); (b) 2 layers of it at full
   width (d_model 2,048, vocab 100,352), B=1, S=64, card against CPU from
   the same init: the loss, every gradient leaf and the params after one
   AdamW step within SENSITIVITY_FACTOR times the card's spread under a
   1e-7 embedding move; (c) ``flash_attention``, ``rglru_scan`` and
   ``decode_attention`` raise on CUDA inputs that require grad and launch
   under ``torch.no_grad()``; (d), in phase 14's spawn, ``--mode hfl
   --edges 2 --ues 2 --smoke --rounds 2`` on the 2 x 2 mesh: the ranks'
   params equal after each cloud event and held to the single-device
   stacked loop on the card by phase 14's rule.
16. The MoE FFN and the xLSTM kinds.  (a) ``repro_torch.launch.serve``
   at full-width Qwen1.5-MoE-A2.7B (24 layers, 60 routed experts top-4
   and 4 shared, MHA 16 over 16 heads of 128; 14,315,636,736 fp32
   parameters from seed 0), B=2, a 4,096-token prompt, 32 greedy tokens:
   24 ``flash_attention`` launches in prefill and 24 ``decode_attention``
   a decode step, no other; (b) the same model step by step, timed,
   counted and profiled (the MoE's route, dispatch, expert products and
   combine annotated), peak memory under 80 GB; (c) its kernel route
   against the plain route as phase 7's, with the routes pinned to the
   kernel run's (``PinnedRoutes``: a rounding-sized move can swap the 4th
   and 5th expert of a token; the flips it would have made unpinned and
   their smallest router margin printed); (d) 3 layers of it at full
   width, B=1, S=320 + 4 decode steps, card against the CPU, pinned; (e)
   ``flash_attention`` and ``decode_attention`` at its head layout
   against their plain versions and timed beside SDPA and their bounds;
   (f) Mixtral-8x7B at smoke width (a 64-token window, no shared
   experts), a 160-token prompt and 16 tokens, kernel route against plain
   route, pinned; ``launch.train --arch qwen2-moe-a2.7b --smoke --steps
   10`` on the card: finite losses, a positive, finite MoE aux loss, no
   launch; (g) full-width xLSTM-125M (125,707,824 parameters) through the
   serving CLI, B=2, a 1,024-token prompt, 32 tokens, with no kernel
   launch; the whole model on the card against the CPU, as phase 8's cut;
   ``impl="chunked"`` (the chunkwise-parallel mLSTM) against the scan on
   the card at B=2, S=512, prefill and 4 teacher-forced decode steps,
   within phase 7's rule.
17. The encoder-decoder stack, the vision frontend and bf16.  (a)
   ``repro_torch.launch.serve`` at full-width Whisper-base (6 encoder and
   6 decoder layers, MHA 8 over 8 heads of 64; 97,182,720 fp32
   parameters from seed 0), B=8, 1,500 frames (its 30 s window), 32
   greedy tokens: 6 ``flash_attention`` launches (the bidirectional
   encoder) and 6 ``decode_attention`` a token, the prefill's first among
   them (6 + 6 x 31), none else; a profiled decode step; (b) 2 encoder and
   2 decoder layers of it at B=1, 1,500 frames: kernel route against
   plain route and card against CPU, prefill and TEACHER_STEPS
   teacher-forced decode steps, within SENSITIVITY_FACTOR times the plain
   route's spread under a 1e-7 move of the embedding and the frames; (c)
   full-width InternVL2-26B in bf16 (``Model(param_dtype=, act_dtype=
   torch.bfloat16)``, 19,861,260,288 parameters, 39.7 GB) through
   ``serve.generate``: B=2, 256 patch embeddings and 3,840 tokens, 32
   greedy tokens, peak memory under 80 GB; then a prefill (48
   ``flash_attention_bf16`` launches) and TEACHER_STEPS teacher-forced
   decode steps (48 ``decode_attention_bf16`` each) against the plain route,
   within BF16_FACTOR times the bf16 yardstick (the plain route with bf16
   activations against the same with fp32 activations on the same bf16
   weights); a profiled decode step; (d) 2 layers of it at full width in
   bf16, B=1, 256 patches and 64 tokens, card against CPU by (c)'s rule;
   (e) ``launch.train --arch whisper-base --steps 10`` at full width
   (``xla_flash``, no launch): finite, falling losses; then
   ``flash_attention`` and ``decode_attention`` at Whisper's shapes
   (fp32) and InternVL2's (bf16, their own lines and tolerances) against
   their plain versions and timed beside SDPA and their bounds (bf16: at
   the bf16 tensor-core rate), the bf16 decode also with half and twice
   its rule's split count.
18. The roofline bridge (``repro_torch.roofline``), run right after
   phase 15 on its StableLM-1.6B before the weights are freed: (a) one
   more warm train step (B=8, S=128, fp32, AdamW) under the cost walk
   (``CostWalk``), no kernel launched; its FLOPs equal the 2-layer cut's
   count plus 22 times the difference of the 2- and 1-layer cuts' counts
   at the same batch, exactly, and phase 15 (b)'s cut counts the same
   FLOPs on the card as on the CPU; ``roofline_report`` at fp32, and phase
   15's warm step, which must not beat ``compute_s``, against
   ``compute_s`` and ``step_time_lower_bound_s``; (b) with the same
   weights one prefill (B=2, 4,096 tokens) and one decode step through
   ``impl="kernel"`` under the walk: 24 ``flash_attention`` and 24
   ``decode_attention`` launches, each with its cost recorded (the walk
   raises on a launch without one), both reports at fp32; (c)
   ``plan_from_roofline`` on (a)'s terms for 2 edges of 4 GPUs at the
   fp32 parameters' bytes on the H100's links: ``t_step`` =
   max(compute_s, memory_s) and T = eq. 34 on the returned association.
19. The transformer sharded over 4 gloo ranks on the card (DTensors,
   ``Model(mesh=, rules=)``; every collective staged through pinned host
   memory), begun beside phase 14 and finished before phase 15: (a)
   full-width StableLM-1.6B's SGD step on a 2 x 2 ('data', 'model') mesh
   (fp32, B=8, S=128, cuDNN's deterministic algorithms) against the
   single-device step on the same keyed draws: the loss within 1e-5
   relative, every leaf within 1e-5 of its largest magnitude; (b)
   full-width Qwen1.5-MoE-A2.7B in bf16 through K5 and K7 on a 1 x 4 mesh
   (B=2, 1,024 tokens, 4 steps) under the default and the expert-parallel
   rules, routes pinned: logits within phase 17's bf16 rule, every greedy
   token equal but at the single-device run's near-ties, 24 K5 (its bf16
   kernel, ``flash_attention_bf16``) and 96 K7 (``decode_attention_bf16``)
   launches on every rank, then both bf16 kernels timed at a rank's local
   shape (the decode also at half and twice its splits); (c)
   the dry run (``--mesh-dryrun``, a process of its own) of (a) and (b)
   on fake groups: per-rank FLOPs, collective bytes and argument bytes
   equal rank 0's walk of the real step, then the production pair
   stablelm-1.6b x train_4k on 16 x 16.
20. Kernel records as JSON (``launches``: each path's count, read around
   its run with the counts reset just before it, summed over the paths
   and, in phases 9, 14 and 19, over the ranks), then the result line.

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``.  Without a card it exits 1 before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import contextlib
import time
from unittest import mock

T_IMPORT = time.time()          # phase 14 times its ranks' start-up

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.lenet_mnist import LeNetConfig  # noqa: E402
from repro_torch.core import HFLProblem, plan  # noqa: E402
from repro_torch.data import (TokenStream, size_partition,  # noqa: E402
                              synthetic_mnist)
from repro_torch.fl.aggregate import (StreamingEdgeAccumulator,  # noqa: E402
                                      flat_cloud_aggregate)
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.fl.sim import HFLSimulator  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, IB_BW, NVLINK_BW,  # noqa: E402
                                     PEAK_FLOPS_BF16, PEAK_FLOPS_FP32,
                                     make_agg_mesh, run_ranks)
from repro_torch.models.lenet import lenet_init, lenet_loss  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.roofline import (CostWalk, record_from_trace,  # noqa: E402
                                  roofline_report)
from torch.utils._python_dispatch import (  # noqa: E402
    _disable_current_modes)

T_IMPORTED = time.time()


MAIN = dict(num_edges=5, num_ues=100, epsilon=0.25, seed=0)
ROUNDS = 2
CUT_ROUNDS = 1               # phases 10, 11 and 14's async runs: one
                             # round's quota (5 updates of phase 5's 10)
SAMPLES_PER_UE = 64
LR = 0.05
KERNEL_RTOL = 1e-5           # of the result's largest magnitude: the kernel
                             # and its plain version sum in other orders
# Phase 4 tolerance.  136 GD steps through tanh convolutions amplify
# float32 rounding far past any fixed 1e-5: moving the init by 1e-7
# relative moves the result by ~5e-4 (phase 4 prints it).  The card
# differs from the CPU only in the order of its sums, so its result must
# lie within 10x the CPU's own spread under such a perturbation, measured
# in the same run.
SENSITIVITY_NOISE = 1e-7
SENSITIVITY_FACTOR = 10.0
ASYNC_STALENESS = 2
# Phase 6: benchmarks/bench_scale.py's largest fleet and its chunking.
STREAM_ROWS = 1 << 20
STREAM_COLS = 1024
STREAM_GROUPS = 16
STREAM_CHUNK = 8192
STREAM_SEED = 7
STREAM_RTOL = 1e-5           # of the largest |mean|: fp32 chunk sums added
                             # 128 times, against a float64 accumulation

# Phase 7: full-width RecurrentGemma-9B serving.
SERVE_ARCH = "recurrentgemma-9b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 4096, 32
SERVE_PARAMS = 8_532_381_696
CPU_BATCH, CPU_PROMPT = 1, 2560   # one pattern cycle, card against the CPU
CPU_STEPS = 4                     # teacher-forced decode steps, card vs CPU
TEACHER_STEPS = 8                 # decode steps held to the plain route
# The kernel route against the plain route (and the card against the CPU)
# is held, as phase 4 holds LeNet, to SENSITIVITY_FACTOR times the plain
# route's own spread when the embedding moves by 1e-7 relative
# (SENSITIVITY_NOISE), measured in the same run.  The two routes differ
# only in the order of their sums; a masking or indexing fault moves the
# logits by percents of their scale, orders of magnitude past that.
ATTN_ATOL = 2e-5             # tests/test_kernels.py's attention tolerance
BF16_FLOOR = 2.0 ** -16      # bf16 attention: each element within one bf16
                             # ulp of itself (2^-7 |ref|) plus this share of
                             # the largest |ref| (the kernel's error before
                             # its store is ~2e-6 of it), and the whole
                             # within 2 bf16 ulps of the largest |ref|
FA_INSTANTIATIONS = 3        # flash_attention.cu: head dims 64/128/256,
                             # fp32
FA_BF16_INSTANTIATIONS = 5   # flash_attention_bf16.cu: head dims 64/128 x
                             # 1 or 2 consumer warpgroups, 256 x 1
DA_INSTANTIATIONS = 6        # decode_attention.cu: head dims 64/128/256
                             # x 1 or 2 m-tiles, fp32
DA_BF16_INSTANTIATIONS = 3   # decode_attention_bf16.cu: head dims
                             # 64/128/256
SEG_INSTANTIATIONS = 6       # segment_sum.cu, segment_aggregate.cu,
                             # cloud_aggregate.cu, weighted_mean.cu: load
                             # widths of 4, 2, 1 elements x fp32/bf16
HOST_CALLS = 1000            # calls timed on the host clock, no sync
PROFILE_RETRIES = 3          # phase 2: reruns of a session that recorded
                             # no kernel (each printed; never a pass)
PROBE_SESSIONS = 200         # --probe-profiler's sessions
# Phase 8: full-width ChatGLM3-6B serving (B, prompt and tokens as phase
# 7), and the serving CLI's default model at the CLI's default sizes.
GLM_ARCH = "chatglm3-6b"
GLM_PARAMS = 6_243_454_976
GLM_CPU_PROMPT = 320
CLI_ARCH = "stablelm-1.6b"
CLI_PARAMS = 1_644_267_520
CLI_BATCH, CLI_PROMPT, CLI_LAYERS = 4, 64, 24
# Phase 9: two data shards of phase 3's fleet (5 edges of 20 UEs packed
# 3 + 2: 60 rows a shard, 20 of them padding on the second), then a
# fleet-scale shard per rank.
SHARD_RANKS = 2
SHARD_ROWS = 60
SPREAD_SEEDS = (1, 2, 3)
CPU_EDGE = 0                 # phase 4's card-against-CPU cohort: this edge
CPU_UES = 10                 # ... its first UEs (of 20)
LENET_PARAMS = 44_426
FLEET_ROWS = 16_384
FLEET_SEED = 11
RANK_TIMEOUT_S = 480
# Phase 10: the stochastic clock on phase 3's problem and model.
STOCH_SCENARIO = "urban_stragglers"
STOCH_SEED = 0
STOCH_TRIALS = 64
CLOCK_RTOL = 1e-6            # card-drawn against CPU-drawn clock: float32
                             # exp/log2 may differ by an ulp between them
# Phase 11: faults and sampling on phase 3's problem and model.  The
# fault model composes the processes of the ue_churn, lossy_uplink and
# edge_outage scenarios; the sampler and rate are
# benchmarks/bench_scale.py's.
FAULT_SCENARIO = "ue_churn"          # its delay model
FAULT_SEED = 0
FAULT_ROUNDS = 4
FAULT_TRIALS = 8
SAMPLER, SAMPLE_RATE = "weight", 0.1
# Phase 12: the joint optimizer on phase 3's problem (16 trials: the
# reference's solve_joint default), refined(objective="joint") on the
# README's 12-UE, 3-edge problem.
JOINT_SEED = 0
JOINT_TRIALS = 16
JOINT_MAX_MOVES = 5
# Phase 13: the always-on service on phase 3's problem and model, with the
# segments of the JAX package's tools/crash_smoke.py (a 4x burst from 40 to
# 100 s simulated); 40 events reach the burst's shedding (its first shed
# comes after event 36).  The resume runs the last 5 events, the streamed
# run the first 4 (a merge row each) and the outage run 4 (the fewest with
# its fail, failover and repair records).  The SIGKILL run
# is tools/crash_smoke.py's, cut from 160 events to 40: the CLI's logreg
# federation of 24 UEs on 4 edges, killed after its second checkpoint
# (event 20), resumed to its end.
SERVICE_SEGMENTS = "iid_campus:1.0:40,iid_campus:4.0:60,iid_campus:1.0:inf"
SERVICE_STALENESS = 4
SERVICE_EVENTS = 40
SERVICE_CKPT_EVERY = 5
SERVICE_RESUME_AT = 35
SERVICE_STREAM_CHUNK = 32
SERVICE_STREAM_EVENTS = 4
SERVICE_FAULT_SEED = 0        # edge_outage: an edge down at the t=40 s
SERVICE_FAULT_EVENTS = 4      # boundary, its repair within 4 events
SERVICE_MODEL_TOL = 1e-6      # the JAX service's own resume rule
STREAM_MERGE_TOL = 1e-5       # streamed against direct merge rows, as there
SERVICE_CHUNK_SEED = 3       # distinct rows for K4 at the service's chunks
KILL_UES, KILL_EDGES, KILL_EVENTS = 24, 4, 40
KILL_CKPT_EVERY = 10
KILL_TIMEOUT_S = 300
# Phase 14: the rest of multi-device, 4 gloo ranks on the one card.  A 4 x 1
# data mesh: phase 3's 5 edges of 20 UEs pack 2 + 1 + 1 + 1, so 40-row
# slabs (the last three a 20-row edge and 20 pad rows); its async,
# faults, sampling and service runs are phases 5, 11 and 13's.  Then a
# 2 x 2 ('edge', 'ue') mesh for the SPMD round, one of phase 3's UEs a
# rank.  The single-device references and their spreads run in this
# process while the ranks run.
MESH_RANKS = 4
MESH_ROWS = 40
MESH_TIMEOUT_S = 600
MESH_CKPT_AT = 2                     # the service's checkpoint, of 4 events
MESH_STREAM_CHUNK = 32
MESH_STREAM_SEED = 5
MESH_SPREAD_SEEDS = SPREAD_SEEDS[:1]   # phase 14: one move a reference
                                       # (the largest ratio, async's train
                                       # loss, 1.20 with two)
FL_MESH = (2, 2)
# Phase 15: the transformer's training half.  (a) the training CLI at its
# defaults (full-width StableLM-1.6B, B=8, S=128, AdamW at 3e-4); (b) a
# full-width 2-layer cut card against CPU; (d) ``--mode hfl`` at smoke
# width on phase 14's 2 x 2 mesh of ranks.
TRAIN_ARGV = ["--arch", CLI_ARCH, "--steps", "10", "--device", "cuda"]
# Phase 16: the MoE FFN and the xLSTM kinds.  Qwen1.5-MoE-A2.7B
# (hf:Qwen/Qwen1.5-MoE-A2.7B) at full width: 24 layers of 60 routed
# experts (top-4) and 4 shared ones, MHA of 16 heads of 128; 57.3 GB of
# fp32 parameters.
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_PARAMS = 14_315_636_736
MOE_LAYERS = 24
MOE_CPU_LAYERS = 3                # the card-against-CPU cut, full width
MOE_MEMORY_LIMIT = 80e9           # peak bytes allowed while serving it
ATTN_MOE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 16, 128, True, 0)
DECODE_MOE = (SERVE_BATCH, 2 * SERVE_PROMPT, 16, 16, 128, SERVE_PROMPT, 0,
              "prefix")
MIXTRAL_ARCH = "mixtral-8x7b"     # smoke width: 186.8 GB in fp32 at full
MIXTRAL_SMOKE_PARAMS = 3_738_880
MIXTRAL_PROMPT, MIXTRAL_GEN = 160, 16    # past its 64-token window
MOE_TRAIN_ARGV = ["--arch", MOE_ARCH, "--smoke", "--steps", "10",
                  "--device", "cuda", "--log-every", "5"]
XLSTM_ARCH = "xlstm-125m"         # arXiv:2405.04517, full width
XLSTM_PARAMS = 125_707_824
XLSTM_PROMPT = 1024
XLSTM_CHUNKED_PROMPT = 512        # chunked against scan: 4 chunks of 128
TRAIN_LR = 3e-4
TRAIN_CUT_LAYERS, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 2, 1, 64
# Phase 18: the roofline bridge on phase 15's StableLM-1.6B.  Its train
# step's FLOPs extrapolated from cuts of these layers at the same batch;
# one prefill of ROOF_PROMPT tokens at B=ROOF_BATCH and one decode step
# through the kernels; the plan on an ROOF_EDGES x ROOF_UES cluster
# priced at the fp32 parameters' bytes.
ROOF_CUTS = (1, 2)
ROOF_BATCH, ROOF_PROMPT = 2, 4096
ROOF_EDGES, ROOF_UES = 2, 4
HFL_ARGV = ["--mode", "hfl", "--edges", "2", "--ues", "2", "--smoke",
            "--rounds", "2"]
# Phase 17: the encoder-decoder stack, the vision frontend and bf16.
# Whisper-base (arXiv:2212.04356) at full width in fp32: 6 encoder and 6
# decoder layers, MHA of 8 heads of 64, 1,500 frames (the model's 30 s
# window); the decoder's self-attention ring has 1,500 // 8 = 187 slots.
WHISPER_ARCH = "whisper-base"
WHISPER_PARAMS = 97_182_720
WHISPER_LAYERS = 6
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_GEN = 8, 1500, 32
WHISPER_CUT = 2                   # (b): 2 encoder and 2 decoder layers
WHISPER_TRAIN_ARGV = ["--arch", WHISPER_ARCH, "--steps", "10", "--device",
                      "cuda", "--log-every", "5"]
# InternVL2-26B (arXiv:2404.16821) at full width in bf16: 48 layers, GQA
# 48 over 8 heads of 128, 256 patch embeddings (one 448-px tile) before
# 3,840 tokens; 39.7 GB of bf16 parameters (79.4 GB in fp32: no card).
VLM_ARCH = "internvl2-26b"
VLM_PARAMS = 19_861_260_288
VLM_LAYERS = 48
VLM_PROMPT = SERVE_PROMPT         # 256 patches + 3,840 tokens
VLM_CPU_LAYERS, VLM_CPU_TOKENS = 2, 64
VLM_MEMORY_LIMIT = 80e9
# A bf16 run is held to a yardstick of bf16's own: the distance between
# the plain route with bf16 activations and the same route with fp32
# activations on the same bf16 weights (a 1e-7 move vanishes under bf16
# rounding).  Two bf16 runs that round at other points each lie about
# that far from the fp32-activation run, so they may lie up to twice it
# apart: BF16_FACTOR.
BF16_FACTOR = 2.0
ATTN_WHISPER = (WHISPER_BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8, 64,
                False, 0)
ATTN_VLM = (SERVE_BATCH, VLM_PROMPT, VLM_PROMPT, 48, 8, 128, True, 0)
DECODE_WHISPER = (WHISPER_BATCH, WHISPER_FRAMES // 8, 8, 8, 64,
                  WHISPER_GEN - 1, 0, "prefix")
DECODE_VLM = (SERVE_BATCH, 2 * VLM_PROMPT, 48, 8, 128, VLM_PROMPT, 0,
              "prefix")

KERNELS = {
    "segment_aggregate": dict(
        source="src/repro_torch/kernels/csrc/segment_aggregate.cu",
        replaces="src/repro/kernels/hier_aggregate.py:182"),
    "cloud_aggregate": dict(
        source="src/repro_torch/kernels/csrc/cloud_aggregate.cu",
        replaces="src/repro/kernels/hier_aggregate.py:117"),
    "weighted_mean": dict(
        source="src/repro_torch/kernels/csrc/weighted_mean.cu",
        replaces="src/repro/kernels/hier_aggregate.py:62"),
    "segment_sum": dict(
        source="src/repro_torch/kernels/csrc/segment_sum.cu",
        replaces="src/repro/kernels/hier_aggregate.py:263"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:89"),
    # the same wrapper's bf16 kernel, counted under its own name
    "flash_attention_bf16": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
        replaces="src/repro/kernels/flash_attention.py:89"),
    "rglru_scan": dict(
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:41"),
    "decode_attention": dict(
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:66"),
    # the same wrapper's bf16 kernel, counted under its own name
    "decode_attention_bf16": dict(
        source="src/repro_torch/kernels/csrc/decode_attention_bf16.cu",
        replaces="src/repro/kernels/decode_attention.py:66"),
}


def expect(**launched) -> dict:
    """Every kernel's count: ``launched`` where named, else 0."""
    return {name: launched.get(name, 0) for name in KERNELS}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase_device() -> None:
    t0 = time.perf_counter()
    paths = build.build()
    print(f"built {', '.join(paths)} in {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    check_no_spill(paths["flash_attention"], FA_INSTANTIATIONS)
    check_no_spill(paths["flash_attention_bf16"], FA_BF16_INSTANTIATIONS)
    # ptxas's notes that setmaxnreg was ignored (C7508) or that wgmma
    # products were serialized for want of registers (C7512)
    log = paths["flash_attention_bf16"].with_suffix(".log").read_text()
    check("C7508" not in log and "C7512" not in log,
          "flash_attention_bf16: ptxas ignored setmaxnreg or serialized "
          "wgmma")
    check_no_spill(paths["decode_attention"], DA_INSTANTIATIONS)
    check_no_spill(paths["decode_attention_bf16"], DA_BF16_INSTANTIATIONS)
    check_no_spill(paths["segment_sum"], SEG_INSTANTIATIONS)
    check_no_spill(paths["segment_aggregate"], SEG_INSTANTIATIONS)
    check_no_spill(paths["cloud_aggregate"], SEG_INSTANTIATIONS)
    check_no_spill(paths["weighted_mean"], SEG_INSTANTIATIONS)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")


def check_no_spill(path, instantiations: int) -> None:
    """Every kernel of the library at ``path`` compiled without spilling:
    ptxas (``-Xptxas -v``) reports 0 bytes of spill stores and loads for
    each of its ``instantiations``."""
    lines = [ln.strip() for ln in path.with_suffix(".log").read_text()
             .splitlines() if "spill" in ln]
    name = path.name.split("-")[0]
    check(len(lines) >= instantiations, f"{path.name}: {len(lines)} "
          f"ptxas spill lines, expected {instantiations}")
    spilled = [ln for ln in lines
               if "0 bytes spill stores, 0 bytes spill loads" not in ln]
    check(not spilled, f"{path.name} spills: {spilled}")
    print(f"  {name}: ptxas reports no spill in any of its {len(lines)} "
          f"kernels")


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def kernel_cases(device):
    """name -> (x, w, group_ids, num_groups), made from a seed on ``device``:
    the main path's shape, then the edge cases."""
    rng = np.random.default_rng(0)
    cases = {}
    for name, n, f, m, edit in [
            ("main_n100_f44426", 100, 44_426, 5, None),
            ("slab_n60_f44426", SHARD_ROWS, LENET_PARAMS, 5, None),
            ("past_tpu_split_n1000", 1000, 1000, 5, None),
            ("ragged_f1001", 100, 1001, 5, None),
            ("bf16_main", 100, 44_426, 5, "bf16"),
            ("edge_without_members", 100, 1001, 6, "empty"),
            ("edge_all_zero_weight", 100, 1001, 5, "zero"),
            ("odd_row_view_f44426", 100, 44_426, 5, "odd_row"),
            ("bf16_odd_row_view", 100, 44_426, 5, "bf16_odd_row")]:
        odd = bool(edit) and "odd_row" in edit
        x = torch.from_numpy(rng.normal(0, 1, (n + odd, f)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(200, 1000, n).astype(np.float32))
        g = torch.from_numpy((np.arange(n) % min(m, 5)).astype(np.int32))
        if edit in ("bf16", "bf16_odd_row"):
            x = x.to(torch.bfloat16)
        if edit == "zero":
            w[g == 2] = 0.0
        # a row view from row 1 of the buffer: 8-byte (fp32) or 4-byte
        # (bf16) aligned at F = 44,426, as a shard's slab can be
        x = x.to(device)[1:] if odd else x.to(device)
        cases[name] = (x, w.to(device), g.to(device), m)
    return cases


def _max_err(out, ref) -> float:
    return float((out - ref).abs().max())


def check_kernels_against_plain(cases) -> dict:
    """Each kernel on each case against its plain version; returns the
    largest absolute error per kernel."""
    errs = {"segment_aggregate": 0.0, "cloud_aggregate": 0.0}
    for case, (x, w, g, m) in cases.items():
        pairs = {
            "segment_aggregate": (ha.segment_aggregate(x, w, g, m),
                                  ha.segment_aggregate_plain(x, w, g, m)),
            "cloud_aggregate": (ha.cloud_aggregate(x, w),
                                ha.cloud_aggregate_plain(x, w)),
        }
        again = {"segment_aggregate": ha.segment_aggregate(x, w, g, m),
                 "cloud_aggregate": ha.cloud_aggregate(x, w)}
        torch.cuda.synchronize()
        for name, out in again.items():
            check(torch.equal(pairs[name][0], out),
                  f"{name} on {case}: two launches differ")
        for name, (out, ref) in pairs.items():
            check(out.dtype == torch.float32 and out.shape == x.shape,
                  f"{name} on {case}: dtype/shape")
            check(bool(torch.isfinite(out).all()), f"{name} on {case}: finite")
            err = _max_err(out, ref)
            scale = float(ref.abs().max())
            check(err <= KERNEL_RTOL * scale,
                  f"{name} on {case}: max|err| {err:.3e} > "
                  f"{KERNEL_RTOL} x {scale:.3e}")
            errs[name] = max(errs[name], err)
            print(f"  {name:17s} {case:22s} max|err| {err:.3e} "
                  f"(scale {scale:.3e})")
        if case == "edge_all_zero_weight":
            seg = pairs["segment_aggregate"][0]
            check(bool((seg[g == 2] == 0).all()),
                  "segment_aggregate: all-zero-weight edge is not exactly 0")
            print("  segment_aggregate  all-zero-weight edge gives exactly 0")
    # No guard in eq. 10: all-zero weights give NaN at every N, as the
    # reference's plain route (the TPU kernel's fall-through for N > 512
    # to the guarded segment kernel is not followed).
    for n in (40, 600):
        x = cases["past_tpu_split_n1000"][0][:n]
        w = torch.zeros(n, device="cuda")
        check(bool(ha.cloud_aggregate(x, w).isnan().all()
                   and ha.cloud_aggregate_plain(x, w).isnan().all()),
              f"cloud_aggregate: all-zero weights at N={n} do not give NaN")
    print("  cloud_aggregate    all-zero weights give NaN at N=40 and 600, "
          "as the reference")
    return errs


def time_ms(fn, flush: torch.Tensor, iters: int = 100,
            warmup: int = 10) -> float:
    """Median device time of ``fn`` in ms over ``iters`` launches, each
    bracketed by CUDA events, with the L2 cache flushed before each (the
    flush also keeps the stream busy while the host enqueues ``fn``)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def averaging_operator(w, g, m):
    """(N, N) matrix P with P @ x equal to the eq. 6 (``g`` given) or eq. 10
    (``g`` None) event: one ``torch.mm`` is then the library yardstick."""
    if g is None:
        return (w / w.sum())[None, :].expand(w.shape[0], -1).contiguous()
    same = (g[:, None] == g[None, :]).to(torch.float32)
    gw = torch.zeros(m, device=w.device).index_add_(0, g.long(), w)
    return same * w[None, :] / gw.clamp_min(1e-12)[g.long()][:, None]


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn``: a loop of ``calls`` calls with
    no synchronisation between them (the card runs behind the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per_call = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return per_call


def kernels_per_call(fn, flush: torch.Tensor) -> dict:
    """The device kernels one call of ``fn`` launches, the L2 flushed just
    before (``torch.profiler``): name -> (count, device us)."""
    fn()
    flush.zero_()
    torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total)
            for e in device_profile(fn)[1]}


def launched_line(launched: dict) -> str:
    return "; ".join(f"{k.split('(')[0][-40:]} {c}x {us:.2f} us"
                     for k, (c, us) in launched.items())


def aggregation_calls(cases, s_cases) -> dict:
    """name -> one call of ``segment_aggregate``, ``cloud_aggregate`` or
    ``segment_sum`` (adding into an accumulator, as the streaming path
    calls it) at each case's shape."""
    accs = {case: torch.zeros(m, x.shape[1], device=x.device)
            for case, (x, _, _, m) in s_cases.items()}
    return {
        "segment_aggregate": [
            lambda x=x, w=w, g=g, m=m: ha.segment_aggregate(x, w, g, m)
            for x, w, g, m in cases.values()],
        "cloud_aggregate": [lambda x=x, w=w: ha.cloud_aggregate(x, w)
                            for x, w, _, _ in cases.values()],
        "segment_sum": [
            lambda x=x, w=w, g=g, m=m, acc=accs[case]:
            ha.segment_sum(x, w, g, m, out=acc)
            for case, (x, w, g, m) in s_cases.items()]}


def warm_profiler(flush: torch.Tensor) -> None:
    """One throwaway ``torch.profiler`` session, so that no checked
    session is the process's first (CUPTI's start-up)."""
    kernels_per_call(lambda: flush.zero_(), flush)


def check_one_launch(calls_by_name: dict) -> None:
    """The calls of each wrapper (name -> calls), run together in one
    ``torch.profiler`` session a wrapper: the wrapper's own count
    (``launch_counts``) rises by exactly one a call and no other kernel's
    count moves, and the profiler records nothing but the wrapper's
    ``{name}_kernel``, at most once a call.  A session that records no
    kernel at all is run again, at most PROFILE_RETRIES times, each retry
    printed; a session that never records one fails."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    warm_profiler(flush)
    for name, calls in calls_by_name.items():
        for attempt in range(1 + PROFILE_RETRIES):
            # the counts of the profiled run alone (kernels_per_call runs
            # the calls once before it)
            launched = kernels_per_call(
                lambda: (tracing.reset(), [fn() for fn in calls]), flush)
            counted = tracing.launches()
            check(counted == expect(**{name: len(calls)}),
                  f"{name}: {len(calls)} calls counted {counted}")
            if launched:
                break
            print(f"  {name}: the profiler recorded no kernel of "
                  f"{len(calls)} calls (session {attempt + 1} of at most "
                  f"{1 + PROFILE_RETRIES}); running the calls again")
        count = sum(c for c, _ in launched.values())
        check(bool(launched) and all(f"{name}_kernel" in k for k in launched)
              and count <= len(calls), f"{name}: {len(calls)} calls "
              f"launched {launched}")
        print(f"  {name}: {len(calls)} calls, one at each case's shape, "
              f"counted {len(calls)} launches; the profiler recorded "
              f"{count} kernels, all {name}_kernel")


def probe_profiler(sessions: int = PROBE_SESSIONS) -> int:
    """``python3 chip_smoke.py --probe-profiler``: how many of phase 2's 9
    ``segment_aggregate`` calls (ctypes launches) a ``torch.profiler``
    session records when they are the process's first launches of the
    kernel, and how often a session records none of them once they have
    run, with and without a PyTorch kernel launched in the same session.  A
    session that records the PyTorch kernel and not the ctypes ones would
    point at CUPTI dropping the ctypes launches; one that records neither,
    at the session."""
    build.build(("segment_aggregate",))
    cases = kernel_cases("cuda")
    calls = aggregation_calls(cases, {})["segment_aggregate"]
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    marker = torch.zeros(1 << 20, device="cuda")
    # the calls' first launches in the process, profiled with no call
    # before them (phase 2's sessions run the calls once first)
    cold = device_profile(lambda: [fn() for fn in calls])[1]
    print(f"probe: CUDA_MODULE_LOADING="
          f"{os.environ.get('CUDA_MODULE_LOADING', '(unset)')}; the first "
          f"{len(calls)} calls of the process recorded "
          f"{sum(e.count for e in cold)} kernels: "
          f"{[(e.key.split('(')[0][-50:], e.count) for e in cold]}")
    rows = []
    for i in range(sessions):
        with_marker = i % 2 == 1
        launched = kernels_per_call(
            lambda: [fn() for fn in calls] + (
                [marker.add_(1.0)] if with_marker else []), flush)
        ours = sum(c for k, (c, _) in launched.items()
                   if "segment_aggregate_kernel" in k)
        other = sum(c for k, (c, _) in launched.items()
                    if "segment_aggregate_kernel" not in k)
        rows.append((i, with_marker, ours, other))
    empty = [r for r in rows if r[2] == 0]
    print(f"probe: {sessions} sessions of {len(calls)} segment_aggregate "
          f"calls (every other one with a PyTorch add); first session "
          f"recorded {rows[0][2]} of ours; sessions recording none of ours: "
          f"{len(empty)} ({[r[0] for r in empty][:20]}), of which the "
          f"PyTorch kernel was recorded in "
          f"{sum(1 for r in empty if r[1] and r[3] > 0)}; sessions "
          f"recording fewer than {len(calls)}: "
          f"{sum(1 for r in rows if 0 < r[2] < len(calls))}")
    print(json.dumps({"probe": [list(r) for r in rows]}))
    return 0


def time_kernels(x, w, g, m,
                 names=("segment_aggregate", "cloud_aggregate")) -> dict:
    """Kernel, plain-version and library times of the events ``names`` on
    one input, the wrappers' host time per call, and each kernel's bound
    from this input's bytes and operations."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)   # > 50 MB L2
    n, f = x.shape
    ops = {"segment_aggregate": (ha.segment_aggregate, ha.segment_aggregate_plain,
                                 ha.segment_aggregate_cost, (w, g, m)),
           "cloud_aggregate": (ha.cloud_aggregate, ha.cloud_aggregate_plain,
                               ha.cloud_aggregate_cost, (w,))}
    out = {}
    for name in names:
        kernel, plain, cost, args = ops[name]
        p = averaging_operator(w, g if len(args) == 3 else None, m)
        ref = plain(x, *args)
        check(_max_err(torch.mm(p, x), ref)
              <= KERNEL_RTOL * float(ref.abs().max()),
              "torch.mm with the averaging operator computes the event")
        flops, nbytes = cost(x, *args)
        launched = kernels_per_call(lambda: kernel(x, *args), flush)
        out[name] = dict(
            ms=time_ms(lambda: kernel(x, *args), flush),
            plain_ms=time_ms(lambda: plain(x, *args), flush),
            library_ms=time_ms(lambda: torch.mm(p, x), flush),
            **bound(nbytes, flops))
        r = out[name]
        print(f"  {name:17s} N={n} F={f} M={m}: kernel "
              f"{r['ms'] * 1e3:8.2f} us   plain {r['plain_ms'] * 1e3:8.2f} us"
              f"   torch.mm {r['library_ms'] * 1e3:8.2f} us   bound "
              f"{r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']}, {nbytes} B);"
              f" host {host_us(lambda: kernel(x, *args)):.2f} us a call; "
              f"one call profiled: {launched_line(launched)}")
    return out


def sum_cases(device):
    """name -> (x, w, group_ids, num_groups) for ``segment_sum``, made from
    a seed on ``device``: the streaming chunk and the LeNet cohort shapes,
    then the edge cases."""
    rng = np.random.default_rng(1)
    cases = {}
    for name, n, f, m, edit in [
            ("stream_n8192_f1024", STREAM_CHUNK, STREAM_COLS, STREAM_GROUPS,
             None),
            ("lenet_n100_f44426", 100, 44_426, 5, None),
            ("service_n20_f44426_m1", 20, 44_426, 1, None),
            ("chunk_of_1", 1, STREAM_COLS, STREAM_GROUPS, None),
            ("chunk_of_7", 7, STREAM_COLS, STREAM_GROUPS, None),
            ("ragged_f1001", STREAM_CHUNK, 1001, STREAM_GROUPS, None),
            ("bf16_stream", STREAM_CHUNK, STREAM_COLS, STREAM_GROUPS, "bf16"),
            ("group_without_members", 1000, 1001, 6, "empty"),
            ("group_all_zero_weight", 1000, 1001, 5, "zero"),
            ("max_groups", 2000, 1001, ha.MAX_GROUPS, None),
            ("odd_row_view_f44426", 100, 44_426, 5, "odd_row"),
            ("bf16_odd_row_view", 100, 44_426, 5, "bf16_odd_row")]:
        odd = bool(edit) and "odd_row" in edit
        x = torch.from_numpy(rng.normal(0, 1, (n + odd, f)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
        g = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
        if edit in ("bf16", "bf16_odd_row"):
            x = x.to(torch.bfloat16)
        if edit == "empty":
            g = torch.from_numpy((np.arange(n) % (m - 1)).astype(np.int32))
        if edit == "zero":
            w[g == 2] = 0.0
        x = x.to(device)[1:] if odd else x.to(device)
        cases[name] = (x, w.to(device), g.to(device), m)
    return cases


def check_segment_sum_against_plain(cases) -> float:
    """``segment_sum`` on each case against its plain version, bit for bit
    between two launches, the chunk sum formed first and then added
    (``0.5 + sum`` exactly), and exact zeros for a group without members
    or with only zero weights; returns the largest absolute error."""
    worst = 0.0
    for case, (x, w, g, m) in cases.items():
        out = ha.segment_sum(x, w, g, m)
        again = ha.segment_sum(x, w, g, m)
        acc = ha.segment_sum(x, w, g, m, out=torch.full_like(out, 0.5))
        ref = ha.segment_sum_plain(x, w, g, m)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"segment_sum on {case}: two "
              "launches differ")
        check(torch.equal(acc, 0.5 + out), f"segment_sum on {case}: the "
              "chunk sum is not formed first and then added")
        check(out.dtype == torch.float32 and tuple(out.shape) ==
              (m, x.shape[1]), f"segment_sum on {case}: dtype/shape")
        check(bool(torch.isfinite(out).all()), f"segment_sum on {case}: "
              "finite")
        err = _max_err(out, ref)
        scale = float(ref.abs().max())
        check(err <= KERNEL_RTOL * scale,
              f"segment_sum on {case}: max|err| {err:.3e} > "
              f"{KERNEL_RTOL} x {scale:.3e}")
        worst = max(worst, err)
        slices, _, warps = ha.segment_sum_plan(*x.shape, m)
        print(f"  {'segment_sum':17s} {case:22s} max|err| {err:.3e} "
              f"(scale {scale:.3e}; {slices} row slices, {warps} warps a "
              f"block, loads of {ha.load_width(x.shape[1], x.element_size(), x.data_ptr())})")
        zero = {"group_without_members": m - 1,
                "group_all_zero_weight": 2}.get(case)
        if zero is not None:
            check(bool((out[zero] == 0).all()),
                  f"segment_sum on {case}: group {zero} is not exactly 0")
            print(f"  {'segment_sum':17s} {case:22s} group {zero} gives "
                  "exactly 0")
    return worst


def time_segment_sum(x, w, g, m) -> dict:
    """``segment_sum`` as the accumulator calls it (adding into an (M, F)
    accumulator), its plain version and the library yardstick: one
    ``torch.mm`` of the (M, N) weighted one-hot with the chunk; the
    wrapper's host time per call and the kernels one call launches."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)   # > 50 MB L2
    n, f = x.shape
    acc = torch.zeros(m, f, device=x.device)
    onehot = torch.zeros(m, n, device=x.device)
    onehot[g.long(), torch.arange(n, device=x.device)] = w
    ref = ha.segment_sum_plain(x, w, g, m)
    check(_max_err(torch.mm(onehot, x), ref)
          <= KERNEL_RTOL * float(ref.abs().max()),
          "torch.mm with the weighted one-hot computes segment_sum")
    flops, nbytes = ha.segment_sum_cost(x, w, g, m)
    launched = kernels_per_call(lambda: ha.segment_sum(x, w, g, m, out=acc),
                                flush)
    r = dict(ms=time_ms(lambda: ha.segment_sum(x, w, g, m, out=acc), flush),
             plain_ms=time_ms(lambda: ha.segment_sum_plain(x, w, g, m),
                              flush),
             library_ms=time_ms(lambda: torch.mm(onehot, x), flush),
             **bound(nbytes, flops))
    print(f"  {'segment_sum':17s} N={n} F={f} M={m}: kernel "
          f"{r['ms'] * 1e3:8.2f} us   plain {r['plain_ms'] * 1e3:8.2f} us"
          f"   torch.mm {r['library_ms'] * 1e3:8.2f} us   bound "
          f"{r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']}, {nbytes} B); "
          f"host {host_us(lambda: ha.segment_sum(x, w, g, m, out=acc)):.2f}"
          f" us a call; one call profiled: {launched_line(launched)}")
    return r


def time_slice_rule(x, w, g, m) -> None:
    """``segment_sum`` with the row slices its rule picks
    (``hier_aggregate.segment_sum_plan``: about a block per SM) against
    half and twice as many, on the same inputs, so that the rule is
    checked on every run."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)
    acc = torch.zeros(m, x.shape[1], device=x.device)
    n = x.shape[0]
    chosen = ha.segment_sum_plan(*x.shape, m)[0]
    times = []
    for slices in (max(1, chosen // 2), chosen, 2 * chosen):
        rows = -(-n // slices)
        slices = -(-n // rows)
        plan = (slices, rows, ha.block_warps(
            rows, slices * -(-x.shape[1] // ha.TILE), m * ha.TILE))
        with mock.patch.object(ha, "segment_sum_plan", lambda *_: plan):
            times.append((plan, time_ms(
                lambda: ha.segment_sum(x, w, g, m, out=acc), flush)))
    print("  segment_sum       slices: " + ", ".join(
        f"{s} of {r} rows, {k} warps -> {t * 1e3:.2f} us"
        for (s, r, k), t in times) + f" (the rule picks {chosen})")


def time_aggregate_warps_rule(x, w, g, m, name="segment_aggregate") -> None:
    """``segment_aggregate`` (or ``cloud_aggregate``) with the warps a
    block its rule picks (``hier_aggregate.segment_aggregate_warps`` or
    ``cloud_aggregate_warps``) against half and twice as many, on the same
    inputs."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)
    if name == "segment_aggregate":
        chosen = ha.segment_aggregate_warps(*x.shape, m)
        call = lambda: ha.segment_aggregate(x, w, g, m)  # noqa: E731
    else:
        chosen = ha.cloud_aggregate_warps(*x.shape)
        call = lambda: ha.cloud_aggregate(x, w)  # noqa: E731
    times = []
    for warps in sorted({max(1, chosen // 2), chosen,
                         min(ha.MAX_WARPS, 2 * chosen)}):
        with mock.patch.object(ha, f"{name}_warps", lambda *_: warps):
            times.append((warps, time_ms(call, flush)))
    print(f"  {name} N={x.shape[0]} warps: " + ", ".join(
        f"{k} -> {t * 1e3:.2f} us" for k, t in times)
        + f" (the rule picks {chosen})")


def fleet_shard(rank: int):
    """Rank ``rank``'s fleet-scale shard (FLEET_ROWS x LENET_PARAMS fp32)
    and its weights in [0.5, 2), made on the card from a generator keyed
    by (FLEET_SEED, rank)."""
    seed = int(np.random.SeedSequence([FLEET_SEED, rank])
               .generate_state(1)[0])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(FLEET_ROWS, LENET_PARAMS, generator=gen, device="cuda")
    w = torch.rand(FLEET_ROWS, generator=gen, device="cuda") * 1.5 + 0.5
    return x, w


def mean_cases():
    """name -> (x, w) for ``weighted_mean`` on the card: phase 9's slab,
    the edge cases (row views from an odd row among them), then a
    fleet-scale shard in fp32 and bf16."""
    rng = np.random.default_rng(2)
    cases = {}
    for name, n, f, edit in [
            ("slab_n60_f44426", SHARD_ROWS, LENET_PARAMS, None),
            ("one_row", 1, 1001, None),
            ("n513_past_tpu_split", 513, 1001, None),
            ("ragged_n1030_f1001", 1030, 1001, None),
            ("one_nonzero_weight", 300, 1001, "one"),
            ("all_zero_weights", 40, 300, "zero"),
            ("bf16_n513", 513, 1001, "bf16"),
            ("odd_row_view_f44426", 100, 44_426, "odd_row"),
            ("bf16_odd_row_view", 100, 44_426, "bf16_odd_row")]:
        odd = bool(edit) and "odd_row" in edit
        x = torch.from_numpy(rng.normal(0, 1, (n + odd, f))
                             .astype(np.float32))
        w = torch.from_numpy(rng.uniform(200, 1000, n).astype(np.float32))
        if edit in ("bf16", "bf16_odd_row"):
            x = x.to(torch.bfloat16)
        if edit == "one":
            w[:] = 0.0
            w[n // 2] = 3.0
        if edit == "zero":
            w[:] = 0.0
        # a row view from row 1, as in kernel_cases
        cases[name] = (x.cuda()[1:] if odd else x.cuda(), w.cuda())
    x, w = fleet_shard(0)
    cases["fleet_n16384_f44426"] = (x, w)
    cases["bf16_fleet"] = (x.to(torch.bfloat16), w)
    return cases


def counters_at_zero() -> bool:
    """The tile counters of ``segment_sum`` and ``weighted_mean`` on the
    card (if a launch has made them) are all 0, as every launch leaves
    them."""
    return all(int(c.count_nonzero()) == 0 for c, _ in ha._scratch.values())


def plan_line(x) -> str:
    slices, rows, warps = ha.weighted_mean_plan(*x.shape)
    return f"{slices} row slices of {rows}, {warps} warps a block"


def check_mean_against_plain(cases) -> float:
    """``weighted_mean`` on each case against its plain version, bit for
    bit between two launches, NaN for all-zero weights (0/0, as the
    reference), the tile counters back at 0 after each case; returns the
    largest absolute error."""
    worst = 0.0
    for case, (x, w) in cases.items():
        out = ha.weighted_mean(x, w)
        again = ha.weighted_mean(x, w)
        ref = ha.weighted_mean_plain(x, w)
        torch.cuda.synchronize()
        check(counters_at_zero(), f"weighted_mean on {case}: tile counters "
              "not back at 0")
        check(out.dtype == torch.float32 and tuple(out.shape) ==
              (x.shape[1],), f"weighted_mean on {case}: dtype/shape")
        if case == "all_zero_weights":
            check(bool(out.isnan().all()), "weighted_mean: all-zero weights "
                  "do not give NaN")
            print(f"  {'weighted_mean':17s} {case:22s} gives NaN (0/0), as "
                  "the reference")
            continue
        check(bool(torch.isfinite(out).all()), f"weighted_mean on {case}: "
              "finite")
        check(torch.equal(out, again), f"weighted_mean on {case}: two "
              "launches differ")
        err = _max_err(out, ref)
        scale = float(ref.abs().max())
        check(err <= KERNEL_RTOL * scale, f"weighted_mean on {case}: max|err| "
              f"{err:.3e} > {KERNEL_RTOL} x {scale:.3e}")
        if case == "one_nonzero_weight":
            row = x[x.shape[0] // 2].float()
            check(_max_err(out, row) <= KERNEL_RTOL * scale,
                  "weighted_mean: one nonzero weight gives that row")
        worst = max(worst, err)
        print(f"  {'weighted_mean':17s} {case:22s} max|err| {err:.3e} "
              f"(scale {scale:.3e}; {plan_line(x)}; loads of "
              f"{ha.load_width(x.shape[1], x.element_size(), x.data_ptr())})")
    return worst


def time_mean(x, w, note: str = "") -> dict:
    """``weighted_mean``, its plain version and, for fp32, the library
    yardstick ``torch.mv(x.t(), w) / w.sum()``, and its bound from this
    input's bytes (the slab and w read once, the mean written once) and
    operations; ``note`` is printed after them."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)   # > 50 MB L2
    n, f = x.shape
    fp32 = x.dtype == torch.float32

    def library():
        return torch.mv(x.t(), w) / w.sum()

    if fp32:
        ref = ha.weighted_mean_plain(x, w)
        check(_max_err(library(), ref) <= KERNEL_RTOL * float(
            ref.abs().max()), "torch.mv computes the weighted mean")
    flops, nbytes = ha.weighted_mean_cost(x, w)
    r = dict(ms=time_ms(lambda: ha.weighted_mean(x, w), flush),
             plain_ms=time_ms(lambda: ha.weighted_mean_plain(x, w), flush),
             library_ms=time_ms(library, flush) if fp32 else None,
             **bound(nbytes, flops))
    lib = (f"torch.mv {r['library_ms'] * 1e3:9.2f} us" if fp32 else
           "torch.mv (fp32 only)")
    print(f"  {'weighted_mean':17s} N={n} F={f} {str(x.dtype)[6:]}: kernel "
          f"{r['ms'] * 1e3:9.2f} us   plain {r['plain_ms'] * 1e3:9.2f} us   "
          f"{lib}   bound {r['bound_ms'] * 1e3:8.2f} us ({r['bound_by']})"
          f"{note}")
    return r


def time_mean_slice_rule(x, w) -> None:
    """``weighted_mean`` with the split its plan picks
    (``hier_aggregate.weighted_mean_plan``: slices and warps a block)
    against half and twice its slices at its warps, and at 4, 8 and 16
    warps a block against the slices that fill 1, 2, 4, 8 and 16 waves, on
    the same inputs."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)
    n, f = x.shape
    tiles = -(-f // ha.TILE)
    chosen, _, warps = ha.weighted_mean_plan(n, f)
    splits = {(max(1, chosen // 2), warps), (chosen, warps),
              (2 * chosen, warps)}
    for k in (4, 8, 16):
        wave = ha.NUM_SMS * (ha.ONE_GROUP_RESIDENT_WARPS // k) // tiles
        splits |= {(max(waves, waves * wave), k)
                   for waves in (1, 2, 4, 8, 16)}
    times = []
    for slices, k in sorted(splits, key=lambda s: (s[1], s[0])):
        rows = -(-n // slices)
        plan = (-(-n // rows), rows, k)
        with mock.patch.object(ha, "weighted_mean_plan", lambda *_: plan):
            times.append((plan, time_ms(lambda: ha.weighted_mean(x, w),
                                        flush)))
    print(f"  weighted_mean     N={n} {str(x.dtype)[6:]} splits: " + ", ".join(
        f"{s} x {k} warps -> {t * 1e3:.2f} us" for (s, _, k), t in times)
        + f" (the plan picks {chosen} x {warps} warps)")


# B, Sq, Sk, H, K, hd, causal, window: tests/test_kernels.py's ATTN_CASES,
# then MQA at head_dim 256 under a window, ragged Sq < Sk, a first key tile
# fully masked for most rows of a query tile, two non-causal cases, groups
# of 6 and 16 that do not fill a block's rows evenly, one query row at
# g = 16, head_dim 4, a window under one key tile, and the prefill shapes
# of phases 7 and 8 and of the serving CLI's default run.
ATTN_SERVING = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 1, 256, True,
                2048)
ATTN_GLM = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 2, 128, True, 0)
ATTN_CLI = (CLI_BATCH, CLI_PROMPT, CLI_PROMPT, 32, 32, 64, True, 0)
ATTN_CASES = [
    (2, 128, 128, 8, 4, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 64),
    (2, 100, 100, 8, 2, 64, True, 0),
    (1, 1, 384, 8, 8, 64, True, 0),
    (1, 1, 250, 4, 2, 32, True, 0),
    (1, 1, 512, 4, 4, 64, True, 128),
    (2, 64, 64, 8, 1, 128, True, 0),
    (1, 192, 192, 6, 3, 32, True, 48),
    (1, 300, 300, 16, 1, 256, True, 128),
    (2, 77, 333, 4, 2, 32, True, 0),
    (1, 256, 256, 4, 1, 64, True, 40),
    (2, 200, 200, 8, 2, 64, False, 0),
    (1, 70, 300, 4, 1, 100, False, 0),
    (2, 100, 100, 12, 2, 128, True, 0),
    (1, 90, 90, 12, 2, 64, True, 20),
    (1, 50, 300, 16, 1, 128, True, 0),
    (2, 1, 200, 16, 1, 256, True, 64),
    (1, 40, 40, 4, 2, 4, True, 0),
    (1, 200, 200, 8, 2, 64, True, 7),
    ATTN_SERVING,
    ATTN_GLM,
    ATTN_CLI,
]
# B, S, D: tests/test_kernels.py's RGLRU_CASES, then the serving shape
SCAN_SERVING = (SERVE_BATCH, SERVE_PROMPT, 4096)
SCAN_CASES = [(2, 64, 128), (1, 300, 96), (3, 17, 8), (1, 512, 256),
              SCAN_SERVING]
SCAN_RTOL = 1e-5             # of the largest |h|: chunked sequential kernel
                             # against the plain log-depth scan


def attn_inputs(case, dtype=torch.float32):
    """q, k, v of ``case`` on the card, from a seed; with ``"fused"`` among
    its tags, views into one (B, S, H + 2K, hd) projection (Sq = Sk)."""
    B, Sq, Sk, H, K, hd = case[:6]
    gen = torch.Generator(device="cuda").manual_seed(Sq * 7 + Sk + hd)
    if "fused" in case[8:]:
        fused = torch.randn((B, Sq, H + 2 * K, hd), generator=gen,
                            device="cuda").to(dtype)
        return fused[:, :, :H], fused[:, :, H:H + K], fused[:, :, H + K:]
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                 for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))


def bf16_attention_cases() -> list:
    """B, Sq, Sk, H, K, hd, causal, window, tags: the bf16 kernel's cases
    (as ``tests/test_torch_kernels.py``'s): InternVL2-26B's prefill (its
    full group of 6 over 8 KV heads at S = 4,096), head dims 32, 64, 256,
    a window, Whisper's bidirectional 1,500, Sq < Sk, the fused-view
    layout, phase 19 (b)'s local prefill and the serving CLI's (blocks of
    32 live rows), one query row (16)."""
    return [c + ("bf16",) for c in (
        ATTN_VLM, (2, 128, 128, 8, 4, 64, True, 0),
        (1, 300, 300, 16, 1, 256, True, 128),
        (2, 300, 300, 12, 2, 32, True, 0), (2, 200, 200, 4, 2, 256, True, 0),
        (1, 600, 600, 12, 2, 128, True, 100),
        (2, 1500, 1500, 8, 8, 64, False, 0),
        (2, 77, 333, 12, 2, 128, True, 0), ATTN_MESH_LOCAL,
        (CLI_BATCH, CLI_PROMPT, CLI_PROMPT, 32, 32, 64, True, 0),
        (1, 1, 384, 8, 8, 64, True, 0))] + [
        (2, 96, 96, 12, 2, 128, True, 32, "bf16", "fused")]


def check_attention_against_plain(cases=None) -> dict:
    """``flash_attention`` on each case (ATTN_CASES and
    ``bf16_attention_cases`` by default) against its plain version (fp32
    within ATTN_ATOL; bf16 each element within one bf16 ulp of itself plus
    BF16_FLOOR of the largest value, and within 2 bf16 ulps of the largest
    value) and bit for bit between two launches; returns the largest
    absolute error of each dtype (``fp32``, ``bf16``)."""
    worst = {"fp32": 0.0, "bf16": 0.0}
    if cases is None:
        cases = ATTN_CASES + bf16_attention_cases()
    for case in cases:
        causal, window = case[6], case[7]
        bf16 = "bf16" in case[8:]
        q, k, v = attn_inputs(case, torch.bfloat16 if bf16 else torch.float32)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        again = fa.flash_attention(q, k, v, causal=causal, window=window)
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(out.shape == q.shape and out.dtype == q.dtype,
              f"flash_attention {case}: dtype/shape")
        check(bool(torch.isfinite(out).all()), f"flash_attention {case}: "
              "finite")
        check(torch.equal(out, again), f"flash_attention {case}: two "
              "launches differ")
        err = _max_err(out.float(), ref.float())
        scale = float(ref.float().abs().max())
        tol = 2 * 2 ** -8 * scale if bf16 else ATTN_ATOL
        check(err <= tol, f"flash_attention {case}: max|err| {err:.3e} > "
              f"{tol:.3e}")
        note = ""
        if bf16:
            # the worst element against its own allowance
            share = float(((out.float() - ref.float()).abs() / (
                2 ** -7 * ref.float().abs() + BF16_FLOOR * scale)).max())
            check(share <= 1.0, f"flash_attention {case}: an element is "
                  f"{share:.3f} of its allowance (one bf16 ulp of itself "
                  f"plus {BF16_FLOOR:g} of the scale) off")
            note = (f"; {err / (tol / 2):.3f} bf16 ulps of the scale; worst "
                    f"element {share:.3f} of its own allowance; blocks of "
                    f"{fa.bf16_block_rows(*case[:2], *case[3:6])} rows")
        kind = "bf16" if bf16 else "fp32"
        worst[kind] = max(worst[kind], err)
        print(f"  {'flash_attention':17s} {'-'.join(map(str, case)):32s} "
              f"max|err| {err:.3e} (scale {scale:.3e}; tolerance "
              f"{tol:.3e}{note})")
    return worst


def scan_inputs(case):
    gen = torch.Generator(device="cuda").manual_seed(sum(case))
    a = torch.rand(case, generator=gen, device="cuda") * 0.299 + 0.7
    return a, torch.randn(case, generator=gen, device="cuda")


def check_scan_against_plain() -> float:
    """``rglru_scan`` on each case against its plain version, within
    SCAN_RTOL of the largest |h|, and bit for bit between two launches;
    returns the largest absolute error."""
    worst = 0.0
    for case in SCAN_CASES:
        a, b = scan_inputs(case)
        out = rs.rglru_scan(a, b)
        again = rs.rglru_scan(a, b)
        ref = rs.rglru_scan_plain(a, b)
        torch.cuda.synchronize()
        check(out.shape == a.shape and out.dtype == torch.float32,
              f"rglru_scan {case}: dtype/shape")
        check(bool(torch.isfinite(out).all()), f"rglru_scan {case}: finite")
        check(torch.equal(out, again), f"rglru_scan {case}: two launches "
              "differ")
        err = _max_err(out, ref)
        scale = float(ref.abs().max())
        check(err <= SCAN_RTOL * scale, f"rglru_scan {case}: max|err| "
              f"{err:.3e} > {SCAN_RTOL} x {scale:.3e}")
        worst = max(worst, err)
        print(f"  {'rglru_scan':17s} {'-'.join(map(str, case)):32s} "
              f"max|err| {err:.3e} (scale {scale:.3e}; "
              f"{rs.scan_chunks(*case)} chunks)")
    return worst


def bound(nbytes: float, flops: float,
          flops_per_s: float = PEAK_FLOPS_FP32) -> dict:
    """The least time of a kernel's work: its bytes (from its wrapper's
    cost function, ``*_cost``) at the HBM rate or its FLOPs at
    ``flops_per_s``, whichever is longer."""
    bytes_ms = nbytes / HBM_BW * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def expand_heads(t, heads: int):
    """(B, S, K, hd) -> (B, heads, S, hd), each KV head repeated for its
    query heads: a view for K = 1 (stride 0), a copy otherwise."""
    B, S, K, hd = t.shape
    return t.transpose(1, 2)[:, :, None].expand(
        B, K, heads // K, S, hd).reshape(B, heads, S, hd)


def attention_yardsticks(q, k, v, causal: bool, window: int) -> dict:
    """name -> one ``scaled_dot_product_attention`` call computing
    ``flash_attention``'s function, in the (B, Sq, H, hd) layout: with the
    boolean mask and the KV heads expanded (a copy made before the timed
    call); without a window, also with ``is_causal=True`` (no mask tensor,
    so the dead tiles can be skipped) on the expanded heads and, where this
    PyTorch takes it on the card, on the KV heads as they are with
    ``enable_gqa=True``; bidirectional without a window, also with no
    mask at all."""
    S, H = q.shape[1], q.shape[2]
    mask = fa.attention_mask(S, k.shape[1], causal, window, "cuda")
    qt, kt, vt = (expand_heads(t, H) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = {"sdpa_mask": lambda: sdpa(qt, kt, vt,
                                       attn_mask=mask).transpose(1, 2)}
    if not causal and window <= 0:
        calls["sdpa_no_mask"] = lambda: sdpa(qt, kt, vt).transpose(1, 2)
    if causal and window <= 0 and S == k.shape[1]:
        calls["sdpa_is_causal"] = lambda: sdpa(
            qt, kt, vt, is_causal=True).transpose(1, 2)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        try:
            sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
            torch.cuda.synchronize()
            calls["sdpa_is_causal_gqa"] = lambda: sdpa(
                qh, kh, vh, is_causal=True, enable_gqa=True).transpose(1, 2)
        except (TypeError, RuntimeError) as e:
            print(f"  {'flash_attention':17s} sdpa enable_gqa=True not "
                  f"taken: {type(e).__name__}: {str(e)[:120]}")
    return calls


def lib_tol(ref) -> float:
    """How far a library call may be from a plain version and still
    compute the same function: 1e-3 in fp32; 8 bf16 ulps of the largest
    value in bf16 (SDPA rounds its own intermediates)."""
    if ref.dtype == torch.bfloat16:
        return 8 * 2 ** -8 * float(ref.float().abs().max())
    return 1e-3


def bf16_bounds(r: dict, nbytes: float, flops: float) -> str:
    """Set ``r``'s bound at the bf16 tensor-core rate (the least time of
    the work on the card); returns the note printed after the kernel's
    line, which holds the kernel to that bound alone."""
    r.update(bound(nbytes, flops, PEAK_FLOPS_BF16))
    return f" (bf16: bound at {PEAK_FLOPS_BF16:.4g} FLOP/s)"


def time_attention(case, dtype=torch.float32) -> dict:
    """``flash_attention`` at a serving shape, its plain version, the
    library yardsticks (``attention_yardsticks``, each checked against the
    plain version; ``library_ms`` is the fastest), and its bound from the
    unmasked (query, key) pairs of this shape: in bf16 at the bf16
    tensor-core rate."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    B, S, _, H, K, hd, causal, window = case
    q, k, v = attn_inputs(case, dtype)
    calls = attention_yardsticks(q, k, v, causal, window)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    for name, call in calls.items():
        lib_err = _max_err(call().float(), ref.float())
        print(f"  {'flash_attention':17s} {name} vs plain max|err| "
              f"{lib_err:.3e}")
        check(lib_err <= lib_tol(ref), f"{name} computes the same function")
    del ref
    iters = 10 if S > 256 else 100     # the CLI's prompt: microseconds
    lib = {name: time_ms(call, flush, iters, 2)
           for name, call in calls.items()}
    fastest = min(lib, key=lib.get)
    flops, nbytes = fa.flash_attention_cost(q, k, v, causal=causal,
                                            window=window)
    pairs = flops // (4 * hd)
    r = dict(ms=time_ms(lambda: fa.flash_attention(
                 q, k, v, causal=causal, window=window), flush, iters, 2),
             plain_ms=time_ms(lambda: fa.flash_attention_plain(
                 q, k, v, causal=causal, window=window), flush, iters // 2,
                 1),
             library_ms=lib[fastest], **bound(nbytes, flops))
    extra = (bf16_bounds(r, nbytes, flops)
             if dtype == torch.bfloat16 else "")
    print(f"  {'flash_attention':17s} {'-'.join(map(str, case))}"
          f"{'-bf16' if extra else ''}: "
          f"kernel {r['ms']:.3f} ms   plain {r['plain_ms']:.3f} ms   "
          + "   ".join(f"{n} {t:.3f} ms" for n, t in lib.items())
          + f"   bound {r['bound_ms']:.3f} ms ({r['bound_by']}: {pairs} "
          f"unmasked pairs, {nbytes} B); kernel/bound "
          f"{r['ms'] / r['bound_ms']:.2f}, kernel/{fastest} "
          f"{r['ms'] / r['library_ms']:.2f}{extra}")
    return r


def time_warps_rule(case) -> None:
    """``flash_attention`` with every warps-per-block count the kernel
    takes (``min_warps`` to ``MAX_WARPS``; a block's rows are
    ``rows_per_warp`` x warps) on the same inputs, the rule's choice
    (``attention_warps``) among them with its half and its double where
    those exist, so that the rule is checked on every run.  Twice 8 warps
    is past the kernel's 256-thread bound."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    B, S, _, H, K, hd, causal, window = case
    q, k, v = attn_inputs(case)
    chosen = fa.attention_warps(B, S, H, K, hd)
    times = []
    for w in (1, 2, 4, 8):
        if not fa.min_warps(hd) <= w <= fa.MAX_WARPS:
            continue
        with mock.patch.object(fa, "attention_warps", lambda *_, w=w: w):
            times.append((w, time_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, window=window), flush,
                10 if S > 256 else 100, 2)))
    print(f"  {'flash_attention':17s} {'-'.join(map(str, case))} warps: "
          + ", ".join(f"{w} ({fa.rows_per_warp(hd) * w} rows) -> "
                      f"{t:.3f} ms" for w, t in times)
          + f" (the rule picks {chosen})")


def time_scan() -> dict:
    """``rglru_scan`` at the serving shape with the chunk count its rule
    picks, one chunk and twice the rule's count, its plain version, and
    its bound.  No single PyTorch call computes the recurrence."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    a, b = scan_inputs(SCAN_SERVING)
    chosen = rs.scan_chunks(*SCAN_SERVING)
    chunked = []
    for c in (1, chosen, 2 * chosen):
        with mock.patch.object(rs, "scan_chunks", lambda *_, c=c: c):
            chunked.append((c, time_ms(lambda: rs.rglru_scan(a, b), flush)))
    flops, nbytes = rs.rglru_scan_cost(a, b)
    r = dict(ms=chunked[1][1],
             plain_ms=time_ms(lambda: rs.rglru_scan_plain(a, b), flush, 20),
             library_ms=None, **bound(nbytes, flops))
    print(f"  {'rglru_scan':17s} {'-'.join(map(str, SCAN_SERVING))}: "
          f"kernel {r['ms'] * 1e3:.2f} us   plain {r['plain_ms'] * 1e3:.2f} "
          f"us   bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}); "
          "chunks: " + ", ".join(f"{c} -> {t * 1e3:.2f} us"
                                 for c, t in chunked)
          + f" (the rule picks {chosen})")
    return r


# B, W, H, K, hd, pos, window, slot layout: tests/test_kernels.py's
# DECODE_CASES, its ring-wrapped case, an empty cache, a view [l] of a
# stacked (L, B, W, 2, K, hd) cache, then the decode shapes of phases 7
# (the ring full) and 8 (4,097 of 8,192 slots written) and of the CLI's
# default model, then the most query heads a KV head, a head dim that is
# not a multiple of 8 and more (batch, KV head) pairs than SMs.
DECODE_SERVING = (SERVE_BATCH, 2048, 16, 1, 256, SERVE_PROMPT, 2048, "ring")
DECODE_GLM = (SERVE_BATCH, 2 * SERVE_PROMPT, 32, 2, 128, SERVE_PROMPT, 0,
              "prefix")
DECODE_CLI = (CLI_BATCH, 2 * CLI_PROMPT, 32, 32, 64, CLI_PROMPT, 0, "prefix")
DECODE_CASES = [
    (2, 256, 8, 4, 64, 100, 0, "prefix"),
    (1, 300, 4, 2, 32, 299, 0, "prefix"),
    (2, 512, 8, 8, 128, 400, 128, "prefix"),
    (1, 64, 4, 1, 64, 10, 0, "prefix"),
    (2, 32, 4, 2, 16, 40, 0, "ring"),
    (2, 64, 8, 2, 32, 0, 0, "empty"),
    (2, 96, 8, 2, 32, 71, 64, "stacked"),
    DECODE_SERVING,
    DECODE_GLM,
    DECODE_CLI,
    (2, 512, 64, 2, 128, 300, 0, "prefix"),        # 32 heads a KV head
    (2, 200, 12, 3, 100, 150, 0, "prefix"),        # a padded head dim
    (300, 64, 4, 2, 32, 40, 0, "prefix"),          # 600 (batch, KV head) pairs
]


def decode_inputs(case, dtype=torch.float32):
    """q, k_cache, v_cache, slot_pos, pos on the card, from a seed."""
    B, W, H, K, hd, pos, window, layout = case
    if layout == "prefix":
        sp = np.full(W, -10**9, np.int32)
        sp[:min(pos + 1, W)] = np.arange(min(pos + 1, W))
    elif layout == "empty":
        sp = np.full(W, -10**9, np.int32)
    else:
        sp = np.asarray([pos - ((pos - w) % W) for w in range(W)])
        sp = np.where(sp >= 0, sp, -10**9).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(W + H + hd)
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(dtype)
    sp = torch.from_numpy(sp).cuda()
    if layout == "stacked":
        kv = torch.randn((3, B, W, 2, K, hd), generator=gen,
                         device="cuda").to(dtype)
        poss = torch.tensor([pos - 1, pos, pos + 1], dtype=torch.int32,
                            device="cuda")
        return q, kv[1, :, :, 0], kv[1, :, :, 1], torch.stack(
            [sp - 1, sp, sp + 1])[1], poss[1]
    k, v = (torch.randn((B, W, K, hd), generator=gen, device="cuda").to(
        dtype) for _ in range(2))
    return q, k, v, sp, torch.tensor(pos, dtype=torch.int32, device="cuda")


def bf16_decode_cases() -> list:
    """The bf16 kernel's cases: every one of DECODE_CASES (its copies by
    TMA, and by threads at hd 100), then the bf16 paths' shapes (phase 17
    (c)'s InternVL2-26B, phase 19 (b)'s local Qwen1.5-MoE), Qwen3-32B's
    group of 8 and RecurrentGemma-9B's group of 16 at hd 256 under its
    2,048 window before the ring fills."""
    return [(c, True) for c in DECODE_CASES + [
        DECODE_VLM, DECODE_MESH_LOCAL,
        (2, 4096, 64, 8, 128, 2500, 0, "prefix"),
        (1, 2048, 16, 1, 256, 1500, 2048, "prefix")]]


def check_decode_against_plain(cases=None) -> dict:
    """``decode_attention`` on each case (DECODE_CASES in fp32 and
    ``bf16_decode_cases`` by default) against its plain version (fp32
    within KERNEL_RTOL of the output's scale; bf16 each element within one
    bf16 ulp of itself plus BF16_FLOOR of the largest value, and within 2
    bf16 ulps of the largest value), bit for bit between two launches,
    each call one launch of its dtype's kernel and none of the other's,
    and the empty cache equal to the mean of V; returns the largest
    absolute error of each dtype (``fp32``, ``bf16``)."""
    worst = {"fp32": 0.0, "bf16": 0.0}
    if cases is None:
        cases = [(c, False) for c in DECODE_CASES] + bf16_decode_cases()
    for case, bf16 in cases:
        window = case[6]
        args = decode_inputs(case, torch.bfloat16 if bf16 else torch.float32)
        kernel = "decode_attention_bf16" if bf16 else "decode_attention"
        want = dict(da.launch_counts)
        want[kernel] += 2
        out = da.decode_attention(*args, window=window)
        again = da.decode_attention(*args, window=window)
        ref = da.decode_attention_plain(*args, window=window)
        torch.cuda.synchronize()
        name = "-".join(map(str, case)) + ("-bf16" if bf16 else "")
        check(da.launch_counts == want, f"{kernel} {name}: launches "
              f"{da.launch_counts} != {want}")
        check(out.shape == args[0].shape and out.dtype == args[0].dtype,
              f"{kernel} {name}: dtype/shape")
        check(bool(torch.isfinite(out).all()), f"{kernel} {name}: finite")
        check(torch.equal(out, again), f"{kernel} {name}: two launches "
              "differ")
        err = _max_err(out.float(), ref.float())
        scale = float(ref.float().abs().max())
        tol = (2 * 2 ** -8 if bf16 else KERNEL_RTOL) * scale
        check(err <= tol, f"{kernel} {name}: max|err| {err:.3e} > "
              f"{tol:.3e}")
        note = ""
        if bf16:
            # the worst element against its own allowance
            share = float(((out.float() - ref.float()).abs() / (
                2 ** -7 * ref.float().abs() + BF16_FLOOR * scale)).max())
            check(share <= 1.0, f"{kernel} {name}: an element is "
                  f"{share:.3f} of its allowance (one bf16 ulp of itself "
                  f"plus {BF16_FLOOR:g} of the scale) off")
            note = f"; worst element {share:.3f} of its own allowance"
        if case[-1] == "empty":
            B, W, H, K, hd = case[:5]
            mean = args[2].float().mean(1).repeat_interleave(H // K, 1)[:, None]
            check(_max_err(out.float(), mean) <= (
                2 * 2 ** -8 if bf16 else KERNEL_RTOL) * scale,
                  f"{kernel}: an empty cache gives the mean of V")
        worst["bf16" if bf16 else "fp32"] = max(
            worst["bf16" if bf16 else "fp32"], err)
        splits, per = split_rule(case, bf16)
        print(f"  {kernel:17s} {name:32s} max|err| {err:.3e} "
              f"(scale {scale:.3e}; tolerance {tol:.3e}{note}; {splits} "
              f"splits of at most {per} tiles)")
    return worst


def decode_yardsticks(q, k, v, mask) -> dict:
    """name -> one ``scaled_dot_product_attention`` call computing
    ``decode_attention``'s function with the valid-slot boolean mask: on
    the KV heads expanded to the query heads (a copy made before the timed
    call) and, where this PyTorch takes it on the card, on the KV heads as
    they are with ``enable_gqa=True``."""
    H = q.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    m = mask[None, None, None]
    qt, kt, vt = (expand_heads(t, H) for t in (q, k, v))
    calls = {"sdpa_expanded": lambda: sdpa(qt, kt, vt,
                                           attn_mask=m).transpose(1, 2)}
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    try:
        sdpa(qh, kh, vh, attn_mask=m, enable_gqa=True)
        torch.cuda.synchronize()
        calls["sdpa_enable_gqa"] = lambda: sdpa(
            qh, kh, vh, attn_mask=m, enable_gqa=True).transpose(1, 2)
    except (TypeError, RuntimeError) as e:
        print(f"  {'decode_attention':17s} sdpa enable_gqa=True not taken: "
              f"{type(e).__name__}: {str(e)[:120]}")
    return calls


def split_rule(case, bf16: bool) -> tuple:
    """(splits, most tiles of a split) of ``decode_attention``'s kernel for
    the dtype at ``case``'s shape."""
    B, W, H, K = case[:4]
    if bf16:
        return da.decode_bf16_splits(B * K, W, H // K)
    return da.decode_splits(B * K, W)


def time_decode(case, dtype=torch.float32) -> dict:
    """``decode_attention`` at a serving decode shape (in bf16 its own
    kernel), its plain version, the library yardsticks
    (``decode_yardsticks``, each checked against the plain version;
    ``library_ms`` is the fastest) and its bound from the slots that count
    in this input: their K and V rows, q and the output (of q's dtype),
    slot_pos and pos; in bf16 at the bf16 tensor-core rate."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    B, W, H, K, hd, _, window, _ = case
    bf16 = dtype == torch.bfloat16
    kernel = "decode_attention_bf16" if bf16 else "decode_attention"
    q, k, v, sp, pos = decode_inputs(case, dtype)
    mask = da.valid_slots(sp, pos, window)
    calls = decode_yardsticks(q, k, v, mask)
    ref = da.decode_attention_plain(q, k, v, sp, pos, window=window)
    for name, call in calls.items():
        lib_err = _max_err(call().float(), ref.float())
        print(f"  {kernel:17s} {name} vs plain max|err| {lib_err:.3e}")
        check(lib_err <= (1e-4 if dtype == torch.float32 else lib_tol(ref)),
              f"{name} computes the same function")
    lib = {name: time_ms(call, flush) for name, call in calls.items()}
    fastest = min(lib, key=lib.get)
    n_valid = int(mask.sum())
    flops, nbytes = da.decode_attention_cost(q, k, v, sp, pos, window=window)
    r = dict(ms=time_ms(lambda: da.decode_attention(
                 q, k, v, sp, pos, window=window), flush),
             plain_ms=time_ms(lambda: da.decode_attention_plain(
                 q, k, v, sp, pos, window=window), flush),
             library_ms=lib[fastest], **bound(nbytes, flops))
    extra = bf16_bounds(r, nbytes, flops) if bf16 else ""
    splits, per = split_rule(case, bf16)
    print(f"  {kernel:17s} {'-'.join(map(str, case))}"
          f"{'-bf16' if extra else ''}: "
          f"kernel {r['ms'] * 1e3:.2f} us   plain {r['plain_ms'] * 1e3:.2f} "
          "us   " + "   ".join(f"{n} {t * 1e3:.2f} us" for n, t in lib.items())
          + f"   bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}: "
          f"{n_valid} of {W} slots count, {nbytes} B; {splits} splits of at "
          f"most {per} tiles); "
          f"kernel/bound {r['ms'] / r['bound_ms']:.2f}, kernel/{fastest} "
          f"{r['ms'] / r['library_ms']:.2f}{extra}")
    return r


def time_split_rule(case, dtype=torch.float32) -> None:
    """``decode_attention`` with the split count its rule picks (fp32:
    ``decode_attention.decode_splits``, bf16: ``decode_bf16_splits``, a
    block per SM) against half and twice as many splits, on the same
    inputs, so that the rule is checked on every run.  Twice is left out
    where it would give a split no tile; where it asks for more blocks than
    the card holds at once, the cooperative launch is refused, and that is
    printed."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    B, W, H, K, hd, _, window, _ = case
    bf16 = dtype == torch.bfloat16
    kernel = "decode_attention_bf16" if bf16 else "decode_attention"
    rule = "decode_bf16_splits" if bf16 else "decode_splits"
    q, k, v, sp, pos = decode_inputs(case, dtype)
    tiles = -(-W // (da.BF16_TILE if bf16 else da.TILE))
    chosen = split_rule(case, bf16)[0]
    times = []
    for splits in (max(1, chosen // 2), chosen, 2 * chosen):
        if splits > tiles:
            continue
        split = (splits, -(-tiles // splits))
        with mock.patch.object(da, rule, lambda *_: split), \
                mock.patch.dict(da._plans, clear=True):
            try:
                times.append((split, time_ms(lambda: da.decode_attention(
                    q, k, v, sp, pos, window=window), flush)))
            except RuntimeError as e:
                print(f"  {kernel:17s} {splits} splits: {e}")
    print(f"  {kernel:17s} {'-'.join(map(str, case))} splits: "
          + ", ".join(f"{n} (at most {p} tiles) -> {t * 1e3:.2f} us"
                      for (n, p), t in times)
          + f" (the rule picks {chosen})")


# ---------------------------------------------------------------------------
# Phases 3-4
# ---------------------------------------------------------------------------


def main_path_inputs():
    prob = HFLProblem(**MAIN)
    t0 = time.perf_counter()
    sch = plan(prob)
    plan_s = time.perf_counter() - t0
    train, test = synthetic_mnist(seed=0)
    parts = size_partition(np.random.default_rng(0), len(train["labels"]),
                           prob.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    return sch, plan_s, ue_data, test


def lenet_params(device, noise=0.0, noise_seed=1) -> dict:
    """Full-width LeNet from seed 0 on ``device``, each parameter moved by
    ``noise`` relative (a draw of ``noise_seed``) if asked."""
    init = lenet_init(torch.Generator().manual_seed(0), LeNetConfig(),
                      device="cpu")
    if noise:
        gen = torch.Generator().manual_seed(noise_seed)
        init = {k: {kk: v * (1 + noise * torch.randn(v.shape, generator=gen))
                    for kk, v in layer.items()} for k, layer in init.items()}
    return {k: {kk: v.to(device) for kk, v in layer.items()}
            for k, layer in init.items()}


def make_sim(sch, ue_data, device, noise=0.0, noise_seed=1, **kw):
    return HFLSimulator(sch, lenet_loss, lenet_params(device, noise,
                                                      noise_seed),
                        ue_data, lr=LR, samples_per_ue=SAMPLES_PER_UE,
                        device=device, **kw)


def phase_main_path(sch, plan_s, ue_data, test):
    rounds = ROUNDS
    print(f"plan: a*={sch.a} b*={sch.b} R={sch.rounds} "
          f"T={sch.cloud_round_time!r} s ({plan_s:.3f} s to plan); "
          f"{sch.num_edges} edges x {sch.num_ues} UEs")
    sim = make_sim(sch, ue_data, "cuda")
    print(f"flat buffer {tuple(sim._flat.shape)} fp32 on "
          f"{sim._flat.device}; LeNetConfig() full width; "
          f"{SAMPLES_PER_UE} samples per UE; {rounds} cloud rounds "
          f"(a*b* = {sch.a * sch.b} GD steps each)")
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    res = sim.run(test, rounds=rounds, verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = tracing.launches()
    print(f"main path: {run_s:.3f} s for {rounds} cloud rounds "
          f"({run_s / rounds:.3f} s per round, first-call warm-up included)")
    print(f"launches during the main path: {launches}")
    check(launches == expect(segment_aggregate=sch.b * rounds,
                             cloud_aggregate=rounds),
          f"launch counts {launches} != b*rounds={sch.b * rounds}, "
          f"rounds={rounds}")
    check(bool(np.isfinite(res.test_loss).all()
               and np.isfinite(res.train_loss).all()), "finite losses")
    check(all(bool(torch.isfinite(t).all())
              for t in tree_leaves(res.final_params)), "finite params")
    t0 = time.perf_counter()
    sim.run(test, rounds=1)
    torch.cuda.synchronize()
    print(f"one more cloud round, warm: {time.perf_counter() - t0:.3f} s")
    profile_round(sim, test)
    return launches, res.times


def run_summary(res) -> dict:
    """A ``SimResult``'s curves and final params, on the host."""
    return dict(test_acc=res.test_acc, test_loss=res.test_loss,
                train_loss=res.train_loss,
                final=[t.cpu() for t in tree_leaves(res.final_params)])


def device_profile(fn):
    """Run ``fn`` once under ``torch.profiler``; returns the wall time in
    us and the device kernels that took time (``key_averages`` entries).
    The device's activity alone is recorded: with the host's too, a warm
    LeNet round on an H100 took 17.2 s to summarise, against 4.5 s, for
    the same kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total > 0]


def print_top(kernels, top: int) -> None:
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def profile_round(sim, test, top: int = 8) -> None:
    """Where a warm cloud round's device time goes (``torch.profiler``):
    device-busy share of the wall time, the aggregation kernels' share,
    and the kernels that take the most device time."""
    wall_us, kernels = device_profile(lambda: sim.run(test, rounds=1))
    if not kernels:
        print("profiled round: the profiler recorded no device time")
        return
    busy_us = sum(e.self_device_time_total for e in kernels)
    agg_us = sum(e.self_device_time_total for e in kernels
                 if "aggregate_kernel" in e.key)
    print(f"profiled round: {wall_us / 1e6:.3f} s wall (profiler on), "
          f"device busy {busy_us / 1e6:.3f} s = {busy_us / wall_us:.1%}; "
          f"aggregation kernels {agg_us / 1e3:.3f} ms = "
          f"{agg_us / busy_us:.2%} of device time; "
          f"{sum(e.count for e in kernels)} kernel launches")
    print_top(kernels, top)


def sub_problem(sch, ue_data):
    """Edge CPU_EDGE's first CPU_UES UEs alone at phase 3's (a*, b*): the
    cohort of phase 4's card-against-CPU round (its weights are the UEs'
    sample counts, their D_n)."""
    idx = np.flatnonzero(sch.assoc[:, CPU_EDGE])[:CPU_UES]
    sub = dataclasses.replace(
        sch, assoc=sch.assoc[idx][:, [CPU_EDGE]],
        edge_round_time=sch.edge_round_time[[CPU_EDGE]], problem=None)
    return sub, [ue_data[i] for i in idx]


def phase_card_vs_cpu(sch, ue_data, test):
    """One cloud round from the same init on the card and the CPU, on edge
    CPU_EDGE's cohort, held to SENSITIVITY_FACTOR times the CPU's spread
    under a SENSITIVITY_NOISE init move.  Returns phase 5's references:
    the full cohort's round on the card and its spread on the card (cuDNN's
    deterministic algorithms, so the spread is the move's alone)."""
    def final(schedule, data, device, noise=0.0):
        t0 = time.perf_counter()
        res = make_sim(schedule, data, device, noise=noise).run(test,
                                                                rounds=1)
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"  one cloud round, {schedule.num_ues} UEs on {device}"
              f"{' (init moved by %g)' % noise if noise else ''}: "
              f"{time.perf_counter() - t0:.2f} s, test loss "
              f"{float(res.test_loss[-1])!r}")
        return [t.cpu() for t in tree_leaves(res.final_params)]

    sub, sub_data = sub_problem(sch, ue_data)
    check(np.array_equal([len(d["labels"]) for d in sub_data],
                         sch.problem.samples[np.flatnonzero(
                             sch.assoc[:, CPU_EDGE])[:CPU_UES]]),
          "the sub-problem's weights are not its UEs' D_n")
    torch.set_num_threads(os.cpu_count() or 1)
    gpu, cpu = final(sub, sub_data, "cuda"), final(sub, sub_data, "cpu")
    cpu_moved = final(sub, sub_data, "cpu", noise=SENSITIVITY_NOISE)
    diff = max(_max_err(a, b) for a, b in zip(gpu, cpu))
    spread = max(_max_err(a, b) for a, b in zip(cpu, cpu_moved))
    scale = max(float(t.abs().max()) for t in cpu)
    print(f"  card vs CPU, edge {CPU_EDGE}'s {sub.num_ues} UEs: max|diff| "
          f"{diff:.3e}; CPU spread under a {SENSITIVITY_NOISE:g} init move "
          f"{spread:.3e}; largest param {scale:.3e}")
    check(spread > 0, "the perturbed CPU run moved")
    check(diff <= SENSITIVITY_FACTOR * spread,
          f"card vs CPU {diff:.3e} > {SENSITIVITY_FACTOR} x CPU spread "
          f"{spread:.3e}")
    card_sync = final(sch, ue_data, "cuda")
    torch.backends.cudnn.deterministic = True
    try:
        base = final(sch, ue_data, "cuda")
        moved = final(sch, ue_data, "cuda", noise=SENSITIVITY_NOISE)
    finally:
        torch.backends.cudnn.deterministic = False
    full_spread = max(_max_err(a, b) for a, b in zip(base, moved))
    print(f"  the full cohort's spread on the card under a "
          f"{SENSITIVITY_NOISE:g} init move: {full_spread:.3e}")
    check(full_spread > 0, "the perturbed card run moved")
    return card_sync, full_spread


# ---------------------------------------------------------------------------
# Phases 5-6
# ---------------------------------------------------------------------------


def departure_waves(timeline) -> int:
    """Departure waves the async replay runs: the runs of departures that
    a cloud update closes."""
    waves, pending = 0, False
    for kind, _ in timeline.trace:
        if kind == "depart":
            pending = True
        elif kind == "update" and pending:
            waves, pending = waves + 1, False
    return waves


def phase_async(sch, ue_data, test, card_sync, spread) -> None:
    """Phase 5."""
    sim = make_sim(sch, ue_data, "cuda", mode="async",
                   max_staleness=ASYNC_STALENESS)
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    res = sim.run(test, rounds=ROUNDS, verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = tracing.launches()
    tl = res.timeline
    waves = departure_waves(tl)
    updates = len(tl.updates)
    print(f"async path: max_staleness={ASYNC_STALENESS}, {ROUNDS} rounds' "
          f"quota = {updates} cloud updates, {waves} departure waves")
    print(f"launches during the async path: {launches}")
    check(launches == expect(segment_aggregate=sch.b * waves),
          f"launch counts {launches} != b*waves={sch.b * waves}, 0, 0")
    check(bool(np.isfinite(res.test_loss).all()
               and np.isfinite(res.train_loss).all()), "async: finite losses")
    check(all(bool(torch.isfinite(t).all())
              for t in tree_leaves(res.final_params)), "async: finite params")
    bound = ROUNDS * sch.cloud_round_time
    print(f"async makespan {tl.makespan!r} s simulated against the eq. 34 "
          f"bound {bound!r} s ({bound / tl.makespan:.4f}x); wall "
          f"{run_s:.3f} s, {run_s / updates:.3f} s per cloud update "
          f"(first-call warm-up included)")
    barrier = make_sim(sch, ue_data, "cuda", mode="async", max_staleness=0)
    res0 = barrier.run(test, rounds=1)
    torch.cuda.synchronize()
    diff = max(_max_err(a.cpu(), b) for a, b in
               zip(tree_leaves(res0.final_params), card_sync))
    print(f"  async max_staleness=0 vs the card's sync round: max|diff| "
          f"{diff:.3e}; the card's spread (phase 4) {spread:.3e}")
    check(diff <= SENSITIVITY_FACTOR * spread,
          f"async barrier vs sync {diff:.3e} > {SENSITIVITY_FACTOR} x the "
          f"card's spread {spread:.3e}")


def stream_chunk(i: int, rows: int) -> torch.Tensor:
    """Chunk ``i`` of the streamed rows, made on the card from a generator
    keyed by (STREAM_SEED, i)."""
    seed = int(np.random.SeedSequence([STREAM_SEED, i]).generate_state(1)[0])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(rows, STREAM_COLS, generator=gen, device="cuda")


def phase_streaming() -> int:
    n, f, m, chunk = STREAM_ROWS, STREAM_COLS, STREAM_GROUPS, STREAM_CHUNK
    rng = np.random.default_rng(0)          # as benchmarks/bench_scale.py
    gid = torch.as_tensor(rng.integers(0, m, n).astype(np.int32),
                          device="cuda")
    w = torch.as_tensor(rng.uniform(0.5, 2.0, n).astype(np.float32),
                        device="cuda")
    acc = StreamingEdgeAccumulator(m, f, device="cuda")
    starts = range(0, n, chunk)
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    for i, start in enumerate(starts):
        stop = min(start + chunk, n)
        acc.add(stream_chunk(i, stop - start), w[start:stop],
                gid[start:stop])
    means = acc.edge_means()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tracing.launches()
    print(f"streaming: {n} rows x {f} fp32 in {len(starts)} chunks of "
          f"{chunk}, M={m}: {wall:.3f} s, {n / wall:.4g} rows/s (chunk "
          f"generation included); resident {acc.resident_bytes()} B, "
          f"chunk {chunk * f * 4} B, full buffer avoided {n * f * 4} B")
    print(f"launches during the streaming path: {launches}")
    check(launches == expect(segment_sum=len(starts)),
          f"launch counts {launches} != 0, 0, {len(starts)}")
    check(acc.resident_bytes() == m * f * 4 + m * 4,
          f"resident bytes {acc.resident_bytes()} != {m * f * 4 + m * 4}")
    num = torch.zeros(m, f, dtype=torch.float64, device="cuda")
    mass = torch.zeros(m, dtype=torch.float64, device="cuda")
    for i, start in enumerate(starts):
        stop = min(start + chunk, n)
        g, ww = gid[start:stop].long(), w[start:stop].double()
        num.index_add_(0, g, ww[:, None] * stream_chunk(i, stop - start)
                       .double())
        mass.index_add_(0, g, ww)
    ref = num / mass[:, None]
    check(bool(torch.isfinite(means).all()), "streaming: finite means")
    err = float((means.double() - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"  edge means vs float64 accumulation: max|err| {err:.3e} "
          f"(largest |mean| {scale:.3e})")
    check(err <= STREAM_RTOL * scale,
          f"streaming means: max|err| {err:.3e} > {STREAM_RTOL} x "
          f"{scale:.3e}")
    profile_chunks(w[:chunk], gid[:chunk])
    return launches["segment_sum"]


def profile_chunks(w, gid, chunks: int = 10) -> None:
    """``chunks`` chunks of phase 6 folded as the path folds them (each
    made on the card just before, so it may sit in L2), under
    ``torch.profiler``: ``segment_sum``'s device time a launch on the path
    and every kernel a fold launches."""
    acc = StreamingEdgeAccumulator(STREAM_GROUPS, STREAM_COLS, device="cuda")

    def fold():
        for i in range(chunks):
            acc.add(stream_chunk(i, STREAM_CHUNK), w, gid)

    fold()
    wall_us, kernels = device_profile(fold)
    k4 = [e for e in kernels if "segment_sum" in e.key
          or "sum_slices" in e.key]
    print(f"  profiled {chunks} chunks: {wall_us / chunks:.1f} us wall a "
          "chunk (profiler on); segment_sum on the path: "
          + "; ".join(f"{e.key[:60]} {e.count}x "
                      f"{e.self_device_time_total / e.count:.2f} us"
                      for e in k4))
    print_top(kernels, 8)


# ---------------------------------------------------------------------------
# Phase 7
# ---------------------------------------------------------------------------


def perturbed(params, seed: int = 1) -> dict:
    """``params`` with the embedding moved by SENSITIVITY_NOISE relative
    (a fresh tensor; the other leaves are shared)."""
    emb = params["embedding"]
    gen = torch.Generator(device=emb.device).manual_seed(seed)
    noise = torch.randn(emb.shape, generator=gen, device=emb.device)
    moved = noise.mul_(SENSITIVITY_NOISE).add_(1.0).mul_(emb)
    return dict(params, embedding=moved)


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def teacher_forced(model, params, state, tokens) -> list:
    """Decode logits of ``tokens`` (B, n) fed one at a time from ``state``."""
    out = []
    for i in range(tokens.shape[1]):
        logits, state = model.decode_step(params, state, tokens[:, i:i + 1])
        out.append(logits)
    return out


def max_diff(a, b) -> float:
    if isinstance(a, list):
        return max(max_diff(x, y) for x, y in zip(a, b))
    return _max_err(a.float(), b.float())


def print_serving_profile(kernels, wall_us, label) -> None:
    if not kernels:
        print(f"profiled {label}: the profiler recorded no device time")
        return
    busy_us = sum(e.self_device_time_total for e in kernels)
    groups = {"flash_attention": ("flash_attention_kernel",),
              "rglru_scan": ("scan_kernel", "chunk_summary_kernel"),
              "decode_attention": ("decode_attention_kernel",),
              "decode_attention_bf16": ("decode_attention_bf16_kernel",),
              "matrix products": ("gemm", "nvjet")}
    shares = {name: sum(e.self_device_time_total for e in kernels
                        if any(k in e.key.lower() for k in keys))
              for name, keys in groups.items()}
    counts = {name: sum(e.count for e in kernels
                        if any(k in e.key.lower() for k in keys))
              for name, keys in groups.items()}
    print(f"profiled {label}: {wall_us / 1e3:.3f} ms wall (profiler on), "
          f"device busy {busy_us / 1e3:.3f} ms = {busy_us / wall_us:.1%}; "
          + "; ".join(f"{n} {t / 1e3:.3f} ms = {t / busy_us:.1%} "
                      f"({counts[n]} kernels)" for n, t in shares.items())
          + f"; {sum(e.count for e in kernels)} kernel launches")
    print_top(kernels, 8)


def phase_serve_cli(argv, batch: int, prefill: dict,
                    attn_layers: int) -> None:
    """``repro_torch.launch.serve``'s entry point at full width: ``prefill``
    launches in prefill and ``attn_layers`` ``decode_attention`` launches
    per decode step, nothing else; (batch, SERVE_GEN) tokens."""
    tracing.reset()
    torch.cuda.reset_peak_memory_stats()
    res = serve.main(argv)
    launches = tracing.launches()
    gen = SERVE_GEN - 1
    print(f"serve CLI {argv}: launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated()} B")
    check(launches == expect(decode_attention=attn_layers * gen, **prefill),
          f"serve CLI launch counts {launches} != {prefill} (prefill), "
          f"{attn_layers} x {gen} decode_attention, none else")
    check(tuple(res["tokens"].shape) == (batch, SERVE_GEN),
          "serve CLI: tokens")


class PinnedRoutes:
    """Pins the MoE routes of the runs compared to one run's.  Top-k of the
    router's probabilities is a discrete choice: a rounding-sized move of a
    router input can swap the k-th and (k+1)-th expert, and a swap moves
    the capacity bins of every later pick of that expert.  So ``record``
    keeps every ``moe._route`` call's experts (``top_e``) in call order,
    and ``replay`` makes another run take them, in the same order, with
    the gates recomputed from that run's own probabilities; it counts the
    token decisions whose expert set the run would have taken otherwise
    and the smallest router margin (k-th minus (k+1)-th probability)
    among them."""

    def __init__(self):
        self.routes = []

    def record(self):
        orig = moe._route

        def rec(cfg, router_w, xt):
            out = orig(cfg, router_w, xt)
            self.routes.append(out[1])
            return out

        return mock.patch.object(moe, "_route", rec)

    @contextlib.contextmanager
    def replay(self, label: str, calls: int):
        """The first ``calls`` recorded routes, each used once."""
        orig = moe._route
        routes = iter(self.routes[:calls])
        stats = dict(used=0, decisions=0, flips=0, margin=float("inf"))

        def rep(cfg, router_w, xt):
            _, own, aux, z = orig(cfg, router_w, xt)
            # the pinning's own ops are not the model's: a cost walk running
            # (phase 19) does not see them
            with _disable_current_modes():
                pinned = next(routes).to(xt.device)
                _, probs = moe.router_probs(router_w, xt)
                top_p = torch.gather(probs, 1, pinned)
                top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True),
                                                1e-9)
                differ = (torch.sort(own, -1).values
                          != torch.sort(pinned, -1).values).any(-1)
                k = pinned.shape[1]
                srt = torch.sort(probs, -1, descending=True).values
                margins = (srt[:, k - 1] - srt[:, k])[differ]
                stats["used"] += 1
                stats["decisions"] += differ.numel()
                stats["flips"] += int(differ.sum())
                if margins.numel():
                    stats["margin"] = min(stats["margin"],
                                          float(margins.min()))
                top_p = top_p.to(xt.dtype)
            return top_p, pinned, aux, z

        with mock.patch.object(moe, "_route", rep):
            yield
        check(stats["used"] == calls, f"{label}: {stats['used']} routes "
              f"replayed, {calls} recorded for it")
        print(f"  {label}: routes pinned over {calls} MoE layer calls; "
              f"unpinned, {stats['flips']} of {stats['decisions']} token "
              f"decisions would differ (smallest router margin among them "
              f"{stats['margin']:.3e})")


def moe_profile(fn, label: str) -> None:
    """``device_profile`` of ``fn`` with the MoE's stages read from the
    program's own spans (``repro_torch.tracing``: ``moe.route``,
    ``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``moe.shared``
    and the whole ``moe``): the device time of the operations the host
    queued inside each one's ranges (a device operation and its runtime
    call share a correlation id) and its share of the device-busy time,
    then the serving profile."""
    import bisect
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    events = prof.events()
    queued_at = {e.id: e.time_range.start for e in events
                 if e.device_type == DeviceType.CPU
                 and e.name.startswith("cu")}
    ranges = defaultdict(list)
    for e in events:
        if e.device_type == DeviceType.CPU and (
                e.name == "moe" or e.name.startswith("moe.")):
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    stages = dict.fromkeys(ranges, 0.0)
    for name, rs in ranges.items():
        rs.sort()
        starts = [lo for lo, _ in rs]
        for d in events:
            t = queued_at.get(d.id) if d.device_type == DeviceType.CUDA \
                else None
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= rs[i][1]:
                stages[name] += d.time_range.elapsed_us()
    print_serving_profile(kernels, wall_us, label)
    if busy and stages:
        print(f"  MoE stages in the {label}: " + "; ".join(
            f"{k} {v / 1e3:.3f} ms = {v / busy:.1%}"
            for k, v in sorted(stages.items()) if k != "moe")
            + f"; the MoE in all {stages.get('moe', 0.0) / 1e3:.3f} ms = "
            f"{stages.get('moe', 0.0) / busy:.1%} of device time")


def phase_serving(arch: str, n_params: int, prefill: dict,
                  attn_layers: int, smoke: bool = False,
                  prompt: int = SERVE_PROMPT, gen: int = SERVE_GEN) -> dict:
    """``arch`` (full width, or its smoke config) from seed 0,
    B=SERVE_BATCH, ``prompt`` prompt tokens, ``gen`` greedy tokens: timed,
    launch-counted (``prefill`` launches in prefill, ``attn_layers``
    ``decode_attention`` per decode step), profiled, and the kernel route
    against the plain route on the prefill and TEACHER_STEPS
    teacher-forced decode steps (an MoE's routes pinned to the kernel
    route's, ``PinnedRoutes``).  Each state is dropped when it is done
    with: full-width Qwen1.5-MoE holds 57.3 GB of parameters and 6.4 GB a
    KV stack."""
    cfg = get_config(arch, smoke=smoke)
    model = Model(cfg)
    check(model.num_params() == n_params,
          f"{model.num_params()} parameters != {n_params}")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers "
          f"({', '.join(sorted(set(cfg.layer_kinds)))}), d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} KV "
          f"head(s) of {cfg.resolved_head_dim}, window "
          f"{cfg.local_window or cfg.sliding_window}, d_ff {cfg.d_ff}"
          + (f", {cfg.num_experts} experts top-{cfg.num_experts_per_tok} "
             f"(+{cfg.num_shared_experts} shared) of {cfg.moe_d_ff or cfg.d_ff}"
             if cfg.is_moe else "")
          + f", vocab {cfg.vocab_size}; {model.num_params()} fp32 parameters "
          f"from seed 0 on the card in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated()} B allocated")
    prompts = torch.as_tensor(TokenStream(cfg.vocab_size, seed=0).batch(
        SERVE_BATCH, prompt)["tokens"], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    pin = PinnedRoutes() if cfg.is_moe else None
    recording = pin.record() if pin else contextlib.nullcontext()

    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    with recording:
        logits, state = model.prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = tracing.launches()
    print(f"prefill B={SERVE_BATCH} S={prompt}: {prefill_s:.3f} s; "
          f"launches {launches}")
    check(launches == expect(**prefill),
          f"prefill launch counts {launches} != {prefill}, none else")
    tokens = [torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]]
    decode_logits = []
    st = state
    del state
    tracing.reset()
    t0 = time.perf_counter()
    with recording:
        for _ in range(gen - 1):
            lg, st = model.decode_step(params, st, tokens[-1])
            decode_logits.append(lg)
            tokens.append(torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None])
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / (gen - 1)
    decoded = tracing.launches()
    check(decoded == expect(decode_attention=attn_layers * (gen - 1)),
          f"decode launch counts {decoded} != {attn_layers} x "
          f"{gen - 1} decode_attention, none else")
    tokens = torch.cat(tokens, 1)
    peak = torch.cuda.max_memory_allocated()
    print(f"decode: {gen - 1} greedy steps, {decode_s * 1e3:.3f} "
          f"ms/token (B={SERVE_BATCH}); launches {decoded}; peak memory "
          f"{peak} B; tokens[0, :16] {tokens[0, :16].tolist()}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "tokens in range")
    check(bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(t).all()) for t in decode_logits),
        "finite logits")

    def profiled(fn, label):
        if cfg.is_moe:
            return moe_profile(fn, label)
        wall, kernels = device_profile(fn)
        print_serving_profile(kernels, wall, label)

    profiled(lambda: model.decode_step(params, st, tokens[:, -1:]),
             "decode step")
    del st
    profiled(lambda: model.prefill(params, {"tokens": prompts}), "prefill")

    steps = min(TEACHER_STEPS, gen - 1)
    moe_layers = cfg.num_layers if cfg.is_moe else 0
    calls = moe_layers * (1 + steps)
    decode_logits = decode_logits[:steps]
    naive = Model(cfg, impl="naive")
    plain = {}
    for label, p in (("plain route", params), ("its spread run",
                                               perturbed(params))):
        pinning = pin.replay(label, calls) if pin else \
            contextlib.nullcontext()
        with pinning:
            lg, n_state = naive.prefill(p, {"tokens": prompts})
            plain[label] = (lg, teacher_forced(naive, p, n_state,
                                               tokens[:, :steps]))
        del n_state, p
    (n_logits, n_decode), (m_logits, m_decode) = plain.values()
    hold_to_spread("kernel vs plain route", "prefill logits", logits,
                   n_logits, n_logits, m_logits)
    hold_to_spread("kernel vs plain route",
                   f"{steps} teacher-forced decode steps' logits",
                   decode_logits, n_decode, n_decode, m_decode)
    return dict(prefill_s=prefill_s, decode_s=decode_s, peak=peak,
                launches={k: launches[k] + decoded[k] for k in launches})


def hold_to_spread(label: str, what: str, tested, reference, plain,
                   plain_moved) -> None:
    """``tested`` within SENSITIVITY_FACTOR times the plain route's own
    spread (``plain`` against ``plain_moved``, the embedding moved by
    SENSITIVITY_NOISE) of ``reference``."""
    diff, spread = max_diff(tested, reference), max_diff(plain, plain_moved)
    scale = max(float(t.abs().max()) for t in (
        reference if isinstance(reference, list) else [reference]))
    print(f"  {label}, {what}: max|diff| {diff:.3e}; plain spread under a "
          f"{SENSITIVITY_NOISE:g} embedding move {spread:.3e} (ratio "
          f"{diff / max(spread, 1e-30):.2f}); largest |logit| {scale:.3e}")
    check(spread > 0, f"{label}, {what}: the perturbed plain route moved")
    check(diff <= SENSITIVITY_FACTOR * spread,
          f"{label}, {what}: {diff:.3e} > {SENSITIVITY_FACTOR} x spread "
          f"{spread:.3e}")


def phase_serving_card_vs_cpu(arch: str, layers: int, prompt: int,
                              prefill: dict, attn_layers: int) -> None:
    """``layers`` layers of ``arch`` at full width, B=CPU_BATCH: the card's
    kernel route against the CPU (whose wrappers take the plain versions)
    on the prefill logits and CPU_STEPS teacher-forced decode steps, held
    to SENSITIVITY_FACTOR times the card's plain-route spread; an MoE's
    routes pinned to the card's kernel run (``PinnedRoutes``)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    card = Model(cfg)
    params = card.init(0)
    tokens = TokenStream(cfg.vocab_size, seed=0).batch(
        CPU_BATCH, prompt + CPU_STEPS)["tokens"]
    batch, follow = {"tokens": tokens[:, :prompt]}, tokens[:, prompt:]
    pin = PinnedRoutes() if cfg.is_moe else None
    calls = layers * (1 + CPU_STEPS) if pin else 0

    def pinned(label):
        return pin.replay(label, calls) if pin else contextlib.nullcontext()

    tracing.reset()
    with pin.record() if pin else contextlib.nullcontext():
        logits, state = card.prefill(params, batch)
        torch.cuda.synchronize()
        check(tracing.launches() == expect(**prefill),
              f"{layers}-layer prefill launch counts {tracing.launches()}")
        tracing.reset()
        decode = teacher_forced(card, params, state, follow)
    torch.cuda.synchronize()
    check(tracing.launches() == expect(decode_attention=attn_layers * CPU_STEPS),
          f"{layers}-layer decode launch counts {tracing.launches()}")
    naive = Model(cfg, impl="naive")
    with pinned("card, plain route"):
        plain, st = naive.prefill(params, batch)
        plain_dec = teacher_forced(naive, params, st, follow)
    moved_params = perturbed(params)
    with pinned("card, plain route's spread run"):
        moved, st = naive.prefill(moved_params, batch)
        moved_dec = teacher_forced(naive, moved_params, st, follow)
    cpu_params = to_cpu(params)
    del params, moved_params, state, st
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = Model(cfg, device="cpu")
    t0 = time.perf_counter()
    with pinned("CPU"):
        cpu_logits, cpu_state = cpu.prefill(cpu_params, batch)
        cpu_dec = teacher_forced(cpu, cpu_params, cpu_state, follow)
    print(f"  card vs CPU, {layers} layers, B={CPU_BATCH} S={prompt} + "
          f"{CPU_STEPS} decode steps: CPU {time.perf_counter() - t0:.1f} s")
    hold_to_spread("card vs CPU", "prefill logits", logits.cpu(),
                   cpu_logits, plain, moved)
    hold_to_spread("card vs CPU", "teacher-forced decode logits",
                   [t.cpu() for t in decode], cpu_dec, plain_dec, moved_dec)


# ---------------------------------------------------------------------------
# Phase 9
# ---------------------------------------------------------------------------


def sharded_rank(sch, ue_data, test) -> dict:
    """One rank of phase 9, run by ``run_ranks`` (``spawn`` imports this
    script in each rank; ``main`` does not run there)."""
    import datetime

    import torch.distributed as dist
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True       # as phase_sharded
    mesh = make_agg_mesh(1, SHARD_RANKS, timeout=datetime.timedelta(
        seconds=RANK_TIMEOUT_S))
    sim = make_sim(sch, ue_data, mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    res = sim.run(test, rounds=ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = tracing.launches()
    t0 = time.perf_counter()
    sim.run(test, rounds=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    x, w = fleet_shard(mesh.rank)
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    out = flat_cloud_aggregate(x, w, mesh=mesh)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    fleet_launches = tracing.launches()
    num = torch.zeros(LENET_PARAMS, dtype=torch.float64, device=x.device)
    for start in range(0, FLEET_ROWS, 2048):
        num += w[start:start + 2048].double() @ x[start:start + 2048].double()
    v = torch.cat([num, w.double().sum()[None]])
    dist.all_reduce(v, group=mesh.data_group)
    ref = v[:-1] / v[-1]
    return dict(rank=mesh.rank, device=str(mesh.device),
                slab=tuple(sim._flat.shape), run_s=run_s, warm_s=warm_s,
                launches=launches, summary=run_summary(res),
                fleet_s=fleet_s, fleet_launches=fleet_launches,
                fleet_err=float((out.double() - ref).abs().max()),
                fleet_scale=float(ref.abs().max()),
                fleet_finite=bool(torch.isfinite(out).all()))


def phase_sharded(sch, ue_data, test) -> dict:
    """Phase 9; returns each kernel's launches summed over the ranks and
    over the sharded run and the fleet-scale event."""
    # cuDNN's default algorithms make a LeNet run on the card differ from
    # itself from run to run: two runs of phase 3's problem came up to
    # 7.7e-6 apart in train loss and 3.7e-4 in the params, as far as the
    # sharded run lies from either.  So the reference (phase 3's run
    # again), its moved runs and the ranks take cuDNN's deterministic
    # algorithms, and each gives the same result on every run.
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_sharded(sch, ue_data, test)
    finally:
        torch.backends.cudnn.deterministic = False


def _phase_sharded(sch, ue_data, test) -> dict:
    torch.cuda.empty_cache()        # the ranks share the card with us
    state = {}

    def spawn():
        t0 = time.perf_counter()
        try:
            state["ranks"] = run_ranks(sharded_rank, SHARD_RANKS, sch,
                                       ue_data, test, device="cuda",
                                       timeout_s=RANK_TIMEOUT_S)
        except BaseException as e:   # re-raised on the main thread
            state["error"] = e
        state["wall"] = time.perf_counter() - t0

    thread = threading.Thread(target=spawn, daemon=True)
    thread.start()
    # Beside the ranks: the unsharded run and its spread over the same
    # ROUNDS rounds when its init moves by SENSITIVITY_NOISE relative (the
    # largest over SPREAD_SEEDS draws of the move: one draw's train-loss
    # spread came out 10x under its test-loss one): the sharded run
    # differs from it only in the order of the cloud sums.
    t0 = time.perf_counter()
    unsharded = run_summary(make_sim(sch, ue_data, "cuda").run(
        test, rounds=ROUNDS))
    spread = dict.fromkeys(("final", "test_loss", "train_loss"), 0.0)
    for seed in SPREAD_SEEDS:
        moved = run_summary(make_sim(sch, ue_data, "cuda",
                                     noise=SENSITIVITY_NOISE,
                                     noise_seed=seed).run(test, rounds=ROUNDS))
        spread["final"] = max(spread["final"], max(
            _max_err(a, b) for a, b in zip(moved["final"],
                                           unsharded["final"])))
        for key in ("test_loss", "train_loss"):
            spread[key] = max(spread[key], float(
                np.abs(moved[key] - unsharded[key]).max()))
    ref_wall = time.perf_counter() - t0
    thread.join(timeout=RANK_TIMEOUT_S + 60)
    check(not thread.is_alive(), "the ranks did not end")
    if "error" in state:
        raise state["error"]
    ranks = state["ranks"]
    print(f"{SHARD_RANKS} ranks (gloo, both on {ranks[0]['device']}, so "
          f"they share one card) on a {SHARD_RANKS} x 1 mesh: "
          f"{state['wall']:.1f} s from spawn to results; the unsharded "
          f"reference and its spread runs beside them {ref_wall:.1f} s")
    per_rank = expect(segment_aggregate=sch.b * ROUNDS,
                      weighted_mean=ROUNDS)
    for r in ranks:
        print(f"  rank {r['rank']}: slab {r['slab']} fp32; {ROUNDS} rounds "
              f"{r['run_s']:.3f} s (first-call warm-up included), one more "
              f"round, warm: {r['warm_s']:.3f} s; launches {r['launches']}")
        check(r["slab"] == (SHARD_ROWS, LENET_PARAMS),
              f"rank {r['rank']}: slab {r['slab']}")
        check(r["launches"] == per_rank, f"rank {r['rank']}: launch counts "
              f"{r['launches']} != {per_rank}")
    first = ranks[0]["summary"]
    for r in ranks[1:]:
        check(all(np.array_equal(first[k], r["summary"][k])
                  for k in ("test_acc", "test_loss", "train_loss"))
              and all(torch.equal(a, b) for a, b in
                      zip(first["final"], r["summary"]["final"])),
              "the ranks' results differ")
    for key in ("final", "test_loss", "train_loss"):
        if key == "final":
            diff = max(_max_err(a, b) for a, b in
                       zip(first["final"], unsharded["final"]))
        else:
            diff = float(np.abs(first[key] - unsharded[key]).max())
        ratio = diff / max(spread[key], 1e-30)
        print(f"  sharded vs the unsharded run, {key}: max|diff| "
              f"{diff:.3e}; spread of that run under a {SENSITIVITY_NOISE:g} "
              f"init move {spread[key]:.3e} (largest of "
              f"{len(SPREAD_SEEDS)} moves; ratio {ratio:.2f})")
        check(spread[key] > 0, f"the perturbed run's {key} moved")
        check(diff <= SENSITIVITY_FACTOR * spread[key],
              f"sharded {key} {diff:.3e} > {SENSITIVITY_FACTOR} x spread "
              f"{spread[key]:.3e}")
    n_test = len(test["labels"])
    acc = float(np.abs(first["test_acc"] - unsharded["test_acc"]).max())
    print(f"  test accuracy {first['test_acc'].tolist()} against "
          f"{unsharded['test_acc'].tolist()}")
    check(acc <= 1.0 / n_test + 1e-9, f"sharded accuracy {acc} apart, more "
          f"than one of {n_test} test samples")

    for r in ranks:
        print(f"  fleet-scale cloud event, rank {r['rank']}: {FLEET_ROWS} x "
              f"{LENET_PARAMS} fp32 ({FLEET_ROWS * LENET_PARAMS * 4} B) in "
              f"{r['fleet_s'] * 1e3:.3f} ms (host clock, synchronised; the "
              f"all-reduce of {LENET_PARAMS + 1} floats through gloo "
              f"included); max|err| against float64 {r['fleet_err']:.3e} "
              f"(largest |mean| {r['fleet_scale']:.3e}); launches "
              f"{r['fleet_launches']}")
        check(r["fleet_finite"], "fleet-scale event: finite")
        check(r["fleet_err"] <= STREAM_RTOL * r["fleet_scale"],
              f"fleet-scale event: max|err| {r['fleet_err']:.3e} > "
              f"{STREAM_RTOL} x {r['fleet_scale']:.3e}")
        check(r["fleet_launches"] == expect(weighted_mean=1),
              f"fleet-scale launch counts {r['fleet_launches']}")
    return {name: sum(r["launches"][name] + r["fleet_launches"][name]
                      for r in ranks) for name in KERNELS}


# ---------------------------------------------------------------------------
# Phase 10
# ---------------------------------------------------------------------------


def phase_stochastic(sch, ue_data, test, main_clock) -> dict:
    """Phase 10; returns each kernel's launches over its stochastic sync
    and async runs.  cuDNN's deterministic algorithms make the
    bit-for-bit comparison a check of the clock, not of cuDNN."""
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_stochastic(sch, ue_data, test, main_clock)
    finally:
        torch.backends.cudnn.deterministic = False


def _phase_stochastic(sch, ue_data, test, main_clock) -> dict:
    # imported here, so that the script still imports in an older tree
    # (``--time-aggregation``, ``--time-rounds``)
    from repro_torch.core import (DeterministicDelays, scenario,
                                  simulate_async)
    from repro_torch.core.delay import makespan_distribution
    from repro_torch.core.stochastic import Key
    prob, assoc, a, b = sch.problem, sch.assoc, sch.a, sch.b
    plain_sim = make_sim(sch, ue_data, "cuda")
    plain = plain_sim.run(test, rounds=ROUNDS)
    det = make_sim(sch, ue_data, "cuda",
                   delay_model=DeterministicDelays()).run(test, rounds=ROUNDS)
    print(f"DeterministicDelays(): clock {det.times.tolist()} against phase "
          f"3's {main_clock.tolist()}")
    check(np.array_equal(det.times, main_clock)
          and np.array_equal(plain.times, main_clock),
          "DeterministicDelays: the clock differs from phase 3's")
    check(all(torch.equal(x, y) for x, y in
              zip(tree_leaves(det.final_params),
                  tree_leaves(plain.final_params))),
          "DeterministicDelays: params differ from delay_model=None's")

    model = scenario(STOCH_SCENARIO).model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = model.cycle_times(Key(STOCH_SEED, device="cuda"), prob, assoc, a,
                             b, ROUNDS)
    draw_ms = (time.perf_counter() - t0) * 1e3
    cpu_rows = model.cycle_times(Key(STOCH_SEED, device="cpu"), prob, assoc,
                                 a, b, ROUNDS)
    sim = make_sim(sch, ue_data, "cuda", delay_model=model,
                   delay_seed=STOCH_SEED)
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    res = sim.run(test, rounds=ROUNDS, verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = tracing.launches()
    print(f"{STOCH_SCENARIO}, delay_seed={STOCH_SEED}: {ROUNDS} sync rounds "
          f"in {run_s:.3f} s (first-call warm-up included); one draw of "
          f"{ROUNDS} cycles x {b} edge rounds x {sch.num_ues} UEs on the card "
          f"{draw_ms:.3f} ms (host clock, synchronised)")
    print(f"launches during the stochastic sync path: {launches}")
    check(launches == expect(segment_aggregate=b * ROUNDS,
                             cloud_aggregate=ROUNDS),
          f"launch counts {launches} != b*rounds={b * ROUNDS}, "
          f"rounds={ROUNDS}")
    check(np.array_equal(res.times, np.cumsum(rows.max(axis=1))),
          "stochastic sync clock != the rows drawn on the card")
    cpu_clock = np.cumsum(cpu_rows.max(axis=1))
    rel = float(np.abs(res.times - cpu_clock).max() / cpu_clock.max())
    print(f"  clock {res.times.tolist()} s against the deterministic "
          f"{main_clock.tolist()}; against the same draws made on the CPU: "
          f"max relative difference {rel:.3e}")
    check(rel <= CLOCK_RTOL, f"card clock vs CPU draws {rel:.3e} > "
          f"{CLOCK_RTOL}")
    check(bool(np.isfinite(res.test_loss).all()
               and np.isfinite(res.train_loss).all()),
          "stochastic sync: finite losses")
    # Warm rounds in turns, constant clock and stochastic, both under this
    # phase's cuDNN algorithms: the draw is the only difference.
    warm = {"constant": [], STOCH_SCENARIO: []}
    for name, run_sim in (("constant", plain_sim), (STOCH_SCENARIO, sim),
                          (STOCH_SCENARIO, sim), ("constant", plain_sim)):
        t0 = time.perf_counter()
        run_sim.run(test, rounds=1)
        torch.cuda.synchronize()
        warm[name].append(time.perf_counter() - t0)
    print("one more sync round, warm, in turns: " + "; ".join(
        f"{name} {', '.join(f'{t:.3f}' for t in ts)} s"
        for name, ts in warm.items()))

    asim = make_sim(sch, ue_data, "cuda", mode="async",
                    max_staleness=ASYNC_STALENESS, delay_model=model,
                    delay_seed=STOCH_SEED)
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    ares = asim.run(test, rounds=CUT_ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    async_launches = tracing.launches()
    tl = ares.timeline
    waves = departure_waves(tl)
    print(f"stochastic async path: max_staleness={ASYNC_STALENESS}, "
          f"{len(tl.updates)} cloud updates, {waves} departure waves in "
          f"{run_s:.3f} s ({run_s / len(tl.updates):.3f} s per update, "
          f"first-call warm-up included)")
    print(f"launches during the stochastic async path: {async_launches}")
    check(async_launches == expect(segment_aggregate=b * waves),
          f"launch counts {async_launches} != b*waves={b * waves}, 0, 0")
    check(all(bool(torch.isfinite(t).all())
              for t in tree_leaves(ares.final_params)),
          "stochastic async: finite params")
    active = np.flatnonzero(assoc.sum(0) > 0)
    cycles = model.cycle_times(Key(STOCH_SEED, device="cuda"), prob, assoc,
                               a, b, CUT_ROUNDS + ASYNC_STALENESS)[:, active]
    ref = simulate_async(cycles, rounds=CUT_ROUNDS,
                         max_staleness=ASYNC_STALENESS)
    check(tl.trace == ref.trace,
          "stochastic async timeline != simulate_async on the card's draws")
    barrier = float(cycles[:CUT_ROUNDS].max(axis=1).sum())
    print(f"  async makespan {float(tl.makespan)!r} s simulated against "
          f"the sync barrier {barrier!r} s on the same draws "
          f"({barrier / tl.makespan:.4f}x)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = makespan_distribution(prob, assoc, a, b, rounds=ROUNDS,
                              max_staleness=ASYNC_STALENESS, model=model,
                              key=STOCH_SEED, num_trials=STOCH_TRIALS,
                              device="cuda")
    dist_s = time.perf_counter() - t0
    print(f"  makespan_distribution, {STOCH_TRIALS} trials drawn on the "
          f"card in {dist_s:.3f} s: async p50 {d['async_p50']!r} p95 "
          f"{d['async_p95']!r}; sync p50 {d['sync_p50']!r} p95 "
          f"{d['sync_p95']!r} s")
    check(bool(np.isfinite(d["async_makespans"]).all()
               and (d["async_makespans"] > 0).all()
               and np.isfinite(d["sync_makespans"]).all()),
          "makespan_distribution: finite, positive makespans")
    return {name: launches[name] + async_launches[name] for name in KERNELS}


# ---------------------------------------------------------------------------
# Phase 11
# ---------------------------------------------------------------------------


def fault_model():
    """Phase 11's fault model: the processes of the ue_churn,
    lossy_uplink and edge_outage scenarios."""
    from repro_torch.core import faults as F
    return F.FaultModel(dropout=F.MarkovChurn(p_off=0.15, p_on=0.45),
                        loss=F.UplinkLoss(rate=0.25, backoff=0.05),
                        outage=F.EdgeOutage(rate=0.05, repair_cycles=6.0))


def phase_faults(sch, ue_data, test) -> tuple:
    """Phase 11; returns each kernel's launches over its fault and sampled
    runs, K1's and K2's largest error under fault weights, and its
    deadline+failover and sampled sync runs (clock, masks, final params:
    phase 14's references).  cuDNN's
    deterministic algorithms make the bit-for-bit null routing a check of
    the routing, not of cuDNN."""
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_faults(sch, ue_data, test)
    finally:
        torch.backends.cudnn.deterministic = False


def _phase_faults(sch, ue_data, test) -> dict:
    # imported here, so that the script still imports in an older tree
    from repro_torch.core import DeterministicDelays, scenario
    from repro_torch.core import faults as F
    from repro_torch.core.delay import (fault_makespan_distribution,
                                        faulty_async_completion)
    from repro_torch.core.stochastic import Key
    from repro_torch.fl.aggregate import flat_edge_aggregate
    from repro_torch.fl.sampling import expected_cohort, make_sampler
    prob, assoc, a, b = sch.problem, sch.assoc, sch.a, sch.b
    M = sch.num_edges
    fm = fault_model()
    model = scenario(FAULT_SCENARIO).model
    policies = {"wait_for_all": F.wait_for_all_policy(),
                "deadline_failover": F.deadline_failover_policy()}
    print(f"fault model {fm}; delays {FAULT_SCENARIO}; fault_seed="
          f"{FAULT_SEED}")

    plain_sim = make_sim(sch, ue_data, "cuda")
    plain = plain_sim.run(test, rounds=ROUNDS)
    null = make_sim(sch, ue_data, "cuda", fault_model=F.FaultModel(),
                    sampler=make_sampler(SAMPLER, 1.0)).run(test,
                                                            rounds=ROUNDS)
    check(np.array_equal(null.times, plain.times)
          and all(torch.equal(x, y) for x, y in
                  zip(tree_leaves(null.final_params),
                      tree_leaves(plain.final_params))),
          "FaultModel() and a rate-1 sampler: clock or params differ from "
          "the plain run's")
    print("FaultModel() with a rate-1 sampler: the plain run's clock and "
          "params bit for bit")

    gids = sch.assoc.argmax(1)
    stats = {}
    for name, pol in policies.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = F.faulty_cycle_stats(fm, pol, Key(FAULT_SEED, device="cuda"),
                                    prob, assoc, a, b, FAULT_ROUNDS,
                                    delay_model=model)
        draw_ms = (time.perf_counter() - t0) * 1e3
        cpu = F.faulty_cycle_stats(fm, pol, Key(FAULT_SEED, device="cpu"),
                                   prob, assoc, a, b, FAULT_ROUNDS,
                                   delay_model=model)
        check(np.array_equal(card.survivors, cpu.survivors)
              and np.array_equal(card.down, cpu.down)
              and card.windows == cpu.windows,
              f"{name}: card-drawn masks or windows != the CPU's")
        rel = float(np.abs(card.cycle_times - cpu.cycle_times).max()
                    / np.abs(cpu.cycle_times).max())
        check(rel <= CLOCK_RTOL, f"{name}: card cycle times vs CPU {rel:.3e}"
              f" > {CLOCK_RTOL}")
        print(f"  faulty_cycle_stats, {name}: {FAULT_ROUNDS} cycles x {b} "
              f"edge rounds x {sch.num_ues} UEs drawn on the card in "
              f"{draw_ms:.3f} ms (host clock, synchronised); masks, down and "
              f"windows equal the CPU's, cycle times within {rel:.3e}")
        stats[name] = card

    launches = {name: 0 for name in KERNELS}
    finals, runs = {}, {}
    for name, pol in policies.items():
        sim = make_sim(sch, ue_data, "cuda", delay_model=model,
                       fault_model=fm, fault_policy=pol,
                       fault_seed=FAULT_SEED)
        torch.cuda.synchronize()
        tracing.reset()
        t0 = time.perf_counter()
        res = sim.run(test, rounds=FAULT_ROUNDS, verbose=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        got = tracing.launches()
        fc = stats[name]
        kept = fc.survivors & ~fc.down[:, gids]
        k = int(kept.any(axis=1).sum())
        print(f"{name} sync: {FAULT_ROUNDS} rounds in {run_s:.3f} s "
              f"(first-call warm-up included); survivors a round "
              f"{fc.survivors.sum(axis=1).tolist()}, kept (outside down "
              f"edges) {kept.sum(axis=1).tolist()} of {sch.num_ues}; "
              f"windows {fc.windows}; launches {got}")
        # wait-for-all adds the outage stalls, the deadline policy skips
        # the edges that are down
        round_times = (fc.cycle_times + fc.stall if name == "wait_for_all"
                       else np.where(fc.down, 0.0, fc.cycle_times))
        check(np.array_equal(res.times,
                             np.cumsum(round_times.max(axis=1))),
              f"{name}: clock != the card-drawn stats' round times")
        check(got == expect(segment_aggregate=b * k, cloud_aggregate=k),
              f"{name}: launch counts {got} != b*k={b * k}, k={k}")
        check(bool(np.isfinite(res.test_loss).all()
                   and np.isfinite(res.train_loss).all()),
              f"{name}: finite losses")
        check(all(bool(torch.isfinite(t).all())
                  for t in tree_leaves(res.final_params)),
              f"{name}: finite params")
        finals[name] = float(res.times[-1])
        for kname in KERNELS:
            launches[kname] += got[kname]
        if name == "deadline_failover":
            fault_sim = sim
            runs["faulty"] = dict(run_summary(res), times=res.times,
                                  masks=kept)
    print(f"  final clock: deadline_failover {finals['deadline_failover']!r}"
          f" s, wait_for_all {finals['wait_for_all']!r} s")
    check(finals["deadline_failover"] <= finals["wait_for_all"],
          "the deadline policy's clock exceeds wait-for-all's")

    # The dead cohort on the card: one edge killed, a few more UEs lost.
    ok = np.ones(sch.num_ues, bool)
    ok[gids == 2] = False
    ok[np.flatnonzero(gids == 0)[:3]] = False
    w_edge, w_cloud = fault_sim._fault_round_weights(ok)
    gen = torch.Generator(device="cuda").manual_seed(FAULT_SEED)
    x = torch.randn((sch.num_ues, LENET_PARAMS), generator=gen,
                    device="cuda")
    g = fault_sim.group_ids
    dead = torch.as_tensor(gids == 2, device="cuda")
    out = flat_edge_aggregate(x, w_edge, g, M)
    check(bool((out[dead] == 0).all()) and bool(torch.isfinite(out).all()),
          "dead cohort: the killed edge's rows are not exactly 0")
    errs = {}
    for kname, (kout, ref) in {
            "segment_aggregate": (ha.segment_aggregate(x, w_edge, g, M),
                                  ha.segment_aggregate_plain(x, w_edge, g,
                                                             M)),
            "cloud_aggregate": (ha.cloud_aggregate(x, w_cloud),
                                ha.cloud_aggregate_plain(x, w_cloud))}.items():
        err, scale = _max_err(kout, ref), float(ref.abs().max())
        check(bool(torch.isfinite(kout).all()) and err <= KERNEL_RTOL * scale,
              f"{kname} under fault weights: max|err| {err:.3e} > "
              f"{KERNEL_RTOL} x {scale:.3e}")
        errs[kname] = err
        print(f"  {kname} under fault weights ({int(ok.sum())} of "
              f"{sch.num_ues} rows kept, edge 2 dead): max|err| {err:.3e} "
              f"(scale {scale:.3e})")
    print("  the dead edge's rows are exactly 0 after flat_edge_aggregate")
    del x, out

    sampler = make_sampler(SAMPLER, participation_rate=SAMPLE_RATE)
    ssim = make_sim(sch, ue_data, "cuda", sampler=sampler,
                    sample_seed=FAULT_SEED)
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    res = ssim.run(test, rounds=FAULT_ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = tracing.launches()
    w_np, g_np = ssim.weights.cpu().numpy(), ssim.group_ids.cpu().numpy()
    part = sampler.sample_rounds(Key(FAULT_SEED, device="cuda"), w_np, g_np,
                                 M, FAULT_ROUNDS)
    rows = DeterministicDelays().cycle_times(None, prob, assoc, a, b,
                                             FAULT_ROUNDS,
                                             participation=part)
    cohort = expected_cohort(w_np, g_np, M, SAMPLE_RATE)
    print(f"sampled sync ({SAMPLER}, rate {SAMPLE_RATE}): {FAULT_ROUNDS} "
          f"rounds in {run_s:.3f} s; cohorts {part.sum(axis=1).tolist()} "
          f"(expected_cohort {cohort}); clock {res.times.tolist()} s; "
          f"launches {got}")
    check(np.array_equal(res.times, np.cumsum(rows.max(axis=1))),
          "sampled clock != the cohort-masked deterministic cycles")
    check(bool((part.sum(axis=1) == cohort).all()),
          "cohort sizes != expected_cohort")
    check(got == expect(segment_aggregate=b * FAULT_ROUNDS,
                        cloud_aggregate=FAULT_ROUNDS),
          f"sampled: launch counts {got}")
    check(all(bool(torch.isfinite(t).all())
              for t in tree_leaves(res.final_params)), "sampled: finite")
    for kname in KERNELS:
        launches[kname] += got[kname]
    runs["sampled"] = dict(run_summary(res), times=res.times, masks=part)

    dlf = policies["deadline_failover"]
    asim = make_sim(sch, ue_data, "cuda", mode="async",
                    max_staleness=ASYNC_STALENESS, delay_model=model,
                    fault_model=fm, fault_policy=dlf, fault_seed=FAULT_SEED)
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    ares = asim.run(test, rounds=CUT_ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = tracing.launches()
    tl = ares.timeline
    waves = departure_waves(tl)
    ref = faulty_async_completion(prob, assoc, a, b, rounds=CUT_ROUNDS,
                                  max_staleness=ASYNC_STALENESS,
                                  fault_model=fm, policy=dlf,
                                  delay_model=model,
                                  key=Key(FAULT_SEED, device="cuda"))
    print(f"faulty async (deadline_failover, max_staleness="
          f"{ASYNC_STALENESS}): {len(tl.updates)} cloud updates, {waves} "
          f"departure waves, {len(tl.failures)} edge failures in "
          f"{run_s:.3f} s; makespan {float(tl.makespan)!r} s simulated "
          f"against the sync barrier {ref['sync_makespan']!r} s; launches "
          f"{got}")
    check(tl.trace == ref["timeline"].trace,
          "faulty async timeline != faulty_async_completion on the card")
    check(got == expect(segment_aggregate=b * waves),
          f"faulty async: launch counts {got} != b*waves={b * waves}")
    check(all(bool(torch.isfinite(t).all())
              for t in tree_leaves(ares.final_params)),
          "faulty async: finite params")
    for kname in KERNELS:
        launches[kname] += got[kname]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = fault_makespan_distribution(prob, assoc, a, b, rounds=FAULT_ROUNDS,
                                    max_staleness=ASYNC_STALENESS,
                                    fault_model=fm, policies=policies,
                                    delay_model=model, key=FAULT_SEED,
                                    num_trials=FAULT_TRIALS, device="cuda")
    dist_s = time.perf_counter() - t0
    print(f"  fault_makespan_distribution, {FAULT_TRIALS} trials drawn on "
          f"the card in {dist_s:.3f} s: " + "; ".join(
              f"{n} p50 {d[n + '_p50']!r} p95 {d[n + '_p95']!r} s, delivered "
              f"{d[n + '_delivered_frac']:.4f}" for n in policies))
    check(all(bool(np.isfinite(d["makespans"][n]).all()
                   and (d["makespans"][n] > 0).all()) for n in policies),
          "fault_makespan_distribution: finite, positive makespans")

    # Warm rounds in turns, plain and faulty, both under this phase's
    # cuDNN algorithms: the fault draw and weights are the difference.
    warm = {"plain": [], "deadline_failover": []}
    for name, run_sim in (("plain", plain_sim),
                          ("deadline_failover", fault_sim),
                          ("deadline_failover", fault_sim),
                          ("plain", plain_sim)):
        t0 = time.perf_counter()
        run_sim.run(test, rounds=1)
        torch.cuda.synchronize()
        warm[name].append(time.perf_counter() - t0)
    print("one more sync round, warm, in turns: " + "; ".join(
        f"{name} {', '.join(f'{t:.3f}' for t in ts)} s"
        for name, ts in warm.items()))
    return launches, errs, runs


# ---------------------------------------------------------------------------
# Phase 12
# ---------------------------------------------------------------------------


def phase_joint(ue_data, test) -> dict:
    """Phase 12; returns each kernel's launches over its async runs.
    cuDNN's deterministic algorithms make the resumed run's bit-for-bit
    comparison a check of the checkpoint, not of cuDNN."""
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_joint(ue_data, test)
    finally:
        torch.backends.cudnn.deterministic = False


def _phase_joint(ue_data, test) -> dict:
    # imported here, so that the script still imports in an older tree
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.core import assoc, jointopt
    from repro_torch.core.schedule import plan_joint
    from repro_torch.core.stochastic import Key
    t_phase = time.perf_counter()
    paper = plan(HFLProblem(**MAIN))
    det = plan_joint(HFLProblem(**MAIN), scenario="deterministic",
                     key=Key(JOINT_SEED, device="cuda"))
    print(f"plan_joint(deterministic): (a, b) = ({det.a}, {det.b}), "
          f"max_staleness {det.meta['max_staleness']}, bandwidth "
          f"{det.meta['bandwidth']}; plan(): ({paper.a}, {paper.b})")
    check((det.a, det.b) == (paper.a, paper.b),
          "plan_joint(deterministic) != plan()'s (a, b)")

    A = paper.assoc
    sols = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        sols[dev] = jointopt.solve_joint(
            HFLProblem(**MAIN), A, model=STOCH_SCENARIO,
            num_trials=JOINT_TRIALS, key=Key(JOINT_SEED, device=dev))
        print(f"solve_joint({STOCH_SCENARIO}, {JOINT_TRIALS} trials, key on "
              f"{dev}): {len(sols[dev].history)} tuples in "
              f"{time.perf_counter() - t0:.3f} s")
    card, host = sols["cuda"], sols["cpu"]
    tup = (card.a, card.b, card.max_staleness, card.bandwidth)
    check(tup == (host.a, host.b, host.max_staleness, host.bandwidth),
          f"joint tuple on the card {tup} != the CPU's")
    h_card = np.array([h[4] for h in card.history])
    h_host = np.array([h[4] for h in host.history])
    fin = np.isfinite(h_host)
    rel = float(np.max(np.abs(h_card[fin] - h_host[fin]) / h_host[fin]))
    check(np.array_equal(np.isfinite(h_card), fin)
          and [h[:4] for h in card.history] == [h[:4] for h in host.history]
          and rel <= CLOCK_RTOL,
          f"joint history: card vs CPU max relative {rel:.3e}")
    t0 = time.perf_counter()
    sched = plan_joint(HFLProblem(**MAIN), scenario=STOCH_SCENARIO,
                       num_trials=JOINT_TRIALS,
                       key=Key(JOINT_SEED, device="cuda"))
    plan_s = time.perf_counter() - t0
    print(f"plan_joint({STOCH_SCENARIO}) on the card in {plan_s:.3f} s: "
          f"(a, b, max_staleness, bandwidth) = {tup}, p95 time-to-target "
          f"{card.objective!r} s (paper's (a, b) = ({paper.a}, {paper.b})); "
          f"history card vs CPU max relative {rel:.3e}")
    check((sched.a, sched.b, sched.meta["max_staleness"],
           sched.meta["bandwidth"]) == tup, "plan_joint != solve_joint")

    readme = HFLProblem(num_edges=3, num_ues=12, seed=0)
    t0 = time.perf_counter()
    ra = assoc.refined(readme, a=8, objective="joint", b=3, rounds=6,
                       max_staleness=2, num_trials=12,
                       max_moves=JOINT_MAX_MOVES,
                       delay_key=Key(JOINT_SEED, device="cuda"))
    print(f"refined(objective='joint') on the 12-UE, 3-edge problem in "
          f"{time.perf_counter() - t0:.3f} s: edge sizes "
          f"{ra.sum(0).tolist()}")
    check(bool((ra.sum(1) == 1).all()), "refined(joint): one edge a UE")

    sim = make_sim(sched, ue_data, "cuda", mode="async", max_staleness=None)
    check(sim.max_staleness == sched.meta["max_staleness"],
          f"max_staleness {sim.max_staleness} != the plan's "
          f"{sched.meta['max_staleness']}")
    launches = dict.fromkeys(KERNELS, 0)
    waves = 0

    def segment(s):
        nonlocal waves
        torch.cuda.synchronize()
        tracing.reset()
        t0 = time.perf_counter()
        res = s.run(test, rounds=1)
        torch.cuda.synchronize()
        got, w = tracing.launches(), departure_waves(res.timeline)
        check(got == expect(segment_aggregate=sched.b * w),
              f"joint async: launch counts {got} != b*waves={sched.b * w}")
        for name in KERNELS:
            launches[name] += got[name]
        waves += w
        return res, time.perf_counter() - t0

    first, first_s = segment(sim)
    with tempfile.TemporaryDirectory() as tmp:
        path = save_pytree(os.path.join(tmp, "sim"),
                           {"flat": sim.flat_state(), "params": sim.params})
        fresh = make_sim(sched, ue_data, "cuda", mode="async",
                         max_staleness=None)
        tree, _ = load_pytree(path, target={"flat": fresh.flat_state(),
                                            "params": fresh.params})
    fresh.params = tree["params"]
    check(np.array_equal(fresh.flat_state(), tree["flat"]),
          "restored params != the checkpoint's flat buffer")
    check(all(t.device.type == "cuda" for t in tree_leaves(tree["params"])),
          "load_pytree(target=) left a leaf off the card")
    ref, ref_s = segment(sim)
    res, res_s = segment(fresh)
    err = max(float((x - y).abs().max()) for x, y in
              zip(tree_leaves(res.final_params),
                  tree_leaves(ref.final_params)))
    updates = len(first.timeline.updates)
    print(f"joint async run, full-width LeNet, max_staleness "
          f"{sim.max_staleness}: {updates} cloud updates a segment, "
          f"{waves} departure waves over 3 segments; "
          f"{first_s / updates:.3f}, {ref_s / updates:.3f}, "
          f"{res_s / updates:.3f} s per update (first call included in the "
          f"first)")
    print(f"  checkpoint {{flat, params}} mid-run, resumed on a fresh "
          f"simulator: clock {float(res.timeline.makespan)!r} against "
          f"{float(ref.timeline.makespan)!r} s; params max|err| {err!r}")
    check(np.array_equal(res.times, ref.times)
          and res.timeline.trace == ref.timeline.trace,
          "resumed clock != the uninterrupted run's")
    check(err == 0.0, f"resumed params max|err| {err!r} != 0.0")
    check(np.array_equal(res.test_loss, ref.test_loss),
          "resumed losses != the uninterrupted run's")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 13
# ---------------------------------------------------------------------------


def phase_service(sch, ue_data, test) -> tuple:
    """Phase 13; returns each kernel's launches over its in-process
    services, and its streamed service's trace and model (phase 14's
    reference).  The SIGKILL pair's processes start first and run beside
    them.  cuDNN's deterministic algorithms make the resumed run's
    comparison a check of the checkpoint, not of cuDNN."""
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        kill = start_service_kill(tmp)
        try:
            return _phase_service(sch, ue_data, test, kill, tmp)
        finally:
            stop_processes(kill)
            torch.backends.cudnn.deterministic = False


def count_waves(sim) -> list:
    """Count ``sim``'s departure waves (``replay_departure`` calls) into
    the returned one-item list."""
    waves = [0]
    replay = sim.replay_departure

    def counted(*a, **k):
        waves[0] += 1
        return replay(*a, **k)

    sim.replay_departure = counted
    return waves


def _merge_records(trace) -> list:
    return [(round(r["t"], 9), r["edge"], r["cycle"], r["stale"])
            for r in trace if r["kind"] == "merge"]


def counted_run(label: str, build, events: int, before=None,
                extra=None) -> tuple:
    """Build a service (``build() -> (svc, waves)``), call ``before(svc)``
    and run it to ``events`` events, the kernels' counts reset before the
    build and read after the run: K1 launches b* a departure wave, and
    ``extra()`` names the run's other launches.  Returns
    ``(svc, launched)``."""
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    svc, waves = build()
    if before is not None:
        before(svc)
    start = svc.events_done
    svc.run(events)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = tracing.launches()
    want = expect(segment_aggregate=svc.sim.schedule.b * waves[0],
                  **(extra() if extra is not None else {}))
    check(got == want, f"{label}: launch counts {got} != {want} (K1 b* a "
          f"wave over {waves[0]} waves)")
    s = svc.summary()
    print(f"  {label}: events {start}..{svc.events_done}, {waves[0]} waves, "
          f"{s['applied']} merges, {s['shed']} shed, clock "
          f"{svc.clock:.3f} s simulated; {wall:.3f} s wall, "
          f"{wall / (svc.events_done - start):.4f} s per event "
          f"(construction included)")
    check(bool(np.isfinite(svc.g).all()), f"{label}: finite model")
    return svc, got


def _phase_service(sch, ue_data, test, kill: dict, kill_dir: str) -> tuple:
    # imported here, so that the script still imports in an older tree
    from repro_torch.core import scenario
    from repro_torch.launch import service as S
    t_phase = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)
    segs = S._parse_segments(SERVICE_SEGMENTS)
    gids = sch.assoc.argmax(1)                # each row's edge

    def run(label, events, before=None, extra=None, **kw):
        """One service over a fresh full-width LeNet simulator, its waves
        counted; its launches are added to the phase's."""
        def build():
            sim = make_sim(sch, ue_data, "cuda", mode="async",
                           max_staleness=SERVICE_STALENESS)
            waves = count_waves(sim)
            cfg = S.ServiceConfig(segments=segs,
                                  max_staleness=SERVICE_STALENESS, **kw)
            return S.HFLService(sim, cfg), waves

        svc, got = counted_run(label, build, events, before, extra)
        for name in KERNELS:
            launches[name] += got[name]
        return svc

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = dict(ckpt_dir=os.path.join(tmp, "inproc"),
                    ckpt_every=SERVICE_CKPT_EVERY)
        print(f"service: full-width LeNet on phase 3's problem, "
              f"max_staleness {SERVICE_STALENESS}, segments "
              f"{SERVICE_SEGMENTS}")
        full = run("uninterrupted", SERVICE_EVENTS, **ckpt)
        s = full.summary()
        check(s["shed"] > 0 and any(r["kind"] == "degraded" and r["on"]
                                    for r in full.trace),
              "the burst drove no shedding")
        print(f"  p50 {s['p50']!r} s, p95 {s['p95']!r} s latency "
              f"(simulated); checkpoints {s['ckpt_wall']:.3f} s of "
              f"{s['run_wall']:.3f} s run wall")
        # a crash after the mid-run checkpoint: the newer files are gone
        keep = SERVICE_RESUME_AT // SERVICE_CKPT_EVERY
        for p in S.list_checkpoints(ckpt["ckpt_dir"])[keep:]:
            os.remove(p)
        src = []

        def restore(svc):
            src.append(svc.restore_latest())
            check(svc.events_done == SERVICE_RESUME_AT,
                  f"resumed at {svc.events_done} events from {src[0]}")

        resumed = run("resumed", SERVICE_EVENTS, before=restore, **ckpt)
        err = float(np.abs(resumed.g - full.g).max())
        same = _merge_records(resumed.trace) == _merge_records(full.trace)
        print(f"  resumed from {os.path.basename(src[0])} at event "
              f"{SERVICE_RESUME_AT}: trace equal {same}; model max|err| "
              f"{err!r}")
        check(same, "resumed trace != the uninterrupted run's")
        check(err <= SERVICE_MODEL_TOL,
              f"resumed model max|err| {err!r} > {SERVICE_MODEL_TOL}")

    # The streaming merge: each merge row folded through the accumulator
    # on the card, held against the direct read of the same row; each
    # chunk the accumulator was given is kept for K4's check below.
    rows, stream_errs, chunks = [], [], []

    def streamed(svc):
        check(svc._stream_acc.device.type == "cuda",
              "the streaming accumulator is not on the card")
        merge_row, add = svc._merge_row, svc._stream_acc.add

        def checked(m):
            row = merge_row(m)
            rows.append(m)
            direct = svc.sim.edge_mean_row(m).cpu().numpy()
            stream_errs.append(float(np.abs(row - direct).max()))
            return row

        def kept(buf, weights, group_ids):
            chunks.append((buf.clone(), torch.as_tensor(
                weights, dtype=torch.float32, device="cuda"),
                torch.as_tensor(group_ids, dtype=torch.int32,
                                device="cuda")))
            return add(buf, weights, group_ids)

        svc._merge_row = checked
        svc._stream_acc.add = kept

    sizes = np.bincount(gids, minlength=sch.num_edges)

    def chunk_launches():
        return dict(segment_sum=sum(-(-int(sizes[m]) // SERVICE_STREAM_CHUNK)
                                    for m in rows))

    stream = run("streaming merge", SERVICE_STREAM_EVENTS, before=streamed,
                 extra=chunk_launches,
                 merge_stream_chunk=SERVICE_STREAM_CHUNK)
    prefix = _merge_records(full.trace)[:len(_merge_records(stream.trace))]
    print(f"  streaming merge (chunks of {SERVICE_STREAM_CHUNK}): "
          f"{len(rows)} merge rows, {len(chunks)} chunks; streamed vs "
          f"direct row max|err| {max(stream_errs)!r}; trace = the "
          f"uninterrupted run's first merges: "
          f"{_merge_records(stream.trace) == prefix}")
    check(len(chunks) == chunk_launches()["segment_sum"],
          f"{len(chunks)} chunks folded, {chunk_launches()} expected")
    check(max(stream_errs) <= STREAM_MERGE_TOL,
          f"streamed rows vs direct {max(stream_errs)!r}")
    check(_merge_records(stream.trace) == prefix,
          "two runs of one configuration gave different traces")
    # K4 at the chunks the service gave it, against its plain version:
    # on the path's own rows, and on distinct random rows of the same
    # shape under the path's weights (at merge time a cohort's rows all
    # hold one edge mean, so only distinct rows show a wrong row order
    # or weight index).  These launches come after the counts were read.
    gen = torch.Generator(device="cuda").manual_seed(SERVICE_CHUNK_SEED)
    cases = {}
    for i, (buf, w, gid) in enumerate(chunks):
        cases[f"service_chunk{i}"] = (buf, w, gid, 1)
        cases[f"service_chunk{i}_distinct"] = (
            torch.randn(buf.shape, generator=gen, device="cuda"), w, gid, 1)
    err = check_segment_sum_against_plain(cases)
    print(f"  segment_sum at the service's {len(chunks)} chunks "
          f"({tuple(chunks[0][0].shape)}, M=1): max|err| {err:.3e} against "
          f"its plain version")

    faulted = run("edge_outage", SERVICE_FAULT_EVENTS,
                  fault_model=scenario("edge_outage").faults,
                  fault_seed=SERVICE_FAULT_SEED)
    kinds = {r["kind"] for r in faulted.trace}
    check({"fail", "repair", "failover"} <= kinds,
          f"edge_outage: records {sorted(kinds)}")
    fo = [r for r in faulted.trace if r["kind"] == "failover"][0]
    print(f"  edge_outage: records {sorted(kinds)}; failover at t={fo['t']} "
          f"of edges {fo['edges']} ({fo['orphans']} orphans)")
    dead = int(gids[0])
    tracing.reset()
    faulted.sim.replay_departure(faulted.g, np.ones(gids.size, bool),
                                 ue_ok=gids != dead)
    got = tracing.launches()
    check(got == expect(segment_aggregate=sch.b), f"dead wave: {got}")
    for name in KERNELS:
        launches[name] += got[name]
    flat = faulted.sim.flat_state()
    check(bool(np.isfinite(flat).all()) and (flat[gids == dead] == 0).all(),
          "a dead cohort's rows are not exactly 0")
    print(f"  a wave with edge {dead}'s cohort dead: its rows exactly 0, "
          f"every row finite")

    killed = finish_service_kill(kill, kill_dir)
    for name in KERNELS:
        launches[name] += killed[name]
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(trace=stream.trace, g=stream.g)


def kill_args(ckpt_dir: str) -> list:
    """The service CLI on the card with the JAX package's
    ``tools/crash_smoke.py`` settings, checkpointing into ``ckpt_dir``."""
    return [sys.executable, "-m", "repro_torch.launch.service", "--device",
            "cuda", "--ues", str(KILL_UES), "--edges", str(KILL_EDGES),
            "--max-staleness", str(SERVICE_STALENESS), "--segments",
            SERVICE_SEGMENTS, "--max-updates", str(KILL_EVENTS),
            "--ckpt-every", str(KILL_CKPT_EVERY), "--ckpt-dir", ckpt_dir]


def kill_and_resume(ckpt_dir: str, procs: list) -> dict:
    """Start the service CLI, SIGKILL it after two checkpoints and rerun
    it with ``--resume`` to its end; each process is appended to
    ``procs`` as it starts, and every wait times out."""
    from repro_torch.launch import service as S
    cmd = kill_args(ckpt_dir)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    log = os.path.join(ckpt_dir, "victim.log")
    t0 = time.perf_counter()
    with open(log, "w") as err:
        victim = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                  stderr=err)
    procs.append(victim)
    while len(S.list_checkpoints(ckpt_dir)) < 2:
        if victim.poll() is not None:
            raise RuntimeError(
                f"victim exited (rc={victim.returncode}) before two "
                f"checkpoints: {open(log).read()[-2000:]}")
        check(time.perf_counter() - t0 < KILL_TIMEOUT_S,
              "no checkpoints from the victim")
        time.sleep(0.05)
    victim.send_signal(signal.SIGKILL)
    victim.wait(timeout=30)
    check(victim.returncode == -signal.SIGKILL,
          f"victim rc {victim.returncode}")
    out = dict(killed=len(S.list_checkpoints(ckpt_dir)),
               victim_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    resume = subprocess.Popen(cmd + ["--resume"], env=env,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
    procs.append(resume)
    _, err = resume.communicate(timeout=KILL_TIMEOUT_S)
    check(resume.returncode == 0, f"--resume failed: {err[-2000:]}")
    out["resume_s"] = time.perf_counter() - t0
    return out


def start_service_kill(ckpt_dir: str) -> dict:
    """``kill_and_resume`` on a thread, so that its processes run beside
    the in-process services; returns its state for
    ``finish_service_kill``, and ``stop_processes`` ends what is left."""
    state = {"procs": []}

    def pair():
        try:
            state.update(kill_and_resume(ckpt_dir, state["procs"]))
        except BaseException as e:       # re-raised on the main thread
            state["error"] = e

    state["thread"] = threading.Thread(target=pair, daemon=True)
    state["thread"].start()
    return state


def stop_processes(state: dict) -> None:
    for proc in state["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def finish_service_kill(state: dict, ckpt_dir: str) -> dict:
    """Wait for the SIGKILL pair and hold the resumed CLI's final
    checkpoint to an in-process run's; returns the in-process run's
    launches."""
    from repro_torch.checkpoint import latest_checkpoint, load_pytree
    from repro_torch.launch import service as S
    state["thread"].join(timeout=2 * KILL_TIMEOUT_S + 60)
    check(not state["thread"].is_alive(), "the SIGKILL pair did not end")
    if "error" in state:
        raise state["error"]
    tree, _ = load_pytree(latest_checkpoint(ckpt_dir))
    trace = json.loads(str(tree["trace_json"]))
    merges = _merge_records(trace)

    def build():
        sim = S.default_service_sim(KILL_UES, KILL_EDGES,
                                    max_staleness=SERVICE_STALENESS,
                                    device="cuda")
        waves = count_waves(sim)
        return S.HFLService(sim, S.ServiceConfig(
            segments=S._parse_segments(SERVICE_SEGMENTS),
            max_staleness=SERVICE_STALENESS)), waves

    ref, got = counted_run("SIGKILL's in-process run", build, KILL_EVENTS)
    err = float(np.abs(np.asarray(tree["g"], np.float32) - ref.g).max())
    print(f"  SIGKILL (beside the in-process runs above): the CLI killed at "
          f"{state['killed']} checkpoints after {state['victim_s']:.3f} s, "
          f"--resume finished {KILL_EVENTS} events in "
          f"{state['resume_s']:.3f} s (process start included); resumed "
          f"trace equal {merges == _merge_records(ref.trace)}, "
          f"{sum(x['kind'] == 'resume' for x in trace)} resume record; "
          f"model max|err| {err!r}")
    check(merges == _merge_records(ref.trace),
          "SIGKILL: resumed trace differs")
    check(any(x["kind"] == "resume" for x in trace), "no resume record")
    check(err <= SERVICE_MODEL_TOL, f"SIGKILL: model max|err| {err!r}")
    return got


# ---------------------------------------------------------------------------
# Phase 14
# ---------------------------------------------------------------------------


def count_merge_rows(svc) -> list:
    """Record the edge of every merge row ``svc`` reads into the returned
    list."""
    edges, read = [], svc._merge_row

    def counted(m):
        edges.append(m)
        return read(m)

    svc._merge_row = counted
    return edges


def spmd_inputs(sch, ue_data) -> tuple:
    """Phase 14's SPMD fleet: the first two UEs of edges 0 and 1 (rank r
    is UE r % 2 of edge r // 2), each resampled to SAMPLES_PER_UE samples
    as the simulator resamples, and their D_n."""
    e, u = FL_MESH
    gids = sch.assoc.argmax(1)
    idx = np.concatenate([np.flatnonzero(gids == m)[:u] for m in range(e)])
    rng = np.random.default_rng(0)
    picks = []
    for i in idx:
        n = len(ue_data[i]["labels"])
        picks.append(rng.choice(n, size=SAMPLES_PER_UE,
                                replace=n < SAMPLES_PER_UE))
    batches = {k: np.stack([ue_data[i][k][ix] for i, ix in zip(idx, picks)])
               for k in ue_data[0]}
    return batches, sch.problem.samples[idx].astype(np.float32)


def spmd_loop(sch, ue_data, noise=0.0, noise_seed=1) -> list:
    """The SPMD round's fleet on one card as a stacked loop: b* times a*
    GD steps (``clients.gd_local_steps``) and the edge means, then the
    cloud mean (``stacked_weighted_average``: K1, K2)."""
    from repro_torch.fl import clients, spmd
    from repro_torch.fl.aggregate import stacked_weighted_average
    from repro_torch.fl.flatten import FlatLayout
    e, u = FL_MESH
    batches, weights = spmd_inputs(sch, ue_data)
    batches = {k: torch.as_tensor(v, device="cuda")
               for k, v in batches.items()}
    w = torch.as_tensor(weights, device="cuda")
    gid = torch.arange(e, device="cuda").repeat_interleave(u)
    stacked = spmd.stack_for_mesh(lenet_params("cuda", noise, noise_seed),
                                  e, u)
    layout = FlatLayout.of(stacked)
    p = layout.unravel(layout.ravel(stacked))
    gd = clients.gd_local_steps(lenet_loss, sch.a, LR)
    for _ in range(sch.b):
        gd(p, batches)
        p = stacked_weighted_average(p, w, group_ids=gid, num_groups=e)
    return [t.cpu() for t in tree_leaves(stacked_weighted_average(p, w))]


def stream_slab(sim) -> dict:
    """Part (d) on a rank: its slab folded through
    ``StreamingEdgeAccumulator`` in MESH_STREAM_CHUNK-row chunks (counted),
    held to K1 on the same slab, and likewise distinct random rows of its
    shape under its weights (at this point an edge's rows all hold one
    mean)."""
    slab, w, g = sim._flat, sim._local_weights, sim._local_gids
    M = sim.schedule.num_edges
    acc = StreamingEdgeAccumulator(M, slab.shape[1], device=slab.device)

    def fold(x):
        acc.reset()
        for s in range(0, x.shape[0], MESH_STREAM_CHUNK):
            stop = s + MESH_STREAM_CHUNK
            acc.add(x[s:stop], w[s:stop], g[s:stop])
        return acc.scatter(g)

    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    streamed = fold(slab)
    torch.cuda.synchronize()
    out = dict(wall=time.perf_counter() - t0, launches=tracing.launches(),
               chunks=-(-slab.shape[0] // MESH_STREAM_CHUNK))
    gen = torch.Generator(device=slab.device).manual_seed(
        MESH_STREAM_SEED + sim.mesh.rank)
    for name, x in (("slab", slab),
                    ("distinct", torch.randn(slab.shape, generator=gen,
                                             device=slab.device))):
        got = streamed if name == "slab" else fold(x)
        ref = ha.segment_aggregate(x, w, g, M)
        out[name] = dict(err=_max_err(got, ref),
                         scale=float(ref.abs().max()),
                         finite=bool(torch.isfinite(got).all()))
    return out


def mesh_rank(sch, ue_data, test, ckpt_dir, spawned: float) -> dict:
    """One rank of phase 14, run by ``run_ranks`` (``spawn`` imports this
    script in each rank; ``main`` does not run there).  ``spawned``: the
    parent's clock (``time.time()``) just before the spawn; the rank's
    start-up stamps come back in ``out["startup"]``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import faults as F
    from repro_torch.core import scenario
    from repro_torch.fl import spmd
    from repro_torch.fl.sampling import make_sampler
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import service as S
    from repro_torch.launch.mesh import make_fl_mesh
    entered = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True       # as phase_mesh
    torch.set_num_threads(2)
    timeout = datetime.timedelta(seconds=MESH_TIMEOUT_S)
    mesh = make_agg_mesh(1, MESH_RANKS, timeout=timeout)
    out = dict(rank=mesh.rank, device=str(mesh.device))
    t = mesh_lib.rank_times
    stamps = [("interpreter and spawn", spawned, T_IMPORT),
              ("import of chip_smoke.py", T_IMPORT, T_IMPORTED),
              ("arguments unpickled", T_IMPORTED, t["entered"]),
              ("CUDA context", t["entered"], t["device"]),
              ("gloo rendezvous", t["device"], t["group"]),
              ("rank's own imports", t["group"], entered),
              ("mesh's groups", entered, time.time())]

    def counted(fn):
        torch.cuda.synchronize()
        tracing.reset()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0, tracing.launches()

    # (a) phase 5's async run on the mesh, CUT_ROUNDS rounds' quota
    t0 = time.time()
    sim = make_sim(sch, ue_data, mesh.device, mesh=mesh, mode="async",
                   max_staleness=ASYNC_STALENESS)
    stamps.append(("(a)'s simulator built", t0, time.time()))
    res, wall, launched = counted(
        lambda: sim.run(test, rounds=CUT_ROUNDS))
    out["startup"] = [(what, b - a) for what, a, b in stamps]
    tl = res.timeline
    out["async"] = dict(run_summary(res), trace=tl.trace, times=res.times,
                        wall=wall, launches=launched,
                        waves=departure_waves(tl), updates=len(tl.updates),
                        slab=tuple(sim._flat.shape))
    # (d) the slab after (a), streamed
    out["stream"] = stream_slab(sim)
    del sim

    # (b) phase 11's deadline+failover and sampled sync runs on the mesh
    for name, kw in (
            ("faulty", dict(delay_model=scenario(FAULT_SCENARIO).model,
                            fault_model=fault_model(),
                            fault_policy=F.deadline_failover_policy(),
                            fault_seed=FAULT_SEED)),
            ("sampled", dict(sampler=make_sampler(SAMPLER, SAMPLE_RATE),
                             sample_seed=FAULT_SEED))):
        fsim = make_sim(sch, ue_data, mesh.device, mesh=mesh, **kw)
        res, wall, launched = counted(
            lambda: fsim.run(test, rounds=FAULT_ROUNDS))
        out[name] = dict(run_summary(res), times=res.times, wall=wall,
                         launches=launched,
                         masks=fsim._sync_plan(FAULT_ROUNDS)[1])
        del fsim

    # (c) phase 13's streamed service on the mesh, checkpointed by rank 0
    # at event MESH_CKPT_AT, then resumed on fresh mesh services
    cfg = S.ServiceConfig(segments=S._parse_segments(SERVICE_SEGMENTS),
                          max_staleness=SERVICE_STALENESS,
                          merge_stream_chunk=SERVICE_STREAM_CHUNK,
                          ckpt_dir=ckpt_dir, ckpt_every=MESH_CKPT_AT)

    def service(before=None) -> dict:
        def build():
            ssim = make_sim(sch, ue_data, mesh.device, mesh=mesh,
                            mode="async", max_staleness=SERVICE_STALENESS)
            waves = count_waves(ssim)
            svc = S.HFLService(ssim, cfg)
            rows = count_merge_rows(svc)
            start = before(svc) if before is not None else 0
            svc.run(SERVICE_STREAM_EVENTS)
            return svc, waves[0], rows, start

        (svc, waves, rows, start), wall, launched = counted(build)
        members = np.bincount(svc._gids[svc._w > 0])
        return dict(trace=svc.trace, g=svc.g, wall=wall, launches=launched,
                    start=start, events=svc.events_done, want=expect(
                        segment_aggregate=sch.b * waves,
                        segment_sum=sum(-(-int(members[m]) //
                                          SERVICE_STREAM_CHUNK)
                                        for m in rows)))

    out["service"] = service()
    if mesh.rank == 0:               # a crash after the first checkpoint
        for path in S.list_checkpoints(ckpt_dir)[1:]:
            os.remove(path)
    dist.barrier()
    src = []

    def restore(svc):
        src.append(os.path.basename(svc.restore_latest()))
        return svc.events_done

    out["resumed"] = dict(service(before=restore), src=src[0])

    # (e) the SPMD round on a 2 x 2 ('edge', 'ue') mesh, one UE a rank
    fl = make_fl_mesh(*FL_MESH, timeout=timeout)
    batches, weights = spmd_inputs(sch, ue_data)
    stacked = spmd.stack_for_mesh(lenet_params("cpu"), *FL_MESH)
    fn = spmd.make_hfl_cloud_round(lenet_loss, fl, a=sch.a, b=sch.b, lr=LR)
    got, wall, launched = counted(lambda: fn(
        fl.local(stacked), fl.local(batches), fl.local(weights)))
    out["spmd"] = dict(final=[t.cpu() for t in tree_leaves(got)], wall=wall,
                       launches=launched, coords=(fl.edge_index, fl.ue_index))
    # phase 15 (d): launch.train's --mode hfl rounds on the same mesh
    out["hfl"] = hfl_rank(fl)
    return out


def _spread(base: dict, moved: list, keys) -> dict:
    """The largest distance of ``moved`` summaries from ``base``, by key."""
    out = {}
    for key in keys:
        if key == "final":
            out[key] = max(max(_max_err(a, b) for a, b in
                               zip(m["final"], base["final"]))
                           for m in moved)
        else:
            out[key] = max(float(np.abs(m[key] - base[key]).max())
                           for m in moved)
    return out


def mesh_references(sch, ue_data, test, refs) -> dict:
    """Phase 14's single-device references not already run by phases 5,
    11 and 13 (phase 5's async run again at CUT_ROUNDS rounds'
    quota, with cuDNN's deterministic algorithms, its timeline kept), and
    the spread of each reference under a SENSITIVITY_NOISE init move."""
    from repro_torch.core import faults as F
    from repro_torch.core import scenario
    from repro_torch.fl.sampling import make_sampler
    from repro_torch.launch import service as S
    t0 = time.perf_counter()
    out, walls = {}, {}

    def async_run(**kw):
        res = make_sim(sch, ue_data, "cuda", mode="async",
                       max_staleness=ASYNC_STALENESS, **kw).run(
            test, rounds=CUT_ROUNDS)
        return dict(run_summary(res), trace=res.timeline.trace,
                    times=res.times)

    def lap(name):
        walls[name] = time.perf_counter() - t0 - sum(walls.values())

    base = async_run()
    out["async"] = (base, _spread(
        base, [async_run(noise=SENSITIVITY_NOISE, noise_seed=seed)
               for seed in MESH_SPREAD_SEEDS],
        ("final", "test_loss", "train_loss")))
    lap("async")
    for name, kw in (
            ("faulty", dict(delay_model=scenario(FAULT_SCENARIO).model,
                            fault_model=fault_model(),
                            fault_policy=F.deadline_failover_policy(),
                            fault_seed=FAULT_SEED)),
            ("sampled", dict(sampler=make_sampler(SAMPLER, SAMPLE_RATE),
                             sample_seed=FAULT_SEED))):
        out[name] = _spread(refs[name], [run_summary(make_sim(
            sch, ue_data, "cuda", noise=SENSITIVITY_NOISE, noise_seed=seed,
            **kw).run(test, rounds=FAULT_ROUNDS))
            for seed in MESH_SPREAD_SEEDS], ("final",))["final"]
        lap(name)
    moved = []
    for seed in MESH_SPREAD_SEEDS:
        svc = S.HFLService(
            make_sim(sch, ue_data, "cuda", noise=SENSITIVITY_NOISE,
                     noise_seed=seed, mode="async",
                     max_staleness=SERVICE_STALENESS),
            S.ServiceConfig(segments=S._parse_segments(SERVICE_SEGMENTS),
                            max_staleness=SERVICE_STALENESS,
                            merge_stream_chunk=SERVICE_STREAM_CHUNK))
        svc.run(SERVICE_STREAM_EVENTS)
        moved.append(float(np.abs(svc.g - refs["service"]["g"]).max()))
    out["service"] = max(moved)
    lap("service")
    base = spmd_loop(sch, ue_data)
    out["spmd"] = (base, max(
        max(_max_err(a, b) for a, b in zip(
            spmd_loop(sch, ue_data, SENSITIVITY_NOISE, seed), base))
        for seed in MESH_SPREAD_SEEDS))
    lap("spmd")
    base = hfl_loop()
    out["hfl"] = (base, max(
        max(_max_err(a, b) for moved, ref in zip(
            hfl_loop(SENSITIVITY_NOISE, seed), base)
            for a, b in zip(moved, ref))
        for seed in MESH_SPREAD_SEEDS))
    lap("hfl")
    out["wall"], out["walls"] = time.perf_counter() - t0, walls
    return out


def phase_mesh(sch, ue_data, test, refs) -> dict:
    """Phase 14; returns each kernel's launches summed over the ranks and
    their paths.  cuDNN's deterministic algorithms in the ranks and in the
    references, as phase 9."""
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_mesh(sch, ue_data, test, refs)
    finally:
        torch.backends.cudnn.deterministic = False


def hold_model(label: str, diff: float, spread: float) -> None:
    print(f"  {label}: max|diff| {diff:.3e}; spread under a "
          f"{SENSITIVITY_NOISE:g} init move {spread:.3e} (ratio "
          f"{diff / max(spread, 1e-30):.2f})")
    check(spread > 0, f"{label}: the moved run moved")
    check(diff <= SENSITIVITY_FACTOR * spread,
          f"{label}: {diff:.3e} > {SENSITIVITY_FACTOR} x spread "
          f"{spread:.3e}")


def _phase_mesh(sch, ue_data, test, refs) -> dict:
    from repro_torch.fl.flatten import _pack_groups
    t_phase = time.perf_counter()
    b = sch.b
    gids = sch.assoc.argmax(1)
    perm, n_padded = _pack_groups(gids, MESH_RANKS)
    per = n_padded // MESH_RANKS
    inv = np.empty(gids.size, np.int64)
    inv[perm[perm >= 0]] = np.flatnonzero(perm >= 0)
    slabs = [perm[i * per:(i + 1) * per] for i in range(MESH_RANKS)]
    print(f"_pack_groups({MESH_RANKS} shards): {n_padded} padded rows, "
          f"{per} a rank; edges a rank "
          f"{[sorted(set(gids[x[x >= 0]].tolist())) for x in slabs]}, pad "
          f"rows a rank {[int((x < 0).sum()) for x in slabs]}")
    check(per == MESH_ROWS, f"{per} rows a rank, not {MESH_ROWS}")

    torch.cuda.empty_cache()        # the ranks share the card with us
    state = {}
    with tempfile.TemporaryDirectory() as tmp:
        def spawn():
            t0 = time.perf_counter()
            try:
                state["ranks"] = run_ranks(
                    mesh_rank, MESH_RANKS, sch, ue_data, test, tmp,
                    time.time(), device="cuda", timeout_s=MESH_TIMEOUT_S)
            except BaseException as e:   # re-raised on the main thread
                state["error"] = e
            state["wall"] = time.perf_counter() - t0

        thread = threading.Thread(target=spawn, daemon=True)
        thread.start()
        ref = mesh_references(sch, ue_data, test, refs)
        thread.join(timeout=MESH_TIMEOUT_S + 60)
        check(not thread.is_alive(), "the ranks did not end")
    if "error" in state:
        raise state["error"]
    ranks = state["ranks"]
    print(f"{MESH_RANKS} ranks (gloo, all on {ranks[0]['device']}) on a "
          f"{MESH_RANKS} x 1 mesh, then a {FL_MESH[0]} x {FL_MESH[1]} "
          f"('edge', 'ue') mesh: {state['wall']:.1f} s from spawn to "
          f"results; the single-device references and spreads beside them "
          f"{ref['wall']:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in ref["walls"].items()) + ")")
    for r in ranks:
        print(f"  rank {r['rank']} start-up, s: " + "; ".join(
            f"{what} {sec:.2f}" for what, sec in r["startup"])
            + f"; (a)'s run {r['async']['wall']:.2f}")
    n_test = len(test["labels"])
    launches = dict.fromkeys(KERNELS, 0)

    def add(got):
        for name in KERNELS:
            launches[name] += got[name]

    def agree(part, keys=("final",)):
        first = ranks[0][part]
        for r in ranks[1:]:
            for key in keys:
                if key == "final":
                    same = all(torch.equal(x, y) for x, y in
                               zip(first[key], r[part][key]))
                else:
                    same = np.array_equal(first[key], r[part][key])
                check(same, f"({part}) rank {r['rank']}'s {key} differs "
                            f"from rank 0's")

    # (a) async on the mesh
    base, spread = ref["async"]
    for r in ranks:
        a = r["async"]
        print(f"  (a) rank {r['rank']}: slab {a['slab']} fp32; "
              f"{a['updates']} updates, {a['waves']} waves in "
              f"{a['wall']:.3f} s ({a['wall'] / a['updates']:.3f} s an "
              f"update, first call included); launches {a['launches']}")
        check(a["slab"] == (MESH_ROWS, LENET_PARAMS),
              f"rank {r['rank']}: slab {a['slab']}")
        check(a["trace"] == base["trace"]
              and np.array_equal(a["times"], base["times"]),
              f"(a) rank {r['rank']}: timeline or clock != the single-"
              f"device run's")
        check(a["launches"] == expect(segment_aggregate=b * a["waves"]),
              f"(a) rank {r['rank']}: launches {a['launches']}")
        add(a["launches"])
    agree("async", ("final", "test_loss", "train_loss", "test_acc"))
    first = ranks[0]["async"]
    hold_model("(a) async mesh vs one card, params", max(
        _max_err(x, y) for x, y in zip(first["final"], base["final"])),
        spread["final"])
    for key in ("test_loss", "train_loss"):
        hold_model(f"(a) async mesh vs one card, {key}", float(
            np.abs(first[key] - base[key]).max()), spread[key])
    # float32 accuracies: one sample apart is 1/n_test up to rounding
    acc = float(np.abs(first["test_acc"] - base["test_acc"]).max())
    check(round(acc * n_test) <= 1, f"(a) accuracy {acc} apart, more than "
                                    f"one of {n_test} test samples")

    # (d) the slab streamed
    for r in ranks:
        d = r["stream"]
        print(f"  (d) rank {r['rank']}: slab folded in {d['chunks']} chunks "
              f"of {MESH_STREAM_CHUNK} in {d['wall'] * 1e3:.3f} ms; "
              f"launches {d['launches']}; against K1 on the slab max|err| "
              f"{d['slab']['err']:.3e} (scale {d['slab']['scale']:.3e}), on "
              f"distinct rows {d['distinct']['err']:.3e} (scale "
              f"{d['distinct']['scale']:.3e})")
        check(d["launches"] == expect(segment_sum=d["chunks"]),
              f"(d) rank {r['rank']}: launches {d['launches']}")
        for case in ("slab", "distinct"):
            check(d[case]["finite"] and d[case]["err"] <= STREAM_RTOL *
                  max(d[case]["scale"], 1e-30),
                  f"(d) rank {r['rank']} {case}: {d[case]['err']:.3e}")
        add(d["launches"])

    # (b) faults and sampling on the mesh
    for name in ("faulty", "sampled"):
        want = refs[name]
        k = int(want["masks"].any(axis=1).sum())
        for r in ranks:
            f = r[name]
            print(f"  (b) {name}, rank {r['rank']}: {FAULT_ROUNDS} rounds in "
                  f"{f['wall']:.3f} s; launches {f['launches']}")
            masks = f["masks"]
            check(np.array_equal(f["times"], want["times"])
                  and np.array_equal(masks[:, inv], want["masks"]),
                  f"(b) {name}, rank {r['rank']}: clock or masks != "
                  f"phase 11's")
            if name == "sampled":
                check(not masks[:, perm < 0].any(), "a pad row sampled")
            check(f["launches"] == expect(segment_aggregate=b * k,
                                          weighted_mean=k),
                  f"(b) {name}, rank {r['rank']}: launches {f['launches']}")
            add(f["launches"])
        agree(name)
        hold_model(f"(b) {name} mesh vs phase 11, params", max(
            _max_err(x, y) for x, y in zip(ranks[0][name]["final"],
                                           want["final"])), ref[name])

    # (c) the service on the mesh
    single = refs["service"]
    for r in ranks:
        for part in ("service", "resumed"):
            c = r[part]
            events = c["events"] - c["start"]
            print(f"  (c) {part}, rank {r['rank']}: events {c['start']}.."
                  f"{c['events']} in {c['wall']:.3f} s "
                  f"({c['wall'] / events:.4f} s an event, construction "
                  f"included); launches {c['launches']}")
            check(c["launches"] == c["want"],
                  f"(c) {part}, rank {r['rank']}: launches {c['launches']} "
                  f"!= {c['want']}")
            add(c["launches"])
        c, res = r["service"], r["resumed"]
        check([x for x in c["trace"] if x["kind"] != "ckpt"] ==
              single["trace"], f"(c) rank {r['rank']}: trace != phase 13's")
        check(res["src"] == "ckpt-1.npz" and res["start"] == MESH_CKPT_AT,
              f"(c) rank {r['rank']}: resumed from {res['src']} at "
              f"{res['start']}")
        err = float(np.abs(res["g"] - c["g"]).max())
        check(_merge_records(res["trace"]) == _merge_records(c["trace"])
              and err <= SERVICE_MODEL_TOL,
              f"(c) rank {r['rank']}: resumed trace or model ({err!r})")
        check(np.array_equal(c["g"], ranks[0]["service"]["g"]),
              f"(c) rank {r['rank']}'s model differs from rank 0's")
    err = float(np.abs(ranks[0]["resumed"]["g"] -
                       ranks[0]["service"]["g"]).max())
    print(f"  (c) mesh trace = phase 13's streamed service's, record for "
          f"record; resumed from ckpt-1 (event {MESH_CKPT_AT}, rank 0's): "
          f"trace equal, model max|err| {err!r}")
    hold_model("(c) service mesh vs phase 13, g", float(
        np.abs(ranks[0]["service"]["g"] - single["g"]).max()),
        ref["service"])

    # (e) the SPMD round
    base, spread = ref["spmd"]
    diff = 0.0
    for r in ranks:
        e = r["spmd"]
        print(f"  (e) rank {r['rank']} (edge {e['coords'][0]}, UE "
              f"{e['coords'][1]}): one cloud round, a*={sch.a} b*={b}, in "
              f"{e['wall']:.3f} s; launches {e['launches']}")
        check(e["launches"] == expect(), f"(e) rank {r['rank']} launched "
                                         f"{e['launches']}")
        diff = max(diff, max(_max_err(x[0], y[r["rank"]])
                             for x, y in zip(e["final"], base)))
    hold_model("(e) SPMD round vs the stacked loop on one card", diff,
               spread)
    check_hfl(ranks, ref)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 15
# ---------------------------------------------------------------------------


def phase_train() -> dict:
    """Part (a): ``launch.train``'s CLI at its defaults on the card:
    full-width StableLM-1.6B, AdamW, B=8, S=128, TRAIN_STEPS steps through
    ``impl="xla_flash"``, with no kernel launch; then one warm step
    profiled.  Returns the trained params and optimizer state with the
    step, its batch and its warm time, for phase 18."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = train.parse_args(TRAIN_ARGV)
    tracing.reset()
    t0 = time.perf_counter()
    res = train.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tracing.launches()
    peak = torch.cuda.max_memory_allocated()
    losses, step_s = res["losses"], res["step_s"]
    warm = float(np.median(step_s[1:]))
    tokens = args.batch * args.seq
    share = 6 * CLI_PARAMS * tokens / warm / PEAK_FLOPS_FP32
    print(f"train CLI {TRAIN_ARGV}: {wall:.2f} s with init; losses "
          f"{[round(x, 4) for x in losses]}; first step "
          f"{step_s[0] * 1e3:.1f} ms, warm steps median {warm * 1e3:.1f} ms "
          f"(min {min(step_s[1:]) * 1e3:.1f}, max "
          f"{max(step_s[1:]) * 1e3:.1f}); {tokens / warm:.0f} tokens/s; "
          f"6*N*tokens/step time = {share:.1%} of {PEAK_FLOPS_FP32:.3g} "
          f"FLOP/s fp32; peak memory {peak} B; launches {launches}")
    check(launches == expect(), f"training launched kernels: {launches}")
    check(len(losses) == args.steps and bool(np.isfinite(losses).all()),
          "finite training losses")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    n = sum(t.numel() for t in tree_leaves(res["params"]))
    check(n == CLI_PARAMS, f"{n} trained parameters != {CLI_PARAMS}")

    model = Model(get_config(args.arch), impl="xla_flash")
    step = steps_lib.make_train_step(model, adamw(args.lr))
    batch = TokenStream(model.cfg.vocab_size, seed=0).batch(args.batch,
                                                            args.seq)
    params, state = res["params"], res["opt_state"]
    del res
    wall_us, kernels = device_profile(lambda: step(params, state, batch))
    if kernels:
        busy = sum(e.self_device_time_total for e in kernels)
        gemm = sum(e.self_device_time_total for e in kernels
                   if "gemm" in e.key.lower())
        print(f"profiled warm step: {wall_us / 1e3:.3f} ms wall (profiler "
              f"on), device busy {busy / 1e3:.3f} ms = "
              f"{busy / wall_us:.1%} of it and {busy / 1e6 / warm:.1%} of "
              f"the unprofiled warm step; matrix products "
              f"{gemm / 1e3:.3f} ms = {gemm / busy:.1%} of device time; "
              f"{sum(e.count for e in kernels)} kernel launches")
        print_top(kernels, 10)
    else:
        print("profiled warm step: the profiler recorded no device time")
    return dict(warm_s=warm, args=args, step=step, params=params,
                state=state, batch=batch)


def train_cut_step(model, params, batch) -> dict:
    """Loss, gradients and the params after one AdamW step from
    ``params`` (left as they were), all on the host."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.optim import adamw
    (loss, _), grads = value_and_grad(model.loss, params, batch)
    stepped = [t.clone() for t in tree_leaves(params)]
    opt = adamw(TRAIN_LR)
    opt.update(tree_leaves(grads), opt.init(stepped), stepped)
    return dict(loss=loss.cpu(), grads=[g.cpu() for g in tree_leaves(grads)],
                params=[t.cpu() for t in stepped])


def phase_train_card_vs_cpu() -> dict:
    """Part (b): TRAIN_CUT_LAYERS layers of StableLM-1.6B at full width,
    B=TRAIN_CUT_BATCH, S=TRAIN_CUT_SEQ, from the same init on the card and
    the CPU: the loss, every gradient leaf and the params after one AdamW
    step, each held to SENSITIVITY_FACTOR times the card's own spread
    under a SENSITIVITY_NOISE move of the embedding (cuDNN's deterministic
    algorithms).  The loss is one float32 number: its spread counts at
    least one float32 step at its value, the least the move can show.
    Returns the FLOPs of the cut's step on the card and on the CPU (cost
    walks of the unmoved runs), for phase 18."""
    cfg = dataclasses.replace(get_config(CLI_ARCH),
                              num_layers=TRAIN_CUT_LAYERS)
    card = Model(cfg, impl="xla_flash")
    params = card.init(0)
    batch = TokenStream(cfg.vocab_size, seed=0).batch(TRAIN_CUT_BATCH,
                                                      TRAIN_CUT_SEQ)
    tracing.reset()
    torch.backends.cudnn.deterministic = True
    try:
        got, card_cost = walk(train_cut_step, card, params, batch)
        moved = train_cut_step(card, perturbed(params), batch)
    finally:
        torch.backends.cudnn.deterministic = False
    check(tracing.launches() == expect(), f"training cut launched {tracing.launches()}")
    cpu_params = to_cpu(params)
    del params
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu, cpu_cost = walk(train_cut_step, Model(cfg, impl="xla_flash",
                                               device="cpu"),
                         cpu_params, batch)
    print(f"  training cut, {TRAIN_CUT_LAYERS} layers at full width "
          f"({sum(t.numel() for t in cpu['params'])} parameters), "
          f"B={TRAIN_CUT_BATCH} S={TRAIN_CUT_SEQ}: CPU "
          f"{time.perf_counter() - t0:.1f} s; loss card "
          f"{float(got['loss'])!r}, CPU {float(cpu['loss'])!r}, moved "
          f"{float(moved['loss'])!r}")
    ulp = float(np.spacing(np.float32(cpu["loss"])))
    diff = max_diff(got["loss"], cpu["loss"])
    spread = max(max_diff(got["loss"], moved["loss"]), ulp)
    print(f"  card vs CPU, training loss: max|diff| {diff:.3e}; spread "
          f"(at least one float32 step, {ulp:.3e}) {spread:.3e} (ratio "
          f"{diff / spread:.2f})")
    check(diff <= SENSITIVITY_FACTOR * spread,
          f"training loss: {diff:.3e} > {SENSITIVITY_FACTOR} x {spread:.3e}")
    for what in ("grads", "params"):
        hold_to_spread("card vs CPU", f"training {what} (one AdamW step)"
                       if what == "params" else "training gradients",
                       got[what], cpu[what], got[what], moved[what])
    return dict(card=card_cost["flops"], cpu=cpu_cost["flops"])


def phase_refuse_autograd() -> None:
    """Part (c): each kernel wrapper raises on CUDA inputs that require
    grad (its output would carry no gradient) and launches under
    ``torch.no_grad()``."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, kv = rand(1, 64, 4, 64), rand(1, 64, 2, 64)
    sp = torch.arange(64, dtype=torch.int32, device="cuda")
    pos = torch.tensor(63, dtype=torch.int32, device="cuda")
    calls = {
        "flash_attention": (fa.flash_attention, (q, kv, kv)),
        "rglru_scan": (rs.rglru_scan, (torch.rand(1, 64, 128, generator=gen,
                                                  device="cuda"),
                                       rand(1, 64, 128))),
        "decode_attention": (lambda *t: da.decode_attention(*t, sp, pos),
                             (q[:, -1:], kv, kv))}
    for name, (fn, args) in calls.items():
        leaf = args[0].clone().requires_grad_()
        tracing.reset()
        try:
            fn(leaf, *args[1:])
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        check("xla_flash" in raised and tracing.launches() == expect(),
              f"{name} took inputs that require grad")
        with torch.no_grad():
            out = fn(leaf, *args[1:])
        torch.cuda.synchronize()
        check(tracing.launches() == expect(**{name: 1})
              and bool(torch.isfinite(out).all()),
              f"{name} under no_grad: launches {tracing.launches()}")
        print(f"  {name}: raised under autograd ({raised[:60]}...); "
              f"launched once under torch.no_grad()")


def walk(fn, *args):
    """``fn(*args)`` under a cost walk (``roofline.CostWalk``), the card
    synchronised inside it: (its result, the walk's dict)."""
    with CostWalk() as w:
        out = fn(*args)
        torch.cuda.synchronize()
    return out, w.result()


def print_report(label: str, rep: dict) -> None:
    print(f"  roofline {label} (fp32 peak {PEAK_FLOPS_FP32:g} FLOP/s, HBM "
          f"{HBM_BW:g} B/s, NVLink {NVLINK_BW:g} B/s each way): "
          + ", ".join(f"{k} {v!r}" for k, v in rep.items()))


def phase_roofline(trained: dict, cut: dict) -> dict:
    """Phase 18 on phase 15's StableLM-1.6B (``trained``, its params and
    AdamW state still on the card) and phase 15 (b)'s cut FLOPs
    (``cut``); frees the params at its end.  Returns the kernel launches
    of its serving walks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import delay
    from repro_torch.core.schedule import plan_from_roofline
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw
    args = trained["args"]
    cfg = get_config(args.arch)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in trained["batch"].items()}

    # (a) one warm step of the full-width train step, walked
    tracing.reset()
    t0 = time.perf_counter()
    _, full = walk(trained["step"], trained["params"], trained["state"],
                   batch)
    walk_s = time.perf_counter() - t0
    check(tracing.launches() == expect() and not full["kernels"],
          f"the train step launched {tracing.launches()}")
    flops = {}
    for layers in ROOF_CUTS:
        model = Model(dataclasses.replace(cfg, num_layers=layers),
                      impl="xla_flash")
        params = model.init(0)
        opt = adamw(args.lr)
        flops[layers] = walk(steps_lib.make_train_step(model, opt), params,
                             opt.init(params), batch)[1]["flops"]
        del model, params, opt
    c1, c2 = flops[ROOF_CUTS[0]], flops[ROOF_CUTS[1]]
    extrapolated = c2 + (cfg.num_layers - 2) * (c2 - c1)
    print(f"  train step B={args.batch} S={args.seq} fp32 AdamW, walked on "
          f"the card in {walk_s:.2f} s: {full['flops']!r} FLOPs, "
          f"{full['bytes']!r} B; cuts {flops} -> count(2) + "
          f"{cfg.num_layers - 2} x (count(2) - count(1)) = {extrapolated!r}"
          f"; phase 15 (b)'s {TRAIN_CUT_LAYERS}-layer cut: card "
          f"{cut['card']!r}, CPU {cut['cpu']!r} FLOPs")
    check(cut["card"] == cut["cpu"], "the cut's FLOPs differ between the "
          f"card and the CPU: {cut}")
    check(full["flops"] == extrapolated, f"full-width FLOPs {full['flops']}"
          f" != the layer extrapolation {extrapolated}")
    shape = ShapeConfig("train_cli", args.seq, args.batch, "train")
    rep = roofline_report(cfg, shape, record_from_trace(full),
                          dtype=torch.float32)
    print_report("train step", rep)
    warm = trained["warm_s"]
    print(f"  phase 15's warm step {warm * 1e3:.1f} ms = "
          f"{warm / rep['compute_s']:.3f} x compute_s, "
          f"{warm / rep['step_time_lower_bound_s']:.3f} x "
          "step_time_lower_bound_s")
    check(warm >= rep["compute_s"], f"the warm step {warm} s beats its "
          f"FLOPs at the fp32 peak ({rep['compute_s']} s): TF32 on, or the "
          "count wrong")

    # (b) one prefill and one decode step through the kernels, walked
    model = Model(cfg, impl="kernel")
    params = trained["params"]
    tokens = TokenStream(cfg.vocab_size, seed=0).batch(
        ROOF_BATCH, ROOF_PROMPT)["tokens"]
    launches = dict.fromkeys(KERNELS, 0)
    with torch.no_grad():
        tracing.reset()
        (logits, state), pre = walk(model.prefill, params,
                                    {"tokens": torch.as_tensor(
                                        tokens, device="cuda")})
        pre_n = tracing.launches()
        tracing.reset()
        (nxt, state), dec = walk(steps_lib.make_serve_step(model), params,
                                 state, logits.argmax(-1).to(torch.int32))
        dec_n = tracing.launches()
    check(bool(torch.isfinite(logits).all()) and tuple(nxt.shape) ==
          (ROOF_BATCH, 1), "prefill logits finite, one token a row")
    for label, walked, got, name in (("prefill", pre, pre_n,
                                      "flash_attention"),
                                     ("decode step", dec, dec_n,
                                      "decode_attention")):
        n = cfg.num_layers
        check(got == expect(**{name: n}), f"{label} launched {got}")
        check(set(walked["kernels"]) == {name}
              and walked["kernels"][name]["launches"] == got[name],
              f"{label}: costs recorded {walked['kernels']}, launches {got}")
        launches[name] += got[name]
        k = walked["kernels"][name]
        kind = "prefill" if name == "flash_attention" else "decode"
        rep_s = roofline_report(
            cfg, ShapeConfig(kind, ROOF_PROMPT, ROOF_BATCH, kind),
            record_from_trace(walked), dtype=torch.float32)
        print(f"  {label} B={ROOF_BATCH} S={ROOF_PROMPT} impl=kernel: "
              f"{walked['flops']!r} FLOPs, {walked['bytes']!r} B; {name} "
              f"{k['launches']} launches (launch_counts {got[name]}), "
              f"{k['flops'] / k['launches']!r} FLOPs and "
              f"{k['bytes'] / k['launches']!r} B each; dominant "
              f"{rep_s['dominant']}")
        print_report(label, rep_s)
    del model, params, state, logits, nxt
    trained.clear()
    torch.cuda.empty_cache()

    # (c) the plan on (a)'s terms
    sch = plan_from_roofline(rep, num_edges=ROOF_EDGES,
                             ues_per_edge=ROOF_UES,
                             model_bytes=4 * CLI_PARAMS)
    T = delay.cloud_round_time(sch.problem, sch.assoc, sch.a, sch.b)
    print(f"  plan_from_roofline(E={ROOF_EDGES}, U={ROOF_UES}, model_bytes="
          f"{4 * CLI_PARAMS}, NVLink {NVLINK_BW:g}, InfiniBand {IB_BW:g} "
          f"B/s): a*={sch.a} b*={sch.b} R={sch.rounds} "
          f"T={sch.cloud_round_time!r} s; problem meta {sch.problem.meta}; "
          f"meta {sch.meta}")
    check(sch.problem.meta["t_step"] == max(rep["compute_s"],
                                            rep["memory_s"]),
          "t_step is not max(compute_s, memory_s)")
    check(T == sch.cloud_round_time, f"T {sch.cloud_round_time} != eq. 34 "
          f"on the returned association {T}")
    return launches


def hfl_args():
    from repro_torch.launch import train
    return train.parse_args(HFL_ARGV + ["--device", "cuda"])


def hfl_schedule(args):
    return plan(HFLProblem(num_edges=args.edges,
                           num_ues=args.edges * args.ues,
                           epsilon=args.epsilon, seed=args.seed))


def hfl_loop(noise=0.0, noise_seed=1) -> list:
    """Part (d)'s reference: ``--mode hfl``'s rounds on the card as a
    stacked loop of its 2 x 2 UEs: b* times a* vmapped GD steps
    (``clients.gd_local_steps`` over ``model.loss``) and the edge means,
    then the cloud mean (``stacked_weighted_average``: K1, K2), each leaf
    moved by ``noise`` relative (a draw of ``noise_seed``) if asked.
    Returns each cloud event's params (row 0, on the host)."""
    from repro_torch.fl import clients, spmd
    from repro_torch.fl.aggregate import stacked_weighted_average
    from repro_torch.fl.flatten import FlatLayout
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_map
    args = hfl_args()
    sch = hfl_schedule(args)
    e, u = args.edges, args.ues
    model = Model(get_config(args.arch, smoke=True), impl="xla_flash",
                  remat=False)
    params = model.init(args.seed)
    if noise:
        gen = torch.Generator().manual_seed(noise_seed)
        params = tree_map(lambda v: v * (1 + noise * torch.randn(
            v.shape, generator=gen).to(v.device)), params)
    stacked = spmd.stack_for_mesh(params, e, u)
    layout = FlatLayout.of(stacked)
    p = layout.unravel(layout.ravel(stacked))
    w = torch.as_tensor(sch.problem.samples[:e * u], dtype=torch.float32,
                        device="cuda")
    gid = torch.arange(e, device="cuda").repeat_interleave(u)
    gd = clients.gd_local_steps(model.loss, sch.a, args.lr)
    stream = TokenStream(model.cfg.vocab_size, seed=0)
    out = []
    for r in range(args.rounds):
        batch = train.batch_for(model, stream, args.batch, args.seq, r)
        stacked_batch = {k: v[None].expand((e * u,) + tuple(v.shape))
                         for k, v in batch.items()}
        for _ in range(sch.b):
            gd(p, stacked_batch)
            p = stacked_weighted_average(p, w, group_ids=gid, num_groups=e)
        p = stacked_weighted_average(p, w)
        # copies: the next round's GD steps write p in place
        out.append([t[0].cpu().clone() for t in tree_leaves(p)])
    return out


def hfl_rank(fl) -> dict:
    """Part (d) on a rank of phase 14's ('edge', 'ue') mesh:
    ``launch.train``'s ``--mode hfl`` rounds (``hfl_rounds``), counted."""
    from repro_torch.launch import train
    args = hfl_args()
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    rounds = [dict(loss=loss, clock=clock,
                   final=[t.cpu() for t in tree_leaves(params)])
              for _, clock, loss, params in train.hfl_rounds(
                  args, hfl_schedule(args), fl, args.rounds)]
    torch.cuda.synchronize()
    return dict(rounds=rounds, wall=time.perf_counter() - t0,
                launches=tracing.launches())


def check_hfl(ranks, ref) -> None:
    """Part (d)'s checks, in phase 14's parent."""
    args = hfl_args()
    sch = hfl_schedule(args)
    base, spread = ref["hfl"]
    for r in ranks:
        h = r["hfl"]
        print(f"  (15d) rank {r['rank']}: --mode hfl at a*={sch.a} b*={sch.b}"
              f", {args.rounds} cloud rounds in {h['wall']:.3f} s; losses "
              f"{[round(x['loss'], 4) for x in h['rounds']]}; launches "
              f"{h['launches']}")
        check(h["launches"] == expect(), f"(15d) rank {r['rank']} launched "
                                         f"{h['launches']}")
        check(all(np.isfinite(x["loss"]) for x in h["rounds"]),
              "(15d) finite losses")
    diff = 0.0
    for i in range(args.rounds):
        first = ranks[0]["hfl"]["rounds"][i]["final"]
        for r in ranks[1:]:
            check(all(torch.equal(x, y) for x, y in
                      zip(first, r["hfl"]["rounds"][i]["final"])),
                  f"(15d) cloud event {i + 1}: rank {r['rank']}'s params "
                  f"differ from rank 0's")
        diff = max(diff, max(_max_err(x, y) for x, y in
                             zip(first, base[i])))
    hold_model("(15d) --mode hfl on 4 ranks vs the stacked loop on one "
               "card", diff, spread)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 16
# ---------------------------------------------------------------------------


def phase_moe_serving() -> dict:
    """Parts (a)-(e): full-width Qwen1.5-MoE-A2.7B through the serving CLI
    and step by step (profiled, kernel route against plain route with the
    routes pinned), a 3-layer cut against the CPU, then ``flash_attention``
    and ``decode_attention`` at its head layout against their plain
    versions and timed.  Returns the model run's launches and (e)'s
    errors and times."""
    torch.cuda.empty_cache()
    print(f"(a) {torch.cuda.memory_allocated()} B allocated at the start")
    t0 = time.perf_counter()
    phase_serve_cli(["--arch", MOE_ARCH, "--batch", str(SERVE_BATCH),
                     "--prompt-len", str(SERVE_PROMPT), "--gen",
                     str(SERVE_GEN), "--seed", "0"], SERVE_BATCH,
                    dict(flash_attention=MOE_LAYERS), MOE_LAYERS)
    print(f"(a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    served = phase_serving(MOE_ARCH, MOE_PARAMS,
                           dict(flash_attention=MOE_LAYERS), MOE_LAYERS)
    check(served["peak"] < MOE_MEMORY_LIMIT,
          f"peak memory {served['peak']} B >= {MOE_MEMORY_LIMIT:g}")
    print(f"(b, c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    phase_serving_card_vs_cpu(MOE_ARCH, MOE_CPU_LAYERS, GLM_CPU_PROMPT,
                              dict(flash_attention=MOE_CPU_LAYERS),
                              MOE_CPU_LAYERS)
    print(f"(d) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    errs = dict(flash_attention=check_attention_against_plain(
                    [ATTN_MOE])["fp32"],
                decode_attention=check_decode_against_plain(
                    [(DECODE_MOE, False)])["fp32"])
    timing = dict(flash_attention=time_attention(ATTN_MOE),
                  decode_attention=time_decode(DECODE_MOE))
    print(f"(e) {time.perf_counter() - t0:.1f} s")
    return dict(launches=served["launches"], errs=errs, timing=timing)


def phase_moe_smoke() -> dict:
    """Part (f): Mixtral-8x7B at smoke width (a 64-token window, no shared
    experts) served past its window, kernel route against plain route with
    the routes pinned; then ``launch.train`` on Qwen1.5-MoE's smoke config
    on the card: finite losses, and the MoE aux loss of the trained params
    positive and finite."""
    from repro_torch.launch import train
    t0 = time.perf_counter()
    served = phase_serving(MIXTRAL_ARCH, MIXTRAL_SMOKE_PARAMS,
                           dict(flash_attention=2), 2, smoke=True,
                           prompt=MIXTRAL_PROMPT, gen=MIXTRAL_GEN)
    tracing.reset()
    res = train.main(MOE_TRAIN_ARGV)
    torch.cuda.synchronize()
    launches = tracing.launches()
    losses = res["losses"]
    model = Model(get_config(MOE_ARCH, smoke=True), impl="xla_flash")
    args = train.parse_args(MOE_TRAIN_ARGV)
    with torch.no_grad():
        _, mets = model.loss(res["params"], train.batch_for(
            model, TokenStream(model.cfg.vocab_size, seed=0), args.batch,
            args.seq, 0))
    aux = float(mets["aux"])
    print(f"train CLI {MOE_TRAIN_ARGV}: losses "
          f"{[round(x, 4) for x in losses]}; the trained params' ce "
          f"{float(mets['ce']):.4f}, aux {aux:.6f}; launches {launches}")
    check(len(losses) == args.steps and bool(np.isfinite(losses).all()),
          "finite MoE training losses")
    check(np.isfinite(aux) and aux > 0, f"MoE aux loss {aux}")
    check(launches == expect(), f"MoE training launched kernels: {launches}")
    print(f"(f) {time.perf_counter() - t0:.1f} s")
    return served["launches"]


def phase_xlstm() -> None:
    """Part (g): full-width xLSTM-125M (mLSTM and sLSTM, no kernel) through
    the serving CLI with every kernel count 0; the whole model on the card
    against the CPU; then ``impl="chunked"`` (the chunkwise-parallel
    mLSTM) against the scan on the card's prefill and decode, each within
    SENSITIVITY_FACTOR times the scan's spread under a 1e-7 embedding
    move."""
    t0 = time.perf_counter()
    phase_serve_cli(["--arch", XLSTM_ARCH, "--batch", str(SERVE_BATCH),
                     "--prompt-len", str(XLSTM_PROMPT), "--gen",
                     str(SERVE_GEN), "--seed", "0"], SERVE_BATCH, {}, 0)
    cfg = get_config(XLSTM_ARCH)
    check(Model(cfg).num_params() == XLSTM_PARAMS,
          f"{XLSTM_ARCH}: parameters != {XLSTM_PARAMS}")
    phase_serving_card_vs_cpu(XLSTM_ARCH, cfg.num_layers, GLM_CPU_PROMPT,
                              {}, 0)
    scan, chunked = Model(cfg), Model(cfg, impl="chunked")
    params = scan.init(0)
    tokens = TokenStream(cfg.vocab_size, seed=0).batch(
        SERVE_BATCH, XLSTM_CHUNKED_PROMPT + CPU_STEPS)["tokens"]
    batch, follow = {"tokens": tokens[:, :XLSTM_CHUNKED_PROMPT]}, \
        tokens[:, XLSTM_CHUNKED_PROMPT:]
    runs = {}
    tracing.reset()
    for label, model, p in (("scan", scan, params),
                            ("chunked", chunked, params),
                            ("scan, moved", scan, perturbed(params))):
        t1 = time.perf_counter()
        logits, state = model.prefill(p, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t1
        runs[label] = (logits, teacher_forced(model, p, state, follow))
        print(f"  xLSTM {label} prefill B={SERVE_BATCH} "
              f"S={XLSTM_CHUNKED_PROMPT}: {t_prefill:.3f} s")
    check(tracing.launches() == expect(), f"xLSTM launched kernels: {tracing.launches()}")
    (s_lg, s_dec), (c_lg, c_dec), (m_lg, m_dec) = runs.values()
    hold_to_spread("chunked vs scan", "prefill logits", c_lg, s_lg, s_lg,
                   m_lg)
    hold_to_spread("chunked vs scan", f"{CPU_STEPS} teacher-forced decode "
                   "logits from the chunked prefill's state", c_dec, s_dec,
                   s_dec, m_dec)
    print(f"(g) {time.perf_counter() - t0:.1f} s")


def moved_frames(batch: dict, seed: int = 1) -> dict:
    """``batch`` with its frames moved by SENSITIVITY_NOISE relative: with
    ``perturbed``'s embedding move, a 1e-7 move of both inputs of an
    encoder-decoder."""
    x = batch["frames"]
    gen = torch.Generator(device=x.device).manual_seed(seed)
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    return dict(batch, frames=noise.mul_(SENSITIVITY_NOISE).add_(1.0).mul_(x))


def served(model, params, batch, follow) -> tuple:
    """Prefill logits and the teacher-forced decode logits of ``follow``."""
    logits, state = model.prefill(params, batch)
    return logits, teacher_forced(model, params, state, follow)


def card_batch(cfg, batch: int, prompt: int) -> dict:
    """The serving CLI's batch (``serve.serve_batch``, seed 0) on the card."""
    return {k: torch.as_tensor(v, device="cuda")
            for k, v in serve.serve_batch(cfg, batch, prompt, 0).items()}


def hold_to_bf16(label: str, what: str, tested, reference, plain,
                 wide) -> None:
    """``tested`` within BF16_FACTOR times the bf16 yardstick of
    ``reference``: the distance of ``plain`` (a bf16 plain-route run) from
    ``wide``, the same route with fp32 activations on the same bf16
    weights."""
    diff, yard = max_diff(tested, reference), max_diff(plain, wide)
    scale = max(float(t.float().abs().max()) for t in (
        reference if isinstance(reference, list) else [reference]))
    print(f"  {label}, {what} (bf16): max|diff| {diff:.3e}; bf16 yardstick "
          f"(plain route, bf16 vs fp32 activations) {yard:.3e} (ratio "
          f"{diff / max(yard, 1e-30):.2f}, allowed {BF16_FACTOR:g}); "
          f"largest |logit| {scale:.3e}")
    check(yard > 0, f"{label}, {what}: bf16 and fp32 activations agree "
          "exactly")
    check(diff <= BF16_FACTOR * yard, f"{label}, {what}: {diff:.3e} > "
          f"{BF16_FACTOR} x bf16 yardstick {yard:.3e}")


def phase_whisper() -> dict:
    """Parts (a) and (b): the serving CLI at full-width Whisper-base (8 x
    1,500 frames, 32 tokens: 6 ``flash_attention`` launches in the
    encoder, 6 ``decode_attention`` a decoded token, the prefill's first
    among them), then a 2 + 2-layer cut at B=1, 1,500 frames: kernel route
    against plain route and card against CPU, prefill and TEACHER_STEPS
    teacher-forced decode steps, held to SENSITIVITY_FACTOR times the
    plain route's spread under a 1e-7 move of the embedding and the
    frames.  Returns the counted launches and the CLI's times."""
    check(Model(get_config(WHISPER_ARCH)).num_params() == WHISPER_PARAMS,
          f"{WHISPER_ARCH}: parameters != {WHISPER_PARAMS}")
    argv = ["--arch", WHISPER_ARCH, "--batch", str(WHISPER_BATCH),
            "--prompt-len", str(WHISPER_FRAMES), "--gen", str(WHISPER_GEN)]
    torch.cuda.reset_peak_memory_stats()
    tracing.reset()
    res = serve.main(argv)
    torch.cuda.synchronize()
    cli = tracing.launches()
    peak = torch.cuda.max_memory_allocated()
    want = expect(flash_attention=WHISPER_LAYERS,
                  decode_attention=WHISPER_LAYERS * WHISPER_GEN)
    print(f"(a) serve CLI {argv}: prefill {res['prefill_s']:.4f} s, decode "
          f"{res['decode_s_per_token'] * 1e3:.3f} ms/token; launches {cli}; "
          f"peak memory {peak} B")
    check(cli == want, f"Whisper CLI launch counts {cli} != {want}")
    check(tuple(res["tokens"].shape) == (WHISPER_BATCH, WHISPER_GEN),
          "Whisper CLI: tokens")
    model = Model(get_config(WHISPER_ARCH))
    params = model.init(0)
    state = model.prefill(params, card_batch(
        model.cfg, WHISPER_BATCH, WHISPER_FRAMES))[1]
    wall, kernels = device_profile(lambda: model.decode_step(
        params, state, res["tokens"][:, :1]))
    print_serving_profile(kernels, wall, "Whisper-base decode step")
    del model, params, state

    cfg = dataclasses.replace(get_config(WHISPER_ARCH), num_layers=WHISPER_CUT,
                              num_encoder_layers=WHISPER_CUT)
    card = Model(cfg)
    params = card.init(0)
    batch = card_batch(cfg, CPU_BATCH, WHISPER_FRAMES)
    follow = torch.as_tensor(TokenStream(cfg.vocab_size, seed=1).batch(
        CPU_BATCH, TEACHER_STEPS)["tokens"], device="cuda")
    tracing.reset()
    logits, decode = served(card, params, batch, follow)
    torch.cuda.synchronize()
    cut = tracing.launches()
    want = expect(flash_attention=WHISPER_CUT,
                  decode_attention=WHISPER_CUT * (1 + TEACHER_STEPS))
    check(cut == want, f"Whisper cut launch counts {cut} != {want}")
    naive = Model(cfg, impl="naive")
    plain = served(naive, params, batch, follow)
    moved = served(naive, perturbed(params), moved_frames(batch), follow)
    what = f"{TEACHER_STEPS} teacher-forced decode steps' logits"
    print(f"(b) {WHISPER_CUT} + {WHISPER_CUT} layers, B={CPU_BATCH}, "
          f"{WHISPER_FRAMES} frames; launches {cut}")
    hold_to_spread("kernel vs plain route", "prefill logits", logits,
                   plain[0], plain[0], moved[0])
    hold_to_spread("kernel vs plain route", what, decode, plain[1], plain[1],
                   moved[1])
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = Model(cfg, device="cpu")
    c_logits, c_decode = served(cpu, to_cpu(params), to_cpu(batch),
                                follow.cpu())
    hold_to_spread("card vs CPU", "prefill logits", logits.cpu(), c_logits,
                   plain[0], moved[0])
    hold_to_spread("card vs CPU", what, [t.cpu() for t in decode], c_decode,
                   plain[1], moved[1])
    return dict(launches={k: cli[k] + cut[k] for k in cli},
                prefill_s=res["prefill_s"],
                decode_s=res["decode_s_per_token"], peak=peak)


def phase_vlm() -> dict:
    """Part (c): full-width InternVL2-26B in bf16 (``Model(param_dtype=,
    act_dtype=torch.bfloat16)``) through ``serve.generate``: B=2, 256
    patches and 3,840 tokens, 32 greedy tokens, peak memory under 80 GB;
    then a counted prefill (48 ``flash_attention_bf16`` launches) and
    TEACHER_STEPS teacher-forced decode steps (48 ``decode_attention_bf16``
    each), a profiled decode step, and the kernel route against the plain
    route held to the bf16 yardstick (``hold_to_bf16``).  Returns the
    counted launches, times and peak."""
    bf = torch.bfloat16
    cfg = get_config(VLM_ARCH)
    model = Model(cfg, param_dtype=bf, act_dtype=bf)
    check(model.num_params() == VLM_PARAMS,
          f"{VLM_ARCH}: parameters != {VLM_PARAMS}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    print(f"(c) {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size},"
          f" {cfg.num_prefix_embeds} patches; {model.num_params()} bf16 "
          f"parameters from seed 0 on the card in "
          f"{time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated()} B allocated")
    batch = card_batch(cfg, SERVE_BATCH, VLM_PROMPT)
    torch.cuda.reset_peak_memory_stats()
    tracing.reset()
    res = serve.generate(model, params, batch, SERVE_GEN)
    gen = tracing.launches()
    peak = torch.cuda.max_memory_allocated()
    tokens = res["tokens"]
    want = expect(flash_attention_bf16=VLM_LAYERS,
                  decode_attention_bf16=VLM_LAYERS * (SERVE_GEN - 1))
    print(f"generate B={SERVE_BATCH}, {cfg.num_prefix_embeds} patches + "
          f"{VLM_PROMPT - cfg.num_prefix_embeds} tokens, {SERVE_GEN} greedy "
          f"tokens: prefill {res['prefill_s']:.3f} s, decode "
          f"{res['decode_s_per_token'] * 1e3:.3f} ms/token; launches {gen}; "
          f"peak memory {peak} B; tokens[0, :16] {tokens[0, :16].tolist()}")
    check(gen == want, f"InternVL2 generate launch counts {gen} != {want}")
    check(peak < VLM_MEMORY_LIMIT, f"peak memory {peak} B >= "
          f"{VLM_MEMORY_LIMIT:g}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "tokens in range")
    follow = tokens[:, :TEACHER_STEPS]
    tracing.reset()
    logits, state = model.prefill(params, batch)
    torch.cuda.synchronize()
    pre = tracing.launches()
    check(pre == expect(flash_attention_bf16=VLM_LAYERS),
          f"InternVL2 prefill launch counts {pre}")
    tracing.reset()
    decode = teacher_forced(model, params, state, follow)
    torch.cuda.synchronize()
    dec = tracing.launches()
    check(dec == expect(decode_attention_bf16=VLM_LAYERS * TEACHER_STEPS),
          f"InternVL2 decode launch counts {dec}")
    check(logits.dtype == bf and all(t.dtype == bf for t in decode)
          and state["scanned"]["k"].dtype == bf, "bf16 logits and cache")
    check(bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(t).all()) for t in decode), "finite logits")
    wall, kernels = device_profile(lambda: model.decode_step(
        params, state, follow[:, :1]))
    print_serving_profile(kernels, wall, "InternVL2-26B bf16 decode step")
    del state
    plain = served(Model(cfg, impl="naive", param_dtype=bf, act_dtype=bf),
                   params, batch, follow)
    wide = served(Model(cfg, impl="naive", param_dtype=bf,
                        act_dtype=torch.float32), params, batch, follow)
    print(f"  plain routes: peak memory {torch.cuda.max_memory_allocated()} B")
    hold_to_bf16("kernel vs plain route", "prefill logits", logits, plain[0],
                 plain[0], wide[0])
    hold_to_bf16("kernel vs plain route", f"{TEACHER_STEPS} teacher-forced "
                 "decode steps' logits", decode, plain[1], plain[1], wide[1])
    return dict(launches={k: gen[k] + pre[k] + dec[k] for k in gen},
                prefill_s=res["prefill_s"],
                decode_s=res["decode_s_per_token"], peak=peak)


def phase_vlm_card_vs_cpu() -> dict:
    """Part (d): 2 layers of InternVL2-26B at full width in bf16, B=1, 256
    patches and 64 tokens, CPU_STEPS teacher-forced decode steps: the
    card's kernel route against the CPU's, held to the bf16 yardstick
    measured on the card."""
    bf = torch.bfloat16
    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_CPU_LAYERS)
    card = Model(cfg, param_dtype=bf, act_dtype=bf)
    params = card.init(0)
    batch = card_batch(cfg, CPU_BATCH, cfg.num_prefix_embeds + VLM_CPU_TOKENS)
    follow = torch.as_tensor(TokenStream(cfg.vocab_size, seed=1).batch(
        CPU_BATCH, CPU_STEPS)["tokens"], device="cuda")
    tracing.reset()
    logits, decode = served(card, params, batch, follow)
    torch.cuda.synchronize()
    cut = tracing.launches()
    want = expect(flash_attention_bf16=VLM_CPU_LAYERS,
                  decode_attention_bf16=VLM_CPU_LAYERS * CPU_STEPS)
    check(cut == want, f"InternVL2 cut launch counts {cut} != {want}")
    plain = served(Model(cfg, impl="naive", param_dtype=bf, act_dtype=bf),
                   params, batch, follow)
    wide = served(Model(cfg, impl="naive", param_dtype=bf,
                        act_dtype=torch.float32), params, batch, follow)
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = Model(cfg, param_dtype=bf, act_dtype=bf, device="cpu")
    t0 = time.perf_counter()
    c_logits, c_decode = served(cpu, to_cpu(params), to_cpu(batch),
                                follow.cpu())
    print(f"(d) {VLM_CPU_LAYERS} layers, B={CPU_BATCH}, "
          f"{cfg.num_prefix_embeds} patches + {VLM_CPU_TOKENS} tokens + "
          f"{CPU_STEPS} decode steps: CPU {time.perf_counter() - t0:.1f} s; "
          f"launches {cut}")
    hold_to_bf16("card vs CPU", "prefill logits", logits.cpu(), c_logits,
                 plain[0].cpu(), wide[0].cpu())
    hold_to_bf16("card vs CPU", "teacher-forced decode logits",
                 [t.cpu() for t in decode], c_decode,
                 [t.cpu() for t in plain[1]], [t.cpu() for t in wide[1]])
    return cut


def phase_whisper_train() -> None:
    """Part (e): ``launch.train --arch whisper-base --steps 10`` at full
    width on the card (B=8, 128 frames and 16 tokens a row, AdamW, the
    ``xla_flash`` route): finite, falling losses, no kernel launch."""
    from repro_torch.launch import train
    tracing.reset()
    t0 = time.perf_counter()
    res = train.main(WHISPER_TRAIN_ARGV)
    torch.cuda.synchronize()
    losses = res["losses"]
    print(f"(e) train CLI {WHISPER_TRAIN_ARGV}: losses "
          f"{[round(x, 4) for x in losses]} in "
          f"{time.perf_counter() - t0:.1f} s; launches {tracing.launches()}")
    check(len(losses) == 10 and bool(np.isfinite(losses).all()),
          "finite Whisper training losses")
    check(losses[-1] < losses[0], f"Whisper losses not falling: {losses}")
    check(tracing.launches() == expect(), f"Whisper training launched {tracing.launches()}")


def phase_frontends() -> dict:
    """Phase 17: parts (a)-(e), then ``flash_attention`` and
    ``decode_attention`` at Whisper's shapes (fp32) and InternVL2's (bf16,
    their own lines and tolerances) against their plain versions, timed.
    Returns the model runs' launches, the fp32 errors and each part's
    numbers."""
    out = {}
    t0 = time.perf_counter()
    out["whisper"] = phase_whisper()
    print(f"(a, b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out["vlm"] = phase_vlm()
    print(f"(c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cut = phase_vlm_card_vs_cpu()
    print(f"(d) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_whisper_train()
    print(f"(e) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out["errs"] = dict(
        flash_attention=check_attention_against_plain([ATTN_WHISPER])["fp32"],
        decode_attention=check_decode_against_plain([(DECODE_WHISPER,
                                                      False)])["fp32"],
        flash_attention_bf16=check_attention_against_plain(
            [ATTN_VLM + ("bf16",)])["bf16"],
        decode_attention_bf16=check_decode_against_plain(
            [(DECODE_VLM, True)])["bf16"])
    out["timing"] = dict(
        whisper_flash=time_attention(ATTN_WHISPER),
        whisper_decode=time_decode(DECODE_WHISPER),
        vlm_flash=time_attention(ATTN_VLM, torch.bfloat16),
        vlm_decode=time_decode(DECODE_VLM, torch.bfloat16))
    time_split_rule(DECODE_VLM, torch.bfloat16)
    print(f"kernels {time.perf_counter() - t0:.1f} s")
    out["launches"] = {k: out["whisper"]["launches"][k]
                       + out["vlm"]["launches"][k] + cut[k] for k in cut}
    return out


# ---------------------------------------------------------------------------
# Phase 19: the sharded transformer on 4 ranks, and the dry run
# ---------------------------------------------------------------------------

MESH_TRAIN_SHAPE = (2, 2)          # ('data', 'model'): FSDP x TP
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 8, 128
MESH_TRAIN_LR = 0.1                # SGD (AdamW is sign-sensitive)
MESH_TRAIN_RTOL = 1e-5             # loss (relative), each leaf (of its
#                                    largest magnitude) after the step, and
#                                    each leaf's update (of the update's,
#                                    plus one fp32 rounding of the leaf)
MESH_SERVE_SHAPE = (1, 4)          # the local T is the global T
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_GEN = 2, 1024, 4
MESH_RING = 2 * MESH_SERVE_PROMPT  # the decode walk's ring, every slot full
MESH_TOKEN_PROMPT = 128            # the fp32-activation greedy run's prompt
MESH_TOKEN_GEN = 2                 # ... and its greedy steps (a step took
                                   # 1.3-1.6 s a rank beside phase 14)
# (b)'s prefill attention on one rank: Qwen1.5-MoE's 16 heads over 16, 4
# local heads over 4, bf16; and its decode attention over the 2,048-slot
# ring, the prompt's 1,024 positions and the first token's written
ATTN_MESH_LOCAL = (MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_PROMPT,
                   4, 4, 128, True, 0)
DECODE_MESH_LOCAL = (MESH_SERVE_BATCH, MESH_RING, 4, 4, 128,
                     MESH_SERVE_PROMPT, 0, "prefix")
MESH_SEED = 0                      # ``sharding.init_keyed``'s draws
MESH19_TIMEOUT_S = 900


def mesh_train_batch(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(MESH_SEED)
    t = torch.randint(0, get_config(CLI_ARCH).vocab_size,
                      (MESH_TRAIN_BATCH, MESH_TRAIN_SEQ + 1), generator=gen,
                      device=device).to(torch.int32)
    return {"tokens": t[:, :-1].contiguous(), "targets": t[:, 1:].contiguous()}


def mesh_serve_tokens(device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(MESH_SEED)
    return torch.randint(0, get_config(MOE_ARCH).vocab_size,
                         (MESH_SERVE_BATCH, MESH_SERVE_PROMPT), generator=gen,
                         device=device).to(torch.int32)


def mesh_serve_model(impl="kernel", act=torch.bfloat16, mesh=None,
                     rules=None) -> Model:
    return Model(get_config(MOE_ARCH), mesh=mesh, rules=rules, impl=impl,
                 param_dtype=torch.bfloat16, act_dtype=act)


def greedy(model, params, tokens, gen: int, follow=None,
           costs=None, laps=None) -> tuple:
    """Prefill logits, then ``gen`` decode steps' logits: of the greedy
    tokens, or teacher-forced with ``follow`` (B, gen).  Returns (logits
    list on the CPU in fp32, the tokens fed).  With a dict ``costs`` the
    prefill is walked (``costs["prefill"]``: the walk's dict); with a dict
    ``laps`` the seconds of the prefill (its logits on the host included)
    and of the steps are kept there."""
    from repro_torch.parallel import sharding as shd
    batch = {"tokens": tokens}
    t0 = time.perf_counter()
    if costs is None:
        logits, state = model.prefill(params, batch)
    else:
        (logits, state), costs["prefill"] = walk(model.prefill, params,
                                                 batch)
    out, fed = [shd.full(logits).float().cpu()], []
    if laps is not None:
        laps["prefill"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    for i in range(gen):
        nxt = (follow[:, i:i + 1] if follow is not None else
               torch.argmax(shd.full(logits), -1).to(torch.int32))
        fed.append(nxt.cpu())
        if model.mesh is not None:
            nxt = shd.distribute_tree(model.mesh, {"t": nxt},
                                      {"t": ("batch", None)},
                                      model.rules)["t"]
        logits, state = model.decode_step(params, state, nxt)
        out.append(shd.full(logits).float().cpu())
    if laps is not None:
        laps["steps"] = time.perf_counter() - t0
    return out, torch.cat(fed, 1)


def mesh_model_references() -> dict:
    """Part (b)'s single-device references, before the spawn: full-width
    Qwen1.5-MoE-A2.7B in bf16 (``init_keyed``'s draws), the kernel route's
    prefill and MESH_SERVE_GEN greedy steps with its routes recorded, and
    phase 17's bf16 yardstick: the plain route (``xla_flash``) with bf16
    and with fp32 activations on the same weights, teacher-forced with the
    greedy tokens, routes pinned; then the kernel route with fp32
    activations on the prompt's first MESH_TOKEN_PROMPT tokens, its
    MESH_TOKEN_GEN greedy tokens and routes recorded (the sharded runs'
    tokens must equal them).  Its weights are freed after."""
    from repro_torch.parallel import sharding as shd
    t0 = time.perf_counter()
    model = mesh_serve_model()
    params = shd.init_keyed(model, MESH_SEED)
    tokens = mesh_serve_tokens("cuda")
    pin = PinnedRoutes()
    with torch.no_grad(), pin.record():
        logits, fed = greedy(model, params, tokens, MESH_SERVE_GEN)
    calls = len(pin.routes)
    yard = {}
    for name, act in (("plain", torch.bfloat16), ("wide", torch.float32)):
        m = mesh_serve_model("xla_flash", act)
        with torch.no_grad(), pin.replay(f"phase 19 {name}", calls):
            yard[name] = greedy(m, params, tokens, MESH_SERVE_GEN,
                                follow=fed.to(tokens.device))[0]
    pin32 = PinnedRoutes()
    with torch.no_grad(), pin32.record():
        logits32, fed32 = greedy(mesh_serve_model(act=torch.float32), params,
                                 tokens[:, :MESH_TOKEN_PROMPT],
                                 MESH_TOKEN_GEN)
    del params
    torch.cuda.empty_cache()
    print(f"  phase 19 references (single device, full-width {MOE_ARCH} "
          f"bf16, B={MESH_SERVE_BATCH}, S={MESH_SERVE_PROMPT}, "
          f"{MESH_SERVE_GEN} greedy steps): greedy tokens "
          f"{fed.tolist()}; fp32 activations, S={MESH_TOKEN_PROMPT}: "
          f"{fed32.tolist()}; {time.perf_counter() - t0:.1f} s")
    return dict(logits=logits, tokens=fed, routes=[r.cpu() for r in
                                                   pin.routes],
                calls=calls, logits32=logits32, tokens32=fed32,
                routes32=[r.cpu() for r in pin32.routes],
                calls32=len(pin32.routes), **yard)


def full_ring_state(model, shape):
    """A decode state of ``shape``'s ring on ``model.mesh``, every slot
    holding a token (slot i token i, the next position MESH_RING), k and v
    random: the state whose every slot K7 counts, as the dry run's."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.parallel import sharding as shd
    sh, shapes = steps_lib.decode_shardings(model, shape)
    _, s_sh, t_sh = sh
    state = shd.empty_sharded(s_sh, shapes[1], "cuda")
    for name, t in state["scanned"].items():
        loc = t.to_local()
        if name in ("k", "v"):
            loc.normal_()
        elif name == "slot_pos":
            loc.copy_(torch.arange(loc.shape[-1], device="cuda"))
        else:
            loc.fill_(MESH_RING)
    tokens = shd.empty_sharded(t_sh, shapes[2], "cuda")
    tokens.to_local().zero_()
    return state, tokens


def mesh_train_reference(batch, mesh, shardings) -> tuple:
    """A rank's single-device SGD step of part (a), before the mesh step
    (``init_keyed``'s draws, cuDNN's deterministic algorithms): (the loss,
    this rank's shard of every updated leaf; the rest freed at once)."""
    from repro_torch.fl.flatten import tree_leaves as leaves
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import sgd
    from repro_torch.parallel import sharding as shd
    model = Model(get_config(CLI_ARCH), impl="xla_flash", remat=False)
    params = shd.init_keyed(model, MESH_SEED)
    step = steps_lib.make_train_step(model, sgd(MESH_TRAIN_LR))
    params, _, mets = step(params, (), batch)
    mine = [shd.local_shard(leaf, mesh, sh).clone()
            for leaf, sh in zip(leaves(params), leaves(shardings))]
    del params
    torch.cuda.synchronize()
    return float(mets["loss"]), mine


def mesh_model_rank(refs: dict) -> dict:
    """Phase 19's rank: (a) the sharded SGD step of full-width StableLM-1.6B
    on a 2 x 2 mesh, walked, every leaf's shard and its update held to
    the same shards of the single-device step (each rank runs that step
    first, two ranks at a time, keeping its shards of the result); (b) full-width
    Qwen1.5-MoE-A2.7B served on a 1 x 4 mesh under the default and the
    expert-parallel rules, routes pinned to the single-device run's, its
    prefill and a full-ring decode step walked, then with fp32
    activations MESH_TOKEN_GEN greedy steps on MESH_TOKEN_PROMPT tokens.
    Every collective is staged through host memory
    (``StagedCollectives``)."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.fl.flatten import tree_leaves as leaves
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.mesh import StagedCollectives, make_host_mesh
    from repro_torch.optim import sgd
    from repro_torch.parallel import sharding as shd
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    out = {"rank": rank}
    t_rank = time.perf_counter()
    times = {}
    with StagedCollectives(), torch.no_grad():
        # (a) training
        t0 = time.perf_counter()
        batch = mesh_train_batch("cuda")
        mesh = make_host_mesh(*MESH_TRAIN_SHAPE)
        model = Model(get_config(CLI_ARCH), mesh=mesh,
                      rules=shd.DEFAULT_RULES, impl="xla_flash", remat=False)
        shardings = shd.logical_to_sharding(mesh, model.axes(),
                                            model.param_shapes(),
                                            shd.DEFAULT_RULES)
        # two ranks at a time: a reference holds the whole model and its
        # gradients (~14 GB), and four at once beside phase 14 have run the
        # card out of memory
        for turn in range(0, dist.get_world_size(), 2):
            if turn <= rank < turn + 2:
                ref = mesh_train_reference(batch, mesh, shardings)
                torch.cuda.empty_cache()
            dist.barrier()
        times["a_reference"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = shd.init_keyed(model, MESH_SEED, mesh, shd.DEFAULT_RULES)
        times["a_init"] = time.perf_counter() - t0
        dbatch = shd.distribute_tree(mesh, batch, {"tokens": ("batch", "seq"),
                                                   "targets": ("batch",
                                                               "seq")},
                                     shd.DEFAULT_RULES)
        arg_bytes = local_bytes((params, dbatch))
        step = steps_lib.make_train_step(model, sgd(MESH_TRAIN_LR))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (params, _, mets), cost = walk(step, params, (), dbatch)
        out["train"] = dict(s=time.perf_counter() - t0, flops=cost["flops"],
                            coll=cost["collective_bytes"],
                            arg_bytes=arg_bytes,
                            loss=float(shd.full(mets["loss"])))
        # each leaf's shard against the same shard of the single-device
        # step, over the leaf's largest magnitude; each leaf's update
        # (after - init) against the single-device update, over its
        # allowance: MESH_TRAIN_RTOL of the update's largest magnitude
        # plus one fp32 rounding of the leaf's largest (two sums w + u
        # with u a rounding apart round one ulp apart: a norm scale near
        # 1 moves by ~1e-3, one ulp 1.2e-7 of it).  The step wrote into
        # its parameters: the init is drawn again (the same keyed draws),
        # so no rank keeps a copy through the step.  Maxima over the ranks
        after = [leaf.to_local() for leaf in leaves(params)]
        init = [leaf.to_local() for leaf in leaves(
            shd.init_keyed(model, MESH_SEED, mesh, shd.DEFAULT_RULES))]
        errs = torch.stack([(a - r).abs().max()
                            for a, r in zip(after, ref[1])])
        scales = torch.stack([r.abs().max() for r in ref[1]])
        u_errs = torch.stack([((a - i) - (r - i)).abs().max()
                              for a, i, r in zip(after, init, ref[1])])
        u_scales = torch.stack([(r - i).abs().max()
                                for i, r in zip(init, ref[1])])
        for t in (errs, scales, u_errs, u_scales):
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
        eps = torch.finfo(torch.float32).eps
        out["train"].update(
            ref_loss=ref[0],
            worst=float((errs / scales.clamp_min(1e-30)).max()),
            update_rel=float((u_errs / u_scales.clamp_min(1e-30)).max()),
            worst_update=float((u_errs / (MESH_TRAIN_RTOL * u_scales
                                          + eps * scales)).max()),
            least_update=float((u_scales / scales.clamp_min(1e-30)).min()))
        times["a_step"] = out["train"]["s"]
        del params, ref, dbatch, init, after
        torch.cuda.empty_cache()
        # (b) serving
        mesh = make_host_mesh(*MESH_SERVE_SHAPE)
        tokens = mesh_serve_tokens("cuda")
        pin = PinnedRoutes()
        pin.routes = refs["routes"]
        for rules_name in ("default", "expert_parallel"):
            t0 = time.perf_counter()
            rules = shd.RULE_SETS[rules_name]
            model = mesh_serve_model(mesh=mesh, rules=rules)
            params = shd.init_keyed(model, MESH_SEED, mesh, rules)
            dtok = shd.distribute_tree(mesh, {"t": tokens},
                                       {"t": ("batch", "seq")}, rules)["t"]
            times[f"b_{rules_name}_init"] = time.perf_counter() - t0
            tracing.reset()
            torch.cuda.synchronize()
            # the default rules' prefill walked: the pinning's own ops are
            # hidden from the walk, so it counts the prefill's
            walked = {} if rules_name == "default" else None
            with pin.replay(f"rank {rank} {rules_name}", refs["calls"]):
                logits, _ = greedy(model, params, dtok, MESH_SERVE_GEN,
                                   follow=refs["tokens"].to("cuda"),
                                   costs=walked)
            torch.cuda.synchronize()
            res = dict(s=time.perf_counter() - t0, logits=logits,
                       launches=tracing.launches())
            if rules_name == "default":
                res["prefill_args"] = local_bytes((params, {"tokens": dtok}))
                cost = walked["prefill"]
                res["prefill"] = (cost["flops"], cost["collective_bytes"])
                shape = ShapeConfig("decode", MESH_RING, MESH_SERVE_BATCH,
                                    "decode")
                state, ntok = full_ring_state(model, shape)
                res["decode_args"] = local_bytes((params, state, ntok))
                _, cost = walk(steps_lib.make_serve_step(model), params,
                               state, ntok)
                res["decode"] = (cost["flops"], cost["collective_bytes"])
                del state
            # fp32 activations, greedy: the tokens must equal one device's;
            # its parts timed (the model and tokens, the prefill, the steps,
            # what is left: the route replay's set-up and the checks)
            t1 = time.perf_counter()
            pin32 = PinnedRoutes()
            pin32.routes = refs["routes32"]
            dtok32 = shd.distribute_tree(
                mesh, {"t": tokens[:, :MESH_TOKEN_PROMPT]},
                {"t": ("batch", "seq")}, rules)["t"]
            model32 = mesh_serve_model(act=torch.float32, mesh=mesh,
                                       rules=rules)
            laps = {"build": time.perf_counter() - t1}
            tracing.reset()
            with pin32.replay(f"rank {rank} {rules_name} fp32",
                              refs["calls32"]):
                res["logits32"], res["tokens32"] = greedy(
                    model32, params, dtok32, MESH_TOKEN_GEN, laps=laps)
            torch.cuda.synchronize()
            res["launches32"] = tracing.launches()
            res["s32"] = time.perf_counter() - t1
            laps["rest"] = res["s32"] - sum(laps.values())
            for part, sec in laps.items():
                times[f"b_{rules_name}_fp32_{part}"] = sec
            out[rules_name] = res
            times[f"b_{rules_name}"] = time.perf_counter() - t0
            del params, model
            torch.cuda.empty_cache()
        out["peak"] = torch.cuda.max_memory_allocated()
    out["s"] = time.perf_counter() - t_rank
    out["times"] = {k: round(v, 2) for k, v in times.items()}
    return out


def equal_tokens(logits, ref_tokens) -> int:
    """How many of the teacher-forced steps' greedy tokens (the prompt's
    last position, then each step) equal the reference's."""
    return sum(int((torch.argmax(lg[:, -1], -1) == ref_tokens[:, i]).sum())
               for i, lg in enumerate(logits[:MESH_SERVE_GEN]))


def mesh_dryrun() -> int:
    """``--mesh-dryrun``: part (c)'s dry runs, in a process of their own
    beside phase 19's ranks: (a)'s train step on a fake 2 x 2 group, (b)'s
    prefill and full-ring decode step on a fake 1 x 4 group, each on the
    card's device type (fake tensors: nothing runs), then the production
    pair stablelm-1.6b x train_4k on 16 x 16.  Prints one JSON line."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import sgd
    out = {}
    t0 = time.perf_counter()
    with dryrun.fake_group(4):
        mesh = make_host_mesh(*MESH_TRAIN_SHAPE)
        out["train"] = dryrun.dryrun_step(
            get_config(CLI_ARCH), ShapeConfig("train", MESH_TRAIN_SEQ,
                                              MESH_TRAIN_BATCH, "train"),
            mesh, param_dtype=torch.float32, act_dtype=torch.float32,
            remat=False, optimizer=sgd(MESH_TRAIN_LR))
    with dryrun.fake_group(4):
        mesh = make_host_mesh(*MESH_SERVE_SHAPE)
        for kind, seq in (("prefill", MESH_SERVE_PROMPT),
                          ("decode", MESH_RING)):
            out[kind] = dryrun.dryrun_step(
                get_config(MOE_ARCH), ShapeConfig(kind, seq,
                                                  MESH_SERVE_BATCH, kind),
                mesh, impl="kernel")
    out["cut_s"] = time.perf_counter() - t0
    out["production"] = dryrun.dryrun_pair(CLI_ARCH, "train_4k")
    out["s"] = time.perf_counter() - t0
    print(json.dumps(out, default=str))
    return 0


class MeshModelPhase:
    """Phase 19: the transformer sharded over ranks (DTensors, gloo, one
    card).  (a) full-width StableLM-1.6B's SGD step on a 2 x 2 mesh (FSDP
    over 'data', TP over 'model'), fp32, B=8, S=128, held to the
    single-device step on the same draws: the loss within 1e-5 relative,
    every leaf within 1e-5 of its largest magnitude, every leaf's update
    within 1e-5 of the update's plus one fp32 rounding of the leaf.  (b)
    full-width Qwen1.5-MoE-A2.7B in bf16 through the kernel route on a 1 x
    4 mesh, B=2, S=1,024, MESH_SERVE_GEN steps teacher-forced with the
    single-device run's greedy tokens, under the default and the
    expert-parallel rules: logits within phase 17's bf16 rule (routes
    pinned), K5 and K7 launched on every rank; then with fp32
    activations, MESH_TOKEN_GEN greedy steps on MESH_TOKEN_PROMPT tokens
    (routes pinned): every token equal to the single-device run's, K5 and
    K7 launched on every rank.  (c) the dry run of (a) and (b) on fake
    groups of the same meshes: per-rank FLOPs, collective bytes and
    argument bytes equal rank 0's walk of the real step; then the
    production pair stablelm-1.6b x train_4k on 16 x 16 and its roofline
    terms.

    ``start`` runs the references and the ranks on a thread of their own,
    and ``start_dryrun`` the dry run in a subprocess, both beside phase 14
    (LeNet: the card's memory holds both phases); ``finish`` waits for
    them and checks."""

    def __init__(self):
        self.state, self.thread, self.dry = {}, None, None

    def start_dryrun(self) -> None:
        self.t0 = time.perf_counter()
        self.dry = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-dryrun"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def start(self) -> None:
        def run():
            try:
                self.state["refs"] = mesh_model_references()
                t0 = time.perf_counter()
                self.state["ranks"] = run_ranks(mesh_model_rank, 4,
                                                self.state["refs"],
                                                timeout_s=MESH19_TIMEOUT_S)
                self.state["spawn"] = time.perf_counter() - t0
            except BaseException as e:       # re-raised by finish
                self.state["error"] = e
        self.t_ranks = time.perf_counter()
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def finish(self) -> dict:
        try:
            if self.thread is None:
                self.start()
            self.thread.join(timeout=MESH19_TIMEOUT_S + 60)
            check(not self.thread.is_alive(), "phase 19's ranks did not end")
            if "error" in self.state:
                raise self.state["error"]
            out, err = self.dry.communicate(timeout=MESH19_TIMEOUT_S)
        finally:
            if self.dry.poll() is None:
                self.dry.kill()
                self.dry.wait()
        print(f"  phase 19 (started {self.t_ranks - self.t0:.1f} s after "
              f"its dry run): references and ranks "
              f"{time.perf_counter() - self.t_ranks:.1f} s")
        return check_mesh_model(self.state["refs"], self.state["ranks"],
                                self.state["spawn"], self.dry.returncode,
                                out, err)


def check_mesh_model(refs, ranks, spawn_s, rc, out, err) -> dict:
    """Phase 19's checks (see ``MeshModelPhase``); returns the kernels'
    launches over the ranks."""
    print(f"  phase 19 ranks: {spawn_s:.1f} s of spawn; each rank "
          f"{[round(r['s'], 1) for r in ranks]} s; peak card memory a rank "
          f"{[r['peak'] for r in ranks]} B")
    check(rc == 0, f"--mesh-dryrun failed: {err[-3000:]}")
    dr = json.loads(out.strip().splitlines()[-1])
    r0 = ranks[0]
    a = r0["train"]
    print(f"  (a) {CLI_ARCH} SGD step on {MESH_TRAIN_SHAPE}: {a['s']:.2f} s "
          f"(walked); loss {a['loss']!r} against {a['ref_loss']!r} on one "
          f"device; worst leaf {a['worst']:.3e} of its largest magnitude; "
          f"worst update {a['update_rel']:.3e} of the update's largest "
          f"magnitude, {a['worst_update']:.3f} of its allowance "
          f"({MESH_TRAIN_RTOL:g} of that plus one fp32 rounding of the "
          f"leaf); the smallest update {a['least_update']:.3e} of its "
          f"leaf's largest magnitude")
    check(abs(a["loss"] - a["ref_loss"]) <= MESH_TRAIN_RTOL * abs(
        a["ref_loss"]), "(a): the sharded loss differs from one device's")
    check(a["worst"] <= MESH_TRAIN_RTOL, f"(a): a leaf after the sharded "
          f"step is {a['worst']:.3e} off the single-device step's")
    check(a["worst_update"] <= 1.0, f"(a): a leaf's update in the sharded "
          f"step is {a['worst_update']:.3f} of its allowance off the "
          "single-device step's")
    print(f"  phase 19 rank times (s): {[r['times'] for r in ranks]}")
    launched = {"flash_attention_bf16": 0, "decode_attention_bf16": 0}
    for rules_name in ("default", "expert_parallel"):
        for r in ranks:
            res = r[rules_name]
            label = f"(b) {rules_name}, rank {r['rank']}"
            want = expect(flash_attention_bf16=MOE_LAYERS,
                          decode_attention_bf16=MOE_LAYERS * MESH_SERVE_GEN)
            check(res["launches"] == want, f"{label}: launches "
                  f"{res['launches']} != {want}")
            check(torch.equal(res["tokens32"], refs["tokens32"]),
                  f"{label}, fp32 activations: greedy tokens "
                  f"{res['tokens32'].tolist()} != the single-device run's "
                  f"{refs['tokens32'].tolist()}")
            want32 = expect(flash_attention=MOE_LAYERS,
                            decode_attention=MOE_LAYERS * MESH_TOKEN_GEN)
            check(res["launches32"] == want32, f"{label}, fp32 activations: "
                  f"launches {res['launches32']} != {want32}")
            for name in launched:
                launched[name] += res["launches"][name]
        res = ranks[0][rules_name]
        same = [equal_tokens(r[rules_name]["logits"], refs["tokens"])
                for r in ranks]
        scale32 = max(float(t.abs().max()) for t in refs["logits32"])
        print(f"  (b) {MOE_ARCH} on {MESH_SERVE_SHAPE} under {rules_name}: "
              f"prefill and {MESH_SERVE_GEN} steps {res['s']:.2f} s; "
              f"launches a rank {res['launches']}; bf16 greedy tokens equal "
              f"to one device's (teacher-forced, not held) {same} of "
              f"{refs['tokens'].numel()} a rank; fp32 activations "
              f"(S={MESH_TOKEN_PROMPT}, {res['s32']:.2f} s): all "
              f"{refs['tokens32'].numel()} greedy tokens equal on every "
              f"rank, logits max|diff| "
              f"{max_diff(res['logits32'], refs['logits32']):.3e} (largest "
              f"|logit| {scale32:.3e})")
        hold_to_bf16(f"(b) {rules_name}", "prefill and decode logits",
                     res["logits"], refs["logits"], refs["plain"],
                     refs["wide"])
    for kind, real, args in (("train", (a["flops"], a["coll"]),
                              a["arg_bytes"]),
                             ("prefill", r0["default"]["prefill"],
                              r0["default"]["prefill_args"]),
                             ("decode", r0["default"]["decode"],
                              r0["default"]["decode_args"])):
        rec = dr[kind]
        got = (rec["cost"]["flops"], rec["collectives"]["total"])
        print(f"  (c) {kind}: dry run FLOPs {got[0]!r}, collective bytes "
              f"{got[1]!r}, argument bytes {rec['memory']['argument_bytes']}"
              f"; rank 0's walk on the card {tuple(real)!r}, {args}")
        check(tuple(got) == tuple(real), f"(c) {kind}: the dry run's "
              f"per-rank counts {got} != the card's walk {tuple(real)}")
        check(rec["memory"]["argument_bytes"] == args, f"(c) {kind}: "
              f"argument bytes {rec['memory']['argument_bytes']} != {args}")
    prod = dr["production"]
    check(prod["status"] == "ok", f"the production pair: {prod}")
    print(f"  (c) production pair {CLI_ARCH} x train_4k on 16 x 16 "
          f"({dr['s'] - dr['cut_s']:.1f} s; the cut pairs "
          f"{dr['cut_s']:.1f} s): memory {prod['memory']}; cost "
          f"{prod['cost']}; collectives {prod['collectives']['total']!r} B; "
          f"roofline {prod['roofline']}")
    return launched


def time_aggregation() -> int:
    """``--time-aggregation``: K1, K2, K3 and K4 timed at the paths'
    shapes and phase 6, nothing else.  Only the wrappers' signatures are
    used, so the same script times an older tree's kernels (copy it into
    that tree) in the same call, for a comparison on one card."""
    print("== aggregation kernels only")
    t0 = time.perf_counter()
    paths = build.build(["segment_aggregate", "cloud_aggregate",
                         "weighted_mean", "segment_sum"])
    print(f"built {', '.join(paths)} in {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line:
                print(f"  {name}: {line.strip()}")
    cases = kernel_cases("cuda")
    time_kernels(*cases["main_n100_f44426"])
    time_kernels(*cases["slab_n60_f44426"], names=("segment_aggregate",))
    s_cases = sum_cases("cuda")
    time_segment_sum(*s_cases["stream_n8192_f1024"])
    time_segment_sum(*s_cases["lenet_n100_f44426"])
    time_mean(*cases["slab_n60_f44426"][:2])
    del cases, s_cases
    x, w = fleet_shard(0)
    time_mean(x, w)
    time_mean(x.to(torch.bfloat16), w)
    del x, w
    phase_streaming()
    return 0


def time_rounds(repeats: int = 3) -> int:
    """``--time-rounds``: phase 3's warm sync round (``repeats`` times)
    and phase 5's async run per cloud update, on the constant clock,
    nothing else.  Only the simulator's first arguments (no delay model)
    are used, so the same script times an older tree's simulator (copy it
    into that tree) in the same call, for a comparison on one card."""
    print("== warm rounds of phases 3 and 5 only")
    build.build(["segment_aggregate", "cloud_aggregate"])
    sch, _, ue_data, test = main_path_inputs()
    sim = make_sim(sch, ue_data, "cuda")
    sim.run(test, rounds=1)
    warm = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(test, rounds=1)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    asim = make_sim(sch, ue_data, "cuda", mode="async",
                    max_staleness=ASYNC_STALENESS)
    asim.run(test, rounds=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = asim.run(test, rounds=ROUNDS)
    torch.cuda.synchronize()
    updates = len(res.timeline.updates)
    print(f"warm sync rounds: {', '.join(f'{t:.3f}' for t in warm)} s; "
          f"async, warm: {(time.perf_counter() - t0) / updates:.3f} s per "
          f"cloud update ({updates} updates)")
    return 0


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    print(card_line())
    if argv == ["--time-aggregation"]:
        return time_aggregation()
    if argv == ["--time-rounds"]:
        return time_rounds()
    if argv == ["--probe-profiler"]:
        return probe_profiler()
    if argv == ["--mesh-dryrun"]:
        return mesh_dryrun()
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    print("== phase 1: device")
    t0 = time.perf_counter()
    phase_device()
    print(f"phase 1: {time.perf_counter() - t0:.1f} s")

    print("== phase 2: kernels vs plain versions on the card")
    t0 = time.perf_counter()
    cases = kernel_cases("cuda")
    errs = check_kernels_against_plain(cases)
    timing = time_kernels(*cases["main_n100_f44426"])
    time_kernels(*cases["slab_n60_f44426"], names=("segment_aggregate",))
    time_aggregate_warps_rule(*cases["main_n100_f44426"])
    time_aggregate_warps_rule(*cases["slab_n60_f44426"])
    time_aggregate_warps_rule(*cases["main_n100_f44426"],
                              name="cloud_aggregate")
    s_cases = sum_cases("cuda")
    errs["segment_sum"] = check_segment_sum_against_plain(s_cases)
    check_one_launch(aggregation_calls(cases, s_cases))
    timing["segment_sum"] = time_segment_sum(*s_cases["stream_n8192_f1024"])
    time_slice_rule(*s_cases["stream_n8192_f1024"])
    time_segment_sum(*s_cases["lenet_n100_f44426"])
    time_segment_sum(*s_cases["service_n20_f44426_m1"])
    del cases, s_cases
    attn_errs = check_attention_against_plain()
    errs["flash_attention"] = attn_errs["fp32"]
    errs["flash_attention_bf16"] = attn_errs["bf16"]
    timing["flash_attention"] = time_attention(ATTN_SERVING)
    time_attention(ATTN_GLM)
    time_attention(ATTN_CLI)
    for case in (ATTN_SERVING, ATTN_GLM, ATTN_CLI):
        time_warps_rule(case)
    errs["rglru_scan"] = check_scan_against_plain()
    timing["rglru_scan"] = time_scan()
    decode_errs = check_decode_against_plain()
    errs["decode_attention"] = decode_errs["fp32"]
    errs["decode_attention_bf16"] = decode_errs["bf16"]
    time_decode(DECODE_SERVING)
    timing["decode_attention"] = time_decode(DECODE_GLM)
    time_decode(DECODE_CLI)
    for case in (DECODE_SERVING, DECODE_GLM):
        time_split_rule(case)
    m_cases = mean_cases()
    errs["weighted_mean"] = check_mean_against_plain(m_cases)
    check_one_launch({"weighted_mean": [
        lambda x=x, w=w: ha.weighted_mean(x, w)
        for x, w in m_cases.values()]})
    for case in ("slab_n60_f44426", "fleet_n16384_f44426", "bf16_fleet"):
        x, w = m_cases[case]
        r = time_mean(x, w, note=f"; {plan_line(x)}")
        timing.setdefault("weighted_mean", r)
    del x, w
    for case in ("slab_n60_f44426", "fleet_n16384_f44426", "bf16_fleet"):
        time_mean_slice_rule(*m_cases[case])
    del m_cases
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")

    print("== phase 3: main path at full width")
    t0 = time.perf_counter()
    sch, plan_s, ue_data, test = main_path_inputs()
    launches, main_clock = phase_main_path(sch, plan_s, ue_data, test)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s")

    print("== phase 4: the card against the CPU, one cloud round")
    t0 = time.perf_counter()
    card_sync, spread = phase_card_vs_cpu(sch, ue_data, test)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s")

    print("== phase 5: async Algorithm 1 at full width")
    t0 = time.perf_counter()
    phase_async(sch, ue_data, test, card_sync, spread)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")

    print("== phase 6: streaming edge aggregation, 1,048,576 rows")
    t0 = time.perf_counter()
    launches["segment_sum"] = phase_streaming()
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")

    print("== phase 7: serving full-width RecurrentGemma-9B")
    t0 = time.perf_counter()
    rg_prefill = dict(flash_attention=12, rglru_scan=26)
    phase_serve_cli(["--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH),
                     "--prompt-len", str(SERVE_PROMPT), "--gen",
                     str(SERVE_GEN), "--seed", "0"], SERVE_BATCH, rg_prefill,
                    12)
    served = phase_serving(SERVE_ARCH, SERVE_PARAMS, rg_prefill, 12)
    phase_serving_card_vs_cpu(SERVE_ARCH, 3, CPU_PROMPT,
                              dict(flash_attention=1, rglru_scan=2), 1)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")

    print("== phase 8: serving the scanned dense stack: full-width "
          "ChatGLM3-6B, then the serving CLI's default")
    t0 = time.perf_counter()
    glm = phase_serving(GLM_ARCH, GLM_PARAMS, dict(flash_attention=28), 28)
    phase_serving_card_vs_cpu(GLM_ARCH, 3, GLM_CPU_PROMPT,
                              dict(flash_attention=3), 3)
    check(Model(get_config(CLI_ARCH)).num_params() == CLI_PARAMS,
          f"{CLI_ARCH}: parameters != {CLI_PARAMS}")
    phase_serve_cli([], CLI_BATCH, dict(flash_attention=CLI_LAYERS),
                    CLI_LAYERS)
    for name in ("flash_attention", "rglru_scan", "decode_attention"):
        launches[name] = served["launches"][name] + glm["launches"][name]
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")

    print("== phase 9: data-sharded sync Algorithm 1, 2 ranks on the card")
    t0 = time.perf_counter()
    sharded = phase_sharded(sch, ue_data, test)
    for name in ("segment_aggregate", "weighted_mean"):
        launches[name] += sharded[name]
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")

    print("== phase 10: the stochastic clock at full width")
    t0 = time.perf_counter()
    stochastic = phase_stochastic(sch, ue_data, test, main_clock)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    for name in ("segment_aggregate", "cloud_aggregate"):
        launches[name] += stochastic[name]

    print("== phase 11: faults and sampling at full width")
    t0 = time.perf_counter()
    faulty, fault_errs, fault_runs = phase_faults(sch, ue_data, test)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    for name in ("segment_aggregate", "cloud_aggregate"):
        launches[name] += faulty[name]
        errs[name] = max(errs[name], fault_errs[name])

    print("== phase 12: joint planning, a checkpointed async run")
    joint = phase_joint(ue_data, test)
    print("== phase 13: the always-on service on the card")
    served13, stream_service = phase_service(sch, ue_data, test)
    for name in KERNELS:
        launches[name] += joint[name] + served13[name]

    print("== phase 14: async, faults, sampling, the service and the SPMD "
          "round on 4 ranks (phase 19's runs beside it)")
    mesh19 = MeshModelPhase()
    mesh19.start_dryrun()
    mesh19.start()
    meshed = phase_mesh(sch, ue_data, test, {
        "service": stream_service, **fault_runs})
    for name in KERNELS:
        launches[name] += meshed[name]

    print("== phase 19: the transformer sharded over 4 ranks (DTensors, "
          "gloo, one card) and the dry run, begun beside phase 14")
    t0 = time.perf_counter()
    meshed19 = mesh19.finish()
    for name, n in meshed19.items():
        launches[name] += n
    time_attention(ATTN_MESH_LOCAL, torch.bfloat16)
    time_decode(DECODE_MESH_LOCAL, torch.bfloat16)
    time_split_rule(DECODE_MESH_LOCAL, torch.bfloat16)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s after phase 14")

    print("== phase 15: the transformer's training half (its part (d) ran "
          "in phase 14's ranks)")
    t0 = time.perf_counter()
    trained = phase_train()
    cut = phase_train_card_vs_cpu()
    phase_refuse_autograd()
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")

    print("== phase 18: the roofline bridge (on phase 15's StableLM-1.6B, "
          "before its weights are freed)")
    t0 = time.perf_counter()
    roof = phase_roofline(trained, cut)
    del trained
    for name in KERNELS:
        launches[name] += roof[name]
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")

    print("== phase 16: the MoE FFN (full-width Qwen1.5-MoE-A2.7B, Mixtral "
          "at smoke width) and the xLSTM kinds (full-width xLSTM-125M)")
    t0 = time.perf_counter()
    moe_run = phase_moe_serving()
    mixtral = phase_moe_smoke()
    phase_xlstm()
    for name in ("flash_attention", "decode_attention"):
        launches[name] += moe_run["launches"][name] + mixtral[name]
        errs[name] = max(errs[name], moe_run["errs"][name])
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")

    print("== phase 17: the encoder-decoder stack (full-width Whisper-base) "
          "and the vision frontend in bf16 (full-width InternVL2-26B)")
    t0 = time.perf_counter()
    fronts = phase_frontends()
    for name in ("flash_attention", "flash_attention_bf16",
                 "decode_attention", "decode_attention_bf16"):
        launches[name] += fronts["launches"][name]
        errs[name] = max(errs[name], fronts["errs"][name])
    timing["flash_attention_bf16"] = fronts["timing"]["vlm_flash"]
    timing["decode_attention_bf16"] = fronts["timing"]["vlm_decode"]
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")

    print(f"total {time.perf_counter() - t_start:.1f} s on {card_line()}")
    print("kernels: " + ", ".join(KERNELS))
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", **meta, launches=launches[name],
             max_abs_err=errs[name], **timing[name])
        for name, meta in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
