#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py [--profile] [--tune] [--long-runs]

It builds the port's CUDA kernels from ``hybridbackend_tpu_torch/ops/csrc``
(one nvcc per source, all at once) and its native Parquet reader from
``hybridbackend_tpu_torch/native/hbtpu_data.cc`` (``g++`` beside them), and
drives the flagship sparse train
step, ``benchmarks/train_benchmark.py --sparse`` with its defaults: 26
tables of [100000, 16] stacked into one [2600000, 16] table, batch 8192
with 13 dense features, BCE loss, Adam 1e-3 on the tower, ids shifted by
one per step; with f32 tables, and then bf16 tables and slots (the JAX
harness's ``--table-dtype bfloat16``); in these variants:
  * DCNv2 (429x429 cross layer, MLP 1024-512-256-1) with row-sparse
    Adagrad 0.05 on the table, with and without duplicate combining;
  * DLRM (``--model dlrm``: bottom MLP 512-256, dot interaction of 27
    features of 16, top MLP 1024-512-1) with LazyAdam 0.05 on the table;
  * DCNv2 with the dense-split Adagrad update (``table_split_dense=True``,
    the JAX option ``emb_update_split_dense='on'``);
  * DCNv2 with bf16 matmul operands (the JAX harness's ``--bf16``).
Weights are random, drawn from a fixed seed. The config, its state and
step, the batch and the timing of a window of steps are the port's
harness's (``hybridbackend_tpu_torch/benchmarks/train_benchmark.py``), so
the timed phases and the harness time the same thing.

Phases; any failure raises and the script exits nonzero:
  0. the card (nvidia-smi), torch/CUDA/nvcc versions, whether pyarrow's
     headers, ``libarrow`` and ``libparquet`` are present (with its
     version), the native reader's build (``g++``, beside the kernel
     builds) and its time, the native helpers' build
     (``native/idmap.py``: the id hash and the dataframe's row takes,
     which the readers' shuffled batches go through), the kernel builds
     with ptxas's registers and spills, and the resident blocks per SM of
     the Adagrad and LazyAdam kernels at the flagship row width;
  1. each kernel against its plain PyTorch version on the card, at the
     flagship update list, with both times and, where one PyTorch call
     computes the same function, that call's time: Adagrad (both modes),
     the add kernel through ``sparse_sgd_apply``, LazyAdam, the dense row
     totals, the split-dense update against the fused one, the row gather
     (at the flagship lookup and at [100000, 128] x 16384) and the
     stochastic bf16 round of the flagship gradients; then the gather and
     the round once more through their entry points, with the launch
     counts read around them; then the Adagrad (both modes), add,
     LazyAdam and dense-totals kernels at full width on an edge list
     (runs across and longer than a tile), with the gradients and then
     the table and slots one float into their storage, against the plain
     versions on the CPU copy; then the bf16 storage mode of the Adagrad
     (both modes), LazyAdam and add kernels at the flagship list against
     their plain versions on the CPU copy (at most 1 bf16 ulp an element,
     the count that differ printed), with their times and bounds, the
     bf16 split-dense update bitwise against the fused one, and the bf16
     modes on edge lists (d = 16 aligned, gradients and then table and
     slots one bf16 into their storage; d = 5; rows too wide to stage);
     then the lists with long runs: kernel 1 in its four modes at the
     Criteo entry point's update list (``criteo_list``, runs of up to
     about 1600 entries), at the flagship list and at phase 36's, bit
     for bit its plain version's totals with a correctly rounded apply
     (``scatter.adagrad_update_sorted_exact``), kernels 4 and 2 there
     bitwise their plain versions and kernel 3 within 1e-5, each timed
     there;
  2. one full-width DCNv2 + Adagrad step on the GPU against the CPU;
  3. that step timed on the card; the Adagrad kernel must have been
     launched once per step;
  4. one full-width DCNv2 step with ``table_dedup=False``, GPU vs CPU;
  5. one full-width DLRM + LazyAdam step, GPU vs CPU;
  6. that step timed on the card; the LazyAdam kernel must have been
     launched once per step;
  7. one full-width DCNv2 step with the dense-split Adagrad update, GPU
     vs CPU; the dense row-totals kernel launched once, the fused
     Adagrad kernel never;
  8. that step timed on the card, with the same launch counts per step;
  9. one full-width DCNv2 + Adagrad step with bf16 tables, GPU vs CPU;
 10. that step timed; the Adagrad kernel launched once per step;
 11. one full-width DCNv2 + no-dedup Adagrad step with bf16 tables, GPU
     vs CPU;
 12. one full-width DLRM + LazyAdam step with bf16 tables, GPU vs CPU;
 13. that step timed; the LazyAdam kernel launched once per step;
 14. one full-width DCNv2 + split-dense Adagrad step with bf16 tables,
     GPU vs CPU;
 15. one full-width DCNv2 step with bf16 matmul operands, GPU vs CPU;
 16. one run of the port's harness, ``python -m
     hybridbackend_tpu_torch.benchmarks.train_benchmark --sparse
     --table-dtype bfloat16 --json``, whose JSON line is printed;
 17. the flagship DCNv2 + Adagrad through ``SparseTrainer``, as a user
     trains it: 64 steps of seeded Criteo-like host batches
     (``benchmarks/synthetic.py``) through ``DeviceIterator``, with a
     ``StepStatHook`` and a checkpoint every 32 steps; the Adagrad kernel
     launched once per step; then ``evaluate`` (4 batches of 8192 and one
     of 1000) on the card against the CPU's on the same parameters (AUC
     within a limit set by the predictions near a threshold), ``predict``,
     a fresh trainer's restore of step 64 and a resume from step 32, both
     bitwise equal to the live state; its synced ms/step beside the
     harness's bare step, the stall fraction and the AUC are printed;
     then 8 steps with LazyAdam tables (``table_optimizer='adam'``), the
     LazyAdam kernel launched once per step; then the loop timed in
     alternating rounds: the step alone on placed batches, ``train``
     with and without ``DeviceIterator`` from an in-memory source and
     from one that waits 4 ms a batch, and the two input paths alone;
 18. the dense-gradient ``Trainer`` at the flagship width (26 unstacked
     tables, ``multi_optimizer(Adagrad 0.05, Adam 1e-3)``): 3 steps on
     the card against the same 3 on the CPU (tables, accumulators, tower
     gradients and second moments across the devices; each device's
     tower weights against Adam's step from its own moments), then 33
     timed steps and one evaluation; every table's gradient through kernel
     4 (``dense_row_totals``), once a table a step;
 19. the harness in its dense mode (no ``--sparse``), its JSON line
     printed;
 20. the port's e2e harness (``python -m
     hybridbackend_tpu_torch.benchmarks.e2e_benchmark --json``) in one
     process of its own, with the native reader and then with
     ``--python-reader``: a Parquet file of 64 batches of 8192 through
     ``ParquetDataset`` and ``DeviceIterator`` into the flagship sparse
     step, 128 timed steps; each JSON line printed (e2e examples/s, stall
     fraction, the steps alone on placed batches, the reader and its
     rows/s alone); the Adagrad kernel launched once a step, at least 64
     fetches, and the native reader serving where phase 0 found Arrow;
 21. the port's Criteo entry point (``examples/criteo/train.py --sparse
     --synthesize``) trains 64 steps from the file it writes, evaluates
     and prints the AUC (the Adagrad kernel once a step); the native and
     the Python reader give the file's batches bit for bit in file order
     and permutations of its rows shuffled; the entry point trains and
     evaluates again through the Python reader, and the planted signal's
     own AUC is printed beside both; the file's first
     2 batches train its trainer on the card against the CPU, each step
     from one state (loss, tables, accumulators, tower gradients and
     weights at phase 2's tolerances, and phase 18's rule); then
     the flagship ``SparseTrainer`` trains from phase 20's file in 4
     alternating rounds of 32 steps (the step alone on placed batches,
     ``train`` with and without ``DeviceIterator`` from each reader, as
     the trainers' ``prefetch`` default is decided), and 8 steps with
     LazyAdam tables (the LazyAdam kernel once a step);
 22. serving: phase 17's trained ``SparseTrainer`` exports an f32 and an
     int8 bundle (``export_saved_model(..., poly_batch=True)``); a fresh
     process loads each as ``Served`` on the card and predicts batches of
     1, 128 and 8192 rows, kernel 5 launched once per member lookup (26
     a predict in f32, 52 in int8: rows and scales) by its own counter;
     the f32 predictions within 1e-6 of the live trainer's and near the
     same bundle served on the CPU, the int8 ones within 2e-2 of f32;
     ``quantize_table`` and ``lookup_quantized`` on the card bit for bit
     against the CPU at the flagship lookup; then the serving harness
     (``python -m hybridbackend_tpu_torch.benchmarks.serving_benchmark
     --cases f32 int8 --json``) once, its JSON line printed;
 23. DIN (the port's DIN harness's ``--sparse`` config: item [1000000, 32]
     and user [100000, 32] in one [1100000, 32] stack, batch 2048, history
     64, DNN 256-128-64, attention 80-40, 2 dense features): kernel 1 at
     the DIN step's update list (135168 rows) against its plain version,
     with its times and bound; then the raw-mode ``SparseTrainer`` step on
     the card against the CPU from the same weights, plain, with 4
     sessions (``-1`` holes) and with the attention's weight
     normalization, 3 steps each from one state (loss, tables,
     accumulators, the tower by phase 18's rule), kernel 1 once a step,
     the rows behind the holes untouched and planted candidates moved by
     their exact run totals;
 24. the DIN harness (``python -m hybridbackend_tpu_torch.benchmarks.
     din_benchmark --json``) at its defaults, dense, ``--sparse`` and
     ``--sparse --sessions 4``, in turn in one process of its own, JSON
     lines printed (kernel 1 once a step in the sparse modes);
 25. the port's Taobao entry point (``examples/taobao/train_din.py
     --synthesize --sparse``, and with ``--sessions``) for 64 steps from
     the file it writes, its evaluation restored on the card (equal) and
     on the CPU (AUC and GAUC within their limits), restore and resume
     bitwise; each trainer's f32 and int8 bundles served by a cold process
     on the card at 1, 128 and 512 rows (kernel 5 twice a f32 predict, 4
     times an int8 one; f32 within 1e-6 of the trainer); then the serving
     harness's DIN case (``--cases din``), its JSON line printed;
 26. host-backed tables: the flagship DCNv2 step with ``c0`` a [10000000,
     16] f32 table and its Adagrad slot in host DRAM behind a 1000000-row
     device cache (``EmbeddingCache``), ``c0``'s ids ``zipf(1.5) %
     vocab``, 32 steps through ``SparseTrainer(caches=...)`` and a flush,
     every touched host row held against an uncached run (``c0`` a
     [10000000, 16] device table) at ``rtol 2e-4, atol 2e-6``; then a
     1024-row cache for 32 steps (most steps evict) and LazyAdam behind
     1024 rows for 8 steps, each held the same way; kernel 1 (or 3) once
     a step and kernel 5 once an array at each eviction and the flush;
     per step of the first half: cached against uncached ms, the plan,
     eviction and upload ms, the hit rate and rows evicted; the second
     half's ms a step with no sync between steps;
 27. a dynamic table: ``c0`` a ``DynamicEmbedding`` of 1000000 rows over
     raw int64 ids (``murmur3_mix64`` of zipf draws), ``min_count`` 1 and
     3, mapped in ``DeviceIterator``'s thread into ``SparseTrainer`` for
     16 steps; ``map_ids`` timed per batch, the ``state_dict`` round trip
     bitwise, and an export with its ``id_mappers``;
 28. the Criteo entry point with ``--sparse --cached 32768 --export DIR
     --export-poly`` and then ``--export-int8``, at its defaults; the
     bundles of phases 27 and 28 served by one cold process on the card
     (kernel 5 once a member lookup, twice in int8), f32 within 1e-6 of
     each trainer's predictions, int8 within 2e-2.
 29. micro-batch gradient accumulation on the dense ``Trainer``'s flagship
     model (26 unstacked [100000, 16] tables, DCNv2, ``multi_optimizer``):
     ``accumulate_gradients`` over 4 micro-batches against the whole
     batch's gradients on the card (``rtol 1e-4, atol 1e-6``); 3 steps of
     ``make_pipelined_train_step`` (4 micro-batches) on the card against
     the CPU, each from the initial weights, at phase 18's tolerances;
     ms/step at 1, 2 and 4 micro-batches against ``make_train_step``, in
     turns; kernel 4 once a table a micro-batch's backward;
 30. the PICASSO interleaved sparse step (``make_interleaved_train_step``,
     the lookups on a side stream) at the flagship, DCNv2 + Adagrad and
     DLRM + LazyAdam: 3 steps of 4 micro-batches on the card against the
     CPU, each from the initial weights (phase 2's and phase 5's
     tolerances, the tower by phase 18's rule too), and 3 consecutive
     steps against the plain step on the card, each from its state (the
     JAX test's limits); kernel 1 (or 3) once a step at 1, 2
     and 4 micro-batches; DCNv2's ms/step against the plain step in
     turns; then the harness, ``--sparse`` and ``--sparse --interleave
     1|2|4``, in turn in one process of its own, JSON lines printed;
 31. the single-device harnesses at their defaults, in turn in one
     process of their own, JSON lines printed: ``auc_parity.py
     --skip-overflow`` (exit 0, ``parity_ok.fast`` true, kernel 1 once a
     ``fast`` step; ``fast_overflow`` changes nothing at a world of one,
     and the CPU tests run it at two),
     ``data_benchmark.py`` in its four modes (parquet, csv, dedup at 40
     steps of the harness's 100, the host-to-device transfer from
     pageable and pinned memory) and
     ``e2e_benchmark.py --profile`` (the stages' medians).
 32. a world of N ranks: the collectives of ``distribute/collective.py``
     on NCCL at a world of one on the card, and kernel 1 on an owner list
     that went through ``all_to_all_v`` there; and the harness once under
     the launcher (``--simulate 2 --lookup alltoall --repeats 2``), its
     JSON line printed. Its world-of-N cases run in phase 33's launches.
 33. every sparse step at a world of N: one launch a world
     (``python -m hybridbackend_tpu_torch.run ... chip_smoke.py --rank-of
     DIR``) of N = 2 and 4 gloo ranks sharing the card (``--simulate N
     --device cuda``; its NCCL world of one runs in phase 35), both
     launches at once, each world held while the other's ranks run. Every rank
     first probes ``all_reduce``, ``all_to_all_single``,
     ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` in bf16 and
     fp16 on its backend, and holds each of the port's cast collectives
     that only moves data bitwise against cast, f32 collective, cast, and
     the cast all-reduce within the wire's rounding. Then, from the seed's
     state on the ranks' rows of a global batch of 8192, at full width,
     3 steps each of phase 32's flagship DCNv2 + Adagrad with the table
     row-sharded over the ranks, under the ``allgather`` lookup, the
     ``alltoall`` one, and ``alltoall`` with bucket ratios so low that
     every lookup and update falls back to the exact exchange; DLRM +
     LazyAdam (kernel 3), no-dedup Adagrad (kernel 1's per-occurrence
     mode; and with an update bucket ratio so low that every rank falls
     back every step), the split-dense update (kernel 4 on each owner's
     shard), bf16 tables with Adagrad and with DLRM + LazyAdam, and
     DCNv2 + Adagrad with ``wire_dtype`` and ``gradient_wire_dtype``
     bfloat16; 3 rounds of ``sparse_sgd_apply`` on the flagship list
     (kernel 2 on every owner); and 3 raw-mode DIN steps at the DIN
     harness's defaults with 4 sessions (kernel 1 on every owner). Each
     is held against the world of one on the card, each step from one
     tower (the LazyAdam and bf16 cases from one whole state), the wire
     case by the wire's bands, the LazyAdam cases with a few ReLU gate
     flips let past and counted; rows that no valid id read, those behind
     ``-1`` holes among them, keep their bits. On every rank the last
     held step's update kernel (the last SGD round's) runs again on a
     copy of the list it received, ``-1`` lanes and all, and of the shard
     before it, against its plain version on the CPU at phase 1's
     tolerances. Then 3 timed steps of each step case (gloo ranks
     sharing one card: not a multi-GPU number).
 34. the trainers at a world of 2 gloo ranks sharing the card (one launch,
     ``chip_smoke.py --rank-of DIR`` with ``{"phase": 34}``): the flagship
     DCNv2 + Adagrad ``SparseTrainer`` on its row-sharded stack, 6 steps of
     the harness's seeded batches (with a group column) through
     ``DeviceIterator``, a checkpoint at step 3; ``evaluate`` over 3 eval
     batches, the last 1000 rows on rank 0 alone (rank 1 has run out); an
     export; then the dense ``Trainer`` with its 26 tables row-sharded, 3
     steps. Against the world of one on the card, each step from rank 0's
     tower: each loss to 1e-6 relative, the tower by phase 18's rule, the
     gathered table and accumulators to 1e-7 at steps 3 and 6 (the dense
     tables and accumulators after 3 steps); the world's step-3 checkpoint
     restored at a world of one bit for bit, and steps 4-6 on from it;
     the evaluation by ``metrics.auc_limit`` and ``_gauc_limit`` (the
     same state, predictions apart by the GEMMs' row blocks) and its loss
     to 1e-5; the world's bundle served cold in this process within 1e-6
     of the world of one's predictions, through kernel 5. Every rank
     reports the same losses and evaluation and holds rank 0's replicated
     parameters bit for bit; kernel 1 runs once a step on every rank and
     again on each rank's last received list against its plain version.
     Meanwhile this process runs the ``SparseTrainer`` in a joined NCCL
     world of one (2 steps, checkpoints, an evaluation) against the same
     trainer in no world, bit for bit. In the same launch each rank then
     trains the flagship with members ``c0`` and ``c13`` in host DRAM
     behind caches of 16384 and 20480 slots (``cached``; ``c0``'s slots
     in rank 0's rows of the stack, ``c13``'s straddling the ranks'
     split): 8 steps of its rows of the global batches, the ids of the
     world's batch planned together on every rank, evictions from step 3
     on, a checkpoint at step 4, then the flush and an export. Against
     the cached world of one on the card, each step from rank 0's tower:
     each rank's slot metadata after each step bit for bit the other
     ranks' and the world of one's, each loss to 1e-6 relative, every
     rank's flushed host tables and accumulators bit for bit rank 0's
     and within 1e-7 of the world of one's, the world's bundle served
     within 1e-6 of the world of one's bundle; kernel 1 once a step on
     each rank and again on its last received list against its plain
     version, and each launch of kernel 5 on the owners' evicted and
     flushed rows against ``index_select``, on every rank. Beside the
     launch, ``benchmarks/embedding_benchmark.py`` (its forward
     checks) and ``collective_benchmark.py`` run under the launcher on 2
     gloo ranks sharing the card and on a NCCL world of one, 3 steps,
     1 and 4 MB: their times are a check's cost, gloo's through the
     host.
 35. node groups, the last three exchanges, the interleaved step and
     sharded serving: one launch of 4 gloo ranks
     in 2 nodes of 2 sharing the card (``--simulate 4 --nodes 2``,
     ``chip_smoke.py --rank-of DIR`` with ``{"phase": 35}``), from the
     seed's state on the ranks' rows of the global batch of 8192, 3 steps
     each of the flagship DCNv2 + Adagrad under the ``hierarchical``
     lookup (intra-node, then inter-node), the same with both bucket
     ratios so low that every lookup and update falls back to the exact
     exchange, and under ``gspmd``; with every table column-sharded
     (each rank every row of a 4-wide slice of the [2600000, 16] stack,
     kernel 1 on the whole batch's list); DLRM + LazyAdam on column
     tables (kernel 3); the interleaved step, DCNv2 + Adagrad under
     ``alltoall`` in 2 micro-batches of each rank's 2048 rows and DLRM +
     LazyAdam under ``hierarchical`` in 4 of 512 (kernel 1 or 3 once a
     step on each rank); then the dense ``Trainer`` through the
     hierarchical lookup, 3 steps. Each is held against the world of one
     on the card (``interleave`` against its plain step,
     ``interleave_adam`` against its interleaved step in the world's 16
     micro-batches of 512 rows, and against its plain step with the
     elements past the flip rule on the rows of the examples whose ReLU
     gates differ between the whole batch and those micro-batches), each
     step from one tower, by phase 33's rules (the
     loss to 1e-5, the gathered state, the tower by phase 18's rule,
     LazyAdam by its flip rule), the dense Trainer's loss, tables and
     accumulators to 1e-5; every rank's last update kernel runs again on
     a copy of its list against its plain version on the CPU; then 3
     timed steps a case (gloo ranks sharing one card: a check's cost).
     After the hierarchical case's steps each rank serves its shard: it
     quantizes it (bit for bit its rows of the quantized whole table) and
     predicts its rows of the next batch through the sharded int8 stack
     (kernel 5 on rows and scales) and the tower, the embeddings bit for
     bit the world of one's ``lookup_quantized`` and the predictions
     within 1e-6; and it serves the float shard (``serving=True``, kernel
     5 at the owners) under ``allgather`` and ``alltoall``, bit for bit
     the training lookup. Meanwhile the launcher starts a NCCL world of
     one on the card (``--nproc 1 --nodes 1``, ``{"phase": "35-nccl"}``):
     phase 33's wire probe, each topology's collectives on its
     subgroups, then 2 steps each of the hierarchical, column,
     interleaved (k = 2) and wire cases, held against the same steps in
     no world in this process, bit for bit.
 36. the module adapter (``module_support.py``) at the width of the JAX
     flax example, through the port's entry point
     (``examples/criteo/train_module.py``, its ``run``): 26 tables of the
     JAX example's vocabularies at dim 16 in one [1279569, 16] stack,
     batch 4096, ``Linear`` 512-256-64-1 over ``'concat'``, Adagrad 0.1
     on everything, 8 steps from the file it synthesizes, an evaluation
     of 20 batches and an export; the summaries read back (``train/loss``
     at steps 4 and 8, the evaluation's scalars); ``save_weights`` and
     ``load_weights`` into a fresh adapter bit for bit; the module's
     inputs through kernel 5 on the member tables bitwise those through
     ``index_select`` on the stack; each bundle (``'concat'``, and
     ``'features'`` and ``'raw'`` on copies of the same weights, one step
     each) served on the card, kernel 5 once a column a predict, within
     1e-6 of ``predict``; one step on the card against the CPU from the
     card's state (phase 18's rule); the table gradients of the adapter
     and of the flagship dense ``Trainer``'s model from one state, 3 times
     each, bit for bit, kernel 4 once a stack (table) a backward; the
     adapter's captured gradients of the embeddings through
     ``dense_row_totals`` on the card bitwise the CPU plain version, and
     kernel 4 at that list timed beside its bound, the stable sort, the
     plain version and ``zeros`` + ``index_add_`` (the old backward,
     repeated as the witness of atomics); then ``profile_trace`` around 2
     flagship sparse steps (each named range twice, CUDA kernel events)
     and the flagship step timed with the named ranges on and off, in
     turns.
Every dense backward through a table lookup (phases 18, 19, 24's dense
mode, 29, 31's ``exact``, the dense ``Trainer`` cases of 34 and 35, 36)
and every GAUC evaluation (phases 25 and 34) launches kernel 4, and every
row-sharded update that combines a rank's duplicate rows before the
alltoall route (phases 33-35) launches it once a step; the launch counts
are held to that.
With ``--profile`` it then traces 10 steps of each timed variant and of
the DIN harness's ``--sparse`` step with and without sessions with
``torch.profiler`` and prints device time per step by kernel class; in
phase 30 it traces the plain and interleaved DCNv2 steps too, with the
kernel time on each CUDA stream and the time two streams ran at once. With
``--tune`` phase 1 also times the add kernel over tile sizes, the
dense-totals kernel over block and chunk sizes, and the Adagrad (both
modes) and LazyAdam kernels over tile sizes and state batches (the rows
of how many run heads a thread loads before it waits for its tile's
gradients); each sweep forth and back, and the dense-totals kernel's
sweep at phase 36's and a dense ``Trainer`` table's list too.
``--long-runs`` runs nothing else but ``long_runs_probe``: kernels 1-4
timed at the flagship, the Criteo, phase 36's, the DIN and a dense
``Trainer`` table's list (with ``--tune``, lists of equal runs and kernel
4's sweeps too); a copy of this file put into an older checkout times
that checkout's kernels the same way, so that two trees compare in one
call.
The run's wall time is printed before the last two lines. The
second-to-last line is a JSON object describing each kernel (its times,
launches on its path, in the trainers' runs, in the runs from Parquet
files, in the served predicts, in the DIN phases, in the host-table
phases, in the pipelining phases, in phase 33's ranks (phase 32's
cases, then the others), in phase 34's worlds, in its cached case, in
phase 35's (the exchanges' cases, then the interleaved cases and
sharded serving), in phase 36 and in the dense backwards,
and its bound: the
larger of its bytes over 3.35 TB/s and its operations over the card's
peak rate); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it fails before printing
either.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import functools
import inspect
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from hybridbackend_tpu_torch.benchmarks import din_benchmark as din
from hybridbackend_tpu_torch.benchmarks import synthetic
from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = 'hybridbackend_tpu_torch/ops/csrc'
PALLAS = 'hybridbackend_tpu/ops/pallas'
# name -> (source, TPU kernel it replaces)
KERNELS = {
    'adagrad_update_sorted': (f'{CSRC}/adagrad_update.cu',
                              f'{PALLAS}/scatter.py:534'),
    'adagrad_update_sorted[dedup=False]': (f'{CSRC}/adagrad_update.cu',
                                           f'{PALLAS}/scatter.py:534'),
    'scatter_add_sorted': (f'{CSRC}/scatter_add.cu',
                           f'{PALLAS}/scatter.py:429'),
    'adam_update_sorted': (f'{CSRC}/adam_update.cu',
                           f'{PALLAS}/scatter.py:749'),
    'gsum_dense_sorted': (f'{CSRC}/gsum_dense.cu',
                          f'{PALLAS}/scatter.py:677'),
    'gather_rows': (f'{CSRC}/gather_rows.cu', f'{PALLAS}/gather.py:51'),
    'stochastic_round_bf16': (f'{CSRC}/stochastic_round.cu',
                              f'{PALLAS}/cast.py:27'),
    # The bf16 storage mode of kernels 1-3: bf16 table, slots, gradients.
    'adagrad_update_sorted[bf16]': (f'{CSRC}/adagrad_update.cu',
                                    f'{PALLAS}/scatter.py:534'),
    'adagrad_update_sorted[bf16,dedup=False]': (f'{CSRC}/adagrad_update.cu',
                                                f'{PALLAS}/scatter.py:534'),
    'adam_update_sorted[bf16]': (f'{CSRC}/adam_update.cu',
                                 f'{PALLAS}/scatter.py:749'),
    'scatter_add_sorted[bf16]': (f'{CSRC}/scatter_add.cu',
                                 f'{PALLAS}/scatter.py:429'),
    # Kernel 1 at the DIN step's update list (phase 23).
    'adagrad_update_sorted[din]': (f'{CSRC}/adagrad_update.cu',
                                   f'{PALLAS}/scatter.py:534'),
    # Kernel 1 at the Criteo entry point's update list (criteo_list), whose
    # runs are up to about 1600 entries long.
    'adagrad_update_sorted[criteo]': (f'{CSRC}/adagrad_update.cu',
                                      f'{PALLAS}/scatter.py:534'),
    # Kernel 4 as the backward of a table lookup (dense_row_totals), at
    # phase 36's list.
    'gsum_dense_sorted[lookup backward]': (f'{CSRC}/gsum_dense.cu',
                                           f'{PALLAS}/scatter.py:677'),
}
# The rows of the kernels that hold state rows in registers.
STATE_KERNELS = ('adagrad_update_sorted',
                 'adagrad_update_sorted[dedup=False]', 'adam_update_sorted',
                 'adagrad_update_sorted[bf16]',
                 'adagrad_update_sorted[bf16,dedup=False]',
                 'adam_update_sorted[bf16]')
# NVIDIA H100 SXM peaks (data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores. Integer work (the Philox rounds) is counted at half
# the f32 rate, the SM's 64 INT32 lanes against 128 FP32 lanes.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = F32_OPS_PER_S / 2
L2_FLUSH_BYTES = 256 * 2**20


def flagship(*flags: str) -> argparse.Namespace:
  """The port's harness's flags for ``--sparse`` with its defaults (the
  JAX harness's) and ``flags``: the flagship config and its variants."""
  return tb.parse_args(['--sparse', *flags])


def _counts():
  import hybridbackend_tpu_torch as hbt
  return {name: getattr(hbt, name).launches for name in tb.COUNTED}


def _reset_counts():
  import hybridbackend_tpu_torch as hbt
  for name in tb.COUNTED:
    getattr(hbt, name).launches = 0


def _expect(label, counts, **want):
  """Fails unless ``counts`` are ``want`` and every other count is 0."""
  want = {name: want.get(name, 0) for name in tb.COUNTED}
  if counts != want:
    raise AssertionError(f'{label}: kernel launches {counts}, expected '
                         f'{want}')


# Kernel 4's launches in the dense backwards of every phase (each table
# lookup's backward through ``dense_row_totals``), for the kernels line.
DENSE_BACKWARD = collections.Counter()


def _dense_backward(counts):
  """Adds a dense run's kernel-4 launches to ``DENSE_BACKWARD``."""
  DENSE_BACKWARD['gsum_dense_sorted'] += counts['gsum_dense_sorted']


def _bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
  """The least time the card could take: the larger of the bytes over the
  memory rate and the operations over the peak rate."""
  by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  by_ops = ops / ops_per_s * 1e3
  return dict(bytes=nbytes, ops=ops, bound_ms=max(by_bytes, by_ops),
              bound_by='bytes' if by_bytes >= by_ops else 'operations')


@functools.cache
def _l2_flush_buffer():
  return torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                     device=torch.device('cuda', torch.cuda.current_device()))


def _flush_l2():
  """Reads ``L2_FLUSH_BYTES`` (more than five times the 50 MB L2), so the
  next call finds none of its inputs in L2 and its last outputs have
  been written back, as a caller whose data is not the last one touched
  would. A read leaves clean lines, which cost the next call nothing to
  evict."""
  _l2_flush_buffer().sum()


def _median_ms(fn, iters=20, warmup=3, per=10, queued=True):
  """Device time of one call of ``fn``, by CUDA events: the median over
  ``iters`` runs of ``per`` calls, each call after an L2 flush
  (:func:`_flush_l2`) and between its own pair of events, so the flush
  is not timed.

  ``queued``: each run first holds the device with a spin kernel long
  enough for the host to enqueue all ``per`` calls behind it, so the
  events time the device's work and not the host's enqueue (a wrapper
  spends tens of microseconds in Python, as long as a small kernel
  runs). The spin is doubled until the first event is still pending when
  the last call has been enqueued; the ``per`` calls must launch fewer
  kernels than the device's queue holds (about a thousand). A function
  that waits for the device (the plain versions: boolean masks and
  ``unique`` read a count back) takes ``queued=False``: events around
  each call, host waits included."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  _flush_l2()
  fn()
  hold_ms = 2 * per * (time.perf_counter() - t0) * 1e3 + 0.5
  calls = per if queued else 1
  times, runs = [], 0
  while runs < iters:
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    if queued:
      # At most 2 GHz, so 2e6 cycles last at least a millisecond.
      torch.cuda._sleep(int(2e6 * hold_ms))
    for start, end in events:
      _flush_l2()
      start.record()
      fn()
      end.record()
    held = not queued or not events[0][0].query()
    events[-1][1].synchronize()
    if held:
      times += [start.elapsed_time(end) for start, end in events]
      runs += 1
    elif hold_ms > 10_000:
      raise RuntimeError(f'the host did not enqueue {per} calls while the '
                         'device was held: a call waits for the device, or '
                         'they launch more kernels than its queue holds')
    else:
      hold_ms *= 2
  return statistics.median(times)


def _run(cmd):
  return subprocess.run(cmd, capture_output=True, text=True, check=True,
                        timeout=120).stdout.strip()


def _modules_json(runs, timeout=600):
  """``hybridbackend_tpu_torch.benchmarks.<module>.main(['--json',
  *flags])`` for each ``(module, flags)`` of ``runs`` in turn, in one
  process of its own (one start-up for all: a process's start on the H100
  machine costs about 13 s); returns each run's JSON line, object and
  wall seconds."""
  code = ('import sys, time\n'
          'from importlib import import_module\n'
          f'for module, flags in {[(m, list(f)) for m, f in runs]!r}:\n'
          "  m = import_module('hybridbackend_tpu_torch.benchmarks.' + module)\n"
          '  t0 = time.perf_counter()\n'
          "  if m.main(['--json', *flags]):\n"
          '    sys.exit(1)\n'
          "  print('__secs__', time.perf_counter() - t0, flush=True)\n")
  out = subprocess.run([sys.executable, '-c', code], cwd=HERE,
                       capture_output=True, text=True, timeout=timeout)
  if out.returncode != 0:
    raise RuntimeError(f'{runs} failed:\n{out.stderr}')
  lines = [l for l in out.stdout.splitlines() if l.startswith('{')]
  secs = [float(l.split()[1]) for l in out.stdout.splitlines()
          if l.startswith('__secs__')]
  if len(lines) != len(runs) or len(secs) != len(runs):
    raise RuntimeError(f'{runs} printed {out.stdout}')
  return [(line, json.loads(line), t) for line, t in zip(lines, secs)]


def phase0_environment():
  from hybridbackend_tpu_torch.ops import build
  smi = _run(['nvidia-smi', '--query-gpu=name,power.limit',
              '--format=csv,noheader']).splitlines()[0]
  print(smi)
  nvcc = _run([build.nvcc_path(), '--version']).splitlines()[-1]
  print(f'python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda} nvcc: {nvcc}')
  from hybridbackend_tpu_torch.native import tabular
  flags, arrow = tabular.arrow_toolchain()
  print(f'Arrow for the native reader: {arrow}' if flags else
        f'Arrow for the native reader: absent ({arrow}); the file phases '
        'read through the Python reader')
  # The native reader's g++ runs beside the nvcc builds.
  native = {}

  def build_native():
    try:
      native['lib'] = tabular.load()
    except tabular.NativeUnavailable as e:
      native['error'] = e
  native_build = threading.Thread(target=build_native)
  # The host library of the id hash and the dataframe's row operations
  # (``native/idmap.py``) builds beside them too: the readers' shuffled
  # batches take their rows through it.
  from hybridbackend_tpu_torch.native import idmap
  helpers = {}

  def build_helpers():
    t = time.perf_counter()
    try:
      idmap.load()
      helpers['s'] = time.perf_counter() - t
    except tabular.NativeUnavailable as e:
      helpers['error'] = e
  helpers_build = threading.Thread(target=build_helpers)
  t0 = time.perf_counter()
  if flags:
    native_build.start()
  helpers_build.start()
  libs = build.load_all()
  print(f'kernel builds: {time.perf_counter() - t0:.3f} s wall for '
        f'{len(libs)} libraries, built concurrently; each is built from and '
        f'hashed with {", ".join(h.name for h in build.headers())}')
  if flags:
    native_build.join()
    if 'error' in native:
      raise RuntimeError(f'the native reader did not build: {native["error"]}')
    lib = native['lib']
    print(f'native reader build: {lib.build_seconds:.3f} s g++ '
          f'({lib.path.name}), {time.perf_counter() - t0:.3f} s wall with the '
          'kernel builds')
  helpers_build.join()
  if 'error' in helpers:
    raise RuntimeError(f'the native helpers did not build: '
                       f'{helpers["error"]}')
  print(f'native helpers ({idmap.library_path().name}): {helpers["s"]:.3f} s '
        'to build or load')
  for name, lib in libs.items():
    print(f'  {name}: {lib.build_seconds:.3f} s nvcc ({lib.path.name})')
    for line in lib.compiler_log.splitlines():
      if 'registers' in line or 'spill' in line:
        print(f'    ptxas: {line.strip()}')
  from hybridbackend_tpu_torch.ops import scatter
  d = flagship().dim
  tile, batch = scatter.tile_entries(d), scatter.STATE_BATCH
  print(f'resident blocks per SM (256 threads each) at d = {d}, tiles of '
        f'{tile} entries, state batch {batch}: ' + ', '.join(
            f'{name} {_blocks_per_sm(name, d, tile, batch)}'
            for name in STATE_KERNELS))
  return smi, bool(flags)


def _blocks_per_sm(name, d, tile, batch):
  """Blocks of ``name``'s 4-element-lane kernel that one SM holds at once
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
  from hybridbackend_tpu_torch.ops import build
  blocks = ctypes.c_int()
  bf16 = int('bf16' in name)
  if name.startswith('adagrad'):
    lib = build.load('adagrad_update').lib
    fn = lib.hb_adagrad_update_sorted_blocks_per_sm
    args = (d, tile, batch, int('dedup=False' not in name), bf16)
  else:
    fn = build.load('adam_update').lib.hb_adam_update_sorted_blocks_per_sm
    args = (d, tile, batch, bf16)
  fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
  fn.restype = ctypes.c_int
  err = fn(*args, ctypes.byref(blocks))
  if err:
    raise RuntimeError(f'{name}: occupancy query failed: CUDA error {err}')
  return blocks.value


def _update_list(cfg: argparse.Namespace, step: int,
                 rng: np.random.RandomState):
  """The stacked update list of one flagship step (ids drawn as in
  ``train_benchmark.py:147-167``), plus 1000 ``-1`` and 1000 ``>= V``
  rows, and N(0, 0.01) gradients."""
  base = [rng.randint(0, cfg.vocab, cfg.batch) for _ in range(cfg.tables)]
  ids = np.stack([(b + step) % cfg.vocab + t * cfg.vocab
                  for t, b in enumerate(base)], axis=1).reshape(-1)
  n, v = ids.shape[0], cfg.tables * cfg.vocab
  ids[rng.choice(n, 1000, replace=False)] = -1
  ids[rng.choice(n, 1000, replace=False)] = v + rng.randint(0, 5000, 1000)
  grads = (rng.randn(n, cfg.dim) * 0.01).astype(np.float32)
  return ids.astype(np.int32), grads


def _hold(name, state0, rows, kernel, plain, tol=1e-5):
  """Runs ``kernel`` and ``plain`` on copies of ``state0`` (table first,
  then slots), checks them against each other at ``rtol = atol = tol``,
  and checks that rows not in the list stay bitwise equal."""
  got = [t.clone() for t in state0]
  want = [t.clone() for t in state0]
  kernel(*got)
  plain(*want)
  torch.cuda.synchronize()
  err = max(float((g - w).abs().max()) for g, w in zip(got, want))
  for i, (g, w) in enumerate(zip(got, want)):
    if not torch.allclose(g, w, rtol=tol, atol=tol):
      raise AssertionError(f'{name}: operand {i} differs from the plain '
                           f'version (max abs err {err})')
  v = state0[0].shape[0]
  touched = torch.zeros(v, dtype=torch.bool, device=rows.device)
  touched[rows[(rows >= 0) & (rows < v)].long()] = True
  for g, before in zip(got, state0):
    if not torch.equal(g[~touched], before[~touched]):
      raise AssertionError(f'{name} changed rows the update list does '
                           'not hold')
  return err, got


def _against_bound(m):
  return (f'bound {m["bound_ms"]:.4f} ms ({m["bytes"] / 1e6:.2f} MB), '
          f'{m["ms"] / m["bound_ms"]:.2f}x it')


def phase1_kernels(cfg: argparse.Namespace, dev: torch.device,
                   tune: bool = False):
  import hybridbackend_tpu_torch as hbt
  v = cfg.tables * cfg.vocab
  rng = np.random.RandomState(tb.SEED)
  ids, grads = _update_list(cfg, 3, rng)
  rows, order = torch.sort(torch.from_numpy(ids).to(dev), stable=True)
  g = torch.from_numpy(grads).to(dev).index_select(0, order)
  gen = torch.Generator().manual_seed(tb.SEED)
  table0 = hbt.default_initializer(gen, (v, cfg.dim)).to(dev)
  acc0 = torch.full_like(table0, tb.ADAGRAD_INIT)
  # Moments as after some steps with N(0, 0.01) gradients.
  m0 = (torch.randn(v, cfg.dim, generator=gen) * 1e-3).to(dev)
  v0 = (torch.rand(v, cfg.dim, generator=gen) * 1e-4).to(dev)
  lr = torch.full((), tb.TABLE_LR, device=dev)
  step = torch.full((), 3.0, device=dev)
  n_touched = int(torch.unique(rows[(rows >= 0) & (rows < v)]).numel())
  print(f'phase 1: update list of {ids.shape[0]} rows, {n_touched} '
        f'distinct, on [{v}, {cfg.dim}] (rtol = atol = 1e-5 against the '
        'plain version on the card: f32 sums of duplicates in another '
        'order)')
  out = {}
  stacked = hbt.TableConfig('stack', v, cfg.dim)
  raw_ids = torch.from_numpy(ids).to(dev)
  raw_g = torch.from_numpy(grads).to(dev)
  # Bytes each kernel must move at this list: the list (rows and
  # gradients, n*(d+1)*4) read once, and each distinct row of the table
  # and of each slot read and written once.
  n, d, u = ids.shape[0], cfg.dim, n_touched
  list_bytes = n * (d + 1) * 4
  valid = (rows >= 0) & (rows < v)

  for name, dedup in (('adagrad_update_sorted', True),
                      ('adagrad_update_sorted[dedup=False]', False)):
    k = functools.partial(hbt.adagrad_update_sorted, rows=rows, updates=g,
                          lr=lr, dedup=dedup)
    p = functools.partial(hbt.adagrad_update_sorted_reference, rows=rows,
                          updates=g, lr=lr, dedup=dedup)
    err, (tk, ak) = _hold(name, (table0, acc0), rows, k, p)
    tr, ar = table0.clone(), acc0.clone()
    ms = _median_ms(lambda: k(tk, ak))
    plain_ms = _median_ms(lambda: p(tr, ar), queued=False)
    st = hbt.init_adagrad_state(tk)
    path_ms = _median_ms(lambda: hbt.sparse_adagrad_apply(
        tk, st, raw_ids, raw_g, stacked, lr, dedup=dedup))
    # Sums of the list, then per distinct element a square, an add, a
    # root, an add, a product, a quotient and a difference (dedup=False
    # squares each occurrence instead).
    ops = n * d * (1 if dedup else 3) + 7 * u * d
    out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=None, path_ms=path_ms,
                     **_bound(list_bytes + 4 * u * d * 4, ops))
    print(f'  {name}: max abs err {err:.3e}; kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms; sort+gather+kernel {path_ms:.4f} ms; '
          + _against_bound(out[name]))

  # The add kernel, as sparse_sgd_apply drives it: -lr·g summed per row.
  scaled = g * -tb.TABLE_LR
  err, (tk,) = _hold('scatter_add_sorted', (table0,), rows,
                     lambda t: hbt.scatter_add_sorted(t, rows, scaled),
                     lambda t: hbt.scatter_add_sorted_reference(
                         t, rows, scaled))
  tr = table0.clone()
  ms = _median_ms(lambda: hbt.scatter_add_sorted(tk, rows, scaled))
  plain_ms = _median_ms(
      lambda: hbt.scatter_add_sorted_reference(tr, rows, scaled),
      queued=False)
  # One PyTorch call computes the same function: index_add_ of the valid
  # entries (atomics, in no fixed order).
  valid_rows, valid_scaled = rows[valid].long(), scaled[valid]
  library_ms = _median_ms(
      lambda: tr.index_add_(0, valid_rows, valid_scaled))
  # The entry point, checked against the plain version of its list with
  # the launch counts read around it, then timed.
  ts = table0.clone()
  _reset_counts()
  hbt.sparse_sgd_apply(ts, raw_ids, raw_g, stacked, tb.TABLE_LR)
  torch.cuda.synchronize()
  _expect('sparse_sgd_apply', _counts(), scatter_add_sorted=1)
  launches = 1
  want = hbt.scatter_add_sorted_reference(table0.clone(), rows, scaled)
  if not torch.allclose(ts, want, rtol=1e-5, atol=1e-5):
    raise AssertionError('sparse_sgd_apply differs from the plain version')
  path_ms = _median_ms(lambda: hbt.sparse_sgd_apply(
      ts, raw_ids, raw_g, stacked, tb.TABLE_LR), iters=10)
  out['scatter_add_sorted'] = dict(
      max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
      launches=launches, path_ms=path_ms,
      **_bound(list_bytes + 2 * u * d * 4, n * d + u * d))
  print(f'  scatter_add_sorted: max abs err {err:.3e}; kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms; '
        f'sparse_sgd_apply {path_ms:.4f} ms, {launches} launch a call')

  k = functools.partial(hbt.adam_update_sorted, rows=rows, updates=g,
                        lr=lr, step=step)
  p = functools.partial(hbt.adam_update_sorted_reference, rows=rows,
                        updates=g, lr=lr, step=step)
  err, (tk, mk, vk) = _hold('adam_update_sorted', (table0, m0, v0), rows,
                            k, p)
  tr, mr, vr = table0.clone(), m0.clone(), v0.clone()
  ms = _median_ms(lambda: k(tk, mk, vk))
  plain_ms = _median_ms(lambda: p(tr, mr, vr), queued=False)
  st = hbt.SparseOptState(acc=(mk, vk))
  path_ms = _median_ms(lambda: hbt.sparse_adam_apply(
      tk, st, raw_ids, raw_g, stacked, lr, step))
  # Per distinct element about 15 operations (two moments, two bias
  # corrections, a root, the step).
  out['adam_update_sorted'] = dict(
      max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
      path_ms=path_ms, **_bound(list_bytes + 6 * u * d * 4,
                                n * d + 15 * u * d))
  print(f'  adam_update_sorted: max abs err {err:.3e}; kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms; sort+gather+kernel {path_ms:.4f} ms; '
        + _against_bound(out['adam_update_sorted']))

  inputs = dict(rows=rows, g=g, valid=valid, table0=table0, acc0=acc0,
                m0=m0, v0=v0, raw_ids=raw_ids, raw_g=raw_g, stacked=stacked,
                lr=lr, step=step)
  out.update(phase1_gsum(cfg, dev, inputs, out['adagrad_update_sorted']))
  out['adagrad_update_sorted[criteo]'], criteo = phase1_long_runs(
      cfg, dev, inputs)
  out.update(phase1_gather(cfg, dev, inputs))
  out.update(phase1_round(cfg, dev, inputs))
  phase1_edges(cfg, dev, inputs)
  out.update(phase1_bf16(cfg, dev, inputs))
  for name, record in criteo.items():
    out[name]['criteo'] = record
  phase1_edges_bf16(cfg, dev, inputs)
  if tune:
    phase1_tune(cfg, dev, inputs)
  return out


def _at_offset(t, k, dev):
  """A copy of ``t`` on ``dev`` that starts ``k`` floats into its
  storage."""
  flat = torch.empty(t.numel() + k, dtype=t.dtype, device=dev)
  flat[k:].copy_(t.reshape(-1))
  return flat[k:].view(t.shape)


def phase1_edges(cfg: argparse.Namespace, dev: torch.device, inp):
  """Kernels 1 (both modes), 2, 3 and 4 at full width on a list built to
  hit the edges of their tiles (all four cut the list by
  ``scatter.tile_entries``), against the plain versions on the CPU copy
  (which add a run in list order, as the kernels do; atomics on the card
  do not); aligned, with the gradients one float into their storage, and
  with the table and slots one float into theirs."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.ops import scatter
  v, d = inp['table0'].shape
  tile = scatter.tile_entries(d)
  n = 40 * tile + 1                           # one more than whole tiles
  rng = np.random.RandomState(tb.SEED + 7)
  rows = np.sort(rng.randint(0, v, n))
  rows[tile - 3:tile + 3] = rows[tile - 3]    # a run across a boundary
  start = 5 * tile + tile // 2                # a run longer than a tile
  rows[start:start + 3 * tile + 5] = rows[start]
  # 5 tiles of entries on 300 neighbouring rows: one block's slice of
  # kernel 4 spans several chunks.
  start = 20 * tile
  rows[start:start + 5 * tile] = rows[start] + np.sort(
      rng.randint(0, 300, 5 * tile))
  rows[:7], rows[-9:] = -1, v + 2
  assert (np.diff(rows) >= 0).all()
  rows = torch.from_numpy(rows.astype(np.int32))
  g = torch.from_numpy(rng.randn(n, d).astype(np.float32))
  lr, step = tb.TABLE_LR, 3
  state = {k: inp[k].cpu() for k in ('table0', 'acc0', 'm0', 'v0')}
  # name -> (kernel, plain version, state it updates)
  kernels = {
      'adagrad_update_sorted': (
          lambda t, a, r, u: hbt.adagrad_update_sorted(t, a, r, u, lr),
          lambda t, a, r, u: hbt.adagrad_update_sorted_reference(
              t, a, r, u, lr), ('table0', 'acc0')),
      'adagrad_update_sorted[dedup=False]': (
          lambda t, a, r, u: hbt.adagrad_update_sorted(t, a, r, u, lr,
                                                       dedup=False),
          lambda t, a, r, u: hbt.adagrad_update_sorted_reference(
              t, a, r, u, lr, dedup=False), ('table0', 'acc0')),
      'scatter_add_sorted': (hbt.scatter_add_sorted,
                             hbt.scatter_add_sorted_reference, ('table0',)),
      'adam_update_sorted': (
          lambda t, m, vv, r, u: hbt.adam_update_sorted(t, m, vv, r, u, lr,
                                                        step),
          lambda t, m, vv, r, u: hbt.adam_update_sorted_reference(
              t, m, vv, r, u, lr, step), ('table0', 'm0', 'v0')),
  }
  wants = {}
  for name, (_, plain, keys) in kernels.items():
    wants[name] = [state[k].clone() for k in keys]
    plain(*wants[name], rows, g)
  want_sum = hbt.gsum_dense_sorted_reference(rows, g, v)
  untouched = torch.ones(v, dtype=torch.bool)
  untouched[rows[(rows >= 0) & (rows < v)].long()] = False
  errs = collections.defaultdict(float)
  for label, g_shift, state_shift in (
      ('aligned', 0, 0), ('gradients one float into their storage', 1, 0),
      ('table and slots one float into theirs', 0, 1)):
    g_dev, rows_dev = _at_offset(g, g_shift, dev), rows.to(dev)
    for name, (kernel, _, keys) in kernels.items():
      got = [_at_offset(state[k], state_shift, dev) for k in keys]
      kernel(*got, rows_dev, g_dev)
      for key, x, want in zip(keys, got, wants[name]):
        x = x.cpu()
        if not torch.allclose(x, want, rtol=1e-5, atol=1e-5):
          raise AssertionError(f'{name} on the edge list ({label}): {key} '
                               'differs from the plain version')
        if not torch.equal(x[untouched], state[key][untouched]):
          raise AssertionError(f'{name} on the edge list ({label}) changed '
                               f'rows of {key} the list does not hold')
        errs[name] = max(errs[name], float((x - want).abs().max()))
      del got
    if not torch.equal(hbt.gsum_dense_sorted(rows_dev, g_dev, v).cpu(),
                       want_sum):
      raise AssertionError(f'gsum_dense_sorted on the edge list ({label}) '
                           'is not bitwise the plain version')
  print(f'  edge list of {n} rows (40 tiles of {tile} and one entry; a run '
        f'across a tile boundary, a run of {3 * tile + 5}, {5 * tile} entries '
        'on 300 neighbouring rows; aligned, gradients one float into their '
        f'storage, table and slots one float into theirs) on [{v}, {d}], '
        'max abs err against the plain version on the CPU (rtol = atol = '
        '1e-5), untouched rows of every array bitwise: '
        + ', '.join(f'{name} {e:.3e}' for name, e in errs.items())
        + '; gsum_dense_sorted bitwise equal')


def _ulps_apart(got, want):
  """Per element, how many bf16 values lie between two bf16 tensors: the
  sign-magnitude bits mapped onto one integer line."""
  def line(x):
    bits = x.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7fff), bits)
  return (line(got) - line(want)).abs()


def _within_an_ulp(label, got, want, atol=1e-6, share=0.01, moved=None,
                   moved_atol=0.0):
  """Fails unless every element of the bf16 ``got`` is at most 1 bf16 ulp
  from ``want`` or within ``atol`` of it (a result that cancels to near 0
  keeps the f32 order error of its terms, where a bf16 ulp is far
  smaller), or, where the mask ``moved`` is set (an input of the element
  moved by more than its rounding), within ``moved_atol``; and at most
  ``share`` of them differ at all. Returns ``(elements that differ, max
  abs difference)``."""
  got, want = got.cpu(), want.cpu()
  ulps = _ulps_apart(got, want)
  diff = (got.float() - want.float()).abs()
  far = (ulps > 1) & (diff > atol)
  if moved is not None:
    far &= ~(moved & (diff <= moved_atol))
  differ = int((ulps > 0).sum())
  if bool(far.any()) or differ > share * ulps.numel():
    raise AssertionError(
        f'{label}: {int(far.sum())} elements more than 1 bf16 ulp and '
        f'{atol} apart, {differ} of {ulps.numel()} differ (max abs '
        f'{float(diff.max())})')
  return differ, float(diff.max())


def phase1_bf16(cfg: argparse.Namespace, dev: torch.device, inp):
  """The bf16 storage mode of kernels 1 (both modes), 3 and 2 at the
  flagship update list: table, slots and gradients rounded to bf16; each
  kernel against its plain version on the CPU copy (the same f32 math in
  the same order, rounded once: at most 1 bf16 ulp, ``_within_an_ulp``),
  untouched rows bitwise; then timed with its plain version on the card;
  then the split-dense update against the fused one on bf16 state,
  through the entry point, bitwise."""
  import hybridbackend_tpu_torch as hbt
  rows, g, valid = inp['rows'], inp['g'].bfloat16(), inp['valid']
  v, d = inp['table0'].shape
  n, u = rows.shape[0], int(torch.unique(rows[valid]).numel())
  lr, step = inp['lr'], inp['step']
  bf = {k: inp[k].bfloat16() for k in ('table0', 'acc0', 'm0', 'v0')}
  cpu = {k: t.cpu() for k, t in bf.items()}
  rows_c, g_c = rows.cpu(), g.cpu()
  untouched = torch.ones(v, dtype=torch.bool)
  untouched[rows_c[valid.cpu()].long()] = False
  # Bytes: the list (rows, then 2-byte gradients) read once; each distinct
  # row of the table and of each slot (2 bytes an element) read and
  # written once.
  list_bytes = n * 4 + n * d * 2
  raw_g = inp['raw_g'].bfloat16()
  print(f'phase 1, bf16 storage: the flagship list ({n} rows, {u} distinct, '
        f'gradients rounded to bf16) on [{v}, {d}] bf16 table and slots; '
        'each kernel against its plain version on the CPU copy: at most 1 '
        'bf16 ulp an element (or 1e-6 where a result cancels to near 0), '
        'at most 1% of the elements apart, untouched rows bitwise')
  # name -> (wrapper call, plain version, state keys, operations, path);
  # the plain versions run on the CPU copy and on the card, and take lr
  # and step on their state's device.
  def adagrad(dedup):
    return (lambda t, a, r, x: hbt.adagrad_update_sorted(t, a, r, x, lr,
                                                         dedup=dedup),
            lambda t, a, r, x: hbt.adagrad_update_sorted_reference(
                t, a, r, x, lr.to(t.device), dedup=dedup),
            ('table0', 'acc0'),
            n * d * (1 if dedup else 3) + 7 * u * d,
            lambda t, a: hbt.sparse_adagrad_apply(
                t, hbt.SparseOptState(acc=(a,)), inp['raw_ids'], raw_g,
                inp['stacked'], lr, dedup=dedup))
  kernels = {
      'adagrad_update_sorted[bf16]': adagrad(True),
      'adagrad_update_sorted[bf16,dedup=False]': adagrad(False),
      'adam_update_sorted[bf16]': (
          lambda t, m, w, r, x: hbt.adam_update_sorted(t, m, w, r, x, lr,
                                                       step),
          lambda t, m, w, r, x: hbt.adam_update_sorted_reference(
              t, m, w, r, x, lr.to(t.device), step.to(t.device)),
          ('table0', 'm0', 'v0'),
          n * d + 15 * u * d,
          lambda t, m, w: hbt.sparse_adam_apply(
              t, hbt.SparseOptState(acc=(m, w)), inp['raw_ids'], raw_g,
              inp['stacked'], lr, step)),
      'scatter_add_sorted[bf16]': (
          hbt.scatter_add_sorted, hbt.scatter_add_sorted_reference,
          ('table0',), n * d + u * d, None),
  }
  out = {}
  for name, (kernel, plain, keys, ops, path) in kernels.items():
    x = g * -tb.TABLE_LR if name.startswith('scatter') else g
    got = [bf[k].clone() for k in keys]
    kernel(*got, rows, x)
    want = [cpu[k].clone() for k in keys]
    plain(*want, rows_c, x.cpu())
    torch.cuda.synchronize()
    differ, err = 0, 0.0
    for key, a, w in zip(keys, got, want):
      k_differ, k_err = _within_an_ulp(f'{name} {key}', a, w)
      differ, err = differ + k_differ, max(err, k_err)
      if not torch.equal(a.cpu()[untouched], cpu[key][untouched]):
        raise AssertionError(f'{name} changed rows of {key} the list does '
                             'not hold')
    ms = _median_ms(lambda: kernel(*got, rows, x))
    ref = [bf[k].clone() for k in keys]
    plain_ms = _median_ms(lambda: plain(*ref, rows, x), queued=False)
    library_ms = None
    if path is None:
      # index_add_ of the valid entries on the bf16 table, which rounds
      # every add to bf16.
      valid_rows, valid_x = rows[valid].long(), x[valid]
      library_ms = _median_ms(
          lambda: ref[0].index_add_(0, valid_rows, valid_x))
    row = dict(max_abs_err=err, elements_differ=differ, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               **_bound(list_bytes + 2 * len(keys) * u * d * 2, ops))
    extra = ''
    if path is not None:
      row['path_ms'] = _median_ms(lambda: path(*got))
      extra = f'; sort+gather+kernel {row["path_ms"]:.4f} ms'
    else:
      # The entry point, with the launch counts read around it.
      ts = bf['table0'].clone()
      _reset_counts()
      hbt.sparse_sgd_apply(ts, inp['raw_ids'], raw_g, inp['stacked'],
                           tb.TABLE_LR)
      torch.cuda.synchronize()
      _expect('sparse_sgd_apply on a bf16 table', _counts(),
              scatter_add_sorted=1)
      row['launches'] = 1
      _within_an_ulp('sparse_sgd_apply on a bf16 table', ts,
                     hbt.scatter_add_sorted_reference(
                         cpu['table0'].clone(), rows_c, x.cpu()))
      extra = (f'; index_add_ {library_ms:.4f} ms; sparse_sgd_apply 1 '
               'launch a call')
    out[name] = row
    print(f'  {name}: {differ} elements differ from the plain version (max '
          f'abs {err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms'
          f'{extra}; ' + _against_bound(row))

  # The split-dense update against the fused one on bf16 state: the same
  # f32 totals and apply, rounded once; bitwise.
  args = (inp['raw_ids'], raw_g, inp['stacked'], lr)
  fused_t, split_t = bf['table0'].clone(), bf['table0'].clone()
  fused_s = hbt.SparseOptState(acc=(bf['acc0'].clone(),))
  split_s = hbt.SparseOptState(acc=(bf['acc0'].clone(),))
  hbt.sparse_adagrad_apply(fused_t, fused_s, *args)
  hbt.sparse_adagrad_apply(split_t, split_s, *args, split_dense=True)
  torch.cuda.synchronize()
  bitwise = (torch.equal(split_t, fused_t)
             and torch.equal(split_s.acc[0], fused_s.acc[0]))
  if not bitwise:
    raise AssertionError('the bf16 split-dense update differs from the fused '
                         f'one in {int((split_t != fused_t).sum())} table and '
                         f'{int((split_s.acc[0] != fused_s.acc[0]).sum())} '
                         'acc elements')
  split_ms = _median_ms(lambda: hbt.sparse_adagrad_apply(
      split_t, split_s, *args, split_dense=True), iters=10)
  out['adagrad_update_sorted[bf16]']['split_bitwise'] = bitwise
  print(f'  split-dense update vs fused on bf16 state: bitwise equal: '
        f'{bitwise}; update path split {split_ms:.4f} ms, fused '
        f'{out["adagrad_update_sorted[bf16]"]["path_ms"]:.4f} ms')
  return out


def _edge_list(v, d, n_tiles, seed):
  """A sorted list of ``n_tiles`` tiles of ``scatter.tile_entries(d)``
  and one entry on ``[v, d]``: a run across a tile boundary, a run longer
  than a tile, 5 tiles of entries on 300 neighbouring rows, 7 ``-1`` and
  9 ``>= v`` entries; rows and N(0, 1) f32 gradients on the CPU."""
  from hybridbackend_tpu_torch.ops import scatter
  tile = scatter.tile_entries(d)
  n = n_tiles * tile + 1
  rng = np.random.RandomState(seed)
  rows = np.sort(rng.randint(0, v, n))
  rows[tile - 3:tile + 3] = rows[tile - 3]    # a run across a boundary
  start = 5 * tile + tile // 2                # a run longer than a tile
  rows[start:start + 3 * tile + 5] = rows[start]
  start = 20 * tile
  rows[start:start + 5 * tile] = rows[start] + np.sort(
      rng.randint(0, 300, 5 * tile))
  rows[:7], rows[-9:] = -1, v + 2
  assert (np.diff(rows) >= 0).all()
  return (torch.from_numpy(rows.astype(np.int32)),
          torch.from_numpy(rng.randn(n, d).astype(np.float32)), tile)


def phase1_edges_bf16(cfg: argparse.Namespace, dev: torch.device, inp):
  """The bf16 modes of kernels 1 (both modes), 2 and 3 on edge lists
  against the plain versions on the CPU copy: the full-width edge list at
  d = 16 (16-byte rows of 8-byte lanes, gradients staged) aligned, with
  the gradients one bf16 into their storage (8-byte lanes, plain loads)
  and with the table and slots one bf16 into theirs (scalar lanes); an
  edge list at d = 5 (scalar lanes, plain loads); and rows of 8192 bf16,
  whose 16-entry tile is too wide to stage."""
  import hybridbackend_tpu_torch as hbt
  lr, step = tb.TABLE_LR, 3
  kernels = {
      'adagrad_update_sorted[bf16]': (
          lambda t, a, r, x: hbt.adagrad_update_sorted(t, a, r, x, lr), 2),
      'adagrad_update_sorted[bf16,dedup=False]': (
          lambda t, a, r, x: hbt.adagrad_update_sorted(t, a, r, x, lr,
                                                       dedup=False), 2),
      'scatter_add_sorted[bf16]': (hbt.scatter_add_sorted, 1),
      'adam_update_sorted[bf16]': (
          lambda t, m, w, r, x: hbt.adam_update_sorted(t, m, w, r, x, lr,
                                                       step), 3),
  }
  gen = torch.Generator().manual_seed(tb.SEED + 8)
  v, d = inp['table0'].shape
  flagship = {k: inp[k].cpu().bfloat16() for k in ('table0', 'acc0', 'm0',
                                                    'v0')}
  rows, g, tile = _edge_list(v, d, 40, tb.SEED + 7)
  cases = [(f'd = {d} aligned', rows, g.bfloat16(), flagship, 0, 0),
           (f'd = {d}, gradients one bf16 into their storage', rows,
            g.bfloat16(), flagship, 1, 0),
           (f'd = {d}, table and slots one bf16 into theirs', rows,
            g.bfloat16(), flagship, 0, 1)]
  for label, vv, dd in (('d = 5', 100_000, 5),
                        ('rows of 8192, too wide to stage', 64, 8192)):
    if dd == 5:
      r, x, _ = _edge_list(vv, dd, 40, tb.SEED + dd)
    else:
      r = torch.randint(-1, vv + 2, (40,), generator=gen,
                        dtype=torch.int32).sort().values
      x = torch.randn(40, dd, generator=gen)
    state = {'table0': torch.rand(vv, dd, generator=gen) - 0.5,
             'acc0': torch.full((vv, dd), 0.1),
             'm0': torch.randn(vv, dd, generator=gen) * 1e-3,
             'v0': torch.rand(vv, dd, generator=gen) * 1e-4}
    cases.append((label, r, x.bfloat16(), {k: t.bfloat16()
                                           for k, t in state.items()}, 0, 0))
  keys = ('table0', 'acc0', 'm0', 'v0')
  counts = collections.defaultdict(int)
  for label, r, x, state, g_shift, state_shift in cases:
    vv = state['table0'].shape[0]
    untouched = torch.ones(vv, dtype=torch.bool)
    untouched[r[(r >= 0) & (r < vv)].long()] = False
    x_dev, r_dev = _at_offset(x, g_shift, dev), r.to(dev)
    for name, (kernel, arrays) in kernels.items():
      use = (keys[0],) + (keys[1:2] if arrays == 2 else keys[2:4]
                          if arrays == 3 else ())
      got = [_at_offset(state[k], state_shift, dev) for k in use]
      want = [state[k].clone() for k in use]
      kernel(*got, r_dev, x_dev)
      kernel(*want, r, x)
      for key, a, w in zip(use, got, want):
        differ, _ = _within_an_ulp(f'{name} on the edge list ({label}) {key}',
                                   a, w)
        counts[name] += differ
        if not torch.equal(a.cpu()[untouched], state[key][untouched]):
          raise AssertionError(f'{name} on the edge list ({label}) changed '
                               f'rows of {key} the list does not hold')
      del got
  print(f'  bf16 edge lists ({"; ".join(c[0] for c in cases)}; the first '
        f'three of {rows.shape[0]} rows, 40 tiles of {tile} and one entry), '
        'against the plain versions on the CPU, at most 1 bf16 ulp, '
        'untouched rows bitwise; elements that differ over all of them: '
        + ', '.join(f'{name} {c}' for name, c in counts.items()))


def phase1_tune(cfg: argparse.Namespace, dev: torch.device, inp):
  """Kernel 2 over tile sizes, kernel 4 over block and chunk sizes, and
  kernels 1 (both modes) and 3 over tile sizes and state batches, at the
  flagship list, and kernel 4's sweep at phase 36's list too; each sweep
  forth and back."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.ops import scatter
  rows, g = inp['rows'], inp['g']
  v, d = inp['table0'].shape
  table = inp['table0'].clone()
  saved = scatter.TILE_ENTRIES, scatter.TILE_BYTES
  tiles = (64, 128, 256, 512, 1024)
  for tile in tiles + tiles[::-1]:
    scatter.TILE_ENTRIES, scatter.TILE_BYTES = tile, tile * 4 * d
    ms = _median_ms(lambda: hbt.scatter_add_sorted(table, rows, g))
    print(f'  tune scatter_add_sorted: tile {scatter.tile_entries(d)} '
          f'entries: {ms:.4f} ms')
  scatter.TILE_ENTRIES, scatter.TILE_BYTES = saved
  _tune_gsum('the flagship list', rows, g, v, dev)
  _tune_gsum("phase 36's list", *phase36_list(dev), dev)
  _tune_gsum("a dense Trainer table's list", *dense_table_list(dev), dev)
  lr, step = inp['lr'], inp['step']
  acc, m, vv = inp['acc0'].clone(), inp['m0'].clone(), inp['v0'].clone()
  calls = {
      'adagrad_update_sorted': lambda: hbt.adagrad_update_sorted(
          table, acc, rows, g, lr),
      'adagrad_update_sorted[dedup=False]': lambda: hbt.adagrad_update_sorted(
          table, acc, rows, g, lr, dedup=False),
      'adam_update_sorted': lambda: hbt.adam_update_sorted(
          table, m, vv, rows, g, lr, step)}
  saved = (scatter.TILE_ENTRIES, scatter.TILE_BYTES, scatter.STATE_BATCH)
  sweep = [(tile, batch) for tile in (64, 128, 256, 512)
           for batch in (1, 2, 4, 8)]
  for name, call in calls.items():
    for tile, batch in sweep + sweep[::-1]:
      scatter.TILE_ENTRIES, scatter.TILE_BYTES = tile, tile * 4 * d
      scatter.STATE_BATCH = batch
      ms = _median_ms(call)
      print(f'  tune {name}: tile {tile} entries, state batch {batch} '
            f'({_blocks_per_sm(name, d, tile, batch)} blocks per SM): '
            f'{ms:.4f} ms')
  scatter.TILE_ENTRIES, scatter.TILE_BYTES, scatter.STATE_BATCH = saved


def phase1_gsum(cfg: argparse.Namespace, dev: torch.device, inp, fused):
  """Kernel 4 against its plain version, and the split-dense update
  against the fused one, at the flagship update list."""
  import hybridbackend_tpu_torch as hbt
  rows, g, valid = inp['rows'], inp['g'], inp['valid']
  v, d, n = inp['table0'].shape[0], cfg.dim, rows.shape[0]
  got = hbt.gsum_dense_sorted(rows, g, v)
  want = hbt.gsum_dense_sorted_reference(rows, g, v)
  torch.cuda.synchronize()
  err = float((got - want).abs().max())
  if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
    raise AssertionError(f'gsum_dense_sorted differs from the plain '
                         f'version (max abs err {err})')
  touched = torch.zeros(v, dtype=torch.bool, device=dev)
  touched[rows[valid].long()] = True
  if bool(got[~touched].any()):
    raise AssertionError('gsum_dense_sorted: an untouched row is not 0')
  ms = _median_ms(lambda: hbt.gsum_dense_sorted(rows, g, v))
  plain_ms = _median_ms(
      lambda: hbt.gsum_dense_sorted_reference(rows, g, v), queued=False)
  # One PyTorch call: zeros, then index_add_ of the valid entries.
  valid_rows, valid_g = rows[valid].long(), g[valid]
  library_ms = _median_ms(lambda: torch.zeros(v, d, device=dev).index_add_(
      0, valid_rows, valid_g))
  # The list read once, the dense output written once; one add per entry.
  bound = _bound(n * (d + 1) * 4 + v * d * 4, n * d)
  print(f'  gsum_dense_sorted: max abs err {err:.3e} (rtol = atol = 1e-5), '
        f'untouched rows exactly 0; kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, zeros + index_add_ {library_ms:.4f} ms; '
        f'bound {bound["bound_ms"]:.4f} ms ({bound["bytes"] / 1e6:.2f} MB)')

  # The split-dense update against the fused one, through the entry
  # point, on the same list. Both round every operation the same way
  # (explicit rounding in the kernel, one op per pass in torch), so they
  # should agree bit for bit; held to 1e-6.
  args = (inp['raw_ids'], inp['raw_g'], inp['stacked'], inp['lr'])
  fused_t, split_t = inp['table0'].clone(), inp['table0'].clone()
  fused_s = hbt.SparseOptState(acc=(inp['acc0'].clone(),))
  split_s = hbt.SparseOptState(acc=(inp['acc0'].clone(),))
  hbt.sparse_adagrad_apply(fused_t, fused_s, *args)
  hbt.sparse_adagrad_apply(split_t, split_s, *args, split_dense=True)
  torch.cuda.synchronize()
  split_err = max(float((split_t - fused_t).abs().max()),
                  float((split_s.acc[0] - fused_s.acc[0]).abs().max()))
  bitwise = (torch.equal(split_t, fused_t)
             and torch.equal(split_s.acc[0], fused_s.acc[0]))
  if split_err > 1e-6:
    raise AssertionError(f'split-dense update differs from the fused one '
                         f'by {split_err}')
  why = '' if bitwise else (
      f'; {int((split_t != fused_t).sum())} table and '
      f'{int((split_s.acc[0] != fused_s.acc[0]).sum())} acc elements differ '
      'in the last bits')
  torch.cuda.reset_peak_memory_stats(dev)
  base = torch.cuda.memory_allocated(dev)
  split_ms = _median_ms(lambda: hbt.sparse_adagrad_apply(
      split_t, split_s, *args, split_dense=True), iters=10)
  extra = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
  # The least a fused split apply could move: read table, acc and gsum,
  # write table and acc, plus kernel 4's own bytes.
  split_bound = _bound(5 * v * d * 4 + bound['bytes'], n * d + 7 * v * d)
  print(f'  split-dense update vs fused: max abs diff {split_err:.3e}, '
        f'bitwise equal: {bitwise}{why}; update path split '
        f'{split_ms:.4f} ms (bound {split_bound["bound_ms"]:.4f} ms), '
        f'fused {fused["path_ms"]:.4f} ms; split peak {extra:.1f} MiB '
        'above its inputs')
  return {'gsum_dense_sorted': dict(
      max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
      split_path_ms=split_ms, split_bitwise=bitwise, split_max_diff=split_err,
      **bound)}


# Update lists with long runs: a run is hundreds to thousands of entries
# where a column of a few rows takes a zipf(1.5) column's hot ids.


def _sorted_list(raw_ids, d, dev, seed=tb.SEED):
  """``(rows, g)``: int32 ``raw_ids`` sorted stably on ``dev``, and
  N(0, 0.01) gradients drawn from ``seed`` in list order, permuted alike
  (as the sparse update sorts its list)."""
  rows, order = torch.sort(raw_ids.reshape(-1).to(dev), stable=True)
  gen = torch.Generator().manual_seed(seed)
  g = (torch.randn(rows.numel(), d, generator=gen) * 0.01).to(dev)
  return rows, g.index_select(0, order)


def _packed(specs, ids, dev):
  """``ids`` (column name -> int64 numpy ``[B]``) packed onto the one stack
  that ``specs`` make, by the stack's ``pack_ids`` (an id past its column's
  vocabulary becomes -1); returns the int32 ids and the stack's rows."""
  import hybridbackend_tpu_torch as hbt
  (stack,) = hbt.StackedFeatureExtractor(specs, ctx=hbt.Context(dev)).stacks
  packed, _ = hbt.pack_ids(stack, {k: torch.from_numpy(v).to(dev)
                                   for k, v in ids.items()})
  return packed, stack.stacked.vocab_size


def criteo_list(dev):
  """Kernel 1's update list in the Criteo entry point
  (``examples/criteo/train.py --sparse`` at its defaults): one batch of
  ``benchmarks/synthetic.py:criteo_batches(4096, 1, 100000)`` packed onto
  the entry point's [1068750, 16] stack of 26 tables, sorted stably, with
  N(0, 0.01) gradients. A column's first id takes about 1570 of its 4096
  entries. Returns ``(rows, g, vocab)``."""
  from hybridbackend_tpu_torch.examples.criteo import train as criteo
  args = criteo.parse_args(['--sparse'])
  (batch,) = synthetic.criteo_batches(args.batch_size, 1, args.vocab)
  ids, v = _packed(criteo._specs(args),
                   {f'c{c}': batch[f'c{c}'] for c in range(26)}, dev)
  return (*_sorted_list(ids, args.dim, dev), v)


def phase36_list(dev):
  """Phase 36's list, the table gradient's in the module entry point's
  backward: the first batch of the file it synthesizes (4096 rows of the
  26 zipf(1.5) columns of ``examples/criteo/train.py:synthesize``, drawn
  from ``RandomState(0)`` for ``MODULE_BATCHES`` batches) packed onto its
  [1279569, 16] stack and sorted stably, with N(0, 0.01) gradients. Each
  column's five hottest ids take about 1590, 530, 300, 190 and 150
  entries, in neighbouring rows. Returns ``(rows, g, vocab)``."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.examples.criteo import train_module as tm
  args = tm.parse_args([])
  vocabs = tm.vocabs(args)
  rng = np.random.RandomState(0)
  file_rows = MODULE_BATCHES * args.batch_size
  ids = {f'c{c}': (rng.zipf(1.5, file_rows) % v)[:args.batch_size]
         for c, v in enumerate(vocabs)}
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{c}', v, args.dim))
           for c, v in enumerate(vocabs)]
  packed, v = _packed(specs, ids, dev)
  return (*_sorted_list(packed, args.dim, dev), v)


def din_list(dev):
  """Phase 23's DIN update list: the DIN harness's ``--sparse`` batch at
  its defaults packed onto its [1100000, 32] stack, sorted stably, with
  N(0, 0.01) gradients. Returns ``(rows, g, vocab)``."""
  import hybridbackend_tpu_torch as hbt
  args = din.parse_args(['--sparse'])
  (stack,) = din.extractor(args, dev).stacks
  base, ids, _ = din.make_batch(args, dev)
  raw_ids, _ = hbt.pack_ids(stack, {'item': ids, 'user': base['user']})
  return (*_sorted_list(raw_ids, args.dim, dev), stack.stacked.vocab_size)


def flagship_list(cfg, dev):
  """Phase 1's flagship update list: ``(rows, g, vocab)``."""
  ids, grads = _update_list(cfg, 3, np.random.RandomState(tb.SEED))
  rows, order = torch.sort(torch.from_numpy(ids).to(dev), stable=True)
  return (rows, torch.from_numpy(grads).to(dev).index_select(0, order),
          cfg.tables * cfg.vocab)


def _update_state(v, d, dev, dtype=torch.float32):
  """A table of ``default_initializer`` draws and Adagrad's accumulator
  (0.1), LazyAdam's moments as after some steps, in ``dtype``."""
  import hybridbackend_tpu_torch as hbt
  gen = torch.Generator().manual_seed(tb.SEED)
  table = hbt.default_initializer(gen, (v, d))
  m = torch.randn(v, d, generator=gen) * 1e-3
  w = torch.rand(v, d, generator=gen) * 1e-4
  return {k: t.to(dev, dtype) for k, t in (
      ('table', table), ('acc', torch.full_like(table, tb.ADAGRAD_INIT)),
      ('m', m), ('v', w))}


def dense_table_list(dev):
  """One table's list in the dense ``Trainer``'s backward (phases 18 and
  19): the 8192 ids of the harness's column 0 (``tb.make_batch`` at its
  defaults, uniform on [0, 100000)) on its [100000, 16] table, sorted
  stably, with N(0, 0.01) gradients. Returns ``(rows, g, vocab)``."""
  args = tb.parse_args([])
  _, ids = tb.make_batch(args, torch.device('cpu'))
  return (*_sorted_list(ids[:, 0].contiguous(), args.dim, dev), args.vocab)


def long_run_lists(cfg, dev, runs=False):
  """The lists that kernels 1-4 are timed at: the flagship, the Criteo,
  phase 36's, the DIN and a dense ``Trainer`` table's list; with
  ``runs``, lists of equal runs on [n, 16] (one block's rows where the
  run is long: what one block's walk costs an entry) and phase 36's shape
  with no valid entry (kernel 4 writes zeros only) and with uniform
  ids."""
  lists = {'flagship': flagship_list(cfg, dev), 'criteo': criteo_list(dev),
           'phase36': phase36_list(dev), 'din': din_list(dev),
           'dense_table': dense_table_list(dev)}
  if not runs:
    return lists
  for n, run in ((4096, 4096), (65536, 65536), (65536, 256), (65536, 1)):
    raw = torch.arange(n, dtype=torch.int32) // run
    lists[f'runs-{run}-of-{n}'] = (*_sorted_list(raw, 16, dev), n)
  v36 = lists['phase36'][2]
  gen = torch.Generator().manual_seed(tb.SEED)
  for label, raw in (
      ('runs-0-of-phase36', torch.full((106496,), -1, dtype=torch.int32)),
      ('runs-uniform-of-phase36',
       torch.randint(0, v36, (106496,), generator=gen, dtype=torch.int32))):
    lists[label] = (*_sorted_list(raw, 16, dev), v36)
  return lists


def _adagrad_modes(rows, g, lr):
  """Kernel 1's four modes on ``(rows, g)``: name -> ``(call, dedup,
  dtype)``; ``call(table, acc)`` updates in place."""
  import hybridbackend_tpu_torch as hbt
  out = {}
  for suffix, dtype in (('', torch.float32), ('bf16', torch.bfloat16)):
    for dedup in (True, False):
      mode = ','.join(x for x in (suffix, '' if dedup else 'dedup=False')
                      if x)
      name = 'adagrad_update_sorted' + (f'[{mode}]' if mode else '')
      out[name] = (functools.partial(hbt.adagrad_update_sorted, rows=rows,
                                     updates=g.to(dtype), lr=lr, dedup=dedup),
                   dedup, dtype)
  return out


def time_lists(lists, dev):
  """Each list's kernel times, as phase 1 times them: kernel 1 in its four
  modes (at the DIN list f32 only), kernels 2 and 3 on f32 and bf16
  tables with ``index_add_`` of the list's valid entries beside kernel 2
  (on the bf16 table it rounds every add) and, at the Criteo list, their
  plain versions, and kernel 4; ``zeros`` + ``index_add_`` and kernel 4's
  plain version beside it at phase 36's and the dense table's list. Returns ``(shape, ms)`` by list. It calls only
  the wrappers, so that a copy of this file put into an older checkout
  times that checkout's kernels (``--long-runs``)."""
  import hybridbackend_tpu_torch as hbt
  lr = torch.full((), tb.TABLE_LR, device=dev)
  step = torch.full((), 3.0, device=dev)
  shape, times = {}, {}
  for label, (rows, g, v) in lists.items():
    d = g.shape[1]
    state = _update_state(v, d, dev)
    valid = (rows >= 0) & (rows < v)
    runs = torch.unique_consecutive(rows[valid], return_counts=True)[1]
    shape[label] = dict(n=rows.numel(), vocab=v, d=d, distinct=runs.numel(),
                        longest=int(runs.max()) if runs.numel() else 0,
                        over_128=int((runs > 128).sum()))
    t = times[label] = {}
    for name, (call, _, dtype) in _adagrad_modes(rows, g, lr).items():
      if label == 'din' and name != 'adagrad_update_sorted':
        continue
      s = [state['table'].to(dtype), state['acc'].to(dtype)]
      t[name] = _median_ms(lambda: call(*s))
    t['gsum_dense_sorted'] = _median_ms(
        lambda: hbt.gsum_dense_sorted(rows, g, v))
    if label in ('phase36', 'dense_table'):
      valid_rows, valid_g = rows[valid].long(), g[valid]
      t['zeros+index_add_'] = _median_ms(
          lambda: torch.zeros(v, d, device=dev).index_add_(0, valid_rows,
                                                           valid_g))
      t['gsum_dense_sorted_reference'] = _median_ms(
          lambda: hbt.gsum_dense_sorted_reference(rows, g, v), queued=False)
    valid_rows = rows[valid].long()
    for suffix, dtype in (('', torch.float32), ('[bf16]', torch.bfloat16)):
      tk, m, w = (state[k].to(dtype, copy=True) for k in ('table', 'm', 'v'))
      x = g.to(dtype)
      valid_x = x[valid]
      t[f'scatter_add_sorted{suffix}'] = _median_ms(
          lambda: hbt.scatter_add_sorted(tk, rows, x))
      t[f'index_add_{suffix}'] = _median_ms(
          lambda: tk.index_add_(0, valid_rows, valid_x))
      t[f'adam_update_sorted{suffix}'] = _median_ms(
          lambda: hbt.adam_update_sorted(tk, m, w, rows, x, lr, step))
      if label == 'criteo':
        t[f'scatter_add_sorted_reference{suffix}'] = _median_ms(
            lambda: hbt.scatter_add_sorted_reference(tk, rows, x),
            queued=False)
        t[f'adam_update_sorted_reference{suffix}'] = _median_ms(
            lambda: hbt.adam_update_sorted_reference(tk, m, w, rows, x, lr,
                                                     step), queued=False)
  return shape, times


def _hold_bits(label, rows, g, state, call, plain):
  """``call`` on copies of ``state`` on the card against ``plain`` on the
  CPU copies, bit for bit; raises on a difference. Returns the results on
  the card."""
  got = [t.clone() for t in state]
  want = [t.to('cpu', copy=True) for t in state]
  call(*got)
  plain(*want, rows.cpu(), g.cpu().to(state[0].dtype))
  torch.cuda.synchronize()
  for i, (a, w) in enumerate(zip(got, want)):
    if not _bits_equal(a.cpu(), w):
      raise AssertionError(
          f'{label}: operand {i} differs from its CPU version in '
          f'{int((a.cpu() != w).sum())} elements, by '
          f'{float((a.cpu().float() - w.float()).abs().max()):.3e} at most')
  return got


def _hold_adam(label, rows, g, state, lr, step):
  """Kernel 3 on copies of ``state`` (table, m, v) on the card against its
  plain version on the CPU copies: m and v bit for bit (no ``powf`` in
  them), the table within phase 1's 1e-5 in f32 and within one bf16 ulp
  in bf16 (``_within_an_ulp``), where CUDA's ``powf`` and the CPU's
  ``pow`` may differ in ``b ** step``; raises on a difference. Returns
  the table's max abs err."""
  import hybridbackend_tpu_torch as hbt
  got = [t.clone() for t in state]
  want = [t.to('cpu', copy=True) for t in state]
  hbt.adam_update_sorted(*got, rows, g, lr, step)
  hbt.adam_update_sorted_reference(*want, rows.cpu(),
                                   g.cpu().to(state[0].dtype), lr.cpu(),
                                   step.cpu())
  torch.cuda.synchronize()
  for key, a, w in zip(('m', 'v'), got[1:], want[1:]):
    if not _bits_equal(a.cpu(), w):
      raise AssertionError(
          f'{label}: {key} differs from its CPU version in '
          f'{int((a.cpu() != w).sum())} elements')
  t, w = got[0].cpu(), want[0]
  if t.dtype == torch.bfloat16:
    return _within_an_ulp(f'{label}: table', t, w)[1]
  if not torch.allclose(t, w, rtol=1e-5, atol=1e-5):
    raise AssertionError(f'{label}: the table differs from its CPU version '
                         f'by {float((t - w).abs().max()):.3e}')
  return float((t - w).abs().max())


def phase1_long_runs(cfg, dev, inp):
  """Kernels 1-4 on update lists with long runs, and at the flagship
  list, against their plain versions on the CPU copy. At the Criteo list
  (``criteo_list``), at the flagship list and at phase 36's: kernel 1 in
  its four modes (f32 and bf16 tables; dedup and per occurrence) bit for
  bit ``scatter.adagrad_update_sorted_exact`` (the plain version's
  totals, a correctly rounded apply); kernel 2 on f32 and bf16 tables bit
  for bit; kernel 3 on f32 and bf16 state with m and v bit for bit and
  the table within 1e-5 (``_hold_adam``). Kernel 4 at the Criteo list bit
  for bit. Then at the Criteo list kernel 1 (f32, dedup) against its
  plain version on the CPU (the max abs err), timed beside its bound and
  its plain version, and its other modes and kernels 2-4 timed
  (``time_lists``). Returns kernel 1's record at the Criteo list, and
  kernels 2 and 3's there (ms, plain version, bound, kernel 2's
  ``index_add_``) by the name of their flagship rows."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.ops import scatter
  t0 = time.perf_counter()
  lr, step = inp['lr'], inp['step']
  rows, g, v = criteo_list(dev)
  d = g.shape[1]
  state = _update_state(v, d, dev)
  flagship = (inp['rows'], inp['g'], {'table': inp['table0'],
                                      'acc': inp['acc0'], 'm': inp['m0'],
                                      'v': inp['v0']})
  r36, g36, v36 = phase36_list(dev)
  adam_err = 0.0
  for label, (r, x, st) in (('the Criteo list', (rows, g, state)),
                            ('the flagship list', flagship),
                            ("phase 36's list",
                             (r36, g36, _update_state(v36, d, dev)))):
    for name, (call, dedup, dtype) in _adagrad_modes(r, x, lr).items():
      exact = functools.partial(scatter.adagrad_update_sorted_exact,
                                lr=float(lr), dedup=dedup)
      got = _hold_bits(f'{name} at {label}', r, x,
                       [st['table'].to(dtype), st['acc'].to(dtype)], call,
                       exact)
      if name == 'adagrad_update_sorted' and r is rows:
        want = hbt.adagrad_update_sorted_reference(
            *(state[k].to('cpu', copy=True) for k in ('table', 'acc')),
            rows.cpu(), g.cpu(), lr.cpu())
        err = max(float((a.cpu() - w).abs().max())
                  for a, w in zip(got, want))
    for suffix, dtype in (('', torch.float32), ('[bf16]', torch.bfloat16)):
      xd = x.to(dtype)
      _hold_bits(f'scatter_add_sorted{suffix} at {label}', r, xd,
                 [st['table'].to(dtype)],
                 lambda t: hbt.scatter_add_sorted(t, r, xd),
                 hbt.scatter_add_sorted_reference)
      adam_err = max(adam_err, _hold_adam(
          f'adam_update_sorted{suffix} at {label}', r, xd,
          [st[k].to(dtype) for k in ('table', 'm', 'v')], lr, step))
  got = hbt.gsum_dense_sorted(rows, g, v)
  if not _bits_equal(got.cpu(), hbt.gsum_dense_sorted_reference(
      rows.cpu(), g.cpu(), v)):
    raise AssertionError('gsum_dense_sorted at the Criteo list differs from '
                         'the plain version')

  shape, times = time_lists({'criteo': (rows, g, v)}, dev)
  shape, times = shape['criteo'], times['criteo']
  tk, ak = state['table'].clone(), state['acc'].clone()
  plain_ms = _median_ms(lambda: hbt.adagrad_update_sorted_reference(
      tk, ak, rows, g, lr), queued=False)
  n, u = shape['n'], shape['distinct']
  # Phase 1's count: the list read once, each distinct row of the table
  # and the accumulator read and written once; the list's sums, then 7
  # operations per distinct element.
  row = dict(max_abs_err=err, ms=times['adagrad_update_sorted'],
             plain_ms=plain_ms, library_ms=None, other_ms=times,
             **_bound(n * (d + 1) * 4 + 4 * u * d * 4, n * d + 7 * u * d))
  # Kernels 2 and 3 there, counted as phase 1 counts them at the flagship
  # list: the list (rows, then gradients of the storage type) read once,
  # each distinct row of the table and of each slot read and written once.
  criteo = {}
  for suffix, size in (('', 4), ('[bf16]', 2)):
    list_bytes = n * 4 + n * d * size
    criteo[f'scatter_add_sorted{suffix}'] = dict(
        ms=times[f'scatter_add_sorted{suffix}'],
        plain_ms=times[f'scatter_add_sorted_reference{suffix}'],
        library_ms=times[f'index_add_{suffix}'],
        **_bound(list_bytes + 2 * u * d * size, n * d + u * d))
    criteo[f'adam_update_sorted{suffix}'] = dict(
        ms=times[f'adam_update_sorted{suffix}'],
        plain_ms=times[f'adam_update_sorted_reference{suffix}'],
        library_ms=None,
        **_bound(list_bytes + 6 * u * d * size, n * d + 15 * u * d))
  print(f'phase 1, long runs: the Criteo list ({n} rows, {u} distinct, the '
        f'longest run {shape["longest"]}, {shape["over_128"]} runs longer '
        f'than 128, on [{v}, {d}]): kernel 1 in its four modes bit for bit '
        'its totals with a correctly rounded apply there, at the flagship '
        "list and at phase 36's (max abs err "
        f'{err:.3e} from its plain version), kernel 2 (f32, bf16) bitwise '
        'its plain version there, kernel 3 (f32, bf16) with m and v '
        f'bitwise and the table within 1e-5 (max abs err {adam_err:.3e}), '
        'kernel 4 bitwise at the Criteo list; '
        f'kernel 1 {row["ms"]:.4f} ms, plain {plain_ms:.4f} ms; '
        + _against_bound(row) + '; ' + '; '.join(
            f'{name} {_against_bound(m)}' for name, m in criteo.items())
        + '; ' + ', '.join(f'{k} {ms:.4f} ms' for k, ms in times.items())
        + f'; {time.perf_counter() - t0:.1f} s')
  return row, criteo


def _tune_gsum(label, rows, g, v, dev):
  """Kernel 4 at ``(rows, g)`` over block and chunk sizes, forth and
  back."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.ops import scatter
  d = g.shape[1]
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  saved = (scatter.GSUM_BLOCK_BYTES, scatter.GSUM_CHUNK_ENTRIES,
           scatter.TILE_BYTES)
  blocks = (512, 1024, 2048, 4096, 8192)
  try:
    for i, chunk in enumerate((1024, 512, 256, 256, 512, 1024)):
      for block in blocks if i % 2 == 0 else blocks[::-1]:
        scatter.GSUM_BLOCK_BYTES = block * 4 * d
        scatter.GSUM_CHUNK_ENTRIES = chunk
        scatter.TILE_BYTES = chunk * 4 * d
        block_rows, chunk_entries = scatter.gsum_blocking(v, d, sms)
        ms = _median_ms(lambda: hbt.gsum_dense_sorted(rows, g, v))
        print(f'  tune gsum_dense_sorted at {label}: about {block} rows a '
              f'block: {-(-v // block_rows)} blocks of {block_rows} rows on '
              f'{sms} SMs, chunks of {chunk_entries} entries: {ms:.4f} ms')
  finally:
    (scatter.GSUM_BLOCK_BYTES, scatter.GSUM_CHUNK_ENTRIES,
     scatter.TILE_BYTES) = saved


def long_runs_probe(tune: bool) -> int:
  """``--long-runs``: ``time_lists`` at ``long_run_lists``, one JSON line.
  Phase 1 holds the kernels' bits at these lists; this runs nothing else,
  so that a copy of this file put into an older checkout times that
  checkout's kernels in the same call. ``--tune`` adds the lists of equal
  runs, kernel 4's sweep over block and chunk sizes at the flagship,
  phase 36's and the dense table's list, and its ring (twice a chunk) at
  one block's long run over chunk sizes."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.ops import build, scatter
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  dev = torch.device('cuda', 0)
  smi = _run(['nvidia-smi', '--query-gpu=name,power.limit',
              '--format=csv,noheader']).splitlines()[0]
  t0 = time.perf_counter()
  build.load_all()
  built = time.perf_counter() - t0
  lists = long_run_lists(flagship(), dev, runs=tune)
  shape, times = time_lists(lists, dev)
  if tune:
    for label in ('flagship', 'phase36', 'dense_table'):
      _tune_gsum(f'the {label} list', *lists[label], dev)
    saved = scatter.GSUM_CHUNK_ENTRIES, scatter.TILE_BYTES
    try:
      for chunk in (64, 256, 1024, 2048):
        scatter.GSUM_CHUNK_ENTRIES, scatter.TILE_BYTES = chunk, chunk * 64
        for label in ('runs-4096-of-4096', 'runs-65536-of-65536'):
          rows, g, v = lists[label]
          ms = _median_ms(lambda: hbt.gsum_dense_sorted(rows, g, v))
          print(f'  tune gsum_dense_sorted at {label}: chunks of {chunk} '
                f'entries: {ms:.4f} ms')
    finally:
      scatter.GSUM_CHUNK_ENTRIES, scatter.TILE_BYTES = saved
  print(json.dumps({'long_runs': dict(
      card=smi, checkout=HERE, build_s=built, lists=shape, ms=times)}))
  return 0


def phase1_gather(cfg: argparse.Namespace, dev: torch.device, inp):
  """Kernel 5 bitwise against its plain version at the flagship lookup
  (the update list's ids, -1 and >= V among them, into the stacked
  table) and at the TPU kernel's measured shape, [100000, 128] f32 with
  16384 random ids; then once more with the counts read around it."""
  import hybridbackend_tpu_torch as hbt
  gen = torch.Generator().manual_seed(tb.SEED + 5)
  wide = torch.rand(100_000, 128, generator=gen).to(dev)
  wide_ids = torch.randint(0, 100_000, (16384,), generator=gen,
                           dtype=torch.int32).to(dev)
  res = {}
  for label, table, ids in (('flagship lookup', inp['table0'],
                             inp['raw_ids']),
                            ('[100000, 128] x 16384', wide, wide_ids)):
    got = hbt.gather_rows(table, ids)
    if not torch.equal(got, hbt.gather_rows_reference(table, ids)):
      raise AssertionError(f'gather_rows differs from the plain version at '
                           f'the {label}')
    clipped = ids.long().clamp(0, table.shape[0] - 1)
    ms = _median_ms(lambda: hbt.gather_rows(table, ids))
    plain_ms = _median_ms(lambda: hbt.gather_rows_reference(table, ids))
    library_ms = _median_ms(lambda: table.index_select(0, clipped))
    n, d = ids.shape[0], table.shape[1]
    # Ids read once, n rows read and n rows written; no arithmetic.
    bound = _bound(n * 4 + 2 * n * d * table.element_size(), 0)
    print(f'  gather_rows at the {label}: bitwise equal; kernel '
          f'{ms:.4f} ms, plain {plain_ms:.4f} ms, index_select '
          f'{library_ms:.4f} ms; bound {bound["bound_ms"]:.4f} ms '
          f'({bound["bytes"] / 1e6:.2f} MB)')
    res.setdefault('gather_rows', dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound))
  _reset_counts()
  hbt.gather_rows(inp['table0'], inp['raw_ids'])
  torch.cuda.synchronize()
  counts = _counts()
  _expect('gather_rows', counts, gather_rows=1)
  res['gather_rows']['launches'] = counts['gather_rows']
  return res


def phase1_round(cfg: argparse.Namespace, dev: torch.device, inp):
  """Kernel 6 on the flagship gradients, bitwise against its plain
  version for one seed; every output is its input truncated to bf16 or
  one bf16 ulp above that in magnitude. Then once through
  ``stochastic_round_bf16`` with the counts read around it."""
  import hybridbackend_tpu_torch as hbt
  x = inp['raw_g']
  gen = torch.Generator().manual_seed(tb.SEED + 6)
  seed = hbt.draw_seed(torch.Generator().set_state(gen.get_state()))
  got = hbt.stochastic_round_bf16(x, gen)
  want = hbt.stochastic_round_bf16_reference(x, seed)
  nan = torch.isnan(got)
  if not (torch.equal(nan, torch.isnan(want)) and torch.equal(
      got.view(torch.int16)[~nan], want.view(torch.int16)[~nan])):
    raise AssertionError('stochastic_round_bf16 differs from the plain '
                         'version')
  trunc = (x.view(torch.int32) >> 16).to(torch.int16).to(torch.int32)
  up = got.view(torch.int16).to(torch.int32) - trunc
  if not bool(((up == 0) | (up == 1)).all()):
    raise AssertionError('stochastic_round_bf16: an output is neither the '
                         'truncation nor one ulp above it')
  ms = _median_ms(lambda: hbt.stochastic_round_bf16(x, gen))
  # The plain version launches about 250 kernels: one call at a time.
  plain_ms = _median_ms(
      lambda: hbt.stochastic_round_bf16_reference(x, seed), iters=5, per=1)
  n = x.numel()
  # 4 bytes read and 2 written per element; per 8 elements a Philox call
  # of ten rounds (2 products, 2 high products, 4 xors, 2 key adds), and
  # per element an add, a shift and a select of the noise.
  bound = _bound(n * 6, n // 8 * 100 + 3 * n, INT32_OPS_PER_S)
  print(f'  stochastic_round_bf16 on [{", ".join(map(str, x.shape))}]: '
        f'bitwise equal for one seed, {float(up.float().mean()):.4f} of the '
        f'outputs rounded up; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; '
        f'bound {bound["bound_ms"]:.4f} ms ({bound["bytes"] / 1e6:.2f} MB)')
  _reset_counts()
  hbt.stochastic_round_bf16(x, gen)
  torch.cuda.synchronize()
  counts = _counts()
  _expect('stochastic_round_bf16', counts, stochastic_round_bf16=1)
  return {'stochastic_round_bf16': dict(
      max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
      launches=counts['stochastic_round_bf16'], **bound)}


def _close(got, want, rtol, atol_of_max):
  """``allclose`` with ``atol`` a share of the reference's largest value."""
  return torch.allclose(got, want, rtol=rtol,
                        atol=atol_of_max * float(want.abs().max()))


def gpu_vs_cpu(dev: torch.device, label: str, flags=(),
               optimizer: str = 'adagrad', split: bool = False):
  """One full-width step of the flagship config with the harness's
  ``flags`` on the GPU against the same step on the CPU, on the batch
  drawn from seed 1. Returns the GPU state and step, to go on from, and
  the kernel launches of the GPU step."""
  cpu = torch.device('cpu')
  args = flagship(*flags)
  bf16_tables = args.table_dtype == 'bfloat16'
  gstate, gstep = tb.build(args, dev, optimizer, split)
  cstate, cstep = tb.build(args, cpu, optimizer, split)
  batch = {d: tb.shifted(*tb.make_batch(args, d, tb.SEED + 1), args.vocab, 0)
           for d in (dev, cpu)}
  _reset_counts()
  gstate, gm = gstep(gstate, batch[dev])
  torch.cuda.synchronize()
  launches = _counts()
  cstate, cm = cstep(cstate, batch[cpu])
  gloss, closs = float(gm['loss']), float(cm['loss'])
  # The loss comes from one forward pass of the same state: f32 matmul
  # sums in another order on the card, about 1e-6 relative. With bf16
  # matmul operands a layer's f32 output within that order error of a bf16
  # rounding boundary feeds the next layer a value one bf16 ulp (2**-8
  # relative) away; 1e-3 covers a few such values in the mean.
  loss_rtol = 1e-3 if args.bf16 else 1e-4
  if not abs(gloss - closs) <= loss_rtol * abs(closs):
    raise AssertionError(f'{label}: loss {gloss} on the GPU, {closs} on '
                         'the CPU')
  report = {'loss_rel_err': abs(gloss - closs) / abs(closs)}
  (name,) = gstate.tables
  slots = zip(('acc',) if optimizer == 'adagrad' else ('m', 'v'),
              gstate.table_opt[name].acc, cstate.table_opt[name].acc)
  pairs = {'table': (gstate.tables[name], cstate.tables[name]),
           **{k: (g, c) for k, g, c in slots}}
  for key, (g, c) in pairs.items():
    g = g.cpu()
    report[f'{key}_max_abs_err'] = float((g.float() - c.float()).abs().max())
    if bf16_tables:
      # bf16 tables, slots and gradients: the tower's f32 order moves an
      # embedding gradient across a bf16 rounding boundary now and then,
      # which moves a stored value by one bf16 ulp. At most 1 ulp, or
      # where a value cancels to near 0 1e-6 (an f32 order error).
      atol, moved = 1e-6, None
      if optimizer == 'adam' and key == 'table':
        # LazyAdam's first step moves an element by lr*s/(|s|+eps), which
        # moves by up to lr*2**-8/4 = 4.9e-5 when s moves by its own bf16
        # ulp. Where a run's total s cancels, one of its gradients moved
        # by that gradient's ulp moves s by many ulps of s, and the step
        # by up to 2*lr (2.2*lr with the stored value's rounding): allowed
        # only where the first moment m = 0.1*s differs too, so the total
        # itself moved.
        atol, moved = 1e-4, pairs['m'][0].cpu() != pairs['m'][1]
        far = (_ulps_apart(g, c) > 1) & ((g.float() - c.float()).abs() > atol)
        report['table_elems_far_where_m_moved'] = int(far.sum())
      elif optimizer == 'adam':
        # m = 0.1*s and v = 0.001*s^2: a total that cancels keeps the
        # absolute error of the gradient that moved (up to 2**-7 of it);
        # 2**-5 of the largest moment bounds four such moves.
        atol = 2**-5 * float(c.float().abs().max())
      report[f'{key}_elems_differ'], _ = _within_an_ulp(
          f'{label}: {key}', g, c, atol=atol, moved=moved,
          moved_atol=2.2 * tb.TABLE_LR)
      continue
    if optimizer == 'adagrad':
      # Table and acc move by 0.05*g/sqrt(0.1+g^2) and g^2 with g ~ 1e-4,
      # so the gradients' order error stays far below 1e-5.
      ok = torch.allclose(g, c, rtol=1e-5, atol=1e-5)
    elif key == 'table':
      # LazyAdam's first step moves an element by lr*s/(|s|+eps): a
      # gradient s near zero turns an order difference ds into up to
      # lr*ds/eps = 5e6*ds; ds up to 1e-10 gives 5e-4. A wrong row or a
      # wrong sign moves it by 0.05 or more.
      report['table_elems_over_1e-5'] = int(((g - c).abs() > 1e-5).sum())
      ok = torch.allclose(g, c, rtol=0, atol=1e-3)
    else:
      # m = 0.1*s and v = 0.001*s^2 follow the gradients' order error,
      # relative to the largest moment.
      ok = _close(g, c, rtol=1e-3, atol_of_max=1e-4)
    if not ok:
      raise AssertionError(f'{label}: {key} differs: {report}')
  # The tower's gradients, read from Adam's first moment ((1 - b1)*g after
  # one step), follow the f32 order of the two devices: a weight's
  # gradient is a sum over the batch of 8192 terms of either sign, whose
  # order error reaches about n*2**-24 = 5e-4 of the sum of their sizes,
  # so 1e-3 relative plus 1e-3 of the tensor's largest gradient. With
  # bf16 matmul operands a layer's input that sits at a bf16 rounding
  # boundary takes the neighbouring bf16 value on one device (2**-8
  # relative), and sums over the batch carry that: 2**-5 of the largest
  # gradient.
  # Adam's first step moves a weight by lr*g/(|g|+1e-8): a 1e-10
  # difference in g moves it by at most 1e-5, so weights are held to
  # rtol = atol = 1e-4. With f32 tables and matmul operands the gradients
  # agree to about 1e-5 of their largest and that holds every weight.
  # With bf16 tables or operands they agree less well, and where the
  # gradient allowance exceeds |g| the two devices may give g either
  # sign: those weights may move up to 2*lr apart (2.2*lr with rounding),
  # and are counted.
  gparams = dict(gstate.dense.named_parameters())
  cp = dict(cstate.dense.named_parameters())
  group = cstate.dense_opt.param_groups[0]
  g_atol_of_max = 2**-5 if args.bf16 else 1e-3

  def grad(state, p):
    return (state.dense_opt.state[p]['exp_avg'] / (1 - group['betas'][0])
            ).cpu()

  report['tower_max_abs_err'] = max(
      float((gparams[n].detach().cpu() - cp[n].detach()).abs().max())
      for n in cp)
  grad_err, grad_err_param, either_sign_far = -1.0, None, 0
  for n in cp:
    gg, cg = grad(gstate, gparams[n]), grad(cstate, cp[n])
    allowance = 1e-3 * cg.abs() + g_atol_of_max * float(cg.abs().max())
    g_diff = (gg - cg).abs()
    if float(g_diff.max()) / float(cg.abs().max()) > grad_err:
      grad_err = float(g_diff.max()) / float(cg.abs().max())
      grad_err_param = n
    if bool((g_diff > allowance).any()):
      raise AssertionError(f'{label}: tower gradient of {n} differs by up to '
                           f'{float(g_diff.max())}, largest '
                           f'{float(cg.abs().max())}: {report}')
    want = cp[n].detach()
    diff = (gparams[n].detach().cpu() - want).abs()
    bad = diff > 1e-4 + 1e-4 * want.abs()
    if bf16_tables or args.bf16:
      either_sign = cg.abs() <= allowance
      either_sign_far += int((bad & either_sign).sum())
      bad &= ~(either_sign & (diff <= 2.2 * group['lr']))
    if bool(bad.any()):
      i = int(torch.argmax(torch.where(bad, diff, 0).flatten()))
      raise AssertionError(
          f'{label}: tower param {n} differs in {int(bad.sum())} elements, '
          f'by up to {float(diff.flatten()[i])} where the gradient is '
          f'{float(gg.flatten()[i])} on the card and '
          f'{float(cg.flatten()[i])} on the CPU: {report}')
  report['tower_grad_err_of_max'] = grad_err
  report['tower_grad_err_in'] = grad_err_param
  if either_sign_far:
    report['tower_far_where_grad_either_sign'] = either_sign_far
  print(f'{label}: one full-width step, GPU vs CPU: '
        + ', '.join(f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                    for k, v in report.items()))
  return gstate, gstep, launches


def timed(cfg: argparse.Namespace, dev: torch.device, label: str, state,
          step, smi, kernel: str, steps=30):
  """The step timed on the card as the harness times one window: its
  batch, warmup and ids shifted by one a step, ``steps`` steps enqueued
  back to back with CUDA events between consecutive steps. ``kernel``
  must have been launched once per step, and no other counted kernel."""
  batch = functools.partial(tb.shifted, *tb.make_batch(cfg, dev), cfg.vocab)
  state = tb.time_steps(state, step, batch, 0, tb.WARMUP, dev).state
  torch.cuda.reset_peak_memory_stats(dev)
  held = torch.cuda.memory_allocated(dev)

  _reset_counts()
  t0 = time.perf_counter()
  state, losses, step_ms, *_ = tb.time_steps(state, step, batch, tb.WARMUP,
                                             steps, dev)
  wall = time.perf_counter() - t0
  counts = _counts()
  _expect(f'{label}, {steps} steps', counts, **{kernel: steps})
  losses = torch.stack(losses)
  if not bool(torch.isfinite(losses).all()):
    raise AssertionError(f'{label}: non-finite loss: {losses.tolist()}')
  med = statistics.median(step_ms)
  print(f'{label}: on {smi}: median {med:.4f} ms/step (device events, '
        f'{steps} steps; min {min(step_ms):.4f}, max {max(step_ms):.4f}), '
        f'{cfg.batch / med * 1e3:.1f} examples/s; host clock '
        f'{wall / steps * 1e3:.4f} ms/step; peak memory '
        f'{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, of which '
        f'{held / 2**30:.3f} GiB held before the steps (the states of all '
        f'variants so far); loss '
        f'{float(losses[0]):.5f} -> {float(losses[-1]):.5f}')
  return state, counts[kernel]


def _stream_overlap(prof, steps):
  """From the trace's kernel events: the kernel time a step on each CUDA
  stream, and the time a step during which kernels of two or more
  streams ran at once."""
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)['traceEvents']
  spans = collections.defaultdict(list)
  for e in events:
    if e.get('cat') == 'kernel' and 'dur' in e:
      spans[e.get('args', {}).get('stream')].append(
          (e['ts'], e['ts'] + e['dur']))
  edges, busy = [], {}
  for stream, iv in spans.items():
    merged = []
    for a, b in sorted(iv):
      if merged and a <= merged[-1][1]:
        merged[-1][1] = max(merged[-1][1], b)
      else:
        merged.append([a, b])
    busy[stream] = sum(b - a for a, b in merged) / 1e3 / steps
    edges += [(a, 1) for a, _ in merged] + [(b, -1) for _, b in merged]
  active, last, both = 0, 0.0, 0.0
  for t, d in sorted(edges):
    if active >= 2:
      both += t - last
    active, last = active + d, t
  return busy, both / 1e3 / steps


def profile(label: str, state, step, batch, steps=10, overlap=False):
  """Device time per step by kernel class over ``steps`` traced steps,
  step ``i`` on ``batch(100 + i)``, and the device's busy share of the
  traced span; with ``overlap`` also the kernel time a step on each CUDA
  stream and the time in which two streams ran kernels at once."""
  from torch.profiler import ProfilerActivity, profile as tprofile
  torch.cuda.synchronize()
  with tprofile(activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for i in range(steps):
      state, _ = step(state, batch(100 + i))
    torch.cuda.synchronize()
    span_ms = (time.perf_counter() - t0) * 1e3
  classes = collections.Counter()
  counts = collections.Counter()
  for e in prof.key_averages():
    us = getattr(e, 'device_time_total', None)
    if us is None:
      us = e.cuda_time_total
    if us <= 0 or e.device_type.name != 'CUDA':
      continue
    key = e.key
    for pattern, cls in (('gemm', 'GEMM'), ('sgemm', 'GEMM'),
                         ('xmma', 'GEMM'), ('gsum_dense', 'update'),
                         ('sorted_kernel', 'update'),
                         ('gather', 'gather'), ('sort', 'sort'),
                         ('multi_tensor', 'optimizer'),
                         ('reduce', 'reduction'), ('Memcpy', 'copy'),
                         ('Memset', 'copy')):
      if pattern.lower() in key.lower():
        key = f'{cls}: {e.key}' if cls == 'update' else cls
        break
    else:
      key = 'elementwise and other'
    classes[key] += us / 1e3 / steps
    counts[key] += e.count / steps
  device_ms = sum(classes.values())
  print(f'{label} profile: {device_ms:.4f} ms device time per step over '
        f'{steps} steps; traced span {span_ms / steps:.4f} ms/step, device '
        f'busy {100 * device_ms * steps / span_ms:.1f}% of it')
  for key, ms in classes.most_common():
    print(f'  {ms:.4f} ms/step ({100 * ms / device_ms:.1f}%), '
          f'{counts[key]:.1f} ops/step: {key}')
  if overlap:
    busy, both = _stream_overlap(prof, steps)
    print(f'  kernels by CUDA stream, ms/step: '
          + ', '.join(f'stream {s} {ms:.4f}' for s, ms in busy.items())
          + f'; two streams at once {both:.4f} ms/step')


def harness(smi):
  """Phase 16: the port's train-step harness at its defaults with bf16
  tables, as a user runs it, in a process of its own; its JSON line is
  printed. Its Adagrad kernel must have been launched once per timed
  step, and no other counted kernel."""
  ((line, report, _),) = _modules_json(
      [('train_benchmark', ['--sparse', '--table-dtype', 'bfloat16'])])
  want = {name: 0 for name in tb.COUNTED}
  want['adagrad_update_sorted'] = report['timed_steps']
  if report['kernel_launches'] != want or report['card'] != smi:
    raise AssertionError(f'the harness launched {report["kernel_launches"]} '
                         f'on {report["card"]}; expected {want} on {smi}')
  print('phase 16 (python -m hybridbackend_tpu_torch.benchmarks.'
        f'train_benchmark --sparse --table-dtype bfloat16 --json): {line}')


TRAIN_STEPS = 64           # phase 17's training run
SAVE_EVERY = 32            # and its checkpoints
EVAL_SHORT = 1000          # rows of its last, short eval batch
STAT_WINDOW = 16           # steps between StepStatHook's syncs
ADAM_STEPS = 8             # the LazyAdam SparseTrainer's run
LOOP_ROUNDS, LOOP_STEPS = 4, 16   # the loop's timing rounds
SLOW_SOURCE_MS = 4.0       # a source's wait per batch, as a reader's I/O
DENSE_STEPS = 3            # phase 18's GPU-vs-CPU steps
DENSE_TIMED = 33           # and its timed steps (2 windows of 16)


def _flat_state(trainer):
  """``{path: value}`` of a trainer's checkpoint state."""
  out = {}

  def walk(prefix, v):
    if isinstance(v, dict):
      for k, x in v.items():
        walk(f'{prefix}/{k}', x)
    elif isinstance(v, (list, tuple)):
      for i, x in enumerate(v):
        walk(f'{prefix}/{i}', x)
    else:
      out[prefix] = v
  walk('', trainer._checkpoint_state())
  return out


def _bitwise_equal(label, a, b):
  """Fails unless two trainers' states hold the same bits everywhere."""
  fa, fb = _flat_state(a), _flat_state(b)
  if fa.keys() != fb.keys():
    raise AssertionError(f'{label}: state keys differ')
  for key, x in fa.items():
    y = fb[key]
    same = (torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor)
            else x == y)
    if not same:
      diff = (float((x.float() - y.float()).abs().max())
              if isinstance(x, torch.Tensor) else f'{x} vs {y}')
      raise AssertionError(f'{label}: {key} differs (max abs diff {diff})')
  return len(fa)


def _step_alone_ms(trainer, batches, dev):
  """The trainer's own step enqueued back to back with CUDA events
  between steps, on batches placed on the card beforehand: the step
  without the trainer's loop, input path and hooks. The median gap."""
  import hybridbackend_tpu_torch as hbt
  placed = [hbt.put_batch(b, dev) for b in batches]
  torch.cuda.synchronize(dev)
  marks = [torch.cuda.Event(enable_timing=True)]
  marks[0].record()
  for b in placed:
    trainer.state, _ = trainer._step_fn(trainer.state, b)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
  torch.cuda.synchronize(dev)
  return statistics.median(a.elapsed_time(b) for a, b in zip(marks,
                                                             marks[1:]))


def _slow_source(batches, ms):
  """``batches``, each after a wait of ``ms`` that holds no interpreter
  lock, as a reader's file reads and decoding do."""
  for b in batches:
    time.sleep(ms / 1e3)
    yield b


def _train_ms(trainer, batches, dev, prefetch, wait_ms=0.0):
  """ms/step of ``trainer.train`` over ``batches`` on the host clock,
  from an idle card to the end of its last step, with or without the
  ``DeviceIterator``; the source waits ``wait_ms`` before each batch."""
  source = _slow_source(batches, wait_ms) if wait_ms else iter(batches)
  torch.cuda.synchronize(dev)
  t0 = time.perf_counter()
  trainer.train(source, prefetch=prefetch)
  torch.cuda.synchronize(dev)
  return (time.perf_counter() - t0) * 1e3 / len(batches)


def _input_ms(batches, dev, prefetch):
  """ms/batch of the input path alone, no step: the ``DeviceIterator``
  or ``put_batch`` of each batch, from an idle card to the last copy."""
  import hybridbackend_tpu_torch as hbt
  torch.cuda.synchronize(dev)
  t0 = time.perf_counter()
  if prefetch:
    it = hbt.DeviceIterator(iter(batches), dev)
    for _ in it:
      pass
    it.close()
  else:
    for b in batches:
      hbt.put_batch(b, dev)
  torch.cuda.synchronize(dev)
  return (time.perf_counter() - t0) * 1e3 / len(batches)


def phase17_sparse_trainer(cfg, dev, smi, bare_state, bare_step):
  """Phase 17: the flagship DCNv2 + Adagrad as a user trains it, through
  ``SparseTrainer``: 64 steps fed from seeded Criteo-like host batches
  (``benchmarks/synthetic.py``) through ``DeviceIterator``, a
  ``StepStatHook``, checkpoints every 32 steps; then an evaluation of 4
  full batches and one of 1000 rows, held against the CPU's evaluation
  of the same parameters (restored from the step-64 checkpoint); a
  fresh trainer's restore, and a resume from step 32 over the same 32
  batches, both held bit for bit against the live state; a short run of
  ``table_optimizer='adam'``, which must launch the LazyAdam kernel once
  a step; and the loop timed with and without ``DeviceIterator``, from a
  source that waits for nothing and from one that waits. Returns the
  kernel launches of the two trainers' runs, the batches and the trained
  trainer (phase 22 serves it)."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch import metrics as hbm
  cpu = torch.device('cpu')
  kw = dict(vocab=cfg.vocab, tables=cfg.tables,
            dense_features=cfg.dense_features)
  batches = synthetic.criteo_batches(cfg.batch, TRAIN_STEPS, seed=tb.SEED,
                                     **kw)
  evals = (synthetic.criteo_batches(cfg.batch, 4, seed=tb.SEED + 1, **kw)
           + synthetic.criteo_batches(EVAL_SHORT, 1, seed=tb.SEED + 2, **kw))
  labels = np.concatenate([b['label'] for b in evals])
  # The harness's bare step, in this process, just before the trainer.
  batch = functools.partial(tb.shifted, *tb.make_batch(cfg, dev), cfg.vocab)
  bare_ms = statistics.median(
      tb.time_steps(bare_state, bare_step, batch, 1000, 30, dev).gaps)
  with tempfile.TemporaryDirectory() as tmp:
    dir_a, dir_b = os.path.join(tmp, 'a'), os.path.join(tmp, 'b')
    live = tb.sparse_trainer(cfg, dev, dir_a)
    reports = []
    hook = hbt.StepStatHook(batch_size=cfg.batch, every_n_steps=0,
                            sync_every_n=STAT_WINDOW, log=reports.append)
    torch.cuda.synchronize(dev)
    _reset_counts()
    t0 = time.perf_counter()
    metrics = live.train(iter(batches), hooks=[hook], prefetch=True,
                         save_checkpoint_steps=SAVE_EVERY)
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    counts = _counts()
    _expect(f'phase 17, SparseTrainer.train of {TRAIN_STEPS} steps', counts,
            adagrad_update_sorted=TRAIN_STEPS)
    if live.global_step != TRAIN_STEPS or live._ckpt.all_steps() != [
        SAVE_EVERY, TRAIN_STEPS]:
      raise AssertionError(f'phase 17: step {live.global_step}, '
                           f'checkpoints {live._ckpt.all_steps()}')
    if not np.isfinite(metrics['loss']):
      raise AssertionError(f'phase 17: train loss {metrics["loss"]}')
    stalls = hook.input_stall_stats
    synced = [s * 1e3 for s in hook.synced_secs_per_step]

    # Evaluation and prediction on the card, against the CPU.
    # Through the DeviceIterator: its pinned staging on the card is what
    # the CPU's evaluation checks.
    res_gpu = live.evaluate(iter(evals), prefetch=True)
    preds_gpu = torch.cat(list(live.predict(iter(evals),
                                            prefetch=True))).cpu()
    on_cpu = tb.sparse_trainer(cfg, cpu, dir_a)
    if on_cpu.global_step != TRAIN_STEPS:
      raise AssertionError(f'phase 17: the CPU trainer restored step '
                           f'{on_cpu.global_step}')
    res_cpu = on_cpu.evaluate(iter(evals))
    preds_cpu = torch.cat(list(on_cpu.predict(iter(evals))))
    del on_cpu
    limit, near, gap = hbm.auc_limit(preds_gpu, preds_cpu, labels)
    # The loss: per-example BCE of predictions about 1e-6 relative apart
    # (the tower's f32 sums in another order), averaged: 1e-4, as the
    # GPU-vs-CPU step phases hold the loss.
    if not (res_gpu['batches'] == res_cpu['batches'] == len(evals)
            and abs(res_gpu['auc'] - res_cpu['auc']) <= limit
            and abs(res_gpu['loss'] - res_cpu['loss'])
            <= 1e-4 * abs(res_cpu['loss'])
            and np.isfinite(res_gpu['auc'])):
      raise AssertionError(f'phase 17: evaluate on the GPU {res_gpu}, on '
                           f'the CPU {res_cpu}; AUC limit {limit} '
                           f'({near} predictions within {gap:.3e} of a '
                           'threshold)')

    # A fresh trainer restores the live state; a resume from step 32
    # over the same batches reaches it.
    restored = tb.sparse_trainer(cfg, dev, dir_a)
    n_tensors = _bitwise_equal('phase 17, restored at step 64', restored,
                               live)
    del restored
    os.makedirs(dir_b)
    shutil.copy(os.path.join(dir_a, f'checkpoint-{SAVE_EVERY}.pt'), dir_b)
    resumed = tb.sparse_trainer(cfg, dev, dir_b)
    if resumed.global_step != SAVE_EVERY:
      raise AssertionError(f'phase 17: resumed at {resumed.global_step}')
    resumed.train(iter(batches[SAVE_EVERY:]))
    _bitwise_equal('phase 17, resumed from step 32', resumed, live)
    del resumed

  # The LazyAdam tables: kernel 3 once a train step.
  adam = tb.sparse_trainer(cfg, dev, None, table_optimizer='adam')
  torch.cuda.synchronize(dev)
  _reset_counts()
  adam_loss = adam.train(iter(batches[:ADAM_STEPS]))['loss']
  torch.cuda.synchronize(dev)
  adam_counts = _counts()
  _expect(f"phase 17, SparseTrainer(table_optimizer='adam').train of "
          f'{ADAM_STEPS} steps', adam_counts, adam_update_sorted=ADAM_STEPS)
  if adam.global_step != ADAM_STEPS or not np.isfinite(adam_loss):
    raise AssertionError(f'phase 17, LazyAdam: step {adam.global_step}, '
                         f'loss {adam_loss}')
  del adam

  # The loop, timed: the step alone on placed batches, and train() with
  # and without the DeviceIterator from a source that waits for nothing
  # and from one that waits SLOW_SOURCE_MS a batch; and the input paths
  # alone. In rounds, each in the other order than the one before: the
  # host's pace drifts by tens of percent within a process, so one window
  # of each would compare two paces.
  timer = tb.sparse_trainer(cfg, dev, None)
  ways = {
      'placed': lambda part: _step_alone_ms(timer, part, dev),
      'train(prefetch=False)': lambda part: _train_ms(timer, part, dev,
                                                       False),
      'train(prefetch=True)': lambda part: _train_ms(timer, part, dev, True),
      'slow source, train(prefetch=False)': lambda part: _train_ms(
          timer, part, dev, False, SLOW_SOURCE_MS),
      'slow source, train(prefetch=True)': lambda part: _train_ms(
          timer, part, dev, True, SLOW_SOURCE_MS),
      'put_batch alone': lambda part: _input_ms(part, dev, False),
      'DeviceIterator alone': lambda part: _input_ms(part, dev, True),
  }
  loop = {name: [] for name in ways}
  for r in range(LOOP_ROUNDS):
    part = batches[r * LOOP_STEPS:(r + 1) * LOOP_STEPS]
    for name in (list(ways) if r % 2 == 0 else list(reversed(ways))):
      loop[name].append(ways[name](part))
  del timer
  print(f'phase 17 (SparseTrainer, DCNv2 + Adagrad flagship, '
        f'{TRAIN_STEPS} steps of seeded Criteo-like batches through '
        f'DeviceIterator, checkpoints every {SAVE_EVERY}): on {smi}: '
        f'trainer {statistics.median(synced):.4f} ms/step synced '
        f'(StepStatHook windows of {STAT_WINDOW} steps: '
        f'{", ".join(f"{x:.4f}" for x in synced)}; the one with step '
        f'{SAVE_EVERY} holds its checkpoint), {wall_ms:.4f} ms/step wall '
        f'over the run; the harness bare step (time_steps, phase 3 '
        f'state) {bare_ms:.4f} ms/step; kernel 1 launches '
        f'{counts["adagrad_update_sorted"] / TRAIN_STEPS:.0f} per '
        f'step; input stalls {stalls["stalls"]}/{stalls["gets"]} '
        f'(fraction {stalls["stall_fraction"]:.4f}, {stalls["stall_s"]:.4f} '
        f's waited); last train loss {metrics["loss"]:.5f}')
  print(f'  the loop, {LOOP_ROUNDS} rounds of {LOOP_STEPS} steps each way '
        f'(medians; rounds in order; a slow source waits '
        f'{SLOW_SOURCE_MS} ms a batch):')
  for name, v in loop.items():
    unit = 'ms/batch' if 'alone' in name else 'ms/step'
    print(f'    {name}: {statistics.median(v):.4f} {unit} '
          f'({", ".join(f"{x:.4f}" for x in v)})')
  print(f'  evaluate ({len(evals)} batches: 4 of {cfg.batch} and one of '
        f'{EVAL_SHORT} rows): GPU auc {res_gpu["auc"]:.6f} loss '
        f'{res_gpu["loss"]:.6f} batches {res_gpu["batches"]:.0f}; CPU auc '
        f'{res_cpu["auc"]:.6f} loss {res_cpu["loss"]:.6f}; predictions '
        f'{gap:.3e} apart at most, {near} within that of a threshold, so '
        f'AUC limit {limit:.3e}, AUC apart {abs(res_gpu["auc"] - res_cpu["auc"]):.3e}')
  print(f'  restore at step {TRAIN_STEPS} and resume from step '
        f'{SAVE_EVERY}: {n_tensors} state entries bitwise equal to the live '
        f'state')
  print(f"  SparseTrainer(table_optimizer='adam'), {ADAM_STEPS} steps: "
        f'kernel 3 launches {adam_counts["adam_update_sorted"]} '
        f'({adam_counts["adam_update_sorted"] / ADAM_STEPS:.0f} per step), '
        f'last train loss {adam_loss:.5f}')
  for line in reports:
    print(f'  StepStatHook: {line}')
  launches = collections.Counter(counts)
  launches.update(adam_counts)
  return launches, batches, evals, live


def _hold_tower(label, g_net, c_net, g_opt, c_opt, before, v_before, adam,
                report, apart_in, zero_grad=(), flip_share=0.0):
  """One Adam step of the tower on the card (``g_net``, its optimizer
  state ``g_opt``) against the same step on the CPU (``c_net``,
  ``c_opt``), both from the CPU's copies of the weights and first
  moments before it (``before``) and of the second moments
  (``v_before``); ``adam`` is ``(lr, b1, b2, eps)``. ``zero_grad`` names
  the parameters whose true gradient is 0 (see below). Raises where a
  difference exceeds the allowances below; adds to ``report`` and
  ``apart_in``. ``flip_share``: the share of a tensor's gradients that
  may exceed (a)'s allowance, each by at most 2**-5 of the tensor's
  largest (one example's term, which a ReLU gate that the two sides
  round to either side of zero puts into one side only; phase 33's
  batches run through other GEMM shapes on each side); counted in
  ``report['tower_grads_past_allowance']``."""
  lr, b1, b2, eps = adam
  # A parameter whose true gradient is 0 (the score's bias under the
  # attention's weight normalization: the softmax does not see a constant
  # added to every score) has rounding noise for a gradient on both
  # devices, under 2**-20 of the tower's largest gradient: (a) does not
  # apply to it, (b) does, and Adam's step of the noise may take either
  # sign: its weights may lie up to 2.2 * lr apart.
  tower_largest = max(
      (float(((c_opt[cp]['exp_avg'] - b1 * m0) / (1 - b1)).abs().max())
       for cp, (_, m0) in zip(c_net.parameters(), before)), default=0.0)
  # The tower, in two parts. (a) Across the devices: each weight's
  # gradient, read from Adam's first moment (g = (m - b1 * m_before) /
  # (1 - b1), m_before the same on both), is a sum over the batch whose
  # order error reaches about n * 2**-24 = 5e-4 of the sum of its terms'
  # sizes: 1e-3 of itself plus 1e-3 of the tensor's largest gradient, as
  # phase 2 holds it; the second moment then within (1 - b2) times what
  # twice that allowance does to g**2 (a gradient read from m carries
  # m's rounding over 1 - b1 besides), plus 4 of its own ulps. (b) On each
  # device: every weight is Adam's step from the state before it, by
  # that device's own moments, to 2**-22 of the weight and 2**-18 of the
  # step (a few f32 roundings of each). Together they hold every weight:
  # where the devices' gradients differ within (a), the weights differ
  # by what Adam makes of it, which near a zero gradient is up to 2 * lr
  # (lr * g / (|g| + eps) takes either sign); those weights are counted
  # below with their gradients' share of the tensor's largest.
  for (n, gp), cp, (w0, m0), v0 in zip(g_net.named_parameters(),
                                       c_net.parameters(), before,
                                       v_before):
    gs, cs = g_opt[gp], c_opt[cp]
    gm, gv = gs['exp_avg'].cpu(), gs['exp_avg_sq'].cpu()
    cm, cv = cs['exp_avg'], cs['exp_avg_sq']
    gg, cg = ((m - b1 * m0) / (1 - b1) for m in (gm, cm))
    if n in zero_grad:
      noise = max(float(gg.abs().max()), float(cg.abs().max()))
      report['zero_grad_noise_of_largest'] = max(
          report.get('zero_grad_noise_of_largest', 0.0),
          noise / tower_largest)
      if noise > 2**-20 * tower_largest:
        raise AssertionError(f'{label}: net.{n}, whose true gradient is 0, '
                             f'has a gradient of {noise}')
    largest = float(cg.abs().max())
    allowance = 1e-3 * cg.abs() + 1e-3 * largest
    g_diff = (gg - cg).abs()
    if n not in zero_grad:
      report['tower_grad_err_of_max'] = max(
          report['tower_grad_err_of_max'], float(g_diff.max()) / largest)
      past = g_diff > allowance
      if flip_share and int(past.sum()) <= flip_share * past.numel():
        report['tower_grads_past_allowance'] = report.get(
            'tower_grads_past_allowance', 0) + int(past.sum())
        allowance = torch.where(past, 2**-5 * largest, allowance)
      if bool((g_diff > allowance).any()):
        raise AssertionError(f'{label}: the gradient of '
                             f'net.{n} differs by up to '
                             f'{float(g_diff.max())}, largest {largest}')
      v_allow = ((1 - b2) * 2 * allowance * (2 * cg.abs() + 2 * allowance)
                 + 2**-21 * cv)
      v_ratio = float(((gv - cv).abs() / v_allow.clamp(min=1e-38)).max())
      report['tower_v_err_of_allowance'] = max(
          report['tower_v_err_of_allowance'], v_ratio)
      if v_ratio > 1:
        raise AssertionError(f'{label}: the second moment of '
                             f'net.{n} differs by {v_ratio:.3g} times its '
                             'allowance')
    t = float(cs['step'])
    if float(gs['step']) != t:
      raise AssertionError(f'{label}: Adam steps '
                           f'{float(gs["step"])} and {t}')
    for where, w, m, v in (('card', gp.detach().cpu(), gm, gv),
                           ('cpu', cp.detach(), cm, cv)):
      step = (lr / (1 - b1**t) * m.double()
              / (v.double().sqrt() / math.sqrt(1 - b2**t) + eps))
      want = w0.double() - step
      tol = 2**-22 * want.abs() + 2**-18 * step.abs()
      ratio = float(((w.double() - want).abs()
                     / tol.clamp(min=1e-300)).max())
      report[f'tower_adam_err_of_tol_{where}'] = max(
          report[f'tower_adam_err_of_tol_{where}'], ratio)
      if ratio > 1:
        raise AssertionError(f'{label}: net.{n} on the '
                             f'{where} is {ratio:.3g} times its tolerance '
                             "from Adam's step of its own moments")
    diff = (gp.detach().cpu() - cp.detach()).abs()
    if n in zero_grad:
      report['zero_grad_weight_max_abs_err'] = max(
          report.get('zero_grad_weight_max_abs_err', 0.0), float(diff.max()))
      if float(diff.max()) > 2.2 * lr:
        raise AssertionError(f'{label}: net.{n}, whose true gradient is 0, '
                             f'differs by {float(diff.max())}')
      continue
    report['tower_max_abs_err'] = max(report['tower_max_abs_err'],
                                      float(diff.max()))
    apart = diff > 1e-4 + 1e-4 * cp.detach().abs()
    if bool(apart.any()):
      apart_in.add(f'net.{n} at {label}')
      report['tower_weights_over_1e-4_apart'] += int(apart.sum())
      for where, g in (('card', gg), ('cpu', cg)):
        key = f'their_largest_grad_of_max_{where}'
        report[key] = max(report[key],
                          float(g[apart].abs().max()) / largest)


def _cloned(tree):
  """``tree`` (dicts, lists, tuples) with every tensor cloned."""
  if isinstance(tree, dict):
    return {k: _cloned(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_cloned(v) for v in tree)
  return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _hold_dense_steps(label, g_trainer, c_trainer, batches,
                      from_start=False):
  """One ``train`` step of the dense trainers on the card (``g_trainer``)
  and on the CPU (``c_trainer``) for each of ``batches``, each from one
  state: before it the CPU trainer takes the card's state, so that every
  comparison is of one step, as in phase 2; with ``from_start`` the card
  trainer first goes back to its state before the first step (see
  ``PIPE_STEPS``). Holds the loss, the tables, their accumulators and
  the tower (``_hold_tower``); returns the report and the tower weights
  apart."""
  report = {'loss_rel_err': 0.0, 'table_max_abs_err': 0.0,
            'acc_max_abs_err': 0.0, **_tower_report()}
  apart_in = set()
  group = c_trainer.state.optimizer.dense_opt.param_groups[0]
  lr, (b1, b2), eps = group['lr'], group['betas'], group['eps']
  start = _cloned(g_trainer._checkpoint_state()) if from_start else None
  for i in range(len(batches)):
    if from_start:
      g_trainer._load_checkpoint_state(start)
    c_trainer._load_checkpoint_state(g_trainer._checkpoint_state())
    g_state, c_state = g_trainer.state, c_trainer.state
    g_net, c_net = g_state.params['net'], c_state.params['net']
    before = [(p.detach().clone(),
               c_state.optimizer.state[p]['exp_avg'].clone())
              for p in c_net.parameters()]
    v_before = [c_state.optimizer.state[p]['exp_avg_sq'].clone()
                for p in c_net.parameters()]
    gl = g_trainer.train(iter(batches[i:i + 1]))['loss']
    cl = c_trainer.train(iter(batches[i:i + 1]))['loss']
    report['loss_rel_err'] = max(report['loss_rel_err'],
                                 abs(gl - cl) / abs(cl))
    if not abs(gl - cl) <= 1e-4 * abs(cl):
      raise AssertionError(f'{label}, step {i + 1}: loss {gl} on the GPU, '
                           f'{cl} on the CPU')
    # Tables and accumulators: a table row's gradient is a sum over the
    # batch's occurrences of its id, in atomic order on the card
    # (index_add_) and in list order on the CPU: at most n * 2**-24 of the
    # sum of the terms' sizes apart, about 1e-7 of it for the hottest ids.
    # Adagrad moves an element by 0.05 * g / sqrt(acc) with acc >= 0.1, so
    # a gradient's rounding moves it by at most 0.16 times that, and acc
    # by 2 * |g| times it: far below 1e-5.
    g_tables, c_tables = g_state.params['tables'], c_state.params['tables']
    for name, c in c_tables.items():
      ga = g_state.optimizer.state[g_tables[name]]['sum_of_squares'].cpu()
      ca = c_state.optimizer.state[c]['sum_of_squares']
      for key, x, y in (('table', g_tables[name].detach().cpu(), c.detach()),
                        ('acc', ga, ca)):
        err = float((x - y).abs().max())
        report[f'{key}_max_abs_err'] = max(report[f'{key}_max_abs_err'], err)
        if not torch.allclose(x, y, rtol=1e-5, atol=1e-5):
          raise AssertionError(f'{label}, step {i + 1}: {key} of {name} '
                               f'differs by up to {err}')
    _hold_tower(f'{label}, step {i + 1}', g_net, c_net,
                g_state.optimizer.state, c_state.optimizer.state, before,
                v_before, (lr, b1, b2, eps), report, apart_in)
  return report, apart_in


def phase18_dense_trainer(cfg, dev, smi, batches, evals):
  """Phase 18: the dense-gradient ``Trainer`` at the flagship width (26
  tables of [100000, 16], one per column; ``multi_optimizer`` with the
  optax-equivalent Adagrad 0.05 on the tables and Adam 1e-3 on the
  tower, as the JAX harness sets it up): 3 steps on the card, each held
  against the same step on the CPU from the same state (the CPU trainer
  takes the card's state before each), then 33 timed steps and one
  evaluation. Kernel 4 runs once a table a step, each table's gradient
  (``dense_row_totals``). Returns the kernel launches of its runs."""
  import hybridbackend_tpu_torch as hbt
  cpu = torch.device('cpu')
  args = argparse.Namespace(**{**vars(cfg), 'sparse': False})
  g_trainer, c_trainer = (
      hbt.Trainer(*tb.dense_parts(args, d), ctx=hbt.Context(d))
      for d in (dev, cpu))
  launches = collections.Counter()
  _reset_counts()
  report, apart_in = _hold_dense_steps('phase 18', g_trainer, c_trainer,
                                       batches[:DENSE_STEPS])
  torch.cuda.synchronize(dev)
  counts = _counts()
  _expect(f'phase 18, Trainer.train of {DENSE_STEPS} steps', counts,
          gsum_dense_sorted=DENSE_STEPS * cfg.tables)
  launches.update(counts)
  _dense_backward(counts)
  del c_trainer
  # Timed steps, then one evaluation.
  reports = []
  hook = hbt.StepStatHook(batch_size=cfg.batch, every_n_steps=0,
                          sync_every_n=STAT_WINDOW, log=reports.append)
  _reset_counts()
  g_trainer.train(iter(batches[DENSE_STEPS:DENSE_STEPS + DENSE_TIMED]),
                  hooks=[hook], prefetch=True)
  torch.cuda.synchronize(dev)
  counts = _counts()
  _expect(f'phase 18, {DENSE_TIMED} timed steps', counts,
          gsum_dense_sorted=DENSE_TIMED * cfg.tables)
  launches.update(counts)
  _dense_backward(counts)
  synced = [s * 1e3 for s in hook.synced_secs_per_step]
  res = g_trainer.evaluate(iter(evals))
  if not (np.isfinite(res['auc']) and np.isfinite(res['loss'])
          and res['batches'] == len(evals)):
    raise AssertionError(f'phase 18: evaluate gave {res}')
  stalls = hook.input_stall_stats
  print(f'phase 18 (Trainer, dense-gradient DCNv2 flagship, {cfg.tables} '
        f'tables of [{cfg.vocab}, {cfg.dim}] under multi_optimizer(Adagrad 0.05, '
        f'Adam 1e-3)): {DENSE_STEPS} steps GPU vs CPU: '
        + ', '.join(f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                    for k, v in report.items())
        + f' (in {", ".join(sorted(apart_in)) or "none"})')
  print(f'  on {smi}: {statistics.median(synced):.4f} ms/step synced '
        f'(windows of {STAT_WINDOW}: {", ".join(f"{x:.4f}" for x in synced)}), '
        f'{cfg.batch / statistics.median(synced) * 1e3:.1f} examples/s; '
        f'input stalls {stalls["stalls"]}/{stalls["gets"]}; evaluate: auc '
        f'{res["auc"]:.6f} loss {res["loss"]:.6f} batches '
        f'{res["batches"]:.0f}')
  return launches


CRITEO_STEPS = 64          # phase 21's run of the Criteo entry point
# Kernel 1's launches in phase 21's runs of the Criteo entry point, whose
# update lists criteo_list stands for (the kernels line's launches of
# adagrad_update_sorted[criteo]).
CRITEO_ENTRY = collections.Counter()
CRITEO_CHECKED = 2         # its file's steps held GPU against CPU
FILE_ROUNDS, FILE_STEPS = 4, 32   # the trainer's rounds from the file
FILE_ADAM_STEPS = 8        # the LazyAdam trainer's steps from the file


def _tower_report():
  """The tower entries of a GPU-vs-CPU report (``_hold_tower``)."""
  return {'tower_grad_err_of_max': 0.0, 'tower_v_err_of_allowance': 0.0,
          'tower_adam_err_of_tol_card': 0.0,
          'tower_adam_err_of_tol_cpu': 0.0, 'tower_max_abs_err': 0.0,
          'tower_weights_over_1e-4_apart': 0,
          'their_largest_grad_of_max_card': 0.0,
          'their_largest_grad_of_max_cpu': 0.0}


def phase20_e2e(smi, arrow):
  """Phase 20: the port's e2e harness at its defaults (a Parquet file of
  64 batches of 8192 through ``ParquetDataset``, ``DeviceIterator`` and
  the flagship sparse step, 128 timed steps), in one process of its own,
  once with the native reader and then with ``--python-reader``; each
  JSON line is printed. The Adagrad kernel must have been launched once
  a timed step and no other counted kernel, the window must hold at least
  64 fetches, and where phase 0 found Arrow the native reader must have
  served the first run. Returns the kernel launches of both runs."""
  from hybridbackend_tpu_torch.benchmarks import e2e_benchmark as e2e
  launches = collections.Counter()
  flag_sets = ([], ['--python-reader'])
  for flags, (line, report, _) in zip(flag_sets, _modules_json(
      [('e2e_benchmark', flags) for flags in flag_sets])):
    want = {name: 0 for name in tb.COUNTED}
    want['adagrad_update_sorted'] = report['steps']
    reader = 'native' if arrow and not flags else 'python'
    if (report['kernel_launches'] != want
        or report['fetches'] < e2e.MIN_FETCHES
        or report['reader'] != reader
        or report['card'] != smi or not np.isfinite(report['final_loss'])):
      raise AssertionError(f'phase 20: the e2e harness reported {report}; '
                           f'expected launches {want}, at least '
                           f'{e2e.MIN_FETCHES} fetches, the {reader} reader, '
                           f'on {smi}')
    launches.update(report['kernel_launches'])
    print('phase 20 (python -m hybridbackend_tpu_torch.benchmarks.'
          f'e2e_benchmark --json{"".join(" " + f for f in flags)}): {line}')
  return launches


def _rows(batches):
  """The batches' columns, by name, as one [rows, columns] float64 matrix
  (the file's ids and f32 values are exact in f64)."""
  names = sorted(batches[0])
  return np.stack([np.concatenate([np.asarray(b[n], np.float64)
                                   for b in batches]) for n in names], 1)


def _readers_agree(data, batch):
  """The native reader against the Python reader on ``data``, on this
  machine's Arrow: every batch in file order bit for bit (names, dtypes,
  values), and a shuffled epoch of each reader a permutation of the
  file's rows (no row mislabelled, no columns mixed). Returns the batch
  count."""
  import hybridbackend_tpu_torch as hbt

  def read(native, shuffle):
    it = iter(hbt.ParquetDataset(data, batch_size=batch, drop_remainder=True,
                                 shuffle=shuffle, native=native))
    want = 'native' if native else 'python'
    if it.reader != want:
      raise AssertionError(f'phase 21: the {it.reader} reader served '
                           f'{data}, not the {want} one '
                           f'({it.fallback_reason})')
    return list(it)
  native, python = read(True, False), read(False, False)
  if len(native) != len(python):
    raise AssertionError(f'phase 21: {len(native)} native batches, '
                         f'{len(python)} Python batches')
  for i, (a, b) in enumerate(zip(native, python)):
    if sorted(a) != sorted(b) or any(
        a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])
        for k in b):
      raise AssertionError(f'phase 21: batch {i} of {data} differs between '
                           'the native and the Python reader')
  rows = _rows(python)
  want = rows[np.lexsort(rows.T[::-1])]
  for flag in (True, False):
    got = _rows(read(flag, True))
    if not np.array_equal(got[np.lexsort(got.T[::-1])], want):
      raise AssertionError(f'phase 21: a shuffled epoch of the '
                           f'{"native" if flag else "Python"} reader is not '
                           f'a permutation of the rows of {data}')
  return len(native)


def _signal_auc(data):
  """The AUC of the signal ``examples/criteo/train.py``'s synthesis
  planted in ``data``, over the file: exact (by ranks, ties averaged) on
  the signal, and by the trainers' 200-threshold metric on the label's
  probability. No model can beat the first on average."""
  import pyarrow.parquet as pq
  from scipy.stats import rankdata
  import hybridbackend_tpu_torch as hbt
  t = pq.read_table(data)
  signal = np.zeros(t.num_rows)
  for c in range(4):
    signal = signal + (t[f'c{c}'].to_numpy() % 5 == 0) * 0.8
  for d in range(2):
    signal = signal + 0.3 * np.log1p(t[f'i{d}'].to_numpy())
  label = t['label'].to_numpy()
  pos = int((label == 1).sum())
  exact = ((rankdata(signal)[label == 1].sum() - pos * (pos + 1) / 2)
           / (pos * (len(label) - pos)))
  p = 1.0 / (1.0 + np.exp(-(signal - signal.mean())))
  state = hbt.metrics.auc_update(
      hbt.metrics.auc_init(device=torch.device('cpu')),
      torch.from_numpy(label.astype(np.float32)),
      torch.from_numpy(p.astype(np.float32)))
  return float(exact), float(hbt.metrics.auc_result(state))


def _file_train_ms(trainer, dataset, dev, prefetch):
  """ms/step of ``trainer.train`` over ``FILE_STEPS`` batches of
  ``dataset`` on the host clock, from an idle card to the end of the last
  step: the reader's start, its fetches and the input path included."""
  torch.cuda.synchronize(dev)
  t0 = time.perf_counter()
  trainer.train(iter(dataset), max_steps=FILE_STEPS, prefetch=prefetch)
  torch.cuda.synchronize(dev)
  return (time.perf_counter() - t0) * 1e3 / FILE_STEPS


def _hold_sparse_steps(label, g_tr, c_tr, batches, dev,
                       optimizer='adagrad', from_start=False):
  """One step of the sparse trainers' ``_step_fn`` on the card (``g_tr``)
  and on the CPU (``c_tr``) for each of the host ``batches``, each from
  one state: before it the CPU trainer takes the card's state. Holds the
  loss (1e-4 relative), the tables and slots at phase 2's (Adagrad) or
  phase 5's (LazyAdam) tolerances, and the tower by phase 18's rule
  (``_hold_tower``) with every weight within phase 2's 1e-4 (+ 1e-4 of
  itself). With ``from_start`` the card trainer first goes back to its
  state before the first step (see ``PIPE_STEPS``), and a weight may lie
  further apart where its gradient is within its allowance of zero on
  both devices, so that Adam's step may take either sign, by up to 2.2 *
  lr: phase 2's rule for bf16, which f32 meets on other batches than
  phase 2's (2 weights of ``net.cross.w`` 1.6e-4 apart, their gradients
  1.3e-6 of the largest, at ids moved by one in a chip run). Returns the
  report and the tower weights apart."""
  import hybridbackend_tpu_torch as hbt
  cpu = torch.device('cpu')
  report = {'loss_rel_err': 0.0, 'table_max_abs_err': 0.0,
            **({'acc_max_abs_err': 0.0} if optimizer == 'adagrad' else
               {'m_max_abs_err': 0.0, 'v_max_abs_err': 0.0}),
            **_tower_report()}
  apart_in = set()
  group = c_tr.state.dense_opt.param_groups[0]
  adam = (group['lr'], *group['betas'], group['eps'])
  slots = ('acc',) if optimizer == 'adagrad' else ('m', 'v')
  start = _cloned(g_tr._checkpoint_state()) if from_start else None
  for i, b in enumerate(batches):
    step_label = f'{label} {i + 1}'
    if from_start:
      g_tr._load_checkpoint_state(start)
    c_tr._load_checkpoint_state(g_tr._checkpoint_state())
    c_opt = c_tr.state.dense_opt.state
    before = [(p.detach().clone(), c_opt[p]['exp_avg'].clone())
              for p in c_tr.state.dense.parameters()]
    v_before = [c_opt[p]['exp_avg_sq'].clone()
                for p in c_tr.state.dense.parameters()]
    g_tr.state, gm = g_tr._step_fn(g_tr.state, hbt.put_batch(b, dev))
    c_tr.state, cm = c_tr._step_fn(c_tr.state, hbt.put_batch(b, cpu))
    gl, cl = float(gm['loss']), float(cm['loss'])
    report['loss_rel_err'] = max(report['loss_rel_err'],
                                 abs(gl - cl) / abs(cl))
    if not abs(gl - cl) <= 1e-4 * abs(cl):
      raise AssertionError(f'{step_label}: loss {gl} on the GPU, {cl} on '
                           'the CPU')
    for name, table in c_tr.state.tables.items():
      pairs = [('table', g_tr.state.tables[name], table)] + [
          (key, g, c) for key, g, c in zip(
              slots, g_tr.state.table_opt[name].acc,
              c_tr.state.table_opt[name].acc)]
      for key, x, y in pairs:
        x = x.cpu()
        err = float((x - y).abs().max())
        report[f'{key}_max_abs_err'] = max(report[f'{key}_max_abs_err'], err)
        if optimizer == 'adagrad':
          # Adagrad moves an element by 0.05 * g / sqrt(0.1 + g**2), so
          # the gradients' order error stays far below 1e-5 (phase 2).
          ok = torch.allclose(x, y, rtol=1e-5, atol=1e-5)
        elif key == 'table':
          # LazyAdam moves an element by lr*s/(|s|+eps): a total s near
          # zero turns an order difference ds into up to 5e6*ds (phase 5).
          ok = torch.allclose(x, y, rtol=0, atol=1e-3)
        else:
          ok = _close(x, y, rtol=1e-3, atol_of_max=1e-4)
        if not ok:
          raise AssertionError(f'{step_label}: {key} of {name} differs by '
                               f'up to {err}')
    _hold_tower(step_label, g_tr.state.dense, c_tr.state.dense,
                g_tr.state.dense_opt.state, c_opt, before, v_before, adam,
                report, apart_in)
    # And every weight within phase 2's 1e-4 (+ 1e-4 of itself), or with
    # from_start where Adam's step may take either sign.
    either_sign = (max(report['their_largest_grad_of_max_card'],
                       report['their_largest_grad_of_max_cpu']) <= 1e-3
                   and report['tower_max_abs_err'] <= 2.2 * adam[0])
    if report['tower_weights_over_1e-4_apart'] and not (
        from_start and either_sign):
      raise AssertionError(f'{step_label}: tower weights over 1e-4 apart: '
                           f'{report} in {sorted(apart_in)}')
  return report, apart_in


def phase21_criteo(cfg, dev, smi, arrow, tmp):
  """Phase 21: the port's Criteo entry point as a user runs it,
  ``examples/criteo/train.py --sparse --synthesize`` at its defaults (26
  tables of up to [100000, 16], DCNv2 with an MLP of 1024-256-32-1,
  batch 4096), trains 64 steps from the file it writes (the Adagrad
  kernel once a step), evaluates and prints the AUC. Then the file's
  first 2 batches train the entry point's trainer on the card and on the
  CPU, each step from one state (the CPU trainer takes the card's state
  before it): loss, tables, accumulators, tower gradients and weights at
  phase 2's tolerances, and the tower's moments and weights by phase 18's
  rule besides. Then the flagship
  ``SparseTrainer`` trains from phase 20's file through
  ``ParquetDataset`` (shuffled, as the example trains) in alternating
  rounds: its step alone on placed batches, and ``train`` with and
  without ``DeviceIterator`` from each reader; and 8 steps with LazyAdam
  tables (kernel 3 once a step). Returns the kernel launches of its
  runs."""
  import contextlib
  import io
  import re
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.benchmarks import e2e_benchmark as e2e
  from hybridbackend_tpu_torch.examples.criteo import train as criteo
  cpu = torch.device('cpu')
  reader = 'native' if arrow else 'python'
  data = os.path.join(tmp, 'criteo.parquet')
  batch = criteo.parse_args([]).batch_size
  argv = ['--sparse', '--synthesize', '--data', data, '--rows',
          str(CRITEO_STEPS * batch), '--steps', str(CRITEO_STEPS)]
  printed = io.StringIO()
  torch.cuda.synchronize(dev)
  _reset_counts()
  t0 = time.perf_counter()
  with contextlib.redirect_stdout(printed):
    rc = criteo.main(argv)
  torch.cuda.synchronize(dev)
  wall = time.perf_counter() - t0
  counts = _counts()
  printed = printed.getvalue()
  _expect('phase 21, the Criteo entry point', counts,
          adagrad_update_sorted=CRITEO_STEPS)
  CRITEO_ENTRY.update(counts)
  launches = collections.Counter(counts)
  m = re.search(r'epoch 0: loss=(\S+), auc=(\S+), (\S+)s, step (\d+)',
                printed)
  if (rc != 0 or m is None or int(m[4]) != CRITEO_STEPS
      or not 0 < float(m[2]) <= 1 or not np.isfinite(float(m[1]))
      or f'through the {reader} reader' not in printed):
    raise AssertionError(f'phase 21: the Criteo entry point returned {rc} '
                         f'and printed:\n{printed}')
  print(f'phase 21 (python -m hybridbackend_tpu_torch.examples.criteo.train '
        f'{" ".join(argv)}), on {smi}: {wall:.3f} s with the file\'s '
        f'synthesis and the evaluation; kernel 1 launches '
        f'{counts["adagrad_update_sorted"]}; it printed:')
  for line in printed.strip().splitlines():
    print(f'  {line}')

  # Whether the AUC is the model's or the reader's: both readers on this
  # machine's Arrow, the same run through the Python reader, and the
  # ceiling the planted signal sets.
  if arrow:
    agree = (f'{_readers_agree(data, batch)} batches bit for bit in file '
             'order, each shuffled epoch a permutation of the rows')
  else:
    agree = 'not compared: phase 0 found no Arrow C++ for the native reader'
  printed = io.StringIO()
  _reset_counts()
  with contextlib.redirect_stdout(printed):
    rc = criteo.main(['--sparse', '--data', data, '--steps',
                      str(CRITEO_STEPS), '--python-reader'])
  torch.cuda.synchronize(dev)
  counts = _counts()
  printed = printed.getvalue()
  _expect('phase 21, the Criteo entry point through the Python reader',
          counts, adagrad_update_sorted=CRITEO_STEPS)
  CRITEO_ENTRY.update(counts)
  launches.update(counts)
  m_py = re.search(r'epoch 0: loss=(\S+), auc=(\S+), (\S+)s, step (\d+)',
                   printed)
  if (rc != 0 or m_py is None or int(m_py[4]) != CRITEO_STEPS
      or 'through the python reader' not in printed):
    raise AssertionError(f'phase 21: the Criteo entry point with '
                         f'--python-reader returned {rc} and printed:\n'
                         f'{printed}')
  exact, bucketed = _signal_auc(data)
  print(f'  the native and the Python reader on {data}: {agree}; the entry '
        f'point through the Python reader: AUC {m_py[2]} (native '
        f'{m[2]}); the planted signal\'s own AUC over the file: exact '
        f'{exact:.4f}, 200 thresholds on its probability {bucketed:.4f}')

  # The file's first batches, on the card against the CPU.
  args = criteo.parse_args(['--sparse', '--data', data])
  g_tr, c_tr = (criteo.sparse_trainer(args, d) for d in (dev, cpu))
  first = list(hbt.ParquetDataset(data, batch_size=batch,
                                  drop_remainder=True).take(CRITEO_CHECKED))
  _reset_counts()
  report, apart_in = _hold_sparse_steps('phase 21, file step', g_tr, c_tr,
                                        first, dev)
  torch.cuda.synchronize(dev)
  counts = _counts()
  _expect(f'phase 21, {CRITEO_CHECKED} file steps', counts,
          adagrad_update_sorted=CRITEO_CHECKED)
  launches.update(counts)
  del g_tr, c_tr
  print(f'  the entry point\'s trainer, the file\'s first {CRITEO_CHECKED} '
        'batches, GPU vs CPU: '
        + ', '.join(f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                    for k, v in report.items())
        + f' (in {", ".join(sorted(apart_in)) or "none"})')

  # The flagship trainer from phase 20's file, in alternating rounds.
  path = e2e.ensure_file(e2e.FILE_BATCHES * cfg.batch)

  def dataset(native):
    return hbt.ParquetDataset(path, batch_size=cfg.batch,
                              drop_remainder=True, shuffle=True,
                              native=native)
  timer = tb.sparse_trainer(cfg, dev, None)
  host = list(dataset(None).take(FILE_STEPS))
  ways = {'placed': lambda: _step_alone_ms(timer, host, dev)}
  for name, native in ((f'{reader} reader', None), ('Python reader', False)):
    for prefetch in (False, True):
      ways[f'{name}, train(prefetch={prefetch})'] = functools.partial(
          _file_train_ms, timer, dataset(native), dev, prefetch)
  rounds = {name: [] for name in ways}
  _reset_counts()
  for r in range(FILE_ROUNDS):
    for name in (list(ways) if r % 2 == 0 else list(reversed(ways))):
      rounds[name].append(ways[name]())
  torch.cuda.synchronize(dev)
  counts = _counts()
  _expect(f'phase 21, {FILE_ROUNDS} rounds of {FILE_STEPS} steps each way',
          counts, adagrad_update_sorted=FILE_ROUNDS * FILE_STEPS * len(ways))
  launches.update(counts)
  del timer, host
  adam_tr = tb.sparse_trainer(cfg, dev, None, table_optimizer='adam')
  _reset_counts()
  adam_loss = adam_tr.train(iter(dataset(None)),
                            max_steps=FILE_ADAM_STEPS)['loss']
  torch.cuda.synchronize(dev)
  counts = _counts()
  _expect(f"phase 21, SparseTrainer(table_optimizer='adam') from the file, "
          f'{FILE_ADAM_STEPS} steps', counts,
          adam_update_sorted=FILE_ADAM_STEPS)
  if adam_tr.global_step != FILE_ADAM_STEPS or not np.isfinite(adam_loss):
    raise AssertionError(f'phase 21, LazyAdam: step {adam_tr.global_step}, '
                         f'loss {adam_loss}')
  launches.update(counts)
  del adam_tr
  print(f'  the flagship SparseTrainer from {os.path.basename(path)} '
        f'(shuffled), {FILE_ROUNDS} rounds of {FILE_STEPS} steps each way, '
        'ms/step (medians; rounds in order):')
  for name, v in rounds.items():
    print(f'    {name}: {statistics.median(v):.4f} '
          f'({", ".join(f"{x:.4f}" for x in v)})')
  key = f'{reader} reader, train(prefetch='
  wins = sum(t < f for f, t in zip(rounds[key + 'False)'],
                                   rounds[key + 'True)']))
  print(f'  {key}True) won {wins} of {FILE_ROUNDS} rounds against '
        f'{key}False); the trainers default to prefetch='
        f'{inspect.signature(hbt.Trainer.train).parameters["prefetch"].default}')
  print(f"  SparseTrainer(table_optimizer='adam') from the file: kernel 3 "
        f'launches {counts["adam_update_sorted"]} in {FILE_ADAM_STEPS} steps, '
        f'last train loss {adam_loss:.5f}')
  return launches


def harness_dense(smi):
  """Phase 19: the port's harness in its dense mode (no ``--sparse``) at
  its defaults, in a process of its own; its JSON line is printed. It
  launches kernel 4 once a table a timed step (each table's gradient)
  and no other counted kernel."""
  ((line, report, _),) = _modules_json([('train_benchmark', [])])
  want = {name: 0 for name in tb.COUNTED}
  want['gsum_dense_sorted'] = report['timed_steps'] * report['tables']
  if (report['kernel_launches'] != want or report['sparse']
      or report['card'] != smi):
    raise AssertionError(f'the dense harness reported {report}')
  _dense_backward(report['kernel_launches'])
  print('phase 19 (python -m hybridbackend_tpu_torch.benchmarks.'
        f'train_benchmark --json, the dense mode): {line}')


SERVE_SIZES = (1, 128, 8192)   # phase 22's batch sizes
SERVE_CASES = {'f32': 'float32', 'int8': 'int8'}
# kernel 5's launches per predict: one per member lookup, and one more
# per member for the scales of an int8 table.
SERVE_GATHERS = {'f32': 1, 'int8': 2}

# The cold process of phases 22 and 25: it imports the port (which
# registers kernel 5's op), loads each bundle as ``Served`` on the card
# and predicts each batch once, each predict between a reset and a read
# of the kernel counts. argv: the bundles' directory, the batches'
# directory, the cases and the sizes, comma-separated. A case is a
# bundle's path under the bundles' directory; its batches are
# ``batch_<size>.npz`` under the batches' directory, in the case's own
# parent directory (``a/f32`` reads ``a/batch_<size>.npz``).
COLD_SERVE = '''
import json, os, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb
from hybridbackend_tpu_torch.ops import build
report = {'import_s': time.perf_counter() - t0, 'cases': {}}
bundles, data, cases, sizes = sys.argv[1:5]
preds = {}
for case in cases.split(','):
  t0 = time.perf_counter()
  served = hbt.Served(os.path.join(bundles, case))
  torch.cuda.synchronize()
  r = {'load_s': time.perf_counter() - t0, 'predict_s': {}, 'launches': {}}
  for size in sizes.split(','):
    batch = dict(np.load(os.path.join(data, os.path.dirname(case),
                                      f'batch_{size}.npz')))
    for name in tb.COUNTED:
      getattr(hbt, name).launches = 0
    t0 = time.perf_counter()
    preds[f'{case.replace("/", ".")}_{size}'] = served.predict(batch)
    r['predict_s'][size] = time.perf_counter() - t0
    r['launches'][size] = {n: getattr(hbt, n).launches for n in tb.COUNTED}
  report['cases'][case] = r
report['gather_build_s'] = build.load('gather_rows').build_seconds
report['gather_library'] = build.load('gather_rows').path.name
np.savez(os.path.join(data, 'preds.npz'), **preds)
print(json.dumps(report))
'''


def _serving_harness(smi):
  """Phase 22's run of the serving harness at its defaults, in a process
  of its own; its JSON line is printed. Kernel 5 must have run once per
  member lookup of each timed predict."""
  ((line, report, _),) = _modules_json(
      [('serving_benchmark', ['--cases', 'f32', 'int8'])])
  for case, per in SERVE_GATHERS.items():
    got = report[f'flagship_{case}']['gather_launches_per_predict']
    if got != per * report['tables'] or report['card'] != smi:
      raise AssertionError(f'the serving harness reported {got} kernel 5 '
                           f'launches per {case} predict on '
                           f'{report["card"]}; expected '
                           f'{per * report["tables"]} on {smi}')
  print('phase 22 (python -m hybridbackend_tpu_torch.benchmarks.'
        f'serving_benchmark --cases f32 int8 --json): {line}')


def phase22_serving(cfg, dev, smi, trained):
  """Phase 22: the serving path. Phase 17's trained ``SparseTrainer``
  exports an f32 and an int8 bundle with ``poly_batch=True``; a fresh
  process (the cold start) loads each as ``Served`` on the card and
  predicts seeded Criteo-like batches of 1, 128 and 8192 rows, each
  predict between a reset and a read of the kernel counts: kernel 5 once
  per member lookup of an f32 predict and twice (rows and scales) of an
  int8 one, no other counted kernel. The f32 predictions are held within
  1e-6 of the live trainer's ``predict`` (the same lookups, through
  ``index_select`` on the stacked table, and the same tower on the same
  card) and against the same bundle served on the CPU at ``rtol = atol
  = 1e-4`` (phase 2's tolerance of the tower's weights: the tower's f32
  sums in another order); the int8 predictions within 2e-2 of the f32
  ones and not all within 1e-7 (JAX ``tests/test_quant.py:124-126``).
  ``quantize_table`` and ``lookup_quantized`` on the card are held bit
  for bit against the CPU copy at the flagship lookup (the stacked table,
  a batch of 8192 ids of each of the 26 members). Then the serving
  harness runs once. Returns kernel 5's launches in the cold process."""
  import hybridbackend_tpu_torch as hbt
  cpu = torch.device('cpu')
  tables = cfg.tables
  kw = dict(vocab=cfg.vocab, tables=tables,
            dense_features=cfg.dense_features)
  data = {size: synthetic.criteo_batches(size, 1, seed=tb.SEED + 3 + i,
                                         **kw)[0]
          for i, size in enumerate(SERVE_SIZES)}
  with tempfile.TemporaryDirectory() as tmp:
    bundles, batch_dir = (os.path.join(tmp, d) for d in ('bundles', 'data'))
    os.makedirs(batch_dir)
    export_s, bundle_mb = {}, {}
    for case, dtype in SERVE_CASES.items():
      path = os.path.join(bundles, case)
      t0 = time.perf_counter()
      trained.export_saved_model(path, data[SERVE_SIZES[-1]],
                                 table_dtype=dtype, poly_batch=True)
      export_s[case] = time.perf_counter() - t0
      bundle_mb[case] = sum(os.path.getsize(os.path.join(path, f))
                            for f in os.listdir(path)) / 1e6
    for size, batch in data.items():
      np.savez(os.path.join(batch_dir, f'batch_{size}.npz'), **batch)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, '-c', COLD_SERVE, bundles, batch_dir,
         ','.join(SERVE_CASES), ','.join(map(str, SERVE_SIZES))],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    cold_wall_s = time.perf_counter() - t0
    if out.returncode != 0:
      raise RuntimeError(f'phase 22: the cold process failed:\n{out.stderr}')
    cold = json.loads(out.stdout.strip().splitlines()[-1])
    preds = dict(np.load(os.path.join(batch_dir, 'preds.npz')))
    # The same f32 bundle served on the CPU, in this process.
    on_cpu = hbt.Served(os.path.join(bundles, 'f32'), cpu)
    cpu_preds = {size: on_cpu.predict(batch) for size, batch in data.items()}
    del on_cpu
  launches = 0
  for case, per in SERVE_GATHERS.items():
    for size in SERVE_SIZES:
      counts = cold['cases'][case]['launches'][str(size)]
      _expect(f'phase 22, the cold process, {case} predict of {size} rows',
              counts, gather_rows=per * tables)
      launches += counts['gather_rows']
  gaps = {}
  for size, batch in data.items():
    f32, int8 = preds[f'f32_{size}'], preds[f'int8_{size}']
    live = next(trained.predict(iter([batch]))).cpu().numpy()
    if not (f32.shape == int8.shape == (size,) and np.isfinite(f32).all()
            and np.isfinite(int8).all()):
      raise AssertionError(f'phase 22: batch {size} predicted f32 '
                           f'{f32.shape}, int8 {int8.shape}, not all finite')
    gaps[size] = (float(np.abs(f32 - live).max()),
                  float(np.abs(f32 - cpu_preds[size]).max()),
                  float(np.abs(int8 - f32).max()))
    if gaps[size][0] > 1e-6:
      raise AssertionError(f'phase 22: the f32 bundle served {size} rows '
                           f'{gaps[size][0]:.3e} from the trainer')
    if not np.allclose(f32, cpu_preds[size], rtol=1e-4, atol=1e-4):
      raise AssertionError(f'phase 22: the f32 bundle on the card is '
                           f'{gaps[size][1]:.3e} from the CPU at {size} rows')
    if gaps[size][2] > 2e-2:
      raise AssertionError(f'phase 22: int8 {gaps[size][2]:.3e} from f32 at '
                           f'{size} rows')
  if all(gaps[size][2] <= 1e-7 for size in SERVE_SIZES):
    raise AssertionError('phase 22: the int8 predictions equal the f32 ones')

  # The quantized lookup on the card against the CPU copy, at the
  # flagship lookup: the stacked table and a batch's packed ids.
  (stack,) = trained._fx.stacks
  table = trained.state.tables[stack.stacked.name]
  ids, _ = hbt.pack_ids(stack, {f'c{t}': torch.from_numpy(
      data[SERVE_SIZES[-1]][f'c{t}']).to(dev) for t in range(tables)})
  qt = hbt.quantize_table(table)
  qt_cpu = hbt.quantize_table(table.cpu())
  if not (torch.equal(qt.q.cpu(), qt_cpu.q)
          and torch.equal(qt.scale.cpu(), qt_cpu.scale)):
    raise AssertionError('phase 22: quantize_table differs on the card')
  _reset_counts()
  got = hbt.lookup_quantized(qt, ids, stack.stacked)
  torch.cuda.synchronize(dev)
  _expect('phase 22, lookup_quantized', _counts(), gather_rows=2)
  if not torch.equal(got.cpu(), hbt.lookup_quantized(qt_cpu, ids.cpu(),
                                                     stack.stacked)):
    raise AssertionError('phase 22: lookup_quantized on the card differs '
                         'from the CPU')
  lookup_ms = _median_ms(lambda: hbt.lookup_quantized(qt, ids,
                                                      stack.stacked))
  print(f'phase 22 (serving: phase 17\'s trainer exported with '
        f'poly_batch=True, served by a cold process on {smi}): export '
        + ', '.join(f'{c} {export_s[c]:.3f} s ({bundle_mb[c]:.2f} MB)'
                    for c in SERVE_CASES)
        + f'; the cold process {cold_wall_s:.3f} s wall, import '
        f'{cold["import_s"]:.3f} s, kernel 5 library '
        f'{cold["gather_library"]} built in {cold["gather_build_s"]:.3f} s '
        '(0: found in _build/)')
  for case in SERVE_CASES:
    r = cold['cases'][case]
    print(f'  {case}: Served() {r["load_s"]:.4f} s; first predict '
          + ', '.join(f'{s} rows {r["predict_s"][str(s)]:.4f} s'
                      for s in SERVE_SIZES)
          + f'; kernel 5 launches per predict '
          f'{r["launches"][str(SERVE_SIZES[0])]["gather_rows"]}')
  for size in SERVE_SIZES:
    print(f'  {size} rows: f32 from the trainer {gaps[size][0]:.3e} (limit '
          f'1e-6), card from CPU {gaps[size][1]:.3e} (rtol = atol = 1e-4), '
          f'int8 from f32 {gaps[size][2]:.3e} (limit 2e-2)')
  print(f'  quantize_table and lookup_quantized (the [{table.shape[0]}, '
        f'{table.shape[1]}] stacked table, {ids.numel()} ids) on the card '
        f'bitwise equal to the CPU; lookup_quantized {lookup_ms:.4f} ms')
  _serving_harness(smi)
  return launches


DIN_SESSIONS = 4            # the sessions of phases 23 and 24
DIN_STEPS = 3               # phase 23's GPU-vs-CPU steps of each variant
DIN_PLANTED = 256           # rows whose candidate phase 23 repeats
# Phase 23's variants: label -> (the harness's flags, the attention's
# weight normalization).
DIN_VARIANTS = {
    'plain': ([], False),
    f'sessions (S = {DIN_SESSIONS})': (['--sessions', str(DIN_SESSIONS)],
                                       False),
    'weight_normalization=True': ([], True),
}
TAOBAO_STEPS = 64           # phase 25's run of the Taobao entry point
TAOBAO_SAVE = 32            # and the checkpoints of its resume check
TAOBAO_SIZES = (1, 128, 512)   # phase 25's served batch sizes
# kernel 5's launches per DIN predict: one per member (item, user), and
# one more per member for the scales of an int8 table.
DIN_SERVE_GATHERS = {'f32': 2, 'int8': 4}


def phase23_din_kernel(dev: torch.device):
  """Kernel 1 at the DIN step's update list: the DIN harness's ``--sparse``
  batch at its defaults (``cand_hist`` [2048, 65] and ``user`` [2048])
  packed onto the [1100000, 32] stack, 135168 occurrences, with N(0, 0.01)
  gradients; held against its plain version on the card (phase 1's
  ``_hold``) and timed as phase 1 times the flagship list."""
  import hybridbackend_tpu_torch as hbt
  args = din.parse_args(['--sparse'])
  (stack,) = din.extractor(args, dev).stacks
  base, ids, _ = din.make_batch(args, dev)
  raw_ids, _ = hbt.pack_ids(stack, {'item': ids, 'user': base['user']})
  raw_ids = raw_ids.reshape(-1)
  rows, order = torch.sort(raw_ids, stable=True)
  n, d, v = rows.numel(), args.dim, stack.stacked.vocab_size
  gen = torch.Generator().manual_seed(tb.SEED)
  raw_g = (torch.randn(n, d, generator=gen) * 0.01).to(dev)
  g = raw_g.index_select(0, order)
  table0 = hbt.default_initializer(gen, (v, d)).to(dev)
  acc0 = torch.full_like(table0, tb.ADAGRAD_INIT)
  lr = torch.full((), tb.TABLE_LR, device=dev)
  u = int(torch.unique(rows[(rows >= 0) & (rows < v)]).numel())
  name = 'adagrad_update_sorted[din]'
  k = functools.partial(hbt.adagrad_update_sorted, rows=rows, updates=g,
                        lr=lr)
  p = functools.partial(hbt.adagrad_update_sorted_reference, rows=rows,
                        updates=g, lr=lr)
  err, (tk, ak) = _hold(name, (table0, acc0), rows, k, p)
  tr, ar = table0.clone(), acc0.clone()
  ms = _median_ms(lambda: k(tk, ak))
  plain_ms = _median_ms(lambda: p(tr, ar), queued=False)
  st = hbt.init_adagrad_state(tk)
  path_ms = _median_ms(lambda: hbt.sparse_adagrad_apply(
      tk, st, raw_ids, raw_g, stack.stacked, lr))
  # Phase 1's count: the list read once, each distinct row of the table
  # and the accumulator read and written once; the list's sums, then 7
  # operations per distinct element.
  row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
             path_ms=path_ms, launches=1,
             **_bound(n * (d + 1) * 4 + 4 * u * d * 4, n * d + 7 * u * d))
  print(f'phase 23: kernel 1 at the DIN update list ({n} rows, {u} '
        f'distinct, on [{v}, {d}]): max abs err {err:.3e}; kernel '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms; sort+gather+kernel '
        f'{path_ms:.4f} ms; ' + _against_bound(row))
  return row


def _din_batch(args, seed):
  """Phase 23's batch: the harness's draws from ``seed`` on the CPU, the
  candidate repeated as the first history id (a valid position in both
  layouts) of the first ``DIN_PLANTED`` rows. Returns the harness's
  ``(base, ids, valid)`` and the ids that the sessions layout's ``-1``
  holes replaced (the same draws without ``--sparse``)."""
  cpu = torch.device('cpu')
  base, ids, _ = din.make_batch(args, cpu, seed)
  ids[:DIN_PLANTED, 1] = ids[:DIN_PLANTED, 0]
  dense = argparse.Namespace(**{**vars(args), 'sparse': False})
  holed = din.make_batch(dense, cpu, seed)[1][ids < 0]
  return (base, ids, (ids >= 0).to(torch.int32)), holed


def _run_totals(trainer, batch):
  """The CPU trainer's per-occurrence embedding gradients of ``batch``
  from its current state (the step's backward, without the update), and
  the packed ids: ``(ids [n], grads [n, d])`` of its one stack."""
  from hybridbackend_tpu_torch.training.sparse_step import loss_from_raw
  fx = trainer._fx
  raw, ids, layouts = fx.lookup_raw(trainer.state.tables, batch)
  ((name, emb),) = raw.items()
  emb = emb.detach().requires_grad_()
  loss, _ = loss_from_raw(fx, None, trainer._raw_model_loss)(
      trainer.state.dense, {name: emb}, layouts, batch)
  loss.backward()
  trainer.state.dense.zero_grad(set_to_none=True)
  return ids[name].reshape(-1), emb.grad.reshape(-1, emb.shape[-1])


def _check_run_totals(label, planted, ids, grads, t0, a0, t1):
  """Each planted row moved by Adagrad's step of its exact run total: the
  sum, in f64, of every occurrence's gradient (the candidate and its
  repeat in the history, and any other); ``t1 - t0`` within one f32 ulp of
  ``t1`` plus 1e-4 of the step. Returns the share of the checked elements
  that a total without the row's last occurrence would have put outside
  that bound (how sharp the check is)."""
  lr = tb.TABLE_LR
  ids64, g64 = ids.long(), grads.double()
  far, checked = 0, 0
  for r in planted.tolist():
    occ = (ids64 == r).nonzero().reshape(-1)
    if occ.numel() < 2:
      raise AssertionError(f'{label}: row {r} occurs {occ.numel()} times')
    total = g64[occ].sum(0)
    a = a0[r].double()

    def step(s):
      return -lr * s / (torch.sqrt(a + s * s) + 1e-7)
    want = step(total)
    got = t1[r].double() - t0[r].double()
    bound = (torch.finfo(torch.float32).eps * t1[r].double().abs()
             + 1e-4 * want.abs())
    if bool(((got - want).abs() > bound).any()):
      raise AssertionError(f'{label}: row {r} moved by {got.tolist()}, '
                           f'its run total gives {want.tolist()}')
    dropped = step(total - g64[occ[-1]])
    far += int(((dropped - want).abs() > bound).sum())
    checked += want.numel()
  return far / checked


def phase23_din_step(dev: torch.device, smi: str):
  """Phase 23: the DIN sparse step at full width (the DIN harness's
  ``--sparse`` config: item [1000000, 32] and user [100000, 32] in one
  stack, batch 2048, history 64, DNN 256-128-64, attention 80-40) through
  ``SparseTrainer`` in raw mode, on the card against the CPU, from the
  same weights (seed 0): plain, sessions (S = 4, ``-1`` holes) and with
  the attention's weight normalization, 3 steps each, each step from one
  state (the CPU trainer takes the card's state before it). Held: the loss
  to 1e-5 relative; tables and accumulators to ``rtol = atol = 1e-5``;
  the tower by phase 18's rule (``_hold_tower``; under weight
  normalization the score's bias, whose true gradient is 0, by its rule
  for such a weight) and every weight within 1e-4 (+ 1e-4 of itself)
  except where its gradient's sign is not settled (under 2e-3 of the
  tensor's largest on both devices); kernel 1 once a
  step; rows that no valid id reads, among them every row a ``-1`` hole
  replaced, bitwise unchanged; each planted candidate's row moved by its
  exact run total (``_check_run_totals``). Returns kernel 1's row at the
  DIN list and the kernel launches of the steps."""
  import hybridbackend_tpu_torch as hbt
  cpu = torch.device('cpu')
  row = phase23_din_kernel(dev)
  launches = collections.Counter()
  for label, (flags, normalize) in DIN_VARIANTS.items():
    label = f'phase 23 (DIN --sparse, {label})'
    args = din.parse_args(['--sparse', *flags])
    g_tr, c_tr = (din.sparse_trainer(args, d, normalize=normalize)
                  for d in (dev, cpu))
    (base, ids, valid), holed = _din_batch(args, tb.SEED + 1)
    (name,) = c_tr.state.tables
    # The score's bias: with weight normalization its true gradient is 0.
    zero_grad = ({f'attention.mlp.layers.{len(din.ATT)}.b'} if normalize
                 else ())
    report = {'loss_rel_err': 0.0, 'table_max_abs_err': 0.0,
              'acc_max_abs_err': 0.0, **_tower_report()}
    apart_in, sharp = set(), []
    group = c_tr.state.dense_opt.param_groups[0]
    adam = (group['lr'], *group['betas'], group['eps'])
    for i in range(DIN_STEPS):
      step_label = f'{label}, step {i + 1}'
      c_tr._load_checkpoint_state(g_tr._checkpoint_state())
      c_opt = c_tr.state.dense_opt.state
      before = [(p.detach().clone(), c_opt[p]['exp_avg'].clone())
                for p in c_tr.state.dense.parameters()]
      v_before = [c_opt[p]['exp_avg_sq'].clone()
                  for p in c_tr.state.dense.parameters()]
      t0 = c_tr.state.tables[name].clone()
      a0 = c_tr.state.table_opt[name].acc[0].clone()
      cb = din.shifted(args, base, ids, valid, i)
      occ_ids, occ_grads = _run_totals(c_tr, cb)
      _reset_counts()
      g_tr.state, gm = g_tr._step_fn(g_tr.state, hbt.put_batch(cb, dev))
      torch.cuda.synchronize(dev)
      counts = _counts()
      _expect(step_label, counts, adagrad_update_sorted=1)
      launches.update(counts)
      c_tr.state, cm = c_tr._step_fn(c_tr.state, cb)
      gl, cl = float(gm['loss']), float(cm['loss'])
      report['loss_rel_err'] = max(report['loss_rel_err'],
                                   abs(gl - cl) / abs(cl))
      if not abs(gl - cl) <= 1e-5 * abs(cl):
        raise AssertionError(f'{step_label}: loss {gl} on the GPU, {cl} on '
                             'the CPU')
      t1 = g_tr.state.tables[name].cpu()
      pairs = (('table', t1, c_tr.state.tables[name]),
               ('acc', g_tr.state.table_opt[name].acc[0].cpu(),
                c_tr.state.table_opt[name].acc[0]))
      for key, x, y in pairs:
        err = float((x - y).abs().max())
        report[f'{key}_max_abs_err'] = max(report[f'{key}_max_abs_err'], err)
        if not torch.allclose(x, y, rtol=1e-5, atol=1e-5):
          raise AssertionError(f'{step_label}: {key} differs by up to {err}')
      read = torch.zeros(t0.shape[0], dtype=torch.bool)
      read[occ_ids[occ_ids >= 0].long()] = True
      if not torch.equal(t1[~read], t0[~read]):
        raise AssertionError(f'{step_label}: a row no valid id reads moved')
      hole_rows = (holed + i) % args.vocab
      hole_rows = hole_rows[~read[hole_rows.long()]].long()
      if not torch.equal(t1[hole_rows], t0[hole_rows]):
        raise AssertionError(f'{step_label}: a row behind a -1 hole moved')
      planted = torch.unique(occ_ids.reshape(args.batch, -1)[:DIN_PLANTED, 0])
      sharp.append(_check_run_totals(step_label, planted, occ_ids, occ_grads,
                                     t0, a0, t1))
      _hold_tower(step_label, g_tr.state.dense, c_tr.state.dense,
                  g_tr.state.dense_opt.state, c_opt, before, v_before, adam,
                  report, apart_in, zero_grad)
      unsettled = max(report['their_largest_grad_of_max_card'],
                      report['their_largest_grad_of_max_cpu'])
      if report['tower_weights_over_1e-4_apart'] and unsettled > 2e-3:
        raise AssertionError(f'{step_label}: tower weights over 1e-4 apart '
                             f'where the gradient is settled: {report} in '
                             f'{sorted(apart_in)}')
    del g_tr, c_tr
    print(f'{label}, {DIN_STEPS} full-width steps GPU vs CPU on {smi}: '
          + ', '.join(f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                      for k, v in report.items())
          + f' (in {", ".join(sorted(apart_in)) or "none"}); -1 holes '
          f'{int((ids < 0).sum())} a step, {holed.numel()} ids behind them, '
          f'their rows unchanged; {DIN_PLANTED} planted candidates moved by '
          'their exact run totals (a total short of one occurrence falls '
          f'outside the bound in {min(sharp):.3f}-{max(sharp):.3f} of their '
          'elements)')
  return row, launches


def phase24_din_harness(smi: str):
  """Phase 24: the DIN harness at its defaults, as a user runs it, in one
  process of its own: dense, ``--sparse`` and ``--sparse --sessions 4``;
  each JSON line printed. Kernel 1 once a timed step in the sparse
  modes; in the dense one kernel 4 twice a timed step (the gradients of
  the item and the user table). Returns their launches."""
  launches = collections.Counter()
  flag_sets = ([], ['--sparse'], ['--sparse', '--sessions',
                                   str(DIN_SESSIONS)])
  for flags, (line, report, _) in zip(flag_sets, _modules_json(
      [('din_benchmark', flags) for flags in flag_sets])):
    want = {name: 0 for name in tb.COUNTED}
    if '--sparse' in flags:
      want['adagrad_update_sorted'] = report['timed_steps']
    else:
      want['gsum_dense_sorted'] = 2 * report['timed_steps']
      _dense_backward(report['kernel_launches'])
    if (report['kernel_launches'] != want or report['card'] != smi
        or not np.isfinite(report['final_loss'])):
      raise AssertionError(f'phase 24: the DIN harness reported {report}; '
                           f'expected launches {want} on {smi}')
    launches.update(report['kernel_launches'])
    print('phase 24 (python -m hybridbackend_tpu_torch.benchmarks.'
          f'din_benchmark --json{"".join(" " + f for f in flags)}): {line}')
  return launches


def _gauc_limit(predictions, reference, labels, groups, rows):
  """How far the GAUC of ``predictions`` may lie from that of
  ``reference`` (the same examples scored on another device), as
  ``metrics.auc_limit`` bounds the AUC: the evaluation ranks each batch's
  groups (``rows`` examples a batch) exactly, so only a positive and a
  negative of one group whose reference predictions lie within twice the
  largest gap of each other may swap; each swap moves its group's AUC by
  ``1 / (pos * neg)``, weighted by the group's share of the examples in
  groups of both classes; plus 1e-6 for the sums' order."""
  p, r = (np.asarray(x, np.float64) for x in (predictions, reference))
  y, g = np.asarray(labels), np.asarray(groups)
  gap = float(np.abs(p - r).max())
  num = den = 0.0
  for lo in range(0, len(y), rows):
    sl = slice(lo, lo + rows)
    _, gi = np.unique(g[sl], return_inverse=True)
    yb, rb = y[sl], r[sl]
    close = ((gi[:, None] == gi[None, :]) & (yb[:, None] == 1)
             & (yb[None, :] == 0)
             & (np.abs(rb[:, None] - rb[None, :]) <= 2 * gap))
    size = np.bincount(gi)
    pos = np.bincount(gi, weights=yb)
    neg = size - pos
    swaps = np.bincount(gi[np.nonzero(close)[0]], minlength=len(size))
    both = (pos > 0) & (neg > 0)
    num += float((size * swaps / np.maximum(pos * neg, 1))[both].sum())
    den += float(size[both].sum())
  return num / den + 1e-6, gap


def phase25_taobao(dev: torch.device, smi: str, tmp: str):
  """Phase 25: the port's Taobao entry point as a user runs it,
  ``examples/taobao/train_din.py --synthesize --sparse`` and ``--sparse
  --sessions`` at their defaults (item [50000, 16] and user [20000, 16]
  in one stack, batch 512, history 32, or 4 sessions of 32), 64 steps
  from the file each writes (kernel 1 once a step), its evaluation
  printed. A trainer made again on its ``--model-dir`` evaluates the
  file's batches as the entry point did, bit for bit, and on the CPU to
  within ``metrics.auc_limit`` (AUC), ``_gauc_limit`` (GAUC) and 1e-4 of
  the loss. A trainer of its config trains the file's first 64 batches with
  checkpoints at 32 and 64: a restore, and a resume from 32, bitwise
  equal to it. Each mode's trainer exports an f32 and an int8 bundle
  (``poly_batch=True``); a cold process serves all four on the card at
  1, 128 and 512 rows of a batch it did not train on, kernel 5 launched 2
  times a f32 predict and 4 times an int8 one (rows and scales, item and
  user); f32 within 1e-6 of the trainer's ``predict`` and within
  ``rtol = atol = 1e-4`` of the same bundle on the CPU, int8 within 2e-2
  of f32 and not all within 1e-7. Then the serving harness's DIN case
  (``serving_benchmark --cases din``, its lookups ``index_select``: no
  kernel 5). Returns the kernel launches of its runs."""
  import ast
  import contextlib
  import io
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch import metrics as hbm
  from hybridbackend_tpu_torch.examples.taobao import train_din as taobao
  cpu = torch.device('cpu')
  launches = collections.Counter()
  bundles, batch_dir = (os.path.join(tmp, d) for d in ('bundles', 'data'))
  serve, live_preds, export_s = {}, {}, {}
  for mode, flags in (('plain', ['--sparse']),
                      ('sessions', ['--sparse', '--sessions'])):
    label = f'phase 25 ({mode})'
    data = os.path.join(tmp, f'taobao_{mode}.parquet')
    model_dir = os.path.join(tmp, f'model_{mode}')
    argv = ['--synthesize', '--data', data, '--steps', str(TAOBAO_STEPS),
            '--model-dir', model_dir, *flags]
    printed = io.StringIO()
    torch.cuda.synchronize(dev)
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
      rc = taobao.main(argv)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = _counts()
    printed = printed.getvalue()
    res_main = [ast.literal_eval(line[len('epoch 0: '):])
                for line in printed.splitlines()
                if line.startswith('epoch 0: ')]
    if rc != 0 or len(res_main) != 1:
      raise AssertionError(f'{label}: the entry point returned {rc} and '
                           f'printed:\n{printed}')
    # Its evaluation's GAUC sums each batch's groups through kernel 4
    # (the batch count is held against the file's below).
    _expect(f'{label}, the Taobao entry point', counts,
            adagrad_update_sorted=TAOBAO_STEPS,
            gsum_dense_sorted=int(res_main[0]['batches']))
    launches.update(counts)
    print(f'{label} (python -m hybridbackend_tpu_torch.examples.taobao.'
          f'train_din {" ".join(argv)}), on {smi}: {wall:.3f} s with the '
          f'file\'s synthesis and the evaluation; kernel 1 launches '
          f'{counts["adagrad_update_sorted"]}; it printed:')
    for line in printed.strip().splitlines():
      print(f'  {line}')

    # The evaluation again, on the card and on the CPU.
    args = taobao.parse_args(['--data', data, '--model-dir', model_dir,
                              *flags])
    evals = list(taobao.batches(args, False))
    labels = np.concatenate([b['label'] for b in evals])
    users = np.concatenate([b['user'] for b in evals])
    res, preds = {}, {}
    _reset_counts()
    for where, d in (('card', dev), ('cpu', cpu)):
      tr = taobao.sparse_trainer(args, d)
      if tr.global_step != TAOBAO_STEPS:
        raise AssertionError(f'{label}: restored step {tr.global_step}')
      res[where] = tr.evaluate(iter(evals))
      preds[where] = torch.cat(list(tr.predict(iter(evals)))).cpu()
      del tr
    torch.cuda.synchronize(dev)
    _expect(f'{label}, evaluate and predict', _counts(),
            gsum_dense_sorted=len(evals))
    limit, near, gap = hbm.auc_limit(preds['card'], preds['cpu'], labels)
    glimit, _ = _gauc_limit(preds['card'], preds['cpu'], labels, users,
                            args.batch_size)
    g, c = res['card'], res['cpu']
    if not (g == res_main[0] and g['batches'] == c['batches'] == len(evals)
            and abs(g['auc'] - c['auc']) <= limit
            and abs(g['gauc'] - c['gauc']) <= glimit
            and abs(g['loss'] - c['loss']) <= 1e-4 * abs(c['loss'])):
      raise AssertionError(f'{label}: evaluate on the card {g} (the entry '
                           f'point printed {res_main[0]}), on the CPU {c}; '
                           f'AUC limit {limit}, GAUC limit {glimit}')
    print(f'  a trainer restored from {os.path.basename(model_dir)}: '
          f'evaluate ({len(evals)} batches) on the card equal to the entry '
          f"point's; CPU auc {c['auc']:.6f} gauc {c['gauc']:.6f} loss "
          f"{c['loss']:.6f}; predictions {gap:.3e} apart at most, AUC "
          f"apart {abs(g['auc'] - c['auc']):.3e} (limit {limit:.3e}, {near} "
          f"near a threshold), GAUC apart {abs(g['gauc'] - c['gauc']):.3e} "
          f'(limit {glimit:.3e})')

    # Restore and resume, bit for bit, over the file's first batches.
    train = evals[:TAOBAO_STEPS]
    dirs = [os.path.join(tmp, f'resume_{mode}', x) for x in 'ab']
    make = lambda d: taobao.sparse_trainer(
        argparse.Namespace(**{**vars(args), 'model_dir': d}), dev)
    live = make(dirs[0])
    _reset_counts()
    live.train(iter(train), save_checkpoint_steps=TAOBAO_SAVE)
    restored = make(dirs[0])
    n_entries = _bitwise_equal(f'{label}, restored at step {TAOBAO_STEPS}',
                               restored, live)
    del restored
    os.makedirs(dirs[1])
    shutil.copy(os.path.join(dirs[0], f'checkpoint-{TAOBAO_SAVE}.pt'),
                dirs[1])
    resumed = make(dirs[1])
    resumed.train(iter(train[TAOBAO_SAVE:]))
    _bitwise_equal(f'{label}, resumed from step {TAOBAO_SAVE}', resumed, live)
    del resumed
    torch.cuda.synchronize(dev)
    counts = _counts()
    _expect(f'{label}, the resume check', counts,
            adagrad_update_sorted=2 * TAOBAO_STEPS - TAOBAO_SAVE)
    launches.update(counts)
    print(f'  restore at step {TAOBAO_STEPS} and resume from step '
          f'{TAOBAO_SAVE}: {n_entries} state entries bitwise equal')

    # The trained model, exported: a batch it did not train on.
    held = evals[TAOBAO_STEPS]
    cols = ('cand_hist', 'hist_mask', 'user', 'label')
    serve[mode] = {size: {k: held[k][:size] for k in cols}
                   for size in TAOBAO_SIZES}
    live_preds[mode] = {size: next(live.predict(iter([b]))).cpu().numpy()
                        for size, b in serve[mode].items()}
    os.makedirs(os.path.join(batch_dir, mode))
    for size, b in serve[mode].items():
      np.savez(os.path.join(batch_dir, mode, f'batch_{size}.npz'), **b)
    for case, dtype in SERVE_CASES.items():
      t0 = time.perf_counter()
      live.export_saved_model(os.path.join(bundles, mode, case),
                              serve[mode][TAOBAO_SIZES[-1]],
                              table_dtype=dtype, poly_batch=True)
      export_s[f'{mode}/{case}'] = time.perf_counter() - t0
    del live

  cases = [f'{mode}/{case}' for mode in serve for case in SERVE_CASES]
  t0 = time.perf_counter()
  out = subprocess.run(
      [sys.executable, '-c', COLD_SERVE, bundles, batch_dir, ','.join(cases),
       ','.join(map(str, TAOBAO_SIZES))],
      cwd=HERE, capture_output=True, text=True, timeout=600)
  cold_wall_s = time.perf_counter() - t0
  if out.returncode != 0:
    raise RuntimeError(f'phase 25: the cold process failed:\n{out.stderr}')
  cold = json.loads(out.stdout.strip().splitlines()[-1])
  preds = dict(np.load(os.path.join(batch_dir, 'preds.npz')))
  for case in cases:
    per = DIN_SERVE_GATHERS[case.split('/')[1]]
    for size in TAOBAO_SIZES:
      counts = cold['cases'][case]['launches'][str(size)]
      _expect(f'phase 25, the cold process, {case} predict of {size} rows',
              counts, gather_rows=per)
      launches.update(counts)
  gaps = {}
  for mode in serve:
    on_cpu = hbt.Served(os.path.join(bundles, mode, 'f32'), cpu)
    int8_apart = []
    for size, b in serve[mode].items():
      f32 = preds[f'{mode}.f32_{size}']
      int8 = preds[f'{mode}.int8_{size}']
      if not (f32.shape == int8.shape == (size,) and np.isfinite(f32).all()
              and np.isfinite(int8).all()):
        raise AssertionError(f'phase 25: {mode} batch {size} predicted '
                             f'{f32.shape}, {int8.shape}, not all finite')
      cpu_pred = on_cpu.predict(b)
      gaps[mode, size] = (float(np.abs(f32 - live_preds[mode][size]).max()),
                          float(np.abs(f32 - cpu_pred).max()),
                          float(np.abs(int8 - f32).max()))
      int8_apart.append(gaps[mode, size][2])
      if (gaps[mode, size][0] > 1e-6
          or not np.allclose(f32, cpu_pred, rtol=1e-4, atol=1e-4)
          or gaps[mode, size][2] > 2e-2):
        raise AssertionError(f'phase 25: {mode}, {size} rows: f32 from the '
                             'trainer, card from CPU, int8 from f32: '
                             f'{gaps[mode, size]}')
    if all(x <= 1e-7 for x in int8_apart):
      raise AssertionError(f'phase 25: {mode}: the int8 predictions equal '
                           'the f32 ones')
    del on_cpu
  print(f'phase 25 (serving: the Taobao trainers exported with '
        f'poly_batch=True, served by a cold process on {smi}): export '
        + ', '.join(f'{c} {s:.3f} s' for c, s in export_s.items())
        + f'; the cold process {cold_wall_s:.3f} s wall, import '
        f'{cold["import_s"]:.3f} s')
  for case in cases:
    r = cold['cases'][case]
    print(f'  {case}: Served() {r["load_s"]:.4f} s; first predict '
          + ', '.join(f'{s} rows {r["predict_s"][str(s)]:.4f} s'
                      for s in TAOBAO_SIZES)
          + f'; kernel 5 launches per predict '
          f'{r["launches"][str(TAOBAO_SIZES[0])]["gather_rows"]}')
  for (mode, size), (f, c, q) in gaps.items():
    print(f'  {mode}, {size} rows: f32 from the trainer {f:.3e} (limit '
          f'1e-6), card from CPU {c:.3e} (rtol = atol = 1e-4), int8 from '
          f'f32 {q:.3e} (limit 2e-2)')
  ((line, report, _),) = _modules_json(
      [('serving_benchmark', ['--cases', 'din'])])
  if (report['din_ragged']['gather_launches_per_predict'] != 0
      or report['card'] != smi):
    raise AssertionError(f'phase 25: the serving harness reported {report}')
  print('phase 25 (python -m hybridbackend_tpu_torch.benchmarks.'
        f'serving_benchmark --cases din --json): {line}')
  return launches


HOST_VOCAB = 10_000_000    # phase 26's host-backed c0, with its Adagrad slot
HOST_CAP = 1_000_000       # and its device cache (JAX docs/embedding.md:70)
HOST_STEPS = 32            # the first half stepped by a _StepClock, the
                           # second timed as a user runs it (no syncs)
# zipf(1.5) % 10M draws about 580 unique c0 ids a batch of 8192 and 3600
# over 16 batches, so a cache of 16384 rows would evict in none of 16
# steps; at 1024 rows every step from the third evicts.
EVICT_CAP = 1024
HOST_ADAM_STEPS = 8
HOST_TOL = dict(rtol=2e-4, atol=2e-6)   # JAX tests/test_service_dynamic.py
DYN_CAP = 1_000_000        # phase 27's dynamic c0
DYN_STEPS = 16
HOST_SERVE_SIZES = (1, 4096)   # phases 27-28's served batch sizes


def _sync(dev):
  if dev.type == 'cuda':
    torch.cuda.synchronize(dev)


class _StepClock:
  """A trainer hook: each step's host-clock ms from an idle device (a sync
  before the step's cache apply and after the step), and the cache's
  plan, eviction and upload seconds and rows of the step. The plan of
  step k is made in the loop's fetch, between step k - 1's end and step
  k's start."""

  def __init__(self, dev, cache=None):
    self.dev, self.cache, self.rows = dev, cache, []

  def begin(self):
    self._last = dict(self.cache.stats) if self.cache else None

  def before_step(self, step):
    _sync(self.dev)
    self._t0 = time.perf_counter()
    self._s0 = dict(self.cache.stats) if self.cache else None

  def after_step(self, step, metrics):
    _sync(self.dev)
    row = {'ms': (time.perf_counter() - self._t0) * 1e3}
    if self.cache:
      s, s0, last = self.cache.stats, self._s0, self._last
      row.update(
          plan_ms=(s0['plan_s'] - last['plan_s']) * 1e3,
          evict_ms=(s['evict_s'] - s0['evict_s']) * 1e3,
          upload_ms=(s['upload_s'] - s0['upload_s']) * 1e3,
          evicted=s['evicted'] - s0['evicted'],
          uploaded=s['uploaded'] - s0['uploaded'],
          planned=s0['planned'] - last['planned'],
          misses=s0['misses'] - last['misses'])
      row['step_ms'] = row['ms'] - row['evict_ms'] - row['upload_ms']
      self._last = dict(s)
    self.rows.append(row)

  def end(self, step):
    pass


def _med(rows, key):
  return statistics.median(r[key] for r in rows)


def _host_batches(cfg, steps, seed, vocab0):
  """The flagship's seeded Criteo-like host batches, ``c0`` drawn anew as
  ``zipf(1.5) % vocab0`` (the JAX Criteo synthesizer's draw)."""
  batches = synthetic.criteo_batches(cfg.batch, steps, cfg.vocab,
                                     tables=cfg.tables,
                                     dense_features=cfg.dense_features,
                                     seed=seed)
  rng = np.random.RandomState(seed + 1)
  for b in batches:
    b['c0'] = (rng.zipf(1.5, cfg.batch) % vocab0).astype(np.int64)
  return batches


def _c0_trainer(cfg, dev, c0, table_optimizer='adagrad', caches=None):
  """The flagship sparse trainer with ``c0``'s config in place of its
  table: columns ``c1...`` are the flagship's [vocab, dim] tables and
  the tower its DCNv2, drawn from one CPU generator after ``c0``'s own
  draws; where ``c0``'s initializer ignores the generator, every such
  variant starts from the same weights."""
  import hybridbackend_tpu_torch as hbt
  specs = [hbt.EmbeddingSpec(c0, column='c0')] + [
      hbt.EmbeddingSpec(hbt.TableConfig(f'c{t}', cfg.vocab, cfg.dim))
      for t in range(1, cfg.tables)]
  fx = hbt.StackedFeatureExtractor(
      specs, dense_columns=[f'i{d}' for d in range(cfg.dense_features)],
      ctx=hbt.Context(dev))
  gen = torch.Generator().manual_seed(tb.SEED)
  tables = fx.init(gen)
  tower, preds = tb._tower(cfg, dev, gen)
  return hbt.SparseTrainer(
      fx, lambda t, e, d, b: tb.bce(preds(t, e, d), b['label']), tower,
      tables=tables,
      dense_optimizer=functools.partial(torch.optim.Adam, lr=tb.TOWER_LR),
      table_lr=tb.TABLE_LR, adagrad_init=tb.ADAGRAD_INIT,
      table_optimizer=table_optimizer, caches=caches)


def _zeros_init(gen, shape, dtype):
  return torch.zeros(shape, dtype=dtype)


def _gold_rows(trainer, ids):
  """Rows ``ids`` of ``c0`` in an uncached trainer: its table and slots,
  as numpy."""
  stack = trainer._fx.stack_of('c0')
  _, off = stack.member('c0')
  idx = torch.from_numpy(ids + off).to(trainer.state.tables[
      stack.stacked.name].device)
  arrays = {'value': trainer.state.tables[stack.stacked.name]}
  arrays.update({f'slot{i}': a for i, a in enumerate(
      trainer.state.table_opt[stack.stacked.name].acc)})
  return {k: a[idx].cpu().numpy() for k, a in arrays.items()}


def _hold_host(label, host, gold, ids):
  """The flushed host tables' rows ``ids`` against the uncached run's,
  at ``HOST_TOL``; returns the largest gap."""
  worst = 0.0
  for name, want in gold.items():
    got = host[name][ids]
    if not np.allclose(got, want, **HOST_TOL):
      raise AssertionError(
          f'{label}: host {name} is {np.abs(got - want).max():.3e} from the '
          f'uncached run on its touched rows (rtol 2e-4, atol 2e-6)')
    worst = max(worst, float(np.abs(got - want).max()))
  return worst


def _train_halves(trainer, batches, dev, cache=None):
  """``trainer.train`` over ``batches``, each batch mapped and placed in
  the loop: the first half with a ``_StepClock``, the second half timed
  whole on the host clock from an idle device to its last step, with no
  sync between steps. Returns the clock's rows and the second half's
  ms a step."""
  half = len(batches) // 2
  clock = _StepClock(dev, cache)
  trainer.train(iter(batches[:half]), hooks=[clock])
  _sync(dev)
  t0 = time.perf_counter()
  trainer.train(iter(batches[half:]))
  _sync(dev)
  return clock.rows, (time.perf_counter() - t0) * 1e3 / (len(batches) - half)


def _cached_run(cfg, dev, batches, value0, capacity, table_optimizer):
  """A cached trainer of ``c0`` over a host copy of ``value0`` (and its
  slots) behind ``capacity`` rows, trained on ``batches`` through
  ``train`` (:func:`_train_halves`), then flushed. Its kernel launches
  must be kernel 1 or 3 once a step and kernel 5 once an array for each
  step that evicted and for the flush. Returns ``(host tables, clock
  rows, unsynced ms a step, launches, cache)``."""
  import hybridbackend_tpu_torch as hbt
  nslots = 2 if table_optimizer == 'adam' else 1
  host = {'value': value0.copy()}
  for i in range(nslots):
    host[f'slot{i}'] = np.full_like(
        value0, 0.0 if table_optimizer == 'adam' else tb.ADAGRAD_INIT)
  cache = hbt.EmbeddingCache(hbt.TableConfig('c0', value0.shape[0], cfg.dim),
                             capacity, host_tables=host, ctx=hbt.Context(dev))
  trainer = _c0_trainer(
      cfg, dev, dataclasses.replace(cache.slot_config(),
                                    initializer=_zeros_init),
      table_optimizer, caches={'c0': cache})
  _sync(dev)
  _reset_counts()
  rows, unsynced_ms = _train_halves(trainer, batches, dev, cache)
  trainer._cache_runner.flush(trainer.state)
  _sync(dev)
  counts = _counts()
  kernel = ('adam_update_sorted' if table_optimizer == 'adam'
            else 'adagrad_update_sorted')
  _expect(f'phase 26, {table_optimizer} behind {capacity} rows', counts,
          **{kernel: len(batches), 'gather_rows': (nslots + 1) * (
              cache.stats['evict_calls'] + 1)})
  # Kernel 5 at the flush's shape (the resident rows of the stacked
  # table) against its plain version, not counted.
  sname = trainer._fx.stack_of('c0').stacked.name
  table = trainer.state.tables[sname]
  resident = torch.from_numpy(np.nonzero(cache._slot_to_id >= 0)[0]).to(dev)
  got = hbt.gather_rows(table, resident)
  if not torch.equal(got, hbt.gather_rows_reference(table, resident)):
    raise AssertionError('phase 26: kernel 5 at the flush differs from its '
                         'plain version')
  _reset_counts()
  del trainer
  return host, rows, unsynced_ms, counts, cache


def phase26_host_backed(cfg, dev, smi):
  """Phase 26: the flagship DCNv2 sparse step with ``c0`` a host-backed
  table of [10000000, 16] f32 with its Adagrad slot (1.28 GB of host
  DRAM) behind a 1000000-row device cache, ``c0``'s ids ``zipf(1.5) %
  vocab``, through ``SparseTrainer(caches=...)``: 32 steps, then a flush;
  every touched row of the host value and slot held against an uncached
  run of the same batches (``c0`` a [10000000, 16] device table) at
  ``rtol 2e-4, atol 2e-6``. Then a 1024-row cache for 32 steps (most
  steps evict), held the same way, and LazyAdam (kernel 3) behind 1024
  rows for 8 steps against an uncached LazyAdam run. Over the first 16
  steps, per step on the host clock from an idle card: cached against
  uncached ms, the plan, the eviction (kernel 5 and the copy to the
  host) and the upload, the hit rate and rows evicted; over the last 16,
  ms a step with no sync between steps, as a user trains. Returns the
  cached runs' kernel launches."""
  import hybridbackend_tpu_torch as hbt
  t_phase = time.perf_counter()
  launches = collections.Counter()
  value0 = np.random.default_rng(26).standard_normal(
      (HOST_VOCAB, cfg.dim), dtype=np.float32)
  value0 *= np.float32(0.01)
  batches = _host_batches(cfg, HOST_STEPS, 260, HOST_VOCAB)
  touched = np.unique(np.concatenate([b['c0'] for b in batches]))
  adam_touched = np.unique(np.concatenate(
      [b['c0'] for b in batches[:HOST_ADAM_STEPS]]))

  full = hbt.TableConfig('c0', HOST_VOCAB, cfg.dim,
                         initializer=lambda g, s, d: torch.from_numpy(value0))
  gold = _c0_trainer(cfg, dev, full)
  gold_rows, gold_ms = _train_halves(gold, batches, dev)
  gold32 = _gold_rows(gold, touched)
  del gold
  gold_adam = _c0_trainer(cfg, dev, full, 'adam')
  gold_adam.train(iter(batches[:HOST_ADAM_STEPS]))
  gold8 = _gold_rows(gold_adam, adam_touched)
  del gold_adam
  torch.cuda.empty_cache()

  runs = {}
  for label, steps, cap, opt, want, ids in (
      (f'{HOST_CAP} rows', HOST_STEPS, HOST_CAP, 'adagrad', gold32, touched),
      (f'{EVICT_CAP} rows', HOST_STEPS, EVICT_CAP, 'adagrad', gold32,
       touched),
      (f'{EVICT_CAP} rows, LazyAdam', HOST_ADAM_STEPS, EVICT_CAP, 'adam',
       gold8, adam_touched)):
    host, rows, unsynced_ms, counts, cache = _cached_run(
        cfg, dev, batches[:steps], value0, cap, opt)
    launches.update(counts)
    gap = _hold_host(f'phase 26 ({label})', host, want, ids)
    moved = float(np.abs(host['value'][ids] - value0[ids]).max())
    if moved <= 1e-4:
      raise AssertionError(f'phase 26 ({label}): training moved c0 by '
                           f'{moved:.3e} only')
    runs[label] = (rows, unsynced_ms, counts, cache, gap, steps)
    del host
  print(f'phase 26 (host-backed c0 of [{HOST_VOCAB}, {cfg.dim}] f32 with its '
        f'slots in host DRAM, the flagship DCNv2 step, batch {cfg.batch}), on '
        f'{smi}: {time.perf_counter() - t_phase:.3f} s wall; uncached '
        f'(c0 a device table) median {_med(gold_rows, "ms"):.4f} ms/step '
        f'over {len(gold_rows)} steps (host clock from an idle card), '
        f'{gold_ms:.4f} ms/step over the next {HOST_STEPS - len(gold_rows)} '
        'unsynced')
  for label, (rows, unsynced_ms, counts, cache, gap, steps) in runs.items():
    s = cache.stats
    evicting = [r for r in rows if r['evicted']]
    print(f'  cached behind {label}: median {_med(rows, "ms"):.4f} ms/step '
          f'over {len(rows)} steps (step alone {_med(rows, "step_ms"):.4f}, '
          f'plan '
          f'{_med(rows, "plan_ms"):.4f}, eviction D2H '
          f'{_med(evicting, "evict_ms") if evicting else 0.0:.4f} over the '
          f'{len(evicting)} steps that evict, upload H2D '
          f'{_med(rows, "upload_ms"):.4f}), {unsynced_ms:.4f} ms/step over '
          f'the next {steps - len(rows)} unsynced; hit rate '
          f'{1 - s["misses"] / s["planned"]:.4f} of unique ids, '
          f'{s["evicted"]} rows evicted, {s["uploaded"]} uploaded; kernel 1 '
          f'{counts["adagrad_update_sorted"]}, kernel 3 '
          f'{counts["adam_update_sorted"]}, kernel 5 '
          f'{counts["gather_rows"]} launches; host rows '
          f'{gap:.3e} from uncached (rtol 2e-4, atol 2e-6)')
  return launches


def phase27_dynamic(cfg, dev, smi, bundles, batch_dir):
  """Phase 27: ``c0`` a dynamic table (``DynamicEmbedding``, 1000000 rows)
  over raw int64 ids (``murmur3_mix64`` of the zipf draws, so the keys
  span the int64 range), with ``min_count`` 1 and 3: its transform maps
  each batch in ``DeviceIterator``'s producer thread (``prefetch=True``)
  into the flagship ``SparseTrainer`` for 16 steps (kernel 1 once a
  step). ``map_ids`` is timed per batch (a fresh mapper on the same
  batches, then the read-only probe); the mapper's ``state_dict`` round
  trip is bitwise. Each trainer exports with its ``id_mappers``; returns
  the trainers' predictions for the cold process of phase 28, and the
  kernel launches."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.native import idmap
  launches = collections.Counter()
  batches = _host_batches(cfg, DYN_STEPS + 1, 270, 1 << 62)
  for b in batches:
    b['c0'] = idmap.murmur3_mix64(b['c0'])
  live = {}
  for min_count in (1, 3):
    label = f'phase 27 (min_count {min_count})'
    dyn = hbt.DynamicEmbedding('c0', DYN_CAP, cfg.dim, min_count=min_count)
    trainer = _c0_trainer(cfg, dev, dyn.config)
    trainer._host_transform = dyn.transform('c0')
    trainer._eval_host_transform = dyn.transform('c0', train=False)
    _sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    trainer.train(iter(batches[:DYN_STEPS]), prefetch=True)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = _counts()
    _expect(label, counts, adagrad_update_sorted=DYN_STEPS)
    launches.update(counts)
    fresh = hbt.IdMapper(DYN_CAP, min_count=min_count)
    t0 = time.perf_counter()
    for b in batches[:DYN_STEPS]:
      fresh.map_ids(b['c0'])
    map_ms = (time.perf_counter() - t0) * 1e3 / DYN_STEPS
    t0 = time.perf_counter()
    for b in batches[:DYN_STEPS]:
      fresh.map_ids(b['c0'], train=False)
    probe_ms = (time.perf_counter() - t0) * 1e3 / DYN_STEPS
    state = dyn.mapper.state_dict()
    again = hbt.IdMapper.from_state_dict(DYN_CAP, state, min_count).state_dict()
    if state.keys() != again.keys() or not all(
        np.array_equal(state[k], again[k]) and state[k].dtype == again[k].dtype
        for k in state):
      raise AssertionError(f'{label}: the state_dict round trip differs')
    for k, v in fresh.state_dict().items():
      if not np.array_equal(v, state[k]):
        raise AssertionError(f'{label}: a fresh mapper on the same batches '
                             f'has another {k}')
    held = batches[DYN_STEPS]
    serve = {size: {k: v[:size] for k, v in held.items()}
             for size in HOST_SERVE_SIZES}
    case = f'dyn{min_count}/f32'
    example = dict(serve[max(serve)], c0=dyn.mapper.map_ids(
        serve[max(serve)]['c0'], train=False))
    path = os.path.join(bundles, case)
    t0 = time.perf_counter()
    trainer.export_saved_model(path, example, poly_batch=True,
                               id_mappers={'c0': dyn.mapper})
    export_s = time.perf_counter() - t0
    out = os.path.join(batch_dir, f'dyn{min_count}')
    os.makedirs(out, exist_ok=True)
    live[case] = {}
    for size, batch in serve.items():
      np.savez(os.path.join(out, f'batch_{size}.npz'), **batch)
      live[case][size] = next(trainer.predict(iter([batch]))).cpu().numpy()
    cold = int((dyn.mapper.map_ids(held['c0'], train=False) < 0).sum())
    print(f'{label}, on {smi}: {DYN_STEPS} steps {wall / DYN_STEPS * 1e3:.4f} '
          f'ms/step (train with prefetch, host clock); {dyn.mapper.size} '
          f'rows assigned, {len(state["pending_ids"])} ids pending; map_ids '
          f'{map_ms:.4f} ms a batch of {cfg.batch} (train), '
          f'{probe_ms:.4f} ms (read-only); state_dict round trip bitwise; '
          f'export {export_s:.3f} s; {cold} of {cfg.batch} held-out ids '
          'cold')
    del trainer
  return live, launches


def phase28_criteo_cached(dev, smi, tmp, bundles, batch_dir):
  """Phase 28: the port's Criteo entry point with ``--sparse --cached
  32768 --export DIR --export-poly`` at its defaults (c0 [100000, 16] in
  host DRAM behind 32768 rows), then again with ``--export-int8``, from
  one file it writes: kernel 1 once a step, kernel 5 once an array at
  each eviction and at the export's flush. Returns the trainers'
  predictions on the file's first batch (rows whose c0 is resident) for
  the cold process, and the launches."""
  import contextlib
  import io
  import re
  from hybridbackend_tpu_torch.examples.criteo import train as criteo
  launches = collections.Counter()
  data = os.path.join(tmp, 'criteo_cached.parquet')
  live = {}
  for case, flags in (('criteo/f32', ['--synthesize']),
                      ('criteo/int8', ['--export-int8'])):
    argv = ['--sparse', '--cached', '32768', '--data', data, '--export',
            os.path.join(bundles, case), '--export-poly', *flags]
    args = criteo.parse_args(argv)
    steps = args.rows // args.batch_size
    printed = io.StringIO()
    _sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
      trainer = criteo.run(args)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = _counts()
    printed = printed.getvalue()
    (cache,) = trainer._caches.values()
    # Kernel 5 gathers value and slot0 at each eviction and at the
    # export's flush.
    _expect(f'phase 28 ({case})', counts, adagrad_update_sorted=steps,
            gather_rows=2 * (cache.stats['evict_calls'] + 1))
    launches.update(counts)
    m = re.search(r'epoch 0: loss=(\S+), auc=(\S+), (\S+)s, step (\d+)',
                  printed)
    if (m is None or int(m[4]) != steps or not 0 < float(m[2]) <= 1
        or 'exported serving bundle' not in printed):
      raise AssertionError(f'phase 28: the Criteo entry point printed:\n'
                           f'{printed}')
    batch = next(criteo.batches(args, False))
    keep = cache.lookup_slots(batch['c0']) >= 0
    batch = {k: v[keep] for k, v in batch.items()}
    out = os.path.join(batch_dir, 'criteo')
    os.makedirs(out, exist_ok=True)
    live[case] = {}
    for size in HOST_SERVE_SIZES:
      part = {k: v[:size] for k, v in batch.items()}
      np.savez(os.path.join(out, f'batch_{size}.npz'), **part)
      live[case][size] = next(trainer.predict(iter([part]))).cpu().numpy()
    s = cache.stats
    print(f'phase 28 (python -m hybridbackend_tpu_torch.examples.criteo.train '
          f'{" ".join(argv)}), on {smi}: {wall:.3f} s for {steps} steps, the '
          f'evaluation and the export; c0 hit rate '
          f'{1 - s["misses"] / s["planned"]:.4f}, {s["uploaded"]} rows '
          f'uploaded, {s["evicted"]} evicted; {int(keep.sum())} of '
          f'{len(keep)} rows of the served batch resident; kernel 1 '
          f'{counts["adagrad_update_sorted"]}, kernel 5 '
          f'{counts["gather_rows"]} launches; it printed:')
    for line in printed.strip().splitlines():
      print(f'  {line}')
    del trainer
  return live, launches


def serve_host_tables(smi, bundles, batch_dir, live):
  """Phases 27-28's bundles served by one cold process on the card
  (``COLD_SERVE``): kernel 5 once a member lookup of an f32 predict and
  twice of an int8 one, no other counted kernel; f32 within 1e-6 of the
  trainer's predictions, int8 within 2e-2. Returns kernel 5's launches
  there."""
  tables = flagship().tables
  out = subprocess.run(
      [sys.executable, '-c', COLD_SERVE, bundles, batch_dir, ','.join(live),
       ','.join(map(str, HOST_SERVE_SIZES))],
      cwd=HERE, capture_output=True, text=True, timeout=600)
  if out.returncode != 0:
    raise RuntimeError(f'phases 27-28: the cold process failed:\n{out.stderr}')
  cold = json.loads(out.stdout.strip().splitlines()[-1])
  preds = dict(np.load(os.path.join(batch_dir, 'preds.npz')))
  launches = 0
  for case, want in live.items():
    per = SERVE_GATHERS[os.path.basename(case)]
    limit = 1e-6 if case.endswith('f32') else 2e-2
    gaps = []
    for size in HOST_SERVE_SIZES:
      counts = cold['cases'][case]['launches'][str(size)]
      _expect(f'the cold process, {case} predict of {size} rows', counts,
              gather_rows=per * tables)
      launches += counts['gather_rows']
      got = preds[f'{case.replace("/", ".")}_{size}']
      if got.shape != want[size].shape or not np.isfinite(got).all():
        raise AssertionError(f'{case}: served {got.shape} at {size} rows')
      gaps.append(float(np.abs(got - want[size]).max()))
      if gaps[-1] > limit:
        raise AssertionError(f'{case}: served {size} rows {gaps[-1]:.3e} '
                             f'from the trainer (limit {limit})')
    r = cold['cases'][case]
    print(f'  {case} served by a cold process on {smi}: Served() '
          f'{r["load_s"]:.4f} s, from the trainer '
          + ', '.join(f'{s} rows {g:.3e}' for s, g in zip(HOST_SERVE_SIZES,
                                                         gaps))
          + f' (limit {limit}); kernel 5 {per * tables} launches a predict')
  return launches


PIPE_K = 4                 # phases 29-30's micro-batches held against the CPU
PIPE_STEPS = 3             # and their steps, each from the initial weights
# (phase 2's situation, on 3 batches). From trained weights a ReLU whose
# input the devices round to either side of zero lets one example's term
# into one device's gradient only, up to 1.05e-3 of a tensor's largest
# gradient in the pipelined dense flagship (the plain step's gap reached
# 6.3e-4 the same way), past phase 18's 1e-3; the LazyAdam table and
# moments of that example's rows then differ past phase 5's rule, which
# holds one step from fresh slots.
PIPE_KS = (1, 2, 4)        # the micro-batch counts timed
PIPE_ROUNDS, PIPE_WINDOW = 2, 10   # timed rounds of a window of steps each
# One such term, in the card's interleaved against its plain step (cuBLAS
# rounds a row in a micro-batch of 2048 and in the batch of 8192
# differently: 2.9e-6 apart at step 3 in a chip run): a share of the
# tensor's largest gradient.
GATE_FLIP = 1e-3
AUC_TIMEOUT = 1200         # phase 31's AUC-parity harness, seconds at most
DATA_MODES = ('parquet', 'csv', 'dedup', 'transfer')
# Phase 31's data_benchmark file modes run 40 steps of 20000 rows, not the
# harness's 100: its file, and the CSV copy of it, 2.5 times smaller, to
# keep the whole script inside its time limit.
DATA_STEPS = 40


def _timed_rounds(label, variants, batch, dev, per_step):
  """The ``variants`` (``{name: (state, step)}``, each warmed up here)
  timed in turn: ``PIPE_ROUNDS`` rounds of a window of ``PIPE_WINDOW``
  steps each, the order reversed every other round, CUDA events between
  steps. Each variant's step must have launched the kernels of
  ``per_step[name]`` (``{kernel: launches a step}``), in the warmup and
  in every window, and no other counted kernel. Returns ``({name: [gap
  ms]}, the kernel launches)``."""
  states = {}
  launches = collections.Counter()

  def want(name, steps):
    return {k: n * steps for k, n in per_step[name].items()}

  for name, (state, step) in variants.items():
    _reset_counts()
    states[name] = tb.time_steps(state, step, batch, 0, tb.WARMUP, dev).state
    counts = _counts()
    _expect(f'{label}, {name}, {tb.WARMUP} warmup steps', counts,
            **want(name, tb.WARMUP))
    launches.update(counts)
  gaps = {name: [] for name in variants}
  first = tb.WARMUP
  for r in range(PIPE_ROUNDS):
    for name in (list(variants) if r % 2 == 0 else list(reversed(variants))):
      _reset_counts()
      w = tb.time_steps(states[name], variants[name][1], batch, first,
                        PIPE_WINDOW, dev)
      counts = _counts()
      _expect(f'{label}, {name}, {PIPE_WINDOW} steps', counts,
              **want(name, PIPE_WINDOW))
      launches.update(counts)
      losses = torch.stack(w.losses)
      if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f'{label}, {name}: non-finite loss')
      states[name] = w.state
      gaps[name] += w.gaps
    first += PIPE_WINDOW
  return gaps, launches


def phase29_pipelined(cfg, dev, smi):
  """Phase 29: micro-batch gradient accumulation on the dense ``Trainer``'s
  flagship model (26 unstacked tables of [100000, 16], DCNv2, batch 8192,
  ``multi_optimizer(Adagrad 0.05, Adam 1e-3)``):
  ``accumulate_gradients`` over 4 micro-batches against the whole batch's
  gradients on the card (``rtol 1e-4, atol 1e-6``, the JAX test's
  limits); 3 steps of ``make_pipelined_train_step`` (4 micro-batches) on
  the card against the same 3 on the CPU, each from the initial weights
  (``PIPE_STEPS``), at phase 18's tolerances; then ms/step of the
  pipelined step at 1, 2 and 4
  micro-batches against ``make_train_step`` in alternating rounds.
  Kernel 4 runs once a table a backward (a micro-batch's, or the whole
  batch's): each table's gradient. Returns the kernel launches."""
  import hybridbackend_tpu_torch as hbt
  cpu = torch.device('cpu')
  args = argparse.Namespace(**{**vars(cfg), 'sparse': False})
  launches = collections.Counter()
  _reset_counts()
  loss_fn, module, _ = tb.dense_parts(args, dev)
  batch = tb.shifted(*tb.make_batch(args, dev, tb.SEED + 1), args.vocab, 0)
  loss, _ = loss_fn(module, batch)
  module.zero_grad(set_to_none=True)
  loss.backward()
  loss = loss.detach()
  full = {n: p.grad.clone() for n, p in module.named_parameters()}
  (acc_loss, aux), grads = hbt.accumulate_gradients(loss_fn, PIPE_K)(
      module, batch)
  if not abs(float(acc_loss) - float(loss)) < 1e-5:
    raise AssertionError(f'phase 29: accumulated loss {float(acc_loss)}, '
                         f'whole batch {float(loss)}')
  if grads.keys() != full.keys() or aux['preds'].shape != (args.batch,):
    raise AssertionError('phase 29: accumulate_gradients gave gradients of '
                         f'{sorted(grads)} and preds {aux["preds"].shape}')
  worst = (0.0, None)
  for n, g in grads.items():
    excess = float(((g - full[n]).abs()
                    / (1e-6 + 1e-4 * full[n].abs())).max())
    worst = max(worst, (excess, n), key=lambda w: w[0])
  if worst[0] > 1:
    raise AssertionError(f'phase 29: the gradient of {worst[1]} is '
                         f'{worst[0]:.3g} times its tolerance from the whole '
                         'batch\'s')
  grad_report = (f'loss {abs(float(acc_loss) - float(loss)):.3e} apart, '
                 f'every gradient within {worst[0]:.3f} of its tolerance '
                 f'(largest in {worst[1]})')
  del module, full, grads, loss, acc_loss, aux

  # PIPE_STEPS pipelined steps, card against CPU, each from one state.
  g_trainer, c_trainer = (
      hbt.Trainer(*tb.dense_parts(args, d), ctx=hbt.Context(d))
      for d in (dev, cpu))
  for tr in (g_trainer, c_trainer):
    tr._step_fn = hbt.make_pipelined_train_step(tr._loss_fn, PIPE_K)
  batches = synthetic.criteo_batches(
      cfg.batch, PIPE_STEPS, vocab=cfg.vocab, tables=cfg.tables,
      dense_features=cfg.dense_features, seed=tb.SEED + 29)
  report, apart_in = _hold_dense_steps('phase 29', g_trainer, c_trainer,
                                       batches, from_start=True)
  del g_trainer, c_trainer
  torch.cuda.synchronize(dev)
  counts = _counts()
  # The whole batch's backward, PIPE_K micro-batches', and PIPE_K a
  # pipelined step on the card.
  _expect('phase 29, accumulated gradients and pipelined steps', counts,
          gsum_dense_sorted=(1 + PIPE_K + PIPE_STEPS * PIPE_K) * cfg.tables)
  launches.update(counts)
  _dense_backward(counts)

  # ms/step: make_train_step against the pipelined step at each k.
  variants, per_step = {}, {}
  for k in (0, *PIPE_KS):
    loss_fn, module, optimizer = tb.dense_parts(args, dev)
    step = (hbt.make_pipelined_train_step(loss_fn, k) if k
            else hbt.make_train_step(loss_fn))
    name = f'pipelined k={k}' if k else 'make_train_step'
    variants[name] = (hbt.TrainState.create(module, optimizer), step)
    per_step[name] = {'gsum_dense_sorted': max(k, 1) * cfg.tables}
  batch = functools.partial(tb.shifted, *tb.make_batch(args, dev),
                            args.vocab)
  gaps, counts = _timed_rounds('phase 29', variants, batch, dev, per_step)
  del variants
  launches.update(counts)
  _dense_backward(counts)
  print(f'phase 29 (dense Trainer flagship, micro-batch accumulation): '
        f'accumulate_gradients over {PIPE_K} micro-batches against the '
        f'whole batch on the card: {grad_report}; {PIPE_STEPS} pipelined '
        f'steps (k = {PIPE_K}) GPU vs CPU: '
        + ', '.join(f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                    for k, v in report.items())
        + f' (in {", ".join(sorted(apart_in)) or "none"})')
  print(f'  on {smi}: ms/step, median of {PIPE_ROUNDS} rounds of '
        f'{PIPE_WINDOW} steps taken in turn (CUDA events): '
        + ', '.join(f'{name} {statistics.median(g):.4f}'
                    for name, g in gaps.items()))
  return launches


INTERLEAVE_CASES = {         # phase 30: model flags, table optimizer, kernel
    'DCNv2 + Adagrad': ((), 'adagrad', 'adagrad_update_sorted'),
    'DLRM + LazyAdam': (('--model', 'dlrm'), 'adam', 'adam_update_sorted'),
}


def _interleaved_trainer(cfg, dev, optimizer, k):
  """The harness's ``SparseTrainer`` of ``cfg`` on ``dev`` with the
  interleaved step of ``k`` micro-batches in place of its plain step."""
  import hybridbackend_tpu_torch as hbt
  tr = tb.sparse_trainer(cfg, dev, table_optimizer=optimizer)
  tr._step_fn = hbt.make_interleaved_train_step(
      tr._fx, tr._model_loss, k, table_lr=tb.TABLE_LR,
      table_optimizer=optimizer)
  return tr


def _interleaved_against_plain(label, cfg, dev, optimizer, batches):
  """Each of ``batches`` one interleaved step (``PIPE_K`` micro-batches)
  and one plain step on the card from one state: the loss to 1e-5
  relative, tables and slots to ``rtol 1e-4, atol 1e-6`` (the JAX test's,
  ``tests/test_trainer.py:250-257``; a LazyAdam table to phase 5's ``atol
  1e-3`` instead: an element moves by up to 5e6 times the order
  difference of a total near zero; and where a gate flip moved a row's
  total, by phase 12's 2.2 * lr: 39 elements at step 3 of DLRM in a chip
  run), and the tower's gradients, read from
  Adam's first moment, to the same ``rtol 1e-4, atol 1e-6`` and one ReLU
  gate flip (``GATE_FLIP`` of the tensor's largest gradient: cuBLAS
  rounds a row's pre-activation in a micro-batch of 2048 and in the
  batch of 8192 differently, 2.9e-6 apart at step 3 in a chip run, one
  example's term). The JAX test
  holds the tower's weights, under SGD; under Adam a weight moves by
  ``lr * g / (|g| + eps)``, which turns a summation-order difference of a
  gradient near ``eps`` into up to about 1e-5, so the weights' largest
  gap is reported, not held. Returns the largest errors."""
  import hybridbackend_tpu_torch as hbt
  plain = tb.sparse_trainer(cfg, dev, table_optimizer=optimizer)
  inter = _interleaved_trainer(cfg, dev, optimizer, PIPE_K)
  b1 = plain.state.dense_opt.param_groups[0]['betas'][0]
  report = {'loss_rel_err': 0.0, 'table_max_abs_err': 0.0,
            'slots_max_abs_err': 0.0, 'tower_grad_max_abs_err': 0.0,
            'tower_weight_max_abs_err': 0.0}
  if optimizer == 'adam':
    report['table_elems_far_where_m_moved'] = 0
  for i, b in enumerate(batches):
    inter._load_checkpoint_state(plain._checkpoint_state())
    opt = plain.state.dense_opt.state
    m0 = [opt[p]['exp_avg'].clone() for p in plain.state.dense.parameters()]
    placed = hbt.put_batch(b, dev)
    plain.state, pm = plain._step_fn(plain.state, placed)
    inter.state, im = inter._step_fn(inter.state, placed)
    pl, il = float(pm['loss']), float(im['loss'])
    report['loss_rel_err'] = max(report['loss_rel_err'], abs(il - pl) / pl)
    if not abs(il - pl) <= 1e-5 * abs(pl):
      raise AssertionError(f'{label}, step {i + 1}: loss {il} interleaved, '
                           f'{pl} plain')
    pairs = []
    for name, t in plain.state.tables.items():
      a, c = inter.state.tables[name], t
      if optimizer == 'adam':
        # Phase 12's rule for a LazyAdam table: where a row's total itself
        # moved (its first moment more than 1e-3 of itself apart: a ReLU
        # gate flip in one example, see GATE_FLIP), an element taking its
        # first step near a zero total may move by up to 2 * lr (2.2 * lr
        # with rounding) on one side against the other.
        mi, mp = inter.state.table_opt[name].acc[0], plain.state.table_opt[
            name].acc[0]
        moved = (mi - mp).abs() > 1e-3 * torch.maximum(mi.abs(), mp.abs())
        far = (a - c).abs() > 1e-3
        report['table_elems_far_where_m_moved'] += int((far & moved).sum())
        if bool((far & ~moved).any()) or bool(
            ((a - c).abs() > 2.2 * tb.TABLE_LR).any()):
          raise AssertionError(
              f'{label}, step {i + 1}: table differs by up to '
              f'{float((a - c).abs().max())}, {int((far & ~moved).sum())} '
              'elements over 1e-3 where the total did not move')
        a = torch.where(moved, c, a)     # those elements held above
      pairs.append(('table', a, c))
      pairs += [('slots', a, c) for a, c in zip(
          inter.state.table_opt[name].acc, plain.state.table_opt[name].acc)]
    for (a, c), m in zip(zip(inter.state.dense.parameters(),
                             plain.state.dense.parameters()), m0):
      ga, gc = ((s[p]['exp_avg'] - b1 * m) / (1 - b1) for s, p in (
          (inter.state.dense_opt.state, a), (opt, c)))
      pairs.append(('tower_grad', ga, gc))
      report['tower_weight_max_abs_err'] = max(
          report['tower_weight_max_abs_err'],
          float((a.detach() - c.detach()).abs().max()))
    for key, a, c in pairs:
      report[f'{key}_max_abs_err'] = max(report[f'{key}_max_abs_err'],
                                         float((a - c).abs().max()))
      if optimizer == 'adam' and key == 'table':
        tol = dict(rtol=0, atol=1e-3)
      elif key == 'tower_grad':
        tol = dict(rtol=1e-4, atol=1e-6 + GATE_FLIP * float(c.abs().max()))
      else:
        tol = dict(rtol=1e-4, atol=1e-6)
      if not torch.allclose(a, c, **tol):
        raise AssertionError(f'{label}, step {i + 1}: {key} differs by up '
                             f'to {float((a - c).abs().max())}: {report}')
  return report


def phase30_interleaved(cfg, dev, smi, profile_steps):
  """Phase 30: the PICASSO interleaved sparse step at the flagship,
  DCNv2 + Adagrad (kernel 1) and DLRM + LazyAdam (kernel 3): 3 steps of 4
  micro-batches on the card against the CPU on phase 2's batch, ids moved
  by one a step, each from the initial weights (phase 2's and phase 5's
  tolerances, the tower by phase 18's rule too); 3 consecutive steps
  against the plain step on the card, each from the plain step's state
  (the JAX test's limits, the tower held by its gradients);
  the update kernel once a step (one stack) at 1, 2 and 4 micro-batches,
  with DCNv2's ms/step against the plain step in alternating rounds; then
  the harness's ``main``, ``--sparse`` and ``--sparse --interleave
  1|2|4``, in turn in one process of its own. With ``profile_steps`` also each k's device busy share
  and the side stream's overlap with the current one. Returns the kernel
  launches."""
  import hybridbackend_tpu_torch as hbt
  cpu = torch.device('cpu')
  launches = collections.Counter()
  # Phases 2 and 5's batch (their tolerances' ground), ids moved by one a
  # step, as host arrays.
  base, ids = tb.make_batch(cfg, cpu, tb.SEED + 1)
  batches = [{k: v.numpy() for k, v in tb.shifted(base, ids, cfg.vocab,
                                                   i).items()}
             for i in range(PIPE_STEPS)]
  for case, (flags, optimizer, kernel) in INTERLEAVE_CASES.items():
    args = flagship(*flags)
    label = f'phase 30 ({case}, interleave {PIPE_K})'
    g_tr, c_tr = (_interleaved_trainer(args, d, optimizer, PIPE_K)
                  for d in (dev, cpu))
    _reset_counts()
    report, apart_in = _hold_sparse_steps(f'{label}, step', g_tr, c_tr,
                                          batches, dev, optimizer,
                                          from_start=True)
    torch.cuda.synchronize(dev)
    counts = _counts()
    _expect(f'{label}, {PIPE_STEPS} steps', counts, **{kernel: PIPE_STEPS})
    launches.update(counts)
    del g_tr, c_tr
    print(f'{label}: {PIPE_STEPS} steps GPU vs CPU: '
          + ', '.join(f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                      for k, v in report.items())
          + f' (in {", ".join(sorted(apart_in)) or "none"})')
    _reset_counts()
    plain = _interleaved_against_plain(label, args, dev, optimizer, batches)
    torch.cuda.synchronize(dev)
    counts = _counts()
    _expect(f'{label} against the plain step', counts,
            **{kernel: 2 * PIPE_STEPS})
    launches.update(counts)
    print(f'  against the plain step on the card, {PIPE_STEPS} consecutive '
          "steps, each from the plain step's state: " + ', '.join(
              f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
              for k, v in plain.items()))
    # The update kernel once a step whatever k is; DCNv2's steps timed.
    variants = {}
    for k in (0, *PIPE_KS):
      state, step = tb.build(flagship(*flags, '--interleave', str(k)), dev,
                             optimizer)
      variants[f'interleave {k}' if k else 'plain'] = (state, step)
    batch = functools.partial(tb.shifted, *tb.make_batch(args, dev),
                              args.vocab)
    if case == 'DCNv2 + Adagrad':
      gaps, counts = _timed_rounds(label, variants, batch, dev,
                                   {name: {kernel: 1} for name in variants})
      launches.update(counts)
      print(f'  on {smi}: ms/step, median of {PIPE_ROUNDS} rounds of '
            f'{PIPE_WINDOW} steps taken in turn (CUDA events): '
            + ', '.join(f'{name} {statistics.median(g):.4f}'
                        for name, g in gaps.items()))
      if profile_steps:
        for name, (state, step) in variants.items():
          profile(f'{label}: {name}', state, step, batch, profile_steps,
                  overlap=True)
    else:
      for name, (state, step) in variants.items():
        _reset_counts()
        tb.time_steps(state, step, batch, 0, 2, dev)
        counts = _counts()
        _expect(f'{label}, {name}, 2 steps', counts, **{kernel: 2})
        launches.update(counts)
      print(f'  kernel 3 once a step at interleave 0, '
            f'{", ".join(map(str, PIPE_KS))}')
    del variants

  # The harness's main, as a user runs it, in one process for the four.
  flag_sets = [['--sparse', *(['--interleave', str(k)] if k else [])]
               for k in (0, *PIPE_KS)]
  runs = _modules_json([('train_benchmark', flags) for flags in flag_sets])
  for k, flags, (line, report, _) in zip((0, *PIPE_KS), flag_sets, runs):
    want = {name: 0 for name in tb.COUNTED}
    want['adagrad_update_sorted'] = report['timed_steps']
    if (report['kernel_launches'] != want or report['card'] != smi
        or report['interleave'] != k):
      raise AssertionError(f'phase 30: the harness {" ".join(flags)} gave '
                           f'{line}; expected launches {want} on {smi}')
    launches.update(report['kernel_launches'])
    print(f'phase 30 (hybridbackend_tpu_torch.benchmarks.train_benchmark '
          f'{" ".join(flags)} --json): {line}')
  return launches


def phase31_harnesses(smi):
  """Phase 31: the single-device harnesses at their defaults, in turn in
  one process of their own, their JSON lines printed: ``auc_parity.py
  --skip-overflow`` (exit 0, ``parity_ok.fast`` true, kernel 1 once a
  ``fast`` step, and in ``exact`` kernel 4 once a step, the stack's
  gradient, and no other counted kernel; ``fast_overflow``
  would train ``fast`` again at a world of one, where there are no
  buckets, and the CPU tests run it at a world of two),
  ``data_benchmark.py`` in each mode and
  ``e2e_benchmark.py --profile`` (kernel 1 once a profiled batch). A
  harness that exits nonzero fails the phase. Returns the kernel
  launches."""
  from hybridbackend_tpu_torch.benchmarks import e2e_benchmark as e2e
  launches = collections.Counter()
  with tempfile.TemporaryDirectory() as tmp:
    os.environ['HB_BENCH_CACHE'] = tmp
    runs = _modules_json(
        [('auc_parity', ['--skip-overflow']),
         *(('data_benchmark', ['--mode', mode] + (
             [] if mode == 'transfer' else ['--steps', str(DATA_STEPS)]))
           for mode in DATA_MODES),
         ('e2e_benchmark', ['--profile'])], timeout=AUC_TIMEOUT + 600)
    line, r, auc_s = runs[0]
    fast = r['results']['fast']
    steps = r['config']['rows'] // r['config']['batch'] * r['config'][
        'epochs']
    # The exact variants' 26 tables of one dim are one stack.
    exact = {name: 0 for name in tb.COUNTED}
    exact['gsum_dense_sorted'] = steps
    if (r['parity_ok'] != {'fast': True} or r['card'] != smi
        or fast['kernel_launches']['adagrad_update_sorted'] != steps
        or any(v['kernel_launches'] != exact
               for key, v in r['results'].items() if key != 'fast')):
      raise AssertionError(f'phase 31: auc_parity gave {line}')
    for key, v in r['results'].items():
      if key != 'fast':
        _dense_backward(v['kernel_launches'])
    for v in r['results'].values():
      launches.update(v['kernel_launches'])
    print(f'phase 31 (python -m hybridbackend_tpu_torch.benchmarks.'
          f'auc_parity --json, {auc_s:.1f} s): exact mean AUC '
          f'{r["exact_mean_auc"]:.6f}, spread {r["exact_spread"]:.6f}, band '
          f'{r["parity_band"]:.6f}, fast {fast["auc"]:.6f}, parity_ok '
          f'{r["parity_ok"]}; seconds: '
          + ', '.join(f'{k} {v["secs"]:.1f}' for k, v in r['results'].items())
          + f'; synthesize {r["synthesize_s"]:.1f}')
    print(f'  {line}')
    for mode, (line, r, secs) in zip(DATA_MODES, runs[1:]):
      if mode == 'transfer' and r['card'] != smi:
        raise AssertionError(f'phase 31: the transfer ran on {r["card"]}')
      print(f'phase 31 (python -m hybridbackend_tpu_torch.benchmarks.'
            f'data_benchmark --mode {mode} --json, {secs:.1f} s): {line}')
    line, r, secs = runs[-1]
    want = {name: 0 for name in tb.COUNTED}
    want['adagrad_update_sorted'] = e2e.PROFILE_ROUNDS
    if r['kernel_launches'] != want or r['card'] != smi:
      raise AssertionError(f'phase 31: e2e_benchmark --profile gave {line}')
    launches.update(r['kernel_launches'])
    print('phase 31 (python -m hybridbackend_tpu_torch.benchmarks.'
          f'e2e_benchmark --profile --json, {secs:.1f} s): stage medians, '
          'ms: '
          + ', '.join(f'{k} {v:.4f}' for k, v in r['profile_ms'].items()))
    print(f'  {line}')
  return launches


SHARDED_FLAGS = ()         # the harness flags of phases 32-33's config
SHARDED_DEVICE = 'cuda'    # the ranks' device


def _tower_values(state):
  opt = state.dense_opt.state
  return {n: (p.detach().cpu().clone(), opt[p]['exp_avg'].cpu().clone(),
              opt[p]['exp_avg_sq'].cpu().clone(), float(opt[p]['step']))
          for n, p in state.dense.named_parameters()}


def _nccl_world_of_one(dev):
  """``distribute/collective.py``'s ops on NCCL in a joined world of one
  on the card, each against its input; and kernel 1 on an owner list that
  went through ``all_to_all_v`` there, against its plain version on the
  CPU copy."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.distribute import collective
  from hybridbackend_tpu_torch.embedding import sparse_update as su
  with tempfile.TemporaryDirectory() as tmp:
    ctx = hbt.Context.join('cuda', 'nccl', rank=0, world_size=1,
                           init_method=f'file://{tmp}/store', timeout_s=120)
    try:
      x = torch.arange(4096, dtype=torch.float32, device=ctx.device)
      ops = {'allreduce': collective.allreduce(x, ctx=ctx),
             'allreduce mean': collective.allreduce(x, 'mean', ctx=ctx),
             'broadcast': collective.broadcast(x, ctx=ctx),
             'allgather': collective.allgather(x, ctx=ctx),
             'alltoall': collective.alltoall(x, ctx=ctx),
             'reduce_scatter': collective.reduce_scatter(x[None], ctx=ctx)}
      recv, sizes = collective.all_to_all_v(
          x.reshape(1, -1, 16), torch.full((1,), 7, dtype=torch.int32,
                                           device=ctx.device), ctx=ctx)
      ops['all_to_all_v'] = recv.reshape(-1)
      bad = [k for k, v in ops.items() if not torch.equal(v, x)]
      if bad or sizes.tolist() != [7]:
        raise AssertionError(f'phase 32: NCCL at a world of one changed '
                             f'{bad}, sizes {sizes.tolist()}')
      cfg = flagship(*SHARDED_FLAGS)
      rng = np.random.RandomState(32)
      v, n = cfg.tables * cfg.vocab, cfg.batch * cfg.tables
      rows = torch.from_numpy(rng.randint(-1, v, n).astype(np.int32)).to(dev)
      g = torch.from_numpy(rng.randn(n, cfg.dim).astype(np.float32)).to(dev)
      buckets = su._bucket_by_owner(*su._local_combine(rows, g), 1, v, n)
      local, grads = su._sort(*(t for t in su._route_grads_a2a(
          buckets, ctx, v)))
      local = local.to(torch.int32)
      gen = torch.Generator().manual_seed(32)
      table = torch.rand((v, cfg.dim), generator=gen)
      acc = torch.full_like(table, tb.ADAGRAD_INIT)
      want = hbt.adagrad_update_sorted_reference(
          table.clone(), acc.clone(), local.cpu(), grads.cpu(), tb.TABLE_LR)
      _reset_counts()
      got = hbt.adagrad_update_sorted(table.to(dev), acc.to(dev), local,
                                      grads, tb.TABLE_LR)
      torch.cuda.synchronize(dev)
      counts = _counts()
      _expect('phase 32, kernel 1 on an all_to_all_v list', counts,
              adagrad_update_sorted=1)
      errs = [float((a.cpu() - b).abs().max()) for a, b in zip(got, want)]
      if not all(torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-5)
                 for a, b in zip(got, want)):
        raise AssertionError(f'phase 32: kernel 1 on an all_to_all_v list '
                             f'differs by {errs}')
    finally:
      ctx.leave()
  print(f'phase 32: NCCL ({torch.cuda.nccl.version()}) at a world of one on '
        f'the card: {", ".join(ops)} give their input back; kernel 1 on an '
        f'owner list of {n} entries through all_to_all_v on NCCL against '
        f'its plain version: table and acc {errs[0]:.3e}, {errs[1]:.3e} '
        'apart')


def phase32_sharded(dev, smi):
  """Phase 32: the collectives on NCCL at a world of one on the card, and
  the harness once under the launcher. Its world-of-N cases, the
  flagship step under each exchange, are rows of ``PHASE33_CASES`` and
  run in phase 33's launches."""
  t_phase = time.perf_counter()
  _nccl_world_of_one(dev)
  print('phase 32: gloo takes CUDA tensors in every collective the port '
        'calls (all_reduce, broadcast, all_gather_into_tensor, '
        'all_to_all_single, reduce_scatter_tensor) and copies them through '
        'the host itself; the port stages nothing')
  t0 = time.perf_counter()
  line = _launched_harness(smi)
  print('phase 32 (python -m hybridbackend_tpu_torch.run --simulate 2 '
        '--device cuda -m hybridbackend_tpu_torch.benchmarks.train_benchmark '
        f'--sparse --lookup alltoall --json; gloo ranks sharing one card: '
        f'not a multi-GPU number; {time.perf_counter() - t0:.1f} s): '
        f'{line}')
  print(f'phase 32: {time.perf_counter() - t_phase:.1f} s')


def _launched_harness(smi):
  """The harness under the launcher as a world of two gloo ranks on the
  card; returns its JSON line, which rank 0 alone prints."""
  cmd = [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
         '2', '--device', SHARDED_DEVICE, '--timeout', '300', '-m',
         'hybridbackend_tpu_torch.benchmarks.train_benchmark', '--sparse',
         '--lookup', 'alltoall', '--json', '--device', SHARDED_DEVICE,
         '--repeats', '2', *SHARDED_FLAGS]
  res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=360)
  lines = [l for l in res.stdout.splitlines() if l.startswith('{')]
  if res.returncode != 0 or len(lines) != 1:
    raise RuntimeError(f'phase 32: the launched harness exited '
                       f'{res.returncode}, printed {res.stdout[-2000:]}:\n'
                       f'{res.stderr[-3000:]}')
  r = json.loads(lines[0])
  if (r['world'], r['lookup'], r['backend']) != (2, 'alltoall', 'gloo') or (
      SHARDED_DEVICE == 'cuda' and r['card'] != smi):
    raise AssertionError(f'phase 32: the launched harness gave {lines[0]}')
  return lines[0]


# Gloo ranks sharing the card; the NCCL world of one's wire probe and
# wire case run in phase 35's NCCL world of one.
PHASE33_WORLDS = (2, 4)
PHASE33_STEPS = 3           # each case's steps held against the world of one
PHASE33_TIMED = 3           # and the steps timed after them
PHASE33_LAUNCH_S = 600      # a world's launch, seconds at most
PHASE33_BATCH_SEED = tb.SEED + 33
PHASE33_WIRES = ('bfloat16', 'float16')
PHASE33_PROBE = 1 << 16     # floats a rank puts into each probed collective
# case -> (harness flags, table optimizer, split-dense, the step's
# exchange options, the kernel its update launches, the (lookup, update)
# fallbacks a step). A '--lookup allgather' case routes its update by
# allgather too where it says so. 'fallback': both bucket ratios so low
# that every lookup and update bucket overflows, so the exact exchanges
# run instead on every step; 'nodedup_overflow': an update bucket of 1%
# of a fair share overflows on every rank, every step.
PHASE33_CASES = {
    # Phase 32's cases: the flagship DCNv2 + Adagrad under each exchange.
    'allgather': (('--lookup', 'allgather'), 'adagrad', False, {},
                  'adagrad_update_sorted', (0, 0)),
    'alltoall': (('--lookup', 'alltoall'), 'adagrad', False, {},
                 'adagrad_update_sorted', (0, 0)),
    'fallback': (('--lookup', 'alltoall'), 'adagrad', False,
                 dict(lookup_bucket_ratio=0.01, update_bucket_ratio=0.01),
                 'adagrad_update_sorted', (1, 1)),
    'dlrm_adam': (('--model', 'dlrm', '--lookup', 'alltoall'), 'adam',
                  False, {}, 'adam_update_sorted', (0, 0)),
    'nodedup': (('--no-dedup', '--lookup', 'alltoall'), 'adagrad', False,
                {}, 'adagrad_update_sorted', (0, 0)),
    'nodedup_overflow': (('--no-dedup', '--lookup', 'alltoall'), 'adagrad',
                         False, dict(update_bucket_ratio=0.01),
                         'adagrad_update_sorted', (0, 1)),
    'split': (('--lookup', 'allgather'), 'adagrad', True,
              dict(update_exchange='allgather'), 'gsum_dense_sorted',
              (0, 0)),
    'bf16_adagrad': (('--table-dtype', 'bfloat16', '--lookup', 'alltoall'),
                     'adagrad', False, {}, 'adagrad_update_sorted', (0, 0)),
    'bf16_adam': (('--table-dtype', 'bfloat16', '--model', 'dlrm',
                   '--lookup', 'allgather'), 'adam', False,
                  dict(update_exchange='allgather'), 'adam_update_sorted',
                  (0, 0)),
    'wire': (('--lookup', 'alltoall', '--wire-dtype', 'bfloat16',
              '--gradient-wire-dtype', 'bfloat16'), 'adagrad', False, {},
             'adagrad_update_sorted', (0, 0)),
}
# The cases whose launches fill the kernels line's sharded_launches
# column (phase 32's); the others fill every_step_launches.
PHASE32_CASES = ('allgather', 'alltoall', 'fallback')
PHASE33_DIN_FLAGS = ('--sparse', '--sessions', '4', '--lookup', 'alltoall')
PHASE33_SGD_ROUNDS = 3
# What the ranks run: the step cases, then the SGD rounds and the DIN steps.
PHASE33_RUN = (*PHASE33_CASES, 'sgd', 'din')


def _combine_launches(flags, optimizer, exchange, partition='row'):
  """Kernel 4's launches a step of a phase 33 or 35 case on a rank: one
  where the row-sharded stack's update takes the alltoall route (the
  default ``update_exchange``) and sums the rank's duplicate rows first
  (``sparse_update._local_combine``): not per-occurrence Adagrad
  (``--no-dedup``), not a column-sharded stack."""
  alltoall = exchange.get('update_exchange', 'alltoall') == 'alltoall'
  per_occurrence = optimizer == 'adagrad' and '--no-dedup' in flags
  return int(partition == 'row' and alltoall and not per_occurrence)


def _phase33_want(case):
  """A phase 33 case's launches on a rank over its held steps: its
  update's kernel once a step, and kernel 4 once a step where the update
  combines (``_combine_launches``; the DIN step's alltoall update does)."""
  if case == 'din':
    kernel, combine = 'adagrad_update_sorted', 1
  else:
    flags, optimizer, _, exchange, kernel, _ = PHASE33_CASES[case]
    combine = _combine_launches(flags, optimizer, exchange)
  want = collections.Counter({kernel: PHASE33_STEPS})
  want['gsum_dense_sorted'] += combine * PHASE33_STEPS
  return dict(want)


def _phase33_steps(run):
  """The step cases of ``run`` (not the SGD rounds)."""
  return [c for c in run if c != 'sgd']


def _phase33_args(case, flags):
  return flagship(*flags, *PHASE33_CASES[case][0])


def _every_state(optimizer, args):
  """Whether the world of one takes a case's whole state (tables and
  slots, not only the tower) before each step: LazyAdam's and bf16
  tables', which a step moves apart by more than its order error (a
  LazyAdam total near zero moves its element by up to 2·lr, a bf16 value
  by an ulp), and the next step's embeddings would carry that into the
  loss and the tower's gradients."""
  return optimizer == 'adam' or args.table_dtype == 'bfloat16'


def _wire_probe(ctx):
  """The backend's four single-tensor calls in each wire dtype, each
  ``'ok'`` or the error it raised; and the port's cast collectives on
  this rank's seeded payload: the ones that only move data against cast,
  f32 collective, cast (bitwise), the all-reduce against the f64 sum of
  every rank's cast payload in wire-dtype ulps at the magnitude of the
  sum of their absolute values, and whether its values are ones the
  wire dtype holds."""
  import torch.distributed as dist
  from hybridbackend_tpu_torch.distribute import collective
  dev, w = ctx.device, ctx.world_size
  gen = torch.Generator().manual_seed(330 + ctx.rank)
  x = (torch.randn(PHASE33_PROBE, generator=gen) * 3).to(dev)
  calls = {
      'all_reduce': lambda v: dist.all_reduce(v.clone()),
      'all_to_all_single': lambda v: dist.all_to_all_single(
          torch.empty_like(v), v),
      'all_gather_into_tensor': lambda v: dist.all_gather_into_tensor(
          v.new_empty(w * v.shape[0]), v),
      'reduce_scatter_tensor': lambda v: dist.reduce_scatter_tensor(
          v.new_empty(v.shape[0] // w), v)}
  out = {'backend': dist.get_backend(), 'calls': {}, 'bitwise': {},
         'sum_ulps': {}, 'held': {}}
  for wire in PHASE33_WIRES:
    dt = getattr(torch, wire)
    for name, call in calls.items():
      try:
        call(x.to(dt))
        out['calls'][f'{name} {wire}'] = 'ok'
      except RuntimeError as e:
        out['calls'][f'{name} {wire}'] = f'refused: {e}'[:200]
    cast = x.to(dt).float()
    buckets = x[:w * 4 * 16].reshape(w, 4, 16)
    sizes = torch.full((w,), 3, dtype=torch.int32, device=dev)
    pairs = {
        'allgather': (collective.allgather(x, ctx=ctx, wire_dtype=wire),
                      collective.allgather(cast, ctx=ctx)),
        'alltoall': (collective.alltoall(x, ctx=ctx, wire_dtype=wire),
                     collective.alltoall(cast, ctx=ctx)),
        'all_to_all_v': (
            collective.all_to_all_v(buckets, sizes, ctx=ctx,
                                    wire_dtype=wire)[0],
            collective.all_to_all_v(buckets.to(dt).float(), sizes,
                                    ctx=ctx)[0])}
    for name, (got, want) in pairs.items():
      out['bitwise'][f'{name} {wire}'] = bool(torch.equal(
          got, want.to(dt).float()))
    got = collective.allreduce(x, ctx=ctx, wire_dtype=wire)
    every = collective.allgather(cast, ctx=ctx).reshape(w, -1).double()
    exact = every.sum(0)
    bits = 7 if wire == 'bfloat16' else 10
    ulp = torch.exp2(torch.floor(torch.log2(
        every.abs().sum(0).clamp(min=1e-30))) - bits)
    out['sum_ulps'][wire] = float(((got.double() - exact).abs()
                                   / ulp).max())
    out['held'][wire] = bool(torch.equal(got.to(dt).float(), got))
  return out


def _run_record(ctx, state, step, batch, steps, apply_counter, timed,
                capture, every_state=False, column=False):
  """``steps`` steps of ``step`` from ``state`` on ``batch(i)``: the
  losses, rank 0's tower and Adam moments after each, this rank's table
  and slots (copies) after the last, and with ``every_state`` after each
  earlier step the rows of its shard that the step changed (global row
  ids, then their table and slot values), its kernel launches and
  (lookup, update) fallbacks, and whether its tower is rank 0's. The
  last step's update calls go into ``capture``
  (:class:`_ListCapture`)."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.embedding import lookup as lookup_mod
  _reset_counts()
  fell = (lookup_mod.lookup.overflow_fallbacks, apply_counter.overflow_fallbacks)
  trace = []
  (name,) = state.tables
  shard = [state.tables[name], *state.table_opt[name].acc]
  for i in range(steps):
    last = i == steps - 1
    before = [t.clone() for t in shard] if every_state and not last else None
    capture.armed = last
    state, metrics = step(state, batch(i))
    capture.armed = False
    rec = {'loss': float(metrics['loss'])}
    if ctx.rank == 0:
      rec['tower'] = _tower_values(state)
    if before is not None:
      idx = _changed_rows(shard, before)
      # A column shard's rows are the table's own.
      offset = 0 if column else ctx.rank * shard[0].shape[0]
      rec['delta'] = (idx.cpu() + offset, [t[idx].cpu() for t in shard])
    if last:
      rec['state'] = [t.to('cpu', copy=True) for t in shard]
    trace.append(rec)
  if ctx.device.type == 'cuda':
    torch.cuda.synchronize(ctx.device)
  flat = torch.cat([p.detach().reshape(-1) for p in state.dense.parameters()])
  record = {
      'trace': trace, 'counts': _counts(),
      'fallbacks': (lookup_mod.lookup.overflow_fallbacks - fell[0],
                    apply_counter.overflow_fallbacks - fell[1]),
      'tower_equal': bool(torch.equal(
          flat, hbt.distribute.broadcast(flat, 0, ctx=ctx))),
      'device': str(ctx.device), 'backend': torch.distributed.get_backend()}
  # The ranks start the timed window together.
  hbt.distribute.allreduce(torch.zeros(1, device=ctx.device), ctx=ctx)
  w = tb.time_steps(state, step, batch, steps, timed, ctx.device)
  record['ms_per_step'] = w.ms / timed
  return record


def _changed_rows(now, before):
  """The rows (ascending) where any of the tensors ``now`` differs from
  its copy in ``before``."""
  changed = torch.zeros(now[0].shape[0], dtype=torch.bool,
                        device=now[0].device)
  for a, b in zip(now, before):
    changed |= (a != b).any(1)
  return changed.nonzero().squeeze(1)


def _sgd_inputs(cfg, dev, fx, i, rows=slice(None)):
  """Round ``i`` of phase 33's SGD: the stacked ids of the flagship batch
  of step ``i`` and seeded gradients, of the ``rows`` of the batch."""
  from hybridbackend_tpu_torch.embedding.stack import pack_ids
  batch = tb.shifted(*tb.make_batch(cfg, dev, PHASE33_BATCH_SEED,
                                    rows=rows), cfg.vocab, i)
  (stack,) = fx.stacks
  ids, _ = pack_ids(stack, fx.member_ids(batch)[stack.stacked.name])
  gen = torch.Generator().manual_seed(3300 + i)
  demb = torch.randn((cfg.batch, cfg.tables, cfg.dim), generator=gen)
  return ids, (demb[rows] * 0.01).to(dev)


# The update kernels that ``embedding/sparse_update.py`` calls by name, and
# where the row list stands among each one's arguments (the state
# operands, updated in place, stand before it).
UPDATE_KERNELS = {'adagrad_update_sorted': 2, 'adam_update_sorted': 3,
                  'scatter_add_sorted': 1, 'gsum_dense_sorted': 0}


class _ListCapture:
  """While ``armed``, keeps a copy of the arguments of every update
  kernel call that ``embedding/sparse_update.py`` makes: the sorted list
  an owner received, its ``-1`` lanes included, and its shard and slots
  before the call. Installed around a rank's cases."""

  def __init__(self):
    from hybridbackend_tpu_torch.embedding import sparse_update
    self.module, self.armed, self.calls = sparse_update, False, []
    self.kernels = {n: getattr(sparse_update, n) for n in UPDATE_KERNELS}

  def __enter__(self):
    for name, kernel in self.kernels.items():
      setattr(self.module, name, self._wrap(name, kernel))
    return self

  def __exit__(self, *exc):
    for name, kernel in self.kernels.items():
      setattr(self.module, name, kernel)

  def _wrap(self, name, kernel):
    def call(*args):
      if self.armed:
        self.calls.append((name, [
            a.clone() if isinstance(a, torch.Tensor) else a for a in args]))
      return kernel(*args)
    return call

  def take(self):
    calls, self.calls = self.calls, []
    return calls


def _hold_lists(calls):
  """Each captured update call's kernel, run again on its copies on the
  rank's device, against its plain version on CPU copies, at phase 1's
  tolerances: f32 ``rtol = atol = 1e-5``, bf16 ``_within_an_ulp``; rows
  the list does not hold keep their bits (kernel 4: their totals are 0).
  Returns for each call its kernel, the list's entries and ``-1`` lanes,
  the largest difference, the kernel launches read around the run, and
  what failed (None when it held)."""
  import hybridbackend_tpu_torch as hbt
  out = []
  for name, args in calls:
    at = UPDATE_KERNELS[name]
    rows = args[at]
    plain_args = [a.to('cpu', copy=True) if isinstance(a, torch.Tensor)
                  else a for a in args]
    before = [a.to('cpu', copy=True) for a in args[:at]]
    _reset_counts()
    got = getattr(hbt, name)(*args)
    if rows.device.type == 'cuda':
      torch.cuda.synchronize(rows.device)
    counts = _counts()
    want = getattr(hbt, f'{name}_reference')(*plain_args)
    got, want = ((x if isinstance(x, tuple) else (x,)) for x in (got, want))
    v = got[0].shape[0]
    held = rows[(rows >= 0) & (rows < v)].long().cpu()
    touched = torch.zeros(v, dtype=torch.bool)
    touched[held] = True
    err, problem = 0.0, None
    try:
      for k, (g, w) in enumerate(zip(got, want)):
        g = g.cpu()
        err = max(err, float((g.float() - w.float()).abs().max()))
        if g.dtype == torch.bfloat16:
          _within_an_ulp(f'{name} operand {k}', g, w)
        elif not torch.allclose(g, w, rtol=1e-5, atol=1e-5):
          raise AssertionError(f'{name} operand {k} differs from the plain '
                               f'version by up to {err}')
        keep = (before[k][~touched] if before
                else torch.zeros_like(g[~touched]))
        if not torch.equal(g[~touched], keep):
          raise AssertionError(f'{name} operand {k} changed rows the list '
                               'does not hold')
    except AssertionError as e:
      problem = str(e)
    out.append(dict(kernel=name, entries=rows.numel(),
                    pad=int((rows < 0).sum()), err=err, counts=counts,
                    problem=problem))
  return out


def phase33_rank(out: str, device: str, spec) -> int:
  """One rank of phase 33, started by the port's launcher
  (``chip_smoke.py --rank-of DIR``): joins the world, probes the wire,
  then runs each case (``PHASE33_CASES``, the SGD rounds and the DIN
  steps; at a world of one only the wire case) from the seed's state on
  its rows of the global batch, writing to ``DIR/<case>.<rank>.pt`` what
  ``_run_record`` records, and what ``_hold_lists`` finds of the last
  held step's update calls (the last round's, for SGD). ``spec`` holds
  the harness flags (``flags``), the DIN harness's (``din``), the timed
  steps (``timed``) and the cases (``run``)."""
  flags, timed = spec['flags'], spec['timed']
  import hybridbackend_tpu_torch as hbt
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  ctx = hbt.Context.join(device)
  try:
    dev = ctx.device
    torch.save(_wire_probe(ctx), os.path.join(out, f'probe.{ctx.rank}.pt'))
    with _ListCapture() as capture:
      for case in _phase33_steps(spec['run']):
        if case == 'din':
          continue
        _, optimizer, split, exchange, _, _ = PHASE33_CASES[case]
        args = _phase33_args(case, flags)
        state, step = tb.build(args, dev, optimizer, split, ctx=ctx,
                               **exchange)
        batch = functools.partial(
            tb.shifted, *tb.make_batch(args, dev, PHASE33_BATCH_SEED,
                                       rows=ctx.rows(args.batch)),
            args.vocab)
        apply = (hbt.sparse_adam_apply if optimizer == 'adam'
                 else hbt.sparse_adagrad_apply)
        record = _run_record(ctx, state, step, batch, PHASE33_STEPS, apply,
                             timed, capture, _every_state(optimizer, args))
        record['lists'] = _hold_lists(capture.take())
        torch.save(record, os.path.join(out, f'{case}.{ctx.rank}.pt'))
        del state, step, record
      if 'sgd' in spec['run']:
        cfg = flagship(*flags)
        fx, tables, _, _ = tb.sparse_parts(cfg, dev, ctx)
        (name,) = tables
        _reset_counts()
        fell = hbt.sparse_sgd_apply.overflow_fallbacks
        for i in range(PHASE33_SGD_ROUNDS):
          ids, demb = _sgd_inputs(cfg, dev, fx, i, ctx.rows(cfg.batch))
          capture.armed = i == PHASE33_SGD_ROUNDS - 1
          hbt.sparse_sgd_apply(tables[name], ids, demb,
                               fx.stacks[0].stacked, tb.TABLE_LR, ctx=ctx,
                               exchange='alltoall')
          capture.armed = False
        if dev.type == 'cuda':
          torch.cuda.synchronize(dev)
        record = {'counts': _counts(),
                  'table': tables[name].to('cpu', copy=True),
                  'fallbacks': (hbt.sparse_sgd_apply.overflow_fallbacks
                                - fell)}
        record['lists'] = _hold_lists(capture.take())
        torch.save(record, os.path.join(out, f'sgd.{ctx.rank}.pt'))
        del fx, tables
      if 'din' in spec['run']:
        args = din.parse_args([*spec['din'], '--device', device])
        state, step = din.build(args, dev, ctx)
        batch = functools.partial(din.shifted, args, *din.make_batch(
            args, dev, PHASE33_BATCH_SEED, rows=ctx.rows(args.batch)))
        record = _run_record(ctx, state, step, batch, PHASE33_STEPS,
                             hbt.sparse_adagrad_apply, timed, capture)
        record['lists'] = _hold_lists(capture.take())
        torch.save(record, os.path.join(out, f'din.{ctx.rank}.pt'))
  finally:
    ctx.leave()
  return 0


# A LazyAdam step moves an element by about lr·sign(s) whatever the size of
# its total s, so where a ReLU gate flip (see ``_hold_tower``) moved an
# example's embedding gradient, its elements may lie up to 2·lr apart
# (2.2·lr with the stored value's rounding) and their moments by that
# gradient: at most this share of a state tensor's elements, and those
# by at most 2.2·lr (table) or 2**-5 of the tensor's largest (m, v).
ADAM_FLIP_SHARE = 1e-5


def _state_close(label, key, got, want, optimizer, bf16, wire, m_moved,
                 report, total=None, largest=None, flips=None):
  """The gathered ``key`` (table or slot) one step from one state (or,
  without ``_every_state``, after the last) at a world of N against the
  world of one, elementwise by the case's rule: f32 Adagrad phase 2's
  1e-5; LazyAdam's table phase 5's 1e-3, its moments 1e-3 relative plus
  1e-4 of the largest; bf16 at most 1 bf16 ulp, or ``gpu_vs_cpu``'s
  atols (1e-6; a LazyAdam table 1e-4, its moments 2**-5 of the largest),
  in at most 1% of the elements, a LazyAdam table element whose m moved
  up to 2.2·lr (phase 12's rule); the wire's bands
  (``tests/test_wire_grad.py``: the accumulator 2e-2; a table element
  moves by lr·g/sqrt(acc) and g by a bf16 rounding, 2**-8 of lr). LazyAdam
  elements past the rule: ``ADAM_FLIP_SHARE``. Adds the largest
  difference (f32) or the elements that differ (bf16), and the elements
  let past, to ``report``. Where ``got`` and ``want`` are some rows of
  their tensors, ``total`` is the tensor's elements, which the shares
  are of, and ``largest`` its largest value. With ``flips`` (a mask of
  ``got``'s rows that the examples whose ReLU gates flipped read, and
  how many elements those examples' terms reach: ``_gate_flips``) the
  LazyAdam elements past the rule must lie on those rows, be at most that
  many and within the loose bound, in place of ``ADAM_FLIP_SHARE``."""
  d = (got.float() - want.float()).abs()
  one = want.float().abs()
  total = total or d.numel()
  largest = float(one.max()) if largest is None else largest
  adam = optimizer == 'adam'
  if bf16:
    ulps = _ulps_apart(got, want)
    atol = (1e-6 if not adam else 1e-4 if key == 'table'
            else 2**-5 * largest)
    bad = (ulps > 1) & (d > atol)
    if m_moved is not None:
      bad &= ~(m_moved & (d <= 2.2 * tb.TABLE_LR))
    differ = int((ulps > 0).sum())
    if differ > 0.01 * total:
      raise AssertionError(f'{label}: {key}: {differ} of {total} '
                           'elements differ')
  elif wire:
    bad = d > ((2e-2 * one + 1e-6) if key != 'table' else (1e-5 * one + 2e-4))
  elif not adam:
    bad = d > 1e-5 * one + 1e-5
  elif key == 'table':
    bad = d > 1e-3
  else:
    bad = d > 1e-3 * one + 1e-4 * largest
  loose = 2.2 * tb.TABLE_LR if key == 'table' else 2**-5 * largest
  if adam and flips is not None:
    on_rows, reach = flips
    off, past = bad & ~on_rows[:, None], int(bad.sum())
    if bool(off.any()) or past > reach:
      raise AssertionError(f'{label}: the gathered {key} differs past its '
                           f'rule in {past} elements, {int(off.sum())} of '
                           'them on rows no example whose gates flipped '
                           f'reads (those examples reach {reach}), by up '
                           f'to {float(d.max())}')
    report[f'{key}_past_rule'] = report.get(f'{key}_past_rule', 0) + past
    bad &= d > loose
  elif adam and 0 < int(bad.sum()) <= ADAM_FLIP_SHARE * total:
    report[f'{key}_past_rule'] = (report.get(f'{key}_past_rule', 0)
                                  + int(bad.sum()))
    bad &= d > loose
  if bool(bad.any()):
    raise AssertionError(f'{label}: the gathered {key} differs in '
                         f'{int(bad.sum())} elements past its rule, by up '
                         f'to {float(d.max())}')
  name = f'{key}_{"elems_differ" if bf16 else "max_abs_err"}'
  report[name] = max(report.get(name, 0),
                     differ if bf16 else float(d.max()))


def _hold_wire_tower(label, net, one_net, opt, one_opt, before, lr, report):
  """The tower after a step on the bf16 wire against the world of one's
  from the same weights and moments: each weight within the wire's band
  (``rtol 5e-2, atol 1e-4``, ``tests/test_wire_grad.py``), or, where the
  first moments differ by more than 1/16 of the world of one's, by up
  to 2.2·lr (Adam's step, ``lr·m/sqrt(v)``, then moves by up to its own
  size and may take the other sign); those are counted. The gradients
  (read from Adam's first moment) are reported, not held: the rows come
  back rounded to bf16 and the tables drift by the wire's rounding of
  their updates, and a gradient that sums terms of either sign over the
  batch keeps that error of their sizes, not of the sum (8.6% of the
  tensor's largest in a CPU rehearsal at batch 256). The loss, the
  accumulator and the table hold the step to its bands."""
  b1 = 0.9
  for (n, p), q, (_, m0) in zip(net.named_parameters(), one_net.parameters(),
                                before):
    m, m1 = opt[p]['exp_avg'].cpu(), one_opt[q]['exp_avg'].cpu()
    report['tower_grad_err_of_max'] = max(
        report['tower_grad_err_of_max'],
        float((m - m1).abs().max()) / float((m1 - b1 * m0).abs().max()))
    diff = (p.detach().cpu() - q.detach().cpu()).abs()
    out = diff > 1e-4 + 5e-2 * q.detach().cpu().abs()
    moved = (m - m1).abs() > m1.abs() / 16
    report['tower_either_sign'] += int((out & moved).sum())
    out &= ~(moved & (diff <= 2.2 * lr))
    report['tower_max_abs_err'] = max(report['tower_max_abs_err'],
                                      float(diff.max()))
    if bool(out.any()):
      raise AssertionError(f'{label}: net.{n} outside the wire band in '
                           f'{int(out.sum())} elements, by up to '
                           f'{float(diff.max())}')


def _gate_flips(args, state, b, k):
  """The examples of batch ``b`` whose ReLU gates differ between the
  tower (``state.dense``, on ``state.tables``' embeddings) run on the
  whole batch, as the world of one's plain step runs it, and on its
  ``k`` contiguous micro-batches, as a world's interleaved step runs it:
  the GEMMs of other shapes round apart, and a gate near zero may take
  the other side, which moves that example's gradient terms. Returns the
  stacked table's rows those examples read, the elements of the table
  that those reads reach (rows times the width), and their count."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.models.layers import Dense
  from hybridbackend_tpu_torch.pipeline import _microbatches
  (table,) = state.tables.values()
  fx = hbt.StackedFeatureExtractor(
      tb._specs(args),
      dense_columns=[f'i{d}' for d in range(args.dense_features)],
      ctx=hbt.Context(table.device))
  _, preds = tb._tower(args, torch.device('cpu'), torch.Generator())
  gates = []
  hooks = [m.register_forward_hook(
      lambda mod, inp, out: gates.append(out.reshape(out.shape[0], -1) > 0))
           for m in state.dense.modules()
           if isinstance(m, Dense) and m.activation is torch.relu]

  def run(part):
    raw, _, layouts = fx.lookup_raw(state.tables, part)
    preds(state.dense, *fx.combine_from_raw(raw, layouts, part))
    out = torch.cat(gates, 1)
    gates.clear()
    return out

  try:
    with torch.no_grad():
      whole = run(b)
      parts = torch.cat([run(part) for part in _microbatches(b, k)])
  finally:
    for h in hooks:
      h.remove()
  flipped = (whole != parts).any(1)
  rows = torch.cat([b[f'c{t}'][flipped].long() + t * args.vocab
                    for t in range(args.tables)])
  return rows, int(rows.numel()) * args.dim, int(flipped.sum())


def _hold_world33(label, case, dev, ranks, flags, spec=None,
                  one_interleave=0, witness=0):
  """One case's records at a world of N against the world of one on the
  card (the same seed, the whole table), each step from one tower: before
  step ``i`` the world of one takes rank 0's tower and Adam moments after
  step ``i - 1``, and where ``_every_state`` says so the world's tables
  and slots too, which are then held after every step
  (``_hold_delta33``, on the rows a step changed). The loss
  (the ranks' mean) to 1e-5 (1e-4 with bf16 tables and on the wire, by
  its band), the tower by phase 18's rule (``_hold_tower``; its weights
  over 1e-4 apart allowed Adam's either-sign step, up to 2.2·lr, where
  their gradients are within 1e-3 of the tensor's largest, as phase 32
  held them), on the wire by ``_hold_wire_tower``, the gathered shards
  and slots by ``_state_close``; rows no valid id read keep their
  initial bits (DIN). The LazyAdam cases alone let 0.1% of a tensor's
  gradients past by up to 2**-5 of its largest, counted as
  ``tower_grads_past_allowance``, and allow the either-sign step up to
  2**-5: a world's ranks run their rows through other GEMM shapes than
  the world of one, a ReLU gate that flips moves one example's term, and
  LazyAdam's tables move a near-zero total by up to 2·lr, which the next
  step's embeddings carry into the tower. The world of one runs the
  plain step, or with ``one_interleave`` the interleaved step in that
  many micro-batches. With ``witness`` (the world's micro-batches in the
  global batch) the plain step's LazyAdam state is held by the gate
  flips it shows: before each step ``_gate_flips`` finds the examples
  whose ReLU gates differ between the tower on the whole batch and on
  those micro-batches, and the elements past the rule must lie on their
  rows (``_state_close``); their count a step is ``gate_flips``."""
  from hybridbackend_tpu_torch.training.optimizer import init_state
  if case == 'din':
    args = din.parse_args([*PHASE33_DIN_FLAGS, '--device', str(dev)])
    state, step = din.build(args, dev)
    batch = functools.partial(din.shifted, args, *din.make_batch(
        args, dev, PHASE33_BATCH_SEED))
    optimizer, bf16, wire = 'adagrad', False, False
    make_tower = lambda: din._tower(args, torch.device('cpu'),
                                    torch.Generator())
  else:
    spec = spec or PHASE33_CASES[case]
    optimizer, split = spec[1], spec[2]
    args = flagship(*flags, *spec[0])
    state, step = tb.build(argparse.Namespace(**{
        **vars(args), 'interleave': one_interleave}), dev, optimizer, split)
    batch = functools.partial(tb.shifted, *tb.make_batch(
        args, dev, PHASE33_BATCH_SEED), args.vocab)
    bf16, wire = args.table_dtype == 'bfloat16', case == 'wire'
    make_tower = lambda: tb._tower(args, torch.device('cpu'),
                                   torch.Generator())[0]
  (name,) = state.tables
  live = [state.tables[name], *state.table_opt[name].acc]
  keys = ['table'] + (['m', 'v'] if optimizer == 'adam' else ['acc'])
  column = spec is not None and spec[6:] == ('column',)
  initial = live[0].to('cpu', copy=True)
  init_state(state.dense_opt)
  group = state.dense_opt.param_groups[0]
  adam = (group['lr'], *group['betas'], group['eps'])
  opt = state.dense_opt.state
  report = {'loss_rel_err': 0.0, **_tower_report(), 'tower_either_sign': 0}
  apart_in = set()
  prev, touched, step_rows = None, None, []
  for i in range(PHASE33_STEPS):
    step_label = f'{label}, step {i + 1}'
    if prev is not None:
      with torch.no_grad():
        for n, p in state.dense.named_parameters():
          w, m, v, t = prev[n]
          p.copy_(w)
          opt[p]['exp_avg'].copy_(m)
          opt[p]['exp_avg_sq'].copy_(v)
          opt[p]['step'].fill_(t)
    before_values = _tower_values(state)
    names = [n for n, _ in state.dense.named_parameters()]
    before = [before_values[n][:2] for n in names]
    v_before = [before_values[n][2] for n in names]
    b = batch(i)
    if case == 'din':
      ids = b['cand_hist']
      rows = torch.cat([ids[(ids >= 0) & (ids < args.vocab)].reshape(-1),
                        b['user'].reshape(-1) + args.vocab]).long().cpu()
      touched = rows if touched is None else torch.cat([touched, rows])
    else:
      step_rows.append(torch.cat([b[f'c{t}'].long().cpu() + t * args.vocab
                                  for t in range(args.tables)]))
    pre = ([x.clone() for x in live] if 'delta' in ranks[0]['trace'][i]
           else None)
    flips = None
    if witness:
      *flips, flipped = _gate_flips(args, state, b, witness)
      report.setdefault('gate_flips', []).append(flipped)
    state, metrics = step(state, b)
    losses = {r['trace'][i]['loss'] for r in ranks}
    if len(losses) != 1:
      raise AssertionError(f'{step_label}: the ranks report losses {losses}')
    (world_loss,) = losses
    one = float(metrics['loss'])
    rel = abs(world_loss - one) / abs(one)
    report['loss_rel_err'] = max(report['loss_rel_err'], rel)
    if rel > (1e-4 if (bf16 or wire) else 1e-5):
      raise AssertionError(f'{step_label}: loss {world_loss}, a world of one '
                           f'{one}')
    g_vals = ranks[0]['trace'][i]['tower']
    g_net, g_opt = make_tower(), {}
    c_net, c_opt = make_tower(), {}
    with torch.no_grad():
      for (n, gp), cp in zip(g_net.named_parameters(), c_net.parameters()):
        for target, opt_out, (w, m, v, t) in (
            (gp, g_opt, g_vals[n]), (cp, c_opt, _tower_values(state)[n])):
          target.copy_(w)
          opt_out[target] = {'exp_avg': m, 'exp_avg_sq': v,
                             'step': torch.tensor(t)}
    if wire:
      _hold_wire_tower(step_label, g_net, c_net, g_opt, c_opt, before,
                       adam[0], report)
    else:
      lazy = optimizer == 'adam'
      _hold_tower(step_label, g_net, c_net, g_opt, c_opt, before, v_before,
                  adam, report, apart_in, flip_share=1e-3 if lazy else 0.0)
      either_sign = (max(report['their_largest_grad_of_max_card'],
                         report['their_largest_grad_of_max_cpu'])
                     <= (2**-5 if lazy else 1e-3)
                     and report['tower_max_abs_err'] <= 2.2 * adam[0])
      if report['tower_weights_over_1e-4_apart'] and not either_sign:
        raise AssertionError(f'{step_label}: tower weights over 1e-4 apart: '
                             f'{report} in {sorted(apart_in)}')
    prev = g_vals
    if pre is not None:
      _hold_delta33(step_label, ranks, i, live, pre, keys, optimizer, bf16,
                    wire, report, column, flips)
    if 'state' in ranks[0]['trace'][i]:
      _hold_state33(step_label, ranks, i, live, keys, optimizer, bf16, wire,
                    step_rows, report, column, flips)
  if touched is not None:
    keep = torch.ones(initial.shape[0], dtype=torch.bool)
    keep[touched] = False
    world = torch.cat([r['trace'][-1]['state'][0] for r in ranks])
    for what, t in (('the world', world), ('the world of one', live[0])):
      if not torch.equal(t.cpu()[keep], initial[keep]):
        raise AssertionError(f'{label}: {what} moved rows no valid id read')
    report['rows_kept'] = int(keep.sum())
  return report, apart_in


def _hold_delta33(label, ranks, i, live, pre, keys, optimizer, bf16, wire,
                  report, column=False, flips=None):
  """Step ``i`` of an ``_every_state`` case, from one state (``pre``, the
  world of one's state before it, is the world's): on the rows that
  either side changed, the world's table and slots (its changed rows
  from the ranks' records, the others as they were; of a column-sharded
  case each rank's columns) against the world of one's (``live``) by
  ``_state_close``, and then the world of one takes the world's values
  there, so that the next step starts from one state again. ``flips``:
  ``_gate_flips``' rows and reach, or None."""
  dev = live[0].device
  world_n, width = len(ranks), live[0].shape[1]
  rows_w = torch.cat([r['trace'][i]['delta'][0] for r in ranks]).to(dev)
  union = torch.zeros(live[0].shape[0], dtype=torch.bool, device=dev)
  union[_changed_rows(live, pre)] = True
  union[rows_w] = True
  rows = union.nonzero().squeeze(1)
  world = [x[rows] for x in pre]
  for r, rec in enumerate(ranks):
    got_rows, got_vals = rec['trace'][i]['delta']
    at = torch.searchsorted(rows, got_rows.to(dev))
    cols = (slice(r * width // world_n, (r + 1) * width // world_n)
            if column else slice(None))
    for w, v in zip(world, got_vals):
      w[at, cols] = v.to(dev)
  ones = [x[rows] for x in live]
  m_moved = (world[1] != ones[1]) if optimizer == 'adam' else None
  at = None if flips is None else (torch.isin(rows, flips[0]), flips[1])
  for key, w, one, x in zip(keys, world, ones, live):
    _state_close(label, key, w, one, optimizer, bf16, wire,
                 m_moved if key == 'table' else None, report,
                 total=x.numel(), largest=float(x.float().abs().max()),
                 flips=at)
  for x, w in zip(live, world):
    x[rows] = w


def _hold_state33(label, ranks, i, live, keys, optimizer, bf16, wire,
                  step_rows, report, column=False, flips=None):
  """The world's gathered table and slots (a column-sharded case's joined
  along the dim) after step ``i`` against the world of one's (``live``),
  on the card, by ``_state_close``; a failure names its largest
  difference's row, every state's values there on both sides, and the
  steps whose batch held that row. ``flips``: ``_gate_flips``' rows and
  reach, or None."""
  dev = live[0].device
  at = None
  if flips is not None:
    at = torch.zeros(live[0].shape[0], dtype=torch.bool, device=dev)
    at[flips[0]] = True
    at = (at, flips[1])
  gots = [torch.cat([r['trace'][i]['state'][k] for r in ranks],
                    dim=int(column)).to(dev) for k in range(len(live))]
  ones = live
  m_moved = (gots[1] != ones[1]) if optimizer == 'adam' else None
  for key, got, one in zip(keys, gots, ones):
    if got.shape != one.shape:
      raise AssertionError(f'{label}: the gathered {key} is '
                           f'{tuple(got.shape)}, not {tuple(one.shape)}')
    try:
      _state_close(label, key, got, one, optimizer, bf16, wire,
                   m_moved if key == 'table' else None, report, flips=at)
    except AssertionError as e:
      d = (got.float() - one.float()).abs()
      k = int(d.argmax())
      row = k // d.shape[1]
      at = {n: (float(g.float().flatten()[k]), float(o.float().flatten()[k]))
            for n, g, o in zip(keys, gots, ones)}
      held = [j + 1 for j, r in enumerate(step_rows)
              if bool((r == row).any())]
      raise AssertionError(
          f'{e}; {int((d > 1e-3).sum())} elements over 1e-3 in '
          f'{int(((d > 1e-3).sum(1) > 0).sum())} rows; the largest at row '
          f'{row}, (world, one) {at}, in the batches of steps {held}') from e


def _hold_sgd33(label, dev, ranks, flags):
  """Phase 33's SGD rounds: the gathered shards against
  ``sparse_sgd_apply`` of the whole list on the whole table on the card
  (rtol 1e-5, atol 1e-6: each row's total summed in another order)."""
  import hybridbackend_tpu_torch as hbt
  cfg = flagship(*flags)
  fx, tables, _, _ = tb.sparse_parts(cfg, dev)
  (name,) = tables
  for i in range(PHASE33_SGD_ROUNDS):
    ids, demb = _sgd_inputs(cfg, dev, fx, i)
    hbt.sparse_sgd_apply(tables[name], ids, demb, fx.stacks[0].stacked,
                         tb.TABLE_LR)
  got = torch.cat([r['table'] for r in ranks])
  one = tables[name].cpu()
  err = float((got - one).abs().max())
  if got.shape != one.shape or not torch.allclose(got, one, rtol=1e-5,
                                                  atol=1e-6):
    raise AssertionError(f'{label}: the gathered table differs by {err}')
  return err


def _print_probe(world, ranks):
  """Phase 33's wire probe: fails unless every cast collective that moves
  data is bitwise cast, f32 collective, cast, the cast sum holds wire
  values within its W - 1 ulps, and every call the backend refused is
  named; prints rank 0's table."""
  for r, rec in enumerate(ranks):
    bad = [k for k, ok in rec['bitwise'].items() if not ok]
    far = {k: u for k, u in rec['sum_ulps'].items() if u > world - 1}
    unheld = [k for k, ok in rec['held'].items() if not ok and world > 1]
    if bad or far or unheld:
      raise AssertionError(f'phase 33, {world} ranks, rank {r}: cast '
                           f'collectives not bitwise {bad}, sums {far} '
                           f'ulps, not held by the wire dtype {unheld}')
  rec = ranks[0]
  print(f'phase 33, {world} rank(s) on {rec["backend"]}: calls '
        + ', '.join(f'{k} {v}' for k, v in rec['calls'].items())
        + '; cast, f32 collective, cast bitwise: '
        + ', '.join(rec['bitwise'])
        + '; the cast all-reduce from the f64 sum of the cast payloads: '
        + ', '.join(f'{k} {v:.3f} ulps' for k, v in rec['sum_ulps'].items()))
  return {k: v for k, v in rec['calls'].items() if v != 'ok'}


def _print_lists(label, ranks):
  """Fails unless every rank's ``_hold_lists`` held and launched its
  kernel once a check; prints them."""
  for r, rec in enumerate(ranks):
    if not rec['lists']:
      raise AssertionError(f'{label}, rank {r}: no update call captured')
    for c in rec['lists']:
      _expect(f'{label}, rank {r}, {c["kernel"]} on its received list',
              c['counts'], **{c['kernel']: 1})
      if c['problem']:
        raise AssertionError(f'{label}, rank {r}, on its received list: '
                             f'{c["problem"]}')
  print(f'{label}: the last step\'s update kernels on each rank\'s received '
        'list against their plain versions on the CPU (one launch each): '
        + '; '.join(f'rank {r} ' + ', '.join(
            f'{c["kernel"]} {c["entries"]} entries, {c["pad"]} -1 lanes, '
            f'max abs err {c["err"]:.3e}' for c in rec['lists'])
                    for r, rec in enumerate(ranks)))


def _launch_world33(world, out):
  """Starts phase 33's launch of ``world`` gloo ranks writing to ``out``;
  its output goes to files there, so that a launch left to run is never
  blocked on a full pipe."""
  cmd = [sys.executable, '-m', 'hybridbackend_tpu_torch.run',
         '--simulate', str(world),
         '--device', SHARDED_DEVICE, '--timeout', str(PHASE33_LAUNCH_S),
         os.path.join(HERE, 'chip_smoke.py'), '--rank-of', out,
         '--rank-device', SHARDED_DEVICE,
         '--rank-flags', json.dumps(dict(
             flags=list(SHARDED_FLAGS), din=list(PHASE33_DIN_FLAGS),
             timed=PHASE33_TIMED, run=list(PHASE33_RUN)))]
  with open(os.path.join(out, 'stdout'), 'w') as so, open(
      os.path.join(out, 'stderr'), 'w') as se:
    return subprocess.Popen(cmd, cwd=HERE, stdout=so, stderr=se)


def phase33_every_step(dev, smi):
  """Phase 33: every sparse step at a world of N, one launch a world of
  ``PHASE33_WORLDS`` (see the module docstring), the launches at once: a
  world is held against the world of one while the next one's ranks
  still run. Returns the kernel launches of the ranks' held steps and
  rounds, summed over the ranks: those of ``PHASE32_CASES``, then the
  others'."""
  t_phase = time.perf_counter()
  sharded, launches = collections.Counter(), collections.Counter()
  refused, failures = {}, []
  with tempfile.TemporaryDirectory() as tmp:
    procs = {}
    for world in PHASE33_WORLDS:
      os.makedirs(os.path.join(tmp, str(world)))
      procs[world] = _launch_world33(world, os.path.join(tmp, str(world)))
    try:
      for world in PHASE33_WORLDS:
        _phase33_world(dev, smi, world, procs[world], t_phase,
                       os.path.join(tmp, str(world)), sharded, launches,
                       refused, failures)
    finally:
      for proc in procs.values():
        if proc.poll() is None:
          proc.kill()
          proc.wait()
  print(f'phase 33: backend refusals {refused or "none"}; '
        f'{time.perf_counter() - t_phase:.1f} s')
  if failures:
    raise AssertionError(f'phase 33: {len(failures)} cases failed: '
                         + ' | '.join(failures))
  return sharded, launches


def _phase33_world(dev, smi, world, proc, started, out, sharded, launches,
                   refused, failures):
  """Waits for phase 33's launch of ``world`` ranks (``proc``, started
  with the phase at ``started``), then holds its records in ``out``
  against the world of one, adding to the launch counters, the backend
  refusals and the failures."""
  proc.wait(timeout=PHASE33_LAUNCH_S + 60)
  launch_s = time.perf_counter() - started
  if proc.returncode != 0:
    with open(os.path.join(out, 'stderr')) as f:
      raise RuntimeError(f'phase 33: {world} ranks exited '
                         f'{proc.returncode}:\n{f.read()[-4000:]}')
  t0 = time.perf_counter()
  load = lambda case: [torch.load(os.path.join(out, f'{case}.{r}.pt'))
                       for r in range(world)]
  refused.update(_print_probe(world, load('probe')))
  times = []
  for case in _phase33_steps(PHASE33_RUN):
    label = f'phase 33, {world} ranks, {case}'
    ranks = load(case)
    try:
      kernel, per_step = (('adagrad_update_sorted', (0, 0))
                          if case == 'din' else PHASE33_CASES[case][4:])
      want_fallbacks = tuple(PHASE33_STEPS * f for f in per_step)
      for r, rec in enumerate(ranks):
        _expect(f'{label}, rank {r}', rec['counts'], **_phase33_want(case))
        (sharded if case in PHASE32_CASES else launches).update(
            rec['counts'])
        if tuple(rec['fallbacks']) != want_fallbacks:
          raise AssertionError(f'{label}, rank {r}: (lookup, update) '
                               f'fallbacks {rec["fallbacks"]}, expected '
                               f'{want_fallbacks}')
        if not rec['tower_equal']:
          raise AssertionError(f'{label}: rank {r}\'s tower is not rank '
                               '0\'s')
      report, apart_in = _hold_world33(label, case, dev, ranks,
                                       SHARDED_FLAGS)
      times.append(f'{case} {ranks[0]["ms_per_step"]:.4f}')
      print(f'{label} ({ranks[0]["backend"]} on {ranks[0]["device"]}): '
            f'{PHASE33_STEPS} steps against a world of one on the card, '
            'each from one tower: '
            + ', '.join(f'{k} {v:.3e}' if isinstance(v, float)
                        else f'{k} {v}' for k, v in report.items())
            + f' (in {", ".join(sorted(apart_in)) or "none"}); launches '
            f'{_phase33_want(case)} on each rank; (lookup, update) '
            f'fallbacks {[tuple(r["fallbacks"]) for r in ranks]} by rank')
      _print_lists(label, ranks)
    except AssertionError as e:
      # Every case runs; the phase fails at its end.
      failures.append(str(e))
      print(f'{label}: FAILED: {e}')
    del ranks
  if 'sgd' in PHASE33_RUN:
    ranks = load('sgd')
    # Each round's alltoall route sums the rank's duplicates (kernel 4).
    for r, rec in enumerate(ranks):
      _expect(f'phase 33, {world} ranks, sgd, rank {r}', rec['counts'],
              scatter_add_sorted=PHASE33_SGD_ROUNDS,
              gsum_dense_sorted=PHASE33_SGD_ROUNDS)
      launches.update(rec['counts'])
      if rec['fallbacks']:
        raise AssertionError(f'phase 33, sgd, rank {r}: fallbacks '
                             f'{rec["fallbacks"]}')
    err = _hold_sgd33(f'phase 33, {world} ranks, sgd', dev, ranks,
                      SHARDED_FLAGS)
    _print_lists(f'phase 33, {world} ranks, sgd', ranks)
    print(f'phase 33, {world} ranks, sgd: {PHASE33_SGD_ROUNDS} rounds of '
          'sparse_sgd_apply on the flagship list against the world of '
          f'one: table max abs err {err:.3e}; scatter_add_sorted '
          f'{PHASE33_SGD_ROUNDS} times on each rank')
    del ranks
  print(f'phase 33, {world} ranks on {smi}: ms/step of rank 0 over '
        f'{PHASE33_TIMED} steps (CUDA events): {", ".join(times)} -- '
        'gloo ranks sharing one card, through the host, beside the other '
        'worlds\' launches: not NCCL, not NVLink, not a multi-GPU number; '
        f'launched {launch_s:.1f} s after the phase began, held against '
        f'the world of one in {time.perf_counter() - t0:.1f} s')


PHASE34_WORLD = 2           # the gloo ranks sharing the card
PHASE34_STEPS = 6           # SparseTrainer's steps, a checkpoint at
PHASE34_SAVE = 3            # this step (and at the end)
PHASE34_CACHED_STEPS = 8    # the cached trainer's steps, a checkpoint at
PHASE34_CACHED_SAVE = 4     # this step (and at the end)
PHASE34_CACHE_SEED = 42     # the host table's draws (the Criteo example's)
PHASE34_DENSE_STEPS = 3     # the dense Trainer's steps
PHASE34_SHORT = 1000        # rows of the last eval batch, rank 0's alone
                            # (at most half a rank's rows)
PHASE34_NCCL_STEPS = 2      # the NCCL world of one's SparseTrainer steps
PHASE34_SEED = tb.SEED + 34
PHASE34_LAUNCH_S = 600
PHASE34_GROUPS = 256        # GAUC's groups: the c1 id modulo this
PHASE34_TOL = dict(loss=1e-6, state=1e-7, served=1e-6, eval_loss=1e-5)


def _phase34_batch(cfg, seed, rows=slice(None), i=0):
  """The harness's seeded batch of ``seed`` moved by ``i`` (``shifted``),
  of ``rows``, as host tensors, with the group column ``g``."""
  base, ids = tb.make_batch(cfg, torch.device('cpu'), seed, rows=rows)
  b = {k: v.contiguous() for k, v in tb.shifted(base, ids, cfg.vocab,
                                                 i).items()}
  b['g'] = b['c1'] % PHASE34_GROUPS
  return b


def _phase34_train(cfg, rows=slice(None)):
  return [_phase34_batch(cfg, PHASE34_SEED, rows, i)
          for i in range(PHASE34_STEPS)]


def _phase34_evals(cfg, world):
  """Each rank's eval batches: two of the global batch's rows each, then
  ``PHASE34_SHORT`` rows on rank 0 alone (the others have run out)."""
  per = cfg.batch // world
  short = min(PHASE34_SHORT, per // 2)
  out = []
  for r in range(world):
    own = [_phase34_batch(cfg, PHASE34_SEED + 100 + k,
                          slice(r * per, (r + 1) * per)) for k in range(2)]
    if r == 0:
      own.append(_phase34_batch(cfg, PHASE34_SEED + 102, slice(0, short)))
    out.append(own)
  return out


def _phase34_global_evals(evals):
  """The global eval batches: each step's ranks' batches in rank order."""
  steps = max(len(e) for e in evals)
  return [{k: torch.cat([e[s][k] for e in evals if s < len(e)])
           for k in evals[0][0]} for s in range(steps)]


def _net_values(net, opt):
  """``net``'s weights and Adam's ``(exp_avg, exp_avg_sq, step)``, CPU
  copies by name (``_tower_values`` of any tower and optimizer)."""
  state = opt.state
  return {n: (p.detach().cpu().clone(), state[p]['exp_avg'].cpu().clone(),
              state[p]['exp_avg_sq'].cpu().clone(), float(state[p]['step']))
          for n, p in net.named_parameters()}


def _load_net(net, opt, values):
  """``values`` (``_net_values``) into ``net`` and its Adam, in place."""
  state = opt.state
  with torch.no_grad():
    for n, p in net.named_parameters():
      w, m, v, t = values[n]
      p.copy_(w)
      state[p]['exp_avg'].copy_(m)
      state[p]['exp_avg_sq'].copy_(v)
      state[p]['step'].fill_(t)


def _phase34_trainer(cfg, dev, ctx=None, model_dir=None):
  """The flagship DCNv2 + Adagrad ``SparseTrainer`` of the harness's
  weights, with GAUC over ``g``; in the world ``ctx``, its shards."""
  import hybridbackend_tpu_torch as hbt
  fx, tables, tower, model_loss = tb.sparse_parts(cfg, dev, ctx)
  return fx, hbt.SparseTrainer(
      fx, model_loss, tower, tables=tables,
      dense_optimizer=functools.partial(torch.optim.Adam, lr=tb.TOWER_LR),
      table_lr=tb.TABLE_LR, adagrad_init=tb.ADAGRAD_INIT,
      model_dir=model_dir, group_key='g')


def _sparse_state(fx, tr):
  """The trainer's tables, accumulators (gathered whole) and tower, on
  the CPU (a collective in a world)."""
  import hybridbackend_tpu_torch as hbt
  (name,) = tr.state.tables
  return {'table': hbt.gather_tables(fx, tr.state.tables)[name].cpu(),
          'acc': hbt.gather_slots(fx, tr.state.table_opt)[name][0].cpu(),
          'tower': _tower_values(tr.state)}


def _dense_state(module, optimizer, ctx):
  """The dense Trainer's tables and Adagrad accumulators (gathered whole
  in a world), on the CPU, and its tower with Adam's moments."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.distribute import collective
  out = {'tables': {}, 'acc': {}}
  for name, t in module['tables'].items():
    acc = optimizer.state[t]['sum_of_squares']
    if hbt.table_shard(t) is not None:
      t, acc = (collective.allgather(x.detach(), ctx=ctx) for x in (t, acc))
    out['tables'][name] = t.detach().cpu()
    out['acc'][name] = acc.cpu()
  out['tower'] = _net_values(module['net'], optimizer)
  return out


def _phase34_cached_slots(cfg):
  """The cached members and their slots, evictions from step 3 on (at the
  flagship's batch about 7250 new ids a step): ``c0``'s 2 slots a row of
  the global batch (16384) lie in rank 0's rows of the stack; the middle
  member's 2.5 (``c13``'s 20480), more than ``c0``'s, straddle the split
  of an even number of tables (at 1218432 of the flagship's 2436864
  rows, 2048 slots into ``c13``'s), so that both ranks own evicted and
  flushed rows."""
  return {'c0': 2 * cfg.batch, f'c{cfg.tables // 2}': 5 * cfg.batch // 2}


def _phase34_cached(cfg, dev, ctx=None, model_dir=None):
  """The flagship DCNv2 + Adagrad ``SparseTrainer`` of the harness's
  weights with the members of ``_phase34_cached_slots`` in host DRAM (values
  ``0.01 * randn`` from ``RandomState(42)`` and the accumulator, as the
  Criteo example draws them, in that order) behind caches of their
  slots; in the world ``ctx``, every rank the same host tables and
  caches. Returns ``(trainer, caches, host tables)``, the last two by
  member."""
  import hybridbackend_tpu_torch as hbt
  ctx = ctx or hbt.Context(dev)
  rng = np.random.RandomState(PHASE34_CACHE_SEED)
  hosts, caches = {}, {}
  for col, slots in _phase34_cached_slots(cfg).items():
    hosts[col] = {
        'value': (rng.randn(cfg.vocab, cfg.dim) * 0.01).astype(np.float32),
        'slot0': np.full((cfg.vocab, cfg.dim), tb.ADAGRAD_INIT, np.float32)}
    caches[col] = hbt.EmbeddingCache(
        hbt.TableConfig(col, cfg.vocab, cfg.dim), slots,
        host_tables=hosts[col], ctx=ctx)
  specs = [hbt.EmbeddingSpec(caches[s.key].slot_config(), column=s.key)
           if s.key in caches else s for s in tb._specs(cfg)]
  fx = hbt.StackedFeatureExtractor(
      specs, dense_columns=[f'i{d}' for d in range(cfg.dense_features)],
      ctx=ctx)
  gen = torch.Generator().manual_seed(tb.SEED)
  tables = fx.init(gen)
  tower, preds = tb._tower(cfg, ctx.device, gen)
  tr = hbt.SparseTrainer(
      fx, lambda t, e, d, b: tb.bce(preds(t, e, d), b['label']), tower,
      tables=tables,
      dense_optimizer=functools.partial(torch.optim.Adam, lr=tb.TOWER_LR),
      table_lr=tb.TABLE_LR, adagrad_init=tb.ADAGRAD_INIT,
      model_dir=model_dir, caches=caches)
  return tr, caches, hosts


def _cache_meta(caches):
  """The caches' slot metadata, copied into tensors: each slot's id, its
  last use, the free list, of each cache in turn."""
  return tuple(torch.from_numpy(a.copy()) for cache in caches.values()
               for a in (cache._slot_to_id, cache._last_used,
                         cache._free[:cache._n_free]))


def _host_tensors(hosts):
  """The host tables of ``_phase34_cached`` as tensors, keyed
  ``<member>/<array>``."""
  return {f'{col}/{k}': torch.from_numpy(v)
          for col, host in hosts.items() for k, v in sorted(host.items())}


def _phase34_cached_train(cfg, rows=slice(None)):
  return [_phase34_batch(cfg, PHASE34_SEED, rows, i)
          for i in range(PHASE34_CACHED_STEPS)]


class _GatherHold:
  """While installed, runs every kernel 5 call that ``embedding/
  service.py`` makes (the owners' evicted and flushed rows) and holds its
  rows against ``index_select`` of the same table, bit for bit."""

  def __init__(self):
    from hybridbackend_tpu_torch.embedding import service
    self.module, self.kernel = service, service.gather_rows
    self.calls, self.rows, self.differ = 0, 0, 0

  def __enter__(self):
    self.module.gather_rows = self._call
    return self

  def __exit__(self, *exc):
    self.module.gather_rows = self.kernel

  def _call(self, table, ids):
    got = self.kernel(table, ids)
    want = table.index_select(0, ids.long().clamp(0, table.shape[0] - 1))
    self.calls += 1
    self.rows += ids.numel()
    self.differ += int((got != want).any(dim=-1).sum())
    return got


def _phase34_cached_rank(ctx, cfg, out):
  """Phase 34's cached case on a rank: the cached trainer's 8 steps of
  the rank's rows (a checkpoint at step 4 into ``DIR/cached_ckpt``),
  each step's loss, metadata and rank 0's tower; the last step's update
  calls held on the rank's received list, every kernel 5 call on the
  owners' rows held (``_GatherHold``); each cached member's slots that
  the rank's shard holds; whether every rank's storage is rank 0's; the
  export into ``DIR/cached_bundle``. Rank 0 writes its host tables to
  ``DIR/cached_host.pt``."""
  import hybridbackend_tpu_torch as hbt
  dev = ctx.device
  tr, caches, hosts = _phase34_cached(cfg, dev, ctx,
                                      os.path.join(out, 'cached_ckpt'))
  rec = {'loss': [], 'tower': [], 'meta': [], 'owned': {}}
  for col, slots in _phase34_cached_slots(cfg).items():
    _, off, shard = tr._cache_runner._loc[col]
    rows = ctx.rows(shard.rows)   # the rank's rows of the stack
    rec['owned'][col] = max(0, min(rows.stop, off + slots)
                            - max(rows.start, off))

  class _Record(hbt.Hook):
    def before_step(self, step):
      capture.armed = step == PHASE34_CACHED_STEPS - 1

    def after_step(self, step, metrics):
      capture.armed = False
      rec['loss'].append(float(metrics['loss']))
      rec['meta'].append(_cache_meta(caches))
      if ctx.rank == 0:
        rec['tower'].append(_tower_values(tr.state))

  with _ListCapture() as capture, _GatherHold() as gathers:
    _reset_counts()
    tr.train(_phase34_cached_train(cfg, ctx.rows(cfg.batch)),
             hooks=[_Record()], save_checkpoint_steps=PHASE34_CACHED_SAVE)
    if dev.type == 'cuda':
      torch.cuda.synchronize(dev)
    rec['counts'] = _counts()
    rec['lists'] = _hold_lists(capture.take())
  rec['gathers'] = dict(calls=gathers.calls, rows=gathers.rows,
                        differ=gathers.differ)
  rec['stats'] = {col: {k: v for k, v in cache.stats.items()
                        if not k.endswith('_s')}
                  for col, cache in caches.items()}
  host = _host_tensors(hosts)
  rec['storage_equal'] = _ranks_agree(
      ctx, [v.to(dev) for v in host.values()])
  if ctx.rank == 0:
    torch.save(host, os.path.join(out, 'cached_host.pt'))
  evals = _phase34_evals(cfg, ctx.world_size)[ctx.rank]
  tr.export_saved_model(os.path.join(out, 'cached_bundle'), {
      k: v[:8] for k, v in evals[0].items()}, poly_batch=True)
  return rec


def phase34_rank(out, device, spec):
  """One rank of phase 34 (``chip_smoke.py --rank-of DIR`` with
  ``{"phase": 34}``): the flagship ``SparseTrainer`` on its shards, 6
  steps through ``DeviceIterator`` with a checkpoint at step 3 into
  ``DIR/ckpt``, each step's loss, rank 0's tower after each, the last
  step's update calls held on the rank's received lists; ``evaluate``
  and ``predict`` on its eval batches; the export into ``DIR/bundle``;
  then the dense ``Trainer`` with row-sharded tables, 3 steps; then the
  cached case (``_phase34_cached_rank``). Rank 0 writes the gathered
  states at steps 3 and 6 and after the dense steps, and every rank its
  record, to ``DIR/34.<rank>.pt``."""
  import hybridbackend_tpu_torch as hbt
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  ctx = hbt.Context.join(device)
  try:
    dev, cfg = ctx.device, flagship(*spec['flags'])
    fx, tr = _phase34_trainer(cfg, dev, ctx, os.path.join(out, 'ckpt'))
    rec = {'loss': [], 'tower': [], 'dense_loss': [], 'dense_tower': []}

    class _Record(hbt.Hook):
      def before_step(self, step):
        capture.armed = step == PHASE34_STEPS - 1

      def after_step(self, step, metrics):
        capture.armed = False
        rec['loss'].append(float(metrics['loss']))
        if ctx.rank == 0:
          rec['tower'].append(_tower_values(tr.state))
        if step in (PHASE34_SAVE, PHASE34_STEPS):
          state = _sparse_state(fx, tr)
          if ctx.rank == 0:
            torch.save(state, os.path.join(out, f'state{step}.pt'))

    with _ListCapture() as capture:
      _reset_counts()
      tr.train(_phase34_train(cfg, ctx.rows(cfg.batch)), hooks=[_Record()],
               prefetch=True, save_checkpoint_steps=PHASE34_SAVE)
      if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
      rec['counts'] = _counts()
      rec['lists'] = _hold_lists(capture.take())
    evals = _phase34_evals(cfg, ctx.world_size)[ctx.rank]
    rec['eval'] = tr.evaluate(evals, prefetch=True)
    rec['preds'] = [p.cpu() for p in tr.predict(evals, prefetch=True)]
    rec['tower_equal'] = _ranks_agree(
        ctx, [p for p in tr.state.dense.parameters()])
    t0 = time.perf_counter()
    tr.export_saved_model(os.path.join(out, 'bundle'), {
        k: v[:8] for k, v in evals[0].items()}, poly_batch=True)
    rec['export_s'] = time.perf_counter() - t0
    del tr, fx
    loss_fn, module, optimizer = tb.dense_parts(cfg, dev, ctx)
    dtr = hbt.Trainer(loss_fn, module, optimizer, ctx=ctx)

    class _DenseRecord(hbt.Hook):
      def after_step(self, step, metrics):
        rec['dense_loss'].append(float(metrics['loss']))
        if ctx.rank == 0:
          rec['dense_tower'].append(_net_values(module['net'], optimizer))

    _reset_counts()
    dtr.train(_phase34_train(cfg, ctx.rows(cfg.batch))[:PHASE34_DENSE_STEPS],
              hooks=[_DenseRecord()])
    if dev.type == 'cuda':
      torch.cuda.synchronize(dev)
    rec['dense_counts'] = _counts()
    rec['dense_sharded'] = sum(hbt.table_shard(t) is not None
                               for t in module['tables'].values())
    rec['dense_tower_equal'] = _ranks_agree(
        ctx, [p for p in module.parameters() if hbt.table_shard(p) is None])
    state = _dense_state(module, optimizer, ctx)
    if ctx.rank == 0:
      torch.save(state, os.path.join(out, 'dense_state.pt'))
    del dtr, module, optimizer
    rec['cached'] = _phase34_cached_rank(ctx, cfg, out)
    rec['device'] = str(dev)
    rec['backend'] = torch.distributed.get_backend()
    torch.save(rec, os.path.join(out, f'34.{ctx.rank}.pt'))
  finally:
    ctx.leave()
  return 0


def _ranks_agree(ctx, tensors):
  """Whether every rank holds rank 0's ``tensors``, bit for bit."""
  import hybridbackend_tpu_torch as hbt
  flat = torch.cat([t.detach().reshape(-1) for t in tensors])
  return bool(torch.equal(flat, hbt.distribute.broadcast(flat, 0, ctx=ctx)))


def _close34(label, got, want, tol, report, key):
  err = float((got.float() - want.float()).abs().max())
  report[key] = max(report.get(key, 0.0), err)
  if err > tol:
    raise AssertionError(f'{label}: {err} apart, more than {tol}')


def _hold_step34(label, tr, batch, before, after, rank_loss, report,
                 apart_in):
  """One world-of-one step of ``tr`` from rank 0's tower (and Adam's
  moments) ``before``, against the world's loss and rank 0's tower
  ``after``: the loss to 1e-6 relative, the tower by phase 18's rule
  (``_hold_tower``, the world's rank 0 on the card's side of it)."""
  from hybridbackend_tpu_torch.training.optimizer import init_state
  state = tr.state
  init_state(state.dense_opt)
  _load_net(state.dense, state.dense_opt, before)
  one = tr.train(iter([batch]))['loss']
  rel = abs(rank_loss - one) / abs(one)
  report['loss_rel_err'] = max(report['loss_rel_err'], rel)
  if rel > PHASE34_TOL['loss']:
    raise AssertionError(f'{label}: loss {rank_loss}, a world of one {one}')
  group = state.dense_opt.param_groups[0]
  adam = (group['lr'], *group['betas'], group['eps'])
  names = [n for n, _ in state.dense.named_parameters()]
  nets = []
  for values in (after, _tower_values(state)):
    net = tb._tower(flagship(*SHARDED_FLAGS), torch.device('cpu'),
                    torch.Generator())[0]
    opt = {}
    with torch.no_grad():
      for n, p in net.named_parameters():
        w, m, v, t = values[n]
        p.copy_(w)
        opt[p] = {'exp_avg': m, 'exp_avg_sq': v, 'step': torch.tensor(t)}
    nets.append((net, opt))
  (g_net, g_opt), (c_net, c_opt) = nets
  _hold_tower(label, g_net, c_net, g_opt, c_opt,
              [before[n][:2] for n in names], [before[n][2] for n in names],
              adam, report, apart_in)
  either_sign = (max(report['their_largest_grad_of_max_card'],
                     report['their_largest_grad_of_max_cpu']) <= 1e-3
                 and report['tower_max_abs_err'] <= 2.2 * adam[0])
  if report['tower_weights_over_1e-4_apart'] and not either_sign:
    raise AssertionError(f'{label}: tower weights over 1e-4 apart: '
                         f'{report} in {sorted(apart_in)}')


def _phase34_nccl(cfg, dev, tmp):
  """The flagship ``SparseTrainer`` in a joined world of one on NCCL (on
  the CPU rehearsal, gloo): 2 steps, a checkpoint, an evaluation; its
  losses against the same trainer in no world, bit for bit, and kernel
  1's launches."""
  import hybridbackend_tpu_torch as hbt
  backend = 'nccl' if dev.type == 'cuda' else 'gloo'
  batches = _phase34_train(cfg)[:PHASE34_NCCL_STEPS]
  evals = _phase34_global_evals(_phase34_evals(cfg, 1))
  plain = _phase34_trainer(cfg, dev)[1]
  want = [plain.train(iter([b]))['loss'] for b in batches]
  want_eval = plain.evaluate(evals)
  del plain
  ctx = hbt.Context.join(str(dev), backend, rank=0, world_size=1,
                         init_method=f'file://{tmp}/store', timeout_s=120)
  try:
    _, tr = _phase34_trainer(cfg, ctx.device, ctx, os.path.join(tmp, 'nccl'))
    _reset_counts()
    got = [tr.train(iter([b]))['loss'] for b in batches]
    if dev.type == 'cuda':
      torch.cuda.synchronize(dev)
    counts = _counts()
    got_eval = tr.evaluate(evals)
    steps = tr._ckpt.all_steps()
  finally:
    ctx.leave()
  _expect('phase 34, the NCCL world of one', counts,
          adagrad_update_sorted=PHASE34_NCCL_STEPS)
  if got != want or got_eval != want_eval or steps != [1, 2]:
    raise AssertionError(f'phase 34, the {backend} world of one: losses '
                         f'{got} against {want}, eval {got_eval} against '
                         f'{want_eval}, checkpoints {steps}')
  return backend, counts, got


def phase34_trainers(dev, smi):
  """Phase 34: the trainers at a world of N (see the module docstring).
  Returns the kernel launches of the world's runs (the ranks' training
  steps, the NCCL world of one's, and the served bundle's predicts), and
  those of the ranks' cached case (kernel 1's steps and kernel 5's
  evicted and flushed rows, summed over the ranks)."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch import metrics as hbm
  t_phase = time.perf_counter()
  cfg = flagship(*SHARDED_FLAGS)
  launches, cached_launches = collections.Counter(), collections.Counter()
  report = {'loss_rel_err': 0.0, **_tower_report()}
  apart_in = set()
  with tempfile.TemporaryDirectory() as out:
    cmd = [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
           str(PHASE34_WORLD), '--device', SHARDED_DEVICE, '--timeout',
           str(PHASE34_LAUNCH_S), os.path.join(HERE, 'chip_smoke.py'),
           '--rank-of', out, '--rank-device', SHARDED_DEVICE,
           '--rank-flags', json.dumps(dict(phase=34,
                                           flags=list(SHARDED_FLAGS)))]
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    # The NCCL world of one meanwhile, in this process.
    try:
      backend, counts, nccl_losses = _phase34_nccl(cfg, dev, out)
    finally:
      stdout, stderr = proc.communicate(timeout=PHASE34_LAUNCH_S + 60)
    launch_s = time.perf_counter() - t0
    if proc.returncode != 0:
      raise RuntimeError(f'phase 34: the world of {PHASE34_WORLD} exited '
                         f'{proc.returncode}:\n{stderr[-4000:]}')
    launches.update(counts)
    ranks = [torch.load(os.path.join(out, f'34.{r}.pt'))
             for r in range(PHASE34_WORLD)]
    t0 = time.perf_counter()
    for r, rec in enumerate(ranks):
      # The alltoall update sums the rank's duplicates (kernel 4) before
      # kernel 1; each dense step's 26 sharded tables take their
      # gradients through kernel 4 (the exchange's transpose).
      _expect(f'phase 34, rank {r}', rec['counts'],
              adagrad_update_sorted=PHASE34_STEPS,
              gsum_dense_sorted=PHASE34_STEPS)
      _expect(f'phase 34, rank {r}, the dense Trainer', rec['dense_counts'],
              gsum_dense_sorted=PHASE34_DENSE_STEPS * cfg.tables)
      launches.update(rec['counts'])
      launches.update(rec['dense_counts'])
      _dense_backward(rec['dense_counts'])
      for held in rec['lists']:
        _expect(f'phase 34, rank {r}, its received list', held['counts'],
                **{held['kernel']: 1})
        if held['problem']:
          raise AssertionError(f'phase 34, rank {r}: {held}')
      if not (rec['tower_equal'] and rec['dense_tower_equal']):
        raise AssertionError(f'phase 34: rank {r}\'s replicated parameters '
                             'are not rank 0\'s')
      for key in ('loss', 'dense_loss', 'eval'):
        if rec[key] != ranks[0][key]:
          raise AssertionError(f'phase 34: the ranks report {key} '
                               f'{rec[key]} and {ranks[0][key]}')
      if rec['dense_sharded'] != cfg.tables:
        raise AssertionError(f'phase 34: {rec["dense_sharded"]} of the '
                             'dense tables are row-sharded')
    rec0 = ranks[0]
    train = _phase34_train(cfg)
    # Steps 1 to PHASE34_SAVE: the world of one from the seed, each step
    # from rank 0's tower; its state then against the world's.
    init = _phase34_trainer(cfg, dev)[1]
    initial = _tower_values(init.state)
    for i in range(PHASE34_SAVE):
      before = initial if i == 0 else rec0['tower'][i - 1]
      _hold_step34(f'phase 34, step {i + 1}', init, train[i], before,
                   rec0['tower'][i], rec0['loss'][i], report, apart_in)
    state4 = torch.load(os.path.join(out, f'state{PHASE34_SAVE}.pt'))
    (name,) = init.state.tables
    _close34(f'phase 34, step {PHASE34_SAVE}, table',
             init.state.tables[name].cpu(), state4['table'],
             PHASE34_TOL['state'], report, 'table_err')
    _close34(f'phase 34, step {PHASE34_SAVE}, accumulator',
             init.state.table_opt[name].acc[0].cpu(), state4['acc'],
             PHASE34_TOL['state'], report, 'acc_err')
    del init
    # The world's checkpoint of step PHASE34_SAVE restored at a world of
    # one, bit for bit; the steps after it from it against the world's.
    ckpt = os.path.join(out, 'one')
    os.makedirs(ckpt)
    shutil.copytree(os.path.join(out, 'ckpt', f'checkpoint-{PHASE34_SAVE}'),
                    os.path.join(ckpt, f'checkpoint-{PHASE34_SAVE}'))
    _, tr = _phase34_trainer(cfg, dev, model_dir=ckpt)
    restored = {'table': tr.state.tables[name].cpu(),
                'acc': tr.state.table_opt[name].acc[0].cpu(),
                'tower': _tower_values(tr.state)}
    bitwise = (tr.global_step == PHASE34_SAVE
               and torch.equal(restored['table'], state4['table'])
               and torch.equal(restored['acc'], state4['acc'])
               and all(all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                           else a == b for a, b in zip(v, state4['tower'][n]))
                       for n, v in restored['tower'].items()))
    if not bitwise:
      raise AssertionError(f'phase 34: the checkpoint of step {PHASE34_SAVE} '
                           'restored at a world of one is not the world\'s '
                           'state')
    tr._ckpt = None          # the copy is the world's, not this run's
    for i in range(PHASE34_SAVE, PHASE34_STEPS):
      _hold_step34(f'phase 34, step {i + 1}', tr, train[i],
                   rec0['tower'][i - 1], rec0['tower'][i], rec0['loss'][i],
                   report, apart_in)
    state8 = torch.load(os.path.join(out, f'state{PHASE34_STEPS}.pt'))
    _close34(f'phase 34, step {PHASE34_STEPS}, table',
             tr.state.tables[name].cpu(), state8['table'],
             PHASE34_TOL['state'], report, 'table_err')
    _close34(f'phase 34, step {PHASE34_STEPS}, accumulator',
             tr.state.table_opt[name].acc[0].cpu(), state8['acc'],
             PHASE34_TOL['state'], report, 'acc_err')
    # Evaluation: the world of one from rank 0's last tower, on the global
    # eval batches, against every rank's result.
    _load_net(tr.state.dense, tr.state.dense_opt, rec0['tower'][-1])
    evals = _phase34_global_evals(_phase34_evals(cfg, PHASE34_WORLD))
    one_eval = tr.evaluate(evals)
    one_preds = torch.cat([p.cpu().reshape(-1) for p in tr.predict(evals)])
    per_rank = [[p.reshape(-1) for p in rec['preds']] for rec in ranks]
    world_preds = torch.cat([p for s in range(len(evals))
                             for p in (r[s] for r in per_rank if s < len(r))])
    labels = torch.cat([b['label'] for b in evals])
    groups = torch.cat([b['g'] for b in evals])
    auc_lim, _, gap = hbm.auc_limit(world_preds, one_preds, labels)
    gauc_lim, _ = _gauc_limit(world_preds, one_preds, labels, groups,
                              cfg.batch)
    got = rec0['eval']
    eval_err = {'auc': abs(got['auc'] - one_eval['auc']),
                'gauc': abs(got['gauc'] - one_eval['gauc']),
                'loss': abs(got['loss'] - one_eval['loss']) / one_eval['loss']}
    if (eval_err['auc'] > auc_lim or eval_err['gauc'] > gauc_lim
        or eval_err['loss'] > PHASE34_TOL['eval_loss']
        or got['batches'] != one_eval['batches'] != len(evals)):
      raise AssertionError(f'phase 34: the world evaluates {got}, a world of '
                           f'one {one_eval} (AUC limit {auc_lim}, GAUC '
                           f'limit {gauc_lim})')
    # The world's bundle, loaded cold, against the world of one.
    served = hbt.Served(os.path.join(out, 'bundle'), dev)
    _reset_counts()
    served_preds = torch.cat([torch.from_numpy(np.asarray(served.predict(
        {k: v.numpy() for k, v in b.items()})).reshape(-1)) for b in evals])
    if dev.type == 'cuda':
      torch.cuda.synchronize(dev)
    counts = _counts()
    _expect('phase 34, the served bundle', counts,
            gather_rows=cfg.tables * len(evals))
    launches.update(counts)
    _close34('phase 34, served', served_preds, one_preds,
             PHASE34_TOL['served'], report, 'served_err')
    del tr, served
    # The dense Trainer: the world of one's 3 steps, each from rank 0's
    # tower, against the world's losses and gathered tables.
    loss_fn, module, optimizer = tb.dense_parts(cfg, dev)
    dtr = hbt.Trainer(loss_fn, module, optimizer, ctx=hbt.Context(dev))
    dense_report = {'loss_rel_err': 0.0}
    initial = _net_values(module['net'], optimizer)
    for i in range(PHASE34_DENSE_STEPS):
      _load_net(module['net'], optimizer,
                initial if i == 0 else rec0['dense_tower'][i - 1])
      one = dtr.train(iter([train[i]]))['loss']
      rel = abs(rec0['dense_loss'][i] - one) / abs(one)
      dense_report['loss_rel_err'] = max(dense_report['loss_rel_err'], rel)
      if rel > PHASE34_TOL['loss']:
        raise AssertionError(f'phase 34, dense step {i + 1}: loss '
                             f'{rec0["dense_loss"][i]}, a world of one {one}')
    dense = torch.load(os.path.join(out, 'dense_state.pt'))
    one_dense = _dense_state(module, optimizer, None)
    for key in ('tables', 'acc'):
      for n, t in one_dense[key].items():
        _close34(f'phase 34, dense {key} {n}', t, dense[key][n],
                 PHASE34_TOL['state'], dense_report, f'{key}_err')
    del dtr, module, optimizer
    cached_report, cached_apart, cached = _hold_cached34(
        cfg, dev, out, ranks, cached_launches)
    check_s = time.perf_counter() - t0
  lists = [(h['kernel'], h['entries'], h['pad'], h['err'])
           for rec in ranks for h in rec['lists']]
  print(f'phase 34 (the trainers at a world of {PHASE34_WORLD}, gloo ranks '
        f'sharing the card, against the world of one on it, each step from '
        f'rank 0\'s tower): SparseTrainer {PHASE34_STEPS} steps through '
        'DeviceIterator, a checkpoint at step '
        f'{PHASE34_SAVE}: ' + ', '.join(
            f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
            for k, v in report.items())
        + f' (in {", ".join(sorted(apart_in)) or "none"}); the step-'
        f'{PHASE34_SAVE} checkpoint restored at a world of one bit for bit, '
        f'steps {PHASE34_SAVE + 1}-{PHASE34_STEPS} on from it; kernel 1 '
        f'{PHASE34_STEPS} times on each rank, on the last step\'s received '
        f'lists (kernel, entries, -1 lanes, max abs err) {lists}')
  print(f'phase 34: evaluate ({len(evals)} batches, the last '
        f'{len(evals[-1]["label"])} rows on rank 0 alone): the world {got}, '
        f'a world of one {one_eval}; '
        f'|AUC| {eval_err["auc"]:.3e} (limit {auc_lim:.3e}, predictions '
        f'{gap:.3e} apart), |GAUC| {eval_err["gauc"]:.3e} (limit '
        f'{gauc_lim:.3e}), loss {eval_err["loss"]:.3e} relative; the '
        f'world\'s bundle (export {rec0["export_s"]:.1f} s on rank 0) served '
        f'cold: {report["served_err"]:.3e} from the world of one\'s '
        f'predictions, kernel 5 {cfg.tables * len(evals)} times')
  print(f'phase 34: the dense Trainer, {cfg.tables} row-sharded tables, '
        f'{PHASE34_DENSE_STEPS} steps against the world of one: ' + ', '.join(
            f'{k} {v:.3e}' for k, v in dense_report.items())
        + '; every rank\'s replicated parameters rank 0\'s, bit for bit '
        f'(both trainers); the {backend} world of one\'s SparseTrainer, '
        f'{PHASE34_NCCL_STEPS} steps: losses {nccl_losses}, bit for bit '
        f'those of no world; launch {launch_s:.1f} s, checks '
        f'{check_s:.1f} s, phase {time.perf_counter() - t_phase:.1f} s '
        f'on {smi}')
  lists = [(h['kernel'], h['entries'], h['pad'], h['err'])
           for rec in ranks for h in rec['cached']['lists']]
  print(f'phase 34, cached ({", ".join(_phase34_cached_slots(cfg))} '
        f'[{cfg.vocab}, {cfg.dim}] in host DRAM behind '
        f'{_phase34_cached_slots(cfg)} slots, the slots '
        f'each rank\'s shard holds {cached["owned"]}, '
        f'{PHASE34_CACHED_STEPS} steps, a checkpoint at step '
        f'{PHASE34_CACHED_SAVE}, against the cached world '
        'of one on the card, each step from rank 0\'s tower): ' + ', '.join(
            f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
            for k, v in cached_report.items())
        + f' (in {", ".join(sorted(cached_apart)) or "none"}); each rank\'s '
        'slot metadata bit for bit the other ranks\' and the world of '
        f'one\'s after each step; cache {cached["stats"]}; every rank\'s '
        'storage bit for bit rank 0\'s; kernel 5 on the owners\' evicted '
        f'and flushed rows (calls, rows, rows apart from index_select) by '
        f'rank {cached["gathers"]}; kernel 1 {PHASE34_CACHED_STEPS} times on '
        f'each rank, on the last step\'s received lists (kernel, entries, '
        f'-1 lanes, max abs err) {lists}; launches {dict(cached_launches)}')
  return launches, cached_launches


def _hold_cached34(cfg, dev, out, ranks, launches):
  """Phase 34's cached case (``_phase34_cached_rank``) against the cached
  world of one on the card, each step from rank 0's tower: the ranks'
  launches, held lists, kernel 5's holds, losses and metadata against
  each other; each step's loss (to 1e-6) and metadata (bit for bit)
  against the world of one's; the flushed host tables to 1e-7; the
  world's bundle against the world of one's, served on the card, to
  1e-6. The middle cached member's slots must straddle the ranks' shards
  (``c13``'s), and every rank
  must have read its evicted or flushed rows through kernel 5. Adds the
  ranks' launches to ``launches``; returns the report, the tower's
  names past 1e-4, and the caches' stats, the slots each rank owns and
  kernel 5's holds."""
  import hybridbackend_tpu_torch as hbt
  recs = [r['cached'] for r in ranks]
  straddles = list(_phase34_cached_slots(cfg))[-1]
  for r, rec in enumerate(recs):
    _expect(f'phase 34, cached, rank {r}', rec['counts'],
            adagrad_update_sorted=PHASE34_CACHED_STEPS,
            gsum_dense_sorted=PHASE34_CACHED_STEPS,
            gather_rows=rec['gathers']['calls'])
    launches.update(rec['counts'])
    for held in rec['lists']:
      _expect(f'phase 34, cached, rank {r}, its received list',
              held['counts'], **{held['kernel']: 1})
      if held['problem']:
        raise AssertionError(f'phase 34, cached, rank {r}: {held}')
    if rec['gathers']['differ'] or not rec['storage_equal']:
      raise AssertionError(f'phase 34, cached, rank {r}: kernel 5 '
                           f'{rec["gathers"]}, storage equal '
                           f'{rec["storage_equal"]}')
    if rec['loss'] != recs[0]['loss'] or rec['stats'] != recs[0]['stats']:
      raise AssertionError(f'phase 34, cached: the ranks report '
                           f'{rec["loss"]} and {recs[0]["loss"]}')
    for i, (got, want) in enumerate(zip(rec['meta'], recs[0]['meta'])):
      if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f'phase 34, cached: rank {r}\'s slot metadata '
                             f'after step {i + 1} is not rank 0\'s')
  if not (all(st['evict_calls'] for st in recs[0]['stats'].values())
          and all(rec['gathers']['calls'] for rec in recs)
          and all(rec['owned'][straddles] for rec in recs)):
    raise AssertionError(
        f'phase 34, cached: a cache without an eviction, a rank without '
        f'kernel 5, or '
        f'{straddles} not straddling the shards: '
        f'{recs[0]["stats"]}, kernel 5 '
        f'{[rec["gathers"] for rec in recs]}, slots owned '
        f'{[rec["owned"] for rec in recs]}')
  report = {'loss_rel_err': 0.0, **_tower_report()}
  apart_in = set()
  tr, caches, hosts = _phase34_cached(cfg, dev)
  train = _phase34_cached_train(cfg)
  initial = _tower_values(tr.state)
  for i in range(PHASE34_CACHED_STEPS):
    rec0 = recs[0]
    _hold_step34(f'phase 34, cached, step {i + 1}', tr, train[i],
                 initial if i == 0 else rec0['tower'][i - 1],
                 rec0['tower'][i], rec0['loss'][i], report, apart_in)
    if not all(torch.equal(a, b)
               for a, b in zip(_cache_meta(caches), rec0['meta'][i])):
      raise AssertionError(f'phase 34, cached: the slot metadata after step '
                           f'{i + 1} is not the world of one\'s')
  tr._cache_runner.flush(tr.state)
  world_host = torch.load(os.path.join(out, 'cached_host.pt'))
  for name, table in _host_tensors(hosts).items():
    _close34(f'phase 34, cached, host {name}', table, world_host[name],
             PHASE34_TOL['state'], report,
             f'host_{name.replace("/", "_")}_err')
  batch = _phase34_global_evals(_phase34_evals(cfg, PHASE34_WORLD))[0]
  one = os.path.join(out, 'cached_one')
  tr.export_saved_model(one, {k: v[:8] for k, v in batch.items()},
                        poly_batch=True)
  host_batch = {k: v.numpy() for k, v in batch.items()}
  served = [torch.from_numpy(np.asarray(hbt.Served(path, dev).predict(
      host_batch))).reshape(-1)
      for path in (os.path.join(out, 'cached_bundle'), one)]
  _close34('phase 34, cached, served', served[0], served[1],
           PHASE34_TOL['served'], report, 'served_err')
  return report, apart_in, {'stats': recs[0]['stats'],
                            'owned': [rec['owned'] for rec in recs],
                            'gathers': [rec['gathers'] for rec in recs]}


PHASE35_WORLD, PHASE35_NODES = 4, 2   # gloo ranks sharing the card
PHASE35_STEPS = 3           # each case's steps held against the world of one
PHASE35_TIMED = 3           # and the steps timed after them
PHASE35_LAUNCH_S = 400
PHASE35_NCCL_STEPS = 2
# case -> phase 33's fields (harness flags, table optimizer, split-dense,
# the step's exchange options, the kernel its update launches, the
# (lookup, update) fallbacks a step), then the tables' partition.
# 'hierarchical_fallback': both bucket ratios so low that every lookup and
# update overflows, so the exact exchanges run on every step.
PHASE35_CASES = {
    'hierarchical': (('--lookup', 'hierarchical'), 'adagrad', False, {},
                     'adagrad_update_sorted', (0, 0), 'row'),
    'hierarchical_fallback': (
        ('--lookup', 'hierarchical'), 'adagrad', False,
        dict(lookup_bucket_ratio=0.01, update_bucket_ratio=0.01),
        'adagrad_update_sorted', (1, 1), 'row'),
    'gspmd': (('--lookup', 'gspmd'), 'adagrad', False, {},
              'adagrad_update_sorted', (0, 0), 'row'),
    'column_adagrad': ((), 'adagrad', False, {}, 'adagrad_update_sorted',
                       (0, 0), 'column'),
    'column_adam': (('--model', 'dlrm'), 'adam', False, {},
                    'adam_update_sorted', (0, 0), 'column'),
    # The interleaved step: each rank's 2048 rows in k micro-batches whose
    # lookups run on the side stream, one table update a step.
    'interleave': (('--lookup', 'alltoall', '--interleave', '2'), 'adagrad',
                   False, {}, 'adagrad_update_sorted', (0, 0), 'row'),
    'interleave_adam': (('--model', 'dlrm', '--lookup', 'hierarchical',
                         '--interleave', '4'), 'adam', False, {},
                        'adam_update_sorted', (0, 0), 'row'),
}
# The cases whose launches fill the kernels line's
# serving_interleave_launches column; the others fill exchanges_launches.
PHASE35_INTERLEAVE = ('interleave', 'interleave_adam')
# The world of one's step for a case: the plain one, or for a case named
# here the interleaved one in this many micro-batches. interleave_adam's
# 16 cut the global batch into the world's micro-batches (each rank's
# 2048 rows in 4 of 512), so that the tower runs the same 512-row GEMMs
# on both sides. Against the plain step's 8192-row GEMMs ReLU gates
# flip, and each flipped example moves its 26 rows' LazyAdam moments
# (416 elements) past the flip rule's share of one example's: the case
# is held against the plain step too, with the elements past the rule
# on the flipped examples' rows (``_gate_flips``).
PHASE35_ONE_INTERLEAVE = {'interleave_adam': 4 * PHASE35_WORLD}
# The NCCL world of one's cases, each against the same steps in no world:
# two of PHASE35_CASES, the interleaved step and phase 33's wire case
# (which casts nothing at a world of one).
PHASE35_NCCL = ('hierarchical', 'column_adagrad', 'interleave', 'wire')
PHASE35_SERVED = ('allgather', 'alltoall')   # float_serving's exchanges
PHASE35_SERVED_TOL = 1e-6   # phase 34's served


def _phase35_build(case, dev, ctx=None, flags=None):
  """A phase 35 case's (or phase 33's) harness flags, state, step and
  batch (the rank's rows of the global batch in the world ``ctx``), on
  ``SHARDED_FLAGS`` unless ``flags`` says otherwise."""
  if case in PHASE35_CASES:
    own, optimizer, split, exchange, _, _, partition = PHASE35_CASES[case]
  else:
    (own, optimizer, split, exchange, _, _), partition = (
        PHASE33_CASES[case], 'row')
  args = flagship(*(SHARDED_FLAGS if flags is None else flags), *own)
  state, step = tb.build(args, dev, optimizer, split, ctx=ctx,
                         partition=partition, **exchange)
  rows = ctx.rows(args.batch) if ctx is not None else slice(None)
  batch = functools.partial(tb.shifted, *tb.make_batch(
      args, dev, PHASE33_BATCH_SEED, rows=rows), args.vocab)
  return args, state, step, batch


def _phase35_serving(ctx, args, state, batch):
  """Sharded serving on a rank after the ``hierarchical`` case's steps,
  from the global batch's next rows: ``int8_serving``, its shard
  quantized (``quantize_table``) and its rows predicted through the
  sharded int8 stack (``lookup_raw(serving=True)``, kernel 5 on rows and
  scales) and the tower; ``float_serving``, ``lookup_raw(serving=True)``
  on the float shard under each of ``PHASE35_SERVED`` against the
  training lookup, bit for bit. Returns the shard, its int8 form, the
  embeddings and predictions, rank 0's tower, the comparisons and the
  kernel launches of each."""
  import hybridbackend_tpu_torch as hbt
  fx = hbt.StackedFeatureExtractor(
      tb._specs(args),
      dense_columns=[f'i{d}' for d in range(args.dense_features)], ctx=ctx)
  _, preds = tb._tower(args, torch.device('cpu'), torch.Generator())
  (name,) = state.tables
  b = batch(PHASE35_STEPS + PHASE35_TIMED)
  t0 = time.perf_counter()
  _reset_counts()
  with torch.no_grad():
    q = hbt.quantize_table(state.tables[name])
    raw, _, layouts = fx.lookup_raw({name: q}, b, serving=True)
    p = preds(state.dense, *fx.combine_from_raw(raw, layouts, b))
    if ctx.device.type == 'cuda':
      torch.cuda.synchronize(ctx.device)
    rec = {'int8_counts': _counts(), 'shard': state.tables[name].cpu(),
           'q': q.q.cpu(), 'scale': q.scale.cpu(), 'emb': raw[name].cpu(),
           'preds': p.cpu()}
    if ctx.rank == 0:
      rec['tower'] = {k: v.cpu() for k, v in state.dense.state_dict().items()}
    _reset_counts()
    rec['float_equal'] = {}
    for strategy in PHASE35_SERVED:
      served = fx.lookup_raw(state.tables, b, strategy, serving=True)[0]
      trained = fx.lookup_raw(state.tables, b, strategy)[0]
      rec['float_equal'][strategy] = bool(torch.equal(served[name],
                                                      trained[name]))
    if ctx.device.type == 'cuda':
      torch.cuda.synchronize(ctx.device)
  rec['float_counts'] = _counts()
  rec['seconds'] = time.perf_counter() - t0
  return rec


def phase35_rank(out, device, spec):
  """One rank of phase 35 (``chip_smoke.py --rank-of DIR`` with
  ``{"phase": 35}``), of ``PHASE35_NODES`` nodes: each case of
  ``PHASE35_CASES`` from the seed's state on its rows of the global
  batch, recorded by ``_run_record`` with its last held step's update
  calls held by ``_hold_lists`` and its seconds, to
  ``DIR/<case>.<rank>.pt``, and after the ``hierarchical`` case's steps
  the sharded serving (``_phase35_serving``) to
  ``DIR/serving.<rank>.pt``; then the
  dense ``Trainer`` through the hierarchical lookup, 3 steps, its losses
  and rank 0's tower after each, and the gathered tables and
  accumulators, to ``DIR/dense.<rank>.pt``. ``spec['flags']``: the
  harness flags (``SHARDED_FLAGS``)."""
  import hybridbackend_tpu_torch as hbt
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  ctx = hbt.Context.join(device)
  try:
    dev, flags = ctx.device, spec['flags']
    with _ListCapture() as capture:
      for case in PHASE35_CASES:
        t0 = time.perf_counter()
        args, state, step, batch = _phase35_build(case, dev, ctx, flags)
        optimizer, column = PHASE35_CASES[case][1], (
            PHASE35_CASES[case][6] == 'column')
        apply = (hbt.sparse_adam_apply if optimizer == 'adam'
                 else hbt.sparse_adagrad_apply)
        record = _run_record(ctx, state, step, batch, PHASE35_STEPS, apply,
                             PHASE35_TIMED, capture,
                             _every_state(optimizer, args), column)
        record['lists'] = _hold_lists(capture.take())
        (name,) = state.tables
        record['shard'] = tuple(state.tables[name].shape)
        record['seconds'] = time.perf_counter() - t0
        torch.save(record, os.path.join(out, f'{case}.{ctx.rank}.pt'))
        if case == 'hierarchical':
          torch.save(_phase35_serving(ctx, args, state, batch),
                     os.path.join(out, f'serving.{ctx.rank}.pt'))
        del state, step, record
    args = flagship(*flags, '--lookup', 'hierarchical')
    loss_fn, module, optimizer = tb.dense_parts(args, dev, ctx)
    dtr = hbt.Trainer(loss_fn, module, optimizer, ctx=ctx)
    rec = {'loss': [], 'tower': []}

    class _Record(hbt.Hook):
      def after_step(self, step, metrics):
        rec['loss'].append(float(metrics['loss']))
        if ctx.rank == 0:
          rec['tower'].append(_net_values(module['net'], optimizer))

    base, ids = tb.make_batch(args, torch.device('cpu'), PHASE33_BATCH_SEED,
                              rows=ctx.rows(args.batch))
    _reset_counts()
    dtr.train([tb.shifted(base, ids, args.vocab, i)
               for i in range(PHASE35_STEPS)], hooks=[_Record()])
    if dev.type == 'cuda':
      torch.cuda.synchronize(dev)
    rec['counts'] = _counts()
    rec['tower_equal'] = _ranks_agree(
        ctx, [p for p in module.parameters() if hbt.table_shard(p) is None])
    state = _dense_state(module, optimizer, ctx)
    if ctx.rank == 0:
      rec['state'] = state
    torch.save(rec, os.path.join(out, f'dense.{ctx.rank}.pt'))
  finally:
    ctx.leave()
  return 0


def phase35_nccl_rank(out, device, spec):
  """Phase 35's world of one under the launcher (``python -m
  hybridbackend_tpu_torch.run --nproc 1 --nodes 1 chip_smoke.py
  --rank-of DIR`` with ``{"phase": "35-nccl"}``; on the CPU rehearsal
  ``--simulate 1``, gloo): it joins the world the launcher describes (its
  backend, the card ``HB_TORCH_RUN_CARD`` names, its rendezvous), runs
  phase 33's wire probe (the backend's calls in bf16 and fp16, the cast
  collectives), each topology's all-reduce and ``all_to_all_v`` on its
  subgroups (bitwise their input at a world of one), then
  ``PHASE35_NCCL_STEPS`` steps of each ``PHASE35_NCCL`` case, and writes
  the backend, the device, the launcher's variables, the probe and each
  case's losses and kernel launches to ``DIR/nccl.0.pt``."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.distribute import collective
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  ctx = hbt.Context.join(device)
  try:
    rec = {'backend': torch.distributed.get_backend(),
           'device': str(ctx.device), 'world': ctx.world_size,
           'env': {k: os.environ.get(k) for k in (
               'RANK', 'WORLD_SIZE', 'LOCAL_WORLD_SIZE', 'HB_TORCH_RUN_CARD')},
           'probe': _wire_probe(ctx), 'losses': {}, 'counts': {}}
    x = torch.arange(12.0, device=ctx.device)
    for topology in collective.Topology:
      got = collective.allreduce(x, ctx=ctx, topology=topology)
      recv, _ = collective.all_to_all_v(
          x.reshape(1, 12), torch.full((1,), 5, dtype=torch.int32,
                                       device=ctx.device),
          ctx=ctx, topology=topology)
      if not (torch.equal(got, x) and torch.equal(recv.reshape(-1), x)):
        raise AssertionError(f'phase 35, {rec["backend"]} world of one: '
                             f'{topology!r} changed its input')
    for case in PHASE35_NCCL:
      _, state, step, batch = _phase35_build(case, ctx.device, ctx,
                                             spec['flags'])
      _reset_counts()
      rec['losses'][case] = [float(step(state, batch(i))[1]['loss'])
                             for i in range(PHASE35_NCCL_STEPS)]
      if ctx.device.type == 'cuda':
        torch.cuda.synchronize(ctx.device)
      rec['counts'][case] = _counts()
      del state, step
    torch.save(rec, os.path.join(out, f'nccl.{ctx.rank}.pt'))
  finally:
    ctx.leave()
  return 0


def _launch_nccl35(out):
  """Starts phase 35's world of one: one NCCL rank on the card through
  the launcher's ``--nproc 1 --nodes 1`` (on the CPU rehearsal one gloo
  rank, ``--simulate 1``), writing to ``out``."""
  ranks = (['--simulate', '1'] if SHARDED_DEVICE == 'cpu'
           else ['--nproc', '1'])
  cmd = [sys.executable, '-m', 'hybridbackend_tpu_torch.run', *ranks,
         '--nodes', '1', '--device', SHARDED_DEVICE, '--timeout',
         str(PHASE35_LAUNCH_S), os.path.join(HERE, 'chip_smoke.py'),
         '--rank-of', out, '--rank-device', SHARDED_DEVICE,
         '--rank-flags', json.dumps({'phase': '35-nccl',
                                     'flags': list(SHARDED_FLAGS)})]
  with open(os.path.join(out, 'nccl.stdout'), 'w') as so, open(
      os.path.join(out, 'nccl.stderr'), 'w') as se:
    return subprocess.Popen(cmd, cwd=HERE, stdout=so, stderr=se)


def _no_world35(dev):
  """The losses of ``PHASE35_NCCL_STEPS`` steps of each ``PHASE35_NCCL``
  case in no world on ``dev``."""
  want = {}
  for case in PHASE35_NCCL:
    _, state, step, batch = _phase35_build(case, dev)
    want[case] = [float(step(state, batch(i))[1]['loss'])
                  for i in range(PHASE35_NCCL_STEPS)]
    del state, step
  return want


def _hold_nccl35(dev, rec, want):
  """The launched world of one's record (``phase35_nccl_rank``) against
  ``want``, the same steps in no world on ``dev``, bit for bit: on the
  card the backend NCCL on ``cuda:0``, the launcher's one rank; kernel 1
  twice a case. Returns the backend, the probe, each case's launches and
  losses."""
  backend = 'nccl' if dev.type == 'cuda' else 'gloo'
  want_env = {'RANK': '0', 'WORLD_SIZE': '1', 'LOCAL_WORLD_SIZE': '1',
              'HB_TORCH_RUN_CARD': '0'}
  if (rec['backend'], rec['world'], rec['env']) != (backend, 1, want_env) or (
      dev.type == 'cuda' and rec['device'] != 'cuda:0'):
    raise AssertionError(f'phase 35, the launched world of one: backend '
                         f'{rec["backend"]} on {rec["device"]}, world '
                         f'{rec["world"]}, launcher variables {rec["env"]}')
  for case, c in rec['counts'].items():
    _expect(f'phase 35, the {backend} world of one, {case}', c,
            adagrad_update_sorted=PHASE35_NCCL_STEPS)
  if rec['losses'] != want:
    raise AssertionError(f'phase 35, the {backend} world of one: losses '
                         f'{rec["losses"]}, no world {want}')
  return backend, rec['probe'], rec['counts'], rec['losses']


def _hold_dense35(dev, rec0, report):
  """The dense ``Trainer``'s world of one, 3 steps each from rank 0's
  tower, against the world's losses (1e-5 relative) and its gathered
  tables and accumulators (1e-5)."""
  import hybridbackend_tpu_torch as hbt
  args = flagship(*SHARDED_FLAGS, '--lookup', 'hierarchical')
  loss_fn, module, optimizer = tb.dense_parts(args, dev)
  dtr = hbt.Trainer(loss_fn, module, optimizer, ctx=hbt.Context(dev))
  base, ids = tb.make_batch(args, torch.device('cpu'), PHASE33_BATCH_SEED)
  initial = _net_values(module['net'], optimizer)
  for i in range(PHASE35_STEPS):
    _load_net(module['net'], optimizer,
              initial if i == 0 else rec0['tower'][i - 1])
    one = dtr.train(iter([tb.shifted(base, ids, args.vocab, i)]))['loss']
    rel = abs(rec0['loss'][i] - one) / abs(one)
    report['dense_loss_rel_err'] = max(report['dense_loss_rel_err'], rel)
    if rel > 1e-5:
      raise AssertionError(f'phase 35, dense step {i + 1}: loss '
                           f'{rec0["loss"][i]}, a world of one {one}')
  one_state = _dense_state(module, optimizer, None)
  for key in ('tables', 'acc'):
    for n, t in one_state[key].items():
      _close34(f'phase 35, dense {key} {n}', t, rec0['state'][key][n], 1e-5,
               report, f'dense_{key}_err')


def _hold_serving35(dev, ranks):
  """Phase 35's sharded serving (``_phase35_serving``) against the world
  of one on the card: each rank's quantized shard bit for bit its rows of
  the quantized whole table (the ranks' shards joined); the ranks'
  int8 embeddings bit for bit ``lookup_quantized`` of the quantized whole
  on the global batch's packed ids (the world's stack layout), their
  predictions within ``PHASE35_SERVED_TOL`` of rank 0's tower on those
  embeddings; every float exchange served bit for bit as trained; kernel
  5 twice a rank for the int8 stack, once a rank an exchange served.
  Returns those launches, summed over the ranks."""
  import hybridbackend_tpu_torch as hbt
  label = f'phase 35, {PHASE35_WORLD} ranks, sharded serving'
  args = flagship(*SHARDED_FLAGS, *PHASE35_CASES['hierarchical'][0])
  launches = collections.Counter()
  for r, rec in enumerate(ranks):
    _expect(f'{label}, int8, rank {r}', rec['int8_counts'], gather_rows=2)
    _expect(f'{label}, float, rank {r}', rec['float_counts'],
            gather_rows=len(PHASE35_SERVED))
    launches.update(rec['int8_counts'])
    launches.update(rec['float_counts'])
    if not all(rec['float_equal'].values()):
      raise AssertionError(f'{label}, rank {r}: served float rows differ '
                           f'from the training lookup: {rec["float_equal"]}')
  whole = hbt.quantize_table(torch.cat([r['shard'] for r in ranks]).to(dev))
  per = whole.vocab // len(ranks)
  for r, rec in enumerate(ranks):
    rows = slice(r * per, (r + 1) * per)
    if not (torch.equal(rec['q'], whole.q[rows].cpu())
            and torch.equal(rec['scale'], whole.scale[rows].cpu())):
      raise AssertionError(f'{label}, rank {r}: quantize_table of the shard '
                           'is not its rows of the quantized whole table')
  fx = hbt.StackedFeatureExtractor(
      tb._specs(args),
      dense_columns=[f'i{d}' for d in range(args.dense_features)],
      ctx=hbt.Context(dev, rank=0, world_size=PHASE35_WORLD,
                      local_world_size=PHASE35_WORLD // PHASE35_NODES))
  (stack,) = fx.stacks
  name = stack.stacked.name
  b = tb.shifted(*tb.make_batch(args, dev, PHASE33_BATCH_SEED), args.vocab,
                 PHASE35_STEPS + PHASE35_TIMED)
  ids, layout = hbt.pack_ids(stack, fx.member_ids(b)[name])
  with torch.no_grad():
    one = hbt.lookup_quantized(whole, ids, stack.stacked)
    if not torch.equal(torch.cat([r['emb'] for r in ranks]).to(dev), one):
      raise AssertionError(f'{label}: the int8 embeddings are not the world '
                           'of one\'s lookup_quantized, bit for bit')
    tower, preds = tb._tower(args, dev, torch.Generator())
    tower.load_state_dict(ranks[0]['tower'])
    want = preds(tower, *fx.combine_from_raw({name: one}, {name: layout}, b))
  err = float((torch.cat([r['preds'] for r in ranks]).to(dev) - want).abs()
              .max())
  if err > PHASE35_SERVED_TOL:
    raise AssertionError(f'{label}: predictions {err:.3e} from the world of '
                         'one\'s')
  print(f'{label}: each rank\'s quantize_table(shard) bitwise its rows of '
        f'the quantized whole [{whole.vocab}, {whole.dim}] table; '
        f'{one.numel()} int8 embeddings of the global batch bitwise the '
        f'world of one\'s lookup_quantized, predictions {err:.3e} apart; '
        f'float shards served under {", ".join(PHASE35_SERVED)} bitwise the '
        'training lookup; kernel 5 2 + '
        f'{len(PHASE35_SERVED)} times on each rank')
  return launches


def start_phase35():
  """Starts phase 35's two launches, the world of ``PHASE35_WORLD`` gloo
  ranks and the NCCL world of one (``_launch_nccl35``), whose ranks may
  run while an earlier phase does; returns their directory, their
  processes and the time they started. ``stop_phase35`` ends them."""
  out = tempfile.mkdtemp(prefix='chip_smoke35_')
  cmd = [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
         str(PHASE35_WORLD), '--nodes', str(PHASE35_NODES), '--device',
         SHARDED_DEVICE, '--timeout', str(PHASE35_LAUNCH_S),
         os.path.join(HERE, 'chip_smoke.py'), '--rank-of', out,
         '--rank-device', SHARDED_DEVICE,
         '--rank-flags', json.dumps(dict(phase=35,
                                         flags=list(SHARDED_FLAGS)))]
  with open(os.path.join(out, 'world.stdout'), 'w') as so, open(
      os.path.join(out, 'world.stderr'), 'w') as se:
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=so, stderr=se)
  return out, proc, _launch_nccl35(out), time.perf_counter()


def stop_phase35(started):
  """Ends ``start_phase35``'s launches where they still run and removes
  their directory."""
  out, *procs, _ = started
  for p in procs:
    if p.poll() is None:
      p.kill()
      p.wait()
  shutil.rmtree(out, ignore_errors=True)


WORLD_HARNESSES = {        # launched beside phase 34, each at both worlds
    'embedding_benchmark': ('--steps', '3'),
    'collective_benchmark': ('--steps', '3', '--sizes-mb', '1', '4'),
}
WORLD_HARNESS_S = 300      # each launch's deadline


def start_world_harnesses():
  """Starts ``WORLD_HARNESSES`` under the launcher, one launch after
  another on a thread of this process: each on 2 gloo ranks sharing the
  card (``--simulate 2``), then on a NCCL world of one (``--nproc 1
  --nodes 1``; on the CPU rehearsal a gloo rank, ``--simulate 1``).
  Returns what ``world_harnesses`` reads and ``stop_world_harnesses``
  ends."""
  results, procs, stop = {}, [], threading.Event()
  one = (['--simulate', '1'] if SHARDED_DEVICE == 'cpu'
         else ['--nproc', '1', '--nodes', '1'])

  def run():
    for name, flags in WORLD_HARNESSES.items():
      for world, ranks in (('gloo', ['--simulate', '2']), ('one', one)):
        if stop.is_set():
          return
        cmd = [sys.executable, '-m', 'hybridbackend_tpu_torch.run', *ranks,
               '--device', SHARDED_DEVICE, '--timeout',
               str(WORLD_HARNESS_S), '-m',
               f'hybridbackend_tpu_torch.benchmarks.{name}', '--device',
               SHARDED_DEVICE, *flags, '--json']
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        try:
          stdout, stderr = proc.communicate(timeout=WORLD_HARNESS_S + 60)
        except subprocess.TimeoutExpired:
          proc.kill()
          stdout, stderr = proc.communicate()
        results[name, world] = (proc.returncode, stdout, stderr,
                                time.perf_counter() - t0)

  thread = threading.Thread(target=run, daemon=True)
  thread.start()
  return thread, results, procs, stop


def stop_world_harnesses(started):
  """Ends ``start_world_harnesses``'s launches where they still run."""
  thread, _, procs, stop = started
  stop.set()
  for p in procs:
    if p.poll() is None:
      p.kill()
      p.wait()
  thread.join(timeout=30)


def world_harnesses(started, smi):
  """Waits for ``start_world_harnesses``'s launches and checks them:
  each exits 0 and prints its JSON line on rank 0; the embedding
  harness's forward checks hold for every strategy. Prints their
  numbers: on gloo ranks sharing one card, host copies (a check's
  cost), not NCCL's."""
  thread, results, _, _ = started
  thread.join(timeout=4 * (WORLD_HARNESS_S + 90))
  for name in WORLD_HARNESSES:
    for world in ('gloo', 'one'):
      if (name, world) not in results:
        raise RuntimeError(f'the launched {name} ({world}) did not finish')
      rc, stdout, stderr, secs = results[name, world]
      if rc != 0:
        raise RuntimeError(f'the launched {name} ({world}) exited {rc}:\n'
                           f'{stderr[-3000:]}')
      got = json.loads(stdout.strip().splitlines()[-1])
      if name == 'embedding_benchmark':
        want = (['allgather', 'alltoall', 'gspmd'] if world == 'gloo'
                else ['local'])
        if list(got['checked']) != want or not all(got['checked'].values()):
          raise AssertionError(f'{name} ({world}): forward checks '
                               f'{got["checked"]}')
        numbers = ', '.join(f'{r["strategy"]} {r["mode"]} {r["ms"]:.3f} ms '
                            f'{r["gb_s"]:.2f} GB/s' for r in got['rows'])
        numbers += (f'; partition {got["partition"]["ms"]:.3f} ms '
                    f'{got["partition"]["mids_s"]:.1f} Mids/s')
      else:
        numbers = ', '.join(f'{r["collective"]} {r["size_mb"]} MB '
                            f'{r["ms"]:.3f} ms {r["gb_s_algo"]:.2f} GB/s '
                            f'wire {r["wire_mb"]:.3f} MB'
                            for r in got['rows'])
      print(f'phase 34, beside it: {name} on a world of {got["world"]} '
            f'({got["backend"]}, {got["timing"]}; a check\'s cost, not a '
            f'multi-GPU number), {secs:.1f} s launched: {numbers} on {smi}')


def phase35_exchanges(dev, smi, started=None):
  """Phase 35: node groups, every exchange, the interleaved step and
  sharded serving at a world of ``PHASE35_WORLD`` gloo ranks in
  ``PHASE35_NODES`` nodes sharing the card (see the module docstring),
  from ``start_phase35``'s launches (started here unless ``started``
  gives them). Returns the kernel launches of the world's held steps
  summed over its ranks and of the NCCL world of one's steps: those of
  the exchanges' cases, then those of the interleaved cases and of
  sharded serving."""
  t_phase = time.perf_counter()
  launches, new_launches = collections.Counter(), collections.Counter()
  failures, times, lists, seconds = [], [], [], {}
  started = started or start_phase35()
  out, proc, nccl, t0 = started
  try:
    # In this process the NCCL world of one's steps in no world, while
    # the launches run.
    want = _no_world35(dev)
    nccl.wait(timeout=PHASE35_LAUNCH_S + 60)
    proc.wait(timeout=PHASE35_LAUNCH_S + 60)
    launch_s = time.perf_counter() - t0
    for p, name, what in ((nccl, 'nccl', 'the launched world of one'), (
        proc, 'world', f'the world of {PHASE35_WORLD}')):
      if p.returncode != 0:
        with open(os.path.join(out, f'{name}.stderr')) as f:
          raise RuntimeError(f'phase 35: {what} exited {p.returncode}:\n'
                             f'{f.read()[-4000:]}')
    backend, probe, counts, nccl_losses = _hold_nccl35(
        dev, torch.load(os.path.join(out, 'nccl.0.pt')), want)
    refused = _print_probe(1, [probe])
    for case, c in counts.items():
      (new_launches if case in PHASE35_INTERLEAVE else launches).update(c)
    t0 = time.perf_counter()
    load = lambda case: [torch.load(os.path.join(out, f'{case}.{r}.pt'))
                         for r in range(PHASE35_WORLD)]
    for case, spec in PHASE35_CASES.items():
      label = (f'phase 35, {PHASE35_WORLD} ranks in {PHASE35_NODES} nodes, '
               f'{case}')
      ranks = load(case)
      t_case = time.perf_counter()
      try:
        kernel, per_step = spec[4], spec[5]
        want_fallbacks = tuple(PHASE35_STEPS * f for f in per_step)
        want = collections.Counter({kernel: PHASE35_STEPS})
        want['gsum_dense_sorted'] += PHASE35_STEPS * _combine_launches(
            spec[0], spec[1], spec[3], spec[6])
        for r, rec in enumerate(ranks):
          _expect(f'{label}, rank {r}', rec['counts'], **want)
          (new_launches if case in PHASE35_INTERLEAVE else launches).update(
              rec['counts'])
          if tuple(rec['fallbacks']) != want_fallbacks:
            raise AssertionError(f'{label}, rank {r}: (lookup, update) '
                                 f'fallbacks {rec["fallbacks"]}, expected '
                                 f'{want_fallbacks}')
          if not rec['tower_equal']:
            raise AssertionError(f'{label}: rank {r}\'s tower is not rank '
                                 '0\'s')
        report, apart_in = _hold_world33(
            label, case, dev, ranks, SHARDED_FLAGS, spec,
            PHASE35_ONE_INTERLEAVE.get(case, 0))
        times.append(f'{case} {ranks[0]["ms_per_step"]:.4f}')
        print(f'{label} ({ranks[0]["backend"]} on {ranks[0]["device"]}, '
              f'shard {ranks[0]["shard"]}): {PHASE35_STEPS} steps against a '
              'world of one on the card, each from one tower: '
              + ', '.join(f'{k} {v:.3e}' if isinstance(v, float)
                          else f'{k} {v}' for k, v in report.items())
              + f' (in {", ".join(sorted(apart_in)) or "none"}); launches '
              f'{dict(want)} on each rank; (lookup, update) '
              f'fallbacks {[tuple(r["fallbacks"]) for r in ranks]} by rank')
        _print_lists(label, ranks)
        lists += [(case, c['kernel'], c['entries'], c['err'])
                  for rec in ranks for c in rec['lists']]
        if case in PHASE35_ONE_INTERLEAVE:
          report, _ = _hold_world33(
              label, case, dev, ranks, SHARDED_FLAGS, spec,
              witness=PHASE35_ONE_INTERLEAVE[case])
          print(f'{label}: against the world of one\'s plain step, each '
                'step from one state, the elements past the flip rule on '
                'the rows of the examples whose ReLU gates differ between '
                f'the whole batch and its {PHASE35_ONE_INTERLEAVE[case]} '
                'micro-batches: ' + ', '.join(
                    f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                    for k, v in report.items()))
      except AssertionError as e:
        # Every case runs; the phase fails at its end.
        failures.append(str(e))
        print(f'{label}: FAILED: {e}')
      seconds[case] = (max(r['seconds'] for r in ranks),
                       time.perf_counter() - t_case)
      del ranks
    t_case = time.perf_counter()
    served = load('serving')
    try:
      new_launches.update(_hold_serving35(dev, served))
    except AssertionError as e:
      failures.append(str(e))
      print(f'phase 35, sharded serving: FAILED: {e}')
    seconds['serving'] = (max(r['seconds'] for r in served),
                          time.perf_counter() - t_case)
    del served
    dense = load('dense')
    report = {'dense_loss_rel_err': 0.0}
    if any(r['loss'] != dense[0]['loss'] for r in dense) or not all(
        r['tower_equal'] for r in dense):
      raise AssertionError('phase 35, dense: the ranks disagree on the '
                           'losses or the replicated parameters')
    # Each sharded table's gradient, the hierarchical transpose, through
    # kernel 4 once a step on every rank.
    for r, rec in enumerate(dense):
      _expect(f'phase 35, dense, rank {r}', rec['counts'],
              gsum_dense_sorted=PHASE35_STEPS * flagship(
                  *SHARDED_FLAGS).tables)
      launches.update(rec['counts'])
      _dense_backward(rec['counts'])
    _hold_dense35(dev, dense[0], report)
    check_s = time.perf_counter() - t0
  finally:
    stop_phase35(started)
  print(f'phase 35, the dense Trainer through the hierarchical lookup, '
        f'{PHASE35_STEPS} steps against the world of one, each from rank '
        '0\'s tower: ' + ', '.join(f'{k} {v:.3e}' for k, v in report.items())
        + f'; the {backend} world of one (python -m hybridbackend_tpu_torch'
        f'.run {"--simulate" if SHARDED_DEVICE == "cpu" else "--nproc"} 1 '
        '--nodes 1): backend refusals '
        f'{refused or "none"}, each topology\'s all-reduce and all_to_all_v '
        f'on its subgroups bitwise, {PHASE35_NCCL_STEPS} steps of '
        f'{", ".join(PHASE35_NCCL)}: losses {nccl_losses}, bit for bit '
        'those of no world')
  new = [c for c in seconds if c in PHASE35_INTERLEAVE or c == 'serving']
  print('phase 35: seconds a case (the slowest rank\'s build, steps and '
        'held lists; this process\'s checks): ' + ', '.join(
            f'{c} {a:.1f} + {b:.1f}' for c, (a, b) in seconds.items())
        + f'; the interleaved and serving cases ({", ".join(new)}) '
        f'{sum(sum(seconds[c]) for c in new):.1f} s')
  print(f'phase 35 on {smi}: ms/step of rank 0 over {PHASE35_TIMED} steps '
        f'(CUDA events): {", ".join(times)} -- gloo ranks sharing one card, '
        'through the host: a check\'s cost, not NCCL, not NVLink, not a '
        f'multi-GPU number; the launches ended {launch_s:.1f} s after they '
        f'started, checks {check_s:.1f} s, phase '
        f'{time.perf_counter() - t_phase:.1f} s')
  if failures:
    raise AssertionError(f'phase 35: {len(failures)} cases failed: '
                         + ' | '.join(failures))
  return launches, new_launches


MODULE_STEPS = 8           # phase 36's fit of the module entry point
MODULE_SUMMARY = 4         # its summary_steps
MODULE_BATCHES = 20        # its file's batches (it evaluates 20, as in JAX)
SCOPE_ROUNDS = 4           # the flagship step timed with the ranges on and
SCOPE_STEPS = 20           # off, in turns, windows of this many steps
SCOPES = ('hb/lookup', 'hb/tower', 'hb/update')


class _Joined(torch.nn.Module):
  """Phase 36's concat tower over the ``'features'`` or ``'raw'`` inputs:
  the same features joined in the same order (embeddings in spec order,
  then the dense columns as ``[B, 1]`` float32), into the same ``net``."""

  def __init__(self, net, inputs, names, dense):
    super().__init__()
    self.net, self.inputs = net, inputs
    self.names, self.dense = list(names), list(dense)

  def forward(self, first, second):
    emb = [first[n] for n in self.names]
    if self.inputs == 'features':
      dense = [second[c] for c in self.dense]
    else:
      dense = [second[c].reshape(-1, 1).to(torch.float32)
               for c in self.dense]
    return self.net(torch.cat([e.to(torch.float32) for e in emb] + dense,
                              -1))


def _module_slots(wrapped):
  """Every parameter of a module adapter and its Adagrad slot, cloned, by
  name, with the step."""
  tr = wrapped.trainer
  out = {'step': tr.global_step}
  for name, p in tr.state.params.named_parameters():
    out[name] = p.detach().clone()
    out[f'{name}:acc'] = tr.state.optimizer.state[p]['sum_of_squares'].clone()
  return out


def _served(label, wrapped, path, batch, dev):
  """``wrapped``'s bundle at ``path`` served on the card, one predict of
  ``batch`` between a reset and a read of the counts: kernel 5 once a
  column, no other counted kernel; the predictions within 1e-6 of the
  adapter's ``predict`` (phase 22's rule). Returns the predictions and the
  gap."""
  import hybridbackend_tpu_torch as hbt
  served = hbt.Served(path, dev)
  columns = len(wrapped.extractor.specs)
  _reset_counts()
  got = served.predict(batch)
  torch.cuda.synchronize(dev)
  _expect(f'{label}, a served predict', _counts(), gather_rows=columns)
  live = next(wrapped.predict(iter([batch]))).cpu().numpy()
  gap = float(np.abs(got - live).max())
  if not (got.shape == live.shape and np.isfinite(got).all()
          and gap <= 1e-6):
    raise AssertionError(f'{label}: the bundle served {got.shape}, '
                         f'{gap:.3e} from predict')
  return got, gap


def _bits_equal(a, b):
  """Whether two float32 or two bfloat16 tensors hold the same bits
  (``-0.0`` is not ``0.0``)."""
  bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
  return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
      a.contiguous().view(bits), b.contiguous().view(bits))


def _dense_backward36(cfg, wrapped, batch, dev, smi):
  """Phase 36's table gradients through kernel 4: the adapter's stacked
  tables and the flagship dense ``Trainer``'s 26 tables (its model,
  ``train_benchmark.dense_parts``), each from one state 3 times, bit for
  bit, kernel 4 once a table a backward; the adapter's captured list (the
  rows and the gradients of the embeddings that reached
  ``dense_row_totals``) summed on the card bitwise the CPU plain version;
  at that list kernel 4 timed beside its bound, the stable sort with its
  permutation, the whole ``dense_row_totals``, the plain version and
  ``zeros`` + ``index_add_`` (one PyTorch call, the backward the lookup
  had before), which is repeated as the witness of atomics. Returns the
  counted launches and kernel 4's record at that list."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.embedding import lookup as lookup_mod
  t0 = time.perf_counter()
  launches = collections.Counter()
  seen = []
  real = lookup_mod.dense_row_totals

  def spy(rows, grad, vocab):
    seen.append((rows.clone(), grad.clone(), vocab))
    return real(rows, grad, vocab)

  def repeated(label, loss_of, tables):
    got = []
    for _ in range(3):
      _reset_counts()
      got.append(torch.autograd.grad(loss_of(), tables))
      torch.cuda.synchronize(dev)
      counts = _counts()
      _expect(label, counts, gsum_dense_sorted=len(tables))
      launches.update(counts)
      _dense_backward(counts)
    if not all(_bits_equal(g, w) for again in got[1:]
               for g, w in zip(again, got[0])):
      raise AssertionError(f'{label}: the table gradients differ between '
                           'repeats')
    return got[0]

  params = wrapped.params
  placed = hbt.put_batch(batch, dev)
  lookup_mod.dense_row_totals = spy
  try:
    (adapter,) = repeated("phase 36, the adapter's backward",
                          lambda: wrapped.loss_fn(params, placed)[0],
                          list(params['tables'].values()))
  finally:
    lookup_mod.dense_row_totals = real
  rows, grad, vocab = seen[0]
  want = hbt.dense_row_totals(rows.cpu(), grad.cpu(), vocab)
  err = float((adapter.cpu() - want).abs().max())
  if not _bits_equal(adapter.cpu(), want):
    raise AssertionError(f'phase 36: the adapter\'s table gradient on the '
                         f'card is {err:.3e} from the CPU plain version')
  args = argparse.Namespace(**{**vars(cfg), 'sparse': False})
  loss_fn, module, _ = tb.dense_parts(args, dev)
  dense_batch = tb.shifted(*tb.make_batch(args, dev, tb.SEED + 36),
                           args.vocab, 0)
  repeated("phase 36, the dense Trainer's backward",
           lambda: loss_fn(module, dense_batch)[0],
           list(module['tables'].values()))
  del module

  # Kernel 4 at the adapter's list.
  n, d = grad.shape
  r32 = torch.where((rows >= 0) & (rows < vocab), rows, -1).to(torch.int32)
  srows, order = torch.sort(r32, stable=True)
  sg = grad.index_select(0, order)
  ms = _median_ms(lambda: hbt.gsum_dense_sorted(srows, sg, vocab))
  sort_ms = _median_ms(
      lambda: grad.index_select(0, torch.sort(r32, stable=True)[1]))
  function_ms = _median_ms(lambda: hbt.dense_row_totals(rows, grad, vocab))
  plain_ms = _median_ms(
      lambda: hbt.gsum_dense_sorted_reference(srows, sg, vocab),
      queued=False)
  valid = srows >= 0
  valid_rows, valid_g = srows[valid].long(), sg[valid]
  library_ms = _median_ms(lambda: torch.zeros(vocab, d, device=dev)
                          .index_add_(0, valid_rows, valid_g))
  bound = _bound(n * (d + 1) * 4 + vocab * d * 4, n * d)
  # The witness: the lookup's backward before, index_select's, repeated.
  table = torch.zeros(vocab, d, device=dev, requires_grad=True)
  ok = (rows >= 0).unsqueeze(-1)
  old = [torch.autograd.grad(
      table.index_select(0, rows.clamp(min=0)), table,
      torch.where(ok, grad, 0))[0] for _ in range(3)]
  differ = sum(not _bits_equal(o, old[0]) for o in old[1:])
  old_err = float((old[0] - adapter).abs().max())
  print(f'  table gradients through kernel 4 on {smi}: the adapter\'s '
        f'[{vocab}, {d}] stack and the dense Trainer\'s {args.tables} '
        f'tables of [{args.vocab}, {args.dim}], 3 backwards each from one '
        'state, '
        'bit for bit; the adapter\'s captured list summed on the card '
        f'bitwise the CPU plain version ({n} ids, max abs err {err:.3e}); '
        f'kernel 4 {ms:.4f} ms (bound {bound["bound_ms"]:.4f} ms, '
        f'{bound["bytes"] / 1e6:.2f} MB), the stable sort and permutation '
        f'{sort_ms:.4f} ms, dense_row_totals {function_ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, zeros + index_add_ {library_ms:.4f} ms; '
        f'index_select\'s backward repeated: {differ} of 2 repeats differ '
        f'from the first, {old_err:.3e} from kernel 4\'s totals at most; '
        f'{time.perf_counter() - t0:.1f} s')
  return launches, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, sort_ms=sort_ms,
                        function_ms=function_ms, witness_repeats_differ=differ,
                        **bound)


def _scoped_steps(cfg, dev, smi, tmp):
  """Phase 36's flagship part: ``profile_trace`` around 2 steps of the
  flagship sparse step, whose trace must hold each named range twice and
  CUDA kernel events; then the step timed with the ranges on and off in
  turns. Returns kernel 1's launches."""
  import hybridbackend_tpu_torch as hbt
  steps = {on: tb.build(cfg, dev, named_scopes=on) for on in (True, False)}
  batch = functools.partial(tb.shifted, *tb.make_batch(cfg, dev), cfg.vocab)
  launches = collections.Counter()
  _reset_counts()
  state, step = steps[True]
  for i in range(2):                       # warm-up, outside the trace
    state, _ = step(state, batch(i))
  torch.cuda.synchronize(dev)
  logdir = os.path.join(tmp, 'trace')
  with hbt.profile_trace(logdir):
    for i in range(2, 4):
      state, _ = step(state, batch(i))
    torch.cuda.synchronize(dev)
  traces = [f for f in os.listdir(logdir) if f.endswith('.pt.trace.json')]
  if len(traces) != 1:
    raise AssertionError(f'phase 36: profile_trace wrote {traces}')
  with open(os.path.join(logdir, traces[0])) as f:
    events = json.load(f)['traceEvents']
  # A range is a host event and, on the card, a device one besides.
  names = collections.Counter((e.get('cat'), e.get('name')) for e in events)
  ranges = {s: (names['user_annotation', s], names['gpu_user_annotation', s])
            for s in SCOPES}
  kernels = [e for e in events if e.get('cat') == 'kernel']
  if any(host != 2 for host, _ in ranges.values()) or not kernels:
    raise AssertionError(f'phase 36: the trace holds ranges {ranges} (on '
                         f'the host, on the device) and {len(kernels)} '
                         'kernel events')
  adagrad = sum(1 for e in kernels if 'adagrad' in e.get('name', ''))
  torch.cuda.synchronize(dev)
  counts = _counts()
  _expect('phase 36, 4 flagship steps', counts, adagrad_update_sorted=4)
  launches.update(counts)
  states = {True: state, False: steps[False][0]}
  ms = {True: [], False: []}
  _reset_counts()
  for r in range(SCOPE_ROUNDS):
    for on in ((True, False) if r % 2 == 0 else (False, True)):
      w = tb.time_steps(states[on], steps[on][1], batch,
                        4 + r * SCOPE_STEPS, SCOPE_STEPS, dev)
      states[on] = w.state
      ms[on].append(w.ms / SCOPE_STEPS)
  torch.cuda.synchronize(dev)
  counts = _counts()
  _expect('phase 36, the timed steps', counts,
          adagrad_update_sorted=2 * SCOPE_ROUNDS * SCOPE_STEPS)
  launches.update(counts)
  on, off = statistics.median(ms[True]), statistics.median(ms[False])
  print(f'  profile_trace of 2 flagship steps: {traces[0]}, '
        f'{len(events)} events, ranges (host, device) '
        + ', '.join(f'{s} {ranges[s]}' for s in SCOPES)
        + f', {len(kernels)} CUDA kernel events ({adagrad} of kernel 1)')
  print(f'  the flagship DCNv2 + Adagrad step on {smi}, the named ranges on '
        f'{on:.4f} ms/step, off {off:.4f} ms/step (median of '
        f'{SCOPE_ROUNDS} windows of {SCOPE_STEPS} each, in turns; on: '
        + ', '.join(f'{x:.4f}' for x in ms[True]) + '; off: '
        + ', '.join(f'{x:.4f}' for x in ms[False])
        + f'), on/off {on / off:.4f}')
  return launches


def phase36_module(cfg, dev, smi):
  """Phase 36: the module adapter at the width of the flax example. The
  port's Criteo module entry point (``examples/criteo/train_module.py``,
  its ``run``) fits 8 steps from the file it synthesizes (26 tables of
  the JAX example's vocabularies at dim 16, batch 4096, Linear
  512-256-64-1 over ``'concat'``, Adagrad 0.1 on everything), evaluates
  20 batches and exports its bundle; then: the summaries read back (the
  train loss at steps 4 and 8, the evaluation's scalars); ``save_weights``
  and ``load_weights`` into a fresh adapter, every parameter, slot and
  the step bit for bit; the module's inputs through kernel 5 on the
  member tables bitwise those through ``index_select`` on the stack (one
  launch a column); the bundle served on the card, kernel 5 once a
  column, within 1e-6 of ``predict``; the ``'features'`` and ``'raw'``
  conventions on copies of the same tables and tower, their predictions
  the concat model's, one step and one served predict each; then one
  step on the card against the same step on the CPU from the card's
  state: the loss to 1e-4 relative, every table, tower weight and
  Adagrad slot to ``rtol = atol = 1e-5`` (phase 18's rule for the
  tables; the tower's Adagrad at lr 0.1 moves a weight by about 0.3
  times its gradient's rounding difference, as it moves a table row);
  the table gradients through kernel 4 (``_dense_backward36``); and the
  flagship's named ranges (``_scoped_steps``). The fit launches kernel 4
  once a step, the stack's gradient. Returns the counted launches and
  kernel 4's record at the adapter's list (its launches: the fit's)."""
  import copy
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.examples.criteo import train_module as tm
  from hybridbackend_tpu_torch.utils.summary import read_event_scalars
  cpu = torch.device('cpu')
  launches = collections.Counter()
  with tempfile.TemporaryDirectory() as tmp:
    args = tm.parse_args([
        '--synthesize', '--data', os.path.join(tmp, 'criteo.parquet'),
        '--rows', str(MODULE_BATCHES * 4096), '--steps', str(MODULE_STEPS),
        '--model-dir', os.path.join(tmp, 'm'), '--summary-steps',
        str(MODULE_SUMMARY), '--export', os.path.join(tmp, 'concat')])
    t0 = time.perf_counter()
    _reset_counts()
    wrapped, metrics, results = tm.run(args)
    torch.cuda.synchronize(dev)
    counts = _counts()
    # Each fit step's table gradient through kernel 4, once a stack.
    _expect('phase 36, the entry point', counts,
            gsum_dense_sorted=MODULE_STEPS * len(wrapped.extractor.stacks))
    launches.update(counts)
    _dense_backward(counts)
    run_s = time.perf_counter() - t0
    if not (np.isfinite(metrics['loss']) and 0 <= results['auc'] <= 1
            and np.isfinite(results['loss'])
            and results['batches'] == MODULE_BATCHES):
      raise AssertionError(f'phase 36: fit gave {metrics}, evaluate '
                           f'{results}')
    (events,) = [f for f in os.listdir(args.model_dir)
                 if f.startswith('events.out.tfevents.')]
    scalars = read_event_scalars(os.path.join(args.model_dir, events))
    train_steps = [s for s, t, _ in scalars if t == 'train/loss']
    evals = {t: v for s, t, v in scalars
             if t.startswith('eval/') and s == MODULE_STEPS}
    if (train_steps != list(range(MODULE_SUMMARY, MODULE_STEPS + 1,
                                  MODULE_SUMMARY))
        or evals.keys() != {'eval/auc', 'eval/loss'}
        or abs(evals['eval/auc'] - results['auc']) > 1e-6):
      raise AssertionError(f'phase 36: the summaries hold {scalars}')

    # save_weights, then load_weights into a fresh adapter.
    ds = tm.dataset(args)
    batches = list(ds.take(3))
    wrapped.save_weights(os.path.join(tmp, 'w'))
    fresh = tm.wrapped_model(args, dev)
    params = fresh.init(torch.Generator().manual_seed(1), batches[0])
    fresh.compile(params, hbt.Adagrad(params.parameters(), lr=0.1))
    fresh.load_weights(os.path.join(tmp, 'w'))
    want, got = _module_slots(wrapped), _module_slots(fresh)
    if sorted(want) != sorted(got) or not all(
        (want[k] == got[k]) if k == 'step' else torch.equal(want[k], got[k])
        for k in want):
      raise AssertionError('phase 36: load_weights did not give back the '
                           'saved weights bit for bit')
    del fresh, params

    # Kernel 5 on the member tables against index_select on the stack.
    placed = hbt.put_batch(batches[0], dev)
    members, specs = wrapped.served_tables()
    _reset_counts()
    with torch.no_grad():
      (served_x,) = wrapped._served_inputs(members, placed, specs)
      torch.cuda.synchronize(dev)
      counts = _counts()
      _expect('phase 36, the served inputs', counts,
              gather_rows=len(specs))
      launches.update(counts)
      (trained_x,) = wrapped._module_inputs(wrapped.params['tables'], placed)
    if not torch.equal(served_x, trained_x):
      raise AssertionError('phase 36: the inputs through kernel 5 differ '
                           'from those through index_select')
    del members, placed

    preds, gaps = {}, {}
    preds['concat'], gaps['concat'] = _served(
        'phase 36, concat', wrapped, args.export, batches[1], dev)
    _reset_counts()
    other = {}
    for inputs in ('features', 'raw'):
      model = hbt.wraps_module(
          _Joined(copy.deepcopy(wrapped.params['net']), inputs,
                  [s.name for s in specs], wrapped.extractor.dense_columns),
          wrapped.extractor.specs,
          dense_columns=wrapped.extractor.dense_columns, inputs=inputs,
          ctx=hbt.Context(dev))
      params = torch.nn.ModuleDict({
          'tables': copy.deepcopy(wrapped.params['tables']),
          'net': model.module})
      model.compile(params, hbt.Adagrad(params.parameters(), lr=0.1))
      with torch.no_grad():
        same = float((model.apply(params, hbt.put_batch(batches[1], dev))
                      - wrapped.apply(wrapped.params, hbt.put_batch(
                          batches[1], dev))).abs().max())
      if same > 1e-6:
        raise AssertionError(f'phase 36: {inputs} predicts {same:.3e} from '
                             'the concat model on the same weights')
      step = model.fit(iter(batches[2:3]), sync=False)
      path = model.export_saved_model(os.path.join(tmp, inputs), batches[0])
      preds[inputs], gaps[inputs] = _served(f'phase 36, {inputs}', model,
                                            path, batches[1], dev)
      other[inputs] = (same, step['loss'])
      launches['gather_rows'] += len(specs)
      del model, params
    launches['gather_rows'] += len(specs)     # the concat bundle's predict

    # One step on the card against the same step on the CPU.
    c_model = tm.wrapped_model(args, cpu)
    params = c_model.init(torch.Generator().manual_seed(2), batches[0])
    c_model.compile(params, hbt.Adagrad(params.parameters(), lr=0.1))
    c_model.trainer._load_checkpoint_state(
        wrapped.trainer._checkpoint_state())
    g_loss = wrapped.fit(iter(batches[2:3]), sync=False)['loss']
    c_loss = c_model.fit(iter(batches[2:3]), sync=False)['loss']
    report = {'loss_rel_err': abs(g_loss - c_loss) / abs(c_loss)}
    g_state, c_state = _module_slots(wrapped), _module_slots(c_model)
    for k in c_state:
      if k == 'step':
        continue
      kind = ('table' if k.startswith('tables.') else 'tower') + (
          '_acc' if k.endswith(':acc') else '')
      g, c = g_state[k].cpu(), c_state[k]
      err = float((g - c).abs().max())
      report[f'{kind}_max_abs_err'] = max(
          report.get(f'{kind}_max_abs_err', 0.0), err)
      if not torch.allclose(g, c, rtol=1e-5, atol=1e-5):
        raise AssertionError(f'phase 36: {k} on the card is {err:.3e} from '
                             'the CPU after one step')
    if report['loss_rel_err'] > 1e-4:
      raise AssertionError(f'phase 36: loss {g_loss} on the card, {c_loss} '
                           'on the CPU')
    del c_model, params
    table = wrapped.params['tables'][wrapped.extractor.stacks[0].stacked.name]
    print(f'phase 36 (the module adapter, examples/criteo/train_module.py: '
          f'{len(specs)} tables stacked into [{table.shape[0]}, '
          f'{table.shape[1]}], batch {args.batch_size}, Linear 512-256-64-1 '
          f'over concat, Adagrad 0.1; on {smi}): fit {MODULE_STEPS} steps, '
          f'evaluate {MODULE_BATCHES} batches and export in {run_s:.1f} s; '
          f'train loss {metrics["loss"]:.6f}, eval auc {results["auc"]:.6f} '
          f'loss {results["loss"]:.6f}; summaries: train/loss at steps '
          f'{train_steps}, {sorted(evals)} at step {MODULE_STEPS}')
    print('  save_weights and load_weights bit for bit; kernel 5 once a '
          'column, the module\'s inputs bitwise index_select\'s; served '
          'predictions from predict: '
          + ', '.join(f'{k} {v:.3e}' for k, v in gaps.items())
          + ' (limit 1e-6); features and raw on the same weights from '
          'concat: ' + ', '.join(f'{k} {v[0]:.3e} (a step: loss {v[1]:.6f})'
                                 for k, v in other.items()))
    print('  one step GPU vs CPU: ' + ', '.join(
        f'{k} {v:.3e}' for k, v in report.items()))
    counts, record = _dense_backward36(cfg, wrapped, batches[0], dev, smi)
    launches.update(counts)
    record['launches'] = MODULE_STEPS * len(wrapped.extractor.stacks)
    launches.update(_scoped_steps(cfg, dev, smi, tmp))
  return launches, record


_LAST_MARK = [time.perf_counter()]


def _mark(label):
  """Prints the wall seconds since the last mark, so that the phases'
  shares of the run's time limit are on record."""
  now = time.perf_counter()
  print(f'chip_smoke: {label} in {now - _LAST_MARK[0]:.1f} s')
  _LAST_MARK[0] = now


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--profile', action='store_true',
                      help='trace 10 steps of each timed variant')
  parser.add_argument('--tune', action='store_true',
                      help='time kernels 2 and 4 over tile and block '
                      'sizes, and kernels 1 and 3 over tile sizes and state '
                      'batches')
  parser.add_argument('--long-runs', action='store_true',
                      help='only time kernels 1-4 at the flagship list and '
                      'at the lists with long runs (long_runs_probe); with '
                      '--tune, at lists of equal runs and kernel 4 over '
                      'block and chunk sizes too')
  parser.add_argument('--rank-of', metavar='DIR',
                      help='run as one rank of phase 33 (34, 35) under the '
                      'port\'s launcher, writing to DIR')
  parser.add_argument('--rank-device', default='cuda',
                      help='that rank\'s device')
  parser.add_argument('--rank-flags', default='{}',
                      help='what that rank runs, a JSON object (see '
                      'phase33_rank)')
  args = parser.parse_args()
  if args.rank_of:
    spec = json.loads(args.rank_flags)
    rank = {34: phase34_rank, 35: phase35_rank,
            '35-nccl': phase35_nccl_rank}.get(spec.get('phase'),
                                              phase33_rank)
    return rank(args.rank_of, args.rank_device, spec)
  if args.long_runs:
    return long_runs_probe(args.tune)
  t_start = time.perf_counter()
  _LAST_MARK[0] = t_start
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this smoke run needs one',
          file=sys.stderr)
    return 1
  import hybridbackend_tpu_torch as hbt
  if not os.path.abspath(hbt.__file__).startswith(
      os.path.join(HERE, 'hybridbackend_tpu_torch')):
    raise RuntimeError('hybridbackend_tpu_torch must come from this '
                       f'checkout, not {hbt.__file__}')
  # Exact f32 on both sides of every comparison.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  cfg = flagship()

  smi, arrow = phase0_environment()
  k = phase1_kernels(cfg, dev, tune=args.tune)
  _mark('phases 0-1')
  state, dcn_step, counts = gpu_vs_cpu(dev, 'phase 2 (DCNv2 + Adagrad)')
  _expect('DCNv2 + Adagrad step', counts, adagrad_update_sorted=1)
  dcn_state, launches = timed(cfg, dev, 'phase 3 (DCNv2 + Adagrad flagship)',
                              state, dcn_step, smi, 'adagrad_update_sorted')
  k['adagrad_update_sorted']['launches'] = launches
  _, _, counts = gpu_vs_cpu(dev, 'phase 4 (DCNv2 + no-dedup Adagrad)',
                            ['--no-dedup'])
  _expect('no-dedup step', counts, adagrad_update_sorted=1)
  k['adagrad_update_sorted[dedup=False]']['launches'] = counts[
      'adagrad_update_sorted']
  state, dlrm_step, counts = gpu_vs_cpu(dev, 'phase 5 (DLRM + LazyAdam)',
                                        ['--model', 'dlrm'], 'adam')
  _expect('LazyAdam step', counts, adam_update_sorted=1)
  dlrm_state, launches = timed(cfg, dev, 'phase 6 (DLRM + LazyAdam flagship)',
                               state, dlrm_step, smi, 'adam_update_sorted')
  k['adam_update_sorted']['launches'] = launches
  state, split_step, counts = gpu_vs_cpu(
      dev, 'phase 7 (DCNv2 + split-dense Adagrad)', split=True)
  _expect('split-dense step', counts, gsum_dense_sorted=1)
  split_state, launches = timed(
      cfg, dev, 'phase 8 (DCNv2 + split-dense Adagrad flagship)', state,
      split_step, smi, 'gsum_dense_sorted')
  k['gsum_dense_sorted']['launches'] = launches
  bf16 = ['--table-dtype', 'bfloat16']
  dcn16_state, dcn16_step, counts = gpu_vs_cpu(
      dev, 'phase 9 (DCNv2 + Adagrad, bf16 tables)', bf16)
  _expect('DCNv2 + Adagrad step, bf16 tables', counts,
          adagrad_update_sorted=1)
  dcn16_state, launches = timed(
      cfg, dev, 'phase 10 (DCNv2 + Adagrad flagship, bf16 tables)',
      dcn16_state, dcn16_step, smi, 'adagrad_update_sorted')
  k['adagrad_update_sorted[bf16]']['launches'] = launches
  _, _, counts = gpu_vs_cpu(
      dev, 'phase 11 (DCNv2 + no-dedup Adagrad, bf16 tables)',
      bf16 + ['--no-dedup'])
  _expect('no-dedup step, bf16 tables', counts, adagrad_update_sorted=1)
  k['adagrad_update_sorted[bf16,dedup=False]']['launches'] = counts[
      'adagrad_update_sorted']
  state, dlrm16_step, counts = gpu_vs_cpu(
      dev, 'phase 12 (DLRM + LazyAdam, bf16 tables)',
      bf16 + ['--model', 'dlrm'], 'adam')
  _expect('LazyAdam step, bf16 tables', counts, adam_update_sorted=1)
  dlrm16_state, launches = timed(
      cfg, dev, 'phase 13 (DLRM + LazyAdam flagship, bf16 tables)', state,
      dlrm16_step, smi, 'adam_update_sorted')
  k['adam_update_sorted[bf16]']['launches'] = launches
  _, _, counts = gpu_vs_cpu(
      dev, 'phase 14 (DCNv2 + split-dense Adagrad, bf16 tables)', bf16,
      split=True)
  _expect('split-dense step, bf16 tables', counts, gsum_dense_sorted=1)
  _, _, counts = gpu_vs_cpu(
      dev, 'phase 15 (DCNv2 + Adagrad, bf16 matmul operands)', ['--bf16'])
  _expect('DCNv2 step with bf16 matmul operands', counts,
          adagrad_update_sorted=1)
  _mark('phases 2-15')
  harness(smi)
  _mark('phase 16')
  trainer_launches, batches, evals, trained = phase17_sparse_trainer(
      cfg, dev, smi, dcn_state, dcn_step)
  trainer_launches.update(phase18_dense_trainer(cfg, dev, smi, batches,
                                                evals))
  _mark('phases 17-18')
  harness_dense(smi)
  _mark('phase 19')
  with tempfile.TemporaryDirectory() as tmp:
    # The file phases' data, cached for the e2e harness's processes too.
    os.environ['HB_BENCH_CACHE'] = tmp
    e2e_launches = phase20_e2e(smi, arrow)
    e2e_launches.update(phase21_criteo(cfg, dev, smi, arrow, tmp))
  k['adagrad_update_sorted[criteo]']['launches'] = CRITEO_ENTRY[
      'adagrad_update_sorted']
  _mark('phases 20-21')
  serving_launches = phase22_serving(cfg, dev, smi, trained)
  _mark('phase 22')
  del trained
  k['adagrad_update_sorted[din]'], din_launches = phase23_din_step(dev, smi)
  din_launches.update(phase24_din_harness(smi))
  with tempfile.TemporaryDirectory() as tmp:
    din_launches.update(phase25_taobao(dev, smi, tmp))
  _mark('phases 23-25')
  cache_launches = phase26_host_backed(cfg, dev, smi)
  with tempfile.TemporaryDirectory() as tmp:
    bundles, batch_dir = (os.path.join(tmp, d) for d in ('bundles', 'data'))
    live, counts = phase27_dynamic(cfg, dev, smi, bundles, batch_dir)
    cache_launches.update(counts)
    live28, counts = phase28_criteo_cached(dev, smi, tmp, bundles, batch_dir)
    cache_launches.update(counts)
    live.update(live28)
    cache_launches['gather_rows'] += serve_host_tables(smi, bundles,
                                                       batch_dir, live)
  _mark('phases 26-28')
  pipeline_launches = phase29_pipelined(cfg, dev, smi)
  pipeline_launches.update(phase30_interleaved(
      cfg, dev, smi, profile_steps=10 if args.profile else 0))
  pipeline_launches.update(phase31_harnesses(smi))
  _mark('phases 29-31')
  phase32_sharded(dev, smi)
  sharded_launches, every_step_launches = phase33_every_step(dev, smi)
  _mark('phases 32-33')
  # Phase 35's ranks and the launched harnesses start now and run beside
  # phase 34's.
  phase35 = start_phase35()
  beside = start_world_harnesses()
  try:
    trainers_n_launches, cache_world_launches = phase34_trainers(dev, smi)
    _mark('phase 34')
    exchanges_launches, serving_interleave_launches = phase35_exchanges(
        dev, smi, phase35)
    world_harnesses(beside, smi)
  except BaseException:
    stop_phase35(phase35)
    stop_world_harnesses(beside)
    raise
  _mark('phase 35')
  module_launches, k['gsum_dense_sorted[lookup backward]'] = phase36_module(
      cfg, dev, smi)
  _mark('phase 36')
  if args.profile:
    batch = functools.partial(tb.shifted, *tb.make_batch(cfg, dev),
                              cfg.vocab)
    profile('DCNv2 + Adagrad', dcn_state, dcn_step, batch)
    profile('DLRM + LazyAdam', dlrm_state, dlrm_step, batch)
    profile('DCNv2 + split-dense Adagrad', split_state, split_step, batch)
    profile('DCNv2 + Adagrad, bf16 tables', dcn16_state, dcn16_step, batch)
    profile('DLRM + LazyAdam, bf16 tables', dlrm16_state, dlrm16_step, batch)
    for flags in ([], ['--sessions', str(DIN_SESSIONS)]):
      din_args = din.parse_args(['--sparse', *flags])
      profile(' '.join(['DIN --sparse', *flags]), *din.build(din_args, dev),
              functools.partial(din.shifted, din_args,
                                *din.make_batch(din_args, dev)))

  rows = []
  for name, (source, replaces) in KERNELS.items():
    m = k[name]
    rows.append({'name': name, 'route': 'cuda', 'source': source,
                 'replaces': replaces, 'launches': m['launches'],
                 'max_abs_err': m['max_abs_err'], 'ms': m['ms'],
                 'plain_ms': m['plain_ms'], 'bound_ms': m['bound_ms'],
                 'bound_by': m['bound_by'], 'bytes': m['bytes'],
                 'library_ms': m['library_ms'],
                 # Kernel 4 as a lookup's backward: the stable sort with
                 # its permutation, and the whole dense_row_totals.
                 'sort_ms': m.get('sort_ms'),
                 'dense_row_totals_ms': m.get('function_ms'),
                 # Kernels 2 and 3 at the Criteo entry point's list
                 # (criteo_list, runs up to about 1600 entries): ms, plain
                 # version, bound and kernel 2's index_add_
                 # (phase1_long_runs).
                 'criteo': m.get('criteo'),
                 # Launches in the trainers' runs (phases 17 and 18), by
                 # the kernel's own counter; null for a storage or dedup
                 # mode, whose counter it shares with its kernel's row.
                 'trainer_launches': (trainer_launches[name]
                                      if name in tb.COUNTED else None),
                 # Launches in the runs from Parquet files (phases 20-21).
                 'e2e_launches': (e2e_launches[name]
                                  if name in tb.COUNTED else None),
                 # Launches in phase 22's cold process, the served
                 # predicts.
                 'serving_launches': ((serving_launches
                                       if name == 'gather_rows' else 0)
                                      if name in tb.COUNTED else None),
                 # Launches in the DIN phases (23-25): the steps, the
                 # harness's processes, the Taobao entry point, its
                 # checks and the cold process's served predicts.
                 'din_launches': (din_launches[name]
                                  if name in tb.COUNTED else None),
                 # Launches in the host-table phases (26-28): the cached
                 # and dynamic trainers, their flushes, the Criteo entry
                 # point's cached runs and the cold process's predicts.
                 'cache_launches': (cache_launches[name]
                                    if name in tb.COUNTED else None),
                 # Launches in the pipelining phases (29-31): the dense
                 # pipelined and the interleaved steps, the harnesses'
                 # processes.
                 'pipeline_launches': (pipeline_launches[name]
                                       if name in tb.COUNTED else None),
                 # Launches in phase 33's ranks in phase 32's cases
                 # (PHASE32_CASES), the held steps of every world and case
                 # summed over the ranks (the timed steps, the checks on
                 # the received lists and the launched harness not
                 # counted).
                 'sharded_launches': (sharded_launches[name]
                                      if name in tb.COUNTED else None),
                 # Launches in phase 33's ranks in its other cases: the
                 # held steps and SGD rounds of every world and case
                 # summed over the ranks (the timed steps and the checks
                 # on the received lists not counted).
                 'every_step_launches': (every_step_launches[name]
                                         if name in tb.COUNTED else None),
                 # Launches in phase 34: the world's SparseTrainer steps
                 # summed over its ranks, the NCCL world of one's steps,
                 # and the served predicts of the world's bundle (the
                 # checks on the received lists and the world of one's
                 # steps not counted).
                 'trainers_n_launches': (trainers_n_launches[name]
                                         if name in tb.COUNTED else None),
                 # Launches in phase 34's cached case: its ranks' steps
                 # and kernel 5 on the owners' evicted and flushed rows,
                 # summed over the ranks (the checks on the received
                 # lists and the world of one not counted).
                 'cache_world_launches': (cache_world_launches[name]
                                          if name in tb.COUNTED else None),
                 # Launches in phase 35's exchange cases: the held steps of
                 # every case summed over the world's ranks, and the NCCL
                 # world of one's steps of the hierarchical, column and
                 # wire cases (the timed steps and the checks on the
                 # received lists not counted).
                 'exchanges_launches': (exchanges_launches[name]
                                        if name in tb.COUNTED else None),
                 # Launches in phase 35's interleaved cases and sharded
                 # serving: the interleaved steps' held steps summed over
                 # the world's ranks and the NCCL world of one's, and the
                 # ranks' served int8 and float lookups (the timed steps
                 # and the checks on the received lists not counted).
                 'serving_interleave_launches': (
                     serving_interleave_launches[name]
                     if name in tb.COUNTED else None),
                 # Launches in phase 36: kernel 4 in the entry point's
                 # fit and the repeated table gradients, kernel 5 in the
                 # module adapter's served inputs and its bundles'
                 # predicts, kernel 1 in the flagship steps traced and
                 # timed with and without the named ranges.
                 'module_launches': (module_launches[name]
                                     if name in tb.COUNTED else None),
                 # Kernel 4's launches in every dense backward through a
                 # table lookup: phases 18, 19, 24, 29, 31, 34-36.
                 'dense_backward_launches': (
                     DENSE_BACKWARD[name] if name in tb.COUNTED else None)})
  print(f'chip_smoke: {time.perf_counter() - t_start:.1f} s wall, every '
        'phase')
  print(json.dumps({'kernels': rows}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
