"""hybridbackend_tpu_torch: the PyTorch and CUDA port of hybridbackend_tpu.

The port lives beside the JAX package, which stays the reference it is
tested against. It imports ``torch`` and never ``jax``, and nothing from
``hybridbackend_tpu``. It covers:

* the sparse train step: stacked embedding tables, the stacked DCNv2,
  DLRM and DIN towers (DIN's attention over the uncombined sequence
  embeddings through ``raw_model_loss``), a torch optimizer on the
  tower, and row-sparse Adagrad
  (with or without duplicate combining, or in its dense-split form), SGD
  or LazyAdam on the tables, each through a CUDA kernel written for
  Hopper (``ops/csrc/``);
* the dense-gradient step: unstacked tables (``init_tables``,
  ``extract_features``, ``lookup_sparse``) differentiated with the
  tower, under ``multi_optimizer`` (an optax-equivalent ``Adagrad`` on
  the tables, Adam on the tower);
* the trainer stack: ``Trainer`` and ``SparseTrainer`` (train, evaluate
  with AUC and GAUC, predict, checkpoint and resume), fed through
  ``SyncReplicasIterator`` (one replica) and ``DeviceIterator``, with
  step-stat and logging hooks, and the metrics;
* the host data plane: ``ParquetDataset`` over Parquet or ORC files (a
  native C++ reader built with ``g++`` against pyarrow's Arrow, or pyarrow
  in Python), rebatching, shuffling, deduplication and the ragged
  ``DataFrame`` values, feeding the trainers from a file
  (``benchmarks/e2e_benchmark.py``, ``examples/criteo/train.py``,
  ``examples/taobao/train_din.py``);
* serving: the trainers' ``export_saved_model`` writes a bundle
  (``torch.export`` graph, parameters, signature) that ``Served`` loads
  in a cold process and predicts from, with f32 or per-row int8 tables
  (``QuantizedTable``), every member lookup through the row gather's
  kernel;
* host-backed tables: ``EmbeddingCache`` (a device cache over a host-DRAM
  table and its slots, LRU eviction, the evicted rows read through the
  row gather's kernel) wired into ``SparseTrainer(caches=...)`` by
  ``CacheRunner``, and ``DynamicEmbedding`` / ``IdMapper`` (raw int64 ids
  to rows, with an admission filter), over the port's native id hash
  (``native/idmap.py``); their bundles serve from the full host table or
  with the bundled id mappers;
* micro-batch pipelining (``pipeline``): gradient accumulation over
  slices of a batch (``accumulate_gradients``,
  ``make_pipelined_train_step``) and the PICASSO interleaved sparse step
  (``make_interleaved_train_step``), whose lookups run on a side CUDA
  stream beside the tower and whose tables take one row-sparse update a
  step;
* a row gather with clipped ids and a stochastically rounded bf16 cast,
  each with its kernel;
* a world of ranks (``Context.join``, the launcher ``python -m
  hybridbackend_tpu_torch.run`` and its node groups, ``distribute`` over
  every rank, a node's or a local rank's): the sparse step with
  row-sharded stacks, looked up through the allgather, alltoall,
  hierarchical or gspmd exchange, or column-sharded ones, their Adagrad, LazyAdam, SGD, per-occurrence or dense-split
  update routed to each row's owner and applied there through the
  update's kernel, f32 or bf16 tables, both model hooks, the tower
  data-parallel, and the lookup's rows and the gradients cast to bf16 or
  fp16 on the wire when asked; both trainers there (``SparseTrainer`` on
  row-sharded stacks, the dense ``Trainer`` data-parallel with
  row-sharded tables through the differentiable sharded lookup), with
  replica-synchronized stopping and padding (``SyncReplicasIterator``),
  exact eval metrics across the ranks, checkpoints that each rank writes
  its rows of and any world restores, and the export of an unsharded
  bundle; the interleaved step, its micro-batches' lookups through the
  sharded exchanges on the side stream; and sharded serving, a rank's
  f32 or int8 shard (``shard_quantized``) served through the row
  gather's kernel;
* the tail of the JAX package: a stock ``nn.Module`` tower wrapped over
  the port's tables (``wraps_module``, the flax adapter's counterpart,
  whose exported bundle serves every column through the row gather's
  kernel), TensorBoard summaries from the trainers (``SummaryHook``,
  ``utils.summary``), ``torch.profiler`` traces and NVTX ranges
  (``utils.profiler``), and the cost-model sharding planner
  (``plan_sharding``, ``plan_options``).

Kernels and the native libraries are built at first use, never at
import.
"""

__version__ = '0.1.0'

from hybridbackend_tpu_torch import data, distribute, metrics, pipeline, utils
from hybridbackend_tpu_torch.convert import (
    from_jax, from_jax_dense, from_jax_module, gather_slots, gather_tables,
    load_adam_state, load_dcn_v2, load_dice, load_din, load_dlrm,
    quantized_from_jax)
from hybridbackend_tpu_torch.data import (
    DataFrame, Dataset, Field, ParquetDataset, RebatchBuffer, Value,
    deduplicate, infer_fields, parse, populate_defaults, rebatch,
    restore_deduplicated)
from hybridbackend_tpu_torch.data.prefetch import DeviceIterator, put_batch
from hybridbackend_tpu_torch.data.sync import (
    SYNC_VALID_KEY, SyncReplicasIterator)
from hybridbackend_tpu_torch.embedding.dynamic import (
    DynamicEmbedding, IdMapper)
from hybridbackend_tpu_torch.embedding.lookup import (
    lookup, lookup_sparse, world_slice)
from hybridbackend_tpu_torch.embedding.planner import (
    TablePlan, plan_options, plan_sharding)
from hybridbackend_tpu_torch.embedding.quant import (
    QuantizedTable, dequantize_table, lookup_quantized, quantize_table,
    shard_quantized)
from hybridbackend_tpu_torch.embedding.service import (
    CachePlan, CacheRunner, EmbeddingCache, InMemoryStorage, Storage)
from hybridbackend_tpu_torch.embedding.sparse_update import (
    SparseOptState, init_adagrad_state, init_adam_state,
    sparse_adagrad_apply, sparse_adam_apply, sparse_sgd_apply)
from hybridbackend_tpu_torch.embedding.stack import (
    TableStack, build_stacks, create_stacked_tables, member_tables,
    pack_ids, unpack_embeddings)
from hybridbackend_tpu_torch.embedding.table import (
    TableConfig, TableShard, create_table, default_initializer, table_shard)
from hybridbackend_tpu_torch.estimator import SparseTrainer, Trainer
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.models.feature import (
    EmbeddingSpec, StackedFeatureExtractor, extract_features, init_tables)
from hybridbackend_tpu_torch.module_support import (
    WrappedModel, binary_cross_entropy, wraps_module)
from hybridbackend_tpu_torch.models.layers import (
    MLP, Dense, Dice, LocalActivationUnit, attention_sequence_pooling)
from hybridbackend_tpu_torch.models.ranking import (
    DIN, DINSession, DLRM, StackedDCNv2)
from hybridbackend_tpu_torch.ops.cast import (
    draw_seed, round_with_noise, stochastic_round_bf16,
    stochastic_round_bf16_reference)
from hybridbackend_tpu_torch.ops.gather import (
    gather_rows, gather_rows_reference)
from hybridbackend_tpu_torch.ops.scatter import (
    adagrad_update_sorted, adagrad_update_sorted_reference,
    adam_update_sorted, adam_update_sorted_reference, gsum_dense_sorted,
    gsum_dense_sorted_reference, scatter_add_sorted,
    scatter_add_sorted_reference)
from hybridbackend_tpu_torch.pipeline import (
    accumulate_gradients, make_interleaved_train_step,
    make_pipelined_train_step)
from hybridbackend_tpu_torch.training.checkpoint import (
    CheckpointManager, Shard)
from hybridbackend_tpu_torch.training.hooks import (
    Hook, LoggingHook, Policy, StepStatHook, SummaryHook)
from hybridbackend_tpu_torch.training.optimizer import (
    Adagrad, MultiOptimizer, is_embedding_path,
    lr_with_linear_warmup_and_polynomial_decay, multi_optimizer, split_trees)
from hybridbackend_tpu_torch.training.saved_model import Served
from hybridbackend_tpu_torch.training.sparse_step import (
    SparseTrainState, make_sparse_train_step)
from hybridbackend_tpu_torch.training.train import (
    TrainState, make_eval_step, make_train_step)
from hybridbackend_tpu_torch.utils import (
    SummaryWriter, named_scope, profile_trace, read_event_scalars)


def wraps(obj):
  """Route ``obj`` to its adapter (JAX ``hybridbackend_tpu.wraps``): an
  ``nn.Module`` instance becomes ``wraps_module`` bound to it (call the
  result with the specs and the adapter's keywords); anything else is
  returned as it is."""
  import functools
  from torch import nn
  if isinstance(obj, nn.Module):
    return functools.partial(wraps_module, obj)
  return obj
