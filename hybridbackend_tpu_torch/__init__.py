"""hybridbackend_tpu_torch: the PyTorch and CUDA port of hybridbackend_tpu.

The port lives beside the JAX package, which stays the reference it is
tested against. It imports ``torch`` and never ``jax``, and nothing from
``hybridbackend_tpu``. It covers:

* the sparse train step: stacked embedding tables, the stacked DCNv2 and
  DLRM towers, a torch optimizer on the tower, and row-sparse Adagrad
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
* a row gather with clipped ids and a stochastically rounded bf16 cast,
  each with its kernel.

Kernels are built at first use, never at import.
"""

__version__ = '0.1.0'

from hybridbackend_tpu_torch import metrics
from hybridbackend_tpu_torch.convert import (
    from_jax, from_jax_dense, load_adam_state, load_dcn_v2, load_dlrm)
from hybridbackend_tpu_torch.data.prefetch import DeviceIterator, put_batch
from hybridbackend_tpu_torch.data.sync import (
    SYNC_VALID_KEY, SyncReplicasIterator)
from hybridbackend_tpu_torch.embedding.lookup import lookup, lookup_sparse
from hybridbackend_tpu_torch.embedding.sparse_update import (
    SparseOptState, init_adagrad_state, init_adam_state,
    sparse_adagrad_apply, sparse_adam_apply, sparse_sgd_apply)
from hybridbackend_tpu_torch.embedding.stack import (
    TableStack, build_stacks, create_stacked_tables, member_tables,
    pack_ids, unpack_embeddings)
from hybridbackend_tpu_torch.embedding.table import (
    TableConfig, create_table, default_initializer)
from hybridbackend_tpu_torch.estimator import SparseTrainer, Trainer
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.models.feature import (
    EmbeddingSpec, StackedFeatureExtractor, extract_features, init_tables)
from hybridbackend_tpu_torch.models.layers import MLP, Dense
from hybridbackend_tpu_torch.models.ranking import DLRM, StackedDCNv2
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
from hybridbackend_tpu_torch.training.checkpoint import CheckpointManager
from hybridbackend_tpu_torch.training.hooks import (
    Hook, LoggingHook, Policy, StepStatHook)
from hybridbackend_tpu_torch.training.optimizer import (
    Adagrad, MultiOptimizer, is_embedding_path,
    lr_with_linear_warmup_and_polynomial_decay, multi_optimizer, split_trees)
from hybridbackend_tpu_torch.training.sparse_step import (
    SparseTrainState, make_sparse_train_step)
from hybridbackend_tpu_torch.training.train import (
    TrainState, make_eval_step, make_train_step)
