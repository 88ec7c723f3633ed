"""The port's data plane: Parquet/ORC reading (a native C++ reader and a
Python one), rebatching, deduplication, host-to-device prefetch and
replica sync."""

from hybridbackend_tpu_torch.data.dataframe import (
    Field, Value, from_arrow, parse, populate_defaults)
from hybridbackend_tpu_torch.data.deduplicate import (
    deduplicate, restore_deduplicated)
from hybridbackend_tpu_torch.data.parquet import (
    Dataset, ParquetDataset, infer_fields)
from hybridbackend_tpu_torch.data.prefetch import DeviceIterator, put_batch
from hybridbackend_tpu_torch.data.rebatch import RebatchBuffer, rebatch
from hybridbackend_tpu_torch.data.sync import (
    SYNC_VALID_KEY, SyncReplicasIterator)


class DataFrame:
  """Namespace alias matching the reference's spelling
  (``hb.data.DataFrame.Field`` / ``.Value``, ``dataframe.py:52-396``)."""
  Field = Field
  Value = Value
