"""The port's example entry points, and what they share in a world."""

from __future__ import annotations


class FileTooSmall(ValueError):
  """A file with fewer row groups than the world has ranks."""


def check_row_groups(path: str, world: int) -> None:
  """Raise :class:`FileTooSmall` when the Parquet file at ``path`` has
  fewer row groups than ``world``: each rank reads its own."""
  import pyarrow.parquet as pq
  groups = pq.ParquetFile(path).metadata.num_row_groups
  if groups < world:
    raise FileTooSmall(
        f'{path} has {groups} row groups, fewer than the {world} ranks of '
        'the world (each rank reads its own row groups): write it with '
        'more, or synthesize it in this world')
