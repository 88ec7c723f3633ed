"""The generator's statistics on the CPU."""

import math

import torch

from portbench import generator


def _pool(traffic, columns, seed=1, batch=512):
  return generator.make_pool(traffic, columns, batch, seed,
                             torch.device('cpu'))


def test_zipf_rank_frequencies():
  rows, n, alpha = 1000, 400_000, 1.05
  gen = torch.Generator().manual_seed(3)
  x = generator.ids({'dist': 'zipf', 'alpha': alpha}, rows, n, gen,
                    torch.device('cpu'))
  assert int(x.min()) >= 0 and int(x.max()) < rows
  counts = torch.bincount(x, minlength=rows).double() / n
  total = sum(k ** -alpha for k in range(1, rows + 1))
  for rank in (1, 2, 3, 10, 100):
    want = rank ** -alpha / total
    assert abs(float(counts[rank - 1]) - want) < 4 * math.sqrt(want / n) + 1e-4


def test_zipf_permutation_scatters_hot_rows():
  rows = 100_000
  gen = torch.Generator().manual_seed(4)
  x = generator.ids({'dist': 'zipf', 'alpha': 1.05, 'permute': True}, rows,
                    50_000, gen, torch.device('cpu'))
  hot = int(torch.bincount(x, minlength=rows).argmax())
  assert hot != 0
  assert (x < 100).float().mean() < 0.01


def test_history_lengths_and_holes():
  traffic = {'pool_batches': 4, 'dists': {
      'item': {'dist': 'zipf', 'alpha': 1.0, 'permute': True},
      'history': {'dist': 'geometric', 'mean': 101, 'max': 100}}}
  cols = [{'name': 'cand_hist', 'kind': 'sequence', 'rows': 5000,
           'dist': 'item', 'length': 'history', 'mask': 'hist_mask'}]
  pool = _pool(traffic, cols, batch=4096)
  ids, mask = pool['cand_hist'], pool['hist_mask']
  assert ids.shape == (4, 4096, 101) and mask.shape == (4, 4096, 100)
  lengths = mask.sum(-1).double()
  assert int(lengths.min()) >= 1 and int(lengths.max()) == 100
  p = 1 / 101
  want = (1 - (1 - p) ** 100) / p            # E[min(100, geometric)]
  assert abs(float(lengths.mean()) - want) < 0.5
  assert bool((ids[..., 1:] >= 0).eq(mask).all())
  assert bool((ids[..., 0] >= 0).all())
  # A mask is a prefix: valid positions first.
  assert bool((mask[..., 1:] <= mask[..., :-1]).all())


def test_pools_repeat_for_a_seed_and_differ_across_seeds():
  traffic = {'pool_batches': 3, 'dists': {
      'categorical': {'dist': 'zipf', 'alpha': 1.05, 'permute': True},
      'dense': {'dist': 'exponential', 'scale': 1.0},
      'label': {'dist': 'bernoulli', 'p': 0.5}}}
  cols = [{'name': 'c0', 'kind': 'categorical', 'rows': 10_000,
           'dist': 'categorical'},
          {'name': 'i0', 'kind': 'dense', 'dist': 'dense'},
          {'name': 'label', 'kind': 'label', 'dist': 'label'}]
  a, b = _pool(traffic, cols, seed=2**40 + 3), _pool(traffic, cols, 2**40 + 3)
  c = _pool(traffic, cols, seed=2**40 + 4)
  for k in a:
    assert torch.equal(a[k], b[k])
    assert not torch.equal(a[k], c[k])
  assert a['c0'].dtype == torch.int32
  assert abs(float(a['i0'].mean()) - 1.0) < 0.1
  assert abs(float(a['label'].mean()) - 0.5) < 0.05
  # The pool's batches differ from each other.
  assert not torch.equal(a['c0'][0], a['c0'][1])


def test_a_mapped_column_gives_each_source_row_one_id():
  traffic = {'pool_batches': 2, 'dists': {
      'item': {'dist': 'zipf', 'alpha': 1.0, 'permute': True},
      'category': {'dist': 'uniform'},
      'history': {'dist': 'geometric', 'mean': 101, 'max': 100}}}
  cols = [{'name': 'cand_hist', 'kind': 'sequence', 'rows': 3000,
           'dist': 'item', 'length': 'history', 'mask': 'hist_mask'},
          {'name': 'cate_hist', 'kind': 'mapped', 'of': 'cand_hist',
           'of_rows': 3000, 'rows': 37, 'dist': 'category'}]
  pool = _pool(traffic, cols, seed=2**41 + 5, batch=256)
  items, cates = pool['cand_hist'], pool['cate_hist']
  assert cates.dtype == torch.int32 and cates.shape == items.shape
  # Holes stay holes, and every other id is a category.
  assert bool(((cates < 0) == (items < 0)).all())
  valid = items >= 0
  assert int(cates[valid].min()) >= 0 and int(cates[valid].max()) < 37
  # One category an item, wherever the item appears.
  seen = {}
  for i, c in zip(items[valid].tolist(), cates[valid].tolist()):
    assert seen.setdefault(i, c) == c
  assert len(set(seen.values())) > 30
