"""The port's host data path against the JAX package's: ``collate_blocks``,
``DataLoaderLite``, ``prefetch_iter``, ``EarlyStopping`` and
``retrieve_best_checkpoint`` on the same seeded numpy inputs, and the
in-memory ``BlockDataModule``'s loaders."""
import os
import threading
import time

import numpy as np
import pytest

from waveformml_tpu.datasets.data_module import DataLoaderLite as JaxDataLoaderLite
from waveformml_tpu.datasets.data_module import collate_blocks as jax_collate_blocks
from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
from waveformml_tpu.engineering.callbacks import EarlyStopping as JaxEarlyStopping
from waveformml_tpu.utils.util import prefetch_iter as jax_prefetch_iter
from waveformml_tpu.utils.util import retrieve_best_checkpoint as jax_retrieve_best
from waveformml_tpu_torch.datasets.data_module import DataLoaderLite, collate_blocks
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
from waveformml_tpu_torch.engineering.callbacks import EarlyStopping
from waveformml_tpu_torch.utils.util import prefetch_iter, retrieve_best_checkpoint


def _ragged_blocks(seed, n_blocks=7):
    """Blocks of 1-9 events with 1-4 rows each, event ids grouped but not
    contiguous (gaps, a non-zero start), a per-row extra and an
    ``edges_`` edge list of block-local rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_blocks):
        n_ev = int(rng.integers(1, 10))
        ids = np.sort(rng.choice(50, size=n_ev, replace=False)) + 3
        mult = rng.integers(1, 5, n_ev)
        ev = np.repeat(ids, mult)
        n = ev.size
        coords = np.stack([rng.integers(0, 14, n), rng.integers(0, 11, n), ev], 1)
        extras = {"E": rng.normal(size=n).astype(np.float32),
                  "edges_k3": rng.integers(0, n, size=(2, 2 * n)).astype(np.int32)}
        out.append(dict(coords=coords.astype(np.int32),
                        feats=rng.normal(size=(n, 6)).astype(np.float32),
                        labels=rng.integers(0, 2, n_ev).astype(np.int64), extras=extras))
    return out


def _port(d):
    return FileBlock(d["coords"], d["feats"], d["labels"], dict(d["extras"]))


def _jax(d):
    return JaxFileBlock(d["coords"], d["feats"], d["labels"], dict(d["extras"]))


def _assert_blocks_equal(got, want):
    for name in ("coords", "feats", "labels"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert sorted(got.extras) == sorted(want.extras)
    for k in got.extras:
        assert got.extras[k].dtype == want.extras[k].dtype, k
        np.testing.assert_array_equal(got.extras[k], want.extras[k], err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 7])
def test_collate_blocks_matches_jax(n):
    raw = _ragged_blocks(1)[:n]
    got = collate_blocks([_port(d) for d in raw])
    _assert_blocks_equal(got, jax_collate_blocks([_jax(d) for d in raw]))
    # events renumbered 0..B-1 over all blocks, edges shifted into their rows
    assert got.coords[:, -1].max() + 1 == sum(d["labels"].shape[0] for d in raw)
    assert got.extras["edges_k3"].max() < got.coords.shape[0]


def test_fileblock_positional_construction_keeps_working():
    b = FileBlock(np.zeros((2, 3), np.int32), np.zeros((2, 4), np.float32),
                  np.zeros(1, np.int64))
    assert b.extras == {}
    b.extras["x"] = np.ones(2)
    assert FileBlock(b.coords, b.feats, b.labels).extras == {}


class _Dataset:
    def __init__(self, blocks):
        self.blocks = blocks

    def __len__(self):
        return len(self.blocks)

    def __getitem__(self, i):
        return self.blocks[i]


@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
@pytest.mark.parametrize("drop_last", [False, True], ids=["keep_last", "drop_last"])
@pytest.mark.parametrize("num_workers", [0, 2], ids=["inline", "prefetch"])
def test_dataloader_lite_matches_jax(shuffle, drop_last, num_workers):
    """Three epochs of batches of 2 over 7 ragged blocks: the same
    batches in the same order for seed 17."""
    raw = _ragged_blocks(2)
    kw = dict(batch_size=2, shuffle=shuffle, num_workers=num_workers, seed=17,
              drop_last=drop_last, prefetch_depth=2)
    loader = DataLoaderLite(_Dataset([_port(d) for d in raw]), **kw)
    jloader = JaxDataLoaderLite(_Dataset([_jax(d) for d in raw]), **kw)
    assert len(loader) == len(jloader) == (3 if drop_last else 4)
    orders = []
    for _ in range(3):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            _assert_blocks_equal(g, w)
        orders.append([float(b.feats[0, 0]) for b in got])
    if shuffle:
        assert len({tuple(o) for o in orders}) > 1, orders


def test_prefetch_iter_keeps_order():
    assert list(prefetch_iter(iter(range(100)), depth=3)) == list(range(100))
    assert list(prefetch_iter(iter([]), depth=1)) == []


def test_prefetch_iter_reraises_the_workers_exception():
    def source():
        yield 1
        yield 2
        raise ValueError("bad block")

    for fn in (prefetch_iter, jax_prefetch_iter):
        got = []
        with pytest.raises(ValueError, match="bad block"):
            for x in fn(source(), depth=1):
                got.append(x)
        assert got == [1, 2]


def test_prefetch_iter_stops_its_thread_when_abandoned():
    """A consumer that breaks off after two items, with the worker blocked
    on a full queue: the worker stops (the source's ``finally`` runs) and
    its thread ends within a second."""
    closed = threading.Event()

    def source():
        try:
            for i in range(10_000):
                yield i
        finally:
            closed.set()

    before = set(threading.enumerate())
    gen = prefetch_iter(source(), depth=2)
    assert [next(gen), next(gen)] == [0, 1]
    time.sleep(0.2)                     # the worker fills the queue and blocks
    workers = [t for t in threading.enumerate() if t not in before]
    assert len(workers) == 1 and workers[0].is_alive()
    gen.close()
    workers[0].join(timeout=2.0)
    assert not workers[0].is_alive()
    assert closed.is_set()


@pytest.mark.parametrize("patience,min_delta", [(1, 0.0), (3, 0.0), (2, 0.05)])
def test_early_stopping_stops_at_the_jax_epoch(patience, min_delta):
    losses = [1.0, 0.8, 0.82, 0.79, 0.81, 0.85, 0.76, 0.77, 0.9, 0.95, 0.99]
    stops = []
    for cls in (EarlyStopping, JaxEarlyStopping):
        es = cls(patience=patience, min_delta=min_delta)
        stop = None
        for epoch, vl in enumerate(losses):
            if epoch == 3:                      # state round trip mid-run
                fresh = cls(patience=patience, min_delta=min_delta)
                fresh.load_state_dict(es.state_dict())
                es = fresh
            if es.update({"val_loss": vl, "train_loss": 0.0}):
                stop = epoch
                break
        stops.append(stop)
    assert stops[0] == stops[1] and stops[0] is not None and stops[0] < len(losses) - 1
    assert not EarlyStopping().update({"train_loss": 1.0})


def test_retrieve_best_checkpoint_matches_jax(tmp_path):
    assert retrieve_best_checkpoint(str(tmp_path)) is None
    (tmp_path / "last.ckpt").write_bytes(b"")
    assert retrieve_best_checkpoint(str(tmp_path)) == jax_retrieve_best(str(tmp_path))
    sub = tmp_path / "version_0"
    sub.mkdir()
    for name in ("epoch=0-val_loss=0.71.ckpt", "epoch=3-val_loss=0.42.ckpt",
                 "epoch=5-val_loss=0.55.ckpt"):
        (sub / name).write_bytes(b"")
    got = retrieve_best_checkpoint(str(tmp_path))
    assert got == jax_retrieve_best(str(tmp_path))
    assert os.path.basename(got) == "epoch=3-val_loss=0.42.ckpt"


def test_block_data_module_loaders():
    blocks = [_port(d) for d in _ragged_blocks(3)]
    dm = BlockDataModule(blocks, blocks[:2], blocks[2:3])
    assert dm.train_dataloader() == blocks and dm.val_dataloader() == blocks[:2]
    assert dm.test_dataloader() == blocks[2:3]
    dm = BlockDataModule(blocks, blocks[:3], batch_size=2, shuffle=True, num_workers=1,
                         seed=4)
    train = dm.train_dataloader()
    assert isinstance(train, DataLoaderLite) and len(train) == 4
    assert sum(b.labels.shape[0] for b in train) == sum(b.labels.shape[0] for b in blocks)
    val = list(dm.val_dataloader())
    _assert_blocks_equal(val[0], collate_blocks(blocks[:2]))
    _assert_blocks_equal(val[1], collate_blocks(blocks[2:3]))
