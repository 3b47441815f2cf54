"""The port's block and loader sharding (``waveformml_tpu_torch/parallel/
mesh.py``) against the JAX package's, on the same seeded inputs:
``split_block_for_devices`` over 3- and 4-column coords, event and
per-row labels, per-row extras, cached padded edge lists (with and
without their mask), fewer events than parts (empty trailing blocks) and
per-row coords; ``stack_shards`` over ragged shapes; and
``shard_loader_round_robin`` over loaders whose length the ranks do not
divide (the tail slots wrap to the first batches, cycling). Equal means
equal arrays, dtypes included."""
import numpy as np
import pytest

from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
from waveformml_tpu.engineering.trainer import shard_loader_round_robin as jax_round_robin
from waveformml_tpu.parallel import mesh as jax_mesh
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.parallel import mesh


def _block(kind: str, seed: int = 7) -> dict:
    """The fields of a block of ``kind``: 7 events of 1-4 rows (fewer for
    ``few``) over the 14 x 11 grid."""
    rng = np.random.default_rng(seed)
    n_events = 2 if kind == "few" else 7
    rows = []
    for e in range(n_events):
        for s in rng.choice(154, size=int(rng.integers(1, 5)), replace=False):
            rows.append([s % 14, s // 14, int(rng.integers(0, 16)), e] if kind == "4col"
                        else [s % 14, s // 14, e])
    coords = np.asarray(rows, np.int32)
    n = coords.shape[0]
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    labels = (rng.normal(size=(n, 3)).astype(np.float32) if kind == "per_row"
              else rng.integers(0, 2, n_events).astype(np.int64))
    extras = {}
    if kind in ("extras", "edges", "edges_no_mask"):
        extras["phys"] = rng.normal(size=(n, 2)).astype(np.float32)
    if kind in ("edges", "edges_no_mask"):
        src, dst = [], []
        ev = coords[:, -1]
        for i in range(n):
            for j in range(n):
                if i != j and ev[i] == ev[j]:
                    src.append(j)
                    dst.append(i)
        live = np.asarray([src, dst], np.int64)
        cap = live.shape[1] + 5
        edges = np.zeros((2, cap), np.int64)
        edges[:, :live.shape[1]] = live
        mask = np.zeros(cap, bool)
        mask[:live.shape[1]] = True
        perm = rng.permutation(cap)   # live and padded slots interleaved
        extras["edges_knn3"] = edges[:, perm]
        if kind == "edges":
            extras["edge_mask_knn3"] = mask[perm]
    if kind == "rows":
        coords = rng.integers(0, 308, n).astype(np.int32)
        labels = rng.normal(size=n).astype(np.float32)
    return {"coords": coords, "feats": feats, "labels": labels, "extras": extras}


def _assert_same_blocks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("coords", "feats", "labels"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b)
        assert sorted(g.extras) == sorted(w.extras)
        for k in g.extras:
            a, b = np.asarray(g.extras[k]), np.asarray(w.extras[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["3col", "4col", "per_row", "extras", "edges",
                                  "edges_no_mask", "few", "rows"])
def test_split_block_for_devices_matches_jax(kind, n_devices):
    fields = _block(kind)
    got = mesh.split_block_for_devices(FileBlock(**fields), n_devices)
    want = jax_mesh.split_block_for_devices(JaxFileBlock(**fields), n_devices)
    _assert_same_blocks(got, want)
    if kind == "few" and n_devices > 2:
        assert got[-1].coords.shape[0] == 0 and got[-1].labels.shape[0] == 0


def test_split_block_edges_stay_inside_their_shard():
    """Every remapped edge joins two rows of one event of its shard, and
    the shards together hold every live edge of the block."""
    fields = _block("edges")
    block = FileBlock(**fields)
    shards = mesh.split_block_for_devices(block, 3)
    total = 0
    for shard in shards:
        e = shard.extras["edges_knn3"]
        assert shard.extras["edge_mask_knn3"].all()
        assert e.min(initial=0) >= 0 and e.max(initial=-1) < shard.coords.shape[0]
        ev = shard.coords[:, -1]
        assert (ev[e[0]] == ev[e[1]]).all()
        total += e.shape[1]
    assert total == int(fields["extras"]["edge_mask_knn3"].sum())


@pytest.mark.parametrize("ragged", [False, True])
def test_stack_shards_matches_jax(ragged):
    rng = np.random.default_rng(3)
    shards = []
    for i in range(3):
        n = 5 + (i if ragged else 0)
        shards.append({"coords": rng.integers(0, 9, (n, 3)).astype(np.int32),
                       "mask": rng.random(n) > 0.3,
                       "edges_knn3": rng.integers(0, n, (2, 4 + 2 * i if ragged else 4)),
                       "labels": rng.integers(0, 2, 8).astype(np.int64)})
    got, want = mesh.stack_shards(shards), jax_mesh.stack_shards(shards)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("total,ranks", [(7, 2), (8, 3), (5, 4), (4, 4), (1, 2), (1, 3),
                                         (2, 5), (1, 8), (3, 8), (6, 1)])
def test_shard_loader_round_robin_matches_jax(total, ranks):
    loader = list(range(total))
    per_rank = []
    for rank in range(ranks):
        got = list(mesh.shard_loader_round_robin(loader, ranks, rank))
        assert got == list(jax_round_robin(loader, ranks, rank))
        assert len(mesh.shard_loader_round_robin(loader, ranks, rank)) == len(got)
        assert len(got) == -(-total // ranks)
        per_rank.append(got)
    assert set(b for got in per_rank for b in got) == set(loader)


def test_round_robin_closes_the_loader_iterator():
    """Leaving the sharded loader early closes the loader's own iterator (a
    prefetching loader's thread stops with it)."""
    closed = []

    class Loader:
        def __len__(self):
            return 6

        def __iter__(self):
            try:
                yield from range(6)
            finally:
                closed.append(True)

    it = iter(mesh.shard_loader_round_robin(Loader(), 2, 1))
    assert next(it) == 1
    it.close()
    assert closed == [True]


def test_initialize_distributed_needs_its_card(monkeypatch):
    """Without ``device`` a rank trains on ``cuda:<local rank>``: on a host
    without that card it raises before any rendezvous; a coordinator needs
    the process count and id."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.initialize_distributed("localhost:1", 1, 0)
    with pytest.raises(ValueError, match="num_processes and process_id"):
        mesh.initialize_distributed("localhost:1", device="cpu")
