"""The port's data helpers and input pipeline, on the CPU.

The loaders are a private copy of the JAX package's numpy module, so
their arrays must be equal, not close: the synthetic sets from the same
seeds, and the IDX and CIFAR-pickle readers on small files written to
``tmp_path``.  The Prefetcher tests are the CPU counterparts of
tests/test_data_pipeline.py; the overlap test shows overlap by the order
of events (the source has produced the next batch while the consumer
still holds the current one), not by a wall-clock margin, which fails
under a loaded machine.  Staging on the card is checked by
tests/test_torch_resnet_cuda.py and chip_smoke.py.
"""
import gzip
import os
import pickle
import struct
import threading

import numpy as np
import pytest
import torch

from kungfu_tpu import data as JD
from kungfu_tpu_torch import data as TD
from kungfu_tpu_torch.benchmarks.gpt import solo_group
from kungfu_tpu_torch.data.pipeline import (Prefetcher, prefetch_to_mesh,
                                            to_device)

CPU = to_device("cpu")


def _equal_splits(got, want):
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype


def test_synthetic_sets_equal_jax():
    for kw in (dict(means_seed=None), dict(means_seed=4)):
        got = TD.synthetic_image_classification(64, (8, 8, 3), 5, seed=3,
                                                **kw)
        want = JD.synthetic_image_classification(64, (8, 8, 3), 5, seed=3,
                                                 **kw)
        _equal_splits([got], [want])
    _equal_splits(TD.mnist(None), JD.mnist(None))
    _equal_splits(TD.cifar10(None), JD.cifar10(None))
    assert TD.mnist(None)[0][0].shape == (8192, 28, 28, 1)
    assert TD.cifar10(None)[1][0].shape == (1024, 32, 32, 3)


def _write_idx(path, arr, code):
    head = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    return head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()


def test_read_idx_and_mnist_dir(tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    (tmp_path / "train-images-idx3-ubyte").write_bytes(
        _write_idx(tmp_path, imgs, 0x08))
    with gzip.open(tmp_path / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(_write_idx(tmp_path, labels, 0x08))
    (tmp_path / "t10k-images.idx3-ubyte").write_bytes(
        _write_idx(tmp_path, imgs[:2], 0x08))
    (tmp_path / "t10k-labels.idx1-ubyte").write_bytes(
        _write_idx(tmp_path, labels[:2], 0x08))
    f32 = rng.randn(3, 4).astype(np.float32)
    (tmp_path / "f.idx").write_bytes(_write_idx(tmp_path, f32, 0x0D))
    for path in ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                 "f.idx"):
        got = TD.read_idx(str(tmp_path / path))
        want = JD.read_idx(str(tmp_path / path))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(TD.read_idx(str(tmp_path / "f.idx")), f32)
    (tmp_path / "bad.idx").write_bytes(b"\x01\x00\x08\x01" + b"\0" * 8)
    with pytest.raises(ValueError, match="bad IDX magic"):
        TD.read_idx(str(tmp_path / "bad.idx"))
    for normalize in (True, False):
        _equal_splits(TD.mnist(str(tmp_path), normalize),
                      JD.mnist(str(tmp_path), normalize))
    assert TD.mnist(str(tmp_path))[0][0].shape == (5, 28, 28, 1)


def test_cifar_pickles(tmp_path):
    rng = np.random.RandomState(1)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.randint(0, 256, (3, 3072)).astype(np.uint8),
             b"labels": list(rng.randint(0, 10, 3))}
        with open(tmp_path / name, "wb") as f:
            pickle.dump(d, f)
    got = TD.cifar10(str(tmp_path))
    _equal_splits(got, JD.cifar10(str(tmp_path)))
    assert got[0][0].shape == (15, 32, 32, 3) and got[1][0].max() <= 1.0


def test_missing_data_dir_raises(tmp_path):
    missing = str(tmp_path / "nowhere")
    for loader in (TD.mnist, TD.cifar10):
        with pytest.raises(FileNotFoundError, match="does not exist"):
            loader(missing)
    os.mkdir(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="missing MNIST file"):
        TD.mnist(str(tmp_path / "empty"))


# ------------------------------------------------------------ Prefetcher
def test_prefetcher_yields_all_batches_in_order():
    batches = [{"x": np.full((4, 2), i), "y": np.arange(4) + i}
               for i in range(7)]
    with Prefetcher(iter(batches), depth=3, place=CPU) as pf:
        got = list(pf)
    assert len(got) == 7
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor)
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        np.testing.assert_array_equal(b["y"].numpy(), batches[i]["y"])


def test_prefetcher_overlaps_slow_source():
    """While the consumer holds batch i, the worker has already pulled
    batch i+1 from the source: the source's pull count, read inside the
    consumer's step, is ahead of the batch being consumed."""
    n, pulled = 6, []
    ahead = threading.Condition()

    def source():
        for i in range(n):
            with ahead:
                pulled.append(i)
                ahead.notify_all()
            yield np.full((2,), i)

    with Prefetcher(source(), depth=2, place=CPU) as pf:
        for i, batch in enumerate(pf):
            assert int(batch[0]) == i
            if i + 1 < n:
                with ahead:          # the next pull, without us asking
                    assert ahead.wait_for(lambda: len(pulled) > i + 1,
                                          timeout=30), (i, pulled)
    assert pulled == list(range(n))


def test_prefetcher_surfaces_source_exception():
    def bad_source():
        yield np.zeros(2)
        raise RuntimeError("disk on fire")

    pf = Prefetcher(bad_source(), depth=2, place=CPU)
    next(pf)
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(pf)
    pf.close()


def test_prefetcher_exhaustion_is_latched():
    """next() after StopIteration, after a surfaced error, or after
    close() raises immediately instead of blocking forever."""
    pf = Prefetcher(iter([np.zeros(2)]), depth=2, place=CPU)
    assert len(list(pf)) == 1
    assert list(pf) == []
    with pytest.raises(StopIteration):
        next(pf)

    def bad():
        raise RuntimeError("boom")
        yield                                  # pragma: no cover

    pf2 = Prefetcher(bad(), depth=1, place=CPU)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="boom"):
            next(pf2)

    pf3 = Prefetcher(iter([np.zeros(2)] * 5), depth=1, place=CPU)
    next(pf3)
    pf3.close()
    with pytest.raises(StopIteration):
        next(pf3)


def test_prefetcher_close_mid_stream():
    """Early exit doesn't deadlock on a blocked producer."""
    def endless():
        i = 0
        while True:
            yield np.full((2,), i)
            i += 1

    pf = Prefetcher(endless(), depth=1, place=CPU)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_defaults_to_the_card():
    """The default placement is the card; without one it raises, never
    staging on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prefetcher(iter([np.zeros(2)]))
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter([]), depth=0, place=CPU)


def test_prefetch_to_mesh_stages_the_rank_block():
    """One rank of one: its block is the whole global batch (the
    two-rank case runs in tests/test_torch_resnet.py)."""
    batches = [(np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + 100 * i,
                np.arange(8) + i) for i in range(3)]
    with solo_group(torch.device("cpu")):
        with prefetch_to_mesh(iter(batches), depth=2, device="cpu") as pf:
            got = list(pf)
    assert len(got) == 3
    for (bx, by), (wx, wy) in zip(got, batches):
        np.testing.assert_array_equal(bx.numpy(), wx)
        np.testing.assert_array_equal(by.numpy(), wy)


def test_prefetch_feeds_train_step():
    """Staged batches go into build_train_step as the rank's block
    (``local=True``), and training progresses."""
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.training import build_train_step

    params = {"w": torch.zeros(3, 2)}

    def loss_fn(p, batch):
        bx, by = batch
        return torch.mean((bx @ p["w"] - by) ** 2)

    rng = np.random.RandomState(0)
    W = rng.randn(3, 2).astype(np.float32)
    batches = []
    for _ in range(5):
        bx = rng.randn(8, 3).astype(np.float32)
        batches.append((bx, bx @ W))
    losses = []
    with solo_group(torch.device("cpu")):
        opt = synchronous_sgd(torch.optim.SGD([params["w"]], lr=0.1))
        step = build_train_step(loss_fn, opt, params)
        with prefetch_to_mesh(iter(batches), depth=2, device="cpu") as pf:
            for batch in pf:
                losses.append(float(step(batch, local=True)))
    assert len(losses) == 5
    assert losses[-1] < losses[0]
