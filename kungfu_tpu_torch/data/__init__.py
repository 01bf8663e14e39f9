"""Dataset helpers: MNIST / CIFAR-10 loaders and synthetic stand-ins
(a private copy of kungfu_tpu/data/__init__.py, which is numpy only).

The loaders read the standard on-disk formats from a data directory
(MNIST idx files, optionally gzipped; the CIFAR-10 python pickles).
``data_dir=None`` asks for deterministic synthetic data of the same
shapes and dtypes, drawn with the JAX package's seeds, so both packages
see the same arrays; a ``data_dir`` that is given but missing raises
rather than training on synthetic data.  Everything returned is numpy
(NHWC images); :mod:`kungfu_tpu_torch.data.pipeline` stages it on the
card.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["mnist", "cifar10", "synthetic_image_classification", "read_idx"]


def _open_maybe_gz(path: str):
    # the exact path wins; fall back to a .gz sibling only when absent
    if os.path.exists(path):
        return open(path, "rb")
    return gzip.open(path + ".gz", "rb")


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (the MNIST container format): big-endian magic
    ``[0, 0, dtype, ndim]`` then dims then raw data."""
    with _open_maybe_gz(path) as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: bad IDX magic")
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                  0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
        if dtype_code not in dtypes:
            raise ValueError(f"{path}: unknown IDX dtype 0x{dtype_code:02x}")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.dtype(dtypes[dtype_code]
                                                      ).newbyteorder(">"))
        return data.reshape(dims).astype(dtypes[dtype_code])


def synthetic_image_classification(
        n: int, shape: Tuple[int, ...], num_classes: int, seed: int = 0,
        means_seed: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-separable synthetic data: per-class mean images
    plus noise, so optimizers actually reduce loss on it.

    ``means_seed`` fixes the class means independently of the sample
    noise (``seed``): a train and a test split drawn with the same
    ``means_seed`` but different ``seed`` describe the SAME
    classification task, so test accuracy measures generalisation rather
    than two unrelated mean banks (defaults to ``seed`` for standalone
    use)."""
    means_rng = np.random.RandomState(seed if means_seed is None
                                      else means_seed)
    means = means_rng.rand(num_classes, *shape).astype(np.float32)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = means[y] + 0.3 * rng.randn(n, *shape).astype(np.float32)
    return x.astype(np.float32), y


_MNIST_FILES = {
    "x_train": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    "y_train": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    "x_test": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
    "y_test": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
}


def mnist(data_dir: Optional[str] = None, normalize: bool = True):
    """((x_train, y_train), (x_test, y_test)) with x [N, 28, 28, 1] f32.

    ``data_dir`` holding the standard idx files (optionally .gz) loads the
    real dataset (reference: helpers/mnist.py load_datasets); ``None``
    yields deterministic synthetic data of the same shape.  A provided but
    missing directory raises rather than silently training on fake data.
    """
    if data_dir is not None and not os.path.isdir(data_dir):
        raise FileNotFoundError(f"data_dir {data_dir!r} does not exist "
                                f"(pass None for synthetic data)")
    if data_dir:
        out = {}
        for key, names in _MNIST_FILES.items():
            for name in names:
                p = os.path.join(data_dir, name)
                if os.path.exists(p) or os.path.exists(p + ".gz"):
                    out[key] = read_idx(p)
                    break
            else:
                raise FileNotFoundError(
                    f"{data_dir}: missing MNIST file {names[0]}[.gz]")
        xtr = out["x_train"][..., None].astype(np.float32)
        xte = out["x_test"][..., None].astype(np.float32)
        if normalize:
            xtr, xte = xtr / 255.0, xte / 255.0
        return ((xtr, out["y_train"].astype(np.int32)),
                (xte, out["y_test"].astype(np.int32)))
    xtr, ytr = synthetic_image_classification(8192, (28, 28, 1), 10,
                                              seed=0, means_seed=0)
    xte, yte = synthetic_image_classification(1024, (28, 28, 1), 10,
                                              seed=1, means_seed=0)
    return (xtr, ytr), (xte, yte)


def cifar10(data_dir: Optional[str] = None, normalize: bool = True):
    """((x_train, y_train), (x_test, y_test)) with x [N, 32, 32, 3] f32.

    ``data_dir`` = the extracted ``cifar-10-batches-py`` directory
    (reference: helpers/cifar.py); ``None`` = synthetic fallback; a
    provided but missing directory raises.
    """
    if data_dir is not None and not os.path.isdir(data_dir):
        raise FileNotFoundError(f"data_dir {data_dir!r} does not exist "
                                f"(pass None for synthetic data)")
    if data_dir:
        def load_batch(name):
            with open(os.path.join(data_dir, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return x.astype(np.float32), np.asarray(d[b"labels"], np.int32)

        xs, ys = zip(*[load_batch(f"data_batch_{i}") for i in range(1, 6)])
        xtr, ytr = np.concatenate(xs), np.concatenate(ys)
        xte, yte = load_batch("test_batch")
        if normalize:
            xtr, xte = xtr / 255.0, xte / 255.0
        return (xtr, ytr), (xte, yte)
    xtr, ytr = synthetic_image_classification(8192, (32, 32, 3), 10,
                                              seed=2, means_seed=2)
    xte, yte = synthetic_image_classification(1024, (32, 32, 3), 10,
                                              seed=3, means_seed=2)
    return (xtr, ytr), (xte, yte)
