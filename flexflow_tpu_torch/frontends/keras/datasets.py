"""Keras datasets (port of ``flexflow_tpu/frontends/keras/datasets.py``;
reference: python/flexflow/keras/datasets/{mnist,cifar10,reuters}.py).

The reference downloads archives from the network. Nothing here
downloads: each loader first looks for a cached numpy archive under
``~/.keras/datasets`` (same location the reference uses) and otherwise
generates a deterministic synthetic dataset with the real shapes and
dtypes — sufficient for the e2e/example tests, which only need
correctly-shaped pipelines.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_CACHE = os.path.expanduser("~/.keras/datasets")


def _cached(fname: str):
    path = os.path.join(_CACHE, fname)
    if os.path.exists(path):
        with np.load(path, allow_pickle=True) as f:
            return {k: f[k] for k in f.files}
    return None


class mnist:
    @staticmethod
    def load_data(path: str = "mnist.npz", n_train: int = 6000, n_test: int = 1000):
        c = _cached(path)
        if c is not None:
            return (c["x_train"], c["y_train"]), (c["x_test"], c["y_test"])
        rs = np.random.RandomState(0)
        x_train = (rs.rand(n_train, 28, 28) * 255).astype(np.uint8)
        y_train = rs.randint(0, 10, size=(n_train,)).astype(np.uint8)
        x_test = (rs.rand(n_test, 28, 28) * 255).astype(np.uint8)
        y_test = rs.randint(0, 10, size=(n_test,)).astype(np.uint8)
        return (x_train, y_train), (x_test, y_test)


class cifar10:
    @staticmethod
    def load_data(n_train: int = 6000, n_test: int = 1000) -> Tuple:
        c = _cached("cifar10.npz")
        if c is not None:
            return (c["x_train"], c["y_train"]), (c["x_test"], c["y_test"])
        rs = np.random.RandomState(1)
        # NCHW uint8 like the reference's pickled batches (cifar.py)
        x_train = (rs.rand(n_train, 3, 32, 32) * 255).astype(np.uint8)
        y_train = rs.randint(0, 10, size=(n_train, 1)).astype(np.uint8)
        x_test = (rs.rand(n_test, 3, 32, 32) * 255).astype(np.uint8)
        y_test = rs.randint(0, 10, size=(n_test, 1)).astype(np.uint8)
        return (x_train, y_train), (x_test, y_test)


class reuters:
    @staticmethod
    def load_data(num_words: int = 10000, maxlen: int = 80, n_train: int = 2000, n_test: int = 500):
        c = _cached("reuters.npz")
        if c is not None:
            return (c["x_train"], c["y_train"]), (c["x_test"], c["y_test"])
        rs = np.random.RandomState(2)
        x_train = rs.randint(1, num_words, size=(n_train, maxlen)).astype(np.int32)
        y_train = rs.randint(0, 46, size=(n_train,)).astype(np.int32)
        x_test = rs.randint(1, num_words, size=(n_test, maxlen)).astype(np.int32)
        y_test = rs.randint(0, 46, size=(n_test,)).astype(np.int32)
        return (x_train, y_train), (x_test, y_test)
