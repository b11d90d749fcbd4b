"""Dataset and rank-partitioned batches for the port.

Copies of ``torchmpi_tpu/utils/data.py``'s ``synthetic_mnist``,
``synthetic_imagenet`` and ``synthetic_tokens`` (numpy only, same arrays
for the same arguments)
and ``DistributedIterator``
(``examples/mnist/makeiterator.lua``: the global batch is split evenly over
the ranks, each rank drawing from its own contiguous shard). The iterator
puts the dataset on the device once and yields rank-stacked device
batches ``(x[p, B/p, ...], y[p, B/p])`` in the JAX iterator's order for the
same seed; labels are int64, PyTorch's index type. It needs no prefetch
thread: a batch is one gather on the device.
"""

from __future__ import annotations

from typing import Iterator, Tuple, Union

import numpy as np
import torch


def synthetic_mnist(
    num_train: int = 8192,
    num_test: int = 2048,
    num_classes: int = 10,
    seed: int = 1234,
    image_shape: Tuple[int, int] = (28, 28),
):
    """Deterministic MNIST-shaped dataset: each class is a smoothed random
    prototype image; samples are prototype + gaussian noise, clipped to
    [0, 1]. Returns ``((x_train, y_train), (x_test, y_test))`` as numpy."""
    rng = np.random.RandomState(seed)
    h, w = image_shape
    protos = rng.randn(num_classes, h * w).astype(np.float32)
    # Smooth prototypes to make pixels locally correlated (image-like).
    protos = protos.reshape(num_classes, h, w)
    for _ in range(2):
        protos = (
            protos
            + np.roll(protos, 1, axis=1)
            + np.roll(protos, -1, axis=1)
            + np.roll(protos, 1, axis=2)
            + np.roll(protos, -1, axis=2)
        ) / 5.0
    protos = protos.reshape(num_classes, h * w)
    protos /= np.abs(protos).max(axis=1, keepdims=True)

    def make(n, rs):
        labels = rs.randint(0, num_classes, size=n).astype(np.int32)
        x = protos[labels] + 0.9 * rs.randn(n, h * w).astype(np.float32)
        x = np.clip(0.5 + 0.5 * x, 0.0, 1.0).astype(np.float32)
        return x.reshape(n, h, w), labels

    train = make(num_train, np.random.RandomState(seed + 1))
    test = make(num_test, np.random.RandomState(seed + 2))
    return train, test


def synthetic_imagenet(
    num_train: int = 1024,
    num_test: int = 256,
    num_classes: int = 1000,
    image_size: int = 224,
    seed: int = 4321,
):
    """Deterministic ImageNet-shaped dataset (NHWC float32 in [0, 1]):
    class prototypes are smooth low-frequency color fields (8x8 upsampled);
    samples add gaussian noise. Returns ``((x_train, y_train), (x_test,
    y_test))`` as numpy, labels int32."""
    rng = np.random.RandomState(seed)
    h = w = image_size
    lo = 8
    protos_lo = rng.randn(num_classes, lo, lo, 3).astype(np.float32)
    reps = -(-h // lo)

    def upsample(p):
        big = np.repeat(np.repeat(p, reps, axis=0), reps, axis=1)
        return big[:h, :w]

    def make(n, rs):
        labels = rs.randint(0, num_classes, size=n).astype(np.int32)
        x = np.empty((n, h, w, 3), np.float32)
        for i in range(n):
            base = upsample(protos_lo[labels[i]])
            x[i] = base + 0.5 * rs.randn(h, w, 3).astype(np.float32)
        x = np.clip(0.5 + 0.25 * x, 0.0, 1.0)
        return x, labels

    train = make(num_train, np.random.RandomState(seed + 1))
    test = make(num_test, np.random.RandomState(seed + 2))
    return train, test


def synthetic_tokens(
    num_seqs: int = 512,
    seq_len: int = 1024,
    vocab: int = 8192,
    seed: int = 97,
):
    """Deterministic LM dataset: ``(tokens_in, tokens_target)`` int32 pairs
    of shape ``[num_seqs, seq_len]`` where target[t] = in[t+1]. The stream
    is an order-1 structured process (each token is a fixed affine map of
    its predecessor plus occasional jumps), so a model genuinely reduces
    loss by attending backwards — same zero-egress role as
    ``synthetic_mnist``."""
    rs = np.random.RandomState(seed)
    raw = np.empty((num_seqs, seq_len + 1), np.int64)
    raw[:, 0] = rs.randint(0, vocab, size=num_seqs)
    jumps = rs.rand(num_seqs, seq_len) < 0.05
    noise = rs.randint(0, vocab, size=(num_seqs, seq_len))
    for t in range(seq_len):
        step = (raw[:, t] * 31 + 17) % vocab
        raw[:, t + 1] = np.where(jumps[:, t], noise[:, t], step)
    tokens = raw.astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


class DistributedIterator:
    """Rank-partitioned minibatches; each ``iter()`` is one epoch.

    Partial tail batches are dropped, like the reference's fixed
    ``batch/size`` partitioning. Each epoch reshuffles within every rank's
    shard from ``RandomState(seed + epoch)``, as the JAX iterator does."""

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        batch_size: int,
        num_ranks: int,
        device: Union[str, torch.device],
        shuffle: bool = True,
        seed: int = 0,
    ):
        if batch_size < num_ranks or batch_size % num_ranks != 0:
            raise ValueError(
                f"global batch {batch_size} must be a positive multiple of "
                f"the {num_ranks} ranks (>= one sample per rank)"
            )
        self.batch_size = batch_size
        self.p = num_ranks
        self.per_rank = batch_size // num_ranks
        self.shuffle = shuffle
        self.seed = seed
        self.device = torch.device(device)
        self.shard_len = len(x) // num_ranks
        self.batches_per_epoch = self.shard_len // self.per_rank
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"dataset of {len(x)} samples is too small for {num_ranks} "
                f"ranks x {self.per_rank} per-rank batch"
            )
        self._x = torch.as_tensor(np.ascontiguousarray(x), device=self.device)
        self._y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        self._epoch = 0

    def __len__(self) -> int:
        return self.batches_per_epoch

    def _epoch_order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.shard_len * self.p).reshape(self.p, self.shard_len)
        rs = np.random.RandomState(self.seed + self._epoch)
        # Each rank permutes within its own contiguous shard.
        return np.stack(
            [r * self.shard_len + rs.permutation(self.shard_len) for r in range(self.p)]
        )

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        order = torch.as_tensor(self._epoch_order(), device=self.device)
        self._epoch += 1
        for b in range(self.batches_per_epoch):
            idx = order[:, b * self.per_rank : (b + 1) * self.per_rank]
            yield self._x[idx], self._y[idx]
