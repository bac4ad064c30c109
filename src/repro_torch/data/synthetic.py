"""Synthetic data (a copy of ``repro.data.synthetic``: numpy only, so the
same seed gives the same data and batches in both packages).

Two generators: token streams for the transformer testbed
(:func:`synthetic_token_batch`) and a class-separable MNIST-like image
dataset.

Each class has a smooth random 28x28 prototype; samples are prototype +
Gaussian noise. Heterogeneity across workers is a Dirichlet(alpha_het) label
split (alpha -> inf is the homogeneous split).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


def synthetic_token_batch(rng: np.random.Generator, n_workers: int,
                          local_batch: int, seq_len: int,
                          vocab: int) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic token stream (learnable bigram structure):
    ``{"tokens": int32 [n_workers, local_batch, seq_len]}``."""
    base = rng.integers(0, vocab, size=(n_workers, local_batch, seq_len))
    # inject predictable structure: every other token repeats its neighbor
    base[..., 1::2] = (base[..., 0::2] + 1) % vocab
    return {"tokens": base.astype(np.int32)}


@dataclasses.dataclass
class SyntheticMNIST:
    """Class-separable image dataset, partitioned across workers."""

    n_workers: int = 10
    per_worker: int = 6000
    n_classes: int = 10
    noise: float = 0.35
    alpha_het: float = 1e6  # Dirichlet concentration; large = homogeneous
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        protos = []
        for _ in range(self.n_classes):
            low = rng.normal(size=(7, 7))
            img = np.kron(low, np.ones((4, 4)))  # 28x28 blocks
            img = (img - img.min()) / (np.ptp(img) + 1e-9)
            protos.append(img.astype(np.float32))
        self.prototypes = np.stack(protos)  # [10, 28, 28]

        props = rng.dirichlet([self.alpha_het] * self.n_classes,
                              size=self.n_workers)
        self.label_props = props
        self.images = np.zeros((self.n_workers, self.per_worker, 28, 28, 1),
                               np.float32)
        self.labels = np.zeros((self.n_workers, self.per_worker), np.int32)
        for w in range(self.n_workers):
            counts = rng.multinomial(self.per_worker, props[w])
            labels = np.repeat(np.arange(self.n_classes), counts)
            rng.shuffle(labels)
            noise = rng.normal(scale=self.noise,
                               size=(self.per_worker, 28, 28)).astype(np.float32)
            self.images[w, :, :, :, 0] = self.prototypes[labels] + noise
            self.labels[w] = labels

        # held-out eval set (drawn iid from the same distribution)
        n_eval = 2000
        elabels = rng.integers(0, self.n_classes, n_eval)
        enoise = rng.normal(scale=self.noise, size=(n_eval, 28, 28)
                            ).astype(np.float32)
        self.eval_images = (self.prototypes[elabels] + enoise)[..., None]
        self.eval_labels = elabels.astype(np.int32)
        self._rng = rng

    def worker_batches(self, batch_size: int) -> "BatchFn":
        return BatchFn(self, batch_size)

    @property
    def eval_batch(self) -> Dict[str, np.ndarray]:
        return {"images": self.eval_images, "labels": self.eval_labels}


class BatchFn:
    """Callable ``batch_fn(step) -> stacked per-worker batches`` (numpy,
    deterministic given the dataset seed; called in step order)."""

    def __init__(self, ds: SyntheticMNIST, batch_size: int):
        self.ds = ds
        self.bs = batch_size
        self.rng = np.random.default_rng(ds.seed + 1)

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, self.ds.per_worker,
                                size=(self.ds.n_workers, self.bs))
        imgs = np.stack([self.ds.images[w, idx[w]]
                         for w in range(self.ds.n_workers)])
        labs = np.stack([self.ds.labels[w, idx[w]]
                         for w in range(self.ds.n_workers)])
        return {"images": imgs, "labels": labs}
