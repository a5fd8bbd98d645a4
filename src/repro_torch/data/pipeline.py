"""Deterministic synthetic data pipelines, host-sharded, with prefetch
(copy of ``repro.data.pipeline``: numpy, so the Philox streams give the
same bytes).

Real-cluster shape: every host generates only its slice of the global batch
(``host_id``/``num_hosts``), the loader is a background-thread prefetcher,
and every batch is reproducible from (seed, step) alone — restart-safe by
construction (checkpoint stores the step; the pipeline needs no state).

The LM stream is a learnable synthetic language: labels are an affine
permutation of the token (plus a context-mix term), so cross-entropy has a
clean floor and "loss decreases" tests are meaningful.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, global_batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        assert global_batch % num_hosts == 0
        self.vocab = vocab
        self.local_batch = global_batch // num_hosts
        self.seq = seq_len
        self.seed = seed
        self.host = host_id

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=[(self.seed << 20) ^ self.host, (step << 4) ^ 0xB]))
        tok = rng.integers(0, self.vocab, size=(self.local_batch, self.seq),
                           dtype=np.int64)
        # learnable map: label_t = (a * tok_t + b + tok_{t-1}) % V
        prev = np.roll(tok, 1, axis=1)
        prev[:, 0] = 0
        labels = (5 * tok + 3 + prev) % self.vocab
        return {"tokens": tok.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class SyntheticImages:
    """Class-conditional Gaussian blobs -> learnable image classification."""

    def __init__(self, num_classes: int, image_size: int, global_batch: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        self.nc = num_classes
        self.sz = image_size
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host = host_id
        rng = np.random.Generator(np.random.Philox(key=[seed, 1]))
        self.means = rng.standard_normal((num_classes, 8)).astype(np.float32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=[(self.seed << 20) ^ self.host, (step << 4) ^ 0xF]))
        labels = rng.integers(0, self.nc, size=(self.local_batch,))
        base = self.means[labels]                       # (B, 8)
        grid = np.linspace(-1, 1, self.sz, dtype=np.float32)
        gx, gy = np.meshgrid(grid, grid)
        feats = np.stack([gx, gy, gx * gy, gx ** 2, gy ** 2,
                          np.sin(3 * gx), np.cos(3 * gy),
                          np.ones_like(gx)], -1)        # (H, W, 8)
        img = np.einsum("bf,hwf->bhw", base, feats)[..., None]
        img = np.repeat(img, 3, axis=-1)
        img += 0.3 * rng.standard_normal(img.shape).astype(np.float32)
        return {"images": img.astype(np.float32),
                "labels": labels.astype(np.int32)}


class Prefetcher:
    """Background-thread prefetch (depth-k) over a step-indexed source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self.q.put(self.source.batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
