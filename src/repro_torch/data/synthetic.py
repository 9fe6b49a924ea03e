"""Synthetic CTR data with Zipf-unbalanced id frequencies.

The paper's entire phenomenon is driven by the *exponential* frequency
imbalance of ids (Fig. 4): frequent ids appear in every batch, infrequent ids
in ~b.P(id) of batches, and that difference is what breaks linear/sqrt LR
scaling. The generator therefore:

* draws each categorical field's ids from a Zipf(a) law over its vocab
  (a ~ 1.1-1.4 matches the Criteo shape),
* defines a ground-truth clickthrough model with first-order id effects +
  low-rank pairwise interactions + a dense-feature term (an FM-family
  teacher, so DeepFM-class students can realize high AUC),
* samples labels from Bernoulli(sigmoid(score / T + bias)) calibrated to a
  target positive rate (~25%, Criteo-like).

Everything is deterministic in (seed, sizes) and generated with NumPy on the
host; batches are served as device arrays.

The port's own copy of the CTR half of ``repro.data.synthetic`` (pure
Python / NumPy), kept verbatim so that ``repro_torch`` imports nothing of
the JAX package; ``make_lm_tokens`` comes with the LM side.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, Sequence

import numpy as np

logger = logging.getLogger(__name__)

# (n_rows, batch_size) pairs note_dropped_remainder has seen (kept for
# introspection/tests) and the process-wide one-shot: the note fires once
# per *process*, not once per distinct shape — a streaming source re-opens
# as it grows, so every re-open used to present a fresh (n, batch) pair
# and re-fire what was meant to be a one-time note
_noted_remainders: set = set()
_tail_note_fired: bool = False


def note_dropped_remainder(n: int, batch_size: int) -> None:
    """One-time (per process) note that a sub-batch row tail is dropped.

    ``train_ctr`` (and the engine's ``chunk_epoch``, and the streaming
    re-batcher at end-of-stream) iterate with ``drop_remainder=True`` —
    static batch shapes keep every step on one compiled executable — which
    silently discarded up to ``batch_size - 1`` rows per epoch. Surfacing
    it once makes the loss of data explicit; evaluation always runs with
    ``drop_remainder=False`` and never drops rows. Documented in
    docs/cli.md ("Batching and the row tail").
    """
    global _tail_note_fired
    rem = n % batch_size
    if not rem:
        return
    _noted_remainders.add((n, batch_size))
    if _tail_note_fired:
        return
    _tail_note_fired = True
    logger.warning(
        "[data] dropping a %d-row tail each epoch (%d rows / batch %d); "
        "static step shapes require whole batches — shrink the batch or "
        "pass drop_remainder=False where supported (eval already does). "
        "Further tail-drop notes are suppressed for this process",
        rem, n, batch_size)


@dataclasses.dataclass
class CTRDataset:
    ids: np.ndarray          # [N, F] int32
    dense: np.ndarray        # [N, Dd] float32
    labels: np.ndarray       # [N] float32 in {0, 1}
    vocab_sizes: tuple

    def __len__(self) -> int:
        return self.ids.shape[0]

    def split(self, train_frac: float = 0.9):
        n_train = int(len(self) * train_frac)
        tr = CTRDataset(
            self.ids[:n_train], self.dense[:n_train], self.labels[:n_train],
            self.vocab_sizes)
        te = CTRDataset(
            self.ids[n_train:], self.dense[n_train:], self.labels[n_train:],
            self.vocab_sizes)
        return tr, te


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def make_ctr_dataset(
    n_samples: int,
    vocab_sizes: Sequence[int],
    n_dense: int = 4,
    *,
    zipf_a: float = 1.2,
    latent_rank: int = 4,
    target_pos_rate: float = 0.25,
    noise_temp: float = 1.0,
    seed: int = 0,
) -> CTRDataset:
    rng = np.random.default_rng(seed)
    n_fields = len(vocab_sizes)

    # --- id draws, Zipf per field (shuffled so id order is not rank order)
    ids = np.empty((n_samples, n_fields), np.int32)
    perms = []
    for f, v in enumerate(vocab_sizes):
        p = _zipf_probs(v, zipf_a)
        raw = rng.choice(v, size=n_samples, p=p)
        perm = rng.permutation(v)
        perms.append(perm)
        ids[:, f] = perm[raw]

    dense = rng.normal(size=(n_samples, n_dense)).astype(np.float32)

    # --- ground-truth FM teacher
    score = np.zeros(n_samples, np.float64)
    latent_sum = np.zeros((n_samples, latent_rank), np.float64)
    latent_sq = np.zeros((n_samples, latent_rank), np.float64)
    for f, v in enumerate(vocab_sizes):
        w = rng.normal(scale=1.0 / np.sqrt(n_fields), size=v)
        lv = rng.normal(
            scale=1.0 / np.sqrt(latent_rank * n_fields), size=(v, latent_rank)
        )
        score += w[ids[:, f]]
        latent_sum += lv[ids[:, f]]
        latent_sq += lv[ids[:, f]] ** 2
    score += 2.0 * (0.5 * (latent_sum**2 - latent_sq)).sum(axis=-1)
    wd = rng.normal(scale=0.3 / np.sqrt(n_dense), size=n_dense)
    score += dense @ wd

    # --- calibrate bias for the target positive rate
    score = score / (noise_temp * max(score.std(), 1e-6))
    lo, hi = -20.0, 20.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        rate = (1.0 / (1.0 + np.exp(-(score * 2.0 + mid)))).mean()
        if rate > target_pos_rate:
            hi = mid
        else:
            lo = mid
    probs = 1.0 / (1.0 + np.exp(-(score * 2.0 + 0.5 * (lo + hi))))
    labels = (rng.random(n_samples) < probs).astype(np.float32)

    return CTRDataset(ids, dense.astype(np.float32), labels, tuple(vocab_sizes))


def iterate_batches(
    ds: CTRDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[dict]:
    """One epoch of batches as host arrays (caller device_puts / jits over)."""
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if drop_remainder:
        note_dropped_remainder(n, batch_size)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, stop, batch_size):
        idx = order[start : start + batch_size]
        yield {
            "ids": ds.ids[idx],
            "dense": ds.dense[idx],
            "labels": ds.labels[idx],
        }

