"""Synthetic benchmark data — the port of ``synthetic_gpt_batch``,
``synthetic_image_batch``, ``synthetic_bert_batch``,
``synthetic_mnist_batch`` and ``softmax_xent`` from
``dear_pytorch_tpu/models/data.py``, and its host-side loaders
``load_real_digits`` and ``ShardedSampler`` (numpy, kept byte-for-byte:
the same seed gives the same arrays). The synthetic batches draw from an
explicit ``torch.Generator`` (the JAX package draws from a PRNG key, so the
two give different values for one seed; the tests feed both packages one
numpy batch instead). Images are NCHW here, NHWC there."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dear_pytorch_tpu_torch._device import resolve_device

__all__ = ["ShardedSampler", "load_real_digits", "softmax_xent",
           "synthetic_bert_batch", "synthetic_gpt_batch",
           "synthetic_image_batch", "synthetic_mnist_batch"]


def synthetic_gpt_batch(generator: torch.Generator, batch_size: int,
                        seq_len: int = 1024, vocab_size: int = 50257) -> dict:
    """``{"input_ids": [batch_size, seq_len] int64}`` on the generator's
    device: token ids only — the LM loss shifts them for its targets."""
    ids = torch.randint(0, vocab_size, (batch_size, seq_len),
                        generator=generator, device=generator.device)
    return {"input_ids": ids}


def _generator(generator, device) -> torch.Generator:
    """``generator`` itself, or a new one seeded with the int ``generator``
    on ``device`` (the card unless the caller says otherwise; no card
    raises)."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(generator))


def synthetic_bert_batch(generator, batch_size: int, seq_len: int = 64,
                         vocab_size: int = 30522,
                         masked_fraction: float = 0.15, *,
                         device=None) -> dict:
    """A random BERT pre-training batch with the JAX package's fields and
    dtypes (all int32): random ``input_ids`` ``[B, S]``, ``token_type_ids``
    0, a full ``attention_mask``, ``masked_lm_labels`` a random id where a
    uniform draw is below ``masked_fraction`` and -1 (the loss's
    ignore_index) elsewhere, and random binary ``next_sentence_labels``
    ``[B]``. ``generator`` as `synthetic_image_batch`'s."""
    generator = _generator(generator, device)
    dev = generator.device
    shape = (batch_size, seq_len)

    def ids(high, size):
        return torch.randint(0, high, size, generator=generator,
                             device=dev).to(torch.int32)

    input_ids = ids(vocab_size, shape)
    is_masked = torch.rand(shape, generator=generator,
                           device=dev) < masked_fraction
    mlm_labels = torch.where(is_masked, ids(vocab_size, shape),
                             torch.full(shape, -1, dtype=torch.int32,
                                        device=dev))
    return {
        "input_ids": input_ids,
        "token_type_ids": torch.zeros(shape, dtype=torch.int32, device=dev),
        "attention_mask": torch.ones(shape, dtype=torch.int32, device=dev),
        "masked_lm_labels": mlm_labels,
        "next_sentence_labels": ids(2, (batch_size,)),
    }


def synthetic_image_batch(generator, batch_size: int,
                          image_size: int = 224, num_classes: int = 1000,
                          dtype=torch.float32, *, device=None) -> dict:
    """A fake ImageNet batch ``{"image": [B, 3, H, W] standard normal in
    dtype, "label": [B] int64}``. ``generator``: a ``torch.Generator``
    (the batch lies on its device), or an int seed for a new generator on
    ``device`` (the card unless the caller says otherwise; no card
    raises)."""
    generator = _generator(generator, device)
    dev = generator.device
    images = torch.randn((batch_size, 3, image_size, image_size),
                         generator=generator, device=dev).to(dtype)
    labels = torch.randint(0, num_classes, (batch_size,),
                           generator=generator, device=dev)
    return {"image": images, "label": labels}


def synthetic_mnist_batch(generator, batch_size: int, *,
                          device=None) -> dict:
    """A fake MNIST batch ``{"image": [B, 1, 28, 28] standard normal fp32,
    "label": [B] int64 in [0, 10)}``; ``generator`` as
    `synthetic_image_batch`'s."""
    generator = _generator(generator, device)
    dev = generator.device
    images = torch.randn((batch_size, 1, 28, 28), generator=generator,
                         device=dev)
    labels = torch.randint(0, 10, (batch_size,), generator=generator,
                           device=dev)
    return {"image": images, "label": labels}


def load_real_digits(image_size: int = 28, train_fraction: float = 0.85,
                     seed: int = 0):
    """Real handwritten digits with no download: scikit-learn's bundled
    ``load_digits`` corpus (1797 8x8 grayscale digits of the UCI optical
    recognition set), as the JAX package loads it. Returns ``(train_x,
    train_y, test_x, test_y)`` as numpy arrays: images resized bilinearly
    (half-pixel centres, pure numpy) to ``[N, image_size, image_size, 1]``
    float32 — NHWC, the JAX package's bytes; the caller transposes —
    centred on the TRAIN split's mean, labels int32, split by a seeded
    permutation. Raises ``ImportError`` without scikit-learn."""
    import numpy as np

    try:
        from sklearn.datasets import load_digits
    except ImportError as exc:
        raise ImportError(
            "load_real_digits needs scikit-learn; or run the caller with "
            "synthetic data (dear_pytorch_tpu_torch.examples.mnist --data "
            "synthetic)") from exc

    X, y = load_digits(return_X_y=True)
    X = (X / 16.0).astype(np.float32).reshape(-1, 8, 8, 1)
    if image_size != 8:
        h = X.shape[1]
        centers = (np.arange(image_size) + 0.5) * h / image_size - 0.5
        i0 = np.clip(np.floor(centers).astype(np.int64), 0, h - 1)
        i1 = np.minimum(i0 + 1, h - 1)
        frac = np.clip(centers - i0, 0.0, 1.0).astype(np.float32)
        # rows then columns (separable)
        rows = (X[:, i0] * (1 - frac)[None, :, None, None]
                + X[:, i1] * frac[None, :, None, None])
        X = (rows[:, :, i0] * (1 - frac)[None, None, :, None]
             + rows[:, :, i1] * frac[None, None, :, None])
    perm = np.random.default_rng(seed).permutation(len(X))
    X, y = X[perm], y[perm].astype(np.int32)
    n_train = int(len(X) * train_fraction)
    # centred with the train split's mean only: no held-out leakage
    X = X - X[:n_train].mean()
    return (X[:n_train], y[:n_train], X[n_train:], y[n_train:])


class ShardedSampler:
    """torch ``DistributedSampler`` semantics, as the JAX package's: each
    process sees a disjoint 1/world shard of a seeded per-epoch
    permutation, padded by wrap-around so every shard has the same length
    (a short rank would stall the collectives). ``epoch_indices(epoch)``
    is this process's index array for that epoch, from the same
    permutation on every process for one (seed, epoch)."""

    def __init__(self, n: int, world: int, rank: int, *, seed: int = 0,
                 shuffle: bool = True):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} not in [0, {world})")
        self.n, self.world, self.rank = int(n), int(world), int(rank)
        self.seed, self.shuffle = int(seed), bool(shuffle)
        self.shard_len = -(-self.n // self.world)  # ceil

    def epoch_indices(self, epoch: int):
        import numpy as np

        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, int(epoch))).permutation(self.n)
        else:
            order = np.arange(self.n)
        total = self.shard_len * self.world
        if total > self.n:  # wrap-around padding, as torch's sampler
            order = np.concatenate([order, order[: total - self.n]])
        return order[self.rank::self.world]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy in fp32 (the CNN benchmarks' criterion)."""
    return F.cross_entropy(logits.float(), labels)
