"""CIFAR dataset sources: on-disk loaders + deterministic synthetic fallback.

The reference downloads CIFAR10 through torchvision (reference
src/no_consensus_trio.py:52-57). This environment has no network egress and
no torchvision, so the equivalent capability is provided two ways:

* `load_cifar10` / `load_cifar100` read the standard published archive
  layouts (python-pickle batches or the binary ``*.bin`` format) from a
  local directory, producing identical uint8 HWC arrays to torchvision's
  in-memory representation.
* `synthetic_cifar` generates a deterministic, *learnable*
  class-conditional dataset with the same shapes/dtypes, used by tests and
  benchmarks when no real archive is present.

A copy of the JAX package's `data/cifar.py` (it imports no JAX, but
importing it from there would load that package and JAX with it). The
archive decoding uses numpy where the original can call a native helper;
the bytes are identical. `synthetic_cifar` is unchanged, so both packages
draw the same dataset from a seed.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tarfile
import warnings
from typing import Tuple

import numpy as np


class ArchiveNotFound(FileNotFoundError):
    """No dataset archive present at the given root (distinct from a
    present-but-corrupt archive, which must not silently fall back)."""


@dataclasses.dataclass(frozen=True)
class DataSource:
    """An image-classification dataset in canonical uint8 NHWC layout."""

    train_images: np.ndarray  # [N, 32, 32, 3] uint8
    train_labels: np.ndarray  # [N] int32
    test_images: np.ndarray  # [M, 32, 32, 3] uint8
    test_labels: np.ndarray  # [M] int32
    num_classes: int
    name: str = "cifar10"

    def __post_init__(self):
        assert self.train_images.dtype == np.uint8
        assert self.train_images.shape[1:] == (32, 32, 3)


def _planes_to_hwc(flat: np.ndarray) -> np.ndarray:
    """CIFAR stores 3072 bytes as R/G/B planes; convert to HWC uint8."""
    flat = np.ascontiguousarray(flat, np.uint8)
    if flat.size % 3072 != 0:
        raise ValueError(f"image buffer of {flat.size} bytes is not a multiple of 3072")
    return flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).copy()


def _decode_records(raw: np.ndarray, label_bytes: int) -> Tuple[np.ndarray, np.ndarray]:
    """[n, label_bytes + 3072] raw .bin records -> (HWC images, int32 fine
    labels). Fine label = last label byte (cifar-100 records are
    [coarse, fine])."""
    labels = raw[:, label_bytes - 1].astype(np.int32)
    return _planes_to_hwc(raw[:, label_bytes:]), labels


def _load_pickle_batches(root: str, files, label_key: bytes):
    images, labels = [], []
    for fn in files:
        with open(os.path.join(root, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        images.append(_planes_to_hwc(np.asarray(d[b"data"], np.uint8)))
        labels.append(np.asarray(d[label_key], np.int32))
    return np.concatenate(images), np.concatenate(labels)


def _load_bin_records(root: str, files, label_bytes: int):
    """The binary archive layout: each record is `label_bytes` label bytes
    followed by 3072 image bytes (fine label is the last label byte)."""
    images, labels = [], []
    rec = label_bytes + 3072
    for fn in files:
        raw = np.fromfile(os.path.join(root, fn), np.uint8).reshape(-1, rec)
        img, lbl = _decode_records(raw, label_bytes)
        images.append(img)
        labels.append(lbl)
    return np.concatenate(images), np.concatenate(labels)


def load_cifar10(root: str) -> DataSource:
    """Load CIFAR-10 from `root`: either the python-pickle layout
    (``cifar-10-batches-py``, tarball ``cifar-10-python.tar.gz``) or the
    binary layout (``cifar-10-batches-bin``); `root` may be the directory
    containing the archive dir or the archive dir itself."""
    try:
        d = _resolve(root, "cifar-10-batches-py", "cifar-10-python.tar.gz")
        tr_i, tr_l = _load_pickle_batches(
            d, [f"data_batch_{i}" for i in range(1, 6)], b"labels"
        )
        te_i, te_l = _load_pickle_batches(d, ["test_batch"], b"labels")
    except ArchiveNotFound:
        d = _resolve(root, "cifar-10-batches-bin", "cifar-10-binary.tar.gz")
        tr_i, tr_l = _load_bin_records(
            d, [f"data_batch_{i}.bin" for i in range(1, 6)], 1
        )
        te_i, te_l = _load_bin_records(d, ["test_batch.bin"], 1)
    return DataSource(tr_i, tr_l, te_i, te_l, 10, "cifar10")


def load_cifar100(root: str) -> DataSource:
    try:
        d = _resolve(root, "cifar-100-python", "cifar-100-python.tar.gz")
        tr_i, tr_l = _load_pickle_batches(d, ["train"], b"fine_labels")
        te_i, te_l = _load_pickle_batches(d, ["test"], b"fine_labels")
    except ArchiveNotFound:
        d = _resolve(root, "cifar-100-binary", "cifar-100-binary.tar.gz")
        tr_i, tr_l = _load_bin_records(d, ["train.bin"], 2)  # coarse+fine
        te_i, te_l = _load_bin_records(d, ["test.bin"], 2)
    return DataSource(tr_i, tr_l, te_i, te_l, 100, "cifar100")


def _resolve(root: str, subdir: str, tarball: str) -> str:
    if os.path.basename(os.path.normpath(root)) == subdir:
        if not os.path.isdir(root):
            raise ArchiveNotFound(f"{root} does not exist")
        return root
    cand = os.path.join(root, subdir)
    if os.path.isdir(cand):
        return cand
    tb = os.path.join(root, tarball)
    if os.path.isfile(tb):
        with tarfile.open(tb) as t:
            t.extractall(root, filter="data")
        return cand
    raise ArchiveNotFound(f"no {subdir} under {root}")


def synthetic_cifar(
    n_train: int = 50_000,
    n_test: int = 10_000,
    num_classes: int = 10,
    seed: int = 0,
    noise: float = 35.0,
    overlap: float = 0.0,
    label_noise: float = 0.0,
) -> DataSource:
    """Deterministic learnable stand-in with CIFAR shapes.

    Each class c gets a fixed low-frequency prototype image; samples are
    `clip(prototype + noise)`. A small CNN separates the classes well above
    chance within one epoch, so convergence smoke tests (SURVEY.md §4d)
    remain meaningful without the real archive.

    The default set is nearly separable — every healthy configuration
    reaches ~1.0, which cannot DISCRIMINATE a correct implementation from
    a subtly wrong one. For a discriminating convergence oracle
    (benchmarks/convergence_parity.py) use:

    * `overlap` in [0, 1): blends each class prototype with its
      neighbour's, shrinking class margins;
    * `label_noise` in [0, 1): flips that fraction of labels (train AND
      test) to a uniformly random other class, capping achievable test
      accuracy at ~(1 - p) + p/C — e.g. 0.25 caps it at ~0.78, so the
      accuracy curve plateaus below ceiling and has discriminating shape.

    Both are deterministic in `seed`.
    """
    rng = np.random.default_rng(seed)
    # low-frequency prototypes: upsampled 4x4 color patterns
    proto_small = rng.uniform(60, 195, size=(num_classes, 4, 4, 3))
    proto = proto_small.repeat(8, axis=1).repeat(8, axis=2)  # [C,32,32,3]
    if overlap:
        proto = (1.0 - overlap) * proto + overlap * np.roll(proto, 1, axis=0)

    def draw(n: int, r: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        labels = r.integers(0, num_classes, size=n).astype(np.int32)
        eps = r.normal(0.0, noise, size=(n, 32, 32, 3))
        images = np.clip(proto[labels] + eps, 0, 255).astype(np.uint8)
        if label_noise:
            flip = r.random(n) < label_noise
            shift = r.integers(1, num_classes, size=n).astype(np.int32)
            labels = np.where(
                flip, (labels + shift) % num_classes, labels
            ).astype(np.int32)
        return images, labels

    tr_i, tr_l = draw(n_train, rng)
    te_i, te_l = draw(n_test, rng)
    return DataSource(tr_i, tr_l, te_i, te_l, num_classes, "synthetic")


def load_cifar(
    name: str = "cifar10",
    root: str | None = None,
    synthetic_ok: bool = True,
    synthetic_n_train: int | None = None,
    synthetic_n_test: int | None = None,
) -> DataSource:
    """Load `name` from `root` (or $CIFAR_DATA_DIR), falling back to the
    synthetic source only when NO archive is present at all. A present but
    corrupt/partial archive raises — it must not silently train on
    synthetic data. The `synthetic_*` sizes apply only to the fallback
    (smoke tests / CI shrink it; a real archive is never truncated)."""
    root = root or os.environ.get("CIFAR_DATA_DIR", "./torchdata")
    loader = {"cifar10": load_cifar10, "cifar100": load_cifar100}[name]
    try:
        return loader(root)
    except ArchiveNotFound:
        if not synthetic_ok:
            raise
        warnings.warn(
            f"no {name} archive under {root}; using the deterministic "
            "synthetic stand-in dataset",
            stacklevel=2,
        )
        sizes = {
            k: v
            for k, v in (
                ("n_train", synthetic_n_train),
                ("n_test", synthetic_n_test),
            )
            if v is not None  # else synthetic_cifar's own defaults apply
        }
        return synthetic_cifar(
            num_classes=10 if name == "cifar10" else 100, **sizes
        )
