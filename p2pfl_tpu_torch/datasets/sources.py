"""Dataset sources: real files when available, synthetic surrogates otherwise.

Dataset families mirror the reference (SURVEY.md §2.4):

| name     | shape          | classes | reference                          |
|----------|----------------|---------|------------------------------------|
| mnist    | 28×28×1        | 10      | mnist/mnist.py                     |
| femnist  | 28×28×1        | 62      | femnist/femnist.py (LEAF)          |
| cifar10  | 32×32×3        | 10      | cifar10/cifar10.py                 |
| syscall  | 17 features    | 9       | syscall/syscall.py                 |
| wadi     | 123 features   | 2       | wadi/wadi.py                       |

Real data: ``$P2PFL_TPU_DATA_DIR/<name>.npz`` with arrays
``x_train, y_train, x_test, y_test`` (images HWC float or uint8), or
for MNIST the standard idx-ubyte files. The reference downloads at
first use (femnist.py:24-77, syscall.py:60-113); this environment has
no egress, so absent files fall back to a **deterministic learnable
surrogate**: each class is a smooth random prototype field plus
per-sample elastic noise — linearly separable enough that real models
show real learning curves, hard enough that accuracy is not trivially
100%.

A copy of ``p2pfl_tpu/datasets/sources.py``, which imports only numpy:
the port keeps its own so that it never imports the JAX package, and
the same seed gives the same surrogate in both packages.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import pathlib
import struct
import zlib

import numpy as np

_SPECS: dict[str, tuple[tuple[int, ...], int]] = {
    "mnist": ((28, 28, 1), 10),
    "femnist": ((28, 28, 1), 62),
    "cifar10": ((32, 32, 3), 10),
    "syscall": ((17,), 9),
    "wadi": ((123,), 2),
}

DATASETS = tuple(sorted(_SPECS))


@dataclasses.dataclass
class DatasetSplits:
    """Host-side numpy train/test splits, normalized, channels-last.

    ``writer_train`` (optional): per-sample writer/source id — LEAF
    FEMNIST's natural grouping (femnist.py partitions by writer). The
    hard surrogate emits it; real npz files may include a
    ``writer_train`` array. Enables ``partition="writer"``.
    """

    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int
    synthetic: bool = False
    writer_train: np.ndarray | None = None

    @property
    def input_shape(self) -> tuple[int, ...]:
        return tuple(self.x_train.shape[1:])


def _data_dir() -> pathlib.Path | None:
    d = os.environ.get("P2PFL_TPU_DATA_DIR")
    return pathlib.Path(d) if d else None


def _read_idx(path: pathlib.Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _try_load_real(name: str) -> DatasetSplits | None:
    d = _data_dir()
    if d is None:
        return None
    npz = d / f"{name}.npz"
    if npz.exists():
        z = np.load(npz)
        out = _normalize(
            name, z["x_train"], z["y_train"], z["x_test"], z["y_test"]
        )
        if "writer_train" in z:  # enables partition="writer" (LEAF)
            out.writer_train = (
                np.asarray(z["writer_train"]).astype(np.int32).reshape(-1)
            )
        return out
    if name == "mnist":  # standard idx-ubyte layout
        files = {}
        for key, stems in {
            "x_train": ["train-images-idx3-ubyte"],
            "y_train": ["train-labels-idx1-ubyte"],
            "x_test": ["t10k-images-idx3-ubyte"],
            "y_test": ["t10k-labels-idx1-ubyte"],
        }.items():
            found = None
            for stem in stems:
                for cand in (d / "mnist" / stem, d / "mnist" / f"{stem}.gz",
                             d / stem, d / f"{stem}.gz"):
                    if cand.exists():
                        found = cand
                        break
                if found:
                    break
            if not found:
                return None
            files[key] = _read_idx(found)
        return _normalize(name, files["x_train"], files["y_train"],
                          files["x_test"], files["y_test"])
    return None


def _normalize(name, x_train, y_train, x_test, y_test) -> DatasetSplits:
    shape, num_classes = _SPECS[name]

    def prep(x):
        x = np.asarray(x)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        x = x.astype(np.float32)
        if len(shape) == 3 and x.ndim == 3:  # HW → HWC
            x = x[..., None]
        return x.reshape((x.shape[0],) + shape)

    return DatasetSplits(
        name=name,
        x_train=prep(x_train),
        y_train=np.asarray(y_train).astype(np.int32).reshape(-1),
        x_test=prep(x_test),
        y_test=np.asarray(y_test).astype(np.int32).reshape(-1),
        num_classes=num_classes,
    )


def _smooth_protos(rng, num_classes: int, shape, dim: int) -> np.ndarray:
    protos = rng.normal(0.0, 1.0, size=(num_classes, dim)).astype(np.float32)
    if len(shape) == 3:  # smooth image prototypes: blur flat noise a little
        img = protos.reshape((num_classes,) + shape)
        for ax in (1, 2):
            img = (
                0.5 * img
                + 0.25 * np.roll(img, 1, axis=ax)
                + 0.25 * np.roll(img, -1, axis=ax)
            )
        protos = img.reshape(num_classes, dim)
    return protos


def _synthetic_easy(name: str, n_train: int, n_test: int,
                    seed: int) -> DatasetSplits:
    """Rounds 1-4 surrogate: y → smooth prototype P_y; x = P_y rolled
    by a per-sample shift + gaussian noise. Learnable by linear models
    yet non-trivial (shift invariance must be learned). Kept verbatim
    for metric continuity — it saturates ~0.99, so round 5 made the
    HARD profile the default (VERDICT r4 #5)."""
    shape, num_classes = _SPECS[name]
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2**16))
    dim = int(np.prod(shape))
    protos = _smooth_protos(rng, num_classes, shape, dim)

    def draw(n, rng):
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        shift = rng.integers(0, 4, size=n)
        base = protos[y]
        rows = np.arange(dim)
        x = np.empty((n, dim), np.float32)
        for s in range(4):
            m = shift == s
            if m.any():
                x[m] = base[m][:, (rows - s) % dim]
        x += rng.normal(0.0, 0.8, size=x.shape).astype(np.float32)
        return x.reshape((n,) + shape), y

    x_train, y_train = draw(n_train, rng)
    x_test, y_test = draw(n_test, rng)
    return DatasetSplits(
        name=name, x_train=x_train, y_train=y_train, x_test=x_test,
        y_test=y_test, num_classes=num_classes, synthetic=True,
    )


#: hard-surrogate difficulty knobs (calibrated on the bench chip so the
#: 64-node north-star federation plateaus ~0.85-0.92 — VERDICT r4 #5;
#: calibration sweep: scripts/exp_surrogate_calibration.py)
_HARD = {
    "n_writers": 240,       # 80% train / 20% held out for the test set
    "style_gamma": 0.7,     # writer-specific class-rendering strength
    "skew_alpha": 0.3,      # per-writer Dirichlet class skew (LEAF-like)
    "label_noise": 0.04,    # train-label flip rate (test labels clean)
    "sample_noise": 0.8,    # per-sample gaussian sigma
}
# calibration (bench chip, 64-node north star, 30-round trajectory —
# scripts/exp_surrogate_calibration.py): gamma 0.4 -> plateau 0.948,
# 0.55 -> 0.937, 0.7 -> 0.917 with rounds-to-80 = 13. gamma 0.7 puts
# the plateau in the 0.85-0.92 target band: 80% is now a threshold the
# federation fights for, not a point on a saturating curve.


def _synthetic_hard(name: str, n_train: int, n_test: int,
                    seed: int) -> DatasetSplits:
    """LEAF-calibrated surrogate (VERDICT r4 #5): the easy profile's
    prototypes, plus the structure that makes real federated FEMNIST
    hard —

    - **writers**: each sample belongs to a writer; a writer renders
      class y as ``P_y + γ·D_{w,y}`` (a writer-specific smooth
      deformation of the class prototype) with a writer intensity
      scale/bias. The TEST set is drawn from held-out writers, so the
      ~0.85-0.92 plateau is a real style-generalization gap, not an
      additive-noise floor.
    - **per-writer class skew**: writer class distributions are
      Dirichlet(α) draws (LEAF femnist: writers favor characters);
      with ``partition="writer"`` nodes inherit that skew.
    - **label noise**: a small fraction of TRAIN labels flipped
      (test labels stay clean — the metric measures generalization).

    Emits ``writer_train`` ids for writer-partitioning.
    """
    shape, num_classes = _SPECS[name]
    cfg = _HARD
    rng = np.random.default_rng(
        seed + zlib.crc32((name + "/hard").encode()) % (2**16))
    dim = int(np.prod(shape))
    protos = _smooth_protos(rng, num_classes, shape, dim)

    n_writers = cfg["n_writers"]
    n_w_test = max(n_writers // 5, 1)
    # writer-specific class renderings: smooth like the prototypes so
    # the style lives in the same frequency band the classifier uses
    deltas = rng.normal(0.0, 1.0, size=(n_writers, num_classes, dim)
                        ).astype(np.float32)
    if len(shape) == 3:
        img = deltas.reshape((n_writers * num_classes,) + shape)
        for ax in (1, 2):
            img = (0.5 * img + 0.25 * np.roll(img, 1, axis=ax)
                   + 0.25 * np.roll(img, -1, axis=ax))
        deltas = img.reshape(n_writers, num_classes, dim)
    w_scale = rng.normal(1.0, 0.15, size=n_writers).astype(np.float32)
    w_bias = rng.normal(0.0, 0.2, size=n_writers).astype(np.float32)
    w_probs = rng.dirichlet([cfg["skew_alpha"]] * num_classes,
                            size=n_writers).astype(np.float32)

    def draw(n, writer_pool, rng, label_noise):
        w = writer_pool[rng.integers(0, len(writer_pool), size=n)]
        # per-writer skewed class draw (vectorized inverse-CDF)
        cdf = np.cumsum(w_probs[w], axis=1)
        y = (rng.random((n, 1)) < cdf).argmax(axis=1).astype(np.int32)
        base = protos[y] + cfg["style_gamma"] * deltas[w, y]
        x = w_scale[w, None] * base + w_bias[w, None]
        shift = rng.integers(0, 4, size=n)
        rows = np.arange(dim)
        out = np.empty((n, dim), np.float32)
        for s in range(4):
            m = shift == s
            if m.any():
                out[m] = x[m][:, (rows - s) % dim]
        out += rng.normal(0.0, cfg["sample_noise"],
                          size=out.shape).astype(np.float32)
        if label_noise:
            flip = rng.random(n) < label_noise
            y = np.where(
                flip, rng.integers(0, num_classes, size=n), y
            ).astype(np.int32)
        return out.reshape((n,) + shape), y, w.astype(np.int32)

    train_pool = np.arange(n_writers - n_w_test)
    test_pool = np.arange(n_writers - n_w_test, n_writers)
    x_train, y_train, w_train = draw(n_train, train_pool, rng,
                                     cfg["label_noise"])
    x_test, y_test, _ = draw(n_test, test_pool, rng, 0.0)
    return DatasetSplits(
        name=name, x_train=x_train, y_train=y_train, x_test=x_test,
        y_test=y_test, num_classes=num_classes, synthetic=True,
        writer_train=w_train,
    )


def _synthetic(name: str, n_train: int, n_test: int, seed: int,
               profile: str = "hard") -> DatasetSplits:
    if profile == "easy":
        return _synthetic_easy(name, n_train, n_test, seed)
    if profile == "hard":
        return _synthetic_hard(name, n_train, n_test, seed)
    raise ValueError(f"unknown surrogate profile {profile!r}")


_SYNTH_SIZES = {  # match real dataset scale where it matters, smaller for speed
    "mnist": (20000, 4000),
    "femnist": (24000, 4000),
    "cifar10": (20000, 4000),
    "syscall": (10000, 2000),
    "wadi": (10000, 2000),
}


def get_dataset(name: str, seed: int = 0,
                synthetic_sizes: tuple[int, int] | None = None,
                profile: str = "hard") -> DatasetSplits:
    """Load a dataset by name — real if files exist, surrogate otherwise."""
    key = name.lower()
    if key not in _SPECS:
        raise ValueError(f"unknown dataset {name!r}; have {DATASETS}")
    real = _try_load_real(key)
    if real is not None:
        return real
    n_train, n_test = synthetic_sizes or _SYNTH_SIZES[key]
    return _synthetic(key, n_train, n_test, seed, profile=profile)
