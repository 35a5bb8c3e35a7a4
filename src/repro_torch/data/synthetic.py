"""Synthetic surrogates for the paper's datasets (offline data gate).

The real Adult (UCI) and Vehicle (Duarte & Hu) datasets are not available in
this container. We generate statistically matched surrogates:

  - ``adult_like``: 32,561 samples, 14 mixed categorical/numerical attributes
    one-hot encoded (we keep d=104 features, matching a standard Adult
    encoding), binary income label, plus a 16-level ``education`` categorical
    used for the paper's non-iid split. Education level shifts both the
    feature distribution and the label rate, so splitting by education yields
    genuinely non-iid clients (as in Adult-1).
  - ``vehicle_like``: 23 sensors x ~1,899 samples, 100 acoustic/seismic
    features, binary AAV/DW label. Each sensor has its own feature covariance
    rotation + bias (sensor placement), giving the Vehicle-1 non-iid-ness.

Features are normalized to the unit ball (paper §4 assumption).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ADULT_EDU_LEVELS = [
    "Bachelors", "Some-college", "11th", "HS-grad", "Prof-school",
    "Assoc-acdm", "Assoc-voc", "9th", "7th-8th", "12th", "Masters",
    "1st-4th", "10th", "Doctorate", "5th-6th", "Preschool",
]
# Rough relative frequencies of education levels in Adult (sums to 1).
_EDU_FREQ = np.array([0.165, 0.224, 0.036, 0.322, 0.018, 0.033, 0.042, 0.016,
                      0.020, 0.013, 0.053, 0.005, 0.029, 0.013, 0.010, 0.002])
_EDU_FREQ = _EDU_FREQ / _EDU_FREQ.sum()
# Education strongly predicts income: P(>50k | edu) ranges ~1% .. ~74%.
_EDU_POS_RATE = np.array([0.41, 0.19, 0.05, 0.16, 0.74, 0.25, 0.26, 0.05,
                          0.06, 0.07, 0.56, 0.04, 0.07, 0.73, 0.05, 0.01])


@dataclass
class Dataset:
    x: np.ndarray          # (N, d) float32, rows in unit ball
    y: np.ndarray          # (N,) int32 in {0, 1}
    group: np.ndarray      # (N,) int32 grouping attribute (education / sensor)
    name: str

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]


def _unit_ball(x: np.ndarray) -> np.ndarray:
    """Normalize every row into the unit ball (paper §4)."""
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.maximum(norms, 1.0)).astype(np.float32)


def adult_like(n: int = 32_561, dim: int = 104, seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    edu = rng.choice(16, size=n, p=_EDU_FREQ).astype(np.int32)
    # class-conditional, education-conditional Gaussian features
    base_dir = rng.normal(size=(16, dim)) / np.sqrt(dim)       # edu shift
    label_dir = rng.normal(size=dim) / np.sqrt(dim)            # income signal
    y = (rng.random(n) < _EDU_POS_RATE[edu]).astype(np.int32)
    x = rng.normal(scale=0.8, size=(n, dim))
    x += base_dir[edu] * 2.0
    x += np.outer(2.0 * y - 1.0, label_dir) * 0.9
    # sparse one-hot-ish block to mimic categorical encodings
    cat = rng.integers(0, dim // 4, size=n)
    x[np.arange(n), cat] += 1.5
    # ~9% Bayes-irreducible label noise (Adult itself is not separable)
    flip = rng.random(n) < 0.09
    y = np.where(flip, 1 - y, y).astype(np.int32)
    return Dataset(x=_unit_ball(x), y=y, group=edu, name="adult_like")


def vehicle_like(n_sensors: int = 23, per_sensor: int = 1_899, dim: int = 100,
                 seed: int = 1) -> Dataset:
    rng = np.random.default_rng(seed)
    n = n_sensors * per_sensor
    sensor = np.repeat(np.arange(n_sensors, dtype=np.int32), per_sensor)
    y = rng.integers(0, 2, size=n).astype(np.int32)
    label_dir = rng.normal(size=dim) / np.sqrt(dim)
    # per-sensor rotation (placement / terrain) + bias
    x = rng.normal(scale=0.5, size=(n, dim))
    for s in range(n_sensors):
        m = sensor == s
        q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
        x[m] = x[m] @ (0.7 * np.eye(dim) + 0.3 * q)
        x[m] += rng.normal(scale=0.4, size=dim)
    x += np.outer(2.0 * y - 1.0, label_dir) * 1.1
    flip = rng.random(n) < 0.07
    y = np.where(flip, 1 - y, y).astype(np.int32)
    return Dataset(x=_unit_ball(x), y=y, group=sensor, name="vehicle_like")
