"""Client data partitioning: IID, Dirichlet(alpha) Non-IID, single-label."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def iid_partition(n: int, n_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """Class-wise Dirichlet split (the paper's Non-IID protocol)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    while True:
        buckets: List[List[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for b, part in zip(buckets, np.split(idx, cuts)):
                b.extend(part.tolist())
        if min(len(b) for b in buckets) >= min_size:
            break
    return [np.sort(np.asarray(b)) for b in buckets]


def single_label_partition(labels: np.ndarray, n_clients: int,
                           seed: int = 0) -> List[np.ndarray]:
    """Extreme Non-IID: each client holds exactly one class (round-robin)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    out = []
    for k in range(n_clients):
        c = k % n_classes
        idx = np.where(labels == c)[0]
        sub = rng.choice(idx, size=max(2, len(idx) // max(
            1, n_clients // n_classes)), replace=False)
        out.append(np.sort(sub))
    return out


def subset(data: Dict[str, np.ndarray], idx: np.ndarray):
    return {k: v[idx] for k, v in data.items()}


def label_histogram(labels: np.ndarray, parts: List[np.ndarray],
                    n_classes: int) -> np.ndarray:
    return np.stack([np.bincount(labels[p], minlength=n_classes)
                     for p in parts])
