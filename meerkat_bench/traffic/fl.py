"""Training traffic of a federated cell, from its workload file and the
run's seed: the synthetic classification task (each class a topic
vocabulary, sequences ending in SEP, the verbalizer token the label), its
Dirichlet(alpha) split over the clients, and the pre-training batches
that pick the mask and give the pre-training gradient.

The samplers are copies of the program's ``data/synthetic.py``,
``data/partition.py`` and ``data/corpus.py`` (numpy), kept here so that
the traffic cannot move with the program.  The class vocabularies come
from the workload's fixed ``class_vocab_seed``; the run's seed draws the
examples, the split and the pre-training batches, so every seed gives
the same sizes of work.
"""
from __future__ import annotations

import numpy as np


def class_vocab(task: dict) -> np.ndarray:
    """Disjoint topic-token sets per class [C, topic_tokens]."""
    rng = np.random.default_rng(task["class_vocab_seed"])
    C, V = task["n_classes"], task["vocab"]
    pool = rng.permutation(np.arange(C, V - 1))
    return pool[:C * task["topic_tokens"]].reshape(C, task["topic_tokens"])


def sample(task: dict, n: int, seed: int) -> dict:
    """n examples {'tokens' [n, S] int32, 'label' [n] int32}."""
    rng = np.random.default_rng(seed)
    cv = class_vocab(task)
    C, V, S = task["n_classes"], task["vocab"], task["seq_len"]
    labels = rng.choice(C, size=n, p=np.full(C, 1.0 / C))
    toks = np.empty((n, S), np.int32)
    body = S - 1
    for i, c in enumerate(labels):
        topic = rng.choice(cv[c], size=body)
        common = rng.integers(C, V - 1, size=body)
        use_common = rng.random(body) < task["noise"]
        toks[i, :body] = np.where(use_common, common, topic)
        toks[i, body] = V - 1                                  # SEP
    return {"tokens": toks, "label": labels.astype(np.int32)}


def dirichlet(labels: np.ndarray, n_clients: int, alpha: float, seed: int,
              min_size: int = 2) -> list:
    """Class-wise Dirichlet(alpha) split: sorted example indices a client."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    while True:
        buckets = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for b, part in zip(buckets, np.split(idx, cuts)):
                b.extend(part.tolist())
        if min(len(b) for b in buckets) >= min_size:
            return [np.sort(np.asarray(b)) for b in buckets]


def pretrain(task: dict, n_batches: int, batch_size: int, seed: int) -> list:
    """LM batches mixing every topic with common tokens."""
    rng = np.random.default_rng(seed)
    cv = class_vocab(task)
    S = task["seq_len"]
    out = []
    for _ in range(n_batches):
        toks = np.empty((batch_size, S), np.int32)
        for i in range(batch_size):
            c = rng.integers(task["n_classes"])
            topic = rng.choice(cv[c], size=S)
            common = rng.integers(0, task["vocab"], size=S)
            toks[i] = np.where(rng.random(S) < 0.5, common, topic)
        out.append({"tokens": toks})
    return out


def make(wl: dict, seed: int) -> dict:
    """The cell's traffic: ``parts`` (one data dict a client) and
    ``pretrain`` (the mask's and the pre-training gradient's batches)."""
    ss = np.random.SeedSequence(int(seed)).spawn(3)
    s = [int(x.generate_state(1)[0]) for x in ss]
    task = wl["task"]
    data = sample(task, wl["train_examples"], s[0])
    parts = dirichlet(data["label"], wl["clients"], wl["dirichlet_alpha"],
                      s[1])
    pre = wl["pretrain"]
    return {"parts": [{k: v[p] for k, v in data.items()} for p in parts],
            "pretrain": pretrain(task, pre["batches"], pre["batch_size"],
                                 s[2])}
