"""C4-proxy pre-training corpus: generic LM sequences spanning all topics.

Used (a) to select MEERKAT's sensitivity mask (avg squared gradient of the
LM loss) and (b) as the server-held pre-training gradient in GradIP."""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import TaskSpec, _class_vocab


def pretrain_batches(spec: TaskSpec, n_batches: int, batch_size: int,
                     seed: int = 100):
    """LM batches mixing all class topics + common tokens ({'tokens': [b,S]})."""
    rng = np.random.default_rng(seed)
    cv = _class_vocab(spec)
    out = []
    for _ in range(n_batches):
        toks = np.empty((batch_size, spec.seq_len), np.int32)
        for i in range(batch_size):
            c = rng.integers(spec.n_classes)
            topic = rng.choice(cv[c], size=spec.seq_len)
            common = rng.integers(0, spec.vocab, size=spec.seq_len)
            use_common = rng.random(spec.seq_len) < 0.5
            toks[i] = np.where(use_common, common, topic)
        out.append({"tokens": toks})
    return out
