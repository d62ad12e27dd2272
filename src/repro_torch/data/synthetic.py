"""Synthetic classification-LM task family.

The paper fine-tunes LLMs on GLUE/SuperGLUE classification tasks; offline we
reproduce the *distributional* structure that drives its claims: each class
has a distinct token distribution ("topic"), sequences end with a SEP token,
and the model must emit the class's verbalizer token after SEP.  Class
composition per client is what IID / Dirichlet / single-label partitioning
controls — exactly the heterogeneity axis the paper studies.

The numpy sampler is a copy of ``repro.data.synthetic``'s; the task
functions are written in torch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


@dataclass(frozen=True)
class TaskSpec:
    name: str = "synth"
    vocab: int = 512
    n_classes: int = 4
    seq_len: int = 16
    topic_tokens: int = 24   # class-specific vocabulary size
    noise: float = 0.25      # probability of a common (non-topic) token
    seed: int = 0

    @property
    def sep_token(self) -> int:
        return self.vocab - 1


def _class_vocab(spec: TaskSpec):
    """Disjoint topic-token sets per class (excluding verbalizers and SEP)."""
    rng = np.random.default_rng(spec.seed)
    lo, hi = spec.n_classes, spec.vocab - 1
    pool = rng.permutation(np.arange(lo, hi))
    need = spec.n_classes * spec.topic_tokens
    assert need <= len(pool), "vocab too small for topic sets"
    return pool[:need].reshape(spec.n_classes, spec.topic_tokens)


def sample_dataset(spec: TaskSpec, n: int, seed: int = 0,
                   class_probs=None) -> Dict[str, np.ndarray]:
    """Draw n examples. Returns {'tokens': [n, S], 'label': [n]}."""
    rng = np.random.default_rng(seed)
    cv = _class_vocab(spec)
    p = (np.full(spec.n_classes, 1.0 / spec.n_classes)
         if class_probs is None else np.asarray(class_probs, np.float64))
    p = p / p.sum()
    labels = rng.choice(spec.n_classes, size=n, p=p)
    S = spec.seq_len
    toks = np.empty((n, S), np.int32)
    body = S - 1
    for i, c in enumerate(labels):
        topic = rng.choice(cv[c], size=body)
        common = rng.integers(spec.n_classes, spec.vocab - 1, size=body)
        use_common = rng.random(body) < spec.noise
        toks[i, :body] = np.where(use_common, common, topic)
        toks[i, body] = spec.sep_token
    return {"tokens": toks, "label": labels.astype(np.int32)}


def make_task_fns(model, spec: TaskSpec):
    """(loss_fn, per_example_loss_fn, eval_fn) closing over the model.

    Classification via the verbalizer-token logits at the SEP position.
    Batches are dicts of numpy arrays or tensors; they are moved to the
    model's device here."""
    C = spec.n_classes

    def _logits(params, batch):
        tokens = torch.as_tensor(batch["tokens"], device=model.device)
        logits, aux = model.forward(params, {"tokens": tokens})
        return logits[:, -1, :C], aux

    def _labels(batch):
        return torch.as_tensor(batch["label"], device=model.device).long()

    def per_example(params, batch):
        lg, aux = _logits(params, batch)
        lp = torch.log_softmax(lg, dim=-1)
        nll = -torch.gather(lp, 1, _labels(batch)[:, None])[:, 0]
        return nll + 0.01 * aux

    def loss(params, batch):
        return per_example(params, batch).mean()

    @torch.no_grad()
    def evaluate(params, batch):
        lg, _ = _logits(params, batch)
        label = _labels(batch)
        acc = (torch.argmax(lg, -1) == label).float().mean()
        lp = torch.log_softmax(lg, dim=-1)
        nll = -torch.gather(lp, 1, label[:, None]).mean()
        return {"loss": nll, "acc": acc}

    return loss, per_example, evaluate
