"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program on the CPU (the look
for a card skipped, the rest of the run as the benchmark drives it).

Training: a step that returns its state unchanged, half of each batch left
out (the mean over the rest), an uploaded answer altered.  Serving: a
served token altered where it is produced, a decode step that leaves its
cache unchanged.  One chip, so no exchange between chips to leave out."""
import pytest
import torch

from meerkat_bench.tests import tiny


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path)


def _fl_unchanged_state(mp):
    from repro_torch.core.spaces import MaskedSpace
    mp.setattr(MaskedSpace, "add", lambda self, params, vec: params)


def _fl_half_batch(mp):
    import repro_torch.data as data
    real = data.make_task_fns

    def half(model, spec):
        loss, per_ex, ev = real(model, spec)

        def loss_half(p, b):
            n = len(b["label"]) // 2
            return loss(p, {k: v[:n] for k, v in b.items()})
        return loss_half, per_ex, ev
    mp.setattr(data, "make_task_fns", half)


def _fl_altered_answer(mp):
    from repro_torch.core.quantize import IdentityCodec, IntCodec

    def altered(real):
        def decode(self, wire):
            g = real(self, wire).copy()
            g.reshape(-1)[0] *= 1.5
            return g
        return decode
    mp.setattr(IdentityCodec, "decode", altered(IdentityCodec.decode))
    mp.setattr(IntCodec, "decode", altered(IntCodec.decode))


def _serve_altered_token(mp):
    """Every fourth decode step's tokens altered where they are picked (in
    every row: the check samples requests, not slots)."""
    import repro_torch.serving.engine as E
    real = E._pick
    n = [0]

    def pick(logits, key, temperature):
        tok = real(logits, key, temperature)
        n[0] += 1
        return (tok + 1) % logits.shape[-1] if n[0] % 4 == 0 else tok
    mp.setattr(E, "_pick", pick)


def _serve_unchanged_state(mp):
    """Each decode step returns the engine's state (cache, positions,
    logits) as it found it: every step of a burst picks from the same
    logits."""
    import repro_torch.serving.engine as E

    def decode_fn(self, n_steps, tailed):
        def body(remaining=None, key=None):
            tok = E._pick(self.last_logits, None, 0.0)
            return torch.stack([tok] * n_steps)
        return self._entry(("decode", n_steps, tailed), body)
    mp.setattr(E.ContinuousBatchingEngine, "_decode_fn", decode_fn)


FAULTS = {
    ("tiny-dense.fl", "unchanged_state"): _fl_unchanged_state,
    ("tiny-dense.fl", "half_batch"): _fl_half_batch,
    ("tiny-dense.fl", "altered_answer"): _fl_altered_answer,
    ("tiny-dense.fleet", "unchanged_state"): _fl_unchanged_state,
    ("tiny-dense.fleet", "half_batch"): _fl_half_batch,
    ("tiny-dense.fleet", "altered_answer"): _fl_altered_answer,
    ("tiny-glm.serve", "altered_token"): _serve_altered_token,
    ("tiny-glm.serve", "unchanged_state"): _serve_unchanged_state,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS),
                         ids=lambda x: x if isinstance(x, str) else None)
def test_a_planted_fault_is_not_correct(root, monkeypatch, cell, fault):
    torch.set_num_threads(2)
    sound = tiny.run_tiny(root, cell, seconds=0.3)
    assert sound["correct"], sound["compared"]
    FAULTS[(cell, fault)](monkeypatch)
    broken = tiny.run_tiny(root, cell, seconds=0.3)
    assert not broken["correct"], broken["compared"]


@pytest.mark.parametrize("cell", ["tiny-dense.fl", "tiny-dense.fleet"])
def test_the_half_batch_control_is_judged_not_correct(root, cell):
    """A control's numbers go through the cell's limits and the expression
    that judges the program (TF32 is no lower precision on the CPU, so only
    the half-batch control is held here; the card tests hold both)."""
    torch.set_num_threads(2)
    out = tiny.run_tiny(root, cell, seconds=0.3, control=True)
    assert out["correct"], out["compared"]
    ctl = out["control"]["half_batch"]
    assert not ctl["correct"], ctl["compared"]
    assert {k: c["limit"] for k, c in ctl["compared"].items()} == \
        {k: c["limit"] for k, c in out["compared"].items()}
