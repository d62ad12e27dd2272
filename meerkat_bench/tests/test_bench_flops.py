"""The yardstick's arithmetic against hand counts at a small size, and
every share it yields at the predicted times no more than the whole."""
import json
from pathlib import Path

import pytest

from meerkat_bench import flops

BENCH = Path(__file__).resolve().parents[1]
SMALL = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab": 32}


def test_layer_matmuls_by_hand():
    # q 8x8, k 8x4, v 8x4, o 8x8, w1 w3 8x16, w2 16x8
    assert flops.layer_matmul_params(SMALL) == 64 + 32 + 32 + 64 + 3 * 128


def test_train_forward_by_hand():
    # B=3, S=5: body 2*2*(576)*5 a sequence; causal keys 1+..+5 = 15,
    # 4 * L * H * hd = 64 a key; verbalizer head 2 * 8 * 4
    per_seq = 2 * 2 * 576 * 5 + 64 * 15 + 2 * 8 * 4
    assert flops.train_forward_flops(SMALL, 3, 5, 4) == 3 * per_seq
    assert flops.zo_step_flops(SMALL, 3, 5, 4) == 6 * per_seq


def test_serve_by_hand():
    assert flops.prefill_flops(SMALL, 5) == 2 * 2 * 576 * 5 + 64 * 15 \
        + 2 * 8 * 32
    assert flops.decode_flops(SMALL, 9) == 2 * 2 * 576 + 64 * 9 + 2 * 8 * 32


def test_kernel_counts_by_hand():
    assert flops.zo_update_bytes(10) == (160.0, 120.0)
    ops, nbytes = flops.flash_fwd_work(2, 3, 4, 2, 8)
    assert ops == 4 * 2 * 4 * 8 * 6          # causal pairs 1+2+3 = 6
    assert nbytes == 4 * 2 * 3 * 8 * (2 * 4 + 2 * 2)
    assert flops.decode_attn_bytes(7, 2, 8, 4) == 4 * (2 * 7 * 2 * 8
                                                       + 2 * 4 * 8)


def test_bound_takes_the_longer_side():
    p = flops.peaks("NVIDIA H100 80GB HBM3")
    assert p["flops"] == 989e12 and p["bytes"] == 3.35e12
    assert flops.bound_s(989e12, 1.0, p) == pytest.approx(1.0)
    assert flops.bound_s(1.0, 3.35e12, p) == pytest.approx(1.0)
    assert flops.peaks("cpu") is None


def _model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())[
        "model"]


# the predicted device times (PERF.md) at the cells' shapes
@pytest.mark.parametrize("case", [
    # Qwen2-1.5B: a ZO step of 16 x 512 in 1.13 s; the flash forward
    # 0.20 s over 448 launches
    ("mfu", "qwen2-1.5b", 16, 512, 1.13),
    ("mfu", "qwen2-1.5b", 2, 256, 0.13),
    ("flash", "qwen2-1.5b", 16, 512, 0.20 / 448),
    ("flash", "qwen2-1.5b", 2, 256, 0.046 / 896),
])
def test_shares_stay_under_the_whole(case):
    kind, name, B, S, secs = case
    m, p = _model(name), flops.PEAKS["H100"]
    if kind == "mfu":
        share = flops.zo_step_flops(m, B, S, 4) / secs / p["flops"]
    else:
        D, H, KV, hd, _, _, _ = flops.dims(m)
        share = flops.bound_s(*flops.flash_fwd_work(B, S, H, KV, hd), p) \
            / secs
    assert 0 < share <= 1


def test_zo_rows_and_decode_shares_under_the_whole():
    p = flops.PEAKS["H100"]
    n_pad = 1543714304
    dual, upd = flops.zo_update_bytes(n_pad)
    # rows 1-2 at Qwen2-1.5B's n_pad: 8.6 and 6.2 ms a launch on the card
    assert flops.bound_s(0, dual, p) / 8.6e-3 <= 1
    assert flops.bound_s(0, upd, p) / 6.2e-3 <= 1
    m = _model("chatglm3-6b")
    D, H, KV, hd, _, L, _ = flops.dims(m)
    # 32 rows at 3072 keys, every layer, in a 25 ms step's 13% share
    need = 32 * L * flops.decode_attn_bytes(3072, KV, hd, H)
    assert flops.bound_s(0, need, p) / (0.13 * 25e-3) <= 1
    step = 32 * flops.decode_flops(m, 3072)
    assert step / 25e-3 / p["flops"] <= 1
