"""The yardstick's arithmetic: the card's peaks, the FLOPs a task needs,
and each measured kernel's operations and bytes.

Peaks are NVIDIA's H100 SXM data sheet, dense, without sparsity, at the
700 W power limit.  A share of a peak is taken against a rate that no
implementation passing the benchmark's checks can exceed: 989 TFLOP/s
(bf16, the tensor cores' dense peak) for operations and 3.35 TB/s for HBM
bytes, whichever bounds.  The f32 CUDA-core rate (67 TFLOP/s) is kept for
prose only: split-precision tensor-core GEMMs beat it.

"Needed" FLOPs count the work the task asks for, not the work the
program does: every layer's matmuls (2 FLOPs a multiply-add; biases,
norms and activations not counted), causal attention at every position
(QK^T and PV over the keys at or before it), and the unembedding only
where its output is read: the verbalizer columns at the SEP position of a
training example, the full vocabulary at a position that yields a served
token.
"""
from __future__ import annotations

PEAKS = {
    "H100": {"flops": 989e12, "bytes": 3.35e12, "f32_cuda_core": 67e12,
             "tf32": 495e12, "memory_bytes": 80e9},
}


def peaks(kind: str):
    """The peak table of the card named ``kind`` (None: not in the
    table, so no share is reported)."""
    for key, p in PEAKS.items():
        if key in (kind or ""):
            return p
    return None


def dims(m: dict):
    D, H = m["d_model"], m["n_heads"]
    hd = m.get("head_dim") or D // H
    return D, H, m["n_kv_heads"], hd, m["d_ff"], m["n_layers"], m["vocab"]


def layer_matmul_params(m: dict) -> int:
    """Multiply-adds a token takes in one layer's projections and MLP."""
    D, H, KV, hd, F, _, _ = dims(m)
    return D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F


def attn_flops(m: dict, keys: int) -> float:
    """QK^T and PV of one query position over ``keys`` keys, all layers."""
    D, H, KV, hd, F, L, V = dims(m)
    return 4.0 * L * H * hd * keys


def causal_attn_flops(m: dict, S: int) -> float:
    """Causal attention over a sequence of S (position i sees i + 1)."""
    return attn_flops(m, S * (S + 1) / 2)


def body_flops(m: dict, tokens: int) -> float:
    """The layers' matmuls for ``tokens`` positions."""
    return 2.0 * m["n_layers"] * layer_matmul_params(m) * tokens


def train_forward_flops(m: dict, B: int, S: int, n_classes: int) -> float:
    """One classification forward: B sequences of S, the unembedding only
    for the verbalizer columns at SEP."""
    D = m["d_model"]
    return B * (body_flops(m, S) + causal_attn_flops(m, S)
                + 2.0 * D * n_classes)


def zo_step_flops(m: dict, B: int, S: int, n_classes: int) -> float:
    """A zeroth-order step: the two perturbed forwards."""
    return 2.0 * train_forward_flops(m, B, S, n_classes)


def prefill_flops(m: dict, prompt: int) -> float:
    """A prompt's prefill; only its last position yields a token."""
    return (body_flops(m, prompt) + causal_attn_flops(m, prompt)
            + 2.0 * m["d_model"] * m["vocab"])


def decode_flops(m: dict, keys: int) -> float:
    """One served token from a position that attends ``keys`` keys."""
    return (body_flops(m, 1) + attn_flops(m, keys)
            + 2.0 * m["d_model"] * m["vocab"])


# ---------------------------------------------------------------- kernels --
def zo_update_bytes(n_pad: int) -> tuple:
    """(dual perturb, fused update) bytes over a flat f32 vector of n_pad:
    each input read once, each output written once (w, z -> w+, w-;
    delta, z -> delta')."""
    return 16.0 * n_pad, 12.0 * n_pad


def flash_fwd_work(B: int, S: int, H: int, KV: int, hd: int) -> tuple:
    """(FLOPs, bytes) of a causal f32 forward over q [B, S, H, hd] and k, v
    [B, S, KV, hd]: QK^T and PV over the causal half, q, k, v read once,
    o written once."""
    ops = 4.0 * B * H * hd * S * (S + 1) / 2
    nbytes = 4.0 * B * S * hd * (2 * H + 2 * KV)
    return ops, nbytes


def decode_attn_bytes(keys: int, KV: int, hd: int, H: int) -> float:
    """One decode-attention row: its cache's k and v over ``keys``
    positions read once, q read and o written once (f32)."""
    return 4.0 * (2 * keys * KV * hd + 2 * H * hd)


def bound_s(ops: float, nbytes: float, p: dict) -> float:
    """The least time the card could take: operations over the peak rate
    or bytes over the peak bandwidth, whichever is longer."""
    return max(ops / p["flops"], nbytes / p["bytes"])
