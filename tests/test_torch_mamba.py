"""The selective scan and the Mamba mixer in torch against repro's: the plain
version and the CPU wrapper against the Pallas kernel (interpret mode) and
the JAX oracle; ``mamba_forward`` on both routes, with its state and a
right-padded batch; the scan route's gradient against ``jax.grad``; and the
``mamba_mode`` rule."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan as j_mamba_scan
from repro.models.init import init_params as j_init
from repro.models.ssm import mamba_forward as j_mamba_forward
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, plans, ref
from repro_torch.models import ssm
from repro_torch.utils.tree import tree_flatten, tree_unflatten

# the scan against the JAX kernel and oracle, of the largest entry: f32
# sums of the same terms (the Pallas body and the port's fused multiply-add
# round differently), an error that grows with S as the decays near 1 keep
# the state (6.9e-7 seen over the grid)
SCAN_REL = 1e-5
# the mixer, either route against either JAX route, of the largest entry:
# the projections' f32 sums plus the scan's (7.6e-7 seen)
MIXER_REL = 1e-5
# the scan route's gradient against jax.grad, per leaf of the largest entry:
# the backward's f32 sums in two orders (1.2e-6 seen; 2.1e-6 on a whole
# reduced period)
GRAD_REL = 1e-5

CFG = "jamba-1.5-large-398b"


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _scan_inputs(B, S, E, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, E)))) * 0.1
    Bi, Ci = (rng.standard_normal((B, S, N)) for _ in range(2))
    x = rng.standard_normal((B, S, E))
    A = -np.exp(rng.standard_normal((E, N)))
    return [a.astype(np.float32) for a in (dt, Bi, Ci, x, A)]


def _fit(n, target):
    b = min(target, n)
    while n % b:
        b -= 1
    return b


# (B, S, E, N): S dividing the kernel's 256-step block or not, E dividing
# its 128 channels or not
@pytest.mark.parametrize("B,S,E,N", [(1, 256, 128, 8), (2, 300, 256, 16),
                                     (3, 37, 200, 16), (2, 64, 384, 8)])
def test_scan_matches_pallas_and_oracle(B, S, E, N):
    args = _scan_inputs(B, S, E, N, B * 1000 + S)
    jy, jh = j_mamba_scan(*map(jnp.asarray, args), e_block=_fit(E, 128),
                          s_block=_fit(S, 256), interpret=True)
    oy, oh = jref.mamba_scan_ref(*map(jnp.asarray, args))
    targs = [torch.tensor(a) for a in args]
    ry, rh = ref.mamba_scan_ref(*targs)
    before = ops.mamba_scan.launches
    wy, wh = ops.mamba_scan(*targs)
    assert ops.mamba_scan.launches == before  # the CPU runs the plain version
    assert torch.equal(wy, ry) and torch.equal(wh, rh)
    assert ry.shape == (B, S, E) and rh.shape == (B, E, N)
    assert ry.dtype == rh.dtype == torch.float32
    for want_y, want_h in ((jy, jh), (oy, oh)):
        assert _rel(ry, want_y) <= SCAN_REL
        assert _rel(rh, want_h) <= SCAN_REL


def _scan_in_kernel_order(dt, B_in, C_in, x, A):
    """The selective scan in ``csrc/mamba_scan.cu``'s order, in f32 torch
    ops: S in tiles of ``MAMBA_SEG`` segments x ``MAMBA_STEPS`` steps
    (zeros past S); per segment a_t = exp2(dt_t * A log2 e), the running
    decay P_j = a_0 ... a_j and the state from zero h0_j; a Kogge-Stone
    prefix of the segments' maps h -> P h + h0 (the warp's shuffle scan,
    earlier maps first); each segment's entering state from the tile's
    carry; h_j = P_j h_in + h0_j and y_t summed over n in order; the last
    state is the next tile's carry and, after the last tile, h_last."""
    seg, k = plans.MAMBA_SEG, plans.MAMBA_STEPS
    Bsz, S, E = dt.shape
    N = A.shape[1]
    T = seg * k
    n_tiles = -(-S // T)
    pad = (0, 0, 0, n_tiles * T - S)
    dt, x = (torch.nn.functional.pad(t, pad) for t in (dt, x))
    B_in, C_in = (torch.nn.functional.pad(t, pad) for t in (B_in, C_in))
    A2 = A * torch.tensor(1.4426950408889634, dtype=torch.float32)
    s_idx = torch.arange(seg)[None, :, None, None]
    carry = torch.zeros(Bsz, E, N)
    ys = []
    for i in range(n_tiles):
        t = slice(i * T, (i + 1) * T)
        dts = dt[:, t].reshape(Bsz, seg, k, E, 1)
        dtx = dts * x[:, t].reshape(Bsz, seg, k, E, 1)
        Bt = B_in[:, t].reshape(Bsz, seg, k, 1, N)
        Ct = C_in[:, t].reshape(Bsz, seg, k, 1, N)
        a = torch.exp2(dts * A2)                    # [B, seg, k, E, N]
        b = dtx * Bt
        P, h0 = [a[:, :, 0]], [b[:, :, 0]]
        for j in range(1, k):
            P.append(P[-1] * a[:, :, j])
            h0.append(a[:, :, j] * h0[-1] + b[:, :, j])
        P, h0 = torch.stack(P, 2), torch.stack(h0, 2)
        Ps, Qs = P[:, :, -1], h0[:, :, -1]          # [B, seg, E, N]
        d = 1
        while d < seg:
            Pu = torch.roll(Ps, d, 1)
            Qu = torch.roll(Qs, d, 1)
            on = s_idx >= d
            Qs = torch.where(on, Ps * Qu + Qs, Qs)
            Ps = torch.where(on, Ps * Pu, Ps)
            d *= 2
        h_in = torch.where(s_idx == 0, carry[:, None],
                           torch.roll(Ps, 1, 1) * carry[:, None]
                           + torch.roll(Qs, 1, 1))
        h = P * h_in[:, :, None] + h0               # [B, seg, k, E, N]
        y = torch.zeros(Bsz, seg, k, E)
        for n in range(N):
            y = y + h[..., n] * Ct[..., n]
        ys.append(y.reshape(Bsz, T, E))
        carry = h[:, -1, -1]
    return torch.cat(ys, 1)[:, :S], carry


# (B, S, E, N): many tiles (S 2048: 16 carries), ragged S and E, N 8 and 16
# and one step
@pytest.mark.parametrize("B,S,E,N", [(1, 2048, 64, 16), (2, 300, 40, 8),
                                     (3, 37, 33, 16), (1, 129, 16, 8),
                                     (2, 1, 8, 16)])
def test_scan_kernel_order_matches_pallas_and_oracle(B, S, E, N):
    """The CUDA kernel's order of operations (``_scan_in_kernel_order``)
    against the Pallas kernel (interpret mode) and the JAX oracle: the
    warp scan's re-association and exp2 of A log2 e stay within
    SCAN_REL."""
    args = _scan_inputs(B, S, E, N, 7 * S + E)
    jy, jh = j_mamba_scan(*map(jnp.asarray, args), e_block=_fit(E, 128),
                          s_block=_fit(S, 256), interpret=True)
    oy, oh = jref.mamba_scan_ref(*map(jnp.asarray, args))
    ey, eh = _scan_in_kernel_order(*map(torch.tensor, args))
    assert ey.shape == (B, S, E) and eh.shape == (B, E, N)
    for want_y, want_h in ((jy, jh), (oy, oh)):
        assert _rel(ey, want_y) <= SCAN_REL
        assert _rel(eh, want_h) <= SCAN_REL


def test_scan_wrapper_rejects_bad_shapes_and_autograd():
    dt, Bi, Ci, x, A = map(torch.tensor, _scan_inputs(1, 8, 16, 8, 0))
    with pytest.raises(ValueError):
        ops.mamba_scan(dt, Bi, Ci, x[:, :4], A)
    with pytest.raises(ValueError):
        ops.mamba_scan(dt, Bi, Ci, x, A[:, :4])
    with pytest.raises(RuntimeError):
        ops.mamba_scan(dt.requires_grad_(True), Bi, Ci, x, A)
    with torch.no_grad():
        ops.mamba_scan(dt, Bi, Ci, x, A)


@pytest.fixture(scope="module")
def mixer():
    """One Mamba layer of reduced Jamba (d 256, E 512, N 8), JAX init."""
    jcfg = j_get_config(CFG).reduced()
    jp = j_init(jax.random.key(0), jcfg)
    lp = jax.tree.map(lambda a: np.asarray(a[0]), jp["stack"]["p1"])
    assert "A_log" in lp
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    valid = np.ones((2, 40), bool)
    valid[1, 29:] = False
    return dict(jcfg=jcfg, lp=lp, tp=params_from_numpy(lp, device="cpu"), x=x,
                valid=valid, scfg=get_config(CFG + "-reduced").ssm)


@pytest.mark.parametrize("use_valid", [False, True])
@pytest.mark.parametrize("jmode", ["scan", "kernel"])
@pytest.mark.parametrize("mode", ["scan", "kernel"])
def test_mamba_forward_matches_jax(mixer, mode, jmode, use_valid):
    """Chunks of 16 over S = 40: a padded last chunk on the scan route."""
    m = mixer
    valid = m["valid"] if use_valid else None
    jo, (jbuf, jh) = j_mamba_forward(
        jnp.asarray(m["x"]), jax.tree.map(jnp.asarray, m["lp"]),
        m["jcfg"].ssm, chunk=16, return_state=True, mode=jmode,
        valid=None if valid is None else jnp.asarray(valid))
    with torch.no_grad():
        to, (tbuf, th) = ssm.mamba_forward(
            torch.tensor(m["x"]), m["tp"], m["scfg"], chunk=16,
            return_state=True, mode=mode,
            valid=None if valid is None else torch.tensor(valid))
    assert _rel(to, jo) <= MIXER_REL
    assert _rel(th, jh) <= MIXER_REL
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))


def test_scan_route_gradient_matches_jax(mixer):
    """d/d(x, every leaf) of sum(out * w) on the scan route (each chunk
    recomputed in the backward) against jax.grad of JAX's scan route."""
    m = mixer
    w = np.random.default_rng(8).standard_normal(m["x"].shape).astype(
        np.float32)

    def jloss(x, p):
        out = j_mamba_forward(x, p, m["jcfg"].ssm, chunk=16, mode="scan")
        return jnp.sum(out * w)

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(m["x"]), jax.tree.map(jnp.asarray, m["lp"]))
    x = torch.tensor(m["x"], requires_grad=True)
    leaves, treedef = tree_flatten(m["tp"])
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    tp = tree_unflatten(treedef, leaves)
    out = ssm.mamba_forward(x, tp, m["scfg"], chunk=16, mode="auto")
    (out * torch.tensor(w)).sum().backward()
    assert _rel(x.grad, jgx) <= GRAD_REL
    for got, want in zip(leaves, jax.tree_util.tree_leaves(jgp)):
        if got.grad is None:  # the layer's norm is applied outside
            assert not np.any(np.asarray(want))
            continue
        assert _rel(got.grad, want) <= GRAD_REL


def test_mamba_mode_rule(mixer, monkeypatch):
    """auto: the kernel without autograd, the scan under it; an explicit
    kernel under autograd raises (the kernel has no backward, as in JAX);
    the dry run's stub is honoured; unknown modes are refused."""
    assert ssm.resolve_mamba_mode("auto", differentiable=False) == "kernel"
    assert ssm.resolve_mamba_mode(None, differentiable=False) == "kernel"
    assert ssm.resolve_mamba_mode("auto", differentiable=True) == "scan"
    assert ssm.resolve_mamba_mode("kernel", differentiable=True) == "kernel"
    assert ssm.resolve_mamba_mode("scan", differentiable=False) == "scan"
    assert ssm.resolve_mamba_mode("stub", differentiable=False) == "stub"
    for bad in ("pallas", "dense"):
        with pytest.raises(ValueError):
            ssm.resolve_mamba_mode(bad, differentiable=False)

    m = mixer
    calls = []
    real = ops.mamba_scan
    monkeypatch.setattr(ops, "mamba_scan",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.tensor(m["x"])
    with torch.no_grad():
        ssm.mamba_forward(x, m["tp"], m["scfg"], mode="auto")
    assert len(calls) == 1
    tp = {k: v.clone().requires_grad_(True) if k == "in_proj" else v
          for k, v in m["tp"].items()}
    ssm.mamba_forward(x, tp, m["scfg"], mode="auto").sum().backward()
    assert len(calls) == 1 and tp["in_proj"].grad is not None
    with pytest.raises(RuntimeError):
        ssm.mamba_forward(x, tp, m["scfg"], mode="kernel")
