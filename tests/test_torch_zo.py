"""The port's ZO machinery on its own: both routes of the estimator, the
multi-direction estimator against its replay, spaces and dispatch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DenseSpace, MaskedSpace, aggregate, get_backing,
                              local_step, make_local_run, projected_gradient,
                              reconstruct_delta, resolve_backend, round_keys)
from repro_torch.core.dispatch import FLAT_ROUTE_VECTORS

N_LEAF = (64, 48)


def _setup(seed=0, density=0.05):
    g = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn(N_LEAF, generator=g),
              "b": {"c": torch.randn(300, generator=g)}}
    target = {"a": torch.randn(N_LEAF, generator=g),
              "b": {"c": torch.randn(300, generator=g)}}
    rng = np.random.default_rng(seed)
    idx = {"a": torch.as_tensor(np.sort(rng.choice(
               np.prod(N_LEAF), int(np.prod(N_LEAF) * density),
               replace=False))),
           "b": {"c": torch.as_tensor(np.sort(rng.choice(300, 20,
                                                         replace=False)))}}

    def loss(p, batch):
        return sum(((p[k] - target[k]) ** 2).sum() for k in ("a",)) + \
            ((p["b"]["c"] - target["b"]["c"]) ** 2).sum() * batch["w"][0]

    return params, MaskedSpace(idx), loss


def test_routes_agree_on_projected_gradient():
    params, space, loss = _setup()
    z = space.sample_z(round_keys(0, 0, 1)[0])
    delta = torch.zeros(space.n)
    batch = {"w": torch.ones(1)}
    gk = projected_gradient(loss, params, space, delta, z, 1e-2, batch,
                            backend="kernel")
    gr = projected_gradient(loss, params, space, delta, z, 1e-2, batch,
                            backend="ref")
    assert float(gk) == pytest.approx(float(gr), rel=1e-4)


@pytest.mark.parametrize("n_dirs", [1, 3])
def test_local_step_routes_agree(n_dirs):
    params, space, loss = _setup(1)
    key = round_keys(3, 1, 1)[0]
    batch = {"w": torch.ones(1)}
    out = [local_step(loss, params, space, torch.zeros(space.n), key, 1e-2,
                      1e-3, batch, n_dirs=n_dirs, backend=be)
           for be in ("kernel", "ref")]
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("backend", ["kernel", "ref"])
@pytest.mark.parametrize("n_dirs", [1, 2])
@pytest.mark.parametrize("T", [1, 3])
def test_client_run_replays_on_server(T, n_dirs, backend):
    params, space, loss = _setup(2)
    run = make_local_run(loss, space, eps=1e-2, lr=1e-3, n_dirs=n_dirs,
                         backend=backend)
    keys = round_keys(5, 0, T)
    batches = {"w": torch.ones(T, 1)}
    delta, gs = run(params, keys, batches, torch.zeros(space.n))
    assert gs.shape == ((T,) if n_dirs == 1 else (T, n_dirs))
    rec = reconstruct_delta(space, keys, gs.numpy(), 1e-3)
    # the client applies (-lr*g)*z, the replay lr*(g*z): each step rounds
    # its product differently, so steps that cancel leave an absolute error
    # of ~1e-7 of the step size, not of the (smaller) sum
    torch.testing.assert_close(delta, rec, rtol=1e-6,
                               atol=1e-6 * float(delta.abs().max()))


def test_masked_space_add_slice_roundtrip():
    params, space, _ = _setup(3)
    vec = torch.randn(space.n, generator=torch.Generator().manual_seed(0))
    moved = space.add(params, vec)
    got = space.slice(moved) - space.slice(params)
    torch.testing.assert_close(got, vec, rtol=0, atol=1e-6)
    backing = get_backing(space, params)
    dense = backing.expand(vec)
    torch.testing.assert_close(backing.restrict(dense), vec, rtol=0, atol=0)
    assert int((dense != 0).sum()) == int((vec != 0).sum())


def test_dense_space_is_identity_layout():
    params, _, _ = _setup(4)
    space = DenseSpace(params)
    backing = get_backing(space, params)
    assert backing.identity and backing.global_index is None
    vec = torch.arange(space.n, dtype=torch.float32)
    torch.testing.assert_close(backing.restrict(backing.expand(vec)), vec)


def test_resolve_backend_rules():
    params, space, _ = _setup(5)
    backing = get_backing(space, params)
    assert resolve_backend("auto", backing) == "kernel"
    assert resolve_backend("ref", backing) == "ref"
    assert resolve_backend(None, backing) == "kernel"
    with pytest.raises(ValueError):
        resolve_backend("pallas", backing)
    big = {"w": torch.empty(256 * 1024 * 1024 // (4 * FLAT_ROUTE_VECTORS)
                            + 4096, device="meta")}
    big_space = DenseSpace(big)
    assert resolve_backend("auto", get_backing(big_space, big)) == "ref"


def test_aggregate_mean_and_empty():
    d = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    torch.testing.assert_close(aggregate(d), d.mean(0))
    with pytest.raises(ValueError):
        aggregate(torch.zeros(0, 4))


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_client_run_leaves_no_cyclic_garbage(backend):
    """Every temporary of a client run on a real model is freed by
    reference counting: a reference cycle around the perturbed parameter
    trees would hold their flat vectors (GBs at full size) until Python's
    cycle collector happened to run."""
    import gc

    from repro_torch.configs import TINY
    from repro_torch.data import TaskSpec, make_task_fns, sample_dataset
    from repro_torch.models import Model
    model = Model(TINY, device="cpu")
    params = model.init(seed=0)
    spec = TaskSpec(seq_len=8)
    loss, _, _ = make_task_fns(model, spec)
    rng = np.random.default_rng(0)
    space = MaskedSpace({k: v for k, v in zip(
        ("embed", "final_norm", "stack"),
        (torch.as_tensor(np.sort(rng.choice(512 * 64, 50, replace=False))),
         {"scale": torch.arange(0)},
         {"p0": {k: torch.arange(3) for k in (
             "w1", "w2", "w3", "wk", "wo", "wq", "wv")} |
          {"norm": {"scale": torch.arange(0)},
           "norm2": {"scale": torch.arange(0)}}}))})
    data = sample_dataset(spec, 8, seed=1)
    batches = {k: torch.as_tensor(v.reshape(2, 4, *v.shape[1:]))
               for k, v in data.items()}
    run = make_local_run(loss, space, eps=1e-2, lr=1e-3, backend=backend)
    keys = round_keys(1, 0, 2)
    run(params, keys, batches, torch.zeros(space.n))
    gc.collect()
    gc.disable()
    try:
        gc.set_debug(gc.DEBUG_SAVEALL)
        run(params, keys, batches, torch.zeros(space.n))
        gc.collect()
        leaked = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert leaked == []
