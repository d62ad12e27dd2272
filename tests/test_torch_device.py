"""The port's entry points run on the CUDA card unless the caller asks for
the CPU, and nothing falls back: without a card they raise, and the kernel
build raises where there is no nvcc."""
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import TINY, FLConfig
from repro_torch.core import Client, FederatedZO, MaskedSpace, sensitivity_mask
from repro_torch.kernels import build, ops
from repro_torch.models import Model
from repro_torch.utils import resolve_device


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rules do not apply")


def _cpu_setup():
    model = Model(TINY, device="cpu")
    params = model.init(seed=0)
    space = MaskedSpace({"embed": torch.arange(8),
                         "final_norm": {"scale": torch.arange(0)},
                         "stack": {"p0": {k: torch.arange(0) for k in (
                             "w1", "w2", "w3", "wk", "wo", "wq", "wv")} |
                             {"norm": {"scale": torch.arange(0)},
                              "norm2": {"scale": torch.arange(0)}}}})
    return model, params, space


def test_resolve_device_requires_cuda_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        Model(TINY)
    model, params, space = _cpu_setup()
    batches = [{"tokens": np.zeros((2, 8), np.int32)}]
    with pytest.raises(RuntimeError):
        sensitivity_mask(model.loss, params, batches, 1e-2)
    clients = [Client(0, {"tokens": np.zeros((4, 8), np.int32),
                          "label": np.zeros(4, np.int32)}, 2)]
    with pytest.raises(RuntimeError):
        FederatedZO(model.loss, params, space, FLConfig(), clients)


def test_entry_points_run_on_cpu_when_asked():
    model, params, space = _cpu_setup()
    tokens = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(
        np.int32)
    batches = [{"tokens": tokens}]
    mask = sensitivity_mask(model.loss, params, batches, 1e-2, device="cpu")
    assert mask.n == round(model.n_params * 1e-2)
    srv = FederatedZO(lambda p, b: model.loss(p, b), params, space,
                      FLConfig(zo_backend="kernel"),
                      [Client(0, {"tokens": np.repeat(tokens, 2, 0)}, 2)],
                      device="cpu")
    gs = srv.run_round()
    assert np.all(np.isfinite(gs[0]))


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; anything else
    that is not a CUDA tensor raises instead of falling back."""
    w = torch.zeros(1024, device="meta")
    with pytest.raises(ValueError):
        ops.zo_fused_update_flat(w, w, None, 0.1)
    cpu = torch.zeros(1024)
    with pytest.raises(ValueError):
        ops.zo_dual_perturb_flat(cpu, w, None, 0.1)


def test_cpu_runs_do_not_count_launches():
    ops.reset_launches()
    x = torch.ones(1024)
    ops.zo_fused_update_flat(x, x, None, 0.5)
    ops.gradip_flat(x, x, 1.0)
    assert all(v == 0 for v in ops.launches().values())
