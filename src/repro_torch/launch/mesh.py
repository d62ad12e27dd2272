"""Meshes and ranks (``repro.launch.mesh``).

``parse_mesh_spec`` maps the CLI syntax of ``launch/train.py --mesh`` onto a
:class:`MeshConfig`, as the JAX package does.  A mesh here is a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group, one rank per device: ``make_mesh_from_config`` builds it and raises
when the group does not have ``n_devices`` ranks (as JAX raises on too few
devices).

Ranks are started in one of two ways, and nothing else in the port starts
them:

* :func:`spawn` runs a function on ``n`` local ranks, each a fresh process
  joined to the others through a ``FileStore`` under a temporary directory
  (no TCP port, so parallel test workers cannot collide): gloo on the CPU,
  NCCL with one card a rank (``cuda:{rank}``) on the GPU;
* :func:`process_group` joins the calling process as one rank: the lone
  rank of a one-device mesh (``"1x1"``), a rank that :func:`spawn` started,
  or a rank that ``torchrun`` started (its environment gives the address).

The dry run needs no devices at all: :func:`fake_mesh` makes the calling
process rank 0 of a ``"fake"`` process group of any size (its collectives
move nothing), with a ``DeviceMesh`` over it, so one process can trace
what one device of the production mesh runs (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig
from repro_torch.utils.device import rank_device


def parse_mesh_spec(spec: str) -> MeshConfig:
    """CLI mesh spec -> :class:`MeshConfig`.

    Accepted forms:

    * ``"DxM"``     — single pod, D 'data' x M 'model' devices (``"2x2"``)
    * ``"PxDxM"``   — multi-pod, P 'pod' x D 'data' x M 'model' (``"2x16x16"``)
    * ``"single"``  — the production 16x16 single-pod mesh (256 devices)
    * ``"multi"``   — the production 2x16x16 multi-pod mesh (512 devices)

    ``"1x1"`` is a valid degenerate mesh (1 device), the smallest sharded
    configuration.
    """
    named = {"single": MeshConfig(data=16, model=16, pods=1),
             "multi": MeshConfig(data=16, model=16, pods=2)}
    if spec in named:
        return named[spec]
    parts = spec.split("x")
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}: want DxM, PxDxM, "
                         f"or one of {sorted(named)}")
    if len(dims) == 2:
        return MeshConfig(data=dims[0], model=dims[1], pods=1)
    if len(dims) == 3:
        return MeshConfig(pods=dims[0], data=dims[1], model=dims[2])
    raise ValueError(f"bad mesh spec {spec!r}: want 2 or 3 'x'-separated dims")


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MeshConfig(data=16, model=16, pods=2 if multi_pod else 1)


def make_production_mesh(*, multi_pod: bool = False):
    """The 16x16 single-pod (256 devices) or 2x16x16 multi-pod (512
    devices) mesh over the default process group, which must have that
    many ranks (:func:`fake_mesh` gives one without devices)."""
    return make_mesh_from_config(mesh_config(multi_pod=multi_pod))


@contextlib.contextmanager
def fake_mesh(mc: MeshConfig, rank: int = 0):
    """Make this process rank ``rank`` of a ``"fake"`` process group of
    ``mc.n_devices`` ranks (``torch.testing``'s ``FakeStore``: no peer, no
    device, and collectives that return at once with their output
    buffers as they are) and yield a CPU ``DeviceMesh`` of ``mc.shape``
    named ``mc.axis_names`` over it.  The group is destroyed on exit.

    Raises if a process group exists already: a group left behind would
    break the next ``spawn`` or ``process_group`` of the same process."""
    if dist.is_initialized():
        raise RuntimeError("a process group exists already; fake_mesh "
                           "makes its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=mc.n_devices)
    try:
        yield make_mesh_from_config(mc, "cpu")
    finally:
        dist.destroy_process_group()


def group_device_type() -> str:
    """``"cuda"`` when the default process group runs NCCL, else ``"cpu"``."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh_from_config(mc: MeshConfig, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of shape ``mc.shape`` named ``mc.axis_names`` over
    every rank of the default process group (rank ``r`` at the row-major
    coordinate ``r``).  ``device_type`` defaults to the group's."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {mc.shape} needs a process group of {mc.n_devices} "
            "rank(s): start them with launch.mesh.spawn or join one with "
            "launch.mesh.process_group")
    world = dist.get_world_size()
    if world != mc.n_devices:
        raise RuntimeError(
            f"need {mc.n_devices} ranks for mesh {mc.shape}; the process "
            f"group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or group_device_type(), mc.shape,
                            mesh_dim_names=mc.axis_names)


def torchrun_env():
    """(rank, world size, local rank) that ``torchrun`` exported, or None."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    if not all(k in os.environ for k in keys):
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ["LOCAL_RANK"]))


@contextlib.contextmanager
def process_group(device_type: str, rank: int = 0, world_size: int = 1,
                  store_path: Optional[str] = None):
    """Join the calling process to a process group as one rank; yields the
    rank's device (``utils.device.rank_device``) and destroys the group on
    exit.

    The ranks meet at a ``FileStore`` at ``store_path`` (a fresh temporary
    file for a lone rank).  Under ``torchrun`` its environment gives the
    rank, world size and address instead.  When a default group exists
    already, the rank joins nothing, yields its device and leaves the group
    as it found it."""
    if dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        yield rank_device(group_device_type(), local)
        return
    env = torchrun_env()
    local = rank if env is None else env[2]
    dev = rank_device(device_type, local)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with contextlib.ExitStack() as stack:
        if env is not None:
            dist.init_process_group(backend, rank=env[0], world_size=env[1])
        else:
            if store_path is None:
                if world_size != 1:
                    raise ValueError("ranks of a group of more than one "
                                     "meet at a store_path")
                store_path = os.path.join(stack.enter_context(
                    tempfile.TemporaryDirectory(prefix="repro_torch_rank_")),
                    "store")
            dist.init_process_group(
                backend, store=dist.FileStore(store_path, world_size),
                rank=rank, world_size=world_size)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def _rank_main(call_path, rank, world_size, device_type, store_path,
               results):
    """One spawned rank: join the group, run ``fn(dev, *args)`` (pickled
    by :func:`spawn` at ``call_path``), report."""
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        if device_type == "cpu":
            torch.set_num_threads(1)  # n ranks share the host's cores
        with process_group(device_type, rank, world_size, store_path) as dev:
            out = fn(dev, *args)
        results.put((rank, None, out))
    except BaseException:  # the rank's boundary: report, then exit non-zero
        results.put((rank, traceback.format_exc(), None))
        raise


def spawn(fn: Callable, n_ranks: int, device_type: str, *args,
          timeout: float = 900.0) -> List:
    """Run ``fn(dev, *args)`` on ``n_ranks`` local ranks (fresh processes,
    ``spawn`` start method; ``fn`` and ``args`` are pickled, so ``fn`` is
    a module-level function) and return their results in rank order.

    On the GPU each rank takes one card (``cuda:{rank}``), and more ranks
    than cards raise before any starts.  When a rank fails or dies, the
    others are stopped and a ``RuntimeError`` carries the failure."""
    if device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_ranks > n:
            raise RuntimeError(f"{n_ranks} ranks need {n_ranks} CUDA "
                               f"devices, one a rank; {n} are visible")
    elif device_type != "cpu":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device_type!r}")
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out, errors = {}, {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as d:
        store = os.path.join(d, "store")
        # the call goes through a file: through the start pipe, a call
        # larger than the pipe's buffer would hold up each start until the
        # rank before has imported everything and read it
        call = os.path.join(d, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(call, r, n_ranks, device_type, store,
                                   results))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) + len(errors) < n_ranks and not errors:
                try:
                    rank, err, value = results.get(timeout=0.2)
                except queue.Empty:
                    dead = {r: p.exitcode for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in out and r not in errors}
                    if dead:
                        errors.update({r: f"exited with code {c}"
                                       for r, c in dead.items()})
                    elif time.monotonic() > deadline:
                        errors[-1] = f"timed out after {timeout} s"
                    continue
                if err is None:
                    out[rank] = value
                else:
                    errors[rank] = err
        finally:
            for p in procs:
                if errors:
                    p.kill()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("; ".join(f"rank {r}: {e}"
                                     for r, e in sorted(errors.items())))
    return [out[r] for r in range(n_ranks)]
