"""Recording one eager call: the port's counterpart of a jaxpr.

PyTorch traces nothing, so the analyzer runs a program once, for real,
under :class:`Recorder`, a ``TorchDispatchMode`` that writes down every
aten op the call dispatches: its name, its outputs' shapes, dtypes and
devices, and which stored values it reads and writes.  Values are
identified by their storage (views and in-place results share their base's
id), through weak references and storage addresses only, so the recorder
keeps no tensor alive and a full-width run holds no more memory than it
would alone.

A kernel wrapper of ``kernels/ops.py`` is **one record**, on the CPU and
on the card alike: while a recorder is active each wrapper hands its call
to :meth:`Recorder.kernel`, and the ops it runs inside (the plain version
on the CPU; the output allocations on the card) are counted under that
record, not among the program's ops.  Its returned tensors are its
outputs, and it carries its launch plan (``kernels/plans.py``).  That keeps
the dense rule and the liveness estimate the same on both devices.

Each record also carries its cost, what one device does for it: ``flops`` of
the matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the SDPA and
convolution ops, as ``torch.utils.flop_counter`` counts them) and ``bytes``,
the bytes of its inputs and outputs (eager PyTorch fuses nothing; views and
``prim`` ops move none).  Under DTensors (the tensor-parallel layout) the
recorder counts only ops on plain tensors, the local ops each DTensor op issues
on this rank's shards and its collectives: a DTensor-level op is handed back to
DTensor (``NotImplemented``) unrecorded, or its global shapes would count it a
second time.  DTensor's sharding propagation runs ops of its own on fake
tensors: :func:`record` pauses the recorder inside it
(:func:`quiet_propagation`; where a torch version lacks the hook, ``warmup``
runs the call once unrecorded to fill DTensor's propagation cache instead), and
a recorder on real tensors skips fake ones.  Storages are told apart by their
``StorageImpl``, so fake tensors (``launch/dryrun.py``) record as real ones do.

The helpers mirror ``repro.analysis.walk``: :func:`iter_ops`,
:func:`record_bytes`, :func:`max_square_dims`, :func:`square_dim_findings`,
:func:`constant_records`, :func:`kernel_block_records` and
:func:`liveness_peak_bytes`.  No rule policy lives here.
"""
from __future__ import annotations

import contextlib
import itertools
import weakref
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import ops as kops
from repro_torch.kernels import plans
from repro_torch.utils.tree import is_dtensor

# ops that make a tensor from host data (torch.tensor / as_tensor of an
# array or a Python value): the recompile rule's counterpart of a baked-in
# constant
LIFT_OPS = ("aten.lift_fresh.default", "aten.lift_fresh_copy.default")


@dataclass(frozen=True)
class Out:
    """One output of a record: ``sid`` names its storage; ``new_bytes`` is
    the storage's size when the record allocated it, 0 for a view or an
    in-place result."""
    shape: tuple
    dtype: str
    device: str
    sid: int
    new_bytes: int


@dataclass
class Record:
    """One op of the program, or one kernel (``kind == "kernel"``)."""
    name: str
    kind: str                      # "op" | "kernel"
    ins: tuple                     # storage ids read (tensor arguments)
    in_devices: tuple
    outs: List[Out]
    in_dtypes: tuple = ()
    kwargs: dict = field(default_factory=dict)  # non-tensor keyword args
    flops: float = 0.0             # matmul-class FLOPs (kernels: inner)
    bytes: float = 0.0             # input + output bytes
    launches: list = field(default_factory=list)  # plans.Launch (kernels)
    inner: int = 0                 # ops run inside a kernel record
    raised: Optional[str] = None   # the kernel's exception, if it raised


@dataclass
class Trace:
    """Everything one recorded call did, in program order."""
    records: List[Record]
    roots: dict                    # sid -> bytes of values from outside
    outputs: tuple                 # sids of the call's returned tensors
    device: str                    # the program's device type
    n_sms: int                     # SMs of the device (plans.H100_SMS on CPU)
    smem_optin: Optional[int]      # the card's per-block limit (None: CPU)
    raised: Optional[str] = None   # the call's exception, if it raised
    died: dict = field(default_factory=dict)  # sid -> records before death
    args: frozenset = frozenset()  # sids of the call's own arguments


def device_limits(device: torch.device):
    """(SMs, per-block opt-in shared bytes) of a CUDA device; for the CPU
    the H100's SMs (the launch plans' grids) and no limit of its own."""
    if device.type == "cuda":
        p = torch.cuda.get_device_properties(device)
        return p.multi_processor_count, p.shared_memory_per_block_optin
    return plans.H100_SMS, None


def tensors_of(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _locals_of(tree):
    """The tensors of a call's arguments or result, a DTensor by its local
    shard (the storage this rank holds)."""
    return [t.to_local() if is_dtensor(t) else t for t in tensors_of(tree)]


def _storage(t: torch.Tensor):
    """(identity, bytes) of t's storage, the identity its ``StorageImpl``
    (shared by views, and there on fake tensors too); (0, t's own bytes)
    for a wrapper subclass with no storage of its own (an async
    collective's result), which then never aliases another value."""
    inner = getattr(t, "elem", None)    # an async collective's wrapper
    if isinstance(inner, torch.Tensor) and inner is not t:
        return _storage(inner)
    try:
        s = t.untyped_storage()
        return s._cdata, s.nbytes()
    except (RuntimeError, NotImplementedError):
        return 0, t.numel() * t.element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def op_flops(func, args, kwargs, out) -> float:
    """FLOPs of one aten op as ``torch.utils.flop_counter`` counts them
    (the matmul-class ops; 0 for any other)."""
    from torch.utils.flop_counter import flop_registry
    f = flop_registry.get(func._overloadpacket)
    return 0.0 if f is None else float(f(*args, **kwargs, out_val=out))


# ops that move no data and that backends issue differently (a gloo rank's
# async collectives wrap and wait where a fake group's do not): unrecorded
_BOOKKEEPING = ("_c10d_functional.wait_tensor.default",
                "_c10d_functional._wrap_tensor_autograd.default")


class TraceBudgetExceeded(RuntimeError):
    """A recorded call ran more ops than its recorder's ``max_records``."""


class Recorder(TorchDispatchMode):
    """Writes one call's ops down (module docstring).  Use through
    :func:`record`."""

    def __init__(self, device: torch.device, fake: bool = False,
                 max_records: Optional[int] = None):
        super().__init__()
        self.max_records = max_records     # raise past this many records
        self.fake = fake                   # the call runs on fake tensors
        self.paused = 0                    # inside DTensor's propagation
        self.records: List[Record] = []
        self.roots = {}
        self.n_sms, self.smem_optin = device_limits(device)
        self._sids = itertools.count()
        self._ids = WeakIdKeyDictionary()  # tensor -> sid
        self._by_ptr = {}                  # live storage identity -> sid
        self._ptr_of = {}                  # sid -> its storage identity
        self._frames = []                  # [inner ops, flops] of kernels
        self._alive = {}                   # sid -> live tensor objects
        self._finalizers = []
        self.died = {}                     # sid -> len(records) at death

    def _track(self, t: torch.Tensor, sid: int) -> None:
        """Count t as one more live tensor of storage sid, and note when the
        last one dies: eager PyTorch frees the storage there."""
        self._ids[t] = sid
        self._alive[sid] = self._alive.get(sid, 0) + 1
        self._finalizers.append(weakref.finalize(t, self._release, sid))

    def _release(self, sid: int) -> None:
        self._alive[sid] -= 1
        if not self._alive[sid]:
            self.died[sid] = len(self.records)
            # the storage is gone: a later tensor at its address is new
            ptr = self._ptr_of.pop(sid, None)
            if ptr and self._by_ptr.get(ptr) == sid:
                del self._by_ptr[ptr]

    # ---------------------------------------------------------- values --
    def sid_of(self, t: torch.Tensor) -> int:
        """The id of t's storage; a tensor first met here comes from
        outside the call (an argument, a captured parameter) and is a
        root, live throughout."""
        sid = self._ids.get(t)
        if sid is None:
            ptr, nbytes = _storage(t)
            sid = self._by_ptr.get(ptr) if ptr else None
            if sid is None:
                sid = next(self._sids)
                self.roots[sid] = nbytes
                if ptr:
                    self._by_ptr[ptr] = sid
                    self._ptr_of[sid] = ptr
            self._track(t, sid)
        return sid

    def _outs(self, result, in_ptrs: dict) -> List[Out]:
        outs = []
        for t in tensors_of(result):
            ptr, nbytes = _storage(t)
            if ptr and ptr in in_ptrs:       # a view or an in-place result
                sid, new = in_ptrs[ptr], 0
            else:
                sid, new = next(self._sids), nbytes
                if ptr:
                    self._by_ptr[ptr] = sid
                    self._ptr_of[sid] = ptr
            if self._ids.get(t) is None:   # an in-place result is its input
                self._track(t, sid)
            outs.append(Out(tuple(t.shape), str(t.dtype).replace("torch.", ""),
                            t.device.type, sid, new))
        return outs

    def _inputs(self, args, kwargs):
        ts = tensors_of((args, kwargs))
        sids = tuple(self.sid_of(t) for t in ts)
        in_ptrs = {}
        for t, sid in zip(ts, sids):
            ptr = _storage(t)[0]
            if ptr:
                in_ptrs[ptr] = sid
        return ts, sids, in_ptrs

    # ------------------------------------------------------------- ops --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_dtensor(t) for t in tree_leaves((args, kwargs))):
            return NotImplemented       # DTensor issues the local ops
        if self.paused:                 # DTensor's shape propagation
            return func(*args, **kwargs)
        if self._frames:                     # inside a kernel record
            result = func(*args, **kwargs)
            self._frames[-1][0] += 1
            self._frames[-1][1] += op_flops(func, args, kwargs, result)
            return result
        name = str(func)
        if name.startswith("prim.") or name in _BOOKKEEPING:
            return func(*args, **kwargs)
        ts = tensors_of((args, kwargs))
        if not self.fake and any(_is_fake(t) for t in ts):
            return func(*args, **kwargs)     # DTensor's shape propagation
        if self.max_records and len(self.records) >= self.max_records:
            raise TraceBudgetExceeded(
                f"more than {self.max_records} ops recorded")
        ts, sids, in_ptrs = self._inputs(args, kwargs)
        result = func(*args, **kwargs)
        flags = {k: v for k, v in kwargs.items()
                 if isinstance(v, (bool, int, float, str))}
        if name.startswith("aten.copy_") and len(args) > 2:
            flags["non_blocking"] = bool(args[2])
        moved = 0.0
        if not func.is_view:
            moved = float(sum(_nbytes(t) for t in ts)
                          + sum(_nbytes(t) for t in tensors_of(result)))
        self.records.append(Record(
            name=name, kind="op", ins=sids,
            in_devices=tuple(t.device.type for t in ts),
            outs=self._outs(result, in_ptrs), kwargs=flags,
            in_dtypes=tuple(str(t.dtype).replace("torch.", "") for t in ts),
            flops=op_flops(func, args, kwargs, result), bytes=moved))
        return result

    def kernel(self, name: str, plan_of, fn, args, kwargs):
        """One kernel wrapper call as one record (``ops._recorded``)."""
        if self._frames:                     # a wrapper inside a wrapper
            self._frames[-1][0] += 1
            return fn(*args, **kwargs)
        ts, sids, in_ptrs = self._inputs(args, kwargs)
        launches = plan_of(self.n_sms, *args, **kwargs)
        rec = Record(name=f"kernel:{name}", kind="kernel", ins=sids,
                     in_devices=tuple(t.device.type for t in ts), outs=[],
                     launches=list(launches))
        self.records.append(rec)
        self._frames.append([0, 0.0])
        try:
            result = fn(*args, **kwargs)
        except Exception as e:
            rec.raised = f"{type(e).__name__}: {e}"
            raise
        finally:
            rec.inner, rec.flops = self._frames.pop()
        rec.outs = self._outs(result, in_ptrs)
        rec.bytes = float(sum(_nbytes(t) for t in ts)
                          + sum(_nbytes(t) for t in tensors_of(result)))
        return result


def _propagator():
    """DTensor's ``ShardingPropagator`` class where DTensor is loaded and
    has the tensor-meta hook, else None."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor._sharding_prop")
    cls = getattr(mod, "ShardingPropagator", None)
    if cls is None or not hasattr(cls, "_propagate_tensor_meta_non_cached"):
        return None
    return cls


@contextlib.contextmanager
def quiet_propagation(rec: "Recorder"):
    """Pause ``rec`` while DTensor infers an op's output metadata by
    running it on fake tensors of its own (uncached calls only), so
    those ops are not counted as the program's."""
    cls = _propagator()
    if cls is None:
        yield
        return
    orig = cls._propagate_tensor_meta_non_cached

    def paused(self, *a, **k):
        rec.paused += 1
        try:
            return orig(self, *a, **k)
        finally:
            rec.paused -= 1

    cls._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        cls._propagate_tensor_meta_non_cached = orig


def can_quiet_propagation() -> bool:
    """Whether :func:`quiet_propagation` has its hook (else warm up)."""
    import torch.distributed.tensor._sharding_prop  # noqa: F401
    return _propagator() is not None


def record(fn, args, device=None, warmup: bool = False,
           fake: bool = False, max_records: Optional[int] = None) -> Trace:
    """Run ``fn(*args)`` once under a :class:`Recorder`; the trace keeps the
    call's exception instead of raising it (a refused launch is a finding,
    not a crash of the analyzer).  ``warmup`` runs it once before,
    unrecorded (module doc; the call must leave its arguments fit for a
    second run); ``fake`` says the call runs on fake tensors;
    ``max_records`` stops the call (``TraceBudgetExceeded``, kept in the
    trace) past that many records."""
    if device is None:
        ts = tensors_of(args)
        device = ts[0].device if ts else torch.device("cpu")
    device = torch.device(device)
    if warmup:
        fn(*args)
    rec = Recorder(device, fake, max_records)
    prev, kops.recorder = kops.recorder, rec
    raised, outputs, arg_sids = None, (), frozenset()
    try:
        with quiet_propagation(rec), rec:
            arg_sids = frozenset(rec.sid_of(t) for t in _locals_of(args))
            result = fn(*args)
            outputs = tuple(rec.sid_of(t) for t in _locals_of(result))
    except Exception as e:  # noqa: BLE001 - kept in the trace, see above
        raised = f"{type(e).__name__}: {e}"
    finally:
        kops.recorder = prev
        for f in rec._finalizers:  # what dies after the call is not ours
            f.detach()
    return Trace(rec.records, dict(rec.roots), outputs, device.type,
                 rec.n_sms, rec.smem_optin, raised, dict(rec.died), arg_sids)


# ------------------------------------------------------------- helpers --
def iter_ops(trace: Trace, kind: Optional[str] = None) -> Iterator[Record]:
    """The trace's records in program order (only ``kind``'s if given)."""
    for r in trace.records:
        if kind is None or r.kind == kind:
            yield r


def record_bytes(out: Out) -> int:
    """Bytes of one output's values (its shape times its element size)."""
    n = 1
    for d in out.shape:
        n *= d
    return n * getattr(torch, out.dtype).itemsize


def square_dim_findings(trace: Trace, S: int, limit: int = 2,
                        allow=()) -> List[dict]:
    """Every output (of an op or a kernel) holding >= ``limit`` dims of size
    >= ``S``: the offending ``{op, shape, dtype}`` records."""
    out = []
    for r in iter_ops(trace):
        if r.name in allow:
            continue
        for o in r.outs:
            if sum(1 for d in o.shape if d >= S) >= limit:
                out.append(dict(op=r.name, shape=list(o.shape),
                                dtype=o.dtype, kind=r.kind))
    return out


def max_square_dims(trace: Trace, S: int) -> int:
    """Largest count of >= S dims on any output of the trace: a forward
    that never holds two >= S dims on one tensor cannot have materialized
    the [S, S] score matrix."""
    return max((sum(1 for d in o.shape if d >= S)
                for r in iter_ops(trace) for o in r.outs), default=0)


def constant_records(trace: Trace) -> List[dict]:
    """Tensors the call built from host data (``torch.tensor`` /
    ``as_tensor`` of an array or a Python value): ``{shape, dtype,
    bytes}`` each, the counterpart of a jaxpr's baked-in constants."""
    return [dict(op=r.name, shape=list(o.shape), dtype=o.dtype,
                 bytes=record_bytes(o))
            for r in iter_ops(trace, "op") if r.name in LIFT_OPS
            for o in r.outs]


def kernel_block_records(trace: Trace) -> List[dict]:
    """Per kernel record and launch: the kernel's name, its shared bytes a
    block (static + dynamic, ``kernels/plans.py``), grid and threads, and
    whether the wrapper raised."""
    return [dict(name=r.name, kernel=l.kernel, grid=list(l.grid),
                 threads=l.threads, block_bytes=l.shared_bytes,
                 raised=r.raised)
            for r in iter_ops(trace, "kernel") for l in r.launches]


def liveness(trace: Trace, device: Optional[str] = None,
             deaths: bool = True, args_only: bool = False) -> dict:
    """Straight-line liveness estimate of one call (``repro.analysis.walk
    .liveness_peak_bytes``, for eager PyTorch): values from outside the
    call (roots) live throughout; each record allocates its new outputs,
    and a value is freed after its last use (the last record that reads
    it, or writes it in place) or where its last tensor died, whichever is
    later: eager PyTorch frees no storage a Python name still holds (the
    parameter tree passed to a loss stays until the loss returns), where
    XLA frees a buffer at its last use.  The call's outputs live to the
    end.  Views and in-place results count zero bytes.  Only storages on
    ``device`` (a device type) count when it is given.  ``deaths=False``
    frees every value at its last use alone, as XLA's liveness does: what
    the dry run reports, since when a Python name lets go of a tensor
    differs between fake tensors and real ones.  ``args_only`` counts of
    the values from outside only the call's own arguments, not the
    constants and caches it first meets inside (a cache a library filled
    on an earlier call).

    Returns ``{peak_bytes, input_bytes}``; ``peak_bytes - input_bytes`` is
    what the call adds to what was resident before it, the number to hold
    against ``torch.cuda.max_memory_allocated``'s rise over it."""
    n = len(trace.records)
    dev_of, size, last = {}, {}, {}
    for i, r in enumerate(trace.records):
        for sid in r.ins:
            last[sid] = i
        for o in r.outs:
            last[o.sid] = i
            if o.new_bytes:
                size[o.sid], dev_of[o.sid] = o.new_bytes, o.device
    for sid in trace.outputs:
        last[sid] = n

    def counts(sid):
        return device is None or dev_of.get(sid) == device

    # roots: their device is that of the records reading them; a root no
    # record reads still counts when no device is asked for
    root_dev = {}
    for r in trace.records:
        for sid, d in zip(r.ins, r.in_devices):
            if sid in trace.roots:
                root_dev.setdefault(sid, d)
    roots = {sid: b for sid, b in trace.roots.items()
             if not args_only or sid in trace.args}
    inputs = sum(b for sid, b in roots.items()
                 if device is None or root_dev.get(sid) == device)

    free_at = {}
    for sid, i in last.items():
        if sid in size and counts(sid):
            # died before record j: the last record it was alive for is j-1
            if deaths:
                i = max(i, trace.died.get(sid, n + 1) - 1)
            free_at.setdefault(i, []).append(sid)
    live = peak = inputs
    for i, r in enumerate(trace.records):
        new = sum(o.new_bytes for o in r.outs if counts(o.sid))
        peak = max(peak, live + new)
        live += new
        for sid in free_at.get(i, []):
            live -= size[sid]
    return dict(peak_bytes=peak, input_bytes=inputs)


def cost(trace: Trace) -> dict:
    """``{flops, bytes}`` of the whole call, one device's."""
    return dict(flops=float(sum(r.flops for r in trace.records)),
                bytes=float(sum(r.bytes for r in trace.records)))


def liveness_peak_bytes(trace: Trace) -> int:
    """Peak live bytes of the call, inputs included (:func:`liveness`)."""
    return liveness(trace)["peak_bytes"]


_COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def collective_bytes(trace: Trace) -> dict:
    """``{kind: bytes}`` of the collectives the call dispatched (the
    ``_c10d_functional`` / ``c10d`` ops ``torch.distributed`` issues), by
    their outputs' bytes, with the kinds of
    ``repro.launch.hlo_tools.collective_bytes``."""
    out = {k: 0.0 for k in COLLECTIVE_KINDS}
    for r in iter_ops(trace, "op"):
        ns, _, op = r.name.partition(".")
        if ns not in ("_c10d_functional", "c10d"):
            continue
        for key, kind in _COLLECTIVES:
            if op.startswith(key):
                out[kind] += float(sum(record_bytes(o) for o in r.outs))
    return out
