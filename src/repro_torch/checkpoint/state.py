"""Versioned snapshot/restore of the full ``FederatedZO`` server state
(``repro.checkpoint.state``; the files are byte for byte the JAX
package's, so a snapshot written by either package restores in the other).

The state inventory (everything a bit-exact resume needs): parameters,
FedAvgM velocity, the round counter, ``CommLog`` byte counters, per-client
GradIP trajectories *including explicit gaps*, VPCS early-stop flags,
per-client data pointers, the straggler pending-upload queue, the eval
history, and a config fingerprint.  All round randomness derives from
``(fl.seed, round, T)`` through the seed ladder (``core/seeds.round_keys``),
the quantizer's rounding noise included, so the only RNG state stored is the
**client sampler's** (state_version 2): restoring its bit-generator state
makes a resumed server re-draw the killed round's cohort identically.

:func:`server_state_sizes` accounts the snapshot's bytes, split into the
model-sized part (params, velocity) and the per-client scalar part
(pointers, GradIP scalars, pending uploads, sampler state): the server
state never grows as K x model.

Parameters are written from wherever they live, leaf by leaf; a server on
a mesh (``plan=``) writes its gathered parameters, from rank 0 alone, so
the file is the unsharded server's byte for byte.  They restore onto the
target server's device with each leaf's dtype and are placed per the
*target* server's plan: a checkpoint moves between meshes and the
unsharded server.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.checkpoint.io import (CheckpointError, load_manifest,
                                       save_pytree)
from repro_torch.utils.tree import (tree_flatten_with_keys, tree_leaves,
                                    tree_unflatten)

STATE_VERSION = 2  # v2: + sampler state & fleet config fields

# conventional file names inside a --checkpoint-dir
LATEST_NAME = "ckpt_latest.msgpack"
FINAL_NAME = "ckpt_final.msgpack"

# config fields that must match between checkpoint and restore target:
# they determine the seed ladder, the client loops and the protocol
# accounting, so a mismatch silently breaks bit-exact replay.
_CONFIG_FIELDS = ("seed", "local_steps", "n_dirs", "lr", "eps",
                  "server_momentum", "sample_frac", "sample_weighted",
                  "quantize")


def _keystr(*parts) -> str:
    return "".join(f"['{p}']" for p in parts)


def _config_fingerprint(server) -> dict:
    fl = server.fl
    cfg = {f: getattr(fl, f, None) for f in _CONFIG_FIELDS}
    cfg["n_clients"] = len(server.clients)
    cfg["space_n"] = int(server.space.n)
    cfg["high_freq"] = bool(server.high_freq)
    # effective codec/sampler (catches constructor overrides that the
    # FLConfig fields above would miss)
    cfg["codec"] = getattr(server.codec, "spec", "none")
    cfg["sampler_m"] = (None if server.sampler is None
                        else int(server.sampler.m))
    return cfg


def _is_writer(server) -> bool:
    """Rank 0 of a mesh server's group writes; an unsharded server writes."""
    return server.plan is None or torch.distributed.get_rank() == 0


def save_server_state(path: str, server, extra_meta: dict | None = None
                      ) -> str:
    """Write a full server snapshot to ``path`` (atomic; io.py format).
    Every rank of a mesh server calls it (the gather is a collective);
    rank 0 writes, and every rank returns once the file is there."""
    tree = {"params": server.full_params()}
    if server.velocity is not None:
        tree["velocity"] = server.velocity
    gradip, gradip_len = {}, {}
    for cid, entries in server.gradip_log.items():
        gradip_len[str(cid)] = len(entries)
        present = {str(i): np.asarray(e) for i, e in enumerate(entries)
                   if e is not None}
        if present:
            gradip[str(cid)] = present
    if gradip:
        tree["gradip"] = gradip
    pending_meta, pending_gs = [], {}
    for j, ent in enumerate(server._pending):
        pending_meta.append({k: int(ent[k]) for k in
                             ("arrive", "cid", "src_round", "gip_idx")})
        pending_gs[str(j)] = np.asarray(ent["gs"])
    if pending_gs:
        tree["pending"] = pending_gs
    meta = {
        "state_version": STATE_VERSION,
        "round": int(server.round),
        "up_bytes": int(server.comm.up_bytes),
        "down_bytes": int(server.comm.down_bytes),
        "ptrs": {str(c.cid): int(c.ptr) for c in server.clients},
        "early_stopped": sorted(int(c) for c in server.early_stopped),
        "has_velocity": server.velocity is not None,
        "gradip_len": gradip_len,
        "pending": pending_meta,
        "history": server.history,
        "config": _config_fingerprint(server),
        # fleet-scale sampler: full bit-generator state, so a resumed
        # server re-draws the killed round's cohort identically
        "sampler": (None if server.sampler is None
                    else server.sampler.state_dict()),
    }
    if extra_meta:
        meta["extra"] = extra_meta
    if _is_writer(server):
        save_pytree(path, tree, metadata=meta)
    if server.plan is not None:
        torch.distributed.barrier()
    return path


def _check_config(meta: dict, server, path: str):
    saved = meta.get("config", {})
    here = _config_fingerprint(server)
    diffs = {k: (saved.get(k), here[k]) for k in here
             if saved.get(k) != here[k]}
    if diffs:
        raise CheckpointError(
            f"{path!r}: checkpoint/server config mismatch "
            f"(field: saved vs here): {diffs}")


def restore_server_state(path: str, server) -> dict:
    """Restore a snapshot written by :func:`save_server_state` (by either
    package, from any mesh) into ``server``, its parameters placed per
    ``server.plan``.  Returns the checkpoint meta dict."""
    meta, leaves = load_manifest(path)
    if meta.get("state_version") != STATE_VERSION:
        raise CheckpointError(
            f"{path!r}: server-state version "
            f"{meta.get('state_version')!r} != supported {STATE_VERSION}")
    _check_config(meta, server, path)

    # -- params: template-checked against the live tree (a mesh server's
    # leaves give their global shapes), onto the server's device with each
    # live leaf's dtype, then placed per the target plan ------------------
    flat, treedef = tree_flatten_with_keys(server.params, "['params']")
    out = []
    for key, tleaf in flat:
        if key not in leaves:
            raise CheckpointError(f"{path!r}: missing param leaf {key!r}")
        arr = leaves.pop(key)
        if tuple(arr.shape) != tuple(tleaf.shape):
            raise CheckpointError(
                f"{path!r}: shape mismatch at {key!r}: "
                f"{tuple(arr.shape)} vs {tuple(tleaf.shape)}")
        out.append(arr.to(device=server.device, dtype=tleaf.dtype))
        del arr
    server.params = tree_unflatten(treedef, out)
    if server.plan is not None:
        server.params = server.plan.place_params(server.params)

    server.velocity = (leaves[_keystr("velocity")].to(server.device)
                       if meta.get("has_velocity") else None)

    # -- scalar state ----------------------------------------------------
    server.round = int(meta["round"])
    server.comm.up_bytes = int(meta["up_bytes"])
    server.comm.down_bytes = int(meta["down_bytes"])
    server.early_stopped = set(int(c) for c in meta["early_stopped"])
    server.history = list(meta.get("history", []))

    samp = meta.get("sampler")
    if (samp is None) != (server.sampler is None):
        raise CheckpointError(
            f"{path!r}: sampler mismatch: checkpoint "
            f"{'has' if samp is not None else 'lacks'} sampler state but "
            f"the target server "
            f"{'lacks' if server.sampler is None else 'has'} a sampler")
    if samp is not None:
        server.sampler.load_state(samp)

    ptrs = meta["ptrs"]
    have = {str(c.cid) for c in server.clients}
    if set(ptrs) != have:
        raise CheckpointError(
            f"{path!r}: client id mismatch: checkpoint {sorted(ptrs)} "
            f"vs server {sorted(have)}")
    for c in server.clients:
        c.ptr = int(ptrs[str(c.cid)])

    # -- GradIP trajectories with explicit gaps (host arrays) -----------
    gradip_len = meta.get("gradip_len", {})
    log = {}
    for c in server.clients:
        n = int(gradip_len.get(str(c.cid), 0))
        entries = [leaves.get(_keystr("gradip", str(c.cid), str(i)))
                   for i in range(n)]
        log[c.cid] = [None if e is None else e.numpy() for e in entries]
    server.gradip_log = log

    # -- straggler pending-upload queue -----------------------------------
    pending = []
    for j, ent in enumerate(meta.get("pending", [])):
        key = _keystr("pending", str(j))
        if key not in leaves:
            raise CheckpointError(f"{path!r}: missing pending leaf {key!r}")
        pending.append(dict(arrive=int(ent["arrive"]), cid=int(ent["cid"]),
                            src_round=int(ent["src_round"]),
                            gip_idx=int(ent["gip_idx"]),
                            gs=leaves[key].numpy()))
    server._pending = pending
    return meta


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def server_state_sizes(server) -> dict:
    """Byte accounting of the checkpointed server state, split into the
    **model-sized** part (params + optional velocity, independent of the
    fleet size K) and the **per-client scalar** part (data pointers,
    GradIP scalars, pending uploads, sampler state): a few scalars per
    client, never K x model."""
    params_b = sum(_nbytes(x) for x in tree_leaves(server.params))
    vel_b = 0 if server.velocity is None else _nbytes(server.velocity)
    gradip_b = sum(_nbytes(e) for entries in server.gradip_log.values()
                   for e in entries if e is not None)
    pending_b = sum(_nbytes(p["gs"]) for p in server._pending)
    ptr_b = 8 * len(server.clients)
    sampler_b = (0 if server.sampler is None
                 else len(json.dumps(server.sampler.state_dict())))
    return dict(
        n_clients=len(server.clients),
        params_bytes=int(params_b),
        velocity_bytes=int(vel_b),
        model_state_bytes=int(params_b + vel_b),
        gradip_bytes=int(gradip_b),
        pending_bytes=int(pending_b),
        ptr_bytes=int(ptr_b),
        sampler_bytes=int(sampler_b),
        per_client_state_bytes=int(gradip_b + pending_b + ptr_b
                                   + sampler_b),
    )
