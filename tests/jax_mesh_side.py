"""The JAX package's side of ``tests/test_torch_tp.py`` and
``tests/test_torch_dryrun.py``, run as a script in a subprocess of its own:
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, and ``moe_sharded`` needs a 2x2 host mesh, so neither may touch
the test process's JAX.

    python tests/jax_mesh_side.py tp <in.pkl> <out.pkl>
    python tests/jax_mesh_side.py ctx <out.json>

``tp``: ``repro.models.moe.moe_sharded`` on a 2x2 (data, model) host mesh
for each capacity factor of the input's MoE layer, and the unsharded
server's two rounds of TINY under each of the input's ``FLConfig``s;
``ctx``: ``make_ctx`` of every ``ASSIGNED`` arch x shape x mesh, field by
field.
"""
import json
import os
import pickle
import sys


def tp(src, dst):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    with open(src, "rb") as f:
        b = pickle.load(f)
    out = moe(b["moe"])
    out["plain"] = [plain(b, fl) for fl in b["fls"]]
    with open(dst, "wb") as f:
        pickle.dump(out, f)


def plain(b, fl):
    """The JAX package's unsharded server: two rounds of 4 clients."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import repro.core as JC
    from repro.configs.base import FLConfig
    from repro.configs.tiny import TINY
    from repro.data.synthetic import TaskSpec, make_task_fns
    from repro.models import Model
    loss, _, _ = make_task_fns(Model(TINY), TaskSpec())
    cs = [JC.Client(k, {n: v[p] for n, v in b["train"].items()}, 4)
          for k, p in enumerate(b["parts4"])]
    srv = JC.FederatedZO(loss, jax.tree.map(jnp.asarray, b["params"]),
                         JC.MaskedSpace(jax.tree.map(jnp.asarray, b["idx"])),
                         FLConfig(**fl), cs)
    for _ in range(2):
        srv.run_round()
    return dict(params=np.concatenate([np.asarray(x, np.float32).ravel()
                                       for x in jax.tree.leaves(srv.params)]),
                ptrs=[c.ptr for c in cs],
                comm=(srv.comm.up_bytes, srv.comm.down_bytes))


def moe(data):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig
    from repro.models.moe import moe_dense_ref, moe_sharded
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         devices=jax.devices()[:4])
    p = {k[2:]: jnp.asarray(v) for k, v in data.items() if k.startswith("p_")}
    x = jnp.asarray(data["x"])
    out = {}
    for i, cf in enumerate(data["cfs"]):
        mcfg = MoEConfig(n_experts=int(data["E"]), top_k=int(data["k"]),
                         d_ff_expert=int(data["F"]),
                         capacity_factor=float(cf))
        # jitted: an eager shard_map compiles op by op (~18 s a call)
        y, aux = jax.jit(lambda xx, pp, m=mcfg: moe_sharded(
            xx, pp, m, "silu", mesh, ("data",), "model"))(x, p)
        out[f"y{i}"] = np.asarray(y)
        out[f"aux{i}"] = np.asarray(aux)
        yd, _ = jax.jit(lambda xx, pp, m=mcfg: moe_dense_ref(
            xx, pp, m, "silu"))(x, p)
        out[f"dense{i}"] = np.asarray(yd)
    return out


def ctx(dst):
    from repro.configs import ASSIGNED, get_shape
    from repro.launch import dryrun
    from repro.launch.mesh import mesh_config
    fields = ("batch_axes", "model_axis", "use_sharded_moe", "attn_q_block",
              "mamba_chunk", "mlstm_block", "seq_shard", "mamba_mode",
              "attn_backend", "decode_backend")
    out = {}
    for name, cfg in ASSIGNED.items():
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            for mp in (False, True):
                c = dryrun.make_ctx(cfg, get_shape(shape), None,
                                    mesh_config(multi_pod=mp))
                out[f"{name}|{shape}|{mp}"] = {
                    f: list(v) if isinstance(v, tuple) else v
                    for f, v in ((f, getattr(c, f)) for f in fields)}
                out[f"{name}|{shape}|{mp}"]["applicable"] = \
                    dryrun.applicable(cfg, get_shape(shape))
    with open(dst, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    {"tp": tp, "ctx": ctx}[sys.argv[1]](*sys.argv[2:])
