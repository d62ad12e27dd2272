"""Helpers of the example tests (``tests/test_torch_examples_*.py``): the
JAX example runs in this process through ``runpy`` with a patched
``sys.argv`` (its globals read back; no JAX file changes), the port's
counterpart from ``examples/*_torch.py`` with ``--device cpu`` and the
JAX example's initial weights."""
import importlib
import os
import runpy
import sys

import numpy as np

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")

# The slice's tolerances (tests/test_torch_slice.py): a ZO scalar moves by a
# few 1e-4 (one f32 ulp of the loss over 2 eps), parameters by lr times that
# per step, GradIP by the scalar's error times |<gp, z>|.
G_ATOL = 5e-4
PARAM_ATOL = 1e-4
GRADIP_ATOL = 2e-4
GRADIP_RTOL = 1e-3
# an evaluation of 512 examples: one example's answer
ACC_ATOL = 1 / 512
MASK_OVERLAP_MIN = 0.999


def port_example(name: str):
    """``examples/<name>_torch.py`` as a module (by name, from a path
    entry, so spawned ranks can unpickle its functions)."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(f"{name}_torch")


def run_port(name: str, argv, **kw) -> dict:
    mod = port_example(name)
    return mod.run(mod.parser().parse_args(list(argv) + ["--device", "cpu"]),
                   **kw)


def run_jax(monkeypatch, name: str, argv) -> dict:
    """Run ``examples/<name>.py`` as ``__main__`` with ``argv``; its
    globals."""
    path = os.path.join(EXAMPLES, f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path] + list(argv))
    return runpy.run_path(path, run_name="__main__")


def global_idx(idx_leaves, param_leaves) -> np.ndarray:
    """A mask's coordinates in the flat parameter vector."""
    off = np.cumsum([0] + [int(np.prod(p.shape)) for p in param_leaves])
    return np.concatenate([np.asarray(i, np.int64) + o
                           for i, o in zip(idx_leaves, off[:-1])])


def flat(leaves) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])


def mask_overlap(jspace, jparams, tspace, tparams) -> float:
    import jax
    from repro_torch.utils.tree import tree_leaves
    j = global_idx(jax.tree_util.tree_leaves(jspace.idx_tree),
                   jax.tree_util.tree_leaves(jparams))
    t = global_idx([x.cpu().numpy() for x in tree_leaves(tspace.idx_tree)],
                   tree_leaves(tparams))
    return len(np.intersect1d(j, t)) / len(j)
