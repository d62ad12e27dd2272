"""Kill-and-recover drill for the PyTorch port's federated training CLI
(``repro_torch.launch.train``), the counterpart of ``tools/kill_recover.py``.

Three subprocess runs of ``python -m repro_torch.launch.train`` on the same
problem, checkpointing every round:

* **A** (reference): uninterrupted.
* **B** (victim): the same flags plus ``--kill-at-round k``: the server
  SIGKILLs itself mid-round k (client compute done, update not applied).
  It must die by SIGKILL, leave ``ckpt_latest.msgpack`` at round k and no
  final checkpoint.
* **C** (recovery): ``--resume`` from B's directory, to the same
  ``--rounds``.

C's final checkpoint must then equal A's bit for bit, read through
``repro_torch.checkpoint``: every leaf, the round counter, the CommLog
byte totals, the clients' data pointers, the VPCS flags, the eval history,
the straggler queue and the sampler state; and the two files byte for
byte.  ``--sample-frac``/``--quantize`` run the drill under client
sampling and a quantized uplink (the survivor re-draws the killed round's
cohort from the restored sampler state).

The flags are ``tools/kill_recover.py``'s plus ``--device`` (the CUDA card
unless ``--device cpu``).  ``--mesh-a/-b/-c`` run that run on a mesh
(``--mesh``: one process a rank, gloo ranks with ``--device cpu``, one
card a rank otherwise; a mesh of more ranks than cards raises, as the
train CLI does).  Unlike the JAX drill, no ZO backend is pinned: the
port's mesh routes run the flat kernels as the unsharded run does, and
write its checkpoints byte for byte.

    PYTHONPATH=src python tools/kill_recover_torch.py --device cpu \\
        --rounds 4 --kill-at 2
    python tools/kill_recover_torch.py --rounds 4 --kill-at 2 \\
        --sample-frac 0.5 --quantize int8          # on the card

Exit code 0 iff every check passes; ``--json PATH`` writes the report.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import load_manifest  # noqa: E402
from repro_torch.checkpoint.state import FINAL_NAME, LATEST_NAME  # noqa: E402

META_FIELDS = ("round", "up_bytes", "down_bytes", "ptrs", "early_stopped",
               "history", "pending", "sampler")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--method", default="random",
                    help="space method (random is fast; see launch/train.py)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--kill-at", type=int, default=2,
                    help="round the victim run SIGKILLs itself in")
    ap.add_argument("--T", type=int, default=2)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=2)
    ap.add_argument("--sample-frac", type=float, default=1.0,
                    help="run the drill under client sampling (the survivor "
                         "must restore the sampler state to re-draw the "
                         "killed round's cohort)")
    ap.add_argument("--quantize", default="none",
                    help="run the drill under a quantized uplink codec "
                         "(none|int8|int4[-nearest])")
    ap.add_argument("--mesh-a", default=None, help="mesh for the reference")
    ap.add_argument("--mesh-b", default=None,
                    help="mesh for the killed run (e.g. 1x2: die sharded, "
                         "recover unsharded)")
    ap.add_argument("--mesh-c", default=None, help="mesh for the recovery")
    ap.add_argument("--workdir", default=None,
                    help="keep checkpoints here (default: a temporary "
                         "directory, removed after)")
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--device", default=None,
                    help="torch device of the runs (default: the CUDA card)")
    return ap


def train_cmd(a, ckpt_dir: str, *, mesh=None, kill_at=None, resume=False,
              extra=()) -> list:
    """The train CLI's command line for one run of the drill; ``extra``
    flags go after the drill's own (a fault plan, say)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", a.arch, "--method", a.method,
           "--rounds", str(a.rounds), "--T", str(a.T),
           "--clients", str(a.clients), "--batch", str(a.batch),
           "--seed", str(a.seed), "--eval-every", str(a.eval_every),
           "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "1"]
    if a.device is not None:
        cmd += ["--device", a.device]
    if a.sample_frac < 1.0:
        cmd += ["--sample-frac", str(a.sample_frac)]
    if a.quantize != "none":
        cmd += ["--quantize", a.quantize]
    if mesh:
        cmd += ["--mesh", mesh]
    if kill_at is not None:
        cmd += ["--kill-at-round", str(kill_at)]
    if resume:
        cmd += ["--resume"]
    return cmd + list(extra)


def run(cmd, label: str, timeout: float = 1800) -> subprocess.CompletedProcess:
    """One run from the repo's root with ``src`` on the path; its output
    is captured, and its last lines printed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    print(f"[{label}] {' '.join(cmd)}", flush=True)
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    tail = "\n".join(p.stdout.strip().splitlines()[-3:])
    print(f"[{label}] rc={p.returncode}\n{tail}", flush=True)
    if p.returncode not in (0, -signal.SIGKILL):
        print(p.stderr[-2000:], file=sys.stderr, flush=True)
    return p


def compare_finals(path_a: str, path_c: str) -> dict:
    """Bit-compare two server checkpoints: every leaf, the replay's meta
    and the files' bytes."""
    meta_a, leaves_a = load_manifest(path_a)
    meta_c, leaves_c = load_manifest(path_c)
    checks = {"leaf_sets_equal": set(leaves_a) == set(leaves_c)}
    diff = [k for k in leaves_a
            if k in leaves_c and not (
                leaves_a[k].dtype == leaves_c[k].dtype
                and leaves_a[k].shape == leaves_c[k].shape
                and torch.equal(leaves_a[k].reshape(-1).view(torch.uint8),
                                leaves_c[k].reshape(-1).view(torch.uint8)))]
    checks["leaves_bitmatch"] = checks["leaf_sets_equal"] and not diff
    for field in META_FIELDS:
        checks[f"meta_{field}_equal"] = meta_a.get(field) == meta_c.get(field)
    with open(path_a, "rb") as fa, open(path_c, "rb") as fc:
        checks["files_bytes_equal"] = fa.read() == fc.read()
    if diff:
        checks["first_diff_leaf"] = diff[0]
    return checks


def drill(a, work: str, extra=(), timeout: float = 1800) -> dict:
    """The three runs under ``work`` (``ref/`` and ``victim/``) and their
    checks, {name: bool} (and ``first_diff_leaf`` where leaves differ)."""
    dir_a, dir_b = os.path.join(work, "ref"), os.path.join(work, "victim")
    os.makedirs(dir_a, exist_ok=True)
    os.makedirs(dir_b, exist_ok=True)
    pa = run(train_cmd(a, dir_a, mesh=a.mesh_a, extra=extra), "A:ref",
             timeout)
    pb = run(train_cmd(a, dir_b, mesh=a.mesh_b, kill_at=a.kill_at,
                       extra=extra), "B:victim", timeout)
    checks = {"ref_completed": pa.returncode == 0,
              "victim_sigkilled": pb.returncode == -signal.SIGKILL}
    latest = os.path.join(dir_b, LATEST_NAME)
    checks["victim_left_latest"] = os.path.exists(latest)
    checks["victim_left_no_final"] = not os.path.exists(
        os.path.join(dir_b, FINAL_NAME))
    if checks["victim_left_latest"]:
        # a checkpoint every round: the kill fires mid-round k, after round
        # k - 1's snapshot, so the last completed round is k
        checks["latest_at_kill_round"] = \
            load_manifest(latest)[0]["round"] == a.kill_at
    pc = run(train_cmd(a, dir_b, mesh=a.mesh_c, resume=True, extra=extra),
             "C:recover", timeout)
    checks["recovery_completed"] = pc.returncode == 0
    checks["resumed_from_kill_round"] = \
        f"resumed from {latest} at round {a.kill_at}" in pc.stdout
    if checks["ref_completed"] and checks["recovery_completed"]:
        checks.update(compare_finals(os.path.join(dir_a, FINAL_NAME),
                                     os.path.join(dir_b, FINAL_NAME)))
    return checks


def passed(checks: dict) -> bool:
    return all(v for k, v in checks.items() if k != "first_diff_leaf")


def main(argv=None) -> int:
    ap = parser()
    a = ap.parse_args(argv)
    if not 0 < a.kill_at < a.rounds:
        ap.error("--kill-at must be inside (0, --rounds)")
    work = a.workdir or tempfile.mkdtemp(prefix="kill_recover_torch_")
    report = {"args": vars(a), "checks": {}, "ok": False}
    try:
        report["checks"] = checks = drill(a, work)
        report["ok"] = passed(checks)
        for k, v in checks.items():
            print(f"  {k}: {v}")
        print("kill_recover_torch:", "ok" if report["ok"] else "FAIL",
              flush=True)
    finally:
        if a.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
    if a.json:
        os.makedirs(os.path.dirname(a.json) or ".", exist_ok=True)
        with open(a.json, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", a.json)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
