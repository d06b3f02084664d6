"""The import guard: what the benchmark's command loads holds neither JAX
nor the JAX package, and the reference loads nothing of the program either.
Top-level names are compared whole: nova_tpu_torch is not nova_tpu."""

import json
import os
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

JAX = {"jax", "jaxlib", "flax", "nova_tpu"}

_RUN = r"""
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
import torch
torch.set_num_threads(1)
import run
from benchlib import spec
bench = json.load(open({root!r} + "/BENCHMARK.json"))
for w in bench["workloads"]:
    spec.cell(w["name"], bench)
c = spec.cell("pallas-ipa.fold-2e17", bench)
c.traffic.update(circuit_args={{"pad_log_cons": 14}}, warm_steps=3)
res = run.run_cell(c, 2**31 + 99, 0.5, True, torch.device("cpu"))
import benchlib.faults, control
print(json.dumps({{"correct": res["correct"],
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

_REF = r"""
import json, sys
sys.path[:0] = [{bench!r}]
import pbref.checks, pbref.curves, pbref.h2c, pbref.msm, pbref.r1cs, pbref.steps
import glob, os
for f in sorted(glob.glob({bench!r} + "/pbref/steps/*.py")):
    if not f.endswith("__init__.py"):
        pbref.steps.load(os.path.basename(f)[:-3])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT, bench=BENCH_DIR)],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_benchmark_run_loads_no_jax():
    res = _run(_RUN)
    assert res["correct"] is True
    assert not JAX & set(res["top"]), JAX & set(res["top"])
    assert "nova_tpu_torch" in res["top"]


def test_reference_loads_nothing_of_either_package():
    top = set(_run(_REF))
    assert not (JAX | {"nova_tpu_torch", "torch"}) & top


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"),
                          "--workload", "pallas-ipa.commit-2e20", "--seed", str(2**33 + 5),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
