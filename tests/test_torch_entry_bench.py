"""The port's headline bench twin (``nova_tpu_torch/bench.py``), the device
selection of its entry points (``nova_tpu_torch/_env.py``), the
no-rebuild contract that stands for ``nova_tpu/ops/aot.py`` (the hashed
build directories of ``_build.py`` and ``native/``), and the ptau example
twins, against the JAX package's scripts on the CPU.

No card here: the bench's stages run only in the no-card case (a
subprocess); tests/test_torch_entry_msm.py runs bench_msm on the CPU, and
bench_fold_and_compress runs here beside bench.py's.
Tolerance: exact (MSM results as affine points, JSON keys, digests, proof
and file bytes)."""

import json
import os
import random
import secrets
import subprocess
import sys
import time

import pytest
import torch

from nova_tpu import checkpoint as jcheckpoint
from nova_tpu.provider import ptau as jptau

from nova_tpu_torch import _build, _env, bench, checkpoint, native
from nova_tpu_torch.nova.compressed import CompressedSNARK
from nova_tpu_torch.nova.ivc import PublicParams
from nova_tpu_torch.examples import ppot_prune, ptau_test_setup
from nova_tpu_torch.provider import ptau

from tests.test_torch_entry_examples import (  # noqa: F401
    ROOT, SEED, checked_keys, jax_keys, jax_spies, load_script, seeded)

torch.set_num_threads(1)


def _jax_line(capfd, state):
    """The JAX bench.py's JSON line for a best-so-far state."""
    jbench = load_script("bench.py", "jax_bench_main")
    jbench._state.update(state)
    capfd.readouterr()
    jbench._emit()
    return json.loads(capfd.readouterr().out)


def test_line_shape_matches_bench_py(capfd):
    """The line's keys, metric and unit equal bench.py's, with a headline
    and every extra the card stages add (the JAX line's backend names its
    TPU engine, the twin's its CUDA one), and without one."""
    run = bench._Run()
    run.value, run.backend = 1.5e6, "cuda (msm3m)"
    run.extra = {"msm_pipelined_pts_per_s": 2.5e6, "host_pts_per_s": 4e5,
                 "fold_step_ms": 80.0, "compressed_snark_prove_s": 4.5}
    line = run.line()
    ref = _jax_line(capfd, {"value": 1.5e6, "backend": "tpu (msm3m)", "extra": {
        "msm_pipelined_pts_per_s": 2.5e6, "fold_step_ms": 80.0,
        "compressed_snark_prove_s": 4.5}})
    assert set(line) == set(ref) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert {k: line[k] for k in ("metric", "value", "unit", "vs_baseline")} == \
        {k: ref[k] for k in ("metric", "value", "unit", "vs_baseline")}
    assert set(ref["extra"]) <= set(line["extra"])
    assert line["extra"]["backend"] == "cuda (msm3m)"
    empty = bench._Run().line()
    ref = _jax_line(capfd, {"value": None, "backend": None, "extra": {}})
    assert set(empty) == set(ref) and set(empty["extra"]) == set(ref["extra"])
    assert (empty["value"], empty["vs_baseline"]) == (0.0, 0.0)


def test_fold_and_compress_matches_bench_py(jax_keys, jax_spies, monkeypatch):  # noqa: F811
    """bench_fold_and_compress on the CPU beside bench.py's, one seeded
    randomness for each: equal PublicParams digests and compressed-proof
    bytes of the trivial circuit's fourth step (both verify inside), and
    positive timings."""
    jbench = load_script("bench.py", "jax_bench_fold")
    seeded(monkeypatch, SEED)
    jbench.bench_fold_and_compress()
    seen = {}
    for owner, name in ((PublicParams, "setup"), (CompressedSNARK, "prove")):
        def spy(*a, _real=getattr(owner, name), _name=name, **k):
            seen[_name] = _real(*a, **k)
            return seen[_name]

        monkeypatch.setattr(owner, name, staticmethod(spy))
    seeded(monkeypatch, SEED)
    fold_ms, compress_s = bench.bench_fold_and_compress("cpu")
    assert fold_ms > 0 and compress_s > 0
    assert seen["setup"].digest() == jax_spies["setup"][0].digest()
    assert checkpoint.proof_to_bytes(seen["prove"]) == jcheckpoint.proof_to_bytes(
        jax_spies["prove"][0])


def test_bench_without_card_exits_nonzero():
    """`python -m nova_tpu_torch.bench` with no card: value 0.0 and an error
    naming the probe's timeout, a non-zero exit, and no fallback stage."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 16 runs the bench on it")
    env = {**os.environ, "NOVA_DEVICE_PROBE_TIMEOUT": "5"}
    res = subprocess.run([sys.executable, "-m", "nova_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert (line["value"], line["vs_baseline"]) == (0.0, 0.0)
    assert "within 5 s" in line["extra"]["error"]
    assert line["extra"]["backend"] == "none"
    for path in ("nova_tpu_torch/bench.py", "nova_tpu_torch/_env.py"):
        with open(os.path.join(ROOT, path)) as fh:
            src = fh.read()
        assert "host-fallback" not in src and "cpu-fallback" not in src
    assert "fallback" not in res.stdout


def test_env_probe_is_cached_and_raises(monkeypatch):
    """The probe answers False here within NOVA_DEVICE_PROBE_TIMEOUT and is
    not run again; selecting the card raises with the timeout in the
    message; device="cpu" gives the CPU without a probe."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe answers True")
    monkeypatch.setattr(_env, "_probe_result", None)
    monkeypatch.setenv("NOVA_DEVICE_PROBE_TIMEOUT", "5")
    assert _env.accelerator_available() is False

    def no_second_probe(*a, **k):
        raise AssertionError("probed twice")

    monkeypatch.setattr(subprocess, "run", no_second_probe)
    assert _env.accelerator_available() is False
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="within 5 s"):
            _env.entry_device(dev)
    assert _env.entry_device("cpu") == torch.device("cpu")
    assert _env.entry_device(torch.device("cpu")) == torch.device("cpu")


def test_env_no_probe_once_cuda_is_initialized(monkeypatch):
    """A process that holds a CUDA context already answers True without a
    probe subprocess, and keeps the answer."""
    monkeypatch.setattr(_env, "_probe_result", None)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)

    def no_probe(*a, **k):
        raise AssertionError("probed")

    monkeypatch.setattr(subprocess, "run", no_probe)
    assert _env.accelerator_available() is True
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert _env.accelerator_available() is True


def test_device_name_needs_no_torch():
    """The bench's watchdog selects its device by name without importing
    torch (its stage processes import it)."""
    code = ("import sys\n"
            "from nova_tpu_torch import _env, bench\n"
            "assert _env.device_name('cpu') == 'cpu'\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_env_probe_timeout(monkeypatch):
    """A probe that does not answer in time counts as no card."""
    monkeypatch.setattr(_env, "_probe_result", None)

    def hang(*a, timeout=None, **k):
        raise subprocess.TimeoutExpired(a[0], timeout)

    monkeypatch.setattr(subprocess, "run", hang)
    assert _env.accelerator_available(timeout_s=0.1) is False


def test_native_binding_not_rebuilt_by_a_second_process(tmp_path):
    """The aot contract on the native binding: a first process compiles
    native-<digest>/ with g++, a second process loads it without invoking
    g++ (the pattern of tests/test_aot.py)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import subprocess\n"
        "from nova_tpu_torch import native\n"
        "native.BUILD_ROOT = %r\n"
        "calls = []\n"
        "real = subprocess.run\n"
        "def counting(cmd, *a, **k):\n"
        "    calls.append(cmd[0])\n"
        "    return real(cmd, *a, **k)\n"
        "subprocess.run = counting\n"
        "assert native.available()\n"
        "print('GXX', calls.count('g++'), native._build())\n"
    ) % (ROOT, str(tmp_path))
    runs = []
    for _ in range(2):
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
        runs.append(res.stdout.split("GXX ")[1].split())
    assert [r[0] for r in runs] == ["1", "0"]
    assert runs[0][1] == runs[1][1] == os.path.join(
        str(tmp_path), f"native-{native._digest()}", native.LIB_NAME)


def test_kernel_library_not_rebuilt(tmp_path, monkeypatch):
    """The aot contract on the CUDA kernels: with <digest>/ built, build()
    returns its library without calling nvcc (built False); without it,
    build() goes to nvcc."""

    def no_nvcc():
        raise RuntimeError("nvcc invoked")

    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "build_info", {})
    with pytest.raises(RuntimeError, match="nvcc invoked"):
        _build.build()
    so = tmp_path / _build._digest() / _build.LIB_NAME
    so.parent.mkdir()
    so.write_bytes(b"")
    assert _build.build() == str(so)
    assert _build.build_info["built"] is False


def test_ppot_prune_matches_reference(tmp_path, monkeypatch):
    """A power-4 test ptau file pruned to power 3, with no card: it passes
    check_sanity_of_ptau_file and equals the JAX package's prune byte for
    byte."""
    src = tmp_path / "src.ptau"
    ptau.write_test_ptau(str(src), 1234567, 4)
    # a host tool: it runs with no card and asks for none
    monkeypatch.setattr(_env, "_probe_result", False)
    dst = ppot_prune.main([str(src), "3", str(tmp_path)])
    assert os.path.basename(dst) == "ppot_pruned_03.ptau"
    ptau.check_sanity_of_ptau_file(dst, 1 << 3, 2)
    jptau.prune_ptau(str(src), str(tmp_path / "j.ptau"), 3)
    assert (tmp_path / "j.ptau").read_bytes() == open(dst, "rb").read()


def test_ptau_test_setup_matches_reference(tmp_path, monkeypatch):
    """Power 4 with one seeded tau in both packages, with no card: equal
    file bytes."""
    monkeypatch.setattr(_env, "_probe_result", False)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jmod = load_script("examples/ptau_test_setup.py", "jax_ptau_test_setup")
    for run in (lambda: jmod.main(),
                lambda: ptau_test_setup.main(["4", str(tdir)])):
        rnd = random.Random(4)
        monkeypatch.setattr(secrets, "randbelow", lambda n, _r=rnd: _r.randrange(n))
        monkeypatch.setattr(sys, "argv", ["ptau_test_setup.py", "4", str(jdir)])
        run()
    name = "ppot_pruned_04.ptau"
    assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    ptau.check_sanity_of_ptau_file(str(tdir / name), 1 << 4, 2)


def test_stage_timeout_stops_its_process_group(tmp_path):
    """A stage that outlives its slice is killed with what it started (a
    grandchild here), and the line records the timeout."""
    pidfile = tmp_path / "pid"
    code = ("import subprocess, sys, time\n"
            "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'])\n"
            f"open({str(pidfile)!r}, 'w').write(str(p.pid))\n"
            "time.sleep(120)\n")
    run = bench._Run()
    assert run.stage(code, 6, "slow") is None
    assert run.extra["slow_error"] == "timed out after 6 s"
    pid = int(pidfile.read_text())
    for _ in range(50):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        pytest.fail(f"the stage's child {pid} outlived the stage")
