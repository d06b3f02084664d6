"""A later change adds a configuration, a traffic mix, a kind of traffic, a
step circuit and a per-layer metric by adding files and entries, without
editing a file that exists."""

import hashlib
import json
import os
import shutil

from conftest import BENCH_DIR, ROOT

from benchlib import spec


def _digests(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, d)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_every_cell_loads_with_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert callable(spec.load_kind(c))
        if "circuit" in c.traffic:
            step = spec.load_file("circuits", c.traffic["circuit"])
            assert callable(step.build) and callable(step.z0)
            assert os.path.isfile(os.path.join(BENCH_DIR, "pbref", "steps",
                                               c.traffic["circuit"] + ".py"))
        assert {m.name for m in c.end_to_end} >= {"setup_s"}
        assert len(c.end_to_end) >= 2 and c.per_layer
        reported = {m.name for m in c.end_to_end}
        assert all(m.moves in reported for m in c.per_layer)
        assert set(c.readers) == {m.name for m in c.per_layer}


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "portbench/configs/pallas-ipa-b.json").write_text(
        json.dumps({"name": "pallas-ipa-b", "engines": ["PallasEngine", "VestaEngine"],
                    "primary_key": {"kind": "pedersen", "label": "ck"},
                    "secondary_key": {"kind": "pedersen", "label": "ck"},
                    "commit_curve": "pallas"}))
    (root / "portbench/traffic/commit-2e18.json").write_text(
        json.dumps({"kind": "commit", "log_points": 18, "scalar_bits": 254, "pool": 4}))
    (root / "portbench/traffic/commit-2e20-bits.json").write_text(
        json.dumps({"kind": "commit", "log_points": 20, "scalar_bits": 1, "pool": 4}))
    (root / "portbench/kinds/replay.py").write_text("def run(*args):\n    return 'replay'\n")
    (root / "portbench/circuits/cubes.py").write_text("def build(args, base_rows):\n    return None\n")
    (root / "portbench/traffic/cubes-2e17.json").write_text(
        json.dumps({"kind": "replay", "circuit": "cubes", "circuit_args": {}}))
    (root / "portbench/metrics/commits_n.commit.py").write_text(
        "def read(ctx):\n    return ctx.get('commits')\n")
    bench["configs"].append({"name": "pallas-ipa-b", "source": "https://example.org",
                             "file": "portbench/configs/pallas-ipa-b.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "pallas-ipa-b.commit-2e18", "config": "pallas-ipa-b",
                               "traffic": "commit-2e18", "chips": 1, "why": "a test"})
    bench["workloads"].append({"name": "pallas-ipa.commit-2e20-bits", "config": "pallas-ipa",
                               "traffic": "commit-2e20-bits", "chips": 1, "why": "a test"})
    bench["workloads"].append({"name": "pallas-ipa.cubes-2e17", "config": "pallas-ipa",
                               "traffic": "cubes-2e17", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("commit_"):
            m["workloads"].append("pallas-ipa-b.commit-2e18")
    bench["per_layer"].append({"name": "commits_n.commit", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "harness",
                               "moves": "commit_pts_per_s",
                               "workloads": ["pallas-ipa-b.commit-2e18"]})
    c = spec.cell("pallas-ipa-b.commit-2e18", bench, root=str(root))
    assert c.config["name"] == "pallas-ipa-b"
    assert c.traffic["log_points"] == 18
    assert [m.name for m in c.per_layer] == ["commits_n.commit"]
    assert c.readers["commits_n.commit"]({"commits": 7}) == 7
    assert {m.name for m in c.end_to_end} == {"commit_pts_per_s", "commit_p95_ms", "setup_s"}
    bits = spec.cell("pallas-ipa.commit-2e20-bits", bench, root=str(root))
    assert bits.traffic["scalar_bits"] == 1
    assert spec.load_kind(bits).__code__.co_filename == spec.load_kind(c).__code__.co_filename
    cubes = spec.cell("pallas-ipa.cubes-2e17", bench, root=str(root))
    assert spec.load_kind(cubes)() == "replay"
    assert spec.load_file("circuits", cubes.traffic["circuit"], cubes.bench_dir).build({}, 0) is None
    after = _digests(root)
    assert {k: after[k] for k in before} == before
