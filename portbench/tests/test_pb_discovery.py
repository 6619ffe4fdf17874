"""BENCHMARK.json and the files that the harness finds by name: every cell,
configuration, traffic mix, limit and metric reader; the contract's limits
on names and keys; the import guard's comparison of top-level names."""

import json
import re
import sys

import pytest

from portbench.cells import HERE, ROOT, load_cell, metric_reader
from portbench.run import FORBIDDEN, forbidden_modules

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELL_NAMES = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_each_cell_loads_from_its_files(cell):
    c = load_cell(cell)
    assert c.config["name"] == [w for w in BENCH["workloads"] if w["name"] == cell][0]["config"]
    assert set(c.limits) == {"first_step", "later_step", "decode"}
    assert c.end_to_end and c.per_layer
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(metric_reader(m["name"]))


def test_attention_patterns_are_read_from_their_directory():
    mod = __import__("importlib").util
    spec = mod.spec_from_file_location("ar", HERE / "metrics" / "attn_roofline.py")
    m = mod.module_from_spec(spec)
    spec.loader.exec_module(m)
    assert "flash_wgmma_bf16<" in m.patterns() and "flash_mma_f32x3<" in m.patterns()


def test_names_units_and_keys_keep_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["moves"] for m in BENCH["per_layer"]} <= {m["name"] for m in BENCH["end_to_end"]}


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    assert "elasticdiffusion_tpu" in FORBIDDEN
    monkeypatch.setitem(sys.modules, "elasticdiffusion_tpu_torch_probe", sys)
    assert "elasticdiffusion_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "elasticdiffusion_tpu.configs", sys)
    assert "elasticdiffusion_tpu" in forbidden_modules()


def test_the_harness_and_reference_import_no_jax():
    """Outside the port's own modules, no file of the benchmark names JAX or
    the JAX package."""
    rx = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|elasticdiffusion_tpu)\b(?!_torch)",
                    re.M)
    for f in HERE.rglob("*.py"):
        assert not rx.search(f.read_text()), f
    for f in (HERE / "reference").rglob("*.py"):
        assert "elasticdiffusion_tpu" not in f.read_text().replace(
            "``elasticdiffusion_tpu_torch``", ""), f
