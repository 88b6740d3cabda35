"""The port stands alone: it imports neither ``jax`` nor the reference
package, and asked for CUDA on a host without a card it raises instead of
running on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
BASELINES = ("fedavg", "fedasyn", "fedsea", "clusterfl", "oort", "standalone")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = list(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 32
    baselines = {m for m in mods if m.startswith("repro_torch.baselines")}
    assert baselines >= {"repro_torch.baselines", *(f"repro_torch.baselines.{n}" for n in BASELINES)}
    assert {"repro_torch.optim", "repro_torch.optim.compression", "repro_torch.fl.uplink",
            "repro_torch.kernels.uplink", "repro_torch.fl.faults", "repro_torch.fl.guard", "repro_torch.checkpoint",
            "repro_torch.checkpoint.checkpointer"} <= set(mods)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


# the scripts that run on the card: the timing loops, the chain's phase timeline, the baselines' card-vs-CPU drift
CARD_SCRIPTS = sorted((ROOT / "scripts").glob("*_timing.py")) + [
    ROOT / "scripts" / n for n in ("timing_turns.py", "chain_phases.py", "sync_drift.py")]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + CARD_SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_statement(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


@pytest.mark.parametrize("path", sorted((PKG / "kernels").glob("*.py")), ids=lambda p: p.name)
def test_kernels_import_no_higher_layer(path):
    """The kernel layer sits below the protocol: it imports nothing from
    ``repro_torch.core``, ``repro_torch.fl`` or ``repro_torch.optim``."""
    for name in _imports(path):
        assert not name.startswith(("repro_torch.core", "repro_torch.fl", "repro_torch.optim")), \
            f"{path.name}: imports {name}"


def test_run_experiment_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    from repro_torch.fl.experiment import run_experiment

    calls = []
    import repro_torch.fl.simulator as sim

    orig = sim.Simulator.run
    sim.Simulator.run = lambda self, **kw: calls.append(kw)  # would mean it ran
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_experiment("har", "echopfl", num_clients=4, max_time=60, device="cuda")
    finally:
        sim.Simulator.run = orig
    assert not calls


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_run_on_the_default_device_without_a_card_raises(name):
    """A baseline's run, like EchoPFL's, goes to the card unless the caller
    asks for the CPU: with no card it raises before the simulator runs."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    import repro_torch.fl.simulator as sim
    from repro_torch.fl.experiment import run_experiment

    calls = []
    orig = sim.Simulator.run
    sim.Simulator.run = lambda self, **kw: calls.append(kw)  # would mean it ran
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_experiment("har", name, num_clients=4, max_time=60, rounds=1)
    finally:
        sim.Simulator.run = orig
    assert not calls


def test_build_strategy_raises_key_error_for_an_unknown_name():
    from repro_torch.fl.experiment import build_clients, build_strategy

    _, clients, init = build_clients("har", 2, device="cpu")
    for name in ("fedprox", "", "EchoPFL"):
        with pytest.raises(KeyError):
            build_strategy(name, init, clients, device="cpu")
    assert {build_strategy(n, init, clients, device="cpu").name for n in BASELINES} == set(BASELINES)


@pytest.mark.parametrize("path", sorted((PKG / "csrc").glob("*.cu*")), ids=lambda p: p.name)
def test_only_use_device_sets_the_device(path):
    """Every C entry point makes its device current through
    ``common.cuh::use_device``, which calls ``cudaSetDevice`` only when the
    device is not current already: no source calls it anywhere else."""
    import re

    code = re.sub(r"//[^\n]*", "", path.read_text())
    if path.name == "common.cuh":
        body = re.search(r"inline void use_device\(int device\) \{.*?\n\}", code, re.S)
        assert body and "cudaSetDevice" in body.group(0)
        code = code.replace(body.group(0), "")
    assert "cudaSetDevice" not in code, f"{path.name} calls cudaSetDevice outside use_device"
