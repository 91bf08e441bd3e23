"""The port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and its entry points
run on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models.draft import draft_from_target
from repro_torch.params import init_params
from repro_torch.serve.engine import Engine, make_engine
from repro_torch.serve.multi_engine import make_multi_engine

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_engine_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.serve.engine, repro_torch.params, "
            "repro_torch.train.loop, repro_torch.launch.train, "
            "repro_torch.serve.multi_engine, repro_torch.serve.faults, "
            "repro_torch.launch.serve, repro_torch.models.draft, "
            "repro_torch.examples.train_lm, repro_torch.models.whisper, "
            "repro_torch.examples.quickstart, repro_torch.models.model; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_entry_points_need_the_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(get_config("mistral-nemo-12b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params)
    dcfg, dparams = draft_from_target(cfg, params, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, draft_cfg=dcfg, draft_params=dparams, spec_k=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, draft_cfg=dcfg, spec_k=2)
    assert Engine(cfg, params, device="cpu").device.type == "cpu"
    assert Engine(cfg, params, device="cpu", draft_cfg=dcfg,
                  draft_params=dparams, spec_k=2).spec
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_engine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_multi_engine(cfg, [{"name": "a"}, {"name": "b"}])
    assert make_engine(cfg, device="cpu").device.type == "cpu"
    meng = make_multi_engine(cfg, [{"name": "a"}, {"name": "b"}],
                             device="cpu")
    assert {t.engine.device.type for t in meng.tiers} == {"cpu"}


ENTRY_POINTS = {
    "launch.serve": ["-m", "repro_torch.launch.serve", "--device", "cpu"],
    "serve_batch": ["-m", "repro_torch.examples.serve_batch", "--smoke",
                    "--device", "cpu"],
    "serve_multitier": ["-m", "repro_torch.examples.serve_multitier",
                        "--smoke", "--device", "cpu"],
}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_serving_entry_points_run_on_the_cpu(name):
    """The serving launcher and examples, each in its own process, exit 0
    on the CPU; the examples' smoke runs assert completion (and the long
    prompts' tier) and print "smoke OK"."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, *ENTRY_POINTS[name]], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    if name == "launch.serve":
        assert out.stdout.startswith("served 8 requests"), out.stdout
    else:
        assert "smoke OK" in out.stdout, out.stdout
