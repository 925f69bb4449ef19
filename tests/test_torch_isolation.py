"""The port stands alone: no module of `repro_torch` (nor `chip_smoke.py`)
imports JAX or the JAX package, and its entry points refuse to fall back to
the CPU when a CUDA device is asked for and there is none."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_pulls_in_no_jax():
    mods = list(_modules())
    assert {"repro_torch.serve.engine", "repro_torch.quant.qtypes",
            "repro_torch.kernels.moe_ffn"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n == 'jax'"
            " or n.startswith('jax.') or n == 'repro'"
            " or n.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    """Make this process look card-less whatever machine it runs on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_cuda_without_a_card(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve import PagedEngine

    cfg = get_config("qwen3-0.6b").reduced()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.lm_init(cfg, device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.lm_init_cache_paged(cfg, 4, 8, device=device)
    params = M.lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedEngine(cfg, params, slots=2, num_pages=4, page_size=8,
                    max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])


def test_cpu_is_taken_only_when_asked(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("qwen3-0.6b").reduced()
    params = M.lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"].device.type == "cpu"
    assert params["embed"].dtype == torch.bfloat16
    assert params["final_norm"]["scale"].dtype == torch.float32
    assert len(params["layers"]) == cfg.n_layers


def test_chip_smoke_fails_without_a_card():
    """`chip_smoke.py` exits non-zero and prints no result line when no
    CUDA device is visible (the subprocess hides every card)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
