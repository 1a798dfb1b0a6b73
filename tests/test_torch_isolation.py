"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``, and no entry
point quietly runs on the CPU when it was asked for a GPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_sources_import_no_jax_and_no_repro():
    assert len(PORT_FILES) > 20
    bad = []
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    """A fresh interpreter imports every ``repro_torch`` module and
    ``chip_smoke`` (its ``main`` is guarded), then finds neither ``jax`` nor
    any ``repro`` module in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda entry points run there")


def test_entry_points_refuse_cuda_without_a_gpu(no_gpu):
    from repro_torch import serving
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.models.common import init_params

    cfg = get_config("llama3.2-1b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        serving.build(serving.ServeConfig(arch="llama3.2-1b", reduced=True))
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(build_model(cfg, device="cpu").param_defs(), torch.Generator(), "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.main(["--arch", "llama3.2-1b", "--batch", "1"])


def test_mamba2_entry_points_refuse_cuda_without_a_gpu(no_gpu):
    """``build_model`` on an ssm config and ``step_engine`` default to the
    card and raise without one, even for a model built on the CPU."""
    from repro_torch import serving
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    cfg = get_config("mamba2-2.7b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg, impl="ref")
    cpu_model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        serving.step_engine(cpu_model, serving.single_device_plan(cfg))


def test_entry_points_default_to_cuda():
    import inspect

    from repro_torch import serving
    from repro_torch.models import build_model

    assert serving.ServeConfig(arch="llama3.2-1b").device == "cuda"
    assert serving.ServeConfig(arch="llama3.2-1b").resolved_cluster().chips == 1
    for fn in (serving.step_engine, build_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(no_gpu, alone, tmp_path):
    """Without a GPU — in the checkout, or alone in an empty directory —
    the smoke script exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
