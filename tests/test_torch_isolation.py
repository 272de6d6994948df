"""The port stands alone: no JAX and nothing of the JAX package, and its
entry points run on the GPU unless the caller asks for the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs import smoke_config
from repro_torch.core import esn, params
from repro_torch.data.pipeline import MarkovTokens
from repro_torch.launch import serve, train
from repro_torch.models import lm
from repro_torch.serve.engine import ReservoirEngine
from repro_torch.train.trainer import TrainConfig, Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "examples").glob("torch_*.py")))
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(
        ".__init__") for p in PORT.rglob("*.py"))
BANNED = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_sources_import_no_jax_and_nothing_of_repro():
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in SOURCES for m in BANNED.finditer(p.read_text())]
    assert not offenders, offenders
    assert len(MODULES) >= 20
    assert len(SOURCES) - len(MODULES) == 5     # chip_smoke, 4 examples


def test_every_module_imports_with_jax_blocked():
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = params.ESNConfig(n=16)
    lm_cfg = smoke_config("linear-esn")
    calls = [lambda: repro_torch.resolve_device(),
             lambda: esn.dpg_params(cfg),
             lambda: esn.diag_params(cfg),
             lambda: esn.standard_params(cfg),
             lambda: params.params_from_numpy("standard", {}, cfg),
             lambda: params.readout_from_numpy([[1.0]]),
             lambda: ReservoirEngine(esn.dpg_params(cfg, device="cpu")),
             lambda: serve.main(["--reservoir", "--n", "16"]),
             lambda: serve.main(["--arch", "linear-esn", "--smoke"]),
             lambda: serve.main(["--arch", "smollm-135m", "--smoke"]),
             lambda: train.main(["--smoke", "--steps", "1"]),
             lambda: train.main(["--arch", "smollm-135m", "--smoke",
                                 "--steps", "1"]),
             lambda: Trainer(lm_cfg, TrainConfig(), MarkovTokens(128, 2, 8)),
             lambda: lm.init_params(torch.Generator(), lm_cfg),
             lambda: lm.lm_params_from_numpy({})]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert repro_torch.resolve_device("cpu").type == "cpu"
