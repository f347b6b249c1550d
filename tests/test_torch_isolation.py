"""The port stands alone: importing ``repro_torch`` and every submodule
pulls in neither JAX nor any module of the JAX package, and its entry
points refuse to run without a card unless ``device="cpu"`` is asked for."""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as MD
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import PagedContinuousEngine

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def test_import_pulls_in_no_jax_and_no_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "jaxlib" or m.startswith("jaxlib.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        assert len(names) >= 20, names
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_without_a_card():
    cfg = get_config("llama3-8b-tiny")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        MD.init_params(cfg)
    params = MD.init_params(cfg, device="cpu")
    sv = ServingConfig(max_seq=64, n_lanes=1, max_active_pages=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedContinuousEngine(cfg, params, sv)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--tiny", "--paged", "--requests", "1"])
    PagedContinuousEngine(cfg, params, sv, device="cpu")


@pytest.mark.parametrize("field,value", [("async_pipeline", True),
                                         ("kv_quant", "int8"),
                                         ("speculative_thaw", True),
                                         ("chaos", object())])
def test_unported_serving_options_raise(field, value):
    with pytest.raises(NotImplementedError):
        ServingConfig(max_seq=64, n_lanes=1, max_active_pages=4,
                      **{field: value})


def test_launcher_serves_on_cpu(capsys):
    serve.main(["--tiny", "--paged", "--device", "cpu", "--requests", "3",
                "--tokens", "12", "--batch", "2", "--max-seq", "128",
                "--pages", "4", "--prefill-chunk", "16"])
    out = capsys.readouterr().out
    assert "served 3 requests / 36 tokens" in out
    assert "terminal: completed=3" in out
