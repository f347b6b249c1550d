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
from repro_torch.serving.engine import (ContinuousEngine,
                                        PagedContinuousEngine)
from repro_torch.serving.faults import ChaosConfig

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


@pytest.mark.parametrize("module", ["repro_torch.serving.scheduler",
                                    "repro_torch.serving.sched_cases",
                                    "repro_torch.launch.bench_sched"])
def test_scheduler_modules_stand_alone(module):
    """Each module of the SLO scheduler slice, imported alone, loads
    neither JAX nor any module of the JAX package."""
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", ["repro_torch.serving.server",
                                    "repro_torch.serving.server_cases",
                                    "repro_torch.launch.bench_serving"])
def test_server_modules_stand_alone(module):
    """Each module of the streaming front end's slice, imported alone,
    loads neither JAX nor any module of the JAX package."""
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", ["repro_torch.models.moe",
                                    "repro_torch.configs.olmoe_1b_7b"])
def test_moe_modules_stand_alone(module):
    """The MoE family's modules, each imported alone, load neither JAX nor
    any module of the JAX package; the config loads no torch either."""
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        if {module!r}.startswith("repro_torch.configs"):
            assert "torch" not in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_olmoe_entry_points_raise_without_a_card():
    """The MoE family goes through the same entry points: each needs a
    card unless the CPU is asked for."""
    cfg = get_config("olmoe-1b-7b-tiny")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        MD.init_params(cfg)
    params = MD.init_params(cfg, device="cpu")
    sv = ServingConfig(max_seq=64, n_lanes=1, max_active_pages=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedContinuousEngine(cfg, params, sv)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(cfg, params, sv.replace(max_active_pages=None))
    for mode in ([], ["--paged"], ["--static"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "olmoe-1b-7b", "--tiny", "--requests",
                        "1"] + mode)


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


def test_http_server_and_bench_serving_raise_without_a_card():
    """``--http`` and the serving twin need a card unless asked for the
    CPU, like every other entry point."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.launch import bench_serving
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--tiny", "--paged", "--http", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_serving.main(["--smoke", "--out", os.devnull])


def test_chaos_config_builds_both_engines():
    """A chaos config deploys both continuous engines, each with its
    injector and the ring endpoint on its fetch ring (the paged one also
    guards its pull, push, staging and stash)."""
    sv = ServingConfig(max_seq=64, n_lanes=1, max_active_pages=4,
                       chaos=ChaosConfig(seed=1))
    cfg = get_config("llama3-8b-tiny")
    params = MD.init_params(cfg, device="cpu")
    paged = PagedContinuousEngine(cfg, params, sv, device="cpu")
    dense = ContinuousEngine(cfg, params, sv.replace(max_active_pages=None),
                             device="cpu")
    for eng in (paged, dense):
        assert eng.injector is not None
        assert eng.ring.endpoint is eng.ep_ring is not None
    assert set(paged.robust_snapshot()["endpoints"]) == \
        {"pull", "push", "ring", "stage", "stash"}
    assert set(dense.robust_snapshot()["endpoints"]) == \
        {"pull", "push", "ring", "stage"}


@pytest.mark.parametrize("module", ["repro_torch.serving.faults",
                                    "repro_torch.launch.bench_chaos"])
def test_chaos_modules_stand_alone(module):
    """Each module of the chaos slice, imported alone, loads neither JAX
    nor any module of the JAX package; ``faults`` loads no torch either."""
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        if {module!r}.endswith(".faults"):
            assert "torch" not in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", ["repro_torch.analysis.invariants",
                                    "repro_torch.serving.tenancy"])
def test_auditor_and_tenancy_modules_stand_alone(module):
    """The invariant auditor and the tenancy controller, each imported
    alone, load neither JAX, nor any module of the JAX package, nor
    torch."""
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro",
                                            "torch"))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_contiguous_engine_accepts_kv_quant(kv_quant):
    """The contiguous engine hands ``kv_quant`` to its host offload, and
    the launcher serves it in the default mode and ignores it with
    ``--static`` (as the reference launcher does)."""
    cfg = get_config("llama3-8b-tiny")
    params = MD.init_params(cfg, device="cpu")
    eng = ContinuousEngine(cfg, params, ServingConfig(
        max_seq=64, n_lanes=1, kv_quant=kv_quant), device="cpu")
    assert eng.kv_quant == eng.offloader.kv_quant == kv_quant
    small = ["--tiny", "--device", "cpu", "--requests", "2", "--tokens",
             "8", "--kv-quant", kv_quant]
    serve.main(small)
    serve.main(small + ["--static"])


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_paged_engine_accepts_quant_modes(kv_quant):
    cfg = get_config("llama3-8b-tiny")
    params = MD.init_params(cfg, device="cpu")
    eng = PagedContinuousEngine(cfg, params, ServingConfig(
        max_seq=64, n_lanes=1, max_active_pages=4, kv_quant=kv_quant),
        device="cpu")
    assert eng.kv_quant == eng.ctl.kv_quant == kv_quant
    assert eng.ctl.pool_dtype == eng.state.k.dtype


def test_unknown_kv_quant_mode_raises_as_the_reference():
    from repro.core.quant import resolve_mode as rresolve
    with pytest.raises(ValueError) as ref:
        rresolve("int4")
    with pytest.raises(ValueError) as port:
        ServingConfig(kv_quant="int4")
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("field", ["async_pipeline", "speculative_thaw",
                                   "speculative_slots"])
def test_serving_defaults_match_the_reference(field):
    """The port deploys what the reference deploys by default: the async
    pipeline, speculative thaw following it, 3 staging slots a lane."""
    from repro.serving.config import ServingConfig as RServingConfig
    assert getattr(ServingConfig(), field) == getattr(RServingConfig(), field)


def test_launcher_serves_on_cpu(capsys):
    serve.main(["--tiny", "--paged", "--device", "cpu", "--requests", "3",
                "--tokens", "12", "--batch", "2", "--max-seq", "128",
                "--pages", "4", "--prefill-chunk", "16"])
    out = capsys.readouterr().out
    assert "served 3 requests / 36 tokens" in out
    assert "terminal: completed=3" in out
