"""Package rules of the port, ``repro_torch``.

(a) Neither ``src/repro_torch`` nor ``chip_smoke.py`` imports JAX or any
module of ``repro``. The control plane is a copy of ``repro``'s, and
the copied modules must stay the reference's text apart from the import
paths. (f) No entry point runs on the CPU unless asked.
"""
import ast
import inspect
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def _scanned_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_scan_covers_the_package():
    files = _scanned_files()
    assert len(files) > 30 and all(f.exists() for f in files)
    rel = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"training/optimizer.py", "training/trainer.py",
            "training/checkpoint.py", "training/data.py",
            "launch/train.py", "examples/train_lm.py",
            "batchsim/state.py", "batchsim/step.py", "batchsim/sweep.py",
            "server/executors.py", "runtime/simulate.py",
            "runtime/engine.py"} <= rel


@pytest.mark.parametrize("path", _scanned_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


_IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)


def _renamed(text: str) -> str:
    return _IMPORT.sub(r"\1\2 repro_torch.", text)


# modules copied as they are, apart from import paths
VERBATIM = ["runtime/invocation.py", "core/flow.py", "core/index.py",
            "core/policy_base.py", "core/mqfq.py", "core/tokens.py",
            "core/fairness.py", "memory/manager.py", "memory/pool.py",
            "faults/plan.py", "faults/inject.py", "faults/__init__.py",
            "server/events.py", "server/metrics.py", "server/control.py",
            "server/stub.py", "configs/qwen3_1_7b.py",
            "configs/xlstm_350m.py", "configs/hymba_1_5b.py",
            "configs/granite_moe_3b_a800m.py", "configs/qwen3_moe_30b_a3b.py",
            "configs/llava_next_mistral_7b.py", "configs/chatglm3_6b.py",
            "configs/qwen1_5_32b.py", "configs/deepseek_coder_33b.py",
            "configs/whisper_large_v3.py", "training/data.py",
            "training/__init__.py", "core/reference.py",
            "memory/reference.py", "memory/__init__.py", "core/policies.py",
            "workloads/traces.py", "runtime/simulate.py"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_control_plane_copy_is_verbatim(rel):
    assert (PORT / rel).read_text() == _renamed((REF / rel).read_text())


def test_cut_modules_keep_their_carried_parts_verbatim():
    """Where the copy cuts code, what it carries stays the reference's:
    the sim and wall-clock executors, ``Server.run_trace``, the server
    config, the policy classes (compared after the import rename)."""
    from repro.core import policies as ref_pol
    from repro.server import config as ref_cfg
    from repro.server import executors as ref_ex
    from repro_torch.core import policies as port_pol
    from repro_torch.server import config as port_cfg
    from repro_torch.server import executors as port_ex
    pairs = [(ref_ex.WallClockExecutor, port_ex.WallClockExecutor),
             (ref_ex.SimExecutor, port_ex.SimExecutor),
             (ref_ex.Server.run_trace, port_ex.Server.run_trace),
             (ref_ex.Server.run_scenario, port_ex.Server.run_scenario),
             (ref_cfg.ServerConfig, port_cfg.ServerConfig),
             (ref_cfg.specs_from_endpoints, port_cfg.specs_from_endpoints)]
    pairs += [(getattr(ref_pol, n), getattr(port_pol, n))
              for n in ("FCFS", "Batch", "SJF", "EEVDF")]
    for ref, port in pairs:
        assert inspect.getsource(port) == \
            _renamed(inspect.getsource(ref)), ref
    # spec.py drops only the data plane's import, used by one annotation
    spec_ref = (REF / "workloads/spec.py").read_text()
    spec_port = (PORT / "workloads/spec.py").read_text()
    assert spec_port.replace(
        "    stages: Optional[object] = None  # ColdStartStages in "
        "repro.datapath",
        "    stages: Optional[ColdStartStages] = None") == spec_ref.replace(
        "from repro.datapath.stages import ColdStartStages\n\n", "")


def test_configs_match_reference():
    import dataclasses
    from repro.configs import get_config as ref_get
    from repro_torch.configs import ARCH_IDS, get_config
    from repro.configs import ARCH_IDS as REF_IDS
    assert ARCH_IDS == ["qwen3-1.7b", "xlstm-350m", "hymba-1.5b",
                        "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
                        "llava-next-mistral-7b", "chatglm3-6b",
                        "qwen1.5-32b", "deepseek-coder-33b",
                        "whisper-large-v3"]
    # every arch of the reference, the encoder-decoder included
    assert sorted(ARCH_IDS) == sorted(REF_IDS)
    for arch in ARCH_IDS:
        port, ref = get_config(arch), ref_get(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
        assert dataclasses.asdict(port.reduced()) == \
            dataclasses.asdict(ref.reduced()), arch
        assert port.compute_dtype is torch.bfloat16
        assert port.reduced().weight_dtype is torch.float32
        assert port.n_params() == ref.n_params(), arch


def test_no_silent_cpu_fallback(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.runtime.device import TorchEndpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchEndpoint("q", cfg)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--requests", "1"])
    from repro_torch.bridge import params_from_jax
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"w": np.zeros(3, np.float32)})
    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, Trainer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(build_model(cfg), AdamWConfig()).init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--steps", "1"])
    from repro_torch.batchsim import (build_consts, init_state, make_params,
                                      run_batch)
    from repro_torch.batchsim.sweep import stack_params
    from repro_torch.workloads.traces import padded_arrivals
    pa = padded_arrivals("zipf", n_fns=2, duration=10.0, total_rps=1.0)
    for call in (lambda: run_batch(pa, [make_params(2)]),
                 lambda: init_state(2, 4, 2, 35, 12),
                 lambda: build_consts(pa),
                 lambda: stack_params([make_params(2)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
