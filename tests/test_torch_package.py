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
            "runtime/engine.py", "datapath/__init__.py",
            "datapath/stages.py", "datapath/link.py", "datapath/device.py",
            "datapath/fabric.py", "server/shard.py",
            "workloads/scenarios.py", "workloads/azure_loader.py",
            "workloads/costmodel.py", "analysis/flops.py",
            "replay.py", "utils/shardctx.py", "launch/mesh.py",
            "launch/specs.py", "launch/dryrun.py", "analysis/hlo.py"} <= rel


def test_every_reference_module_has_a_counterpart():
    """Each module of ``src/repro`` has its counterpart at the same path
    in the port, but a Pallas kernel (``kernels/<k>/kernel.py``), whose
    counterpart is ``csrc/<k>.cu``, and its oracle (``ref.py``), whose
    counterpart is the plain version in ``kernels/<k>/ops.py``."""
    missing = []
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF)
        if rel.parts[0] == "kernels" and rel.name in ("kernel.py", "ref.py"):
            port = PORT / "csrc" / f"{rel.parts[1]}.cu" \
                if rel.name == "kernel.py" else PORT / rel.parent / "ops.py"
        else:
            port = PORT / rel
        if not port.exists():
            missing.append(str(rel))
    assert not missing, missing


@pytest.mark.parametrize("path", _scanned_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)
    # nor by name at run time
    assert not re.search(r"import_module\(f?[\"'](jax|repro)\b",
                         path.read_text()), path


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
            "workloads/traces.py", "runtime/simulate.py",
            "datapath/__init__.py", "datapath/stages.py", "datapath/link.py",
            "datapath/device.py", "datapath/fabric.py", "server/shard.py",
            "server/config.py", "workloads/spec.py", "workloads/__init__.py",
            "workloads/scenarios.py", "workloads/azure_loader.py",
            "replay.py"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_control_plane_copy_is_verbatim(rel):
    assert (PORT / rel).read_text() == _renamed((REF / rel).read_text())


def _ref(rel: str) -> str:
    return _renamed((REF / rel).read_text())


def _without(text: str, start: str, end: str) -> str:
    """``text`` with the span from ``start`` up to ``end`` cut out."""
    i = text.index(start)
    return text[:i] + text[text.index(end, i):]


def test_cut_modules_keep_their_carried_parts_verbatim():
    """Where the copy cuts code, what it carries stays the reference's:
    the executors' module but for the endpoint class its docstring names,
    the server package's exports, the sim launcher, the policy classes
    (compared after the import rename)."""
    port_ex = (PORT / "server/executors.py").read_text()
    assert port_ex == _ref("server/executors.py").replace(
        "over real ``JaxEndpoint`` execution;",
        "over real ``TorchEndpoint`` execution;", 1)
    # the registry imports each config module by name
    assert (PORT / "configs/__init__.py").read_text() == \
        _ref("configs/__init__.py").replace(
            'import_module(f"repro.configs.',
            'import_module(f"repro_torch.configs.')
    # server/__init__.py: the module docstring only
    doc_end = '"""\nfrom '
    assert _without((PORT / "server/__init__.py").read_text(), '"""',
                    doc_end) == _without(_ref("server/__init__.py"), '"""',
                                         doc_end)
    from repro.core import policies as ref_pol
    from repro.launch import serve as ref_serve
    from repro_torch.core import policies as port_pol
    from repro_torch.launch import serve as port_serve
    pairs = [(ref_serve.run_sim_mode, port_serve.run_sim_mode)]
    pairs += [(getattr(ref_pol, n), getattr(port_pol, n))
              for n in ("FCFS", "Batch", "SJF", "EEVDF")]
    for ref, port in pairs:
        assert inspect.getsource(port) == \
            _renamed(inspect.getsource(ref)), ref


# the cost model's one cut: its hardware constants are the H100's
HARDWARE_BLOCKS = [("analysis/flops.py", "# --- hardware (",
                    "\n\ndef roofline_terms"),
                   ("workloads/costmodel.py", "# endpoint-serving",
                    "\n\ndef service_time")]


@pytest.mark.parametrize("rel,start,end", HARDWARE_BLOCKS,
                         ids=[b[0] for b in HARDWARE_BLOCKS])
def test_cost_model_cuts_only_its_hardware_block(rel, start, end):
    port = (PORT / rel).read_text()
    assert _without(port, start, end) == _without(_ref(rel), start, end)
    block = port[port.index(start):port.index(end)]
    assert "TPU" not in block and "v5e" not in block and "XLA" not in block


def test_cost_model_constants_are_the_h100s():
    from repro.analysis import flops as ref_flops
    from repro.workloads import costmodel as ref_cm
    from repro_torch.analysis import flops
    from repro_torch.workloads import costmodel as cm
    assert (flops.PEAK_FLOPS, flops.HBM_BW, flops.ICI_BW) == \
        (989e12, 3.35e12, 450e9)
    assert (cm.DEFAULT_CHIPS, cm.H2D_BW, cm.MFU) == (1, 64e9, ref_cm.MFU)
    assert cm.PEAK_FLOPS == flops.PEAK_FLOPS != ref_flops.PEAK_FLOPS
    assert 0.0 < cm.COMPILE_TIME < ref_cm.COMPILE_TIME


def test_configs_match_reference():
    import dataclasses
    from repro.configs import get_config as ref_get
    from repro_torch.configs import ARCH_IDS, get_config
    from repro.configs import ARCH_IDS as REF_IDS
    # every arch of the reference, the encoder-decoder included, in the
    # reference's order (the cost model's endpoint mix follows it)
    assert ARCH_IDS == REF_IDS and len(ARCH_IDS) == 10
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
