"""The port's cost model (``repro_torch.analysis.flops``,
``repro_torch.workloads.costmodel``) against the reference's.

The analytic FLOP and byte counts are the reference's text, so
``step_cost`` must equal it for every arch and input shape. The one cut
is the hardware block (the H100's constants in place of the TPU's); with
the port's constants set to the reference's values (monkeypatched, and
the defaults the functions bound when they were defined passed
explicitly) every service time, endpoint spec and endpoint mix must
equal the reference's field by field, and ``launch.serve --mode sim
--workload endpoints`` must print the reference's object. With the H100
constants the launcher prints a finite result.
"""
import argparse
import dataclasses
import json
import math

import pytest

from repro.analysis import flops as ref_flops
from repro.configs import ARCH_IDS as REF_IDS
from repro.configs import get_config as ref_get
from repro.shapes import INPUT_SHAPES as REF_SHAPES
from repro.workloads import costmodel as ref_cm
from repro_torch.analysis import flops
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.shapes import INPUT_SHAPES, InputShape
from repro_torch.workloads import costmodel as cm

CASES = [(a, s) for a in REF_IDS for s in REF_SHAPES]


def _configs(arch):
    """The arch's config in both packages, and its kv_quant variant."""
    ref, port = ref_get(arch), get_config(arch)
    return [(ref, port),
            (dataclasses.replace(ref, kv_quant=True),
             dataclasses.replace(port, kv_quant=True))]


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s}" for a, s in CASES])
def test_step_cost_matches_reference(arch, shape):
    assert sorted(INPUT_SHAPES) == sorted(REF_SHAPES)
    for ref_cfg, port_cfg in _configs(arch):
        want = ref_flops.step_cost(ref_cfg, REF_SHAPES[shape])
        got = flops.step_cost(port_cfg, INPUT_SHAPES[shape])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.hbm_bytes == want.hbm_bytes


@pytest.fixture
def reference_hardware(monkeypatch):
    """The port's hardware constants set to the reference's values."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(flops, name, getattr(ref_flops, name))
    monkeypatch.setattr(cm, "PEAK_FLOPS", ref_cm.PEAK_FLOPS)
    monkeypatch.setattr(cm, "MFU", ref_cm.MFU)
    return dict(chips=ref_cm.DEFAULT_CHIPS, compile_time=ref_cm.COMPILE_TIME,
                h2d_bw=ref_cm.H2D_BW)


def test_roofline_and_service_time_match_under_reference_hardware(
        reference_hardware):
    chips = reference_hardware["chips"]
    for arch in REF_IDS:
        for shape in REF_SHAPES:
            for ref_cfg, port_cfg in _configs(arch):
                for coll in (0.0, 3.0e9):
                    assert flops.roofline_terms(
                        flops.step_cost(port_cfg, INPUT_SHAPES[shape]),
                        chips, coll) == ref_flops.roofline_terms(
                        ref_flops.step_cost(ref_cfg, REF_SHAPES[shape]),
                        chips, coll)
                    assert cm.service_time(
                        port_cfg, INPUT_SHAPES[shape], chips, coll) == \
                        ref_cm.service_time(ref_cfg, REF_SHAPES[shape],
                                            chips, coll)


@pytest.mark.parametrize("shape", sorted(REF_SHAPES))
def test_endpoint_spec_and_mix_match_under_reference_hardware(
        shape, reference_hardware):
    kw = reference_hardware
    for arch in REF_IDS:
        got = cm.endpoint_spec(arch, shape, kw["chips"],
                               compile_time=kw["compile_time"],
                               h2d_bw=kw["h2d_bw"], setup_time=0.5)
        want = ref_cm.endpoint_spec(arch, shape, setup_time=0.5)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
    got = cm.endpoint_mix(shape, **kw)
    want = ref_cm.endpoint_mix(shape)
    # the same functions in the same order (a trace draws by position)
    assert list(got) == list(want)
    for fn in want:
        assert dataclasses.asdict(got[fn]) == dataclasses.asdict(want[fn])
    sub = ["hymba-1.5b", "qwen3-1.7b"]
    assert list(cm.endpoint_mix(shape, archs=sub, **kw)) == \
        list(ref_cm.endpoint_mix(shape, archs=sub))


def test_registry_order_is_the_references():
    """The endpoint mix iterates ``ARCH_IDS``: a registry in another order
    would give the zipf trace of ``--workload endpoints`` other ranks."""
    assert ARCH_IDS == REF_IDS
    assert list(cm.endpoint_mix()) == list(ref_cm.endpoint_mix())


def _sim_args(**over):
    args = dict(mode="sim", policy="mqfq-sticky", T=10.0, alpha=2.0, d=2,
                dynamic_d=False, devices=1, mem_policy="prefetch_swap",
                pool_size=32, workload="endpoints",
                endpoint_shape="decode_32k", n_fns=24, duration=300.0,
                rps=1.0, trace_id=4, seed=0)
    args.update(over)
    return args


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_serve_endpoints_workload_matches_reference_under_its_hardware(
        shape, reference_hardware, monkeypatch, capsys):
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    kw = reference_hardware
    monkeypatch.setattr(cm.service_time, "__defaults__",
                        (kw["chips"], 0.0))
    monkeypatch.setattr(cm.endpoint_spec, "__defaults__", (kw["chips"],))
    monkeypatch.setattr(cm.endpoint_spec, "__kwdefaults__",
                        {"compile_time": kw["compile_time"],
                         "h2d_bw": kw["h2d_bw"], "setup_time": 0.0})
    got = serve.main(["--mode", "sim", "--workload", "endpoints",
                      "--endpoint-shape", shape, "--duration", "300"])
    port_out = capsys.readouterr().out
    want = ref_serve.run_sim_mode(argparse.Namespace(
        **_sim_args(endpoint_shape=shape)))
    assert port_out == capsys.readouterr().out
    assert got == want and want["events"] > 0


def test_serve_endpoints_workload_on_h100_constants(capsys):
    from repro_torch.launch import serve
    got = serve.main(["--mode", "sim", "--workload", "endpoints"])
    assert json.loads(capsys.readouterr().out) == got
    assert got["events"] > 0
    for key, v in got.items():
        if key != "policy":
            assert math.isfinite(v), key
    # the same zipf trace as the reference's launcher, other prices
    from repro.launch import serve as ref_serve
    want = ref_serve.run_sim_mode(argparse.Namespace(**_sim_args()))
    capsys.readouterr()
    assert got["events"] == want["events"]
    assert got["mean_latency_s"] != want["mean_latency_s"]


def test_h100_terms_at_the_served_shape():
    """The cost model's terms at the shape ``chip_smoke.py`` serves
    (B 4, S 1024 prefill, decode steps after it) are finite and positive,
    and the cold start is the compile plus the upload at ``H2D_BW``."""
    cfg = get_config("qwen3-1.7b")
    pre = cm.service_time(cfg, InputShape("serve", 1024, 4, "prefill"))
    dec = cm.service_time(cfg, InputShape("serve", 1040, 4, "decode"))
    assert 0.0 < dec < pre < 1.0
    spec = cm.endpoint_spec("qwen3-1.7b", "decode_32k")
    assert spec.stages.compile_s == cm.COMPILE_TIME
    assert spec.cold_init == pytest.approx(
        cm.COMPILE_TIME + spec.mem_bytes / cm.H2D_BW, rel=1e-12)
    assert spec.mem_bytes == cfg.n_params() * 2
