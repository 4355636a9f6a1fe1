"""``TorchEndpoint`` greedy tokens against ``JaxEndpoint``'s, for the
archs that ``tests/test_torch_vlm.py`` (llava, granite) and
``tests/test_torch_whisper.py`` (whisper) do not cover: the reference's
default ``--archs`` (qwen3-1.7b's full cache, xlstm-350m's state and
hymba-1.5b's ring) and qwen3-moe-30b-a3b, chatglm3-6b, qwen1.5-32b and
deepseek-coder-33b.

Both endpoints serve the reduced config on the reference's own weights
(``bridge.params_from_jax``); the port's batch for a request is the
reference's (``make_batch`` under the request's seed), passed through
numpy. ``serve_batch`` 2, ``serve_seq`` 64 (hymba's 64-slot ring wraps
on the first decode step), 6 decode steps, ``kv_quant`` off and on.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.runtime.device import JaxEndpoint  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime.device import TorchEndpoint  # noqa: E402

ARCHS = ["qwen3-1.7b", "xlstm-350m", "hymba-1.5b", "qwen3-moe-30b-a3b",
         "chatglm3-6b", "qwen1.5-32b", "deepseek-coder-33b"]
SERVE = dict(seed=2, serve_seq=64, serve_batch=2, decode_steps=6)
REQUEST_SEEDS = (0, 5, 9)


@pytest.mark.parametrize("kv_quant", [False, True],
                         ids=["kv", "kv_quant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_endpoint_greedy_tokens_match_jax_endpoint(arch, kv_quant):
    rcfg = dataclasses.replace(ref_config(arch).reduced(), kv_quant=kv_quant)
    pcfg = dataclasses.replace(get_config(arch).reduced(), kv_quant=kv_quant)
    jep = JaxEndpoint("ref", rcfg, **SERVE)
    tep = TorchEndpoint("port", pcfg, device="cpu", **SERVE)
    tep.host_params = params_from_jax(jep.host_params, device="cpu")

    def jax_batch(shape, generator, device):
        rb = jep.model.make_batch(
            shape, rng=jax.random.PRNGKey(generator.initial_seed()))
        return {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
    tep.model.make_batch = jax_batch
    for ep in (jep, tep):
        ep.upload()
        ep.compile()
    if arch == "hymba-1.5b":
        assert tep.plan.kind == "ring" and tep.plan.length == 64
    for seed in REQUEST_SEEDS:
        want = jep.execute({"seed": seed})["tokens"]
        got = tep.execute({"seed": seed})["tokens"]
        assert got.shape == want.shape == (2, SERVE["decode_steps"])
        assert np.array_equal(got, want), (seed, got, want)
