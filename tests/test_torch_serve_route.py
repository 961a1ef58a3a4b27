"""The Gateway / worker serving route of the port against the JAX package's.

``repro_torch.launch.gateway_serve.build_registry`` behind the port's
``Gateway`` and ``repro.launch.serve.build_registry`` behind the reference's,
each over its own in-process or HTTP workers, on the same params (the
reference's ``model.init``, carried across with ``from_numpy_tree``): the
greedy tokens of every request must be identical, the first prefill's logits
within 1e-4 (float32 both sides; XLA and ATen sum in different orders) and
``health`` equal. The same holds for ``examples/serve_lm.py``'s reduced
model and its own registry. Last, the port's CLI over both transports.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
from repro.configs import get_config, smoke_variant
from repro.launch.serve import build_registry as jbuild_registry
from repro.models import build as jbuild
from repro_torch.launch import gateway_serve
from repro_torch.models import build
from repro_torch.params import from_numpy_tree

REPO = Path(__file__).resolve().parents[1]
LOGITS_TOL = 1e-4
N_REQUESTS, NEW_TOKENS, PROMPT_LEN = 4, 8, 16


def _pair(jcfg, tcfg, seed):
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.key(seed))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build(tcfg, device="cpu"), tparams


@pytest.fixture(scope="module")
def smoke():
    jcfg = smoke_variant(get_config("serpytor-demo-100m"))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config("serpytor-demo-100m"))
    return (jcfg, tcfg, *_pair(jcfg, tcfg, 0))


def _prompts(vocab):
    rng = np.random.default_rng(0)  # the reference CLI's prompts
    return [rng.integers(0, vocab, PROMPT_LEN).tolist() for _ in range(N_REQUESTS)]


def _run(core, registries, transport, prompts, task="generate"):
    """Every prompt through ``core``'s Gateway over its workers; outputs in order."""
    servers = []
    if transport == "http":
        servers = [core.WorkerServer(f"w{i}", r).start() for i, r in enumerate(registries)]
        workers = [
            core.WorkerClient(s.name, s.address, s.heartbeat_server.address) for s in servers
        ]
    else:
        workers = [core.InProcWorker(f"w{i}", r) for i, r in enumerate(registries)]
    try:
        with core.Gateway(workers, allocation=("context_affinity", "least_loaded")) as gw:
            futs = [
                gw.submit(
                    task,
                    core.Context.origin({"session": f"s{i}"}),
                    {"prompt": p, "new_tokens": NEW_TOKENS} if task == "generate" else {},
                    affinity_key=f"s{i % 2}",
                )
                for i, p in enumerate(prompts)
            ]
            outs = [f.result(timeout=300) for f in futs]
            completed = [h.completed for h in gw.handles]
    finally:
        for s in servers:
            s.stop()
    assert sum(completed) == len(prompts)
    return outs


@pytest.mark.parametrize("transport", ["inproc", "http"])
def test_generate_equals_the_references_through_each_gateway(smoke, transport):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = smoke
    prompts = _prompts(jcfg.vocab_size)
    want = _run(jcore, [jbuild_registry(jcfg, jmodel, jparams)] * 2, transport, prompts)
    got = _run(tcore, [gateway_serve.build_registry(tcfg, tmodel, tparams)] * 2, transport, prompts)
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]
    assert all(len(o["tokens"]) == NEW_TOKENS for o in got)
    assert all(isinstance(t, int) for o in got for t in o["tokens"])


def test_first_prefill_logits_and_health_equal_the_references(smoke):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = smoke
    prompt = np.asarray(_prompts(jcfg.vocab_size)[0], np.int32)[None]
    pad_to = PROMPT_LEN + NEW_TOKENS
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, pad_to=pad_to)
    tl, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompt).long()}, pad_to=pad_to)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGITS_TOL)
    want = _run(jcore, [jbuild_registry(jcfg, jmodel, jparams)], "inproc", [None], "health")
    treg = gateway_serve.build_registry(tcfg, tmodel, tparams)
    got = _run(tcore, [treg], "inproc", [None], "health")
    assert got == want and got[0]["params_mb"] > 0


def _serve_lm():
    spec = importlib.util.spec_from_file_location("serve_lm", REPO / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_lm_reduced_model_equals_the_references_over_inproc_workers():
    serve_lm = _serve_lm()
    reduced = dict(
        name="serve-demo",
        num_layers=4,
        d_model=256,
        num_heads=8,
        num_kv_heads=4,
        head_dim=32,
        d_ff=1024,
        vocab_size=8192,
    )  # examples/serve_lm.py's config
    jcfg = dataclasses.replace(get_config("serpytor-demo-100m"), **reduced)
    tcfg = dataclasses.replace(tconfigs.get_config("serpytor-demo-100m"), **reduced)
    jmodel, jparams, tmodel, tparams = _pair(jcfg, tcfg, 0)
    prompts = _prompts(jcfg.vocab_size)
    jreg = serve_lm.make_worker_registry(jcfg, jparams, jmodel, NEW_TOKENS)
    want = _run(jcore, [jreg] * 2, "inproc", prompts)
    got = _run(tcore, [gateway_serve.build_registry(tcfg, tmodel, tparams)] * 2, "inproc", prompts)
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]
    assert [o["prompt_len"] for o in want] == [PROMPT_LEN] * N_REQUESTS


@pytest.mark.parametrize("transport", ["http", "inproc"])
def test_cli_serves_on_the_cpu_over_each_transport(transport, capsys):
    gateway_serve.main(["--smoke", "--device", "cpu", "--transport", transport, "--requests", "4"])
    out = capsys.readouterr().out.splitlines()
    want = f"serving serpytor-demo-100m-smoke (0.7M params) on 2 {transport} workers (cpu)"
    assert out[0] == want
    assert out[1].startswith("4 requests / 32 tokens in ")
    assert "worker w0 heartbeat: ok=True" in out[2]


def test_generate_all_reports_every_request_and_raises_a_failed_one():
    reg = tcore.TaskRegistry()
    reg.register("generate", lambda ctx, prompt, new_tokens: {"tokens": prompt[:new_tokens]})
    with tcore.Gateway([tcore.InProcWorker("w0", reg)]) as gw:
        outs, wall, latency = gateway_serve.generate_all(gw, [[1, 2, 3], [4, 5]], 2)
        assert outs == [{"tokens": [1, 2]}, {"tokens": [4, 5]}]
        assert len(latency) == 2 and all(0 <= t <= wall for t in latency)
    reg.register("generate", lambda ctx, prompt, new_tokens: 1 / 0)
    with tcore.Gateway([tcore.InProcWorker("w0", reg)]) as gw:
        with pytest.raises(RuntimeError, match="ZeroDivisionError"):
            gateway_serve.generate_all(gw, [[1]], 1)
