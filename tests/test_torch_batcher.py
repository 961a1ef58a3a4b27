"""The port's continuous batcher: against its own sequential decoding and the JAX batcher.

The model is the small one of ``tests/test_batcher.py`` (2 layers, d=64),
with the JAX package's params loaded into the port, so both batchers see
the same weights.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.models import build as jbuild
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch.models import build
from repro_torch.params import from_numpy_tree
from repro_torch.serve import ContinuousBatcher, Request

SMALL = dict(
    name="batcher-demo",
    num_layers=2,
    d_model=64,
    num_heads=2,
    num_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(get_config("serpytor-demo-100m"), **SMALL)
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    tcfg = dataclasses.replace(tconfigs.get_config("serpytor-demo-100m"), **SMALL)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build(tcfg, device="cpu"), tparams


def _sequential_generate(model, params, prompt, n, max_len):
    toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long)[None, :]
    logits, cache = model.prefill(params, {"tokens": toks}, pad_to=max_len)
    tok = torch.argmax(logits, dim=-1)
    out = []
    for _ in range(n):
        out.append(int(tok[0]))
        logits, cache = model.decode_step(params, cache, {"token": tok})
        tok = torch.argmax(logits, dim=-1)
    return out


def _prompts(seed, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, rng.integers(4, 12)).astype(np.int32) for _ in range(n)]


def _drain(eng, request_cls, prompts, new_tokens):
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=f"r{i}", prompt=p, max_new_tokens=new_tokens))
    return {rid: g.tokens for rid, g in eng.run_until_drained().items()}


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_batched_equals_sequential(models, slots):
    """Each request's generation equals single-request greedy decoding.

    ``slots=1`` is the case the JAX reference gets wrong: its
    ``_splice_cache`` takes max(old, new) of cache leaves whose shapes
    agree, which at one slot is every K/V leaf. The port splices each leaf's
    row by slot index and does not reproduce that fault.
    """
    _, _, tmodel, tparams = models
    prompts = _prompts(0)
    want = {f"r{i}": _sequential_generate(tmodel, tparams, p, 6, 64) for i, p in enumerate(prompts)}
    got = _drain(ContinuousBatcher(tmodel, tparams, slots=slots, max_len=64), Request, prompts, 6)
    assert got == want


def test_batched_equals_the_jax_batcher(models):
    jmodel, jparams, tmodel, tparams = models
    prompts = _prompts(1, n=6)
    want = _drain(JaxBatcher(jmodel, jparams, slots=2, max_len=64), JaxRequest, prompts, 7)
    got = _drain(ContinuousBatcher(tmodel, tparams, slots=2, max_len=64), Request, prompts, 7)
    assert got == want


def test_jax_sequential_decode_equals_the_ports(models):
    """The port's sequential greedy tokens equal the JAX model's (same params)."""
    jmodel, jparams, tmodel, tparams = models
    prompt = _prompts(2, n=1)[0]
    logits, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)[None, :]}, pad_to=32)
    tok, want = jnp.argmax(logits, axis=-1), []
    for _ in range(5):
        want.append(int(tok[0]))
        logits, cache = jmodel.decode_step(jparams, cache, {"token": tok})
        tok = jnp.argmax(logits, axis=-1)
    assert _sequential_generate(tmodel, tparams, prompt, 5, 32) == want


def test_request_digest_equals_the_jax_package(models):
    for p in _prompts(3, n=3):
        for n in (1, 8):
            assert Request("a", p, n).digest() == JaxRequest("a", p, n).digest()
    a, b = _prompts(4, n=2)
    assert Request("x", a, 4).digest() != Request("x", b, 4).digest()


def test_slot_reuse_more_requests_than_slots(models):
    _, _, tmodel, tparams = models
    rng = np.random.default_rng(1)
    eng = ContinuousBatcher(tmodel, tparams, slots=2, max_len=32)
    for i in range(7):
        prompt = rng.integers(0, 512, 4).astype(np.int32)
        eng.submit(Request(rid=f"q{i}", prompt=prompt, max_new_tokens=3))
    done = eng.run_until_drained()
    assert len(done) == 7
    assert all(len(g.tokens) == 3 for g in done.values())
    assert eng.utilization() > 0.4


def test_token_streaming_order_and_backpressure(models):
    """submit_stream: tokens arrive in order on the channel while the engine
    still runs (capacity 2 < 8 tokens forces backpressure), and equal the
    final generation."""
    _, _, tmodel, tparams = models
    rng = np.random.default_rng(3)
    eng = ContinuousBatcher(tmodel, tparams, slots=2, max_len=64)
    ch = eng.submit_stream(
        Request(rid="st", prompt=rng.integers(0, 512, 4).astype(np.int32), max_new_tokens=8),
        capacity=2,
    )
    plain = rng.integers(0, 512, 4).astype(np.int32)
    eng.submit(Request(rid="plain", prompt=plain, max_new_tokens=8))
    done = {}
    t = threading.Thread(target=lambda: done.update(eng.run_until_drained()), daemon=True)
    t.start()
    streamed = []
    first_arrival_engine_alive = None
    for seq, tok in ch:  # ends when the engine closes the channel
        if first_arrival_engine_alive is None:
            first_arrival_engine_alive = t.is_alive()
        assert seq == len(streamed)
        streamed.append(tok)
    t.join(timeout=60)
    assert not t.is_alive()
    assert first_arrival_engine_alive, "the first token must stream out before the drain ends"
    assert ch.stats["high_watermark"] <= 2
    assert streamed == done["st"].tokens
    assert len(streamed) == 8
    assert done["plain"].tokens


def test_latency_accounting(models):
    _, _, tmodel, tparams = models
    eng = ContinuousBatcher(tmodel, tparams, slots=1, max_len=32)
    eng.submit(Request(rid="a", prompt=np.arange(4, dtype=np.int32), max_new_tokens=2))
    g = eng.run_until_drained()["a"]
    assert g.prompt_len == 4 and g.total_s > 0
    assert g.prefill_s >= 0 and g.decode_s >= 0
