"""GPT-OSS under prompt-lookup speculation through the PyTorch port against
the JAX package on the CPU: the mixture-of-experts FFN on verify rows with
no host read, and the speculative Engine.

The verify rows of a speculative step (B sequences x S = spec_tokens + 1
rows) take the grouped MoE route, as in JAX (ops/moe.py:261). Where the
padding bound holds for the worst case (every expert's group padded to T
rows, the most a group can hold: a token's k experts are distinct),
``ops.moe.pads_to_tokens`` says so from the shapes alone and the groups are
padded to T with nothing read on the host; the route is held to the
host-read route (the group sizes read on the host, each group padded to
the largest) and to JAX's ``moe_ffn_grouped``, f32 within 1e-5 of the
output's largest magnitude, over random and skewed routers. The models are
tests/test_torch_gpt_oss.py's tiny GPT-OSS (4 layers, sliding and full
alternating at window 8, sinks, biases, 4 experts of 64 with top 2, one JAX
draw) and, for the MoE alone, a GPT-OSS-shaped layer of 8 experts (the
gate then turns at T = 64). The spec Engine (spec_tokens 4, the grouped
engine's ring pools and the ordinary pools) runs the sink forms on verify
rows (4vs, 4vws) and the sync-free MoE: greedy tokens exact against JAX's
spec Engine (run once, over the ring pools, which change no token) and
against the port's spec_tokens=0 Engine, with the same speculative
metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gpt_oss as oss
from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKVConfig
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.engine import Engine as JaxEngine
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops import moe as jmoe
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import moe as tmoe

TOL = 1e-5
# a GPT-OSS-shaped MoE layer of 8 experts with top 2: the gate admits
# T <= 64 tokens (8 T <= 4 T + 256)
MOE8 = dict(hidden_size=96, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=32, num_experts=8,
            num_experts_per_tok=2, moe_intermediate_size=64,
            hidden_act="swiglu_oss", moe_bias=True, norm_topk_prob=True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread: the tiny models' ops are far
    below where threads pay off, and under the suite's parallel workers
    (each with an OpenMP thread per core) the threads spin against each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_rel(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(g).all()
    assert np.abs(g - w).max() <= TOL * np.abs(w).max(), np.abs(g - w).max()


_LAYERS: dict = {}


def _moe8():
    """The 8-expert layer stack, one JAX draw for the module."""
    if not _LAYERS:
        jcfg = JaxModelConfig.tiny_test(dtype="float32", **MOE8)
        jp = jllama.init_params(jcfg, jax.random.PRNGKey(21))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _LAYERS.update(jcfg=jcfg, jlw=jp["layers"],
                       cfg=ModelConfig.tiny_test(dtype="float32", **MOE8),
                       tlw=tp["layers"])
    return _LAYERS


@pytest.mark.parametrize("t_,e,k,want", [
    (40, 32, 4, True),      # gpt-oss-20b's verify step: 8 x 5 rows
    (42, 32, 4, True), (43, 32, 4, False), (1024, 32, 4, False),
    (64, 8, 2, True), (65, 8, 2, False),
    (1, 4, 2, True), (4096, 4, 2, True)])   # e <= 2k: every T
def test_pads_to_tokens_is_a_function_of_shapes(t_, e, k, want):
    assert tmoe.pads_to_tokens(t_, e, k) == want
    # where it holds, the host-read route's bound holds for any routing
    # (no group exceeds T rows)
    if want:
        assert e * t_ <= 2 * t_ * k + tmoe.PAD_SLACK * e


def _host_read(monkeypatch):
    """Send moe_ffn_grouped down its host-read route (the group sizes read
    on the host, each group padded to the largest)."""
    monkeypatch.setattr(tmoe, "pads_to_tokens", lambda *a: False)


def _no_host_read(monkeypatch):
    """Make every read of the group sizes on the host raise."""
    def refuse(*a, **kw):
        raise AssertionError("a host read in the sync-free route")
    monkeypatch.setattr(torch, "bincount", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)


@pytest.mark.parametrize("skew", [False, True], ids=["random", "skewed"])
@pytest.mark.parametrize("b,s", [(4, 5), (8, 5), (2, 3)],
                         ids=["4x5", "8x5", "2x3"])
def test_verify_rows_moe_without_host_read(monkeypatch, b, s, skew):
    """Verify rows (B x S, T <= 64) through the sync-free route against
    the host-read route and JAX's ``moe_ffn_grouped``; the skewed router
    sends every token to experts 2 and 0 (two groups of T rows, six
    empty)."""
    m = _moe8()
    jlw, tlw = m["jlw"], m["tlw"]
    if skew:
        bias = np.zeros((2, 8), np.float32)
        bias[:, 2], bias[:, 0] = 60.0, 40.0
        jlw = dict(jlw, router_bias=jnp.asarray(bias))
        tlw = dict(tlw, router_bias=t(bias))
    rng = np.random.default_rng(b * 10 + s + skew)
    x = rng.standard_normal((b, s, 96)).astype(np.float32) * 4.0
    assert tmoe.pads_to_tokens(b * s, 8, 2)
    with monkeypatch.context() as mp:
        _no_host_read(mp)
        free = [tmoe.moe_ffn(m["cfg"], tlw, li, t(x)) for li in (0, 1)]
    with monkeypatch.context() as mp:
        _host_read(mp)
        read = [tmoe.moe_ffn(m["cfg"], tlw, li, t(x)) for li in (0, 1)]
    for li in (0, 1):
        want = jmoe.moe_ffn_grouped(m["jcfg"], jlw, jnp.int32(li),
                                    jnp.asarray(x))
        _close_rel(free[li], want)
        _close_rel(free[li], read[li])
    if skew:
        ids = tmoe.router_topk(t(x).reshape(-1, 96), tlw["router"][1], 2,
                               bias=tlw["router_bias"][1])[1]
        assert torch.equal(ids, torch.tensor([[2, 0]]).expand(b * s, 2))


def test_prefill_past_the_gate_keeps_its_host_read(monkeypatch):
    """Past the gate (T = 80 > 64 over 8 experts) the grouped route reads
    its group sizes on the host, as before; the sync-free route, forced,
    gives the same outputs."""
    m = _moe8()
    rng = np.random.default_rng(31)
    x = t(rng.standard_normal((2, 40, 96)).astype(np.float32) * 3.0)
    assert not tmoe.pads_to_tokens(80, 8, 2)
    with monkeypatch.context() as mp:
        _no_host_read(mp)
        with pytest.raises(AssertionError, match="host read"):
            tmoe.moe_ffn(m["cfg"], m["tlw"], 1, x)
    read = tmoe.moe_ffn(m["cfg"], m["tlw"], 1, x)
    with monkeypatch.context() as mp:
        mp.setattr(tmoe, "pads_to_tokens", lambda *a: True)
        _close_rel(tmoe.moe_ffn(m["cfg"], m["tlw"], 1, x), read)


SPEC_PROMPTS = [[5, 6, 7, 8] * 5, list(range(30, 51)),
                [9, 8, 7, 9, 8, 7, 9, 8, 7], [101, 4], oss.SYSTEM + [7, 7]]


def _kv(reclaim: bool):
    return dict(page_size=oss.PS, num_pages=96, max_pages_per_seq=16,
                kv_dtype="f32", sliding_reclaim=reclaim)


_JAX: dict = {}


def _jax_spec():
    """JAX's spec Engine over the grouped engine's ring pools, run once for
    the module: (outputs, (spec_steps, spec_accepted), ring pages)."""
    if not _JAX:
        jcfg, jp, _cfg, _tp = oss._drawn("f32")
        je = JaxEngine(jcfg, jp, JaxEngineConfig(
            kv=JaxKVConfig(**_kv(True)), max_batch_size=4, spec_tokens=4),
            decode_burst=3)
        assert je._grouped
        out = je.generate(SPEC_PROMPTS, JaxSampling(max_new_tokens=14))
        _JAX.update(out=out, metrics=(je.metrics.spec_steps,
                                      je.metrics.spec_accepted),
                    ring=je._ring)
    return _JAX


@pytest.mark.parametrize("grouped", [True, False],
                         ids=["grouped", "ungrouped"])
def test_spec_engine_matches_jax(grouped):
    """spec_tokens 4, burst 3, 5 prompts over 4 slots (one waits), 14 new
    tokens past the window of 8: the verify rows through 4vs on the full
    layers and 4vws on the sliding ones (over the ring pools when
    grouped), the MoE on verify rows without a host read. Both engines
    against JAX's grouped spec Engine (the ring pools change no token) and
    the port's spec_tokens=0 Engine."""
    _jcfg, _jp, cfg, tp = oss._drawn("f32")
    want = _jax_spec()
    te = Engine(cfg, tp, EngineConfig(kv=KVCacheConfig(**_kv(grouped)),
                                      max_batch_size=4, spec_tokens=4),
                decode_burst=3, device="cpu")
    assert te._grouped == grouped
    assert te._ring == (want["ring"] if grouped else 0)
    got = te.generate(SPEC_PROMPTS, SamplingParams(max_new_tokens=14))
    assert got == want["out"]
    assert (te.metrics.spec_steps,
            te.metrics.spec_accepted) == want["metrics"]
    assert te.metrics.spec_accepted > 0
    plain = Engine(cfg, tp, EngineConfig(kv=KVCacheConfig(**_kv(grouped)),
                                         max_batch_size=4), decode_burst=3,
                   device="cpu")
    assert plain.generate(SPEC_PROMPTS,
                          SamplingParams(max_new_tokens=14)) == got
    assert len({tok for o in got for tok in o}) > 2
