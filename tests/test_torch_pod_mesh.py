"""The port's tensor-parallel serving (`accelerate_tpu_torch.serving.pod`
layer 1) against the JAX package's, on the same converted f32 tiny
weights.

Two `debug_launcher` worlds on the CPU (gloo) hold every multi-rank
check, each rank serving the same seeded trace:

- 2 ranks: gpt2-tiny through `sharded_engine(tensor_parallel=2)` (the
  fused qkv, column-sharded off the head boundaries) gives the JAX
  `sharded_engine`'s greedy streams (the port's sampling noise is not
  threefry's) and the port's single engine's, greedy and sampled;
  llama-tiny likewise, with an int8 pool whose scales shard with it;
  `PodEngine(PodConfig(tensor_parallel=2))` gives the single engine's;
  and the lockstep check: rank 1's clock runs five times faster than
  rank 0's, the requests carry deadlines and TTFT SLOs, and both ranks
  make rank 0's clock's shed and admit decisions and give its tokens,
  which rank 1's own clock would not;
- 4 ranks: llama-tiny (2 KV heads) with a replicated pool and with a
  page-sharded one (pages + 1 divides 4; int8 too, its scales sharded
  alike), alone and under a pod, stays exact.

Every engine and pod router in the worlds runs the serving sanitizer
after each step, over its rank's local pool.

In one process: a 1-rank mesh degrades to single serving, and
`cache_state_shardings` gives the JAX specs at 2 and 3 (and the page and
replicate fallbacks at 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import gpt2 as jg
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import Engine as JEngine
from accelerate_tpu.serving import EngineConfig as JConfig
from accelerate_tpu.serving.pod import cache_state_shardings as j_cache_sh
from accelerate_tpu.serving.pod import sharded_engine as j_sharded
from accelerate_tpu.serving.pod import tensor_mesh as j_mesh
from accelerate_tpu_torch.models import gpt2 as tg
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.serving import Engine, EngineConfig
from accelerate_tpu_torch.serving.pod import (
    cache_state_shardings,
    sharded_engine,
)
from accelerate_tpu_torch.state import ProcessMesh
from accelerate_tpu_torch.test_utils import run_world
from accelerate_tpu_torch.test_utils.worlds import (
    serve_job,
    tensor_parallel_serving,
)

BASE = dict(num_slots=3, max_len=64, prefill_chunk=8)
SMALL = dict(BASE, num_slots=2)
SHORT = dict(budgets=(5, 5, 3, 3))
# six requests through one slot, each with a deadline and a TTFT SLO;
# rank 0's clock advances 10 ms a read, rank 1's 50 ms
LOCKSTEP = dict(
    engine=dict(num_slots=1, max_len=64, prefill_chunk=8),
    trace=dict(lens=(5, 11, 3, 17, 9, 4), budgets=(6, 6, 4, 4, 5, 3),
               temps=(0.0, 0.7, 0.0, 1.1, 0.0, 0.5), deadline_s=0.5,
               slo_ttft_s=0.8),
    clock_steps=(0.01, 0.05))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name, jm, cfg in (("gpt2", jg, jg.GPT2Config.tiny()),
                          ("llama", jl, jl.LlamaConfig.tiny())):
        pj = jm.init_params(cfg, jax.random.key(0))
        out[name] = (cfg, pj, jax.tree_util.tree_map(np.asarray, pj))
    return out


def _jax_trace(engine, cfg, budgets=(6, 6, 4, 4),
               temps=(0.0, 0.7, 0.0, 1.1)):
    """The reference's trace (`tests/test_pod.py` `_run_trace`)."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 11, 3, 17)]
    reqs = [engine.submit(prompts[0], max_new_tokens=budgets[0],
                          temperature=temps[0])]
    for _ in range(3):
        engine.step()
    for p, b, t in zip(prompts[1:], budgets[1:], temps[1:]):
        reqs.append(engine.submit(p, max_new_tokens=b, temperature=t))
    engine.run_until_idle()
    return [list(r.tokens) for r in reqs]


def _jec(**kw):
    return JConfig(**dict(kw, cache_dtype=jnp.float32))


@pytest.fixture(scope="module")
def jax_streams(weights):
    g_cfg, g_p, _ = weights["gpt2"]
    l_cfg, l_p, _ = weights["llama"]
    return {
        "gpt2": _jax_trace(JEngine(jg, g_cfg, g_p, _jec(**BASE)), g_cfg),
        "gpt2_tp2": _jax_trace(j_sharded(jg, g_cfg, g_p, _jec(**BASE),
                                         mesh=j_mesh(2)), g_cfg),
        "llama": _jax_trace(JEngine(jl, l_cfg, l_p, _jec(**BASE)), l_cfg),
        "llama_small": _jax_trace(JEngine(jl, l_cfg, l_p, _jec(**SMALL)),
                                  l_cfg, **SHORT),
        "llama_small_pages11": _jax_trace(
            JEngine(jl, l_cfg, l_p, _jec(**SMALL, num_pages=11)), l_cfg,
            **SHORT),
    }


def _jobs(weights):
    """The worlds' jobs; every engine (and pod router) runs the serving
    sanitizer after each step, over its rank's local pool."""
    g, l_ = weights["gpt2"][2], weights["llama"][2]
    two = [
        dict(name="gpt2_tp2", family="gpt2", params=g, engine=BASE,
             kind="sharded", tp=2),
        dict(name="llama_tp2", family="llama", params=l_, engine=BASE,
             kind="sharded", tp=2),
        dict(name="llama_tp2_int8", family="llama", params=l_,
             engine=dict(BASE, kv_dtype="int8"), kind="sharded", tp=2),
        dict(name="gpt2_pod_tp2", family="gpt2", params=g, engine=BASE,
             kind="pod", tp=2),
        dict(name="lockstep", family="gpt2", params=g, kind="sharded", tp=2,
             **LOCKSTEP),
    ]
    four = [
        dict(name="llama_tp4", family="llama", params=l_, engine=SMALL,
             kind="sharded", tp=4, trace=SHORT),
        dict(name="llama_tp4_pages", family="llama", params=l_,
             engine=dict(SMALL, num_pages=11), kind="sharded", tp=4,
             trace=SHORT),
        dict(name="llama_pod_tp4_pages", family="llama", params=l_,
             engine=dict(SMALL, num_pages=11), kind="pod", tp=4,
             trace=SHORT),
        dict(name="llama_tp4_pages_int8", family="llama", params=l_,
             engine=dict(SMALL, num_pages=11, kv_dtype="int8"),
             kind="sharded", tp=4, trace=SHORT),
    ]
    for job in two + four:
        job["engine"] = dict(job.get("engine", BASE), sanitize=True)
    return two, four


@pytest.fixture(scope="module")
def worlds(weights):
    two, four = _jobs(weights)
    return {"jobs": {j["name"]: j for j in two + four},
            2: run_world(tensor_parallel_serving, 2, (two,)),
            4: run_world(tensor_parallel_serving, 4, (four,))}


def _greedy(streams, temps=(0.0, 0.7, 0.0, 1.1)):
    """The greedy requests' streams: the port draws its sampling noise
    from a counter hash, not JAX's threefry, so sampled streams are held
    against the port's single engine and greedy ones against JAX."""
    return [s for s, t in zip(streams, temps) if t == 0.0]


def _single(job, rank=0):
    return [list(r.tokens) for r in serve_job(dict(job, kind="single"),
                                              rank)[1]]


def _ranks(worlds, n, name):
    res = [r[name] for r in worlds[n]]
    for r in res[1:]:
        assert r == res[0]
    return res[0]


def test_gpt2_tp2_equals_jax_sharded_and_single(worlds, jax_streams):
    """The fused c_attn's column shard holds all of q and half of k on
    rank 0; the forward gathers and splits it, and the streams are the
    JAX sharded engine's, which are the single engine's."""
    res = _ranks(worlds, 2, "gpt2_tp2")
    assert jax_streams["gpt2_tp2"] == jax_streams["gpt2"]
    assert _greedy(res["tokens"]) == _greedy(jax_streams["gpt2_tp2"])
    assert res["tokens"] == _single(worlds["jobs"]["gpt2_tp2"])
    assert res["status"] == ["finished"] * 4
    assert res["compile_stats"] == {"admit": 1, "prefill": 1, "decode": 1}
    # gloo collectives pass through the host: nothing captured
    assert res["mesh"] and not res["graphs_captured"]
    # 4 heads over 2 ranks: each holds 2 heads' pages
    assert res["pool_spec"] == (None, None, None, "model")
    assert res["pool_shape"][3] == 2


def test_llama_tp2_and_int8_pool_shard_their_heads(worlds, jax_streams):
    res = _ranks(worlds, 2, "llama_tp2")
    assert _greedy(res["tokens"]) == _greedy(jax_streams["llama"])
    assert res["tokens"] == _single(worlds["jobs"]["llama_tp2"])
    assert res["pool_shape"][3] == 1           # 2 KV heads over 2 ranks
    q = _ranks(worlds, 2, "llama_tp2_int8")
    assert q["tokens"] == _single(worlds["jobs"]["llama_tp2_int8"])
    assert q["pool_spec"] == q["scale_spec"] == (None, None, None, "model")
    assert q["scale_shape"] == q["pool_shape"][:4]


def test_pod_tensor_parallel_2_equals_single_engine(worlds, jax_streams):
    res = _ranks(worlds, 2, "gpt2_pod_tp2")
    assert _greedy(res["tokens"]) == _greedy(jax_streams["gpt2"])
    assert res["tokens"] == _single(worlds["jobs"]["gpt2_pod_tp2"])
    assert res["shipments"] == 4.0
    assert res["compile_stats"] == {"admit": 1, "prefill": 1, "decode": 1,
                                    "extract": 1, "install": 1}


def test_skewed_clock_ranks_decide_in_lockstep(worlds):
    """Rank 1's clock runs five times faster; both ranks shed, admit and
    stream as one engine on rank 0's clock does, not as one on rank 1's,
    and the world ends (no rank waits in a collective the other never
    reached)."""
    job = worlds["jobs"]["lockstep"]
    res = _ranks(worlds, 2, "lockstep")
    eng0, on0 = serve_job(dict(job, kind="single"), 0)
    _, on1 = serve_job(dict(job, kind="single"), 1)
    assert res["tokens"] == [list(r.tokens) for r in on0]
    assert res["status"] == [r.status.value for r in on0]
    assert res["shed"] == [r.shed_code for r in on0]
    assert res["shed"] != [r.shed_code for r in on1]
    assert "finished" in res["status"] and "expired" in res["status"]


@pytest.mark.parametrize("name,ref,spec", [
    ("llama_tp4", "llama_small", ()),
    ("llama_tp4_pages", "llama_small_pages11", (None, "model")),
    ("llama_pod_tp4_pages", "llama_small_pages11", (None, "model")),
    ("llama_tp4_pages_int8", None, (None, "model"))])
def test_llama_tp4_nondividing_heads_stay_exact(worlds, jax_streams, name,
                                                ref, spec):
    """2 KV heads over 4 ranks: attention runs over every head, and the
    pool replicates, or shards its pages when pages + 1 divides 4."""
    res = _ranks(worlds, 4, name)
    if ref is not None:
        assert _greedy(res["tokens"]) == _greedy(jax_streams[ref])
    assert res["tokens"] == _single(worlds["jobs"][name])
    assert res["pool_spec"] == spec
    if spec:
        # a stripe of 12 / 4 pages, and one dump page
        assert res["pool_shape"][1] == 12 // 4 + 1
    if res["scale_shape"] is not None:     # int8: the scales shard alike
        assert res["scale_spec"] == spec
        assert res["scale_shape"] == res["pool_shape"][:4]
    assert res["compile_stats"]["decode"] == 1


def test_one_rank_mesh_degrades_to_single(weights):
    cfg = tg.GPT2Config.tiny()
    params = params_from_numpy(weights["gpt2"][2], device="cpu")
    ec = EngineConfig(**BASE, cache_dtype=torch.float32)
    ref = Engine(tg, cfg, params, ec, device="cpu")
    p = np.random.default_rng(31).integers(0, cfg.vocab_size,
                                           (7,)).astype(np.int32)
    r0 = ref.submit(p, max_new_tokens=5)
    ref.run_until_idle()
    eng = sharded_engine(tg, cfg, params, ec, tensor_parallel=1,
                         device="cpu")
    assert eng.engine_config.mesh is None      # normalised away
    r1 = eng.submit(p, max_new_tokens=5)
    eng.run_until_idle()
    assert r1.tokens == r0.tokens
    assert eng.compile_stats() == {"admit": 1, "prefill": 1, "decode": 1}


@pytest.mark.parametrize("family,n,extra,kv", [
    ("gpt2", 2, {}, None), ("gpt2", 3, {}, None), ("gpt2", 2, {}, "int8"),
    ("llama", 4, {"num_slots": 2, "num_pages": 11}, None),
    ("llama", 4, {"num_slots": 2, "num_pages": 10}, None)])
def test_cache_state_shardings_equal_jax(weights, family, n, extra, kv):
    cfg, pj, pn = weights[family]
    tm = {"gpt2": tg, "llama": tl}[family]
    jm = {"gpt2": jg, "llama": jl}[family]
    tcfg = {"gpt2": tg.GPT2Config, "llama": tl.LlamaConfig}[family].tiny()
    kw = dict(BASE, **extra, kv_dtype=kv)
    jeng = JEngine(jm, cfg, pj, _jec(**kw))
    jsh, jrep = j_cache_sh(jeng.cache, j_mesh(n))
    teng = Engine(tm, tcfg, params_from_numpy(pn, device="cpu"),
                  EngineConfig(**kw, cache_dtype=torch.float32),
                  device="cpu")
    tsh, trep = cache_state_shardings(teng.cache, ProcessMesh({"model": n}))
    assert tuple(tsh.k.spec) == tuple(jsh.k.spec)
    assert tuple(tsh.v.spec) == tuple(jsh.v.spec)
    assert tuple(tsh.lengths.spec) == tuple(jsh.lengths.spec) == ()
    assert tuple(trep.spec) == tuple(jrep.spec) == ()
    if kv is not None:
        assert tuple(tsh.k_scale.spec) == tuple(jsh.k_scale.spec) \
            == tuple(tsh.k.spec)
