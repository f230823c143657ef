"""The port's big-model inference (`accelerate_tpu_torch.big_modeling`,
`utils/modeling.py`, `utils/offload.py`, `utils/memory.py`) against the
JAX package's, on the same numpy weights, with the reference's cases
(tests/test_big_modeling.py) run on the port.

Tolerances, with their reasons:
- device maps, module sizes, balanced caps, offload files and indexes:
  equal (integers, names and bytes);
- streamed greedy tokens (every causal family and T5's hybrid) against
  the JAX package's streamed decode and the port's resident `generate`:
  equal;
- streamed logits in f32 against the JAX package's: rtol 2e-4, atol 2e-4
  (the reference's own bound for its offloaded forward: the same f32
  products, summed in another order); against the port's resident
  forward on the same tiers: equal, the same products in the same order.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import big_modeling as jbm
from accelerate_tpu.checkpointing import save_model as jsave_model
from accelerate_tpu.utils import modeling as jmod
from accelerate_tpu.utils import offload as joff
from accelerate_tpu_torch import big_modeling as tbm
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.utils import memory as tmem
from accelerate_tpu_torch.utils import modeling as tmod
from accelerate_tpu_torch.utils import offload as toff
from accelerate_tpu_torch.utils.other import flatten_dict

L, D, V = 6, 8, 32
RTOL = ATOL = 2e-4
FAMILIES = {"llama": "LlamaConfig", "gpt2": "GPT2Config",
            "gptj": "GPTJConfig", "gpt_neox": "GPTNeoXConfig",
            "opt": "OPTConfig"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_numpy(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "embed": {"embedding": rng.normal(size=(V, D)).astype(np.float32)},
        "layers": {
            "w1": rng.normal(size=(L, D, 4 * D)).astype(np.float32) * 0.3,
            "w2": rng.normal(size=(L, 4 * D, D)).astype(np.float32) * 0.3,
        },
        "head": {"kernel": rng.normal(size=(D, V)).astype(np.float32)},
    }


def _tiny_abstract():
    """The tiny tree on the meta device (its init runs under meta)."""
    return tbm.init_empty_weights(lambda: {
        "embed": {"embedding": torch.empty(V, D)},
        "layers": {"w1": torch.empty(L, D, 4 * D),
                   "w2": torch.empty(L, 4 * D, D)},
        "head": {"kernel": torch.empty(D, V)},
    })


def _jabstract():
    return jax.eval_shape(lambda: jax.tree_util.tree_map(
        jnp.asarray, _tiny_numpy()))


def _embed(res, ids):
    return res["embed"]["embedding"][ids]


def _layer(layer, x, i):
    return x + torch.tanh(x @ layer["w1"]) @ layer["w2"]


def _final(res, x):
    return x @ res["head"]["kernel"]


def _tiny_forward(params, ids):
    x = params["embed"]["embedding"][ids]
    for i in range(L):
        x = _layer({k: v[i] for k, v in params["layers"].items()}, x, i)
    return x @ params["head"]["kernel"]


def _three_tiers():
    dmap = {"embed": 0, "head": 0}
    dmap.update({f"layers.{i}": 0 if i < 2 else ("cpu" if i < 4 else "disk")
                 for i in range(L)})
    return dmap


# --- meta init --------------------------------------------------------------


def test_init_empty_weights_allocates_nothing():
    from accelerate_tpu_torch.models import llama

    abstract = _tiny_abstract()
    assert abstract["layers"]["w1"].is_meta
    assert abstract["layers"]["w1"].shape == (L, D, 4 * D)
    # llama3-8B in f32 would be 32 GB: on meta it is shapes only
    tree = tbm.init_empty_weights(llama.init_params,
                                  llama.LlamaConfig.llama3_8b(), 0)
    leaves = flatten_dict(tree).values()
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == 8_030_261_248
    # outside the context the device rule is back
    with pytest.raises(ValueError, match="unsupported device"):
        llama.init_params(llama.LlamaConfig.tiny(), 0, device="meta")


def test_init_on_device():
    with tbm.init_on_device("meta"):
        assert torch.empty(3).is_meta
    with tbm.init_on_device("cpu"):
        assert torch.empty(3).device.type == "cpu"


# --- device maps ------------------------------------------------------------


def test_module_sizes_and_stacked_modules_match_reference():
    t, j = _tiny_abstract(), _jabstract()
    assert tmod.find_stacked_modules(t) == jmod.find_stacked_modules(j)
    assert tmod.compute_module_sizes(t) == jmod.compute_module_sizes(j)
    assert tmod.compute_module_sizes(t, dtype=torch.bfloat16) == \
        jmod.compute_module_sizes(j, dtype=jnp.bfloat16)
    assert tmod.dtype_byte_size(torch.bfloat16) == 2
    assert tmod.dtype_byte_size("int4") == 0.5


@pytest.mark.parametrize("budget_layers", [0, 3, 5, 6])
def test_infer_auto_device_map_matches_reference(budget_layers):
    t, j = _tiny_abstract(), _jabstract()
    sizes = jmod.compute_module_sizes(j)
    budget = (sizes["embed"] + sizes["head"]
              + budget_layers * sizes["layers.0"] + 100)
    mm = {0: budget, "cpu": 2 * sizes["layers.0"] + 10}
    got = tmod.infer_auto_device_map(t, max_memory=mm)
    assert list(got.items()) == list(
        jmod.infer_auto_device_map(j, max_memory=mm).items())
    assert tmod.infer_auto_device_map(
        t, max_memory=mm, no_split_modules=("layers",)) == \
        jmod.infer_auto_device_map(j, max_memory=mm,
                                   no_split_modules=("layers",))


def test_llama3_8b_map_of_the_chip_phase_matches_reference():
    """The map `chip_smoke.py` phase big_model plans: full width and
    depth, bf16, 8 GiB of card and 6 GiB of host."""
    from accelerate_tpu.models import llama as jllama
    from accelerate_tpu_torch.models import llama as tllama

    mm = {0: "8GiB", "cpu": "6GiB"}
    jtree = jax.eval_shape(lambda: jllama.init_params(
        jllama.LlamaConfig.llama3_8b(), jax.random.key(0)))
    ttree = tbm.init_empty_weights(tllama.init_params,
                                   tllama.LlamaConfig.llama3_8b(), 0)
    got = tmod.infer_auto_device_map(ttree, max_memory=mm,
                                     dtype=torch.bfloat16)
    assert list(got.items()) == list(jmod.infer_auto_device_map(
        jtree, max_memory=mm, dtype=jnp.bfloat16).items())
    rows = [got[f"layers.{i}"] for i in range(32)]
    assert {rows.count(t) for t in (0, "cpu", "disk")} == {17, 14, 1}


def test_get_max_memory_parses_strings():
    mm = tmod.get_max_memory({0: "1GiB", "cpu": "500MB"})
    assert mm == jmod.get_max_memory({0: "1GiB", "cpu": "500MB"})
    assert mm[0] == 2**30 and mm["cpu"] == 500 * 10**6
    cpu = tmod.get_max_memory(device="cpu")
    assert cpu[0] > 0 and cpu["cpu"] > 0 and cpu["disk"] == 2**62


@pytest.mark.parametrize("low_zero", [False, True])
def test_get_balanced_memory_matches_reference(low_zero):
    t, j = _tiny_abstract(), _jabstract()
    big = 100 * jmod.compute_module_sizes(j)[""]
    mm = {0: big, 1: big, 2: big, 3: big}
    got = tmod.get_balanced_memory(t, max_memory=mm, low_zero=low_zero)
    assert got == jmod.get_balanced_memory(j, max_memory=mm,
                                           low_zero=low_zero)
    assert got[3] == big and got[0] < big
    if low_zero:
        assert got[0] < got[1]
    dmap = tmod.infer_auto_device_map(t, max_memory=got)
    assert len(set(dmap.values()) - {"cpu", "disk"}) >= 2


@pytest.mark.parametrize("dmap,match", [
    ({"embed": 0, "head": 0, "layers.0": 0}, "addressed per-row"),
    ({"embed.0": 0, "head": 0, "layers": 0}, "not a stacked"),
    ({"embed": 0, "layers": 0}, "not covered"),
    ({"embed": 0, "head": 0, "layers": 0, "nothing": 0}, "match no params"),
])
def test_bad_maps_rejected_alike(dmap, match):
    jparams = jax.tree_util.tree_map(jnp.asarray, _tiny_numpy())
    tparams = params_from_numpy(_tiny_numpy(), device="cpu")
    with pytest.raises(ValueError, match=match):
        jbm.dispatch_model(jparams, dmap)
    with pytest.raises(ValueError, match=match):
        tbm.dispatch_model(tparams, dmap, device="cpu")


# --- offload folders --------------------------------------------------------


def _offload_tensors():
    import ml_dtypes

    rng = np.random.default_rng(3)
    return {
        "w.f32": rng.normal(size=(3, 5)).astype(np.float32),
        "w.bf16": rng.normal(size=(2, 7)).astype(ml_dtypes.bfloat16),
        "w.f16": rng.normal(size=(4,)).astype(np.float16),
        "n.i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "n.i8": np.array([-3, 4], dtype=np.int8),
        "s.rank0": np.float32(3.5),
        "s.bool": np.array([True, False]),
    }


def _dat_bytes(folder):
    return {f: open(os.path.join(folder, f), "rb").read()
            for f in sorted(os.listdir(folder))}


def test_offload_folders_are_the_same_bytes(tmp_path):
    sd = _offload_tensors()
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jidx = joff.offload_state_dict(jdir, sd)
    tidx = toff.offload_state_dict(tdir, sd)
    assert tidx == jidx
    assert _dat_bytes(tdir) == _dat_bytes(jdir)    # index.json included


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_offload_folder_read_by_the_other_package(tmp_path, writer):
    sd = _offload_tensors()
    folder = str(tmp_path)
    if writer == "jax":
        joff.offload_state_dict(folder, sd)
        loader = toff.OffloadedWeightsLoader(offload_folder=folder)
        for name, want in sd.items():
            got = loader[name]
            assert isinstance(got, torch.Tensor)
            assert tuple(got.shape) == np.shape(want)
            if str(np.asarray(want).dtype) == "bfloat16":
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(),
                    np.asarray(want).view(np.int16))
            else:
                np.testing.assert_array_equal(got.numpy(), want)
    else:
        toff.offload_state_dict(folder, params_from_numpy(
            {k.replace(".", "_"): v for k, v in sd.items()}, device="cpu"))
        loader = joff.OffloadedWeightsLoader(offload_folder=folder)
        for name, want in sd.items():
            got = np.asarray(loader[name.replace(".", "_")])
            assert got.shape == np.shape(want)
            assert got.dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got, want)


def test_offloaded_weights_loader(tmp_path):
    sd = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
          "b": torch.ones(4, dtype=torch.int32)}
    toff.offload_state_dict(str(tmp_path), sd)
    loader = toff.OffloadedWeightsLoader(state_dict={"c": torch.zeros(2)},
                                         offload_folder=str(tmp_path))
    assert set(loader) == {"a", "b", "c"} and len(loader) == 3
    assert torch.equal(loader["a"], sd["a"])
    sub = toff.extract_submodule_offload_index(
        toff.load_offload_index(str(tmp_path)), "a")
    assert sub == joff.extract_submodule_offload_index(
        joff.load_offload_index(str(tmp_path)), "a") == {
        "a": {"dtype": "float32", "shape": [2, 3]}}
    # a write to the mapped tensor never reaches the file
    loaded = loader["a"]
    loaded += 1
    assert torch.equal(toff.OffloadedWeightsLoader(
        offload_folder=str(tmp_path))["a"], sd["a"])


def test_scalar_offload_roundtrip(tmp_path):
    idx = {}
    toff.offload_weight(torch.tensor(3.0), "s", str(tmp_path), idx)
    back = toff.load_offloaded_weight(str(tmp_path / "s.dat"), idx["s"])
    assert back.shape == () and float(back) == 3.0


# --- dispatch and streamed forward ------------------------------------------


def test_dispatch_rowgroups_on_three_tiers_and_streamed_forward(tmp_path):
    tree = _tiny_numpy()
    tparams = params_from_numpy(tree, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    off = tbm.dispatch_model(tparams, _three_tiers(),
                             offload_folder=str(tmp_path / "t"),
                             device="cpu")
    w1 = off["layers"]["w1"]
    assert isinstance(w1, tbm.RowGroups)
    assert w1.tiers == ["device", "cpu", "disk"]
    assert [(s, e) for s, e, _ in w1.groups] == [(0, 2), (2, 4), (4, 6)]
    assert torch.equal(w1.row(3), tparams["layers"]["w1"][3])
    assert "disk" in repr(w1)
    # the disk rows' files and index are the reference's
    jbm.dispatch_model(jparams, _three_tiers(),
                       offload_folder=str(tmp_path / "j"))
    assert _dat_bytes(str(tmp_path / "t")) == _dat_bytes(str(tmp_path / "j"))

    ids = np.arange(8)[None]
    want = jbm.streamed_forward(
        jbm.dispatch_model(jparams, _three_tiers(),
                           offload_folder=str(tmp_path / "j2")),
        jnp.asarray(ids), embed_fn=lambda r, i: r["embed"]["embedding"][i],
        layer_fn=lambda layer, x, i: x + jnp.tanh(x @ layer["w1"])
        @ layer["w2"], final_fn=lambda r, x: x @ r["head"]["kernel"])
    got = tbm.streamed_forward(off, torch.from_numpy(ids), _embed, _layer,
                               _final, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(got, _tiny_forward(tparams, torch.from_numpy(ids)))


def test_cpu_and_disk_offload(tmp_path):
    tparams = params_from_numpy(_tiny_numpy(), device="cpu")
    off = tbm.cpu_offload(tparams, keep_modules=("head",), device="cpu")
    assert off["head"]["kernel"] is tparams["head"]["kernel"]
    assert torch.equal(off["embed"]["embedding"],
                       tparams["embed"]["embedding"])
    doff = tbm.disk_offload(tparams, str(tmp_path), keep_modules=("embed",),
                            device="cpu")
    idx = toff.load_offload_index(str(tmp_path))
    assert "layers.w1" in idx and "embed.embedding" not in idx
    assert torch.equal(doff["layers"]["w1"], tparams["layers"]["w1"])


def test_sharded_dispatch_is_device_zero_and_raises_on_several(monkeypatch):
    tparams = params_from_numpy(_tiny_numpy(), device="cpu")
    for mode in ("sharded", None):
        out = tbm.dispatch_model(tparams, mode, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            flatten_dict(out).values(), flatten_dict(tparams).values()))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError,
                       match="one process on a device"):
        tbm.dispatch_model(tparams, "sharded", device="cpu")


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tparams = params_from_numpy(_tiny_numpy(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbm.dispatch_model(tparams, _three_tiers(),
                           offload_folder=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbm.streamed_forward(tparams, torch.zeros(1, 2, dtype=torch.long),
                             _embed, _layer, _final)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmod.get_max_memory()
    from accelerate_tpu_torch import inference
    from accelerate_tpu_torch.state import ProcessMesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.prepare_pipeline(lambda layer, x: x, tparams["layers"],
                                   mesh=ProcessMesh({"stage": 2}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.prepare_sharded_inference(lambda p, x: x, tparams,
                                            mesh=ProcessMesh({"model": 1}))


# --- checkpoints ------------------------------------------------------------


def test_load_checkpoint_and_dispatch_roundtrip(tmp_path, monkeypatch):
    tree = _tiny_numpy()
    jsave_model(jax.tree_util.tree_map(jnp.asarray, tree),
                str(tmp_path / "ckpt"))
    abstract = _tiny_abstract()
    loaded, _ = tmod.load_checkpoint_in_model(abstract,
                                              str(tmp_path / "ckpt"))
    assert torch.equal(loaded["head"]["kernel"],
                       torch.from_numpy(tree["head"]["kernel"]))
    # the tiers are read by byte range: no tensor is read whole
    from accelerate_tpu_torch.utils import safetensors as st

    def whole(*a, **k):
        raise AssertionError("read a whole file")

    monkeypatch.setattr(st, "iter_file", whole)
    dmap = {"embed": 0, "head": "cpu"}
    dmap.update({f"layers.{i}": "cpu" if i % 2 else "disk"
                 for i in range(L)})
    off = tbm.load_checkpoint_and_dispatch(
        abstract, str(tmp_path / "ckpt"), device_map=dmap,
        offload_folder=str(tmp_path / "off"), device="cpu")
    ids = torch.arange(4)[None]
    want = _tiny_forward(params_from_numpy(tree, device="cpu"), ids)
    got = tbm.streamed_forward(off, ids, _embed, _layer, _final,
                               device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert os.path.exists(str(tmp_path / "off" / "index.json"))
    # "auto" under a small card budget spills to the host and disk alike
    sizes = tmod.compute_module_sizes(abstract, dtype=torch.bfloat16)
    mm = {0: sizes["embed"] + sizes["head"] + 2 * sizes["layers.0"],
          "cpu": 2 * sizes["layers.0"]}
    auto = tbm.load_checkpoint_and_dispatch(
        abstract, str(tmp_path / "ckpt"), max_memory=mm,
        offload_folder=str(tmp_path / "auto"), dtype=torch.bfloat16,
        device="cpu")
    assert auto["layers"]["w1"].tiers == ["device", "cpu", "disk"]
    assert auto["layers"]["w1"].dtype == torch.bfloat16
    assert torch.equal(auto["layers"]["w1"].row(5),
                       torch.from_numpy(tree["layers"]["w1"][5]).to(
                           torch.bfloat16))


def test_load_checkpoint_shape_mismatch_raises(tmp_path):
    jsave_model(jax.tree_util.tree_map(jnp.asarray, _tiny_numpy()),
                str(tmp_path / "ckpt"))
    bad = _tiny_abstract()
    bad["head"]["kernel"] = torch.empty(D, V + 1, device="meta")
    with pytest.raises(ValueError, match="shape mismatch"):
        tmod.load_checkpoint_in_model(bad, str(tmp_path / "ckpt"))


def test_torch_bin_import(tmp_path):
    sd = {"embed.embedding": torch.randn(V, D), "head.kernel": torch.randn(D, V)}
    path = tmp_path / "pytorch_model.bin"
    torch.save(sd, str(path))
    out = tmod.load_state_dict(str(path))
    assert out["embed.embedding"].shape == (V, D)
    assert torch.equal(out["head.kernel"], sd["head.kernel"])


@pytest.mark.parametrize("bits", [8, 4])
def test_load_and_quantize_params_matches_reference(tmp_path, bits):
    from accelerate_tpu.models import llama as jllama
    from accelerate_tpu.ops import quant as jq
    from accelerate_tpu.utils.dataclasses import QuantizationConfig as JQC
    from accelerate_tpu_torch.models import llama as tllama
    from accelerate_tpu_torch.ops import quant as tq
    from accelerate_tpu_torch.utils.dataclasses import QuantizationConfig

    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(1))
    jsave_model(jparams, str(tmp_path))
    kw = dict(load_in_8bit=bits == 8, load_in_4bit=bits == 4, block_size=32)
    ref = jbm.load_and_quantize_params(
        jax.eval_shape(lambda: jparams), str(tmp_path), JQC(**kw),
        device_put=False)
    got = tbm.load_and_quantize_params(
        tbm.init_empty_weights(tllama.init_params,
                               tllama.LlamaConfig.tiny(), 0),
        str(tmp_path), QuantizationConfig(**kw), device="cpu")
    jflat, tflat = jmod.flatten_dict(ref), flatten_dict(got)
    assert jflat.keys() == tflat.keys()
    for k, want in jflat.items():
        have = tflat[k]
        assert isinstance(have, tq.QuantizedTensor) == isinstance(
            want, jq.QuantizedTensor), k
        if isinstance(want, jq.QuantizedTensor):
            np.testing.assert_array_equal(have.data.numpy(),
                                          np.asarray(want.data))
            np.testing.assert_array_equal(
                have.scales.view(torch.int16).numpy(),
                np.asarray(want.scales).view(np.int16))
        else:
            np.testing.assert_array_equal(have.numpy(), np.asarray(want))
    assert tq.quantized_nbytes(got) == jq.quantized_nbytes(ref)


# --- streamed decode --------------------------------------------------------


def _perturbed(tree, rng):
    """Norm scales and biases off their one and zero inits, so a skipped
    final norm would flip tokens."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k in ("bias", "scale"):
            out[k] = (v + rng.uniform(0.1, 0.9, size=v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _family(name, seed):
    jm = importlib.import_module(f"accelerate_tpu.models.{name}")
    tm = importlib.import_module(f"accelerate_tpu_torch.models.{name}")
    cls = FAMILIES.get(name, "T5Config")
    jcfg, tcfg = getattr(jm, cls).tiny(), getattr(tm, cls).tiny()
    tree = _perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init_params(jcfg, jax.random.key(seed))),
        np.random.default_rng(seed))
    return (jm, tm, jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _split_map(params, n, stacked="layers"):
    """The resident modules on the device, the stacked rows over device,
    host and disk."""
    dmap = {k: 0 for k in params if k != stacked}
    third = max(1, n // 3)
    dmap.update({f"{stacked}.{i}": 0 if i < third else (
        "cpu" if i < n - 1 else "disk") for i in range(n)})
    return dmap


@pytest.mark.parametrize("family", list(FAMILIES))
def test_streamed_generate_matches_reference_and_generate(family, tmp_path):
    jm, tm, jcfg, tcfg, jparams, tparams = _family(family, 40)
    ids = np.full((2, 5), 3, np.int32)
    want = np.asarray(jm.streamed_generate(
        jcfg, jbm.cpu_offload(jparams), jnp.asarray(ids), max_new_tokens=6,
        dtype=jnp.float32))
    np.testing.assert_array_equal(want, np.asarray(jm.generate(
        jcfg, jparams, jnp.asarray(ids), max_new_tokens=6)))
    tids = torch.from_numpy(ids).long()
    n = tcfg.num_hidden_layers
    off = tbm.dispatch_model(tparams, _split_map(tparams, n),
                             offload_folder=str(tmp_path), device="cpu")
    got = tm.streamed_generate(tcfg, off, tids, max_new_tokens=6,
                               dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tm.generate(tcfg, tparams, tids,
                                        max_new_tokens=6))
    # sampling draws the same stream as generate's
    hot = dict(max_new_tokens=6, temperature=0.8, key=11)
    assert torch.equal(
        tm.streamed_generate(tcfg, off, tids, dtype=torch.float32,
                             device="cpu", **hot),
        tm.generate(tcfg, tparams, tids, **hot))


def test_llama_streamed_generate_at_depth_over_three_tiers(tmp_path):
    """Four layers, so device, host and disk each hold a row."""
    from accelerate_tpu.models import llama as jllama
    from accelerate_tpu_torch.models import llama as tllama

    jcfg = jllama.LlamaConfig.tiny(num_hidden_layers=4)
    tcfg = tllama.LlamaConfig.tiny(num_hidden_layers=4)
    tree = _perturbed(jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.key(5))),
        np.random.default_rng(5))
    tparams = params_from_numpy(tree, device="cpu")
    off = tbm.dispatch_model(tparams, _split_map(tparams, 4),
                             offload_folder=str(tmp_path), device="cpu")
    assert off["layers"]["attn"]["q_proj"]["kernel"].tiers == [
        "device", "cpu", "disk"]
    ids = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    want = np.asarray(jllama.generate(jcfg, jax.tree_util.tree_map(
        jnp.asarray, tree), jnp.asarray(ids), max_new_tokens=7))
    got = tllama.streamed_generate(tcfg, off, torch.from_numpy(ids).long(),
                                   max_new_tokens=7, dtype=torch.float32,
                                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_t5_streamed_generate_matches_reference_and_generate():
    jm, tm, jcfg, tcfg, jparams, tparams = _family("t5", 43)
    ids = np.full((2, 6), 5, np.int32)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    want = np.asarray(jm.streamed_generate(
        jcfg, jbm.cpu_offload(jparams), jnp.asarray(ids), max_new_tokens=5,
        attention_mask=jnp.asarray(mask), dtype=jnp.float32))
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    got = tm.streamed_generate(tcfg, tbm.cpu_offload(tparams, device="cpu"),
                               tids, max_new_tokens=5, attention_mask=tmask,
                               dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tm.generate(tcfg, tparams, tids,
                                        max_new_tokens=5,
                                        attention_mask=tmask))


def test_llama_forward_offloaded_matches_reference(tmp_path):
    from accelerate_tpu.models import llama as jllama
    from accelerate_tpu_torch.models import llama as tllama

    jcfg = jllama.LlamaConfig.tiny(num_hidden_layers=4)
    tcfg = tllama.LlamaConfig.tiny(num_hidden_layers=4)
    tree = _perturbed(jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.key(0))),
        np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    ids = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)
    dmap = _split_map(tparams, 4)
    want = jllama.forward_offloaded(
        jcfg, jbm.dispatch_model(jparams, dmap,
                                 offload_folder=str(tmp_path / "j")),
        jnp.asarray(ids), dtype=jnp.float32)
    off = tbm.dispatch_model(tparams, dmap, offload_folder=str(tmp_path / "t"),
                             device="cpu")
    tids = torch.from_numpy(ids).long()
    got = tllama.forward_offloaded(tcfg, off, tids, dtype=torch.float32,
                                   device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(got, tllama.forward(tcfg, tparams, tids))


# --- memory helpers ---------------------------------------------------------


def test_find_executable_batch_size_halves_on_oom():
    tried = []

    @tmem.find_executable_batch_size(starting_batch_size=128)
    def run(batch_size, scale):
        tried.append(batch_size)
        if batch_size > 16:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return batch_size * scale

    assert run(2) == 32
    assert tried == [128, 64, 32, 16]
    # the card's error class itself, whatever its message
    assert tmem.should_reduce_batch_size(torch.cuda.OutOfMemoryError("x"))


@pytest.mark.parametrize("error,oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), True),
    (MemoryError(), True),
    (RuntimeError("RESOURCE_EXHAUSTED: Attempting to reserve 2G"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate"), True),
    (ValueError("shape mismatch"), False),
])
def test_should_reduce_batch_size_matches_reference(error, oom):
    from accelerate_tpu.utils import memory as jmem

    assert tmem.should_reduce_batch_size(error) is oom
    assert jmem.should_reduce_batch_size(error) is oom


def test_find_executable_batch_size_errors():
    @tmem.find_executable_batch_size(starting_batch_size=4)
    def never(batch_size):
        raise RuntimeError("out of memory")

    with pytest.raises(RuntimeError, match="reached zero"):
        never()

    @tmem.find_executable_batch_size(starting_batch_size=4)
    def other(batch_size):
        raise KeyError("not memory")

    with pytest.raises(KeyError):
        other()

    @tmem.find_executable_batch_size
    def takes(batch_size, x):
        return x

    with pytest.raises(TypeError, match="Remove this"):
        takes(8, 1)


def test_release_memory_and_free_memory():
    from accelerate_tpu_torch.state import PartialState

    a, b = tmem.release_memory(torch.ones(3), torch.ones(2))
    assert a is None and b is None
    assert tmem.get_device_memory_stats() == {}
    PartialState._reset_state()
    acc = Accelerator(cpu=True)
    acc.step = 5
    loader = acc.prepare([{"x": torch.ones(2)}])
    assert acc._dataloaders == [loader]
    (x,) = acc.free_memory(loader)
    assert x is None and acc.step == 0 and acc._dataloaders == []
    assert acc.clear(1) == [None]
    PartialState._reset_state()


def test_package_exports():
    import accelerate_tpu_torch as pkg

    for name in ("init_empty_weights", "infer_auto_device_map",
                 "get_balanced_memory", "get_max_memory",
                 "load_checkpoint_and_dispatch", "dispatch_model",
                 "find_executable_batch_size", "release_memory"):
        assert callable(getattr(pkg, name)), name


def test_offload_index_json_is_the_reference_text(tmp_path):
    index = {"a": {"dtype": "bfloat16", "shape": [2, 3]}}
    toff.save_offload_index(index, str(tmp_path / "t"))
    joff.save_offload_index(index, str(tmp_path / "j"))
    assert (open(tmp_path / "t" / "index.json").read()
            == open(tmp_path / "j" / "index.json").read())
    assert json.loads(open(tmp_path / "t" / "index.json").read()) == index
