"""Data parallelism in the port against the JAX package:

- one SGD step of `LlamaConfig.tiny()` by two real processes (the
  bundled `test_grad_parity.py` through the launcher, gloo on the CPU),
  each on half of the global batch with the gradients averaged, against
  the JAX package's single-device `jax.grad` step on the same weights
  (carried across by `params_from_numpy`) and the same batch, at
  rtol=1e-4, atol=1e-6, as `accelerate_tpu/test_utils/scripts/
  test_grad_parity.py` holds its world;
- the fused bf16 step of `train_llama_dp.py` at two processes against
  one: bit-identical replicas, the same losses on both ranks, step 1's
  loss equal to one process's to f32 rounding (1e-6 relative);
- `gather_for_metrics`'s trim of a padded final batch against the
  reference's on the same gathered rows (both layouts);
- two fp8 steps by two processes: bit-identical metas and params on
  both ranks, step 1's metas the JAX package's on the global batch; one
  fp8 projection's gradients by two processes against one process's on
  the whole batch (the backward's scale from the amax across ranks);
- `LocalSGD` and a checkpoint written by a two-process world (read back
  in one process).
"""

import os

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu as at
from accelerate_tpu.models import llama as jl
from accelerate_tpu.utils import operations as jops
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.test_utils import bundled_script_path, \
    execute_subprocess, launch_command_for, run_world
from accelerate_tpu_torch.utils import operations as tops
from accelerate_tpu_torch.utils.other import flatten_dict

LR = 0.1   # the bundled script's


@pytest.fixture(autouse=True)
def _fresh_state():
    PartialState._reset_state()
    at.PartialState._reset_state()
    yield
    PartialState._reset_state()
    at.PartialState._reset_state()


def _fixed_batch(vocab: int, rows: int) -> np.ndarray:
    rng = np.random.default_rng(1234)   # the bundled script's batch
    return rng.integers(0, vocab, (rows, 33)).astype(np.int32)


def test_two_rank_step_matches_the_jax_single_device_step(tmp_path):
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in flatten_dict(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    np.savez(tmp_path / "init.npz", **flat)
    ids = _fixed_batch(cfg.vocab_size, 4)
    grads = jax.grad(lambda p: jl.causal_lm_loss(
        cfg, p, {"input_ids": ids}))(params)
    want = {k: np.asarray(v) for k, v in flatten_dict(jax.tree_util.tree_map(
        lambda p, g: np.asarray(p) - LR * np.asarray(g), params,
        grads)).items()}

    out = execute_subprocess(
        [*launch_command_for(bundled_script_path("test_grad_parity.py"), 2,
                             ["--cpu"]),
         "--params", str(tmp_path / "init.npz"),
         "--save", str(tmp_path / "stepped.npz")], timeout=300)
    assert "ALL CHECKS PASSED (2 process(es))" in out
    with np.load(tmp_path / "stepped.npz") as got:
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def _dp_results(n: int) -> list:
    out = execute_subprocess(
        [*launch_command_for(bundled_script_path("train_llama_dp.py"), n,
                             ["--cpu"]),
         "--config", "tiny", "--steps", "3", "--rows", "4", "--seq", "33"],
        timeout=300)
    import json

    return sorted((json.loads(line.split(" ", 1)[1])
                   for line in out.splitlines()
                   if line.startswith("DP_RESULT ")),
                  key=lambda r: r["rank"])


def test_fused_bf16_step_two_ranks_against_one(monkeypatch):
    import importlib.util

    from accelerate_tpu_torch.utils.constants import ENV_CPU

    two = _dp_results(2)
    # the world of one in this process
    spec = importlib.util.spec_from_file_location(
        "bundled_train_llama_dp", bundled_script_path("train_llama_dp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setenv(ENV_CPU, "1")
    one = mod.main(["--config", "tiny", "--steps", "3", "--rows", "4",
                    "--seq", "33"])
    assert [r["world"] for r in two] == [2, 2]
    assert [r["batch_rows"] for r in two] == [2, 2] and one["batch_rows"] == 4
    assert all(r["identical_to_rank0"] and r["backend"] == "gloo"
               for r in two)
    assert two[0]["losses"] == two[1]["losses"]
    assert abs(two[0]["losses"][0] - one["losses"][0]) <= \
        1e-6 * abs(one["losses"][0])
    assert two[0]["losses"][-1] < two[0]["losses"][0]


def _meta_leaves(tree, path=""):
    """(path, scale, amax_history) of every Fp8Meta of a numpy fp8 state
    (either package's)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _meta_leaves(tree[k], f"{path}.{k}")
    elif tree is not None:
        yield path, np.asarray(tree.scale), np.asarray(tree.amax_history)


def test_fp8_step_two_ranks_hold_the_global_batch_metas(tmp_path):
    """Two fp8 steps by two ranks, each on half of every global batch:
    both ranks hold bit-identical metas and params, and step 1's metas
    are the JAX package's single-device step's on the global batch,
    held as `test_torch_fp8.py` holds the one-process step."""
    import pickle

    import optax

    cfg = jl.LlamaConfig.tiny()
    pn = jax.tree_util.tree_map(np.asarray,
                                jl.init_params(cfg, jax.random.key(0)))
    batches = [np.random.default_rng(i).integers(0, 256, (8, 17)).astype(
        np.int32) for i in range(2)]
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump((pn, batches), f)
    from accelerate_tpu_torch.test_utils.worlds import fp8_forms

    res = run_world(fp8_forms, 2, args=(str(tmp_path / "inputs.pkl"),))
    for (l0, f0), (l1, f1) in zip(res[0]["steps"], res[1]["steps"]):
        assert l0 == l1
        for (p, s0, h0), (_, s1, h1) in zip(_meta_leaves(f0),
                                            _meta_leaves(f1)):
            np.testing.assert_array_equal(s0, s1, err_msg=p)
            np.testing.assert_array_equal(h0, h1, err_msg=p)
    for k, v in flatten_dict(res[0]["params"]).items():
        np.testing.assert_array_equal(
            np.asarray(v), np.asarray(flatten_dict(res[1]["params"])[k]),
            err_msg=str(k))

    jacc = at.Accelerator(mixed_precision="fp8", gradient_clipping=1.0)
    js = at.TrainState.create(
        apply_fn=None, params=jax.tree_util.tree_map(jax.numpy.asarray, pn),
        tx=optax.adamw(3e-3), fp8_state=jl.init_fp8_state(cfg))
    jstep = jacc.train_step(lambda p, b, fp8_state=None: jl.causal_lm_loss(
        cfg, p, b, fp8_state=fp8_state))
    js, jm = jstep(js, {"input_ids": jax.numpy.asarray(batches[0])})
    loss, t1 = res[0]["steps"][0]
    np.testing.assert_allclose(loss, float(jm["loss"]), rtol=0, atol=5e-3)
    j1 = jax.tree_util.tree_map(np.asarray, js.fp8_state)
    pairs = list(zip(_meta_leaves(j1), _meta_leaves(t1)))
    assert len(pairs) == 14
    for (path, js_, jh), (tpath, ts_, th) in pairs:
        assert path == tpath
        if path.endswith(".w"):
            np.testing.assert_array_equal(ts_, js_, err_msg=path)
            np.testing.assert_array_equal(th, jh, err_msg=path)
        elif ".down_proj." in path:
            np.testing.assert_allclose(ts_[0], js_[0], rtol=2e-2)
            np.testing.assert_allclose(th[0], jh[0], rtol=2e-2)
        else:
            np.testing.assert_array_equal(ts_[0], js_[0], err_msg=path)
            np.testing.assert_array_equal(th[0], jh[0], err_msg=path)


def test_fp8_gradient_scale_is_the_global_batchs():
    """The backward's E5M2 scale comes from the amax across ranks: one
    fp8 projection's dW averaged over two ranks, each on half the rows,
    is the one-process dW on all of them (to f32 rounding), and each
    rank's dX is twice the one-process dX of its rows (its loss is the
    mean of half the rows), bit for bit."""
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.test_utils.worlds import fp8_grad_forms

    res = run_world(fp8_grad_forms, 2)
    PartialState(cpu=True)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    out, _ = fp8.fp8_dense(x, w, {"x": fp8.Fp8Meta.init(device="cpu"),
                                  "w": fp8.Fp8Meta.init(device="cpu")})
    (out.float() ** 2).mean().backward()
    # dW sums rows in another order: f32 rounding of the largest entry
    atol = 1e-6 * float(w.grad.abs().max())
    for r, got in enumerate(res):
        torch.testing.assert_close(got["dw"], w.grad, rtol=1e-6, atol=atol)
        assert torch.equal(got["dx"], 2 * x.grad[4 * r:4 * r + 4])


class _Tail:
    """A loader in its final batch, padded as `layout` says."""

    def __init__(self, remainder, layout):
        self.end_of_dataloader = True
        self.remainder = remainder
        self.tail_layout = layout


@pytest.mark.parametrize("remainder, layout", [
    (5, None), (6, (2, 4, 3)), (3, (1, 4, 3))],
    ids=["global_tail", "per_process_pads", "one_process_pads"])
def test_gather_for_metrics_trims_a_padded_tail_like_jax(
        remainder, layout, monkeypatch):
    rows = np.arange(16, dtype=np.float32).reshape(8, 2)
    if layout is not None and layout[0] * layout[1] != 8:
        rows = rows[: layout[0] * layout[1]]
    acc = Accelerator(cpu=True)
    jacc = at.Accelerator()
    # the gathered rows of every process, as both packages' gather
    monkeypatch.setattr(tops, "gather",
                        lambda t: {"x": torch.from_numpy(rows)})
    monkeypatch.setattr(jops, "gather", lambda t: {"x": rows})
    outs = []
    for a in (acc, jacc):
        a.gradient_state._add_dataloader(_Tail(remainder, layout))
        outs.append((a.gather_for_metrics({"x": rows})["x"],
                     a.gather_for_metrics(list(range(8)))))
        a.gradient_state._remove_dataloader(
            a.gradient_state.active_dataloader)
    (t, tl), (j, jl_) = outs
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tl == jl_


def test_local_sgd_averages_every_k_steps_and_on_flush():
    from accelerate_tpu_torch.local_sgd import LocalSGD
    from accelerate_tpu_torch.test_utils.worlds import local_sgd_forms

    res = run_world(local_sgd_forms, 2)
    for r, out in enumerate(res):
        # rank r holds r; +1 a step; averaged at step 3: (3 + 4) / 2
        assert [float(s[0, 0]) for s in out["seen"]] == [r + 1, r + 2, 3.5]
        # b = r averaged at step 3 (0.5), + r, averaged by flush
        assert float(out["b"]) == 1.0
        assert out["ts_w"].tolist() == [0.5, 0.5]
    one = LocalSGD(local_sgd_steps=2)
    params = {"w": torch.ones(2)}
    assert not one.enabled and one.step(params) is params
    with pytest.raises(ValueError):
        LocalSGD(local_sgd_steps=0)


def test_checkpoint_of_a_two_process_world(tmp_path):
    """The main process writes the replicated state and the manifest,
    each process its RNG streams; `total_limit` prunes on the main
    process only; every rank reloads its saved params; the checkpoint
    loads in one process too."""
    from accelerate_tpu_torch import checkpointing
    from accelerate_tpu_torch.optimizers import adam
    from accelerate_tpu_torch.test_utils.training import regression_params
    from accelerate_tpu_torch.test_utils.worlds import checkpoint_forms
    from accelerate_tpu_torch.training import TrainState

    res = run_world(checkpoint_forms, 2, out_dir=str(tmp_path))
    assert res[0]["path"] == res[1]["path"]
    assert res[0]["dirs"] == ["checkpoint_1"]
    files = res[0]["files"]
    assert {"model_0.safetensors", "random_states_0.pkl",
            "random_states_1.pkl", "checkpoint.manifest.json"} <= set(files)
    for r in res:
        assert r["step"] == 2
        for k in ("a", "b"):
            assert torch.equal(r["saved"][k], r["loaded"][k])
    assert checkpointing.is_complete_checkpoint(res[0]["path"])
    ts = TrainState.create(apply_fn=None,
                           params=regression_params(device="cpu"),
                           tx=adam(0.05))
    checkpointing.load_accelerator_state(res[0]["path"], train_states=[ts])
    assert ts.step == 2 and torch.equal(ts.params["a"], res[0]["saved"]["a"])
