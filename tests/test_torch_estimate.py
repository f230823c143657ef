"""The port's memory estimator (`python -m accelerate_tpu_torch.commands.
estimate`) against the JAX package's: the same parameter counts and the
same table for every preset (the port builds them on the meta device, the
reference with `jax.eval_shape`), for a safetensors directory and for an
HF config.json. Counts are integers: compared exactly."""

import argparse
import json

import numpy as np
import pytest
import torch

from accelerate_tpu.commands import estimate as je
from accelerate_tpu_torch.commands import estimate as te
from accelerate_tpu_torch.utils import safetensors as st


@pytest.mark.parametrize("preset", list(je.PRESETS))
def test_preset_table_matches_reference(preset):
    assert te.PRESETS[preset] == je.PRESETS[preset]
    counts = te.count_model_params(preset)
    assert counts == je.count_model_params(preset)
    dtypes = list(je._DTYPES)
    assert te.estimate_table(preset, dtypes, counts) == je.estimate_table(
        preset, dtypes, counts)


def test_presets_allocate_nothing():
    from accelerate_tpu_torch.big_modeling import init_empty_weights
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.utils.other import flatten_dict

    tree = init_empty_weights(llama.init_params,
                              llama.LlamaConfig(**te.PRESETS["llama-70b"][1]))
    assert all(t.is_meta for t in flatten_dict(tree).values())


def test_safetensors_dir_counts_from_headers(tmp_path):
    rng = np.random.default_rng(0)
    st.save_file({"embed.w": torch.from_numpy(
        rng.normal(size=(10, 4)).astype(np.float32)),
        "layers.0.w": torch.zeros(4, 4, dtype=torch.bfloat16)},
        str(tmp_path / "a.safetensors"))
    st.save_file({"layers.1.w": torch.zeros(4, 4, dtype=torch.int8),
                  "head.b": torch.zeros(3)}, str(tmp_path / "b.safetensors"))
    got = te.count_model_params(str(tmp_path))
    assert got == je.count_model_params(str(tmp_path))
    assert got == (40 + 16 + 16 + 3, {"embed": 40, "layers": 32, "head": 3})


@pytest.mark.parametrize("model_type,extra", [
    ("llama", {}), ("mistral", {"num_key_value_heads": 2}),
    ("bert", {}), ("mixtral", {"num_local_experts": 4}),
])
def test_hf_config_maps_onto_a_family(tmp_path, model_type, extra):
    data = {"model_type": model_type, "vocab_size": 512, "hidden_size": 64,
            "intermediate_size": 128, "num_hidden_layers": 3,
            "num_attention_heads": 4, **extra}
    if model_type != "bert":
        data.setdefault("num_key_value_heads", 4)
    (tmp_path / "config.json").write_text(json.dumps(data))
    assert te.count_model_params(str(tmp_path)) == je.count_model_params(
        str(tmp_path))


def test_unknown_sources_raise_alike(tmp_path):
    for name in ("no-such-preset", str(tmp_path)):
        with pytest.raises(ValueError) as j:
            je.count_model_params(name)
        with pytest.raises(ValueError) as t:
            te.count_model_params(name)
        assert str(t.value).split(":")[0] == str(j.value).split(":")[0]
    (tmp_path / "config.json").write_text('{"model_type": "rwkv"}')
    with pytest.raises(ValueError, match="Unsupported architecture"):
        te.count_model_params(str(tmp_path))


def test_cli_prints_the_reference_table(capsys):
    args = argparse.Namespace(model_name="llama-7b",
                              dtypes=["float32", "bfloat16", "int4"])
    assert je.estimate_command(args) == 0
    ref = capsys.readouterr().out
    assert te.main(["llama-7b", "--dtypes", "float32", "bfloat16",
                    "int4"]) == 0
    assert capsys.readouterr().out == ref
    assert te.main(["no-such-preset"]) == 2
