"""Model memory estimator (port of `accelerate_tpu/commands/estimate.py`).

    python -m accelerate_tpu_torch.commands.estimate <preset|dir> [--dtypes ...]

Three sources, as in the reference:

- a family preset (`llama-7b`, `mixtral-8x7b`, `bert-base`, ...), whose
  params are built on the meta device (`big_modeling.init_empty_weights`:
  shapes only, nothing allocated);
- a local checkpoint directory of safetensors files, sized from their
  headers (no weights read);
- a local HF `config.json` of a llama/mistral, bert or mixtral model,
  mapped onto the family's config.

The table gives, per dtype, the largest top-level module, the total size
and the size of Adam training (params and grads in the dtype, an f32
master copy and two f32 moments).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

from ..utils import safetensors

_DTYPES = {"float32": 4.0, "bfloat16": 2.0, "float16": 2.0, "int8": 1.0,
           "int4": 0.5}

PRESETS = {
    "bert-base": ("bert", dict()),
    "bert-large": ("bert", dict(hidden_size=1024, num_hidden_layers=24,
                                num_attention_heads=16,
                                intermediate_size=4096)),
    "llama-1b": ("llama", dict(hidden_size=2048, intermediate_size=5632,
                               num_hidden_layers=16, num_attention_heads=32,
                               num_key_value_heads=8)),
    "llama-7b": ("llama", dict(hidden_size=4096, intermediate_size=11008,
                               num_hidden_layers=32, num_attention_heads=32,
                               num_key_value_heads=32)),
    "llama-8b": ("llama", dict(hidden_size=4096, intermediate_size=14336,
                               num_hidden_layers=32, num_attention_heads=32,
                               num_key_value_heads=8, vocab_size=128256)),
    "llama-70b": ("llama", dict(hidden_size=8192, intermediate_size=28672,
                                num_hidden_layers=80, num_attention_heads=64,
                                num_key_value_heads=8)),
    "mixtral-8x7b": ("mixtral", dict(hidden_size=4096,
                                     intermediate_size=14336,
                                     num_hidden_layers=32,
                                     num_attention_heads=32,
                                     num_key_value_heads=8,
                                     num_local_experts=8)),
    "gpt2": ("gpt2", dict()),
    "gpt2-xl": ("gpt2", dict(hidden_size=1600, num_hidden_layers=48,
                             num_attention_heads=25)),
    "gptj-6b": ("gptj", dict()),
    "gpt-neox-20b": ("gpt_neox", dict()),
    "opt-30b": ("opt", dict()),
    "t5-11b": ("t5", dict(d_model=1024, d_ff=65536, d_kv=128, num_layers=24,
                          num_heads=128, is_gated_act=False,
                          tie_word_embeddings=True)),
    "t0pp": ("t5", dict()),
}

_CONFIGS = {"llama": "LlamaConfig", "bert": "BertConfig",
            "mixtral": "MixtralConfig", "gpt2": "GPT2Config",
            "gptj": "GPTJConfig", "gpt_neox": "GPTNeoXConfig",
            "opt": "OPTConfig", "t5": "T5Config"}


def _family_param_tree(family: str, overrides: dict):
    """The family's params on the meta device: shapes and dtypes only."""
    from ..big_modeling import init_empty_weights

    if family not in _CONFIGS:
        raise ValueError(f"unknown family {family}")
    mod = importlib.import_module(f"..models.{family}", __package__)
    config = getattr(mod, _CONFIGS[family])(**overrides)
    return init_empty_weights(mod.init_params, config, 0)


def _tree_sizes(tree) -> tuple[int, dict[str, int]]:
    """(total parameter count, per top-level module counts)."""
    from ..utils.other import flatten_dict

    total = 0
    per_module: dict[str, int] = {}
    for key, leaf in flatten_dict(tree).items():
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        top = key.split(".")[0]
        per_module[top] = per_module.get(top, 0) + n
    return total, per_module


def _from_safetensors_dir(path: Path) -> tuple[int, dict[str, int]] | None:
    files = sorted(path.glob("*.safetensors"))
    if not files:
        return None
    total = 0
    per_module: dict[str, int] = {}
    for f in files:
        header, _ = safetensors.read_header(str(f))
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            n = 1
            for d in meta["shape"]:
                n *= d
            total += n
            top = name.split(".")[0]
            per_module[top] = per_module.get(top, 0) + n
    return total, per_module


_HF_ARCH_FAMILY = {"llama": "llama", "mistral": "llama", "bert": "bert",
                   "mixtral": "mixtral"}

_HF_CONFIG_KEYS = (
    "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
    "num_attention_heads", "num_key_value_heads", "num_local_experts",
)


def _from_hf_config(path: Path) -> tuple[int, dict[str, int]] | None:
    config_file = path / "config.json"
    if not config_file.is_file():
        return None
    data = json.loads(config_file.read_text())
    family = _HF_ARCH_FAMILY.get(str(data.get("model_type", "")).lower())
    if family is None:
        raise ValueError(
            f"Unsupported architecture {data.get('model_type')!r}; provide "
            "a safetensors checkpoint dir instead")
    overrides = {k: data[k] for k in _HF_CONFIG_KEYS if k in data}
    if family != "mixtral":
        overrides.pop("num_local_experts", None)
    return _tree_sizes(_family_param_tree(family, overrides))


def count_model_params(model_name: str) -> tuple[int, dict[str, int]]:
    if model_name in PRESETS:
        family, overrides = PRESETS[model_name]
        return _tree_sizes(_family_param_tree(family, overrides))
    path = Path(model_name)
    if path.is_dir():
        result = _from_safetensors_dir(path) or _from_hf_config(path)
        if result is not None:
            return result
        raise ValueError(
            f"{path} contains neither *.safetensors files nor a config.json")
    raise ValueError(
        f"Unknown model {model_name!r}: not a preset "
        f"({', '.join(PRESETS)}) and not a local directory")


def _human(num_bytes: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(num_bytes) < 1024:
            return f"{num_bytes:.2f} {unit}"
        num_bytes /= 1024
    return f"{num_bytes:.2f} PB"


def estimate_table(model_name: str, dtypes: list[str],
                   counts: tuple[int, dict[str, int]] | None = None
                   ) -> list[dict]:
    total, per_module = (counts if counts is not None
                         else count_model_params(model_name))
    largest = max(per_module.values()) if per_module else total
    rows = []
    for dtype in dtypes:
        bytes_per = _DTYPES[dtype]
        rows.append({
            "dtype": dtype,
            "largest_layer": largest * bytes_per,
            "total_size": total * bytes_per,
            "training_with_adam": total * (2 * bytes_per + 12.0),
        })
    return rows


def estimate_command(args: argparse.Namespace) -> int:
    counts = count_model_params(args.model_name)
    rows = estimate_table(args.model_name, args.dtypes, counts=counts)
    print(f"Model: {args.model_name} — {counts[0] / 1e6:,.1f}M params")
    header = (f"{'dtype':>10} | {'largest layer':>14} | {'total size':>12} "
              f"| {'training w/ Adam':>17}")
    print(header)
    print("-" * len(header))
    for row in rows:
        print(f"{row['dtype']:>10} | {_human(row['largest_layer']):>14} | "
              f"{_human(row['total_size']):>12} | "
              f"{_human(row['training_with_adam']):>17}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.estimate",
        description="Estimate memory needed to load/train a model")
    parser.add_argument(
        "model_name", help="Built-in preset (e.g. llama-7b, mixtral-8x7b, "
                           "bert-base) or a local checkpoint/config dir")
    parser.add_argument("--dtypes", nargs="+", default=list(_DTYPES),
                        choices=list(_DTYPES))
    args = parser.parse_args(argv)
    try:
        return estimate_command(args)
    except ValueError as e:
        print(f"estimate: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
