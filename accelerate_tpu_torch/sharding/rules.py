"""Path-pattern sharding rules (a copy of `accelerate_tpu/sharding/rules.py`:
the port imports nothing of the JAX package).

The reference configures parallelism per-engine: FSDP auto-wrap policies
(ref utils/dataclasses.py:1007-1236), DeepSpeed ZeRO JSON
(ref accelerator.py:1563-1786), Megatron's hardcoded layer splits
(ref utils/megatron_lm.py). Here one concept covers all of them: an ordered
list of `(path_regex, spec_template)` rules mapping parameter *paths* to
`PartitionSpec` templates over named mesh axes. Axes absent from the actual
mesh (or not dividing the dimension) are dropped at plan time, so a single
rule set serves every mesh shape from 1 chip to a multi-slice pod.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Sequence

from ..utils.constants import AXIS_EXPERT, AXIS_FSDP, AXIS_MODEL

# A spec template is a tuple over dims; each entry is None, an axis name, or a
# tuple of axis names (sharded over several axes).
SpecTemplate = tuple


@dataclass
class ShardingRule:
    pattern: str
    spec: SpecTemplate

    def __post_init__(self) -> None:
        self._compiled = re.compile(self.pattern)

    def matches(self, path: str) -> bool:
        return self._compiled.search(path) is not None


@dataclass
class ShardingRules:
    """Ordered rule list; first match wins. `default_fsdp` enables the
    auto-rule: shard the largest divisible dim on the fsdp axis (ZeRO-3
    semantics without any per-model annotation)."""

    rules: Sequence[ShardingRule] = field(default_factory=tuple)
    default_fsdp: bool = True
    min_weight_size: int = 2**12  # below this, replicate (ref FSDP min_num_params)

    def find(self, path: str) -> SpecTemplate | None:
        for rule in self.rules:
            if rule.matches(path):
                return rule.spec
        return None

    @classmethod
    def from_pairs(cls, pairs: Sequence[tuple[str, SpecTemplate]], **kwargs) -> "ShardingRules":
        return cls(rules=tuple(ShardingRule(p, s) for p, s in pairs), **kwargs)


# ---------------------------------------------------------------------------
# canonical transformer rule set (Megatron TP layout re-expressed as specs;
# replaces utils/megatron_lm.py's hand-split Linear layers)
# ---------------------------------------------------------------------------

# Conventions covered: our models/ naming, flax linen defaults ('kernel',
# 'embedding'), and HF-style ('weight').
TRANSFORMER_RULES: tuple[tuple[str, SpecTemplate], ...] = (
    # token embedding: (vocab, hidden) — vocab on model axis (Megatron
    # VocabParallelEmbedding), hidden on fsdp
    (r"(embed_tokens|wte|embedding|tok_embeddings).*(embedding|weight)$", (AXIS_MODEL, AXIS_FSDP)),
    # MoE experts first (more specific than the generic projections below):
    # leading expert dim on expert axis, then column/row layout
    (r"experts.*(gate_proj|up_proj|w1|w3)[/.](kernel|weight)$",
     (AXIS_EXPERT, AXIS_FSDP, AXIS_MODEL)),
    (r"experts.*(down_proj|w2)[/.](kernel|weight)$",
     (AXIS_EXPERT, AXIS_MODEL, AXIS_FSDP)),
    (r"router[/.](kernel|weight)$", (None, None)),
    # column-parallel (output dim sharded): q/k/v incl. fused qkv (one
    # [in, 3h] kernel whose out dim slices to per-device head groups) —
    # gpt2's `c_attn` matched NO alternative and silently replicated the
    # biggest attention matmul under tensor parallelism; neox's
    # `query_key_value` only matched through the `value` substring (the
    # rules are unanchored re.search), which is an accident, not a
    # contract — both are now named explicitly — and MLP up/gate. (in, out)
    (r"(q_proj|k_proj|v_proj|query|key|value|c_attn|query_key_value"
     r"|gate_proj|up_proj|wi|w1|w3|fc1|c_fc)[/.](kernel|weight)$",
     (AXIS_FSDP, AXIS_MODEL)),
    # row-parallel (input dim sharded): attention out, MLP down — (in, out)
    (r"(o_proj|out_proj|dense|down_proj|wo|w2|fc2|c_proj)[/.](kernel|weight)$",
     (AXIS_MODEL, AXIS_FSDP)),
    # LM head: (hidden, vocab)
    (r"(lm_head|output)[/.](kernel|weight)$", (AXIS_FSDP, AXIS_MODEL)),
    # norms / biases / scalars: replicated
    (r"(norm|ln_f|layernorm|layer_norm|rmsnorm).*", ()),
    (r"[/.](bias|scale)$", ()),
)


def transformer_rules(**kwargs) -> ShardingRules:
    return ShardingRules.from_pairs(TRANSFORMER_RULES, **kwargs)
