"""The launch-config reader (the reader half of
`accelerate_tpu/commands/config/config_args.py`).

A YAML (or JSON) file whose keys are `LaunchConfig`'s fields fills every
launch flag the command line left unset: explicit flags win over the
file. The default file is `~/.cache/accelerate_tpu_torch/
default_config.yaml`. The fields are the reference's, so its files
load; the launcher refuses the ones the port does not run (pods,
sharded engines), as it refuses their flags. PyYAML is needed only to
read a `.yaml` file.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from pathlib import Path

CACHE_DIR = Path.home() / ".cache" / "accelerate_tpu_torch"
DEFAULT_CONFIG_NAME = "default_config.yaml"


def default_config_path() -> Path:
    return CACHE_DIR / DEFAULT_CONFIG_NAME


@dataclass
class LaunchConfig:
    """The reference's launch record, field for field."""

    compute_environment: str = "LOCAL_MACHINE"
    distributed_type: str = "NO"
    num_machines: int = 1
    machine_rank: int = 0
    main_process_ip: str | None = None
    main_process_port: int | None = None
    num_processes: int | None = None
    mixed_precision: str | None = None
    mesh_shape: str | None = None
    gradient_accumulation_steps: int | None = None
    zero_stage: int | None = None
    fsdp_sharding_strategy: str | None = None
    context_parallel_mode: str | None = None
    context_parallel_degree: int | None = None
    num_virtual_devices: int | None = None
    max_restarts: int | None = None
    use_cpu: bool = False
    debug: bool = False
    tpu_name: str | None = None
    tpu_zone: str | None = None
    tpu_project: str | None = None
    tpu_accelerator_type: str | None = None

    @classmethod
    def from_dict(cls, data: dict) -> "LaunchConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"Unknown config keys {sorted(unknown)}; valid "
                             f"keys: {sorted(known)}")
        return cls(**data)

    @classmethod
    def load(cls, config_file: str | os.PathLike | None = None
             ) -> "LaunchConfig":
        path = Path(config_file) if config_file else default_config_path()
        text = path.read_text()
        if path.suffix == ".json":
            data = json.loads(text)
        else:
            import yaml

            data = yaml.safe_load(text)
        return cls.from_dict(data or {})


def load_config(config_file: str | os.PathLike | None = None
                ) -> LaunchConfig | None:
    """The config at `config_file` (default: the default file), or None
    where there is none."""
    path = Path(config_file) if config_file else default_config_path()
    if not path.is_file():
        if config_file:
            raise FileNotFoundError(f"no launch config at {path}")
        return None
    return LaunchConfig.load(path)
