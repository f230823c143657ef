"""Launch-and-assert: pipeline-parallel inference (port of the reference
script of the same name; GPipe micro-batching over the mesh's `stage`
axis, one process a stage).

    python -m accelerate_tpu_torch.commands.launch --cpu --num_processes 2 \\
        test_pipeline_inference.py

Every rank asserts:
- `prepare_pipeline` over a `data` x `stage` mesh reproduces the
  sequential forward for several chunk counts, and keeps only its own
  stage's layers;
- every process receives the full output (the reference's
  `gather_output=True` contract);
- `prepare_sharded_inference` (the sharded serving path) agrees too.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

# f32 products in another order than the sequential reference's
RTOL, ATOL = 2e-5, 2e-6


def _layer_fn(layer, x):
    return x + torch.tanh(x @ layer["kernel"] + layer["bias"])


def _stacked_layers(seed: int, n_layers: int, width: int, device):
    rng = np.random.default_rng(seed)
    return {
        "kernel": torch.from_numpy(
            rng.standard_normal((n_layers, width, width), np.float32) * 0.05
        ).to(device),
        "bias": torch.zeros((n_layers, width), device=device),
    }


def _sequential_reference(layers, x):
    for i in range(layers["kernel"].shape[0]):
        x = _layer_fn({k: v[i] for k, v in layers.items()}, x)
    return x


def check_pipeline_matches_sequential():
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.inference import prepare_pipeline
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils.constants import AXIS_DATA, AXIS_STAGE
    from accelerate_tpu_torch.utils.dataclasses import MeshConfig

    n = PartialState().num_processes
    if n < 2 or n % 2:
        return  # a stage axis needs an even world here
    PartialState._reset_state()
    acc = Accelerator(mesh_config=MeshConfig(
        axes={AXIS_DATA: n // 2, AXIS_STAGE: 2}))
    width, n_layers, batch = 64, 8, 16
    layers = _stacked_layers(0, n_layers, width, acc.device)
    x = np.random.default_rng(1).standard_normal((batch, width), np.float32)
    want = _sequential_reference(layers, torch.from_numpy(x).to(acc.device))

    for num_chunks in (2, 4):
        model = prepare_pipeline(_layer_fn, layers, num_chunks=num_chunks,
                                 mesh=acc.mesh, device=acc.device)
        assert model.stage_params["kernel"].shape == \
            (1, n_layers // 2, width, width)
        got = model(x)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


def check_sharded_serving_path():
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.inference import prepare_sharded_inference
    from accelerate_tpu_torch.state import PartialState

    PartialState._reset_state()
    acc = Accelerator()
    width, n_layers = 64, 4
    layers = _stacked_layers(2, n_layers, width, acc.device)
    served_fn, sharded_params = prepare_sharded_inference(
        _sequential_reference, layers, mesh=acc.mesh, device=acc.device)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (16, width), np.float32)).to(acc.device)
    got = served_fn(sharded_params, x)
    want = _sequential_reference(layers, x)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def main() -> None:
    from accelerate_tpu_torch.state import PartialState

    torch.set_grad_enabled(False)
    PartialState()
    check_pipeline_matches_sequential()
    check_sharded_serving_path()
    state = PartialState()
    if state.is_main_process:
        sys.stdout.write("test_pipeline_inference: ALL CHECKS PASSED "
                         f"({state.num_processes} process(es))\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
