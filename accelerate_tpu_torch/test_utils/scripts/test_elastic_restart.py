"""Launch-and-assert: a relaunch after a crash resumes from the last
checkpoint.

Run as `python -m accelerate_tpu_torch.commands.launch --num_processes 2
--max_restarts 1 --cpu test_elastic_restart.py STATE_DIR`: on the first
attempt every rank trains 5 steps and checkpoints, then a rank other
than 0 dies hard (`os._exit`). The launcher tears the world down and
relaunches it; the second attempt finds the marker file, resumes at step
5 and trains to step 10. In a world of one the crash is skipped."""

from __future__ import annotations

import os
import sys

import numpy as np


def main(argv: list[str] | None = None) -> None:
    import tempfile

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.optimizers import sgd
    from accelerate_tpu_torch.training import TrainState

    argv = argv or []
    state_dir = argv[0] if argv else tempfile.mkdtemp()
    marker = os.path.join(state_dir, "crashed_once")
    ckpt_dir = os.path.join(state_dir, "ckpt")

    acc = Accelerator()
    cfg = llama.LlamaConfig.tiny()
    ts = acc.prepare(TrainState.create(
        apply_fn=None, params=llama.init_params(cfg, 0, device=acc.device),
        tx=sgd(1e-3)))
    rng = np.random.default_rng(0)
    (batch,) = list(acc.prepare([{"input_ids": rng.integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32)}]))
    step = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))

    first_attempt = not os.path.exists(marker)
    start = 0
    if not first_attempt:
        acc.load_state(ckpt_dir, state=ts)
        start = int(ts.step)
        assert start == 5, f"expected to resume at step 5, got {start}"
    for i in range(start, 10):
        ts, m = step(ts, batch)
        if first_attempt and i == 4:
            acc.save_state(ckpt_dir, state=ts)
            acc.wait_for_everyone()
            if acc.is_main_process:
                with open(marker, "w") as f:
                    f.write("1")
            acc.wait_for_everyone()
        if first_attempt and i == 5 and not acc.is_main_process:
            os._exit(17)  # a hard crash: no clean-up, no exception
    assert int(ts.step) == 10, int(ts.step)
    assert np.isfinite(float(m["loss"]))
    acc.print("test_elastic_restart: ALL CHECKS PASSED")


if __name__ == "__main__":
    main(sys.argv[1:])
