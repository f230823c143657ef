"""Launch-and-assert: `notebook_launcher` builds the world it is asked
for, and refuses to fork once the process state (or CUDA) is
initialised in the caller."""

from __future__ import annotations

import os


def basic_function():
    from accelerate_tpu_torch.state import PartialState

    state = PartialState()
    state.wait_for_everyone()
    print(f"PartialState:\n{state!r}")


def test_can_initialize(num_processes: int):
    from accelerate_tpu_torch.launchers import notebook_launcher

    notebook_launcher(basic_function, (), num_processes=num_processes)


def test_refuses_after_state_initialized():
    from accelerate_tpu_torch.launchers import notebook_launcher
    from accelerate_tpu_torch.state import PartialState

    PartialState()
    try:
        notebook_launcher(basic_function, (), num_processes=2)
    except RuntimeError:
        pass
    else:
        raise AssertionError("notebook_launcher(num_processes=2) started "
                             "after the state was initialized")


def main() -> None:
    # the world to build; a launched world's ranks each run it alone
    num_processes = int(os.environ.get("NOTEBOOK_NUM_PROCESSES", "1"))
    test_can_initialize(num_processes)
    test_refuses_after_state_initialized()
    print("test_notebook: ALL CHECKS PASSED")


if __name__ == "__main__":
    main()
