"""Launch-and-assert: the smallest script, printing the world it ran in
so the launcher's wiring can be asserted from outside."""

from __future__ import annotations

import sys


def main() -> None:
    from accelerate_tpu_torch.state import PartialState

    state = PartialState()
    # one write of the whole line: every process shares the launcher's
    # stdout, and print() may write the text and its newline apart
    sys.stdout.write(f"Successfully ran on {state.device} as process "
                     f"{state.process_index} of {state.num_processes} "
                     "process(es)\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
