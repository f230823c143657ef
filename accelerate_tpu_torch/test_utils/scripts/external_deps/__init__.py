"""Heavier launch-and-assert scripts: checkpoint round-trips and the
exactness of `gather_for_metrics`. Each script's `main()` asserts on
every rank and prints "ALL CHECKS PASSED" from the main process."""
