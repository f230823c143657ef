"""The launch-config reader (`config_args.py`); the interactive
`config` command is a later slice (ROADMAP.md, queue 1 item 8d)."""
