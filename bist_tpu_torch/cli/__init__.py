"""Command-line entry points (python -m bist_tpu_torch.cli.<name>)."""


def repo_root():
    """Best-effort path to a source checkout's repository root: entry points
    find repo-level data (``dstc7avsd_eval/data``) relative to it; an
    installed package has no such files, and callers take explicit flags."""
    import os

    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
