"""Synchronizing calls a frame under ``set_sync_debug_mode("warn")``."""


def read(run):
    if run.syncs is None:
        return None
    return run.syncs["syncs"] / run.syncs["units"]
