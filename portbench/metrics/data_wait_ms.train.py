"""Host time a step waits for its batch from ``prefetch_to_device``
(``next`` of the loader), averaged over the timed window's steps, ms."""


def read(run):
    w = run.window
    if "data_wait_s" not in w or not w["steps"]:
        return None
    return 1e3 * w["data_wait_s"] / w["steps"]
