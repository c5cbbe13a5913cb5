"""Host syncs of one request, as torch's sync debug mode flags them."""


def read(run):
    return run.syncs
