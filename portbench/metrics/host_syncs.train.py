"""Host syncs of one train step (its batch fetched and the step), as
torch's sync debug mode flags them."""


def read(run):
    return run.syncs
