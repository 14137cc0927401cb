"""Mean ms of one mapper call per batch of the window (the harness's span
around the runner's call, which ends in the mapper's read-back to the
host)."""


def read(ctx):
    run = ctx["run"]
    return 1e3 * run["inference_s"] / run["batches"] if run["batches"] else None
