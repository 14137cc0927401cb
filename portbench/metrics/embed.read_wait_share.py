"""Share of the window the runner loop spent waiting in `next(reader)`
(the harness's span around each of the window's calls), in %: the reader
and staging layer holding the mapper back."""


def read(ctx):
    run = ctx["run"]
    return 100.0 * run["read_s"] / run["window_s"] if run["window_s"] > 0 else None
