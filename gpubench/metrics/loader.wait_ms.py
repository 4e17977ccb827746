"""loader.wait_ms: the mean time a step of the window waited for its batch
(the benchmark's clock around the Loader's next()), in ms."""


def read(ctx):
    waits = ctx.feed.waits
    return sum(waits) / len(waits) * 1e3 if waits else None
