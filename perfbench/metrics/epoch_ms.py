"""Milliseconds a stage-1 epoch: the trainer's own ``epoch_times`` (each
epoch ends in a host read), summed over the window and divided by their
count."""


def read(ctx):
    epochs = [t for r in ctx.records for t in r.get("epoch_s", ())]
    return 1000.0 * sum(epochs) / len(epochs) if epochs else None
