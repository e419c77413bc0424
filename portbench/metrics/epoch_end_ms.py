"""Layer: trainer loop (``runtime/loop.py::run_epochs`` as
``SampledTrainer.train`` runs it). The mean of the host's time across
each epoch boundary of the traced run's window, from the harness's
clock: from the return of an epoch's last call to the entry of the next
epoch's first call. It holds the wait for the epoch's losses (the last
calls still on the card), the sentry's drain, the epoch's record, the
next permutation and the device run's staging of the next epoch's ids;
the card idles for most of it."""

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "trainer loop"
MOVES = "samples_per_s"


def read(ctx):
    spans = ctx.get("epoch_end_ms")
    return sum(spans) / len(spans) if spans else None
