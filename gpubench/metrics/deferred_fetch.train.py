"""deferred_fetch.train: the share of the window's groups whose metrics
the trainer's host took only after it had launched the next group (the
group runner's counters `nsp.group.deferred` and `nsp.group.drained`; a
drained group had nothing queued behind it: an epoch's end, the end of
the data, a read at once). Layer: group runner. Moves
train_samples_s."""
from _spans import counter


def read(ctx):
    deferred = counter("nsp.group.deferred") or 0
    drained = counter("nsp.group.drained") or 0
    if not deferred + drained:
        return None
    return 100.0 * deferred / (deferred + drained)
