"""train_scans_per_s: the scans of the optimizer steps completed in the
window (each ended by a synchronise of the card) over the window's
seconds."""


def read(run):
    return sum(run.window.scans) / run.window.seconds
