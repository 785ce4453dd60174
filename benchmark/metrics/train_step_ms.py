"""The window's milliseconds over the training steps completed in it,
each round's work finished on the device."""


def read(run):
    if not run.window.units:
        return None
    return 1e3 * run.window.elapsed_s / run.window.units
