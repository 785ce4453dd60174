"""The window's milliseconds over the circuits completed in it."""


def read(run):
    if not run.window.units:
        return None
    return 1e3 * run.window.elapsed_s / run.window.units
