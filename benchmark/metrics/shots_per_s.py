"""Shots completed in the window over the window's seconds."""


def read(run):
    return run.window.work["shots"] / run.window.elapsed_s
