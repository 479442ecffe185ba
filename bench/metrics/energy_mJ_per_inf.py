"""The card's energy over the window (its NVML energy counter, or its
sampled power draw) per inference answered inside the window: the paper's
energy per inference, measured on the card."""


def read(run):
    n = len(run.answered_in_window)
    if run.window.energy_j is None or n == 0:
        return None
    return run.window.energy_j * 1e3 / n
