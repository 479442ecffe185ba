"""Process start to the first request of the window: imports, the
weights and frames made from the seed, calibration, the ladder's
warm-up, and in a checkout's first run the build of the kernels."""


def read(run):
    return run.setup_s
