"""Process start to the first timed operation: import, CUDA context, kernel
library, data made and packed on the card, warm-up."""


def read(run):
    return run.setup_s
