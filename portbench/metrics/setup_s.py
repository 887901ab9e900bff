"""setup_s (s, host clock): from process start to the first timed step:
imports, building the model and its step, making the weights and the feed,
the checked steps, which also build the kernels and warm every shape, and
the warm-up steps."""


def read(run):
    return run.setup_s
