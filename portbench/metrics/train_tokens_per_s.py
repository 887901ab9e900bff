"""train_tokens_per_s (tokens/s, host clock): batch x seq x the steps
completed in the window, over the window's time from its synchronised start
to its final synchronise."""


def read(run):
    return run.rate()
