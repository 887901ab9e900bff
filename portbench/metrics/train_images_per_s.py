"""train_images_per_s (images/s, host clock): images of the steps
completed in the window, over the window's time."""


def read(run):
    return run.rate()
