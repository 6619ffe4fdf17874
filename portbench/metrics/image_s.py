"""image_s: the window's wall seconds, from the first image's start to the
last image's end, over the images completed (host clock)."""


def read(run):
    return run.window_s / len(run.images)
