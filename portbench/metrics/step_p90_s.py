"""step_p90_s: the 90th percentile of the duration of every denoise step
of every image in the window, from CUDA events recorded at the step
boundaries by ``generate_image``'s ``progress=`` hook."""

import numpy as np


def read(run):
    return float(np.quantile([s for img in run.images for s in img["steps_s"]], 0.9))
