"""The whole step's share of the card's peak: the products of a frame
(the benchmark's own count over its reference model on the meta device)
times the frames of the window, over the window's seconds and the peak of
the configuration's dtype (989 TFLOP/s bf16). The traced group is left
out of both. Moves ``fps``."""


def read(run):
    if run.frames <= 0 or run.seconds <= 0:
        return None
    return 100.0 * run.products * run.frames / run.seconds / run.peak_flops
