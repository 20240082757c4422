"""Mean device time per step of the span ``encoder_step_ms``, from CUDA events the
task records (the GAN step's own ``mark`` hook, or around the encoder
step's two calls) over the traced window."""


def read(r, name):
    xs = r.spans.get("encoder_step_ms")
    return sum(xs) / len(xs) if xs else None
