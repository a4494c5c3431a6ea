"""Device milliseconds of the episode's ViT encoder (the program's ``sam.encoder`` span: its micro-batches, inside ``network``) per episode (``dispatch`` span) of the traced work, from the span's CUDA events."""

from _program import device_ms


def read(run):
    return device_ms(run, "sam.encoder", "dispatch")
