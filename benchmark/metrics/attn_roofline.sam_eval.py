"""Share of its roofline that the ViT's attention reaches: Σ of ``attention_roofline.bound`` over the attention calls the traced episodes need, from their shapes, over the device time of the program's ``sam.attn`` spans (each call's bias and attention) in the traced work."""

import attention_roofline
from _program import traced


def read(run):
    recs, calls = traced(run), getattr(run, "attn_calls", None)
    if recs is None or not calls:
        return None
    ms = [r.device_ms() for r in recs if r.name == "sam.attn"]
    if not ms or None in ms or sum(ms) <= 0:
        return None
    return 100.0 * sum(map(attention_roofline.bound, calls)) / (1e-3 * sum(ms))
